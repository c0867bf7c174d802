// Fused local SGD of one communication round (K1), float32.
//
// Replaces feddrift_tpu/core/step.py::TrainStep._local_sgd (:225-293) under
// _round_body's double vmap over (model, client) pairs, together with the
// optimizer it steps, make_optimizer("adam") (:94-99) =
// optax.chain(add_decayed_weights(wd), amsgrad(lr)), or make_optimizer("sgd")
// = optax.sgd(lr) on the general kernel's SGD route. The reference has no
// Pallas kernel here: XLA fuses the vmapped scan. Eager PyTorch would issue
// dozens of small ops per local step, so the whole round is one launch.
//
// What it computes. For each pair (m, c), S local steps starting from
// params[m] and the pair's optimizer state (mu, nu, nu_max, count). Step s
// reads the batch rows t_idx*N + slot*B + [0, B) of client c's [T1*N] rows
// (a contiguous batch), or, where the caller passes explicit rows idx
// [M, C, S, B] (the weighted draw, K4: weighted_draw.cu), rows idx[m, c, s]
// (a gathered batch). x is multiplied by model m's feature mask fmask[m]
// (KUE's; none: ones) as it is staged. It runs dense -> relu -> dense, the
// mean softmax cross-entropy and its
// gradient, g += wd * p, then optax's scale_by_amsgrad exactly: mu and nu
// moments, bias-corrected mu_hat and nu_hat (1 - b^count in float32, as
// optax's bias_correction), nu_max = max(nu_max, nu_hat) -- the max of the
// CORRECTED nu, which is not torch.optim.Adam(amsgrad=True) -- and
// p += (-lr * mu_hat / (sqrt(nu_max) + eps)) * lr_scale. Pairs with
// total_w == 0 run like every other pair, as the reference's static-shape
// program runs them, but their params, optimizer state and count are
// masked back and their n is 0; their mean loss is still reported.
// NaN and Inf propagate as in the reference: relu and nu_max's max keep a
// NaN, the logsumexp's max takes a NaN logit, and relu's gradient is
// jax.nn.relu's, dh * (pre-activation > 0), so 0 where h is NaN
// (fnn_eval.cuh's helpers; finite values are bitwise what fmaxf gave).
//
// Bound on the H100 SXM at the canonical SEA shape (M=4, C=10, S=5, B=500,
// F=3, H=10, K=2): each distinct batch read once is ~0.6 MB, ~0.2 us at
// 3.35 TB/s; the active pairs' ~19 MFLOP take ~0.29 us at 67 TFLOP/s, so
// the bound is set by operations. What a round really waits on is the chain
// of S dependent steps of one pair: latency, not throughput.
//
// Four kernels compute this one function; the wrapper
// (local_sgd.py::_route) picks one by shape, model and update alone, before
// the launch.
//
// local_sgd_fused_kernel<F, H, K>: the widths the port's registry produces
// at the default fnn_hidden_dim = 10 (F = 3 for SEA, F = 2 for sine and
// circle, F = 5 for ro, F = 18 for susy; H = 10, K = 2; P = 62, 52, 82 and
// 212), under AMSGrad, B <= 512 with a thread for each parameter and the
// loss (round_up(B, 32) >= P + 1: susy from B = 193, ro from B = 65).
// - One block per pair of round_up(B, 32) threads (at least 64): one batch
//   row a thread. Each thread runs its row's forward, softmax cross-entropy,
//   dlogits, the ReLU mask and its row's share of all P gradients (x (x) dh,
//   dh, h (x) dz, dz) and of the loss: P + 1 values in registers. No
//   activations go through shared memory.
// - A deterministic two-barrier reduction. Each warp folds its P + 1 values
//   (padded to V = 64) with a transpose-reduce: five butterfly rounds, each
//   lane keeping the half of the values its lane bit selects, so the warp
//   spends V - V/32 shuffles instead of P separate 5-level trees, and lane l
//   ends with the sums of values [l * V/32, (l + 1) * V/32). Those go to
//   shared memory [warps, V]; after __syncthreads, thread p sums parameter
//   p's warps in order 0, 1, ... and steps AMSGrad with mu, nu and nu_max
//   held in its registers for all S steps; the next __syncthreads publishes
//   the new parameters. Two barriers a step (the first design had five),
//   and a fixed summation order: the result is bitwise the same call after
//   call.
// - The chunked fold, where P + 1 > 64 (ro's 83, susy's 213 values: V = 96
//   and 224 would not stay in registers, 128 a thread at 512 threads). The
//   row's x (masked), h, dz, dh and loss stay in registers (the mask moves
//   to shared memory), and its P + 1 values are generated from them in
//   packed-param order kFoldChunk = 32 at a time (fused_value), each chunk
//   folded by the same five butterfly rounds into its slice of s_red and
//   its registers reused by the next; the chunk loop is unrolled, so every
//   index is a compile-time constant and nothing goes to local memory.
//   Each sum runs over the same butterfly tree as a one-pass fold and then
//   the warps in order: a chunk only changes which lane ends up holding
//   it. SEA's and sine's instances (one fold of 64) keep their code.
// - Asynchronous batch copies. Every step's rows are known at entry, and
//   each batch is contiguous (B*F*4 bytes of x, B*4 of labels). One thread
//   issues them as TMA bulk copies (cp.async.bulk, completion counted in
//   bytes on one mbarrier per stage) into a ring of min(S, 8) stages, and
//   refills a stage for step s + stages as soon as step s has read it, so
//   global latency is paid once. Where an address or a size is not a
//   multiple of 16 bytes the bulk copy is not allowed, and a gathered
//   batch has no contiguous rows: then every thread copies its own row
//   (row0 + i, or idx[i]) with 4-byte cp.async and arrives on the same
//   mbarrier (cp.async.mbarrier.arrive.noinc).
// - No tensor cores: at H = 10 and K = 2 an mma tile would be more than
//   80 % padding. No thread-block clusters: the chain is latency-bound, and
//   a cluster barrier per step would cost more than the rows it splits.
// Shared memory (fused_layout): stages * B * (F + 1) * 4 bytes of batches
// (40 KB at SEA, 190 KB at susy), warps * V * 4 of partials, P * 4 of
// parameters (and F * 4 of the mask, chunked), 8 a stage of mbarriers; with
// the eval below, 4 * (P + F + 64) more and its window's rows. The ring
// takes min(S, 8) stages where they fit; with an eval it gives up stages,
// down to 2, until the window fits beside it (susy: 3 stages and a 76 KB
// window, 207 KB), else the window is read where it lies.
//
// K2 as the fused kernel's epilogue. Where the caller passes agg_out, the
// fused kernel also aggregates each model's round, exactly as fedavg.cu
// computes it (the masked, sample-weighted FedAvg over the C clients'
// out_params and n_out, prev = params), so a round is one launch. After its
// pair's last write each block takes a ticket of its model (an
// acquire-release atomicAdd on ticket[m]); the block that draws C - 1 is the
// model's last,
// reads the C clients' params and n through L2 (__ldcg), sums denom and each
// parameter in client order 0..C-1 with each product rounded before its add
// and w[c] = n[c] / max(denom, 1e-12) by IEEE division, keeps prev bitwise
// where denom == 0, writes the stats row (#active, 0, 0) and resets
// ticket[m] to 0 for the next launch. No block waits for another, so the
// kernel cannot deadlock at any grid size, and the result is bitwise that of
// the K1 launch followed by the fedavg.cu launch. The local-step body, its
// barriers and its reduction order are unchanged. The general kernel has no
// epilogue: on its route the caller launches fedavg.cu.
//
// K3 in the fused kernel. Where the caller also passes eval_correct, block
// (m, c) writes the eval cells (m, c, 0) and (m, c, 1): model m's INPUT
// params (kept in shared memory, since s_p changes at step 0) under its
// feature mask, on client c's rows of a two-step window (x[:, t:t + 2]),
// through fnn_eval.cuh's cell, with which eval_cells.cu's fused kernel
// computes its cells. At equal block sizes (local_sgd.py::_folds_eval) the
// cells are bitwise that kernel's. The fused round loop thus evaluates
// round r's params in round r + 1's launch. The window's rows (2N(F + 1) * 4
// bytes, 16 KB at SEA) are staged at entry by TMA bulk copies on an
// mbarrier of their own (4-byte cp.async where an address or stride is not
// 16-byte aligned; read from device memory where they would not fit), so
// they arrive while the S steps run. The eval runs after the S steps and
// before the ticket (placing it after the ticket measured slower, PERF.md).
//
// local_sgd_general_kernel<kLr, kSgd>: the widths, batches, models and
// updates the others do not take (e.g. fnn_hidden_dim = 32, the lr and SGD
// at SEA's F = 3, SGD at susy's and ro's widths, susy below B = 193 and ro
// below B = 65, or a batch the wide kernel's budget refuses). One block
// of 256 threads per pair; params (and moments) in shared memory for all S
// steps; threads over rows for the forward; a warp per parameter for the
// gradient sums (a shuffle tree, fixed order); five barriers a step (four
// for the lr). Two compile-time routes:
// - the model: the fnn, or (kLr, H = 0 on the wire) the lr of
//   models/mlp.py::LogisticRegression, packed W [F, K], b [K]: s =
//   sigmoid(x W + b) in float32 (1 / (1 + exp(-z))), whose outputs the
//   reference feeds to its cross-entropy as logits, so loss =
//   logsumexp(s) - s_y and dz = (softmax(s) - onehot(y)) * s * (1 - s) / B;
//   dW = x^T dz and db = sum dz, each a warp's sum as the fnn's dW1;
// - the update: AMSGrad after add_decayed_weights as above, or (kSgd)
//   make_optimizer("sgd") = optax.sgd(lr), p += (-lr * g) * lr_scale with
//   no weight decay, no moments and no count (mu, nu, nu_max and count
//   are not read or written; an inactive pair keeps its params).
// Its shared memory is 4 * (5P + B(H + K) + 8 + F) bytes (2P in place of
// 5P under SGD; P = F * K + K for the lr); for shapes above the 227 KB a
// block may take the entry point returns kErrSmem without a launch, and
// the wrapper raises ValueError.
//
// local_sgd_wide_kernel<kLr, kSgd, kK64>: wide inputs, MNIST-4's (F = 784;
// the fnn 784 -> 10 -> 10, P 7960, or the lr 784 -> 10, P 7850), under
// AMSGrad or SGD, contiguous or gathered batches, with feature masks: F % 4
// == 0, a first layer of at most 16 units, at most 32 classes a lane each,
// or (kK64, the fnn) up to 64 two a lane (femnist's 784 -> 10 -> 62), B <=
// 512 and its shared memory within a block's. It computes what the general
// kernel computes, in float32.
// Bound on the H100 SXM at MNIST's shape (M 4, C 10, S 5, B 500): the
// distinct batch rows of a round, each read once, and the state move ~0.13
// GB, 0.039 ms at 3.35 TB/s; the two products below are ~3.1 GFLOP a
// round, 0.047 ms at 67 TFLOP/s float32. The general kernel read each
// batch row once per hidden unit, uncoalesced, from one 256-thread block a
// pair (40 blocks for 132 SMs).
// - A pair's batch is split over a thread-block cluster of Q = ceil(B / 32)
//   CTAs (16 at B = 500, a non-portable size the H100 allows): CTA q holds
//   batch rows [32q, 32q + 32) of the step in shared memory, staged by TMA
//   bulk copies (one of F * 4 bytes a row, contiguous or gathered, counted
//   on an mbarrier) at a padded stride. x is read from device memory once a
//   step, by both products, and never uncoalesced; the next step's rows
//   land while the cluster sums and steps. A thread reads the next step's
//   row index and label early in a step, so no load is outstanding at the
//   stage or the cluster barrier.
// - The products of a step are two skinny products a pair: Z1 = (x * fm)
//   W1, [B, F] x [F, H], and dW1 = (x * fm)^T dh, [F, B] x [B, H] (the lr:
//   W and dW, [F, K]). Both run in float32 FMAs from shared memory, with
//   W1 kept transposed there so a warp's float4 loads are consecutive: the
//   forward gives a warp 8 rows and half the inputs, a lane 4 consecutive
//   inputs of every 256 for 8 rows and every unit (128 sums in
//   registers), folded over the lanes by a transpose-reduce; dW1 gives a
//   thread 4 consecutive inputs, the CTA's 32 rows summed in order for
//   every unit. (3xTF32 on the tensor cores, mma.sync m16n8k8 with H
//   padded to 16, tracked float64 no better than float32 PyTorch, and its
//   time, taken in another call than this design's, was not lower:
//   PERF.md.) The small layers, a warp 4 rows and a lane a unit or class:
//   h W2, the softmax loss and dz by shuffles, dh. Under kK64 a lane takes
//   classes lane and lane + 32: its two exponentials are summed before the
//   warp's shuffle tree, the max and the label's logit likewise.
// - Every CTA keeps all P params (its forward needs all of W1); CTA q owns
//   coordinates [q ceil(P / Q), (q + 1) ceil(P / Q)) of the cluster's order
//   (W1 transposed, then b1, W2, b2) and their moments. After the step's
//   partials over its rows (dW1, db1, dW2, db2, the loss) a cluster
//   barrier; CTA q sums its coordinates over the Q CTAs' partials in rank
//   order through distributed shared memory, four a thread as float4s (a
//   fixed order, no atomics: bitwise the same call after call), steps them
//   and writes the new values into every CTA's params; a second cluster
//   barrier publishes them. Five steps, one launch, no grid-wide sync.
// - Its shared memory is wide_smem_bytes (175 KB at MNIST's fnn: x 101 KB,
//   params and partials 31 KB each): one CTA an SM, so the card holds 7
//   clusters of 16 at once and a round of 40 pairs runs in 6 waves. The
//   waves, not the products, bound it; two CTAs an SM or a layout that
//   splits F is the next step (PERF.md). Wider inputs (cifar10's and
//   fmow's F = 3072: 32 rows of x are 394 KB) take the split kernel.
//
// local_sgd_split_kernel<kSgd>: the fnn at inputs too wide for the wide
// kernel, fmow's (F = 3072 = 32 x 32 x 3, 3072 -> 10 -> 62, P 31,412), or
// whose shared memory the wide kernel's budget refuses, stackoverflow_lr's
// under AMSGrad (1000 -> 10 -> 50: 235,600 bytes a wide CTA), under AMSGrad
// or SGD, contiguous or gathered batches, with feature masks: F % 4 == 0,
// at most 1024 inputs a CTA, 16 hidden units and 64 classes, B <= 512 and
// its shared memory within a block's. It computes what the general kernel
// computes, in float32.
// - Where F % 64 != 0 each CTA takes split_fq(F) inputs, a sixteenth of F
//   rounded up to float4s (64 at F = 1000), and the last CTA's slots past F
//   (24 there) are padding: W1's and the mask's slots there hold zeros, no
//   copy fills them, no product reads them and no step moves them, so the
//   sums over the real inputs run in the order they run where F % 64 == 0,
//   and at such an F every CTA holds F / 16 real inputs and the kernel is
//   the one it was before the padding existed.
// Bound on the H100 SXM at fmow's shape (M 4, C 10, S 5, B 500): the two
// [500, 3072] x [3072, 10] products of every step are ~12.3 GFLOP a round,
// 0.18 ms at 67 TFLOP/s float32; the distinct rows of a round (~61 MB)
// and the state take ~0.03 ms at 3.35 TB/s: operations bound it.
// - x cannot stay resident: a pair's step batch is 500 x 3072 x 4 B = 6.1
//   MB, more than a whole 16-CTA cluster's 3.6 MB of shared memory. So F
//   is split and x streams. A cluster of 16 CTAs a pair; CTA q owns inputs
//   [192q, 192q + 192) (F / 16) with their W1 slice and its moments (1920
//   coordinates at fmow), and streams its column block of the step's batch
//   through a ring of 4 tiles of 32 rows at a stride of 4 mod 8 floats: all
//   256 threads issue a tile's 16-byte cp.async copies (8 threads a row, 6
//   copies each at fmow, one row index read a tile) and arrive on the
//   stage's mbarrier as they land, from the step's row indices staged in
//   shared memory (contiguous or gathered rows alike).
//   Every row of every step is known at entry, so the ring runs ahead
//   across passes and steps, but never past the steps whose indices are
//   staged: two steps' are held, and step s + 1's are staged at the start
//   of step s (at B <= 32 a step has 2 tiles, fewer than the ring's 4
//   stages, and a tile of step s + 2 waits for that). (A first design
//   issued one 768-byte TMA bulk copy a row from warp 0: the 32 issues a
//   tile sat on every tile's critical path, and a step took ~105 us, pass
//   1 50 and pass 2 38, with ~1 us of waiting for data:
//   scripts/torch_wide_breakdown.py --kernel split, PERF.md.)
// - Each step reads x twice. Pass 1, two tiles a barrier: Z1's partials
//   over the CTA's inputs for every batch row ([B, H]; a warp an eighth of
//   the inputs, a lane a row of both tiles, W1's and the mask's broadcast
//   loads each serving both; the warps' partials summed in warp order).
//   A cluster barrier; then CTA q takes rows [32q, 32q + 32): Z1
//   summed over the 16 CTAs in rank order through distributed shared
//   memory, b1 and relu, the 62 logits two classes a lane, the loss and
//   dlogits by shuffles, dh, pushed into every CTA's dh rows; its partials
//   of the small params (db1, dW2, db2) over its rows. A second cluster
//   barrier; CTA q sums a sixteenth of the small partials over the cluster
//   in rank order, steps them with the moments it keeps and pushes the new
//   values into every CTA (read after the next step's first barrier; the
//   first design had every CTA gather all 500 dh rows and step all 692
//   small params, the same values in each). Pass 2, in reverse tile order
//   (the latest tiles are likelier still in L2): dW1's slice = (x * fm)^T
//   dh, a thread one input quad and a row group, the row groups summed in
//   order; the slice steps in place. Its dW1 needs no cluster sum: the CTA
//   holds every row of its inputs. Two cluster barriers a step, fixed
//   orders, no atomics: bitwise the same call after call, and bitwise the
//   first design (the sums in the same orders).
//   (A design with both products on the tensor cores in 3xTF32 took 2.50
//   ms a round against 2.88 and sat nearer float64 than this one, but its
//   rounding moved two of fmow's four runs out of their gates: PERF.md.)
// - L2 (50 MB) holds a pair's 6.1 MB between the two passes only while few
//   clusters run at once (8 clusters of 6.1 MB are 49 MB); the pairs of one
//   client are scheduled side by side, so with B = N the models that drew
//   the same step read the same rows.
// - Its shared memory is split_smem_bytes: 215,808 bytes at fmow under
//   AMSGrad (x ring 100 KB, the forward's partials 20 KB, W1's slice and
//   moments 30 KB, dh and Z1's partials of every row 44 KB, the small
//   params and partials and the moments of a sixteenth of them 6 KB, own
//   rows' h and dz 9 KB, two steps' row indices 4 KB): one CTA an SM, so
//   the card holds 7 clusters of 16 at once (cudaOccupancyMaxActiveClusters).

#include <cuda_runtime.h>
#include <stdint.h>

#include <cooperative_groups.h>

#include <atomic>
#include <climits>

#include "bulk_copy.cuh"
#include "fnn_eval.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxSmem = 232448;
constexpr int kErrSmem = -1;  // local_sgd.py's _ERR_SMEM
constexpr int kGeneralThreads = 256;
constexpr int kGeneralWarps = kGeneralThreads / 32;
constexpr int kFusedMaxThreads = 512;
constexpr int kStages = 8;    // batch stages of the fused kernel's ring
constexpr int kMinStages = 2;  // at least, where an eval window wants room
// the fused kernel's fold: P + 1 values up to kFoldOne fold at once (SEA's,
// sine's), more kFoldChunk at a time (susy's, ro's)
constexpr int kFoldOne = 64;
constexpr int kFoldChunk = 32;
constexpr int kAggBatch = 16;  // loads in flight a thread in the epilogue
// the fused kernel's mbarriers (the ring's, then the eval window's), padded
// to keep the batch stages 16-byte aligned
constexpr int kBarBytes = 8 * (kStages + 2);
// how the fused kernel reads the eval window's rows (fused_kernel's emode)
constexpr int kEvalNone = 0, kEvalBulk = 1, kEvalCopies = 2, kEvalGlobal = 3;

struct Args {
  const float* x;        // [C, T1, N, F]
  const int* y;          // [C, T1, N]
  const float* params;   // [M, P]
  float* mu;             // [M, C, P], updated in place
  float* nu;             // [M, C, P], updated in place
  float* nu_max;         // [M, C, P], updated in place
  int* count;            // [M, C], updated in place
  const int* t_idx;      // [M, C, S], or null with idx
  const int* slot;       // [M, C, S], or null with idx
  const int* idx;        // [M, C, S, B] rows of a gathered batch, or null
  const float* fmask;    // [M, F] feature masks, or null (ones)
  const float* total_w;  // [M, C]
  float* out_params;     // [M, C, P]
  float* n_out;          // [M, C]
  float* loss_out;       // [M, C]
  float* agg_out;        // [M, P] the aggregated params, or null (no epilogue)
  float* stats_out;      // [M, 3] the aggregation stats (with agg_out)
  int* ticket;           // [M] zeros between launches (with agg_out)
  // the eval of the input params (fused kernel with agg_out only): rows
  // [N, F] at ex + c * exs_c + g * exs_g, labels [N] at ey + c * eys_c +
  // g * eys_g for the window's steps g = 0, 1; eval_correct null: no eval
  const float* ex;
  const int* ey;
  int* eval_correct;     // [M, C, 2]
  float* eval_nll;       // [M, C, 2]
  long long exs_c, exs_g, eys_c, eys_g;
  int C, T1, N, F, H, K, B, S;
  float neg_lr, wd, lr_scale, b1, b2, one_minus_b1, one_minus_b2, eps;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// One coordinate's update from its gradient g: optax.sgd (scale by the
// learning rate, then the reference's lr_scale), or add_decayed_weights,
// scale_by_amsgrad (bias corrections bc1, bc2 of this step's count), the
// learning rate and lr_scale; the moments in place. Every kernel here
// steps its coordinates through it.
template <bool kSgd>
__device__ __forceinline__ float step_coord(const Args& a, float w, float g,
                                            float& mu, float& nu, float& vmax,
                                            float bc1, float bc2) {
  if constexpr (kSgd) {
    return w + (a.neg_lr * g) * a.lr_scale;
  } else {
    const float gd = g + a.wd * w;
    mu = a.one_minus_b1 * gd + a.b1 * mu;
    nu = a.one_minus_b2 * (gd * gd) + a.b2 * nu;
    vmax = fnn_eval::max_nan(vmax, nu / bc2);
    const float u = (mu / bc1) / (sqrtf(vmax) + a.eps);
    return w + (a.neg_lr * u) * a.lr_scale;
  }
}

// ---------------------------------------------------------------------------
// The general kernel (any width; the fnn or the lr; AMSGrad or SGD).

// Arrays of P floats a pair keeps in shared memory: params, gradient and,
// under AMSGrad, mu, nu and nu_max.
__host__ __device__ constexpr int state_arrays(bool sgd) { return sgd ? 2 : 5; }

template <bool kLr, bool kSgd>
__global__ void __launch_bounds__(kGeneralThreads)
local_sgd_general_kernel(Args a) {
  extern __shared__ float smem[];
  const int F = a.F, H = a.H, K = a.K, B = a.B, N = a.N;
  const int P = kLr ? F * K + K : F * H + H + H * K + K;
  const int oB1 = F * H, oW2 = oB1 + H, oB2 = oW2 + H * K;
  float* s_p = smem;                // [P] params
  float* s_g = s_p + P;             // [P] gradient
  float* s_mu = s_g + P;            // [P] each, AMSGrad only
  float* s_nu = s_mu + P;
  float* s_vmax = s_nu + P;
  float* s_h = s_p + state_arrays(kSgd) * P;  // [B, H] activations, then dh
  float* s_z = s_h + B * H;         // [B, K] logits, then dlogits
  float* s_red = s_z + B * K;       // [kGeneralWarps] loss partials
  float* s_fm = s_red + kGeneralWarps;  // [F] model m's feature mask

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int pair = blockIdx.x;
  const int m = pair / a.C, c = pair % a.C;
  const float* pm = a.params + (size_t)m * P;
  const size_t so = (size_t)pair * P;
  for (int p = tid; p < P; p += kGeneralThreads) {
    s_p[p] = pm[p];
    if constexpr (!kSgd) {
      s_mu[p] = a.mu[so + p];
      s_nu[p] = a.nu[so + p];
      s_vmax[p] = a.nu_max[so + p];
    }
  }
  for (int f = tid; f < F; f += kGeneralThreads)
    s_fm[f] = a.fmask ? a.fmask[(size_t)m * F + f] : 1.f;
  const float* xc = a.x + (size_t)c * a.T1 * N * F;
  const int* yc = a.y + (size_t)c * a.T1 * N;
  const float inv_b = 1.0f / (float)B;
  int count = kSgd ? 0 : a.count[pair];
  float loss_sum = 0.f;             // thread 0's sum of the S step losses
  __syncthreads();

  for (int s = 0; s < a.S; ++s) {
    // batch row i of this step: a gathered row, or row0 + i
    const int* ib = a.idx ? a.idx + ((size_t)pair * a.S + s) * B : nullptr;
    const size_t row0 = ib ? 0
                           : (size_t)a.t_idx[pair * a.S + s] * N
                             + (size_t)a.slot[pair * a.S + s] * B;
    auto row = [&](int i) { return ib ? (size_t)ib[i] : row0 + i; };

    // forward, loss and dlogits: threads over rows
    float part = 0.f;
    for (int i = tid; i < B; i += kGeneralThreads) {
      const float* xr = xc + row(i) * F;
      float zmax = -INFINITY;
      if constexpr (kLr) {
        // s_k = sigmoid(x W[:, k] + b_k): the outputs the loss takes
        for (int k = 0; k < K; ++k) {
          float acc = 0.f;
          for (int f = 0; f < F; ++f)
            acc = fmaf(xr[f] * s_fm[f], s_p[f * K + k], acc);
          acc += s_p[F * K + k];
          const float sk = 1.f / (1.f + expf(-acc));
          s_z[i * K + k] = sk;
          zmax = fnn_eval::max_nan(zmax, sk);
        }
      } else {
        for (int j = 0; j < H; ++j) {
          float acc = 0.f;
          for (int f = 0; f < F; ++f)
            acc = fmaf(xr[f] * s_fm[f], s_p[f * H + j], acc);
          acc += s_p[oB1 + j];
          s_h[i * H + j] = fnn_eval::relu_select(acc);
        }
        for (int k = 0; k < K; ++k) {
          float z = 0.f;
          for (int j = 0; j < H; ++j)
            z = fmaf(s_h[i * H + j], s_p[oW2 + j * K + k], z);
          z += s_p[oB2 + k];
          s_z[i * K + k] = z;
          zmax = fnn_eval::max_nan(zmax, z);
        }
      }
      float se = 0.f;
      for (int k = 0; k < K; ++k) se += expf(s_z[i * K + k] - zmax);
      const int yi = yc[row(i)];
      part += logf(se) - (s_z[i * K + yi] - zmax);
      for (int k = 0; k < K; ++k) {
        const float z = s_z[i * K + k];
        const float d = (expf(z - zmax) / se - (k == yi ? 1.f : 0.f)) * inv_b;
        // the lr: through the sigmoid, ds/dz = s (1 - s)
        s_z[i * K + k] = kLr ? d * (z * (1.f - z)) : d;
      }
    }
    part = warp_sum(part);
    if (lane == 0) s_red[warp] = part;
    __syncthreads();
    if (tid == 0) {
      float tot = 0.f;
      for (int w = 0; w < kGeneralWarps; ++w) tot += s_red[w];
      loss_sum += tot * inv_b;
    }

    if constexpr (kLr) {
      // dW = x^T dz, db = sum dz: a warp per parameter
      for (int q = warp; q < F * K + K; q += kGeneralWarps) {
        float acc = 0.f;
        if (q < F * K) {
          const int f = q / K, k = q % K;
          for (int i = lane; i < B; i += 32)
            acc = fmaf(xc[row(i) * F + f] * s_fm[f], s_z[i * K + k], acc);
        } else {
          const int k = q - F * K;
          for (int i = lane; i < B; i += 32) acc += s_z[i * K + k];
        }
        acc = warp_sum(acc);
        if (lane == 0) s_g[q] = acc;
      }
      __syncthreads();
    } else {
      // dW2 = h^T dz, db2 = sum dz: a warp per parameter
      for (int q = warp; q < H * K + K; q += kGeneralWarps) {
        float acc = 0.f;
        if (q < H * K) {
          const int j = q / K, k = q % K;
          for (int i = lane; i < B; i += 32)
            acc = fmaf(s_h[i * H + j], s_z[i * K + k], acc);
        } else {
          const int k = q - H * K;
          for (int i = lane; i < B; i += 32) acc += s_z[i * K + k];
        }
        acc = warp_sum(acc);
        if (lane == 0) s_g[oW2 + q] = acc;
      }
      __syncthreads();

      // dh = (dz W2^T) * (h > 0), over the activations
      for (int i = tid; i < B; i += kGeneralThreads) {
        for (int j = 0; j < H; ++j) {
          float d = 0.f;
          if (s_h[i * H + j] > 0.f)
            for (int k = 0; k < K; ++k)
              d = fmaf(s_z[i * K + k], s_p[oW2 + j * K + k], d);
          s_h[i * H + j] = d;
        }
      }
      __syncthreads();

      // dW1 = x^T dh, db1 = sum dh: a warp per parameter
      for (int q = warp; q < F * H + H; q += kGeneralWarps) {
        float acc = 0.f;
        if (q < F * H) {
          const int f = q / H, j = q % H;
          for (int i = lane; i < B; i += 32)
            acc = fmaf(xc[row(i) * F + f] * s_fm[f], s_h[i * H + j], acc);
        } else {
          const int j = q - F * H;
          for (int i = lane; i < B; i += 32) acc += s_h[i * H + j];
        }
        acc = warp_sum(acc);
        if (lane == 0) s_g[q] = acc;
      }
      __syncthreads();
    }

    if constexpr (!kSgd) count = count < INT_MAX ? count + 1 : count;
    const float bc1 = kSgd ? 1.f : 1.f - powf(a.b1, (float)count);
    const float bc2 = kSgd ? 1.f : 1.f - powf(a.b2, (float)count);
    for (int p = tid; p < P; p += kGeneralThreads) {
      float mu = 0.f, nu = 0.f, vmax = 0.f;
      if constexpr (!kSgd) mu = s_mu[p], nu = s_nu[p], vmax = s_vmax[p];
      s_p[p] = step_coord<kSgd>(a, s_p[p], s_g[p], mu, nu, vmax, bc1, bc2);
      if constexpr (!kSgd) s_mu[p] = mu, s_nu[p] = nu, s_vmax[p] = vmax;
    }
    __syncthreads();
  }

  const float tw = a.total_w[pair];
  const bool active = tw > 0.f;
  float* op = a.out_params + so;
  for (int p = tid; p < P; p += kGeneralThreads) {
    op[p] = active ? s_p[p] : pm[p];
    if (!kSgd && active) {
      a.mu[so + p] = s_mu[p];
      a.nu[so + p] = s_nu[p];
      a.nu_max[so + p] = s_vmax[p];
    }
  }
  if (tid == 0) {
    if (!kSgd && active) a.count[pair] = count;
    a.n_out[pair] = active ? tw * (float)N : 0.f;
    a.loss_out[pair] = loss_sum / (float)a.S;
  }
}

// Shared memory one block of the general kernel needs for these sizes
// (H = 0: the lr).
long long general_smem_bytes(int F, int H, int K, int B, bool sgd) {
  const long long P = H ? (long long)F * H + H + (long long)H * K + K
                        : (long long)F * K + K;
  return 4 * (state_arrays(sgd) * P + (long long)B * (H + K) + kGeneralWarps
              + F);
}

// One butterfly round of the transpose-reduce: lanes with bit O set keep
// the upper half of their HALF * 2 values, the others the lower half, and
// each adds its partner's copy of the half it keeps.
template <int O, int HALF, int V>
__device__ __forceinline__ void fold(float (&v)[V], int lane) {
  const bool upper = (lane & O) != 0;
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
    const float send = upper ? v[i] : v[i + HALF];
    const float keep = upper ? v[i + HALF] : v[i];
    v[i] = keep + __shfl_xor_sync(kFull, send, O);
  }
}

// ---------------------------------------------------------------------------
// The wide kernel (MNIST's widths; the fnn or the lr; AMSGrad or SGD).

namespace cg = cooperative_groups;

constexpr int kWideRows = 32;        // batch rows a CTA holds: two m16 tiles
constexpr int kWideThreads = 256;
constexpr int kWideWarps = kWideThreads / 32;
constexpr int kWideMaxCluster = 16;  // CTAs a pair (non-portable above 8)
constexpr int kWideMaxWidth = 16;    // units of the first layer at most

// x's row stride in shared memory, in floats: the least multiple of 4 at or
// above F that is 4 (mod 8), so the eight rows of an A fragment fall in
// eight different bank quads, and a row stays 16-byte aligned.
__host__ __device__ constexpr int wide_stride(int F) {
  return (F + 3) / 4 * 4 % 8 == 4 ? (F + 3) / 4 * 4 : (F + 3) / 4 * 4 + 4;
}

// CTAs of a pair's cluster at batch B: one a kWideRows rows.
__host__ __device__ constexpr int wide_cluster(int B) {
  return (B + kWideRows - 1) / kWideRows;
}

// The owned slice of the params: ceil(P / Q) rounded up to whole float4s.
__host__ __device__ constexpr int wide_chunk(int P, int Q) {
  return ((P + Q - 1) / Q + 3) / 4 * 4;
}

// Shared memory one CTA of the wide kernel needs (H = 0: the lr), in floats
// after the 16-byte mbarrier: x's rows, the params and the gradient
// partials (also the forward's two partials), each padded to float4s, the
// owned slice of the three moments, the feature mask, h, dh (the lr: dz),
// the fnn's dz, the labels and the warps' losses.
long long wide_smem_bytes(int F, int H, int K, int B, bool sgd) {
  const long long P = H ? (long long)F * H + H + (long long)H * K + K
                        : (long long)F * K + K;
  const long long PP = (P + 3) / 4 * 4;
  const long long parts = 2LL * kWideRows * kWideMaxWidth;
  const long long floats =
      (long long)kWideRows * wide_stride(F) + PP + (PP > parts ? PP : parts)
      + (sgd ? 0 : 3LL * wide_chunk((int)P, wide_cluster(B))) + F
      + 2LL * kWideRows * kWideMaxWidth + (H ? kWideRows * K : 0)
      + kWideRows + kWideWarps + 4;
  return 16 + 4 * floats;
}

template <bool kLr, bool kSgd, bool kK64>
__global__ void __launch_bounds__(kWideThreads, 1)
local_sgd_wide_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int F = a.F, H = a.H, K = a.K, B = a.B, N = a.N, S = a.S;
  const int L1 = kLr ? K : H;                   // the first layer's width
  constexpr int L1P = kWideMaxWidth;            // its row stride in h, dh
  const int P = kLr ? F * K + K : F * H + H + H * K + K;
  const int PP = (P + 3) / 4 * 4;
  const int oB1 = F * L1, oW2 = oB1 + H, oB2 = oW2 + H * K;
  const int XS = wide_stride(F);
  const int Q = (int)cluster.num_blocks();
  const int chunk = wide_chunk(P, Q);
  const int parts = 2 * kWideRows * kWideMaxWidth;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem_raw);
  float* s_x = reinterpret_cast<float*>(smem_raw + 16);  // [rows][XS]
  float* s_p = s_x + kWideRows * XS;            // [PP] the params, in the
                                                // cluster's order
  float* s_g = s_p + PP;                        // [max(PP, parts)] partials
  float* s_mu = s_g + (PP > parts ? PP : parts);  // [chunk] each, AMSGrad
  float* s_nu = s_mu + chunk;
  float* s_vmax = s_nu + chunk;
  float* s_fm = s_mu + (kSgd ? 0 : 3 * chunk);  // [F]
  float* s_h = s_fm + F;                        // [rows][L1P] h (fnn)
  float* s_d = s_h + kWideRows * L1P;           // [rows][L1P] dh, dz (lr)
  float* s_z = s_d + kWideRows * L1P;           // [rows][K] dz (fnn)
  int* s_y = reinterpret_cast<int*>(s_z + (kLr ? 0 : kWideRows * K));
  float* s_wl = reinterpret_cast<float*>(s_y + kWideRows);  // [warps]
  float* s_loss = s_wl + kWideWarps;            // [1] this CTA's loss sum

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q = (int)cluster.block_rank();
  const int pair = blockIdx.x / Q;
  const int m = pair / a.C, c = pair % a.C;
  const int r0 = q * kWideRows;                 // this CTA's batch rows
  const int nrows = min(kWideRows, B - r0);
  const int lo = min(P, q * chunk), hi = min(P, lo + chunk);  // owned coords
  const float* pm = a.params + (size_t)m * P;
  const size_t so = (size_t)pair * P;
  const float* xc = a.x + (size_t)c * a.T1 * N * F;
  const int* yc = a.y + (size_t)c * a.T1 * N;

  // The cluster's order of the params: W1 transposed first (coordinate
  // j * F + f is W1[f][j]: unit j's weights contiguous over the inputs),
  // then the small params as packed. Coordinate i's index in the packed
  // params:
  auto param_of = [&](int i) { return i < oB1 ? (i % F) * L1 + i / F : i; };

  for (int p = tid; p < P; p += kWideThreads)
    s_p[p < oB1 ? (p % L1) * F + p / L1 : p] = pm[p];
  for (int f = tid; f < F; f += kWideThreads)
    s_fm[f] = a.fmask ? a.fmask[(size_t)m * F + f] : 1.f;
  if constexpr (!kSgd) {
    for (int i = lo + tid; i < hi; i += kWideThreads) {
      const int p = param_of(i);
      s_mu[i - lo] = a.mu[so + p];
      s_nu[i - lo] = a.nu[so + p];
      s_vmax[i - lo] = a.nu_max[so + p];
    }
  }
  // rows past the batch stay zero (they add nothing to x^T dh), with label 0
  for (int i = nrows * XS + tid; i < kWideRows * XS; i += kWideThreads)
    s_x[i] = 0.f;
  if (tid >= nrows && tid < kWideRows) s_y[tid] = 0;
  if (tid == 0) {
    mbar_init(bar, (unsigned)nrows);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // Thread i < nrows stages batch row r0 + i of each step: one TMA bulk
  // copy of F * 4 bytes, arriving on the barrier. The next step's row index
  // is read at the start of a step and its label after the forward, so the
  // loads have landed before the stage and the cluster barrier.
  auto row_of = [&](int s) -> size_t {
    return a.idx ? (size_t)a.idx[((size_t)pair * S + s) * B + r0 + tid]
                 : (size_t)a.t_idx[pair * S + s] * N
                   + (size_t)a.slot[pair * S + s] * B + r0 + tid;
  };
  size_t row_next = tid < nrows ? row_of(0) : 0;
  int y_next = tid < nrows ? yc[row_next] : 0;
  auto stage = [&]() {
    if (tid >= nrows) return;
    fence_proxy_async();
    mbar_expect_tx(bar, (unsigned)(F * 4));
    bulk_copy(s_x + (size_t)tid * XS, xc + row_next * F, (unsigned)(F * 4),
              bar);
  };
  stage();

  const float inv_b = 1.0f / (float)B;
  int count = kSgd ? 0 : a.count[pair];
  float loss_sum = 0.f;             // rank 0's thread 0: the S step losses
  for (int s = 0; s < S; ++s) {
    const bool ahead = tid < nrows && s + 1 < S;
    if (tid < nrows) s_y[tid] = y_next;
    if (ahead) row_next = row_of(s + 1);
    mbar_wait(bar, (unsigned)s & 1u);

    // (1) the first layer, (x * fm) W, in float32 FMAs: warp w takes rows
    // 8 (w % 4) .. + 7 and half the inputs, a lane the 4 inputs from f =
    // 128 (w / 4) + 4 lane + 256 k on (float4 loads of x, the mask and W's
    // transposed rows), summing them in order for 8 rows and every unit
    // (128 sums in registers); a transpose-reduce folds the lanes (five
    // butterfly rounds, each lane keeping half its values), and the two
    // warps of a row block leave their sums in s_g, [half][row][L1P]
    {
      float v[8 * L1P];
#pragma unroll
      for (int i = 0; i < 8 * L1P; ++i) v[i] = 0.f;
      const float* xr = s_x + 8 * (warp & 3) * XS;
      for (int f = 128 * (warp >> 2) + 4 * lane; f < F; f += 256) {
        const float4 mf = *reinterpret_cast<const float4*>(s_fm + f);
        float4 xv[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float4 xq = *reinterpret_cast<const float4*>(xr + i * XS + f);
          xv[i] = make_float4(xq.x * mf.x, xq.y * mf.y, xq.z * mf.z,
                              xq.w * mf.w);
        }
#pragma unroll
        for (int j = 0; j < L1P; ++j) {
          if (j >= L1) break;
          const float4 wq = *reinterpret_cast<const float4*>(s_p + j * F + f);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            float acc = v[i * L1P + j];
            acc = fmaf(xv[i].x, wq.x, acc);
            acc = fmaf(xv[i].y, wq.y, acc);
            acc = fmaf(xv[i].z, wq.z, acc);
            v[i * L1P + j] = fmaf(xv[i].w, wq.w, acc);
          }
        }
      }
      fold<16, 4 * L1P>(v, lane);
      fold<8, 2 * L1P>(v, lane);
      fold<4, L1P>(v, lane);
      fold<2, L1P / 2>(v, lane);
      fold<1, L1P / 4>(v, lane);
      // lane l holds values [4l, 4l + 4): row l / 4 of the block, units
      // 4 (l % 4) .. + 3
      float* o = s_g + ((warp >> 2) * kWideRows + 8 * (warp & 3) + (lane >> 2))
                       * L1P + 4 * (lane & 3);
#pragma unroll
      for (int i = 0; i < 4; ++i) o[i] = v[i];
    }
    if (ahead) y_next = yc[row_next];
    __syncthreads();

    // (2) a warp four rows (w, w + 8, w + 16, w + 24), side by side so
    // their shuffles overlap, and a lane a unit or a class: the two halves'
    // sums in order, the bias and the activation (the lr: the sigmoid, its
    // logits); the fnn's second layer; the loss and dlogits through
    // shuffles (the lr's dz through ds/dz = s (1 - s)); the fnn's dh =
    // (dz W2^T) * (h > 0). Rows past the batch get dlogits 0 and no loss.
    {
      constexpr int R = kWideRows / kWideWarps;
      float hj[R], z[R];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int r = warp + i * kWideWarps;
        hj[i] = 0.f;
        if (lane < L1) {
          float v = s_g[r * L1P + lane] + s_g[(kWideRows + r) * L1P + lane];
          v += s_p[oB1 + lane];
          hj[i] = kLr ? 1.f / (1.f + expf(-v)) : fnn_eval::relu_select(v);
          if (!kLr) s_h[r * L1P + lane] = hj[i];
        }
        z[i] = hj[i];               // the logit of class `lane`
      }
      // kK64: a lane's second class, lane + 32 (z2, e2, d2)
      const int c2 = lane + 32;
      float z2[R];
      if constexpr (!kLr) {
        float acc[R], acc2[R];
#pragma unroll
        for (int i = 0; i < R; ++i) acc[i] = acc2[i] = 0.f;
        for (int j = 0; j < H; ++j) {
          const float w2 = lane < K ? s_p[oW2 + j * K + lane] : 0.f;
          float w22 = 0.f;
          if constexpr (kK64) w22 = c2 < K ? s_p[oW2 + j * K + c2] : 0.f;
#pragma unroll
          for (int i = 0; i < R; ++i) {
            const float hb = __shfl_sync(kFull, hj[i], j);
            acc[i] = fmaf(hb, w2, acc[i]);
            if constexpr (kK64) acc2[i] = fmaf(hb, w22, acc2[i]);
          }
        }
        const float b2 = lane < K ? s_p[oB2 + lane] : 0.f;
#pragma unroll
        for (int i = 0; i < R; ++i) z[i] = lane < K ? acc[i] + b2 : 0.f;
        if constexpr (kK64) {
          const float b22 = c2 < K ? s_p[oB2 + c2] : 0.f;
#pragma unroll
          for (int i = 0; i < R; ++i) z2[i] = c2 < K ? acc2[i] + b22 : 0.f;
        }
      }
      float zmax[R], se[R], e[R], d[R], e2[R], d2[R];
#pragma unroll
      for (int i = 0; i < R; ++i) zmax[i] = lane < K ? z[i] : -INFINITY;
      if constexpr (kK64) {
#pragma unroll
        for (int i = 0; i < R; ++i)
          if (c2 < K) zmax[i] = fnn_eval::max_nan(zmax[i], z2[i]);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
#pragma unroll
        for (int i = 0; i < R; ++i)
          zmax[i] = fnn_eval::max_nan(zmax[i],
                                      __shfl_xor_sync(kFull, zmax[i], o));
#pragma unroll
      for (int i = 0; i < R; ++i)
        se[i] = e[i] = lane < K ? expf(z[i] - zmax[i]) : 0.f;
      if constexpr (kK64) {
#pragma unroll
        for (int i = 0; i < R; ++i) {
          e2[i] = c2 < K ? expf(z2[i] - zmax[i]) : 0.f;
          se[i] += e2[i];
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
#pragma unroll
        for (int i = 0; i < R; ++i) se[i] += __shfl_xor_sync(kFull, se[i], o);
      float wl = 0.f;               // lane 0: this warp's rows' losses
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int r = warp + i * kWideWarps;
        const bool live = r < nrows;
        const int yi = s_y[r];
        float zy;
        if constexpr (kK64)
          zy = __shfl_sync(kFull, yi < 32 ? z[i] : z2[i], yi & 31);
        else
          zy = __shfl_sync(kFull, z[i], yi);
        d[i] = lane < K && live
                   ? (e[i] / se[i] - (lane == yi ? 1.f : 0.f)) * inv_b : 0.f;
        if constexpr (kLr) {
          if (lane < K) s_d[r * L1P + lane] = d[i] * (z[i] * (1.f - z[i]));
        } else {
          if (lane < K) s_z[r * K + lane] = d[i];
        }
        if constexpr (kK64) {
          d2[i] = c2 < K && live
                      ? (e2[i] / se[i] - (c2 == yi ? 1.f : 0.f)) * inv_b
                      : 0.f;
          if (c2 < K) s_z[r * K + c2] = d2[i];
        }
        if (live) wl += logf(se[i]) - (zy - zmax[i]);
      }
      if constexpr (!kLr) {
        float dh[R];
#pragma unroll
        for (int i = 0; i < R; ++i) dh[i] = 0.f;
        for (int k = 0; k < K; ++k) {
          const float w2 = lane < H ? s_p[oW2 + lane * K + k] : 0.f;
#pragma unroll
          for (int i = 0; i < R; ++i) {
            float dk;
            if constexpr (kK64)
              dk = __shfl_sync(kFull, k < 32 ? d[i] : d2[i], k & 31);
            else
              dk = __shfl_sync(kFull, d[i], k);
            dh[i] = fmaf(dk, w2, dh[i]);
          }
        }
#pragma unroll
        for (int i = 0; i < R; ++i)
          if (lane < H)
            s_d[(warp + i * kWideWarps) * L1P + lane] =
                hj[i] > 0.f ? dh[i] : 0.f;
      }
      if (lane == 0) s_wl[warp] = wl;
    }
    __syncthreads();

    // (3) the small partials over the CTA's rows (the fnn: dW2 = h^T dz,
    // db2, db1; the lr: db), the loss, and dW1 = (x * fm)^T dh (the lr: dW)
    // in float32 FMAs: thread t takes inputs 4t .. 4t + 3 (and 1024 on),
    // summing the CTA's rows in order for every unit, and leaves them in
    // the cluster's order (unit j's at j * F + f)
    if (tid == 0) {
      float l = 0.f;
      for (int w = 0; w < kWideWarps; ++w) l += s_wl[w];
      *s_loss = l;
    }
    {
      // from the last thread down: dW1 below leaves the last threads idle
      const int small = kLr ? K : H * K + K + H;
      for (int e = kWideThreads - 1 - tid; e < small; e += kWideThreads) {
        float acc = 0.f;
        if (kLr || e >= H * K + K) {            // db1 (the lr: db)
          const int j = kLr ? e : e - H * K - K;
#pragma unroll 4
          for (int r = 0; r < nrows; ++r) acc += s_d[r * L1P + j];
          s_g[oB1 + j] = acc;
        } else if (e < H * K) {                 // dW2
          const int j = e / K, k = e - j * K;
#pragma unroll 4
          for (int r = 0; r < nrows; ++r)
            acc = fmaf(s_h[r * L1P + j], s_z[r * K + k], acc);
          s_g[oW2 + e] = acc;
        } else {                                // db2
#pragma unroll 4
          for (int r = 0; r < nrows; ++r) acc += s_z[r * K + e - H * K];
          s_g[oW2 + e] = acc;
        }
      }
    }
    for (int f = 4 * tid; f < F; f += 4 * kWideThreads) {
      float v[4][L1P];
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int j = 0; j < L1P; ++j) v[k][j] = 0.f;
      const float4 mf = *reinterpret_cast<const float4*>(s_fm + f);
#pragma unroll 4
      for (int r = 0; r < nrows; ++r) {
        const float4 xq = *reinterpret_cast<const float4*>(s_x + r * XS + f);
        const float xv[4] = {xq.x * mf.x, xq.y * mf.y, xq.z * mf.z,
                             xq.w * mf.w};
        const float4* dr = reinterpret_cast<const float4*>(s_d + r * L1P);
#pragma unroll
        for (int j4 = 0; j4 < L1P / 4; ++j4) {
          if (4 * j4 >= L1) break;
          const float4 dv = dr[j4];
          const float dj[4] = {dv.x, dv.y, dv.z, dv.w};
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
#pragma unroll
            for (int k = 0; k < 4; ++k)
              v[k][4 * j4 + jj] = fmaf(xv[k], dj[jj], v[k][4 * j4 + jj]);
        }
      }
#pragma unroll
      for (int j = 0; j < L1P; ++j) {
        if (j >= L1) break;
        *reinterpret_cast<float4*>(s_g + j * F + f) =
            make_float4(v[0][j], v[1][j], v[2][j], v[3][j]);
      }
    }
    __syncthreads();
    // every read of s_x is done: the next step's rows land while the
    // cluster sums and steps
    if (s + 1 < S) stage();

    // (4) the cluster: every CTA's partials are visible after the sync;
    // CTA q sums coordinates [lo, hi) over the CTAs in rank order, four a
    // thread as float4s through distributed shared memory, steps them and
    // writes the new values into every CTA's params
    cluster.sync();
    if (q == 0 && tid == 0) {
      float tot = 0.f;
      for (int r = 0; r < Q; ++r) tot += *cluster.map_shared_rank(s_loss, r);
      loss_sum += tot * inv_b;
    }
    if constexpr (!kSgd) count = count < INT_MAX ? count + 1 : count;
    const float bc1 = kSgd ? 1.f : 1.f - powf(a.b1, (float)count);
    const float bc2 = kSgd ? 1.f : 1.f - powf(a.b2, (float)count);
    for (int p = lo + 4 * tid; p < hi; p += 4 * kWideThreads) {
      const int n = min(4, hi - p);
      float4 part[kWideMaxCluster];
#pragma unroll
      for (int r = 0; r < kWideMaxCluster; ++r) {
        if (r >= Q) break;
        const float* src = cluster.map_shared_rank(s_g + p, r);
        if (n == 4) {
          part[r] = *reinterpret_cast<const float4*>(src);
        } else {
          part[r] = make_float4(src[0], n > 1 ? src[1] : 0.f,
                                n > 2 ? src[2] : 0.f, 0.f);
        }
      }
      float g[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int r = 0; r < kWideMaxCluster; ++r) {
        if (r >= Q) break;
        g[0] += part[r].x;
        g[1] += part[r].y;
        g[2] += part[r].z;
        g[3] += part[r].w;
      }
      float wn[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (i >= n) break;
        const int o = p - lo + i;
        float mu = 0.f, nu = 0.f, vmax = 0.f;
        if constexpr (!kSgd) mu = s_mu[o], nu = s_nu[o], vmax = s_vmax[o];
        wn[i] = step_coord<kSgd>(a, s_p[p + i], g[i], mu, nu, vmax, bc1, bc2);
        if constexpr (!kSgd) s_mu[o] = mu, s_nu[o] = nu, s_vmax[o] = vmax;
      }
      if (s + 1 < S) {
#pragma unroll
        for (int r = 0; r < kWideMaxCluster; ++r) {
          if (r >= Q) break;
          float* dst = cluster.map_shared_rank(s_p + p, r);
          if (n == 4) {
            *reinterpret_cast<float4*>(dst) =
                make_float4(wn[0], wn[1], wn[2], wn[3]);
          } else {
            for (int i = 0; i < n; ++i) dst[i] = wn[i];
          }
        }
      } else {
        for (int i = 0; i < n; ++i) s_p[p + i] = wn[i];  // written out below
      }
    }
    // the new params are in every CTA, and no CTA reads another's
    // partials any more
    cluster.sync();
  }

  const float tw = a.total_w[pair];
  const bool active = tw > 0.f;
  float* op = a.out_params + so;
  for (int i = lo + tid; i < hi; i += kWideThreads) {
    const int p = param_of(i);
    op[p] = active ? s_p[i] : pm[p];
    if (!kSgd && active) {
      a.mu[so + p] = s_mu[i - lo];
      a.nu[so + p] = s_nu[i - lo];
      a.nu_max[so + p] = s_vmax[i - lo];
    }
  }
  if (q == 0 && tid == 0) {
    if (!kSgd && active) a.count[pair] = count;
    a.n_out[pair] = active ? tw * (float)N : 0.f;
    a.loss_out[pair] = loss_sum / (float)S;
  }
}

// ---------------------------------------------------------------------------
// The fused kernel's asynchronous copies (sm_90: TMA bulk copies, mbarrier;
// the helpers in bulk_copy.cuh).

__device__ __forceinline__ void copy4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void copy16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void copies_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];"
               :: "r"(smem_addr(bar)) : "memory");
}

// The epilogue's ticket: atomicAdd(p, 1) with acquire-release semantics at
// device scope; returns the old value.
__device__ __forceinline__ int ticket_add(int* p) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;"
               : "=r"(old) : "l"(p) : "memory");
  return old;
}

// Start the copies of step s's batch into ring stage `st`: x rows [B, F]
// and labels [B]. Bulk (contiguous batches only): thread 0 alone, the
// stage's mbarrier expecting the bytes (its count is 1). Otherwise: thread
// i copies batch row i (row0 + i, or the gathered row idx[i]) and every
// thread arrives (the count is the block's size).
template <int F>
__device__ __forceinline__ void stage_batch(const Args& a, const float* xc,
                                            const int* yc, int pair, int s,
                                            int st, bool bulk, float* s_x,
                                            int* s_y, uint64_t* bars) {
  const int B = a.B;
  const int* ib = a.idx ? a.idx + ((size_t)pair * a.S + s) * B : nullptr;
  const size_t row0 = ib ? 0
                         : (size_t)a.t_idx[pair * a.S + s] * a.N
                           + (size_t)a.slot[pair * a.S + s] * B;
  float* dx = s_x + (size_t)st * B * F;
  int* dy = s_y + (size_t)st * B;
  if (bulk) {
    if (threadIdx.x == 0) {
      // the stage was last read through the generic proxy
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      mbar_expect_tx(bars + st, (unsigned)(B * (F + 1) * 4));
      bulk_copy(dx, xc + row0 * F, (unsigned)(B * F * 4), bars + st);
      bulk_copy(dy, yc + row0, (unsigned)(B * 4), bars + st);
    }
  } else {
    const int i = threadIdx.x;
    if (i < B) {
      const size_t row = ib ? (size_t)ib[i] : row0 + i;
#pragma unroll
      for (int f = 0; f < F; ++f)
        copy4(dx + (size_t)i * F + f, xc + row * F + f);
      copy4(dy + i, yc + row);
    }
    copies_arrive(bars + st);
  }
}

// Start the copies of client c's eval window, x rows [2, N, F] and labels
// [2, N], into s_ex and s_ey. Bulk (16-byte aligned rows and strides): four
// TMA bulk copies by thread 0, `bar` expecting the bytes (its count is 1).
// Otherwise every thread copies rows i, i + blockDim.x, ... with 4-byte
// cp.async and arrives (the count is the block's size).
template <int F>
__device__ __forceinline__ void stage_window(const Args& a, int c, bool bulk,
                                             float* s_ex, int* s_ey,
                                             uint64_t* bar) {
  const int N = a.N;
  if (bulk) {
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar, (unsigned)(2 * N * (F + 1) * 4));
      for (int g = 0; g < 2; ++g) {
        bulk_copy(s_ex + (size_t)g * N * F, a.ex + c * a.exs_c + g * a.exs_g,
                  (unsigned)(N * F * 4), bar);
        bulk_copy(s_ey + (size_t)g * N, a.ey + c * a.eys_c + g * a.eys_g,
                  (unsigned)(N * 4), bar);
      }
    }
  } else {
    for (int i = threadIdx.x; i < 2 * N; i += blockDim.x) {
      const int g = i / N, r = i - g * N;
      const float* src = a.ex + c * a.exs_c + g * a.exs_g + (size_t)r * F;
#pragma unroll
      for (int f = 0; f < F; ++f) copy4(s_ex + (size_t)i * F + f, src + f);
      copy4(s_ey + i, a.ey + c * a.eys_c + g * a.eys_g + r);
    }
    copies_arrive(bar);
  }
}

// The values a row of the fused kernel folds: its P gradients and its loss,
// padded to a whole number of folds (kFoldOne at once, else kFoldChunk at a
// time).
__host__ __device__ constexpr int fused_values(int P) {
  return P + 1 <= kFoldOne ? (P + 1 + 31) / 32 * 32
                           : (P + 1 + kFoldChunk - 1) / kFoldChunk * kFoldChunk;
}

// The fused kernel's block at batch B: one row a thread, round_up(B, 32)
// and at least 64 threads; thread p < P owns parameter p, thread P the loss.
__host__ __device__ constexpr int fused_threads(int B) {
  return (B + 31) / 32 * 32 < 64 ? 64 : (B + 31) / 32 * 32;
}

// Value q of a row's P + 1 in packed-param order (W1, b1, W2, b2, then the
// loss; 0 past them) from the row's registers: (x * fm) (x) dh, dh, h (x)
// dz, dz. q is a compile-time constant wherever the chunk loop is unrolled,
// so every index below is too.
template <int F, int H, int K>
__device__ __forceinline__ float fused_value(int q, const float (&xv)[F],
                                             const float (&h)[H],
                                             const float (&dz)[K],
                                             const float (&dh)[H],
                                             float loss) {
  constexpr int P = F * H + H + H * K + K;
  if (q < F * H) return xv[q / H] * dh[q % H];
  if (q < F * H + H) return dh[q - F * H];
  if (q < P - K) return h[(q - F * H - H) / K] * dz[(q - F * H - H) % K];
  if (q < P) return dz[q - (P - K)];
  return q == P ? loss : 0.f;
}

template <int F, int H, int K>
__global__ void __launch_bounds__(kFusedMaxThreads, 1)
local_sgd_fused_kernel(const Args a, int stages, int bulk, int emode) {
  constexpr int P = F * H + H + H * K + K;
  constexpr int oB1 = F * H, oW2 = oB1 + H, oB2 = oW2 + H * K;
  constexpr int V = fused_values(P);         // P gradients and the loss
  constexpr int VL = V / 32;                 // of them a lane keeps
  // the values fold kFoldChunk at a time (the mask then in shared memory,
  // to leave the registers to the row)
  constexpr bool kChunked = P + 1 > kFoldOne;
  constexpr int FM = kChunked ? F : 0;
  constexpr int EW = 2 * fnn_eval::kMaxWarps;  // the eval's warp totals
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // [kStages] the ring's, then the eval window's
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem_raw);
  const int B = a.B, S = a.S, N = a.N;
  const int warps = blockDim.x >> 5;
  float* s_x = reinterpret_cast<float*>(smem_raw + kBarBytes);  // [st, B, F]
  int* s_y = reinterpret_cast<int*>(s_x + (size_t)stages * B * F); // [st, B]
  float* s_red = reinterpret_cast<float*>(s_y + (size_t)stages * B); // [w, V]
  float* s_p = s_red + warps * V;                                  // [P]
  float* s_fm = s_p + P;                                           // [FM]
  // the eval (emode != kEvalNone): the input params, the mask, the warp
  // totals of the two cells and, 16-byte aligned, the window's rows
  float* s_pe = s_fm + FM;                                         // [P]
  float* s_fe = s_pe + P;                                          // [F]
  int* s_ecnt = reinterpret_cast<int*>(s_fe + F);                  // [EW]
  float* s_enll = reinterpret_cast<float*>(s_ecnt + EW);           // [EW]
  const size_t ew = ((reinterpret_cast<unsigned char*>(s_enll + EW)
                      - smem_raw) + 15) & ~(size_t)15;
  float* s_ex = reinterpret_cast<float*>(smem_raw + ew);           // [2, N, F]
  int* s_ey = reinterpret_cast<int*>(
      smem_raw + ew + ((8 * (size_t)N * F + 15) & ~(size_t)15));   // [2, N]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int pair = blockIdx.x;
  const int m = pair / a.C, c = pair % a.C;
  const float* pm = a.params + (size_t)m * P;
  const size_t so = (size_t)pair * P;
  const float* xc = a.x + (size_t)c * a.T1 * a.N * F;
  const int* yc = a.y + (size_t)c * a.T1 * a.N;

  if (tid == 0) {
    for (int st = 0; st < stages; ++st)
      mbar_init(bars + st, bulk ? 1u : blockDim.x);
    mbar_init(bars + kStages, emode == kEvalBulk ? 1u : blockDim.x);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // thread p owns parameter p: its value and its optimizer state stay in
  // registers for all S steps
  float w_own = 0.f, mu = 0.f, nu = 0.f, vmax = 0.f;
  if (tid < P) {
    w_own = pm[tid];
    mu = a.mu[so + tid];
    nu = a.nu[so + tid];
    vmax = a.nu_max[so + tid];
    s_p[tid] = w_own;
    if (emode != kEvalNone) s_pe[tid] = w_own;  // s_p changes at step 0
  }
  int count = a.count[pair];
  float fm[kChunked ? 1 : F];       // model m's feature mask
  if constexpr (kChunked) {
    if (tid < F) s_fm[tid] = a.fmask ? a.fmask[m * F + tid] : 1.f;
  } else {
#pragma unroll
    for (int f = 0; f < F; ++f) fm[f] = a.fmask ? a.fmask[m * F + f] : 1.f;
  }
  if (emode != kEvalNone && tid < F)
    s_fe[tid] = a.fmask ? a.fmask[m * F + tid] : 1.f;
  __syncthreads();
  for (int s = 0; s < stages; ++s)
    stage_batch<F>(a, xc, yc, pair, s, s, bulk, s_x, s_y, bars);
  // the eval window after the first batches: it is read only after step S-1
  if (emode == kEvalBulk || emode == kEvalCopies)
    stage_window<F>(a, c, emode == kEvalBulk, s_ex, s_ey, bars + kStages);

  const float inv_b = 1.0f / (float)B;
  float loss_sum = 0.f;             // thread P's sum of the S step losses
  for (int s = 0; s < S; ++s) {
    const int st = s % stages;
    mbar_wait(bars + st, (unsigned)(s / stages) & 1u);

    if constexpr (!kChunked) {
      // this thread's row: forward, loss, dlogits, dh and its gradient share
      float v[V];
#pragma unroll
      for (int i = 0; i < V; ++i) v[i] = 0.f;
      if (tid < B) {
        const float* xr = s_x + ((size_t)st * B + tid) * F;
        const int yi = s_y[(size_t)st * B + tid];
        float xv[F], h[H], z[K], e[K];
#pragma unroll
        for (int f = 0; f < F; ++f) xv[f] = xr[f] * fm[f];
#pragma unroll
        for (int j = 0; j < H; ++j) {
          float acc = 0.f;
#pragma unroll
          for (int f = 0; f < F; ++f) acc = fmaf(xv[f], s_p[f * H + j], acc);
          acc += s_p[oB1 + j];
          h[j] = fnn_eval::relu_select(acc);
        }
        float zmax = -INFINITY;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          float acc = 0.f;
#pragma unroll
          for (int j = 0; j < H; ++j)
            acc = fmaf(h[j], s_p[oW2 + j * K + k], acc);
          z[k] = acc + s_p[oB2 + k];
          zmax = fnn_eval::max_nan(zmax, z[k]);
        }
        float se = 0.f, zy = 0.f;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          e[k] = expf(z[k] - zmax);
          se += e[k];
          zy = k == yi ? z[k] : zy;
        }
        v[P] = logf(se) - (zy - zmax);
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const float dz = (e[k] / se - (k == yi ? 1.f : 0.f)) * inv_b;
          v[oB2 + k] = dz;
#pragma unroll
          for (int j = 0; j < H; ++j) v[oW2 + j * K + k] = h[j] * dz;
        }
#pragma unroll
        for (int j = 0; j < H; ++j) {
          float d = 0.f;
          if (h[j] > 0.f) {
#pragma unroll
            for (int k = 0; k < K; ++k)
              d = fmaf(v[oB2 + k], s_p[oW2 + j * K + k], d);
          }
          v[oB1 + j] = d;
#pragma unroll
          for (int f = 0; f < F; ++f) v[f * H + j] = xv[f] * d;
        }
      }

      // the warp's sums: lane l ends with values [l * VL, (l + 1) * VL)
      fold<16, V / 2>(v, lane);
      fold<8, V / 4>(v, lane);
      fold<4, V / 8>(v, lane);
      fold<2, V / 16>(v, lane);
      fold<1, V / 32>(v, lane);
#pragma unroll
      for (int i = 0; i < VL; ++i) s_red[warp * V + lane * VL + i] = v[i];
    } else {
      // this thread's row: its masked x, forward, loss, dlogits and dh in
      // registers; then its P + 1 values, generated and folded kFoldChunk
      // at a time into s_red, each chunk reusing the registers of the last.
      // Each sum runs over the same butterfly as a one-pass fold, then the
      // warps in order: a chunk only changes which lane ends up holding it.
      // (Leaving x in shared memory for the chunks, or summing the forward
      // input by input, measured 1.25-1.55 x slower a launch: PERF.md.)
      float xv[F], h[H], dz[K], dh[H], lrow = 0.f;
#pragma unroll
      for (int f = 0; f < F; ++f) xv[f] = 0.f;
#pragma unroll
      for (int j = 0; j < H; ++j) h[j] = dh[j] = 0.f;
#pragma unroll
      for (int k = 0; k < K; ++k) dz[k] = 0.f;
      if (tid < B) {
        const float* xr = s_x + ((size_t)st * B + tid) * F;
        const int yi = s_y[(size_t)st * B + tid];
        float z[K], e[K];
#pragma unroll
        for (int f = 0; f < F; ++f) xv[f] = xr[f] * s_fm[f];
#pragma unroll
        for (int j = 0; j < H; ++j) {
          float acc = 0.f;
#pragma unroll
          for (int f = 0; f < F; ++f) acc = fmaf(xv[f], s_p[f * H + j], acc);
          acc += s_p[oB1 + j];
          h[j] = fnn_eval::relu_select(acc);
        }
        float zmax = -INFINITY;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          float acc = 0.f;
#pragma unroll
          for (int j = 0; j < H; ++j)
            acc = fmaf(h[j], s_p[oW2 + j * K + k], acc);
          z[k] = acc + s_p[oB2 + k];
          zmax = fnn_eval::max_nan(zmax, z[k]);
        }
        float se = 0.f, zy = 0.f;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          e[k] = expf(z[k] - zmax);
          se += e[k];
          zy = k == yi ? z[k] : zy;
        }
        lrow = logf(se) - (zy - zmax);
#pragma unroll
        for (int k = 0; k < K; ++k)
          dz[k] = (e[k] / se - (k == yi ? 1.f : 0.f)) * inv_b;
#pragma unroll
        for (int j = 0; j < H; ++j) {
          float d = 0.f;
          if (h[j] > 0.f) {
#pragma unroll
            for (int k = 0; k < K; ++k)
              d = fmaf(dz[k], s_p[oW2 + j * K + k], d);
          }
          dh[j] = d;
        }
      }
      constexpr int CL = kFoldChunk / 32;  // of a chunk's values a lane keeps
#pragma unroll
      for (int c0 = 0; c0 < V; c0 += kFoldChunk) {
        float v[kFoldChunk];
#pragma unroll
        for (int i = 0; i < kFoldChunk; ++i)
          v[i] = fused_value<F, H, K>(c0 + i, xv, h, dz, dh, lrow);
        fold<16, kFoldChunk / 2>(v, lane);
        fold<8, kFoldChunk / 4>(v, lane);
        fold<4, kFoldChunk / 8>(v, lane);
        fold<2, kFoldChunk / 16>(v, lane);
        fold<1, kFoldChunk / 32>(v, lane);
#pragma unroll
        for (int i = 0; i < CL; ++i)
          s_red[warp * V + c0 + lane * CL + i] = v[i];
      }
    }
    __syncthreads();

    // every thread has read stage st: refill it for step s + stages
    if (s + stages < S)
      stage_batch<F>(a, xc, yc, pair, s + stages, st, bulk, s_x, s_y, bars);

    // add_decayed_weights, then scale_by_amsgrad, lr and lr_scale
    count = count < INT_MAX ? count + 1 : count;
    if (tid < P) {
      float g = 0.f;
      for (int w = 0; w < warps; ++w) g += s_red[w * V + tid];
      const float bc1 = 1.f - powf(a.b1, (float)count);
      const float bc2 = 1.f - powf(a.b2, (float)count);
      w_own = step_coord<false>(a, w_own, g, mu, nu, vmax, bc1, bc2);
      s_p[tid] = w_own;
    } else if (tid == P) {
      float tot = 0.f;
      for (int w = 0; w < warps; ++w) tot += s_red[w * V + P];
      loss_sum += tot * inv_b;
    }
    __syncthreads();
  }

  const float tw = a.total_w[pair];
  const bool active = tw > 0.f;
  if (tid < P) {
    a.out_params[so + tid] = active ? w_own : pm[tid];
    if (active) {
      a.mu[so + tid] = mu;
      a.nu[so + tid] = nu;
      a.nu_max[so + tid] = vmax;
    }
  } else if (tid == P) {
    if (active) a.count[pair] = count;
    a.n_out[pair] = active ? tw * (float)a.N : 0.f;
    a.loss_out[pair] = loss_sum / (float)S;
  }
  // cells (m, c, 0) and (m, c, 1) of the eval: model m's INPUT params on
  // client c's rows of the window, exactly as eval_cells.cu's blocks
  // (m, c, 0) and (m, c, 1) compute them at this block size
  if (emode != kEvalNone) {
    if (emode != kEvalGlobal) mbar_wait(bars + kStages, 0);
    for (int g = 0; g < 2; ++g) {
      const float* ex = emode == kEvalGlobal
                            ? a.ex + c * a.exs_c + g * a.exs_g
                            : s_ex + (size_t)g * N * F;
      const int* ey = emode == kEvalGlobal ? a.ey + c * a.eys_c + g * a.eys_g
                                           : s_ey + (size_t)g * N;
      fnn_eval::cell<F, H, K>(s_pe, s_fe, ex, ey, N,
                              s_ecnt + g * fnn_eval::kMaxWarps,
                              s_enll + g * fnn_eval::kMaxWarps,
                              a.eval_correct, a.eval_nll,
                              (size_t)pair * 2 + g);
    }
  }
  if (a.agg_out == nullptr) return;

  // K2, the epilogue: the last block of model m to finish aggregates it.
  // s_red is free after the loop's last barrier.
  // After the block's barrier, thread 0 takes the ticket with one
  // acquire-release atomic at device scope: it releases the block's writes
  // (ordered before it by the barrier) and, in the last block, acquires the
  // other blocks' writes, which the next barrier passes to its threads.
  int* s_last = reinterpret_cast<int*>(s_red);
  __syncthreads();
  if (tid == 0) *s_last = ticket_add(a.ticket + m) == a.C - 1;
  __syncthreads();
  if (!*s_last || tid >= P) return;
  // thread p aggregates parameter p. Its loads go in batches of kAggBatch
  // independent L2 reads (__ldcg: the other blocks' writes are not in this
  // SM's L1), so a batch costs one L2 latency; the sums stay in client
  // order 0..C-1.
  const int C = a.C;
  const float* nm = a.n_out + (size_t)m * C;
  float denom = 0.f;
  int clients = 0;
  for (int q0 = 0; q0 < C; q0 += kAggBatch) {
    float nv[kAggBatch];
#pragma unroll
    for (int i = 0; i < kAggBatch; ++i)
      nv[i] = q0 + i < C ? __ldcg(nm + q0 + i) : 0.f;
#pragma unroll
    for (int i = 0; i < kAggBatch; ++i) {
      if (q0 + i < C) {
        denom = __fadd_rn(denom, nv[i]);
        clients += nv[i] > 0.f;
      }
    }
  }
  const size_t mp = (size_t)m * P + tid;
  if (!(denom > 0.f)) {             // no active client: keep prev
    a.agg_out[mp] = pm[tid];
  } else {
    const float safe = fmaxf(denom, 1e-12f);
    const float* col = a.out_params + (size_t)m * C * P + tid;
    float acc = 0.f;
    for (int q0 = 0; q0 < C; q0 += kAggBatch) {
      float nv[kAggBatch], cv[kAggBatch];
#pragma unroll
      for (int i = 0; i < kAggBatch; ++i) {
        const bool in = q0 + i < C;
        nv[i] = in ? __ldcg(nm + q0 + i) : 0.f;
        cv[i] = in ? __ldcg(col + (size_t)(q0 + i) * P) : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kAggBatch; ++i)
        if (q0 + i < C)
          acc = __fadd_rn(acc, __fmul_rn(cv[i], __fdiv_rn(nv[i], safe)));
    }
    a.agg_out[mp] = acc;
  }
  if (tid == 0) {
    float* st = a.stats_out + (size_t)m * 3;
    st[0] = (float)clients;
    st[1] = 0.f;
    st[2] = 0.f;
    a.ticket[m] = 0;                // every block of model m has drawn
  }
}

// ---------------------------------------------------------------------------
// The split kernel (fmow's widths: the fnn, AMSGrad or SGD).

constexpr int kSplitCluster = 16;  // CTAs a pair, each a sixteenth of F
constexpr int kSplitRows = 32;     // batch rows a tile, and a CTA's rows in
                                   // the row phase
constexpr int kSplitStages = 4;    // x tiles in flight a CTA
constexpr int kSplitMaxH = 16;     // hidden units at most
constexpr int kSplitMaxK = 64;     // classes at most: two a lane
constexpr int kSplitMaxFq = 1024;  // inputs a CTA at most (NQ <= 256)

// The inputs a CTA of the split kernel takes: a sixteenth of F rounded up
// to whole float4s (F / 16 where F % 64 == 0). CTA q takes inputs
// [q FQ, q FQ + FQ); where 16 FQ > F the last CTAs hold fewer real inputs,
// and the slots past F are never copied, read or stepped.
__host__ __device__ constexpr int split_fq(int F) {
  return (F + 4 * kSplitCluster - 1) / (4 * kSplitCluster) * 4;
}

// dh's row stride in shared memory: H rounded up to float4s.
__host__ __device__ constexpr int split_dh_stride(int H) {
  return (H + 3) / 4 * 4;
}

// The small params' coordinates (b1, W2, b2) one CTA sums, steps and keeps
// the moments of: a sixteenth of them, rounded up.
__host__ __device__ constexpr int split_small_chunk(int SP) {
  return (SP + kSplitCluster - 1) / kSplitCluster;
}

// Shared memory one CTA of the split kernel needs, in bytes: the stages'
// mbarriers, then in floats the x ring (kSplitStages tiles of 32 rows of
// split_fq(F) inputs at a padded stride), the forward's warp partials of two
// tiles or dW1's slice, W1's slice (transposed) and its three moments,
// the mask's slice, dh of every batch row, the Z1 partials of every row, the
// small params (b1, W2, b2) and their partials, the moments of the CTA's
// sixteenth of them, h and dz of the CTA's own rows, their labels, the
// warps' losses and the loss, and the batch's row indices of two steps.
long long split_smem_bytes(int F, int H, int K, int B, bool sgd) {
  const long long FQ = split_fq(F), W = (long long)H * FQ;
  const long long SP = H + (long long)H * K + K;
  const long long red = 2LL * kWideWarps * kSplitRows * H;
  const long long floats =
      (long long)kSplitStages * kSplitRows * wide_stride((int)FQ)
      + (red > W ? red : W) + (sgd ? 1 : 4) * W + FQ
      + (long long)B * split_dh_stride(H) + (long long)B * H + 2 * SP
      + (sgd ? 0 : 3LL * split_small_chunk((int)SP))
      + (long long)kSplitRows * (H + K) + kSplitRows + kWideWarps + 4
      + 2LL * B;
  return 8LL * kSplitStages + 4 * floats;
}

template <bool kSgd>
__global__ void __launch_bounds__(kWideThreads, 1)
local_sgd_split_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  constexpr int Q = kSplitCluster, T = kWideThreads;
  const int F = a.F, H = a.H, K = a.K, B = a.B, N = a.N, S = a.S;
  const int FQ = split_fq(F), NQ = FQ / 4, XS = wide_stride(FQ);
  const int W = H * FQ, HD = split_dh_stride(H);
  const int SP = H + H * K + K, SPC = split_small_chunk(SP);
  const int oSm = F * H, P = oSm + SP;
  const int NT = (B + kSplitRows - 1) / kSplitRows;  // row tiles a pass
  const int TT = 2 * S * NT;                         // tiles a launch
  const int red = 2 * kWideWarps * kSplitRows * H;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem_raw);  // [stages]
  float* s_x = reinterpret_cast<float*>(smem_raw + 8 * kSplitStages);
  float* s_red = s_x + kSplitStages * kSplitRows * XS;  // [2][warps][rows][H]
                                                        // or dW1 [H][FQ]
  float* s_w = s_red + (red > W ? red : W);     // [H][FQ] W1[f0 + f][j]
  float* s_mw = s_w + W;                        // [H][FQ] each, AMSGrad
  float* s_vw = s_mw + W;
  float* s_xw = s_vw + W;
  float* s_fm = s_w + (kSgd ? 1 : 4) * W;       // [FQ]
  float* s_dh = s_fm + FQ;                      // [B][HD] every row's dh
  float* s_zp = s_dh + B * HD;                  // [B][H] Z1's partials
  float* s_sp = s_zp + B * H;                   // [SP] b1, W2, b2
  float* s_sg = s_sp + SP;                      // [SP] their partials
  float* s_smu = s_sg + SP;                     // [SPC] each, AMSGrad: the
  float* s_snu = s_smu + SPC;                   // owned coordinates'
  float* s_sxm = s_snu + SPC;                   // moments
  float* s_h = s_sg + SP + (kSgd ? 0 : 3 * SPC);  // [rows][H] own rows' h
  float* s_z = s_h + kSplitRows * H;            // [rows][K] their dz
  int* s_y = reinterpret_cast<int*>(s_z + kSplitRows * K);  // their labels
  float* s_wl = reinterpret_cast<float*>(s_y + kSplitRows);  // [warps]
  float* s_loss = s_wl + kWideWarps;            // [1] own rows' loss sum
  int* s_rows = reinterpret_cast<int*>(s_loss + 4);  // [2][B] batch rows

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q = (int)cluster.block_rank();
  // the pairs of one client side by side: with B = N they read the same
  // rows wherever their models drew the same step
  const int M = (int)(gridDim.x / Q) / a.C;
  const int cl = (int)blockIdx.x / Q, m = cl % M, c = cl / M;
  const int pair = m * a.C + c;
  const int f0 = q * FQ;                        // inputs [f0, f0 + FQ)
  const int FV = max(0, min(FQ, F - f0));       // of which real: [0, FV)
  const int NV = FV / 4;                        // their float4s
  const int o0 = q * kSplitRows;                // own rows in the row phase
  const int nown = max(0, min(kSplitRows, B - o0));
  const int e0 = q * SPC, ne = max(0, min(SPC, SP - e0));  // owned small
                                                // coordinates
  const float* pm = a.params + (size_t)m * P;
  const size_t so = (size_t)pair * P;
  const float* xc = a.x + (size_t)c * a.T1 * N * F + f0;
  const int* yc = a.y + (size_t)c * a.T1 * N;

  for (int e = tid; e < W; e += T) {           // packed W1[f0 + f][j]
    const int f = e / H, i = (e - f * H) * FQ + f;
    const size_t p = (size_t)f0 * H + e;
    const bool real = f < FV;                   // slots past F hold zeros
    s_w[i] = real ? pm[p] : 0.f;
    if constexpr (!kSgd) {
      s_mw[i] = real ? a.mu[so + p] : 0.f;
      s_vw[i] = real ? a.nu[so + p] : 0.f;
      s_xw[i] = real ? a.nu_max[so + p] : 0.f;
    }
  }
  for (int e = tid; e < SP; e += T) s_sp[e] = pm[oSm + e];
  if constexpr (!kSgd) {
    for (int e = tid; e < ne; e += T) {
      const size_t p = so + oSm + e0 + e;
      s_smu[e] = a.mu[p];
      s_snu[e] = a.nu[p];
      s_sxm[e] = a.nu_max[p];
    }
  }
  for (int f = tid; f < FQ; f += T)
    s_fm[f] = f >= FV ? 0.f : a.fmask ? a.fmask[(size_t)m * F + f0 + f] : 1.f;
  // the batch's rows of steps 0 and 1 (client c's rows of its T1 * N);
  // step s + 1's replace step s - 1's at the start of step s
  auto load_rows = [&](int s) {
    for (int b = tid; b < B; b += T)
      s_rows[(s & 1) * B + b] =
          a.idx ? a.idx[((size_t)pair * S + s) * B + b]
                : a.t_idx[pair * S + s] * N + a.slot[pair * S + s] * B + b;
  };
  load_rows(0);
  if (S > 1) load_rows(1);
  int loaded = S > 1 ? 1 : 0;       // the last step whose rows are staged
  if (tid == 0) {
    for (int st = 0; st < kSplitStages; ++st) mbar_init(bar + st, T);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // The stream of x tiles: for each step, pass 1's tiles 0 .. NT - 1, then
  // pass 2's NT - 1 .. 0 (the latest read first, likelier in L2). Every
  // thread issues its share of tile v into stage v % kSplitStages, in
  // order: 16-byte cp.async copies (8 threads a row, a thread every eighth
  // float4 of it), then an arrival on the stage's mbarrier when they land.
  // A tile is issued once its stage is free and its step's rows are
  // staged: with B <= 32 (2 tiles a step) the ring would otherwise reach
  // step s + 2 while its buffer still holds step s's rows.
  int iu = 0;                       // the next tile to issue
  int u = 0;                        // the next tile of the stream
  // this thread's row of a tile and its float4s cq, cq + 8, .. (a warp
  // copies 4 rows, 128 contiguous bytes of each at a time)
  const int cr = tid >> 3, cq = tid & 7;
  auto issue = [&]() {
    const int s = iu / (2 * NT), k = iu - s * 2 * NT;
    const int r0 = (k < NT ? k : 2 * NT - 1 - k) * kSplitRows;
    const int nr = min(kSplitRows, B - r0), st = iu % kSplitStages;
    if (cr < nr) {
      const float* src = xc + (size_t)s_rows[(s & 1) * B + r0 + cr] * F;
      float* dst = s_x + ((size_t)st * kSplitRows + cr) * XS;
#pragma unroll 4
      for (int q4 = cq; q4 < NV; q4 += 8) copy16(dst + 4 * q4, src + 4 * q4);
    }
    copies_arrive(bar + st);
    ++iu;
  };
  auto top_up = [&]() {
    while (iu < min(u + kSplitStages, TT) && iu / (2 * NT) <= loaded)
      issue();
  };
  top_up();
  // tile u + d of the stream, once it has landed
  auto wait_tile = [&](int d) -> const float* {
    const int st = (u + d) % kSplitStages;
    mbar_wait(bar + st, (unsigned)((u + d) / kSplitStages) & 1u);
    return s_x + (size_t)st * kSplitRows * XS;
  };
  // every thread is done with tiles u .. u + n - 1: their stages take the
  // tiles kSplitStages on
  auto release = [&](int n) {
    __syncthreads();
    u += n;
    top_up();
  };

  const float inv_b = 1.0f / (float)B;
  int count = kSgd ? 0 : a.count[pair];
  float loss_sum = 0.f;             // rank 0's thread 0: the S step losses
  for (int s = 0; s < S; ++s) {
    // own rows' labels, read now and stored after pass 1; step s + 1's
    // rows (step s - 1's tiles are all issued), then the tiles they free
    const int ylab = tid < nown ? yc[s_rows[(s & 1) * B + o0 + tid]] : 0;
    if (s >= 1 && s + 1 < S) {
      load_rows(s + 1);
      __syncthreads();
      loaded = s + 1;
      top_up();
    }

    // (1) Z1's partials over this CTA's inputs for every batch row, in
    // float32 FMAs: warp w takes the input quads w, w + 8, ..., lane r row
    // r of two tiles at a time (x at a stride of 4 mod 8 floats: a quarter
    // warp's float4 loads hit distinct banks; W1's and the mask's float4s
    // are broadcast, each load serving both tiles); the warps' partials
    // are summed in warp order
    for (int i = 0; i < NT; i += 2) {
      const int n2 = min(2, NT - i);
      const int nra = min(kSplitRows, B - i * kSplitRows);
      const int nrb = n2 > 1 ? min(kSplitRows, B - (i + 1) * kSplitRows) : 0;
      const float* xa = wait_tile(0) + lane * XS;
      const float* xb = n2 > 1 ? wait_tile(1) + lane * XS : xa;
      {
        float acc[2][kSplitMaxH];
#pragma unroll
        for (int j = 0; j < kSplitMaxH; ++j) acc[0][j] = acc[1][j] = 0.f;
        if (lane < nra) {           // the second tile's rows are as many or
          const bool inb = lane < nrb;  // fewer
          for (int f = 4 * warp; f < FV; f += 4 * kWideWarps) {
            const float4 mf = *reinterpret_cast<const float4*>(s_fm + f);
            const float4 qa = *reinterpret_cast<const float4*>(xa + f);
            const float4 qb = inb ? *reinterpret_cast<const float4*>(xb + f)
                                  : make_float4(0.f, 0.f, 0.f, 0.f);
            const float va[4] = {qa.x * mf.x, qa.y * mf.y, qa.z * mf.z,
                                 qa.w * mf.w};
            const float vb[4] = {qb.x * mf.x, qb.y * mf.y, qb.z * mf.z,
                                 qb.w * mf.w};
#pragma unroll
            for (int j = 0; j < kSplitMaxH; ++j) {
              if (j >= H) break;
              const float4 wq =
                  *reinterpret_cast<const float4*>(s_w + j * FQ + f);
              float v = fmaf(va[0], wq.x, acc[0][j]);
              v = fmaf(va[1], wq.y, v);
              v = fmaf(va[2], wq.z, v);
              acc[0][j] = fmaf(va[3], wq.w, v);
              float w = fmaf(vb[0], wq.x, acc[1][j]);
              w = fmaf(vb[1], wq.y, w);
              w = fmaf(vb[2], wq.z, w);
              acc[1][j] = fmaf(vb[3], wq.w, w);
            }
          }
        }
        // s_red [tile][warp][rows][H]
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int j = 0; j < kSplitMaxH; ++j) {
            if (j >= H || t >= n2) break;
            s_red[((t * kWideWarps + warp) * kSplitRows + lane) * H + j] =
                acc[t][j];
          }
      }
      release(n2);
      for (int t = 0; t < n2; ++t) {
        const int r0 = (i + t) * kSplitRows, nr = t ? nrb : nra;
        const float* rb = s_red + t * kWideWarps * kSplitRows * H;
        for (int e = tid; e < nr * H; e += T) {
          float z = 0.f;
#pragma unroll
          for (int w = 0; w < kWideWarps; ++w)
            z += rb[w * kSplitRows * H + e];
          s_zp[r0 * H + e] = z;
        }
      }
      __syncthreads();              // s_red is free again
    }
    if (tid < nown) s_y[tid] = ylab;
    cluster.sync();                 // every CTA's Z1 partials are visible

    // (2) the row phase, this CTA's rows o0 .. o0 + nown, a warp 4 rows
    // side by side and a lane a hidden unit, then two classes (lane and
    // lane + 32): Z1 summed over the cluster in rank order through
    // distributed shared memory, b1 and relu; the logits; the loss and
    // dlogits through shuffles; dh = (dz W2^T) * (h > 0) into this CTA's
    // rows of s_dh. Rows past the batch get no loss and no dh.
    {
      constexpr int R = kSplitRows / kWideWarps;
      const int c2 = lane + 32;
      float hj[R];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int r = warp + i * kWideWarps;
        hj[i] = 0.f;
        if (lane < H && r < nown) {
          float v = 0.f;
          for (int rk = 0; rk < Q; ++rk)
            v += cluster.map_shared_rank(s_zp, rk)[(o0 + r) * H + lane];
          v += s_sp[lane];
          hj[i] = fnn_eval::relu_select(v);
          s_h[r * H + lane] = hj[i];
        }
      }
      float z1[R], z2[R];
      {
        float acc1[R], acc2[R];
#pragma unroll
        for (int i = 0; i < R; ++i) acc1[i] = acc2[i] = 0.f;
        for (int j = 0; j < H; ++j) {
          const float w1 = lane < K ? s_sp[H + j * K + lane] : 0.f;
          const float w2 = c2 < K ? s_sp[H + j * K + c2] : 0.f;
#pragma unroll
          for (int i = 0; i < R; ++i) {
            const float hb = __shfl_sync(kFull, hj[i], j);
            acc1[i] = fmaf(hb, w1, acc1[i]);
            acc2[i] = fmaf(hb, w2, acc2[i]);
          }
        }
        const float b1 = lane < K ? s_sp[H + H * K + lane] : 0.f;
        const float b2 = c2 < K ? s_sp[H + H * K + c2] : 0.f;
#pragma unroll
        for (int i = 0; i < R; ++i) {
          z1[i] = lane < K ? acc1[i] + b1 : 0.f;
          z2[i] = c2 < K ? acc2[i] + b2 : 0.f;
        }
      }
      float zmax[R], se[R], e1[R], e2[R], d1[R], d2[R];
#pragma unroll
      for (int i = 0; i < R; ++i)
        zmax[i] = fnn_eval::max_nan(lane < K ? z1[i] : -INFINITY,
                                    c2 < K ? z2[i] : -INFINITY);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
#pragma unroll
        for (int i = 0; i < R; ++i)
          zmax[i] = fnn_eval::max_nan(zmax[i],
                                      __shfl_xor_sync(kFull, zmax[i], o));
#pragma unroll
      for (int i = 0; i < R; ++i) {
        e1[i] = lane < K ? expf(z1[i] - zmax[i]) : 0.f;
        e2[i] = c2 < K ? expf(z2[i] - zmax[i]) : 0.f;
        se[i] = e1[i] + e2[i];
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
#pragma unroll
        for (int i = 0; i < R; ++i) se[i] += __shfl_xor_sync(kFull, se[i], o);
      float wl = 0.f;               // lane 0: this warp's rows' losses
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int r = warp + i * kWideWarps;
        const bool live = r < nown;
        const int yi = live ? s_y[r] : 0;
        const float zy = __shfl_sync(kFull, yi < 32 ? z1[i] : z2[i], yi & 31);
        d1[i] = lane < K && live
                    ? (e1[i] / se[i] - (lane == yi ? 1.f : 0.f)) * inv_b
                    : 0.f;
        d2[i] = c2 < K && live
                    ? (e2[i] / se[i] - (c2 == yi ? 1.f : 0.f)) * inv_b : 0.f;
        if (live) {
          if (lane < K) s_z[r * K + lane] = d1[i];
          if (c2 < K) s_z[r * K + c2] = d2[i];
          wl += logf(se[i]) - (zy - zmax[i]);
        }
      }
      float dh[R];
#pragma unroll
      for (int i = 0; i < R; ++i) dh[i] = 0.f;
      for (int k = 0; k < K; ++k) {
        const float w2 = lane < H ? s_sp[H + lane * K + k] : 0.f;
#pragma unroll
        for (int i = 0; i < R; ++i)
          dh[i] = fmaf(__shfl_sync(kFull, k < 32 ? d1[i] : d2[i], k & 31),
                       w2, dh[i]);
      }
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int r = warp + i * kWideWarps;
        if (lane < H && r < nown) {
          const float d = hj[i] > 0.f ? dh[i] : 0.f;
#pragma unroll
          for (int rk = 0; rk < Q; ++rk)
            cluster.map_shared_rank(s_dh, rk)[(o0 + r) * HD + lane] = d;
        }
      }
      if (lane == 0) s_wl[warp] = wl;
    }
    __syncthreads();

    // (3) the small params' partials over the own rows, in order (db1,
    // dW2 = h^T dz, db2, as packed), and the loss
    if (tid == 0) {
      float l = 0.f;
      for (int w = 0; w < kWideWarps; ++w) l += s_wl[w];
      *s_loss = l;
    }
    for (int e = tid; e < SP; e += T) {
      float acc = 0.f;
      if (e < H) {
        for (int r = 0; r < nown; ++r) acc += s_dh[(o0 + r) * HD + e];
      } else if (e < H + H * K) {
        const int j = (e - H) / K, k = e - H - j * K;
        for (int r = 0; r < nown; ++r)
          acc = fmaf(s_h[r * H + j], s_z[r * K + k], acc);
      } else {
        const int k = e - H - H * K;
        for (int r = 0; r < nown; ++r) acc += s_z[r * K + k];
      }
      s_sg[e] = acc;
    }
    cluster.sync();                 // dh rows, partials and losses visible

    // (4) CTA q sums its sixteenth of the small params' partials over the
    // cluster in rank order, steps them with the moments it keeps and
    // pushes the new values into every CTA (read after the next step's
    // first cluster barrier); rank 0 the loss. Every row's dh is here.
    if (q == 0 && tid == 0) {
      float tot = 0.f;
      for (int rk = 0; rk < Q; ++rk)
        tot += *cluster.map_shared_rank(s_loss, rk);
      loss_sum += tot * inv_b;
    }
    if constexpr (!kSgd) count = count < INT_MAX ? count + 1 : count;
    const float bc1 = kSgd ? 1.f : 1.f - powf(a.b1, (float)count);
    const float bc2 = kSgd ? 1.f : 1.f - powf(a.b2, (float)count);
    for (int e = tid; e < ne; e += T) {
      const int p = e0 + e;
      float g = 0.f;
      for (int rk = 0; rk < Q; ++rk) g += cluster.map_shared_rank(s_sg, rk)[p];
      float mu = 0.f, nu = 0.f, vmax = 0.f;
      if constexpr (!kSgd) {
        mu = s_smu[e];
        nu = s_snu[e];
        vmax = s_sxm[e];
      }
      const float v = step_coord<kSgd>(a, s_sp[p], g, mu, nu, vmax, bc1, bc2);
      if constexpr (!kSgd) {
        s_smu[e] = mu;
        s_snu[e] = nu;
        s_sxm[e] = vmax;
      }
#pragma unroll
      for (int rk = 0; rk < Q; ++rk) cluster.map_shared_rank(s_sp, rk)[p] = v;
    }

    // (5) dW1 = (x * fm)^T dh over every row, float32 FMAs: thread t takes
    // input quad t % NQ and the rows t / NQ, + RG, ... of each tile, then
    // the RG row groups' sums in group order into s_red ([H][FQ])
    {
      const int RG = T / NQ, fq = tid % NQ, rg = tid / NQ;
      const bool on = rg < RG && fq < NV;     // a real input quad
      float acc[4][kSplitMaxH];
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int j = 0; j < kSplitMaxH; ++j) acc[k][j] = 0.f;
      const float4 mf = on ? *reinterpret_cast<const float4*>(s_fm + 4 * fq)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
      for (int i = NT - 1; i >= 0; --i) {
        const float* xt = wait_tile(0);
        const int r0 = i * kSplitRows, nr = min(kSplitRows, B - r0);
        if (on) {
          for (int r = rg; r < nr; r += RG) {
            const float4 xq =
                *reinterpret_cast<const float4*>(xt + r * XS + 4 * fq);
            const float xv[4] = {xq.x * mf.x, xq.y * mf.y, xq.z * mf.z,
                                 xq.w * mf.w};
            const float4* dr =
                reinterpret_cast<const float4*>(s_dh + (r0 + r) * HD);
#pragma unroll
            for (int j4 = 0; j4 < kSplitMaxH / 4; ++j4) {
              if (4 * j4 >= H) break;
              const float4 dv = dr[j4];
              const float dj[4] = {dv.x, dv.y, dv.z, dv.w};
#pragma unroll
              for (int jj = 0; jj < 4; ++jj)
#pragma unroll
                for (int k = 0; k < 4; ++k)
                  acc[k][4 * j4 + jj] =
                      fmaf(xv[k], dj[jj], acc[k][4 * j4 + jj]);
            }
          }
        }
        release(1);
      }
      for (int g = 0; g < RG; ++g) {
        if (rg == g) {
#pragma unroll
          for (int j = 0; j < kSplitMaxH; ++j) {
            if (j >= H) break;
            float4* o = reinterpret_cast<float4*>(s_red + j * FQ + 4 * fq);
            float4 v = make_float4(acc[0][j], acc[1][j], acc[2][j],
                                   acc[3][j]);
            if (g > 0) {
              const float4 p = *o;
              v = make_float4(p.x + v.x, p.y + v.y, p.z + v.z, p.w + v.w);
            }
            *o = v;
          }
        }
        __syncthreads();
      }
    }

    // (6) W1's slice steps here, with its own moments (its slots past F
    // stay zero)
    for (int i = tid; i < W; i += T) {
      if (FV < FQ && i % FQ >= FV) continue;
      float mu = 0.f, nu = 0.f, vmax = 0.f;
      if constexpr (!kSgd) {
        mu = s_mw[i];
        nu = s_vw[i];
        vmax = s_xw[i];
      }
      s_w[i] = step_coord<kSgd>(a, s_w[i], s_red[i], mu, nu, vmax, bc1, bc2);
      if constexpr (!kSgd) {
        s_mw[i] = mu;
        s_vw[i] = nu;
        s_xw[i] = vmax;
      }
    }
    __syncthreads();
  }
  cluster.sync();                   // no CTA leaves while another reads it,
                                    // and every push has landed

  const bool active = a.total_w[pair] > 0.f;
  float* op = a.out_params + so;
  for (int e = tid; e < W; e += T) {
    const int f = e / H, i = (e - f * H) * FQ + f;
    const size_t p = (size_t)f0 * H + e;
    if (f >= FV) break;             // e rises with f: the rest are past F
    op[p] = active ? s_w[i] : pm[p];
    if (!kSgd && active) {
      a.mu[so + p] = s_mw[i];
      a.nu[so + p] = s_vw[i];
      a.nu_max[so + p] = s_xw[i];
    }
  }
  if (!kSgd && active) {
    for (int e = tid; e < ne; e += T) {
      const size_t p = so + oSm + e0 + e;
      a.mu[p] = s_smu[e];
      a.nu[p] = s_snu[e];
      a.nu_max[p] = s_sxm[e];
    }
  }
  if (q == 0) {
    for (int e = tid; e < SP; e += T) {
      const size_t p = (size_t)oSm + e;
      op[p] = active ? s_sp[e] : pm[p];
    }
    if (tid == 0) {
      if (!kSgd && active) a.count[pair] = count;
      a.n_out[pair] = active ? a.total_w[pair] * (float)N : 0.f;
      a.loss_out[pair] = loss_sum / (float)S;
    }
  }
}

// Opt in to more than 48 KB of dynamic shared memory, once per device.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, std::atomic<unsigned long long>& ready,
                       int device) {
  const unsigned long long bit = device < 64 ? 1ull << device : 0;
  if (ready.load() & bit) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err == cudaSuccess) ready.fetch_or(bit);
  return err;
}

// Both launchers return a cudaError_t, or kErrSmem without a launch.
template <bool kLr, bool kSgd>
int launch_general(const Args& a, int pairs, int device, cudaStream_t st) {
  const long long smem = general_smem_bytes(a.F, a.H, a.K, a.B, kSgd);
  if (smem > kMaxSmem) return kErrSmem;
  if (smem > 48 * 1024) {
    static std::atomic<unsigned long long> ready{0};
    const cudaError_t err = allow_smem(local_sgd_general_kernel<kLr, kSgd>,
                                       ready, device);
    if (err != cudaSuccess) return (int)err;
  }
  local_sgd_general_kernel<kLr, kSgd>
      <<<pairs, kGeneralThreads, (size_t)smem, st>>>(a);
  return (int)cudaGetLastError();
}

// The fused kernel's launch at these sizes: its shared memory, its ring's
// stages and how it reads the eval window (kEvalNone without an eval). The
// ring takes min(S, kStages) stages, fewer where they would not fit a block
// (at least one). With an eval, the ring gives up stages, down to
// kMinStages, until the window fits beside it (staged by TMA bulk copies
// where `eval_bulk`, else by 4-byte copies); where even that does not fit
// the ring keeps its stages and the window is read where it lies. Layout:
// the mbarriers, the batch stages [stages, B, F + 1], the warps' partials
// [warps, fused_values(P)], the params [P] and, folding in chunks, the mask
// [F]; with an eval, the input params, the mask and the warp totals, then,
// 16-byte aligned, the window's rows [2, N, F] and labels [2, N].
// local_sgd.py's fused_smem_bytes mirrors it.
struct FusedLayout {
  long long smem;
  int stages, emode;
};

FusedLayout fused_layout(int F, int H, int K, int B, int S, int N, bool eval,
                         bool eval_bulk) {
  const int P = F * H + H + H * K + K;
  const int FM = P + 1 > kFoldOne ? F : 0;
  const long long fixed = kBarBytes + 4LL * (fused_threads(B) / 32)
                          * fused_values(P) + 4LL * (P + FM);
  auto ring = [&](int st) { return fixed + 4LL * st * B * (F + 1); };
  auto head = [&](int st) {
    return (ring(st) + 4LL * (P + F + 4 * fnn_eval::kMaxWarps) + 15) & ~15LL;
  };
  int stages = S < kStages ? S : kStages;
  while (stages > 1 && ring(stages) > kMaxSmem) --stages;
  if (!eval) return {ring(stages), stages, kEvalNone};
  const long long window = ((8LL * N * F + 15) & ~15LL)
                           + ((8LL * N + 15) & ~15LL);
  for (int st = stages; st >= (stages < kMinStages ? stages : kMinStages);
       --st)
    if (head(st) + window <= kMaxSmem)
      return {head(st) + window, st, eval_bulk ? kEvalBulk : kEvalCopies};
  return {head(stages), stages, kEvalGlobal};
}

// Returns a cudaError_t, or kErrSmem without a launch where even one batch
// stage would not fit a block.
template <int F, int H, int K>
int launch_fused(const Args& a, int pairs, int device, cudaStream_t st) {
  constexpr int P = F * H + H + H * K + K;
  if (a.B > kFusedMaxThreads || fused_threads(a.B) < P + 1)
    return (int)cudaErrorInvalidValue;  // a thread a parameter and the loss
  // TMA bulk copies need contiguous batches, and 16-byte aligned addresses
  // and sizes: every batch offset t*N + slot*B is a multiple of 4 rows
  // when N and B are
  const bool bulk = a.idx == nullptr
                    && ((reinterpret_cast<uintptr_t>(a.x)
                      | reinterpret_cast<uintptr_t>(a.y)) & 15) == 0
                    && a.N % 4 == 0 && a.B % 4 == 0;
  const bool eval_bulk =
      ((reinterpret_cast<uintptr_t>(a.ex)
        | reinterpret_cast<uintptr_t>(a.ey)) & 15) == 0
      && (a.exs_c % 4 | a.exs_g % 4 | a.eys_c % 4 | a.eys_g % 4) == 0
      && a.N % 4 == 0;
  const FusedLayout lay = fused_layout(F, H, K, a.B, a.S, a.N,
                                       a.eval_correct != nullptr, eval_bulk);
  if (lay.smem > kMaxSmem) return kErrSmem;
  if (lay.smem > 48 * 1024) {
    static std::atomic<unsigned long long> ready{0};
    const cudaError_t err = allow_smem(local_sgd_fused_kernel<F, H, K>, ready,
                                       device);
    if (err != cudaSuccess) return (int)err;
  }
  local_sgd_fused_kernel<F, H, K>
      <<<pairs, fused_threads(a.B), (size_t)lay.smem, st>>>(
          a, lay.stages, bulk ? 1 : 0, lay.emode);
  return (int)cudaGetLastError();
}

// A cluster kernel's launch configuration: `ctas` CTAs of kWideThreads in
// clusters of Q (above 8 a non-portable size, which the H100 allows), each
// with `smem` bytes of dynamic shared memory; the kernel's attributes are set
// once per device (`ready`, one per kernel).
template <typename Kernel>
cudaError_t cluster_config(Kernel kernel,
                           std::atomic<unsigned long long>& ready, int device,
                           unsigned ctas, unsigned Q, long long smem,
                           cudaStream_t st, cudaLaunchConfig_t& cfg,
                           cudaLaunchAttribute& attr) {
  const unsigned long long bit = device < 64 ? 1ull << device : 0;
  if (!(ready.load() & bit)) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    ready.fetch_or(bit);
  }
  cfg = {};
  cfg.gridDim = dim3(ctas);
  cfg.blockDim = dim3(kWideThreads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = st;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = Q;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaSuccess;
}

// Launch `kernel` (clusters == null), or write how many of its clusters the
// device holds at once into *clusters.
template <typename Kernel>
int cluster_launch(Kernel kernel, std::atomic<unsigned long long>& ready,
                   const Args& a, int pairs, int Q, long long smem,
                   int device, cudaStream_t st, int* clusters) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = cluster_config(kernel, ready, device,
                                   (unsigned)pairs * (unsigned)Q,
                                   (unsigned)Q, smem, st, cfg, attr);
  if (err != cudaSuccess) return (int)err;
  if (clusters)
    return (int)cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// What the wide kernel takes: F a multiple of 4 (16-byte rows for the bulk
// copies), a first layer of at most 16 units and at most 32 classes (a
// lane each; the fnn up to 64, two a lane), B <= 512 (at most 16 CTAs of
// 32 rows), x 16-byte aligned, and its shared memory within a block's.
template <bool kLr, bool kSgd>
int launch_wide(const Args& a, int pairs, int device, cudaStream_t st,
                int* clusters) {
  const int L1 = kLr ? a.K : a.H;
  if (a.F % 4 || L1 < 1 || L1 > kWideMaxWidth
      || a.K > (kLr ? 32 : 2 * 32) || a.B > kWideRows * kWideMaxCluster
      || (reinterpret_cast<uintptr_t>(a.x) & 15))
    return (int)cudaErrorInvalidValue;
  const long long smem = wide_smem_bytes(a.F, a.H, a.K, a.B, kSgd);
  if (smem > kMaxSmem) return kErrSmem;
  const int Q = wide_cluster(a.B);
  if constexpr (!kLr) {
    if (a.K > 32) {
      static std::atomic<unsigned long long> ready64{0};
      return cluster_launch(local_sgd_wide_kernel<false, kSgd, true>, ready64,
                            a, pairs, Q, smem, device, st, clusters);
    }
  }
  static std::atomic<unsigned long long> ready{0};
  return cluster_launch(local_sgd_wide_kernel<kLr, kSgd, false>, ready, a,
                        pairs, Q, smem, device, st, clusters);
}

// What the split kernel takes: the fnn, F a multiple of 4 (16-byte rows;
// each of the 16 CTAs whole float4s of every row, split_fq(F) of them) with
// at most 1024 inputs a CTA, at most 16 hidden units and 64 classes, B <=
// 512, x 16-byte aligned, and its shared memory within a block's.
template <bool kSgd>
int launch_split(const Args& a, int pairs, int device, cudaStream_t st,
                 int* clusters) {
  if (a.F % 4 || split_fq(a.F) > kSplitMaxFq
      || a.H < 1 || a.H > kSplitMaxH || a.K < 1 || a.K > kSplitMaxK
      || a.B > kSplitRows * kSplitCluster
      || (reinterpret_cast<uintptr_t>(a.x) & 15))
    return (int)cudaErrorInvalidValue;
  const long long smem = split_smem_bytes(a.F, a.H, a.K, a.B, kSgd);
  if (smem > kMaxSmem) return kErrSmem;
  static std::atomic<unsigned long long> ready{0};
  return cluster_launch(local_sgd_split_kernel<kSgd>, ready, a, pairs,
                        kSplitCluster, smem, device, st, clusters);
}

// The cluster routes by model and update: 2 the wide kernel, 3 the split
// one (the fnn only).
int launch_cluster_route(const Args& a, int route, bool sgd, int pairs,
                         int device, cudaStream_t st, int* clusters) {
  if (route == 3)
    return a.H == 0 ? (int)cudaErrorInvalidValue
           : sgd    ? launch_split<true>(a, pairs, device, st, clusters)
                    : launch_split<false>(a, pairs, device, st, clusters);
  if (a.H == 0)
    return sgd ? launch_wide<true, true>(a, pairs, device, st, clusters)
               : launch_wide<true, false>(a, pairs, device, st, clusters);
  return sgd ? launch_wide<false, true>(a, pairs, device, st, clusters)
             : launch_wide<false, false>(a, pairs, device, st, clusters);
}

}  // namespace

// What the wrapper packs for one call (local_sgd.py, _PARAMS).
struct Params {
  unsigned long long x, y, params, mu, nu, nu_max, count, t_idx, slot, idx,
      fmask, total_w, out_params, n_out, loss_out, agg_out, stats_out,
      ticket, ex, ey, eval_correct, eval_nll;  // device pointers
  long long exs_c, exs_g, eys_c, eys_g;        // element strides
  int M, C, T1, N, F, H, K, B, S;
  int device;  // CUDA device index of every tensor
  int sgd;     // 1: the SGD update (general route), 0: AMSGrad
  float neg_lr, wd, lr_scale, b1, b2, one_minus_b1, one_minus_b2, eps;
};
static_assert(sizeof(Params) == 288, "Params must match the wrapper's pack");

// Plain C entry point bound with ctypes. Every tensor contiguous on device
// `device`, float32 except y, count, t_idx, slot and idx (int32); either
// t_idx and slot or idx are given (idx: the others 0), fmask may be 0.
// agg_out may be 0 (no epilogue); with it, stats_out and ticket (int32, M
// zeros, left zero by every launch) are given, and only the fused route
// takes it. eval_correct may be 0 (no eval); with it, agg_out, eval_nll,
// ex and ey are given (the window's rows [N, F] and labels [N] contiguous).
// Rows of idx must lie in [0, T1*N): the weighted draw clips them. `route` is
// local_sgd.py's _ROUTES: 0 the general kernel, 1 the fused kernel (only
// for the (F, H, K) it is built for, B <= 512 and AMSGrad), 2 the wide
// kernel (F % 4 == 0, a first layer of at most 16 units, at most 32
// classes, B <= 512, x 16-byte aligned). H = 0 is the lr and sgd = 1 the SGD update, both on the general
// and wide kernels only; under SGD mu, nu, nu_max and count may be 0.
// `stream` is a stream of that device; the device is made current for the
// launch only if it is not. Returns the cudaError_t of the launch (0 = ok),
// or kErrSmem (nothing launched) when the general or wide kernel would need
// more shared memory than a block may take.
extern "C" int local_sgd_f32(const Params* p, int route, void* stream) {
  if (p->M < 1 || p->C < 1 || p->S < 1 || p->B < 1 || p->H < 0
      || (p->sgd && route == 1)
      || (!p->sgd && (!p->mu || !p->nu || !p->nu_max || !p->count))
      || (p->agg_out && (route != 1 || !p->stats_out || !p->ticket))
      || (p->eval_correct
          && (!p->agg_out || !p->eval_nll || !p->ex || !p->ey)))
    return (int)cudaErrorInvalidValue;
  const Args a{reinterpret_cast<const float*>(p->x),
               reinterpret_cast<const int*>(p->y),
               reinterpret_cast<const float*>(p->params),
               reinterpret_cast<float*>(p->mu),
               reinterpret_cast<float*>(p->nu),
               reinterpret_cast<float*>(p->nu_max),
               reinterpret_cast<int*>(p->count),
               reinterpret_cast<const int*>(p->t_idx),
               reinterpret_cast<const int*>(p->slot),
               reinterpret_cast<const int*>(p->idx),
               reinterpret_cast<const float*>(p->fmask),
               reinterpret_cast<const float*>(p->total_w),
               reinterpret_cast<float*>(p->out_params),
               reinterpret_cast<float*>(p->n_out),
               reinterpret_cast<float*>(p->loss_out),
               reinterpret_cast<float*>(p->agg_out),
               reinterpret_cast<float*>(p->stats_out),
               reinterpret_cast<int*>(p->ticket),
               reinterpret_cast<const float*>(p->ex),
               reinterpret_cast<const int*>(p->ey),
               reinterpret_cast<int*>(p->eval_correct),
               reinterpret_cast<float*>(p->eval_nll),
               p->exs_c, p->exs_g, p->eys_c, p->eys_g,
               p->C, p->T1, p->N, p->F, p->H, p->K, p->B, p->S,
               p->neg_lr, p->wd, p->lr_scale, p->b1, p->b2,
               p->one_minus_b1, p->one_minus_b2, p->eps};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int current = 0;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != p->device)
    err = cudaSetDevice(p->device);
  if (err != cudaSuccess) return (int)err;
  const int pairs = p->M * p->C;
  int ret;
  if (route == 0 && p->H == 0)
    ret = p->sgd ? launch_general<true, true>(a, pairs, p->device, st)
                 : launch_general<true, false>(a, pairs, p->device, st);
  else if (route == 0)
    ret = p->sgd ? launch_general<false, true>(a, pairs, p->device, st)
                 : launch_general<false, false>(a, pairs, p->device, st);
  else if (route == 2 || route == 3)
    ret = launch_cluster_route(a, route, p->sgd != 0, pairs, p->device, st,
                               nullptr);
  else if (route == 1 && p->F == 3 && p->H == 10 && p->K == 2)
    ret = launch_fused<3, 10, 2>(a, pairs, p->device, st);
  else if (route == 1 && p->F == 2 && p->H == 10 && p->K == 2)
    ret = launch_fused<2, 10, 2>(a, pairs, p->device, st);
  else if (route == 1 && p->F == 18 && p->H == 10 && p->K == 2)
    ret = launch_fused<18, 10, 2>(a, pairs, p->device, st);
  else if (route == 1 && p->F == 5 && p->H == 10 && p->K == 2)
    ret = launch_fused<5, 10, 2>(a, pairs, p->device, st);
  else
    ret = (int)cudaErrorInvalidValue;
  if (current != p->device) cudaSetDevice(current);
  return ret;
}

// The wide kernel's shared memory a CTA at these sizes (H = 0: the lr), in
// bytes: local_sgd.py's wide_smem_bytes mirrors it.
extern "C" long long local_sgd_wide_smem(int F, int H, int K, int B,
                                         int sgd) {
  return wide_smem_bytes(F, H, K, B, sgd != 0);
}

// The fused kernel's shared memory a block at these sizes, in bytes, its
// ring's stages into *stages and its eval mode into *emode (0 none, 1 and 2
// the window staged, by bulk copies where eval_bulk, 3 read where it lies):
// local_sgd.py's fused_smem_bytes mirrors it.
extern "C" long long local_sgd_fused_smem(int F, int H, int K, int B, int S,
                                          int N, int eval, int eval_bulk,
                                          int* stages, int* emode) {
  const FusedLayout lay = fused_layout(F, H, K, B, S, N, eval != 0,
                                       eval_bulk != 0);
  *stages = lay.stages;
  *emode = lay.emode;
  return lay.smem;
}

// The general kernel's shared memory a block at these sizes, in bytes:
// local_sgd.py's general_smem_bytes mirrors it.
extern "C" long long local_sgd_general_smem(int F, int H, int K, int B,
                                            int sgd) {
  return general_smem_bytes(F, H, K, B, sgd != 0);
}

// The split kernel's shared memory a CTA at these sizes, in bytes:
// local_sgd.py's split_smem_bytes mirrors it.
extern "C" long long local_sgd_split_smem(int F, int H, int K, int B,
                                          int sgd) {
  return split_smem_bytes(F, H, K, B, sgd != 0);
}

// How many clusters of the wide (route 2) or split (route 3) kernel device
// `device` holds at once at these sizes (H = 0: the lr), into *clusters:
// the launch's waves are M * C / *clusters. Returns a cudaError_t, or
// kErrSmem.
extern "C" int local_sgd_clusters(int route, int F, int H, int K, int B,
                                  int sgd, int device, int* clusters) {
  if (route != 2 && route != 3) return (int)cudaErrorInvalidValue;
  Args a{};
  a.F = F;
  a.H = H;
  a.K = K;
  a.B = B;
  int current = 0;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int ret = launch_cluster_route(a, route, sgd != 0, 1, device, nullptr,
                                       clusters);
  if (current != device) cudaSetDevice(current);
  return ret;
}
