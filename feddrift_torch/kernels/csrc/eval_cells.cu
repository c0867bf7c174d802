// Eval matrices of the fnn or lr pool (K3): correct counts and NLL sums per
// (model, client, time step), float32 in, int32 and float32 out.
//
// Replaces feddrift_tpu/core/step.py::TrainStep._acc_matrix_body (:777-789)
// and _acc_cells_jit (:844-866): every model of the pool on every client's
// rows of one time step (acc_matrix) or of every step (acc_cells). The
// reference has no Pallas kernel here: XLA fuses the vmapped forward, the
// argmax and the log-softmax.
//
// What it computes. Model m's packed fnn params (flax layout: W0 [F, H],
// b0 [H], W1 [H, K], b1 [K]), its feature mask fm[m] (none: ones), and
// client c's rows x [N, F], labels y [N] of window step g: per row
// z = relu((x * fm) @ W0 + b0) @ W1 + b1; the row is correct when the FIRST
// maximal class (torch.argmax's and jnp.argmax's pick) equals y; its NLL is
// log(sum_k exp(z_k - max z)) - (z_y - max z), log_softmax's arithmetic.
// correct[m, c, g] counts the correct rows and nll[m, c, g] sums the NLLs
// (not written when nll is null). The window is any [C, G] view of the
// dataset: x's client and step strides are arguments, so x[:, t] and
// x[:, t:t + 2] need no copy; a block's rows [N, F] are contiguous.
//
// Bound on the H100 SXM at an eval of the canonical run (M = 4, C = 10,
// G = 2, N = 500, F = 3, H = 10, K = 2): x and y of the window (160 KB),
// the params and the outputs move ~0.16 MB, ~0.05 us at 3.35 TB/s; the
// forward is ~4.5 MFLOP, ~0.07 us at 67 TFLOP/s float32. Either way far
// under a launch's latency: the kernel exists to replace the plain
// version's ~18 launches with one.
//
// Design of the fused and general kernels: one block per (m, c, g) (80
// blocks for an eval, 440 for acc_cells at T1 = 11) of round_up(N, 32)
// threads, at most 512, one row a thread and a loop over the rest. The
// model's params and mask are staged once into shared memory, where every
// thread reads the same address. Three kernels of the one function; the
// wrapper (eval_cells.py::_route) picks one by shape alone, before the
// launch:
// - eval_fused_kernel<F, H, K> for the registry's widths at
//   fnn_hidden_dim = 10 (F in {2, 3, 5, 18}: sine and circle, SEA, ro,
//   susy; H = 10, K = 2): x, h and z of a row in registers, fully
//   unrolled.
// - eval_general_kernel<false> for the widths the others do not take
//   (fnn_hidden_dim = 32, F % 4 != 0 outside the fused widths, or inputs
//   too wide for the wide kernel's shared memory): a loop over the hidden
//   units, each accumulated into the row's K logits kept in shared memory
//   ([K][threads], one column a thread). Its shared memory is 4 * (P + F + K * threads) bytes; above
//   what a block may take the entry point returns kErrSmem without a
//   launch, and the wrapper raises ValueError.
// - eval_general_kernel<true>, the lr (LogisticRegression, H = 0 on the
//   wire: packed W [F, K], b [K]): each output s_k = sigmoid(x.W[:, k] +
//   b_k), summed over f in order, then the bias, then 1 / (1 + exp(-z)).
//   The reference takes the sigmoid outputs as its logits: the argmax runs
//   over s (a large |z| saturates s to exactly 1.0f or 0.0f, and the tie
//   then goes to the lowest class, jnp.argmax's rule, where an argmax over
//   z would pick another), and the NLL is log_softmax(s)'s. Its shared
//   memory is 4 * (P + F + K * threads) bytes with P = F * K + K.
// The fused and general kernels sum in the same order (f, then the bias;
// j, then the bias; classes in order). The block's count and NLL sum fold by a warp-shuffle tree,
// then the warp totals in warp order: a fixed order, so `correct` is exact
// and `nll` is bitwise the same call after call, and a block's result does
// not depend on G or on the strides. No tensor cores: at H = 10 and K = 2
// an mma tile would be mostly padding.
//
// - eval_wide_kernel<kLr> for wide inputs, MNIST-4's (F = 784; the fnn
//   784 -> 10 -> 10 or the lr 784 -> 10), in resident tiles of 32 rows: F % 4
//   == 0 (16-byte rows for TMA), a first layer at most 64 wide, 32 rows of
//   x within a block's shared memory (eval_wide_rows). It computes what
//   eval_general_kernel computes.
//   Bound on the H100 SXM at an eval of MNIST-4 (M 4, C 10, G 2, N 500):
//   x's window is 31 MB, ~0.0094 ms at 3.35 TB/s; the forward is ~0.64
//   GFLOP, ~0.0095 ms at 67 TFLOP/s float32 (0.0039 in 3xTF32 on the
//   tensor cores). The general kernel read each row once per model and
//   once per hidden unit, uncoalesced (one block a (m, c, g), a thread a
//   row, SIMT).
//   Design: a cluster of Q = min(16, ceil(N / 32)) CTAs per (c, g) (at
//   MNIST-4's G = 2, 8 CTAs measured 2.6 % faster and 4 or 2 up to 3.4 x
//   slower; at G = T1, 2 CTAs 5 % faster: PERF.md); CTA q
//   stages row tiles q, q + Q, ... (32 rows each) of the step by TMA bulk
//   copies, once for ALL M models, at a padded stride (no bank conflicts in
//   the mma fragments). The models' first layers side by side, [F, M * H]
//   (40 columns at M = 4; groups of at most 64 columns and 8 models, so
//   M = 10 runs as 6 + 4 on the same staged rows), times x on the tensor
//   cores in 3xTF32 (mma.sync m16n8k8; W0 read through L2 and scaled by the
//   model's mask; eight warps over n-tiles, splitting F where the tiles are
//   few, their partials summed in order). Then warp w takes model g0 + w
//   and a lane a row for the second layer (the lr: the sigmoid) and the
//   score, with the general kernel's arithmetic; a warp's shuffle tree
//   sums its rows, lane 0 the CTA's tiles in order, and CTA 0 the CTAs in
//   rank order through distributed shared memory: a fixed order, so
//   `correct` is exact and `nll` bitwise the same call after call. Its
//   shared memory is eval_wide_smem_bytes (117 KB at MNIST's fnn), one CTA
//   an SM.
// - eval_stream_kernel<kLr> where 32 rows of x do not fit a block, fmow's
//   (F = 3072; the fnn 3072 -> 10 -> 62; 32 rows of x are 394 KB): the same
//   function, F streamed in chunks. Bound on the H100 SXM at an eval of
//   fmow (M 4, C 10, G 2, N 500): x's window is 123 MB, ~0.037 ms at 3.35
//   TB/s; the forward is ~2.5 GFLOP, 0.037 ms at 67 TFLOP/s float32: bytes
//   and operations alike. (Its first design, the resident kernel on 16-row
//   tiles, lost to the plain version, 1.37 ms against 0.79: each of its
//   working warps, five of eight, walked all of F alone, and read W0 by
//   scalar loads through L2 once for every 16 rows; PERF.md.)
//   Design: a cluster of Q = min(16, ceil(N / 64)) CTAs per (c, g), CTA q
//   taking row tiles q, q + Q, ... of 64 rows (four m16 tiles). For each
//   tile and model group (as above) the CTA streams F in chunks of 32
//   inputs through a ring of kStreamStages stages filled by cp.async (one
//   commit group a chunk, so chunk k + 2 lands while chunk k multiplies):
//   the tile's x rows at a padded stride, the group's W0 rows [32, cols]
//   and, with masks, each column's mask values laid out as W0's. So each
//   W0 value is read once per 64 rows, from shared memory. Warp w takes
//   m16 tiles 2 (w & 1) and 2 (w & 1) + 1 and k-step w >> 1 of every
//   chunk, all of the group's n-tiles, its accumulators in registers
//   across the chunks (3xTF32 as above: the two small cross terms, then
//   big * big, into one accumulator); the four k-steps' partials are
//   summed in order after the last chunk. Then the second layer, the score
//   and the sums as in the resident kernel, a warp's lanes over the tile's
//   two halves in order: a fixed order, bitwise the same call after call.
//   Its shared memory is eval_stream_smem_bytes (97 KB at fmow's fnn), so
//   two CTAs share an SM and an eval of G = 2 (20 clusters of 8) is one
//   wave.
//
// The fused kernel's cell (its row loop, score_row and block_total) lives
// in fnn_eval.cuh, which K1's fused kernel (local_sgd.cu) shares: the fused
// round loop evaluates round r's params inside round r + 1's K1 launch, and
// those cells are bitwise this kernel's. This kernel takes every other
// eval: the last round's of a time step, the per-round path's, acc_matrix
// and acc_cells.

#include <cuda_runtime.h>
#include <stdint.h>

#include <cooperative_groups.h>

#include <atomic>

#include "bulk_copy.cuh"
#include "fnn_eval.cuh"
#include "mma_tf32.cuh"

namespace {

using fnn_eval::block_total;
using fnn_eval::kMaxWarps;
using fnn_eval::score_row;

constexpr int kMaxThreads = 512;
constexpr int kMaxSmem = 232448;              // a block's shared memory
constexpr int kStaticSmem = 2 * 4 * kMaxWarps;  // the warp totals
constexpr int kErrSmem = -1;                  // eval_cells.py's _ERR_SMEM

struct Args {
  const float* params;  // [M, P]
  const float* fmask;   // [M, F], or null (ones)
  const float* x;       // rows [N, F] at x + c * xs_c + g * xs_g
  const int* y;         // [N] at y + c * ys_c + g * ys_g
  int* correct;         // [M, C, G]
  float* nll;           // [M, C, G], or null
  long long xs_c, xs_g, ys_c, ys_g;
  int C, G, N, F, H, K;
};

// This block's (m, c, g), its output index and its rows and labels.
struct Cell {
  size_t m, out;
  const float* x;
  const int* y;
};

__device__ __forceinline__ Cell cell_of(const Args& a) {
  const size_t b = blockIdx.x;
  const size_t g = b % a.G, c = (b / a.G) % a.C;
  return {b / ((size_t)a.G * a.C), b, a.x + c * a.xs_c + g * a.xs_g,
          a.y + c * a.ys_c + g * a.ys_g};
}

template <int F, int H, int K>
__global__ void __launch_bounds__(kMaxThreads)
eval_fused_kernel(const Args a) {
  constexpr int P = F * H + H + H * K + K;
  __shared__ float sp[P];
  __shared__ float sf[F];
  __shared__ int s_cnt[kMaxWarps];
  __shared__ float s_nll[kMaxWarps];
  const Cell cl = cell_of(a);
  const int tid = threadIdx.x;
  for (int i = tid; i < P; i += blockDim.x) sp[i] = a.params[cl.m * P + i];
  if (tid < F) sf[tid] = a.fmask ? a.fmask[cl.m * F + tid] : 1.f;
  __syncthreads();
  fnn_eval::cell<F, H, K>(sp, sf, cl.x, cl.y, a.N, s_cnt, s_nll, a.correct,
                          a.nll, cl.out);
}

// kLr: the lr (P = F * K + K); else the fnn (P = F * H + H + H * K + K).
template <bool kLr>
__global__ void __launch_bounds__(kMaxThreads)
eval_general_kernel(const Args a) {
  extern __shared__ float smem[];  // params [P], mask [F], logits [K][nt]
  __shared__ int s_cnt[kMaxWarps];
  __shared__ float s_nll[kMaxWarps];
  const int F = a.F, H = a.H, K = a.K;
  const int P = kLr ? F * K + K : F * H + H + H * K + K;
  const int tid = threadIdx.x, nt = blockDim.x;
  float* sp = smem;
  float* sf = sp + P;
  float* zs = sf + F;
  const Cell cl = cell_of(a);
  for (int i = tid; i < P; i += nt) sp[i] = a.params[cl.m * P + i];
  for (int f = tid; f < F; f += nt)
    sf[f] = a.fmask ? a.fmask[cl.m * F + f] : 1.f;
  __syncthreads();
  const float* W0 = sp;
  const float* b0 = sp + F * H;
  const float* W1 = b0 + H;
  const float* b1 = W1 + H * K;
  float* z = zs + tid;              // this thread's logits, stride nt
  int cnt = 0;
  float nll = 0.f;
  for (int i = tid; i < a.N; i += nt) {
    const float* xi = cl.x + (size_t)i * F;
    if constexpr (kLr) {
      const float* W = sp;          // [F, K]
      const float* b = sp + F * K;  // [K]
      for (int k = 0; k < K; ++k) {
        float s = 0.f;
        for (int f = 0; f < F; ++f)
          s = fmaf(__fmul_rn(xi[f], sf[f]), W[f * K + k], s);
        z[k * nt] = __fdiv_rn(1.f, __fadd_rn(1.f, expf(-__fadd_rn(s, b[k]))));
      }
      score_row<0>([&](int k) { return z[k * nt]; }, K, cl.y[i], &cnt, &nll,
                   a.nll != nullptr);
      continue;
    }
    for (int k = 0; k < K; ++k) z[k * nt] = 0.f;
    for (int j = 0; j < H; ++j) {
      float s = 0.f;
      for (int f = 0; f < F; ++f)
        s = fmaf(__fmul_rn(xi[f], sf[f]), W0[f * H + j], s);
      const float h = fnn_eval::relu(__fadd_rn(s, b0[j]));
      for (int k = 0; k < K; ++k) z[k * nt] = fmaf(h, W1[j * K + k], z[k * nt]);
    }
    for (int k = 0; k < K; ++k) z[k * nt] = __fadd_rn(z[k * nt], b1[k]);
    score_row<0>([&](int k) { return z[k * nt]; }, K, cl.y[i], &cnt, &nll,
                 a.nll != nullptr);
  }
  block_total(cnt, nll, s_cnt, s_nll, a.correct, a.nll, cl.out);
}

// ---------------------------------------------------------------------------
// The wide kernel (MNIST's widths; the fnn or the lr).

namespace cg = cooperative_groups;

constexpr int kWideThreads = 256;
constexpr int kWideWarps = kWideThreads / 32;
constexpr int kWideMaxCluster = 16;  // CTAs a cell (non-portable above 8)
constexpr int kWideCols = 64;        // first-layer columns of a model group
constexpr int kWideRows = 32;        // the resident kernel's row tile
constexpr int kStreamRows = 64;      // the streamed kernel's: four m16 tiles
constexpr int kStreamChunk = 32;     // inputs a chunk: four k-steps
constexpr int kStreamStages = 3;     // chunks in flight a CTA

// x's row stride in shared memory, in floats: the least multiple of 4 at or
// above F that is 4 (mod 8), so the eight rows of an A fragment fall in
// eight different bank quads, and a row stays 16-byte aligned.
__host__ __device__ constexpr int wide_stride(int F) {
  return (F + 3) / 4 * 4 % 8 == 4 ? (F + 3) / 4 * 4 : (F + 3) / 4 * 4 + 4;
}

// Models whose first layers one pass computes side by side: at most 64
// columns (eight n8 tiles) and eight models, one a warp in the second
// layer.
__host__ __device__ constexpr int wide_group(int L1) {
  return kWideCols / L1 < 1 ? 1
         : kWideCols / L1 > kWideWarps ? kWideWarps : kWideCols / L1;
}

// Floats of one model's second layer (b0, W1, b1; the lr: b).
__host__ __device__ constexpr int wide_tail(int H, int K) {
  return H ? H + H * K + K : K;
}

// Shared memory one CTA of the resident kernel needs (H = 0: the lr): the
// mbarrier, x's 32 rows, the first layer's k-split partials (at most eight
// [32, 8] tiles), a group's second layers and the warps' totals.
long long eval_wide_smem_bytes(int F, int H, int K) {
  return 16 + 4LL * ((long long)kWideRows * wide_stride(F)
                     + kWideWarps * kWideRows * 8
                     + (long long)wide_group(H ? H : K) * wide_tail(H, K)
                     + 2 * kWideWarps);
}

// The streamed kernel's row stride of a W0 chunk in shared memory, in
// floats: a group of `cols` columns rounded up to n8 tiles, and to 8 (mod
// 16), so the four k rows a B fragment reads fall in four bank octets.
__host__ __device__ constexpr int stream_ns(int cols) {
  return (cols + 7) / 8 * 8 % 16 ? (cols + 7) / 8 * 8 : (cols + 7) / 8 * 8 + 8;
}

// Floats of one stage of the streamed kernel's ring at first-layer width
// L1: a chunk of the tile's 64 rows at stride wide_stride(32) = 36, then
// the widest group's W0 rows of the chunk and their mask values, [32][NS]
// each.
__host__ __device__ constexpr int stream_stage(int L1) {
  return kStreamRows * wide_stride(kStreamChunk)
         + 2 * kStreamChunk * stream_ns(wide_group(L1) * L1);
}

// Floats of the ring: its stages, or the four k-steps' [64][n-tiles * 8]
// partials, which take its place after a tile's last chunk.
__host__ __device__ constexpr int stream_ring(int L1) {
  return kStreamStages * stream_stage(L1)
                 > 4 * kStreamRows * ((wide_group(L1) * L1 + 7) / 8 * 8)
             ? kStreamStages * stream_stage(L1)
             : 4 * kStreamRows * ((wide_group(L1) * L1 + 7) / 8 * 8);
}

// Shared memory one CTA of the streamed kernel needs (H = 0: the lr),
// whatever F: the ring, a group's second layers and the warps' totals.
long long eval_stream_smem_bytes(int H, int K) {
  const int L1 = H ? H : K;
  return 4LL * (stream_ring(L1) + (long long)wide_group(L1) * wide_tail(H, K)
                + 2 * kWideWarps);
}

// The wide route's row tile at these widths: 32 rows resident (the
// resident kernel) where they fit a block, else 64 rows with F streamed in
// chunks (the streamed kernel; fmow's F = 3072: 32 rows of x alone are 394
// KB), else 0 (the wide route does not take the shape).
int eval_wide_rows(int F, int H, int K) {
  return eval_wide_smem_bytes(F, H, K) <= kMaxSmem ? kWideRows
         : eval_stream_smem_bytes(H, K) <= kMaxSmem ? kStreamRows
                                                    : 0;
}

// Row `label`'s count and NLL from its first-layer sums z1 [L1] and its
// model's second layer tl (b0, W1, b1; the lr: b), with the general
// kernel's arithmetic after the first layer's sum: the bias, relu, W1 over
// j in order, then b1 (the lr: the sigmoid). Logit k is computed where the
// score reads it. The streamed kernel calls this and group_totals; the
// resident kernel keeps its own copy of both, which measured 35 % faster
// at MNIST-4's width than calling them (the same outputs bitwise; PERF.md).
template <bool kLr>
__device__ __forceinline__ void wide_score(const float* z1, const float* tl,
                                           int H, int K, int label, int* cnt,
                                           float* nll, bool want_nll) {
  if constexpr (kLr) {
    score_row<0>(
        [&](int k) {
          return __fdiv_rn(1.f,
                           __fadd_rn(1.f, expf(-__fadd_rn(z1[k], tl[k]))));
        },
        K, label, cnt, nll, want_nll);
  } else {
    const float* b0 = tl;
    const float* W1 = b0 + H;
    const float* b1 = W1 + H * K;
    score_row<0>(
        [&](int k) {
          float z = 0.f;
          for (int jj = 0; jj < H; ++jj)
            z = fmaf(fnn_eval::relu(__fadd_rn(z1[jj], b0[jj])),
                     W1[jj * K + k], z);
          return __fadd_rn(z, b1[k]);
        },
        K, label, cnt, nll, want_nll);
  }
}

// A group's cells: lane 0 of warp w < mg holds model g0 + w's totals over
// the CTA's tiles; CTA 0 sums the cluster's CTAs in rank order through
// distributed shared memory and writes cells (g0 + w, c, g). Every thread of
// the cluster calls it.
__device__ __forceinline__ void group_totals(cg::cluster_group& cluster,
                                             const Args& a, int acc_cnt,
                                             float acc_nll, int* s_cnt,
                                             float* s_nll, int g0, int mg,
                                             size_t c, size_t g) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (lane == 0 && warp < mg) {
    s_cnt[warp] = acc_cnt;
    s_nll[warp] = acc_nll;
  }
  cluster.sync();
  if (cluster.block_rank() == 0 && tid < mg) {
    const int Q = (int)cluster.num_blocks();
    int cn = 0;
    float l = 0.f;
    for (int r = 0; r < Q; ++r) {
      cn += *cluster.map_shared_rank(s_cnt + tid, r);
      l += *cluster.map_shared_rank(s_nll + tid, r);
    }
    const size_t out = ((size_t)(g0 + tid) * a.C + c) * a.G + g;
    a.correct[out] = cn;
    if (a.nll) a.nll[out] = l;
  }
  cluster.sync();                   // CTA 0 has read every CTA's totals
}

template <bool kLr>
__global__ void __launch_bounds__(kWideThreads, 1)
eval_wide_kernel(const Args a, int M) {
  constexpr int kMTiles = kWideRows / 16;       // m16 tiles a row tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int F = a.F, H = a.H, K = a.K, N = a.N;
  const int L1 = kLr ? K : H;                   // the first layer's width
  const int P = kLr ? F * K + K : F * H + H + H * K + K;
  const int XS = wide_stride(F), MG = wide_group(L1), TL = wide_tail(H, K);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem_raw);
  float* s_x = reinterpret_cast<float*>(smem_raw + 16);  // [rows][XS]
  float* s_zp = s_x + kWideRows * XS;           // [ksplit][rows][W]
  float* s_l2 = s_zp + kWideWarps * kWideRows * 8;  // [MG][TL]
  int* s_cnt = reinterpret_cast<int*>(s_l2 + MG * TL);  // [warps]
  float* s_nll = reinterpret_cast<float*>(s_cnt + kWideWarps);  // [warps]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g8 = lane >> 2, t4 = lane & 3;      // mma fragment coordinates
  const int Q = (int)cluster.num_blocks(), q = (int)cluster.block_rank();
  const size_t cell = blockIdx.x / Q;           // (c, g)
  const size_t g = cell % a.G, c = cell / a.G;
  const float* xg = a.x + c * a.xs_c + g * a.xs_g;
  const int* yg = a.y + c * a.ys_c + g * a.ys_g;
  const int tiles = (N + kWideRows - 1) / kWideRows;
  const int mine = tiles > q ? (tiles - q + Q - 1) / Q : 0;  // q, q + Q, ..
  const int KS = (F + 7) / 8;
  if (tid == 0) {
    mbar_init(bar, 32);             // warp 0 arrives, a row or none a lane
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  unsigned phase = 0;
  for (int g0 = 0; g0 < M; g0 += MG) {
    const int mg = min(MG, M - g0), cols = mg * L1;
    const int NTg = (cols + 7) / 8, W = NTg * 8;
    const int ksplit = kWideWarps / NTg;        // jobs: ksplit * NTg <= 8
    // the group's second layers, model after model (the barrier before
    // their first read is the tile's)
    for (int e = tid; e < mg * TL; e += kWideThreads) {
      const int i = e / TL;
      s_l2[e] = a.params[(size_t)(g0 + i) * P + F * L1 + (e - i * TL)];
    }
    int acc_cnt = 0;                // lane 0 of warp w: model g0 + w
    float acc_nll = 0.f;
    for (int i = 0; i < mine; ++i) {
      const int row0 = (q + i * Q) * kWideRows;
      const int nrows = min(kWideRows, N - row0);
      if (mine > 1 || g0 == 0) {    // a lone tile stays for every group
        if (warp == 0) {
          if (lane < nrows) {
            fence_proxy_async();
            mbar_expect_tx(bar, (unsigned)(F * 4));
            bulk_copy(s_x + (size_t)lane * XS,
                      xg + (size_t)(row0 + lane) * F, (unsigned)(F * 4), bar);
          } else {
            mbar_arrive(bar);
          }
        }
        mbar_wait(bar, phase & 1u);
        ++phase;
      }

      // the group's first layers on the tensor cores in 3xTF32: x [32, F]
      // times the models' W0 (times their masks) side by side, [F, cols];
      // warp w takes n-tile w % NTg and k-steps w / NTg + ksplit * i, its
      // W0 values read through L2 four k-steps ahead; the small cross
      // products and big * big in accumulators of their own
      if (warp < ksplit * NTg) {
        const int nt = warp % NTg, kq = warp / NTg;
        const int n = nt * 8 + g8;              // this lane's column
        const bool nin = n < cols;
        const int mi = g0 + (nin ? n / L1 : 0), j = nin ? n % L1 : 0;
        const float* wcol = a.params + (size_t)mi * P + j;  // W0[f][j]
        const float* fmc = a.fmask ? a.fmask + (size_t)mi * F : nullptr;
        float accs[kMTiles][4], accb[kMTiles][4];
#pragma unroll
        for (int mt = 0; mt < kMTiles; ++mt)
#pragma unroll
          for (int e = 0; e < 4; ++e) accs[mt][e] = accb[mt][e] = 0.f;
        for (int ks0 = kq; ks0 < KS; ks0 += 4 * ksplit) {
          float bv[4][2];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int f0 = (ks0 + u * ksplit) * 8 + t4, f1 = f0 + 4;
            bv[u][0] = nin && f0 < F ? __ldg(wcol + (size_t)f0 * L1)
                                           * (fmc ? __ldg(fmc + f0) : 1.f)
                                     : 0.f;
            bv[u][1] = nin && f1 < F ? __ldg(wcol + (size_t)f1 * L1)
                                           * (fmc ? __ldg(fmc + f1) : 1.f)
                                     : 0.f;
          }
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int ks = ks0 + u * ksplit;
            if (ks >= KS) break;
            const int f0 = ks * 8 + t4, f1 = f0 + 4;
            const bool in0 = f0 < F, in1 = f1 < F;
            uint32_t bb0, bs0, bb1, bs1;
            split<true>(bv[u][0], bb0, bs0);
            split<true>(bv[u][1], bb1, bs1);
#pragma unroll
            for (int mt = 0; mt < kMTiles; ++mt) {
              const float* xr = s_x + (mt * 16 + g8) * XS;
              const float av[4] = {in0 ? xr[f0] : 0.f,
                                   in0 ? xr[8 * XS + f0] : 0.f,
                                   in1 ? xr[f1] : 0.f,
                                   in1 ? xr[8 * XS + f1] : 0.f};
              uint32_t ab[4], as[4];
              split4<true>(av, ab, as);
              mma_tf32(accs[mt], as, bb0, bb1);
              mma_tf32(accs[mt], ab, bs0, bs1);
              mma_tf32(accb[mt], ab, bb0, bb1);
            }
          }
        }
#pragma unroll
        for (int mt = 0; mt < kMTiles; ++mt) {
          float* o = s_zp + (kq * kWideRows + mt * 16 + g8) * W + nt * 8
                     + 2 * t4;
          o[0] = accb[mt][0] + accs[mt][0];
          o[1] = accb[mt][1] + accs[mt][1];
          o[8 * W] = accb[mt][2] + accs[mt][2];
          o[8 * W + 1] = accb[mt][3] + accs[mt][3];
        }
      }
      __syncthreads();
      if (ksplit > 1) {             // the k-split partials in order
        for (int e = tid; e < kWideRows * cols; e += kWideThreads) {
          const int r = e / cols, cc = e - r * cols;
          float z = 0.f;
          for (int k = 0; k < ksplit; ++k)
            z += s_zp[(k * kWideRows + r) * W + cc];
          s_zp[r * W + cc] = z;
        }
        __syncthreads();
      }

      // the second layer (the lr: the sigmoid) and the score: warp w takes
      // model g0 + w, lane r row row0 + r; logit k is computed where the
      // score reads it, with the general kernel's arithmetic after the
      // first layer's sum (the bias, relu, W1 over j in order, then b1)
      if (warp < mg) {
        const int r = lane;
        int cnt = 0;
        float nll = 0.f;
        if (r < nrows) {
          const float* z1 = s_zp + r * W + warp * L1;
          const float* tl = s_l2 + warp * TL;
          if constexpr (kLr) {
            score_row<0>(
                [&](int k) {
                  return __fdiv_rn(
                      1.f, __fadd_rn(1.f, expf(-__fadd_rn(z1[k], tl[k]))));
                },
                K, yg[row0 + r], &cnt, &nll, a.nll != nullptr);
          } else {
            const float* b0 = tl;
            const float* W1 = b0 + H;
            const float* b1 = W1 + H * K;
            score_row<0>(
                [&](int k) {
                  float z = 0.f;
                  for (int jj = 0; jj < H; ++jj)
                    z = fmaf(fnn_eval::relu(__fadd_rn(z1[jj], b0[jj])),
                             W1[jj * K + k], z);
                  return __fadd_rn(z, b1[k]);
                },
                K, yg[row0 + r], &cnt, &nll, a.nll != nullptr);
          }
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          cnt += __shfl_xor_sync(fnn_eval::kFull, cnt, o);
          nll += __shfl_xor_sync(fnn_eval::kFull, nll, o);
        }
        if (lane == 0) {            // the CTA's tiles in order
          acc_cnt += cnt;
          acc_nll += nll;
        }
      }
      __syncthreads();              // s_x, s_zp and s_l2 are free again
    }

    // the group's cells: CTA 0 sums the Q CTAs' totals in rank order
    if (lane == 0 && warp < mg) {
      s_cnt[warp] = acc_cnt;
      s_nll[warp] = acc_nll;
    }
    cluster.sync();
    if (q == 0 && tid < mg) {
      int cn = 0;
      float l = 0.f;
      for (int r = 0; r < Q; ++r) {
        cn += *cluster.map_shared_rank(s_cnt + tid, r);
        l += *cluster.map_shared_rank(s_nll + tid, r);
      }
      const size_t out = ((size_t)(g0 + tid) * a.C + c) * a.G + g;
      a.correct[out] = cn;
      if (a.nll) a.nll[out] = l;
    }
    cluster.sync();                 // CTA 0 has read every CTA's totals
  }
}

template <bool kLr>
__global__ void __launch_bounds__(kWideThreads, 2)
eval_stream_kernel(const Args a, int M) {
  constexpr int KC = kStreamChunk, XS = wide_stride(kStreamChunk);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int F = a.F, H = a.H, K = a.K, N = a.N;
  const int L1 = kLr ? K : H;                   // the first layer's width
  const int P = kLr ? F * K + K : F * H + H + H * K + K;
  const int MG = wide_group(L1), TL = wide_tail(H, K);
  const int NS = stream_ns(MG * L1), SS = stream_stage(L1);
  float* ring = reinterpret_cast<float*>(smem_raw);  // [stages][SS]: x
                                                // [64][XS], W0 and mask
                                                // [KC][NS] each
  float* s_l2 = ring + stream_ring(L1);         // [MG][TL]
  int* s_cnt = reinterpret_cast<int*>(s_l2 + MG * TL);  // [warps]
  float* s_nll = reinterpret_cast<float*>(s_cnt + kWideWarps);  // [warps]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g8 = lane >> 2, t4 = lane & 3;      // mma fragment coordinates
  const int Q = (int)cluster.num_blocks(), q = (int)cluster.block_rank();
  const size_t cell = blockIdx.x / Q;           // (c, g)
  const size_t g = cell % a.G, c = cell / a.G;
  const float* xg = a.x + c * a.xs_c + g * a.xs_g;
  const int* yg = a.y + c * a.ys_c + g * a.ys_g;
  const int tiles = (N + kStreamRows - 1) / kStreamRows;
  const int mine = tiles > q ? (tiles - q + Q - 1) / Q : 0;  // q, q + Q, ..
  const int chunks = (F + KC - 1) / KC;
  // warp w: m16 tiles 2 mp and 2 mp + 1, k-step kq of every chunk
  const int mp = warp & 1, kq = warp >> 1;
  // this thread's float4 of x in a chunk: column quad xc4 of rows xr and
  // xr + 32
  const int xr = tid >> 3, xc4 = tid & 7;

  for (int g0 = 0; g0 < M; g0 += MG) {
    const int mg = min(MG, M - g0), cols = mg * L1;
    const int NT = (cols + 7) / 8, NZ = NT * 8;
    // this thread's column wn of the group's W0 chunk (and mask), rows wk,
    // wk + KR, ..: 4-byte copies, KR rows of the chunk at once
    const int KR = kWideThreads / cols, wn = tid % cols, wk = tid / cols;
    const int wi = wn / L1;
    const float* wsrc = a.params + (size_t)(g0 + wi) * P + (wn - wi * L1);
    const float* msrc = a.fmask ? a.fmask + (size_t)(g0 + wi) * F : nullptr;
    // the group's second layers, model after model (the barrier before
    // their first read is the first chunk's)
    for (int e = tid; e < mg * TL; e += kWideThreads) {
      const int i = e / TL;
      s_l2[e] = a.params[(size_t)(g0 + i) * P + F * L1 + (e - i * TL)];
    }
    int acc_cnt = 0;                // lane 0 of warp w: model g0 + w
    float acc_nll = 0.f;
    for (int i = 0; i < mine; ++i) {
      const int row0 = (q + i * Q) * kStreamRows;
      const int nrows = min(kStreamRows, N - row0);
      // chunk ch into stage ch % stages: x's rows (zero past F), W0's rows
      // [k0, k0 + 32) of the group's columns and their mask values (zero
      // past F); one commit group a chunk, empty past the last. Rows past
      // N and columns past the group's are not copied: they reach only
      // outputs nobody reads.
      auto issue = [&](int ch) {
        if (ch < chunks) {
          float* st = ring + (ch % kStreamStages) * SS;
          const int k0 = ch * KC;
          const bool xin = k0 + 4 * xc4 < F;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = xr + 32 * h;
            if (r < nrows)
              cp_async16(st + r * XS + 4 * xc4,
                         xg + (size_t)(row0 + r) * F
                             + (xin ? k0 + 4 * xc4 : 0),
                         xin ? 16 : 0);
          }
          if (wk < KR) {
            float* sw = st + kStreamRows * XS;
            for (int k = wk; k < KC; k += KR) {
              const bool in = k0 + k < F;
              const int f = in ? k0 + k : 0;
              cp_async4(sw + k * NS + wn, wsrc + (size_t)f * L1, in);
              if (msrc) cp_async4(sw + (KC + k) * NS + wn, msrc + f, in);
            }
          }
        }
        cp_async_commit();
      };
      for (int ch = 0; ch < kStreamStages - 1; ++ch) issue(ch);

      // the group's first layers on the tensor cores in 3xTF32: x [64, F]
      // times the models' W0 (times their masks) side by side, [F, cols],
      // the sums over the chunks in registers
      float acc[2][kWideCols / 8][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < kWideCols / 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
      for (int ch = 0; ch < chunks; ++ch) {
        cp_async_wait<kStreamStages - 2>();
        __syncthreads();            // chunk ch is here; ch - 1's stage free
        issue(ch + kStreamStages - 1);
        const float* st = ring + (ch % kStreamStages) * SS;
        const float* sw = st + kStreamRows * XS + (kq * 8 + t4) * NS + g8;
        uint32_t ab[2][4], as[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const float* xp = st + ((2 * mp + mt) * 16 + g8) * XS + kq * 8 + t4;
          const float av[4] = {xp[0], xp[8 * XS], xp[4], xp[8 * XS + 4]};
          split4<true>(av, ab[mt], as[mt]);
        }
#pragma unroll
        for (int nt = 0; nt < kWideCols / 8; ++nt) {
          if (nt >= NT) break;
          float b0 = sw[nt * 8], b1 = sw[4 * NS + nt * 8];
          if (msrc) {
            b0 *= sw[KC * NS + nt * 8];
            b1 *= sw[(KC + 4) * NS + nt * 8];
          }
          uint32_t bb0, bs0, bb1, bs1;
          split<true>(b0, bb0, bs0);
          split<true>(b1, bb1, bs1);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            mma_tf32(acc[mt][nt], as[mt], bb0, bb1);
            mma_tf32(acc[mt][nt], ab[mt], bs0, bs1);
            mma_tf32(acc[mt][nt], ab[mt], bb0, bb1);
          }
        }
      }
      cp_async_wait<0>();
      __syncthreads();              // every warp is done with the ring

      // the four k-steps' partials [kq][64][NZ] over the ring, summed in
      // order into [64][NZ]
      float* s_zp = ring;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < kWideCols / 8; ++nt) {
          if (nt >= NT) break;
          float* o = s_zp + (kq * kStreamRows + (2 * mp + mt) * 16 + g8) * NZ
                     + nt * 8 + 2 * t4;
          o[0] = acc[mt][nt][0];
          o[1] = acc[mt][nt][1];
          o[8 * NZ] = acc[mt][nt][2];
          o[8 * NZ + 1] = acc[mt][nt][3];
        }
      __syncthreads();
      for (int e = tid; e < kStreamRows * cols; e += kWideThreads) {
        const int r = e / cols, cc = e - r * cols;
        float z = 0.f;
#pragma unroll
        for (int k = 0; k < 4; ++k) z += s_zp[(k * kStreamRows + r) * NZ + cc];
        s_zp[r * NZ + cc] = z;
      }
      __syncthreads();

      // the second layer (the lr: the sigmoid) and the score: warp w takes
      // model g0 + w, lane r rows row0 + r and row0 + 32 + r in turn
      if (warp < mg) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = lane + 32 * h;
          int cnt = 0;
          float nll = 0.f;
          if (r < nrows)
            wide_score<kLr>(s_zp + r * NZ + warp * L1, s_l2 + warp * TL, H,
                            K, yg[row0 + r], &cnt, &nll, a.nll != nullptr);
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) {
            cnt += __shfl_xor_sync(fnn_eval::kFull, cnt, o);
            nll += __shfl_xor_sync(fnn_eval::kFull, nll, o);
          }
          if (lane == 0) {          // the CTA's half tiles in order
            acc_cnt += cnt;
            acc_nll += nll;
          }
        }
      }
      __syncthreads();              // the ring and s_l2 are free again
    }

    group_totals(cluster, a, acc_cnt, acc_nll, s_cnt, s_nll, g0, mg, c, g);
  }
}

template <int F, int H, int K>
int launch_fused(const Args& a, long long blocks, int threads,
                 cudaStream_t st) {
  eval_fused_kernel<F, H, K><<<(unsigned)blocks, threads, 0, st>>>(a);
  return (int)cudaGetLastError();
}

template <bool kLr>
int launch_general(const Args& a, long long blocks, int threads, int device,
                   cudaStream_t st) {
  const long long P = kLr ? (long long)a.F * a.K + a.K
                          : (long long)a.F * a.H + a.H + a.H * a.K + a.K;
  const long long smem = 4LL * (P + a.F + (long long)a.K * threads);
  if (smem > kMaxSmem - kStaticSmem) return kErrSmem;
  // opt in to more than 48 KB of dynamic shared memory, once per device
  // and kernel
  static std::atomic<unsigned long long> ready{0};
  const unsigned long long bit = device < 64 ? 1ull << device : 0;
  if (smem > 48 * 1024 && !(ready.load() & bit)) {
    const cudaError_t err = cudaFuncSetAttribute(
        eval_general_kernel<kLr>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmem - kStaticSmem);
    if (err != cudaSuccess) return (int)err;
    ready.fetch_or(bit);
  }
  eval_general_kernel<kLr>
      <<<(unsigned)blocks, threads, (size_t)smem, st>>>(a);
  return (int)cudaGetLastError();
}

// A cell kernel of the wide route: C * G cells of Q = min(16, ceil(N /
// rows)) CTAs in clusters of Q (above 8 a non-portable size, which the H100
// allows), `smem` bytes each; the kernel's attributes are set once per
// device (`ready`, one per kernel).
template <typename Kernel>
int launch_cells(Kernel kernel, std::atomic<unsigned long long>& ready,
                 const Args& a, int M, int rows, long long smem, int device,
                 cudaStream_t st) {
  if (smem > kMaxSmem) return kErrSmem;
  const int tiles = (a.N + rows - 1) / rows;
  const int Q = tiles < 1 ? 1 : tiles < kWideMaxCluster ? tiles
                                                       : kWideMaxCluster;
  const long long blocks = (long long)a.C * a.G * Q;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const unsigned long long bit = device < 64 ? 1ull << device : 0;
  if (!(ready.load() & bit)) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
    ready.fetch_or(bit);
  }
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3(kWideThreads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = st;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = (unsigned)Q;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, a, M);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// The wide route: its checks, then the kernel the widths take (the
// resident one at MNIST's, the streamed one at fmow's) and the model.
int launch_wide_any(const Args& a, int M, int device, cudaStream_t st) {
  const int L1 = a.H ? a.H : a.K;
  if (a.F % 4 || L1 < 1 || L1 > kWideCols
      || (reinterpret_cast<uintptr_t>(a.x) & 15)
      || (a.C > 1 && a.xs_c % 4) || (a.G > 1 && a.xs_g % 4))
    return (int)cudaErrorInvalidValue;
  static std::atomic<unsigned long long> ready[4];
  switch (eval_wide_rows(a.F, a.H, a.K)) {
    case kWideRows: {
      const long long smem = eval_wide_smem_bytes(a.F, a.H, a.K);
      return a.H ? launch_cells(eval_wide_kernel<false>, ready[0],
                                a, M, kWideRows, smem, device, st)
                 : launch_cells(eval_wide_kernel<true>, ready[1],
                                a, M, kWideRows, smem, device, st);
    }
    case kStreamRows: {
      const long long smem = eval_stream_smem_bytes(a.H, a.K);
      return a.H ? launch_cells(eval_stream_kernel<false>, ready[2], a, M,
                                kStreamRows, smem, device, st)
                 : launch_cells(eval_stream_kernel<true>, ready[3], a, M,
                                kStreamRows, smem, device, st);
    }
    default:
      return kErrSmem;
  }
}

}  // namespace

// What the wrapper packs for one call (eval_cells.py, _PARAMS).
struct Params {
  unsigned long long params, fmask, x, y, correct, nll;  // device pointers
  long long xs_c, xs_g, ys_c, ys_g;                      // element strides
  int M, C, G, N, F, H, K, threads;
  int device;  // CUDA device index of every tensor
};
static_assert(sizeof(Params) == 120, "Params must match the wrapper's pack");

// Plain C entry point bound with ctypes. `route`: 0 the general kernel, 1
// the fused one (F, H, K must be one of its widths), 2 the wide route (its
// resident or streamed kernel by eval_wide_rows; F % 4 == 0, a first layer
// at most 64 wide, x's rows and strides 16-byte aligned). H = 0 is the lr,
// which the general and wide kernels take.
// `stream` is a stream of device `device`, which is made current for the
// launch only if it is not. Returns the cudaError_t of the launch (0 = ok),
// or kErrSmem (nothing launched) when the general or wide kernel would need
// more shared memory than a block may take.
extern "C" int eval_cells_f32(const Params* p, int route, void* stream) {
  const long long blocks = (long long)p->M * p->C * p->G;
  if (p->M < 1 || p->C < 1 || p->G < 1 || p->N < 0 || p->F < 1 ||
      p->H < 0 || p->K < 1 || blocks > 0x7fffffffLL || p->threads < 32 ||
      p->threads > kMaxThreads || p->threads % 32)
    return (int)cudaErrorInvalidValue;
  const Args a{reinterpret_cast<const float*>(p->params),
               reinterpret_cast<const float*>(p->fmask),
               reinterpret_cast<const float*>(p->x),
               reinterpret_cast<const int*>(p->y),
               reinterpret_cast<int*>(p->correct),
               reinterpret_cast<float*>(p->nll),
               p->xs_c, p->xs_g, p->ys_c, p->ys_g,
               p->C, p->G, p->N, p->F, p->H, p->K};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int current = 0;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != p->device)
    err = cudaSetDevice(p->device);
  if (err != cudaSuccess) return (int)err;
  int ret;
  if (route == 0 && p->H == 0)
    ret = launch_general<true>(a, blocks, p->threads, p->device, st);
  else if (route == 0)
    ret = launch_general<false>(a, blocks, p->threads, p->device, st);
  else if (route == 2)
    ret = launch_wide_any(a, p->M, p->device, st);
  else if (route == 1 && p->F == 3 && p->H == 10 && p->K == 2)
    ret = launch_fused<3, 10, 2>(a, blocks, p->threads, st);
  else if (route == 1 && p->F == 2 && p->H == 10 && p->K == 2)
    ret = launch_fused<2, 10, 2>(a, blocks, p->threads, st);
  else if (route == 1 && p->F == 18 && p->H == 10 && p->K == 2)
    ret = launch_fused<18, 10, 2>(a, blocks, p->threads, st);
  else if (route == 1 && p->F == 5 && p->H == 10 && p->K == 2)
    ret = launch_fused<5, 10, 2>(a, blocks, p->threads, st);
  else
    ret = (int)cudaErrorInvalidValue;
  if (current != p->device) cudaSetDevice(current);
  return ret;
}

// The resident and streamed kernels' shared memory a CTA at these widths
// (H = 0: the lr), in bytes, and the wide route's row tile (32 resident, 64
// streamed, 0: none): eval_cells.py's wide_smem_bytes, stream_smem_bytes
// and wide_rows mirror them.
extern "C" long long eval_cells_wide_smem(int F, int H, int K) {
  return eval_wide_smem_bytes(F, H, K);
}

extern "C" long long eval_cells_stream_smem(int H, int K) {
  return eval_stream_smem_bytes(H, K);
}

extern "C" int eval_cells_wide_rows(int F, int H, int K) {
  return eval_wide_rows(F, H, K);
}
