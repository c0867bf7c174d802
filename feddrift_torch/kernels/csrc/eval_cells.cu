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
// Design: one block per (m, c, g) (80 blocks for an eval, 440 for
// acc_cells at T1 = 11) of round_up(N, 32) threads, at most 512, one row a
// thread and a loop over the rest. The model's params and mask are staged
// once into shared memory, where every thread reads the same address.
// Two kernels of the one function; the wrapper (eval_cells.py::_route)
// picks one by shape alone, before the launch:
// - eval_fused_kernel<F, H, K> for the registry's widths (F in {2, 3},
//   H = 10, K = 2): x, h and z of a row in registers, fully unrolled.
// - eval_general_kernel<false> for any other width (fnn_hidden_dim = 32,
//   MNIST's F = 784): a loop over the hidden units, each accumulated into
//   the row's K logits kept in shared memory ([K][threads], one column a
//   thread). Its shared memory is 4 * (P + F + K * threads) bytes; above
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
// Both sum in the same order (f, then the bias; j, then the bias; classes
// in order). The block's count and NLL sum fold by a warp-shuffle tree,
// then the warp totals in warp order: a fixed order, so `correct` is exact
// and `nll` is bitwise the same call after call, and a block's result does
// not depend on G or on the strides. No tensor cores: at H = 10 and K = 2
// an mma tile would be mostly padding.
//
// The fused kernel's cell (its row loop, score_row and block_total) lives
// in fnn_eval.cuh, which K1's fused kernel (local_sgd.cu) shares: the fused
// round loop evaluates round r's params inside round r + 1's K1 launch, and
// those cells are bitwise this kernel's. This kernel takes every other
// eval: the last round's of a time step, the per-round path's, acc_matrix
// and acc_cells.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "fnn_eval.cuh"

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
      const float h = fmaxf(__fadd_rn(s, b0[j]), 0.f);
      for (int k = 0; k < K; ++k) z[k * nt] = fmaf(h, W1[j * K + k], z[k * nt]);
    }
    for (int k = 0; k < K; ++k) z[k * nt] = __fadd_rn(z[k * nt], b1[k]);
    score_row<0>([&](int k) { return z[k * nt]; }, K, cl.y[i], &cnt, &nll,
                 a.nll != nullptr);
  }
  block_total(cnt, nll, s_cnt, s_nll, a.correct, a.nll, cl.out);
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
// the fused one (F, H, K must be one of its widths). H = 0 is the lr, which
// only the general kernel takes. `stream` is a stream of
// device `device`, which is made current for the launch only if it is not.
// Returns the cudaError_t of the launch (0 = ok), or kErrSmem (nothing
// launched) when the general kernel would need more shared memory than a
// block may take.
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
  else if (route == 1 && p->F == 3 && p->H == 10 && p->K == 2)
    ret = launch_fused<3, 10, 2>(a, blocks, p->threads, st);
  else if (route == 1 && p->F == 2 && p->H == 10 && p->K == 2)
    ret = launch_fused<2, 10, 2>(a, blocks, p->threads, st);
  else
    ret = (int)cudaErrorInvalidValue;
  if (current != p->device) cudaSetDevice(current);
  return ret;
}
