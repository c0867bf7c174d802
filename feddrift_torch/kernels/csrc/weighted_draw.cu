// Weighted draw of one round's batch rows (K4): float32 weights, int32 rows.
//
// Replaces feddrift_tpu/core/step.py::weight_cdf and inverse_cdf_draw
// (:72-91) as TrainStep._local_sgd applies them to each (model, client)
// pair under weighted_sampling (:237-248, :265-267): KUE's Poisson
// bootstrap, a batch drawn with replacement from the pair's T1*N rows with
// probability p[t, n] proportional to w_t[t] * s_n[n]. The reference has no
// Pallas kernel here: XLA fuses a cumsum and a searchsorted per pair.
//
// What it computes. For each pair (one block): active = sum_t w_t[t] > 0;
// p[t*N + n] = active ? w_t[t] * s_n[n] : 0, and p = 1 everywhere when its
// total is 0 (the reference's uniform fallback: an inactive pair still
// draws, and K1 masks its result); cdf = inclusive cumsum of p divided by
// its last element; then each of the pair's D = S*B uniforms u becomes
// min(#{i : cdf[i] <= u}, L - 1), L = T1*N: searchsorted(side="right")
// and the clip, so a zero-weight row is never drawn.
//
// Bound on the H100 SXM at KUE's canonical shape (M = 4, C = 10, T1 = 11,
// N = 500, S = 5, B = 500): the weights (0.2 MB), the uniforms (0.4 MB)
// and the rows written (0.4 MB) move ~0.9 MB, ~0.27 us at 3.35 TB/s; the
// scan and ~13 comparisons a uniform are ~2 M operations, far under that.
// So bytes bound it, and at 40 blocks on 132 SMs, latency: the scan's two
// barriers and a 13-step search whose loads depend on each other.
//
// Design (simple first): one block of 512 threads a pair. The pair's L
// probabilities are scanned into shared memory (22 KB at SEA's L = 5500):
// each thread scans its contiguous chunk of ~L/512 elements in registers,
// a warp-shuffle scan and a scan of the 16 warp totals give each chunk its
// offset, and the chunk adds it. For integer weights (0/1 time weights
// times Poisson counts) every partial sum is an exact float32 integer, so
// the cdf and every row equal the plain version's (torch.cumsum +
// searchsorted) bit for bit; for other weights the sums round in another
// order than a sequential cumsum. Then one thread a uniform runs the
// binary search over the shared cdf. Above 48 KB the cdf takes the
// dynamic shared memory a block may opt in to (226 KB, L <= 57856);
// beyond that the entry point returns kErrSmem without a launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSmem = 232448;           // a block's shared memory
constexpr int kMaxDynSmem = kMaxSmem - 1024;  // less the static arrays
constexpr int kErrSmem = -1;  // weighted_draw.py's _ERR_SMEM

struct Args {
  const float* time_w;    // [pairs, T1]
  const float* sample_w;  // [pairs, N]
  const float* u;         // [pairs, D]
  int* idx;               // [pairs, D]
  float* cdf_out;         // [pairs, L] or null
  int T1, N, D;
};

// Inclusive scan of v over the warp's lanes.
__device__ __forceinline__ float warp_scan(float v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float up = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += up;
  }
  return v;
}

__global__ void __launch_bounds__(kThreads)
weighted_draw_kernel(const Args a) {
  extern __shared__ float cdf[];          // [L]
  __shared__ float s_warp[kWarps];
  __shared__ float s_total;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int T1 = a.T1, N = a.N, L = T1 * N;
  const size_t pair = blockIdx.x;
  const float* tw = a.time_w + pair * T1;
  const float* sw = a.sample_w + pair * N;

  float wsum = 0.f;                       // every thread, the same order
  for (int t = 0; t < T1; ++t) wsum += tw[t];
  const bool active = wsum > 0.f;

  // this thread's chunk [lo, hi) of the L rows, scanned in order
  const int chunk = (L + kThreads - 1) / kThreads;
  const int lo = min(tid * chunk, L), hi = min(lo + chunk, L);
  float run = 0.f;
  for (int i = lo; i < hi; ++i) {
    const int t = i / N;
    // __fmul_rn: the product rounds before the sum, as in the plain
    // version (no contraction into an fma)
    run += active ? __fmul_rn(tw[t], sw[i - t * N]) : 0.f;
    cdf[i] = run;
  }
  // the chunks' offsets: an exclusive scan of the threads' totals
  const float incl = warp_scan(run, lane);
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const float w = lane < kWarps ? s_warp[lane] : 0.f;
    const float ws = warp_scan(w, lane);
    if (lane < kWarps) s_warp[lane] = ws - w;   // exclusive
  }
  __syncthreads();
  float before = __shfl_up_sync(kFull, incl, 1);   // the lanes below
  if (lane == 0) before = 0.f;
  const float offset = s_warp[warp] + before;
  for (int i = lo; i < hi; ++i) cdf[i] += offset;
  __syncthreads();
  if (tid == 0) s_total = cdf[L - 1];
  __syncthreads();
  const float total = s_total;
  // normalise; a total of 0 takes the uniform fallback, cumsum of ones
  for (int i = tid; i < L; i += kThreads) {
    const float c = total > 0.f ? cdf[i] / total
                                : (float)(i + 1) / (float)L;
    cdf[i] = c;
    if (a.cdf_out) a.cdf_out[pair * L + i] = c;
  }
  __syncthreads();

  const float* u = a.u + pair * a.D;
  int* out = a.idx + pair * a.D;
  for (int j = tid; j < a.D; j += kThreads) {
    const float v = u[j];
    int l = 0, h = L;                     // first i with cdf[i] > v
    while (l < h) {
      const int mid = (l + h) >> 1;
      if (cdf[mid] <= v) l = mid + 1;
      else h = mid;
    }
    out[j] = l < L ? l : L - 1;
  }
}

}  // namespace

// What the wrapper packs for one call (weighted_draw.py, _PARAMS).
struct Params {
  unsigned long long time_w, sample_w, u, idx, cdf_out;  // device pointers
  int pairs, T1, N, D;
  int device;  // CUDA device index of every tensor
};
static_assert(sizeof(Params) == 64, "Params must match the wrapper's pack");

// Plain C entry point bound with ctypes. Every tensor contiguous on device
// `device`; cdf_out may be 0. `stream` is a stream of that device; the
// device is made current for the launch only if it is not. Returns the
// cudaError_t of the launch (0 = ok), or kErrSmem (nothing launched) when
// the cdf would need more shared memory than a block may take.
extern "C" int weighted_draw_f32(const Params* p, void* stream) {
  if (p->pairs < 1 || p->T1 < 1 || p->N < 1 || p->D < 0)
    return (int)cudaErrorInvalidValue;
  const long long smem = 4LL * p->T1 * p->N;
  if (smem > kMaxDynSmem) return kErrSmem;
  const Args a{reinterpret_cast<const float*>(p->time_w),
               reinterpret_cast<const float*>(p->sample_w),
               reinterpret_cast<const float*>(p->u),
               reinterpret_cast<int*>(p->idx),
               reinterpret_cast<float*>(p->cdf_out), p->T1, p->N, p->D};
  int current = 0;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != p->device)
    err = cudaSetDevice(p->device);
  if (err != cudaSuccess) return (int)err;
  // opt in to more than 48 KB of dynamic shared memory, once per device
  static std::atomic<unsigned long long> ready{0};
  const unsigned long long bit = p->device < 64 ? 1ull << p->device : 0;
  if (smem > 48 * 1024 && !(ready.load() & bit)) {
    err = cudaFuncSetAttribute(weighted_draw_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxDynSmem);
    if (err == cudaSuccess) ready.fetch_or(bit);
  }
  int ret = (int)err;
  if (err == cudaSuccess) {
    weighted_draw_kernel<<<p->pairs, kThreads, (size_t)smem,
                           static_cast<cudaStream_t>(stream)>>>(a);
    ret = (int)cudaGetLastError();
  }
  if (current != p->device) cudaSetDevice(current);
  return ret;
}
