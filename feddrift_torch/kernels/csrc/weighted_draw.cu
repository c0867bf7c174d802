// Weighted draw of a round's batch rows (K4), in two kernels: the cdf once
// a time step (K4a, weighted_cdf) and the search once a round (K4b,
// weighted_search). float32 weights and cdf, int32 rows.
//
// Replaces feddrift_tpu/core/step.py::weight_cdf and inverse_cdf_draw
// (:72-91) as TrainStep._local_sgd applies them to each (model, client)
// pair under weighted_sampling (:237-248, :265-267): KUE's Poisson
// bootstrap, a batch drawn with replacement from the pair's T1*N rows with
// probability p[t, n] proportional to w_t[t] * s_n[n]. The reference has no
// Pallas kernel here: XLA fuses a cumsum and a searchsorted per pair, once
// per (model, client) round.
//
// What it computes. K4a, for each pair: active = sum_t w_t[t] > 0;
// p[t*N + n] = active ? w_t[t] * s_n[n] : 0, and p = 1 everywhere when its
// total is 0 (the reference's uniform fallback: an inactive pair still
// draws, and K1 masks its result); cdf = inclusive cumsum of p divided by
// its last element. K4b, for each pair and each of its D = S*B uniforms u:
// min(#{i : cdf[i] <= u}, L - 1), L = T1*N (searchsorted(side="right") and
// the clip, so a zero-weight row is never drawn), over the step's cdf where
// the round's total weight total_w > 0 and over the uniform cdf
// (i + 1) / L where it is 0.
//
// Why two kernels. Within a time step only the client mask changes between
// rounds, and it only sets an unsampled client's pair weights to 0: such a
// pair draws from the uniform fallback, and a sampled pair's weights are
// its unmasked ones. So the cdf of the step's unmasked weights, computed
// once, gives every round's rows: K4a runs once a step, K4b once a round,
// given the round's masked total_w (which K1 reads too).
//
// Bound on the H100 SXM at KUE's canonical shape (M = 4, C = 10, T1 = 11,
// N = 500, S = 5, B = 500). K4a: the weights (0.2 MB) in and the cdf
// (0.88 MB) out, ~0.32 us at 3.35 TB/s. K4b: the uniforms (0.4 MB) in, the
// rows (0.4 MB) out and the cdf of the weighted pairs (0.88 MB, from L2 in
// practice), ~0.5 us; ~13 comparisons a uniform are far under that. Bytes
// bound both, and at these sizes a launch's latency.
//
// K4a design: one block of 512 threads a pair (it runs once a step). The
// pair's L probabilities are scanned into shared memory (22 KB at SEA's
// L = 5500): each thread scans its contiguous chunk of ~L/512 elements in
// registers, a warp-shuffle scan and a scan of the 16 warp totals give each
// chunk its offset, and the chunk adds it; then the block normalises and
// writes the cdf. For integer weights (0/1 time weights times Poisson
// counts) every partial sum is an exact float32 integer, so the cdf equals
// the plain version's (torch.cumsum) bit for bit; for other weights the
// sums round in another order than a sequential cumsum.
//
// K4b design: each pair's D uniforms are split over ceil(D / 1024) blocks
// of up to 1024 threads, one uniform a thread (KUE's shape: 40 pairs x 3
// blocks of 864 threads, 120 blocks on 132 SMs). A block of a weighted
// pair stages the pair's cdf into shared memory with one TMA bulk copy
// (cp.async.bulk on an mbarrier; the < 16 bytes before and after its
// 16-byte-aligned body by plain loads), its threads having issued their
// uniform's load first, so that load overlaps the copy; the ~13-step
// binary search then runs in shared memory. A block of a pair with
// total_w == 0 copies nothing and computes the uniform cdf in registers.
//
// Both kernels hold the pair's L floats in shared memory; above what a
// block may take (L > 57856) an entry point returns kErrSmem without a
// launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kCdfThreads = 512;
constexpr int kCdfWarps = kCdfThreads / 32;
constexpr int kSearchMaxThreads = 1024;
constexpr int kMaxSmem = 232448;               // a block's shared memory
constexpr int kMaxRows = (kMaxSmem - 1024) / 4;  // L <= 57856
constexpr int kErrSmem = -1;  // weighted_draw.py's _ERR_SMEM
constexpr int kMaxGridY = 65535;

struct CdfArgs {
  const float* time_w;    // [pairs, T1]
  const float* sample_w;  // [pairs, N]
  float* cdf;             // [pairs, L]
  int T1, N;
};

struct SearchArgs {
  const float* cdf;       // [pairs, L]
  const float* total_w;   // [pairs]
  const float* u;         // [pairs, D]
  int* idx;               // [pairs, D]
  int L, D;
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

__global__ void __launch_bounds__(kCdfThreads)
weighted_cdf_kernel(const CdfArgs a) {
  extern __shared__ float cdf[];          // [L]
  __shared__ float s_warp[kCdfWarps];
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
  const int chunk = (L + kCdfThreads - 1) / kCdfThreads;
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
    const float w = lane < kCdfWarps ? s_warp[lane] : 0.f;
    const float ws = warp_scan(w, lane);
    if (lane < kCdfWarps) s_warp[lane] = ws - w;   // exclusive
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
  float* out = a.cdf + pair * L;
  for (int i = tid; i < L; i += kCdfThreads)
    out[i] = total > 0.f ? cdf[i] / total : (float)(i + 1) / (float)L;
}

// ---------------------------------------------------------------------------
// K4b's staging copy (sm_90: a TMA bulk copy completing on an mbarrier).

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Wait for the phase of parity `parity` to complete. A copy of a few tens
// of KB lands in microseconds; a wait that has not ended after 2^24 tries
// is a fault, and the trap ends the launch with an error instead of a hang.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done;
  for (uint32_t tries = 0;; ++tries) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    if (done) return;
    if (tries == (1u << 24)) __trap();
  }
}

// Thread 0 alone: initialise the block's mbarrier, have it expect `bytes`
// and start the bulk copy of `bytes` (a multiple of 16, both addresses
// 16-byte aligned) from src to dst.
__device__ __forceinline__ void bulk_stage(float* dst, const float* src,
                                           unsigned bytes, uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
               :: "r"(smem_addr(bar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__global__ void __launch_bounds__(kSearchMaxThreads)
weighted_search_kernel(const SearchArgs a) {
  extern __shared__ __align__(16) float s_raw[];   // [L + 3]
  __shared__ __align__(8) uint64_t bar;
  const int tid = threadIdx.x, L = a.L, D = a.D;
  const size_t pair = blockIdx.x;
  const int j = blockIdx.y * blockDim.x + tid;     // this thread's uniform
  // issued first, so that its latency overlaps the cdf's copy
  const float v = j < D ? a.u[pair * D + j] : 0.f;
  const bool weighted = a.total_w[pair] > 0.f;     // the same for the block

  // the row's first h floats lie before a 16-byte boundary; s is offset so
  // that s + h lies on one in shared memory too
  const float* g = a.cdf + pair * L;
  const int h = min((int)(((16u - (reinterpret_cast<uintptr_t>(g) & 15u))
                           & 15u) >> 2), L);
  const int body = (L - h) & ~3;
  float* s = s_raw + ((4 - h) & 3);
  if (weighted) {
    if (tid == 0 && body > 0)
      bulk_stage(s + h, g + h, (unsigned)body * 4u, &bar);
    for (int i = tid; i < h; i += blockDim.x) s[i] = g[i];
    for (int i = h + body + tid; i < L; i += blockDim.x) s[i] = g[i];
  }
  __syncthreads();              // the mbarrier's init, the head and tail
  if (weighted && body > 0) mbar_wait(&bar, 0);
  if (j >= D) return;

  int lo = 0, hi = L;           // the first i with cdf[i] > v
  if (weighted) {
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (s[mid] <= v) lo = mid + 1;
      else hi = mid;
    }
  } else {                      // the uniform cdf, as K4a writes it
    const float fl = (float)L;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if ((float)(mid + 1) / fl <= v) lo = mid + 1;
      else hi = mid;
    }
  }
  a.idx[pair * D + j] = lo < L ? lo : L - 1;
}

// Make `device` current for a launch, remembering the caller's device.
cudaError_t enter(int device, int* current) {
  cudaError_t err = cudaGetDevice(current);
  if (err == cudaSuccess && *current != device) err = cudaSetDevice(device);
  return err;
}

// Opt in to more than 48 KB of dynamic shared memory, once per device.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, std::atomic<unsigned long long>& ready,
                       int device, int bytes) {
  const unsigned long long bit = device < 64 ? 1ull << device : 0;
  if (ready.load() & bit) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) ready.fetch_or(bit);
  return err;
}

}  // namespace

// What the wrapper packs for one K4a call (weighted_draw.py, _CDF_PARAMS).
struct CdfParams {
  unsigned long long time_w, sample_w, cdf;  // device pointers
  int pairs, T1, N;
  int device;  // CUDA device index of every tensor
};
static_assert(sizeof(CdfParams) == 40, "CdfParams must match the wrapper");

// What the wrapper packs for one K4b call (weighted_draw.py,
// _SEARCH_PARAMS).
struct SearchParams {
  unsigned long long cdf, total_w, u, idx;  // device pointers
  int pairs, L, D;
  int device;  // CUDA device index of every tensor
};
static_assert(sizeof(SearchParams) == 48,
              "SearchParams must match the wrapper");

// Plain C entry points bound with ctypes. Every tensor contiguous on device
// `device`; `stream` is a stream of that device, which is made current for
// the launch only if it is not. Each returns the cudaError_t of its launch
// (0 = ok), or kErrSmem (nothing launched) when a pair's L floats need more
// shared memory than a block may take.
extern "C" int weighted_cdf_f32(const CdfParams* p, void* stream) {
  if (p->pairs < 1 || p->T1 < 1 || p->N < 1)
    return (int)cudaErrorInvalidValue;
  const long long L = (long long)p->T1 * p->N;
  if (L > kMaxRows) return kErrSmem;
  const CdfArgs a{reinterpret_cast<const float*>(p->time_w),
                  reinterpret_cast<const float*>(p->sample_w),
                  reinterpret_cast<float*>(p->cdf), p->T1, p->N};
  int current = 0;
  cudaError_t err = enter(p->device, &current);
  if (err != cudaSuccess) return (int)err;
  const int smem = (int)(4 * L);
  if (smem > 48 * 1024) {
    static std::atomic<unsigned long long> ready{0};
    err = allow_smem(weighted_cdf_kernel, ready, p->device, 4 * kMaxRows);
  }
  int ret = (int)err;
  if (err == cudaSuccess) {
    weighted_cdf_kernel<<<p->pairs, kCdfThreads, (size_t)smem,
                          static_cast<cudaStream_t>(stream)>>>(a);
    ret = (int)cudaGetLastError();
  }
  if (current != p->device) cudaSetDevice(current);
  return ret;
}

extern "C" int weighted_search_f32(const SearchParams* p, void* stream) {
  if (p->pairs < 1 || p->L < 1 || p->D < 1)
    return (int)cudaErrorInvalidValue;
  if (p->L > kMaxRows) return kErrSmem;
  // ceil(D / 1024) blocks a pair, the uniforms spread evenly over them
  const int blocks = (p->D + kSearchMaxThreads - 1) / kSearchMaxThreads;
  if (blocks > kMaxGridY) return (int)cudaErrorInvalidValue;
  const int per = (p->D + blocks - 1) / blocks;
  const int threads = (per + 31) / 32 * 32;
  const SearchArgs a{reinterpret_cast<const float*>(p->cdf),
                     reinterpret_cast<const float*>(p->total_w),
                     reinterpret_cast<const float*>(p->u),
                     reinterpret_cast<int*>(p->idx), p->L, p->D};
  int current = 0;
  cudaError_t err = enter(p->device, &current);
  if (err != cudaSuccess) return (int)err;
  const int smem = 4 * (p->L + 3);
  if (smem > 48 * 1024) {
    static std::atomic<unsigned long long> ready{0};
    err = allow_smem(weighted_search_kernel, ready, p->device,
                     4 * (kMaxRows + 3));
  }
  int ret = (int)err;
  if (err == cudaSuccess) {
    weighted_search_kernel<<<dim3(p->pairs, blocks), threads, (size_t)smem,
                             static_cast<cudaStream_t>(stream)>>>(a);
    ret = (int)cudaGetLastError();
  }
  if (current != p->device) cudaSetDevice(current);
  return ret;
}
