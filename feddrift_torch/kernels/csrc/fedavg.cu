// Masked, sample-weighted FedAvg of one round (K2), float32.
//
// Replaces feddrift_tpu/resilience/robust_agg.py::agg_mean (:139-141) with
// the pieces it applies, weighted_mean (:93-112), _active_counts and
// _stats (:115-126): the reference's `mean` aggregator at the end of
// _round_body. The reference has no Pallas kernel here: XLA fuses the
// reduction over the client axis.
//
// What it computes. For each model m, over its clients c = 0..C-1 with
// weights n[m, c] >= 0 (0 for a client that did not train this round):
// denom = sum_c n[m, c]; w[c] = n[m, c] / max(denom, 1e-12);
// out[m, p] = denom > 0 ? sum_c client[m, c, p] * w[c] : prev[m, p]; and
// stats[m] = (#{c : n[m, c] > 0}, 0, 0), the (active, rejected, clipped)
// counts of the mean, which rejects and clips nothing. A client with
// n = 0 is read and weighted by 0, as in the plain version; a model with
// no active client returns prev bitwise.
//
// Bound on the H100 SXM at the canonical shape (M = 4, C = 10, P = 62):
// the client stack (9.9 KB), n, prev, out and stats move ~12 KB, ~3.6 ns at
// 3.35 TB/s; 2·M·C·P ~ 5 K operations are less. So bytes bound it, and at
// this size one launch's latency is the whole cost: the kernel exists to
// replace the plain version's ~13 launches a round with one.
//
// Design: grid (ceil(P / 256), M), so P = 62 runs one block a model and a
// wider model (P in the thousands) spreads over the SMs without a second
// route. Thread 0 of each block sums denom in client order 0..C-1 and
// counts the active clients; the block stages w[c] in shared memory (an
// IEEE division each). Thread p then sums its parameter over c in the same
// fixed order, each product rounded before its add (__fmul_rn, __fadd_rn:
// no contraction into an fma, as the plain version multiplies, then sums).
// The result is bitwise the same call after call. Block x = 0 writes the
// model's stats row, which may be a row of a caller's [R, M, 3] buffer.
// The weights take 4·C bytes of dynamic shared memory; above what a block
// may take (C > ~58000) the entry point returns kErrSmem without a launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDynSmem = 232448 - 1024;   // a block's shared memory
constexpr int kErrSmem = -1;                 // fedavg.py's _ERR_SMEM
constexpr int kMaxGridY = 65535;

struct Args {
  const float* client;  // [M, C, P]
  const float* n;       // [M, C]
  const float* prev;    // [M, P]
  float* out;           // [M, P]
  float* stats;         // [M, 3]
  int C, P;
};

__global__ void __launch_bounds__(kThreads) fedavg_kernel(const Args a) {
  extern __shared__ float w[];               // [C] normalised weights
  __shared__ float s_denom;
  const int tid = threadIdx.x, C = a.C, P = a.P;
  const size_t m = blockIdx.y;
  const float* n = a.n + m * C;
  if (tid == 0) {
    float denom = 0.f;
    int active = 0;
    for (int c = 0; c < C; ++c) {
      const float v = n[c];
      denom = __fadd_rn(denom, v);
      active += v > 0.f;
    }
    s_denom = denom;
    if (blockIdx.x == 0) {
      float* st = a.stats + m * 3;
      st[0] = (float)active;
      st[1] = 0.f;
      st[2] = 0.f;
    }
  }
  __syncthreads();
  const float denom = s_denom;
  const float safe = fmaxf(denom, 1e-12f);
  for (int c = tid; c < C; c += kThreads) w[c] = __fdiv_rn(n[c], safe);
  __syncthreads();
  const int p = blockIdx.x * kThreads + tid;
  if (p >= P) return;
  const size_t mp = m * P + p;
  if (!(denom > 0.f)) {                      // no active client: keep prev
    a.out[mp] = a.prev[mp];
    return;
  }
  const float* col = a.client + m * (size_t)C * P + p;
  float acc = 0.f;
  for (int c = 0; c < C; ++c)
    acc = __fadd_rn(acc, __fmul_rn(col[(size_t)c * P], w[c]));
  a.out[mp] = acc;
}

}  // namespace

// What the wrapper packs for one call (fedavg.py, _PARAMS).
struct Params {
  unsigned long long client, n, prev, out, stats;  // device pointers
  int M, C, P;
  int device;  // CUDA device index of every tensor
};
static_assert(sizeof(Params) == 56, "Params must match the wrapper's pack");

// Plain C entry point bound with ctypes. Every tensor contiguous on device
// `device`; `stream` is a stream of that device, which is made current for
// the launch only if it is not. Returns the cudaError_t of the launch (0 =
// ok), or kErrSmem (nothing launched) when C weights need more shared
// memory than a block may take.
extern "C" int fedavg_f32(const Params* p, void* stream) {
  if (p->M < 1 || p->C < 1 || p->P < 1 || p->M > kMaxGridY)
    return (int)cudaErrorInvalidValue;
  const long long smem = 4LL * p->C;
  if (smem > kMaxDynSmem) return kErrSmem;
  const Args a{reinterpret_cast<const float*>(p->client),
               reinterpret_cast<const float*>(p->n),
               reinterpret_cast<const float*>(p->prev),
               reinterpret_cast<float*>(p->out),
               reinterpret_cast<float*>(p->stats), p->C, p->P};
  int current = 0;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != p->device)
    err = cudaSetDevice(p->device);
  if (err != cudaSuccess) return (int)err;
  // opt in to more than 48 KB of dynamic shared memory, once per device
  static std::atomic<unsigned long long> ready{0};
  const unsigned long long bit = p->device < 64 ? 1ull << p->device : 0;
  if (smem > 48 * 1024 && !(ready.load() & bit)) {
    err = cudaFuncSetAttribute(fedavg_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxDynSmem);
    if (err == cudaSuccess) ready.fetch_or(bit);
  }
  int ret = (int)err;
  if (err == cudaSuccess) {
    const dim3 grid((p->P + kThreads - 1) / kThreads, p->M);
    fedavg_kernel<<<grid, kThreads, (size_t)smem,
                    static_cast<cudaStream_t>(stream)>>>(a);
    ret = (int)cudaGetLastError();
  }
  if (current != p->device) cudaSetDevice(current);
  return ret;
}
