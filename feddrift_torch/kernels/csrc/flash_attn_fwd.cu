// Flash-attention forward for Hopper (sm_90a), float32.
//
// Replaces the TPU kernel feddrift_tpu/parallel/pallas_attention.py:
// _flash_kernel (body, :35-86) launched by _flash_forward through
// pl.pallas_call (:111). Computes the same function: softmax(q k^T / sqrt(D))
// v over [B*H, L, D] with online softmax, key positions >= L and (when
// causal) kpos > qpos masked to -1e30, output acc / max(l, 1e-30), and key
// tiles wholly above the causal diagonal never read.
//
// Design. One thread block per (q tile of 16 rows, b*h). Four warps; each
// warp owns 4 query rows and keeps their running max m, denominator l and
// output accumulator in registers (lane d owns output dims d, d+32, ...).
// K/V are staged in shared memory 32 keys at a time, one key per lane for
// the score dot products (K rows padded to D+1 floats so the lane-per-key
// reads hit 32 different banks). The grid runs every (q tile, b*h) in
// parallel; the sequential grid axis of the TPU kernel becomes the k-tile
// loop inside the block. Masking is computed from positions in the kernel,
// so nothing is padded or copied around the launch. All math is f32.
//
// Bound at the serving path's shape (B=32, H=4, L=80, D=32, causal): q, k,
// v and out are 4 x 1.3 MB, i.e. ~1.6 us of HBM traffic at 3.35 TB/s, and
// the causal work is ~0.05 GFLOP (0.1 GFLOP without the mask), ~0.8 us at
// the 67 TFLOP/s f32 peak. Either is below a kernel launch: the call is
// bound by launch latency, not by bandwidth or arithmetic. This first
// version uses the scalar f32 FMA path; wgmma/TMA tiles are later work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 4;
constexpr int kBlockQ = kWarps * kRowsPerWarp;
constexpr int kBlockK = 32;
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(kFull, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(kFull, x, off);
  return x;
}

template <int D>
__global__ void __launch_bounds__(kWarps * 32)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     int L, int causal, float scale) {
  constexpr int kDimsPerLane = (D + 31) / 32;
  __shared__ float qs[kBlockQ][D];
  __shared__ float ks[kBlockK][D + 1];
  __shared__ float vs[kBlockK][D];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int q0 = blockIdx.x * kBlockQ;
  const size_t base = (size_t)blockIdx.y * (size_t)L * D;
  const float* qb = q + base;
  const float* kb = k + base;
  const float* vb = v + base;

  for (int i = tid; i < kBlockQ * D; i += blockDim.x) {
    const int r = i / D, d = i % D;
    const int qpos = q0 + r;
    qs[r][d] = qpos < L ? qb[(size_t)qpos * D + d] * scale : 0.f;
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kDimsPerLane];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int t = 0; t < kDimsPerLane; ++t) acc[r][t] = 0.f;
  }

  const int q_last = min(q0 + kBlockQ, L) - 1;
  const int k_end = causal ? q_last + 1 : L;
  for (int k0 = 0; k0 < k_end; k0 += kBlockK) {
    __syncthreads();  // previous tile consumed; q tile visible on first pass
    for (int i = tid; i < kBlockK * D; i += blockDim.x) {
      const int j = i / D, d = i % D;
      const int kpos = k0 + j;
      const bool in = kpos < L;
      ks[j][d] = in ? kb[(size_t)kpos * D + d] : 0.f;
      vs[j][d] = in ? vb[(size_t)kpos * D + d] : 0.f;
    }
    __syncthreads();

    const int kpos = k0 + lane;
    float s[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float kd = ks[lane][d];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r)
        s[r] = fmaf(qs[warp * kRowsPerWarp + r][d], kd, s[r]);
    }

#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int qpos = q0 + warp * kRowsPerWarp + r;
      if (qpos >= L) continue;  // uniform across the warp
      const bool masked = kpos >= L || (causal && kpos > qpos);
      const float sr = masked ? kNegInf : s[r];
      const float m_new = fmaxf(m[r], warp_max(sr));
      const float p = masked ? 0.f : expf(sr - m_new);
      const float corr = expf(m[r] - m_new);
      l[r] = l[r] * corr + warp_sum(p);
#pragma unroll
      for (int t = 0; t < kDimsPerLane; ++t) acc[r][t] *= corr;
#pragma unroll 8
      for (int j = 0; j < kBlockK; ++j) {
        const float pj = __shfl_sync(kFull, p, j);
#pragma unroll
        for (int t = 0; t < kDimsPerLane; ++t) {
          const int d = lane + 32 * t;
          if (d < D) acc[r][t] = fmaf(pj, vs[j][d], acc[r][t]);
        }
      }
      m[r] = m_new;
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int qpos = q0 + warp * kRowsPerWarp + r;
    if (qpos >= L) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int t = 0; t < kDimsPerLane; ++t) {
      const int d = lane + 32 * t;
      if (d < D) o[base + (size_t)qpos * D + d] = acc[r][t] * inv;
    }
  }
}

template <int D>
cudaError_t launch(const float* q, const float* k, const float* v, float* o,
                   int bh, int L, int causal, float scale, cudaStream_t st) {
  const dim3 grid((L + kBlockQ - 1) / kBlockQ, bh);
  flash_fwd_f32_kernel<D><<<grid, kWarps * 32, 0, st>>>(q, k, v, o, L, causal,
                                                        scale);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point bound with ctypes. q, k, v, o: contiguous float32
// [bh, L, D] on the current device; `stream` is a stream of that device.
// Returns the cudaError_t of the launch (0 = ok).
extern "C" int flash_attn_fwd_f32(const float* q, const float* k,
                                  const float* v, float* o, int bh, int L,
                                  int D, int causal, float scale,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 8: return (int)launch<8>(q, k, v, o, bh, L, causal, scale, st);
    case 16: return (int)launch<16>(q, k, v, o, bh, L, causal, scale, st);
    case 32: return (int)launch<32>(q, k, v, o, bh, L, causal, scale, st);
    case 64: return (int)launch<64>(q, k, v, o, bh, L, causal, scale, st);
    case 128: return (int)launch<128>(q, k, v, o, bh, L, causal, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
