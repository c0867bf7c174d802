// Per-row Dense of the serving forward (float32): y[b] = x[b] @ W[b] + bias[b].
//
// Replaces nothing in Pallas: the reference serves a mixed-model micro-batch
// by vmapping flax's nn.Dense over per-row gathered params
// (feddrift_tpu/models/transformer.py: qkv, proj, Dense_0, Dense_1, lm_head)
// and leaves the products to XLA. The port first ran them as torch.bmm, and
// cuBLAS picks another GEMM (another summation order) when the batch count
// changes, so a request's logits depended on the micro-batch it was served
// in (up to 2.6e-6 on the H100). This kernel is the repair.
//
// The rule that makes a row batch-invariant: the launch geometry and the
// order of the k loop depend on (L, in, out) only, never on B. Grid
// (B, ceil(L / TL), ceil(out / TO)); each block computes one TL x TO output
// tile of one row b, each thread an RL x RO register tile of it, every
// output summed over k = 0, 1, ..., in - 1 in that order with one fmaf per
// term, starting from 0; the bias is added once at the end. No split-K, no
// atomics. The tile comes from dense_rows.py::_launch_config(L, in, out).
//
// Bound on the H100 SXM. At the serving shapes (b32, L = 80, E = 128) one
// forward's five Dense layers do ~2.0 GFLOP over ~50 MB of per-row weights:
// ~30 us at the 67 TFLOP/s float32 rate, ~15 us of bytes, so bound by
// operations. This first design is SIMT float32 FMAs: k tiles of 32 staged
// in shared memory (x rows padded to 36 floats, so the four rows a thread
// reads fall in distinct banks; W read as float4), a 4 x 4 register tile a
// thread (one output per thread for L = 1, the lm_head's last position).
// Tensor cores (3xTF32 mma.sync or wgmma, as the flash kernel does) are the
// next step; this one is simple and right first.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTK = 32;   // k depth of one staged tile

struct Args {
  const float* x;       // [B, L, in], strides xs_b, xs_l, 1
  const float* w;       // [B, in, out], strides ws_b, ws_k, 1
  const float* bias;    // [B, out], strides bs_b, 1; or null
  float* y;             // [B, L, out], contiguous
  long long xs_b, xs_l, ws_b, ws_k, bs_b;
  int L, in, out;
};

template <int TL, int TO, int RL, int RO>
__global__ void __launch_bounds__((TL / RL) * (TO / RO))
dense_rows_kernel(const Args a) {
  constexpr int kThreads = (TL / RL) * (TO / RO);
  static_assert(kThreads == TO && kThreads % kTK == 0,
                "a thread stages one column of W's k tile");
  constexpr int kXPad = kTK + 4;
  __shared__ float xs[TL][kXPad];
  __shared__ __align__(16) float ws[kTK][TO];

  const long long b = blockIdx.x;
  const int l0 = blockIdx.y * TL, o0 = blockIdx.z * TO;
  const int tid = threadIdx.x;
  const int r0 = (tid / (TO / RO)) * RL, c0 = (tid % (TO / RO)) * RO;
  const float* xb = a.x + b * a.xs_b;
  const float* wb = a.w + b * a.ws_b;

  float acc[RL][RO];
#pragma unroll
  for (int i = 0; i < RL; ++i)
#pragma unroll
    for (int j = 0; j < RO; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < a.in; k0 += kTK) {
    // stage x[l0 : l0+TL, k0 : k0+kTK] and W[k0 : k0+kTK, o0 : o0+TO];
    // outside the tensors the tile holds 0, which adds exactly nothing.
    // Thread t stages column k0 + t % kTK of x's rows t / kTK, ... and
    // column o0 + t of W's k tile: neighbouring threads, neighbouring
    // addresses.
    {
      const int kk = tid % kTK, k = k0 + kk;
#pragma unroll
      for (int r = tid / kTK; r < TL; r += kThreads / kTK) {
        const int l = l0 + r;
        xs[r][kk] = (l < a.L && k < a.in) ? __ldg(xb + l * a.xs_l + k) : 0.f;
      }
      const int o = o0 + tid;
      const float* wk = wb + k0 * a.ws_k + o;
#pragma unroll 4
      for (int kk2 = 0; kk2 < kTK; ++kk2)
        ws[kk2][tid] = (o < a.out && k0 + kk2 < a.in)
                           ? __ldg(wk + kk2 * a.ws_k) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTK; ++kk) {
      float xv[RL], wv[RO];
#pragma unroll
      for (int i = 0; i < RL; ++i) xv[i] = xs[r0 + i][kk];
      if constexpr (RO == 4) {
        const float4 t = *reinterpret_cast<const float4*>(&ws[kk][c0]);
        wv[0] = t.x; wv[1] = t.y; wv[2] = t.z; wv[3] = t.w;
      } else {
#pragma unroll
        for (int j = 0; j < RO; ++j) wv[j] = ws[kk][c0 + j];
      }
#pragma unroll
      for (int i = 0; i < RL; ++i)
#pragma unroll
        for (int j = 0; j < RO; ++j) acc[i][j] = fmaf(xv[i], wv[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* yb = a.y + b * a.L * a.out;
#pragma unroll
  for (int i = 0; i < RL; ++i) {
    const int l = l0 + r0 + i;
    if (l >= a.L) continue;
#pragma unroll
    for (int j = 0; j < RO; ++j) {
      const int o = o0 + c0 + j;
      if (o >= a.out) continue;
      float v = acc[i][j];
      if (a.bias != nullptr) v += __ldg(a.bias + b * a.bs_b + o);
      yb[(long long)l * a.out + o] = v;
    }
  }
}

template <int TL, int TO, int RL, int RO>
cudaError_t launch(const Args& a, int B, cudaStream_t st) {
  const dim3 grid(B, (a.L + TL - 1) / TL, (a.out + TO - 1) / TO);
  dense_rows_kernel<TL, TO, RL, RO>
      <<<grid, (TL / RL) * (TO / RO), 0, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

// What the wrapper packs for one call (dense_rows.py, _PARAMS).
struct Params {
  unsigned long long x, w, bias, y;          // device pointers (bias 0: none)
  long long xs_b, xs_l, ws_b, ws_k, bs_b;    // strides in floats
  int B, L, in, out;
  int tile_l;                                // _launch_config's TL: 16 or 1
  int device;                                // CUDA device of every tensor
};
static_assert(sizeof(Params) == 96, "Params must match the wrapper's pack");

// Plain C entry point bound with ctypes. x, w, bias: float32 with stride 1
// in their last dimension; y: contiguous float32 [B, L, out]. tile_l picks
// the build: 16 (16 x 64 tiles, 4 x 4 a thread) or 1 (1 x 64, one output a
// thread). `stream` is a stream of `device`; the device is made current for
// the launch only if it is not. Returns the cudaError_t of the launch.
extern "C" int dense_rows_f32(const Params* p, void* stream) {
  if (p->B < 1 || p->L < 1 || p->in < 0 || p->out < 1)
    return (int)cudaErrorInvalidValue;
  const Args a{reinterpret_cast<const float*>(p->x),
               reinterpret_cast<const float*>(p->w),
               reinterpret_cast<const float*>(p->bias),
               reinterpret_cast<float*>(p->y),
               p->xs_b, p->xs_l, p->ws_b, p->ws_k, p->bs_b,
               p->L, p->in, p->out};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int current = 0;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != p->device)
    err = cudaSetDevice(p->device);
  if (err != cudaSuccess) return (int)err;
  switch (p->tile_l) {
    case 16: err = launch<16, 64, 4, 4>(a, p->B, st); break;
    case 1: err = launch<1, 64, 1, 1>(a, p->B, st); break;
    default: err = cudaErrorInvalidValue;
  }
  if (current != p->device) cudaSetDevice(current);
  return (int)err;
}
