// The pointwise part of one LSTM time step, forward and backward, in float32
// and float64.
//
// Replaces no Pallas kernel: the JAX package's LSTMs (feddrift_tpu/models/
// rnn.py, flax's OptimizedLSTMCell) leave the cell to XLA, which fuses its
// gate activations and state update into the scan's step. In PyTorch the
// same step is ~15 separate elementwise launches forward and more backward;
// this file does each direction in one.
//
// What it computes. Forward, for each row r < R and unit j < H, from the
// gate pre-activations z [R, 4H] (x·W_i + (h·W_h + b), gate order i, f, g,
// o along the row, flax's concatenation order) and the carry c [R, H]:
//   i = σ(z_i), f = σ(z_f), g = tanh(z_g), o = σ(z_o)
//   c' = f·c + i·g,  h' = o·tanh(c')
// and writes h' [R, H], c' [R, H] and the activated gates [R, 4H] (i, f, g,
// o), which the backward reads. σ(x) = 1 / (1 + exp(-x)), as
// torch.sigmoid. Backward, from dh' and dc' [R, H], the gates, c and c':
//   t = tanh(c'),  dct = dc' + dh'·o·(1 - t²)
//   dz_i = dct·g·i(1 - i), dz_f = dct·c·f(1 - f), dz_g = dct·i·(1 - g²),
//   dz_o = dh'·t·o(1 - o),  dc = dct·f
// and writes dz [R, 4H] and dc [R, H]. The plain version
// (kernels/lstm_cell.py: lstm_cell_fwd_ref, lstm_cell_bwd_ref) takes the
// same steps in the same order.
//
// Bound on the H100 SXM: bytes. The forward moves 11·R·H values (z and c in;
// h', c' and the gates out), the backward 13·R·H (dh', dc', the gates, c and
// c' in; dz and dc out); ~20 and ~25 operations a unit are far below what
// those bytes allow. At the CharLSTM's R = 960 (30 pairs of 32 rows) and H =
// 256 the forward moves 10.8 MB, ~3.2 us at 3.35 TB/s, so one launch's
// latency is most of its cost.
//
// Design: one thread a (row, unit), rows outer, so a warp reads 32
// neighbouring units of each of the five (forward) or eight (backward)
// arrays: coalesced, no shared memory, no reduction. The grid covers R·H
// threads in blocks of 256; the last block's threads past R·H return, which
// guards H = 670 (no multiple of 32) and any R. Accurate expf / tanhf (no
// fast-math intrinsics), so the kernel stays within a few ulp of the plain
// version.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float exp_(float x) { return expf(x); }
__device__ __forceinline__ double exp_(double x) { return exp(x); }
__device__ __forceinline__ float tanh_(float x) { return tanhf(x); }
__device__ __forceinline__ double tanh_(double x) { return tanh(x); }

template <typename T>
__device__ __forceinline__ T sigmoid_(T x) {
  return T(1) / (T(1) + exp_(-x));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    lstm_cell_fwd_kernel(const T* __restrict__ z, const T* __restrict__ c,
                         T* __restrict__ h_out, T* __restrict__ c_out,
                         T* __restrict__ gates, int R, int H) {
  const long long k = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (k >= (long long)R * H) return;
  const long long r = k / H;
  const int j = (int)(k - r * H);
  const T* zr = z + r * 4 * H + j;
  T* gr = gates + r * 4 * H + j;
  const T i = sigmoid_(zr[0]);
  const T f = sigmoid_(zr[H]);
  const T g = tanh_(zr[2 * H]);
  const T o = sigmoid_(zr[3 * H]);
  const T cn = f * c[k] + i * g;
  c_out[k] = cn;
  h_out[k] = o * tanh_(cn);
  gr[0] = i;
  gr[H] = f;
  gr[2 * H] = g;
  gr[3 * H] = o;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    lstm_cell_bwd_kernel(const T* __restrict__ dh, const T* __restrict__ dcn,
                         const T* __restrict__ gates, const T* __restrict__ c,
                         const T* __restrict__ cn, T* __restrict__ dz,
                         T* __restrict__ dc, int R, int H) {
  const long long k = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (k >= (long long)R * H) return;
  const long long r = k / H;
  const int j = (int)(k - r * H);
  const T* gr = gates + r * 4 * H + j;
  T* dzr = dz + r * 4 * H + j;
  const T i = gr[0], f = gr[H], g = gr[2 * H], o = gr[3 * H];
  const T t = tanh_(cn[k]);
  const T dhk = dh[k];
  const T dct = dcn[k] + dhk * o * (T(1) - t * t);
  dzr[0] = dct * g * i * (T(1) - i);
  dzr[H] = dct * c[k] * f * (T(1) - f);
  dzr[2 * H] = dct * i * (T(1) - g * g);
  dzr[3 * H] = dhk * t * o * (T(1) - o);
  dc[k] = dct * f;
}

// Makes `device` current for one launch; returns the previous device in
// `*prev` (or an error).
cudaError_t enter(int device, int* prev) {
  cudaError_t err = cudaGetDevice(prev);
  if (err == cudaSuccess && *prev != device) err = cudaSetDevice(device);
  return err;
}

unsigned blocks(int R, int H) {
  return (unsigned)(((long long)R * H + kThreads - 1) / kThreads);
}

template <typename T>
int fwd(const void* z, const void* c, void* h, void* cn, void* gates, int R,
        int H, int device, void* stream) {
  if (R < 1 || H < 1 || (long long)R * H > (long long)kThreads * 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  int prev = 0;
  cudaError_t err = enter(device, &prev);
  if (err != cudaSuccess) return (int)err;
  lstm_cell_fwd_kernel<T><<<blocks(R, H), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(z), static_cast<const T*>(c), static_cast<T*>(h),
      static_cast<T*>(cn), static_cast<T*>(gates), R, H);
  const int ret = (int)cudaGetLastError();
  if (prev != device) cudaSetDevice(prev);
  return ret;
}

template <typename T>
int bwd(const void* dh, const void* dcn, const void* gates, const void* c,
        const void* cn, void* dz, void* dc, int R, int H, int device,
        void* stream) {
  if (R < 1 || H < 1 || (long long)R * H > (long long)kThreads * 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  int prev = 0;
  cudaError_t err = enter(device, &prev);
  if (err != cudaSuccess) return (int)err;
  lstm_cell_bwd_kernel<T><<<blocks(R, H), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(dh), static_cast<const T*>(dcn),
      static_cast<const T*>(gates), static_cast<const T*>(c),
      static_cast<const T*>(cn), static_cast<T*>(dz), static_cast<T*>(dc), R,
      H);
  const int ret = (int)cudaGetLastError();
  if (prev != device) cudaSetDevice(prev);
  return ret;
}

}  // namespace

// Plain C entry points bound with ctypes (kernels/lstm_cell.py). Every
// pointer is a contiguous tensor on device `device` of the entry's type;
// `stream` is a stream of that device. Each returns the cudaError_t of its
// launch (0 = ok).
extern "C" int lstm_cell_fwd_f32(const void* z, const void* c, void* h,
                                 void* cn, void* gates, int R, int H,
                                 int device, void* stream) {
  return fwd<float>(z, c, h, cn, gates, R, H, device, stream);
}

extern "C" int lstm_cell_fwd_f64(const void* z, const void* c, void* h,
                                 void* cn, void* gates, int R, int H,
                                 int device, void* stream) {
  return fwd<double>(z, c, h, cn, gates, R, H, device, stream);
}

extern "C" int lstm_cell_bwd_f32(const void* dh, const void* dcn,
                                 const void* gates, const void* c,
                                 const void* cn, void* dz, void* dc, int R,
                                 int H, int device, void* stream) {
  return bwd<float>(dh, dcn, gates, c, cn, dz, dc, R, H, device, stream);
}

extern "C" int lstm_cell_bwd_f64(const void* dh, const void* dcn,
                                 const void* gates, const void* c,
                                 const void* cn, void* dz, void* dc, int R,
                                 int H, int device, void* stream) {
  return bwd<double>(dh, dcn, gates, c, cn, dz, dc, R, H, device, stream);
}
