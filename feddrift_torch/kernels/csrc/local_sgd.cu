// Fused local SGD of one communication round (K1), float32.
//
// Replaces feddrift_tpu/core/step.py::TrainStep._local_sgd (:225-293) under
// _round_body's double vmap over (model, client) pairs, together with the
// optimizer it steps, make_optimizer("adam") (:94-99) =
// optax.chain(add_decayed_weights(wd), amsgrad(lr)). The reference has no
// Pallas kernel here: XLA fuses the vmapped scan. Eager PyTorch would issue
// dozens of small ops per local step, so the whole round is one launch.
//
// What it computes. For each pair (m, c), S local steps starting from
// params[m] and the pair's optimizer state (mu, nu, nu_max, count). Step s
// reads the batch rows t_idx*N + slot*B + [0, B) of client c's [T1*N] rows
// and runs dense -> relu -> dense, the mean softmax cross-entropy and its
// gradient, g += wd * p, then optax's scale_by_amsgrad exactly: mu and nu
// moments, bias-corrected mu_hat and nu_hat (1 - b^count in float32, as
// optax's bias_correction), nu_max = max(nu_max, nu_hat) -- the max of the
// CORRECTED nu, which is not torch.optim.Adam(amsgrad=True) -- and
// p += (-lr * mu_hat / (sqrt(nu_max) + eps)) * lr_scale. Pairs with
// total_w == 0 run like every other pair, as the reference's static-shape
// program runs them, but their params, optimizer state and count are
// masked back and their n is 0; their mean loss is still reported.
//
// Bound on the H100 SXM at the canonical SEA shape (M=4, C=10, S=5, B=500,
// F=3, H=10, K=2): a round reads ~1.6 MB of batch rows (40 pairs x 5 steps
// x 500 rows x 16 B) and ~80 KB of params and state, ~0.5 us at 3.35 TB/s;
// it does ~30 MFLOP, ~0.45 us at 67 TFLOP/s: bound by bytes, ~0.5 us. This
// first design sits far above that: the S steps of a pair run one after
// another, each with five block-wide barriers, and 40 blocks fill 40 of 132
// SMs.
//
// Design (simple and right first).
// - One block of 256 threads per pair; grid M*C.
// - The pair's params, mu, nu, nu_max and gradient (5 x P floats) live in
//   shared memory for all S steps; the optimizer state is written back once,
//   and only for active pairs.
// - Forward and dlogits: threads over batch rows. The hidden activations
//   [B, H] and logits [B, K] stay in shared memory; dlogits overwrite the
//   logits, and dh overwrites the activations once dW2 is summed.
// - Gradient sums over B: one warp per parameter, lanes over rows, then a
//   shuffle tree (a fixed order, so the kernel is deterministic). x is read
//   from global memory (the SEA dataset is 660 KB and stays in L2).
// - AMSGrad: threads over parameters, with __syncthreads between phases.
// Shared memory is 4 * (5P + B(H + K) + 8) bytes, 45 KB at the SEA shape.
// This file holds the only copy of that size and of the 227 KB a block may
// opt in to: for larger shapes the entry point returns kErrSmem without a
// launch, and the wrapper (local_sgd.py) raises ValueError.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <climits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxSmem = 232448;
constexpr int kErrSmem = -1;  // local_sgd.py's _ERR_SMEM

struct Args {
  const float* x;        // [C, T1, N, F]
  const int* y;          // [C, T1, N]
  const float* params;   // [M, P]
  float* mu;             // [M, C, P], updated in place
  float* nu;             // [M, C, P], updated in place
  float* nu_max;         // [M, C, P], updated in place
  int* count;            // [M, C], updated in place
  const int* t_idx;      // [M, C, S]
  const int* slot;       // [M, C, S]
  const float* total_w;  // [M, C]
  float* out_params;     // [M, C, P]
  float* n_out;          // [M, C]
  float* loss_out;       // [M, C]
  int C, T1, N, F, H, K, B, S;
  float neg_lr, wd, lr_scale, b1, b2, one_minus_b1, one_minus_b2, eps;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__global__ void __launch_bounds__(kThreads) local_sgd_kernel(Args a) {
  extern __shared__ float smem[];
  const int F = a.F, H = a.H, K = a.K, B = a.B, N = a.N;
  const int P = F * H + H + H * K + K;
  const int oB1 = F * H, oW2 = oB1 + H, oB2 = oW2 + H * K;
  float* s_p = smem;                // [P] params
  float* s_mu = s_p + P;
  float* s_nu = s_mu + P;
  float* s_vmax = s_nu + P;
  float* s_g = s_vmax + P;          // [P] gradient
  float* s_h = s_g + P;             // [B, H] activations, then dh
  float* s_z = s_h + B * H;         // [B, K] logits, then dlogits
  float* s_red = s_z + B * K;       // [kWarps] loss partials

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int pair = blockIdx.x;
  const int m = pair / a.C, c = pair % a.C;
  const float* pm = a.params + (size_t)m * P;
  const size_t so = (size_t)pair * P;
  for (int p = tid; p < P; p += kThreads) {
    s_p[p] = pm[p];
    s_mu[p] = a.mu[so + p];
    s_nu[p] = a.nu[so + p];
    s_vmax[p] = a.nu_max[so + p];
  }
  const float* xc = a.x + (size_t)c * a.T1 * N * F;
  const int* yc = a.y + (size_t)c * a.T1 * N;
  const float inv_b = 1.0f / (float)B;
  int count = a.count[pair];
  float loss_sum = 0.f;             // thread 0's sum of the S step losses
  __syncthreads();

  for (int s = 0; s < a.S; ++s) {
    const size_t row0 = (size_t)a.t_idx[pair * a.S + s] * N
                        + (size_t)a.slot[pair * a.S + s] * B;
    const float* xb = xc + row0 * F;
    const int* yb = yc + row0;

    // forward, loss and dlogits: threads over rows
    float part = 0.f;
    for (int i = tid; i < B; i += kThreads) {
      const float* xr = xb + (size_t)i * F;
      for (int j = 0; j < H; ++j) {
        float acc = 0.f;
        for (int f = 0; f < F; ++f) acc = fmaf(xr[f], s_p[f * H + j], acc);
        acc += s_p[oB1 + j];
        s_h[i * H + j] = acc > 0.f ? acc : 0.f;
      }
      float zmax = -INFINITY;
      for (int k = 0; k < K; ++k) {
        float z = 0.f;
        for (int j = 0; j < H; ++j)
          z = fmaf(s_h[i * H + j], s_p[oW2 + j * K + k], z);
        z += s_p[oB2 + k];
        s_z[i * K + k] = z;
        zmax = fmaxf(zmax, z);
      }
      float se = 0.f;
      for (int k = 0; k < K; ++k) se += expf(s_z[i * K + k] - zmax);
      const int yi = yb[i];
      part += logf(se) - (s_z[i * K + yi] - zmax);
      for (int k = 0; k < K; ++k) {
        const float prob = expf(s_z[i * K + k] - zmax) / se;
        s_z[i * K + k] = (prob - (k == yi ? 1.f : 0.f)) * inv_b;
      }
    }
    part = warp_sum(part);
    if (lane == 0) s_red[warp] = part;
    __syncthreads();
    if (tid == 0) {
      float tot = 0.f;
      for (int w = 0; w < kWarps; ++w) tot += s_red[w];
      loss_sum += tot * inv_b;
    }

    // dW2 = h^T dz, db2 = sum dz: a warp per parameter
    for (int q = warp; q < H * K + K; q += kWarps) {
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
    for (int i = tid; i < B; i += kThreads) {
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
    for (int q = warp; q < F * H + H; q += kWarps) {
      float acc = 0.f;
      if (q < F * H) {
        const int f = q / H, j = q % H;
        for (int i = lane; i < B; i += 32)
          acc = fmaf(xb[(size_t)i * F + f], s_h[i * H + j], acc);
      } else {
        const int j = q - F * H;
        for (int i = lane; i < B; i += 32) acc += s_h[i * H + j];
      }
      acc = warp_sum(acc);
      if (lane == 0) s_g[q] = acc;
    }
    __syncthreads();

    // add_decayed_weights, then scale_by_amsgrad, lr and lr_scale
    count = count < INT_MAX ? count + 1 : count;
    const float bc1 = 1.f - powf(a.b1, (float)count);
    const float bc2 = 1.f - powf(a.b2, (float)count);
    for (int p = tid; p < P; p += kThreads) {
      const float w = s_p[p];
      const float g = s_g[p] + a.wd * w;
      const float mu = a.one_minus_b1 * g + a.b1 * s_mu[p];
      const float nu = a.one_minus_b2 * (g * g) + a.b2 * s_nu[p];
      const float vmax = fmaxf(s_vmax[p], nu / bc2);
      const float u = (mu / bc1) / (sqrtf(vmax) + a.eps);
      s_p[p] = w + (a.neg_lr * u) * a.lr_scale;
      s_mu[p] = mu;
      s_nu[p] = nu;
      s_vmax[p] = vmax;
    }
    __syncthreads();
  }

  const float tw = a.total_w[pair];
  const bool active = tw > 0.f;
  float* op = a.out_params + so;
  for (int p = tid; p < P; p += kThreads) {
    op[p] = active ? s_p[p] : pm[p];
    if (active) {
      a.mu[so + p] = s_mu[p];
      a.nu[so + p] = s_nu[p];
      a.nu_max[so + p] = s_vmax[p];
    }
  }
  if (tid == 0) {
    if (active) a.count[pair] = count;
    a.n_out[pair] = active ? tw * (float)N : 0.f;
    a.loss_out[pair] = loss_sum / (float)a.S;
  }
}

// Shared memory one block needs for these sizes.
long long smem_bytes(int F, int H, int K, int B) {
  const long long P = (long long)F * H + H + (long long)H * K + K;
  return 4 * (5 * P + (long long)B * (H + K) + kWarps);
}

}  // namespace

// What the wrapper packs for one call (local_sgd.py, _PARAMS).
struct Params {
  unsigned long long x, y, params, mu, nu, nu_max, count, t_idx, slot,
      total_w, out_params, n_out, loss_out;  // device pointers
  int M, C, T1, N, F, H, K, B, S;
  int device;  // CUDA device index of every tensor
  float neg_lr, wd, lr_scale, b1, b2, one_minus_b1, one_minus_b2, eps;
};
static_assert(sizeof(Params) == 176, "Params must match the wrapper's pack");

// Plain C entry point bound with ctypes. Every tensor contiguous on device
// `device`, float32 except y, count, t_idx and slot (int32). `stream` is a
// stream of that device; the device is made current for the launch only if
// it is not. Returns the cudaError_t of the launch (0 = ok), or kErrSmem
// (nothing launched) when the shape needs more shared memory than a block
// may take.
extern "C" int local_sgd_f32(const Params* p, void* stream) {
  if (p->M < 1 || p->C < 1 || p->S < 1 || p->B < 1)
    return (int)cudaErrorInvalidValue;
  const long long smem = smem_bytes(p->F, p->H, p->K, p->B);
  if (smem > kMaxSmem) return kErrSmem;
  const Args a{reinterpret_cast<const float*>(p->x),
               reinterpret_cast<const int*>(p->y),
               reinterpret_cast<const float*>(p->params),
               reinterpret_cast<float*>(p->mu),
               reinterpret_cast<float*>(p->nu),
               reinterpret_cast<float*>(p->nu_max),
               reinterpret_cast<int*>(p->count),
               reinterpret_cast<const int*>(p->t_idx),
               reinterpret_cast<const int*>(p->slot),
               reinterpret_cast<const float*>(p->total_w),
               reinterpret_cast<float*>(p->out_params),
               reinterpret_cast<float*>(p->n_out),
               reinterpret_cast<float*>(p->loss_out),
               p->C, p->T1, p->N, p->F, p->H, p->K, p->B, p->S,
               p->neg_lr, p->wd, p->lr_scale, p->b1, p->b2,
               p->one_minus_b1, p->one_minus_b2, p->eps};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int current = 0;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != p->device)
    err = cudaSetDevice(p->device);
  if (err != cudaSuccess) return (int)err;
  if (smem > 48 * 1024) {  // opt in to more, once per device
    static std::atomic<unsigned long long> ready{0};
    const unsigned long long bit = p->device < 64 ? 1ull << p->device : 0;
    if (!(ready.load() & bit)) {
      err = cudaFuncSetAttribute(local_sgd_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kMaxSmem);
      if (err == cudaSuccess) ready.fetch_or(bit);
    }
  }
  if (err == cudaSuccess) {
    local_sgd_kernel<<<p->M * p->C, kThreads, (size_t)smem, st>>>(a);
    err = cudaGetLastError();
  }
  if (current != p->device) cudaSetDevice(current);
  return (int)err;
}
