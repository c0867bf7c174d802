// One eval cell of the fnn pool (K3's arithmetic), shared by the standalone
// eval kernels (eval_cells.cu) and K1's fused kernel (local_sgd.cu), which
// evaluates its input params in the same launch. Both compute a cell through
// these functions, in one order, so the two give bitwise-equal cells
// wherever their blocks have the same number of threads.
//
// A cell is model m's packed params (flax layout: W0 [F, H], b0 [H], W1
// [H, K], b1 [K]) and feature mask in shared memory, on one client's rows
// x [N, F] and labels y [N] of one time step: per row
// z = relu((x * fm) @ W0 + b0) @ W1 + b1; the row is correct when the FIRST
// maximal class (torch.argmax's and jnp.argmax's pick) equals y; its NLL is
// log(sum_k exp(z_k - max z)) - (z_y - max z), log_softmax's arithmetic.
// Row i goes to thread i % blockDim.x; the block's count and NLL sum fold by
// a warp-shuffle tree, then the warp totals in warp order.
//
// NaN goes where the reference sends it: relu(NaN) and max(NaN, v) are NaN
// (jax.nn.relu, jnp.maximum, torch.relu, torch.maximum), and the argmax
// picks the first NaN (jnp.argmax, torch.argmax). On finite values the
// helpers below give what fmaxf and a strict `>` gave, bit for bit.

#pragma once

#include <cuda_runtime.h>

namespace fnn_eval {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxWarps = 512 / 32;  // the largest block either kernel uses
// Values (the params and the loss) above which a cell's row loop reads the
// params from shared memory for each row: hoisted out of the loop as
// invariant loads, susy's 212 params do not fit in registers and spill to
// local memory (SEA's 62 do, and keep their code).
constexpr int kHoistMax = 64;

// relu that keeps NaN (fmaxf(NaN, 0) would give 0)
__device__ __forceinline__ float relu(float v) {
  return v != v ? v : fmaxf(v, 0.f);
}

// K1's relu, a select (-0 -> +0), that keeps NaN
__device__ __forceinline__ float relu_select(float v) {
  return v > 0.f || v != v ? v : 0.f;
}

// max that returns NaN when either side is NaN (fmaxf returns the other)
__device__ __forceinline__ float max_nan(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}

// One row's count and NLL from its logits, read through zk(k): KC classes
// where the width is a template argument, else K.
template <int KC, typename Z>
__device__ __forceinline__ void score_row(Z zk, int K, int label, int* cnt,
                                          float* nll, bool want_nll) {
  const int nk = KC > 0 ? KC : K;
  float best = zk(0), zy = zk(0);
  int arg = 0;
#pragma unroll
  for (int k = 1; k < nk; ++k) {
    const float v = zk(k);
    // strictly: the first maximum wins; the first NaN beats everything
    if (v > best || (v != v && best == best)) {
      best = v;
      arg = k;
    }
    if (k == label) zy = v;
  }
  *cnt += arg == label;
  if (want_nll) {
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < nk; ++k) s += expf(zk(k) - best);
    *nll += logf(s) - (zy - best);
  }
}

// The block's totals in a fixed order: a shuffle tree within each warp,
// then the warps in order. Thread 0 writes them to correct[out] and, where
// nll_out is given, nll_out[out]. Every thread of the block must call it.
__device__ __forceinline__ void block_total(int cnt, float nll, int* s_cnt,
                                            float* s_nll, int* correct,
                                            float* nll_out, size_t out) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    cnt += __shfl_xor_sync(kFull, cnt, o);
    nll += __shfl_xor_sync(kFull, nll, o);
  }
  if (lane == 0) {
    s_cnt[warp] = cnt;
    s_nll[warp] = nll;
  }
  __syncthreads();
  if (tid == 0) {
    int c = 0;
    float l = 0.f;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) {
      c += s_cnt[w];
      l += s_nll[w];
    }
    correct[out] = c;
    if (nll_out) nll_out[out] = l;
  }
}

// One cell at the fused widths (F, H, K template arguments): sp the params
// [P], sf the mask [F], both in shared memory; x [N, F] and y [N] anywhere.
// Writes correct[out] and nll_out[out] (none where nll_out is null). s_cnt
// and s_nll take the warp totals ([kMaxWarps] each); a block evaluating a
// second cell passes other arrays, so no barrier is needed between the two.
template <int F, int H, int K>
__device__ __forceinline__ void cell(const float* sp, const float* sf,
                                     const float* x, const int* y, int N,
                                     int* s_cnt, float* s_nll, int* correct,
                                     float* nll_out, size_t out) {
  const float* W0 = sp;
  const float* b0 = sp + F * H;
  const float* W1 = b0 + H;
  const float* b1 = W1 + H * K;
  int cnt = 0;
  float nll = 0.f;
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    if constexpr (F * H + H + H * K + K + 1 > kHoistMax)
      asm volatile("" ::: "memory");  // no params hoisted out of the loop
    float xv[F];
#pragma unroll
    for (int f = 0; f < F; ++f)
      xv[f] = __fmul_rn(x[(size_t)i * F + f], sf[f]);
    float z[K];
#pragma unroll
    for (int k = 0; k < K; ++k) z[k] = 0.f;
#pragma unroll
    for (int j = 0; j < H; ++j) {
      float s = 0.f;
#pragma unroll
      for (int f = 0; f < F; ++f) s = fmaf(xv[f], W0[f * H + j], s);
      const float h = relu(__fadd_rn(s, b0[j]));
#pragma unroll
      for (int k = 0; k < K; ++k) z[k] = fmaf(h, W1[j * K + k], z[k]);
    }
#pragma unroll
    for (int k = 0; k < K; ++k) z[k] = __fadd_rn(z[k], b1[k]);
    score_row<K>([&](int k) { return z[k]; }, K, y[i], &cnt, &nll,
                 nll_out != nullptr);
  }
  block_total(cnt, nll, s_cnt, s_nll, correct, nll_out, out);
}

}  // namespace fnn_eval
