// A whole LSTM layer's recurrence in one launch forward and one backward:
// every step's gate product h·W_h fused with its cell, W_h held in shared
// memory across the L steps. float32.
//
// Replaces no Pallas kernel: the JAX package's LSTMs (feddrift_tpu/models/
// rnn.py:25-26, :40, flax's nn.RNN(nn.OptimizedLSTMCell), a lax.scan) leave
// the recurrence to XLA, which runs the scan as one program. In PyTorch a
// loop of L steps costs, a step, one batched product, one add and one cell
// launch forward, and autograd's replay of each backward: a CharLSTM round
// made 9,436 launches and kept the card 30 % busy. These two kernels take
// one launch a layer each way; the products outside the recurrence (x·W_i
// of all steps, dW_h, dW_i, dx) stay plain products in kernels/lstm_layer.py.
//
// What it computes, for each pair k < K and row n < N, from a zero carry,
// with zx [K, N, L, 4H] (x·W_i of every step), W_h [K, H, 4H], b [K, 4H]
// (gate order i, f, g, o along the 4H columns, flax's):
//   forward, t = 0 .. L-1:
//     z = (h_{t-1}·W_h + b) + zx_t            (flax's sum order)
//     i = σ(z_i), f = σ(z_f), g = tanh(z_g), o = σ(z_o)
//     c_t = f·c_{t-1} + i·g,  h_t = o·tanh(c_t)
//   writing h [K, N, L, H] (or only h_{L-1}, [K, N, H]) and, for the
//   backward, c [K, N, L, H] and the activated gates [K, N, L, 4H];
//   backward, t = L-1 .. 0, from dH (every step's [K, N, L, H], or the last
//   step's [K, N, H]), the gates, c and W_h:
//     dh_t = dH_t + dz_{t+1}·W_hᵀ
//     τ = tanh(c_t),  dct = dc + dh_t·o·(1 - τ²)
//     dz_i = dct·g·i(1 - i), dz_f = dct·c_{t-1}·f(1 - f),
//     dz_g = dct·i·(1 - g²), dz_o = dh_t·τ·o(1 - o),  dc = dct·f
//   writing dZ [K, N, L, 4H], the gradient of z (so of zx, and of b and
//   W_h after a sum and one product). The cell's expressions are
//   csrc/lstm_cell.cu's. The plain versions (kernels/lstm_layer.py:
//   lstm_layer_fwd_ref, lstm_layer_bwd_ref) run the same steps as a loop of
//   batched products and the plain cell.
//
// Bound on the H100 SXM: operations. A layer's recurrent products are
// K·N·L·H·4H FMAs each way; at CharLSTM's training shape (K 30, N 32, L 80,
// H 256) 40.3 GFLOP, 0.60 ms at the 67 TFLOP/s of float32 FMA (TF32 is off
// on the model path), against ~0.8 GB of zx, gates, c and h, 0.24 ms at
// 3.35 TB/s.
//
// Design. The 4H columns of a pair's W_h are split over a thread-block
// cluster of Q = H / 32 CTAs (8 at H 256); a cluster runs one (pair, block
// of 32 rows), and clusters are independent: no grid-wide barrier, no
// cooperative launch. CTA q owns units [32q, 32q + 32) and their four gates'
// columns, 4 · 32 = 128 of them, and keeps its slice of W_h resident in
// shared memory for all L steps (H × 128 floats, 128 KiB at H 256, read in
// with 8 float4 loads in flight a thread). 256 threads in two groups of 4
// warps: warp w takes rows [8(w % 4), 8(w % 4) + 8), lane j unit 32q + j.
// (A first design of 128 threads, one group, ran both directions slower:
// with 4 warps an SM the FMA loops could not hide shared memory's latency,
// and the cell, the stores and the exchange ran on half the threads.)
// - Forward step t: each thread sums its unit's four gates for its warp's
//   8 rows over half of h_{t-1}'s H values (group 0 the low half, group 1
//   the high; float32 FMAs in ascending order; h read as float4, broadcast
//   over the warp; W_h's row read by the 32 lanes, conflict-free). Then the
//   groups split the rows: each hands the other its sums of the other's 4
//   rows through shared memory ([2][16][128]) and adds them to its own
//   (low half first, then high), so a thread runs the cell on 4 rows. It
//   stores h_t into every CTA's h buffer of the cluster (distributed shared
//   memory), arrives at the cluster barrier (release), and only then writes
//   h, c and the gates to global memory and loads zx_{t+1}, before the
//   barrier's wait (acquire). The h buffers alternate by step ([2][32][H],
//   64 KiB at H 256), so one barrier a step orders the writes before the
//   next step's reads and the reads before the writes two steps on.
// - Backward step t: each thread runs the cell's backward on its 4 rows'
//   registers (the carry dc stays there), writes dZ, keeps dz_t in the
//   tile in shared memory ([32][128]) and loads step t-1's inputs; then
//   both groups take the partial dh_{t-1} = dz_t[:, own columns] ·
//   W_h[:, own columns]ᵀ over all H units ([32 × H]; a thread 8 rows ×
//   units j + 32m, group 0 the peers m < Q / 2, group 1 the rest, so the
//   part for CTA m is exactly lane j's m-th column: no shuffle) and store
//   it into CTA m's receive slot q. At step t-1 each CTA sums its Q slots
//   in rank order, so two calls are bitwise equal. The backward keeps
//   W_h's slice transposed ([128][H + 1]: the pad keeps the transposing
//   copy's stores 4-way at most and the product's reads conflict-free),
//   and the slots alternate by step as the forward's buffers do:
//   [2][Q][32][32] floats.
// - Rows past N (the last block of a ragged N) compute on zeros and are
//   never stored; their dz is zero.
// - Shared memory: forward H·128 + 2·32·H + 2·16·128 floats (208 KiB at
//   H 256); backward 128·(H + 1) + 32·128 + 2·Q·32·32 floats (208.5 KiB).
//   One CTA an SM either way: the H100 holds 15 clusters of 8 at once
//   (cudaOccupancyMaxActiveClusters), so CharLSTM's 30 pairs of 32 rows run
//   in two waves. On the H100 both directions run at ~2.5-2.8 × their
//   bound (PERF.md): the FMA loops' shared-memory reads and the step's
//   serial part (the cell, the exchange, the barrier) hold them there; the
//   tensor cores (3xTF32) are the next design.
// - H is a template parameter (32, 64, 128 or 256: Q 1, 2, 4, 8, the
//   portable cluster sizes that are powers of two), so every loop unrolls.
//   Other widths (WordLSTM's 670), float64, and rows whose grid would not
//   fit take the per-step route (kernels/lstm_layer.py::layer_refusal).
// - Accurate expf / tanhf, as csrc/lstm_cell.cu. The products' order
//   differs from cuBLAS's; the tolerance is stated against float64 where
//   the kernel is checked.

#include <cuda_runtime.h>
#include <stdint.h>

#include <cooperative_groups.h>

#include <atomic>

namespace cg = cooperative_groups;

namespace {

constexpr int kUnits = 32;                // units a CTA
constexpr int kRows = 32;                 // rows a cluster
constexpr int kThreads = 256;             // two groups of 4 warps
constexpr int kGroup = 128;               // threads a group
constexpr int kRowsPerThread = 8;         // a warp's rows of the block
constexpr int kCellRows = 4;              // of which a thread's cell's
constexpr int kCols = 4 * kUnits;         // a CTA's gate columns

__device__ __forceinline__ float sigmoid_(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// The cluster barrier in two halves: the arrive releases the thread's
// earlier writes (its stores into peers' shared memory) to the cluster, the
// wait acquires the peers'. Work between the two (global stores, the next
// step's loads) overlaps the barrier.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

template <int H>
constexpr long long fwd_smem_bytes() {     // W_h slice, h buffers, partials
  return 4LL * (H * kCols + 2 * kRows * H + 2 * 16 * kGroup);
}

template <int H>
constexpr long long bwd_smem_bytes() {     // W_h slice, dz tile, slots
  return 4LL * (kCols * (H + 1) + kRows * kCols + 2 * (H / kUnits) * kRows *
                                                      kUnits);
}

// CTA q's slice of pair k's W_h: element (kk, cc) is W_h[kk][(cc / 32) * H
// + 32q + cc % 32], read as float4 (4 units of one gate), 8 in flight a
// thread; `put(kk, cc, v)` stores one value.
template <int H, typename Put>
__device__ __forceinline__ void load_slice(const float* whk, int q,
                                           Put put) {
  constexpr int G = 4 * H;
  constexpr int kVecs = H * kCols / 4;
#pragma unroll 8
  for (int e = threadIdx.x; e < kVecs; e += kThreads) {
    const int kk = e / (kCols / 4), cc = 4 * (e - kk * (kCols / 4));
    const float4 v = *reinterpret_cast<const float4*>(
        whk + (long long)kk * G + (cc / kUnits) * H + q * kUnits +
        (cc % kUnits));
    put(kk, cc, v);
  }
}

template <int H>
__global__ void __launch_bounds__(kThreads, 1)
    lstm_layer_fwd_kernel(const float* __restrict__ zx,
                          const float* __restrict__ wh,
                          const float* __restrict__ bias,
                          float* __restrict__ h_out, float* __restrict__ c_out,
                          float* __restrict__ g_out, int N, int L, int h_all) {
  constexpr int Q = H / kUnits;
  constexpr int G = 4 * H;
  constexpr int KH = H / 2;               // a group's half of the sum
  extern __shared__ __align__(16) float smem[];
  float* ws = smem;                       // [H][kCols]
  float* hbuf = ws + H * kCols;           // [2][kRows][H]
  float* part = hbuf + 2 * kRows * H;     // [2 groups][16 sums][kGroup]
  cg::cluster_group cluster = cg::this_cluster();
  const int q = (int)cluster.block_rank();
  const int cid = blockIdx.x / Q;
  const int blocks = (N + kRows - 1) / kRows;
  const int k = cid / blocks;
  const int row0 = (cid - k * blocks) * kRows;
  const int warp = threadIdx.x >> 5, j = threadIdx.x & 31;
  const int grp = warp >> 2;              // k in [grp·H/2, (grp + 1)·H/2)
  const int gt = threadIdx.x & (kGroup - 1);
  const int u = q * kUnits + j;           // the thread's unit
  const int r0 = (warp & 3) * kRowsPerThread;   // its first row
  const int cr = grp * kCellRows;         // its cell's rows: r0 + cr + i

  load_slice<H>(wh + (long long)k * H * G, q,
                [&](int kk, int cc, float4 v) {
                  *reinterpret_cast<float4*>(ws + kk * kCols + cc) = v;
                });
  float bg[4], c[kCellRows];
#pragma unroll
  for (int g = 0; g < 4; ++g) bg[g] = bias[(long long)k * G + g * H + u];
#pragma unroll
  for (int i = 0; i < kCellRows; ++i) c[i] = 0.0f;
  // the cell's rows are (k, row0 + r0 + cr + i): stored below `live`
  const long long base = (long long)k * N + row0 + r0 + cr;
  const int live = N - (row0 + r0 + cr);
  float zv[kCellRows][4];                 // zx_t of the cell's rows
  auto load_zx = [&](int t) {
#pragma unroll
    for (int i = 0; i < kCellRows; ++i) {
      const float* zr = zx + ((base + i) * L + t) * G + u;
#pragma unroll
      for (int g = 0; g < 4; ++g) zv[i][g] = i < live ? zr[g * H] : 0.0f;
    }
  };
  load_zx(0);
  cluster.sync();                         // the slices, every CTA running

  for (int t = 0; t < L; ++t) {
    float hw[kCellRows][4];               // h_{t-1}·W_h of the cell's rows
#pragma unroll
    for (int i = 0; i < kCellRows; ++i)
#pragma unroll
      for (int g = 0; g < 4; ++g) hw[i][g] = 0.0f;
    if (t > 0) {
      float acc[kRowsPerThread][4];
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r)
#pragma unroll
        for (int g = 0; g < 4; ++g) acc[r][g] = 0.0f;
      const float* hb = hbuf + (t & 1) * kRows * H + r0 * H + grp * KH;
      const float* wb = ws + grp * KH * kCols + j;
#pragma unroll 2
      for (int kk = 0; kk < KH; kk += 4) {
        float4 hv[kRowsPerThread];
#pragma unroll
        for (int r = 0; r < kRowsPerThread; ++r)
          hv[r] = *reinterpret_cast<const float4*>(hb + r * H + kk);
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          float wv[4];
#pragma unroll
          for (int g = 0; g < 4; ++g) wv[g] = wb[(kk + s) * kCols + g * kUnits];
#pragma unroll
          for (int r = 0; r < kRowsPerThread; ++r) {
            const float hs = s == 0 ? hv[r].x : s == 1 ? hv[r].y
                             : s == 2 ? hv[r].z : hv[r].w;
#pragma unroll
            for (int g = 0; g < 4; ++g) acc[r][g] = fmaf(hs, wv[g], acc[r][g]);
          }
        }
      }
      // each group hands the other its sums of the other's cell rows
#pragma unroll
      for (int i = 0; i < kCellRows; ++i)
#pragma unroll
        for (int g = 0; g < 4; ++g)
          part[((grp * kCellRows + i) * 4 + g) * kGroup + gt] =
              grp ? acc[i][g] : acc[kCellRows + i][g];
      __syncthreads();
#pragma unroll
      for (int i = 0; i < kCellRows; ++i)
#pragma unroll
        for (int g = 0; g < 4; ++g) {     // the low half's sum, then the high
          const float theirs =
              part[(((1 - grp) * kCellRows + i) * 4 + g) * kGroup + gt];
          hw[i][g] = grp ? theirs + acc[kCellRows + i][g]
                         : acc[i][g] + theirs;
        }
    }
    const bool more = t + 1 < L;
    float act[kCellRows][4], hn[kCellRows];
#pragma unroll
    for (int i = 0; i < kCellRows; ++i) {
      act[i][0] = sigmoid_((hw[i][0] + bg[0]) + zv[i][0]);
      act[i][1] = sigmoid_((hw[i][1] + bg[1]) + zv[i][1]);
      act[i][2] = tanhf((hw[i][2] + bg[2]) + zv[i][2]);
      act[i][3] = sigmoid_((hw[i][3] + bg[3]) + zv[i][3]);
      c[i] = act[i][1] * c[i] + act[i][0] * act[i][2];
      hn[i] = act[i][3] * tanhf(c[i]);
    }
    if (more) {                           // h_t into every CTA's buffer
      float* next = hbuf + ((t + 1) & 1) * kRows * H + (r0 + cr) * H + u;
#pragma unroll
      for (int p = 0; p < Q; ++p) {
        float* dst = cluster.map_shared_rank(next, p);
#pragma unroll
        for (int i = 0; i < kCellRows; ++i) dst[i * H] = hn[i];
      }
      cluster_arrive();
    }
#pragma unroll
    for (int i = 0; i < kCellRows; ++i) {
      if (i >= live) continue;
      const long long at = (base + i) * L + t;
      if (h_all)
        h_out[at * H + u] = hn[i];
      else if (!more)
        h_out[(base + i) * H + u] = hn[i];
      if (c_out) c_out[at * H + u] = c[i];
      if (g_out) {
        float* gr = g_out + at * G + u;
#pragma unroll
        for (int g = 0; g < 4; ++g) gr[g * H] = act[i][g];
      }
    }
    if (!more) break;
    load_zx(t + 1);
    cluster_wait();
  }
}

template <int H>
__global__ void __launch_bounds__(kThreads, 1)
    lstm_layer_bwd_kernel(const float* __restrict__ dH,
                          const float* __restrict__ gates,
                          const float* __restrict__ cs,
                          const float* __restrict__ wh,
                          float* __restrict__ dZ, int N, int L, int dh_all) {
  constexpr int Q = H / kUnits;
  constexpr int G = 4 * H;
  constexpr int WT = H + 1;               // the transposed slice's row pitch
  constexpr int SLOT = kRows * kUnits;    // one sender's partial for a CTA
  constexpr int QG = (Q + 1) / 2;         // peers a group's product serves
  extern __shared__ __align__(16) float smem[];
  float* wt = smem;                       // [kCols][H + 1]: W_h[:, own]ᵀ
  float* dzs = wt + kCols * WT;           // [kRows][kCols]
  float* recv = dzs + kRows * kCols;      // [2][Q][kRows][kUnits]
  cg::cluster_group cluster = cg::this_cluster();
  const int q = (int)cluster.block_rank();
  const int cid = blockIdx.x / Q;
  const int blocks = (N + kRows - 1) / kRows;
  const int k = cid / blocks;
  const int row0 = (cid - k * blocks) * kRows;
  const int warp = threadIdx.x >> 5, j = threadIdx.x & 31;
  const int grp = warp >> 2;              // the product's peers [grp·QG, ..)
  const int u = q * kUnits + j;
  const int r0 = (warp & 3) * kRowsPerThread;
  const int cr = grp * kCellRows;         // its cell's rows: r0 + cr + i

  load_slice<H>(wh + (long long)k * H * G, q,
                [&](int kk, int cc, float4 v) {
                  wt[cc * WT + kk] = v.x;
                  wt[(cc + 1) * WT + kk] = v.y;
                  wt[(cc + 2) * WT + kk] = v.z;
                  wt[(cc + 3) * WT + kk] = v.w;
                });
  const long long base = (long long)k * N + row0 + r0 + cr;
  const int live = N - (row0 + r0 + cr);
  // a step's inputs of the cell's rows: the gates, c_t, c_{t-1}, dH_t
  // (c_t is the previous step's c_{t-1})
  struct Step {
    float g[kCellRows][4], c[kCellRows], cp[kCellRows], dh[kCellRows];
  };
  auto load = [&](int t, Step& s) {
#pragma unroll
    for (int i = 0; i < kCellRows; ++i) {
      const long long at = (base + i) * L + t;
      const bool v = i < live;
#pragma unroll
      for (int g = 0; g < 4; ++g) s.g[i][g] = v ? gates[at * G + g * H + u]
                                                : 0.0f;
      s.cp[i] = v && t > 0 ? cs[(at - 1) * H + u] : 0.0f;
      s.dh[i] = !v ? 0.0f
                : dh_all ? dH[at * H + u]
                : t == L - 1 ? dH[(base + i) * H + u] : 0.0f;
    }
  };
  float dc[kCellRows];
  Step cur;
#pragma unroll
  for (int i = 0; i < kCellRows; ++i) {
    dc[i] = 0.0f;
    cur.c[i] = i < live ? cs[((base + i) * L + L - 1) * H + u] : 0.0f;
  }
  load(L - 1, cur);
  cluster.sync();                         // the slices, every CTA running

  for (int t = L - 1; t >= 0; --t) {
#pragma unroll
    for (int i = 0; i < kCellRows; ++i) {
      float dh = cur.dh[i];
      if (t < L - 1) {                    // dz_{t+1}·W_hᵀ, in rank order
        const float* in = recv + (t & 1) * Q * SLOT +
                          (r0 + cr + i) * kUnits + j;
        float sum = 0.0f;
#pragma unroll
        for (int p = 0; p < Q; ++p) sum += in[p * SLOT];
        dh = dh + sum;
      }
      const float ig = cur.g[i][0], f = cur.g[i][1], g = cur.g[i][2],
                  o = cur.g[i][3];
      const float tc = tanhf(cur.c[i]);
      const float dct = dc[i] + dh * o * (1.0f - tc * tc);
      float dz[4];
      dz[0] = dct * g * ig * (1.0f - ig);
      dz[1] = dct * cur.cp[i] * f * (1.0f - f);
      dz[2] = dct * ig * (1.0f - g * g);
      dz[3] = dh * tc * o * (1.0f - o);
      dc[i] = dct * f;
      float* zs = dzs + (r0 + cr + i) * kCols + j;
      if (i < live) {
        float* out = dZ + ((base + i) * L + t) * G + u;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          out[e * H] = dz[e];
          zs[e * kUnits] = dz[e];
        }
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) zs[e * kUnits] = 0.0f;
      }
    }
    if (t == 0) break;
    Step nxt;
    load(t - 1, nxt);
    __syncthreads();                      // dz_t's tile complete
    // partial dh_{t-1} over the own columns: rows r0.., units j + 32m for
    // the group's peers m
    float acc[kRowsPerThread][QG];
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r)
#pragma unroll
      for (int m = 0; m < QG; ++m) acc[r][m] = 0.0f;
    const int m0 = grp * QG;
    if (m0 < Q) {
      const float* zb = dzs + r0 * kCols;
      const float* wb = wt + m0 * kUnits + j;
#pragma unroll 2
      for (int cc = 0; cc < kCols; cc += 4) {
        float4 zv[kRowsPerThread];
#pragma unroll
        for (int r = 0; r < kRowsPerThread; ++r)
          zv[r] = *reinterpret_cast<const float4*>(zb + r * kCols + cc);
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          float wv[QG];
#pragma unroll
          for (int m = 0; m < QG; ++m) wv[m] = wb[(cc + s) * WT + m * kUnits];
#pragma unroll
          for (int r = 0; r < kRowsPerThread; ++r) {
            const float zsv = s == 0 ? zv[r].x : s == 1 ? zv[r].y
                              : s == 2 ? zv[r].z : zv[r].w;
#pragma unroll
            for (int m = 0; m < QG; ++m)
              acc[r][m] = fmaf(zsv, wv[m], acc[r][m]);
          }
        }
      }
      float* slot = recv + ((t - 1) & 1) * Q * SLOT + q * SLOT +
                    r0 * kUnits + j;
#pragma unroll
      for (int m = 0; m < QG; ++m) {
        if (m0 + m >= Q) break;
        float* dst = cluster.map_shared_rank(slot, m0 + m);
#pragma unroll
        for (int r = 0; r < kRowsPerThread; ++r) dst[r * kUnits] = acc[r][m];
      }
    }
    cluster_arrive();
    cluster_wait();
#pragma unroll
    for (int i = 0; i < kCellRows; ++i) {
#pragma unroll
      for (int g = 0; g < 4; ++g) cur.g[i][g] = nxt.g[i][g];
      cur.c[i] = cur.cp[i];
      cur.cp[i] = nxt.cp[i];
      cur.dh[i] = nxt.dh[i];
    }
  }
}

// Makes `device` current for one launch; returns the previous device in
// `*prev` (or an error).
cudaError_t enter(int device, int* prev) {
  cudaError_t err = cudaGetDevice(prev);
  if (err == cudaSuccess && *prev != device) err = cudaSetDevice(device);
  return err;
}

// A launch of `kernel` over K · ceil(N / 32) clusters of H / 32 CTAs, or
// (clusters != null) how many of its clusters the device holds at once.
template <typename Kernel, typename... Args>
int cluster_launch(Kernel kernel, std::atomic<unsigned long long>& ready,
                   int H, long long smem, int K, int N, int device,
                   void* stream, int* clusters, Args... args) {
  const int Q = H / kUnits;
  const long long blocks = (long long)K * ((N + kRows - 1) / kRows) * Q;
  if (K < 1 || N < 1 || blocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  int prev = 0;
  cudaError_t err = enter(device, &prev);
  if (err != cudaSuccess) return (int)err;
  const unsigned long long bit = device < 64 ? 1ull << device : 0;
  if (!(ready.load() & bit)) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess) ready.fetch_or(bit);
  }
  if (err == cudaSuccess) {
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr;
    cfg.gridDim = dim3((unsigned)blocks);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = (size_t)smem;
    cfg.stream = static_cast<cudaStream_t>(stream);
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = (unsigned)Q;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    if (clusters) {
      err = cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
    } else {
      err = cudaLaunchKernelEx(&cfg, kernel, args...);
      if (err == cudaSuccess) err = cudaGetLastError();
    }
  }
  if (prev != device) cudaSetDevice(prev);
  return (int)err;
}

template <int H>
int fwd(const void* zx, const void* wh, const void* b, void* h, void* c,
        void* g, int K, int N, int L, int h_all, int device, void* stream,
        int* clusters) {
  static std::atomic<unsigned long long> ready{0};
  if (L < 1) return (int)cudaErrorInvalidValue;
  return cluster_launch(lstm_layer_fwd_kernel<H>, ready, H,
                        fwd_smem_bytes<H>(), K, N, device, stream, clusters,
                        static_cast<const float*>(zx),
                        static_cast<const float*>(wh),
                        static_cast<const float*>(b), static_cast<float*>(h),
                        static_cast<float*>(c), static_cast<float*>(g), N, L,
                        h_all);
}

template <int H>
int bwd(const void* dH, const void* gates, const void* c, const void* wh,
        void* dZ, int K, int N, int L, int dh_all, int device, void* stream,
        int* clusters) {
  static std::atomic<unsigned long long> ready{0};
  if (L < 1) return (int)cudaErrorInvalidValue;
  return cluster_launch(lstm_layer_bwd_kernel<H>, ready, H,
                        bwd_smem_bytes<H>(), K, N, device, stream, clusters,
                        static_cast<const float*>(dH),
                        static_cast<const float*>(gates),
                        static_cast<const float*>(c),
                        static_cast<const float*>(wh), static_cast<float*>(dZ),
                        N, L, dh_all);
}

}  // namespace

// Plain C entry points bound with ctypes (kernels/lstm_layer.py). Every
// pointer is a contiguous float32 tensor on device `device` (c and g of
// the forward may be null: not written); `stream` is a stream of that
// device. H is 32, 64, 128 or 256. With `clusters` non-null nothing
// launches: the entry writes cudaOccupancyMaxActiveClusters there. Each
// returns a cudaError_t (0 = ok).
extern "C" int lstm_layer_fwd_f32(const void* zx, const void* wh,
                                  const void* b, void* h, void* c, void* g,
                                  int K, int N, int L, int H, int h_all,
                                  int device, void* stream, int* clusters) {
  switch (H) {
    case 32: return fwd<32>(zx, wh, b, h, c, g, K, N, L, h_all, device,
                            stream, clusters);
    case 64: return fwd<64>(zx, wh, b, h, c, g, K, N, L, h_all, device,
                            stream, clusters);
    case 128: return fwd<128>(zx, wh, b, h, c, g, K, N, L, h_all, device,
                              stream, clusters);
    case 256: return fwd<256>(zx, wh, b, h, c, g, K, N, L, h_all, device,
                              stream, clusters);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int lstm_layer_bwd_f32(const void* dH, const void* gates,
                                  const void* c, const void* wh, void* dZ,
                                  int K, int N, int L, int H, int dh_all,
                                  int device, void* stream, int* clusters) {
  switch (H) {
    case 32: return bwd<32>(dH, gates, c, wh, dZ, K, N, L, dh_all, device,
                            stream, clusters);
    case 64: return bwd<64>(dH, gates, c, wh, dZ, K, N, L, dh_all, device,
                            stream, clusters);
    case 128: return bwd<128>(dH, gates, c, wh, dZ, K, N, L, dh_all, device,
                              stream, clusters);
    case 256: return bwd<256>(dH, gates, c, wh, dZ, K, N, L, dh_all, device,
                              stream, clusters);
    default: return (int)cudaErrorInvalidValue;
  }
}
