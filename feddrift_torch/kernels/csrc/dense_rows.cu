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
// Batch invariance. A row's answer is bitwise the same in any batch: the
// route, the tiles and the order of every sum come from (L, in, out) alone
// (dense_rows.py::_launch_config), never from B. A block computes one
// output tile of one row b from that row's x and W only, with no split-K
// across blocks and no atomics, and mma.sync is deterministic, so every
// row runs the same instruction stream on the same values whatever B is.
// Whether a copy is 16 bytes or 4 (the alignment of the tensors) changes
// no value.
//
// Bound on the H100 SXM: bytes, at every serving shape. The per-row weights
// dominate (a b32 forward moves ~94 MB of x, W and y: 28 us at 3.35 TB/s,
// against ~12 us for its ~2.0 GFLOP through the tensor cores at 495/3
// TFLOP/s). Why 3xTF32 and not one TF32 product: the port holds float32
// accuracy (torch.backends.cuda.matmul.allow_tf32 is False, and the plain
// version is a float32 bmm); one TF32 term is off by ~1e-3 at these widths,
// three stay within 1e-5 (mma_tf32.cuh).
//
// Two routes, picked by shape alone:
// - mma (L > 1: qkv, proj, Dense_0, Dense_1). A block of 4 warps computes
//   a 16 x TO tile of one row (one m16 tile of positions; TO = 64 outputs,
//   or 32 where a row has too few 16 x 64 tiles for a b8 micro-batch to
//   fill the 132 SMs: proj and Dense_1, out = 128). The k8 slices of each
//   staged 32-deep k tile are shared out to the warps, one each, so warp w
//   sums k = 8w .. 8w+7 of every tile over the whole tile width in TO/8
//   m16n8 3xTF32 mma.sync products. Each slice's product is a fresh
//   tensor-core sum added into the warp's running sum with a rounded f32
//   add: the tensor core truncates as it accumulates, and a chain of 48 of
//   those drifted by 1e-5 at in = 512. Operands are split round-to-nearest
//   (split<true>), so what the tensor core drops has no bias either. The
//   four partials meet in shared memory and are added in warp order, then
//   the bias once, then stored as float4. x [16, 32] and W [32, TO] tiles
//   come through a 3-stage cp.async ring (16-byte copies, zero-filled
//   outside the tensors; 4-byte copies where an address or a stride is not
//   16-byte aligned), the copies of tile k+2 in flight while tile k is
//   used. x rows are padded to 36 floats (= 4 mod 32: the A fragment's
//   reads of x[g][t] hit 32 banks), W rows to TO + 8 (= 8 mod 32: the .col
//   B fragment's reads of W[t][g] hit 32 banks). 16-row tiles and not the
//   whole L = 80: five blocks of a row read its W, the four repeats from
//   L2 (the blocks are neighbours in the grid), and in exchange a b8
//   micro-batch fills the card (160 to 320 blocks a layer, where 80-row
//   tiles give 32 for proj and Dense_1). 80-row tiles of 5 or 10 warps,
//   32- and 48-row tiles and rings of 4 and 6 stages were tried on the
//   H100 in an earlier version; none was faster at b8.
// - gemv (L = 1: the lm_head on the last position). One block of 8 warps
//   per (row, 64 outputs). Lane i owns outputs 2i and 2i+1 and streams W's
//   rows along out as float2 (two scalars where W is not 8-byte aligned;
//   the lm_head's out = 90 gives 360-byte rows, which are); warp w sums
//   k = w, w + 8, ... with one fmaf a term; the eight partials are added in
//   warp order in shared memory, then the bias. Bound by bytes (1.5 MB at
//   b32, ~0.45 us): each warp issues its loads eight at a time, ahead of
//   the sums that need them.
//
// Left for a later design: wgmma with TMA. Its tf32 form wants both
// operands K-major in shared memory, and W is [in, out] (N-major), so W
// would be staged transposed with both halves of the split in shared
// memory; a TMA descriptor per row of a mixed-model batch (or a read of the
// pool by model index instead of the per-row copies ForwardStep makes) is
// the step after.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tf32.cuh"

namespace {

constexpr int kRouteGemv = 0, kRouteMma = 1;   // dense_rows.py, _ROUTES

constexpr int kTL = 16;            // positions of an mma tile: one m16 tile
constexpr int kTK = 32;            // k depth of one staged tile
constexpr int kStages = 3;         // cp.async ring
constexpr int kWarps = 4;          // one k8 slice of every staged tile each
constexpr int kThreads = 32 * kWarps;
constexpr int kXStride = kTK + 4;  // = 4 mod 32
static_assert(kTK == 8 * kWarps, "a warp takes one k8 slice of a tile");

constexpr int kGemvWarps = 8;
constexpr int kGemvChunk = 64;     // outputs of a gemv block: a float2 a lane

struct Args {
  const float* x;       // [B, L, in], strides xs_b, xs_l, 1
  const float* w;       // [B, in, out], strides ws_b, ws_k, 1
  const float* bias;    // [B, out], strides bs_b, 1; or null
  float* y;             // [B, L, out], contiguous
  long long xs_b, xs_l, ws_b, ws_k, bs_b;
  int L, in, out;
};

template <int TO>
struct MmaTile {
  static_assert(TO % 32 == 0, "W and partial rows = 8 mod 32 floats");
  static constexpr int kNT = TO / 8;                  // m16n8 tiles a warp
  static constexpr int kWStride = TO + 8;             // = 8 mod 32
  static constexpr int kXFloats = kTL * kXStride;
  static constexpr int kStageFloats = kXFloats + kTK * kWStride;
  static constexpr int kPartStride = TO + 8;          // = 8 mod 32
  static constexpr int kPartFloats = kWarps * kTL * kPartStride;
  static constexpr int kRingFloats = kStages * kStageFloats;
  static constexpr int kSmemFloats =
      kRingFloats > kPartFloats ? kRingFloats : kPartFloats;
};

// VEC: x and W 16-byte aligned, so the ring is filled with 16-byte copies
template <int TO, bool VEC>
__global__ void __launch_bounds__(kThreads)
dense_rows_mma_kernel(const Args a, int l_tiles, int o_tiles) {
  using T = MmaTile<TO>;
  constexpr int NT = T::kNT;
  __shared__ __align__(16) float smem[T::kSmemFloats];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  // blockIdx.x -> (b, o tile, l tile), l tiles fastest: the blocks that
  // read one row's W slice run side by side and share it through L2
  unsigned bid = blockIdx.x;
  const int lt = bid % l_tiles;
  bid /= l_tiles;
  const int ot = bid % o_tiles;
  const long long b = bid / o_tiles;
  const int l0 = lt * kTL, o0 = ot * TO;
  const float* xb = a.x + b * a.xs_b;
  const float* wb = a.w + b * a.ws_b;
  const int n_k = (a.in + kTK - 1) / kTK;

  // stage k tile kt: x[l0 : l0+16, k0 : k0+32] and W[k0 : k0+32, o0 : o0+TO],
  // 0 outside the tensors (which adds exactly nothing)
  auto load = [&](int kt) {
    float* xs = smem + (kt % kStages) * T::kStageFloats;
    float* ws = xs + T::kXFloats;
    const int k0 = kt * kTK;
    if constexpr (VEC) {
      constexpr int kX = kTL * kTK / 4, kW = kTK * TO / 4;   // 16-byte chunks
      static_assert(kX % kThreads == 0 && kW % kThreads == 0, "whole chunks");
#pragma unroll
      for (int j = 0; j < kX / kThreads; ++j) {
        const int i = tid + j * kThreads;
        const int r = i / (kTK / 4), c = (i % (kTK / 4)) * 4;
        const int l = l0 + r, k = k0 + c;
        const int n = l < a.L ? 4 * max(0, min(a.in - k, 4)) : 0;
        cp_async16(xs + r * kXStride + c,
                   n ? xb + (long long)l * a.xs_l + k : a.x, n);
      }
#pragma unroll
      for (int j = 0; j < kW / kThreads; ++j) {
        const int i = tid + j * kThreads;
        const int r = i / (TO / 4), c = (i % (TO / 4)) * 4;
        const int k = k0 + r, o = o0 + c;
        const int n = k < a.in ? 4 * max(0, min(a.out - o, 4)) : 0;
        cp_async16(ws + r * T::kWStride + c,
                   n ? wb + (long long)k * a.ws_k + o : a.w, n);
      }
    } else {
      for (int i = tid; i < kTL * kTK; i += kThreads) {
        const int r = i / kTK, c = i % kTK;
        const int l = l0 + r, k = k0 + c;
        const bool in = l < a.L && k < a.in;
        cp_async4(xs + r * kXStride + c,
                  in ? xb + (long long)l * a.xs_l + k : a.x, in);
      }
      for (int i = tid; i < kTK * TO; i += kThreads) {
        const int r = i / TO, c = i % TO;
        const int k = k0 + r, o = o0 + c;
        const bool in = k < a.in && o < a.out;
        cp_async4(ws + r * T::kWStride + c,
                  in ? wb + (long long)k * a.ws_k + o : a.w, in);
      }
    }
  };

  float acc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_k) load(s);
    cp_async_commit();
  }
  for (int kt = 0; kt < n_k; ++kt) {
    cp_async_wait<kStages - 2>();   // this thread's copies of tile kt
    __syncthreads();  // everyone's copies of tile kt; tile kt-1 is used up
    if (kt + kStages - 1 < n_k) load(kt + kStages - 1);
    cp_async_commit();

    // this warp's k8 slice of the tile: A fragment x[g (+8)][8w + t (+4)],
    // B fragment W[8w + t (+4)][8 nt + g]
    const float* xs = smem + (kt % kStages) * T::kStageFloats + 8 * warp + t;
    const float* ws = smem + (kt % kStages) * T::kStageFloats + T::kXFloats
        + (8 * warp + t) * T::kWStride + g;
    const float af[4] = {xs[g * kXStride], xs[(g + 8) * kXStride],
                         xs[g * kXStride + 4], xs[(g + 8) * kXStride + 4]};
    uint32_t a_big[4], a_small[4];
    split4<true>(af, a_big, a_small);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      float d[4] = {0.f, 0.f, 0.f, 0.f};
      mma_3xtf32<true>(d, a_big, a_small, ws[8 * nt],
                       ws[4 * T::kWStride + 8 * nt]);
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] += d[e];
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: the partials go where it was

  // each warp's 16 x TO partial into shared memory (C fragment: rows g and
  // g + 8, columns 8 nt + 2t and 8 nt + 2t + 1)
  {
    float* part = smem + warp * kTL * T::kPartStride + g * T::kPartStride
        + 2 * t;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      *reinterpret_cast<float2*>(part + 8 * nt) =
          make_float2(acc[nt][0], acc[nt][1]);
      *reinterpret_cast<float2*>(part + 8 * T::kPartStride + 8 * nt) =
          make_float2(acc[nt][2], acc[nt][3]);
    }
  }
  __syncthreads();

  // y = ((p0 + p1) + p2) + p3, then + bias: four outputs a thread a pass
  const bool vec_y = a.out % 4 == 0;
  float* yb = a.y + (b * a.L + l0) * a.out + o0;
  const float* bb = a.bias != nullptr ? a.bias + b * a.bs_b + o0 : nullptr;
  constexpr int kY = kTL * TO / 4;
  static_assert(kY % kThreads == 0, "whole passes");
#pragma unroll
  for (int j = 0; j < kY / kThreads; ++j) {
    const int i = tid + j * kThreads;
    const int r = i / (TO / 4), c = (i % (TO / 4)) * 4;
    if (l0 + r >= a.L) continue;
    float4 s = *reinterpret_cast<const float4*>(smem + r * T::kPartStride + c);
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      const float4 p = *reinterpret_cast<const float4*>(
          smem + (w * kTL + r) * T::kPartStride + c);
      s.x += p.x;
      s.y += p.y;
      s.z += p.z;
      s.w += p.w;
    }
    float v[4] = {s.x, s.y, s.z, s.w};
    const int n_out = min(4, a.out - (o0 + c));
    if (bb != nullptr) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (e < n_out) v[e] += __ldg(bb + c + e);
    }
    float* dst = yb + (long long)r * a.out + c;
    if (vec_y && n_out == 4) {
      *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (e < n_out) dst[e] = v[e];
    }
  }
}

template <int TO>
void launch_mma(const Args& a, bool vec, unsigned grid, int l_tiles,
                int o_tiles, cudaStream_t st) {
  if (vec)
    dense_rows_mma_kernel<TO, true><<<grid, kThreads, 0, st>>>(a, l_tiles,
                                                               o_tiles);
  else
    dense_rows_mma_kernel<TO, false><<<grid, kThreads, 0, st>>>(a, l_tiles,
                                                                o_tiles);
}

__global__ void __launch_bounds__(kGemvWarps * 32)
dense_rows_gemv_kernel(const Args a, int o_chunks, bool vec) {
  __shared__ __align__(8) float part[kGemvWarps][kGemvChunk];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int chunk = blockIdx.x % o_chunks;
  const long long b = blockIdx.x / o_chunks;
  const int o = chunk * kGemvChunk + 2 * lane;
  const float* xb = a.x + b * a.xs_b;
  const float* wb = a.w + b * a.ws_b + o;

  float acc0 = 0.f, acc1 = 0.f;
  if (vec && o + 1 < a.out) {
#pragma unroll 8
    for (int k = warp; k < a.in; k += kGemvWarps) {
      const float xv = __ldg(xb + k);
      const float2 wv =
          __ldg(reinterpret_cast<const float2*>(wb + k * a.ws_k));
      acc0 = fmaf(xv, wv.x, acc0);
      acc1 = fmaf(xv, wv.y, acc1);
    }
  } else if (o < a.out) {
    const bool two = o + 1 < a.out;
#pragma unroll 8
    for (int k = warp; k < a.in; k += kGemvWarps) {
      const float xv = __ldg(xb + k);
      acc0 = fmaf(xv, __ldg(wb + k * a.ws_k), acc0);
      if (two) acc1 = fmaf(xv, __ldg(wb + k * a.ws_k + 1), acc1);
    }
  }
  *reinterpret_cast<float2*>(&part[warp][2 * lane]) = make_float2(acc0, acc1);
  __syncthreads();

  if (tid < kGemvChunk) {
    const int oc = chunk * kGemvChunk + tid;
    if (oc < a.out) {
      float s = part[0][tid];
#pragma unroll
      for (int w = 1; w < kGemvWarps; ++w) s += part[w][tid];
      if (a.bias != nullptr) s += __ldg(a.bias + b * a.bs_b + oc);
      a.y[b * a.out + oc] = s;
    }
  }
}

bool aligned(const void* p, long long s0, long long s1, int bytes) {
  const long long f = bytes / 4;   // floats
  return reinterpret_cast<uintptr_t>(p) % bytes == 0 && s0 % f == 0 &&
         s1 % f == 0;
}

}  // namespace

// What the wrapper packs for one call (dense_rows.py, _PARAMS).
struct Params {
  unsigned long long x, w, bias, y;          // device pointers (bias 0: none)
  long long xs_b, xs_l, ws_b, ws_k, bs_b;    // strides in floats
  long long B;
  int L, in, out;
  int route, tile_l, tile_out, warps;        // _launch_config's choice
  int device;                                // CUDA device of every tensor
};
static_assert(sizeof(Params) == 112, "Params must match the wrapper's pack");

// Plain C entry point bound with ctypes. x, w, bias: float32 with stride 1
// in their last dimension; y: contiguous float32 [B, L, out]. The route
// and its tile come from the wrapper's _launch_config and must be a build
// of this file: gemv (L = 1, 1 x 64 tiles, 8 warps) or mma (L > 1, 16 x 64
// or 16 x 32 tiles, 4 warps). The grid is one dimension of
// B * ceil(L / tile_l) * ceil(out / tile_out) blocks, which must not pass
// 2^31 - 1. `stream` is a stream of `device`; the device is made current
// for the launch only if it is not. Returns the cudaError_t of the launch.
extern "C" int dense_rows_f32(const Params* p, void* stream) {
  if (p->B < 1 || p->L < 1 || p->in < 0 || p->out < 1)
    return (int)cudaErrorInvalidValue;
  const bool gemv = p->route == kRouteGemv && p->L == 1 && p->tile_l == 1 &&
                    p->tile_out == kGemvChunk && p->warps == kGemvWarps;
  const bool mma = p->route == kRouteMma && p->L > 1 && p->tile_l == kTL &&
                   (p->tile_out == 64 || p->tile_out == 32) &&
                   p->warps == kWarps;
  if (!gemv && !mma) return (int)cudaErrorInvalidValue;
  const Args a{reinterpret_cast<const float*>(p->x),
               reinterpret_cast<const float*>(p->w),
               reinterpret_cast<const float*>(p->bias),
               reinterpret_cast<float*>(p->y),
               p->xs_b, p->xs_l, p->ws_b, p->ws_k, p->bs_b,
               p->L, p->in, p->out};
  const int l_tiles = (p->L + p->tile_l - 1) / p->tile_l;
  const int o_tiles = (p->out + p->tile_out - 1) / p->tile_out;
  const long long blocks = p->B * l_tiles * o_tiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const unsigned grid = static_cast<unsigned>(blocks);

  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int current = 0;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != p->device)
    err = cudaSetDevice(p->device);
  if (err != cudaSuccess) return (int)err;
  if (gemv) {
    const bool vec = aligned(a.w, a.ws_b, a.ws_k, 8);
    dense_rows_gemv_kernel<<<grid, kGemvWarps * 32, 0, st>>>(a, o_tiles, vec);
  } else {
    const bool vec = aligned(a.x, a.xs_b, a.xs_l, 16) &&
                     aligned(a.w, a.ws_b, a.ws_k, 16);
    if (p->tile_out == 64)
      launch_mma<64>(a, vec, grid, l_tiles, o_tiles, st);
    else
      launch_mma<32>(a, vec, grid, l_tiles, o_tiles, st);
  }
  err = cudaGetLastError();
  if (current != p->device) cudaSetDevice(current);
  return (int)err;
}
