// Flash-attention forward for Hopper (sm_90a), float32 in and out.
//
// Replaces the TPU kernel feddrift_tpu/parallel/pallas_attention.py:
// _flash_kernel (body, :35-86) launched by _flash_forward through
// pl.pallas_call (:111). Computes the same function: softmax(q k^T / sqrt(D))
// v over [B, H, L, D] with an online softmax, key positions >= L and (when
// causal) kpos > qpos masked to -1e30, output acc / max(l, 1e-30), and key
// tiles wholly above the causal diagonal never read.
//
// Bound on the H100 SXM. At the serving shape (B=32, H=4, L=80, D=32,
// causal) q, k, v and out are 4 x 1.3 MB, ~1.6 us at 3.35 TB/s, and the
// causal work is ~0.05 GFLOP: the call is bound by launch latency and by
// the one block's walk down its few key tiles. At (4, 8, 2048, 64) causal
// the work is 17 GFLOP: 0.26 ms at the 67 TFLOP/s scalar f32 peak, 0.10 ms
// through the tensor cores at 495/3 TFLOP/s (three TF32 products per f32
// product, below), so there it is bound by operations.
//
// Design.
// - Tensor cores at f32 accuracy. Both products, S = Q K^T and O += P V,
//   run as mma.sync m16n8k8 tf32 with f32 accumulators, each operand split
//   into a tf32 big part and a small remainder and every product taken as
//   three TF32 terms (3xTF32, the route of PyTorch's f32 mem-efficient
//   attention; mma_tf32.cuh), which holds |kernel - plain| near 4e-6.
// - Short accumulation chains. Each key tile's P V goes into fresh
//   accumulators and is merged into O with an f32 FMA (O * corr + PV), so
//   the tensor core's own summation spans one tile, whatever L is.
// - FA2 tiling. A block is 1, 2 or 4 warps (from L, chosen by the wrapper);
//   each warp owns 16 query rows and keeps their Q fragments, row max,
//   partial row sums and O fragments in registers. K/V tiles are 64 keys
//   for D <= 64 and 32 for D = 128 (at D = 128 the O fragments and the
//   tile's P V sums are 64 registers each). Q is split anew on each tile:
//   hoisted out of the loop, its two halves take D/2 more registers, which
//   spilled at D = 128 and cut occupancy at D = 64.
// - No re-layout of P. The m16n8 C fragment of S gives lane (g, t) the keys
//   2t and 2t+1 of each 8-key column group, while the A fragment of P V
//   wants keys t and t+4. The order of the keys inside a k-step is free as
//   long as A and B agree, so k-step column t is key 2t and column t+4 is
//   key 2t+1: P goes from the S accumulators straight into the A fragment,
//   and the B fragment reads V rows 2t and 2t+1. The same permutation of
//   head dims in S = Q K^T turns the Q and K reads into float2 loads.
// - A cp.async ring of two K/V stages: 16-byte cp.async.cg copies, the
//   zero-filling form (src-size 0) for keys >= L, and the copy of tile j+1
//   in flight while tile j is used. K rows are padded to a stride = 8 mod
//   16 floats (float2 reads of K[g][2t] from each half-warp hit 32 banks),
//   V rows to D + 4 (reads of V[2t][g] and V[2t+1][g] hit 32 banks).
// - Causal work skipped per warp: a warp leaves out key tiles and 8-key
//   groups wholly above its rows, and masks only on tiles that cross the
//   diagonal or the end of the sequence (a skipped group adds exactly 0).
// - Grid (B*H, q tiles), the q tiles of a causal call longest first, so
//   B*H is limited only by grid.x. Tile sizes depend on (L, D) alone, so a
//   row's answer does not depend on the batch it is launched in.
// - Strided I/O: q, k, v are [B, H, L, D] views with stride 1 in D and
//   16-byte aligned rows, given by their B, H and L strides; the output is
//   written into a [B, L, H, D] buffer, so a caller that split q, k, v off
//   one qkv projection and merges the heads afterwards copies nothing.
//
// Next step if this still loses to the library: wgmma with TMA. Its tf32
// form wants both operands K-major in shared memory, so V would be staged
// transposed and both halves of the split would live in shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "mma_tf32.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kMaxWarps = 4;
constexpr unsigned kFull = 0xffffffffu;

template <int D>
struct Tile {
  static constexpr int kBlockK = D == 128 ? 32 : 64;
  static constexpr int kKStride = D % 16 == 0 ? D + 8 : D;  // = 8 mod 16
  static constexpr int kVStride = D + 4;                    // = 4 mod 8
  static constexpr int kStageFloats = kBlockK * (kKStride + kVStride);
  static constexpr int kSmemBytes = 2 * kStageFloats * 4;
};

struct Args {
  const float* q;
  const float* k;
  const float* v;
  float* o;                       // [B, L, H, D], contiguous
  long long qs[3], ks[3], vs[3];  // B, H and L strides in floats
  int H, L, causal;
  float scale;
};

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(kFull, x, 1));
  return fmaxf(x, __shfl_xor_sync(kFull, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(kFull, x, 1);
  return x + __shfl_xor_sync(kFull, x, 2);
}

template <int D>
__global__ void __launch_bounds__(kMaxWarps * 32)
flash_fwd_kernel(const Args a) {
  using T = Tile<D>;
  constexpr int BK = T::kBlockK;
  constexpr int NT = BK / 8;  // 8-key groups per tile
  constexpr int DT = D / 8;   // 8-dim groups per head
  constexpr int kChunks = D / 4;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int nthreads = blockDim.x;
  const int block_q = nthreads / 2;  // 16 rows per warp
  const int H = a.H, L = a.L;
  const int b = blockIdx.x / H, h = blockIdx.x - b * H;
  const int q_tile = a.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = q_tile * block_q;
  const float* qb = a.q + b * a.qs[0] + h * a.qs[1];
  const float* kb = a.k + b * a.ks[0] + h * a.ks[1];
  const float* vb = a.v + b * a.vs[0] + h * a.vs[1];

  const int k_end = a.causal ? min(q0 + block_q, L) : L;
  const int n_tiles = (k_end + BK - 1) / BK;

  auto load_tile = [&](int j) {
    float* ks = smem + (j & 1) * T::kStageFloats;
    float* vs = ks + BK * T::kKStride;
    for (int i = tid; i < BK * kChunks; i += nthreads) {
      const int r = i / kChunks, c = (i % kChunks) * 4;
      const int kpos = j * BK + r;
      const bool in = kpos < L;
      cp_async16(ks + r * T::kKStride + c, in ? kb + kpos * a.ks[2] + c : kb,
                 in ? 16 : 0);
      cp_async16(vs + r * T::kVStride + c, in ? vb + kpos * a.vs[2] + c : vb,
                 in ? 16 : 0);
    }
    cp_async_commit();
  };
  load_tile(0);

  // This warp's rows r0 + g and r0 + g + 8. Q fragments, scaled: k-step kst
  // column t is head dim 8*kst + 2t and column t+4 is dim 8*kst + 2t + 1.
  const int r0 = q0 + warp * 16;
  const int row_a = r0 + g, row_b = r0 + g + 8;
  float qf[DT][4];
#pragma unroll
  for (int kst = 0; kst < DT; ++kst) {
    const int d = kst * 8 + 2 * t;
    const float2 x = row_a < L
        ? *reinterpret_cast<const float2*>(qb + row_a * a.qs[2] + d)
        : make_float2(0.f, 0.f);
    const float2 y = row_b < L
        ? *reinterpret_cast<const float2*>(qb + row_b * a.qs[2] + d)
        : make_float2(0.f, 0.f);
    qf[kst][0] = x.x * a.scale;
    qf[kst][1] = y.x * a.scale;
    qf[kst][2] = x.y * a.scale;
    qf[kst][3] = y.y * a.scale;
  }

  float o[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
    o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
  float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;
  // keys this warp's rows can see
  const int warp_k_end = a.causal ? min(L, r0 + 16) : L;

  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) {
      load_tile(j + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile j visible to every warp
    const int k0 = j * BK;
    if (r0 < L && k0 < warp_k_end) {
      // opaque to the compiler, so the split of Q stays in the loop
#pragma unroll
      for (int kst = 0; kst < DT; ++kst)
        asm volatile("" : "+f"(qf[kst][0]), "+f"(qf[kst][1]),
                     "+f"(qf[kst][2]), "+f"(qf[kst][3]));
      const float* ks = smem + (j & 1) * T::kStageFloats;
      const float* vs = ks + BK * T::kKStride;
      const int nt_live = min(NT, (warp_k_end - k0 + 7) / 8);

      float s[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] =
          s[nt][3] = 0.f;
#pragma unroll
      for (int kst = 0; kst < DT; ++kst) {
        uint32_t qa_big[4], qa_small[4];
        split4(qf[kst], qa_big, qa_small);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          if (nt < nt_live) {
            const float2 kk = *reinterpret_cast<const float2*>(
                ks + (nt * 8 + g) * T::kKStride + kst * 8 + 2 * t);
            mma_3xtf32(s[nt], qa_big, qa_small, kk.x, kk.y);
          }
        }
      }

      if (k0 + BK > L || (a.causal && k0 + BK - 1 > r0)) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kpos = k0 + nt * 8 + 2 * t + (e & 1);
            const int row = e < 2 ? row_a : row_b;
            if (kpos >= L || (a.causal && kpos > row)) s[nt][e] = kNegInf;
          }
        }
      }

      float mx_a = m_a, mx_b = m_b;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        mx_a = fmaxf(mx_a, fmaxf(s[nt][0], s[nt][1]));
        mx_b = fmaxf(mx_b, fmaxf(s[nt][2], s[nt][3]));
      }
      mx_a = quad_max(mx_a);
      mx_b = quad_max(mx_b);
      const float corr_a = expf(m_a - mx_a), corr_b = expf(m_b - mx_b);
      m_a = mx_a;
      m_b = mx_b;
      // per-lane partial row sums; the quad's four are added at the end
      l_a *= corr_a;
      l_b *= corr_b;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        s[nt][0] = expf(s[nt][0] - mx_a);
        s[nt][1] = expf(s[nt][1] - mx_a);
        s[nt][2] = expf(s[nt][2] - mx_b);
        s[nt][3] = expf(s[nt][3] - mx_b);
        l_a += s[nt][0] + s[nt][1];
        l_b += s[nt][2] + s[nt][3];
      }

      // PV = P V. k-step column t is key 2t, column t+4 key 2t+1, so the
      // A fragment is the S accumulator of the same 8-key group.
      float pv[DT][4];
#pragma unroll
      for (int dt = 0; dt < DT; ++dt)
        pv[dt][0] = pv[dt][1] = pv[dt][2] = pv[dt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < NT; ++kk) {
        if (kk < nt_live) {
          const float p[4] = {s[kk][0], s[kk][2], s[kk][1], s[kk][3]};
          uint32_t p_big[4], p_small[4];
          split4(p, p_big, p_small);
          const float* v0 = vs + (kk * 8 + 2 * t) * T::kVStride + g;
#pragma unroll
          for (int dt = 0; dt < DT; ++dt)
            mma_3xtf32(pv[dt], p_big, p_small, v0[dt * 8],
                       v0[T::kVStride + dt * 8]);
        }
      }
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        o[dt][0] = fmaf(o[dt][0], corr_a, pv[dt][0]);
        o[dt][1] = fmaf(o[dt][1], corr_a, pv[dt][1]);
        o[dt][2] = fmaf(o[dt][2], corr_b, pv[dt][2]);
        o[dt][3] = fmaf(o[dt][3], corr_b, pv[dt][3]);
      }
    }
    __syncthreads();  // stage j & 1 is refilled next iteration
  }

  if (r0 >= L) return;
  const float den_a = fmaxf(quad_sum(l_a), 1e-30f);
  const float den_b = fmaxf(quad_sum(l_b), 1e-30f);
  const long long row_stride = (long long)H * D;
  float* ob = a.o + ((long long)b * L * H + h) * D + 2 * t;
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
    if (row_a < L)
      *reinterpret_cast<float2*>(ob + row_a * row_stride + dt * 8) =
          make_float2(o[dt][0] / den_a, o[dt][1] / den_a);
    if (row_b < L)
      *reinterpret_cast<float2*>(ob + row_b * row_stride + dt * 8) =
          make_float2(o[dt][2] / den_b, o[dt][3] / den_b);
  }
}

template <int D>
int launch(const Args& a, int grid_x, int grid_y, int warps, int block_k,
           cudaStream_t st) {
  using T = Tile<D>;
  if (block_k != T::kBlockK || (warps != 1 && warps != 2 && warps != 4))
    return (int)cudaErrorInvalidValue;
  if (T::kSmemBytes > 48 * 1024) {  // opt in to more, once per device
    static std::atomic<unsigned long long> ready{0};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
    if (!(ready.load() & bit)) {
      err = cudaFuncSetAttribute(flash_fwd_kernel<D>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 T::kSmemBytes);
      if (err != cudaSuccess) return (int)err;
      ready.fetch_or(bit);
    }
  }
  flash_fwd_kernel<D><<<dim3(grid_x, grid_y), warps * 32, T::kSmemBytes,
                        st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// What the wrapper packs for one call (flash_attention.py, _PARAMS): one
// buffer instead of 23 ctypes arguments, whose conversion alone costs more
// host time than the kernel runs at the serving shape.
struct Params {
  unsigned long long q, k, v, o;  // device pointers
  long long qs[3], ks[3], vs[3];  // B, H, L strides in floats
  int H, L, D, causal;
  float scale;
  int grid_x, grid_y, warps, block_k;
  int device;                     // CUDA device index of q, k, v, o
};
static_assert(sizeof(Params) == 144, "Params must match the wrapper's pack");

// Plain C entry point bound with ctypes. q, k, v: float32 [B, H, L, D]
// views on the current device, stride 1 in D, 16-byte aligned rows. o:
// contiguous float32 [B, L, H, D]. The launch geometry (grid_x = B*H,
// grid_y = q tiles, warps per block, keys per tile) comes from the
// wrapper's _launch_config; block_k must be the tile this build uses for D.
// `stream` is a stream of that device; the device is made current for the
// launch only if it is not. Returns the cudaError_t of the launch (0 = ok).
extern "C" int flash_attn_fwd_f32(const Params* p, void* stream) {
  const Args a{reinterpret_cast<const float*>(p->q),
               reinterpret_cast<const float*>(p->k),
               reinterpret_cast<const float*>(p->v),
               reinterpret_cast<float*>(p->o),
               {p->qs[0], p->qs[1], p->qs[2]},
               {p->ks[0], p->ks[1], p->ks[2]},
               {p->vs[0], p->vs[1], p->vs[2]},
               p->H,
               p->L,
               p->causal,
               p->scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int gx = p->grid_x, gy = p->grid_y, w = p->warps, bk = p->block_k;
  int current = 0;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != p->device)
    err = cudaSetDevice(p->device);
  if (err != cudaSuccess) return (int)err;
  int ret;
  switch (p->D) {
    case 8: ret = launch<8>(a, gx, gy, w, bk, st); break;
    case 16: ret = launch<16>(a, gx, gy, w, bk, st); break;
    case 32: ret = launch<32>(a, gx, gy, w, bk, st); break;
    case 64: ret = launch<64>(a, gx, gy, w, bk, st); break;
    case 128: ret = launch<128>(a, gx, gy, w, bk, st); break;
    default: ret = (int)cudaErrorInvalidValue;
  }
  if (current != p->device) cudaSetDevice(current);
  return ret;
}
