// Helpers shared by the port's tensor-core kernels (flash_attn_fwd.cu,
// dense_rows.cu, eval_cells.cu's wide kernel): float32 products on the TF32 tensor cores at float32
// accuracy (3xTF32 mma.sync m16n8k8), and cp.async copies into shared
// memory. kernels/build.py hashes this header into every library's name, so
// an edit here rebuilds every source.
//
// 3xTF32. One TF32 term keeps a 10-bit mantissa (errors ~1e-3). Each
// operand x is split into big = x with its low 13 bits cleared and
// small = x - big (exact in f32), and a*b is accumulated as small*big +
// big*small, then big*big. The tensor core reads the top 19 bits of a tf32
// operand, so small goes in as it is: the split is one LOP3 and one FADD
// (and one IADD when big is rounded to nearest), where cvt.rna.tf32.f32
// lowers to four instructions (with its NaN check) on sm_90; rounding both
// halves with it made the flash kernel markedly slower for a slightly
// smaller error.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// x = big + small, big a tf32 value (x with its low 13 bits cleared) and
// small exact in f32; the tensor core reads the top 19 bits of small. With
// kRound, big is x rounded to the nearest tf32 value instead of toward
// zero, so small takes either sign and the parts the tensor core drops
// (small * small, small's low bits) do not all lean the way of x * y.
template <bool kRound = false>
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = (__float_as_uint(x) + (kRound ? 0x1000u : 0u)) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

template <bool kRound = false>
__device__ __forceinline__ void split4(const float (&x)[4], uint32_t (&big)[4],
                                       uint32_t (&small)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) split<kRound>(x[i], big[i], small[i]);
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a * b in 3xTF32: the two small cross terms first, then big * big.
template <bool kRound = false>
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const uint32_t (&a_big)[4],
                                           const uint32_t (&a_small)[4],
                                           float b0, float b1) {
  uint32_t b0_big, b0_small, b1_big, b1_small;
  split<kRound>(b0, b0_big, b0_small);
  split<kRound>(b1, b1_big, b1_small);
  mma_tf32(d, a_small, b0_big, b1_big);
  mma_tf32(d, a_big, b0_small, b1_small);
  mma_tf32(d, a_big, b0_big, b1_big);
}

// 16 bytes global -> shared, bypassing L1: the first src_bytes (0..16) are
// copied and the rest zero-filled. src and dst are 16-byte aligned.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int src_bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// 4 bytes global -> shared; zero-fills when !in.
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool in) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace
