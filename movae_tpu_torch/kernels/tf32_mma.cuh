// Split-TF32 tensor-core products and cp.async staging of row tiles, shared
// by the port's Hopper kernels (flash_attention.cu, nearest_code.cu), whose
// blocks are 4 warps that stream the rows of a (rows, D) float32 matrix
// through shared memory in tiles.
//
// A float32-accurate product on the tensor cores ("3xTF32"): x = big + small,
// big = x rounded to TF32 to nearest (ties away, the value of
// cvt.rna.tf32.f32, tf32_rna), small = x - big so rounded; a.b ~ a_small
// b_big + a_big b_small + a_big b_big in float32 (the dropped a_small b_small
// is ~2^-22 relative). No product is a single TF32 pass. The tensor cores
// round their sums toward zero, so a caller that sums many steps adds each
// step's products to its running float32 sum with an ordinary add.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace movae {

// x rounded to TF32 (10 explicit mantissa bits), to nearest with ties away
// from zero: the value of cvt.rna.tf32.f32 for every x that is not a NaN,
// in 2 integer instructions where ptxas expands the cvt into 4
__device__ __forceinline__ float tf32_rna(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xffffe000u);
}

// x = big + small, both TF32; x - big is exact in float32
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  const float b = tf32_rna(x);
  big = __float_as_uint(b);
  small = __float_as_uint(tf32_rna(x - b));
}

struct FragA {  // m16 x k8 operand: (g, t), (g+8, t), (g, t+4), (g+8, t+4)
  uint32_t big[4], small[4];
  __device__ __forceinline__ void set(float a0, float a1, float a2,
                                      float a3) {
    split(a0, big[0], small[0]);
    split(a1, big[1], small[1]);
    split(a2, big[2], small[2]);
    split(a3, big[3], small[3]);
  }
};

struct FragB {  // k8 x n8 operand: (t, g), (t+4, g), from a split tile
  uint32_t big[2], small[2];
  // elements at offsets i0 and i1 of the big and small halves
  __device__ __forceinline__ void load(const float* __restrict__ b,
                                       const float* __restrict__ s, int i0,
                                       int i1) {
    big[0] = __float_as_uint(b[i0]);
    big[1] = __float_as_uint(b[i1]);
    small[0] = __float_as_uint(s[i0]);
    small[1] = __float_as_uint(s[i1]);
  }
};

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a b in split TF32: the two small cross terms first, then big x big
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const FragA& a,
                                           const FragB& b) {
  mma_tf32(c, a.small, b.big);
  mma_tf32(c, a.big, b.small);
  mma_tf32(c, a.big, b.big);
}

// 16 bytes from global to shared memory, asynchronously; zeros when !in
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool in) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool in) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

constexpr int kThreads = 128;  // 4 warps a block

// rows per staged tile (32 at D=128, so that 7 staged tiles fit in
// shared memory)
template <int D>
constexpr int kStream = D <= 64 ? 64 : 32;
// staged rows are padded to D + 4 floats: the 16-byte loads of 4 rows 2t
// apart, the 4-byte loads of rows 2t (+1) at 8 columns and of rows g at 4
// columns then all fall on distinct banks
template <int D>
constexpr int kStride = D + 4;
template <int D>
constexpr int kMat = kStream<D> * kStride<D>;  // floats of one staged tile

// the 16-byte chunks of a staged tile that thread threadIdx.x copies and
// splits: i = threadIdx.x + kThreads * it, row i / (D / 4), column 4 (i % (D
// / 4)); the trip count is known at compile time
template <int D>
constexpr int kChunkIters = kStream<D> * D / 4 / kThreads;

__device__ __forceinline__ unsigned chunk(int it) {
  return threadIdx.x + static_cast<unsigned>(kThreads * it);
}

// rows [r0, r0 + kStream) of an (L, D) matrix into a padded staged tile,
// zeros past L (a copy of 0 bytes from row 0)
template <int D>
__device__ __forceinline__ void copy_tile(const float* __restrict__ src,
                                          float* __restrict__ dst, int r0,
                                          int L) {
  static_assert(kStream<D> * D / 4 % kThreads == 0, "whole chunks a thread");
#pragma unroll
  for (int it = 0; it < kChunkIters<D>; ++it) {
    const unsigned i = chunk(it), c = 4 * (i % (D / 4));
    const int r = static_cast<int>(i / (D / 4));
    const bool in = r0 + r < L;
    cp_async16(dst + r * kStride<D> + c,
               src + static_cast<int64_t>(in ? r0 + r : 0) * D + c, in);
  }
}

}  // namespace movae
