// Nearest-code index kernel for the VQ layer, CUDA C++ for sm_90a.
//
// Replaces movae_tpu/ops/vq.py:_inds_kernel (launched by
// _nearest_inds_pallas through pl.pallas_call). Same function: for every
// latent row z_n, argmin over k of (||e_k||^2 - 2 z_n . e_k), accumulated in
// float32, the lowest k winning ties. Only the (N,) int32 index vector is
// written; the (N, K) distance matrix never reaches device memory.
//
// Bound on an H100 SXM (700 W): at the VQ-VAE training shape N = 16,384
// rows (batch 256 on an 8x8 latent grid), K = 512 codes, D = 64, the work is
// 2*N*K*D = 1.07 GFLOP of products against ~4.4 MB moved (z 4.2 MB, the
// codebook 128 KB, the indices 64 KB). At the split-TF32 tensor-core rate
// (495 / 3 = 165 TFLOP/s, the fastest float32-accurate route) that is 6.5 us
// of products against ~1.3 us of memory at 3.35 TB/s, so the kernel is bound
// by operations (chip_smoke.py states the bound at every shape it times).
//
// Design:
//   * a block of 4 warps owns 64 latent rows, 16 per warp. Each warp holds
//     its rows' z in registers for the whole codebook, as split-TF32 A
//     operands (FragA, tf32_mma.cuh) over D / 8 k-steps, the reduction
//     index permuted (k = t -> dim 8s + 2t, k = t + 4 -> dim 8s + 2t + 1;
//     g = lane / 4, t = lane % 4) so that a thread's two dims are adjacent;
//   * the codebook streams through dynamic shared memory in chunks of 64
//     codes (32 at D=128), double buffered with cp.async (commit_group /
//     wait_group 1; codes past K zero-filled): chunk c+1 lands while chunk c
//     computes. The whole codebook and its halves (384 KB at K=512, D=64) do
//     not fit at once. Each thread splits the part of a chunk it copied into
//     TF32 big and small halves as it lands, into rows laid out (big, big,
//     small, small) for every pair of adjacent dims: one 16-byte load then
//     gives a thread its whole B fragment (both halves of dims 2t and 2t+1
//     of code g), and the split rows are padded so that the two codes of a
//     quarter warp fall 16 banks apart (no bank conflicts);
//   * ||e||^2 is computed once per chunk, one code per thread, by a float32
//     fmaf chain over i ascending from 0 on the raw chunk (rows padded to D +
//     4 floats, so the 8 rows a quarter warp reads lie on distinct banks).
//     Every code takes the same order, so duplicated codebook rows get
//     bit-identical norms and, through identical tensor-core products,
//     identical distances: the lowest index wins among them;
//   * z e^T runs on the tensor cores as mma.sync m16n8k8 in split TF32
//     (a_small b_big + a_big b_small + a_big b_big, never a single TF32
//     pass), 4 n-tiles (32 codes) at a time, so 4 independent accumulators
//     hide the mma latency;
//   * dist = ||e||^2 - 2 dot is reduced in the registers where the
//     accumulator lands: each thread keeps a running (min, index) for its
//     rows g and g+8 over its codes 2t, 2t+1 of each 8, with a strict '<'
//     while the codes ascend (the lowest index wins within the thread); then
//     the 4 lanes of a row merge by (distance, index) with two shuffles, so
//     the lowest index wins across lanes too. Codes past K get ||e||^2 =
//     +inf and never win; a NaN distance never wins, and the index starts at
//     0, so it stays in range whatever the inputs.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32_mma.cuh"

namespace {

using namespace movae;

constexpr int kRows = 64;  // latent rows a block owns, 16 per warp
constexpr int kGroup = 4;  // n-tiles (8 codes each) in flight at once

// a chunk of codes is a staged tile of the codebook: kStream<D> codes, raw
// rows padded to kStride<D> floats (tf32_mma.cuh). Its split rows hold 2D
// floats, padded so that rows g and g + 1 fall 16 banks apart
template <int D>
constexpr int kSplitStride = 2 * D % 32 == 16 ? 2 * D : 2 * D + 16;
// 3 blocks an SM at D <= 64 (70 KB of shared memory each) cap a thread at
// 170 registers
template <int D>
constexpr int kMinBlocks = D <= 64 ? 3 : 1;

template <int D>
constexpr int smem_bytes() {
  // 2 raw chunks, the split chunk, ||e||^2 of the chunk's codes
  return (2 * kMat<D> + kStream<D> * (kSplitStride<D> + 1)) *
         static_cast<int>(sizeof(float));
}

// once this thread's copies of a raw chunk have landed (copy_tile's
// chunks): their TF32 halves, (big, big, small, small) per pair of dims
template <int D>
__device__ __forceinline__ void split_chunk(const float* __restrict__ raw,
                                            float* __restrict__ sp) {
#pragma unroll
  for (int it = 0; it < kChunkIters<D>; ++it) {
    const unsigned i = chunk(it), c = 4 * (i % (D / 4));
    const unsigned r = i / (D / 4);
    const float4 x =
        *reinterpret_cast<const float4*>(raw + r * kStride<D> + c);
    const float4 b = make_float4(tf32_rna(x.x), tf32_rna(x.y), tf32_rna(x.z),
                                 tf32_rna(x.w));
    float* o = sp + r * kSplitStride<D> + 2 * c;
    *reinterpret_cast<float4*>(o) =
        make_float4(b.x, b.y, tf32_rna(x.x - b.x), tf32_rna(x.y - b.y));
    *reinterpret_cast<float4*>(o + 4) =
        make_float4(b.z, b.w, tf32_rna(x.z - b.z), tf32_rna(x.w - b.w));
  }
}

__device__ __forceinline__ void consider(float& best, int& idx, float dist,
                                         int code) {
  if (dist < best) {
    best = dist;
    idx = code;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, kMinBlocks<D>)
nearest_code_kernel(const float* __restrict__ z, const float* __restrict__ cb,
                    int32_t* __restrict__ out, int n, int k) {
  constexpr int KC = kStream<D>, KS = D / 8, SS = kSplitStride<D>;
  constexpr int RAW = kMat<D>;
  extern __shared__ __align__(16) float smem[];
  float* raw = smem;           // 2 buffers
  float* sp = smem + 2 * RAW;  // the split chunk
  float* esq = sp + KC * SS;   // ||e||^2 of its codes

  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2,
            t = threadIdx.x & 3;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kRows + 16 * warp;
  const int64_t rows[2] = {first + g, first + g + 8};
  const int n_chunks = (k + KC - 1) / KC;

  copy_tile<D>(cb, raw, 0, k);
  cp_async_commit();

  // rows g, g+8 as split A operands, k-step s: dims 8s + 2t, 8s + 2t + 1
  FragA za[KS];
#pragma unroll
  for (int s = 0; s < KS; ++s) {
    float2 x[2];
#pragma unroll
    for (int r = 0; r < 2; ++r)
      x[r] = rows[r] < n ? __ldg(reinterpret_cast<const float2*>(
                               z + rows[r] * D + 8 * s + 2 * t))
                         : make_float2(0.f, 0.f);
    za[s].set(x[0].x, x[1].x, x[0].y, x[1].y);
  }

  float best[2] = {INFINITY, INFINITY};
  int idx[2] = {0, 0};

  for (int ch = 0; ch < n_chunks; ++ch) {
    const float* cur = raw + (ch & 1) * RAW;
    if (ch + 1 < n_chunks) {
      copy_tile<D>(cb, raw + ((ch + 1) & 1) * RAW, (ch + 1) * KC, k);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    split_chunk<D>(cur, sp);
    __syncthreads();  // the whole chunk has landed
    if (threadIdx.x < KC) {
      float s = INFINITY;  // codes past k never win
      if (ch * KC + static_cast<int>(threadIdx.x) < k) {
        const float* e = cur + threadIdx.x * kStride<D>;
        s = 0.f;
#pragma unroll
        for (int i = 0; i < D; i += 4) {
          const float4 v = *reinterpret_cast<const float4*>(e + i);
          s = fmaf(v.x, v.x, s);
          s = fmaf(v.y, v.y, s);
          s = fmaf(v.z, v.z, s);
          s = fmaf(v.w, v.w, s);
        }
      }
      esq[threadIdx.x] = s;
    }
    __syncthreads();
#pragma unroll
    for (int n0 = 0; n0 < KC / 8; n0 += kGroup) {
      // acc[j]: rows g, g+8 by codes 8 (n0 + j) + 2t, + 1 of the chunk
      float acc[kGroup][4];
#pragma unroll
      for (int j = 0; j < kGroup; ++j)
        acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
      for (int s = 0; s < KS; ++s)
#pragma unroll
        for (int j = 0; j < kGroup; ++j) {
          const float4 b = *reinterpret_cast<const float4*>(
              sp + (8 * (n0 + j) + g) * SS + 16 * s + 4 * t);
          FragB ef;
          ef.big[0] = __float_as_uint(b.x);
          ef.big[1] = __float_as_uint(b.y);
          ef.small[0] = __float_as_uint(b.z);
          ef.small[1] = __float_as_uint(b.w);
          mma_3xtf32(acc[j], za[s], ef);
        }
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        const int c = 8 * (n0 + j) + 2 * t;
        const float2 e2 = *reinterpret_cast<const float2*>(esq + c);
        const int code = ch * KC + c;
        consider(best[0], idx[0], e2.x - 2.f * acc[j][0], code);
        consider(best[0], idx[0], e2.y - 2.f * acc[j][1], code + 1);
        consider(best[1], idx[1], e2.x - 2.f * acc[j][2], code);
        consider(best[1], idx[1], e2.y - 2.f * acc[j][3], code + 1);
      }
    }
    __syncthreads();  // before the next split and chunk ch + 2 overwrite
  }

  // the 4 lanes of a row, merged by (distance, index)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int m = 1; m <= 2; m <<= 1) {
      const float od = __shfl_xor_sync(0xffffffffu, best[r], m);
      const int oi = __shfl_xor_sync(0xffffffffu, idx[r], m);
      if (od < best[r] || (od == best[r] && oi < idx[r])) {
        best[r] = od;
        idx[r] = oi;
      }
    }
    if (t == 0 && rows[r] < n) out[rows[r]] = idx[r];
  }
}

template <int D>
int launch(const float* z, const float* cb, int32_t* out, int n, int k,
           cudaStream_t stream) {
  constexpr int smem = smem_bytes<D>();
  if (smem > 48 * 1024) {  // past the default, dynamic shared memory is opt-in
    const cudaError_t err = cudaFuncSetAttribute(
        nearest_code_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const unsigned blocks = static_cast<unsigned>((n + kRows - 1) / kRows);
  nearest_code_kernel<D><<<blocks, kThreads, smem, stream>>>(z, cb, out, n, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface for ctypes. z (n, d) and cb (k, d) are contiguous float32 with
// 16-byte aligned rows, out is (n,) int32, all on `device`; the launch goes
// on `stream`. Returns a cudaError_t value (0 on success); d must be one of
// 8, 16, 32, 64, 128.
extern "C" int movae_nearest_code(const float* z, const float* cb,
                                  int32_t* out, int n, int k, int d,
                                  int device, void* stream) {
  if (n < 0 || k <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 8: return launch<8>(z, cb, out, n, k, s);
    case 16: return launch<16>(z, cb, out, n, k, s);
    case 32: return launch<32>(z, cb, out, n, k, s);
    case 64: return launch<64>(z, cb, out, n, k, s);
    case 128: return launch<128>(z, cb, out, n, k, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
