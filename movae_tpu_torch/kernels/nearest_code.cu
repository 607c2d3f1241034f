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
// 2*N*K*D = 1.07 GFLOP of float32 FMAs against ~4.4 MB moved (z 4.2 MB, the
// codebook 128 KB, the indices 64 KB). On the CUDA cores (67 TFLOP/s fp32)
// that is ~16 us of arithmetic against ~1.3 us of memory at 3.35 TB/s, so
// the kernel is bound by operations.
//
// Design (simple and exact first; tensor cores / wgmma / TMA are later work):
//   * a block owns kRows latent rows; kSplit threads share each row, thread
//     group g scanning codes g, g + kSplit, ... so a row's K codes are split
//     four ways and the grid has enough warps to cover the card;
//   * each thread keeps its z row in registers (D is a template parameter);
//   * the codebook streams through shared memory in 32 KB chunks (the whole
//     codebook, 128 KB at the slice shape, is above the 48 KB static limit);
//     all threads of a warp read the same code, so every shared load is a
//     broadcast; ||e_k||^2 is folded in, computed once per chunk;
//   * a running min/argmin with strict '<' while k ascends keeps the lowest
//     index within a thread; the kSplit partial results are merged by
//     (distance, index) so the lowest index wins ties across threads too.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;
constexpr int kSplit = 4;
constexpr int kThreads = kRows * kSplit;
constexpr int kChunkFloats = 8192;  // 32 KB of codebook per chunk

template <int D>
__global__ void __launch_bounds__(kThreads)
nearest_code_kernel(const float* __restrict__ z, const float* __restrict__ cb,
                    int32_t* __restrict__ out, int n, int k) {
  constexpr int KC = kChunkFloats / D;  // codes per chunk
  __shared__ __align__(16) float cs[kChunkFloats];
  __shared__ float cs_sq[KC];
  __shared__ float red_dist[kSplit][kRows];
  __shared__ int red_idx[kSplit][kRows];

  const int tid = threadIdx.x;
  const int r = tid % kRows;  // row within the block; a warp shares g
  const int g = tid / kRows;  // code group of this thread
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kRows + r;
  const bool valid = row < n;

  float zr[D];
  if (valid) {
    const float4* zp = reinterpret_cast<const float4*>(z + row * D);
#pragma unroll
    for (int i = 0; i < D / 4; ++i) {
      const float4 v = __ldg(zp + i);
      zr[4 * i + 0] = v.x;
      zr[4 * i + 1] = v.y;
      zr[4 * i + 2] = v.z;
      zr[4 * i + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < D; ++i) zr[i] = 0.f;
  }

  float best = INFINITY;
  int best_idx = g;  // stays in range even if every distance is NaN

  for (int c0 = 0; c0 < k; c0 += KC) {
    const int kc = min(KC, k - c0);
    const float4* src = reinterpret_cast<const float4*>(cb + static_cast<int64_t>(c0) * D);
    float4* dst = reinterpret_cast<float4*>(cs);
    for (int i = tid; i < kc * (D / 4); i += kThreads) dst[i] = __ldg(src + i);
    __syncthreads();
    // ||e_j||^2 for the chunk; the rotated start keeps neighbouring threads
    // on different shared-memory banks
    for (int j = tid; j < kc; j += kThreads) {
      float s = 0.f;
      for (int t = 0; t < D; ++t) {
        const float e = cs[j * D + (t + j) % D];
        s = fmaf(e, e, s);
      }
      cs_sq[j] = s;
    }
    __syncthreads();
    for (int j = g; j < kc; j += kSplit) {
      const float4* e = reinterpret_cast<const float4*>(cs + j * D);
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < D / 4; ++i) {
        const float4 v = e[i];
        dot = fmaf(zr[4 * i + 0], v.x, dot);
        dot = fmaf(zr[4 * i + 1], v.y, dot);
        dot = fmaf(zr[4 * i + 2], v.z, dot);
        dot = fmaf(zr[4 * i + 3], v.w, dot);
      }
      const float dist = cs_sq[j] - 2.0f * dot;
      if (dist < best) {
        best = dist;
        best_idx = c0 + j;
      }
    }
    __syncthreads();
  }

  red_dist[g][r] = best;
  red_idx[g][r] = best_idx;
  __syncthreads();
  if (g == 0 && valid) {
#pragma unroll
    for (int s = 1; s < kSplit; ++s) {
      const float d2 = red_dist[s][r];
      const int i2 = red_idx[s][r];
      if (d2 < best || (d2 == best && i2 < best_idx)) {
        best = d2;
        best_idx = i2;
      }
    }
    out[row] = best_idx;
  }
}

template <int D>
void launch(const float* z, const float* cb, int32_t* out, int n, int k,
            cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((n + kRows - 1) / kRows);
  nearest_code_kernel<D><<<blocks, kThreads, 0, stream>>>(z, cb, out, n, k);
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
    case 8: launch<8>(z, cb, out, n, k, s); break;
    case 16: launch<16>(z, cb, out, n, k, s); break;
    case 32: launch<32>(z, cb, out, n, k, s); break;
    case 64: launch<64>(z, cb, out, n, k, s); break;
    case 128: launch<128>(z, cb, out, n, k, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
