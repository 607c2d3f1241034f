// Causal flash attention, forward and backward, CUDA C++ for sm_90a.
//
// Replaces the stock Pallas TPU flash attention that
// movae_tpu/ops/attention.py:causal_attention calls for L > 1024
// (jax/experimental/pallas/ops/tpu/flash_attention.py, jax 0.9.0):
//   flash_fwd_kernel     <- _flash_attention_impl (:589, pallas_call :758),
//                           the forward of flash_attention (:140);
//   flash_bwd_dkv_kernel <- _flash_attention_bwd_dkv (:941, pallas_call :1121);
//   flash_bwd_dq_kernel  <- _flash_attention_bwd_dq (:1287, pallas_call :1456).
// Same functions: o = softmax(q k^T * s with an inclusive causal mask) v over
// (B, H, L, D) float32, and its gradients dq, dk, dv given do, the forward's
// per-row log-sum-exp and di = sum_d o * do (computed by the caller, as the
// JAX package leaves di to XLA, flash_attention.py:273). No L x L matrix
// reaches device memory.
//
// Bound on an H100 SXM (700 W) at the PixelSNAIL prior shape B=16, H=8,
// L=4096, D=16: the causal half is B*H*D*L(L+1)/2 = 17.2 G multiply-adds per
// (q k^T or p v)-sized product. Forward 4 flops per pair-element (q.k and
// p.v), dK/dV 8 (q.k, do.v, p.do, ds.q), dQ 6 (q.k, do.v, ds.k): 68.7, 137
// and 103 GFLOP, i.e. 1.03, 2.05 and 1.54 ms at 67 TFLOP/s of fp32 on the
// CUDA cores, against 0.04-0.1 ms for the bytes (each of q, k, v, o, do, dq,
// dk, dv is 32 MB). The kernels are bound by operations, and at D=16 each
// dot product is a short 16-FMA chain, so latency, not instruction
// throughput, is what they have to hide.
//
// Design (simple and exact first; wgmma / TMA, TF32 or 3xTF32 tensor-core
// products and split-D layouts are later work):
//   * a block of 64 threads owns 64 rows of the outer dimension (query rows
//     for the forward and dQ, key rows for dK/dV), one row per thread; the
//     thread keeps its row of q (or k and v), its accumulators and its
//     softmax statistics in registers (D is a template parameter);
//   * the other operand streams through shared memory in tiles of 64 rows
//     (32 at D=128, to stay under the 48 KB static limit); every thread of a
//     warp reads the same staged row, so shared loads are broadcasts;
//   * inner steps take 16 staged rows at a time: 16 independent dot
//     products give the FMA pipes 16-way instruction-level parallelism, and
//     the forward's online softmax rescales once per 16 keys;
//   * causality: tiles wholly past the diagonal are never loaded; inside a
//     tile, 16-row steps that lie wholly past every row of a warp are
//     skipped (a warp-uniform branch); the diagonal is masked element by
//     element with the inclusive rule (query i sees keys 0..i);
//   * ragged L is masked, not padded: staged rows >= L are zero-filled and
//     masked, and threads whose row is >= L compute but never write;
//   * causal imbalance: the last query tile does up to L/64 times the work
//     of the first, so the grid puts the longest blocks first (query tiles
//     in descending order, key tiles in ascending order) and the short ones
//     fill the tail;
//   * the backward is split as the TPU kernel splits it: dK/dV by key tile,
//     dQ by query tile, each block owning its outputs, so there are no
//     atomics and the result is deterministic;
//   * logits are kept in base 2: q is pre-scaled by s * log2(e) and
//     exponentials are exp2f, which is accurate to 2 ulp (the CUDA math
//     API's bound) without -use_fast_math, for the price of one MUFU op plus
//     range handling. __expf is ex2.approx on a pre-multiplied argument,
//     whose error grows with |x|; it is not used. The log-sum-exp handed
//     from the forward to the backward is in base 2 as well, and both
//     backward kernels recompute every logit bit for bit as the forward
//     computed it (same scaled q, same fmaf order), so p = exp2(s - lse)
//     adds no rounding of its own however large the logits grow.
//   * everything is float32 with fmaf accumulation: no TF32 anywhere.
//   * registers: at D=16 a thread holds 16 q values and 16 accumulators
//     (forward), 4 x 16 (dK/dV) or 3 x 16 (dQ) — 80, 165 and 105 registers,
//     no spills. Larger D hits the 255-register limit: dK/dV spills a
//     little at D=32 and heavily at 64, dQ spills at 64, and at D=128 every
//     kernel spills. Those sizes are right but slow.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#ifndef MOVAE_FLASH_D
#error "build with -DMOVAE_FLASH_D=<head dim>: one library per head dim"
#endif
static_assert(MOVAE_FLASH_D == 8 || MOVAE_FLASH_D == 16 ||
                  MOVAE_FLASH_D == 32 || MOVAE_FLASH_D == 64 ||
                  MOVAE_FLASH_D == 128,
              "MOVAE_FLASH_D must be one of 8, 16, 32, 64, 128");

namespace {

constexpr int kRows = 64;   // rows a block owns: one per thread
constexpr int kStep = 16;   // staged rows per inner step

template <int D>
struct Tile {
  // staged rows per shared-memory tile: two tiles of kStaged x D floats
  static constexpr int kStaged = D <= 64 ? 64 : 32;
};

template <int D>
__device__ __forceinline__ void load_row(const float* __restrict__ src,
                                         float (&dst)[D], bool valid) {
  const float4* p = reinterpret_cast<const float4*>(src);
#pragma unroll
  for (int i = 0; i < D / 4; ++i) {
    const float4 v = valid ? __ldg(p + i) : make_float4(0.f, 0.f, 0.f, 0.f);
    dst[4 * i + 0] = v.x;
    dst[4 * i + 1] = v.y;
    dst[4 * i + 2] = v.z;
    dst[4 * i + 3] = v.w;
  }
}

template <int D>
__device__ __forceinline__ void store_row(float* __restrict__ dst,
                                          const float (&src)[D], float mul) {
  float4* p = reinterpret_cast<float4*>(dst);
#pragma unroll
  for (int i = 0; i < D / 4; ++i)
    p[i] = make_float4(src[4 * i] * mul, src[4 * i + 1] * mul,
                       src[4 * i + 2] * mul, src[4 * i + 3] * mul);
}

// rows [r0, r0 + S) of an (L, D) matrix into shared memory, zeros past L;
// kScaled multiplies every value by mul on the way
template <int D, int S, bool kScaled = false>
__device__ __forceinline__ void stage(const float* __restrict__ src,
                                      float* __restrict__ dst, int r0, int L,
                                      float mul = 1.f) {
  constexpr int kVecs = S * D / 4;
  const float4* s = reinterpret_cast<const float4*>(
      src + static_cast<int64_t>(r0) * D);
  float4* d = reinterpret_cast<float4*>(dst);
  for (int i = threadIdx.x; i < kVecs; i += kRows) {
    const bool in = r0 + i / (D / 4) < L;
    float4 x = in ? __ldg(s + i) : make_float4(0.f, 0.f, 0.f, 0.f);
    if (kScaled) x = make_float4(x.x * mul, x.y * mul, x.z * mul, x.w * mul);
    d[i] = x;
  }
}

template <int D>
__device__ __forceinline__ float dot(const float (&a)[D],
                                     const float* __restrict__ b) {
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < D; i += 4) {
    const float4 v = *reinterpret_cast<const float4*>(b + i);
    acc = fmaf(a[i], v.x, acc);
    acc = fmaf(a[i + 1], v.y, acc);
    acc = fmaf(a[i + 2], v.z, acc);
    acc = fmaf(a[i + 3], v.w, acc);
  }
  return acc;
}

// grid (B*H, ceil(L/64)); blockIdx.y = 0 is the LAST query tile
template <int D>
__global__ void __launch_bounds__(kRows)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse2, int L, float scale_log2) {
  constexpr int S = Tile<D>::kStaged;
  __shared__ __align__(16) float ks[S * D];
  __shared__ __align__(16) float vs[S * D];

  const int qt = gridDim.y - 1 - blockIdx.y;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * L * D;
  const int row = qt * kRows + threadIdx.x;
  const bool valid = row < L;
  const int warp_last = qt * kRows + (threadIdx.x | 31);
  const int last = min(qt * kRows + kRows, L) - 1;

  float qr[D], acc[D];
  load_row<D>(q + base + static_cast<int64_t>(row) * D, qr, valid);
#pragma unroll
  for (int i = 0; i < D; ++i) {
    qr[i] *= scale_log2;
    acc[i] = 0.f;
  }
  float m = -INFINITY, l = 0.f;

  for (int t0 = 0; t0 <= last; t0 += S) {
    __syncthreads();
    stage<D, S>(k + base, ks, t0, L);
    stage<D, S>(v + base, vs, t0, L);
    __syncthreads();
#pragma unroll 1
    for (int c0 = 0; c0 < S; c0 += kStep) {
      const int key0 = t0 + c0;
      if (key0 > warp_last) break;  // every key here is ahead of the warp
      float s[kStep];
      float mx = m;
#pragma unroll
      for (int c = 0; c < kStep; ++c) {
        const float d = dot<D>(qr, ks + (c0 + c) * D);
        s[c] = key0 + c > row ? -INFINITY : d;
        mx = fmaxf(mx, s[c]);
      }
      // key 0 is in every row's first step, so mx is finite from there on
      const float corr = exp2f(m - mx);
      m = mx;
      l *= corr;
#pragma unroll
      for (int i = 0; i < D; ++i) acc[i] *= corr;
#pragma unroll
      for (int c = 0; c < kStep; ++c) {
        const float p = exp2f(s[c] - mx);
        l += p;
        const float* vr = vs + (c0 + c) * D;
#pragma unroll
        for (int i = 0; i < D; i += 4) {
          const float4 vv = *reinterpret_cast<const float4*>(vr + i);
          acc[i] = fmaf(p, vv.x, acc[i]);
          acc[i + 1] = fmaf(p, vv.y, acc[i + 1]);
          acc[i + 2] = fmaf(p, vv.z, acc[i + 2]);
          acc[i + 3] = fmaf(p, vv.w, acc[i + 3]);
        }
      }
    }
  }
  if (valid) {
    store_row<D>(o + base + static_cast<int64_t>(row) * D, acc, 1.f / l);
    lse2[static_cast<int64_t>(blockIdx.x) * L + row] = m + log2f(l);
  }
}

// grid (B*H, ceil(L/64)); blockIdx.y = 0 is the FIRST key tile, which sees
// every query tile
template <int D>
__global__ void __launch_bounds__(kRows)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ lse2,
                     const float* __restrict__ di, float* __restrict__ dk,
                     float* __restrict__ dv, int L, float scale_log2,
                     float scale) {
  constexpr int S = Tile<D>::kStaged;
  __shared__ __align__(16) float qs[S * D];
  __shared__ __align__(16) float dos[S * D];
  __shared__ float ls[S];
  __shared__ float dis[S];

  const int kt = blockIdx.y;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * L * D;
  const int64_t lbase = static_cast<int64_t>(blockIdx.x) * L;
  const int col = kt * kRows + threadIdx.x;
  const bool valid = col < L;
  const int warp_first = kt * kRows + (threadIdx.x & ~31);

  // q is staged pre-scaled by scale_log2, exactly as the forward and dQ
  // kernels scale their q rows, so that each logit here is bit-identical to
  // the forward's (same products, same fmaf order) and p = exp2(s - lse2)
  // carries no recompute rounding; at |logits| ~ 1e4 (a deep random-init
  // prior) a rounding of k instead put ~4e-4 relative error on dv
  float kr[D], vr[D], dka[D], dva[D];
  load_row<D>(k + base + static_cast<int64_t>(col) * D, kr, valid);
  load_row<D>(v + base + static_cast<int64_t>(col) * D, vr, valid);
#pragma unroll
  for (int i = 0; i < D; ++i) {
    dka[i] = 0.f;
    dva[i] = 0.f;
  }

  for (int t0 = (kt * kRows / S) * S; t0 < L; t0 += S) {
    __syncthreads();
    stage<D, S, true>(q + base, qs, t0, L, scale_log2);
    stage<D, S>(dout + base, dos, t0, L);
    for (int i = threadIdx.x; i < S; i += kRows) {
      const bool in = t0 + i < L;
      ls[i] = in ? lse2[lbase + t0 + i] : 0.f;
      dis[i] = in ? di[lbase + t0 + i] : 0.f;
    }
    __syncthreads();
#pragma unroll 1
    for (int c0 = 0; c0 < S; c0 += kStep) {
      const int qi0 = t0 + c0;
      if (qi0 >= L) break;
      // every query here comes before every key of the warp
      if (qi0 + kStep - 1 < warp_first) continue;
#pragma unroll
      for (int c = 0; c < kStep; ++c) {
        const int qi = qi0 + c;
        const float* qrow = qs + (c0 + c) * D;
        const float* dorow = dos + (c0 + c) * D;
        const float sv = dot<D>(kr, qrow);
        const float dp = dot<D>(vr, dorow);
        const float p =
            (qi < col || qi >= L) ? 0.f : exp2f(sv - ls[c0 + c]);
        const float ds = p * (dp - dis[c0 + c]);
#pragma unroll
        for (int i = 0; i < D; i += 4) {
          const float4 dd = *reinterpret_cast<const float4*>(dorow + i);
          const float4 qq = *reinterpret_cast<const float4*>(qrow + i);
          dva[i] = fmaf(p, dd.x, dva[i]);
          dva[i + 1] = fmaf(p, dd.y, dva[i + 1]);
          dva[i + 2] = fmaf(p, dd.z, dva[i + 2]);
          dva[i + 3] = fmaf(p, dd.w, dva[i + 3]);
          dka[i] = fmaf(ds, qq.x, dka[i]);
          dka[i + 1] = fmaf(ds, qq.y, dka[i + 1]);
          dka[i + 2] = fmaf(ds, qq.z, dka[i + 2]);
          dka[i + 3] = fmaf(ds, qq.w, dka[i + 3]);
        }
      }
    }
  }
  if (valid) {
    // dka sums ds * q * scale_log2; dk wants ds * q * scale
    store_row<D>(dk + base + static_cast<int64_t>(col) * D, dka,
                 scale / scale_log2);
    store_row<D>(dv + base + static_cast<int64_t>(col) * D, dva, 1.f);
  }
}

// grid (B*H, ceil(L/64)); blockIdx.y = 0 is the LAST query tile
template <int D>
__global__ void __launch_bounds__(kRows)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse2,
                    const float* __restrict__ di, float* __restrict__ dq,
                    int L, float scale_log2, float scale) {
  constexpr int S = Tile<D>::kStaged;
  __shared__ __align__(16) float ks[S * D];
  __shared__ __align__(16) float vs[S * D];

  const int qt = gridDim.y - 1 - blockIdx.y;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * L * D;
  const int64_t lbase = static_cast<int64_t>(blockIdx.x) * L;
  const int row = qt * kRows + threadIdx.x;
  const bool valid = row < L;
  const int warp_last = qt * kRows + (threadIdx.x | 31);
  const int last = min(qt * kRows + kRows, L) - 1;

  float qr[D], dor[D], dqa[D];
  load_row<D>(q + base + static_cast<int64_t>(row) * D, qr, valid);
  load_row<D>(dout + base + static_cast<int64_t>(row) * D, dor, valid);
#pragma unroll
  for (int i = 0; i < D; ++i) {
    qr[i] *= scale_log2;
    dqa[i] = 0.f;
  }
  const float lr = valid ? lse2[lbase + row] : 0.f;
  const float dir = valid ? di[lbase + row] : 0.f;

  for (int t0 = 0; t0 <= last; t0 += S) {
    __syncthreads();
    stage<D, S>(k + base, ks, t0, L);
    stage<D, S>(v + base, vs, t0, L);
    __syncthreads();
#pragma unroll 1
    for (int c0 = 0; c0 < S; c0 += kStep) {
      const int key0 = t0 + c0;
      if (key0 > warp_last) break;
#pragma unroll
      for (int c = 0; c < kStep; ++c) {
        const float* krow = ks + (c0 + c) * D;
        const float sv = dot<D>(qr, krow);
        const float dp = dot<D>(dor, vs + (c0 + c) * D);
        const float p = key0 + c > row ? 0.f : exp2f(sv - lr);
        const float ds = p * (dp - dir);
#pragma unroll
        for (int i = 0; i < D; i += 4) {
          const float4 kk = *reinterpret_cast<const float4*>(krow + i);
          dqa[i] = fmaf(ds, kk.x, dqa[i]);
          dqa[i + 1] = fmaf(ds, kk.y, dqa[i + 1]);
          dqa[i + 2] = fmaf(ds, kk.z, dqa[i + 2]);
          dqa[i + 3] = fmaf(ds, kk.w, dqa[i + 3]);
        }
      }
    }
  }
  if (valid) store_row<D>(dq + base + static_cast<int64_t>(row) * D, dqa, scale);
}

constexpr float kLog2e = 1.4426950408889634f;

inline dim3 grid_for(int bh, int L) {
  return dim3(static_cast<unsigned>(bh),
              static_cast<unsigned>((L + kRows - 1) / kRows));
}

// one library per head dim, each its own nvcc job (kernels/build.py)
constexpr int kD = MOVAE_FLASH_D;

inline int prologue(int bh, int L, int d, int device) {
  // gridDim.y is at most 65535 tiles of 64 rows
  if (d != kD || bh <= 0 || L <= 0 || (L + kRows - 1) / kRows > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaSetDevice(device));
}

}  // namespace

// C interface for ctypes. Every tensor is contiguous float32 with 16-byte
// aligned rows on `device`: q, k, v, o, do, dq, dk, dv (bh, L, d); lse2 and
// di (bh, L). lse2 is the forward's log-sum-exp in base 2 of the scaled
// logits (only the backward reads it). Launches go on `stream`; each
// function returns a cudaError_t value (0 on success). d must equal the
// MOVAE_FLASH_D this library was built for (8, 16, 32, 64 or 128).
extern "C" int movae_flash_fwd(const float* q, const float* k, const float* v,
                               float* o, float* lse2, int bh, int L, int d,
                               float scale, int device, void* stream) {
  int err = prologue(bh, L, d, device);
  if (err != 0) return err;
  flash_fwd_kernel<kD><<<grid_for(bh, L), kRows, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      q, k, v, o, lse2, L, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int movae_flash_bwd_dkv(const float* q, const float* k,
                                   const float* v, const float* dout,
                                   const float* lse2, const float* di,
                                   float* dk, float* dv, int bh, int L, int d,
                                   float scale, int device, void* stream) {
  int err = prologue(bh, L, d, device);
  if (err != 0) return err;
  flash_bwd_dkv_kernel<kD><<<grid_for(bh, L), kRows, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      q, k, v, dout, lse2, di, dk, dv, L, scale * kLog2e, scale);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int movae_flash_bwd_dq(const float* q, const float* k,
                                  const float* v, const float* dout,
                                  const float* lse2, const float* di,
                                  float* dq, int bh, int L, int d, float scale,
                                  int device, void* stream) {
  int err = prologue(bh, L, d, device);
  if (err != 0) return err;
  flash_bwd_dq_kernel<kD><<<grid_for(bh, L), kRows, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      q, k, v, dout, lse2, di, dq, L, scale * kLog2e, scale);
  return static_cast<int>(cudaGetLastError());
}
