// Causal flash attention, forward and backward, CUDA C++ for sm_90a.
//
// Replaces the stock Pallas TPU flash attention that
// movae_tpu/ops/attention.py:causal_attention calls for L > 1024
// (jax/experimental/pallas/ops/tpu/flash_attention.py, jax 0.9.0):
//   flash_fwd_kernel     <- _flash_attention_impl (:589, pallas_call :758),
//                           the forward of flash_attention (:140); its body
//                           is _flash_attention_kernel_single_batch (:342:
//                           logits :396, p.v :471);
//   flash_bwd_dkv_kernel <- _flash_attention_bwd_dkv (:941, pallas_call
//                           :1121); body _flash_attention_dkv_kernel (:796:
//                           logits :845, dv :900, dp :909, dk :918);
//   flash_bwd_dq_kernel  <- _flash_attention_bwd_dq (:1287, pallas_call
//                           :1456); body _flash_attention_dq_kernel (:1146:
//                           logits :1187, p :1227, dp :1237, ds :1243,
//                           dq :1257).
// Same functions: o = softmax(q k^T * s with an inclusive causal mask) v over
// (B, H, L, D) float32 (bfloat16: the instances at the end of this file),
// and its gradients dq, dk, dv given do, the forward's
// per-row log-sum-exp and di = sum_d o * do (computed by the caller, as the
// JAX package leaves di to XLA, flash_attention.py:273). No L x L matrix
// reaches device memory.
//
// Bound on an H100 SXM (700 W) at the PixelSNAIL prior shape B=16, H=8,
// L=4096, D=16, the larger of three times (chip_smoke.py:flash_bounds):
//   * products of the causal half over the split-TF32 tensor-core rate
//     (495 / 3 = 165 TFLOP/s, the fastest float32-accurate route): the
//     forward has 2 products (q k^T, p v), dK/dV 4 (q k^T, do v^T, p^T do,
//     ds^T q), dQ 3 (q k^T, do v^T, ds k), each 2 * B*H*D*L(L+1)/2 = 34.4
//     GFLOP: 0.416, 0.832 and 0.624 ms;
//   * one exp2 per causal pair (1.07 G) over the MUFU rate (132 SMs x 16 a
//     clock x 1.98 GHz = 4.18 T/s): 0.257 ms in each kernel;
//   * the bytes (each of q, k, v, o, do, dq, dk, dv is 32 MB): 0.04-0.1 ms.
// (On the CUDA cores alone, 67 TFLOP/s of fp32, the products would take
// 1.03, 2.05 and 1.54 ms.)
//
// Design, shared by all three kernels:
//   * a block of 4 warps owns 64 rows of the outer dimension (query rows in
//     the forward and dQ, key rows in dK/dV), 16 per warp, and streams the
//     other side in tiles of 64 rows (32 at D=128) through shared memory.
//     The tiles are double buffered with cp.async (commit_group / wait_group
//     1): tile t+1 loads while tile t computes. Rows are padded to D + 4
//     floats, which makes every shared load below free of bank conflicts.
//     Shared memory is dynamic (26, 37 and 35 KB at D=16 for the forward,
//     dK/dV and dQ; 84, 119 and 118 KB at D=128), allowed past the 48 KB
//     default with cudaFuncSetAttribute;
//   * logits stay on the CUDA cores: each thread computes a 2 x 2 block of
//     (row, column) logits per 8 columns, the layout of an m16n8 mma
//     accumulator (rows g and g+8 of its warp's 16, columns 2t and 2t+1 of
//     each 8; g = lane / 4, t = lane % 4), two rows from registers against
//     two staged rows, so every staged value feeds two dot products;
//   * every other product is on the tensor cores as
//     mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 in split TF32
//     (tf32_mma.cuh): no product is a single TF32 pass. mma.sync takes p and
//     ds as its A operand in the registers where they are made; wgmma would
//     also need the B operand transposed in shared memory and every warp of
//     the group on the same steps. The accumulator layout of the logits
//     becomes the A layout by permuting the reduction index (k = t -> column
//     2t, k = t + 4 -> column 2t + 1), and the B fragment is read from the
//     same permuted rows;
//   * the B operands (V in the forward; do and q in dK/dV; V and K in dQ) are
//     split once per tile, as the tile lands, into big and small halves in
//     shared memory, so the 4 warps that read them do not split them again;
//   * the tensor cores round their sums toward zero, so each step's products
//     are summed apart and added to the running float32 sums with an
//     ordinary add: a single long-lived accumulator drifts with L;
//   * forward: per 32 keys, the logits of both rows, the row maxima across
//     the 4 lanes of a row (two shuffles), one rescale of the accumulator,
//     then p = exp2(s - m) and p v (D / 8 n-tiles);
//   * dK/dV: v is held as split A fragments for the whole block; per 16
//     queries, the logits, dp = v do^T on the tensor cores (its accumulator
//     is laid out as the logits), p = exp2(s - lse2), ds = p (dp - di), then
//     dv += p^T do and dk += ds^T q;
//   * dQ: do is held as split A fragments for the whole block; per 32 keys,
//     the logits, dp = do v^T on the tensor cores (B read from the staged V
//     rows; the accumulator is laid out as the logits), p = exp2(s - lse2),
//     ds = p (dp - di), then dq += ds k (ds the A operand through the
//     permutation above, the split K tile the B operand); dq is stored times
//     s. Its staged tiles: K raw in 2 buffers (the logit chain), K big, K
//     small, V in 2 buffers split in place (big), V small;
//   * only the steps that touch the diagonal or the ragged end of L are
//     masked (a warp-uniform choice between two instances of the step);
//   * what bounds them: instruction issue on the CUDA cores, where the
//     logit chains (D fmaf a pair) are under half of a step's instructions
//     and exp2f, the TF32 splits of p and ds, the softmax and the loads the
//     rest; the mma.sync products add their tensor-core time to it (most in
//     dK/dV: at D=16, 36 mmas a warp per 16 queries) rather than hide under
//     it. chip_smoke.py prints the SASS counts.
//
// The recompute contract: every logit in all three kernels is the same
// scalar chain, bit for bit: q scaled once by s * log2(e) (one float
// multiply; dK/dV multiplies each staged q value after its cp.async lands,
// as the forward and dQ do their q rows in registers), then acc = fmaf(q_s[i],
// k[i], acc) for i = 0 .. D-1 ascending from acc = 0, on the CUDA cores
// (dot2). So p = exp2(s - lse2) carries no recompute rounding however large
// the logits grow (at |logits| ~ 1e4, a different rounding put 4e-4 relative
// error on dv). Putting q k^T on the tensor cores would change all three
// kernels at once.
//
// Common to all three:
//   * causality: tiles wholly past the diagonal are never loaded; inside a
//     tile, steps that lie wholly past every row of a warp are skipped (a
//     warp-uniform branch); the diagonal is masked element by element with
//     the inclusive rule (query i sees keys 0..i);
//   * ragged L is masked, not padded: staged rows >= L are zero-filled and
//     masked, and rows >= L are computed but never written;
//   * causal imbalance: the last query tile does up to L/64 times the work
//     of the first, so the grid puts the longest blocks first (query tiles
//     in descending order, key tiles in ascending order);
//   * the backward is split as the TPU kernel splits it: dK/dV by key tile,
//     dQ by query tile, each block owning its outputs, so there are no
//     atomics and the result is deterministic;
//   * logits are kept in base 2: exponentials are exp2f, accurate to 2 ulp
//     without -use_fast_math (__expf, an ex2.approx of a pre-multiplied
//     argument whose error grows with |x|, is not used); the log-sum-exp
//     handed from the forward to the backward is in base 2 as well.
//
// Registers of the forward, dK/dV and dQ (ptxas, sm_90a, CUDA 12.9; spill
// store/load bytes in brackets): D=8 95, 107, 104; D=16 118, 127, 128 (all
// under __launch_bounds__(128, 4)); D=32 180, 239, 244; D=64 254, 255
// [1204/1048], 255 [580/488]; D=128 255 [1896/2908], 255 [4432/5240], 255
// [4184/7548]. chip_smoke.py prints the registers and spills at every head
// dim; the bfloat16 instances' are in their note below.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32_mma.cuh"

#ifndef MOVAE_FLASH_D
#error "build with -DMOVAE_FLASH_D=<head dim>: one library per head dim"
#endif
static_assert(MOVAE_FLASH_D == 8 || MOVAE_FLASH_D == 16 ||
                  MOVAE_FLASH_D == 32 || MOVAE_FLASH_D == 64 ||
                  MOVAE_FLASH_D == 128,
              "MOVAE_FLASH_D must be one of 8, 16, 32, 64, 128");

namespace {

using namespace movae;

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

// ---------------------------------------------------------------------------
// 4 warps a block, tensor-core products in split TF32, cp.async staging
// ---------------------------------------------------------------------------

constexpr int kTile = 64;      // rows a block owns
constexpr int kKeyStep = 32;   // forward: keys per online-softmax step
constexpr int kQStep = 16;     // dK/dV: queries per inner step
constexpr int kDqStep = 32;    // dQ: keys per inner step

// blocks an SM must hold at once: 4 at D <= 16 caps a thread at 128
// registers, which all three kernels fit without spilling
template <int D>
constexpr int kMinBlocks = D <= 16 ? 4 : 1;

template <int D>
constexpr int fwd_smem_bytes() {
  // 2 buffers of K and of V (split in place: big), V small
  return 5 * kMat<D> * static_cast<int>(sizeof(float));
}
template <int D>
constexpr int dkv_smem_bytes() {
  // 2 buffers of q (scaled) and of do (split in place: big), q big, q small,
  // do small, and 2 buffers of lse2 and of di
  return (7 * kMat<D> + 4 * kStream<D>) * static_cast<int>(sizeof(float));
}
template <int D>
constexpr int dq_smem_bytes() {
  // 2 buffers of K (raw: the logits), K big, K small, 2 buffers of V (split
  // in place: big), V small
  return 7 * kMat<D> * static_cast<int>(sizeof(float));
}

// the logit chain, acc = fmaf(a[i], b[i], acc) for i ascending from acc = 0,
// for two rows a0, a1 against one staged row b
template <int D>
__device__ __forceinline__ void dot2(const float (&a0)[D],
                                     const float (&a1)[D],
                                     const float* __restrict__ b, float& d0,
                                     float& d1) {
  float acc0 = 0.f, acc1 = 0.f;
#pragma unroll
  for (int i = 0; i < D; i += 4) {
    const float4 v = *reinterpret_cast<const float4*>(b + i);
    acc0 = fmaf(a0[i], v.x, acc0);
    acc1 = fmaf(a1[i], v.x, acc1);
    acc0 = fmaf(a0[i + 1], v.y, acc0);
    acc1 = fmaf(a1[i + 1], v.y, acc1);
    acc0 = fmaf(a0[i + 2], v.z, acc0);
    acc1 = fmaf(a1[i + 2], v.z, acc1);
    acc0 = fmaf(a0[i + 3], v.w, acc0);
    acc1 = fmaf(a1[i + 3], v.w, acc1);
  }
  d0 = acc0;
  d1 = acc1;
}

// once this thread's copies of a staged tile have landed (the same chunks
// as copy_tile's): x = raw * mul, kept in raw when kKeep; its TF32 halves
// into big and small (big may be raw itself, split in place)
template <int D, bool kKeep>
__device__ __forceinline__ void split_tile(float* raw, float* big,
                                           float* small, float mul) {
#pragma unroll
  for (int it = 0; it < kChunkIters<D>; ++it) {
    const unsigned i = chunk(it);
    const unsigned at = (i / (D / 4)) * kStride<D> + 4 * (i % (D / 4));
    float4 x = *reinterpret_cast<const float4*>(raw + at);
    if (kKeep) {
      x = make_float4(x.x * mul, x.y * mul, x.z * mul, x.w * mul);
      *reinterpret_cast<float4*>(raw + at) = x;
    }
    const float4 b = make_float4(tf32_rna(x.x), tf32_rna(x.y), tf32_rna(x.z),
                                 tf32_rna(x.w));
    *reinterpret_cast<float4*>(big + at) = b;
    *reinterpret_cast<float4*>(small + at) =
        make_float4(tf32_rna(x.x - b.x), tf32_rna(x.y - b.y),
                    tf32_rna(x.z - b.z), tf32_rna(x.w - b.w));
  }
}

// one forward step over the kKeyStep staged keys from row c of the tile
// (key index `key`): logits, online softmax, p v. kMasked: the step holds
// keys past some row of the warp (the diagonal)
template <int D, bool kMasked>
__device__ __forceinline__ void fwd_step(const float (&qr)[2][D],
                                         float (&acc)[D / 8][4],
                                         float (&m)[2], float (&l)[2],
                                         const float* __restrict__ ks,
                                         const float* __restrict__ vbig,
                                         const float* __restrict__ vsmall,
                                         int c, int key, int row0) {
  constexpr int S = kStride<D>, N8 = D / 8;
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  // s[j]: keys key + 8j + 2t (+1) of rows row0, row0 + 8, accumulator order
  float s[kKeyStep / 8][4];
#pragma unroll
  for (int j = 0; j < kKeyStep / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = 8 * j + 2 * t + e;
      float d0, d1;
      dot2<D>(qr[0], qr[1], ks + (c + r) * S, d0, d1);
      s[j][e] = kMasked && key + r > row0 ? -INFINITY : d0;
      s[j][2 + e] = kMasked && key + r > row0 + 8 ? -INFINITY : d1;
    }
  }
  float mx[2] = {m[0], m[1]}, corr[2];
#pragma unroll
  for (int j = 0; j < kKeyStep / 8; ++j) {
    mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    // key 0 is in every row's first step, so mx is finite from there on
    corr[r] = exp2f(m[r] - mx[r]);
    m[r] = mx[r];
    l[r] *= corr[r];
  }
  // this step's p v
  float pv[N8][4];
#pragma unroll
  for (int n = 0; n < N8; ++n) pv[n][0] = pv[n][1] = pv[n][2] = pv[n][3] = 0.f;
#pragma unroll
  for (int j = 0; j < kKeyStep / 8; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      s[j][i] = exp2f(s[j][i] - m[i >> 1]);
      l[i >> 1] += s[j][i];
    }
    // p as the A operand, reduction index k = t -> key 2t, t+4 -> 2t+1
    FragA pa;
    pa.set(s[j][0], s[j][2], s[j][1], s[j][3]);
    const int v0 = (c + 8 * j + 2 * t) * S + g;
#pragma unroll
    for (int n = 0; n < N8; ++n) {
      FragB vf;
      vf.load(vbig, vsmall, v0 + 8 * n, v0 + S + 8 * n);
      mma_3xtf32(pv[n], pa, vf);
    }
  }
  // the tensor cores round their sums toward zero: one long-lived
  // accumulator would drift with L, so each step's products are added to
  // the running sum with an ordinary float32 add
#pragma unroll
  for (int n = 0; n < N8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      acc[n][i] = fmaf(acc[n][i], corr[i >> 1], pv[n][i]);
}

// grid (B*H, ceil(L/64)); blockIdx.y = 0 is the LAST query tile
template <int D>
__global__ void __launch_bounds__(kThreads, kMinBlocks<D>)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse2, int L, float scale_log2) {
  constexpr int M = kMat<D>, N8 = D / 8, R = kStream<D>;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;          // 2 buffers
  float* vs = smem + 2 * M;  // 2 buffers, split in place: big
  float* vsm = smem + 4 * M;

  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2,
            t = threadIdx.x & 3;
  const int qt = gridDim.y - 1 - blockIdx.y;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * L * D;
  const float* kb = k + base;
  const float* vb = v + base;
  const int warp_first = qt * kTile + 16 * warp;
  const int rows[2] = {warp_first + g, warp_first + g + 8};
  // key tiles up to the one that holds the block's last row
  const int n_tiles = (min(qt * kTile + kTile, L) - 1) / R + 1;

  copy_tile<D>(kb, ks, 0, L);
  copy_tile<D>(vb, vs, 0, L);
  cp_async_commit();

  float qr[2][D];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    load_row<D>(q + base + static_cast<int64_t>(rows[r]) * D, qr[r],
                rows[r] < L);
#pragma unroll
    for (int i = 0; i < D; ++i) qr[r][i] *= scale_log2;
  }
  // accumulator n-tile n: rows g, g+8 by columns 8n + 2t, 8n + 2t + 1
  float acc[N8][4];
#pragma unroll
  for (int n = 0; n < N8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int buf = (kt & 1) * M;
    if (kt + 1 < n_tiles) {
      const int next = ((kt + 1) & 1) * M;
      copy_tile<D>(kb, ks + next, (kt + 1) * R, L);
      copy_tile<D>(vb, vs + next, (kt + 1) * R, L);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    split_tile<D, false>(vs + buf, vs + buf, vsm, 1.f);
    __syncthreads();
#pragma unroll 1
    for (int c0 = 0; c0 < R; c0 += kKeyStep) {
      const int key0 = kt * R + c0;
      if (key0 > warp_first + 15) break;  // every key here is ahead
      if (key0 + kKeyStep - 1 <= warp_first)
        fwd_step<D, false>(qr, acc, m, l, ks + buf, vs + buf, vsm, c0, key0,
                           rows[0]);
      else
        fwd_step<D, true>(qr, acc, m, l, ks + buf, vs + buf, vsm, c0, key0,
                          rows[0]);
    }
    __syncthreads();  // before tile kt + 2 overwrites this buffer
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    if (rows[r] >= L) continue;
    const float inv = 1.f / l[r];
    float* orow = o + base + static_cast<int64_t>(rows[r]) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < N8; ++n)
      *reinterpret_cast<float2*>(orow + 8 * n) =
          make_float2(acc[n][2 * r] * inv, acc[n][2 * r + 1] * inv);
    if (t == 0)
      lse2[static_cast<int64_t>(blockIdx.x) * L + rows[r]] =
          m[r] + log2f(l[r]);
  }
}

// staged query tile of dK/dV from row c on: q scaled (logits), its halves,
// do's halves, lse2 and di
struct DkvTile {
  const float *q, *qbig, *qsmall, *dobig, *dosmall, *lse2, *di;
};

// one dK/dV step over the kQStep staged queries from row c of the tile
// (query index qi0): logits, dp, p, ds, then dv and dk. kMasked: the step
// holds a query before some key of the warp, or past L
template <int D, bool kMasked>
__device__ __forceinline__ void dkv_step(const float (&kr)[2][D],
                                         const FragA (&va)[D / 8],
                                         float (&dka)[D / 8][4],
                                         float (&dva)[D / 8][4],
                                         const DkvTile& tile, int c, int qi0,
                                         int col0, int L) {
  constexpr int S = kStride<D>, N8 = D / 8;
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  // s[j], dp[j]: keys col0, col0 + 8 by queries qi0 + 8j + 2t (+1)
  float s[kQStep / 8][4], dp[kQStep / 8][4];
#pragma unroll
  for (int j = 0; j < kQStep / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e)
      dot2<D>(kr[0], kr[1], tile.q + (c + 8 * j + 2 * t + e) * S, s[j][e],
              s[j][2 + e]);
    dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
    const int d0 = (c + 8 * j + g) * S + t;
#pragma unroll
    for (int n = 0; n < N8; ++n) {
      FragB df;  // do^T: reduction index d = 8n + t (+4), query g
      df.load(tile.dobig, tile.dosmall, d0 + 8 * n, d0 + 8 * n + 4);
      mma_3xtf32(dp[j], va[n], df);
    }
  }
  // this step's dv and dk, added to the running sums with a float32 add
  // (the tensor cores round their sums toward zero)
  float sdv[N8][4], sdk[N8][4];
#pragma unroll
  for (int n = 0; n < N8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) sdv[n][i] = sdk[n][i] = 0.f;
#pragma unroll
  for (int j = 0; j < kQStep / 8; ++j) {
    float ds[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = c + 8 * j + 2 * t + (i & 1);
      const int qi = qi0 - c + r;
      const float p = kMasked && (qi < col0 + 8 * (i >> 1) || qi >= L)
                          ? 0.f
                          : exp2f(s[j][i] - tile.lse2[r]);
      ds[i] = p * (dp[j][i] - tile.di[r]);
      s[j][i] = p;
    }
    // p^T and ds^T as A operands: k = t -> query 2t, t+4 -> 2t+1
    FragA pa, sa;
    pa.set(s[j][0], s[j][2], s[j][1], s[j][3]);
    sa.set(ds[0], ds[2], ds[1], ds[3]);
    const int r0 = (c + 8 * j + 2 * t) * S + g;
#pragma unroll
    for (int n = 0; n < N8; ++n) {
      FragB df, qf;
      df.load(tile.dobig, tile.dosmall, r0 + 8 * n, r0 + S + 8 * n);
      qf.load(tile.qbig, tile.qsmall, r0 + 8 * n, r0 + S + 8 * n);
      mma_3xtf32(sdv[n], pa, df);
      mma_3xtf32(sdk[n], sa, qf);
    }
  }
#pragma unroll
  for (int n = 0; n < N8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      dva[n][i] += sdv[n][i];
      dka[n][i] += sdk[n][i];
    }
}

// grid (B*H, ceil(L/64)); blockIdx.y = 0 is the FIRST key tile, which sees
// every query tile
template <int D>
__global__ void __launch_bounds__(kThreads, kMinBlocks<D>)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ lse2,
                     const float* __restrict__ di, float* __restrict__ dk,
                     float* __restrict__ dv, int L, float scale_log2,
                     float scale) {
  constexpr int M = kMat<D>, N8 = D / 8, R = kStream<D>;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;             // 2 buffers: q, scaled once landed
  float* dos = smem + 2 * M;    // 2 buffers: do, split in place: big
  float* qbig = smem + 4 * M;
  float* qsmall = smem + 5 * M;
  float* dosmall = smem + 6 * M;
  float* ls = smem + 7 * M;     // 2 buffers of R
  float* dis = ls + 2 * R;      // 2 buffers of R

  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2,
            t = threadIdx.x & 3;
  const int kt = blockIdx.y;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * L * D;
  const int64_t lbase = static_cast<int64_t>(blockIdx.x) * L;
  const float* qb = q + base;
  const float* dob = dout + base;
  const int warp_first = kt * kTile + 16 * warp;
  const int cols[2] = {warp_first + g, warp_first + g + 8};
  const int n_tiles = (L - kt * kTile + R - 1) / R;

  // one query tile (rows t0 .. t0 + R - 1) of q, do, lse2, di into buffer b
  auto issue = [&](int t0, int b) {
    copy_tile<D>(qb, qs + b * M, t0, L);
    copy_tile<D>(dob, dos + b * M, t0, L);
    if (threadIdx.x < 2 * R) {  // 2R <= kThreads: one value a thread
      const int r = threadIdx.x % R;
      const bool in = t0 + r < L;
      const int64_t at = lbase + (in ? t0 + r : 0);
      if (threadIdx.x < R)
        cp_async4(ls + b * R + r, lse2 + at, in);
      else
        cp_async4(dis + b * R + r, di + at, in);
    }
    cp_async_commit();
  };
  issue(kt * kTile, 0);

  // the warp's k rows (logits) and v as split A operands of dp = v do^T
  float kr[2][D];
#pragma unroll
  for (int r = 0; r < 2; ++r)
    load_row<D>(k + base + static_cast<int64_t>(cols[r]) * D, kr[r],
                cols[r] < L);
  FragA va[N8];
#pragma unroll
  for (int n = 0; n < N8; ++n) {
    float x[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int col = cols[i & 1], d = 8 * n + t + 4 * (i >> 1);
      x[i] = col < L ? __ldg(v + base + static_cast<int64_t>(col) * D + d)
                     : 0.f;
    }
    va[n].set(x[0], x[1], x[2], x[3]);
  }
  // accumulators: rows (keys) g, g+8 by columns 8n + 2t, 8n + 2t + 1
  float dka[N8][4], dva[N8][4];
#pragma unroll
  for (int n = 0; n < N8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) dka[n][i] = dva[n][i] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int t0 = kt * kTile + it * R, b = it & 1;
    if (it + 1 < n_tiles) {
      issue(t0 + R, b ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    // q is scaled as it lands, exactly as the forward and dQ scale their q
    // rows, so that each logit here is bit-identical to theirs
    split_tile<D, true>(qs + b * M, qbig, qsmall, scale_log2);
    split_tile<D, false>(dos + b * M, dos + b * M, dosmall, 1.f);
    __syncthreads();
    const DkvTile tile{qs + b * M, qbig,   qsmall, dos + b * M,
                       dosmall,    ls + b * R, dis + b * R};
#pragma unroll 1
    for (int c0 = 0; c0 < R; c0 += kQStep) {
      const int qi0 = t0 + c0;
      if (qi0 >= L) break;
      // every query here comes before every key of the warp
      if (qi0 + kQStep - 1 < warp_first) continue;
      if (qi0 >= warp_first + 15 && qi0 + kQStep <= L)
        dkv_step<D, false>(kr, va, dka, dva, tile, c0, qi0, cols[0], L);
      else
        dkv_step<D, true>(kr, va, dka, dva, tile, c0, qi0, cols[0], L);
    }
    __syncthreads();  // before tile it + 2 overwrites this buffer
  }

  // dka sums ds * q * scale_log2; dk wants ds * q * scale
  const float mul = scale / scale_log2;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (cols[r] >= L) continue;
    const int64_t at = base + static_cast<int64_t>(cols[r]) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < N8; ++n) {
      *reinterpret_cast<float2*>(dk + at + 8 * n) =
          make_float2(dka[n][2 * r] * mul, dka[n][2 * r + 1] * mul);
      *reinterpret_cast<float2*>(dv + at + 8 * n) =
          make_float2(dva[n][2 * r], dva[n][2 * r + 1]);
    }
  }
}

// staged key tile of dQ from row c on: K raw (the logits), K's halves, V's
// halves
struct DqTile {
  const float *k, *kbig, *ksmall, *vbig, *vsmall;
};

// one dQ step over the kDqStep staged keys from row c of the tile (key index
// key): logits, dp, p, ds, then dq. kMasked: the step holds keys past some
// row of the warp (the diagonal)
template <int D, bool kMasked>
__device__ __forceinline__ void dq_step(const float (&qr)[2][D],
                                        const FragA (&doa)[D / 8],
                                        const float (&lr)[2],
                                        const float (&dir)[2],
                                        float (&dqa)[D / 8][4],
                                        const DqTile& tile, int c, int key,
                                        int row0) {
  constexpr int S = kStride<D>, N8 = D / 8;
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  // s[j], dp[j]: keys key + 8j + 2t (+1) of rows row0, row0 + 8, in the
  // forward's accumulator order
  float s[kDqStep / 8][4], dp[kDqStep / 8][4];
#pragma unroll
  for (int j = 0; j < kDqStep / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e)
      dot2<D>(qr[0], qr[1], tile.k + (c + 8 * j + 2 * t + e) * S, s[j][e],
              s[j][2 + e]);
    dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
    const int v0 = (c + 8 * j + g) * S + t;
#pragma unroll
    for (int n = 0; n < N8; ++n) {
      FragB vf;  // v^T: reduction index d = 8n + t (+4), key g
      vf.load(tile.vbig, tile.vsmall, v0 + 8 * n, v0 + 8 * n + 4);
      mma_3xtf32(dp[j], doa[n], vf);
    }
  }
  // this step's ds k, added to the running sum with a float32 add (the
  // tensor cores round their sums toward zero)
  float sdq[N8][4];
#pragma unroll
  for (int n = 0; n < N8; ++n)
    sdq[n][0] = sdq[n][1] = sdq[n][2] = sdq[n][3] = 0.f;
#pragma unroll
  for (int j = 0; j < kDqStep / 8; ++j) {
    float ds[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = i >> 1;
      const float p = kMasked && key + 8 * j + 2 * t + (i & 1) > row0 + 8 * r
                          ? 0.f
                          : exp2f(s[j][i] - lr[r]);
      ds[i] = p * (dp[j][i] - dir[r]);
    }
    // ds as the A operand: k = t -> key 2t, t+4 -> 2t+1
    FragA da;
    da.set(ds[0], ds[2], ds[1], ds[3]);
    const int k0 = (c + 8 * j + 2 * t) * S + g;
#pragma unroll
    for (int n = 0; n < N8; ++n) {
      FragB kf;
      kf.load(tile.kbig, tile.ksmall, k0 + 8 * n, k0 + S + 8 * n);
      mma_3xtf32(sdq[n], da, kf);
    }
  }
#pragma unroll
  for (int n = 0; n < N8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) dqa[n][i] += sdq[n][i];
}

// grid (B*H, ceil(L/64)); blockIdx.y = 0 is the LAST query tile
template <int D>
__global__ void __launch_bounds__(kThreads, kMinBlocks<D>)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse2,
                    const float* __restrict__ di, float* __restrict__ dq,
                    int L, float scale_log2, float scale) {
  constexpr int M = kMat<D>, N8 = D / 8, R = kStream<D>;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;          // 2 buffers: raw, for the logits
  float* vs = smem + 2 * M;  // 2 buffers, split in place: big
  float* kbig = smem + 4 * M;
  float* ksmall = smem + 5 * M;
  float* vsmall = smem + 6 * M;

  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2,
            t = threadIdx.x & 3;
  const int qt = gridDim.y - 1 - blockIdx.y;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * L * D;
  const int64_t lbase = static_cast<int64_t>(blockIdx.x) * L;
  const float* kb = k + base;
  const float* vb = v + base;
  const int warp_first = qt * kTile + 16 * warp;
  const int rows[2] = {warp_first + g, warp_first + g + 8};
  // key tiles up to the one that holds the block's last row
  const int n_tiles = (min(qt * kTile + kTile, L) - 1) / R + 1;

  copy_tile<D>(kb, ks, 0, L);
  copy_tile<D>(vb, vs, 0, L);
  cp_async_commit();

  // the warp's q rows, scaled once (the logits, as in the forward), do as
  // split A operands of dp = do v^T, and lse2, di of both rows
  float qr[2][D], lr[2], dir[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool in = rows[r] < L;
    load_row<D>(q + base + static_cast<int64_t>(rows[r]) * D, qr[r], in);
#pragma unroll
    for (int i = 0; i < D; ++i) qr[r][i] *= scale_log2;
    lr[r] = in ? lse2[lbase + rows[r]] : 0.f;
    dir[r] = in ? di[lbase + rows[r]] : 0.f;
  }
  FragA doa[N8];
#pragma unroll
  for (int n = 0; n < N8; ++n) {
    float x[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = rows[i & 1], d = 8 * n + t + 4 * (i >> 1);
      x[i] = row < L
                 ? __ldg(dout + base + static_cast<int64_t>(row) * D + d)
                 : 0.f;
    }
    doa[n].set(x[0], x[1], x[2], x[3]);
  }
  // accumulator n-tile n: rows g, g+8 by columns 8n + 2t, 8n + 2t + 1
  float dqa[N8][4];
#pragma unroll
  for (int n = 0; n < N8; ++n)
    dqa[n][0] = dqa[n][1] = dqa[n][2] = dqa[n][3] = 0.f;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int buf = (kt & 1) * M;
    if (kt + 1 < n_tiles) {
      const int next = ((kt + 1) & 1) * M;
      copy_tile<D>(kb, ks + next, (kt + 1) * R, L);
      copy_tile<D>(vb, vs + next, (kt + 1) * R, L);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    split_tile<D, false>(ks + buf, kbig, ksmall, 1.f);
    split_tile<D, false>(vs + buf, vs + buf, vsmall, 1.f);
    __syncthreads();
    const DqTile tile{ks + buf, kbig, ksmall, vs + buf, vsmall};
#pragma unroll 1
    for (int c0 = 0; c0 < R; c0 += kDqStep) {
      const int key0 = kt * R + c0;
      if (key0 > warp_first + 15) break;  // every key here is ahead
      if (key0 + kDqStep - 1 <= warp_first)
        dq_step<D, false>(qr, doa, lr, dir, dqa, tile, c0, key0, rows[0]);
      else
        dq_step<D, true>(qr, doa, lr, dir, dqa, tile, c0, key0, rows[0]);
    }
    __syncthreads();  // before tile kt + 2 and the next split overwrite
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= L) continue;
    float* drow = dq + base + static_cast<int64_t>(rows[r]) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < N8; ++n)
      *reinterpret_cast<float2*>(drow + 8 * n) =
          make_float2(dqa[n][2 * r] * scale, dqa[n][2 * r + 1] * scale);
  }
}

constexpr float kLog2e = 1.4426950408889634f;

inline dim3 grid_for(int bh, int L) {
  return dim3(static_cast<unsigned>(bh),
              static_cast<unsigned>((L + kTile - 1) / kTile));
}

// one library per head dim, each its own nvcc job (kernels/build.py)
constexpr int kD = MOVAE_FLASH_D;

inline int prologue(int bh, int L, int d, int device) {
  // gridDim.y is at most 65535 tiles of 64 rows
  if (d != kD || bh <= 0 || L <= 0 || (L + kTile - 1) / kTile > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaSetDevice(device));
}

// past the 48 KB default a kernel must be allowed its dynamic shared memory
template <typename Kernel>
inline int allow_smem(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
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
  constexpr int smem = fwd_smem_bytes<kD>();
  err = allow_smem(flash_fwd_kernel<kD>, smem);
  if (err != 0) return err;
  flash_fwd_kernel<kD><<<grid_for(bh, L), kThreads, smem,
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
  constexpr int smem = dkv_smem_bytes<kD>();
  err = allow_smem(flash_bwd_dkv_kernel<kD>, smem);
  if (err != 0) return err;
  flash_bwd_dkv_kernel<kD><<<grid_for(bh, L), kThreads, smem,
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
  constexpr int smem = dq_smem_bytes<kD>();
  err = allow_smem(flash_bwd_dq_kernel<kD>, smem);
  if (err != 0) return err;
  flash_bwd_dq_kernel<kD><<<grid_for(bh, L), kThreads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      q, k, v, dout, lse2, di, dq, L, scale * kLog2e, scale);
  return static_cast<int>(cudaGetLastError());
}

// ===========================================================================
// bfloat16 instances: what the stock Pallas kernel computes on bf16 q, k, v
// (the PixelSNAIL prior under --compute_dtype bfloat16)
// ===========================================================================
//
// Replace the same three Pallas kernels at bf16 (flash_attention.py, jax
// 0.9.0): _flash_attention_impl :589 (logits from bf16 operands summed in
// f32 :395-397, scaled on the f32 logits :410-411, p rounded to bf16 before
// p.v :470-471, o written as bf16 :477), _flash_attention_bwd_dkv :941
// (dv = bf16(p)^T do :900, dp = do v^T in f32 :908-910, ds = (dp - di) p s
// :913-914, dk = bf16(ds)^T q :918, bf16 outputs :937-938) and
// _flash_attention_bwd_dq :1287 (dq = bf16(ds) k :1257-1261, bf16 :1283).
// di = sum_d o * do is the caller's, in f32 from the bf16 o and do (:273).
// The softmax statistics and the log-sum-exp (base 2) stay f32.
//
// Bound on an H100 SXM (700 W) at the prior shape B=16, H=8, L=4096, D=16:
// each causal pair needs one exp2 (1.07 G pairs over the MUFU rate, 16 a
// clock per SM, 4.18 T/s at 1.98 GHz: 0.257 ms in each kernel); the
// products (2, 4 and 3 a pair at 2 * D flops each: 34.4 GFLOP each) over
// the dense bf16 rate (989 TFLOP/s) take 0.07, 0.14 and 0.10 ms, and the
// bytes (each (B, H, L, D) bf16 tensor 16.8 MB) 0.02-0.04 ms. So the exp2
// per pair bounds all three at D=16: MUFU.EX2 issues a warp's 32 results
// in 8 cycles of its SM sub-partition, so a kernel stays on that bound only
// while it issues fewer than 8 other instructions per MUFU.EX2, and keeps
// enough warps in flight to cover the chain logits -> max -> exp2 -> p v.
//
// flash_fwd_bf16_kernel, flash_bwd_dkv_bf16_kernel and
// flash_bwd_dq_bf16_kernel, built for that:
//   * a block is 4 warps and no producer warp, so that 3 blocks of
//     168-register threads fit an SM (3 warps on each sub-partition, against
//     a producer design's 2). Thread 0 streams the other side (K, then K
//     and V, in the forward; q, do, lse2 and di in dK/dV; K and V in dQ) in
//     stages of 64 rows by TMA (cp.async.bulk.tensor) into a ring of 4
//     stages (3 at D = 128) with "full" mbarriers only; each stage ends its
//     wait with a __syncthreads, past which every warp is done with the
//     previous stage, whose slot thread 0 then refills. Before that barrier
//     each warp converts 16 of the stage's 64 streamed rows to floats (the
//     forward's K; q in dK/dV and K in dQ up to D = 64), into one of two
//     float copies;
//   * a staged tile is dense, laid out by the TMA box's swizzle (32-, 64- or
//     128-byte rows; D = 128 in two boxes of 64 columns; D = 8 rows are 16
//     bytes and need none), so that the 8 rows of every ldmatrix phase fall
//     on distinct banks (BfTile). Rows past L arrive as zeros;
//   * every B operand of an mma read from a staged tile is one ldmatrix:
//     along the rows for the logits and dp (K; q and do; K and V), .trans
//     down the rows for p v, p^T do and ds^T q, ds K. The A operands that
//     stay (q in the forward, k and v in dK/dV, q and do in dQ) are loaded
//     once from device memory;
//   * only the steps that touch the diagonal (or, in dK/dV, pass L) are
//     masked, each a warp-uniform choice between two instances of the step;
//   * forward: a warp owns 32 query rows at D = 16 (two groups of 16 that
//     share every staged value), 16 at the other D, in steps of 32 keys at
//     D = 16 and 128, 64 at the others, in two passes over the keys. Pass 1
//     takes each row's reference maximum m~ of its logits summed on the
//     tensor cores (one HMMA a 16 x 8 block and an FMNMX a logit; the scale
//     is positive, so m~ c rounds as max(s c) would). m~ is one value a row
//     and differs from the maximum m of the IEEE chain only by the tensor
//     cores' truncation (cuts 2^-25 of the row's largest products and a
//     float32 ulp), so p = 2^fma(s, c, -m~ c) in pass 2 is the plain version's
//     p times 2^((m - m~) c), next to 1 on the whole row: its bf16 roundings
//     are taken against one reference, as the plain version's are, with no
//     rescale of the sums. (A running maximum, one pass at 441 us against
//     537 at the prior shape in an earlier design, put the trained bf16
//     prior's dk 0.080 u from float64 in best-fit scale, past 17a's gate,
//     through o's bf16 rounding in di on sharp rows; the chain's own
//     maximum in a first IEEE pass costs a second chain: 2,208 against
//     1,419 us on an H100 SXM at 700 W.) Pass 2
//     computes the logits' IEEE chain, then p: one FFMA and one MUFU.EX2 a
//     logit, the sum and half a bf16 pack. movae_flash_bf16_fwd_ref_max
//     runs pass 1 alone and returns m~, so that a check on the card holds
//     |m~ - m| within the truncation's bound;
//   * dK/dV: a warp owns 32 keys at D <= 16 (two groups of 16 that share
//     every staged value), 16 above, in steps of 16 queries; a stage
//     whose every query sees every key of the warp runs its 4 steps
//     unrolled, with no mask. lse2 and di * scale of a step's queries are
//     read once into registers; p = 2^fma(s, c, -lse2), ds = p fma(dp,
//     scale, -di scale): 3 FP32 instructions, one bf16 pack and one
//     MUFU.EX2 a pair.
//     Past L, lse2 and di come from the next head and are masked; each of
//     their boxes starts at the 16-byte boundary at or before the stage's
//     first query (a TMA box must start 16-byte aligned);
//   * dQ: a warp owns 32 query rows at D <= 32 (two groups of 16 that share
//     every staged value), 16 above, in steps of 16 keys: the logits from
//     the warp's q rows as floats and the stage's float copy of K (up to D
//     = 64), dp along the V tile, then dq += ds K .trans down the K tile.
//     A stage whose every key precedes every row of the warp runs
//     its 4 steps unrolled, with no mask (at D <= 32). Each row's lse2 and
//     di * scale are read once into registers; p and ds are dK/dV's, so the
//     two kernels round one and the same bf16 ds. Keys past L are past
//     every row before L, so the diagonal's mask covers them; rows past L
//     are never stored. Per pair: one MUFU.EX2, 3 FP32 instructions, half
//     a bf16 pack and 3/4 of an HMMA (against dK/dV's 1), so the exp2
//     bounds dQ as it bounds the other two: 256.5 us at the prior shape,
//     its 3 products 104.3;
//   * ex2.approx.ftz.f32 is the MUFU.EX2 that exp2f compiles to, without
//     exp2f's fix-up of results below 2^-126: those are flushed to 0,
//     which no bf16 output can see. (The CUDA C++ programming guide bounds
//     exp2f at 2 ulp.)
//
// Common to all three:
//   * the logits are IEEE float32: each is one fmaf chain over d ascending
//     from 0 of the exact bf16 x bf16 products, in the accumulator layout
//     of an m16n8k16 product. The tensor cores sum the 16 products of an
//     mma with truncation, not rounding (chip_smoke.py --probe tc: they
//     cut each term toward zero 25 bits below the largest exponent, sum,
//     and cut the sum to float32): on a trained prior's sharp rows
//     that bias of the logits moved p's bf16 roundings enough to put dk
//     0.244 u from float64 in best-fit scale against the IEEE sums' 0.162
//     (17a allows + 0.0625), and the logits alone on the tensor cores
//     reproduced it (chip_smoke.py --probe dkv, PERF.md);
//   * the chain's operands. In the forward, and in dK/dV and dQ up to D =
//     64 (kDkvFloatK, kDqFloatQ), the side that stays (q rows in the
//     forward and dQ, the warp's k rows in dK/dV) is held as floats in
//     registers, converted once, and the streamed side is read as float4
//     from the stage's float copy (rows of D + 4 floats: a quad's LDS.128
//     reads of rows 2t, 2t + 1 and the 8 rows g of a warp fall on distinct
//     banks): per 4 d, 16 FFMA a 2 x 2 block of logits from two LDS.128, or
//     32 from one at two row groups. dK/dV and dQ at D = 128 (where their
//     float rows spill) shuffle the operands out of the mma fragments
//     (fma_logits: 48 SHFL and 96 unpacks for 128 FFMA). What bounds the
//     float path at D = 16 is the delivery of those broadcast LDS.128 to
//     the registers and the FFMA issue, not occupancy: with the loads of
//     the forward's keys hoisted out of its step (wrong values, a timing
//     probe) it ran in 740 us against 1,678 (H100 SXM, 700 W);
//   * every other product is mma.sync.aligned.m16n8k16.row.col.f32.bf16.
//     bf16.f32: bf16 operands exactly as given, f32 accumulation, one pass.
//     The logits' accumulator layout is the A layout of the next product
//     (p or ds as A: k = 2t, 2t+1 of each 8 columns), so p and ds go from
//     registers to the tensor cores, rounded to bf16 as they are packed;
//     wgmma would buy nothing while the products take 69.5-139 us of bound
//     against exp2's 257;
//   * D = 8 is below the mma's depth of 16: the logit and dp products pad
//     the reduction to 16 with zeros in registers (the upper half of each
//     A and B fragment is 0); a chain of 8 then adds exact zeros, which
//     leave it bit for bit as it is (from acc = +0 no sum is -0);
//   * accumulators run for the whole row (no per-step f32 add): the tensor
//     cores' truncated sums drift by ~1e-5 relative over L = 4096, far under
//     the bf16 rounding of the outputs (2^-9);
//   * no atomics: each block owns its outputs; the longest blocks first.
//
// The recompute contract: each logit is one fmaf chain over d ascending of
// the same bf16 values, so the raw logit s is bit for bit the same in all
// three kernels (dK/dV swaps the operands of the same exact bf16 x bf16
// products; float operands are those bf16 values exactly); the three scale
// it by c in f32. Only the forward's reference maximum comes from another
// sum.
//
// Registers of the bf16 forward, dK/dV and dQ (ptxas, sm_90a, CUDA 12.9's
// nvcc; spill store/load bytes in brackets): D=8 113, 168, 164; D=16 168,
// 168 [4/8], 168; D=32 168 [20/24], 168, 255 [72/76]; D=64 255, 230, 197;
// D=128 255, 255 [20/36], 247. dQ before its float rows (shuffled
// operands, a producer warp): D=8 128 [60/60], D=16 128 [216/320], D=32
// 168 [680/1408], D=64 247, D=128 248. The fragment-path forward and
// dK/dV, both shuffling at every D, with the same nvcc: D=8 128 [40/44],
// 128; D=16 128, 128 [220/464]; D=32 128 [68/96], 168; D=64 255, 246;
// D=128 255 [3056/3132], 255 [12/16].

#include <cuda.h>  // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>

#include <type_traits>

namespace {

using u16 = unsigned short;

template <int D>
constexpr int kBfSteps = D < 16 ? 1 : D / 16;  // k16 steps over D

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return (static_cast<uint32_t>(__bfloat16_as_ushort(v.y)) << 16) |
         __bfloat16_as_ushort(v.x);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float bf_lo(uint32_t x) {
  return __uint_as_float(x << 16);
}
__device__ __forceinline__ float bf_hi(uint32_t x) {
  return __uint_as_float(x & 0xffff0000u);
}

// c0 += A B0 and c1 += A B1 over one k16 step, each element an IEEE float32
// fmaf chain in ascending k (the logit chain): A the m16n8k16 A fragment a
// (rows g and g + 8 by k = 2t, 2t + 1 and 2t + 8, 2t + 9), B0 and B1 the B
// fragments (b[0], b[1]) and (b[2], b[3]) of two n-tiles (k = 2t, 2t + 1
// and 2t + 8, 2t + 9 by column g), c0 and c1 in the accumulator layout (rows
// g, g + 8 by columns 2t, 2t + 1). A's rows come from the lanes of this
// thread's quad, B's columns 2t and 2t + 1 from the quads 2t and 2t + 1.
__device__ __forceinline__ void fma_logits(float (&c0)[4], float (&c1)[4],
                                           const uint32_t (&a)[4],
                                           const uint32_t (&b)[4]) {
  constexpr unsigned kAll = 0xffffffffu;
  const int lane = threadIdx.x & 31, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h)  // k in [8 h, 8 h + 8)
#pragma unroll
    for (int tt = 0; tt < 4; ++tt) {  // k = 8 h + 2 tt, then + 1
      const uint32_t r0 = __shfl_sync(kAll, a[2 * h], (lane & ~3) | tt);
      const uint32_t r1 = __shfl_sync(kAll, a[2 * h + 1], (lane & ~3) | tt);
      uint32_t col[2][2];
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        col[n][0] = __shfl_sync(kAll, b[2 * n + h], 8 * t + tt);
        col[n][1] = __shfl_sync(kAll, b[2 * n + h], 8 * t + 4 + tt);
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float x0 = e ? bf_hi(r0) : bf_lo(r0);
        const float x1 = e ? bf_hi(r1) : bf_lo(r1);
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          float(&c)[4] = n ? c1 : c0;
          const float y0 = e ? bf_hi(col[n][0]) : bf_lo(col[n][0]);
          const float y1 = e ? bf_hi(col[n][1]) : bf_lo(col[n][1]);
          c[0] = fmaf(x0, y0, c[0]);
          c[1] = fmaf(x0, y1, c[1]);
          c[2] = fmaf(x1, y0, c[2]);
          c[3] = fmaf(x1, y1, c[3]);
        }
      }
    }
}

// the m16 x k16 A fragments over D of rows r0 (g) and r1 (g + 8) of an
// (L, D) bf16 matrix in device memory; zeros past L and past D (D = 8)
template <int D>
__device__ __forceinline__ void load_a_bf16(const u16* __restrict__ m,
                                            int r0, int r1, int L,
                                            uint32_t (&a)[kBfSteps<D>][4]) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int s = 0; s < kBfSteps<D>; ++s) {
    const int c0 = 16 * s + 2 * t, c1 = c0 + 8;
    a[s][0] = r0 < L ? __ldg(reinterpret_cast<const unsigned*>(
                           m + static_cast<int64_t>(r0) * D + c0))
                     : 0u;
    a[s][1] = r1 < L ? __ldg(reinterpret_cast<const unsigned*>(
                           m + static_cast<int64_t>(r1) * D + c0))
                     : 0u;
    a[s][2] = c1 < D && r0 < L
                  ? __ldg(reinterpret_cast<const unsigned*>(
                        m + static_cast<int64_t>(r0) * D + c1))
                  : 0u;
    a[s][3] = c1 < D && r1 < L
                  ? __ldg(reinterpret_cast<const unsigned*>(
                        m + static_cast<int64_t>(r1) * D + c1))
                  : 0u;
  }
}

// the A fragment of a 16 x 16 block from two 8-column accumulators, rounded
// to bf16
__device__ __forceinline__ void acc_to_a(const float (&lo)[4],
                                         const float (&hi)[4],
                                         uint32_t (&a)[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

// rows r0 (g) and r1 (g + 8) of an (.., D) accumulator set, as bf16, times
// mul, at columns 8n + 2t (+1)
template <int D>
__device__ __forceinline__ void store_rows_bf16(u16* __restrict__ out,
                                                const float (&c)[D / 8][4],
                                                int r0, int r1, int L,
                                                float mul0, float mul1) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r ? r1 : r0;
    if (row >= L) continue;
    const float mul = r ? mul1 : mul0;
    u16* p = out + static_cast<int64_t>(row) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(p + 8 * n) =
          pack_bf16(c[n][2 * r] * mul, c[n][2 * r + 1] * mul);
  }
}

// ---------------------------------------------------------------------------
// The bf16 kernels: TMA ring issued by the first thread, ldmatrix
// ---------------------------------------------------------------------------

constexpr int kBfConsumers = 4;  // warps a block
// no producer warp (the first thread issues the copies), so that 3 blocks
// of 168-register threads fit an SM
constexpr int kFThreads = 32 * kBfConsumers;
constexpr int kStage = 64;                           // streamed rows a stage
// dK/dV's lse2 and di boxes: a box must start on a 16-byte boundary of
// device memory, so each starts at the 4-float boundary at or before the
// stage's first query and runs 4 floats longer; they lie kVecPitch floats
// apart in shared memory (384 bytes: a TMA destination is 128-byte aligned)
constexpr int kVecBox = kStage + 4;
constexpr int kVecPitch = 96;

// 16-row groups a warp owns: two where they fit the registers without a
// spill, so that every staged value feeds two chains (the forward's float q
// rows of two groups: 64 registers at D = 16; two groups took 1,442.8
// us against one's 1,678.5 at the prior shape)
template <int D>
constexpr int kFwdGroups = D == 16 ? 2 : 1;
template <int D>
constexpr int kDkvGroups = D <= 16 ? 2 : 1;
template <int D>
constexpr int kStages = D <= 64 ? 4 : 3;  // ring depth
template <int D>
constexpr int kFwdStep = D == 16 || D == 128 ? 32 : 64;  // forward: keys a step
// blocks an SM must hold at once: 3 blocks of 4 warps put 3 warps on one SM
// sub-partition (16,384 registers each), which caps a thread at 168
template <int D>
constexpr int kFwdMinBlocks = D <= 32 ? 3 : 1;
template <int D>
constexpr int kDkvMinBlocks = D <= 32 ? 3 : 1;

// The forward, and dK/dV up to D = 64, read the logit chain's operands as
// floats: the side that stays (q rows in the forward, the warp's k rows in
// dK/dV) converted once, the streamed side from a float copy of each stage
// that the block's 4 warps make as the stage lands, a quarter each (rows of
// kFPitch floats: the quad's LDS.128 reads of rows 2t fall on distinct
// banks, as do 8 consecutive rows). dK/dV and dQ at D = 128 keep the
// operands shuffled out of the mma fragments (fma_logits): their float rows
// spill there (dK/dV's k 856 / 1,044 bytes, 1.8x the time; dQ's q 64 / 116
// bytes, 24.7-24.9 ms against 15.2; ptxas of CUDA 12.9 and an H100 SXM at
// 700 W, PERF.md). Up to D = 64 dQ's float rows took 0.64, 0.80, 0.82 and
// 0.71 of the shuffled path's time at D = 8, 16, 32, 64 (the same row
// groups: one at D = 32)
template <int D>
constexpr bool kDkvFloatK = D <= 64;
template <int D>
constexpr bool kDqFloatQ = D <= 64;
// dQ's 16-row groups a warp owns and the blocks an SM must hold at once:
// two groups up to D = 32 (D = 16: 64 q floats and 168 registers, 1,204-1,212
// us against one group's 1,448-1,454 at the prior shape; D = 8 804-811
// against 866-873). At D = 32 two groups fit only 2 blocks an SM (255
// registers, 72 / 76 bytes spilled) and still beat one group at 3 blocks
// (168, no spill): 2,631-2,633 against 2,781-2,784 us at (16, 8, 4096, 32)
template <int D>
constexpr int kDqGroups = D <= 32 ? 2 : 1;
template <int D>
constexpr int kDqMinBlocks = D <= 16 ? 3 : D == 32 ? 2 : 1;

template <int D>
constexpr int kFPitch = D + 4;
template <int D>
constexpr int kFTileBytes = kStage * kFPitch<D> * 4;

// A staged (kStage, D) bf16 tile as TMA writes it: boxes of kBox bytes a
// row (two boxes of 64 columns at D = 128), each box kStage dense rows, its
// 16-byte chunks swizzled by the box's own mode (CU_TENSOR_MAP_SWIZZLE_32B,
// _64B, _128B: chunk bits [4, 4 + log2(kBox / 16)) of the byte offset
// XORed with bits [7, ...)), so that the 8 rows an ldmatrix phase reads lie
// on 8 distinct 16-byte bank groups. D = 8 rows are 16 bytes, so 8
// consecutive rows already do. Tiles start on 1024-byte boundaries, the
// 128-byte swizzle's period.
template <int D>
struct BfTile {
  static constexpr int kBox = 2 * D < 128 ? 2 * D : 128;
  static constexpr int kPer = kBox / 16;  // 16-byte chunks a box row
  static constexpr int kBytes = kStage * 2 * D;
  // byte offset of 16-byte chunk c (of 2D / 16) of row r
  __device__ static __forceinline__ uint32_t at(int r, int c) {
    const int o = r * kBox + (c % kPer) * 16;
    return static_cast<uint32_t>((c / kPer) * (kStage * kBox) +
                                 (o ^ (((o >> 7) & (kPer - 1)) << 4)));
  }
};

template <int D>
constexpr int fwd_bf16_smem() {  // K and V a stage, the barriers, alignment
  return 1024 + kStages<D> * 2 * BfTile<D>::kBytes + 16 * kStages<D>;
}
template <int D>
constexpr int dkv_bf16_smem() {  // q, do, lse2 and di a stage
  return 1024 + kStages<D> * (2 * BfTile<D>::kBytes + 8 * kVecPitch) +
         16 * kStages<D>;
}
// the forward and dK/dV: their rings and two float copies of the streamed
// side (a stage's and the next's)
template <int D>
constexpr int fwd_bf16_f_smem() {
  return fwd_bf16_smem<D>() + 2 * kFTileBytes<D>;
}
template <int D>
constexpr int dkv_bf16_f_smem() {
  return dkv_bf16_smem<D>() + (kDkvFloatK<D> ? 2 * kFTileBytes<D> : 0);
}
template <int D>
constexpr int dq_bf16_f_smem() {  // dQ: the forward's K and V ring
  return fwd_bf16_smem<D>() + (kDqFloatQ<D> ? 2 * kFTileBytes<D> : 0);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// this thread's arrival, and `bytes` more that the copies must bring
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// until the phase of parity `parity` of the barrier has completed; a phase
// that never completes (a copy that faulted) traps after 2^28 polls, so
// that the launch fails where it would hang
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done, polls = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (++polls == (1u << 28)) __trap();
  } while (!done);
}

// box (c0, c1, c2) of a tensor map into shared memory at dst, completing
// its bytes on the barrier
__device__ __forceinline__ void tma_3d(uint32_t dst, const CUtensorMap* map,
                                       uint32_t bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_1d(uint32_t dst, const CUtensorMap* map,
                                       uint32_t bar, int c0) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0)
      : "memory");
}

// rows [r0, r0 + kStage) of head h of a (bh, L, D) map: one box a 64
// columns (128 bytes)
template <int D>
__device__ __forceinline__ void tma_rows(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int r0, int h) {
  constexpr int kBoxes = 2 * D / BfTile<D>::kBox;
#pragma unroll
  for (int b = 0; b < kBoxes; ++b)
    tma_3d(dst + b * kStage * BfTile<D>::kBox, map, bar,
           b * (BfTile<D>::kBox / 2), r0, h);
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}
__device__ __forceinline__ void ldsm_x2(uint32_t addr, uint32_t& r0,
                                        uint32_t& r1) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void ldsm_x2_t(uint32_t addr, uint32_t& r0,
                                          uint32_t& r1) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r0), "=r"(r1)
      : "r"(addr)
      : "memory");
}

// B fragments of a product that reduces along the staged rows (K for the
// forward's logits, q and do for dK/dV's), reduction step st over D: (b[0],
// b[1]) for rows r0 .. r0 + 7 as the columns, (b[2], b[3]) for rows r0 + 8
// .. r0 + 15; at D = 8 the upper halves are 0 (the reduction padded to 16)
template <int D>
__device__ __forceinline__ void ldsm_along(uint32_t tile, int r0, int st,
                                           uint32_t (&b)[4]) {
  const int lane = threadIdx.x & 31;
  if constexpr (D >= 16) {
    ldsm_x4(tile + BfTile<D>::at(r0 + (lane & 7) + ((lane >> 4) << 3),
                                 2 * st + ((lane >> 3) & 1)),
            b);
  } else {
    ldsm_x2(tile + BfTile<D>::at(r0 + (lane & 7) + (lane & 8), 0), b[0],
            b[2]);
    b[1] = b[3] = 0u;
  }
}

// B fragments of a product that reduces down the staged rows (V for p v, do
// and q for dv and dk): 16 rows from r0 by columns 16 n2 .. 16 n2 + 15, as
// (b[0], b[1]) for n-tile 2 n2 and (b[2], b[3]) for n-tile 2 n2 + 1 (only
// the first at D = 8)
template <int D>
__device__ __forceinline__ void ldsm_down(uint32_t tile, int r0, int n2,
                                          uint32_t (&b)[4]) {
  const int lane = threadIdx.x & 31;
  const int r = r0 + (lane & 7) + (lane & 8);
  if constexpr (D >= 16)
    ldsm_x4_t(tile + BfTile<D>::at(r, 2 * n2 + (lane >> 4)), b);
  else
    ldsm_x2_t(tile + BfTile<D>::at(r, 0), b[0], b[1]);
}

// 2^x on the MUFU unit, inputs and results below 2^-126 flushed to 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// acc + a.x b.x + a.y b.y + a.z b.z + a.w b.w as four fmaf in that order:
// four steps of the logit chain
__device__ __forceinline__ float chain4(float acc, float4 a, float4 b) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// 8 bf16 values (one 16-byte chunk) as two float4, into dst
__device__ __forceinline__ void bf8_to_float(uint4 v, float* dst) {
  reinterpret_cast<float4*>(dst)[0] =
      make_float4(bf_lo(v.x), bf_hi(v.x), bf_lo(v.y), bf_hi(v.y));
  reinterpret_cast<float4*>(dst)[1] =
      make_float4(bf_lo(v.z), bf_hi(v.z), bf_lo(v.w), bf_hi(v.w));
}

// rows [r0, r0 + 16) of a staged (kStage, D) bf16 tile (BfTile's layout)
// as float rows of kFPitch<D> at dst, by the 32 lanes of one warp: each of
// the 4 warps converts its quarter of a stage
template <int D>
__device__ __forceinline__ void tile_to_float(const uint8_t* tile,
                                              float* dst, int r0) {
  constexpr int kChunks = D / 8;  // 16-byte chunks a row
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int x = lane; x < 16 * kChunks; x += 32) {
    const int r = r0 + x / kChunks, c = x % kChunks;
    bf8_to_float(*reinterpret_cast<const uint4*>(tile + BfTile<D>::at(r, c)),
                 dst + r * kFPitch<D> + 8 * c);
  }
}

// row r of an (L, D) bf16 matrix in device memory as D floats, zeros past L
template <int D>
__device__ __forceinline__ void row_to_float(const u16* __restrict__ m,
                                             int r, int L, float (&x)[D]) {
#pragma unroll
  for (int c = 0; c < D; c += 8) {
    const uint4 v = r < L ? __ldg(reinterpret_cast<const uint4*>(
                                m + static_cast<int64_t>(r) * D + c))
                          : make_uint4(0u, 0u, 0u, 0u);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[c + 2 * i] = bf_lo(w[i]);
      x[c + 2 * i + 1] = bf_hi(w[i]);
    }
  }
}

// the forward's q rows a thread holds: rows row0 + 16 rg + g (+8) as the
// m16 x k16 A fragments over D (FwdQa: pass 1's tensor-core sums) and as
// floats (FwdQ: pass 2's chain)
template <int D>
using FwdQa = uint32_t[kFwdGroups<D>][kBfSteps<D>][4];
template <int D>
using FwdQ = float[kFwdGroups<D>][2][D];

template <int D>
__device__ __forceinline__ void load_fwd_qa(const u16* __restrict__ q,
                                            int row0, int L, FwdQa<D>& qa) {
  const int g = (threadIdx.x & 31) >> 2;
#pragma unroll
  for (int rg = 0; rg < kFwdGroups<D>; ++rg)
    load_a_bf16<D>(q, row0 + 16 * rg + g, row0 + 16 * rg + g + 8, L, qa[rg]);
}

template <int D>
__device__ __forceinline__ void load_fwd_q(const u16* __restrict__ q,
                                           int row0, int L, FwdQ<D>& qo) {
  const int g = (threadIdx.x & 31) >> 2;
#pragma unroll
  for (int rg = 0; rg < kFwdGroups<D>; ++rg) {
    row_to_float<D>(q, row0 + 16 * rg + g, L, qo[rg][0]);
    row_to_float<D>(q, row0 + 16 * rg + g + 8, L, qo[rg][1]);
  }
}

// keys past some row of the warp (the diagonal) read as -inf: s[rg][j] of a
// step from key0 as fwd_bf16_logits lays them out
template <int D>
__device__ __forceinline__ void fwd_mask(
    float (&s)[kFwdGroups<D>][kFwdStep<D> / 8][4], int key0, int row0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int rg = 0; rg < kFwdGroups<D>; ++rg)
#pragma unroll
    for (int j = 0; j < kFwdStep<D> / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (key0 + 8 * j + 2 * t + (i & 1) > row0 + 16 * rg + g + 8 * (i >> 1))
          s[rg][j][i] = -INFINITY;
}

// the raw logits s[rg][j] of kFwdStep<D> staged keys from tile row c (key
// index key0) for the warp's kFwdGroups<D> groups of 16 rows from row0: rows
// row0 + 16 rg + g (+8) by keys key0 + 8j + 2t (+1), each the logit chain.
// Its operands: q from qo, the keys from the stage's float copy kf (two
// LDS.128 a 4 x 4 block of the chain: 16 FFMA). kMasked: the step holds
// keys past some row of the warp, which read as -inf
template <int D, bool kMasked>
__device__ __forceinline__ void fwd_bf16_logits(
    const FwdQ<D>& qo, const float* __restrict__ kf, int c, int key0,
    int row0, float (&s)[kFwdGroups<D>][kFwdStep<D> / 8][4]) {
  constexpr int G = kFwdGroups<D>, NJ = kFwdStep<D> / 8;
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const float* k0 = kf + (c + 8 * j + 2 * t) * kFPitch<D>;
#pragma unroll
    for (int rg = 0; rg < G; ++rg)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[rg][j][i] = 0.f;
#pragma unroll
    for (int d = 0; d < D; d += 4) {
      const float4 x0 = ld4(k0 + d), x1 = ld4(k0 + kFPitch<D> + d);
#pragma unroll
      for (int rg = 0; rg < G; ++rg)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float* y = qo[rg][r] + d;
          const float4 yr = make_float4(y[0], y[1], y[2], y[3]);
          s[rg][j][2 * r] = chain4(s[rg][j][2 * r], yr, x0);
          s[rg][j][2 * r + 1] = chain4(s[rg][j][2 * r + 1], yr, x1);
        }
    }
  }
  if (kMasked) fwd_mask<D>(s, key0, row0);
}

// pass 1 of the forward over one step: this thread's share of each row's
// reference maximum m~, of the logits summed on the tensor cores from qa's
// A fragments (one HMMA a 16 x 8 block against the chain's 16 FFMA a
// logit): m~ differs from the chain's maximum by the tensor cores'
// truncation, one fixed shift of the row. The scale is positive, so m~ c
// rounds as max(s c) would
template <int D, bool kMasked>
__device__ __forceinline__ void fwd_bf16_max(const FwdQa<D>& qa,
                                             float (&m)[kFwdGroups<D>][2],
                                             uint32_t ktile, int c, int key0,
                                             int row0) {
  constexpr int G = kFwdGroups<D>, NJ = kFwdStep<D> / 8;
  float s[G][NJ][4];
#pragma unroll
  for (int j2 = 0; j2 < NJ / 2; ++j2) {
#pragma unroll
    for (int rg = 0; rg < G; ++rg)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        s[rg][2 * j2][i] = s[rg][2 * j2 + 1][i] = 0.f;
#pragma unroll
    for (int st = 0; st < kBfSteps<D>; ++st) {
      uint32_t b[4];
      ldsm_along<D>(ktile, c + 16 * j2, st, b);
#pragma unroll
      for (int rg = 0; rg < G; ++rg) {
        mma_bf16(s[rg][2 * j2], qa[rg][st], b[0], b[1]);
        mma_bf16(s[rg][2 * j2 + 1], qa[rg][st], b[2], b[3]);
      }
    }
  }
  if (kMasked) fwd_mask<D>(s, key0, row0);
#pragma unroll
  for (int rg = 0; rg < G; ++rg)
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      m[rg][0] = fmaxf(m[rg][0], fmaxf(s[rg][j][0], s[rg][j][1]));
      m[rg][1] = fmaxf(m[rg][1], fmaxf(s[rg][j][2], s[rg][j][3]));
    }
}

// pass 2 of the forward over one step: p = 2^fma(s, c, -m c) against the
// row's reference maximum (one FFMA and one MUFU.EX2 a logit), the sum of
// p, and p v with p rounded to bf16 as the A operand
template <int D, bool kMasked>
__device__ __forceinline__ void fwd_bf16_step(
    const FwdQ<D>& qo, float (&acc)[kFwdGroups<D>][D / 8][4],
    const float (&mc)[kFwdGroups<D>][2], float (&l)[kFwdGroups<D>][2],
    const float* __restrict__ kf, uint32_t vtile, int c, int key0, int row0,
    float cl2) {
  constexpr int G = kFwdGroups<D>, NJ = kFwdStep<D> / 8;
  float s[G][NJ][4];
  fwd_bf16_logits<D, kMasked>(qo, kf, c, key0, row0, s);
#pragma unroll
  for (int rg = 0; rg < G; ++rg)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = ex2(fmaf(s[rg][j][i], cl2, -mc[rg][i >> 1]));
        l[rg][i >> 1] += p;
        s[rg][j][i] = p;
      }
#pragma unroll
  for (int j2 = 0; j2 < NJ / 2; ++j2) {
    uint32_t pa[G][4];
#pragma unroll
    for (int rg = 0; rg < G; ++rg)
      acc_to_a(s[rg][2 * j2], s[rg][2 * j2 + 1], pa[rg]);
#pragma unroll
    for (int n2 = 0; n2 < (D < 16 ? 1 : D / 16); ++n2) {
      uint32_t b[4];
      ldsm_down<D>(vtile, c + 16 * j2, n2, b);
#pragma unroll
      for (int rg = 0; rg < G; ++rg) {
        mma_bf16(acc[rg][2 * n2], pa[rg], b[0], b[1]);
        if constexpr (D >= 16)
          mma_bf16(acc[rg][2 * n2 + 1], pa[rg], b[2], b[3]);
      }
    }
  }
}

// the forward's blocks: grid (B*H, ceil(L / R)), R = 64 kFwdGroups<D> query
// rows a block; blockIdx.y = 0 is the LAST query block. Its 4 warps own 16
// kFwdGroups<D> rows each. Thread 0 streams the K tiles of kStage keys
// (pass 1), then K and V again (pass 2), through a ring of kStages<D>
// stages, refilling a stage's slot once every warp is past it; the warps
// convert each pass-2 stage's K to floats, a quarter each, as it lands.
// kRefMax: pass 1 only, each row's reference maximum m~ (unscaled)
// written to lse2, so that a check can hold it against the chain's maximum
template <int D, bool kRefMax>
__device__ __forceinline__ void fwd_bf16_blocks(
    const CUtensorMap& tk, const CUtensorMap& tv, const u16* __restrict__ q,
    u16* __restrict__ o, float* __restrict__ lse2, int L, float scale_log2) {
  constexpr int G = kFwdGroups<D>, N8 = D / 8, S = kStages<D>;
  constexpr int TB = BfTile<D>::kBytes, FT = kFTileBytes<D>;
  constexpr int R = 16 * kBfConsumers * G;
  extern __shared__ uint8_t bf_smem[];
  const uint32_t smem0 = smem_u32(bf_smem);
  const uint32_t tiles = (smem0 + 1023u) & ~1023u;
  // the ring's "full" barriers, then the float copies of K
  const uint32_t full = tiles + S * 2 * TB, ftiles = full + 16 * S;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int qb = gridDim.y - 1 - blockIdx.y, h = blockIdx.x;
  // key stages up to the one that holds the block's last row, twice
  const int n_tiles = (min(qb * R + R, L) - 1) / kStage + 1;
  const int total = kRefMax ? n_tiles : 2 * n_tiles;
  // stage i's copies into ring slot i % S, issued by thread 0
  auto issue = [&](int i) {
    const int s = i % S, kt = i < n_tiles ? i : i - n_tiles;
    const uint32_t at = tiles + s * 2 * TB;
    mbar_expect_tx(full + 8 * s, i < n_tiles ? TB : 2 * TB);
    tma_rows<D>(at, &tk, full + 8 * s, kt * kStage, h);
    if (i >= n_tiles)
      tma_rows<D>(at + TB, &tv, full + 8 * s, kt * kStage, h);
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) mbar_init(full + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int i = 0; i < min(S - 1, total); ++i) issue(i);
  }
  __syncthreads();
  // stage i: wait for its copies and convert this warp's quarter of its K
  // into float copy i % 2 (pass 2); past the barrier every warp is done with
  // stage i - 1, whose slot then takes stage i + S - 1
  auto stage = [&](int i, const float*& kf) {
    const int s = i % S;
    const uint32_t at = tiles + s * 2 * TB;
    float* fk =
        reinterpret_cast<float*>(bf_smem + (ftiles + (i & 1) * FT - smem0));
    mbar_wait(full + 8 * s, (i / S) & 1);
    if (i >= n_tiles) tile_to_float<D>(bf_smem + (at - smem0), fk, 16 * warp);
    __syncthreads();
    if (threadIdx.x == 0 && i + S - 1 < total) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      issue(i + S - 1);
    }
    kf = fk;
    return at;
  };
  const int g = lane >> 2, t = lane & 3;
  const int64_t base = static_cast<int64_t>(h) * L * D;
  const int row0 = qb * R + 16 * G * warp, last = row0 + 16 * G - 1;

  float m[G][2];
  {
    FwdQa<D> qa;
    load_fwd_qa<D>(q + base, row0, L, qa);
#pragma unroll
    for (int rg = 0; rg < G; ++rg) m[rg][0] = m[rg][1] = -INFINITY;
    for (int i = 0; i < n_tiles; ++i) {
      const float* kf;
      const uint32_t at = stage(i, kf);
#pragma unroll 1
      for (int c = 0; c < kStage; c += kFwdStep<D>) {
        const int key0 = i * kStage + c;
        if (key0 > last) break;  // every key here is ahead of the warp
        if (key0 + kFwdStep<D> - 1 <= row0)
          fwd_bf16_max<D, false>(qa, m, at, c, key0, row0);
        else
          fwd_bf16_max<D, true>(qa, m, at, c, key0, row0);
      }
    }
  }
  // the rows' maxima across the 4 lanes of a row; key 0 is in every row, so
  // each is finite. Pass 2 rounds p against them: one reference a row, as
  // the plain version rounds against the row's maximum (a running maximum
  // moved the trained prior's dK)
#pragma unroll
  for (int rg = 0; rg < G; ++rg)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float& mr = m[rg][r];
      mr = fmaxf(mr, __shfl_xor_sync(0xffffffffu, mr, 1));
      mr = fmaxf(mr, __shfl_xor_sync(0xffffffffu, mr, 2));
      const int row = row0 + 16 * rg + g + 8 * r;
      if (kRefMax && t == 0 && row < L)
        lse2[static_cast<int64_t>(h) * L + row] = mr;
      mr *= scale_log2;  // m c from here on
    }
  if constexpr (kRefMax) return;

  FwdQ<D> qo;
  load_fwd_q<D>(q + base, row0, L, qo);
  float acc[G][N8][4], l[G][2];
#pragma unroll
  for (int rg = 0; rg < G; ++rg) {
#pragma unroll
    for (int n = 0; n < N8; ++n)
      acc[rg][n][0] = acc[rg][n][1] = acc[rg][n][2] = acc[rg][n][3] = 0.f;
    l[rg][0] = l[rg][1] = 0.f;
  }
  for (int i = n_tiles; i < total; ++i) {
    const float* kf;
    const uint32_t at = stage(i, kf);
#pragma unroll 1
    for (int c = 0; c < kStage; c += kFwdStep<D>) {
      const int key0 = (i - n_tiles) * kStage + c;
      if (key0 > last) break;
      if (key0 + kFwdStep<D> - 1 <= row0)
        fwd_bf16_step<D, false>(qo, acc, m, l, kf, at + TB, c, key0, row0,
                                scale_log2);
      else
        fwd_bf16_step<D, true>(qo, acc, m, l, kf, at + TB, c, key0, row0,
                               scale_log2);
    }
  }

#pragma unroll
  for (int rg = 0; rg < G; ++rg) {
    const int r0 = row0 + 16 * rg + g;
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float lr = l[rg][r];
      lr += __shfl_xor_sync(0xffffffffu, lr, 1);
      lr += __shfl_xor_sync(0xffffffffu, lr, 2);
      inv[r] = 1.f / lr;
      if (t == 0 && r0 + 8 * r < L)
        lse2[static_cast<int64_t>(h) * L + r0 + 8 * r] = m[rg][r] + log2f(lr);
    }
    store_rows_bf16<D>(o + base, acc[rg], r0, r0 + 8, L, inv[0], inv[1]);
  }
}

template <int D>
__global__ void __launch_bounds__(kFThreads, kFwdMinBlocks<D>)
flash_fwd_bf16_kernel(const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const u16* __restrict__ q, u16* __restrict__ o,
                      float* __restrict__ lse2, int L, float scale_log2) {
  fwd_bf16_blocks<D, false>(tk, tv, q, o, lse2, L, scale_log2);
}

// the forward's pass 1 alone: m~ of each row into m (a check's, not the
// port's path)
template <int D>
__global__ void __launch_bounds__(kFThreads, kFwdMinBlocks<D>)
flash_fwd_ref_max_bf16_kernel(const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv,
                              const u16* __restrict__ q, float* __restrict__ m,
                              int L) {
  fwd_bf16_blocks<D, true>(tk, tv, q, nullptr, m, L, 1.f);
}

// the warp's k rows for the logits: keys key0 + 16 kg + g (+8) as floats,
// or (D = 128) as A fragments
template <int D>
using DkvK = std::conditional_t<kDkvFloatK<D>, float[kDkvGroups<D>][2][D],
                                uint32_t[kDkvGroups<D>][kBfSteps<D>][4]>;

// one dK/dV step over the 16 staged queries from tile row c (query index
// qi0) for the warp's kDkvGroups<D> groups of 16 keys from key0: logits and
// dp transposed, p, ds, then dv and dk. The logits' operands: the warp's k
// rows as floats (kr) against the stage's float copy of q (qf), or, at D =
// 128, kr's A fragments against the q tile's fragments (fma_logits).
// kMasked: the step holds a query before some key of the warp, or past L
template <int D, bool kMasked>
__device__ __forceinline__ void dkv_bf16_step(
    const DkvK<D>& kr, const float* __restrict__ qf,
    const uint32_t (&va)[kDkvGroups<D>][kBfSteps<D>][4],
    float (&dka)[kDkvGroups<D>][D / 8][4],
    float (&dva)[kDkvGroups<D>][D / 8][4], uint32_t qtile, uint32_t dotile,
    const float* __restrict__ ls, const float* __restrict__ dis, int c,
    int qi0, int key0, int L, float cl2, float scale) {
  constexpr int G = kDkvGroups<D>;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  // lse2 and di * scale of this thread's queries c + 8j + 2t (+1), once a
  // step
  float lq[2][2], dq[2][2];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      lq[j][e] = ls[c + 8 * j + 2 * t + e];
      dq[j][e] = dis[c + 8 * j + 2 * t + e] * scale;
    }
  // s[kg][j], dp[kg][j]: keys key0 + 16 kg + g (+8) by queries qi0 + 8j +
  // 2t (+1)
  float s[G][2][4], dp[G][2][4];
#pragma unroll
  for (int kg = 0; kg < G; ++kg)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[kg][j][i] = dp[kg][j][i] = 0.f;
  if constexpr (kDkvFloatK<D>) {
    // per 4 d: 4 LDS.128 of q rows (c + 8j + 2t + e), 4 of k rows (16 kg +
    // g + 8r), 64 FFMA
#pragma unroll
    for (int d = 0; d < D; d += 4) {
      float4 y[2][2];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          y[j][e] = ld4(qf + (c + 8 * j + 2 * t + e) * kFPitch<D> + d);
#pragma unroll
      for (int kg = 0; kg < G; ++kg)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float* k4 = kr[kg][r] + d;
          const float4 x = make_float4(k4[0], k4[1], k4[2], k4[3]);
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              s[kg][j][2 * r + e] = chain4(s[kg][j][2 * r + e], x, y[j][e]);
        }
    }
#pragma unroll
    for (int st = 0; st < kBfSteps<D>; ++st) {
      uint32_t bd[4];
      ldsm_along<D>(dotile, c, st, bd);
#pragma unroll
      for (int kg = 0; kg < G; ++kg) {
        mma_bf16(dp[kg][0], va[kg][st], bd[0], bd[1]);
        mma_bf16(dp[kg][1], va[kg][st], bd[2], bd[3]);
      }
    }
  } else {
#pragma unroll
    for (int st = 0; st < kBfSteps<D>; ++st) {
      uint32_t bq[4], bd[4];
      ldsm_along<D>(qtile, c, st, bq);
      ldsm_along<D>(dotile, c, st, bd);
#pragma unroll
      for (int kg = 0; kg < G; ++kg) {
        fma_logits(s[kg][0], s[kg][1], kr[kg][st], bq);
        mma_bf16(dp[kg][0], va[kg][st], bd[0], bd[1]);
        mma_bf16(dp[kg][1], va[kg][st], bd[2], bd[3]);
      }
    }
  }
  uint32_t pa[G][4], da[G][4];
#pragma unroll
  for (int kg = 0; kg < G; ++kg) {
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int e = i & 1;
        float p = ex2(fmaf(s[kg][j][i], cl2, -lq[j][e]));
        if (kMasked) {
          const int qi = qi0 + 8 * j + 2 * t + e;
          if (qi < key0 + 16 * kg + g + 8 * (i >> 1) || qi >= L) p = 0.f;
        }
        s[kg][j][i] = p;
        dp[kg][j][i] = p * fmaf(dp[kg][j][i], scale, -dq[j][e]);
      }
    // p^T and ds^T as A operands: k = 2t (+1) of each 8 queries
    acc_to_a(s[kg][0], s[kg][1], pa[kg]);
    acc_to_a(dp[kg][0], dp[kg][1], da[kg]);
  }
#pragma unroll
  for (int n2 = 0; n2 < (D < 16 ? 1 : D / 16); ++n2) {
    uint32_t bd[4], bq[4];
    ldsm_down<D>(dotile, c, n2, bd);
    ldsm_down<D>(qtile, c, n2, bq);
#pragma unroll
    for (int kg = 0; kg < G; ++kg) {
      mma_bf16(dva[kg][2 * n2], pa[kg], bd[0], bd[1]);
      mma_bf16(dka[kg][2 * n2], da[kg], bq[0], bq[1]);
      if constexpr (D >= 16) {
        mma_bf16(dva[kg][2 * n2 + 1], pa[kg], bd[2], bd[3]);
        mma_bf16(dka[kg][2 * n2 + 1], da[kg], bq[2], bq[3]);
      }
    }
  }
}

// grid (B*H, ceil(L / R)), R = 64 kDkvGroups<D> keys a block; blockIdx.y =
// 0 is the FIRST key block, which sees every query. Its 4 warps own 16
// kDkvGroups<D> keys each. Thread 0 streams q, do, lse2 and di stages of
// kStage queries from the block's first key on, refilling a stage's slot
// once every warp is past it; up to D = 64 the warps convert each stage's
// q to floats, a quarter each, as it lands
template <int D>
__global__ void __launch_bounds__(kFThreads, kDkvMinBlocks<D>)
flash_bwd_dkv_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tdo,
                          const __grid_constant__ CUtensorMap tlse,
                          const __grid_constant__ CUtensorMap tdi,
                          const u16* __restrict__ k, const u16* __restrict__ v,
                          u16* __restrict__ dk, u16* __restrict__ dv, int L,
                          float scale_log2, float scale) {
  constexpr int G = kDkvGroups<D>, N8 = D / 8, S = kStages<D>;
  constexpr int TB = BfTile<D>::kBytes, FT = kFTileBytes<D>;
  constexpr int R = 16 * kBfConsumers * G;
  extern __shared__ uint8_t bf_smem[];
  const uint32_t smem0 = smem_u32(bf_smem);
  const uint32_t tiles = (smem0 + 1023u) & ~1023u;
  const uint32_t vecs = tiles + S * 2 * TB;  // lse2 then di, a stage each
  // the ring's "full" barriers, then the float copies of q
  const uint32_t full = vecs + S * 8 * kVecPitch, ftiles = full + 16 * S;
  const float* vec_ptr =
      reinterpret_cast<const float*>(bf_smem + (vecs - smem0));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int h = blockIdx.x, q_first = blockIdx.y * R;
  const int n_tiles = (L - q_first + kStage - 1) / kStage;
  // the vector boxes start at element h L + q0 - off (q0 % 4 == 0)
  const int off = (h * L) & 3;
  // stage i's copies into ring slot i % S, issued by thread 0
  auto issue = [&](int i) {
    const int s = i % S, q0 = q_first + i * kStage;
    const uint32_t at = tiles + s * 2 * TB, vat = vecs + s * 8 * kVecPitch;
    mbar_expect_tx(full + 8 * s, 2 * TB + 8 * kVecBox);
    tma_rows<D>(at, &tq, full + 8 * s, q0, h);
    tma_rows<D>(at + TB, &tdo, full + 8 * s, q0, h);
    // (bh L,) vectors: past L come the next head's values, masked
    tma_1d(vat, &tlse, full + 8 * s, h * L + q0 - off);
    tma_1d(vat + 4 * kVecPitch, &tdi, full + 8 * s, h * L + q0 - off);
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) mbar_init(full + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int i = 0; i < min(S - 1, n_tiles); ++i) issue(i);
  }
  __syncthreads();
  const int g = lane >> 2;
  const int64_t base = static_cast<int64_t>(h) * L * D;
  const int key0 = q_first + 16 * G * warp, key_last = key0 + 16 * G - 1;

  // the warp's k rows (the logits) and v rows (dp: A fragments)
  DkvK<D> kr;
  uint32_t va[G][kBfSteps<D>][4];
#pragma unroll
  for (int kg = 0; kg < G; ++kg) {
    const int c0 = key0 + 16 * kg + g;
    if constexpr (kDkvFloatK<D>) {
      row_to_float<D>(k + base, c0, L, kr[kg][0]);
      row_to_float<D>(k + base, c0 + 8, L, kr[kg][1]);
    } else {
      load_a_bf16<D>(k + base, c0, c0 + 8, L, kr[kg]);
    }
    load_a_bf16<D>(v + base, c0, c0 + 8, L, va[kg]);
  }
  float dka[G][N8][4], dva[G][N8][4];
#pragma unroll
  for (int kg = 0; kg < G; ++kg)
#pragma unroll
    for (int n = 0; n < N8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) dka[kg][n][i] = dva[kg][n][i] = 0.f;

  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % S, q0 = q_first + i * kStage;
    const uint32_t at = tiles + s * 2 * TB;
    const float* ls = vec_ptr + s * 2 * kVecPitch + off;
    const float* dis = ls + kVecPitch;
    float* qf =
        reinterpret_cast<float*>(bf_smem + (ftiles + (i & 1) * FT - smem0));
    mbar_wait(full + 8 * s, (i / S) & 1);
    if constexpr (kDkvFloatK<D>)
      tile_to_float<D>(bf_smem + (at - smem0), qf, 16 * warp);
    // past the barrier every warp is done with stage i - 1, whose slot
    // then takes stage i + S - 1, and q's float copy i % 2 is complete
    __syncthreads();
    if (threadIdx.x == 0 && i + S - 1 < n_tiles) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      issue(i + S - 1);
    }
    if (D <= 32 && q0 >= key_last && q0 + kStage <= L) {
      // every query of the stage sees every key of the warp: the four
      // steps unrolled, no mask (at D >= 64 the products dominate, and
      // the unrolled steps would spill)
#pragma unroll
      for (int c = 0; c < kStage; c += 16)
        dkv_bf16_step<D, false>(kr, qf, va, dka, dva, at, at + TB, ls, dis,
                                c, q0 + c, key0, L, scale_log2, scale);
    } else {
#pragma unroll 1
      for (int c = 0; c < kStage; c += 16) {
        const int qi0 = q0 + c;
        if (qi0 >= L) break;
        if (qi0 + 15 < key0) continue;  // every query before every key
        if (qi0 >= key_last && qi0 + 16 <= L)
          dkv_bf16_step<D, false>(kr, qf, va, dka, dva, at, at + TB, ls,
                                  dis, c, qi0, key0, L, scale_log2, scale);
        else
          dkv_bf16_step<D, true>(kr, qf, va, dka, dva, at, at + TB, ls, dis,
                                 c, qi0, key0, L, scale_log2, scale);
      }
    }
  }
#pragma unroll
  for (int kg = 0; kg < G; ++kg) {
    const int c0 = key0 + 16 * kg + g;
    store_rows_bf16<D>(dk + base, dka[kg], c0, c0 + 8, L, 1.f, 1.f);
    store_rows_bf16<D>(dv + base, dva[kg], c0, c0 + 8, L, 1.f, 1.f);
  }
}

// the warp's q rows for the logits: rows row0 + 16 rg + g (+8) as floats,
// or (where kDqFloatQ is false) as A fragments
template <int D>
using DqQ = std::conditional_t<kDqFloatQ<D>, float[kDqGroups<D>][2][D],
                               uint32_t[kDqGroups<D>][kBfSteps<D>][4]>;

// one dQ step over the 16 staged keys from tile row c (key index key0) for
// the warp's kDqGroups<D> groups of 16 rows from row0: the logits and dp, p,
// ds, then dq += ds K from the same K tile. The logits' operands: the q rows
// as floats (qr) against the stage's float copy of K (kf), or qr's A
// fragments against the K tile's fragments (fma_logits). kMasked: the step
// holds a key past some row of the warp (the diagonal; every key past L is
// past every row before L)
template <int D, bool kMasked>
__device__ __forceinline__ void dq_bf16_step(
    const DqQ<D>& qr, const float* __restrict__ kf,
    const uint32_t (&da)[kDqGroups<D>][kBfSteps<D>][4],
    const float (&lr)[kDqGroups<D>][2], const float (&dis)[kDqGroups<D>][2],
    float (&dqa)[kDqGroups<D>][D / 8][4], uint32_t ktile, uint32_t vtile,
    int c, int key0, int row0, float cl2, float scale) {
  constexpr int G = kDqGroups<D>;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  // s[rg][j], dp[rg][j]: rows row0 + 16 rg + g (+8) by keys key0 + 8j + 2t
  // (+1)
  float s[G][2][4], dp[G][2][4];
#pragma unroll
  for (int rg = 0; rg < G; ++rg)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[rg][j][i] = dp[rg][j][i] = 0.f;
  if constexpr (kDqFloatQ<D>) {
    // per 4 d: 4 LDS.128 of key rows (c + 8j + 2t + e), 32 G FFMA
#pragma unroll
    for (int d = 0; d < D; d += 4) {
      float4 x[2][2];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          x[j][e] = ld4(kf + (c + 8 * j + 2 * t + e) * kFPitch<D> + d);
#pragma unroll
      for (int rg = 0; rg < G; ++rg)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float* q4 = qr[rg][r] + d;
          const float4 y = make_float4(q4[0], q4[1], q4[2], q4[3]);
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              s[rg][j][2 * r + e] = chain4(s[rg][j][2 * r + e], y, x[j][e]);
        }
    }
#pragma unroll
    for (int st = 0; st < kBfSteps<D>; ++st) {
      uint32_t bv[4];
      ldsm_along<D>(vtile, c, st, bv);
#pragma unroll
      for (int rg = 0; rg < G; ++rg) {
        mma_bf16(dp[rg][0], da[rg][st], bv[0], bv[1]);
        mma_bf16(dp[rg][1], da[rg][st], bv[2], bv[3]);
      }
    }
  } else {
#pragma unroll
    for (int st = 0; st < kBfSteps<D>; ++st) {
      uint32_t bk[4], bv[4];
      ldsm_along<D>(ktile, c, st, bk);
      ldsm_along<D>(vtile, c, st, bv);
#pragma unroll
      for (int rg = 0; rg < G; ++rg) {
        fma_logits(s[rg][0], s[rg][1], qr[rg][st], bk);
        mma_bf16(dp[rg][0], da[rg][st], bv[0], bv[1]);
        mma_bf16(dp[rg][1], da[rg][st], bv[2], bv[3]);
      }
    }
  }
  uint32_t dsa[G][4];
#pragma unroll
  for (int rg = 0; rg < G; ++rg) {
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = i >> 1;
        float p = ex2(fmaf(s[rg][j][i], cl2, -lr[rg][r]));
        if (kMasked &&
            key0 + 8 * j + 2 * t + (i & 1) > row0 + 16 * rg + g + 8 * r)
          p = 0.f;
        dp[rg][j][i] = p * fmaf(dp[rg][j][i], scale, -dis[rg][r]);
      }
    // ds as the A operand: k = 2t (+1) of each 8 keys
    acc_to_a(dp[rg][0], dp[rg][1], dsa[rg]);
  }
#pragma unroll
  for (int n2 = 0; n2 < (D < 16 ? 1 : D / 16); ++n2) {
    uint32_t b[4];
    ldsm_down<D>(ktile, c, n2, b);
#pragma unroll
    for (int rg = 0; rg < G; ++rg) {
      mma_bf16(dqa[rg][2 * n2], dsa[rg], b[0], b[1]);
      if constexpr (D >= 16)
        mma_bf16(dqa[rg][2 * n2 + 1], dsa[rg], b[2], b[3]);
    }
  }
}

// grid (B*H, ceil(L / R)), R = 64 kDqGroups<D> query rows a block;
// blockIdx.y = 0 is the LAST query block. Its 4 warps own 16 kDqGroups<D>
// rows each. Thread 0 streams K and V stages of kStage keys up to the one
// that holds the block's last row through a ring of kStages<D> stages,
// refilling a stage's slot once every warp is past it; where kDqFloatQ the
// warps convert each stage's K to floats, a quarter each, as it lands
template <int D>
__global__ void __launch_bounds__(kFThreads, kDqMinBlocks<D>)
flash_bwd_dq_bf16_kernel(const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const u16* __restrict__ q,
                         const u16* __restrict__ dout,
                         const float* __restrict__ lse2,
                         const float* __restrict__ di, u16* __restrict__ dq,
                         int L, float scale_log2, float scale) {
  constexpr int G = kDqGroups<D>, N8 = D / 8, S = kStages<D>;
  constexpr int TB = BfTile<D>::kBytes, FT = kFTileBytes<D>;
  constexpr int R = 16 * kBfConsumers * G;
  extern __shared__ uint8_t bf_smem[];
  const uint32_t smem0 = smem_u32(bf_smem);
  const uint32_t tiles = (smem0 + 1023u) & ~1023u;
  // the ring's "full" barriers, then the float copies of K
  const uint32_t full = tiles + S * 2 * TB, ftiles = full + 16 * S;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int qb = gridDim.y - 1 - blockIdx.y, h = blockIdx.x;
  const int n_tiles = (min(qb * R + R, L) - 1) / kStage + 1;
  // stage i's copies into ring slot i % S, issued by thread 0
  auto issue = [&](int i) {
    const int s = i % S;
    const uint32_t at = tiles + s * 2 * TB;
    mbar_expect_tx(full + 8 * s, 2 * TB);
    tma_rows<D>(at, &tk, full + 8 * s, i * kStage, h);
    tma_rows<D>(at + TB, &tv, full + 8 * s, i * kStage, h);
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) mbar_init(full + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int i = 0; i < min(S - 1, n_tiles); ++i) issue(i);
  }
  __syncthreads();
  const int g = lane >> 2;
  const int64_t base = static_cast<int64_t>(h) * L * D;
  const int64_t lbase = static_cast<int64_t>(h) * L;
  const int row0 = qb * R + 16 * G * warp;
  // the warp's last row before L; -1 when every row is past L (no work)
  const int last = row0 < L ? min(row0 + 16 * G, L) - 1 : -1;

  // the warp's q (logits) and do (dp: A fragments) rows, and each row's
  // lse2 and di * scale, once
  DqQ<D> qr;
  uint32_t da[G][kBfSteps<D>][4];
  float lr[G][2], dis[G][2];
#pragma unroll
  for (int rg = 0; rg < G; ++rg) {
    const int r0 = row0 + 16 * rg + g;
    if constexpr (kDqFloatQ<D>) {
      row_to_float<D>(q + base, r0, L, qr[rg][0]);
      row_to_float<D>(q + base, r0 + 8, L, qr[rg][1]);
    } else {
      load_a_bf16<D>(q + base, r0, r0 + 8, L, qr[rg]);
    }
    load_a_bf16<D>(dout + base, r0, r0 + 8, L, da[rg]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const bool in = r0 + 8 * r < L;
      lr[rg][r] = in ? lse2[lbase + r0 + 8 * r] : 0.f;
      dis[rg][r] = in ? di[lbase + r0 + 8 * r] * scale : 0.f;
    }
  }
  float dqa[G][N8][4];
#pragma unroll
  for (int rg = 0; rg < G; ++rg)
#pragma unroll
    for (int n = 0; n < N8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) dqa[rg][n][i] = 0.f;

  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % S, k0 = i * kStage;
    const uint32_t at = tiles + s * 2 * TB;
    float* kf =
        reinterpret_cast<float*>(bf_smem + (ftiles + (i & 1) * FT - smem0));
    mbar_wait(full + 8 * s, (i / S) & 1);
    if constexpr (kDqFloatQ<D>)
      tile_to_float<D>(bf_smem + (at - smem0), kf, 16 * warp);
    // past the barrier every warp is done with stage i - 1, whose slot
    // then takes stage i + S - 1, and K's float copy i % 2 is complete
    __syncthreads();
    if (threadIdx.x == 0 && i + S - 1 < n_tiles) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      issue(i + S - 1);
    }
    if (D <= 32 && k0 + kStage - 1 <= row0 && row0 <= last) {
      // every key of the stage precedes every row of the warp: the four
      // steps unrolled, no mask
#pragma unroll
      for (int c = 0; c < kStage; c += 16)
        dq_bf16_step<D, false>(qr, kf, da, lr, dis, dqa, at, at + TB, c,
                               k0 + c, row0, scale_log2, scale);
    } else {
#pragma unroll 1
      for (int c = 0; c < kStage; c += 16) {
        const int key0 = k0 + c;
        if (key0 > last) break;  // every key here is ahead of the warp
        if (key0 + 15 <= row0)
          dq_bf16_step<D, false>(qr, kf, da, lr, dis, dqa, at, at + TB, c,
                                 key0, row0, scale_log2, scale);
        else
          dq_bf16_step<D, true>(qr, kf, da, lr, dis, dqa, at, at + TB, c,
                                key0, row0, scale_log2, scale);
      }
    }
  }
#pragma unroll
  for (int rg = 0; rg < G; ++rg) {
    const int r0 = row0 + 16 * rg + g;
    store_rows_bf16<D>(dq + base, dqa[rg], r0, r0 + 8, L, 1.f, 1.f);
  }
}

// ---------------------------------------------------------------------------
// host: tensor maps for the TMA copies
// ---------------------------------------------------------------------------

// cuTensorMapEncodeTiled, fetched from the driver through the runtime (the
// library links no libcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &res);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &res);
#endif
    if (err == cudaSuccess && res == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a (bh, L, D) bf16 tensor in boxes of (kBox / 2 columns, kStage rows, one
// head), swizzled as BfTile<D> reads them; rows past L read as zeros
template <int D>
inline int rows_map(CUtensorMap* map, const void* ptr, int bh, int L) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return static_cast<int>(cudaErrorNotSupported);
  constexpr int kBox = BfTile<D>::kBox;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(L),
                              static_cast<cuuint64_t>(bh)};
  const cuuint64_t strides[2] = {2ull * D, 2ull * D * L};
  const cuuint32_t box[3] = {kBox / 2, kStage, 1}, one[3] = {1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      kBox == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
      : kBox == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
      : kBox == 32 ? CU_TENSOR_MAP_SWIZZLE_32B
                   : CU_TENSOR_MAP_SWIZZLE_NONE;
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                         const_cast<void*>(ptr), dims, strides, box, one,
                         CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// a (bh, L) float32 tensor as one vector of bh L in boxes of kVecBox (a
// row stride of 4L bytes need not be a multiple of 16, which a 2-D map
// asks)
inline int vec_map(CUtensorMap* map, const float* ptr, int bh, int L) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[1] = {static_cast<cuuint64_t>(bh) * L};
  const cuuint64_t strides[1] = {4};  // unused at rank 1
  const cuuint32_t box[1] = {kVecBox}, one[1] = {1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1,
                         const_cast<float*>(ptr), dims, strides, box, one,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_NONE,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

inline dim3 bf_grid(int bh, int L, int rows) {
  return dim3(static_cast<unsigned>(bh),
              static_cast<unsigned>((L + rows - 1) / rows));
}

}  // namespace

// C interface of the bf16 instances: q, k, v, o, do, dq, dk, dv contiguous
// bf16 (bh, L, d), 16-byte aligned; lse2 and di float32 (bh, L). Otherwise
// as the float32 functions above; the dK/dV kernel also needs bh L < 2^31
// (its lse2 and di copies index the flat vectors with 32-bit coordinates).
extern "C" int movae_flash_bf16_fwd(const void* q, const void* k,
                                    const void* v, void* o, float* lse2,
                                    int bh, int L, int d, float scale,
                                    int device, void* stream) {
  int err = prologue(bh, L, d, device);
  if (err != 0) return err;
  CUtensorMap tk, tv;
  if ((err = rows_map<kD>(&tk, k, bh, L)) != 0) return err;
  if ((err = rows_map<kD>(&tv, v, bh, L)) != 0) return err;
  constexpr int smem = fwd_bf16_f_smem<kD>();
  err = allow_smem(flash_fwd_bf16_kernel<kD>, smem);
  if (err != 0) return err;
  flash_fwd_bf16_kernel<kD>
      <<<bf_grid(bh, L, 16 * kBfConsumers * kFwdGroups<kD>), kFThreads, smem,
         static_cast<cudaStream_t>(stream)>>>(
          tk, tv, static_cast<const u16*>(q), static_cast<u16*>(o), lse2, L,
          scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

// the bf16 forward's reference maximum m~ of each row's raw logits (its
// pass 1, run alone) into m, float32 (bh, L): for a check that holds it
// against the maximum of the logit chain. Not on the port's path
extern "C" int movae_flash_bf16_fwd_ref_max(const void* q, const void* k,
                                            const void* v, float* m, int bh,
                                            int L, int d, int device,
                                            void* stream) {
  int err = prologue(bh, L, d, device);
  if (err != 0) return err;
  CUtensorMap tk, tv;
  if ((err = rows_map<kD>(&tk, k, bh, L)) != 0) return err;
  if ((err = rows_map<kD>(&tv, v, bh, L)) != 0) return err;
  constexpr int smem = fwd_bf16_f_smem<kD>();
  err = allow_smem(flash_fwd_ref_max_bf16_kernel<kD>, smem);
  if (err != 0) return err;
  flash_fwd_ref_max_bf16_kernel<kD>
      <<<bf_grid(bh, L, 16 * kBfConsumers * kFwdGroups<kD>), kFThreads, smem,
         static_cast<cudaStream_t>(stream)>>>(
          tk, tv, static_cast<const u16*>(q), m, L);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int movae_flash_bf16_bwd_dkv(const void* q, const void* k,
                                        const void* v, const void* dout,
                                        const float* lse2, const float* di,
                                        void* dk, void* dv, int bh, int L,
                                        int d, float scale, int device,
                                        void* stream) {
  int err = prologue(bh, L, d, device);
  if (err != 0) return err;
  if (static_cast<int64_t>(bh) * L > 2147483647 - kStage)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tq, tdo, tlse, tdi;
  if ((err = rows_map<kD>(&tq, q, bh, L)) != 0) return err;
  if ((err = rows_map<kD>(&tdo, dout, bh, L)) != 0) return err;
  if ((err = vec_map(&tlse, lse2, bh, L)) != 0) return err;
  if ((err = vec_map(&tdi, di, bh, L)) != 0) return err;
  constexpr int smem = dkv_bf16_f_smem<kD>();
  err = allow_smem(flash_bwd_dkv_bf16_kernel<kD>, smem);
  if (err != 0) return err;
  flash_bwd_dkv_bf16_kernel<kD>
      <<<bf_grid(bh, L, 16 * kBfConsumers * kDkvGroups<kD>), kFThreads,
         smem, static_cast<cudaStream_t>(stream)>>>(
          tq, tdo, tlse, tdi, static_cast<const u16*>(k),
          static_cast<const u16*>(v), static_cast<u16*>(dk),
          static_cast<u16*>(dv), L, scale * kLog2e, scale);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int movae_flash_bf16_bwd_dq(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const float* lse2, const float* di,
                                       void* dq, int bh, int L, int d,
                                       float scale, int device, void* stream) {
  int err = prologue(bh, L, d, device);
  if (err != 0) return err;
  CUtensorMap tk, tv;
  if ((err = rows_map<kD>(&tk, k, bh, L)) != 0) return err;
  if ((err = rows_map<kD>(&tv, v, bh, L)) != 0) return err;
  constexpr int smem = dq_bf16_f_smem<kD>();
  err = allow_smem(flash_bwd_dq_bf16_kernel<kD>, smem);
  if (err != 0) return err;
  flash_bwd_dq_bf16_kernel<kD>
      <<<bf_grid(bh, L, 16 * kBfConsumers * kDqGroups<kD>), kFThreads, smem,
         static_cast<cudaStream_t>(stream)>>>(
          tk, tv, static_cast<const u16*>(q), static_cast<const u16*>(dout),
          lse2, di, static_cast<u16*>(dq), L, scale * kLog2e, scale);
  return static_cast<int>(cudaGetLastError());
}
