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
// Registers at D=16 (ptxas, sm_90a): forward 118, dK/dV 127, dQ 128 (all
// under __launch_bounds__(128, 4)), none spilling; at D=32 180, 239 and
// 244, none spilling; at D >= 64 all but the forward at D=64 spill.
// chip_smoke.py prints the registers and spills at every head dim.

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
// The running max and sum and the log-sum-exp (base 2) stay f32.
//
// Bound on an H100 SXM (700 W) at the prior shape B=16, H=8, L=4096, D=16:
// each causal pair needs one exp2 (1.07 G pairs over the MUFU rate, 4.18
// T/s: 0.257 ms in each kernel); the products (2, 4 and 3 a pair at
// 2 * D flops each: 34.4 GFLOP each) over the dense bf16 rate (989 TFLOP/s)
// take 0.07, 0.14 and 0.10 ms, and the bytes (each (B, H, L, D) bf16 tensor
// 16.8 MB) 0.02-0.04 ms. So the exp2 per pair bounds all three at D=16.
//
// Design (a simple one; wgmma and TMA are later work):
//   * the f32 kernels' blocks: 4 warps own 64 rows of the outer dimension,
//     16 a warp, and stream the other side in tiles of 64 rows through
//     shared memory, double buffered with cp.async; rows padded to D + 8
//     bf16 (16 bytes), which keeps the 32-bit fragment loads free of bank
//     conflicts at D >= 16;
//   * every product is mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32:
//     bf16 operands exactly as given, f32 accumulation, one pass. The
//     logits' accumulator layout is the A layout of the next product (p or
//     ds as A: k = 2t, 2t+1 of each 8 columns), so p and ds go from
//     registers to the tensor cores, rounded to bf16 as they are packed;
//   * A operands that stay (q, do in the forward and dQ; k, v in dK/dV) are
//     loaded once from device memory into fragments; B operands come from
//     the staged tiles: as 32-bit pairs where the reduction runs along a
//     staged row (K for the logits, V for dp), as two 16-bit loads where it
//     runs down the rows (V for p.v, do and q for dv and dk, K for dq);
//   * D = 8 is below the mma's depth of 16: the logit and dp products pad
//     the reduction to 16 with zeros in registers (the upper half of each
//     A and B fragment is 0), never reading the staged row's padding;
//   * accumulators run for the whole row (no per-step f32 add): the tensor
//     cores' truncated sums drift by ~1e-5 relative over L = 4096, far under
//     the bf16 rounding of the outputs (2^-9);
//   * masking is element by element (key <= query, query < L) on every
//     step; only whole 8-key blocks past a warp's last row are skipped.
//
// The recompute contract: each logit is one chain of m16n8k16 products over
// the same D/16 reduction steps in the same order, from the same bf16
// values, times scale * log2(e) in f32. The backward kernels' p is the
// forward's p bit for bit (dK/dV swaps the operands of the same exact
// bf16 x bf16 products, which sum position by position alike).

#include <cuda_bf16.h>

namespace {

using u16 = unsigned short;

template <int D>
constexpr int kBfStride = D + 8;  // bf16 a staged row
template <int D>
constexpr int kBfMat = kTile * kBfStride<D>;  // bf16 of one staged tile
template <int D>
constexpr int kBfSteps = D < 16 ? 1 : D / 16;  // k16 steps over D

template <int D>
constexpr int bf_tiles_bytes() {  // 2 double-buffered tiles
  return 4 * kBfMat<D> * static_cast<int>(sizeof(u16));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return (static_cast<uint32_t>(__bfloat16_as_ushort(v.y)) << 16) |
         __bfloat16_as_ushort(v.x);
}

__device__ __forceinline__ uint32_t ld32(const u16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// two bf16 a row apart (rows r and r + 1 of a staged tile) as one operand
// register, the lower row in the low half
template <int S>
__device__ __forceinline__ uint32_t ld_pair(const u16* p) {
  return static_cast<uint32_t>(p[0]) | (static_cast<uint32_t>(p[S]) << 16);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// rows [r0, r0 + kTile) of an (L, D) bf16 matrix into a padded staged tile,
// zeros past L
template <int D>
__device__ __forceinline__ void copy_tile_bf16(const u16* __restrict__ src,
                                               u16* __restrict__ dst, int r0,
                                               int L) {
  constexpr int C = D / 8;  // 16-byte chunks a row
  for (int i = threadIdx.x; i < kTile * C; i += kThreads) {
    const int r = i / C, c = 8 * (i % C);
    const bool in = r0 + r < L;
    cp_async16(reinterpret_cast<float*>(dst + r * kBfStride<D> + c),
               reinterpret_cast<const float*>(
                   src + static_cast<int64_t>(in ? r0 + r : 0) * D + c),
               in);
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

// c += a b^T over D for the 8 staged rows at `row` (b's rows are the
// product's columns: the reduction runs along each staged row)
template <int D>
__device__ __forceinline__ void mma_rows(float (&c)[4],
                                         const uint32_t (&a)[kBfSteps<D>][4],
                                         const u16* __restrict__ row) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const u16* p = row + g * kBfStride<D> + 2 * t;
#pragma unroll
  for (int s = 0; s < kBfSteps<D>; ++s)
    mma_bf16(c, a[s], ld32(p + 16 * s),
             16 * s + 8 < D ? ld32(p + 16 * s + 8) : 0u);
}

// c[n] += a x (16 staged rows from `rows`, columns 8n .. 8n + 7): the
// reduction runs down the staged rows
template <int D>
__device__ __forceinline__ void mma_down(float (&c)[D / 8][4],
                                         const uint32_t (&a)[4],
                                         const u16* __restrict__ rows) {
  constexpr int S = kBfStride<D>;
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const u16* p = rows + 2 * t * S + g;
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
    mma_bf16(c[n], a, ld_pair<S>(p + 8 * n), ld_pair<S>(p + 8 * S + 8 * n));
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

// grid (B*H, ceil(L/64)); blockIdx.y = 0 is the LAST query tile
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_bf16_kernel(const u16* __restrict__ q, const u16* __restrict__ k,
                      const u16* __restrict__ v, u16* __restrict__ o,
                      float* __restrict__ lse2, int L, float scale_log2) {
  constexpr int M = kBfMat<D>, N8 = D / 8;
  extern __shared__ __align__(16) u16 bsmem[];
  u16* ks = bsmem;          // 2 buffers
  u16* vs = bsmem + 2 * M;  // 2 buffers

  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2,
            t = threadIdx.x & 3;
  const int qt = gridDim.y - 1 - blockIdx.y;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * L * D;
  const int warp_first = qt * kTile + 16 * warp;
  const int rows[2] = {warp_first + g, warp_first + g + 8};

  copy_tile_bf16<D>(k + base, ks, 0, L);
  copy_tile_bf16<D>(v + base, vs, 0, L);
  cp_async_commit();

  uint32_t qa[kBfSteps<D>][4];
  load_a_bf16<D>(q + base, rows[0], rows[1], L, qa);
  float acc[N8][4];
#pragma unroll
  for (int n = 0; n < N8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  // key tiles up to the diagonal one (tiles and blocks are both kTile rows)
  for (int kt = 0; kt <= qt; ++kt) {
    const int buf = (kt & 1) * M;
    if (kt < qt) {
      const int next = ((kt + 1) & 1) * M;
      copy_tile_bf16<D>(k + base, ks + next, (kt + 1) * kTile, L);
      copy_tile_bf16<D>(v + base, vs + next, (kt + 1) * kTile, L);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int key0 = kt * kTile;
    // 8-key blocks at or before the warp's last row (an even count)
    const int nb = min(8, (warp_first + 15 - key0) / 8 + 1);
    float s[8][4];
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      if (j < nb) mma_rows<D>(s[j], qa, ks + buf + 8 * j * kBfStride<D>);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = key0 + 8 * j + 2 * t + (i & 1);
        const float x = s[j][i] * scale_log2;
        s[j][i] = j < nb && key <= rows[i >> 1] ? x : -INFINITY;
        mx[i >> 1] = fmaxf(mx[i >> 1], s[j][i]);
      }
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // key 0 is in every row's first tile, so mx is finite from there on
      corr[r] = exp2f(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= corr[r];
    }
#pragma unroll
    for (int n = 0; n < N8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[n][i] *= corr[i >> 1];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[j][i] = exp2f(s[j][i] - m[i >> 1]);
        l[i >> 1] += s[j][i];
      }
    // p v, p rounded to bf16 as the A operand
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (2 * c >= nb) break;
      uint32_t pa[4];
      acc_to_a(s[2 * c], s[2 * c + 1], pa);
      mma_down<D>(acc, pa, vs + buf + 16 * c * kBfStride<D>);
    }
    __syncthreads();  // before tile kt + 2 overwrites this buffer
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = 1.f / l[r];
    if (t == 0 && rows[r] < L)
      lse2[static_cast<int64_t>(blockIdx.x) * L + rows[r]] =
          m[r] + log2f(l[r]);
  }
  store_rows_bf16<D>(o + base, acc, rows[0], rows[1], L, inv[0], inv[1]);
}

// grid (B*H, ceil(L/64)); blockIdx.y = 0 is the FIRST key tile, which sees
// every query tile
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_bf16_kernel(const u16* __restrict__ q, const u16* __restrict__ k,
                          const u16* __restrict__ v,
                          const u16* __restrict__ dout,
                          const float* __restrict__ lse2,
                          const float* __restrict__ di, u16* __restrict__ dk,
                          u16* __restrict__ dv, int L, float scale_log2,
                          float scale) {
  constexpr int M = kBfMat<D>, N8 = D / 8;
  extern __shared__ __align__(16) u16 bsmem[];
  u16* qs = bsmem;           // 2 buffers
  u16* dos = bsmem + 2 * M;  // 2 buffers
  float* ls = reinterpret_cast<float*>(bsmem + 4 * M);  // 2 buffers of kTile
  float* dis = ls + 2 * kTile;                           // 2 buffers of kTile

  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2,
            t = threadIdx.x & 3;
  const int kt = blockIdx.y;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * L * D;
  const int64_t lbase = static_cast<int64_t>(blockIdx.x) * L;
  const int warp_first = kt * kTile + 16 * warp;
  const int cols[2] = {warp_first + g, warp_first + g + 8};
  const int n_tiles = (L - kt * kTile + kTile - 1) / kTile;

  // one query tile (rows t0 .. t0 + 63) of q, do, lse2, di into buffer b
  auto load_tile = [&](int t0, int b) {
    copy_tile_bf16<D>(q + base, qs + b * M, t0, L);
    copy_tile_bf16<D>(dout + base, dos + b * M, t0, L);
    const int r = threadIdx.x % kTile;  // 2 * kTile == kThreads
    const bool in = t0 + r < L;
    const int64_t at = lbase + (in ? t0 + r : 0);
    if (threadIdx.x < kTile)
      cp_async4(ls + b * kTile + r, lse2 + at, in);
    else
      cp_async4(dis + b * kTile + r, di + at, in);
    cp_async_commit();
  };
  load_tile(kt * kTile, 0);

  uint32_t ka[kBfSteps<D>][4], va[kBfSteps<D>][4];
  load_a_bf16<D>(k + base, cols[0], cols[1], L, ka);
  load_a_bf16<D>(v + base, cols[0], cols[1], L, va);
  float dka[N8][4], dva[N8][4];
#pragma unroll
  for (int n = 0; n < N8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) dka[n][i] = dva[n][i] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int t0 = kt * kTile + it * kTile, b = it & 1;
    if (it + 1 < n_tiles) {
      load_tile(t0 + kTile, b ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const u16* qt_ = qs + b * M;
    const u16* dt_ = dos + b * M;
#pragma unroll 1
    for (int c = 0; c < 4; ++c) {
      const int qi0 = t0 + 16 * c;
      if (qi0 >= L) break;
      if (qi0 + 15 < warp_first) continue;  // every query before every key
      // s^T, dp^T: keys (rows g, g+8) by queries qi0 + 8jj + 2t (+1)
      float s[2][4], dp[2][4];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        s[jj][0] = s[jj][1] = s[jj][2] = s[jj][3] = 0.f;
        dp[jj][0] = dp[jj][1] = dp[jj][2] = dp[jj][3] = 0.f;
        mma_rows<D>(s[jj], ka, qt_ + (16 * c + 8 * jj) * kBfStride<D>);
        mma_rows<D>(dp[jj], va, dt_ + (16 * c + 8 * jj) * kBfStride<D>);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = 16 * c + 8 * jj + 2 * t + (i & 1);  // tile row
          const int qi = t0 + r;
          const float p =
              qi >= cols[i >> 1] && qi < L
                  ? exp2f(s[jj][i] * scale_log2 - ls[b * kTile + r])
                  : 0.f;
          s[jj][i] = p;
          dp[jj][i] = (dp[jj][i] - dis[b * kTile + r]) * p * scale;
        }
      }
      uint32_t pa[4], da[4];
      acc_to_a(s[0], s[1], pa);
      acc_to_a(dp[0], dp[1], da);
      mma_down<D>(dva, pa, dt_ + 16 * c * kBfStride<D>);
      mma_down<D>(dka, da, qt_ + 16 * c * kBfStride<D>);
    }
    __syncthreads();  // before tile it + 2 overwrites this buffer
  }
  store_rows_bf16<D>(dk + base, dka, cols[0], cols[1], L, 1.f, 1.f);
  store_rows_bf16<D>(dv + base, dva, cols[0], cols[1], L, 1.f, 1.f);
}

// grid (B*H, ceil(L/64)); blockIdx.y = 0 is the LAST query tile
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_bf16_kernel(const u16* __restrict__ q, const u16* __restrict__ k,
                         const u16* __restrict__ v,
                         const u16* __restrict__ dout,
                         const float* __restrict__ lse2,
                         const float* __restrict__ di, u16* __restrict__ dq,
                         int L, float scale_log2, float scale) {
  constexpr int M = kBfMat<D>, N8 = D / 8;
  extern __shared__ __align__(16) u16 bsmem[];
  u16* ks = bsmem;          // 2 buffers
  u16* vs = bsmem + 2 * M;  // 2 buffers

  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2,
            t = threadIdx.x & 3;
  const int qt = gridDim.y - 1 - blockIdx.y;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * L * D;
  const int64_t lbase = static_cast<int64_t>(blockIdx.x) * L;
  const int warp_first = qt * kTile + 16 * warp;
  const int rows[2] = {warp_first + g, warp_first + g + 8};

  copy_tile_bf16<D>(k + base, ks, 0, L);
  copy_tile_bf16<D>(v + base, vs, 0, L);
  cp_async_commit();

  uint32_t qa[kBfSteps<D>][4], da[kBfSteps<D>][4];
  load_a_bf16<D>(q + base, rows[0], rows[1], L, qa);
  load_a_bf16<D>(dout + base, rows[0], rows[1], L, da);
  float lr[2], dir[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool in = rows[r] < L;
    lr[r] = in ? lse2[lbase + rows[r]] : 0.f;
    dir[r] = in ? di[lbase + rows[r]] : 0.f;
  }
  float dqa[N8][4];
#pragma unroll
  for (int n = 0; n < N8; ++n)
    dqa[n][0] = dqa[n][1] = dqa[n][2] = dqa[n][3] = 0.f;

  for (int kt = 0; kt <= qt; ++kt) {
    const int buf = (kt & 1) * M;
    if (kt < qt) {
      const int next = ((kt + 1) & 1) * M;
      copy_tile_bf16<D>(k + base, ks + next, (kt + 1) * kTile, L);
      copy_tile_bf16<D>(v + base, vs + next, (kt + 1) * kTile, L);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int key0 = kt * kTile;
    const int nb = min(8, (warp_first + 15 - key0) / 8 + 1);
#pragma unroll 1
    for (int c = 0; c < 4; ++c) {
      if (2 * c >= nb) break;
      // s, dp: rows g, g+8 by keys key0 + 16c + 8jj + 2t (+1)
      float s[2][4], dp[2][4];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        s[jj][0] = s[jj][1] = s[jj][2] = s[jj][3] = 0.f;
        dp[jj][0] = dp[jj][1] = dp[jj][2] = dp[jj][3] = 0.f;
        const int off = buf + (16 * c + 8 * jj) * kBfStride<D>;
        mma_rows<D>(s[jj], qa, ks + off);
        mma_rows<D>(dp[jj], da, vs + off);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = i >> 1;
          const int key = key0 + 16 * c + 8 * jj + 2 * t + (i & 1);
          const float p = key <= rows[r] && rows[r] < L
                              ? exp2f(s[jj][i] * scale_log2 - lr[r])
                              : 0.f;
          dp[jj][i] = (dp[jj][i] - dir[r]) * p * scale;
        }
      }
      uint32_t dsa[4];
      acc_to_a(dp[0], dp[1], dsa);
      mma_down<D>(dqa, dsa, ks + buf + 16 * c * kBfStride<D>);
    }
    __syncthreads();  // before tile kt + 2 overwrites this buffer
  }
  store_rows_bf16<D>(dq + base, dqa, rows[0], rows[1], L, 1.f, 1.f);
}

}  // namespace

// C interface of the bf16 instances: q, k, v, o, do, dq, dk, dv contiguous
// bf16 (bh, L, d), 16-byte aligned; lse2 and di float32 (bh, L). Otherwise
// as the float32 functions above.
extern "C" int movae_flash_bf16_fwd(const void* q, const void* k,
                                    const void* v, void* o, float* lse2,
                                    int bh, int L, int d, float scale,
                                    int device, void* stream) {
  int err = prologue(bh, L, d, device);
  if (err != 0) return err;
  constexpr int smem = bf_tiles_bytes<kD>();
  err = allow_smem(flash_fwd_bf16_kernel<kD>, smem);
  if (err != 0) return err;
  flash_fwd_bf16_kernel<kD><<<grid_for(bh, L), kThreads, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const u16*>(q), static_cast<const u16*>(k),
      static_cast<const u16*>(v), static_cast<u16*>(o), lse2, L,
      scale * kLog2e);
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
  constexpr int smem =
      bf_tiles_bytes<kD>() + 4 * kTile * static_cast<int>(sizeof(float));
  err = allow_smem(flash_bwd_dkv_bf16_kernel<kD>, smem);
  if (err != 0) return err;
  flash_bwd_dkv_bf16_kernel<kD><<<grid_for(bh, L), kThreads, smem,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const u16*>(q), static_cast<const u16*>(k),
      static_cast<const u16*>(v), static_cast<const u16*>(dout), lse2, di,
      static_cast<u16*>(dk), static_cast<u16*>(dv), L, scale * kLog2e, scale);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int movae_flash_bf16_bwd_dq(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const float* lse2, const float* di,
                                       void* dq, int bh, int L, int d,
                                       float scale, int device, void* stream) {
  int err = prologue(bh, L, d, device);
  if (err != 0) return err;
  constexpr int smem = bf_tiles_bytes<kD>();
  err = allow_smem(flash_bwd_dq_bf16_kernel<kD>, smem);
  if (err != 0) return err;
  flash_bwd_dq_bf16_kernel<kD><<<grid_for(bh, L), kThreads, smem,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const u16*>(q), static_cast<const u16*>(k),
      static_cast<const u16*>(v), static_cast<const u16*>(dout), lse2, di,
      static_cast<u16*>(dq), L, scale * kLog2e, scale);
  return static_cast<int>(cudaGetLastError());
}
