"""Causal flash attention: the CUDA kernels' wrapper and their plain version.

``flash_causal_attention(q, k, v, sm_scale)`` computes, over (B, H, L, D)
float32 or bfloat16 tensors, ``softmax(q k^T * sm_scale, inclusive causal
mask) v`` (position i attends to 0..i) — the function of the stock Pallas
TPU flash attention that ``movae_tpu/ops/attention.py:causal_attention``
calls for long sequences. A CPU tensor takes the plain PyTorch version; a
CUDA tensor launches ``flash_attention.cu`` (forward; dK/dV then dQ in the
backward), the float32 or the bfloat16 instances by its dtype, or raises.

At bfloat16 the kernels compute what the stock Pallas kernel computes on
bf16 inputs: products of bf16 values summed in float32, the logits scaled
in float32, p and ds rounded to bf16 before their products, outputs in
bf16; the softmax statistics and di stay float32. The plain version rounds
at the same points and computes p and ds as the kernels do, in base 2 with
one float32 fma each (:func:`flash_causal_attention_plain`). It sums its
products in IEEE float32; asked with ``tensor_cores=True``, on the card it
sums them as the kernels do: the logits as one float32 fma chain over d
ascending, every other product on the tensor cores.
"""

from __future__ import annotations

import ctypes
import math
from typing import Callable, Optional

import torch

from movae_tpu_torch.kernels import LAUNCH_COUNTS
from movae_tpu_torch.kernels import build

Tensor = torch.Tensor
SUPPORTED_DIMS = build.FLASH_HEAD_DIMS  # one library each
_INT32_MAX = 2 ** 31 - 1
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
DTYPES = (torch.float32, torch.bfloat16)
_SIGNATURES = {
    # q, k, v, o, lse2, bh, L, d, scale, device, stream
    "movae_flash_fwd": [_P] * 5 + [_I] * 3 + [_F, _I, _P],
    # q, k, v, do, lse2, di, dk, dv, bh, L, d, scale, device, stream
    "movae_flash_bwd_dkv": [_P] * 8 + [_I] * 3 + [_F, _I, _P],
    # q, k, v, do, lse2, di, dq, bh, L, d, scale, device, stream
    "movae_flash_bwd_dq": [_P] * 7 + [_I] * 3 + [_F, _I, _P],
}
# the bfloat16 instances take the same arguments
_SIGNATURES.update({name.replace("movae_flash_", "movae_flash_bf16_"): sig
                    for name, sig in list(_SIGNATURES.items())})
# bfloat16 plain version: rows of B computed at a time, so that the L x L
# float32 intermediates of the prior's shape stay a few GB
_PLAIN_CHUNK = 8
LOG2E = 1.4426950408889634
_TINY = 2.0 ** -126  # ex2.approx.ftz flushes results below it to 0


def dense_causal_attention(
        q: Tensor, k: Tensor, v: Tensor, sm_scale: float,
        weights_fn: Optional[Callable[[Tensor], Tensor]] = None) -> Tensor:
    """The dense masked softmax in plain PyTorch, in the inputs' dtype (the
    L x L logits are materialized), as ``movae_tpu/ops/attention.py:
    dense_causal_attention``. ``weights_fn`` maps the (B, H, L, L)
    attention weights before they meet v (the prior's attention-weight
    dropout)."""
    L = q.shape[2]
    logits = torch.matmul(q, k.transpose(-1, -2)) * sm_scale
    mask = torch.ones((L, L), dtype=torch.bool, device=q.device).tril()
    weights = torch.softmax(logits.masked_fill(~mask, float("-inf")), dim=-1)
    if weights_fn is not None:
        weights = weights_fn(weights)
    return torch.matmul(weights, v)


def _mm(a: Tensor, b: Tensor, tensor_cores: bool = False) -> Tensor:
    """a @ b in float32, for (..., m, k) and (..., k, n) operands of one
    batch shape, summed in IEEE float32. With ``tensor_cores`` and operands
    on the card, the operands, which must hold bf16 values, go through
    cuBLAS's bf16 GEMM with a float32 output instead: summed on the tensor
    cores as the kernels' HMMA sums them (on a trained prior's sharp rows
    the order of the logits' sum moves p's bf16 roundings)."""
    if tensor_cores and a.is_cuda:
        sa, sb = a.shape, b.shape
        out = torch.bmm(a.to(torch.bfloat16).reshape(-1, *sa[-2:]),
                        b.to(torch.bfloat16).reshape(-1, *sb[-2:]),
                        out_dtype=torch.float32)
        return out.reshape(*sa[:-1], sb[-1])
    return torch.matmul(a.float(), b.float())


def fma_chain_logits(q: Tensor, k: Tensor) -> Tensor:
    """q k^T for (..., L, D) bf16-valued q, k as the bf16 kernels sum each
    logit: one float32 fma chain over d ascending from 0 (each step's exact
    product and sum in float64, rounded once to float32, as
    :func:`fma_f32`), a leading slice at a time."""
    out = torch.empty((*q.shape[:-1], k.shape[-2]), dtype=torch.float32,
                      device=q.device)
    qf, kf = q.double(), k.double()
    for i in range(out.shape[0]):
        acc = torch.zeros(out.shape[1:], dtype=torch.float32,
                          device=q.device)
        for d in range(q.shape[-1]):
            acc = (qf[i, ..., d, None] * kf[i, ..., None, :, d]
                   + acc.double()).float()
        out[i] = acc
    return out


def _plain_logits(q: Tensor, k: Tensor, tensor_cores: bool = False
                  ) -> Tensor:
    """The raw float32 logits q k^T from bf16 q, k, the causal mask as
    -inf: IEEE float32 sums, or with ``tensor_cores`` on the card the
    kernels' fma chain (:func:`fma_chain_logits`)."""
    L = q.shape[2]
    if tensor_cores and q.is_cuda:
        s = fma_chain_logits(q, k)
    else:
        s = _mm(q, k.transpose(-1, -2))
    mask = torch.ones((L, L), dtype=torch.bool, device=q.device).tril()
    return s.masked_fill(~mask, float("-inf"))


def _bf(x: Tensor) -> Tensor:
    """x rounded to bfloat16, back in float32 for the product it feeds."""
    return x.to(torch.bfloat16).float()


def log2e_scale(sm_scale: float) -> float:
    """The kernels' ``scale * kLog2e``: one float32 product (returned as the
    Python float of that float32 value)."""
    return float(torch.tensor(sm_scale, dtype=torch.float32)
                 * torch.tensor(LOG2E, dtype=torch.float32))


def _f32(x: float) -> float:
    return float(torch.tensor(x, dtype=torch.float32))


def fma_f32(a: Tensor, b: float, c: Tensor) -> Tensor:
    """float32 ``fmaf(a, b, c)`` for float32 a, c and a float32 value b: the
    product of two floats is exact in float64, so one float64 product and
    sum rounded once to float32 is the fma. Computed a leading slice at a
    time, to keep the float64 temporaries small."""
    out = torch.empty(torch.broadcast_shapes(a.shape, c.shape),
                      dtype=torch.float32, device=a.device)
    c = c.expand(out.shape)
    for i in range(out.shape[0]):
        out[i] = (a[i].double() * b + c[i].double()).float()
    return out


def ex2_ftz(x: Tensor) -> Tensor:
    """The kernels' ``ex2.approx.ftz.f32``, exactly rounded: 2^x with
    results below 2^-126 flushed to 0."""
    p = torch.exp2(x)
    return p.masked_fill(p < _TINY, 0.0)


def plain_p_bf16(s: Tensor, c: float, shift: Tensor) -> Tensor:
    """p = 2^fma(s, c, -shift) from the raw logits ``s`` (-inf where
    masked), c = :func:`log2e_scale` and a (..., L, 1) float32 ``shift``
    (the row maximum of s c in the forward, lse2 in the backward), as the
    bf16 kernels compute it; unrounded float32."""
    return ex2_ftz(fma_f32(s, c, -shift))


def plain_ds_bf16(p: Tensor, dp: Tensor, di: Tensor, sm_scale: float
                  ) -> Tensor:
    """ds = bf16(p fma(dp, scale, -di scale)), di scale one float32
    product, as both bf16 backward kernels compute it (float32 holding the
    bf16 values)."""
    sc = _f32(sm_scale)
    return _bf(p * fma_f32(dp, sc, -(di * sc)))


def plain_fwd_bf16(q: Tensor, k: Tensor, v: Tensor, sm_scale: float,
                   tensor_cores: bool = False):
    """The bf16 forward kernel's arithmetic in plain PyTorch, in base 2:
    raw f32 logits s (:func:`_plain_logits`, ``tensor_cores`` as there and
    in :func:`_mm`), each row's maximum m2 of s c (c =
    scale log2 e, one float32 product), p = 2^fma(s, c, -m2) rounded to
    bf16 before p v, the row sum of the unrounded p, o in bf16. Returns
    (o, lse2), lse2 the base-2 log-sum-exp of the scaled logits, (B, H, L)
    float32."""
    c = log2e_scale(sm_scale)
    o = torch.empty_like(q)
    lse2 = q.new_empty(q.shape[:3], dtype=torch.float32)
    for i in range(0, q.shape[0], _PLAIN_CHUNK):
        sl = slice(i, i + _PLAIN_CHUNK)
        s = _plain_logits(q[sl], k[sl], tensor_cores)
        m2 = s.amax(-1, keepdim=True) * c  # key 0 is in every row
        p = plain_p_bf16(s, c, m2)
        del s
        denom = p.sum(-1, keepdim=True)
        o[sl] = (_mm(_bf(p), v[sl], tensor_cores) / denom).to(o.dtype)
        lse2[sl] = (m2 + torch.log2(denom))[..., 0]
        del p
    return o, lse2


def plain_bwd_bf16(q: Tensor, k: Tensor, v: Tensor, o: Tensor, lse2: Tensor,
                   do: Tensor, sm_scale: float, tensor_cores: bool = False):
    """The bf16 backward kernels' arithmetic in plain PyTorch from the
    forward's ``o`` and base-2 ``lse2``: di = sum(o do) in f32, p =
    2^fma(s, c, -lse2), dv = bf16(p)^T do, ds = bf16(p fma(dp, scale,
    -di scale)), dk = ds^T q, dq = ds k, each in bf16, the products summed
    as :func:`_plain_logits` and :func:`_mm` sum them. Returns (dq, dk,
    dv)."""
    c = log2e_scale(sm_scale)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    for i in range(0, q.shape[0], _PLAIN_CHUNK):
        sl = slice(i, i + _PLAIN_CHUNK)
        dof = do[sl].float()
        di = (o[sl].float() * dof).sum(-1, keepdim=True)
        p = plain_p_bf16(_plain_logits(q[sl], k[sl], tensor_cores), c,
                         lse2[sl][..., None])
        dv[sl] = _mm(_bf(p).transpose(-1, -2), dof, tensor_cores
                     ).to(dv.dtype)
        dp = _mm(dof, v[sl].transpose(-1, -2), tensor_cores)
        ds = plain_ds_bf16(p, dp, di, sm_scale)
        del p, dp
        dk[sl] = _mm(ds.transpose(-1, -2), q[sl], tensor_cores).to(dk.dtype)
        dq[sl] = _mm(ds, k[sl], tensor_cores).to(dq.dtype)
        del ds
    return dq, dk, dv


class _PlainFlashBf16(torch.autograd.Function):
    """:func:`plain_fwd_bf16`, differentiable through
    :func:`plain_bwd_bf16`."""

    @staticmethod
    def forward(ctx, q: Tensor, k: Tensor, v: Tensor, sm_scale: float
                ) -> Tensor:
        o, lse2 = plain_fwd_bf16(q, k, v, sm_scale)
        ctx.save_for_backward(q, k, v, o, lse2)
        ctx.sm_scale = sm_scale
        return o

    @staticmethod
    def backward(ctx, do: Tensor):
        q, k, v, o, lse2 = ctx.saved_tensors
        return (*plain_bwd_bf16(q, k, v, o, lse2, do, ctx.sm_scale), None)


def flash_causal_attention_plain(
        q: Tensor, k: Tensor, v: Tensor, sm_scale: float,
        weights_fn: Optional[Callable[[Tensor], Tensor]] = None) -> Tensor:
    """The kernels' plain PyTorch version. float32: the dense masked
    softmax (:func:`dense_causal_attention`; ``weights_fn`` as there).
    bfloat16: the kernels' rounding points (:class:`_PlainFlashBf16`),
    which take no ``weights_fn``."""
    if q.dtype != torch.bfloat16:
        return dense_causal_attention(q, k, v, sm_scale, weights_fn)
    if weights_fn is not None:
        raise ValueError("the bfloat16 plain flash version takes no "
                         "weights_fn (the dense path applies weight "
                         "dropout)")
    return _PlainFlashBf16.apply(q, k, v, float(sm_scale))


def _library(d: int) -> ctypes.CDLL:
    lib = build.load(f"flash_attention_d{d}")
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        if fn.argtypes is None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def _check(**tensors: Tensor) -> None:
    """Raise on anything the kernels do not take: every tensor on one CUDA
    device, all float32 or all bfloat16, 4-D (B, H, L, D) of one shape,
    contiguous, 16-byte aligned, D in SUPPORTED_DIMS."""
    first = next(iter(tensors.values()))
    for name, t in tensors.items():
        if t.device.type != "cuda" or t.device != first.device:
            raise ValueError(f"flash_causal_attention_cuda needs every tensor "
                             f"on one CUDA device, got {name} on {t.device}")
        if t.dtype not in DTYPES or t.dtype != first.dtype:
            raise TypeError(f"flash_causal_attention_cuda takes float32 or "
                            f"bfloat16 tensors of one dtype, got {name} "
                            f"{t.dtype}")
        if t.dim() != 4 or t.shape != first.shape:
            raise ValueError(f"flash_causal_attention_cuda takes (B, H, L, D) "
                             f"tensors of one shape, got {name} "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash_causal_attention_cuda needs a contiguous, "
                             f"16-byte aligned {name}")
    b, h, L, d = first.shape
    if d not in SUPPORTED_DIMS:
        raise ValueError(f"flash_causal_attention_cuda supports D in "
                         f"{SUPPORTED_DIMS}, got {d}")
    if L == 0 or b * h == 0 or b * h > _INT32_MAX or L * d > _INT32_MAX:
        raise ValueError(f"flash_causal_attention_cuda needs 0 < B*H, L and "
                         f"B*H, L*D < 2^31, got {tuple(first.shape)}")


def _launch(name: str, count: str, dtype: torch.dtype, d: int, *args
            ) -> None:
    if dtype == torch.bfloat16:
        name = name.replace("movae_flash_", "movae_flash_bf16_")
    err = getattr(_library(d), name)(*args)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    LAUNCH_COUNTS[count] += 1


def _stream(t: Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def flash_fwd(q: Tensor, k: Tensor, v: Tensor, sm_scale: float):
    """Forward kernel: (o, lse2), o in q's dtype, lse2 the per-row
    log-sum-exp of the scaled logits in base 2, (B, H, L) float32. Inputs
    are checked by the caller."""
    b, h, L, d = q.shape
    o = torch.empty_like(q)
    lse2 = torch.empty((b, h, L), dtype=torch.float32, device=q.device)
    _launch("movae_flash_fwd", "flash_attention_fwd", q.dtype, d,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse2.data_ptr(), b * h,
            L, d, sm_scale, q.device.index, _stream(q))
    return o, lse2


def flash_bwd_dkv(q: Tensor, k: Tensor, v: Tensor, do: Tensor, lse2: Tensor,
                  di: Tensor, sm_scale: float):
    """dK/dV kernel: (dk, dv). ``di`` = (o * do).sum(-1), (B, H, L)
    float32."""
    b, h, L, d = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch("movae_flash_bwd_dkv", "flash_attention_bwd_dkv", q.dtype, d,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse2.data_ptr(), di.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b * h, L, d, sm_scale, q.device.index, _stream(q))
    return dk, dv


def flash_bwd_dq(q: Tensor, k: Tensor, v: Tensor, do: Tensor, lse2: Tensor,
                 di: Tensor, sm_scale: float) -> Tensor:
    """dQ kernel."""
    b, h, L, d = q.shape
    dq = torch.empty_like(q)
    _launch("movae_flash_bwd_dq", "flash_attention_bwd_dq", q.dtype, d,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse2.data_ptr(), di.data_ptr(), dq.data_ptr(), b * h, L, d,
            sm_scale,
            q.device.index, _stream(q))
    return dq


class _FlashCausalAttention(torch.autograd.Function):
    """Forward kernel; backward = dK/dV kernel, then dQ kernel. Saves q, k,
    v, o and lse2."""

    @staticmethod
    def forward(ctx, q: Tensor, k: Tensor, v: Tensor, sm_scale: float
                ) -> Tensor:
        o, lse2 = flash_fwd(q, k, v, sm_scale)
        ctx.save_for_backward(q, k, v, o, lse2)
        ctx.sm_scale = sm_scale
        return o

    @staticmethod
    def backward(ctx, do: Tensor):
        q, k, v, o, lse2 = ctx.saved_tensors
        # the dim-major flatten after the attention hands back a strided
        # cotangent
        do = do.contiguous()
        _check(q=q, do=do)
        # in float32 from the bf16 o and do at bfloat16, as the TPU kernel
        di = (o.float() * do.float()).sum(-1)
        dk, dv = flash_bwd_dkv(q, k, v, do, lse2, di, ctx.sm_scale)
        dq = flash_bwd_dq(q, k, v, do, lse2, di, ctx.sm_scale)
        return dq, dk, dv, None


def flash_causal_attention_cuda(q: Tensor, k: Tensor, v: Tensor,
                                sm_scale: float) -> Tensor:
    """Launch the forward kernel on the current stream; differentiable
    through the backward kernels."""
    _check(q=q, k=k, v=v)
    if not math.isfinite(sm_scale):
        raise ValueError(f"sm_scale must be finite, got {sm_scale}")
    return _FlashCausalAttention.apply(q, k, v, float(sm_scale))


def flash_causal_attention(q: Tensor, k: Tensor, v: Tensor,
                           sm_scale: float) -> Tensor:
    """(B, H, L, D) q, k, v -> (B, H, L, D) causal attention output.

    CPU tensors take :func:`flash_causal_attention_plain`; CUDA tensors
    launch the kernels of their dtype, which raise on anything they do not
    take (no fallback, and no cast from bfloat16 to float32)."""
    if all(t.device.type == "cpu" for t in (q, k, v)):
        return flash_causal_attention_plain(q, k, v, sm_scale)
    return flash_causal_attention_cuda(q, k, v, sm_scale)
