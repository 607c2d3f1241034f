"""Causal flash attention: the CUDA kernels' wrapper and their plain version.

``flash_causal_attention(q, k, v, sm_scale)`` computes, over (B, H, L, D)
float32 tensors, ``softmax(q k^T * sm_scale, inclusive causal mask) v``
(position i attends to 0..i) — the function of the stock Pallas TPU flash
attention that ``movae_tpu/ops/attention.py:causal_attention`` calls for
long sequences, and of its ``dense_causal_attention``. A CPU tensor takes
the plain PyTorch version; a CUDA tensor launches ``flash_attention.cu``
(forward; dK/dV then dQ in the backward) or raises.
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
_SIGNATURES = {
    # q, k, v, o, lse2, bh, L, d, scale, device, stream
    "movae_flash_fwd": [_P] * 5 + [_I] * 3 + [_F, _I, _P],
    # q, k, v, do, lse2, di, dk, dv, bh, L, d, scale, device, stream
    "movae_flash_bwd_dkv": [_P] * 8 + [_I] * 3 + [_F, _I, _P],
    # q, k, v, do, lse2, di, dq, bh, L, d, scale, device, stream
    "movae_flash_bwd_dq": [_P] * 7 + [_I] * 3 + [_F, _I, _P],
}


def flash_causal_attention_plain(
        q: Tensor, k: Tensor, v: Tensor, sm_scale: float,
        weights_fn: Optional[Callable[[Tensor], Tensor]] = None) -> Tensor:
    """The dense masked softmax in plain PyTorch (the L x L logits are
    materialized), as ``movae_tpu/ops/attention.py:dense_causal_attention``.
    ``weights_fn`` maps the (B, H, L, L) attention weights before they meet
    v (the prior's attention-weight dropout)."""
    L = q.shape[2]
    logits = torch.matmul(q, k.transpose(-1, -2)) * sm_scale
    mask = torch.ones((L, L), dtype=torch.bool, device=q.device).tril()
    weights = torch.softmax(logits.masked_fill(~mask, float("-inf")), dim=-1)
    if weights_fn is not None:
        weights = weights_fn(weights)
    return torch.matmul(weights, v)


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
    device, float32, 4-D (B, H, L, D) of one shape, contiguous, 16-byte
    aligned, D in SUPPORTED_DIMS."""
    first = next(iter(tensors.values()))
    for name, t in tensors.items():
        if t.device.type != "cuda" or t.device != first.device:
            raise ValueError(f"flash_causal_attention_cuda needs every tensor "
                             f"on one CUDA device, got {name} on {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"flash_causal_attention_cuda takes float32, got "
                            f"{name} {t.dtype}")
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


def _launch(name: str, count: str, d: int, *args) -> None:
    err = getattr(_library(d), name)(*args)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    LAUNCH_COUNTS[count] += 1


def _stream(t: Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def flash_fwd(q: Tensor, k: Tensor, v: Tensor, sm_scale: float):
    """Forward kernel: (o, lse2), lse2 the per-row log-sum-exp of the scaled
    logits in base 2, (B, H, L). Inputs are checked by the caller."""
    b, h, L, d = q.shape
    o = torch.empty_like(q)
    lse2 = torch.empty((b, h, L), dtype=torch.float32, device=q.device)
    _launch("movae_flash_fwd", "flash_attention_fwd", d, q.data_ptr(),
            k.data_ptr(), v.data_ptr(), o.data_ptr(), lse2.data_ptr(), b * h,
            L, d, sm_scale, q.device.index, _stream(q))
    return o, lse2


def flash_bwd_dkv(q: Tensor, k: Tensor, v: Tensor, do: Tensor, lse2: Tensor,
                  di: Tensor, sm_scale: float):
    """dK/dV kernel: (dk, dv). ``di`` = (o * do).sum(-1), (B, H, L)."""
    b, h, L, d = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch("movae_flash_bwd_dkv", "flash_attention_bwd_dkv", d,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse2.data_ptr(), di.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b * h, L, d, sm_scale, q.device.index, _stream(q))
    return dk, dv


def flash_bwd_dq(q: Tensor, k: Tensor, v: Tensor, do: Tensor, lse2: Tensor,
                 di: Tensor, sm_scale: float) -> Tensor:
    """dQ kernel."""
    b, h, L, d = q.shape
    dq = torch.empty_like(q)
    _launch("movae_flash_bwd_dq", "flash_attention_bwd_dq", d, q.data_ptr(),
            k.data_ptr(), v.data_ptr(), do.data_ptr(), lse2.data_ptr(),
            di.data_ptr(), dq.data_ptr(), b * h, L, d, sm_scale,
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
        di = (o * do).sum(-1)
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
    launch the kernels, which raise on anything they do not take (no
    fallback)."""
    if all(t.device.type == "cpu" for t in (q, k, v)):
        return flash_causal_attention_plain(q, k, v, sm_scale)
    return flash_causal_attention_cuda(q, k, v, sm_scale)
