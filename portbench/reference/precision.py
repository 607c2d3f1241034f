"""The arithmetic a reference run computes in.

``fp32`` is the reference itself: float32 with TF32 off for matmuls and
cuDNN. Three witnesses serve the look behind a cell's limits: ``fp64``
(the reference in float64, its attention on the plain matmul path),
``fp32_math`` (float32 with the attention on the plain matmul path
instead of the memory-efficient kernel) and ``bf16`` (the reference under
``torch.autocast`` to bfloat16, a plain second bfloat16 program). The
controls sit one step below a configuration's precision:
``tf32`` (float32 products on the TF32 tensor cores) below float32, and
``fp8`` below bfloat16: every product's operands and result, and every
activation and residual sum between the layers, rounded to float8 e4m3
with a per-tensor scale (the sums inside a product in float32), as
bfloat16 layers keep their activations in bfloat16; ``int8`` the same
with symmetric 8-bit integers under a per-tensor scale.
"""

from __future__ import annotations

import contextlib

import torch

MODES = ("fp32", "fp32_math", "fp64", "bf16", "tf32", "fp8", "int8")
# largest finite float8 e4m3fn value
_E4M3_MAX = 448.0


class Precision:
    """A run's arithmetic: :meth:`operand` maps each product's operand,
    :meth:`region` sets the TF32 switches (and for ``bf16`` the autocast)
    around the run; ``dtype`` is the parameters' type."""

    def __init__(self, mode: str = "fp32"):
        if mode not in MODES:
            raise ValueError(f"precision {mode!r} not in {MODES}")
        self.mode = mode
        self.dtype = torch.float64 if mode == "fp64" else torch.float32
        # the attention on the plain matmul path, not a fused kernel
        self.math_attention = mode in ("fp32_math", "fp64")

    def operand(self, x: torch.Tensor) -> torch.Tensor:
        if self.mode == "fp8":
            return _Fake.apply(x, _round_e4m3)
        if self.mode == "int8":
            return _Fake.apply(x, _round_int8)
        return x

    # a product's result and an activation are kept in the operand type
    output = operand

    @contextlib.contextmanager
    def region(self, device_type: str = "cuda"):
        tf32 = self.mode == "tf32"
        saved = (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        try:
            with (torch.autocast(device_type, dtype=torch.bfloat16)
                  if self.mode == "bf16" else contextlib.nullcontext()):
                yield
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = saved


def _round_e4m3(x: torch.Tensor) -> torch.Tensor:
    scale = x.detach().abs().amax().clamp(min=1e-30) / _E4M3_MAX
    return ((x / scale).to(torch.float8_e4m3fn).to(x.dtype)) * scale


def _round_int8(x: torch.Tensor) -> torch.Tensor:
    scale = x.detach().abs().amax().clamp(min=1e-30) / 127.0
    return torch.round(x / scale).clamp(-127, 127) * scale


class _Fake(torch.autograd.Function):
    """Round under a per-tensor scale, the value in the forward and its
    gradient in the backward: the backward computes in the low type where
    the forward does, as a bfloat16 program's backward does in
    bfloat16."""

    @staticmethod
    def forward(ctx, x, rnd):
        ctx.rnd = rnd
        return rnd(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.rnd(g), None
