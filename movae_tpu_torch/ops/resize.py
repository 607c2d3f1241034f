"""Bicubic and bilinear image resize — port of ``movae_tpu/ops/resize.py``.

The JAX module rebuilds ``torch.nn.functional.interpolate(mode="bicubic" |
"bilinear", antialias=...)`` as weight-matrix products, because that is
what the reference's ``torchvision.transforms.functional.resize`` runs on
tensors. Here the original is at hand, so both functions call it directly.
On an axis whose size does not change torch's kernels are the identity,
as the JAX module's skipped axis is; a batch whose size does not change at
all is returned as it is.

Images are NHWC at this interface; ``F.interpolate`` runs NCHW inside. The
result is float32 (float64 input stays float64: a reference run in float64
checks the float32 one).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def as_float(x) -> Tensor:
    """A tensor in float32, or float64 if it already is."""
    x = torch.as_tensor(x)
    return x if x.dtype == torch.float64 else x.float()


def _resize(x: Tensor, out_h: int, out_w: int, antialias: bool,
            mode: str) -> Tensor:
    x = as_float(x)
    if tuple(x.shape[1:3]) == (out_h, out_w):
        return x
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(out_h, out_w), mode=mode,
                      align_corners=False, antialias=antialias)
    return y.permute(0, 2, 3, 1)


def resize_bicubic(x: Tensor, out_h: int, out_w: int,
                   antialias: bool = True) -> Tensor:
    """Bicubic-resize an NHWC batch to (out_h, out_w):
    ``F.interpolate(mode="bicubic", antialias=...)`` (A=-0.5 with
    antialias, the PIL filter; A=-0.75 without)."""
    return _resize(x, out_h, out_w, antialias, "bicubic")


def resize_bilinear(x: Tensor, out_h: int, out_w: int,
                    antialias: bool = True) -> Tensor:
    """Bilinear-resize an NHWC batch to (out_h, out_w):
    ``F.interpolate(mode="bilinear", antialias=..., align_corners=False)``,
    torchvision's default interpolation, which the reference's
    Inception-Score preprocessing uses."""
    return _resize(x, out_h, out_w, antialias, "bilinear")
