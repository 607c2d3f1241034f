"""Convolutions whose products go through a :class:`Precision`: the
operands of every product pass ``prec.operand`` and its result
``prec.output`` (float8 rounding in the ``fp8`` control, else nothing).
Parameter names are torch's own, so a reference module's ``state_dict``
keys are the published layout's."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference.precision import Precision


class Conv(nn.Conv2d):
    prec = Precision()

    def forward(self, x):
        p = self.prec.operand
        return self.prec.output(F.conv2d(p(x), p(self.weight), self.bias,
                                         self.stride, self.padding))


class ConvT(nn.ConvTranspose2d):
    prec = Precision()

    def forward(self, x):
        p = self.prec.operand
        return self.prec.output(F.conv_transpose2d(
            p(x), p(self.weight), self.bias, self.stride, self.padding))


def causal_mask(k: int, mask_type: str) -> torch.Tensor:
    """(1, 1, k, k) raster-order mask: every row above the centre, the
    centre row left of the centre, and the centre itself for type "B"."""
    m = np.zeros((k, k), np.float32)
    m[: k // 2, :] = 1.0
    m[k // 2, : k // 2] = 1.0
    if mask_type == "B":
        m[k // 2, k // 2] = 1.0
    return torch.from_numpy(m)[None, None]


class MaskedConv(nn.Conv2d):
    """A causal k x k convolution (PixelCNN's type A or B), zero padding
    on every side."""

    prec = Precision()

    def __init__(self, cin: int, cout: int, k: int, mask_type: str):
        super().__init__(cin, cout, k, padding=k // 2)
        self.register_buffer("mask", causal_mask(k, mask_type),
                             persistent=False)

    def forward(self, x):
        p = self.prec.operand
        return self.prec.output(F.conv2d(p(x), p(self.weight * self.mask),
                                         self.bias, padding=self.padding))


def set_precision(module: nn.Module, prec: Precision) -> None:
    """Route every product of ``module`` (and of the modules that hold a
    ``prec`` of their own) through ``prec``."""
    for m in module.modules():
        if hasattr(m, "prec"):
            m.prec = prec
