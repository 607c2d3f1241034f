"""Weights from the seed, made by the benchmark and handed to both sides.

Every convolution kernel is normal with standard deviation
1 / sqrt(fan in) (a transposed convolution's fan in counts its input
channels), every bias is zero, a VQ codebook is uniform in (-1/K, 1/K)
and a code embedding normal with standard deviation 1 / sqrt(D). The
draws are two large calls on the device's generator, one normal and one
uniform, sliced leaf by leaf in the module's parameter order.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
from torch import nn


def _kind(module: nn.Module, name: str, p: torch.Tensor):
    """('normal', std), ('uniform', bound) or ('zero', 0) for a leaf."""
    owner = module.get_submodule(name.rsplit(".", 1)[0])
    leaf = name.rsplit(".", 1)[1]
    if leaf == "bias":
        return "zero", 0.0
    if isinstance(owner, nn.ConvTranspose2d):
        return "normal", 1.0 / math.sqrt(p.shape[0] * p.shape[2] * p.shape[3])
    if isinstance(owner, nn.Conv2d):
        return "normal", 1.0 / math.sqrt(p.shape[1] * p.shape[2] * p.shape[3])
    if isinstance(owner, nn.Embedding):  # a VQ codebook
        return "uniform", 1.0 / p.shape[0]
    return "normal", 1.0 / math.sqrt(p.shape[1])  # a code embedding


def make_weights(module: nn.Module, seed: int, device: torch.device
                 ) -> Dict[str, torch.Tensor]:
    """{parameter name: float32 tensor on ``device``} for ``module``'s
    parameters, from ``seed``."""
    kinds = {n: _kind(module, n, p) for n, p in module.named_parameters()}
    sizes = {k: sum(p.numel() for n, p in module.named_parameters()
                    if kinds[n][0] == k) for k in ("normal", "uniform")}
    gen = torch.Generator(device=device).manual_seed(seed)
    pools = {k: (torch.randn(n, generator=gen, device=device) if k == "normal"
                 else torch.rand(n, generator=gen, device=device) * 2 - 1)
             for k, n in sizes.items()}
    at = dict.fromkeys(pools, 0)
    out = {}
    for n, p in module.named_parameters():
        kind, scale = kinds[n]
        if kind == "zero":
            out[n] = torch.zeros(p.shape, device=device)
            continue
        flat = pools[kind][at[kind]:at[kind] + p.numel()]
        at[kind] += p.numel()
        out[n] = (flat * scale).reshape(p.shape)
    return out


def scale_leaves(weights: Dict[str, torch.Tensor],
                 factors: Dict[str, float]) -> Dict[str, torch.Tensor]:
    """``weights`` with each leaf that ``factors`` names multiplied by its
    factor (a cell's ``weight_scale``); every name has to be a leaf."""
    missing = set(factors) - set(weights)
    if missing:
        raise KeyError(f"weight_scale names no leaf: {sorted(missing)}")
    return {n: w * float(factors[n]) if n in factors else w
            for n, w in weights.items()}
