"""Strict loading of converted tower weights, and the random fallback — port
of ``movae_tpu/metrics/pretrained.py``.

The towers' weights arrive as the JAX package's converted ``.npz`` files
(flax paths such as ``params/Mixed_5b/branch1x1/conv/kernel`` and
``batch_stats/.../bn/mean``, HWIO kernels), so one file serves both
frameworks. A user who points ``MOVAE_INCEPTION_WEIGHTS`` /
``MOVAE_VGG16_WEIGHTS`` at a file expects the pretrained network: a path
that is set but missing, a missing entry and a shape mismatch each raise,
never fall back to random features.

Without a file, a tower takes a fixed-seed torch init (He-normal kernels,
zero biases, identity BatchNorm) and warns once: its FID/IS/KID/LPIPS are
relative measures only, and they differ from the JAX package's
random-feature numbers (a flax init the port cannot reproduce). Only a
shared weights file makes the two frameworks' numbers agree.
"""

from __future__ import annotations

import math
import os
import warnings
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

FALLBACK_SEED = 20260816
_TRUNC_STD_CORRECTION = 0.87962566103423978


class RandomTowerWarning(UserWarning):
    """A metric tower runs on the fixed-seed random init."""


def merge_pretrained(expected: Mapping[str, Tuple[int, ...]],
                     flat: Mapping[str, np.ndarray], source: str
                     ) -> Dict[str, np.ndarray]:
    """``expected``: {flax path: shape} the tower needs. Returns those
    entries of ``flat``; raises ValueError if any is missing or has another
    shape (extra entries, such as torchvision's ``AuxLogits``, are
    ignored)."""
    missing = [k for k in expected if k not in flat]
    if missing:
        raise ValueError(
            f"{source}: {len(missing)}/{len(expected)} variable paths are "
            f"missing from the weights file (e.g. {missing[:3]}); refusing "
            "a partial merge.")
    bad = [(k, tuple(np.shape(flat[k])), tuple(shape))
           for k, shape in expected.items()
           if tuple(np.shape(flat[k])) != tuple(shape)]
    if bad:
        k, got, want = bad[0]
        raise ValueError(
            f"{source}: {len(bad)} entries have wrong shapes (e.g. {k}: "
            f"file {got} vs model {want}); the file was converted for a "
            "different architecture/layout.")
    return {k: np.asarray(flat[k]) for k in expected}


@torch.no_grad()
def random_init(module: nn.Module, seed: int = FALLBACK_SEED) -> nn.Module:
    """Fixed-seed init on the CPU: He-normal (truncated, variance
    2 / fan-in) conv and dense kernels, zero biases, BatchNorm scale 1 /
    shift 0 / mean 0 / var 1. The variance 2 keeps the activations' scale
    through the ReLUs: at 1 (flax's lecun default) the 2048 Inception
    features shrink to ~1e-3 and barely depend on the image."""
    gen = torch.Generator().manual_seed(seed)
    for mod in module.modules():
        if isinstance(mod, (nn.Conv2d, nn.Linear)):
            std = math.sqrt(2.0 / mod.weight[0].numel()) \
                / _TRUNC_STD_CORRECTION
            nn.init.trunc_normal_(mod.weight, 0.0, std, -2.0 * std,
                                  2.0 * std, generator=gen)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, nn.BatchNorm2d):
            mod.reset_parameters()
    return module


def load_tower(module: nn.Module, path: Optional[str], env_var: str,
               name: str, metrics: str) -> nn.Module:
    """Weights for ``module`` from ``path``, else from the file that
    ``env_var`` names, else :func:`random_init` with a one-time
    :class:`RandomTowerWarning`. Returns the module (on the CPU)."""
    from movae_tpu_torch.utils.weights import load_tower_npz

    path = path or os.environ.get(env_var)
    if path:
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"{env_var} points at a missing file: {path}")
        return load_tower_npz(module, path)
    warnings.warn(
        f"no pretrained {name} weights (set {env_var}); {metrics} use the "
        f"port's fixed random features: relative numbers only, and not the "
        f"JAX package's random-feature numbers (only a shared weights file "
        f"makes the two agree)", RandomTowerWarning, stacklevel=3)
    return random_init(module)
