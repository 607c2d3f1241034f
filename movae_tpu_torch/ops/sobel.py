"""Sobel edge losses of the gradient-guided models — port of
``movae_tpu/ops/sobel.py`` with both of its version tables (GG-VAE and
GG-VQ-VAE).

Images are NHWC at the public functions, as in the JAX package; the
depthwise 3x3 Sobel convolutions run NCHW inside (zero padding 1, the JAX
package's ``SAME``), and each loss is a mean, so it reads the NCHW
gradients directly.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch
import torch.nn.functional as F

Tensor = torch.Tensor
EPS = 1e-8

_SOBEL_X = ((-1.0, 0.0, 1.0), (-2.0, 0.0, 2.0), (-1.0, 0.0, 1.0))
_SOBEL_Y = ((-1.0, -2.0, -1.0), (0.0, 0.0, 0.0), (1.0, 2.0, 1.0))


@functools.lru_cache(maxsize=None)
def _kernels(c: int, device: torch.device) -> Tensor:
    """(2c, 1, 3, 3) depthwise weights, x then y per channel, made once per
    device (a copy from the host each call would synchronise with the
    card)."""
    k = torch.tensor((_SOBEL_X, _SOBEL_Y), dtype=torch.float32)
    return k[:, None].repeat(c, 1, 1, 1).to(device)


def _gradients_nchw(x: Tensor) -> Tuple[Tensor, Tensor]:
    """Depthwise Sobel x/y gradients of NHWC images, as NCHW planes."""
    c = x.shape[-1]
    g = F.conv2d(x.float().permute(0, 3, 1, 2), _kernels(c, x.device),
                 padding=1, groups=c)
    return g[:, 0::2], g[:, 1::2]


def sobel_gradients(x: Tensor) -> Tuple[Tensor, Tensor]:
    """Depthwise Sobel x/y gradients on NHWC images -> (gx, gy), NHWC."""
    gx, gy = _gradients_nchw(x)
    return gx.permute(0, 2, 3, 1), gy.permute(0, 2, 3, 1)


def _smooth_l1(a: Tensor, b: Tensor, beta: float = 1.0) -> Tensor:
    d = (a - b).abs()
    return torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta).mean()


def _mag(gx: Tensor, gy: Tensor) -> Tensor:
    return torch.sqrt(gx * gx + gy * gy + EPS)


def _both(inputs: Tensor, recons: Tensor):
    return _gradients_nchw(inputs), _gradients_nchw(recons)


def edge_weighted_pixel_loss(inputs: Tensor, recons: Tensor) -> Tensor:
    """gradient_guided_loss: MSE weighted by the input's edge magnitude
    (largest over channels, scaled to a maximum of 1)."""
    gx, gy = _gradients_nchw(inputs)
    w = _mag(gx, gy).amax(1)                    # (N, H, W)
    w = w / (w.max() + EPS)
    pixel = (recons.float() - inputs.float()) ** 2
    return (w[..., None] * pixel).mean()


def edge_matching_signed_mse(inputs: Tensor, recons: Tensor) -> Tensor:
    """MSE on signed gradients (v2)."""
    (igx, igy), (rgx, rgy) = _both(inputs, recons)
    return ((rgx - igx) ** 2).mean() + ((rgy - igy) ** 2).mean()


def edge_matching_magnitude(inputs: Tensor, recons: Tensor) -> Tensor:
    """Smooth-L1 on gradient magnitudes (v3)."""
    (igx, igy), (rgx, rgy) = _both(inputs, recons)
    return _smooth_l1(_mag(rgx, rgy), _mag(igx, igy))


def edge_matching_normalized(inputs: Tensor, recons: Tensor) -> Tensor:
    """Smooth-L1 on max-normalized magnitudes (v4)."""
    (igx, igy), (rgx, rgy) = _both(inputs, recons)
    gt, gp = _mag(igx, igy), _mag(rgx, rgy)
    return _smooth_l1(gp / (gp.max() + EPS), gt / (gt.max() + EPS))


def edge_matching_angle(inputs: Tensor, recons: Tensor) -> Tensor:
    """Smooth-L1 on atan2 gradient angles (v5)."""
    (igx, igy), (rgx, rgy) = _both(inputs, recons)
    return _smooth_l1(torch.atan2(rgy, rgx), torch.atan2(igy, igx))


def edge_matching_masked(inputs: Tensor, recons: Tensor) -> Tensor:
    """Smooth-L1 on magnitudes masked above the target mean (v6)."""
    (igx, igy), (rgx, rgy) = _both(inputs, recons)
    gt, gp = _mag(igx, igy), _mag(rgx, rgy)
    mask = (gt > gt.mean()).float()
    return _smooth_l1(gp * mask, gt * mask)


def edge_matching_cosine(inputs: Tensor, recons: Tensor) -> Tensor:
    """1 - cosine similarity of unit gradient vectors (v7); the norms are
    clamped at 1e-12, as torch's ``F.normalize``."""
    (igx, igy), (rgx, rgy) = _both(inputs, recons)
    gt = torch.stack([igx, igy], dim=-1)
    gp = torch.stack([rgx, rgy], dim=-1)
    gt_n = gt / torch.linalg.vector_norm(gt, dim=-1,
                                         keepdim=True).clamp_min(1e-12)
    gp_n = gp / torch.linalg.vector_norm(gp, dim=-1,
                                         keepdim=True).clamp_min(1e-12)
    return 1.0 - (gt_n * gp_n).sum(-1).mean()


def edge_matching_binary(inputs: Tensor, recons: Tensor) -> Tensor:
    """MSE on binary edge maps, magnitudes thresholded at 0.5 (v8)."""
    (igx, igy), (rgx, rgy) = _both(inputs, recons)
    te = (_mag(igx, igy) > 0.5).float()
    pe = (_mag(rgx, rgy) > 0.5).float()
    return ((pe - te) ** 2).mean()


# GG-VAE arch version -> edge-matching loss; the registry builds no v4, and
# GGVAE falls back to the magnitude loss for a version missing here
GG_VAE_EDGE_FNS = {
    1: edge_matching_magnitude,
    2: edge_matching_normalized,
    3: edge_matching_angle,
    5: edge_matching_cosine,
    6: edge_matching_binary,
}

# GG-VQ-VAE arch version -> edge-matching loss (v1 has none)
GG_VQVAE_EDGE_FNS = {
    "v2": edge_matching_signed_mse,
    "v3": edge_matching_magnitude,
    "v4": edge_matching_normalized,
    "v5": edge_matching_angle,
    "v6": edge_matching_masked,
    "v7": edge_matching_cosine,
    "v8": edge_matching_binary,
}
