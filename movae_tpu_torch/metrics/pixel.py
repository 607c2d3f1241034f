"""Pixel-space reconstruction metrics: SSIM / PSNR / SSNR — port of
``movae_tpu/metrics/pixel.py``.

11x11 Gaussian-window (sigma 1.5) SSIM with the reference's C1/C2 and a
depthwise convolution with zero padding (the JAX package's "SAME"), per
image PSNR and SSNR in dB with the same clamps. Inputs in [-1, 1] are mapped
to [0, 1] when the minimum of the whole batch is negative, as in the JAX
package. Images are NHWC; the blur runs NCHW inside. Each returns a 0-dim
float32 tensor on the inputs' device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

Tensor = torch.Tensor


@functools.lru_cache(maxsize=8)
def _gaussian_window(window_size: int = 11, sigma: float = 1.5) -> np.ndarray:
    g = np.exp(-((np.arange(window_size) - window_size // 2) ** 2)
               / (2 * sigma ** 2))
    g = g / g.sum()
    return np.outer(g, g).astype(np.float32)


def _auto_range(img: Tensor) -> Tensor:
    img = torch.as_tensor(img).float()
    img = torch.where(img.min() < 0, (img + 1.0) / 2.0, img)
    return img.clamp(0.0, 1.0)


def _depthwise_blur(img: Tensor, window: Tensor) -> Tensor:
    """NCHW depthwise convolution with ``window``, zero "SAME" padding."""
    c, k = img.shape[1], window.shape[0]
    weight = window[None, None].expand(c, 1, k, k)
    return F.conv2d(img, weight, padding=k // 2, groups=c)


def ssim(img1: Tensor, img2: Tensor, window_size: int = 11,
         size_average: bool = True) -> Tensor:
    """SSIM of NHWC images in [0, 1] or [-1, 1]: the mean over the batch,
    or per image with ``size_average=False``."""
    img1 = _auto_range(img1).permute(0, 3, 1, 2)
    img2 = _auto_range(img2).permute(0, 3, 1, 2)
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    w = torch.from_numpy(_gaussian_window(window_size)).to(img1.device)
    mu1, mu2 = _depthwise_blur(img1, w), _depthwise_blur(img2, w)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    s1 = _depthwise_blur(img1 * img1, w) - mu1_sq
    s2 = _depthwise_blur(img2 * img2, w) - mu2_sq
    s12 = _depthwise_blur(img1 * img2, w) - mu12
    ssim_map = ((2 * mu12 + c1) * (2 * s12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (s1 + s2 + c2))
    if size_average:
        return ssim_map.mean()
    return ssim_map.mean(dim=(1, 2, 3))


def psnr(img1: Tensor, img2: Tensor, max_val: float = 1.0) -> Tensor:
    """PSNR in dB, the mean over the batch of each image's."""
    img1, img2 = _auto_range(img1), _auto_range(img2)
    mse = (img1 - img2).square().mean(dim=(1, 2, 3)).clamp(min=1e-10)
    vals = 20.0 * np.log10(max_val) - 10.0 * torch.log10(mse)
    return vals.mean()


def ssnr(img1: Tensor, img2: Tensor) -> Tensor:
    """Signal-to-noise ratio in dB, the mean over the batch."""
    img1, img2 = _auto_range(img1), _auto_range(img2)
    signal = img1.var(dim=(1, 2, 3), unbiased=False).clamp(min=1e-10)
    noise = (img1 - img2).square().mean(dim=(1, 2, 3)).clamp(min=1e-10)
    return (10.0 * torch.log10(signal / noise)).mean()
