"""Metrics suite — port of ``movae_tpu/metrics``: pixel (SSIM/PSNR/SSNR),
perceptual (LPIPS, ``metrics/vgg.py``), feature-space
(FID/KID/IS/precision-recall) and hypervolume. The same exported names as
the JAX package."""

from movae_tpu_torch.metrics.features import (  # noqa: F401
    calculate_fid,
    calculate_inception_score,
    calculate_kid,
    extract_inception_features,
    fid_from_features,
    kid_from_features,
    precision_recall_from_features,
)
from movae_tpu_torch.metrics.hv import (  # noqa: F401
    HVIndicator,
    build_hv_indicator,
    hypervolume,
)
from movae_tpu_torch.metrics.pixel import psnr, ssim, ssnr  # noqa: F401
