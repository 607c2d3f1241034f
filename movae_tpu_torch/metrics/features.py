"""Feature-space generative metrics: FID / KID / Inception Score /
precision-recall — port of ``movae_tpu/metrics/features.py``.

Images in [-1, 1] (NHWC) are denormalized, resized with the shorter side to
299 (antialiased; bicubic for the FID/KID features, bilinear for the IS
logits, as the reference does), center-cropped and ImageNet-normalized, then
run through the InceptionV3 tower on the card (pool-2048 features and the
fc logits). The statistics stay numpy/scipy on the host, copied line for
line from the JAX package: the Gaussian Fréchet distance with scipy's
``sqrtm`` (the eps-offset retry and the imaginary-part guard), the unbiased
polynomial-kernel MMD^2 for KID over ``default_rng(seed)`` subsets, the
10-split Inception Score and the nearest-only precision/recall.
"""

from __future__ import annotations

import warnings
from typing import Dict, Optional

import numpy as np
import torch
from scipy import linalg

from movae_tpu_torch.device import DeviceLike, resolve_device
from movae_tpu_torch.metrics.inception import build_inception
from movae_tpu_torch.ops.resize import (as_float, resize_bicubic,
                                        resize_bilinear)

Tensor = torch.Tensor

_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)


def inception_preprocess(batch: Tensor, method: str = "bicubic") -> Tensor:
    """[-1, 1] -> [0, 1], resize the shorter side to 299 (antialiased), center
    crop 299, ImageNet-normalize; NHWC in and out, float32 (float64 stays
    float64).

    As ``torchvision.transforms.functional.resize(t, 299, <method>,
    antialias=True)``: the longer side is TRUNCATED (``int(299 * long /
    short)``), no resize when the shorter side is already 299, and the crop
    offset is ``int(round((n - 299) / 2))`` (Python's banker's rounding).
    ``method``: "bicubic" for the FID/KID features, "bilinear" (torchvision's
    default) for the Inception-Score logits, as the reference does."""
    x = as_float(batch) * 0.5 + 0.5
    x = x.clamp(0.0, 1.0)
    _, h, w, _ = x.shape
    if min(h, w) != 299:
        if h <= w:
            nh, nw = 299, int(299 * w / h)
        else:
            nw, nh = 299, int(299 * h / w)
        resize = resize_bilinear if method == "bilinear" else resize_bicubic
        x = resize(x, nh, nw, antialias=True)
    else:
        nh, nw = h, w
    top, left = int(round((nh - 299) / 2.0)), int(round((nw - 299) / 2.0))
    x = x[:, top:top + 299, left:left + 299]
    return (x - x.new_tensor(_IMAGENET_MEAN)) / x.new_tensor(_IMAGENET_STD)


class InceptionTower:
    """The Inception tower on one device, and its batched extraction.

    ``InceptionTower.get(device)`` keeps one tower per device (default
    ``cuda``), its weights from ``MOVAE_INCEPTION_WEIGHTS`` or the random
    fallback."""

    _instances: Dict[str, "InceptionTower"] = {}

    def __init__(self, weights_path: Optional[str] = None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.model = build_inception(weights_path, self.device)

    @classmethod
    def get(cls, device: DeviceLike = None) -> "InceptionTower":
        dev = resolve_device(device)
        if str(dev) not in cls._instances:
            cls._instances[str(dev)] = InceptionTower(device=dev)
        return cls._instances[str(dev)]

    @torch.no_grad()
    def run(self, batch: Tensor, method: str = "bicubic"):
        """One batch of [-1, 1] NHWC images -> (features, logits) on the
        tower's device."""
        x = torch.as_tensor(batch).to(self.device, non_blocking=True)
        return self.model(inception_preprocess(x, method))

    def extract(self, images, batch_size: int = 128,
                want_logits: bool = False, method: str = "bicubic"):
        """images: (N, H, W, C) float, EXPECTED in [-1, 1]: preprocessing
        denormalizes with x*0.5+0.5 unconditionally, as the reference does
        (so [0, 1] inputs are compressed to [0.5, 1]; the VGG tower
        auto-ranges instead). Returns numpy features (and logits)."""
        n = len(images)
        if n == 0:
            empty = np.array([])
            return (empty, empty) if want_logits else empty
        feats, logits = [], []
        for i in range(0, n, batch_size):
            f, lg = self.run(images[i:i + batch_size], method)
            feats.append(f.cpu().numpy())
            if want_logits:
                logits.append(lg.cpu().numpy())
        feats = np.concatenate(feats)
        if want_logits:
            return feats, np.concatenate(logits)
        return feats


def extract_inception_features(images, batch_size: int = 128,
                               device: DeviceLike = None) -> np.ndarray:
    """Shared features for FID/KID (bicubic preprocessing)."""
    return InceptionTower.get(device).extract(images, batch_size)

def fid_from_features(real_features: np.ndarray, fake_features: np.ndarray,
                      eps: float = 1e-6) -> float:
    """Fréchet distance between feature Gaussians (metrics.py:656-679)."""
    if len(real_features) == 0 or len(fake_features) == 0:
        return float("nan")
    mu1 = real_features.mean(axis=0)
    mu2 = fake_features.mean(axis=0)
    sigma1 = np.cov(real_features, rowvar=False)
    sigma2 = np.cov(fake_features, rowvar=False)
    sigma1 = np.atleast_2d(sigma1)
    sigma2 = np.atleast_2d(sigma2)
    diff = mu1 - mu2
    ssdiff = diff.dot(diff)
    # scipy >= 1.16 deprecates disp=; inaccuracy surfaces as a warning +
    # non-finite entries, which the eps-offset retry below already handles
    # (metrics.py:594-600), so keep the old disp=False silence
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        covmean = linalg.sqrtm(sigma1.dot(sigma2))
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
            print("Warning: FID imaginary component too large, returning nan.")
            return float("nan")
        covmean = covmean.real
    return float(ssdiff + np.trace(sigma1) + np.trace(sigma2)
                 - 2.0 * np.trace(covmean))


def kid_from_features(real_features: np.ndarray, fake_features: np.ndarray,
                      subset_size: int = 50, n_subsets: int = 50,
                      degree: int = 3, gamma: Optional[float] = None,
                      seed: Optional[int] = None) -> float:
    """Unbiased poly-kernel MMD^2 (metrics.py:682-709)."""
    if len(real_features) == 0 or len(fake_features) == 0:
        return float("nan")
    n_real, dim = real_features.shape
    n_fake = fake_features.shape[0]
    gamma = gamma if gamma is not None else 1.0 / dim
    subset_size = min(subset_size, n_real, n_fake)
    if subset_size < 2:
        return float("nan")

    def k(x, y):
        return (gamma * (x @ y.T) + 1.0) ** degree

    rng = np.random.default_rng(seed)
    vals = []
    for _ in range(n_subsets):
        r = real_features[rng.choice(n_real, subset_size, replace=False)]
        f = fake_features[rng.choice(n_fake, subset_size, replace=False)]
        krr, kff, krf = k(r, r), k(f, f), k(r, f)
        np.fill_diagonal(krr, 0)
        np.fill_diagonal(kff, 0)
        n = subset_size
        mmd2 = (krr.sum() / (n * (n - 1)) + kff.sum() / (n * (n - 1))
                - 2.0 * krf.mean())
        vals.append(max(0.0, mmd2))
    return float(np.mean(vals))


def calculate_fid(real_images, fake_images, batch_size: int = 128,
                  eps: float = 1e-6, device: DeviceLike = None) -> float:
    """End-to-end FID (metrics.py:513-615)."""
    rf = extract_inception_features(real_images, batch_size, device)
    ff = extract_inception_features(fake_images, batch_size, device)
    return fid_from_features(rf, ff, eps)


def calculate_kid(real_images, fake_images, batch_size: int = 128,
                  device: DeviceLike = None, **kw) -> float:
    """End-to-end KID. Its features are preprocessed BICUBIC, as the JAX
    package's are; the original torch repository's image-level KID resizes
    bilinear (a known divergence of the reference, mirrored here)."""
    rf = extract_inception_features(real_images, batch_size, device)
    ff = extract_inception_features(fake_images, batch_size, device)
    return kid_from_features(rf, ff, **kw)


def inception_score_from_probs(probs: np.ndarray, splits: int = 10):
    """IS = exp(mean_splits KL(p(y|x) || p(y))) over given class
    probabilities (metrics.py:866-906). Returns (mean, std)."""
    n = len(probs)
    scores = []
    for i in range(splits):
        # floor-size splits, tail REMAINDER DROPPED — bug-for-bug with the
        # reference slicing i*(n//splits):(i+1)*(n//splits) (metrics.py:905)
        part = probs[i * (n // splits): (i + 1) * (n // splits)]
        if len(part) == 0:
            continue
        py = part.mean(axis=0, keepdims=True)
        kl = part * (np.log(part + 1e-16) - np.log(py + 1e-16))
        scores.append(np.exp(kl.sum(axis=1).mean()))
    if not scores:
        return float("nan"), float("nan")
    return float(np.mean(scores)), float(np.std(scores))


def calculate_inception_score(images, batch_size: int = 128,
                              splits: int = 10, device: DeviceLike = None):
    """IS over images via the Inception logits tower (metrics.py:835-914).
    Returns (mean, std)."""
    if len(images) == 0:
        return float("nan"), float("nan")
    # the reference's IS pass resizes BILINEAR (torchvision's default for
    # TF.resize with no interpolation argument, metrics.py:873-875) where
    # its FID passes are explicit BICUBIC — mirrored bug-for-bug
    _, logits = InceptionTower.get(device).extract(images, batch_size,
                                                   want_logits=True,
                                                   method="bilinear")
    probs = torch.softmax(torch.from_numpy(logits), dim=-1).numpy()
    return inception_score_from_probs(probs, splits)


def precision_recall_from_features(real_features: np.ndarray,
                                   fake_features: np.ndarray,
                                   k: int = 3, nearest_only: bool = True):
    """kNN-manifold precision/recall (metrics.py:712-736, 917-1039 —
    disabled in the reference pipeline, main.py:845-846, but provided).

    ``nearest_only=True`` (default) is the REFERENCE's variant: a sample
    counts as covered only if its single NEAREST manifold point's k-NN
    ball contains it (metrics.py:726-735) — stricter than Kynkäänniemi
    2019's membership test (ANY manifold ball contains it), which remains
    available via ``nearest_only=False``. Cross-framework lockstep of the
    default is pinned by tests/test_kid_pr_lockstep.py for the JAX package
    and held against it in tests/test_torch_port_metrics.py."""
    if len(real_features) < k + 1 or len(fake_features) < k + 1:
        return float("nan"), float("nan")

    def kth_nn_radii(x):
        d = np.linalg.norm(x[:, None, :] - x[None, :, :], axis=-1)
        np.fill_diagonal(d, np.inf)
        return np.sort(d, axis=1)[:, k - 1]

    def coverage(samples, manifold, radii):
        d = np.linalg.norm(samples[:, None, :] - manifold[None, :, :],
                           axis=-1)
        if nearest_only:
            j = np.argmin(d, axis=1)
            near = d[np.arange(len(samples)), j]
            return float(np.mean(near <= radii[j]))
        return float(np.mean(np.any(d <= radii[None, :], axis=1)))

    r_real = kth_nn_radii(real_features)
    r_fake = kth_nn_radii(fake_features)
    precision = coverage(fake_features, real_features, r_real)
    recall = coverage(real_features, fake_features, r_fake)
    return precision, recall
