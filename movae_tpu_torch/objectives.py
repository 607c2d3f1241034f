"""Objective (loss) library — port of ``movae_tpu/objectives.py``.

Per-pixel-mean reconstruction losses (mse/bce/l1/smooth_l1/perceptual),
their per-image-sum variants, the analytic Gaussian KL divergence and the
integer cross-entropy of the prior stage. Every function is
``(inputs, recons) -> scalar`` (or ``(mu, log_var) -> scalar``), computed in
float32, and layout-agnostic (images are NHWC at the port's public API).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

Tensor = torch.Tensor

# torch.nn.functional.binary_cross_entropy clamps log() at -100; the JAX
# package mirrors that, and so does this port.
_BCE_LOG_CLAMP = -100.0


def _diff(inputs: Tensor, recons: Tensor) -> Tensor:
    return recons.float() - inputs.float()


def mse_per_pixel_mean(inputs: Tensor, recons: Tensor) -> Tensor:
    """Mean squared error, mean over every element."""
    return _diff(inputs, recons).square().mean()


def mse_per_image_sum(inputs: Tensor, recons: Tensor) -> Tensor:
    """MSE summed over features, mean over batch."""
    return _diff(inputs, recons).square().sum() / inputs.shape[0]


def mse_total_batch_sum_scaled(inputs: Tensor, recons: Tensor) -> Tensor:
    """Scaled total MSE."""
    return (_diff(inputs, recons) * 255.0).square().sum() / 255.0


def _bce_elementwise(inputs: Tensor, recons: Tensor) -> Tensor:
    p = recons.float()
    t = inputs.float()
    log_p = torch.clamp(torch.log(p), min=_BCE_LOG_CLAMP)
    log_1mp = torch.clamp(torch.log1p(-p), min=_BCE_LOG_CLAMP)
    return -(t * log_p + (1.0 - t) * log_1mp)


def bce_per_pixel_mean(inputs: Tensor, recons: Tensor) -> Tensor:
    """Binary cross entropy on probabilities, mean reduction."""
    return _bce_elementwise(inputs, recons).mean()


def bce_per_image_sum(inputs: Tensor, recons: Tensor) -> Tensor:
    """BCE summed over features, mean over batch."""
    return _bce_elementwise(inputs, recons).sum() / inputs.shape[0]


def _bce_logits_elementwise(inputs: Tensor, logits: Tensor) -> Tensor:
    x = logits.float()
    t = inputs.float()
    # numerically stable: max(x,0) - x*t + log(1+exp(-|x|))
    return torch.clamp(x, min=0.0) - x * t + torch.log1p(torch.exp(-x.abs()))


def bce_with_logits_per_pixel_mean(inputs: Tensor, recons: Tensor) -> Tensor:
    """BCE with logits, mean reduction."""
    return _bce_logits_elementwise(inputs, recons).mean()


def bce_with_logits_per_image_sum(inputs: Tensor, recons: Tensor) -> Tensor:
    """BCE with logits, per-image sum."""
    return _bce_logits_elementwise(inputs, recons).sum() / inputs.shape[0]


def laplacian_per_pixel_mean(inputs: Tensor, recons: Tensor) -> Tensor:
    """L1 loss, mean reduction."""
    return _diff(inputs, recons).abs().mean()


def laplacian_per_image_sum(inputs: Tensor, recons: Tensor) -> Tensor:
    """L1 loss summed over features, mean over batch."""
    return _diff(inputs, recons).abs().sum() / inputs.shape[0]


def smooth_l1_per_pixel_mean(inputs: Tensor, recons: Tensor,
                             beta: float = 1.0) -> Tensor:
    """Smooth-L1 (Huber, beta=1 as torch's default), mean reduction."""
    d = _diff(inputs, recons).abs()
    return torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta).mean()


def kl_divergence(mu: Tensor, log_var: Tensor) -> Tensor:
    """D_KL(N(mu, e^log_var) || N(0, I)): sum over latents, mean over batch."""
    mu = mu.float()
    log_var = log_var.float()
    kl = -0.5 * torch.sum(1.0 + log_var - mu.square() - log_var.exp(), dim=1)
    return kl.mean()


def integer_cross_entropy(logits: Tensor, labels: Tensor) -> Tensor:
    """Mean CE over integer labels: ``mean(logsumexp(l) - l[label])``."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, labels.long().unsqueeze(-1))[..., 0]
    return (lse - picked).mean()


# ---------------------------------------------------------------------------
# Registry: recons_objective name -> (fn, inferred activation)
# ---------------------------------------------------------------------------

VALID_RECONS_OBJECTIVES = ("mse", "bce", "l1", "smooth_l1", "perceptual")

ReconFn = Callable[[Tensor, Tensor], Tensor]


def get_recon_obj_and_activation(
    recons_objective: str,
    recons_activation: Optional[str] = "tanh",
    use_logits: bool = False,
    perceptual_fn: Optional[ReconFn] = None,
) -> Tuple[Optional[ReconFn], str]:
    """Resolve a reconstruction objective name to ``(loss_fn, activation)``.

    mse/l1/smooth_l1/perceptual default the decoder activation to ``tanh``;
    bce forces ``sigmoid`` (or ``none`` with ``use_logits``). For
    ``"perceptual"`` the loss needs a feature tower that lives in the model;
    callers pass a bound ``perceptual_fn`` or receive ``None``.
    """
    name = recons_objective.lower()
    if name not in VALID_RECONS_OBJECTIVES:
        raise ValueError(
            f"recons_objective must be one of {VALID_RECONS_OBJECTIVES}, "
            f"got {name}")
    if name == "mse":
        return mse_per_pixel_mean, recons_activation or "tanh"
    if name == "bce":
        if use_logits:
            return bce_with_logits_per_pixel_mean, "none"
        return bce_per_pixel_mean, "sigmoid"
    if name == "l1":
        return laplacian_per_pixel_mean, recons_activation or "tanh"
    if name == "smooth_l1":
        return smooth_l1_per_pixel_mean, recons_activation or "tanh"
    return perceptual_fn, recons_activation or "tanh"
