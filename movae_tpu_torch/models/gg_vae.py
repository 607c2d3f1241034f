"""Gradient-guided VAE, versions 1, 2, 3, 5 and 6 — port of
``movae_tpu/models/gg_vae.py``.

The VAE plus ``gradient_guided_loss`` (the input-edge-weighted pixel MSE)
and an ``edge_matching_loss`` chosen by version
(``movae_tpu_torch/ops/sobel.py:GG_VAE_EDGE_FNS``, the magnitude loss for a
version the table lacks). The weights are the VAE's. Objectives, in this
order: reconstruction_loss, kld_loss, gradient_guided_loss,
edge_matching_loss.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from movae_tpu_torch import objectives as obj_lib
from movae_tpu_torch.models.vae import VAE
from movae_tpu_torch.ops import sobel

Tensor = torch.Tensor


class GGVAE(VAE):

    default_weights = (("reconstruction_loss", 1.0), ("kld_loss", 0.00025),
                       ("gradient_guided_loss", 1.0),
                       ("edge_matching_loss", 1.0))

    def __init__(self, *args, edge_matching_version: int = 1, **kwargs):
        super().__init__(*args, **kwargs)
        self.edge_matching_version = edge_matching_version

    @property
    def objective_names(self) -> Tuple[str, ...]:
        return ("reconstruction_loss", "kld_loss", "gradient_guided_loss",
                "edge_matching_loss")

    def loss_terms(self, x: Tensor, outputs: Dict[str, Any]
                   ) -> Dict[str, Tensor]:
        lw = dict(self.lambda_weights)
        recons = outputs["recons"]
        edge_fn = sobel.GG_VAE_EDGE_FNS.get(self.edge_matching_version,
                                            sobel.edge_matching_magnitude)
        return {
            "reconstruction_loss":
                lw["reconstruction_loss"] * self._recon_fn()(x, recons),
            "kld_loss": lw["kld_loss"] * obj_lib.kl_divergence(
                outputs["mu"], outputs["log_var"]),
            "gradient_guided_loss": lw["gradient_guided_loss"]
            * sobel.edge_weighted_pixel_loss(x, recons),
            "edge_matching_loss":
                lw["edge_matching_loss"] * edge_fn(x, recons),
        }
