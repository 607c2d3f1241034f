"""Gradient-guided VQ-VAE, versions v1-v8 — port of
``movae_tpu/models/gg_vq_vae.py``.

The VQ-VAE plus ``gradient_guided_loss`` (the input-edge-weighted pixel
MSE) and, for v2-v8, an ``edge_matching_loss`` chosen by version
(``movae_tpu_torch/ops/sobel.py:GG_VQVAE_EDGE_FNS``). The weights are the
VQ-VAE's. Objectives, in this order (positional lambda lists, aggregator
task indices and ``task_i_weight`` depend on it): reconstruction_loss,
embedding_loss (not with the EMA codebook), commitment_loss,
gradient_guided_loss[, edge_matching_loss].
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from movae_tpu_torch.models.vq_vae import VQVAE
from movae_tpu_torch.ops import sobel

Tensor = torch.Tensor


class GGVQVAE(VQVAE):

    def __init__(self, *args, version: str = "v1", **kwargs):
        super().__init__(*args, **kwargs)
        self.version = version

    @property
    def objective_names(self) -> Tuple[str, ...]:
        emb = () if self.vq_ema else ("embedding_loss",)
        base = ("reconstruction_loss", *emb, "commitment_loss",
                "gradient_guided_loss")
        return base if self.version == "v1" else base + ("edge_matching_loss",)

    def _extra_loss(self, key: str, x: Tensor, outputs: Dict[str, Any]
                    ) -> Tensor:
        if key == "gradient_guided_loss":
            return sobel.edge_weighted_pixel_loss(x, outputs["recons"])
        if key == "edge_matching_loss":
            return sobel.GG_VQVAE_EDGE_FNS[self.version](x, outputs["recons"])
        raise KeyError(key)
