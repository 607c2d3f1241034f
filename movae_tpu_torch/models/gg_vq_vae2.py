"""Gradient-guided VQ-VAE-2 — port of ``movae_tpu/models/gg_vq_vae2.py``.

The VQ-VAE-2 plus the GG-VQ-VAE "v3" pair of losses: ``gradient_guided_loss``
(the input-edge-weighted pixel MSE) and ``edge_matching_loss`` (smooth-L1
on Sobel gradient magnitudes). The weights are the VQ-VAE-2's. Objectives,
in this order: reconstruction_loss, commitment_loss, embedding_loss (not
with the EMA codebooks), gradient_guided_loss, edge_matching_loss.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from movae_tpu_torch.models.vq_vae2 import VQVAE2
from movae_tpu_torch.ops import sobel

Tensor = torch.Tensor


class GGVQVAE2(VQVAE2):

    version = "v3"

    @property
    def objective_names(self) -> Tuple[str, ...]:
        emb = () if self.vq_ema else ("embedding_loss",)
        return ("reconstruction_loss", "commitment_loss", *emb,
                "gradient_guided_loss", "edge_matching_loss")

    def _extra_loss(self, key: str, x: Tensor, outputs: Dict[str, Any]
                    ) -> Tensor:
        if key == "gradient_guided_loss":
            return sobel.edge_weighted_pixel_loss(x, outputs["recons"])
        if key == "edge_matching_loss":
            return sobel.GG_VQVAE_EDGE_FNS[self.version](x, outputs["recons"])
        raise KeyError(key)
