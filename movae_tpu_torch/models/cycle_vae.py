"""Cycle VAE: reconstruction + latent cycle consistency (no KL) — port of
``movae_tpu/models/cycle_vae.py``.

A second branch decodes ``z_prior ~ N(0, I)``, re-encodes the result and
penalizes ``||z_prior - mu_gen||^2`` (sum over latents, mean over batch).
``feature_names = None``: the train step takes the full-parameter
Jacobian. The encoder runs twice a step, the second pass starting from the
first pass's BatchNorm statistics. Draws, in this order: ``eps`` (the
reparameterization), then ``z_prior`` — each from ``generator`` or from
``noise``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from movae_tpu_torch.models.base import Noise, RestartRows
from movae_tpu_torch.models.vae import VAE, draw_normal

Tensor = torch.Tensor


def cycle_loss(z_prior: Tensor, mu_gen: Tensor) -> Tensor:
    return (z_prior - mu_gen).square().sum(1).mean()


def cycle_branch(model: VAE, out: Dict[str, Any], batch: int, train: bool,
                 stats: Dict[str, Tensor],
                 generator: Optional[torch.Generator], noise: Noise) -> None:
    """The cycle branch: decode ``z_prior``, re-encode the result; its
    tensors go into ``out``."""
    z_prior = draw_normal("z_prior", (batch, model.latent_dim), generator,
                          noise, out["mu"].device)
    x_gen = model.decode(z_prior, train=train, stats=stats)
    mu_gen, log_var_gen = model.encode(x_gen, train=train, stats=stats)
    out.update(z_prior=z_prior, x_gen=x_gen, mu_gen=mu_gen,
               log_var_gen=log_var_gen)


class CycleVAE(VAE):

    default_weights = (("reconstruction_loss", 1.0), ("cycle_loss", 0.00025))

    feature_names = None

    @property
    def objective_names(self) -> Tuple[str, ...]:
        return ("reconstruction_loss", "cycle_loss")

    def forward(self, x: Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None,
                restart_rows: RestartRows = None,
                noise: Noise = None) -> Dict[str, Any]:
        stats: Dict[str, Tensor] = {}
        mu, log_var = self.encode(x, train=train, stats=stats)
        z = self.reparameterize(mu, log_var, generator, noise)
        out = {"recons": self.decode(z, train=train, stats=stats), "mu": mu,
               "log_var": log_var, "z": z}
        cycle_branch(self, out, x.shape[0], train, stats, generator, noise)
        return self._with_stats(out, train, stats)

    def loss_terms(self, x: Tensor, outputs: Dict[str, Any]
                   ) -> Dict[str, Tensor]:
        lw = dict(self.lambda_weights)
        recon = self._recon_fn()(x, outputs["recons"])
        cyc = cycle_loss(outputs["z_prior"], outputs["mu_gen"])
        return {"reconstruction_loss": lw["reconstruction_loss"] * recon,
                "cycle_loss": lw["cycle_loss"] * cyc}
