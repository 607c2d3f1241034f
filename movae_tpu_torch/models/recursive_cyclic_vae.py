"""Recursive-Cyclic VAE: reconstruction + annealed recursive KL + latent
cycle consistency — port of
``movae_tpu/models/recursive_cyclic_vae.py``.

Branch A is the recursive-KL VAE's (``models/recursive_kl_vae.py``, its
anneal counter included), branch B the cycle VAE's
(``models/cycle_vae.py``). ``feature_names = None``. The encoder runs three
times a step, each pass starting from the previous one's BatchNorm
statistics. Draws, in this order: ``eps``, then ``z_prior``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from movae_tpu_torch import objectives as obj_lib
from movae_tpu_torch.models.base import Noise, RestartRows
from movae_tpu_torch.models.cycle_vae import cycle_branch, cycle_loss
from movae_tpu_torch.models.recursive_kl_vae import RecursiveKLVAE

Tensor = torch.Tensor


class RecursiveCyclicVAE(RecursiveKLVAE):

    default_weights = (("reconstruction_loss", 1.0),
                       ("recursive_kld_loss", 0.00025),
                       ("cycle_loss", 0.00025))

    @property
    def objective_names(self) -> Tuple[str, ...]:
        return ("reconstruction_loss", "recursive_kld_loss", "cycle_loss")

    def forward(self, x: Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None,
                restart_rows: RestartRows = None,
                noise: Noise = None) -> Dict[str, Any]:
        stats: Dict[str, Tensor] = {}
        out = self._recursive(x, train, stats, generator, noise)
        cycle_branch(self, out, x.shape[0], train, stats, generator, noise)
        return self._with_stats(out, train, stats)

    def loss_terms(self, x: Tensor, outputs: Dict[str, Any]
                   ) -> Dict[str, Tensor]:
        lw = dict(self.lambda_weights)
        recon = self._recon_fn()(x, outputs["recons"])
        rec_kld = obj_lib.kl_divergence(outputs["mu_hat"],
                                        outputs["log_var_hat"])
        cyc = cycle_loss(outputs["z_prior"], outputs["mu_gen"])
        anneal = self._anneal(outputs, self.recursive_kld_anneal_steps)
        return {"reconstruction_loss": lw["reconstruction_loss"] * recon,
                "recursive_kld_loss":
                    anneal * lw["recursive_kld_loss"] * rec_kld,
                "cycle_loss": lw["cycle_loss"] * cyc}
