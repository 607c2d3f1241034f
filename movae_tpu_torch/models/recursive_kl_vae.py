"""Recursive-KL VAE — port of ``movae_tpu/models/recursive_kl_vae.py``.

The KL term is taken on the re-encoded reconstruction
``enc(dec(enc(x)))``, with a linear 0 -> lambda anneal over
``recursive_kld_anneal_steps``. ``feature_names = None``: the train step
takes the full-parameter Jacobian. The anneal counter ``num_iter`` is a
float32 buffer that starts at 0; a train-mode ``loss_terms`` returns it
moved up by one in ``outputs["batch_stats"]`` (the step commits it) and
uses the new value. The encoder runs twice a step, the second pass
starting from the first pass's BatchNorm statistics.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from movae_tpu_torch import objectives as obj_lib
from movae_tpu_torch.models.base import Noise, RestartRows
from movae_tpu_torch.models.vae import VAE

Tensor = torch.Tensor


class RecursiveKLVAE(VAE):

    default_weights = (("reconstruction_loss", 1.0),
                       ("recursive_kld_loss", 0.00025))

    feature_names = None

    def __init__(self, *args, recursive_kld_anneal_steps: int = 25000,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.recursive_kld_anneal_steps = recursive_kld_anneal_steps
        self.register_buffer("num_iter", torch.zeros(()))

    @property
    def objective_names(self) -> Tuple[str, ...]:
        return ("reconstruction_loss", "recursive_kld_loss")

    def _recursive(self, x: Tensor, train: bool, stats: Dict[str, Tensor],
                   generator: Optional[torch.Generator], noise: Noise
                   ) -> Dict[str, Any]:
        """Encode, reparameterize, decode, re-encode the reconstruction."""
        mu, log_var = self.encode(x, train=train, stats=stats)
        z = self.reparameterize(mu, log_var, generator, noise)
        recons = self.decode(z, train=train, stats=stats)
        mu_hat, log_var_hat = self.encode(recons, train=train, stats=stats)
        return {"recons": recons, "mu": mu, "log_var": log_var, "z": z,
                "mu_hat": mu_hat, "log_var_hat": log_var_hat,
                "is_training": train}

    def forward(self, x: Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None,
                restart_rows: RestartRows = None,
                noise: Noise = None) -> Dict[str, Any]:
        stats: Dict[str, Tensor] = {}
        out = self._recursive(x, train, stats, generator, noise)
        return self._with_stats(out, train, stats)

    def loss_terms(self, x: Tensor, outputs: Dict[str, Any]
                   ) -> Dict[str, Tensor]:
        lw = dict(self.lambda_weights)
        recon = self._recon_fn()(x, outputs["recons"])
        rec_kld = obj_lib.kl_divergence(outputs["mu_hat"],
                                        outputs["log_var_hat"])
        anneal = self._anneal(outputs, self.recursive_kld_anneal_steps)
        return {"reconstruction_loss": lw["reconstruction_loss"] * recon,
                "recursive_kld_loss":
                    anneal * lw["recursive_kld_loss"] * rec_kld}
