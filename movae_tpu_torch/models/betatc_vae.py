"""Beta-TC-VAE: the total-correlation decomposition of the ELBO (4
objectives) — port of ``movae_tpu/models/betatc_vae.py``.

k4-s2-p1 conv encoder with LeakyReLU(0.01) and no norm, ``fc`` (256 wide,
no activation), ``fc_mu`` / ``fc_var``, ``decoder_input``, transposed-conv
decoder, ``final_layer = (ConvTranspose2d, LeakyReLU, Conv2d k3)``.
``state_dict()`` keys are the layout of
``movae_tpu/utils/torch_export.py:_export_betatc`` plus the anneal counter
``num_iter``, which that layout lacks. ``fc`` flattens, and
``decoder_input`` unflattens, in NCHW ``(c, s, s)`` order.

Objectives: reconstruction_loss, mi_loss, tc_loss, kld. The minibatch-
stratified importance weights keep the reference's quirk: torch's
``view(-1)[::B]`` / ``[1::B]`` address columns 0 and 1 of the B x B matrix,
not its diagonal. The KLD term is annealed linearly over ``anneal_steps``
by the float32 ``num_iter`` buffer, moved up by one in train mode before
use (``VAE._anneal``).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from movae_tpu_torch import objectives as obj_lib
from movae_tpu_torch.models.base import (LambdaWeights, Noise, RestartRows,
                                         compute_region, resolve_activation,
                                         resolve_compute_dtype)
from movae_tpu_torch.models.vae import VAE, _nchw, _nhwc, reset_vae_parameters
from movae_tpu_torch.parallel import mesh as mesh_lib

Tensor = torch.Tensor
_SLOPE = 0.01


def log_density_gaussian(x: Tensor, mu: Tensor, logvar: Tensor) -> Tensor:
    norm = -0.5 * (math.log(2 * math.pi) + logvar)
    return norm - 0.5 * (x - mu).square() * torch.exp(-logvar)


class BetaTCVAE(VAE):
    """Its own layers (``VAE.__init__`` is not run); the VAE's trunk,
    heads, reparameterization, anneal and ``sample``."""

    default_weights = (("reconstruction_loss", 1.0), ("mi_loss", 1.0),
                       ("tc_loss", 1.0), ("kld", 0.00256))

    def __init__(self, latent_dim: int = 128, input_size: int = 32,
                 in_channels: int = 3,
                 hidden_dims: Tuple[int, ...] = (32, 32, 32, 32),
                 anneal_steps: int = 200,
                 dataset_size: Optional[int] = 50000,
                 recons_activation: str = "tanh",
                 recons_objective: str = "mse",
                 lambda_weights: Optional[LambdaWeights] = None,
                 perceptual_fn: Optional[Any] = None,
                 dtype: Any = torch.float32):
        nn.Module.__init__(self)
        self.compute_dtype = resolve_compute_dtype(dtype)
        hd = tuple(hidden_dims)
        self.latent_dim = latent_dim
        self.input_size = input_size
        self.in_channels = in_channels
        self.hidden_dims = hd
        self.anneal_steps = anneal_steps
        self.dataset_size = dataset_size
        self.recons_activation = recons_activation
        self.recons_objective = recons_objective
        self.lambda_weights = tuple(lambda_weights or self.default_weights)
        self.perceptual_fn = perceptual_fn
        c, s = hd[-1], self.spatial_dim

        enc, prev = [], in_channels
        for h in hd:
            enc.append(nn.Sequential(nn.Conv2d(prev, h, 4, stride=2,
                                               padding=1),
                                     nn.LeakyReLU(_SLOPE)))
            prev = h
        self.encoder = nn.Sequential(*enc)
        self.fc = nn.Linear(c * s * s, 256)
        self.fc_mu = nn.Linear(256, latent_dim)
        self.fc_var = nn.Linear(256, latent_dim)
        self.decoder_input = nn.Linear(latent_dim, c * s * s)
        rev = tuple(reversed(hd))
        self.decoder = nn.Sequential(*[
            nn.Sequential(nn.ConvTranspose2d(rev[i], rev[i + 1], 3, stride=2,
                                             padding=1, output_padding=1),
                          nn.LeakyReLU(_SLOPE))
            for i in range(len(rev) - 1)])
        self.final_layer = nn.Sequential(
            nn.ConvTranspose2d(rev[-1], rev[-1], 3, stride=2, padding=1,
                               output_padding=1),
            nn.LeakyReLU(_SLOPE),
            nn.Conv2d(rev[-1], in_channels, 3, padding=1))
        self.register_buffer("num_iter", torch.zeros(()))
        self._act = resolve_activation(recons_activation)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        reset_vae_parameters(self, generator)

    @property
    def objective_names(self) -> Tuple[str, ...]:
        return ("reconstruction_loss", "mi_loss", "tc_loss", "kld")

    def encode(self, x: Tensor, train: bool = False, stats=None
               ) -> Tuple[Tensor, Tensor]:
        """NHWC images -> float32 (mu, log_var), computed in
        ``compute_dtype``."""
        with compute_region(self.compute_dtype, x.device):
            h = self.fc(self.encoder(_nchw(x, self.compute_dtype)).flatten(1))
            mu, log_var = self.fc_mu(h), self.fc_var(h)
        return mu.float(), log_var.float()

    def decode(self, z: Tensor, train: bool = False, stats=None) -> Tensor:
        s = self.spatial_dim
        with compute_region(self.compute_dtype, z.device):
            h = self.decoder_input(z.to(self.compute_dtype)).reshape(
                z.shape[0], self.hidden_dims[-1], s, s)
            h = self._act(self.final_layer(self.decoder(h)))
        return _nhwc(h.float())

    def heads(self, features, aux, x: Tensor, train: bool = False,
              generator: Optional[torch.Generator] = None,
              restart_rows: RestartRows = None,
              noise: Noise = None) -> Dict[str, Any]:
        out = super().heads(features, aux, x, train=train,
                            generator=generator, noise=noise)
        out["is_training"] = train
        return out

    def _recon_fn(self):
        fn, _ = obj_lib.get_recon_obj_and_activation(
            self.recons_objective, self.recons_activation)
        return fn

    def loss_terms(self, x: Tensor, outputs: Dict[str, Any]
                   ) -> Dict[str, Tensor]:
        lw = dict(self.lambda_weights)
        recons = outputs["recons"]
        # the pairwise estimate couples the rows: over the global batch in
        # a data-parallel step (a differentiable gather)
        mu, log_var, z = (mesh_lib.gather_batch(outputs[k])
                          for k in ("mu", "log_var", "z"))
        b = z.shape[0]
        dataset_size = float(self.dataset_size or 50000)

        recons_loss = self._recon_fn()(x, recons)
        log_q_zx = log_density_gaussian(z, mu, log_var).sum(1)
        zeros = torch.zeros_like(z)
        log_p_z = log_density_gaussian(z, zeros, zeros).sum(1)
        mat = log_density_gaussian(z[:, None, :], mu[None, :, :],
                                   log_var[None, :, :])  # (B, B, D)
        strat = (dataset_size - b + 1) / (dataset_size * (b - 1))
        # built by selection on the device: writing Python scalars into
        # single elements of a CUDA tensor copies each from the host
        col = torch.arange(b, device=z.device)
        row = col[:, None]
        iw = torch.full((b, b), 1.0 / (b - 1), dtype=torch.float32,
                        device=z.device)
        iw = torch.where(col == 0, 1.0 / dataset_size, iw)
        iw = torch.where(col == 1, strat, iw)
        iw = torch.where((row == b - 2) & (col == 0), strat, iw)
        mat = mat + iw.log()[:, :, None]
        log_q_z = torch.logsumexp(mat.sum(2), dim=1)
        log_prod_q_z = torch.logsumexp(mat, dim=1).sum(1)

        mi_loss = (log_q_zx - log_q_z).mean()
        tc_loss = (log_q_z - log_prod_q_z).mean()
        kld_loss = (log_prod_q_z - log_p_z).mean()
        anneal = self._anneal(outputs, self.anneal_steps)
        return {"reconstruction_loss": lw["reconstruction_loss"] * recons_loss,
                "mi_loss": lw["mi_loss"] * mi_loss,
                "tc_loss": lw["tc_loss"] * tc_loss,
                "kld": lw["kld"] * anneal * kld_loss}
