"""Vanilla VAE with a decomposed (reconstruction, KL) objective — port of
``movae_tpu/models/vae.py``.

Stride-2 k3 conv encoder over ``hidden_dims``, each conv followed by a norm
and LeakyReLU(0.01); linear ``mu`` / ``log_var`` heads; ``decoder_input``;
mirrored ``ConvTranspose2d(k3, s2, p1, output_padding=1)`` blocks; a final
transposed conv, norm, LeakyReLU and k3 conv, then the output activation.
Submodules are named so that ``state_dict()`` keys equal the reference-torch
layout of ``movae_tpu/utils/torch_export.py:_export_vae``: ``encoder.{i}.
{0,1}``, ``mu``, ``log_var``, ``decoder_input``, ``decoder.{1+i}.{0,1}``,
``final_layer.{0,1,3}``. The dense heads flatten, and ``decoder_input``
unflattens, in NCHW ``(c, s, s)`` order, the order of that layout.

Images are NHWC at the public methods; the convolutions run NCHW inside.

BatchNorm is :class:`TorchBatchNorm`: its running statistics are never
written during a forward. Each train-mode norm call puts its new
statistics into a dict of pending updates, keyed like ``state_dict()``, and
the next call of the same norm in that forward starts from them (the second
encoder pass of the cycle and recursive VAEs). The dict leaves the model as
``outputs["batch_stats"]``, which the train step commits only on a finite
step. The trunk hands its updates to the heads through ``aux``.

Noise: ``heads`` draws the reparameterization's ``eps`` from ``generator``,
or takes ``noise["eps"]`` (:func:`draw_normal`); ``sample`` draws its z the
same way.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from movae_tpu_torch import objectives as obj_lib
from movae_tpu_torch.models.base import (LambdaWeights, MOVAEModel, Noise,
                                         RestartRows, compute_region, draw,
                                         resolve_activation,
                                         resolve_compute_dtype)
from movae_tpu_torch.models.vq_vae import (_TRUNC_STD_CORRECTION,
                                           reset_conv_parameters)
from movae_tpu_torch.parallel import mesh as mesh_lib

Tensor = torch.Tensor
Stats = Optional[Dict[str, Tensor]]
_SLOPE = 0.01


def draw_normal(name: str, shape: Sequence[int],
                generator: Optional[torch.Generator], noise: Noise,
                device: torch.device) -> Tensor:
    """A float32 N(0, I) draw of ``shape``: ``noise[name]`` when given, else
    a draw from ``generator`` (:func:`models.base.draw`)."""
    return draw(name, "randn", shape, generator, noise, device)


class TorchBatchNorm(nn.Module):
    """``nn.BatchNorm2d`` (NCHW) with the JAX package's ``TorchBatchNorm``
    semantics: normalization by the biased batch variance, the running
    variance accumulating the unbiased one, keep-fraction ``momentum`` 0.9
    (torch's 0.1), eps 1e-5. The running statistics update functionally
    (see the module docstring); ``num_batches_tracked`` is kept for the
    reference layout and stays 0, as the JAX exporter writes it. A bf16
    input is normalized in float32 and the output returned in bf16, as the
    JAX module does with ``dtype=bfloat16``."""

    def __init__(self, num_features: int, momentum: float = 0.9,
                 eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.prefix = ""  # this module's state_dict prefix, set by the model
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.register_buffer("num_batches_tracked",
                             torch.zeros((), dtype=torch.long))

    @torch.no_grad()
    def reset_parameters(self) -> None:
        self.weight.fill_(1.0)
        self.bias.zero_()
        self.running_mean.zero_()
        self.running_var.fill_(1.0)
        self.num_batches_tracked.zero_()

    def forward(self, x: Tensor, train: bool, stats: Stats) -> Tensor:
        xf = x.float()
        if not train:
            return F.batch_norm(xf, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0,
                                self.eps).to(x.dtype)
        if mesh_lib.active_data_parallel() is not None:
            return self._forward_global(x, xf, stats)
        y = F.batch_norm(xf, None, None, self.weight, self.bias, True, 0.0,
                         self.eps)
        if stats is not None:
            with torch.no_grad():
                var, mean = torch.var_mean(xf, dim=(0, 2, 3),
                                           unbiased=False)
                self._update_running(stats, mean, var,
                                     x.numel() // x.shape[1])
        return y.to(x.dtype)

    def _forward_global(self, x: Tensor, xf: Tensor, stats: Stats
                        ) -> Tensor:
        """Train mode over the global batch of a data-parallel step: the
        mean and the biased variance from per-rank sums all-reduced
        (differentiable, two passes), so every rank normalizes with the
        statistics one device computes on the whole batch."""
        n = mesh_lib.global_batch_size(x.shape[0]) * x.shape[2] * x.shape[3]
        mean = mesh_lib.sum_over_batch(xf.sum((0, 2, 3))) / n
        d = xf - mean[None, :, None, None]
        var = mesh_lib.sum_over_batch(d.square().sum((0, 2, 3))) / n
        y = (d * torch.rsqrt(var + self.eps)[None, :, None, None]
             * self.weight[None, :, None, None]
             + self.bias[None, :, None, None])
        if stats is not None:
            with torch.no_grad():
                self._update_running(stats, mean.detach(), var.detach(), n)
        return y.to(x.dtype)

    @torch.no_grad()
    def _update_running(self, stats: Stats, mean: Tensor, var: Tensor,
                        n: int) -> None:
        """The pending running statistics from a batch's mean and biased
        variance over ``n`` values a channel (the running variance
        unbiased)."""
        unbiased = var * (n / max(n - 1, 1))
        m = self.momentum
        for name, batch in (("running_mean", mean),
                            ("running_var", unbiased)):
            key = self.prefix + name
            old = stats.get(key, getattr(self, name))
            stats[key] = m * old + (1.0 - m) * batch


class ChannelLayerNorm(nn.Module):
    """Flax ``nn.LayerNorm`` on NHWC features, here on NCHW ones: normalizes
    each position over the channel axis alone, eps 1e-6, variance as
    E[x^2] - E[x]^2 clipped at 0 (flax's fast variance); in float32, the
    output in the input's dtype (flax's ``LayerNorm(dtype=)``)."""

    def __init__(self, num_features: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))

    @torch.no_grad()
    def reset_parameters(self) -> None:
        self.weight.fill_(1.0)
        self.bias.zero_()

    def forward(self, x: Tensor, train: bool, stats: Stats) -> Tensor:
        xf = x.float()
        mean = xf.mean(1, keepdim=True)
        var = ((xf * xf).mean(1, keepdim=True) - mean * mean).clamp(min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight[:, None, None]
        return ((xf - mean) * mul + self.bias[:, None, None]).to(x.dtype)


def make_norm(kind: Optional[str], channels: int) -> nn.Module:
    """``layer_norm`` -> the norm module of one block (``none``: an
    ``nn.Identity`` that holds the block's index 1)."""
    kind = (kind or "none").lower()
    if kind == "batch":
        return TorchBatchNorm(channels)
    if kind == "layer":
        return ChannelLayerNorm(channels)
    if kind == "none":
        return nn.Identity()
    raise ValueError(f"Layer norm {kind} not supported")


@torch.no_grad()
def reset_vae_parameters(module: nn.Module,
                         generator: torch.Generator) -> None:
    """The JAX package's initializers: lecun-normal (truncated) kernels of
    every conv and dense layer, zero biases, unit norm scales, fresh
    running statistics and counters."""
    reset_conv_parameters(module, generator)
    for mod in module.modules():
        if isinstance(mod, nn.Linear):
            std = math.sqrt(1.0 / mod.in_features) / _TRUNC_STD_CORRECTION
            nn.init.trunc_normal_(mod.weight, 0.0, std, -2.0 * std,
                                  2.0 * std, generator=generator)
            mod.bias.zero_()
        elif isinstance(mod, (TorchBatchNorm, ChannelLayerNorm)):
            mod.reset_parameters()
    for name, buf in module.named_buffers():
        if name.endswith("num_iter"):
            buf.zero_()


def _nchw(x: Tensor, dtype: torch.dtype = torch.float32) -> Tensor:
    return x.to(dtype).permute(0, 3, 1, 2)


def _nhwc(x: Tensor) -> Tensor:
    return x.permute(0, 2, 3, 1)


class VAE(MOVAEModel):

    feature_names = ("mu", "log_var")
    # the JAX class's own weights (the registry always passes its own)
    default_weights: LambdaWeights = (("reconstruction_loss", 1.0),
                                      ("kld_loss", 0.00025))

    def __init__(self, latent_dim: int = 128, input_size: int = 32,
                 in_channels: int = 3,
                 hidden_dims: Tuple[int, ...] = (32, 64, 128, 256, 512),
                 layer_norm: str = "batch", recons_activation: str = "tanh",
                 recons_objective: str = "mse",
                 lambda_weights: Optional[LambdaWeights] = None,
                 perceptual_fn: Optional[Any] = None,
                 dtype: Any = torch.float32):
        super().__init__()
        self.compute_dtype = resolve_compute_dtype(dtype)
        hd = tuple(hidden_dims)
        self.latent_dim = latent_dim
        self.input_size = input_size
        self.in_channels = in_channels
        self.hidden_dims = hd
        self.layer_norm = layer_norm
        self.recons_activation = recons_activation
        self.recons_objective = recons_objective
        self.lambda_weights = tuple(lambda_weights or self.default_weights)
        self.perceptual_fn = perceptual_fn
        c, s = hd[-1], self.spatial_dim

        enc, prev = [], in_channels
        for h in hd:
            enc.append(nn.Sequential(
                nn.Conv2d(prev, h, 3, stride=2, padding=1),
                make_norm(layer_norm, h), nn.LeakyReLU(_SLOPE)))
            prev = h
        self.encoder = nn.ModuleList(enc)
        self.mu = nn.Linear(c * s * s, latent_dim)
        self.log_var = nn.Linear(c * s * s, latent_dim)
        self.decoder_input = nn.Linear(latent_dim, c * s * s)
        rev = tuple(reversed(hd))
        dec = [nn.Unflatten(1, (c, s, s))]
        for i in range(len(rev) - 1):
            dec.append(nn.Sequential(
                nn.ConvTranspose2d(rev[i], rev[i + 1], 3, stride=2, padding=1,
                                   output_padding=1),
                make_norm(layer_norm, rev[i + 1]), nn.LeakyReLU(_SLOPE)))
        self.decoder = nn.ModuleList(dec)
        self.final_layer = nn.Sequential(
            nn.ConvTranspose2d(rev[-1], rev[-1], 3, stride=2, padding=1,
                               output_padding=1),
            make_norm(layer_norm, rev[-1]), nn.LeakyReLU(_SLOPE),
            nn.Conv2d(rev[-1], in_channels, 3, padding=1))
        self._act = resolve_activation(recons_activation)
        for name, mod in self.named_modules():
            if isinstance(mod, TorchBatchNorm):
                mod.prefix = f"{name}."

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        reset_vae_parameters(self, generator)

    @property
    def objective_names(self) -> Tuple[str, ...]:
        return ("reconstruction_loss", "kld_loss")

    @property
    def spatial_dim(self) -> int:
        return self.input_size // (2 ** len(self.hidden_dims))

    # --- encoder / decoder (NHWC at the public methods) -------------------
    @staticmethod
    def _block(block: nn.Sequential, h: Tensor, train: bool,
               stats: Stats) -> Tensor:
        """conv -> norm -> LeakyReLU of one ``Sequential(conv, norm, ...)``."""
        h = block[0](h)
        if not isinstance(block[1], nn.Identity):
            h = block[1](h, train, stats)
        return F.leaky_relu(h, _SLOPE)

    def encode(self, x: Tensor, train: bool = False, stats: Stats = None
               ) -> Tuple[Tensor, Tensor]:
        """NHWC images -> float32 (mu, log_var), computed in
        ``compute_dtype``; train-mode norms write their new statistics into
        ``stats``."""
        with compute_region(self.compute_dtype, x.device):
            h = _nchw(x, self.compute_dtype)
            for block in self.encoder:
                h = self._block(block, h, train, stats)
            h = h.flatten(1)
            mu, log_var = self.mu(h), self.log_var(h)
        return mu.float(), log_var.float()

    def decode(self, z: Tensor, train: bool = False, stats: Stats = None
               ) -> Tensor:
        """(B, latent_dim) -> float32 NHWC images, computed in
        ``compute_dtype``."""
        with compute_region(self.compute_dtype, z.device):
            h = self.decoder[0](self.decoder_input(z.to(self.compute_dtype)))
            for block in self.decoder[1:]:
                h = self._block(block, h, train, stats)
            h = self._act(self.final_layer[3](self._block(
                self.final_layer, h, train, stats)))
        return _nhwc(h.float())

    def reparameterize(self, mu: Tensor, log_var: Tensor,
                       generator: Optional[torch.Generator] = None,
                       noise: Noise = None) -> Tensor:
        eps = draw_normal("eps", mu.shape, generator, noise, mu.device)
        return mu + eps * torch.exp(0.5 * log_var)

    # --- trunk / heads ------------------------------------------------------
    def trunk(self, x: Tensor, train: bool = False):
        stats: Dict[str, Tensor] = {}
        mu, log_var = self.encode(x, train=train, stats=stats)
        return (mu, log_var), stats

    def heads(self, features, aux, x: Tensor, train: bool = False,
              generator: Optional[torch.Generator] = None,
              restart_rows: RestartRows = None,
              noise: Noise = None) -> Dict[str, Any]:
        mu, log_var = features
        stats = dict(aux or {})
        z = self.reparameterize(mu, log_var, generator, noise)
        out = {"recons": self.decode(z, train=train, stats=stats), "mu": mu,
               "log_var": log_var, "z": z}
        return self._with_stats(out, train, stats)

    @staticmethod
    def _with_stats(out: Dict[str, Any], train: bool,
                    stats: Dict[str, Tensor]) -> Dict[str, Any]:
        if train and stats:
            out["batch_stats"] = stats
        return out

    # --- losses ------------------------------------------------------------
    def _recon_fn(self):
        if self.recons_objective.lower() == "perceptual":
            if self.perceptual_fn is None:
                raise ValueError(
                    "recons_objective='perceptual' requires perceptual_fn "
                    "(built by the registry from movae_tpu_torch.metrics.vgg)")
            return self.perceptual_fn
        fn, _ = obj_lib.get_recon_obj_and_activation(
            self.recons_objective, self.recons_activation)
        return fn

    def loss_terms(self, x: Tensor, outputs: Dict[str, Any]
                   ) -> Dict[str, Tensor]:
        lw = dict(self.lambda_weights)
        recon = self._recon_fn()(x, outputs["recons"])
        kld = obj_lib.kl_divergence(outputs["mu"], outputs["log_var"])
        return {"reconstruction_loss": lw["reconstruction_loss"] * recon,
                "kld_loss": lw["kld_loss"] * kld}

    def _anneal(self, outputs: Dict[str, Any], steps: int):
        """The linear KLD anneal of the counter models: in train mode the
        ``num_iter`` counter moves up by one (into the pending
        ``outputs["batch_stats"]``) and min(num_iter / steps, 1) is
        returned; in eval mode 1.0, the counter untouched."""
        if not outputs.get("is_training", False):
            return 1.0
        stats = outputs.setdefault("batch_stats", {})
        n = stats.get("num_iter", self.num_iter) + 1.0
        stats["num_iter"] = n
        return torch.clamp(n / steps, max=1.0)

    # --- generation ----------------------------------------------------------
    def sample(self, num_samples: int,
               generator: Optional[torch.Generator] = None,
               noise: Noise = None) -> Tensor:
        """Decode N(0, I) latents (``noise["z"]`` where given) in eval
        mode."""
        z = draw_normal("z", (num_samples, self.latent_dim), generator, noise,
                        self.decoder_input.weight.device)
        return self.decode(z, train=False)
