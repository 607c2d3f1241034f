"""VQ-VAE with (reconstruction, embedding, commitment) objectives — port of
``movae_tpu/models/vq_vae.py``.

k4-s2 conv downsample per hidden dim, a k3 conv, ``num_residual_layers``
residual blocks (k3 + k1), a 1x1 projection to the embedding dim, the
vector quantizer (``movae_tpu_torch.ops.vq``, whose nearest-code search is
the hand-written CUDA kernel on the card) and the mirrored decoder.

Images, ``encoding`` and ``quantized`` are NHWC at the public methods, so
the flattened VQ rows come out in the JAX package's ``encoding_inds`` order;
the convolutions run NCHW inside. Submodules are named so that
``state_dict()`` keys equal the reference-torch layout of
``movae_tpu/utils/torch_export.py:_export_vqvae``: ``encoder.{i}.0``,
``encoder.{H+1+r}.resblock.{0,2}``, ``vq_layer.embedding.weight``,
``decoder.{...}``. Geometry: k4-s2-p1 convs, ``ConvTranspose2d(k4, s2, p1)``
(flax's ``SAME`` transpose with the kernel flipped), leaky-relu slope 0.01.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from movae_tpu_torch import objectives as obj_lib
from movae_tpu_torch.models.base import (LambdaWeights, MOVAEModel,
                                         RestartRows, resolve_activation)
from movae_tpu_torch.ops import vq as vq_ops

Tensor = torch.Tensor
_SLOPE = 0.01
# flax's lecun_normal: truncated normal at +-2 std, rescaled to unit variance
_TRUNC_STD_CORRECTION = 0.87962566103423978


class ResidualLayer(nn.Module):
    """k3 conv -> ReLU -> k1 conv residual block, both without bias."""

    def __init__(self, channels: int):
        super().__init__()
        self.resblock = nn.Sequential(
            nn.Conv2d(channels, channels, 3, padding=1, bias=False),
            nn.ReLU(),
            nn.Conv2d(channels, channels, 1, bias=False))

    def forward(self, x: Tensor) -> Tensor:
        return x + self.resblock(x)


class Codebook(nn.Module):
    """Learnable codebook, init U(-1/K, 1/K).

    ``ema=True`` maintains the codebook by exponential moving averages
    (van den Oord 2017, appendix A.1) instead of the embedding loss: the
    codebook stops being a gradient parameter, and the EMA cluster counts and
    embedding sums ride beside it as buffers. :meth:`ema_update` returns the
    step's new values; the train step commits them (non-finite guard)."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 ema: bool = False, ema_decay: float = 0.99,
                 ema_restart_threshold: float = 0.01):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.ema = ema
        self.ema_decay = ema_decay
        # dead-code restart: codes whose EMA count decays below the
        # threshold are re-seeded from random batch latents
        self.ema_restart_threshold = ema_restart_threshold
        self.embedding = nn.Embedding(num_embeddings, embedding_dim)
        if ema:
            self.embedding.weight.requires_grad_(False)
            self.register_buffer("cluster_size",
                                 torch.zeros(num_embeddings))
            self.register_buffer("ema_embed",
                                 torch.zeros(num_embeddings, embedding_dim))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        k = self.num_embeddings
        self.embedding.weight.uniform_(-1.0 / k, 1.0 / k, generator=generator)
        if self.ema:
            self.cluster_size.zero_()
            self.ema_embed.copy_(self.embedding.weight)

    def forward(self) -> Tensor:
        return self.embedding.weight

    def embed_code(self, code: Tensor) -> Tensor:
        return F.embedding(code.long(), self.embedding.weight)

    @torch.no_grad()
    def ema_update(self, z_flat: Tensor, inds: Tensor,
                   generator: Optional[torch.Generator] = None,
                   restart_rows: Optional[Tensor] = None
                   ) -> Dict[str, Tensor]:
        """EMA decay update from this batch's assignments plus dead-code
        restart; returns the new state, keyed like ``state_dict()``.

        A dead code restarts from the latent row ``rows[k]``: ``rows`` is
        ``restart_rows`` when given ((K,) indices into ``z_flat``), else a
        draw from ``generator`` (the JAX package draws it from its
        ``sample`` stream, which torch cannot reproduce)."""
        z_flat = z_flat.detach().float()
        new_cb, new_cluster, new_sum = vq_ops.ema_codebook_update(
            self.embedding.weight, self.cluster_size, self.ema_embed, z_flat,
            inds, decay=self.ema_decay)
        if self.ema_restart_threshold > 0:
            if restart_rows is None:
                rows = torch.randint(0, z_flat.shape[0],
                                     (self.num_embeddings,),
                                     generator=generator,
                                     device=z_flat.device)
            else:
                rows = torch.as_tensor(restart_rows, device=z_flat.device)
                if tuple(rows.shape) != (self.num_embeddings,):
                    raise ValueError(
                        f"restart_rows must be ({self.num_embeddings},), got "
                        f"{tuple(rows.shape)}")
                rows = rows.long()
            seeds = z_flat[rows]
            dead = new_cluster < self.ema_restart_threshold
            new_cb = torch.where(dead[:, None], seeds, new_cb)
            new_sum = torch.where(dead[:, None], seeds, new_sum)
            new_cluster = torch.where(dead, torch.ones_like(new_cluster),
                                      new_cluster)
        return {"embedding.weight": new_cb, "cluster_size": new_cluster,
                "ema_embed": new_sum}


def _conv_block(conv: nn.Module) -> nn.Sequential:
    return nn.Sequential(conv, nn.LeakyReLU(_SLOPE))


@torch.no_grad()
def reset_conv_parameters(module: nn.Module,
                          generator: torch.Generator) -> None:
    """The JAX package's conv initializers on every (transposed) conv in
    ``module``: lecun-normal (truncated) kernels over the fan-in, zero
    biases."""
    for mod in module.modules():
        if isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d)):
            w = mod.weight
            fan_in = (w.shape[0] if isinstance(mod, nn.ConvTranspose2d)
                      else w.shape[1]) * w.shape[2] * w.shape[3]
            std = math.sqrt(1.0 / fan_in) / _TRUNC_STD_CORRECTION
            nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                  generator=generator)
            if mod.bias is not None:
                mod.bias.zero_()


class VQVAE(MOVAEModel):

    feature_names = ("encoding",)

    def __init__(self, in_channels: int = 3, embedding_dim: int = 64,
                 num_embeddings: int = 512,
                 hidden_dims: Tuple[int, ...] = (128, 256),
                 num_residual_layers: int = 2, input_size: int = 64,
                 recons_activation: str = "tanh",
                 recons_objective: str = "mse",
                 lambda_weights: LambdaWeights = (
                     ("reconstruction_loss", 1.0),
                     ("embedding_loss", 1.0),
                     ("commitment_loss", 0.25)),
                 perceptual_fn: Optional[Any] = None,
                 vq_ema: bool = False, vq_ema_decay: float = 0.99):
        super().__init__()
        hd = tuple(hidden_dims)
        self.in_channels = in_channels
        self.embedding_dim = embedding_dim
        self.num_embeddings = num_embeddings
        self.hidden_dims = hd
        self.num_residual_layers = num_residual_layers
        self.input_size = input_size
        self.recons_activation = recons_activation
        self.recons_objective = recons_objective
        self.lambda_weights = tuple(lambda_weights)
        self.perceptual_fn = perceptual_fn
        self.vq_ema = vq_ema

        enc, c = [], in_channels
        for h in hd:
            enc.append(_conv_block(nn.Conv2d(c, h, 4, stride=2, padding=1)))
            c = h
        enc.append(_conv_block(nn.Conv2d(c, c, 3, padding=1)))
        enc += [ResidualLayer(c) for _ in range(num_residual_layers)]
        enc.append(nn.LeakyReLU(_SLOPE))
        enc.append(_conv_block(nn.Conv2d(c, embedding_dim, 1)))
        self.encoder = nn.Sequential(*enc)

        self.vq_layer = Codebook(num_embeddings, embedding_dim, ema=vq_ema,
                                 ema_decay=vq_ema_decay)

        dec = [_conv_block(nn.Conv2d(embedding_dim, c, 3, padding=1))]
        dec += [ResidualLayer(c) for _ in range(num_residual_layers)]
        dec.append(nn.LeakyReLU(_SLOPE))
        rev = tuple(reversed(hd))
        for i in range(len(rev) - 1):
            dec.append(_conv_block(nn.ConvTranspose2d(
                rev[i], rev[i + 1], 4, stride=2, padding=1)))
        dec.append(nn.Sequential(nn.ConvTranspose2d(
            rev[-1], in_channels, 4, stride=2, padding=1)))
        self.decoder = nn.Sequential(*dec)
        self._act = resolve_activation(recons_activation)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """The JAX package's initializers: lecun-normal (truncated) conv
        kernels, zero biases, U(-1/K, 1/K) codebook."""
        reset_conv_parameters(self, generator)
        self.vq_layer.reset_parameters(generator)

    @property
    def objective_names(self) -> Tuple[str, ...]:
        if self.vq_ema:
            # EMA maintains the codebook; the embedding loss has no
            # gradient path and leaves the objective vector
            return ("reconstruction_loss", "commitment_loss")
        return ("reconstruction_loss", "embedding_loss", "commitment_loss")

    @property
    def latent_spatial_dim(self) -> int:
        return self.input_size // (2 ** len(self.hidden_dims))

    # --- encoder / decoder (NHWC in and out) ------------------------------
    def encode(self, x: Tensor, train: bool = False) -> Tensor:
        h = self.encoder(x.float().permute(0, 3, 1, 2))
        return h.permute(0, 2, 3, 1)

    def decode(self, z: Tensor, train: bool = False) -> Tensor:
        h = self.decoder(z.float().permute(0, 3, 1, 2))
        return self._act(h).permute(0, 2, 3, 1)

    # --- trunk / heads ------------------------------------------------------
    def trunk(self, x: Tensor, train: bool = False):
        return (self.encode(x, train=train),), None

    def heads(self, features, aux, x: Tensor, train: bool = False,
              generator: Optional[torch.Generator] = None,
              restart_rows: RestartRows = None) -> Dict[str, Any]:
        (encoding,) = features
        vq_out = vq_ops.vector_quantize(encoding, self.vq_layer())
        out = {
            "recons": self.decode(vq_out["quantized"], train=train),
            "quantized_inputs": vq_out["quantized"],
            "encoding": encoding,
            "commitment_loss": vq_out["commitment"],
            "embedding_loss": vq_out["embedding"],
            "encoding_inds": vq_out["encoding_inds"],
        }
        if self.vq_ema and train:
            upd = self.vq_layer.ema_update(
                encoding.reshape(-1, self.embedding_dim),
                vq_out["encoding_inds"], generator,
                (restart_rows or {}).get("vq_layer"))
            out["batch_stats"] = {f"vq_layer.{k}": v for k, v in upd.items()}
        return out

    # --- losses ------------------------------------------------------------
    def _recon_fn(self):
        if self.recons_objective.lower() == "perceptual":
            return self.perceptual_fn
        fn, _ = obj_lib.get_recon_obj_and_activation(
            self.recons_objective, self.recons_activation)
        return fn

    def loss_terms(self, x: Tensor, outputs: Dict[str, Any]
                   ) -> Dict[str, Tensor]:
        lw = dict(self.lambda_weights)
        out = {}
        for key in self.objective_names:
            if key == "reconstruction_loss":
                v = self._recon_fn()(x, outputs["recons"])
            else:
                v = outputs[key]
            out[key] = lw[key] * v
        return out

    # --- code extraction & generation ----------------------------------------
    def get_code_indices(self, x: Tensor) -> Tensor:
        """Discrete (B, h, w) code grid for prior training."""
        encoding = self.encode(x, train=False)
        b, h, w, d = encoding.shape
        inds = vq_ops.nearest_code_indices(encoding.reshape(-1, d),
                                           self.vq_layer())
        return inds.reshape(b, h, w)

    def decode_code(self, code: Tensor) -> Tensor:
        """code (B, h, w) int -> NHWC images."""
        return self.decode(self.vq_layer.embed_code(code), train=False)

    def sample(self, num_samples: int,
               generator: Optional[torch.Generator] = None) -> Tensor:
        """Uniform-random codebook sampling (a trained prior samples
        properly)."""
        s = self.latent_spatial_dim
        code = torch.randint(0, self.num_embeddings, (num_samples, s, s),
                             generator=generator,
                             device=self.vq_layer().device)
        return self.decode_code(code)
