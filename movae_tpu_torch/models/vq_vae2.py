"""VQ-VAE-2, two-level hierarchical vector quantization — port of
``movae_tpu/models/vq_vae2.py``.

enc_b (stride 4) -> enc_t (stride 2) -> quantize_conv_t -> top quantizer ->
dec_t -> [dec_t, enc_b] -> quantize_conv_b -> bottom quantizer; decode =
[upsample_t(quant_t), quant_b] -> stride-4 decoder. The top and bottom
commitment and embedding losses are summed. Latent grids are input/8 (top)
and input/4 (bottom). Both quantizers take their nearest code from the
hand-written CUDA kernel on the card (``movae_tpu_torch.ops.vq``).

Images, features, quantized latents and code grids are NHWC at the public
methods (the quantizer sees NHWC rows, so the flattened indices come out in
the JAX package's order); the convolutions run NCHW inside. Submodules are
named so that ``state_dict()`` keys equal the reference-torch layout of
``movae_tpu/utils/torch_export.py:_export_vqvae2``: ``enc_b.blocks.N``,
``enc_t``, ``quantize_conv_t``, ``quantize_t.embedding.weight``, ``dec_t``,
``quantize_conv_b``, ``quantize_b``, ``upsample_t`` and ``dec``. Geometry:
flax ``SAME`` on the k4-s2 convs is ``padding=1``, and the k4-s2 SAME
transpose is ``ConvTranspose2d(k=4, s=2, p=1)`` with the kernel flipped.

Objectives: reconstruction_loss, commitment_loss, embedding_loss (in that
order, unlike ``VQVAE``). Features: encoding_top (enc_t), encoding_bottom
(enc_b); enc_t is computed from enc_b, so the trunk pullback carries
enc_t's cotangent on into enc_b.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from movae_tpu_torch import objectives as obj_lib
from movae_tpu_torch.models.base import (LambdaWeights, MOVAEModel,
                                         RestartRows, resolve_activation)
from movae_tpu_torch.models.vq_vae import Codebook, reset_conv_parameters
from movae_tpu_torch.ops import vq as vq_ops

Tensor = torch.Tensor


def _nchw(x: Tensor) -> Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: Tensor) -> Tensor:
    return x.permute(0, 2, 3, 1)


class ResBlock(nn.Module):
    """relu -> k3 conv(channel) -> relu -> k1 conv(in), residual."""

    def __init__(self, in_channel: int, channel: int):
        super().__init__()
        self.conv = nn.Sequential(
            nn.ReLU(), nn.Conv2d(in_channel, channel, 3, padding=1),
            nn.ReLU(), nn.Conv2d(channel, in_channel, 1))

    def forward(self, x: Tensor) -> Tensor:
        return x + self.conv(x)


class Encoder(nn.Module):
    """Stride-4 or stride-2 conv stack, residual blocks, relu (NCHW)."""

    def __init__(self, in_channel: int, channel: int, n_res_block: int,
                 n_res_channel: int, stride: int):
        super().__init__()
        if stride == 4:
            blocks = [nn.Conv2d(in_channel, channel // 2, 4, 2, 1), nn.ReLU(),
                      nn.Conv2d(channel // 2, channel, 4, 2, 1), nn.ReLU(),
                      nn.Conv2d(channel, channel, 3, padding=1)]
        elif stride == 2:
            blocks = [nn.Conv2d(in_channel, channel // 2, 4, 2, 1), nn.ReLU(),
                      nn.Conv2d(channel // 2, channel, 3, padding=1)]
        else:
            raise ValueError(f"stride {stride} not supported")
        blocks += [ResBlock(channel, n_res_channel)
                   for _ in range(n_res_block)]
        blocks.append(nn.ReLU())
        self.blocks = nn.Sequential(*blocks)

    def forward(self, x: Tensor) -> Tensor:
        return self.blocks(x)


class Decoder(nn.Module):
    """k3 conv, residual blocks, relu, k4-s2 transposed upsample(s) (NCHW);
    the output activation is the caller's."""

    def __init__(self, in_channel: int, out_channel: int, channel: int,
                 n_res_block: int, n_res_channel: int, stride: int):
        super().__init__()
        blocks = [nn.Conv2d(in_channel, channel, 3, padding=1)]
        blocks += [ResBlock(channel, n_res_channel)
                   for _ in range(n_res_block)]
        blocks.append(nn.ReLU())
        if stride == 4:
            blocks += [nn.ConvTranspose2d(channel, channel // 2, 4, 2, 1),
                       nn.ReLU(),
                       nn.ConvTranspose2d(channel // 2, out_channel, 4, 2, 1)]
        elif stride == 2:
            blocks.append(nn.ConvTranspose2d(channel, out_channel, 4, 2, 1))
        else:
            raise ValueError(f"stride {stride} not supported")
        self.blocks = nn.Sequential(*blocks)

    def forward(self, x: Tensor) -> Tensor:
        return self.blocks(x)


class VQVAE2(MOVAEModel):

    feature_names = ("encoding_top", "encoding_bottom")

    def __init__(self, in_channels: int = 3, embedding_dim: int = 64,
                 num_embeddings: int = 512,
                 hidden_dims: Tuple[int, ...] = (128, 256),
                 num_residual_layers: int = 2, input_size: int = 64,
                 recons_activation: str = "tanh",
                 recons_objective: str = "mse",
                 lambda_weights: LambdaWeights = (
                     ("reconstruction_loss", 1.0),
                     ("commitment_loss", 1.0),
                     ("embedding_loss", 1.0)),
                 perceptual_fn: Optional[Any] = None,
                 vq_ema: bool = False, vq_ema_decay: float = 0.99):
        super().__init__()
        self.in_channels = in_channels
        self.embedding_dim = embedding_dim
        self.num_embeddings = num_embeddings
        self.hidden_dims = tuple(hidden_dims)
        self.num_residual_layers = num_residual_layers
        self.input_size = input_size
        self.recons_activation = recons_activation
        self.recons_objective = recons_objective
        self.lambda_weights = tuple(lambda_weights)
        self.perceptual_fn = perceptual_fn
        self.vq_ema = vq_ema

        ch, nr, d = self.hidden_dims[0], num_residual_layers, embedding_dim
        self.enc_b = Encoder(in_channels, ch, nr, 32, stride=4)
        self.enc_t = Encoder(ch, ch, nr, 32, stride=2)
        self.quantize_conv_t = nn.Conv2d(ch, d, 1)
        self.quantize_t = Codebook(num_embeddings, d, ema=vq_ema,
                                   ema_decay=vq_ema_decay)
        self.dec_t = Decoder(d, d, ch, nr, 32, stride=2)
        self.quantize_conv_b = nn.Conv2d(d + ch, d, 1)
        self.quantize_b = Codebook(num_embeddings, d, ema=vq_ema,
                                   ema_decay=vq_ema_decay)
        self.upsample_t = nn.ConvTranspose2d(d, d, 4, 2, 1)
        self.dec = Decoder(2 * d, in_channels, ch, nr, 32, stride=4)
        self._act = resolve_activation(recons_activation)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """The JAX package's initializers: lecun-normal (truncated) conv
        kernels, zero biases, U(-1/K, 1/K) codebooks."""
        reset_conv_parameters(self, generator)
        self.quantize_t.reset_parameters(generator)
        self.quantize_b.reset_parameters(generator)

    @property
    def objective_names(self) -> Tuple[str, ...]:
        if self.vq_ema:
            # both codebooks are EMA-maintained; the summed embedding loss
            # has no gradient path and leaves the objective vector
            return ("reconstruction_loss", "commitment_loss")
        return ("reconstruction_loss", "commitment_loss", "embedding_loss")

    @property
    def latent_spatial_dim_bottom(self) -> int:
        return self.input_size // 4

    @property
    def latent_spatial_dim_top(self) -> int:
        return self.input_size // 8

    # --- trunk / heads ------------------------------------------------------
    def trunk(self, x: Tensor, train: bool = False):
        enc_b = self.enc_b(_nchw(x.float()))
        enc_t = self.enc_t(enc_b)
        return (_nhwc(enc_t), _nhwc(enc_b)), None

    def _bottom_input(self, quant_t: Tensor, enc_b: Tensor) -> Tensor:
        """quantize_conv_b([dec_t(quant_t), enc_b]), NHWC in and out."""
        dec_t = self.dec_t(_nchw(quant_t))
        return _nhwc(self.quantize_conv_b(torch.cat([dec_t, _nchw(enc_b)],
                                                    dim=1)))

    def heads(self, features, aux, x: Tensor, train: bool = False,
              generator: Optional[torch.Generator] = None,
              restart_rows: RestartRows = None) -> Dict[str, Any]:
        enc_t, enc_b = features
        qt_in = _nhwc(self.quantize_conv_t(_nchw(enc_t)))
        vq_t = vq_ops.vector_quantize(qt_in, self.quantize_t())
        qb_in = self._bottom_input(vq_t["quantized"], enc_b)
        vq_b = vq_ops.vector_quantize(qb_in, self.quantize_b())
        out = {
            "recons": self.decode(vq_t["quantized"], vq_b["quantized"],
                                  train=train),
            "encoding_top": enc_t,
            "encoding_bottom": enc_b,
            "quantized_top": vq_t["quantized"],
            "quantized_bottom": vq_b["quantized"],
            "commitment_loss": vq_t["commitment"] + vq_b["commitment"],
            "embedding_loss": vq_t["embedding"] + vq_b["embedding"],
            "encoding_inds_top": vq_t["encoding_inds"],
            "encoding_inds_bottom": vq_b["encoding_inds"],
        }
        if self.vq_ema and train:
            stats = {}
            for name, book, z, vq_out in (
                    ("quantize_t", self.quantize_t, qt_in, vq_t),
                    ("quantize_b", self.quantize_b, qb_in, vq_b)):
                upd = book.ema_update(z.reshape(-1, self.embedding_dim),
                                      vq_out["encoding_inds"], generator,
                                      (restart_rows or {}).get(name))
                stats.update((f"{name}.{k}", v) for k, v in upd.items())
            out["batch_stats"] = stats
        return out

    def decode(self, quant_t: Tensor, quant_b: Tensor,
               train: bool = False) -> Tensor:
        """(top, bottom) quantized NHWC latents -> NHWC images."""
        up = self.upsample_t(_nchw(quant_t.float()))
        h = self.dec(torch.cat([up, _nchw(quant_b.float())], dim=1))
        return _nhwc(self._act(h))

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
    def get_code_indices_pair(self, x: Tensor) -> Tuple[Tensor, Tensor]:
        """(top (B, s/8, s/8), bottom (B, s/4, s/4)) int32 code grids for
        prior training. Runs the encoders, both quantizers and dec_t (which
        the bottom quantizer conditions on), not the image decoder: two
        nearest-code launches on the card."""
        (enc_t, enc_b), _ = self.trunk(x)
        qt_in = _nhwc(self.quantize_conv_t(_nchw(enc_t)))
        vq_t = vq_ops.vector_quantize(qt_in, self.quantize_t())
        qb_in = self._bottom_input(vq_t["quantized"], enc_b)
        inds_b = vq_ops.nearest_code_indices(
            qb_in.reshape(-1, self.embedding_dim), self.quantize_b())
        b = x.shape[0]
        st, sb = self.latent_spatial_dim_top, self.latent_spatial_dim_bottom
        return (vq_t["encoding_inds"].reshape(b, st, st),
                inds_b.reshape(b, sb, sb))

    def decode_code(self, code_t: Tensor, code_b: Tensor) -> Tensor:
        """(top, bottom) int code grids -> NHWC images."""
        return self.decode(self.quantize_t.embed_code(code_t),
                           self.quantize_b.embed_code(code_b))

    def sample(self, num_samples: int,
               generator: Optional[torch.Generator] = None) -> Tensor:
        """Uniform-random codes at both levels (a trained hierarchical prior
        samples properly)."""
        dev = self.quantize_t().device
        st, sb = self.latent_spatial_dim_top, self.latent_spatial_dim_bottom
        ct = torch.randint(0, self.num_embeddings, (num_samples, st, st),
                           generator=generator, device=dev)
        cb = torch.randint(0, self.num_embeddings, (num_samples, sb, sb),
                           generator=generator, device=dev)
        return self.decode_code(ct, cb)
