"""Sphere Encoder ViT — port of ``movae_tpu/models/sphere_encoder_vit.py``.

Patch embedding -> sinusoidal absolute positions -> pre-norm Transformer
blocks with RoPE on q and k (depth 24, dim 1024 by default) -> an
MLP-Mixer (token and channel mixing, RMSNorm) -> per-patch latent channels
-> spherify; the decoder mirrors it back through the patches and a tanh.
The noise schedule, the three objectives and the sampling are the conv
sphere encoder's (``models/sphere_encoder.py:SphereMixin``).

Attention is ``torch.matmul`` plus ``torch.softmax`` in the activations'
dtype, as the JAX module's einsum and ``jax.nn.softmax`` (no Pallas
kernel): at the model's 256 tokens the (N, N) weights are small (the
attention products are ~6% of a block's FLOPs at the default width), the
order of operations is JAX's, and the dropout, where set, acts on the
weights as the JAX module's does (its draws from torch's global generator:
the registry never sets a dropout, as the JAX one never does).
``scaled_dot_product_attention`` would
fuse the same function but computes float32 attention in another order.

GELU is the tanh approximation (flax's ``nn.gelu`` default); LayerNorm is
flax's (eps 1e-6, variance E[x^2] - E[x]^2 clipped at 0, in float32).
The state_dict keys are those of ``movae_tpu/utils/torch_export.py:
_export_sphere_vit``: ``patch_embed_enc.proj``, ``blocks_{enc,dec}.i.
{norm1, attn.qkv, attn.proj, norm2, mlp.0, mlp.3}`` (the MLP's second
Linear is index 3, after GELU and Dropout), ``mixer_{enc,dec}.blocks.j.
{norm1, token_mix.0, token_mix.2, norm2, channel_mix.0, channel_mix.2}``,
``mixer_*.norm``, ``norm_enc``, ``latent_proj_{enc,dec}``,
``norm_dec_in``, ``norm_dec_out`` and ``head_dec``.
"""

from __future__ import annotations

import math
from typing import Any, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from movae_tpu_torch.models.base import (LambdaWeights, MOVAEModel,
                                         compute_region,
                                         resolve_compute_dtype)
from movae_tpu_torch.models.sphere_encoder import SphereMixin, rms_norm
from movae_tpu_torch.models.vae import Stats, _nchw
from movae_tpu_torch.models.vq_vae import (_TRUNC_STD_CORRECTION,
                                           reset_conv_parameters)

Tensor = torch.Tensor


def sinusoidal_table(n: int, dim: int) -> np.ndarray:
    pe = np.zeros((n, dim), np.float32)
    pos = np.arange(n, dtype=np.float32)[:, None]
    div = np.exp(np.arange(0, dim, 2, dtype=np.float32)
                 * (-math.log(10000.0) / dim))
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return pe


def rope_freqs(n: int, head_dim: int, base: float = 10000.0) -> np.ndarray:
    inv = 1.0 / (base ** (np.arange(0, head_dim, 2, np.float32) / head_dim))
    return np.outer(np.arange(n, dtype=np.float32), inv)  # (N, head_dim/2)


def apply_rope(q: Tensor, k: Tensor, freqs: Tensor) -> Tuple[Tensor, Tensor]:
    """q, k: (B, H, N, hd); freqs: (N, hd/2). Rotation of interleaved
    pairs (0, 1), (2, 3), ..."""
    cos, sin = torch.cos(freqs), torch.sin(freqs)

    def rot(u):
        u1, u2 = u[..., 0::2], u[..., 1::2]
        return torch.stack([u1 * cos - u2 * sin, u1 * sin + u2 * cos],
                           dim=-1).reshape(u.shape)

    return rot(q), rot(k)


def _gelu(x: Tensor) -> Tensor:
    return F.gelu(x, approximate="tanh")


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x: Tensor) -> Tensor:
        return rms_norm(x, self.eps) * self.weight


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` over the last axis: statistics in float32,
    the output in the input's dtype."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: Tensor) -> Tensor:
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = ((xf * xf).mean(-1, keepdim=True) - mean * mean).clamp(min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return ((xf - mean) * mul + self.bias).to(x.dtype)


class AttentionRoPE(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0):
        super().__init__()
        self.num_heads = num_heads
        self.dropout = dropout
        self.qkv = nn.Linear(embed_dim, 3 * embed_dim)
        self.proj = nn.Linear(embed_dim, embed_dim)

    def forward(self, x: Tensor, freqs: Tensor, train: bool = False
                ) -> Tensor:
        b, n, c = x.shape
        nh = self.num_heads
        hd = c // nh
        qkv = self.qkv(x).reshape(b, n, 3, nh, hd).permute(2, 0, 3, 1, 4)
        q, k = apply_rope(qkv[0], qkv[1], freqs.to(qkv.dtype))
        attn = torch.matmul(q, k.transpose(-1, -2)) * (hd ** -0.5)
        attn = torch.softmax(attn, dim=-1)
        attn = F.dropout(attn, self.dropout, train)
        out = torch.matmul(attn, qkv[2]).transpose(1, 2).reshape(b, n, c)
        return self.proj(out)


class TransformerBlock(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.norm1 = LayerNorm(embed_dim)
        self.attn = AttentionRoPE(embed_dim, num_heads, dropout)
        self.norm2 = LayerNorm(embed_dim)
        hidden = int(embed_dim * mlp_ratio)
        self.mlp = nn.Sequential(nn.Linear(embed_dim, hidden), nn.GELU(
            approximate="tanh"), nn.Dropout(dropout),
            nn.Linear(hidden, embed_dim), nn.Dropout(dropout))

    def forward(self, x: Tensor, freqs: Tensor, train: bool = False
                ) -> Tensor:
        x = x + self.attn(self.norm1(x), freqs, train)
        h = F.dropout(_gelu(self.mlp[0](self.norm2(x))), self.dropout, train)
        return x + F.dropout(self.mlp[3](h), self.dropout, train)


class MLPMixerBlock(nn.Module):
    def __init__(self, num_patches: int, embed_dim: int,
                 tokens_mlp_dim: int = 256, channels_mlp_dim: int = 2048):
        super().__init__()
        self.norm1 = RMSNorm(embed_dim)
        self.token_mix = nn.Sequential(
            nn.Linear(num_patches, tokens_mlp_dim),
            nn.GELU(approximate="tanh"),
            nn.Linear(tokens_mlp_dim, num_patches))
        self.norm2 = RMSNorm(embed_dim)
        self.channel_mix = nn.Sequential(
            nn.Linear(embed_dim, channels_mlp_dim),
            nn.GELU(approximate="tanh"),
            nn.Linear(channels_mlp_dim, embed_dim))

    def forward(self, x: Tensor) -> Tensor:
        h = self.token_mix(self.norm1(x).transpose(1, 2))
        x = x + h.transpose(1, 2)
        return x + self.channel_mix(self.norm2(x))


class MLPMixer(nn.Module):
    def __init__(self, num_patches: int, embed_dim: int, depth: int,
                 tokens_mlp_dim: int = 256, channels_mlp_dim: int = 2048):
        super().__init__()
        self.blocks = nn.ModuleList(
            MLPMixerBlock(num_patches, embed_dim, tokens_mlp_dim,
                          channels_mlp_dim) for _ in range(depth))
        self.norm = RMSNorm(embed_dim)

    def forward(self, x: Tensor) -> Tensor:
        for blk in self.blocks:
            x = blk(x)
        return self.norm(x)


class PatchEmbed(nn.Module):
    def __init__(self, in_channels: int, embed_dim: int, patch_size: int):
        super().__init__()
        self.proj = nn.Conv2d(in_channels, embed_dim, patch_size,
                              stride=patch_size)

    def forward(self, x: Tensor, dtype: torch.dtype) -> Tensor:
        """NHWC images -> (B, N, D) patch tokens, row-major."""
        return self.proj(_nchw(x, dtype)).flatten(2).transpose(1, 2)


class SphereEncoderViT(SphereMixin, MOVAEModel):

    def __init__(self, img_size: int = 32, patch_size: int = 2,
                 in_channels: int = 3, embed_dim: int = 1024, depth: int = 24,
                 num_heads: int = 16, mlp_ratio: float = 4.0,
                 mixer_depth: int = 2, mixer_tokens_mlp_dim: int = 256,
                 mixer_channels_mlp_dim: int = 2048, latent_channels: int = 8,
                 num_classes: int = 0, sigma_max_angle_deg: float = 80.0,
                 sigma_mix_prob: float = 0.0,
                 sigma_mix_angle_min_deg: Optional[float] = None,
                 sigma_mix_angle_max_deg: Optional[float] = None,
                 lambda_pix_recon: float = 1.0, lambda_pix_con: float = 0.5,
                 lambda_lat_con: float = 0.1,
                 lambda_weights: Optional[LambdaWeights] = None,
                 use_perceptual: bool = True,
                 perceptual_fn: Optional[Any] = None, dropout: float = 0.0,
                 dtype: Any = torch.float32):
        super().__init__()
        self._init_sphere(sigma_max_angle_deg, sigma_mix_prob,
                          sigma_mix_angle_min_deg, sigma_mix_angle_max_deg,
                          lambda_pix_recon, lambda_pix_con, lambda_lat_con,
                          use_perceptual, perceptual_fn)
        self.compute_dtype = resolve_compute_dtype(dtype)
        self.img_size = img_size
        self.patch_size = patch_size
        self.in_channels = in_channels
        self.embed_dim = embed_dim
        self.depth = depth
        self.num_heads = num_heads
        self.mixer_depth = mixer_depth
        self.latent_channels = latent_channels
        self.num_classes = num_classes
        self.lambda_weights = tuple(lambda_weights or (
            ("pix_recon", lambda_pix_recon), ("pix_con", lambda_pix_con),
            ("lat_con", lambda_lat_con)))
        d, n = embed_dim, self.num_patches
        mix = (n, d, mixer_depth, mixer_tokens_mlp_dim,
               mixer_channels_mlp_dim)
        self.patch_embed_enc = PatchEmbed(in_channels, d, patch_size)
        self.blocks_enc = nn.ModuleList(
            TransformerBlock(d, num_heads, mlp_ratio, dropout)
            for _ in range(depth))
        self.mixer_enc = MLPMixer(*mix)
        self.norm_enc = RMSNorm(d)
        self.latent_proj_enc = nn.Linear(d, latent_channels)
        self.latent_proj_dec = nn.Linear(latent_channels, d)
        self.norm_dec_in = RMSNorm(d)
        self.mixer_dec = MLPMixer(*mix)
        self.blocks_dec = nn.ModuleList(
            TransformerBlock(d, num_heads, mlp_ratio, dropout)
            for _ in range(depth))
        self.norm_dec_out = LayerNorm(d)
        self.head_dec = nn.Linear(d, patch_size * patch_size * in_channels)
        hd = d // num_heads
        self.register_buffer("pos", torch.from_numpy(
            sinusoidal_table(n, d)), persistent=False)
        self.register_buffer("freqs", torch.from_numpy(
            rope_freqs(n, hd)), persistent=False)

    @property
    def num_patches(self) -> int:
        return (self.img_size // self.patch_size) ** 2

    @property
    def latent_dim(self) -> int:
        return self.num_patches * self.latent_channels

    @property
    def input_size(self) -> int:
        return self.img_size

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """The JAX package's initializers: lecun-normal (truncated) kernels,
        zero biases, unit norm scales."""
        reset_conv_parameters(self, generator)
        for mod in self.modules():
            if isinstance(mod, nn.Linear):
                std = math.sqrt(1.0 / mod.in_features) / _TRUNC_STD_CORRECTION
                nn.init.trunc_normal_(mod.weight, 0.0, std, -2.0 * std,
                                      2.0 * std, generator=generator)
                mod.bias.zero_()
            elif isinstance(mod, (RMSNorm, LayerNorm)):
                mod.weight.fill_(1.0)
                if isinstance(mod, LayerNorm):
                    mod.bias.zero_()

    def encode_to_vector(self, x: Tensor, train: bool = False,
                         stats: Stats = None) -> Tensor:
        """NHWC images -> float32 (B, N * latent_channels), token-major."""
        b = x.shape[0]
        with compute_region(self.compute_dtype, x.device):
            h = self.patch_embed_enc(x, self.compute_dtype)
            h = h + self.pos.to(h.dtype)
            for blk in self.blocks_enc:
                h = blk(h, self.freqs, train)
            z = self.latent_proj_enc(self.norm_enc(self.mixer_enc(h)))
        return z.reshape(b, -1).float()

    def decode_from_sphere(self, v: Tensor, train: bool = False,
                           stats: Stats = None) -> Tensor:
        """(B, N * latent_channels) -> float32 NHWC images in [-1, 1]."""
        b, g = v.shape[0], self.img_size // self.patch_size
        p, c = self.patch_size, self.in_channels
        with compute_region(self.compute_dtype, v.device):
            h = v.reshape(b, self.num_patches, self.latent_channels).to(
                self.compute_dtype)
            h = self.mixer_dec(self.norm_dec_in(self.latent_proj_dec(h)))
            h = h + self.pos.to(h.dtype)
            for blk in self.blocks_dec:
                h = blk(h, self.freqs, train)
            h = self.head_dec(self.norm_dec_out(h))
            img = h.reshape(b, g, g, p, p, c).permute(0, 1, 3, 2, 4, 5)
            img = torch.tanh(img.reshape(b, self.img_size, self.img_size, c))
        return img.float()
