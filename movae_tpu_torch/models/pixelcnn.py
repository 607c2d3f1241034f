"""PixelCNN / PixelSNAIL priors over discrete VQ codes — port of
``movae_tpu/models/pixelcnn.py:37-367`` (the flat priors).

Masked A/B convolutions, gated residual blocks and, in PixelSNAIL, causal
self-attention over the raster sequence with coordinate channels. Code grids
are (B, H, W) integers and logits NHWC (B, H, W, K) at the public methods,
as in the JAX package; convolutions run NCHW inside. Submodules are named so
that ``state_dict()`` keys equal the reference-torch layout of
``movae_tpu/utils/torch_export.py:_export_pixelcnn`` / ``_export_pixelsnail``:
``embedding.weight``, ``conv_in``, ``res_blocks.{l}`` or
``blocks.{b}.{res_blocks.{r},attention.{q,k,v,out}_proj,out_conv}`` (the
projections as 1x1 convolutions) and ``conv_out.{1,3}``.

Dropout draws come from an explicit ``torch.Generator``; the JAX package's
draws differ, so tests compare at dropout 0 or by statistics. Not ported
yet: the hierarchical priors (``ROADMAP.md`` Queue 1 item 7, with VQ-VAE-2)
and the samplers (item 9).
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from movae_tpu_torch.ops.attention import (DENSE_ATTENTION_MAX_L,
                                           causal_attention,
                                           dense_causal_attention)
from movae_tpu_torch.ops.vq import gather_rows

Tensor = torch.Tensor

# flax's lecun_normal: truncated normal at +-2 std, rescaled to unit variance
_TRUNC_STD_CORRECTION = 0.87962566103423978


def make_conv_mask(kh: int, kw: int, cin: int, cout: int,
                   mask_type: str) -> np.ndarray:
    """Raster-order causal mask for an HWIO conv kernel: rows above the
    centre, the centre row left of the centre, and the centre itself for
    type "B"."""
    mask = np.zeros((kh, kw, cin, cout), np.float32)
    mask[: kh // 2, :, :, :] = 1.0
    mask[kh // 2, : kw // 2, :, :] = 1.0
    if mask_type == "B":
        mask[kh // 2, kw // 2, :, :] = 1.0
    return mask


def _dropout(x: Tensor, rate: float, generator: Optional[torch.Generator]
             ) -> Tensor:
    """flax ``nn.Dropout``: keep with probability 1 - rate, scale kept
    values by 1 / (1 - rate)."""
    if rate <= 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))


class GatherEmbed(nn.Module):
    """Code embedding whose lookup goes through ``ops.vq.gather_rows``
    (``index_add_`` backward), as the JAX package's ``GatherEmbed``."""

    def __init__(self, num_embeddings: int, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(num_embeddings, features))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        # flax default_embed_init: variance_scaling(1, fan_in, normal,
        # out_axis=0) on (K, D) has fan_in = D
        self.weight.normal_(0.0, 1.0 / math.sqrt(self.weight.shape[1]),
                            generator=generator)

    def forward(self, codes: Tensor) -> Tensor:
        out = gather_rows(self.weight, codes.reshape(-1))
        return out.reshape(codes.shape + (self.weight.shape[1],))


class MaskedConv(nn.Conv2d):
    """Masked conv with SAME padding: the kernel is multiplied by the causal
    mask at apply time and never mutated."""

    def __init__(self, cin: int, cout: int, kernel_size: int,
                 mask_type: str = "B"):
        super().__init__(cin, cout, kernel_size, padding="same")
        mask = make_conv_mask(kernel_size, kernel_size, cin, cout, mask_type)
        self.register_buffer(
            "mask", torch.from_numpy(mask.transpose(3, 2, 0, 1).copy()),
            persistent=False)

    def forward(self, x: Tensor) -> Tensor:
        return self._conv_forward(x, self.weight * self.mask, self.bias)


class GatedResBlock(nn.Module):
    """1x1 -> masked k3 -> gated tanh * sigmoid, residual."""

    def __init__(self, channels: int, kernel_size: int = 3):
        super().__init__()
        half = channels // 2
        self.conv1 = nn.Conv2d(channels, half, 1)
        self.conv2 = MaskedConv(half, half, kernel_size, "B")
        self.conv_gate = nn.Conv2d(half, channels, 1)
        self.conv_feature = nn.Conv2d(half, channels, 1)

    def forward(self, x: Tensor) -> Tensor:
        out = F.relu(self.conv1(x))
        out = F.relu(self.conv2(out))
        gate = torch.sigmoid(self.conv_gate(out))
        feature = torch.tanh(self.conv_feature(out))
        return x + gate * feature


class CausalAttention(nn.Module):
    """Causal multi-head attention over the flattened raster sequence
    (NCHW in and out), inclusive diagonal.

    ``attn_dropout_mode``: "output" (default) runs ``causal_attention`` (the
    flash kernels above ``DENSE_ATTENTION_MAX_L``) and applies dropout to
    its output; "weights" applies dropout to the attention weights on the
    dense path, at L <= ``DENSE_ATTENTION_MAX_L`` only (longer sequences use
    "output")."""

    def __init__(self, channels: int, num_heads: int = 8,
                 dropout: float = 0.1, attn_dropout_mode: str = "output"):
        super().__init__()
        if attn_dropout_mode not in ("output", "weights"):
            raise ValueError(f"attn_dropout_mode {attn_dropout_mode!r}")
        self.num_heads = num_heads
        self.head_dim = channels // num_heads
        self.dropout = dropout
        self.attn_dropout_mode = attn_dropout_mode
        pd = self.head_dim * num_heads
        self.q_proj = nn.Conv2d(channels, pd, 1)
        self.k_proj = nn.Conv2d(channels, pd, 1)
        self.v_proj = nn.Conv2d(channels, pd, 1)
        self.out_proj = nn.Conv2d(pd, channels, 1)

    def qkv(self, x: Tensor):
        """(B, C, H, W) -> q, k, v as contiguous (B, heads, L, head_dim)."""
        b, _, h, w = x.shape

        def split(t):
            # projection channel c = head * hd + d, as the JAX package's
            # reshape(b, L, nh, hd); the kernels take contiguous
            # (B, H, L, D), so each of q, k, v is copied once per call (at
            # batch 16, L=4096, 128 channels: 33.5 MB read and written
            # each, ~60 us of HBM traffic per layer at 3.35 TB/s)
            return t.reshape(b, self.num_heads, self.head_dim,
                             h * w).transpose(2, 3).contiguous()

        return split(self.q_proj(x)), split(self.k_proj(x)), split(
            self.v_proj(x))

    def forward(self, x: Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> Tensor:
        b, _, h, w = x.shape
        L = h * w
        nh, hd = self.num_heads, self.head_dim
        q, k, v = self.qkv(x)
        sm_scale = 1.0 / math.sqrt(hd)
        drop = self.dropout if train else 0.0
        if (drop > 0.0 and self.attn_dropout_mode == "weights"
                and L <= DENSE_ATTENTION_MAX_L):
            out = dense_causal_attention(
                q, k, v, sm_scale, lambda w: _dropout(w, drop, generator))
        else:
            out = _dropout(causal_attention(q, k, v, sm_scale), drop,
                           generator)
        # flatten DIM-MAJOR, channel = d * nh + head, as the reference's
        # out.permute(0, 2, 3, 1).reshape(B, L, proj_dim) does; out_proj's
        # weights are bound to this layout (a heads-major flatten was the
        # r4 PixelSNAIL parity fault)
        out = out.permute(0, 3, 1, 2).reshape(b, hd * nh, h, w)
        return self.out_proj(out)


class PixelSNAILBlock(nn.Module):
    """Residual blocks + causal attention + 1x1 merge, residual."""

    def __init__(self, channels: int, num_res_blocks: int = 2,
                 num_heads: int = 8, dropout: float = 0.1,
                 attn_dropout_mode: str = "output"):
        super().__init__()
        self.res_blocks = nn.ModuleList(
            GatedResBlock(channels) for _ in range(num_res_blocks))
        self.attention = CausalAttention(channels, num_heads, dropout,
                                         attn_dropout_mode)
        self.out_conv = nn.Conv2d(2 * channels, channels, 1)

    def forward(self, x: Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> Tensor:
        for blk in self.res_blocks:
            x = blk(x)
        attn = self.attention(x, train=train, generator=generator)
        return self.out_conv(torch.cat([x, attn], dim=1)) + x


def _pos_encoding(h: int, w: int) -> np.ndarray:
    """Row/col coordinates normalized around zero, (1, H, W, 2)."""
    ch = (np.arange(h, dtype=np.float32) - h / 2) / max(h, 1)
    cw = (np.arange(w, dtype=np.float32) - w / 2) / max(w, 1)
    pos = np.stack(np.broadcast_arrays(ch[:, None], cw[None, :]), axis=-1)
    return pos[None]


class _Prior(nn.Module):
    """Shared embedding, output head, loss and initializers."""

    num_embeddings: int

    def _head(self) -> nn.Sequential:
        hc = self.hidden_channels
        return nn.Sequential(nn.ReLU(), nn.Conv2d(hc, hc, 1), nn.ReLU(),
                             nn.Conv2d(hc, self.num_embeddings, 1))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """The JAX package's initializers: lecun-normal (truncated) kernels
        for every conv and 1x1 projection, zero biases, flax's embedding
        init for the code table."""
        for mod in self.modules():
            if isinstance(mod, nn.Conv2d):
                w = mod.weight
                std = math.sqrt(1.0 / (w.shape[1] * w.shape[2] * w.shape[3]))
                std /= _TRUNC_STD_CORRECTION
                nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                      generator=generator)
                mod.bias.zero_()
        self.embedding.reset_parameters(generator)

    def logits_nchw(self, codes: Tensor, train: bool = False,
                    generator: Optional[torch.Generator] = None) -> Tensor:
        raise NotImplementedError

    def forward(self, codes: Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> Tensor:
        """(B, H, W) int codes -> (B, H, W, K) float32 logits."""
        return self.logits_nchw(codes, train, generator).permute(0, 2, 3, 1)

    def loss_function(self, codes: Tensor, train: bool = True,
                      generator: Optional[torch.Generator] = None
                      ) -> Dict[str, Tensor]:
        """Mean cross-entropy of the codes under their own logits."""
        logits = self.logits_nchw(codes, train, generator)
        return {"total_loss": F.cross_entropy(logits, codes.long())}


class PixelCNN(_Prior):
    """Gated PixelCNN over code grids."""

    def __init__(self, num_embeddings: int, embedding_dim: int = 64,
                 hidden_channels: int = 128, num_layers: int = 15,
                 kernel_size: int = 7):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.hidden_channels = hidden_channels
        self.embedding = GatherEmbed(num_embeddings, embedding_dim)
        self.conv_in = MaskedConv(embedding_dim, hidden_channels,
                                  kernel_size, "A")
        self.res_blocks = nn.ModuleList(
            GatedResBlock(hidden_channels) for _ in range(num_layers))
        self.conv_out = self._head()

    def logits_nchw(self, codes: Tensor, train: bool = False,
                    generator: Optional[torch.Generator] = None) -> Tensor:
        h = self.conv_in(self.embedding(codes).permute(0, 3, 1, 2))
        for blk in self.res_blocks:
            h = blk(h)
        return self.conv_out(h)


class PixelSNAIL(_Prior):
    """PixelCNN + causal attention blocks + coordinate channels."""

    def __init__(self, num_embeddings: int, embedding_dim: int = 64,
                 hidden_channels: int = 128, num_blocks: int = 8,
                 num_res_blocks_per_layer: int = 2, num_heads: int = 8,
                 kernel_size: int = 7, dropout: float = 0.1,
                 attn_dropout_mode: str = "output"):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.hidden_channels = hidden_channels
        self.dropout = dropout
        self.attn_dropout_mode = attn_dropout_mode
        self.embedding = GatherEmbed(num_embeddings, embedding_dim)
        self.conv_in = MaskedConv(embedding_dim + 2, hidden_channels,
                                  kernel_size, "A")
        self.blocks = nn.ModuleList(
            PixelSNAILBlock(hidden_channels, num_res_blocks_per_layer,
                            num_heads, dropout, attn_dropout_mode)
            for _ in range(num_blocks))
        self.conv_out = self._head()

    def logits_nchw(self, codes: Tensor, train: bool = False,
                    generator: Optional[torch.Generator] = None) -> Tensor:
        b, hh, ww = codes.shape
        h = self.embedding(codes).permute(0, 3, 1, 2)
        pos = torch.from_numpy(_pos_encoding(hh, ww).transpose(0, 3, 1, 2))
        pos = pos.to(device=h.device, dtype=h.dtype).expand(b, -1, -1, -1)
        h = self.conv_in(torch.cat([h, pos], dim=1))
        for blk in self.blocks:
            h = h + blk(h, train=train, generator=generator)
        return self.conv_out(h)
