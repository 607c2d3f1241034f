"""PixelCNN / PixelSNAIL priors over discrete VQ codes and their samplers —
port of ``movae_tpu/models/pixelcnn.py``.

Masked A/B convolutions, gated residual blocks and, in PixelSNAIL, causal
self-attention over the raster sequence with coordinate channels; the
two-level priors P(z_top) P(z_bottom | z_top) of VQ-VAE-2. Code grids are
(B, H, W) integers, conditioning planes and logits NHWC (B, H, W, C) at the
public methods, as in the JAX package; convolutions run NCHW inside.
Submodules are named so that ``state_dict()`` keys equal the reference-torch
layout of ``movae_tpu/utils/torch_export.py:_export_pixelcnn`` /
``_export_pixelsnail`` / ``_export_hierarchical``: ``embedding.weight``,
``conv_in``, ``res_blocks.{l}`` or
``blocks.{b}.{res_blocks.{r},attention.{q,k,v,out}_proj,out_conv}`` (the
projections as 1x1 convolutions), ``conv_out.{1,3}``; ``prior_top.*``,
``embedding_top.weight``, ``upsample_top`` and ``prior_bottom.*``.

Samplers (after the models): ``sample_naive`` (the oracle: one full forward
per pixel), ``sample_fast`` (PixelCNN with per-layer padded activation
caches), ``sample_wavefront`` (PixelCNN over the same caches, one
skew-diagonal front of pixels a step), ``sample_fast_snail`` (PixelSNAIL,
plus a key/value cache per attention block in float32, bfloat16 or int8),
the ``sample_prior`` dispatch and ``sample_hierarchical``. Each draws pixel t as the argmax of its logits
over the temperature plus Gumbel noise ``gumbel[t]`` — the Gumbel-max form of
the JAX package's ``jax.random.categorical`` — where ``gumbel`` (L, B, K) is
drawn up front from a ``torch.Generator`` or given by the caller, so every
sampler draws the same codes from the same noise.

Dropout draws come from an explicit ``torch.Generator``; the JAX package's
draws differ, so tests compare at dropout 0 or by statistics.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from movae_tpu_torch.ops.attention import (DENSE_ATTENTION_MAX_L,
                                           causal_attention,
                                           dense_causal_attention)
from movae_tpu_torch.device import replay_steps
from movae_tpu_torch.models.base import (compute_region, draw,
                                         resolve_compute_dtype)
from movae_tpu_torch.ops.vq import gather_rows
from movae_tpu_torch.parallel import context as cp_lib
from movae_tpu_torch.parallel import mesh as mesh_lib
from movae_tpu_torch.parallel.context import (gather_sample_batch,
                                              shard_sample_batch)

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


def _dropout(x: Tensor, rate: float, generator: Optional[torch.Generator],
             seq_dim: Optional[int] = None) -> Tensor:
    """flax ``nn.Dropout``: keep with probability 1 - rate, scale kept
    values by 1 / (1 - rate). The uniform draw goes through
    ``models/base.py:draw`` (a data-parallel step draws it for the global
    batch); inside a row-sharded trunk it is drawn for the whole sequence
    along ``seq_dim`` and this rank keeps its part, so one generator draws
    the same masks whatever the ``seq`` ranks."""
    if rate <= 0.0:
        return x
    keep = 1.0 - rate
    shape = list(x.shape)
    part = None
    if seq_dim is not None and cp_lib.trunk_sharded():
        part = cp_lib.seq_part(shape[seq_dim])
        shape[seq_dim] = part[1]
    mask = draw("dropout", "rand", shape, generator, None, x.device)
    if part is not None:
        mask = mask.narrow(seq_dim, part[0], x.shape[seq_dim])
    mask = mask < keep
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
    mask at apply time and never mutated. Inside a row-sharded trunk
    (``parallel/context.py``) the rows above this rank's come from the
    ranks that hold them (``halo_rows``) in place of the top padding; the
    bottom and the sides stay zeros (the mask zeroes every kernel row
    below the centre)."""

    def __init__(self, cin: int, cout: int, kernel_size: int,
                 mask_type: str = "B"):
        super().__init__(cin, cout, kernel_size, padding="same")
        mask = make_conv_mask(kernel_size, kernel_size, cin, cout, mask_type)
        self.register_buffer(
            "mask", torch.from_numpy(mask.transpose(3, 2, 0, 1).copy()),
            persistent=False)

    def forward(self, x: Tensor) -> Tensor:
        w = self.weight * self.mask
        if not cp_lib.trunk_sharded():
            return self._conv_forward(x, w, self.bias)
        kh, kw = self.kernel_size
        if kh % 2 == 0 or kw % 2 == 0:
            raise ValueError(f"a row-sharded trunk needs odd masked "
                             f"kernels, got {kh}x{kw}")
        top = kh // 2
        x = torch.cat([cp_lib.halo_rows(x, top), x], 2)
        x = F.pad(x, (0, 0, 0, top))
        return F.conv2d(x, w, self.bias, padding=(0, kw // 2))


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
        # the attention computes in q's dtype (the projections' compute
        # dtype), as the JAX package's: no autocast re-casting inside
        with torch.autocast(x.device.type, enabled=False):
            # under context parallelism the ring and output dropout run
            # at any L, as in the JAX package
            if (drop > 0.0 and self.attn_dropout_mode == "weights"
                    and L <= DENSE_ATTENTION_MAX_L
                    and not _context_active()):
                out = dense_causal_attention(
                    q, k, v, sm_scale,
                    lambda w: _dropout(w, drop, generator))
            else:
                out = _dropout(causal_attention(q, k, v, sm_scale), drop,
                               generator, seq_dim=2)
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
    """Shared embedding, output head, loss and initializers.
    ``compute_dtype`` (float32 or bfloat16) is the dtype of the conv and
    dense layers (``models/base.py:compute_region``); the embedding, the
    logits and the cross-entropy are float32, as in the JAX package.

    Under an active context-parallel config whose ``seq`` ranks divide the
    grid's rows, the trunk runs row-sharded (``parallel/context.py``, the
    JAX package's ``seq_shard_spatial``): each rank embeds and runs its
    own rows of the codes, the condition plane and the coordinate
    channels; :meth:`loss_function` sums its rows' cross-entropy over the
    global pixel count and then over ``seq`` (the logits are never
    gathered), and :meth:`logits_nchw` / :meth:`forward` gather the rows
    into the whole grid."""

    num_embeddings: int
    compute_dtype: torch.dtype = torch.float32

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

    def _input(self, codes: Tensor, extra: Optional[Tensor],
               condition: Optional[Tensor]) -> Tensor:
        """conv_in's NCHW input: the code embedding, then ``extra``
        channels (NCHW), then the NHWC ``condition`` plane."""
        h = [self.embedding(codes).permute(0, 3, 1, 2)]
        if extra is not None:
            h.append(extra.to(h[0].dtype))
        if condition is not None:
            h.append(condition.permute(0, 3, 1, 2).to(h[0].dtype))
        return torch.cat(h, dim=1) if len(h) > 1 else h[0]

    def _logits(self, h: Tensor, train: bool,
                generator: Optional[torch.Generator]) -> Tensor:
        raise NotImplementedError

    def _trunk_logits(self, codes: Tensor, train: bool,
                      generator: Optional[torch.Generator],
                      condition: Optional[Tensor]):
        """(logits, rows): this rank's rows ``rows`` of the (B, K, H, W)
        logits where the active context shards the trunk, else the whole
        grid's and None."""
        rows = cp_lib.trunk_rows(codes.shape[1])
        extra = self._extra(codes, rows)
        if rows is not None:
            codes = codes[:, rows[0]:rows[1]]
            if condition is not None:
                condition = condition[:, rows[0]:rows[1]]
        h = self._input(codes, extra, condition)
        with cp_lib.sharded_trunk(rows), compute_region(self.compute_dtype,
                                                        codes.device):
            out = self._logits(h, train, generator)
        # bf16 logits to float32; a float64 module keeps float64
        return out.to(torch.promote_types(out.dtype, torch.float32)), rows

    def logits_nchw(self, codes: Tensor, train: bool = False,
                    generator: Optional[torch.Generator] = None,
                    condition: Optional[Tensor] = None) -> Tensor:
        """(B, H, W) codes -> (B, K, H, W) float32 logits, the layers in
        ``compute_dtype`` (a row-sharded trunk's rows gathered)."""
        out, rows = self._trunk_logits(codes, train, generator, condition)
        return out if rows is None else mesh_lib.gather_from_axis(out, 2,
                                                                  "seq")

    def _extra(self, codes: Tensor, rows: Optional[Tuple[int, int]] = None
               ) -> Optional[Tensor]:
        return None

    def forward(self, codes: Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None,
                condition: Optional[Tensor] = None) -> Tensor:
        """(B, H, W) int codes (and an NHWC ``condition`` plane where the
        prior has conditional channels) -> (B, H, W, K) float32 logits."""
        return self.logits_nchw(codes, train, generator,
                                condition).permute(0, 2, 3, 1)

    def loss_function(self, codes: Tensor, train: bool = True,
                      generator: Optional[torch.Generator] = None,
                      condition: Optional[Tensor] = None
                      ) -> Dict[str, Tensor]:
        """Mean cross-entropy of the codes under their own logits. Under
        an active context-parallel config every ``seq`` rank's gradient is
        its part of the whole (the trainer sums them): a sharded trunk's
        rows', a whole trunk's 1/S (``parallel/context.py``)."""
        logits, rows = self._trunk_logits(codes, train, generator,
                                          condition)
        if rows is None:
            return {"total_loss": cp_lib.part_of_whole(
                F.cross_entropy(logits, codes.long()))}
        ce = F.cross_entropy(logits, codes[:, rows[0]:rows[1]].long(),
                             reduction="sum") / codes.numel()
        return {"total_loss": cp_lib.sum_over_seq(ce)}


class PixelCNN(_Prior):
    """Gated PixelCNN over code grids."""

    def __init__(self, num_embeddings: int, embedding_dim: int = 64,
                 hidden_channels: int = 128, num_layers: int = 15,
                 kernel_size: int = 7, conditional_channels: int = 0,
                 dtype: Any = torch.float32):
        super().__init__()
        self.compute_dtype = resolve_compute_dtype(dtype)
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.hidden_channels = hidden_channels
        self.kernel_size = kernel_size
        self.conditional_channels = conditional_channels
        self.embedding = GatherEmbed(num_embeddings, embedding_dim)
        self.conv_in = MaskedConv(embedding_dim + conditional_channels,
                                  hidden_channels, kernel_size, "A")
        self.res_blocks = nn.ModuleList(
            GatedResBlock(hidden_channels) for _ in range(num_layers))
        self.conv_out = self._head()

    def _logits(self, h: Tensor, train: bool,
                generator: Optional[torch.Generator]) -> Tensor:
        h = self.conv_in(h)
        for blk in self.res_blocks:
            h = blk(h)
        return self.conv_out(h)


class PixelSNAIL(_Prior):
    """PixelCNN + causal attention blocks + coordinate channels."""

    def __init__(self, num_embeddings: int, embedding_dim: int = 64,
                 hidden_channels: int = 128, num_blocks: int = 8,
                 num_res_blocks_per_layer: int = 2, num_heads: int = 8,
                 kernel_size: int = 7, conditional_channels: int = 0,
                 dropout: float = 0.1, attn_dropout_mode: str = "output",
                 dtype: Any = torch.float32):
        super().__init__()
        self.compute_dtype = resolve_compute_dtype(dtype)
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.hidden_channels = hidden_channels
        self.kernel_size = kernel_size
        self.conditional_channels = conditional_channels
        self.num_heads = num_heads
        self.dropout = dropout
        self.attn_dropout_mode = attn_dropout_mode
        self.embedding = GatherEmbed(num_embeddings, embedding_dim)
        self.conv_in = MaskedConv(embedding_dim + 2 + conditional_channels,
                                  hidden_channels, kernel_size, "A")
        self.blocks = nn.ModuleList(
            PixelSNAILBlock(hidden_channels, num_res_blocks_per_layer,
                            num_heads, dropout, attn_dropout_mode)
            for _ in range(num_blocks))
        self.conv_out = self._head()

    def _extra(self, codes: Tensor, rows: Optional[Tuple[int, int]] = None
               ) -> Tensor:
        """The whole grid's coordinate channels, NCHW, or its ``rows``."""
        b, hh, ww = codes.shape
        pos = _pos_encoding(hh, ww).transpose(0, 3, 1, 2)
        if rows is not None:
            pos = pos[:, :, rows[0]:rows[1]]
        pos = torch.from_numpy(np.ascontiguousarray(pos))
        return pos.to(codes.device).expand(b, -1, -1, -1)

    def _logits(self, h: Tensor, train: bool,
                generator: Optional[torch.Generator]) -> Tensor:
        h = self.conv_in(h)
        for blk in self.blocks:
            h = h + blk(h, train=train, generator=generator)
        return self.conv_out(h)


class HierarchicalPrior(nn.Module):
    """Two-level prior P(z_top) P(z_bottom | z_top) for VQ-VAE-2: a top
    prior over z_top, and a PixelCNN over z_bottom conditioned on
    ``condition_from_top(z_top)`` — the top codes embedded and upsampled 2x
    by a k4-s2 transposed conv. Subclasses give ``make_top_module`` and
    ``make_bottom_module``, the single config source of both submodules
    (the samplers sample ``prior_top`` and ``prior_bottom`` themselves)."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 hidden_channels: int, dtype: Any = torch.float32):
        super().__init__()
        self.compute_dtype = resolve_compute_dtype(dtype)
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.hidden_channels = hidden_channels
        self.prior_top = self.make_top_module()
        self.embedding_top = GatherEmbed(num_embeddings, embedding_dim)
        self.upsample_top = nn.ConvTranspose2d(embedding_dim, embedding_dim,
                                               4, 2, 1)
        self.prior_bottom = self.make_bottom_module()

    def make_top_module(self) -> _Prior:
        raise NotImplementedError

    def make_bottom_module(self) -> "PixelCNN":
        raise NotImplementedError

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """The JAX package's initializers (see ``_Prior``); the upsampling
        transposed conv is lecun-normal over its input channels."""
        self.prior_top.reset_parameters(generator)
        self.embedding_top.reset_parameters(generator)
        w = self.upsample_top.weight
        std = math.sqrt(1.0 / (w.shape[0] * w.shape[2] * w.shape[3]))
        std /= _TRUNC_STD_CORRECTION
        nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                              generator=generator)
        self.upsample_top.bias.zero_()
        self.prior_bottom.reset_parameters(generator)

    def condition_from_top(self, z_top: Tensor) -> Tensor:
        """(B, h, w) top codes -> (B, 2h, 2w, D) conditioning plane, in
        ``compute_dtype``."""
        emb = self.embedding_top(z_top).permute(0, 3, 1, 2)
        with compute_region(self.compute_dtype, z_top.device):
            return self.upsample_top(emb).permute(0, 2, 3, 1)

    def forward(self, z_top: Tensor, z_bottom: Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, Tensor]:
        cond = self.condition_from_top(z_top)
        return {"logits_top": self.prior_top(z_top, train, generator),
                "logits_bottom": self.prior_bottom(z_bottom, train, generator,
                                                   condition=cond)}

    def loss_function(self, z_top: Tensor, z_bottom: Tensor,
                      train: bool = True,
                      generator: Optional[torch.Generator] = None
                      ) -> Dict[str, Tensor]:
        """Mean cross-entropy of each level; ``total_loss`` is their sum."""
        cond = self.condition_from_top(z_top)
        lt = self.prior_top.loss_function(z_top, train,
                                          generator)["total_loss"]
        lb = self.prior_bottom.loss_function(
            z_bottom, train, generator, condition=cond)["total_loss"]
        return {"loss_top": lt, "loss_bottom": lb, "total_loss": lt + lb}


class HierarchicalPixelCNN(HierarchicalPrior):
    """PixelCNN top prior, conditioned PixelCNN bottom prior."""

    def __init__(self, num_embeddings: int, embedding_dim: int = 64,
                 hidden_channels: int = 128, num_layers: int = 15,
                 dtype: Any = torch.float32):
        self.num_layers = num_layers
        super().__init__(num_embeddings, embedding_dim, hidden_channels,
                         dtype)

    def make_top_module(self) -> "PixelCNN":
        return PixelCNN(self.num_embeddings, self.embedding_dim,
                        self.hidden_channels, self.num_layers,
                        dtype=self.compute_dtype)

    def make_bottom_module(self) -> "PixelCNN":
        return PixelCNN(self.num_embeddings, self.embedding_dim,
                        self.hidden_channels, self.num_layers,
                        conditional_channels=self.embedding_dim,
                        dtype=self.compute_dtype)


class HierarchicalPixelSNAIL(HierarchicalPrior):
    """Attention (PixelSNAIL) top prior, conditioned PixelCNN bottom prior,
    per the VQ-VAE-2 paper."""

    def __init__(self, num_embeddings: int, embedding_dim: int = 64,
                 hidden_channels: int = 128, num_blocks_top: int = 8,
                 num_res_blocks_per_layer: int = 2, num_heads: int = 8,
                 num_layers_bottom: int = 15, dropout: float = 0.1,
                 attn_dropout_mode: str = "output",
                 dtype: Any = torch.float32):
        self.num_blocks_top = num_blocks_top
        self.num_res_blocks_per_layer = num_res_blocks_per_layer
        self.num_heads = num_heads
        self.num_layers_bottom = num_layers_bottom
        self.dropout = dropout
        self.attn_dropout_mode = attn_dropout_mode
        super().__init__(num_embeddings, embedding_dim, hidden_channels,
                         dtype)

    def make_top_module(self) -> "PixelSNAIL":
        return PixelSNAIL(
            self.num_embeddings, self.embedding_dim, self.hidden_channels,
            self.num_blocks_top, self.num_res_blocks_per_layer,
            self.num_heads, dropout=self.dropout,
            attn_dropout_mode=self.attn_dropout_mode,
            dtype=self.compute_dtype)

    def make_bottom_module(self) -> "PixelCNN":
        return PixelCNN(self.num_embeddings, self.embedding_dim,
                        self.hidden_channels, self.num_layers_bottom,
                        conditional_channels=self.embedding_dim,
                        dtype=self.compute_dtype)


# ===========================================================================
# Sampling
# ===========================================================================

def _context_active() -> bool:
    from movae_tpu_torch.parallel.context import get_context_parallel

    ctx = get_context_parallel()
    return ctx is not None and ctx.size > 1


def warn_long_seq_dropout(model, h: int, w: int) -> None:
    """The JAX package's construction-site notice for a PixelSNAIL-family
    prior with dropout > 0 in "weights" mode where dropout falls on the
    attention output (the flash path past the dense threshold, the ring
    under context parallelism at any L), not on the attention weights as
    in the reference (pixelcnn_prior.py:126-127)."""
    L = h * w
    dropout = float(getattr(model, "dropout", 0.0) or 0.0)
    if not (isinstance(model, (PixelSNAIL, HierarchicalPixelSNAIL))
            and dropout > 0.0
            and getattr(model, "attn_dropout_mode", "output") == "weights"):
        return
    if L > DENSE_ATTENTION_MAX_L:
        print(f"Note: attention grid {h}x{w} (L={L}) exceeds the dense "
              f"threshold ({DENSE_ATTENTION_MAX_L}); dropout={dropout} is "
              "applied to the attention output (flash-compatible), not the "
              "attention weights as in the reference (pixelcnn_prior.py:"
              "126-127).")
    elif _context_active():
        from movae_tpu_torch.parallel.context import get_context_parallel
        print(f"Note: --context_parallel {get_context_parallel().size} "
              "routes attention through the ring path; dropout="
              f"{dropout} is applied to the attention output, not the "
              "attention weights as in the reference (pixelcnn_prior.py:"
              "126-127).")


def _device(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


def gumbel_noise(generator: Optional[torch.Generator], length: int,
                 batch_size: int, num_embeddings: int,
                 device: torch.device) -> Tensor:
    """(L, B, K) standard Gumbel noise drawn in one call from ``generator``:
    pixel t's draw is row t, whatever the sampler."""
    u = torch.rand((length, batch_size, num_embeddings), generator=generator,
                   device=device)
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))


def _noise(gumbel: Optional[Tensor], generator, model, batch_size: int,
           length: int) -> Tensor:
    dev = _device(model)
    if gumbel is None:
        return gumbel_noise(generator, length, batch_size,
                            model.num_embeddings, dev)
    gumbel = torch.as_tensor(gumbel, dtype=torch.float32, device=dev)
    want = (length, batch_size, model.num_embeddings)
    if tuple(gumbel.shape) != want:
        raise ValueError(f"gumbel noise must be (L, B, K) = {want}, got "
                         f"{tuple(gumbel.shape)}")
    return gumbel


@torch.no_grad()
def sample_naive(model: _Prior, generator: Optional[torch.Generator],
                 batch_size: int, height: int, width: int,
                 condition: Optional[Tensor] = None,
                 temperature: float = 1.0,
                 gumbel: Optional[Tensor] = None) -> Tensor:
    """Raster sampling with the full forward once per pixel — the oracle the
    cached samplers are held against. Works for any flat prior."""
    g = _noise(gumbel, generator, model, batch_size, height * width)
    samples = torch.zeros((batch_size, height, width), dtype=torch.int32,
                          device=g.device)
    for t in range(height * width):
        i, j = divmod(t, width)
        logits = model.logits_nchw(samples, condition=condition)[:, :, i, j]
        samples[:, i, j] = (logits / temperature + g[t]).argmax(-1).to(
            torch.int32)
    return samples


def _flat_masked(conv: MaskedConv) -> Tensor:
    """Masked (cout, cin, kh, kw) kernel -> (kh * kw * cin, cout), the order
    of an NHWC neighbourhood flattened row by row."""
    w = conv.weight * conv.mask
    return w.permute(2, 3, 1, 0).reshape(-1, w.shape[0])


def _w1x1(conv: nn.Conv2d) -> Tensor:
    """1x1 conv (cout, cin, 1, 1) -> (cin, cout) for ``x @ w``."""
    return conv.weight[:, :, 0, 0].T


class _GatedStep(nn.Module):
    """One ``GatedResBlock`` at a front's cells over a padded NHWC cache of
    its conv1 output plane: conv1 is written at the cells' cache positions,
    then each cell reads its 3x3 neighbourhood for the masked k3 conv; the
    gate and feature 1x1 convs are fused into one product (each output
    column keeps its own reduction, so the fusion changes no number)."""

    def __init__(self, blk: GatedResBlock):
        super().__init__()
        self.register_buffer("w1", _w1x1(blk.conv1).contiguous())
        self.register_buffer("b1", blk.conv1.bias.detach())
        self.register_buffer("w2", _flat_masked(blk.conv2).contiguous())
        self.register_buffer("b2", blk.conv2.bias.detach())
        self.register_buffer("wgf", torch.cat(
            [_w1x1(blk.conv_gate), _w1x1(blk.conv_feature)], dim=1))
        self.register_buffer("bgf", torch.cat(
            [blk.conv_gate.bias, blk.conv_feature.bias]).detach())
        self.hc = blk.conv_gate.out_channels

    def cache_shape(self, batch_size: int, height: int, width: int):
        return (batch_size, height + 2, width + 2, self.w1.shape[1])

    def forward(self, cache: Tensor, x: Tensor, c1_at: Tensor,
                c1_win: Tensor) -> Tensor:
        """x (B * C, hc), rows batch-major, for the C cells of ``c1_at``;
        ``c1_win`` (C, 9) their 3x3 windows in the flattened cache."""
        b, c = cache.shape[0], c1_at.shape[0]
        flat = cache.view(b, -1, cache.shape[-1])
        flat.index_copy_(1, c1_at, F.relu(torch.addmm(
            self.b1, x, self.w1)).view(b, c, -1))
        nb = flat.index_select(1, c1_win.reshape(-1)).view(b * c, -1)
        c2 = F.relu(torch.addmm(self.b2, nb, self.w2))
        gf = torch.addmm(self.bgf, c2, self.wgf)
        return x + torch.sigmoid(gf[:, :self.hc]) * torch.tanh(gf[:, self.hc:])


class _AttentionStep(nn.Module):
    """One ``CausalAttention`` at one pixel with a key/value cache: the
    pixel's (k, v) rows are written at its raster position t and its query
    attends over the whole cache with the keys past t masked out, so that
    every step has the same shapes (a step is captured once and replayed:
    ``device.py:replay_steps``), as the JAX package's static-shape
    ``SNAIL_KV_SEGMENTS`` prefixes are masked. A ``cache_dtype`` of the
    model's own dtype (float32, or float64 for a reference) keeps the rows
    exact; bfloat16 rounds them (and the query and probabilities) to
    bfloat16; int8 stores each row as int8 with a per-(batch, head) max-abs
    scale, which factors out of both products (logit_j = (q . k8_j) s^k_j,
    out = sum_j (p_j s^v_j) v8_j), the query and the scaled probabilities
    rounded to bfloat16. The products run in the model's dtype on the exact
    upcast values, so they accumulate in float32 as the JAX package's
    ``preferred_element_type`` does."""

    def __init__(self, att: CausalAttention, cache_dtype: torch.dtype):
        super().__init__()
        self.nh, self.hd = att.num_heads, att.head_dim
        self.register_buffer("wqkv", torch.cat(
            [_w1x1(att.q_proj), _w1x1(att.k_proj), _w1x1(att.v_proj)],
            dim=1))
        self.register_buffer("bqkv", torch.cat(
            [att.q_proj.bias, att.k_proj.bias, att.v_proj.bias]).detach())
        self.register_buffer("wo", _w1x1(att.out_proj).contiguous())
        self.register_buffer("bo", att.out_proj.bias.detach())
        self.scale = 1.0 / math.sqrt(self.hd)
        self.dtype = cache_dtype
        self.int8 = cache_dtype == torch.int8
        self.lossy = cache_dtype in (torch.bfloat16, torch.int8)
        self.num_caches = 4 if self.int8 else 2

    def cache_specs(self, batch_size: int, length: int) -> list:
        """(shape, dtype) of k, v (and their int8 scales)."""
        shape = (batch_size, self.nh, length, self.hd)
        specs = [(shape, self.dtype), (shape, self.dtype)]
        if self.int8:
            specs += [(shape[:3], self.wqkv.dtype)] * 2
        return specs

    def _lossy(self, x: Tensor) -> Tensor:
        """What the products see of an operand: itself, or its bfloat16
        rounding for the bfloat16 and int8 caches."""
        return x.to(torch.bfloat16).to(x.dtype) if self.lossy else x

    def _store(self, cache: Tensor, scales: Optional[Tensor], row: Tensor,
               t: Tensor) -> None:
        if self.int8:
            s = row.abs().amax(-1).clamp_min(1e-8) / 127.0
            scales.index_copy_(2, t, s[..., None])
            row = torch.clamp(torch.round(row / s[..., None]), -127, 127)
        cache.index_copy_(2, t, row.to(self.dtype)[:, :, None])

    def forward(self, x: Tensor, caches, t: Tensor) -> Tensor:
        """``x`` (B, C) at the pixel of raster position ``t`` (1,)."""
        b = x.shape[0]
        kc, vc = caches[0], caches[1]
        ks, vs = (caches[2], caches[3]) if self.int8 else (None, None)
        qkv = torch.addmm(self.bqkv, x, self.wqkv).reshape(b, 3, self.nh,
                                                           self.hd)
        self._store(kc, ks, qkv[:, 1], t)
        self._store(vc, vs, qkv[:, 2], t)
        q = self._lossy(qkv[:, 0])
        logits = torch.einsum("bnd,bnld->bnl", q, kc.to(q.dtype)) * self.scale
        if self.int8:
            logits = logits * ks
        later = torch.arange(kc.shape[2], device=t.device) > t
        probs = torch.softmax(logits.masked_fill(later, float("-inf")),
                              dim=-1)
        if self.int8:
            probs = probs * vs
        out = torch.einsum("bnl,bnld->bnd", self._lossy(probs),
                           vc.to(probs.dtype))
        # dim-major flatten (channel d * heads + head), as CausalAttention
        return torch.addmm(self.bo, out.transpose(1, 2).reshape(b, -1),
                           self.wo)


# a sampler step's index columns, in the order the step takes them: the
# cells' raster positions, their positions in the padded input cache and
# conv1 caches, and their k x k and 3 x 3 windows there
FRONT_COLUMNS = ("t", "in_at", "in_win", "c1_at", "c1_win")


def front_table(height: int, width: int, k: int, raster: bool = False):
    """The cells of every front, front by front, as int64 numpy columns
    (:data:`FRONT_COLUMNS`; the windows (cells, k * k) and (cells, 9)), and
    each front's [start, stop) rows, (S, 2). Wavefront (``raster`` False):
    the fronts d = s * i + j, s = k // 2 + 1 (at least 2), in order: every
    pixel that a pixel's masked convolutions see lies on an earlier front
    (the mask-A input conv's last tap (i - 1, j + k // 2) on front d - 1,
    the mask-B 3x3 taps on d - 1 and earlier), so a front's cells are drawn
    in one step. Raster: one pixel a front, in raster order."""
    pad, s = k // 2, max(k // 2 + 1, 2)
    ii, jj = np.divmod(np.arange(height * width), width)
    key = ii * width + jj if raster else s * ii + jj
    order = np.lexsort((ii, key))  # by front, then row
    ii, jj, key = ii[order], jj[order], key[order]
    wp, w1 = width + 2 * pad, width + 2
    ak, a3 = np.arange(k), np.arange(3)
    in_win = ((ii[:, None, None] + ak[None, :, None]) * wp
              + jj[:, None, None] + ak[None, None, :])
    c1_win = ((ii[:, None, None] + a3[None, :, None]) * w1
              + jj[:, None, None] + a3[None, None, :])
    cols = {"t": ii * width + jj, "in_at": (ii + pad) * wp + jj + pad,
            "in_win": in_win.reshape(-1, k * k), "c1_at": (ii + 1) * w1 + jj + 1,
            "c1_win": c1_win.reshape(-1, 9)}
    ends = np.cumsum(np.bincount(key))
    starts = np.concatenate([[0], ends[:-1]])
    keep = ends > starts  # no cell on a front of a grid narrower than s
    return ({n: v.astype(np.int64) for n, v in cols.items()},
            np.stack([starts[keep], ends[keep]], axis=1).astype(np.int64))


class SamplerStep(nn.Module):
    """One step of the cached samplers as a function of tensors alone, so
    that ``torch.export`` can hold it: ``forward(state, idx, gumbel)``
    draws the codes of one front's C cells (B, C) and writes them into
    ``state`` in place.

    ``state`` (:meth:`state_specs`, zeros, then :meth:`init_state`): the
    padded NHWC cache of the mask-A input conv's input plane (the code
    embeddings as they are drawn; PixelSNAIL's coordinates and the
    condition written up front), one padded cache of each gated block's
    conv1 plane, PixelSNAIL's key/value caches, and the (B, H, W) int32
    codes, last. ``idx``: the front's :data:`FRONT_COLUMNS`, slices of
    :meth:`tables`. ``gumbel`` (L, B, K):
    pixel t draws argmax(logits / T + gumbel[t]). Each layer computes its
    output at the front's cells from its cached k x k or 3 x 3
    neighbourhood, so every sampler here draws the codes of
    :func:`sample_naive` from the same noise. PixelCNN runs raster fronts
    (:func:`sample_fast`) or skew-diagonal ones (:func:`sample_wavefront`);
    PixelSNAIL raster fronts only (a raster-earlier key can lie on a later
    front), attending over its key/value caches in ``cache_dtype``."""

    def __init__(self, model: "_Prior", batch_size: int, height: int,
                 width: int, temperature: float = 1.0,
                 cache_dtype: torch.dtype = torch.int8,
                 raster: bool = True):
        super().__init__()
        self.snail = isinstance(model, PixelSNAIL)
        self.batch_size, self.height, self.width = batch_size, height, width
        self.temperature = temperature
        self.raster = raster or self.snail
        k = model.conv_in.kernel_size[0]
        self.k, self.pad, self.e = k, k // 2, model.embedding_dim
        self.cin = model.conv_in.in_channels
        self.register_buffer("table", model.embedding.weight.detach())
        self.register_buffer("w_in", _flat_masked(model.conv_in).contiguous())
        self.register_buffer("b_in", model.conv_in.bias.detach())
        head = model.conv_out
        self.register_buffer("wh1", _w1x1(head[1]).contiguous())
        self.register_buffer("bh1", head[1].bias.detach())
        self.register_buffer("wh2", _w1x1(head[3]).contiguous())
        self.register_buffer("bh2", head[3].bias.detach())
        self.pos = None
        if self.snail:
            self.pos = torch.from_numpy(_pos_encoding(height, width))
            self.blocks = nn.ModuleList(
                nn.ModuleList([nn.ModuleList(_GatedStep(r)
                                             for r in blk.res_blocks),
                               _AttentionStep(blk.attention, cache_dtype),
                               _OutConv(blk.out_conv)])
                for blk in model.blocks)
        else:
            self.layers = nn.ModuleList(_GatedStep(r)
                                        for r in model.res_blocks)

    def _gated(self):
        if self.snail:
            return [r for res, _, _ in self.blocks for r in res]
        return list(self.layers)

    def state_specs(self) -> list:
        """(shape, dtype) of each state tensor, in order."""
        b, h, w = self.batch_size, self.height, self.width
        dt = self.w_in.dtype
        specs = [((b, h + 2 * self.pad, w + 2 * self.pad, self.cin), dt)]
        if self.snail:
            for res, att, _ in self.blocks:
                specs += [(r.cache_shape(b, h, w), dt) for r in res]
                specs += att.cache_specs(b, h * w)
        else:
            specs += [(r.cache_shape(b, h, w), dt) for r in self.layers]
        return specs + [((b, h, w), torch.int32)]

    def new_state(self, condition: Optional[Tensor] = None) -> list:
        """Zeroed state on the model's device, initialised
        (:meth:`init_state`)."""
        dev = self.w_in.device
        state = [torch.zeros(s, dtype=d, device=dev)
                 for s, d in self.state_specs()]
        self.init_state(state, condition)
        return state

    def init_state(self, state: list, condition: Optional[Tensor] = None
                   ) -> None:
        """Write the planes that follow the code embedding in conv_in's
        input (PixelSNAIL's coordinates, then the NHWC ``condition``) into
        the input cache."""
        planes = []
        if self.pos is not None:
            planes.append(self.pos.to(self.w_in).expand(
                self.batch_size, -1, -1, -1))
        if condition is not None:
            planes.append(condition.to(self.w_in))
        if planes:
            p, h, w = self.pad, self.height, self.width
            state[0][:, p:p + h, p:p + w, self.e:] = torch.cat(planes, -1)

    def tables(self):
        """Each step's index tensors as slices of int64 columns: ``(cols,
        bounds)``, ``bounds[name]`` (S, 2) the [start, stop) rows of
        ``cols[name]`` at each step; the columns in the order ``idx`` takes
        them."""
        cols, fronts = front_table(self.height, self.width, self.k,
                                   self.raster)
        out = {n: torch.from_numpy(cols[n]) for n in FRONT_COLUMNS}
        return out, {n: fronts for n in FRONT_COLUMNS}

    def steps(self) -> list:
        """Every step's ``idx``, slices of :meth:`tables` on the model's
        device."""
        cols, bounds = self.tables()
        dev = self.w_in.device
        cols = {n: c.to(dev) for n, c in cols.items()}
        rows = {n: b.tolist() for n, b in bounds.items()}
        return [[cols[n][rows[n][s][0]:rows[n][s][1]] for n in cols]
                for s in range(len(rows["t"]))]

    def logits(self, state: list, idx: list) -> Tensor:
        """The front's logits over the temperature, (B, C, K)."""
        t, in_at, in_win, c1_at, c1_win = idx
        inp = state[0]
        b, c = inp.shape[0], t.shape[0]
        flat = inp.view(b, -1, inp.shape[-1])
        nb = flat.index_select(1, in_win.reshape(-1)).view(b * c, -1)
        x = torch.addmm(self.b_in, nb, self.w_in)
        i = 1
        if self.snail:
            h = x
            for res, att, out_conv in self.blocks:
                x = h
                for r in res:
                    x = r(state[i], x, c1_at, c1_win)
                    i += 1
                na = att.num_caches
                h = h + out_conv(torch.cat([x, att(x, state[i:i + na], t)],
                                           dim=1)) + x
                i += na
        else:
            for r in self.layers:
                x = r(state[i], x, c1_at, c1_win)
                i += 1
            h = x
        h = F.relu(torch.addmm(self.bh1, F.relu(h), self.wh1))
        return (torch.addmm(self.bh2, h, self.wh2)
                / self.temperature).view(b, c, -1)

    def write(self, state: list, idx: list, code: Tensor) -> None:
        """Write the front's codes (B, C) into the codes and the input
        cache."""
        t, in_at = idx[0], idx[1]
        inp, samples = state[0], state[-1]
        b = inp.shape[0]
        samples.view(b, -1).index_copy_(1, t, code.to(torch.int32))
        inp.view(b, -1, inp.shape[-1])[:, in_at, :self.e] = self.table[code]

    def forward(self, state: list, idx: list, gumbel: Tensor) -> Tensor:
        g = gumbel.index_select(0, idx[0]).transpose(0, 1)
        code = (self.logits(state, idx) + g).argmax(-1)
        self.write(state, idx, code)
        return code


class _OutConv(nn.Module):
    """PixelSNAIL's 1x1 merge conv at a front's cells."""

    def __init__(self, conv: nn.Conv2d):
        super().__init__()
        self.register_buffer("w", _w1x1(conv).contiguous())
        self.register_buffer("b", conv.bias.detach())

    def forward(self, x: Tensor) -> Tensor:
        return torch.addmm(self.b, x, self.w)


def run_sampler(step: SamplerStep, gumbel: Tensor,
                condition: Optional[Tensor] = None) -> Tensor:
    """The cached sampling loop: ``step`` over every front of its tables
    from a fresh state (``device.py:replay_steps``: on the card, raster
    steps replay one captured CUDA graph); returns the (B, H, W) int32
    codes."""
    state = step.new_state(condition)
    replay_steps(step, state, step.steps(), gumbel)
    return state[-1]


def _run_sharded(make_step: Callable[[int], SamplerStep], gumbel: Tensor,
                 condition: Optional[Tensor]) -> Tensor:
    """:func:`run_sampler` over this rank's rows of the global (L, B, K)
    noise and condition under an active sample-parallel config
    (``parallel/context.py``), the codes gathered back into the global
    batch; the whole batch otherwise. ``make_step(b)`` builds the step
    for b rows."""
    batch = gumbel.shape[1]
    g = shard_sample_batch(gumbel, 1)
    codes = run_sampler(make_step(g.shape[1]), g,
                        shard_sample_batch(condition, 0))
    return gather_sample_batch(codes, batch)


@torch.no_grad()
def sample_fast(model: PixelCNN, generator: Optional[torch.Generator],
                batch_size: int, height: int, width: int,
                condition: Optional[Tensor] = None, temperature: float = 1.0,
                gumbel: Optional[Tensor] = None) -> Tensor:
    """Cached raster sampler for PixelCNN (:class:`SamplerStep` over raster
    fronts): at each pixel every layer computes one output vector from its
    cached k x k neighbourhood instead of a full-plane convolution. The
    caches are padded, so no bounds are checked. Draws the codes of
    :func:`sample_naive` from the same noise."""
    g = _noise(gumbel, generator, model, batch_size, height * width)
    return _run_sharded(lambda b: SamplerStep(
        model, b, height, width, temperature, raster=True), g, condition)


def _sample_fronts(model: PixelCNN, batch_size: int, height: int,
                   width: int, condition: Optional[Tensor],
                   temperature: float, draw) -> Tensor:
    """The wavefront loop with ``draw(logits (B, C, K), t (C,)) -> codes (B,
    C)`` picking each front's codes from its logits over the temperature
    (:meth:`SamplerStep.logits` and :meth:`SamplerStep.write`, the two
    halves of the sampler's step)."""
    step = SamplerStep(model, batch_size, height, width, temperature,
                       raster=False)
    state = step.new_state(condition)
    for idx in step.steps():
        step.write(state, idx, draw(step.logits(state, idx), idx[0]))
    return state[-1]


@torch.no_grad()
def sample_wavefront(model: PixelCNN, generator: Optional[torch.Generator],
                     batch_size: int, height: int, width: int,
                     condition: Optional[Tensor] = None,
                     temperature: float = 1.0,
                     gumbel: Optional[Tensor] = None) -> Tensor:
    """Skew-diagonal (wavefront) cached sampler for PixelCNN: the H * W
    raster steps of :func:`sample_fast` become ``s * (H - 1) + W`` fronts
    (s = kernel_size // 2 + 1; 316 instead of 4,096 at 64x64 with k = 7),
    each drawing up to ceil(W / s) cells at once over ``sample_fast``'s own
    padded caches: each cell reads the same k x k and 3 x 3 windows, which
    hold the same values (every tap a pixel's mask lets through lies on an
    earlier front, every masked tap on a later one), through a product of
    B * C rows instead of B. Pixel t draws with ``gumbel[t]``, so this draws
    the codes of :func:`sample_fast` and :func:`sample_naive` from the same
    noise. Attention rules it out for PixelSNAIL: a raster-earlier key can
    lie on a later front."""
    g = _noise(gumbel, generator, model, batch_size, height * width)
    return _run_sharded(lambda b: SamplerStep(
        model, b, height, width, temperature, raster=False), g, condition)


@torch.no_grad()
def sample_fast_snail(model: PixelSNAIL, generator: Optional[torch.Generator],
                      batch_size: int, height: int, width: int,
                      condition: Optional[Tensor] = None,
                      temperature: float = 1.0,
                      cache_dtype: torch.dtype = torch.int8,
                      forced: Optional[Tensor] = None,
                      return_logits: bool = False,
                      gumbel: Optional[Tensor] = None):
    """Cached raster sampler for PixelSNAIL (:class:`SamplerStep`):
    :func:`sample_fast`'s activation caches plus a key/value cache per
    attention block, each pixel's attention reading the whole cache with
    the keys past it masked (as the JAX package masks its static-shape
    ``SNAIL_KV_SEGMENTS`` prefixes). ``cache_dtype`` (the model's dtype,
    bfloat16 or int8, see ``_AttentionStep``): float32 draws the codes of
    :func:`sample_naive`.

    ``forced`` (B, H, W) teacher-forces the sequence: each pixel's code is
    read from it instead of drawn. ``return_logits`` also returns the
    per-pixel logits over the temperature, (B, H, W, K) in the model's
    dtype, as ``(samples, logits)``."""
    L = height * width
    dev = _device(model)
    if forced is None and not return_logits:
        return _run_sharded(lambda b: SamplerStep(
            model, b, height, width, temperature, cache_dtype),
            _noise(gumbel, generator, model, batch_size, L), condition)
    step = SamplerStep(model, batch_size, height, width, temperature,
                       cache_dtype)
    if forced is not None:
        forced, g = torch.as_tensor(forced, device=dev).long(), None
    else:
        g = _noise(gumbel, generator, model, batch_size, L)
    state = step.new_state(condition)
    logits_buf = (step.w_in.new_zeros((batch_size, L, model.num_embeddings))
                  if return_logits else None)
    for idx in step.steps():
        logits = step.logits(state, idx)
        if return_logits:
            logits_buf[:, idx[0]] = logits
        if forced is not None:
            code = forced.view(batch_size, -1)[:, idx[0]]
        else:
            code = (logits + g.index_select(0, idx[0]).transpose(0, 1)
                    ).argmax(-1)
        step.write(state, idx, code)
    if return_logits:
        return state[-1], logits_buf.view(batch_size, height, width, -1)
    return state[-1]


def wavefront_steps(kernel_size: int, height: int, width: int) -> int:
    """The number of fronts :func:`sample_wavefront` takes for a grid."""
    return max(kernel_size // 2 + 1, 2) * (height - 1) + width


def sample_prior(model: _Prior, generator: Optional[torch.Generator],
                 batch_size: int, height: int, width: int,
                 condition: Optional[Tensor] = None,
                 temperature: float = 1.0, fast: bool = True,
                 cache_dtype: torch.dtype = torch.int8,
                 gumbel: Optional[Tensor] = None) -> Tensor:
    """Dispatch: the cached sampler for PixelSNAIL and PixelCNN with
    ``fast``, :func:`sample_naive` otherwise. ``cache_dtype`` only affects
    the PixelSNAIL key/value cache (float32 for the naive sampler's codes;
    int8, the default, reads a quarter of the bytes).

    PixelCNN takes :func:`sample_wavefront` wherever it has fewer fronts
    than the grid has pixels (more than one row, wider than s =
    k // 2 + 1), else
    :func:`sample_fast`; both draw the same codes. On one H100 80GB HBM3
    at 700 W a step of either is mostly host time whatever its width:
    2.2-5.4 ms a front against 1.9-4.8 ms a raster step, so the wavefront
    drew 5.1-7.5x the raster sampler's pixels/s at 32x32 and 7.5-17.2x at
    64x64, batch 16 and 128 (``chip_smoke.py`` phase 14; PERF.md).
    The JAX package's rule, 256 <= H * W <= 1024, comes from TPU timings
    where a 64x64 raster step was compute-bound."""
    if fast and isinstance(model, PixelSNAIL):
        return sample_fast_snail(model, generator, batch_size, height, width,
                                 condition, temperature,
                                 cache_dtype=cache_dtype, gumbel=gumbel)
    if fast and isinstance(model, PixelCNN):
        sampler = (sample_wavefront if wavefront_steps(
            model.kernel_size, height, width) < height * width
            else sample_fast)
        return sampler(model, generator, batch_size, height, width,
                       condition, temperature, gumbel=gumbel)
    return sample_naive(model, generator, batch_size, height, width,
                        condition, temperature, gumbel=gumbel)


@torch.no_grad()
def sample_hierarchical(model: HierarchicalPrior,
                        generator: Optional[torch.Generator],
                        batch_size: int, top_shape: Tuple[int, int],
                        bottom_shape: Tuple[int, int],
                        temperature: float = 1.0, fast: bool = True,
                        cache_dtype: torch.dtype = torch.int8,
                        gumbel: Optional[Tuple[Tensor, Tensor]] = None
                        ) -> Tuple[Tensor, Tensor]:
    """Sample z_top, then z_bottom | z_top through ``condition_from_top``.
    The top noise is drawn before the bottom noise, or both are given as
    ``gumbel = (top (Lt, B, K), bottom (Lb, B, K))``."""
    g_top, g_bottom = gumbel if gumbel is not None else (None, None)
    if g_top is None:
        g_top = _noise(None, generator, model, batch_size,
                       top_shape[0] * top_shape[1])
        g_bottom = _noise(None, generator, model, batch_size,
                          bottom_shape[0] * bottom_shape[1])
    z_top = sample_prior(model.prior_top, None, batch_size, *top_shape,
                         temperature=temperature, fast=fast,
                         cache_dtype=cache_dtype, gumbel=g_top)
    cond = model.condition_from_top(z_top)
    z_bottom = sample_prior(model.prior_bottom, None, batch_size,
                            *bottom_shape, condition=cond,
                            temperature=temperature, fast=fast,
                            cache_dtype=cache_dtype, gumbel=g_bottom)
    return z_top, z_bottom
