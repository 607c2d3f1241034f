"""PixelSNAIL (Chen et al., arXiv:1712.09763) over a grid of discrete
codes, as MO-VAE's prior trains it.

The code embedding (K x D) plus two coordinate channels ((i - H/2) / H,
(j - W/2) / W) enter a causal 7x7 convolution of type A. Each block then
adds to its input h: ``out_conv([x, attn(x)]) + x``, where x is h through
the block's gated residual layers (1x1 down to C/2, ReLU, causal 3x3 of
type B, ReLU, then ``x + sigmoid(1x1) * tanh(1x1)``) and attn is causal
multi-head self-attention over the raster sequence (1x1 projections,
inclusive diagonal, scale 1/sqrt(head size)), with dropout on its output.
The head is ReLU, 1x1, ReLU, 1x1 to K logits; the loss is the mean
cross-entropy of the codes under their own logits.

Head split: projection channel c = head * head_size + d; the attention
output is flattened back as channel = d * heads + head before its 1x1.
Parameter names follow MO-VAE's torch layout.

Dropout follows the trainer's documented draws: one uniform (B, heads,
L, head_size) draw per block from the trainer's generator, in block
order, kept where below 1 - rate and scaled by 1 / (1 - rate).
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.attention import SDPBackend, sdpa_kernel

from portbench.reference.layers import Conv, MaskedConv
from portbench.reference.precision import Precision


class GatedRes(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.prec = Precision()
        self.conv1 = Conv(c, c // 2, 1)
        self.conv2 = MaskedConv(c // 2, c // 2, 3, "B")
        self.conv_gate = Conv(c // 2, c, 1)
        self.conv_feature = Conv(c // 2, c, 1)

    def forward(self, x):
        o = self.prec.output
        out = F.relu(self.conv2(F.relu(self.conv1(x))))
        return o(x + o(o(torch.sigmoid(self.conv_gate(out)))
                       * o(torch.tanh(self.conv_feature(out)))))


class Attention(nn.Module):
    def __init__(self, c: int, heads: int):
        super().__init__()
        self.heads, self.hd = heads, c // heads
        self.prec = Precision()
        self.q_proj = Conv(c, c, 1)
        self.k_proj = Conv(c, c, 1)
        self.v_proj = Conv(c, c, 1)
        self.out_proj = Conv(c, c, 1)

    def forward(self, x, dropout: Optional[Callable] = None):
        b, _, h, w = x.shape
        nh, hd, p = self.heads, self.hd, self.prec.operand

        def split(t):
            return t.reshape(b, nh, hd, h * w).transpose(2, 3).contiguous()

        q, k, v = (split(m(x)) for m in (self.q_proj, self.k_proj,
                                          self.v_proj))
        # on the card the memory-efficient kernel, which sums in float32
        # without the L x L matrix; on the CPU, in float64 and where the
        # precision asks for it the plain matmuls
        backend = (SDPBackend.EFFICIENT_ATTENTION
                   if q.is_cuda and not self.prec.math_attention
                   else SDPBackend.MATH)
        with sdpa_kernel([backend]):
            out = F.scaled_dot_product_attention(
                p(q), p(k), p(v), is_causal=True, scale=1.0 / math.sqrt(hd))
        out = self.prec.output(out)
        if dropout is not None:
            out = dropout(out)
        out = out.permute(0, 3, 1, 2).reshape(b, hd * nh, h, w)
        return self.out_proj(out)


class Block(nn.Module):
    def __init__(self, c: int, n_res: int, heads: int):
        super().__init__()
        self.prec = Precision()
        self.res_blocks = nn.ModuleList(GatedRes(c) for _ in range(n_res))
        self.attention = Attention(c, heads)
        self.out_conv = Conv(2 * c, c, 1)

    def forward(self, x, dropout=None):
        for r in self.res_blocks:
            x = r(x)
        return self.prec.output(self.out_conv(
            torch.cat([x, self.attention(x, dropout)], 1)) + x)


class PixelSNAIL(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        k, d = int(cfg["num_embeddings"]), int(cfg["embedding_dim"])
        c = int(cfg["hidden_channels"])
        self.rate = float(cfg["dropout"])
        self.prec = Precision()
        self.embedding = nn.Module()
        self.embedding.weight = nn.Parameter(torch.empty(k, d))
        self.conv_in = MaskedConv(d + 2, c, int(cfg["kernel_size"]), "A")
        self.blocks = nn.ModuleList(
            Block(c, int(cfg["num_res_blocks"]), int(cfg["num_heads"]))
            for _ in range(int(cfg["num_blocks"])))
        self.conv_out = nn.Sequential(nn.ReLU(), Conv(c, c, 1), nn.ReLU(),
                                      Conv(c, k, 1))

    def logits(self, codes: torch.Tensor,
               masks: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
        """(B, H, W) codes -> (B, K, H, W) float32 logits; ``masks``: each
        block's kept-element mask (B, heads, L, head_size), or None for no
        dropout."""
        b, hh, ww = codes.shape
        emb = self.embedding.weight[codes.long()].permute(0, 3, 1, 2)
        dev = codes.device
        dt = self.embedding.weight.dtype
        ci = (torch.arange(hh, dtype=dt, device=dev) - hh / 2) / hh
        cj = (torch.arange(ww, dtype=dt, device=dev) - ww / 2) / ww
        pos = torch.stack(torch.broadcast_tensors(ci[:, None], cj[None]), 0)
        h = self.conv_in(torch.cat([emb, pos.expand(b, -1, -1, -1)], 1))
        keep = 1.0 - self.rate
        for i, blk in enumerate(self.blocks):
            drop = None
            if masks is not None:
                m = masks[i]
                drop = (lambda t, m=m: torch.where(m, t / keep,
                                                   torch.zeros_like(t)))
            h = self.prec.output(h + blk(h, drop))
        return self.conv_out(h)

    def draw_masks(self, gen: torch.Generator, b: int, length: int
                   ) -> List[torch.Tensor]:
        """One step's dropout masks, drawn as the trainer draws them."""
        a = self.blocks[0].attention
        shape = (b, a.heads, length, a.hd)
        return [torch.rand(shape, generator=gen, device=gen.device)
                < (1.0 - self.rate) for _ in self.blocks]
