"""Causal attention for the PixelSNAIL prior — port of
``movae_tpu/ops/attention.py``.

All paths use the inclusive-diagonal causal mask (position i attends to
0..i) over (B, H, L, D) tensors:

  * ``dense`` for L <= ``DENSE_ATTENTION_MAX_L``: the plain O(L^2) masked
    softmax in the inputs' dtype, which is also what XLA runs in the JAX
    package at that length;
  * ``flash`` above it: the hand-written CUDA kernels on the card
    (``movae_tpu_torch/kernels/flash_attention.cu``; a bfloat16 tensor
    reaches the bfloat16 instances, never the float32 ones through a cast),
    their plain version on the CPU.

A data-parallel prior step (``parallel/mesh.py``) runs these paths on each
rank's rows: attention is per row. Not ported: the JAX package's ring
(context-parallel) path, ``ROADMAP.md`` Queue 1 item 13's next sub-item
(``train_prior`` refuses ``context_parallel > 1``), and its
``blockwise_causal_attention`` scan, a CPU fallback and test oracle whose
role the kernel's plain version takes here.
"""

from __future__ import annotations

import torch

from movae_tpu_torch.kernels.flash_attention import (
    dense_causal_attention, flash_causal_attention)

Tensor = torch.Tensor

# Longest raster sequence for which attention uses the dense L x L matrix
# (and with it the attention-WEIGHT dropout of attn_dropout_mode="weights");
# beyond it the flash kernels run and dropout applies to the attention
# OUTPUT.
DENSE_ATTENTION_MAX_L = 1024

__all__ = ["DENSE_ATTENTION_MAX_L", "causal_attention",
           "dense_causal_attention", "flash_causal_attention"]


def causal_attention(q: Tensor, k: Tensor, v: Tensor, sm_scale: float
                     ) -> Tensor:
    """Dispatch: dense up to ``DENSE_ATTENTION_MAX_L``, the flash kernels
    above it."""
    if q.shape[2] <= DENSE_ATTENTION_MAX_L:
        return dense_causal_attention(q, k, v, sm_scale)
    return flash_causal_attention(q, k, v, sm_scale)
