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

Under an active context-parallel config (``parallel/context.py``,
``--context_parallel N``) every call takes the ring over the ``seq`` axis
(``ops/ring_attention.py``), at any L, as the JAX package's dispatch does.
A data-parallel prior step (``parallel/mesh.py``) runs these paths on each
rank's rows: attention is per row. Not ported: the JAX package's
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
    """Dispatch: the ring under an active context-parallel config, else
    dense up to ``DENSE_ATTENTION_MAX_L`` and the flash kernels above
    it."""
    from movae_tpu_torch.parallel.context import get_context_parallel

    ctx = get_context_parallel()
    if ctx is not None and ctx.size > 1:
        from movae_tpu_torch.ops.ring_attention import ring_causal_attention
        return ring_causal_attention(q, k, v, sm_scale)
    if q.shape[2] <= DENSE_ATTENTION_MAX_L:
        return dense_causal_attention(q, k, v, sm_scale)
    return flash_causal_attention(q, k, v, sm_scale)
