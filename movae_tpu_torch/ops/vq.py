"""Vector-quantization op — port of ``movae_tpu/ops/vq.py``.

The nearest-code indices come from the hand-written CUDA kernel on the card
(``movae_tpu_torch/kernels/nearest_code.cu``) and from its plain PyTorch
version on the CPU, both through the operator ``movae::nearest_code``, so
that an exported graph holds the kernel by name. The quantized rows are a row gather of the codebook
whose gradient is the scatter-add of the output cotangent into the codebook
(``index_add_``) and nothing for the latents; the straight-through
estimator and the commitment/embedding MSEs are built around it.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from movae_tpu_torch.kernels.nearest_code import nearest_code

Tensor = torch.Tensor


def nearest_code_indices(z_flat: Tensor, codebook: Tensor) -> Tensor:
    """(N, D) latents + (K, D) codebook -> (N,) int32 nearest-code indices.
    Not differentiable."""
    return nearest_code(z_flat.detach().float().contiguous(),
                        codebook.detach().float().contiguous())


class _GatherRows(torch.autograd.Function):
    """``codebook[inds]`` whose backward gives the codebook the scatter-add
    of the output cotangent and the indices nothing."""

    @staticmethod
    def forward(ctx, codebook: Tensor, inds: Tensor) -> Tensor:
        ctx.save_for_backward(inds)
        ctx.num_rows = codebook.shape[0]
        return codebook.index_select(0, inds)

    @staticmethod
    def backward(ctx, g: Tensor):
        (inds,) = ctx.saved_tensors
        grad = g.new_zeros((ctx.num_rows,) + tuple(g.shape[1:]))
        return grad.index_add_(0, inds, g), None


def gather_rows(codebook: Tensor, inds: Tensor) -> Tensor:
    """Differentiable (w.r.t. ``codebook``) row gather ``codebook[inds]``."""
    return _GatherRows.apply(codebook, inds.reshape(-1))


def vq_lookup(z_flat: Tensor, codebook: Tensor) -> Tuple[Tensor, Tensor]:
    """Nearest-codebook lookup: returns (quantized rows, indices). Gradient
    flows to the codebook only, none to ``z_flat``."""
    inds = nearest_code_indices(z_flat, codebook)
    return gather_rows(codebook, inds), inds


def used_codes_mask(inds: Tensor, num_embeddings: int) -> Tensor:
    """(...,) int indices -> (K,) bool mask of the codes that appear."""
    mask = torch.zeros(num_embeddings, dtype=torch.bool, device=inds.device)
    return mask.index_fill_(0, inds.reshape(-1).long(), True)


def vector_quantize(z: Tensor, codebook: Tensor) -> Dict[str, Tensor]:
    """Full VQ layer forward on NHWC latents.

    Returns a dict:
      ``quantized``     straight-through quantized latents (B, H, W, D)
      ``commitment``    mse(sg(q), z)
      ``embedding``     mse(q, sg(z))
      ``encoding_inds`` (B*H*W,) int32 flat indices, rows in NHWC order
    """
    b, h, w, d = z.shape
    z32 = z.float()
    q_rows, inds = vq_lookup(z32.reshape(-1, d), codebook)
    q = q_rows.float().reshape(b, h, w, d)
    commitment = (q.detach() - z32).square().mean()
    embedding = (q - z32.detach()).square().mean()
    quantized = z32 + (q - z32).detach()
    return {
        "quantized": quantized,
        "commitment": commitment,
        "embedding": embedding,
        "encoding_inds": inds,
    }


@torch.no_grad()
def ema_codebook_update(codebook: Tensor, cluster_size: Tensor,
                        ema_embed: Tensor, z_flat: Tensor, inds: Tensor,
                        decay: float = 0.99, eps: float = 1e-5
                        ) -> Tuple[Tensor, Tensor, Tensor]:
    """EMA codebook update (van den Oord 2017, appendix A.1). Returns new
    (codebook, cluster_size, ema_embed); the inputs are left untouched."""
    k, _ = codebook.shape
    inds = inds.reshape(-1).long()
    z32 = z_flat.float()
    counts = torch.zeros(k, dtype=torch.float32, device=z32.device)
    counts.index_add_(0, inds, torch.ones_like(inds, dtype=torch.float32))
    embed_sums = torch.zeros((k, z32.shape[1]), dtype=torch.float32,
                             device=z32.device).index_add_(0, inds, z32)
    cluster_size = cluster_size * decay + (1 - decay) * counts
    ema_embed = ema_embed * decay + (1 - decay) * embed_sums
    n = cluster_size.sum()
    stable = (cluster_size + eps) / (n + k * eps) * n
    new_codebook = ema_embed / stable[:, None]
    return new_codebook.to(codebook.dtype), cluster_size, ema_embed
