"""Standalone hierarchical prior training over a saved VQ-VAE-2 —
``python -m movae_tpu_torch.train_prior_vqvae2``.

The counterpart of the repo's ``train_prior_vqvae2.py``: the flags of
``movae_tpu_torch/train_prior_vqvae.py`` (``--vqvae2_checkpoint`` for
``--model_path``), a HierarchicalPixelCNN / HierarchicalPixelSNAIL on the
checkpoint's (top, bottom) codes (two nearest-code launches per extraction
batch), its best / final checkpoints and a sample grid decoded through both
codebooks. A flat VQ model raises ``ValueError``, as in the JAX CLI.

Usage:
  python -m movae_tpu_torch.train_prior_vqvae2 --model_path \\
      <run>/checkpoints/final_checkpoint.pth --pixelcnn_epochs 50
"""

from __future__ import annotations

from typing import Optional, Sequence

from movae_tpu_torch.train_prior_vqvae import run


def main(argv: Optional[Sequence[str]] = None) -> dict:
    return run(argv, "vqvae2_checkpoint", hierarchical_only=True)


if __name__ == "__main__":
    main()
