"""Offline sample generation from a trained VQ-VAE-2 and its hierarchical
prior — ``python -m movae_tpu_torch.generate_samples_pixelcnn_vqvae2``.

The counterpart of the repo's ``generate_samples_pixelcnn_vqvae2.py``, and
like it the flat generator's ``main``
(``movae_tpu_torch/generate_samples_pixelcnn_vqvae.py``), which samples
z_top, then z_bottom given z_top, for a hierarchical checkpoint and decodes
both through their codebooks.
"""

from movae_tpu_torch.generate_samples_pixelcnn_vqvae import main

__all__ = ["main"]

if __name__ == "__main__":
    main()
