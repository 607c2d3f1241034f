"""The benchmark of the PyTorch and CUDA port (``movae_tpu_torch``); see
README.md."""
