"""PyTorch / CUDA port of the MO-VAE framework for NVIDIA Hopper (H100).

Mirrors the module layout of the JAX package ``movae_tpu`` so every port
module has an obvious counterpart. The port imports ``torch`` only — never
JAX, flax, optax or ``movae_tpu`` — and keeps its own copy of anything it
needs from the JAX side.

Conventions:
  * Public functions keep the JAX package's NHWC image layout; convolutions
    run NCHW inside the models.
  * Entry points take a ``device`` and default to ``cuda``; they raise when
    no card is present rather than falling back (``device="cpu"`` runs on
    the CPU, as the tests do).
  * float32 compute with TF32 disabled for matmul and cuDNN
    (``movae_tpu_torch.device.resolve_device``).
  * Hand-written CUDA kernels live in ``movae_tpu_torch/kernels``; each has
    a plain PyTorch version beside it that the CPU path uses.
"""
