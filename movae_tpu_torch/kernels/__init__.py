"""Hand-written Hopper kernels of the port.

Each kernel is a ``.cu`` source with a plain C interface, built on first use
by :mod:`movae_tpu_torch.kernels.build` and bound with ``ctypes`` in a
wrapper module beside its plain PyTorch version:

  * ``nearest_code`` — nearest-codebook index of the VQ layer
    (replaces ``movae_tpu/ops/vq.py:_inds_kernel``);
  * ``flash_attention`` — causal flash attention, three kernels: forward,
    dK/dV and dQ, each with a float32 and a bfloat16 instance (replace the
    stock Pallas TPU flash attention that
    ``movae_tpu/ops/attention.py:causal_attention`` calls).

``LAUNCH_COUNTS`` holds one plain integer per kernel; its wrapper adds one
where it launches the kernel and nowhere else, so a run can show that it
went through the kernel.
"""

from __future__ import annotations

from typing import Dict

LAUNCH_COUNTS: Dict[str, int] = {
    "nearest_code": 0,
    "flash_attention_fwd": 0,
    "flash_attention_bwd_dkv": 0,
    "flash_attention_bwd_dq": 0,
}


def reset_launch_counts() -> None:
    for name in LAUNCH_COUNTS:
        LAUNCH_COUNTS[name] = 0
