"""Device resolution for the port's entry points."""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[None, str, torch.device]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``. Raises if a CUDA device is asked for and none is
    present: the port never falls back to the CPU on its own.

    Also pins float32 numerics for the process: TF32 is turned off for both
    matmul (``torch.backends.cuda.matmul.allow_tf32``) and cuDNN convolutions
    (``torch.backends.cudnn.allow_tf32``, which PyTorch enables by default),
    so card results stay comparable with the CPU path and the JAX reference.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA device requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev

