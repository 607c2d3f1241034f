"""Nearest-code index: the CUDA kernel's wrapper and its plain version.

``nearest_code(z, codebook)`` returns, for every row of ``z`` (N, D), the
index of the codebook row (K, D) minimising ``||e_k||^2 - 2 z.e_k`` (the
per-row constant ``||z||^2`` is dropped), the lowest index winning ties —
the function of ``movae_tpu/ops/vq.py:_inds_kernel``. A CPU tensor takes the
plain PyTorch version; a CUDA tensor launches ``nearest_code.cu`` or raises.
Both are registered as the operator ``movae::nearest_code``
(:func:`nearest_code_op`), so that an exported graph can hold the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from movae_tpu_torch.kernels import LAUNCH_COUNTS
from movae_tpu_torch.kernels import build

SUPPORTED_DIMS = (8, 16, 32, 64, 128)
_INT32_MAX = 2 ** 31 - 1


def nearest_code_plain(z: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """The same formula in plain PyTorch: ``(cb_sq - 2 z @ cb^T).argmin(1)``
    (torch's argmin returns the first minimum, so the lowest index wins)."""
    z = z.float()
    cb = codebook.float()
    cb_sq = (cb * cb).sum(1)
    return (cb_sq[None, :] - 2.0 * (z @ cb.T)).argmin(1).to(torch.int32)


def _library() -> ctypes.CDLL:
    lib = build.load("nearest_code")
    fn = lib.movae_nearest_code
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def nearest_code_cuda(z: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream; (N,) int32 indices."""
    if z.device.type != "cuda" or codebook.device != z.device:
        raise ValueError(f"nearest_code_cuda needs both tensors on one CUDA "
                         f"device, got {z.device} and {codebook.device}")
    if z.dtype != torch.float32 or codebook.dtype != torch.float32:
        raise TypeError(f"nearest_code_cuda takes float32, got {z.dtype} and "
                        f"{codebook.dtype}")
    if z.dim() != 2 or codebook.dim() != 2 or z.shape[1] != codebook.shape[1]:
        raise ValueError(f"nearest_code_cuda takes z (N, D) and codebook "
                         f"(K, D), got {tuple(z.shape)} and "
                         f"{tuple(codebook.shape)}")
    n, d = z.shape
    k = codebook.shape[0]
    if d not in SUPPORTED_DIMS:
        raise ValueError(f"nearest_code_cuda supports D in {SUPPORTED_DIMS}, "
                         f"got {d}")
    if k == 0 or n > _INT32_MAX or k > _INT32_MAX:
        raise ValueError(f"nearest_code_cuda needs 0 < K and N, K < 2^31, "
                         f"got N={n}, K={k}")
    for name, t in (("z", z), ("codebook", codebook)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"nearest_code_cuda needs a contiguous, 16-byte "
                             f"aligned {name}")
    out = torch.empty((n,), dtype=torch.int32, device=z.device)
    stream = torch.cuda.current_stream(z.device).cuda_stream
    err = _library().movae_nearest_code(
        z.data_ptr(), codebook.data_ptr(), out.data_ptr(), n, k, d,
        z.device.index, stream)
    if err != 0:
        raise RuntimeError(f"nearest_code kernel launch failed: cudaError {err}")
    LAUNCH_COUNTS["nearest_code"] += 1
    return out


@torch.library.custom_op("movae::nearest_code", mutates_args=(),
                         device_types="cuda")
def nearest_code_op(z: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """``movae::nearest_code``: the kernel on CUDA tensors
    (:func:`nearest_code_cuda`), the plain version on CPU tensors. As an
    operator, a graph that ``torch.export`` captures holds it by name, and
    the exported program launches the kernel on the card."""
    return nearest_code_cuda(z, codebook)


@nearest_code_op.register_kernel("cpu")
def _nearest_code_cpu(z: torch.Tensor, codebook: torch.Tensor
                      ) -> torch.Tensor:
    return nearest_code_plain(z, codebook)


@nearest_code_op.register_fake
def _nearest_code_fake(z: torch.Tensor, codebook: torch.Tensor
                       ) -> torch.Tensor:
    return z.new_empty((z.shape[0],), dtype=torch.int32)


def nearest_code(z: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """(N, D) latents + (K, D) codebook -> (N,) int32 nearest-code indices,
    through ``movae::nearest_code``: CPU tensors take
    :func:`nearest_code_plain`; CUDA tensors launch the kernel, which
    raises on anything it does not take (no fallback)."""
    return nearest_code_op(z, codebook)
