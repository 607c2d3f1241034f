"""ctypes binding to the native batch-assembly library — the port's own
copy of ``movae_tpu/data/native.py``.

Loads ``native/libbatch_ops.v4.so``, built from ``native/batch_ops.cpp`` by
``native/build.sh`` on first use (the ``.so`` is gitignored), and exposes
the fused gather (+ float32 cast + normalize) + horizontal flip, with a
numpy twin of identical semantics where no C++ compiler is present.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

_EXPECTED_VERSION = 4


class _Library:
    """The loaded library, or ``None`` after a failed build or load (then
    every function takes its numpy twin)."""

    lib = None
    tried = False


def _native_dir() -> str:
    return os.path.join(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))), "native")


def _bind(lib):
    lib.batch_ops_version.restype = ctypes.c_int
    if lib.batch_ops_version() != _EXPECTED_VERSION:
        return None
    lib.assemble_batch_u8.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int]
    lib.assemble_batch_u8.restype = None
    lib.assemble_batch_u8_raw.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64]
    lib.assemble_batch_u8_raw.restype = None
    lib.gather_codes_i32.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int64]
    lib.gather_codes_i32.restype = None
    lib.set_num_threads.argtypes = [ctypes.c_int]
    lib.set_num_threads.restype = None
    return lib


def _load():
    if _Library.tried:
        return _Library.lib
    _Library.tried = True
    # the version-suffixed name: an ABI bump gets a fresh file, never a
    # stale handle that dlopen has already deduplicated
    name = f"libbatch_ops.v{_EXPECTED_VERSION}.so"
    so = os.path.join(_native_dir(), name)
    if not os.path.exists(so):
        try:
            subprocess.run(["sh", os.path.join(_native_dir(), "build.sh"),
                            name], check=True, capture_output=True,
                           timeout=120)
        except (OSError, subprocess.SubprocessError) as e:
            print(f"native batch library not built ({e!r}); batches are "
                  "assembled by numpy")
            return None
    try:
        _Library.lib = _bind(ctypes.CDLL(so))
    except OSError as e:
        print(f"native batch library not loaded ({e!r}); batches are "
              "assembled by numpy")
    return _Library.lib


def available() -> bool:
    return _load() is not None


def set_num_threads(n: int) -> bool:
    """Cap the assembly worker threads (0 = hardware concurrency): the
    reference DataLoader's ``num_workers``. False without the library."""
    lib = _load()
    if lib is None:
        return False
    lib.set_num_threads(int(n))
    return True


def _flip_rows(out: np.ndarray, flip_mask: Optional[np.ndarray]) -> None:
    if flip_mask is not None:
        m = flip_mask.astype(bool)
        out[m] = out[m, :, ::-1, :]


def assemble_batch(images: np.ndarray, idx: np.ndarray,
                   flip_mask: Optional[np.ndarray], normalize: bool
                   ) -> np.ndarray:
    """(N, H, W, C) uint8 archive + (B,) indices -> (B, H, W, C) float32
    batch in [0, 1] (or [-1, 1] with ``normalize``)."""
    lib = _load()
    idx = np.ascontiguousarray(idx, np.int64)
    b = len(idx)
    h, w, c = images.shape[1:]
    if lib is not None and images.flags.c_contiguous:
        out = np.empty((b, h, w, c), np.float32)
        fm = (np.ascontiguousarray(flip_mask, np.uint8)
              if flip_mask is not None else None)
        lib.assemble_batch_u8(
            images.ctypes.data, idx.ctypes.data,
            fm.ctypes.data if fm is not None else None,
            out.ctypes.data, b, h, w, c, int(normalize))
        return out
    out = images[idx].astype(np.float32) / 255.0
    _flip_rows(out, flip_mask)
    if normalize:
        out = (out - 0.5) / 0.5
    return out


def assemble_batch_raw(images: np.ndarray, idx: np.ndarray,
                       flip_mask: Optional[np.ndarray]) -> np.ndarray:
    """(N, H, W, C) uint8 archive + (B,) indices -> (B, H, W, C) uint8 batch
    (gather + flip; the cast runs on the device in the train step)."""
    lib = _load()
    idx = np.ascontiguousarray(idx, np.int64)
    b = len(idx)
    h, w, c = images.shape[1:]
    if lib is not None and images.flags.c_contiguous:
        out = np.empty((b, h, w, c), np.uint8)
        fm = (np.ascontiguousarray(flip_mask, np.uint8)
              if flip_mask is not None else None)
        lib.assemble_batch_u8_raw(
            images.ctypes.data, idx.ctypes.data,
            fm.ctypes.data if fm is not None else None,
            out.ctypes.data, b, h, w, c)
        return out
    out = images[idx].copy()
    _flip_rows(out, flip_mask)
    return out


def gather_codes(codes: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """Rows ``idx`` of an (N, ...) int32 code archive."""
    lib = _load()
    idx = np.ascontiguousarray(idx, np.int64)
    if (lib is not None and codes.flags.c_contiguous
            and codes.dtype == np.int32):
        b = len(idx)
        out = np.empty((b,) + codes.shape[1:], np.int32)
        lib.gather_codes_i32(codes.ctypes.data, idx.ctypes.data,
                             out.ctypes.data, b,
                             int(np.prod(codes.shape[1:])))
        return out
    return np.ascontiguousarray(codes[idx])
