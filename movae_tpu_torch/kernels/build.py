"""Build the port's CUDA kernels from the sources in the checkout.

Each ``.cu`` file has a plain C interface and is compiled by ``nvcc`` into
shared libraries under ``<checkout>/build/kernels/`` (gitignored), then
loaded with ``ctypes``. ``TARGETS`` names every library: a source built once
per template value (the flash-attention head dim) gives one library per
value, so that each is its own ``nvcc`` job and all compile in parallel.
Libraries are named by a hash of the source, the headers beside it
(``*.cuh``) and the flags, so an edited source or header is rebuilt and an
unchanged one is reused.

Nothing here runs at import: the first launch of a kernel calls
:func:`load`, and a CPU-only host (no ``nvcc``) never reaches it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

KERNEL_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNEL_DIR.parents[1] / "build" / "kernels"
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

FLASH_HEAD_DIMS = (8, 16, 32, 64, 128)
# library name -> (source in this directory, extra nvcc flags)
TARGETS: Dict[str, Tuple[str, Tuple[str, ...]]] = {
    "nearest_code": ("nearest_code.cu", ()),
    **{f"flash_attention_d{d}": ("flash_attention.cu",
                                 (f"-DMOVAE_FLASH_D={d}",))
       for d in FLASH_HEAD_DIMS},
}

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
# ptxas register / shared-memory report of each source's last build
build_logs: Dict[str, str] = {}


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                           "to build the CUDA kernels")
    return found


def _flags(name: str) -> Tuple[str, ...]:
    return NVCC_FLAGS + TARGETS[name][1]


def _lib_path(name: str) -> Path:
    h = hashlib.sha256((KERNEL_DIR / TARGETS[name][0]).read_bytes())
    for header in sorted(KERNEL_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(_flags(name)).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Sequence[str]) -> List[Path]:
    """Compile the named ``TARGETS`` that are not built yet, one ``nvcc``
    process each, all started together."""
    todo = []
    for name in names:
        lib = _lib_path(name)
        if not lib.exists():
            todo.append((name, KERNEL_DIR / TARGETS[name][0], lib))
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = []
        for name, src, lib in todo:
            tmp = lib.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc_path(), *_flags(name), "-o", str(tmp), str(src)]
            procs.append((name, lib, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        errors = []
        for name, lib, tmp, proc in procs:
            _, err = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"nvcc failed for {name} "
                              f"({TARGETS[name][0]}):\n{err}")
                continue
            os.replace(tmp, lib)
            build_logs[name] = err
        if errors:
            raise RuntimeError("\n".join(errors))
    return [_lib_path(n) for n in names]


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load the library of ``TARGETS[name]``."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            (path,) = build([name])
            lib = ctypes.CDLL(str(path))
            _loaded[name] = lib
        return lib
