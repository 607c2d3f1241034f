"""Build the port's CUDA kernels from the sources in the checkout.

Each ``.cu`` file has a plain C interface and is compiled by ``nvcc`` into
its own shared library under ``<checkout>/build/kernels/`` (gitignored),
then loaded with ``ctypes``. Libraries are named by a hash of the source and
the flags, so an edited source is rebuilt and an unchanged one is reused.

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
from typing import Dict, List, Sequence

KERNEL_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNEL_DIR.parents[1] / "build" / "kernels"
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

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


def _lib_path(source: Path) -> Path:
    h = hashlib.sha256(source.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{source.stem}-{h.hexdigest()[:16]}.so"


def build(names: Sequence[str]) -> List[Path]:
    """Compile the named sources (``<name>.cu`` in this directory) that are
    not built yet, one ``nvcc`` process each, all started together."""
    todo = []
    for name in names:
        src = KERNEL_DIR / f"{name}.cu"
        lib = _lib_path(src)
        if not lib.exists():
            todo.append((name, src, lib))
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = []
        for name, src, lib in todo:
            tmp = lib.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
            procs.append((name, lib, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        errors = []
        for name, lib, tmp, proc in procs:
            _, err = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"nvcc failed for {name}.cu:\n{err}")
                continue
            os.replace(tmp, lib)
            build_logs[name] = err
        if errors:
            raise RuntimeError("\n".join(errors))
    return [_lib_path(KERNEL_DIR / f"{n}.cu") for n in names]


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``<name>.cu``'s shared library."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            (path,) = build([name])
            lib = ctypes.CDLL(str(path))
            _loaded[name] = lib
        return lib
