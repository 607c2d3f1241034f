"""Pre-extracted VQ code cache for prior training — the port's own copy of
``movae_tpu/utils/codes_cache.py`` (one process).

A one-time frozen-VQ sweep over the train loader writes each level's
(N, h, w) int32 codes as a memory-mapped ``.npy`` beside a ``meta.json``,
under ``<save_root>/codes_cache/<md5(arch_dataset_K_inputsize)[:12]>/``:
the JAX package's files and key, so either package reads the other's cache.
Batches over the cached codes come from
``movae_tpu_torch/utils/codes.py:CodeLoader``.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from movae_tpu_torch.parallel import mesh as mesh_lib


def cache_key(arch: str, dataset: str, num_embeddings: int,
              input_size: int) -> str:
    s = f"{arch}_{dataset}_{num_embeddings}_{input_size}"
    return hashlib.md5(s.encode()).hexdigest()[:12]


class CodeCache:
    """Memory-mapped code store; levels are named (N, h, w) int32 arrays."""

    def __init__(self, root: str):
        self.root = root
        self.meta_path = os.path.join(root, "meta.json")

    def exists(self) -> bool:
        return os.path.exists(self.meta_path)

    def write(self, levels: Dict[str, np.ndarray], meta: Optional[dict] = None):
        """Publish every array through a temporary file and ``os.replace``,
        ``meta.json`` (the marker :meth:`exists` reads) last."""
        os.makedirs(self.root, exist_ok=True)
        info = {"levels": {}, **(meta or {})}
        for name, arr in levels.items():
            arr = np.ascontiguousarray(arr, np.int32)
            path = os.path.join(self.root, f"{name}.npy")
            # the tmp name keeps the .npy suffix, or np.save appends one
            tmp = os.path.join(self.root, f".{name}.{os.getpid()}.tmp.npy")
            np.save(tmp, arr)
            os.replace(tmp, path)
            info["levels"][name] = {"shape": list(arr.shape)}
        info["__len__"] = int(next(iter(levels.values())).shape[0])
        tmp = f"{self.meta_path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(info, f, indent=2)
        os.replace(tmp, self.meta_path)

    def open(self) -> Dict[str, np.ndarray]:
        with open(self.meta_path) as f:
            info = json.load(f)
        return {name: np.load(os.path.join(self.root, f"{name}.npy"),
                              mmap_mode="r")
                for name in info["levels"]}

    def __len__(self) -> int:
        with open(self.meta_path) as f:
            return json.load(f)["__len__"]


def get_or_extract_codes(
    extract_fn,
    loader,
    save_root: str,
    arch: str,
    dataset: str,
    num_embeddings: int,
    input_size: int,
    is_hierarchical: bool = False,
    force_extract: bool = False,
    use_cache: bool = True,
) -> Tuple[Dict[str, np.ndarray], bool]:
    """``({level: (N, h, w) int32}, cache_hit)``: the cached codes, or one
    sweep of ``extract_fn(images) -> codes`` (or ``-> (top, bottom)``) over
    ``loader``'s valid rows, cached when ``use_cache``. The sweep keeps the
    codes on the device and copies them to the host once, at its end."""
    key = cache_key(arch, dataset, num_embeddings, input_size)
    if mesh_lib.process_count() > 1:
        # each rank sweeps only its loader slice, so its cache is its own
        key += f"_p{mesh_lib.process_index()}of{mesh_lib.process_count()}"
    cache = CodeCache(os.path.join(save_root, "codes_cache", key))
    hit = use_cache and cache.exists() and not force_extract
    if mesh_lib.process_count() > 1:
        # a partial earlier run can leave some ranks with a cache: every
        # rank extracts unless every rank hits
        flag = torch.tensor([0 if hit else 1], dtype=torch.int32)
        hit = int(mesh_lib.all_reduce_(flag, "max").item()) == 0
    if hit:
        print(f"Loading cached VQ codes from {cache.root}")
        return cache.open(), True

    names = ("top", "bottom") if is_hierarchical else ("codes",)
    chunks = {n: [] for n in names}
    for imgs, _labels, n_valid in loader:
        out = extract_fn(imgs)
        for n, codes in zip(names, out if is_hierarchical else (out,)):
            chunks[n].append(torch.as_tensor(codes)[:n_valid])
    levels = {n: torch.cat(c).cpu().numpy().astype(np.int32)
              for n, c in chunks.items()}
    if use_cache:
        cache.write(levels, {"arch": arch, "dataset": dataset,
                             "num_embeddings": num_embeddings,
                             "input_size": input_size})
        print(f"Wrote VQ code cache to {cache.root}")
    return levels, False
