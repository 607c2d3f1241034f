"""Batches of frozen VQ codes for prior training — the port's own numpy copy
of ``movae_tpu/utils/codes_cache.py:CodeLoader``.

Same order as the JAX package's loader: the permutation of epoch e is
``np.random.default_rng((seed, e)).permutation(n)``, the last batch wraps
around the epoch's order to keep a static batch shape, and each batch
reports how many of its rows are new (``n_valid``). The gather is plain
numpy indexing. Not ported: the LMDB/npz code cache and the multi-host
``epoch_len`` (``ROADMAP.md`` Queue 1 items 12 and 13).
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np


class CodeLoader:
    """Static-shape batch iterator over code arrays that share their first
    dimension; yields ``({name: (batch_size, ...) array}, n_valid)``."""

    def __init__(self, levels: Dict[str, np.ndarray], batch_size: int,
                 shuffle: bool = True, seed: int = 0):
        self.levels = levels
        self.n = next(iter(levels.values())).shape[0]
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0

    def __len__(self) -> int:
        return (self.n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[Tuple[Dict[str, np.ndarray], int]]:
        rng = np.random.default_rng((self.seed, self.epoch))
        order = rng.permutation(self.n) if self.shuffle else np.arange(self.n)
        self.epoch += 1
        bs = self.batch_size
        for start in range(0, len(order), bs):
            idx = order[start:start + bs]
            n_valid = len(idx)
            if n_valid < bs:
                # np.resize wraps cyclically, so sets smaller than a batch
                # still fill the static shape
                idx = np.concatenate([idx, np.resize(order, bs - n_valid)])
            yield {k: v[idx] for k, v in self.levels.items()}, n_valid
