"""Batches of frozen VQ codes for prior training — the port's own numpy copy
of ``movae_tpu/utils/codes_cache.py:CodeLoader``.

Same order as the JAX package's loader: the permutation of epoch e is
``np.random.default_rng((seed, e)).permutation(n)``, the last batch wraps
around the epoch's order to keep a static batch shape, and each batch
reports how many of its rows are new (``n_valid``). The gather is plain
numpy indexing; the code cache is ``utils/codes_cache.py``.

In a data-parallel run the loader walks the GLOBAL code set (every rank's
extracted codes gathered in the loaders' interleaved order,
``train/prior.py``) and ``process_index``/``process_count`` give each rank
the interleaved slice ``p, p + P, ...`` of each global batch of
``batch_size * P`` rows, as ``data.Loader`` does: the ranks' batches
together are the one-process batch stream. (The JAX package's multi-host
``epoch_len`` walks each process's own shard instead; with the global set
every rank takes the same number of steps by construction.)
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np


class CodeLoader:
    """Static-shape batch iterator over code arrays that share their first
    dimension; yields ``({name: (batch_size, ...) array}, n_valid)``."""

    def __init__(self, levels: Dict[str, np.ndarray], batch_size: int,
                 shuffle: bool = True, seed: int = 0,
                 process_index: int = 0, process_count: int = 1):
        self.levels = levels
        self.n = next(iter(levels.values())).shape[0]
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.process_index = process_index
        self.process_count = process_count
        self.epoch = 0

    def __len__(self) -> int:
        gb = self.batch_size * self.process_count
        return (self.n + gb - 1) // gb

    def __iter__(self) -> Iterator[Tuple[Dict[str, np.ndarray], int]]:
        """Yields this rank's ``(batch, n_valid)``; ``n_valid`` counts the
        GLOBAL batch's new rows."""
        rng = np.random.default_rng((self.seed, self.epoch))
        order = rng.permutation(self.n) if self.shuffle else np.arange(self.n)
        self.epoch += 1
        gb = self.batch_size * self.process_count
        for start in range(0, len(order), gb):
            idx = order[start:start + gb]
            n_valid = len(idx)
            if n_valid < gb:
                # np.resize wraps cyclically, so sets smaller than a batch
                # still fill the static shape
                idx = np.concatenate([idx, np.resize(order, gb - n_valid)])
            idx = idx[self.process_index::self.process_count]
            yield {k: v[idx] for k, v in self.levels.items()}, n_valid
