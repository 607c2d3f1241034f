"""Device-resident training data (``--device_data``) — port of
``movae_tpu/data/device.py`` for one card.

The whole uint8 train set is uploaded once as one tensor on the card, and
every full batch is gathered (and flipped) there: the host sends no
batches, only one (steps, B) index block per epoch. The epoch plan is the
JAX package's numpy plan (``_perm``, ``epoch_plan``) on a one-device mesh,
so both packages walk the same rows. The flip mask comes from a torch
generator on the card; JAX draws its in-jit flip from ``jax.random``, so
flips part between the packages by design, as they already do between the
JAX package's own two loaders. Epoch leftovers (fewer rows than a batch)
run as host batches through ``dataset.get_batch``, so every image trains
once per epoch.

In a data-parallel run (``process_index``/``process_count``, one rank a
card) each rank holds the rows it owns, the interleaved global ids ``p,
p + P, ...`` (the loaders' interleave): its own seeded permutation of them
gives its columns of each global (steps, B) batch, the epoch's steps are
the fewest any rank can fill, and every rank walks the global leftovers in
lockstep, each taking its interleaved slice (the JAX package's multi-host
``DeviceData`` with one data shard a process).
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from movae_tpu_torch.train.step import optimizer_steps

Array = np.ndarray

# auto-enable budget: the resident set may take at most this fraction of
# the card's memory, less what is already in use (the JAX package's rule)
AUTO_MEMORY_FRACTION = 0.4


def _memory_budget(device: torch.device) -> int:
    free, total = torch.cuda.mem_get_info(device)
    return int(AUTO_MEMORY_FRACTION * total) - (total - free)


def resolve_device_data(args, dataset, batch_size: int,
                        device: torch.device, process_index: int = 0,
                        process_count: int = 1) -> Optional["DeviceData"]:
    """``--device_data`` / ``--no_device_data`` / auto -> a
    :class:`DeviceData` or ``None`` (the host loader).

    Auto enables it on a CUDA device for a uint8 set without a random
    resized crop whose bytes (this rank's share) fit
    :data:`AUTO_MEMORY_FRACTION` of the card's memory less what is in use.
    ``batch_size`` is the global batch."""
    if getattr(args, "no_device_data", False):
        return None
    forced = bool(getattr(args, "device_data", False))
    if not forced:
        if device.type != "cuda":
            return None
        if getattr(dataset, "random_resized_crop", None) is not None:
            return None
        imgs = getattr(dataset, "images", None)
        if imgs is None or getattr(imgs, "dtype", None) != np.uint8:
            return None
        nbytes = int(np.prod(imgs.shape, dtype=np.int64)) // process_count
        budget = _memory_budget(device)
        if nbytes > budget:
            print(f"[device_data] auto: train set needs {nbytes / 1e9:.2f} "
                  f"GB > {budget / 1e9:.2f} GB budget — host loader")
            return None
    dd = DeviceData(dataset, batch_size, device,
                    seed=getattr(args, "seed", 0) or 0,
                    process_index=process_index,
                    process_count=process_count)
    if not forced:
        print("[device_data] auto-enabled: the train set fits the card's "
              "memory budget (opt out with --no_device_data)")
    return dd


class DeviceData:
    """The resident image store and its deterministic per-epoch plans
    (``batch_size`` the global batch B; this rank's columns are B / P)."""

    def __init__(self, dataset, batch_size: int, device: torch.device,
                 seed: int = 0, process_index: int = 0,
                 process_count: int = 1):
        if getattr(dataset, "random_resized_crop", None) is not None:
            raise ValueError(
                "--device_data does not support datasets with a "
                "RandomResizedCrop train transform (flowers); use the host "
                "loader for those")
        self.dataset = dataset
        self.seed = seed
        self.flip = bool(getattr(dataset, "flip", False))
        self.B = int(batch_size)
        self.pi, self.pc = int(process_index), int(process_count)
        if self.B % self.pc:
            raise ValueError(f"global batch {self.B} must be divisible by "
                             f"the data-axis size {self.pc} for "
                             f"--device_data")
        self.b_loc = self.B // self.pc
        self.n = len(dataset)
        # rank p owns the global ids p, p + P, ...
        self.counts = np.array([(self.n - p + self.pc - 1) // self.pc
                                for p in range(self.pc)], np.int64)
        if (self.counts // self.b_loc).min() == 0 and self.n >= 2 * self.B:
            raise ValueError(
                f"--device_data layout degenerate: a rank holds "
                f"{int(self.counts.min())} rows < B/P={self.b_loc}")
        self.steps = int((self.counts // self.b_loc).min())
        self.device = device
        own = self._ids(self.pi)
        print(f"[device_data] uploading "
              f"{dataset.images[:1].nbytes * len(own) / 1e9:.2f} GB "
              f"({len(own)} of {self.n} images) to {device}")
        self.images_dev = torch.from_numpy(np.ascontiguousarray(
            dataset.images[own] if self.pc > 1 else dataset.images)
            ).to(device)

    def _ids(self, p: int) -> Array:
        """The global ids rank ``p`` owns, in its local order."""
        return p + np.arange(self.counts[p]) * self.pc

    def _perm(self, epoch: int, p: int = 0) -> Array:
        return np.random.default_rng((self.seed, epoch, p)).permutation(
            self.counts[p])

    def epoch_plan(self, epoch: int) -> Tuple[Array, Array]:
        """``(idx, tail_ids)`` for ``epoch``: this rank's (steps, B / P)
        int32 rows of the full batches (local row numbers) and the GLOBAL
        leftover ids of every rank (the same on all ranks)."""
        take = self.steps * self.b_loc
        idx, tails = None, []
        for p in range(self.pc):
            perm = self._perm(epoch, p)
            if p == self.pi:
                idx = perm[:take].reshape(self.steps, self.b_loc).astype(
                    np.int32)
            tails.append(self._ids(p)[perm[take:]])
        return idx, np.concatenate(tails)

    def batches(self, idx: Array, generator: Optional[torch.Generator]
                ) -> Iterator[torch.Tensor]:
        """The epoch's full uint8 batches (this rank's rows), gathered and
        flipped on the card from one upload of the index block."""
        idx_dev = torch.from_numpy(idx.astype(np.int64))
        if self.device.type == "cuda":  # no host wait for the upload
            idx_dev = idx_dev.pin_memory()
        idx_dev = idx_dev.to(self.device, non_blocking=True)
        for row in idx_dev:
            batch = self.images_dev.index_select(0, row)
            if self.flip:
                mask = torch.rand(self.b_loc, generator=generator,
                                  device=self.device) < 0.5
                batch = torch.where(mask[:, None, None, None],
                                    batch.flip(2), batch)
            yield batch

    def tail_batches(self, tail_ids: Array, rng: np.random.Generator
                     ) -> Iterator[Tuple[Array, int]]:
        """The leftovers as host uint8 batches, walked in lockstep by
        every rank: each global batch of B leftovers gives this rank its
        interleaved slice, wrap-padded and trimmed to the smallest multiple
        of P covering the valid rows (one rank: the valid rows alone).
        Yields ``(images, global valid rows)``."""
        L = len(tail_ids)
        for start in range(0, L, self.B):
            ids = tail_ids[start:start + self.B][self.pi::self.pc]
            gv = min(self.B, L - start)
            keep = -(-gv // self.pc)
            if len(ids) < keep:
                pad = np.resize(tail_ids, keep - len(ids))
                ids = np.concatenate([ids, pad]) if len(ids) else pad
            imgs, _ = self.dataset.get_batch(ids[:keep], rng, raw=True)
            yield imgs, gv

    @property
    def tail_len(self) -> int:
        return int(self.n - self.steps * self.B)

    @property
    def tail_steps(self) -> int:
        return -(-self.tail_len // self.B) if self.tail_len else 0

    def optimizer_steps_per_epoch(self, accum_k: int = 1) -> int:
        """Optimizer updates per epoch (the lr schedule's and COMFORT's
        cadence): the full batches, in groups of A under ``--grad_accum``
        with the leftovers as single updates, plus the host tail's."""
        return optimizer_steps(self.steps, self.steps + self.tail_steps,
                               accum_k)
