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
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np
import torch

Array = np.ndarray

# auto-enable budget: the resident set may take at most this fraction of
# the card's memory, less what is already in use (the JAX package's rule)
AUTO_MEMORY_FRACTION = 0.4


def _memory_budget(device: torch.device) -> int:
    free, total = torch.cuda.mem_get_info(device)
    return int(AUTO_MEMORY_FRACTION * total) - (total - free)


def resolve_device_data(args, dataset, batch_size: int,
                        device: torch.device) -> Optional["DeviceData"]:
    """``--device_data`` / ``--no_device_data`` / auto -> a
    :class:`DeviceData` or ``None`` (the host loader).

    Auto enables it on a CUDA device for a uint8 set without a random
    resized crop whose bytes fit :data:`AUTO_MEMORY_FRACTION` of the card's
    memory less what is in use."""
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
        nbytes = int(np.prod(imgs.shape, dtype=np.int64))
        budget = _memory_budget(device)
        if nbytes > budget:
            print(f"[device_data] auto: train set needs {nbytes / 1e9:.2f} "
                  f"GB > {budget / 1e9:.2f} GB budget — host loader")
            return None
    dd = DeviceData(dataset, batch_size, device,
                    seed=getattr(args, "seed", 0) or 0)
    if not forced:
        print("[device_data] auto-enabled: the train set fits the card's "
              "memory budget (opt out with --no_device_data)")
    return dd


class DeviceData:
    """The resident image store and its deterministic per-epoch plans."""

    def __init__(self, dataset, batch_size: int, device: torch.device,
                 seed: int = 0):
        if getattr(dataset, "random_resized_crop", None) is not None:
            raise ValueError(
                "--device_data does not support datasets with a "
                "RandomResizedCrop train transform (flowers); use the host "
                "loader for those")
        self.dataset = dataset
        self.seed = seed
        self.flip = bool(getattr(dataset, "flip", False))
        self.B = int(batch_size)
        self.n = len(dataset)
        self.steps = self.n // self.B
        self.device = device
        print(f"[device_data] uploading {dataset.images.nbytes / 1e9:.2f} GB "
              f"({self.n} images) to {device}")
        self.images_dev = torch.from_numpy(
            np.ascontiguousarray(dataset.images)).to(device)

    def _perm(self, epoch: int) -> Array:
        return np.random.default_rng((self.seed, epoch, 0)).permutation(
            self.n)

    def epoch_plan(self, epoch: int) -> Tuple[Array, Array]:
        """``(idx, tail_ids)`` for ``epoch``: the (steps, B) int32 rows of
        the full batches and the leftover row ids."""
        perm = self._perm(epoch)
        take = self.steps * self.B
        return (perm[:take].reshape(self.steps, self.B).astype(np.int32),
                perm[take:])

    def batches(self, idx: Array, generator: Optional[torch.Generator]
                ) -> Iterator[torch.Tensor]:
        """The epoch's full uint8 batches, gathered and flipped on the
        card from one upload of the (steps, B) index block."""
        idx_dev = torch.from_numpy(idx.astype(np.int64))
        if self.device.type == "cuda":  # no host wait for the upload
            idx_dev = idx_dev.pin_memory()
        idx_dev = idx_dev.to(self.device, non_blocking=True)
        for row in idx_dev:
            batch = self.images_dev.index_select(0, row)
            if self.flip:
                mask = torch.rand(self.B, generator=generator,
                                  device=self.device) < 0.5
                batch = torch.where(mask[:, None, None, None],
                                    batch.flip(2), batch)
            yield batch

    def tail_batches(self, tail_ids: Array, rng: np.random.Generator
                     ) -> Iterator[Tuple[Array, int]]:
        """The leftovers as host uint8 batches of their valid rows only."""
        for start in range(0, len(tail_ids), self.B):
            ids = tail_ids[start:start + self.B]
            imgs, _ = self.dataset.get_batch(ids, rng, raw=True)
            yield imgs, len(ids)

    @property
    def tail_len(self) -> int:
        return int(self.n - self.steps * self.B)

    @property
    def tail_steps(self) -> int:
        return -(-self.tail_len // self.B) if self.tail_len else 0

    def optimizer_steps_per_epoch(self) -> int:
        return max(1, self.steps + self.tail_steps)
