"""Sample-parallel generation — port of the sampling half of
``movae_tpu/parallel/context.py`` (``SampleParallel``, ``sample_parallel``,
``shard_sample_batch``).

A :class:`SampleParallel` installed by :func:`sample_parallel` makes the
prior samplers batch-parallel over the ranks: every rank draws the global
batch's Gumbel noise from its generator (the same on every rank), keeps
its rows (:func:`shard_sample_batch`, rows ``p, p + P, ...`` as the
loaders interleave them), runs the cached sampling loop on them with no
collective, and the codes are gathered back into the global batch
(:func:`gather_sample_batch`): the codes of one device on the whole
batch, on every rank. A batch the ranks do not divide runs whole on every
rank. The context half (``ContextParallel``, the ring attention) is
ROADMAP.md Queue 1 item 13's next sub-item.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import torch

from movae_tpu_torch.parallel import mesh as mesh_lib

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class SampleParallel:
    mesh: mesh_lib.Mesh
    batch_axis: str = "data"

    @property
    def size(self) -> int:
        return int(self.mesh.shape[self.batch_axis])


_sample: Optional[SampleParallel] = None


def get_sample_parallel() -> Optional[SampleParallel]:
    return _sample


def _sharded(batch: int) -> bool:
    ctx = get_sample_parallel()
    return ctx is not None and ctx.size > 1 and batch % ctx.size == 0


def shard_sample_batch(x: Optional[Tensor], batch_dim: int = 0
                       ) -> Optional[Tensor]:
    """This rank's rows of a sampler's global-batch tensor along
    ``batch_dim`` under an active sample-parallel config; ``x`` itself
    without one, or when the ranks do not divide the batch."""
    if x is None or not _sharded(x.shape[batch_dim]):
        return x
    return mesh_lib.local_rows(x, batch_dim)


def gather_sample_batch(x: Tensor, batch: int) -> Tensor:
    """The global batch of ``batch`` rows from this rank's rows (leading
    dimension), where :func:`shard_sample_batch` sharded it; else ``x``."""
    if not _sharded(batch):
        return x
    return mesh_lib.interleave(mesh_lib.all_gather(x))


@contextlib.contextmanager
def sample_parallel(mesh: mesh_lib.Mesh, batch_axis: str = "data"):
    """Install a sample-parallel config while generating samples."""
    global _sample
    prev = _sample
    _sample = SampleParallel(mesh, batch_axis)
    try:
        yield _sample
    finally:
        _sample = prev
