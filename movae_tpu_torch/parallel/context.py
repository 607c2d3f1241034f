"""Context-parallel attention and sample-parallel generation — port of
``movae_tpu/parallel/context.py``.

A :class:`ContextParallel` installed by :func:`context_parallel` (the prior
trainer does, for ``--context_parallel N``) makes
``ops/attention.py:causal_attention`` take the zigzag ring
(``ops/ring_attention.py``) over the current mesh's ``seq`` axis
(``parallel/mesh.py:using``), at any L. The JAX config's ``mesh``,
``seq_axis``, ``batch_axis`` and ``head_axis`` have no counterpart: the
mesh is the current one, its axis is always ``seq``, each rank already
holds its rows of the batch, and the port splits no attention heads (its
prior is not tensor-parallel). The JAX package's
``seq_shard_spatial`` (the prior trunk row-sharded over ``seq`` with halo
exchanges) is not ported: the trunk runs whole on every ``seq`` rank and
the ring slices q, k, v at its entry, which gives the same values
(ROADMAP.md "After the port").

A :class:`SampleParallel` installed by :func:`sample_parallel` makes the
prior samplers batch-parallel over the ranks: every rank draws the global
batch's Gumbel noise from its generator (the same on every rank), keeps
its rows (:func:`shard_sample_batch`, rows ``p, p + P, ...`` as the
loaders interleave them), runs the cached sampling loop on them with no
collective, and the codes are gathered back into the global batch
(:func:`gather_sample_batch`): the codes of one device on the whole
batch, on every rank. A batch the ranks do not divide runs whole on every
rank.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import torch

from movae_tpu_torch.parallel import mesh as mesh_lib

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class ContextParallel:
    """Attention takes the ring over the current mesh's ``seq`` axis."""

    @property
    def size(self) -> int:
        return mesh_lib.axis_size("seq")


_current: Optional[ContextParallel] = None


def get_context_parallel() -> Optional[ContextParallel]:
    """The active config, or None (one rank's attention paths)."""
    return _current


@contextlib.contextmanager
def context_parallel():
    """Install a context-parallel config while the prior trains."""
    global _current
    prev = _current
    _current = ContextParallel()
    try:
        yield _current
    finally:
        _current = prev


# --- data-parallel SAMPLING -------------------------------------------------

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
