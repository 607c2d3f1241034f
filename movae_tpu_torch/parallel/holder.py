"""How a trainer holds its parameters over the mesh: one interface that
the trainers (``train/loop.py``, ``train/prior.py``, ``train/state.py``,
``train/step.py``) call without asking how the leaves are split.

:class:`Holder` keeps every leaf whole on every rank (one device, or data
parallelism); fsdp (``parallel/fsdp.py:ShardedParams``), tensor
parallelism (``parallel/tensor.py:TensorParallel``) and the pipeline
(``parallel/pipeline.py:PipelinedPrior``) override what they split.
``params`` are the leaves the step differentiates, ``shards`` the
optimizer's (this rank's slices), ``clip_axes()`` the axes each shard is
split over. :func:`stack` composes tensor parallelism with fsdp over its
slices.
"""

from __future__ import annotations

import contextlib
from typing import List, Optional, Sequence

import torch

Tensor = torch.Tensor


class Holder:
    """Every leaf of ``params`` whole on every rank."""

    def __init__(self, params: Sequence[torch.nn.Parameter]):
        self.params = list(params)
        self.shards = self.params

    def gather(self) -> None:
        """The leaves the step needs whole, gathered (a collective)."""

    def release(self) -> None:
        """Back to the slices held at rest, after the step."""

    @contextlib.contextmanager
    def whole(self, load: bool = False):
        """The model whole and plain for the block (eval, figures,
        checkpoints; a collective); with ``load`` each rank takes its
        slices again from what the block loaded."""
        yield

    def slice_grads(self, grads: Sequence[Tensor]) -> List[Tensor]:
        """The optimizer's gradients (of ``shards``) from the whole
        leaves' gradients, equal on the ranks that split a leaf."""
        return list(grads)

    def clip_axes(self) -> Optional[List[tuple]]:
        """The axes each shard is split over, for a global-norm clip
        (``mesh.clip_by_global_norm``); None where nothing is split."""
        return None

    def full_optimizer_state(self, sd: dict) -> dict:
        """The optimizer's state dict over ``shards`` made whole: what one
        device's optimizer would hold (a collective)."""
        return sd

    def local_optimizer_state(self, sd: dict) -> Optional[dict]:
        """A :meth:`full_optimizer_state` cut to this rank's shards; None
        where it cannot be (the moments then start afresh)."""
        return sd

    def finalize(self) -> None:
        """The model whole from here on (the stages after training)."""


class _Stack(Holder):
    """``inner`` (tensor parallelism) with ``outer`` (fsdp) over its
    slices: gathered inner first, whole outer first."""

    def __init__(self, inner: Holder, outer: Holder):
        self.inner, self.outer = inner, outer
        self.params, self.shards = outer.params, outer.shards

    def gather(self) -> None:
        self.inner.gather()
        self.outer.gather()

    def release(self) -> None:
        self.outer.release()
        self.inner.release()

    @contextlib.contextmanager
    def whole(self, load: bool = False):
        with self.outer.whole(load), self.inner.whole(load):
            yield

    def slice_grads(self, grads):
        return self.inner.slice_grads(self.outer.slice_grads(grads))

    def clip_axes(self):
        return [a + b for a, b in zip(self.outer.clip_axes(),
                                      self.inner.clip_axes())]

    def full_optimizer_state(self, sd):
        return self.inner.full_optimizer_state(
            self.outer.full_optimizer_state(sd))

    def local_optimizer_state(self, sd):
        return self.outer.local_optimizer_state(
            self.inner.local_optimizer_state(sd))

    def finalize(self) -> None:
        self.outer.finalize()
        self.inner.finalize()


def stack(params: Sequence[torch.nn.Parameter], tp: Optional[Holder],
          fsdp: Optional[Holder]) -> Holder:
    """The one holder of ``params``: tensor parallelism ``tp`` and fsdp
    ``fsdp`` over its slices, either, or neither (None)."""
    if tp is not None and fsdp is not None:
        return _Stack(tp, fsdp)
    if tp is not None:
        return tp
    return fsdp if fsdp is not None else Holder(params)


def split_axes(dims: Sequence[Optional[int]], axis: str) -> List[tuple]:
    """``(axis,)`` for each split leaf of ``dims``, ``()`` for a whole
    one."""
    return [() if d is None else (axis,) for d in dims]
