"""Fully sharded data parallelism (``--fsdp``, ZeRO-3) by hand — the
counterpart of the JAX package's ``DataParallel(fsdp=True)`` placement.

:class:`ShardedParams` holds, at rest, each large trainable leaf as this
rank's 1/dp slice on the dimension ``DataParallel.param_shardings`` picks
(the JAX rule: at least 4,096 elements, the largest dimension divisible by
dp); the optimizer is built over the slices, so its moments are 1/dp too.
:meth:`ShardedParams.gather` all-gathers every leaf into the model's own
parameters before the step; :meth:`ShardedParams.slice_grads` cuts the
step's combined gradient (the mean over the data ranks) to each slice's,
and :meth:`ShardedParams.release` frees the gathered leaves after the
update. The update is elementwise on each slice (Adam, AdamW, SGD,
RMSprop; a global-norm clip sums its squares over the ranks), so the
numbers are DDP's. :class:`ShardedParams` is a
``parallel/holder.py:Holder``.
"""

from __future__ import annotations

import contextlib
from typing import Any, List, Optional

import torch

from movae_tpu_torch.parallel import mesh as mesh_lib
from movae_tpu_torch.parallel.holder import Holder, split_axes

Tensor = torch.Tensor


def _slice(t: Tensor, dim: int, rank: int, n: int) -> Tensor:
    return t.chunk(n, dim)[rank]


class ShardedParams(Holder):
    """The fsdp shard set of ``model``'s trainable parameters (see the
    module docstring). ``shards`` are the optimizer's parameters, in the
    order of ``model``'s; ``dims[i]`` is the sharded dimension of leaf i,
    or None where it stays whole on every rank."""

    def __init__(self, model: torch.nn.Module, parallel, min_elems: int):
        self.parallel = parallel
        self.n = parallel.mesh.shape["data"]
        self.rank = mesh_lib.data_index()
        self.params = [p for p in model.parameters() if p.requires_grad]
        self.dims = [parallel.param_shardings(p, min_elems)
                     for p in self.params]
        self.shapes = [tuple(p.shape) for p in self.params]
        self.shards: List[torch.nn.Parameter] = []
        with torch.no_grad():
            for p, d in zip(self.params, self.dims):
                self.shards.append(p if d is None else torch.nn.Parameter(
                    _slice(p.detach(), d, self.rank, self.n).clone()))
        self.gathered = True
        self.release()

    @property
    def sharded(self) -> int:
        """How many leaves are sharded."""
        return sum(d is not None for d in self.dims)

    @torch.no_grad()
    def gather(self) -> None:
        """Every sharded leaf whole in the model's parameter (a
        collective)."""
        if self.gathered:
            return
        for p, s, d in zip(self.params, self.shards, self.dims):
            if d is not None:
                p.data = torch.cat(mesh_lib.all_gather(s.detach()), d)
        self.gathered = True

    @torch.no_grad()
    def reload_shards(self) -> None:
        """Take each slice again from the whole leaves (after a checkpoint
        was loaded into them)."""
        for p, s, d in zip(self.params, self.shards, self.dims):
            if d is not None:
                s.copy_(_slice(p.detach(), d, self.rank, self.n))

    def release(self) -> None:
        """Free the gathered leaves (only the slices stay)."""
        for p, d in zip(self.params, self.dims):
            if d is not None:
                p.data = p.data.new_empty(0)
        self.gathered = False

    @contextlib.contextmanager
    def whole(self, load: bool = False):
        """The model's parameters whole for the block (eval, figures,
        checkpoints), released after; a collective. With ``load`` the
        slices are taken again from what the block loaded."""
        was = self.gathered
        self.gather()
        try:
            yield
            if load:
                self.reload_shards()
        finally:
            if not was:
                self.release()

    def slice_grads(self, grads: List[Tensor]) -> List[Tensor]:
        """Each leaf's gradient for the optimizer from the mean over the
        data ranks (equal on every rank): a sharded leaf's slice of it. The
        mean is one all-reduce, then sliced: a reduce-scatter would move
        less, but no run has measured one."""
        return [g if d is None else
                _slice(g, d, self.rank, self.n).contiguous()
                for g, d in zip(grads, self.dims)]

    def clip_axes(self) -> List[tuple]:
        return split_axes(self.dims, "data")

    def finalize(self) -> None:
        self.gather()

    def rest_bytes(self, optimizer: Optional[torch.optim.Optimizer] = None
                   ) -> dict:
        """Bytes this rank holds at rest: the parameters (slices and whole
        leaves) and the optimizer's state tensors."""
        params = sum(s.numel() * s.element_size() for s in self.shards)
        moments = 0
        if optimizer is not None:
            for st in optimizer.state.values():
                moments += sum(t.numel() * t.element_size()
                               for t in st.values() if torch.is_tensor(t)
                               and t.dim() > 0)
        return {"params": params, "moments": moments}

    # --- optimizer state whole, for a rank-0 checkpoint ---------------------
    def full_optimizer_state(self, sd: dict) -> dict:
        """An optimizer state dict over the slices with every sharded
        moment gathered whole (a collective): the state dict an unsharded
        optimizer over the model's parameters would hold."""
        sd = {"state": {int(i): dict(st) for i, st in sd["state"].items()},
              "param_groups": sd["param_groups"]}
        for i, st in sd["state"].items():
            d = self.dims[i]
            if d is None:
                continue
            for k, t in list(st.items()):
                if torch.is_tensor(t) and t.dim() > 0:
                    st[k] = torch.cat(mesh_lib.all_gather(t), d)
        return sd

    def local_optimizer_state(self, sd: dict) -> dict:
        """A whole optimizer state dict cut to this rank's slices."""
        sd = {"state": {int(i): dict(st) for i, st in sd["state"].items()},
              "param_groups": sd["param_groups"]}
        for i, st in sd["state"].items():
            d = self.dims[i]
            if d is None:
                continue
            for k, t in list(st.items()):
                if torch.is_tensor(t) and t.dim() > 0:
                    st[k] = _slice(t, d, self.rank, self.n).clone()
        return sd


def host_tree(tree: Any) -> Any:
    """Host copy of a tensor tree; a module's state and tensors alike."""
    if isinstance(tree, ShardedParams):
        with tree.whole():
            return [p.detach().cpu() for p in tree.params]
    if isinstance(tree, dict):
        return {k: host_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(host_tree(v) for v in tree)
    if torch.is_tensor(tree):
        return tree.detach().cpu()
    return tree
