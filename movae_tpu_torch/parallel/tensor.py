"""Tensor parallelism over the ``model`` mesh axis (``--model_partitions``)
— the port of ``movae_tpu/parallel/mesh.py:DataParallel.param_shardings``'s
``model`` rule, computed by hand where GSPMD would partition.

The rule is the JAX package's: a trainable leaf of at least two dimensions
and ``min_elems`` elements whose output dimension the ``model`` axis
divides is split on that dimension; every other leaf is replicated. The
output dimension is the one flax keeps last: dim 0 of a ``Conv2d`` or
``Linear`` weight, dim 1 of a ``ConvTranspose2d`` weight (in, out, kh, kw),
the last dimension of a table (an embedding, a codebook), which the port
lays out as flax does.

A split ``Conv2d``/``ConvTranspose2d``/``Linear`` weight runs
column-parallel: each ``model`` rank holds its slice of the output
channels and computes them; the input enters through "identity forward,
all-reduce backward" and the output leaves through "all-gather forward,
own slice backward" (``mesh.copy_to_axis``/``mesh.gather_from_axis``), the
replicated bias added after the gather. Any other split leaf is gathered
whole before the step and its gradient sliced after it, as the port's fsdp
does (under ``--fsdp`` such leaves are left to fsdp's ``data`` slices).
The optimizer holds the slices, so its moments are 1/model too. The
train step's Gramian in full mode sums the split leaves' partial Gramians
over ``model`` and counts the replicated leaves' once
(``moo/engine.py:gramian``); the combined gradient is weighted locally.
Checkpoints and everything after the training stage see the whole model
(:meth:`TensorParallel.whole`, :meth:`TensorParallel.finalize`).
:class:`TensorParallel` is a ``parallel/holder.py:Holder``.
"""

from __future__ import annotations

import contextlib
import types
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from movae_tpu_torch.parallel import mesh as mesh_lib
from movae_tpu_torch.parallel.holder import Holder, split_axes

Tensor = torch.Tensor
TP_MIN_ELEMS = 4096
_COLUMN = (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)


def output_dim(module: nn.Module, name: str, leaf: Tensor) -> int:
    """The dimension of ``module``'s parameter ``name`` that the JAX rule
    reads as the output one (flax's last)."""
    if name == "weight" and isinstance(module, nn.ConvTranspose2d):
        return 1
    if name == "weight" and isinstance(module, (nn.Conv2d, nn.Linear)):
        return 0
    return leaf.dim() - 1


def tp_rule(module: nn.Module, name: str, leaf: Tensor, tp: int,
            min_elems: int = TP_MIN_ELEMS) -> Optional[int]:
    """The dimension a leaf is split on over ``model`` (None: replicated)."""
    if tp <= 1 or leaf.dim() < 2 or leaf.numel() < min_elems:
        return None
    d = output_dim(module, name, leaf)
    return d if leaf.shape[d] % tp == 0 else None


def model_shardings(model: nn.Module, tp: int,
                    min_elems: int = TP_MIN_ELEMS
                    ) -> Dict[str, Optional[int]]:
    """``{parameter name: split dimension or None}`` for every trainable
    parameter of ``model``."""
    out = {}
    for mname, mod in model.named_modules():
        for name, p in mod.named_parameters(recurse=False):
            if p.requires_grad:
                key = f"{mname}.{name}" if mname else name
                out[key] = tp_rule(mod, name, p, tp, min_elems)
    return out


def _column(mod: nn.Module, name: str) -> bool:
    return (name == "weight" and type(mod) in _COLUMN
            and getattr(mod, "groups", 1) == 1)


def _column_forward(self, x: Tensor, *args) -> Tensor:
    """A split layer's forward: its output channels on this rank, then
    every rank's gathered (see the module docstring)."""
    if not self._tp_on:
        return type(self).forward(self, x, *args)
    if args:
        raise ValueError("a tensor-parallel layer takes its input alone")
    x = mesh_lib.copy_to_axis(x, "model")
    if isinstance(self, nn.Linear):
        y, dim = F.linear(x, self.weight), -1
    elif isinstance(self, nn.ConvTranspose2d):
        y, dim = F.conv_transpose2d(x, self.weight, None, self.stride,
                                    self.padding, self.output_padding,
                                    self.groups, self.dilation), 1
    else:
        y, dim = self._conv_forward(x, self.weight, None), 1
    y = mesh_lib.gather_from_axis(y, dim, "model")
    if self.bias is None:
        return y
    b = self.bias.to(y.dtype)
    return y + (b if dim == -1 else b.view(1, -1, *([1] * (y.dim() - 2))))


def _chunk(t: Tensor, dim: int, rank: int, n: int) -> Tensor:
    return t.chunk(n, dim)[rank].clone()


class TensorParallel(Holder):
    """``model``'s trainable parameters split over the ``model`` axis (see
    the module docstring). ``params`` are the model's parameters; the
    optimizer's are ``shards`` (the same objects but for gathered leaves);
    ``dims[i]`` is leaf i's split dimension or None; ``column[i]`` whether
    its layer computes column-parallel. ``gather_leaves`` False leaves a
    split leaf that is not a layer weight whole (fsdp then holds it)."""

    def __init__(self, model: nn.Module, min_elems: int = TP_MIN_ELEMS,
                 gather_leaves: bool = True):
        self.n = mesh_lib.axis_size("model")
        self.rank = mesh_lib.axis_index("model")
        self.params: List[nn.Parameter] = []
        self.dims: List[Optional[int]] = []
        self.column: List[bool] = []
        self.shards: List[nn.Parameter] = []
        self.layers: List[nn.Module] = []
        seen = set()
        with torch.no_grad():
            for mod in model.modules():
                for name, p in mod.named_parameters(recurse=False):
                    if not p.requires_grad or id(p) in seen:
                        continue
                    seen.add(id(p))
                    d = tp_rule(mod, name, p, self.n, min_elems)
                    col = d is not None and _column(mod, name)
                    if d is not None and not col and not gather_leaves:
                        d = None
                    shard = p
                    if d is not None:
                        full = tuple(p.shape)
                        if col:
                            p.data = _chunk(p.data, d, self.rank, self.n)
                            self._install(mod)
                        else:
                            shard = nn.Parameter(_chunk(p.data, d, self.rank,
                                                        self.n))
                        for t in (p, shard):
                            t.tp_dim, t.tp_full_shape = d, full
                        # the Gramian sums these leaves over 'model'
                        p.tp_column = col
                    self.params.append(p)
                    self.dims.append(d)
                    self.column.append(col)
                    self.shards.append(shard)
        # the model's own parameter order (the optimizer's)
        order = {id(p): i for i, p in enumerate(
            q for q in model.parameters() if q.requires_grad)}
        idx = sorted(range(len(self.params)),
                     key=lambda i: order[id(self.params[i])])
        for attr in ("params", "dims", "column", "shards"):
            setattr(self, attr, [getattr(self, attr)[i] for i in idx])
        self.gathered = True
        self.release()

    def _install(self, mod: nn.Module) -> None:
        if not hasattr(mod, "_tp_on"):
            mod._tp_on = True
            mod.forward = types.MethodType(_column_forward, mod)
            self.layers.append(mod)

    @property
    def sharded(self) -> int:
        """How many leaves are split."""
        return sum(d is not None for d in self.dims)

    def _gathered(self, t: Tensor, d: int) -> Tensor:
        return torch.cat(mesh_lib.all_gather(t.detach(), "model"), d)

    @torch.no_grad()
    def gather(self) -> None:
        """Every gathered (non-layer) split leaf whole in the model's
        parameter (a collective over ``model``)."""
        if self.gathered:
            return
        for p, s, d, col in zip(self.params, self.shards, self.dims,
                                self.column):
            if d is not None and not col:
                p.data = self._gathered(s, d)
        self.gathered = True

    def release(self) -> None:
        for p, d, col in zip(self.params, self.dims, self.column):
            if d is not None and not col:
                p.data = p.data.new_empty(0)
        self.gathered = False

    def slice_grads(self, grads: Sequence[Tensor]) -> List[Tensor]:
        """The optimizer's gradients: a gathered leaf's slice (every
        ``model`` rank computed the whole, equal), a layer's slice as
        given, and a replicated leaf's mean over ``model`` (equal in
        value on every rank, each rank's rounding its own where the card
        sums in no fixed order: the mean keeps the replicas equal)."""
        rep = iter(mesh_lib.all_reduce_mean(
            [g for g, d in zip(grads, self.dims) if d is None], "model"))
        return [next(rep) if d is None else g if col else
                g.chunk(self.n, d)[self.rank].contiguous()
                for g, d, col in zip(grads, self.dims, self.column)]

    def clip_axes(self) -> List[tuple]:
        return split_axes(self.dims, "model")

    @contextlib.contextmanager
    def whole(self, load: bool = False):
        """Every parameter whole and every layer plain for the block
        (eval, figures, checkpoints, loading); on leaving, each rank takes
        its slices again from the parameters as they then are (so
        ``load`` needs nothing more). A collective over ``model``."""
        self.gather()
        with torch.no_grad():
            for p, d, col in zip(self.params, self.dims, self.column):
                if col:
                    p.data = self._gathered(p.data, d)
        for mod in self.layers:
            mod._tp_on = False
        try:
            yield
        finally:
            with torch.no_grad():
                for p, s, d, col in zip(self.params, self.shards, self.dims,
                                        self.column):
                    if col:
                        p.data = _chunk(p.data, d, self.rank, self.n)
                    elif d is not None:
                        s.copy_(_chunk(p.data, d, self.rank, self.n))
            for mod in self.layers:
                mod._tp_on = True
            self.release()

    @torch.no_grad()
    def finalize(self) -> None:
        """The model whole and plain from here on (the stages after
        training read it)."""
        self.gather()
        for p, d, col in zip(self.params, self.dims, self.column):
            if col:
                p.data = self._gathered(p.data, d)
        for mod in self.layers:
            mod._tp_on = False
        for p in self.params:
            for attr in ("tp_dim", "tp_full_shape", "tp_column"):
                if hasattr(p, attr):
                    delattr(p, attr)
        self.dims = [None] * len(self.dims)
        self.shards = list(self.params)
        self.gathered = True

    # --- optimizer state whole, for a rank-0 checkpoint ---------------------
    def full_optimizer_state(self, sd: dict) -> dict:
        """An optimizer state dict over the slices with every split moment
        gathered whole (a collective over ``model``)."""
        sd = {"state": {int(i): dict(st) for i, st in sd["state"].items()},
              "param_groups": sd["param_groups"]}
        for i, st in sd["state"].items():
            d = self.dims[i]
            if d is None:
                continue
            for k, t in list(st.items()):
                if torch.is_tensor(t) and t.dim() > 0:
                    st[k] = self._gathered(t, d)
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
                    st[k] = _chunk(t, d, self.rank, self.n)
        return sd


__all__ = ["TP_MIN_ELEMS", "TensorParallel", "model_shardings",
           "output_dim", "tp_rule"]
