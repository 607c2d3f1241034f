"""Process groups, the device mesh and data parallelism — port of
``movae_tpu/parallel/mesh.py``.

In the JAX package one process drives every device of a host and GSPMD
inserts the collectives. Here one process drives one device (one rank), as
``torchrun`` starts them: :func:`init_distributed` reads torchrun's
environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/
``MASTER_PORT``) and joins the group; without it one process drives one
device, as before. Every data rank loads its own interleaved slice of
the global batch (``data.Loader(process_index=, process_count=)`` with its
index and the size of the ``data`` axis), so data rank ``p`` holds the
global batch's rows ``p, p + P, p + 2P, ...`` (:func:`local_rows`,
:func:`gather_batch`).

:class:`DataParallel` is the JAX class's counterpart: ``shard_batch``,
``shard_batch_stacked``, ``replicate`` (a broadcast from rank 0),
``host_copy``, ``param_shardings`` (the ``fsdp`` rule), ``shard_params`` and
``pad_to_devices``. The train step reads the active one
(:func:`active_data_parallel`, installed by :meth:`DataParallel.activate`)
and all-reduces what GSPMD would: the gradients, the Jacobian rows, the
Gramian, the metrics; the models' batch-coupled terms (BatchNorm's
statistics, Beta-TC's pairwise estimate, the EMA codebook's restarts)
gather through the helpers here, which are identities on one rank.

Backends: NCCL where each rank has a card of its own; gloo on the CPU and
where ranks share one card (NCCL refuses two ranks on one GPU). gloo
reduces and broadcasts CUDA tensors but gathers only host ones, so a
gather of CUDA tensors on gloo is staged through pinned host memory
(:func:`all_gather`); the compute stays on the card.

The mesh keeps the JAX package's four axes, ``('data', 'model', 'seq',
'pipe')``, the ranks laid out as ``reshape(data, model, seq, pipe)``
(rank ``((d M + m) S + s) P + p``). :func:`make_mesh` builds one process
group per axis line (every rank creates every group, in one order);
:func:`using` makes a mesh current for a block (and
:meth:`DataParallel.activate` through it), and each collective here names
the axis of the current mesh it runs over (``axis=``; ``None`` is every
rank). An autograd function whose backward runs collectives keeps its
forward's mesh for it. Whatever couples the rows of a batch (the
gradients' means, BatchNorm, Beta-TC, the EMA restarts, codebook usage,
the loaders' slices) runs over ``data`` alone: ranks that share a data
index hold the same rows. ``model`` carries tensor parallelism
(``parallel/tensor.py``), ``pipe`` the prior's pipeline
(``parallel/pipeline.py``) and ``seq`` the ring attention
(``ops/ring_attention.py``). Point-to-point transfers (:func:`exchange`)
are batched ``isend``/``irecv`` pairs, staged through pinned host memory
on gloo as the gathers are.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

Tensor = torch.Tensor
AXES = ("data", "model", "seq", "pipe")
FSDP_MIN_ELEMS = 4096


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def backend() -> Optional[str]:
    return dist.get_backend() if dist.is_initialized() else None


def _shared_card(world: int) -> bool:
    """Whether this host's ranks outnumber its cards (they then share)."""
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    return torch.cuda.device_count() < local


def rank_device(device: Any = None) -> torch.device:
    """This rank's device: the CPU where asked, else the card torchrun's
    ``LOCAL_RANK`` names (modulo the cards present, so ranks that outnumber
    the cards share them); without it, ``device`` as given."""
    dev = torch.device("cuda" if device is None else device)
    if (dev.type != "cuda" or dev.index is not None
            or "LOCAL_RANK" not in os.environ):
        return dev
    n = max(torch.cuda.device_count(), 1)
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)) % n)


def init_distributed(device: Any = None, backend_name: Optional[str] = None,
                     init_method: Optional[str] = None,
                     rank: Optional[int] = None,
                     world_size: Optional[int] = None) -> tuple:
    """Join the process group torchrun's environment describes (or the one
    ``init_method``/``rank``/``world_size`` name) and return ``(rank,
    world_size)``; ``(0, 1)`` with no group, one process on one device.
    The backend is NCCL where every rank of the host has a card of its own,
    else gloo (the CPU, or ranks sharing one card)."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    world = int(world_size if world_size is not None
                else os.environ.get("WORLD_SIZE", 1))
    if world <= 1:
        return 0, 1
    rank = int(rank if rank is not None else os.environ.get("RANK", 0))
    dev = rank_device(device)
    if backend_name is None:
        backend_name = ("nccl" if dev.type == "cuda"
                        and not _shared_card(world) else "gloo")
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)
    dist.init_process_group(backend_name, init_method=init_method or
                            "env://", rank=rank, world_size=world)
    return rank, world


@dataclasses.dataclass
class Mesh:
    """The ('data', 'model', 'seq', 'pipe') mesh over the ranks:
    ``shape`` maps each axis to its size; ``device`` is this rank's
    device; ``coords`` this rank's index on each axis; ``lines`` the global
    ranks of this rank's line along each axis (its group's members, in
    axis order) and ``groups`` their process groups (None: every rank, or
    a line of one). ``member`` is False on a rank outside a mesh over a
    subset of the ranks."""

    shape: Dict[str, int]
    device: torch.device
    coords: Dict[str, int] = dataclasses.field(
        default_factory=lambda: dict.fromkeys(AXES, 0))
    lines: Dict[str, List[int]] = dataclasses.field(default_factory=dict)
    groups: Dict[str, Any] = dataclasses.field(default_factory=dict)
    member: bool = True

    @property
    def size(self) -> int:
        n = 1
        for v in self.shape.values():
            n *= v
        return n


_mesh: Optional[Mesh] = None


def current_mesh() -> Optional[Mesh]:
    """The mesh :func:`using` made current (its groups serve the
    collectives), or None."""
    return _mesh


def make_mesh(num_data: Optional[int] = None, num_model: int = 1,
              devices: Optional[Sequence] = None, num_seq: int = 1,
              num_pipe: int = 1, device: Any = None) -> Mesh:
    """('data', 'model', 'seq', 'pipe') mesh over ``devices`` (the ranks,
    by default every rank of the group; one rank drives one device, this
    rank's :func:`rank_device` of ``device``, the card by default), the
    first ``num_data * model * seq * pipe`` of them laid out as
    ``reshape(data, model, seq, pipe)``, as the JAX package's
    ``make_mesh``. Builds every axis line's process group (a collective:
    every rank of the group calls it); :func:`using` makes it current."""
    ranks = list(devices if devices is not None else range(process_count()))
    extra = num_model * num_seq * num_pipe
    if min(num_model, num_seq, num_pipe) < 1 or len(ranks) % extra:
        raise ValueError(
            f"model_partitions={num_model} * context_parallel={num_seq} * "
            f"pipeline_parallel={num_pipe} must divide the device count "
            f"({len(ranks)})")
    if num_data is None:
        num_data = len(ranks) // extra
    used = ranks[:num_data * extra]
    if num_data < 1 or len(used) < num_data * extra or any(
            not 0 <= int(r) < process_count() for r in used):
        raise ValueError(f"a mesh of {num_data} x {extra} ranks needs that "
                         f"many ranks of the {process_count()} in the "
                         f"group, got {ranks}")
    dims = (num_data, num_model, num_seq, num_pipe)
    grid = np.asarray([int(r) for r in used]).reshape(dims)
    me = process_index()
    where = np.argwhere(grid == me)
    member = len(where) == 1
    coords = dict(zip(AXES, (int(c) for c in where[0]) if member
                      else (0,) * 4))
    lines: Dict[str, List[int]] = {}
    groups: Dict[str, Any] = {}
    world = process_count()
    for a, axis in enumerate(AXES):
        # every line along this axis, in one order on every rank
        moved = np.moveaxis(grid, a, -1).reshape(-1, dims[a])
        for line in moved.tolist():
            group = None
            if 1 < dims[a] < world or (dims[a] == world and line != sorted(
                    line)):
                group = dist.new_group(ranks=line)
            if me in line:
                lines[axis], groups[axis] = line, group
    return Mesh(dict(zip(AXES, dims)), rank_device(device), coords, lines,
                groups, member)


@contextlib.contextmanager
def using(mesh: Optional[Mesh]):
    """``mesh`` current for the block (its groups serve the collectives;
    None: no mesh, the data axis over every rank): the one way a mesh
    becomes current."""
    global _mesh
    prev, _mesh = _mesh, mesh
    try:
        yield
    finally:
        _mesh = prev


def axis_size(axis: Optional[str]) -> int:
    """The size of ``axis`` in the current mesh (None: every rank). With
    no mesh, ``data`` spans every rank and the other axes are 1."""
    if axis is None:
        return process_count()
    if _mesh is None:
        return process_count() if axis == "data" else 1
    return _mesh.shape[axis]


def axis_index(axis: Optional[str]) -> int:
    """This rank's index on ``axis`` (None: its rank)."""
    if axis is None:
        return process_index()
    if _mesh is None:
        return process_index() if axis == "data" else 0
    return _mesh.coords[axis]


def _group(axis: Optional[str]):
    if axis is None or _mesh is None:
        return None
    return _mesh.groups.get(axis)


def _global_rank(axis: Optional[str], index: int) -> int:
    if axis is None or _mesh is None:
        return index
    return _mesh.lines[axis][index]


def data_size() -> int:
    return axis_size("data")


def data_index() -> int:
    return axis_index("data")


# ---------------------------------------------------------------------------
# collectives over one axis (identities where the axis is 1)
# ---------------------------------------------------------------------------

def _staged() -> bool:
    return backend() == "gloo"


def _on_backend(t: Tensor) -> Tensor:
    """``t`` where the backend takes it: NCCL reduces CUDA tensors only."""
    if backend() == "nccl" and not t.is_cuda:
        return t.cuda()
    return t


def all_reduce_(t: Tensor, op: str = "sum",
                axis: Optional[str] = "data") -> Tensor:
    """In place over ``axis`` (None: every rank): ``sum``, ``mean`` or
    ``max``."""
    n = axis_size(axis)
    if n == 1:
        return t
    red = {"sum": dist.ReduceOp.SUM, "mean": dist.ReduceOp.SUM,
           "max": dist.ReduceOp.MAX}[op]
    buf = _on_backend(t)
    dist.all_reduce(buf, red, group=_group(axis))
    if buf is not t:
        t.copy_(buf)
    if op == "mean":
        t.div_(n)
    return t


def _all_reduce_flat(tensors: Sequence[Tensor], op: str,
                     axis: Optional[str]) -> List[Tensor]:
    """One all-reduce of one flat buffer, float32 (float64 where a tensor
    is)."""
    tensors = list(tensors)
    if axis_size(axis) == 1 or not tensors:
        return tensors
    dtype = (torch.float64 if any(t.dtype == torch.float64 for t in tensors)
             else torch.float32)
    flat = torch.cat([t.reshape(-1).to(dtype) for t in tensors])
    all_reduce_(flat, op, axis=axis)
    out, i = [], 0
    for t in tensors:
        out.append(flat[i:i + t.numel()].view(t.shape).to(t.dtype))
        i += t.numel()
    return out


def all_reduce_mean(tensors: Sequence[Tensor], axis: Optional[str] = "data"
                    ) -> List[Tensor]:
    """Each tensor's mean over ``axis``, in one all-reduce of one flat
    buffer (identities where the axis is 1)."""
    return _all_reduce_flat(tensors, "mean", axis)


def all_reduce_sum(tensors: Sequence[Tensor], axis: Optional[str] = "data"
                   ) -> List[Tensor]:
    """Each tensor's sum over ``axis``, in one all-reduce of one flat
    buffer (identities where the axis is 1)."""
    return _all_reduce_flat(tensors, "sum", axis)


def all_gather(t: Tensor, axis: Optional[str] = "data") -> List[Tensor]:
    """Every ``axis`` rank's ``t`` (one shape), in axis order; on gloo a
    CUDA tensor goes through pinned host memory."""
    n = axis_size(axis)
    if n == 1:
        return [t]
    src = t.contiguous()
    group = _group(axis)
    if _staged() and src.is_cuda:
        host = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
        host.copy_(src)
        parts = [torch.empty_like(host) for _ in range(n)]
        dist.all_gather(parts, host, group=group)
        return [p.to(t.device, non_blocking=True) for p in parts]
    src = _on_backend(src)
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return [p.to(t.device) for p in parts]


def broadcast_(t: Tensor, src: int = 0,
               axis: Optional[str] = None) -> Tensor:
    """``t`` from the rank of index ``src`` on ``axis`` (None: every
    rank), in place."""
    if axis_size(axis) > 1:
        dist.broadcast(t, _global_rank(axis, src), group=_group(axis))
    return t


def all_gather_object(obj: Any, axis: Optional[str]) -> List[Any]:
    """Every ``axis`` rank's picklable ``obj``, in axis order."""
    parts: List[Any] = [None] * axis_size(axis)
    if len(parts) == 1:
        return [obj]
    dist.all_gather_object(parts, obj, group=_group(axis))
    return parts


def exchange(sends: Sequence = (), recvs: Sequence = (),
             axis: str = "pipe") -> None:
    """Point-to-point transfers over ``axis``, posted together as one
    batch of ``isend``/``irecv`` pairs and waited for (a chain of blocking
    sends and receives around a ring deadlocks): ``sends`` and ``recvs``
    are ``(tensor, peer)`` pairs, ``peer`` an index on the axis; each
    received tensor is written in place. On gloo a CUDA tensor goes
    through pinned host memory."""
    staged = _staged()
    ops, landing = [], []
    group = _group(axis)
    for t, peer in sends:
        buf = t.contiguous()
        if staged and buf.is_cuda:
            host = torch.empty(buf.shape, dtype=buf.dtype, pin_memory=True)
            buf = host.copy_(buf)
        ops.append(dist.P2POp(dist.isend, buf, _global_rank(axis, peer),
                              group))
    for t, peer in recvs:
        buf = t
        if (staged and t.is_cuda) or not t.is_contiguous():
            buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=staged
                              and t.is_cuda,
                              device="cpu" if staged and t.is_cuda
                              else t.device)
        landing.append((t, buf))
        ops.append(dist.P2POp(dist.irecv, buf, _global_rank(axis, peer),
                              group))
    if not ops:
        return
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    for t, buf in landing:
        if buf is not t:
            t.copy_(buf)


def clip_by_global_norm(grads: Sequence[Tensor], axes: Sequence[tuple],
                        max_norm: float) -> List[Tensor]:
    """optax's ``clip_by_global_norm`` over the whole gradient from leaves
    split over the mesh: ``axes[i]`` are the axes leaf i is split over
    (fsdp's ``data``, tensor parallelism's ``model``, the pipeline's
    ``pipe``); its squares are summed over them, a replicated leaf's
    counted once."""
    dev = grads[0].device
    total = torch.zeros((), dtype=torch.float32, device=dev)
    for key in sorted(set(tuple(a) for a in axes)):
        sq = torch.zeros((), dtype=torch.float32, device=dev)
        for g, ax in zip(grads, axes):
            if tuple(ax) == key:
                sq = sq + g.float().square().sum()
        for axis in key:
            sq = all_reduce_(sq, "sum", axis=axis)
        total = total + sq
    norm = total.sqrt()
    scale = torch.where(norm < max_norm, torch.ones_like(norm),
                        max_norm / norm)
    return [g * scale.to(g.dtype) for g in grads]


def sync_generator(gen: torch.Generator) -> torch.Generator:
    """``gen`` set to rank 0's state on every rank (after draws that
    followed each rank's own rows)."""
    if process_count() > 1:
        state = [gen.get_state()]
        dist.broadcast_object_list(state, 0)
        gen.set_state(state[0])
    return gen


def interleave(parts: Sequence[Tensor]) -> Tensor:
    """Per-rank (b, ...) row blocks -> the global (P b, ...) batch, rank p's
    row i at global row i P + p (the loaders' interleave)."""
    if len(parts) == 1:
        return parts[0]
    stacked = torch.stack(list(parts), 1)
    return stacked.reshape(-1, *stacked.shape[2:])


def local_rows(t: Tensor, batch_dim: int = 0) -> Tensor:
    """This rank's rows ``p, p + P, ...`` of a global batch along
    ``batch_dim``, ``p`` its index on the data axis of ``P``."""
    n = data_size()
    if n == 1:
        return t
    idx = torch.arange(data_index(), t.shape[batch_dim], n,
                       device=t.device)
    return t.index_select(batch_dim, idx)


class _GatherBatch(torch.autograd.Function):
    """:func:`interleave` of every data rank's rows; the backward sums the
    cotangents of every data rank (each computed the same global function) and
    keeps this rank's rows, so the all-reduced mean of the parameter
    gradients is the gradient of the global loss."""

    @staticmethod
    def forward(ctx, t: Tensor) -> Tensor:
        ctx.mesh = _mesh
        return interleave(all_gather(t))

    @staticmethod
    def backward(ctx, g: Tensor) -> Tensor:
        with using(ctx.mesh):
            g = all_reduce_(g.contiguous().clone(), "sum")
            return local_rows(g)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t: Tensor) -> Tensor:
        ctx.mesh = _mesh
        return all_reduce_(t.clone(), "sum")

    @staticmethod
    def backward(ctx, g: Tensor) -> Tensor:
        with using(ctx.mesh):
            return all_reduce_(g.contiguous().clone(), "sum")


class _CopyToAxis(torch.autograd.Function):
    """Identity forward; the backward sums the cotangent over ``axis``
    (an input every rank of the axis holds whole, each using part of it)."""

    @staticmethod
    def forward(ctx, t: Tensor, axis: str) -> Tensor:
        ctx.axis, ctx.mesh = axis, _mesh
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g: Tensor):
        with using(ctx.mesh):
            return (all_reduce_(g.contiguous().clone(), "sum", ctx.axis),
                    None)


class _GatherFromAxis(torch.autograd.Function):
    """Every ``axis`` rank's part concatenated along ``dim`` (in axis
    order); the backward keeps this rank's part of the cotangent (every
    rank of the axis computes the same function of the whole)."""

    @staticmethod
    def forward(ctx, t: Tensor, dim: int, axis: str) -> Tensor:
        ctx.dim, ctx.axis, ctx.n = dim, axis, t.shape[dim]
        ctx.index = axis_index(axis)
        return torch.cat(all_gather(t, axis), dim)

    @staticmethod
    def backward(ctx, g: Tensor):
        i = ctx.index
        return g.narrow(ctx.dim, i * ctx.n, ctx.n).contiguous(), None, None


def copy_to_axis(t: Tensor, axis: str) -> Tensor:
    """``t`` as it is, its gradient summed over ``axis`` (the entry of a
    layer whose ``axis`` ranks each compute part of the output)."""
    if axis_size(axis) == 1:
        return t
    return _CopyToAxis.apply(t, axis)


def gather_from_axis(t: Tensor, dim: int, axis: str) -> Tensor:
    """The ``axis`` ranks' parts of ``t`` concatenated along ``dim``,
    differentiable (the exit of such a layer)."""
    if axis_size(axis) == 1:
        return t
    return _GatherFromAxis.apply(t, dim % t.dim(), axis)


def gather_batch(t: Tensor) -> Tensor:
    """The global batch of a per-row tensor under an active
    :class:`DataParallel` (differentiable), else ``t``."""
    if active_data_parallel() is None or data_size() == 1:
        return t
    return _GatherBatch.apply(t)


def global_rows(t: Tensor) -> Tensor:
    """The global batch of a per-row (b, ...) tensor under an active
    :class:`DataParallel` (no gradient: statistics, restart rows), else
    ``t``."""
    if active_data_parallel() is None or data_size() == 1:
        return t
    return interleave(all_gather(t.detach()))


def sum_over_batch(t: Tensor) -> Tensor:
    """``t`` summed over the data ranks under an active
    :class:`DataParallel` (differentiable: a per-rank partial sum of a
    batch statistic), else ``t``."""
    if active_data_parallel() is None or data_size() == 1:
        return t
    return _AllReduceSum.apply(t)


def global_batch_size(local: int) -> int:
    """The global batch of a ``local`` per-rank batch under an active
    :class:`DataParallel`."""
    if active_data_parallel() is None:
        return local
    return local * data_size()


# ---------------------------------------------------------------------------
# DataParallel
# ---------------------------------------------------------------------------

_active: Optional["DataParallel"] = None


def active_data_parallel() -> Optional["DataParallel"]:
    """The :class:`DataParallel` whose step is running, or None."""
    return _active


class DataParallel:
    """Shard batches over 'data' (each rank holds its own rows); replicate
    state (broadcast from rank 0). With ``fsdp=True`` (ZeRO-3), large
    parameter leaves and their optimizer moments are held at rest as
    1/dp slices on their largest dimension divisible by dp
    (:meth:`param_shardings`; ``parallel/fsdp.py``), gathered before the
    step, their gradients reduce-scattered."""

    def __init__(self, mesh: Optional[Mesh] = None, fsdp: bool = False):
        self.mesh = mesh if mesh is not None else make_mesh()
        self.fsdp = fsdp
        self.device = self.mesh.device

    @property
    def num_devices(self) -> int:
        return self.mesh.size

    @property
    def rank(self) -> int:
        return process_index()

    @contextlib.contextmanager
    def activate(self):
        """Install this as the active data-parallel config (the step and
        the models' batch-coupled terms read it)."""
        global _active
        prev, _active = _active, self
        try:
            with using(self.mesh):
                yield self
        finally:
            _active = prev

    def shard_batch(self, batch: Any) -> Tensor:
        """This rank's batch (its own slice, as its loader yields it) on
        its device."""
        return torch.as_tensor(batch).to(self.device, non_blocking=True)

    def shard_batch_stacked(self, batches: Any) -> Tensor:
        """A (k, b, ...) stack of this rank's per-step batches."""
        return self.shard_batch(batches)

    def replicate(self, module: torch.nn.Module) -> torch.nn.Module:
        """``module``'s parameters and buffers broadcast from rank 0, in
        place."""
        with torch.no_grad():
            for t in module.state_dict().values():
                broadcast_(t)
        return module

    def host_copy(self, tree: Any) -> Any:
        """Host copy of ``tree``; sharded (fsdp) leaves are gathered, a
        COLLECTIVE: every rank calls it, and only the write is gated on
        rank 0."""
        from movae_tpu_torch.parallel.fsdp import host_tree
        return host_tree(tree)

    def param_shardings(self, params: Any,
                        min_elems: int = FSDP_MIN_ELEMS) -> Any:
        """The dimension each leaf is sharded on over 'data' (None:
        replicated): under ``fsdp``, a leaf of at least ``min_elems``
        elements on its largest dimension divisible by dp."""
        dp = self.mesh.shape["data"]

        def rule(leaf) -> Optional[int]:
            # a tensor-parallel slice (parallel/tensor.py) counts its whole
            # leaf's size, and its 'model' dimension is taken
            ndim = getattr(leaf, "ndim", 0)
            full = getattr(leaf, "tp_full_shape", None)
            numel = (int(np.prod(full)) if full is not None
                     else leaf.numel())
            taken = getattr(leaf, "tp_dim", None)
            if not (self.fsdp and dp > 1 and ndim >= 1
                    and numel >= min_elems):
                return None
            cands = [d for d in range(ndim)
                     if d != taken and leaf.shape[d] % dp == 0]
            return max(cands, key=lambda d: leaf.shape[d]) if cands else None

        if isinstance(params, dict):
            return {k: rule(v) for k, v in params.items()}
        if isinstance(params, (list, tuple)):
            return [rule(v) for v in params]
        return rule(params)

    def shard_params(self, model: torch.nn.Module,
                     min_elems: int = FSDP_MIN_ELEMS):
        """The model's trainable parameters as an fsdp shard set
        (``parallel/fsdp.py:ShardedParams``)."""
        from movae_tpu_torch.parallel.fsdp import ShardedParams
        return ShardedParams(model, self, min_elems)

    def pad_to_devices(self, n: int) -> int:
        d = self.mesh.shape["data"]
        return ((n + d - 1) // d) * d
