"""Process groups, the device mesh and data parallelism — port of
``movae_tpu/parallel/mesh.py``.

In the JAX package one process drives every device of a host and GSPMD
inserts the collectives. Here one process drives one device (one rank), as
``torchrun`` starts them: :func:`init_distributed` reads torchrun's
environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/
``MASTER_PORT``) and joins the group; without it one process drives one
device, as before. Every rank loads its own interleaved slice of the
global batch (``data.Loader(process_index=, process_count=)``), so rank
``p`` holds the global batch's rows ``p, p + P, p + 2P, ...``
(:func:`local_rows`, :func:`gather_batch`).

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
'pipe')``. Only ``data`` may exceed 1: tensor, context and pipeline
parallelism are ROADMAP.md Queue 1 item 13's remaining sub-items.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Any, Dict, List, Optional, Sequence

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
    ``shape`` maps each axis to its size; ``device_mesh`` is torch's
    ``DeviceMesh`` over the same axes where a group exists (None on one
    process); ``device`` this rank's device."""

    shape: Dict[str, int]
    device: torch.device
    device_mesh: Any = None

    @property
    def size(self) -> int:
        n = 1
        for v in self.shape.values():
            n *= v
        return n


def make_mesh(num_data: Optional[int] = None, num_model: int = 1,
              devices: Optional[Sequence] = None, num_seq: int = 1,
              num_pipe: int = 1, device: Any = None) -> Mesh:
    """('data', 'model', 'seq', 'pipe') mesh over ``devices`` (the ranks,
    by default every rank of the group; one rank drives one device, this
    rank's :func:`rank_device` of ``device``, the card by default). The
    trailing axes default to size 1; the port takes none of them above 1
    yet (ROADMAP.md Queue 1 item 13)."""
    ranks = list(devices if devices is not None else range(process_count()))
    extra = num_model * num_seq * num_pipe
    if min(num_model, num_seq, num_pipe) < 1 or len(ranks) % extra:
        raise ValueError(
            f"model_partitions={num_model} * context_parallel={num_seq} * "
            f"pipeline_parallel={num_pipe} must divide the device count "
            f"({len(ranks)})")
    if extra > 1:
        raise NotImplementedError(
            "model_partitions, context_parallel and pipeline_parallel > 1 "
            "are not ported to movae_tpu_torch yet: ROADMAP.md Queue 1 item "
            "13 (tensor parallelism, parallel/pipeline.py, "
            "ops/ring_attention.py with ContextParallel)")
    if num_data is None:
        num_data = len(ranks) // extra
    if num_data != process_count():
        raise ValueError(f"the data axis ({num_data}) must span every rank "
                         f"({process_count()}): one rank drives one device")
    dev = rank_device(device)
    shape = dict(zip(AXES, (num_data, num_model, num_seq, num_pipe)))
    device_mesh = None
    if dist.is_initialized() and num_data > 1:
        from torch.distributed.device_mesh import DeviceMesh
        device_mesh = DeviceMesh(
            dev.type, torch.arange(num_data).reshape(num_data, 1, 1, 1),
            mesh_dim_names=AXES)
    return Mesh(shape, dev, device_mesh)


# ---------------------------------------------------------------------------
# collectives over the data axis (identities on one rank)
# ---------------------------------------------------------------------------

def _staged() -> bool:
    return backend() == "gloo"


def _on_backend(t: Tensor) -> Tensor:
    """``t`` where the backend takes it: NCCL reduces CUDA tensors only."""
    if backend() == "nccl" and not t.is_cuda:
        return t.cuda()
    return t


def all_reduce_(t: Tensor, op: str = "sum") -> Tensor:
    """In place over every rank: ``sum``, ``mean`` or ``max``."""
    if process_count() == 1:
        return t
    red = {"sum": dist.ReduceOp.SUM, "mean": dist.ReduceOp.SUM,
           "max": dist.ReduceOp.MAX}[op]
    buf = _on_backend(t)
    dist.all_reduce(buf, red)
    if buf is not t:
        t.copy_(buf)
    if op == "mean":
        t.div_(process_count())
    return t


def all_gather(t: Tensor) -> List[Tensor]:
    """Every rank's ``t`` (one shape), in rank order; on gloo a CUDA tensor
    goes through pinned host memory."""
    n = process_count()
    if n == 1:
        return [t]
    src = t.contiguous()
    if _staged() and src.is_cuda:
        host = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
        host.copy_(src)
        parts = [torch.empty_like(host) for _ in range(n)]
        dist.all_gather(parts, host)
        return [p.to(t.device, non_blocking=True) for p in parts]
    src = _on_backend(src)
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src)
    return [p.to(t.device) for p in parts]


def broadcast_(t: Tensor, src: int = 0) -> Tensor:
    if process_count() > 1:
        dist.broadcast(t, src)
    return t


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
    ``batch_dim``."""
    n = process_count()
    if n == 1:
        return t
    idx = torch.arange(process_index(), t.shape[batch_dim], n,
                       device=t.device)
    return t.index_select(batch_dim, idx)


class _GatherBatch(torch.autograd.Function):
    """:func:`interleave` of every rank's rows; the backward sums the
    cotangents of every rank (each computed the same global function) and
    keeps this rank's rows, so the all-reduced mean of the parameter
    gradients is the gradient of the global loss."""

    @staticmethod
    def forward(ctx, t: Tensor) -> Tensor:
        return interleave(all_gather(t))

    @staticmethod
    def backward(ctx, g: Tensor) -> Tensor:
        g = all_reduce_(g.contiguous().clone(), "sum")
        return local_rows(g)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t: Tensor) -> Tensor:
        return all_reduce_(t.clone(), "sum")

    @staticmethod
    def backward(ctx, g: Tensor) -> Tensor:
        return all_reduce_(g.contiguous().clone(), "sum")


def gather_batch(t: Tensor) -> Tensor:
    """The global batch of a per-row tensor under an active
    :class:`DataParallel` (differentiable), else ``t``."""
    if active_data_parallel() is None or process_count() == 1:
        return t
    return _GatherBatch.apply(t)


def global_rows(t: Tensor) -> Tensor:
    """The global batch of a per-row (b, ...) tensor under an active
    :class:`DataParallel` (no gradient: statistics, restart rows), else
    ``t``."""
    if active_data_parallel() is None or process_count() == 1:
        return t
    return interleave(all_gather(t.detach()))


def sum_over_batch(t: Tensor) -> Tensor:
    """``t`` summed over the ranks under an active :class:`DataParallel`
    (differentiable: a per-rank partial sum of a batch statistic), else
    ``t``."""
    if active_data_parallel() is None or process_count() == 1:
        return t
    return _AllReduceSum.apply(t)


def global_batch_size(local: int) -> int:
    """The global batch of a ``local`` per-rank batch under an active
    :class:`DataParallel`."""
    if active_data_parallel() is None:
        return local
    return local * process_count()


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
            ndim = getattr(leaf, "ndim", 0)
            if not (self.fsdp and dp > 1 and ndim >= 1
                    and leaf.numel() >= min_elems):
                return None
            cands = [d for d in range(ndim) if leaf.shape[d] % dp == 0]
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
