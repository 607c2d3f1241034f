"""Context-parallel attention, the row-sharded prior trunk and
sample-parallel generation — port of ``movae_tpu/parallel/context.py``.

A :class:`ContextParallel` installed by :func:`context_parallel` (the prior
trainer does, for ``--context_parallel N``) makes
``ops/attention.py:causal_attention`` take the zigzag ring
(``ops/ring_attention.py``) over the current mesh's ``seq`` axis
(``parallel/mesh.py:using``), at any L. The JAX config's ``mesh``,
``seq_axis``, ``batch_axis`` and ``head_axis`` have no counterpart: the
mesh is the current one, its axis is always ``seq``, each rank already
holds its rows of the batch, and the port splits no attention heads (its
prior is not tensor-parallel).

The port of ``seq_shard_spatial``: where the active context's S > 1
``seq`` ranks divide a code grid's H rows (the JAX package's own
condition), each ``seq`` rank runs the prior's trunk on its contiguous
rows ``[r H/S, (r+1) H/S)`` alone (:func:`trunk_rows`,
:func:`sharded_trunk`; ``models/pixelcnn.py:_Prior``). Inside such a
trunk a masked convolution pads its top with the rows above from the
ranks that hold them (:func:`halo_rows`, over as many ranks as its halo
spans), the 1×1 convolutions, gates and head are row-local, the raster
sequence of each rank is its contiguous part of L, which the ring takes
as it is (``ops/ring_attention.py:ring_attention_rows``), and each rank's
loss is its rows' share of the global mean, summed over ``seq``
(:func:`sum_over_seq`), so its parameter gradients are its part of the
whole. A grid the ranks do not divide runs whole on every ``seq`` rank,
the ring slicing q, k, v at its entry, and its loss hands each rank
1/S of the (replicated) gradient (:func:`part_of_whole`): under an
active context every rank's gradient is a part, and the trainer sums
them over ``seq``.

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
from typing import Iterator, List, Optional, Tuple

import torch

from movae_tpu_torch.parallel import mesh as mesh_lib

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class ContextParallel:
    """Attention takes the ring over the current mesh's ``seq`` axis;
    ``sharded``: inside a row-sharded trunk (each rank holds its
    contiguous rows, and its part of the raster sequence)."""

    sharded: bool = False

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


# --- the row-sharded trunk (seq_shard_spatial) -----------------------------

def _size() -> int:
    ctx = get_context_parallel()
    return 1 if ctx is None else ctx.size


def trunk_rows(h: int) -> Optional[Tuple[int, int]]:
    """This rank's rows ``(start, stop)`` of an ``h``-row grid where the
    active context shards the trunk (S > 1 ``seq`` ranks dividing ``h``);
    None: the trunk runs whole."""
    S = _size()
    if S <= 1 or h % S:
        return None
    n = h // S
    r = mesh_lib.axis_index("seq")
    return r * n, (r + 1) * n


def trunk_sharded() -> bool:
    """Whether the code runs inside a row-sharded trunk."""
    ctx = get_context_parallel()
    return ctx is not None and ctx.sharded and ctx.size > 1


@contextlib.contextmanager
def sharded_trunk(rows: Optional[Tuple[int, int]]) -> Iterator[None]:
    """The active context marked sharded for the block where ``rows`` (of
    :func:`trunk_rows`) is given; else nothing changes."""
    global _current
    if rows is None:
        yield
        return
    prev = _current
    _current = dataclasses.replace(prev, sharded=True)
    try:
        yield
    finally:
        _current = prev


def seq_part(n: int) -> Tuple[int, int]:
    """``(offset, whole)`` of this rank's ``n`` positions along the
    sequence (or rows) of a sharded trunk: its part of a draw made for the
    whole (``models/pixelcnn.py:_dropout``)."""
    S = mesh_lib.axis_size("seq")
    return mesh_lib.axis_index("seq") * n, n * S


def _halo_parts(n: int, p: int, r: int) -> List[Tuple[int, int, int, int]]:
    """Rank ``r``'s halo: the ``p`` rows above its first, ``n`` rows a
    rank, as ``(owner, owner's first row, count, offset in the halo)``;
    rows above row 0 own nothing (the halo's zeros)."""
    base = r * n - p
    parts, g = [], max(base, 0)
    while g < r * n:
        owner, first = divmod(g, n)
        count = min(n - first, r * n - g)
        parts.append((owner, first, count, g - base))
        g += count
    return parts


def _halo_moves(n: int, p: int) -> Tuple[list, list]:
    """(sends, receives) of this rank's halo exchange: ``(peer, first row
    on the owner, count, offset in the peer's or this rank's halo)``."""
    S, me = mesh_lib.axis_size("seq"), mesh_lib.axis_index("seq")
    sends = [(d, first, count, off) for d in range(me + 1, S)
             for owner, first, count, off in _halo_parts(n, p, d)
             if owner == me]
    recvs = [(owner, first, count, off)
             for owner, first, count, off in _halo_parts(n, p, me)]
    return sends, recvs


class _Halo(torch.autograd.Function):
    """The ``p`` rows above this rank's rows, from the ``seq`` ranks that
    hold them (zeros above the grid); the backward sends each halo row's
    cotangent home, where it is added in. Over the forward's mesh."""

    @staticmethod
    def forward(ctx, x: Tensor, p: int) -> Tensor:
        ctx.shape, ctx.p, ctx.mesh = x.shape, p, mesh_lib.current_mesh()
        sends, recvs = _halo_moves(x.shape[2], p)
        b, c, _, w = x.shape
        bufs = [x.new_empty((b, c, count, w)) for _, _, count, _ in recvs]
        mesh_lib.exchange(
            [(x.narrow(2, first, count), d) for d, first, count, _ in sends],
            [(buf, owner) for buf, (owner, _, _, _) in zip(bufs, recvs)],
            axis="seq")
        halo = x.new_zeros((b, c, p, w))
        for buf, (_, _, count, off) in zip(bufs, recvs):
            halo[:, :, off:off + count] = buf
        return halo

    @staticmethod
    def backward(ctx, g: Tensor):
        b, c, n, w = ctx.shape
        with mesh_lib.using(ctx.mesh):
            sends, recvs = _halo_moves(n, ctx.p)
            bufs = [g.new_empty((b, c, count, w)) for _, _, count, _ in sends]
            mesh_lib.exchange(
                [(g.narrow(2, off, count), owner)
                 for owner, _, count, off in recvs],
                [(buf, d) for buf, (d, _, _, _) in zip(bufs, sends)],
                axis="seq")
        gx = g.new_zeros((b, c, n, w))
        for buf, (_, first, count, _) in zip(bufs, sends):
            gx[:, :, first:first + count] += buf
        return gx, None


def halo_rows(x: Tensor, p: int) -> Tensor:
    """The ``p`` rows of the whole grid above this rank's (B, C, H/S, W)
    rows of a sharded trunk, (B, C, p, W): zeros above row 0, else from
    the rank or ranks that hold them (a halo may span several ranks where
    H/S < p). Differentiable: each row's gradient goes home."""
    if p == 0:
        return x[:, :, :0]
    return _Halo.apply(x, p)


class _SumOverSeq(torch.autograd.Function):
    """Sum over ``seq``; the backward passes the cotangent as it is (each
    rank's term is its own part of the sum)."""

    @staticmethod
    def forward(ctx, t: Tensor) -> Tensor:
        return mesh_lib.all_reduce_(t.clone(), "sum", axis="seq")

    @staticmethod
    def backward(ctx, g: Tensor) -> Tensor:
        return g


def sum_over_seq(t: Tensor) -> Tensor:
    """A sharded trunk's per-rank term (its rows' share of a loss) summed
    over ``seq``: the whole value on every rank, each rank's gradient its
    own rows'."""
    if mesh_lib.axis_size("seq") == 1:
        return t
    return _SumOverSeq.apply(t)


class _PartOfWhole(torch.autograd.Function):
    """Identity forward; the backward hands on 1/``n`` of the cotangent."""

    @staticmethod
    def forward(ctx, t: Tensor, n: int) -> Tensor:
        ctx.n = n
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g: Tensor):
        return g / ctx.n, None


def part_of_whole(loss: Tensor) -> Tensor:
    """A whole trunk's loss under an active context, the same on every
    ``seq`` rank: its value as it is, its gradient 1/S of it, so that the
    trainer's sum over ``seq`` (made for the sharded trunk's parts) gives
    the replicas' mean (bit for bit where S is a power of two)."""
    S = _size()
    if S <= 1:
        return loss
    return _PartOfWhole.apply(loss, S)


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
