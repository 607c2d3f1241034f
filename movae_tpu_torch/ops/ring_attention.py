"""Ring (sequence-parallel) causal attention over the ``seq`` mesh axis —
port of ``movae_tpu/ops/ring_attention.py``.

The raster sequence L of the prior's attention is cut into stripes over
the S ranks of ``seq``; K/V stripes rotate around the ring
(``mesh.exchange``, one batch of ``isend``/``irecv`` pairs a rotation)
while each rank merges its queries' attention over the passing keys with
an online softmax in base 2. Both layouts of the JAX package:

* ``zigzag=True`` (default): L is padded to a multiple of 2S and cut into
  2S stripes; rank d holds stripes (d, 2S-1-d). Every cross-stripe block
  is then fully visible or fully masked: each rotation runs two full
  stripe products (the back stripe always sees the arriving front stripe;
  the front stripe the arriving front one where the source rank is lower,
  else the back stripe the arriving back one), and only the own pair's
  diagonal blocks are causal.
* ``zigzag=False``: contiguous chunks (L padded to a multiple of S); a
  chunk from a later rank is fully masked and skipped (the JAX version
  leaves its accumulators exactly unchanged there).

Pad keys sit after every real query, so causality keeps them out; pad
query rows are sliced off. The ring always computes in float32, whatever
the inputs' dtype, and casts back, as the JAX package does. The diagonal
(causal) blocks run the hand-written float32 flash kernels
(``kernels/flash_attention.py:flash_fwd``, ``flash_bwd_dkv``,
``flash_bwd_dq``; their plain version on the CPU); the full off-diagonal
blocks are plain float32 products with TF32 off, as JAX computes them in
XLA outside any Pallas kernel. :class:`_Ring` is one
``torch.autograd.Function`` with its backward by hand: it feeds every
block, the kernels included, the GLOBAL ``lse2`` (base 2) and ``di =
rowsum(do * o)`` of the merged output, so each block's partial dQ/dK/dV
is exact; the K/V stripes and their dK/dV accumulators travel the ring in
the opposite direction, and dK/dV take one more hop home.

The trunk before the attention runs whole on every ``seq`` rank, so
:func:`ring_causal_attention` takes each rank's whole (B, H, L, D) q, k,
v, keeps its stripes (identity forward, gradient summed over ``seq``) and
gathers the output (all-gather forward, own stripes backward): the pair
of ``parallel/tensor.py``'s layers (``mesh.copy_to_axis``,
``mesh.gather_from_axis``).
"""

from __future__ import annotations

import contextlib
import math
from typing import Tuple

import torch

from movae_tpu_torch.kernels import flash_attention as fa
from movae_tpu_torch.parallel import mesh as mesh_lib

Tensor = torch.Tensor
LOG2E = 1.4426950408889634


def _rotations(S: int) -> range:
    """The ring's rotations after the own (diagonal) step."""
    return range(1, S)


@contextlib.contextmanager
def _no_tf32():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _logits2(q: Tensor, k: Tensor, sm_scale: float, causal: bool
             ) -> Tensor:
    """Base-2 logits ``q k^T sm_scale log2(e)``, -inf above the diagonal
    where ``causal``."""
    with _no_tf32():
        s = torch.matmul(q, k.transpose(-1, -2)) * (sm_scale * LOG2E)
    if causal:
        L = q.shape[2]
        mask = torch.ones((L, L), dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask, float("-inf"))
    return s


def plain_block_fwd(q: Tensor, k: Tensor, v: Tensor, sm_scale: float,
                    causal: bool) -> Tuple[Tensor, Tensor]:
    """One block's (o, lse2) in float32: the flash forward kernel's
    function (``causal``) or a full block's."""
    s = _logits2(q, k, sm_scale, causal)
    m = s.amax(-1, keepdim=True)
    p = torch.exp2(s - m)
    l = p.sum(-1, keepdim=True)
    with _no_tf32():
        o = torch.matmul(p, v) / l
    return o, (m + torch.log2(l)).squeeze(-1)


def plain_block_bwd(q: Tensor, k: Tensor, v: Tensor, do: Tensor,
                    lse2: Tensor, di: Tensor, sm_scale: float, causal: bool
                    ) -> Tuple[Tensor, Tensor, Tensor]:
    """One block's (dq, dk, dv) from the global ``lse2`` and ``di``: the
    flash backward kernels' function (``causal``) or a full block's."""
    p = torch.exp2(_logits2(q, k, sm_scale, causal) - lse2[..., None])
    with _no_tf32():
        dv = torch.matmul(p.transpose(-1, -2), do)
        dp = torch.matmul(do, v.transpose(-1, -2))
        ds = p * (dp - di[..., None])
        dq = torch.matmul(ds, k) * sm_scale
        dk = torch.matmul(ds.transpose(-1, -2), q) * sm_scale
    return dq, dk, dv


def _tril_fwd(q: Tensor, k: Tensor, v: Tensor, sm_scale: float):
    """A diagonal block: the float32 flash forward kernel on the card, its
    plain version on the CPU."""
    if q.device.type == "cpu":
        return plain_block_fwd(q, k, v, sm_scale, True)
    fa._check(q=q, k=k, v=v)
    return fa.flash_fwd(q, k, v, sm_scale)


def _tril_bwd(q, k, v, do, lse2, di, sm_scale: float):
    """A diagonal block's (dq, dk, dv): the float32 dK/dV and dQ kernels
    fed the global ``lse2`` and ``di`` on the card."""
    if q.device.type == "cpu":
        return plain_block_bwd(q, k, v, do, lse2, di, sm_scale, True)
    fa._check(q=q, do=do)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse2, di, sm_scale)
    dq = fa.flash_bwd_dq(q, k, v, do, lse2, di, sm_scale)
    return dq, dk, dv


def _merge(acc, new):
    """Online softmax merge in base 2 of two normalized partial outputs
    with their row log-sum-exps."""
    if acc is None:
        return new
    (o1, l1), (o2, l2) = acc, new
    lse = torch.logaddexp2(l1, l2)
    return (o1 * torch.exp2(l1 - lse)[..., None]
            + o2 * torch.exp2(l2 - lse)[..., None], lse)


def _halves(t: Tensor) -> Tuple[Tensor, Tensor]:
    n = t.shape[2] // 2
    return t[:, :, :n].contiguous(), t[:, :, n:].contiguous()


def _rotate(t: Tensor, step: int) -> Tensor:
    """``t`` from the rank ``step`` behind on the ring (it goes ``step``
    ahead)."""
    S, me = mesh_lib.axis_size("seq"), mesh_lib.axis_index("seq")
    out = torch.empty_like(t)
    mesh_lib.exchange([(t, (me + step) % S)], [(out, (me - step) % S)],
                      axis="seq")
    return out


class _Ring(torch.autograd.Function):
    """This rank's stripes (B, H, Ls, D) float32 q, k, v -> its output
    stripes; forward and backward by hand (see the module docstring),
    the backward over the forward's mesh."""

    @staticmethod
    def forward(ctx, q: Tensor, k: Tensor, v: Tensor, sm_scale: float,
                zigzag: bool) -> Tensor:
        S, me = mesh_lib.axis_size("seq"), mesh_lib.axis_index("seq")
        if zigzag:
            qA, qB = _halves(q)
            kA, kB = _halves(k)
            vA, vB = _halves(v)
            accA = _tril_fwd(qA, kA, vA, sm_scale)
            accB = _merge(_tril_fwd(qB, kB, vB, sm_scale),
                          plain_block_fwd(qB, kA, vA, sm_scale, False))
        else:
            acc = _tril_fwd(q, k, v, sm_scale)
        kv = torch.stack([k, v])
        for s in _rotations(S):
            kv = _rotate(kv, 1)
            src = (me - s) % S
            if zigzag:
                kA, kB = _halves(kv[0])
                vA, vB = _halves(kv[1])
                accB = _merge(accB, plain_block_fwd(qB, kA, vA, sm_scale,
                                                    False))
                if src < me:
                    accA = _merge(accA, plain_block_fwd(qA, kA, vA,
                                                        sm_scale, False))
                else:
                    accB = _merge(accB, plain_block_fwd(qB, kB, vB,
                                                        sm_scale, False))
            elif src < me:
                acc = _merge(acc, plain_block_fwd(q, kv[0], kv[1], sm_scale,
                                                  False))
        if zigzag:
            o = torch.cat([accA[0], accB[0]], 2)
            lse2 = torch.cat([accA[1], accB[1]], 2)
        else:
            o, lse2 = acc
        ctx.save_for_backward(q, k, v, o, lse2)
        ctx.sm_scale, ctx.zigzag = sm_scale, zigzag
        ctx.mesh = mesh_lib.current_mesh()
        return o

    @staticmethod
    def backward(ctx, do: Tensor):
        with mesh_lib.using(ctx.mesh):
            return _Ring._backward(ctx, do)

    @staticmethod
    def _backward(ctx, do: Tensor):
        q, k, v, o, lse2 = ctx.saved_tensors
        sm, zigzag = ctx.sm_scale, ctx.zigzag
        S, me = mesh_lib.axis_size("seq"), mesh_lib.axis_index("seq")
        do = do.contiguous()
        di = (o * do).sum(-1)

        def full(qx, kx, vx, dox, lx, dx):
            return plain_block_bwd(qx, kx, vx, dox, lx, dx, sm, False)

        if zigzag:
            qA, qB = _halves(q)
            kA, kB = _halves(k)
            vA, vB = _halves(v)
            doA, doB = _halves(do)
            n = lse2.shape[2] // 2
            lA, lB = lse2[:, :, :n].contiguous(), lse2[:, :, n:].contiguous()
            dA, dB = di[:, :, :n].contiguous(), di[:, :, n:].contiguous()
            dqA, dkA, dvA = _tril_bwd(qA, kA, vA, doA, lA, dA, sm)
            dqB, dkB, dvB = _tril_bwd(qB, kB, vB, doB, lB, dB, sm)
            g = full(qB, kA, vA, doB, lB, dB)
            dqB, dkA, dvA = dqB + g[0], dkA + g[1], dvA + g[2]
            dq = [dqA, dqB]
            dkv = torch.stack([torch.cat([dkA, dkB], 2),
                               torch.cat([dvA, dvB], 2)])
        else:
            dq0, dk0, dv0 = _tril_bwd(q, k, v, do, lse2, di, sm)
            dq = [dq0]
            dkv = torch.stack([dk0, dv0])
        # the stripes and their dK/dV go the other way round: after i
        # rotations this rank holds the stripes of rank me + i, those of
        # the forward's rotation S - i; then dK/dV take one hop home
        steps = set(_rotations(S))
        kv = torch.stack([k, v])
        for i in range(1, S):
            both = _rotate(torch.cat([kv, dkv]), -1)
            kv, dkv = both[:2], both[2:]
            if S - i not in steps:
                continue
            src = (me + i) % S
            if zigzag:
                kA, kB = _halves(kv[0])
                vA, vB = _halves(kv[1])
                dk_c, dv_c = list(_halves(dkv[0])), list(_halves(dkv[1]))
                g = full(qB, kA, vA, doB, lB, dB)
                dq[1] = dq[1] + g[0]
                dk_c[0], dv_c[0] = dk_c[0] + g[1], dv_c[0] + g[2]
                if src < me:
                    g = full(qA, kA, vA, doA, lA, dA)
                    dq[0] = dq[0] + g[0]
                    dk_c[0], dv_c[0] = dk_c[0] + g[1], dv_c[0] + g[2]
                else:
                    g = full(qB, kB, vB, doB, lB, dB)
                    dq[1] = dq[1] + g[0]
                    dk_c[1], dv_c[1] = dk_c[1] + g[1], dv_c[1] + g[2]
                dkv = torch.stack([torch.cat(dk_c, 2), torch.cat(dv_c, 2)])
            elif src < me:
                g = full(q, kv[0], kv[1], do, lse2, di)
                dq[0] = dq[0] + g[0]
                dkv = dkv + torch.stack([g[1], g[2]])
        if S > 1:
            dkv = _rotate(dkv, -1)
        return torch.cat(dq, 2), dkv[0], dkv[1], None, None


def stripe_order(L: int, S: int, zigzag: bool) -> Tuple[int, torch.Tensor]:
    """(padded length, positions in stripe order): rank d's stripes are
    positions ``order[d Ls : (d + 1) Ls]``."""
    stripes = 2 * S if zigzag else S
    Lp = -(-L // stripes) * stripes
    Lc = Lp // stripes
    seq = ([c for d in range(S) for c in (d, stripes - 1 - d)] if zigzag
           else list(range(S)))
    order = torch.cat([torch.arange(c * Lc, (c + 1) * Lc) for c in seq])
    return Lp, order


def ring_causal_attention(q: Tensor, k: Tensor, v: Tensor, sm_scale: float,
                          zigzag: bool = True) -> Tensor:
    """Causal attention of this rank's whole (B, H, L, D) q, k, v (its
    rows of the batch, equal on every ``seq`` rank) with L sharded over
    the current mesh's ``seq`` axis. Returns the (B, H, L, D) output in the
    inputs' dtype, equal on every ``seq`` rank."""
    S = mesh_lib.axis_size("seq")
    if S == 1:
        return fa.flash_causal_attention(q, k, v, sm_scale)
    if not math.isfinite(sm_scale):
        raise ValueError(f"sm_scale must be finite, got {sm_scale}")
    dtype, L = q.dtype, q.shape[2]
    Lp, order = stripe_order(L, S, zigzag)
    Ls = Lp // S
    me = mesh_lib.axis_index("seq")
    mine = order[me * Ls:(me + 1) * Ls].to(q.device)

    def local(t):
        t = mesh_lib.copy_to_axis(t, "seq").float()
        if Lp != L:
            t = torch.nn.functional.pad(t, (0, 0, 0, Lp - L))
        return t.index_select(2, mine)

    out = _Ring.apply(local(q), local(k), local(v), float(sm_scale), zigzag)
    out = mesh_lib.gather_from_axis(out, 2, "seq")
    out = out.index_select(2, torch.argsort(order).to(out.device))
    return out[:, :, :L].to(dtype)
