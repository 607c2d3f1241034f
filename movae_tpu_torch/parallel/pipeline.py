"""GPipe pipeline parallelism over the prior's blocks (``--pipeline_parallel
S``, ``--pipeline_microbatches M``) for all four prior types — port of
``movae_tpu/parallel/pipeline.py``.

The homogeneous block stack (PixelSNAIL's ``blocks.i``, PixelCNN's
``res_blocks.i``; the JAX package's ``block_i`` / ``res_i``) is split into
S stages over the ``pipe`` mesh axis: stage s holds blocks ``s N/S ..
(s + 1) N/S - 1`` and their optimizer moments. M microbatches of each
rank's rows flow through the stages, plain GPipe fill and drain over
``M + S - 1`` ticks; at every tick each stage posts its output to the next
stage and its next input from the previous one as one batch of
``isend``/``irecv`` pairs (``mesh.exchange``). The prologue (embedding,
position channels, the condition plane, ``conv_in``) runs on stage 0 and
the heads with the cross-entropy on stage S-1; both are replicated
parameters whose gradients are summed over ``pipe`` (only those two
stages make them). The backward runs per microbatch in reverse tick
order: each stage calls ``torch.autograd.backward`` on its stored outputs
with the gradient the next stage sent, and sends its inputs' gradient
back. The loss is the last stage's mean cross-entropy over the
microbatches (equal sizes: the mean of means), broadcast over ``pipe``;
the trainer averages it and the gradients over ``data``, as the JAX
package's ``pmean``. Each block can be recomputed in the backward
(``remat``, through ``train/step.py:_remat``). Dropout draws through
``models/base.py:draw`` per stage and microbatch, so with dropout > 0 the
streams differ from one device's (as in the JAX package, where they are
folded per stage and tick); at dropout 0 the numbers are one device's.

``stack_block_params`` / ``unstack_block_params`` (and the
``_prior_params`` pair for the hierarchical priors) move between the
reference ``state_dict`` layout of the checkpoints and the stacked layout
a stage holds and gathers (a leading block axis).
"""

from __future__ import annotations

import contextlib
import re
from typing import Any, Dict, List, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from movae_tpu_torch.models.base import compute_region
from movae_tpu_torch.parallel import mesh as mesh_lib
from movae_tpu_torch.parallel.holder import Holder

Tensor = torch.Tensor
BLOCKS_KEY = "blocks_stacked"


def block_prefix(prior) -> str:
    """The ``state_dict`` prefix of a pipelineable prior's block stack:
    ``blocks.`` for PixelSNAIL, ``res_blocks.`` for PixelCNN (the JAX
    package's ``block_`` and ``res_``)."""
    from movae_tpu_torch.models.pixelcnn import PixelSNAIL

    return "blocks." if isinstance(prior, PixelSNAIL) else "res_blocks."


def _split_block_key(key: str, prefix: str) -> Optional[Tuple[int, str]]:
    m = re.match(re.escape(prefix) + r"(\d+)\.(.+)$", key)
    return (int(m.group(1)), m.group(2)) if m else None


def stack_block_params(state: Mapping[str, Tensor],
                       prefix: str = "blocks.") -> Dict[str, Tensor]:
    """``{'<prefix>i.<leaf>': t_i}`` -> ``{'blocks_stacked.<leaf>': (N,
    ...) stack}``; other keys unchanged."""
    blocks: Dict[str, Dict[int, Tensor]] = {}
    out = {}
    for k, v in state.items():
        hit = _split_block_key(k, prefix)
        if hit is None:
            out[k] = v
        else:
            blocks.setdefault(hit[1], {})[hit[0]] = v
    for leaf, parts in blocks.items():
        out[f"{BLOCKS_KEY}.{leaf}"] = torch.stack(
            [parts[i] for i in sorted(parts)])
    return out


def unstack_block_params(state: Mapping[str, Tensor],
                         prefix: str = "blocks.") -> Dict[str, Tensor]:
    """Inverse of :func:`stack_block_params` (the checkpoint layout)."""
    out = {}
    for k, v in state.items():
        if k.startswith(BLOCKS_KEY + "."):
            leaf = k[len(BLOCKS_KEY) + 1:]
            for i in range(v.shape[0]):
                out[f"{prefix}{i}.{leaf}"] = v[i]
        else:
            out[k] = v
    return out


def _is_hierarchical(prior) -> bool:
    return hasattr(prior, "make_top_module")


def _levels(prior) -> List[Tuple[str, Any]]:
    """``(state_dict prefix, flat prior)`` of each pipelined stack."""
    if _is_hierarchical(prior):
        return [("prior_top.", prior.prior_top),
                ("prior_bottom.", prior.prior_bottom)]
    return [("", prior)]


def _map_levels(prior, state, fn) -> Dict[str, Tensor]:
    out = dict(state)
    for pre, flat in _levels(prior):
        if not pre:
            return fn(out, block_prefix(flat))
        sub = {k[len(pre):]: out.pop(k) for k in list(out)
               if k.startswith(pre)}
        out.update((pre + k, v) for k, v in fn(sub, block_prefix(flat))
                   .items())
    return out


def stack_prior_params(prior, state: Mapping[str, Tensor]
                       ) -> Dict[str, Tensor]:
    """Stack ``prior``'s block stack(s): the root's for a flat prior,
    ``prior_top.``'s and ``prior_bottom.``'s each for a hierarchical
    one."""
    return _map_levels(prior, state, stack_block_params)


def unstack_prior_params(prior, state: Mapping[str, Tensor]
                         ) -> Dict[str, Tensor]:
    """Inverse of :func:`stack_prior_params`."""
    return _map_levels(prior, state, unstack_block_params)


def default_microbatches(local_batch: int, num_stages: int) -> int:
    """Largest divisor of the per-data-shard batch that is <= 2*S (GPipe
    wants M >= S for utilization; beyond ~2S each microbatch's work gets
    too small)."""
    target = max(1, 2 * num_stages)
    for m in range(min(target, local_batch), 0, -1):
        if local_batch % m == 0:
            return m
    return 1


def check_composition(args) -> None:
    """The JAX package's refusal: pipeline parallelism composes with
    ``data`` only (``ValueError``)."""
    def n(flag):
        return int(getattr(args, flag, 1) or 1)

    if n("pipeline_parallel") > 1 and (n("model_partitions") > 1
                                       or n("context_parallel") > 1):
        raise ValueError("pipeline parallelism composes with 'data' only: "
                         "set model_partitions=1 and context_parallel=1")


def _stage_range(num_blocks: int) -> range:
    S, s = mesh_lib.axis_size("pipe"), mesh_lib.axis_index("pipe")
    n = num_blocks // S
    return range(s * n, (s + 1) * n)


class _Level:
    """One flat prior's stack pipelined over ``pipe`` (see the module
    docstring)."""

    def __init__(self, prior, num_microbatches: int, train: bool,
                 remat: bool):
        from movae_tpu_torch.models.pixelcnn import PixelCNN, PixelSNAIL

        if isinstance(prior, PixelSNAIL):
            self.blocks, self.residual = prior.blocks, True
        elif isinstance(prior, PixelCNN):
            self.blocks, self.residual = prior.res_blocks, False
        else:
            raise TypeError(f"pipeline parallelism supports PixelSNAIL/"
                            f"PixelCNN priors, got {type(prior).__name__}")
        self.S = mesh_lib.axis_size("pipe")
        if len(self.blocks) % self.S:
            raise ValueError(f"{len(self.blocks)} blocks must divide into "
                             f"pipeline stages ({self.S})")
        if (mesh_lib.axis_size("model") > 1
                or mesh_lib.axis_size("seq") > 1):
            raise ValueError("pipeline parallelism composes with 'data' "
                             "only: set model_partitions=1 and "
                             "context_parallel=1")
        self.prior = prior
        self.M = int(num_microbatches)
        self.train = train
        self.remat = remat
        self.s = mesh_lib.axis_index("pipe")
        self.local = _stage_range(len(self.blocks))
        # this stage's blocks, in block order
        self.stage_blocks = [self.blocks[i] for i in self.local]

    def local_params(self) -> List[torch.nn.Parameter]:
        return [p for b in self.stage_blocks for p in b.parameters()]

    def _stage(self, x: Tensor, generator) -> Tensor:
        for blk in self.stage_blocks:
            def one(h, blk=blk):
                if self.residual:
                    return h + blk(h, train=self.train, generator=generator)
                return blk(h)
            if self.remat and torch.is_grad_enabled():
                from movae_tpu_torch.train.step import _remat
                one = _remat(one, generator)
            x = one(x)
        return x

    def run(self, z: Tensor, generator=None,
            condition: Optional[Tensor] = None) -> Tensor:
        """Forward and backward of this rank's rows ``z``; returns the
        loss (this data rank's mean CE, equal on every stage). Gradients
        land in the stage's parameters' ``.grad``, the prologue's and the
        heads' summed over ``pipe`` by the caller."""
        prior, S, s, M = self.prior, self.S, self.s, self.M
        bl, hh, ww = z.shape
        if bl % M:
            raise ValueError(f"per-shard batch {bl} not divisible by "
                             f"num_microbatches={M}")
        mb = bl // M
        dev = z.device
        region = compute_region(prior.compute_dtype, dev)
        act_dtype = (torch.float32 if prior.compute_dtype == torch.float32
                     else prior.compute_dtype)
        shape = (mb, prior.hidden_channels, hh, ww)
        h = None
        if s == 0:
            with region:
                h = prior.conv_in(prior._input(z, prior._extra(z),
                                               condition))
            micro = list(h.split(mb))
        labels = z.long().split(mb)
        ins: Dict[int, Tensor] = {}
        outs: Dict[int, Tensor] = {}
        ces: Dict[int, Tensor] = {}
        nxt: Optional[Tensor] = None
        ticks = M + S - 1
        for t in range(ticks):
            j = t - s
            y = None
            if 0 <= j < M:
                x = micro[j] if s == 0 else nxt
                x = x.detach().requires_grad_(True)
                with region:
                    y = self._stage(x, generator)
                ins[j], outs[j] = x, y
                if s == S - 1:
                    with region:
                        logits = prior.conv_out(y)
                    logits = logits.to(torch.promote_types(logits.dtype,
                                                           torch.float32))
                    ces[j] = F.cross_entropy(logits, labels[j])
            sends = ([(y.detach(), s + 1)] if y is not None and s < S - 1
                     else [])
            recvs = []
            if s > 0 and 0 <= t + 1 - s < M:
                nxt = torch.empty(shape, dtype=act_dtype, device=dev)
                recvs = [(nxt, s - 1)]
            mesh_lib.exchange(sends, recvs, axis="pipe")
        dh = [None] * M
        dy: Optional[Tensor] = None
        for t in reversed(range(ticks)):
            j = t - s
            dx = None
            if 0 <= j < M:
                if s == S - 1:
                    torch.autograd.backward(ces[j] / M)
                else:
                    torch.autograd.backward(outs[j], dy)
                dx = ins[j].grad
                if s == 0:
                    dh[j] = dx
                del outs[j], ins[j]
            sends = ([(dx, s - 1)] if dx is not None and s > 0 else [])
            recvs = []
            if s < S - 1 and 0 <= t - 1 - s < M:
                dy = torch.empty(shape, dtype=act_dtype, device=dev)
                recvs = [(dy, s + 1)]
            mesh_lib.exchange(sends, recvs, axis="pipe")
        if s == 0:
            torch.autograd.backward(h, torch.cat(dh))
        loss = (torch.stack([ces[j].detach() for j in range(M)]).sum() / M
                if s == S - 1 else torch.zeros((), device=dev))
        return mesh_lib.all_reduce_(loss.float(), "sum", axis="pipe")


class PipelinedPrior(Holder):
    """A prior (any of the four types) trained with its block stack(s)
    pipelined over ``pipe``: :meth:`loss_and_grads` runs one (micro)batch
    forward and backward, ``params`` are the parameters this stage holds
    (the optimizer's: its blocks, the prologue, the heads and a
    hierarchical prior's conditioning path), ``split`` marks the block
    leaves (split over ``pipe``; the rest are replicated). Blocks another
    stage holds are freed (``release``); :meth:`whole` gathers them for a
    block, :meth:`finalize` for good. A ``parallel/holder.py:Holder``
    whose step needs nothing gathered."""

    def __init__(self, prior, num_microbatches: int, train: bool = True,
                 remat: bool = True):
        self.prior = prior
        self.levels = [(pre, _Level(flat, num_microbatches, train, remat))
                       for pre, flat in _levels(prior)]
        block_ids = set()
        local = set()
        for _, lv in self.levels:
            block_ids.update(id(p) for p in lv.blocks.parameters())
            local.update(id(p) for p in lv.local_params())
        self.params = [p for p in prior.parameters()
                       if id(p) not in block_ids or id(p) in local]
        self.shards = self.params
        self.split = [id(p) in block_ids for p in self.params]
        self.remote = [p for p in prior.parameters()
                       if id(p) in block_ids and id(p) not in local]
        self._shapes = {id(p): p.shape for p in self.remote}
        self.release()

    def loss_and_grads(self, codes: List[Tensor], generator=None,
                       condition: Optional[Tensor] = None
                       ) -> Tuple[Tensor, List[Tensor]]:
        """``codes``: ``[z]`` or ``[z_top, z_bottom]`` (this rank's rows;
        ``condition`` a flat prior's NHWC plane). Returns (this data rank's
        loss, the gradients of ``params``), the replicated ones summed
        over ``pipe``."""
        for p in self.params:
            p.grad = None
        if len(self.levels) == 1:
            loss = self.levels[0][1].run(codes[0], generator, condition)
        else:
            prior = self.prior
            cond = None
            if mesh_lib.axis_index("pipe") == 0:
                cond = prior.condition_from_top(codes[0])
            lt = self.levels[0][1].run(codes[0], generator)
            lb = self.levels[1][1].run(codes[1], generator, condition=cond)
            loss = lt + lb
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in self.params]
        rep = [g for g, sp in zip(grads, self.split) if not sp]
        flat = torch.cat([g.reshape(-1).float() for g in rep])
        mesh_lib.all_reduce_(flat, "sum", axis="pipe")
        i = 0
        for g in rep:
            g.copy_(flat[i:i + g.numel()].view(g.shape))
            i += g.numel()
        for p in self.params:
            p.grad = None
        return loss, grads

    # --- the whole prior ----------------------------------------------------
    @torch.no_grad()
    def _stacked_local(self) -> Dict[str, Tensor]:
        """This stage's blocks in the stacked layout (keys with their
        level's prefix)."""
        out = {}
        for pre, lv in self.levels:
            state = {}
            for i in lv.local:
                for k, v in lv.blocks[i].state_dict().items():
                    state[f"{block_prefix(lv.prior)}{i}.{k}"] = v
            out.update((pre + k, v) for k, v in
                       stack_block_params(state,
                                          block_prefix(lv.prior)).items())
        return out

    @torch.no_grad()
    def _gather_all(self) -> None:
        """Every stage's blocks into the prior's parameters (a collective
        over ``pipe``)."""
        for p in self.remote:
            p.data = torch.empty(self._shapes[id(p)], dtype=p.dtype,
                                 device=p.device)
        stacked = self._stacked_local()
        whole = {k: torch.cat(mesh_lib.all_gather(v, "pipe"))
                 for k, v in stacked.items()}
        state = self.prior.state_dict()
        for k, v in unstack_prior_params(self.prior, whole).items():
            state[k].copy_(v)

    def release(self) -> None:
        """Free the blocks another stage holds."""
        for p in self.remote:
            p.data = p.data.new_empty(0)

    @contextlib.contextmanager
    def whole(self, load: bool = False):
        """The whole prior for the block (figures, checkpoints; what a
        block loads lands in this stage's own blocks)."""
        self._gather_all()
        try:
            yield
        finally:
            self.release()

    def finalize(self) -> None:
        """The whole prior from here on (the stages after training)."""
        self._gather_all()
        self.remote = []

    def clip_axes(self) -> List[tuple]:
        return [("pipe",) if sp else () for sp in self.split]

    # --- optimizer state ----------------------------------------------------
    def full_optimizer_state(self, sd: dict) -> dict:
        """Every stage's optimizer state dict (a collective over ``pipe``),
        the JAX package's stacked payload: it resumes a run with the same
        number of stages."""
        sd = {"state": {i: {k: v.cpu() if torch.is_tensor(v) else v
                            for k, v in st.items()}
                        for i, st in sd["state"].items()},
              "param_groups": sd["param_groups"]}
        parts = mesh_lib.all_gather_object(sd, "pipe")
        return {"pipeline_stages": len(parts), "stages": parts}

    def local_optimizer_state(self, payload: dict) -> Optional[dict]:
        """This stage's optimizer state from :meth:`full_optimizer_state`'s
        payload; None (the moments start afresh) where the number of
        stages differs."""
        if (not isinstance(payload, dict) or payload.get("pipeline_stages")
                != mesh_lib.axis_size("pipe")):
            return None
        return payload["stages"][mesh_lib.axis_index("pipe")]


def make_pipelined_prior_loss(prior, num_microbatches: int,
                              train: bool = True, remat: bool = True):
    """``loss_fn(z, generator=None, condition=None) -> {"total_loss"}`` for
    a flat prior over the current mesh's ``pipe`` axis, forward and
    backward at once: the gradients land in ``.grad`` of this stage's
    parameters (``loss_fn.pipe.params``), the replicated ones summed over
    ``pipe``."""
    pipe = PipelinedPrior(prior, num_microbatches, train, remat)

    def loss_fn(z, generator=None, condition=None):
        if (condition is None) != (prior.conditional_channels == 0):
            raise ValueError("condition must be passed iff the prior has "
                             "conditional_channels")
        loss, grads = pipe.loss_and_grads([z], generator, condition)
        for p, g in zip(pipe.params, grads):
            p.grad = g
        return {"total_loss": loss}

    loss_fn.pipe = pipe
    return loss_fn


def make_pipelined_hierarchical_loss(prior, num_microbatches: int,
                                     train: bool = True,
                                     remat: bool = True):
    """``loss_fn(z_top, z_bottom, generator=None)`` for a hierarchical
    prior, as :func:`make_pipelined_prior_loss`: the top pipeline drains,
    then the bottom one fills; the conditioning path runs in stage 0's
    prologue."""
    pipe = PipelinedPrior(prior, num_microbatches, train, remat)

    def loss_fn(z_top, z_bottom, generator=None):
        loss, grads = pipe.loss_and_grads([z_top, z_bottom], generator)
        for p, g in zip(pipe.params, grads):
            p.grad = g
        return {"total_loss": loss}

    loss_fn.pipe = pipe
    return loss_fn
