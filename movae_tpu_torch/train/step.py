"""The train step — port of ``movae_tpu/train/step.py``.

``make_train_step(model, agg_cfg, ...)`` returns ``train_step(state, batch,
generator, restart_rows, agg_draws, noise) -> (state, metrics)``: forward,
the multi-objective Jacobian, Gramian and aggregator solve, gradient
combination and the optimizer update. ``generator`` draws the EMA
codebooks' dead-code restarts, the VAE family's N(0, I) noise and the
aggregator's random choices; ``restart_rows`` and ``noise``
(``movae_tpu_torch/models/base.py``) and ``agg_draws`` (``use_pairwise``,
``perms``: ``movae_tpu_torch/moo/aggregators.py:compute_weights``) give
them instead.
The aggregation mode follows the reference dispatch:

  * aggregator ``sum``     -> plain backward of ``total_loss``;
  * ``feature_names`` set  -> torchjd ``mtl_backward`` semantics (feature
    Jacobian + trunk pullback);
  * ``feature_names`` None -> torchjd ``backward`` (full-parameter Jacobian).

The step updates ``state`` in place and returns it. Metrics are 0-dim
tensors on the model's device. The non-finite guard runs on the device:
the step makes no host synchronisation of its own (a host-solved
aggregator makes its one copy of G). ``grad_accum > 1`` gives the
accumulating step over an (A, B, ...) stack of microbatches,
:func:`make_scanned_train_step` runs k steps over a (k, B, ...) stack, and
``remat`` recomputes the forward in the backward
(``torch.utils.checkpoint``). ``make_eval_step`` gives the eval losses and
the codebook used-masks without gradients.

With ``parallel`` (a ``parallel/mesh.py:DataParallel``) each rank's step
takes its own rows of the global batch and computes what one device
computes on the whole batch: the gradients' mean over the ranks (one
all-reduce of the combined gradient in the sum and feature modes; in full
mode the Jacobian rows are all-reduced before the Gramian, so G, the
weights and the update are equal on every rank), the losses' means, the
codebook usage over the global batch, and a non-finite guard agreed
across ranks. Where the state's holder splits leaves (``--fsdp``,
``--model_partitions``: ``parallel/holder.py``) they are gathered before
the step and their gradients cut to this rank's slices after it.
"""

from __future__ import annotations

from typing import (Any, Callable, Dict, Iterable, Iterator, List,
                    Optional, Sequence)

import torch
from torch.utils.checkpoint import checkpoint

from movae_tpu_torch.models.base import Noise, RestartRows
from movae_tpu_torch.moo import aggregators as agg_lib
from movae_tpu_torch.moo import engine
from movae_tpu_torch.ops.vq import used_codes_mask
from movae_tpu_torch.parallel import mesh as mesh_lib
from movae_tpu_torch.train.state import TrainState

Tensor = torch.Tensor
Draws = Optional[Sequence[Optional[Dict[str, Any]]]]


def preprocess_batch(x: Tensor, normalize: bool) -> Tensor:
    """uint8 batches are cast to float32 in [0, 1], or [-1, 1] with
    ``normalize``; float batches pass through untouched."""
    if x.dtype == torch.uint8:
        x = x.float() * ((1.0 / 127.5) if normalize else (1.0 / 255.0))
        if normalize:
            x = x - 1.0
    return x


def _codebook_usage(outputs: Dict[str, Any], num_embeddings: int
                    ) -> Optional[Tensor]:
    """Per-batch codebook usage %, from the encoding indices (single, or
    hierarchical ``encoding_inds_top``/``_bottom``)."""
    def pct(inds):
        used = global_used_mask(used_codes_mask(inds, num_embeddings))
        return used.float().sum() / num_embeddings * 100.0

    if outputs.get("encoding_inds") is not None:
        return pct(outputs["encoding_inds"])
    if (outputs.get("encoding_inds_top") is not None
            and outputs.get("encoding_inds_bottom") is not None):
        return 0.5 * (pct(outputs["encoding_inds_top"])
                      + pct(outputs["encoding_inds_bottom"]))
    return None


def global_used_mask(used: Tensor) -> Tensor:
    """A codebook used-mask over the global batch under an active
    data-parallel config (the union over ranks), else ``used``."""
    if mesh_lib.active_data_parallel() is None:
        return used
    return mesh_lib.all_reduce_(used.to(torch.int32), "max",
                                axis="data").bool()


def _reduce_grads(state: TrainState, grads: List[Tensor],
                  reduced: bool) -> List[Tensor]:
    """The gradients the optimizer takes: under data parallelism the mean
    over the data ranks (``reduced``: already that mean, equal on every
    rank), cut to this rank's slices where the holder splits a leaf."""
    if mesh_lib.active_data_parallel() is not None:
        if not reduced:
            grads = engine.all_reduce_mean(grads)
        # the seq and pipe ranks run this stage whole on the same rows,
        # each rounding its own way on the card: the mean keeps their
        # replicas equal
        for axis in ("seq", "pipe"):
            grads = engine.all_reduce_mean(grads, axis)
    return state.holder.slice_grads(grads)


def _reduce_metrics(metrics: Dict[str, Tensor], names: Sequence[str]
                    ) -> None:
    """The losses' means over the ranks, in place (the weights, the
    similarity and the usage are already global)."""
    if mesh_lib.active_data_parallel() is None:
        return
    keys = [*names, "total_loss"]
    for k, v in zip(keys, engine.all_reduce_mean(
            [metrics[k].float() for k in keys])):
        metrics[k] = v


def _agree(ok: Tensor) -> Tensor:
    """``ok`` on every rank only where it holds on every rank (a
    tensor-parallel rank's gradients are its own slices)."""
    if mesh_lib.active_data_parallel() is None:
        return ok
    return mesh_lib.all_reduce_((~ok).to(torch.int32), "max",
                                axis=None) == 0


def _remat(fn: Callable, generator: Optional[torch.Generator]) -> Callable:
    """``fn`` under ``torch.utils.checkpoint`` (non-reentrant): its
    activations are recomputed in the backward, the JAX package's
    ``jax.checkpoint``. The recompute must repeat the forward exactly, so
    the explicit ``generator`` (VAE noise, EMA restart rows, dropout) is set
    back to its state at the forward's start for the recompute and
    returned to where it was after it (checkpoint's ``preserve_rng_state``
    covers only the global generators); pending statistics the recompute
    writes land in a dict of its own, which is dropped."""
    def call(*args):
        start = None if generator is None else generator.get_state()
        done = []

        def run(*a):
            if not done or generator is None:
                done.append(True)
                return fn(*a)
            now = generator.get_state()
            generator.set_state(start)
            try:
                return fn(*a)
            finally:
                generator.set_state(now)

        return checkpoint(run, *args, use_reentrant=False)
    return call


def _where(ok: Tensor, new: Tensor, old: Tensor) -> Tensor:
    """``new`` where ``ok``, else ``old`` (which may still sit on the CPU
    where its initial value was made: NashMTL's first weights); a new
    state tensor that lives on another device than ``ok`` (NashMTL's CPU
    step count) reads ``ok`` on the host."""
    if new.device != ok.device:
        return new if bool(ok) else old
    return torch.where(ok, new, old.to(new.device))


def _all_finite(loss: Tensor, grads: Sequence[Tensor]) -> Tensor:
    """A 0-dim bool tensor: ``loss`` and every gradient element finite (the
    max-norm of a tensor is NaN or inf exactly when an element is)."""
    norms = torch._foreach_norm(list(grads), float("inf")) if grads else []
    return torch.isfinite(torch.stack([loss.detach().float(),
                                       *[n.float() for n in norms]])).all()


def _nth(draws: Draws, i: int):
    """The i-th microbatch's (or inner step's) given draws, or None."""
    return None if draws is None else draws[i]


def optimizer_steps(n_full: int, n_batches: int, accum_k: int = 1) -> int:
    """Optimizer updates an epoch of ``n_batches`` batches, ``n_full`` of
    them full, makes (the lr schedule's and COMFORT's cadence; the JAX
    package's ``opt_steps_per_epoch``): under ``grad_accum`` the full
    batches in groups of ``accum_k``, a group's leftovers and the ragged
    tail as single updates (:func:`accum_groups`)."""
    groups, left = divmod(n_full, accum_k) if accum_k > 1 else (n_full, 0)
    return max(1, groups + left + n_batches - n_full)


def accum_groups(batches: Iterable, accum_k: int,
                 is_full: Callable[[Any], bool]) -> Iterator[list]:
    """``batches`` as the updates :func:`optimizer_steps` counts: each run
    of ``accum_k`` full batches as one list (one accumulated update), every
    other batch alone — a ragged one, and a group's leftovers before it or
    at the end (the JAX loop's ``run_accum_buf``)."""
    group: list = []
    for b in batches:
        if accum_k > 1 and is_full(b):
            group.append(b)
            if len(group) == accum_k:
                yield group
                group = []
            continue
        yield from ([one] for one in group)
        group = []
        yield [b]
    yield from ([one] for one in group)


def accumulate(acc: List[Tensor], grads: Sequence[Optional[Tensor]],
               inv: float) -> None:
    """``acc += inv * g`` in float32, the JAX package's ``acc + g / A``; a
    None gradient adds nothing."""
    pairs = [(a, g) for a, g in zip(acc, grads) if g is not None]
    torch._foreach_add_([a for a, _ in pairs], [g.float() for _, g in pairs],
                        alpha=inv)


def make_train_step(
    model,
    agg_cfg: agg_lib.AggregatorConfig,
    total_epochs: int = 1,
    steps_per_epoch: int = 1,
    normalize_inputs: bool = False,
    guard_nonfinite: bool = True,
    remat: bool = False,
    grad_accum: int = 1,
    parallel=None,
):
    """Build the train step for ``model`` under ``agg_cfg`` (data-parallel
    over ``parallel``'s ranks where given: see the module docstring).

    With ``guard_nonfinite`` a non-finite loss or gradient leaves every part
    of the state untouched — parameters, optimizer moments and step counts,
    the step counter (so the learning rate and COMFORT's beta), batch
    statistics (BatchNorm running statistics, EMA codebooks, anneal
    counters) and aggregator state — decided on the device by masked
    updates (``metrics["skipped_nonfinite"]`` says so), with no host
    synchronisation.

    ``remat`` recomputes in the backward what the JAX package's ``--remat``
    recomputes: the whole ``forward_with_losses`` in the sum and full
    modes, the trunk alone in feature mode.

    ``grad_accum > 1`` returns the ACCUMULATING step ``train_step(state,
    batches, generator, restart_rows, agg_draws, noise)`` over an (A, B,
    ...) stack of A microbatches: each microbatch runs the whole
    multi-objective machinery (its own Gramian and alpha) at the
    parameters and step counter the update starts from, while the batch
    statistics and the aggregator state advance microbatch by microbatch;
    the gradients are accumulated as ``acc + g / A`` in float32 and ONE
    optimizer update is applied, on the guard's condition that every
    microbatch loss and the accumulated gradients are finite. Metrics are
    microbatch means. ``restart_rows``, ``agg_draws`` and ``noise`` are
    then sequences of A per-microbatch values (or None).
    """
    names = tuple(model.objective_names)
    m = len(names)
    if agg_cfg.is_sum:
        mode = "sum"
    elif model.feature_names is not None:
        mode = "feature"
    else:
        mode = "full"
    num_embeddings = getattr(model, "num_embeddings", 0)

    def compute_grads(state: TrainState, x: Tensor, agg_state,
                      generator, restart_rows, agg_draws, noise):
        """One (micro)batch: forward, per-objective gradients and the
        aggregation. Returns ``(grads, batch_stats updates, new agg_state,
        metrics)`` without touching the optimizer; under data parallelism
        the gradients are this rank's part (full mode: already the mean
        over ranks) and the losses local."""
        params = state.grad_params
        device = params[0].device

        def forward(xx):
            return state.model.forward_with_losses(
                xx, train=True, generator=generator,
                restart_rows=restart_rows, noise=noise)

        if remat and mode != "feature":
            forward = _remat(forward, generator)

        if mode == "sum":
            _, loss_dict, outputs = forward(x)
            grads = engine.grads_or_zeros(loss_dict["total_loss"], params)
            alpha = torch.ones(m, dtype=torch.float32, device=device)
            similarity = torch.ones((), dtype=torch.float32, device=device)
            new_agg_state = agg_state
        else:
            beta = agg_lib.comfort_beta(
                agg_cfg, state.step // steps_per_epoch + 1, total_epochs)
            if mode == "full":
                def loss_tuple_fn():
                    _, ld, out = forward(x)
                    return tuple(ld[k] for k in names), (ld, out)

                loss_vec, (loss_dict, outputs), J, G = engine.full_jacobian(
                    loss_tuple_fn, params, m)
                alpha, new_agg_state = agg_lib.compute_weights(
                    agg_cfg, G, loss_vec, agg_state, beta,
                    generator=generator, **(agg_draws or {}))
                grads = engine.combine(J, alpha)
            else:  # feature mode
                def trunk(xx):
                    return state.model.trunk(xx, train=True)

                if remat:
                    trunk = _remat(trunk, generator)

                def heads_fn(features, t_aux):
                    _, ld, out = state.model.heads_with_losses(
                        features, t_aux, x, train=True, generator=generator,
                        restart_rows=restart_rows, noise=noise)
                    return tuple(ld[k] for k in names), (ld, out)

                fj = engine.FeatureJacobian(lambda: trunk(x), heads_fn,
                                            params, m)
                loss_dict, outputs = fj.heads_aux
                G = fj.G
                alpha, new_agg_state = agg_lib.compute_weights(
                    agg_cfg, G, fj.losses, agg_state, beta,
                    generator=generator, **(agg_draws or {}))
                grads = fj.grads(alpha)
            similarity = agg_lib.gradient_similarity(G, alpha)

        metrics = {k: loss_dict[k].detach() for k in names}
        metrics["total_loss"] = loss_dict["total_loss"].detach()
        for i in range(m):
            metrics[f"task_{i}_weight"] = alpha[i]
        metrics["gradient_similarity"] = similarity
        usage = _codebook_usage(outputs, num_embeddings)
        if usage is not None:
            metrics["codebook_usage_percentage"] = usage
        return grads, outputs.get("batch_stats") or {}, new_agg_state, \
            metrics

    def finish(state: TrainState, grads, new_agg_state, metrics,
               ok: Optional[Tensor], commit: Callable[[Optional[Tensor]],
                                                      None]):
        """ONE optimizer update from (possibly accumulated) grads, the
        batch statistics (``commit(ok)``) and aggregator state, all masked
        by ``ok`` on the device."""
        if guard_nonfinite:
            metrics["skipped_nonfinite"] = 1.0 - ok.float()
        else:
            ok = None
        state.apply_gradients(grads, ok)
        commit(ok)
        if ok is None:
            state.agg_state = new_agg_state
        else:
            state.agg_state = {k: _where(ok, v, state.agg_state[k])
                               if k in state.agg_state else v
                               for k, v in new_agg_state.items()}
        return state, metrics

    def prepare(state: TrainState, batch: Tensor) -> Tensor:
        device = state.params[0].device
        return preprocess_batch(batch.to(device, non_blocking=True),
                                normalize_inputs)

    # full mode's combined gradient is already the mean over the ranks
    reduced = mode == "full"

    def parallel_step(fn: Callable) -> Callable:
        """``fn`` with ``parallel`` active and the leaves its holder
        splits gathered for it and released after."""
        if parallel is None:
            return fn

        def run(state: TrainState, *a, **kw):
            with parallel.activate():
                state.holder.gather()
                try:
                    return fn(state, *a, **kw)
                finally:
                    state.holder.release()
        return run

    if grad_accum <= 1:
        def train_step(state: TrainState, batch: Tensor,
                       generator: Optional[torch.Generator] = None,
                       restart_rows: RestartRows = None,
                       agg_draws: Optional[Dict[str, Tensor]] = None,
                       noise: Noise = None):
            x = prepare(state, batch)
            grads, stats, new_agg, metrics = compute_grads(
                state, x, state.agg_state, generator, restart_rows,
                agg_draws, noise)
            grads = _reduce_grads(state, grads, reduced)
            _reduce_metrics(metrics, names)
            ok = _agree(_all_finite(metrics["total_loss"], grads))
            return finish(state, grads, new_agg, metrics, ok,
                          lambda k: state.model.commit_batch_stats(stats, k)
                          if stats else None)

        return parallel_step(train_step)

    inv = 1.0 / grad_accum

    def accum_step(state: TrainState, batches: Tensor,
                   generator: Optional[torch.Generator] = None,
                   restart_rows: Draws = None, agg_draws: Draws = None,
                   noise: Draws = None):
        """A microbatches -> averaged grads -> one update (see
        :func:`make_train_step`)."""
        if batches.shape[0] != grad_accum:
            raise ValueError(f"the accumulating step takes {grad_accum} "
                             f"microbatches, got {batches.shape[0]}")
        model = state.model
        # the statistics advance microbatch by microbatch through the
        # model's own buffers; the update's starting values come back
        # where the guard says no
        saved = {k: v.detach().clone() for k, v in model.batch_stats().items()}
        agg_c = state.agg_state
        acc: List[Tensor] = [torch.zeros_like(p) for p in state.grad_params]
        losses, mets = [], []
        for i in range(grad_accum):
            x = prepare(state, batches[i])
            grads, stats, agg_c, met = compute_grads(
                state, x, agg_c, generator, _nth(restart_rows, i),
                _nth(agg_draws, i), _nth(noise, i))
            accumulate(acc, grads, inv)
            if stats:
                model.commit_batch_stats(stats)
            losses.append(met["total_loss"])
            mets.append(met)
        metrics = {k: torch.stack([mt[k] for mt in mets]).mean(0)
                   for k in mets[0]}
        acc = _reduce_grads(state, acc, reduced)
        _reduce_metrics(metrics, names)
        loss_sum = torch.stack(losses).sum()
        if mesh_lib.active_data_parallel() is not None:
            loss_sum = engine.all_reduce_mean([loss_sum])[0]
        ok = _agree(_all_finite(loss_sum, acc))

        def commit(k: Optional[Tensor]) -> None:
            if k is not None:
                model.commit_batch_stats(
                    {n: torch.where(k, v, saved[n])
                     for n, v in model.batch_stats().items()})

        return finish(state, acc, agg_c, metrics, ok, commit)

    return parallel_step(accum_step)


def make_scanned_train_step(step_fn: Callable, k: int) -> Callable:
    """``k`` train steps in one call over a (k, B, ...) stack of batches —
    the JAX package's ``make_scanned_train_step`` (``lax.scan``). Each inner
    step takes its own batch (and its own ``restart_rows``, ``agg_draws``
    and ``noise``, sequences of k values where given) and the numbers are
    those of k single steps. Returns ``(state, metrics)`` with every metric
    stacked along a leading (k,) axis, in execution order. The steps are
    queued back to back with no host synchronisation between them."""
    def scanned(state: TrainState, batches: Tensor,
                generator: Optional[torch.Generator] = None,
                restart_rows: Draws = None, agg_draws: Draws = None,
                noise: Draws = None):
        if batches.shape[0] != k:
            raise ValueError(f"the scanned step takes {k} batches, got "
                             f"{batches.shape[0]}")
        mets = []
        for i in range(k):
            state, met = step_fn(state, batches[i], generator,
                                 _nth(restart_rows, i), _nth(agg_draws, i),
                                 _nth(noise, i))
            mets.append(met)
        return state, {key: torch.stack([torch.as_tensor(mt[key])
                                         for mt in mets])
                       for key in mets[0]}

    return scanned


def make_eval_step(model, normalize_inputs: bool = False):
    """Eval step (the JAX package's ``make_eval_step``): ``eval_step(batch,
    generator=None) -> (metrics, extras, outputs)`` on the model's current
    weights, without gradients. ``metrics`` holds the weighted objectives
    and ``total_loss``; ``extras`` the codebook used-masks (``used_mask``,
    or ``used_mask_top``/``used_mask_bottom``) for exact usage across
    batches. Every value stays on the model's device."""
    names = tuple(model.objective_names)
    num_embeddings = getattr(model, "num_embeddings", 0)

    @torch.no_grad()
    def eval_step(batch, generator: Optional[torch.Generator] = None):
        device = next(model.parameters()).device
        x = preprocess_batch(torch.as_tensor(batch).to(device,
                                                       non_blocking=True),
                             normalize_inputs)
        _, loss_dict, outputs = model.forward_with_losses(
            x, train=False, generator=generator)
        metrics = {k: loss_dict[k] for k in names}
        metrics["total_loss"] = loss_dict["total_loss"]
        extras = {}
        if outputs.get("encoding_inds") is not None:
            extras["used_mask"] = used_codes_mask(outputs["encoding_inds"],
                                                  num_embeddings)
        if (outputs.get("encoding_inds_top") is not None
                and outputs.get("encoding_inds_bottom") is not None):
            for side in ("top", "bottom"):
                extras[f"used_mask_{side}"] = used_codes_mask(
                    outputs[f"encoding_inds_{side}"], num_embeddings)
        return metrics, extras, outputs

    return eval_step
