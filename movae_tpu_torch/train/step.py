"""The train step — port of ``movae_tpu/train/step.py``.

``make_train_step(model, agg_cfg, ...)`` returns ``train_step(state, batch,
generator, restart_rows, agg_draws) -> (state, metrics)``: forward, the
multi-objective Jacobian, Gramian and aggregator solve, gradient combination
and the optimizer update. ``generator`` draws the EMA codebooks' dead-code
restarts and the aggregator's random choices; ``restart_rows``
(``movae_tpu_torch/models/base.py``) and ``agg_draws`` (``use_pairwise``,
``perms``: ``movae_tpu_torch/moo/aggregators.py:compute_weights``) give
them instead.
The aggregation mode follows the reference dispatch:

  * aggregator ``sum``     -> plain backward of ``total_loss``;
  * ``feature_names`` set  -> torchjd ``mtl_backward`` semantics (feature
    Jacobian + trunk pullback);
  * ``feature_names`` None -> torchjd ``backward`` (full-parameter Jacobian).

The step updates ``state`` in place and returns it. Metrics are 0-dim
tensors on the model's device. ``make_eval_step`` gives the eval losses
and the codebook used-masks without gradients.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from movae_tpu_torch.models.base import RestartRows
from movae_tpu_torch.moo import aggregators as agg_lib
from movae_tpu_torch.moo import engine
from movae_tpu_torch.ops.vq import used_codes_mask
from movae_tpu_torch.train.state import TrainState

Tensor = torch.Tensor


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
        used = used_codes_mask(inds, num_embeddings)
        return used.float().sum() / num_embeddings * 100.0

    if outputs.get("encoding_inds") is not None:
        return pct(outputs["encoding_inds"])
    if (outputs.get("encoding_inds_top") is not None
            and outputs.get("encoding_inds_bottom") is not None):
        return 0.5 * (pct(outputs["encoding_inds_top"])
                      + pct(outputs["encoding_inds_bottom"]))
    return None


def make_train_step(
    model,
    agg_cfg: agg_lib.AggregatorConfig,
    total_epochs: int = 1,
    steps_per_epoch: int = 1,
    normalize_inputs: bool = False,
    guard_nonfinite: bool = True,
    grad_accum: int = 1,
):
    """Build the train step for ``model`` under ``agg_cfg``.

    With ``guard_nonfinite`` a non-finite loss or gradient leaves every part
    of the state untouched — parameters, optimizer moments and step counts,
    the step counter, batch statistics and aggregator state: finiteness is
    checked (one host synchronisation) before ``optimizer.step()``, which is
    skipped on a bad step.
    """
    if grad_accum > 1:
        raise NotImplementedError(
            "grad_accum > 1 is not ported to movae_tpu_torch yet: ROADMAP.md "
            "Queue 1 item 6 (deferred from the first slice)")
    names = tuple(model.objective_names)
    m = len(names)
    if agg_cfg.is_sum:
        mode = "sum"
    elif model.feature_names is not None:
        mode = "feature"
    else:
        mode = "full"
    num_embeddings = getattr(model, "num_embeddings", 0)

    def train_step(state: TrainState, batch: Tensor,
                   generator: Optional[torch.Generator] = None,
                   restart_rows: RestartRows = None,
                   agg_draws: Optional[Dict[str, Tensor]] = None):
        params = state.params
        device = params[0].device
        x = preprocess_batch(batch.to(device, non_blocking=True),
                             normalize_inputs)

        if mode == "sum":
            _, loss_dict, outputs = state.model.forward_with_losses(
                x, train=True, generator=generator,
                restart_rows=restart_rows)
            grads = engine.grads_or_zeros(loss_dict["total_loss"], params)
            alpha = torch.ones(m, dtype=torch.float32, device=device)
            similarity = torch.ones((), dtype=torch.float32, device=device)
            new_agg_state = state.agg_state
        else:
            beta = agg_lib.comfort_beta(
                agg_cfg, state.step // steps_per_epoch + 1, total_epochs)
            if mode == "full":
                def loss_tuple_fn():
                    _, ld, out = state.model.forward_with_losses(
                        x, train=True, generator=generator,
                        restart_rows=restart_rows)
                    return tuple(ld[k] for k in names), (ld, out)

                loss_vec, (loss_dict, outputs), J, G = engine.full_jacobian(
                    loss_tuple_fn, params, m)
                alpha, new_agg_state = agg_lib.compute_weights(
                    agg_cfg, G, loss_vec, state.agg_state, beta,
                    generator=generator, **(agg_draws or {}))
                grads = engine.combine(J, alpha)
            else:  # feature mode
                def trunk_fn():
                    return state.model.trunk(x, train=True)

                def heads_fn(features, t_aux):
                    _, ld, out = state.model.heads_with_losses(
                        features, t_aux, x, train=True, generator=generator,
                        restart_rows=restart_rows)
                    return tuple(ld[k] for k in names), (ld, out)

                fj = engine.FeatureJacobian(trunk_fn, heads_fn, params, m)
                loss_dict, outputs = fj.heads_aux
                G = fj.G
                alpha, new_agg_state = agg_lib.compute_weights(
                    agg_cfg, G, fj.losses, state.agg_state, beta,
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

        ok = True
        if guard_nonfinite:
            finite = torch.stack([torch.isfinite(metrics["total_loss"])]
                                 + [torch.isfinite(g).all() for g in grads])
            ok = bool(finite.all())
            metrics["skipped_nonfinite"] = 1.0 - finite.all().float()
        if ok:
            state.apply_gradients(grads)
            if outputs.get("batch_stats"):
                state.model.commit_batch_stats(outputs["batch_stats"])
            state.agg_state = new_agg_state
        return state, metrics

    return train_step


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
