"""Base model contract — port of ``movae_tpu/models/base.py``.

Every model follows the same contract as the JAX zoo:

  * ``objective_names``: ordered tuple of component-loss names; the dict from
    :meth:`loss_terms` has exactly these keys (weighted by
    ``lambda_weights``); ``total_loss`` is their sum.
  * ``feature_names``: names of the forward outputs at which the shared
    trunk ends, or ``None`` to force full-parameter Jacobians.
  * ``trunk(x, train)`` -> (features tuple, aux).
  * ``heads(features, aux, x, train, generator, restart_rows)`` -> outputs
    dict, differentiable w.r.t. both the features and the head parameters.
  * ``forward(x, train)`` = heads(trunk(x)).

Images are NHWC at this interface. ``train`` is an explicit argument as in
the JAX package (not ``nn.Module.train()``), and randomness comes from an
explicit ``torch.Generator``. ``restart_rows`` maps an EMA codebook's module
name to the (K,) latent rows its dead-code restart reads, in place of a draw
from ``generator`` (so a test can give both frameworks the same rows).
"""

from __future__ import annotations

from typing import (Any, Callable, Dict, Mapping, Optional, Sequence, Tuple,
                    Union)

import torch
from torch import nn

Tensor = torch.Tensor
RestartRows = Optional[Mapping[str, Tensor]]
LambdaWeights = Tuple[Tuple[str, float], ...]


def resolve_lambda_weights(
    objective_names: Sequence[str],
    lambda_weights: Union[None, Sequence[float], Mapping[str, float],
                          LambdaWeights],
    defaults: Mapping[str, float],
) -> LambdaWeights:
    """Validate/normalize lambda weights to an ordered tuple of items.

    A list must have one weight per objective (in objective order); a dict
    must have exactly the objective keys.
    """
    names = tuple(objective_names)
    if lambda_weights is None:
        return tuple((k, float(defaults[k])) for k in names)
    if isinstance(lambda_weights, Mapping):
        expected, provided = set(names), set(lambda_weights.keys())
        if expected != provided:
            missing, extra = expected - provided, provided - expected
            msg = "lambda_weights keys must match objectives keys. "
            if missing:
                msg += f"Missing: {missing}. "
            if extra:
                msg += f"Extra: {extra}."
            raise ValueError(msg)
        return tuple((k, float(lambda_weights[k])) for k in names)
    seq = tuple(lambda_weights)
    if seq and isinstance(seq[0], tuple):  # already items
        return resolve_lambda_weights(names, dict(seq), defaults)
    if len(seq) != len(names):
        raise ValueError(
            f"model requires {len(names)} lambda_weights {names}, "
            f"got {len(seq)}")
    return tuple((k, float(w)) for k, w in zip(names, seq))


def resolve_activation(name: Optional[str]) -> Callable[[Tensor], Tensor]:
    """Decoder output activation by name."""
    name = (name or "none").lower()
    if name == "tanh":
        return torch.tanh
    if name == "sigmoid":
        return torch.sigmoid
    if name == "none":
        return lambda x: x
    raise ValueError(f"recons_activation {name} not supported")


class MOVAEModel(nn.Module):
    """Abstract base (see module docstring for the contract)."""

    lambda_weights: LambdaWeights = ()

    @property
    def objective_names(self) -> Tuple[str, ...]:
        raise NotImplementedError

    @property
    def feature_names(self) -> Optional[Tuple[str, ...]]:
        raise NotImplementedError

    def trunk(self, x: Tensor, train: bool = False
              ) -> Tuple[Tuple[Tensor, ...], Any]:
        raise NotImplementedError

    def heads(self, features, aux, x: Tensor, train: bool = False,
              generator: Optional[torch.Generator] = None,
              restart_rows: RestartRows = None) -> Dict[str, Any]:
        raise NotImplementedError

    def forward(self, x: Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None,
                restart_rows: RestartRows = None) -> Dict[str, Any]:
        features, aux = self.trunk(x, train=train)
        return self.heads(features, aux, x, train=train, generator=generator,
                          restart_rows=restart_rows)

    def loss_terms(self, x: Tensor, outputs: Dict[str, Any]
                   ) -> Dict[str, Tensor]:
        raise NotImplementedError

    def _with_total(self, x: Tensor, outputs: Dict[str, Any]):
        loss_dict = dict(self.loss_terms(x, outputs))
        loss_vec = torch.stack([loss_dict[k] for k in self.objective_names])
        loss_dict["total_loss"] = loss_vec.sum()
        return loss_vec, loss_dict, outputs

    def forward_with_losses(self, x: Tensor, train: bool = False,
                            generator: Optional[torch.Generator] = None,
                            restart_rows: RestartRows = None):
        """One-shot forward + weighted component losses: returns
        ``(loss_vec, loss_dict, outputs)``; ``loss_dict`` carries
        ``total_loss`` (the sum of ``loss_vec``) as well."""
        return self._with_total(x, self(x, train=train, generator=generator,
                                         restart_rows=restart_rows))

    def heads_with_losses(self, features, aux, x: Tensor, train: bool = False,
                          generator: Optional[torch.Generator] = None,
                          restart_rows: RestartRows = None):
        """Heads + losses, differentiable w.r.t. ``features``."""
        return self._with_total(
            x, self.heads(features, aux, x, train=train, generator=generator,
                          restart_rows=restart_rows))

    def sample(self, num_samples: int,
               generator: Optional[torch.Generator] = None) -> Tensor:
        raise NotImplementedError

    # --- state updated in-step without gradients (flax ``batch_stats``) -----
    def batch_stats(self) -> Dict[str, Tensor]:
        """Buffers and frozen parameters, keyed like ``state_dict()``."""
        stats = dict(self.named_buffers())
        stats.update((n, p) for n, p in self.named_parameters()
                     if not p.requires_grad)
        return stats

    @torch.no_grad()
    def commit_batch_stats(self, updates: Mapping[str, Tensor]) -> None:
        """Write a step's new statistics (``outputs["batch_stats"]``) in
        place."""
        stats = self.batch_stats()
        for name, value in updates.items():
            stats[name].copy_(value)
