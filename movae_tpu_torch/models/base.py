"""Base model contract — port of ``movae_tpu/models/base.py``.

Every model follows the same contract as the JAX zoo:

  * ``objective_names``: ordered tuple of component-loss names; the dict from
    :meth:`loss_terms` has exactly these keys (weighted by
    ``lambda_weights``); ``total_loss`` is their sum.
  * ``feature_names``: names of the forward outputs at which the shared
    trunk ends, or ``None`` to force full-parameter Jacobians.
  * ``trunk(x, train)`` -> (features tuple, aux).
  * ``heads(features, aux, x, train, generator, restart_rows, noise)`` ->
    outputs dict, differentiable w.r.t. both the features and the head
    parameters.
  * ``forward(x, train)`` = heads(trunk(x)).

``compute_dtype`` (float32, or bfloat16 for ``--compute_dtype bfloat16``)
is the dtype of the conv and dense layers (:func:`compute_region`);
parameters stay float32, so ``state_dict()`` does not change.

Images are NHWC at this interface. ``train`` is an explicit argument as in
the JAX package (not ``nn.Module.train()``), and randomness comes from an
explicit ``torch.Generator``. ``restart_rows`` maps an EMA codebook's module
name to the (K,) latent rows its dead-code restart reads, in place of a draw
from ``generator`` (so a test can give both frameworks the same rows);
``noise`` does the same for every other draw, by name (the VAE family's
``eps``, ``z_prior``; ``sample``'s ``z`` or uniform ``codes``: :func:`draw`).
A :class:`DrawLog` passed as ``noise`` records the draws a call makes.
"""

from __future__ import annotations

import contextlib
from typing import (Any, Callable, Dict, Mapping, Optional, Sequence, Tuple,
                    Union)

import torch
from torch import nn

Tensor = torch.Tensor
RestartRows = Optional[Mapping[str, Tensor]]
Noise = Optional[Mapping[str, Tensor]]
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


def resolve_compute_dtype(dt) -> torch.dtype:
    """'float32' / 'bfloat16' (or a torch dtype) -> the torch dtype; the
    single resolver of ``--compute_dtype`` (the JAX package's
    ``resolve_compute_dtype``)."""
    if isinstance(dt, str):
        return {"float32": torch.float32, "bfloat16": torch.bfloat16}[dt]
    if dt not in (torch.float32, torch.bfloat16):
        raise ValueError(f"compute_dtype {dt!r}: float32 or bfloat16")
    return dt


def compute_region(dtype: torch.dtype, device: torch.device):
    """flax's ``dtype=`` on the conv and dense layers of a region: under
    bfloat16 every convolution and matmul inside computes in bf16 from its
    float32 parameters cast at use (``torch.autocast``), and the activations
    and residual sums between them stay bf16. The caller casts at the
    region's ends where the JAX package does (inputs to the dtype, outputs
    to float32); norms compute in float32 themselves. float32 changes
    nothing."""
    if dtype == torch.float32:
        return contextlib.nullcontext()
    return torch.autocast(device.type, dtype=dtype)


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


_DRAW_DTYPES = {"randn": torch.float32, "rand": torch.float32,
                "randint": torch.int64}


class DrawLog(dict):
    """A ``noise`` mapping that records the draws asked of it: a draw site
    (:func:`draw`) whose name it does not hold draws from ``generator``
    and appends ``{"name", "op", "shape", "high"}`` to ``log``, in call
    order (how serving learns the draws a function makes, which become
    inputs of its exported program)."""

    def __init__(self, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.generator = generator
        self.log: list = []


def draw(name: str, op: str, shape: Sequence[int],
         generator: Optional[torch.Generator], noise: Noise,
         device: torch.device, high: Optional[int] = None) -> Tensor:
    """``noise[name]`` when given (float32 for ``randn`` / ``rand``, int64
    for ``randint``), else one ``torch.<op>`` draw of ``shape`` from
    ``generator``: ``randn`` N(0, I), ``rand`` U[0, 1), ``randint``
    integers in [0, ``high``).

    Under an active data-parallel step (``parallel/mesh.py``) every draw a
    model makes is per row of the batch (the leading dimension, this
    rank's rows): the draw, or the given ``noise[name]``, is the global
    batch's, and this rank keeps its rows, so the step draws what one
    device draws on the whole batch."""
    from movae_tpu_torch.parallel import mesh as mesh_lib

    if (mesh_lib.active_data_parallel() is not None
            and mesh_lib.process_count() > 1):
        full = (mesh_lib.global_batch_size(shape[0]), *shape[1:])
        return mesh_lib.local_rows(
            _draw(name, op, full, generator, noise, device, high))
    return _draw(name, op, shape, generator, noise, device, high)


def _draw(name: str, op: str, shape: Sequence[int],
          generator: Optional[torch.Generator], noise: Noise,
          device: torch.device, high: Optional[int] = None) -> Tensor:
    shape = tuple(shape)
    if noise is not None and name in noise:
        value = torch.as_tensor(noise[name], dtype=_DRAW_DTYPES[op],
                                device=device)
        if tuple(value.shape) != shape:
            raise ValueError(f"noise[{name!r}] must be {shape}, got "
                             f"{tuple(value.shape)}")
        return value
    if isinstance(noise, DrawLog):
        noise.log.append({"name": name, "op": op,
                          "shape": [int(d) for d in shape], "high": high})
        generator = noise.generator
    if op == "randint":
        return torch.randint(0, high, shape, generator=generator,
                             device=device)
    return getattr(torch, op)(shape, generator=generator, device=device)


class MOVAEModel(nn.Module):
    """Abstract base (see module docstring for the contract)."""

    lambda_weights: LambdaWeights = ()
    compute_dtype: torch.dtype = torch.float32

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
              restart_rows: RestartRows = None,
              noise: Noise = None) -> Dict[str, Any]:
        raise NotImplementedError

    def forward(self, x: Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None,
                restart_rows: RestartRows = None,
                noise: Noise = None) -> Dict[str, Any]:
        features, aux = self.trunk(x, train=train)
        return self.heads(features, aux, x, train=train, generator=generator,
                          restart_rows=restart_rows, noise=noise)

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
                            restart_rows: RestartRows = None,
                            noise: Noise = None):
        """One-shot forward + weighted component losses: returns
        ``(loss_vec, loss_dict, outputs)``; ``loss_dict`` carries
        ``total_loss`` (the sum of ``loss_vec``) as well."""
        return self._with_total(x, self(x, train=train, generator=generator,
                                         restart_rows=restart_rows,
                                         noise=noise))

    def heads_with_losses(self, features, aux, x: Tensor, train: bool = False,
                          generator: Optional[torch.Generator] = None,
                          restart_rows: RestartRows = None,
                          noise: Noise = None):
        """Heads + losses, differentiable w.r.t. ``features``."""
        return self._with_total(
            x, self.heads(features, aux, x, train=train, generator=generator,
                          restart_rows=restart_rows, noise=noise))

    def sample(self, num_samples: int,
               generator: Optional[torch.Generator] = None,
               noise: Noise = None) -> Tensor:
        raise NotImplementedError

    # --- state updated in-step without gradients (flax ``batch_stats``) -----
    def batch_stats(self) -> Dict[str, Tensor]:
        """Buffers and frozen parameters, keyed like ``state_dict()``."""
        stats = dict(self.named_buffers())
        stats.update((n, p) for n, p in self.named_parameters()
                     if not p.requires_grad)
        return stats

    @torch.no_grad()
    def commit_batch_stats(self, updates: Mapping[str, Tensor],
                           ok: Optional[Tensor] = None) -> None:
        """Write a step's new statistics (``outputs["batch_stats"]``) in
        place; where the 0-dim bool ``ok`` is False each keeps its value
        (decided on the device)."""
        stats = self.batch_stats()
        for name, value in updates.items():
            old = stats[name]
            value = value.to(old.dtype)
            old.copy_(value if ok is None else torch.where(ok, value, old))
