"""Train state — port of ``movae_tpu/train/state.py``.

The JAX state is one immutable pytree; here the model and the torch
optimizer own their tensors and a step updates them in place (no second
copy of the parameters or the Adam moments is kept). The step counter is
a 0-dim int64 tensor on the parameters' device that counts *applied*
updates, as optax's count does under the JAX package's non-finite guard:
the learning rate and COMFORT's beta are computed from it on the device,
so a step that is skipped there moves neither, with no host
synchronisation. Under ``--fsdp`` the optimizer holds this rank's slices
of the large leaves (``parallel/fsdp.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch

from movae_tpu_torch.models.base import MOVAEModel
from movae_tpu_torch.parallel.fsdp import ShardedParams
from movae_tpu_torch.train.optim import Optimizer


@dataclasses.dataclass
class TrainState:
    """Model (parameters and batch statistics), optimizer state, step
    counter and aggregator state."""

    model: MOVAEModel
    tx: Optimizer
    optimizer: torch.optim.Optimizer
    agg_state: Dict[str, torch.Tensor]
    step: torch.Tensor
    fsdp: Optional[ShardedParams] = None

    @property
    def params(self) -> List[torch.nn.Parameter]:
        """Trainable parameters, in the optimizer's order (under ``fsdp``
        this rank's slices)."""
        return [p for g in self.optimizer.param_groups for p in g["params"]]

    @property
    def grad_params(self) -> List[torch.nn.Parameter]:
        """The model's trainable parameters, whole, in the optimizer's
        order: what the step differentiates (``params`` but under
        ``fsdp``, where they are whole only between ``fsdp.gather`` and
        ``fsdp.release``)."""
        return self.params if self.fsdp is None else self.fsdp.params

    @property
    def batch_stats(self) -> Dict[str, torch.Tensor]:
        return self.model.batch_stats()

    def apply_gradients(self, grads: List[torch.Tensor],
                        ok: Optional[torch.Tensor] = None) -> None:
        """One optimizer update from ``grads`` (aligned with ``params``);
        where the 0-dim bool ``ok`` is False, the parameters, the
        optimizer's state and the step counter stay as they were."""
        tx = self.tx
        if self.fsdp is not None and tx.max_grad_norm is not None:
            # the global norm sums the slices' squares over the ranks
            grads = self.fsdp.clip_by_global_norm(grads, tx.max_grad_norm)
            tx = dataclasses.replace(tx, max_grad_norm=None)
        for p, g in zip(self.params, grads):
            p.grad = g
        tx.step(self.optimizer, self.step, ok)
        for p in self.params:
            p.grad = None
        with torch.no_grad():
            self.step += 1 if ok is None else ok.long()

    @classmethod
    def create(cls, model: MOVAEModel, tx: Optimizer,
               agg_state: Dict[str, torch.Tensor],
               fsdp: Optional[ShardedParams] = None) -> "TrainState":
        """The state of ``model`` under ``tx``; with ``fsdp`` (a
        ``DataParallel.shard_params(model)``) the optimizer runs over this
        rank's slices."""
        params = ([p for p in model.parameters() if p.requires_grad]
                  if fsdp is None else fsdp.shards)
        step = torch.zeros((), dtype=torch.int64, device=params[0].device)
        return cls(model=model, tx=tx, optimizer=tx.init(params),
                   agg_state=agg_state, step=step, fsdp=fsdp)
