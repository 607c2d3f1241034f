"""Train state — port of ``movae_tpu/train/state.py``.

The JAX state is one immutable pytree; here the model and the torch
optimizer own their tensors and a step updates them in place (no second
copy of the parameters or the Adam moments is kept). The step counter is
a 0-dim int64 tensor on the parameters' device that counts *applied*
updates, as optax's count does under the JAX package's non-finite guard:
the learning rate and COMFORT's beta are computed from it on the device,
so a step that is skipped there moves neither, with no host
synchronisation.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch

from movae_tpu_torch.models.base import MOVAEModel
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

    @property
    def params(self) -> List[torch.nn.Parameter]:
        """Trainable parameters, in the optimizer's order."""
        return [p for g in self.optimizer.param_groups for p in g["params"]]

    @property
    def batch_stats(self) -> Dict[str, torch.Tensor]:
        return self.model.batch_stats()

    def apply_gradients(self, grads: List[torch.Tensor],
                        ok: Optional[torch.Tensor] = None) -> None:
        """One optimizer update from ``grads`` (aligned with ``params``);
        where the 0-dim bool ``ok`` is False, the parameters, the
        optimizer's state and the step counter stay as they were."""
        for p, g in zip(self.params, grads):
            p.grad = g
        self.tx.step(self.optimizer, self.step, ok)
        for p in self.params:
            p.grad = None
        with torch.no_grad():
            self.step += 1 if ok is None else ok.long()

    @classmethod
    def create(cls, model: MOVAEModel, tx: Optimizer,
               agg_state: Dict[str, torch.Tensor]) -> "TrainState":
        params = [p for p in model.parameters() if p.requires_grad]
        step = torch.zeros((), dtype=torch.int64, device=params[0].device)
        return cls(model=model, tx=tx, optimizer=tx.init(params),
                   agg_state=agg_state, step=step)
