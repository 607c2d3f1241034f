"""Train state — port of ``movae_tpu/train/state.py``.

The JAX state is one immutable pytree; here the model and the torch
optimizer own their tensors and a step updates them in place (no second
copy of the parameters or the Adam moments is kept).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

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
    step: int = 0

    @property
    def params(self) -> List[torch.nn.Parameter]:
        """Trainable parameters, in the optimizer's order."""
        return [p for g in self.optimizer.param_groups for p in g["params"]]

    @property
    def batch_stats(self) -> Dict[str, torch.Tensor]:
        return self.model.batch_stats()

    def apply_gradients(self, grads: List[torch.Tensor]) -> None:
        """One optimizer update from ``grads`` (aligned with ``params``)."""
        for p, g in zip(self.params, grads):
            p.grad = g
        self.tx.step(self.optimizer, self.step)
        for p in self.params:
            p.grad = None
        self.step += 1

    @classmethod
    def create(cls, model: MOVAEModel, tx: Optimizer,
               agg_state: Dict[str, torch.Tensor]) -> "TrainState":
        params = [p for p in model.parameters() if p.requires_grad]
        return cls(model=model, tx=tx, optimizer=tx.init(params),
                   agg_state=agg_state)
