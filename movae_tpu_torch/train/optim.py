"""Optimizers and per-epoch LR schedules — port of
``movae_tpu/train/optim.py``.

sgd/adam/adamw/rmsprop with the JAX package's (torch-reference)
hyperparameter semantics: weight decay as L2-on-gradient except for AdamW,
``eps`` outside the square root, and optional global-norm clipping with
optax's ``clip_by_global_norm`` rule. Schedules are step-indexed functions
with the reference's per-epoch stepping baked in; a schedule takes a host
int (a float comes back) or the train state's device step counter (a
device tensor comes back, with no host synchronisation).

An update can be skipped on the device: :meth:`Optimizer.step` takes a
boolean ``ok`` tensor, and where it is False the parameters, the moments
and the optimizer's step counts stay as they were (sgd/adam/adamw through
the fused torch optimizers' ``found_inf``, rmsprop, which has no fused
form, through a masked update of its own) — the JAX package's
``jnp.where(ok, new, old)`` over the optimizer state.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Optional, Sequence, Union

import torch

Tensor = torch.Tensor
Schedule = Callable[[Union[int, Tensor]], Union[float, Tensor]]


def _epoch(step, spe: int):
    """The epoch index of ``step``: an int, or a float64 tensor for a
    device counter."""
    if torch.is_tensor(step):
        return torch.div(step, spe, rounding_mode="floor").double()
    return step // spe


def lr_schedule(
    base_lr: float,
    scheduler: Optional[str],
    epochs: int,
    steps_per_epoch: int,
    lr_min: float = 0.0,
    gamma: float = 0.1,
    milestones: Optional[Sequence[int]] = None,
) -> Schedule:
    """Return ``step -> lr`` with torch's per-epoch stepping; ``step`` is a
    host int (float lr) or a device counter (float64 tensor lr)."""
    spe = max(int(steps_per_epoch), 1)

    if scheduler is None or scheduler == "none":
        return lambda step: base_lr
    if scheduler == "cosine":
        def fn(step):
            e = _epoch(step, spe)
            if torch.is_tensor(e):
                t = e.clamp(max=epochs) / max(epochs, 1)
                return lr_min + (base_lr - lr_min) * 0.5 * (
                    1.0 + torch.cos(math.pi * t))
            t = min(e, epochs) / max(epochs, 1)
            return lr_min + (base_lr - lr_min) * 0.5 * (1.0 + math.cos(
                math.pi * t))
        return fn
    if scheduler == "multi_step":
        ms = sorted(milestones or [])

        def fn(step):
            epoch = _epoch(step, spe)
            if torch.is_tensor(epoch):
                passed = sum((epoch >= m).double() for m in ms)
            else:
                passed = sum(1 for m in ms if m <= epoch)
            return base_lr * gamma ** passed
        return fn
    if scheduler == "exponential":
        return lambda step: base_lr * gamma ** _epoch(step, spe)
    raise ValueError(f"Scheduler {scheduler} not supported")


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """An optimizer recipe (the counterpart of an optax chain): :meth:`init`
    builds the torch optimizer over the parameters (fused sgd/adam/adamw),
    :meth:`step` applies one update from the gradients already in
    ``.grad``."""

    name: str
    schedule: Union[float, Schedule]
    momentum: float = 0.9
    weight_decay: float = 0.0
    max_grad_norm: Optional[float] = None
    eps: float = 1e-8

    def lr(self, step: Union[int, Tensor]) -> Union[float, Tensor]:
        """The learning rate at ``step``: a float for a host int, a float64
        tensor for a device counter (unless the schedule is constant)."""
        if not callable(self.schedule):
            return float(self.schedule)
        lr = self.schedule(step)
        return lr if torch.is_tensor(lr) else float(lr)

    def init(self, params: List[torch.nn.Parameter]) -> torch.optim.Optimizer:
        lr, wd = float(self.lr(0)), self.weight_decay
        if self.name == "sgd":
            opt = torch.optim.SGD(params, lr=lr, momentum=self.momentum,
                                  weight_decay=wd, fused=True)
            if self.momentum:
                # zero buffers give the first step's buf = grad exactly
                # (dampening 0), and a skipped first step leaves them zero
                for p in params:
                    opt.state[p]["momentum_buffer"] = torch.zeros_like(p)
            return opt
        if self.name == "adam":
            return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999),
                                    eps=self.eps, weight_decay=wd,
                                    fused=True)
        if self.name == "adamw":
            return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999),
                                     eps=self.eps, weight_decay=wd,
                                     fused=True)
        # rmsprop: torch divides by (sqrt(nu) + eps), as the JAX package's
        # scale_by_rms(eps_in_sqrt=False)
        return torch.optim.RMSprop(params, lr=lr, alpha=0.99, eps=self.eps,
                                   weight_decay=wd)

    @torch.no_grad()
    def step(self, opt: torch.optim.Optimizer, step: Union[int, Tensor],
             ok: Optional[Tensor] = None) -> None:
        """One update at the learning rate of ``step`` (a host int, or the
        device step counter). ``ok``: a 0-dim bool tensor on the
        parameters' device; where False, nothing of the optimizer's state
        moves, decided on the device."""
        params = [p for g in opt.param_groups for p in g["params"]
                  if p.grad is not None]
        for p in params:
            # the fused update walks parameter and gradient element by
            # element: a gradient in another memory layout (a conv
            # weight's channels-last grad on the CPU) is made contiguous
            if not p.grad.is_contiguous():
                p.grad = p.grad.contiguous()
        if self.max_grad_norm is not None and params:
            # optax clip_by_global_norm: g * max / ||g|| when ||g|| >= max
            norm = torch.linalg.vector_norm(torch.stack(
                [torch.linalg.vector_norm(p.grad) for p in params]))
            scale = torch.where(norm < self.max_grad_norm,
                                torch.ones_like(norm),
                                self.max_grad_norm / norm)
            for p in params:
                p.grad.mul_(scale)
        lr = self.lr(step)
        if torch.is_tensor(lr) and params:
            # the fused kernels read a float32 lr on the parameters' device
            lr = lr.to(params[0].device, torch.float32)
        if self.name == "rmsprop":
            _rmsprop_step(opt, lr, ok)
            return
        for group in opt.param_groups:
            group["lr"] = lr
        # found_inf: 1.0 skips the fused update and takes its step back
        opt.found_inf = None if ok is None else (~ok).float()
        opt.step()


@torch.no_grad()
def _rmsprop_step(opt: torch.optim.Optimizer, lr: Union[float, Tensor],
                  ok: Optional[Tensor]) -> None:
    """torch's RMSprop update (alpha, eps outside the square root, L2
    weight decay; no momentum, not centered) on ``opt``'s state, kept
    where ``ok`` is False."""
    for group in opt.param_groups:
        alpha, eps, wd = group["alpha"], group["eps"], group["weight_decay"]
        for p in group["params"]:
            if p.grad is None:
                continue
            st = opt.state[p]
            if not st:
                st["step"] = torch.zeros((), device=p.device)
                st["square_avg"] = torch.zeros_like(p)
            g = p.grad if not wd else p.grad.add(p, alpha=wd)
            sq = st["square_avg"].mul(alpha).addcmul_(g, g, value=1 - alpha)
            new = p - lr * (g / sq.sqrt().add_(eps))
            if ok is None:
                p.copy_(new)
                st["square_avg"].copy_(sq)
                st["step"] += 1
            else:
                p.copy_(torch.where(ok, new, p))
                st["square_avg"].copy_(torch.where(ok, sq, st["square_avg"]))
                st["step"] += ok.to(st["step"].dtype)


def build_optimizer(
    name: str,
    schedule: Union[float, Schedule],
    momentum: float = 0.9,
    weight_decay: float = 0.0,
    max_grad_norm: Optional[float] = None,
    eps: float = 1e-8,
) -> Optimizer:
    """Optimizer recipe matching the reference dispatch. ``eps`` is the
    adaptive-denominator epsilon; parity tests raise it to 1e-4 on both
    sides (at 1e-8 a gradient below float32 cross-framework noise takes a
    full +-lr step)."""
    name = name.lower()
    if name not in ("sgd", "adam", "adamw", "rmsprop"):
        raise ValueError(f"Optimizer {name} not supported")
    return Optimizer(name, schedule, momentum, weight_decay, max_grad_norm,
                     eps)
