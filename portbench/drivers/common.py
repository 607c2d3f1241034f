"""What the drivers share: the optimizer tap that reads the program's
first steps, the clock, memory and clean-up helpers."""

from __future__ import annotations

import contextlib
import functools
import gc
import importlib
import sys
import time
from typing import Any, Callable, Dict, Iterator, List, Optional

import torch

ADAM_BETA1 = 0.9


def mark(clock0: float, what: str) -> None:
    """Print to standard error how far set-up has come."""
    print(f"portbench: {time.perf_counter() - clock0:8.3f} s {what}",
          file=sys.stderr, flush=True)


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def now() -> float:
    return time.perf_counter()


def reset_peak(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def peak_bytes(dev: torch.device) -> int:
    return int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" \
        else 0


def release(dev: torch.device) -> None:
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


@contextlib.contextmanager
def recording(entry: str, keep: Callable[[Any], Any], limit: int
              ) -> Iterator[List[Any]]:
    """While open, the program's ``module:function`` ``entry`` replaced by
    itself that also keeps ``keep(result)`` of its first ``limit`` calls,
    in order, in the list it yields. The program reaches the function as
    a module attribute, so it calls the replacement."""
    mod_name, attr = entry.split(":")
    mod = importlib.import_module(mod_name)
    fn = getattr(mod, attr)
    kept: List[Any] = []

    @functools.wraps(fn)
    def inner(*a, **kw):
        out = fn(*a, **kw)
        if len(kept) < limit:
            kept.append(keep(out))
        return out

    setattr(mod, attr, inner)
    try:
        yield kept
    finally:
        setattr(mod, attr, fn)


def steady_timeline(tr) -> Dict[str, float]:
    """``busy_s`` and ``window_s`` of a traced call's steady stretch (its
    whole steps after the first: :meth:`Trace.steady`), and its
    ``steady_steps``; the whole traced window where under two steps are
    marked (``steady_steps`` 0)."""
    from portbench.trace import STEP_RANGE

    st = tr.steady(STEP_RANGE)
    if st is None:
        return {"busy_s": tr.busy_seconds(), "window_s": tr.window_s,
                "steady_steps": 0}
    start, end, n = st
    return {"busy_s": tr.busy_seconds(start, end),
            "window_s": (end - start) / 1e6, "steady_steps": n}


class OptimizerTap:
    """While open, a global post-step hook on every torch optimizer: after
    the first step it copies the Adam first moments (the first gradient
    as the optimizer took it is exp_avg / (1 - beta1)). The copies are
    queued on the device like any other work, so they read the step's
    results. :meth:`read` gives the program's side of the comparison: a
    leaf whose first moment the optimizer never wrote reads zero."""

    def __init__(self, module: torch.nn.Module):
        self.module = module
        self.names = {id(p): n for n, p in module.named_parameters()}
        self.steps = 0
        self.grad1: Dict[str, torch.Tensor] = {}
        self._handle = None

    def _hook(self, opt, args, kwargs) -> None:
        self.steps += 1
        if self.steps == 1:
            self.grad1 = {self.names[id(p)]:
                          opt.state[p]["exp_avg"].detach().clone()
                          / (1.0 - ADAM_BETA1)
                          for g in opt.param_groups for p in g["params"]
                          if "exp_avg" in opt.state[p]}

    def read(self, losses: List[float]) -> Dict:
        """{"losses", "grad1", "params"}: the parameters as they stand
        (read right after the checked steps, before any other step)."""
        params = {n: p.detach().clone()
                  for n, p in self.module.named_parameters()}
        grad1 = {n: self.grad1.get(n, torch.zeros_like(p))
                 for n, p in params.items()}
        return {"losses": list(losses), "grad1": grad1, "params": params}

    def __enter__(self):
        from torch.optim.optimizer import register_optimizer_step_post_hook
        self._handle = register_optimizer_step_post_hook(self._hook)
        return self

    def __exit__(self, *exc) -> None:
        self._handle.remove()


class StepLog:
    """A logger for the program's metric pump: keeps every step's row."""

    active = True

    def __init__(self):
        self.rows: List[Dict[str, float]] = []

    def log(self, row: Dict[str, float], step: Optional[int] = None) -> None:
        self.rows.append(dict(row))
