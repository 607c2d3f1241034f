"""What the per-layer metrics' readers share. A reader gets the driver's
``ctx`` (the trace of the traced stretch, its step count, the untraced
window's seconds a step, the sync count, launch counts and the work
counted from the shapes) and its own directory, whose data files it
reads: ``kernels*.txt`` (regular expressions of kernel names; every file
counts), ``wrap.txt`` (the host ranges the harness opened), ``ops.txt``
(host operators whose launches count), ``work.txt``
(the kernels whose work the roofline counts). A reader that finds nothing
returns None, and the metric is left out of the line."""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, List, Optional

from portbench.harness import lines
from portbench.work import bound_seconds

Ctx = Dict[str, Any]


def kernel_patterns(d: Path) -> List[str]:
    out: List[str] = []
    for f in sorted(d.glob("kernels*.txt")):
        out += [p for p in lines(f) if p not in out]
    return out


def kernel_ms_per_step(ctx: Ctx, d: Path) -> Optional[float]:
    s = ctx["trace"].device_seconds(kernel_patterns(d))
    return 1e3 * s / ctx["traced_steps"] if s > 0 else None


def range_ms_per_step(ctx: Ctx, d: Path) -> Optional[float]:
    """Device time launched inside the host ranges the metric names: the
    harness's ranges (``wrap.txt``) or host operators (``ops.txt``)."""
    names: List[str] = []
    for f in ("wrap.txt", "ops.txt"):
        if (d / f).exists():
            names += lines(d / f)
    s = ctx["trace"].range_seconds(names)
    return 1e3 * s / ctx["traced_steps"] if s > 0 else None


def roofline_pct(ctx: Ctx, d: Path) -> Optional[float]:
    """The least time of the kernels' launches in the traced stretch (each
    launch's work from the shapes, over the tensor-core peak of the
    configuration's operand type or HBM) over their summed device time."""
    spent = ctx["trace"].device_seconds(kernel_patterns(d))
    least = 0.0
    for kind in lines(d / "work.txt"):
        per_step = ctx["kernel_work"].get(kind)
        n = ctx["launches"].get(kind, 0)
        if not per_step or not n:
            continue
        least += n / len(per_step) * sum(bound_seconds(w, ctx["tensor_peak"])
                                         for w in per_step)
    if spent <= 0 or least <= 0:
        return None
    return 100.0 * least / spent


def idle_pct(ctx: Ctx, d: Path) -> Optional[float]:
    """The share of the traced call's steady stretch (its whole steps
    after the first, so not what the call does before its first step) in
    which the device runs nothing: one minus the device-busy time over the
    stretch's length, both from the one timeline. Unclamped: a busy time
    that the stretch cannot hold reads below 0 and shows."""
    if not ctx.get("steady_steps") or ctx["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["window_s"])


def mfu_pct(ctx: Ctx, d: Path) -> Optional[float]:
    """Model FLOPs a step over the untraced window's time a step, as a
    share of the tensor-core peak of the configuration's operand type."""
    return 100.0 * ctx["step_flops"] / ctx["step_s"] / ctx["tensor_peak"]


def syncs_per_step(ctx: Ctx, d: Path) -> Optional[float]:
    return float(ctx["syncs_per_step"])
