"""The device timeline of a traced stretch, and what the per-layer metrics
read from it.

:func:`capture` runs a stretch under ``torch.profiler`` (host and CUDA
activity), writes the Chrome trace to a temporary file, reads it back and
deletes it. :class:`Trace` reduces the events: device operations
(kernels, copies, sets) with their launches' correlation ids, the host's
runtime launches, and the ``record_function`` ranges the harness opened.
Times are seconds.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import math
import os
import re
import tempfile
import time
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "python_function")


class Trace:
    def __init__(self, events: Sequence[dict], window_s: float):
        self.window_s = window_s
        self.device: List[Tuple[float, float, str, Optional[int]]] = []
        self.launch_ts: Dict[int, Tuple[float, int]] = {}
        host: List[Tuple[float, float, str, int]] = []
        for e in events:
            if e.get("ph") != "X":
                continue
            cat, ts, dur = e.get("cat", ""), float(e["ts"]), float(
                e.get("dur", 0.0))
            corr = (e.get("args") or {}).get("correlation")
            if cat in DEVICE_CATS:
                self.device.append((ts, ts + dur, e.get("name", ""), corr))
            elif cat in ("cuda_runtime", "cuda_driver") and corr is not None:
                self.launch_ts[corr] = (ts, e.get("tid", 0))
            elif cat in HOST_CATS:
                host.append((ts, ts + dur, e.get("name", ""),
                             e.get("tid", 0)))
        self.device.sort()
        host.sort()
        self._host = host
        self._host_starts = [h[0] for h in host]

    # --- device time ---------------------------------------------------
    def _merged(self) -> List[Tuple[float, float]]:
        out: List[List[float]] = []
        for s, e, _, _ in self.device:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    def busy_seconds(self, start: Optional[float] = None,
                     end: Optional[float] = None) -> float:
        """Seconds in which any operation ran on the device, within
        [start, end] (trace microseconds) where given."""
        lo = -math.inf if start is None else start
        hi = math.inf if end is None else end
        return sum(max(0.0, min(e, hi) - max(s, lo))
                   for s, e in self._merged()) / 1e6

    def step_ends(self, name: str) -> List[float]:
        """For each host range called ``name`` (the optimizer steps that
        :class:`StepMarks` marks), in order, the end of the last device
        operation launched inside it: where that step's work ends."""
        ranges = sorted((s, e, tid) for s, e, n, tid in self._host
                        if n == name)
        ends = [-math.inf] * len(ranges)
        starts = [r[0] for r in ranges]
        for _, e, _, corr in self.device:
            at = self.launch_ts.get(corr)
            if at is None:
                continue
            i = bisect.bisect_right(starts, at[0]) - 1
            if i >= 0 and ranges[i][2] == at[1] and at[0] <= ranges[i][1]:
                ends[i] = max(ends[i], e)
        return [e for e in ends if e > -math.inf]

    def steady(self, name: str) -> Optional[Tuple[float, float, int]]:
        """(start, end, steps) of the stretch from the end of the first
        marked step's work to the end of the last's: whole steps of the
        steady loop, without what a call does before its first step or
        after its last. None where fewer than two steps are marked."""
        ends = self.step_ends(name)
        if len(ends) < 2:
            return None
        return ends[0], ends[-1], len(ends) - 1

    def device_seconds(self, patterns: Iterable[str]) -> float:
        """Summed time of the device operations whose name matches any of
        the regular expressions."""
        rx = [re.compile(p) for p in patterns]
        return sum(e - s for s, e, n, _ in self.device
                   if any(r.search(n) for r in rx)) / 1e6

    def range_seconds(self, names: Iterable[str]) -> float:
        """Summed time of the device operations launched inside a host
        range named in ``names`` (a harness range or a host operator such
        as ``aten::convolution_backward``) on the launching thread."""
        names = set(names)
        spans: Dict[int, List[List[float]]] = {}
        for s, e, n, tid in self._host:
            if n not in names:
                continue
            merged = spans.setdefault(tid, [])
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        starts = {tid: [m[0] for m in ms] for tid, ms in spans.items()}
        total = 0.0
        for s, e, _, corr in self.device:
            at = self.launch_ts.get(corr)
            if at is None or at[1] not in spans:
                continue
            ms = spans[at[1]]
            i = bisect.bisect_right(starts[at[1]], at[0]) - 1
            if i >= 0 and ms[i][0] <= at[0] <= ms[i][1]:
                total += e - s
        return total / 1e6

    # --- breakdown -----------------------------------------------------
    def top_ops(self, n: int = 10) -> List[List]:
        by: Dict[str, float] = {}
        for s, e, name, _ in self.device:
            by[name] = by.get(name, 0.0) + (e - s) / 1e6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
                [:n]]

    def _host_at(self, ts: float, tid: int) -> str:
        """The innermost host range around ``ts`` on thread ``tid``, under
        the outermost harness range, if any."""
        i = bisect.bisect_right(self._host_starts, ts)
        inner, outer = None, None
        for s, e, name, t in reversed(self._host[max(0, i - 4000):i]):
            if s <= ts <= e and t == tid:
                if inner is None:
                    inner = name
                if name.startswith("portbench."):
                    outer = name
        label = inner or "no host range"
        return label if outer is None or outer == inner else \
            f"{outer}/{label}"

    def idle_gaps(self, n: int = 10, scan: int = 400) -> List[List]:
        """Idle seconds between device operations, summed by what the host
        was doing when it launched the operation that ended each gap: the
        ``scan`` longest gaps, the ``n`` largest sums."""
        merged = self._merged()
        starts = [d[0] for d in self.device]
        gaps = []
        for (s0, e0), (s1, _) in zip(merged, merged[1:]):
            if s1 > e0:
                gaps.append((s1 - e0, s1))
        gaps.sort(reverse=True)
        by: Dict[str, float] = {}
        for length, s1 in gaps[:scan]:
            j = bisect.bisect_left(starts, s1)
            corr = self.device[j][3] if j < len(self.device) else None
            at = self.launch_ts.get(corr)
            label = (self._host_at(at[0], at[1]) if at is not None
                     else "unattributed")
            by[label] = by.get(label, 0.0) + length / 1e6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
                [:n]]


STEP_RANGE = "portbench.optimizer_step"


@contextlib.contextmanager
def step_marks():
    """While open, every torch optimizer step runs inside a host range
    named :data:`STEP_RANGE` (global pre- and post-step hooks), so that a
    trace shows where each training step's update was launched."""
    from torch.optim.optimizer import (register_optimizer_step_post_hook,
                                       register_optimizer_step_pre_hook)
    open_ranges = []

    def pre(opt, args, kwargs):
        rf = torch.profiler.record_function(STEP_RANGE)
        rf.__enter__()
        open_ranges.append(rf)

    def post(opt, args, kwargs):
        if open_ranges:
            open_ranges.pop().__exit__(None, None, None)

    handles = [register_optimizer_step_pre_hook(pre),
               register_optimizer_step_post_hook(post)]
    try:
        yield
    finally:
        for h in handles:
            h.remove()


def capture(fn: Callable[[], None], device: torch.device) -> Trace:
    """Run ``fn`` (which ends by synchronising) under the profiler, its
    optimizer steps marked (:func:`step_marks`); the window is its host
    wall time."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize(device)
    with step_marks(), torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(device)
        window = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return Trace(events, window)
