"""One run of one cell: the cell, its configuration and its per-layer
metrics found by name, the cell's driver run, the per-layer readers fed,
and the result line put together.

A cell is ``workloads/<name>.json``; its configuration
``configs/<config>.json``; a per-layer metric ``metrics/<metric>/``
(``metric.json``, which names its reader in ``readers.py``, or a
``reader.py`` of its own, and the metric's data files); a driver
``drivers/<entry>.py``. Nothing here names a cell, a configuration or a
metric.
"""

from __future__ import annotations

import contextlib
import functools
import importlib
import importlib.util
import json
import subprocess
import sys
from pathlib import Path
from typing import Any, Callable, Dict, Iterator, List, Optional

import numpy as np

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "movae_tpu")


class NoCard(RuntimeError):
    pass


def load_json(*parts: str) -> dict:
    with open(HERE.joinpath(*parts)) as f:
        return json.load(f)


def workload(name: str) -> dict:
    return load_json("workloads", f"{name}.json")


def config(name: str) -> dict:
    return load_json("configs", f"{name}.json")


def metric_dirs() -> List[Path]:
    return sorted(p for p in (HERE / "metrics").iterdir()
                  if (p / "metric.json").exists())


def per_layer_for(cell: str) -> List[Path]:
    """The per-layer metrics whose ``workloads`` name ``cell``."""
    return [d for d in metric_dirs()
            if cell in json.loads((d / "metric.json").read_text())[
                "workloads"]]


def sub_seed(seed: int, tag: str) -> int:
    """A 32-bit seed for one use of the run's ``--seed``."""
    ss = np.random.SeedSequence([seed % (1 << 64),
                                 int.from_bytes(tag.encode(), "little")])
    return int(ss.generate_state(1, np.uint32)[0])


def lines(path: Path) -> List[str]:
    return [s.strip() for s in path.read_text().splitlines()
            if s.strip() and not s.lstrip().startswith("#")]


def wraps_for(dirs: List[Path]) -> List[str]:
    """``module:function`` entries that the cell's metrics ask to see as
    host ranges (each metric's ``wrap.txt``)."""
    out: List[str] = []
    for d in dirs:
        if (d / "wrap.txt").exists():
            out += [w for w in lines(d / "wrap.txt") if w not in out]
    return out


@contextlib.contextmanager
def wrapped(entries: List[str]) -> Iterator[None]:
    """Each ``module:function`` replaced, for the block, by itself inside
    a ``record_function`` range named by the entry."""
    import torch

    saved = []
    for entry in entries:
        mod_name, attr = entry.split(":")
        mod = importlib.import_module(mod_name)
        fn = getattr(mod, attr)

        def make(fn=fn, entry=entry):
            @functools.wraps(fn)
            def inner(*a, **kw):
                with torch.profiler.record_function(entry):
                    return fn(*a, **kw)
            return inner

        saved.append((mod, attr, fn))
        setattr(mod, attr, make())
    try:
        yield
    finally:
        for mod, attr, fn in reversed(saved):
            setattr(mod, attr, fn)


def read_metric(d: Path, ctx: Dict[str, Any]) -> Optional[float]:
    """The metric's reading: the function of ``readers.py`` that its
    ``metric.json`` names under ``reader``, or else the ``read`` of a
    ``reader.py`` of its own (how a metric that no function here reads
    comes in without an edit to ``readers.py``)."""
    spec = json.loads((d / "metric.json").read_text())
    if "reader" in spec:
        from portbench import readers
        return getattr(readers, spec["reader"])(ctx, d)
    mod_spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + d.name.replace(".", "_").replace("-", "_"),
        d / "reader.py")
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read(ctx, d)


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and \
        out.stdout.strip() else None


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             clock0: float, cell: Optional[dict] = None,
             cfg: Optional[dict] = None, device: Optional[str] = None,
             patch: Optional[Callable[[], contextlib.AbstractContextManager]]
             = None) -> Dict[str, Any]:
    """Run cell ``name`` once and return the contract's result object.
    ``cell``, ``cfg``, ``device`` and ``patch`` serve the tests, which
    drive a small copy of a cell on the CPU (``patch``: a context manager
    around the driver's run, where a test plants a fault)."""
    import torch

    cell = cell if cell is not None else workload(name)
    cfg = cfg if cfg is not None else config(cell["config"])
    if device is None:
        if (not torch.cuda.is_available()
                or torch.cuda.device_count() < int(cell["chips"])):
            raise NoCard(f"cell {name} needs {cell['chips']} CUDA device(s); "
                         f"torch sees {torch.cuda.device_count()}")
        device = "cuda"
    dev = torch.device(device)
    dirs = per_layer_for(name) if trace else []
    driver = importlib.import_module(f"portbench.drivers.{cell['entry']}")
    with (patch() if patch is not None else contextlib.nullcontext()):
        out = driver.run(cfg, cell, seed, seconds, trace, dev, clock0,
                         wraps_for(dirs))
    limits = cell["limits"]
    checks = {k: {"value": out["readings"][k]["value"], "limit": v}
              for k, v in limits.items()}
    from portbench.judge import verdict
    correct = verdict(out["readings"], limits) and out["failed"] == 0
    res: Dict[str, Any] = {"correct": correct,
                           "attempted": out["attempted"],
                           "failed": out["failed"]}
    if trace:
        ctx = dict(out["ctx"], cell=cell, config=cfg)
        metrics = {}
        for d in dirs:
            v = read_metric(d, ctx)
            if v is not None:
                unit = json.loads((d / "metric.json").read_text())["unit"]
                metrics[d.name] = {"value": v, "unit": unit}
        res["metrics"] = metrics
    else:
        res["metrics"] = {k: {"value": v, "unit": u}
                          for k, (v, u) in out["e2e"].items()}
    res["device"] = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                 else "cpu"),
        "count": 1, "memory_peak_bytes": out["memory_peak_bytes"]}
    if trace:
        res["device"].update(busy_s=out["ctx"]["busy_s"],
                             window_s=out["ctx"]["window_s"])
        res["breakdown"] = out["ctx"]["breakdown"]
        for name, secs in out["ctx"]["trace"].top_ops(40):
            print(f"device op {secs:.6f} s: {name[:160]}", file=sys.stderr)
    if dev.type == "cuda":
        res["device"]["power"] = power_limit()
    # every number read, compared or not, with what explains it
    res["diagnosis"] = out["readings"]
    # the numbers compared come last in the line
    res["checks"] = checks
    return res
