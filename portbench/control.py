"""Readings of a cell's control, planted faults and witnesses, for setting
its limits.

    python3 portbench/control.py --workload <cell> --mode <mode> --seeds <n> [<n> ...]
        [--chunk <rows>] [--weight_scale <leaf>=<factor> ...]

Each seed prints one JSON line of the cell's numbers, read as a run reads
them, of one side against the reference (float32, TF32 off). ``--mode``:

* ``program``: the program's checked steps, as a run takes them (no
  window): the program's readings over many seeds in one process;
* ``fp32``: the reference against itself (its attention kernel's
  backward is not deterministic on the card);
* ``fp32_math``, ``fp64``, ``bf16``: witnesses (``reference/precision.py``);
* ``tf32``, ``fp8``, ``int8``: controls, the reference computed one
  precision below the configuration's in the program's place;
* ``half_batch``: the reference in the program's place, each step on the
  first half of its batch, the mean taken over it.

``--chunk`` sets the reference's rows a pass (the plain-matmul attention
of ``fp64`` needs fewer); ``--weight_scale`` replaces the cell's
``weight_scale`` (``none`` clears it). The benchmark's own runs never run
this.
"""

import argparse
import contextlib
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

MODES = ("program", "fp32", "fp32_math", "fp64", "bf16", "tf32", "fp8",
         "int8", "half_batch")


def readings(cell_name: str, mode: str, seed: int, cell=None, cfg=None,
             device: str = "cuda") -> dict:
    import importlib

    import torch

    from portbench import harness, judge
    from portbench.drivers.common import release

    cell = cell if cell is not None else harness.workload(cell_name)
    cfg = cfg if cfg is not None else harness.config(cell["config"])
    dev = torch.device(device)
    driver = importlib.import_module(f"portbench.drivers.{cell['entry']}")
    weights, data = driver.inputs(cfg, seed, dev, cell)
    if mode == "program":
        side, held = driver.program(cfg, cell, seed, weights, data, dev)
        del held
        release(dev)
    else:
        half = mode == "half_batch"
        side = driver.reference(cfg, cell, weights, data, seed, dev,
                                "fp32" if half else mode, half)
    ref = driver.reference(cfg, cell, weights, data, seed, dev)
    return judge.readings(side, ref, weights)


def main(argv=None) -> int:
    from portbench import harness

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--mode", required=True, choices=MODES)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--chunk", type=int)
    ap.add_argument("--weight_scale", nargs="+")
    a = ap.parse_args(argv)
    cell = harness.workload(a.workload)
    if a.chunk:
        cell["reference_chunk"] = a.chunk
    if a.weight_scale:
        cell["weight_scale"] = {
            k: float(v) for k, v in (x.split("=") for x in a.weight_scale
                                     if x != "none")}
    out = sys.stdout
    for seed in a.seeds:
        # what the program prints goes to standard error
        with contextlib.redirect_stdout(sys.stderr):
            r = readings(a.workload, a.mode, seed, cell)
        print(json.dumps({"workload": a.workload, "mode": a.mode,
                          "seed": seed,
                          "weight_scale": cell.get("weight_scale", {}),
                          "readings": r}), file=out, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
