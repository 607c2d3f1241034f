"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints one JSON object as the last line of
standard output (with ``--trace 0`` the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics and a breakdown) and, as the last lines
of standard error, each number compared beside its limit. Everything the
program prints goes to standard error. Exits non-zero, with no result,
when the cell's CUDA devices are missing or when JAX or the JAX package
is loaded once the window has closed.
"""

import time

CLOCK0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# build and kernel caches at fixed paths inside the checkout
CACHE = ROOT / "build" / "portbench_cache"
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ.setdefault("USE_FLAX", "0")
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)

    from portbench import harness

    out = sys.stdout
    with contextlib.redirect_stdout(sys.stderr):
        try:
            res = harness.run_cell(a.workload, a.seed, a.seconds,
                                   bool(a.trace), CLOCK0)
        except harness.NoCard as e:
            print(f"portbench: {e}", file=sys.stderr)
            return 2
        bad = harness.forbidden_modules()
        if bad:
            print(f"portbench: JAX or the JAX package is loaded: {bad}",
                  file=sys.stderr)
            return 3
    for k, c in res["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res), file=out, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
