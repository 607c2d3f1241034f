"""Input-pipeline throughput benchmark —
``python -m movae_tpu_torch.benchmark_workers``.

The counterpart of the repo's ``benchmark_workers.py``, over the port's
host loader (``movae_tpu_torch/data``) and its native batch assembly
(``data/native.py``): with no ``--workers`` it sweeps the batch size; with
``--workers`` it sweeps the assembly's worker threads at one batch size (0
= hardware concurrency), the reference DataLoader's ``num_workers``. Each
cell runs ``--warmup`` batches, then ``--num_runs`` timed runs of
``--num_batches`` batches, and reports mean +/- std seconds a batch and
images/s. The loader runs on the host; ``--device`` is accepted and
resolved as the port's other entry points do (``cuda`` by default).

Usage:
  python -m movae_tpu_torch.benchmark_workers --dataset synthetic-32 \\
      --batch_sizes 64 128 256
  python -m movae_tpu_torch.benchmark_workers --dataset synthetic-32 \\
      --batch_size 256 --workers 1 2 4 0
"""

from __future__ import annotations

import argparse
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np

from movae_tpu_torch.data import Loader, get_dataset
from movae_tpu_torch.device import resolve_device

Row = Tuple[int, float, float, float]  # (cell, s/batch, std, images/s)


def benchmark(dataset_name: str, data_dir: str, batch_sizes, num_batches: int,
              num_runs: int, normalize: bool, shuffle: bool = True,
              warmup: int = 2, workers=None) -> List[Row]:
    """One row per batch size (``workers`` None or empty) or per worker
    count at ``batch_sizes[0]``."""
    from movae_tpu_torch.data import native

    train_ds, _, input_size = get_dataset(dataset_name, data_dir,
                                          normalize=normalize)
    print(f"dataset={dataset_name} n={len(train_ds)} input_size={input_size}")
    if workers:
        if not native.available():
            print("native batch assembly unavailable; worker sweep reflects "
                  "the single-threaded numpy fallback")
        cells = [(batch_sizes[0], w) for w in workers]
    else:
        cells = [(bs, None) for bs in batch_sizes]
    results = []
    for bs, nw in cells:
        if nw is not None:
            native.set_num_threads(nw)
        loader = Loader(train_ds, bs, shuffle=shuffle, seed=0)
        if warmup > 0:
            for i, _ in enumerate(loader):
                if i + 1 >= warmup:
                    break
        times = []
        for _ in range(num_runs):
            t0 = time.perf_counter()
            n = 0
            for _batch in loader:
                n += 1
                if n >= num_batches:
                    break
            times.append((time.perf_counter() - t0) / max(n, 1))
        mean, std = float(np.mean(times)), float(np.std(times))
        results.append((bs if nw is None else nw, mean, std, bs / mean))
    if workers:
        native.set_num_threads(0)  # back to the hardware default
    return results


def print_results(results: Sequence[Row], axis: str = "batch") -> None:
    base = results[0][3]
    print(f"\n{axis:>8} {'s/batch':>12} {'std':>10} {'img/s':>12} "
          f"{'speedup':>8}")
    for cell, mean, std, ips in results:
        print(f"{cell:>8} {mean:>12.6f} {std:>10.6f} {ips:>12.1f} "
              f"{ips / base:>8.2f}x")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--dataset", type=str, default="synthetic-32")
    p.add_argument("--data_dir", type=str, default="./data")
    # the reference's spellings: --batch_size, --runs, --warmup, --workers;
    # --no_pin_memory is a no-op (the loader feeds host arrays)
    p.add_argument("--batch_size", type=int, default=None,
                   help="bench a single batch size (reference spelling)")
    p.add_argument("--runs", type=int, default=None, dest="runs")
    p.add_argument("--warmup", type=int, default=2)
    p.add_argument("--workers", type=int, nargs="*", default=None,
                   help="sweep native assembly worker-thread counts at a "
                        "fixed batch size (0 = hardware concurrency)")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    p.add_argument("--no_pin_memory", action="store_true", help="(ignored)")
    p.add_argument("--no_shuffle", action="store_true")
    p.add_argument("--batch_sizes", type=int, nargs="+",
                   default=[32, 64, 128, 256])
    p.add_argument("--num_batches", type=int, default=20)
    p.add_argument("--num_runs", type=int, default=3)
    p.add_argument("--normalize_inputs", action="store_true")
    return p


def main(argv: Optional[Sequence[str]] = None) -> List[Row]:
    a = build_parser().parse_args(argv)
    resolve_device(a.device)
    sizes = [a.batch_size] if a.batch_size else a.batch_sizes
    results = benchmark(a.dataset, a.data_dir, sizes, a.num_batches,
                        a.runs if a.runs else a.num_runs, a.normalize_inputs,
                        shuffle=not a.no_shuffle, warmup=a.warmup,
                        workers=a.workers)
    print_results(results, axis="workers" if a.workers else "batch")
    return results


if __name__ == "__main__":
    main()
