"""Interleaved A/B: the live model against its serving artifact —
``python -m movae_tpu_torch.serving_ab``.

The counterpart of the repo's ``scripts/serving_ab.py``: checks that the
``torch.export`` artifact (``movae_tpu_torch/serving.py``) pays no
throughput tax over the live model on ``reconstruct``. Both arms run the
same operators, so the expected result is parity; a gap means the export
lost or added work. Both arms interleave in ONE process, with a card
synchronisation at each rep and medians.

    python -m movae_tpu_torch.serving_ab [--batch_size 256]
        [--input_size 32] [--rounds 7] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import statistics
import tempfile
import time
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch


def interleaved(arms: Dict[str, Callable], x, rounds: int = 7,
                reps: int = 10) -> Dict[str, float]:
    """Each arm's median seconds per call of ``fn(x)``, the arms in turns
    within each round (the first call of each arm untimed), each call
    closed by a card synchronisation."""
    sync = (torch.cuda.synchronize if torch.cuda.is_available()
            else (lambda: None))
    for fn in arms.values():
        fn(x)
    times = {k: [] for k in arms}
    for _ in range(rounds):
        for k, fn in arms.items():
            for _ in range(reps):
                sync()
                t0 = time.perf_counter()
                fn(x)
                sync()
                times[k].append(time.perf_counter() - t0)
    return {k: statistics.median(v) for k, v in times.items()}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--batch_size", type=int, default=256)
    p.add_argument("--input_size", type=int, default=32)
    p.add_argument("--hidden_dims", type=int, nargs="+", default=[128, 256])
    p.add_argument("--rounds", type=int, default=7)
    p.add_argument("--reps_per_round", type=int, default=10)
    p.add_argument("--compute_dtype", default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from movae_tpu_torch.device import resolve_device
    from movae_tpu_torch.models import get_network, init_model
    from movae_tpu_torch.serving import export_serving, load_serving
    from movae_tpu_torch.train.step import preprocess_batch

    dev = resolve_device(args.device)
    size = args.input_size
    margs = dict(arch="vq_vae", embedding_dim=64, num_embeddings=512,
                 hidden_dims=tuple(args.hidden_dims), num_residual_layers=2,
                 batch_size=args.batch_size, dataset_size=50000,
                 compute_dtype=args.compute_dtype)
    model = init_model(get_network(size, 3, margs), seed=0,
                       device=dev).eval()
    out_dir = tempfile.mkdtemp(prefix="movae_serving_ab_")
    export_serving(model, out_dir, sample_batch=2,
                   image_batch=args.batch_size, input_size=size)
    art = load_serving(out_dir)

    def live(x):
        with torch.no_grad():
            return model(preprocess_batch(x, False),
                         train=False)["recons"].float()

    x = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (args.batch_size, size, size, 3)).astype(np.uint8)).to(dev)
    np.testing.assert_allclose(art["reconstruct"](x).cpu().numpy(),
                               live(x).cpu().numpy(), rtol=2e-2, atol=2e-2)
    med = interleaved({"live": live, "artifact": art["reconstruct"]}, x,
                      args.rounds, args.reps_per_round)
    res = {"batch_size": args.batch_size, "input_size": size,
           "compute_dtype": args.compute_dtype,
           **{f"{k}_ms": v * 1e3 for k, v in med.items()},
           **{f"{k}_images_per_sec": args.batch_size / v
              for k, v in med.items()},
           "artifact_over_live": med["artifact"] / med["live"]}
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
