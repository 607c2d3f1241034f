"""Benchmark CLI of the port — ``python -m movae_tpu_torch.bench``.

The counterpart of the repo's ``bench.py``: the stage-1 VQ-VAE train step
(hidden (128, 256), K=512, D=64, mse) on a seeded batch resident on the
card, or (``--mode sampling``) the prior samplers at full width, printing
ONE JSON line ``{"metric", "value", "unit", "vs_baseline", "device"}`` (the
train mode adds ``dtype``, ``steps_per_dispatch``, ``remat``,
``host_syncs_per_step`` and ``steps_run``). Train steps are timed with CUDA
events in 5 rounds, and the median round's rate is reported; on ``--device
cpu`` the host clock times them. ``vs_baseline`` divides by the same fixed
estimates as ``bench.py`` (4,000 images/s for the train step, 500 px/s for
sampling).

The defaults are ``bench.py``'s: ``--dtype bfloat16`` (on the CPU the
model computes in float32, as ``bench.py`` does there), ``--batch_size
1024`` and ``--steps_per_dispatch 8``. A dispatch is k calls of the single
step queued back to back: the step makes no host synchronisation, so they
already queue as the JAX package's k-step scan does, and give its
numbers. ``host_syncs_per_step`` is counted by CUDA's sync debug mode over
untimed dispatches (0 on the CPU, where there is nothing to count).
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import numpy as np
import torch

from movae_tpu_torch.device import resolve_device

REFERENCE_IMAGES_PER_SEC = 4000.0
REFERENCE_PX_PER_SEC = 500.0
ROUNDS = 5


def _timed(fn, device: torch.device) -> float:
    """Seconds that ``fn()``'s work takes on ``device``."""
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def _device_name(device: torch.device) -> str:
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")


def bench_sampling(args, device: torch.device) -> dict:
    """Prior sampling px/s through ``sample_prior``'s dispatch."""
    from movae_tpu_torch.models.pixelcnn import (PixelCNN, PixelSNAIL,
                                                 sample_prior)

    h = w = args.grid
    b = args.batch_size
    if args.prior == "pixelsnail":
        model = PixelSNAIL(num_embeddings=512, embedding_dim=64,
                           hidden_channels=128, num_blocks=8,
                           num_res_blocks_per_layer=2, num_heads=8,
                           dropout=0.0)
    else:
        model = PixelCNN(num_embeddings=512, embedding_dim=64,
                         hidden_channels=128, num_layers=15)
    model.reset_parameters(torch.Generator().manual_seed(0))
    model = model.to(device)
    gen = torch.Generator(device=device).manual_seed(1)
    sample_prior(model, gen, b, h, w)  # warm up
    times = [_timed(lambda: sample_prior(model, gen, b, h, w), device)
             for _ in range(max(args.steps // 10, 3))]
    px_per_sec = b * h * w / statistics.median(times)
    return {"metric": f"{args.prior}_sample_px_per_sec(bs={b},grid={h}x{w},"
                      "cached-sampler)",
            "value": round(px_per_sec, 1), "unit": "px/sec",
            "vs_baseline": round(px_per_sec / REFERENCE_PX_PER_SEC, 2)}


def model_args(args) -> dict:
    """The registry arguments of ``bench.py``'s model, for any ``--arch``
    (the VAE family's KL weight is batch_size / 50,000, as there)."""
    return dict(arch=args.arch, embedding_dim=64, num_embeddings=512,
                hidden_dims=(128, 256), num_residual_layers=2,
                batch_size=args.batch_size, dataset_size=50000,
                recons_objective="mse")


def count_syncs(fn, device: torch.device) -> int:
    """Host synchronisations while ``fn()`` runs, as CUDA's sync debug mode
    reports them; 0 off a card."""
    if device.type != "cuda":
        fn()
        return 0
    import warnings

    torch.cuda.synchronize(device)
    # the debug mode's first switch in a process reports a synchronisation
    # of its own: switch it once before counting
    torch.cuda.set_sync_debug_mode("warn")
    torch.cuda.set_sync_debug_mode("default")
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in seen)


def bench_train(args, device: torch.device) -> dict:
    from movae_tpu_torch.models import get_network, init_model
    from movae_tpu_torch.moo import AggregatorConfig, init_state
    from movae_tpu_torch.train.optim import build_optimizer, lr_schedule
    from movae_tpu_torch.train.state import TrainState
    from movae_tpu_torch.train.step import make_train_step

    # bf16 on the card; the CPU computes in float32, as bench.py does
    dtype = args.dtype if device.type == "cuda" else "float32"
    model = init_model(get_network(args.input_size, 3, dict(
        model_args(args), compute_dtype=dtype)), seed=0, device=device)
    cfg = AggregatorConfig(name=args.agg,
                           num_objectives=len(model.objective_names))
    state = TrainState.create(
        model, build_optimizer("adam", lr_schedule(1e-3, None, 1, 1)),
        init_state(cfg))
    step = make_train_step(model, cfg, 1, 1, remat=args.remat)
    k = max(args.steps_per_dispatch, 1)
    x = np.random.default_rng(0).uniform(
        -1, 1, (args.batch_size, args.input_size, args.input_size, 3))
    batch = torch.from_numpy(x.astype(np.float32)).to(device)
    gen = torch.Generator(device=device).manual_seed(1)

    def run(n):
        """n dispatches of k steps"""
        for _ in range(n * k):
            step(state, batch, gen)

    warm = max(-(-args.warmup // k), 1)
    run(warm)
    per_round = max(args.steps // (ROUNDS * k), 1)
    rates = [per_round * k * args.batch_size
             / _timed(lambda: run(per_round), device)
             for _ in range(ROUNDS)]
    ips = statistics.median(rates)
    syncs = count_syncs(lambda: run(per_round), device) / (per_round * k)
    return {"metric": f"{args.arch}_train_images_per_sec_per_chip("
                      f"agg={args.agg},bs={args.batch_size},{dtype},"
                      f"k={k}{',remat' if args.remat else ''})",
            "value": round(ips, 2), "unit": "images/sec/chip",
            "vs_baseline": round(ips / REFERENCE_IMAGES_PER_SEC, 3),
            "dtype": dtype, "steps_per_dispatch": k, "remat": args.remat,
            "host_syncs_per_step": syncs,
            # every train step the run took, warmup and sync count included
            "steps_run": (warm + (ROUNDS + 1) * per_round) * k}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--mode", type=str, default="train",
                   choices=["train", "sampling"])
    p.add_argument("--arch", type=str, default="vq_vae")
    p.add_argument("--remat", action="store_true",
                   help="rematerialized backward (large-image configs)")
    p.add_argument("--agg", type=str, default="sum")
    p.add_argument("--batch_size", type=int, default=1024)
    p.add_argument("--input_size", type=int, default=32)
    p.add_argument("--grid", type=int, default=16,
                   help="code grid side for --mode sampling")
    p.add_argument("--prior", type=str, default="pixelcnn",
                   choices=["pixelcnn", "pixelsnail"])
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--steps_per_dispatch", type=int, default=8,
                   help="train steps queued per dispatch (the step makes "
                        "no host synchronisation)")
    p.add_argument("--warmup", type=int, default=10)
    p.add_argument("--dtype", type=str, default="bfloat16",
                   choices=["bfloat16", "float32"],
                   help="compute dtype on the card (the CPU computes in "
                        "float32)")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    out = (bench_sampling if args.mode == "sampling" else bench_train)(
        args, device)
    out["device"] = _device_name(device)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
