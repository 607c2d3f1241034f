#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port (``movae_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py              # from the root of a checkout
    python3 chip_smoke.py --profile    # adds a torch.profiler breakdown

Phases, each of which fails the run:
  1. build every CUDA kernel of the main path from the sources in the
     checkout (``build/kernels/``), one nvcc per source, all at once;
  2. hold each kernel against its plain PyTorch version on the card at the
     main path's shapes (plus a ragged N and a small D), and time the
     kernel, the plain version and one PyTorch library call that computes
     the same function;
  3. drive the main path — full-width VQ-VAE training (hidden (128, 256),
     K=512, D=64, batch 256, 32x32, adam 1e-3, float32 with TF32 off) —
     with agg=sum and agg=upgrad, launch counts set to 0 just before and
     read just after: every kernel must have run on every forward;
  4. card vs CPU lockstep at a small width: 3 upgrad steps from one init
     must leave the parameters within 1e-4 of each other.

Prints the kernel table as one JSON line, the card's name and power limit,
and last ``{"ok": true, "device": {...}}``. Exits non-zero without a card,
or without the ``movae_tpu_torch`` package beside this script.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

SLICE_N, SLICE_K, SLICE_D = 16384, 512, 64
FULL_WIDTH = dict(arch="vq_vae", embedding_dim=SLICE_D,
                  num_embeddings=SLICE_K, hidden_dims=(128, 256),
                  num_residual_layers=2, recons_objective="mse",
                  recons_activation="tanh")
BATCH, SIZE = 256, 32
WARMUP, TIMED = 3, 20
# published H100 peaks (NVIDIA data sheets): fp32 on the CUDA cores, HBM
PEAKS = {"sxm": (67e12, 3.35e12), "pcie": (51e12, 2.0e12),
         "nvl": (60e12, 3.9e12)}


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_peaks(name: str):
    n = name.lower()
    part = "pcie" if "pcie" in n else "nvl" if "nvl" in n else "sxm"
    return part, PEAKS[part]


def time_ms(torch, fn, reps: int = 100, warmup: int = 5) -> float:
    """Mean device time of ``fn`` over ``reps`` launches (CUDA events)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------------------
# phase 2: nearest-code kernel vs its plain version
# ---------------------------------------------------------------------------

def compare_nearest(torch, nc, z, cb) -> dict:
    """Kernel vs plain on the same inputs. Indices must match except where a
    row's top-two distance gap, recomputed in float64, is below
    1e-5 * (1 + |d|) (a near tie that float32 summation order may flip)."""
    got = nc.nearest_code_cuda(z, cb)
    want = nc.nearest_code_plain(z, cb)
    torch.cuda.synchronize()
    z64, cb64 = z.double(), cb.double()
    dist = (cb64 * cb64).sum(1)[None, :] - 2.0 * z64 @ cb64.T
    top2 = dist.topk(2, dim=1, largest=False).values
    near_tie = (top2[:, 1] - top2[:, 0]) < 1e-5 * (1.0 + top2[:, 0].abs())
    mismatch = got != want
    d_got = dist.gather(1, got.long()[:, None])[:, 0]
    d_want = dist.gather(1, want.long()[:, None])[:, 0]
    return {
        "rows": int(z.shape[0]),
        "mismatch": int(mismatch.sum()),
        "near_tie_mismatch": int((mismatch & near_tie).sum()),
        "bad": int((mismatch & ~near_tie).sum()),
        # float64 distance between the two picks (0 where they agree)
        "max_abs_err": float((d_got - d_want).abs().max()),
        "in_range": bool(((got >= 0) & (got < cb.shape[0])).all()),
    }


def phase_kernels(torch, nc, dev, peaks) -> dict:
    gen = torch.Generator(device=dev).manual_seed(0)
    cases = [(SLICE_N, SLICE_K, SLICE_D), (1000, SLICE_K, SLICE_D),
             (4096, 64, 8), (777, 1000, 128)]
    worst = 0.0
    for n, k, d in cases:
        z = torch.randn(n, d, generator=gen, device=dev)
        cb = torch.randn(k, d, generator=gen, device=dev)
        res = compare_nearest(torch, nc, z, cb)
        log(f"nearest_code N={n} K={k} D={d}: {json.dumps(res)}")
        check(res["in_range"] and res["bad"] == 0,
              f"nearest_code disagrees with its plain version at "
              f"N={n} K={k} D={d}: {res}")
        worst = max(worst, res["max_abs_err"])

    z = torch.randn(SLICE_N, SLICE_D, generator=gen, device=dev)
    cb = torch.randn(SLICE_K, SLICE_D, generator=gen, device=dev)
    ms = time_ms(torch, lambda: nc.nearest_code_cuda(z, cb))
    plain_ms = time_ms(torch, lambda: nc.nearest_code_plain(z, cb))
    library_ms = time_ms(torch, lambda: torch.cdist(z, cb).argmin(1))
    flops = 2.0 * SLICE_N * SLICE_K * SLICE_D + 2.0 * SLICE_K * SLICE_D
    nbytes = 4.0 * (SLICE_N * SLICE_D + SLICE_K * SLICE_D) + 4.0 * SLICE_N
    flop_peak, byte_peak = peaks
    ops_ms, bytes_ms = flops / flop_peak * 1e3, nbytes / byte_peak * 1e3
    bound_ms = max(ops_ms, bytes_ms)
    log(f"nearest_code timing N={SLICE_N} K={SLICE_K} D={SLICE_D}: "
        f"kernel {ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} us, "
        f"cdist+argmin {library_ms * 1e3:.2f} us, bound {bound_ms * 1e3:.2f} "
        f"us (ops {ops_ms * 1e3:.2f} us, bytes {bytes_ms * 1e3:.2f} us), "
        f"{flops / (ms * 1e-3) / 1e12:.2f} TFLOP/s achieved")
    return {
        "name": "nearest_code", "route": "cuda",
        "source": "movae_tpu_torch/kernels/nearest_code.cu",
        "replaces": "movae_tpu/ops/vq.py:93",
        "launches": None, "max_abs_err": worst, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": library_ms,
    }


# ---------------------------------------------------------------------------
# phase 3: the main path, full-width VQ-VAE training
# ---------------------------------------------------------------------------

def train_mode(torch, agg: str, dev):
    from movae_tpu_torch.kernels import LAUNCH_COUNTS
    from movae_tpu_torch.models import get_network, init_model
    from movae_tpu_torch.moo import AggregatorConfig, init_state
    from movae_tpu_torch.train.optim import build_optimizer, lr_schedule
    from movae_tpu_torch.train.state import TrainState
    from movae_tpu_torch.train.step import make_train_step

    model = init_model(get_network(SIZE, 3, FULL_WIDTH), seed=0, device=dev)
    cfg = AggregatorConfig(name=agg, num_objectives=len(model.objective_names))
    state = TrainState.create(
        model, build_optimizer("adam", lr_schedule(1e-3, None, 1, 1)),
        init_state(cfg))
    step = make_train_step(model, cfg)
    gen = torch.Generator(device=dev).manual_seed(1)
    batches = [torch.rand(BATCH, SIZE, SIZE, 3, generator=gen, device=dev)
               * 2 - 1 for _ in range(4)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = LAUNCH_COUNTS["nearest_code"]
    times, mets = [], []
    for i in range(WARMUP + TIMED):
        t0 = time.perf_counter()
        state, met = step(state, batches[i % len(batches)], gen)
        torch.cuda.synchronize()
        if i >= WARMUP:
            times.append(time.perf_counter() - t0)
        mets.append({k: float(v) for k, v in met.items()})
    launches = LAUNCH_COUNTS["nearest_code"] - start
    for i, met in enumerate(mets):
        check(all(v == v and abs(v) != float("inf") for v in met.values()),
              f"{agg} step {i}: non-finite metric {met}")
        check(met["skipped_nonfinite"] == 0.0,
              f"{agg} step {i}: non-finite loss or gradient")
        check("codebook_usage_percentage" in met,
              f"{agg} step {i}: codebook_usage_percentage missing")
    forwards = WARMUP + TIMED
    check(launches == forwards,
          f"{agg}: nearest_code launched {launches} times in {forwards} "
          f"forwards")
    med = statistics.median(times)
    res = {"agg": agg, "steps": forwards, "nearest_code_launches": launches,
           "median_step_ms": med * 1e3, "min_step_ms": min(times) * 1e3,
           "images_per_sec": BATCH / med,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "first": mets[0], "last": mets[-1]}
    log(f"train agg={agg}: {json.dumps(res)}")
    return res, (step, state, batches, gen)


def profile_steps(torch, res: dict, step, state, batches, gen) -> None:
    """Device time by kernel over 5 steady steps (run after the counts are
    read, so it adds no launches to the main path's count). The busy share
    is kernel time over the untraced median step time: tracing slows the
    host several-fold."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=acts) as prof:
        for i in range(5):
            step(state, batches[i % len(batches)], gen)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    # device kernels only: the CPU-side ops' device totals, and the GPU
    # ranges of annotations such as "Optimizer.step#Adam.step", would count
    # their kernels a second time
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and "#" not in e.key
               and not getattr(e, "is_user_annotation", False)]
    attr = ("self_device_time_total"
            if hasattr(kernels[0], "self_device_time_total")
            else "self_cuda_time_total")
    kernels.sort(key=lambda e: getattr(e, attr), reverse=True)
    dev_ms = sum(getattr(e, attr) for e in kernels) / 1e3
    step_ms = res["median_step_ms"]
    lines = [f"profile agg={res['agg']}: 5 traced steps, wall {wall_ms:.2f} "
             f"ms; device kernel time {dev_ms / 5:.3f} ms/step against an "
             f"untraced median step of {step_ms:.3f} ms "
             f"({100.0 * dev_ms / 5 / step_ms:.1f}% busy), "
             f"{sum(e.count for e in kernels) // 5} kernels/step"]
    for e in kernels[:15]:
        lines.append(f"  {getattr(e, attr) / 1e3 / 5:9.3f} ms/step  "
                     f"{e.count // 5:5d}x  {e.key[:90]}")
    log("\n".join(lines))


# ---------------------------------------------------------------------------
# phase 4: card vs CPU lockstep
# ---------------------------------------------------------------------------

def phase_lockstep(torch, dev) -> float:
    import numpy as np

    from movae_tpu_torch.models import get_network, init_model
    from movae_tpu_torch.moo import AggregatorConfig, init_state
    from movae_tpu_torch.train.optim import build_optimizer
    from movae_tpu_torch.train.state import TrainState
    from movae_tpu_torch.train.step import make_train_step

    small = dict(FULL_WIDTH, hidden_dims=(8, 16), embedding_dim=8,
                 num_embeddings=32)
    rng = np.random.default_rng(0)
    batches = [torch.tensor(rng.uniform(-1, 1, (4, 16, 16, 3)).astype(
        np.float32)) for _ in range(3)]
    runs = {}
    for where in ("cpu", dev):
        model = init_model(get_network(16, 3, small), seed=3, device=where)
        cfg = AggregatorConfig(name="upgrad",
                               num_objectives=len(model.objective_names))
        state = TrainState.create(model, build_optimizer("adam", 1e-3,
                                                         eps=1e-4),
                                  init_state(cfg))
        step = make_train_step(model, cfg)
        losses = []
        for xb in batches:
            state, met = step(state, xb)
            losses.append(float(met["total_loss"]))
        runs[str(where)] = (model.state_dict(), losses)
    (cpu_sd, cpu_l), (dev_sd, dev_l) = runs["cpu"], runs[str(dev)]
    delta = max(float((cpu_sd[k] - dev_sd[k].cpu()).abs().max())
                for k in cpu_sd)
    log(f"lockstep card vs cpu, 3 upgrad steps: losses cpu {cpu_l} card "
        f"{dev_l}, max param delta {delta:.3e}")
    check(delta < 1e-4, f"card and CPU parameters differ by {delta:.3e}")
    return delta


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--profile", action="store_true",
                   help="also print a torch.profiler breakdown per mode")
    args = p.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from movae_tpu_torch.device import resolve_device
        from movae_tpu_torch.kernels import (LAUNCH_COUNTS, build,
                                             reset_launch_counts)
        from movae_tpu_torch.kernels import nearest_code as nc
    except ImportError as e:
        print(f"chip_smoke: the movae_tpu_torch package must sit beside "
              f"this script: {e}", file=sys.stderr)
        return 1

    dev = resolve_device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    part, peaks = card_peaks(name)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; {name}; "
        f"peaks for H100 {part}: {peaks[0] / 1e12:g} TFLOP/s fp32, "
        f"{peaks[1] / 1e12:g} TB/s; tf32 matmul "
        f"{torch.backends.cuda.matmul.allow_tf32} cudnn "
        f"{torch.backends.cudnn.allow_tf32}")

    try:
        t0 = time.perf_counter()
        build.build(["nearest_code"])
        log(f"build: {time.perf_counter() - t0:.1f} s")
        for src, text in build.build_logs.items():
            log(f"ptxas {src}:\n{text.strip()}")

        row = phase_kernels(torch, nc, dev, peaks)

        reset_launch_counts()
        runs = [train_mode(torch, agg, dev) for agg in ("sum", "upgrad")]
        row["launches"] = LAUNCH_COUNTS["nearest_code"]
        check(row["launches"] == sum(r["steps"] for r, _ in runs),
              f"nearest_code launches {row['launches']} != forwards")

        # the kernel on the main path's own tensors: the trained model's
        # latents against its codebook (16,384 x 64 against 512 x 64)
        _, (_, state, batches, _) = runs[-1]
        with torch.no_grad():
            enc = state.model.encode(batches[0]).reshape(-1, SLICE_D)
            res = compare_nearest(torch, nc, enc.contiguous(),
                                  state.model.vq_layer().contiguous())
        log(f"nearest_code on trained latents: {json.dumps(res)}")
        check(res["bad"] == 0 and res["in_range"],
              f"nearest_code disagrees on trained latents: {res}")
        row["max_abs_err"] = max(row["max_abs_err"], res["max_abs_err"])
        if args.profile:
            for res_mode, ctx in runs:
                profile_steps(torch, res_mode, *ctx)

        phase_lockstep(torch, dev)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1

    log(json.dumps({"kernels": [row]}))
    log(smi[0] if smi else "nvidia-smi: no output")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
