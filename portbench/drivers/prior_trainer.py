"""Stage 2 as MO-VAE trains it: ``train/prior.py:train_prior`` (its
``train_prior_on_levels`` form) over host code grids through its
``utils/codes.py:CodeLoader``, one epoch a call, the prior carried from
call to call (``prior=``).

Set-up makes the weights and builds one prior, then drives it through a
call over ``CHECK_STEPS`` batches of fresh codes, reading each step's
loss from the call's ``step_trace``, the first Adam moments and the
parameters after the last step; a second call of ``CHECK_STEPS`` batches
times a step. The window is one call whose code set holds as many
batches as the timed step says fill ``--seconds``, ended by a
synchronisation. The reference follows the checked steps on the same
rows and dropout masks, worked out again from the seeds.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List

import numpy as np
import torch

from portbench import judge, work
from portbench.drivers.common import (OptimizerTap, mark, now, peak_bytes,
                                      release, reset_peak, steady_timeline,
                                      sync)
from portbench.harness import sub_seed, wrapped
from portbench.peaks import TENSOR_PEAK
from portbench.reference.pixelsnail import PixelSNAIL
from portbench.reference.precision import Precision
from portbench.reference.train import prior_steps
from portbench.reference.weights import make_weights, scale_leaves

CHECK_STEPS = 3
SYNC_STEPS = 4
TRACE_STEPS = 5


def codes(cfg: dict, cell: dict, n: int, seed: int) -> np.ndarray:
    """(n, H, W) int32 codes. Each grid draws uniformly from its own band
    of the K codes, of a width log-uniform from 1 to K, as images use parts
    of a codebook (a flat image one code, a busy one all): grids differ in
    their loss, so that a step that leaves rows out shows in its loss. The
    work does not depend on the values."""
    g, k = int(cell["grid"]), int(cfg["num_embeddings"])
    rng = np.random.default_rng(seed)
    lo = rng.integers(0, k, n)
    width = np.exp(rng.uniform(0.0, np.log(k), n))
    u = rng.random((n, g, g))
    return ((lo[:, None, None] + (u * width[:, None, None]).astype(np.int64))
            % k).astype(np.int32)


def checked_codes(cfg: dict, cell: dict, seed: int) -> np.ndarray:
    return codes(cfg, cell, CHECK_STEPS * int(cell["batch_size"]),
                 sub_seed(seed, "codes"))


def reference(cfg: dict, cell: dict, weights, data, seed: int,
              dev: torch.device, mode: str = "fp32",
              half_batch: bool = False) -> Dict[str, Any]:
    """The checked steps' batches in the loader's documented order (the
    permutation of ``np.random.default_rng((seed, epoch))`` over the call's
    set, epoch 0), the dropout masks from the trainer's generator
    (``seed + 1``)."""
    b = int(cell["batch_size"])
    c = checked_codes(cfg, cell, seed)
    run_seed = sub_seed(seed, "trainer")
    order = np.random.default_rng((run_seed, 0)).permutation(len(c))
    batches = [torch.from_numpy(c[order[s * b:(s + 1) * b]]).to(dev)
               for s in range(CHECK_STEPS)]
    return prior_steps(cfg, weights, batches, run_seed + 1, Precision(mode),
                       half_batch, chunk=int(cell["reference_chunk"]))


def inputs(cfg: dict, seed: int, dev: torch.device, cell: dict = None):
    """The benchmark's inputs: {name: weight}, and no data set (the code
    batches are drawn where they are used). The cell's ``weight_scale``
    ({leaf: factor}) scales the leaves it names (see ``scale_leaves``)."""
    w = make_weights(PixelSNAIL(cfg), sub_seed(seed, "weights"), dev)
    return scale_leaves(w, (cell or {}).get("weight_scale", {})), None


def build(cfg: dict, cell: dict, seed: int, weights, dev: torch.device):
    """The program's prior, loaded with ``weights``, and ``call(codes,
    trace_into=None)``: one ``train_prior`` call of one epoch over the
    (n, H, W) codes, carrying the prior."""
    from movae_tpu_torch.train.prior import build_prior, train_prior

    b = int(cell["batch_size"])
    args = {
        "seed": sub_seed(seed, "trainer"), "batch_size": b,
        "pixelcnn_epochs": 1, "pixelcnn_lr": float(cfg["lr"]),
        "pixelcnn_adam_eps": float(cfg["adam_eps"]),
        "pixelcnn_weight_decay": 0.0, "prior_type": "pixelsnail",
        "pixelsnail_num_blocks": int(cfg["num_blocks"]),
        "pixelcnn_hidden_channels": int(cfg["hidden_channels"]),
        "pixelsnail_num_res_blocks": int(cfg["num_res_blocks"]),
        "pixelsnail_num_heads": int(cfg["num_heads"]),
        "pixelsnail_dropout": float(cfg["dropout"]),
        "attention_dropout": cfg["attention_dropout"],
        "compute_dtype": cfg["compute_dtype"]}
    meta = type("VQMeta", (), {"num_embeddings": int(cfg["num_embeddings"]),
                               "embedding_dim": int(cfg["embedding_dim"])})
    prior = build_prior(args, meta.num_embeddings, False,
                        meta.embedding_dim).to(dev)
    prior.load_state_dict(weights)

    def call(codes_np: np.ndarray, trace_into=None) -> None:
        train_prior({"codes": codes_np}, meta, args, device=dev,
                    step_trace=trace_into, prior=prior)

    return prior, call


def program(cfg: dict, cell: dict, seed: int, weights, data,
            dev: torch.device):
    """The program's side of the comparison: one prior driven through a
    call over the checked batches, on the device as the port sets it up
    (``resolve_device``: TF32 off). Returns (readings, (prior, call))."""
    from movae_tpu_torch.device import resolve_device

    dev = resolve_device(dev)
    prior, call = build(cfg, cell, seed, weights, dev)
    losses: List[float] = []
    with OptimizerTap(prior) as tap:
        call(checked_codes(cfg, cell, seed), losses)
    return tap.read(losses), (prior, call)


def run(cfg: dict, cell: dict, seed: int, seconds: float, trace: bool,
        dev: torch.device, clock0: float, wraps: List[str]) -> Dict:
    from movae_tpu_torch.device import resolve_device
    from movae_tpu_torch.kernels import LAUNCH_COUNTS

    from portbench.syncs import count_syncs
    from portbench.trace import capture

    dev = resolve_device(dev)
    reset_peak(dev)
    mark(clock0, "imports and device")
    b, g = int(cell["batch_size"]), int(cell["grid"])
    weights, data = inputs(cfg, seed, dev, cell)
    prog, (prior, call) = program(cfg, cell, seed, weights, data, dev)
    mark(clock0, "checked steps")

    sync(dev)
    t = now()
    call(codes(cfg, cell, CHECK_STEPS * b, sub_seed(seed, "sizing")))
    sync(dev)
    step_s = (now() - t) / CHECK_STEPS
    n_steps = max(CHECK_STEPS, math.ceil(seconds / step_s))
    window_codes = codes(cfg, cell, n_steps * b, sub_seed(seed, "window"))

    sync(dev)
    t0 = now()
    window_losses: List[float] = []
    call(window_codes, window_losses)
    sync(dev)
    t1 = now()
    window = t1 - t0
    failed = sum(not math.isfinite(v) for v in window_losses) + (
        n_steps - len(window_losses))
    peak = peak_bytes(dev)
    out: Dict[str, Any] = {
        "attempted": n_steps, "failed": failed, "memory_peak_bytes": peak,
        "e2e": {"prior_codes_per_s": (n_steps * b * g * g / window,
                                      "codes/s"),
                "peak_mem_gib": (peak / 2 ** 30, "GiB"),
                "setup_s": (t0 - clock0, "s")}}

    if trace:
        # a step's syncs: a call of 1 + SYNC_STEPS steps less a call of
        # one, so the call's own (its host copies of the weights) drop out
        one = codes(cfg, cell, b, sub_seed(seed, "syncs1"))
        more = codes(cfg, cell, (1 + SYNC_STEPS) * b, sub_seed(seed, "syncs"))
        syncs = (count_syncs(lambda: call(more), dev)
                 - count_syncs(lambda: call(one), dev))
        traced = codes(cfg, cell, TRACE_STEPS * b, sub_seed(seed, "traced"))
        before = dict(LAUNCH_COUNTS)
        with wrapped(wraps):
            tr = capture(lambda: call(traced), dev)
        heads = int(cfg["num_heads"])
        hd = int(cfg["hidden_channels"]) // heads
        flash = work.flash_work(b, heads, g * g, hd)
        out["ctx"] = {
            "trace": tr, "traced_steps": TRACE_STEPS,
            "step_s": window / n_steps,
            "syncs_per_step": syncs / SYNC_STEPS,
            "launches": {k: LAUNCH_COUNTS[k] - before[k] for k in before},
            "step_flops": work.pixelsnail_step_flops(cfg, b, g, g),
            "tensor_peak": TENSOR_PEAK[cfg["compute_dtype"]],
            "kernel_work": {
                "flash_attention_fwd": [flash["fwd"]],
                "flash_attention_bwd_dkv": [flash["dkv"]],
                "flash_attention_bwd_dq": [flash["dq"]]},
            **steady_timeline(tr),
            "breakdown": {"device_ops": tr.top_ops(10),
                          "idle_gaps": tr.idle_gaps(10)}}

    del prior, call
    release(dev)
    ref = reference(cfg, cell, weights, data, seed, dev)
    out["readings"] = judge.readings(prog, ref, weights)
    return out
