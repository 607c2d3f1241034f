"""Stage 1 as MO-VAE trains it: ``train/loop.py:train_epoch_device`` over
``train/step.py:make_train_step``, the images resident on the card in a
``data/device.py:DeviceData`` (gathered and flipped there), a closed loop
of back-to-back steps.

Set-up makes the weights and a seeded uint8 image set, builds one train
state, and drives it through the window's own call for the first
``CHECK_STEPS`` steps (epoch 1's first batches), reading each step's
loss from the program's metric pump, the first Adam moments and the
parameters after the last of them. ``WARM_STEPS`` more steps (epoch 0)
follow; the window then runs epochs 2, 3, ... until ``--seconds`` have
passed, stopped by the loop's ``stop_check``, and ends in a
synchronisation. The reference follows the checked steps on the same
rows and flips, worked out again from the seeds.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Any, Dict, List

import numpy as np
import torch

from portbench import judge, work
from portbench.drivers.common import (OptimizerTap, StepLog, mark, now,
                                      peak_bytes, recording, release,
                                      reset_peak, steady_timeline, sync)
from portbench.harness import sub_seed, wrapped
from portbench.peaks import TENSOR_PEAK
from portbench.reference.precision import Precision
from portbench.reference.train import stage1_steps
from portbench.reference.vqvae2 import VQVAE2
from portbench.reference.weights import make_weights, scale_leaves

CHECK_STEPS = 3
WARM_STEPS = 2
SYNC_STEPS = 4
TRACE_STEPS = 6
IMAGE_CHUNK = 512


def make_images(n: int, size: int, seed: int, dev: torch.device
                ) -> np.ndarray:
    """(n, size, size, 3) uint8 images, uniform, drawn on ``dev`` in
    chunks into one host array (page-locked on a card, so that the copies
    to and from it run at the link's speed)."""
    out = torch.empty((n, size, size, 3), dtype=torch.uint8,
                      pin_memory=dev.type == "cuda").numpy()
    gen = torch.Generator(device=dev).manual_seed(seed)
    for i in range(0, n, IMAGE_CHUNK):
        m = min(IMAGE_CHUNK, n - i)
        chunk = torch.randint(0, 256, (m, size, size, 3), dtype=torch.uint8,
                              generator=gen, device=dev)
        torch.from_numpy(out[i:i + m]).copy_(chunk)
    return out


def inputs(cfg: dict, seed: int, dev: torch.device, cell: dict = None):
    """The benchmark's inputs: {name: weight} and the host image set. The
    cell's ``weight_scale`` ({leaf: factor}) scales the leaves it names."""
    weights = scale_leaves(
        make_weights(VQVAE2(cfg), sub_seed(seed, "weights"), dev),
        (cell or {}).get("weight_scale", {}))
    images = make_images(int(cfg["train_images"]), int(cfg["image_size"]),
                         sub_seed(seed, "images"), dev)
    return weights, images


def checked_batches(cfg: dict, images: np.ndarray, seed: int,
                    dev: torch.device) -> List[torch.Tensor]:
    """The first ``CHECK_STEPS`` batches of epoch 1 as the loop feeds
    them: rows by the resident set's documented plan (the permutation of
    ``np.random.default_rng((seed, epoch, 0))``), each batch then flipped
    along its width where one uniform draw per row from the loop's
    generator falls below 0.5."""
    b = int(cfg["batch_size"])
    perm = np.random.default_rng((sub_seed(seed, "plan"), 1, 0)).permutation(
        len(images))
    gen = torch.Generator(device=dev).manual_seed(sub_seed(seed, "flips"))
    out = []
    for s in range(CHECK_STEPS):
        imgs = torch.from_numpy(images[perm[s * b:(s + 1) * b]]).to(dev)
        if cfg["flip"]:
            mask = torch.rand(b, generator=gen, device=dev) < 0.5
            imgs = torch.where(mask[:, None, None, None], imgs.flip(2), imgs)
        out.append(imgs)
    return out


def reference(cfg: dict, cell: dict, weights, images, seed: int,
              dev: torch.device, mode: str = "fp32",
              half_batch: bool = False) -> Dict[str, Any]:
    return stage1_steps(cfg, weights,
                        checked_batches(cfg, images, seed, dev),
                        cell["aggregator"], Precision(mode), half_batch)


class Stage1:
    """The program's stage 1: one model loaded with the benchmark's
    weights, its resident image set, train state and step, and the loop
    that drives them (:meth:`steps`)."""

    def __init__(self, cfg: dict, cell: dict, seed: int, weights, images,
                 dev: torch.device):
        from movae_tpu_torch.data import ArrayDataset
        from movae_tpu_torch.data.device import DeviceData
        from movae_tpu_torch.models import get_network
        from movae_tpu_torch.moo import init_state
        from movae_tpu_torch.train.loop import aggregator_config_from_args
        from movae_tpu_torch.train.optim import build_optimizer, lr_schedule
        from movae_tpu_torch.train.state import TrainState
        from movae_tpu_torch.train.step import make_train_step

        b = int(cfg["batch_size"])
        args = SimpleNamespace(
            arch="vq_vae2", embedding_dim=cfg["embedding_dim"],
            num_embeddings=cfg["num_embeddings"],
            hidden_dims=tuple(cfg["hidden_dims"]),
            num_residual_layers=cfg["num_residual_layers"],
            loss_weights=dict(cfg["loss_weights"]),
            recons_objective=cfg["recons_objective"],
            recons_activation=cfg["recons_activation"],
            compute_dtype=cfg["compute_dtype"])
        self.model = get_network(int(cfg["image_size"]), 3, args).to(dev)
        self.model.load_state_dict(weights)
        self.dd = DeviceData(ArrayDataset(
            images, flip=bool(cfg["flip"]),
            normalize=bool(cfg["normalize_inputs"])), b, dev,
            seed=sub_seed(seed, "plan"))
        spe = self.dd.optimizer_steps_per_epoch()
        epochs = int(cfg["epochs"])
        tx = build_optimizer(cfg["optimizer"], lr_schedule(
            float(cfg["lr"]), cfg["scheduler"], epochs, spe,
            lr_min=float(cfg["scheduler_lr_min"])),
            weight_decay=float(cfg["wd"]))
        agg_cfg = aggregator_config_from_args(
            SimpleNamespace(aggregator=cell["aggregator"]),
            len(self.model.objective_names))
        self.state = TrainState.create(self.model, tx, init_state(agg_cfg))
        self.step_fn = make_train_step(
            self.model, agg_cfg, epochs, spe,
            normalize_inputs=bool(cfg["normalize_inputs"]))
        self.gen = torch.Generator(device=dev).manual_seed(
            sub_seed(seed, "flips"))
        self.names = self.model.objective_names
        self.dev = dev

    def epoch(self, epoch: int, step0: int, logger, stop) -> int:
        """Steps of ``epoch`` through the loop until ``stop()``; the step
        count."""
        from movae_tpu_torch.train.loop import train_epoch_device

        self.state, _, step = train_epoch_device(
            self.dd, self.step_fn, self.state, self.dev, self.gen, step0,
            logger, self.names, epoch_index=epoch, stop_check=stop)
        return step

    def steps(self, epoch: int, count: int, logger=None, step0: int = 0
              ) -> int:
        """``count`` steps of ``epoch`` through the loop."""
        done = [0]

        def stop() -> bool:
            done[0] += 1
            return done[0] >= count
        return self.epoch(epoch, step0, logger, stop)


def program(cfg: dict, cell: dict, seed: int, weights, images,
            dev: torch.device):
    """The program's side of the comparison: the first ``CHECK_STEPS``
    steps (epoch 1's first batches) through the loop. Returns (readings,
    :class:`Stage1`); the readings add the first step's codes (top, then
    bottom, as ``ops/vq.py:vector_quantize`` returned them) and, where the
    step calls ``moo/aggregators.py:compute_weights``, its weights. The
    device is set up as the port sets it up (``resolve_device``: TF32
    off)."""
    from movae_tpu_torch.device import resolve_device

    s1 = Stage1(cfg, cell, seed, weights, images, resolve_device(dev))
    log = StepLog()
    with OptimizerTap(s1.model) as tap, \
            recording("movae_tpu_torch.ops.vq:vector_quantize",
                      lambda o: o["encoding_inds"].detach().clone(),
                      2) as codes, \
            recording("movae_tpu_torch.moo.aggregators:compute_weights",
                      lambda o: o[0].detach().clone(), 1) as alphas:
        s1.steps(1, CHECK_STEPS, log)
    prog = tap.read([r["train/total_loss_curr"] for r in log.rows])
    prog["codes1"] = list(codes)
    if alphas:
        prog["alpha1"] = alphas[0]
    return prog, s1


def run(cfg: dict, cell: dict, seed: int, seconds: float, trace: bool,
        dev: torch.device, clock0: float, wraps: List[str]) -> Dict:
    from movae_tpu_torch.device import resolve_device
    from movae_tpu_torch.kernels import LAUNCH_COUNTS

    from portbench.syncs import count_syncs
    from portbench.trace import capture

    dev = resolve_device(dev)
    reset_peak(dev)
    mark(clock0, "imports and device")
    b = int(cfg["batch_size"])
    weights, images = inputs(cfg, seed, dev, cell)
    mark(clock0, "weights and images made")
    prog, s1 = program(cfg, cell, seed, weights, images, dev)
    mark(clock0, "checked steps")
    s1.steps(0, WARM_STEPS)

    sync(dev)
    applied0 = int(s1.state.step)
    t0 = now()
    deadline = t0 + seconds
    step, epoch = 0, 2
    while True:
        step = s1.epoch(epoch, step, None, lambda: now() >= deadline)
        if now() >= deadline:
            break
        epoch += 1
    sync(dev)
    t1 = now()
    window = t1 - t0
    failed = step - (int(s1.state.step) - applied0)
    peak = peak_bytes(dev)
    out: Dict[str, Any] = {
        "attempted": step, "failed": failed, "memory_peak_bytes": peak,
        "e2e": {"train_images_per_s": (step * b / window, "images/s"),
                "peak_mem_gib": (peak / 2 ** 30, "GiB"),
                "setup_s": (t0 - clock0, "s")}}

    if trace:
        syncs = count_syncs(lambda: s1.steps(900, SYNC_STEPS), dev)
        before = dict(LAUNCH_COUNTS)
        with wrapped(wraps):
            tr = capture(lambda: s1.steps(901, TRACE_STEPS), dev)
        out["ctx"] = {
            "trace": tr, "traced_steps": TRACE_STEPS,
            "step_s": window / max(step, 1),
            "syncs_per_step": syncs / SYNC_STEPS,
            "launches": {k: LAUNCH_COUNTS[k] - before[k] for k in before},
            "step_flops": work.vqvae2_step_flops(cfg, b),
            "tensor_peak": TENSOR_PEAK[cfg["compute_dtype"]],
            "kernel_work": {"nearest_code": [
                work.nearest_code_work(*s)
                for s in work.nearest_code_launches(cfg, b)]},
            **steady_timeline(tr),
            "breakdown": {"device_ops": tr.top_ops(10),
                          "idle_gaps": tr.idle_gaps(10)}}

    del s1
    release(dev)
    ref = reference(cfg, cell, weights, images, seed, dev)
    out["readings"] = judge.readings(prog, ref, weights)
    return out
