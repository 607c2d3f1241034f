"""Training orchestration — port of ``movae_tpu/train/loop.py`` for one
card.

Data -> model -> optimizer -> aggregator config -> train step -> epoch loop
with periodic eval, sample/recon figures and a resumable
``last_checkpoint.pth`` -> final checkpoint. The run tree is the
reference's: ``<save_path>/<dataset>/<arch>/<optimizer>/<aggregator>/
<timestamp>/{figures/{generated,reconstructed}, checkpoints, wandb_local}``.

The host reads each step's metrics one step late: the step's metric
tensors are stacked on the card and copied into a pinned host buffer
without blocking, and the copy is read after the next step is queued.
The train step's non-finite guard is then the only host synchronisation a
step makes.

Flags the port cannot honour yet raise ``NotImplementedError`` naming
their ``ROADMAP.md`` item (:func:`check_supported`).
"""

from __future__ import annotations

import os
import sys
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from movae_tpu_torch.data import Loader, get_dataset
from movae_tpu_torch.data.device import resolve_device_data
from movae_tpu_torch.device import DeviceLike, resolve_device
from movae_tpu_torch.metrics.hv import build_hv_indicator
from movae_tpu_torch.models import get_network, init_model
from movae_tpu_torch.moo import AggregatorConfig, init_state
from movae_tpu_torch.train import checkpoint as ckpt_lib
from movae_tpu_torch.train import figures as fig_lib
from movae_tpu_torch.train.optim import build_optimizer, lr_schedule
from movae_tpu_torch.train.state import TrainState
from movae_tpu_torch.train.step import make_eval_step, make_train_step
from movae_tpu_torch.utils import AverageMeter
from movae_tpu_torch.utils.logging import ExperimentLogger, StepTimer
from movae_tpu_torch.utils.preemption import PreemptionGuard

# VQ architectures that need a prior for meaningful generation
# (reference main.py:54-59)
ARCHS_NEEDING_PRIOR = {
    "vq_vae", "gg_vq_vae", "gg_vq_vae_v1", "gg_vq_vae_v2", "gg_vq_vae_v3",
    "gg_vq_vae_v4", "gg_vq_vae_v5", "gg_vq_vae_v6", "gg_vq_vae_v7",
    "gg_vq_vae_v8", "vq_vae2", "gg_vq_vae2",
}


def is_vq_model(args) -> bool:
    return getattr(args, "arch", "vae").lower() in ARCHS_NEEDING_PRIOR


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to movae_tpu_torch yet: ROADMAP.md {item}")


def check_supported(args) -> None:
    """Raise for a flag the port cannot honour yet, naming its item."""
    for flag in ("model_partitions", "context_parallel", "pipeline_parallel"):
        if int(getattr(args, flag, 1) or 1) > 1:
            raise _not_ported(f"--{flag} > 1", "Queue 1 item 13")
    if getattr(args, "fsdp", False):
        raise _not_ported("--fsdp", "Queue 1 item 13")
    for flag in ("grad_accum", "steps_per_dispatch"):
        if int(getattr(args, flag, 1) or 1) > 1:
            raise _not_ported(f"--{flag} > 1", "Queue 1 item 6")
    if getattr(args, "remat", False):
        raise _not_ported("--remat", "Queue 1 item 6")
    if getattr(args, "compute_dtype", "float32") != "float32":
        raise _not_ported(f"--compute_dtype {args.compute_dtype}",
                          "Queue 1 item 6")


def aggregator_config_from_args(args, num_objectives: int) -> AggregatorConfig:
    """Name + hyperparameter dispatch matching the reference
    (main.py:1191-1246)."""
    name = (getattr(args, "aggregator", None) or "sum").lower()
    pref = getattr(args, "pref_weights", None)
    if isinstance(pref, dict):
        pref = tuple(float(v) for v in pref.values())
    elif pref is not None:
        pref = tuple(float(v) for v in pref)
    return AggregatorConfig(
        name=name,
        num_objectives=num_objectives,
        norm_eps=getattr(args, "agg_norm_eps", 1e-4),
        reg_eps=getattr(args, "agg_reg_eps", 1e-4),
        mgda_norm_type=getattr(args, "comfort_mgda_norm_type", "none")
        if name == "comfort" else "none",
        mgda_epsilon=getattr(args, "mgda_epsilon", 1e-5),
        mgda_max_iters=getattr(args, "mgda_max_iters", 250),
        mgda_stable=getattr(args, "comfort_mgda_stable", False),
        mgda_min_eigenvalue_eps=getattr(args, "mgda_min_eigenvalue_eps",
                                        1e-10),
        pref_vector=pref,
        nashmtl_update_every=getattr(args, "nashmtl_update_every", None)
        or 1,
        comfort_beta_k=getattr(args, "comfort_beta_k", 1.0),
        comfort_beta_a=getattr(args, "comfort_beta_a", 1.0),
        comfort_beta_l=getattr(args, "comfort_beta_l", 0.01),
        comfort_beta_u=getattr(args, "comfort_beta_u", 1.0),
    )


def model_summary(model: torch.nn.Module) -> str:
    """Trainable parameters per module, grouped by the first two levels of
    the parameter names (the JAX package's table)."""
    groups: Dict[str, int] = {}
    for name, p in model.named_parameters():
        if p.requires_grad:
            key = ".".join(name.split(".")[:2])
            groups[key] = groups.get(key, 0) + p.numel()
    width = max([len(k) for k in groups] + [24])
    lines = [f"{'module':<{width}}  params"]
    lines += [f"{k:<{width}}  {v:,}" for k, v in groups.items()]
    lines.append(f"{'total':<{width}}  {sum(groups.values()):,}")
    return "\n".join(lines)


def to_device(imgs, device: torch.device) -> torch.Tensor:
    """A host batch on ``device``: pinned and copied without blocking on a
    card."""
    t = torch.as_tensor(imgs)
    if device.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


class _MetricPump:
    """Per-step metric bookkeeping, read one step late.

    :meth:`push` stacks a step's metrics on the device and starts their
    copy into a pinned host buffer; the entry is read when the next step
    is pushed (or at :meth:`flush`), by which time the copy has landed, so
    the host never waits on the step that made it."""

    def __init__(self, objective_names, logger, log_every: int,
                 device: torch.device):
        self.meters = {k: AverageMeter() for k in
                       list(objective_names) + ["total_loss"]}
        self.usage_meter = AverageMeter()
        self.logger = logger
        self.log_every = log_every
        self.device = device
        self.pending = []

    def push(self, step: int, n_valid: int, metrics) -> None:
        keys = list(metrics)
        vec = torch.stack([torch.as_tensor(metrics[k], device=self.device)
                           .float() for k in keys])
        event = None
        if self.device.type == "cuda":
            host = torch.empty(vec.shape, dtype=vec.dtype, pin_memory=True)
            host.copy_(vec, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
        else:
            host = vec
        self.pending.append((step, n_valid, keys, host, event))
        while len(self.pending) > 1:
            self._drain(*self.pending.pop(0))

    def flush(self) -> None:
        while self.pending:
            self._drain(*self.pending.pop(0))

    def _drain(self, step, n_valid, keys, host, event) -> None:
        if event is not None:
            event.synchronize()
        vals = dict(zip(keys, host.tolist()))
        if vals.get("skipped_nonfinite"):
            # the update was skipped; its losses stay out of the meters
            print(f"Step {step}: non-finite loss/grads — update skipped")
            return
        for k, m in self.meters.items():
            if k in vals:
                m.update(vals[k])
        if "codebook_usage_percentage" in vals:
            self.usage_meter.update(vals["codebook_usage_percentage"],
                                    n=n_valid)
        if vals["total_loss"] > 1e15:
            print(f"Step {step}: EXPLODING: total={vals['total_loss']:.6e}")
        if not (self.log_every and step % self.log_every == 0):
            return
        if self.logger is not None and self.logger.active:
            log = {f"train/{k}": m.avg for k, m in self.meters.items()}
            log.update({f"train/{k}_curr": m.val
                        for k, m in self.meters.items()})
            for k in keys:
                if k.startswith("task_"):
                    log[f"train/{k}"] = vals[k]
            log["train/gradient_similarity"] = vals["gradient_similarity"]
            if self.usage_meter.count > 0:
                log["train/codebook_usage_percentage"] = self.usage_meter.avg
            self.logger.log(log, step=step)

    def final_meters(self):
        if self.usage_meter.count > 0:
            self.meters["codebook_usage_percentage"] = self.usage_meter
        return self.meters


def _end_timed(timer: Optional[StepTimer], device: torch.device,
               n_images: int) -> None:
    if timer is not None and n_images:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        timer.stop(n_images)


def train_epoch(step_fn, state, loader, device, generator, step, logger,
                objective_names, log_every: int = 1,
                timer: Optional[StepTimer] = None, stop_check=None):
    """One epoch over the host loader (reference train_epoch,
    main.py:125-235). The wrap padding of the tail batch is dropped, so it
    trains on its valid rows only. ``stop_check`` is polled after every
    step; when it returns True the epoch ends early. Returns ``(state,
    meters, step)``."""
    pump = _MetricPump(objective_names, logger, log_every, device)
    n_images = 0
    if timer is not None:
        timer.start()
    for imgs, _labels, n_valid in loader:
        state, metrics = step_fn(state, to_device(imgs[:n_valid], device),
                                 generator)
        step += 1
        n_images += n_valid
        pump.push(step, n_valid, metrics)
        if stop_check is not None and stop_check():
            break
    pump.flush()
    _end_timed(timer, device, n_images)
    return state, pump.final_meters(), step


def train_epoch_device(dd, step_fn, state, device, generator, step, logger,
                       objective_names, epoch_index: int,
                       log_every: int = 1,
                       timer: Optional[StepTimer] = None, stop_check=None):
    """One epoch over a device-resident set (``data/device.py``): full
    batches gathered and flipped on the card, the leftovers as host
    batches. Returns ``(state, meters, step)``."""
    pump = _MetricPump(objective_names, logger, log_every, device)
    n_images = 0
    idx, tail_ids = dd.epoch_plan(epoch_index)
    if timer is not None:
        timer.start()
    stopped = False
    for batch in dd.batches(idx, generator):
        state, metrics = step_fn(state, batch, generator)
        step += 1
        n_images += dd.B
        pump.push(step, dd.B, metrics)
        if stop_check is not None and stop_check():
            stopped = True
            break
    if not stopped and len(tail_ids):
        host_rng = np.random.default_rng((dd.seed, epoch_index, 1 << 20))
        for imgs, n_valid in dd.tail_batches(tail_ids, host_rng):
            state, metrics = step_fn(state, to_device(imgs, device),
                                     generator)
            step += 1
            n_images += n_valid
            pump.push(step, n_valid, metrics)
            if stop_check is not None and stop_check():
                break
    pump.flush()
    _end_timed(timer, device, n_images)
    return state, pump.final_meters(), step


def evaluate(eval_fn, loader, objective_names,
             generator: Optional[torch.Generator] = None):
    """Eval losses (weighted by valid rows) and exact codebook usage over
    the whole loader (reference evaluate, main.py:238-332). The per-batch
    losses and the used-code union stay on the device and reach the host
    in one copy at the end."""
    keys = list(objective_names) + ["total_loss"]
    meters = {k: AverageMeter() for k in keys}
    rows, weights, union = [], [], {}
    for imgs, _labels, n_valid in loader:
        metrics, extras, _ = eval_fn(imgs[:n_valid], generator)
        rows.append(torch.stack([metrics[k].float() for k in keys]))
        weights.append(n_valid)
        for k, mask in extras.items():
            union[k] = union[k] | mask if k in union else mask
    if rows:
        for vals, w in zip(torch.stack(rows).cpu().tolist(), weights):
            for k, v in zip(keys, vals):
                meters[k].update(v, n=w)
    if union:
        if "used_mask_top" in union:
            usage = 0.5 * (union["used_mask_top"].float().mean() * 100.0
                           + union["used_mask_bottom"].float().mean() * 100.0)
        else:
            usage = union["used_mask"].float().mean() * 100.0
        m = AverageMeter()
        m.update(float(usage))
        meters["codebook_usage_percentage"] = m
    return meters


def run_training(args, device: DeviceLike = None) -> Dict[str, Any]:
    """The VQ/VAE training stage of ``main``; returns the results dict the
    prior stage and the final metrics read. Runs on ``device``, else
    ``args.device``, else ``cuda``."""
    check_supported(args)
    dev = resolve_device(device if device is not None
                         else getattr(args, "device", None))
    normalize = getattr(args, "normalize_inputs", False)
    train_ds, test_ds, input_size = get_dataset(
        args.dataset, data_dir=args.data_dir, normalize=normalize)
    if (not normalize) and getattr(args, "recons_objective", "mse") in {
            "mse", "l1", "smooth_l1", "perceptual"}:
        print("Warning: normalize_inputs=false with a tanh-range recons "
              "objective; consider --normalize_inputs (main.py:1131-1138).")
    args.dataset_size = len(train_ds)
    seed = getattr(args, "seed", 0) or 0
    batch_size = args.batch_size

    # the hot loop's loaders ship raw uint8 (cast on the device); the float
    # test_loader serves the final metric passes
    train_loader = Loader(train_ds, batch_size, shuffle=True, seed=seed,
                          raw=True)
    eval_loader = Loader(test_ds, batch_size, shuffle=False, raw=True)
    test_loader = Loader(test_ds, batch_size, shuffle=False)

    model = init_model(get_network(input_size, 3, args), seed=seed,
                       device=dev)
    args.total_params = sum(p.numel() for p in model.parameters()
                            if p.requires_grad)
    print(model_summary(model))
    for name, w in dict(model.lambda_weights).items():
        setattr(args, f"{name}_weight", w)

    dd = resolve_device_data(args, train_ds, batch_size, dev)
    steps_per_epoch = (dd.optimizer_steps_per_epoch() if dd is not None
                       else len(train_loader))
    sched = lr_schedule(args.lr, getattr(args, "scheduler", None),
                        args.epochs, steps_per_epoch,
                        lr_min=getattr(args, "scheduler_lr_min", 0.0),
                        gamma=getattr(args, "scheduler_gamma", 0.1),
                        milestones=getattr(args, "scheduler_milestones",
                                           None))
    tx = build_optimizer(args.optimizer, sched,
                         momentum=getattr(args, "momentum", 0.9),
                         weight_decay=getattr(args, "wd", 0.0) or 0.0,
                         max_grad_norm=getattr(args, "max_grad_norm", None))

    agg_cfg = aggregator_config_from_args(args, len(model.objective_names))
    if (agg_cfg.name == "nashmtl"
            and not getattr(args, "nashmtl_update_every", None)):
        # reference default: recompute the Nash weights once per epoch
        # (update_weights_every=len(train_loader), main.py:1230-1235)
        agg_cfg = AggregatorConfig(
            **{**agg_cfg.__dict__, "nashmtl_update_every": steps_per_epoch})
    args.aggregator = agg_cfg.name
    state = TrainState.create(model, tx, init_state(agg_cfg))

    save_root = os.path.join(args.save_path, args.dataset, args.arch,
                             args.optimizer, agg_cfg.name,
                             time.strftime("%Y%m%d_%H%M%S"))
    for sub in (("figures", "generated"), ("figures", "reconstructed"),
                ("checkpoints",)):
        os.makedirs(os.path.join(save_root, *sub), exist_ok=True)
    logger = ExperimentLogger(
        use_wandb=getattr(args, "use_wandb", False), save_dir=save_root,
        config=vars(args), project=getattr(args, "wandb_project", "mo-vae"),
        entity=getattr(args, "wandb_entity", None),
        name=getattr(args, "wandb_name", None),
        group=getattr(args, "wandb_group", None),
        tags=getattr(args, "wandb_tags", None))
    hv_indicator = build_hv_indicator(model.objective_names,
                                      getattr(args, "hv_ref", None))

    train_step = make_train_step(model, agg_cfg, args.epochs,
                                 steps_per_epoch, normalize_inputs=normalize)
    eval_fn = make_eval_step(model, normalize_inputs=normalize)
    # the step's draws (EMA restarts, aggregator choices, device flips)
    gen = torch.Generator(device=dev).manual_seed(seed)

    step = 0
    timer = StepTimer()
    train_losses, eval_losses = [], []
    log_every = getattr(args, "log_every", 1)
    num_vis = getattr(args, "num_vis_samples", 4)
    start_epoch = 1

    # resume from a last_checkpoint.pth: weights, optimizer moments, step
    # (so the lr schedule's position), aggregator state, the generator, and
    # the loader's epoch counter (the next epoch draws the permutation an
    # unbroken run would have drawn)
    resume_from = getattr(args, "resume", None)
    if resume_from:
        payload = ckpt_lib.load_checkpoint(resume_from)
        ckpt_lib.load_module_state(model, payload)
        state.optimizer.load_state_dict(payload["optimizer_state_dict"])
        state.agg_state = dict(payload.get("agg_state") or {})
        gen.set_state(payload["generator_state"])
        start_epoch = int(payload.get("epoch") or 0) + 1
        step = int(payload.get("step") or 0)
        state.step = step
        train_loader.epoch = start_epoch - 1
        print(f"Resumed from {resume_from} at epoch {start_epoch}")

    profile_dir = getattr(args, "profile_dir", None)
    prof = None
    if profile_dir:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if dev.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=activities)
        prof.__enter__()

    def stop_profile(epoch: int) -> None:
        nonlocal prof
        if prof is not None:
            prof.__exit__(None, None, None)
            os.makedirs(profile_dir, exist_ok=True)
            path = os.path.join(profile_dir, f"epoch_{epoch}_trace.json")
            prof.export_chrome_trace(path)
            print(f"Saved profiler trace of epoch {epoch} to {path}")
            prof = None

    # preemption: SIGTERM checkpoints at the next step boundary and exits
    # 143 so a retry can --resume
    guard = PreemptionGuard()

    def save_last(epoch_done: int) -> None:
        ref, extra = ckpt_lib.split_state_dict(model)
        ckpt_lib.save_checkpoint(ckpt_lib.last_checkpoint_path(save_root), {
            "epoch": epoch_done, "step": step,
            "model_state_dict": ref, "ema_state": extra,
            "optimizer_state_dict": state.optimizer.state_dict(),
            "agg_state": {k: v.detach().cpu()
                          for k, v in state.agg_state.items()},
            "generator_state": gen.get_state(),
            "args": ckpt_lib.args_echo(args)})

    for epoch in range(start_epoch, args.epochs + 1):
        if dd is not None:
            state, meters, step = train_epoch_device(
                dd, train_step, state, dev, gen, step, logger,
                model.objective_names, epoch_index=epoch,
                log_every=log_every, timer=timer,
                stop_check=lambda: guard.triggered)
        else:
            state, meters, step = train_epoch(
                train_step, state, train_loader, dev, gen, step, logger,
                model.objective_names, log_every=log_every, timer=timer,
                stop_check=lambda: guard.triggered)
        train_losses.append({k: v.avg for k, v in meters.items()})

        if guard.triggered:
            # this epoch did not complete: resume runs it again from the
            # mid-epoch weights
            save_last(epoch - 1)
            stop_profile(epoch)
            guard.uninstall()
            path = ckpt_lib.last_checkpoint_path(save_root)
            print(f"[movae_tpu_torch] preempted during epoch {epoch}: wrote "
                  f"resumable checkpoint ({path}); exiting 143. "
                  f"Continue with --resume {path}", flush=True)
            sys.exit(143)

        log_dict = {}
        if hv_indicator is not None:
            pt = np.array([[meters[k].avg for k in model.objective_names]])
            log_dict["train/hv"] = hv_indicator(pt)

        if (epoch % getattr(args, "save_freq", 10) == 0
                or epoch == args.epochs):
            _write_figures(model, test_ds, gen, save_root, epoch, num_vis,
                           normalize, logger, step, train_ds=train_ds)

        if epoch % getattr(args, "eval_freq", 1) == 0:
            eval_meters = evaluate(eval_fn, eval_loader,
                                   model.objective_names, gen)
            eval_losses.append({k: v.avg for k, v in eval_meters.items()})
            for k, v in eval_meters.items():
                log_dict[f"eval/{k}"] = v.avg
            if hv_indicator is not None:
                pt = np.array([[eval_meters[k].avg
                                for k in model.objective_names]])
                log_dict["eval/hv"] = hv_indicator(pt)
            loss_line = ", ".join(f"{k}: {v.avg:.6e}"
                                  for k, v in eval_meters.items())
            print(f"Epoch {epoch}/{args.epochs} eval: {loss_line}")

        if logger.active and log_dict:
            logger.log(log_dict, step=step)
        if epoch == start_epoch:
            stop_profile(epoch)
        # resumable checkpoint every save_freq epochs (the reference writes
        # only the final one, main.py:1422-1437)
        if (epoch % getattr(args, "save_freq", 10) == 0
                and epoch < args.epochs):
            save_last(epoch)

    guard.uninstall()
    print(f"Training done: {timer.images_per_sec:.1f} images/sec")

    final_path = ckpt_lib.final_checkpoint_path(save_root)
    ref, extra = ckpt_lib.split_state_dict(model)
    payload = {
        "epoch": args.epochs, "model_state_dict": ref,
        "args": ckpt_lib.args_echo(args),
        "train_losses": train_losses, "eval_losses": eval_losses,
        "best_eval_loss": min((e.get("total_loss", np.inf)
                               for e in eval_losses), default=None)}
    if extra:
        payload["ema_state"] = extra
    ckpt_lib.save_checkpoint(final_path, payload)
    print(f"Saved final checkpoint to {final_path}")

    results = {
        "save_root": save_root, "state": state, "model": model,
        "train_losses": train_losses, "eval_losses": eval_losses,
        "images_per_sec": timer.images_per_sec, "logger": logger,
        "test_loader": test_loader, "train_loader": train_loader,
        "normalize": normalize, "seed": seed, "device": dev,
        "step": step,
    }
    if resume_from:
        # a run preempted in the prior stage left a last_prior beside the
        # VQ checkpoint, and its code cache: the resumed prior continues on
        # the same code snapshot (extraction draws the loader's flips)
        old_root = os.path.dirname(os.path.dirname(
            os.path.abspath(resume_from)))
        pr = ckpt_lib.last_prior_path(old_root,
                                      getattr(args, "prior_type", "pixelcnn"))
        if os.path.exists(pr):
            results["prior_resume"] = pr
        if os.path.isdir(os.path.join(old_root, "codes_cache")):
            results["prior_cache_root"] = old_root
    return results


@torch.no_grad()
def _write_figures(model, test_ds, generator, save_root, epoch, num_vis,
                   normalized, logger, step, train_ds=None):
    """Per-epoch sample grid and test/train reconstruction panels at the
    reference's file names (main.py:1331-1366). A failed figure is printed
    and the run goes on, as in the JAX package."""
    dev = next(model.parameters()).device
    try:
        samples = model.sample(num_vis, generator=generator)
        png = fig_lib.save_sample_grid(
            samples.cpu().numpy(),
            os.path.join(save_root, "figures", "generated",
                         f"epoch_{epoch:04d}_random_samples.pdf"),
            normalized)
        logger.log_image("samples/generated", png, step=step)
    except Exception as e:
        print(f"figure generation failed: {e!r}")
    for split, ds in (("test", test_ds), ("train", train_ds)):
        if ds is None:
            continue
        try:
            imgs, _ = ds.get_batch(np.arange(min(num_vis, len(ds))))
            out = model(torch.from_numpy(imgs).to(dev), train=False,
                        generator=generator)
            png = fig_lib.save_reconstruction_panel(
                imgs, out["recons"].cpu().numpy(),
                os.path.join(save_root, "figures", "reconstructed",
                             f"epoch_{epoch:04d}_{split}_samples.pdf"),
                normalized)
            logger.log_image(f"samples/reconstructed_{split}", png,
                             step=step)
        except Exception as e:
            print(f"{split} reconstruction figure failed: {e!r}")
