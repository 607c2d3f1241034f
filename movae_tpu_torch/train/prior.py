"""Prior training stage (PixelCNN / PixelSNAIL over frozen VQ codes) — port
of ``movae_tpu/train/prior.py``, for the flat priors over a VQ-VAE's codes
and the hierarchical priors over a VQ-VAE-2's (top, bottom) codes.

Freeze the VQ model, extract its code grids (:func:`extract_codes`, the
nearest-code CUDA kernel on the card; cached by ``utils/codes_cache.py``),
and train the prior with Adam (``pixelcnn_lr``), a cosine over epochs to
1e-6 that steps once per epoch, global-norm clipping at 1.0, and the
best-epoch-loss rule. Under a ``save_root`` it writes the reference's
``<pixelcnn|pixelsnail>_prior/checkpoints/{best,final}_prior.pth`` and a
resumable ``last_prior.pth`` every epoch, exits 143 on SIGTERM, resumes,
logs ``prior/loss`` and draws ``prior_sample_every`` sample grids.
``compute_dtype`` bfloat16 builds the prior with bf16 layers (the flash
kernels' bf16 instances at L > 1024); ``grad_accum`` A accumulates A full
code batches into one update, as the JAX package's prior does.

Data-parallel over the stage-1 mesh's ``data`` ranks (``parallel``, from
``run_training`` under torchrun): each rank extracts its own loader slice
(a per-rank code cache), the slices are gathered into the global code set
in the loaders' interleaved order, and each rank trains on its slice of
every global batch (``CodeLoader(process_index=, process_count=)``, the
data index and size) with the gradients all-reduced over ``data``, the
dropout masks drawn for the global batch, and under ``--fsdp`` 1/N of the
large leaves and moments held at rest: the numbers of one device on the
whole batch. Rank 0 alone writes. With ``--context_parallel N`` the
mesh's ``seq`` axis carries the prior's trunk row-sharded where its N
ranks divide the grid's rows (each rank its rows, masked convolutions
exchanging halos; else the trunk whole on every rank) and its attention
as ring attention (``parallel/context.py``, ``ops/ring_attention.py``);
each rank's gradient is its part, summed over ``seq``; with
``--pipeline_parallel S`` the block stack(s) run as a GPipe pipeline over
``pipe`` (``parallel/pipeline.py``; ``--pipeline_microbatches M``, else
the largest divisor of the per-shard batch up to 2S), each stage holding
its blocks and their moments, the checkpoints in the reference layout.
The prior stays whole over ``model`` (the JAX package places it so
unless ``--fsdp``; the numbers are the same).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import sys
from types import SimpleNamespace
from typing import Any, Callable, Dict, List, Mapping, Optional

import numpy as np
import torch

from movae_tpu_torch.device import DeviceLike, resolve_device
from movae_tpu_torch.models.base import resolve_compute_dtype
from movae_tpu_torch.models.pixelcnn import (HierarchicalPixelCNN,
                                             HierarchicalPixelSNAIL,
                                             PixelCNN, PixelSNAIL,
                                             warn_long_seq_dropout)
from movae_tpu_torch.moo import engine
from movae_tpu_torch.parallel import holder as holder_lib
from movae_tpu_torch.parallel import mesh as mesh_lib
from movae_tpu_torch.parallel import pipeline as pp_lib
from movae_tpu_torch.parallel.context import context_parallel
from movae_tpu_torch.train import checkpoint as ckpt_lib
from movae_tpu_torch.train.optim import build_optimizer, lr_schedule
from movae_tpu_torch.train.step import (accum_groups, accumulate,
                                        optimizer_steps, preprocess_batch)
from movae_tpu_torch.utils.codes import CodeLoader
from movae_tpu_torch.utils.codes_cache import get_or_extract_codes
from movae_tpu_torch.utils.preemption import PreemptionGuard

HIERARCHICAL_ARCHS = ("vq_vae2", "gg_vq_vae2")


def _get(args, name: str, default=None):
    if isinstance(args, Mapping):
        return args.get(name, default)
    return getattr(args, name, default)


def build_prior(args, num_embeddings: int, hierarchical: bool = False,
                embedding_dim: Optional[int] = None):
    """Prior construction per args (the JAX package's ``build_prior``). The
    code-embedding width follows a prior checkpoint's echo, then the VQ
    model's ``embedding_dim``, then the args' echo, then 64. The module's
    weights are not initialized: call ``reset_parameters``."""
    dtype = resolve_compute_dtype(_get(args, "compute_dtype", "float32")
                                  or "float32")
    d = (_get(args, "prior_embedding_dim") or embedding_dim
         or _get(args, "embedding_dim") or 64)
    hc = _get(args, "pixelcnn_hidden_channels", 128)
    nl = _get(args, "pixelcnn_num_layers", 15)
    if _get(args, "prior_type", "pixelcnn") == "pixelsnail":
        snail = dict(
            num_res_blocks_per_layer=_get(args, "pixelsnail_num_res_blocks",
                                          2),
            num_heads=_get(args, "pixelsnail_num_heads", 8),
            dropout=_get(args, "pixelsnail_dropout", 0.1),
            attn_dropout_mode=_get(args, "attention_dropout", "output")
            or "output")
        blocks = _get(args, "pixelsnail_num_blocks", 8)
        if hierarchical:
            return HierarchicalPixelSNAIL(
                num_embeddings=num_embeddings, embedding_dim=d,
                hidden_channels=hc, num_blocks_top=blocks,
                num_layers_bottom=nl, dtype=dtype, **snail)
        return PixelSNAIL(num_embeddings=num_embeddings, embedding_dim=d,
                          hidden_channels=hc, num_blocks=blocks, dtype=dtype,
                          **snail)
    cls = HierarchicalPixelCNN if hierarchical else PixelCNN
    return cls(num_embeddings=num_embeddings, embedding_dim=d,
               hidden_channels=hc, num_layers=nl, dtype=dtype)


def extract_codes(model, normalize_inputs: bool = False,
                  hierarchical: bool = False) -> Callable[[Any], Any]:
    """Frozen-VQ code extraction: returns ``extract(images)`` mapping an
    NHWC batch (uint8 or float, numpy or tensor) to its (B, h, w) int32
    code grid on the model's device, through ``get_code_indices`` (one
    nearest-code launch per batch on the card); with ``hierarchical``, a
    VQ-VAE-2's (top, bottom) grids through ``get_code_indices_pair`` (two
    launches per batch)."""
    device = next(model.parameters()).device

    @torch.no_grad()
    def extract(imgs):
        x = preprocess_batch(torch.as_tensor(imgs).to(device),
                             normalize_inputs)
        if hierarchical:
            top, bottom = model.get_code_indices_pair(x)
            return top.to(torch.int32), bottom.to(torch.int32)
        return model.get_code_indices(x).to(torch.int32)

    return extract




def prior_args_echo(args, embedding_dim: Optional[int] = None
                    ) -> Dict[str, Any]:
    """Prior hyperparameters echoed into prior checkpoints (``prior_args``),
    so a loader rebuilds the module without the flags; the JAX package's
    keys, layout stamp included."""
    keys = ("prior_type", "pixelcnn_hidden_channels", "pixelcnn_num_layers",
            "pixelsnail_num_blocks", "pixelsnail_num_res_blocks",
            "pixelsnail_num_heads", "pixelsnail_dropout", "attention_dropout")
    echo = {k: _get(args, k) for k in keys if _get(args, k) is not None}
    # the attention output flattens dim-major, as the reference's does
    echo["attn_out_layout"] = "dim_major"
    if embedding_dim is not None:
        echo["prior_embedding_dim"] = int(embedding_dim)
    return echo


def _count(state: Mapping[str, Any], pattern: str) -> int:
    i = 0
    while pattern.format(i) in state:
        i += 1
    return i


def prior_args_from_state(state: Mapping[str, Any], hierarchical: bool
                          ) -> Dict[str, Any]:
    """The shape-inferable prior hyperparameters of a reference prior
    ``state_dict`` (which carries no args echo); ``num_heads`` is not
    inferable and comes from the VQ run's args."""
    p = "prior_top." if hierarchical else ""
    emb = state["embedding_top.weight" if hierarchical else "embedding.weight"]
    conv_in = state[("prior_bottom." if hierarchical else "") +
                    "conv_in.weight"]
    out = {"prior_embedding_dim": int(emb.shape[1]),
           "pixelcnn_hidden_channels": int(conv_in.shape[0])}
    if f"{p}blocks.0.out_conv.weight" in state:
        out["prior_type"] = "pixelsnail"
        out["pixelsnail_num_blocks"] = _count(state,
                                              p + "blocks.{}.out_conv.weight")
        out["pixelsnail_num_res_blocks"] = _count(
            state, p + "blocks.0.res_blocks.{}.conv1.weight")
    else:
        out["prior_type"] = "pixelcnn"
    bottom = "prior_bottom." if hierarchical else ""
    if hierarchical or out["prior_type"] == "pixelcnn":
        out["pixelcnn_num_layers"] = _count(
            state, bottom + "res_blocks.{}.conv1.weight")
    return out


def find_prior(model_path: str, model, vq_args) -> Optional[Dict[str, Any]]:
    """The trained prior beside a model checkpoint
    (``<save_root>/<pixelcnn|pixelsnail>_prior/checkpoints/{best,final}_
    prior.pth``, the port's or the reference's), built on the model's
    device; ``None`` (uniform-code sampling) when there is none."""
    if not hasattr(model, "num_embeddings"):
        return None
    arch = (_get(vq_args, "arch", "") or "").lower()
    hier = arch in HIERARCHICAL_ARCHS
    save_root = os.path.dirname(os.path.dirname(os.path.abspath(model_path)))
    device = next(model.parameters()).device
    for prior_dir in ("pixelcnn_prior", "pixelsnail_prior"):
        for name in ("best_prior", "final_prior"):
            path = os.path.join(save_root, prior_dir, "checkpoints",
                                f"{name}.pth")
            if not os.path.isfile(path):
                continue
            try:
                payload = ckpt_lib.load_checkpoint(path)
                state = payload.get("model_state_dict", payload)
                p_args = (payload.get("prior_args")
                          or prior_args_from_state(state, hier))
                merged = SimpleNamespace(**{**vars(vq_args), **p_args})
                if "pixelsnail" in prior_dir:
                    merged.prior_type = "pixelsnail"
                prior = build_prior(merged, model.num_embeddings, hier,
                                    getattr(model, "embedding_dim", None))
                prior.load_state_dict(state, strict=True)
                print(f"Using prior checkpoint {path} for generation")
                return {"model": prior.to(device), "params": state,
                        "hierarchical": hier}
            except Exception as e:  # the JAX package's rule: report, go on
                print(f"prior load failed ({path}): {e!r}")
    return None


def _check_supported(args) -> None:
    if (int(_get(args, "grad_accum", 1) or 1) > 1
            and int(_get(args, "steps_per_dispatch", 1) or 1) > 1):
        raise ValueError(
            "--grad_accum and --steps_per_dispatch are mutually exclusive "
            "(an accumulation group is already one dispatch)")
    pp_lib.check_composition(SimpleNamespace(**{
        k: _get(args, k, 1) for k in ("pipeline_parallel",
                                      "model_partitions",
                                      "context_parallel")}))


def parallel_for_prior(args, device) -> Optional[mesh_lib.DataParallel]:
    """The prior's parallel config where the caller gave none: the JAX
    package's mesh over the ranks with ``--context_parallel`` and
    ``--pipeline_parallel`` (``ValueError`` where they do not divide the
    ranks); None with both at 1 (each process trains on its own)."""
    cp = int(_get(args, "context_parallel", 1) or 1)
    pp = int(_get(args, "pipeline_parallel", 1) or 1)
    if cp * pp == 1:
        return None
    mesh_lib.init_distributed(device)
    return mesh_lib.DataParallel(
        mesh_lib.make_mesh(num_seq=cp, num_pipe=pp, device=device),
        fsdp=bool(_get(args, "fsdp", False)))


def _cpu_state(module: torch.nn.Module) -> Dict[str, torch.Tensor]:
    return {k: v.detach().cpu().clone()
            for k, v in module.state_dict().items()}


def train_prior_on_levels(levels: Mapping[str, np.ndarray], model_meta, args,
                          device: DeviceLike = None,
                          step_trace: Optional[List[float]] = None,
                          prior: Optional[torch.nn.Module] = None,
                          save_root: Optional[str] = None,
                          logger=None, resume: Optional[str] = None,
                          vq_model=None, parallel=None) -> Dict[str, Any]:
    """Train a prior on frozen code grids; returns ``{"model" (the last
    epoch's weights), "params" (the best epoch's state_dict on the CPU),
    "hierarchical"}``.

    ``levels``: ``{"codes": (N, H, W) int array}`` for a flat prior, or
    ``{"top": (N, h, w), "bottom": (N, 2h, 2w)}`` for a hierarchical one
    (one shuffled order serves both arrays; the step's loss is the sum of
    the two levels' CE). ``model_meta``: the VQ model (or anything with
    ``num_embeddings`` and ``embedding_dim``).
    ``prior``: a prior module to train as it stands (for example with
    weights loaded from the JAX package); by default one is built from
    ``args`` and initialized from ``seed``. Dropout draws come from a
    generator seeded with ``seed + 1``. ``step_trace`` receives every
    step's CE (the loop syncs with the device once every 8 steps to fetch
    them). Runs on ``cuda`` unless ``device`` says otherwise.

    With ``save_root``: ``best_prior.pth`` on each new best epoch loss,
    ``last_prior.pth`` (with the optimizer and generator states) after
    every epoch, ``final_prior.pth`` at the end, SIGTERM -> ``last_prior``
    and exit 143, ``prior/loss`` to ``logger``, and every
    ``prior_sample_every`` epochs a sample grid decoded by ``vq_model``.
    ``resume`` (else ``args.prior_resume``) names a ``last_prior.pth`` to
    continue from; a path that does not exist is ignored, as in the JAX
    package.

    ``grad_accum`` A: full batches accumulate in groups of A into one
    update (gradients ``acc + g / A`` in float32, the loss the microbatch
    mean); a group's leftovers and the ragged tail run as single updates,
    and the per-epoch cosine counts optimizer steps. ``steps_per_dispatch``
    k gives the numbers of k single steps, as the JAX package's scanned
    step does; the loop already queues steps with no host synchronisation
    between them (it reads the losses every 8 steps).

    ``parallel`` (a ``DataParallel`` over the ranks): ``levels`` is the
    global code set on every rank and ``batch_size`` the global batch;
    each rank trains on its interleaved slice of every batch (see the
    module docstring), rank 0 writes.
    """
    _check_supported(args)
    dev = resolve_device(device)
    if parallel is None:
        parallel = parallel_for_prior(args, dev)
    ctx = contextlib.nullcontext()
    if parallel is not None and parallel.mesh.shape["seq"] > 1:
        ctx = context_parallel()
    with ctx, mesh_lib.using(parallel.mesh if parallel is not None
                             else None):
        return _train_on_levels(levels, model_meta, args, dev, step_trace,
                                prior, save_root, logger, resume, vq_model,
                                parallel)


def _train_on_levels(levels, model_meta, args, dev, step_trace, prior,
                     save_root, logger, resume, vq_model, parallel
                     ) -> Dict[str, Any]:
    hierarchical = "codes" not in levels
    names = ("top", "bottom") if hierarchical else ("codes",)
    seed = int(_get(args, "seed", 0) or 0)
    epochs = int(_get(args, "pixelcnn_epochs", 100))
    lr = float(_get(args, "pixelcnn_lr", 3e-4))
    wd = float(_get(args, "pixelcnn_weight_decay", 0.0) or 0.0)
    eps = float(_get(args, "pixelcnn_adam_eps", 1e-8) or 1e-8)
    prior_type = _get(args, "prior_type", "pixelcnn")
    sample_every = int(_get(args, "prior_sample_every", 0) or 0)
    lead = mesh_lib.process_index() == 0
    rank, world = 0, 1
    if parallel is not None:
        rank, world = mesh_lib.data_index(), mesh_lib.data_size()
    batch = int(_get(args, "batch_size"))
    if batch % world:
        raise ValueError(f"--batch_size {batch} (the global batch) must be "
                         f"divisible by the {world} data ranks")
    loader = CodeLoader({k: np.asarray(levels[k]) for k in names},
                        batch // world, shuffle=True, seed=seed,
                        process_index=rank, process_count=world)

    if prior is None:
        prior = build_prior(args, model_meta.num_embeddings, hierarchical,
                            getattr(model_meta, "embedding_dim", None))
        prior.reset_parameters(torch.Generator().manual_seed(seed))
    prior = prior.to(dev)
    if parallel is not None:
        parallel.replicate(prior)
    grid = levels[names[0]]
    warn_long_seq_dropout(prior, grid.shape[1], grid.shape[2])
    gen = torch.Generator(device=dev).manual_seed(seed + 1)

    # the per-epoch cosine: the LR is constant within an epoch, whose
    # length counts optimizer steps (full batches in groups of A under
    # grad_accum, the leftovers and the ragged tail as single updates)
    accum_k = int(_get(args, "grad_accum", 1) or 1)
    n_batches = max(len(loader), 1)
    spe = optimizer_steps(min(n_batches, loader.n // batch), n_batches,
                          accum_k)
    recipe = build_optimizer(
        "adamw" if wd else "adam",
        lr_schedule(lr, "cosine", epochs, spe, lr_min=1e-6),
        weight_decay=wd, max_grad_norm=1.0, eps=eps)
    pipe = None
    pp_n = parallel.mesh.shape["pipe"] if parallel is not None else 1
    if pp_n > 1:
        if parallel.fsdp and lead:
            print("[movae_tpu_torch] note: --fsdp does not apply to the "
                  "pipelined prior — the block stack is stage-sharded "
                  "over 'pipe' (the bigger at-rest saving) and the "
                  "prologue/head params stay replicated", flush=True)
        per_shard = batch // world
        pp_m = (int(_get(args, "pipeline_microbatches", 0) or 0)
                or pp_lib.default_microbatches(per_shard, pp_n))
        if pp_m < pp_n and lead:
            print(f"[movae_tpu_torch] pipeline_parallel={pp_n} got only "
                  f"{pp_m} microbatch(es) from the per-shard batch "
                  f"{per_shard} (bubble {(pp_n - 1) / (pp_m + pp_n - 1):.0%});"
                  f" raise --batch_size or set --pipeline_microbatches",
                  flush=True)
        if batch % (world * pp_m):
            raise ValueError(f"batch {batch} must divide by data_parallel*"
                             f"microbatches ({world}*{pp_m})")
        holder = pipe = pp_lib.PipelinedPrior(prior, pp_m, train=True,
                                              remat=True)
    elif parallel is not None and parallel.fsdp:
        holder = parallel.shard_params(prior)
    else:
        holder = holder_lib.Holder(prior.parameters())
    params = holder.params
    opt = recipe.init(holder.shards)
    # where the holder splits leaves the optimizer clips the slices'
    # gradients as one vector, their squares summed over their axes
    clip_axes = holder.clip_axes()
    step_recipe = (recipe if clip_axes is None
                   else dataclasses.replace(recipe, max_grad_norm=None))
    whole = holder.whole

    def full_optimizer_state() -> dict:
        return holder.full_optimizer_state(opt.state_dict())
    echo = prior_args_echo(args, prior.embedding_dim)

    start_epoch, step, best_loss = 1, 0, float("inf")
    resume = resume or _get(args, "prior_resume")
    if resume and os.path.exists(resume):
        payload = ckpt_lib.load_checkpoint(resume)
        with whole(load=True):
            prior.load_state_dict(payload["model_state_dict"])
        opt_sd = holder.local_optimizer_state(
            payload["optimizer_state_dict"])
        if opt_sd is not None:
            opt.load_state_dict(opt_sd)
        elif lead:
            print(f"[movae_tpu_torch] {resume}: its optimizer state "
                  f"is another pipeline's; the moments start afresh")
        gen.set_state(payload["generator_state"])
        start_epoch = int(payload.get("epoch") or 0) + 1
        step = int(payload.get("step") or 0)
        best_loss = float(payload.get("best_loss", float("inf")))
        loader.epoch = start_epoch - 1
        print(f"Resumed prior from {resume} at epoch {start_epoch}")
    with whole():
        best_params = _cpu_state(prior)

    guard = PreemptionGuard() if save_root is not None else None

    def save(path: str, epoch_done: int, params, loss: float, **extra):
        if lead:
            ckpt_lib.save_checkpoint(path, {
                "epoch": epoch_done, "model_state_dict": params,
                "loss": loss, "prior_args": echo, **extra})

    def save_last(epoch_done: int, loss: float) -> None:
        # the gathers are collectives; rank 0 alone writes
        with whole():
            state = _cpu_state(prior)
        save(ckpt_lib.last_prior_path(save_root, prior_type), epoch_done,
             state, loss, step=step, best_loss=best_loss,
             optimizer_state_dict=full_optimizer_state(),
             generator_state=gen.get_state())

    def prior_loss(codes) -> torch.Tensor:
        """This rank's loss; its dropout masks are drawn for the global
        batch (the rank keeps its rows)."""
        if parallel is None:
            return prior.loss_function(*codes, train=True,
                                       generator=gen)["total_loss"]
        with parallel.activate():
            return prior.loss_function(*codes, train=True,
                                       generator=gen)["total_loss"]

    def loss_and_grads(codes):
        """This rank's loss and its gradients of ``params`` (the pipeline:
        its stage's, forward and backward at once)."""
        if pipe is not None:
            with parallel.activate():
                return pipe.loss_and_grads(codes, gen)
        loss = prior_loss(codes)
        return loss.detach(), [
            torch.zeros_like(p) if g is None else g for p, g in zip(
                params, torch.autograd.grad(loss, params,
                                            allow_unused=True))]

    def apply(grads) -> None:
        """One optimizer update from this rank's gradients: their mean over
        the data ranks, cut to this rank's slices (fsdp) and clipped as one
        vector where the holder splits leaves (fsdp, the pipeline's
        stages)."""
        if parallel is not None:
            grads = engine.all_reduce_mean(grads)
            # each seq rank's gradient is its part of the whole (a
            # row-sharded trunk's rows'; a whole trunk's 1/S, so the sum
            # is the replicas' mean): the sum is the whole, the same on
            # every rank
            grads = mesh_lib.all_reduce_sum(grads, "seq")
        grads = holder.slice_grads(grads)
        if clip_axes is not None:
            grads = mesh_lib.clip_by_global_norm(grads, clip_axes,
                                                 recipe.max_grad_norm)
        for p, g in zip(holder.shards, grads):
            p.grad = g
        step_recipe.step(opt, step)

    avg = float("nan")
    for epoch in range(start_epoch, epochs + 1):
        total, count = 0.0, 0
        pending = []  # losses fetched in groups, not one sync per step

        def flush():
            nonlocal total, count
            if pending:
                values = torch.stack([loss for loss, _ in pending]).tolist()
                for value, (_, w) in zip(values, pending):
                    total += value * w
                    count += w
                    if step_trace is not None:
                        step_trace.append(value)
                pending.clear()

        def update(batches) -> None:
            nonlocal step
            losses = []
            holder.gather()
            if len(batches) == 1:
                codes = [torch.from_numpy(batches[0][0][k]).to(dev)
                         for k in names]
                loss, grads = loss_and_grads(codes)
                losses.append(loss)
            else:
                grads = [torch.zeros_like(p) for p in params]
                for batch, _ in batches:
                    codes = [torch.from_numpy(batch[k]).to(dev)
                             for k in names]
                    loss, g = loss_and_grads(codes)
                    accumulate(grads, g, 1.0 / len(batches))
                    losses.append(loss)
            apply(grads)
            holder.release()
            step += 1
            mean = torch.stack(losses).mean()
            if parallel is not None:
                mean = engine.all_reduce_mean([mean])[0]
            pending.append((mean, sum(n for _, n in batches)))

        gb = batch
        for group in accum_groups(loader, accum_k, lambda b: b[1] == gb):
            update(group)
            if len(pending) >= 8:
                flush()
            if (guard is not None and mesh_lib.process_count() == 1
                    and guard.triggered):
                break
        flush()
        avg = total / max(count, 1)
        if guard is not None and guard.globally_triggered():
            save_last(epoch - 1, avg)
            guard.uninstall()
            path = ckpt_lib.last_prior_path(save_root, prior_type)
            print(f"[movae_tpu_torch] preempted during prior epoch {epoch}: "
                  f"wrote resumable checkpoint ({path}); exiting 143. "
                  f"Continue with --resume (main) or --prior_resume {path}",
                  flush=True)
            sys.exit(143)
        if logger is not None and logger.active:
            logger.log({"prior/loss": avg, "prior/epoch": epoch})
        if avg < best_loss:
            with whole():
                best_loss, best_params = avg, _cpu_state(prior)
            if save_root is not None:
                save(ckpt_lib.best_prior_path(save_root, prior_type), epoch,
                     best_params, best_loss)
        if save_root is not None:
            save_last(epoch, avg)
        if lead and (epoch % 10 == 0 or epoch == epochs):
            print(f"prior epoch {epoch}/{epochs}: CE={avg:.4f} "
                  f"(best {best_loss:.4f})")
        if (sample_every and save_root is not None and vq_model is not None
                and (epoch % sample_every == 0 or epoch == epochs)):
            with whole():
                _sample_figure(vq_model, args, prior, hierarchical,
                               save_root, epoch, seed, write=lead)

    # the later stages read the whole prior
    holder.finalize()
    if guard is not None:
        guard.uninstall()
        save(ckpt_lib.final_prior_path(save_root, prior_type), epochs,
             _cpu_state(prior), avg)
    return {"model": prior, "params": best_params,
            "hierarchical": hierarchical}


def _sample_figure(vq_model, args, prior, hierarchical: bool, save_root: str,
                   epoch: int, seed: int, write: bool = True) -> None:
    """A sample grid through the current prior (reference
    train_prior_vqvae.py ``--sample_every``), from its own generator so the
    training draws stay those of a run without figures. Every rank of a
    data-parallel run generates (sample-parallel); ``write`` saves."""
    from movae_tpu_torch.train import figures as fig_lib
    from movae_tpu_torch.train.final_metrics import (GEN_SEED_OFFSET,
                                                     generate_samples)

    try:
        n = min(int(_get(args, "num_samples", 16) or 16), 16)
        gen = torch.Generator(device=next(prior.parameters()).device)
        gen.manual_seed(seed + GEN_SEED_OFFSET)
        imgs = generate_samples(vq_model, args, {
            "model": prior, "hierarchical": hierarchical}, gen, n, batch=n)
        if write:
            fig_lib.save_sample_grid(imgs, os.path.join(
                save_root, "figures", "generated",
                f"prior_epoch_{epoch:04d}.pdf"),
                bool(_get(args, "normalize_inputs", False)))
    except Exception as e:  # the JAX package's rule: report, go on
        print(f"prior sample figure failed: {e!r}")


def gather_levels(levels: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Every rank's extracted codes as the global code set, in the loaders'
    interleaved order (rank p's i-th row is global row i P + p; the
    ranks' counts differ by at most one): the codes one process extracts
    from the whole train loader (a collective)."""
    world = mesh_lib.data_size()
    out = {}
    for name, local in levels.items():
        local = torch.from_numpy(np.ascontiguousarray(local, np.int32))
        n = torch.tensor([local.shape[0]])
        counts = [int(c) for c in mesh_lib.all_gather(n)]
        pad = local.new_zeros((max(counts), *local.shape[1:]))
        pad[:local.shape[0]] = local
        parts = mesh_lib.all_gather(pad)
        full = np.empty((sum(counts), *local.shape[1:]), np.int32)
        for p, (part, c) in enumerate(zip(parts, counts)):
            full[p::world] = part[:c].numpy()
        out[name] = full
    return out


def _train_prior_from_results(results: Mapping[str, Any], args
                              ) -> Dict[str, Any]:
    model = results["model"]
    save_root = results["save_root"]
    hierarchical = args.arch.lower() in HIERARCHICAL_ARCHS
    if results.get("prior_levels") is not None:
        # given code levels: no extraction sweep
        levels = results["prior_levels"]
    else:
        extract = extract_codes(model, results.get("normalize", False),
                                hierarchical)
        # a resumed run reads the interrupted run's cache: a new sweep
        # would draw other flips from the augmenting train loader
        cache_root = results.get("prior_cache_root") or save_root
        levels, _ = get_or_extract_codes(
            extract, results["train_loader"], cache_root, args.arch,
            args.dataset, model.num_embeddings, model.input_size,
            hierarchical,
            force_extract=getattr(args, "prior_force_extract_codes", False),
            use_cache=getattr(args, "prior_use_lmdb_codes", True))
        if results.get("parallel") is not None:
            with mesh_lib.using(results["parallel"].mesh):
                levels = gather_levels(levels)
    device = results.get("device")
    if device is None:
        device = next(model.parameters()).device
    out = train_prior_on_levels(
        levels, model, args, device=device,
        step_trace=results.get("prior_step_trace"), save_root=save_root,
        logger=results.get("logger"), resume=results.get("prior_resume"),
        vq_model=model if isinstance(model, torch.nn.Module) else None,
        parallel=results.get("parallel"))
    # generation uses the best epoch's weights, as in the JAX package
    out["model"].load_state_dict(out["params"])
    return out


def train_prior(source: Mapping[str, Any], *args, **kwargs
                ) -> Dict[str, Any]:
    """The prior stage, in two forms:

    * ``train_prior(results, args)`` — the JAX package's form, after
      ``run_training``: extract (or read the cached) codes of
      ``results["model"]`` over ``results["train_loader"]`` (or take
      ``results["prior_levels"]``), then :func:`train_prior_on_levels`
      under ``results["save_root"]``; the returned module holds the best
      epoch's weights.
    * ``train_prior(levels, model_meta, args, device=..., ...)`` —
      :func:`train_prior_on_levels` itself.
    """
    if "save_root" in source:
        return _train_prior_from_results(source, *args, **kwargs)
    return train_prior_on_levels(source, *args, **kwargs)
