"""Prior training stage (PixelCNN / PixelSNAIL over frozen VQ codes) — port
of ``movae_tpu/train/prior.py``, for the flat priors over a VQ-VAE's codes
and the hierarchical priors over a VQ-VAE-2's (top, bottom) codes.

Freeze the VQ model, extract its code grids (:func:`extract_codes`, the
nearest-code CUDA kernel on the card), and train the prior with Adam
(``pixelcnn_lr``), a cosine over epochs to 1e-6 that steps once per epoch,
global-norm clipping at 1.0, and the best-epoch-loss rule
(:func:`train_prior`).

Not ported yet, each raising with its ``ROADMAP.md`` item:
``grad_accum > 1`` and bf16 compute (Queue 1 item 6), context / pipeline
parallelism and fsdp (item 13), checkpoints, preemption and resume under a
``save_root`` and periodic sample figures (item 12).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Mapping, Optional

import numpy as np
import torch

from movae_tpu_torch.device import DeviceLike, resolve_device
from movae_tpu_torch.models.pixelcnn import (HierarchicalPixelCNN,
                                             HierarchicalPixelSNAIL,
                                             PixelCNN, PixelSNAIL)
from movae_tpu_torch.train.optim import build_optimizer, lr_schedule
from movae_tpu_torch.train.step import preprocess_batch
from movae_tpu_torch.utils.codes import CodeLoader


def _get(args, name: str, default=None):
    if isinstance(args, Mapping):
        return args.get(name, default)
    return getattr(args, name, default)


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to movae_tpu_torch yet: ROADMAP.md {item}")


def build_prior(args, num_embeddings: int, hierarchical: bool = False,
                embedding_dim: Optional[int] = None):
    """Prior construction per args (the JAX package's ``build_prior``). The
    code-embedding width follows a prior checkpoint's echo, then the VQ
    model's ``embedding_dim``, then the args' echo, then 64. The module's
    weights are not initialized: call ``reset_parameters``."""
    dtype = _get(args, "compute_dtype", "float32")
    if dtype not in (None, "float32", torch.float32):
        raise _not_ported(f"compute_dtype {dtype!r} (bf16 compute)",
                          "Queue 1 item 6")
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
                num_layers_bottom=nl, **snail)
        return PixelSNAIL(num_embeddings=num_embeddings, embedding_dim=d,
                          hidden_channels=hc, num_blocks=blocks, **snail)
    cls = HierarchicalPixelCNN if hierarchical else PixelCNN
    return cls(num_embeddings=num_embeddings, embedding_dim=d,
               hidden_channels=hc, num_layers=nl)


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


def _check_supported(args, save_root: Optional[str]) -> None:
    if int(_get(args, "grad_accum", 1) or 1) > 1:
        raise _not_ported("grad_accum > 1", "Queue 1 item 6")
    if (int(_get(args, "context_parallel", 1) or 1) > 1
            or int(_get(args, "pipeline_parallel", 1) or 1) > 1
            or _get(args, "fsdp", False)):
        raise _not_ported("context / pipeline parallelism and fsdp",
                          "Queue 1 item 13")
    if save_root is not None or _get(args, "prior_resume"):
        raise _not_ported("prior checkpoints, preemption and resume",
                          "Queue 1 item 12")
    if _get(args, "prior_sample_every", 0):
        raise _not_ported("periodic prior sample figures (train/figures.py)",
                          "Queue 1 item 12")


def train_prior(levels: Mapping[str, np.ndarray], model_meta, args,
                device: DeviceLike = None,
                step_trace: Optional[List[float]] = None,
                prior: Optional[torch.nn.Module] = None,
                save_root: Optional[str] = None) -> Dict[str, Any]:
    """Train a prior on frozen code grids; returns ``{"model", "params" (the
    best epoch's state_dict), "hierarchical"}``.

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

    ``steps_per_dispatch`` is accepted and changes nothing: in JAX it fuses
    k steps into one dispatch with the same numbers, and eager PyTorch has
    no counterpart.
    """
    _check_supported(args, save_root)
    hierarchical = "codes" not in levels
    names = ("top", "bottom") if hierarchical else ("codes",)
    dev = resolve_device(device)
    seed = int(_get(args, "seed", 0) or 0)
    epochs = int(_get(args, "pixelcnn_epochs", 100))
    lr = float(_get(args, "pixelcnn_lr", 3e-4))
    wd = float(_get(args, "pixelcnn_weight_decay", 0.0) or 0.0)
    eps = float(_get(args, "pixelcnn_adam_eps", 1e-8) or 1e-8)
    loader = CodeLoader({k: np.asarray(levels[k]) for k in names},
                        int(_get(args, "batch_size")), shuffle=True,
                        seed=seed)

    if prior is None:
        prior = build_prior(args, model_meta.num_embeddings, hierarchical,
                            getattr(model_meta, "embedding_dim", None))
        prior.reset_parameters(torch.Generator().manual_seed(seed))
    prior = prior.to(dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)

    # the per-epoch cosine: the LR is constant within an epoch
    spe = max(len(loader), 1)
    recipe = build_optimizer(
        "adamw" if wd else "adam",
        lr_schedule(lr, "cosine", epochs, spe, lr_min=1e-6),
        weight_decay=wd, max_grad_norm=1.0, eps=eps)
    opt = recipe.init(list(prior.parameters()))

    def snapshot() -> Dict[str, torch.Tensor]:
        return {k: v.detach().clone() for k, v in prior.state_dict().items()}

    best_loss, best_params = float("inf"), snapshot()
    step = 0
    for epoch in range(1, epochs + 1):
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

        for batch, n_valid in loader:
            codes = [torch.from_numpy(batch[k]).to(dev) for k in names]
            loss = prior.loss_function(*codes, train=True,
                                       generator=gen)["total_loss"]
            opt.zero_grad(set_to_none=True)
            loss.backward()
            recipe.step(opt, step)
            step += 1
            pending.append((loss.detach(), n_valid))
            if len(pending) >= 8:
                flush()
        flush()
        avg = total / max(count, 1)
        if avg < best_loss:
            best_loss, best_params = avg, snapshot()
        if epoch % 10 == 0 or epoch == epochs:
            print(f"prior epoch {epoch}/{epochs}: CE={avg:.4f} "
                  f"(best {best_loss:.4f})")
    return {"model": prior, "params": best_params,
            "hierarchical": hierarchical}
