"""Offline sample generation from a trained VQ-VAE and its prior —
``python -m movae_tpu_torch.generate_samples_pixelcnn_vqvae``.

The counterpart of the repo's ``generate_samples_pixelcnn_vqvae.py``: the
same flags, aliases and defaults, except ``--device`` (``cuda`` by
default, ``cpu`` for a CPU rehearsal). Rebuild the VQ model and the prior
from their checkpoints alone (the dataset files need not be present): the
prior's hyperparameters come from the VQ run's args, overridden by those
echoed in the prior checkpoint (``prior_args``), overridden by flags given
on the command line. Sample codes (``sample_hierarchical`` for a VQ-VAE-2,
``sample_prior`` otherwise, with ``--kv_cache_dtype`` for a PixelSNAIL:
given, else the prior checkpoint's, else int8), decode them, and write one
grid (``samples.pdf`` + PNG) or per-image PNGs (``--individual``) into
``--out_dir``. A seed repeats its images bit for bit, as the JAX CLI's
does: the generation runs under cuDNN's deterministic algorithms
(:func:`deterministic_cudnn`).
"""

from __future__ import annotations

import argparse
import contextlib
import os
from types import SimpleNamespace
from typing import Optional, Sequence

import numpy as np
import torch

from movae_tpu_torch.device import DeviceLike, resolve_device
from movae_tpu_torch.train import checkpoint as ckpt_lib
from movae_tpu_torch.train.figures import (_png_bytes, _to_display,
                                           save_sample_grid)
from movae_tpu_torch.train.final_metrics import generate_samples
from movae_tpu_torch.train.prior import HIERARCHICAL_ARCHS, build_prior
from movae_tpu_torch.train_prior_vqvae import load_vqvae


def load_models(model_path: str, prior_path: str, dataset=None,
                data_dir: str = "./data", prior_args=None,
                device: DeviceLike = None):
    """``(model, vq_args, prior)`` on ``device``; ``prior`` is
    ``{"model", "params", "hierarchical", "args"}``, ``args`` the merged
    view (VQ args < the prior checkpoint's echo < flags not None)."""
    model, vq_args, _, _ = load_vqvae(model_path, dataset, data_dir,
                                      need_data=False, device=device)
    dev = next(model.parameters()).device
    hierarchical = vq_args.arch.lower() in HIERARCHICAL_ARCHS
    payload = ckpt_lib.load_checkpoint(prior_path)
    saved = payload.get("prior_args") or {}
    explicit = {k: v for k, v in (prior_args or {}).items() if v is not None}
    merged = SimpleNamespace(**{**vars(vq_args), **saved, **explicit})
    prior_model = build_prior(merged, model.num_embeddings, hierarchical,
                              getattr(model, "embedding_dim", None))
    state = payload["model_state_dict"]
    prior_model.load_state_dict(state, strict=True)
    prior = {"model": prior_model.to(dev), "params": state,
             "hierarchical": hierarchical, "args": merged}
    return model, vq_args, prior


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN's deterministic algorithms, no autotuning; the flags restored
    after. The hierarchical prior's top-to-bottom upsampling and the
    VQ-VAE-2 decoder are transposed convolutions, which cuDNN may otherwise
    run with an algorithm that sums in no fixed order (on an H100, two
    calls on one input part by ~3e-8): enough to flip a Gumbel-max near a
    tie, so that a seed would not repeat its images."""
    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        yield
    finally:
        cudnn.deterministic, cudnn.benchmark = saved


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--model_path", "--vqvae_checkpoint",
                   "--vqvae2_checkpoint", type=str, required=True,
                   dest="model_path")
    p.add_argument("--prior_path", "--prior_checkpoint", type=str,
                   required=True, dest="prior_path")
    p.add_argument("--dataset", type=str, default=None)
    p.add_argument("--data_dir", type=str, default="./data")
    p.add_argument("--num_samples", type=int, default=16)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--kv_cache_dtype", type=str, default=None,
                   choices=["f32", "bf16", "int8"],
                   help="PixelSNAIL sampler KV-cache dtype; default: the "
                   "prior checkpoint's echoed prior_args, else int8")
    p.add_argument("--out_dir", "--output_dir", type=str,
                   default="generated_samples",
                   help="output directory (reference spelling: --output_dir)")
    p.add_argument("--grid", "--save_grid", action="store_true", default=True)
    p.add_argument("--individual", action="store_false", dest="grid",
                   help="save per-image PNGs instead of one grid")
    # prior hyperparameters: None = the prior checkpoint's echo or the VQ
    # run's args; given flags win
    p.add_argument("--prior_type", type=str, default=None)
    p.add_argument("--pixelcnn_hidden_channels", type=int, default=None)
    p.add_argument("--pixelcnn_num_layers", type=int, default=None)
    p.add_argument("--pixelsnail_num_blocks", type=int, default=None)
    p.add_argument("--pixelsnail_num_res_blocks", type=int, default=None)
    p.add_argument("--pixelsnail_num_heads", type=int, default=None)
    p.add_argument("--pixelsnail_dropout", type=float, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--grid_nrow", type=int, default=None,
                   help="images per grid row")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    return p


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Returns ``{"images": (N, H, W, C) array, "paths": [...]}``."""
    a = build_parser().parse_args(argv)
    dev = resolve_device(a.device)
    model, vq_args, prior = load_models(a.model_path, a.prior_path,
                                        a.dataset, a.data_dir, vars(a),
                                        device=dev)
    gen_args = SimpleNamespace(**{**vars(vq_args), **vars(a)})
    gen_args.pixelcnn_temperature = a.temperature
    if a.kv_cache_dtype is None:
        gen_args.kv_cache_dtype = getattr(prior["args"], "kv_cache_dtype",
                                          None) or "int8"
    with deterministic_cudnn():
        imgs = generate_samples(
            model, gen_args, prior,
            torch.Generator(device=dev).manual_seed(a.seed), a.num_samples,
            batch=a.batch_size)
    os.makedirs(a.out_dir, exist_ok=True)
    normalized = bool(getattr(vq_args, "normalize_inputs", False))
    if a.grid:
        paths = [save_sample_grid(imgs, os.path.join(a.out_dir,
                                                     "samples.pdf"),
                                  normalized, ncols=a.grid_nrow)]
        print(f"Saved grid to {paths[0]}")
    else:
        paths = []
        for i, img in enumerate(imgs):
            rgb = (_to_display(img, normalized) * 255).astype(np.uint8)
            if rgb.shape[-1] == 1:
                rgb = np.repeat(rgb, 3, axis=-1)
            paths.append(os.path.join(a.out_dir, f"sample_{i:05d}.png"))
            with open(paths[-1], "wb") as f:
                f.write(_png_bytes(rgb))
        print(f"Saved {len(imgs)} images to {a.out_dir}")
    return {"images": imgs, "paths": paths}


if __name__ == "__main__":
    main()
