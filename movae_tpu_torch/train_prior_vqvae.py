"""Standalone prior training over a saved VQ-VAE —
``python -m movae_tpu_torch.train_prior_vqvae``.

The counterpart of the repo's ``train_prior_vqvae.py``: the same flags,
aliases and defaults, except ``--device``, which is ``cuda`` by default and
``cpu`` for a CPU rehearsal (no quiet fall back). Load a saved VQ-VAE
checkpoint (``.pth``; K and D inferred from its saved codebook), lay the
flags typed on the command line over the args saved in it (typed flags >
saved args > the parser's defaults), train a PixelCNN / PixelSNAIL prior on
its codes (``train/prior.py:train_prior``: extraction by the nearest-code
kernel, cached under the run), write ``figures/generated/
prior_samples.pdf`` (+ PNG) under the run, and with
``--max_gen_metrics_samples`` the ``final/*`` generative metrics into the
prior's log. ``--wandb_id`` downloads a run's checkpoint through ``wandb``
(raising when it is not installed).

Usage:
  python -m movae_tpu_torch.train_prior_vqvae --model_path \\
      <run>/checkpoints/final_checkpoint.pth --pixelcnn_epochs 50
"""

from __future__ import annotations

import argparse
import copy
import os
from types import SimpleNamespace
from typing import Optional, Sequence

import torch

from movae_tpu_torch.data import Loader, dataset_input_size, get_dataset
from movae_tpu_torch.device import DeviceLike, resolve_device
from movae_tpu_torch.models import get_network
from movae_tpu_torch.parallel import mesh as mesh_lib
from movae_tpu_torch.train import checkpoint as ckpt_lib
from movae_tpu_torch.train.figures import save_sample_grid
from movae_tpu_torch.train.final_metrics import generate_samples
from movae_tpu_torch.train.prior import HIERARCHICAL_ARCHS, train_prior
from movae_tpu_torch.utils.logging import ExperimentLogger

# the saved codebook of each VQ family (reference state_dict keys)
CODEBOOK_KEYS = ("vq_layer.embedding.weight", "quantize_t.embedding.weight")
# generation's generator seed offset from --seed (the JAX CLI's seed + 7)
SAMPLE_SEED_OFFSET = 7


def load_vqvae(model_path: str, dataset: Optional[str] = None,
               data_dir: str = "./data", need_data: bool = True,
               device: DeviceLike = None):
    """``(model on device, saved args, train_ds, test_ds)`` from a
    ``.pth`` checkpoint. ``need_data=False`` (the generators) rebuilds the
    model from the checkpoint alone when the dataset files are absent."""
    dev = resolve_device(device)
    payload = ckpt_lib.load_checkpoint(model_path)
    args = SimpleNamespace(**dict(payload.get("args") or {}))
    if dataset:
        args.dataset = dataset
    args.data_dir = data_dir
    normalize = getattr(args, "normalize_inputs", False)
    try:
        train_ds, test_ds, input_size = get_dataset(args.dataset, data_dir,
                                                    normalize)
        args.dataset_size = len(train_ds)
    except FileNotFoundError:
        if need_data:
            raise
        train_ds = test_ds = None
        input_size = dataset_input_size(args.dataset)
        args.dataset_size = getattr(args, "dataset_size", 50000) or 50000
    state = payload["model_state_dict"]
    for key in CODEBOOK_KEYS:
        if key in state:
            args.num_embeddings, args.embedding_dim = state[key].shape
            break
    model = get_network(input_size, 3, args)
    ckpt_lib.load_module_state(model, payload)
    return model.to(dev), args, train_ds, test_ds


def build_prior_parser(checkpoint_alias: str = "vqvae_checkpoint"
                       ) -> argparse.ArgumentParser:
    """The standalone prior trainers' parser: this repo's flag spellings
    and the reference's (--vqvae_checkpoint / --epochs / --lr /
    --hidden_channels / --num_layers / --temperature / --weight_decay /
    --output_dir / --sample_every); --num_workers and
    --prior_lmdb_map_size_gb are accepted no-ops."""
    p = argparse.ArgumentParser()
    p.add_argument("--model_path", f"--{checkpoint_alias}", type=str,
                   default=None, dest="model_path")
    p.add_argument("--dataset", type=str, default=None)
    p.add_argument("--data_dir", type=str, default="./data")
    p.add_argument("--save_root", "--output_dir", type=str, default=None,
                   dest="save_root",
                   help="defaults to the checkpoint's run directory")
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--prior_type", type=str, default="pixelcnn",
                   choices=["pixelcnn", "pixelsnail"])
    p.add_argument("--pixelcnn_epochs", "--epochs", type=int, default=100,
                   dest="pixelcnn_epochs")
    p.add_argument("--pixelcnn_hidden_channels", "--hidden_channels",
                   type=int, default=128, dest="pixelcnn_hidden_channels")
    p.add_argument("--pixelcnn_num_layers", "--num_layers", type=int,
                   default=15, dest="pixelcnn_num_layers")
    p.add_argument("--pixelcnn_lr", "--lr", type=float, default=3e-4,
                   dest="pixelcnn_lr")
    p.add_argument("--pixelcnn_weight_decay", "--weight_decay", type=float,
                   default=0.0, dest="pixelcnn_weight_decay")
    p.add_argument("--pixelcnn_temperature", "--temperature", type=float,
                   default=1.0, dest="pixelcnn_temperature")
    p.add_argument("--kv_cache_dtype", type=str, default="int8",
                   choices=["f32", "bf16", "int8"],
                   help="PixelSNAIL sampler KV-cache dtype")
    p.add_argument("--pixelsnail_num_blocks", type=int, default=8)
    p.add_argument("--pixelsnail_num_res_blocks", type=int, default=2)
    p.add_argument("--pixelsnail_num_heads", type=int, default=8)
    p.add_argument("--pixelsnail_dropout", type=float, default=0.1)
    p.add_argument("--attention_dropout", type=str, default="output",
                   choices=["output", "weights"],
                   help="prior attention-dropout semantics: output = the "
                   "flash path; weights = the reference's, on the dense "
                   "path only (L <= 1024)")
    p.add_argument("--context_parallel", type=int, default=1,
                   help="sequence-parallel partitions of the prior: "
                        "its trunk's rows and ring attention over a 'seq' "
                        "axis of the torchrun ranks")
    p.add_argument("--pipeline_parallel", type=int, default=1,
                   help="pipeline-parallel prior stages: GPipe over a "
                        "'pipe' axis of the torchrun ranks (data "
                        "parallelism only beside it)")
    p.add_argument("--pipeline_microbatches", type=int, default=0,
                   help="GPipe microbatches per step (0 = auto)")
    p.add_argument("--fsdp", action="store_true",
                   help="shard parameters and optimizer state over ranks: "
                        "the prior stage of a torchrun run of "
                        "movae_tpu_torch.main takes it; this CLI trains on "
                        "one process, where it changes nothing")
    p.add_argument("--prior_resume", type=str, default=None,
                   help="resume prior training from a last_prior.pth "
                        "(written every epoch and on SIGTERM)")
    p.add_argument("--prior_sample_every", "--sample_every", type=int,
                   default=0, dest="prior_sample_every",
                   help="write a prior sample grid every N epochs")
    p.add_argument("--prior_use_lmdb_codes", action="store_true", default=True)
    p.add_argument("--no_prior_lmdb_codes", action="store_false",
                   dest="prior_use_lmdb_codes")
    p.add_argument("--prior_force_extract_codes", action="store_true")
    p.add_argument("--num_samples", type=int, default=16)
    p.add_argument("--max_gen_metrics_samples", type=int, default=0,
                   help="if > 0, compute gFID/IS/KID over this many samples "
                        "after training")
    p.add_argument("--use_wandb", action="store_true")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    p.add_argument("--num_workers", type=int, default=None, help="(ignored)")
    p.add_argument("--prior_lmdb_map_size_gb", type=float, default=None,
                   help="(ignored; the code cache is memory-mapped .npy)")
    # a wandb run's checkpoint, downloaded (needs the wandb package)
    p.add_argument("--wandb_id", type=str, default=None)
    p.add_argument("--wandb_project", type=str, default="mo-vae")
    p.add_argument("--wandb_entity", type=str, default=None)
    return p


def explicit_cli_args(parser: argparse.ArgumentParser,
                      argv: Optional[Sequence[str]] = None) -> dict:
    """Dests the user actually typed: a re-parse with every default
    suppressed, so untouched flags are absent."""
    clone = copy.deepcopy(parser)
    for action in clone._actions:
        action.default = argparse.SUPPRESS
    ns, _unknown = clone.parse_known_args(argv)
    return vars(ns)


def merge_cli_over_saved(vq_args, a, explicit: Optional[dict] = None
                         ) -> SimpleNamespace:
    """Typed flags > checkpoint-saved args > the parser's defaults: a
    default must not clobber a saved value (the saved dataset keys the code
    cache; the saved prior hyperparameters rebuild the same prior).
    Without ``explicit``, every non-None flag counts as typed."""
    if explicit is None:
        explicit = {k: v for k, v in vars(a).items() if v is not None}
    defaults = {k: v for k, v in vars(a).items() if v is not None}
    merged = SimpleNamespace(**{**defaults, **vars(vq_args), **explicit})
    merged.arch = vq_args.arch
    return merged


def prior_log_dir(save_root: str, a) -> str:
    """The prior stage's log directory (<save_root>/<type>_prior, beside
    its checkpoints)."""
    name = ("pixelsnail_prior"
            if "pixelsnail" in (getattr(a, "prior_type", "") or "").lower()
            else "pixelcnn_prior")
    return os.path.join(save_root, name)


def resolve_checkpoint(a) -> str:
    """``--model_path`` itself, or a wandb run's final checkpoint
    downloaded into ``wandb_downloads/<id>`` (``--wandb_id``)."""
    if a.model_path:
        return a.model_path
    if a.wandb_id:
        import wandb  # raises without the package (and needs the network)

        api = wandb.Api()
        path = (f"{a.wandb_entity}/{a.wandb_project}/{a.wandb_id}"
                if a.wandb_entity else f"{a.wandb_project}/{a.wandb_id}")
        run = api.run(path)
        dl = os.path.join("wandb_downloads", a.wandb_id)
        os.makedirs(dl, exist_ok=True)
        for f in run.files():
            if "final_checkpoint" in f.name:
                f.download(root=dl, exist_ok=True)
        return os.path.join(dl, "checkpoints", "final_checkpoint.pth")
    raise SystemExit("provide --model_path/--vqvae_checkpoint or --wandb_id")


def run_post_prior_metrics(model, test_ds, merged, prior, seed: int, a,
                           logger) -> dict:
    """gFID / IS / KID of the trained prior's samples into the logger's
    summary as ``final/*`` (the command line's sample count wins)."""
    from movae_tpu_torch.train.final_metrics import (
        evaluate_generative_metrics)

    merged.max_gen_metrics_samples = a.max_gen_metrics_samples
    test_loader = Loader(test_ds, a.batch_size, shuffle=False)
    dev = next(model.parameters()).device
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    finals = evaluate_generative_metrics(
        model, test_loader, merged, prior, gen,
        max_samples=a.max_gen_metrics_samples)
    for k, v in finals.items():
        logger.set_summary(f"final/{k}", v)
        print(f"final/{k}: {v}")
    return finals


def run(argv: Optional[Sequence[str]], checkpoint_alias: str,
        hierarchical_only: bool) -> dict:
    """Both prior CLIs: returns ``{"prior", "merged", "save_root",
    "samples", "samples_png", "finals"}``. ``hierarchical_only`` refuses
    a flat VQ model, as the hierarchical CLI does."""
    parser = build_prior_parser(checkpoint_alias)
    a = parser.parse_args(argv)
    # under torchrun each rank drives its card; rank 0 writes
    dev = resolve_device(mesh_lib.rank_device(a.device))
    mesh_lib.init_distributed(dev)
    lead = mesh_lib.process_index() == 0
    ckpt_path = resolve_checkpoint(a)
    model, vq_args, train_ds, test_ds = load_vqvae(
        ckpt_path, a.dataset, a.data_dir, device=dev)
    if hierarchical_only and vq_args.arch.lower() not in HIERARCHICAL_ARCHS:
        raise ValueError(
            f"{vq_args.arch} is not hierarchical; use train_prior_vqvae")
    save_root = a.save_root or os.path.dirname(
        os.path.dirname(os.path.abspath(ckpt_path)))
    merged = merge_cli_over_saved(vq_args, a, explicit_cli_args(parser, argv))
    normalize = bool(getattr(vq_args, "normalize_inputs", False))
    # a run trained without --seed saved None, which wins over the default
    seed = int(merged.seed or 0)
    logger = ExperimentLogger(a.use_wandb and lead,
                              prior_log_dir(save_root, merged) if lead
                              else None, config=vars(merged))
    results = {"model": model, "save_root": save_root, "device": dev,
               "normalize": normalize, "logger": logger,
               "train_loader": Loader(train_ds, merged.batch_size,
                                      shuffle=True, seed=seed)}
    prior = train_prior(results, merged)

    gen = torch.Generator(device=dev).manual_seed(seed + SAMPLE_SEED_OFFSET)
    imgs = generate_samples(model, merged, prior, gen, merged.num_samples)
    png = None
    if lead:
        png = save_sample_grid(imgs, os.path.join(
            save_root, "figures", "generated", "prior_samples.pdf"),
            normalize)
        kind = "hierarchical prior" if prior["hierarchical"] else "prior"
        print(f"Saved {kind} samples to {png}")
    finals = {}
    if getattr(merged, "max_gen_metrics_samples", 0):
        finals = run_post_prior_metrics(model, test_ds, merged, prior,
                                        seed + SAMPLE_SEED_OFFSET, merged,
                                        logger)
    logger.finish()
    return {"prior": prior, "merged": merged, "save_root": save_root,
            "samples": imgs, "samples_png": png, "finals": finals}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    return run(argv, "vqvae_checkpoint", hierarchical_only=False)


if __name__ == "__main__":
    main()
