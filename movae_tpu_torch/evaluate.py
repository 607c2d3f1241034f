"""Checkpoint evaluation CLI of the port — ``python -m
movae_tpu_torch.evaluate``.

The counterpart of the repo's ``evaluate.py``: load a ``.pth`` checkpoint
(the port's ``final_checkpoint.pth``, or the reference's; an orbax
checkpoint of the JAX package becomes one through
``scripts/export_torch_checkpoint.py``), rebuild the model from its saved
``args``, then print test losses, the hypervolume (fixed 1.1 reference
point), the reconstruction metrics (rFID/PSNR/SSIM/LPIPS) and, through the
prior found beside the checkpoint (uniform codes without one), the
generative metrics (gFID/IS/KID) as one table.

Usage: python -m movae_tpu_torch.evaluate --model_path <...>.pth
"""

from __future__ import annotations

import argparse
import json
from types import SimpleNamespace

import numpy as np
import torch

from movae_tpu_torch.data import Loader, get_dataset
from movae_tpu_torch.device import DeviceLike, resolve_device
from movae_tpu_torch.metrics.hv import build_hv_indicator
from movae_tpu_torch.models import get_network
from movae_tpu_torch.train import checkpoint as ckpt_lib
from movae_tpu_torch.train.final_metrics import (
    evaluate_generative_metrics, evaluate_recon_metrics)
from movae_tpu_torch.train.loop import evaluate as evaluate_losses
from movae_tpu_torch.train.prior import find_prior
from movae_tpu_torch.train.step import make_eval_step

try:
    from tabulate import tabulate
except ImportError:  # pragma: no cover - optional package
    tabulate = None


def load_model_from_checkpoint(model_path: str, dataset: str = None,
                               data_dir: str = "./data", arch: str = None,
                               device: DeviceLike = None):
    """``(model, args, train_ds, test_ds, normalize)`` from a ``.pth``.
    ``arch`` fills a checkpoint without one; against a saved arch that
    differs, the checkpoint wins with a warning (reference
    evaluate.py:48-59)."""
    dev = resolve_device(device)
    payload = ckpt_lib.load_checkpoint(model_path)
    args = SimpleNamespace(**dict(payload.get("args") or {}))
    if arch is not None:
        saved_arch = getattr(args, "arch", None)
        if saved_arch is not None and saved_arch.lower() != arch.lower():
            print(f"Warning: checkpoint arch ({saved_arch}) does not match "
                  f"provided arch ({arch}); using the checkpoint arch.")
        else:
            args.arch = arch
    if dataset is not None:
        args.dataset = dataset
    args.data_dir = data_dir
    normalize = getattr(args, "normalize_inputs", False)
    train_ds, test_ds, input_size = get_dataset(args.dataset, data_dir,
                                                normalize)
    args.dataset_size = len(train_ds)
    model = get_network(input_size, 3, args)
    ckpt_lib.load_module_state(model, payload)
    return model.to(dev), args, train_ds, test_ds, normalize


def print_results_table(results: dict):
    rows = [(k, f"{v:.6g}" if isinstance(v, float) else v)
            for k, v in results.items()]
    if tabulate is not None:
        print(tabulate(rows, headers=["metric", "value"], tablefmt="github"))
    else:  # pragma: no cover
        for k, v in rows:
            print(f"{k:40s} {v}")


def evaluate(arch: str = None, dataset: str = None, model_path: str = None,
             data_dir: str = "./data", batch_size: int = 128,
             max_fid_samples: int = 10000, skip_generative: bool = False,
             max_gen_metrics_samples: int = 10000, seed: int = 0,
             device: DeviceLike = None):
    model, args, _train_ds, test_ds, _ = load_model_from_checkpoint(
        model_path, dataset, data_dir, arch=arch, device=device)
    dev = next(model.parameters()).device
    test_loader = Loader(test_ds, batch_size, shuffle=False)
    recon_gen = torch.Generator(device=dev).manual_seed(seed)
    loss_meters = evaluate_losses(make_eval_step(model), test_loader,
                                  model.objective_names, recon_gen)
    results = {f"eval/{k}": v.avg for k, v in loss_meters.items()}

    hv = build_hv_indicator(model.objective_names, None)  # fixed 1.1 ref
    if hv is not None:
        pt = np.array([[loss_meters[k].avg for k in model.objective_names]])
        results["eval/hv"] = float(hv(pt))

    results.update({f"recon/{k}": v for k, v in evaluate_recon_metrics(
        model, test_loader, recon_gen, max_samples=max_fid_samples).items()})

    if not skip_generative:
        args.batch_size = batch_size
        args.max_gen_metrics_samples = max_gen_metrics_samples
        prior = find_prior(model_path, model, args)
        gen = torch.Generator(device=dev).manual_seed(seed + 1)
        results.update({f"gen/{k}": v for k, v in
                        evaluate_generative_metrics(
                            model, test_loader, args, prior, gen,
                            max_samples=max_gen_metrics_samples).items()})

    print_results_table(results)
    return results


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--model_path", type=str, required=True,
                   help="checkpoint file (e.g. .../final_checkpoint.pth)")
    p.add_argument("--arch", type=str, default=None)
    p.add_argument("--dataset", type=str, default=None)
    p.add_argument("--data_dir", type=str, default="./data")
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--max_fid_samples", type=int, default=10000)
    p.add_argument("--max_gen_metrics_samples", type=int, default=10000)
    p.add_argument("--skip_generative", action="store_true")
    p.add_argument("--out_json", type=str, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    p.add_argument("--num_workers", type=int, default=None,
                   help="(ignored)")
    a = p.parse_args()
    results = evaluate(a.arch, a.dataset, a.model_path, a.data_dir,
                       a.batch_size, a.max_fid_samples, a.skip_generative,
                       max_gen_metrics_samples=a.max_gen_metrics_samples,
                       seed=a.seed, device=a.device)
    if a.out_json:
        with open(a.out_json, "w") as f:
            json.dump(results, f, indent=2)


if __name__ == "__main__":
    main()
