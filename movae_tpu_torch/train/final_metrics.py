"""End-of-run metric passes: reconstruction and generative metrics — port
of ``movae_tpu/train/final_metrics.py``.

Collect test reconstructions -> rFID / PSNR / SSIM / LPIPS; generate samples
(prior-driven for VQ models, ``model.sample`` otherwise) and matched real
images -> gFID / IS / KID from one Inception feature pass each. The towers
run on the model's device; the feature statistics on the host.

``loader`` is any iterable of ``(imgs, labels, n_valid)`` with NHWC float
images (numpy arrays or tensors), the tuples the JAX package's ``Loader``
yields. Randomness comes from explicit ``torch.Generator`` objects on the
model's device. Each metric family catches its own failure, prints it and
reports nan, as the JAX package does.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from movae_tpu_torch.device import deterministic_cudnn
from movae_tpu_torch.metrics import features as feat_lib
from movae_tpu_torch.metrics import pixel as pixel_lib
from movae_tpu_torch.metrics.vgg import make_lpips_fn
from movae_tpu_torch.models.pixelcnn import sample_hierarchical, sample_prior
from movae_tpu_torch.parallel import mesh as mesh_lib
from movae_tpu_torch.parallel.context import (gather_sample_batch,
                                              get_sample_parallel,
                                              sample_parallel,
                                              shard_sample_batch)

# ``args.kv_cache_dtype`` -> the PixelSNAIL sampler's key/value cache dtype
KV_CACHE_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16,
                   "int8": torch.int8}
# the recon pass's pixel and LPIPS metrics: unweighted means of per-batch
# values over batches of this size, as the reference computes them
METRIC_BATCH = 128
# the two generators of run_final_metrics: the run seed plus these
RECON_SEED_OFFSET, GEN_SEED_OFFSET = 1, 2


def _device(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


@torch.no_grad()
def collect_recons(model, loader, generator: Optional[torch.Generator],
                   max_samples: int) -> Tuple[np.ndarray, np.ndarray]:
    """(real, recons) host arrays of the first ``max_samples`` valid images
    of ``loader`` and the model's eval-mode reconstructions of them."""
    dev = _device(model)
    reals, recons = [], []
    n = 0
    for imgs, _labels, n_valid in loader:
        r = model(torch.as_tensor(imgs).to(dev), train=False,
                  generator=generator)["recons"]
        reals.append(_host(imgs)[:n_valid])
        recons.append(_host(r)[:n_valid])
        n += n_valid
        if n >= max_samples:
            break
    return (np.concatenate(reals)[:max_samples],
            np.concatenate(recons)[:max_samples])


def evaluate_recon_metrics(model, loader, generator: Optional[torch.Generator],
                           max_samples: int = 10000) -> Dict[str, float]:
    """rFID / PSNR / SSIM / LPIPS over test reconstructions. The pixel
    metrics and LPIPS run in batches of 128 on the model's device and report
    the UNWEIGHTED mean of the per-batch values, as the reference does."""
    dev = _device(model)
    real, rec = collect_recons(model, loader, generator, max_samples)
    out: Dict[str, float] = {}
    bs = METRIC_BATCH
    psnr_vals, ssim_vals = [], []
    for i in range(0, len(real), bs):
        a = torch.from_numpy(real[i:i + bs]).to(dev)
        b = torch.from_numpy(rec[i:i + bs]).to(dev)
        psnr_vals.append(float(pixel_lib.psnr(a, b)))
        ssim_vals.append(float(pixel_lib.ssim(a, b)))
    out["psnr"] = float(np.mean(psnr_vals)) if psnr_vals else float("nan")
    out["ssim"] = float(np.mean(ssim_vals)) if ssim_vals else float("nan")
    try:
        lpips_fn = make_lpips_fn(device=dev)
        vals = [float(lpips_fn(real[i:i + bs], rec[i:i + bs]))
                for i in range(0, len(real), bs)]
        out["lpips"] = float(np.mean(vals)) if vals else float("nan")
    except Exception as e:  # reported as nan, as the JAX package does
        print(f"lpips failed: {e!r}")
        out["lpips"] = float("nan")
    try:
        rf = feat_lib.extract_inception_features(real, device=dev)
        ff = feat_lib.extract_inception_features(rec, device=dev)
        out["rfid"] = feat_lib.fid_from_features(rf, ff)
    except Exception as e:  # reported as nan, as the JAX package does
        print(f"rfid failed: {e!r}")
        out["rfid"] = float("nan")
    return out


@torch.no_grad()
def generate_samples(model, args, prior: Optional[Mapping[str, Any]],
                     generator: Optional[torch.Generator], num: int,
                     batch: int = 64) -> np.ndarray:
    """``num`` generated NHWC images on the host: prior-driven for VQ models
    (``prior = {"model": nn.Module, "hierarchical": bool}``), else
    ``model.sample``. A multi-chunk call samples every chunk at the one
    batch size ``batch`` and slices the tail on the host; a single-chunk
    call (``num <= batch``) samples exactly ``num``.

    Runs under ``device.py:deterministic_cudnn``, so one seed repeats its
    images on the card (the decoders' transposed convolutions would
    otherwise sum in no fixed order), as the generator CLIs do.

    Data-parallel over the ranks of a torchrun run: a sample-parallel
    config (``parallel/context.py``) is installed over every rank when none
    is active, so each rank samples its rows of every chunk, decodes them
    and the chunk is gathered; the draws are the global batch's, so the
    images are one device's. That gather is a COLLECTIVE: every rank calls
    this, and only the use of the result is gated on rank 0."""
    ctx = contextlib.nullcontext()
    if get_sample_parallel() is None and mesh_lib.data_size() > 1:
        ctx = sample_parallel(mesh_lib.current_mesh() or mesh_lib.make_mesh(
            device=_device(model)))
    with deterministic_cudnn(), ctx:
        return _generate_samples(model, args, prior, generator, num, batch)


def _generate_samples(model, args, prior, generator, num: int,
                      batch: int) -> np.ndarray:
    temperature = getattr(args, "pixelcnn_temperature", 1.0)
    cache_dtype = KV_CACHE_DTYPES[getattr(args, "kv_cache_dtype", "int8")]
    chunks = []
    n = 0
    while n < num:
        need = min(batch, num - n)
        b = batch if num > batch else need
        if prior is not None:
            pm = prior["model"]
            if prior["hierarchical"]:
                z_top, z_bottom = sample_hierarchical(
                    pm, generator, b, (model.latent_spatial_dim_top,) * 2,
                    (model.latent_spatial_dim_bottom,) * 2,
                    temperature=temperature, cache_dtype=cache_dtype)
                imgs = gather_sample_batch(model.decode_code(
                    shard_sample_batch(z_top), shard_sample_batch(z_bottom)),
                    b)
            else:
                s = model.latent_spatial_dim
                codes = sample_prior(pm, generator, b, s, s,
                                     temperature=temperature,
                                     cache_dtype=cache_dtype)
                imgs = gather_sample_batch(
                    model.decode_code(shard_sample_batch(codes)), b)
        else:
            imgs = model.sample(b, generator=generator)
        chunks.append(_host(imgs)[:need])
        n += need
    return np.concatenate(chunks)[:num]


def evaluate_generative_metrics(model, loader, args,
                                prior: Optional[Mapping[str, Any]],
                                generator: Optional[torch.Generator],
                                max_samples: int = 10000) -> Dict[str, float]:
    """gFID / IS / KID. The sample count is ``max_gen_metrics_samples`` (not
    ``max_fid_samples``, which only governs the recon pass); the real and
    generated sets are truncated to the smaller of the two before every
    metric. ``precision`` and ``recall`` are always present, as nan: the
    reference returns them but keeps their computation off."""
    dev = _device(model)
    num = min(max_samples, getattr(args, "max_gen_metrics_samples", 10000))
    out: Dict[str, float] = {k: float("nan") for k in (
        "gfid", "inception_score_mean", "inception_score_std",
        "precision", "recall", "kid")}
    if num <= 0:
        print(f"Warning: max_gen_metrics_samples is {num}, skipping "
              "generative metrics evaluation.")
        return out
    # prior sampling is per-pixel-latency bound: generate at up to 256/batch
    fake = generate_samples(model, args, prior, generator, num,
                            batch=min(max(args.batch_size, 64), 256))
    reals = []
    n = 0
    for imgs, _labels, n_valid in loader:
        reals.append(_host(imgs)[:n_valid])
        n += n_valid
        if n >= len(fake):
            break
    real = np.concatenate(reals)[: len(fake)]
    n = min(len(fake), len(real))
    if n < num:
        print(f"Warning: Only {n} samples available (requested {num}). "
              f"Using {n} samples for metrics.")
    fake, real = fake[:n], real[:n]
    try:
        rf = feat_lib.extract_inception_features(real, device=dev)
        ff = feat_lib.extract_inception_features(fake, device=dev)
        out["gfid"] = feat_lib.fid_from_features(rf, ff)
        out["kid"] = feat_lib.kid_from_features(rf, ff)
    except Exception as e:  # reported as nan, as the JAX package does
        print(f"gfid/kid failed: {e!r}")
    try:
        is_mean, is_std = feat_lib.calculate_inception_score(fake, device=dev)
        out["inception_score_mean"] = is_mean
        out["inception_score_std"] = is_std
    except Exception as e:  # reported as nan, as the JAX package does
        print(f"inception score failed: {e!r}")
    return out


def run_final_metrics(results: Mapping[str, Any], args,
                      prior: Optional[Mapping[str, Any]] = None
                      ) -> Dict[str, float]:
    """The final metric block: ``eval_<key>`` from the last entry of
    ``results["eval_losses"]``, then the recon and the generative metrics of
    ``results["model"]`` on ``results["test_loader"]``. The two passes draw
    from independent generators seeded from the run seed
    (``results["seed"]``, else ``args.seed``, else 0) plus fixed offsets."""
    model, loader = results["model"], results["test_loader"]
    seed = results.get("seed", getattr(args, "seed", 0))
    dev = _device(model)
    finals: Dict[str, float] = {}
    for k, v in (results.get("eval_losses") or [{}])[-1].items():
        finals[f"eval_{k}"] = v
    recon_gen = torch.Generator(device=dev).manual_seed(
        seed + RECON_SEED_OFFSET)
    gen_gen = torch.Generator(device=dev).manual_seed(seed + GEN_SEED_OFFSET)
    finals.update(evaluate_recon_metrics(
        model, loader, recon_gen,
        max_samples=getattr(args, "max_fid_samples", 10000)))
    finals.update(evaluate_generative_metrics(
        model, loader, args, prior, gen_gen,
        max_samples=getattr(args, "max_gen_metrics_samples", 10000)))
    return finals
