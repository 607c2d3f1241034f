#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port (``movae_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py              # from the root of a checkout
    python3 chip_smoke.py --profile    # adds a torch.profiler breakdown
    python3 chip_smoke.py --probe [dkv cudnn timings] [--parent DIR]
                                       # only the probes behind PERF.md

Phases, each of which fails the run:
  1. build every CUDA kernel of the main paths from the sources in the
     checkout (``build/kernels/``), one nvcc per library (the flash
     attention is one library per head dim), all at once; print each
     kernel's registers and spills (ptxas) and its SASS counts (HMMA, the
     tensor-core mma, FFMA, MUFU, LDS in ``cuobjdump -sass``, where the
     toolkit has it): the nearest-code and every flash kernel must have
     HMMA;
  2. hold the nearest-code kernel against its plain PyTorch version on the
     card at the main paths' shapes (plus a ragged N and K and small and
     large D), on a codebook with duplicated rows (the lowest index of each
     group of equal rows must win, exactly) and on rows of NaN (the index
     stays in range); time the kernel, the plain version and one PyTorch
     library call that computes the same function at stage 1's shape, at
     stage 2's extraction shape and at the VQ-VAE-2's two levels, by
     CUDA-graph replay (the host's launch path is not timed);
  2b. the same for the three causal flash-attention kernels (forward, dK/dV,
     dQ): output and gradients against the plain version at the prior's
     shape (B=16, H=8, L=4096, D=16), at L=4096, 1600 and 1025, and at
     every other head dim the kernels are built for; times at the prior's
     shape;
  3. drive the stage-1 path — full-width VQ-VAE training (hidden (128, 256),
     K=512, D=64, batch 256, 32x32, adam 1e-3, float32 with TF32 off) —
     with agg=sum and agg=upgrad, launch counts set to 0 just before and
     read just after: every kernel must have run on every forward;
  4. card vs CPU lockstep at a small width: 3 upgrad steps from one init
     must leave the parameters within 1e-4 of each other;
  5. drive the stage-2 path — code extraction through the full-width 256-px
     VQ-VAE (64x64 codes, L=4096), then PixelSNAIL prior training at full
     width (hidden 128, 8 blocks, 8 heads of 16) with batch 16 — counts set
     to 0 just before and read just after: 8 launches of each flash kernel
     per step and one nearest-code launch per extraction batch; then the
     flash kernels against their plain version on the trained prior's own
     q, k, v (its last attention layer);
  6. card vs CPU lockstep of the prior at a small width with L=1600:
     3 steps from one init within 1e-4;
  7. drive the 256-px VQ-VAE-2 path — the model of configs/celeba-hq/
     vq_vae2/{sum,upgrad}/mse/config_1.yaml at full width (channel 128,
     K=512, D=64, batch 128, uint8 inputs normalized) with agg=sum and
     agg=upgrad, then (top 32x32, bottom 64x64) code extraction — counts
     set to 0 just before and read just after: two nearest-code launches
     per forward and per extraction batch; then the kernel against its
     plain version on the trained model's latents at both levels;
  8. train the hierarchical prior those configs build (HierarchicalPixelCNN,
     15 layers, 128 channels, batch 32) on the extracted codes, then 3
     steps of HierarchicalPixelSNAIL, whose top attention at L=1024 is
     dense (no flash launch);
  9. sample: sample_hierarchical from the trained prior (batch 16; through
     sample_prior's dispatch, the wavefront sampler at both levels) decoded
     to 256-px images by VQVAE2.decode_code, and sample_fast_snail from
     phase 5's PixelSNAIL at 64x64 with the int8 and the float32 caches;
     at small grids, the cached samplers against sample_naive on the same
     noise (near ties excepted) and teacher-forced logits card vs CPU;
  10. card vs CPU lockstep of the VQ-VAE-2 at a small width: 3 steps of sum
     and of upgrad within 1e-4;
  11. stage 3, the metrics: the InceptionV3 and VGG16 towers (the port's
     fixed-seed random weights, or the files that MOVAE_INCEPTION_WEIGHTS /
     MOVAE_VGG16_WEIGHTS name) held on the card against themselves in
     float64 on the CPU (4 images: 32 px through both resize methods for
     Inception, 256 px for VGG16) and timed (Inception at 299 px, batch 128,
     preprocessing and tower apart; LPIPS on 256-px pairs, batch 128); then
     ``run_final_metrics`` on phase 7's VQ-VAE-2 and phase 8's hierarchical
     prior (512 seeded uint8 images normalized, batch 128; 256 generated
     images in 2 chunks of 128), counts set to 0 just before and read just
     after (two nearest-code launches a recon batch), with the wall time of
     each part; every final/* value finite (precision and recall nan, as in
     the JAX package), FID and KID >= 0, IS >= 1;
  12. (after phase 4) the aggregators on the stage-1 path: mgda, mgda_ln,
     mgda_gn, mgda_lgn, aligned_mtl and aligned_mtl_median each 3 untimed
     and 10 timed steps, with the overhead over sum and the host
     synchronisations a step; every other aggregator name 3 steps (finite
     losses and weights); the A/B of where the Frank–Wolfe and eigh solves
     run (on the host, the default; on the card; Frank–Wolfe as one CUDA
     graph), the step and the solve alone, the card's weights held against
     the host's; card vs CPU lockstep of mgda_ln and aligned_mtl;
  13. (after phase 12) the gradient-guided VQ models: gg_vq_vae_v3 at the
     width of configs/cifar100/gg_vq_vae_v3/mgda_ln/mse/config_1.yaml and
     gg_vq_vae2 at that of configs/celeba-hq/gg_vq_vae2/mgda_ln/mse/
     config_1.yaml, each with mgda_ln and upgrad, nearest-code launches
     counted; card vs CPU lockstep of each at a small width;
  14. (after phase 9, before 10 and 11) the wavefront sampler: under one
     Gumbel draw at batch 16, sample_wavefront against sample_fast on the
     trained hierarchical prior's top (32x32) and conditioned bottom
     (64x64) and at small grids (near ties excepted); a front's forced
     logits on the card against float64 on the CPU; the A/B of both
     samplers at 32x32 and 64x64, batch 16 and 128 (pixels/s; with
     --profile, launches and busy share per front and per raster pixel,
     at both batches).
     Phase 11's generation then runs through sample_prior's dispatch, its
     time printed beside the raster sampler's for the same pixels.
  15. (last) the CLI: 15a runs configs/celeba-hq/vq_vae2/sum/mse/
     config_1.yaml (full width; cut to a synthetic 256-px set, 2 epochs,
     1 prior epoch, 256-image final metrics: CLI_15A_CUTS) through
     ``movae_tpu_torch.runner.yaml_to_args`` and ``movae_tpu_torch.main``
     in-process, counts set to 0 just before and read just after (the
     nearest-code kernel launched, its plain version never called), with
     the wall time of each part; the JAX package's run tree, finite
     final/* values (precision and recall nan); then a resume from
     last_checkpoint.pth through ``python -m movae_tpu_torch.runner`` (it
     must start at epoch 2, step 8), the host loader against the
     device-resident set in alternating epochs with the host
     synchronisations a step, and ``python -m movae_tpu_torch.bench`` at
     stage 1 beside phase 3's step; 15b runs configs/imagenet/vq_vae/sum/
     mse/config_1.yaml with ``prior_type: pixelsnail`` (L = 4096, batch 16:
     CLI_15B_CUTS), counts set to 0 just before and read just after: every
     flash kernel 8 blocks x 8 prior steps, and the nearest-code kernel.
  16. (after 15) the VAE family, which reaches no kernel of the port:
     16a the vae of configs/imagenet/gg_vae/mgda/mse/config_1.yaml (the
     file's arch) and the gg_vae of configs/animal-face/gg_vae/mgda_ln/
     mse/config_1.yaml at that width (256 px, latent 4096, batch 128),
     16b configs/cifar100/vae/mgda/mse/config_1.yaml (batch 256), 16c
     BASELINE.json config 2's betatc_vae (32 px, batch 128), each under
     sum and its config's aggregator (16c aligned_mtl), not cut: step ms,
     images/s, host synchronisations a step, peak memory (--profile: busy
     share, top kernels); 16d card vs CPU locksteps of vae/mgda (3 steps)
     and cycle_vae, recursive_kl_vae, recursive_cyclic_vae (2 steps), the
     noise given to both, within 1e-4 (weights, running statistics,
     counters, losses); 16e configs/celeba-hq/vae/sum/mse/config_1.yaml
     through ``runner.yaml_to_args`` and ``main`` with 15a's cuts to
     final/* (generation by model.sample, no prior stage). Launch counts
     set to 0 just before the phase and read just after: all must be 0.
  17. (after 16) bf16 compute, grad_accum, steps_per_dispatch and remat:
     17a the bf16 flash kernels (HMMA in each instance's SASS) against the
     bf16 plain version and float64 on the same bf16 inputs at the prior's
     shape, L = 4096, 1600, 1025 and every head dim, element by element,
     in rms and in scale (BF16_ELEM, BF16_RMS, BF16_SCALE), with planted
     faults that the same gate must refuse, timed by CUDA-graph
     replay beside their bound, the plain version and
     scaled_dot_product_attention in bf16; 17b phase 5's path in bf16
     (extraction and the PixelSNAIL prior at full width, batch 16), counts
     set to 0 just before and read just after, every flash launch at bf16
     (none at float32) and 8 of each kernel a step; the kernels on the
     trained bf16 prior's q/k/v; train_prior with grad_accum 2 and with
     steps_per_dispatch 8; 17c the JAX bench's default workload through
     ``movae_tpu_torch.bench`` (bf16, batch 1024, k = 8) against bf16 and
     float32 at k = 1, nearest-code launches equal to the forwards, at most
     1/8 host synchronisation a step; the cifar100 vae/mgda path twice;
     17d the memory levers at 256 px (the celeba-hq
     VQ-VAE-2 and the 16a vae: plain, remat, grad_accum 2, both): peak
     memory and step ms; 17e card locksteps: 4 scanned steps against 4
     single steps bit for bit across a NaN batch, an accumulating step
     against the microbatch mean, remat against no remat, a bf16 step
     against the CPU's.
  18. (after 17) the standalone CLIs and the sphere encoders: 18a
     ``train_prior_vqvae2`` on 15a's run (the HierarchicalPixelCNN, batch
     128 as saved, 1 epoch, final/* over 256 generated images) and
     ``train_prior_vqvae --prior_type pixelsnail`` on 15b's (L = 4096,
     batch 16, 1 epoch), both re-extracting the codes, then both
     generators from the checkpoints alone (CLI_18A_*), counts set to 0
     just before and read just after each: nearest-code launches equal to
     the extraction batches (two each for the VQ-VAE-2), 8 of each flash
     kernel a PixelSNAIL step, none in a generator; files where the JAX
     CLIs put them, finite images, the hierarchical generation run a
     second time with its seed, bit for bit; 18b ``benchmark_workers`` over batch
     64/128/256 and workers 1/2/0; 18c sphere_encoder_vit at its default
     width (depth 24, dim 1024, 32 px, latent 2048; ~620 M parameters)
     under sum and upgrad at batch 16 (3 untimed, 5 timed steps), then
     ``sample`` at 1 and 4 steps; 18d the conv sphere_encoder through
     ``main`` at main.py's widths to final/* (CLI_18D) and its bare step;
     18e card vs CPU lockstep of a small ViT, 3 upgrad steps within 1e-4.
     18b-18e reach no kernel of the port: their counts stay 0.
  19. (after 18) serving: phase 15's checkpoints exported through
     ``serving.export_checkpoint`` in float32 and at int8 weights (KV
     cache int8; the int8 artifact copies the float32 one's sampler
     programs) and served by ``serve_artifacts`` on 127.0.0.1 in a
     thread: /healthz, /manifest, reconstruct, encode_codes and
     decode_codes at batch 1, 16 and 128 and one sample of 16 from each
     artifact, each float32 answer equal to the live port model's (codes
     but for near ties, images within SERVE_TOL of the largest value), the
     sample equal to 18a's generator's on the same seed, 15a's seed
     repeated, int8 within SERVE_INT8_TOL and under half the bytes; the
     nearest-code kernel launched inside the exported graphs, counted per
     request; export seconds per function, artifact bytes,
     ``serving_ab``'s images/s live and artifact, sample seconds.

A kernel's bound is the larger of three times: its float32 products over
the split-TF32 tensor-core rate (a third of the dense TF32 peak; the bf16
kernels: the dense bf16 rate), its exponentials over the MUFU rate, and
its bytes over HBM; the log line keeps the older bound with the products
on the fp32 CUDA cores beside it.

Prints the kernel table as one JSON line, the card's name and power limit,
and last ``{"ok": true, "device": {...}}``. Exits non-zero without a card,
without the ``movae_tpu_torch`` package beside this script, or when
MOVAE_INCEPTION_WEIGHTS or MOVAE_VGG16_WEIGHTS names a missing file.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from typing import Optional, Sequence

SLICE_N, SLICE_K, SLICE_D = 16384, 512, 64
FULL_WIDTH = dict(arch="vq_vae", embedding_dim=SLICE_D,
                  num_embeddings=SLICE_K, hidden_dims=(128, 256),
                  num_residual_layers=2, recons_objective="mse",
                  recons_activation="tanh")
BATCH, SIZE = 256, 32
WARMUP, TIMED = 3, 20
# the stage-2 path: the 256-px VQ-VAE of configs/imagenet/vq_vae (hidden
# (128, 256): 64x64 codes) and the default PixelSNAIL prior; the prior batch
# is cut from the configs' 128 to 16
PRIOR_SIZE, PRIOR_BATCH, PRIOR_WARMUP, PRIOR_TIMED = 256, 16, 3, 10
EXTRACT_BATCH = 52  # 4 extraction batches = 208 code grids = 13 prior batches
# latent rows of one extraction batch: 52 images of 64 x 64 codes
EXTRACT_N = EXTRACT_BATCH * (PRIOR_SIZE // 4) ** 2
PRIOR_ARGS = dict(prior_type="pixelsnail", batch_size=PRIOR_BATCH, seed=0,
                  pixelcnn_epochs=1, pixelcnn_lr=3e-4,
                  pixelcnn_hidden_channels=128, pixelsnail_num_blocks=8,
                  pixelsnail_num_res_blocks=2, pixelsnail_num_heads=8,
                  pixelsnail_dropout=0.1, attention_dropout="output")
# the 256-px VQ-VAE-2 of configs/celeba-hq/vq_vae2/{sum,upgrad}/mse/
# config_1.yaml, not cut: channel 128 (hidden_dims[0]), 2 residual layers,
# K=512, D=64, mse with no output activation, loss weights recon 1.0,
# embedding 1.0, commitment 0.25, adam 1e-4 under the per-epoch cosine (all
# steps fall in its first epoch), batch 128, normalized uint8 inputs
V2_SIZE, V2_BATCH, V2_WARMUP, V2_TIMED = 256, 128, 3, 10
V2_WIDTH = dict(arch="vq_vae2", embedding_dim=SLICE_D, num_embeddings=SLICE_K,
                hidden_dims=(128, 256), num_residual_layers=2,
                recons_objective="mse", recons_activation="none",
                loss_weights={"reconstruction_loss": 1.0,
                              "embedding_loss": 1.0, "commitment_loss": 0.25})
# latent rows of one VQ-VAE-2 batch at each level: 128 images of 32 x 32
# (top) and 64 x 64 (bottom) codes
V2_TOP_N = V2_BATCH * (V2_SIZE // 8) ** 2
V2_BOTTOM_N = V2_BATCH * (V2_SIZE // 4) ** 2
# the hierarchical prior those configs build (no prior_type: a
# HierarchicalPixelCNN of 15 layers, 128 channels, kernel 7) on 4 extracted
# batches; the prior batch is cut from the configs' 128 to 32
V2_EXTRACT_BATCHES = 4
HPRIOR_BATCH, HPRIOR_WARMUP, HPRIOR_TIMED, HSNAIL_STEPS = 32, 3, 10, 3
HPRIOR_ARGS = dict(batch_size=HPRIOR_BATCH, seed=0, pixelcnn_epochs=1,
                   pixelcnn_lr=3e-4, pixelcnn_hidden_channels=128,
                   pixelcnn_num_layers=15)
# the same with prior_type pixelsnail: its top runs dense attention at L=1024
HSNAIL_ARGS = dict(HPRIOR_ARGS, **{k: v for k, v in PRIOR_ARGS.items()
                                   if k.startswith(("prior_type",
                                                    "pixelsnail",
                                                    "attention"))})
# sampling: batch 16 at the full grids (top 32x32, bottom 64x64, flat
# 64x64); the sampler checks at small grids, batch 4
SAMPLE_BATCH = 16
CHECK_BATCH, CHECK_TOP, CHECK_FLAT = 4, (8, 8), (8, 8)
# two perturbed logits closer than this are a near tie (either draw is
# right), as nearest-code ties are in phase 2
SAMPLE_TIE = 1e-5
FLASH_SLICE = (PRIOR_BATCH, 8, 4096, 16)  # (B, H, L, D) of every prior layer
# the other shapes compared: L=4096 at batch 2, a 40x40 grid, L just past
# the dense threshold, and short ragged L at the two remaining head dims
FLASH_CASES = ((2, 8, 4096, 16), (2, 4, 1600, 64), (1, 2, 1025, 32),
               (2, 2, 777, 8), (1, 2, 333, 128))
# float32 sums over up to 4096 terms, taken in another order than the plain
# version's GEMMs and softmax: both sides carry rounding of ~1e-6 relative,
# so the kernel must sit within 1e-4 (output) and 1e-3 (gradients, which
# add the di and dp subtractions) of the largest value
FLASH_O_TOL, FLASH_GRAD_TOL = 1e-4, 1e-3
# on the trained prior's q, k, v the logits reach ~1e4 and a float32 logit
# carries ~1e-3 of absolute rounding: there the kernel is held against the
# plain version in float64, within those limits or within twice the
# distance of the float32 plain version from it, whichever is larger
FLASH_PLAIN_FACTOR = 2.0
FLASH_KERNELS = ("flash_attention_fwd", "flash_attention_bwd_dkv",
                 "flash_attention_bwd_dq")
FLASH_REPLACES = {
    "flash_attention_fwd": "jax/experimental/pallas/ops/tpu/"
                           "flash_attention.py:589",
    "flash_attention_bwd_dkv": "jax/experimental/pallas/ops/tpu/"
                               "flash_attention.py:941",
    "flash_attention_bwd_dq": "jax/experimental/pallas/ops/tpu/"
                              "flash_attention.py:1287",
}
# stage 3 (phase 11): run_final_metrics on phase 7's VQ-VAE-2 and phase 8's
# hierarchical prior. Cut: the sample counts from the configs' 10,000 to 512
# (recon pass) and 256 (generation: 2 chunks of the batch, 128), and random
# towers for pretrained ones; widths and image size are not cut
S3_FID_SAMPLES, S3_GEN_SAMPLES, S3_BATCH = 512, 256, 128
# images per tower held on the card against the CPU in float64, their sizes,
# and the timed repetitions (median) of each tower at batch S3_BATCH
S3_CHECK, S3_CHECK_SIZE, S3_TIMED = 4, 32, 10
# the tower checks' limit: 1e-4 of the largest value, or this many times the
# float32 CPU tower's own distance from float64, whichever is larger
TOWER_TOL, TOWER_PLAIN_FACTOR = 1e-4, 2.0
IS_ROUNDING = 1e-6
# phase 12: the aggregators that configs/ names beyond sum and upgrad, on
# the stage-1 path (3 untimed + 10 timed steps each), and every other name
# of the JAX package's AGGREGATOR_NAMES for 3 steps
CONFIG_AGGS = ("mgda", "mgda_ln", "mgda_gn", "mgda_lgn", "aligned_mtl",
               "aligned_mtl_median")
AGG_TIMED, AGG_OTHER_STEPS = 10, 3
# phase 13: gg_vq_vae_v3 as configs/cifar100/gg_vq_vae_v3/mgda_ln/mse/
# config_1.yaml builds it (32 px, hidden (128, 256), D=64, K=512, no output
# activation, its loss weights, adam 1e-3 cosine over 200 epochs, batch 256,
# normalized uint8) and gg_vq_vae2 as configs/celeba-hq/gg_vq_vae2/mgda_ln/
# mse/config_1.yaml does (256 px, batch 128, adam 1e-4 cosine over 1000
# epochs); not cut
GG_WEIGHTS = {"reconstruction_loss": 1.0, "embedding_loss": 1.0,
              "commitment_loss": 0.25, "gradient_guided_loss": 1.0,
              "edge_matching_loss": 1.0}
GG_V3 = dict(width=dict(FULL_WIDTH, arch="gg_vq_vae_v3",
                        recons_activation="none", loss_weights=GG_WEIGHTS),
             size=SIZE, batch=BATCH, warmup=WARMUP, timed=AGG_TIMED,
             lr=(1e-3, "cosine", 200, WARMUP + AGG_TIMED), uint8=True, vq=1)
GG_V2 = dict(width=dict(V2_WIDTH, arch="gg_vq_vae2",
                        loss_weights=GG_WEIGHTS),
             size=V2_SIZE, batch=V2_BATCH, warmup=V2_WARMUP, timed=V2_TIMED,
             lr=(1e-4, "cosine", 1000, V2_WARMUP + V2_TIMED), uint8=True,
             vq=2)
# phase 14: the wavefront A/B batches, and the small grids of the checks
WAVE_BATCHES = (SAMPLE_BATCH, S3_BATCH)
WAVE_CHECK_TOP = (8, 8)
# phase 15: two configs of configs/ through the port's CLI. Every key
# changed from the file is a cut: 15a runs the celeba-hq VQ-VAE-2 at full
# width (hidden 128/256, K 512, D 64, batch 128, adam 1e-4 cosine) on a
# synthetic 256-px set (celeba-hq cannot be fetched) for 2 epochs of 8
# steps, 1 prior epoch and 256-image final metrics, then resumes; 15b runs
# the imagenet VQ-VAE with a PixelSNAIL prior at L = 4096 at batch 16 (the
# stage-2 prior's cut; its final sample grid through the f32 KV cache, the
# faster one on the card in the KV-cache A/B of PERF.md)
CLI_15A = "configs/celeba-hq/vq_vae2/sum/mse/config_1.yaml"
CLI_15A_CUTS = dict(dataset="synthetic-256-1024", epochs=2, save_freq=1,
                    eval_freq=1, use_wandb=False, pixelcnn_epochs=1,
                    max_fid_samples=256, max_gen_metrics_samples=256)
CLI_15A_RESUME = dict(epochs=3, skip_pixelcnn=True, skip_final_metrics=True)
CLI_15B = "configs/imagenet/vq_vae/sum/mse/config_1.yaml"
CLI_15B_CUTS = dict(prior_type="pixelsnail", dataset="synthetic-256-128",
                    batch_size=16, epochs=1, pixelcnn_epochs=1,
                    skip_final_metrics=True, use_wandb=False,
                    kv_cache_dtype="f32")
# latent rows of one 15b batch (16 images of 64 x 64 codes): the
# nearest-code shape of its training, eval and extraction
CLI_15B_N = 16 * 64 * 64
# the loader A/B: epochs of each arm, alternating (host, card, card, host)
CLI_AB_ORDER = ("host", "device", "device", "host")
CLI_BENCH_STEPS = 20
# phase 16: the VAE family. 16a: the model of configs/imagenet/gg_vae/mgda/
# mse/config_1.yaml (its arch is vae: 2 objectives) and, for the four
# objectives of a gg_vae at that width, configs/animal-face/gg_vae/mgda_ln/
# mse/config_1.yaml; both 256 px, hidden 32-512, latent 4096, batch 128,
# normalized uint8, adam 1e-4 cosine; 16b: configs/cifar100/vae/mgda/mse/
# config_1.yaml (32 px, hidden 32-128, latent 128, batch 256); 16c: the
# Beta-TC-VAE of BASELINE.json's config 2 (32 px, the registry's defaults:
# hidden 32-512, latent 128), batch 128. Each path is driven under sum and
# under its config's aggregator (16c: aligned_mtl), not cut
VAE_16A = "configs/imagenet/gg_vae/mgda/mse/config_1.yaml"
GG_VAE_16A = "configs/animal-face/gg_vae/mgda_ln/mse/config_1.yaml"
VAE_16B = "configs/cifar100/vae/mgda/mse/config_1.yaml"
VAE_WARMUP, VAE_TIMED = 3, 10
BETATC_16C = dict(width=dict(arch="betatc_vae", recons_objective="mse",
                             batch_size=128, dataset_size=50000),
                  size=32, batch=128, warmup=VAE_WARMUP, timed=VAE_TIMED,
                  lr=(1e-3, None, 1, 1), uint8=True, vq=0)
# 16d: card-vs-CPU locksteps at a small width (16 px, hidden 8/16, latent
# 8, batch 4) with the N(0, I) draws of each step made once on the host;
# the anneal counters run over 4 steps
VAE_DRAWS = {"cycle_vae": ("eps", "z_prior"),
             "recursive_cyclic_vae": ("eps", "z_prior")}
VAE_LOCKSTEPS = (("vae", "mgda", 3), ("cycle_vae", "mgda", 2),
                 ("recursive_kl_vae", "upgrad", 2),
                 ("recursive_cyclic_vae", "mgda", 2))
# 16e: configs/celeba-hq/vae/sum/mse/config_1.yaml through the CLI with 15a's
# cuts (every key changed from the file is a cut)
CLI_16E = "configs/celeba-hq/vae/sum/mse/config_1.yaml"
CLI_16E_CUTS = dict(dataset="synthetic-256-1024", epochs=2, save_freq=1,
                    eval_freq=1, use_wandb=False, max_fid_samples=256,
                    max_gen_metrics_samples=256)
# phase 17: the bf16 flash kernels at the prior's shape (FLASH_SLICE), at
# L = 4096, 1600 and 1025 and at every other head dim built
FLASH_BF16_CASES = ((2, 8, 4096, 16), (2, 2, 1025, 8), (1, 2, 1600, 32),
                    (1, 2, 777, 64), (1, 2, 333, 128))
# 17a's gate on the bf16 flash kernels, in units of bf16's unit roundoff
# u = 2^-8 (a rounding to bf16 moves a value by at most u of it). Against
# the plain version on the same inputs, with the backward kernels and the
# plain backward both fed the forward kernel's own o and lse (so that each
# kernel is compared alone): every element within BF16_ELEM floors, a
# floor being u of the value plus the root-sum-square of the products
# summed into it plus 1/16 of the output's rms (``bf16_terms``: one bf16
# rounding of p or ds moves an element by up to u of its term, and on a
# trained prior's sharp rows the terms of dq and dk cancel to far less
# than themselves: one rounding of ds there moved a dq row by 2.3% of its
# rms); the difference's rms within BF16_RMS u of the output's rms; and
# the best-fit scale between the two within BF16_SCALE u of 1. Against
# float64 on the same bf16 inputs, each kernel as the port runs it end to
# end: the rms within BF16_F64_FACTOR times the plain version's own plus
# BF16_RMS / 2 u, and the scale within the plain version's plus BF16_SCALE
# u. The kernels' arithmetic emulated on the CPU
# (tests/test_torch_port_flash_bf16_gate.py) passes it; a normalisation
# 0.9% low (2.2 u of scale), q pre-scaled in bf16 at D = 32 (0.75 u rms),
# ds left unrounded (0.67 u rms) and the last quarter of the rows zeroed
# (~190 floors) do not, and 17a plants each of them on the card
BF16_U, BF16_ELEM, BF16_RMS, BF16_SCALE = 2.0 ** -8, 4.0, 0.5, 1 / 16
BF16_F64_FACTOR = 1.25
# the shape of 17a's planted controls: D = 32, where 1/sqrt(D) is not a
# power of two, so that q pre-scaled in bf16 rounds differently
FLASH_BF16_CONTROL = (1, 2, 1600, 32)
# 17a's trained-prior case (kernels/fixtures/dkv_sharp_prior.pt: q, k, v, do
# and the dk of the kernel that summed the logits on the tensor cores)
DKV_FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "movae_tpu_torch", "kernels", "fixtures",
                           "dkv_sharp_prior.pt")
# 17c: bench steps a run (5 rounds of 16 steps: 2 dispatches of 8 at k = 8)
# and the cifar100 vae/mgda steps a run
BENCH_17C_STEPS, VAE_17C_STEPS = 80, 48
# 17d: untimed and timed steps of each memory-lever run
LEVER_WARMUP, LEVER_TIMED = 2, 3
# 17e: the accumulated update against the microbatch mean (float32 sums
# of two gradients in another order: ~1e-7 of the largest update), remat
# against no remat after 3 SGD steps at lr 1e-2 (the same kernels in
# deterministic mode: expected 0; 1e-5 absolute leaves room for float32
# reassociation), a bf16 step card against CPU (bf16 cotangents summed in
# other orders on the two devices; the CPU tests hold the port to JAX
# within 5e-2 the same way)
ACCUM_TOL, REMAT_TOL, BF16_STEP_TOL = 1e-5, 1e-5, 5e-2
# phase 18: the standalone CLIs and the sphere encoders. 18a runs the two
# prior CLIs on phase 15's run trees: train_prior_vqvae2 on 15a's
# celeba-hq vq_vae2/sum checkpoint (the HierarchicalPixelCNN of that run,
# 15 layers of 128 channels, batch 128 as saved, 1 prior epoch of 15a's
# synthetic-256-1024, final/* over 256 generated images) and
# train_prior_vqvae --prior_type pixelsnail on 15b's imagenet vq_vae/sum
# checkpoint (the default PixelSNAIL at L = 4096, 15b's batch 16 and 1
# epoch); both re-extract the codes (the run's cache would skip the
# nearest-code kernel); then both generators from the checkpoints alone,
# the hierarchical one twice with one seed (bit for bit), the flat one with
# the int8 KV cache (the serving artifacts' default: both generators' images
# are phase 19's live samples; the f32 cache runs at L = 4096 in phases 9
# and 15b)
CLI_18A_V2 = ["--pixelcnn_epochs", "1", "--prior_force_extract_codes",
              "--max_gen_metrics_samples", "256", "--num_samples", "16"]
CLI_18A_SNAIL = ["--prior_type", "pixelsnail", "--batch_size", "16",
                 "--pixelcnn_epochs", "1", "--prior_force_extract_codes",
                 "--max_gen_metrics_samples", "0", "--num_samples", "16"]
# (seed and count as phase 19's sample, whose live reference these are)
GEN_SEED = 3
CLI_18A_GEN = ["--num_samples", "16", "--batch_size", "16", "--seed",
               str(GEN_SEED)]
# 18b: benchmark_workers on the card machine's host
CLI_18B = (["--batch_sizes", "64", "128", "256"],
           ["--batch_size", "256", "--workers", "1", "2", "0"])
CLI_18B_COMMON = ["--num_batches", "10", "--num_runs", "3", "--warmup", "2"]
# 18c: sphere_encoder_vit at its registry's defaults (depth 24, dim 1024,
# 16 heads, mixer depth 2, 32 px, patch 2) with latent 2048 (8 channels x
# 256 patches), the VGG perceptual term on, adam 1e-3 (main.py's default);
# batch 16, 3 untimed and 5 timed steps under sum and upgrad
SPHERE_VIT_18C = dict(width=dict(arch="sphere_encoder_vit", latent_dim=2048,
                                 batch_size=16),
                      size=32, batch=16, warmup=3, timed=5,
                      lr=(1e-3, None, 1, 8), uint8=False, vq=0)
SPHERE_SAMPLE_STEPS = (1, 4)
# 18d: the conv sphere_encoder through python -m movae_tpu_torch.main at
# main.py's defaults (hidden 32-512, latent 128, batch 128, adam 1e-3) with
# 16e's cuts (a synthetic set of 1024 32-px images, 2 epochs, 256
# final-metric samples); its bare step at that width beside the CLI
CLI_18D = ["--arch", "sphere_encoder", "--dataset", "synthetic-32-1024",
           "--epochs", "2", "--save_freq", "1", "--eval_freq", "1",
           "--max_fid_samples", "256", "--max_gen_metrics_samples", "256",
           "--seed", "0"]
SPHERE_CONV_18D = dict(width=dict(arch="sphere_encoder", batch_size=128),
                       size=32, batch=128, warmup=3, timed=10,
                       lr=(1e-3, None, 1, 13), uint8=False, vq=0)
# 18e: card vs CPU lockstep of the ViT at a small width (16 px, depth 2,
# dim 64, 4 heads, mixer depth 1, 64 patches of 8 channels), 3 upgrad steps
SPHERE_VIT_18E = dict(arch="sphere_encoder_vit", vit_depth=2,
                      vit_embed_dim=64, vit_num_heads=4, vit_mixer_depth=1,
                      latent_dim=512)
# phase 19: serving. Phase 15's two checkpoints exported in float32 and at
# int8 weights (KV cache int8), each answering reconstruct, encode_codes and
# decode_codes over HTTP at these batches and one sample of 16 images, seed
# GEN_SEED; against the live model: images within SERVE_TOL of the largest
# value, codes but for near ties (the live model's sample: 18a's generator
# on the same checkpoint and seed, int8 KV cache); int8 against float32
# within SERVE_INT8_TOL of the largest value (the JAX package's serving
# test allows 0.02); the live and artifact reconstruct interleaved
# (serving_ab) at SERVE_AB_BATCHES. The int8 artifact copies the float32
# one's sampler programs (prior weights stay float)
SERVE_BATCHES, SERVE_SAMPLE_BATCH, SERVE_SEED = (1, 16, 128), 16, GEN_SEED
SERVE_TOL, SERVE_INT8_TOL = 1e-4, 0.02
SERVE_AB_BATCHES, SERVE_AB = (16, 128), dict(rounds=3, reps=5)
# phase 20: the data axis on the one card. P20_WORLD ranks spawned on it,
# gloo (NCCL refuses two ranks on one GPU). Each holds the global batch's
# rows p, p + P, ... (the loaders' interleave); one data-parallel step from
# one init against the one-rank step on the whole batch in rank 0, at
# tests/test_parallel.py's bounds (loss rtol 1e-5; parameters rtol 1e-4,
# atol 1e-6): phase 3's full-width VQ-VAE at batch BATCH (sum, upgrad, and
# under --fsdp), SGD with momentum as the JAX test steps (float32, TF32
# off); phase 5's full-width PixelSNAIL at L = 4096 and batch PRIOR_BATCH
# (float32 and bf16, Adam eps 1e-4 as the locksteps); then sample-parallel
# sample_fast_snail at 64x64 (float32 cache, seed GEN_SEED) against one
# rank's codes. Each rank's launch counts show its kernels on every step
P20_WORLD, P20_LR, P20_MOMENTUM, P20_TIMED = 2, 1e-3, 0.9, 3
P20_LOSS_RTOL, P20_PARAM_RTOL, P20_PARAM_ATOL = 1e-5, 1e-4, 1e-6
# bf16 prior: the share of all parameters, and the least share of any one
# entry's elements, within those bounds (the rest within one Adam step:
# see p20_bf16_close)
P20_BF16_SHARE, P20_BF16_LEAF_SHARE = 0.99, 0.9
# phase 20's model, pipe and seq axes, each over the P20_WORLD ranks
# against one rank on the whole batch: (a) model_partitions: phase 3's
# VQ-VAE, sum and upgrad, its large convolutions split over the ranks'
# output channels (column-parallel), its codebook gathered before use, at
# the data axis's bounds, and each leaf's update within FLASH_GRAD_TOL of
# its largest; (b) pipeline_parallel: phase 5's float32 PixelSNAIL at L =
# 4096, its 8 blocks in P20_WORLD stages and P20_PP_M microbatches
# (default_microbatches of the batch), each block recomputed in the
# backward; (c) context_parallel: the same prior through the zigzag ring,
# and the ring alone on FLASH_SLICE against the plain ring (its diagonal
# blocks through the plain version) within FLASH_O_TOL and FLASH_GRAD_TOL.
# (b) and (c) run at dropout 0 (a pipeline stage draws its own masks, as
# the JAX package's do), in two parts. The step: P20_STEPS train_prior
# steps with each step's gradients recorded, against the one-rank trainer
# fed those gradients (_p20_axis_prior): every CE at P20_LOSS_RTOL and the
# parameters after the steps at test_parallel's bounds, which holds the
# axis's clip and optimizer (the pipeline's per-stage moments, its norm
# summed over 'pipe') to one device's. The gradients: on the whole batch,
# held as 17a holds the flash kernels (p20_grad_close). At this prior's
# random init the attention logits reach ~4.6e3 in the last block, where
# the one-rank float32 path is itself 6.4% of a leaf's largest gradient
# from float64 (flash_vs_f64), so neither float32 path is the other's
# reference, and a path's parameters after Adam cannot be held to the
# one-rank step's own at test_parallel's bounds (Adam's first step
# divides each gradient by its size). Planted faults each check refuses:
# a TP layer that skips its input's backward all-reduce, a pipeline that
# loses one microbatch's cross-entropy, pipeline stages that clip by their
# own norms, a ring that drops its last rotation
P20_PP_M, P20_STEPS = 4, 2
# the depth of (b), (c) and the sample-parallel sampler's prior: phase 5's
# 8 blocks cut to 4 (L, the widths and the kernels' shapes kept) to keep
# the phase's time
P20_BLOCKS = 4
# published H100 peaks (NVIDIA data sheets): fp32 on the CUDA cores, HBM
PEAKS = {"sxm": (67e12, 3.35e12), "pcie": (51e12, 2.0e12),
         "nvl": (60e12, 3.9e12)}
# dense TF32 on the tensor cores of the SXM part (data sheet), scaled to the
# other parts by their fp32 rate. A float32-accurate product on the tensor
# cores takes three TF32 passes (split TF32), so the bound's products run at
# a third of it: 165 TFLOP/s on the SXM part
TF32_SXM = 495e12
# dense bf16 on the tensor cores of the SXM part (data sheet)
BF16_SXM = 989e12
# exp2 on the MUFU units: 16 a clock per SM against 128 fp32 FMA lanes, so
# 1/8 of the FMA rate (132 SMs x 16 x 1.98 GHz = 4.18e12/s on the SXM part)
MUFU_PER_FMA = 1 / 8


# --probe's probes (probe_dkv, probe_cudnn, probe_timings)
PROBES = ("dkv", "cudnn", "timings")


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


def bound(flops: float, exps: float, nbytes: float, peaks,
          tensor_sxm: float = TF32_SXM / 3) -> dict:
    """The least time the card could take: the larger of the products over
    the tensor-core rate ``tensor_sxm`` of the SXM part (default split
    TF32; the bf16 kernels: dense bf16) scaled to the card's part, the
    exponentials over the MUFU rate and the bytes over HBM; ``fp32_ms`` is
    the bound with the products on the fp32 CUDA cores instead, as it was
    stated before."""
    fp32, hbm = peaks
    ops_ms = flops / (tensor_sxm * fp32 / PEAKS["sxm"][0]) * 1e3
    exp_ms = exps / (fp32 / 2 * MUFU_PER_FMA) * 1e3
    bytes_ms = nbytes / hbm * 1e3
    ms = max(ops_ms, exp_ms, bytes_ms)
    return {"ms": ms, "by": "bytes" if bytes_ms >= ms else "operations",
            "products_ms": ops_ms, "exp2_ms": exp_ms, "bytes_ms": bytes_ms,
            "fp32_ms": max(flops / fp32 * 1e3, bytes_ms), "flops": flops}


# a kernel's name in a mangled symbol, with its first int template
# argument (``nearest_code_kernel<64>``, ``flash_fwd_kernel<16>``,
# ``flash_fwd_bf16_kernel<16>``)
KERNEL_NAME = r"([a-z_]+(?:_bf16)?_kernel)(?:ILi(\d+)E)?"


def kernel_name(m) -> str:
    return m.group(1) + (f"<{m.group(2)}>" if m.group(2) else "")


def ptxas_summary(log_text: str) -> dict:
    """{kernel: [registers, spill store bytes, spill load bytes]} from the
    ``-Xptxas -v`` report of one library."""
    out, name = {}, None
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '.*?" + KERNEL_NAME, line)
        if m:
            name = kernel_name(m)
            out[name] = [None, 0, 0]
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            out[name][1:] = [int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name][0] = int(m.group(1))
    return out


# SASS opcodes counted per kernel: an entry with a dot counts that opcode
# with its first modifier (MUFU.EX2), one without counts every modifier;
# SYNCS are the mbarrier operations, UTMALDG the TMA loads
SASS_OPS = ("HMMA", "FFMA", "FMUL", "FADD", "FMNMX", "FSEL", "ISETP", "MUFU",
            "MUFU.EX2", "LDS", "LDSM", "SHFL", "BAR", "SYNCS", "UTMALDG")


def sass_counts(cuobjdump: str, lib: str, ops=SASS_OPS) -> dict:
    """{kernel: {op: count, "all": instructions}} of SASS opcodes in a
    built library (static counts: every instruction of the binary once),
    and "hot": the instructions and MUFU.EX2 of the kernel's branch-free
    run (between two branches or exits) that holds the most MUFU.EX2, the
    body of its unrolled step."""
    text = subprocess.run([cuobjdump, "-sass", lib], capture_output=True,
                          text=True, timeout=120).stdout
    out, name, run = {}, None, [0, 0]
    for line in text.splitlines():
        m = re.search(r"Function : .*?" + KERNEL_NAME, line)
        if m:
            name, run = kernel_name(m), [0, 0]
            out[name] = dict.fromkeys((*ops, "all"), 0)
            out[name]["hot"] = [0, 0]
            continue
        m = re.match(r"\s+/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?"
                     r"([A-Z0-9_]+)(\.[A-Z0-9_]+)?", line)
        if m and name:
            out[name]["all"] += 1
            for op in {m.group(1), m.group(1) + (m.group(2) or "")}:
                if op in ops:
                    out[name][op] += 1
            run[0] += 1
            run[1] += m.group(1) + (m.group(2) or "") == "MUFU.EX2"
            if m.group(1) in ("BRA", "EXIT", "RET", "BRX", "JMP", "CALL"):
                if run[1] > out[name]["hot"][1]:
                    out[name]["hot"] = run
                run = [0, 0]
    return out


def per_ex2(ops: dict) -> tuple:
    """SASS instructions other than MUFU per MUFU.EX2 of a kernel: over the
    whole binary (prologue, epilogue and both step instances), and in its
    hot branch-free run (``sass_counts``)."""
    hot_all, hot_ex2 = ops["hot"]
    return ((ops["all"] - ops["MUFU"]) / max(ops["MUFU.EX2"], 1),
            (hot_all - hot_ex2) / max(hot_ex2, 1))


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


def graph_ms(torch, fn, reps: int = 100) -> float:
    """Mean device time of ``fn`` over ``reps`` calls captured in one CUDA
    graph and replayed (CUDA events). Replaying a graph leaves out the
    host's launch path, which for a kernel of a few tens of µs (Python
    checks and a ctypes call) can take longer than the kernel itself: back
    to back launches would then time the host."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (3 * reps)
    del graph
    return ms


# ---------------------------------------------------------------------------
# phase 2: nearest-code kernel vs its plain version
# ---------------------------------------------------------------------------

def codes_agree(torch, z, cb, got, want) -> dict:
    """Two code assignments of the rows ``z`` (N, D) against the codebook
    ``cb``: they must match except where a row's top-two distance gap,
    recomputed in float64, is below 1e-5 * (1 + |d|) (a near tie that
    float32 summation order may flip)."""
    z64, cb64 = z.double(), cb.double()
    dist = (cb64 * cb64).sum(1)[None, :] - 2.0 * z64 @ cb64.T
    top2 = dist.topk(2, dim=1, largest=False).values
    near_tie = (top2[:, 1] - top2[:, 0]) < 1e-5 * (1.0 + top2[:, 0].abs())
    got, want = got.reshape(-1).long(), want.reshape(-1).long()
    mismatch = got != want
    d_got = dist.gather(1, got[:, None])[:, 0]
    d_want = dist.gather(1, want[:, None])[:, 0]
    return {
        "rows": int(z.shape[0]),
        "mismatch": int(mismatch.sum()),
        "near_tie_mismatch": int((mismatch & near_tie).sum()),
        "bad": int((mismatch & ~near_tie).sum()),
        # float64 distance between the two picks (0 where they agree)
        "max_abs_err": float((d_got - d_want).abs().max()),
    }


def compare_nearest(torch, nc, z, cb) -> dict:
    """Kernel vs plain on the same inputs, by ``codes_agree``'s rule."""
    got = nc.nearest_code_cuda(z, cb)
    want = nc.nearest_code_plain(z, cb)
    torch.cuda.synchronize()
    return dict(codes_agree(torch, z, cb, got, want),
                in_range=bool(((got >= 0) & (got < cb.shape[0])).all()))


def check_nearest_ties(torch, nc, dev, gen) -> float:
    """A codebook whose rows come in groups of equal rows: every member of
    a group has the same distance to a latent bit for bit, so the kernel
    must pick the lowest index of its group, exactly, on every row; and on
    rows of NaN its index must stay in range."""
    groups, n = 128, 4096
    base = torch.randn(groups, SLICE_D, generator=gen, device=dev)
    owner = torch.randint(0, groups, (SLICE_K,), generator=gen, device=dev)
    cb = base[owner].contiguous()
    # lowest[c]: the lowest index of code c's group
    first = torch.full((groups,), SLICE_K, dtype=torch.long, device=dev)
    first.scatter_reduce_(0, owner, torch.arange(SLICE_K, device=dev),
                          "amin")
    lowest = first[owner]
    pick = torch.randint(0, groups, (n,), generator=gen, device=dev)
    z = base[pick] + 0.3 * torch.randn(n, SLICE_D, generator=gen,
                                       device=dev)
    res = compare_nearest(torch, nc, z, cb)
    got = nc.nearest_code_cuda(z, cb).long()
    res["not_lowest_of_group"] = int((lowest[got] != got).sum())
    nan_rows = torch.full((64, SLICE_D), float("nan"), device=dev)
    nan_got = nc.nearest_code_cuda(nan_rows, cb)
    torch.cuda.synchronize()
    res["nan_rows_in_range"] = bool(((nan_got >= 0)
                                     & (nan_got < SLICE_K)).all())
    log(f"nearest_code duplicated rows N={n} K={SLICE_K} ({groups} distinct) "
        f"D={SLICE_D}: {json.dumps(res)}")
    check(res["in_range"] and res["bad"] == 0
          and res["not_lowest_of_group"] == 0 and res["nan_rows_in_range"],
          f"nearest_code on duplicated codebook rows: {res}")
    return res["max_abs_err"]


def time_nearest(torch, nc, dev, gen, n: int, peaks) -> dict:
    """Kernel, plain version and ``cdist + argmin`` at (n, SLICE_K,
    SLICE_D), each timed by CUDA-graph replay, with the bound; the kernel
    also launched back to back from the host, as the path launches it."""
    z = torch.randn(n, SLICE_D, generator=gen, device=dev)
    cb = torch.randn(SLICE_K, SLICE_D, generator=gen, device=dev)
    # fewer calls a graph where each holds (n, K) intermediates
    reps = 100 if n <= SLICE_N else 10
    ms = graph_ms(torch, lambda: nc.nearest_code_cuda(z, cb), reps)
    launched_ms = time_ms(torch, lambda: nc.nearest_code_cuda(z, cb))
    plain_ms = graph_ms(torch, lambda: nc.nearest_code_plain(z, cb), reps)
    library_ms = graph_ms(torch, lambda: torch.cdist(z, cb).argmin(1), reps)
    flops = 2.0 * n * SLICE_K * SLICE_D + 2.0 * SLICE_K * SLICE_D
    nbytes = 4.0 * (n * SLICE_D + SLICE_K * SLICE_D) + 4.0 * n
    b = bound(flops, 0.0, nbytes, peaks)
    log(f"nearest_code timing N={n} K={SLICE_K} D={SLICE_D} (graph "
        f"replay): kernel {ms * 1e3:.2f} us (launched back to back from "
        f"the host {launched_ms * 1e3:.2f} us), "
        f"plain {plain_ms * 1e3:.2f} us, "
        f"cdist+argmin {library_ms * 1e3:.2f} us, bound {b['ms'] * 1e3:.2f} "
        f"us (products at split TF32 {b['products_ms'] * 1e3:.2f} us, bytes "
        f"{b['bytes_ms'] * 1e3:.2f} us; on the fp32 CUDA cores "
        f"{b['fp32_ms'] * 1e3:.2f} us), "
        f"{flops / (ms * 1e-3) / 1e12:.2f} TFLOP/s achieved")
    del z, cb
    torch.cuda.empty_cache()
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": b["ms"], "bound_by": b["by"]}


def phase_kernels(torch, nc, dev, peaks) -> dict:
    gen = torch.Generator(device=dev).manual_seed(0)
    cases = [(SLICE_N, SLICE_K, SLICE_D), (1000, SLICE_K, SLICE_D),
             (4096, 64, 8), (777, 1000, 128), (EXTRACT_N, SLICE_K, SLICE_D),
             (V2_TOP_N, SLICE_K, SLICE_D), (V2_BOTTOM_N, SLICE_K, SLICE_D),
             (CLI_15B_N, SLICE_K, SLICE_D)]
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
    worst = max(worst, check_nearest_ties(torch, nc, dev, gen))

    # stage 1's shape (the row's numbers), then stage 2's extraction shape,
    # the VQ-VAE-2's top and bottom levels and phase 15b's batch
    t = time_nearest(torch, nc, dev, gen, SLICE_N, peaks)
    for n in (EXTRACT_N, V2_TOP_N, V2_BOTTOM_N, CLI_15B_N):
        time_nearest(torch, nc, dev, gen, n, peaks)
    return {
        "name": "nearest_code", "route": "cuda",
        "source": "movae_tpu_torch/kernels/nearest_code.cu",
        "replaces": "movae_tpu/ops/vq.py:93",
        "launches": None, "max_abs_err": worst, "ms": t["ms"],
        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": t["library_ms"],
    }


# ---------------------------------------------------------------------------
# phase 2b: the flash-attention kernels vs their plain version
# ---------------------------------------------------------------------------

def compare_flash(torch, fa, q, k, v, do, exact: bool = False) -> dict:
    """Output and dq/dk/dv (autograd, cotangent ``do``) of the kernels and
    of the plain version on the same inputs: the largest absolute
    difference of each and the largest absolute value of the plain one.
    ``exact``: the reference is the plain version in float64, and the
    float32 plain version's own distance from it is ``plain_err``."""
    scale = q.shape[-1] ** -0.5
    plain = fa.flash_causal_attention_plain
    runs = [("cuda", fa.flash_causal_attention_cuda, torch.float32),
            ("plain", plain, torch.float32)]
    if exact:
        runs.append(("exact", plain, torch.float64))
    outs = {}
    for name, fn, dtype in runs:
        leaves = [t.to(dtype, copy=True).requires_grad_() for t in (q, k, v)]
        o = fn(*leaves, scale)
        outs[name] = [o.detach(),
                      *torch.autograd.grad(o, leaves, do.to(dtype))]
    torch.cuda.synchronize()
    res = {}
    for i, key in enumerate(("o", "dq", "dk", "dv")):
        want = outs["exact" if exact else "plain"][i]
        got = outs["cuda"][i]
        res[key] = {"max_abs_err": float((got.to(want) - want).abs().max()),
                    "max_abs": float(want.abs().max()),
                    "finite": bool(torch.isfinite(got).all())}
        if exact:
            res[key]["plain_err"] = float(
                (outs["plain"][i].to(want) - want).abs().max())
    return res


def flash_bounds(shape, peaks, elem_bytes: int = 4,
                 tensor_sxm: float = TF32_SXM / 3) -> dict:
    """:func:`bound` per kernel: the products of the causal half (2, 4 and
    3 of them: 4, 8 and 6 flops per pair element), one exp2 per causal pair,
    and each input read and output written once (``elem_bytes`` an element
    of a (.., D) tensor; the log-sum-exp and di stay float32).
    ``fma_logits_ms``, beside the bound and not in it: the logits' 2 flops
    per pair element on the fp32 CUDA cores, where the bf16 kernels sum
    them as one IEEE fma chain (the least time of that design's choice)."""
    b, h, L, d = shape
    pairs = b * h * L * (L + 1) / 2
    mat, row = elem_bytes * b * h * L * d, 4.0 * b * h * L
    work = {"flash_attention_fwd": (4, 4 * mat + row),
            "flash_attention_bwd_dkv": (8, 6 * mat + 2 * row),
            "flash_attention_bwd_dq": (6, 5 * mat + 2 * row)}
    fma_logits_ms = 2 * pairs * d / peaks[0] * 1e3
    return {name: {**bound(per * pairs * d, pairs, nbytes, peaks,
                           tensor_sxm), "fma_logits_ms": fma_logits_ms}
            for name, (per, nbytes) in work.items()}


def check_flash(torch, fa, label: str, q, k, v, do, worst: dict,
                exact: bool = False) -> None:
    """compare_flash within the stated tolerances; raises the largest
    errors in ``worst`` (per kernel) to this comparison's."""
    res = compare_flash(torch, fa, q, k, v, do, exact)
    log(f"flash_attention {label}: {json.dumps(res)}")
    for key, r in res.items():
        tol = FLASH_O_TOL if key == "o" else FLASH_GRAD_TOL
        limit = max(tol * r["max_abs"],
                    FLASH_PLAIN_FACTOR * r.get("plain_err", 0.0))
        check(r["finite"] and r["max_abs_err"] <= limit,
              f"flash_attention {key} at {label} is off its plain version: "
              f"{r} (limit {limit:.3e}: {tol} of the largest value"
              + (f" or {FLASH_PLAIN_FACTOR}x the float32 plain version's "
                 f"own error" if exact else "") + ")")
    for name, keys in (("flash_attention_fwd", ("o",)),
                       ("flash_attention_bwd_dkv", ("dk", "dv")),
                       ("flash_attention_bwd_dq", ("dq",))):
        worst[name] = max(worst[name], *(res[k]["max_abs_err"] for k in keys))


def phase_flash(torch, fa, dev, peaks) -> list:
    gen = torch.Generator(device=dev).manual_seed(5)
    worst = dict.fromkeys(FLASH_KERNELS, 0.0)
    for shape in FLASH_CASES:
        check_flash(torch, fa, str(shape), *(
            torch.randn(shape, generator=gen, device=dev) for _ in range(4)),
            worst)
    q, k, v, do = (torch.randn(FLASH_SLICE, generator=gen, device=dev)
                   for _ in range(4))
    check_flash(torch, fa, str(FLASH_SLICE), q, k, v, do, worst)
    torch.cuda.empty_cache()

    # times at the prior's shape, on the inputs compared first; each
    # backward kernel on the forward kernel's own o and lse
    import torch.nn.functional as F

    scale = FLASH_SLICE[-1] ** -0.5
    o, lse2 = fa.flash_fwd(q, k, v, scale)
    di = (o * do).sum(-1)
    ms = {
        "flash_attention_fwd": time_ms(
            torch, lambda: fa.flash_fwd(q, k, v, scale), reps=20),
        "flash_attention_bwd_dkv": time_ms(
            torch, lambda: fa.flash_bwd_dkv(q, k, v, do, lse2, di, scale),
            reps=20),
        "flash_attention_bwd_dq": time_ms(
            torch, lambda: fa.flash_bwd_dq(q, k, v, do, lse2, di, scale),
            reps=20),
    }
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]

    def backward_ms(out):
        return time_ms(torch, lambda: torch.autograd.grad(
            out, leaves, do, retain_graph=True), reps=5, warmup=2)

    def fwd_bwd_ms(fn):
        return time_ms(torch, lambda: torch.autograd.grad(
            fn(*leaves, scale), leaves, do), reps=5, warmup=2)

    pair_ms = backward_ms(fa.flash_causal_attention_cuda(*leaves, scale))
    cuda_fb = fwd_bwd_ms(fa.flash_causal_attention_cuda)
    with torch.no_grad():
        plain_fwd = time_ms(torch, lambda: fa.flash_causal_attention_plain(
            q, k, v, scale), reps=5, warmup=2)
        sdpa_fwd = time_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, scale=scale), reps=20)
    plain_bwd = backward_ms(fa.flash_causal_attention_plain(*leaves, scale))
    torch.cuda.empty_cache()
    sdpa_bwd = backward_ms(F.scaled_dot_product_attention(
        *leaves, is_causal=True, scale=scale))
    sdpa_fb = fwd_bwd_ms(lambda *a: F.scaled_dot_product_attention(
        *a[:3], is_causal=True, scale=a[3]))
    del leaves, o, lse2, di, q, k, v, do
    torch.cuda.empty_cache()
    bounds = flash_bounds(FLASH_SLICE, peaks)
    fwd_ms, dkv_ms, dq_ms = (ms[n] for n in FLASH_KERNELS)
    log(f"flash_attention timing {FLASH_SLICE}: forward {fwd_ms:.4f} ms, "
        f"dK/dV {dkv_ms:.4f} ms, dQ {dq_ms:.4f} ms, backward through "
        f"autograd (di + dK/dV + dQ) {pair_ms:.4f} ms, "
        f"forward + backward {cuda_fb:.4f} ms; plain forward "
        f"{plain_fwd:.4f} ms, plain backward {plain_bwd:.4f} ms; "
        f"scaled_dot_product_attention forward {sdpa_fwd:.4f} ms, backward "
        f"{sdpa_bwd:.4f} ms, forward + backward {sdpa_fb:.4f} ms; bounds "
        + ", ".join(f"{n} {b['ms']:.4f} ms ({b['by']}: products at split "
                    f"TF32 {b['products_ms']:.4f} ms, exp2 {b['exp2_ms']:.4f} "
                    f"ms, bytes {b['bytes_ms']:.4f} ms; on the fp32 CUDA "
                    f"cores {b['fp32_ms']:.4f} ms; "
                    f"{b['flops'] / (ms[n] * 1e-3) / 1e12:.2f} TFLOP/s "
                    f"achieved)" for n, b in bounds.items()))
    rows = []
    for name in FLASH_KERNELS:
        fwd = name == "flash_attention_fwd"
        rows.append({
            "name": name, "route": "cuda",
            "source": "movae_tpu_torch/kernels/flash_attention.cu",
            "replaces": FLASH_REPLACES[name], "launches": None,
            "max_abs_err": worst[name], "ms": ms[name],
            # the plain version and the library compute dq, dk and dv in
            # one backward: both backward rows carry that backward's time
            "plain_ms": plain_fwd if fwd else plain_bwd,
            "bound_ms": bounds[name]["ms"], "bound_by": bounds[name]["by"],
            "library_ms": sdpa_fwd if fwd else sdpa_bwd,
        })
    return rows


# ---------------------------------------------------------------------------
# phase 3: the main path, full-width VQ-VAE training
# ---------------------------------------------------------------------------

# the stage-1 VQ-VAE (phase 3) and the VQ-VAE-2 (phase 7): width, image
# size, batch, steps, the learning-rate schedule's arguments, uint8 inputs
# (normalized) or float ones in [-1, 1], and nearest-code launches a forward
STAGE1 = dict(width=FULL_WIDTH, size=SIZE, batch=BATCH, warmup=WARMUP,
              timed=TIMED, lr=(1e-3, None, 1, 1), uint8=False, vq=1)
VQVAE2 = dict(width=V2_WIDTH, size=V2_SIZE, batch=V2_BATCH, warmup=V2_WARMUP,
              timed=V2_TIMED, lr=(1e-4, "cosine", 400, V2_WARMUP + V2_TIMED),
              uint8=True, vq=2)


def train_mode(torch, agg: str, dev, path: dict, model=None):
    """``path``'s model (a fresh one from seed 0, or ``model`` as given)
    trained under ``agg``: warmup then timed steps, each synchronized."""
    from movae_tpu_torch.kernels import LAUNCH_COUNTS
    from movae_tpu_torch.models import get_network, init_model
    from movae_tpu_torch.moo import AggregatorConfig, init_state
    from movae_tpu_torch.train.optim import build_optimizer, lr_schedule
    from movae_tpu_torch.train.state import TrainState
    from movae_tpu_torch.train.step import make_train_step

    size, batch = path["size"], path["batch"]
    if model is None:
        model = init_model(get_network(size, 3, path["width"]), seed=0,
                           device=dev)
    cfg = AggregatorConfig(name=agg, num_objectives=len(model.objective_names))
    lr, sched, epochs, spe = path["lr"]
    state = TrainState.create(
        model, build_optimizer("adam", lr_schedule(lr, sched, epochs, spe,
                                                   lr_min=1e-6)),
        init_state(cfg))
    step = make_train_step(model, cfg, normalize_inputs=path["uint8"])
    gen = torch.Generator(device=dev).manual_seed(1)
    shape = (batch, size, size, 3)
    if path["uint8"]:
        batches = [torch.randint(0, 256, shape, generator=gen, device=dev,
                                 dtype=torch.uint8) for _ in range(4)]
    else:
        batches = [torch.rand(shape, generator=gen, device=dev) * 2 - 1
                   for _ in range(4)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = LAUNCH_COUNTS["nearest_code"]
    times, mets = [], []
    forwards = path["warmup"] + path["timed"]
    for i in range(forwards):
        t0 = time.perf_counter()
        state, met = step(state, batches[i % len(batches)], gen)
        torch.cuda.synchronize()
        if i >= path["warmup"]:
            times.append(time.perf_counter() - t0)
        mets.append({k: float(v) for k, v in met.items()})
    launches = LAUNCH_COUNTS["nearest_code"] - start
    arch = path["width"]["arch"]
    for i, met in enumerate(mets):
        check(all(v == v and abs(v) != float("inf") for v in met.values()),
              f"{arch} {agg} step {i}: non-finite metric {met}")
        check(met["skipped_nonfinite"] == 0.0,
              f"{arch} {agg} step {i}: non-finite loss or gradient")
        check(("codebook_usage_percentage" in met) == (path["vq"] > 0),
              f"{arch} {agg} step {i}: codebook_usage_percentage "
              f"{'missing' if path['vq'] else 'present'}")
    check(launches == path["vq"] * forwards,
          f"{arch} {agg}: nearest_code launched {launches} times in "
          f"{forwards} forwards of {path['vq']} quantizers")
    med = statistics.median(times)
    res = {"arch": arch, "agg": agg, "steps": forwards,
           "nearest_code_launches": launches,
           "median_step_ms": med * 1e3, "min_step_ms": min(times) * 1e3,
           "images_per_sec": batch / med,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "first": mets[0], "last": mets[-1]}
    log(f"train {arch} {size}px batch {batch} agg={agg}: {json.dumps(res)}")
    return res, (step, state, batches, gen)


def profile_device(torch, label: str, run, steps: int, step_ms: float
                   ) -> None:
    """Device time by kernel over ``steps`` steady steps that ``run()``
    drives (run after the counts are read, so it adds no launches to a
    path's count). The busy share is kernel time over the untraced step
    time ``step_ms``: tracing slows the host several-fold."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=acts) as prof:
        run()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    # device kernels only: the CPU-side ops' device totals, and the GPU
    # ranges of annotations such as "Optimizer.step#Adam.step", would count
    # their kernels a second time. A kernel's own name can hold a "#" too,
    # in a lambda's signature ("{lambda(float)#1}": PyTorch's elementwise
    # copies, relu, sigmoid, tanh), so only "#" outside parentheses marks
    # an annotation
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and not ("#" in e.key and "(" not in e.key)
               and not getattr(e, "is_user_annotation", False)]
    attr = ("self_device_time_total"
            if hasattr(kernels[0], "self_device_time_total")
            else "self_cuda_time_total")
    kernels.sort(key=lambda e: getattr(e, attr), reverse=True)
    dev_ms = sum(getattr(e, attr) for e in kernels) / 1e3
    lines = [f"profile {label}: {steps} traced steps, wall {wall_ms:.2f} "
             f"ms; device kernel time {dev_ms / steps:.3f} ms/step against "
             f"an untraced step of {step_ms:.3f} ms "
             f"({100.0 * dev_ms / steps / step_ms:.1f}% busy), "
             f"{sum(e.count for e in kernels) // steps} kernels/step"]
    # the top 15, then every kernel in an anonymous namespace wherever it
    # ranks: the port's own kernels (and some of PyTorch's)
    for e in kernels[:15] + [e for e in kernels[15:]
                             if "anonymous namespace" in e.key]:
        lines.append(f"  {getattr(e, attr) / 1e3 / steps:9.3f} ms/step  "
                     f"{e.count // steps:5d}x  {e.key[:90]}")
    log("\n".join(lines))


# ---------------------------------------------------------------------------
# phase 4: card vs CPU lockstep
# ---------------------------------------------------------------------------

def phase_lockstep(torch, dev, small: dict, size: int, agg: str) -> float:
    """3 steps of ``agg`` from one init on the CPU and on the card, at a
    small width (``small`` overrides FULL_WIDTH): the parameters must end
    within 1e-4 of each other."""
    import numpy as np

    from movae_tpu_torch.models import get_network, init_model
    from movae_tpu_torch.moo import AggregatorConfig, init_state
    from movae_tpu_torch.train.optim import build_optimizer
    from movae_tpu_torch.train.state import TrainState
    from movae_tpu_torch.train.step import make_train_step

    width = dict(FULL_WIDTH, **small)
    rng = np.random.default_rng(0)
    batches = [torch.tensor(rng.uniform(-1, 1, (4, size, size, 3)).astype(
        np.float32)) for _ in range(3)]
    runs = {}
    for where in ("cpu", dev):
        model = init_model(get_network(size, 3, width), seed=3, device=where)
        cfg = AggregatorConfig(name=agg,
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
    log(f"lockstep card vs cpu, {width['arch']} 3 {agg} steps: losses cpu "
        f"{cpu_l} card {dev_l}, max param delta {delta:.3e}")
    check(delta < 1e-4, f"{width['arch']} {agg}: card and CPU parameters "
          f"differ by {delta:.3e}")
    return delta


# ---------------------------------------------------------------------------
# phase 12: the aggregators on the stage-1 path
# ---------------------------------------------------------------------------

def count_syncs(torch, fn) -> tuple:
    """Host synchronisations while ``fn()`` runs, as CUDA's sync debug mode
    reports them (copies between host and card, ``.item()``,
    ``synchronize``): their count and the Python lines that made them."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    sites = [f"{os.path.relpath(w.filename)}:{w.lineno}" for w in seen
             if "synchroniz" in str(w.message)]
    return len(sites), sorted(set(sites))


@contextlib.contextmanager
def deterministic_kernels(torch):
    """Deterministic kernels (cuDNN's algorithms, index_add_ without
    atomics) for a bit-for-bit comparison; the flags restored after."""
    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark,
             torch.are_deterministic_algorithms_enabled())
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = flags[0]
        torch.backends.cudnn.benchmark = flags[1]
        torch.use_deterministic_algorithms(flags[2])


class GraphedSolve:
    """A stand-in for ``aggregators._on_host`` that captures the solve on
    the card as one CUDA graph at its first call and replays it on the
    step's own Gramian after (the CUDA-graph arm of the A/B)."""

    def __init__(self, torch):
        self.torch, self.graph = torch, None

    def __call__(self, fn, G, *rest):
        torch = self.torch
        if self.graph is None:
            self.inputs = [G.clone(), *(r.clone() for r in rest)]
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                fn(*self.inputs)
            torch.cuda.current_stream().wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):
                self.out = fn(*self.inputs)
        for dst, src in zip(self.inputs, (G, *rest)):
            dst.copy_(src)
        self.graph.replay()
        return self.out.clone()


def solve_modes(torch, name: str):
    """Where ``name``'s solve runs in the A/B: on the host (the port's
    ``_on_host``), on the card (the masked Frank–Wolfe loop, cuSOLVER's
    eigh) and, for the Frank–Wolfe names, as one CUDA graph."""
    from movae_tpu_torch.moo import aggregators as agg_lib

    modes = {"host": agg_lib._on_host,
             "card": lambda fn, G, *rest: fn(G, *rest)}
    if "mgda" in name:
        modes["graph"] = GraphedSolve(torch)
    return modes


def phase_aggregators(torch, dev, profile: bool) -> dict:
    """Stage-1 training with the aggregators, beside sum and upgrad in the
    same phase; returns the results and the nearest-code launches of the
    runs (counts set to 0 just before)."""
    from movae_tpu_torch.kernels import LAUNCH_COUNTS, reset_launch_counts
    from movae_tpu_torch.moo import aggregators as agg_lib

    path = dict(STAGE1, timed=AGG_TIMED)
    others = [n for n in agg_lib.AGGREGATOR_NAMES
              if n not in CONFIG_AGGS + ("sum", "upgrad")]
    sum_ms = None
    reset_launch_counts()
    out, forwards = {}, 0
    count_syncs(torch, lambda: None)  # the debug mode's own first switch
    for agg in ("sum", "upgrad") + CONFIG_AGGS:
        res, (step, state, batches, gen) = train_mode(torch, agg, dev, path)
        if agg == "sum":
            sum_ms = res["median_step_ms"]
        syncs, sites = count_syncs(torch, lambda: step(state, batches[0],
                                                       gen))
        forwards += res["steps"] + 1
        if profile and agg in ("mgda_ln", "aligned_mtl"):
            profile_device(torch, f"agg={agg}", lambda: [
                step(state, batches[i % len(batches)], gen)
                for i in range(5)], 5, res["median_step_ms"])
            forwards += 5
        out[agg] = {"median_step_ms": res["median_step_ms"],
                    "images_per_sec": res["images_per_sec"],
                    "overhead_over_sum": res["median_step_ms"] / sum_ms,
                    "host_syncs_per_step": syncs, "sync_sites": sites,
                    "weights_last": [res["last"][f"task_{i}_weight"]
                                     for i in range(3)]}
    short = dict(path, warmup=1, timed=AGG_OTHER_STEPS - 1)
    for agg in others:
        res, _ = train_mode(torch, agg, dev, short)
        forwards += res["steps"]
        out[agg] = {"median_step_ms": res["median_step_ms"],
                    "weights_last": [res["last"][f"task_{i}_weight"]
                                     for i in range(3)]}
    launches = LAUNCH_COUNTS["nearest_code"]
    check(launches == forwards, f"nearest_code launched {launches} times in "
          f"{forwards} aggregator-phase forwards")
    log(f"aggregators on stage 1 (batch {BATCH}; {WARMUP} untimed + "
        f"{AGG_TIMED} timed steps, {AGG_OTHER_STEPS} for the others; sum "
        f"{sum_ms:.3f} ms): {json.dumps(out)}")
    out["ab"] = phase_solve_ab(torch, dev, path)
    return {"results": out, "nearest_code_launches": launches}


def phase_solve_ab(torch, dev, path: dict) -> dict:
    """Where the Frank–Wolfe (mgda_ln) and eigh (aligned_mtl) solves run:
    each mode's step time (median of the timed steps, modes in turns: host,
    card, graph, host) and the solve alone on the step's own Gramian (host
    clock around compute_weights and a synchronize, median of 20); each
    mode's weights against the host's on that Gramian. These runs are not
    counted in the kernel row (the A/B repeats phase 12's path)."""
    from movae_tpu_torch.moo import aggregators as agg_lib

    res = {}
    for agg in ("mgda_ln", "aligned_mtl"):
        modes = solve_modes(torch, agg)
        order = list(modes) + ["host"]
        steps, grams, solve = {}, [], {}
        spied = agg_lib.compute_weights

        def spy(cfg, G, *a, **kw):
            grams.append((G.detach().clone(), a[0].detach().clone()))
            return spied(cfg, G, *a, **kw)

        for i, mode in enumerate(order):
            agg_lib._on_host, saved = modes[mode], agg_lib._on_host
            agg_lib.compute_weights = spy if i == 0 else spied
            try:
                r, _ = train_mode(torch, agg, dev, path)
            finally:
                agg_lib._on_host, agg_lib.compute_weights = saved, spied
            steps.setdefault(mode, []).append(r["median_step_ms"])
        G, losses = grams[-1]
        cfg = agg_lib.AggregatorConfig(name=agg, num_objectives=G.shape[0])
        ref = None
        for mode, where in modes.items():
            agg_lib._on_host, saved = where, agg_lib._on_host
            try:
                times = []
                for _ in range(23):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    alpha, _ = agg_lib.compute_weights(cfg, G, losses, {})
                    torch.cuda.synchronize()
                    times.append(time.perf_counter() - t0)
            finally:
                agg_lib._on_host = saved
            ref = alpha if ref is None else ref
            err = float((alpha - ref).abs().max())
            solve[mode] = {"solve_ms": statistics.median(times[3:]) * 1e3,
                           "max_abs_err_vs_host": err}
            check(err <= 1e-4 * max(1.0, float(ref.abs().max())),
                  f"{agg} weights with the solve on {mode} are off the "
                  f"host's: {err:.3e}")
        res[agg] = {"step_ms": steps, "solve": solve}
    log(f"solve A/B (stage 1, batch {BATCH}): {json.dumps(res)}")
    return res


# ---------------------------------------------------------------------------
# phase 13: the gradient-guided VQ models
# ---------------------------------------------------------------------------

def phase_gg(torch, dev, profile: bool) -> dict:
    """gg_vq_vae_v3 and gg_vq_vae2 at their configs' widths with mgda_ln
    and upgrad; nearest-code launches counted (set to 0 just before);
    card vs CPU locksteps at a small width."""
    from movae_tpu_torch.kernels import LAUNCH_COUNTS, reset_launch_counts

    reset_launch_counts()
    out, expected = {}, 0
    for path in (GG_V3, GG_V2):
        arch = path["width"]["arch"]
        for agg in ("mgda_ln", "upgrad"):
            res, (step, state, batches, gen) = train_mode(torch, agg, dev,
                                                          path)
            expected += path["vq"] * res["steps"]
            out[f"{arch} {agg}"] = res
            if profile:
                n = len(batches)
                profile_device(torch, f"{arch} agg={agg}", lambda: [
                    step(state, batches[i % n], gen) for i in range(3)], 3,
                    res["median_step_ms"])
                expected += path["vq"] * 3
            del state, batches
            torch.cuda.empty_cache()
    launches = LAUNCH_COUNTS["nearest_code"]
    check(launches == expected, f"nearest_code launched {launches} times in "
          f"the GG-VQ runs, expected {expected}")
    phase_lockstep(torch, dev, dict(arch="gg_vq_vae_v3", hidden_dims=(8, 16),
                                    embedding_dim=8, num_embeddings=32,
                                    recons_activation="none"), 16, "mgda_ln")
    phase_lockstep(torch, dev, dict(arch="gg_vq_vae2", hidden_dims=(16, 32),
                                    embedding_dim=8, num_embeddings=32,
                                    recons_activation="none"), 32,
                   "aligned_mtl")
    return {"results": out, "nearest_code_launches": launches}


# ---------------------------------------------------------------------------
# phase 5: the stage-2 path, code extraction + full-width PixelSNAIL training
# ---------------------------------------------------------------------------

def phase_prior(torch, dev, profile: bool, compute_dtype: str = "float32"):
    """Returns the path's numbers and the trained prior with a batch of its
    codes; the VQ-VAE and the prior compute in ``compute_dtype``."""
    from types import SimpleNamespace

    from movae_tpu_torch.kernels import LAUNCH_COUNTS, reset_launch_counts
    from movae_tpu_torch.models import get_network, init_model
    from movae_tpu_torch.train.prior import extract_codes, train_prior

    vq = init_model(get_network(PRIOR_SIZE, 3, dict(
        FULL_WIDTH, compute_dtype=compute_dtype)), seed=0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    steps = PRIOR_WARMUP + PRIOR_TIMED
    n_batches = -(-steps * PRIOR_BATCH // EXTRACT_BATCH)
    images = [torch.randint(0, 256, (EXTRACT_BATCH, PRIOR_SIZE, PRIOR_SIZE,
                                     3), generator=gen, device=dev,
                            dtype=torch.uint8) for _ in range(n_batches)]
    args = SimpleNamespace(**PRIOR_ARGS, compute_dtype=compute_dtype)
    trace = []
    warm = PRIOR_WARMUP * PRIOR_BATCH

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    extract = extract_codes(vq, normalize_inputs=True)
    codes = torch.cat([extract(x) for x in images])[:steps * PRIOR_BATCH]
    codes = codes.cpu().numpy()
    extract_s = time.perf_counter() - t0
    # untimed steps in one call, then the timed steps in a second call on
    # the same prior, timed as one window (the loop's own syncs only)
    out = train_prior({"codes": codes[:warm]}, vq, args, device=dev,
                      step_trace=trace)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = train_prior({"codes": codes[warm:]}, vq, args, device=dev,
                      step_trace=trace, prior=out["model"])
    torch.cuda.synchronize()
    window_s = time.perf_counter() - t0
    counts = dict(LAUNCH_COUNTS)

    grid = PRIOR_SIZE // 4
    check(codes.shape == (steps * PRIOR_BATCH, grid, grid)
          and str(codes.dtype) == "int32"
          and 0 <= codes.min() and codes.max() < FULL_WIDTH["num_embeddings"],
          f"extracted codes: shape {codes.shape} dtype {codes.dtype} range "
          f"[{codes.min()}, {codes.max()}]")
    check(len(trace) == steps,
          f"prior ran {len(trace)} steps, expected {steps}")
    check(all(v == v and abs(v) != float("inf") for v in trace),
          f"non-finite prior CE: {trace}")
    check(trace[-1] < trace[0], f"prior CE did not fall: {trace}")
    layers = PRIOR_ARGS["pixelsnail_num_blocks"]
    for name in FLASH_KERNELS:
        check(counts[name] == layers * steps,
              f"{name} launched {counts[name]} times in {steps} prior steps "
              f"of {layers} attention layers")
    check(counts["nearest_code"] == n_batches,
          f"nearest_code launched {counts['nearest_code']} times in "
          f"{n_batches} extraction batches")
    step_s = window_s / PRIOR_TIMED
    res = {"steps": steps, "extract_batches": n_batches,
           "distinct_codes": int(len(set(codes.reshape(-1).tolist()))),
           "launches": counts, "extract_s": extract_s,
           "timed_steps": PRIOR_TIMED, "window_s": window_s,
           "step_ms": step_s * 1e3,
           "codes_per_sec": PRIOR_BATCH * grid * grid / step_s,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "ce_first": trace[0], "ce_last": trace[-1]}
    log(f"prior (PixelSNAIL, L={grid * grid}, batch {PRIOR_BATCH}, "
        f"{compute_dtype}): {json.dumps(res)}")
    if profile:
        few = {"codes": codes[:5 * PRIOR_BATCH]}
        profile_device(torch, "prior", lambda: train_prior(
            few, vq, args, device=dev, prior=out["model"]), 5,
            res["step_ms"])
    return res, out["model"], codes[:4]


def phase_prior_kernels(torch, fa, prior, codes) -> dict:
    """The flash kernels against their plain version on the trained
    prior's own q, k, v: those of its last attention layer, on 4 of the
    extracted code grids (cotangent: seeded noise). Its logits reach ~1e4
    (the random-init prior's activations grow block by block), where float32
    itself is off by ~1e-4 of the largest output, so the reference is the
    plain version in float64."""
    attn = prior.blocks[-1].attention
    seen = []
    hook = attn.register_forward_pre_hook(lambda mod, a: seen.append(a[0]))
    dev = next(prior.parameters()).device
    with torch.no_grad():
        prior.logits_nchw(torch.from_numpy(codes).to(dev))
        q, k, v = attn.qkv(seen[0])
    hook.remove()
    do = torch.randn(q.shape, device=dev,
                     generator=torch.Generator(device=dev).manual_seed(6))
    worst = dict.fromkeys(FLASH_KERNELS, 0.0)
    check_flash(torch, fa, f"trained prior q/k/v {tuple(q.shape)}", q, k,
                v, do, worst, exact=True)
    return worst


# ---------------------------------------------------------------------------
# phase 6: prior training, card vs CPU
# ---------------------------------------------------------------------------

def phase_prior_lockstep(torch, dev) -> float:
    import numpy as np
    from types import SimpleNamespace

    from movae_tpu_torch.train.prior import train_prior

    # a 40x40 grid (L=1600 > 1024: the card runs the flash kernels), head
    # dim 32 / 2 = 16, dropout 0, adam eps 1e-4 as in phase 4
    codes = np.random.default_rng(0).integers(0, 32, (6, 40, 40)).astype(
        np.int32)
    args = SimpleNamespace(prior_type="pixelsnail", batch_size=2, seed=3,
                           pixelcnn_epochs=1, pixelcnn_hidden_channels=32,
                           pixelsnail_num_blocks=1,
                           pixelsnail_num_res_blocks=1,
                           pixelsnail_num_heads=2, pixelsnail_dropout=0.0,
                           pixelcnn_adam_eps=1e-4)
    meta = SimpleNamespace(num_embeddings=32, embedding_dim=8)
    runs = {}
    for where in ("cpu", dev):
        trace = []
        out = train_prior({"codes": codes}, meta, args, device=where,
                          step_trace=trace)
        runs[str(where)] = (out["model"].state_dict(), trace)
    (cpu_sd, cpu_ce), (dev_sd, dev_ce) = runs["cpu"], runs[str(dev)]
    delta = max(float((cpu_sd[k] - dev_sd[k].cpu()).abs().max())
                for k in cpu_sd)
    log(f"prior lockstep card vs cpu, 3 steps at L=1600: CE cpu {cpu_ce} "
        f"card {dev_ce}, max param delta {delta:.3e}")
    check(len(dev_ce) == 3, f"prior lockstep ran {len(dev_ce)} steps")
    check(delta < 1e-4, f"card and CPU prior parameters differ by "
          f"{delta:.3e}")
    return delta


# ---------------------------------------------------------------------------
# phase 7: the 256-px VQ-VAE-2 path, training and code extraction
# ---------------------------------------------------------------------------

def vq_rows(torch, model, x) -> list:
    """The two quantizers' inputs on the images ``x``, as the contiguous
    (N, D) rows in NHWC order that ``nearest_code`` sees, with their
    codebooks: [(top rows, top codebook), (bottom rows, bottom codebook)]."""
    seen = []
    hooks = [conv.register_forward_hook(lambda m, a, out: seen.append(out))
             for conv in (model.quantize_conv_t, model.quantize_conv_b)]
    with torch.no_grad():
        model.get_code_indices_pair(x)
    for h in hooks:
        h.remove()
    d = model.embedding_dim
    rows = [out.permute(0, 2, 3, 1).reshape(-1, d).contiguous()
            for out in seen]
    return [(rows[0], model.quantize_t().detach().contiguous()),
            (rows[1], model.quantize_b().detach().contiguous())]


def check_vqvae2_latents(torch, nc, model) -> float:
    """``nearest_code`` against its plain version on the trained VQ-VAE-2's
    own latents at both levels (N = 131,072 and 524,288 rows), near ties
    excepted as in phase 2; returns the largest float64 distance error."""
    from movae_tpu_torch.train.step import preprocess_batch

    gen = torch.Generator(device=next(model.parameters()).device)
    x = preprocess_batch(torch.randint(
        0, 256, (V2_BATCH, V2_SIZE, V2_SIZE, 3), generator=gen.manual_seed(4),
        device=gen.device, dtype=torch.uint8), True)
    worst = 0.0
    for level, (z, cb) in zip(("top", "bottom"), vq_rows(torch, model, x)):
        res = compare_nearest(torch, nc, z, cb)
        log(f"nearest_code on trained VQ-VAE-2 {level} latents: "
            f"{json.dumps(res)}")
        check(res["bad"] == 0 and res["in_range"],
              f"nearest_code disagrees on trained {level} latents: {res}")
        worst = max(worst, res["max_abs_err"])
    return worst


def phase_vqvae2_extract(torch, model, dev) -> tuple:
    """(top, bottom) code grids of V2_EXTRACT_BATCHES batches of seeded
    uint8 images through ``extract_codes(hierarchical=True)``: two
    nearest-code launches a batch."""
    from movae_tpu_torch.kernels import LAUNCH_COUNTS
    from movae_tpu_torch.train.prior import extract_codes

    gen = torch.Generator(device=dev).manual_seed(3)
    images = [torch.randint(0, 256, (V2_BATCH, V2_SIZE, V2_SIZE, 3),
                            generator=gen, device=dev, dtype=torch.uint8)
              for _ in range(V2_EXTRACT_BATCHES)]
    extract = extract_codes(model, normalize_inputs=True, hierarchical=True)
    torch.cuda.synchronize()
    start = LAUNCH_COUNTS["nearest_code"]
    t0 = time.perf_counter()
    pairs = [extract(x) for x in images]
    torch.cuda.synchronize()
    extract_s = time.perf_counter() - t0
    launches = LAUNCH_COUNTS["nearest_code"] - start
    top = torch.cat([t for t, _ in pairs]).cpu().numpy()
    bottom = torch.cat([b for _, b in pairs]).cpu().numpy()
    n, st, sb = V2_EXTRACT_BATCHES * V2_BATCH, V2_SIZE // 8, V2_SIZE // 4
    for name, codes, side in (("top", top, st), ("bottom", bottom, sb)):
        check(codes.shape == (n, side, side) and str(codes.dtype) == "int32"
              and 0 <= codes.min() and codes.max() < SLICE_K,
              f"extracted {name} codes: shape {codes.shape} dtype "
              f"{codes.dtype} range [{codes.min()}, {codes.max()}]")
    check(launches == 2 * V2_EXTRACT_BATCHES,
          f"nearest_code launched {launches} times in {V2_EXTRACT_BATCHES} "
          f"VQ-VAE-2 extraction batches")
    res = {"batches": V2_EXTRACT_BATCHES, "nearest_code_launches": launches,
           "extract_s": extract_s,
           "images_per_sec": n / extract_s,
           "distinct_top": int(len(set(top.reshape(-1).tolist()))),
           "distinct_bottom": int(len(set(bottom.reshape(-1).tolist())))}
    log(f"extract VQ-VAE-2 codes (top {st}x{st}, bottom {sb}x{sb}): "
        f"{json.dumps(res)}")
    return res, top, bottom


# ---------------------------------------------------------------------------
# phase 8: the hierarchical priors on the extracted codes
# ---------------------------------------------------------------------------

def phase_hier_prior(torch, dev, vq, top, bottom, profile: bool) -> tuple:
    """The HierarchicalPixelCNN the configs build: HPRIOR_WARMUP untimed
    steps in one call, then HPRIOR_TIMED in a second call timed as one
    window; then HSNAIL_STEPS steps of HierarchicalPixelSNAIL, whose top
    runs dense attention at L=1024 (no flash launch). Returns the results
    and the trained HierarchicalPixelCNN."""
    from types import SimpleNamespace

    from movae_tpu_torch.kernels import LAUNCH_COUNTS, reset_launch_counts
    from movae_tpu_torch.train.prior import train_prior

    args = SimpleNamespace(**HPRIOR_ARGS)
    warm = HPRIOR_WARMUP * HPRIOR_BATCH
    end = warm + HPRIOR_TIMED * HPRIOR_BATCH
    trace = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = train_prior({"top": top[:warm], "bottom": bottom[:warm]}, vq, args,
                      device=dev, step_trace=trace)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = train_prior({"top": top[warm:end], "bottom": bottom[warm:end]}, vq,
                      args, device=dev, step_trace=trace, prior=out["model"])
    torch.cuda.synchronize()
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    steps = HPRIOR_WARMUP + HPRIOR_TIMED
    prior = out["model"]
    check(out["hierarchical"] and type(prior).__name__
          == "HierarchicalPixelCNN", f"built {type(prior).__name__}")
    check(len(trace) == steps and all(v == v and abs(v) != float("inf")
                                      for v in trace),
          f"hierarchical prior CE over {steps} steps: {trace}")
    check(trace[-1] < trace[0], f"hierarchical prior CE did not fall: "
          f"{trace}")
    step_s = window_s / HPRIOR_TIMED
    codes = top.shape[1] * top.shape[2] + bottom.shape[1] * bottom.shape[2]
    res = {"steps": steps, "timed_steps": HPRIOR_TIMED,
           "window_s": window_s, "step_ms": step_s * 1e3,
           "codes_per_sec": HPRIOR_BATCH * codes / step_s,
           "peak_mem_gib": peak, "ce_first": trace[0], "ce_last": trace[-1]}
    log(f"hierarchical prior (HierarchicalPixelCNN, top {top.shape[1:]}, "
        f"bottom {bottom.shape[1:]}, batch {HPRIOR_BATCH}): "
        f"{json.dumps(res)}")
    if profile:
        few = {"top": top[:3 * HPRIOR_BATCH],
               "bottom": bottom[:3 * HPRIOR_BATCH]}
        profile_device(torch, "hierarchical prior", lambda: train_prior(
            few, vq, args, device=dev, prior=prior), 3, res["step_ms"])

    snail_args = SimpleNamespace(**HSNAIL_ARGS)
    n = HSNAIL_STEPS * HPRIOR_BATCH
    snail_trace = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    snail = train_prior({"top": top[:n], "bottom": bottom[:n]}, vq,
                        snail_args, device=dev, step_trace=snail_trace)
    torch.cuda.synchronize()
    snail_s = time.perf_counter() - t0
    flash = {k: v for k, v in LAUNCH_COUNTS.items() if k.startswith("flash")}
    check(type(snail["model"]).__name__ == "HierarchicalPixelSNAIL",
          f"built {type(snail['model']).__name__}")
    check(len(snail_trace) == HSNAIL_STEPS
          and all(v == v and abs(v) != float("inf") for v in snail_trace),
          f"hierarchical PixelSNAIL CE: {snail_trace}")
    check(not any(flash.values()),
          f"flash kernels launched at L={top.shape[1] * top.shape[2]} "
          f"(dense attention expected): {flash}")
    snail_res = {"steps": HSNAIL_STEPS, "wall_s": snail_s,
                 "flash_launches": flash, "ce": snail_trace,
                 "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    log(f"hierarchical prior (HierarchicalPixelSNAIL, dense top attention "
        f"at L={top.shape[1] * top.shape[2]}): {json.dumps(snail_res)}")
    del snail
    torch.cuda.empty_cache()
    return res, prior


# ---------------------------------------------------------------------------
# phase 9: sampling, and the samplers held against the naive one
# ---------------------------------------------------------------------------

def phase_sampling(torch, dev, hprior, vq, snail, profile: bool) -> dict:
    """sample_hierarchical from the trained HierarchicalPixelCNN (top
    32x32, bottom 64x64, batch 16), decoded by VQVAE2.decode_code; then
    sample_fast_snail from stage 2's trained PixelSNAIL at 64x64 with the
    int8 and the float32 caches, on the same noise."""
    from movae_tpu_torch.models import pixelcnn as pc

    b, st, sb = SAMPLE_BATCH, V2_SIZE // 8, V2_SIZE // 4
    gen = torch.Generator(device=dev).manual_seed(7)
    marks = []
    level_split = hprior.condition_from_top

    def marked(z):  # the top level has been sampled: mark the time
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        return level_split(z)

    hprior.condition_from_top = marked
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    zt, zb = pc.sample_hierarchical(hprior, gen, b, (st, st), (sb, sb))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    del hprior.condition_from_top
    with torch.no_grad():
        images = vq.decode_code(zt, zb)
    torch.cuda.synchronize()
    for name, z, side in (("top", zt, st), ("bottom", zb, sb)):
        check(tuple(z.shape) == (b, side, side) and int(z.min()) >= 0
              and int(z.max()) < SLICE_K,
              f"sampled {name} codes: shape {tuple(z.shape)} range "
              f"[{int(z.min())}, {int(z.max())}]")
    check(tuple(images.shape) == (b, V2_SIZE, V2_SIZE, 3)
          and bool(torch.isfinite(images).all()),
          f"decoded images: shape {tuple(images.shape)}, finite "
          f"{bool(torch.isfinite(images).all())}")
    top_s, bottom_s = marks[0] - t0, t1 - marks[0]
    res = {"hierarchical_top_px_per_sec": b * st * st / top_s,
           "hierarchical_bottom_px_per_sec": b * sb * sb / bottom_s,
           "hierarchical_top_s": top_s, "hierarchical_bottom_s": bottom_s,
           "distinct_top": int(zt.unique().numel()),
           "distinct_bottom": int(zb.unique().numel()),
           "images_range": [float(images.min()), float(images.max())]}

    flat = PRIOR_SIZE // 4
    noise = pc.gumbel_noise(gen, flat * flat, b, SLICE_K, dev)
    codes = {}
    for name, dtype in (("int8", torch.int8), ("f32", torch.float32)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        codes[name] = pc.sample_fast_snail(snail, None, b, flat, flat,
                                           cache_dtype=dtype, gumbel=noise)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        z = codes[name]
        check(int(z.min()) >= 0 and int(z.max()) < SLICE_K,
              f"sample_fast_snail {name}: codes out of range")
        res[f"snail_{name}_px_per_sec"] = b * flat * flat / secs
        res[f"snail_{name}_s"] = secs
        if profile:
            rows = 2
            profile_device(torch, f"sampler PixelSNAIL {name} cache (first "
                           f"{rows} rows; per pixel)",
                           lambda: pc.sample_fast_snail(
                               snail, None, b, rows, flat, cache_dtype=dtype,
                               gumbel=noise[:rows * flat]),
                           rows * flat, secs / (flat * flat) * 1e3)
    # once a pixel's draw differs the two sequences part, so the agreement
    # is read with the raster index of each row's first difference
    diff = (codes["int8"] != codes["f32"]).reshape(b, -1)
    res["snail_int8_f32_code_agreement"] = float(
        (~diff).float().mean())
    res["snail_int8_f32_first_difference"] = [
        int(r.nonzero()[0, 0]) if bool(r.any()) else flat * flat
        for r in diff]
    if not profile:
        res["launches_per_pixel"] = "not measured (run with --profile)"
    log(f"sampling (batch {b}; hierarchical top {st}x{st}, bottom "
        f"{sb}x{sb}; flat PixelSNAIL {flat}x{flat}): {json.dumps(res)}")
    return res


def first_mismatches(torch, model, fast, naive, noise, condition=None
                     ) -> dict:
    """Rows where ``fast`` and ``naive`` codes differ, judged at their first
    differing pixel (later pixels follow other histories): a near tie if the
    top two perturbed logits there lie within SAMPLE_TIE. The logits come
    from the full forward on the naive codes, whose prefix up to that pixel
    both samplers share."""
    b = fast.shape[0]
    diff = (fast != naive).reshape(b, -1)
    res = {"rows": b, "rows_equal": int((~diff.any(1)).sum()),
           "near_tie": 0, "bad": 0, "gaps": []}
    if res["rows_equal"] == b:
        return res
    with torch.no_grad():
        logits = model(naive, condition=condition).reshape(b, diff.shape[1],
                                                           -1)
    for row in diff.any(1).nonzero()[:, 0].tolist():
        t = int(diff[row].nonzero()[0, 0])
        top2 = (logits[row, t] + noise[t, row]).topk(2).values
        gap = float(top2[0] - top2[1])
        res["gaps"].append(gap)
        res["near_tie" if gap < SAMPLE_TIE else "bad"] += 1
    return res


def phase_sampler_checks(torch, dev, hprior, snail) -> dict:
    """At small grids on the card, with the same noise: sample_fast (both
    hierarchical levels, the bottom on the condition of the sampled top) and
    sample_fast_snail (float32 cache) give sample_naive's codes, near ties
    excepted; sample_fast_snail's teacher-forced logits on the card match
    the same call on the CPU. The trained prior's attention logits reach
    ~1e4, where float32 is off by ~1e-4 of the largest output logit, so
    both are held against the call in float64 on the CPU: the card within
    1e-4 of the largest logit or FLASH_PLAIN_FACTOR times the CPU float32
    call's own error, whichever is larger (as phase 5 holds the flash
    kernels)."""
    import copy

    from movae_tpu_torch.models import pixelcnn as pc

    b = CHECK_BATCH
    gen = torch.Generator(device=dev).manual_seed(11)
    out = {}
    top_shape = CHECK_TOP
    bottom_shape = (2 * top_shape[0], 2 * top_shape[1])
    g = pc.gumbel_noise(gen, top_shape[0] * top_shape[1], b, SLICE_K, dev)
    fast = pc.sample_fast(hprior.prior_top, None, b, *top_shape, gumbel=g)
    naive = pc.sample_naive(hprior.prior_top, None, b, *top_shape, gumbel=g)
    out["top"] = first_mismatches(torch, hprior.prior_top, fast, naive, g)
    with torch.no_grad():
        cond = hprior.condition_from_top(fast)
    g = pc.gumbel_noise(gen, bottom_shape[0] * bottom_shape[1], b, SLICE_K,
                        dev)
    args = (None, b, *bottom_shape)
    fast = pc.sample_fast(hprior.prior_bottom, *args, condition=cond,
                          gumbel=g)
    naive = pc.sample_naive(hprior.prior_bottom, *args, condition=cond,
                            gumbel=g)
    out["bottom"] = first_mismatches(torch, hprior.prior_bottom, fast, naive,
                                     g, cond)
    g = pc.gumbel_noise(gen, CHECK_FLAT[0] * CHECK_FLAT[1], b, SLICE_K, dev)
    fast = pc.sample_fast_snail(snail, None, b, *CHECK_FLAT,
                                cache_dtype=torch.float32, gumbel=g)
    naive = pc.sample_naive(snail, None, b, *CHECK_FLAT, gumbel=g)
    out["snail_f32"] = first_mismatches(torch, snail, fast, naive, g)
    for name, r in out.items():
        check(r["bad"] == 0, f"cached sampler ({name}) drew other codes than "
              f"sample_naive away from a near tie: {r}")

    forced = torch.randint(0, SLICE_K, (b, *CHECK_FLAT), generator=gen,
                           device=dev)
    _, on_card = pc.sample_fast_snail(snail, None, b, *CHECK_FLAT,
                                      cache_dtype=torch.float32,
                                      forced=forced, return_logits=True)
    on_cpu = {}
    for dtype in (torch.float32, torch.float64):
        model = copy.deepcopy(snail).cpu().to(dtype)
        _, on_cpu[dtype] = pc.sample_fast_snail(
            model, None, b, *CHECK_FLAT, cache_dtype=dtype,
            forced=forced.cpu(), return_logits=True)
    exact = on_cpu[torch.float64]
    scale = float(exact.abs().max())
    res = {"max_abs_err": float((on_card.cpu().double() - exact).abs().max()),
           "plain_err": float((on_cpu[torch.float32].double()
                               - exact).abs().max()),
           "card_vs_cpu": float((on_card.cpu()
                                 - on_cpu[torch.float32]).abs().max()),
           "max_abs": scale}
    out["forced_logits"] = res
    log(f"sampler checks on the card (batch {b}; top {top_shape}, bottom "
        f"{bottom_shape}, flat {CHECK_FLAT}): {json.dumps(out)}")
    limit = max(1e-4 * scale, FLASH_PLAIN_FACTOR * res["plain_err"])
    check(res["max_abs_err"] <= limit,
          f"forced logits on the card are off the float64 CPU call: {res} "
          f"(limit {limit:.3e})")
    return out


# ---------------------------------------------------------------------------
# phase 14: the wavefront sampler
# ---------------------------------------------------------------------------

def timed_sample(torch, fn) -> tuple:
    """(codes, wall seconds) of one sampler call, the card synchronized."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    z = fn()
    torch.cuda.synchronize()
    return z, time.perf_counter() - t0


def phase_wavefront(torch, dev, hprior, profile: bool) -> dict:
    """sample_wavefront against sample_fast on the trained hierarchical
    PixelCNN under one Gumbel draw: its top at 32x32 and its bottom at
    64x64 on the condition of the sampled top, at batch 16 and 128 (the
    A/B, pixels/s), and at small grids; codes must agree but for near ties
    (SAMPLE_TIE, judged at each row's first difference); then a front's
    forced logits on the card against float64 on the CPU. Returns the
    results and the raster sampler's seconds for one generation chunk
    (batch 128, both levels)."""
    import copy

    from movae_tpu_torch.models import pixelcnn as pc

    st, sb = V2_SIZE // 8, V2_SIZE // 4
    gen = torch.Generator(device=dev).manual_seed(13)
    res, chunk_raster_s = {}, 0.0
    for b in WAVE_BATCHES:
        cond = None
        for level, model, side in (("top", hprior.prior_top, st),
                                   ("bottom", hprior.prior_bottom, sb)):
            g = pc.gumbel_noise(gen, side * side, b, SLICE_K, dev)
            args = (model, None, b, side, side)
            wave, wave_s = timed_sample(torch, lambda: pc.sample_wavefront(
                *args, condition=cond, gumbel=g))
            fast, fast_s = timed_sample(torch, lambda: pc.sample_fast(
                *args, condition=cond, gumbel=g))
            fronts = pc.wavefront_steps(model.kernel_size, side, side)
            r = first_mismatches(torch, model, wave, fast, g, cond)
            check(r["bad"] == 0, f"sample_wavefront drew other codes than "
                  f"sample_fast away from a near tie ({level}, batch {b}): "
                  f"{r}")
            res[f"{level} {side}x{side} batch {b}"] = {
                "fronts": fronts, "wavefront_s": wave_s, "raster_s": fast_s,
                "wavefront_px_per_sec": b * side * side / wave_s,
                "raster_px_per_sec": b * side * side / fast_s,
                "speedup": fast_s / wave_s,
                "ms_per_front": wave_s / fronts * 1e3,
                "ms_per_raster_step": fast_s / (side * side) * 1e3,
                "rows_equal": r["rows_equal"], "near_tie": r["near_tie"]}
            if b == S3_BATCH:
                chunk_raster_s += fast_s
            if profile:
                profile_device(torch, f"wavefront {level} {side}x{side} "
                               f"batch {b} (per front)",
                               lambda: pc.sample_wavefront(
                                   *args, condition=cond, gumbel=g),
                               fronts, wave_s / fronts * 1e3)
                rows = 2
                part = None if cond is None else cond[:, :rows]
                profile_device(torch, f"raster {level} batch {b} (first "
                               f"{rows} rows; per pixel)",
                               lambda: pc.sample_fast(
                                   model, None, b, rows, side,
                                   condition=part, gumbel=g[:rows * side]),
                               rows * side, fast_s / (side * side) * 1e3)
            if level == "top":
                with torch.no_grad():
                    cond = hprior.condition_from_top(fast)
    log(f"wavefront vs raster (hierarchical PixelCNN; one Gumbel draw per "
        f"level and batch): {json.dumps(res)}")

    # small grids: the top at 8x8 and the bottom at 16x16 on its condition,
    # and a grid narrower than s (the raster sampler's case)
    b, small = CHECK_BATCH, {}
    cond = None
    for level, model, shape in (
            ("top", hprior.prior_top, WAVE_CHECK_TOP),
            ("bottom", hprior.prior_bottom, tuple(2 * x for x in
                                                   WAVE_CHECK_TOP)),
            ("top narrow", hprior.prior_top, (6, 3))):
        g = pc.gumbel_noise(gen, shape[0] * shape[1], b, SLICE_K, dev)
        c = cond if level == "bottom" else None
        wave = pc.sample_wavefront(model, None, b, *shape, condition=c,
                                   gumbel=g)
        naive = pc.sample_naive(model, None, b, *shape, condition=c,
                                gumbel=g)
        small[level] = r = first_mismatches(torch, model, wave, naive, g, c)
        check(r["bad"] == 0, f"sample_wavefront ({level}, {shape}) drew other "
              f"codes than sample_naive away from a near tie: {r}")
        if level == "top":
            with torch.no_grad():
                cond = hprior.condition_from_top(naive)

    # a front's logits on forced codes: card float32 against the CPU in
    # float64, within 1e-4 of the largest logit or twice the CPU float32
    # call's own error (as phase 9 holds sample_fast_snail's)
    shape = tuple(2 * x for x in WAVE_CHECK_TOP)
    forced = torch.randint(0, SLICE_K, (b, *shape), generator=gen,
                           device=dev)
    runs = {}
    for where, dtype in (("card", torch.float32), ("cpu32", torch.float32),
                         ("cpu64", torch.float64)):
        model = hprior.prior_bottom
        c, z = cond, forced
        if where != "card":
            model = copy.deepcopy(model).cpu().to(dtype)
            c, z = cond.cpu().to(dtype), forced.cpu()
        logits = torch.zeros((b, shape[0] * shape[1], SLICE_K), dtype=dtype,
                             device=z.device)

        def read(lg, t, logits=logits, z=z):
            logits[:, t] = lg
            return z.reshape(b, -1)[:, t]

        with torch.no_grad():
            pc._sample_fronts(model, b, *shape, c, 1.0, read)
        runs[where] = logits.cpu().double()
    exact = runs["cpu64"]
    scale = float(exact.abs().max())
    forced_res = {"max_abs_err": float((runs["card"] - exact).abs().max()),
                  "plain_err": float((runs["cpu32"] - exact).abs().max()),
                  "max_abs": scale}
    limit = max(1e-4 * scale, FLASH_PLAIN_FACTOR * forced_res["plain_err"])
    log(f"wavefront checks (batch {b}; top {WAVE_CHECK_TOP}, bottom "
        f"{shape}, narrow (6, 3)): {json.dumps(small)}; forced front "
        f"logits on the card vs float64: {json.dumps(forced_res)}")
    check(forced_res["max_abs_err"] <= limit,
          f"forced front logits on the card are off the float64 CPU call: "
          f"{forced_res} (limit {limit:.3e})")
    return {"ab": res, "small": small, "forced_logits": forced_res,
            "chunk_raster_s": chunk_raster_s}


# ---------------------------------------------------------------------------
# phase 11: stage 3, the metric towers and run_final_metrics
# ---------------------------------------------------------------------------

def median_ms(torch, fn, reps: int = S3_TIMED, warmup: int = 2) -> float:
    """Median device time of ``fn`` over ``reps`` calls, each between its
    own pair of CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def held_against_float64(torch, label: str, card, cpu32, cpu64) -> dict:
    """Card float32 outputs against the same module in float64 on the CPU:
    within TOWER_TOL of the largest value or TOWER_PLAIN_FACTOR times the
    float32 CPU module's own error, whichever is larger."""
    res = {}
    for name in cpu64:
        exact = cpu64[name].double()
        scale = float(exact.abs().max())
        err = float((card[name].detach().cpu().double() - exact).abs().max())
        plain = float((cpu32[name].double() - exact).abs().max())
        limit = max(TOWER_TOL * scale, TOWER_PLAIN_FACTOR * plain)
        res[name] = {"max_abs_err": err, "plain_err": plain,
                     "max_abs": scale, "limit": limit}
        check(err <= limit, f"{label} {name} on the card is off the float64 "
              f"CPU tower: {res[name]}")
    return res


def phase_towers(torch, dev, profile: bool) -> dict:
    """The Inception tower (``InceptionTower.get``, which the recon and
    generation passes then use) and a VGG16, each built once, held on the
    card against themselves in float64 on the CPU, then timed."""
    import copy

    import numpy as np

    from movae_tpu_torch.metrics.features import (InceptionTower,
                                                  inception_preprocess)
    from movae_tpu_torch.metrics.vgg import (build_vgg16, lpips_from_taps,
                                             make_lpips_fn, preprocess)

    tower = InceptionTower.get(dev)
    vgg = build_vgg16(device=dev)
    rng = np.random.default_rng(21)
    small = rng.uniform(-1, 1, (S3_CHECK, S3_CHECK_SIZE, S3_CHECK_SIZE, 3))
    big = rng.uniform(-1, 1, (S3_CHECK, V2_SIZE, V2_SIZE, 3))
    res = {}
    cpu = {dt: copy.deepcopy(tower.model).cpu().to(dt)
           for dt in (torch.float32, torch.float64)}
    with torch.no_grad():
        for method in ("bicubic", "bilinear"):
            outs = {}
            for where, model, dt in (("card", tower.model, torch.float32),
                                     ("cpu32", cpu[torch.float32],
                                      torch.float32),
                                     ("cpu64", cpu[torch.float64],
                                      torch.float64)):
                x = torch.tensor(small, dtype=dt,
                                 device=dev if where == "card" else "cpu")
                f, lg = model(inception_preprocess(x, method))
                outs[where] = {"features": f, "logits": lg}
            res[f"inception_{method}"] = held_against_float64(
                torch, f"inception ({method})", *outs.values())
    del cpu
    cpu = {dt: copy.deepcopy(vgg).cpu().to(dt)
           for dt in (torch.float32, torch.float64)}
    with torch.no_grad():
        outs = {}
        for where, model, dt in (("card", vgg, torch.float32),
                                 ("cpu32", cpu[torch.float32], torch.float32),
                                 ("cpu64", cpu[torch.float64],
                                  torch.float64)):
            x = torch.tensor(big, dtype=dt,
                             device=dev if where == "card" else "cpu")
            taps = model(preprocess(x))
            half = S3_CHECK // 2
            taps["lpips"] = lpips_from_taps(
                {k: v[:half] for k, v in taps.items()},
                {k: v[half:] for k, v in taps.items()})
            outs[where] = taps
        res["vgg16"] = held_against_float64(torch, "vgg16", *outs.values())
    del cpu, outs
    log(f"towers on the card vs float64 on the CPU ({S3_CHECK} images; "
        f"Inception {S3_CHECK_SIZE} px through the real resize, VGG16 "
        f"{V2_SIZE} px): {json.dumps(res)}")

    gen = torch.Generator(device=dev).manual_seed(22)
    imgs = torch.rand((S3_BATCH, V2_SIZE, V2_SIZE, 3), generator=gen,
                      device=dev) * 2 - 1
    other = torch.rand(imgs.shape, generator=gen, device=dev) * 2 - 1
    lpips_fn = make_lpips_fn(vgg)
    with torch.no_grad():
        x299 = inception_preprocess(imgs)
        times = {
            "inception_preprocess_ms": median_ms(
                torch, lambda: inception_preprocess(imgs)),
            "inception_tower_ms": median_ms(torch, lambda: tower.model(x299)),
            "lpips_ms": median_ms(torch, lambda: lpips_fn(imgs, other)),
        }
    times["inception_preprocess_images_per_sec"] = (
        S3_BATCH / times["inception_preprocess_ms"] * 1e3)
    times["inception_tower_images_per_sec"] = (
        S3_BATCH / times["inception_tower_ms"] * 1e3)
    times["lpips_pairs_per_sec"] = S3_BATCH / times["lpips_ms"] * 1e3
    res["timing"] = times
    log(f"tower throughput (batch {S3_BATCH}; Inception 299 px from "
        f"{V2_SIZE} px, bicubic; LPIPS on {V2_SIZE}-px pairs; median of "
        f"{S3_TIMED}): {json.dumps(times)}")
    if profile:
        with torch.no_grad():
            profile_device(torch, f"inception tower (batch {S3_BATCH}, 299 "
                           f"px)", lambda: [tower.model(x299)
                                            for _ in range(3)], 3,
                           times["inception_tower_ms"])
            profile_device(torch, f"lpips (VGG16 to conv4_3, batch "
                           f"{S3_BATCH} pairs, {V2_SIZE} px)",
                           lambda: [lpips_fn(imgs, other) for _ in range(3)],
                           3, times["lpips_ms"])
    del x299, imgs, other, vgg, lpips_fn
    torch.cuda.empty_cache()
    return res


class PartTimer:
    """Wall time of the parts of ``run_final_metrics``: each named module
    function is wrapped (and restored on exit) to add its time, the card
    synchronized, to its part. A factory's own time goes to
    ``<part>_build`` and the calls of the function it returns to the
    part."""

    def __init__(self, torch, parts):
        self.torch, self.parts = torch, parts
        self.secs = {}

    def _timed(self, name, fn, factory=False):
        def run(*a, **kw):
            self.torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            self.torch.cuda.synchronize()
            self.secs.setdefault(name + ("_build" if factory else ""),
                                 []).append(time.perf_counter() - t0)
            return self._timed(name, out) if factory else out
        return run

    def __enter__(self):
        self.saved = [(mod, attr, getattr(mod, attr))
                      for _, mod, attr, _ in self.parts]
        for name, mod, attr, factory in self.parts:
            setattr(mod, attr, self._timed(name, getattr(mod, attr),
                                           factory))
        return self

    def __exit__(self, *exc):
        for mod, attr, fn in self.saved:
            setattr(mod, attr, fn)


def phase_stage3(torch, dev, vq, hprior, raster_chunk_s: float) -> dict:
    """``run_final_metrics`` on the trained VQ-VAE-2 and hierarchical prior,
    counts set to 0 just before and read just after. Its generation runs
    through sample_prior's dispatch (the wavefront sampler at both
    levels); ``raster_chunk_s``, phase 14's raster sampler time for one
    chunk of both levels at the same batch, gives the raster sampler's
    time for the same pixels beside it."""
    from types import SimpleNamespace

    import numpy as np
    from scipy import linalg

    from movae_tpu_torch.kernels import LAUNCH_COUNTS, reset_launch_counts
    from movae_tpu_torch.metrics import features as feat_lib
    from movae_tpu_torch.metrics import pixel as pixel_lib
    from movae_tpu_torch.train import final_metrics as fm

    rng = np.random.default_rng(23)
    n_batches = S3_FID_SAMPLES // S3_BATCH
    loader = [((rng.integers(0, 256, (S3_BATCH, V2_SIZE, V2_SIZE, 3),
                             dtype=np.uint8) / 127.5 - 1.0).astype(
                                 np.float32), None, S3_BATCH)
              for _ in range(n_batches)]
    args = SimpleNamespace(batch_size=S3_BATCH, seed=0,
                           max_fid_samples=S3_FID_SAMPLES,
                           max_gen_metrics_samples=S3_GEN_SAMPLES)
    prior = {"model": hprior, "hierarchical": True}
    parts = [("collect_recons", fm, "collect_recons", False),
             ("pixel", pixel_lib, "psnr", False),
             ("pixel", pixel_lib, "ssim", False),
             ("lpips", fm, "make_lpips_fn", True),
             ("inception", feat_lib, "extract_inception_features", False),
             ("sqrtm", linalg, "sqrtm", False),
             ("kid", feat_lib, "kid_from_features", False),
             ("inception_score", feat_lib, "calculate_inception_score",
              False),
             ("generation", fm, "generate_samples", False)]
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    with PartTimer(torch, parts) as timer:
        finals = fm.run_final_metrics({"model": vq, "test_loader": loader},
                                      args, prior)
    wall_s = time.perf_counter() - t0
    counts = dict(LAUNCH_COUNTS)

    secs = {k: sum(v) for k, v in timer.secs.items()}
    secs["sqrtm_each"] = timer.secs.get("sqrtm", [])
    secs["wall"] = wall_s
    chunks = -(-S3_GEN_SAMPLES // S3_BATCH)
    res = {"final": finals, "seconds": secs,
           "generation_images_per_sec": S3_GEN_SAMPLES / secs["generation"],
           "generation_raster_sampler_s": chunks * raster_chunk_s,
           "launches": counts}
    log(f"stage 3 (run_final_metrics on the trained VQ-VAE-2 and "
        f"hierarchical prior; {S3_FID_SAMPLES} recon / {S3_GEN_SAMPLES} "
        f"generated images at {V2_SIZE} px): {json.dumps(res)}")
    expected = {"psnr", "ssim", "lpips", "rfid", "gfid", "kid",
                "inception_score_mean", "inception_score_std", "precision",
                "recall"}
    check(set(finals) == expected, f"final metrics keys {sorted(finals)}")
    for key in expected - {"precision", "recall"}:
        v = finals[key]
        check(v == v and abs(v) != float("inf"), f"final/{key} is {v}")
    for key in ("precision", "recall"):
        check(finals[key] != finals[key], f"final/{key} is {finals[key]}, "
              f"expected nan (the reference keeps it off)")
    for key in ("rfid", "gfid", "kid"):
        check(finals[key] >= 0, f"final/{key} = {finals[key]} < 0")
    # IS >= 1 (each split's KL >= 0), up to float32 rounding of the class
    # probabilities where the samples' predictions are nearly alike
    check(finals["inception_score_mean"] >= 1.0 - IS_ROUNDING,
          f"final/inception_score_mean = {finals['inception_score_mean']}")
    check(counts["nearest_code"] == 2 * n_batches,
          f"nearest_code launched {counts['nearest_code']} times in "
          f"{n_batches} recon batches of 2 quantizers")
    flash = {k: v for k, v in counts.items() if k.startswith("flash")}
    check(not any(flash.values()), f"flash kernels launched in stage 3 "
          f"(no attention on this path): {flash}")
    # the pixel metrics and LPIPS run in batches of fm.METRIC_BATCH
    runs = {k: len(v) for k, v in timer.secs.items()}
    metric_batches = -(-S3_FID_SAMPLES // fm.METRIC_BATCH)
    check(runs.get("generation") == 1 and runs.get("sqrtm", 0) >= 2
          and runs.get("inception") == 4
          and runs.get("lpips") == metric_batches
          and runs.get("pixel") == 2 * metric_batches,
          f"stage 3 parts ran {runs} times")
    # one seed repeats its generated images (generate_samples samples
    # under deterministic cuDNN)
    twice = [fm.generate_samples(vq, args, prior, torch.Generator(
        device=dev).manual_seed(GEN_SEED), SAMPLE_BATCH, SAMPLE_BATCH)
        for _ in range(2)]
    res["seed_repeats"] = bool(np.array_equal(*twice))
    log(f"stage 3: generate_samples twice from seed {GEN_SEED} "
        f"({SAMPLE_BATCH} images): equal {res['seed_repeats']}")
    check(res["seed_repeats"], "stage 3: one seed gave two different sets "
          "of generated images")
    # the generation of stage 3's chunk as it was (default cuDNN) against
    # as it is (deterministic cuDNN), in turns
    default = fm.deterministic_cudnn
    ab = {"default_cudnn_s": [], "deterministic_cudnn_s": []}
    for arm in ("deterministic_cudnn_s", "default_cudnn_s",
                "default_cudnn_s", "deterministic_cudnn_s"):
        fm.deterministic_cudnn = (contextlib.nullcontext
                                  if arm == "default_cudnn_s" else default)
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fm.generate_samples(vq, args, prior, torch.Generator(
                device=dev).manual_seed(GEN_SEED), S3_BATCH, S3_BATCH)
            torch.cuda.synchronize()
            ab[arm].append(time.perf_counter() - t0)
        finally:
            fm.deterministic_cudnn = default
    res["generation_cudnn_ab"] = ab
    log(f"stage 3: one generated chunk of {S3_BATCH}, default against "
        f"deterministic cuDNN (s): {json.dumps(ab)}")
    return res


# ---------------------------------------------------------------------------
# phase 15: the CLI, configs of configs/ from images to final/*
# ---------------------------------------------------------------------------

def cli_config(path: str, cuts: dict, save_path: str, out: str) -> dict:
    """Write a copy of a config with ``cuts`` applied to ``out`` (a
    temporary file; ``configs/`` is never written) and return it."""
    import yaml

    from movae_tpu_torch import runner

    cfg = runner.load_yaml_config(path)
    cfg.update(cuts, save_path=save_path)
    with open(out, "w") as f:
        yaml.safe_dump(cfg, f, sort_keys=False)
    return cfg


def synthetic_count(dataset: str) -> int:
    """Train images of a ``synthetic-<size>-<n>`` dataset."""
    return int(dataset.split("-")[2])


def run_tree(save_path: str) -> list:
    """The run roots under ``save_path`` (one per run), oldest first."""
    roots = []
    for dirpath, dirnames, _ in os.walk(save_path):
        if "checkpoints" in dirnames and "figures" in dirnames:
            roots.append(dirpath)
    return sorted(roots)


def history(root: str) -> list:
    with open(os.path.join(root, "wandb_local", "history.jsonl")) as f:
        return [json.loads(line) for line in f]


def check_run_tree(root: str, epochs, prior: bool, finals: bool) -> dict:
    """The JAX package's run tree under ``root``; returns the final/* values
    the run logged."""
    def need(*rel):
        check(os.path.exists(os.path.join(root, *rel)),
              f"{root}: missing {os.path.join(*rel)}")

    for e in epochs:
        for ext in ("pdf", "png"):
            need("figures", "generated", f"epoch_{e:04d}_random_samples.{ext}")
            for split in ("test", "train"):
                need("figures", "reconstructed",
                     f"epoch_{e:04d}_{split}_samples.{ext}")
    need("checkpoints", "final_checkpoint.pth")
    need("checkpoints", "last_checkpoint.pth")
    keys = set().union(*[set(r) for r in history(root)])
    check(any(k.startswith("train/") for k in keys)
          and any(k.startswith("eval/") for k in keys),
          f"{root}: history.jsonl lacks train/* or eval/*: {sorted(keys)}")
    if prior:
        for name in ("best_prior", "final_prior"):
            need("pixelcnn_prior", "checkpoints", f"{name}.pth")
        need("figures", "generated", "final_random_samples_with_prior.pdf")
        cache = os.path.join(root, "codes_cache")
        check(os.path.isdir(cache) and any(
            os.path.exists(os.path.join(cache, d, "meta.json"))
            for d in os.listdir(cache)), f"{root}: no codes_cache")
        check("prior/loss" in keys, f"{root}: no prior/loss logged")
    if not finals:
        return {}
    final = {k[len("final/"):]: v for r in history(root) for k, v in r.items()
             if k.startswith("final/")}
    expected = {"psnr", "ssim", "lpips", "rfid", "gfid", "kid",
                "inception_score_mean", "inception_score_std", "precision",
                "recall"}
    check(expected <= set(final), f"{root}: final/* keys {sorted(final)}")
    for k, v in final.items():
        if k in ("precision", "recall"):
            check(v != v, f"final/{k} is {v}, expected nan")
        else:
            check(v == v and abs(v) != float("inf"), f"final/{k} is {v}")
    return final


def loader_ab(torch, dev, results, args) -> dict:
    """The host ``Loader`` against ``DeviceData`` on the trained model, one
    epoch per turn in ``CLI_AB_ORDER``, and the host synchronisations a
    step of each (CUDA's sync debug mode)."""
    from movae_tpu_torch.data import Loader
    from movae_tpu_torch.data.device import DeviceData
    from movae_tpu_torch.moo import AggregatorConfig
    from movae_tpu_torch.train import loop
    from movae_tpu_torch.train.step import make_train_step
    from movae_tpu_torch.utils.logging import StepTimer

    model, state = results["model"], results["state"]
    train_ds = results["train_loader"].dataset
    loader = Loader(train_ds, args.batch_size, shuffle=True, seed=1, raw=True)
    dd = DeviceData(train_ds, args.batch_size, dev, seed=1)
    step = make_train_step(model, AggregatorConfig(
        name="sum", num_objectives=len(model.objective_names)),
        normalize_inputs=True)
    gen = torch.Generator(device=dev).manual_seed(3)
    names = model.objective_names

    def epoch(arm, e, timer=None):
        if arm == "host":
            return loop.train_epoch(step, state, loader, dev, gen, 0, None,
                                    names, timer=timer)
        return loop.train_epoch_device(dd, step, state, dev, gen, 0, None,
                                       names, epoch_index=e, timer=timer)

    rates = {"host": [], "device": []}
    for e, arm in enumerate(CLI_AB_ORDER, 1):
        timer = StepTimer()
        epoch(arm, e, timer)
        rates[arm].append(timer.images_per_sec)
    steps = len(loader)
    syncs = {}
    for arm in ("host", "device"):
        n, sites = count_syncs(torch, lambda: epoch(arm, 9))
        syncs[arm] = {"per_step": n / steps, "sites": sites}
    res = {"images_per_sec": rates, "syncs": syncs, "steps_per_epoch": steps,
           "device_over_host": statistics.mean(rates["device"])
           / statistics.mean(rates["host"])}
    del dd
    return res


def phase_cli(torch, dev, bare: dict, tmp: str) -> dict:
    """Phase 15: 15a runs CLI_15A through ``runner.yaml_to_args`` and
    ``main`` in-process (the wall time of each part, launch counts set to 0
    just before and read just after), checks the run tree and the final/*
    values, resumes from ``last_checkpoint.pth`` through ``python -m
    movae_tpu_torch.runner``, then the loader A/B and the port bench; 15b
    runs CLI_15B with the PixelSNAIL prior. ``bare`` carries this run's
    bare-step numbers (phases 3 and 7). The run trees stay under ``tmp``
    (phase 18 reads them): ``res["roots"]``."""
    from scipy import linalg

    from movae_tpu_torch import main as main_mod
    from movae_tpu_torch import runner
    from movae_tpu_torch.kernels import LAUNCH_COUNTS, reset_launch_counts
    from movae_tpu_torch.kernels import nearest_code as nc
    from movae_tpu_torch.train import checkpoint as ckpt_lib
    from movae_tpu_torch.train import final_metrics as fm
    from movae_tpu_torch.train import loop
    from movae_tpu_torch.train import prior as prior_mod

    here = os.path.dirname(os.path.abspath(__file__))
    plain_calls = []
    plain = nc.nearest_code_plain

    def counted_plain(*a, **kw):
        plain_calls.append(1)
        return plain(*a, **kw)

    res = {}
    try:
        nc.nearest_code_plain = counted_plain
        # 15a: the VQ-VAE-2 config in-process
        save_a = os.path.join(tmp, "a")
        cfg = cli_config(os.path.join(here, CLI_15A), CLI_15A_CUTS, save_a,
                         os.path.join(tmp, "15a.yaml"))
        args = main_mod.parse_args(runner.yaml_to_args(cfg))
        parts = [("dataset", loop, "get_dataset", False),
                 ("train_epochs", loop, "train_epoch", False),
                 ("train_epochs", loop, "train_epoch_device", False),
                 ("eval", loop, "evaluate", False),
                 ("figures", loop, "_write_figures", False),
                 ("checkpoint_writes", ckpt_lib, "save_checkpoint", False),
                 ("extraction", prior_mod, "get_or_extract_codes", False),
                 ("prior", prior_mod, "train_prior_on_levels", False),
                 ("final_metrics", fm, "run_final_metrics", False),
                 ("final_metrics_sqrtm", linalg, "sqrtm", False)]
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        with PartTimer(torch, parts) as timer:
            results = main_mod.main(args)
        wall = time.perf_counter() - t0
        counts_a = dict(LAUNCH_COUNTS)
        check(counts_a["nearest_code"] > 0 and not plain_calls,
              f"15a: nearest_code launched {counts_a['nearest_code']} times "
              f"on the card, its plain version {len(plain_calls)} times")
        roots = run_tree(save_a)
        check(len(roots) == 1, f"15a: run roots {roots}")
        final = check_run_tree(roots[0], (1, 2), prior=True, finals=True)
        secs = {k: sum(v) for k, v in timer.secs.items()}
        secs["wall"] = wall
        # images/s of each epoch (the first pays the process's first steps
        # at these shapes) and of the loop's own timer over both
        per_epoch = [synthetic_count(cfg["dataset"]) / t
                     for t in timer.secs["train_epochs"]]
        res["15a"] = {
            "seconds": secs, "final": final, "launches": counts_a,
            "cli_train_images_per_sec": results["images_per_sec"],
            "epoch_images_per_sec": per_epoch,
            "bare_step_images_per_sec": bare["v2_sum_images_per_sec"],
            "last_epoch_over_bare": per_epoch[-1]
            / bare["v2_sum_images_per_sec"]}
        log(f"phase 15a (CLI, {CLI_15A} cut to {json.dumps(CLI_15A_CUTS)}): "
            f"{json.dumps(res['15a'])}")

        # the resume, through the runner in a subprocess
        last = ckpt_lib.last_checkpoint_path(roots[0])
        path_r = os.path.join(tmp, "15a_resume.yaml")
        cli_config(os.path.join(here, CLI_15A),
                   dict(CLI_15A_CUTS, **CLI_15A_RESUME, resume=last), save_a,
                   path_r)
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "movae_tpu_torch.runner", "--f", path_r],
            cwd=here, capture_output=True, text=True, timeout=600)
        resume_s = time.perf_counter() - t0
        check(proc.returncode == 0, f"15a resume exited {proc.returncode}: "
              f"{proc.stdout[-2000:]} {proc.stderr[-2000:]}")
        check("at epoch 2" in proc.stdout,
              f"15a resume did not start at epoch 2: {proc.stdout[-2000:]}")
        roots_r = [r for r in run_tree(save_a) if r != roots[0]]
        check(len(roots_r) == 1, f"15a resume: run roots {roots_r}")
        check_run_tree(roots_r[0], (2, 3), prior=False, finals=False)
        first = min(r["_step"] for r in history(roots_r[0])
                    if any(k.startswith("train/") for k in r))
        steps_a = -(-synthetic_count(cfg["dataset"]) // cfg["batch_size"])
        check(first == steps_a + 1, f"15a resume: first step logged {first}, "
              f"expected {steps_a + 1} (the step counter at {steps_a})")
        res["15a_resume"] = {"seconds": resume_s, "first_step": first,
                             "stdout_tail": [line for line in
                                             proc.stdout.splitlines()
                                             if "images/sec" in line
                                             or "Resumed" in line]}
        log(f"phase 15a resume: {json.dumps(res['15a_resume'])}")

        res["loader_ab"] = loader_ab(torch, dev, results, args)
        log(f"phase 15 loader A/B at 256 px, batch {args.batch_size}: "
            f"{json.dumps(res['loader_ab'])}")
        del results
        torch.cuda.empty_cache()

        proc = subprocess.run(
            [sys.executable, "-m", "movae_tpu_torch.bench", "--steps",
             str(CLI_BENCH_STEPS), "--dtype", "float32", "--batch_size",
             str(BATCH), "--steps_per_dispatch", "1"], cwd=here,
            capture_output=True, text=True, timeout=600)
        check(proc.returncode == 0, f"bench exited {proc.returncode}: "
              f"{proc.stderr[-2000:]}")
        line = json.loads(proc.stdout.strip().splitlines()[-1])
        check(set(line) >= {"metric", "value", "unit", "vs_baseline"},
              f"bench line {line}")
        res["bench"] = {"line": line,
                        "bare_step_images_per_sec":
                            bare["stage1_sum_images_per_sec"],
                        "bench_over_bare": line["value"]
                        / bare["stage1_sum_images_per_sec"]}
        log(f"phase 15 bench: {json.dumps(res['bench'])}")

        # 15b: PixelSNAIL at L = 4096 through the CLI
        save_b = os.path.join(tmp, "b")
        cfg_b = cli_config(os.path.join(here, CLI_15B), CLI_15B_CUTS, save_b,
                           os.path.join(tmp, "15b.yaml"))
        args_b = main_mod.parse_args(runner.yaml_to_args(cfg_b))
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        main_mod.main(args_b)
        wall_b = time.perf_counter() - t0
        counts_b = dict(LAUNCH_COUNTS)
        steps_b = -(-synthetic_count(cfg_b["dataset"])
                    // cfg_b["batch_size"])
        blocks = args_b.pixelsnail_num_blocks
        check(counts_b["nearest_code"] > 0 and not plain_calls,
              f"15b: nearest_code {counts_b['nearest_code']} launches, plain "
              f"version {len(plain_calls)} calls")
        for k in FLASH_KERNELS:
            check(counts_b[k] == blocks * steps_b,
                  f"15b: {k} launched {counts_b[k]} times, expected "
                  f"{blocks} blocks x {steps_b} prior steps")
        roots_b = run_tree(save_b)
        check(len(roots_b) == 1, f"15b: run roots {roots_b}")
        need = os.path.join(roots_b[0], "pixelsnail_prior", "checkpoints",
                            "final_prior.pth")
        check(os.path.exists(need), f"15b: missing {need}")
        res["15b"] = {"seconds": wall_b, "launches": counts_b}
        log(f"phase 15b (CLI, {CLI_15B} cut to {json.dumps(CLI_15B_CUTS)}):"
            f" {json.dumps(res['15b'])}")
    finally:
        nc.nearest_code_plain = plain
    res["launches"] = {k: counts_a[k] + counts_b[k] for k in counts_a}
    res["roots"] = {"15a": roots[0], "15b": roots_b[0], "tmp": tmp}
    return res


# ---------------------------------------------------------------------------
# phase 16: the VAE family
# ---------------------------------------------------------------------------

def vae_path(config: str, warmup: int = VAE_WARMUP,
             timed: int = VAE_TIMED) -> dict:
    """A train path with the model, batch, image size and learning rate of
    a VAE-family YAML of configs/. The registry sets a loss-weight dict's KL
    weight to batch_size / dataset_size; dataset_size is the train-set size
    that the file's KL weight implies, so the file's weight is the one
    used."""
    from movae_tpu_torch import runner
    from movae_tpu_torch.data import dataset_input_size

    here = os.path.dirname(os.path.abspath(__file__))
    cfg = runner.load_yaml_config(os.path.join(here, config))
    lw = dict(cfg["loss_weights"])
    kld = lw["kld_loss"]
    width = dict(arch=cfg["arch"], latent_dim=cfg["latent_dim"],
                 hidden_dims=tuple(cfg["hidden_dims"]), loss_weights=lw,
                 recons_objective=cfg["recons_objective"],
                 recons_activation=cfg["recons_activation"],
                 batch_size=cfg["batch_size"],
                 dataset_size=cfg["batch_size"] / kld)
    return dict(width=width, size=dataset_input_size(cfg["dataset"]),
                batch=cfg["batch_size"], warmup=warmup, timed=timed,
                lr=(float(cfg["lr"]), cfg.get("scheduler"), cfg["epochs"],
                    warmup + timed),
                uint8=bool(cfg.get("normalize_inputs")), vq=0,
                agg=cfg["aggregator"], config=config)


def vae_runs(torch, dev, path: dict, aggs, profile: bool, card: str,
             init=None, after=None) -> tuple:
    """``path`` under each of ``aggs`` from one init (its weights kept on
    the card and reloaded before each run): step ms (median), images/s,
    host synchronisations a step, peak device memory; with ``profile``
    the busy share and the top kernels. The init is ``init_model``'s from
    seed 0 (its wall time reported: on the host), or ``init``, a state
    dict of the same layout. ``after(model)``, given, runs on the model as
    the last run left it and returns results to add. Returns the results
    and the init."""
    from movae_tpu_torch.models import get_network, init_model

    t0 = time.perf_counter()
    if init is None:
        model = init_model(get_network(path["size"], 3, path["width"]),
                           seed=0, device=dev)
        init = {k: v.clone() for k, v in model.state_dict().items()}
    else:
        with torch.device(dev):
            model = get_network(path["size"], 3, path["width"])
        model.load_state_dict(init)
    torch.cuda.synchronize()
    out = {"params": sum(p.numel() for p in model.parameters()),
           "init_s": time.perf_counter() - t0, "card": card}
    for agg in aggs:
        model.load_state_dict(init)
        res, (step, state, batches, gen) = train_mode(torch, agg, dev, path,
                                                      model=model)
        syncs, sites = count_syncs(torch, lambda: step(state, batches[0],
                                                       gen))
        out[agg] = {k: res[k] for k in ("median_step_ms", "min_step_ms",
                                        "images_per_sec", "peak_mem_gib")}
        out[agg].update(host_syncs_per_step=syncs, sync_sites=sites,
                        objectives=len(model.objective_names),
                        last={k: v for k, v in res["last"].items()
                              if k.endswith("loss") or "weight" in k})
        if profile:
            n = len(batches)
            profile_device(torch, f"{path['width']['arch']} "
                           f"{path['size']}px agg={agg}", lambda: [
                               step(state, batches[i % n], gen)
                               for i in range(3)], 3, res["median_step_ms"])
        del state, batches, step
        torch.cuda.empty_cache()
    sum_ms = out["sum"]["median_step_ms"]
    for agg in aggs:
        out[agg]["over_sum"] = out[agg]["median_step_ms"] / sum_ms
    if after is not None:
        out.update(after(model))
    del model
    torch.cuda.empty_cache()
    return out, init


def phase_vae_lockstep(torch, dev, arch: str, agg: str, steps: int) -> dict:
    """``steps`` steps of ``agg`` from one init on the CPU and on the card
    at a small width, each step's N(0, I) draws made once on the host and
    given to both: parameters, BatchNorm running statistics and anneal
    counters (the whole state_dict) and the losses within 1e-4."""
    import numpy as np

    from movae_tpu_torch.models import get_network, init_model
    from movae_tpu_torch.moo import AggregatorConfig, init_state
    from movae_tpu_torch.train.optim import build_optimizer
    from movae_tpu_torch.train.state import TrainState
    from movae_tpu_torch.train.step import make_train_step

    width = dict(arch=arch, hidden_dims=(8, 16), latent_dim=8,
                 layer_norm="batch", anneal_steps=4,
                 recursive_kld_anneal_steps=4)
    rng = np.random.default_rng(0)
    batches = [torch.tensor(rng.uniform(-1, 1, (4, 16, 16, 3)).astype(
        np.float32)) for _ in range(steps)]
    noises = [{n: torch.tensor(rng.standard_normal((4, 8)).astype(
        np.float32)) for n in VAE_DRAWS.get(arch, ("eps",))}
        for _ in range(steps)]
    runs = {}
    for where in ("cpu", dev):
        model = init_model(get_network(16, 3, width), seed=3, device=where)
        cfg = AggregatorConfig(name=agg,
                               num_objectives=len(model.objective_names))
        state = TrainState.create(model, build_optimizer("adam", 1e-3,
                                                         eps=1e-4),
                                  init_state(cfg))
        step = make_train_step(model, cfg)
        losses = []
        for xb, noise in zip(batches, noises):
            state, met = step(state, xb, noise=noise)
            losses.append([float(met[k]) for k in
                           (*model.objective_names, "total_loss")])
        runs[str(where)] = ({k: v.cpu() for k, v in
                             model.state_dict().items()}, losses)
    (cpu_sd, cpu_l), (dev_sd, dev_l) = runs["cpu"], runs[str(dev)]
    delta = max(float((cpu_sd[k].double() - dev_sd[k].double()).abs().max())
                for k in cpu_sd)
    loss_delta = max(abs(a - b) / max(abs(a), 1.0)
                     for ra, rb in zip(cpu_l, dev_l) for a, b in zip(ra, rb))
    res = {"arch": arch, "agg": agg, "steps": steps,
           "max_state_delta": delta, "max_loss_delta": loss_delta,
           "num_iter": (float(dev_sd["num_iter"]) if "num_iter" in dev_sd
                        else None),
           "running_var_moved": float((dev_sd["encoder.0.1.running_var"]
                                       - 1).abs().max())}
    log(f"lockstep card vs cpu, {arch} {steps} {agg} steps: "
        f"{json.dumps(res)}")
    check(delta < 1e-4 and loss_delta < 1e-4,
          f"{arch} {agg}: card and CPU differ by {delta:.3e} (state) and "
          f"{loss_delta:.3e} (losses)")
    check(res["num_iter"] in (None, float(steps)),
          f"{arch}: anneal counter {res['num_iter']} after {steps} steps")
    check(res["running_var_moved"] > 0,
          f"{arch}: the running statistics did not move")
    return res


def phase_vae_cli(torch, dev) -> dict:
    """16e: CLI_16E through ``runner.yaml_to_args`` and ``main`` in-process,
    the wall time of each part; the run tree, finite final/* values
    (precision and recall nan), no prior stage, and the generated images
    from ``model.sample``."""

    from scipy import linalg

    from movae_tpu_torch import main as main_mod
    from movae_tpu_torch import runner
    from movae_tpu_torch.models import vae as vae_mod
    from movae_tpu_torch.train import checkpoint as ckpt_lib
    from movae_tpu_torch.train import final_metrics as fm
    from movae_tpu_torch.train import loop
    from movae_tpu_torch.train import prior as prior_mod

    here = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix="movae_vae_cli_")
    sampled = []
    sample = vae_mod.VAE.sample

    def counted_sample(self, n, generator=None):
        sampled.append(n)
        return sample(self, n, generator=generator)

    prior_calls = []
    train_prior = prior_mod.train_prior

    def counted_prior(*a, **kw):
        prior_calls.append(1)
        return train_prior(*a, **kw)

    try:
        vae_mod.VAE.sample = counted_sample
        prior_mod.train_prior = counted_prior
        cfg = cli_config(os.path.join(here, CLI_16E), CLI_16E_CUTS, tmp,
                         os.path.join(tmp, "16e.yaml"))
        args = main_mod.parse_args(runner.yaml_to_args(cfg))
        parts = [("dataset", loop, "get_dataset", False),
                 ("train_epochs", loop, "train_epoch", False),
                 ("train_epochs", loop, "train_epoch_device", False),
                 ("eval", loop, "evaluate", False),
                 ("figures", loop, "_write_figures", False),
                 ("checkpoint_writes", ckpt_lib, "save_checkpoint", False),
                 ("final_metrics", fm, "run_final_metrics", False),
                 ("final_metrics_generation", fm, "generate_samples", False),
                 ("final_metrics_sqrtm", linalg, "sqrtm", False)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with PartTimer(torch, parts) as timer:
            results = main_mod.main(args)
        wall = time.perf_counter() - t0
        roots = run_tree(tmp)
        check(len(roots) == 1, f"16e: run roots {roots}")
        final = check_run_tree(roots[0], (1, 2), prior=False, finals=True)
        leftovers = [d for d in os.listdir(roots[0])
                     if d.endswith("_prior") or d == "codes_cache"]
        check(not prior_calls and not leftovers,
              f"16e: a prior stage ran ({len(prior_calls)} calls, "
              f"{leftovers})")
        gen_n = CLI_16E_CUTS["max_gen_metrics_samples"]
        check(sum(sampled) >= gen_n,
              f"16e: model.sample gave {sum(sampled)} images, the "
              f"generative metrics need {gen_n}")
        secs = {k: sum(v) for k, v in timer.secs.items()}
        secs["wall"] = wall
        res = {"seconds": secs, "final": final,
               "images_per_sec": results["images_per_sec"],
               "sampled_images": sum(sampled),
               "params": sum(p.numel() for p in
                             results["model"].parameters())}
        del results
    finally:
        vae_mod.VAE.sample = sample
        prior_mod.train_prior = train_prior
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()
    log(f"phase 16e (CLI, {CLI_16E} cut to {json.dumps(CLI_16E_CUTS)}): "
        f"{json.dumps(res)}")
    return res


def phase_vae(torch, dev, profile: bool, card: str) -> dict:
    """Phase 16: 16a-16c train the VAE family's paths, 16d locks card and
    CPU, 16e runs a config through the CLI. Launch counts are set to 0
    just before and read just after: this path reaches no kernel of the
    port, so every count must stay 0."""
    from movae_tpu_torch.kernels import LAUNCH_COUNTS, reset_launch_counts

    t0 = time.perf_counter()
    count_syncs(torch, lambda: None)  # the debug mode's own first switch
    reset_launch_counts()
    res = {}
    init = None
    for label, path in (("16a", vae_path(VAE_16A)),
                        ("16a_gg", vae_path(GG_VAE_16A)),
                        ("16b", vae_path(VAE_16B)),
                        ("16c", BETATC_16C)):
        aggs = ("sum", path.get("agg", "aligned_mtl"))
        # the gg_vae of 16a has the vae's layout: it starts from its init
        res[label], init = vae_runs(torch, dev, path, aggs, profile, card,
                                    init if label == "16a_gg" else None)
        res[label]["config"] = path.get("config", "BASELINE.json config 2")
        log(f"phase {label} ({res[label]['config']}, "
            f"{path['width']['arch']} {path['size']}px batch "
            f"{path['batch']}): {json.dumps(res[label])}")
    res["16d"] = [phase_vae_lockstep(torch, dev, arch, agg, steps)
                  for arch, agg, steps in VAE_LOCKSTEPS]
    res["16e"] = phase_vae_cli(torch, dev)
    launches = dict(LAUNCH_COUNTS)
    check(not any(launches.values()),
          f"phase 16 launched a kernel of the port: {launches}")
    res["launches"] = launches
    res["seconds"] = time.perf_counter() - t0
    log(f"phase 16 (the VAE family; {card}): {res['seconds']:.1f} s, "
        f"launches {json.dumps(launches)}")
    return res


# ---------------------------------------------------------------------------
# phase 17: bf16 compute, grad_accum, steps_per_dispatch and remat
# ---------------------------------------------------------------------------

def bf16_agreement(torch, got, want, terms) -> dict:
    """``got`` against ``want`` (one shape): ``elem`` the largest
    |got - want| in floors (BF16_U of |want| plus ``terms``, the
    root-sum-square of the products summed into each element, plus 1/16 of
    want's rms), ``rms`` the rms of got - want over want's and ``scale``
    sum((got - want) want) / sum(want^2) (the best-fit scale's distance
    from 1), both in units of BF16_U."""
    got, want = got.double(), want.double()
    d = got - want
    rms = want.square().mean().sqrt().clamp_min(1e-300)
    floor = BF16_U * (want.abs() + terms.double() + rms / 16)
    return {"elem": float((d.abs() / floor).max()),
            "rms": float(d.square().mean().sqrt() / rms) / BF16_U,
            "scale": float((d * want).sum()
                           / want.square().sum().clamp_min(1e-300)) / BF16_U}


def bf16_terms(torch, fa, q, k, v, do, o, lse2, scale, tensor_cores=False
               ) -> dict:
    """The root-sum-square of the products the plain version sums into each
    element (its backward from ``o`` and base-2 ``lse2``): o = p v, dv =
    p^T do, dq = ds k, dk = ds^T q, with p and ds rounded to bf16, p and
    ds computed as the plain version computes them (``tensor_cores`` as
    in ``fa._mm``)."""
    out = {n: torch.empty(q.shape, dtype=torch.float32, device=q.device)
           for n in ("o", "dq", "dk", "dv")}
    c = fa.log2e_scale(scale)
    for i in range(0, q.shape[0], fa._PLAIN_CHUNK):
        sl = slice(i, i + fa._PLAIN_CHUNK)
        p = fa.plain_p_bf16(fa._plain_logits(q[sl], k[sl], tensor_cores),
                            c, lse2[sl][..., None])
        dof = do[sl].float()
        di = (o[sl].float() * dof).sum(-1, keepdim=True)
        ds = fa.plain_ds_bf16(p, fa._mm(dof, v[sl].transpose(-1, -2),
                                        tensor_cores), di, scale).square()
        p = fa._bf(p).square()
        out["o"][sl] = (p @ v[sl].float().square()).sqrt()
        out["dv"][sl] = (p.transpose(-1, -2) @ dof.square()).sqrt()
        out["dq"][sl] = (ds @ k[sl].float().square()).sqrt()
        out["dk"][sl] = (ds.transpose(-1, -2) @ q[sl].float().square()).sqrt()
        del p, ds
    return out


def plain_bf16(fa, q, k, v, do, o, lse2, scale, rounding=None,
               tensor_cores=False):
    """The plain bf16 forward's o, and the plain backward's (dq, dk, dv)
    from ``o`` and base-2 ``lse2``, their products summed in IEEE float32 or
    on the tensor cores (``tensor_cores``, as in ``fa._mm``; bf16 operands
    only); ``rounding`` stands in for the plain version's bf16 rounding
    where given."""
    saved = fa._bf
    fa._bf = rounding or saved
    try:
        return (fa.plain_fwd_bf16(q, k, v, scale, tensor_cores)[0],
                *fa.plain_bwd_bf16(q, k, v, o, lse2, do, scale,
                                   tensor_cores))
    finally:
        fa._bf = saved


def bf16_agrees(a: dict) -> bool:
    """17a's gate against the plain version (``bf16_agreement``)."""
    return (a["elem"] <= BF16_ELEM and a["rms"] <= BF16_RMS
            and abs(a["scale"]) <= BF16_SCALE)


def bf16_as_close(kernel: dict, plain: dict) -> bool:
    """17a's gate against float64: the kernel's agreement no worse than the
    plain version's own, within BF16_F64_FACTOR and an additive margin."""
    return (kernel["rms"] <= BF16_F64_FACTOR * plain["rms"] + BF16_RMS / 2
            and abs(kernel["scale"]) <= abs(plain["scale"]) + BF16_SCALE)


def compare_flash_bf16(torch, fa, q, k, v, do) -> dict:
    """The bf16 kernels on (q, k, v) and cotangent ``do``: the forward, and
    the dK/dV and dQ kernels from the forward's o and lse2, each against the
    plain version with its products summed on the tensor cores as the
    kernels sum them (its backward fed the same o and lse2) and, as the
    port runs them end to end, against float64 from the same bf16 inputs
    beside the distance from float64 of the plain version summed in IEEE
    float32, end to end (``bf16_agreement`` for each), and the largest
    absolute difference from the plain version."""
    scale = q.shape[-1] ** -0.5
    q, k, v, do = (t.contiguous() for t in (q, k, v, do))
    fa._check(q=q, k=k, v=v, do=do)
    o, lse2 = fa.flash_fwd(q, k, v, scale)
    di = (o.float() * do.float()).sum(-1)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse2, di, scale)
    cuda = {"o": o, "dq": fa.flash_bwd_dq(q, k, v, do, lse2, di, scale),
            "dk": dk, "dv": dv}
    keys = ("o", "dq", "dk", "dv")
    plain = dict(zip(keys, plain_bf16(fa, q, k, v, do, o, lse2, scale,
                                      tensor_cores=True)))
    terms = bf16_terms(torch, fa, q, k, v, do, o, lse2, scale,
                       tensor_cores=True)
    # the float64 half's yardstick sums in IEEE float32, so that a bias the
    # tensor cores' sums share with the kernels shows there
    o_p, lse2_p = fa.plain_fwd_bf16(q, k, v, scale)
    e2e = dict(zip(keys, plain_bf16(fa, q, k, v, do, o_p, lse2_p, scale)))
    parts = []  # float64, the L x L intermediates two batch rows at a time
    for i in range(0, q.shape[0], 2):
        leaves = [t[i:i + 2].double().requires_grad_() for t in (q, k, v)]
        out = fa.dense_causal_attention(*leaves, scale)
        parts.append([out.detach(), *torch.autograd.grad(
            out, leaves, do[i:i + 2].double())])
        del leaves, out
        torch.cuda.empty_cache()
    f64 = dict(zip(keys, (torch.cat(p) for p in zip(*parts))))
    torch.cuda.synchronize()
    return {key: {"finite": bool(torch.isfinite(got).all()),
                  "max_abs_err": float((got.double() - plain[key].double())
                                       .abs().max()),
                  "plain": bf16_agreement(torch, got, plain[key],
                                          terms[key]),
                  "f64": bf16_agreement(torch, got, f64[key], terms[key]),
                  "plain_vs_f64": bf16_agreement(torch, e2e[key], f64[key],
                                                 terms[key])}
            for key, got in cuda.items()}


def check_flash_bf16(torch, fa, label: str, q, k, v, do, worst: dict
                     ) -> dict:
    """compare_flash_bf16 within 17a's gate (``bf16_agrees`` against the
    plain version, ``bf16_as_close`` against float64); the largest absolute
    errors against the plain version into ``worst``."""
    res = compare_flash_bf16(torch, fa, q, k, v, do)
    log(f"flash_attention bf16 {label} (u = 2^-8): {json.dumps(res)}")
    for key, r in res.items():
        check(r["finite"] and bf16_agrees(r["plain"])
              and bf16_as_close(r["f64"], r["plain_vs_f64"]),
              f"flash_attention bf16 {key} at {label}: {r} (gate: element "
              f"{BF16_ELEM} u, rms {BF16_RMS} u, scale {BF16_SCALE} u from "
              f"the plain version; from float64 {BF16_F64_FACTOR}x the "
              f"plain version's rms + {BF16_RMS / 2} u and its scale + "
              f"{BF16_SCALE} u)")
    for name, keys in (("flash_attention_fwd", ("o",)),
                       ("flash_attention_bwd_dkv", ("dk", "dv")),
                       ("flash_attention_bwd_dq", ("dq",))):
        worst[name] = max(worst[name],
                          *(res[k]["max_abs_err"] for k in keys))
    return res


def flash_bf16_controls(torch, fa, label: str, q, k, v, do) -> dict:
    """Planted faults that 17a's gate must refuse, each built from the plain
    version on (q, k, v, do) and held against it as the kernels are: o
    normalised 0.9% low, q pre-scaled in bf16 (where 1/sqrt(D) is not a
    power of two), the last quarter of o's rows zeroed, and dq with ds
    left unrounded; o with p left unrounded is reported, not required to
    fail (its rounding differs from the plain version's by about as much
    as the forward kernel's running-maximum rounding does). Faults and
    plain version alike sum in IEEE float32, so that each fault differs
    from the plain version in one thing only."""
    scale = q.shape[-1] ** -0.5
    o, lse2 = fa.plain_fwd_bf16(q, k, v, scale)
    plain = plain_bf16(fa, q, k, v, do, o, lse2, scale)
    terms = bf16_terms(torch, fa, q, k, v, do, o, lse2, scale)
    unrounded = plain_bf16(fa, q, k, v, do, o, lse2, scale,
                           rounding=lambda x: x)  # p and ds left in float32
    late = o.clone()
    late[:, :, 3 * q.shape[2] // 4:] = 0
    faults = {"o_normalised_0.9pct_low": (o.float() * 0.991).to(o.dtype),
              "o_last_quarter_of_rows_zero": late,
              "dq_ds_unrounded": unrounded[1]}
    if scale != 2.0 ** round(math.log2(scale)):
        faults["o_q_prescaled_in_bf16"] = fa.plain_fwd_bf16(
            (q.float() * scale).to(q.dtype), k, v, 1.0)[0]
    res = {name: bf16_agreement(torch, got, *((plain[1], terms["dq"])
                                              if name[:2] == "dq"
                                              else (o, terms["o"])))
           for name, got in faults.items()}
    res["o_p_unrounded_reported"] = bf16_agreement(torch, unrounded[0], o,
                                                   terms["o"])
    log(f"17a planted controls at {label} (u = 2^-8): {json.dumps(res)}")
    for name in faults:
        check(not bf16_agrees(res[name]),
              f"17a control {name} at {label} passed the gate: {res[name]}")
    torch.cuda.empty_cache()
    return res


def phase_flash_bf16(torch, fa, dev, peaks, sass: dict) -> list:
    """17a: the bf16 flash kernels against the bf16 plain version and
    float64 at the prior's shape, at L = 4096, 1600 and 1025 and at every
    head dim built; times at the prior's shape by CUDA-graph replay beside
    their bound, the plain version and scaled_dot_product_attention in
    bf16 (the yardstick; the port never calls it). Returns the three bf16
    kernel rows (launches and the trained prior's q/k/v come from 17b)."""
    from movae_tpu_torch.kernels import build
    from movae_tpu_torch.kernels.flash_ab import sdpa_ms

    for d in build.FLASH_HEAD_DIMS:
        for kern in ("flash_fwd_bf16_kernel", "flash_bwd_dkv_bf16_kernel",
                     "flash_bwd_dq_bf16_kernel"):
            ops = sass.get(f"flash_attention_d{d}", {}).get(f"{kern}<{d}>")
            check(not sass or (ops is not None and ops["HMMA"] > 0),
                  f"no HMMA in {kern}<{d}>: {ops}")
            if ops:
                whole, hot = per_ex2(ops)
                log(f"17a SASS {kern}<{d}> (static): {json.dumps(ops)}; "
                    f"instructions other than MUFU per MUFU.EX2: {whole:.2f} "
                    f"in the binary, {hot:.2f} in the hot step "
                    f"({ops['hot'][0]} instructions, {ops['hot'][1]} EX2)")
    gen = torch.Generator(device=dev).manual_seed(17)
    worst = dict.fromkeys(FLASH_KERNELS, 0.0)

    def randn(shape):
        return torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16)

    for shape in FLASH_BF16_CASES:
        check_flash_bf16(torch, fa, str(shape), *(randn(shape)
                                                  for _ in range(4)), worst)
    flash_bf16_controls(torch, fa, str(FLASH_BF16_CONTROL),
                        *(randn(FLASH_BF16_CONTROL) for _ in range(4)))
    q, k, v, do = (randn(FLASH_SLICE) for _ in range(4))
    check_flash_bf16(torch, fa, str(FLASH_SLICE), q, k, v, do, worst)
    torch.cuda.empty_cache()
    # a trained prior's sharp head on which the logits' tensor-core sums
    # put dk past the float64 half (Queue 3 item 1; kernels/fixtures/)
    fix = torch.load(DKV_FIXTURE, weights_only=False)
    check_flash_bf16(torch, fa, "fixture dkv_sharp_prior (1, 1, 4096, 16)",
                     *(fix[n].to(dev) for n in ("q", "k", "v", "do")), worst)
    del fix

    scale = FLASH_SLICE[-1] ** -0.5
    o, lse2 = fa.flash_fwd(q, k, v, scale)
    di = (o.float() * do.float()).sum(-1)
    ms = {
        "flash_attention_fwd": graph_ms(
            torch, lambda: fa.flash_fwd(q, k, v, scale), reps=20),
        "flash_attention_bwd_dkv": graph_ms(
            torch, lambda: fa.flash_bwd_dkv(q, k, v, do, lse2, di, scale),
            reps=20),
        "flash_attention_bwd_dq": graph_ms(
            torch, lambda: fa.flash_bwd_dq(q, k, v, do, lse2, di, scale),
            reps=20),
    }
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    with torch.no_grad():
        plain_fwd = time_ms(torch, lambda: fa.flash_causal_attention_plain(
            q, k, v, scale), reps=3, warmup=1)
    out = fa.flash_causal_attention_plain(*leaves, scale)
    plain_bwd = time_ms(torch, lambda: torch.autograd.grad(
        out, leaves, do, retain_graph=True), reps=3, warmup=1)
    del leaves, out
    torch.cuda.empty_cache()
    # the yardstick, timed as the kernels are: SDPA's causal forward and the
    # flash backward its autograd calls, each by CUDA-graph replay
    sdpa_fwd, sdpa_bwd = sdpa_ms(q, k, v, do, scale, reps=20)
    del o, lse2, di, q, k, v, do
    torch.cuda.empty_cache()
    bounds = flash_bounds(FLASH_SLICE, peaks, elem_bytes=2,
                          tensor_sxm=BF16_SXM)
    log(f"flash_attention bf16 timing {FLASH_SLICE} (graph replay): "
        + ", ".join(f"{n} {ms[n] * 1e3:.1f} us (bound {b['ms'] * 1e3:.1f} "
                    f"us, {b['by']}: products at bf16 "
                    f"{b['products_ms'] * 1e3:.1f} us, exp2 "
                    f"{b['exp2_ms'] * 1e3:.1f} us, bytes "
                    f"{b['bytes_ms'] * 1e3:.1f} us; beside it, the fma-chain "
                    f"logits on the fp32 cores "
                    f"{b['fma_logits_ms'] * 1e3:.1f} us)"
                    for n, b in bounds.items())
        + f"; plain forward {plain_fwd:.3f} ms, plain backward "
          f"{plain_bwd:.3f} ms; scaled_dot_product_attention bf16 forward "
          f"{sdpa_fwd * 1e3:.1f} us, backward {sdpa_bwd * 1e3:.1f} us")
    rows = []
    for name in FLASH_KERNELS:
        fwd = name == "flash_attention_fwd"
        rows.append({
            "name": f"{name}_bf16", "route": "cuda",
            "source": "movae_tpu_torch/kernels/flash_attention.cu",
            "replaces": FLASH_REPLACES[name], "launches": None,
            "max_abs_err": worst[name], "ms": ms[name],
            "plain_ms": plain_fwd if fwd else plain_bwd,
            "bound_ms": bounds[name]["ms"], "bound_by": bounds[name]["by"],
            "library_ms": sdpa_fwd if fwd else sdpa_bwd,
        })
    return rows


def phase_prior_bf16(torch, fa, dev, f32_prior: dict, rows: list,
                     profile: bool = False, hold=None) -> dict:
    """17b: the stage-2 PixelSNAIL in bf16 at phase 5's width and cut
    (256-px VQ-VAE extraction, L = 4096, 8 blocks of 128 channels and 8
    heads of 16, batch 16), every flash launch recorded with its dtype:
    8 bf16 launches of each kernel a step and none at float32; the step
    ms, codes/s and peak memory beside phase 5's float32 numbers; the
    kernels on the trained bf16 prior's last-layer q, k, v; then
    train_prior with grad_accum 2 and with steps_per_dispatch 8.
    ``hold(q, k, v, do, label)``, where given, takes the trained prior's
    q/k/v in place of 17a's check and controls (``--probe``)."""
    from types import SimpleNamespace

    from movae_tpu_torch.kernels import LAUNCH_COUNTS, reset_launch_counts
    from movae_tpu_torch.models.base import compute_region
    from movae_tpu_torch.train.prior import train_prior

    dtypes = []
    launch = fa._launch

    def recorded(name, count, dtype, *a):
        dtypes.append(dtype)
        return launch(name, count, dtype, *a)

    fa._launch = recorded
    try:
        res, snail, codes = phase_prior(torch, dev, profile, "bfloat16")
    finally:
        fa._launch = launch
    check(dtypes and all(d == torch.bfloat16 for d in dtypes),
          f"17b: flash launches at {sorted(set(map(str, dtypes)))}: a bf16 "
          f"tensor reached another instance")
    for r in rows:
        r["launches"] = res["launches"][r["name"][:-len("_bf16")]]
    res["vs_float32"] = {k: res[k] / f32_prior[k] for k in
                         ("step_ms", "codes_per_sec", "peak_mem_gib")}

    # the kernels on the trained bf16 prior's own q, k, v
    attn = snail.blocks[-1].attention
    seen = []
    hook = attn.register_forward_pre_hook(lambda mod, a: seen.append(a[0]))
    with torch.no_grad():
        snail.logits_nchw(torch.from_numpy(codes).to(dev))
        with compute_region(torch.bfloat16, dev):
            q, k, v = attn.qkv(seen[0])
    hook.remove()
    check(q.dtype == torch.bfloat16, f"17b: prior q/k/v are {q.dtype}")
    do = torch.randn(q.shape, device=dev, generator=torch.Generator(
        device=dev).manual_seed(6)).to(torch.bfloat16)
    worst = dict.fromkeys(FLASH_KERNELS, 0.0)
    label = f"trained bf16 prior q/k/v {tuple(q.shape)}"
    q, k, v = (t.contiguous() for t in (q, k, v))
    if hold is not None:
        hold(q, k, v, do, label)
    else:
        check_flash_bf16(torch, fa, label, q, k, v, do, worst)
        flash_bf16_controls(torch, fa, label, q, k, v, do)
    for r in rows:
        r["max_abs_err"] = max(r["max_abs_err"],
                               worst[r["name"][:-len("_bf16")]])
    del snail, q, k, v, do
    torch.cuda.empty_cache()

    # grad_accum 2 (4 full batches: 2 updates) and steps_per_dispatch 8
    # (8 batches), bf16, on codes of the same grid
    rng = torch.Generator().manual_seed(3)
    grid = PRIOR_SIZE // 4
    more = torch.randint(0, FULL_WIDTH["num_embeddings"],
                         (8 * PRIOR_BATCH, grid, grid), generator=rng,
                         dtype=torch.int32).numpy()
    meta = SimpleNamespace(num_embeddings=FULL_WIDTH["num_embeddings"],
                           embedding_dim=FULL_WIDTH["embedding_dim"])
    for label, kw, batches in (("grad_accum_2", dict(grad_accum=2), 4),
                               ("steps_per_dispatch_8",
                                dict(steps_per_dispatch=8), 8)):
        args = SimpleNamespace(**PRIOR_ARGS, compute_dtype="bfloat16", **kw)
        trace = []
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        train_prior({"codes": more[:batches * PRIOR_BATCH]}, meta, args,
                    device=dev, step_trace=trace)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        updates = batches // kw.get("grad_accum", 1)
        check(len(trace) == updates and all(v == v for v in trace),
              f"17b {label}: {len(trace)} updates {trace}, expected "
              f"{updates}")
        layers = PRIOR_ARGS["pixelsnail_num_blocks"]
        check(LAUNCH_COUNTS["flash_attention_fwd"] == layers * batches,
              f"17b {label}: {LAUNCH_COUNTS['flash_attention_fwd']} "
              f"forward launches for {batches} batches")
        res[label] = {"updates": updates, "batches": batches,
                      "seconds_with_init": secs, "ce": trace}
        torch.cuda.empty_cache()
    log(f"phase 17b (bf16 PixelSNAIL prior, L={grid * grid}, batch "
        f"{PRIOR_BATCH}): {json.dumps(res)}")
    return res


def dispatch_run(torch, dev, path: dict, agg: str, dtype: str,
                 steps: int) -> dict:
    """``path``'s model under ``agg`` in ``dtype``, ``steps`` train steps
    queued as the loop queues them, one synchronisation at the end: step
    ms, images/s and the host synchronisations of a step."""
    from movae_tpu_torch.models import get_network, init_model
    from movae_tpu_torch.moo import AggregatorConfig, init_state
    from movae_tpu_torch.train.optim import build_optimizer, lr_schedule
    from movae_tpu_torch.train.state import TrainState
    from movae_tpu_torch.train.step import make_train_step

    model = init_model(get_network(path["size"], 3, dict(
        path["width"], compute_dtype=dtype)), seed=0, device=dev)
    cfg = AggregatorConfig(name=agg, num_objectives=len(model.objective_names))
    lr, sched, epochs, spe = path["lr"]
    state = TrainState.create(model, build_optimizer(
        "adam", lr_schedule(lr, sched, epochs, spe, lr_min=1e-6)),
        init_state(cfg))
    step = make_train_step(model, cfg, normalize_inputs=path["uint8"])
    gen = torch.Generator(device=dev).manual_seed(1)
    shape = (path["batch"], path["size"], path["size"], 3)
    batch = torch.randint(0, 256, shape, generator=gen, device=dev,
                          dtype=torch.uint8)
    if not path["uint8"]:
        batch = batch.float() / 127.5 - 1.0
    for _ in range(2):
        step(state, batch, gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        state, met = step(state, batch, gen)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    syncs, sites = count_syncs(torch, lambda: step(state, batch, gen))
    loss = float(met["total_loss"])
    check(loss == loss, f"{agg} {dtype}: loss {loss}")
    res = {"agg": agg, "dtype": dtype, "steps": steps,
           "step_ms": secs / steps * 1e3,
           "images_per_sec": steps * path["batch"] / secs,
           "host_syncs_per_step": syncs, "sync_sites": sites}
    del state, model, batch
    torch.cuda.empty_cache()
    return res


def phase_bench_defaults(torch, dev, card: str) -> dict:
    """17c: the JAX bench's default workload through the port's bench
    (vq_vae 32 px, bf16, batch 1024, k = 8, sum, adam 1e-3), then bf16 at
    k = 1 and float32 at k = 1 at the same batch (a dispatch is k single
    steps: k only groups them); nearest_code launches equal to the
    forwards, the host synchronisations a step (at most 1/8 under sum at
    k = 8); then the cifar100 vae/mgda config of 16b twice (its host
    solve's one synchronisation a step)."""
    from movae_tpu_torch import bench
    from movae_tpu_torch.kernels import LAUNCH_COUNTS

    count_syncs(torch, lambda: None)  # the debug mode's own first switch
    res = {"card": card}
    for label, flags in (("default", []),
                         ("bf16_k1", ["--steps_per_dispatch", "1"]),
                         ("f32_k1", ["--steps_per_dispatch", "1",
                                     "--dtype", "float32"])):
        start = LAUNCH_COUNTS["nearest_code"]
        line = bench.main(["--steps", str(BENCH_17C_STEPS)] + flags)
        launches = LAUNCH_COUNTS["nearest_code"] - start
        check(launches == line["steps_run"],
              f"17c {label}: nearest_code launched {launches} times in "
              f"{line['steps_run']} forwards")
        res[label] = dict(line, nearest_code_launches=launches)
        torch.cuda.empty_cache()
    d = res["default"]
    check(d["dtype"] == "bfloat16" and d["steps_per_dispatch"] == 8
          and "bs=1024" in d["metric"],
          f"17c: the bench's defaults are not the JAX bench's: {d}")
    check(d["host_syncs_per_step"] <= 1 / 8,
          f"17c: {d['host_syncs_per_step']} host synchronisations a step "
          f"at k = 8 under sum")
    res["default_over_bf16_k1"] = d["value"] / res["bf16_k1"]["value"]
    res["default_over_f32_k1"] = d["value"] / res["f32_k1"]["value"]
    vae = vae_path(VAE_16B)
    res["vae_mgda"] = [dispatch_run(torch, dev, vae, vae["agg"], "float32",
                                    VAE_17C_STEPS) for _ in range(2)]
    log(f"phase 17c (the JAX bench's default workload through the port's "
        f"bench; {card}): {json.dumps(res)}")
    return res


def lever_run(torch, dev, path: dict, remat: bool, accum: int) -> dict:
    """One way of a 256-px path: ``remat`` and/or ``grad_accum`` (the
    batch split into ``accum`` microbatches): peak memory and step ms over
    LEVER_TIMED steps after LEVER_WARMUP."""
    from movae_tpu_torch.models import get_network, init_model
    from movae_tpu_torch.moo import AggregatorConfig, init_state
    from movae_tpu_torch.train.optim import build_optimizer, lr_schedule
    from movae_tpu_torch.train.state import TrainState
    from movae_tpu_torch.train.step import make_train_step

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = init_model(get_network(path["size"], 3, path["width"]), seed=0,
                       device=dev)
    cfg = AggregatorConfig(name="sum",
                           num_objectives=len(model.objective_names))
    lr, sched, epochs, spe = path["lr"]
    state = TrainState.create(model, build_optimizer(
        "adam", lr_schedule(lr, sched, epochs, spe, lr_min=1e-6)),
        init_state(cfg))
    step = make_train_step(model, cfg, normalize_inputs=path["uint8"],
                           remat=remat, grad_accum=accum)
    gen = torch.Generator(device=dev).manual_seed(1)
    b = path["batch"]
    shape = (b // accum, path["size"], path["size"], 3)
    if accum > 1:
        shape = (accum, *shape)
    batch = torch.randint(0, 256, shape, generator=gen, device=dev,
                          dtype=torch.uint8)
    times = []
    for i in range(LEVER_WARMUP + LEVER_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, met = step(state, batch, gen)
        torch.cuda.synchronize()
        if i >= LEVER_WARMUP:
            times.append(time.perf_counter() - t0)
    loss = float(met["total_loss"])
    check(loss == loss and float(met["skipped_nonfinite"]) == 0.0,
          f"17d {path['width']['arch']} remat={remat} accum={accum}: "
          f"loss {loss}")
    res = {"remat": remat, "grad_accum": accum,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "step_ms": statistics.median(times) * 1e3, "loss": loss}
    del state, model, batch
    torch.cuda.empty_cache()
    return res


def phase_levers(torch, dev, card: str) -> dict:
    """17d: the memory levers at 256 px on the celeba-hq vq_vae2/sum path
    (phase 7, batch 128) and the 16a vae (BatchNorm and noise, batch 128):
    plain, --remat, --grad_accum 2 (2 x 64) and both."""
    res = {"card": card}
    for label, path in (("vq_vae2", VQVAE2), ("vae_16a", vae_path(VAE_16A))):
        res[label] = [lever_run(torch, dev, path, remat, accum)
                      for remat, accum in ((False, 1), (True, 1),
                                           (False, 2), (True, 2))]
    log(f"phase 17d (memory levers at 256 px, sum; {card}): "
        f"{json.dumps(res)}")
    return res


def phase_locksteps_17e(torch, dev) -> dict:
    """17e: on the card, with deterministic kernels, 4 scanned steps
    against 4 single steps with a NaN batch at position 2 (skipped; the
    counter and lr do not advance), bit for bit or within the spread of
    two single-step runs; remat against no remat (3 SGD steps) on vq_vae
    with vq_ema and on the BatchNorm vae within REMAT_TOL; then an
    accumulating step (A = 2, SGD at lr 1: the update is the accumulated
    gradient) against the mean of the two microbatches' single-step
    gradients within ACCUM_TOL; a bf16 vae step on the card against the
    port's bf16 step on the CPU within BF16_STEP_TOL, every conv and dense
    layer of both computing in bf16 (forward hooks)."""
    import numpy as np

    from movae_tpu_torch.models import get_network, init_model
    from movae_tpu_torch.moo import AggregatorConfig, init_state
    from movae_tpu_torch.train.optim import build_optimizer, lr_schedule
    from movae_tpu_torch.train.state import TrainState
    from movae_tpu_torch.train.step import (make_scanned_train_step,
                                            make_train_step)

    small_vq = dict(FULL_WIDTH, hidden_dims=(16, 32), embedding_dim=8,
                    num_embeddings=32)
    small_vae = dict(arch="vae", hidden_dims=(8, 16), latent_dim=8,
                     layer_norm="batch", batch_size=4, dataset_size=64)
    rng = np.random.default_rng(7)

    def imgs(n, size=16):
        return torch.tensor(rng.uniform(-1, 1, (n, 4, size, size, 3)).astype(
            np.float32))

    def build(width, where, opt="adam", lr=1e-3, sched=None, dtype=None,
              **kw):
        w = dict(width, **({"compute_dtype": dtype} if dtype else {}))
        model = init_model(get_network(16, 3, w), seed=3, device=where)
        cfg = AggregatorConfig(name=kw.pop("agg", "sum"),
                               num_objectives=len(model.objective_names))
        tx = build_optimizer(opt, lr_schedule(lr, sched, 8, 1), eps=1e-4,
                             **({"momentum": 0.0} if opt == "sgd" else {}))
        state = TrainState.create(model, tx, init_state(cfg))
        return model, state, make_train_step(model, cfg, 8, 1, **kw)

    def max_diff(a, b):
        return max(float((a[k].double() - b[k].double()).abs().max())
                   for k in a)

    res = {}
    with deterministic_kernels(torch):
        # scanned against single (twice: the run-to-run spread), a NaN
        # batch at position 2 of 4
        xb = imgs(4).to(dev)
        xb[2, 0, 0, 0, 0] = float("nan")
        sds, mets = [], []
        for scanned in (False, False, True):
            model, state, step = build(small_vq, dev, sched="cosine",
                                       agg="upgrad")
            gen = torch.Generator(device=dev).manual_seed(0)
            if scanned:
                state, met = make_scanned_train_step(step, 4)(state, xb,
                                                              gen)
            else:
                met = [step(state, xb[i], gen)[1] for i in range(4)]
                met = {k: torch.stack([m[k] for m in met]) for k in met[0]}
            sds.append({k: v.cpu() for k, v in model.state_dict().items()})
            mets.append({k: v.cpu() for k, v in met.items()})
            check(int(state.step) == 3 and float(state.tx.lr(state.step))
                  == float(state.tx.lr(3)),
                  f"17e scan: counter {int(state.step)} after 4 steps, "
                  f"one skipped")
        spread, err = max_diff(sds[0], sds[1]), max_diff(sds[0], sds[2])
        check(err <= 2 * spread,
              f"17e: 4 scanned steps differ from 4 single steps by "
              f"{err:.3e} (two single runs by {spread:.3e})")
        check(mets[2]["skipped_nonfinite"].tolist() == [0.0, 0.0, 1.0, 0.0],
              f"17e scan skips {mets[2]['skipped_nonfinite'].tolist()}")
        res["scan_vs_single"] = {"bit_for_bit": err == 0.0,
                                 "max_abs_err": err, "single_spread": spread,
                                 "applied_steps": 3}

        # remat against no remat (SGD, 3 steps)
        xr = imgs(3).to(dev)
        for label, width in (("vq_vae_ema", dict(small_vq, vq_ema=True)),
                             ("vae_bn", small_vae)):
            sds = []
            for remat in (False, True):
                model, state, step = build(width, dev, opt="sgd", lr=1e-2,
                                           remat=remat)
                gen = torch.Generator(device=dev).manual_seed(0)
                for i in range(3):
                    step(state, xr[i], gen)
                sds.append({k: v.cpu() for k, v in
                            model.state_dict().items()})
            err = max_diff(*sds)
            check(err <= REMAT_TOL, f"17e remat {label}: {err:.3e}")
            res[f"remat_{label}"] = {"max_abs_err": err,
                                     "bit_for_bit": err == 0.0}

    # accumulation against the mean of the microbatch gradients (SGD lr 1)
    xa = imgs(2).to(dev)
    ups = []
    for i in range(2):
        model, state, step = build(small_vq, dev, opt="sgd", lr=1.0)
        before = {k: v.clone() for k, v in model.state_dict().items()}
        step(state, xa[i])
        ups.append({k: model.state_dict()[k] - before[k] for k in before})
    model, state, step = build(small_vq, dev, opt="sgd", lr=1.0,
                               grad_accum=2)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    step(state, xa)
    scale = max(float(u.abs().max()) for u in ups[0].values())
    acc_err = max(float(((model.state_dict()[k] - before[k])
                         - 0.5 * (ups[0][k] + ups[1][k])).abs().max())
                  for k in before) / scale
    check(acc_err <= ACCUM_TOL, f"17e accumulation: {acc_err:.3e} of the "
          f"largest update from the microbatch mean")
    res["accum_vs_mean"] = {"max_err_over_largest_update": acc_err}

    # a bf16 vae step, card against CPU (SGD lr 1: the update is the
    # gradient); the N(0, I) draw made once on the host
    xv = imgs(1)[0]
    noise = {"eps": torch.tensor(rng.standard_normal((4, 8)).astype(
        np.float32))}
    runs = {}
    layers = (torch.nn.Conv2d, torch.nn.ConvTranspose2d, torch.nn.Linear)
    for where in ("cpu", dev):
        model, state, step = build(small_vae, where, opt="sgd", lr=1.0,
                                   dtype="bfloat16")
        before = {k: v.clone() for k, v in model.state_dict().items()}
        # the output dtype of every conv and dense layer the step runs
        seen = []
        hooks = [m.register_forward_hook(
            lambda mod, a, out, n=n: seen.append((n, str(out.dtype))))
            for n, m in model.named_modules() if isinstance(m, layers)]
        _, met = step(state, xv, noise=noise)
        for h in hooks:
            h.remove()
        check(seen and all(d == "torch.bfloat16" for _, d in seen),
              f"17e bf16 step on {where}: layer output dtypes {seen}")
        runs[str(where)] = ({k: (model.state_dict()[k] - before[k]).cpu()
                             for k, _ in model.named_parameters()},
                            float(met["total_loss"]))
    (up_c, l_c), (up_d, l_d) = runs["cpu"], runs[str(dev)]
    scale = max(float(u.abs().max()) for u in up_c.values())
    err = max(float((up_c[k] - up_d[k]).abs().max()) for k in up_c) / scale
    check(err <= BF16_STEP_TOL and abs(l_c - l_d) <= 2e-3 * abs(l_c),
          f"17e bf16 step: card vs CPU update {err:.3e} of the largest, "
          f"losses {l_c} {l_d}")
    res["bf16_card_vs_cpu"] = {"update_err_over_largest": err,
                               "loss_cpu": l_c, "loss_card": l_d}
    log(f"phase 17e (card locksteps): {json.dumps(res)}")
    return res


def phase_item6(torch, fa, dev, peaks, sass: dict, f32_prior: dict,
                card: str, profile: bool = False) -> list:
    """Phase 17 (17a-17e); returns the three bf16 kernel rows. ``profile``
    adds 17b's torch.profiler breakdown."""
    t0 = time.perf_counter()
    rows = phase_flash_bf16(torch, fa, dev, peaks, sass)
    phase_prior_bf16(torch, fa, dev, f32_prior, rows, profile)
    phase_bench_defaults(torch, dev, card)
    phase_levers(torch, dev, card)
    phase_locksteps_17e(torch, dev)
    log(f"phase 17 (bf16, grad_accum, steps_per_dispatch, remat; {card}): "
        f"{time.perf_counter() - t0:.1f} s")
    return rows



# ---------------------------------------------------------------------------
# phase 18: the standalone CLIs and the sphere encoders
# ---------------------------------------------------------------------------

def counted_call(torch, fn, *a) -> tuple:
    """``fn(*a)`` with the launch counts set to 0 just before and read just
    after: (its result, wall seconds, counts)."""
    from movae_tpu_torch.kernels import LAUNCH_COUNTS, reset_launch_counts

    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    out = fn(*a)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, dict(LAUNCH_COUNTS)


def image_stats(imgs) -> dict:
    import numpy as np

    imgs = np.asarray(imgs)
    return {"shape": list(imgs.shape), "finite": bool(np.isfinite(imgs).all()),
            "min": float(imgs.min()), "max": float(imgs.max())}


def phase_prior_clis(torch, dev, roots: dict, profile: bool) -> dict:
    """18a: train_prior_vqvae2 on 15a's run and train_prior_vqvae
    (PixelSNAIL) on 15b's, then both generators from the checkpoints
    alone, each through its ``main(argv)`` with the counts set to 0 just
    before and read just after: nearest-code launches = the extraction
    batches (two per batch for the VQ-VAE-2), 8 launches of each flash
    kernel per PixelSNAIL step, none in a generator. The files land where
    the JAX CLIs put them; every image is finite (these configs have no
    output activation: the range is printed); the hierarchical generator,
    run a second time with its seed, repeats its images bit for bit. The
    generators' images, by run tree, are ``res["live_samples"]``."""
    from movae_tpu_torch import generate_samples_pixelcnn_vqvae as gen_mod
    from movae_tpu_torch import generate_samples_pixelcnn_vqvae2 as gen2_mod
    from movae_tpu_torch import train_prior_vqvae as tp_mod
    from movae_tpu_torch import train_prior_vqvae2 as tp2_mod
    from movae_tpu_torch.train import checkpoint as ckpt_lib

    res = {}
    none = dict.fromkeys(("nearest_code", *FLASH_KERNELS), 0)
    launches = dict(none)

    def need(*path):
        check(os.path.exists(os.path.join(*path)),
              f"18a: missing {os.path.join(*path)}")

    for label, mod, root, argv, prior_dir in (
            ("train_prior_vqvae2", tp2_mod, roots["15a"], CLI_18A_V2,
             "pixelcnn_prior"),
            ("train_prior_vqvae", tp_mod, roots["15b"], CLI_18A_SNAIL,
             "pixelsnail_prior")):
        ckpt = ckpt_lib.final_checkpoint_path(root)
        out, secs, counts = counted_call(
            torch, mod.main, ["--model_path", ckpt] + argv)
        merged = out["merged"]
        n = synthetic_count(merged.dataset)
        batches = -(-n // merged.batch_size)
        hier = out["prior"]["hierarchical"]
        steps = batches  # one prior epoch: one step per full or tail batch
        expect = dict(none, nearest_code=(2 if hier else 1) * batches)
        if not hier:
            blocks = merged.pixelsnail_num_blocks
            expect.update({k: blocks * steps for k in FLASH_KERNELS})
        check(counts == expect, f"18a {label}: launches {counts}, expected "
              f"{expect} ({batches} extraction batches, {steps} steps)")
        for name in ("best_prior", "final_prior", "last_prior"):
            need(root, prior_dir, "checkpoints", f"{name}.pth")
        for ext in ("pdf", "png"):
            need(root, "figures", "generated", f"prior_samples.{ext}")
        stats = image_stats(out["samples"])
        check(stats["finite"], f"18a {label}: samples {stats}")
        finals = out["finals"]  # the VQ-VAE-2 run asks for them
        check(bool(finals) == hier, f"18a {label}: final/* {finals}")
        for k, v in finals.items():
            if k in ("precision", "recall"):
                check(v != v, f"18a final/{k} is {v}, expected nan")
            else:
                check(v == v and abs(v) != float("inf"),
                      f"18a final/{k} is {v}")
        for k in counts:
            launches[k] += counts[k]
        res[label] = {"seconds": secs, "launches": counts,
                      "steps": steps, "batch": merged.batch_size,
                      "hierarchical": hier, "samples": stats,
                      "final": finals}
        log(f"phase 18a {label} on {root}: {json.dumps(res[label])}")

    out_dir = tempfile.mkdtemp(prefix="movae_gen_", dir=roots["tmp"])
    live = {}  # each run tree's generated images, phase 19's live samples
    for label, mod, root, prior_dir, extra, rerun in (
            ("generate_samples_pixelcnn_vqvae2", gen2_mod, roots["15a"],
             "pixelcnn_prior", ["--individual"], True),
            ("generate_samples_pixelcnn_vqvae", gen_mod, roots["15b"],
             "pixelsnail_prior", ["--kv_cache_dtype", "int8"], False)):
        argv = ["--model_path", ckpt_lib.final_checkpoint_path(root),
                "--prior_path", os.path.join(root, prior_dir, "checkpoints",
                                             "best_prior.pth"),
                "--out_dir", os.path.join(out_dir, label)] + \
            CLI_18A_GEN + extra
        runs = [counted_call(torch, mod.main, argv)
                for _ in range(2 if rerun else 1)]
        for out, _, counts in runs:
            check(counts == none, f"18a {label}: launches {counts}")
        imgs = runs[0][0]["images"]
        stats = image_stats(imgs)
        n = int(CLI_18A_GEN[CLI_18A_GEN.index("--num_samples") + 1])
        check(stats["finite"] and len(imgs) == n, f"18a {label}: {stats}")
        files = sorted(os.listdir(os.path.join(out_dir, label)))
        want = ([f"sample_{i:05d}.png" for i in range(n)]
                if "--individual" in extra else ["samples.pdf",
                                                 "samples.png"])
        check(files == want, f"18a {label}: wrote {files[:4]}...")
        res[label] = {"seconds": [r[1] for r in runs], "samples": stats,
                      "files": len(files)}
        live[root] = imgs
        if rerun:
            check((runs[0][0]["images"] == runs[1][0]["images"]).all(),
                  f"18a {label}: a second generation with one seed "
                  f"differs")
            res[label]["rerun_equal"] = True
        log(f"phase 18a {label}: {json.dumps(res[label])}")
        if profile and rerun:
            profile_device(torch, f"18a {label} ({n} samples)",
                           lambda: mod.main(argv), 1, runs[0][1] * 1e3)
    res["launches"] = launches
    res["live_samples"] = live
    return res


def phase_benchmark_workers(torch) -> dict:
    """18b: ``benchmark_workers`` on the card machine's host: the batch
    sweep and the worker-thread sweep, images/s of each cell."""
    from movae_tpu_torch import benchmark_workers as bw_mod

    res = {}
    for flags in CLI_18B:
        axis = "workers" if "--workers" in flags else "batch"
        t0 = time.perf_counter()
        rows = bw_mod.main(flags + CLI_18B_COMMON)
        check(all(r[3] > 0 for r in rows), f"18b {axis}: {rows}")
        res[axis] = {"rows": [{axis: r[0], "s_per_batch": r[1],
                               "std": r[2], "images_per_sec": r[3]}
                              for r in rows],
                     "seconds": time.perf_counter() - t0}
    res["cpus"] = os.cpu_count()
    log(f"phase 18b (benchmark_workers, synthetic-32): {json.dumps(res)}")
    return res


def phase_sphere_vit(torch, dev, profile: bool, card: str) -> dict:
    """18c: sphere_encoder_vit at full width under sum and upgrad
    (``vae_runs``: step ms, images/s, host syncs a step, peak memory; the
    parameter count), then ``sample`` at 1 and 4 steps from the trained
    weights: finite, in tanh's range."""
    path = SPHERE_VIT_18C

    def sample(model) -> dict:
        res = {}
        gen = torch.Generator(device=dev).manual_seed(5)
        for steps in SPHERE_SAMPLE_STEPS:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            imgs = model.sample(path["batch"], generator=gen, steps=steps)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            stats = image_stats(imgs.cpu().numpy())
            check(stats["finite"] and -1 <= stats["min"]
                  and stats["max"] <= 1
                  and stats["shape"] == [path["batch"], path["size"],
                                         path["size"], 3],
                  f"18c sample at {steps} steps: {stats}")
            res[f"sample_{steps}_steps"] = {"seconds": secs, **stats}
        return res

    out, _ = vae_runs(torch, dev, path, ("sum", "upgrad"), profile, card,
                      after=sample)
    torch.cuda.empty_cache()
    out["latent_dim"] = path["width"]["latent_dim"]
    log(f"phase 18c (sphere_encoder_vit, depth 24, dim 1024, batch "
        f"{path['batch']}): {json.dumps(out)}")
    return out


def phase_sphere_cli(torch, dev, profile: bool, card: str) -> dict:
    """18d: the conv sphere_encoder through ``python -m
    movae_tpu_torch.main``'s ``main`` in-process at main.py's widths with
    CLI_18D's cuts: the run tree, finite final/* values (precision and
    recall nan), no prior stage, the wall time of each part; then its bare
    step at that width under sum."""
    from scipy import linalg

    from movae_tpu_torch import main as main_mod
    from movae_tpu_torch.train import checkpoint as ckpt_lib
    from movae_tpu_torch.train import final_metrics as fm
    from movae_tpu_torch.train import loop

    tmp = tempfile.mkdtemp(prefix="movae_sphere_cli_")
    try:
        args = main_mod.parse_args(CLI_18D + ["--save_path", tmp])
        parts = [("dataset", loop, "get_dataset", False),
                 ("train_epochs", loop, "train_epoch", False),
                 ("train_epochs", loop, "train_epoch_device", False),
                 ("eval", loop, "evaluate", False),
                 ("figures", loop, "_write_figures", False),
                 ("checkpoint_writes", ckpt_lib, "save_checkpoint", False),
                 ("final_metrics", fm, "run_final_metrics", False),
                 ("final_metrics_generation", fm, "generate_samples", False),
                 ("final_metrics_sqrtm", linalg, "sqrtm", False)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with PartTimer(torch, parts) as timer:
            results = main_mod.main(args)
        wall = time.perf_counter() - t0
        roots = run_tree(tmp)
        check(len(roots) == 1, f"18d: run roots {roots}")
        final = check_run_tree(roots[0], (1, 2), prior=False, finals=True)
        check(not [d for d in os.listdir(roots[0]) if d.endswith("_prior")],
              "18d: a prior stage ran")
        secs = {k: sum(v) for k, v in timer.secs.items()}
        secs["wall"] = wall
        res = {"seconds": secs, "final": final,
               "cli_train_images_per_sec": results["images_per_sec"],
               "params": sum(p.numel() for p in
                             results["model"].parameters())}
        del results
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()
    res["bare"], _ = vae_runs(torch, dev, SPHERE_CONV_18D, ("sum",), profile,
                              card)
    log(f"phase 18d (CLI, sphere_encoder, {' '.join(CLI_18D)}): "
        f"{json.dumps(res)}")
    return res


def phase_sphere_lockstep(torch, dev, steps: int = 3) -> dict:
    """18e: ``steps`` upgrad steps of the small ViT from one init on the
    CPU and on the card, each step's draws (angle, s, e) made once on the
    host and given to both: the state_dict and the losses within 1e-4."""
    import numpy as np

    from movae_tpu_torch.models import get_network, init_model
    from movae_tpu_torch.moo import AggregatorConfig, init_state
    from movae_tpu_torch.train.optim import build_optimizer
    from movae_tpu_torch.train.state import TrainState
    from movae_tpu_torch.train.step import make_train_step

    width, b = SPHERE_VIT_18E, 4
    rng = np.random.default_rng(0)
    batches = [torch.tensor(rng.uniform(-1, 1, (b, 16, 16, 3)).astype(
        np.float32)) for _ in range(steps)]
    noises = [{"angle_deg": torch.tensor((rng.uniform(size=(b, 1)) * 80.0)
                                         .astype(np.float32)),
               "s": torch.tensor((rng.uniform(size=(b, 1)) * 0.5).astype(
                   np.float32)),
               "e": torch.tensor(rng.standard_normal(
                   (b, width["latent_dim"])).astype(np.float32))}
              for _ in range(steps)]
    runs = {}
    for where in ("cpu", dev):
        model = init_model(get_network(16, 3, width), seed=3, device=where)
        cfg = AggregatorConfig(name="upgrad",
                               num_objectives=len(model.objective_names))
        state = TrainState.create(model, build_optimizer("adam", 1e-3,
                                                         eps=1e-4),
                                  init_state(cfg))
        step = make_train_step(model, cfg)
        losses = []
        for xb, noise in zip(batches, noises):
            state, met = step(state, xb, noise=noise)
            losses.append([float(met[k]) for k in
                           (*model.objective_names, "total_loss")])
        runs[str(where)] = ({k: v.cpu() for k, v in
                             model.state_dict().items()}, losses)
    (cpu_sd, cpu_l), (dev_sd, dev_l) = runs["cpu"], runs[str(dev)]
    delta = max(float((cpu_sd[k].double() - dev_sd[k].double()).abs().max())
                for k in cpu_sd)
    loss_delta = max(abs(x - y) / max(abs(x), 1.0)
                     for ra, rb in zip(cpu_l, dev_l) for x, y in zip(ra, rb))
    res = {"steps": steps, "max_state_delta": delta,
           "max_loss_delta": loss_delta, "losses": dev_l}
    log(f"phase 18e lockstep card vs cpu, sphere_encoder_vit {steps} upgrad "
        f"steps: {json.dumps(res)}")
    check(delta < 1e-4 and loss_delta < 1e-4,
          f"18e: card and CPU differ by {delta:.3e} (state) and "
          f"{loss_delta:.3e} (losses)")
    return res


def phase_standalone(torch, dev, roots: dict, profile: bool,
                     card: str) -> tuple:
    """Phase 18 (18a-18e); returns 18a's launches, which join the kernel
    rows, and its generators' images by run tree (phase 19's live
    samples). 18b-18e reach no kernel of the port: their counts must stay
    0."""
    from movae_tpu_torch.kernels import LAUNCH_COUNTS, reset_launch_counts

    t0 = time.perf_counter()
    res = {"18a": phase_prior_clis(torch, dev, roots, profile)}
    torch.cuda.empty_cache()
    reset_launch_counts()
    res["18b"] = phase_benchmark_workers(torch)
    res["18c"] = phase_sphere_vit(torch, dev, profile, card)
    res["18d"] = phase_sphere_cli(torch, dev, profile, card)
    res["18e"] = phase_sphere_lockstep(torch, dev)
    check(not any(LAUNCH_COUNTS.values()),
          f"18b-18e launched a kernel of the port: {dict(LAUNCH_COUNTS)}")
    res["seconds"] = time.perf_counter() - t0
    log(f"phase 18 (standalone CLIs, sphere encoders; {card}): "
        f"{res['seconds']:.1f} s")
    return res["18a"]["launches"], res["18a"]["live_samples"]

def serving_rows(torch, model, xf) -> list:
    """The quantizers' inputs on the preprocessed images ``xf`` with their
    codebooks: one level (``vq_vae``) or two (``vq_rows``)."""
    if hasattr(model, "quantize_t"):
        return vq_rows(torch, model, xf)
    with torch.no_grad():
        z = model.encode(xf).reshape(-1, model.embedding_dim)
    return [(z.contiguous(), model.vq_layer().detach())]


def http(base: str, path: str, body: Optional[bytes] = None) -> bytes:
    """One request to the artifact server (``body`` None: a GET)."""
    import urllib.request

    req = urllib.request.Request(base + path, data=body,
                                 method="GET" if body is None else "POST")
    with urllib.request.urlopen(req, timeout=900) as r:
        return r.read()


def rel_err(got, want) -> float:
    """max |got - want| over max |want|."""
    import numpy as np

    return float(np.abs(got - want).max()) / float(np.abs(want).max())


def serve_artifact(torch, label: str, art: str, live: dict, nc: int,
                   ref: Optional[dict] = None) -> dict:
    """19: the artifact ``art`` behind ``movae_tpu_torch.serve_artifacts``
    on 127.0.0.1 in a thread: /healthz, /manifest, then ``reconstruct``,
    ``encode_codes`` and ``decode_codes`` at each of SERVE_BATCHES and one
    ``sample`` of SERVE_SAMPLE_BATCH images (seed SERVE_SEED). A float32
    artifact (``ref`` None) answers as the live port model in ``live`` does
    on the same inputs: codes but for near ties, images within SERVE_TOL
    of the largest value. An int8 artifact is held within SERVE_INT8_TOL
    of the largest value against float32 weights: its ``decode_codes``
    against the float32 artifact's answer ``ref`` on the same codes, its
    ``reconstruct`` against the live decoder on its own codes (int8
    weights move a few codes: their agreement with the float32 codes is
    reported). ``reconstruct`` and ``encode_codes`` launch ``nc``
    nearest-code kernels in the server, ``decode_codes`` and ``sample``
    none (the counts set to 0 just before each request, read after)."""
    import threading

    import numpy as np

    from movae_tpu_torch import serve_artifacts
    from movae_tpu_torch.kernels import LAUNCH_COUNTS, reset_launch_counts
    from movae_tpu_torch.serve_artifacts import load_body, npy_bytes as npy
    from movae_tpu_torch.train.step import preprocess_batch

    model, size = live["model"], live["size"]
    dev = next(model.parameters()).device
    httpd = serve_artifacts.serve(art, "127.0.0.1", 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    out = {"answers": {}, "launches": 0, "seconds": {}}

    def post(path, body, launches):
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        got = load_body(http(base, path, body))
        secs = time.perf_counter() - t0
        check(LAUNCH_COUNTS["nearest_code"] == launches,
              f"19 {label} {path}: {LAUNCH_COUNTS['nearest_code']} "
              f"nearest-code launches, expected {launches}")
        out["launches"] += launches
        return got, secs

    try:
        health = json.loads(http(base, "/healthz"))
        man = json.loads(http(base, "/manifest"))
        check(health["ok"] and sorted(health["functions"]) == [
            "decode_codes", "encode_codes", "reconstruct", "sample"],
            f"19 {label}: /healthz {health}")
        check(man["device"] == str(dev) and man["prior"],
              f"19 {label}: manifest device {man['device']}, prior "
              f"{man['prior']}")
        gen = torch.Generator(device=dev)
        worst = {"reconstruct": 0.0, "decode_codes": 0.0, "code_rows": 0,
                 "code_mismatch": 0, "code_bad": 0}
        for b in SERVE_BATCHES:
            x = torch.randint(0, 256, (b, size, size, 3), dtype=torch.uint8,
                              generator=gen.manual_seed(b), device=dev)
            xn = x.cpu().numpy()
            (recon,), t_rec = post("/reconstruct", npy(xn), nc)
            codes, t_enc = post("/encode_codes", npy(xn), nc)
            dec_in = codes if ref is None else ref[b]["codes"]
            (dec,), t_dec = post("/decode_codes", npy(*dec_in), 0)
            out["answers"][b] = {"reconstruct": recon, "codes": codes,
                                 "decode_codes": dec}
            out["seconds"][b] = [t_rec, t_enc, t_dec]
            check(np.isfinite(recon).all() and np.isfinite(dec).all()
                  and recon.shape == dec.shape == (b, size, size, 3),
                  f"19 {label} batch {b}: {recon.shape}, {dec.shape}")
            if ref is not None:
                # int8 weights move the encoder's latents, and a few codes
                # with them: reconstruct is held against the float32
                # decoder on the int8 artifact's own codes, decode_codes on
                # the float32 artifact's
                with torch.no_grad():
                    own = model.decode_code(*(torch.from_numpy(c).to(dev)
                                              for c in codes)).float()
                worst["reconstruct"] = max(worst["reconstruct"], rel_err(
                    recon, own.cpu().numpy()))
                worst["decode_codes"] = max(worst["decode_codes"], rel_err(
                    dec, ref[b]["decode_codes"]))
                worst["code_rows"] += sum(c.size for c in codes)
                worst["code_mismatch"] += sum(int((c != r).sum()) for c, r
                                              in zip(codes, ref[b]["codes"]))
                continue
            xf = preprocess_batch(x, live["normalize"])
            with torch.no_grad():
                want_rec = model(xf, train=False)["recons"].float()
                want_dec = model.decode_code(
                    *(torch.from_numpy(c).to(dev) for c in codes)).float()
                want_codes = (model.get_code_indices_pair(xf)
                              if hasattr(model, "quantize_t")
                              else (model.get_code_indices(xf),))
            for (z, cb), g, w in zip(serving_rows(torch, model, xf), codes,
                                     want_codes):
                agree = codes_agree(torch, z, cb,
                                    torch.from_numpy(g).to(dev), w)
                worst["code_rows"] += agree["rows"]
                worst["code_mismatch"] += agree["mismatch"]
                worst["code_bad"] += agree["bad"]
            worst["reconstruct"] = max(worst["reconstruct"], rel_err(
                recon, want_rec.cpu().numpy()))
            worst["decode_codes"] = max(worst["decode_codes"], rel_err(
                dec, want_dec.cpu().numpy()))
        (s,), t_s = post(f"/sample?seed={SERVE_SEED}", b"", 0)
        check(np.isfinite(s).all() and s.shape == (
            SERVE_SAMPLE_BATCH, size, size, 3),
            f"19 {label}: sample {s.shape}")
        out.update(sample=s, sample_seconds=t_s)
        out.update(worst=worst, manifest=man)
        tol = SERVE_TOL if ref is None else SERVE_INT8_TOL
        check(worst["code_bad"] == 0 and worst["reconstruct"] <= tol
              and worst["decode_codes"] <= tol,
              f"19 {label}: {worst} against the "
              f"{'live model' if ref is None else 'float32 artifact'} "
              f"(images within {tol} of the largest value; codes but for "
              f"near ties)")
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=60)
    return out


def phase_serving(torch, dev, roots: dict, live_samples: dict,
                  card: str) -> dict:
    """Phase 19: serving at full width. Phase 15's checkpoints (15a's
    celeba-hq VQ-VAE-2 at 256 px with its HierarchicalPixelCNN, 15b's
    imagenet vq_vae with its PixelSNAIL at L = 4096) exported through
    ``serving.export_checkpoint`` on the card, in float32 and at int8
    weights (KV cache int8; the int8 artifact copies the float32 one's
    sampler programs), each served over HTTP (``serve_artifact``); the
    float32 artifact's ``sample`` against the live model's on the same
    seed (``live_samples``: 18a's generators, by run tree), the int8
    one's within SERVE_INT8_TOL of it and, for 15a, the seed repeated
    through a second load; the int8 image artifacts under half the float32
    ones' bytes; ``serving_ab``'s live and artifact ``reconstruct`` at
    SERVE_AB_BATCHES. Returns the nearest-code launches."""
    import numpy as np

    from movae_tpu_torch import serving, serving_ab
    from movae_tpu_torch.device import deterministic_cudnn
    from movae_tpu_torch.train import checkpoint as ckpt_lib
    from movae_tpu_torch.train.prior import find_prior
    from movae_tpu_torch.train.step import preprocess_batch

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="movae_serving_", dir=roots["tmp"])
    res = {"launches": 0}
    for label in ("15a", "15b"):
        ckpt = ckpt_lib.final_checkpoint_path(roots[label])
        model, args, size = serving._model_from_checkpoint(ckpt, None, dev)
        prior = find_prior(ckpt, model, args)
        check(prior is not None, f"19 {label}: no prior beside {ckpt}")
        live = {"model": model, "prior": prior, "size": size,
                "normalize": bool(getattr(args, "normalize_inputs", False))}
        nc = 2 if hasattr(model, "quantize_t") else 1
        r = {}
        for quant in (None, "int8"):
            key = quant or "f32"
            art = os.path.join(tmp, f"{label}_{key}")
            t0 = time.perf_counter()
            man = serving.export_checkpoint(
                ckpt, art, device=dev, sample_batch=SERVE_SAMPLE_BATCH,
                quantize=quant,
                sampler_from=None if quant is None else r["f32"]["dir"])
            export_s = time.perf_counter() - t0
            copied = [p["copied"] for p in
                      man["functions"]["sample"]["programs"].values()]
            check(all(copied) if quant else not any(copied),
                  f"19 {label} {key}: sampler programs copied {copied}")
            with deterministic_cudnn():
                served = serve_artifact(
                    torch, f"{label} {key}", art, live, nc,
                    None if quant is None else r["f32"]["answers"])
            res["launches"] += served["launches"]
            r[key] = dict(served, export_seconds=export_s, dir=art,
                          bytes={f: e["bytes"]
                                 for f, e in man["functions"].items()},
                          function_export_seconds={
                              f: e["export_seconds"]
                              for f, e in man["functions"].items()})
        ratio = {f: r["int8"]["bytes"][f] / r["f32"]["bytes"][f]
                 for f in ("reconstruct", "encode_codes", "decode_codes")}
        check(all(v < 0.5 for v in ratio.values()),
              f"19 {label}: int8 artifacts at {ratio} of float32's bytes")
        want = live_samples[roots[label]]
        sample_err = rel_err(r["f32"]["sample"], want)
        check(sample_err <= SERVE_TOL,
              f"19 {label}: the float32 artifact's sample is {sample_err} "
              f"of the largest value from the live model's (seed "
              f"{SERVE_SEED})")
        int8_sample_err = rel_err(r["int8"]["sample"], r["f32"]["sample"])
        check(int8_sample_err <= SERVE_INT8_TOL,
              f"19 {label}: the int8 artifact's sample is {int8_sample_err} "
              f"of the largest value from the float32 one's")
        fns = serving.load_serving(r["f32"]["dir"])
        repeat = None
        if prior["hierarchical"]:  # the seed again, through a second load
            with deterministic_cudnn():
                again = fns["sample"](SERVE_SEED).cpu().numpy()
            repeat = bool((again == r["f32"]["sample"]).all())
            check(repeat, f"19 {label}: seed {SERVE_SEED} sampled twice "
                  f"differs")

        def live_rec(x, model=model, norm=live["normalize"]):
            with torch.no_grad():
                return model(preprocess_batch(x, norm),
                             train=False)["recons"].float()

        ab = {}
        for b in SERVE_AB_BATCHES:
            x = torch.randint(0, 256, (b, size, size, 3), dtype=torch.uint8,
                              device=dev, generator=torch.Generator(
                                  device=dev).manual_seed(b))
            med = serving_ab.interleaved(
                {"live": live_rec, "artifact": fns["reconstruct"]}, x,
                **SERVE_AB)
            ab[b] = {f"{k}_images_per_sec": b / v for k, v in med.items()}
        summary = {
            "export_seconds": {k: r[k]["export_seconds"] for k in r},
            "function_export_seconds": {
                k: r[k]["function_export_seconds"] for k in r},
            "bytes": {k: r[k]["bytes"] for k in r},
            "int8_over_f32_bytes": ratio,
            "worst": {k: r[k]["worst"] for k in r},
            "request_seconds": {k: r[k]["seconds"] for k in r},
            "sample_seconds": {k: r[k]["sample_seconds"] for k in r},
            "sample_vs_live": sample_err,
            "int8_sample_vs_f32": int8_sample_err, "seed_repeats": repeat,
            "serving_ab_reconstruct": ab,
            "sample_range": [float(np.min(r["f32"]["sample"])),
                             float(np.max(r["f32"]["sample"]))]}
        log(f"phase 19 {label} ({type(prior['model']).__name__}; {card}): "
            f"{json.dumps(summary)}")
        res[label] = summary
        del model, prior, live, fns, r
        torch.cuda.empty_cache()
    res["seconds"] = time.perf_counter() - t_phase
    log(f"phase 19 (serving; {card}): {res['seconds']:.1f} s, "
        f"{res['launches']} nearest-code launches")
    return res


# ---------------------------------------------------------------------------
# phase 20: the data axis (DDP, fsdp, sample-parallel) over ranks of one card
# ---------------------------------------------------------------------------

def _p20_close(torch, got: dict, want: dict) -> dict:
    """The largest |got - want| / (atol + rtol |want|) over every state
    entry (<= 1 passes) and that entry's name, the largest |got - want|,
    the share of elements within the bound, and the least share within it
    of any one entry (``leaf_within``) and that entry's name."""
    worst, name, diff, inside, total = 0.0, None, 0.0, 0, 0
    leaf_within, leaf = 1.0, None
    for k, w in want.items():
        if not w.numel():
            continue
        g, w = got[k].double(), w.double()
        d = (g - w).abs()
        r = d / (P20_PARAM_ATOL + P20_PARAM_RTOL * w.abs())
        n_in = int((r <= 1).sum())
        inside += n_in
        total += r.numel()
        diff = max(diff, float(d.max()))
        if float(r.max()) > worst:
            worst, name = float(r.max()), k
        if n_in / r.numel() < leaf_within:
            leaf_within, leaf = n_in / r.numel(), k
    return {"worst": worst, "at": name, "max_abs": diff,
            "share_within": inside / max(total, 1),
            "leaf_within": leaf_within, "leaf": leaf}


def p20_bf16_close(p: dict) -> bool:
    """Phase 20's bf16 prior check on a ``_p20_close`` result: at least
    P20_BF16_SHARE of all parameters and P20_BF16_LEAF_SHARE of every
    entry's elements within test_parallel.py's bounds, and no element off
    by more than one Adam step (the learning rate). Each rank's bf16
    weight gradients leave the bf16 convolutions rounded to bf16 before
    the all-reduce, where one device rounds the whole batch's sum once;
    where a gradient's halves cancel, the Adam step can differ by up to
    its size (a bias of 128 has 8 such elements on this data). A fault in
    one entry (left unchanged, or from one rank's rows) moves nearly every
    element of it (``_p20_planted``)."""
    return (p["share_within"] >= P20_BF16_SHARE
            and p["leaf_within"] >= P20_BF16_LEAF_SHARE
            and p["max_abs"] <= PRIOR_ARGS["pixelcnn_lr"])


def _p20_state(model) -> dict:
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _p20_digest(torch, state: dict) -> str:
    """A digest of the state's bytes: equal on every rank whose replica
    is the same bit for bit."""
    import hashlib

    h = hashlib.sha1()
    for k in sorted(state):
        h.update(k.encode())
        h.update(state[k].detach().cpu().contiguous().view(-1).view(
            torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _p20_stage1(torch, dev, dp, agg: str, fsdp: bool = False,
                tp: bool = False, planted: bool = False) -> dict:
    """One step (then P20_TIMED timed ones) of phase 3's VQ-VAE over
    ``dp``'s mesh: data-parallel (``fsdp``: sharded), or with ``tp`` its
    large layers split over the mesh's model axis ((a)); rank 0 holds the
    first step against the one-rank step on the whole batch. ``planted``
    (tp): every TP layer's input skips its backward all-reduce."""
    from movae_tpu_torch.kernels import LAUNCH_COUNTS, reset_launch_counts
    from movae_tpu_torch.models import get_network, init_model
    from movae_tpu_torch.moo import AggregatorConfig, init_state
    from movae_tpu_torch.parallel import mesh, tensor
    from movae_tpu_torch.train.optim import build_optimizer
    from movae_tpu_torch.train.state import TrainState
    from movae_tpu_torch.train.step import make_train_step

    gen = torch.Generator(device=dev).manual_seed(1)
    batches = [torch.rand((BATCH, SIZE, SIZE, 3), generator=gen, device=dev)
               * 2 - 1 for _ in range(2)]

    def build():
        model = init_model(get_network(SIZE, 3, FULL_WIDTH), seed=0,
                           device=dev)
        cfg = AggregatorConfig(name=agg,
                               num_objectives=len(model.objective_names))
        return model, cfg, build_optimizer("sgd", P20_LR,
                                           momentum=P20_MOMENTUM)

    model, cfg, tx = build()
    init = _p20_state(model)
    par = mesh.DataParallel(dp.mesh, fsdp=fsdp)
    with mesh.using(dp.mesh):
        split = tensor.TensorParallel(model) if tp else None
        shards = par.shard_params(model) if fsdp else None
        state = TrainState.create(model, tx, init_state(cfg), fsdp=shards,
                                  tp=split)
        step = make_train_step(model, cfg, parallel=par)
        real = mesh._CopyToAxis.backward
        if planted:
            mesh._CopyToAxis.backward = staticmethod(
                lambda ctx, g: (g, None))
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            reset_launch_counts()
            state, met = step(state, mesh.local_rows(batches[0]))
            counts = dict(LAUNCH_COUNTS)
        finally:
            mesh._CopyToAxis.backward = real
        with state.holder.whole():
            got = _p20_state(model)
        rest = (shards.rest_bytes(state.optimizer) if shards is not None
                else {"params": sum(p.numel() * 4 for p in state.params),
                      "moments": sum(t.numel() * t.element_size()
                                     for st in state.optimizer.state.values()
                                     for t in st.values()
                                     if torch.is_tensor(t)
                                     and t.dim() > 0)})
        times = []
        # (a): one warm step (a TP step takes ~0.6 s on gloo)
        for _ in range(0 if planted else 1 if tp else P20_TIMED):
            x = mesh.local_rows(batches[1])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, _ = step(state, x)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
    res = {"loss": float(met["total_loss"]), "launches": counts,
           "rest_bytes": rest,
           "peak_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30}
    if split is not None:
        res["split"] = split.sharded
        res["digest"] = _p20_digest(torch, got)
    if times:
        res["step_ms"] = statistics.median(times) * 1e3
    if mesh.process_index() == 0:
        ref, rcfg, rtx = build()
        rstate = TrainState.create(ref, rtx, init_state(rcfg))
        rstate, rmet = make_train_step(ref, rcfg)(rstate, batches[0])
        res["ref_loss"] = float(rmet["total_loss"])
        want = _p20_state(ref)
        res["params"] = _p20_close(torch, got, want)
        res["update"] = _p20_update_close(got, want, init)
        del ref, rstate
    del model, state, step, shards, split
    torch.cuda.empty_cache()
    return res


def _p20_prior(torch, dev, dp, dtype: str) -> dict:
    """One data-parallel step of phase 5's PixelSNAIL (L = 4096) on
    PRIOR_BATCH random code grids; rank 0 holds it against the one-rank
    step on the whole batch."""
    from types import SimpleNamespace

    from movae_tpu_torch.kernels import LAUNCH_COUNTS, reset_launch_counts
    from movae_tpu_torch.parallel import mesh
    from movae_tpu_torch.train.prior import build_prior, train_prior

    grid = PRIOR_SIZE // 4
    codes = torch.randint(0, FULL_WIDTH["num_embeddings"],
                          (PRIOR_BATCH, grid, grid), dtype=torch.int32,
                          generator=torch.Generator().manual_seed(4)).numpy()
    args = SimpleNamespace(**PRIOR_ARGS, compute_dtype=dtype,
                           pixelcnn_adam_eps=1e-4)
    meta = SimpleNamespace(num_embeddings=FULL_WIDTH["num_embeddings"],
                           embedding_dim=FULL_WIDTH["embedding_dim"])

    def fresh():
        prior = build_prior(args, meta.num_embeddings, False,
                            meta.embedding_dim)
        prior.reset_parameters(torch.Generator().manual_seed(0))
        return prior

    trace = []
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    out = train_prior({"codes": codes}, meta, args, device=dev,
                      step_trace=trace, prior=fresh(), parallel=dp)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    res = {"ce": trace, "launches": dict(LAUNCH_COUNTS),
           "seconds_with_init": secs}
    if mesh.process_index() == 0:
        got = _p20_state(out["model"])
        ref_trace = []
        ref = train_prior({"codes": codes}, meta, args, device=dev,
                          step_trace=ref_trace, prior=fresh())
        want = _p20_state(ref["model"])
        res["ref_ce"] = ref_trace
        res["params"] = _p20_close(torch, got, want)
        del ref
        if dtype == "bfloat16":
            res["planted"] = _p20_planted(torch, dev, got, want, fresh,
                                          codes, meta, args)
    del out
    torch.cuda.empty_cache()
    return res


def _p20_planted(torch, dev, got: dict, want: dict, fresh, codes, meta,
                 args) -> dict:
    """Controls of the bf16 prior's check (``p20_bf16_close``): the
    2-rank state with its smallest entry that the step moves (a leaf of
    under 1% of the parameters) left at its init, and with that entry
    from a one-rank step on rank 0's rows alone (rows 0, 2, ..: half the
    batch), each held against the one-rank step on the whole batch as
    the real state is. The check must refuse both."""
    from types import SimpleNamespace

    from movae_tpu_torch.train.prior import train_prior

    init = {k: v.to(dev) for k, v in fresh().state_dict().items()}
    moved = [k for k, w in want.items() if w.is_floating_point()
             and w.numel() and not torch.equal(w, init[k])]
    leaf = min(moved, key=lambda k: want[k].numel())
    half = SimpleNamespace(**{**vars(args), "batch_size": PRIOR_BATCH // 2})
    one = train_prior({"codes": codes[0::2]}, meta, half, device=dev,
                      prior=fresh())
    half_leaf = _p20_state(one["model"])[leaf]
    del one
    return {"leaf": leaf, "numel": want[leaf].numel(),
            "share": want[leaf].numel() / sum(w.numel() for w in
                                               want.values()),
            "leaf_unchanged": _p20_close(torch, {**got, leaf: init[leaf]},
                                         want),
            "half_batch": _p20_close(torch, {**got, leaf: half_leaf}, want)}


def _p20_sample(torch, dev, dp) -> dict:
    """sample_fast_snail at 64x64 (float32 cache) from phase 5's
    full-width PixelSNAIL (P20_BLOCKS deep) at random weights, batch
    SAMPLE_BATCH: sharded over the ranks against rank 0's one-rank codes
    on the same seed."""
    from types import SimpleNamespace

    from movae_tpu_torch.models.pixelcnn import sample_fast_snail
    from movae_tpu_torch.parallel import mesh
    from movae_tpu_torch.parallel.context import sample_parallel
    from movae_tpu_torch.train.prior import build_prior

    args = SimpleNamespace(**{**PRIOR_ARGS,
                              "pixelsnail_num_blocks": P20_BLOCKS})
    prior = build_prior(args, FULL_WIDTH["num_embeddings"], False,
                        FULL_WIDTH["embedding_dim"])
    prior.reset_parameters(torch.Generator().manual_seed(0))
    prior = prior.to(dev).eval()
    grid = PRIOR_SIZE // 4

    def sample():
        return sample_fast_snail(
            prior, torch.Generator(device=dev).manual_seed(GEN_SEED),
            SAMPLE_BATCH, grid, grid, cache_dtype=torch.float32)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with sample_parallel(dp.mesh):
        sharded = sample()
    torch.cuda.synchronize()
    res = {"sharded_s": time.perf_counter() - t0}
    if mesh.process_index() == 0:
        t0 = time.perf_counter()
        one = sample()
        torch.cuda.synchronize()
        res["one_rank_s"] = time.perf_counter() - t0
        res["equal_codes"] = float((sharded == one).float().mean())
    del prior
    torch.cuda.empty_cache()
    return res


def _p20_update_close(got: dict, want: dict, init: dict) -> dict:
    """The step's update (parameters after minus before) against the
    one-rank step's, leaf by leaf, as a part of the largest update of the
    leaf: unlike the parameters it shows a fault in a gradient that the
    learning rate makes small beside the weights. (a) passes within
    FLASH_PLAIN_FACTOR times the data-parallel step's own distance (the
    rounding of a 2-rank split of the same step) or FLASH_GRAD_TOL,
    whichever is larger."""
    worst, at = 0.0, None
    for k, w in want.items():
        if not w.is_floating_point():
            continue
        u_want = (w - init[k]).double()
        scale = float(u_want.abs().max())
        if scale == 0.0:
            continue
        err = float(((got[k] - init[k]).double() - u_want).abs().max())
        if err / scale > worst:
            worst, at = err / scale, k
    return {"worst": worst, "at": at}


_P20_REFS: dict = {}


class _LoseFirstCE:
    """A stand-in for ``torch.nn.functional`` in ``parallel/pipeline.py``
    whose first cross-entropy comes back as zero (the planted fault of
    path (b): one microbatch's CE lost)."""

    def __init__(self, F):
        self.F, self.calls = F, 0

    def __getattr__(self, name):
        return getattr(self.F, name)

    def cross_entropy(self, *a, **kw):
        self.calls += 1
        ce = self.F.cross_entropy(*a, **kw)
        return ce * 0.0 if self.calls == 1 else ce


def _p20_prior_setup(torch, dev):
    """Phase 5's float32 PixelSNAIL at dropout 0 and PRIOR_BATCH random
    code grids: (codes, args, meta, fresh)."""
    from types import SimpleNamespace

    from movae_tpu_torch.train.prior import build_prior

    grid = PRIOR_SIZE // 4
    codes = torch.randint(0, FULL_WIDTH["num_embeddings"],
                          (PRIOR_BATCH, grid, grid), dtype=torch.int32,
                          generator=torch.Generator().manual_seed(4)).numpy()
    args = SimpleNamespace(**{**PRIOR_ARGS, "pixelsnail_dropout": 0.0,
                              "pixelcnn_adam_eps": 1e-4,
                              "pixelsnail_num_blocks": P20_BLOCKS})
    meta = SimpleNamespace(num_embeddings=FULL_WIDTH["num_embeddings"],
                           embedding_dim=FULL_WIDTH["embedding_dim"])

    def fresh():
        prior = build_prior(args, meta.num_embeddings, False,
                            meta.embedding_dim)
        prior.reset_parameters(torch.Generator().manual_seed(0))
        return prior.to(dev)

    return codes, args, meta, fresh


def _p20_mesh(torch, dev, axis: str):
    from movae_tpu_torch.parallel import mesh

    sizes = {"pipe": dict(num_pipe=P20_WORLD), "seq": dict(num_seq=P20_WORLD)}
    return mesh.make_mesh(device=dev, **sizes[axis])


class _Recorded:
    """A stand-in for ``parallel/holder.py:Holder.slice_grads`` (the step's
    gradients, their data mean taken, before the clip and the optimizer)
    on the holders that do not override it (the pipeline's and the
    one-rank trainer's). Recording (``feed`` None): keeps each step's
    gradients by leaf name, and the time at each call once the card is
    idle, so ``stamps[1] - stamps[0]`` is one warm step (the first step's
    update, then the second step's forward and backward). Feeding: hands
    the trainer the gradients of ``feed``, step by step, in place of its
    own."""

    def __init__(self, torch, prior, feed=None):
        self.torch, self.feed = torch, feed
        self.names = {id(p): n for n, p in prior.named_parameters()}
        self.steps, self.stamps = [], []

    def __call__(self, holder, grads):
        if self.feed is not None:
            step = self.feed[len(self.steps)]
            self.steps.append(None)
            return [step[self.names[id(p)]].to(g.device, g.dtype)
                    for p, g in zip(holder.params, grads)]
        self.torch.cuda.synchronize()
        self.stamps.append(time.perf_counter())
        self.steps.append({self.names[id(p)]: g.detach().cpu().clone()
                           for p, g in zip(holder.params, grads)})
        return list(grads)


def _p20_train(torch, dev, prior, codes, args, meta, par, rec) -> tuple:
    """train_prior on ``codes`` with ``rec`` in place of the holders'
    ``slice_grads``: (CE trace, its state after the last step)."""
    from movae_tpu_torch.parallel import holder
    from movae_tpu_torch.train.prior import train_prior

    real = holder.Holder.slice_grads
    holder.Holder.slice_grads = lambda self, grads: rec(self, grads)
    try:
        trace = []
        out = train_prior({"codes": codes}, meta, args, device=dev,
                          step_trace=trace, prior=prior, parallel=par)
    finally:
        holder.Holder.slice_grads = real
    return trace, _p20_state(out["model"])


def _p20_axis_prior(torch, dev, axis: str, planted: bool = False) -> dict:
    """(b) ``axis`` "pipe", (c) "seq": P20_STEPS train_prior steps of the
    prior of ``_p20_prior_setup`` with that axis over the ranks, the
    launches counted, each step's gradients recorded (``_Recorded``) and
    a warm step timed. Rank 0 then runs the one-rank trainer fed those
    gradients: its first CE is the one-rank step's on the whole batch,
    and the path's CE trace and parameters after the steps are held
    against it at test_parallel's bounds (``_p20_close``), so the clip and
    the optimizer the axis runs (the pipeline's: its stage's leaves, the
    norm summed over ``pipe``) are held to one device's on the same
    gradients. ``planted`` (pipe): each stage clips by its own norm."""
    import numpy as np

    from movae_tpu_torch.kernels import LAUNCH_COUNTS, reset_launch_counts
    from movae_tpu_torch.parallel import mesh

    codes, args, meta, fresh = _p20_prior_setup(torch, dev)
    codes = np.concatenate([codes] * P20_STEPS)
    par = mesh.DataParallel(_p20_mesh(torch, dev, axis))
    prior = fresh()
    rec = _Recorded(torch, prior)
    real = mesh.clip_by_global_norm
    if planted:
        mesh.clip_by_global_norm = lambda grads, axes, max_norm: real(
            grads, [()] * len(axes), max_norm)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_launch_counts()
        trace, got = _p20_train(torch, dev, prior, codes, args, meta, par,
                                rec)
        torch.cuda.synchronize()
    finally:
        mesh.clip_by_global_norm = real
    res = {"ce": trace, "launches": dict(LAUNCH_COUNTS),
           "step_ms": (rec.stamps[1] - rec.stamps[0]) * 1e3,
           "digest": _p20_digest(torch, got),
           "peak_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30}
    # the stages' gradients, whole on rank 0 (the replicated leaves are
    # equal on every stage)
    parts = [None] * P20_WORLD
    torch.distributed.all_gather_object(parts, rec.steps)
    if mesh.process_index() == 0:
        feed = [{} for _ in range(P20_STEPS)]
        for part in parts[::-1]:  # rank 0's where leaves are shared
            for whole, step in zip(feed, part):
                whole.update(step)
        ref = fresh()
        res["ref_ce"], want = _p20_train(
            torch, dev, ref, codes, args, meta, None,
            _Recorded(torch, ref, feed))
        res["params"] = _p20_close(torch, got, want)
        del ref
    del prior, rec, parts
    torch.cuda.empty_cache()
    return res


_P20_LOGITS: list = []


def _f64_attention(q, k, v, sm_scale):
    """Causal attention in float64, one batch row at a time (recomputed in
    the backward), cast back to float32: the gradient reference of
    ``_p20_axis_grads``. Appends the largest |logit| of the call (over
    every row and head) to ``_P20_LOGITS``."""
    import torch
    from torch.utils.checkpoint import checkpoint

    from movae_tpu_torch.kernels.flash_attention import \
        dense_causal_attention

    with torch.no_grad():
        _P20_LOGITS.append(max(
            float((q[b].double() @ k[b].double().transpose(-1, -2))
                  .abs().max()) * sm_scale for b in range(q.shape[0])))

    def one(qq, kk, vv):
        return dense_causal_attention(qq.double(), kk.double(), vv.double(),
                                      sm_scale).float()

    return torch.cat([checkpoint(one, q[b:b + 1], k[b:b + 1], v[b:b + 1],
                                 use_reentrant=False)
                      for b in range(q.shape[0])])


def _p20_prior_grads(torch, prior, codes) -> tuple:
    """(loss, {leaf: float64 CPU gradient}) of one rank's whole batch."""
    params = list(prior.parameters())
    loss = prior.loss_function(codes, train=True)["total_loss"]
    grads = torch.autograd.grad(loss, params)
    return float(loss.detach()), {
        n: g.detach().double().cpu()
        for (n, _), g in zip(prior.named_parameters(), grads)}


def p20_grad_close(got: dict, flash: dict, f64: dict) -> dict:
    """The gradients of a path held as 17a holds the flash kernels on a
    trained prior's q, k, v: each leaf's largest distance from the
    float64-attention gradient within FLASH_PLAIN_FACTOR times the
    one-rank float32 path's distance, or within FLASH_GRAD_TOL of its
    block's largest gradient, whichever is larger (a key bias's true
    gradient is 0: softmax ignores a constant logit). ``worst`` <= 1
    passes."""
    scale: dict = {}
    for n, g in f64.items():
        block = ".".join(n.split(".")[:2]) if n.startswith("blocks.") \
            else n.split(".")[0]
        scale[block] = max(scale.get(block, 0.0), float(g.abs().max()))
    worst, at, ratio = 0.0, None, 0.0
    for n, g in f64.items():
        block = ".".join(n.split(".")[:2]) if n.startswith("blocks.") \
            else n.split(".")[0]
        d_path = float((got[n] - g).abs().max())
        d_flash = float((flash[n] - g).abs().max())
        bound = max(FLASH_PLAIN_FACTOR * d_flash,
                    FLASH_GRAD_TOL * scale[block])
        if d_path / bound > worst:
            worst, at = d_path / bound, n
        ratio = max(ratio, d_path / max(d_flash, 1e-30))
    return {"worst": worst, "at": at, "max_ratio_to_flash": ratio}


def _p20_axis_grads(torch, dev, axis: str, planted: bool = False) -> dict:
    """(b) and (c)'s gradients: the prior's gradient on the whole batch
    with ``axis`` over the ranks (the pipeline's stages gathered), rank 0
    holding it by ``p20_grad_close`` against the one-rank float32 path and
    the float64-attention reference (computed once). ``planted`` (pipe):
    the pipeline loses one microbatch's CE."""
    from movae_tpu_torch.models import pixelcnn as pc
    from movae_tpu_torch.parallel import mesh, pipeline
    from movae_tpu_torch.parallel.context import context_parallel

    codes, _, _, fresh = _p20_prior_setup(torch, dev)
    codes = torch.from_numpy(codes).to(dev)
    msh = _p20_mesh(torch, dev, axis)
    par = mesh.DataParallel(msh)
    prior = fresh()
    if axis == "pipe":
        names = {id(p): n for n, p in prior.named_parameters()}
        real = pipeline.F
        if planted:
            pipeline.F = _LoseFirstCE(real)
        try:
            with par.activate():
                pipe = pipeline.PipelinedPrior(prior, P20_PP_M)
                loss, grads = pipe.loss_and_grads([codes])
        finally:
            pipeline.F = real
        parts = [None] * P20_WORLD
        torch.distributed.all_gather_object(parts, {
            names[id(p)]: g.detach().double().cpu()
            for p, g in zip(pipe.params, grads)})
        got = {}
        for part in parts:
            got.update(part)
        loss = float(loss)
    else:
        with par.activate(), context_parallel():
            loss, got = _p20_prior_grads(torch, prior, codes)
    res = {"loss": loss}
    if mesh.process_index() == 0:
        if "grads" not in _P20_REFS:
            flash = _p20_prior_grads(torch, fresh(), codes)
            real = pc.causal_attention
            pc.causal_attention = _f64_attention
            _P20_LOGITS.clear()
            try:
                f64 = _p20_prior_grads(torch, fresh(), codes)
            finally:
                pc.causal_attention = real
            _P20_REFS["grads"] = (flash, f64)
            res["logit_max"] = list(_P20_LOGITS)
        (res["ref_loss"], flash), (res["f64_loss"], f64) = _P20_REFS["grads"]
        res["grads"] = p20_grad_close(got, flash, f64)
        res["flash_vs_f64"] = max(
            float((flash[n] - g).abs().max() / g.abs().max().clamp_min(
                1e-30)) for n, g in f64.items() if "k_proj.bias" not in n)
    del prior
    torch.cuda.empty_cache()
    return res


def _p20_ring(torch, dev) -> dict:
    """(c): the ring alone over the ranks on FLASH_SLICE's q, k, v,
    forward and backward, against the plain ring (its diagonal blocks
    through the kernels' plain version) in the same call; its launches,
    its ms and the plain ring's, and the planted fault (the last rotation
    dropped) held to the same gate."""
    from movae_tpu_torch.kernels import LAUNCH_COUNTS, reset_launch_counts
    from movae_tpu_torch.ops import ring_attention as ra
    from movae_tpu_torch.parallel import mesh

    msh = mesh.make_mesh(num_seq=P20_WORLD, device=dev)
    b, h, L, d = FLASH_SLICE
    gen = torch.Generator(device=dev).manual_seed(5)
    q, k, v, do = (torch.randn((b, h, L, d), generator=gen, device=dev)
                   for _ in range(4))
    sm = 1.0 / math.sqrt(d)

    def run():
        ts = [t.clone().requires_grad_(True) for t in (q, k, v)]
        with mesh.using(msh):
            o = ra.ring_causal_attention(*ts, sm)
            o.backward(do)
        return o.detach(), [t.grad for t in ts]

    def timed(reps=3):
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return statistics.median(times) * 1e3

    torch.cuda.synchronize()
    reset_launch_counts()
    o, g = run()
    torch.cuda.synchronize()
    counts = {n: LAUNCH_COUNTS[n] for n in FLASH_KERNELS}
    ms = timed()
    real = (ra._tril_fwd, ra._tril_bwd, ra._rotations)

    def err(o2, g2):
        return (float((o - o2).abs().max() / o2.abs().max()),
                max(float((a - b_).abs().max() / b_.abs().max())
                    for a, b_ in zip(g, g2)))

    try:
        ra._tril_fwd = lambda q_, k_, v_, s: ra.plain_block_fwd(
            q_, k_, v_, s, True)
        ra._tril_bwd = lambda q_, k_, v_, do_, l_, di_, s: \
            ra.plain_block_bwd(q_, k_, v_, do_, l_, di_, s, True)
        op, gp = run()
        plain_ms = timed()
        o_err, g_err = err(op, gp)
        ra._tril_fwd, ra._tril_bwd = real[:2]
        ra._rotations = lambda S: range(1, S - 1)
        of, gf = run()
        planted = (float((of - op).abs().max() / op.abs().max()),
                   max(float((a - b_).abs().max() / b_.abs().max())
                       for a, b_ in zip(gf, gp)))
    finally:
        ra._tril_fwd, ra._tril_bwd, ra._rotations = real
    del q, k, v, do, o, g
    torch.cuda.empty_cache()
    return {"launches": counts, "ms": ms, "plain_ms": plain_ms,
            "o_err": o_err, "grad_err": g_err, "planted": planted}


def _phase20_worker(rank: int, world: int, store: str, root: str,
                    out: str) -> None:
    """One rank of phase 20 (spawned): the card, gloo, every part; rank 0
    writes every rank's results to ``out``."""
    sys.path.insert(0, root)
    import torch

    from movae_tpu_torch.device import resolve_device
    from movae_tpu_torch.parallel import mesh

    dev = resolve_device("cuda")
    mesh.init_distributed("cuda", backend_name="gloo",
                          init_method=f"file://{store}", rank=rank,
                          world_size=world)
    dp = mesh.DataParallel(mesh.make_mesh(device=dev))
    res = {"rank": rank, "backend": mesh.backend(), "device": str(dev),
           "card": torch.cuda.get_device_name(dev)}
    res["part_s"] = {}

    def run(key, part):
        t2 = time.perf_counter()
        res[key] = part()
        res["part_s"][key] = time.perf_counter() - t2

    t0 = time.perf_counter()
    for agg, fsdp in (("sum", False), ("upgrad", False), ("sum", True),
                      ("upgrad", True)):
        run(f"stage1_{agg}{'_fsdp' if fsdp else ''}",
            lambda: _p20_stage1(torch, dev, dp, agg, fsdp))
    for dtype in ("float32", "bfloat16"):
        run(f"prior_{dtype}", lambda: _p20_prior(torch, dev, dp, dtype))
    run("sample_fast_snail", lambda: _p20_sample(torch, dev, dp))
    res["seconds_data"] = time.perf_counter() - t0
    # the model, pipe and seq axes, after the data axis's paths, each
    # part's seconds kept
    t1 = time.perf_counter()
    tp = mesh.DataParallel(mesh.make_mesh(num_model=P20_WORLD, device=dev))
    pp, cp = "pipe", "seq"
    parts = {
        "tp_sum": lambda: _p20_stage1(torch, dev, tp, "sum", tp=True),
        "tp_upgrad": lambda: _p20_stage1(torch, dev, tp, "upgrad", tp=True),
        "tp_planted": lambda: _p20_stage1(torch, dev, tp, "sum", tp=True,
                                          planted=True),
        "pp_prior": lambda: _p20_axis_prior(torch, dev, pp),
        "pp_clip_planted": lambda: _p20_axis_prior(torch, dev, pp,
                                                   planted=True),
        "pp_grads": lambda: _p20_axis_grads(torch, dev, pp),
        "pp_planted": lambda: _p20_axis_grads(torch, dev, pp, planted=True),
        "cp_prior": lambda: _p20_axis_prior(torch, dev, cp),
        "cp_grads": lambda: _p20_axis_grads(torch, dev, cp),
        "ring": lambda: _p20_ring(torch, dev)}
    for key, part in parts.items():
        run(key, part)
    res["seconds_axes"] = time.perf_counter() - t1
    res["seconds"] = time.perf_counter() - t0
    every = [None] * world
    torch.distributed.all_gather_object(every, res)
    if rank == 0:
        with open(out, "w") as f:
            json.dump(every, f)
    torch.distributed.destroy_process_group()


def phase_multirank(torch, card: str) -> dict:
    """20: P20_WORLD ranks on the one card over gloo (``_phase20_worker``):
    each data-parallel step equal to the one-rank step on the whole batch,
    fsdp's bytes at rest below DDP's, sample-parallel codes equal to one
    rank's, and every rank's nearest-code and flash kernels on every
    step; then the model, pipe and seq axes (P20_PP_M's comment), each
    with its planted fault refused, their per-rank step times and peak
    memory printed beside the card."""
    import torch.multiprocessing as mp

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="movae_p20_")
    out = os.path.join(tmp, "ranks.json")
    root = os.path.dirname(os.path.abspath(__file__))
    try:
        mp.spawn(_phase20_worker, args=(P20_WORLD, os.path.join(tmp, "store"),
                                        root, out),
                 nprocs=P20_WORLD, join=True)
        with open(out) as f:
            ranks = json.load(f)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"phase 20 ranks: " + ", ".join(
        f"rank {r['rank']} on {r['device']} ({r['card']}), backend "
        f"{r['backend']}" for r in ranks))
    res = {"ranks": ranks, "seconds": time.perf_counter() - t_phase}
    log(f"phase 20 ({P20_WORLD} ranks on one card, gloo; {card}): "
        f"{res['seconds']:.1f} s: {json.dumps(ranks)}")
    for r in ranks:
        log(f"phase 20 axes, rank {r['rank']} ({card}): "
            f"tp sum {r['tp_sum']['step_ms']:.3f} ms/step "
            f"peak {r['tp_sum']['peak_gib']:.2f} GiB, tp upgrad "
            f"{r['tp_upgrad']['step_ms']:.3f} ms/step peak "
            f"{r['tp_upgrad']['peak_gib']:.2f} GiB; pp prior "
            f"{r['pp_prior']['step_ms']:.3f} ms/step, peak "
            f"{r['pp_prior']['peak_gib']:.2f} GiB; cp prior "
            f"{r['cp_prior']['step_ms']:.3f} ms/step, peak "
            f"{r['cp_prior']['peak_gib']:.2f} GiB; ring fwd+bwd "
            f"{r['ring']['ms']:.3f} ms (plain ring "
            f"{r['ring']['plain_ms']:.3f}); data paths "
            f"{r['seconds_data']:.1f} s, axes {r['seconds_axes']:.1f} s "
            f"(" + ", ".join(f"{k} {v:.1f}"
                             for k, v in r['part_s'].items()) + ")")
    check_multirank(ranks)
    return res


def check_multirank(ranks: list) -> None:
    """Phase 20's checks over every rank's results."""
    lead = ranks[0]
    layers = PRIOR_ARGS["pixelsnail_num_blocks"]
    for r in ranks:
        for key in ("stage1_sum", "stage1_upgrad", "stage1_sum_fsdp",
                    "stage1_upgrad_fsdp"):
            check(r[key]["launches"]["nearest_code"] == 1,
                  f"20 {key} rank {r['rank']}: nearest_code launched "
                  f"{r[key]['launches']['nearest_code']} times in one step")
        for dtype in ("float32", "bfloat16"):
            n = r[f"prior_{dtype}"]["launches"]
            for name in FLASH_KERNELS:
                check(n[name] == layers,
                      f"20 prior {dtype} rank {r['rank']}: {name} "
                      f"launched {n[name]} times in one step of {layers} "
                      f"layers")
    for key in ("stage1_sum", "stage1_upgrad", "stage1_sum_fsdp",
                "stage1_upgrad_fsdp"):
        r = lead[key]
        check(abs(r["loss"] - r["ref_loss"]) <= P20_LOSS_RTOL
              * abs(r["ref_loss"]) and r["params"]["worst"] <= 1.0,
              f"20 {key}: 2 ranks against one on the whole batch: loss "
              f"{r['loss']} vs {r['ref_loss']}, parameters {r['params']} "
              f"(rtol {P20_PARAM_RTOL}, atol {P20_PARAM_ATOL})")
    for agg in ("sum", "upgrad"):
        ddp, fs = lead[f"stage1_{agg}"], lead[f"stage1_{agg}_fsdp"]
        check(fs["rest_bytes"]["params"] + fs["rest_bytes"]["moments"]
              < ddp["rest_bytes"]["params"] + ddp["rest_bytes"]["moments"],
              f"20 fsdp {agg}: bytes at rest {fs['rest_bytes']} not below "
              f"DDP's {ddp['rest_bytes']}")
    for dtype in ("float32", "bfloat16"):
        r = lead[f"prior_{dtype}"]
        p = r["params"]
        params_ok = (p["worst"] <= 1.0 if dtype == "float32" else
                     p20_bf16_close(p))
        check(len(r["ce"]) == len(r["ref_ce"]) == 1
              and abs(r["ce"][0] - r["ref_ce"][0]) <= P20_LOSS_RTOL
              * abs(r["ref_ce"][0]) and params_ok,
              f"20 prior {dtype}: 2 ranks against one on the whole batch: "
              f"CE {r['ce']} vs {r['ref_ce']}, parameters {p}")
    planted = lead["prior_bfloat16"]["planted"]
    for fault in ("leaf_unchanged", "half_batch"):
        check(not p20_bf16_close(planted[fault]),
              f"20 prior bfloat16: the check passes a planted fault "
              f"({fault} at {planted['leaf']}, {planted['numel']} "
              f"elements): {planted[fault]}")
    check(lead["sample_fast_snail"]["equal_codes"] == 1.0,
          f"20 sample-parallel sample_fast_snail: "
          f"{lead['sample_fast_snail']['equal_codes']:.4f} of the codes "
          f"equal one rank's")
    check_axes(ranks)


def _p20_step_close(r: dict, control: float) -> bool:
    """(a): the data axis's bounds, and the update within
    FLASH_PLAIN_FACTOR times ``control`` (the data-parallel step's update
    distance) or FLASH_GRAD_TOL, whichever is larger."""
    return (abs(r["loss"] - r["ref_loss"]) <= P20_LOSS_RTOL
            * abs(r["ref_loss"]) and r["params"]["worst"] <= 1.0
            and r["update"]["worst"] <= max(FLASH_GRAD_TOL,
                                            FLASH_PLAIN_FACTOR * control))


def _p20_step_ok(r: dict) -> bool:
    """(b), (c): every step's CE at P20_LOSS_RTOL and the parameters
    after the steps at test_parallel's bounds, against the one-rank
    trainer fed the path's gradients."""
    return (len(r["ce"]) == len(r["ref_ce"]) == P20_STEPS
            and all(abs(a - b) <= P20_LOSS_RTOL * abs(b)
                    for a, b in zip(r["ce"], r["ref_ce"]))
            and r["params"]["worst"] <= 1.0)


def _p20_grads_close(r: dict) -> bool:
    return (abs(r["loss"] - r["ref_loss"]) <= P20_LOSS_RTOL
            * abs(r["ref_loss"]) and r["grads"]["worst"] <= 1.0)


def check_axes(ranks: list) -> None:
    """Phase 20's model, pipe and seq paths (see P20_PP_M's comment)."""
    lead = ranks[0]
    blocks = P20_BLOCKS
    local = blocks // P20_WORLD
    # (b): each stage's blocks on each microbatch, the forward again in
    # the recompute; (c): the zigzag ring's two diagonal blocks per layer;
    # the ring alone: one layer; P20_STEPS steps of (b) and (c)
    want_pp = {"flash_attention_fwd": 2 * local * P20_PP_M * P20_STEPS,
               "flash_attention_bwd_dkv": local * P20_PP_M * P20_STEPS,
               "flash_attention_bwd_dq": local * P20_PP_M * P20_STEPS}
    want_cp = dict.fromkeys(FLASH_KERNELS, 2 * blocks * P20_STEPS)
    want_ring = dict.fromkeys(FLASH_KERNELS, 2)
    for r in ranks:
        for key in ("tp_sum", "tp_upgrad"):
            check(r[key]["launches"]["nearest_code"] == 1
                  and r[key]["split"] > 0,
                  f"20 {key} rank {r['rank']}: nearest_code launched "
                  f"{r[key]['launches']['nearest_code']} times in one "
                  f"step, {r[key]['split']} leaves split")
        for key, want in (("pp_prior", want_pp), ("cp_prior", want_cp)):
            got = {n: r[key]["launches"][n] for n in FLASH_KERNELS}
            check(got == want, f"20 {key} rank {r['rank']}: flash "
                  f"launches {got}, want {want}")
        got = r["ring"]["launches"]
        check(got == want_ring, f"20 ring rank {r['rank']}: flash launches "
              f"{got}, want {want_ring}")
        ring = r["ring"]
        check(ring["o_err"] <= FLASH_O_TOL
              and ring["grad_err"] <= FLASH_GRAD_TOL,
              f"20 ring rank {r['rank']}: against the plain ring, output "
              f"{ring['o_err']:.3g} (limit {FLASH_O_TOL}), gradients "
              f"{ring['grad_err']:.3g} (limit {FLASH_GRAD_TOL})")
        check(ring["planted"][0] > FLASH_O_TOL,
              f"20 ring rank {r['rank']}: the ring without its last "
              f"rotation passes the gate: {ring['planted']}")
    for key in ("tp_sum", "tp_upgrad", "pp_prior", "cp_prior"):
        off = [r["rank"] for r in ranks
               if r[key]["digest"] != lead[key]["digest"]]
        check(not off, f"20 {key}: the whole model after the steps on "
              f"ranks {off} is not rank 0's")
    control = max(lead[f"stage1_{agg}"]["update"]["worst"]
                  for agg in ("sum", "upgrad"))
    for key in ("tp_sum", "tp_upgrad"):
        check(_p20_step_close(lead[key], control),
              f"20 {key}: model_partitions={P20_WORLD} against one rank: "
              f"loss {lead[key]['loss']} vs {lead[key]['ref_loss']}, "
              f"parameters {lead[key]['params']}, update "
              f"{lead[key]['update']} (data-parallel control {control})")
    check(not _p20_step_close(lead["tp_planted"], control),
          f"20 tp: the check passes a TP layer that skips its input's "
          f"backward all-reduce: {lead['tp_planted']['params']}, update "
          f"{lead['tp_planted']['update']}")
    for key in ("pp", "cp"):
        r, g = lead[f"{key}_prior"], lead[f"{key}_grads"]
        check(_p20_step_ok(r),
              f"20 {key} prior steps: {P20_WORLD} ranks against one fed "
              f"their gradients: CE {r['ce']} vs {r['ref_ce']}, "
              f"parameters {r['params']} (rtol {P20_PARAM_RTOL}, atol "
              f"{P20_PARAM_ATOL})")
        check(_p20_grads_close(g),
              f"20 {key} gradients: loss {g['loss']} vs {g['ref_loss']}, "
              f"against float64 attention {g['grads']} (the one-rank "
              f"float32 path {g['flash_vs_f64']:.3g} of a leaf's largest)")
    planted = lead["pp_clip_planted"]
    check(not _p20_step_ok(planted),
          f"20 pp: the check passes a pipeline whose stages clip by their "
          f"own norms: CE {planted['ce']} vs {planted['ref_ce']}, "
          f"parameters {planted['params']}")
    planted = lead["pp_planted"]
    check(not _p20_grads_close(planted),
          f"20 pp: the check passes a pipeline that loses one "
          f"microbatch's CE: loss {planted['loss']} vs "
          f"{planted['ref_loss']}, {planted['grads']}")


def probe_dkv(torch, fa, dev, parent: Optional[str],
              seeds: Sequence[int] = (0,), inputs: Optional[str] = None,
              save: Optional[str] = None) -> None:
    """17b trained twice in one process, unprofiled then profiled, and each
    trained prior's q/k/v through 17a's comparison (``compare_flash_bf16``)
    on every build: whether each output passes 17a's gate against the
    plain version (``bf16_agrees``) and against float64 (``bf16_as_close``),
    printed, not raised. With ``parent`` (another checkout's root) its
    ``flash_attention.cu`` is built too, and the priors train through that
    build's kernels: the inputs on which the parent's dk was measured, held
    against this checkout's build on the same q/k/v/do. ``seeds``: the
    prior's init seeds to train through (each twice), until a prior
    fails this build; where any build fails dk, the dk attribution is
    printed, and where this one does, its failing (batch, head) slices;
    the inputs and the worst failing slice are saved in the directory
    ``save`` where one is given. ``inputs``: a file of q, k, v, do (as saved there) held
    on every build in place of the training."""
    from pathlib import Path

    from movae_tpu_torch.kernels import flash_ab

    own = fa._library
    builds = {"this": own}
    if parent is not None:
        d = FLASH_SLICE[-1]
        lib = flash_ab.compile_libs({"parent": Path(parent) / "movae_tpu_torch"
                                     / "kernels" / "flash_attention.cu"},
                                    d)["parent"]

        def parent_library(dd: int, lib=lib, d=d):
            check(dd == d, f"probe: the parent's build is for D = {d}, "
                  f"asked for {dd}")
            return lib

        builds["parent"] = parent_library
    trainer = builds["parent" if parent is not None else "this"]
    failed = []

    def hold(q, k, v, do, label):
        failing = []
        for name, library in builds.items():
            fa._library = library
            try:
                res = compare_flash_bf16(torch, fa, q, k, v, do)
            finally:
                fa._library = trainer
            verdict = {key: {"plain": bf16_agrees(r["plain"]),
                             "f64": bf16_as_close(r["f64"],
                                                  r["plain_vs_f64"])}
                       for key, r in res.items()}
            passed = all(v for r in verdict.values() for v in r.values())
            log(f"probe 17a {label}, {name}'s build: "
                f"{'passed' if passed else 'failed'} {json.dumps(verdict)}; "
                f"scale from float64 (u): " + json.dumps(
                    {key: [r["f64"]["scale"], r["plain_vs_f64"]["scale"]]
                     for key, r in res.items()}) + f"; {json.dumps(res)}")
            if not verdict["dk"]["f64"]:
                failing.append(name)
        if not failing:
            return
        # a failing dk: which tensor-core sum moves it (of the plain
        # version, whichever build failed); where this build fails, which
        # (batch, head) slices still fail alone (fixture candidates)
        if save:
            os.makedirs(save, exist_ok=True)
            torch.save({"q": q.cpu(), "k": k.cpu(), "v": v.cpu(),
                        "do": do.cpu(), "label": label},
                       os.path.join(save, "dkv_failing_prior.pt"))
        log(f"probe dk attribution {label} ({', '.join(failing)}'s build "
            f"failed; scale from float64, u): "
            + json.dumps(dk_attribution(torch, fa, q, k, v, do)))
        if "this" not in failing:
            return
        failed.append(label)
        rows = dk_failing_slices(torch, fa, q, k, v, do)
        bad = [r for r in rows if not r[4]]
        log(f"probe dk slices {label}: {len(bad)} of {len(rows)} "
            f"(batch, head) slices fail the float64 half alone; worst "
            f"first: {json.dumps(rows[:12])}")
        if bad and save:
            b, h = bad[0][:2]
            sl = [t[b:b + 1, h:h + 1].contiguous() for t in (q, k, v, do)]
            scale = q.shape[-1] ** -0.5
            o, lse2 = fa.flash_fwd(*sl[:3], scale)
            di = (o.float() * sl[3].float()).sum(-1)
            dk = fa.flash_bwd_dkv(*sl, lse2, di, scale)[0]
            path = os.path.join(save, f"dkv_fixture_b{b}_h{h}.pt")
            torch.save({"q": sl[0].cpu(), "k": sl[1].cpu(),
                        "v": sl[2].cpu(), "do": sl[3].cpu(),
                        "kernel_dk": dk.cpu(), "batch": b, "head": h,
                        "label": label}, path)
            log(f"probe dk fixture written: {path}")

    if inputs is not None:
        saved = torch.load(inputs, weights_only=False)
        try:
            hold(*(saved[n].to(dev) for n in ("q", "k", "v", "do")),
                 f"{saved.get('label', inputs)} (saved)")
        finally:
            fa._library = own
        return
    ones = dict.fromkeys(("step_ms", "codes_per_sec", "peak_mem_gib"), 1.0)
    seed0 = PRIOR_ARGS["seed"]
    try:
        for seed in seeds:
            PRIOR_ARGS["seed"] = seed
            for profile in (False, True):
                fa._library = trainer
                phase_prior_bf16(torch, fa, dev, ones, [], profile=profile,
                                 hold=lambda *a, p=profile: hold(
                                     *a[:4], f"{a[4]}, trained through "
                                     f"{'the parent' if parent else 'this'} "
                                     f"build (seed {seed}, profile {p})"))
                torch.cuda.empty_cache()
            if failed:
                break
    finally:
        fa._library = own
        PRIOR_ARGS["seed"] = seed0


def float64_grads(torch, fa, q, k, v, do) -> tuple:
    """(o, dq, dk, dv) in float64 from the bf16 inputs, by the dense
    causal softmax, two batch rows at a time."""
    scale = q.shape[-1] ** -0.5
    parts = []
    for i in range(0, q.shape[0], 2):
        leaves = [t[i:i + 2].double().requires_grad_() for t in (q, k, v)]
        out = fa.dense_causal_attention(*leaves, scale)
        parts.append([out.detach(), *torch.autograd.grad(
            out, leaves, do[i:i + 2].double())])
        del leaves, out
        torch.cuda.empty_cache()
    return tuple(torch.cat(p) for p in zip(*parts))


# the products of the plain bf16 version that feed dk, for its
# attribution: the logits q k^T and p v (the forward's o, through di), dp =
# do v^T and dk = ds^T q; dv = p^T do and dq = ds k do not feed dk
DK_PRODUCTS = ("logits", "pv", "dp", "dk")


def plain_dk_summed(torch, fa, q, k, v, do, on=()):
    """dk of the plain bf16 version end to end (``fa.plain_fwd_bf16``'s o
    and lse2 feeding ``fa.plain_bwd_bf16``'s arithmetic) with the products
    of DK_PRODUCTS named in ``on`` summed on the tensor cores (``fa._mm``:
    the logits too, as the kernels summed them before their fma chain) and
    the rest in IEEE float32."""
    unknown = set(on) - set(DK_PRODUCTS)
    if unknown:
        raise ValueError(f"unknown products {sorted(unknown)}; known: "
                         f"{DK_PRODUCTS}")
    scale = q.shape[-1] ** -0.5
    c = fa.log2e_scale(scale)
    L = q.shape[2]
    mask = torch.ones((L, L), dtype=torch.bool, device=q.device).tril()
    dk = torch.empty_like(k)
    for i in range(0, q.shape[0], fa._PLAIN_CHUNK):
        sl = slice(i, i + fa._PLAIN_CHUNK)
        s = fa._mm(q[sl], k[sl].transpose(-1, -2), "logits" in on
                   ).masked_fill(~mask, float("-inf"))
        m2 = s.amax(-1, keepdim=True) * c
        p = fa.plain_p_bf16(s, c, m2)
        denom = p.sum(-1, keepdim=True)
        o = (fa._mm(fa._bf(p), v[sl], "pv" in on) / denom).to(q.dtype)
        p = fa.plain_p_bf16(s, c, m2 + torch.log2(denom))
        del s
        dof = do[sl].float()
        di = (o.float() * dof).sum(-1, keepdim=True)
        ds = fa.plain_ds_bf16(p, fa._mm(dof, v[sl].transpose(-1, -2),
                                        "dp" in on), di, scale)
        del p
        dk[sl] = fa._mm(ds.transpose(-1, -2), q[sl], "dk" in on
                        ).to(dk.dtype)
        del ds
    return dk


def dk_attribution(torch, fa, q, k, v, do) -> dict:
    """dk's best-fit scale from float64 (u = 2^-8, ``bf16_agreement``) for
    the plain bf16 version end to end with every product in IEEE float32
    (``none``), every product of DK_PRODUCTS on the tensor cores (``all``,
    the sums of the kernels before their fma-chain logits), each product
    alone on the tensor cores (``tc:<name>``) and each alone in IEEE
    (``ieee:<name>``) (``plain_dk_summed``), and as the kernels sum now
    (``kernels``: ``tensor_cores=True``, the logits as an fma chain)."""
    scale = q.shape[-1] ** -0.5
    f64_dk = float64_grads(torch, fa, q, k, v, do)[2]
    o, lse2 = fa.plain_fwd_bf16(q, k, v, scale, True)
    terms = bf16_terms(torch, fa, q, k, v, do, o, lse2, scale,
                       tensor_cores=True)["dk"]
    out = {"kernels": bf16_agreement(torch, fa.plain_bwd_bf16(
        q, k, v, o, lse2, do, scale, True)[1], f64_dk, terms)["scale"]}
    del o, lse2
    arms = {"none": (), "all": DK_PRODUCTS}
    arms.update((f"tc:{n}", (n,)) for n in DK_PRODUCTS)
    arms.update((f"ieee:{n}", tuple(p for p in DK_PRODUCTS if p != n))
                for n in DK_PRODUCTS)
    for label, on in arms.items():
        dk = plain_dk_summed(torch, fa, q, k, v, do, on)
        out[label] = bf16_agreement(torch, dk, f64_dk, terms)["scale"]
        del dk
        torch.cuda.empty_cache()
    return out


def dk_failing_slices(torch, fa, q, k, v, do) -> list:
    """Each (batch, head) slice of (q, k, v, do) through 17a's comparison
    (``compare_flash_bf16`` at B = H = 1): ``[(b, h, dk scale from float64
    of the kernel, of the IEEE plain version, passes the float64 half)]``
    for every slice, worst kernel scale first."""
    rows = []
    for b in range(q.shape[0]):
        for h in range(q.shape[1]):
            sl = [t[b:b + 1, h:h + 1].contiguous() for t in (q, k, v, do)]
            r = compare_flash_bf16(torch, fa, *sl)["dk"]
            rows.append((b, h, r["f64"]["scale"], r["plain_vs_f64"]["scale"],
                         bf16_as_close(r["f64"], r["plain_vs_f64"])))
    return sorted(rows, key=lambda r: r[2])


def probe_cudnn(torch, dev) -> None:
    """The sampler path's layers called three times on one input under the
    default cuDNN flags and under deterministic ones: the largest
    difference from the first call."""
    from types import SimpleNamespace

    from movae_tpu_torch.models import get_network, init_model
    from movae_tpu_torch.train.prior import build_prior

    vq = init_model(get_network(V2_SIZE, 3, V2_WIDTH), seed=0,
                    device=dev).eval()
    hp = build_prior(SimpleNamespace(**HPRIOR_ARGS), 512, True, 64)
    hp.reset_parameters(torch.Generator().manual_seed(0))
    hp = hp.to(dev).eval()
    g = torch.Generator().manual_seed(1)
    zt = torch.randint(0, 512, (16, 32, 32), generator=g).to(dev)
    zb = torch.randint(0, 512, (16, 64, 64), generator=g).to(dev)
    layers = {"condition_from_top": lambda: hp.condition_from_top(zt),
              "prior_bottom_logits": lambda: hp.prior_bottom(
                  zb, False, None, condition=hp.condition_from_top(zt)),
              "decode_code": lambda: vq.decode_code(zt, zb)}
    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic
    for det in (False, True):
        cudnn.deterministic = det
        with torch.no_grad():
            res = {}
            for name, fn in layers.items():
                outs = [fn().double() for _ in range(3)]
                res[name] = [float((o - outs[0]).abs().max())
                             for o in outs[1:]]
        log(f"probe cuDNN deterministic={det}, sampler path at 15a's "
            f"widths: {json.dumps(res)}")
    cudnn.deterministic = saved


def probe_timings(torch, dev) -> dict:
    """The port's stage-1 step and cached samplers, timed on the card with
    this script's configurations and random weights from fixed seeds (for
    an A/B, run ``--probe`` of two checkouts in one call, in turns, the
    other one's package through ``--root``):

      * ``stage1_step_ms``: phase 3's full-width ``vq_vae`` sum step (32
        px, batch 256; median of 20 after 3);
      * ``prior_bf16_step_ms``: 17b's bf16 PixelSNAIL step (phase 5's
        prior at L = 4096, batch 16; a window of 10 steps);
      * ``snail_int8_s`` / ``snail_f32_s``: ``sample_fast_snail`` on phase
        9's default PixelSNAIL, batch 16, int8 KV cache at 64x64 and
        float32 at 32x32;
      * ``wavefront_b16_s`` / ``wavefront_b128_s``: ``sample_wavefront``
        on phase 14's HierarchicalPixelCNN bottom prior at 64x64,
        conditioned, batch 16 and 128; ``raster_top_s``: ``sample_fast``
        on its top prior at 32x32, batch 16.

    Each sampler run is timed once after a warm-up run of a 4x4 grid, with
    a card synchronisation at each end."""
    from types import SimpleNamespace

    import movae_tpu_torch
    from movae_tpu_torch.models import pixelcnn as pc
    from movae_tpu_torch.train.prior import build_prior

    out = {"package": os.path.dirname(os.path.abspath(
        movae_tpu_torch.__file__))}
    res, _ = train_mode(torch, "sum", dev, STAGE1)
    out["stage1_step_ms"] = res["median_step_ms"]
    torch.cuda.empty_cache()
    out["prior_bf16_step_ms"] = phase_prior(torch, dev, False,
                                            "bfloat16")[0]["step_ms"]
    torch.cuda.empty_cache()

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    b = SAMPLE_BATCH
    snail = build_prior(SimpleNamespace(**PRIOR_ARGS), SLICE_K, False,
                        SLICE_D)
    snail.reset_parameters(torch.Generator().manual_seed(0))
    snail = snail.to(dev).eval()
    gen = torch.Generator(device=dev)
    for key, dtype, grid in (("snail_int8_s", torch.int8, 64),
                             ("snail_f32_s", torch.float32, 32)):
        pc.sample_fast_snail(snail, gen.manual_seed(1), b, 4, 4,
                             cache_dtype=dtype)
        out[key] = timed(lambda: pc.sample_fast_snail(
            snail, gen.manual_seed(1), b, grid, grid, cache_dtype=dtype))
    del snail
    hp = build_prior(SimpleNamespace(**HPRIOR_ARGS), SLICE_K, True, SLICE_D)
    hp.reset_parameters(torch.Generator().manual_seed(0))
    hp = hp.to(dev).eval()
    for bb in (b, S3_BATCH):
        zt = torch.randint(0, SLICE_K, (bb, 32, 32), device=dev,
                           generator=gen.manual_seed(2))
        with torch.no_grad():
            cond = hp.condition_from_top(zt)
        pc.sample_wavefront(hp.prior_bottom, gen.manual_seed(3), bb, 4, 4,
                            condition=cond[:, :4, :4])
        out[f"wavefront_b{bb}_s"] = timed(lambda: pc.sample_wavefront(
            hp.prior_bottom, gen.manual_seed(3), bb, 64, 64,
            condition=cond))
    pc.sample_fast(hp.prior_top, gen.manual_seed(4), b, 4, 4)
    out["raster_top_s"] = timed(lambda: pc.sample_fast(
        hp.prior_top, gen.manual_seed(4), b, 32, 32))
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--profile", action="store_true",
                   help="also print a torch.profiler breakdown per mode")
    p.add_argument("--probe", nargs="*", default=None,
                   choices=PROBES, metavar="NAME",
                   help="only the probes behind PERF.md's findings, each "
                   f"of {', '.join(PROBES)} named (all when none is): "
                   "probe_dkv, probe_cudnn, probe_timings; not a smoke "
                   "run")
    p.add_argument("--seeds", type=int, nargs="*", default=[0],
                   metavar="SEED",
                   help="--probe dkv: the prior init seeds to train "
                   "through, until one fails")
    p.add_argument("--save", default=None, metavar="DIR",
                   help="--probe dkv: write a failing prior's q, k, v, do "
                   "and its worst failing slice to DIR")
    p.add_argument("--inputs", default=None, metavar="FILE",
                   help="--probe dkv: hold the builds on these saved q, k, "
                   "v, do instead of training priors")
    p.add_argument("--parent", default=None, metavar="DIR",
                   help="--probe: another checkout's root, whose "
                   "flash_attention.cu trains probe_dkv's priors and is "
                   "held beside this build on them")
    p.add_argument("--root", default=None, metavar="DIR",
                   help="import movae_tpu_torch from DIR (another "
                   "checkout, for an A/B of --probe's timings) instead of "
                   "from beside this script")
    args = p.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root) if args.root
                    else os.path.dirname(os.path.abspath(__file__)))
    try:
        from movae_tpu_torch.device import resolve_device
        from movae_tpu_torch.kernels import (LAUNCH_COUNTS, build,
                                             reset_launch_counts)
        from movae_tpu_torch.kernels import flash_attention as fa
        from movae_tpu_torch.kernels import nearest_code as nc
    except ImportError as e:
        print(f"chip_smoke: the movae_tpu_torch package must sit beside "
              f"this script: {e}", file=sys.stderr)
        return 1

    # a tower weights file that is named but absent fails the run before
    # any phase (stage 3 would raise on it after the others)
    for var in ("MOVAE_INCEPTION_WEIGHTS", "MOVAE_VGG16_WEIGHTS"):
        path = os.environ.get(var)
        if path and not os.path.exists(path):
            print(f"chip_smoke: {var} points at a missing file: {path}",
                  file=sys.stderr)
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

    if args.probe is not None:
        build.build(list(build.TARGETS))
        probes = args.probe or PROBES
        try:
            if "dkv" in probes:
                probe_dkv(torch, fa, dev, args.parent, args.seeds,
                          args.inputs, args.save)
            if "cudnn" in probes:
                probe_cudnn(torch, dev)
            if "timings" in probes:
                log(f"probe timings ({smi[0] if smi else name}): "
                    + json.dumps(probe_timings(torch, dev)))
        except SmokeFailure as e:
            print(f"chip_smoke: probe FAILED: {e}", file=sys.stderr)
            return 1
        return 0
    start = time.perf_counter()
    cli_tmp = None
    try:
        t0 = time.perf_counter()
        libs = build.build(list(build.TARGETS))
        log(f"build: {time.perf_counter() - t0:.1f} s")
        for src, text in build.build_logs.items():
            log(f"ptxas {src}:\n{text.strip()}")
        log("registers, spill stores, spill loads (bytes): " + json.dumps(
            {src: ptxas_summary(text)
             for src, text in build.build_logs.items()}))
        cuobjdump = os.path.join(os.path.dirname(build.nvcc_path()),
                                 "cuobjdump")
        sass = {}
        if os.path.exists(cuobjdump):
            sass = {n: sass_counts(cuobjdump, str(p))
                    for n, p in zip(build.TARGETS, libs)}
            log("SASS instructions per kernel (HMMA: tensor-core mma): "
                + json.dumps(sass))
            no_mma = [f"{lib}:{kern}" for lib, kerns in sass.items()
                      for kern, ops in kerns.items() if ops["HMMA"] == 0]
            check(not no_mma, f"kernels without tensor-core mma: {no_mma}")
        else:
            log(f"SASS counts: no cuobjdump at {cuobjdump}")

        row = phase_kernels(torch, nc, dev, peaks)
        flash_rows = phase_flash(torch, fa, dev, peaks)

        reset_launch_counts()
        runs = [train_mode(torch, agg, dev, STAGE1)
                for agg in ("sum", "upgrad")]
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
            for res_mode, (step, state, batches, gen) in runs:
                profile_device(torch, f"agg={res_mode['agg']}", lambda: [
                    step(state, batches[i % len(batches)], gen)
                    for i in range(5)], 5, res_mode["median_step_ms"])

        phase_lockstep(torch, dev, dict(hidden_dims=(8, 16), embedding_dim=8,
                                        num_embeddings=32), 16, "upgrad")

        # the aggregators and the gradient-guided models on their paths;
        # their nearest_code launches join the row
        bare = {"stage1_sum_images_per_sec": runs[0][0]["images_per_sec"]}
        del runs, state, batches
        aggs = phase_aggregators(torch, dev, args.profile)
        row["launches"] += aggs["nearest_code_launches"]
        for agg in ("mgda_ln", "aligned_mtl"):
            phase_lockstep(torch, dev, dict(hidden_dims=(8, 16),
                                            embedding_dim=8,
                                            num_embeddings=32), 16, agg)
        gg = phase_gg(torch, dev, args.profile)
        row["launches"] += gg["nearest_code_launches"]
        torch.cuda.empty_cache()

        prior, snail, codes = phase_prior(torch, dev, args.profile)
        row["launches"] += prior["launches"]["nearest_code"]
        trained = phase_prior_kernels(torch, fa, snail, codes)
        torch.cuda.empty_cache()
        for r in flash_rows:
            r["launches"] = prior["launches"][r["name"]]
            r["max_abs_err"] = max(r["max_abs_err"], trained[r["name"]])
        phase_prior_lockstep(torch, dev)

        # the 256-px VQ-VAE-2 path: train, extract, hierarchical prior,
        # sample, decode; nearest_code counts are read per phase
        reset_launch_counts()
        v2_runs = [train_mode(torch, agg, dev, VQVAE2)
                   for agg in ("sum", "upgrad")]
        vq2 = v2_runs[-1][1][1].model
        _, top, bottom = phase_vqvae2_extract(torch, vq2, dev)
        v2_launches = LAUNCH_COUNTS["nearest_code"]
        forwards = sum(r["steps"] for r, _ in v2_runs)
        check(v2_launches == 2 * (forwards + V2_EXTRACT_BATCHES),
              f"nearest_code launched {v2_launches} times in the VQ-VAE-2 "
              f"path, expected 2 x ({forwards} forwards + "
              f"{V2_EXTRACT_BATCHES} extraction batches)")
        row["launches"] += v2_launches
        bare["v2_sum_images_per_sec"] = v2_runs[0][0]["images_per_sec"]
        row["max_abs_err"] = max(row["max_abs_err"],
                                 check_vqvae2_latents(torch, nc, vq2))
        if args.profile:
            for res_mode, (step, state, batches, gen) in v2_runs:
                profile_device(torch, f"vq_vae2 agg={res_mode['agg']}",
                               lambda: [step(state, batches[i % 4], gen)
                                        for i in range(3)], 3,
                               res_mode["median_step_ms"])
        del v2_runs
        _, hprior = phase_hier_prior(torch, dev, vq2, top, bottom,
                                     args.profile)
        phase_sampling(torch, dev, hprior, vq2, snail, args.profile)
        phase_sampler_checks(torch, dev, hprior, snail)
        del snail
        torch.cuda.empty_cache()
        wave = phase_wavefront(torch, dev, hprior, args.profile)
        torch.cuda.empty_cache()
        small2 = dict(arch="vq_vae2", hidden_dims=(16, 32), embedding_dim=8,
                      num_embeddings=32, recons_activation="none")
        for agg in ("sum", "upgrad"):
            phase_lockstep(torch, dev, small2, 32, agg)

        # stage 3: the towers, then run_final_metrics on the VQ-VAE-2 path's
        # trained model and prior (its nearest_code launches join the row)
        phase_towers(torch, dev, args.profile)
        stage3 = phase_stage3(torch, dev, vq2, hprior,
                              wave["chunk_raster_s"])
        row["launches"] += stage3["launches"]["nearest_code"]
        del hprior, vq2
        torch.cuda.empty_cache()

        # configs through the port's CLI; the run trees stay for phase 18
        cli_tmp = tempfile.mkdtemp(prefix="movae_cli_")
        cli = phase_cli(torch, dev, bare, cli_tmp)
        row["launches"] += cli["launches"]["nearest_code"]
        for r in flash_rows:
            r["launches"] += cli["launches"][r["name"]]

        # the VAE family: no kernel of the port on its path (every count 0)
        phase_vae(torch, dev, args.profile, smi[0] if smi else name)

        # this slice's path: bf16 compute (the bf16 flash kernels),
        # grad_accum, steps_per_dispatch, remat
        bf16_rows = phase_item6(torch, fa, dev, peaks, sass, prior,
                                smi[0] if smi else name, args.profile)

        # this slice's path: the standalone prior CLIs on phase 15's run
        # trees, benchmark_workers and the sphere encoders
        standalone, live = phase_standalone(
            torch, dev, cli["roots"], args.profile, smi[0] if smi else name)
        row["launches"] += standalone["nearest_code"]
        for r in flash_rows:
            r["launches"] += standalone[r["name"]]

        # this slice's path: serving, phase 15's checkpoints exported and
        # served over HTTP; the nearest-code launches the server makes
        reset_launch_counts()
        serve = phase_serving(torch, dev, cli["roots"], live,
                              smi[0] if smi else name)
        row["launches"] += serve["launches"]

        # this slice's path: the data axis (DDP, fsdp, sample-parallel
        # generation) over ranks of the one card
        phase_multirank(torch, smi[0] if smi else name)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        if cli_tmp is not None:
            shutil.rmtree(cli_tmp, ignore_errors=True)

    log(f"chip_smoke: all phases passed in "
        f"{time.perf_counter() - start:.1f} s")
    log(json.dumps({"kernels": [row, *flash_rows, *bf16_rows]}))
    log(smi[0] if smi else "nvidia-smi: no output")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
