"""Training CLI of the port — ``python -m movae_tpu_torch.main``.

The counterpart of the repo's ``main.py``: the same flags, aliases and
defaults (so ``movae_tpu_torch/runner.py`` runs every YAML of ``configs/``
unchanged), except ``--device``, which is ``cuda`` by default and ``cpu``
for a CPU rehearsal. Train the model (``train/loop.py``), then for VQ
models the prior (``train/prior.py``) and a final sample grid through it,
then the final metrics (``train/final_metrics.py``) into the run's
summary as ``final/*``. ``torchrun --nproc_per_node N -m
movae_tpu_torch.main ...`` runs every stage over N ranks
(``--batch_size`` the global batch; rank 0 writes the run tree): data
parallel by default, with ``--model_partitions`` (tensor parallelism of
stage 1), ``--context_parallel`` (ring attention in the prior) and
``--pipeline_parallel`` (the prior's blocks as a GPipe pipeline) taking
their axes of the ranks (``parallel/``).
"""

from __future__ import annotations

import json
import os
from argparse import ArgumentParser

import torch

from movae_tpu_torch.utils import set_seed


def build_parser() -> ArgumentParser:
    parser = ArgumentParser()
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu (a CPU rehearsal)")
    parser.add_argument("--data_dir", type=str, default="./data")
    parser.add_argument("--save_path", type=str, default="logs/")
    parser.add_argument("--epochs", type=int, default=50)
    parser.add_argument("--dataset", type=str, default="CIFAR10")
    parser.add_argument("--normalize_inputs", action="store_true",
                        dest="normalize_inputs",
                        help="Normalize inputs to [-1,1] (mean=0.5, std=0.5)")
    parser.add_argument("--batch_size", type=int, default=128)
    parser.add_argument("--num_workers", type=int, default=0)
    parser.add_argument("--aggregator", "--agg", type=str, default=None)
    parser.add_argument("--agg_norm_eps", "--agg-norm-eps", "--norm_eps",
                        "--norm-eps", type=float, default=1e-4)
    parser.add_argument("--agg_reg_eps", "--agg-reg-eps", "--reg_eps",
                        "--reg-eps", type=float, default=1e-4)
    parser.add_argument("--mgda_epsilon", "--mgda-epsilon", type=float,
                        default=1e-5)
    parser.add_argument("--mgda_max_iters", "--mgda-max-iters", type=int,
                        default=250)
    parser.add_argument("--mgda_min_eigenvalue_eps",
                        "--mgda-min-eigenvalue-eps", type=float, default=1e-10)
    parser.add_argument("--comfort_mgda_norm_type", "--comfort-mgda-norm-type",
                        type=str, default="none",
                        choices=["none", "l2", "loss", "loss+"])
    parser.add_argument("--comfort_mgda_stable", "--comfort-mgda-stable",
                        action="store_true")
    parser.add_argument("--comfort_beta_k", type=float, default=1.0)
    parser.add_argument("--comfort_beta_a", type=float, default=1.0)
    parser.add_argument("--comfort_beta_l", type=float, default=0.01)
    parser.add_argument("--comfort_beta_u", type=float, default=1.0)
    parser.add_argument("--arch", type=str, default="vae")
    parser.add_argument("--layer_norm", type=str, default="batch")
    parser.add_argument("--latent_dim", type=int, default=128)
    parser.add_argument("--hidden_dims", type=int, nargs="+",
                        default=[32, 64, 128, 256, 512])
    parser.add_argument("--num_residual_layers", type=int, default=2)
    # default None (not "mse") so old-style --recons_dist configs can map
    # through get_network's back-compat path (reference
    # models/__init__.py:25-38); unset resolves to mse there.
    parser.add_argument("--recons_objective", type=str, default=None,
                        choices=["mse", "bce", "l1", "smooth_l1", "perceptual"])
    parser.add_argument("--recons_dist", type=str, default="gaussian",
                        choices=["gaussian", "bernoulli", "laplacian"])
    parser.add_argument("--recons_reduction", type=str, default="mean")
    parser.add_argument("--recons_activation", type=str, default=None,
                        choices=["tanh", "sigmoid", "none"])
    parser.add_argument("--loss_weights", type=str, nargs="*", default=None,
                        help="JSON dict or list of floats")
    parser.add_argument("--pref_weights", type=str, nargs="*", default=None)
    parser.add_argument("--optimizer", type=str, default="adam")
    parser.add_argument("--momentum", type=float, default=0.9)
    parser.add_argument("--max_grad_norm", type=float, default=None)
    parser.add_argument("--lr", type=float, default=0.001)
    parser.add_argument("--wd", "--weight_decay", type=float, default=0)
    parser.add_argument("--scheduler", type=str, default=None)
    parser.add_argument("--scheduler_lr_min", type=float, default=0.0)
    parser.add_argument("--scheduler_gamma", type=float, default=0.1)
    parser.add_argument("--scheduler_milestones", type=int, nargs="+",
                        default=None)
    parser.add_argument("--embedding_dim", type=int, default=None)
    parser.add_argument("--num_embeddings", type=int, default=None)
    parser.add_argument("--anneal_steps", type=int, default=None)
    parser.add_argument("--recursive_kld_anneal_steps", type=int,
                        default=25000)
    # Sphere encoder (reference main.py:1604-1618)
    parser.add_argument("--sigma_max_angle_deg", type=float, default=80.0)
    parser.add_argument("--sigma_mix_prob", type=float, default=0.0)
    parser.add_argument("--sigma_mix_angle_min_deg", type=float, default=None)
    parser.add_argument("--sigma_mix_angle_max_deg", type=float, default=None)
    parser.add_argument("--lambda_pix_recon", type=float, default=1.0)
    parser.add_argument("--lambda_pix_con", type=float, default=0.5)
    parser.add_argument("--lambda_lat_con", type=float, default=0.1)
    parser.add_argument("--patch_size", type=int, default=None)
    parser.add_argument("--vit_embed_dim", type=int, default=1024)
    parser.add_argument("--vit_depth", type=int, default=24)
    parser.add_argument("--vit_num_heads", type=int, default=16)
    parser.add_argument("--vit_mixer_depth", type=int, default=2)
    parser.add_argument("--num_classes", type=int, default=0)
    parser.add_argument("--hv_ref", type=str, nargs="*", default=None)
    parser.add_argument("--num_vis_samples", type=int, default=4,
                        dest="num_vis_samples")
    parser.add_argument("--save_freq", type=int, default=10)
    parser.add_argument("--eval_freq", type=int, default=1)
    parser.add_argument("--use_wandb", action="store_true")
    parser.add_argument("--wandb_project", type=str, default="mo-vae")
    parser.add_argument("--wandb_entity", type=str, default=None)
    parser.add_argument("--wandb_name", type=str, default=None)
    parser.add_argument("--wandb_group", type=str, default=None)
    parser.add_argument("--wandb_tags", type=str, nargs="+", default=None)
    parser.add_argument("--max_fid_samples", type=int, default=10000)
    parser.add_argument("--max_gen_metrics_samples", type=int, default=10000)
    # Prior (reference main.py:1631-1651)
    parser.add_argument("--prior_type", type=str, default="pixelcnn",
                        choices=["pixelcnn", "pixelsnail"])
    parser.add_argument("--skip_pixelcnn", action="store_true")
    parser.add_argument("--pixelcnn_epochs", type=int, default=100)
    parser.add_argument("--pixelcnn_hidden_channels", type=int, default=128)
    parser.add_argument("--pixelcnn_num_layers", type=int, default=15)
    parser.add_argument("--pixelcnn_lr", type=float, default=3e-4)
    parser.add_argument("--pixelcnn_temperature", type=float, default=1.0)
    parser.add_argument("--kv_cache_dtype", type=str, default="int8",
                        choices=["f32", "bf16", "int8"],
                        help="PixelSNAIL sampler KV-cache dtype")
    parser.add_argument("--pixelsnail_num_blocks", type=int, default=8)
    parser.add_argument("--pixelsnail_num_res_blocks", type=int, default=2)
    parser.add_argument("--pixelsnail_num_heads", type=int, default=8)
    parser.add_argument("--pixelsnail_dropout", type=float, default=0.1)
    parser.add_argument("--attention_dropout", type=str, default="output",
                        choices=["output", "weights"],
                        help="prior attention-dropout semantics: output = "
                        "the flash path; weights = the reference's, on the "
                        "dense path only (L <= 1024)")
    parser.add_argument("--prior_use_lmdb_codes", action="store_true",
                        default=True, help="cache the extracted codes")
    parser.add_argument("--no_prior_lmdb_codes", action="store_false",
                        dest="prior_use_lmdb_codes")
    parser.add_argument("--prior_force_extract_codes", action="store_true")
    parser.add_argument("--prior_lmdb_map_size_gb", type=float, default=150,
                        help="accepted; the code cache is memory-mapped "
                             ".npy files")
    parser.add_argument("--compute_dtype", type=str, default="float32",
                        choices=["float32", "bfloat16"],
                        help="dtype of the conv and dense layers "
                             "(parameters stay float32)")
    parser.add_argument("--log_every", type=int, default=1,
                        help="per-step logger record cadence (0 = epoch "
                             "only)")
    parser.add_argument("--skip_final_metrics", action="store_true",
                        help="skip rFID/gFID metric towers (smoke runs)")
    parser.add_argument("--resume", type=str, default=None,
                        help="resume from a last_checkpoint.pth")
    parser.add_argument("--profile_dir", type=str, default=None,
                        help="write a torch.profiler trace of the first "
                             "epoch")
    parser.add_argument("--model_partitions", type=int, default=1,
                        help="tensor-parallel partitions of stage 1 over a "
                             "'model' axis of the torchrun ranks (the rest "
                             "data parallel)")
    parser.add_argument("--context_parallel", type=int, default=1,
                        help="sequence-parallel partitions of the prior's "
                             "attention: ring attention over a 'seq' axis "
                             "of the torchrun ranks")
    parser.add_argument("--pipeline_parallel", type=int, default=1,
                        help="pipeline-parallel prior stages: GPipe over a "
                             "'pipe' axis of the torchrun ranks (data "
                             "parallelism only beside it)")
    parser.add_argument("--pipeline_microbatches", type=int, default=0,
                        help="GPipe microbatches per step (0 = auto)")
    parser.add_argument("--fsdp", action="store_true",
                        help="under torchrun, hold 1/N of the large "
                             "parameters and their optimizer moments on "
                             "each rank (ZeRO-3); one process: no effect")
    parser.add_argument("--vq_ema", action="store_true",
                        help="EMA-maintained codebook (objectives become "
                             "recon+commitment; the reference is loss-based "
                             "only)")
    parser.add_argument("--vq_ema_decay", type=float, default=0.99)
    parser.add_argument("--steps_per_dispatch", type=int, default=1,
                        help="train steps a dispatch queues; the port's "
                             "step makes no host synchronisation, so every "
                             "batch runs through the single step")
    parser.add_argument("--grad_accum", type=int, default=1,
                        help="gradient accumulation microbatches per "
                             "optimizer update")
    parser.add_argument("--remat", action="store_true",
                        help="rematerialized backward (recompute the "
                             "forward in the backward)")
    parser.add_argument("--device_data", action="store_true",
                        help="keep the whole uint8 train set on the card "
                             "and gather batches there (auto-enabled on "
                             "cuda when the set fits 40%% of the card's "
                             "memory less what is in use)")
    parser.add_argument("--no_device_data", action="store_true",
                        help="force the host batch loader")
    return parser


def parse_json_or_list(value):
    """loss_weights/pref_weights/hv_ref: JSON dict string or float list
    (reference main.py:1654-1667)."""
    if value is None or len(value) == 0:
        return None
    if len(value) == 1 and value[0].strip().startswith("{"):
        d = json.loads(value[0])
        return {k: float(v) for k, v in d.items()}
    return [float(x) for x in value]


def parse_args(argv=None):
    args = build_parser().parse_args(argv)
    args.loss_weights = parse_json_or_list(args.loss_weights)
    args.pref_weights = parse_json_or_list(args.pref_weights)
    args.hv_ref = parse_json_or_list(args.hv_ref)
    if args.recons_objective is None:
        # back-compat: recons_dist (+ unused recons_reduction) implies the
        # objective (reference models/__init__.py:25-38); unset -> mse
        args.recons_objective = {"bernoulli": "bce", "laplacian": "l1"}.get(
            args.recons_dist, "mse")
    if args.seed is not None:
        set_seed(args.seed)
    return args


def main(args):
    from movae_tpu_torch.parallel import mesh as mesh_lib
    from movae_tpu_torch.train.loop import run_training

    if getattr(args, "num_workers", 0):
        # the reference DataLoader's worker count caps the native
        # batch-assembly threads
        from movae_tpu_torch.data import native
        native.set_num_threads(args.num_workers)

    results = run_training(args)
    parallel = results["parallel"]
    # the later stages run on the training stage's mesh
    with mesh_lib.using(parallel.mesh if parallel is not None else None):
        _after_training(results, args)
    return results


def _after_training(results, args) -> None:
    from movae_tpu_torch.train import figures as fig_lib
    from movae_tpu_torch.train.final_metrics import (GEN_SEED_OFFSET,
                                                     generate_samples,
                                                     run_final_metrics)
    from movae_tpu_torch.train.loop import is_vq_model
    from movae_tpu_torch.train.prior import train_prior

    logger = results["logger"]
    prior = None
    if is_vq_model(args) and not args.skip_pixelcnn:
        prior = train_prior(results, args)
        try:
            # final prior-driven sample grid (reference main.py:1445)
            n = getattr(args, "num_vis_samples", 4)
            gen = torch.Generator(device=results["device"]).manual_seed(
                (args.seed or 0) + GEN_SEED_OFFSET)
            # every rank generates (sample-parallel); rank 0 writes
            imgs = generate_samples(results["model"], args, prior, gen, n,
                                    batch=n)
            if results["rank"] == 0:
                png = fig_lib.save_sample_grid(
                    imgs, os.path.join(results["save_root"], "figures",
                                       "generated",
                                       "final_random_samples_with_prior.pdf"),
                    results["normalize"])
                logger.log_image("samples/final_with_prior", png)
        except Exception as e:  # the JAX package's rule: report, go on
            print(f"final prior sample figure failed: {e!r}")

    if not getattr(args, "skip_final_metrics", False):
        finals = run_final_metrics(results, args, prior=prior)
        for k, v in finals.items():
            logger.set_summary(f"final/{k}", v)
            if results["rank"] == 0:
                print(f"final/{k}: {v}")
        if logger.active:
            logger.log({f"final/{k}": v for k, v in finals.items()})
    logger.save_file(results["save_root"])
    logger.finish()


if __name__ == "__main__":
    main(parse_args())
