"""The port's CLIs (``python -m movae_tpu_torch.{main,runner,evaluate,
bench}``) against the JAX package's: the YAML schema of every file of
``configs/``, an end-to-end ``main`` run on the CPU that writes the JAX
run tree (whose prior ``.pth`` the JAX package loads and whose logits it
reproduces), ``evaluate`` on a checkpoint exported from a JAX model, the
bench's JSON line, the item-6 flags (bf16, grad_accum,
steps_per_dispatch, remat) on the CPU, and the flags that still raise.
"""

import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import main as jmain  # noqa: E402
import runner as jrunner  # noqa: E402
from movae_tpu_torch import main as tmain  # noqa: E402
from movae_tpu_torch import runner as trunner  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
DATASET_DIRS = sorted(p.name for p in (ROOT / "configs").iterdir()
                      if p.is_dir())
TINY = ["--device", "cpu", "--dataset", "synthetic-32-64", "--arch",
        "vq_vae", "--hidden_dims", "8", "16", "--embedding_dim", "8",
        "--num_embeddings", "16", "--batch_size", "16", "--normalize_inputs",
        "--seed", "1"]
FEATURE_DIMS = 8


@pytest.mark.parametrize("dataset_dir", DATASET_DIRS)
def test_yaml_to_args_matches_jax_runner(dataset_dir):
    """Every config: the same argv from both runners, and the same parsed
    namespace from both mains (``device`` aside)."""
    files = sorted((ROOT / "configs" / dataset_dir).rglob("*.yaml"))
    assert files
    for path in files:
        argv = trunner.yaml_to_args(trunner.load_yaml_config(path))
        assert argv == jrunner.yaml_to_args(jrunner.load_yaml_config(path))
        got, want = vars(tmain.parse_args(argv)), vars(jmain.parse_args(argv))
        got.pop("device"), want.pop("device")
        assert got == want, path


def test_flag_set_matches_jax():
    """Every flag of the JAX main exists under the same name, aliases and
    default; only --device's default differs (cuda)."""
    def flags(p):
        return {a.dest: (tuple(a.option_strings), a.default, a.nargs,
                         a.choices, a.const) for a in p._actions}

    got, want = flags(tmain.build_parser()), flags(jmain.build_parser())
    assert got.keys() == want.keys() and len(got) == 104
    assert got.pop("device")[1] == "cuda"
    want.pop("device")
    assert got == want


def test_runner_launches_the_port_main(monkeypatch):
    """One subprocess per config: ``python -m movae_tpu_torch.main`` with
    the YAML's argv, the checkout on PYTHONPATH, ``--gpu_id`` as
    CUDA_VISIBLE_DEVICES; a failed run is reported, not raised."""
    seen = []

    def fake_run(cmd, check, env):
        seen.append((cmd, env))
        if len(seen) > 1:
            raise subprocess.CalledProcessError(1, cmd)
        return subprocess.CompletedProcess(cmd, 0)

    monkeypatch.setattr(trunner.subprocess, "run", fake_run)
    cfg = "configs/celeba-hq/vq_vae2/sum/mse/config_1.yaml"
    assert trunner.run_single_config(cfg, device_id=3, num_workers=2)
    cmd, env = seen[0]
    assert cmd[:3] == [sys.executable, "-m", "movae_tpu_torch.main"]
    assert cmd[3:] == trunner.yaml_to_args(trunner.load_yaml_config(cfg)) + [
        "--num_workers", "2"]
    assert env["CUDA_VISIBLE_DEVICES"] == "3"
    assert str(ROOT) in env["PYTHONPATH"].split(os.pathsep)
    assert not trunner.run_single_config(cfg)
    assert not trunner.run_single_config("configs/missing.yaml")


@pytest.fixture
def cheap_towers(monkeypatch):
    """The port's final metrics without the Inception tower: features are
    the first pixels of each image (FID/KID on 8 dims), IS a constant; the
    CLI's wiring is under test, the metrics have their own tests."""
    from movae_tpu_torch.metrics import features as tf

    def extract(images, batch_size=128, device=None):
        return np.asarray(images, np.float64).reshape(len(images), -1)[
            :, :FEATURE_DIMS]

    monkeypatch.setattr(tf, "extract_inception_features", extract)
    monkeypatch.setattr(tf, "calculate_inception_score",
                        lambda images, batch_size=128, splits=10,
                        device=None: (1.0, 0.0))


def test_main_end_to_end_writes_the_jax_run_tree(tmp_path, cheap_towers):
    """``main`` on the CPU (vq_vae, a 2-layer PixelCNN prior, 1 epoch each,
    16-image final metrics) writes the JAX package's run tree and a
    history with train/*, eval/*, prior/loss and every final/*; the JAX
    package's ``find_prior`` loads the prior .pth beside the checkpoint and
    its logits equal the port's."""
    from movae_tpu.models import get_network as jget
    from movae_tpu.train.checkpoint import load_checkpoint
    from movae_tpu.train.prior import find_prior as jfind
    from movae_tpu_torch.train.prior import find_prior

    args = tmain.parse_args(TINY + [
        "--epochs", "1", "--pixelcnn_epochs", "1", "--pixelcnn_num_layers",
        "2", "--pixelcnn_hidden_channels", "8", "--max_fid_samples", "16",
        "--max_gen_metrics_samples", "16", "--num_vis_samples", "2",
        "--save_path", str(tmp_path)])
    results = tmain.main(args)
    root = Path(results["save_root"])
    assert root.relative_to(tmp_path).parts[:4] == (
        "synthetic-32-64", "vq_vae", "adam", "sum")
    for rel in ("figures/generated/epoch_0001_random_samples.pdf",
                "figures/generated/epoch_0001_random_samples.png",
                "figures/generated/final_random_samples_with_prior.pdf",
                "figures/reconstructed/epoch_0001_test_samples.pdf",
                "figures/reconstructed/epoch_0001_train_samples.png",
                "checkpoints/final_checkpoint.pth",
                "pixelcnn_prior/checkpoints/best_prior.pth",
                "pixelcnn_prior/checkpoints/final_prior.pth",
                "pixelcnn_prior/checkpoints/last_prior.pth",
                "wandb_local/config.json", "wandb_local/summary.json"):
        assert (root / rel).exists(), rel
    assert len(list((root / "codes_cache").glob("*/meta.json"))) == 1
    with open(root / "wandb_local" / "history.jsonl") as f:
        keys = set().union(*(json.loads(line) for line in f))
    finals = {"psnr", "ssim", "lpips", "rfid", "gfid", "kid",
              "inception_score_mean", "inception_score_std", "precision",
              "recall", "eval_total_loss"}
    assert {f"final/{k}" for k in finals} <= keys
    assert {"train/total_loss", "eval/total_loss", "prior/loss"} <= keys
    with open(root / "wandb_local" / "summary.json") as f:
        summary = json.load(f)
    assert np.isfinite(summary["final/psnr"])

    payload = load_checkpoint(str(root / "checkpoints"
                                  / "final_checkpoint.pth"))
    vq_args = SimpleNamespace(**payload["args"])
    found = jfind(str(root / "checkpoints" / "final_checkpoint.pth"),
                  jget(32, 3, vq_args), vq_args)
    assert found is not None and not found["hierarchical"]
    codes = np.random.default_rng(4).integers(0, 16, (2, 8, 8))
    want = np.asarray(found["model"].apply({"params": found["params"]},
                                           jnp.asarray(codes)))
    mine = find_prior(str(root / "checkpoints" / "final_checkpoint.pth"),
                      results["model"], vq_args)
    with torch.no_grad():
        got = mine["model"](torch.from_numpy(codes))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_evaluate_on_a_checkpoint_exported_from_jax(tmp_path, monkeypatch,
                                                    cheap_towers):
    """A JAX-trained orbax checkpoint, exported to .pth by
    scripts/export_torch_checkpoint.py, through the port's ``evaluate``:
    PSNR and SSIM equal JAX's ``evaluate_recon_metrics`` within 1e-4."""
    from movae_tpu.data import Loader as JLoader, get_dataset as jget_ds
    from movae_tpu.metrics import features as jf
    from movae_tpu.models import get_network as jget, init_model as jinit
    from movae_tpu.train.checkpoint import save_checkpoint
    from movae_tpu.train.final_metrics import evaluate_recon_metrics
    from movae_tpu_torch import evaluate as tevaluate

    sys.path.insert(0, str(ROOT / "scripts"))
    try:
        import export_torch_checkpoint
    finally:
        sys.path.remove(str(ROOT / "scripts"))
    jargs = dict(arch="vq_vae", embedding_dim=8, num_embeddings=16,
                 hidden_dims=[8, 16], num_residual_layers=2,
                 dataset="synthetic-32-64", normalize_inputs=True)
    jm = jget(32, 3, jargs)
    params, bstats = jinit(jm, jax.random.PRNGKey(6), 32, 3)
    ckpt = str(tmp_path / "final_checkpoint")
    save_checkpoint(ckpt, {"epoch": 1, "args": jargs, "model_state_dict": {
        "params": params, "batch_stats": bstats}})
    out = str(tmp_path / "exported.pth")
    monkeypatch.setattr(sys, "argv", ["export", "--ckpt", ckpt, "--out", out])
    export_torch_checkpoint.main()

    results = tevaluate.evaluate(model_path=out, batch_size=16,
                                 max_fid_samples=16, skip_generative=True,
                                 device="cpu")
    monkeypatch.setattr(jf, "extract_inception_features",
                        lambda images, batch_size=128: np.asarray(
                            images, np.float64).reshape(len(images), -1)[
                                :, :FEATURE_DIMS])
    _, test_ds, _ = jget_ds("synthetic-32-64", normalize=True)
    state = SimpleNamespace(params=params, batch_stats=bstats)
    want = evaluate_recon_metrics(jm, state, JLoader(test_ds, 16),
                                  jax.random.PRNGKey(0), max_samples=16)
    for k in ("psnr", "ssim"):
        np.testing.assert_allclose(results[f"recon/{k}"], want[k],
                                   rtol=1e-4, err_msg=k)
    assert {"eval/total_loss", "eval/hv", "recon/rfid"} <= set(results)


def test_bench_prints_one_json_line():
    """``python -m movae_tpu_torch.bench --device cpu``: one JSON line with
    bench.py's keys, the device it ran on, and the run's dtype (float32 on
    the CPU, as bench.py), steps a dispatch, remat, host synchronisations
    a step and steps run; the defaults are bench.py's (bf16, batch 1024,
    8 steps a dispatch; 2 here, to keep the run short)."""
    from movae_tpu_torch import bench

    defaults = bench.build_parser().parse_args([])
    assert (defaults.dtype, defaults.batch_size,
            defaults.steps_per_dispatch) == ("bfloat16", 1024, 8)
    out = subprocess.run(
        [sys.executable, "-m", "movae_tpu_torch.bench", "--device", "cpu",
         "--steps", "5", "--warmup", "1", "--batch_size", "2",
         "--input_size", "8", "--steps_per_dispatch", "2"], cwd=ROOT,
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert set(line) == {"metric", "value", "unit", "vs_baseline", "device",
                         "dtype", "steps_per_dispatch", "remat",
                         "host_syncs_per_step", "steps_run"}
    assert line["unit"] == "images/sec/chip" and line["value"] > 0
    assert line["device"] == "cpu" and line["dtype"] == "float32"
    assert line["steps_per_dispatch"] == 2 and line["remat"] is False
    assert line["host_syncs_per_step"] == 0
    # 1 warmup dispatch, 5 timed rounds and the sync count of 1 dispatch
    assert line["steps_run"] == 7 * 2


@pytest.mark.parametrize("arch", ["vq_vae", "vae", "gg_vae_v2",
                                  "betatc_vae", "cycle_vae"])
def test_bench_builds_the_model_of_bench_py(arch):
    """``--arch`` through the registry alone: the model of the repo's
    ``bench.py`` (its ``model_args``, bench.py:141-148, float32), with the
    same class, objectives, lambda weights and parameter count."""
    from movae_tpu.models import get_network as jget, init_model as jinit
    from movae_tpu_torch import bench
    from movae_tpu_torch.models import get_network

    args = SimpleNamespace(arch=arch, batch_size=256, input_size=32)
    jm = jget(32, 3, dict(arch=arch, embedding_dim=64, num_embeddings=512,
                          hidden_dims=(128, 256), num_residual_layers=2,
                          batch_size=256, dataset_size=50000,
                          recons_objective="mse", compute_dtype="float32"))
    tm = get_network(32, 3, bench.model_args(args))
    assert type(tm).__name__ == type(jm).__name__
    assert tm.objective_names == jm.objective_names
    assert tm.lambda_weights == tuple(jm.lambda_weights)
    params, _ = jinit(jm, jax.random.PRNGKey(0), 32, 3)
    assert sum(p.numel() for p in tm.parameters() if p.requires_grad) == sum(
        int(np.size(x)) for x in jax.tree_util.tree_leaves(params))


def test_main_cli_runs_a_vae_to_the_jax_run_tree(tmp_path):
    """``python -m movae_tpu_torch.main --device cpu --arch vae`` at a tiny
    size: the JAX package's run tree (figures from ``model.sample``, both
    checkpoints), no prior stage, and a final checkpoint the JAX package
    reads."""
    from movae_tpu.utils.torch_import import load_reference_checkpoint

    out = subprocess.run(
        [sys.executable, "-m", "movae_tpu_torch.main", "--device", "cpu",
         "--dataset", "synthetic-32-64", "--arch", "vae", "--hidden_dims",
         "8", "16", "--latent_dim", "8", "--batch_size", "16", "--epochs",
         "2", "--save_freq", "1", "--aggregator", "mgda",
         "--normalize_inputs", "--num_vis_samples", "2", "--seed", "1",
         "--skip_final_metrics", "--save_path", str(tmp_path)],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    roots = [p.parent.parent for p in tmp_path.rglob("final_checkpoint.pth")]
    assert len(roots) == 1
    root = roots[0]
    assert root.relative_to(tmp_path).parts[:4] == (
        "synthetic-32-64", "vae", "adam", "mgda")
    for e in (1, 2):
        for rel in (f"figures/generated/epoch_{e:04d}_random_samples.png",
                    f"figures/reconstructed/epoch_{e:04d}_test_samples.pdf",
                    f"figures/reconstructed/epoch_{e:04d}_train_samples.png"):
            assert (root / rel).exists(), rel
    assert (root / "checkpoints" / "last_checkpoint.pth").exists()
    assert not list(root.glob("*_prior")) and not (root / "codes_cache"
                                                   ).exists()
    with open(root / "wandb_local" / "history.jsonl") as f:
        keys = set().union(*(json.loads(line) for line in f))
    assert {"train/reconstruction_loss", "train/kld_loss",
            "train/task_1_weight", "eval/total_loss"} <= keys
    loaded = load_reference_checkpoint(str(root / "checkpoints"
                                           / "final_checkpoint.pth"))
    assert "enc_norm_0" in loaded["model_state_dict"]["batch_stats"]


@pytest.mark.parametrize("flag,item", [
    (["--model_partitions", "2"], "item 13"),
    (["--context_parallel", "2"], "item 13"),
    (["--pipeline_parallel", "2"], "item 13"),
    (["--context_parallel", "2", "--fsdp"], "item 13")])
def test_unported_flags_name_their_roadmap_item(flag, item, tmp_path):
    from movae_tpu_torch.train.loop import run_training

    args = tmain.parse_args(TINY + ["--save_path", str(tmp_path)] + flag)
    with pytest.raises(NotImplementedError, match=f"Queue 1 {item}"):
        run_training(args)


def test_sphere_encoder_arch_builds_as_in_jax():
    """``--arch sphere_encoder`` (once refused as not ported) parses to one
    model in both packages: the same objectives, lambda weights and
    parameter count."""
    from movae_tpu.models import get_network as jget
    from movae_tpu.models import init_model as jinit
    from movae_tpu_torch.models import get_network

    argv = TINY + ["--arch", "sphere_encoder", "--latent_dim", "8"]
    jargs, targs = jmain.parse_args(argv), tmain.parse_args(argv)
    jargs.use_perceptual = targs.use_perceptual = False
    jm, tm = jget(32, 3, jargs), get_network(32, 3, targs)
    assert tm.objective_names == jm.objective_names
    assert tm.lambda_weights == tuple(jm.lambda_weights) == (
        ("pix_recon", 1.0), ("pix_con", 0.5), ("lat_con", 0.1))
    params, _ = jax.eval_shape(lambda key: jinit(jm, key, 32, 3),
                               jax.random.PRNGKey(0))
    assert sum(p.numel() for p in tm.parameters()) == sum(
        int(np.prod(p.shape)) for p in jax.tree_util.tree_leaves(params))


@pytest.mark.parametrize("flag,steps", [
    (["--grad_accum", "2"], 2), (["--steps_per_dispatch", "2"], 4),
    (["--remat"], 4), (["--compute_dtype", "bfloat16"], 4)])
def test_item6_flags_run_on_the_cpu(flag, steps, tmp_path):
    """The flags of ROADMAP item 6 train at the file's tiny size (64
    images, batch 16: 4 batches an epoch): --grad_accum 2 makes 2 optimizer
    updates of 2 microbatches, the others 4 updates; the step counter
    counts them, the losses are finite, nothing is skipped."""
    from movae_tpu_torch.train.loop import run_training

    args = tmain.parse_args(TINY + ["--save_path", str(tmp_path), "--epochs",
                                    "1", "--num_vis_samples", "2"] + flag)
    res = run_training(args)
    assert res["step"] == steps and int(res["state"].step) == steps
    assert all(np.isfinite(v) for v in res["train_losses"][0].values())
    want = (torch.bfloat16 if "bfloat16" in flag else torch.float32)
    assert res["model"].compute_dtype == want
    assert all(p.dtype == torch.float32 for p in res["model"].parameters())


def test_grad_accum_with_steps_per_dispatch_raises_value_error(tmp_path):
    """As in the JAX package: an accumulation group is already one
    dispatch."""
    from movae_tpu.train.loop import run_training as jrun
    from movae_tpu_torch.train.loop import run_training

    flags = ["--grad_accum", "2", "--steps_per_dispatch", "2"]
    for run, parse in ((run_training, tmain.parse_args),
                       (jrun, jmain.parse_args)):
        args = parse(TINY + ["--save_path", str(tmp_path)] + flags)
        with pytest.raises(ValueError, match="mutually exclusive"):
            run(args)


@pytest.mark.parametrize("flag,key,value", [
    (["--steps_per_dispatch", "2"], "steps_per_dispatch", 2),
    (["--dtype", "bfloat16"], "dtype", "float32"),
    (["--remat"], "remat", True)])
def test_bench_tpu_flags_run_on_the_cpu(flag, key, value):
    """bench.py's TPU flags run through the port's bench on the CPU
    (bfloat16 computes in float32 there, as bench.py does)."""
    from movae_tpu_torch import bench

    line = bench.main(["--device", "cpu", "--batch_size", "2", "--steps",
                       "5", "--warmup", "1", "--input_size", "8",
                       "--steps_per_dispatch", "1"] + flag)
    assert line[key] == value and line["value"] > 0
