"""The port's standalone CLIs (``movae_tpu_torch/train_prior_vqvae.py``,
``train_prior_vqvae2.py``, ``generate_samples_pixelcnn_vqvae.py``,
``generate_samples_pixelcnn_vqvae2.py``, ``benchmark_workers.py``) on the
CPU, each through its ``main(argv)``, on a tiny VQ-VAE and VQ-VAE-2 trained
and saved by the port's ``main`` on ``synthetic-32-64``; their flag merging
against the JAX CLIs' functions on the same argv.

The generative metrics run on the port's random towers with FID on 4
feature dims (a 2048-dim ``sqrtm`` takes ~20 s on the CPU), as in
tests/test_torch_port_final_metrics.py.
"""

import glob
import json
import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import train_prior_vqvae as jtp  # noqa: E402
from movae_tpu_torch import benchmark_workers as tbw  # noqa: E402
from movae_tpu_torch import generate_samples_pixelcnn_vqvae as tgen  # noqa
from movae_tpu_torch import generate_samples_pixelcnn_vqvae2 as tgen2  # noqa
from movae_tpu_torch import main as tmain  # noqa: E402
from movae_tpu_torch import train_prior_vqvae as ttp  # noqa: E402
from movae_tpu_torch import train_prior_vqvae2 as ttp2  # noqa: E402

CPU = ["--device", "cpu"]
TINY_VQ = ["--device", "cpu", "--dataset", "synthetic-32-64",
           "--hidden_dims", "8", "16", "--embedding_dim", "8",
           "--num_embeddings", "16", "--batch_size", "16", "--epochs", "1",
           "--skip_pixelcnn", "--skip_final_metrics"]
SNAIL = ["--prior_type", "pixelsnail", "--pixelsnail_num_blocks", "1",
         "--pixelsnail_num_heads", "2", "--hidden_channels", "8",
         "--epochs", "1", "--num_samples", "4"]
CNN = ["--num_layers", "2", "--hidden_channels", "8", "--epochs", "1",
       "--num_samples", "4", "--max_gen_metrics_samples", "0"]


def _train(arch, root):
    tmain.main(tmain.parse_args(TINY_VQ + ["--arch", arch, "--save_path",
                                           str(root)]))
    (path,) = glob.glob(os.path.join(str(root), "**", "final_checkpoint.pth"),
                        recursive=True)
    return path


@pytest.fixture(scope="module")
def flat(tmp_path_factory):
    """A tiny VQ-VAE run and a PixelSNAIL prior trained over it by
    ``train_prior_vqvae`` with 8-sample generative metrics."""
    from movae_tpu_torch.metrics import features as tf

    ckpt = _train("vq_vae", tmp_path_factory.mktemp("flat"))
    fid = tf.fid_from_features
    tf.fid_from_features = lambda a, b, eps=1e-6: fid(a[:, :4], b[:, :4], eps)
    try:
        out = ttp.main(["--model_path", ckpt, "--max_gen_metrics_samples",
                        "8"] + SNAIL + CPU)
    finally:
        tf.fid_from_features = fid
    return ckpt, out


@pytest.fixture(scope="module")
def hier(tmp_path_factory):
    """A tiny VQ-VAE-2 run and a HierarchicalPixelCNN trained over it by
    ``train_prior_vqvae2``."""
    ckpt = _train("vq_vae2", tmp_path_factory.mktemp("hier"))
    return ckpt, ttp2.main(["--vqvae2_checkpoint", ckpt] + CNN + CPU)


def _root(ckpt):
    return os.path.dirname(os.path.dirname(ckpt))


def test_train_prior_vqvae_writes_the_jax_run_tree(flat):
    """The prior's checkpoints, log, code cache and sample grid land where
    the JAX CLI puts them; typed flags win over the saved args, the saved
    args over the parser's defaults; final/* in the prior's summary."""
    ckpt, out = flat
    root = _root(ckpt)
    assert out["save_root"] == root
    for name in ("best_prior", "final_prior", "last_prior"):
        assert os.path.exists(os.path.join(root, "pixelsnail_prior",
                                           "checkpoints", f"{name}.pth"))
    for ext in ("pdf", "png"):
        assert os.path.exists(os.path.join(root, "figures", "generated",
                                           f"prior_samples.{ext}"))
    assert glob.glob(os.path.join(root, "codes_cache", "*", "codes.npy"))
    merged = out["merged"]
    assert merged.prior_type == "pixelsnail"
    assert merged.pixelcnn_hidden_channels == 8
    assert merged.batch_size == 16  # saved by the VQ run, not the 128 default
    assert len(out["prior"]["model"].blocks) == 1
    with open(os.path.join(root, "pixelsnail_prior", "wandb_local",
                           "summary.json")) as f:
        summary = json.load(f)
    for key in ("gfid", "kid"):
        assert np.isfinite(out["finals"][key]), key
        assert summary[f"final/{key}"] == out["finals"][key]


def test_train_prior_vqvae2_writes_the_hierarchical_prior(hier):
    ckpt, out = hier
    root = _root(ckpt)
    assert out["prior"]["hierarchical"]
    for name in ("best_prior", "final_prior"):
        assert os.path.exists(os.path.join(root, "pixelcnn_prior",
                                           "checkpoints", f"{name}.pth"))
    assert glob.glob(os.path.join(root, "codes_cache", "*", "top.npy"))
    assert os.path.exists(os.path.join(root, "figures", "generated",
                                       "prior_samples.png"))
    assert out["finals"] == {}  # --max_gen_metrics_samples 0 typed


def test_hierarchical_cli_refuses_a_flat_arch(flat):
    with pytest.raises(ValueError, match="vq_vae is not hierarchical"):
        ttp2.main(["--model_path", flat[0]] + CNN + CPU)


def _generate(ckpt, prior, out, *flags):
    return tgen.main(["--model_path", ckpt, "--prior_path", prior,
                      "--out_dir", str(out), "--num_samples", "3",
                      "--seed", "5"] + list(flags) + CPU)


def _check_images(imgs, n):
    assert imgs.shape == (n, 32, 32, 3)
    assert np.isfinite(imgs).all() and np.abs(imgs).max() <= 1.0


@pytest.mark.parametrize("flags,files", [
    ((), ["samples.pdf", "samples.png"]),
    (("--individual",), [f"sample_{i:05d}.png" for i in range(3)])])
def test_hierarchical_generator_from_checkpoints(hier, tmp_path, flags,
                                                 files):
    """The VQ-VAE-2 twin rebuilds both models from their checkpoints,
    samples (the int8 default KV cache has no effect on a PixelCNN) and
    writes a grid or per-image PNGs; the same seed gives the same images
    bit for bit."""
    ckpt = hier[0]
    prior = os.path.join(_root(ckpt), "pixelcnn_prior", "checkpoints",
                         "best_prior.pth")
    argv = ["--vqvae2_checkpoint", ckpt, "--prior_checkpoint", prior,
            "--output_dir", str(tmp_path), "--num_samples", "3", *flags]
    first = tgen2.main(argv + CPU)
    again = tgen2.main(argv + CPU)
    assert sorted(os.listdir(tmp_path)) == sorted(files)
    _check_images(first["images"], 3)
    np.testing.assert_array_equal(first["images"], again["images"])


@pytest.mark.parametrize("kv", ["f32", "int8"])
def test_flat_generator_kv_cache_dtypes(flat, tmp_path, kv):
    """The flat generator on the PixelSNAIL prior at each KV cache dtype:
    in range, and equal bit for bit on a second run with the seed."""
    ckpt = flat[0]
    prior = os.path.join(_root(ckpt), "pixelsnail_prior", "checkpoints",
                         "best_prior.pth")
    first = _generate(ckpt, prior, tmp_path / "a", "--kv_cache_dtype", kv,
                      "--individual")
    again = _generate(ckpt, prior, tmp_path / "b", "--kv_cache_dtype", kv,
                      "--individual")
    _check_images(first["images"], 3)
    np.testing.assert_array_equal(first["images"], again["images"])
    assert len(first["paths"]) == 3


def test_generator_samples_under_deterministic_cudnn(flat, tmp_path,
                                                    monkeypatch):
    """The generation runs under cuDNN's deterministic algorithms without
    autotuning (so that a seed repeats its images on the card too), and
    the flags are restored after."""
    import torch

    ckpt = flat[0]
    prior = os.path.join(_root(ckpt), "pixelsnail_prior", "checkpoints",
                         "best_prior.pth")
    cudnn = torch.backends.cudnn
    before = cudnn.deterministic, cudnn.benchmark
    seen = []

    def fake(*a, **kw):
        seen.append((cudnn.deterministic, cudnn.benchmark))
        return np.zeros((1, 32, 32, 3), np.float32)

    monkeypatch.setattr(tgen, "generate_samples", fake)
    cudnn.benchmark = True
    try:
        _generate(ckpt, prior, tmp_path, "--num_samples", "1")
        assert seen == [(True, False)]
        assert (cudnn.deterministic, cudnn.benchmark) == (before[0], True)
    finally:
        cudnn.deterministic, cudnn.benchmark = before


def test_generator_inherits_the_prior_checkpoint_hyperparameters(flat):
    """The prior is rebuilt from the checkpoint's echoed prior_args alone;
    an explicit flag wins over them."""
    ckpt = flat[0]
    prior = os.path.join(_root(ckpt), "pixelsnail_prior", "checkpoints",
                         "best_prior.pth")
    _, _, p = tgen.load_models(ckpt, prior, device="cpu")
    assert p["args"].prior_type == "pixelsnail"
    assert len(p["model"].blocks) == 1 and not p["hierarchical"]
    with pytest.raises(RuntimeError):  # 2 blocks do not fit 1 block's state
        tgen.load_models(ckpt, prior, prior_args={"pixelsnail_num_blocks": 2},
                         device="cpu")


def _saved_args(ckpt):
    from movae_tpu_torch.train import checkpoint as ckpt_lib

    return SimpleNamespace(**ckpt_lib.load_checkpoint(ckpt)["args"])


@pytest.mark.parametrize("extra", [
    [],  # untyped defaults must not clobber the saved args
    ["--batch_size", "8", "--seed", "3"],  # typed flags override them
    ["--epochs", "3", "--lr", "1e-3", "--hidden_channels", "16",
     "--no_prior_lmdb_codes", "--device", "cpu"]])  # aliases, store_false
def test_flag_merging_matches_jax(flat, extra):
    ckpt = flat[0]
    argv = ["--vqvae_checkpoint", ckpt] + extra
    jparser, tparser = (jtp.build_prior_parser("vqvae_checkpoint"),
                        ttp.build_prior_parser("vqvae_checkpoint"))
    jexp = jtp.explicit_cli_args(jparser, argv)
    texp = ttp.explicit_cli_args(tparser, argv)
    assert texp == jexp
    saved = _saved_args(ckpt)
    jm = vars(jtp.merge_cli_over_saved(saved, jparser.parse_args(argv), jexp))
    tm = vars(ttp.merge_cli_over_saved(saved, tparser.parse_args(argv), texp))
    # --device is "(ignored)" with no default in the JAX CLI; the saved
    # device ("cpu") wins over the port's "cuda" default
    assert tm == jm
    assert tm["batch_size"] == (8 if "--batch_size" in extra else 16)
    assert tm["seed"] == (3 if "--seed" in extra else saved.seed)
    assert tm["pixelcnn_epochs"] == (3 if "--epochs" in extra else 100)
    assert tm["prior_use_lmdb_codes"] == ("--no_prior_lmdb_codes"
                                          not in extra)


def test_wandb_id_without_wandb_raises(monkeypatch):
    """--wandb_id imports wandb, in both packages, and raises without
    it."""
    monkeypatch.setitem(sys.modules, "wandb", None)
    ns = SimpleNamespace(model_path=None, wandb_id="abc123",
                         wandb_project="mo-vae", wandb_entity=None)
    for resolve in (jtp.resolve_checkpoint, ttp.resolve_checkpoint):
        with pytest.raises(ImportError):
            resolve(ns)
    with pytest.raises(ImportError):
        ttp.main(["--wandb_id", "abc123"] + CPU)


@pytest.mark.parametrize("flags,axis", [
    (["--batch_sizes", "16", "32"], [16, 32]),
    (["--batch_size", "16", "--workers", "1", "0"], [1, 0])])
def test_benchmark_workers_sweeps(flags, axis, capsys):
    rows = tbw.main(["--dataset", "synthetic-32-64", "--num_batches", "2",
                     "--num_runs", "2", "--warmup", "1"] + flags + CPU)
    assert [r[0] for r in rows] == axis
    for cell, mean, std, ips in rows:
        assert mean > 0 and std >= 0 and ips > 0
    assert "img/s" in capsys.readouterr().out


@pytest.mark.parametrize("cli,argv", [
    (ttp.main, ["--model_path", "x.pth"]),
    (ttp2.main, ["--model_path", "x.pth"]),
    (tgen.main, ["--model_path", "x.pth", "--prior_path", "p.pth"]),
    (tgen2.main, ["--model_path", "x.pth", "--prior_path", "p.pth"]),
    (tbw.main, ["--dataset", "synthetic-32-64"])])
def test_device_defaults_to_cuda_with_no_fall_back(cli, argv):
    """Without --device every CLI asks for the card, and raises where
    there is none."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        cli(argv)
