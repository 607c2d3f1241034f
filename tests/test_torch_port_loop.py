"""The port's training loop (``movae_tpu_torch/train/loop.py``), eval step,
checkpoints, preemption and the prior stage's host side against the JAX
package, on the same seeded numpy inputs at a small size.

The slice as a whole: a 2-epoch ``run_training`` of a tiny ``vq_vae`` under
``sum`` in each package, from the same weights (the JAX init, loaded into
the port) on the same synthetic set, gives the same per-epoch train and
eval losses within 1e-4 relative, and the JAX package loads the port's
``final_checkpoint.pth`` and computes the port's forward.
"""

import dataclasses
import glob
import os
import signal
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import main as jmain  # noqa: E402
import runner as jrunner  # noqa: E402
from movae_tpu_torch import main as tmain  # noqa: E402
from movae_tpu_torch.train import loop as tloop  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
AGG_DIRS = sorted(str(p.relative_to(ROOT))
                  for p in ROOT.glob("configs/*/*/*") if p.is_dir())
TINY = ["--dataset", "synthetic-32-64", "--arch", "vq_vae", "--hidden_dims",
        "8", "16", "--embedding_dim", "8", "--num_embeddings", "16",
        "--batch_size", "16", "--normalize_inputs", "--seed", "3",
        "--eval_freq", "1"]


def test_agg_dirs_found():
    assert len(AGG_DIRS) > 200


@pytest.mark.parametrize("agg_dir", AGG_DIRS)
def test_aggregator_config_matches_jax(agg_dir):
    """The first config of every configs/<dataset>/<arch>/<agg>/ directory:
    its argv through each package's parser, then
    ``aggregator_config_from_args``; every JAX field agrees."""
    from movae_tpu.train.loop import aggregator_config_from_args as jcfg

    path = sorted(glob.glob(str(ROOT / agg_dir / "**" / "*.yaml"),
                            recursive=True))[0]
    argv = jrunner.yaml_to_args(jrunner.load_yaml_config(path))
    got = tloop.aggregator_config_from_args(tmain.parse_args(argv), 3)
    want = jcfg(jmain.parse_args(argv), 3)
    for f in dataclasses.fields(want):
        assert getattr(got, f.name) == getattr(want, f.name), f.name


def _jax_pair(arch, seed=2, **kw):
    from movae_tpu.models import get_network as jget, init_model as jinit
    from movae_tpu_torch.models import get_network, init_model
    from movae_tpu_torch.utils.weights import load_jax_params

    cfg = dict(arch=arch, embedding_dim=8, num_embeddings=16,
               hidden_dims=(8, 16), num_residual_layers=1, **kw)
    jm = jget(32, 3, cfg)
    params, bstats = jinit(jm, jax.random.PRNGKey(seed), 32, 3)
    tm = init_model(get_network(32, 3, cfg), 0, device="cpu")
    as_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    load_jax_params(tm, as_np(params), as_np(bstats))
    return jm, params, bstats, tm


@pytest.mark.parametrize("arch", ["vq_vae", "vq_vae2"])
def test_eval_step_and_evaluate_match_jax(arch):
    """``make_eval_step`` (losses, used-code masks) on a uint8 batch, and
    ``evaluate`` over a loader with a wrap-padded tail (losses weighted by
    valid rows, exact usage), at the step test's tolerances."""
    from types import SimpleNamespace

    from movae_tpu.data import ArrayDataset as JDS, Loader as JLoader
    from movae_tpu.parallel.mesh import DataParallel, make_mesh
    from movae_tpu.train.loop import evaluate as jevaluate
    from movae_tpu.train.step import make_eval_step as jmake
    from movae_tpu_torch.data import ArrayDataset, Loader
    from movae_tpu_torch.train.step import make_eval_step

    jm, params, bstats, tm = _jax_pair(arch)
    imgs = np.random.default_rng(5).integers(0, 256, (20, 32, 32, 3),
                                             dtype=np.uint8)
    jfn = jax.jit(jmake(jm, normalize_inputs=True))
    tfn = make_eval_step(tm, normalize_inputs=True)
    jmet, jext, _ = jfn(params, bstats, jnp.asarray(imgs[:8]),
                        jax.random.PRNGKey(0))
    tmet, text, _ = tfn(imgs[:8])
    assert set(tmet) == set(jmet) and set(text) == set(jext)
    for k in jmet:
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]),
                                   rtol=2e-4, atol=2e-5, err_msg=k)
    for k in jext:
        np.testing.assert_array_equal(text[k].numpy(), np.asarray(jext[k]))

    state = SimpleNamespace(params=params, batch_stats=bstats)
    parallel = DataParallel(make_mesh(devices=jax.devices()[:1]))
    jmeters, _ = jevaluate(jfn, state,
                           JLoader(JDS(imgs), 8, raw=True), parallel,
                           jax.random.PRNGKey(0), jm.objective_names)
    tmeters = tloop.evaluate(tfn, Loader(ArrayDataset(imgs), 8, raw=True),
                             tm.objective_names)
    assert set(tmeters) == set(jmeters)
    for k in jmeters:
        np.testing.assert_allclose(tmeters[k].avg, jmeters[k].avg,
                                   rtol=2e-4, atol=2e-5, err_msg=k)
        assert tmeters[k].count == jmeters[k].count


def _jax_init_into_port(monkeypatch, jargs):
    """Make the port's run start from the JAX run's init (the JAX package
    seeds its flax init from ``PRNGKey(seed)``, split once)."""
    from movae_tpu.models import get_network as jget, init_model as jinit
    from movae_tpu_torch.utils.weights import load_jax_params

    jm = jget(32, 3, jargs)
    _, init_rng = jax.random.split(jax.random.PRNGKey(jargs.seed))
    params, bstats = jinit(jm, init_rng, 32, 3, batch_size=2)
    as_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731

    def init_model(model, seed=0, device=None):
        load_jax_params(model, as_np(params), as_np(bstats))
        return model.to(device)

    monkeypatch.setattr(tloop, "init_model", init_model)
    return jm


def test_run_training_matches_jax(tmp_path, monkeypatch):
    """Two epochs of 4 steps of a tiny vq_vae under sum, in each package:
    per-epoch train and eval losses within 1e-4 relative; the JAX package
    loads the port's final_checkpoint.pth and computes its forward within
    1e-5."""
    from movae_tpu.train.checkpoint import load_checkpoint
    from movae_tpu.train.loop import run_training as jrun

    common = TINY + ["--epochs", "2", "--save_freq", "2",
                     "--num_vis_samples", "2"]
    jargs = jmain.parse_args(common + ["--save_path", str(tmp_path / "j")])
    targs = tmain.parse_args(common + ["--save_path", str(tmp_path / "t"),
                                       "--device", "cpu"])
    jm = _jax_init_into_port(monkeypatch, jargs)
    want = jrun(jargs)
    got = tloop.run_training(targs)
    for split in ("train_losses", "eval_losses"):
        assert len(got[split]) == len(want[split]) == 2
        for g, w in zip(got[split], want[split]):
            assert set(g) == set(w)
            for k in w:
                np.testing.assert_allclose(g[k], w[k], rtol=1e-4, atol=1e-7,
                                           err_msg=f"{split} {k}")

    payload = load_checkpoint(os.path.join(got["save_root"], "checkpoints",
                                           "final_checkpoint.pth"))
    sd = payload["model_state_dict"]
    x = np.random.default_rng(9).uniform(-1, 1, (4, 32, 32, 3)).astype(
        np.float32)
    jout = jm.apply({"params": sd["params"], "batch_stats": sd["batch_stats"]},
                    jnp.asarray(x), train=False,
                    rngs={"sample": jax.random.PRNGKey(0)})
    with torch.no_grad():
        tout = got["model"](torch.from_numpy(x), train=False)
    np.testing.assert_allclose(tout["recons"].numpy(),
                               np.asarray(jout["recons"]), rtol=0, atol=1e-5)
    assert payload["epoch"] == 2 and len(payload["eval_losses"]) == 2


def _snapshot(results):
    state = results["state"]
    opt = state.optimizer.state_dict()["state"]
    return ({k: v.clone() for k, v in state.model.state_dict().items()},
            {i: {k: v.clone() for k, v in s.items() if torch.is_tensor(v)}
             for i, s in opt.items()},
            state.step, state.tx.lr(state.step),
            {k: v.clone() for k, v in state.agg_state.items()})


def test_resume_continues_like_an_unbroken_run(tmp_path):
    """Resuming from epoch 1's last_checkpoint.pth continues the weights,
    the EMA codebook, Adam's moments, the step (so the cosine lr), the
    NashMTL state, the generator (EMA restarts) and the loader's epoch:
    epoch 2 ends bit for bit where the unbroken run's does."""
    common = TINY + ["--device", "cpu", "--epochs", "2", "--save_freq", "1",
                     "--aggregator", "nashmtl", "--vq_ema", "--scheduler",
                     "cosine", "--num_vis_samples", "2"]
    full = tloop.run_training(tmain.parse_args(
        common + ["--save_path", str(tmp_path / "full")]))
    last = os.path.join(full["save_root"], "checkpoints",
                        "last_checkpoint.pth")
    payload = torch.load(last, weights_only=False)
    assert payload["epoch"] == 1 and payload["step"] == 4
    resumed = tloop.run_training(tmain.parse_args(
        common + ["--save_path", str(tmp_path / "res"), "--resume", last]))
    assert len(resumed["train_losses"]) == 1
    assert resumed["train_losses"][0] == full["train_losses"][1]
    a, b = _snapshot(full), _snapshot(resumed)
    assert a[2] == b[2] == 8 and a[3] == b[3]
    for x, y in ((a[0], b[0]), (a[4], b[4])):
        assert x.keys() == y.keys()
        for k in x:
            assert torch.equal(x[k], y[k]), k
    for i in a[1]:
        for k in a[1][i]:
            assert torch.equal(a[1][i][k], b[1][i][k]), (i, k)


def test_sigterm_writes_last_checkpoint_and_exits_143(tmp_path, monkeypatch):
    """A SIGTERM during the first epoch: the step in flight finishes, the
    resumable last_checkpoint.pth (epoch 0, step 1) is written, and the run
    exits 143 with the default handler restored."""
    make = tloop.make_train_step

    def make_signalling(*a, **kw):
        step = make(*a, **kw)

        def signalling(state, batch, gen=None):
            out = step(state, batch, gen)
            os.kill(os.getpid(), signal.SIGTERM)
            return out
        return signalling

    monkeypatch.setattr(tloop, "make_train_step", make_signalling)
    before = signal.getsignal(signal.SIGTERM)
    args = tmain.parse_args(TINY + ["--device", "cpu", "--epochs", "2",
                                    "--save_path", str(tmp_path)])
    with pytest.raises(SystemExit) as exc:
        tloop.run_training(args)
    assert exc.value.code == 143
    assert signal.getsignal(signal.SIGTERM) == before
    (last,) = glob.glob(str(tmp_path / "**" / "last_checkpoint.pth"),
                        recursive=True)
    payload = torch.load(last, weights_only=False)
    assert payload["epoch"] == 0 and payload["step"] == 1
    assert {"optimizer_state_dict", "generator_state",
            "model_state_dict"} <= set(payload)


def _codes(n=12, grid=6, k=16, seed=7):
    return {"codes": np.random.default_rng(seed).integers(
        0, k, (n, grid, grid)).astype(np.int32)}


def test_prior_resume_and_sample_figures(tmp_path):
    """``last_prior.pth`` after epoch 1 of a 1-epoch run resumes into epoch
    2 of a 2-epoch run (the cosine's epoch-1 lr is the base lr either way)
    and ends where the unbroken 2-epoch run ends; ``prior_sample_every``
    writes prior_epoch_NNNN sample grids through the VQ model."""
    from types import SimpleNamespace

    from movae_tpu_torch.models import get_network, init_model
    from movae_tpu_torch.train.prior import train_prior

    vq = init_model(get_network(24, 3, dict(
        arch="vq_vae", embedding_dim=8, num_embeddings=16,
        hidden_dims=(8, 16), num_residual_layers=1)), 0, device="cpu")

    def args(epochs, **kw):
        return SimpleNamespace(prior_type="pixelcnn", batch_size=5, seed=1,
                               pixelcnn_epochs=epochs, pixelcnn_lr=1e-3,
                               pixelcnn_hidden_channels=8,
                               pixelcnn_num_layers=2, **kw)

    full = train_prior(_codes(), vq, args(2), device="cpu",
                       save_root=str(tmp_path / "full"))
    train_prior(_codes(), vq, args(1), device="cpu",
                save_root=str(tmp_path / "one"))
    last = tmp_path / "one" / "pixelcnn_prior" / "checkpoints" / \
        "last_prior.pth"
    resumed = train_prior(_codes(), vq, args(2, prior_sample_every=1),
                          device="cpu", save_root=str(tmp_path / "res"),
                          resume=str(last), vq_model=vq)
    want, got = full["model"].state_dict(), resumed["model"].state_dict()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    figs = tmp_path / "res" / "figures" / "generated"
    assert (figs / "prior_epoch_0002.pdf").exists()
    assert not (figs / "prior_epoch_0001.pdf").exists()  # resumed past it
    final = torch.load(tmp_path / "res" / "pixelcnn_prior" / "checkpoints"
                       / "final_prior.pth", weights_only=False)
    assert final["epoch"] == 2 and final["prior_args"]["prior_type"] == \
        "pixelcnn"


def test_long_sequence_weight_dropout_note_matches_jax(capsys):
    """The JAX package's note when weight-mode attention dropout meets
    L > 1024 (where dropout falls on the attention output): the same text
    from both packages, none at L <= 1024; the port's prior stage prints
    it when it trains on such a grid."""
    from movae_tpu.models.pixelcnn import (PixelSNAIL as JSnail,
                                           warn_long_seq_dropout as jwarn)
    from movae_tpu_torch.models.pixelcnn import warn_long_seq_dropout
    from movae_tpu_torch.train.prior import build_prior, train_prior

    from types import SimpleNamespace

    a = SimpleNamespace(prior_type="pixelsnail", pixelcnn_hidden_channels=8,
                        pixelsnail_num_blocks=1, pixelsnail_num_res_blocks=1,
                        pixelsnail_num_heads=2, pixelsnail_dropout=0.1,
                        attention_dropout="weights", batch_size=2, seed=0,
                        pixelcnn_epochs=1)
    tm = build_prior(a, 16, False, 8)
    jm = JSnail(num_embeddings=16, embedding_dim=8, hidden_channels=8,
                num_blocks=1, num_res_blocks_per_layer=1, num_heads=2,
                dropout=0.1, attn_dropout_mode="weights")
    for hw in ((33, 33), (32, 32)):
        jwarn(jm, *hw)
        want = capsys.readouterr().out
        warn_long_seq_dropout(tm, *hw)
        assert capsys.readouterr().out == want
        assert ("exceeds the dense threshold" in want) == (hw == (33, 33))
    train_prior(_codes(n=2, grid=33), SimpleNamespace(
        num_embeddings=16, embedding_dim=8), a, device="cpu")
    assert "L=1089) exceeds the dense threshold" in capsys.readouterr().out


@pytest.mark.parametrize("prior_type,hier", [
    ("pixelcnn", False), ("pixelsnail", False), ("pixelcnn", True),
    ("pixelsnail", True)])
def test_find_prior_reads_a_reference_prior_pth(tmp_path, prior_type, hier):
    """A prior .pth without an args echo (the reference's
    ``{epoch, model_state_dict, loss}``): the shapes read from its keys
    equal the JAX importer's, and ``find_prior`` rebuilds the prior beside
    a model checkpoint with its weights."""
    from types import SimpleNamespace

    from movae_tpu.utils.torch_import import load_reference_checkpoint
    from movae_tpu_torch.models import get_network, init_model
    from movae_tpu_torch.train.prior import (build_prior, find_prior,
                                             prior_args_from_state)

    a = SimpleNamespace(prior_type=prior_type, pixelcnn_hidden_channels=8,
                        pixelcnn_num_layers=3, pixelsnail_num_blocks=2,
                        pixelsnail_num_res_blocks=1, pixelsnail_num_heads=2)
    prior = build_prior(a, 16, hier, 8)
    prior.reset_parameters(torch.Generator().manual_seed(0))
    state = prior.state_dict()
    ckpts = tmp_path / f"{prior_type}_prior" / "checkpoints"
    ckpts.mkdir(parents=True)
    torch.save({"epoch": 1, "model_state_dict": state, "loss": 1.0},
               ckpts / "best_prior.pth")
    want = load_reference_checkpoint(str(ckpts / "best_prior.pth"))
    got = prior_args_from_state(state, hier)
    for k, v in want["prior_args"].items():
        assert got[k] == v, k

    vq_args = SimpleNamespace(arch="vq_vae2" if hier else "vq_vae",
                              embedding_dim=8, num_embeddings=16,
                              hidden_dims=(8, 16), num_residual_layers=1,
                              pixelsnail_num_heads=2)
    vq = init_model(get_network(32, 3, vq_args), 0, device="cpu")
    found = find_prior(str(tmp_path / "checkpoints" / "final.pth"), vq,
                       vq_args)
    assert found["hierarchical"] == hier
    for k, v in found["model"].state_dict().items():
        assert torch.equal(v, state[k]), k
