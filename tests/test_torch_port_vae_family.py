"""The rest of the port's VAE family against the JAX package: the Beta-TC
VAE (``movae_tpu_torch/models/betatc_vae.py``), the cycle VAE and the
recursive-KL and recursive-cyclic VAEs (``cycle_vae.py``,
``recursive_kl_vae.py``, ``recursive_cyclic_vae.py``), their anneal
counters, checkpoints and resume.

The harness (seeded inputs, the JAX init loaded into the port, JAX's noise
read from its ``sample`` stream and given to the port) and the tolerances
are those of tests/test_torch_port_vae.py: forward outputs and losses
within 1e-5 (1e-6 absolute for losses); locksteps hold losses and
aggregator weights within 2e-4 relative (2e-5 absolute) and every
parameter and running statistic within 5e-4 after each step; anneal
counters exactly; weight mappings bit for bit.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_torch_port_vae import (  # noqa: E402
    NORMS, SIZE, as_np, assert_jax_reads_port_checkpoint,
    assert_nonfinite_batch_leaves_state, build_pair, images, port_state,
    run_lockstep, spy_normal, state_dict_of, take_noise)

COUNTER_ARCHS = ("betatc_vae", "recursive_kl_vae", "recursive_cyclic_vae")


@pytest.mark.parametrize("layer_norm", NORMS)
def test_betatc_state_dict_equals_jax_export_bit_for_bit(layer_norm):
    """(Beta-TC has no norm: ``layer_norm`` must not change its layout.)"""
    from movae_tpu.utils.torch_export import export_torch_state_dict
    from movae_tpu_torch.utils.weights import betatc_state_dict

    _, params, bstats, tm = build_pair(arch="betatc_vae",
                                       layer_norm=layer_norm)
    assert "num_iter" in bstats
    ref = export_torch_state_dict(params, bstats, "betatc_vae")
    got = betatc_state_dict(params, bstats)
    assert list(got) == list(ref)
    assert set(tm.state_dict()) == set(ref) | {"num_iter"}
    for k in ref:
        assert got[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
        np.testing.assert_array_equal(tm.state_dict()[k].numpy(), ref[k],
                                      err_msg=k)


@pytest.mark.parametrize("arch", ["cycle_vae", "recursive_kl_vae",
                                  "recursive_cyclic_vae"])
def test_shared_trunk_state_dict_equals_jax_export_bit_for_bit(arch):
    from movae_tpu.utils.torch_export import export_torch_state_dict
    from movae_tpu_torch.utils.weights import vae_state_dict

    _, params, bstats, tm = build_pair(arch=arch)
    ref = export_torch_state_dict(params, bstats, arch)
    got = vae_state_dict(params, bstats)
    assert list(got) == list(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
        np.testing.assert_array_equal(tm.state_dict()[k].numpy(), ref[k],
                                      err_msg=k)


@pytest.mark.parametrize("arch", ["betatc_vae", "btc_vae", "cycle_vae",
                                  "recursive_kl_vae", "recursive_cyclic_vae",
                                  "rc_vae"])
@pytest.mark.parametrize("layer_norm", NORMS)
@pytest.mark.parametrize("train", [True, False])
def test_forward_losses_stats_and_counter_match_jax(arch, layer_norm, train,
                                                   monkeypatch):
    """One forward in each mode: outputs, weighted losses (the anneal at
    its first train step, 1 in eval), the new running statistics from every
    encoder pass and the counter, returned and not written."""
    jm, params, bstats, tm = build_pair(seed=1, arch=arch,
                                        layer_norm=layer_norm)
    drawn = spy_normal(monkeypatch)
    x = images(2)
    (j_vec, j_dict, j_out), mut = jm.apply(
        {"params": params, "batch_stats": bstats}, jnp.asarray(x),
        train=train, method="forward_with_losses", mutable=["batch_stats"],
        rngs={"sample": jax.random.PRNGKey(0)})
    noise = take_noise(drawn, 0, arch)
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    with torch.no_grad():
        t_vec, t_dict, t_out = tm.forward_with_losses(
            torch.tensor(x), train=train, noise=noise)
    for key in ("recons", "mu", "log_var", "z", "mu_hat", "log_var_hat",
                "z_prior", "x_gen", "mu_gen", "log_var_gen"):
        if key in j_out:
            np.testing.assert_allclose(t_out[key].numpy(),
                                       np.asarray(j_out[key]), rtol=1e-5,
                                       atol=1e-5, err_msg=key)
    np.testing.assert_allclose(t_vec.numpy(), np.asarray(j_vec), rtol=1e-5,
                               atol=1e-6)
    for key in (*jm.objective_names, "total_loss"):
        np.testing.assert_allclose(float(t_dict[key]), float(j_dict[key]),
                                   rtol=1e-5, atol=1e-6, err_msg=key)
    for k, v in tm.state_dict().items():
        assert torch.equal(v, before[k]), k
    jbs = as_np(mut["batch_stats"])
    stats = t_out.get("batch_stats", {})
    if not train:
        assert not stats
        return
    ref = state_dict_of(arch, params, jbs)
    for k, v in stats.items():
        if k == "num_iter":
            assert float(v) == float(jbs["num_iter"]) == 1.0
        else:
            np.testing.assert_allclose(v.numpy(), ref[k], rtol=0, atol=1e-6,
                                       err_msg=k)
    want = {k for k in ref if k.endswith(("_mean", "_var"))}
    if "num_iter" in jbs:
        want.add("num_iter")
    assert set(stats) == want


@pytest.mark.parametrize("arch,agg", [
    ("betatc_vae", "aligned_mtl"), ("cycle_vae", "mgda"),
    ("recursive_kl_vae", "upgrad"), ("recursive_cyclic_vae", "mgda")])
def test_train_lockstep_matches_jax(arch, agg, monkeypatch):
    """Beta-TC in feature mode; the cycle and recursive VAEs in full mode
    (full-parameter Jacobian, the encoder run two or three times)."""
    tm = run_lockstep(monkeypatch, arch, agg, anneal_steps=4,
                      recursive_kld_anneal_steps=4)
    assert (tm.feature_names is None) == (arch != "betatc_vae")


def test_anneal_reaches_one_and_eval_leaves_the_counter():
    from movae_tpu_torch.models import get_network, init_model

    tm = init_model(get_network(SIZE, 3, dict(
        arch="recursive_kl_vae", hidden_dims=(8, 16), latent_dim=8,
        recursive_kld_anneal_steps=2)), 0, device="cpu")
    x = torch.tensor(images(0))
    for n, want in ((1, 0.5), (2, 1.0), (3, 1.0)):
        out = tm(x, train=True)
        assert float(tm._anneal(out, 2)) == want
        tm.commit_batch_stats(out["batch_stats"])
        assert float(tm.num_iter) == n
    out = tm(x, train=False)
    assert tm._anneal(out, 2) == 1.0 and "batch_stats" not in out
    assert float(tm.num_iter) == 3


@pytest.mark.parametrize("arch,agg", [("recursive_kl_vae", "upgrad"),
                                      ("betatc_vae", "sum")])
def test_nonfinite_batch_leaves_weights_and_counter(arch, agg):
    _, _, _, tm = build_pair(seed=12, arch=arch)
    state = assert_nonfinite_batch_leaves_state(tm, agg)
    assert float(state.model.num_iter) == 2.0


@pytest.mark.parametrize("arch", COUNTER_ARCHS)
def test_jax_loads_a_port_written_checkpoint(arch, tmp_path, monkeypatch):
    """The counter rides beside the reference keys (``ema_state``) and the
    JAX package reads the rest."""
    jm, _, _, tm = build_pair(seed=6, arch=arch)
    state, step = port_state(tm, "sum")
    for i in range(2):
        step(state, torch.tensor(images(i)), torch.Generator().manual_seed(i))
    assert float(tm.num_iter) == 2.0
    assert_jax_reads_port_checkpoint(tm, jm, arch, tmp_path, monkeypatch)


def test_resume_continues_the_counter_and_statistics(tmp_path):
    """Resuming a recursive-cyclic VAE from epoch 1's last_checkpoint.pth
    continues its anneal counter, BatchNorm statistics, weights and
    generator (the N(0, I) draws): epoch 2 ends bit for bit where the
    unbroken run's does."""
    from movae_tpu_torch import main as tmain
    from movae_tpu_torch.train import loop as tloop

    common = ["--dataset", "synthetic-32-64", "--arch",
              "recursive_cyclic_vae", "--hidden_dims", "8", "16",
              "--latent_dim", "8", "--batch_size", "16", "--seed", "3",
              "--device", "cpu", "--epochs", "2", "--save_freq", "1",
              "--aggregator", "upgrad", "--num_vis_samples", "2",
              "--recursive_kld_anneal_steps", "6"]
    full = tloop.run_training(tmain.parse_args(
        common + ["--save_path", str(tmp_path / "full")]))
    last = os.path.join(full["save_root"], "checkpoints",
                        "last_checkpoint.pth")
    payload = torch.load(last, weights_only=False)
    assert payload["epoch"] == 1 and payload["step"] == 4
    assert float(payload["ema_state"]["num_iter"]) == 4.0
    assert "num_iter" not in payload["model_state_dict"]
    resumed = tloop.run_training(tmain.parse_args(
        common + ["--save_path", str(tmp_path / "res"), "--resume", last]))
    assert resumed["train_losses"][0] == full["train_losses"][1]
    a = full["model"].state_dict()
    b = resumed["model"].state_dict()
    assert float(a["num_iter"]) == float(b["num_iter"]) == 8.0
    for k in a:
        assert torch.equal(a[k], b[k]), k
