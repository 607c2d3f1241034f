"""Port gradient-guided VQ models (movae_tpu_torch/ops/sobel.py,
models/gg_vq_vae.py v1-v8, models/gg_vq_vae2.py and their registry
branches) against the JAX package: the Sobel losses, each version's
objective order and default weights with the EMA codebook on and off, the
forward losses on the same weights, and 6-step train locksteps of
``gg_vq_vae_v3`` (mgda_ln) and ``gg_vq_vae2`` (aligned_mtl) at a small
width.

The weights are the VQ-VAE's and the VQ-VAE-2's, so the pairs come from
tests/test_torch_port_vqvae.py and tests/test_torch_port_vqvae2.py. The
losses agree within 1e-5 relative (float32 sums over the image in two
frameworks); the locksteps hold tests/test_torch_port_step.py's
tolerances. ``edge_matching_binary`` thresholds magnitudes at 0.5 and the
angle and cosine losses divide by magnitudes: the test images are checked
to keep every magnitude 1e-5 away from the threshold (float32 rounds
them by ~1e-6), and the Sobel
gradients away from zero, so float32 rounding cannot flip a comparison.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import test_torch_port_vqvae as v1  # noqa: E402
import test_torch_port_vqvae2 as v2  # noqa: E402
from movae_tpu.ops import sobel as jsobel  # noqa: E402
from movae_tpu_torch.ops import sobel as tsobel  # noqa: E402

GG_VQ = ["gg_vq_vae"] + [f"gg_vq_vae_v{i}" for i in range(1, 9)]
LOSSES = ["edge_weighted_pixel_loss"] + sorted(
    f.__name__ for f in jsobel.GG_VQVAE_EDGE_FNS.values())


def _images():
    x, y = v1.images(31), v1.images(32)
    for img in (x, y):
        gx, gy = jsobel.sobel_gradients(jnp.asarray(img))
        mag = np.sqrt(np.asarray(gx) ** 2 + np.asarray(gy) ** 2 + 1e-8)
        assert np.abs(mag - 0.5).min() > 1e-5
        assert np.abs(np.asarray(gx)).min() > 0 or np.abs(
            np.asarray(gy)).min() > 0
    return x, y


def test_sobel_gradients_match_jax():
    x, _ = _images()
    gx, gy = tsobel.sobel_gradients(torch.tensor(x))
    jx, jy = jsobel.sobel_gradients(jnp.asarray(x))
    np.testing.assert_allclose(gx.numpy(), np.asarray(jx), rtol=0, atol=1e-6)
    np.testing.assert_allclose(gy.numpy(), np.asarray(jy), rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", LOSSES)
def test_sobel_losses_match_jax(name):
    x, y = _images()
    for a, b in ((x, y), (y, x), (x, x)):
        want = float(getattr(jsobel, name)(jnp.asarray(a), jnp.asarray(b)))
        got = float(getattr(tsobel, name)(torch.tensor(a), torch.tensor(b)))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7,
                                   err_msg=name)


def test_edge_table_matches_jax():
    assert {k: f.__name__ for k, f in tsobel.GG_VQVAE_EDGE_FNS.items()} == {
        k: f.__name__ for k, f in jsobel.GG_VQVAE_EDGE_FNS.items()}


@pytest.mark.parametrize("arch", GG_VQ + ["gg_vq_vae2"])
def test_objective_order_and_defaults_match_jax(arch):
    """Objective order, default and positional lambda weights and features,
    with the EMA codebook off and on."""
    from movae_tpu.models import get_network as jget
    from movae_tpu_torch.models import get_network

    mod = v2 if arch == "gg_vq_vae2" else v1
    args = mod.vq2_args if mod is v2 else mod.vq_args
    for ema in (False, True):
        jm = jget(mod.SIZE, 3, args(arch=arch, vq_ema=ema))
        tm = get_network(mod.SIZE, 3, args(arch=arch, vq_ema=ema))
        assert tm.objective_names == jm.objective_names
        assert tm.lambda_weights == jm.lambda_weights
        assert tm.feature_names == jm.feature_names
        n = len(jm.objective_names)
        listed = [0.5 + i for i in range(n)]
        assert get_network(mod.SIZE, 3, args(
            arch=arch, vq_ema=ema, lambda_weights=listed)).lambda_weights \
            == jget(mod.SIZE, 3, args(arch=arch, vq_ema=ema,
                                      lambda_weights=listed)).lambda_weights
        with pytest.raises(ValueError):
            get_network(mod.SIZE, 3, args(arch=arch, vq_ema=ema,
                                          lambda_weights=listed + [1.0]))


@pytest.mark.parametrize("arch", GG_VQ + ["gg_vq_vae2"])
def test_forward_losses_match_jax(arch):
    mod = v2 if arch == "gg_vq_vae2" else v1
    jm, params, bstats, tm = mod.build_pair(seed=5, arch=arch)
    x = mod.images(6)
    j_vec, j_dict, _ = jm.apply({"params": params, "batch_stats": bstats},
                                jnp.asarray(x), train=True,
                                method="forward_with_losses",
                                rngs={"sample": jax.random.PRNGKey(0)})
    with torch.no_grad():
        t_vec, t_dict, _ = tm.forward_with_losses(torch.tensor(x), train=True)
    assert set(t_dict) == set(j_dict)
    np.testing.assert_allclose(t_vec.numpy(), np.asarray(j_vec), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(float(t_dict["total_loss"]),
                               float(j_dict["total_loss"]), rtol=1e-5)


# Aligned-MTL's weights on the GG-VQ-VAE-2's five-objective feature
# Gramian: its smallest kept eigenvalue is ~1e-8 of a largest ~2e-4
# (condition ~1e4), where a float32 eigh is off by ~1e-3 of the largest
# weight in either framework (measured against float64 on the same G), so
# the two frameworks' weights part by up to ~9e-4 of the largest from step
# 1 on while losses and parameters stay at 3e-5 and 4e-7. The weights are
# held within 2e-3 of the largest weight, of JAX's and of a float64 solve
# on the port's own Gramian (ROADMAP.md Queue 3, which also records why
# upgrad on this model is not held in a lockstep).
EIGH_F32_TOL = 2e-3


@pytest.mark.parametrize("arch,agg", [("gg_vq_vae_v3", "mgda_ln"),
                                      ("gg_vq_vae2", "aligned_mtl")])
def test_train_lockstep_matches_jax(arch, agg, monkeypatch):
    """6 steps from one init on one batch stream, at
    tests/test_torch_port_step.py's tolerances; Aligned-MTL's task weights
    at EIGH_F32_TOL."""
    from movae_tpu.moo import AggregatorConfig as JCfg
    from movae_tpu.moo import init_state as jinit
    from movae_tpu.train.optim import build_optimizer as jbuild
    from movae_tpu.train.state import TrainState as JState
    from movae_tpu.train.step import make_train_step as jmake
    from movae_tpu.utils.torch_export import export_torch_state_dict
    from movae_tpu_torch.moo import AggregatorConfig, aggregators, init_state
    from movae_tpu_torch.train.optim import build_optimizer
    from movae_tpu_torch.train.state import TrainState
    from movae_tpu_torch.train.step import make_train_step

    mod = v2 if arch == "gg_vq_vae2" else v1
    steps, lr, eps = 6, 1e-3, 1e-4
    jm, params, bstats, tm = mod.build_pair(seed=7, arch=arch)
    m = len(jm.objective_names)
    jcfg = JCfg(name=agg, num_objectives=m)
    jstate = JState.create(jm.apply, params, bstats,
                           jbuild("adam", lr, eps=eps), jinit(jcfg))
    jstep = jax.jit(jmake(jm, jcfg, 1, steps))
    tcfg = AggregatorConfig(name=agg, num_objectives=m)
    tstate = TrainState.create(tm, build_optimizer("adam", lr, eps=eps),
                               init_state(tcfg))
    tstep = make_train_step(tm, tcfg, 1, steps)
    grams = []
    weights_fn = aggregators.compute_weights

    def seen(cfg, G, *a, **kw):
        grams.append(G.detach().double())
        return weights_fn(cfg, G, *a, **kw)

    monkeypatch.setattr(aggregators, "compute_weights", seen)
    export_arch = "vq_vae2" if arch == "gg_vq_vae2" else "vq_vae"
    rng = jax.random.PRNGKey(8)
    for i in range(steps):
        xb = mod.images(300 + i)
        rng, sub = jax.random.split(rng)
        jstate, jmet = jstep(jstate, jnp.asarray(xb), sub)
        tstate, tmet = tstep(tstate, torch.tensor(xb))
        for key in ("total_loss", *jm.objective_names):
            np.testing.assert_allclose(float(tmet[key]), float(jmet[key]),
                                       rtol=2e-4, atol=2e-5,
                                       err_msg=f"step {i} {key} ({arch})")
        got = np.array([float(tmet[f"task_{j}_weight"]) for j in range(m)])
        want = np.array([float(jmet[f"task_{j}_weight"]) for j in range(m)])
        if agg == "aligned_mtl":
            exact = aggregators._aligned_mtl_alpha(
                grams[-1], torch.full((m,), 1.0 / m, dtype=torch.float64),
                "min").numpy()
            for ref in (want, exact):
                atol = EIGH_F32_TOL * float(np.abs(ref).max())
                np.testing.assert_allclose(got, ref, rtol=0, atol=atol,
                                           err_msg=f"step {i} weights")
        else:
            np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5,
                                       err_msg=f"step {i} weights")
        np.testing.assert_allclose(
            float(tmet["codebook_usage_percentage"]),
            float(jmet["codebook_usage_percentage"]))
        assert float(tmet["skipped_nonfinite"]) == 0.0
        ref = export_torch_state_dict(jstate.params, {}, export_arch)
        got = tm.state_dict()
        delta = max(float(np.max(np.abs(np.asarray(v) - got[k].numpy())))
                    for k, v in ref.items())
        assert delta < 5e-4, f"step {i}: max param divergence {delta:.2e}"
    assert tstate.step == int(jstate.step) == steps
