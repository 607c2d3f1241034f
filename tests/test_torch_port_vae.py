"""The port's VAE and gradient-guided VAE (``movae_tpu_torch/models/vae.py``,
``gg_vae.py``), their weight mapping (``utils/weights.py``), the registry
(``models/__init__.py``) and their train step against the JAX package, on
the same seeded inputs and the same weights.

The JAX model is initialized in flax; its params and batch statistics reach
the port through ``load_jax_params``. JAX draws the reparameterization's
noise from its ``sample`` stream, which torch cannot reproduce: the tests
read the draws JAX made (``jax.random.normal`` wrapped for the test's
duration, each draw handed out by an ordered debug callback) and give the
port the same ones through ``noise``.

Tolerances are those of tests/test_torch_port_step.py: forward outputs and
losses within 1e-5 (relative and absolute, 1e-6 absolute for losses);
locksteps hold losses and aggregator weights within 2e-4 relative (2e-5
absolute; for losses 2e-5 of the largest objective where that exceeds 1, the
scaling of tests/test_torch_port_aggregators.py: Beta-TC's KL term is the
difference of two terms of ~8) and every parameter within 5e-4 after each
step; BatchNorm
running statistics within STAT_TOL = 5e-4 and the anneal counters exactly.
Aligned-MTL's task weights are held as in tests/test_torch_port_gg.py:
within EIGH_F32_TOL = 2e-3 of the largest weight, of JAX's and of a
float64 solve on the port's own Gramian (a float32 ``eigh`` of an
ill-conditioned Gramian, ROADMAP.md Queue 3). Weight mappings are bit for
bit.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

SIZE = 16
HIDDEN = (8, 16)
LATENT = 8
BATCH = 4
STEPS, LR, EPS = 6, 1e-3, 1e-4
STAT_TOL = 5e-4
EIGH_F32_TOL = 2e-3
NORMS = ("batch", "layer", "none")
GG_ARCHS = ("gg_vae", "gg_vae_v2", "gg_vae_v3", "gg_vae_v5", "gg_vae_v6")
# the arch names of the VAE family and the N(0, I) draws of one forward,
# in the order both packages make them
DRAWS = {"vae": ("eps",), **{a: ("eps",) for a in GG_ARCHS},
         "betatc_vae": ("eps",), "btc_vae": ("eps",),
         "cycle_vae": ("eps", "z_prior"), "recursive_kl_vae": ("eps",),
         "recursive_cyclic_vae": ("eps", "z_prior"),
         "rc_vae": ("eps", "z_prior")}


def vae_args(**kw):
    args = dict(arch="vae", latent_dim=LATENT, hidden_dims=HIDDEN,
                batch_size=BATCH, dataset_size=64, recons_objective="mse",
                recons_activation="tanh", layer_norm="batch")
    args.update(kw)
    return args


def as_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def build_pair(seed=0, **kw):
    """The same model in both frameworks: (jax_model, params, batch_stats,
    port_model on the CPU)."""
    from movae_tpu.models import get_network as jget, init_model as jinit
    from movae_tpu_torch.models import get_network, init_model
    from movae_tpu_torch.utils.weights import load_jax_params

    jm = jget(SIZE, 3, vae_args(**kw))
    params, bstats = jinit(jm, jax.random.PRNGKey(seed), SIZE, 3)
    params, bstats = as_np(params), as_np(bstats)
    tm = init_model(get_network(SIZE, 3, vae_args(**kw)), seed, device="cpu")
    load_jax_params(tm, params, bstats)
    return jm, params, bstats, tm


def images(seed=0, n=BATCH):
    return np.random.default_rng(seed).uniform(
        -1, 1, (n, SIZE, SIZE, 3)).astype(np.float32)


def spy_normal(monkeypatch):
    """Wrap ``jax.random.normal`` so every draw (jitted or not) is also
    handed to the host, in program order."""
    drawn = []
    orig = jax.random.normal

    def normal(key, shape=(), dtype=jnp.float32, *args, **kw):
        out = orig(key, shape, dtype, *args, **kw)
        jax.debug.callback(lambda r: drawn.append(np.asarray(r)), out,
                           ordered=True)
        return out

    monkeypatch.setattr(jax.random, "normal", normal)
    return drawn


def take_noise(drawn, start, arch):
    """The draws of one JAX forward (or step) made after ``drawn[start]``,
    as the port's ``noise``. A step that traces the forward several times
    (one trace per objective) repeats the same draws: checked equal."""
    jax.effects_barrier()
    names = DRAWS[arch]
    new = drawn[start:]
    assert new and len(new) % len(names) == 0, (arch, len(new))
    for j in range(len(names), len(new)):
        np.testing.assert_array_equal(new[j], new[j % len(names)])
    return {n: torch.tensor(new[j]) for j, n in enumerate(names)}


def state_dict_of(arch, params, bstats):
    from movae_tpu_torch.utils import weights

    fn = (weights.betatc_state_dict if arch in ("betatc_vae", "btc_vae")
          else weights.vae_state_dict)
    return fn(params, bstats)


def jax_state(jm, params, bstats, agg):
    from movae_tpu.moo import AggregatorConfig, init_state
    from movae_tpu.train.optim import build_optimizer
    from movae_tpu.train.state import TrainState
    from movae_tpu.train.step import make_train_step

    cfg = AggregatorConfig(name=agg, num_objectives=len(jm.objective_names))
    state = TrainState.create(jm.apply, params, bstats,
                              build_optimizer("adam", LR, eps=EPS),
                              init_state(cfg))
    return state, jax.jit(make_train_step(jm, cfg, 1, STEPS))


def port_state(tm, agg):
    from movae_tpu_torch.moo import AggregatorConfig, init_state
    from movae_tpu_torch.train.optim import build_optimizer
    from movae_tpu_torch.train.state import TrainState
    from movae_tpu_torch.train.step import make_train_step

    cfg = AggregatorConfig(name=agg, num_objectives=len(tm.objective_names))
    state = TrainState.create(tm, build_optimizer("adam", LR, eps=EPS),
                              init_state(cfg))
    return state, make_train_step(tm, cfg, 1, STEPS)


def run_lockstep(monkeypatch, arch, agg, seed=11, **kw):
    """``STEPS`` steps of ``agg`` in both packages from one init on one
    batch stream and the same noise; after every step the losses, weights,
    parameters, running statistics and anneal counter agree."""
    from movae_tpu_torch.moo import aggregators

    jm, params, bstats, tm = build_pair(seed=seed, arch=arch, **kw)
    drawn = spy_normal(monkeypatch)
    jstate, jstep = jax_state(jm, params, bstats, agg)
    tstate, tstep = port_state(tm, agg)
    m = len(jm.objective_names)
    grams = []
    weights_fn = aggregators.compute_weights

    def seen(cfg, G, *a, **kw):
        grams.append(G.detach().double())
        return weights_fn(cfg, G, *a, **kw)

    monkeypatch.setattr(aggregators, "compute_weights", seen)
    rng = jax.random.PRNGKey(3)
    counter = "num_iter" in tm.state_dict()
    for i in range(STEPS):
        xb = images(100 + i)
        rng, sub = jax.random.split(rng)
        start = len(drawn)
        jstate, jmet = jstep(jstate, jnp.asarray(xb), sub)
        noise = take_noise(drawn, start, arch)
        tstate, tmet = tstep(tstate, torch.tensor(xb), noise=noise)
        scale = max(1.0, max(abs(float(jmet[k])) for k in jm.objective_names))
        for key in ("total_loss", *jm.objective_names):
            np.testing.assert_allclose(float(tmet[key]), float(jmet[key]),
                                       rtol=2e-4, atol=2e-5 * scale,
                                       err_msg=f"{arch} {agg} step {i} {key}")
        got = np.array([float(tmet[f"task_{j}_weight"]) for j in range(m)])
        want = np.array([float(jmet[f"task_{j}_weight"]) for j in range(m)])
        if agg == "aligned_mtl":
            exact = aggregators._aligned_mtl_alpha(
                grams[-1], torch.full((m,), 1.0 / m, dtype=torch.float64),
                "min").numpy()
            for ref in (want, exact):
                atol = EIGH_F32_TOL * float(np.abs(ref).max())
                np.testing.assert_allclose(got, ref, rtol=0, atol=atol,
                                           err_msg=f"{arch} step {i} weights")
        else:
            np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5,
                                       err_msg=f"{arch} {agg} step {i}")
        assert float(tmet["skipped_nonfinite"]) == 0.0
        jbs = as_np(jstate.batch_stats)
        ref = state_dict_of(arch, as_np(jstate.params), jbs)
        got = tm.state_dict()
        for k, v in ref.items():
            tol = STAT_TOL if "running" in k else 5e-4
            np.testing.assert_allclose(got[k].numpy(), v, rtol=0, atol=tol,
                                       err_msg=f"{arch} {agg} step {i} {k}")
        if counter:
            assert float(got["num_iter"]) == float(jbs["num_iter"]) == i + 1
    assert tstate.step == int(jstate.step) == STEPS
    return tm


@pytest.mark.parametrize("arch", ["vae", "gg_vae_v3"])
@pytest.mark.parametrize("layer_norm", NORMS)
def test_state_dict_equals_jax_export_bit_for_bit(arch, layer_norm):
    from movae_tpu.utils.torch_export import export_torch_state_dict
    from movae_tpu_torch.utils.weights import vae_state_dict

    _, params, bstats, tm = build_pair(arch=arch, layer_norm=layer_norm)
    ref = export_torch_state_dict(params, bstats, arch)
    got = vae_state_dict(params, bstats)
    assert list(got) == list(ref)
    assert set(got) == set(tm.state_dict())
    if layer_norm == "batch":
        assert "encoder.0.1.num_batches_tracked" in ref
    for k in ref:
        assert got[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
        np.testing.assert_array_equal(tm.state_dict()[k].numpy(), ref[k],
                                      err_msg=k)


@pytest.mark.parametrize("arch", ["vae", *GG_ARCHS])
@pytest.mark.parametrize("layer_norm", NORMS)
def test_train_forward_losses_and_stats_match_jax(arch, layer_norm,
                                                 monkeypatch):
    """A train-mode forward: outputs, weighted losses and the new BatchNorm
    running statistics (returned, not written) against flax's mutable
    batch_stats."""
    jm, params, bstats, tm = build_pair(seed=1, arch=arch,
                                        layer_norm=layer_norm)
    drawn = spy_normal(monkeypatch)
    x = images(2)
    (j_vec, j_dict, j_out), mut = jm.apply(
        {"params": params, "batch_stats": bstats}, jnp.asarray(x),
        train=True, method="forward_with_losses", mutable=["batch_stats"],
        rngs={"sample": jax.random.PRNGKey(0)})
    noise = take_noise(drawn, 0, arch)
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    with torch.no_grad():
        t_vec, t_dict, t_out = tm.forward_with_losses(
            torch.tensor(x), train=True, noise=noise)
    for key in ("recons", "mu", "log_var", "z"):
        assert t_out[key].shape == j_out[key].shape, key
        np.testing.assert_allclose(t_out[key].numpy(), np.asarray(j_out[key]),
                                   rtol=1e-5, atol=1e-5, err_msg=key)
    np.testing.assert_allclose(t_vec.numpy(), np.asarray(j_vec), rtol=1e-5,
                               atol=1e-6)
    for key in (*jm.objective_names, "total_loss"):
        np.testing.assert_allclose(float(t_dict[key]), float(j_dict[key]),
                                   rtol=1e-5, atol=1e-6, err_msg=key)
    # the forward wrote nothing; its new statistics are the flax ones
    for k, v in tm.state_dict().items():
        assert torch.equal(v, before[k]), k
    ref = state_dict_of(arch, params, as_np(mut["batch_stats"]))
    stats = t_out.get("batch_stats", {})
    assert set(stats) == {k for k in ref if k.endswith(("_mean", "_var"))}
    for k, v in stats.items():
        np.testing.assert_allclose(v.numpy(), ref[k], rtol=0, atol=1e-6,
                                   err_msg=k)


@pytest.mark.parametrize("arch", ["vae", "gg_vae_v6"])
def test_eval_forward_and_sample_match_jax(arch, monkeypatch):
    """Eval mode normalizes by the running statistics (loaded from JAX, set
    away from their init) and touches nothing; ``sample`` decodes N(0, I)."""
    jm, params, bstats, tm = build_pair(seed=4, arch=arch)
    drawn = spy_normal(monkeypatch)
    rng = np.random.default_rng(3)
    bstats = jax.tree_util.tree_map(
        lambda a: (a + rng.uniform(0.1, 0.5, a.shape)).astype(np.float32),
        bstats)
    from movae_tpu_torch.utils.weights import load_jax_params
    load_jax_params(tm, params, bstats)
    x = images(5)
    _, j_dict, j_out = jm.apply({"params": params, "batch_stats": bstats},
                                jnp.asarray(x), train=False,
                                method="forward_with_losses",
                                rngs={"sample": jax.random.PRNGKey(1)})
    noise = take_noise(drawn, 0, arch)
    with torch.no_grad():
        _, t_dict, t_out = tm.forward_with_losses(torch.tensor(x),
                                                  noise=noise)
    assert "batch_stats" not in t_out
    np.testing.assert_allclose(t_out["recons"].numpy(),
                               np.asarray(j_out["recons"]), rtol=1e-5,
                               atol=1e-5)
    for key in (*jm.objective_names, "total_loss"):
        np.testing.assert_allclose(float(t_dict[key]), float(j_dict[key]),
                                   rtol=1e-5, atol=1e-6, err_msg=key)
    start = len(drawn)
    j_smp = jm.apply({"params": params, "batch_stats": bstats}, 3,
                     method="sample", rngs={"sample": jax.random.PRNGKey(2)})
    z = take_noise(drawn, start, "vae")["eps"]
    with torch.no_grad():
        t_smp = tm.decode(z, train=False)
    np.testing.assert_allclose(t_smp.numpy(), np.asarray(j_smp), rtol=1e-5,
                               atol=1e-5)
    gen = torch.Generator().manual_seed(0)
    assert tuple(tm.sample(3, generator=gen).shape) == (3, SIZE, SIZE, 3)


ALL_ARCHS = ("vae", *GG_ARCHS, "betatc_vae", "btc_vae", "cycle_vae",
             "recursive_kl_vae", "recursive_cyclic_vae", "rc_vae")


def _weight_cases(names):
    """Missing, dict (the KL-type key set away from the registry's), dict
    without its last key, positional list, list of the wrong length."""
    full = {k: 0.5 + 0.25 * i for i, k in enumerate(names)}
    return [None, full, {k: v for k, v in full.items() if k != names[-1]},
            {k: v for k, v in full.items() if k != names[1]},
            [float(v) for v in full.values()], [1.0] * (len(names) + 1)]


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_registry_order_and_lambda_weights_match_jax(arch):
    """Every arch name: class, objective order, feature names and the lambda
    weights for missing, dict and list weights (the KL weight's override,
    pass-through and setdefault rules), or the same ValueError."""
    from movae_tpu.models import get_network as jget
    from movae_tpu_torch.models import get_network

    names = jget(SIZE, 3, vae_args(arch=arch)).objective_names
    for lw in _weight_cases(names):
        args = vae_args(arch=arch, loss_weights=lw, batch_size=16,
                        dataset_size=1000, anneal_steps=7,
                        recursive_kld_anneal_steps=9)
        try:
            jm = jget(SIZE, 3, args)
        except ValueError:
            with pytest.raises(ValueError):
                get_network(SIZE, 3, args)
            continue
        tm = get_network(SIZE, 3, args)
        assert type(tm).__name__ == type(jm).__name__
        assert tm.objective_names == jm.objective_names
        assert tm.lambda_weights == tuple(jm.lambda_weights), (arch, lw)
        assert tm.feature_names == jm.feature_names
        for attr in ("anneal_steps", "recursive_kld_anneal_steps",
                     "edge_matching_version", "layer_norm", "dataset_size"):
            if hasattr(jm, attr):
                assert getattr(tm, attr) == getattr(jm, attr), attr


def test_gg_vae_v4_raises_in_both_packages_and_sphere_encoders_name_item_11():
    from movae_tpu.models import get_network as jget
    from movae_tpu_torch.models import get_network

    for get in (jget, get_network):
        with pytest.raises(ValueError, match="gg_vae_v4 not supported"):
            get(SIZE, 3, vae_args(arch="gg_vae_v4"))
    for arch in ("sphere_encoder", "sphere_encoder_vit"):
        with pytest.raises(NotImplementedError, match="ROADMAP.md.*item 11"):
            get_network(SIZE, 3, vae_args(arch=arch))


@pytest.mark.parametrize("arch,agg", [
    ("vae", "sum"), ("vae", "upgrad"), ("vae", "mgda"), ("gg_vae", "sum"),
    ("gg_vae", "mgda"), ("gg_vae_v5", "sum"), ("gg_vae_v5", "mgda")])
def test_train_lockstep_matches_jax(arch, agg, monkeypatch):
    run_lockstep(monkeypatch, arch, agg)


def test_layer_norm_lockstep_matches_jax(monkeypatch):
    run_lockstep(monkeypatch, "vae", "mgda", layer_norm="layer")


def _snapshot(state):
    opt = state.optimizer.state_dict()
    return {"model": {k: v.clone()
                      for k, v in state.model.state_dict().items()},
            "opt": {i: {k: v.clone() for k, v in s.items()
                        if torch.is_tensor(v)}
                    for i, s in opt["state"].items()},
            "step": state.step}


def assert_nonfinite_batch_leaves_state(tm, agg):
    """A good step, then a batch with a NaN: every parameter, running
    statistic, counter and Adam moment stays bit-identical; the next good
    step trains."""
    state, step = port_state(tm, agg)
    gen = torch.Generator().manual_seed(0)
    state, met = step(state, torch.tensor(images(1)), gen)
    assert float(met["skipped_nonfinite"]) == 0.0
    before = _snapshot(state)
    bad = images(2)
    bad[0, 0, 0, 0] = np.nan
    state, met = step(state, torch.tensor(bad), gen)
    assert float(met["skipped_nonfinite"]) == 1.0
    after = _snapshot(state)
    assert before["step"] == after["step"] == 1
    for k, v in before["model"].items():
        assert torch.equal(v, after["model"][k]), k
    for i, s in before["opt"].items():
        for k, v in s.items():
            assert torch.equal(v, after["opt"][i][k]), (i, k)
    state, met = step(state, torch.tensor(images(3)), gen)
    assert float(met["skipped_nonfinite"]) == 0.0 and state.step == 2
    return state


@pytest.mark.parametrize("arch,agg", [("vae", "sum"), ("gg_vae_v2", "mgda")])
def test_nonfinite_batch_leaves_weights_and_statistics(arch, agg):
    _, _, _, tm = build_pair(seed=12, arch=arch)
    state = assert_nonfinite_batch_leaves_state(tm, agg)
    assert float(state.model.state_dict()["encoder.0.1.running_var"
                                          ].sub(1).abs().max()) > 0


def write_final_checkpoint(tm, path, arch):
    """A ``final_checkpoint.pth`` as ``train/loop.py`` writes it."""
    from movae_tpu_torch.train import checkpoint as ckpt_lib

    ref, extra = ckpt_lib.split_state_dict(tm)
    payload = {"epoch": 1, "model_state_dict": ref,
               "args": ckpt_lib.args_echo(vae_args(arch=arch)),
               "train_losses": [], "eval_losses": [], "best_eval_loss": None}
    if extra:
        payload["ema_state"] = extra
    return ckpt_lib.save_checkpoint(path, payload)


def assert_jax_reads_port_checkpoint(tm, jm, arch, tmp_path, monkeypatch):
    """The JAX package's ``load_reference_checkpoint`` reads a port-written
    ``final_checkpoint.pth`` (reference keys only) and computes the same
    eval forward; the port reloads it strictly, counters included."""
    from movae_tpu.utils.torch_import import load_reference_checkpoint
    from movae_tpu_torch.models import get_network
    from movae_tpu_torch.train import checkpoint as ckpt_lib

    path = write_final_checkpoint(
        tm, os.path.join(tmp_path, "final_checkpoint.pth"), arch)
    payload = ckpt_lib.load_checkpoint(path)
    assert "num_iter" not in payload["model_state_dict"]
    loaded = load_reference_checkpoint(path)
    sd = loaded["model_state_dict"]
    bstats = dict(sd["batch_stats"])
    if arch in ("recursive_kl_vae", "recursive_cyclic_vae"):
        # the JAX importer adds the counter for betatc_vae only; these
        # models' flax setup needs it even in eval (ROADMAP.md Queue 3)
        assert "num_iter" not in bstats
        bstats["num_iter"] = np.zeros((), np.float32)
    drawn = spy_normal(monkeypatch)
    x = images(9)
    jout = jm.apply({"params": sd["params"], "batch_stats": bstats},
                    jnp.asarray(x), train=False,
                    rngs={"sample": jax.random.PRNGKey(0)})
    noise = take_noise(drawn, 0, arch)
    with torch.no_grad():
        tout = tm(torch.from_numpy(x), train=False, noise=noise)
    np.testing.assert_allclose(tout["recons"].numpy(),
                               np.asarray(jout["recons"]), rtol=0, atol=1e-5)
    again = get_network(SIZE, 3, vae_args(arch=arch))
    ckpt_lib.load_module_state(again, payload)
    for k, v in tm.state_dict().items():
        assert torch.equal(again.state_dict()[k], v), k


def test_jax_loads_a_port_written_vae_checkpoint(tmp_path, monkeypatch):
    jm, _, _, tm = build_pair(seed=6, arch="vae")
    state, step = port_state(tm, "sum")
    for i in range(2):
        step(state, torch.tensor(images(i)), torch.Generator().manual_seed(i))
    assert_jax_reads_port_checkpoint(tm, jm, "vae", tmp_path, monkeypatch)
