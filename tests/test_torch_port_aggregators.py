"""Port aggregators (movae_tpu_torch/moo: every name of the JAX
AGGREGATOR_NAMES) against the JAX package on seeded Gramians at m = 2..5,
Frank–Wolfe's iteration count, PCGrad and PNUPGrad fed JAX's own draws, and
6-step train locksteps against the JAX step for the aggregators the configs
name, NashMTL's carried state and COMFORT's epoch schedule.

Gramians (``_gramians``): full rank at scales 1e-4..1e4 in G, rank-deficient
(exactly, in float32) at trace <= ~0.1 and with a zero row/column (an objective with no path to
the features); CAGrad also on scale-split ones (diagonal ratios ~1e6, the
VQ models' reconstruction against codebook objectives). Rank-deficient
Gramians are held at trace <= ~0.1 for the reason in
tests/test_torch_port_moo.py. IMTL-G and NashMTL are not held on them:
IMTL-G needs linearly independent gradients and NashMTL's weights grow as
1/sqrt(1e-8 ridge) along a null space, so both frameworks' float32 answers
sit up to ~0.3 of the largest weight from a float64 solve there, and from
each other (JAX's IMTL-G solve returns NaN where the port's returns finite
values; ROADMAP.md Queue 3). The minimizers of CAGrad and of MGDA's
min-norm problem (so COMFORT's too) are not unique on a rank-deficient
Gramian: their objective is flat along the null space, and a float32 tie
there sends the two frameworks to different weights with the same update
(MGDA on a rank-1 G whose min-norm point is 0: JAX [0.4, 0.3, 0.3], the
port [0, 1, 0]). There the two weight vectors are held in gradient space:
the G-norm of their difference, sqrt(d^T G d) = ||d^T J||, within 1e-4 of
the gradients' size, sqrt(trace G), times the largest weight (at least 1).

Weights agree within 2e-5 of the largest (at least 1) plus 1e-4 relative:
float32 solves in two frameworks, measured up to ~7e-6 (MGDA with the loss
normalizations, Aligned-MTL's median and mean scales).
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from movae_tpu.moo import aggregators as jagg  # noqa: E402
from movae_tpu.moo import solvers as jsol  # noqa: E402
from movae_tpu_torch.moo import aggregators as tagg  # noqa: E402
from movae_tpu_torch.moo import solvers as tsol  # noqa: E402
from test_torch_port_step import _param_delta, EPS, LR  # noqa: E402
from test_torch_port_vqvae import build_pair, images  # noqa: E402

ILL_POSED_ON_RANK_DEFICIENT = ("imtlg", "nashmtl")
NON_UNIQUE_ON_RANK_DEFICIENT = ("cagrad", "mgda", "mgda_ln", "mgda_gn",
                                "mgda_lgn", "comfort")


def _gramians(m, seed, name="", labels=False):
    """Seeded Gramians for ``name``; with ``labels``, (kind, G) pairs."""
    rng = np.random.default_rng(seed)
    out = []
    for trial in range(2):
        A = rng.normal(size=(m, m + 2)) * 10.0 ** rng.integers(-2, 3)
        out.append(("full", A @ A.T))
        if name not in ILL_POSED_ON_RANK_DEFICIENT:
            # entries in 1/64ths: B B^T is exact in float32, so its null
            # space is exact too (rounding would lift it to ~1e-7 of G)
            B = rng.integers(-4, 5, size=(m, max(m - 2, 1))) / 64.0
            out.append(("rank_deficient", B @ B.T))
        Z = A @ A.T
        z = int(rng.integers(0, m))
        Z[z, :] = 0.0
        Z[:, z] = 0.0
        out.append(("zero_row", Z))
        if name == "cagrad":
            d = np.diag([1e3] + [1e-3] * (m - 1))
            out.append(("scale_split", d @ (A @ A.T) @ d))
    out = [(k, g.astype(np.float32)) for k, g in out]
    return out if labels else [g for _, g in out]


def _draws(name, m, key):
    """JAX's own draws from ``key``: PCGrad's m permutations
    (``split(key, m)``, then ``permutation(key_i, m)``) and PNUPGrad's
    ``uniform(key) < 0.5``."""
    if name == "pcgrad":
        return {"perms": torch.tensor(np.asarray(_jax_perms(m)(key)))}
    if name == "pnupgrad":
        return {"use_pairwise": torch.tensor(
            bool(jax.random.uniform(key) < 0.5))}
    return {}


@functools.lru_cache(maxsize=None)
def _jax_perms(m):
    """PCGrad's task orders as its vmapped ``project_task`` draws them."""
    return jax.jit(lambda key: jax.vmap(
        lambda k: jax.random.permutation(k, m))(jax.random.split(key, m)))


@functools.lru_cache(maxsize=None)
def _jax_fn(name, m):
    cfg = jagg.AggregatorConfig(name=name, num_objectives=m)
    return jax.jit(lambda G, losses, key, beta: jagg.compute_weights(
        cfg, G, losses, key, jagg.init_state(cfg), beta)[0])


def _pair(name, G, losses, key, beta=0.3):
    m = G.shape[0]
    want = np.asarray(_jax_fn(name, m)(jnp.asarray(G), jnp.asarray(losses),
                                       key, jnp.float32(beta)))
    cfg = tagg.AggregatorConfig(name=name, num_objectives=m)
    got, _ = tagg.compute_weights(cfg, torch.tensor(G), torch.tensor(losses),
                                  tagg.init_state(cfg), torch.tensor(beta),
                                  **_draws(name, m, key))
    return got.numpy(), want


def _close(got, want, msg):
    atol = 2e-5 * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=atol, err_msg=msg)


@pytest.mark.parametrize("name", jagg.AGGREGATOR_NAMES)
def test_compute_weights_match_jax(name):
    for m in (2, 3, 4, 5):
        rng = np.random.default_rng(m)
        for i, (kind, G) in enumerate(_gramians(m, seed=10 * m + len(name),
                                                name=name, labels=True)):
            losses = rng.uniform(0.1, 2.0, m).astype(np.float32)
            got, want = _pair(name, G, losses, jax.random.PRNGKey(i))
            assert np.isfinite(got).all(), (name, m, i, got)
            msg = f"{name} m={m} gramian {i} ({kind})"
            if (name in NON_UNIQUE_ON_RANK_DEFICIENT
                    and kind == "rank_deficient"):
                G64, d = G.astype(np.float64), (got - want).astype(np.float64)
                scale = np.sqrt(np.trace(G64)) * max(1.0, np.abs(want).max())
                assert np.sqrt(max(d @ G64 @ d, 0.0)) <= 1e-4 * scale, msg
            else:
                _close(got, want, msg)


@pytest.mark.parametrize("name", ["pcgrad", "pnupgrad"])
def test_randomized_aggregators_take_jax_draws(name):
    """Fed the draws JAX made from its key, the port gives JAX's weights;
    over 8 keys both PNUPGrad branches and distinct PCGrad orders occur."""
    G = _gramians(4, seed=3)[0]
    # a conflicting Gramian, so that PCGrad's projections do something
    G[0, 1] = G[1, 0] = -0.9 * np.sqrt(G[0, 0] * G[1, 1])
    losses = np.ones(4, np.float32)
    seen = set()
    for k in range(8):
        key = jax.random.PRNGKey(k)
        got, want = _pair(name, G, losses, key)
        _close(got, want, f"{name} key {k}")
        seen.add(str(_draws(name, 4, key)))
    assert len(seen) >= 2


def test_randomized_aggregators_draw_from_the_generator():
    G = torch.tensor(_gramians(4, seed=5)[0])
    for name in ("pcgrad", "pnupgrad"):
        cfg = tagg.AggregatorConfig(name=name, num_objectives=4)
        runs = [tagg.compute_weights(
            cfg, G, torch.ones(4), {},
            generator=torch.Generator().manual_seed(s))[0] for s in (1, 1, 2)]
        assert torch.equal(runs[0], runs[1])
        assert all(torch.isfinite(r).all() for r in runs)


_jax_fw = jax.jit(jsol.frank_wolfe_minnorm, static_argnums=(1, 2))
_jax_eigen = jax.jit(jsol.regularize_gramian_eigen, static_argnums=1)
_jax_cagrad = jax.jit(jsol.cagrad_exact, static_argnums=1)
_jax_balance = jax.jit(jsol.balance_transformation, static_argnums=1)


@pytest.mark.parametrize("m", [2, 3, 4, 5])
def test_frank_wolfe_iterations_match_jax(m):
    """alpha, the iteration count and the last step of the Frank–Wolfe
    min-norm solve; on equal Gramian rows argmin(G alpha) takes the lowest
    index in both frameworks."""
    rng = np.random.default_rng(40 + m)
    cases = [g for g in _gramians(m, seed=m)]
    tie = rng.normal(size=(m, m + 1))
    tie[1] = tie[0]
    cases.append(tie @ tie.T)
    for i, G in enumerate(cases):
        G = G.astype(np.float32)
        for eps, iters in ((1e-5, 250), (1e-3, 7)):
            a, n, g = tsol.frank_wolfe_minnorm(torch.tensor(G), eps, iters)
            ja, jn, jg = _jax_fw(jnp.asarray(G), eps, iters)
            assert int(n) == int(jn), (m, i, eps, int(n), int(jn))
            _close(a.numpy(), np.asarray(ja), f"m={m} case {i}")
            np.testing.assert_allclose(float(g), float(jg), rtol=1e-3,
                                       atol=1e-6)


@pytest.mark.parametrize("mode", ["min", "median", "rmse"])
def test_balance_transformation_matches_jax(mode):
    """B = V f(Sigma) V^T (eigenvector signs and order differ between
    backends, so only B is compared)."""
    for m in (2, 3, 5):
        for G in _gramians(m, seed=60 + m):
            got = tsol.balance_transformation(torch.tensor(G), mode).numpy()
            want = np.asarray(_jax_balance(jnp.asarray(G), mode))
            _close(got, want, f"{mode} m={m}")


def test_eigen_regularization_and_cagrad_match_jax():
    for m in (2, 4):
        for kind, G in _gramians(m, seed=70 + m, name="cagrad", labels=True):
            _close(tsol.regularize_gramian_eigen(torch.tensor(G), 1e-3)
                   .numpy(), np.asarray(_jax_eigen(jnp.asarray(G), 1e-3)),
                   f"eigen m={m} {kind}")
            if kind != "rank_deficient":
                _close(tsol.cagrad_exact(torch.tensor(G), 0.5).numpy(),
                       np.asarray(_jax_cagrad(jnp.asarray(G), 0.5)),
                       f"cagrad c=0.5 m={m} {kind}")


def test_stable_mgda_and_nashmtl_state_match_jax():
    """mgda_stable's eigen clamp, and NashMTL's carried (alpha, step) with
    nashmtl_update_every=2: the solve reruns on even steps only."""
    G0, G1 = _gramians(3, seed=80)[:2]
    losses = np.array([0.5, 1.0, 2.0], np.float32)
    for kw in ({"name": "mgda", "mgda_stable": True,
                "mgda_min_eigenvalue_eps": 1e-2},
               {"name": "mgda", "mgda_norm_type": "loss+"}):
        jcfg = jagg.AggregatorConfig(num_objectives=3, **kw)
        tcfg = tagg.AggregatorConfig(num_objectives=3, **kw)
        want = jagg.compute_weights(jcfg, jnp.asarray(G0), jnp.asarray(losses),
                                    jax.random.PRNGKey(0), {})[0]
        got = tagg.compute_weights(tcfg, torch.tensor(G0),
                                   torch.tensor(losses), {})[0]
        _close(got.numpy(), np.asarray(want), str(kw))
    jcfg = jagg.AggregatorConfig(name="nashmtl", num_objectives=3,
                                 nashmtl_update_every=2)
    tcfg = tagg.AggregatorConfig(name="nashmtl", num_objectives=3,
                                 nashmtl_update_every=2)
    jstate, tstate = jagg.init_state(jcfg), tagg.init_state(tcfg)
    for step, G in enumerate((G0, G1, G1, G0)):
        ja, jstate = jagg.compute_weights(jcfg, jnp.asarray(G),
                                          jnp.ones(3), jax.random.PRNGKey(0),
                                          jstate)
        ta, tstate = tagg.compute_weights(tcfg, torch.tensor(G),
                                          torch.ones(3), tstate)
        _close(ta.numpy(), np.asarray(ja), f"nashmtl step {step}")
        assert int(tstate["nash_step"]) == int(jstate["nash_step"]) == step + 1
    # step 1 kept step 0's weights (no refresh), step 2 solved on G1
    assert set(tstate) == set(jstate)


# ---------------------------------------------------------------------------
# 6-step train locksteps against the JAX step
# ---------------------------------------------------------------------------

STEPS = 6
LOCKSTEP = [("mgda", {}), ("mgda_ln", {}), ("mgda_gn", {}),
            ("mgda_lgn", {}), ("aligned_mtl", {}),
            ("aligned_mtl_median", {}),
            ("nashmtl", {"nashmtl_update_every": 2}),
            # beta by epoch: 3 epochs of 2 steps
            ("comfort", {"epochs": 3})]


@pytest.mark.parametrize("agg,kw", LOCKSTEP, ids=[a for a, _ in LOCKSTEP])
def test_train_lockstep_matches_jax(agg, kw):
    from movae_tpu.moo import AggregatorConfig as JCfg
    from movae_tpu.moo import init_state as jinit
    from movae_tpu.train.optim import build_optimizer as jbuild
    from movae_tpu.train.state import TrainState as JState
    from movae_tpu.train.step import make_train_step as jmake
    from movae_tpu_torch.moo import AggregatorConfig, init_state
    from movae_tpu_torch.train.optim import build_optimizer
    from movae_tpu_torch.train.state import TrainState
    from movae_tpu_torch.train.step import make_train_step

    kw = dict(kw)
    epochs = kw.pop("epochs", 1)
    spe = STEPS // epochs
    jm, params, bstats, tm = build_pair(seed=21)
    m = len(jm.objective_names)
    jcfg = JCfg(name=agg, num_objectives=m, **kw)
    jstate = JState.create(jm.apply, params, bstats,
                           jbuild("adam", LR, eps=EPS), jinit(jcfg))
    jstep = jax.jit(jmake(jm, jcfg, epochs, spe))
    tcfg = AggregatorConfig(name=agg, num_objectives=m, **kw)
    tstate = TrainState.create(tm, build_optimizer("adam", LR, eps=EPS),
                               init_state(tcfg))
    tstep = make_train_step(tm, tcfg, epochs, spe)
    rng = jax.random.PRNGKey(4)
    for i in range(STEPS):
        xb = images(200 + i)
        rng, sub = jax.random.split(rng)
        jstate, jmet = jstep(jstate, jnp.asarray(xb), sub)
        tstate, tmet = tstep(tstate, torch.tensor(xb))
        for key in ("total_loss", *jm.objective_names):
            np.testing.assert_allclose(float(tmet[key]), float(jmet[key]),
                                       rtol=2e-4, atol=2e-5,
                                       err_msg=f"step {i} {key} ({agg})")
        for j in range(m):
            np.testing.assert_allclose(float(tmet[f"task_{j}_weight"]),
                                       float(jmet[f"task_{j}_weight"]),
                                       rtol=2e-4, atol=2e-5,
                                       err_msg=f"step {i} task {j} ({agg})")
        assert float(tmet["skipped_nonfinite"]) == 0.0
        delta = _param_delta(jstate.params, tm)
        assert delta < 5e-4, f"step {i}: max param divergence {delta:.2e}"
    assert tstate.step == int(jstate.step) == STEPS
    if agg == "nashmtl":
        assert int(tstate.agg_state["nash_step"]) == STEPS
        np.testing.assert_allclose(
            tstate.agg_state["nash_alpha"].numpy(),
            np.asarray(jstate.agg_state["nash_alpha"]), rtol=2e-4, atol=2e-5)
