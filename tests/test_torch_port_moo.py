"""Port multi-objective engine (movae_tpu_torch/moo) against the JAX package
(movae_tpu/moo): aggregator weights on random PSD, rank-deficient and
zero-row Gramians, and the feature-Jacobian grads of the VQ-VAE.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from movae_tpu.moo import aggregators as jagg  # noqa: E402
from movae_tpu.moo import engine as jeng  # noqa: E402
from movae_tpu.moo import solvers as jsol  # noqa: E402
from movae_tpu_torch.moo import aggregators as tagg  # noqa: E402
from movae_tpu_torch.moo import engine as teng  # noqa: E402
from movae_tpu_torch.moo import solvers as tsol  # noqa: E402
from test_solvers import J as ORACLE_J  # noqa: E402
from test_torch_port_vqvae import build_pair, images  # noqa: E402


def _gramians(m, seed):
    """Random PSD (full rank), rank-deficient, and with a zero row/column
    (an objective with no path to the features).

    The rank-deficient ones stay at trace ~0.1 or below: regularized by
    reg_eps = 1e-4, their masked systems have a condition number of about
    trace(G) / 1e-4, and at unit scale the float32 solves of both
    frameworks already sit ~1e-4 from a float64 solve and from each other.
    """
    rng = np.random.default_rng(seed)
    out = []
    for trial in range(3):
        scale = 10.0 ** rng.integers(-2, 3)
        A = rng.normal(size=(m, m + 2)) * scale
        out.append(A @ A.T)
        B = rng.normal(size=(m, max(m - 2, 1))) * 10.0 ** rng.integers(-2, 0)
        out.append(B @ B.T)
        Z = A @ A.T
        z = int(rng.integers(0, m))
        Z[z, :] = 0.0
        Z[:, z] = 0.0
        out.append(Z)
    return [g.astype(np.float32) for g in out]


@functools.lru_cache(maxsize=None)
def _jax_weights_fn(name, m, pref):
    cfg = jagg.AggregatorConfig(name=name, num_objectives=m,
                                pref_vector=pref)
    return jax.jit(lambda G: jagg.compute_weights(
        cfg, G, jnp.ones(m), jax.random.PRNGKey(0), jagg.init_state(cfg))[0])


def _weights(lib, name, G, pref=None):
    m = G.shape[0]
    if lib == "jax":
        return np.asarray(_jax_weights_fn(name, m, pref)(jnp.asarray(G)))
    cfg = tagg.AggregatorConfig(name=name, num_objectives=m, pref_vector=pref)
    a, _ = tagg.compute_weights(cfg, torch.tensor(G), torch.ones(m),
                                tagg.init_state(cfg))
    return a.numpy()


@pytest.mark.parametrize("name", ["sum", "mean", "upgrad", "dualproj"])
@pytest.mark.parametrize("m", [2, 3, 4, 5])
def test_compute_weights_match_jax(name, m):
    for i, G in enumerate(_gramians(m, seed=10 * m + len(name))):
        got = _weights("torch", name, G)
        ref = _weights("jax", name, G)
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5,
                                   err_msg=f"{name} m={m} gramian {i}")


def test_preference_vector_matches_jax():
    G = _gramians(3, seed=1)[0]
    for name in ("upgrad", "dualproj"):
        np.testing.assert_allclose(
            _weights("torch", name, G, (0.2, 0.5, 0.3)),
            _weights("jax", name, G, (0.2, 0.5, 0.3)), rtol=1e-5, atol=1e-5)


def test_upgrad_reference_oracle():
    """UPGrad()(J) == [0.2929, 1.9004, 1.9004] (the oracle of
    tests/test_solvers.py)."""
    G = (ORACLE_J @ ORACLE_J.T).astype(np.float32)
    alpha = _weights("torch", "upgrad", G)
    np.testing.assert_allclose(alpha @ ORACLE_J, [0.2929, 1.9004, 1.9004],
                               atol=5e-3)


_jax_project = jax.jit(jsol.dual_cone_project_weights)


@pytest.mark.parametrize("m", [2, 3, 4, 5])
def test_dual_cone_projection_matches_jax_and_kkt(m):
    rng = np.random.default_rng(100 + m)
    for trial in range(10):
        A = rng.normal(size=(m, m + 2))
        G = (A @ A.T).astype(np.float32)
        u = rng.uniform(0.1, 1.0, m).astype(np.float32)
        w = tsol.dual_cone_project_weights(torch.tensor(u),
                                           torch.tensor(G)).numpy()
        ref = np.asarray(_jax_project(jnp.asarray(u), jnp.asarray(G)))
        np.testing.assert_allclose(w, ref, rtol=1e-5, atol=1e-5)
        tol = 1e-4 * (np.trace(G) + 1.0)
        assert (G @ w >= -tol).all() and (w - u >= -tol).all()


def test_non_pd_masked_systems_are_infeasible_not_errors():
    """cholesky_ex flags a non-PD masked system instead of raising: an
    unregularized singular Gramian still projects to a finite answer."""
    G = torch.zeros(3, 3)
    w = tsol.dual_cone_project_weights(torch.full((3,), 1 / 3), G)
    assert torch.isfinite(w).all()
    np.testing.assert_allclose(w.numpy(), np.asarray(
        jsol.dual_cone_project_weights(jnp.full((3,), 1 / 3), jnp.zeros(
            (3, 3)))), atol=1e-6)


@pytest.mark.parametrize("fn", ["normalize_gramian_l2",
                                "normalize_gramian_min_l2",
                                "normalize_gramian_loss",
                                "normalize_gramian_loss_plus"])
def test_gramian_normalizers_match_jax(fn):
    for G in _gramians(4, seed=7):
        losses = np.array([0.5, 2.0, 1.0, 0.1], np.float32)
        args_t = (torch.tensor(G),)
        args_j = (jnp.asarray(G),)
        if "loss" in fn:
            args_t += (torch.tensor(losses),)
            args_j += (jnp.asarray(losses),)
        elif fn.endswith("min_l2"):
            args_t += (1e-4,)
            args_j += (1e-4,)
        np.testing.assert_allclose(
            getattr(tsol, fn)(*args_t).numpy(),
            np.asarray(getattr(jsol, fn)(*args_j)), rtol=1e-5, atol=1e-6)


def test_similarity_and_comfort_beta_match_jax():
    G = _gramians(3, seed=3)[0]
    alpha = np.array([0.3, 1.2, 0.5], np.float32)
    np.testing.assert_allclose(
        float(tagg.gradient_similarity(torch.tensor(G), torch.tensor(alpha))),
        float(jagg.gradient_similarity(jnp.asarray(G), jnp.asarray(alpha))),
        rtol=1e-5)
    for epoch in (1, 3, 10):
        np.testing.assert_allclose(
            float(tagg.comfort_beta(tagg.AggregatorConfig(), epoch, 10)),
            float(jagg.comfort_beta(jagg.AggregatorConfig(),
                                    jnp.asarray(epoch), 10)), rtol=1e-6)


def test_unported_aggregator_names_roadmap_item():
    """No aggregator is left unported: every name of the JAX package's
    AGGREGATOR_NAMES gives finite weights, and an unknown name raises
    ValueError, as in the JAX package."""
    assert tagg.AGGREGATOR_NAMES == jagg.AGGREGATOR_NAMES
    G = torch.tensor(_gramians(3, seed=2)[0])
    for name in jagg.AGGREGATOR_NAMES:
        cfg = tagg.AggregatorConfig(name=name, num_objectives=3)
        alpha, _ = tagg.compute_weights(cfg, G, torch.ones(3),
                                        tagg.init_state(cfg))
        assert alpha.shape == (3,) and torch.isfinite(alpha).all(), name
    cfg = tagg.AggregatorConfig(name="no_such_aggregator", num_objectives=2)
    with pytest.raises(ValueError, match="not supported"):
        tagg.compute_weights(cfg, torch.eye(2), torch.ones(2), {})


# ---------------------------------------------------------------------------
# feature-Jacobian engine on the VQ-VAE
# ---------------------------------------------------------------------------

def _jax_feature_jacobian(jm, params, x):
    names = jm.objective_names

    def trunk_fn(p):
        feats, aux = jm.apply({"params": p}, x, train=True, method="trunk")
        return feats, aux

    def heads_fn(p, feats, aux):
        _, ld, out = jm.apply({"params": p}, feats, aux, x, train=True,
                              method="heads_with_losses")
        return tuple(ld[k] for k in names), out

    return jeng.FeatureJacobian(trunk_fn, heads_fn, params, len(names))


def _port_feature_jacobian(tm, x):
    names = tm.objective_names
    params = [p for p in tm.parameters() if p.requires_grad]

    def heads_fn(feats, aux):
        _, ld, out = tm.heads_with_losses(feats, aux, x, train=True)
        return tuple(ld[k] for k in names), out

    return params, teng.FeatureJacobian(lambda: tm.trunk(x, train=True),
                                        heads_fn, params, len(names))


def _named(tm, params, grads):
    by_id = {id(p): n for n, p in tm.named_parameters()}
    return {by_id[id(p)]: g.detach().numpy() for p, g in zip(params, grads)}


def test_feature_jacobian_grads_match_jax():
    from movae_tpu.utils.torch_export import export_torch_state_dict

    jm, params, _, tm = build_pair(seed=4)
    x = images(5)
    cfg = jagg.AggregatorConfig(name="upgrad", num_objectives=3)

    @jax.jit
    def jax_side(p, xb):
        fj = _jax_feature_jacobian(jm, p, xb)
        alpha, _ = jagg.compute_weights(cfg, fj.G, fj.losses,
                                        jax.random.PRNGKey(0), {})
        return fj.losses, fj.G, alpha, fj.grads(alpha)

    j_losses, j_G, alpha, j_grads = jax_side(params, jnp.asarray(x))
    tparams, tfj = _port_feature_jacobian(tm, torch.tensor(x))
    np.testing.assert_allclose(tfj.losses.numpy(), np.asarray(j_losses),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(tfj.G.numpy(), np.asarray(j_G), rtol=1e-5,
                               atol=1e-9)
    ref = export_torch_state_dict(jax.tree_util.tree_map(np.asarray,
                                                         j_grads), {},
                                  "vq_vae")
    got = _named(tm, tparams, tfj.grads(torch.tensor(np.asarray(alpha))))
    assert set(got) == set(ref)
    for k in ref:
        scale = max(float(np.abs(ref[k]).max()), 1e-3)
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-5,
                                   atol=1e-5 * scale, err_msg=k)


def test_feature_jacobian_heads_get_unweighted_sum_and_embedding_row_zero():
    _, _, _, tm = build_pair(seed=6)
    x = torch.tensor(images(7))
    tparams, fj = _port_feature_jacobian(tm, x)
    # the embedding loss (objective 1) has no path to the features: an
    # exact zero row, and a zero row/column of the Gramian
    assert fj._J_feats[0].shape[0] == 3
    assert not fj._J_feats[0][1].any()
    assert not fj.G[1].any() and not fj.G[:, 1].any()
    g_a = _named(tm, tparams, fj.grads(torch.tensor([1.0, 1.0, 1.0])))
    tparams, fj = _port_feature_jacobian(tm, x)
    g_b = _named(tm, tparams, fj.grads(torch.tensor([0.2, 3.0, 0.7])))
    # head parameters (codebook, decoder) ignore alpha ...
    for k in g_a:
        if not k.startswith("encoder"):
            np.testing.assert_array_equal(g_a[k], g_b[k], err_msg=k)
    # ... and equal the gradient of the unweighted total loss
    _, ld, _ = tm.forward_with_losses(x, train=True)
    total = dict(zip([n for n, p in tm.named_parameters()],
                     torch.autograd.grad(ld["total_loss"],
                                         list(tm.parameters()))))
    for k in g_a:
        np.testing.assert_allclose(g_a[k], total[k].numpy(), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    # the trunk does depend on alpha
    assert not np.allclose(g_a["encoder.0.0.weight"],
                           g_b["encoder.0.0.weight"])


def test_full_jacobian_gramian_matches_jax():
    jm, params, _, tm = build_pair(seed=8)
    x = images(9)
    names = jm.objective_names

    def jloss(p):
        _, ld, out = jm.apply({"params": p}, jnp.asarray(x), train=True,
                              method="forward_with_losses")
        return tuple(ld[k] for k in names), out

    jl, _, _, jG = jax.jit(lambda p: jeng.full_jacobian(jloss, p, 3))(params)

    def tloss():
        _, ld, out = tm.forward_with_losses(torch.tensor(x), train=True)
        return tuple(ld[k] for k in names), out

    tparams = [p for p in tm.parameters() if p.requires_grad]
    tl, _, J, tG = teng.full_jacobian(tloss, tparams, 3)
    assert [tuple(j.shape) for j in J] == [(3,) + tuple(p.shape)
                                           for p in tparams]
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5)
    np.testing.assert_allclose(tG.numpy(), np.asarray(jG), rtol=1e-4,
                               atol=1e-8)
