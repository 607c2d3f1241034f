"""Port VQ-VAE-2 (movae_tpu_torch/models/vq_vae2.py, its registry branch,
utils/weights.py:vqvae2_state_dict and the train step on its two features)
against the JAX package on the same seeded inputs and the same weights.

The JAX model is initialized in flax; its params reach the port through
``load_jax_params``. Sizes: 32-px inputs, channel 16, K=32, D=8 (top 4x4,
bottom 8x8 codes). Tolerances are those of tests/test_torch_port_vqvae.py and
tests/test_torch_port_step.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

SIZE = 32
HIDDEN = (16, 32)
K, D = 32, 8
BATCH = 4
STEPS, LR, EPS = 6, 1e-3, 1e-4


def vq2_args(**kw):
    args = dict(arch="vq_vae2", embedding_dim=D, num_embeddings=K,
                hidden_dims=HIDDEN, num_residual_layers=2, batch_size=BATCH,
                dataset_size=64, recons_objective="mse",
                recons_activation="none")
    args.update(kw)
    return args


def build_pair(seed=0, **kw):
    """The same VQ-VAE-2 in both frameworks: (jax_model, params,
    batch_stats, port_model on the CPU)."""
    from movae_tpu.models import get_network as jget, init_model as jinit
    from movae_tpu_torch.models import get_network, init_model
    from movae_tpu_torch.utils.weights import load_jax_params

    jm = jget(SIZE, 3, vq2_args(**kw))
    params, bstats = jinit(jm, jax.random.PRNGKey(seed), SIZE, 3)
    params = jax.tree_util.tree_map(np.asarray, params)
    bstats = jax.tree_util.tree_map(np.asarray, bstats)
    tm = init_model(get_network(SIZE, 3, vq2_args(**kw)), seed, device="cpu")
    load_jax_params(tm, params, bstats)
    return jm, params, bstats, tm


def images(seed=0, n=BATCH):
    return np.random.default_rng(seed).uniform(
        -1, 1, (n, SIZE, SIZE, 3)).astype(np.float32)


def _apply(jm, params, bstats, *args, **kw):
    return jm.apply({"params": params, "batch_stats": bstats}, *args, **kw)


def test_converted_state_dict_equals_jax_export_bit_for_bit():
    from movae_tpu.utils.torch_export import export_torch_state_dict
    from movae_tpu_torch.utils.weights import vqvae2_state_dict

    _, params, _, tm = build_pair()
    ref = export_torch_state_dict(params, {}, "vq_vae2")
    got = vqvae2_state_dict(params)
    assert list(got) == list(ref)
    assert list(tm.state_dict()) == list(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
        np.testing.assert_array_equal(tm.state_dict()[k].numpy(), ref[k],
                                      err_msg=k)


def test_ema_statistics_dropped_as_the_exporter_drops_them():
    """With EMA codebooks the codebooks come from batch_stats; their EMA
    statistics are left out unless asked for, and the EMA model loads
    them."""
    from movae_tpu_torch.utils.weights import vqvae2_state_dict

    _, params, bstats, tm = build_pair(seed=4, vq_ema=True)
    got = vqvae2_state_dict(params, bstats)
    assert not any("cluster_size" in k or "ema_embed" in k for k in got)
    np.testing.assert_array_equal(got["quantize_t.embedding.weight"],
                                  bstats["vq_top"]["embedding"])
    full = vqvae2_state_dict(params, bstats, ema_stats=True)
    assert set(full) == set(tm.state_dict())
    np.testing.assert_array_equal(tm.quantize_b.ema_embed.numpy(),
                                  bstats["vq_bottom"]["ema_embed"])


@pytest.mark.parametrize("train", [False, True])
def test_forward_losses_and_codes_match_jax(train):
    """Recons and latents within 1e-5, the three losses within 1e-5
    relative, both code grids exactly."""
    jm, params, bstats, tm = build_pair(seed=1)
    x = images(2)
    j_vec, j_dict, j_out = _apply(jm, params, bstats, jnp.asarray(x),
                                  train=train, method="forward_with_losses",
                                  rngs={"sample": jax.random.PRNGKey(0)})
    with torch.no_grad():
        t_vec, t_dict, t_out = tm.forward_with_losses(torch.tensor(x),
                                                      train=train)
    for key in ("encoding_inds_top", "encoding_inds_bottom"):
        np.testing.assert_array_equal(t_out[key].numpy(),
                                      np.asarray(j_out[key]), err_msg=key)
    for key in ("recons", "encoding_top", "encoding_bottom",
                "quantized_top", "quantized_bottom"):
        assert t_out[key].shape == j_out[key].shape, key
        np.testing.assert_allclose(t_out[key].numpy(), np.asarray(j_out[key]),
                                   rtol=1e-5, atol=1e-5, err_msg=key)
    np.testing.assert_allclose(t_vec.numpy(), np.asarray(j_vec), rtol=1e-5,
                               atol=1e-6)
    assert tm.objective_names == jm.objective_names
    for key in (*jm.objective_names, "total_loss"):
        np.testing.assert_allclose(float(t_dict[key]), float(j_dict[key]),
                                   rtol=1e-5, atol=1e-6, err_msg=key)


def test_code_indices_pair_and_decode_code_match_jax():
    """(top, bottom) grids exactly, as (B, 4, 4) and (B, 8, 8); the decoded
    images within 1e-5."""
    jm, params, bstats, tm = build_pair(seed=2)
    x = images(3)
    jt, jb = _apply(jm, params, bstats, jnp.asarray(x),
                    method="get_code_indices_pair")
    with torch.no_grad():
        tt, tb = tm.get_code_indices_pair(torch.tensor(x))
    assert tt.shape == (BATCH, SIZE // 8, SIZE // 8)
    assert tb.shape == (BATCH, SIZE // 4, SIZE // 4)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    j_dec = _apply(jm, params, bstats, jt, jb, method="decode_code")
    with torch.no_grad():
        t_dec = tm.decode_code(tt, tb)
    assert t_dec.shape == (BATCH, SIZE, SIZE, 3)
    np.testing.assert_allclose(t_dec.numpy(), np.asarray(j_dec), rtol=1e-5,
                               atol=1e-5)


def test_ema_codebooks_load_and_match_jax_forward():
    jm, params, bstats, tm = build_pair(seed=3, vq_ema=True)
    assert tm.objective_names == jm.objective_names == (
        "reconstruction_loss", "commitment_loss")
    assert not tm.quantize_t.embedding.weight.requires_grad
    x = images(4)
    _, j_dict, j_out = _apply(jm, params, bstats, jnp.asarray(x), train=False,
                              method="forward_with_losses")
    with torch.no_grad():
        _, t_dict, t_out = tm.forward_with_losses(torch.tensor(x))
    for key in ("encoding_inds_top", "encoding_inds_bottom"):
        np.testing.assert_array_equal(t_out[key].numpy(),
                                      np.asarray(j_out[key]))
    np.testing.assert_allclose(float(t_dict["total_loss"]),
                               float(j_dict["total_loss"]), rtol=1e-5)
    # in training both levels' EMA updates are returned, not applied
    with torch.no_grad():
        out = tm(torch.tensor(x), train=True,
                 generator=torch.Generator().manual_seed(0))
    assert set(out["batch_stats"]) == set(tm.batch_stats())
    np.testing.assert_array_equal(tm.quantize_t.cluster_size.numpy(),
                                  bstats["vq_top"]["cluster_size"])


@pytest.mark.parametrize("kw", [
    {}, {"vq_ema": True}, {"lambda_weights": [1.0, 0.5, 2.0]},
    {"loss_weights": {"reconstruction_loss": 1.0, "embedding_loss": 1.0,
                      "commitment_loss": 0.25}}])
def test_registry_names_order_and_defaults_match_jax(kw):
    """Objective order (reconstruction, commitment, embedding), the
    registry's defaults (commitment 1.0, embedding 0.25), EMA dropping the
    embedding loss, and the feature seam."""
    from movae_tpu.models import get_network as jget
    from movae_tpu_torch.models import VQVAE2, get_network

    jm, tm = jget(SIZE, 3, vq2_args(**kw)), get_network(SIZE, 3,
                                                       vq2_args(**kw))
    assert isinstance(tm, VQVAE2)
    assert tm.objective_names == jm.objective_names
    assert tm.lambda_weights == jm.lambda_weights
    assert tm.feature_names == jm.feature_names == ("encoding_top",
                                                    "encoding_bottom")
    if not kw:
        assert dict(tm.lambda_weights) == {"reconstruction_loss": 1.0,
                                           "commitment_loss": 1.0,
                                           "embedding_loss": 0.25}


def test_trunk_pullback_is_the_jax_vjp_of_the_whole_trunk():
    """The feature engine's pullback (``autograd.grad`` of both features
    with their cotangents) equals the JAX VJP of x -> (enc_t, enc_b): enc_t's
    cotangent flows on through enc_t into enc_b's parameters."""
    from movae_tpu.utils.torch_export import export_torch_state_dict

    jm, params, bstats, tm = build_pair(seed=5)
    x = images(5)
    rng = np.random.default_rng(6)
    ct_t = rng.normal(size=(BATCH, 4, 4, HIDDEN[0])).astype(np.float32)
    ct_b = rng.normal(size=(BATCH, 8, 8, HIDDEN[0])).astype(np.float32)

    def trunk(p):
        (et, eb), _ = jm.apply({"params": p, "batch_stats": bstats},
                               jnp.asarray(x), method="trunk")
        return et, eb

    _, vjp = jax.vjp(trunk, params)
    (j_grads,) = vjp((jnp.asarray(ct_t), jnp.asarray(ct_b)))
    ref = export_torch_state_dict(
        jax.tree_util.tree_map(np.asarray, j_grads), {}, "vq_vae2")
    (et, eb), _ = tm.trunk(torch.tensor(x))
    names = [n for n, _ in tm.named_parameters()]
    grads = torch.autograd.grad((et, eb), list(tm.parameters()),
                                grad_outputs=(torch.tensor(ct_t),
                                              torch.tensor(ct_b)),
                                allow_unused=True)
    checked = 0
    for name, g in zip(names, grads):
        if not name.startswith(("enc_b.", "enc_t.")):
            assert g is None, name
            continue
        scale = max(float(np.abs(ref[name]).max()), 1e-6)
        err = float(np.abs(g.numpy() - ref[name]).max()) / scale
        assert err < 1e-5, (name, err)
        checked += 1
    assert checked == len([n for n in names if n.startswith("enc_")])


def _jax_step(jm, params, bstats, agg):
    from movae_tpu.moo import AggregatorConfig, init_state
    from movae_tpu.train.optim import build_optimizer
    from movae_tpu.train.state import TrainState
    from movae_tpu.train.step import make_train_step

    cfg = AggregatorConfig(name=agg, num_objectives=len(jm.objective_names))
    state = TrainState.create(jm.apply, params, bstats,
                              build_optimizer("adam", LR, eps=EPS),
                              init_state(cfg))
    return state, jax.jit(make_train_step(jm, cfg, 1, STEPS))


def _port_step(tm, agg):
    from movae_tpu_torch.moo import AggregatorConfig, init_state
    from movae_tpu_torch.train.optim import build_optimizer
    from movae_tpu_torch.train.state import TrainState
    from movae_tpu_torch.train.step import make_train_step

    cfg = AggregatorConfig(name=agg, num_objectives=len(tm.objective_names))
    state = TrainState.create(tm, build_optimizer("adam", LR, eps=EPS),
                              init_state(cfg))
    return state, make_train_step(tm, cfg, 1, STEPS)


@pytest.mark.parametrize("agg", ["sum", "upgrad"])
def test_train_lockstep_matches_jax(agg):
    """6 steps from one init on one batch stream: losses and task weights
    within 2e-4 relative (2e-5 absolute), the hierarchical codebook usage
    exactly, parameters within 5e-4 — tests/test_torch_port_step.py's
    tolerances."""
    from movae_tpu.utils.torch_export import export_torch_state_dict

    jm, params, bstats, tm = build_pair(seed=11)
    jstate, jstep = _jax_step(jm, params, bstats, agg)
    tstate, tstep = _port_step(tm, agg)
    rng = jax.random.PRNGKey(3)
    for i in range(STEPS):
        xb = images(100 + i)
        rng, sub = jax.random.split(rng)
        jstate, jmet = jstep(jstate, jnp.asarray(xb), sub)
        tstate, tmet = tstep(tstate, torch.tensor(xb))
        for key in ("total_loss", *jm.objective_names):
            np.testing.assert_allclose(float(tmet[key]), float(jmet[key]),
                                       rtol=2e-4, atol=2e-5,
                                       err_msg=f"step {i} {key} ({agg})")
        for j in range(len(jm.objective_names)):
            np.testing.assert_allclose(float(tmet[f"task_{j}_weight"]),
                                       float(jmet[f"task_{j}_weight"]),
                                       rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(
            float(tmet["codebook_usage_percentage"]),
            float(jmet["codebook_usage_percentage"]))
        assert float(tmet["skipped_nonfinite"]) == 0.0
        ref = export_torch_state_dict(jstate.params, {}, "vq_vae2")
        got = tm.state_dict()
        delta = max(float(np.max(np.abs(np.asarray(v) - got[k].numpy())))
                    for k, v in ref.items())
        assert delta < 5e-4, f"step {i}: max param divergence {delta:.2e}"
    assert tstate.step == int(jstate.step) == STEPS


def test_ema_step_commits_both_codebooks():
    _, _, _, tm = build_pair(seed=13, vq_ema=True)
    state, step = _port_step(tm, "upgrad")
    before = {k: v.clone() for k, v in tm.batch_stats().items()}
    _, met = step(state, torch.tensor(images(4)),
                  torch.Generator().manual_seed(0))
    assert float(met["skipped_nonfinite"]) == 0.0
    after = tm.batch_stats()
    assert set(after) == {f"quantize_{s}.{k}" for s in "tb" for k in (
        "embedding.weight", "cluster_size", "ema_embed")}
    assert all(not torch.equal(before[k], after[k]) for k in after)
