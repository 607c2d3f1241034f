"""Port hierarchical priors (movae_tpu_torch/models/pixelcnn.py:
HierarchicalPixelCNN / HierarchicalPixelSNAIL, utils/weights.py:
hierarchical_state_dict, and train/prior.py on (top, bottom) code levels)
against the JAX package's on the same seeded inputs and the same weights.

The ``train_prior`` lockstep is set up as tests/test_torch_port_prior.py sets
up the flat one: frozen code levels handed to the JAX ``train_prior`` as
``results["prior_levels"]``, the per-step CE captured in
``prior_step_trace``, the prior initialized from ``PRNGKey(seed + 1)`` and
loaded into the port, dropout 0 and Adam eps 1e-4 on both sides.
"""

import argparse
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from movae_tpu.models import pixelcnn as jpc  # noqa: E402
from movae_tpu_torch.models import pixelcnn as tpc  # noqa: E402
from movae_tpu_torch.utils import weights  # noqa: E402

K, D, HC = 32, 8, 16
TOP = 4  # top grid; the bottom grid is twice as wide
N, BS, SEED, EPOCHS = 20, 8, 0, 2  # 3 batches per epoch, the last ragged


def _configs(kind):
    if kind == "hierarchical_pixelcnn":
        kw = dict(num_embeddings=K, embedding_dim=D, hidden_channels=HC,
                  num_layers=2)
        return jpc.HierarchicalPixelCNN(**kw), tpc.HierarchicalPixelCNN(**kw)
    kw = dict(num_embeddings=K, embedding_dim=D, hidden_channels=HC,
              num_blocks_top=2, num_res_blocks_per_layer=1, num_heads=2,
              num_layers_bottom=3, dropout=0.0)
    return (jpc.HierarchicalPixelSNAIL(**kw),
            tpc.HierarchicalPixelSNAIL(**kw))


def build_pair(kind, top=TOP, seed=0):
    """The same hierarchical prior in both frameworks: (jax module, numpy
    params, port module on the CPU with those params)."""
    jm, tm = _configs(kind)
    params = jm.init({"params": jax.random.PRNGKey(seed),
                      "dropout": jax.random.PRNGKey(seed)},
                     jnp.zeros((2, top, top), jnp.int32),
                     jnp.zeros((2, 2 * top, 2 * top), jnp.int32))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    tm.reset_parameters(torch.Generator().manual_seed(seed))
    weights.load_jax_prior_params(tm, params)
    return jm, params, tm


def code_pair(seed, b, top=TOP):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, K, (b, top, top)).astype(np.int32),
            rng.integers(0, K, (b, 2 * top, 2 * top)).astype(np.int32))


KINDS = ["hierarchical_pixelcnn", "hierarchical_pixelsnail"]


@pytest.mark.parametrize("kind", KINDS)
def test_hierarchical_state_dict_equals_jax_export_bit_for_bit(kind):
    from movae_tpu.utils.torch_export import export_torch_state_dict

    _, params, tm = build_pair(kind)
    ref = export_torch_state_dict(params, {}, kind)
    got = weights.hierarchical_state_dict(params)
    assert list(got) == list(ref)
    assert set(got) == set(tm.state_dict())
    for k in ref:
        assert got[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
        np.testing.assert_array_equal(tm.state_dict()[k].numpy(), ref[k],
                                      err_msg=k)


@pytest.mark.parametrize("kind,top", [
    ("hierarchical_pixelcnn", 4), ("hierarchical_pixelsnail", 4),
    ("hierarchical_pixelcnn", 8), ("hierarchical_pixelsnail", 8)])
def test_logits_losses_and_ce_grads_match_flax(kind, top):
    """Logits within 1e-4 relative (1e-5 absolute), the three losses within
    1e-5 relative, every CE gradient within 1e-4 of its largest value (the
    key biases, whose gradient is 0, below 1e-8 on both sides)."""
    jm, params, tm = build_pair(kind, top, seed=1)
    zt, zb = code_pair(top, 2, top)
    j_out = jm.apply({"params": params}, jnp.asarray(zt), jnp.asarray(zb))
    with torch.no_grad():
        t_out = tm(torch.tensor(zt), torch.tensor(zb))
    for key in ("logits_top", "logits_bottom"):
        assert t_out[key].shape == j_out[key].shape, key
        np.testing.assert_allclose(t_out[key].numpy(), np.asarray(j_out[key]),
                                   rtol=1e-4, atol=1e-5, err_msg=key)
    j_cond = jm.apply({"params": params}, jnp.asarray(zt),
                      method="condition_from_top")
    with torch.no_grad():
        t_cond = tm.condition_from_top(torch.tensor(zt))
    np.testing.assert_allclose(t_cond.numpy(), np.asarray(j_cond), rtol=1e-5,
                               atol=1e-6)

    def jloss(p):
        out = jm.apply({"params": p}, jnp.asarray(zt), jnp.asarray(zb),
                       method="loss_function")
        return out["total_loss"], out

    (_, j_loss), j_grads = jax.value_and_grad(jloss, has_aux=True)(params)
    t_loss = tm.loss_function(torch.tensor(zt), torch.tensor(zb))
    for key in ("loss_top", "loss_bottom", "total_loss"):
        np.testing.assert_allclose(t_loss[key].item(), float(j_loss[key]),
                                   rtol=1e-5, err_msg=key)
    tm.zero_grad()
    t_loss["total_loss"].backward()
    ref = weights.hierarchical_state_dict(
        jax.tree_util.tree_map(np.asarray, j_grads))
    for name, p in tm.named_parameters():
        if name.endswith("k_proj.bias"):
            # softmax is invariant to a per-query constant: the key bias's
            # true gradient is 0, and both sides hold rounding (~1e-10)
            assert float(np.abs(ref[name]).max()) < 1e-8, name
            assert float(p.grad.abs().max()) < 1e-8, name
            continue
        scale = max(float(np.abs(ref[name]).max()), 1e-6)
        err = float(np.abs(p.grad.numpy() - ref[name]).max()) / scale
        assert err < 1e-4, (name, err)


def test_submodules_come_from_the_factories():
    """prior_top / prior_bottom are what make_top_module /
    make_bottom_module build, with the non-default depths."""
    _, tm = _configs("hierarchical_pixelsnail")
    assert isinstance(tm.prior_top, tpc.PixelSNAIL)
    assert len(tm.prior_top.blocks) == 2
    assert isinstance(tm.prior_bottom, tpc.PixelCNN)
    assert len(tm.prior_bottom.res_blocks) == 3
    assert tm.prior_bottom.conditional_channels == D
    assert tm.prior_bottom.conv_in.in_channels == 2 * D
    fresh = tm.make_bottom_module()
    assert ({k: v.shape for k, v in fresh.state_dict().items()}
            == {k: v.shape for k, v in tm.prior_bottom.state_dict().items()})


def prior_args(kind, **kw):
    args = argparse.Namespace(
        arch="vq_vae2", dataset="synthetic-prior-study", dataset_size=N,
        batch_size=BS, num_workers=0, seed=SEED, prior_type=kind,
        pixelcnn_epochs=EPOCHS, pixelcnn_hidden_channels=HC,
        pixelcnn_num_layers=2, pixelcnn_lr=3e-4, pixelcnn_temperature=1.0,
        pixelcnn_adam_eps=1e-4, prior_use_lmdb_codes=False,
        prior_sample_every=0, input_size=8 * TOP,
        pixelsnail_num_blocks=2, pixelsnail_num_res_blocks=1,
        pixelsnail_num_heads=2, pixelsnail_dropout=0.0)
    for k, v in kw.items():
        setattr(args, k, v)
    return args


def make_levels(seed=7):
    """Spatially correlated (top, bottom) grids: smoothed noise binned into
    K, the bottom grid following its top grid."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N, 2 * TOP + 2, 2 * TOP + 2))
    sm = x[:, :-2, :-2] + x[:, 1:-1, 1:-1] + x[:, 2:, 2:]
    q = np.clip(((sm - sm.min()) / (np.ptp(sm) + 1e-9) * K).astype(np.int32),
                0, K - 1)
    return {"top": np.ascontiguousarray(q[:, ::2, ::2]), "bottom": q}


def run_jax(kind, levels, tmp_path):
    from movae_tpu.parallel.mesh import DataParallel, make_mesh
    from movae_tpu.train import checkpoint as ckpt_lib
    from movae_tpu.train.prior import build_prior, train_prior

    args = prior_args(kind)
    prior = build_prior(args, K, True, D)
    rng = jax.random.PRNGKey(SEED + 1)
    init = prior.init({"params": rng, "dropout": rng},
                      jnp.zeros((2, TOP, TOP), jnp.int32),
                      jnp.zeros((2, 2 * TOP, 2 * TOP), jnp.int32),
                      train=False)["params"]
    trace = []
    stub = types.SimpleNamespace(num_embeddings=K, embedding_dim=D,
                                 input_size=8 * TOP)
    results = dict(model=stub, state=None, save_root=str(tmp_path),
                   parallel=DataParallel(make_mesh()), train_loader=None,
                   prior_levels=levels, prior_step_trace=trace)
    out = train_prior(results, args)
    assert out["hierarchical"] is True
    final = ckpt_lib.load_checkpoint(
        ckpt_lib.final_prior_path(str(tmp_path), kind))
    as_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return (as_np(init), trace, as_np(out["params"]),
            as_np(final["model_state_dict"]["params"]))


@pytest.mark.parametrize("kind,ce_tol", [("pixelcnn", 1e-4),
                                         ("pixelsnail", 1e-3)])
def test_train_prior_locksteps_with_jax(kind, ce_tol, tmp_path):
    """Per-step CE (the sum of both levels) within 1e-4 (pixelcnn) / 1e-3
    (pixelsnail) relative and final and best parameters within 1e-3 — the
    flat lockstep's bounds."""
    from movae_tpu_torch.train.prior import build_prior, train_prior

    levels = make_levels()
    init, j_trace, j_best, j_final = run_jax(kind, levels, tmp_path)
    args = prior_args(kind)
    prior = build_prior(args, K, True, D)
    weights.load_jax_prior_params(prior, init)
    t_trace = []
    meta = types.SimpleNamespace(num_embeddings=K, embedding_dim=D)
    out = train_prior(levels, meta, args, device="cpu", step_trace=t_trace,
                      prior=prior)
    assert out["hierarchical"] is True and out["model"] is prior

    assert len(t_trace) == len(j_trace) == EPOCHS * 3
    rel = np.abs(np.array(t_trace) - np.array(j_trace)) / np.abs(j_trace)
    assert rel.max() < ce_tol, (t_trace, j_trace)
    to_sd = weights.hierarchical_state_dict
    for got, ref in ((prior.state_dict(), to_sd(j_final)),
                     (out["params"], to_sd(j_best))):
        assert set(got) == set(ref)
        delta = max(float(np.abs(got[k].numpy() - ref[k]).max())
                    for k in ref)
        assert delta < 1e-3, delta


def test_build_prior_hierarchical_follows_jax_defaults():
    from movae_tpu.train.prior import build_prior as jbuild
    from movae_tpu_torch.train.prior import build_prior

    for kind in ("pixelcnn", "pixelsnail"):
        args = argparse.Namespace(prior_type=kind)
        jm, tm = jbuild(args, 512, True, 64), build_prior(args, 512, True, 64)
        assert type(tm).__name__ == type(jm).__name__
        assert tm.embedding_dim == jm.embedding_dim == 64
        assert tm.hidden_channels == jm.hidden_channels == 128
        bottom = tm.prior_bottom
        assert len(bottom.res_blocks) == 15 and bottom.kernel_size == 7
        if kind == "pixelsnail":
            assert len(tm.prior_top.blocks) == jm.num_blocks_top == 8
            assert tm.dropout == jm.dropout == 0.1
            assert tm.prior_top.num_heads == jm.num_heads == 8
            assert jm.num_layers_bottom == 15
        else:
            assert len(tm.prior_top.res_blocks) == jm.num_layers == 15


@pytest.mark.parametrize("normalize", [False, True])
def test_hierarchical_extract_codes_matches_jax(normalize):
    """uint8 images through the frozen VQ-VAE-2: the same (top, bottom) code
    grids as the JAX package's extract_codes, as int32."""
    from movae_tpu.models import get_network as jget, init_model as jinit
    from movae_tpu.train.prior import extract_codes as jextract
    from movae_tpu_torch.models import get_network, init_model
    from movae_tpu_torch.train.prior import extract_codes
    from movae_tpu_torch.utils.weights import load_jax_params

    vq = dict(arch="vq_vae2", embedding_dim=D, num_embeddings=K,
              hidden_dims=(16, 32), num_residual_layers=1)
    jm = jget(32, 3, vq)
    params, bstats = jinit(jm, jax.random.PRNGKey(2), 32, 3)
    tm = init_model(get_network(32, 3, vq), 0, device="cpu")
    load_jax_params(tm, jax.tree_util.tree_map(np.asarray, params),
                    jax.tree_util.tree_map(np.asarray, bstats))
    imgs = np.random.default_rng(4).integers(0, 256, (3, 32, 32, 3),
                                             dtype=np.uint8)
    state = types.SimpleNamespace(params=params, batch_stats=bstats)
    jt, jb = jextract(jm, state, True, normalize)(imgs)
    tt, tb = extract_codes(tm, normalize, hierarchical=True)(imgs)
    assert tt.dtype == tb.dtype == torch.int32
    assert tt.shape == (3, 4, 4) and tb.shape == (3, 8, 8)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
