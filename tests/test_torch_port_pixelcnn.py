"""Port priors (movae_tpu_torch/models/pixelcnn.py, utils/weights.py,
utils/codes.py) against the JAX package's (movae_tpu/models/pixelcnn.py,
utils/torch_export.py, utils/codes_cache.py) on the same seeded inputs and
the same weights."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from movae_tpu.models import pixelcnn as jpc  # noqa: E402
from movae_tpu_torch.models import pixelcnn as tpc  # noqa: E402
from movae_tpu_torch.utils import weights  # noqa: E402

K, D, HC = 32, 8, 16


def _configs(kind):
    if kind == "pixelcnn":
        kw = dict(num_embeddings=K, embedding_dim=D, hidden_channels=HC,
                  num_layers=2)
        return jpc.PixelCNN(**kw), tpc.PixelCNN(**kw)
    kw = dict(num_embeddings=K, embedding_dim=D, hidden_channels=HC,
              num_blocks=1, num_res_blocks_per_layer=1, num_heads=2,
              dropout=0.0)
    return jpc.PixelSNAIL(**kw), tpc.PixelSNAIL(**kw)


def build_pair(kind, grid, seed=0):
    """The same prior in both frameworks: (jax module, numpy params, port
    module on the CPU with those params)."""
    jm, tm = _configs(kind)
    params = jm.init({"params": jax.random.PRNGKey(seed),
                      "dropout": jax.random.PRNGKey(seed)},
                     jnp.zeros((2, grid, grid), jnp.int32))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    tm.reset_parameters(torch.Generator().manual_seed(seed))
    weights.load_jax_prior_params(tm, params)
    return jm, params, tm


def codes(seed, b, grid):
    return np.random.default_rng(seed).integers(
        0, K, (b, grid, grid)).astype(np.int32)


@pytest.mark.parametrize("kind", ["pixelcnn", "pixelsnail"])
def test_prior_state_dict_equals_jax_export_bit_for_bit(kind):
    from movae_tpu.utils.torch_export import export_torch_state_dict

    _, params, tm = build_pair(kind, 8)
    ref = export_torch_state_dict(params, {}, kind)
    got = getattr(weights, f"{kind}_state_dict")(params)
    assert list(got) == list(ref)
    assert set(got) == set(tm.state_dict())
    for k in ref:
        assert got[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
        np.testing.assert_array_equal(tm.state_dict()[k].numpy(), ref[k],
                                      err_msg=k)


@pytest.mark.parametrize("kind,grid", [
    ("pixelcnn", 8), ("pixelsnail", 8), ("pixelcnn", 40),
    ("pixelsnail", 40)])
def test_logits_and_ce_grads_match_flax(kind, grid):
    """At 40x40 (L=1600 > DENSE_ATTENTION_MAX_L) PixelSNAIL takes the flash
    path in the port and JAX's CPU path in the reference."""
    jm, params, tm = build_pair(kind, grid, seed=1)
    x = codes(grid, 2, grid)
    j_logits = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    t_logits = tm(torch.tensor(x)).detach().numpy()
    assert t_logits.shape == (2, grid, grid, K)
    np.testing.assert_allclose(t_logits, j_logits, rtol=1e-4, atol=1e-5)

    def jloss(p):
        return jm.apply({"params": p}, jnp.asarray(x),
                        method="loss_function")["total_loss"]

    j_ce, j_grads = jax.value_and_grad(jloss)(params)
    t_ce = tm.loss_function(torch.tensor(x))["total_loss"]
    tm.zero_grad()
    t_ce.backward()
    np.testing.assert_allclose(t_ce.item(), float(j_ce), rtol=1e-5)
    ref = getattr(weights, f"{kind}_state_dict")(
        jax.tree_util.tree_map(np.asarray, j_grads))
    for name, p in tm.named_parameters():
        g_ref = ref[name]
        scale = max(float(np.abs(g_ref).max()), 1e-6)
        err = float(np.abs(p.grad.numpy() - g_ref).max()) / scale
        assert err < 1e-4, (name, err)


def test_attention_output_flattens_dim_major(monkeypatch):
    """out_proj reads channel d * num_heads + head (the reference's
    permute-then-reshape), not head * head_dim + d."""
    nh, hd, grid = 2, 4, 3
    att = tpc.CausalAttention(nh * hd, nh, dropout=0.0)
    with torch.no_grad():
        att.out_proj.weight.copy_(torch.eye(nh * hd)[:, :, None, None])
        att.out_proj.bias.zero_()
    tagged = (100.0 * torch.arange(nh)[:, None, None]
              + torch.arange(hd)[None, None, :]).expand(nh, grid * grid, hd)
    monkeypatch.setattr(tpc, "causal_attention",
                        lambda q, *a: tagged.expand_as(q).clone())
    out = att(torch.zeros(1, nh * hd, grid, grid))
    got = out[0, :, 0, 0]
    want = torch.tensor([100.0 * (c % nh) + c // nh for c in range(nh * hd)])
    torch.testing.assert_close(got, want)


def _uniform_attention(mode, rate, grid):
    """Attention with q = k = 0 (uniform weights over the causal prefix),
    v = 1 and an identity out_proj: without dropout every output is 1."""
    att = tpc.CausalAttention(8, 2, dropout=rate, attn_dropout_mode=mode)
    with torch.no_grad():
        for proj in (att.q_proj, att.k_proj, att.v_proj):
            proj.weight.zero_()
            proj.bias.zero_()
        att.v_proj.bias.fill_(1.0)
        att.out_proj.weight.copy_(torch.eye(8)[:, :, None, None])
        att.out_proj.bias.zero_()
    gen = torch.Generator().manual_seed(0)
    x = torch.zeros(64, 8, grid, grid)
    out = att(x, train=True, generator=gen)
    return out.permute(0, 2, 3, 1).reshape(64, grid * grid, 8)


def test_weight_dropout_statistics():
    """"weights" mode drops attention weights: output i averages i + 1
    kept-and-rescaled ones, so its mean is 1 and its variance
    rate / (1 - rate) / (i + 1). "output" mode drops the output itself:
    every value is 0 or 1 / (1 - rate)."""
    rate, grid = 0.5, 6
    out = _uniform_attention("weights", rate, grid)
    assert abs(float(out.mean()) - 1.0) < 0.03
    var = out.var(dim=(0, 2))
    want = rate / (1 - rate) / torch.arange(1, grid * grid + 1)
    ratio = var / want
    assert float(ratio[:8].mean()) == pytest.approx(1.0, abs=0.15)
    assert float(ratio[8:].mean()) == pytest.approx(1.0, abs=0.15)
    out = _uniform_attention("output", rate, grid)
    # (the softmax of equal logits sums to 1 up to rounding)
    dist = torch.minimum(out.abs(), (out - 1.0 / (1 - rate)).abs())
    assert float(dist.max()) < 1e-5
    assert abs(float(out.mean()) - 1.0) < 0.03
    # evaluation (train=False) is deterministic and drops nothing
    att = tpc.CausalAttention(8, 2, dropout=rate, attn_dropout_mode="weights")
    x = torch.randn(2, 8, grid, grid, generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(att(x), att(x))


@pytest.mark.parametrize("n,bs", [(21, 8), (16, 8), (5, 8)])
def test_code_loader_order_matches_jax(n, bs):
    from movae_tpu.utils.codes_cache import CodeLoader as JLoader
    from movae_tpu_torch.utils.codes import CodeLoader

    levels = {"codes": codes(n, n, 4)}
    jl, tl = JLoader(levels, bs, seed=3), CodeLoader(levels, bs, seed=3)
    assert len(jl) == len(tl)
    for _ in range(3):
        jb, tb = list(jl), list(tl)
        assert len(jb) == len(tb)
        for (jd, jn), (td, tn) in zip(jb, tb):
            assert jn == tn
            np.testing.assert_array_equal(td["codes"], jd["codes"])
