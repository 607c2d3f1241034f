"""Port samplers (movae_tpu_torch/models/pixelcnn.py: sample_naive,
sample_fast, sample_fast_snail, sample_prior, sample_hierarchical) against
the JAX package's priors and samplers, with the same numpy Gumbel noise on
both sides: the JAX samplers draw pixel t as ``categorical(fold_in(rng, t),
logits / T)``, i.e. argmax(logits / T + Gumbel noise), and the test-side
oracles below draw argmax(logits / T + g[t]) from the flax model's full
forward. Sizes follow tests/test_pixelcnn.py (K=16, E=8, 32 channels; flat
grids up to 7x5, hierarchical 3x3 over 6x6)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from movae_tpu.models import pixelcnn as jpc  # noqa: E402
from movae_tpu_torch.models import pixelcnn as tpc  # noqa: E402
from movae_tpu_torch.utils import weights  # noqa: E402

K, E, HC = 16, 8, 32
SNAIL = dict(num_embeddings=K, embedding_dim=E, hidden_channels=HC,
             num_blocks=2, num_res_blocks_per_layer=2, num_heads=2,
             dropout=0.0)


def pair(kind, cond=0, grid=(6, 6), seed=0):
    """(flax module, numpy params, port module with those params)."""
    if kind == "pixelcnn":
        kw = dict(num_embeddings=K, embedding_dim=E, hidden_channels=HC,
                  num_layers=3, conditional_channels=cond)
        jm, tm = jpc.PixelCNN(**kw), tpc.PixelCNN(**kw)
    else:
        jm = jpc.PixelSNAIL(**SNAIL, conditional_channels=cond)
        tm = tpc.PixelSNAIL(**SNAIL, conditional_channels=cond)
    c = jnp.zeros((2, *grid, cond)) if cond else None
    params = jm.init(jax.random.PRNGKey(seed), jnp.zeros((2, *grid),
                                                         jnp.int32), c)
    params = jax.tree_util.tree_map(np.asarray, params["params"])
    tm.reset_parameters(torch.Generator().manual_seed(seed))
    weights.load_jax_prior_params(tm, params)
    return jm, params, tm


def gumbel(seed, length, b):
    return np.random.default_rng(seed).gumbel(size=(length, b, K)).astype(
        np.float32)


def condition(seed, b, grid, c):
    return np.random.default_rng(seed).normal(size=(b, *grid, c)).astype(
        np.float32)


def flax_oracle(apply_fn, g, b, h, w, temperature=1.0):
    """Raster loop over the flax model's full forward, drawing
    argmax(logits / T + g[t]) at pixel t."""
    z = jnp.zeros((b, h, w), jnp.int32)
    for t in range(h * w):
        i, j = divmod(t, w)
        logits = apply_fn(z)[:, i, j] / temperature
        z = z.at[:, i, j].set(jnp.argmax(logits + g[t], axis=-1))
    return np.asarray(z)


@pytest.mark.parametrize("kind,cond,grid,temperature", [
    ("pixelcnn", 0, (6, 6), 1.0), ("pixelcnn", 4, (7, 5), 0.7),
    ("pixelsnail", 0, (5, 5), 1.0)])
def test_naive_sampler_matches_flax_oracle(kind, cond, grid, temperature):
    """sample_naive draws the codes of the flax oracle under the same
    noise, exactly."""
    b = 2
    jm, params, tm = pair(kind, cond, grid)
    g = gumbel(1, grid[0] * grid[1], b)
    c = condition(2, b, grid, cond) if cond else None
    want = flax_oracle(lambda z: jm.apply(
        {"params": params}, z, None if c is None else jnp.asarray(c)),
        g, b, *grid, temperature)
    got = tpc.sample_naive(tm, None, b, *grid,
                           condition=None if c is None else torch.tensor(c),
                           temperature=temperature, gumbel=torch.tensor(g))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("cond,grid", [(0, (6, 6)), (4, (6, 6)),
                                       (4, (7, 5))])
def test_fast_sampler_matches_naive(cond, grid):
    """The cached PixelCNN sampler draws sample_naive's codes, exactly
    (with and without condition, on a non-square grid)."""
    b = 3
    _, _, tm = pair("pixelcnn", cond, grid)
    g = torch.tensor(gumbel(3, grid[0] * grid[1], b))
    c = torch.tensor(condition(4, b, grid, cond)) if cond else None
    naive = tpc.sample_naive(tm, None, b, *grid, condition=c, gumbel=g)
    fast = tpc.sample_fast(tm, None, b, *grid, condition=c, gumbel=g)
    np.testing.assert_array_equal(fast.numpy(), naive.numpy())


@pytest.mark.parametrize("cond,grid", [(0, (5, 5)), (3, (4, 6))])
def test_fast_snail_f32_matches_naive(cond, grid):
    """The KV-cached PixelSNAIL sampler with the float32 cache draws
    sample_naive's codes, exactly."""
    b = 2
    _, _, tm = pair("pixelsnail", cond, grid)
    g = torch.tensor(gumbel(5, grid[0] * grid[1], b))
    c = torch.tensor(condition(6, b, grid, cond)) if cond else None
    naive = tpc.sample_naive(tm, None, b, *grid, condition=c, gumbel=g)
    fast = tpc.sample_fast_snail(tm, None, b, *grid, condition=c,
                                 cache_dtype=torch.float32, gumbel=g)
    np.testing.assert_array_equal(fast.numpy(), naive.numpy())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8])
def test_lossy_caches_agree_with_f32(dtype):
    """bfloat16 and int8 key/value caches draw at least 0.7 of the float32
    cache's codes (tests/test_pixelcnn.py's bound), all in range."""
    _, _, tm = pair("pixelsnail", grid=(5, 5))
    g = torch.tensor(gumbel(11, 25, 4))
    ref = tpc.sample_fast_snail(tm, None, 4, 5, 5, cache_dtype=torch.float32,
                                gumbel=g)
    got = tpc.sample_fast_snail(tm, None, 4, 5, 5, cache_dtype=dtype,
                                gumbel=g)
    assert got.shape == (4, 5, 5) and int(got.min()) >= 0
    assert int(got.max()) < K
    match = float((got == ref).float().mean())
    assert match >= 0.7, f"{dtype} cache diverged: match fraction {match}"


# forced-scoring logits against JAX's sample_fast_snail of the same cache
# dtype, as a fraction of the largest logit: float32 1e-4; bfloat16 and
# int8 round q, the cached rows and the probabilities to bfloat16 (int8 the
# rows to 1/127 of their largest value first), so a float32 difference of
# ~1e-7 upstream can move one rounding by a bfloat16 ulp (2^-8 relative) or
# one int8 step. Measured over this test's four seeds: float32 at most
# 2.6e-7, bfloat16 5.9e-6, int8 1.1e-4; the lossy bound is 1e-3.
FORCED_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-3, torch.int8: 1e-3}
JAX_DTYPE = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
             torch.int8: jnp.int8}


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("dtype", list(FORCED_TOL))
def test_forced_logits_match_jax(dtype, seed):
    """Teacher-forced scoring (forced + return_logits): the forced codes
    echo, and the per-pixel logits match JAX's within FORCED_TOL of the
    largest; with the float32 cache they also match the port's dense
    forward within 1e-4."""
    jm, params, tm = pair("pixelsnail", grid=(5, 5), seed=seed)
    forced = np.random.default_rng(3 + seed).integers(0, K, (2, 5, 5)).astype(
        np.int32)
    _, want = jpc.sample_fast_snail(jm, params, jax.random.PRNGKey(0), 2, 5,
                                    5, cache_dtype=JAX_DTYPE[dtype],
                                    forced=jnp.asarray(forced),
                                    return_logits=True)
    echoed, got = tpc.sample_fast_snail(tm, None, 2, 5, 5, cache_dtype=dtype,
                                        forced=torch.tensor(forced),
                                        return_logits=True)
    np.testing.assert_array_equal(echoed.numpy(), forced)
    want = np.asarray(want)
    scale = float(np.abs(want).max())
    err = float(np.abs(got.numpy() - want).max()) / scale
    assert err < FORCED_TOL[dtype], err
    if dtype == torch.float32:
        with torch.no_grad():
            dense = tm(torch.tensor(forced))
        np.testing.assert_allclose(got.numpy(), dense.numpy(), rtol=0,
                                   atol=1e-4 * scale)


def test_forced_scoring_follows_the_model_dtype():
    """A float64 model with a float64 cache scores a forced sequence in
    float64: its logits are the float64 dense forward's within 1e-10 of
    the largest (the float32 path sits ~1e-7 from it)."""
    _, _, tm = pair("pixelsnail", grid=(5, 5))
    tm = tm.double()
    forced = torch.tensor(np.random.default_rng(3).integers(0, K, (2, 5, 5)))
    echoed, got = tpc.sample_fast_snail(tm, None, 2, 5, 5,
                                        cache_dtype=torch.float64,
                                        forced=forced, return_logits=True)
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(echoed.numpy(), forced.numpy())
    with torch.no_grad():
        dense = tm(forced)
    scale = float(dense.abs().max())
    assert float((got - dense).abs().max()) < 1e-10 * scale


def _hier_pair(kind):
    if kind == "pixelcnn":
        kw = dict(num_embeddings=K, embedding_dim=E, hidden_channels=HC,
                  num_layers=3)
        jm, tm = jpc.HierarchicalPixelCNN(**kw), tpc.HierarchicalPixelCNN(
            **kw)
    else:
        kw = dict(num_embeddings=K, embedding_dim=E, hidden_channels=HC,
                  num_blocks_top=2, num_res_blocks_per_layer=1, num_heads=2,
                  num_layers_bottom=3, dropout=0.0)
        jm = jpc.HierarchicalPixelSNAIL(**kw)
        tm = tpc.HierarchicalPixelSNAIL(**kw)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 3, 3), jnp.int32),
                     jnp.zeros((1, 6, 6), jnp.int32))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    weights.load_jax_prior_params(tm, params)
    return jm, params, tm


@pytest.mark.parametrize("kind", ["pixelcnn", "pixelsnail"])
def test_hierarchical_matches_naive_oracle(kind):
    """sample_hierarchical with non-default depths (num_blocks_top 2,
    num_layers_bottom 3): the cached samplers (float32 cache), the naive
    ones and a flax oracle over both levels all draw the same (top, bottom)
    codes from the same noise."""
    jm, params, tm = _hier_pair(kind)
    b = 2
    gt, gb = gumbel(7, 9, b), gumbel(8, 36, b)
    top = jm.make_top_module()
    bottom = jm.make_bottom_module()
    zt = flax_oracle(lambda z: top.apply({"params": params["prior_top"]}, z),
                     gt, b, 3, 3)
    cond = jm.apply({"params": params}, jnp.asarray(zt),
                    method="condition_from_top")
    zb = flax_oracle(lambda z: bottom.apply(
        {"params": params["prior_bottom"]}, z, cond), gb, b, 6, 6)
    noise = (torch.tensor(gt), torch.tensor(gb))
    for fast in (True, False):
        got_t, got_b = tpc.sample_hierarchical(
            tm, None, b, (3, 3), (6, 6), fast=fast,
            cache_dtype=torch.float32, gumbel=noise)
        np.testing.assert_array_equal(got_t.numpy(), zt, err_msg=str(fast))
        np.testing.assert_array_equal(got_b.numpy(), zb, err_msg=str(fast))


def test_sample_prior_dispatch(monkeypatch):
    """PixelSNAIL -> sample_fast_snail (int8 cache by default); PixelCNN ->
    sample_wavefront wherever it takes fewer fronts than the grid has pixels
    (wider than s = k // 2 + 1 = 4 at k = 7: 8x8, 16x16, 32x32, 64x64 and
    3x5 here), else sample_fast (4x4, 64x4 and one row); fast=False ->
    sample_naive."""
    calls = []
    for name in ("sample_naive", "sample_fast", "sample_fast_snail",
                 "sample_wavefront"):
        monkeypatch.setattr(tpc, name, lambda *a, _n=name, **kw: calls.append(
            (_n, kw.get("cache_dtype"))))
    cnn, snail = pair("pixelcnn")[2], pair("pixelsnail")[2]
    tpc.sample_prior(snail, None, 1, 4, 4)
    for grid in ((8, 8), (16, 16), (32, 32), (64, 64), (3, 5), (4, 4),
                 (64, 4), (1, 9)):
        tpc.sample_prior(cnn, None, 1, *grid)
    tpc.sample_prior(cnn, None, 1, 32, 32, fast=False)
    tpc.sample_prior(snail, None, 1, 4, 4, fast=False)
    assert calls == [("sample_fast_snail", torch.int8)] + [
        ("sample_wavefront", None)] * 5 + [("sample_fast", None)] * 3 + [
        ("sample_naive", None)] * 2


def test_generator_noise_depends_on_seed_only():
    """Without noise given, each sampler draws one (L, B, K) Gumbel array up
    front from the generator: the same seed gives the same codes in every
    sampler, and the noise of gumbel_noise."""
    _, _, tm = pair("pixelcnn")
    seeded = lambda: torch.Generator().manual_seed(5)  # noqa: E731
    g = tpc.gumbel_noise(seeded(), 36, 2, K, torch.device("cpu"))
    a = tpc.sample_fast(tm, seeded(), 2, 6, 6)
    b = tpc.sample_naive(tm, seeded(), 2, 6, 6)
    c = tpc.sample_fast(tm, None, 2, 6, 6, gumbel=g)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    np.testing.assert_array_equal(a.numpy(), c.numpy())
    with pytest.raises(ValueError, match="gumbel"):
        tpc.sample_fast(tm, None, 2, 6, 6, gumbel=g[:10])


def test_slice_images_to_codes_to_sampled_images():
    """The slice as a whole at a small size: uint8 images -> VQ-VAE-2 codes
    (as JAX extracts them) -> the hierarchical prior's loss on them (as
    JAX's) -> codes sampled under shared noise (as the flax oracle draws
    them) -> images decoded (as JAX decodes them)."""
    import types

    from movae_tpu.models import get_network as jget, init_model as jinit
    from movae_tpu.train.prior import extract_codes as jextract
    from movae_tpu_torch.models import get_network, init_model
    from movae_tpu_torch.train.prior import extract_codes
    from movae_tpu_torch.utils.weights import load_jax_params

    vq = dict(arch="vq_vae2", embedding_dim=E, num_embeddings=K,
              hidden_dims=(16, 32), num_residual_layers=1,
              recons_activation="none")
    jvq = jget(24, 3, vq)
    vp, vs = jinit(jvq, jax.random.PRNGKey(1), 24, 3)
    tvq = init_model(get_network(24, 3, vq), 0, device="cpu")
    load_jax_params(tvq, jax.tree_util.tree_map(np.asarray, vp),
                    jax.tree_util.tree_map(np.asarray, vs))
    imgs = np.random.default_rng(9).integers(0, 256, (2, 24, 24, 3),
                                             dtype=np.uint8)
    state = types.SimpleNamespace(params=vp, batch_stats=vs)
    jt, jb = jextract(jvq, state, True, True)(imgs)
    tt, tb = extract_codes(tvq, True, hierarchical=True)(imgs)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))

    jm, params, tm = _hier_pair("pixelcnn")
    want = jm.apply({"params": params}, jt, jb, method="loss_function")
    with torch.no_grad():
        got = tm.loss_function(tt, tb, train=False)
    np.testing.assert_allclose(float(got["total_loss"]),
                               float(want["total_loss"]), rtol=1e-5)

    gt, gb = gumbel(12, 9, 2), gumbel(13, 36, 2)
    st, sb = tpc.sample_hierarchical(tm, None, 2, (3, 3), (6, 6),
                                     gumbel=(torch.tensor(gt),
                                             torch.tensor(gb)))
    zt = flax_oracle(lambda z: jm.make_top_module().apply(
        {"params": params["prior_top"]}, z), gt, 2, 3, 3)
    np.testing.assert_array_equal(st.numpy(), zt)
    with torch.no_grad():
        t_img = tvq.decode_code(st, sb)
    j_img = jvq.apply({"params": vp, "batch_stats": vs}, jnp.asarray(zt),
                      jnp.asarray(sb.numpy()), method="decode_code")
    assert t_img.shape == (2, 24, 24, 3)
    np.testing.assert_allclose(t_img.numpy(), np.asarray(j_img), rtol=1e-5,
                               atol=1e-5)
