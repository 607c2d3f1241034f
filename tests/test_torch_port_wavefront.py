"""Port wavefront sampler (movae_tpu_torch/models/pixelcnn.py:
sample_wavefront) against the port's raster samplers and the JAX package's
``sample_wavefront``, under shared Gumbel noise.

The same noise reaches every sampler as an (L, B, K) array indexed by raster
position t = i * W + j. For the JAX sampler it is built as it draws: pixel
t is ``categorical(fold_in(rng, t), logits)`` = argmax(logits +
``gumbel(fold_in(rng, t), (B, K))``). Sizes follow
tests/test_torch_port_sampling.py (K=16, E=8, 32 channels, 3 layers):
square, non-square and conditioned grids, a grid narrower than s =
k // 2 + 1, and k = 3, 5, 7. The forced logits (a front's logits on a given
code sequence) are held against the port's dense forward within
tests/test_torch_port_sampling.py's float32 bound, 1e-4 of the largest.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from movae_tpu.models import pixelcnn as jpc  # noqa: E402
from movae_tpu_torch.models import pixelcnn as tpc  # noqa: E402
from movae_tpu_torch.utils import weights  # noqa: E402
from test_torch_port_sampling import (HC, E, K, condition,  # noqa: E402
                                      gumbel)

CASES = [(7, 0, (6, 6)), (7, 4, (7, 5)), (7, 0, (5, 12)), (7, 3, (9, 3)),
         (5, 0, (6, 8)), (5, 2, (8, 5)), (3, 0, (5, 7)), (3, 4, (6, 4))]


def pair(k, cond, grid, seed=0):
    kw = dict(num_embeddings=K, embedding_dim=E, hidden_channels=HC,
              num_layers=3, kernel_size=k, conditional_channels=cond)
    jm, tm = jpc.PixelCNN(**kw), tpc.PixelCNN(**kw)
    c = jnp.zeros((2, *grid, cond)) if cond else None
    params = jm.init(jax.random.PRNGKey(seed), jnp.zeros((2, *grid),
                                                         jnp.int32), c)
    params = jax.tree_util.tree_map(np.asarray, params["params"])
    weights.load_jax_prior_params(tm, params)
    return jm, params, tm


@pytest.mark.parametrize("k,cond,grid", CASES)
def test_wavefront_draws_the_raster_samplers_codes(k, cond, grid):
    """Codes equal to sample_fast's and sample_naive's, exactly, with and
    without a condition and a temperature."""
    b = 3
    _, _, tm = pair(k, cond, grid)
    g = torch.tensor(gumbel(k + grid[0], grid[0] * grid[1], b))
    c = torch.tensor(condition(5, b, grid, cond)) if cond else None
    for temperature in (1.0, 0.6):
        wave = tpc.sample_wavefront(tm, None, b, *grid, condition=c,
                                    temperature=temperature, gumbel=g)
        assert wave.dtype == torch.int32 and wave.shape == (b, *grid)
        fast = tpc.sample_fast(tm, None, b, *grid, condition=c,
                               temperature=temperature, gumbel=g)
        np.testing.assert_array_equal(wave.numpy(), fast.numpy())
    naive = tpc.sample_naive(tm, None, b, *grid, condition=c, gumbel=g)
    np.testing.assert_array_equal(
        tpc.sample_wavefront(tm, None, b, *grid, condition=c,
                             gumbel=g).numpy(), naive.numpy())


@pytest.mark.parametrize("k,cond,grid", [(7, 0, (6, 6)), (7, 4, (7, 5)),
                                         (3, 2, (5, 9))])
def test_wavefront_matches_jax_wavefront(k, cond, grid):
    """The JAX sample_wavefront's codes, with the port given JAX's noise:
    gumbel(fold_in(rng, t), (B, K)) for each raster position t."""
    b = 2
    jm, params, tm = pair(k, cond, grid, seed=1)
    c = condition(6, b, grid, cond) if cond else None
    rng = jax.random.PRNGKey(9)
    want = jpc.sample_wavefront(jm, params, rng, b, *grid,
                                None if c is None else jnp.asarray(c))
    noise = np.stack([np.asarray(jax.random.gumbel(jax.random.fold_in(
        rng, t), (b, K))) for t in range(grid[0] * grid[1])])
    got = tpc.sample_wavefront(tm, None, b, *grid,
                               condition=None if c is None else torch.tensor(c),
                               gumbel=torch.tensor(noise))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_fronts_cover_the_grid_in_dependency_order():
    """Every pixel on exactly one front, s * (H - 1) + W fronts where the
    grid is at least s wide, and every tap a pixel's masks let through on
    an earlier front."""
    for k, (h, w) in ((7, (6, 9)), (3, (4, 4)), (7, (5, 2))):
        s = max(k // 2 + 1, 2)
        cols, bounds = tpc.front_table(h, w, k)
        fronts = [cols["t"][lo:hi] for lo, hi in bounds.tolist()]
        ts = np.concatenate(fronts)
        assert sorted(ts.tolist()) == list(range(h * w))
        if w >= s:
            assert len(fronts) == tpc.wavefront_steps(k, h, w) == s * (h - 1) + w
        front_of = {}
        for d, f in enumerate(fronts):
            for t in f.tolist():
                front_of[divmod(t, w)] = d
        p = k // 2
        for (i, j), d in front_of.items():
            seen = [(i - a, j + b) for a in range(1, p + 1)
                    for b in range(-p, p + 1)] + [(i, j - b)
                                                  for b in range(1, p + 1)]
            seen += [(i - 1, j - 1), (i - 1, j), (i - 1, j + 1), (i, j - 1)]
            for q in seen:
                if q in front_of:
                    assert front_of[q] < d, (k, (i, j), q)


def test_forced_front_logits_match_the_dense_forward():
    """A front's logits on a given code sequence (the wavefront loop with
    the codes read instead of drawn) against the port's dense forward,
    within 1e-4 of the largest logit, conditioned and not."""
    b, grid = 2, (6, 7)
    for cond in (0, 4):
        _, _, tm = pair(7, cond, grid, seed=2)
        forced = torch.tensor(np.random.default_rng(3).integers(
            0, K, (b, *grid)))
        c = torch.tensor(condition(8, b, grid, cond)) if cond else None
        logits = torch.zeros((b, grid[0] * grid[1], K))

        def read(lg, t):
            logits[:, t] = lg
            return forced.reshape(b, -1)[:, t]

        with torch.no_grad():
            got = tpc._sample_fronts(tm, b, *grid, c, 1.0, read)
            dense = tm(forced, condition=c).reshape(b, -1, K)
        np.testing.assert_array_equal(got.numpy(), forced.numpy())
        scale = float(dense.abs().max())
        assert float((logits - dense).abs().max()) < 1e-4 * scale
