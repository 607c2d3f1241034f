"""Code comparison across frameworks, with near ties allowed.

The port's nearest code (``movae_tpu_torch/kernels/nearest_code.py``, and
the CUDA kernel) minimizes ``||e||^2 - 2 z.e``; the JAX package's default
XLA path (``movae_tpu/ops/vq.py:_nearest_inds_xla``) adds ``||z||^2``
first, which in float32 swamps gaps of a few 1e-6 when ``||z||^2`` is ~64.
So at init-scale codebooks the two can pick different codes on near ties,
and the port's pick is the float64 argmin. ``assert_codes_match`` is the
comparison every port test that holds codes against JAX uses.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

# a differing row is a near tie when the float64 gap between the two picks
# is within TIE_REL of the picked distance (plus 1): float32 rounding of a
# sum of terms ~||z||^2 moves a distance by ~1e-7 of it
TIE_REL = 1e-5


def assert_codes_match(port, ref, z, codebook, rel: float = TIE_REL):
    """``port`` and ``ref`` (any shape, one code per row of ``z`` (N, D) in
    order) must be equal except at rows whose float64 squared distances to
    the two picks lie within ``rel * (1 + distance)``; there the port's pick
    must be the float64 argmin. Returns the number of near-tie rows."""
    port = np.asarray(port).reshape(-1).astype(np.int64)
    ref = np.asarray(ref).reshape(-1).astype(np.int64)
    z = np.asarray(z, np.float64).reshape(len(port), -1)
    cb = np.asarray(codebook, np.float64)
    diff = np.nonzero(port != ref)[0]
    if len(diff) == 0:
        return 0
    zd = z[diff]
    dist = ((zd[:, None, :] - cb[None, :, :]) ** 2).sum(-1)
    rows = np.arange(len(diff))
    d_port, d_ref = dist[rows, port[diff]], dist[rows, ref[diff]]
    gap = np.abs(d_port - d_ref)
    tie = gap <= rel * (1.0 + np.minimum(d_port, d_ref))
    best = dist.min(axis=1)
    argmin = d_port <= best + 1e-12 * (1.0 + best)
    bad = diff[~(tie & argmin)]
    assert len(bad) == 0, (
        f"{len(bad)} of {len(port)} codes differ away from a near tie or "
        f"off the float64 argmin (rows {bad[:8].tolist()}, gaps "
        f"{gap[~(tie & argmin)][:8].tolist()})")
    return len(diff)


def _two_code_case():
    cb = np.array([[1.0, 0.0], [-1.0, 0.0], [0.0, 3.0]])
    z = np.array([[0.9, 0.1], [1e-7, 0.5], [0.0, 2.0]])
    return z, cb


def test_equal_codes_and_a_near_tie_pass():
    z, cb = _two_code_case()
    # row 1 sits 1e-7 to the right of the two codes' midplane: code 0 is
    # the float64 argmin, code 1 a near tie
    assert assert_codes_match([0, 0, 2], [0, 0, 2], z, cb) == 0
    assert assert_codes_match([0, 0, 2], [0, 1, 2], z, cb) == 1


@pytest.mark.parametrize("port,ref", [
    ([1, 0, 2], [0, 0, 2]),   # far apart
    ([0, 1, 2], [0, 0, 2]),   # a near tie, but not the float64 argmin
    ([0, 0, 0], [0, 0, 2])])
def test_a_real_mismatch_or_a_non_argmin_pick_fails(port, ref):
    z, cb = _two_code_case()
    with pytest.raises(AssertionError):
        assert_codes_match(port, ref, z, cb)


def test_jax_default_path_near_ties_at_init_scale():
    """The measured case: z ~ N(0, 1) rows at D=64 against a K=512 codebook
    at its init scale U(-1/K, 1/K). The JAX default path and the port may
    pick different codes only on near ties, and there the port holds the
    float64 argmin."""
    from movae_tpu.ops.vq import _nearest_inds_xla
    from movae_tpu_torch.kernels.nearest_code import nearest_code_plain

    rng = np.random.default_rng(0)
    n, k, d = 65536, 512, 64
    z = rng.standard_normal((n, d)).astype(np.float32)
    cb = rng.uniform(-1.0 / k, 1.0 / k, (k, d)).astype(np.float32)
    ref = np.asarray(_nearest_inds_xla(jnp.asarray(z), jnp.asarray(cb)))
    port = nearest_code_plain(torch.from_numpy(z),
                              torch.from_numpy(cb)).numpy()
    ties = assert_codes_match(port, ref, z, cb)
    assert ties <= n // 1000, ties
