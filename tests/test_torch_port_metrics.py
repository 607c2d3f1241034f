"""Port metrics (movae_tpu_torch/ops/resize.py, metrics/{pixel,hv,features}.py)
against the JAX package on the same seeded numpy inputs.

Tolerances: resize and ``inception_preprocess`` within rtol=atol=1e-4 (the
JAX module sums its taps as a matmul, torch in ATen's order, as in
tests/test_metric_tower_oracle.py); SSIM, PSNR and SSNR within 1e-5; the
hypervolume exactly; FID, KID, IS and precision/recall from shared features
bit for bit (the same numpy code on both sides), except IS from logits,
whose float32 softmax runs in torch here and in XLA there (the mean within
1e-6 relative, the std within 1e-5).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402


def _nhwc(x):
    return np.asarray(x.numpy() if torch.is_tensor(x) else x)


RESIZE_CASES = [
    ((2, 32, 32, 3), (299, 299), True),    # the FID/IS upscale path
    ((2, 512, 384, 3), (299, 224), True),  # downscale, non-square
    ((1, 64, 48, 2), (48, 96), True),      # mixed up/down
    ((2, 40, 56, 3), (20, 28), False),     # classic kernel, downscale
    ((1, 17, 23, 1), (51, 46), False),     # classic kernel, upscale
]


@pytest.mark.parametrize("mode", ["bicubic", "bilinear"])
@pytest.mark.parametrize("shape,out,aa", RESIZE_CASES)
def test_resize_matches_jax(mode, shape, out, aa):
    from movae_tpu.ops import resize as jres
    from movae_tpu_torch.ops import resize as tres

    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    want = np.asarray(getattr(jres, f"resize_{mode}")(
        jnp.asarray(x), out[0], out[1], antialias=aa))
    got = getattr(tres, f"resize_{mode}")(torch.from_numpy(x), out[0],
                                          out[1], antialias=aa)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(_nhwc(got), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("method", ["bicubic", "bilinear"])
@pytest.mark.parametrize("hw", [(32, 32), (32, 48), (320, 299)])
def test_inception_preprocess_matches_jax(method, hw):
    from movae_tpu.metrics.features import inception_preprocess as jprep
    from movae_tpu_torch.metrics.features import inception_preprocess

    x = np.random.default_rng(1).uniform(
        -1.2, 1.2, (2, hw[0], hw[1], 3)).astype(np.float32)
    want = np.asarray(jprep(jnp.asarray(x), method=method))
    got = _nhwc(inception_preprocess(torch.from_numpy(x), method=method))
    assert got.shape == want.shape == (2, 299, 299, 3)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def _pair(rng_seed, n, signed):
    rng = np.random.default_rng(rng_seed)
    lo = -1.0 if signed else 0.0
    a = rng.uniform(lo, 1.0, (n, 24, 20, 3)).astype(np.float32)
    b = np.clip(a + 0.2 * rng.standard_normal(a.shape), lo,
                1.0).astype(np.float32)
    return a, b


@pytest.mark.parametrize("metric", ["ssim", "ssim_per_image", "psnr",
                                    "ssnr"])
@pytest.mark.parametrize("signed", [False, True], ids=["01", "pm1"])
@pytest.mark.parametrize("n", [1, 5], ids=["unbatched", "batched"])
def test_pixel_metrics_match_jax(metric, signed, n):
    from movae_tpu.metrics import pixel as jpix
    from movae_tpu_torch.metrics import pixel as tpix

    a, b = _pair(2, n, signed)
    name, kw = metric, {}
    if metric == "ssim_per_image":
        name, kw = "ssim", {"size_average": False}
    want = np.asarray(getattr(jpix, name)(jnp.asarray(a), jnp.asarray(b),
                                          **kw))
    got = getattr(tpix, name)(torch.from_numpy(a), torch.from_numpy(b), **kw)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_auto_range_reads_the_whole_batch_minimum():
    """One negative pixel anywhere in the batch maps every image from
    [-1, 1] to [0, 1], in both packages."""
    from movae_tpu.metrics import pixel as jpix
    from movae_tpu_torch.metrics import pixel as tpix

    a, b = _pair(3, 3, False)
    a[2, 0, 0, 0] = -0.5
    want = np.asarray(jpix.psnr(jnp.asarray(a), jnp.asarray(b)))
    got = tpix.psnr(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    alone = tpix.psnr(torch.from_numpy(a[:2]), torch.from_numpy(b[:2]))
    assert abs(float(alone) - float(got)) > 0.1


HV_CASES = [
    (np.array([[0.5, 0.5]]), np.array([1.1, 1.1])),
    (np.array([[0.2, 0.9], [0.9, 0.2], [0.5, 0.5], [1.2, 0.1]]),
     np.array([1.1, 1.1])),
    (np.random.default_rng(4).uniform(0, 1, (7, 3)), np.full(3, 1.1)),
    (np.random.default_rng(5).uniform(0, 1.3, (6, 4)), np.full(4, 1.2)),
    (np.array([[2.0, 2.0]]), np.array([1.1, 1.1])),
]


@pytest.mark.parametrize("case", range(len(HV_CASES)))
def test_hypervolume_matches_jax_exactly(case):
    from movae_tpu.metrics import hv as jhv
    from movae_tpu_torch.metrics import hv as thv

    pts, ref = HV_CASES[case]
    assert thv.hypervolume(pts, ref) == jhv.hypervolume(pts, ref)
    assert thv.HVIndicator(ref)(pts) == jhv.HVIndicator(ref)(pts)


@pytest.mark.parametrize("keys,hv_ref", [
    (("a",), None), (("a", "b"), None), (("a", "b"), {"a": 2.0}),
    (("a", "b", "c"), [1.0, 2.0, 3.0]), (("a", "b"), [1.0, 2.0, 3.0])])
def test_build_hv_indicator_matches_jax(keys, hv_ref):
    from movae_tpu.metrics import hv as jhv
    from movae_tpu_torch.metrics import hv as thv

    got, want = (thv.build_hv_indicator(keys, hv_ref),
                 jhv.build_hv_indicator(keys, hv_ref))
    if want is None:
        assert got is None
    else:
        np.testing.assert_array_equal(got.ref_point, want.ref_point)


def _features(seed, n, d):
    return np.random.default_rng(seed).standard_normal((n, d))


@pytest.mark.parametrize("n,d", [(6, 4), (40, 8), (24, 64)])
def test_fid_kid_from_features_bitwise(n, d):
    """(24, 64) has rank-deficient covariances: sqrtm comes back complex
    and the imaginary-part guard takes its real part."""
    from movae_tpu.metrics import features as jf
    from movae_tpu_torch.metrics import features as tf

    a, b = _features(6, n, d), _features(7, n, d) + 0.3
    got = tf.fid_from_features(a, b)
    assert np.isfinite(got) and got > 0
    assert got == jf.fid_from_features(a, b)
    for kw in ({"seed": 0}, {"seed": 3, "subset_size": 5, "n_subsets": 7}):
        assert tf.kid_from_features(a, b, **kw) == jf.kid_from_features(
            a, b, **kw)
    empty = np.zeros((0, d))
    assert np.isnan(tf.fid_from_features(empty, b))
    assert np.isnan(tf.kid_from_features(a[:1], b[:1]))


@pytest.mark.parametrize("nearest_only", [True, False])
def test_precision_recall_bitwise(nearest_only):
    from movae_tpu.metrics import features as jf
    from movae_tpu_torch.metrics import features as tf

    a, b = _features(8, 30, 5), _features(9, 25, 5) + 0.5
    got = tf.precision_recall_from_features(a, b, nearest_only=nearest_only)
    assert got == jf.precision_recall_from_features(
        a, b, nearest_only=nearest_only)


def test_precision_recall_defaults_to_nearest_only():
    from movae_tpu_torch.metrics import features as tf

    a, b = _features(10, 30, 5), _features(11, 25, 5) + 0.5
    default = tf.precision_recall_from_features(a, b)
    assert default == tf.precision_recall_from_features(a, b,
                                                        nearest_only=True)
    # on these features the two variants differ, so the default is seen
    assert default != tf.precision_recall_from_features(a, b,
                                                        nearest_only=False)


@pytest.mark.parametrize("n,splits", [(25, 10), (40, 4), (3, 10)])
def test_inception_score_from_probs_bitwise(n, splits):
    from movae_tpu.metrics import features as jf
    from movae_tpu_torch.metrics import features as tf

    probs = np.random.default_rng(12).dirichlet(np.ones(7), size=n)
    got = tf.inception_score_from_probs(probs, splits)
    want = jf.inception_score_from_probs(probs, splits)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_inception_score_from_logits_matches_jax(monkeypatch):
    """``calculate_inception_score`` on the same tower logits: the softmax
    runs in torch in the port and in XLA in the JAX package."""
    from movae_tpu.metrics import features as jf
    from movae_tpu_torch.metrics import features as tf

    logits = np.random.default_rng(13).normal(
        size=(20, 1000)).astype(np.float32) * 3
    seen = {}

    class _Tower:
        def extract(self, images, batch_size, want_logits, method):
            seen[len(seen)] = (want_logits, method)
            return None, logits

    monkeypatch.setattr(jf.InceptionTower, "get", classmethod(
        lambda cls: _Tower()))
    monkeypatch.setattr(tf.InceptionTower, "get", classmethod(
        lambda cls, device=None: _Tower()))
    images = np.zeros((20, 8, 8, 3), np.float32)
    got = tf.calculate_inception_score(images, splits=4)
    want = jf.calculate_inception_score(images, splits=4)
    # float32 softmax in two libraries (an ulp or so per probability): the
    # mean within 1e-6; the std, a difference of near-equal split scores,
    # within 1e-5
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5)
    # both ask the tower for the BILINEAR logits pass
    assert seen == {0: (True, "bilinear"), 1: (True, "bilinear")}
