"""The port's metric towers (movae_tpu_torch/metrics/{inception,vgg,
pretrained}.py, utils/weights.py:load_tower_npz) against the torchvision
mirrors of refharness/towers.py and the flax VGG16, with one random state
dict converted to the JAX package's ``.npz`` layout and loaded into each.

Tolerances: against the torch mirrors (both sides torch on the CPU, one
weights file) features, logits and taps within 1e-5 of the largest value;
against the flax VGG16 taps within rtol 5e-3 and 2e-3 of the largest value
and LPIPS within 1e-2 relative, as tests/test_metric_tower_oracle.py holds
the flax towers against the mirrors. The flax Inception tower is held
against the port once per resize method, in
tests/test_torch_port_final_metrics.py (its compile is the costly part).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from refharness.towers import TInception3, TVGG16, randomize  # noqa: E402

MIRROR_TOL = 1e-5
VGG_TAPS = {3: "conv1_2", 8: "conv2_2", 15: "conv3_3", 22: "conv4_3"}


@pytest.fixture(scope="module")
def inception_pair(tmp_path_factory):
    """(mirror, .npz path, port tower) with one random state dict."""
    from movae_tpu.metrics.inception import convert_torch_weights
    from movae_tpu_torch.metrics.inception import InceptionV3
    from movae_tpu_torch.utils.weights import load_tower_npz

    mirror = TInception3()
    randomize(mirror, 1234)
    npz = str(tmp_path_factory.mktemp("towers") / "inception.npz")
    convert_torch_weights(mirror.state_dict(), npz)
    return mirror, npz, load_tower_npz(InceptionV3(), npz)


@pytest.fixture(scope="module")
def vgg_pair(tmp_path_factory):
    from movae_tpu.metrics.vgg import convert_torch_weights
    from movae_tpu_torch.metrics.vgg import VGG16Features
    from movae_tpu_torch.utils.weights import load_tower_npz

    mirror = TVGG16()
    randomize(mirror, 77)
    npz = str(tmp_path_factory.mktemp("towers") / "vgg.npz")
    convert_torch_weights(mirror.state_dict(), npz)
    return mirror, npz, load_tower_npz(VGG16Features(), npz)


def test_load_tower_npz_inverts_the_inception_converter(inception_pair):
    """Key for key and bit for bit: the port's state dict is the mirror's
    (torchvision's keys), including the BatchNorm running statistics."""
    mirror, _, port = inception_pair
    want, got = mirror.state_dict(), port.state_dict()
    assert list(got) == list(want)
    for k, v in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        assert got[k].dtype == v.dtype, k
        assert torch.equal(got[k], v), k


def test_load_tower_npz_inverts_the_vgg_converter(vgg_pair):
    """The port keeps torchvision's ``features`` indices through conv4_3's
    ReLU; the mirror's conv5 block (not in the file) has no counterpart."""
    mirror, _, port = vgg_pair
    want, got = mirror.state_dict(), port.state_dict()
    assert list(got) == [k for k in want if int(k.split(".")[1]) <= 22]
    for k in got:
        assert torch.equal(got[k], want[k]), k


def _images(seed, n, size=32):
    return np.random.default_rng(seed).uniform(
        -1, 1, (n, size, size, 3)).astype(np.float32)


@pytest.mark.parametrize("method", ["bicubic", "bilinear"])
def test_inception_tower_matches_the_mirror(inception_pair, method):
    """The real preprocessing (32 px resized to 299) and the tower, against
    the mirror's ``features_and_logits`` on the same preprocessed input."""
    from movae_tpu_torch.metrics.features import InceptionTower

    mirror, npz, _ = inception_pair
    tower = InceptionTower(weights_path=npz, device="cpu")
    x = _images(2, 3)
    feats, logits = tower.extract(x, batch_size=2, want_logits=True,
                                  method=method)
    with torch.no_grad():
        t = torch.clamp(torch.from_numpy(x).permute(0, 3, 1, 2) * 0.5 + 0.5,
                        0, 1)
        t = F.interpolate(t, size=(299, 299), mode=method, antialias=True)
        mean = torch.tensor([0.485, 0.456, 0.406]).view(1, 3, 1, 1)
        std = torch.tensor([0.229, 0.224, 0.225]).view(1, 3, 1, 1)
        want_f, want_l = mirror.features_and_logits((t - mean) / std)
    for got, want in ((feats, want_f.numpy()), (logits, want_l.numpy())):
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=MIRROR_TOL * np.abs(want).max())


def _mirror_taps(features, x_nhwc):
    taps, t = {}, torch.from_numpy(x_nhwc).permute(0, 3, 1, 2)
    with torch.no_grad():
        for i, m in enumerate(features):
            t = m(t)
            if i in VGG_TAPS:
                taps[VGG_TAPS[i]] = t.permute(0, 2, 3, 1).numpy()
            if i == 22:
                break
    return taps


def _mirror_lpips(features, a, b):
    from movae_tpu_torch.metrics.vgg import preprocess

    ta = _mirror_taps(features, preprocess(torch.from_numpy(a)).numpy())
    tb = _mirror_taps(features, preprocess(torch.from_numpy(b)).numpy())
    scores = []
    for name in VGG_TAPS.values():
        na = ta[name] / np.maximum(np.linalg.norm(ta[name], axis=-1,
                                                  keepdims=True), 1e-10)
        nb = tb[name] / np.maximum(np.linalg.norm(tb[name], axis=-1,
                                                  keepdims=True), 1e-10)
        scores.append(((na - nb) ** 2).sum(-1).mean(axis=(1, 2)))
    return float(np.mean(scores))


def test_vgg_taps_and_lpips_match_the_mirror(vgg_pair):
    from movae_tpu_torch.metrics.vgg import make_lpips_fn, preprocess

    mirror, _, port = vgg_pair
    a = _images(3, 2, 64)
    b = np.clip(a + 0.2 * np.random.default_rng(4).standard_normal(a.shape),
                -1, 1).astype(np.float32)
    with torch.no_grad():
        taps = port(preprocess(torch.from_numpy(a)))
    want = _mirror_taps(mirror.features,
                        preprocess(torch.from_numpy(a)).numpy())
    assert set(taps) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(taps[name].numpy(), w, rtol=0,
                                   atol=MIRROR_TOL * np.abs(w).max(),
                                   err_msg=name)
    got = float(make_lpips_fn(port, device="cpu")(a, b))
    np.testing.assert_allclose(got, _mirror_lpips(mirror.features, a, b),
                               rtol=MIRROR_TOL)


def test_vgg_and_lpips_match_the_flax_tower(vgg_pair):
    """The same ``.npz`` in the flax VGG16 and in the port."""
    from movae_tpu.metrics import vgg as jvgg
    from movae_tpu_torch.metrics.vgg import make_lpips_fn, preprocess

    _, npz, port = vgg_pair
    variables = jvgg.load_params(npz)
    a = _images(5, 2, 32)
    b = np.clip(a + 0.3 * np.random.default_rng(6).standard_normal(a.shape),
                -1, 1).astype(np.float32)
    jtaps = jvgg.VGG16Features().apply(variables,
                                       jvgg.preprocess(jnp.asarray(a)))
    with torch.no_grad():
        taps = port(preprocess(torch.from_numpy(a)))
    for name in jvgg.LPIPS_TAPS:
        want = np.asarray(jtaps[name])
        np.testing.assert_allclose(taps[name].numpy(), want, rtol=5e-3,
                                   atol=2e-3 * np.abs(want).max(),
                                   err_msg=name)
    want = float(jvgg.make_lpips_fn(variables)(jnp.asarray(a),
                                               jnp.asarray(b)))
    got = float(make_lpips_fn(port, device="cpu")(a, b))
    assert abs(got - want) / want < 1e-2, (got, want)


def test_strict_loading_raises(inception_pair, vgg_pair, tmp_path):
    """A missing entry, a wrong shape, and a path that is set but absent
    (argument or environment variable) each raise."""
    from movae_tpu_torch.metrics.inception import InceptionV3, build_inception
    from movae_tpu_torch.metrics.vgg import VGG16Features, build_vgg16
    from movae_tpu_torch.utils.weights import load_tower_npz

    for (_, npz, _), cls in ((inception_pair, InceptionV3),
                             (vgg_pair, VGG16Features)):
        flat = dict(np.load(npz))
        key = sorted(flat)[0]
        missing = {k: v for k, v in flat.items() if k != key}
        with pytest.raises(ValueError, match="missing"):
            load_tower_npz(cls(), missing)
        wrong = dict(flat)
        wrong[key] = np.zeros(np.shape(flat[key])[:-1] + (1,), np.float32)
        with pytest.raises(ValueError, match="wrong shapes"):
            load_tower_npz(cls(), wrong)
        # extra entries (torchvision's AuxLogits in a converted file) are
        # ignored, as the JAX package ignores them
        load_tower_npz(cls(), dict(flat, **{"params/AuxLogits/x": np.ones(2)}))
    absent = str(tmp_path / "absent.npz")
    for build, var in ((build_inception, "MOVAE_INCEPTION_WEIGHTS"),
                       (build_vgg16, "MOVAE_VGG16_WEIGHTS")):
        with pytest.raises(FileNotFoundError, match=var):
            build(absent, device="cpu")
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv(var, absent)
            with pytest.raises(FileNotFoundError, match=var):
                build(device="cpu")


def test_random_fallback_is_seeded_and_warns(monkeypatch):
    from movae_tpu_torch.metrics.pretrained import RandomTowerWarning
    from movae_tpu_torch.metrics.vgg import build_vgg16

    monkeypatch.delenv("MOVAE_VGG16_WEIGHTS", raising=False)
    with pytest.warns(RandomTowerWarning, match="JAX package"):
        a = build_vgg16(device="cpu")
    with pytest.warns(RandomTowerWarning):
        b = build_vgg16(device="cpu")
    for (k, v), w in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(v, w), k
    assert not any(p.requires_grad for p in a.parameters())


def test_entry_points_default_to_cuda():
    """Without a card, the towers' entry points raise instead of falling
    back to the CPU."""
    from movae_tpu_torch.metrics.features import InceptionTower
    from movae_tpu_torch.metrics.vgg import make_lpips_fn

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for call in (lambda: InceptionTower(), lambda: make_lpips_fn()):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_port_never_imports_refharness():
    """Every module of the port, the metrics included, imports without the
    test-side torchvision mirrors (and without JAX); scipy is allowed."""
    import os
    import subprocess
    import sys

    code = (
        "import importlib, pkgutil, sys\n"
        "import movae_tpu_torch\n"
        "for m in pkgutil.walk_packages(movae_tpu_torch.__path__,\n"
        "                               'movae_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in\n"
        "             ('refharness', 'jax', 'flax', 'movae_tpu'))\n"
        "assert not bad, bad\n"
        "assert 'movae_tpu_torch.train.final_metrics' in sys.modules\n"
        "assert 'scipy.linalg' in sys.modules\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
