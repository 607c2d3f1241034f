"""Port final metrics (movae_tpu_torch/train/final_metrics.py) against the
JAX package's, and the perceptual reconstruction objective.

Both frameworks load one pair of random tower weights: the torchvision
mirrors of refharness/towers.py, converted to the JAX package's ``.npz``
layout and named by ``MOVAE_INCEPTION_WEIGHTS`` / ``MOVAE_VGG16_WEIGHTS`` for
the whole module, so JAX's ``InceptionTower.get()`` singleton is built (and
its flax tower compiled, once per resize method) a single time. The flax
towers' variables come from the file through the package's
``merge_pretrained``, with the flax init jitted (``_load_flax``).

Test-side patches, the same on both sides: the Inception passes run in
batches of 4 (JAX pads each batch to a static shape: its default of 128
would run 128 images on the CPU per call); FID reads the first 4 feature
dims (full-rank covariances at 6 samples, and a 2048-dim ``sqrtm`` takes
~20 s on a CPU — the full path is held in tests/test_torch_port_metrics.py
and on the card).

Tolerances: PSNR and SSIM within 1e-4; features and logits against the flax
tower within rtol 5e-3 and 2e-3 of the largest value
(tests/test_metric_tower_oracle.py); LPIPS and IS within 1e-2 relative, FID
within 2e-2 relative (the oracle's); codes equal up to near ties
(tests/test_torch_port_codes.py); the perceptual objective's loss within
1e-5 relative, its trunk gradient within 1e-4 of the largest entry, and the
3-step lockstep at tests/test_torch_port_step.py's tolerances.
"""

from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import test_torch_port_vqvae as v1  # noqa: E402
import test_torch_port_vqvae2 as v2  # noqa: E402
from refharness.towers import TInception3, TVGG16, randomize  # noqa: E402
from test_torch_port_codes import assert_codes_match  # noqa: E402

SIZE = 32
BATCH = 4
TOWER_BATCH = 4


def _load_flax(module, shape, path):
    """The JAX package's ``load_params(path)`` with its flax init under
    ``jax.jit``: the same variable tree, merged strictly with the file by
    the package's own ``merge_pretrained``, in seconds (the package's eager
    init of the 299-px Inception takes ~45 s on a CPU)."""
    from movae_tpu.metrics.pretrained import merge_pretrained

    variables = jax.jit(module.init)(jax.random.PRNGKey(20260816),
                                     jnp.zeros(shape, jnp.float32))
    return merge_pretrained(variables, dict(np.load(path)), path)


@pytest.fixture(scope="module")
def synced_towers(tmp_path_factory):
    """One random weights file per tower, named by the environment for the
    whole module; the towers cached by either package are dropped before
    and after."""
    from movae_tpu.metrics import features as jf
    from movae_tpu.metrics.inception import InceptionV3
    from movae_tpu.metrics.inception import convert_torch_weights as jincv
    from movae_tpu.metrics.vgg import convert_torch_weights as jvggcv
    from movae_tpu_torch.metrics import features as tf

    root = tmp_path_factory.mktemp("synced")
    inc, vgg = TInception3(), TVGG16()
    randomize(inc, 31)
    randomize(vgg, 32)
    paths = {"MOVAE_INCEPTION_WEIGHTS": str(root / "inception.npz"),
             "MOVAE_VGG16_WEIGHTS": str(root / "vgg.npz")}
    jincv(inc.state_dict(), paths["MOVAE_INCEPTION_WEIGHTS"])
    jvggcv(vgg.state_dict(), paths["MOVAE_VGG16_WEIGHTS"])
    old = jf.InceptionTower._instance
    with pytest.MonkeyPatch.context() as mp:
        for k, v in paths.items():
            mp.setenv(k, v)
        jf.InceptionTower._instance = None
        mp.setattr(tf.InceptionTower, "_instances", {})
        mp.setattr(jf, "load_params", lambda path=None: _load_flax(
            InceptionV3(), (1, 299, 299, 3),
            path or paths["MOVAE_INCEPTION_WEIGHTS"]))
        yield paths
    jf.InceptionTower._instance = old


@pytest.fixture(scope="module")
def jax_vgg(synced_towers):
    """The flax VGG16's variables from the synced file, loaded once (the
    JAX package's ``load_params`` runs an eager flax init first, ~10 s on a
    CPU, on every ``make_lpips_fn()`` and ``make_perceptual_fn()`` call)."""
    from movae_tpu.metrics import vgg as jvgg

    return _load_flax(jvgg.VGG16Features(), (1, 64, 64, 3),
                      synced_towers["MOVAE_VGG16_WEIGHTS"])


@pytest.fixture
def small_passes(monkeypatch, synced_towers, jax_vgg):
    """Both packages' Inception passes in batches of 4 and FID on 4 feature
    dims, and JAX's LPIPS on the variables loaded once; returns the features
    each pass extracted, per package."""
    from movae_tpu.metrics import features as jf
    from movae_tpu.metrics import vgg as jvgg
    from movae_tpu.train import final_metrics as jfm
    from movae_tpu_torch.metrics import features as tf

    monkeypatch.setattr(jfm, "make_lpips_fn",
                        lambda variables=None: jvgg.make_lpips_fn(jax_vgg))

    seen = {"jax": [], "port": []}
    port_extract = tf.extract_inception_features

    def jextract(images, batch_size=128):
        f = jf.InceptionTower.get().extract(images, TOWER_BATCH)
        seen["jax"].append(f)
        return f

    def textract(images, batch_size=128, device=None):
        f = port_extract(images, TOWER_BATCH, device)
        seen["port"].append(f)
        return f

    for mod, extract in ((jf, jextract), (tf, textract)):
        fid = mod.fid_from_features
        monkeypatch.setattr(mod, "extract_inception_features", extract)
        monkeypatch.setattr(mod, "fid_from_features",
                            lambda a, b, eps=1e-6, fid=fid: fid(
                                a[:, :4], b[:, :4], eps))
    jis, tis = jf.calculate_inception_score, tf.calculate_inception_score
    monkeypatch.setattr(jf, "calculate_inception_score",
                        lambda images, batch_size=128, splits=10: jis(
                            images, TOWER_BATCH, splits))
    monkeypatch.setattr(tf, "calculate_inception_score",
                        lambda images, batch_size=128, splits=10,
                        device=None: tis(images, TOWER_BATCH, splits, device))
    return seen


def _pair(arch, seed, perceptual=None):
    """The same tiny model in both frameworks at 32 px: (jax model, flax
    variables, port model on the CPU). ``perceptual``: the flax VGG16's
    variables, for ``recons_objective="perceptual"``.

    The JAX registry builds a perceptual function but does not pass it to
    ``VQVAE`` / ``VQVAE2`` (``movae_tpu/models/__init__.py:210-260``): its
    VQ models then fail at their first loss. So the JAX model is built for
    mse and given the objective and its function by ``clone``; the port's
    comes from its own registry."""
    from movae_tpu.metrics import vgg as jvgg
    from movae_tpu.models import get_network as jget, init_model as jinit
    from movae_tpu_torch.models import get_network, init_model
    from movae_tpu_torch.utils.weights import load_jax_params

    make_args = v1.vq_args if arch == "vq_vae" else v2.vq2_args
    jm = jget(SIZE, 3, make_args())
    if perceptual is not None:
        jm = jm.clone(recons_objective="perceptual",
                      perceptual_fn=jvgg.make_perceptual_fn(perceptual))
    args = make_args(recons_objective="perceptual" if perceptual is not None
                     else "mse")
    params, bstats = jinit(jm, jax.random.PRNGKey(seed), SIZE, 3)
    params = jax.tree_util.tree_map(np.asarray, params)
    bstats = jax.tree_util.tree_map(np.asarray, bstats)
    tm = init_model(get_network(SIZE, 3, args), seed, device="cpu")
    load_jax_params(tm, params, bstats)
    return jm, {"params": params, "batch_stats": bstats}, tm


def _images(seed, n):
    return np.random.default_rng(seed).uniform(
        -1, 1, (n, SIZE, SIZE, 3)).astype(np.float32)


def _loader(n=6, seed=40):
    """(imgs, labels, n_valid) batches of BATCH; the last one padded, as the
    JAX Loader pads a ragged tail."""
    x = _images(seed, n)
    out = []
    for i in range(0, n, BATCH):
        chunk = x[i:i + BATCH]
        valid = len(chunk)
        if valid < BATCH:
            chunk = np.concatenate([chunk, np.repeat(chunk[-1:],
                                                     BATCH - valid, 0)])
        out.append((chunk, None, valid))
    return out


def _state(variables):
    return SimpleNamespace(params=variables["params"],
                           batch_stats=variables["batch_stats"])


def _vq_rows(tm, x):
    """Each quantizer's input rows (NHWC order) and codebook."""
    if not hasattr(tm, "quantize_t"):
        with torch.no_grad():
            z = tm.encode(x)
        return [(z.reshape(-1, tm.embedding_dim), tm.vq_layer())]
    seen = []
    hooks = [c.register_forward_hook(lambda m, a, out: seen.append(out))
             for c in (tm.quantize_conv_t, tm.quantize_conv_b)]
    with torch.no_grad():
        tm.get_code_indices_pair(x)
    for h in hooks:
        h.remove()
    return [(o.permute(0, 2, 3, 1).reshape(-1, tm.embedding_dim), cb)
            for o, cb in zip(seen, (tm.quantize_t(), tm.quantize_b()))]


@pytest.mark.parametrize("arch", ["vq_vae", "vq_vae2"])
def test_recon_metrics_match_jax(arch, small_passes):
    from movae_tpu.train import final_metrics as jfm
    from movae_tpu_torch.train import final_metrics as tfm

    jm, variables, tm = _pair(arch, seed=7)
    loader = _loader()
    # the codes the recon pass quantizes to, near ties allowed
    x = _loader()[0][0]
    if arch == "vq_vae":
        jcodes = [jm.apply(variables, jnp.asarray(x),
                           method="get_code_indices")]
        tcodes = [tm.get_code_indices(torch.from_numpy(x))]
    else:
        jcodes = jm.apply(variables, jnp.asarray(x),
                          method="get_code_indices_pair")
        tcodes = tm.get_code_indices_pair(torch.from_numpy(x))
    for t, j, (z, cb) in zip(tcodes, jcodes,
                             _vq_rows(tm, torch.from_numpy(x))):
        assert_codes_match(t.numpy(), np.asarray(j), z.numpy(),
                           cb.detach().numpy())

    want = jfm.evaluate_recon_metrics(jm, _state(variables), loader,
                                      jax.random.PRNGKey(0), max_samples=5)
    got = tfm.evaluate_recon_metrics(tm, loader, torch.Generator(),
                                     max_samples=5)
    assert set(got) == set(want) == {"psnr", "ssim", "lpips", "rfid"}
    for key in ("psnr", "ssim"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4,
                                   atol=1e-4, err_msg=key)
    assert abs(got["lpips"] - want["lpips"]) / want["lpips"] < 1e-2
    assert abs(got["rfid"] - want["rfid"]) / want["rfid"] < 2e-2
    # reals, then recons: 5 images each (the max_samples cut)
    assert [len(f) for f in small_passes["port"]] == [5, 5]
    for g, w in zip(small_passes["port"], small_passes["jax"]):
        np.testing.assert_allclose(g, w, rtol=5e-3,
                                   atol=2e-3 * np.abs(w).max())


def test_generative_metrics_match_jax(monkeypatch, small_passes):
    """Generation stubbed to the same images in both packages (their
    samplers draw from different noise); gFID, KID and the mutual
    truncation on the real tower passes; IS is nan at 6 samples and 10
    splits in both, as it is in the reference."""
    from movae_tpu.train import final_metrics as jfm
    from movae_tpu_torch.train import final_metrics as tfm

    jm, variables, tm = _pair("vq_vae2", seed=8)
    # darker, flatter images than the reals: a distance well above rounding
    fake = np.clip(0.3 * _images(41, 9) - 0.4, -1, 1)
    monkeypatch.setattr(jfm, "generate_samples",
                        lambda model, state, args, prior, rng, num,
                        batch=64: fake[:num])
    monkeypatch.setattr(tfm, "generate_samples",
                        lambda model, args, prior, gen, num, batch=64:
                        fake[:num])
    args = SimpleNamespace(batch_size=BATCH, max_fid_samples=64,
                           max_gen_metrics_samples=9)
    want = jfm.evaluate_generative_metrics(
        jm, _state(variables), _loader(), args, None, jax.random.PRNGKey(0))
    got = tfm.evaluate_generative_metrics(tm, _loader(), args, None,
                                          torch.Generator())
    assert set(got) == set(want)
    for key in ("precision", "recall", "inception_score_mean",
                "inception_score_std"):
        assert np.isnan(got[key]) and np.isnan(want[key]), key
    # only 6 reals exist: both sets are cut to 6
    assert [len(f) for f in small_passes["port"]] == [6, 6]
    for g, w in zip(small_passes["port"], small_passes["jax"]):
        np.testing.assert_allclose(g, w, rtol=5e-3,
                                   atol=2e-3 * np.abs(w).max())
    assert abs(got["gfid"] - want["gfid"]) / want["gfid"] < 2e-2
    assert abs(got["kid"] - want["kid"]) <= 2e-2 * abs(want["kid"])


def test_inception_tower_and_is_match_flax(synced_towers):
    """The flax tower (the JAX singleton, one weights file) against the
    port's on the same 32-px images, through both resize methods."""
    from movae_tpu.metrics import features as jf
    from movae_tpu_torch.metrics import features as tf

    imgs = _images(42, 8)
    jt, tt = jf.InceptionTower.get(), tf.InceptionTower.get("cpu")
    for method in ("bicubic", "bilinear"):
        jfeat, jlog = jt.extract(imgs, TOWER_BATCH, want_logits=True,
                                 method=method)
        tfeat, tlog = tt.extract(imgs, TOWER_BATCH, want_logits=True,
                                 method=method)
        for g, w in ((tfeat, jfeat), (tlog, jlog)):
            np.testing.assert_allclose(g, w, rtol=5e-3,
                                       atol=2e-3 * np.abs(w).max(),
                                       err_msg=method)
    is_j, _ = jf.calculate_inception_score(imgs, TOWER_BATCH, splits=2)
    is_t, _ = tf.calculate_inception_score(imgs, TOWER_BATCH, splits=2,
                                           device="cpu")
    assert abs(is_t - is_j) / is_j < 1e-2, (is_t, is_j)


# ---------------------------------------------------------------------------
# generate_samples and run_final_metrics: the count and chunk rules
# ---------------------------------------------------------------------------

class _StubModel(torch.nn.Module):
    """Records every sample batch size generate_samples requests."""

    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.zeros(()))
        self.sample_batches = []

    def sample(self, b, generator=None):
        self.sample_batches.append(b)
        return torch.zeros(b, 4, 4, 3)


def _stub_loader(n, batch=4):
    left = n
    while left > 0:
        b = min(batch, left)
        yield np.zeros((b, 4, 4, 3), np.float32), None, b
        left -= b


def test_generate_samples_static_chunk_shape():
    from movae_tpu_torch.train.final_metrics import generate_samples

    model = _StubModel()
    args = SimpleNamespace(batch_size=4)
    out = generate_samples(model, args, None, None, 10, batch=4)
    assert out.shape == (10, 4, 4, 3)
    # every chunk at the SAME batch, the tail sliced on the host
    assert model.sample_batches == [4, 4, 4]
    model2 = _StubModel()
    out2 = generate_samples(model2, args, None, None, 3, batch=4)
    assert out2.shape[0] == 3 and model2.sample_batches == [3]


def test_gen_metrics_driven_by_max_gen_metrics_samples(monkeypatch):
    from movae_tpu_torch.train import final_metrics as tfm

    seen = {}

    def fake_generate(model, args, prior, gen, num, batch=64):
        seen["num"], seen["batch"] = num, batch
        return np.zeros((num, 4, 4, 3), np.float32)

    monkeypatch.setattr(tfm, "generate_samples", fake_generate)
    monkeypatch.setattr(tfm.feat_lib, "extract_inception_features",
                        lambda images, **kw: np.random.default_rng(
                            len(images)).normal(size=(len(images), 8)))
    monkeypatch.setattr(tfm.feat_lib, "calculate_inception_score",
                        lambda images, **kw: (1.0, 0.0))
    args = SimpleNamespace(batch_size=4, max_fid_samples=64,
                           max_gen_metrics_samples=6)
    out = tfm.evaluate_generative_metrics(_StubModel(), _stub_loader(32),
                                          args, None, None)
    # max_fid_samples must not leak into the generative pass; the batch is
    # min(max(batch_size, 64), 256)
    assert seen == {"num": 6, "batch": 64}
    assert set(out) == {"gfid", "inception_score_mean",
                        "inception_score_std", "precision", "recall", "kid"}
    assert np.isnan(out["precision"]) and np.isnan(out["recall"])
    assert np.isfinite(out["gfid"]) and np.isfinite(out["kid"])


def test_gen_metrics_mutual_truncation(monkeypatch):
    from movae_tpu_torch.train import final_metrics as tfm

    lengths = {"sets": []}

    def fake_extract(images, **kw):
        lengths["sets"].append(len(images))
        return np.random.default_rng(len(images)).normal(
            size=(len(images), 8))

    def fake_is(images, **kw):
        lengths["is"] = len(images)
        return 1.0, 0.0

    monkeypatch.setattr(tfm, "generate_samples",
                        lambda model, args, prior, gen, num, batch=64:
                        np.zeros((num, 4, 4, 3), np.float32))
    monkeypatch.setattr(tfm.feat_lib, "extract_inception_features",
                        fake_extract)
    monkeypatch.setattr(tfm.feat_lib, "calculate_inception_score", fake_is)
    args = SimpleNamespace(batch_size=300, max_gen_metrics_samples=16)
    tfm.evaluate_generative_metrics(_StubModel(), _stub_loader(6), args,
                                    None, None)
    assert lengths == {"sets": [6, 6], "is": 6}


def test_gen_metrics_nonpositive_count_skips():
    from movae_tpu_torch.train import final_metrics as tfm

    args = SimpleNamespace(batch_size=4, max_gen_metrics_samples=0)
    out = tfm.evaluate_generative_metrics(_StubModel(), _stub_loader(4),
                                          args, None, None)
    assert len(out) == 6 and all(np.isnan(v) for v in out.values())


def test_failed_metric_family_reports_nan(monkeypatch):
    """As in the JAX package, a failing family prints and reports nan; the
    others still run."""
    from movae_tpu_torch.train import final_metrics as tfm

    def boom(*a, **k):
        raise RuntimeError("tower missing")

    monkeypatch.setattr(tfm.feat_lib, "extract_inception_features", boom)
    monkeypatch.setattr(tfm, "make_lpips_fn", boom)
    loader = [(np.zeros((2, 4, 4, 3), np.float32), None, 2)]

    class _Identity(_StubModel):
        def forward(self, x, train=False, generator=None):
            return {"recons": x * 0.5}

    out = tfm.evaluate_recon_metrics(_Identity(), loader, None, 2)
    assert np.isnan(out["lpips"]) and np.isnan(out["rfid"])
    assert np.isfinite(out["psnr"]) and np.isfinite(out["ssim"])


@pytest.mark.parametrize("hierarchical", [False, True])
def test_generate_samples_through_a_prior(hierarchical):
    """Prior-driven generation on tiny real models: codes from the cached
    samplers (the int8 KV cache by default), decoded by the VQ model; the
    same generator seed gives the same images."""
    from movae_tpu_torch.models import get_network, init_model
    from movae_tpu_torch.train.final_metrics import generate_samples
    from movae_tpu_torch.train.prior import build_prior

    arch = "vq_vae2" if hierarchical else "vq_vae"
    args = (v2.vq2_args if hierarchical else v1.vq_args)()
    model = init_model(get_network(SIZE, 3, args), 0, device="cpu")
    pargs = SimpleNamespace(prior_type="pixelsnail",
                            pixelcnn_hidden_channels=8,
                            pixelsnail_num_blocks=1,
                            pixelsnail_num_res_blocks=1,
                            pixelsnail_num_heads=2, pixelsnail_dropout=0.0,
                            pixelcnn_num_layers=2)
    prior = build_prior(pargs, model.num_embeddings, hierarchical,
                        model.embedding_dim)
    prior.reset_parameters(torch.Generator().manual_seed(1))
    prior.eval()
    run = SimpleNamespace(batch_size=2, kv_cache_dtype="int8")
    out = [generate_samples(model, run,
                            {"model": prior, "hierarchical": hierarchical},
                            torch.Generator().manual_seed(5), 3, batch=2)
           for _ in range(2)]
    assert out[0].shape == (3, SIZE, SIZE, 3), arch
    assert np.isfinite(out[0]).all()
    np.testing.assert_array_equal(out[0], out[1])


def test_run_final_metrics_keys_and_streams(monkeypatch):
    """eval_* from the last eval losses; the recon and generation passes on
    independent generators (run seed + 1 and + 2), each with its own
    sample count."""
    from movae_tpu_torch.train import final_metrics as tfm

    seen = {}

    def recon(model, loader, gen, max_samples):
        seen["recon"] = (gen.initial_seed(), max_samples)
        return {"psnr": 1.0}

    def gen_metrics(model, loader, args, prior, gen, max_samples):
        seen["gen"] = (gen.initial_seed(), max_samples, prior)
        return {"gfid": 2.0}

    monkeypatch.setattr(tfm, "evaluate_recon_metrics", recon)
    monkeypatch.setattr(tfm, "evaluate_generative_metrics", gen_metrics)
    args = SimpleNamespace(seed=10, max_fid_samples=7,
                           max_gen_metrics_samples=3)
    prior = {"model": None, "hierarchical": True}
    out = tfm.run_final_metrics(
        {"model": _StubModel(), "test_loader": [],
         "eval_losses": [{"a": 9.0}, {"a": 1.0, "b": 2.0}]}, args, prior)
    assert out == {"eval_a": 1.0, "eval_b": 2.0, "psnr": 1.0, "gfid": 2.0}
    assert seen == {"recon": (11, 7), "gen": (12, 3, prior)}


# ---------------------------------------------------------------------------
# the perceptual reconstruction objective
# ---------------------------------------------------------------------------

def test_perceptual_loss_and_trunk_gradient_match_jax(jax_vgg):
    from movae_tpu_torch.utils.weights import vqvae_state_dict

    jm, variables, tm = _pair("vq_vae", seed=9, perceptual=jax_vgg)
    assert tm.recons_objective == "perceptual"
    # the tower stays out of the model's parameters and state
    assert not any("features" in k for k in tm.state_dict())
    x = _images(43, 2)

    def recon_loss(params):
        _, ld, _ = jm.apply({"params": params,
                             "batch_stats": variables["batch_stats"]},
                            jnp.asarray(x), method="forward_with_losses")
        return ld["reconstruction_loss"]

    want, jgrads = jax.jit(jax.value_and_grad(recon_loss))(
        variables["params"])
    _, ld, _ = tm.forward_with_losses(torch.from_numpy(x))
    got = ld["reconstruction_loss"]
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    names = [n for n, _ in tm.named_parameters()]
    grads = torch.autograd.grad(got, list(tm.parameters()),
                                allow_unused=True)
    ref = vqvae_state_dict(jax.tree_util.tree_map(np.asarray, jgrads))
    checked = 0
    for name, g in zip(names, grads):
        if not name.startswith("encoder."):
            continue
        scale = max(float(np.abs(ref[name]).max()), 1e-12)
        err = float(np.abs(g.numpy() - ref[name]).max()) / scale
        assert err < 1e-4, (name, err)
        checked += 1
    assert checked > 0


def test_perceptual_sum_lockstep_matches_jax(jax_vgg):
    """3 sum steps of the 32-px VQ-VAE-2 with the perceptual objective."""
    from movae_tpu_torch.utils.weights import vqvae2_state_dict

    jm, variables, tm = _pair("vq_vae2", seed=10, perceptual=jax_vgg)
    jstate, jstep = v2._jax_step(jm, variables["params"],
                                 variables["batch_stats"], "sum")
    tstate, tstep = v2._port_step(tm, "sum")
    rng = jax.random.PRNGKey(5)
    for i in range(3):
        xb = _images(300 + i, BATCH)
        rng, sub = jax.random.split(rng)
        jstate, jmet = jstep(jstate, jnp.asarray(xb), sub)
        tstate, tmet = tstep(tstate, torch.tensor(xb))
        for key in ("total_loss", *jm.objective_names):
            np.testing.assert_allclose(float(tmet[key]), float(jmet[key]),
                                       rtol=2e-4, atol=2e-5,
                                       err_msg=f"step {i} {key}")
        ref = vqvae2_state_dict(jax.tree_util.tree_map(np.asarray,
                                                       jstate.params))
        got = tm.state_dict()
        delta = max(float(np.max(np.abs(v - got[k].numpy())))
                    for k, v in ref.items())
        assert delta < 5e-4, f"step {i}: max param divergence {delta:.2e}"
