"""Port serving (movae_tpu_torch/serving.py and its CLIs) against the live
port model and the JAX package's serving and models, on the CPU.

Sizes follow tests/test_serving.py: hidden (8, 16), K=32, D=8, 16 px
(the int8 size check at hidden (32, 64), 32 px, as the JAX test). The same weights reach both packages through
``utils/weights.py:load_jax_params``. Tolerances: an artifact against the
live port model bit for bit (the same operators on the same inputs);
against the JAX model rtol 1e-5, atol 1e-5, as tests/test_torch_port_
vqvae.py holds the port's decoder; codes equal; int8 outputs within 0.02
of float32's, as the JAX test.
"""

import io
import json
import os
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from movae_tpu_torch import serving  # noqa: E402
from movae_tpu_torch.models import pixelcnn as tpc  # noqa: E402
from movae_tpu_torch.train.step import preprocess_batch  # noqa: E402

SIZE, K, D = 16, 32, 8
RTOL = ATOL = 1e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def margs(arch="vq_vae", hidden=(8, 16)):
    return dict(arch=arch, embedding_dim=D, num_embeddings=K,
                hidden_dims=hidden, num_residual_layers=1, batch_size=8,
                dataset_size=64, latent_dim=16)


def port_model(arch="vq_vae", size=SIZE, hidden=(8, 16), params=None,
               bs=None):
    """The port's model, with flax ``params`` where given."""
    from movae_tpu_torch.models import get_network, init_model
    from movae_tpu_torch.utils.weights import load_jax_params

    tm = init_model(get_network(size, 3, margs(arch, hidden)), 0,
                    device="cpu")
    if params is not None:
        load_jax_params(tm, params, bs)
    return tm.eval()


_PAIRS = {}


def pair(arch="vq_vae", size=SIZE, hidden=(8, 16)):
    """(flax model, params, batch_stats, port model with those weights),
    built once per configuration (no test changes them)."""
    from movae_tpu.models import get_network as jget, init_model as jinit

    key = (arch, size, hidden)
    if key not in _PAIRS:
        jm = jget(size, 3, margs(arch, hidden))
        params, bs = jinit(jm, jax.random.PRNGKey(0), size, 3, batch_size=2)
        params = jax.tree_util.tree_map(np.asarray, params)
        bs = jax.tree_util.tree_map(np.asarray, bs)
        _PAIRS[key] = (jm, params, bs,
                       port_model(arch, size, hidden, params, bs))
    return _PAIRS[key]


def uint8_images(b, size=SIZE, seed=0):
    return np.random.default_rng(seed).integers(
        0, 256, (b, size, size, 3)).astype(np.uint8)


def live_recon(tm, x):
    with torch.no_grad():
        return tm(preprocess_batch(torch.from_numpy(x), False),
                  train=False)["recons"].float()


def export(tm, path, **kw):
    kw.setdefault("sample_batch", 2)
    kw.setdefault("image_batch", 4)
    kw.setdefault("input_size", tm.input_size)
    return serving.export_serving(tm, str(path), **kw)


@pytest.fixture(scope="module")
def vq(tmp_path_factory):
    jm, params, bs, tm = pair()
    art = tmp_path_factory.mktemp("vq")
    man = export(tm, art)
    return jm, params, bs, tm, str(art), man


@pytest.mark.parametrize("arch", ["vq_vae", "vq_vae2", "vae"])
def test_quantized_weights_equal_jax_bit_for_bit(arch):
    """quantize_params -> dequantize_params on the port's layout (Conv 0,
    ConvTranspose 1, Linear 0 as the output axis) gives each weight of the
    JAX package's quantize -> dequantize -> load_jax_params bit for bit,
    over the same set: every >= 2-D weight but the codebooks."""
    from movae_tpu.serving import (dequantize_params as jdeq,
                                   quantize_params as jq)

    jm, params, bs, tm = pair(arch)
    dq = jax.tree_util.tree_map(np.asarray, jdeq(jq(params)))
    want = port_model(arch, params=dq, bs=bs).state_dict()
    q = serving.quantize_params(tm)
    got = serving.dequantize_params(q)
    quantized = {n for n, v in q.items() if isinstance(v, dict)}
    layers = {type(m).__name__ for n, m in tm.named_modules()
              if f"{n}.weight" in quantized}
    assert quantized == {n for n, p in tm.named_parameters()
                         if p.dim() >= 2 and "embedding" not in n}
    assert layers >= ({"Conv2d", "ConvTranspose2d"} if arch != "vae"
                      else {"Conv2d", "ConvTranspose2d", "Linear"})
    for n, p in tm.named_parameters():
        assert torch.equal(got[n], want[n]), n
        if n not in quantized:
            assert torch.equal(p.detach(), want[n]), n
    s = q[next(iter(quantized))]
    assert s["_q8"].dtype == torch.int8 and s["_scale"].dtype == torch.float32


def test_export_round_trip_matches_live_and_jax(vq):
    """reconstruct, encode_codes and decode_codes against the live port model
    bit for bit and against the JAX model; sample (no prior: the model's
    uniform codes) against model.sample from the same seed, bit for bit."""
    jm, params, bs, tm, art, man = vq
    assert set(man["functions"]) == {"reconstruct", "encode_codes",
                                     "decode_codes", "sample"}
    assert man["device"] == "cpu" and man["format"] == "torch.export"
    assert all(e["export_seconds"] > 0 and e["bytes"] > 0
               for e in man["functions"].values())
    fns = serving.load_serving(art)
    x = uint8_images(4)
    rec = fns["reconstruct"](x)
    assert torch.equal(rec, live_recon(tm, x))
    variables = {"params": params, "batch_stats": bs}
    xf = jnp.asarray(x, jnp.float32) / 255.0
    jrec = jm.apply(variables, xf, train=False,
                    rngs={"sample": jax.random.PRNGKey(0),
                          "dropout": jax.random.PRNGKey(0)})["recons"]
    np.testing.assert_allclose(rec.numpy(), np.asarray(jrec), rtol=RTOL,
                               atol=ATOL)
    codes = fns["encode_codes"](x)
    assert codes.dtype == torch.int32
    with torch.no_grad():
        xt = preprocess_batch(torch.from_numpy(x), False)
        assert torch.equal(codes, tm.get_code_indices(xt))
        live_dec = tm.decode_code(codes)
    np.testing.assert_array_equal(
        codes.numpy(), np.asarray(jm.apply(variables, xf,
                                           method="get_code_indices")))
    dec = fns["decode_codes"](codes)
    assert torch.equal(dec, live_dec)
    np.testing.assert_allclose(
        dec.numpy(), np.asarray(jm.apply(variables, jnp.asarray(codes),
                                         method="decode_code")),
        rtol=RTOL, atol=ATOL)
    with torch.no_grad():
        live_s = tm.sample(2, torch.Generator().manual_seed(7))
    assert torch.equal(fns["sample"](7), live_s)
    assert man["functions"]["sample"]["draws"][0]["op"] == "randint"


@pytest.mark.parametrize("b", [1, 3, 7])
def test_symbolic_batch_serves_any_batch(vq, b):
    _, _, _, tm, art, man = vq
    for name in ("reconstruct", "encode_codes", "decode_codes"):
        assert man["functions"][name]["symbolic_batch"], name
    fns = serving.load_serving(art)
    x = uint8_images(b, seed=b)
    assert torch.equal(fns["reconstruct"](x), live_recon(tm, x))
    codes = fns["encode_codes"](x)
    assert codes.shape == (b, 4, 4)
    assert fns["decode_codes"](codes).shape == (b, SIZE, SIZE, 3)


def test_vae_reconstruct_draws_its_noise_from_seed_0(tmp_path):
    """A VAE's eval forward draws eps: the program takes it as an input,
    drawn from a seed-0 generator on every call, so reconstruct equals the
    live model's from a seed-0 generator and repeats itself."""
    _, _, _, tm = pair("vae")
    man = export(tm, tmp_path / "vae")
    assert man["functions"]["reconstruct"]["draws"][0]["op"] == "randn"
    fns = serving.load_serving(str(tmp_path / "vae"))
    x = uint8_images(3)
    with torch.no_grad():
        live = tm(preprocess_batch(torch.from_numpy(x), False), train=False,
                  generator=torch.Generator().manual_seed(0))["recons"]
    assert torch.equal(fns["reconstruct"](x), live)
    assert torch.equal(fns["reconstruct"](x), live)


def test_hierarchical_code_pair_export(tmp_path):
    jm, params, bs, tm = pair("vq_vae2")
    export(tm, tmp_path / "v2", image_batch=2)
    fns = serving.load_serving(str(tmp_path / "v2"))
    x = uint8_images(2)
    ct, cb = fns["encode_codes"](x)
    assert ct.shape == (2, 2, 2) and cb.shape == (2, 4, 4)
    variables = {"params": params, "batch_stats": bs}
    xf = jnp.asarray(x, jnp.float32) / 255.0
    jt, jb = jm.apply(variables, xf, method="get_code_indices_pair")
    np.testing.assert_array_equal(ct.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(cb.numpy(), np.asarray(jb))
    imgs = fns["decode_codes"](ct, cb)
    with torch.no_grad():
        assert torch.equal(imgs, tm.decode_code(ct, cb))
    np.testing.assert_allclose(
        imgs.numpy(), np.asarray(jm.apply(variables, jnp.asarray(ct),
                                          jnp.asarray(cb),
                                          method="decode_code")),
        rtol=RTOL, atol=ATOL)


def jax_gumbel(key, length, b):
    """The Gumbel noise of the JAX samplers' draw at pixel t:
    categorical(fold_in(key, t), logits) = argmax(logits + gumbel(
    fold_in(key, t)))."""
    return np.stack([np.asarray(jax.random.gumbel(
        jax.random.fold_in(key, t), (b, K))) for t in range(length)])


SNAIL = dict(num_embeddings=K, embedding_dim=D, hidden_channels=8,
             num_blocks=1, num_res_blocks_per_layer=1, num_heads=2,
             dropout=0.0)
CNN = dict(num_embeddings=K, embedding_dim=D, hidden_channels=8,
           num_layers=2)
# kernel 3: a 4x4 grid takes 2 * 3 + 4 = 10 fronts, fewer than its pixels
CNN3 = dict(CNN, kernel_size=3)


@pytest.mark.parametrize("kind,kv", [("pixelcnn", "int8"),
                                     ("pixelsnail", "int8"),
                                     ("pixelsnail", "f32"),
                                     ("hierarchical", "int8")])
def test_prior_sample_on_jax_draws(tmp_path, kind, kv):
    """The prior-driven sample artifact fed JAX's own Gumbel draws (the
    loader's ``draws`` hook) against JAX's sample_prior /
    sample_hierarchical decoded by the JAX model: the same codes, the
    images within the decoder's tolerance; the live port sampler from the
    same draws gives the artifact's images bit for bit. PixelCNN with
    kernel 3, so that its 4x4 grid is drawn by the wavefront step."""
    from movae_tpu.models import pixelcnn as jpc
    from movae_tpu_torch.utils.weights import load_jax_prior_params

    hier = kind == "hierarchical"
    jm, params, bs, tm = pair("vq_vae2" if hier else "vq_vae")
    b = 2
    if hier:
        st, sb = tm.latent_spatial_dim_top, tm.latent_spatial_dim_bottom
        jp, tp = jpc.HierarchicalPixelCNN(**CNN), tpc.HierarchicalPixelCNN(
            **CNN)
        pp = jp.init({"params": jax.random.PRNGKey(1)},
                     jnp.zeros((b, st, st), jnp.int32),
                     jnp.zeros((b, sb, sb), jnp.int32), train=False)
    else:
        s = tm.latent_spatial_dim
        jp, tp = ((jpc.PixelCNN(**CNN3), tpc.PixelCNN(**CNN3))
                  if kind == "pixelcnn" else
                  (jpc.PixelSNAIL(**SNAIL), tpc.PixelSNAIL(**SNAIL)))
        pp = jp.init({"params": jax.random.PRNGKey(1)},
                     jnp.zeros((b, s, s), jnp.int32), train=False)
    pp = jax.tree_util.tree_map(np.asarray, pp["params"])
    tp.reset_parameters(torch.Generator().manual_seed(1))
    load_jax_prior_params(tp, pp)
    tp.eval()
    man = export(tm, tmp_path / "art", image_batch=2,
                 prior={"model": tp, "hierarchical": hier},
                 kv_cache_dtype=kv)
    loop = man["functions"]["sample"]["loop"]
    if kind == "pixelcnn":
        assert not loop["levels"][0]["raster"]
        assert loop["levels"][0]["steps"] < s * s
    fns = serving.load_serving(str(tmp_path / "art"))
    key = jax.random.PRNGKey(5)
    cache = {"int8": jnp.int8, "f32": jnp.float32}[kv]
    variables = {"params": params, "batch_stats": bs}
    if hier:
        kt, kb = jax.random.split(key)
        draws = [jax_gumbel(kt, st * st, b), jax_gumbel(kb, sb * sb, b)]
        jt, jb = jpc.sample_hierarchical(jp, pp, key, b, (st, st), (sb, sb),
                                         cache_dtype=cache)
        want = jm.apply(variables, jt, jb, method="decode_code")
        live_codes = tpc.sample_hierarchical(
            tp, None, b, (st, st), (sb, sb),
            cache_dtype=serving.KV_CACHE_DTYPES[kv],
            gumbel=tuple(torch.from_numpy(d) for d in draws))
        jcodes = (jt, jb)
    else:
        draws = [jax_gumbel(key, s * s, b)]
        jc = jpc.sample_prior(jp, pp, key, b, s, s, cache_dtype=cache)
        want = jm.apply(variables, jc, method="decode_code")
        live_codes = (tpc.sample_prior(
            tp, None, b, s, s, cache_dtype=serving.KV_CACHE_DTYPES[kv],
            gumbel=torch.from_numpy(draws[0])),)
        jcodes = (jc,)
    for got, ref in zip(live_codes, jcodes):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    imgs = fns["sample"](0, draws=draws)
    with torch.no_grad():
        assert torch.equal(imgs, tm.decode_code(*live_codes))
    np.testing.assert_allclose(imgs.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    # a seed repeats its images; another seed draws other codes
    assert torch.equal(fns["sample"](3), fns["sample"](3))


def test_export_checkpoint_without_dataset_files(tmp_path):
    """export_checkpoint rebuilds the model from a port-written .pth's args
    alone (the input size from the dataset NAME; no data files) and loads
    the trained prior beside it (find_prior), so sample is prior-driven."""
    from movae_tpu_torch.train import checkpoint as ckpt_lib
    from movae_tpu_torch.train.prior import prior_args_echo

    _, _, _, tm = pair()
    root = tmp_path / "run"
    args = dict(margs(), dataset="synthetic-16-8",
                pixelcnn_hidden_channels=8, pixelcnn_num_layers=2)
    ckpt = ckpt_lib.save_checkpoint(
        ckpt_lib.final_checkpoint_path(str(root)),
        {"epoch": 1, "model_state_dict": tm.state_dict(), "args": args})
    prior = tpc.PixelCNN(**CNN)
    prior.reset_parameters(torch.Generator().manual_seed(2))
    ckpt_lib.save_checkpoint(
        ckpt_lib.best_prior_path(str(root)),
        {"epoch": 1, "model_state_dict": prior.state_dict(),
         "prior_args": prior_args_echo(args, D)})
    man = serving.export_checkpoint(ckpt, str(tmp_path / "art"),
                                    device="cpu", sample_batch=2)
    assert man["input_size"] == SIZE and man["arch"] == "vq_vae"
    assert man["prior"] == "PixelCNN"
    fns = serving.load_serving(str(tmp_path / "art"))
    x = uint8_images(2)
    assert torch.equal(fns["reconstruct"](x), live_recon(tm, x))
    s = tm.latent_spatial_dim
    codes = tpc.sample_prior(prior, torch.Generator().manual_seed(4), 2, s,
                             s)
    with torch.no_grad():
        assert torch.equal(fns["sample"](4), tm.decode_code(codes))


def test_int8_quantized_export(tmp_path):
    """--quantize int8: the artifact holds int8 weights with their scales
    (under half the float32 artifact's bytes), dequantized in the graph;
    outputs within 0.02 of float32's; the codebook stays float."""
    tm = port_model(size=32, hidden=(32, 64))
    m_f = export(tm, tmp_path / "f32")
    m_q = export(tm, tmp_path / "int8", quantize="int8")
    assert m_q["quantize"] == "int8" and m_f["quantize"] is None
    for name in ("reconstruct", "encode_codes", "decode_codes"):
        ratio = (m_q["functions"][name]["bytes"]
                 / m_f["functions"][name]["bytes"])
        assert ratio < 0.5, (name, ratio)
    f_f = serving.load_serving(str(tmp_path / "f32"))
    f_q = serving.load_serving(str(tmp_path / "int8"))
    x = uint8_images(4, size=32)
    assert float((f_f["reconstruct"](x) - f_q["reconstruct"](x)).abs()
                 .max()) < 0.02
    codes = torch.from_numpy(np.random.default_rng(1).integers(
        0, K, (4, 8, 8)).astype(np.int32))
    assert float((f_f["decode_codes"](codes) - f_q["decode_codes"](codes))
                 .abs().max()) < 0.02
    q = serving.quantize_params(tm)
    assert not isinstance(q["vq_layer.embedding.weight"], dict)


def test_int8_export_copies_the_float32_sampler(tmp_path):
    """``sampler_from``: the int8 artifact of a model whose float32 one
    holds the same prior copies its sampler programs (prior weights stay
    float: the same sampler_key) and draws the same codes, decoded at int8
    within 0.02; another prior's key differs, and its programs are
    exported anew."""
    tm = port_model()
    tp = tpc.PixelSNAIL(**SNAIL)
    tp.reset_parameters(torch.Generator().manual_seed(1))
    prior = {"model": tp.eval(), "hierarchical": False}
    m_f = export(tm, tmp_path / "f32", prior=prior)
    m_q = export(tm, tmp_path / "int8", prior=prior, quantize="int8",
                 sampler_from=str(tmp_path / "f32"))
    sf, sq = m_f["functions"]["sample"], m_q["functions"]["sample"]
    assert sf["sampler_key"] == sq["sampler_key"]
    assert not any(p["copied"] for p in sf["programs"].values())
    assert all(p["copied"] for p in sq["programs"].values())
    f_f = serving.load_serving(str(tmp_path / "f32"))
    f_q = serving.load_serving(str(tmp_path / "int8"))
    assert float((f_f["sample"](4) - f_q["sample"](4)).abs().max()) < 0.02
    other = tpc.PixelSNAIL(**SNAIL)
    other.reset_parameters(torch.Generator().manual_seed(2))
    m_o = export(tm, tmp_path / "other", quantize="int8",
                 prior={"model": other.eval(), "hierarchical": False},
                 sampler_from=str(tmp_path / "f32"))
    so = m_o["functions"]["sample"]
    assert so["sampler_key"] != sf["sampler_key"]
    assert not any(p["copied"] for p in so["programs"].values())


class _DrawsOutsideNoise(torch.nn.Module):
    """A model whose reconstruct draws with torch.randn_like, past the
    ``noise`` mapping."""

    input_size = 4

    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.ones(()))

    def forward(self, x, train=False, noise=None):
        return {"recons": x * self.w + torch.randn_like(x)}

    def sample(self, n, noise=None):
        return torch.zeros((n, 4, 4, 3)) * self.w


def test_export_refuses_a_graph_that_draws(tmp_path):
    """Every draw is an input of its program: a graph that still draws
    (here ``randn_like``, which no DrawLog sees) fails the export."""
    with pytest.raises(RuntimeError, match="draws outside its noise"):
        export(_DrawsOutsideNoise(), tmp_path / "bad", image_batch=2)


def test_draw_log_records_each_draw_and_noise_overrides_it():
    """models/base.py:draw: a DrawLog records (name, op, shape, high) in
    call order and draws from its generator; a given name is taken as
    is."""
    from movae_tpu_torch.models.base import DrawLog, draw

    log = DrawLog(torch.Generator().manual_seed(0))
    a = draw("z", "randn", (2, 3), None, log, torch.device("cpu"))
    c = draw("codes", "randint", (2, 2), None, log, torch.device("cpu"),
             high=5)
    assert [d["name"] for d in log.log] == ["z", "codes"]
    assert log.log[1] == {"name": "codes", "op": "randint", "shape": [2, 2],
                          "high": 5}
    assert torch.equal(a, torch.randn((2, 3), generator=torch.Generator()
                                      .manual_seed(0)))
    assert c.dtype == torch.int64 and int(c.max()) < 5
    given = {"z": np.ones((2, 3))}
    assert torch.equal(draw("z", "randn", (2, 3), None, given,
                            torch.device("cpu")), torch.ones((2, 3)))
    with pytest.raises(ValueError):
        draw("z", "randn", (3, 3), None, given, torch.device("cpu"))


def test_unported_options_raise(vq, tmp_path):
    _, _, _, tm, _, _ = vq
    with pytest.raises(ValueError, match="quantize"):
        export(tm, tmp_path / "bad", quantize="int4")
    with pytest.raises(ValueError, match="data_parallel"):
        export(tm, tmp_path / "dp", data_parallel=0)
    with pytest.raises(ValueError, match="data_parallel"):
        serving.export_checkpoint("unused.pth", str(tmp_path / "dp2"),
                                  data_parallel=0)


def test_artifact_runs_only_where_exported(vq):
    """An artifact exported for the CPU refuses a CUDA device (it is never
    moved quietly)."""
    art = vq[4]
    with pytest.raises(ValueError, match="exported for cpu"):
        serving.load_serving(art, device="cuda")


def test_nearest_code_op_opcheck():
    """movae::nearest_code: schema, fake tensor, autograd registration and
    the AOT dispatch of torch.library.opcheck; the CPU kernel is the plain
    version."""
    from movae_tpu_torch.kernels import nearest_code as nc

    g = torch.Generator().manual_seed(0)
    z, cb = torch.randn(64, D, generator=g), torch.randn(K, D, generator=g)
    res = torch.library.opcheck(nc.nearest_code_op, (z, cb))
    assert all(v == "SUCCESS" for v in res.values()), res
    assert torch.equal(torch.ops.movae.nearest_code(z, cb),
                       nc.nearest_code_plain(z, cb))


def test_exported_graph_holds_the_nearest_code_op(vq):
    art = vq[4]
    ep = torch.export.load(os.path.join(art, "encode_codes.pt2"))
    targets = {str(n.target) for n in ep.graph.nodes
               if n.op == "call_function"}
    assert "movae.nearest_code.default" in targets


def test_http_artifact_server(vq):
    """serve_artifacts: healthz, manifest, one POST per function with .npy
    bodies, 404 for an unknown function, 400 for a bad body."""
    from movae_tpu_torch import serve_artifacts as sa

    _, _, _, tm, art, _ = vq
    httpd = sa.serve(art, "127.0.0.1", 0)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"

    def call(path, body=None):
        req = urllib.request.Request(base + path, data=body,
                                     method="GET" if body is None
                                     else "POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.read()

    def npy(a):
        buf = io.BytesIO()
        np.save(buf, a)
        return buf.getvalue()

    try:
        h = json.loads(call("/healthz"))
        assert h["ok"] and h["functions"] == ["decode_codes", "encode_codes",
                                              "reconstruct", "sample"]
        assert json.loads(call("/manifest"))["functions"]
        x = uint8_images(2)
        recon = np.load(io.BytesIO(call("/reconstruct", npy(x))))
        np.testing.assert_array_equal(recon, live_recon(tm, x).numpy())
        codes = np.load(io.BytesIO(call("/encode_codes", npy(x))))
        dec = np.load(io.BytesIO(call("/decode_codes", npy(codes))))
        assert codes.dtype == np.int32 and dec.shape == (2, SIZE, SIZE, 3)
        s = np.load(io.BytesIO(call("/sample?seed=3", b"")))
        assert s.shape == (2, SIZE, SIZE, 3) and np.isfinite(s).all()
        with pytest.raises(urllib.error.HTTPError) as ei:
            call("/nosuchfn", b"")
        assert ei.value.code == 404
        with pytest.raises(urllib.error.HTTPError) as ei:
            call("/reconstruct", b"not-an-npy")
        assert ei.value.code == 400
    finally:
        httpd.shutdown()
        httpd.server_close()
        t.join(timeout=10)


def test_loading_imports_no_model_module(vq):
    """A fresh process loads the artifact and calls every function with
    ``movae_tpu_torch.serving`` alone: no movae_tpu_torch.models module is
    imported (nor JAX)."""
    art = vq[4]
    code = (
        "import sys, numpy as np\n"
        "from movae_tpu_torch.serving import load_serving\n"
        f"fns = load_serving({art!r})\n"
        "x = np.zeros((2, 16, 16, 3), np.uint8)\n"
        "fns['decode_codes'](fns['encode_codes'](x))\n"
        "fns['reconstruct'](x); fns['sample'](1)\n"
        "bad = sorted(m for m in sys.modules if m.startswith("
        "('movae_tpu_torch.models', 'movae_tpu_torch.train', 'jax',"
        " 'movae_tpu.')))\n"
        "print(bad)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env, cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]", out.stdout


def test_export_cli(tmp_path, vq):
    """python -m movae_tpu_torch.export_serving on a port checkpoint,
    --no_prior --device cpu --quantize int8."""
    from movae_tpu_torch import export_serving as cli
    from movae_tpu_torch.train import checkpoint as ckpt_lib

    tm = vq[3]
    ckpt = ckpt_lib.save_checkpoint(
        str(tmp_path / "run" / "checkpoints" / "final_checkpoint.pth"),
        {"epoch": 1, "model_state_dict": tm.state_dict(),
         "args": dict(margs(), dataset="synthetic-16-8")})
    man = cli.main(["--model_path", ckpt, "--out", str(tmp_path / "art"),
                    "--device", "cpu", "--no_prior", "--quantize", "int8",
                    "--sample_batch", "3"])
    assert man["quantize"] == "int8" and man["prior"] is None
    fns = serving.load_serving(str(tmp_path / "art"))
    assert fns["sample"](0).shape == (3, SIZE, SIZE, 3)
