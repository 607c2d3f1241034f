"""``--compute_dtype bfloat16`` in the port (models/base.py:compute_region,
the VQ-VAE, VAE and PixelSNAIL modules) against the JAX package's flax
``dtype=bfloat16`` modules on the same float32 weights and inputs:
forwards, losses and one train step. Parameters stay float32 and the
``state_dict()`` layout does not change.

Tolerances (bf16 keeps 8 bits: 2^-8 = 3.9e-3 relative a rounding, and
the two frameworks round at different places — autocast around the
PyTorch convolutions, flax's ``dtype=`` per layer):
* forwards: within 2e-2 of the largest value (a few bf16 roundings);
  a VQ-VAE's codes may flip where two codes are within bf16 rounding of
  each other, so its decoder is held on JAX's own quantized latents and
  its losses within 2e-3 relative;
* one SGD step (lr 1, so the update is the gradient): every parameter's
  update within 5e-2 of the model's largest update, since a bias's or a
  codebook row's gradient sums many bf16 cotangents rounded apart (seen
  up to 3.1e-2).

Those limits alone would pass a model that ignored ``compute_dtype`` (a
float32 forward sits about one bf16 rounding from JAX's bf16 one), so each
test also records, by forward hooks, the output dtype of every convolution
and dense layer the model runs: all bfloat16 under bf16 (as flax's
``dtype=`` puts them), all float32 in the float32 model.
"""

import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import test_torch_port_vae as tv  # noqa: E402
import test_torch_port_vqvae as tq  # noqa: E402

FWD_TOL, LOSS_RTOL, STEP_TOL = 2e-2, 2e-3, 5e-2


@contextlib.contextmanager
def layer_dtypes(model):
    """The output dtypes of the conv and dense layers ``model`` runs while
    the context is open, as a list of (name, dtype)."""
    layers = (torch.nn.Conv2d, torch.nn.ConvTranspose2d, torch.nn.Linear)
    seen = []
    hooks = [m.register_forward_hook(
        lambda mod, args, out, name=name: seen.append((name, out.dtype)))
        for name, m in model.named_modules() if isinstance(m, layers)]
    try:
        yield seen
    finally:
        for h in hooks:
            h.remove()


def assert_layers_in(seen, dtype):
    assert seen, "no conv or dense layer ran"
    wrong = [(n, d) for n, d in seen if d != dtype]
    assert not wrong, f"layers not in {dtype}: {wrong}"


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-12))


def _one_sgd_step(jm, params, bstats, tm, x, export, noise_fn=None):
    """(port update, JAX update) of every parameter after one sum step of
    SGD at lr 1 from the same weights, and both losses."""
    from movae_tpu.moo import AggregatorConfig as JConfig
    from movae_tpu.moo import init_state as jinit
    from movae_tpu.train.optim import build_optimizer as jbuild
    from movae_tpu.train.state import TrainState as JState
    from movae_tpu.train.step import make_train_step as jmake
    from movae_tpu_torch.moo import AggregatorConfig, init_state
    from movae_tpu_torch.train.optim import build_optimizer
    from movae_tpu_torch.train.state import TrainState
    from movae_tpu_torch.train.step import make_train_step

    names = {n for n, p in tm.named_parameters() if p.requires_grad}
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    cfg = JConfig(name="sum", num_objectives=len(jm.objective_names))
    js = JState.create(jm.apply, params, bstats,
                       jbuild("sgd", 1.0, momentum=0.0), jinit(cfg))
    js, jmet = jax.jit(jmake(jm, cfg))(js, jnp.asarray(x),
                                       jax.random.PRNGKey(1))
    noise = noise_fn() if noise_fn else None
    cfg = AggregatorConfig(name="sum", num_objectives=len(tm.objective_names))
    ts = TrainState.create(tm, build_optimizer("sgd", 1.0, momentum=0.0),
                           init_state(cfg))
    ts, tmet = make_train_step(tm, cfg)(ts, torch.tensor(x), noise=noise)
    ref = export(jax.tree_util.tree_map(np.asarray, js.params))
    after = tm.state_dict()
    ups = {k: (after[k].numpy() - before[k].numpy(),
               np.asarray(ref[k]) - before[k].numpy()) for k in names}
    return ups, float(tmet["total_loss"]), float(jmet["total_loss"])


def _check_step(ups, t_loss, j_loss):
    np.testing.assert_allclose(t_loss, j_loss, rtol=LOSS_RTOL)
    scale = max(float(np.abs(j).max()) for _, j in ups.values())
    for k, (t, j) in ups.items():
        np.testing.assert_allclose(t, j, rtol=0, atol=STEP_TOL * scale,
                                   err_msg=k)


def test_bf16_vqvae_forward_and_step_match_jax():
    jm, params, bstats, tm = tq.build_pair(seed=3, compute_dtype="bfloat16")
    assert tm.compute_dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    _, _, _, t32 = tq.build_pair(seed=3)
    assert list(tm.state_dict()) == list(t32.state_dict())
    x = tq.images(7)
    variables = {"params": params, "batch_stats": bstats}
    _, jld, jout = jm.apply(variables, jnp.asarray(x), train=False,
                            method="forward_with_losses")
    with torch.no_grad(), layer_dtypes(tm) as seen:
        _, tld, tout = tm.forward_with_losses(torch.tensor(x), train=False)
    assert_layers_in(seen, torch.bfloat16)
    with torch.no_grad(), layer_dtypes(t32) as seen32:
        t32.forward_with_losses(torch.tensor(x), train=False)
    assert_layers_in(seen32, torch.float32)
    # the quantizer sees float32 latents in both packages
    assert tout["encoding"].dtype == torch.float32
    assert tout["recons"].dtype == torch.float32
    assert _rel(tout["encoding"], jout["encoding"]) < FWD_TOL
    for k in tm.objective_names:
        np.testing.assert_allclose(float(tld[k]), float(jld[k]),
                                   rtol=LOSS_RTOL, err_msg=k)
    q = np.asarray(jout["quantized_inputs"])
    with torch.no_grad():
        td = tm.decode(torch.tensor(q))
    jd = jm.apply(variables, jnp.asarray(q), method="decode")
    assert _rel(td, jd) < FWD_TOL

    from movae_tpu.utils.torch_export import export_torch_state_dict

    _check_step(*_one_sgd_step(
        jm, params, bstats, tm, x,
        lambda t: export_torch_state_dict(t, {}, "vq_vae")))


@pytest.mark.parametrize("layer_norm", ["batch", "layer"])
def test_bf16_vae_forward_and_step_match_jax(monkeypatch, layer_norm):
    """The VAE's norms compute in float32 on the bf16 activations and hand
    bf16 on; mu and log_var come back float32; the N(0, I) draw is JAX's."""
    jm, params, bstats, tm = tv.build_pair(seed=5, arch="vae",
                                           layer_norm=layer_norm,
                                           compute_dtype="bfloat16")
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    x = tv.images(9)
    variables = {"params": params, "batch_stats": bstats}
    (jmu, jlv), _ = jm.apply(variables, jnp.asarray(x), train=False,
                             method="trunk")
    with torch.no_grad(), layer_dtypes(tm) as seen:
        (tmu, tlv), _ = tm.trunk(torch.tensor(x), train=False)
        z = np.random.default_rng(2).normal(size=tmu.shape).astype(
            np.float32)
        trec = tm.decode(torch.tensor(z))
    assert_layers_in(seen, torch.bfloat16)
    assert tmu.dtype == tlv.dtype == trec.dtype == torch.float32
    assert _rel(tmu, jmu) < FWD_TOL and _rel(tlv, jlv) < FWD_TOL
    jrec = jm.apply(variables, jnp.asarray(z), method="decode")
    assert _rel(trec, jrec) < FWD_TOL

    drawn = tv.spy_normal(monkeypatch)

    def noise():
        jax.effects_barrier()
        return {"eps": torch.tensor(drawn[-1])}

    with layer_dtypes(tm) as seen:
        ups = _one_sgd_step(
            jm, params, bstats, tm, x,
            lambda t: tv.state_dict_of("vae", t, tv.as_np(bstats)), noise)
    assert_layers_in(seen, torch.bfloat16)
    _check_step(*ups)


def test_bf16_pixelsnail_logits_and_gradients_match_jax():
    """The prior's layers in bf16 (the attention in bf16 on the dense path
    at this grid), the logits and the cross-entropy float32: logits within
    2e-2 of the largest, the CE within 2e-3 relative, each parameter's
    gradient within 5e-2 of the largest gradient."""
    from movae_tpu.models.pixelcnn import PixelSNAIL as JSnail
    from movae_tpu_torch.models.pixelcnn import PixelSNAIL
    from movae_tpu_torch.utils import weights

    kw = dict(num_embeddings=16, embedding_dim=8, hidden_channels=16,
              num_blocks=2, num_res_blocks_per_layer=1, num_heads=2,
              dropout=0.0)
    jm = JSnail(dtype=jnp.bfloat16, **kw)
    codes = np.random.default_rng(4).integers(0, 16, (2, 6, 6)).astype(
        np.int32)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 6, 6), jnp.int32))[
        "params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    tm = PixelSNAIL(dtype="bfloat16", **kw)
    weights.load_jax_prior_params(tm, params)
    assert list(tm.state_dict()) == list(PixelSNAIL(**kw).state_dict())

    def jloss(p):
        return jm.apply({"params": p}, jnp.asarray(codes),
                        method="loss_function")["total_loss"]

    jlogits = jm.apply({"params": params}, jnp.asarray(codes))
    assert jlogits.dtype == jnp.float32
    jl, jg = jax.value_and_grad(jloss)(params)
    with layer_dtypes(tm) as seen:
        tlogits = tm(torch.tensor(codes))
    assert_layers_in(seen, torch.bfloat16)
    assert tlogits.dtype == torch.float32
    assert _rel(tlogits.detach(), jlogits) < FWD_TOL
    tl = tm.loss_function(torch.tensor(codes), train=False)["total_loss"]
    np.testing.assert_allclose(float(tl.detach()), float(jl),
                               rtol=LOSS_RTOL)
    tl.backward()
    ref = weights.pixelsnail_state_dict(
        jax.tree_util.tree_map(np.asarray, jg))
    grads = {n: p.grad.numpy() for n, p in tm.named_parameters()}
    scale = max(float(np.abs(np.asarray(v)).max()) for v in ref.values())
    for k, v in ref.items():
        np.testing.assert_allclose(grads[k], np.asarray(v), rtol=0,
                                   atol=STEP_TOL * scale, err_msg=k)


@pytest.mark.parametrize("arch", ["vq_vae2", "betatc_vae", "gg_vq_vae_v3",
                                  "cycle_vae"])
def test_bf16_registry_builds_every_family_in_bf16(arch):
    """get_network honours compute_dtype for every family: the layers'
    dtype, float32 parameters, the float32 layout, and a finite bf16
    train-mode forward with float32 losses."""
    from movae_tpu_torch.models import get_network, init_model

    args = dict(arch=arch, embedding_dim=8, num_embeddings=16,
                hidden_dims=(8, 16), num_residual_layers=1, latent_dim=8,
                batch_size=4, dataset_size=64, recons_objective="mse")
    size = 32
    tm = init_model(get_network(size, 3, dict(args, compute_dtype="bfloat16")),
                    0, device="cpu")
    t32 = init_model(get_network(size, 3, args), 0, device="cpu")
    assert tm.compute_dtype == torch.bfloat16
    assert list(tm.state_dict()) == list(t32.state_dict())
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    x = torch.tensor(np.random.default_rng(1).uniform(
        -1, 1, (4, size, size, 3)).astype(np.float32))
    with layer_dtypes(tm) as seen:
        _, ld, out = tm.forward_with_losses(x, train=True,
                                            generator=torch.Generator())
    assert_layers_in(seen, torch.bfloat16)
    with layer_dtypes(t32) as seen32:
        t32.forward_with_losses(x, train=True, generator=torch.Generator())
    assert_layers_in(seen32, torch.float32)
    assert out["recons"].dtype == torch.float32
    for k in tm.objective_names:
        assert ld[k].dtype == torch.float32 and torch.isfinite(ld[k]), k
