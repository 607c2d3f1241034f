"""The port's sphere encoders (``movae_tpu_torch/models/sphere_encoder.py``,
``sphere_encoder_vit.py``), their weight mappings (``utils/weights.py``),
the registry's two branches and their train step against the JAX package,
on the same seeded inputs and the same weights.

Both models are small: the conv model at hidden (8, 16), latent 8; the ViT
at depth 2, dim 64, 4 heads, mixer depth 1, 16 px, patch 2 (64 patches of
8 latent channels). The JAX model is initialized in flax and its params
reach the port through ``load_jax_params``. JAX's forward returns its draws
(``angle_deg``, ``s``, ``e``), which the port takes through ``noise``; in
a train step, where the outputs are not returned, the draws are read by
wrapping ``jax.random.uniform`` and ``jax.random.normal`` (each draw handed
to the host by an ordered debug callback). The VGG16 perceptual term runs
on one random tower file that both packages load (the layout of the JAX
package's converter), as in tests/test_torch_port_final_metrics.py.

Tolerances are those of tests/test_torch_port_vae.py: forward outputs and
objectives within 1e-5 (relative and absolute, 1e-6 absolute for the
objectives; the absolute part scaled by the largest value of outputs that
exceed 1, as the sphere points of radius sqrt(L) do: a float32 rounding of
their norm moves every element by ~1e-6 of the largest); locksteps hold
losses and aggregator weights within 2e-4 relative (2e-5 absolute) and
every parameter within 5e-4 after each step, BatchNorm running statistics
within 5e-4. Weight mappings are bit for bit.
All float32 with TF32 off (the CPU has none).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from refharness.towers import TVGG16, randomize  # noqa: E402

SIZE = 16
BATCH = 4
STEPS, LR, EPS = 3, 1e-3, 1e-4
ARCHS = ("sphere_encoder", "sphere_encoder_vit")
WIDTHS = {"sphere_encoder": dict(hidden_dims=(8, 16), latent_dim=8),
          "sphere_encoder_vit": dict(vit_depth=2, vit_embed_dim=64,
                                     vit_num_heads=4, vit_mixer_depth=1,
                                     latent_dim=8 * (SIZE // 2) ** 2)}


def sphere_args(arch, **kw):
    args = dict(arch=arch, batch_size=BATCH, dataset_size=64,
                use_perceptual=False, **WIDTHS[arch])
    args.update(kw)
    return args


def as_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def images(seed=0, n=BATCH):
    return np.random.default_rng(seed).uniform(
        -1, 1, (n, SIZE, SIZE, 3)).astype(np.float32)


def _load_flax(module, shape, path):
    from movae_tpu.metrics.pretrained import merge_pretrained

    variables = jax.jit(module.init)(jax.random.PRNGKey(20260816),
                                     jnp.zeros(shape, jnp.float32))
    return merge_pretrained(variables, dict(np.load(path)), path)


@pytest.fixture(scope="module")
def synced_vgg(tmp_path_factory):
    """(path of one random VGG16 file, the flax variables loaded from it)."""
    from movae_tpu.metrics import vgg as jvgg

    path = str(tmp_path_factory.mktemp("vgg") / "vgg.npz")
    vgg = TVGG16()
    randomize(vgg, 32)
    jvgg.convert_torch_weights(vgg.state_dict(), path)
    return path, _load_flax(jvgg.VGG16Features(), (1, 64, 64, 3), path)


def build_pair(arch, seed=0, vgg=None, monkeypatch=None, **kw):
    """The same model in both frameworks: (jax_model, params, batch_stats,
    port model on the CPU). ``vgg`` (the synced tower): both with the
    perceptual term, the port's read by its registry from
    ``MOVAE_VGG16_WEIGHTS``."""
    from movae_tpu.metrics import vgg as jvgg
    from movae_tpu.models import get_network as jget, init_model as jinit
    from movae_tpu_torch.models import get_network, init_model
    from movae_tpu_torch.utils.weights import load_jax_params

    jm = jget(SIZE, 3, sphere_args(arch, **kw))
    params, bstats = jinit(jm, jax.random.PRNGKey(seed), SIZE, 3)
    params, bstats = as_np(params), as_np(bstats)
    if vgg is not None:
        jm = jm.clone(use_perceptual=True,
                      perceptual_fn=jvgg.make_perceptual_fn(vgg[1]))
        monkeypatch.setenv("MOVAE_VGG16_WEIGHTS", vgg[0])
    tm = init_model(get_network(SIZE, 3, sphere_args(
        arch, use_perceptual=vgg is not None, **kw)), seed, device="cpu")
    load_jax_params(tm, params, bstats)
    return jm, params, bstats, tm


def spy_draws(monkeypatch):
    """Wrap ``jax.random.uniform`` and ``jax.random.normal`` so every draw
    (jitted or not) is also handed to the host, in program order, as
    (kind, array)."""
    drawn = []
    for name in ("uniform", "normal"):
        orig = getattr(jax.random, name)

        def draw(key, shape=(), dtype=jnp.float32, *args, _orig=orig,
                 _name=name, **kw):
            out = _orig(key, shape, dtype, *args, **kw)
            jax.debug.callback(lambda r: drawn.append((_name, np.asarray(r))),
                               out, ordered=True)
            return out

        monkeypatch.setattr(jax.random, name, draw)
    return drawn


def take_noise(drawn, start, sigma_max_angle_deg=80.0):
    """The draws of one JAX forward (or step) after ``drawn[start]`` as the
    port's ``noise``: uniform angle, uniform s, normal e (no sigma mix). A
    step that traces the forward several times repeats them: checked
    equal."""
    jax.effects_barrier()
    new = drawn[start:]
    kinds = ("uniform", "uniform", "normal")
    assert new and len(new) % 3 == 0, len(new)
    for j, (kind, value) in enumerate(new):
        assert kind == kinds[j % 3], (j, kind)
        np.testing.assert_array_equal(value, new[j % 3][1])
    angle = new[0][1] * np.float32(sigma_max_angle_deg)
    s = new[1][1] * np.float32(0.5)
    return {"angle_deg": torch.tensor(angle), "s": torch.tensor(s),
            "e": torch.tensor(new[2][1])}


def state_dict_of(arch, params, bstats):
    from movae_tpu_torch.utils import weights

    if arch == "sphere_encoder":
        return weights.sphere_state_dict(params, bstats)
    return weights.sphere_vit_state_dict(params)


@pytest.mark.parametrize("arch", ARCHS)
def test_state_dict_equals_jax_export_bit_for_bit(arch):
    from movae_tpu.utils.torch_export import export_torch_state_dict

    _, params, bstats, tm = build_pair(arch)
    ref = export_torch_state_dict(params, bstats, arch)
    got = state_dict_of(arch, params, bstats)
    assert list(got) == list(ref)
    assert set(got) == set(tm.state_dict())
    if arch == "sphere_encoder_vit":
        # the block MLP's second Linear sits at Sequential index 3
        assert "blocks_enc.0.mlp.3.weight" in ref
        assert "blocks_enc.0.mlp.2.weight" not in ref
    else:
        assert "encoder_proj.weight" in ref and "mu.weight" not in ref
    for k in ref:
        assert got[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
        np.testing.assert_array_equal(tm.state_dict()[k].numpy(), ref[k],
                                      err_msg=k)


def test_rope_and_sinusoidal_table_match_jax():
    from movae_tpu.models import sphere_encoder_vit as jv
    from movae_tpu_torch.models import sphere_encoder_vit as tv

    np.testing.assert_array_equal(tv.sinusoidal_table(64, 32),
                                  jv.sinusoidal_table(64, 32))
    freqs = tv.rope_freqs(64, 16)
    np.testing.assert_array_equal(freqs, jv.rope_freqs(64, 16))
    rng = np.random.default_rng(0)
    q, k = (rng.standard_normal((2, 4, 64, 16)).astype(np.float32)
            for _ in range(2))
    jq, jk = jv.apply_rope(jnp.asarray(q), jnp.asarray(k),
                           jnp.asarray(freqs))
    tq, tk = tv.apply_rope(torch.tensor(q), torch.tensor(k),
                           torch.tensor(freqs))
    for t, j in ((tq, jq), (tk, jk)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5,
                                   atol=1e-6)
    # the rotation keeps each interleaved pair's norm
    pair = tq.reshape(2, 4, 64, 8, 2).norm(dim=-1)
    np.testing.assert_allclose(pair.numpy(), np.linalg.norm(
        q.reshape(2, 4, 64, 8, 2), axis=-1), rtol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_forward_objectives_match_jax(arch, synced_vgg, monkeypatch):
    """A train-mode forward with the perceptual term, fed JAX's draws: the
    outputs, each objective and (conv) the new BatchNorm statistics."""
    jm, params, bstats, tm = build_pair(arch, seed=1, vgg=synced_vgg,
                                        monkeypatch=monkeypatch)
    x = images(2)
    (j_vec, j_dict, j_out), mut = jm.apply(
        {"params": params, "batch_stats": bstats}, jnp.asarray(x),
        train=True, method="forward_with_losses", mutable=["batch_stats"],
        rngs={"sample": jax.random.PRNGKey(0)})
    noise = {k: torch.tensor(np.asarray(j_out[k]))
             for k in ("angle_deg", "s", "e")}
    with torch.no_grad():
        t_vec, t_dict, t_out = tm.forward_with_losses(
            torch.tensor(x), train=True, noise=noise)
    for key in ("recons", "x_recon_NOISY", "v", "v_noisy", "v_noisy_small",
                "v_enc_dec", "sigma", "sigma_sub"):
        want = np.asarray(j_out[key])
        assert t_out[key].shape == want.shape, key
        np.testing.assert_allclose(t_out[key].numpy(), want, rtol=1e-5,
                                   atol=1e-5 * max(1.0, np.abs(want).max()),
                                   err_msg=key)
    for key in (*jm.objective_names, "total_loss"):
        np.testing.assert_allclose(float(t_dict[key]), float(j_dict[key]),
                                   rtol=1e-5, atol=1e-6, err_msg=key)
    np.testing.assert_allclose(t_vec.numpy(), np.asarray(j_vec), rtol=1e-5,
                               atol=1e-6)
    # the perceptual term is in the objectives: without it they move
    tm.use_perceptual = False
    with torch.no_grad():
        _, bare, _ = tm.forward_with_losses(torch.tensor(x), train=True,
                                            noise=noise)
    assert abs(float(bare["pix_recon"]) - float(t_dict["pix_recon"])) > 1e-4
    if arch == "sphere_encoder":
        ref = state_dict_of(arch, params, as_np(mut["batch_stats"]))
        stats = t_out["batch_stats"]
        assert set(stats) == {k for k in ref
                              if k.endswith(("_mean", "_var"))}
        for k, v in stats.items():
            np.testing.assert_allclose(v.numpy(), ref[k], rtol=0, atol=1e-6,
                                       err_msg=k)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("steps,share", [(1, True), (3, True), (3, False)])
def test_sample_matches_jax(arch, steps, share, monkeypatch):
    """``sample`` at 1 and 3 steps (shared and fresh noise) with JAX's
    draws given."""
    jm, params, bstats, tm = build_pair(arch, seed=4)
    drawn = spy_draws(monkeypatch)
    j_smp = jm.apply({"params": params, "batch_stats": bstats}, 3,
                     steps=steps, share_noise=share, method="sample",
                     rngs={"sample": jax.random.PRNGKey(2)})
    jax.effects_barrier()
    assert [k for k, _ in drawn] == ["normal"] * (1 if share else steps)
    noise = {"e": torch.tensor(drawn[0][1])}
    noise.update({f"e_{i}": torch.tensor(v) for i, (_, v)
                  in enumerate(drawn[1:], 1)})
    t_smp = tm.sample(3, steps=steps, share_noise=share, noise=noise)
    np.testing.assert_allclose(t_smp.numpy(), np.asarray(j_smp), rtol=1e-5,
                               atol=1e-5)
    gen = torch.Generator().manual_seed(0)
    assert tuple(tm.sample(2, generator=gen).shape) == (2, SIZE, SIZE, 3)


def jax_state(jm, params, bstats, agg):
    from movae_tpu.moo import AggregatorConfig, init_state
    from movae_tpu.train.optim import build_optimizer
    from movae_tpu.train.state import TrainState
    from movae_tpu.train.step import make_train_step

    cfg = AggregatorConfig(name=agg, num_objectives=len(jm.objective_names))
    state = TrainState.create(jm.apply, params, bstats,
                              build_optimizer("adam", LR, eps=EPS),
                              init_state(cfg))
    return state, jax.jit(make_train_step(jm, cfg, 1, STEPS))


def port_state(tm, agg):
    from movae_tpu_torch.moo import AggregatorConfig, init_state
    from movae_tpu_torch.train.optim import build_optimizer
    from movae_tpu_torch.train.state import TrainState
    from movae_tpu_torch.train.step import make_train_step

    cfg = AggregatorConfig(name=agg, num_objectives=len(tm.objective_names))
    state = TrainState.create(tm, build_optimizer("adam", LR, eps=EPS),
                              init_state(cfg))
    return state, make_train_step(tm, cfg, 1, STEPS)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("agg", ["sum", "upgrad"])
def test_train_lockstep_matches_jax(arch, agg, monkeypatch):
    """``STEPS`` steps of ``agg`` in both packages from one init on one
    batch stream and the same draws; after every step the losses, weights,
    parameters and running statistics agree."""
    jm, params, bstats, tm = build_pair(arch, seed=11)
    drawn = spy_draws(monkeypatch)
    jstate, jstep = jax_state(jm, params, bstats, agg)
    tstate, tstep = port_state(tm, agg)
    m = len(jm.objective_names)
    rng = jax.random.PRNGKey(3)
    for i in range(STEPS):
        xb = images(100 + i)
        rng, sub = jax.random.split(rng)
        start = len(drawn)
        jstate, jmet = jstep(jstate, jnp.asarray(xb), sub)
        noise = take_noise(drawn, start)
        tstate, tmet = tstep(tstate, torch.tensor(xb), noise=noise)
        for key in ("total_loss", *jm.objective_names):
            np.testing.assert_allclose(float(tmet[key]), float(jmet[key]),
                                       rtol=2e-4, atol=2e-5,
                                       err_msg=f"{arch} {agg} step {i} {key}")
        got = np.array([float(tmet[f"task_{j}_weight"]) for j in range(m)])
        want = np.array([float(jmet[f"task_{j}_weight"]) for j in range(m)])
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5,
                                   err_msg=f"{arch} {agg} step {i}")
        assert float(tmet["skipped_nonfinite"]) == 0.0
        ref = state_dict_of(arch, as_np(jstate.params),
                            as_np(jstate.batch_stats))
        sd = tm.state_dict()
        for k, v in ref.items():
            np.testing.assert_allclose(sd[k].numpy(), v, rtol=0, atol=5e-4,
                                       err_msg=f"{arch} {agg} step {i} {k}")
    assert tstate.step == int(jstate.step) == STEPS


@pytest.mark.parametrize("arch", ARCHS)
def test_registry_matches_jax(arch):
    """Class, objective order, feature names, lambda weights (defaults and
    the lambda_* args), perceptual flag, the ViT's patch size (2 at <= 32
    px, else 8) and latent channels, and the parameter count."""
    from movae_tpu.models import get_network as jget, init_model as jinit
    from movae_tpu_torch.models import get_network

    for kw in ({}, dict(lambda_pix_recon=2.0, lambda_pix_con=0.25,
                        lambda_lat_con=0.5, sigma_max_angle_deg=60.0)):
        jm = jget(SIZE, 3, sphere_args(arch, **kw))
        tm = get_network(SIZE, 3, sphere_args(arch, **kw))
        assert type(tm).__name__ == type(jm).__name__
        assert tm.objective_names == jm.objective_names
        assert tm.feature_names is None and jm.feature_names is None
        assert tm.lambda_weights == tuple(jm.lambda_weights)
        for attr in ("lambda_pix_recon", "lambda_pix_con", "lambda_lat_con",
                     "sigma_max_angle_deg", "use_perceptual", "latent_dim"):
            assert getattr(tm, attr) == getattr(jm, attr), attr
    params, _ = jinit(jm, jax.random.PRNGKey(0), SIZE, 3)
    assert sum(p.numel() for p in tm.parameters()) == sum(
        np.size(p) for p in jax.tree_util.tree_leaves(params))
    if arch == "sphere_encoder_vit":
        for size, patch in ((32, 2), (64, 8)):
            lat = 8 * (size // patch) ** 2
            jm = jget(size, 3, sphere_args(arch, latent_dim=lat))
            tm = get_network(size, 3, sphere_args(arch, latent_dim=lat))
            assert tm.patch_size == jm.patch_size == patch
            assert tm.latent_channels == jm.latent_channels == 8
        for get in (jget, get_network):
            with pytest.raises(ValueError, match="divisible by num_patches"):
                get(SIZE, 3, sphere_args(arch, latent_dim=100))
