"""Port VQ-VAE model, weight loading, objectives and registry
(movae_tpu_torch/models, utils/weights.py, objectives.py) against the JAX
package on the same seeded inputs and the same weights.

The JAX model is initialized in flax; its params reach the port through
``load_jax_params`` (numpy in, no JAX on the port side).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

SIZE = 16
HIDDEN = (8, 16)
K, D = 32, 8
BATCH = 4


def vq_args(**kw):
    args = dict(arch="vq_vae", embedding_dim=D, num_embeddings=K,
                hidden_dims=HIDDEN, num_residual_layers=2, batch_size=BATCH,
                dataset_size=64, recons_objective="mse",
                recons_activation="tanh")
    args.update(kw)
    return args


def build_pair(seed=0, **kw):
    """The same VQ-VAE in both frameworks: (jax_model, params, batch_stats,
    port_model on the CPU)."""
    from movae_tpu.models import get_network as jget, init_model as jinit
    from movae_tpu_torch.models import get_network, init_model
    from movae_tpu_torch.utils.weights import load_jax_params

    jm = jget(SIZE, 3, vq_args(**kw))
    params, bstats = jinit(jm, jax.random.PRNGKey(seed), SIZE, 3)
    params = jax.tree_util.tree_map(np.asarray, params)
    bstats = jax.tree_util.tree_map(np.asarray, bstats)
    tm = init_model(get_network(SIZE, 3, vq_args(**kw)), seed, device="cpu")
    load_jax_params(tm, params, bstats)
    return jm, params, bstats, tm


def images(seed=0, n=BATCH):
    return np.random.default_rng(seed).uniform(
        -1, 1, (n, SIZE, SIZE, 3)).astype(np.float32)


def test_converted_state_dict_equals_jax_export_bit_for_bit():
    from movae_tpu.utils.torch_export import export_torch_state_dict
    from movae_tpu_torch.utils.weights import vqvae_state_dict

    _, params, _, tm = build_pair()
    ref = export_torch_state_dict(params, {}, "vq_vae")
    got = vqvae_state_dict(params)
    assert list(got) == list(ref)
    assert set(got) == set(tm.state_dict())
    for k in ref:
        assert got[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
        np.testing.assert_array_equal(tm.state_dict()[k].numpy(), ref[k],
                                      err_msg=k)


@pytest.mark.parametrize("train", [False, True])
def test_forward_losses_and_codes_match_jax(train):
    jm, params, bstats, tm = build_pair(seed=1)
    x = images(2)
    j_vec, j_dict, j_out = jm.apply({"params": params, "batch_stats": bstats},
                                    jnp.asarray(x), train=train,
                                    method="forward_with_losses",
                                    rngs={"sample": jax.random.PRNGKey(0)})
    with torch.no_grad():
        t_vec, t_dict, t_out = tm.forward_with_losses(torch.tensor(x),
                                                      train=train)
    np.testing.assert_array_equal(t_out["encoding_inds"].numpy(),
                                  np.asarray(j_out["encoding_inds"]))
    for key in ("recons", "quantized_inputs", "encoding"):
        assert t_out[key].shape == j_out[key].shape, key
        np.testing.assert_allclose(t_out[key].numpy(), np.asarray(j_out[key]),
                                   rtol=1e-5, atol=1e-5, err_msg=key)
    np.testing.assert_allclose(t_vec.numpy(), np.asarray(j_vec), rtol=1e-5,
                               atol=1e-6)
    for key in (*jm.objective_names, "total_loss"):
        np.testing.assert_allclose(float(t_dict[key]), float(j_dict[key]),
                                   rtol=1e-5, atol=1e-6, err_msg=key)

    j_codes = jm.apply({"params": params, "batch_stats": bstats},
                       jnp.asarray(x), method="get_code_indices")
    t_codes = tm.get_code_indices(torch.tensor(x))
    np.testing.assert_array_equal(t_codes.numpy(), np.asarray(j_codes))
    j_dec = jm.apply({"params": params, "batch_stats": bstats}, j_codes,
                     method="decode_code")
    with torch.no_grad():
        t_dec = tm.decode_code(t_codes)
    np.testing.assert_allclose(t_dec.numpy(), np.asarray(j_dec), rtol=1e-5,
                               atol=1e-5)


def test_ema_codebook_model_loads_and_matches_jax_forward():
    jm, params, bstats, tm = build_pair(seed=2, vq_ema=True)
    assert tm.objective_names == jm.objective_names
    assert not tm.vq_layer.embedding.weight.requires_grad
    x = images(3)
    _, j_dict, j_out = jm.apply({"params": params, "batch_stats": bstats},
                                jnp.asarray(x), train=False,
                                method="forward_with_losses")
    with torch.no_grad():
        _, t_dict, t_out = tm.forward_with_losses(torch.tensor(x))
    np.testing.assert_array_equal(t_out["encoding_inds"].numpy(),
                                  np.asarray(j_out["encoding_inds"]))
    np.testing.assert_allclose(float(t_dict["total_loss"]),
                               float(j_dict["total_loss"]), rtol=1e-5)
    # in training the EMA update is returned, not applied
    with torch.no_grad():
        out = tm(torch.tensor(x), train=True,
                 generator=torch.Generator().manual_seed(0))
    assert set(out["batch_stats"]) == set(tm.batch_stats())
    np.testing.assert_array_equal(tm.vq_layer.cluster_size.numpy(),
                                  bstats["vq"]["cluster_size"])


def test_init_model_is_seeded_and_flax_scaled():
    from movae_tpu_torch.models import get_network, init_model

    a = init_model(get_network(SIZE, 3, vq_args()), 7, device="cpu")
    b = init_model(get_network(SIZE, 3, vq_args()), 7, device="cpu")
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
    w = a.encoder[0][0].weight.detach()  # fan_in 3*4*4: lecun std 0.144
    assert abs(float(w.std()) - (1 / 48) ** 0.5) < 0.04
    cb = a.vq_layer.embedding.weight.detach()
    assert float(cb.abs().max()) <= 1.0 / K


@pytest.mark.parametrize("name", [
    "mse_per_pixel_mean", "mse_per_image_sum", "mse_total_batch_sum_scaled",
    "bce_per_pixel_mean", "bce_per_image_sum",
    "bce_with_logits_per_pixel_mean", "bce_with_logits_per_image_sum",
    "laplacian_per_pixel_mean", "laplacian_per_image_sum",
    "smooth_l1_per_pixel_mean"])
def test_objectives_match_jax(name):
    from movae_tpu import objectives as jobj
    from movae_tpu_torch import objectives as tobj

    rng = np.random.default_rng(len(name))
    t = rng.uniform(0, 1, (3, 5, 5, 2)).astype(np.float32)
    r = rng.uniform(0.01, 0.99, t.shape).astype(np.float32)
    if "smooth" in name:
        r = r * 3.0  # both branches of the Huber loss
    got = float(getattr(tobj, name)(torch.tensor(t), torch.tensor(r)))
    ref = float(getattr(jobj, name)(jnp.asarray(t), jnp.asarray(r)))
    np.testing.assert_allclose(got, ref, rtol=1e-6)


def test_kl_and_integer_cross_entropy_match_jax():
    from movae_tpu import objectives as jobj
    from movae_tpu_torch import objectives as tobj

    rng = np.random.default_rng(9)
    mu, lv = (rng.normal(size=(4, 6)).astype(np.float32) for _ in range(2))
    np.testing.assert_allclose(
        float(tobj.kl_divergence(torch.tensor(mu), torch.tensor(lv))),
        float(jobj.kl_divergence(jnp.asarray(mu), jnp.asarray(lv))),
        rtol=1e-6)
    logits = rng.normal(size=(3, 4, 7)).astype(np.float32)
    labels = rng.integers(0, 7, size=(3, 4)).astype(np.int32)
    np.testing.assert_allclose(
        float(tobj.integer_cross_entropy(torch.tensor(logits),
                                         torch.tensor(labels))),
        float(jobj.integer_cross_entropy(jnp.asarray(logits),
                                         jnp.asarray(labels))), rtol=1e-6)


@pytest.mark.parametrize("objective,activation", [
    ("mse", None), ("bce", None), ("l1", "sigmoid"), ("smooth_l1", None)])
def test_recon_registry_matches_jax(objective, activation):
    from movae_tpu import objectives as jobj
    from movae_tpu_torch import objectives as tobj

    jfn, jact = jobj.get_recon_obj_and_activation(objective, activation)
    tfn, tact = tobj.get_recon_obj_and_activation(objective, activation)
    assert tact == jact and tfn.__name__ == jfn.__name__


@pytest.mark.parametrize("arch,item", [("pixelsnail", "item 8")])
def test_unported_arch_names_roadmap_item(arch, item):
    from movae_tpu_torch.models import get_network

    with pytest.raises(NotImplementedError, match=f"ROADMAP.md.*{item}"):
        get_network(SIZE, 3, vq_args(arch=arch))


def jax_param_count(jm, size):
    """The JAX model's parameter count, from the shapes of its init."""
    from movae_tpu.models import init_model as jinit

    params, _ = jax.eval_shape(lambda key: jinit(jm, key, size, 3),
                               jax.random.PRNGKey(0))
    return sum(int(np.prod(p.shape))
               for p in jax.tree_util.tree_leaves(params))


@pytest.mark.parametrize("arch", ["sphere_encoder", "sphere_encoder_vit"])
def test_sphere_archs_build_as_in_jax(arch):
    """The sphere encoders (once named by the registry as not ported) build
    in both packages from this file's args: the same objectives, lambda
    weights and parameter count."""
    from movae_tpu.models import get_network as jget
    from movae_tpu_torch.models import get_network

    args = vq_args(arch=arch, use_perceptual=False, vit_depth=1,
                   vit_embed_dim=32, vit_num_heads=2, vit_mixer_depth=1)
    jm, tm = jget(SIZE, 3, args), get_network(SIZE, 3, args)
    assert tm.objective_names == jm.objective_names
    assert tm.lambda_weights == tuple(jm.lambda_weights)
    assert sum(p.numel() for p in tm.parameters()) == jax_param_count(
        jm, SIZE)


def test_lambda_weights_and_objective_order_match_jax():
    from movae_tpu.models import get_network as jget
    from movae_tpu_torch.models import get_network

    for kw in ({}, {"vq_ema": True}, {"lambda_weights": [1.0, 0.5, 2.0]}):
        jm, tm = jget(SIZE, 3, vq_args(**kw)), get_network(SIZE, 3,
                                                          vq_args(**kw))
        assert tm.objective_names == jm.objective_names
        assert tm.lambda_weights == jm.lambda_weights
        assert tm.feature_names == jm.feature_names


def test_entry_points_default_to_cuda_and_raise_without_it():
    from movae_tpu_torch.device import resolve_device
    from movae_tpu_torch.models import get_network, init_model

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default resolves to it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_model(get_network(SIZE, 3, vq_args()), 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"
