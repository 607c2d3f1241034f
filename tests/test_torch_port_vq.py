"""Port VQ op (movae_tpu_torch/ops/vq.py, kernels/nearest_code.py) against
the JAX VQ op (movae_tpu/ops/vq.py) on the same seeded numpy inputs.

On the CPU the nearest-code wrapper takes its plain PyTorch version; the CUDA
kernel is held against that plain version on the card by chip_smoke.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from movae_tpu.ops import vq as jvq  # noqa: E402
from movae_tpu_torch.kernels import nearest_code as nc  # noqa: E402
from movae_tpu_torch.ops import vq as tvq  # noqa: E402

K, D = 32, 8


def _inputs(seed, n=64, k=K, d=D):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, d)).astype(np.float32),
            rng.normal(size=(k, d)).astype(np.float32))


@pytest.mark.parametrize("n,k,d", [(64, 32, 8), (300, 32, 8), (64, 256, 128)])
def test_plain_nearest_matches_jax_xla_and_pallas(n, k, d):
    """Index-exact against _nearest_inds_xla and against the Pallas kernel
    run in TPU interpret mode (as tests/test_vq.py runs it)."""
    from jax.experimental.pallas import tpu as pltpu

    z, cb = _inputs(n + k + d, n, k, d)
    port = tvq.nearest_code_indices(torch.tensor(z), torch.tensor(cb))
    assert port.dtype == torch.int32 and port.shape == (n,)
    ref_xla = np.asarray(jvq._nearest_inds_xla(jnp.asarray(z),
                                               jnp.asarray(cb)))
    with pltpu.force_tpu_interpret_mode():
        ref_pallas = np.asarray(jvq._nearest_inds_pallas(jnp.asarray(z),
                                                         jnp.asarray(cb)))
    np.testing.assert_array_equal(port.numpy(), ref_xla)
    np.testing.assert_array_equal(port.numpy(), ref_pallas)


def test_plain_nearest_lowest_index_wins_ties():
    cb = torch.tensor([[1.0, 0.0], [0.0, 1.0], [1.0, 0.0], [0.0, 1.0]])
    z = torch.tensor([[0.5, 0.5], [2.0, 0.0], [0.0, 3.0]])
    np.testing.assert_array_equal(nc.nearest_code_plain(z, cb).numpy(),
                                  [0, 0, 1])


def test_cuda_wrapper_refuses_cpu_tensors():
    z, cb = (torch.tensor(a) for a in _inputs(0))
    with pytest.raises(ValueError, match="CUDA"):
        nc.nearest_code_cuda(z, cb)


def _vq_outputs_and_grads(lib, z, cb, w):
    """Outputs of vector_quantize and the codebook/latent grads of each
    objective (quantized through a fixed random projection w)."""
    if lib == "jax":
        def objs(z_, cb_):
            o = jvq.vector_quantize(z_, cb_, use_pallas=False)
            return (o["commitment"], o["embedding"],
                    jnp.sum(o["quantized"] * w))

        out = jvq.vector_quantize(jnp.asarray(z), jnp.asarray(cb),
                                  use_pallas=False)
        grads = [jax.grad(lambda a, b, i=i: objs(a, b)[i], argnums=(0, 1))(
            jnp.asarray(z), jnp.asarray(cb)) for i in range(3)]
        return ({k: np.asarray(v) for k, v in out.items()},
                [tuple(np.asarray(g) for g in gs) for gs in grads])
    grads = []
    for i in range(3):
        zt = torch.tensor(z, requires_grad=True)
        cbt = torch.tensor(cb, requires_grad=True)
        o = tvq.vector_quantize(zt, cbt)
        obj = (o["commitment"], o["embedding"],
               (o["quantized"] * torch.tensor(w)).sum())[i]
        gz, gcb = torch.autograd.grad(obj, (zt, cbt), allow_unused=True)
        grads.append(tuple(np.zeros_like(a) if g is None else g.numpy()
                           for g, a in ((gz, z), (gcb, cb))))
    out = tvq.vector_quantize(torch.tensor(z), torch.tensor(cb))
    return {k: v.detach().numpy() for k, v in out.items()}, grads


def test_vector_quantize_outputs_and_grads_match_jax():
    rng = np.random.default_rng(3)
    z = rng.normal(size=(4, 4, 4, D)).astype(np.float32)
    # a small codebook so indices repeat and the scatter-add accumulates
    cb = rng.normal(size=(6, D)).astype(np.float32)
    w = rng.normal(size=z.shape).astype(np.float32)
    j_out, j_grads = _vq_outputs_and_grads("jax", z, cb, w)
    t_out, t_grads = _vq_outputs_and_grads("torch", z, cb, w)
    np.testing.assert_array_equal(t_out["encoding_inds"],
                                  j_out["encoding_inds"])
    for key in ("quantized", "commitment", "embedding"):
        np.testing.assert_allclose(t_out[key], j_out[key], rtol=1e-6,
                                   atol=1e-6, err_msg=key)
    for i, (tg, jg) in enumerate(zip(t_grads, j_grads)):
        for name, a, b in zip(("z", "codebook"), tg, jg):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6,
                                       err_msg=f"objective {i} d/d{name}")
    # reference semantics: commitment never moves the codebook, the
    # embedding loss never moves the latents
    assert not t_grads[0][1].any() and not t_grads[1][0].any()


def test_gather_rows_backward_is_scatter_add():
    cb = torch.randn(5, 3, generator=torch.Generator().manual_seed(0),
                     requires_grad=True)
    inds = torch.tensor([4, 1, 4, 4], dtype=torch.int32)
    g = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    (tvq.gather_rows(cb, inds) * g).sum().backward()
    expect = torch.zeros(5, 3)
    expect[1] = g[1]
    expect[4] = g[0] + g[2] + g[3]
    torch.testing.assert_close(cb.grad, expect, rtol=0, atol=0)


def test_used_codes_mask_matches_jax():
    inds = np.random.default_rng(4).integers(0, K, size=(3, 5)).astype(
        np.int32)
    np.testing.assert_array_equal(
        tvq.used_codes_mask(torch.tensor(inds), K).numpy(),
        np.asarray(jvq.used_codes_mask(jnp.asarray(inds), K)))


def test_ema_codebook_update_matches_jax():
    rng = np.random.default_rng(5)
    cb = rng.normal(size=(K, D)).astype(np.float32)
    cluster = rng.uniform(0, 3, size=(K,)).astype(np.float32)
    ema = rng.normal(size=(K, D)).astype(np.float32)
    z = rng.normal(size=(50, D)).astype(np.float32)
    inds = rng.integers(0, K, size=(50,)).astype(np.int32)
    ref = jvq.ema_codebook_update(*(jnp.asarray(a) for a in
                                    (cb, cluster, ema, z, inds)), decay=0.9)
    got = tvq.ema_codebook_update(*(torch.tensor(a) for a in
                                    (cb, cluster, ema, z, inds)), decay=0.9)
    for name, g, r in zip(("codebook", "cluster_size", "ema_embed"), got,
                          ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6,
                                   atol=1e-6, err_msg=name)
