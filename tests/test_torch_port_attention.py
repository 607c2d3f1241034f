"""Port causal attention (movae_tpu_torch/ops/attention.py,
kernels/flash_attention.py) against the JAX attention op
(movae_tpu/ops/attention.py) and the stock Pallas flash-attention kernel,
on the same seeded numpy inputs.

On the CPU the flash wrapper takes its plain PyTorch version; the CUDA
kernels are held against that plain version on the card by chip_smoke.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from movae_tpu.ops import attention as jatt  # noqa: E402
from movae_tpu_torch.kernels import flash_attention as fa  # noqa: E402
from movae_tpu_torch.ops import attention as tatt  # noqa: E402


def _inputs(seed, b, h, L, d):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, h, L, d)).astype(np.float32)
            for _ in range(4)]  # q, k, v, cotangent


def _port_out_and_grads(fn, q, k, v, do, scale):
    ts = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    out = fn(*ts, scale)
    grads = torch.autograd.grad(out, ts, torch.tensor(do))
    return out.detach().numpy(), [g.numpy() for g in grads]


def _jax_out_and_grads(fn, q, k, v, do):
    out, vjp = jax.vjp(fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(do))]


def _assert_close(port, ref):
    (o, grads), (o_ref, grads_ref) = port, ref
    np.testing.assert_allclose(o, o_ref, rtol=1e-5, atol=1e-5)
    for name, g, g_ref in zip("qkv", grads, grads_ref):
        np.testing.assert_allclose(g, g_ref, rtol=1e-4, atol=1e-4,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("L,d", [(64, 8), (64, 16), (1025, 8), (1025, 16)])
def test_plain_matches_jax_dense(L, d):
    b, h = (2, 2) if L < 1000 else (1, 2)
    q, k, v, do = _inputs(L + d, b, h, L, d)
    scale = 1.0 / np.sqrt(d)
    port = _port_out_and_grads(fa.flash_causal_attention_plain, q, k, v, do,
                               scale)
    ref = _jax_out_and_grads(
        lambda a, b_, c: jatt.dense_causal_attention(a, b_, c, scale),
        q, k, v, do)
    _assert_close(port, ref)


def test_plain_matches_pallas_flash_kernel_in_interpret_mode():
    """The stock TPU kernel itself, run in TPU interpret mode, with the
    sequence padded to its 128-row tiling as movae_tpu/ops/attention.py
    pads it (L=320 -> 384, pad rows sliced off)."""
    from jax.experimental.pallas import tpu as pltpu
    from jax.experimental.pallas.ops.tpu import flash_attention as jfa

    b, h, L, d = 2, 2, 320, 16
    q, k, v, do = _inputs(7, b, h, L, d)
    scale = 1.0 / np.sqrt(d)
    Lp = -(-L // 128) * 128
    pad = ((0, 0), (0, 0), (0, Lp - L), (0, 0))

    def pallas(a, b_, c):
        out = jfa.flash_attention(jnp.pad(a, pad), jnp.pad(b_, pad),
                                  jnp.pad(c, pad), causal=True,
                                  sm_scale=scale)
        return out[:, :, :L]

    with pltpu.force_tpu_interpret_mode():
        ref = _jax_out_and_grads(pallas, q, k, v, do)
    port = _port_out_and_grads(fa.flash_causal_attention_plain, q, k, v, do,
                               scale)
    _assert_close(port, ref)


@pytest.mark.parametrize("L,threshold,path", [
    (64, 1024, "dense"), (1024, 1024, "dense"), (1025, 1024, "flash"),
    (64, 32, "flash")])
def test_dispatch_by_sequence_length(monkeypatch, L, threshold, path):
    calls = []
    for name in ("dense_causal_attention", "flash_causal_attention"):
        real = getattr(tatt, name)
        monkeypatch.setattr(
            tatt, name, lambda *a, _n=name, _r=real: calls.append(_n) or _r(*a))
    monkeypatch.setattr(tatt, "DENSE_ATTENTION_MAX_L", threshold)
    q, k, v, _ = _inputs(0, 1, 1, L, 8)
    t = [torch.tensor(a) for a in (q, k, v)]
    out = tatt.causal_attention(*t, 0.3)
    assert calls == [f"{path}_causal_attention"]
    np.testing.assert_allclose(
        out.numpy(), np.asarray(jatt.dense_causal_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 0.3)),
        rtol=1e-5, atol=1e-5)


def test_dense_threshold_matches_jax_prior():
    from movae_tpu.models import pixelcnn as jpix

    assert tatt.DENSE_ATTENTION_MAX_L == jpix.DENSE_ATTENTION_MAX_L == 1024


def test_plain_weights_fn_sees_causal_softmax_weights():
    """The weights hook (the prior's attention-weight dropout) receives the
    row-normalized causal weights, and the identity leaves o unchanged."""
    q, k, v, _ = (torch.tensor(a) for a in _inputs(3, 1, 2, 48, 8))
    seen = []
    out = fa.flash_causal_attention_plain(
        q, k, v, 0.4, lambda w: seen.append(w) or w)
    (w,) = seen
    assert w.shape == (1, 2, 48, 48)
    torch.testing.assert_close(w.sum(-1), torch.ones(1, 2, 48))
    assert (w.triu(1) == 0).all()
    torch.testing.assert_close(out, fa.flash_causal_attention_plain(
        q, k, v, 0.4), rtol=0, atol=0)


def test_cpu_dispatch_counts_no_kernel_launch():
    from movae_tpu_torch.kernels import LAUNCH_COUNTS

    before = dict(LAUNCH_COUNTS)
    q = torch.randn(1, 2, 1100, 16, generator=torch.Generator().manual_seed(0))
    out = fa.flash_causal_attention(q, q, q, 0.25)
    assert out.shape == q.shape and torch.isfinite(out).all()
    assert LAUNCH_COUNTS == before


def test_cuda_wrapper_refuses_cpu_tensors():
    q = torch.zeros(1, 1, 8, 16)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_causal_attention_cuda(q, q, q, 0.25)
