"""The bfloat16 flash attention of the port (kernels/flash_attention.py)
against the stock Pallas flash-attention kernel at bfloat16, run in TPU
interpret mode on the CPU, on the same seeded numpy inputs rounded to
bfloat16; and the bfloat16 dispatch of ops/attention.py.

On the CPU the wrapper takes the plain version, which rounds where the
kernels round (p and ds to bf16 before their products, outputs in bf16);
chip_smoke.py holds the CUDA kernels against it on the card.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from movae_tpu.ops import attention as jatt  # noqa: E402
from movae_tpu_torch.kernels import flash_attention as fa  # noqa: E402
from movae_tpu_torch.ops import attention as tatt  # noqa: E402

# Tolerances, as fractions of the largest value of each output:
# * against the stock kernel (same rounding points): both round outputs to
#   bf16 (2^-9 relative) and p, ds to bf16 before their products, but the
#   TPU kernel rounds its unnormalized p against a running maximum, block
#   by block, and sums in another order; seen up to 1.5e-3, held within
#   about one bf16 ulp of the largest value (4e-3 for o, 8e-3 for the
#   gradients, which add the dp - di subtraction);
# * against float64 on the same bf16 inputs: the roundings themselves,
#   seen up to 3.8e-3, held within 1e-2;
# * the dense bf16 path against JAX's: both round the logits and the
#   softmax weights to bf16 as well (seen up to 9e-3), held within 2e-2.
PALLAS_TOL, F64_TOL, DENSE_TOL = (4e-3, 8e-3), (1e-2, 1e-2), (2e-2, 2e-2)


def _bf16_inputs(seed, shape):
    rng = np.random.default_rng(seed)
    # q, k, v, cotangent, each exactly representable in bfloat16
    return [np.asarray(jnp.asarray(rng.normal(size=shape), jnp.bfloat16)
                       .astype(jnp.float32)) for _ in range(4)]


def _port(fn, q, k, v, do, scale):
    ts = [torch.tensor(a).to(torch.bfloat16).requires_grad_()
          for a in (q, k, v)]
    out = fn(*ts, scale)
    assert out.dtype == torch.bfloat16
    grads = torch.autograd.grad(out, ts,
                                torch.tensor(do).to(torch.bfloat16))
    assert all(g.dtype == torch.bfloat16 for g in grads)
    return [t.float().numpy() for t in (out.detach(), *grads)]


def _jax(fn, q, k, v, do):
    args = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    out, vjp = jax.vjp(fn, *args)
    assert out.dtype == jnp.bfloat16
    return [np.asarray(t.astype(jnp.float32))
            for t in (out, *vjp(jnp.asarray(do, jnp.bfloat16)))]


def _assert_close(port, ref, label, tols):
    for name, got, want in zip(("o", "dq", "dk", "dv"), port, ref):
        tol = tols[name != "o"] * np.abs(want).max()
        err = np.abs(got - want).max()
        assert np.isfinite(got).all() and err <= tol, (label, name, err, tol)


@pytest.mark.parametrize("b,h,L,d", [(1, 2, 320, 16), (1, 2, 256, 8),
                                     (1, 1, 200, 32)])
def test_plain_bf16_matches_pallas_kernel_in_interpret_mode(b, h, L, d):
    """The stock TPU kernel at bf16, in TPU interpret mode, the sequence
    padded to its 128-row tiling as movae_tpu/ops/attention.py pads it."""
    from jax.experimental.pallas import tpu as pltpu
    from jax.experimental.pallas.ops.tpu import flash_attention as jfa

    q, k, v, do = _bf16_inputs(L + d, (b, h, L, d))
    scale = 1.0 / np.sqrt(d)
    Lp = -(-L // 128) * 128
    pad = ((0, 0), (0, 0), (0, Lp - L), (0, 0))

    def pallas(a, b_, c):
        out = jfa.flash_attention(jnp.pad(a, pad), jnp.pad(b_, pad),
                                  jnp.pad(c, pad), causal=True,
                                  sm_scale=scale)
        return out[:, :, :L]

    with pltpu.force_tpu_interpret_mode():
        ref = _jax(pallas, q, k, v, do)
    port = _port(fa.flash_causal_attention_plain, q, k, v, do, scale)
    _assert_close(port, ref, (b, h, L, d), PALLAS_TOL)


def test_plain_bf16_against_float64():
    """Against float64 from the same bf16-rounded inputs: the bf16
    roundings alone separate them."""
    q, k, v, do = _bf16_inputs(3, (2, 2, 96, 16))
    scale = 0.25
    port = _port(fa.flash_causal_attention_plain, q, k, v, do, scale)
    ts = [torch.tensor(a, dtype=torch.float64, requires_grad=True)
          for a in (q, k, v)]
    out = fa.dense_causal_attention(*ts, scale)
    grads = torch.autograd.grad(out, ts, torch.tensor(do, dtype=torch.float64))
    ref = [t.detach().numpy() for t in (out, *grads)]
    _assert_close(port, ref, "float64", F64_TOL)


def test_plain_bf16_chunks_give_the_same_bits(monkeypatch):
    """The plain version's B chunking (memory) does not change a bit."""
    q, k, v, do = _bf16_inputs(11, (3, 2, 40, 8))
    whole = _port(fa.flash_causal_attention_plain, q, k, v, do, 0.3)
    monkeypatch.setattr(fa, "_PLAIN_CHUNK", 1)
    chunked = _port(fa.flash_causal_attention_plain, q, k, v, do, 0.3)
    for a, b in zip(whole, chunked):
        np.testing.assert_array_equal(a, b)


def test_dense_bf16_computes_in_bf16_like_jax():
    """At L <= 1024 the dense path computes in the inputs' dtype, as the
    JAX package's dense_causal_attention does."""
    q, k, v, do = _bf16_inputs(5, (1, 2, 64, 16))
    port = _port(tatt.dense_causal_attention, q, k, v, do, 0.25)
    ref = _jax(lambda a, b_, c: jatt.dense_causal_attention(a, b_, c, 0.25),
               q, k, v, do)
    _assert_close(port, ref, "dense", DENSE_TOL)


@pytest.mark.parametrize("L,path", [(64, "dense"), (1025, "flash")])
def test_bf16_dispatch_keeps_the_dtype(monkeypatch, L, path):
    calls = []
    for name in ("dense_causal_attention", "flash_causal_attention"):
        real = getattr(tatt, name)
        monkeypatch.setattr(tatt, name, lambda *a, _n=name, _r=real, **kw: (
            calls.append((_n, a[0].dtype)), _r(*a, **kw))[1])
    q = torch.randn(1, 1, L, 8).to(torch.bfloat16)
    out = tatt.causal_attention(q, q, q, 0.3)
    assert calls == [(f"{path}_causal_attention", torch.bfloat16)]
    assert out.dtype == torch.bfloat16


def test_bf16_weights_fn_is_refused_by_the_flash_plain_version():
    q = torch.randn(1, 1, 8, 8).to(torch.bfloat16)
    with pytest.raises(ValueError, match="weights_fn"):
        fa.flash_causal_attention_plain(q, q, q, 0.3, weights_fn=lambda w: w)
