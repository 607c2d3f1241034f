"""chip_smoke.py's gate on the bfloat16 flash kernels (phase 17a), on the
CPU: the kernels' arithmetic emulated in torch passes it, and the planted
faults that 17a plants on the card do not.

``movae_tpu_torch/kernels/flash_attention.cu``'s bf16 forward takes the
logits from bf16 products summed in float32, scales them by
``s * log2(e)`` in float32 and runs an online softmax over tiles of 64 keys:
each tile's p = exp2(logit - running max) is rounded to bf16 before p v,
the running sum takes the unrounded p, and o = bf16(acc / sum). Its
backward kernels recompute p = exp2(logit - lse2) from the forward's lse2
and round p and ds to bf16 before their products; they sum in another
order than torch's GEMMs, which the emulation models by summing in
float64. The plain version (``plain_fwd_bf16``/``plain_bwd_bf16``) rounds
at the same points against the row's final maximum.

The gate and the controls are chip_smoke.py's own functions, loaded from
the checkout.
"""

import importlib.util
import math
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from movae_tpu_torch.kernels import flash_attention as fa  # noqa: E402

TILE = 64  # the forward kernel's keys per online-softmax step
LOG2E = 1.4426950408889634


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_gate", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


cs = _chip_smoke()


def _bf(x):
    return x.to(torch.bfloat16).float()


def _kernel_fwd(q, k, v, scale):
    """The forward kernel's tiles: (o, lse2)."""
    B, H, L, D = q.shape
    qf, kf, vf = q.float(), k.float(), v.float()
    m = torch.full((B, H, L, 1), -math.inf)
    s_sum = torch.zeros((B, H, L, 1))
    acc = torch.zeros((B, H, L, D))
    rows = torch.arange(L)[:, None]
    for k0 in range(0, L, TILE):
        s = (qf @ kf[:, :, k0:k0 + TILE].transpose(-1, -2)) * (scale * LOG2E)
        keys = torch.arange(k0, min(k0 + TILE, L))[None, :]
        s = s.masked_fill(keys > rows, -math.inf)
        mx = torch.maximum(m, s.amax(-1, keepdim=True))
        corr = torch.nan_to_num(torch.exp2(m - mx), nan=0.0)
        p = torch.nan_to_num(torch.exp2(s - mx), nan=0.0)
        s_sum = s_sum * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + _bf(p) @ vf[:, :, k0:k0 + TILE]
        m = mx
    return (acc * (1.0 / s_sum)).to(torch.bfloat16), (m + torch.log2(s_sum))[
        ..., 0]


def _kernel_bwd(q, k, v, o, lse2, do, scale):
    """The backward kernels from the forward's o and lse2, summed in
    float64: (dq, dk, dv)."""
    L = q.shape[2]
    s = (q.double() @ k.double().transpose(-1, -2)).float() * (scale * LOG2E)
    s = s.masked_fill(~torch.ones(L, L, dtype=torch.bool).tril(), -math.inf)
    p = torch.exp2(s - lse2[..., None])
    di = (o.float() * do.float()).sum(-1, keepdim=True)
    dp = (do.double() @ v.double().transpose(-1, -2)).float()
    ds = _bf((dp - di) * p * scale).double()
    dv = _bf(p).double().transpose(-1, -2) @ do.double()
    return [t.to(torch.bfloat16) for t in
            (ds @ k.double(), ds.transpose(-1, -2) @ q.double(), dv)]


def _inputs(shape, seed, sharp=1.0):
    g = torch.Generator().manual_seed(seed)
    q, k, v, do = (torch.randn(shape, generator=g).to(torch.bfloat16)
                   for _ in range(4))
    # sharp: larger logits, the attention of a trained prior
    return (q.float() * sharp).to(torch.bfloat16), \
        (k.float() * sharp).to(torch.bfloat16), v, do


CASES = [((1, 2, 1024, 16), 1.0), ((1, 2, 1025, 8), 1.0),
         ((1, 2, 777, 32), 1.0), ((1, 1, 333, 128), 1.0),
         ((1, 2, 1024, 16), 5.0), ((1, 2, 640, 32), 5.0)]


@pytest.mark.parametrize("shape,sharp", CASES)
def test_kernel_arithmetic_passes_the_bf16_gate(shape, sharp):
    """The emulated kernels against the plain version (the backward fed the
    forward's o and lse) within bf16_agrees, and against float64 within
    bf16_as_close of the plain version's own distance."""
    q, k, v, do = _inputs(shape, seed=shape[2], sharp=sharp)
    scale = shape[-1] ** -0.5
    o, lse2 = _kernel_fwd(q, k, v, scale)
    got = dict(zip(("o", "dq", "dk", "dv"),
                   (o, *_kernel_bwd(q, k, v, o, lse2, do, scale))))
    keys = ("o", "dq", "dk", "dv")
    lse = lse2 * math.log(2.0)
    plain = dict(zip(keys, cs.plain_bf16(fa, q, k, v, do, o, lse, scale)))
    terms = cs.bf16_terms(torch, fa, q, k, v, do, o, lse, scale)
    o_p, lse_p = fa.plain_fwd_bf16(q, k, v, scale)
    e2e = dict(zip(keys, cs.plain_bf16(fa, q, k, v, do, o_p, lse_p, scale)))
    leaves = [t.double().requires_grad_() for t in (q, k, v)]
    out = fa.dense_causal_attention(*leaves, scale)
    f64 = dict(zip(("o", "dq", "dk", "dv"), (out.detach(), *torch.autograd
                                             .grad(out, leaves,
                                                   do.double()))))
    for key, g in got.items():
        a = cs.bf16_agreement(torch, g, plain[key], terms[key])
        assert cs.bf16_agrees(a), (key, a)
        kf = cs.bf16_agreement(torch, g, f64[key], terms[key])
        pf = cs.bf16_agreement(torch, e2e[key], f64[key], terms[key])
        assert cs.bf16_as_close(kf, pf), (key, kf, pf)


@pytest.mark.parametrize("shape,sharp", [(cs.FLASH_BF16_CONTROL, 1.0),
                                         ((1, 2, 1024, 16), 5.0)])
def test_planted_faults_fail_the_bf16_gate(shape, sharp):
    """chip_smoke.py's flash_bf16_controls: every planted fault is refused
    by the gate (it raises if one passes), the same function 17a runs on
    the card; q pre-scaled in bf16 is planted only where 1/sqrt(D) is not a
    power of two."""
    q, k, v, do = _inputs(shape, seed=7, sharp=sharp)
    res = cs.flash_bf16_controls(torch, fa, str(shape), q, k, v, do)
    planted = [n for n in res if not n.endswith("_reported")]
    assert ("o_q_prescaled_in_bf16" in planted) == (shape[-1] == 32)
    assert len(planted) == 3 + (shape[-1] == 32)
    assert all(not cs.bf16_agrees(res[n]) for n in planted)
    assert fa._bf(torch.tensor([1.0 + 2 ** -10])).item() == 1.0  # restored


def test_gate_refuses_a_bias_within_1e2_of_the_largest_value():
    """An output normalised 0.9% low sits within 1e-2 of the largest value
    of the plain version's (a limit relative to the whole output's largest
    value cannot see it), yet fails the gate's scale term."""
    q, k, v, _ = _inputs((1, 2, 1024, 16), seed=9)
    o, _ = fa.plain_fwd_bf16(q, k, v, 0.25)
    low = (o.float() * 0.991).to(torch.bfloat16)
    err = (low.float() - o.float()).abs().max() / o.float().abs().max()
    assert err < 1e-2
    a = cs.bf16_agreement(torch, low, o, torch.zeros(o.shape))
    assert abs(a["scale"]) > cs.BF16_SCALE and not cs.bf16_agrees(a)
