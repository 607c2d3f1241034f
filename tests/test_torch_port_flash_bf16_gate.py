"""chip_smoke.py's gate on the bfloat16 flash kernels (phase 17a), on the
CPU: the kernels' arithmetic emulated in torch passes it, and the planted
faults that 17a plants on the card do not.

``movae_tpu_torch/kernels/flash_attention.cu``'s bf16 forward takes the
raw logits s from bf16 products summed in float32 in two passes over the
keys: the first takes each row's maximum m of the raw logits, the second,
in steps of 64 keys (32 at D = 128), p = 2^fma(s, c, -m c) (c = scale *
log2(e), m c one float32 product, results below 2^-126 flushed to 0),
rounded to bf16 before p v; the sum takes the unrounded p, and o =
bf16(acc / sum), lse2 = m c + log2(sum). The dK/dV and dQ kernels both
recompute p = 2^fma(s, c, -lse2) and ds = p fma(dp, scale, -di scale), so
one and the same bf16 ds feeds dq and dk; the two round p and ds to
bf16 before their products and sum in another order than torch's GEMMs,
which the emulation models by summing in float64 (a float32 fma is a
float64 sum rounded once). The plain version (``plain_fwd_bf16``/
``plain_bwd_bf16``) rounds at the same points against the row's final
maximum, in base 2 with one float32 fma for p and one for ds, as the
kernels compute them: on inputs whose sums are exact in any order its p
and ds equal the emulation's element for element.

The gate and the controls are chip_smoke.py's own functions, loaded from
the checkout.
"""

import importlib.util
import math
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from movae_tpu_torch.kernels import flash_attention as fa  # noqa: E402

LOG2E = 1.4426950408889634
TINY = 2.0 ** -126  # ex2.approx.ftz flushes results below it to 0


def tile(d):
    """The forward kernel's keys per step of its second pass (kFwdStep)."""
    return 64 if d <= 64 else 32


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_gate", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


cs = _chip_smoke()


def _bf(x):
    return x.to(torch.bfloat16).float()


def _fma(a, b, c):
    """float32 fma(a, b, c): the product is exact in float64."""
    return (a.double() * b + c.double()).float()


def _ex2(x):
    """ex2.approx.ftz.f32, exactly rounded."""
    p = torch.exp2(x)
    return torch.where(p < TINY, torch.zeros_like(p), p)


def _kernel_fwd(q, k, v, scale):
    """The forward kernel's two passes: each row's final maximum of the raw
    logits, then its steps against it: (o, lse2)."""
    B, H, L, D = q.shape
    T, c = tile(D), torch.tensor(scale * LOG2E, dtype=torch.float32)
    qf, kf, vf = q.float(), k.float(), v.float()
    rows = torch.arange(L)[:, None]
    s = (qf @ kf.transpose(-1, -2)).masked_fill(
        torch.arange(L)[None, :] > rows, -math.inf)
    mc = s.amax(-1, keepdim=True) * c  # key 0 is in every row
    s_sum = torch.zeros((B, H, L, 1))
    acc = torch.zeros((B, H, L, D))
    for k0 in range(0, L, T):
        p = _ex2(_fma(s[..., k0:k0 + T], c, -mc))
        s_sum = s_sum + p.sum(-1, keepdim=True)
        acc = acc + _bf(p) @ vf[:, :, k0:k0 + T]
    return (acc * (1.0 / s_sum)).to(torch.bfloat16), (mc + torch.log2(s_sum))[
        ..., 0]


def _kernel_p_ds(q, k, v, o, lse2, do, scale):
    """The p and ds both backward kernels compute from the forward's o and
    lse2, with one fma each (float32 holding ds's bf16 values)."""
    L = q.shape[2]
    c = torch.tensor(scale * LOG2E, dtype=torch.float32)
    sc = torch.tensor(scale, dtype=torch.float32)
    s = (q.double() @ k.double().transpose(-1, -2)).float()
    causal = torch.ones(L, L, dtype=torch.bool).tril()
    di = (o.float() * do.float()).sum(-1, keepdim=True)
    dp = (do.double() @ v.double().transpose(-1, -2)).float()
    # 2^fma(s, c, -lse2), p fma(dp, s, -di s)
    p = _ex2(_fma(s, c, -lse2[..., None])).masked_fill(~causal, 0.0)
    return p, _bf(p * _fma(dp, sc, -(di * sc)))


def _kernel_bwd(q, k, v, o, lse2, do, scale):
    """The backward kernels from the forward's o and lse2, summed in
    float64: (dq, dk, dv)."""
    p, ds = _kernel_p_ds(q, k, v, o, lse2, do, scale)
    ds = ds.double()
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
# ragged L at the edges of the forward's key step T: T - 1, T + 1, 2T + 1
CASES += [((1, 1, L, d), 1.0) for d in (8, 16)
          for L in (tile(d) - 1, tile(d) + 1, 2 * tile(d) + 1)]


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
    plain = dict(zip(keys, cs.plain_bf16(fa, q, k, v, do, o, lse2, scale)))
    terms = cs.bf16_terms(torch, fa, q, k, v, do, o, lse2, scale)
    o_p, lse2_p = fa.plain_fwd_bf16(q, k, v, scale)
    e2e = dict(zip(keys, cs.plain_bf16(fa, q, k, v, do, o_p, lse2_p,
                                       scale)))
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


def _sharp_integer_inputs(shape, seed):
    """bf16 q, k of integers in [-16, 16] and v, do of integers in [-4, 4]:
    every product and every sum of D of them is exact in float32, so s and
    dp do not depend on the order of summation; the logits s scale reach
    1e2-1e3 and the rows are sharp. The keys of the first half come in
    equal pairs: a row whose weight sits on such a pair has dq terms that
    cancel to far less than themselves."""
    g = torch.Generator().manual_seed(seed)

    def ints(hi):
        return torch.randint(-hi, hi + 1, shape, generator=g).to(
            torch.bfloat16)

    q, k, v, do = ints(16), ints(16), ints(4), ints(4)
    h = shape[2] // 4 * 2
    k[:, :, 1:h:2] = k[:, :, 0:h:2]
    return q, k, v, do


SHARP = [(1, 2, 512, 16), (1, 2, 333, 32)]


@pytest.mark.parametrize("shape", SHARP)
def test_base2_plain_p_and_ds_equal_the_kernel_emulation(shape):
    """On sharp rows: the plain version's p (forward and backward) and ds
    equal the emulated kernels' element for element, and its lse2 is the
    emulated forward's up to the order of the row sum."""
    q, k, v, do = _sharp_integer_inputs(shape, seed=shape[2])
    scale = shape[-1] ** -0.5
    c = fa.log2e_scale(scale)
    assert c == torch.tensor(scale * LOG2E, dtype=torch.float32).item()
    o, lse2 = _kernel_fwd(q, k, v, scale)
    s = fa._plain_logits(q, k)
    logits = s[torch.isfinite(s)].abs() * scale
    assert 1e2 <= float(logits.max()) <= 1e3, float(logits.max())
    # the forward: p against each row's maximum of s c
    mc = s.amax(-1, keepdim=True) * c
    torch.testing.assert_close(fa.plain_p_bf16(s, c, mc),
                               _ex2(_fma(s, c, -mc)), rtol=0, atol=0)
    o_p, lse2_p = fa.plain_fwd_bf16(q, k, v, scale)
    torch.testing.assert_close(lse2_p, lse2, rtol=1e-6, atol=1e-5)
    # the backward from the emulated forward's o and lse2
    p_k, ds_k = _kernel_p_ds(q, k, v, o, lse2, do, scale)
    p = fa.plain_p_bf16(s, c, lse2[..., None])
    di = (o.float() * do.float()).sum(-1, keepdim=True)
    ds = fa.plain_ds_bf16(p, do.float() @ v.float().transpose(-1, -2), di,
                          scale)
    torch.testing.assert_close(p, p_k, rtol=0, atol=0)
    torch.testing.assert_close(ds, ds_k, rtol=0, atol=0)
    # sharp rows: most rows put nearly all their weight on one key or on
    # one pair of equal keys
    top2 = p.topk(2, dim=-1).values.sum(-1)
    assert float((top2 > 0.99).float().mean()) > 0.5


@pytest.mark.parametrize("shape", SHARP)
def test_sharp_rows_pass_the_gate_and_controls_fail(shape):
    """On sharp rows whose dq terms cancel: the emulated kernels within the
    gate of the base-2 plain version and, as the port runs them end to
    end, of float64; every planted control refused."""
    q, k, v, do = _sharp_integer_inputs(shape, seed=shape[2] + 1)
    scale = shape[-1] ** -0.5
    o, lse2 = _kernel_fwd(q, k, v, scale)
    keys = ("o", "dq", "dk", "dv")
    got = dict(zip(keys, (o, *_kernel_bwd(q, k, v, o, lse2, do, scale))))
    plain = dict(zip(keys, cs.plain_bf16(fa, q, k, v, do, o, lse2, scale)))
    terms = cs.bf16_terms(torch, fa, q, k, v, do, o, lse2, scale)
    o_p, lse2_p = fa.plain_fwd_bf16(q, k, v, scale)
    e2e = dict(zip(keys, cs.plain_bf16(fa, q, k, v, do, o_p, lse2_p,
                                       scale)))
    leaves = [t.double().requires_grad_() for t in (q, k, v)]
    out = fa.dense_causal_attention(*leaves, scale)
    f64 = dict(zip(keys, (out.detach(), *torch.autograd.grad(
        out, leaves, do.double()))))
    # rows where dq cancels to far less than the terms summed into it
    rss = terms["dq"].double().norm(dim=-1)
    row = f64["dq"].norm(dim=-1)[rss > 0] / rss[rss > 0]
    assert float((row < 0.1).float().mean()) > 0.2, row
    for key, g in got.items():
        a = cs.bf16_agreement(torch, g, plain[key], terms[key])
        assert cs.bf16_agrees(a), (key, a)
        kf = cs.bf16_agreement(torch, g, f64[key], terms[key])
        pf = cs.bf16_agreement(torch, e2e[key], f64[key], terms[key])
        assert cs.bf16_as_close(kf, pf), (key, kf, pf)
    res = cs.flash_bf16_controls(torch, fa, str(shape), q, k, v, do)
    planted = [n for n in res if not n.endswith("_reported")]
    assert all(not cs.bf16_agrees(res[n]) for n in planted), res


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


SASS = """
        Function : _ZN12_GLOBAL__N_121flash_fwd_bf16_kernelILi16EEEvPKt
        /*0000*/                   S2R R0, SR_TID.X ;
        /*0010*/              @!P0 BRA 0x100 ;
        /*0020*/                   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;
        /*0030*/                   FFMA R1, R2, R3, -R4 ;
        /*0040*/                   MUFU.EX2 R1, R1 ;
        /*0050*/                   FFMA R5, R6, R3, -R4 ;
        /*0060*/                   MUFU.EX2 R5, R5 ;
        /*0070*/                   FADD R7, R1, R5 ;
        /*0080*/                   LDSM.16.M88.4 R8, [R9] ;
        /*0090*/               @P1 BRA 0x20 ;
        /*00a0*/                   MUFU.RCP R2, R7 ;
        /*00b0*/                   EXIT ;
"""

PTXAS = """ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__flash_attention_cu_2724flash_bwd_dq_bf16_kernelILi16EEEvPKt' for 'sm_90a'
ptxas info    : Function properties for _ZN45_GLOBAL__N__flash_attention_cu_2724flash_bwd_dq_bf16_kernelILi16EEEvPKt
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_116flash_fwd_kernelILi16EEEvPKf' for 'sm_90a'
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 118 registers, used 1 barriers
"""


def test_sass_counts_reads_the_hot_step(tmp_path):
    """17a's SASS reading: opcodes with their first modifier (MUFU.EX2 apart
    from MUFU.RCP), and the branch-free run with the most MUFU.EX2; the A/B
    script's ptxas reading keeps only the bf16 kernels."""
    from movae_tpu_torch.kernels.flash_ab import bf16_registers

    listing = tmp_path / "lib.sass"
    listing.write_text(SASS)
    fake = tmp_path / "cuobjdump"
    fake.write_text(f"#!/bin/sh\ncat {listing}\n")
    fake.chmod(0o755)
    ops = cs.sass_counts(str(fake), "lib.so")["flash_fwd_bf16_kernel<16>"]
    assert (ops["all"], ops["MUFU"], ops["MUFU.EX2"], ops["HMMA"],
            ops["LDSM"], ops["FFMA"]) == (12, 3, 2, 1, 1, 2)
    assert ops["hot"] == [8, 2]  # 0x0020 .. the branch at 0x0090
    whole, hot = cs.per_ex2(ops)
    assert (whole, hot) == ((12 - 3) / 2, (8 - 2) / 2)
    assert bf16_registers(PTXAS) == {"flash_bwd_dq_bf16_kernel": [64, 0, 0]}
