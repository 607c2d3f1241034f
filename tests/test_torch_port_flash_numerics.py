"""The arithmetic of the causal flash-attention kernels, emulated on the CPU.

``movae_tpu_torch/kernels/flash_attention.cu`` computes every logit as a
float32 ``fmaf`` chain on q scaled by ``s * log2(e)``, and the forward's
p v, dK/dV's do v^T, p^T do and ds^T q, and dQ's do v^T and ds k on the
tensor cores in split TF32: x = big + small, each rounded to nearest TF32
(10 explicit mantissa bits), and a b ~ a_small b_big + a_big b_small +
a_big b_big, summed in float32. The forward runs an online softmax over
steps of 32 keys, adding each step's p v to its running sum; dQ adds each
step of 32 keys' ds k to its running sum.

The CUDA kernels run only on the card (``chip_smoke.py`` holds them against
the plain version there). This file emulates their arithmetic in torch on the
CPU and holds it against the plain version in float64 within
``chip_smoke.py``'s limits: 1e-4 (o) or 1e-3 (gradients) of the largest
value, or twice the float32 plain version's own error, whichever is larger;
at unit scale and with q and k scaled so that the logits reach ~1e4, as in
the check on the trained prior's q, k, v.
"""

import functools
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from movae_tpu_torch.kernels import flash_attention as fa  # noqa: E402

# chip_smoke.py: FLASH_O_TOL, FLASH_GRAD_TOL, FLASH_PLAIN_FACTOR
O_TOL, GRAD_TOL, PLAIN_FACTOR = 1e-4, 1e-3, 2.0
LOG2E = 1.4426950408889634
KEY_STEP = 32  # the forward's keys per online-softmax step
DQ_STEP = 32  # dQ's keys per step


def tf32(x):
    """Round float32 to TF32 (10 explicit mantissa bits), to nearest with
    ties away from zero (``cvt.rna.tf32.f32``), on the int32 view."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x):
    big = tf32(x)
    return big, tf32(x - big)


def mm3(a, b):
    """a @ b in split TF32: the two cross terms, then big x big."""
    (ab, as_), (bb, bs) = split(a), split(b)
    return as_ @ bb + ab @ bs + ab @ bb


def _scale_log2(scale):
    # the C interface gets float32 scale and multiplies by float32 log2(e)
    return np.float32(scale) * np.float32(LOG2E)


def _logits(q, k, scale):
    """Scaled base-2 logits, masked: q scaled once, then the kernels' chain
    acc = fmaf(q_s[i], k[i], acc), i ascending (a float32 product is exact
    in float64, so each step rounds once to float32, as fmaf does, but for
    rare double roundings)."""
    L = q.shape[2]
    qs = (q * float(_scale_log2(scale))).double()
    kt = k.double().transpose(-1, -2)
    s = torch.zeros(q.shape[:-1] + (L,), dtype=torch.float64)
    for i in range(q.shape[-1]):
        s = (qs[..., i, None] * kt[..., i, None, :] + s).float().double()
    s = s.float()
    mask = torch.ones((L, L), dtype=torch.bool).tril()
    return s.masked_fill(~mask, float("-inf")), mask


def emulated_forward(q, k, v, scale, mm=mm3):
    """(o, lse2) as the forward kernel computes them."""
    s, _ = _logits(q, k, scale)
    shape = q.shape[:-1]
    m = torch.full(shape, float("-inf"))
    l = torch.zeros(shape)
    acc = torch.zeros_like(q)
    for c in range(0, q.shape[2], KEY_STEP):
        sc, vc = s[..., c:c + KEY_STEP], v[..., c:c + KEY_STEP, :]
        mx = torch.maximum(m, sc.amax(-1))
        corr = torch.exp2(m - mx)
        p = torch.exp2(sc - mx[..., None])
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + mm(p, vc)
        m = mx
    return acc * (1.0 / l)[..., None], m + torch.log2(l)


def emulated_dkv(q, k, v, do, lse2, di, scale, mm=mm3):
    """(dk, dv) as the dK/dV kernel computes them."""
    s, mask = _logits(q, k, scale)
    p = torch.where(mask, torch.exp2(s - lse2[..., None]), 0.0)
    dp = mm(do, v.transpose(-1, -2))
    ds = p * (dp - di[..., None])
    sl2 = _scale_log2(scale)
    qs = q * float(sl2)
    dk = mm(ds.transpose(-1, -2), qs) * float(np.float32(scale) / sl2)
    return dk, mm(p.transpose(-1, -2), do)


def emulated_dq(q, k, v, do, lse2, di, scale, mm=mm3):
    """dq as the dQ kernel computes it: the forward's logits and p, dp = do
    v^T, ds = p (dp - di), and per step of 32 keys the product ds k, added
    to the running float32 sum; stored times the scale."""
    s, mask = _logits(q, k, scale)
    p = torch.where(mask, torch.exp2(s - lse2[..., None]), 0.0)
    ds = p * (mm(do, v.transpose(-1, -2)) - di[..., None])
    dq = torch.zeros_like(q)
    for c in range(0, q.shape[2], DQ_STEP):
        dq = dq + mm(ds[..., c:c + DQ_STEP], k[..., c:c + DQ_STEP, :])
    return dq * float(np.float32(scale))


@functools.lru_cache(maxsize=None)
def _case(scale_kind, L, d):
    """The emulated kernels' outputs with split-TF32 and with exact float32
    products, and the plain version's in float32 and float64 (o, dq, dk,
    dv)."""
    rng = np.random.default_rng(L * 100 + d)
    q, k, v, do = (torch.tensor(rng.normal(size=(1, 2, L, d)).astype(
        np.float32)) for _ in range(4))
    scale = d ** -0.5
    if scale_kind == "logits_1e4":
        # grow q and k until the largest logit is ~1e4, like the trained
        # prior's in chip_smoke.py
        top = float((q @ k.transpose(-1, -2)).abs().max()) * scale
        c = math.sqrt(1e4 / top)
        q, k = q * c, k * c
    emulated = {}
    for name, mm in (("split", mm3), ("exact", torch.matmul)):
        o, lse2 = emulated_forward(q, k, v, scale, mm)
        di = (o * do).sum(-1)
        dk, dv = emulated_dkv(q, k, v, do, lse2, di, scale, mm)
        dq = emulated_dq(q, k, v, do, lse2, di, scale, mm)
        emulated[name] = {"o": o, "dq": dq, "dk": dk, "dv": dv}
    refs = {}
    for dtype in (torch.float32, torch.float64):
        leaves = [t.to(dtype).requires_grad_() for t in (q, k, v)]
        out = fa.flash_causal_attention_plain(*leaves, scale)
        refs[dtype] = [out.detach(), *torch.autograd.grad(
            out, leaves, do.to(dtype))]
    return emulated, refs


def _assert_within_gate(scale_kind, L, d, key, tol, chain_allowed=False):
    """The split-TF32 emulation within chip_smoke.py's gate. With
    ``chain_allowed``, a miss of the gate must be the logit chain's: the
    result then lies within 1e-6 of the largest value of the same
    arithmetic with exact float32 products."""
    emulated, refs = _case(scale_kind, L, d)
    i = ("o", "dq", "dk", "dv").index(key)
    want = refs[torch.float64][i]
    top = float(want.abs().max())
    got = emulated["split"][key]
    err = float((got.double() - want).abs().max())
    plain_err = float((refs[torch.float32][i].double() - want).abs().max())
    limit = max(tol * top, PLAIN_FACTOR * plain_err)
    chain_err = float((emulated["exact"][key].double() - want).abs().max())
    if chain_allowed:
        limit = max(limit, chain_err + 1e-6 * top)
    assert torch.isfinite(got).all()
    assert err <= limit, (f"{key}: {err:.3e} off float64, limit {limit:.3e} "
                          f"(float32 plain {plain_err:.3e}, exact products "
                          f"{chain_err:.3e}, largest {top:.3e})")


SIZES = [(L, d) for L in (257, 1025) for d in (8, 16)]


def test_split_reconstructs_within_2_pow_minus_21():
    rng = np.random.default_rng(0)
    x = torch.tensor((rng.normal(size=100_000)
                      * 10.0 ** rng.uniform(-30, 30, size=100_000)).astype(
                          np.float32))
    big, small = split(x)
    for part in (big, small):  # both TF32: the low 13 bits are zero
        assert not (part.view(torch.int32) & 0x1FFF).any()
    err = ((big.double() + small.double()) - x.double()).abs()
    assert (err <= 2.0 ** -21 * x.double().abs()).all()
    # round to nearest, ties away from zero
    tie = torch.tensor([0x3F801000, 0x3F800FFF], dtype=torch.int32)
    assert tf32(tie.view(torch.float32)).view(torch.int32).tolist() == [
        0x3F802000, 0x3F800000]
    assert tf32(-tie.view(torch.float32)).tolist() == [
        -float(tf32(tie.view(torch.float32))[0]), -1.0]


@pytest.mark.parametrize("L,d", SIZES)
def test_forward_split_tf32_within_gate(L, d):
    _assert_within_gate("unit", L, d, "o", O_TOL)


@pytest.mark.parametrize("L,d", SIZES)
def test_dkv_split_tf32_within_gate(L, d):
    _assert_within_gate("unit", L, d, "dk", GRAD_TOL)
    _assert_within_gate("unit", L, d, "dv", GRAD_TOL)


@pytest.mark.parametrize("L,d", SIZES)
def test_dq_split_tf32_within_gate(L, d):
    _assert_within_gate("unit", L, d, "dq", GRAD_TOL)


# At logits ~1e4 a float32 logit carries ~1e-3 of rounding. The chain that
# the three kernels share (and must share, so that the backward's p is the
# forward's) can then land past twice the plain version's error, with exact
# float32 products as much as with the split (o at L=1025, D=16: 8.4e-4 on a
# largest value of 4.2, plain 2.3e-4): that is the chain's, not the split's.
@pytest.mark.parametrize("L,d", SIZES)
def test_forward_split_tf32_at_logits_1e4(L, d):
    _assert_within_gate("logits_1e4", L, d, "o", O_TOL, chain_allowed=True)


@pytest.mark.parametrize("L,d", SIZES)
def test_dkv_split_tf32_at_logits_1e4(L, d):
    _assert_within_gate("logits_1e4", L, d, "dk", GRAD_TOL,
                        chain_allowed=True)
    _assert_within_gate("logits_1e4", L, d, "dv", GRAD_TOL,
                        chain_allowed=True)


@pytest.mark.parametrize("L,d", SIZES)
def test_dq_split_tf32_at_logits_1e4(L, d):
    _assert_within_gate("logits_1e4", L, d, "dq", GRAD_TOL,
                        chain_allowed=True)
