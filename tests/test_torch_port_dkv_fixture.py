"""17a's trained-prior fixture (movae_tpu_torch/kernels/fixtures/
dkv_sharp_prior.pt), the plain bf16 version's summation flag
(kernels/flash_attention.py) and dk's per-product attribution
(chip_smoke.py:plain_dk_summed).

The fixture is one (batch, head) slice of a trained bf16 PixelSNAIL's
q/k/v with its cotangent, on which the dK/dV kernel that summed the logits
on the tensor cores put dk past 17a's float64 half (its dk is stored as
``parent_dk``). On the CPU: the plain version with IEEE float32 sums
passes that half, as the repaired kernels must on the card, and the stored
dk of the old kernel fails it, so the fixture still holds the fault that
chip_smoke.py's plain run checks.
"""

import importlib.util
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from movae_tpu_torch.kernels import flash_attention as fa  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FIXTURE = ROOT / "movae_tpu_torch" / "kernels" / "fixtures" / \
    "dkv_sharp_prior.pt"


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_fixture",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def held():
    """dk of the IEEE plain version end to end and the stored kernel dk,
    each against float64 (17a's bf16_agreement), on the fixture."""
    cs = _chip_smoke()
    fix = torch.load(FIXTURE, weights_only=False)
    q, k, v, do = (fix[n] for n in ("q", "k", "v", "do"))
    assert q.shape == (1, 1, 4096, 16) and q.dtype == torch.bfloat16
    scale = q.shape[-1] ** -0.5
    o, lse2 = fa.plain_fwd_bf16(q, k, v, scale)
    dk = fa.plain_bwd_bf16(q, k, v, o, lse2, do, scale)[1]
    terms = cs.bf16_terms(torch, fa, q, k, v, do, o, lse2, scale)["dk"]
    leaves = [t.double().requires_grad_() for t in (q, k, v)]
    out = fa.dense_causal_attention(*leaves, scale)
    f64_dk = torch.autograd.grad(out, leaves, do.double())[1]
    plain = cs.bf16_agreement(torch, dk, f64_dk, terms)
    parent = cs.bf16_agreement(torch, fix["parent_dk"], f64_dk, terms)
    return cs, plain, parent


def test_ieee_plain_version_passes_the_float64_half(held):
    """The plain version is its own yardstick in 17a's float64 half: it
    passes, and its dk sits near the -0.806 u the card's IEEE sums gave."""
    cs, plain, _ = held
    assert cs.bf16_as_close(plain, plain)
    assert -0.9 < plain["scale"] < -0.7, plain


def test_stored_tensor_core_dk_fails_the_float64_half(held):
    """The dK/dV kernel that summed the logits on the tensor cores fails
    17a's float64 half on the fixture: dk's best-fit scale 0.0625 u or more
    past the plain version's."""
    cs, plain, parent = held
    assert not cs.bf16_as_close(parent, plain), (parent, plain)
    assert parent["scale"] < plain["scale"] - cs.BF16_SCALE


def _small(seed: int = 3):
    g = torch.Generator().manual_seed(seed)
    return g, [torch.randn((1, 2, 80, 16), generator=g).to(torch.bfloat16)
               for _ in range(4)]


@pytest.mark.parametrize("on", [
    (), ("logits", "pv", "dp", "dk"), ("dp",), ("logits", "dk")])
def test_tensor_cores_flag_names_products(on):
    """dk's attribution (chip_smoke.py:plain_dk_summed) names the products
    that feed dk and sums them as the plain version does: on CPU tensors
    every product sums in IEEE float32 whichever are named, so its dk is
    the plain version's bit for bit; an unknown name raises."""
    cs = _chip_smoke()
    assert set(on) <= set(cs.DK_PRODUCTS)
    _, (q, k, v, do) = _small()
    scale = q.shape[-1] ** -0.5
    o, lse2 = fa.plain_fwd_bf16(q, k, v, scale)
    want = fa.plain_bwd_bf16(q, k, v, o, lse2, do, scale)[1]
    assert torch.equal(cs.plain_dk_summed(torch, fa, q, k, v, do, on), want)
    with pytest.raises(ValueError, match="unknown products"):
        cs.plain_dk_summed(torch, fa, q, k, v, do, ("dv",))


def test_cpu_plain_version_sums_in_ieee_whatever_the_flag():
    """On CPU tensors every product sums in IEEE float32 under either
    flag: the forward and the backward are unchanged by
    ``tensor_cores=True``, and the fma chain of the logits equals the IEEE
    sum on these small integers."""
    g, (q, k, v, do) = _small()
    scale = 0.25
    o, lse2 = fa.plain_fwd_bf16(q, k, v, scale)
    o2, l2 = fa.plain_fwd_bf16(q, k, v, scale, True)
    assert torch.equal(o, o2) and torch.equal(lse2, l2)
    for a, b in zip(fa.plain_bwd_bf16(q, k, v, o, lse2, do, scale),
                    fa.plain_bwd_bf16(q, k, v, o, lse2, do, scale, True)):
        assert torch.equal(a, b)
    ints = torch.randint(-8, 8, (1, 2, 9, 16), generator=g).to(torch.bfloat16)
    assert torch.equal(fa.fma_chain_logits(ints, ints),
                       ints.float() @ ints.float().transpose(-1, -2))
