"""``remat`` in the port's train step (``torch.utils.checkpoint`` around
the region the JAX package rematerializes: the whole
``forward_with_losses`` in the sum and full modes, the trunk in feature
mode) against the same step without it.

The forward has side effects that a recompute must not repeat: draws from
the explicit generator (the VAE family's noise, the EMA codebook's
dead-code restart rows) and the train-mode norms' pending statistics.
The recompute runs the same ops on the same inputs in the same order, so
the step is held bit for bit: parameters, optimizer moments, running
statistics, EMA codebooks, losses, and the generator's state after the
step (the same draws consumed). tests/test_train_step.py:222 holds the
JAX package's remat to its non-remat step the same way (there within
1e-5, XLA fusing the two programs differently).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import test_torch_port_vae as tv  # noqa: E402
from test_torch_port_vqvae import build_pair, images  # noqa: E402

STEPS = 3


def _run(tm, agg, remat, batches, seed=5):
    from movae_tpu_torch.moo import AggregatorConfig, init_state
    from movae_tpu_torch.train.optim import build_optimizer
    from movae_tpu_torch.train.state import TrainState
    from movae_tpu_torch.train.step import make_train_step

    cfg = AggregatorConfig(name=agg, num_objectives=len(tm.objective_names))
    state = TrainState.create(tm, build_optimizer("adam", 1e-3, eps=1e-4),
                              init_state(cfg))
    step = make_train_step(tm, cfg, 1, STEPS, remat=remat)
    gen = torch.Generator().manual_seed(seed)
    mets = []
    for xb in batches:
        state, met = step(state, torch.tensor(xb), gen)
        mets.append({k: float(v) for k, v in met.items()})
    opt = {i: {k: v.clone() for k, v in s.items()}
           for i, s in state.optimizer.state_dict()["state"].items()}
    return ({k: v.clone() for k, v in tm.state_dict().items()}, opt, mets,
            gen.get_state())


def _assert_identical(a, b):
    (sd0, opt0, m0, g0), (sd1, opt1, m1, g1) = a, b
    assert torch.equal(g0, g1), "the recompute drew from the generator"
    for k in sd0:
        assert torch.equal(sd0[k], sd1[k]), k
    for i in opt0:
        for k in opt0[i]:
            assert torch.equal(opt0[i][k], opt1[i][k]), (i, k)
    assert m0 == m1


@pytest.mark.parametrize("agg", ["sum", "upgrad"])
def test_remat_vq_ema_restarts_are_drawn_once(agg):
    """vq_vae with the EMA codebook, whose dead codes restart from rows
    drawn from the generator (sum: the whole forward under checkpoint;
    upgrad: feature mode, the trunk under checkpoint)."""
    batches = [images(80 + i) for i in range(STEPS)]
    runs = []
    for remat in (False, True):
        _, _, _, tm = build_pair(seed=41, vq_ema=True)
        runs.append(_run(tm, agg, remat, batches))
    _assert_identical(*runs)


@pytest.mark.parametrize("arch,agg,mode", [
    ("vae", "sum", "sum"), ("vae", "upgrad", "feature"),
    ("cycle_vae", "mgda", "full")])
def test_remat_bn_vae_with_generator_noise(arch, agg, mode):
    """BatchNorm VAEs whose N(0, I) draws come from the generator: the
    pending running statistics are written once and the noise is drawn
    once, in the sum, feature and full (cycle_vae: two encoder passes,
    two draws) modes."""
    batches = [tv.images(90 + i) for i in range(STEPS)]
    runs = []
    for remat in (False, True):
        _, _, _, tm = tv.build_pair(seed=42, arch=arch)
        runs.append(_run(tm, agg, remat, batches))
    _assert_identical(*runs)


def test_remat_keeps_the_checkpointed_region_out_of_the_graph(monkeypatch):
    """With remat the forward runs twice (forward, then the recompute in
    the backward), the generator draws once; without it once."""
    from movae_tpu_torch.models import vae as vae_mod

    calls = []
    real = vae_mod.VAE.forward

    def counted(self, *a, **kw):
        calls.append(1)
        return real(self, *a, **kw)

    monkeypatch.setattr(vae_mod.VAE, "forward", counted)
    for remat, want in ((False, 1), (True, 2)):
        calls.clear()
        _, _, _, tm = tv.build_pair(seed=43, arch="vae")
        _run(tm, "sum", remat, [tv.images(95)])
        assert len(calls) == want, (remat, calls)
