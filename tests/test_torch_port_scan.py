"""The port's scanned train step (``make_scanned_train_step``,
movae_tpu_torch/train/step.py) against k single steps and against the JAX
package's scanned step, with a non-finite batch inside a scan, and the
loop's single steps against the scan (movae_tpu_torch/train/loop.py).

A scan of k steps must give the numbers of k single steps bit for bit
(the same kernels in the same order). Against JAX the step locksteps'
tolerances hold (tests/test_torch_port_step.py): losses and weights
within 2e-4 relative (2e-5 absolute), parameters within 5e-4.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_torch_port_vqvae import build_pair, images  # noqa: E402

K, LR, EPS, EPOCHS = 3, 1e-3, 1e-4, 6


def _port(tm, agg, sched=None):
    from movae_tpu_torch.moo import AggregatorConfig, init_state
    from movae_tpu_torch.train.optim import build_optimizer, lr_schedule
    from movae_tpu_torch.train.state import TrainState
    from movae_tpu_torch.train.step import (make_scanned_train_step,
                                            make_train_step)

    cfg = AggregatorConfig(name=agg, num_objectives=len(tm.objective_names))
    tx = build_optimizer("adam", lr_schedule(LR, sched, EPOCHS, 1), eps=EPS)
    state = TrainState.create(tm, tx, init_state(cfg))
    step = make_train_step(tm, cfg, EPOCHS, 1)
    return state, step, make_scanned_train_step(step, K)


def _jax(jm, params, bstats, agg, sched=None):
    from movae_tpu.moo import AggregatorConfig, init_state
    from movae_tpu.train.optim import build_optimizer, lr_schedule
    from movae_tpu.train.state import TrainState
    from movae_tpu.train.step import make_scanned_train_step, make_train_step

    cfg = AggregatorConfig(name=agg, num_objectives=len(jm.objective_names))
    tx = build_optimizer("adam", lr_schedule(LR, sched, EPOCHS, 1), eps=EPS)
    state = TrainState.create(jm.apply, params, bstats, tx, init_state(cfg))
    raw = make_train_step(jm, cfg, EPOCHS, 1)
    return state, jax.jit(make_scanned_train_step(raw, K))


def _stack(seed, nan_at=None):
    xb = np.stack([images(seed + i) for i in range(K)])
    if nan_at is not None:
        xb[nan_at, 0, 0, 0, 0] = np.nan
    return xb


@pytest.mark.parametrize("agg,ema", [("upgrad", False), ("sum", True)])
def test_scan_equals_k_single_steps_bit_for_bit(agg, ema):
    kw = {"vq_ema": True} if ema else {}
    runs = []
    for scanned in (False, True):
        _, _, _, tm = build_pair(seed=31, **kw)
        state, step, scan = _port(tm, agg)
        gen = torch.Generator().manual_seed(2)
        xb = torch.tensor(_stack(60, nan_at=1))
        if scanned:
            state, mets = scan(state, xb, gen)
        else:
            per = [step(state, xb[i], gen)[1] for i in range(K)]
            mets = {k: torch.stack([torch.as_tensor(p[k]) for p in per])
                    for k in per[0]}
        runs.append((tm.state_dict(), mets, int(state.step),
                     gen.get_state()))
    (sd0, m0, s0, g0), (sd1, m1, s1, g1) = runs
    assert s0 == s1 == K - 1 and torch.equal(g0, g1)
    for k in sd0:
        assert torch.equal(sd0[k], sd1[k]), k
    assert m0.keys() == m1.keys()
    for k in m0:  # NaN where the NaN batch made it, in both
        assert m1[k].shape == (K,), k
        np.testing.assert_array_equal(m0[k].numpy(), m1[k].numpy(), k)
    assert m1["skipped_nonfinite"].tolist() == [0.0, 1.0, 0.0]


@pytest.mark.parametrize("agg", ["upgrad", "comfort"])
def test_scanned_step_locksteps_with_jax_across_a_nan_batch(agg):
    """Two scans of 3 steps, the first with a NaN batch in its middle, under
    a per-step cosine lr (one step an epoch) and, for comfort, a per-epoch
    beta: the skipped step moves neither the counter nor the lr nor beta on
    either side, so every later step agrees (tests/test_train_step.py:187,
    357 for the JAX package)."""
    jm, params, bstats, tm = build_pair(seed=32)
    jstate, jscan = _jax(jm, params, bstats, agg, "cosine")
    tstate, _, tscan = _port(tm, agg, "cosine")
    rng = jax.random.PRNGKey(4)
    m = len(jm.objective_names)
    for d, nan_at in enumerate((1, None)):
        xb = _stack(70 + 10 * d, nan_at)
        rng, sub = jax.random.split(rng)
        jstate, jmet = jscan(jstate, jnp.asarray(xb), sub)
        tstate, tmet = tscan(tstate, torch.tensor(xb))
        np.testing.assert_array_equal(tmet["skipped_nonfinite"].numpy(),
                                      np.asarray(jmet["skipped_nonfinite"]))
        for j in range(K):
            if nan_at == j:
                continue
            for key in ("total_loss", *jm.objective_names,
                        *(f"task_{i}_weight" for i in range(m))):
                np.testing.assert_allclose(
                    float(tmet[key][j]), float(jmet[key][j]), rtol=2e-4,
                    atol=2e-5, err_msg=f"{agg} dispatch {d} step {j} {key}")
        from movae_tpu.utils.torch_export import export_torch_state_dict

        ref = export_torch_state_dict(
            jax.tree_util.tree_map(np.asarray, jstate.params), {}, "vq_vae")
        got = tm.state_dict()
        delta = max(float(np.abs(np.asarray(v) - got[k].numpy()).max())
                    for k, v in ref.items())
        assert delta < 5e-4, f"{agg} dispatch {d}: {delta:.2e}"
    assert int(tstate.step) == int(jstate.step) == 2 * K - 1
    np.testing.assert_allclose(float(tstate.tx.lr(tstate.step)),
                               float(tstate.tx.lr(2 * K - 1)), rtol=0)


def test_scan_takes_exactly_k_batches():
    _, _, _, tm = build_pair(seed=33)
    state, _, scan = _port(tm, "sum")
    with pytest.raises(ValueError, match="3 batches"):
        scan(state, torch.tensor(np.stack([images(1)] * 2)))


def test_loop_groups_full_batches_for_the_scan():
    """train_epoch under --steps_per_dispatch runs every batch through the
    single step: on 34 images at batch 8 its 5 updates leave the weights
    of two scans of 2 full batches followed by the ragged tail's single
    step, bit for bit (the JAX loop's test_train_epoch_with_scan_dispatch
    makes the same 5 optimizer steps and 5 metric rows)."""
    from movae_tpu_torch.data import Loader, get_dataset
    from movae_tpu_torch.train import loop
    from movae_tpu_torch.train.step import make_scanned_train_step

    train_ds, _, _ = get_dataset("synthetic-32-34", None, False)
    sds = []
    for scanned in (False, True):
        _, _, _, tm = build_pair(seed=34)
        state, step, _ = _port(tm, "sum")
        loader = Loader(train_ds, 8, raw=True)
        if scanned:
            scan = make_scanned_train_step(step, 2)
            batches = [imgs[:nv] for imgs, _, nv in loader]
            for i in (0, 2):
                state, _ = scan(state, torch.as_tensor(
                    np.stack(batches[i:i + 2])))
            state, _ = step(state, torch.as_tensor(batches[4]))
        else:
            state, meters, n = loop.train_epoch(
                step, state, loader, torch.device("cpu"), None, 0, None,
                tm.objective_names)
            assert n == 5 and meters["total_loss"].count == 5
            assert np.isfinite(meters["total_loss"].avg)
        assert int(state.step) == 5
        sds.append({k: v.clone() for k, v in tm.state_dict().items()})
    for k, v in sds[0].items():
        assert torch.equal(v, sds[1][k]), k
