"""The port's accumulating train step (``make_train_step(...,
grad_accum=A)``, movae_tpu_torch/train/step.py) against the JAX package's
on the same weights and microbatches, its non-finite guard, and the loop's
optimizer-step arithmetic under ``--grad_accum`` (movae_tpu_torch/train/
loop.py, data/device.py) against the JAX loop's.

Adam runs with eps=1e-4 on both sides (tests/test_torch_port_step.py says
why). Tolerances are the step locksteps': losses and aggregator weights
within 2e-4 relative (2e-5 absolute), every parameter within 5e-4 of JAX's
after each update, BatchNorm running statistics within 5e-4; the Adam
moments within 1e-3 of the model's largest moment of their kind (the
moments are gradients averaged over two microbatches whose float32 sums
run in another order in the two frameworks; a conv bias ahead of a
BatchNorm has a gradient of float noise, ~1e-9, which only a model-wide
scale can hold).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import test_torch_port_vae as tv  # noqa: E402
from test_torch_port_vqvae import build_pair, images  # noqa: E402

A, UPDATES, LR, EPS = 2, 3, 1e-3, 1e-4
MOMENT_TOL = 1e-3


def _jax_accum(jm, params, bstats, agg, a=A):
    from movae_tpu.moo import AggregatorConfig, init_state
    from movae_tpu.train.optim import build_optimizer
    from movae_tpu.train.state import TrainState
    from movae_tpu.train.step import make_train_step

    cfg = AggregatorConfig(name=agg, num_objectives=len(jm.objective_names))
    state = TrainState.create(jm.apply, params, bstats,
                              build_optimizer("adam", LR, eps=EPS),
                              init_state(cfg))
    return state, jax.jit(make_train_step(jm, cfg, 1, UPDATES,
                                          grad_accum=a))


def _port_accum(tm, agg, a=A, **kw):
    from movae_tpu_torch.moo import AggregatorConfig, init_state
    from movae_tpu_torch.train.optim import build_optimizer
    from movae_tpu_torch.train.state import TrainState
    from movae_tpu_torch.train.step import make_train_step

    cfg = AggregatorConfig(name=agg, num_objectives=len(tm.objective_names))
    state = TrainState.create(tm, build_optimizer("adam", LR, eps=EPS),
                              init_state(cfg))
    return state, make_train_step(tm, cfg, 1, UPDATES, grad_accum=a, **kw)


def _adam_moments(opt_state):
    import optax

    def is_adam(x):
        return isinstance(x, optax.ScaleByAdamState)

    for s in jax.tree_util.tree_leaves(opt_state, is_leaf=is_adam):
        if is_adam(s):
            return s.mu, s.nu
    raise AssertionError("no Adam state")


def _check_moments(tstate, jstate, arch, export):
    names = {id(p): n for n, p in tstate.model.named_parameters()}
    for which, tree in zip(("exp_avg", "exp_avg_sq"),
                           _adam_moments(jstate.opt_state)):
        ref = export(jax.tree_util.tree_map(np.asarray, tree))
        scale = max(float(np.abs(np.asarray(ref[names[id(p)]])).max())
                    for p in tstate.params)
        for p in tstate.params:
            got = tstate.optimizer.state[p][which].numpy()
            want = np.asarray(ref[names[id(p)]])
            tol = MOMENT_TOL * scale
            np.testing.assert_allclose(got, want, rtol=0, atol=tol,
                                       err_msg=f"{arch} {which} "
                                               f"{names[id(p)]}")


def _vq_export(tree):
    from movae_tpu.utils.torch_export import export_torch_state_dict

    return export_torch_state_dict(tree, {}, "vq_vae")


def _stack(seed):
    return np.stack([images(seed + i) for i in range(A)])


@pytest.mark.parametrize("agg", ["sum", "upgrad", "mgda"])
def test_accum_step_locksteps_with_jax(agg):
    """3 accumulating updates of 2 microbatches on a tiny VQ-VAE: the
    microbatch-mean metrics, the parameters and the Adam moments after each
    update, and the step counter (one update per group)."""
    jm, params, bstats, tm = build_pair(seed=21)
    jstate, jstep = _jax_accum(jm, params, bstats, agg)
    tstate, tstep = _port_accum(tm, agg)
    rng = jax.random.PRNGKey(5)
    m = len(jm.objective_names)
    for i in range(UPDATES):
        xb = _stack(300 + 10 * i)
        rng, sub = jax.random.split(rng)
        jstate, jmet = jstep(jstate, jnp.asarray(xb), sub)
        tstate, tmet = tstep(tstate, torch.tensor(xb))
        for key in ("total_loss", *jm.objective_names,
                    *(f"task_{j}_weight" for j in range(m))):
            np.testing.assert_allclose(float(tmet[key]), float(jmet[key]),
                                       rtol=2e-4, atol=2e-5,
                                       err_msg=f"{agg} update {i} {key}")
        assert float(tmet["skipped_nonfinite"]) == 0.0
        ref = _vq_export(jax.tree_util.tree_map(np.asarray, jstate.params))
        got = tm.state_dict()
        delta = max(float(np.abs(np.asarray(v) - got[k].numpy()).max())
                    for k, v in ref.items())
        assert delta < 5e-4, f"{agg} update {i}: {delta:.2e}"
    _check_moments(tstate, jstate, "vq_vae", _vq_export)
    assert int(tstate.step) == int(jstate.step) == UPDATES


def test_accum_with_bn_vae_runs_statistics_sequentially(monkeypatch):
    """A BatchNorm VAE (sum): each microbatch's train-mode norms start from
    the previous microbatch's pending statistics, committed once; the N(0,
    I) draws of JAX's per-microbatch keys go to the port per microbatch."""
    jm, params, bstats, tm = tv.build_pair(seed=4, arch="vae")
    drawn = tv.spy_normal(monkeypatch)
    jstate, jstep = _jax_accum(jm, params, bstats, "sum")
    tstate, tstep = _port_accum(tm, "sum")
    rng = jax.random.PRNGKey(8)
    for i in range(UPDATES):
        xb = np.stack([tv.images(500 + 10 * i + j) for j in range(A)])
        rng, sub = jax.random.split(rng)
        start = len(drawn)
        jstate, jmet = jstep(jstate, jnp.asarray(xb), sub)
        jax.effects_barrier()
        assert len(drawn) - start == A
        noise = [{"eps": torch.tensor(drawn[start + j])} for j in range(A)]
        tstate, tmet = tstep(tstate, torch.tensor(xb), noise=noise)
        for key in ("total_loss", *jm.objective_names):
            np.testing.assert_allclose(float(tmet[key]), float(jmet[key]),
                                       rtol=2e-4, atol=2e-5,
                                       err_msg=f"update {i} {key}")
        ref = tv.state_dict_of("vae", tv.as_np(jstate.params),
                               tv.as_np(jstate.batch_stats))
        got = tm.state_dict()
        for k, v in ref.items():
            np.testing.assert_allclose(got[k].numpy(), v, rtol=0,
                                       atol=5e-4, err_msg=f"update {i} {k}")

    def export(tree):
        return tv.state_dict_of("vae", tree, tv.as_np(jstate.batch_stats))

    _check_moments(tstate, jstate, "vae", export)


def _snapshot(state):
    opt = state.optimizer.state_dict()["state"]
    return ({k: v.clone() for k, v in state.model.state_dict().items()},
            {i: {k: v.clone() for k, v in s.items()} for i, s in opt.items()},
            int(state.step), float(state.tx.lr(state.step)),
            {k: v.clone() for k, v in state.agg_state.items()})


def _assert_same(a, b):
    for k in a[0]:
        assert torch.equal(a[0][k], b[0][k]), k
    for i in a[1]:
        for k in a[1][i]:
            assert torch.equal(a[1][i][k], b[1][i][k]), (i, k)
    assert a[2:4] == b[2:4]
    for k in a[4]:
        assert torch.equal(a[4][k], b[4][k]), k


@pytest.mark.parametrize("agg,ema,bad", [("sum", False, 1),
                                         ("upgrad", True, 0),
                                         ("nashmtl", False, 1)])
def test_nan_microbatch_skips_the_whole_update(agg, ema, bad):
    """A NaN in one microbatch: the parameters, the moments, the step
    counter and the lr, the batch statistics (EMA codebook, advanced by the
    good microbatch on the way) and the aggregator state (NashMTL's) are
    exactly as before; the next group trains (tests/test_grad_accum.py:100
    for the JAX package)."""
    kw = {"vq_ema": True} if ema else {}
    _, _, _, tm = build_pair(seed=23, **kw)
    from movae_tpu_torch.train.optim import build_optimizer, lr_schedule
    state, step = _port_accum(tm, agg)
    state.tx = build_optimizer("adam", lr_schedule(LR, "cosine", 4, 1),
                               eps=EPS)
    gen = torch.Generator().manual_seed(0)
    state, met = step(state, torch.tensor(_stack(1)), gen)
    assert float(met["skipped_nonfinite"]) == 0.0
    before = _snapshot(state)
    xb = _stack(3)
    xb[bad, 0, 0, 0, 0] = np.nan
    state, met = step(state, torch.tensor(xb), gen)
    assert float(met["skipped_nonfinite"]) == 1.0
    _assert_same(before, _snapshot(state))
    state, met = step(state, torch.tensor(_stack(5)), gen)
    assert float(met["skipped_nonfinite"]) == 0.0 and int(state.step) == 2


def test_accum_equals_mean_of_single_updates_under_sgd():
    """Plain SGD: the accumulated update from p equals the mean of the A
    single updates from p (tests/test_grad_accum.py:64's oracle), within
    float32 rounding."""
    from movae_tpu_torch.moo import AggregatorConfig, init_state
    from movae_tpu_torch.train.optim import build_optimizer
    from movae_tpu_torch.train.state import TrainState
    from movae_tpu_torch.train.step import make_train_step

    xb = _stack(40)
    results = []
    for i in range(A):
        _, _, _, tm = build_pair(seed=24)
        cfg = AggregatorConfig(name="upgrad", num_objectives=3)
        st = TrainState.create(tm, build_optimizer("sgd", 1e-2, momentum=0.0),
                               init_state(cfg))
        make_train_step(tm, cfg)(st, torch.tensor(xb[i]))
        results.append({k: v.clone() for k, v in tm.state_dict().items()})
    _, _, _, tm = build_pair(seed=24)
    cfg = AggregatorConfig(name="upgrad", num_objectives=3)
    st = TrainState.create(tm, build_optimizer("sgd", 1e-2, momentum=0.0),
                           init_state(cfg))
    make_train_step(tm, cfg, grad_accum=A)(st, torch.tensor(xb))
    for k, v in tm.state_dict().items():
        want = 0.5 * (results[0][k] + results[1][k])
        np.testing.assert_allclose(v.numpy(), want.numpy(), rtol=2e-5,
                                   atol=2e-6, err_msg=k)


def test_accum_takes_exactly_a_microbatches():
    _, _, _, tm = build_pair(seed=25)
    state, step = _port_accum(tm, "sum")
    with pytest.raises(ValueError, match="2 microbatches"):
        step(state, torch.tensor(np.stack([images(1)] * 3)))


@pytest.mark.parametrize("n,bs,a", [(64, 16, 2), (70, 16, 3), (64, 16, 4),
                                    (50, 16, 1)])
def test_optimizer_steps_per_epoch_match_jax(n, bs, a):
    """The optimizer steps an epoch under --grad_accum, the lr schedule's
    and COMFORT's cadence: DeviceData's against the JAX DeviceData's, and
    the host loader's arithmetic of the port's run_training against the
    JAX run_training's (full batches in groups of A, leftovers and the
    ragged tail single)."""
    from movae_tpu.data.device import DeviceData as JDD
    from movae_tpu_torch.data.device import DeviceData

    for cls in (DeviceData, JDD):
        assert hasattr(cls, "optimizer_steps_per_epoch")
    dd = DeviceData.__new__(DeviceData)
    dd.n, dd.B, dd.steps = n, bs, n // bs
    jd = JDD.__new__(JDD)
    jd.n, jd.B, jd.steps = n, bs, n // bs
    assert dd.optimizer_steps_per_epoch(a) == jd.optimizer_steps_per_epoch(a)
    full, batches = n // bs, -(-n // bs)
    want = max(1, full // a + full % a + (batches - full)) if a > 1 \
        else batches
    assert dd.optimizer_steps_per_epoch(a) == want


@pytest.mark.parametrize("n_full,n_batches,a", [(5, 6, 2), (4, 4, 2),
                                                 (7, 8, 3), (3, 3, 1),
                                                 (1, 2, 2)])
def test_accum_groups_make_the_updates_optimizer_steps_counts(n_full,
                                                              n_batches, a):
    """The one grouping rule the loop, DeviceData and train_prior share:
    accum_groups yields every batch once, in order, in groups of A full
    batches or alone, and as many groups as optimizer_steps counts."""
    from movae_tpu_torch.train.step import accum_groups, optimizer_steps

    batches = [(i, i < n_full) for i in range(n_batches)]
    groups = list(accum_groups(iter(batches), a, lambda b: b[1]))
    assert [b for g in groups for b in g] == batches
    assert all(len(g) == 1 or (len(g) == a and all(f for _, f in g))
               for g in groups)
    assert len(groups) == optimizer_steps(n_full, n_batches, a)


def test_loop_groups_full_batches_and_runs_leftovers_single():
    """train_epoch on a host loader of 5 full batches and a ragged tail
    under A = 2: two accumulated updates, then the leftover full batch and
    the tail as single updates — 4 optimizer steps, 6 batches trained."""
    from movae_tpu_torch.train import loop

    calls = []

    def single(state, batch, gen):
        calls.append(("single", tuple(batch.shape)))
        return state, {"total_loss": torch.tensor(1.0)}

    def accum(state, batches, gen):
        calls.append(("accum", tuple(batches.shape)))
        return state, {"total_loss": torch.tensor(1.0)}

    class Loader:
        batch_size = 4

        def __iter__(self):
            for i in range(6):
                nv = 4 if i < 5 else 3
                yield np.zeros((4, 2, 2, 3), np.float32), None, nv

    _, _, step = loop.train_epoch(
        single, None, Loader(), torch.device("cpu"), None, 0, None,
        ("total_loss",), accum_fn=accum, accum_k=2)
    assert step == 4
    assert calls == [("accum", (2, 4, 2, 2, 3)), ("accum", (2, 4, 2, 2, 3)),
                     ("single", (4, 2, 2, 3)), ("single", (3, 2, 2, 3))]
