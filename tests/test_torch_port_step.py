"""Port train step (movae_tpu_torch/train) against the JAX train step
(movae_tpu/train) from one init on one batch stream, plus the non-finite
guard, the optimizers, and the port's import hygiene.

Adam runs with eps=1e-4 on both sides, for the reason in
tests/test_torch_lockstep.py: at 1e-8 a gradient below float32
cross-framework noise takes a full +-lr step.
"""

import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_torch_port_vqvae import build_pair, images  # noqa: E402

STEPS = 6
LR = 1e-3
EPS = 1e-4


def _jax_state(jm, params, bstats, agg):
    from movae_tpu.moo import AggregatorConfig, init_state
    from movae_tpu.train.optim import build_optimizer
    from movae_tpu.train.state import TrainState
    from movae_tpu.train.step import make_train_step

    cfg = AggregatorConfig(name=agg, num_objectives=len(jm.objective_names))
    state = TrainState.create(jm.apply, params, bstats,
                              build_optimizer("adam", LR, eps=EPS),
                              init_state(cfg))
    return state, jax.jit(make_train_step(jm, cfg, 1, STEPS))


def _port_state(tm, agg, **step_kw):
    from movae_tpu_torch.moo import AggregatorConfig, init_state
    from movae_tpu_torch.train.optim import build_optimizer
    from movae_tpu_torch.train.state import TrainState
    from movae_tpu_torch.train.step import make_train_step

    cfg = AggregatorConfig(name=agg, num_objectives=len(tm.objective_names))
    state = TrainState.create(tm, build_optimizer("adam", LR, eps=EPS),
                              init_state(cfg))
    return state, make_train_step(tm, cfg, 1, STEPS, **step_kw)


def _param_delta(jparams, tm):
    from movae_tpu.utils.torch_export import export_torch_state_dict

    ref = export_torch_state_dict(jparams, {}, "vq_vae")
    got = tm.state_dict()
    return max(float(np.max(np.abs(np.asarray(v) - got[k].numpy())))
               for k, v in ref.items())


@pytest.mark.parametrize("agg", ["sum", "upgrad"])
def test_train_lockstep_matches_jax(agg):
    jm, params, bstats, tm = build_pair(seed=11)
    jstate, jstep = _jax_state(jm, params, bstats, agg)
    tstate, tstep = _port_state(tm, agg)
    rng = jax.random.PRNGKey(3)
    for i in range(STEPS):
        xb = images(100 + i)
        rng, sub = jax.random.split(rng)
        jstate, jmet = jstep(jstate, jnp.asarray(xb), sub)
        tstate, tmet = tstep(tstate, torch.tensor(xb))
        for key in ("total_loss", *jm.objective_names):
            np.testing.assert_allclose(float(tmet[key]), float(jmet[key]),
                                       rtol=2e-4, atol=2e-5,
                                       err_msg=f"step {i} {key} ({agg})")
        for j in range(len(jm.objective_names)):
            np.testing.assert_allclose(float(tmet[f"task_{j}_weight"]),
                                       float(jmet[f"task_{j}_weight"]),
                                       rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(
            float(tmet["codebook_usage_percentage"]),
            float(jmet["codebook_usage_percentage"]))
        assert float(tmet["skipped_nonfinite"]) == 0.0
        delta = _param_delta(jstate.params, tm)
        assert delta < 5e-4, f"step {i}: max param divergence {delta:.2e}"
    assert tstate.step == int(jstate.step) == STEPS


def _snapshot(state):
    opt = state.optimizer.state_dict()
    return {
        "model": {k: v.clone() for k, v in state.model.state_dict().items()},
        "opt": {i: {k: (v.clone() if torch.is_tensor(v) else v)
                    for k, v in s.items()} for i, s in opt["state"].items()},
        "step": state.step,
        "agg": dict(state.agg_state),
    }


def _assert_identical(a, b):
    assert a["step"] == b["step"] and a["agg"].keys() == b["agg"].keys()
    for k in a["model"]:
        assert torch.equal(a["model"][k], b["model"][k]), k
    assert a["opt"].keys() == b["opt"].keys()
    for i in a["opt"]:
        for k, v in a["opt"][i].items():
            w = b["opt"][i][k]
            assert (torch.equal(v, w) if torch.is_tensor(v) else v == w), k


@pytest.mark.parametrize("agg,ema", [("sum", False), ("upgrad", False),
                                     ("upgrad", True)])
def test_nonfinite_batch_leaves_state_bit_identical(agg, ema):
    kw = {"vq_ema": True} if ema else {}
    _, _, _, tm = build_pair(seed=12, **kw)
    state, step = _port_state(tm, agg)
    gen = torch.Generator().manual_seed(0)
    state, met = step(state, torch.tensor(images(1)), gen)  # moments exist
    assert float(met["skipped_nonfinite"]) == 0.0
    before = _snapshot(state)
    bad = images(2)
    bad[0, 0, 0, 0] = np.nan
    state, met = step(state, torch.tensor(bad), gen)
    assert float(met["skipped_nonfinite"]) == 1.0
    _assert_identical(before, _snapshot(state))
    # and the next good step still trains
    state, met = step(state, torch.tensor(images(3)), gen)
    assert float(met["skipped_nonfinite"]) == 0.0 and state.step == 2


def test_ema_step_commits_batch_stats():
    _, _, _, tm = build_pair(seed=13, vq_ema=True)
    state, step = _port_state(tm, "sum")
    before = {k: v.clone() for k, v in tm.batch_stats().items()}
    step(state, torch.tensor(images(4)), torch.Generator().manual_seed(0))
    after = tm.batch_stats()
    assert set(after) == {"vq_layer.embedding.weight",
                          "vq_layer.cluster_size", "vq_layer.ema_embed"}
    assert all(not torch.equal(before[k], after[k]) for k in after)


def test_preprocess_and_codebook_usage_match_jax():
    from movae_tpu.train import step as jstep
    from movae_tpu_torch.train import step as tstep

    u8 = np.random.default_rng(5).integers(0, 256, (2, 4, 4, 3),
                                           dtype=np.uint8)
    for normalize in (False, True):
        np.testing.assert_allclose(
            tstep.preprocess_batch(torch.tensor(u8), normalize).numpy(),
            np.asarray(jstep.preprocess_batch(jnp.asarray(u8), normalize)),
            rtol=0, atol=0)
    f = torch.tensor(images(6))
    assert tstep.preprocess_batch(f, True) is f  # float batches pass through
    inds = np.random.default_rng(6).integers(0, 32, (40,)).astype(np.int32)
    for out in ({"encoding_inds": inds},
                {"encoding_inds_top": inds, "encoding_inds_bottom": inds[:7]}):
        np.testing.assert_allclose(
            float(tstep._codebook_usage(
                {k: torch.tensor(v) for k, v in out.items()}, 32)),
            float(jstep._codebook_usage(
                {k: jnp.asarray(v) for k, v in out.items()}, 32)),
            rtol=1e-6)


@pytest.mark.parametrize("name,kw", [
    ("adam", dict(weight_decay=0.01)), ("sgd", dict(weight_decay=0.01)),
    ("sgd", dict(momentum=0.0)), ("adamw", dict(weight_decay=0.05)),
    ("rmsprop", dict(max_grad_norm=0.5)), ("adam", dict(max_grad_norm=0.1))])
def test_optimizers_match_optax(name, kw):
    import optax

    from movae_tpu.train.optim import build_optimizer as jbuild
    from movae_tpu.train.optim import lr_schedule as jsched
    from movae_tpu_torch.train.optim import build_optimizer, lr_schedule

    rng = np.random.default_rng(7)
    p0 = rng.normal(size=(5, 3)).astype(np.float32)
    grads = [rng.normal(size=p0.shape).astype(np.float32) for _ in range(4)]
    jtx = jbuild(name, jsched(0.1, "cosine", 2, 2), eps=EPS, **kw)
    jp = jnp.asarray(p0)
    jopt = jtx.init(jp)
    tx = build_optimizer(name, lr_schedule(0.1, "cosine", 2, 2), eps=EPS,
                         **kw)
    tp = torch.nn.Parameter(torch.tensor(p0))
    topt = tx.init([tp])
    for step, g in enumerate(grads):
        upd, jopt = jtx.update(jnp.asarray(g), jopt, jp)
        jp = optax.apply_updates(jp, upd)
        tp.grad = torch.tensor(g)
        tx.step(topt, step)
        # optax keeps Adam's bias corrections in float32: at lr 0.1 it sits
        # up to 3e-6 from a float64 Adam after 4 steps (torch: 1e-7)
        np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp),
                                   rtol=1e-5, atol=1e-5,
                                   err_msg=f"{name} {kw} step {step}")


@pytest.mark.parametrize("sched,kw", [
    (None, {}), ("cosine", dict(lr_min=1e-4)),
    ("multi_step", dict(milestones=[1, 3])), ("exponential", dict(gamma=0.5))])
def test_lr_schedules_match_jax(sched, kw):
    from movae_tpu.train.optim import lr_schedule as jsched
    from movae_tpu_torch.train.optim import lr_schedule

    jfn = jsched(0.1, sched, 4, 3, **kw)
    tfn = lr_schedule(0.1, sched, 4, 3, **kw)
    for step in range(15):
        np.testing.assert_allclose(tfn(step), float(jfn(step)), rtol=1e-6)


def test_port_imports_neither_jax_nor_movae_tpu():
    """Every movae_tpu_torch module imports without JAX or movae_tpu."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import movae_tpu_torch\n"
        "for m in pkgutil.walk_packages(movae_tpu_torch.__path__,\n"
        "                               'movae_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules\n"
        "             if n.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax',\n"
        "                                    'movae_tpu'))\n"
        "assert not bad, bad\n"
        "print(len([n for n in sys.modules\n"
        "           if n.startswith('movae_tpu_torch')]))\n")
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 52
