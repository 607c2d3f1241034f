"""The EMA codebook's training step (``vq_ema=True``) in lockstep with the
JAX step, for ``vq_vae`` and ``vq_vae2``.

At init every code is dead (cluster size 0 < 0.01), so each step's
dead-code restart decides the codebook. JAX draws the restart rows from its
``sample`` stream (``movae_tpu/models/vq_vae.py:apply_ema``); torch cannot
reproduce that draw, so the test reads the rows JAX drew on each step
(``jax.random.randint`` wrapped for the test's duration, the rows passed
out by an ordered debug callback) and gives the port the same table through
``train_step(..., restart_rows=...)``.

Tolerances are those of tests/test_torch_port_step.py: losses within 2e-4
relative (2e-5 absolute), codebook usage exactly, parameters within 5e-4;
the codebook and its EMA statistics within 5e-4 absolute after every step.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import test_torch_port_vqvae as v1  # noqa: E402
import test_torch_port_vqvae2 as v2  # noqa: E402

STEPS, LR, EPS = 6, 1e-3, 1e-4
STAT_TOL = 5e-4

# (harness module, arch, {port codebook module: flax codebook scope}) in
# the order the JAX step draws their restart rows
CASES = {
    "vq_vae": (v1, {"vq_layer": "vq"}),
    "vq_vae2": (v2, {"quantize_t": "vq_top", "quantize_b": "vq_bottom"}),
}


def _jax_step(jm, params, bstats):
    from movae_tpu.moo import AggregatorConfig, init_state
    from movae_tpu.train.optim import build_optimizer
    from movae_tpu.train.state import TrainState
    from movae_tpu.train.step import make_train_step

    cfg = AggregatorConfig(name="sum", num_objectives=len(jm.objective_names))
    state = TrainState.create(jm.apply, params, bstats,
                              build_optimizer("adam", LR, eps=EPS),
                              init_state(cfg))
    return state, jax.jit(make_train_step(jm, cfg, 1, STEPS))


def _port_step(tm):
    from movae_tpu_torch.moo import AggregatorConfig, init_state
    from movae_tpu_torch.train.optim import build_optimizer
    from movae_tpu_torch.train.state import TrainState
    from movae_tpu_torch.train.step import make_train_step

    cfg = AggregatorConfig(name="sum", num_objectives=len(tm.objective_names))
    state = TrainState.create(tm, build_optimizer("adam", LR, eps=EPS),
                              init_state(cfg))
    return state, make_train_step(tm, cfg, 1, STEPS)


def _spy_randint(monkeypatch):
    """Wrap ``jax.random.randint`` so every draw inside the jitted step is
    also handed to the host, in program order."""
    drawn = []
    orig = jax.random.randint

    def randint(key, shape, minval, maxval, *args, **kw):
        rows = orig(key, shape, minval, maxval, *args, **kw)
        jax.debug.callback(lambda r: drawn.append(np.asarray(r)), rows,
                           ordered=True)
        return rows

    monkeypatch.setattr(jax.random, "randint", randint)
    return drawn


@pytest.mark.parametrize("arch", list(CASES))
def test_ema_train_lockstep_matches_jax(arch, monkeypatch):
    from movae_tpu_torch.utils import weights

    to_state_dict = {"vq_vae": weights.vqvae_state_dict,
                     "vq_vae2": weights.vqvae2_state_dict}
    harness, books = CASES[arch]
    drawn = _spy_randint(monkeypatch)
    jm, params, bstats, tm = harness.build_pair(seed=21, vq_ema=True)
    jstate, jstep = _jax_step(jm, params, bstats)
    tstate, tstep = _port_step(tm)
    rng = jax.random.PRNGKey(4)
    restarted = 0
    for i in range(STEPS):
        xb = harness.images(200 + i)
        rng, sub = jax.random.split(rng)
        jstate, jmet = jstep(jstate, jnp.asarray(xb), sub)
        jax.effects_barrier()
        assert len(drawn) == len(books) * (i + 1), len(drawn)
        rows = dict(zip(books, drawn[-len(books):]))
        tstate, tmet = tstep(tstate, torch.tensor(xb), restart_rows={
            name: torch.tensor(r) for name, r in rows.items()})
        for key in ("total_loss", *jm.objective_names):
            np.testing.assert_allclose(float(tmet[key]), float(jmet[key]),
                                       rtol=2e-4, atol=2e-5,
                                       err_msg=f"{arch} step {i} {key}")
        np.testing.assert_allclose(
            float(tmet["codebook_usage_percentage"]),
            float(jmet["codebook_usage_percentage"]),
            err_msg=f"{arch} step {i}")
        assert float(tmet["skipped_nonfinite"]) == 0.0
        stats = tm.batch_stats()
        for name, scope in books.items():
            jb = jstate.batch_stats[scope]
            for tkey, jkey in (("embedding.weight", "embedding"),
                               ("cluster_size", "cluster_size"),
                               ("ema_embed", "ema_embed")):
                got = stats[f"{name}.{tkey}"].numpy()
                np.testing.assert_allclose(
                    got, np.asarray(jb[jkey]), rtol=0, atol=STAT_TOL,
                    err_msg=f"{arch} step {i} {name}.{tkey}")
            restarted += int((stats[f"{name}.cluster_size"] == 1.0).sum())
        # the JAX state through the port's own mapping (held bit for bit
        # against the JAX exporter), EMA codebooks from batch_stats
        ref = to_state_dict[arch](
            jax.tree_util.tree_map(np.asarray, jstate.params),
            jax.tree_util.tree_map(np.asarray, jstate.batch_stats))
        got = tm.state_dict()
        delta = max(float(np.max(np.abs(np.asarray(v) - got[k].numpy())))
                    for k, v in ref.items())
        assert delta < 5e-4, f"{arch} step {i}: param divergence {delta:.2e}"
    # the restart really ran: dead codes were re-seeded from the given rows
    assert restarted > 0
    assert tstate.step == int(jstate.step) == STEPS


def test_restart_rows_replace_the_draw_and_are_checked():
    from movae_tpu_torch.models.vq_vae import Codebook

    book = Codebook(4, 2, ema=True)
    book.reset_parameters(torch.Generator().manual_seed(0))
    z = torch.arange(10.0).reshape(5, 2)
    inds = torch.zeros(5, dtype=torch.int32)
    out = book.ema_update(z, inds, restart_rows=torch.tensor([4, 3, 2, 1]))
    # code 0 has 5 assignments (EMA count 0.05): kept; codes 1-3 are dead
    # and restart from rows 3, 2, 1 of z
    np.testing.assert_array_equal(out["embedding.weight"][1:].numpy(),
                                  z[[3, 2, 1]].numpy())
    np.testing.assert_array_equal(out["cluster_size"][1:].numpy(), 1.0)
    with pytest.raises(ValueError, match="restart_rows"):
        book.ema_update(z, inds, restart_rows=torch.tensor([0, 1]))
