"""The port's data-parallel train step (movae_tpu_torch/parallel/mesh.py,
train/step.py, moo/engine.py) on 2 gloo ranks against the JAX package's
single-device step on the whole batch — the oracle of tests/test_parallel.py
(a data-parallel step equals the unsharded one) — and the prior stage
(train/prior.py) the same way.

The JAX side runs here; the port's ranks are spawned once for every case
(torch.multiprocessing, a FileStore rendezvous under tmp_path), each rank
taking its interleaved rows of the global batch (rows p, p + 2, ...; the
loaders' order) and the global draws (VAE noise, EMA restart rows) that the
JAX step made. Tolerances are test_parallel.py's: losses rtol 1e-5,
parameters rtol 1e-4 and atol 1e-6 (SGD with momentum 0.9, as the JAX test
steps SGD; float32 on the CPU, where no TF32 exists). The prior's 2 Adam
steps (eps 1e-4) are held to the same bounds against the port's own
single-process run, and to tests/test_prior_lockstep.py's against JAX.
"""

import os
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

LOSS_RTOL, PARAM_RTOL, PARAM_ATOL = 1e-5, 1e-4, 1e-6
WORLD, BATCH, STEPS, LR, MOMENTUM = 2, 8, 2, 1e-2, 0.9
VQ = dict(arch="vq_vae", embedding_dim=8, num_embeddings=32,
          hidden_dims=(8, 16), num_residual_layers=1)
# (case id, model args, aggregator, fsdp): vae's layer_norm "batch" is
# BatchNorm; cycle_vae has no feature seam (the full-Jacobian mode)
CASES = [
    ("vq_vae-sum", VQ, "sum", False),
    ("vq_vae-upgrad", VQ, "upgrad", False),
    ("vq_vae-mgda", VQ, "mgda", False),
    ("vq_ema-sum", dict(VQ, vq_ema=True), "sum", False),
    ("vae_batchnorm-upgrad", dict(arch="vae", layer_norm="batch"), "upgrad",
     False),
    ("betatc_vae-sum", dict(arch="betatc_vae", layer_norm="batch"), "sum",
     False),
    ("cycle_vae-upgrad", dict(arch="cycle_vae", layer_norm="batch"),
     "upgrad", False),
    ("fsdp-vae_batchnorm-upgrad", dict(arch="vae", layer_norm="batch"),
     "upgrad", True),
    ("fsdp-vq_vae-sum", VQ, "sum", True),
]


def spawn(fn, *args, world=WORLD):
    """Run ``fn(rank, world, store, *args)`` on ``world`` gloo ranks;
    returns the seconds from spawn to join."""
    import tempfile
    import time

    import torch.multiprocessing as mp

    store = tempfile.mktemp(prefix="movae_dp_store_")
    t0 = time.perf_counter()
    mp.spawn(fn, args=(world, store, *args), nprocs=world, join=True)
    if os.path.exists(store):
        os.remove(store)
    return time.perf_counter() - t0


def join_group(rank, world, store):
    torch.set_num_threads(1)
    from movae_tpu_torch.parallel import mesh

    mesh.init_distributed("cpu", init_method=f"file://{store}", rank=rank,
                          world_size=world)
    return mesh.DataParallel(mesh.make_mesh(device="cpu"))


def _port_model(model_args, state_dict):
    from movae_tpu_torch.models import get_network

    model = get_network(16, 3, model_args)
    model.load_state_dict(state_dict)
    return model


def _run_step_case(case, parallel):
    """The case's STEPS data-parallel steps on this rank; returns the
    metrics, the final state_dict and the optimizer's bytes at rest."""
    from movae_tpu_torch.moo import AggregatorConfig, init_state
    from movae_tpu_torch.parallel import mesh
    from movae_tpu_torch.parallel.mesh import DataParallel
    from movae_tpu_torch.train.optim import build_optimizer
    from movae_tpu_torch.train.state import TrainState
    from movae_tpu_torch.train.step import make_train_step

    model = _port_model(case["model_args"], case["state_dict"])
    dp = DataParallel(parallel.mesh, fsdp=case["fsdp"])
    cfg = AggregatorConfig(name=case["agg"],
                           num_objectives=len(model.objective_names))
    fsdp = dp.shard_params(model, min_elems=0) if case["fsdp"] else None
    state = TrainState.create(model, build_optimizer(
        "sgd", LR, momentum=MOMENTUM), init_state(cfg), fsdp=fsdp)
    step = make_train_step(model, cfg, 1, STEPS, parallel=dp)
    mets = []
    for i in range(STEPS):
        x = mesh.local_rows(torch.from_numpy(case["batches"][i]))
        rows = case["restart_rows"][i] if case["restart_rows"] else None
        noise = case["noise"][i] if case["noise"] else None
        state, met = step(state, x, restart_rows=rows, noise=noise)
        mets.append({k: float(v) for k, v in met.items()})
    rest = fsdp.rest_bytes(state.optimizer) if fsdp else None
    if fsdp is not None:
        fsdp.gather()
    sd = {k: v.detach().clone() for k, v in model.state_dict().items()}
    # the largest difference of any state entry from rank 0's
    spread = 0.0
    for v in sd.values():
        parts = mesh.all_gather(v.float().reshape(-1))
        spread = max(spread, float((parts[-1] - parts[0]).abs().max()))
    return {"metrics": mets, "state_dict": sd, "spread": spread,
            "rest": rest}


def _run_prior_case(case):
    from movae_tpu_torch.parallel import mesh
    from movae_tpu_torch.train.prior import build_prior, train_prior
    from movae_tpu_torch.utils import weights

    prior = build_prior(case["args"], case["K"], False, case["D"])
    weights.load_jax_prior_params(prior, case["init"])
    trace = []
    meta = types.SimpleNamespace(num_embeddings=case["K"],
                                 embedding_dim=case["D"])
    dp = mesh.DataParallel(mesh.make_mesh(device="cpu"), fsdp=case["fsdp"])
    out = train_prior(case["levels"], meta, case["args"], device="cpu",
                      step_trace=trace, prior=prior, parallel=dp)
    return {"trace": trace, "state_dict": {
        k: v.detach().clone() for k, v in out["model"].state_dict().items()}}


def _worker(rank, world, store, infile, outfile):
    parallel = join_group(rank, world, store)
    todo = torch.load(infile, weights_only=False)
    out = {name: _run_step_case(case, parallel)
           for name, case in todo["steps"].items()}
    out.update((name, _run_prior_case(case))
               for name, case in todo["priors"].items())
    if rank == 0:
        torch.save(out, outfile)
    torch.distributed.destroy_process_group()


# ---------------------------------------------------------------------------
# the JAX side
# ---------------------------------------------------------------------------

def _jax_case(name, model_args, agg, fsdp, mp_):
    """The JAX step on the whole batch, STEPS times, with its draws read
    for the port; returns (the port's inputs, the JAX outcome)."""
    import jax
    import jax.numpy as jnp
    from test_torch_port_ema import _spy_randint
    from test_torch_port_vae import DRAWS, spy_normal, take_noise

    from movae_tpu.models import get_network as jget, init_model as jinit
    from movae_tpu.moo import AggregatorConfig, init_state
    from movae_tpu.train.optim import build_optimizer
    from movae_tpu.train.state import TrainState
    from movae_tpu.train.step import make_train_step
    from movae_tpu_torch.models import get_network
    from movae_tpu_torch.utils import weights

    args = dict(dict(latent_dim=8, hidden_dims=(8, 16), batch_size=BATCH,
                     dataset_size=64, recons_objective="mse",
                     recons_activation="tanh"), **model_args)
    jm = jget(16, 3, args)
    params, bstats = jinit(jm, jax.random.PRNGKey(7), 16, 3)
    as_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    tm = get_network(16, 3, args)
    weights.load_jax_params(tm, as_np(params), as_np(bstats))
    init_sd = {k: v.clone() for k, v in tm.state_dict().items()}
    cfg = AggregatorConfig(name=agg, num_objectives=len(jm.objective_names))
    state = TrainState.create(jm.apply, params, bstats,
                              build_optimizer("sgd", LR, momentum=MOMENTUM),
                              init_state(cfg))
    step = jax.jit(make_train_step(jm, cfg, 1, STEPS))
    arch = args["arch"]
    normals = spy_normal(mp_) if arch in DRAWS else None
    ints = _spy_randint(mp_) if args.get("vq_ema") else None
    batches, noise, rows, mets = [], [], [], []
    rng = jax.random.PRNGKey(3)
    for i in range(STEPS):
        xb = np.random.default_rng(300 + i).uniform(
            -1, 1, (BATCH, 16, 16, 3)).astype(np.float32)
        rng, sub = jax.random.split(rng)
        start = len(normals) if normals is not None else 0
        state, met = step(state, jnp.asarray(xb), sub)
        jax.effects_barrier()
        batches.append(xb)
        if normals is not None:
            noise.append(take_noise(normals, start, arch))
        if ints is not None:
            rows.append({"vq_layer": torch.tensor(ints[-1])})
        mets.append({k: float(v) for k, v in met.items()})
    to_sd = {"vq_vae": weights.vqvae_state_dict,
             "betatc_vae": weights.betatc_state_dict}.get(
                 arch, weights.vae_state_dict)
    final = to_sd(as_np(state.params), as_np(state.batch_stats))
    port = {"model_args": args, "state_dict": init_sd, "agg": agg,
            "fsdp": fsdp, "batches": batches, "noise": noise,
            "restart_rows": rows}
    return port, {"metrics": mets, "state_dict": final,
                  "names": tuple(jm.objective_names)}


def _prior_cases(tmp_path):
    """The prior (PixelCNN, dropout 0, Adam eps 1e-4) for 2 steps: 16 code
    grids in batches of 8, one epoch, through JAX's train_prior, and the
    port's single-process run from the same init."""
    from test_torch_port_prior import D, K, make_codes, prior_args, run_jax

    from movae_tpu_torch.train.prior import build_prior, train_prior
    from movae_tpu_torch.utils import weights

    levels = {"codes": make_codes()["codes"][:16]}
    args = prior_args("pixelcnn", pixelcnn_epochs=1)
    init, j_trace, _, j_final = run_jax("pixelcnn", levels, tmp_path,
                                        pixelcnn_epochs=1)
    prior = build_prior(args, K, False, D)
    weights.load_jax_prior_params(prior, init)
    one = []
    train_prior(levels, types.SimpleNamespace(num_embeddings=K,
                                              embedding_dim=D), args,
                device="cpu", step_trace=one, prior=prior)
    port = {"args": args, "K": K, "D": D, "init": init, "levels": levels}
    want = {"trace": j_trace, "state_dict": weights.pixelcnn_state_dict(
        j_final), "single_trace": one, "single_state_dict": {
        k: v.detach().clone() for k, v in prior.state_dict().items()}}
    return ({"prior-pixelcnn": dict(port, fsdp=False),
             "prior-pixelcnn-fsdp": dict(port, fsdp=True)},
            {"prior-pixelcnn": want, "prior-pixelcnn-fsdp": want})


@pytest.fixture(scope="module")
def dp_runs(tmp_path_factory):
    """Every case through JAX here and through the port's 2 gloo ranks in
    one spawn; ``{case: (port outcome, JAX outcome)}`` and the spawn's
    seconds."""
    tmp = tmp_path_factory.mktemp("dp")
    steps, want = {}, {}
    with pytest.MonkeyPatch.context() as mp_:
        for name, model_args, agg, fsdp in CASES:
            steps[name], want[name] = _jax_case(name, model_args, agg, fsdp,
                                                mp_)
    priors, prior_want = _prior_cases(tmp)
    want.update(prior_want)
    infile, outfile = tmp / "in.pt", tmp / "out.pt"
    torch.save({"steps": steps, "priors": priors}, infile)
    seconds = spawn(_worker, str(infile), str(outfile))
    got = torch.load(outfile, weights_only=False)
    print(f"2-rank gloo spawn, {len(got)} cases, join: {seconds:.1f} s")
    return {name: (got[name], want[name]) for name in want}


def _assert_state_close(got, want, label):
    assert set(got) >= set(want), set(want) - set(got)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), np.asarray(v),
                                   rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                   err_msg=f"{label}: {k}")


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_data_parallel_step_equals_jax_single_device(name, dp_runs):
    """2 ranks, each on its rows of the global batch, equal JAX's step on
    the whole batch: losses, aggregator weights, codebook usage,
    parameters and batch statistics (BatchNorm's running statistics,
    the EMA codebook), and every rank holds the same state."""
    got, want = dp_runs[name]
    for i, (gm, wm) in enumerate(zip(got["metrics"], want["metrics"])):
        for key in ("total_loss", *want["names"]):
            np.testing.assert_allclose(gm[key], wm[key], rtol=LOSS_RTOL,
                                       err_msg=f"{name} step {i} {key}")
        for j in range(len(want["names"])):
            np.testing.assert_allclose(gm[f"task_{j}_weight"],
                                       wm[f"task_{j}_weight"], rtol=1e-4,
                                       atol=1e-6, err_msg=f"{name} step {i}")
        if "codebook_usage_percentage" in wm:
            assert gm["codebook_usage_percentage"] == pytest.approx(
                wm["codebook_usage_percentage"])
        assert gm["skipped_nonfinite"] == 0.0
    _assert_state_close(got["state_dict"], want["state_dict"], name)
    assert got["spread"] == 0.0, f"{name}: ranks differ by {got['spread']}"
    if name.startswith("fsdp"):
        # at rest each rank holds about half of the momentum buffers
        full = sum(np.asarray(v).size * 4
                   for k, v in want["state_dict"].items()
                   if "running" not in k and "num_batches" not in k)
        assert got["rest"]["moments"] < 0.75 * full, got["rest"]


@pytest.mark.parametrize("name", ["prior-pixelcnn", "prior-pixelcnn-fsdp"])
def test_data_parallel_prior_equals_single_process_and_jax(name, dp_runs):
    """train_prior for 2 steps on 2 ranks (fsdp too): the CE and the
    weights of the port's one-process run at test_parallel.py's bounds, and
    JAX's train_prior at tests/test_prior_lockstep.py's (CE 1e-4
    relative, weights 1e-3)."""
    got, want = dp_runs[name]
    assert len(got["trace"]) == len(want["trace"]) == 2
    np.testing.assert_allclose(got["trace"], want["single_trace"],
                               rtol=LOSS_RTOL)
    _assert_state_close(got["state_dict"], want["single_state_dict"], name)
    np.testing.assert_allclose(got["trace"], want["trace"], rtol=1e-4)
    for k, v in want["state_dict"].items():
        np.testing.assert_allclose(got["state_dict"][k].numpy(), v, rtol=0,
                                   atol=1e-3, err_msg=f"{name}: {k}")
