"""Tensor parallelism over the 'model' axis (movae_tpu_torch/parallel/
tensor.py, --model_partitions) against the JAX package: the split rule
leaf for leaf against movae_tpu/parallel/mesh.py:DataParallel.
param_shardings through load_jax_params's key map, and train steps on a
data 2 x model 2 mesh of 4 gloo ranks against JAX's one-device step on
the whole batch — the oracle of tests/test_parallel.py
(test_dp_tp_train_step_matches_single_device: loss rtol 1e-5, parameters
rtol 1e-4 / atol 1e-6) — for the VAE in full mode (upgrad), the VQ-VAE's
sum and feature modes (its codebook a split table, gathered before use),
fsdp composed with tp (test_fsdp_composes_with_tp), a checkpoint round
trip in the reference layout, and `movae_tpu_torch.main --model_partitions
4` (every rank a model rank: the data axis's own summation order, which
over a whole CLI run moves weights by ~4e-5, stays out) against the
one-process CLI.

The ranks are spawned once for every case (tests/test_torch_port_parallel.
py's spawn, a FileStore rendezvous).
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_port_parallel import (  # noqa: E402
    LOSS_RTOL, STEPS, VQ, _assert_state_close, _jax_case, _port_model,
    spawn)

WORLD, DATA, MODEL = 4, 2, 2
LR, MOMENTUM = 1e-2, 0.9
VAE = dict(arch="vae", layer_norm="none", hidden_dims=(8,))
# (case id, model args, aggregator, fsdp)
CASES = [
    ("vae-upgrad", VAE, "upgrad", False),
    ("vq_vae-sum", VQ, "sum", False),
    ("vq_vae-upgrad", VQ, "upgrad", False),
    ("fsdp-vae-upgrad", VAE, "upgrad", True),
]
CLI = ["--device", "cpu", "--dataset", "synthetic-32-64", "--arch", "vq_vae",
       "--hidden_dims", "32", "64", "--embedding_dim", "8",
       "--num_embeddings", "16", "--batch_size", "16", "--epochs", "1",
       "--optimizer", "sgd", "--lr", "0.01", "--aggregator", "upgrad",
       "--seed", "1", "--skip_pixelcnn", "--skip_final_metrics",
       "--normalize_inputs"]


# ---------------------------------------------------------------------------
# the rule, leaf for leaf
# ---------------------------------------------------------------------------

def _marked(params):
    """Each flax leaf as ``leaf id * 1000 + index along its last axis``
    (the axis the JAX rule splits)."""
    import jax

    leaves, treedef = jax.tree_util.tree_flatten(params)
    marked = []
    for i, leaf in enumerate(leaves):
        shape = np.shape(leaf)
        idx = np.arange(shape[-1]) if shape else np.zeros(())
        marked.append((1000.0 * (i + 1) + np.broadcast_to(idx, shape))
                      .astype(np.float64))
    return jax.tree_util.tree_unflatten(treedef, marked), leaves


@pytest.mark.parametrize("arch,min_elems", [
    ("vae", 0), ("vq_vae", 0), ("vq_vae", 4096), ("vq_vae2", 0)])
def test_split_rule_is_jax_param_shardings_leaf_for_leaf(arch, min_elems):
    """The port splits a parameter over 'model' exactly where JAX's rule
    puts 'model' on its flax leaf, and on the dimension that leaf's last
    (output) axis maps to: dim 0 of a Conv2d/Linear weight, dim 1 of a
    ConvTranspose2d weight, the last dim of a table."""
    import jax

    from movae_tpu.models import get_network as jget, init_model as jinit
    from movae_tpu.parallel.mesh import DataParallel as JDP, make_mesh
    from movae_tpu_torch.models import get_network
    from movae_tpu_torch.parallel.tensor import model_shardings
    from movae_tpu_torch.utils import weights

    args = dict(arch=arch, latent_dim=8, hidden_dims=(32, 64),
                embedding_dim=8, num_embeddings=32, num_residual_layers=1,
                batch_size=8, dataset_size=64, layer_norm="none")
    jm = jget(16, 3, args)
    params, _ = jinit(jm, jax.random.PRNGKey(0), 16, 3, batch_size=2)
    jdp = JDP(make_mesh(num_data=4, num_model=MODEL,
                        devices=jax.devices()[:8]))
    specs = jax.tree_util.tree_leaves(
        jdp.param_shardings(params, min_elems=min_elems),
        is_leaf=lambda s: hasattr(s, "spec"))
    marked, leaves = _marked(params)
    to_sd = {"vq_vae": weights.vqvae_state_dict,
             "vq_vae2": weights.vqvae2_state_dict}.get(arch,
                                                       weights.vae_state_dict)
    tm = get_network(16, 3, args)
    state = to_sd(jax.tree_util.tree_map(np.asarray, marked))
    rule = model_shardings(tm, MODEL, min_elems)
    assert rule, arch
    n_split = 0
    for key, dim in rule.items():
        t = np.asarray(state[key])
        leaf = int(t.flat[0] // 1000) - 1
        spec = tuple(getattr(specs[leaf], "spec", ()))
        want = len(spec) == np.ndim(leaves[leaf]) and spec[-1] == "model"
        assert (dim is not None) == want, (key, dim, spec)
        if dim is None:
            continue
        n_split += 1
        # the leaf's last flax axis varies along `dim` alone
        for e in range(t.ndim):
            spread = np.ptp(t, axis=e).max() if t.shape[e] > 1 else 0.0
            assert (spread > 0) == (e == dim), (key, e, dim)
    assert n_split > 0


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------

def _run_tp_case(case):
    """STEPS steps on this rank of the data x model mesh; returns the
    metrics, the whole state_dict and the optimizer's bytes at rest."""
    from movae_tpu_torch.moo import AggregatorConfig, init_state
    from movae_tpu_torch.parallel import mesh
    from movae_tpu_torch.parallel.tensor import TensorParallel
    from movae_tpu_torch.train.optim import build_optimizer
    from movae_tpu_torch.train.state import TrainState
    from movae_tpu_torch.train.step import make_train_step

    msh = mesh.make_mesh(num_data=DATA, num_model=MODEL, device="cpu")
    with mesh.using(msh):
        model = _port_model(case["model_args"], case["state_dict"])
        dp = mesh.DataParallel(msh, fsdp=case["fsdp"])
        cfg = AggregatorConfig(name=case["agg"],
                               num_objectives=len(model.objective_names))
        tp = TensorParallel(model, min_elems=0,
                            gather_leaves=not case["fsdp"])
        fsdp = (dp.shard_params(model, min_elems=0) if case["fsdp"]
                else None)
        state = TrainState.create(model, build_optimizer(
            "sgd", LR, momentum=MOMENTUM), init_state(cfg), fsdp=fsdp,
            tp=tp)
        step = make_train_step(model, cfg, 1, STEPS, parallel=dp)
        mets = []
        for i in range(STEPS):
            x = mesh.local_rows(torch.from_numpy(case["batches"][i]))
            noise = case["noise"][i] if case["noise"] else None
            state, met = step(state, x, noise=noise)
            mets.append({k: float(v) for k, v in met.items()})
        moments = sum(t.numel() for st in state.optimizer.state.values()
                      for t in st.values()
                      if torch.is_tensor(t) and t.dim())
        with state.holder.whole():
            sd = {k: v.detach().clone()
                  for k, v in model.state_dict().items()}
        return {"metrics": mets, "state_dict": sd, "moments": moments,
                "split": tp.sharded,
                "fsdp_split": fsdp.sharded if fsdp is not None else 0}


def _checkpoint_round_trip(case, tmp):
    """A step under tp, the whole state and optimizer state written by
    rank 0 through train/checkpoint.py, read back into a fresh model and
    re-sliced: every slice and moment as it was, and the next step equal
    to the one the first state takes."""
    from movae_tpu_torch.moo import AggregatorConfig, init_state
    from movae_tpu_torch.parallel import mesh
    from movae_tpu_torch.parallel.tensor import TensorParallel
    from movae_tpu_torch.train import checkpoint as ckpt_lib
    from movae_tpu_torch.train.optim import build_optimizer
    from movae_tpu_torch.train.state import TrainState
    from movae_tpu_torch.train.step import make_train_step

    msh = mesh.make_mesh(num_data=DATA, num_model=MODEL, device="cpu")
    with mesh.using(msh):
        dp = mesh.DataParallel(msh)

        def build():
            model = _port_model(case["model_args"], case["state_dict"])
            cfg = AggregatorConfig(name="sum",
                                   num_objectives=len(model.objective_names))
            tp = TensorParallel(model, min_elems=0)
            state = TrainState.create(model, build_optimizer(
                "sgd", LR, momentum=MOMENTUM), init_state(cfg), tp=tp)
            return model, tp, state, make_train_step(model, cfg, parallel=dp)

        x = [mesh.local_rows(torch.from_numpy(b)) for b in case["batches"]]
        model, tp, state, step = build()
        state, _ = step(state, x[0])
        with tp.whole():
            ref = {k: v.detach().clone()
                   for k, v in model.state_dict().items()}
        opt = tp.full_optimizer_state(state.optimizer.state_dict())
        path = os.path.join(tmp, "tp_ckpt.pth")
        if mesh.process_index() == 0:
            ckpt_lib.save_checkpoint(path, {"model_state_dict": ref,
                                            "optimizer_state_dict": opt})
        torch.distributed.barrier()
        payload = ckpt_lib.load_checkpoint(path)
        model2, tp2, state2, step2 = build()
        with tp2.whole():
            model2.load_state_dict(payload["model_state_dict"])
        state2.optimizer.load_state_dict(tp2.local_optimizer_state(
            payload["optimizer_state_dict"]))
        slices_equal = all(torch.equal(a, b) for a, b in
                           zip(tp.shards, tp2.shards))
        m1 = [t for st in state.optimizer.state.values() for t in st.values()
              if torch.is_tensor(t)]
        m2 = [t for st in state2.optimizer.state.values() for t in st.values()
              if torch.is_tensor(t)]
        moments_equal = len(m1) == len(m2) and all(
            torch.equal(a, b) for a, b in zip(m1, m2))
        state.step.fill_(1)
        state2.step.fill_(1)
        state, _ = step(state, x[1])
        state2, _ = step2(state2, x[1])
        next_equal = all(torch.equal(a, b) for a, b in
                         zip(tp.shards, tp2.shards))
        return {"keys": sorted(ref), "slices_equal": slices_equal,
                "moments_equal": moments_equal, "next_equal": next_equal,
                "whole_shapes": {k: tuple(v.shape) for k, v in ref.items()}}


def _run_cli(argv):
    """``movae_tpu_torch.main`` on these ranks; its final weights."""
    from movae_tpu_torch import main as tmain
    from movae_tpu_torch.train import checkpoint as ckpt_lib

    res = tmain.main(tmain.parse_args(argv))
    path = ckpt_lib.final_checkpoint_path(res["save_root"])
    torch.distributed.barrier()
    return {"state_dict": ckpt_lib.load_checkpoint(path)[
        "model_state_dict"], "model": tuple(
            res["parallel"].mesh.shape.values())}


def _worker(rank, world, store, infile, outfile, tmp):
    torch.set_num_threads(1)
    from movae_tpu_torch.parallel import mesh

    mesh.init_distributed("cpu", init_method=f"file://{store}", rank=rank,
                          world_size=world)
    todo = torch.load(infile, weights_only=False)
    out = {name: _run_tp_case(case) for name, case in todo["steps"].items()}
    out["checkpoint"] = _checkpoint_round_trip(todo["steps"]["vq_vae-sum"],
                                               tmp)
    out["cli"] = _run_cli(todo["cli"])
    every = [None] * world
    torch.distributed.all_gather_object(every, out)
    if rank == 0:
        torch.save(every, outfile)
    torch.distributed.destroy_process_group()


@pytest.fixture(scope="module")
def tp_runs(tmp_path_factory):
    """Every case through JAX here and through the port's 4 gloo ranks in
    one spawn; returns (per-rank outcomes, JAX outcomes, the one-process
    CLI's final weights)."""
    from movae_tpu_torch import main as tmain
    from movae_tpu_torch.train import checkpoint as ckpt_lib

    tmp = tmp_path_factory.mktemp("tp")
    steps, want = {}, {}
    with pytest.MonkeyPatch.context() as mp_:
        for name, model_args, agg, fsdp in CASES:
            steps[name], want[name] = _jax_case(name, model_args, agg, fsdp,
                                                mp_)
    one = tmain.main(tmain.parse_args(CLI + ["--save_path",
                                             str(tmp / "one")]))
    cli_want = ckpt_lib.load_checkpoint(ckpt_lib.final_checkpoint_path(
        one["save_root"]))["model_state_dict"]
    infile, outfile = tmp / "in.pt", tmp / "out.pt"
    torch.save({"steps": steps, "cli": CLI + [
        "--save_path", str(tmp / "tp"), "--model_partitions", str(WORLD)]},
        infile)
    seconds = spawn(_worker, str(infile), str(outfile), str(tmp),
                    world=WORLD)
    got = torch.load(outfile, weights_only=False)
    print(f"{WORLD}-rank gloo spawn (data {DATA} x model {MODEL}), "
          f"{len(CASES) + 2} cases, spawn to join: {seconds:.1f} s")
    return got, want, cli_want


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_data_model_step_equals_jax_single_device(name, tp_runs):
    """data 2 x model 2: losses, aggregator weights and parameters equal
    JAX's step on the whole batch, every rank holds the same whole model,
    and the optimizer's moments are split (fewer on each rank than the
    whole model has parameters)."""
    ranks, want, _ = tp_runs
    w = want[name]
    whole = sum(np.asarray(v).size for k, v in w["state_dict"].items()
                if "running" not in k and "num_batches" not in k)
    for r, out in enumerate(ranks):
        got = out[name]
        assert got["split"] > 0
        for i, (gm, wm) in enumerate(zip(got["metrics"], w["metrics"])):
            for key in ("total_loss", *w["names"]):
                np.testing.assert_allclose(gm[key], wm[key], rtol=LOSS_RTOL,
                                           err_msg=f"{name} {r} {i} {key}")
            for j in range(len(w["names"])):
                np.testing.assert_allclose(gm[f"task_{j}_weight"],
                                           wm[f"task_{j}_weight"],
                                           rtol=1e-4, atol=1e-6)
            assert gm["skipped_nonfinite"] == 0.0
        _assert_state_close(got["state_dict"], w["state_dict"],
                            f"{name} rank {r}")
        assert got["moments"] < whole, (got["moments"], whole)


def test_fsdp_composes_with_tp(tp_runs):
    """test_fsdp_composes_with_tp's layout on a real step: a leaf split on
    both axes (its 'model' dimension by tp, another by fsdp), so each rank
    holds about a quarter of its moments, and the step still equals
    JAX's."""
    from movae_tpu_torch.parallel import mesh

    ranks, _, _ = tp_runs
    for out in ranks:
        assert out["fsdp-vae-upgrad"]["fsdp_split"] > 0
        assert (out["fsdp-vae-upgrad"]["moments"]
                < out["vae-upgrad"]["moments"])
    # the rule: a (16, 8) Linear weight (flax (8, 16)) gets 'model' on dim
    # 0 and 'data' on dim 1; its bias 'data' (16 % 2 == 0), as in JAX
    leaf = torch.nn.Linear(8, 16).weight
    leaf.tp_dim, leaf.tp_full_shape = 0, (16, 8)
    m = mesh.Mesh({"data": 4, "model": 2, "seq": 1, "pipe": 1},
                  torch.device("cpu"))
    dp = mesh.DataParallel(m, fsdp=True)
    assert dp.param_shardings(leaf, min_elems=0) == 1
    assert dp.param_shardings(torch.zeros(16), min_elems=0) == 0


def test_checkpoint_round_trip_in_reference_layout(tp_runs):
    """Rank 0's checkpoint holds the whole model under the reference
    state_dict keys and shapes; read back and re-sliced, every rank's
    slices and moments are as they were and the next step is the same."""
    from movae_tpu_torch.models import get_network

    ranks, _, _ = tp_runs
    ref = get_network(16, 3, dict(dict(latent_dim=8, batch_size=8,
                                       dataset_size=64), **VQ)).state_dict()
    for out in ranks:
        ck = out["checkpoint"]
        assert ck["keys"] == sorted(ref)
        assert ck["whole_shapes"] == {k: tuple(v.shape)
                                      for k, v in ref.items()}
        assert ck["slices_equal"] and ck["moments_equal"]
        assert ck["next_equal"]


def test_main_cli_with_model_partitions_equals_one_process(tp_runs):
    """``movae_tpu_torch.main --model_partitions 4`` on 4 ranks writes the
    final weights of the one-process run (the model's convolutions split
    4 ways, its codebook gathered before use)."""
    ranks, _, cli_want = tp_runs
    got = ranks[0]["cli"]
    assert got["model"] == (1, WORLD, 1, 1)
    _assert_state_close(got["state_dict"], cli_want, "cli")
