"""GPipe pipeline parallelism over the prior's blocks (movae_tpu_torch/
parallel/pipeline.py, --pipeline_parallel) against the JAX package — the
cases of tests/test_pipeline_parallel.py: the stacked layout, the default
microbatch count, the pipelined loss and gradients of PixelSNAIL (dp, pp,
M) in {(2,2,2), (1,2,4), (2,1,2)}, PixelCNN {(2,2,2), (1,4,2)} and both
hierarchical priors against JAX's plain module on the same seeded inputs
and weights (loss rtol 1e-5, gradients rtol 2e-4 / atol 1e-6), the
refusals with JAX's error classes, train_prior over 'data' x 'pipe' with a
resume (against JAX's train_prior at tests/test_prior_lockstep.py's
bounds), bf16 against plain bf16, steps_per_dispatch, and
`movae_tpu_torch.main --pipeline_parallel 4` against the one-process CLI.

The port's 4 gloo ranks are spawned once for every case (tests/
test_torch_port_parallel.py's spawn); a (dp, pp) case runs on a mesh over
the first dp * pp ranks, as the JAX test's mesh takes the first devices.
"""

import contextlib
import io
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_port_parallel import spawn  # noqa: E402

WORLD = 4
LOSS_RTOL, GRAD_RTOL, GRAD_ATOL = 1e-5, 2e-4, 1e-6
SNAIL = dict(num_embeddings=16, embedding_dim=4, hidden_channels=8,
             num_blocks=2, num_res_blocks_per_layer=1, num_heads=2,
             dropout=0.0)
CNN = dict(num_embeddings=16, embedding_dim=4, hidden_channels=8,
           num_layers=4)
HSNAIL = dict(num_embeddings=16, embedding_dim=4, hidden_channels=8,
              num_blocks_top=2, num_res_blocks_per_layer=1, num_heads=2,
              num_layers_bottom=2, dropout=0.0)
HCNN = dict(num_embeddings=16, embedding_dim=4, hidden_channels=8,
            num_layers=2)
# (case id, prior class name, kwargs, dp, pp, M, dtype)
GRAD_CASES = [
    ("snail-2-2-2", "PixelSNAIL", SNAIL, 2, 2, 2, "float32"),
    ("snail-1-2-4", "PixelSNAIL", SNAIL, 1, 2, 4, "float32"),
    ("snail-2-1-2", "PixelSNAIL", SNAIL, 2, 1, 2, "float32"),
    ("cnn-2-2-2", "PixelCNN", CNN, 2, 2, 2, "float32"),
    ("cnn-1-4-2", "PixelCNN", CNN, 1, 4, 2, "float32"),
    ("hier-snail", "HierarchicalPixelSNAIL", HSNAIL, 2, 2, 2, "float32"),
    ("hier-cnn", "HierarchicalPixelCNN", HCNN, 2, 2, 2, "float32"),
    ("snail-bf16", "PixelSNAIL", SNAIL, 2, 2, 2, "bfloat16"),
]
CLI = ["--device", "cpu", "--dataset", "synthetic-32-64", "--arch", "vq_vae",
       "--hidden_dims", "8", "16", "--embedding_dim", "8",
       "--num_embeddings", "16", "--batch_size", "16", "--epochs", "1",
       "--optimizer", "sgd", "--lr", "0.01", "--seed", "1",
       "--pixelcnn_epochs", "1", "--pixelcnn_num_layers", "4",
       "--pixelcnn_hidden_channels", "8", "--skip_final_metrics",
       "--normalize_inputs"]


def _codes(cls, b=4):
    rng = np.random.default_rng(11)
    if cls.startswith("Hierarchical"):
        return [rng.integers(0, 16, (b, 2, 2)).astype(np.int64),
                rng.integers(0, 16, (b, 4, 4)).astype(np.int64)]
    return [rng.integers(0, 16, (b, 4, 4)).astype(np.int64)]


def _jax_plain(cls, kw, dtype, codes):
    """JAX's plain module on ``codes``: (init params, loss, gradients),
    numpy trees."""
    import jax
    import jax.numpy as jnp

    from movae_tpu.models import pixelcnn as jpc

    jkw = dict(kw, dtype=jnp.bfloat16) if dtype == "bfloat16" else kw
    prior = getattr(jpc, cls)(**jkw)
    rng = jax.random.PRNGKey(0)
    zs = [jnp.asarray(c, jnp.int32) for c in codes]
    params = prior.init({"params": rng, "dropout": rng},
                        *[z[:2] for z in zs], train=False)["params"]

    def loss(p):
        return prior.apply({"params": p}, *zs, train=True,
                           method="loss_function")["total_loss"]

    val, grads = jax.jit(jax.value_and_grad(loss))(params)
    as_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return as_np(params), float(val), as_np(grads)


def _to_sd(cls, tree):
    from movae_tpu_torch.utils import weights

    fn = {"PixelSNAIL": weights.pixelsnail_state_dict,
          "PixelCNN": weights.pixelcnn_state_dict}.get(
              cls, weights.hierarchical_state_dict)
    return fn(tree)


def _port_prior(cls, kw, dtype, params):
    from movae_tpu_torch.models import pixelcnn as pc
    from movae_tpu_torch.utils import weights

    prior = getattr(pc, cls)(**dict(kw, dtype=getattr(torch, dtype)))
    weights.load_jax_prior_params(prior, params)
    return prior


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------

def _grad_case(case):
    """The pipelined loss and gradients on the (dp, pp) mesh: the data
    mean, every stage's leaves by name; None off the mesh."""
    from movae_tpu_torch.moo import engine
    from movae_tpu_torch.parallel import mesh, pipeline

    msh = mesh.make_mesh(num_data=case["dp"], num_pipe=case["pp"],
                         devices=range(WORLD), device="cpu")
    if not msh.member:
        return None
    prior = _port_prior(case["cls"], case["kw"], case["dtype"],
                        case["params"])
    par = mesh.DataParallel(msh)
    names = {id(p): n for n, p in prior.named_parameters()}
    with par.activate():
        codes = [mesh.local_rows(torch.from_numpy(c)) for c in case["codes"]]
        # JAX's entry points: forward and backward at once, the
        # gradients in each stage's .grad
        if case["cls"].startswith("Hierarchical"):
            loss_fn = pipeline.make_pipelined_hierarchical_loss(prior,
                                                                case["m"])
        else:
            loss_fn = pipeline.make_pipelined_prior_loss(prior, case["m"])
        pipe = loss_fn.pipe
        loss = loss_fn(*codes)["total_loss"]
        grads = [p.grad for p in pipe.params]
        loss, *grads = engine.all_reduce_mean([loss, *grads])
        plain = None
        if case["dtype"] == "bfloat16":
            pipe.finalize()
            plain = float(prior.loss_function(
                *[torch.from_numpy(c) for c in case["codes"]],
                train=True)["total_loss"])
    return {"loss": float(loss), "plain": plain,
            "grads": {names[id(p)]: g for p, g in zip(pipe.params, grads)},
            "split": sum(pipe.split), "held": len(pipe.params)}


def _refusals():
    """The JAX package's refusals, by error class name."""
    from movae_tpu_torch.models.pixelcnn import PixelSNAIL
    from movae_tpu_torch.parallel import mesh, pipeline

    out = {}

    def attempt(key, fn):
        try:
            fn()
            out[key] = None
        except Exception as e:  # the class is the result
            out[key] = type(e).__name__

    with mesh.using(mesh.make_mesh(num_pipe=4, device="cpu")):
        attempt("blocks", lambda: pipeline.PipelinedPrior(
            PixelSNAIL(16, num_blocks=3), 2))
    with mesh.using(mesh.make_mesh(num_pipe=2, device="cpu")):
        pipe = pipeline.PipelinedPrior(PixelSNAIL(**SNAIL), 3)
        attempt("batch", lambda: pipe.loss_and_grads(
            [torch.zeros((4, 4, 4), dtype=torch.long)]))
    with mesh.using(mesh.make_mesh(num_pipe=2, num_seq=2, device="cpu")):
        attempt("seq", lambda: pipeline.PipelinedPrior(PixelSNAIL(**SNAIL),
                                                       2))
    with mesh.using(mesh.make_mesh(num_pipe=2, num_model=2, device="cpu")):
        attempt("model", lambda: pipeline.PipelinedPrior(
            PixelSNAIL(**SNAIL), 2))
    return out


def _train(case, **over):
    """train_prior over data 2 x pipe 2 on every rank; (CE trace, final
    state_dict, stdout)."""
    from movae_tpu_torch.parallel import mesh
    from movae_tpu_torch.train.prior import build_prior, train_prior
    from movae_tpu_torch.utils import weights

    args = types.SimpleNamespace(**{**vars(case["args"]), **over})
    prior = build_prior(args, case["K"], False, case["D"])
    weights.load_jax_prior_params(prior, case["init"])
    meta = types.SimpleNamespace(num_embeddings=case["K"],
                                 embedding_dim=case["D"])
    dp = mesh.DataParallel(mesh.make_mesh(num_pipe=2, device="cpu"),
                           fsdp=bool(getattr(args, "fsdp", False)))
    trace, buf = [], io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = train_prior(case["levels"], meta, args, device="cpu",
                          step_trace=trace, prior=prior, parallel=dp,
                          save_root=over.get("save_root"))
    return trace, {k: v.detach().clone()
                   for k, v in out["model"].state_dict().items()}, \
        buf.getvalue()


def _train_cases(case, tmp):
    from movae_tpu_torch.train import checkpoint as ckpt_lib

    res = {}
    res["run"] = _train(case)[:2]
    root = f"{tmp}/pp_resume"
    _train(case, save_root=root)
    last = ckpt_lib.last_prior_path(root, "pixelcnn")
    res["last_keys"] = sorted(ckpt_lib.load_checkpoint(last)[
        "model_state_dict"])
    res["resumed"] = _train(case, pixelcnn_epochs=3, prior_resume=last)[:2]
    res["scan"] = _train(case, steps_per_dispatch=2)[:2]
    _, _, res["fsdp_out"] = _train(case, fsdp=True)
    return res


def _run_cli(argv, tmp):
    """``main --pipeline_parallel 4`` (its final prior), then
    ``train_prior_vqvae --pipeline_parallel 4`` on its checkpoint."""
    from movae_tpu_torch import main as tmain
    from movae_tpu_torch import train_prior_vqvae
    from movae_tpu_torch.train import checkpoint as ckpt_lib

    args = tmain.parse_args(argv)
    args.pixelcnn_adam_eps = 1e-4
    res = tmain.main(args)
    torch.distributed.barrier()
    path = ckpt_lib.final_prior_path(res["save_root"], "pixelcnn")
    out = train_prior_vqvae.main([
        "--model_path", ckpt_lib.final_checkpoint_path(res["save_root"]),
        "--device", "cpu", "--pipeline_parallel", str(WORLD),
        "--pixelcnn_epochs", "1", "--max_gen_metrics_samples", "0",
        "--save_root", f"{tmp}/standalone"])
    return {"state_dict": ckpt_lib.load_checkpoint(path)["model_state_dict"],
            "mesh": tuple(res["parallel"].mesh.shape.values()),
            "standalone": {k: v.detach().clone() for k, v in
                           out["prior"]["model"].state_dict().items()}}


def _worker(rank, world, store, infile, outfile, tmp):
    torch.set_num_threads(1)
    from movae_tpu_torch.parallel import mesh

    mesh.init_distributed("cpu", init_method=f"file://{store}", rank=rank,
                          world_size=world)
    todo = torch.load(infile, weights_only=False)
    out = {name: _grad_case(case) for name, case in todo["grads"].items()}
    out["refusals"] = _refusals()
    out["train"] = _train_cases(todo["train"], tmp)
    out["cli"] = _run_cli(todo["cli"], tmp)
    every = [None] * world
    torch.distributed.all_gather_object(every, out)
    if rank == 0:
        torch.save(every, outfile)
    torch.distributed.destroy_process_group()


@pytest.fixture(scope="module")
def pp_runs(tmp_path_factory):
    """Every case through JAX here and the port's 4 gloo ranks in one
    spawn: (per-rank outcomes, JAX outcomes, the one-process CLI's prior,
    the JAX and one-process train_prior runs)."""
    from test_torch_port_prior import D, K, make_codes, prior_args, run_jax

    from movae_tpu_torch import main as tmain
    from movae_tpu_torch.train import checkpoint as ckpt_lib
    from movae_tpu_torch.train.prior import build_prior, train_prior
    from movae_tpu_torch.utils import weights

    tmp = tmp_path_factory.mktemp("pp")
    grads, want = {}, {}
    for name, cls, kw, dp, pp, m, dtype in GRAD_CASES:
        codes = _codes(cls)
        params, loss, g = _jax_plain(cls, kw, dtype, codes)
        grads[name] = dict(cls=cls, kw=kw, dp=dp, pp=pp, m=m, dtype=dtype,
                           params=params, codes=codes)
        want[name] = {"loss": loss, "grads": _to_sd(cls, g)}
    # train_prior: 16 codes in batches of 8 (no ragged tail: the pipeline
    # takes whole microbatches, as in the JAX package), dropout 0, eps 1e-4
    levels = {"codes": make_codes()["codes"][:16]}
    args = prior_args("pixelcnn", pixelcnn_num_layers=4)
    init, j_trace, _, j_final = run_jax("pixelcnn", levels, tmp / "jax",
                                        pixelcnn_num_layers=4)
    prior = build_prior(args, K, False, D)
    weights.load_jax_prior_params(prior, init)
    meta = types.SimpleNamespace(num_embeddings=K, embedding_dim=D)
    one = []
    train_prior(levels, meta, args, device="cpu", step_trace=one,
                prior=prior)
    train = {"args": args, "K": K, "D": D, "init": init, "levels": levels}
    trained = {"jax_trace": j_trace,
               "jax_state": weights.pixelcnn_state_dict(j_final),
               "one_trace": one, "one_state": {
                   k: v.detach().clone()
                   for k, v in prior.state_dict().items()}}
    # the one-process resume: 2 epochs, then on to 3 from last_prior.pth
    root = str(tmp / "one_resume")
    prior = build_prior(args, K, False, D)
    weights.load_jax_prior_params(prior, init)
    train_prior(levels, meta, args, device="cpu", prior=prior,
                save_root=root)
    resumed = []
    prior = build_prior(args, K, False, D)
    out = train_prior(levels, meta, types.SimpleNamespace(
        **{**vars(args), "pixelcnn_epochs": 3}), device="cpu",
        step_trace=resumed, prior=prior,
        resume=ckpt_lib.last_prior_path(root, "pixelcnn"))
    trained["one_resumed"] = (resumed, {
        k: v.detach().clone() for k, v in out["model"].state_dict().items()})
    oargs = tmain.parse_args(CLI + ["--save_path", str(tmp / "one")])
    oargs.pixelcnn_adam_eps = 1e-4
    res = tmain.main(oargs)
    cli_want = ckpt_lib.load_checkpoint(ckpt_lib.final_prior_path(
        res["save_root"], "pixelcnn"))["model_state_dict"]
    infile, outfile = tmp / "in.pt", tmp / "out.pt"
    torch.save({"grads": grads, "train": train, "cli": CLI + [
        "--save_path", str(tmp / "pp"), "--pipeline_parallel", "4"]},
        infile)
    seconds = spawn(_worker, str(infile), str(outfile), str(tmp),
                    world=WORLD)
    got = torch.load(outfile, weights_only=False)
    print(f"{WORLD}-rank gloo spawn, {len(GRAD_CASES) + 3} case groups, "
          f"spawn to join: {seconds:.1f} s")
    return got, want, cli_want, trained


def _gathered(ranks, name):
    """The case's loss and every leaf's gradient, over the stages."""
    outs = [r[name] for r in ranks if r[name] is not None]
    grads = {}
    for o in outs:
        grads.update(o["grads"])
    return outs, grads


def test_stack_unstack_roundtrip():
    """The stacked layout: one leading block axis per leaf (N blocks),
    the other keys unchanged; unstacking gives the reference state_dict
    back, for flat and hierarchical priors; JAX's block prefixes map to
    the port's state_dict prefixes."""
    from movae_tpu.models.pixelcnn import PixelCNN as JCNN, \
        PixelSNAIL as JSnail
    from movae_tpu.parallel.pipeline import block_prefix as jprefix
    from movae_tpu_torch.models import pixelcnn as pc
    from movae_tpu_torch.parallel.pipeline import (
        BLOCKS_KEY, block_prefix, stack_block_params, stack_prior_params,
        unstack_block_params, unstack_prior_params)

    snail = pc.PixelSNAIL(**SNAIL)
    snail.reset_parameters(torch.Generator().manual_seed(0))
    state = snail.state_dict()
    stacked = stack_block_params(state)
    lead = {v.shape[0] for k, v in stacked.items()
            if k.startswith(BLOCKS_KEY)}
    assert lead == {SNAIL["num_blocks"]}
    assert not any(k.startswith("blocks.") for k in stacked)
    back = unstack_block_params(stacked)
    assert set(back) == set(state)
    for k, v in state.items():
        assert torch.equal(back[k], v)
    assert (jprefix(JSnail(**SNAIL)), block_prefix(snail)) == (
        "block_", "blocks.")
    assert (jprefix(JCNN(**CNN)), block_prefix(pc.PixelCNN(**CNN))) == (
        "res_", "res_blocks.")
    hier = pc.HierarchicalPixelSNAIL(**HSNAIL)
    hier.reset_parameters(torch.Generator().manual_seed(0))
    hs = hier.state_dict()
    hstack = stack_prior_params(hier, hs)
    assert f"prior_top.{BLOCKS_KEY}.out_conv.weight" in hstack
    assert f"prior_bottom.{BLOCKS_KEY}.conv1.weight" in hstack
    hback = unstack_prior_params(hier, hstack)
    assert set(hback) == set(hs)
    for k, v in hs.items():
        assert torch.equal(hback[k], v)


def test_default_microbatches():
    from movae_tpu.parallel.pipeline import default_microbatches as jdm
    from movae_tpu_torch.parallel.pipeline import default_microbatches

    assert default_microbatches(8, 2) == 4
    assert default_microbatches(6, 2) == 3
    assert default_microbatches(7, 4) == 7
    assert default_microbatches(1, 4) == 1
    for b in range(1, 33):
        for s in (1, 2, 3, 4, 8):
            assert default_microbatches(b, s) == jdm(b, s)


@pytest.mark.parametrize("name", [c[0] for c in GRAD_CASES
                                  if c[6] == "float32"])
def test_pipelined_loss_and_grads_match_jax_plain(name, pp_runs):
    """The pipelined loss on every rank of the mesh, and every leaf's
    gradient (each stage its blocks, the replicated prologue and heads
    summed over 'pipe'), equal JAX's plain module on the whole batch."""
    ranks, want, _, _ = pp_runs
    outs, grads = _gathered(ranks, name)
    case = next(c for c in GRAD_CASES if c[0] == name)
    assert len(outs) == case[3] * case[4]
    for o in outs:
        np.testing.assert_allclose(o["loss"], want[name]["loss"],
                                   rtol=LOSS_RTOL)
        if case[4] > 1:
            # a stage holds its blocks only
            assert o["held"] < len(want[name]["grads"])
    assert set(grads) == set(want[name]["grads"])
    for k, v in want[name]["grads"].items():
        np.testing.assert_allclose(grads[k].numpy(), v, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=f"{name}: {k}")


def test_pipelined_bf16_matches_plain_bf16(pp_runs):
    """bf16 compute: the pipelined loss tracks the plain bf16 module's,
    the port's and JAX's (rtol 2e-2, the JAX test's bound)."""
    ranks, want, _, _ = pp_runs
    outs, _ = _gathered(ranks, "snail-bf16")
    for o in outs:
        np.testing.assert_allclose(o["loss"], o["plain"], rtol=2e-2)
        np.testing.assert_allclose(o["loss"], want["snail-bf16"]["loss"],
                                   rtol=2e-2)


def test_pipeline_rejects_bad_configs(pp_runs):
    """JAX's refusals with its error class: blocks that do not divide
    into the stages, a batch the microbatches do not divide, and the
    pipeline with a 'seq' or 'model' axis."""
    ranks, _, _, _ = pp_runs
    for r in ranks:
        assert r["refusals"] == {"blocks": "ValueError",
                                 "batch": "ValueError",
                                 "seq": "ValueError",
                                 "model": "ValueError"}


def test_pp_prior_trains_and_resumes(pp_runs):
    """train_prior over data 2 x pipe 2: the CE and weights of the port's
    one-process run (test_parallel.py's bounds) and of JAX's train_prior
    (test_prior_lockstep.py's: CE 1e-4 relative, weights 1e-3); the last
    checkpoint in the reference (unstacked) layout; a run resumed from it
    (epoch 3 of 3) equal to the one-process resume; --fsdp noted and not
    applied."""
    ranks, _, _, trained = pp_runs
    for r in ranks:
        t = r["train"]
        trace, state = t["run"]
        np.testing.assert_allclose(trace, trained["one_trace"], rtol=1e-5)
        np.testing.assert_allclose(trace, trained["jax_trace"], rtol=1e-4)
        for k, v in trained["one_state"].items():
            np.testing.assert_allclose(state[k].numpy(), v.numpy(),
                                       rtol=1e-4, atol=1e-6, err_msg=k)
            np.testing.assert_allclose(state[k].numpy(),
                                       trained["jax_state"][k], atol=1e-3)
        assert t["last_keys"] == sorted(trained["one_state"])
        res_trace, resumed = t["resumed"]
        one_trace, one = trained["one_resumed"]
        assert len(res_trace) == len(one_trace) == 2
        np.testing.assert_allclose(res_trace, one_trace, rtol=1e-5)
        for k, v in one.items():
            np.testing.assert_allclose(resumed[k].numpy(), v.numpy(),
                                       rtol=1e-4, atol=1e-6, err_msg=k)
        assert "--fsdp does not apply to the pipelined prior" in \
            t["fsdp_out"] or r is not ranks[0]


def test_pp_composes_with_steps_per_dispatch(pp_runs):
    """--steps_per_dispatch 2 under the pipeline: the numbers of single
    steps."""
    ranks, _, _, _ = pp_runs
    for r in ranks:
        trace, state = r["train"]["scan"]
        base_trace, base = r["train"]["run"]
        np.testing.assert_allclose(trace, base_trace, rtol=1e-6)
        for k, v in base.items():
            assert torch.allclose(state[k], v, rtol=1e-6, atol=1e-7), k


def test_main_cli_with_pipeline_parallel_equals_one_process(pp_runs):
    """``movae_tpu_torch.main --pipeline_parallel 4`` on 4 ranks (stage 1
    replicated over 'pipe', the PixelCNN prior's 4 blocks one a stage)
    writes the one-process run's final prior, at tests/
    test_prior_lockstep.py's bound on the weights (1e-3: four Adam steps,
    where a gradient element below eps moves by a fraction of a step with
    the summation order); ``train_prior_vqvae --pipeline_parallel 4``
    trains on its checkpoint, every rank ending with the same whole
    prior."""
    ranks, _, cli_want, _ = pp_runs
    got = ranks[0]["cli"]
    assert got["mesh"] == (1, 1, 1, WORLD)
    assert set(got["state_dict"]) == set(cli_want)
    for k, v in cli_want.items():
        np.testing.assert_allclose(np.asarray(got["state_dict"][k]),
                                   np.asarray(v), rtol=0, atol=1e-3,
                                   err_msg=k)
    for r in ranks:
        for k, v in r["cli"]["standalone"].items():
            assert torch.isfinite(v.float()).all(), k
            assert torch.equal(v, got["standalone"][k]), k
