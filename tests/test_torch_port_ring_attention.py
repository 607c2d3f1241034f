"""Ring (sequence-parallel) attention over the 'seq' axis (movae_tpu_torch/
ops/ring_attention.py, parallel/context.py, --context_parallel) against
the JAX package's dense oracle — the cases of
tests/test_ring_attention.py: the forward for (L, S) in {(64, 4), (60,
8), (16, 2)} in both layouts (L padded where the stripes do not divide
it) at 2e-5, the gradients at 3e-5, the composition with the data axis,
the dispatch of ops/attention.py:causal_attention under an installed
context, the PixelSNAIL, PixelCNN and hierarchical priors' loss (and a
6x6 PixelSNAIL's gradients, its trunk whole) under the context against
JAX's at 1e-5 / 1e-6 (5e-5 / 5e-6 for gradients), bf16 inputs against
the float32 dense at 0.05, make_mesh's 'seq' validation, a planted fault
(the last rotation dropped) refused, and both CLIs with
--context_parallel 8.

The row-sharded trunk (parallel/context.py, the JAX package's
seq_shard_spatial) where the seq ranks divide the grid's rows, against
JAX's own sharded oracles (tests/test_ring_attention.py:131-219, under
JAX's context on the 8 virtual CPU devices): PixelSNAIL's loss and every
gradient at 5e-5 / 5e-6 on an 8x8 grid at seq 4 (2 rows a rank against
conv_in's 3-row halo), the PixelCNN and hierarchical PixelSNAIL at 1e-5
/ 1e-6 (loss) and 5e-5 / 5e-6 (every gradient), the hierarchical prior
with its 6x6 top whole and its 12x12 bottom sharded, a 4x3 grid (3
positions a rank: the ring's gather fallback, the trunk still sharded),
conv_in's input and the logits holding 2 of the 8 rows on each rank
(each hierarchical level its own), a planted halo that drops its first
row refused, output dropout at 0.3 equal to the one-rank port on the
same generator, and a bf16 trunk within 2e-2 of the largest logit of the
one-rank bf16 port with its halos and stripes moved in bf16.

The port's 8 gloo ranks are spawned once for every case (tests/
test_torch_port_parallel.py's spawn); a case with S ranks on the ring
runs on a mesh of 8 / S data ranks, each holding the whole batch where
the JAX case maps no batch axis.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_port_parallel import spawn  # noqa: E402

WORLD = 8
FWD = [(64, 4), (60, 8), (16, 2)]
SNAIL = dict(num_embeddings=16, embedding_dim=8, hidden_channels=16,
             num_blocks=2, num_res_blocks_per_layer=1, num_heads=2,
             dropout=0.0)
PIXELCNN = dict(num_embeddings=16, embedding_dim=8, hidden_channels=12,
                num_layers=2)
HIER = dict(num_embeddings=16, embedding_dim=8, hidden_channels=16,
            num_blocks_top=1, num_res_blocks_per_layer=1, num_heads=2,
            num_layers_bottom=2, dropout=0.0)
CLI = ["--device", "cpu", "--dataset", "synthetic-32-64", "--arch", "vq_vae",
       "--hidden_dims", "8", "16", "--embedding_dim", "8",
       "--num_embeddings", "16", "--batch_size", "16", "--epochs", "1",
       "--optimizer", "sgd", "--lr", "0.01", "--seed", "1",
       "--prior_type", "pixelsnail", "--pixelsnail_num_blocks", "1",
       "--pixelsnail_num_res_blocks", "1", "--pixelsnail_num_heads", "2",
       "--pixelsnail_dropout", "0.0", "--pixelcnn_hidden_channels", "8",
       "--pixelcnn_epochs", "1", "--skip_final_metrics",
       "--normalize_inputs"]


def _qkv(seed, b, h, L, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, h, L, d)).astype(np.float32)
            for _ in range(3)]


def _jax_dense(q, k, v, sm):
    import jax.numpy as jnp

    from movae_tpu.ops.attention import dense_causal_attention

    return np.asarray(dense_causal_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), sm))


def _jax_prior(cls, kw, codes, grads=False, sharded=False):
    """JAX's module on ``codes`` (train, dropout 0): (params, loss[,
    gradients]); ``sharded``: under JAX's context over data 2 x seq 4 (its
    trunk row-sharded where 4 divides the rows), as tests/
    test_ring_attention.py runs it."""
    import jax
    import jax.numpy as jnp

    from movae_tpu.models import pixelcnn as jpc
    from movae_tpu.parallel.context import context_parallel
    from movae_tpu.parallel.mesh import make_mesh

    if sharded:
        mesh = make_mesh(num_data=2, num_model=1, num_seq=4,
                         devices=jax.devices()[:8])
        with context_parallel(mesh):
            return _jax_prior(cls, kw, codes, grads)
    prior = getattr(jpc, cls)(**kw)
    rng = jax.random.PRNGKey(5)
    zs = [jnp.asarray(c, jnp.int32) for c in codes]
    params = prior.init({"params": rng, "dropout": rng}, *zs,
                        train=False)["params"]

    def loss(p):
        return prior.apply({"params": p}, *zs, train=True,
                           method="loss_function",
                           rngs={"dropout": rng})["total_loss"]

    as_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    if grads:
        val, g = jax.jit(jax.value_and_grad(loss))(params)
        return as_np(params), float(val), as_np(g)
    return as_np(params), float(jax.jit(loss)(params)), None


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------

def _mesh(S, data=None):
    from movae_tpu_torch.parallel import mesh

    return mesh.make_mesh(num_data=data or WORLD // S, num_seq=S,
                          device="cpu")


def _ring(q, k, v, sm, msh, zigzag=True, grad_w=None, backward_on=None):
    """The ring over ``msh`` (its backward with ``backward_on`` current
    where given)."""
    from movae_tpu_torch.ops.ring_attention import ring_causal_attention
    from movae_tpu_torch.parallel import mesh

    ts = [torch.from_numpy(t).requires_grad_(grad_w is not None)
          for t in (q, k, v)]
    with mesh.using(msh):
        out = ring_causal_attention(*ts, sm, zigzag=zigzag)
    if grad_w is None:
        return out.detach(), None
    with mesh.using(backward_on or msh):
        (out.float() * torch.from_numpy(grad_w)).sum().backward()
    return out.detach(), [t.grad for t in ts]


def _port_prior(case):
    """The port's prior of ``case``: JAX's weights (``params``) or its own
    init from ``init``; ``dtype`` its compute dtype."""
    from movae_tpu_torch.models import pixelcnn as pc
    from movae_tpu_torch.utils import weights

    prior = getattr(pc, case["cls"])(**case["kw"], **(
        {"dtype": case["dtype"]} if "dtype" in case else {}))
    if "params" in case:
        weights.load_jax_prior_params(prior, case["params"])
    else:
        prior.reset_parameters(torch.Generator().manual_seed(case["init"]))
    return prior


def _logits(prior, codes):
    """The prior's NHWC logits (the hierarchical prior's bottom's)."""
    out = prior(*codes)
    return out["logits_bottom"] if isinstance(out, dict) else out


def _one_rank(case):
    """The one-rank port on the whole batch: loss, gradients and NHWC
    logits (the hierarchical prior's bottom), from generator seed 3."""
    prior = _port_prior(case)
    codes = [torch.from_numpy(c).long() for c in case["codes"]]
    loss = prior.loss_function(*codes, train=True,
                               generator=torch.Generator().manual_seed(3))
    names = [n for n, _ in prior.named_parameters()]
    grads = torch.autograd.grad(loss["total_loss"], list(prior.parameters()))
    with torch.no_grad():
        logits = _logits(prior, codes)
    return {"loss": float(loss["total_loss"].detach()),
            "grads": dict(zip(names, grads)), "logits": logits}


def _drop_first_halo_row(real):
    """A planted fault: the halo's first row lost (zeros)."""
    def halo_rows(x, p):
        h = real(x, p)
        return torch.cat([torch.zeros_like(h[:, :, :1]), h[:, :, 1:]], 2)
    return halo_rows


def _prior_case(case):
    """The port's prior under a data 2 x seq 4 context, each data rank on
    its rows, dropout drawn from generator seed 3: the loss's data mean
    and the gradients' data mean summed over seq, as the prior trainer
    takes them (each seq rank's gradient is its part of the whole); where
    the trunk is row-sharded, conv_in's input and the logits' shapes on
    this rank, its NHWC logits (the whole grid, gathered) and the dtypes
    of the exchanges' sends. ``planted``: a halo that drops its first
    row."""
    from movae_tpu_torch.moo import engine
    from movae_tpu_torch.parallel import context as cp_lib
    from movae_tpu_torch.parallel import mesh
    from movae_tpu_torch.parallel.context import context_parallel

    msh = _mesh(4, data=2)
    prior = _port_prior(case)
    par = mesh.DataParallel(msh)
    seen, hooks, sent = {}, [], []
    def record(key, t):
        seen.setdefault(key, tuple(t.shape))

    if hasattr(prior, "conv_in"):
        hooks = [prior.conv_in.register_forward_hook(
            lambda m, i, o: record("conv_in", i[0])),
            prior.conv_out.register_forward_hook(
            lambda m, i, o: record("logits", o))]
    else:
        hooks = [getattr(prior, f"prior_{level}").conv_in
                 .register_forward_hook(
                     lambda m, i, o, key=f"{level}_conv_in": record(key, i[0]))
                 for level in ("top", "bottom")]
    real_halo, real_exchange = cp_lib.halo_rows, mesh.exchange

    def exchange(sends=(), recvs=(), axis="pipe"):
        sent.extend(str(t.dtype) for t, _ in sends)
        return real_exchange(sends, recvs, axis)

    if case.get("planted"):
        cp_lib.halo_rows = _drop_first_halo_row(real_halo)
    mesh.exchange = exchange
    try:
        with par.activate(), context_parallel():
            codes = [mesh.local_rows(torch.from_numpy(c).long())
                     for c in case["codes"]]
            loss = prior.loss_function(
                *codes, train=True,
                generator=torch.Generator().manual_seed(3))["total_loss"]
            names = [n for n, _ in prior.named_parameters()]
            grads = torch.autograd.grad(loss, list(prior.parameters()))
            loss, *grads = engine.all_reduce_mean([loss.detach(), *grads])
            grads = mesh.all_reduce_sum(grads, "seq")
            with torch.no_grad():
                logits = mesh.interleave(mesh.all_gather(
                    _logits(prior, codes)))
    finally:
        cp_lib.halo_rows, mesh.exchange = real_halo, real_exchange
        for h in hooks:
            h.remove()
    return {"loss": float(loss), "grads": dict(zip(names, grads)),
            "shapes": seen, "logits": logits, "sent": sorted(set(sent))}


def _run_cli(argv, tmp):
    """``main --context_parallel 8`` (its final prior), then
    ``train_prior_vqvae --context_parallel 8`` on its checkpoint."""
    from movae_tpu_torch import main as tmain
    from movae_tpu_torch import train_prior_vqvae
    from movae_tpu_torch.train import checkpoint as ckpt_lib

    args = tmain.parse_args(argv)
    args.pixelcnn_adam_eps = 1e-4
    res = tmain.main(args)
    torch.distributed.barrier()
    root = res["save_root"]
    prior = ckpt_lib.load_checkpoint(ckpt_lib.final_prior_path(
        root, "pixelsnail"))["model_state_dict"]
    out = train_prior_vqvae.main([
        "--model_path", ckpt_lib.final_checkpoint_path(root), "--device",
        "cpu", "--context_parallel", str(WORLD), "--pixelcnn_epochs", "1",
        "--max_gen_metrics_samples", "0", "--save_root", f"{tmp}/standalone"])
    standalone = {k: v.detach().clone() for k, v in
                  out["prior"]["model"].state_dict().items()}
    return {"prior": prior, "mesh": tuple(res["parallel"].mesh.shape
                                          .values()),
            "standalone": standalone}


def _worker(rank, world, store, infile, outfile, tmp):
    torch.set_num_threads(1)
    from movae_tpu_torch.ops import attention, ring_attention
    from movae_tpu_torch.parallel import mesh
    from movae_tpu_torch.parallel.context import (context_parallel,
                                                  get_context_parallel)

    mesh.init_distributed("cpu", init_method=f"file://{store}", rank=rank,
                          world_size=world)
    todo = torch.load(infile, weights_only=False)
    out = {}
    for (L, S) in FWD:
        q, k, v = todo["fwd"][(L, S)]
        for zz in (True, False):
            out[("fwd", L, S, zz)] = _ring(q, k, v, 0.25, _mesh(S), zz)[0]
    g = todo["grads"]
    for zz in (True, False):
        out[("grads", zz)] = _ring(*g["qkv"], g["sm"], _mesh(4), zz,
                                   grad_w=g["w"])
    # the backward after another mesh (seq 2) was made current: it runs
    # over its forward's
    out["grads_other_mesh"] = _ring(*g["qkv"], g["sm"], _mesh(4),
                                    grad_w=g["w"], backward_on=_mesh(2))
    # the data axis: each data rank's rows, gathered back
    msh = _mesh(4, data=2)
    q, k, v = todo["data"]
    with mesh.using(msh):
        rows = [mesh.local_rows(torch.from_numpy(t)).numpy()
                for t in (q, k, v)]
        o, _ = _ring(*rows, 0.3, msh)
        out["data"] = mesh.interleave(mesh.all_gather(o))
    # the dispatch under a context: the ring once, over the current mesh
    msh = _mesh(4)
    before = get_context_parallel()
    real, rings = ring_attention.ring_causal_attention, []

    def counted(*a, **kw):
        rings.append(1)
        return real(*a, **kw)

    ring_attention.ring_causal_attention = counted
    try:
        with mesh.using(msh), context_parallel() as ctx:
            size = get_context_parallel().size
            q, k, v = (torch.from_numpy(t) for t in todo["dispatch"])
            out["dispatch"] = (attention.causal_attention(q, k, v, 0.5),
                               before, size, len(rings),
                               get_context_parallel() is ctx)
    finally:
        ring_attention.ring_causal_attention = real
    out["dispatch_after"] = get_context_parallel()
    out.update((name, _prior_case(case))
               for name, case in todo["priors"].items())
    q, k, v = (t.astype(np.float32) for t in todo["bf16"])
    out["bf16"] = _ring_bf16(q, k, v)
    # the planted fault: the last rotation dropped
    q, k, v = todo["fwd"][(64, 4)]
    real = ring_attention._rotations
    ring_attention._rotations = lambda S: range(1, S - 1)
    try:
        out["planted"] = _ring(q, k, v, 0.25, _mesh(4))[0]
    finally:
        ring_attention._rotations = real
    # make_mesh's 'seq' validation
    m2 = mesh.make_mesh(num_seq=2, device="cpu")
    try:
        mesh.make_mesh(num_model=3, num_seq=3, device="cpu")
        bad = None
    except ValueError as e:
        bad = str(e)
    out["mesh"] = (dict(m2.shape), bad)
    out["cli"] = _run_cli(todo["cli"], tmp)
    every = [None] * world
    torch.distributed.all_gather_object(every, out)
    if rank == 0:
        torch.save(every, outfile)
    torch.distributed.destroy_process_group()


def _ring_bf16(q, k, v):
    from movae_tpu_torch.ops.ring_attention import ring_causal_attention

    from movae_tpu_torch.parallel import mesh

    ts = [torch.from_numpy(t).to(torch.bfloat16) for t in (q, k, v)]
    with mesh.using(_mesh(4)):
        return ring_causal_attention(*ts, 1.0 / np.sqrt(8.0))


@pytest.fixture(scope="module")
def ring_runs(tmp_path_factory):
    """Every case through JAX here and through the port's 8 gloo ranks in
    one spawn: (per-rank outcomes, JAX outcomes, the inputs)."""
    import jax
    import jax.numpy as jnp

    from movae_tpu.ops.attention import dense_causal_attention
    from movae_tpu_torch import main as tmain
    from movae_tpu_torch.train import checkpoint as ckpt_lib

    tmp = tmp_path_factory.mktemp("ring")
    todo, want = {"fwd": {}}, {}
    for i, (L, S) in enumerate(FWD):
        qkv = _qkv(i, 2, 2, L, 16)
        todo["fwd"][(L, S)] = qkv
        want[("fwd", L, S)] = _jax_dense(*qkv, 0.25)
    qkv = _qkv(10, 1, 2, 32, 8)
    w = np.random.default_rng(11).standard_normal(qkv[0].shape).astype(
        np.float32)
    sm = 1.0 / np.sqrt(8.0)
    todo["grads"] = {"qkv": qkv, "w": w, "sm": sm}

    def loss_dense(q, k, v):
        return jnp.sum(jnp.asarray(w) * dense_causal_attention(q, k, v, sm))

    want["grads"] = [np.asarray(g) for g in jax.grad(
        loss_dense, argnums=(0, 1, 2))(*map(jnp.asarray, qkv))]
    todo["data"] = _qkv(12, 4, 2, 24, 8)
    want["data"] = _jax_dense(*todo["data"], 0.3)
    todo["dispatch"] = _qkv(13, 2, 2, 40, 8)
    want["dispatch"] = _jax_dense(*todo["dispatch"], 0.5)
    rng = np.random.default_rng(14)
    priors = {}
    for name, cls, kw, codes, grads in (
            ("pixelsnail", "PixelSNAIL", SNAIL,
             [rng.integers(0, 16, (2, 6, 6))], False),
            ("pixelsnail-grads", "PixelSNAIL", dict(SNAIL, num_blocks=1),
             [rng.integers(0, 16, (2, 6, 6))], True),
            ("pixelcnn", "PixelCNN", PIXELCNN,
             [rng.integers(0, 16, (2, 8, 8))], False),
            ("hierarchical", "HierarchicalPixelSNAIL", HIER,
             [rng.integers(0, 16, (2, 4, 4)), rng.integers(0, 16, (2, 8, 8))],
             False)):
        params, loss, g = _jax_prior(cls, kw, codes, grads)
        priors[name] = dict(cls=cls, kw=kw, codes=codes, params=params)
        want[name] = {"loss": loss, "grads": g, "cls": cls}
    # the row-sharded trunk: JAX's seq_shard_spatial oracles (its trunk
    # sharded under its context), then the one-rank port for dropout and
    # bf16
    rng = np.random.default_rng(16)
    snail1 = dict(SNAIL, num_blocks=1)
    for name, cls, kw, codes in (
            ("sharded-pixelsnail", "PixelSNAIL", snail1,
             [rng.integers(0, 16, (2, 8, 8))]),
            ("sharded-odd", "PixelSNAIL", snail1,
             [rng.integers(0, 16, (2, 4, 3))]),
            ("sharded-pixelcnn", "PixelCNN", PIXELCNN,
             [rng.integers(0, 16, (2, 8, 8))]),
            ("sharded-hierarchical", "HierarchicalPixelSNAIL", HIER,
             [rng.integers(0, 16, (2, 4, 4)),
              rng.integers(0, 16, (2, 8, 8))]),
            ("sharded-hierarchical-top-whole", "HierarchicalPixelSNAIL",
             HIER, [rng.integers(0, 16, (2, 6, 6)),
                    rng.integers(0, 16, (2, 12, 12))])):
        params, loss, g = _jax_prior(cls, kw, codes, True, sharded=True)
        priors[name] = dict(cls=cls, kw=kw, codes=codes, params=params)
        want[name] = {"loss": loss, "grads": g, "cls": cls}
    priors["sharded-planted"] = dict(priors["sharded-pixelsnail"],
                                     planted=True)
    for name, case in (
            ("sharded-dropout", dict(
                cls="PixelSNAIL", kw=dict(snail1, dropout=0.3), init=17,
                codes=[rng.integers(0, 16, (2, 8, 8))])),
            ("sharded-bf16", dict(
                cls="PixelSNAIL", kw=snail1, dtype="bfloat16", init=18,
                codes=[rng.integers(0, 16, (2, 8, 8))]))):
        priors[name] = case
        want[name] = _one_rank(case)
    todo["priors"] = priors
    todo["bf16"] = _qkv(15, 2, 2, 32, 8)
    want["bf16"] = _jax_dense(*todo["bf16"], 1.0 / np.sqrt(8.0))
    args = tmain.parse_args(CLI + ["--save_path", str(tmp / "one")])
    args.pixelcnn_adam_eps = 1e-4
    res = tmain.main(args)
    want["cli"] = ckpt_lib.load_checkpoint(ckpt_lib.final_prior_path(
        res["save_root"], "pixelsnail"))["model_state_dict"]
    todo["cli"] = CLI + ["--save_path", str(tmp / "cp"),
                         "--context_parallel", str(WORLD)]
    infile, outfile = tmp / "in.pt", tmp / "out.pt"
    torch.save(todo, infile)
    seconds = spawn(_worker, str(infile), str(outfile), str(tmp),
                    world=WORLD)
    got = torch.load(outfile, weights_only=False)
    print(f"{WORLD}-rank gloo spawn, spawn to join: {seconds:.1f} s")
    return got, want


@pytest.mark.parametrize("zigzag", [True, False])
@pytest.mark.parametrize("L,S", FWD)
def test_ring_matches_dense_forward(L, S, zigzag, ring_runs):
    ranks, want = ring_runs
    for r in ranks:
        np.testing.assert_allclose(r[("fwd", L, S, zigzag)].numpy(),
                                   want[("fwd", L, S)], rtol=2e-5,
                                   atol=2e-5)


@pytest.mark.parametrize("zigzag", [True, False])
def test_ring_matches_dense_grads(zigzag, ring_runs):
    """dQ, dK and dV through the hand-written backward (global lse2 and
    di into every block; dK/dV round the ring the other way)."""
    ranks, want = ring_runs
    for r in ranks:
        _, grads = r[("grads", zigzag)]
        for a, b in zip(grads, want["grads"]):
            np.testing.assert_allclose(a.numpy(), b, rtol=3e-5, atol=3e-5)


def test_ring_backward_keeps_its_forward_mesh(ring_runs):
    """The backward run while another mesh (seq 2) is current still
    rotates over its forward's seq 4 and sums over its groups."""
    ranks, want = ring_runs
    for r in ranks:
        _, grads = r["grads_other_mesh"]
        for a, b in zip(grads, want["grads"]):
            np.testing.assert_allclose(a.numpy(), b, rtol=3e-5, atol=3e-5)


def test_ring_composes_with_data_parallel_batch(ring_runs):
    ranks, want = ring_runs
    for r in ranks:
        np.testing.assert_allclose(r["data"].numpy(), want["data"],
                                   rtol=2e-5, atol=2e-5)


def test_causal_attention_dispatches_ring_under_context(ring_runs):
    ranks, want = ring_runs
    for r in ranks:
        out, before, size, rings, active = r["dispatch"]
        assert before is None and r["dispatch_after"] is None
        assert (size, rings, active) == (4, 1, True)
        np.testing.assert_allclose(out.numpy(), want["dispatch"],
                                   rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("name", ["pixelsnail", "pixelcnn", "hierarchical"])
def test_prior_loss_invariant_under_context_parallel(name, ring_runs):
    """The priors' loss_function (train, dropout 0) under a data 2 x seq
    4 context equals JAX's on the whole batch (PixelSNAIL at L = 36 pads
    to 40; the hierarchical top at L = 16)."""
    ranks, want = ring_runs
    for r in ranks:
        np.testing.assert_allclose(r[name]["loss"], want[name]["loss"],
                                   rtol=1e-5, atol=1e-6)


def test_prior_loss_and_grads_invariant_under_context_parallel(ring_runs):
    """Loss and every parameter's gradient through the ring with the
    trunk whole (a 6x6 grid, which seq 4 does not divide: each rank's
    gradient 1/S of the whole, summed over seq as the trainer does) equal
    JAX's one-device ones at tests/test_ring_attention.py's bounds."""
    from movae_tpu_torch.utils import weights

    ranks, want = ring_runs
    w = want["pixelsnail-grads"]
    g = weights.pixelsnail_state_dict(w["grads"])
    for r in ranks:
        got = r["pixelsnail-grads"]
        np.testing.assert_allclose(got["loss"], w["loss"], rtol=1e-5,
                                   atol=1e-6)
        assert set(got["grads"]) == set(g)
        for k, v in g.items():
            np.testing.assert_allclose(got["grads"][k].numpy(), v,
                                       rtol=5e-5, atol=5e-6, err_msg=k)


def test_ring_bf16_matches_f32_dense(ring_runs):
    """bf16 inputs: the ring computes in float32 and casts back."""
    ranks, want = ring_runs
    for r in ranks:
        assert r["bf16"].dtype == torch.bfloat16
        np.testing.assert_allclose(r["bf16"].float().numpy(), want["bf16"],
                                   rtol=0.05, atol=0.05)


def test_ring_without_its_last_rotation_is_refused(ring_runs):
    """A planted fault: the ring that skips its last rotation misses one
    stripe product and leaves the forward's bound."""
    ranks, want = ring_runs
    err = np.abs(ranks[0]["planted"].numpy() - want[("fwd", 64, 4)]).max()
    assert err > 2e-5 * 100, err


def test_make_mesh_seq_axis_validation(ring_runs):
    ranks, _ = ring_runs
    for r in ranks:
        shape, bad = r["mesh"]
        assert shape == {"data": WORLD // 2, "model": 1, "seq": 2, "pipe": 1}
        assert bad is not None and "must divide the device count" in bad


def test_both_clis_with_context_parallel(ring_runs):
    """``movae_tpu_torch.main --context_parallel 8`` (stage 1 replicated
    over 'seq', the PixelSNAIL prior's 8x8 trunk row-sharded, one row a
    rank, its attention on the ring at L = 64)
    writes the one-process run's final prior at tests/
    test_prior_lockstep.py's weight bound (1e-3), and
    ``train_prior_vqvae --context_parallel 8`` trains on its checkpoint,
    every rank holding the same prior."""
    ranks, want = ring_runs
    got = ranks[0]["cli"]
    assert got["mesh"] == (1, 1, WORLD, 1)
    assert set(got["prior"]) == set(want["cli"])
    for k, v in want["cli"].items():
        np.testing.assert_allclose(np.asarray(got["prior"][k]),
                                   np.asarray(v), rtol=0, atol=1e-3,
                                   err_msg=k)
    for r in ranks:
        for k, v in r["cli"]["standalone"].items():
            assert torch.isfinite(v.float()).all(), k
            assert torch.equal(v, ranks[0]["cli"]["standalone"][k]), k


_CONVERT = {"PixelSNAIL": "pixelsnail_state_dict",
            "PixelCNN": "pixelcnn_state_dict",
            "HierarchicalPixelSNAIL": "hierarchical_state_dict"}


def _grads_close(got, want, rtol, atol):
    """Whether every gradient is within the bounds (and the names equal)."""
    return set(got) == set(want) and all(
        np.allclose(got[k].numpy(), v, rtol=rtol, atol=atol)
        for k, v in want.items())


def _jax_grads(w):
    from movae_tpu_torch.utils import weights

    return getattr(weights, _CONVERT[w["cls"]])(w["grads"])


@pytest.mark.parametrize("name", ["sharded-pixelsnail", "sharded-odd"])
def test_prior_loss_and_grads_invariant_with_seq_sharded_trunk(name,
                                                                ring_runs):
    """The port of tests/test_ring_attention.py:131-162: PixelSNAIL's loss
    and every gradient with the trunk row-sharded over seq 4 (8x8: 2 rows
    a rank, conv_in's 3-row halo over two ranks; 4x3: 3 positions a rank,
    which the zigzag ring takes by its gather fallback) equal JAX's
    seq_shard_spatial oracle at that test's bounds."""
    ranks, want = ring_runs
    w = want[name]
    g = _jax_grads(w)
    for r in ranks:
        got = r[name]
        np.testing.assert_allclose(got["loss"], w["loss"], rtol=1e-5,
                                   atol=1e-6)
        assert set(got["grads"]) == set(g)
        for k, v in g.items():
            np.testing.assert_allclose(got["grads"][k].numpy(), v,
                                       rtol=5e-5, atol=5e-6, err_msg=k)


@pytest.mark.parametrize("name", ["sharded-pixelcnn", "sharded-hierarchical",
                                  "sharded-hierarchical-top-whole"])
def test_sharded_trunk_priors_invariant(name, ring_runs):
    """The ports of tests/test_ring_attention.py:165-219: the conv-only
    PixelCNN and the hierarchical PixelSNAIL (top 4x4 at 1 row a rank,
    bottom 8x8 at 2) with their trunks row-sharded, and the hierarchical
    prior with its 6x6 top whole (seq 4 does not divide it: each rank's
    gradient of the top 1/S of the whole) and its 12x12 bottom sharded (3
    rows a rank): the loss at 1e-5 / 1e-6 against JAX's under its
    context, every gradient at 5e-5 / 5e-6."""
    ranks, want = ring_runs
    w = want[name]
    g = _jax_grads(w)
    for r in ranks:
        got = r[name]
        np.testing.assert_allclose(got["loss"], w["loss"], rtol=1e-5,
                                   atol=1e-6)
        assert set(got["grads"]) == set(g)
        for k, v in g.items():
            np.testing.assert_allclose(got["grads"][k].numpy(), v,
                                       rtol=5e-5, atol=5e-6, err_msg=k)


def test_sharded_trunk_runs_its_rows(ring_runs):
    """Each seq rank's conv_in takes its rows alone and its logits hold
    them: 2 of 8 rows (8x8), 1 of 4 (4x3), each data rank its one batch
    row; the 6x6 grid, which seq 4 does not divide, runs whole. The
    hierarchical prior shards each level its rows alone: a 4x4 top at 1
    row and an 8x8 bottom at 2; a 6x6 top whole and a 12x12 bottom at
    3."""
    ranks, _ = ring_runs
    for r in ranks:
        for name, top, bottom in (
                ("sharded-hierarchical", (1, 4), (2, 8)),
                ("sharded-hierarchical-top-whole", (6, 6), (3, 12))):
            shapes = r[name]["shapes"]
            assert shapes["top_conv_in"][2:] == top, name
            assert shapes["bottom_conv_in"][2:] == bottom, name
        assert r["sharded-pixelsnail"]["shapes"] == {
            "conv_in": (1, 8 + 2, 2, 8), "logits": (1, 16, 2, 8)}
        assert r["sharded-odd"]["shapes"] == {
            "conv_in": (1, 8 + 2, 1, 3), "logits": (1, 16, 1, 3)}
        assert r["sharded-pixelcnn"]["shapes"] == {
            "conv_in": (1, 8, 2, 8), "logits": (1, 16, 2, 8)}
        assert r["pixelsnail"]["shapes"] == {
            "conv_in": (1, 8 + 2, 6, 6), "logits": (1, 16, 6, 6)}


def test_sharded_trunk_halo_fault_is_refused(ring_runs):
    """A planted fault: a halo that drops its first row. The loss may
    move little, but the gradients leave the sharded trunk's bound."""
    ranks, want = ring_runs
    g = _jax_grads(want["sharded-pixelsnail"])
    assert _grads_close(ranks[0]["sharded-pixelsnail"]["grads"], g, 5e-5,
                        5e-6)
    assert not _grads_close(ranks[0]["sharded-planted"]["grads"], g, 5e-5,
                            5e-6)


def test_sharded_trunk_output_dropout_matches_one_rank(ring_runs):
    """Output dropout at 0.3: each rank draws the whole batch's and
    sequence's masks from the generator and keeps its rows, so the loss
    and gradients equal the one-rank port's on the same generator."""
    ranks, want = ring_runs
    w = want["sharded-dropout"]
    for r in ranks:
        got = r["sharded-dropout"]
        np.testing.assert_allclose(got["loss"], w["loss"], rtol=1e-5,
                                   atol=1e-6)
        for k, v in w["grads"].items():
            np.testing.assert_allclose(got["grads"][k].numpy(), v.numpy(),
                                       rtol=5e-5, atol=5e-6, err_msg=k)


def test_sharded_trunk_bf16_matches_whole_trunk(ring_runs):
    """--compute_dtype bfloat16 with the trunk row-sharded: the halos and
    the ring's stripes move bf16 over gloo, and the logits are within the
    bf16 tests' 2e-2 of the largest value of the one-rank port's."""
    ranks, want = ring_runs
    ref = want["sharded-bf16"]["logits"]
    for r in ranks:
        got = r["sharded-bf16"]
        assert "torch.bfloat16" in got["sent"], got["sent"]
        assert got["logits"].shape == ref.shape
        err = float((got["logits"] - ref).abs().max())
        assert err <= 2e-2 * float(ref.abs().max()), err
