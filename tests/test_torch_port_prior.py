"""Port prior training (movae_tpu_torch/train/prior.py) in lockstep with the
JAX package's ``train_prior`` (movae_tpu/train/prior.py), set up as
scripts/prior_equivalence_study.py sets up its movae side: frozen code
levels handed over as ``results["prior_levels"]``, the per-step CE captured
in ``prior_step_trace``, the prior initialized from ``PRNGKey(seed + 1)``
(exactly what ``_train_prior_impl`` derives) and loaded into the port,
dropout 0 and Adam eps 1e-4 on both sides."""

import argparse
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

K, D, HC, GRID = 32, 8, 16, 6
N, BS, SEED, EPOCHS = 20, 8, 0, 2  # 3 batches per epoch, the last ragged


def make_codes(seed=7):
    """Spatially correlated code grids (smoothed noise binned into K)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N, GRID + 2, GRID + 2))
    sm = (x[:, :-2, :-2] + x[:, 1:-1, :-2] + x[:, :-2, 1:-1]
          + 2 * x[:, 1:-1, 1:-1])
    q = ((sm - sm.min()) / (np.ptp(sm) + 1e-9) * K).astype(np.int32)
    return {"codes": np.clip(q, 0, K - 1)[:, :GRID, :GRID]}


def prior_args(kind, **kw):
    args = argparse.Namespace(
        arch="vq_vae", dataset="synthetic-prior-study", dataset_size=N,
        batch_size=BS, num_workers=0, seed=SEED, prior_type=kind,
        pixelcnn_epochs=EPOCHS, pixelcnn_hidden_channels=HC,
        pixelcnn_num_layers=3, pixelcnn_lr=3e-4, pixelcnn_temperature=1.0,
        pixelcnn_adam_eps=1e-4, prior_use_lmdb_codes=False,
        prior_sample_every=0, input_size=4 * GRID,
        pixelsnail_num_blocks=2, pixelsnail_num_res_blocks=1,
        pixelsnail_num_heads=2, pixelsnail_dropout=0.0)
    for k, v in kw.items():
        setattr(args, k, v)
    return args


def run_jax(kind, levels, tmp_path, **kw):
    from movae_tpu.parallel.mesh import DataParallel, make_mesh
    from movae_tpu.train import checkpoint as ckpt_lib
    from movae_tpu.train.prior import build_prior, train_prior

    args = prior_args(kind, **kw)
    prior = build_prior(args, K, False, D)
    rng = jax.random.PRNGKey(SEED + 1)
    init = prior.init({"params": rng, "dropout": rng},
                      jnp.zeros((2, GRID, GRID), jnp.int32),
                      train=False)["params"]
    trace = []
    stub = types.SimpleNamespace(num_embeddings=K, embedding_dim=D,
                                 input_size=4 * GRID)
    results = dict(model=stub, state=None, save_root=str(tmp_path),
                   parallel=DataParallel(make_mesh()), train_loader=None,
                   prior_levels=levels, prior_step_trace=trace)
    out = train_prior(results, args)
    final = ckpt_lib.load_checkpoint(
        ckpt_lib.final_prior_path(str(tmp_path), kind))
    as_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return (as_np(init), trace, as_np(out["params"]),
            as_np(final["model_state_dict"]["params"]))


@pytest.mark.parametrize("kind,ce_tol", [("pixelcnn", 1e-4),
                                         ("pixelsnail", 1e-3)])
def test_train_prior_locksteps_with_jax(kind, ce_tol, tmp_path):
    """Per-step CE within 1e-4 (pixelcnn) / 1e-3 (pixelsnail) relative and
    final parameters within 1e-3 — the bounds of
    tests/test_prior_lockstep.py."""
    from movae_tpu_torch.train.prior import build_prior, train_prior
    from movae_tpu_torch.utils import weights

    levels = make_codes()
    init, j_trace, j_best, j_final = run_jax(kind, levels, tmp_path)
    to_sd = getattr(weights, f"{kind}_state_dict")

    args = prior_args(kind)
    prior = build_prior(args, K, False, D)
    weights.load_jax_prior_params(prior, init)
    t_trace = []
    meta = types.SimpleNamespace(num_embeddings=K, embedding_dim=D)
    out = train_prior(levels, meta, args, device="cpu", step_trace=t_trace,
                      prior=prior)
    assert out["hierarchical"] is False and out["model"] is prior

    assert len(t_trace) == len(j_trace) == EPOCHS * 3
    rel = np.abs(np.array(t_trace) - np.array(j_trace)) / np.abs(j_trace)
    assert rel.max() < ce_tol, (t_trace, j_trace)
    for got, ref in ((prior.state_dict(), to_sd(j_final)),
                     (out["params"], to_sd(j_best))):
        assert set(got) == set(ref)
        delta = max(float(np.abs(got[k].numpy() - ref[k]).max())
                    for k in ref)
        assert delta < 1e-3, delta


@pytest.mark.parametrize("kw,item", [
    (dict(context_parallel=2), "must divide the device count"),
    (dict(pipeline_parallel=2), "must divide the device count"),
    (dict(pipeline_parallel=2, context_parallel=2),
     "composes with 'data' only")])
def test_unported_options_name_roadmap_item(kw, item):
    """Context and pipeline parallelism run since ROADMAP.md Queue 1 item
    13 was ported; the JAX package's refusals remain, with its error
    class (ValueError): sizes that do not divide the ranks (one process
    here) and the pipeline with context parallelism."""
    from movae_tpu_torch.train.prior import train_prior

    meta = types.SimpleNamespace(num_embeddings=K, embedding_dim=D)
    with pytest.raises(ValueError, match=item):
        train_prior(make_codes(), meta, prior_args("pixelsnail", **kw),
                    device="cpu")


@pytest.mark.parametrize("kind,kw,updates", [
    ("pixelcnn", dict(grad_accum=2), 2),
    ("pixelsnail", dict(compute_dtype="bfloat16"), 3)])
def test_item6_options_run_on_the_cpu(kind, kw, updates):
    """grad_accum and bf16 compute train the prior on the CPU for one
    epoch: 3 batches (the last ragged) make 2 updates under grad_accum 2
    (the two full batches accumulated, the ragged one alone) and 3
    otherwise; the losses are finite and the parameters stay float32."""
    from movae_tpu_torch.train.prior import train_prior

    meta = types.SimpleNamespace(num_embeddings=K, embedding_dim=D)
    trace = []
    out = train_prior(make_codes(), meta,
                      prior_args(kind, pixelcnn_epochs=1, **kw),
                      device="cpu", step_trace=trace)
    assert len(trace) == updates and np.isfinite(trace).all()
    want = torch.bfloat16 if kw.get("compute_dtype") else torch.float32
    assert out["model"].compute_dtype == want
    assert all(p.dtype == torch.float32 for p in out["model"].parameters())


@pytest.mark.parametrize("kw", [dict(grad_accum=2),
                                dict(steps_per_dispatch=2)])
def test_train_prior_accum_and_dispatch_lockstep_with_jax(kw, tmp_path):
    """The JAX ``train_prior``'s accumulating and scanned prior steps on the
    same codes: per-step (per-update) CE within 1e-4 relative and the
    final parameters within 1e-3, the bounds of the plain lockstep above.
    Under grad_accum the cosine counts optimizer steps on both sides."""
    from movae_tpu_torch.train.prior import build_prior, train_prior
    from movae_tpu_torch.utils import weights

    levels = make_codes()
    init, j_trace, _, j_final = run_jax("pixelcnn", levels, tmp_path, **kw)
    args = prior_args("pixelcnn", **kw)
    prior = build_prior(args, K, False, D)
    weights.load_jax_prior_params(prior, init)
    t_trace = []
    meta = types.SimpleNamespace(num_embeddings=K, embedding_dim=D)
    train_prior(levels, meta, args, device="cpu", step_trace=t_trace,
                prior=prior)
    per_epoch = 2 if kw.get("grad_accum") else 3
    assert len(t_trace) == len(j_trace) == EPOCHS * per_epoch
    rel = np.abs(np.array(t_trace) - np.array(j_trace)) / np.abs(j_trace)
    assert rel.max() < 1e-4, (t_trace, j_trace)
    ref = weights.pixelcnn_state_dict(j_final)
    got = prior.state_dict()
    assert max(float(np.abs(got[k].numpy() - ref[k]).max())
               for k in ref) < 1e-3


def test_grad_accum_with_steps_per_dispatch_raises_value_error(tmp_path):
    """As in the JAX package's train_prior."""
    from movae_tpu_torch.train.prior import train_prior

    kw = dict(grad_accum=2, steps_per_dispatch=2)
    meta = types.SimpleNamespace(num_embeddings=K, embedding_dim=D)
    with pytest.raises(ValueError, match="mutually exclusive"):
        train_prior(make_codes(), meta, prior_args("pixelcnn", **kw),
                    device="cpu")
    with pytest.raises(ValueError, match="mutually exclusive"):
        run_jax("pixelcnn", make_codes(), tmp_path, **kw)


def test_hierarchical_prior_and_save_root_name_roadmap_items(tmp_path):
    """build_prior(hierarchical=True) builds the two-level prior of the
    prior type; a save_root gets the reference's prior checkpoints."""
    from movae_tpu_torch.models.pixelcnn import (HierarchicalPixelCNN,
                                                 HierarchicalPixelSNAIL)
    from movae_tpu_torch.train.prior import build_prior, train_prior

    snail = build_prior(prior_args("pixelsnail"), K, hierarchical=True,
                        embedding_dim=D)
    assert isinstance(snail, HierarchicalPixelSNAIL)
    assert len(snail.prior_top.blocks) == 2
    assert len(snail.prior_bottom.res_blocks) == 3
    cnn = build_prior(prior_args("pixelcnn"), K, hierarchical=True,
                      embedding_dim=D)
    assert isinstance(cnn, HierarchicalPixelCNN)
    assert cnn.prior_bottom.conditional_channels == D
    meta = types.SimpleNamespace(num_embeddings=K, embedding_dim=D)
    out = train_prior(make_codes(), meta, prior_args("pixelcnn"),
                      device="cpu", save_root=str(tmp_path))
    ckpts = tmp_path / "pixelcnn_prior" / "checkpoints"
    for name in ("best_prior", "final_prior", "last_prior"):
        payload = torch.load(ckpts / f"{name}.pth", weights_only=False)
        assert set(payload["model_state_dict"]) == set(out["params"])


def test_build_prior_follows_jax_defaults():
    """The flat priors get the JAX package's widths and defaults."""
    from movae_tpu.train.prior import build_prior as jbuild
    from movae_tpu_torch.train.prior import build_prior

    for kind in ("pixelcnn", "pixelsnail"):
        args = argparse.Namespace(prior_type=kind)
        jm, tm = jbuild(args, 512, False, 64), build_prior(args, 512, False,
                                                            64)
        assert tm.embedding_dim == jm.embedding_dim == 64
        assert tm.hidden_channels == jm.hidden_channels
        if kind == "pixelsnail":
            assert len(tm.blocks) == jm.num_blocks == 8
            assert tm.dropout == jm.dropout == 0.1
            att = tm.blocks[0].attention
            assert att.num_heads == jm.num_heads == 8
            assert att.attn_dropout_mode == jm.attn_dropout_mode == "output"
            assert len(tm.blocks[0].res_blocks) == jm.num_res_blocks_per_layer
        else:
            assert len(tm.res_blocks) == jm.num_layers == 15


@pytest.mark.parametrize("normalize", [False, True])
def test_extract_codes_matches_jax(normalize):
    """uint8 images through the frozen VQ-VAE: the same code grids as the
    JAX package's extract_codes, as (B, h, w) int32."""
    from movae_tpu.models import get_network as jget, init_model as jinit
    from movae_tpu.train.prior import extract_codes as jextract
    from movae_tpu_torch.models import get_network, init_model
    from movae_tpu_torch.train.prior import extract_codes
    from movae_tpu_torch.utils.weights import load_jax_params

    vq = dict(arch="vq_vae", embedding_dim=D, num_embeddings=K,
              hidden_dims=(8, 16), num_residual_layers=1)
    jm = jget(16, 3, vq)
    params, bstats = jinit(jm, jax.random.PRNGKey(2), 16, 3)
    tm = init_model(get_network(16, 3, vq), 0, device="cpu")
    load_jax_params(tm, jax.tree_util.tree_map(np.asarray, params),
                    jax.tree_util.tree_map(np.asarray, bstats))
    imgs = np.random.default_rng(4).integers(0, 256, (3, 16, 16, 3),
                                             dtype=np.uint8)
    state = types.SimpleNamespace(params=params, batch_stats=bstats)
    want = np.asarray(jextract(jm, state, False, normalize)(imgs))
    got = extract_codes(tm, normalize)(imgs)
    assert got.dtype == torch.int32 and got.shape == (3, 4, 4)
    np.testing.assert_array_equal(got.numpy(), want)
