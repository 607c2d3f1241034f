"""Sample-parallel generation (movae_tpu_torch/parallel/context.py) and
data-parallel serving (serving.py ``data_parallel``) — the oracles of
tests/test_sample_parallel.py and tests/test_serving.py: the sharded
samplers draw the codes of the single-device sampler on one seed (every
rank draws the global batch's Gumbel noise and keeps its rows), a batch
the ranks do not divide runs whole, ``generate_samples`` over 2 ranks gives
one device's images on every rank, and a 2-replica serving answer equals
one replica's on the whole batch.

The samplers run on 2 spawned gloo ranks (one spawn for every case, a
FileStore rendezvous); the single-device references run in each rank too.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_port_parallel import join_group, spawn  # noqa: E402

K, D, GRID = 16, 4, 4


def _priors():
    from movae_tpu_torch.models.pixelcnn import (HierarchicalPixelCNN,
                                                 PixelCNN, PixelSNAIL)

    gen = torch.Generator().manual_seed(0)
    cnn = PixelCNN(num_embeddings=K, embedding_dim=D, hidden_channels=8,
                   num_layers=2)
    snail = PixelSNAIL(num_embeddings=K, embedding_dim=D, hidden_channels=8,
                       num_blocks=1, num_res_blocks_per_layer=1, num_heads=2,
                       dropout=0.0)
    hier = HierarchicalPixelCNN(num_embeddings=K, embedding_dim=D,
                                hidden_channels=8, num_layers=2)
    for m in (cnn, snail, hier):
        m.reset_parameters(gen)
        m.eval()
    return cnn, snail, hier


def _generate(model_args, prior, hierarchical, seed=5, num=8):
    import types

    from movae_tpu_torch.models import get_network, init_model
    from movae_tpu_torch.train.final_metrics import generate_samples

    vq = init_model(get_network(16, 3, model_args), 0, device="cpu").eval()
    args = types.SimpleNamespace(kv_cache_dtype="f32")
    return generate_samples(vq, args, {"model": prior,
                                       "hierarchical": hierarchical},
                            torch.Generator().manual_seed(seed), num,
                            batch=num)


def _sample_worker(rank, world, store, outdir):
    parallel = join_group(rank, world, store)
    from movae_tpu_torch.models.pixelcnn import (sample_fast,
                                                 sample_fast_snail,
                                                 sample_wavefront)
    from movae_tpu_torch.parallel.context import sample_parallel

    cnn, snail, hier = _priors()
    cases = {
        "sample_fast": lambda g, b: sample_fast(cnn, g, b, GRID, GRID),
        "sample_wavefront": lambda g, b: sample_wavefront(cnn, g, b, 6, 6),
        "sample_fast_snail_f32": lambda g, b: sample_fast_snail(
            snail, g, b, GRID, GRID, cache_dtype=torch.float32),
    }
    out = {}
    for name, fn in cases.items():
        for b in (8, 5):  # 5: the ranks do not divide it
            base = fn(torch.Generator().manual_seed(7), b)
            with sample_parallel(parallel.mesh):
                sharded = fn(torch.Generator().manual_seed(7), b)
            out[f"{name}-{b}"] = (base.numpy(), sharded.numpy())
    vq = dict(arch="vq_vae", embedding_dim=D, num_embeddings=K,
              hidden_dims=(8, 16), num_residual_layers=1)
    vq2 = dict(arch="vq_vae2", embedding_dim=D, num_embeddings=K,
               hidden_dims=(8, 16), num_residual_layers=1)
    # generate_samples installs sample parallelism over the ranks itself
    out["generate_samples-flat"] = _generate(vq, cnn, False)
    out["generate_samples-hierarchical"] = _generate(vq2, hier, True)
    torch.save(out, os.path.join(outdir, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


@pytest.fixture(scope="module")
def sampled(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sp")
    seconds = spawn(_sample_worker, str(tmp))
    print(f"2-rank gloo spawn and join: {seconds:.1f} s")
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False)
            for r in range(2)]


@pytest.mark.parametrize("name", ["sample_fast", "sample_wavefront",
                                  "sample_fast_snail_f32"])
@pytest.mark.parametrize("batch", [8, 5])
def test_sample_parallel_codes_equal_single_device(sampled, name, batch):
    """The sharded sampler's codes equal the single-device sampler's on one
    seed, bit for bit, on every rank (batch 5: not divided, run whole)."""
    for out in sampled:
        base, sharded = out[f"{name}-{batch}"]
        assert base.shape == (batch, *base.shape[1:])
        np.testing.assert_array_equal(base, sharded)
    np.testing.assert_array_equal(sampled[0][f"{name}-{batch}"][1],
                                  sampled[1][f"{name}-{batch}"][1])


@pytest.mark.parametrize("kind,model_args,hier", [
    ("flat", dict(arch="vq_vae"), False),
    ("hierarchical", dict(arch="vq_vae2"), True)])
def test_generate_samples_over_ranks_equals_one_device(sampled, kind,
                                                       model_args, hier):
    """generate_samples on 2 ranks (each sampling and decoding its rows,
    the chunk gathered) gives every rank the images of one process on one
    seed."""
    cnn, _, h = _priors()
    args = dict(model_args, embedding_dim=D, num_embeddings=K,
                hidden_dims=(8, 16), num_residual_layers=1)
    want = _generate(args, h if hier else cnn, hier)
    for out in sampled:
        got = out[f"generate_samples-{kind}"]
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_generate_samples_runs_under_deterministic_cudnn(monkeypatch):
    """generate_samples enters device.py:deterministic_cudnn once a call
    (so one seed repeats its images on the card)."""
    import contextlib

    from movae_tpu_torch.train import final_metrics

    entered = []

    @contextlib.contextmanager
    def counted():
        entered.append(True)
        yield

    monkeypatch.setattr(final_metrics, "deterministic_cudnn", counted)
    cnn, _, _ = _priors()
    _generate(dict(arch="vq_vae", embedding_dim=D, num_embeddings=K,
                   hidden_dims=(8, 16), num_residual_layers=1), cnn, False)
    assert len(entered) == 1


@pytest.mark.parametrize("arch", ["vq_vae", "vae"])
def test_two_replica_serving_equals_one_replica(tmp_path, arch):
    """An artifact exported with data_parallel=2 serves reconstruct,
    encode_codes and decode_codes on 2 replicas, each on half the batch;
    every answer equals the one-replica artifact's on the whole batch (the
    VAE's reconstruct draws its noise for the whole batch); sample stays
    one program; a batch of 3 is refused."""
    from test_torch_port_serving import export, port_model, uint8_images

    from movae_tpu_torch import serving

    tm = port_model(arch)
    export(tm, tmp_path / "one", data_parallel=1)
    man = export(tm, tmp_path / "two", data_parallel=2)
    one, two = (serving.load_serving(str(tmp_path / n))
                for n in ("one", "two"))
    x = uint8_images(4)
    fns = [f for f in ("reconstruct", "encode_codes", "decode_codes")
           if f in man["functions"]]
    for f in fns:
        assert man["functions"][f]["nr_devices"] == 2
        assert len(two[f].replicas) == 2
    if "sample" in man["functions"]:
        assert man["functions"]["sample"]["nr_devices"] == 1
    assert torch.equal(two["reconstruct"](x), one["reconstruct"](x))
    if "encode_codes" in fns:
        codes = one["encode_codes"](x)
        assert torch.equal(two["encode_codes"](x), codes)
        assert torch.equal(two["decode_codes"](codes),
                           one["decode_codes"](codes))
    with pytest.raises(ValueError, match="multiple of data_parallel=2"):
        two["reconstruct"](uint8_images(3))
