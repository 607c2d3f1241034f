"""The host side of the port's data-parallel runs: the loaders' per-rank
slices (data/__init__.py:Loader, data/device.py:DeviceData,
utils/codes.py:CodeLoader) against the JAX package's multi-host plans, the
tail trim of the loop, and, on 2 spawned gloo ranks, the per-rank code
cache with its all-or-none hit, the preemption flag agreed across ranks,
the gathered code set of the prior stage, and torchrun's environment in
init_distributed.

The JAX side's multi-host loaders are faked as its own tests fake them
(tests/test_device_data_multihost.py: jax.process_count/process_index
patched, one data shard a process).
"""

import os
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_port_parallel import spawn  # noqa: E402

N, B, SEED = 103, 16, 3


def _datasets(n=N, flip=False):
    from movae_tpu.data import ArrayDataset as JDS
    from movae_tpu_torch.data import ArrayDataset as TDS

    imgs = np.random.default_rng(0).integers(0, 256, (n, 8, 8, 3),
                                             dtype=np.uint8)
    return (JDS(imgs, flip=flip, random_resized_crop=None),
            TDS(imgs, flip=flip))


@pytest.mark.parametrize("n,bs,pc,drop_last", [
    (N, 8, 2, False), (N, 8, 2, True), (50, 4, 3, False), (7, 4, 2, False)])
def test_loader_slices_equal_jax_multihost_and_partition(n, bs, pc,
                                                         drop_last):
    """Every rank's batches equal the JAX loader's process slice (images,
    flips and n_valid, two epochs), every rank takes the same number of
    steps, and the ranks' valid rows of an epoch are the one-process
    epoch's rows."""
    from movae_tpu.data import Loader as JLoader
    from movae_tpu_torch.data import Loader

    jds, tds = _datasets(n, flip=True)
    steps, rows = [], []
    for pi in range(pc):
        kw = dict(shuffle=True, seed=SEED, drop_last=drop_last, raw=True,
                  process_index=pi, process_count=pc)
        jl, tl = JLoader(jds, bs, **kw), Loader(tds, bs, **kw)
        assert len(jl) == len(tl)
        for _ in range(2):
            got, want = list(tl), list(jl)
            assert len(got) == len(want)
            for (ti, _, tn), (ji, _, jn) in zip(got, want):
                assert tn == jn
                np.testing.assert_array_equal(ti, np.asarray(ji))
        steps.append(len(got))
        rows.append(sum(nv for _, _, nv in got))
    assert len(set(steps)) == 1
    one = list(Loader(tds, bs * pc, shuffle=True, seed=SEED,
                      drop_last=drop_last, raw=True))
    assert len(one) == steps[0]
    assert sum(rows) == sum(nv for _, _, nv in one)


def _device_data_pair(monkeypatch, pi, pc, n=N):
    import jax

    from movae_tpu.data.device import DeviceData as JDD
    from movae_tpu.parallel.mesh import DataParallel, make_mesh
    from movae_tpu_torch.data.device import DeviceData

    jds, tds = _datasets(n)
    monkeypatch.setattr(jax, "process_count", lambda: pc)
    monkeypatch.setattr(jax, "process_index", lambda: pi)
    monkeypatch.setattr(JDD, "_upload", lambda self: None)
    # one data shard a process, as the port holds one device a rank
    jdd = JDD(jds, DataParallel(make_mesh(num_data=pc,
                                          devices=jax.devices()[:pc])),
              B, seed=SEED)
    return jdd, DeviceData(tds, B, torch.device("cpu"), seed=SEED,
                           process_index=pi, process_count=pc)


@pytest.mark.parametrize("pc", [1, 2, 4])
def test_device_data_plans_equal_jax_multihost(monkeypatch, pc):
    """Each rank's plan equals the JAX multi-host plan of its process (full
    batches and the shared tail ids), the ranks' full-batch rows and the
    tail partition the set, and the tail walk gives every rank the same
    batch shapes, the JAX walk's rows."""
    plans, tails, walks = [], [], []
    for pi in range(pc):
        jdd, tdd = _device_data_pair(monkeypatch, pi, pc)
        assert tdd.steps == jdd.steps and tdd.tail_len == jdd.tail_len
        for epoch in (0, 1):
            (ti, tt), (ji, jt) = tdd.epoch_plan(epoch), jdd.epoch_plan(epoch)
            np.testing.assert_array_equal(ti, ji)
            np.testing.assert_array_equal(tt, jt)
        plans.append(tdd._ids(pi)[ti])
        tails.append(tt)
        got = list(tdd.tail_batches(tt, np.random.default_rng(0)))
        want = list(jdd.tail_batches(jt, np.random.default_rng(0)))
        assert len(got) == len(want)
        for (gi, gv), (wi, _) in zip(got, want):
            np.testing.assert_array_equal(gi, wi)
        walks.append([(gi.shape, gv) for gi, gv in got])
        # the device rows are the rank's own: its uploaded set
        np.testing.assert_array_equal(
            tdd.images_dev.numpy(), tdd.dataset.images[tdd._ids(pi)])
    assert all(np.array_equal(t, tails[0]) for t in tails)
    assert all(w == walks[0] for w in walks)
    ids = np.concatenate([p.ravel() for p in plans] + [tails[0]])
    assert sorted(ids.tolist()) == list(range(N))


@pytest.mark.parametrize("gv_case", [(16, 8, 2, 103, 6), (7, 4, 2, 103, 6),
                                     (7, 4, 2, 7, 0), (8, 8, 1, 103, 12)])
def test_trim_tail_equals_jax(gv_case):
    """The loop's tail trim equals the JAX loop's with one data shard a
    process."""
    from movae_tpu.train.loop import _trim_tail
    from movae_tpu_torch.train.loop import trim_tail

    bs, n_valid, pc, n_ds, i = gv_case
    imgs = np.zeros((bs, 2, 2, 3), np.uint8)
    gb = bs * pc
    got = trim_tail(imgs, i, n_valid, pc, n_ds, gb)
    want = _trim_tail(imgs, i, n_valid, pc, pc, n_ds, gb)
    assert got[0].shape == want[0].shape and got[1] == want[1]


def test_code_loader_slices_are_the_one_process_batches():
    """CodeLoader's per-rank slices of each global batch, interleaved, are
    the one-process loader's batches (the prior's data-parallel
    equality)."""
    from movae_tpu_torch.utils.codes import CodeLoader

    codes = {"codes": np.arange(21 * 4, dtype=np.int32).reshape(21, 2, 2)}
    one = list(CodeLoader(codes, 8, seed=SEED))
    ranks = [list(CodeLoader(codes, 4, seed=SEED, process_index=p,
                             process_count=2)) for p in range(2)]
    assert len(ranks[0]) == len(ranks[1]) == len(one) == 3
    for i, (batch, nv) in enumerate(one):
        both = np.empty_like(batch["codes"])
        for p in range(2):
            both[p::2] = ranks[p][i][0]["codes"]
            assert ranks[p][i][1] == nv
        np.testing.assert_array_equal(both, batch["codes"])


def _host_worker(rank, world, store, tmp):
    """On 2 gloo ranks: the code cache's per-rank key and all-or-none hit,
    the agreed preemption flag, the gathered code set."""
    from test_torch_port_parallel import join_group

    join_group(rank, world, store)
    from movae_tpu_torch.train.prior import gather_levels
    from movae_tpu_torch.utils.codes_cache import (cache_key,
                                                   get_or_extract_codes)
    from movae_tpu_torch.utils.preemption import PreemptionGuard

    out = {}
    calls = []
    imgs = np.full((6, 8, 8, 3), rank, np.float32)
    loader = [(imgs, np.zeros(6, np.int64), 6)]

    def extract(x):
        calls.append(len(x))
        return torch.full((len(x), 4, 4), int(x[0, 0, 0, 0]),
                          dtype=torch.int32)

    def get():
        return get_or_extract_codes(extract, loader, tmp, "vq_vae",
                                    "synthetic-8-6", 16, 8)

    out["first_hit"] = get()[1]
    if rank == 1:  # a partial earlier run: rank 1's cache is gone
        import shutil

        key = cache_key("vq_vae", "synthetic-8-6", 16, 8)
        shutil.rmtree(os.path.join(tmp, "codes_cache",
                                   f"{key}_p1of2"))
    out["partial_hit"] = get()[1]
    levels, out["full_hit"] = get()
    out["calls"] = list(calls)
    out["cached_value"] = int(np.asarray(levels["codes"]).max())
    dirs = sorted(os.listdir(os.path.join(tmp, "codes_cache")))
    out["cache_dirs"] = dirs

    guard = PreemptionGuard()
    out["quiet"] = guard.globally_triggered()
    if rank == 1:
        guard._flag = True
    out["signalled"] = guard.globally_triggered()
    guard.uninstall()

    # rank r extracted 5 - r rows: codes r*100 + i
    local = {"codes": (rank * 100 + np.arange(5 - rank, dtype=np.int32)
                       ).reshape(-1, 1, 1)}
    out["gathered"] = gather_levels(local)["codes"].reshape(-1).tolist()
    torch.save(out, os.path.join(tmp, f"out{rank}.pt"))
    torch.distributed.destroy_process_group()


@pytest.fixture(scope="module")
def host_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("host")
    seconds = spawn(_host_worker, str(tmp))
    print(f"2-rank gloo spawn and join: {seconds:.1f} s")
    return [torch.load(tmp / f"out{r}.pt", weights_only=False)
            for r in range(2)]


def test_codes_cache_is_per_rank_and_hits_only_when_every_rank_hits(
        host_runs):
    """Each rank writes its own cache (``_p{rank}of{world}``); when one
    rank's cache is missing every rank extracts again; when all hit, none
    extracts."""
    for rank, out in enumerate(host_runs):
        assert out["first_hit"] is False
        assert out["partial_hit"] is False
        assert out["full_hit"] is True
        assert out["calls"] == [6, 6]
        assert out["cached_value"] == rank
        assert [d[-6:] for d in out["cache_dirs"]] == ["_p0of2", "_p1of2"]


def test_preemption_is_agreed_across_ranks(host_runs):
    for out in host_runs:
        assert out["quiet"] is False and out["signalled"] is True


def test_gathered_codes_follow_the_loaders_interleave(host_runs):
    """Rank p's i-th code is global code i P + p: the one-process
    extraction's order, the ranks' counts differing by one."""
    want = [0, 100, 1, 101, 2, 102, 3, 103, 4]
    for out in host_runs:
        assert out["gathered"] == want


def test_init_distributed_reads_torchrun_environment(monkeypatch):
    """Without torchrun's WORLD_SIZE one process drives one device; the
    mesh then has one rank and make_mesh's validation is the JAX
    package's."""
    from movae_tpu_torch.parallel import mesh

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert mesh.init_distributed("cpu") == (0, 1)
    m = mesh.make_mesh(device="cpu")
    assert m.shape == {"data": 1, "model": 1, "seq": 1, "pipe": 1}
    assert m.device_mesh is None
    with pytest.raises(ValueError, match="must divide the device count"):
        mesh.make_mesh(num_model=3, devices=[0, 1], device="cpu")
    with pytest.raises(NotImplementedError, match="Queue 1 item 13"):
        mesh.make_mesh(num_model=2, devices=[0, 1], device="cpu")
    dp = mesh.DataParallel(m, fsdp=True)
    assert dp.pad_to_devices(5) == 5
    leaf = types.SimpleNamespace(ndim=2, shape=(64, 128),
                                 numel=lambda: 64 * 128)
    # one rank: nothing to shard
    assert dp.param_shardings({"w": leaf}) == {"w": None}


def test_fsdp_rule_is_jax_param_shardings():
    """The fsdp rule picks the dimension the JAX rule shards over 'data':
    a leaf of at least min_elems elements, its largest dimension divisible
    by dp; smaller leaves and indivisible ones stay whole."""
    import jax
    import jax.numpy as jnp

    from movae_tpu.parallel.mesh import DataParallel as JDP, make_mesh
    from movae_tpu_torch.parallel import mesh

    shapes = {"w": (8, 16), "b": (16,), "odd": (3, 5), "conv": (3, 3, 4, 8),
              "small": (4,)}
    jdp = JDP(make_mesh(num_data=4, devices=jax.devices()[:4]), fsdp=True)
    want = jdp.param_shardings({k: jnp.zeros(s) for k, s in shapes.items()},
                               min_elems=16)
    tdp = mesh.DataParallel(mesh.Mesh({"data": 4, "model": 1, "seq": 1,
                                       "pipe": 1}, torch.device("cpu")),
                            fsdp=True)
    got = tdp.param_shardings({k: torch.zeros(s) for k, s in shapes.items()},
                              min_elems=16)
    for k in shapes:
        spec = tuple(want[k].spec) if hasattr(want[k], "spec") else ()
        dim = next((i for i, a in enumerate(spec) if a == "data"), None)
        assert got[k] == dim, (k, got[k], spec)
