"""The port's data layer (``movae_tpu_torch/data``, ``utils/codes_cache.py``)
against the JAX package's on the same seeded numpy inputs: synthetic sets,
``dataset_input_size``, ``Loader`` batches over two epochs, the native
gather and its numpy twin, ``DeviceData``'s epoch plan and tail batches on
a one-device mesh, pre-placed archives, and a code cache that either
package writes and the other reads. Everything is compared bit for bit.
"""

import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from movae_tpu import data as jdata  # noqa: E402
from movae_tpu.data import native as jnative  # noqa: E402
from movae_tpu_torch import data as tdata  # noqa: E402
from movae_tpu_torch.data import native as tnative  # noqa: E402

# every dataset name configs/ uses, the others get_dataset knows, and the
# synthetic forms
DATASET_NAMES = ("cifar10", "cifar100", "celeba", "celeba-128", "celeba-hq",
                 "imagenet", "oxford-flower-102", "afhq", "animal-face",
                 "synthetic", "synthetic-64", "synthetic-48-100", "fake-16",
                 "CIFAR10")


@pytest.mark.parametrize("name", ["synthetic-32-64", "synthetic-16-21",
                                  "synthetic", "fake-8-3"])
@pytest.mark.parametrize("normalize", [False, True])
def test_synthetic_sets_equal_jax(name, normalize):
    jtr, jte, jsize = jdata.get_dataset(name, normalize=normalize)
    ttr, tte, tsize = tdata.get_dataset(name, normalize=normalize)
    assert tsize == jsize
    for j, t in ((jtr, ttr), (jte, tte)):
        np.testing.assert_array_equal(t.images, j.images)
        np.testing.assert_array_equal(t.labels, j.labels)
        assert (t.flip, t.normalize) == (j.flip, j.normalize)


@pytest.mark.parametrize("name", DATASET_NAMES)
def test_dataset_input_size_matches_jax(name):
    assert tdata.dataset_input_size(name) == jdata.dataset_input_size(name)


def _pair_sets(n=21, size=8, flip=True, normalize=False, seed=3):
    imgs = np.random.default_rng(seed).integers(
        0, 256, (n, size, size, 3), dtype=np.uint8)
    labels = np.arange(n, dtype=np.int64)
    return (jdata.ArrayDataset(imgs, labels, flip=flip, normalize=normalize),
            tdata.ArrayDataset(imgs, labels, flip=flip, normalize=normalize))


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("raw", [False, True])
@pytest.mark.parametrize("flip,normalize", [(True, False), (False, True),
                                            (True, True)])
def test_loader_batches_equal_jax(shuffle, raw, flip, normalize):
    """Two epochs: batches, labels and n_valid bit for bit, the last batch
    of each wrap-padded (21 images, batch 8)."""
    jds, tds = _pair_sets(flip=flip, normalize=normalize)
    jl = jdata.Loader(jds, 8, shuffle=shuffle, seed=5, raw=raw)
    tl = tdata.Loader(tds, 8, shuffle=shuffle, seed=5, raw=raw)
    assert len(tl) == len(jl) == 3
    for _ in range(2):
        got, want = list(tl), list(jl)
        assert len(got) == len(want)
        for (ti, tlab, tn), (ji, jlab, jn) in zip(got, want):
            assert ti.dtype == ji.dtype
            np.testing.assert_array_equal(ti, ji)
            np.testing.assert_array_equal(tlab, jlab)
            assert tn == jn
        assert [n for _, _, n in got] == [8, 8, 5]


def test_loader_drop_last_and_tiny_set():
    """drop_last drops the tail; a set smaller than the batch wraps."""
    for n, drop in ((21, True), (3, False)):
        jds, tds = _pair_sets(n=n)
        got = list(tdata.Loader(tds, 8, shuffle=True, drop_last=drop))
        want = list(jdata.Loader(jds, 8, shuffle=True, drop_last=drop))
        assert [g[2] for g in got] == [w[2] for w in want]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[0], w[0])


def test_native_gather_equals_jax_and_numpy_twin():
    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 256, (10, 6, 5, 3), dtype=np.uint8)
    idx = rng.integers(0, 10, 7)
    mask = (rng.random(7) < 0.5).astype(np.uint8)
    # a Fortran-ordered copy takes the numpy twin
    twin = np.asfortranarray(imgs)
    for fm in (None, mask):
        want = jnative.assemble_batch_raw(imgs, idx, fm)
        np.testing.assert_array_equal(
            tnative.assemble_batch_raw(imgs, idx, fm), want)
        np.testing.assert_array_equal(
            tnative.assemble_batch_raw(twin, idx, fm), want)
        for norm in (False, True):
            want = jnative.assemble_batch(imgs, idx, fm, norm)
            np.testing.assert_array_equal(
                tnative.assemble_batch(imgs, idx, fm, norm), want)
            np.testing.assert_allclose(
                tnative.assemble_batch(twin, idx, fm, norm), want,
                rtol=0, atol=1e-6)
    codes = rng.integers(0, 512, (9, 4, 4)).astype(np.int32)
    np.testing.assert_array_equal(tnative.gather_codes(codes, idx % 9),
                                  jnative.gather_codes(codes, idx % 9))


def _one_device_parallel():
    from types import SimpleNamespace

    from movae_tpu.parallel.mesh import make_mesh

    return SimpleNamespace(mesh=make_mesh(devices=jax.devices()[:1]))


@pytest.mark.parametrize("n,batch", [(21, 8), (24, 8), (5, 8)])
def test_device_data_plan_equals_jax(n, batch):
    """``epoch_plan`` (rows of the full batches, leftovers) and the tail's
    host batches equal the JAX package's on a one-device mesh; the card
    gather (here on the CPU, flips off) returns the planned rows."""
    from movae_tpu.data.device import DeviceData as JDD
    from movae_tpu_torch.data.device import DeviceData

    jds, tds = _pair_sets(n=n)
    jdd = JDD(jds, _one_device_parallel(), batch, seed=4)
    tdd = DeviceData(tds, batch, torch.device("cpu"), seed=4)
    assert (tdd.steps, tdd.tail_len, tdd.tail_steps) == (
        jdd.steps, jdd.tail_len, jdd.tail_steps)
    assert tdd.optimizer_steps_per_epoch() == jdd.optimizer_steps_per_epoch()
    for epoch in (1, 2, 3):
        tidx, ttail = tdd.epoch_plan(epoch)
        jidx, jtail = jdd.epoch_plan(epoch)
        assert tidx.dtype == jidx.dtype == np.int32
        np.testing.assert_array_equal(tidx, jidx)
        np.testing.assert_array_equal(ttail, jtail)
        trng = np.random.default_rng((4, epoch, 1 << 20))
        jrng = np.random.default_rng((4, epoch, 1 << 20))
        got = list(tdd.tail_batches(ttail, trng))
        want = list(jdd.tail_batches(jtail, jrng))
        assert [g[1] for g in got] == [w[1] for w in want]
        for (gi, _), (wi, _) in zip(got, want):
            np.testing.assert_array_equal(gi, wi)
        tdd.flip = False
        for row, b in zip(tidx, tdd.batches(tidx, None)):
            np.testing.assert_array_equal(b.numpy(), tds.images[row])


def test_device_data_flip_mirrors_rows():
    """With flips on, every gathered row is its image or its mirror."""
    from movae_tpu_torch.data.device import DeviceData

    _, tds = _pair_sets(n=16)
    dd = DeviceData(tds, 8, torch.device("cpu"), seed=0)
    idx, _ = dd.epoch_plan(1)
    gen = torch.Generator().manual_seed(0)
    flipped = 0
    for row, b in zip(idx, dd.batches(idx, gen)):
        for r, img in zip(row, b.numpy()):
            same = np.array_equal(img, tds.images[r])
            mirror = np.array_equal(img, tds.images[r][:, ::-1])
            assert same or mirror
            flipped += (not same)
    assert 0 < flipped < 16


def test_device_data_resolution(monkeypatch):
    """Auto stays on the host loader off the card; --no_device_data wins;
    --device_data forces it; the flowers crop is refused."""
    from types import SimpleNamespace

    from movae_tpu_torch.data.device import DeviceData, resolve_device_data

    _, tds = _pair_sets(n=16)
    cpu = torch.device("cpu")
    assert resolve_device_data(SimpleNamespace(), tds, 8, cpu) is None
    assert resolve_device_data(SimpleNamespace(device_data=True,
                                               no_device_data=True),
                               tds, 8, cpu) is None
    assert isinstance(resolve_device_data(SimpleNamespace(device_data=True),
                                          tds, 8, cpu), DeviceData)
    tds.random_resized_crop = (8, 0.7, 1.0)
    with pytest.raises(ValueError, match="RandomResizedCrop"):
        resolve_device_data(SimpleNamespace(device_data=True), tds, 8, cpu)


def test_preplaced_archive_is_read_and_missing_one_named(tmp_path,
                                                         monkeypatch):
    """A ``movae_cache`` archive written by the JAX package is what the
    port serves for an HF dataset; without one (and without HF
    ``datasets``) the port raises naming the archive path."""
    rng = np.random.default_rng(1)
    items = [(rng.integers(0, 256, (4, 4, 3), dtype=np.uint8), i)
             for i in range(6)]
    for split in ("train", "validation"):
        path = str(tmp_path / "movae_cache"
                   / f"korexyz_celeba-hq-256x256_{split}_0_0_0.npy")
        jdata._materialize_memmap(path, 6, lambda i: items[i])
    ttr, tte, size = tdata.get_dataset("celeba-hq", data_dir=str(tmp_path))
    jtr, jte, _ = jdata.get_dataset("celeba-hq", data_dir=str(tmp_path))
    assert size == 256
    np.testing.assert_array_equal(ttr.images, jtr.images)
    np.testing.assert_array_equal(tte.labels, jte.labels)

    monkeypatch.setitem(sys.modules, "datasets", None)
    with pytest.raises(FileNotFoundError,
                       match="benjamin-paine_imagenet-1k-256x256_train"):
        tdata.get_dataset("imagenet", data_dir=str(tmp_path))
    with pytest.raises(FileNotFoundError, match="celeba"):
        tdata.get_dataset("celeba", data_dir=str(tmp_path))
    with pytest.raises(FileNotFoundError, match="cifar-10-batches-py"):
        tdata.get_dataset("cifar10", data_dir=str(tmp_path))


def test_code_cache_read_across_packages(tmp_path):
    """The same key, and a cache written by either package is read by the
    other; a sweep over a loader keeps valid rows only, as JAX's does."""
    from movae_tpu.utils import codes_cache as jcc
    from movae_tpu_torch.utils import codes_cache as tcc

    assert tcc.cache_key("vq_vae2", "celeba-hq", 512, 256) == jcc.cache_key(
        "vq_vae2", "celeba-hq", 512, 256)
    rng = np.random.default_rng(2)
    levels = {"top": rng.integers(0, 16, (5, 2, 2)).astype(np.int32),
              "bottom": rng.integers(0, 16, (5, 4, 4)).astype(np.int32)}
    for writer, reader in ((tcc, jcc), (jcc, tcc)):
        root = str(tmp_path / writer.__name__)
        writer.CodeCache(root).write(levels, {"arch": "vq_vae2"})
        got = reader.CodeCache(root)
        assert got.exists() and len(got) == 5
        for k, v in got.open().items():
            np.testing.assert_array_equal(v, levels[k])

    jds, tds = _pair_sets(n=21)

    def extract(imgs):
        x = np.asarray(imgs, np.int64)
        return (x[..., 0] % 16).astype(np.int32)

    t_levels, t_hit = tcc.get_or_extract_codes(
        lambda b: torch.from_numpy(extract(b)),
        tdata.Loader(tds, 8, shuffle=True, seed=1, raw=True),
        str(tmp_path / "t"), "vq_vae", "synthetic-8-21", 16, 8)
    j_levels, j_hit = jcc.get_or_extract_codes(
        extract, jdata.Loader(jds, 8, shuffle=True, seed=1, raw=True),
        str(tmp_path / "j"), "vq_vae", "synthetic-8-21", 16, 8)
    assert not t_hit and not j_hit
    np.testing.assert_array_equal(t_levels["codes"], j_levels["codes"])
    again, hit = tcc.get_or_extract_codes(
        None, None, str(tmp_path / "j"), "vq_vae", "synthetic-8-21", 16, 8)
    assert hit
    np.testing.assert_array_equal(again["codes"], j_levels["codes"])
