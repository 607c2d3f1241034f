"""Datasets and the host batch pipeline — port of
``movae_tpu/data/__init__.py``.

The same dataset surface as the JAX package: cifar10/cifar100 (32 px),
imagenet, celeba-hq, oxford-flower-102 and afhq/animal-face (256 px),
celeba (64 px) and celeba-128, and ``synthetic[-<size>[-<n>]]``. Train
augmentation is a random horizontal flip (flowers add a random resized
crop); ``normalize`` maps images to [-1, 1]. Batches are numpy NHWC arrays
on the host, drawn with the JAX package's seeded numpy streams, so both
packages see the same batches bit for bit.

Real datasets come only from files already in place: the cifar pickles,
the celeba folder, or the ``<data_dir>/movae_cache/*.npy`` memmap archives
that either package writes. Where an archive is absent, HF ``datasets``
builds it when that package can be imported; otherwise the loader raises
and names the archive. Nothing is downloaded.
"""

from __future__ import annotations

import os
import pickle
from typing import Iterator, Optional, Tuple

import numpy as np

from movae_tpu_torch.data import native

Array = np.ndarray


class ArrayDataset:
    """In-memory (or memory-mapped) uint8 HWC images with per-batch
    transforms."""

    def __init__(self, images: Array, labels: Optional[Array] = None,
                 flip: bool = False, normalize: bool = False,
                 random_resized_crop: Optional[Tuple[int, float, float]] = None):
        if images.dtype != np.uint8 or images.ndim != 4:
            raise ValueError(f"ArrayDataset needs (N, H, W, C) uint8 images, "
                             f"got {images.dtype} {images.shape}")
        self.images = images
        self.labels = (labels if labels is not None
                       else np.zeros((len(images),), np.int64))
        self.flip = flip
        self.normalize = normalize
        self.random_resized_crop = random_resized_crop

    def __len__(self) -> int:
        return len(self.images)

    @property
    def input_size(self) -> int:
        return self.images.shape[1]

    def get_batch(self, idx: Array, rng: Optional[np.random.Generator] = None,
                  raw: bool = False) -> Tuple[Array, Array]:
        """Rows ``idx`` with the train transform drawn from ``rng`` (no
        flip without one). ``raw=True`` returns uint8 for the train step
        to cast on the device; otherwise float32."""
        if self.random_resized_crop is not None and rng is None:
            # the crop is part of the dataset's contract (flowers stores
            # 300-px archives for a 256-px model): never skip it
            rng = np.random.default_rng(0)
        if self.random_resized_crop is None:
            flip_mask = None
            if self.flip and rng is not None:
                flip_mask = (rng.random(len(idx)) < 0.5).astype(np.uint8)
            if raw:
                imgs = native.assemble_batch_raw(self.images, np.asarray(idx),
                                                 flip_mask)
            else:
                imgs = native.assemble_batch(self.images, np.asarray(idx),
                                             flip_mask, self.normalize)
            return imgs, self.labels[idx]
        imgs_u8 = _batch_random_resized_crop(
            self.images[idx], rng, *self.random_resized_crop)
        if self.flip and rng is not None:
            mask = rng.random(len(idx)) < 0.5
            imgs_u8[mask] = imgs_u8[mask, :, ::-1, :]
        if raw:
            return imgs_u8, self.labels[idx]
        imgs = imgs_u8.astype(np.float32) / 255.0
        if self.normalize:
            imgs = (imgs - 0.5) / 0.5
        return imgs, self.labels[idx]


def _batch_random_resized_crop(imgs_u8, rng, out_size, scale_lo, scale_hi):
    """RandomResizedCrop (bicubic) per image through PIL (the flowers
    transform)."""
    from PIL import Image

    out = np.empty((len(imgs_u8), out_size, out_size, imgs_u8.shape[-1]),
                   np.uint8)
    for i, im in enumerate(imgs_u8):
        h, w = im.shape[:2]
        area = h * w
        for _ in range(10):
            target = area * rng.uniform(scale_lo, scale_hi)
            ar = np.exp(rng.uniform(np.log(3 / 4), np.log(4 / 3)))
            cw = int(round(np.sqrt(target * ar)))
            ch = int(round(np.sqrt(target / ar)))
            if cw <= w and ch <= h:
                x0 = rng.integers(0, w - cw + 1)
                y0 = rng.integers(0, h - ch + 1)
                crop = im[y0:y0 + ch, x0:x0 + cw]
                break
        else:
            crop = im
        out[i] = np.asarray(Image.fromarray(crop).resize(
            (out_size, out_size), Image.BICUBIC))
    return out


class Loader:
    """Static-shape batch iterator: epoch ``e`` (counted from 0) walks
    ``default_rng((seed, e)).permutation(n)`` (or ``arange`` without
    ``shuffle``), and the same generator draws the batch's flips. The last
    batch is wrap-padded to ``batch_size`` and reports ``n_valid``."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 seed: int = 0, drop_last: bool = False, raw: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.raw = raw
        self.epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[Tuple[Array, Array, int]]:
        """Yields ``(images, labels, n_valid)``."""
        n = len(self.dataset)
        rng = np.random.default_rng((self.seed, self.epoch))
        order = rng.permutation(n) if self.shuffle else np.arange(n)
        self.epoch += 1
        bs = self.batch_size
        for start in range(0, n, bs):
            if self.drop_last and n - start < bs:
                return
            idx = order[start:start + bs]
            n_valid = len(idx)
            if n_valid < bs:
                # np.resize repeats the order cyclically, so sets smaller
                # than the pad still fill it
                idx = np.concatenate([idx, np.resize(order, bs - n_valid)])
            imgs, labels = self.dataset.get_batch(idx, rng, raw=self.raw)
            yield imgs, labels, n_valid


# ---------------------------------------------------------------------------
# dataset loaders
# ---------------------------------------------------------------------------

def _load_cifar10(data_dir: str):
    root = os.path.join(data_dir, "cifar-10-batches-py")
    if not os.path.isdir(root):
        raise FileNotFoundError(
            f"CIFAR-10 not found at {root}: place the standard python-pickle "
            "batches there, or use dataset 'synthetic-32' for smoke runs.")

    def load(names):
        xs, ys = [], []
        for name in names:
            with open(os.path.join(root, name), "rb") as f:
                d = pickle.load(f, encoding="bytes")
            xs.append(d[b"data"])
            ys.append(np.asarray(d[b"labels"], np.int64))
        x = np.concatenate(xs).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        return np.ascontiguousarray(x), np.concatenate(ys)

    return (load([f"data_batch_{i}" for i in range(1, 6)]),
            load(["test_batch"]))


def _load_cifar100(data_dir: str):
    root = os.path.join(data_dir, "cifar-100-python")
    if not os.path.isdir(root):
        raise FileNotFoundError(
            f"CIFAR-100 not found at {root}; use 'synthetic-32' for smoke "
            "runs.")

    def load(name):
        with open(os.path.join(root, name), "rb") as f:
            d = pickle.load(f, encoding="bytes")
        x = d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        return np.ascontiguousarray(x), np.asarray(d[b"fine_labels"], np.int64)

    return load("train"), load("test")


def _synthetic(size: int, n: int, seed: int = 0):
    """Deterministic structured fake images (smooth gradients + noise, so
    reconstruction losses are not degenerate) and labels."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    base = np.stack([xx, yy, 0.5 * (xx + yy)], -1)[None]
    imgs = (base * 255 * rng.uniform(0.3, 1.0, (n, 1, 1, 3))
            + rng.normal(0, 20, (n, size, size, 3)))
    labels = rng.integers(0, 10, n).astype(np.int64)
    return np.clip(imgs, 0, 255).astype(np.uint8), labels


def _materialize_memmap(path: str, n: int, item_fn):
    """Build (or reopen) an on-disk uint8 image archive with int64 labels,
    the JAX package's format: ``item_fn(i) -> (uint8 HWC image, label)``,
    written once with constant host memory, published by ``os.replace`` and
    served as a read-only memory map. Items whose shape differs from the
    first are bicubic-resized to it."""
    lbl_path = path + ".labels.npy"
    if os.path.exists(path) and os.path.exists(lbl_path):
        imgs = np.load(path, mmap_mode="r")
        labels = np.load(lbl_path)
        if len(imgs) == n and len(labels) == n:
            return imgs, labels
    os.makedirs(os.path.dirname(path), exist_ok=True)
    img0, lbl0 = item_fn(0)
    img0 = np.asarray(img0, np.uint8)
    tmp = f"{path}.tmp.{os.getpid()}.npy"
    lbl_tmp = f"{lbl_path}.tmp.{os.getpid()}.npy"
    out = np.lib.format.open_memmap(tmp, mode="w+", dtype=np.uint8,
                                    shape=(n,) + img0.shape)
    labels = np.zeros((n,), np.int64)
    out[0], labels[0] = img0, lbl0
    for i in range(1, n):
        img, lbl = item_fn(i)
        img = np.asarray(img, np.uint8)
        if img.shape != img0.shape:
            from PIL import Image
            img = np.asarray(Image.fromarray(img).resize(
                (img0.shape[1], img0.shape[0]), Image.BICUBIC), np.uint8)
        out[i], labels[i] = img, lbl
    out.flush()
    del out
    np.save(lbl_tmp, labels)
    os.replace(lbl_tmp, lbl_path)
    os.replace(tmp, path)
    return np.load(path, mmap_mode="r"), labels


def _archive_path(data_dir: str, repo: str, split: str,
                  out_size: Optional[int], center_crop: Optional[int],
                  limit: Optional[int], short_side: Optional[int]) -> str:
    """The JAX package's archive name for an HF split and its transform."""
    return os.path.join(
        data_dir, "movae_cache",
        f"{repo.replace('/', '_')}_{split}_{out_size or 0}"
        f"_{center_crop or 0}_{limit or 0}"
        + (f"_ss{short_side}" if short_side else "") + ".npy")


def _hf_images(repo: str, split: str, data_dir: str,
               out_size: Optional[int] = None,
               center_crop: Optional[int] = None,
               limit: Optional[int] = None,
               short_side: Optional[int] = None):
    """An HF image split as a uint8 memmap archive under
    ``<data_dir>/movae_cache``: opened where it exists, else built from the
    local HF ``datasets`` cache. ``short_side`` resizes the shorter side to
    N and center-crops an N-square (flowers, whose train transform crops
    later)."""
    cache = _archive_path(data_dir, repo, split, out_size, center_crop,
                          limit, short_side)
    if os.path.exists(cache) and os.path.exists(cache + ".labels.npy"):
        return np.load(cache, mmap_mode="r"), np.load(cache + ".labels.npy")
    try:
        from datasets import load_dataset
    except ImportError as e:
        raise FileNotFoundError(
            f"{repo} split {split!r}: no archive at {cache} (and its "
            f".labels.npy), and HF `datasets` cannot be imported to build "
            f"it ({e}). Place the archive there, or use a 'synthetic-*' "
            "dataset.") from e
    from PIL import Image

    ds = load_dataset(repo, split=split)
    n = len(ds) if limit is None else min(limit, len(ds))
    key = "image" if "image" in ds.column_names else ds.column_names[0]
    has_label = "label" in ds.column_names

    def item_fn(i):
        row = ds[i]  # one fetch: every ds[i] decodes the image again
        im = row[key]
        if not isinstance(im, Image.Image):
            im = Image.fromarray(np.asarray(im))
        im = im.convert("RGB")
        if short_side:
            w, h = im.size
            s = short_side / min(w, h)
            im = im.resize((max(short_side, round(w * s)),
                            max(short_side, round(h * s))), Image.BICUBIC)
            w, h = im.size
            left, top = (w - short_side) // 2, (h - short_side) // 2
            im = im.crop((left, top, left + short_side, top + short_side))
        if center_crop:
            w, h = im.size
            left, top = (w - center_crop) // 2, (h - center_crop) // 2
            im = im.crop((left, top, left + center_crop, top + center_crop))
        if out_size and im.size != (out_size, out_size):
            im = im.resize((out_size, out_size), Image.BICUBIC)
        label = row["label"] if has_label else 0
        return np.asarray(im, np.uint8), label

    return _materialize_memmap(cache, n, item_fn)


def _load_celeba_folder(data_dir: str, split: str, crop: int, out: int):
    """CelebA from the torchvision folder layout (``celeba/img_align_celeba``
    + ``celeba/list_eval_partition.txt``): center crop, bicubic resize,
    archived under ``movae_cache`` as the JAX package does."""
    from PIL import Image

    img_dir = os.path.join(data_dir, "celeba", "img_align_celeba")
    part_file = os.path.join(data_dir, "celeba", "list_eval_partition.txt")
    if not (os.path.isdir(img_dir) and os.path.isfile(part_file)):
        raise FileNotFoundError(
            f"CelebA not found under {os.path.join(data_dir, 'celeba')}: "
            "extract img_align_celeba/ and list_eval_partition.txt there "
            "(use 'synthetic-64' for smoke runs).")
    split_id = {"train": 0, "valid": 1, "test": 2}[split]
    names = []
    with open(part_file) as f:
        for line in f:
            fname, sid = line.split()
            if int(sid) == split_id:
                names.append(fname)

    def item_fn(i):
        im = Image.open(os.path.join(img_dir, names[i])).convert("RGB")
        w, h = im.size
        left, top = (w - crop) // 2, (h - crop) // 2
        im = im.crop((left, top, left + crop, top + crop))
        return np.asarray(im.resize((out, out), Image.BICUBIC), np.uint8), 0

    cache = os.path.join(data_dir, "movae_cache",
                         f"celeba_{split}_{crop}_{out}_{len(names)}.npy")
    return _materialize_memmap(cache, len(names), item_fn)


def dataset_input_size(dataset_name: str) -> int:
    """Image size for a dataset name without loading any file."""
    name = dataset_name.lower()
    if name.startswith("synthetic") or name.startswith("fake"):
        parts = name.split("-")
        return int(parts[1]) if len(parts) > 1 else 32
    if name in ("cifar10", "cifar100"):
        return 32
    if name == "celeba":
        return 64
    if name == "celeba-128":
        return 128
    return 256


def get_dataset(dataset_name: str, data_dir: str = "./data",
                normalize: bool = False):
    """Return ``(train_dataset, test_dataset, input_size)``."""
    name = dataset_name.lower()

    def pair(xtr, ytr, xte, yte, **train_kw):
        return (ArrayDataset(xtr, ytr, flip=True, normalize=normalize,
                             **train_kw),
                ArrayDataset(xte, yte, normalize=normalize))

    if name.startswith("synthetic") or name.startswith("fake"):
        parts = name.split("-")
        size = int(parts[1]) if len(parts) > 1 else 32
        n = int(parts[2]) if len(parts) > 2 else 512
        imgs, labels = _synthetic(size, n)
        timgs, tlabels = _synthetic(size, max(n // 4, 8), seed=1)
        return (*pair(imgs, labels, timgs, tlabels), size)
    if name == "cifar10":
        (xtr, ytr), (xte, yte) = _load_cifar10(data_dir)
        return (*pair(xtr, ytr, xte, yte), 32)
    if name == "cifar100":
        (xtr, ytr), (xte, yte) = _load_cifar100(data_dir)
        return (*pair(xtr, ytr, xte, yte), 32)
    if name == "imagenet":
        repo = "benjamin-paine/imagenet-1k-256x256"
        return (*pair(*_hf_images(repo, "train", data_dir),
                      *_hf_images(repo, "test", data_dir)), 256)
    if name in ("celeba", "celeba-128"):
        size = 64 if name == "celeba" else 128
        crop = 148 if name == "celeba" else 178
        return (*pair(*_load_celeba_folder(data_dir, "train", crop, size),
                      *_load_celeba_folder(data_dir, "test", crop, size)),
                size)
    if name == "celeba-hq":
        repo = "korexyz/celeba-hq-256x256"
        return (*pair(*_hf_images(repo, "train", data_dir),
                      *_hf_images(repo, "validation", data_dir)), 256)
    if name == "oxford-flower-102":
        # train and validation stored aspect-preserved (shorter side 300),
        # so the random resized crop samples undistorted content
        repo = "Donghyun99/Oxford-Flower-102"
        xtr, ytr = _hf_images(repo, "train", data_dir, short_side=300)
        xva, yva = _hf_images(repo, "validation", data_dir, short_side=300)
        xte, yte = _hf_images(repo, "test", data_dir, out_size=256)
        return (*pair(np.concatenate([xtr, xva]), np.concatenate([ytr, yva]),
                      xte, yte, random_resized_crop=(256, 0.7, 1.0)), 256)
    if name in ("animal-face", "afhq"):
        # the reference reuses the train split for test; the read-only
        # memmap is shared, not copied
        x, y = _hf_images("huggan/AFHQ", "train", data_dir, out_size=256)
        return (*pair(x, y, x, np.array(y)), 256)
    raise ValueError(f"Dataset {dataset_name} not supported")
