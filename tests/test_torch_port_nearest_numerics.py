"""The arithmetic of the nearest-code kernel, emulated on the CPU.

``movae_tpu_torch/kernels/nearest_code.cu`` computes ||e||^2 by a float32
``fmaf`` chain over the dims in ascending order, z e^T on the tensor cores
in split TF32 (x = big + small, each rounded to nearest TF32, and a b ~
a_small b_big + a_big b_small + a_big b_big, summed in float32), and
dist = ||e||^2 - 2 dot in float32. Each of the 4 lanes of a row keeps a
running (min, index) over its codes 2t, 2t + 1 of every 8, with a strict
'<' while the codes ascend and (+inf, 0) to start; then the lanes merge by
(distance, index) with the shuffles xor 1, then xor 2.

The CUDA kernel runs only on the card (``chip_smoke.py`` holds it against
the plain version there). This file emulates its arithmetic in torch and
holds it against the float64 argmin, which it must equal except on near
ties (``chip_smoke.py:compare_nearest``'s gap rule); on duplicated codebook
rows it must pick the lowest index of each group, and on rows of NaN or inf
an index in range.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from movae_tpu_torch.kernels import nearest_code as nc  # noqa: E402

# chip_smoke.py:compare_nearest: a near tie is a top-two float64 gap below
# NEAR_TIE * (1 + |d|)
NEAR_TIE = 1e-5


def tf32(x):
    """Round float32 to TF32, to nearest with ties away from zero
    (``cvt.rna.tf32.f32``), on the int32 view."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def mm3(a, b):
    """a @ b in split TF32: the two cross terms, then big x big."""
    ab, bb = tf32(a), tf32(b)
    as_, bs = tf32(a - ab), tf32(b - bb)
    return as_ @ bb + ab @ bs + ab @ bb


def code_norms(cb):
    """||e||^2 by the kernel's chain, s = fmaf(e[i], e[i], s), i ascending
    (a float32 product is exact in float64, so each step rounds once)."""
    cb64 = cb.double()
    s = torch.zeros(cb.shape[0], dtype=torch.float64)
    for i in range(cb.shape[1]):
        s = (cb64[:, i] * cb64[:, i] + s).float().double()
    return s.float()


def emulated_nearest(z, cb):
    """(N,) indices as the kernel computes them."""
    dist = code_norms(cb)[None, :] - 2.0 * mm3(z, cb.T)
    codes = torch.arange(cb.shape[0])
    inf = float("inf")
    # a NaN distance never passes the strict '<'
    dist = torch.where(torch.isnan(dist), inf, dist)
    best, idx = [], []
    for t in range(4):  # lane t: codes 2t, 2t + 1 of every 8
        lane = (codes % 8) // 2 == t
        d = torch.where(lane[None, :], dist, inf)
        b = d.min(1).values
        # the first code that beat the running minimum, starting at +inf
        hit = lane[None, :] & (d == b[:, None]) & (b[:, None] < inf)
        best.append(b)
        idx.append(torch.where(hit.any(1), hit.int().argmax(1),
                               torch.zeros_like(b, dtype=torch.long)))
    for m in (1, 2):
        merged = []
        for t in range(4):
            o = t ^ m
            take = (best[o] < best[t]) | ((best[o] == best[t])
                                          & (idx[o] < idx[t]))
            merged.append((torch.where(take, best[o], best[t]),
                           torch.where(take, idx[o], idx[t])))
        best, idx = [b for b, _ in merged], [i for _, i in merged]
    return idx[0]  # lane 0 writes the row's index


def near_tie_rows(z, cb):
    """The float64 argmin and the rows whose top-two gap is a near tie."""
    z64, cb64 = z.double(), cb.double()
    dist = (cb64 * cb64).sum(1)[None, :] - 2.0 * z64 @ cb64.T
    top2 = dist.topk(2, dim=1, largest=False).values
    return dist.argmin(1), (top2[:, 1] - top2[:, 0]) < NEAR_TIE * (
        1.0 + top2[:, 0].abs())


def _inputs(seed, n, k, d):
    rng = np.random.default_rng(seed)
    return (torch.tensor(rng.normal(size=(n, d)).astype(np.float32)),
            torch.tensor(rng.normal(size=(k, d)).astype(np.float32)))


# the stage-1 shape cut in N, a K that is no multiple of the kernel's
# chunk of 64 codes, and every head dim the kernel is built for
@pytest.mark.parametrize("n,k,d", [(2048, 512, 64), (1000, 500, 8),
                                   (512, 512, 16), (512, 300, 32),
                                   (777, 1000, 128), (4096, 64, 8)])
def test_emulated_nearest_equals_float64_argmin_except_near_ties(n, k, d):
    z, cb = _inputs(n + k + d, n, k, d)
    got = emulated_nearest(z, cb)
    want, near = near_tie_rows(z, cb)
    assert got.shape == (n,) and ((got >= 0) & (got < k)).all()
    off = got != want
    assert not (off & ~near).any(), (
        f"{int((off & ~near).sum())} rows off the float64 argmin beyond a "
        f"near tie")
    # and so the plain version, on the same rule
    plain = nc.nearest_code_plain(z, cb).long()
    assert not ((got != plain) & ~near).any()


def test_emulated_nearest_duplicated_rows_lowest_index():
    rng = np.random.default_rng(7)
    groups, k, d = 32, 256, 64
    base = rng.normal(size=(groups, d)).astype(np.float32)
    owner = rng.integers(0, groups, size=k)
    cb = torch.tensor(base[owner])
    z = torch.tensor((base[rng.integers(0, groups, size=1024)]
                      + 0.3 * rng.normal(size=(1024, d))).astype(np.float32))
    # every member of a group has a bit-identical norm
    norms = code_norms(cb)
    for gi in range(groups):
        assert len(set(norms[owner == gi].tolist())) <= 1
    lowest = torch.tensor([int(np.flatnonzero(owner == o)[0])
                           for o in owner])
    got = emulated_nearest(z, cb)
    assert (lowest[got] == got).all()
    plain = nc.nearest_code_plain(z, cb).long()
    assert (lowest[plain] == plain).all()


def test_emulated_nearest_nan_and_inf_rows_stay_in_range():
    z, cb = _inputs(11, 8, 100, 16)
    z[0] = float("nan")
    z[1, 3] = float("nan")
    z[2] = float("inf")
    z[3, 0] = -float("inf")
    got = emulated_nearest(z, cb)
    assert ((got >= 0) & (got < cb.shape[0])).all()
    # a row whose every distance is NaN keeps the starting index 0
    assert int(got[0]) == 0
    want, _ = near_tie_rows(z[4:], cb)
    assert torch.equal(got[4:], want)
