"""The greedy-NMS kernel's algorithm against the plain versions, and
detection at a pool over 1024 candidates against the JAX function.

``csrc/greedy_nms.cu`` runs only on the card, so its algorithm is
transcribed here in numpy, step for step and in the kernel's float32
rounding, and held bitwise against ``greedy_nms_ref`` (the fixpoint) and
``greedy_nms_pack_ref`` (the fixpoint, capped and packed as
``detect_corners`` returns it):

- the binning: the cell side, the smallest power of two ``s`` with
  ``fl(s * s) >= r2``, doubled while the valid finite candidates' bounding
  box needs more cells than the kernel's ``kMaxCells`` (read from the
  source), and each candidate's cell ``floor(fl(v / s))`` per axis;
- the conflict lists: the candidates in cell order (a counting sort), each
  pair of entries at most a cell apart tested once (from an entry, the rest
  of its cell and the cell to its right, and the three cells of the next
  row) as the kernel tests it, the conflict given to the later candidate;
  they must be exactly the plain version's conflict matrix, which shows
  that the binning loses no conflict (the grown grid, the cell borders and
  the pairs one ulp either side of ``r2`` included); a candidate whose list
  outgrows its shared-memory slots gets a bit row from a rescan of its
  3 x 3 cells, which must give the same list;
- the rounds (the first folded into the build: accepted where a valid
  candidate has no earlier conflict), as many as the plain version's, and
  the rank cap and pack through the accepted count's prefix.

The sets: the nine pools of the kernel's card tests
(``tests/test_torch_sync_free.py``), one candidate, seeded random pools of
1500 and 4096 candidates at two densities, coordinates on cell borders,
pairs at ``d2 = r2`` and one ulp either side, a pool spread wider than the
grid at its smallest cell, non-finite coordinates, and the grid grown on a
frame's pool by a small cell budget. Then the port's ``detect_corners`` at
``candidates=2048`` against the jitted JAX function on two frames of the
20-frame world, bitwise, as the default is held
(``tests/test_torch_detect_bm.py``, ``test_torch_sync_free.py``).
"""

import os
import re

import numpy as np
import pytest
import torch

from stereo_vo_tpu_torch.core.config import FrontendConfig, load_config
from stereo_vo_tpu_torch.ops import shi_tomasi as tst

from torch_port_helpers import assert_equal, nms_pool, to_jax, to_torch

F32 = np.float32
KERNEL_SRC = open(os.path.join(os.path.dirname(tst.__file__), os.pardir, "csrc",
                               "greedy_nms.cu")).read()


def _constant(name):
    return int(eval(re.search(rf"constexpr \w+ {name} = ([\d\s\-+*]+);", KERNEL_SRC).group(1)))


MAX_CELLS = _constant("kMaxCells")
DYN_SMEM = _constant("kDynSmem")
BIT_SETS = _constant("kBitSets")
CAND_ARRAYS = _constant("kCandArrays")
MAX_SLOTS = _constant("kMaxSlots")
MAX_SLOT_C = _constant("kMaxSlotC")
# the pools of the kernel's card tests in test_torch_sync_free.py
CARD_SETS = ("billboard0", "billboard1", "billboard2", "billboard3", "billboard4", "photo0",
             "chain1024", "none_valid", "corners")
POOL_SETS = ("single", "random1500_sparse", "random1500_dense", "random4096_sparse",
             "random4096_dense", "cell_borders", "ulp_pairs", "wide", "nonfinite")


def _align16(x):
    return (x + 15) & ~15


def slot_count(c):
    """The kernel's ``make_plan``: the list slots a candidate has in shared
    memory for ``c`` candidates (16-bit entries; none past ``kMaxSlotC``)."""
    words = (c + 31) // 32
    s = _align16((MAX_CELLS + 1) * 4)
    for size in (BIT_SETS * words * 4, CAND_ARRAYS * c * 4):
        if s + size <= DYN_SMEM:
            s = _align16(s + size)
    fit = max(DYN_SMEM - s, 0) // (2 * c)
    return 0 if c > MAX_SLOT_C else min(fit, MAX_SLOTS)


def cell_side(r2):
    """The smallest power of two ``s`` with ``fl(s * s) >= r2`` (``r2 > 0``)."""
    s = F32(1)
    with np.errstate(over="ignore", under="ignore"):
        while F32(s * s) < r2:
            s = F32(s * F32(2))
        while True:
            h = F32(s * F32(0.5))
            if h > 0 and F32(h * h) >= r2:
                s = h
            else:
                return s


def binning(cxy, cvalid, r2, max_cells=MAX_CELLS):
    """``(cell [C, 2] int, grid (gx, gy, s) or None)``: each candidate's
    cell, ``-1`` where it has none (invalid, a non-finite coordinate, or no
    conflict possible: ``r2 <= 0`` or NaN)."""
    cell = np.full((len(cxy), 2), -1, np.int64)
    binned = cvalid & np.isfinite(cxy).all(1)
    if not (r2 > 0) or not binned.any():
        return cell, None
    lo, hi = cxy[binned].min(0), cxy[binned].max(0)
    s = cell_side(F32(r2))
    inv = F32(1) / s
    with np.errstate(over="ignore", invalid="ignore"):
        while True:
            c0 = np.floor(lo * inv)
            g = (np.floor(hi * inv) - c0) + F32(1)
            if F32(g[0] * g[1]) <= max_cells:
                break
            s, inv = F32(s * F32(2)), F32(inv * F32(0.5))
    cell[binned] = (np.floor(cxy[binned] * inv) - c0).astype(np.int64)
    return cell, (int(g[0]), int(g[1]), s)


def _near(cxy, a, b, r2):
    """The kernel's pair test between candidates ``a`` (array) and ``b``."""
    with np.errstate(over="ignore", invalid="ignore"):
        d = cxy[a] - cxy[b]
        return d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] < F32(r2)


def conflict_lists(cxy, cvalid, r2, max_cells=MAX_CELLS):
    """Each candidate's earlier conflicts, found as the kernel finds them:
    the binned candidates in cell order (a counting sort), and from each
    entry the later entries of its cell and of the cell to its right (one
    run) and the three cells of the next row (another), each pair tested
    once and its conflict given to the later candidate. ``(lists, grid,
    rescan)``: ``lists[i]`` a sorted index array, and ``rescan(i)`` the
    earlier conflicts of ``i`` in its 3 x 3 cells, as the kernel rescans a
    candidate whose list outgrows its slots."""
    cell, grid = binning(cxy, cvalid, r2, max_cells)
    lists = [[] for _ in range(len(cxy))]
    if grid is None:
        return [np.zeros(0, np.int64) for _ in lists], grid, None
    gx, gy, _ = grid
    binned = np.flatnonzero(cell[:, 0] >= 0)
    cid = cell[binned, 1] * gx + cell[binned, 0]
    order = binned[np.argsort(cid, kind="stable")]
    start = np.concatenate([[0], np.cumsum(np.bincount(cid, minlength=gx * gy))])
    for e, i in enumerate(order):
        cx, cy = cell[i]
        runs = [order[e + 1:start[cy * gx + min(cx + 1, gx - 1) + 1]]]
        if cy + 1 < gy:
            row = (cy + 1) * gx
            runs.append(order[start[row + max(cx - 1, 0)]:start[row + min(cx + 1, gx - 1) + 1]])
        q = np.concatenate(runs)
        for j in q[_near(cxy, q, i, r2)]:
            lists[max(i, j)].append(min(i, j))

    def rescan(i):
        cx, cy = cell[i]
        j = np.concatenate([order[start[ny * gx + max(cx - 1, 0)]:
                                  start[ny * gx + min(cx + 1, gx - 1) + 1]]
                            for ny in range(max(cy - 1, 0), min(cy + 1, gy - 1) + 1)])
        j = j[j < i]
        return np.sort(j[_near(cxy, j, i, r2)])

    return [np.sort(np.array(x, np.int64)) for x in lists], grid, rescan


def bit_row_candidates(lists):
    """The candidates whose lists outgrow their slots: the kernel keeps
    their conflicts as bit rows."""
    n = np.array([len(x) for x in lists], np.int64)
    return n > slot_count(len(lists))


def rounds(cvalid, lists):
    """The kernel's rounds over the conflict lists: ``(accepted, rounds)``.
    The first runs inside the build: the valid candidates with no earlier
    conflict are accepted, the others pending."""
    c = len(cvalid)
    row = np.repeat(np.arange(c), [len(x) for x in lists])
    col = np.concatenate(lists) if c else np.zeros(0, np.int64)
    later = np.bincount(row, minlength=c) > 0
    acc = cvalid & ~later
    kill = np.zeros(c, bool)
    pend = cvalid & later
    n = int(cvalid.any())
    while pend.any():
        n += 1
        blocked = np.bincount(row, weights=pend[col], minlength=c) > 0
        by_acc = np.bincount(row, weights=acc[col], minlength=c) > 0
        kill |= pend & by_acc
        acc |= pend & ~by_acc & ~blocked
        pend = cvalid & ~acc & ~kill
    return acc, n


def pack(cxy, cvals, accepted, k):
    """The kernel's cap and pack: each candidate's rank among the accepted
    (the exclusive prefix), its output row, ``min(C, k)`` rows."""
    c = len(accepted)
    rank = np.cumsum(accepted) - accepted
    capped = accepted & (rank < k)
    n_acc = min(int(accepted.sum()), k)
    slot = np.where(capped, rank, n_acc + np.arange(c) - np.minimum(rank, k))
    rows = min(c, k)
    xy = np.zeros((rows, 2), F32)
    resp = np.zeros(rows, F32)
    valid = np.zeros(rows, bool)
    keep = slot < rows
    xy[slot[keep]] = cxy[keep]
    resp[slot[keep]] = np.where(capped, cvals, F32(-1))[keep]
    valid[slot[keep]] = capped[keep]
    return xy, resp, valid


def _pool(name):
    """``(cxy, cvalid, cvals, r2)`` as numpy: the card tests' pools (their
    order stands in for the response order), or ``nms_pool``'s."""
    if name in CARD_SETS:
        from test_torch_sync_free import _nms_inputs

        cxy, cvalid, r2 = (x.numpy() if isinstance(x, torch.Tensor) else x
                           for x in _nms_inputs(name, torch.device("cpu")))
    else:
        cxy, cvalid, r2 = nms_pool(name)
    # descending responses, positive where valid, as the candidate pool has
    cvals = np.where(cvalid, np.linspace(2.0, 1.0, len(cxy), dtype=F32), F32(-1))
    return np.ascontiguousarray(cxy, F32), cvalid, cvals.astype(F32), r2


def _plain_conflicts(cxy, cvalid, r2):
    """The plain version's conflict matrix ``[j, i]`` (``greedy_nms_ref``)."""
    t = to_torch(cxy)
    d2 = torch.sum((t[:, None, :] - t[None, :, :]) ** 2, dim=-1)
    ar = torch.arange(len(cxy))
    v = torch.from_numpy(cvalid)
    return ((d2 < r2) & (ar[:, None] < ar[None, :]) & v[:, None] & v[None, :]).numpy()


def _check(cxy, cvalid, cvals, r2, max_cells=MAX_CELLS):
    lists, grid, rescan = conflict_lists(cxy, cvalid, r2, max_cells)
    conf = _plain_conflicts(cxy, cvalid, r2)
    for i in range(len(cxy)):
        np.testing.assert_array_equal(lists[i], np.flatnonzero(conf[:, i]),
                                      err_msg=f"conflicts of candidate {i}")
    for i in np.flatnonzero(bit_row_candidates(lists)):
        np.testing.assert_array_equal(rescan(i), lists[i], err_msg=f"bit row of {i}")
    accepted, n_rounds = rounds(cvalid, lists)
    want, want_rounds = tst.greedy_nms_rounds(to_torch(cxy), torch.from_numpy(cvalid), r2)
    assert_equal(torch.from_numpy(accepted), want, "accepted")
    assert n_rounds == want_rounds
    assert_equal(want, tst.greedy_nms_ref(to_torch(cxy), torch.from_numpy(cvalid), r2))
    for k in (300, 40, len(cxy) + 5):
        got = pack(cxy, cvals, accepted, k)
        want = tst.greedy_nms_pack_ref(to_torch(cxy), torch.from_numpy(cvalid), to_torch(cvals),
                                       r2, k)
        for g, w, what in zip(got, want, ("xy", "response", "valid")):
            assert_equal(torch.from_numpy(g), w, f"{what} at k={k}")
    return grid, n_rounds, lists


@pytest.mark.parametrize("name", CARD_SETS + POOL_SETS)
def test_transcription_equals_plain_versions(name):
    cxy, cvalid, cvals, r2 = _pool(name)
    grid, n_rounds, lists = _check(cxy, cvalid, cvals, r2)
    if name == "chain1024":
        assert n_rounds == 1024
    if name == "none_valid":
        assert grid is None and n_rounds == 0
    if name == "cell_borders":
        assert grid[2] == 32.0
        assert sum(map(len, lists)) > 0
    if name == "wide":
        gx, gy, s = grid
        assert s > cell_side(F32(r2)) and gx * gy <= MAX_CELLS
    if name == "random4096_dense":
        assert bit_row_candidates(lists).any()
    if name.startswith("billboard"):
        assert not bit_row_candidates(lists).any()


def test_transcription_grown_grid():
    """A frame's pool with a budget of 16 cells: the side doubles until the
    box fits, and the lists are still exactly the conflicts."""
    cxy, cvalid, cvals, r2 = _pool("billboard0")
    grid, _, _ = _check(cxy, cvalid, cvals, r2, max_cells=16)
    assert grid[0] * grid[1] <= 16 and grid[2] >= 256


@pytest.mark.parametrize("r2", [0.0, -1.0, float("nan"), float("inf"), 1e-45])
def test_transcription_degenerate_radii(r2):
    """No conflict under r2 <= 0 or NaN; every finite pair under an infinite
    one (cell side 2^64 or more); subnormal r2."""
    cxy, cvalid, cvals, _ = _pool("nonfinite")
    grid, _, lists = _check(cxy, cvalid, cvals, r2)
    if not r2 > 0:
        assert grid is None
    if r2 == float("inf"):
        assert grid[2] >= F32(2.0 ** 64) and sum(map(len, lists)) > 0


def test_pack_wrapper_checks():
    """The wrapper's arguments on the CPU: both or neither of cvals and
    max_corners, and the kernel's stats only on the card."""
    cxy, cvalid, cvals, r2 = (to_torch(x) if isinstance(x, np.ndarray) else x
                              for x in _pool("random1500_sparse"))
    with pytest.raises(ValueError):
        tst.greedy_nms(cxy, cvalid, r2, cvals)
    with pytest.raises(ValueError):
        tst.greedy_nms(cxy, cvalid, r2, max_corners=10)
    with pytest.raises(ValueError):
        tst.greedy_nms(cxy, cvalid, r2, stats=torch.zeros(len(tst.NMS_STATS), dtype=torch.int64))
    got = tst.greedy_nms(cxy, cvalid, r2, cvals, 0)
    assert [tuple(x.shape) for x in got] == [(0, 2), (0,), (0,)]


@pytest.mark.parametrize("frame", [0, 1])
def test_detect_corners_2048_candidates_matches_jitted_reference(frame):
    import jax

    from stereo_vo_tpu.ops import shi_tomasi as jst
    from stereo_vo_tpu_torch.data.synthetic import SyntheticStereoSequence

    world = SyntheticStereoSequence(cam=load_config("kitti00").camera, shape=(376, 1241),
                                    n_frames=20, n_points=4000, seed=0, speed=0.8,
                                    yaw_rate=0.003)
    img = world.render(frame)[0].astype(np.float32)
    fc = FrontendConfig()
    kw = dict(max_corners=fc.max_detect, quality_level=fc.quality_level,
              min_distance=fc.min_distance, block_size=fc.detect_block_size, candidates=2048)
    want = jax.jit(lambda x: jst.detect_corners(x, **kw))(to_jax(img))
    got = tst.detect_corners(to_torch(img), **kw)
    assert int(got[2].sum()) > 50
    for g, w, what in zip(got, want, ("xy", "response", "valid")):
        assert_equal(g, w, what)
