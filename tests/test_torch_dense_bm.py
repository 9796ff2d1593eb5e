"""Parity of the large-radius box filters and the dense StereoBM with the JAX
package.

Tolerances:
- ``box_filter`` (radius 10, integral image) and ``box_sum_tree`` (windowed
  sliding sums): exact on integer-valued input, the dense BM's case (sums of
  at most 441 values below 63); on general float input ``box_sum_tree`` is
  the same sums in the same order (exact), and ``box_filter`` reads an
  integral image whose rounding grows with the image's total, so
  rtol 1e-5 plus 1e-6 of that total;
- ``stereo_bm_disparity``: validity identical, values within 1e-5 (costs
  are exact integers; the parabola is the same f32 arithmetic);
- the dense map sampled at feature pixels equals ``stereo_bm_at`` (1e-5).

The JAX package is imported inside the parity tests only, so the
``cuda``-marked test runs on a GPU machine without JAX:

    python -m pytest tests/test_torch_dense_bm.py -m cuda --noconftest -q
"""

import os

import numpy as np
import pytest
import torch

from stereo_vo_tpu_torch.core.camera import CameraInfo
from stereo_vo_tpu_torch.data.synthetic import SyntheticStereoSequence
from stereo_vo_tpu_torch.ops import filters as tfilters
from stereo_vo_tpu_torch.ops.stereo_bm import disparity_at, stereo_bm_at, stereo_bm_disparity

from torch_port_helpers import assert_close, assert_equal, to_jax, to_torch

CAM = CameraInfo(focal=300.0, cx=160.0, cy=120.0, baseline=0.3)
FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures", "real")


@pytest.fixture(scope="module")
def world():
    return SyntheticStereoSequence(cam=CAM, n_frames=2, shape=(240, 320), n_points=200, seed=3)


@pytest.fixture(scope="module")
def synthetic_pair(world):
    return tuple(a.astype(np.float32) for a in world.render(0))


def _fixture_pair():
    from PIL import Image

    # a 240x320 crop of the first KITTI-sized photographic pair
    return tuple(np.asarray(Image.open(os.path.join(FIXDIR, side, "000000.png")),
                            np.float32)[70:310, 450:770] for side in ("image_0", "image_1"))


@pytest.mark.parametrize("radius", [4, 10])
def test_box_filters_exact_on_integers(rng, radius):
    from stereo_vo_tpu.ops import filters as jfilters

    img = rng.integers(0, 63, size=(2, 61, 83)).astype(np.float32)
    assert_equal(tfilters.box_filter(to_torch(img), radius),
                 jfilters.box_filter(to_jax(img), radius), "box_filter")
    assert_equal(tfilters.box_sum_tree(to_torch(img), radius),
                 jfilters.box_sum_tree(to_jax(img), radius), "box_sum_tree")
    # and both equal the plain windowed sum
    p = np.pad(img, [(0, 0), (radius, radius), (radius, radius)], mode="reflect")
    k = 2 * radius + 1
    plain = sum(p[:, i:i + 61, j:j + 83] for i in range(k) for j in range(k))
    assert_equal(tfilters.box_sum_tree(to_torch(img), radius), plain)


def test_box_filters_on_floats(rng):
    from stereo_vo_tpu.ops import filters as jfilters

    img = rng.normal(size=(64, 80)).astype(np.float32)
    # same sums in the same order as the reference's doubling tree
    assert_equal(tfilters.box_sum_tree(to_torch(img), 10),
                 jfilters.box_sum_tree(to_jax(img), 10), "box_sum_tree")
    total = float(np.abs(img).sum())
    assert_close(tfilters.box_filter(to_torch(img), 10), jfilters.box_filter(to_jax(img), 10),
                 atol=1e-6 * total, rtol=1e-5, what="box_filter")


@pytest.mark.skipif(not os.path.isdir(os.path.join(FIXDIR, "image_0")),
                    reason="real fixtures not generated")
@pytest.mark.parametrize("source", ["synthetic", "photographic"])
def test_stereo_bm_disparity_matches_reference(synthetic_pair, source):
    from stereo_vo_tpu.ops.stereo_bm import stereo_bm_disparity as jax_bm_dense

    left, right = synthetic_pair if source == "synthetic" else _fixture_pair()
    want = np.asarray(jax_bm_dense(to_jax(left), to_jax(right)))
    got = stereo_bm_disparity(to_torch(left), to_torch(right)).numpy()
    assert_equal(got > 0, want > 0, "validity")
    assert_equal(got == -1.0, want == -1.0, "invalid marks")
    assert_close(got, want, atol=1e-5, what="disparity")
    assert (want > 0).mean() > 0.1


def test_sparse_equals_dense_at_points(world, synthetic_pair):
    """``stereo_bm_at`` == the dense map sampled at feature pixels, with and
    without live-slot compaction (the port's copy of the JAX package's
    ``test_stereo_bm_at_matches_dense_and_compacts``)."""
    l0, r0 = synthetic_pair
    lt, rt = to_torch(l0), to_torch(r0)
    dense = stereo_bm_disparity(lt, rt)
    u, v, _, vis = world.projections(0)
    sel = vis & (u > 70) & (u < 310) & (v > 11) & (v < 229)
    pts = np.stack([u[sel], v[sel]], 1).astype(np.float32)
    n_cap = 128
    xy = np.zeros((n_cap, 2), np.float32)
    n = min(len(pts), n_cap)
    xy[:n] = pts[:n]
    perm = np.random.RandomState(1).permutation(n_cap)
    valid = (np.arange(n_cap) < n)[np.argsort(perm)]
    xy = to_torch(xy[np.argsort(perm)])

    ref = np.where(valid, disparity_at(dense, xy).numpy(), -1.0)
    full = stereo_bm_at(lt, rt, xy, to_torch(valid)).numpy()
    assert_close(full[valid], ref[valid], atol=1e-5, what="sparse vs dense")
    assert np.all(full[~valid] == -1.0)
    assert (full[valid] > 0).mean() > 0.5

    valid_small = valid.copy()
    valid_small[np.cumsum(valid) > 40] = False
    comp = stereo_bm_at(lt, rt, xy, to_torch(valid_small), compact_slots=64).numpy()
    assert_close(comp[valid_small], ref[valid_small], atol=1e-5, what="compacted")
    assert np.all(comp[~valid_small] == -1.0)


@pytest.mark.cuda
def test_dense_bm_on_cuda_matches_cpu(synthetic_pair):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    left, right = (to_torch(a) for a in synthetic_pair)
    want = stereo_bm_disparity(left, right)
    got = stereo_bm_disparity(left.cuda(), right.cuda()).cpu()
    assert_equal(got > 0, want > 0, "validity")
    assert_close(got, want, atol=1e-5, what="disparity")
