"""Parity of detection, sparse StereoBM and triangulation with the JAX package.

Tolerances:
- Shi-Tomasi responses: f32 rounding (rtol 1e-5, plus 4e-7 of the largest
  response: the min-eigenvalue formula cancels terms of the trace's size);
- corner sets, peak counts, dedup masks and sparse StereoBM: exact. SADs are
  sums of integers and ``argmin`` takes the first minimum in both;
- triangulated points: f32 rounding (rtol 1e-6, atol 1e-5 m).
"""

import os

import numpy as np
import pytest

import jax.numpy as jnp
from stereo_vo_tpu.core.camera import CameraInfo as JCameraInfo
from stereo_vo_tpu.core.config import FrontendConfig as JFrontendConfig
from stereo_vo_tpu.data.synthetic import SyntheticStereoSequence
from stereo_vo_tpu.frontend.detect import dedup_new_features as jax_dedup
from stereo_vo_tpu.frontend.detect import detect_features as jax_detect_features
from stereo_vo_tpu.frontend.triangulate import triangulate_features as jax_tri_features
from stereo_vo_tpu.frontend.triangulate import triangulate_from_disparities as jax_tri
from stereo_vo_tpu.ops import shi_tomasi as jst
from stereo_vo_tpu.ops.stereo_bm import disparity_at as jax_disparity_at
from stereo_vo_tpu.ops.stereo_bm import stereo_bm_at as jax_bm_at
from stereo_vo_tpu.ops.stereo_bm import stereo_bm_disparity as jax_bm_dense

from stereo_vo_tpu_torch.core.config import FrontendConfig
from stereo_vo_tpu_torch.frontend.detect import dedup_new_features, detect_features
from stereo_vo_tpu_torch.frontend.triangulate import (
    triangulate_features,
    triangulate_from_disparities,
)
from stereo_vo_tpu_torch.ops import shi_tomasi as tst
from stereo_vo_tpu_torch.ops.stereo_bm import disparity_at, stereo_bm_at, stereo_bm_disparity

from torch_port_helpers import assert_close, assert_equal, port_camera, to_jax, to_torch

JCAM = JCameraInfo(focal=300.0, cx=160.0, cy=120.0, baseline=0.3)
REAL = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures", "real")


@pytest.fixture(scope="module")
def frames():
    world = SyntheticStereoSequence(cam=JCAM, n_frames=2, shape=(240, 320),
                                    n_points=300, seed=3)
    return [tuple(a.astype(np.float32) for a in world.render(i)) for i in range(2)]


def _jit_response(img):
    """The reference's response as the engine computes it: under ``jax.jit``
    (``stereo_vo_tpu/engine/step.py``), where XLA fuses multiply-adds."""
    import jax

    return np.asarray(jax.jit(jst.min_eig_response)(to_jax(img)))


def test_min_eig_response_and_peak_count(frames):
    left = frames[0][0]
    assert_equal(tst.min_eig_response(to_torch(left)), _jit_response(left), "response")
    stack = np.stack([frames[0][0], frames[1][0]])
    assert_equal(tst.count_quality_peaks(to_torch(stack)), jst.count_quality_peaks(to_jax(stack)))


def _response_image(name):
    """``name``'s left image as float32: a ``tests/fixtures/real`` frame, frame
    0 of the photo world (``tests/test_long_sequence.py``, seed 11) or of the
    billboard world (``chip_smoke.py`` phase 4), or a stack of real frames."""
    import cv2

    from stereo_vo_tpu.core.config import load_config

    def real(i):
        return cv2.imread(os.path.join(REAL, "image_0", f"{i:06d}.png"), cv2.IMREAD_GRAYSCALE)

    if name.startswith("real"):
        return real(int(name[4:])).astype(np.float32)
    if name == "stack3":
        return np.stack([real(i) for i in range(3)]).astype(np.float32)
    from stereo_vo_tpu.data.synthetic import load_sample_photo

    cam = load_config("kitti00").camera
    world = (dict(n_frames=161, n_points=3000, seed=11, speed=0.9, yaw_rate=0.004,
                  texture=load_sample_photo()) if name == "photo0" else
             dict(n_frames=20, n_points=4000, seed=0, speed=0.8, yaw_rate=0.003))
    seq = SyntheticStereoSequence(cam=cam, shape=(376, 1241), **world)
    return seq.render(0)[0].astype(np.float32)


@pytest.mark.parametrize("name", ["real0", "real1", "real2", "real3", "real4", "photo0",
                                  "billboard0", "stack3"])
def test_min_eig_response_bitwise_jitted(name):
    """The response bit for bit the jitted reference's at 376x1241, single
    and ``[3, H, W]``, and so the peak count the every-frame bail reads."""
    img = _response_image(name)
    got = tst.min_eig_response(to_torch(img))
    assert_equal(got, _jit_response(img), name)
    assert_equal(tst.count_quality_peaks(to_torch(img), resp=got),
                 jst.count_quality_peaks(to_jax(img)), name)


@pytest.mark.parametrize("max_corners,min_distance", [(300, 30.0), (300, 12.0), (40, 12.0)])
def test_detect_corners_identical(frames, max_corners, min_distance):
    left = frames[1][0]
    want = jst.detect_corners(to_jax(left), max_corners=max_corners, min_distance=min_distance)
    got = tst.detect_corners(to_torch(left), max_corners=max_corners, min_distance=min_distance)
    assert_equal(got[2], want[2], "valid")
    assert_equal(got[0], want[0], "xy")
    assert_close(got[1], want[1], atol=1e-3, rtol=1e-5, what="response")
    assert int(np.sum(np.asarray(want[2]))) > 10


def test_detect_features_and_dedup(frames, rng):
    left = frames[0][0]
    jcfg = JFrontendConfig(min_distance=12.0)
    jxy, jvalid = jax_detect_features(to_jax(left), jcfg)
    txy, tvalid = detect_features(to_torch(left), FrontendConfig(min_distance=12.0))
    assert_equal(tvalid, jvalid)
    assert_equal(txy, jxy)
    tracked = (np.asarray(jxy) + rng.normal(size=np.asarray(jxy).shape) * 8).astype(np.float32)
    tvalid_tr = rng.random(len(tracked)) < 0.5
    want = jax_dedup(jxy, jvalid, to_jax(tracked), to_jax(tvalid_tr), 12.0)
    got = dedup_new_features(txy, tvalid, to_torch(tracked), to_torch(tvalid_tr), 12.0)
    assert_equal(got, want)


@pytest.mark.parametrize("compact_slots", [0, 64, 320])
def test_stereo_bm_at_bit_exact(frames, rng, compact_slots):
    left, right = frames[0]
    n = 260
    xy = np.stack([rng.uniform(-5, 330, n), rng.uniform(-5, 245, n)], 1).astype(np.float32)
    xy[:4] = [[0, 0], [319, 239], [57.9, 10.2], [300.5, 230.7]]   # borders, truncation
    valid = rng.random(n) < (0.2 if compact_slots == 64 else 0.8)
    want = jax_bm_at(to_jax(left), to_jax(right), to_jax(xy), to_jax(valid),
                     compact_slots=compact_slots)
    got = stereo_bm_at(to_torch(left), to_torch(right), to_torch(xy), to_torch(valid),
                       compact_slots=compact_slots)
    assert_equal(got, want)
    assert int(np.sum(np.asarray(want) > 0)) > 20


def test_disparity_lookup(rng):
    disp = rng.uniform(-1, 40, size=(50, 70)).astype(np.float32)
    xy = np.stack([rng.uniform(-3, 75, 64), rng.uniform(-3, 55, 64)], 1).astype(np.float32)
    assert_equal(disparity_at(to_torch(disp), to_torch(xy)),
                 jax_disparity_at(to_jax(disp), to_jax(xy)))


def test_triangulation(frames, rng):
    cam = port_camera(JCAM)
    n = 128
    xy = rng.uniform(0, 300, size=(n, 2)).astype(np.float32)
    disp = rng.uniform(-2, 40, size=n).astype(np.float32)
    valid = rng.random(n) < 0.8
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    pose = np.concatenate([q, rng.normal(size=3) * 3]).astype(np.float32)
    wp, wv = jax_tri(to_jax(disp), to_jax(xy), to_jax(valid), JCAM, jnp.asarray(pose))
    tp, tv = triangulate_from_disparities(to_torch(disp), to_torch(xy), to_torch(valid), cam,
                                          to_torch(pose))
    assert_equal(tv, wv)
    assert_close(tp, wp, atol=1e-5, rtol=1e-6)


def test_triangulate_features_on_dense_map(frames, rng):
    """``triangulate_features`` on the dense StereoBM map of a stereo pair,
    at the detected corners and at random points (borders and truncation
    included), against the reference's."""
    left, right = frames[0]
    dense_j = jax_bm_dense(to_jax(left), to_jax(right))
    dense_t = stereo_bm_disparity(to_torch(left), to_torch(right))
    assert_equal(dense_t, dense_j, "dense map")
    jxy, jvalid = jax_detect_features(to_jax(left), JFrontendConfig(min_distance=12.0))
    extra = np.stack([rng.uniform(-3, 325, 64), rng.uniform(-3, 245, 64)], 1).astype(np.float32)
    xy = np.concatenate([np.asarray(jxy), extra]).astype(np.float32)
    valid = np.concatenate([np.asarray(jvalid), rng.random(64) < 0.8])
    pose = np.array([0.99, 0.05, -0.08, 0.1, 0.4, -0.2, 1.5], np.float32)
    pose[:4] /= np.linalg.norm(pose[:4])
    wp, wv = jax_tri_features(dense_j, to_jax(xy), to_jax(valid), JCAM, jnp.asarray(pose))
    tp, tv = triangulate_features(dense_t, to_torch(xy), to_torch(valid), port_camera(JCAM),
                                  to_torch(pose))
    assert_equal(tv, wv, "valid")
    assert_close(tp, wp, atol=1e-5, rtol=1e-6, what="points")
    assert int(np.sum(np.asarray(wv))) > 20
