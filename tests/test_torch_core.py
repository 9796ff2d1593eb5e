"""Parity of the port's ``core`` (geometry, camera, config) with the JAX package.

Tolerance: geometry is elementwise f32 arithmetic written in the same order
as the reference, so results agree to a few f32 ulps (atol 1e-6 on unit-scale
values, rtol 1e-6 elsewhere); configs must be equal field by field.
"""

import dataclasses

import numpy as np
import pytest

from stereo_vo_tpu.core import geometry as jgeo
from stereo_vo_tpu.core.camera import CameraInfo as JCameraInfo
from stereo_vo_tpu.core.config import available_configs, load_config as jax_load_config

from stereo_vo_tpu_torch.core import geometry as tgeo
from stereo_vo_tpu_torch.core.config import load_config, parse_config_yaml

from torch_port_helpers import assert_close, port_camera, to_jax, to_torch

ATOL = 1e-6


def _quats(rng, n, unit=False):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    if unit:
        q /= np.linalg.norm(q, axis=1, keepdims=True)
    return q


def _poses(rng, n):
    q = _quats(rng, n, unit=True)
    t = rng.normal(size=(n, 3)).astype(np.float32) * 5
    return np.concatenate([q, t], axis=1)


@pytest.mark.parametrize(
    "name",
    ["quat_mul", "rot_apply", "quat_to_rotmat", "rotmat_to_quat", "quat_retract",
     "quat_lift_jacobian", "quat_to_axis_angle", "axis_angle_to_quat",
     "pose_apply", "pose_inverse", "pose_retract", "camera_to_world_matrix"],
)
def test_geometry_matches_reference(rng, name):
    n = 64
    q = _quats(rng, n)
    pose = _poses(rng, n)
    pts = rng.normal(size=(n, 3)).astype(np.float32) * 10
    small = rng.normal(size=(n, 3)).astype(np.float32) * 0.3
    small[0] = 0.0                                  # the exp-map's Taylor branch
    delta6 = rng.normal(size=(n, 6)).astype(np.float32) * 0.1
    args = {
        "quat_mul": (q, _quats(rng, n)),
        "rot_apply": (q, pts),
        "quat_to_rotmat": (q,),
        "rotmat_to_quat": (np.asarray(jgeo.quat_to_rotmat(to_jax(q))),),
        "quat_retract": (q, small),
        "quat_lift_jacobian": (q,),
        "quat_to_axis_angle": (q,),
        "axis_angle_to_quat": (small,),
        "pose_apply": (pose, pts),
        "pose_inverse": (pose,),
        "pose_retract": (pose, delta6),
        "camera_to_world_matrix": (pose,),
    }[name]
    want = getattr(jgeo, name)(*to_jax(args))
    got = getattr(tgeo, name)(*to_torch(args))
    assert_close(got, want, atol=ATOL, rtol=1e-6, what=name)


def test_non_unit_rotation_and_identity():
    q = np.array([[2.0, 0.0, 0.0, 0.0], [0.0, 3.0, 0.0, 0.0]], np.float32)
    p = np.array([[1.0, 2.0, 3.0], [1.0, 2.0, 3.0]], np.float32)
    got = tgeo.rot_apply(*to_torch((q, p)))
    assert_close(got, jgeo.rot_apply(*to_jax((q, p))), atol=ATOL)
    assert_close(tgeo.pose_identity(), jgeo.pose_identity(), atol=0)
    assert_close(tgeo.quat_identity(), jgeo.quat_identity(), atol=0)


def test_camera_matches_reference(rng):
    jcam = JCameraInfo(focal=718.856, cx=607.1928, cy=185.2157, baseline=0.5371657)
    tcam = port_camera(jcam)
    for m in ("intrinsic_matrix", "projection_2x3", "reprojection_q"):
        assert_close(getattr(tcam, m)(), getattr(jcam, m)(), atol=0, what=m)
    uv = rng.uniform(0, 1200, size=(128, 2)).astype(np.float32)
    disp = rng.uniform(0.5, 60, size=(128,)).astype(np.float32)
    want = jcam.back_project(*to_jax((uv, disp)))
    got = tcam.back_project(*to_torch((uv, disp)))
    assert_close(got, want, atol=0, rtol=1e-6, what="back_project")
    p_cam = np.asarray(want)
    assert_close(tcam.project(to_torch(p_cam)), jcam.project(to_jax(p_cam)),
                 atol=1e-4, what="project")


@pytest.mark.parametrize("name", sorted(available_configs()))
def test_all_configs_match_reference(name):
    want = jax_load_config(name)
    got = load_config(name)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.name == name


def test_config_overrides_and_parser_errors(tmp_path):
    p = tmp_path / "cam.yaml"
    p.write_text(
        "# a camera\nfocal_length: 500.0\ncx: 320  # principal point\ncy: 240\n"
        "baseline: 0.1\nleft_topic: \"/l # not a comment\"\n"
        "frontend:\n  max_detect: 120\n  lk_eps: 0.02\nbackend:\n  window_size: 7\n"
    )
    got = load_config(str(p), overrides={"backend": {"max_lm_iters": 4}})
    want = jax_load_config(str(p), overrides={"backend": {"max_lm_iters": 4}})
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.left_topic == "/l # not a comment"
    for bad in ("focal_length: [1, 2]\n", "frontend:\n  nested:\n    x: 1\n",
                "  stray: 1\n", "unknown_section:\n  a: 1\n", "key value\n"):
        with pytest.raises(ValueError):
            parse_config_yaml(bad)
