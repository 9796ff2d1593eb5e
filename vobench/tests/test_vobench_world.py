"""The benchmark's frozen world against the port's generator."""

import json
import os

import numpy as np

from vobench import manifest
from vobench.world import (Camera, World, cache_path, cached_frames, render_frames,
                           world_from)


def _config(name):
    with open(os.path.join(manifest.HERE, "configs", name + ".json")) as f:
        return json.load(f)


def test_scale_one_is_bitwise_the_ports_world():
    from stereo_vo_tpu_torch.core.camera import CameraInfo
    from stereo_vo_tpu_torch.data.synthetic import SyntheticStereoSequence

    cam = _config("kitti00")["camera"]
    kw = dict(n_frames=4, shape=(96, 160), n_points=120, seed=2**31 + 5, speed=0.8,
              yaw_rate=0.003)
    port = SyntheticStereoSequence(
        cam=CameraInfo(cam["focal"], 80.0, 48.0, cam["baseline"]), **kw)
    ours = World(cam=Camera(cam["focal"], 80.0, 48.0, cam["baseline"]), scale=1.0, **kw)
    assert np.array_equal(port.gt_poses, ours.gt_poses)
    assert np.array_equal(port.points, ours.points)
    for i in range(kw["n_frames"]):
        for a, b in zip(port.render(i), ours.render(i)):
            assert a.dtype == b.dtype == np.uint8
            assert np.array_equal(a, b)


def test_render_frames_is_the_worlds_render():
    cfg = _config("d435i")
    cfg["camera"].update(width=160, height=120, cx=80.0, cy=60.0)
    cfg["world"]["n_points"] = 150
    lefts, rights = render_frames(cfg, 3, 2**31 + 9)
    w = world_from(cfg, 3, 2**31 + 9)
    assert lefts.shape == rights.shape == (3, 120, 160) and lefts.dtype == np.uint8
    for i in range(3):
        left, right = w.render(i)
        assert np.array_equal(lefts[i], left) and np.array_equal(rights[i], right)


def _disparities(name, frames):
    w = world_from(_config(name), 129, 0)
    return [w.projections(i)[2][w.projections(i)[3]] for i in frames]


def test_d435i_scale_keeps_disparities_inside_the_matcher():
    cfg = _config("d435i")
    assert abs(cfg["world"]["scale"] - 0.05 / 0.537165718864418) < 1e-15
    d0 = _disparities("d435i", [0])[0]
    # the world's depths 6-30 m scaled to 0.56-2.8 m: 4.3-34.3 px at frame 0
    assert d0.min() > 4.0 and d0.max() < 48.0
    over = np.concatenate(_disparities("d435i", range(0, 129, 4)))
    kitti = np.concatenate(_disparities("kitti00", range(0, 129, 4)))
    # only landmarks the camera closes in on pass bm_num_disparities (48 px)
    assert (over > 48.0).mean() < 0.01
    assert (over > 48.0).mean() < (kitti > 48.0).mean()


def test_d435i_world_is_the_kitti_world_scaled():
    k = world_from(_config("kitti00"), 129, 3)
    d = world_from(_config("d435i"), 129, 3)
    s = _config("d435i")["world"]["scale"]
    # depths and travel scale; the lateral spread fills each camera's view
    assert np.allclose(d.points[:, 2], k.points[:, 2] * s, rtol=1e-6)
    assert np.allclose(d.gt_poses[:, 4:], k.gt_poses[:, 4:] * s, rtol=1e-5, atol=1e-7)
    assert np.array_equal(d.gt_poses[:, :4], k.gt_poses[:, :4])


def test_a_pool_and_the_cache_give_the_same_frames(tmp_path):
    cfg = _config("kitti00")
    cfg["camera"].update(width=160, height=96, cx=80.0, cy=48.0)
    cfg["world"]["n_points"] = 120
    seed = 2**31 + 3
    lefts, rights = render_frames(cfg, 5, seed)
    pooled = render_frames(cfg, 5, seed, workers=2)
    assert np.array_equal(pooled[0], lefts) and np.array_equal(pooled[1], rights)
    written = cached_frames(cfg, 5, seed, str(tmp_path), workers=2)
    path = cache_path(str(tmp_path), cfg, 5, seed)
    assert os.listdir(tmp_path) == [os.path.basename(path)]
    read = cached_frames(cfg, 5, seed, str(tmp_path))
    for got in (written, read):
        assert np.array_equal(got[0], lefts) and np.array_equal(got[1], rights)
    cfg["world"]["speed"] = 0.7
    assert cache_path(str(tmp_path), cfg, 5, seed) != path
