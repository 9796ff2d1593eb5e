"""The benchmark's frozen copy of the port's synthetic stereo world.

A copy of ``stereo_vo_tpu_torch/data/synthetic.py`` (the billboard world
``bench.py`` runs, and the one the repository's timings were taken on), kept here
so that a change to the program cannot change the benchmark's traffic. One
parameter is added: ``scale``, a uniform factor on every length of the world
(the trajectory's speed, the landmarks' depths and the corridor beyond them,
the billboards' world radius, the background's distance and the near limit
of visibility). Angles and pixel sizes stay as they are, so a world scaled
by ``s`` and seen through a camera of baseline ``s * b`` gives the same
images as the unscaled world through baseline ``b``. At ``scale`` 1 the
frames are bitwise the port's (``vobench/tests/test_vobench_world.py``).

Pure numpy: rendering runs on the host, never on the device.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import multiprocessing
import os
from typing import NamedTuple, Optional, Tuple

import numpy as np


# bumped when the rendering changes, so no older file is read
CACHE_VERSION = 1


class Camera(NamedTuple):
    focal: float
    cx: float
    cy: float
    baseline: float


def _np_rotmat_to_quat(m: np.ndarray) -> np.ndarray:
    """w-first unit quaternion from a rotation matrix (numpy, Shepperd)."""
    tr = np.trace(m)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        q = np.array([0.25 * s, (m[2, 1] - m[1, 2]) / s,
                      (m[0, 2] - m[2, 0]) / s, (m[1, 0] - m[0, 1]) / s])
    elif m[0, 0] > m[1, 1] and m[0, 0] > m[2, 2]:
        s = np.sqrt(1.0 + m[0, 0] - m[1, 1] - m[2, 2]) * 2
        q = np.array([(m[2, 1] - m[1, 2]) / s, 0.25 * s,
                      (m[0, 1] + m[1, 0]) / s, (m[0, 2] + m[2, 0]) / s])
    elif m[1, 1] > m[2, 2]:
        s = np.sqrt(1.0 + m[1, 1] - m[0, 0] - m[2, 2]) * 2
        q = np.array([(m[0, 2] - m[2, 0]) / s, (m[0, 1] + m[1, 0]) / s,
                      0.25 * s, (m[1, 2] + m[2, 1]) / s])
    else:
        s = np.sqrt(1.0 + m[2, 2] - m[0, 0] - m[1, 1]) * 2
        q = np.array([(m[1, 0] - m[0, 1]) / s, (m[0, 2] + m[2, 0]) / s,
                      (m[1, 2] + m[2, 1]) / s, 0.25 * s])
    q = q / np.linalg.norm(q)
    return q if q[0] >= 0 else -q


def _smooth_noise(rng, h, w, octaves=4, amp=40.0):
    """Band-limited random texture in roughly [-amp, amp]."""
    tex = np.zeros((h, w), np.float32)
    for o in range(octaves):
        step = 2 ** (octaves - o + 2)
        hh, ww = max(h // step, 2), max(w // step, 2)
        coarse = rng.normal(size=(hh, ww)).astype(np.float32)
        yi = np.linspace(0, hh - 1, h)
        xi = np.linspace(0, ww - 1, w)
        y0 = np.clip(yi.astype(int), 0, hh - 2)
        x0 = np.clip(xi.astype(int), 0, ww - 2)
        fy = (yi - y0)[:, None]
        fx = (xi - x0)[None, :]
        up = (
            coarse[y0][:, x0] * (1 - fy) * (1 - fx)
            + coarse[y0 + 1][:, x0] * fy * (1 - fx)
            + coarse[y0][:, x0 + 1] * (1 - fy) * fx
            + coarse[y0 + 1][:, x0 + 1] * fy * fx
        )
        tex += up * (amp / (2 ** o) / 2.0)
    return tex


@dataclasses.dataclass
class World:
    """A renderable synthetic sequence with exact ground truth (the port's
    ``SyntheticStereoSequence``, its fields in the same order, plus
    ``scale``)."""

    cam: Camera
    n_frames: int = 60
    shape: Tuple[int, int] = (240, 320)      # (H, W)
    n_points: int = 600
    seed: int = 0
    speed: float = 0.4                       # meters / frame along +z, before scale
    yaw_rate: float = 0.002                  # radians / frame
    patch_radius: int = 8                    # pixels
    patch_world_radius: float = 0.15         # meters, before scale
    bg_margin: float = 30.0                  # meters past the corridor, before scale
    point_depth: Tuple[float, float] = (6.0, 30.0)
    rate_hz: float = 11.0
    texture: Optional[np.ndarray] = None
    scale: float = 1.0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        h, w = self.shape
        f = self.cam.focal
        s = self.scale
        speed = self.speed * s
        self._patch_world_radius = self.patch_world_radius * s
        self._near = 2.0 * s

        poses_wc = []  # camera-to-world (R_wc, c_w)
        pos = np.zeros(3)
        yaw = 0.0
        for _ in range(self.n_frames):
            r_wc = np.array(
                [
                    [np.cos(yaw), 0, np.sin(yaw)],
                    [0, 1, 0],
                    [-np.sin(yaw), 0, np.cos(yaw)],
                ]
            )
            poses_wc.append((r_wc, pos.copy()))
            pos = pos + r_wc @ np.array([0, 0, speed])
            yaw += self.yaw_rate
        self._poses_wc = poses_wc

        gt = []
        for r_wc, c_w in poses_wc:
            r_cw = r_wc.T
            t_cw = -r_cw @ c_w
            gt.append(np.concatenate([_np_rotmat_to_quat(r_cw), t_cw]).astype(np.float32))
        self.gt_poses = np.stack(gt)

        total_z = speed * self.n_frames + self.point_depth[1] * s + 40.0 * s
        zs = rng.uniform(self.point_depth[0] * s, total_z, size=self.n_points)
        half_w = (w / 2) / f
        half_h = (h / 2) / f
        xs = rng.uniform(-half_w * 1.4, half_w * 1.4, size=self.n_points) * zs
        ys = rng.uniform(-half_h * 1.2, half_h * 1.2, size=self.n_points) * zs
        self.points = np.stack([xs, ys, zs], axis=1).astype(np.float32)

        r = self.patch_radius
        side = 2 * r + 3
        raw = rng.normal(size=(self.n_points, side + 4, side + 4)).astype(np.float32)
        g = np.array([1.0, 4.0, 6.0, 4.0, 1.0], np.float32)
        g = g / g.sum()
        sm = np.apply_along_axis(lambda m: np.convolve(m, g, mode="valid"), 1, raw)
        sm = np.apply_along_axis(lambda m: np.convolve(m, g, mode="valid"), 2, sm)
        yy = np.arange(side, dtype=np.float32)[None, :, None] - (side - 1) / 2
        xx = np.arange(side, dtype=np.float32)[None, None, :] - (side - 1) / 2
        env = np.exp(-(xx * xx + yy * yy) / (2 * (r * 0.6) ** 2))
        amp = rng.uniform(250, 450, size=(self.n_points, 1, 1)).astype(np.float32)
        self._patches = (sm * env * amp).astype(np.float32)

        self._bg_z = total_z + self.bg_margin * s
        if self.texture is not None:
            t = np.asarray(self.texture, np.float32)
            self._tex = t - float(t.mean())
        else:
            self._tex = _smooth_noise(rng, 512, 512, amp=26.0)
        self._tex_scale = 1.0 / (2 * half_w * 1.6 * self._bg_z)

        self._grid_u = np.arange(w, dtype=np.float32)[None, :] - self.cam.cx
        self._grid_v = np.arange(h, dtype=np.float32)[:, None] - self.cam.cy

    # ------------------------------------------------------------------
    def _render_background(self, r_wc, c_w, baseline_offset=0.0):
        """Sample the z = bg_z world plane through the given camera."""
        f = self.cam.focal
        c = c_w + r_wc @ np.array([baseline_offset, 0.0, 0.0])
        du = self._grid_u / f
        dv = self._grid_v / f
        dxw = r_wc[0, 0] * du + r_wc[0, 1] * dv + r_wc[0, 2]
        dyw = r_wc[1, 0] * du + r_wc[1, 1] * dv + r_wc[1, 2]
        dzw = r_wc[2, 0] * du + r_wc[2, 1] * dv + r_wc[2, 2]
        tparam = (self._bg_z - c[2]) / np.maximum(dzw, 1e-6)
        xw = c[0] + tparam * dxw
        yw = c[1] + tparam * dyw
        tex = self._tex
        th, tw = tex.shape
        tu = xw * self._tex_scale * tw
        tv = yw * self._tex_scale * th
        t0u = np.floor(tu).astype(np.int64)
        t0v = np.floor(tv).astype(np.int64)
        fu = (tu - t0u).astype(np.float32)
        fv = (tv - t0v).astype(np.float32)
        i0 = np.mod(t0v, th)
        i1 = np.mod(t0v + 1, th)
        j0 = np.mod(t0u, tw)
        j1 = np.mod(t0u + 1, tw)
        return (
            tex[i0, j0] * (1 - fv) * (1 - fu)
            + tex[i1, j0] * fv * (1 - fu)
            + tex[i0, j1] * (1 - fv) * fu
            + tex[i1, j1] * fv * fu
        )

    def _splat(self, img, u, v, patch, scale=1.0):
        """Add a landmark patch, bilinearly resampled, centred at sub-pixel
        ``(u, v)``; ``scale`` is the pixel size of one patch texel."""
        h, w = img.shape
        r = max(int(np.ceil(self.patch_radius * scale)), 1)
        iu, iv = int(np.floor(u)), int(np.floor(v))
        if iu < -r or iv < -r or iu >= w + r or iv >= h + r:
            return
        y0, y1 = max(iv - r, 0), min(iv + r + 2, h)
        x0, x1 = max(iu - r, 0), min(iu + r + 2, w)
        if y0 >= y1 or x0 >= x1:
            return
        c = (patch.shape[0] - 1) / 2
        py = (np.arange(y0, y1, dtype=np.float32)[:, None] - v) / scale + c
        px = (np.arange(x0, x1, dtype=np.float32)[None, :] - u) / scale + c
        py0 = np.clip(np.floor(py).astype(int), 0, patch.shape[0] - 2)
        px0 = np.clip(np.floor(px).astype(int), 0, patch.shape[1] - 2)
        fy = py - py0
        fx = px - px0
        val = (
            patch[py0, px0] * (1 - fy) * (1 - fx)
            + patch[py0, px0 + 1] * (1 - fy) * fx
            + patch[py0 + 1, px0] * fy * (1 - fx)
            + patch[py0 + 1, px0 + 1] * fy * fx
        )
        inside = ((py >= 0) & (py <= patch.shape[0] - 1)) * (
            (px >= 0) & (px <= patch.shape[1] - 1)
        )
        img[y0:y1, x0:x1] += val * inside

    def render(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        """Frame ``i`` as ``(left, right)`` uint8 images."""
        r_wc, c_w = self._poses_wc[i]
        b = self.cam.baseline
        f = self.cam.focal
        h, w = self.shape

        left = 128.0 + self._render_background(r_wc, c_w, 0.0)
        right = 128.0 + self._render_background(r_wc, c_w, b)

        r_cw = r_wc.T
        p_cam = (self.points - c_w) @ r_cw.T
        z = p_cam[:, 2]
        vis = z > self._near
        u = f * p_cam[:, 0] / z + self.cam.cx
        v = f * p_cam[:, 1] / z + self.cam.cy
        disp = f * b / z
        if self._patch_world_radius > 0:
            scale = f * self._patch_world_radius / (z * self.patch_radius)
            drawable = vis & (scale * self.patch_radius >= 1.2)
            scale = np.minimum(scale, 8.0)
        else:
            scale = np.ones_like(z)
            drawable = vis
        for k in np.nonzero(drawable)[0]:
            if -20 <= u[k] < w + 20 and -20 <= v[k] < h + 20:
                self._splat(left, u[k], v[k], self._patches[k], scale[k])
                self._splat(right, u[k] - disp[k], v[k], self._patches[k], scale[k])

        return (
            np.clip(left, 0, 255).astype(np.uint8),
            np.clip(right, 0, 255).astype(np.uint8),
        )

    def projections(self, i: int):
        """Ground-truth ``(u, v, disparity, visible)`` of every landmark in
        frame ``i``; visible as ``render`` draws it, inside the image."""
        r_wc, c_w = self._poses_wc[i]
        r_cw = r_wc.T
        p_cam = (self.points - c_w) @ r_cw.T
        z = p_cam[:, 2]
        f = self.cam.focal
        u = f * p_cam[:, 0] / np.maximum(z, 1e-6) + self.cam.cx
        v = f * p_cam[:, 1] / np.maximum(z, 1e-6) + self.cam.cy
        h, w = self.shape
        vis = (z > self._near) & (u >= 0) & (u < w) & (v >= 0) & (v < h)
        if self._patch_world_radius > 0:
            vis &= f * self._patch_world_radius / np.maximum(z, 1e-6) >= 1.2
        return u, v, f * self.cam.baseline / np.maximum(z, 1e-6), vis


def world_from(config: dict, n_frames: int, seed: int) -> World:
    """The world of a configuration file's ``camera`` and ``world`` groups,
    ``n_frames`` long, from ``seed``."""
    cam = config["camera"]
    wp = dict(config["world"])
    return World(
        cam=Camera(cam["focal"], cam["cx"], cam["cy"], cam["baseline"]),
        n_frames=n_frames, shape=(cam["height"], cam["width"]), seed=seed,
        n_points=wp["n_points"], speed=wp["speed"], yaw_rate=wp["yaw_rate"],
        patch_radius=wp["patch_radius"], patch_world_radius=wp["patch_world_radius"],
        bg_margin=wp["bg_margin"], point_depth=tuple(wp["point_depth"]),
        rate_hz=cam["rate_hz"], scale=wp["scale"],
    )


def _render_slice(job) -> Tuple[np.ndarray, np.ndarray]:
    config, n_frames, seed, lo, hi = job
    w = world_from(config, n_frames, seed)
    pairs = [w.render(i) for i in range(lo, hi)]
    return np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs])


def render_frames(config: dict, n_frames: int, seed: int,
                  workers: int = 1) -> Tuple[np.ndarray, np.ndarray]:
    """Every frame of the world as ``(lefts, rights)``, uint8 ``[N, H, W]``;
    with ``workers`` > 1, slices of frames rendered by as many forked
    processes (each frame depends on the world and its index alone, so the
    frames are the same), which have all ended when it returns."""
    workers = max(1, min(int(workers), n_frames))
    bounds = np.linspace(0, n_frames, workers + 1).astype(int)
    jobs = [(config, n_frames, seed, int(lo), int(hi)) for lo, hi in zip(bounds, bounds[1:])]
    if workers == 1:
        parts = [_render_slice(jobs[0])]
    else:
        pool = multiprocessing.get_context("fork").Pool(workers)
        try:
            parts = pool.map(_render_slice, jobs)
            pool.close()
        finally:
            pool.terminate()
            pool.join()
    return np.concatenate([p[0] for p in parts]), np.concatenate([p[1] for p in parts])


def cache_path(cache_dir: str, config: dict, n_frames: int, seed: int) -> str:
    """The file of a rendered sequence: named by the configuration, the seed
    and a digest of everything the frames depend on."""
    key = json.dumps({"version": CACHE_VERSION, "camera": config["camera"],
                      "world": config["world"], "n_frames": n_frames, "seed": seed},
                     sort_keys=True)
    digest = hashlib.sha256(key.encode()).hexdigest()[:16]
    return os.path.join(cache_dir, f"{config['name']}-{seed}-{digest}.npy")


def cached_frames(config: dict, n_frames: int, seed: int, cache_dir: str,
                  workers: int = 1) -> Tuple[np.ndarray, np.ndarray]:
    """``render_frames``, kept as one ``[2, N, H, W]`` file under
    ``cache_dir`` and read back from it by a later run of the same
    configuration and seed."""
    path = cache_path(cache_dir, config, n_frames, seed)
    if os.path.exists(path):
        both = np.load(path)
        return both[0], both[1]
    lefts, rights = render_frames(config, n_frames, seed, workers)
    os.makedirs(cache_dir, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        np.save(f, np.stack([lefts, rights]))
    os.replace(tmp, path)
    return lefts, rights


def gt_poses(config: dict, n_frames: int, seed: int) -> np.ndarray:
    """The world's ground-truth ``T_cw`` poses ``[N, 7]``."""
    return world_from(config, n_frames, seed).gt_poses
