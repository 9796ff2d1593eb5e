"""Synthetic stereo world: geometrically consistent rendered sequences.

The reference validates only by eyeballing rviz on KITTI (SURVEY.md §4); this
module is the foundation of the real test pyramid: a known trajectory + known
3D landmarks rendered into stereo pairs, so the frontend kernels (detection,
LK, StereoBM), PnP, triangulation and the full VO loop can be verified against
exact ground truth — and the benchmark harness can run KITTI-sized frames on
machines with no dataset.

Rendering model (all geometry exact, no approximations):
- A textured background **plane** at fixed world depth, sampled per-pixel via
  the plane-ray intersection for each camera — so background optical flow and
  stereo disparity are both geometrically consistent.
- Sparse landmarks splatted as Gabor-like corner patches at their projected
  (sub-pixel) locations in the left and right cameras; the right camera sits
  at baseline b along +x of the left (KITTI rectified convention), giving each
  landmark its exact disparity f*b/z.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterator, Optional, Tuple

import numpy as np

from stereo_vo_tpu_torch.core.camera import CameraInfo
from stereo_vo_tpu_torch.data.stream import StereoFrame


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
        # bilinear upsample to full size
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


SAMPLE_PHOTO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "grace_hopper.jpg")


def load_sample_photo() -> Optional[np.ndarray]:
    """Public-domain photograph for photo-textured worlds (None if PIL is
    unavailable to decode it).

    The Grace Hopper portrait shipped with matplotlib (a US government work),
    zero-meaned and contrast-scaled for the renderer's mid-gray canvas. Worlds
    textured with it have natural image statistics (real gradients, lighting
    structure) — the regime the pipeline defaults are tuned for, vs the
    band-limited-noise billboards (tests/fixtures/make_real_fixtures.py uses
    the same source for the checked-in PNG fixtures). The port ships a
    byte-equal copy of matplotlib's ``sample_data/grace_hopper.jpg``
    (``SAMPLE_PHOTO``), so it loads where matplotlib is not installed."""
    try:
        from PIL import Image
    except ImportError:
        return None
    img = np.asarray(Image.open(SAMPLE_PHOTO).convert("L"), np.float32)
    return (img - img.mean()) * 0.9


@dataclasses.dataclass
class SyntheticStereoSequence:
    """Renderable synthetic sequence with exact ground truth."""

    cam: CameraInfo
    n_frames: int = 60
    shape: Tuple[int, int] = (240, 320)      # (H, W)
    n_points: int = 600
    seed: int = 0
    speed: float = 0.4                       # meters / frame along +z
    yaw_rate: float = 0.002                  # radians / frame
    patch_radius: int = 8
    # World-space patch radius (meters). Patches are rendered as camera-facing
    # billboards whose PIXEL size scales with focal/depth, so a corner anywhere
    # on a patch moves exactly like the rigid 3D point it triangulates to.
    # (The earlier constant-pixel-size splat made patch-edge corners
    # geometrically inconsistent: their image offset from the patch center did
    # not scale with 1/z, which systematically biased PnP and actively poisoned
    # multi-view BA — on this world BA *hurt* accuracy until this fix.)
    # 0 = legacy constant-pixel-size behavior.
    patch_world_radius: float = 0.15
    bg_margin: float = 30.0                  # background plane this far past the end
    point_depth: Tuple[float, float] = (6.0, 30.0)
    rate_hz: float = 11.0
    # Optional real photograph [Ht, Wt] used as the background-plane texture
    # (zero-meaned internally) instead of band-limited noise: gives rendered
    # frames natural image statistics while keeping exact geometry.
    texture: Optional[np.ndarray] = None

    def __post_init__(self):
        # Pure numpy: the data plane must never touch the accelerator
        # (rendering happens on the host while the device computes).
        rng = np.random.default_rng(self.seed)
        h, w = self.shape
        f, cx, cy = self.cam.focal, self.cam.cx, self.cam.cy

        # --- trajectory: forward motion with gentle yaw (KITTI-like)
        poses_wc = []  # camera-to-world (R_wc, c_w)
        pos = np.zeros(3)
        yaw = 0.0
        for i in range(self.n_frames):
            r_wc = np.array(
                [
                    [np.cos(yaw), 0, np.sin(yaw)],
                    [0, 1, 0],
                    [-np.sin(yaw), 0, np.cos(yaw)],
                ]
            )
            poses_wc.append((r_wc, pos.copy()))
            pos = pos + r_wc @ np.array([0, 0, self.speed])
            yaw += self.yaw_rate
        self._poses_wc = poses_wc

        # T_cw pose vectors (framework convention)
        gt = []
        for r_wc, c_w in poses_wc:
            r_cw = r_wc.T
            t_cw = -r_cw @ c_w
            gt.append(np.concatenate([_np_rotmat_to_quat(r_cw), t_cw]).astype(np.float32))
        self.gt_poses = np.stack(gt)

        # --- landmarks: sprinkled through the flight corridor, extended past
        # the final camera position so feature density stays constant to the
        # last frame (otherwise the corridor end starves the tracker and
        # pollutes accuracy metrics)
        total_z = self.speed * self.n_frames + self.point_depth[1] + 40.0
        zs = rng.uniform(self.point_depth[0], total_z, size=self.n_points)
        # lateral spread that roughly fills the FOV at each depth
        half_w = (w / 2) / f
        half_h = (h / 2) / f
        xs = rng.uniform(-half_w * 1.4, half_w * 1.4, size=self.n_points) * zs
        ys = rng.uniform(-half_h * 1.2, half_h * 1.2, size=self.n_points) * zs
        self.points = np.stack([xs, ys, zs], axis=1).astype(np.float32)

        # per-point pattern: a unique band-limited random patch (distinctive,
        # so tracking/matching is unambiguous), tapered by a Gaussian envelope.
        r = self.patch_radius
        side = 2 * r + 3  # +2 for bilinear sampling margin
        raw = rng.normal(size=(self.n_points, side + 4, side + 4)).astype(np.float32)
        g = np.array([1.0, 4.0, 6.0, 4.0, 1.0], np.float32)
        g = g / g.sum()
        sm = np.apply_along_axis(lambda m: np.convolve(m, g, mode="valid"), 1, raw)
        sm = np.apply_along_axis(lambda m: np.convolve(m, g, mode="valid"), 2, sm)
        yy = np.arange(side, dtype=np.float32)[None, :, None] - (side - 1) / 2
        xx = np.arange(side, dtype=np.float32)[None, None, :] - (side - 1) / 2
        env = np.exp(-(xx * xx + yy * yy) / (2 * (r * 0.6) ** 2))
        amp = rng.uniform(250, 450, size=(self.n_points, 1, 1)).astype(np.float32)
        self._patches = (sm * env * amp).astype(np.float32)  # [N, side, side]

        # background plane + texture
        self._bg_z = total_z + self.bg_margin
        if self.texture is not None:
            t = np.asarray(self.texture, np.float32)
            self._tex = t - float(t.mean())
        else:
            self._tex = _smooth_noise(rng, 512, 512, amp=26.0)
        # Fraction of the texture per world unit, chosen so ONE texture period
        # spans the visible background width (with margin). Multiplied by the
        # texel count at lookup time (render()); folding the texel count in
        # here as well (the old `512 /` form) scaled frequencies 512x, putting
        # ~100 texels between adjacent image pixels — pure aliasing noise that
        # StereoBM matched at garbage disparities, poisoning triangulated
        # depth for every background feature in both our pipeline and the twin.
        self._tex_scale = 1.0 / (2 * half_w * 1.6 * self._bg_z)

        # cached pixel grid
        self._grid_u = np.arange(w, dtype=np.float32)[None, :] - cx
        self._grid_v = np.arange(h, dtype=np.float32)[:, None] - cy

    # ------------------------------------------------------------------
    def _render_background(self, r_wc, c_w, baseline_offset=0.0):
        """Sample the z = bg_z world plane through the given camera."""
        h, w = self.shape
        f = self.cam.focal
        # camera center (right camera sits +baseline along camera x)
        c = c_w + r_wc @ np.array([baseline_offset, 0.0, 0.0])
        # ray directions in world frame for each pixel
        du = self._grid_u / f  # [1, W]
        dv = self._grid_v / f  # [H, 1]
        # d_cam = [du, dv, 1]; d_world = R_wc @ d_cam
        dxw = r_wc[0, 0] * du + r_wc[0, 1] * dv + r_wc[0, 2]
        dyw = r_wc[1, 0] * du + r_wc[1, 1] * dv + r_wc[1, 2]
        dzw = r_wc[2, 0] * du + r_wc[2, 1] * dv + r_wc[2, 2]
        tparam = (self._bg_z - c[2]) / np.maximum(dzw, 1e-6)
        xw = c[0] + tparam * dxw
        yw = c[1] + tparam * dyw
        # texture lookup (wrap, bilinear)
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
        """Add landmark patch (bilinearly resampled) centered at sub-pixel (u, v).

        ``scale`` is the pixel size of one canonical patch texel: the rendered
        footprint radius is ``patch_radius * scale``, so billboards shrink with
        distance (scale = focal * patch_world_radius / (z * patch_radius))."""
        h, w = img.shape
        r = max(int(np.ceil(self.patch_radius * scale)), 1)
        iu, iv = int(np.floor(u)), int(np.floor(v))
        if iu < -r or iv < -r or iu >= w + r or iv >= h + r:
            return
        y0, y1 = max(iv - r, 0), min(iv + r + 2, h)
        x0, x1 = max(iu - r, 0), min(iu + r + 2, w)
        if y0 >= y1 or x0 >= x1:
            return
        # continuous patch coordinates of each target pixel
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
        # zero outside the patch footprint (the scaled target rectangle can
        # overhang it; the clamped bilinear indices would extrapolate there)
        inside = ((py >= 0) & (py <= patch.shape[0] - 1)) * (
            (px >= 0) & (px <= patch.shape[1] - 1)
        )
        img[y0:y1, x0:x1] += val * inside

    def render(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        """Render frame i -> (left, right) uint8 images."""
        r_wc, c_w = self._poses_wc[i]
        b = self.cam.baseline
        f = self.cam.focal
        h, w = self.shape

        left = 128.0 + self._render_background(r_wc, c_w, 0.0)
        right = 128.0 + self._render_background(r_wc, c_w, b)

        # landmarks into left/right cameras
        r_cw = r_wc.T
        p_cam = (self.points - c_w) @ r_cw.T  # [N, 3] in left-cam frame
        z = p_cam[:, 2]
        vis = z > 2.0
        u = f * p_cam[:, 0] / z + self.cam.cx
        v = f * p_cam[:, 1] / z + self.cam.cy
        disp = f * b / z
        if self.patch_world_radius > 0:
            # billboard pixel size ∝ 1/z; sub-pixel patches are invisible
            scale = f * self.patch_world_radius / (z * self.patch_radius)
            drawable = vis & (scale * self.patch_radius >= 1.2)
            scale = np.minimum(scale, 8.0)  # bound near-field splat cost
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
        """Ground-truth (u, v, disparity, visible) for every landmark in frame i."""
        r_wc, c_w = self._poses_wc[i]
        r_cw = r_wc.T
        p_cam = (self.points - c_w) @ r_cw.T
        z = p_cam[:, 2]
        f = self.cam.focal
        u = f * p_cam[:, 0] / np.maximum(z, 1e-6) + self.cam.cx
        v = f * p_cam[:, 1] / np.maximum(z, 1e-6) + self.cam.cy
        h, w = self.shape
        vis = (z > 2.0) & (u >= 0) & (u < w) & (v >= 0) & (v < h)
        if self.patch_world_radius > 0:
            # match render(): billboards smaller than ~a pixel are not drawn
            vis &= f * self.patch_world_radius / np.maximum(z, 1e-6) >= 1.2
        return u, v, f * self.cam.baseline / np.maximum(z, 1e-6), vis

    def __len__(self) -> int:
        return self.n_frames

    def __iter__(self) -> Iterator[StereoFrame]:
        for i in range(self.n_frames):
            left, right = self.render(i)
            yield StereoFrame(
                left=left,
                right=right,
                stamp=i / self.rate_hz,
                index=i,
                gt_pose=self.gt_poses[i],
            )
