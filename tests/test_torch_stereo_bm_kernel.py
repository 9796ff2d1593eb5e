"""Sparse StereoBM at feature pixels (``ops/stereo_bm.py::stereo_bm_at``): the
plain version against the JAX function, the kernel's contract against the
plain version on the CPU, the wrapper's dispatch and checks, and the CUDA
kernel against the plain version on the card.

Tolerance: none anywhere. The images are uint8 frames as f32, so every
prefiltered value, SAD and texture sum is an exact f32 integer whatever the
order of the sums, and ``argmin`` takes the first minimum in every version.

- ``stereo_bm_at_ref`` == the JAX ``stereo_bm_at`` at the engine's two call
  shapes: the bootstrap's detections at full width, and a keyframe's 748
  slots (detections, then frame 1's detections standing in for tracked
  inliers) with ``compact_slots=320`` at <= 320 valid (it compacts) and
  > 320 valid (it does not).
- The kernel's contract (``csrc/stereo_bm_at.cu``), written here as direct
  edge-clamped indexing into the prefiltered images, == ``stereo_bm_at_ref``
  at border, negative and fractional coordinates, for (D, block) = (48, 21)
  and (16, 9); and the plain version's windows never leave their 8-aligned
  regions, at every pixel of a 376x1241 image, so its zero fill is never
  read. Together they prove the clamped-read formulation is the same
  function.

The JAX package is imported inside the parity test only, so that on a GPU
machine without JAX the kernel tests run alone:

    python -m pytest tests/test_torch_stereo_bm_kernel.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from stereo_vo_tpu_torch.core.config import FrontendConfig
from stereo_vo_tpu_torch.frontend.detect import dedup_new_features, detect_features
from stereo_vo_tpu_torch.ops.stereo_bm import _region_geometry, stereo_bm_at, stereo_bm_at_ref

from torch_port_helpers import assert_equal, to_torch

H, W = 240, 320
FCFG = FrontendConfig(min_distance=12.0)
F_CAP = 448
COMPACT = 320
# (num_disparities, block_size): the defaults and a smaller pair
SIZES = [(48, 21), (16, 9)]
SLOTS = ["bootstrap_300", "keyframe_748_le320", "keyframe_748_gt320"]


@pytest.fixture(scope="module")
def frames():
    from stereo_vo_tpu_torch.core.camera import CameraInfo
    from stereo_vo_tpu_torch.data.synthetic import SyntheticStereoSequence

    world = SyntheticStereoSequence(cam=CameraInfo(focal=300.0, cx=160.0, cy=120.0,
                                                   baseline=0.3),
                                    n_frames=2, shape=(H, W), n_points=300, seed=3)
    return [tuple(a.astype(np.float32) for a in world.render(i)) for i in range(2)]


def _slots(frames, kind):
    """``(xy, valid, compact_slots)`` of one of the engine's calls: the
    bootstrap's detections, or a keyframe's new detections (deduplicated
    against the tracked set) then ``F_CAP`` tracked slots (frame 1's
    detections, tiled with 1-px jitter), at <= or > ``COMPACT`` valid."""
    det_xy, det_valid = detect_features(to_torch(frames[0][0]), FCFG)
    if kind == "bootstrap_300":
        return det_xy, det_valid, 0
    trk_xy, trk_valid = detect_features(to_torch(frames[1][0]), FCFG)
    rng = np.random.default_rng(7)
    pts = trk_xy[trk_valid].numpy()
    tiled = pts[np.arange(F_CAP) % len(pts)] + rng.uniform(-1, 1, (F_CAP, 2))
    feat_xy = to_torch(tiled.astype(np.float32))
    if kind == "keyframe_748_le320":
        feat_valid = torch.arange(F_CAP) < len(pts)
        new_valid = dedup_new_features(det_xy, det_valid, feat_xy, feat_valid, FCFG.min_distance)
        valid = torch.cat([new_valid, feat_valid])
        valid &= torch.cumsum(valid.to(torch.int64), 0) <= COMPACT
    else:
        valid = torch.cat([det_valid, torch.ones(F_CAP, dtype=torch.bool)])
    return torch.cat([det_xy, feat_xy]).contiguous(), valid, COMPACT


def _border_slots(n, seed):
    """Features over and past the image, fractional, with the corners, the
    negative-fraction truncation and ~20% invalid slots."""
    rng = np.random.default_rng(seed)
    xy = np.stack([rng.uniform(-6, W + 6, n), rng.uniform(-6, H + 6, n)], 1).astype(np.float32)
    xy[:8] = [[0, 0], [W - 1, H - 1], [-0.7, -0.2], [-3.5, 100.5], [57.9, 10.2],
              [W - 0.5, H - 0.1], [47.0, 10.0], [W - 11.0, H - 11.0]]
    valid = rng.random(n) < 0.8
    valid[:8] = True
    return to_torch(xy), to_torch(valid)


def _contract(left, right, xy, valid, d_max, block, cap=31, texture=10, uniqueness=15):
    """The kernel's contract in numpy: edge-clamped reads into the whole
    prefiltered images (reflect-101 XSobel, rows then columns), the D SADs,
    the first minimum, the uniqueness, parabola, texture and inside tests."""
    def prefilter(img):
        p = np.pad(img, 1, mode="reflect")
        rows = (p[:-2] + np.float32(2.0) * p[1:-1]) + p[2:]           # [h, w + 2]
        s = (np.float32(0.0) - rows[:, :-2]) + rows[:, 2:]
        return np.clip(s + np.float32(cap), 0, 2 * cap).astype(np.float32)

    pl, pr = prefilter(left), prefilter(right)
    h, w = left.shape
    r = block // 2
    out = np.full(len(xy), -1.0, np.float32)
    for n, ((x, y), ok) in enumerate(zip(xy, valid)):
        if not ok:
            continue
        xi = min(max(int(np.trunc(x)), 0), w - 1)
        yi = min(max(int(np.trunc(y)), 0), h - 1)
        rows = np.clip(yi - r + np.arange(block), 0, h - 1)
        lw = pl[rows][:, np.clip(xi - r + np.arange(block), 0, w - 1)]
        rb = pr[rows][:, np.clip(xi - (d_max - 1) - r + np.arange(d_max + block - 1), 0, w - 1)]
        sads = np.array([np.abs(lw - rb[:, d_max - 1 - d:d_max - 1 - d + block]).sum()
                         for d in range(d_max)], np.float32)
        best = int(np.argmin(sads))
        far = np.abs(np.arange(d_max) - best) > 1
        second = sads[far].min() if far.any() else np.float32(np.inf)
        unique_ok = second * np.float32(100) >= sads[best] * np.float32(100 + uniqueness)
        d0 = min(max(best, 1), d_max - 2)
        c_m, c_0, c_p = sads[d0 - 1], sads[d0], sads[d0 + 1]
        denom = max((c_m + c_p) - np.float32(2) * c_0, np.float32(1e-9))
        delta = np.clip((c_m - c_p) / (np.float32(2) * denom), -0.5, 0.5).astype(np.float32)
        disp = np.float32(best) + delta if best == d0 else np.float32(best)
        tex_ok = np.abs(lw - np.float32(cap)).sum() >= texture
        inside = r <= yi < h - r and d_max + r - 1 <= xi < w - r
        if inside and unique_ok and tex_ok:
            out[n] = disp
    return out


@pytest.mark.parametrize("kind", SLOTS)
def test_plain_version_matches_reference(frames, kind):
    from stereo_vo_tpu.ops.stereo_bm import stereo_bm_at as jax_bm_at

    from torch_port_helpers import to_jax

    left, right = frames[0]
    xy, valid, compact = _slots(frames, kind)
    n_valid = int(valid.sum())
    assert len(xy) == (300 if kind == "bootstrap_300" else 300 + F_CAP)
    assert (n_valid <= COMPACT) == (kind != "keyframe_748_gt320")
    want = jax_bm_at(to_jax(left), to_jax(right), to_jax(xy), to_jax(valid),
                     compact_slots=compact)
    got = stereo_bm_at_ref(to_torch(left), to_torch(right), xy, valid, compact_slots=compact)
    assert_equal(got, want)
    assert int((got > 0).sum()) > 20


@pytest.mark.parametrize("d_max,block", SIZES)
def test_contract_matches_plain_version(frames, d_max, block):
    left, right = frames[0]
    xy, valid = _border_slots(200, seed=d_max)
    det_xy, det_valid = detect_features(to_torch(left), FCFG)
    xy, valid = torch.cat([xy, det_xy]), torch.cat([valid, det_valid])
    want = stereo_bm_at_ref(to_torch(left), to_torch(right), xy, valid,
                            num_disparities=d_max, block_size=block)
    got = _contract(left, right, xy.numpy(), valid.numpy(), d_max, block)
    assert_equal(got, want)
    assert int((want > 0).sum()) > 20


@pytest.mark.parametrize("d_max,block", SIZES)
def test_plain_windows_stay_inside_their_regions(d_max, block):
    """At every row and column of a 376x1241 image: the origins need no
    clamp and the window and band lie inside their regions."""
    h, w = 376, 1241
    xi, yi = torch.arange(w), torch.arange(h)      # rows and columns are independent
    m, (ry, rx_l, rx_r), (ox_l, ox_r, oy), (row0, col0_l, col0_r) = _region_geometry(
        xi, yi, h, w, d_max, block)
    r = block // 2
    assert torch.equal(oy, (yi - r + m) // 8 * 8)               # no origin is clamped
    assert torch.equal(ox_l, (xi - r + m) // 8 * 8)
    assert torch.equal(ox_r, (xi - (d_max - 1) - r + m) // 8 * 8)
    assert int(row0.min()) >= 0 and int(row0.max()) + block <= ry
    assert int(col0_l.min()) >= 0 and int(col0_l.max()) + block <= rx_l
    assert int(col0_r.min()) >= 0 and int(col0_r.max()) + d_max + block - 1 <= rx_r


def test_cpu_wrapper_takes_the_plain_version(frames):
    left, right = (to_torch(a) for a in frames[0])
    xy, valid, compact = _slots(frames, "keyframe_748_le320")
    before = stereo_bm_at.launches
    got = stereo_bm_at(left, right, xy, valid, compact_slots=compact)
    assert stereo_bm_at.launches == before       # no kernel launch on the CPU
    assert_equal(got, stereo_bm_at_ref(left, right, xy, valid, compact_slots=compact))


def test_keyframe_bm_input_and_compaction():
    """``utils.profiling.keyframe_bm_input`` (the 748-slot input that
    ``chip_smoke.py`` and ``profile_pair.py`` time): the engine's slot
    layout, at most ``bm_compact_slots`` valid or every slot valid; the
    compacted plain version equals the full-width one on it."""
    from stereo_vo_tpu_torch.core.camera import CameraInfo
    from stereo_vo_tpu_torch.core.config import PipelineConfig
    from stereo_vo_tpu_torch.data.synthetic import SyntheticStereoSequence
    from stereo_vo_tpu_torch.utils.profiling import keyframe_bm_input

    cam = CameraInfo(focal=300.0, cx=160.0, cy=120.0, baseline=0.3)
    cfg = PipelineConfig(camera=cam, frontend=FCFG)
    world = list(SyntheticStereoSequence(cam=cam, n_frames=2, shape=(H, W), n_points=300,
                                         seed=3))
    n = FCFG.max_detect + cfg.backend.feature_capacity
    left, right, xy, valid = keyframe_bm_input(cfg, world[0], world[1], "cpu")
    assert xy.shape == (n, 2) and xy.is_contiguous() and valid.shape == (n,)
    assert 0 < int(valid.sum()) <= FCFG.bm_compact_slots
    assert_equal(stereo_bm_at_ref(left, right, xy, valid, compact_slots=FCFG.bm_compact_slots),
                 stereo_bm_at_ref(left, right, xy, valid))
    _, _, xy_all, valid_all = keyframe_bm_input(cfg, world[0], world[1], "cpu", live=False)
    assert torch.equal(xy_all, xy) and bool(valid_all.all())


def test_empty_and_all_invalid_slot_sets(frames):
    left, right = (to_torch(a) for a in frames[0])
    xy, _ = _border_slots(64, seed=1)
    none = torch.zeros(64, dtype=torch.bool)
    assert_equal(stereo_bm_at(left, right, xy, none), np.full(64, -1.0, np.float32))
    empty = stereo_bm_at(left, right, xy[:0], none[:0])
    assert empty.shape == (0,) and empty.dtype == torch.float32


def _break(args, what):
    left, right, xy, valid = args
    if what == "image dtype":
        left = left.double()
    elif what == "image shapes":
        right = right[:-1]
    elif what == "xy dtype":
        xy = xy.double()
    elif what == "xy shape":
        xy = xy[:, :1]
    elif what == "valid dtype":
        valid = valid.to(torch.uint8)
    elif what == "valid shape":
        valid = valid[:-1]
    elif what == "device mix":
        xy = xy.to("meta")
    elif what == "unsupported device":
        left, right, xy, valid = (t.to("meta") for t in (left, right, xy, valid))
    return left, right, xy, valid


@pytest.mark.parametrize("what", ["image dtype", "image shapes", "xy dtype", "xy shape",
                                  "valid dtype", "valid shape", "device mix",
                                  "unsupported device"])
def test_wrapper_rejects_bad_arguments(frames, what):
    xy, valid = _border_slots(32, seed=2)
    args = _break((to_torch(frames[0][0]), to_torch(frames[0][1]), xy, valid), what)
    with pytest.raises(ValueError):
        stereo_bm_at(*args)


@pytest.mark.parametrize("d_max,block", [(2, 21), (48, 20)])
def test_wrapper_rejects_unsupported_sizes(frames, d_max, block):
    xy, valid = _border_slots(32, seed=2)
    with pytest.raises(ValueError):
        stereo_bm_at(to_torch(frames[0][0]), to_torch(frames[0][1]), xy, valid,
                     num_disparities=d_max, block_size=block)


def _cuda(*ts):
    return [t.cuda().contiguous() for t in ts]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", SLOTS + ["all_invalid_748", "empty"])
def test_cuda_kernel_equals_plain_version(frames, kind):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    left, right = _cuda(*(to_torch(a) for a in frames[0]))
    if kind in SLOTS:
        xy, valid, compact = _slots(frames, kind)
    else:
        xy, _, compact = _slots(frames, "keyframe_748_gt320")
        valid = torch.zeros(len(xy), dtype=torch.bool)
        if kind == "empty":
            xy, valid = xy[:0], valid[:0]
    xy, valid = _cuda(xy, valid)
    want = stereo_bm_at_ref(left, right, xy, valid, compact_slots=compact)
    before = stereo_bm_at.launches
    got = stereo_bm_at(left, right, xy, valid, compact_slots=compact)
    torch.cuda.synchronize()
    assert stereo_bm_at.launches == before + (1 if len(xy) else 0)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("d_max,block", SIZES)
def test_cuda_kernel_equals_plain_version_at_the_borders(frames, d_max, block):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    left, right = _cuda(*(to_torch(a) for a in frames[0]))
    xy, valid = _cuda(*_border_slots(200, seed=d_max))
    kw = dict(num_disparities=d_max, block_size=block)
    got = stereo_bm_at(left, right, xy, valid, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, stereo_bm_at_ref(left, right, xy, valid, **kw))


@pytest.mark.cuda
def test_cuda_wrapper_raises_on_non_contiguous_input(frames):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    left, right = _cuda(*(to_torch(a) for a in frames[0]))
    xy, valid = _cuda(*_border_slots(64, seed=3))
    before = stereo_bm_at.launches
    with pytest.raises(ValueError):
        stereo_bm_at(left, right, xy.t().contiguous().t(), valid)
    with pytest.raises(ValueError):
        stereo_bm_at(left[:, ::2], right[:, ::2], xy, valid)
    assert stereo_bm_at.launches == before
