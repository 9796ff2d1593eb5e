"""One LK level pass (``ops/lk.py::lk_level_pass``): the plain version
against the JAX level pass on the CPU, the wrapper's dispatch and checks,
and the CUDA kernel against the plain version on the card.

CPU parity, forward and backward role, at the 56x56 inner-level regions and
the 88x88 top-level regions with N = 32: the JAX side extracts, centers and
runs ``_gn_pass`` exactly as ``_lk_level`` / ``lk_track_fwdbwd`` do. The
port samples by direct indexing where the reference multiplies by selector
matrices and sums the 441-term GN terms in another order, so positions agree
within ``POS_TOL`` = 1e-3 px (as in ``test_torch_lk_track.py``), flags
exactly, and the centering constant within ``CENTER_RTOL`` = 2e-5: both take
an f32 mean of 3136 or 7744 pixels near 128, XLA's CPU reduction in another
order than torch's, measured 2.6e-6 apart.

Kernel vs plain version on the card (``KERNEL_TOL``): the sums again add in
another order, which can flip an eps or oscillation test at its margin, so a
flipped feature takes one iteration more or fewer and moves by up to ~eps =
0.01 px; ``solvable`` flips only with min_eig exactly at its threshold. The
JAX package is imported inside the parity tests only, so on a GPU machine
without JAX the kernel test runs alone:

    python -m pytest tests/test_torch_lk_level.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from stereo_vo_tpu_torch.ops.lk import (
    LK_SLACK,
    LK_SLACK_TOP,
    _image_inside,
    _origins,
    level_geometry,
    lk_level_pass,
    lk_level_pass_ref,
)
from stereo_vo_tpu_torch.ops.pyramid import build_pyramid

from torch_port_helpers import (
    FAST_SHIFTS,
    assert_close,
    assert_equal,
    fast_motion_scene,
    fast_motion_slots,
    shifted,
    to_torch,
)

POS_TOL = 1e-3
CENTER_RTOL = 2e-5
N = 32
HALF, ITERS, EPS, MIN_EIG = 10, 30, 0.01, 1e-2
# kernel vs plain version: solvable flips per call, share of active features
# with equal final ok, px on features ok in both (max, median), centering
# constant relative to max(|c|, 1)
KERNEL_TOL = dict(flips=1, ok_share=0.995, max_px=0.02, median_px=1e-4, center=1e-4)
# (label, pyramid level of a 240x320 frame, slack): an inner level (56x56
# regions), the 30x40 top level and the top of a two-level hinted pyramid
# (88x88 regions)
LEVELS = [("inner_56", 0, LK_SLACK), ("top_88", 3, LK_SLACK_TOP), ("hint_top_88", 1, LK_SLACK_TOP)]


@pytest.fixture(scope="module")
def frames():
    from stereo_vo_tpu_torch.core.camera import CameraInfo
    from stereo_vo_tpu_torch.data.synthetic import SyntheticStereoSequence

    world = SyntheticStereoSequence(cam=CameraInfo(focal=300.0, cx=160.0, cy=120.0,
                                                   baseline=0.3),
                                    n_frames=2, shape=(240, 320), n_points=900, seed=5,
                                    speed=0.5, yaw_rate=0.01)
    return [world.render(i)[0].astype(np.float32) for i in range(2)]


def _pass_inputs(frames, lvl, slack, n, seed, device="cpu"):
    """Forward-role arguments at pyramid level ``lvl``: detected corners of
    frame 0 (tiled to ``n``), guesses within +-slack, ~10% inactive slots;
    also returns the level's points."""
    from stereo_vo_tpu_torch.ops.shi_tomasi import detect_corners

    rng = np.random.default_rng(seed)
    prev = build_pyramid(to_torch(frames[0]), 3)[lvl]
    nxt = build_pyramid(to_torch(frames[1]), 3)[lvl]
    xy, _, valid = detect_corners(to_torch(frames[0]), max_corners=n, min_distance=8.0)
    corners = xy[valid].numpy()
    pts = (corners[np.arange(n) % len(corners)] / 2.0 ** lvl).astype(np.float32)
    guess = (pts + rng.uniform(-slack, slack, pts.shape)).astype(np.float32)
    active = rng.random(n) > 0.1
    region, m = level_geometry(HALF, slack)
    h, w = prev.shape
    pts_t, guess_t = to_torch(pts), to_torch(guess)
    prev_org = _origins(pts_t, HALF, slack, m, h + 2 * m, w + 2 * m, region, region)
    next_org = _origins(guess_t, HALF, slack, m, h + 2 * m, w + 2 * m, region, region)
    tpl_pos = pts_t - HALF + m - prev_org.to(torch.float32)
    args = [prev, nxt, prev_org, next_org, tpl_pos, guess_t, to_torch(active), None,
            HALF, m, region, ITERS, EPS, MIN_EIG]
    return [a.to(device) if isinstance(a, torch.Tensor) else a for a in args], pts_t.to(device)


def _backward_inputs(fwd, pts, fwd_out, seed):
    """Backward-role arguments over the same regions: images and origins
    swap, the template sits at the forward endpoint, guesses start near the
    original points, the forward constant centers both regions."""
    rng = np.random.default_rng(seed)
    half, m = fwd[8], fwd[9]
    slack = m - half - 2
    bwd = list(fwd)
    bwd[0:4] = [fwd[1], fwd[0], fwd[3], fwd[2]]
    bwd[4] = fwd_out[0] - half + m - fwd[3].to(torch.float32)
    bwd[5] = pts + to_torch(rng.uniform(-slack, slack, tuple(pts.shape)).astype(np.float32)).to(
        pts.device)
    bwd[6] = fwd_out[1] & fwd_out[2]
    bwd[7] = fwd_out[3]
    return bwd


def _jax_pass(args):
    """The JAX level pass on the same inputs: ``_extract_regions``,
    ``_center_regions`` with the forward prev region's mean, ``_gn_pass``."""
    import jax.numpy as jnp

    from stereo_vo_tpu.ops import lk as jlk

    tpl_img, it_img, tpl_org, it_org, tpl_pos, guess, active, center, half, m, region = [
        a.numpy() if isinstance(a, torch.Tensor) else a for a in args[:11]]
    tpl_reg = jlk._extract_regions(jlk._pad_edge(jnp.asarray(tpl_img)[None], m),
                                   jnp.asarray(tpl_org), region, region)
    it_reg = jlk._extract_regions(jlk._pad_edge(jnp.asarray(it_img)[None], m),
                                  jnp.asarray(it_org), region, region)
    if center is None:
        # forward: _center_regions subtracts the template (prev) region's mean
        c = jnp.mean(tpl_reg[:, 0], axis=(-2, -1))
        tpl_c, it_c = jlk._center_regions(tpl_reg, it_reg)
    else:
        c = jnp.asarray(center)
        tpl_c, it_c = tpl_reg - c[:, None, None, None], it_reg - c[:, None, None, None]
    out, solvable, in_region = jlk._gn_pass(
        tpl_c, it_c, jnp.asarray(tpl_pos), jnp.asarray(guess), jnp.asarray(active), half,
        ITERS, EPS, MIN_EIG, jnp.asarray(it_org), m)
    return np.asarray(out), np.asarray(solvable), np.asarray(in_region(out)), np.asarray(c)


def _assert_matches_jax(got, args):
    out, solvable, inside, c = _jax_pass(args)
    assert_equal(got[1], solvable, "solvable")
    assert_equal(got[2], inside, "in_region")
    assert solvable.sum() > 0.5 * args[6].sum()
    assert_close(got[0].numpy()[solvable], out[solvable], atol=POS_TOL, what="guess")
    assert_close(got[3], c, atol=0.0, rtol=CENTER_RTOL, what="center")


@pytest.mark.parametrize("label,lvl,slack", LEVELS)
def test_plain_forward_pass_matches_reference(frames, label, lvl, slack):
    fwd, _ = _pass_inputs(frames, lvl, slack, N, seed=lvl)
    got = lk_level_pass_ref(*fwd)
    assert got[4].dtype == torch.int32 and int(got[4].max()) <= ITERS
    _assert_matches_jax(got, fwd)


@pytest.mark.parametrize("label,lvl,slack", LEVELS)
def test_plain_backward_pass_matches_reference(frames, label, lvl, slack):
    fwd, pts = _pass_inputs(frames, lvl, slack, N, seed=lvl)
    bwd = _backward_inputs(fwd, pts, lk_level_pass_ref(*fwd), seed=10 + lvl)
    got = lk_level_pass_ref(*bwd)
    assert got[3] is bwd[7]
    _assert_matches_jax(got, bwd)


def test_cpu_wrapper_takes_the_plain_version(frames):
    fwd, _ = _pass_inputs(frames, 0, LK_SLACK, N, seed=0)
    before = lk_level_pass.launches
    got = lk_level_pass(*fwd)
    assert lk_level_pass.launches == before       # no kernel launch on the CPU
    for g, w in zip(got, lk_level_pass_ref(*fwd)):
        assert_equal(g, w)


def _break(args, what):
    args = list(args)
    if what == "image dtype":
        args[0] = args[0].double()
    elif what == "origin dtype":
        args[2] = args[2].long()
    elif what == "guess shape":
        args[5] = args[5][:, :1]
    elif what == "center shape":
        args[7] = torch.zeros(N + 1)
    elif what == "image shapes":
        args[1] = args[1][:-1]
    elif what == "device mix":
        args[5] = args[5].to("meta")
    elif what == "region":
        args[10] = 512
    return args


@pytest.mark.parametrize("what", ["image dtype", "origin dtype", "guess shape", "center shape",
                                  "image shapes", "device mix", "region"])
def test_wrapper_rejects_bad_arguments(frames, what):
    fwd, _ = _pass_inputs(frames, 0, LK_SLACK, N, seed=0)
    with pytest.raises(ValueError):
        lk_level_pass(*_break(fwd, what))


def _assert_kernel_matches_plain(got, want, args):
    h, w = args[0].shape
    active = args[6]

    def ok(res):
        return res[1] & res[2] & _image_inside(res[0], h, w)

    assert int((got[1] != want[1]).sum()) <= KERNEL_TOL["flips"]
    g_ok, w_ok = ok(got), ok(want)
    assert int(((g_ok == w_ok) & active).sum()) >= KERNEL_TOL["ok_share"] * int(active.sum())
    both = g_ok & w_ok
    assert int(both.sum()) > 0
    d = (got[0] - want[0]).abs().amax(dim=1)[both]
    assert float(d.max()) <= KERNEL_TOL["max_px"] and float(d.median()) <= KERNEL_TOL["median_px"]
    c_err = (got[3] - want[3]).abs() / want[3].abs().clamp(min=1.0)
    assert float(c_err.max()) <= KERNEL_TOL["center"]


@pytest.mark.cuda
@pytest.mark.parametrize("label,lvl,slack", LEVELS)
@pytest.mark.parametrize("role", ["forward", "backward"])
def test_cuda_inactive_slots_equal_plain_version(frames, label, lvl, slack, role):
    """Every other slot inactive, the tracker's full width: an inactive
    slot exits the kernel at once and writes what the plain version writes
    for it, bitwise (its forward-role centre, the one float the two sum in
    another order, within ``KERNEL_TOL``, and bitwise the same slot's
    centre from an all-active launch); an active slot's outputs do not
    depend on its neighbours, bitwise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    fwd, pts = _pass_inputs(frames, lvl, slack, 448, seed=lvl, device="cuda")
    args = fwd if role == "forward" else _backward_inputs(fwd, pts, lk_level_pass_ref(*fwd),
                                                          seed=20 + lvl)
    full = list(args)
    full[6] = torch.ones_like(args[6])
    half = list(args)
    half[6] = torch.arange(448, device="cuda") % 2 == 0
    got = lk_level_pass(*half)
    all_active = lk_level_pass(*full)
    want = lk_level_pass_ref(*half)
    torch.cuda.synchronize()
    off, on = ~half[6], half[6]
    for k in (0, 1, 2, 4):                          # guess, solvable, in_region, iterations
        assert_equal(got[k][off].cpu(), want[k][off].cpu(), f"{label} {role} output {k}")
        assert_equal(got[k][on].cpu(), all_active[k][on].cpu(), f"{label} {role} output {k}")
    assert not bool(got[1][off].any()) and not bool(got[4][off].any())
    assert_equal(got[3].cpu(), all_active[3].cpu(), f"{label} {role} centre")
    c_err = (got[3][off] - want[3][off]).abs() / want[3][off].abs().clamp(min=1.0)
    assert float(c_err.max()) <= KERNEL_TOL["center"]


@pytest.mark.cuda
@pytest.mark.parametrize("label,lvl,slack", LEVELS)
@pytest.mark.parametrize("n", [160, 448])
def test_cuda_kernel_matches_plain_version(frames, label, lvl, slack, n):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    fwd, pts = _pass_inputs(frames, lvl, slack, n, seed=lvl, device="cuda")
    before = lk_level_pass.launches
    want = lk_level_pass_ref(*fwd)
    got = lk_level_pass(*fwd)
    torch.cuda.synchronize()
    assert lk_level_pass.launches == before + 1
    _assert_kernel_matches_plain(got, want, fwd)
    bwd = _backward_inputs(fwd, pts, want, seed=10 + lvl)
    want = lk_level_pass_ref(*bwd)
    got = lk_level_pass(*bwd)
    torch.cuda.synchronize()
    assert lk_level_pass.launches == before + 2
    _assert_kernel_matches_plain(got, want, bwd)


@pytest.mark.cuda
@pytest.mark.parametrize("shift", FAST_SHIFTS)
def test_cuda_fast_motion_kernel_matches_plain(shift):
    """The fast-motion sweep of ``test_torch_lk_track.py`` on the card:
    ``lk_track_fwdbwd`` through the kernel against the same call through the
    plain version, the same fwd/bwd flags and positions within
    ``KERNEL_TOL``. At 200 px the top level's guess sits at 25 of
    ``LK_SLACK_TOP`` = 26 px."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    import stereo_vo_tpu_torch.ops.lk as lk
    from stereo_vo_tpu_torch.ops.shi_tomasi import detect_corners

    img = torch.from_numpy(fast_motion_scene()).cuda()
    cur = torch.from_numpy(shifted(fast_motion_scene(), shift)).cuda()
    xy, _, valid = detect_corners(img, max_corners=128, min_distance=30.0)
    xy, valid = fast_motion_slots(xy.cpu().numpy(), valid.cpu().numpy(), shift, img.shape[1])
    args = (build_pyramid(img, 3), build_pyramid(cur, 3), torch.from_numpy(xy).cuda(),
            torch.from_numpy(valid).cuda())
    before = lk.lk_level_pass.launches
    got = lk.lk_track_fwdbwd(*args, window=21, max_iters=30)
    torch.cuda.synchronize()
    assert lk.lk_level_pass.launches == before + 8
    kernel, lk.lk_level_pass = lk.lk_level_pass, lk.lk_level_pass_ref
    try:
        want = lk.lk_track_fwdbwd(*args, window=21, max_iters=30)
    finally:
        lk.lk_level_pass = kernel
    assert torch.equal(got[1], want[1]) and torch.equal(got[3], want[3])
    for i, ok in ((0, want[1]), (2, want[3])):
        d = (got[i] - want[i]).abs().amax(dim=1)[ok]
        assert int(ok.sum()) > 0 and float(d.max()) <= KERNEL_TOL["max_px"]
