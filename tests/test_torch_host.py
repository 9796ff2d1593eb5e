"""The port's host layer against the JAX package: the KITTI loader and pose
parser, the native PNG decoder binding, ``LiveStereoStream``, the viz
helpers, the world-points dump, the CLI and the smoke entry point.

Tolerances: images, decoded pixels, drawn track images, stream semantics and
CLI summary keys are compared exactly; KITTI poses within 1e-6 (f32
quaternion algebra in both), translations of a random pose file within
2e-7 of their magnitude; ``eval`` numbers within rtol 1e-5 (the same f32
alignment in both packages).
"""

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from stereo_vo_tpu.data import kitti as jax_kitti
from stereo_vo_tpu.data import native_loader as jax_native
from stereo_vo_tpu.eval import viz as jax_viz

from stereo_vo_tpu_torch import cli, smoke
from stereo_vo_tpu_torch.core import geometry as geo
from stereo_vo_tpu_torch.core.config import load_config
from stereo_vo_tpu_torch.data import kitti, native_loader, synthetic
from stereo_vo_tpu_torch.data.stream import LiveStereoStream
from stereo_vo_tpu_torch.data.synthetic import SyntheticStereoSequence
from stereo_vo_tpu_torch.engine.driver import write_world_points
from stereo_vo_tpu_torch.eval import viz
from stereo_vo_tpu_torch.utils.profiling import StageTimer, device_trace, summarize_trace

from torch_port_helpers import (
    SMALL_CONFIG_YAML,
    assert_close,
    assert_equal,
    cpu_engine,
    cpu_run_vo,
    write_kitti_sequence,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures")
CLI_ENV = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")


def _img(v, shape=(24, 32)):
    return np.full(shape, v % 255, np.uint8)


@pytest.fixture(scope="module")
def small_config_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("cfg") / "small.yaml"
    path.write_text(SMALL_CONFIG_YAML)
    return str(path)


@pytest.fixture(scope="module")
def small_frames(small_config_path):
    cfg = load_config(small_config_path)
    return cfg, list(SyntheticStereoSequence(
        cam=cfg.camera, n_frames=14, shape=(240, 320), n_points=500, seed=11,
        speed=0.35, yaw_rate=0.004, point_depth=(5.0, 18.0)))


def _run_cli(module, *args, timeout=300):
    return subprocess.run([sys.executable, "-m", module, *args], cwd=REPO, env=CLI_ENV,
                          capture_output=True, text=True, timeout=timeout)


# ---------------------------------------------------------------------------
# KITTI data layer and the native decoder
# ---------------------------------------------------------------------------


def test_kitti_sequence_matches_jax():
    ours = kitti.KittiSequence(FIXTURES, "real")
    ref = jax_kitti.KittiSequence(FIXTURES, "real")
    assert len(ours) == len(ref) == 5
    assert_close(ours.gt_poses, ref.gt_poses, atol=1e-6, what="gt poses")
    for i in (0, 4):
        a, b = ours[i], ref[i]
        assert_equal(a.left, b.left, f"left {i}")
        assert_equal(a.right, b.right, f"right {i}")
        assert a.index == b.index and a.stamp == b.stamp
    replayed = list(kitti.kitti_replay(FIXTURES, "real", max_frames=3))
    assert [f.index for f in replayed] == [0, 1, 2]
    assert_equal(replayed[2].left, ref[2].left, "prefetched frame")


def test_sample_photo_copy_equals_matplotlib_file():
    """The port's photo texture is matplotlib's ``grace_hopper.jpg``, byte
    for byte (61,306 bytes, a JPEG)."""
    with open(synthetic.SAMPLE_PHOTO, "rb") as f:
        ours = f.read()
    assert len(ours) == 61306 and ours[:3] == b"\xff\xd8\xff"
    try:
        import matplotlib
    except ImportError:
        return
    path = os.path.join(os.path.dirname(matplotlib.__file__), "mpl-data", "sample_data",
                        "grace_hopper.jpg")
    with open(path, "rb") as f:
        assert f.read() == ours


def test_sample_photo_matches_jax_loader_without_matplotlib(monkeypatch):
    from stereo_vo_tpu.data.synthetic import load_sample_photo as jax_load_sample_photo

    want = jax_load_sample_photo()
    assert want is not None and want.shape == (600, 512)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    assert_equal(synthetic.load_sample_photo(), want, "photo texture")


def test_parse_kitti_poses_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    q = rng.normal(size=(20, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    r = geo.quat_to_rotmat(torch.from_numpy(q)).numpy()
    t = rng.uniform(-50, 50, size=(20, 3))
    path = tmp_path / "poses.txt"
    np.savetxt(path, np.concatenate([r, t[:, :, None]], axis=2).reshape(20, 12))
    got, want = kitti.parse_kitti_poses(str(path)), jax_kitti.parse_kitti_poses(str(path))
    assert_close(got[:, :4], want[:, :4], atol=1e-6, what="q_cw")
    # t_cw = -R_cw t_wc: f32 rounding scales with |t| (up to 87 m here)
    assert_close(got[:, 4:], want[:, 4:], atol=2e-7 * float(np.abs(t).sum(axis=1).max()),
                 what="t_cw")


def test_native_decoder_matches_jax(tmp_path):
    cv2 = pytest.importorskip("cv2")
    assert native_loader.native_available(), native_loader.build_error()
    paths = [os.path.join(FIXTURES, "real", side, "000002.png") for side in ("image_0", "image_1")]
    img = np.random.default_rng(1).integers(0, 255, (37, 53), dtype=np.uint8)
    cv2.imwrite(str(tmp_path / "r.png"), img)
    paths.append(str(tmp_path / "r.png"))
    for p in paths:
        assert_equal(native_loader.read_png_gray(p), jax_native.read_png_gray(p), p)
    assert_equal(native_loader.read_png_gray(paths[-1]), img, "random png")
    with pytest.raises(IOError):
        native_loader.read_png_gray(str(tmp_path / "missing.png"))
    seq = os.path.join(FIXTURES, "real")
    loader = native_loader.NativeStereoLoader(os.path.join(seq, "image_0"),
                                              os.path.join(seq, "image_1"), prefetch=2)
    got = list(loader)
    loader.close()
    assert len(got) == 5
    assert_equal(got[3][0], jax_native.read_png_gray(os.path.join(seq, "image_0", "000003.png")))


# ---------------------------------------------------------------------------
# LiveStereoStream (copies of tests/test_stream.py)
# ---------------------------------------------------------------------------


def test_live_sync_pairs_within_slop_and_drops_unmatched():
    s = LiveStereoStream(sync_slop=0.02, drop_time=0.0, maxlen=100)
    s.push_left(_img(1), 0.100)
    s.push_right(_img(2), 0.110)
    s.push_left(_img(3), 0.150)      # orphan, older than the next right by > slop
    s.push_right(_img(4), 0.300)
    s.push_left(_img(5), 0.305)
    s.close()
    frames = list(s)
    assert [f.stamp for f in frames] == [0.100, 0.300]
    assert s.dropped == 1
    assert frames[0].left[0, 0] == 1 and frames[0].right[0, 0] == 2
    assert frames[1].left[0, 0] == 5 and frames[1].right[0, 0] == 4


def test_live_bounded_queue_drops_oldest():
    s = LiveStereoStream(sync_slop=0.02, drop_time=0.0, maxlen=3)
    for i in range(6):
        s.push_right(_img(i), i * 0.1)
    for i in range(6):
        s.push_left(_img(i + 10), i * 0.1)
    s.close()
    frames = list(s)
    assert len(frames) == 3 and s.dropped == 3
    assert np.allclose([f.stamp for f in frames], [0.3, 0.4, 0.5])
    assert [f.index for f in frames] == [3, 4, 5]


def test_live_drop_gate_on_close_pairs():
    s = LiveStereoStream(sync_slop=0.01, drop_time=0.05, maxlen=100)
    s.push(_img(0), _img(0), 0.10)
    s.push(_img(1), _img(1), 0.12)
    s.push(_img(2), _img(2), 0.20)
    s.close()
    assert [f.stamp for f in s] == [0.10, 0.20]
    assert s.dropped == 1


def test_live_producer_thread_and_blocking_consumer():
    s = LiveStereoStream(sync_slop=0.005, drop_time=0.0, maxlen=10)
    got = []

    def consume():
        for f in s:
            got.append(f.stamp)

    t = threading.Thread(target=consume)
    t.start()
    for i in range(5):
        s.push_left(_img(i), i * 0.05)
        time.sleep(0.002)
        s.push_right(_img(i), i * 0.05 + 0.001)
    time.sleep(0.05)
    s.close()
    t.join(timeout=5)
    assert not t.is_alive()
    assert len(got) == 5 and s.dropped == 0


def test_live_stream_through_run_vo(small_frames):
    cfg, frames = small_frames
    s = LiveStereoStream(sync_slop=0.02, drop_time=0.0, maxlen=50)

    def produce():
        rng = np.random.default_rng(3)
        for i, f in enumerate(frames):
            t = i * 0.09
            jl, jr = float(rng.uniform(0, 0.005)), float(rng.uniform(0, 0.005))
            if i % 3 == 0:
                s.push_right(f.right, t + jr)
                s.push_left(f.left, t + jl)
            else:
                s.push_left(f.left, t + jl)
                s.push_right(f.right, t + jr)
            if i == 5:
                s.push_left(f.left, t + 0.045)   # orphan: discarded by the matcher
            time.sleep(0.05)
        s.close()

    t = threading.Thread(target=produce)
    t.start()
    run = cpu_run_vo(s, cfg)
    t.join(timeout=30)
    assert not t.is_alive()
    assert s.dropped == 1
    assert len(run.poses) == len(frames) and np.isfinite(run.poses).all()
    kf = [st["is_keyframe"] for st in run.frame_stats]
    assert kf[0] and sum(kf) >= 2
    assert np.linalg.norm(run.poses[-1][4:]) > 0.5


# ---------------------------------------------------------------------------
# viz, image writes, world points
# ---------------------------------------------------------------------------


def _tracks():
    rng = np.random.default_rng(4)
    image = rng.integers(0, 255, (60, 90), dtype=np.uint8)
    from_xy = rng.uniform(-5, 95, (40, 2)).astype(np.float32)
    to_xy = (from_xy + rng.normal(0, 6, (40, 2))).astype(np.float32)
    valid = rng.uniform(size=40) < 0.7
    return image, from_xy, to_xy, valid


@pytest.mark.parametrize("with_cv2", [False, True])
def test_draw_tracks_matches_jax(monkeypatch, with_cv2):
    if with_cv2:
        pytest.importorskip("cv2")
    else:
        monkeypatch.setitem(sys.modules, "cv2", None)
    args = _tracks()
    got = viz.draw_tracks(*args)
    assert got.shape == (60, 90, 3) and got.dtype == np.uint8
    assert_equal(got, jax_viz.draw_tracks(*args), "track image")


def test_write_image_without_cv2_writes_npy(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "cv2", None)
    img = viz.draw_tracks(*_tracks())
    written = viz.write_image(str(tmp_path / "tracks_000000.png"), img)
    assert written.endswith("tracks_000000.png.npy")
    assert_equal(np.load(written), img)


def test_plot_trajectory(monkeypatch, tmp_path):
    pytest.importorskip("matplotlib")
    pos = np.cumsum(np.random.default_rng(5).normal(size=(20, 3)), axis=0)
    out = str(tmp_path / "traj.png")
    assert viz.plot_trajectory(pos, pos + 0.1, out_path=out) == out
    assert os.path.getsize(out) > 0
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(RuntimeError, match="matplotlib"):
        viz.plot_trajectory(pos)


def test_world_points_file_format(small_frames, tmp_path):
    cfg, frames = small_frames
    engine = cpu_engine(cfg, (240, 320))
    state, _ = engine.bootstrap(engine.init_state(), frames[0].left, frames[0].right)
    path = str(tmp_path / "points.txt")
    write_world_points(path, state.window)
    valid = state.window.lm_valid.numpy()
    rows = open(path).read().splitlines()
    assert len(rows) == int(valid.sum()) > 20
    fields = [r.split() for r in rows]
    assert all(len(f) == 5 for f in fields)
    assert [int(f[0]) for f in fields] == list(np.nonzero(valid)[0])
    assert_close(np.array([[float(v) for v in f[1:4]] for f in fields]),
                 state.window.lm_pos.numpy()[valid], atol=1e-6, what="xyz")
    assert [int(f[4]) for f in fields] == list(state.window.lm_refcount.numpy()[valid])


# ---------------------------------------------------------------------------
# CLI, smoke, profiling
# ---------------------------------------------------------------------------


def test_cli_run_and_eval_match_jax_cli(small_config_path, tmp_path, monkeypatch, capsys):
    """``run --synthetic 6 --device cpu`` and ``eval`` as subprocesses of the
    port's CLI. The JAX CLI builds its summary from the same run (its
    ``run_vo`` handed the port's results, so no JAX pipeline is compiled) and
    evaluates the same files."""
    from stereo_vo_tpu import cli as jax_cli
    from stereo_vo_tpu import engine as jax_engine

    out = tmp_path / "torch"
    common = ["run", "--config", small_config_path, "--synthetic", "6",
              "--synthetic-shape", "240", "320", "--synthetic-points", "500", "--quiet"]
    proc = _run_cli("stereo_vo_tpu_torch.cli", *common, "--device", "cpu", "--out", str(out))
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    for name in ("metrics.jsonl", "trajectory_kitti.txt", "trajectory_tum.txt"):
        assert (out / name).exists(), name
    stats = [json.loads(line) for line in open(out / "metrics.jsonl")]
    assert got["frames"] == len(stats) == 6
    assert got["keyframes"] == sum(s["is_keyframe"] for s in stats)

    class _Run:
        poses = np.zeros((len(stats), 7), np.float32)
        frame_stats = stats
        frames_per_sec = got["frames_per_sec"]
        ate = got["ate"]

    monkeypatch.setattr(jax_engine, "run_vo", lambda *a, **k: _Run())
    assert jax_cli.main([*common, "--platform", "cpu"]) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert want == got and list(want) == list(got) and list(want["ate"]) == list(got["ate"])

    # eval: the TUM estimate against the KITTI file of the same run, aligned
    args = ["eval", "--est", str(out / "trajectory_tum.txt"),
            "--gt", str(out / "trajectory_kitti.txt")]
    proc = _run_cli("stereo_vo_tpu_torch.cli", *args)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout)
    assert jax_cli.main(args) == 0
    want = json.loads(capsys.readouterr().out)
    assert list(got) == list(want) == ["ate", "rpe_1"]
    for metric in got:
        assert list(got[metric]) == list(want[metric])
        for k, v in want[metric].items():
            assert got[metric][k] == pytest.approx(v, rel=1e-5, abs=1e-6), (metric, k)


def test_cli_run_kitti_layout_writes_outputs(small_config_path, small_frames, tmp_path, monkeypatch):
    """The phase the H100 smoke runs on the real fixtures, here at 240x320 on
    the CPU: KITTI replay, chunked, world points and track images."""
    pytest.importorskip("cv2")
    _, frames = small_frames
    write_kitti_sequence(tmp_path / "kitti", "small", frames[:7])
    out = tmp_path / "out"
    monkeypatch.setitem(sys.modules, "cv2", None)      # track images as .npy
    rc = cli.main(["run", "--config", small_config_path, "--kitti-root", str(tmp_path / "kitti"),
                   "--sequence", "small", "--device", "cpu", "--out", str(out),
                   "--chunk-size", "3", "--checkpoint-every", "4", "--save-world-points",
                   "--save-track-images", "2", "--quiet"])
    assert rc == 0
    files = set(os.listdir(out))
    assert {"metrics.jsonl", "trajectory_kitti.txt", "trajectory_tum.txt", "checkpoint.npz",
            "world_points", "tracks_000000.png.npy"} <= files
    assert len(open(out / "metrics.jsonl").read().splitlines()) == 7
    dumps = sorted(os.listdir(out / "world_points"))
    assert dumps and all(np.loadtxt(out / "world_points" / d).shape[1] == 5 for d in dumps)


def test_cli_run_refuses_missing_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = _run_cli("stereo_vo_tpu_torch.cli", "run", "--config", "kitti00", "--synthetic", "3")
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert cli.main(["run", "--config", "kitti00", "--synthetic", "3", "--device", "cuda"]) == 2


def test_cli_plot_without_matplotlib_fails_early(monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    rc = cli.main(["run", "--config", "kitti00", "--synthetic", "3", "--device", "cpu",
                   "--plot", "--out", "unused"])
    assert rc == 2
    assert "matplotlib" in capsys.readouterr().err


def test_cli_configs_match_jax(capsys):
    from stereo_vo_tpu import cli as jax_cli

    assert cli.main(["configs"]) == 0
    ours = capsys.readouterr().out
    assert jax_cli.main(["configs"]) == 0
    assert ours == capsys.readouterr().out
    assert "kitti00" in ours.split()


def test_smoke_fails_without_the_device(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert smoke.main(["--device", "cuda"]) == 1
    assert "FAIL" in capsys.readouterr().out


def test_stage_timer_and_trace_summary(tmp_path):
    timer = StageTimer()
    a = torch.rand(64, 64)
    with device_trace(str(tmp_path / "trace")) as prof:
        for _ in range(3):
            with timer.stage("matmul"):
                a = torch.tanh(a @ a)
    summary = timer.summary()
    assert summary["matmul"]["count"] == 3 and summary["matmul"]["total_s"] >= 0
    rows = summarize_trace(prof, top=5)
    assert rows and all(ms >= 0 for ms, _ in rows)
    assert [ms for ms, _ in rows] == sorted((ms for ms, _ in rows), reverse=True)
    assert any("mm" in name for _, name in rows)
    assert (tmp_path / "trace" / "trace.json").exists()


def test_profile_pair_refuses_without_the_device():
    """``profile_pair.py`` prints its usage (exit 2) without exactly one tree
    and exits 1 before running a turn when no CUDA device is present."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    script = os.path.join(REPO, "profile_pair.py")
    usage = subprocess.run([sys.executable, script], capture_output=True, text=True,
                           timeout=120)
    assert usage.returncode == 2 and "profile_pair.py <dir>" in usage.stderr
    proc = subprocess.run([sys.executable, script, REPO], capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 1 and "no CUDA device" in proc.stderr
    assert proc.stdout == ""
