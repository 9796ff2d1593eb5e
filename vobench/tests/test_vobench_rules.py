"""The harness's refusals, the no-JAX rule and the end-to-end arithmetic."""

import json
import os
import subprocess
import sys

import numpy as np

from vobench import manifest
from vobench.drive import Chunk, Step, Window
from vobench.metrics import end_to_end

FORBIDDEN = ("jax", "jaxlib", "flax", "stereo_vo_tpu")


def _python(code, cwd=manifest.ROOT, env=None):
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, capture_output=True,
                          text=True, timeout=300, env=env)


def test_no_jax_after_importing_harness_and_reference():
    """Whole top-level names: ``stereo_vo_tpu_torch`` is the port, allowed;
    ``stereo_vo_tpu`` is the JAX package, not."""
    code = (
        "import sys, json\n"
        "import vobench.run, vobench.drive, vobench.trace, vobench.check, vobench.control\n"
        "import vobench.readings\n"
        "import vobench.reference.engine.step, vobench.reference.tf32\n"
        "import stereo_vo_tpu_torch.engine.step, stereo_vo_tpu_torch.engine.graphs\n"
        "from vobench import manifest\n"
        "for w in json.load(open('BENCHMARK.json'))['workloads']:\n"
        "    manifest.load_cell(w['name'])\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n"
    )
    out = _python(code)
    assert out.returncode == 0, out.stderr
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "stereo_vo_tpu_torch" in tops
    assert not tops & set(FORBIDDEN), tops & set(FORBIDDEN)


def test_forbidden_modules_compares_whole_names():
    from vobench import run

    before = set(sys.modules)
    try:
        sys.modules.setdefault("stereo_vo_tpu_torch_fake", object())
        assert "stereo_vo_tpu_torch_fake" not in run.forbidden_modules()
        sys.modules.setdefault("stereo_vo_tpu.fake", object())
        assert "stereo_vo_tpu" in run.forbidden_modules()
    finally:
        for k in set(sys.modules) - before:
            del sys.modules[k]


def test_exits_nonzero_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-m", "vobench.run", "--workload", "kitti00.stream",
                          "--seed", "3000000000", "--seconds", "1", "--trace", "0"],
                         cwd=manifest.ROOT, capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_exits_nonzero_without_the_port(tmp_path):
    """In a directory holding only BENCHMARK.json and vobench/."""
    import shutil

    shutil.copy(os.path.join(manifest.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(manifest.HERE, tmp_path / "vobench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    env = dict(os.environ, PYTHONPATH="")
    out = subprocess.run([sys.executable, "-m", "vobench.run", "--workload", "kitti00.stream",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode != 0 and out.stdout.strip() == ""


def _window(stall_s=0.0):
    """A fake window of 200 streamed steps of 4 ms, every tenth a 20 ms
    keyframe step, and 6 chunks of 64 frames; ``stall_s`` added to one step
    in ten and to the window."""
    win = Window(mode="stream")
    kf = np.zeros(19, np.float32)
    kf[7] = 1
    cruise = np.zeros(19, np.float32)
    for i in range(200):
        slow = i % 10 == 0
        win.steps.append(Step("step", (0.020 if slow else 0.004) + (stall_s if i % 10 == 5 else 0),
                              kf if slow else cruise))
    win.chunks = [Chunk(64, 240.0, True) for _ in range(6)]
    win.frames = 6 * 64
    win.seconds = 1.6 + 20 * stall_s
    return win


def test_a_stall_moves_every_end_to_end_metric():
    base, stalled = end_to_end(_window()), end_to_end(_window(stall_s=0.5))
    assert stalled["replay_fps"] < base["replay_fps"]
    assert stalled["step_p95_ms"] > base["step_p95_ms"]
    # a stall in one step of ten lands in the median once it shifts the order
    many = end_to_end(_window(stall_s=0.5)), end_to_end(_window())
    assert many[0]["step_p50_ms"] >= many[1]["step_p50_ms"]
    win = _window()
    for s in win.steps[:120]:
        s.seconds += 0.003
    assert end_to_end(win)["step_p50_ms"] > base["step_p50_ms"]


def test_layer_readers_on_a_fake_window():
    readers = {m: manifest.reader(m) for m in
               ("cruise_step_ms", "kf_step_ms", "chunk_device_ms_per_frame", "chunk_gap_pct")}
    win = _window()
    assert abs(readers["cruise_step_ms"](win) - 4.0) < 1e-9
    assert abs(readers["kf_step_ms"](win) - 20.0) < 1e-9
    assert abs(readers["chunk_device_ms_per_frame"](win) - 240.0 / 64) < 1e-9
    assert abs(readers["chunk_gap_pct"](win) - 100 * (1 - 1.44 / 1.6)) < 1e-9
    assert readers["chunk_gap_pct"](Window(mode="stream")) is None


def test_trajectory_error_against_the_ground_truth():
    from vobench import check
    from vobench.world import gt_poses

    cfg = manifest.load_json(os.path.join(manifest.HERE, "configs", "kitti00.json"))
    gt = gt_poses(cfg, 12, 5)
    summ = np.zeros((12, 19))
    summ[:, :7] = gt
    summ[::3, 7] = 1.0                      # every third frame a keyframe
    assert check.traj_err(summ, gt, 0.8) < 1e-6
    moved = summ.copy()
    moved[:, 4] += 0.4                      # t_cw moved: centers by -R^T (0.4, 0, 0)
    assert abs(check.traj_err(moved, gt, 0.8) - 0.5) < 1e-6
    summ[:, 7] = 0.0
    assert check.traj_err(summ, gt, 0.8) == float("inf")


def test_one_flipped_step_moves_no_median_and_a_lower_precision_moves_them():
    """The compared medians over the sampled keyframe steps: one step that
    took the other side of a threshold reads far off and moves none of
    them; small gaps on every keyframe step move them all."""
    from vobench import check

    def rows(gap, flipped=None):
        out = []
        for k in range(12):
            r = {"dq": gap * 1e-2, "dt": gap, "ints": 0.0, "fidx": 0.0, "lm": gap * 10,
                 "kf": float(k % 2 == 0)}
            if k == flipped:
                r.update(dq=1e-3, dt=0.5, lm=3.0, ints=1.0)
            out.append(r)
        return out

    sound, flipped, lower = (check.step_numbers(rows(1e-6)),
                             check.step_numbers(rows(1e-6, flipped=4)),
                             check.step_numbers(rows(1e-4)))
    for k in ("kf_lm_median", "kf_quat_median", "kf_trans_median"):
        assert flipped[k] == sound[k] and abs(lower[k] / sound[k] - 100) < 1e-9
    assert flipped["trans_gap"] == 0.5 and flipped["int_frames"] == 1.0
    assert check.step_numbers(rows(1e-6) + [None])["kf_lm_median"] == float("inf")
