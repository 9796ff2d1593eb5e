"""Shared helpers for the PyTorch port's parity tests (``test_torch_*.py``).

Each parity test makes its inputs with numpy from a seed, feeds them to the
JAX function (on the CPU, as the JAX package's own tests run it) and to its
counterpart in ``stereo_vo_tpu_torch``, and compares the results at a stated
tolerance. Data crosses between the two frameworks only as numpy arrays.

JAX is imported inside the helpers that need it, so the ``cuda``-marked tests
can also run on a GPU machine that has no JAX.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# torch's own thread count, before the tier-1 run's several xdist workers
# per machine take one thread each
DEFAULT_THREADS = torch.get_num_threads()
torch.set_num_threads(1)


def to_torch(x, dtype=None):
    """numpy / JAX array (or a tuple/list of them) -> CPU torch tensor(s)."""
    if isinstance(x, (tuple, list)):
        return type(x)(to_torch(v, dtype) for v in x)
    t = torch.from_numpy(np.array(np.asarray(x), copy=True))
    return t if dtype is None else t.to(dtype)


def to_jax(x):
    import jax.numpy as jnp

    if isinstance(x, (tuple, list)):
        return type(x)(to_jax(v) for v in x)
    return jnp.asarray(np.asarray(x))


def to_numpy(x):
    if isinstance(x, (tuple, list)):
        return type(x)(to_numpy(v) for v in x)
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_close(got, want, atol, rtol=0.0, what=""):
    """Elementwise parity of a port output against the JAX output."""
    got, want = to_numpy(got), to_numpy(want)
    assert got.shape == want.shape, f"{what}: shape {got.shape} != {want.shape}"
    if got.dtype == np.bool_ or np.issubdtype(got.dtype, np.integer):
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        np.testing.assert_allclose(got, want, atol=atol, rtol=rtol, err_msg=what)


def assert_equal(got, want, what=""):
    """Bitwise parity (values and dtype kind)."""
    got, want = to_numpy(got), to_numpy(want)
    assert got.shape == want.shape, f"{what}: shape {got.shape} != {want.shape}"
    np.testing.assert_array_equal(got, want, err_msg=what)


def port_config(jax_cfg):
    """The port's ``PipelineConfig`` with the same values as a JAX one."""
    from stereo_vo_tpu_torch.core import config as tc
    from stereo_vo_tpu_torch.core.camera import CameraInfo

    return tc.PipelineConfig(
        camera=CameraInfo(**dataclasses.asdict(jax_cfg.camera)),
        frontend=tc.FrontendConfig(**dataclasses.asdict(jax_cfg.frontend)),
        backend=tc.BackendConfig(**dataclasses.asdict(jax_cfg.backend)),
        runtime=tc.RuntimeConfig(**dataclasses.asdict(jax_cfg.runtime)),
        left_topic=jax_cfg.left_topic,
        right_topic=jax_cfg.right_topic,
        frame_rate=jax_cfg.frame_rate,
        name=jax_cfg.name,
    )


def cpu_engine(config, image_shape):
    """The port's ``VOEngine`` on the CPU (its default device is ``cuda``)."""
    from stereo_vo_tpu_torch.engine.step import VOEngine

    return VOEngine(config, image_shape, device="cpu")


def cpu_run_vo(stream, config, **kwargs):
    """The port's ``run_vo`` on the CPU (its default device is ``cuda``)."""
    from stereo_vo_tpu_torch.engine.driver import run_vo

    return run_vo(stream, config, device="cpu", **kwargs)


def port_camera(jax_cam):
    from stereo_vo_tpu_torch.core.camera import CameraInfo

    return CameraInfo(**dataclasses.asdict(jax_cam))


SMALL_CONFIG_YAML = """\
# 240x320 test camera with the small-world front/back-end settings
focal_length: 400.0
cx: 160.0
cy: 120.0
baseline: 0.5
frame_rate: 11
frontend:
  min_distance: 12.0
  parallax_thresh: 10.0
backend:
  feature_capacity: 384
  landmark_capacity: 1024
  max_lm_iters: 8
"""


def write_kitti_sequence(root, name, frames):
    """Write ``frames`` (``StereoFrame``s with ground truth) as a KITTI-layout
    sequence ``root/name/image_{0,1}/NNNNNN.png`` + ``root/name/name.txt``."""
    import os

    import cv2

    from stereo_vo_tpu_torch.eval.trajectory import write_kitti_trajectory

    seq = os.path.join(str(root), name)
    for side in ("image_0", "image_1"):
        os.makedirs(os.path.join(seq, side), exist_ok=True)
    for i, f in enumerate(frames):
        cv2.imwrite(os.path.join(seq, "image_0", f"{i:06d}.png"), f.left)
        cv2.imwrite(os.path.join(seq, "image_1", f"{i:06d}.png"), f.right)
    write_kitti_trajectory(os.path.join(seq, name + ".txt"), np.stack([f.gt_pose for f in frames]))
    return seq


def _jax_draw(valid, seed, n_hyp: int, k: int):
    """The ``jax.random`` calls of ``stereo_vo_tpu/frontend/pnp.py::pnp_ransac``
    on a valid mask and a uint32 seed (the frame index)."""
    import jax
    import jax.numpy as jnp

    f_cap = valid.shape[0]
    n_valid = jnp.sum(valid.astype(jnp.int32))
    probs = valid.astype(jnp.float32) / jnp.maximum(n_valid, 1).astype(jnp.float32)
    keys = jax.random.split(jax.random.PRNGKey(seed), n_hyp - 1)
    return jax.vmap(
        lambda hk: jax.random.choice(hk, f_cap, shape=(k,), replace=False, p=probs)
    )(keys)


def jax_pnp_indices(valid, seed: int, n_hyp: int, k: int) -> np.ndarray:
    """The minimal samples ``stereo_vo_tpu/frontend/pnp.py`` draws for one
    frame (``[n_hyp - 1, k]``), rebuilt with the same ``jax.random`` calls."""
    import jax.numpy as jnp

    idx = _jax_draw(jnp.asarray(np.asarray(valid)), np.uint32(seed), n_hyp, k)
    return np.asarray(idx).astype(np.int64)


def jax_pnp_indices_batch(valids, seeds, n_hyp: int, k: int) -> np.ndarray:
    """``jax_pnp_indices`` for each row of ``valids [B, F]`` and of ``seeds
    [B]``, in one jitted call: ``[B, n_hyp - 1, k]``."""
    import jax
    import jax.numpy as jnp

    draw = jax.jit(jax.vmap(lambda v, s: _jax_draw(v, s, n_hyp, k)))
    idx = draw(jnp.asarray(np.asarray(valids)), jnp.asarray(np.asarray(seeds, np.uint32)))
    return np.asarray(idx).astype(np.int64)


FAST_SHIFTS = (40, 100, 160, 200)


def fast_motion_scene():
    """``tests/test_lk_fast_motion.py``'s scene: a unique band-limited
    texture at 376x1241 (uint8 values as float32), through the port's copy of
    the JAX package's noise generator."""
    from stereo_vo_tpu_torch.data.synthetic import _smooth_noise

    rng = np.random.default_rng(3)
    img = np.clip(128.0 + _smooth_noise(rng, 376, 1241, octaves=5, amp=55.0), 0, 255)
    return img.astype(np.uint8).astype(np.float32)


def shifted(img, shift: int):
    """``img`` moved ``shift`` px to the right, zeros entering on the left."""
    cur = np.zeros_like(img)
    cur[:, shift:] = img[:, : img.shape[1] - shift]
    return cur


def fast_motion_slots(xy, valid, shift: int, width: int):
    """Corner slots whose target stays 30 px inside the frame; the others
    invalid at an arbitrary position, as the tracker's are."""
    xy, valid = np.array(xy, np.float32), np.array(valid, bool)
    valid &= xy[:, 0] + shift < width - 30
    xy[~valid] = np.array([5.0, 7.0], np.float32)
    return xy, valid


def nms_pool(name: str):
    """A greedy-NMS candidate pool made with numpy from a seed, for the edges
    of ``csrc/greedy_nms.cu``: ``(cxy [C, 2] float32, cvalid [C] bool,
    r2)``, candidates in index order (the sweep's order).

    ``single``: one candidate. ``random<C>_sparse`` / ``random<C>_dense``:
    integer pixels over a 1241x376 frame / a 160x160 patch (many conflicts a
    candidate), 90% valid. ``cell_borders``: ``r2`` 1024, so the kernel's
    cell side is 32 = sqrt(r2), and coordinates on, and one ulp either side
    of, the multiples of 32, zero and the smallest subnormals of either sign
    included. ``ulp_pairs``: pairs at d2 = r2 exactly and one ulp either
    side, far apart from each other. ``wide``: clusters and candidates
    spread over a million pixels, more cells than the kernel's grid holds at
    the smallest side. ``nonfinite``: NaN, infinite and near-overflow
    coordinates among a cluster."""
    f32 = np.float32
    up = lambda v: np.nextafter(f32(v), f32(np.inf))        # noqa: E731
    down = lambda v: np.nextafter(f32(v), f32(-np.inf))     # noqa: E731
    if name == "single":
        return np.array([[5.0, 5.0]], f32), np.ones(1, bool), 900.0
    if name.startswith("random"):
        c, density = name[6:].split("_")
        c = int(c)
        rng = np.random.default_rng(c * 2 + (density == "dense"))
        span = (1241, 376) if density == "sparse" else (160, 160)
        cxy = np.stack([rng.integers(0, span[0], c), rng.integers(0, span[1], c)], 1)
        return cxy.astype(f32), rng.random(c) < 0.9, 900.0
    if name == "cell_borders":
        tiny = np.nextafter(f32(0), f32(1))
        xs = [-64.0, down(-32), -32.0, up(-32), -tiny, -0.0, 0.0, tiny, down(32), 32.0, up(32),
              down(64), 64.0, up(64), down(96), 96.0, down(128)]
        ys = [0.0, down(32), 32.0, up(32), 64.0, down(-32)]
        cxy = np.array([[x, y] for y in ys for x in xs], f32)
        order = np.random.default_rng(5).permutation(len(cxy))
        return cxy[order], np.ones(len(cxy), bool), 1024.0
    if name == "ulp_pairs":
        pairs = []
        for g, (dx, dy) in enumerate([(30.0, 0.0), (down(30), 0.0), (up(30), 0.0),
                                      (18.0, 24.0), (18.0, down(24)), (18.0, up(24)),
                                      (0.0, 30.0), (0.0, down(30)), (30.0, 1e-3)]):
            x0, y0 = f32(200 * g + 50), f32(100)
            pairs += [[x0, y0], [f32(x0 + f32(dx)), f32(y0 + f32(dy))]]
        return np.array(pairs, f32), np.ones(len(pairs), bool), 900.0
    if name == "wide":
        rng = np.random.default_rng(7)
        spread = rng.integers(0, 1_000_000, (512, 2))
        near = rng.integers(0, 80, (512, 2)) + rng.integers(0, 4, (512, 1)) * 250_000
        cxy = np.concatenate([spread, near])[rng.permutation(1024)]
        return cxy.astype(f32), rng.random(1024) < 0.9, 900.0
    if name == "nonfinite":
        rng = np.random.default_rng(9)
        cxy = rng.integers(0, 100, (256, 2)).astype(f32)
        odd = [np.nan, np.inf, -np.inf, f32(3e38), f32(-3e38)]
        for k in range(40):
            cxy[rng.integers(0, 256), rng.integers(0, 2)] = odd[k % len(odd)]
        return cxy, rng.random(256) < 0.95, 900.0
    raise ValueError(name)
