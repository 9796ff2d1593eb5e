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

# the tier-1 run uses several xdist workers per machine: one thread each
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


def port_camera(jax_cam):
    from stereo_vo_tpu_torch.core.camera import CameraInfo

    return CameraInfo(**dataclasses.asdict(jax_cam))


def jax_pnp_indices(valid, seed: int, n_hyp: int, k: int) -> np.ndarray:
    """The minimal samples ``stereo_vo_tpu/frontend/pnp.py`` draws for one
    frame (``[n_hyp - 1, k]``), rebuilt with the same ``jax.random`` calls."""
    import jax
    import jax.numpy as jnp

    valid = jnp.asarray(np.asarray(valid))
    f_cap = valid.shape[0]
    n_valid = jnp.sum(valid.astype(jnp.int32))
    probs = valid.astype(jnp.float32) / jnp.maximum(n_valid, 1).astype(jnp.float32)
    keys = jax.random.split(jax.random.PRNGKey(seed), n_hyp - 1)
    idx = jax.vmap(
        lambda hk: jax.random.choice(hk, f_cap, shape=(k,), replace=False, p=probs)
    )(keys)
    return np.asarray(idx).astype(np.int64)
