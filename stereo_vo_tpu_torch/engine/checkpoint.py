"""Checkpoint / resume (counterpart of ``stereo_vo_tpu/engine/checkpoint.py``).

The reference loses all state on a crash (SURVEY.md §5 "Checkpoint / resume"):
window, landmark table and tracker live only in process memory
(``bundle_adjuster.hpp:134-149``). Here a checkpoint is a flat ``np.savez`` of
the state's leaves in the JAX package's leaf order (``engine/convert.py``),
under the same keys (``__next_frame__``, ``leaf_{i}``), so a checkpoint written
by either package resumes in the other.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from stereo_vo_tpu_torch.engine.convert import state_from_numpy, state_to_numpy


def save_state(path: str, state, next_frame_index: int) -> None:
    np.savez(
        path,
        __next_frame__=np.asarray(next_frame_index),
        **{f"leaf_{i}": leaf for i, leaf in enumerate(state_to_numpy(state))},
    )


def load_state(path: str, engine) -> Tuple[object, int]:
    """Returns ``(state, next_frame_index)`` with the state on
    ``engine.device``; each leaf must have the shape and dtype of the engine's
    own state (its config and image shape)."""
    with np.load(path) as data:
        n_leaves = sum(1 for k in data.files if k.startswith("leaf_"))
        leaves = [data[f"leaf_{i}"] for i in range(n_leaves)]
        next_index = int(data["__next_frame__"])
    state = state_from_numpy(leaves, engine.config, engine.image_shape, device=engine.device)
    return state, next_index
