"""Gaussian image pyramids, cv::pyrDown-compatible (counterpart of
``stereo_vo_tpu/ops/pyramid.py``)."""

from __future__ import annotations

from typing import List

import torch

from vobench.reference.ops.filters import sep_filter

_G5 = [1.0 / 16, 4.0 / 16, 6.0 / 16, 4.0 / 16, 1.0 / 16]


def pyr_down(img: torch.Tensor) -> torch.Tensor:
    """5x5 Gaussian blur then even-index decimation (OpenCV pyrDown)."""
    blurred = sep_filter(img, _G5, _G5, mode="reflect")
    return blurred[..., ::2, ::2].contiguous()


def build_pyramid(img: torch.Tensor, max_level: int) -> List[torch.Tensor]:
    """Levels ``0..max_level`` (level 0 is the input), float32."""
    levels = [img.to(torch.float32)]
    for _ in range(max_level):
        levels.append(pyr_down(levels[-1]))
    return levels
