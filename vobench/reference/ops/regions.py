"""Batched region extraction at per-feature origins, and edge padding.

``extract_regions(stack [C, Hp, Wp], origins [N, 2] (x, y), ry, rx)`` returns
``[N, C, ry, rx]``: for each feature an exact f32 copy of
``stack[:, oy:oy+ry, ox:ox+rx]``, with the start placed the way
``jax.lax.dynamic_slice`` places it (the contract of the reference's CPU path,
``_extract_regions_vmap``): a negative start counts from the end of its axis
(``+ dim``, once), then the start is clamped to ``[0, dim - size]``. The
pipeline's callers pass origins already inside that range.

On a CUDA tensor it launches the hand-written kernel
``csrc/extract_regions.cu`` (the port of the TPU kernels in
``stereo_vo_tpu/ops/pallas_extract.py``) and raises if it cannot; it never
falls back. On a CPU tensor it runs the plain PyTorch version
``extract_regions_ref``. It is the port's counterpart of the contract of
both TPU variants, held bitwise against ``extract_regions_ref`` on the card
(``chip_smoke.py`` phase 3), but no main-path caller launches it on the card
any more: LK stages its regions inside its level-pass kernel (``ops/lk.py``)
and sparse StereoBM inside its own kernel (``ops/stereo_bm.py``). Their plain
versions copy regions with ``extract_regions_ref`` and ``pad_edge``.
"""

from __future__ import annotations


import torch

from vobench.reference.ops.filters import pad_2d


def pad_edge(img: torch.Tensor, m: int) -> torch.Tensor:
    """Replicate-pad the two trailing dims by ``m`` on every side."""
    return pad_2d(img, m, m, mode="edge")


def _check(stack: torch.Tensor, origins: torch.Tensor, ry: int, rx: int):
    """Raise on a stack, origins or region size the extraction does not
    take; return the stack's ``(C, Hp, Wp)``."""
    if stack.dim() != 3 or stack.dtype != torch.float32:
        raise ValueError(f"stack must be [C, Hp, Wp] float32, got {tuple(stack.shape)} {stack.dtype}")
    if origins.dim() != 2 or origins.shape[1] != 2:
        raise ValueError(f"origins must be [N, 2], got {tuple(origins.shape)}")
    c, hp, wp = stack.shape
    if not (0 < ry <= hp and 0 < rx <= wp):
        raise ValueError(f"region {ry}x{rx} does not fit a {hp}x{wp} image")
    return c, hp, wp


def extract_regions_ref(stack: torch.Tensor, origins: torch.Tensor, ry: int, rx: int
                        ) -> torch.Tensor:
    """Plain PyTorch version: batched advanced indexing with clamped starts."""
    _, hp, wp = _check(stack, origins, ry, rx)
    origins = origins.to(torch.int64)
    ox, oy = origins[:, 0], origins[:, 1]
    ox = torch.where(ox < 0, ox + wp, ox).clamp(0, wp - rx)
    oy = torch.where(oy < 0, oy + hp, oy).clamp(0, hp - ry)
    rows = oy[:, None] + torch.arange(ry, device=stack.device)     # [N, ry]
    cols = ox[:, None] + torch.arange(rx, device=stack.device)     # [N, rx]
    out = stack[:, rows[:, :, None], cols[:, None, :]]             # [C, N, ry, rx]
    return out.permute(1, 0, 2, 3).contiguous()


extract_regions = extract_regions_ref
