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
``extract_regions_ref``. LK (two calls per pyramid level pass) and sparse
StereoBM (two per keyframe) both call this module.
"""

from __future__ import annotations

import ctypes

import torch

from stereo_vo_tpu_torch.ops.filters import pad_2d


def pad_edge(img: torch.Tensor, m: int) -> torch.Tensor:
    """Replicate-pad the two trailing dims by ``m`` on every side."""
    return pad_2d(img, m, m, mode="edge")


def _check(stack: torch.Tensor, origins: torch.Tensor, ry: int, rx: int):
    if stack.dim() != 3 or stack.dtype != torch.float32:
        raise ValueError(f"stack must be [C, Hp, Wp] float32, got {tuple(stack.shape)} {stack.dtype}")
    if origins.dim() != 2 or origins.shape[1] != 2:
        raise ValueError(f"origins must be [N, 2], got {tuple(origins.shape)}")
    _, hp, wp = stack.shape
    if not (0 < ry <= hp and 0 < rx <= wp):
        raise ValueError(f"region {ry}x{rx} does not fit a {hp}x{wp} image")


def extract_regions_ref(stack: torch.Tensor, origins: torch.Tensor, ry: int, rx: int
                        ) -> torch.Tensor:
    """Plain PyTorch version: batched advanced indexing with clamped starts."""
    _check(stack, origins, ry, rx)
    _, hp, wp = stack.shape
    origins = origins.to(torch.int64)
    ox, oy = origins[:, 0], origins[:, 1]
    ox = torch.where(ox < 0, ox + wp, ox).clamp(0, wp - rx)
    oy = torch.where(oy < 0, oy + hp, oy).clamp(0, hp - ry)
    rows = oy[:, None] + torch.arange(ry, device=stack.device)     # [N, ry]
    cols = ox[:, None] + torch.arange(rx, device=stack.device)     # [N, rx]
    out = stack[:, rows[:, :, None], cols[:, None, :]]             # [C, N, ry, rx]
    return out.permute(1, 0, 2, 3).contiguous()


def _kernel():
    from stereo_vo_tpu_torch import cuda_build

    lib = cuda_build.load("extract_regions")
    fn = lib.svo_extract_regions
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def extract_regions(stack: torch.Tensor, origins: torch.Tensor, ry: int, rx: int
                    ) -> torch.Tensor:
    """``[C, Hp, Wp]`` + origins ``[N, 2]`` (x, y) -> ``[N, C, ry, rx]``.

    CUDA tensors go through the kernel (each launch adds one to
    ``extract_regions.launches``); CPU tensors through ``extract_regions_ref``.
    """
    if stack.device.type == "cpu":
        return extract_regions_ref(stack, origins, ry, rx)
    if stack.device.type != "cuda":
        raise ValueError(f"extract_regions: unsupported device {stack.device}")
    _check(stack, origins, ry, rx)
    if origins.device != stack.device or origins.dtype != torch.int32:
        raise ValueError("origins must be int32 on the stack's device")
    if not (stack.is_contiguous() and origins.is_contiguous()):
        raise ValueError("stack and origins must be contiguous")
    c, hp, wp = stack.shape
    n = origins.shape[0]
    out = torch.empty((n, c, ry, rx), dtype=torch.float32, device=stack.device)
    if n == 0:
        return out
    fn = _kernel()
    with torch.cuda.device(stack.device):
        stream = torch.cuda.current_stream(stack.device).cuda_stream
        rc = fn(stack.data_ptr(), origins.data_ptr(), out.data_ptr(),
                c, hp, wp, n, ry, rx, stream)
    if rc != 0:
        raise RuntimeError(f"extract_regions kernel launch failed: CUDA error {rc}")
    extract_regions.launches += 1
    return out


extract_regions.launches = 0
