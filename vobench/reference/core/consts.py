"""Small constant tensors, made once per value, dtype and device.

``torch.tensor(values, device="cuda")`` copies from host memory and waits for
the copy, and a CUDA graph cannot capture that copy. Code that
``VOEngine`` captures takes its constants from ``const``: the first call for
a value, made in an eager run before any capture, creates the tensor, and
later calls return the same tensor. Callers never write into it.
"""

from __future__ import annotations

import threading

import torch

_lock = threading.Lock()
_cache: dict = {}


def const(values, dtype: torch.dtype, device) -> torch.Tensor:
    """The tensor ``torch.tensor(values, dtype=dtype, device=device)`` for a
    number or a flat sequence of numbers, shared by every caller."""
    key = (tuple(values) if isinstance(values, (list, tuple)) else values, dtype,
           str(torch.device(device) if device is not None else torch.device("cpu")))
    t = _cache.get(key)
    if t is None:
        with _lock:
            t = _cache.get(key)
            if t is None:
                t = torch.tensor(values, dtype=dtype, device=device)
                _cache[key] = t
    return t
