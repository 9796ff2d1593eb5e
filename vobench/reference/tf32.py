"""The control: the reference computed one precision below what the
configurations state. They state float32 with TF32 off (the port switches
TF32 off for matrix products and cuDNN), so the control rounds the float32
inputs of every matrix product the reference makes (``torch.einsum``,
``torch.matmul`` and ``@``, ``torch.mm``, ``torch.bmm``) to TF32's 10
mantissa bits, nearest with ties away from zero as the card's conversion
does, and keeps the float32 accumulation. The CPU has no TF32 unit, so this
is the card's TF32 arithmetic emulated in place.
"""

from __future__ import annotations

import contextlib

import torch


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` with each float32 element rounded to TF32 (other dtypes and
    non-finite values as they are)."""
    if not isinstance(x, torch.Tensor) or x.dtype != torch.float32:
        return x
    bits = x.contiguous().view(torch.int32)
    rounded = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return torch.where(torch.isfinite(x), rounded, x)


@contextlib.contextmanager
def tf32_products():
    """Inside the block, every matrix product rounds its float32 inputs to
    TF32. Patches ``torch`` for the whole process: use it in a process, or
    a phase of one, that runs nothing else."""
    saved = (torch.einsum, torch.matmul, torch.mm, torch.bmm, torch.Tensor.__matmul__)
    einsum, matmul, mm, bmm, tmatmul = saved

    def r(args):
        return [round_tf32(a) for a in args]

    torch.einsum = lambda eq, *ops: einsum(eq, *r(ops))
    torch.matmul = lambda a, b, **kw: matmul(*r((a, b)), **kw)
    torch.mm = lambda a, b, **kw: mm(*r((a, b)), **kw)
    torch.bmm = lambda a, b, **kw: bmm(*r((a, b)), **kw)
    torch.Tensor.__matmul__ = lambda a, b: tmatmul(*r((a, b)))
    try:
        yield
    finally:
        (torch.einsum, torch.matmul, torch.mm, torch.bmm, torch.Tensor.__matmul__) = saved
