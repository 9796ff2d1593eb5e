"""CUDA graphs of the keyframe branch (the reference runs it as one device
program: ``lax.cond`` branches inside the jitted step).

A ``Stretch`` is a function from tensors to tensors that makes no host read
and no host-to-device copy, so a CUDA graph can capture it. Its first call
runs it eagerly, which builds and loads every kernel it launches and makes
the constants it needs (``core/consts.py``), and returns that run's result;
then it captures the function on static copies of the inputs. Every later
call copies its inputs into those buffers, replays the graph and returns
copies of the outputs, so nothing a caller keeps aliases memory that the
next replay overwrites. An output that is one of the inputs comes back as
the caller's own tensor. A capture or a replay that fails raises: nothing
falls back to the eager run.

Launch counts stay what the card ran: the kernels' wrappers count at call
time, and a replay calls no wrapper. The capture records what each wrapper
counted while it was captured, takes that back (a capture launches nothing),
and every replay adds it again.

Trees of tensors are tensors, ``None`` and (named) tuples of them.
"""

from __future__ import annotations

from typing import Callable, Dict, List

import torch

from stereo_vo_tpu_torch.ops.lk import lk_level_pass
from stereo_vo_tpu_torch.ops.regions import extract_regions
from stereo_vo_tpu_torch.ops.shi_tomasi import greedy_nms
from stereo_vo_tpu_torch.ops.stereo_bm import stereo_bm_at

# every hand kernel's wrapper, each with its ``launches`` count
COUNTED = (lk_level_pass, stereo_bm_at, extract_regions, greedy_nms)


def flatten(tree):
    """``(leaves, spec)``: the tensors of ``tree`` in order, and what
    ``unflatten`` needs to rebuild it."""
    leaves: List[torch.Tensor] = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            leaves.append(x)
            return "t"
        if x is None:
            return None
        if isinstance(x, tuple):
            specs = tuple(walk(v) for v in x)
            return (type(x) if hasattr(x, "_fields") else tuple, specs)
        raise TypeError(f"not a tree of tensors: {type(x).__name__}")

    return leaves, walk(tree)


def unflatten(spec, leaves):
    """The tree of ``spec`` with ``leaves`` (an iterator) in its tensors'
    places."""
    if spec == "t":
        return next(leaves)
    if spec is None:
        return None
    kind, specs = spec
    items = [unflatten(s, leaves) for s in specs]
    return kind(*items) if kind is not tuple else tuple(items)


class Stretch:
    """``fn(*args)`` eager at its first call, then replayed from a CUDA graph
    (module docstring). ``launches`` maps each counted wrapper to what one
    replay launches; ``replays`` counts the replays."""

    def __init__(self, name: str, fn: Callable):
        self.name = name
        self.fn = fn
        self.graph = None
        self.launches: Dict[Callable, int] = {}
        self.replays = 0

    def __call__(self, *args):
        leaves, spec = flatten(args)
        if self.graph is None:
            out = self.fn(*args)
            self._capture(leaves, spec)
            return out
        if spec != self._in_spec or len(leaves) != len(self._static_in):
            raise ValueError(f"stretch {self.name}: its inputs changed structure")
        for buf, x in zip(self._static_in, leaves):
            if buf.shape != x.shape or buf.dtype != x.dtype or buf.device != x.device:
                raise ValueError(f"stretch {self.name}: input {tuple(x.shape)} {x.dtype} on "
                                 f"{x.device}, captured {tuple(buf.shape)} {buf.dtype} on "
                                 f"{buf.device}")
            buf.copy_(x)
        self.graph.replay()
        self.replays += 1
        for wrapper, n in self.launches.items():
            wrapper.launches += n
        outs = [leaves[src] if isinstance(src, int) else src.clone() for src in self._out_src]
        return unflatten(self._out_spec, iter(outs))

    def _capture(self, leaves, spec):
        device = leaves[0].device
        self._in_spec = spec
        self._static_in = [x.clone() for x in leaves]
        args = unflatten(spec, iter(self._static_in))
        before = {w: w.launches for w in COUNTED}
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.device(device), torch.cuda.graph(graph):
                out = self.fn(*args)
        finally:
            self.launches = {w: w.launches - before[w] for w in COUNTED
                             if w.launches != before[w]}
            for w in COUNTED:
                w.launches = before[w]
        out_leaves, self._out_spec = flatten(out)
        ids = {id(b): k for k, b in enumerate(self._static_in)}
        self._out_src = [ids.get(id(t), t) for t in out_leaves]
        self.graph = graph
