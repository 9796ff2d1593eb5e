"""The port's step as one device program: a CUDA graph whose decisions are
conditional nodes (the reference runs its step as one jitted function and
takes each decision with ``lax.cond``).

``cond(pred, true_fn, false_fn, operands)`` is the one decision primitive.
``pred`` is a 0-d bool tensor; both functions take ``operands`` and return
trees of tensors of the same structure, shapes and dtypes (trees are
tensors, ``None`` and (named) tuples of them). Outside a capture ``cond``
reads ``pred`` once on the host and runs one function, as plain code would:
that is the CPU path and ``VOEngine(graphs=False)`` on the card. While a
``Program`` captures, it reads nothing: it adds two IF nodes to the graph
(``csrc/graph_cond.cu``), one running ``true_fn`` when ``pred`` holds and
one running ``false_fn`` when it does not, the second copying its outputs
into the first's, so the work after the pair reads one set of buffers. The
bodies are captured on a side stream, one per device for every program,
whose allocations go to a private memory pool that lives as long as the
graph. Bodies do not nest.

A ``Program`` is ``fn(carry, inputs) -> (new_carry, outputs)``, a function
that makes no host read and no host-to-device copy. Its first call runs
``fn`` eagerly with both sides of every ``cond`` run (the untaken side on
the same operands, its result and its kernel launches thrown away), so
every kernel is built and loaded and every constant (``core/consts.py``)
exists before the capture, and returns that run's result; then it captures
``fn`` on static copies of the carry and the inputs. The captured graph
ends by writing ``new_carry`` into the carry's own buffers, so a chain of
calls carries its state in place, as ``lax.scan`` carries its own. Every
later call copies only what differs from those buffers (a carry the
program handed out is its own buffers: nothing to copy), copies the inputs
into theirs and replays the graph. The carry and the outputs handed out
are the program's buffers: the next call overwrites them. A capture, a
conditional node or a replay that fails raises; nothing falls back.

Launch counts: the hand kernels' wrappers (``COUNTED``) count at call
time, and a replay calls no wrapper. So the capture takes back what each
wrapper counted while it was captured, and the graph adds, on the device,
what each body launches when that body runs (and what the rest launches,
every replay) to a counter; ``Program.flush_launches`` reads it once into
the wrappers' counts. No count is read on the host per frame.
"""

from __future__ import annotations

import contextlib
import ctypes
import gc
import threading
from typing import Callable, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

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


def signature(tree):
    """What a captured graph is fixed to: the tree's structure and each
    tensor's shape, dtype and device."""
    leaves, spec = flatten(tree)
    return spec, tuple((tuple(t.shape), t.dtype, str(t.device)) for t in leaves)


def _counts() -> List[int]:
    return [w.launches for w in COUNTED]


def _set_counts(values) -> None:
    for w, v in zip(COUNTED, values):
        w.launches = v


_lib_fns = None


def _cond_lib():
    """``(svo_cond_begin, svo_cond_end)`` of ``csrc/graph_cond.cu``, built,
    loaded and typed at first use."""
    global _lib_fns
    if _lib_fns is None:
        from stereo_vo_tpu_torch import cuda_build

        lib = cuda_build.load("graph_cond")
        begin, end = lib.svo_cond_begin, lib.svo_cond_end
        begin.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
        end.argtypes = [ctypes.c_void_p]
        begin.restype = end.restype = ctypes.c_int
        _lib_fns = (begin, end)
    return _lib_fns


_body_streams: dict = {}


def _body_stream(device: torch.device) -> torch.cuda.Stream:
    """The one stream every program on ``device`` captures its conditional
    bodies on. Libraries keep state per stream: cuSOLVER's solves take
    scratch through a cuBLAS handle of cuSOLVER's own, and on a stream new
    to it under capture that handle allocates with ``cudaMallocAsync``, a
    memory-allocation node that a conditional body cannot hold (the graph
    then fails to instantiate). On a stream it has captured on before, it
    does not."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    stream = _body_streams.get(index)
    if stream is None:
        stream = _body_streams[index] = torch.cuda.Stream(index)
    return stream


class _Context(threading.local):
    capture: Optional["Program"] = None    # the program capturing on this thread
    warming: bool = False                  # run both sides of every cond
    reads: int = 0                         # predicates read on the host


_ctx = _Context()


def _check_same(a, b, what: str) -> None:
    sa, sb = signature(a), signature(b)
    if sa != sb:
        raise ValueError(f"cond: the two sides of {what} differ: {sa} against {sb}")


def cond(pred: torch.Tensor, true_fn: Callable, false_fn: Callable, operands=()):
    """``true_fn(*operands)`` if ``pred`` else ``false_fn(*operands)``
    (module docstring): one host read of ``pred`` outside a capture, two IF
    nodes inside one."""
    if pred.dim() != 0 or pred.dtype != torch.bool:
        raise ValueError(f"cond: pred must be a 0-d bool tensor, got {tuple(pred.shape)} "
                         f"{pred.dtype}")
    program = _ctx.capture
    if program is not None:
        return program._cond(pred, true_fn, false_fn, operands)
    _ctx.reads += 1
    take = bool(pred)
    if not _ctx.warming:
        return true_fn(*operands) if take else false_fn(*operands)
    before = _counts()
    other = (false_fn if take else true_fn)(*operands)
    _set_counts(before)
    out = (true_fn if take else false_fn)(*operands)
    _check_same(out, other, getattr(true_fn, "__name__", "a cond"))
    return out


@contextlib.contextmanager
def warming():
    """Run both sides of every ``cond`` (the untaken side's launches not
    counted), checking that they agree in structure, shapes and dtypes."""
    previous = _ctx.warming
    _ctx.warming = True
    try:
        yield
    finally:
        _ctx.warming = previous


class _Allocations(TorchDispatchMode):
    """Records the storages that operators allocate (outputs that alias no
    input), so a body's outputs that it did not allocate can be copied."""

    def __init__(self):
        super().__init__()
        self.storages = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        results = out if isinstance(out, (tuple, list)) else (out,)
        returns = func._schema.returns
        for k, r in enumerate(results):
            spec = returns[min(k, len(returns) - 1)]
            items = r if isinstance(r, (tuple, list)) else (r,)
            if spec.alias_info is None:
                for t in items:
                    if isinstance(t, torch.Tensor):
                        self.storages.add(t.untyped_storage().data_ptr())
        return out


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


class Program:
    """``fn(carry, inputs)`` eager with both sides of every ``cond`` at its
    first call, then replayed from one CUDA graph with conditional nodes
    (module docstring). ``replays`` counts the replays."""

    def __init__(self, name: str, fn: Callable):
        self.name = name
        self.fn = fn
        self.graph = None
        self.replays = 0
        self.conds = 0

    # ------------------------------------------------------------------
    def __call__(self, carry, inputs):
        if self.graph is None:
            with warming():
                out = self.fn(carry, inputs)
            self._capture(carry, inputs)
            return out
        self._load(carry, inputs)
        self.graph.replay()
        self.replays += 1
        return (unflatten(self._carry_spec, iter(self._carry_buf)),
                unflatten(self._out_spec, iter(self._out)))

    def flush_launches(self) -> None:
        """Add what the replays launched, counted on the device, to the
        wrappers' counts (one read back)."""
        if self.graph is None:
            return
        for w, n in zip(COUNTED, self._counter.tolist()):
            w.launches += int(n)
        self._counter.zero_()

    # ------------------------------------------------------------------
    def _load(self, carry, inputs) -> None:
        """Copy what differs from the program's buffers into them."""
        for what, tree, spec, bufs in (("carry", carry, self._carry_sig, self._carry_buf),
                                       ("inputs", inputs, self._in_sig, self._in_buf)):
            leaves, _ = flatten(tree)
            pairs = [(b, x) for b, x in zip(bufs, leaves) if x is not b]
            if not pairs and len(leaves) == len(bufs):
                continue
            if signature(tree) != spec:
                raise ValueError(f"program {self.name}: {what} {signature(tree)} differ from "
                                 f"the captured {spec}")
            owned = {_storage(b) for b in bufs}
            for b, x in pairs:
                b.copy_(x.clone() if _storage(x) in owned else x)

    def _capture(self, carry, inputs) -> None:
        dev = flatten(inputs)[0][0].device
        self._carry_sig, self._in_sig = signature(carry), signature(inputs)
        carry_leaves, self._carry_spec = flatten(carry)
        in_leaves, in_spec = flatten(inputs)
        self._carry_buf = [x.clone() for x in carry_leaves]
        self._in_buf = [x.clone() for x in in_leaves]
        self._counter = torch.zeros(len(COUNTED), dtype=torch.int64, device=dev)
        self._body_stream = _body_stream(dev)
        self._in_body = False
        self._device = dev
        owned = {_storage(b) for b in self._carry_buf}
        index = dev.index if dev.index is not None else torch.cuda.current_device()
        graph = torch.cuda.CUDAGraph()
        # the conditional bodies are captured on another stream, whose
        # allocations the graph's own pool does not take: this thread's go to
        # a pool of their own, which lives as long as the graph
        self._body_pool = torch.cuda.MemPool()
        pool = self._body_pool.id
        before = _counts()
        # a program dies with its engine, in a reference cycle: its pool must
        # not be freed by the collector in the middle of another capture
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.device(dev), torch.cuda.graph(graph):
                self._record(index, pool, in_spec, owned, before)
        finally:
            if collecting:
                gc.enable()
        self.graph = graph

    def _record(self, index, pool, in_spec, owned, before) -> None:
        """The capture's body: ``fn`` on the program's buffers, its launches
        counted on the device, the new carry written into the carry's
        buffers."""
        torch._C._cuda_beginAllocateCurrentThreadToPool(index, pool)
        _ctx.capture = self
        try:
            new_carry, out = self.fn(
                unflatten(self._carry_spec, iter(self._carry_buf)),
                unflatten(in_spec, iter(self._in_buf)))
            self._count_launches(before)
            if signature(new_carry) != self._carry_sig:
                raise ValueError(f"program {self.name}: the new carry "
                                 f"{signature(new_carry)} differs from the carry "
                                 f"{self._carry_sig}")
            out_leaves, self._out_spec = flatten(out)
            # outputs that live in the carry's buffers would change
            # when the carry is written back: copy them first
            self._out = [t.clone() if _storage(t) in owned else t for t in out_leaves]
            new_leaves, _ = flatten(new_carry)
            pairs = [(b, n.clone() if _storage(n) in owned else n)
                     for b, n in zip(self._carry_buf, new_leaves) if n is not b]
            if pairs:
                torch._foreach_copy_([b for b, _ in pairs], [n for _, n in pairs])
        finally:
            _ctx.capture = None
            torch._C._cuda_endAllocateToPool(index, pool)
            torch._C._cuda_releasePool(index, pool)
            _set_counts(before)

    def _count_launches(self, before) -> None:
        """While capturing: the graph adds what the wrappers counted since
        ``before`` to the device counter, and the counts go back."""
        for k, (now, then) in enumerate(zip(_counts(), before)):
            if now != then:
                self._counter[k:k + 1].add_(now - then)
        _set_counts(before)

    def _cond(self, pred, true_fn, false_fn, operands):
        """``cond`` while capturing: two IF nodes, on ``pred`` and on its
        negation; the second body copies its outputs into the first's."""
        if self._in_body:
            raise RuntimeError(f"program {self.name}: a cond inside a cond body")
        if pred.device != self._device:
            raise ValueError(f"cond: pred on {pred.device}, the program runs on {self._device}")
        begin, end = _cond_lib()
        stream = torch.cuda.current_stream(self._device)
        outs, spec = None, None
        self.conds += 1
        for negate, fn in ((0, true_fn), (1, false_fn)):
            before = _counts()
            rc = begin(stream.cuda_stream, self._body_stream.cuda_stream, pred.data_ptr(), negate)
            if rc != 0:
                raise RuntimeError(f"program {self.name}: conditional node failed: CUDA error "
                                   f"{rc}")
            self._in_body = True
            try:
                with torch.cuda.stream(self._body_stream):
                    if outs is None:
                        with _Allocations() as made:
                            out = fn(*operands)
                        leaves, spec = flatten(out)
                        seen = set()
                        outs = []
                        for t in leaves:
                            fresh = _storage(t) in made.storages and id(t) not in seen
                            outs.append(t if fresh else t.clone())
                            seen.add(id(t))
                    else:
                        out = fn(*operands)
                        _check_same(unflatten(spec, iter(outs)), out,
                                    getattr(true_fn, "__name__", "a cond"))
                        torch._foreach_copy_(outs, flatten(out)[0])
                    self._count_launches(before)
            finally:
                self._in_body = False
                rc = end(self._body_stream.cuda_stream)
            if rc != 0:
                raise RuntimeError(f"program {self.name}: conditional body failed: CUDA error "
                                   f"{rc}")
        return unflatten(spec, iter(outs))
