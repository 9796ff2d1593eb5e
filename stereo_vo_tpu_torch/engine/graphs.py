"""The port's step as one device program: a CUDA graph whose decisions and
loops are conditional nodes (the reference runs its step as one jitted
function and takes each decision with ``lax.cond``, each loop with
``lax.while_loop``).

``cond(pred, true_fn, false_fn, operands)`` is the decision primitive.
``pred`` is a 0-d bool tensor; both functions take ``operands`` and return
trees of tensors of the same structure, shapes and dtypes (trees are
tensors, ``None`` and (named) tuples of them). Outside a capture ``cond``
reads ``pred`` once on the host and runs one function, as plain code would:
that is the CPU path and ``VOEngine(graphs=False)`` on the card. While a
``Program`` captures, it reads nothing: it adds two IF nodes to the graph
(``csrc/graph_cond.cu``), one running ``true_fn`` when ``pred`` holds and
one running ``false_fn`` when it does not, the second copying its outputs
into the first's, so the work after the pair reads one set of buffers.

``while_loop(cond_fn, body_fn, carry)`` is the loop primitive:
``body_fn(carry)`` returns a carry of the same tree signature, and runs
while ``cond_fn(carry)`` (a 0-d bool tensor) holds. Outside a capture it is
a Python loop that reads the predicate once per trip and once more to stop.
While a ``Program`` captures, it copies the carry into buffers of its own
and adds a WHILE node: a one-thread kernel sets the node's handle from
``cond_fn`` of the carry before the node; the body graph ends by writing the
new carry into the carry's buffers and setting the handle from ``cond_fn``
of the new carry, so the node runs the body again while the predicate
holds, with no host read.

Bodies nest: a ``cond`` or a ``while_loop`` may open inside a body. Every
body is captured on one stream, one per device for every program
(``_body_stream``); a stream captures into one graph at a time, so a nested
body suspends the capture of the body around it and resumes it when it
ends. The allocations of every body go to a private memory pool that lives
as long as the graph. A conditional node inside a body needs CUDA 12.4 or
later in both the runtime and the driver; without it the capture raises.

A ``Program`` is ``fn(carry, inputs) -> (new_carry, outputs)``, a function
that makes no host read and no host-to-device copy. Its first call runs
``fn`` eagerly, warming (``warming``): both sides of every ``cond`` run (the
untaken side on the same operands, its result and its kernel launches
thrown away), a loop that takes no trip runs its body once (thrown away
likewise), and every body runs on the body stream, so every kernel is built
and loaded, every constant (``core/consts.py``) exists and every library
has met the body stream before the capture; it
returns that run's result. Then it captures ``fn`` on static copies of the
carry and the inputs. The captured graph ends by writing ``new_carry`` into
the carry's own buffers, so a chain of calls carries its state in place, as
``lax.scan`` carries its own. Every later call copies only what differs
from those buffers (a carry the program handed out is its own buffers:
nothing to copy), copies the inputs into theirs and replays the graph. The
carry and the outputs handed out are the program's buffers: the next call
overwrites them. A capture, a conditional node or a replay that fails
raises; nothing falls back.

Counts on the device: the hand kernels' wrappers (``COUNTED``) count at
call time, and a replay calls no wrapper. So the capture takes back what
each wrapper counted while it was captured, and the graph adds, on the
device, what each body launches each time that body runs (and what the rest
launches, every replay) to a counter, with one more slot per conditional
body that counts the body's runs (a WHILE body's trips).
``Program.flush_launches`` reads the counter once into the wrappers' counts
and ``Program.runs``. No count is read on the host per frame.

Device stamps (``utils/profiling.py::Recorder``, ``csrc/graph_cond.cu``'s
``svo_stamp``) are one-thread kernels on the current stream, so a capture
takes them as ordinary kernel nodes, at the graph's own level or inside an
IF or WHILE body. A body that warming throws away (``discarding``) records
none, as its launches are not counted.
"""

from __future__ import annotations

import contextlib
import ctypes
import gc
import threading
from typing import Callable, Dict, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from stereo_vo_tpu_torch.backend.schur import ba_build, ba_cost, ba_damp_reduce, ba_step
from stereo_vo_tpu_torch.frontend.pnp import pnp_hypotheses
from stereo_vo_tpu_torch.ops.lk import lk_level_pass
from stereo_vo_tpu_torch.ops.regions import extract_regions
from stereo_vo_tpu_torch.ops.shi_tomasi import greedy_nms
from stereo_vo_tpu_torch.ops.stereo_bm import stereo_bm_at

# every hand kernel's wrapper, each with its ``launches`` count
COUNTED = (lk_level_pass, stereo_bm_at, extract_regions, greedy_nms, ba_build, ba_damp_reduce,
           ba_step, ba_cost, pnp_hypotheses)
# the conditional bodies one program may hold (each has a slot of the
# device counter for its runs)
MAX_BODIES = 64
# the CUDA version (runtime and driver) that nests conditional nodes
NESTING_CUDA = 12040
# csrc/graph_cond.cu's node types
_IF, _WHILE = 0, 1


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


def _name(fn) -> str:
    """A body's label: its function's name (through ``functools.partial``)."""
    return getattr(fn, "__name__", None) or getattr(getattr(fn, "func", None), "__name__",
                                                    "body")


class _CondLib:
    """``csrc/graph_cond.cu``, built, loaded and typed at first use, with the
    CUDA runtime and driver versions it runs under."""

    def __init__(self):
        from stereo_vo_tpu_torch import cuda_build

        lib = cuda_build.load("graph_cond")
        self.begin, self.set, self.end = lib.svo_cond_begin, lib.svo_cond_set, lib.svo_cond_end
        self.begin.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                               ctypes.c_int, ctypes.POINTER(ctypes.c_ulonglong),
                               ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_void_p)]
        self.set.argtypes = [ctypes.c_void_p, ctypes.c_ulonglong, ctypes.c_void_p]
        self.end.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        versions = lib.svo_cuda_versions
        versions.argtypes = [ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
        # the span recorder's device stamps (utils/profiling.py::Recorder)
        self.stamp, self.tick = lib.svo_stamp, lib.svo_timer_tick
        self.stamp.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                               ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p,
                               ctypes.c_longlong]
        self.tick.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
        for fn in (self.begin, self.set, self.end, versions, self.stamp, self.tick):
            fn.restype = ctypes.c_int
        runtime, driver = ctypes.c_int(0), ctypes.c_int(0)
        _raise_on(versions(ctypes.byref(runtime), ctypes.byref(driver)), "cuda versions")
        self.runtime, self.driver = runtime.value, driver.value


_lib: Optional[_CondLib] = None


def cond_lib() -> _CondLib:
    global _lib
    if _lib is None:
        _lib = _CondLib()
    return _lib


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} failed: CUDA error {rc}")


_body_streams: dict = {}


def _body_stream(device: torch.device) -> torch.cuda.Stream:
    """The one stream every program on ``device`` captures its conditional
    bodies on, at every depth. Libraries keep state per stream: cuSOLVER's
    solves take scratch through a cuBLAS handle of cuSOLVER's own, and once
    a capture has taken it on one stream, a capture of a solve on another
    stream frees it and takes it again with ``cudaMallocAsync``:
    memory-free and memory-allocation nodes, which a conditional body cannot
    hold (the graph then fails to instantiate). On the stream it was taken
    on, it is not taken again."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    stream = _body_streams.get(index)
    if stream is None:
        stream = _body_streams[index] = torch.cuda.Stream(index)
    return stream


class _Context(threading.local):
    capture: Optional["Program"] = None    # the program capturing on this thread
    warming: bool = False                  # run both sides of every cond
    depth: int = 0                         # conditional bodies open around a capture
    reads: int = 0                         # predicates read on the host
    discarding: int = 0                    # warming bodies whose run is thrown away


_ctx = _Context()


def discarding() -> bool:
    """Whether the code running now is a body that warming runs and throws
    away (the untaken side of a ``cond``, the trip of a loop that takes
    none): what it launches is not counted and it records no span."""
    return _ctx.discarding > 0


@contextlib.contextmanager
def _discarded():
    _ctx.discarding += 1
    try:
        yield
    finally:
        _ctx.discarding -= 1


def _check_pred(pred: torch.Tensor, what: str) -> torch.Tensor:
    if not isinstance(pred, torch.Tensor) or pred.dim() != 0 or pred.dtype != torch.bool:
        got = (f"{tuple(pred.shape)} {pred.dtype}" if isinstance(pred, torch.Tensor)
               else type(pred).__name__)
        raise ValueError(f"{what}: the predicate must be a 0-d bool tensor, got {got}")
    return pred


def _read(pred: torch.Tensor) -> bool:
    """One predicate read on the host, counted."""
    _ctx.reads += 1
    return bool(pred)


def _check_same(a, b, what: str) -> None:
    sa, sb = signature(a), signature(b)
    if sa != sb:
        raise ValueError(f"cond: the two sides of {what} differ: {sa} against {sb}")


def _check_carry(want, carry, what: str) -> None:
    got = signature(carry)
    if got != want:
        raise ValueError(f"while_loop: the body {what} returned {got}, the carry is {want}")


def _nested(device: torch.device, fn: Callable, *args):
    """``fn(*args)`` as a body, while warming: on the card, on the stream
    bodies are captured on (ordered after the work before it, and the work
    after it ordered after it)."""
    if device.type != "cuda":
        return fn(*args)
    here = torch.cuda.current_stream(device)
    stream = _body_stream(device)
    if stream == here:
        return fn(*args)
    stream.wait_stream(here)
    with torch.cuda.stream(stream):
        out = fn(*args)
    here.wait_stream(stream)
    return out


def cond(pred: torch.Tensor, true_fn: Callable, false_fn: Callable, operands=()):
    """``true_fn(*operands)`` if ``pred`` else ``false_fn(*operands)``
    (module docstring): one host read of ``pred`` outside a capture, two IF
    nodes inside one."""
    _check_pred(pred, "cond")
    program = _ctx.capture
    if program is not None:
        return program._cond(pred, true_fn, false_fn, operands)
    take = _read(pred)
    if not _ctx.warming:
        return true_fn(*operands) if take else false_fn(*operands)
    before = _counts()
    with _discarded():
        other = _nested(pred.device, false_fn if take else true_fn, *operands)
    _set_counts(before)
    out = _nested(pred.device, true_fn if take else false_fn, *operands)
    _check_same(out, other, _name(true_fn))
    return out


def while_loop(cond_fn: Callable, body_fn: Callable, carry):
    """``carry = body_fn(carry)`` while ``cond_fn(carry)`` holds (module
    docstring): one host read of the predicate per trip and one to stop
    outside a capture, a WHILE node inside one."""
    program = _ctx.capture
    if program is not None:
        return program._while(cond_fn, body_fn, carry)
    want = signature(carry)
    what = _name(body_fn)
    trips = 0
    while True:
        pred = _check_pred(cond_fn(carry), "while_loop")
        if not _read(pred):
            break
        carry = _nested(pred.device, body_fn, carry) if _ctx.warming else body_fn(carry)
        _check_carry(want, carry, what)
        trips += 1
    if _ctx.warming and trips == 0:
        before = _counts()
        with _discarded():
            _check_carry(want, _nested(pred.device, body_fn, carry), what)
        _set_counts(before)
    return carry


@contextlib.contextmanager
def warming():
    """Run both sides of every ``cond`` and at least one trip of every
    ``while_loop`` (the launches of what is thrown away not counted),
    checking that the sides, and a body and its carry, agree in structure,
    shapes and dtypes; on the card every body runs on its level's stream."""
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
        if not returns:
            return out
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


def _write_back(bufs, new_leaves) -> None:
    """Copy ``new_leaves`` into ``bufs``; a new leaf that lives in one of the
    buffers is copied out first, so no write overwrites what a later one
    reads."""
    owned = {_storage(b) for b in bufs}
    pairs = [(b, n.clone() if _storage(n) in owned else n)
             for b, n in zip(bufs, new_leaves) if n is not b]
    if pairs:
        torch._foreach_copy_([b for b, _ in pairs], [n for _, n in pairs])


class Program:
    """``fn(carry, inputs)`` eager and warming at its first call, then
    replayed from one CUDA graph with conditional nodes (module docstring).
    ``replays`` counts the replays; ``conds`` and ``whiles`` the IF pairs
    and WHILE nodes captured; ``bodies`` lists each conditional body as
    ``(kind, label, depth)`` (kind ``if``, ``else`` or ``while``, depth 1
    for a body of the graph itself); ``runs`` maps ``"kind:label"`` to the
    runs of those bodies that ``flush_launches`` has read."""

    def __init__(self, name: str, fn: Callable):
        self.name = name
        self.fn = fn
        self.graph = None
        self.replays = 0
        self.conds = 0
        self.whiles = 0
        self.bodies: List[tuple] = []
        self.runs: Dict[str, int] = {}

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
        """Add what the replays launched and each body's runs, counted on
        the device, to the wrappers' counts and ``runs`` (one read back)."""
        if self.graph is None:
            return
        values = self._counter.tolist()
        for w, n in zip(COUNTED, values):
            w.launches += int(n)
        for (kind, label, _), n in zip(self.bodies, values[len(COUNTED):]):
            key = f"{kind}:{label}"
            self.runs[key] = self.runs.get(key, 0) + int(n)
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
        self._counter = torch.zeros(len(COUNTED) + MAX_BODIES, dtype=torch.int64, device=dev)
        self._device = dev
        index = dev.index if dev.index is not None else torch.cuda.current_device()
        graph = torch.cuda.CUDAGraph()
        # the conditional bodies are captured on other streams, whose
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
                self._record(index, pool, in_spec, before)
        finally:
            if collecting:
                gc.enable()
        self.graph = graph

    def _record(self, index, pool, in_spec, before) -> None:
        """The capture's body: ``fn`` on the program's buffers, its launches
        counted on the device, the new carry written into the carry's
        buffers."""
        torch._C._cuda_beginAllocateCurrentThreadToPool(index, pool)
        _ctx.capture = self
        try:
            new_carry, out = self.fn(
                unflatten(self._carry_spec, iter(self._carry_buf)),
                unflatten(in_spec, iter(self._in_buf)))
            self._count(before)
            if signature(new_carry) != self._carry_sig:
                raise ValueError(f"program {self.name}: the new carry "
                                 f"{signature(new_carry)} differs from the carry "
                                 f"{self._carry_sig}")
            out_leaves, self._out_spec = flatten(out)
            # outputs that live in the carry's buffers would change
            # when the carry is written back: copy them first
            owned = {_storage(b) for b in self._carry_buf}
            self._out = [t.clone() if _storage(t) in owned else t for t in out_leaves]
            _write_back(self._carry_buf, flatten(new_carry)[0])
        finally:
            _ctx.capture = None
            torch._C._cuda_endAllocateToPool(index, pool)
            torch._C._cuda_releasePool(index, pool)
            _set_counts(before)

    def _count(self, before, slot: Optional[int] = None) -> None:
        """While capturing: the graph adds what the wrappers counted since
        ``before`` (and one run to a body's ``slot``) to the device counter,
        in one kernel, and the counts go back."""
        adds = [(k, now - then) for k, (now, then) in enumerate(zip(_counts(), before))
                if now != then]
        if slot is not None:
            adds.append((slot, 1))
        if adds:
            torch._foreach_add_([self._counter[k:k + 1] for k, _ in adds],
                                [n for _, n in adds])
        _set_counts(before)

    def _open(self, kind: int, pred, negate: int, label: str):
        """Add a conditional node on ``pred`` after the work captured so far,
        and start capturing its body on the body stream (suspending the
        capture of the body around it): returns ``(body stream, handle, the
        body's counter slot, what resumes the suspended capture)``."""
        if pred.device != self._device:
            raise ValueError(f"{label}: the predicate is on {pred.device}, the program runs "
                             f"on {self._device}")
        lib = cond_lib()
        if _ctx.depth > 0 and min(lib.runtime, lib.driver) < NESTING_CUDA:
            raise RuntimeError(f"program {self.name}: {label} nests a conditional node, "
                               f"which needs CUDA {NESTING_CUDA}; runtime {lib.runtime}, "
                               f"driver {lib.driver}")
        if len(self.bodies) == MAX_BODIES:
            raise RuntimeError(f"program {self.name}: more than {MAX_BODIES} conditional "
                               f"bodies")
        stream = torch.cuda.current_stream(self._device)
        body = _body_stream(self._device)
        handle = ctypes.c_ulonglong(0)
        parent, node = ctypes.c_void_p(None), ctypes.c_void_p(None)
        _raise_on(lib.begin(stream.cuda_stream, body.cuda_stream, pred.data_ptr(), negate,
                            kind, ctypes.byref(handle), ctypes.byref(parent), ctypes.byref(node)),
                  f"program {self.name}: conditional node for {label}")
        kind_name = "while" if kind == _WHILE else ("else" if negate else "if")
        self.bodies.append((kind_name, label, _ctx.depth + 1))
        return body, handle.value, len(COUNTED) + len(self.bodies) - 1, (parent, node)

    @contextlib.contextmanager
    def _body(self, body: torch.cuda.Stream, resume, label: str):
        """The body's capture, on the body stream one level deeper, ended
        (and the capture it suspended resumed, and both checked) however the
        body's code ends."""
        _ctx.depth += 1
        try:
            with torch.cuda.stream(body):
                yield
        finally:
            _ctx.depth -= 1
            rc = cond_lib().end(body.cuda_stream, *resume)
        _raise_on(rc, f"program {self.name}: conditional body of {label}")

    def _cond(self, pred, true_fn, false_fn, operands):
        """``cond`` while capturing: two IF nodes, on ``pred`` and on its
        negation; the second body copies its outputs into the first's."""
        label = _name(true_fn)
        outs, spec = None, None
        self.conds += 1
        for negate, fn in ((0, true_fn), (1, false_fn)):
            before = _counts()
            body, _, slot, resume = self._open(_IF, pred, negate, _name(fn))
            with self._body(body, resume, label):
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
                    _check_same(unflatten(spec, iter(outs)), out, label)
                    torch._foreach_copy_(outs, flatten(out)[0])
                self._count(before, slot)
        return unflatten(spec, iter(outs))

    def _while(self, cond_fn, body_fn, carry):
        """``while_loop`` while capturing: the carry copied into buffers of
        its own, then a WHILE node whose body writes the new carry into them
        and sets the node's handle from ``cond_fn`` of it."""
        label = _name(body_fn)
        want = signature(carry)
        leaves, spec = flatten(carry)
        bufs = [t.clone() for t in leaves]
        pred = _check_pred(cond_fn(unflatten(spec, iter(bufs))), "while_loop")
        self.whiles += 1
        before = _counts()
        body, handle, slot, resume = self._open(_WHILE, pred, 0, label)
        with self._body(body, resume, label):
            new = body_fn(unflatten(spec, iter(bufs)))
            _check_carry(want, new, label)
            _write_back(bufs, flatten(new)[0])
            again = _check_pred(cond_fn(unflatten(spec, iter(bufs))), "while_loop")
            self._count(before, slot)
            _raise_on(cond_lib().set(body.cuda_stream, handle, again.data_ptr()),
                      f"program {self.name}: the handle of {label}")
        return unflatten(spec, iter(bufs))
