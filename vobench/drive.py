"""The loop that drives the port, as ``engine/driver.py::run_vo`` drives it.

A pass is one drive of the seed's sequence from ``VOEngine.init_state()``
on the one engine built in set-up. The ``stream`` mode mirrors ``run_vo``'s
streamed path (``stream_step``): each frame is ``bootstrap`` (until one
reports a keyframe; a frame with too few detections is retried on the
next) or ``step``, then the summary's fetch, and the next host pair is
handed over only when the pose is on the host. The ``replay`` mode mirrors
its chunked path with ``preload_device`` (``flush_chunk``): the pass's
stack is uploaded, the bootstrap runs on host frames, then
``replay_chunk`` over whole chunks of the device stack, synchronized after
each and fetched once per chunk; a tail shorter than a chunk is streamed.

Every host span is the harness's own, a ``record_function`` range named
``upload``, ``bootstrap``, ``step``, ``fetch`` or ``replay_chunk`` (so a
trace shows them), and so is every CUDA event: one pair around each
``replay_chunk`` call, its closing event's ``query()`` read as the call
returns.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch
from torch.profiler import record_function

SPANS = ("upload", "bootstrap", "step", "fetch", "replay_chunk")


@dataclasses.dataclass
class Step:
    """A streamed call: ``kind`` ``bootstrap`` or ``step``, its latency from
    handing the pair over to the pose on the host, the part of it until the
    entry returned (the rest is the summary's fetch), its summary."""
    kind: str
    seconds: float
    summary: np.ndarray
    call_seconds: float = 0.0


@dataclasses.dataclass
class Chunk:
    """A ``replay_chunk`` call: its frames, the device ms between its events
    (None off the card), and whether the closing event was still pending
    when the call returned."""
    frames: int
    device_ms: Optional[float]
    pending_at_return: Optional[bool]


@dataclasses.dataclass
class Pass:
    """One pass: the summaries of the frames it finished, in frame order,
    and the ms of its bootstrap calls."""
    summaries: List[np.ndarray] = dataclasses.field(default_factory=list)
    bootstrap_ms: float = 0.0


@dataclasses.dataclass
class Window:
    """What a measured window recorded (the per-layer readers' input)."""
    mode: str
    seconds: float = 0.0                  # from its start to its last unit's end
    frames: int = 0                       # frames finished
    steps: List[Step] = dataclasses.field(default_factory=list)
    chunks: List[Chunk] = dataclasses.field(default_factory=list)
    passes: List[Pass] = dataclasses.field(default_factory=list)
    profile: Optional[dict] = None        # the traced stretch's reading (trace.py)


def host_copy(tree):
    """A tree of tensors (the port's ``VOState``) copied to the host."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, tuple):
        items = [host_copy(x) for x in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    return tree


class StateTap:
    """Wraps an engine's ``bootstrap`` and ``step`` (the calls ``replay_chunk``
    makes too) for one pass: for the frames in ``keep`` it copies to the
    host the state each call was given (``before[k]``) and the state it
    handed out (``after[k]``), and records each frame's entry (``kinds``).
    It adds host reads inside a chunk, so it taps the warm pass, never the
    window."""

    def __init__(self, engine, keep):
        self.engine, self.keep = engine, set(keep)
        self.kinds: List[str] = []
        self.before: Dict[int, object] = {}
        self.after: Dict[int, object] = {}

    def __enter__(self):
        self._own = {k: self.engine.__dict__.get(k) for k in ("bootstrap", "step")}
        for kind in ("bootstrap", "step"):
            setattr(self.engine, kind, self._wrap(kind, getattr(self.engine, kind)))
        return self

    def __exit__(self, *exc):
        for kind, fn in self._own.items():
            if fn is None:
                delattr(self.engine, kind)
            else:
                setattr(self.engine, kind, fn)

    def _wrap(self, kind, fn):
        def tapped(state, *args, **kwargs):
            k = len(self.kinds)
            self.kinds.append(kind)
            if k in self.keep:
                self.before[k] = host_copy(state)
            state, out = fn(state, *args, **kwargs)
            if k in self.keep:
                self.after[k] = host_copy(state)
            return state, out
        return tapped


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Driver:
    """Drives ``engine`` over the host stacks ``lefts`` / ``rights`` (uint8
    ``[N, H, W]``) in the traffic's mode."""

    def __init__(self, engine, parse_summary, lefts: np.ndarray, rights: np.ndarray,
                 traffic: dict):
        self.engine = engine
        self.parse = parse_summary
        self.lefts, self.rights = lefts, rights
        self.mode = traffic["mode"]
        if self.mode not in ("stream", "replay"):
            raise ValueError(f"unknown traffic mode {self.mode!r}")
        self.chunk = int(traffic.get("chunk_frames", 0))
        self.dev = engine.device

    # ------------------------------------------------------------------
    def run(self, seconds: float, whole_passes: bool = False) -> Window:
        """Passes until ``seconds`` have gone (checked between calls), or,
        with ``whole_passes``, until the pass running then ends."""
        win = Window(mode=self.mode)
        t0 = time.perf_counter()
        t_end = t0 + seconds

        def stop():
            return not whole_passes and time.perf_counter() >= t_end

        while True:
            self._pass(win, stop)
            if time.perf_counter() >= t_end:
                break
        win.seconds = time.perf_counter() - t0
        return win

    def _pass(self, win: Window, stop) -> None:
        p = Pass()
        win.passes.append(p)
        (self._stream_pass if self.mode == "stream" else self._replay_pass)(win, p, stop)

    def _call(self, win: Window, p: Pass, state, booting: bool, left, right):
        """One streamed ``bootstrap`` or ``step`` and its summary's fetch."""
        kind = "bootstrap" if booting else "step"
        fn = self.engine.bootstrap if booting else self.engine.step
        t0 = time.perf_counter()
        with record_function(kind):
            state, out = fn(state, left, right)
        t1 = time.perf_counter()
        with record_function("fetch"):
            vec = out.summary.detach().cpu().numpy()
        dt = time.perf_counter() - t0
        win.steps.append(Step(kind, dt, vec, t1 - t0))
        p.summaries.append(vec)
        if booting:
            p.bootstrap_ms += 1000 * dt
        win.frames += 1
        return state, bool(self.parse(vec)[1]["is_keyframe"])

    def _stream_pass(self, win: Window, p: Pass, stop) -> None:
        state = self.engine.init_state()
        initialized = False
        for i in range(len(self.lefts)):
            state, kf = self._call(win, p, state, not initialized, self.lefts[i], self.rights[i])
            initialized = initialized or kf
            if stop():
                return

    def _replay_pass(self, win: Window, p: Pass, stop) -> None:
        n = len(self.lefts)
        with record_function("upload"):
            lefts_d = torch.from_numpy(self.lefts).to(self.dev)
            rights_d = torch.from_numpy(self.rights).to(self.dev)
            _sync(self.dev)
        state = self.engine.init_state()
        i = 0
        initialized = False
        while not initialized and i < n:
            state, initialized = self._call(win, p, state, True, self.lefts[i], self.rights[i])
            i += 1
            if stop():
                return
        on_card = self.dev.type == "cuda"
        while self.chunk > 1 and i + self.chunk <= n:
            if on_card:
                ev0, ev1 = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
                ev0.record()
            with record_function("replay_chunk"):
                state, _, summ = self.engine.replay_chunk(state, lefts_d[i:i + self.chunk],
                                                          rights_d[i:i + self.chunk])
            pending = None
            if on_card:
                ev1.record()
                pending = not ev1.query()
            _sync(self.dev)
            with record_function("fetch"):
                rows = summ.detach().cpu().numpy()
            win.chunks.append(Chunk(self.chunk, ev0.elapsed_time(ev1) if on_card else None,
                                    pending))
            p.summaries.extend(rows)
            win.frames += self.chunk
            i += self.chunk
            if stop():
                return
        while i < n:
            state, _ = self._call(win, p, state, False, self.lefts[i], self.rights[i])
            i += 1
            if stop():
                return
