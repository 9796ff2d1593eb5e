"""``engine/graphs.py::while_loop`` and nested conditional bodies.

On the CPU (outside a capture ``while_loop`` is a Python loop):
- 0, 1 and n trips, the predicate read once per trip and once to stop
  (counted in ``graphs._ctx.reads``), what plain Python computes;
- a body whose carry changes structure, shape or dtype raises, and so does a
  predicate that is no 0-d bool;
- while warming, a loop that takes no trip runs its body once, keeps the
  zero-trip result and counts none of that run's launches; a loop that
  takes trips runs exactly those, their launches counted;
- a ``cond`` inside a ``while_loop`` inside a ``cond`` computes what plain
  Python computes, warming or not.

The ``cuda`` tests need the card (``python -m pytest
tests/test_torch_graph_while.py -m cuda --noconftest -q``): the same
three-level nest captured in a ``graphs.Program`` (an IF pair whose body
holds a WHILE node whose body holds an IF pair) and replayed at several
inputs, bitwise its eager run, with the loop's trips and a launch counted
per trip on the device; and a WHILE node at the graph's own level at 0, 1
and 10 trips, bitwise its eager run.
"""

import contextlib

import pytest
import torch

from stereo_vo_tpu_torch.engine import graphs
from stereo_vo_tpu_torch.ops.lk import lk_level_pass

from torch_port_helpers import assert_equal


def _count_up(n):
    """A loop of ``n`` trips over ``(x, i)``: ``x`` halved and moved by
    ``i`` each trip."""
    def running(c):
        return c[1] < n

    def halve(c):
        x, i = c
        return x * 0.5 + i.to(x.dtype), i + 1

    return running, halve


def _plain_count_up(x, n):
    i = torch.zeros((), dtype=torch.int32)
    for _ in range(n):
        x, i = x * 0.5 + i.to(x.dtype), i + 1
    return x, i


@pytest.mark.parametrize("n", [0, 1, 7])
def test_while_loop_trips_and_reads(n):
    x = torch.linspace(-3.0, 5.0, 6)
    running, halve = _count_up(n)
    reads = graphs._ctx.reads
    got = graphs.while_loop(running, halve, (x, torch.zeros((), dtype=torch.int32)))
    assert graphs._ctx.reads - reads == n + 1
    want = _plain_count_up(x, n)
    assert int(got[1]) == n
    assert_equal(got[0], want[0], "x")


@pytest.mark.parametrize("change", ["dtype", "shape", "structure"])
def test_while_loop_body_changing_the_carry_raises(change):
    bad = {"dtype": lambda c: (c[0].to(torch.float64), c[1] + 1),
           "shape": lambda c: (c[0][:2], c[1] + 1),
           "structure": lambda c: (c[0], c[1] + 1, c[0])}[change]
    carry = (torch.zeros(3), torch.zeros((), dtype=torch.int32))
    with pytest.raises(ValueError):
        graphs.while_loop(lambda c: c[1] < 2, bad, carry)


@pytest.mark.parametrize("pred", [torch.tensor([True]), torch.tensor(1), True])
def test_while_loop_predicate_must_be_a_0d_bool(pred):
    with pytest.raises(ValueError):
        graphs.while_loop(lambda c: pred, lambda c: c, (torch.zeros(2),))


@pytest.mark.parametrize("n", [0, 3])
def test_while_loop_warming(n):
    """A zero-trip loop runs its body once while warming, keeps the zero-trip
    carry and counts none of that run's launches; otherwise the trips run,
    each counted."""
    ran = []

    def body(c):
        ran.append(1)
        lk_level_pass.launches += 1
        return c[0] + 1.0, c[1] + 1

    x = torch.arange(4.0)
    before = lk_level_pass.launches
    try:
        with graphs.warming():
            out = graphs.while_loop(lambda c: c[1] < n, body,
                                    (x, torch.zeros((), dtype=torch.int32)))
        assert len(ran) == max(n, 1)
        assert lk_level_pass.launches - before == n
    finally:
        lk_level_pass.launches = before
    assert int(out[1]) == n
    assert_equal(out[0], x + float(n), "carry")


def _nest(x, n, flag):
    """A ``cond`` on ``flag`` whose true side loops ``n`` times, each trip a
    ``cond`` on the sign of ``x``'s sum; one launch counted per trip."""
    def step(c):
        v, i = c
        lk_level_pass.launches += 1
        v = graphs.cond(v.sum() > 0, lambda u: u * 0.5 + 1.0, lambda u: u - 2.0, (v,))
        return v, i + 1

    def looped(v, m):
        v, i = graphs.while_loop(lambda c: c[1] < m, step,
                                 (v, torch.zeros((), dtype=torch.int32, device=v.device)))
        return v + i.to(v.dtype)

    def skipped(v, m):
        return v - 1.0

    return graphs.cond(flag, looped, skipped, (x, n))


def _plain_nest(x, n, flag):
    if not flag:
        return x - 1.0
    i = 0
    for _ in range(n):
        x = x * 0.5 + 1.0 if float(x.sum()) > 0 else x - 2.0
        i += 1
    return x + torch.tensor(i, dtype=torch.int32).to(x.dtype)


NEST_CASES = [(0.5, 0, True), (0.5, 1, True), (-4.0, 5, True), (3.0, 10, True),
              (3.0, 4, False)]


@pytest.mark.parametrize("warm", [False, True])
@pytest.mark.parametrize("shift,n,flag", NEST_CASES)
def test_cond_in_while_loop_in_cond(shift, n, flag, warm):
    x = torch.linspace(-1.0, 1.0, 5) + shift
    before = lk_level_pass.launches
    try:
        with graphs.warming() if warm else contextlib.nullcontext():
            got = _nest(x, torch.tensor(n, dtype=torch.int32), torch.tensor(flag))
        assert lk_level_pass.launches - before == (n if flag else 0)
    finally:
        lk_level_pass.launches = before
    assert_equal(got, _plain_nest(x, n, flag), "nest")


# ---------------------------------------------------------------------------
# on the card

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_nested_while_in_if_equals_eager():
    """The three-level nest as one graph: an IF pair, a WHILE node in its
    true body, an IF pair in the WHILE body; replayed at each case, bitwise
    the eager run, the trips and one launch per trip counted on the
    device."""
    dev = _card()

    def fn(carry, inputs):
        (x,), (n, flag) = carry, inputs
        return (_nest(x, n, flag),), ()

    program = graphs.Program("nest", fn)
    base = torch.linspace(-1.0, 1.0, 5, device=dev)
    n_t = torch.zeros((), dtype=torch.int32, device=dev)
    flag_t = torch.zeros((), dtype=torch.bool, device=dev)
    program((base.clone(),), (n_t, flag_t))            # warming, then the capture
    assert program.whiles == 1 and program.conds == 2
    assert [b[0] for b in program.bodies] == ["if", "while", "if", "else", "else"]
    assert [b[2] for b in program.bodies] == [1, 2, 3, 3, 1]
    program.flush_launches()
    program.runs.clear()
    before = lk_level_pass.launches
    trips = 0
    for shift, n, flag in NEST_CASES:
        x = base + shift
        n_t.fill_(n)
        flag_t.fill_(flag)
        (got,), _ = program((x.clone(),), (n_t, flag_t))
        got = got.clone()
        want = _nest(x.clone(), torch.tensor(n, dtype=torch.int32, device=dev),
                     torch.tensor(flag, device=dev))
        assert_equal(got.cpu(), want.cpu(), f"shift {shift}, n {n}, flag {flag}")
        trips += n if flag else 0
    eager_launches = lk_level_pass.launches - before
    program.flush_launches()
    assert lk_level_pass.launches - before - eager_launches == trips
    assert program.runs["while:step"] == trips
    assert program.runs["if:looped"] == sum(flag for _, _, flag in NEST_CASES)
    assert program.runs["if:<lambda>"] + program.runs["else:<lambda>"] == trips
    lk_level_pass.launches = before


@pytest.mark.cuda
@pytest.mark.parametrize("n", [0, 1, 10])
def test_cuda_while_node_trips_equal_eager(n):
    dev = _card()

    def fn(carry, inputs):
        (x,), (m,) = carry, inputs
        running, halve = _count_up(m)
        x, i = graphs.while_loop(running, halve,
                                 (x, torch.zeros((), dtype=torch.int32, device=dev)))
        return (x,), (i,)

    program = graphs.Program("count_up", fn)
    x = torch.linspace(-3.0, 5.0, 6, device=dev)
    m = torch.full((), 2, dtype=torch.int32, device=dev)
    program((x.clone(),), (m,))                        # warming, then the capture
    program.flush_launches()
    program.runs.clear()
    m.fill_(n)
    (got,), (i,) = program((x.clone(),), (m,))
    want, want_i = _plain_count_up(x.cpu(), n)
    assert int(i) == n
    assert_equal(got.cpu(), want, "x")
    program.flush_launches()
    assert program.runs["while:halve"] == n
