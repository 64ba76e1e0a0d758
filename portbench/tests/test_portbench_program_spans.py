"""The program spans' parser (``program_spans.parse``) and its three
readers on a trace made by hand, whose readings are worked out below;
and ``trace.parse`` and every reader of the manifest unchanged by the
``mp.*`` spans on the same events."""

from __future__ import annotations

import pytest

from portbench import harness, program_spans, trace
from portbench.tests._tiny import REPO, manifest

MAIN, W0, W1, W2 = 1, 11, 12, 13


def _span(name, tid, s, e):
    # the program's spans are cpu_op events, the benchmark's annotations
    cat = "cpu_op" if name.startswith("mp.") else "user_annotation"
    return {"ph": "X", "cat": cat, "name": name, "tid": tid, "ts": s,
            "dur": e - s}


def _op(corr, tid, at, s, e, skew=0.0, cat="kernel", name="k"):
    """A launch on thread ``tid`` at ``at`` and its device operation at
    ``s``-``e`` on the host's clock, stamped ``skew`` later."""
    return [{"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
             "tid": tid, "ts": at, "dur": 1, "args": {"correlation": corr}},
            {"ph": "X", "cat": cat, "name": name, "tid": 7, "ts": s + skew,
             "dur": e - s, "args": {"correlation": corr}}]


# epoch 5's dispatch hands tasks to workers 0 and 1, stalling 25 and
# 50 us before their launch: the least is left out of the head
STALLS = {5: 25e-6}


def _events(program=True, retask=False, skew=0.0):
    """One epoch (5) of a 1000 us window. The coordinator: drain, dispatch
    (holding the payload copy, on the card 18-25, as soon as it is
    launched), two waits, the last returning at 280, the decode's five
    spans (on the card 340-345 and 370-390). Workers 0 and 1 launch
    products at 65 and 92, on the card at 80-180 and 100-260. With
    ``retask``, worker 2 is handed a task by a re-task at 45 whose
    product runs 52-56: a launch inside the head, which ends it there;
    the tail does not move. The device's clock reads ``skew`` ahead of
    the host's."""
    pb = [_span("pb.window", MAIN, 0, 1000), _span("pb.epoch", MAIN, 0, 500),
          _span("pb.asyncmap", MAIN, 10, 300),
          _span("pb.decode", MAIN, 300, 400), _span("pb.sync", MAIN, 400, 500)]
    ops = (_op(99, MAIN, 18, 18, 25, skew, "gpu_memcpy", "Memcpy DtoD")
           + _op(100, W0, 65, 80, 180, skew) + _op(101, W1, 92, 100, 260, skew)
           + _op(200, MAIN, 335, 340, 345, skew)
           + _op(201, MAIN, 360, 370, 390, skew))
    mp = [_span("mp.pool.drain/e5", MAIN, 10, 12),
          _span("mp.pool.dispatch/e5", MAIN, 12, 40),
          _span("mp.backend.copy", MAIN, 14, 20),
          _span("mp.pool.wait/e5", MAIN, 41, 200),
          _span("mp.pool.wait/e5", MAIN, 201, 280),
          _span("mp.decode.select", MAIN, 300, 310),
          _span("mp.decode.stack", MAIN, 310, 330),
          _span("mp.decode.factor", MAIN, 330, 340),
          _span("mp.decode.gather", MAIN, 340, 350),
          _span("mp.decode.solve", MAIN, 350, 395)]
    if retask:
        ops += _op(102, W2, 48, 52, 56, skew)
        if program:
            mp.append(_span("mp.pool.retask/w2/e5", MAIN, 45, 46))
    return pb + ops + (mp if program else [])


# head: idle 12-80 (68, less the copy's 7), less the idle of the least
# stall from the dispatch's start, 12-37 (25, less the copy's 7); tail:
# 260-280; decode: 300-395 (95) less 5 + 20 on the card
HEAD_US, TAIL_US, DECODE_US = 43.0, 20.0, 70.0
# with the re-task: idle 12-52 (40, less the copy's 7), less 18
HEAD_RETASK_US = 15.0
# the window's idle 788 us, each stretch under the innermost span open
GAPS_US = {"host outside pb spans": 510, "pb.sync": 100,
           "mp.pool.wait": 59, "mp.decode.solve": 25, "pb.asyncmap": 21,
           "mp.decode.stack": 20, "mp.pool.dispatch": 17,
           "mp.decode.select": 10, "mp.decode.factor": 10,
           "mp.decode.gather": 5, "pb.decode": 5, "mp.backend.copy": 4,
           "mp.pool.drain": 2}


@pytest.mark.parametrize("skew", [0.0, -300.0, 40.0])
@pytest.mark.parametrize("retask", [False, True])
def test_the_three_readings(retask, skew):
    got = program_spans.parse(_events(retask=retask, skew=skew), STALLS)
    assert got["clock_skew_us"] == [skew]
    head = HEAD_RETASK_US if retask else HEAD_US
    assert got["dispatch_idle_us"] == [pytest.approx(head)]
    assert got["arrival_idle_us"] == [pytest.approx(TAIL_US)]
    assert got["decode_spans"] == 5
    assert got["decode_idle_us"] == pytest.approx(DECODE_US)
    record = {"n_epochs": 1, "trace": {"program": got}}
    for name, us in [("dispatch_idle_ms", head),
                     ("arrival_idle_ms", TAIL_US),
                     ("decode_idle_ms", DECODE_US)]:
        assert harness.reader(REPO, name).read(record) == pytest.approx(
            us / 1e3)


def test_idle_gaps_named_by_the_innermost_span_same_total():
    got = dict(program_spans.parse(_events(), top=len(GAPS_US))["idle_gaps"])
    assert got == pytest.approx({n: us / 1e6 for n, us in GAPS_US.items()})
    before = trace.parse(_events())["idle_gaps"]
    assert sum(got.values()) == pytest.approx(sum(s for _, s in before))


@pytest.mark.parametrize("retask", [False, True])
def test_existing_readings_unchanged_by_program_spans(retask):
    bare = trace.parse(_events(program=False, retask=retask))
    spanned = trace.parse(_events(program=True, retask=retask))
    assert spanned == bare
    record = {"setup_s": 1.0, "window_s": 1e-3, "n_epochs": 1,
              "latency_ms": [1.0], "asyncmap_host_ms": [0.3],
              "fresh_at_return": [2], "k": 2, "variable_nwait": False,
              "useful_flops_per_epoch": 1, "product_flops": 1,
              "products_dispatched": 2, "decode_bytes": 1,
              "decode_flops": 1}
    for m in manifest()["per_layer"]:
        read = harness.reader(REPO, m["name"]).read
        assert read(dict(record, trace=spanned)) == read(
            dict(record, trace=bare)), m["name"]


def test_nothing_to_read_without_program_spans():
    assert program_spans.parse(_events(program=False)) is None
    assert program_spans.parse([]) is None
    for name in ("dispatch_idle_ms", "arrival_idle_ms", "decode_idle_ms"):
        read = harness.reader(REPO, name).read
        assert read({"n_epochs": 1, "trace": None}) is None
        assert read({"n_epochs": 1, "trace": trace.parse(
            _events(program=False))}) is None


def test_the_clocks_offset_between_epochs_and_over_queued_ones():
    epochs = [(0, 100), (100, 200), (200, 300)]
    # epoch 1's one launch waited 5 ms in a queue: it says nothing
    launches = {1: (MAIN, 10), 2: (MAIN, 110), 3: (MAIN, 210)}
    device = [("kernel", 10 - 300, 0, 1), ("kernel", 110 + 5000, 0, 2),
              ("kernel", 210 - 310, 0, 3)]
    skew = program_spans._Skew(epochs, device, launches)
    assert skew.of == [-300, -310]
    assert skew(110) == pytest.approx(110 - 305)  # linear between
    assert skew(0) == -300 and skew(300) == 300 - 310  # held outside
    nothing = program_spans._Skew(epochs[1:2], device[1:2], launches)
    assert nothing.of == [] and nothing(150) == 150


def test_without_stalls_none_is_left_out():
    """Without ``stalls`` the head keeps the whole stretch, 12-80 less
    the copy's 7 us; the other readings stand."""
    got = program_spans.parse(_events())
    assert got["dispatch_idle_us"] == [pytest.approx(61.0)]
    assert got["arrival_idle_us"] == [pytest.approx(TAIL_US)]
    assert got["decode_idle_us"] == pytest.approx(DECODE_US)


def test_a_launch_before_the_dispatch_is_not_its_head():
    """The head ends at the first operation launched after the dispatch
    began: an older launch (worker 0's, at 5) is not its end."""
    events = _events() + _op(103, W0, 5, 6, 9)
    got = program_spans.parse(events, STALLS)
    assert got["dispatch_idle_us"] == [pytest.approx(HEAD_US)]
    # the least stall leaves out no more than the head
    assert program_spans.parse(_events(), {5: 1.0})[
        "dispatch_idle_us"] == [pytest.approx(0.0)]


def test_program_spans_read_as_either_category():
    """A program span recorded by ``record_function`` (a
    ``user_annotation``) reads as the fast record function's."""
    events = [dict(e, cat="user_annotation")
              if e.get("name", "").startswith("mp.") else e
              for e in _events()]
    assert program_spans.parse(events, STALLS) == program_spans.parse(
        _events(), STALLS)


def test_span_names_split():
    assert program_spans.split("mp.pool.retask/w3/e120") == (
        "mp.pool.retask", 3, 120)
    assert program_spans.split("mp.pool.wait/e7") == ("mp.pool.wait", None, 7)
    assert program_spans.split("mp.decode.solve") == (
        "mp.decode.solve", None, None)
