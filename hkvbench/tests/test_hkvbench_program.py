"""The readers of the program's spans and counters (`hkvbench/program.py`
and `metrics/program_idle.py`, `closure.idle_ms.py`, `hash.idle_ms.py`,
`hit_rate.py`) on synthetic spans over a synthetic slice, against values
worked out by hand; and on a program that records no spans."""

from __future__ import annotations

import types

import pytest

from hkvbench import harness
from hkvbench import trace as trace_mod
from repro_torch.obs import trace

READERS = ("program_idle", "closure.idle_ms", "hash.idle_ms", "hit_rate", "device_idle")


class _Span:
    def __init__(self, name, start_ns, end_ns, **counters):
        self.name, self.start_ns, self.end_ns, self._c = name, start_ns, end_ns, counters

    def counters(self):
        return dict(self._c)


def _slice(t0, t1, busy):
    s = object.__new__(trace_mod.Slice)
    s.spans, s.device, s.t0, s.t1 = [], [], t0, t1
    s.busy = [list(b) for b in busy]
    return s


# The slice [0, 100) ns; the device runs in [10, 20) and [40, 70): 60 ns idle.
BUSY = [(10, 20), (40, 70)]
SPANS = [
    _Span("op.find", 5, 50, lanes=10, hits=7),
    _Span("hash", 5, 15),
    _Span("op.find_or_insert", 52, 98, lanes=30, hits=20, inserted=10),
    _Span("closure.dedupe", 55, 90),
    _Span("closure.rank", 80, 95),
    _Span("op.insert_or_assign", 60, 61, lanes=100, hits=0),
    _Span("op.find", 150, 160, lanes=1000, hits=0),          # after the slice
]
# by hand: in a span [5, 50) + [52, 98) = 91 ns, the device busy 10 + 10 + 18
# of them: 53 ns idle; closure [55, 95) idle [70, 95) = 25 ns; hash [5, 15)
# idle [5, 10) = 5 ns; two profiled batches; hits (7 + 20) of (10 + 30) lanes.
WANT = {"program_idle": 53.0, "closure.idle_ms": 12.5e-6, "hash.idle_ms": 2.5e-6,
        "hit_rate": 67.5, "device_idle": 60.0}


def _run(busy=BUSY, profiled=(7, 8)):
    return types.SimpleNamespace(slice=_slice(0, 100, busy), profiled=list(profiled))


def _read(name, run):
    return harness.load_module(harness.HERE / "metrics" / f"{name}.py").read(run)


@pytest.mark.parametrize("name", READERS)
def test_readers_give_the_values_worked_out_by_hand(monkeypatch, name):
    monkeypatch.setattr(trace, "recorded", lambda: list(SPANS))
    assert _read(name, _run()) == pytest.approx(WANT[name], rel=1e-12)


@pytest.mark.parametrize("busy", [BUSY, [(0, 100)], [(99, 100)], [(3, 4), (50, 52), (96, 130)]],
                         ids=["two", "all", "one_ns", "edges"])
def test_program_idle_is_never_above_device_idle(monkeypatch, busy):
    monkeypatch.setattr(trace, "recorded", lambda: list(SPANS))
    run = _run(busy)
    program, device = _read("program_idle", run), _read("device_idle", run)
    assert 0.0 <= program <= device


@pytest.mark.parametrize("name", READERS[:4])
def test_a_program_without_spans_gives_nothing(monkeypatch, name):
    monkeypatch.delattr(trace, "recorded")
    assert _read(name, _run()) is None
    monkeypatch.setattr(trace, "recorded", lambda: [], raising=False)
    assert _read(name, _run()) is None


@pytest.mark.parametrize("name", READERS[:4])
def test_an_untraced_run_gives_nothing(monkeypatch, name):
    monkeypatch.setattr(trace, "recorded", lambda: list(SPANS))
    assert _read(name, types.SimpleNamespace(slice=None, profiled=[])) is None
