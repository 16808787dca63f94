"""The six readers of the program's spans on synthetic records: grouping
into operations, self times and region rests, the device time outside the
regions, kernel nodes by span, the settled replans before a window (not
the window's late ones) and the newest batch calls, a ring that overwrote
what a reader needs, and a program without spans."""
from __future__ import annotations

import types

import numpy as np
import pytest

from idto_tpu_torch.utils.profiler import intervals
from yardstick import manifest, spans


def _site(name, parent, kernels):
    return types.SimpleNamespace(name=name, parent=parent, kernels=kernels)


# A replan's regions and spans (site id: name, parent, kernel nodes between
# its stamps) and a batch call's, as one capture of each would record them.
SITES = [
    _site("mpc.replan_start", -1, 10),        # 0
    _site("solve.start", -1, 5),              # 1
    _site("solve.prepare", -1, 100),          # 2
    _site("physics.forces", 2, 30),           # 3
    _site("physics.partials", 2, 50),         # 4
    _site("linalg.factor", 2, 8),             # 5
    _site("solve.advance", -1, 40),           # 6
    _site("linalg.dogleg", 6, 4),             # 7
    _site("physics.trial", 6, 30),            # 8
    _site("solve.finish", -1, 35),            # 9
    _site("physics.forces", 9, 30),           # 10
    _site("mpc.store", -1, 6),                # 11
]


def _replan(t, wait=0):
    """The records of one replan from ns ``t`` (all times in us): 1 us
    between regions, and ``wait`` more before ``solve.prepare`` (a launch
    the host was late with); returns (records, ns after it)."""
    rec = []

    def stamp(site, exit_, us):
        us += wait if us >= 16 else 0
        rec.append((site << 1 | exit_, t + int(1000 * us)))

    stamp(0, 0, 0), stamp(0, 1, 10)                      # replan_start 10
    stamp(1, 0, 11), stamp(1, 1, 15)                     # start 4
    stamp(2, 0, 16)                                      # prepare 200
    stamp(3, 0, 17), stamp(3, 1, 57)                     # forces 40
    stamp(4, 0, 58), stamp(4, 1, 198)                    # partials 140
    stamp(5, 0, 199), stamp(5, 1, 209)                   # factor 10
    stamp(2, 1, 216)
    stamp(6, 0, 217)                                     # advance 60
    stamp(7, 0, 218), stamp(7, 1, 222)                   # dogleg 4
    stamp(8, 0, 223), stamp(8, 1, 273)                   # trial 50
    stamp(6, 1, 277)
    stamp(9, 0, 278), stamp(9, 1, 330)                   # finish 52
    stamp(10, 0, 279), stamp(10, 1, 329)                 # forces 50
    stamp(11, 0, 331), stamp(11, 1, 339)                 # store 8
    # Written region by region above; the ring holds them in time order.
    rec.sort(key=lambda r: r[1])
    return rec, t + 1000 * (400 + wait)


def _ring(replans, late=0):
    """``replans`` replans, of which the last ``late`` wait 5 ms."""
    rec, t = [], 10_000
    for k in range(replans):
        more, t = _replan(t, 5000 if k >= replans - late else 0)
        rec += more
    return np.asarray(rec, dtype=np.int64)


def _ctx(kind, n):
    """A run's context: a replan window of ``n`` replans, or ``n`` batch
    calls after the traced stretch."""
    if kind == "replan":
        return types.SimpleNamespace(kind="replan", ops=n)
    return types.SimpleNamespace(kind="batch", rate_solves=256 * n,
                                 solves_per_op=256)


@pytest.fixture
def program(monkeypatch):
    """Stands the program's ring in for ``records`` (and ``written``)."""
    state = {}

    def read():
        if "records" not in state:
            return None
        recs = state["records"]
        return (state.get("written", len(recs)), recs, SITES, intervals)

    monkeypatch.setattr(spans, "read_program", read)
    return state


def test_replan_readers_on_synthetic_records(program, monkeypatch):
    # Two settled replans of set-up, then a window of one late replan.
    monkeypatch.setattr(spans, "SETTLED", 2)
    program["records"] = _ring(3, late=1)
    assert spans.newest("replan", 1)[0].outside_ms == pytest.approx(5.005)
    ops = spans.newest("replan", 3)[:2]
    op = ops[-1]
    # self times: prepare's rest is 200 - 40 - 140 - 10 us
    assert op.span_ms["solve.prepare"] == pytest.approx(0.010)
    assert op.span_ms["physics.forces"] == pytest.approx(0.090)
    assert op.span_ms["solve.finish"] == pytest.approx(0.002)
    # the replan's stamps span 339 us, of which 334 lie in regions
    assert op.outside_ms == pytest.approx(0.005)
    assert sum(op.span_ms.values()) + op.outside_ms == pytest.approx(0.339)
    # kernel nodes under no child: prepare 100 - (30+2) - (50+2) - (8+2)
    assert op.kernels["solve.prepare"] == 6
    assert op.kernels["physics.forces"] == 60

    def metric(name):
        return manifest.reader(name)(_ctx("replan", 1))

    assert metric("physics_ms.replan") == pytest.approx(0.280)
    assert metric("linalg_ms.replan") == pytest.approx(0.014)
    assert metric("outside_regions_ms.replan") == pytest.approx(0.005)
    assert metric("physics_kernels_per_replan") == 30 + 50 + 30 + 30
    for name in ("physics_ms.batch", "linalg_ms.batch"):
        assert manifest.reader(name)(_ctx("replan", 2)) is None


def test_batch_readers_open_a_call_at_the_solve_start(program):
    recs = _ring(2)
    # A batch call has no replan start: drop its records.
    program["records"] = recs[(recs[:, 0] >> 1) != 0]
    ops = spans.newest("batch", 2)
    assert [round(sum(op.span_ms.values()) + op.outside_ms, 6)
            for op in ops] == [0.328, 0.328]
    got = {name: manifest.reader(name)(_ctx("batch", 2))
           for name in ("physics_ms.batch", "linalg_ms.batch")}
    assert got == {"physics_ms.batch": pytest.approx(0.280),
                   "linalg_ms.batch": pytest.approx(0.014)}


def test_newest_and_an_overwritten_ring(program):
    program["records"] = _ring(3)
    first = spans.newest("replan", 3)[0]
    assert spans.newest("replan", 1)[0] == spans.newest("replan", 3)[-1]
    assert first.span_ms == spans.newest("replan", 3)[1].span_ms
    program["written"] = 10 * len(program["records"])
    with pytest.raises(RuntimeError, match="overwrote"):
        spans.newest("replan", 4)
    assert len(spans.newest("replan", 3)) == 3


def test_a_program_without_spans_reads_nothing(program):
    for name in ("physics_ms.replan", "linalg_ms.replan",
                 "outside_regions_ms.replan", "physics_kernels_per_replan"):
        assert manifest.reader(name)(_ctx("replan", 2)) is None
    for name in ("physics_ms.batch", "linalg_ms.batch"):
        assert manifest.reader(name)(_ctx("batch", 2)) is None
