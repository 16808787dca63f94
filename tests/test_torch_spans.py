"""The port's spans (``idto_tpu_torch/utils/profiler.py``) on the CPU: a
pendulum replan through the CPU stand-in of its captured graphs stamps its
regions and the named spans inside them, and the benchmark's reader
(``benchmark/yardstick/spans.py``) groups the records into replans.

Each span's records nest in its parent's as the site table says, the
spans under a region and its rest tile the region, the newest replans are
the last ones run, and the reader raises once the ring has overwritten
what it needs; a reset empties the ring and keeps it."""
from collections import defaultdict

import numpy as np
import pytest
import torch

from idto_tpu_torch.examples.registry import load_example
from idto_tpu_torch.mpc import controller as mpc
from idto_tpu_torch.parallel.batching import broadcast_problem
from idto_tpu_torch.soa import contact as tcon
from idto_tpu_torch.utils import graphs, profiler
import torch_bench  # noqa: F401  (puts benchmark/ on sys.path)
from yardstick import spans  # noqa: E402

# One intra-op thread: several test workers share the cores.
torch.set_num_threads(1)

REGIONS = ("mpc.replan_start", "solve.start", "solve.prepare",
           "solve.advance", "solve.finish", "mpc.store")


def _pendulum(name="pendulum"):
    """A pendulum (or the example ``name``) at T=4, initialized directly;
    returns a function that runs one replan through the stand-in and the
    ring's records written before it."""
    model, cfg, prob, params, q_guess = load_example(name, device="cpu")
    T = 4
    prob = prob.replace(num_steps=T, q_nom=prob.q_nom[: T + 1],
                        v_nom=prob.v_nom[: T + 1])
    probs = broadcast_problem(prob, 1)
    with graphs.eager():
        carry, _ = mpc.mpc_initialize(model, probs, params.replace(
            max_iterations=1), q_guess[None, : T + 1])
    x0 = torch.cat([prob.q_init, prob.v_init])[None]
    state = {"carry": carry, "k": 0}

    def replan():
        held = profiler.device_records("cpu")
        written = held[0] if held else 0
        k = state["k"] = state["k"] + 1
        with graphs.stand_in():
            state["carry"], _ = mpc.mpc_step(
                model, probs, mpc.make_mpc_params(params, 1),
                np.zeros(model.nq), state["carry"], x0 + 0.01 * k,
                torch.tensor(0.05 * k, dtype=torch.float64))
        return written
    return replan


@pytest.fixture(scope="module")
def ring():
    """Three replans, the first of which captures (warm-up, capture and
    replay all stamp): (records written before each and after the last,
    the records, the replan function)."""
    graphs.reset()
    profiler.reset()
    try:
        replan = _pendulum()
        marks = [replan() for _ in range(3)]
        count, records = profiler.device_records("cpu")
        yield marks + [count], records, replan
    finally:
        graphs.reset()
        profiler.reset()


def test_a_replan_opens_with_its_start_and_nests_as_the_sites_say(ring):
    marks, records, _ = ring
    last = records[marks[-2]:marks[-1]]
    first_site = profiler.sites[int(last[0, 0]) >> 1]
    assert last[0, 0] & 1 == 0 and first_site.name == "mpc.replan_start"
    assert first_site.parent == -1
    ivs = profiler.intervals(last)
    assert 2 * len(ivs) == len(last)  # every stamp paired
    assert [profiler.sites[s].name for s, *_ in ivs
            if profiler.sites[s].parent == -1] == list(REGIONS)
    names = {profiler.sites[s].name for s, *_ in ivs}
    assert {"physics.forces", "physics.partials", "physics.cost",
            "linalg.assemble", "linalg.factor", "linalg.newton",
            "linalg.dogleg", "physics.trial"} <= names
    for site, pos, t0, t1, _ in ivs:
        parent = profiler.sites[site].parent
        holders = [iv for iv in ivs if iv[1] < pos and iv[2] <= t0
                   and t1 <= iv[3]]
        if parent == -1:
            assert not holders
        else:  # the innermost span around it is its parent
            assert max(holders, key=lambda iv: iv[1])[0] == parent


def test_spans_and_rest_tile_each_region(ring):
    marks, records, _ = ring
    ivs = profiler.intervals(records[marks[-2]:marks[-1]])
    for site, pos, t0, t1, rest in ivs:
        if profiler.sites[site].parent != -1:
            continue
        kids = sorted((iv for iv in ivs if profiler.sites[iv[0]].parent
                       == site), key=lambda iv: iv[2])
        assert rest >= 0
        assert rest + sum(b - a for _, _, a, b, _ in kids) == t1 - t0
        edges = [t0] + [x for _, _, a, b, _ in kids for x in (a, b)] + [t1]
        assert edges == sorted(edges)  # inside the region, no overlap


def test_newest_are_the_last_replans(ring):
    marks, records, _ = ring
    ops = spans.operations(marks[-1], records, profiler.sites,
                           profiler.intervals, "replan", 2)
    for op, a, b in zip(ops, marks[-3:-1], marks[-2:]):
        want = records[a:b]
        self_ms = defaultdict(float)
        for site, _, _, _, own in profiler.intervals(want):
            self_ms[profiler.sites[site].name] += 1e-6 * own
        assert op.span_ms == pytest.approx(dict(self_ms))
        assert set(REGIONS) <= set(op.span_ms)
        assert sum(op.span_ms.values()) + op.outside_ms == \
            pytest.approx(1e-6 * (want[-1, 1] - want[0, 1]))
        assert op.kernels is None
    # The capturing replan stamped its warm-up and its capture's run too.
    held = sum(1 for code in records[:, 0].tolist() if not code & 1
               and profiler.sites[code >> 1].name == "mpc.replan_start")
    assert held == 3 + 2
    with pytest.raises(RuntimeError, match=f"holds {held} replan"):
        spans.operations(marks[-1], records, profiler.sites,
                         profiler.intervals, "replan", held + 1)


def test_the_reader_raises_once_the_ring_overwrote_a_replan(ring,
                                                            monkeypatch):
    replan = ring[2]
    cpu = torch.device("cpu")
    monkeypatch.setattr(profiler, "RING_RECORDS", 32)
    monkeypatch.setitem(profiler._rings, cpu, profiler._Ring(cpu))
    replan()
    replan()  # two replans of 30 records each: 32 hold one
    count, records = profiler.device_records("cpu")
    assert count > len(records) == 32
    assert len(spans.newest("replan", 1)) == 1
    with pytest.raises(RuntimeError, match="overwrote"):
        spans.newest("replan", 2)


def test_reset_empties_the_ring_it_keeps(ring):
    """Captured graphs hold a ring's memory: a reset empties the ring in
    place, and the next replan's records open it."""
    replan = ring[2]
    held = profiler._rings[torch.device("cpu")]
    profiler.reset()
    assert profiler._rings[torch.device("cpu")] is held
    assert profiler.device_records("cpu")[0] == 0
    replan()
    count, records = profiler.device_records("cpu")
    assert count == len(records) == 30
    assert profiler.sites[int(records[0, 0]) >> 1].name == "mpc.replan_start"
    assert len(spans.newest("replan", 1)) == 1


# -- the capsule search's span: punyo's replans stamp it, the other models'
# never enter it -------------------------------------------------------------

def _second_replan(name):
    """Two replans of ``name`` at T=4, the first of which captures: the
    second's records and its spans' names."""
    graphs.reset()
    profiler.reset()
    try:
        replan = _pendulum(name)
        replan()
        written = replan()
        count, records = profiler.device_records("cpu")
        last = records[written - (count - len(records)):]
        names = [profiler.sites[s].name for s, *_ in profiler.intervals(last)]
        return last, names
    finally:
        graphs.reset()
        profiler.reset()


def test_punyo_replans_stamp_the_capsule_search():
    """punyo's captured regions hold ``physics.capsule_search`` under each
    physics span that evaluates contact: the forces of ``solve.prepare``
    and ``solve.finish``, the partials (q, v and a tangents: three
    step_tau evaluations under ``torch.func``) and the trial rollout of
    ``solve.advance``, once in each: its 8 capsule-box pairs (the arms'
    capsules against the chest and against the ground) are one search; a
    capsule search's time counts towards ``physics_ms`` once, as self
    time."""
    records, _ = _second_replan("punyo")
    ivs = profiler.intervals(records)
    under = defaultdict(int)
    for site, *_ in ivs:
        if profiler.sites[site].name == "physics.capsule_search":
            parent = profiler.sites[profiler.sites[site].parent]
            region = profiler.sites[parent.parent].name
            under[(region, parent.name)] += 1
    assert dict(under) == {
        ("solve.prepare", "physics.forces"): 1,
        ("solve.prepare", "physics.partials"): 3,
        ("solve.advance", "physics.trial"): 1,
        ("solve.finish", "physics.forces"): 1,
    }
    op = spans.operations(len(records), records, profiler.sites,
                          profiler.intervals, "replan", 1)[0]
    assert op.span_ms["physics.capsule_search"] > 0.0


class _SearchRan(Exception):
    pass


@pytest.mark.parametrize("name", ("hopper", "mini_cheetah", "punyo"))
def test_models_without_capsules_never_enter_the_search(name, monkeypatch):
    """The models without capsule-box pairs run no capsule search: their
    replans, capture included, run with both searches made to raise, and
    stamp no ``physics.capsule_search``; punyo's, which search, raise."""
    def raises(*args, **kwargs):
        raise _SearchRan

    monkeypatch.setattr(tcon, "capsule_vs_box", raises)
    monkeypatch.setattr(tcon, "_ternary_search", raises)
    if name == "punyo":
        with pytest.raises(_SearchRan):
            _second_replan(name)
        return
    _, names = _second_replan(name)
    assert "physics.forces" in names
    assert "physics.capsule_search" not in names
