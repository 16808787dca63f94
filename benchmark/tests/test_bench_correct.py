"""The comparison that decides ``correct``, on the CPU at a small size: the
reference agrees with the port, a sound run passes, and the control (the
reference in float32 in the program's place) and each fault a cell can
have fail it."""
from __future__ import annotations

import os
import subprocess
import sys
import time

import pytest
import torch

import control
from conftest import BENCH_DIR, ROOT, tiny_cell, tiny_program
from yardstick import runner

SEED = 2**31 + 77
CELLS = ("cheetah.replan", "cheetah.batch256", "hopper.replan",
         "allegro.batch256")


def _run(cell, prog, seconds=0.5):
    result, lines = runner.run_cell(cell, SEED, seconds, False, "cpu",
                                    time.perf_counter(), prog=prog)
    return result


def test_reference_matches_the_port_at_the_configurations_sizes():
    """One iteration of each configuration at its YAML sizes, from its
    YAML guess: the reference against the port's batch solve."""
    from reference import Reference
    from yardstick import manifest, program

    for name in ("mini_cheetah", "allegro_hand", "hopper"):
        config = manifest._load_json(os.path.join(
            BENCH_DIR, "configs", f"{name}.json"))
        loaded = program.load(config, "cpu")
        params = loaded.params.replace(max_iterations=1,
                                       check_convergence=False)
        sol, st, _ = program.solve_batch(
            loaded.model, program.broadcast_problem(loaded.prob, 1), params,
            loaded.q_guess[None])
        ref = Reference(config, "cpu")
        b = ref.base
        it = ref.iterate(b["q_guess"][None], b["q_init"][None],
                         b["v_init"][None], b["q_nom"][None],
                         torch.tensor([ref.solver["Delta0"]],
                                      dtype=torch.float64))
        step = (it.q - loaded.q_guess[None]).norm()
        assert float((sol.q - it.q).norm() / step) < 1e-5, name
        assert float((st.cost[0, 0] - it.cost[0]).abs() / it.cost[0]) < 1e-12
        assert bool(it.accepted[0])


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    result = _run(tiny_cell(name), tiny_program())
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 0
    assert list(result)[-1] == "checks"


# The smallest sizes at which float32 shows: the hopper's four knots and
# three initial iterations leave its float32 steps inside the limits.
CONTROL_SIZE = {"hopper.replan": dict(steps=10, iters=10)}


@pytest.mark.parametrize("name", CELLS)
def test_control_fails(name):
    """The reference in float32 in the program's place is not correct."""
    cell = tiny_cell(name, **CONTROL_SIZE.get(name, {}))
    result = _run(cell, control.adapter("control", cell, tiny_program()))
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("name,fault", [
    ("cheetah.replan", "unchanged"), ("cheetah.replan", "altered"),
    ("cheetah.batch256", "unchanged"), ("cheetah.batch256", "half"),
    ("cheetah.batch256", "altered"), ("allegro.batch256", "half"),
    ("hopper.replan", "unchanged"), ("cheetah.replan", "radius"),
    ("hopper.replan", "radius"),
])
def test_fault_fails(name, fault):
    cell = tiny_cell(name, batch=4)
    result = _run(cell, control.adapter(fault, cell, tiny_program()))
    assert not result["correct"], (fault, result["checks"])


def test_run_fails_without_a_card_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this test needs a machine without a card")
    proc = subprocess.run(
        [sys.executable, os.path.join(BENCH_DIR, "run.py"), "--workload",
         "cheetah.replan", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_run_fails_with_only_the_benchmark_files(tmp_path):
    """A checkout that holds only BENCHMARK.json and the benchmark's own
    files has no program to drive."""
    import shutil

    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "cheetah.replan",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=tmp_path, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


@pytest.mark.cuda
def test_cell_on_the_card(cuda):
    """A short traced run of the cheapest cell on the card."""
    proc = subprocess.run(
        [sys.executable, os.path.join(BENCH_DIR, "run.py"), "--workload",
         "cheetah.replan", "--seed", "5", "--seconds", "3", "--trace", "1"],
        capture_output=True, text=True, cwd=ROOT, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    import json

    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["busy_s"] > 0
