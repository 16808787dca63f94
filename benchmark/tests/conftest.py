"""Shared pieces of the benchmark's own tests (run with
``python -m pytest benchmark/tests``; ``pytest tests/`` does not collect
them).  The tests drive the harness on the CPU at a small size: each
configuration at a short horizon and few iterations, through the port's
own problem-building functions, so that the program and the reference see the same
shrunken problem."""
from __future__ import annotations

import copy
import dataclasses
import os
import sys
import types

import pytest
import torch

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
for p in (BENCH_DIR, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)

from yardstick import manifest, program  # noqa: E402

TINY_STEPS = 4
TINY_ITERS = 3


def tiny_cell(name, batch=3, steps=TINY_STEPS, iters=TINY_ITERS):
    """The cell at ``steps`` knots, ``iters`` initial iterations and a
    batch of ``batch``, with the cell's own limits."""
    cell = manifest.Manifest(ROOT).cell(name)
    config = copy.deepcopy(cell.config)
    config["problem"]["num_steps"] = steps
    config["solver"]["max_iters"] = iters
    t = dict(cell.traffic)
    if t["kind"] == "batch":
        t.update(batch=batch, check_scenarios=2, check_calls=3, warm_calls=1)
    else:
        t.update(warm_replans=1, check_replans=4, settle_s=0)
    return dataclasses.replace(cell, config=config, traffic=t)


def tiny_program(base=program):
    """The program adapter with ``load`` building the shrunken problem
    through the port's own problem-building functions."""

    def load(config, device):
        from idto_tpu_torch.examples.config import (
            build_initial_guess, build_problem, build_solver_params)

        loaded = base.load(_as_yaml(config), device)
        cfg = dataclasses.replace(
            loaded.yaml_config, num_steps=config["problem"]["num_steps"],
            max_iters=config["solver"]["max_iters"])
        return program.Loaded(
            loaded.model, cfg,
            build_problem(cfg, loaded.model, device=device),
            build_solver_params(cfg),
            build_initial_guess(cfg, device=device))

    prog = types.SimpleNamespace(**{k: getattr(base, k) for k in dir(base)
                                    if not k.startswith("_")})
    prog.load = load
    return prog


def _as_yaml(config):
    """The configuration with the YAML's own sizes, for the copy check."""
    c = copy.deepcopy(config)
    src = manifest.Manifest(ROOT).configs[c["name"]]["file"]
    full = manifest._load_json(os.path.join(ROOT, src))
    c["problem"]["num_steps"] = full["problem"]["num_steps"]
    c["solver"]["max_iters"] = full["solver"]["max_iters"]
    return c


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda():
    """Skips a test that needs the card where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
