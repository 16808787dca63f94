"""``BENCHMARK.json`` and the files it names, found by name.

A cell names a configuration and a traffic mix; each is a JSON file of its
own (``configs/<config>.json`` through the manifest's ``file``,
``traffic/<traffic>.json``), and the cell's correctness limits are
``limits/<cell>.json``.  A configuration file holds a copy of its YAML's
problem and solver values and may add ``overrides``: values of those
groups that the cell runs in place of the YAML's (a linear solver, a
method), applied here, so that the program, the traffic and the reference
all read the configuration as it is run.  Every metric, end-to-end or per-layer, is a reader
``metrics/<metric name>.py``.  A later cell, mix or metric is one more
file and one more entry: no file here changes.
"""
from __future__ import annotations

import copy
import dataclasses
import importlib.util
import json
import os
import re

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _load_json(path):
    with open(path) as f:
        return json.load(f)


GROUPS = ("problem", "solver")


def applied(config: dict) -> dict:
    """The configuration as it is run: its copy of the YAML's problem and
    solver values with its ``overrides`` put in their place."""
    out = copy.deepcopy(config)
    for key, value in config.get("overrides", {}).items():
        group = next((g for g in GROUPS if key in config[g]), None)
        if group is None:
            raise ValueError(f"{config['name']}: override {key!r} is no "
                             "problem or solver value of the configuration")
        out[group][key] = value
    return out


@dataclasses.dataclass(frozen=True)
class Metric:
    name: str
    unit: str
    end_to_end: bool
    moves: str | None
    workloads: tuple | None


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    config_name: str
    traffic_name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: tuple  # Metric, reported with --trace 0
    per_layer: tuple  # Metric, reported with --trace 1


class Manifest:
    """The parsed ``BENCHMARK.json`` of a checkout."""

    def __init__(self, root: str = ROOT):
        self.root = root
        self.data = _load_json(os.path.join(root, "BENCHMARK.json"))
        self.configs = {c["name"]: c for c in self.data["configs"]}
        self.workloads = {w["name"]: w for w in self.data["workloads"]}
        self.metrics = [self._metric(m, True) for m in self.data["end_to_end"]]
        self.metrics += [self._metric(m, False)
                         for m in self.data["per_layer"]]

    @staticmethod
    def _metric(m, e2e):
        return Metric(
            name=m["name"], unit=m["unit"], end_to_end=e2e,
            moves=m.get("moves"),
            workloads=tuple(m["workloads"]) if "workloads" in m else None)

    def path(self, rel: str) -> str:
        return os.path.join(self.root, rel)

    def _reports(self, metric: Metric, cell: str) -> bool:
        if metric.workloads is not None:
            return cell in metric.workloads
        if metric.end_to_end:
            return True
        moved = next(m for m in self.metrics if m.name == metric.moves)
        return self._reports(moved, cell)

    def cell(self, name: str) -> Cell:
        if name not in self.workloads:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                           f"(have {sorted(self.workloads)})")
        w = self.workloads[name]
        conf = self.configs[w["config"]]
        return Cell(
            name=name,
            config_name=w["config"],
            traffic_name=w["traffic"],
            chips=int(w["chips"]),
            config=applied(_load_json(self.path(conf["file"]))),
            traffic=_load_json(os.path.join(
                BENCH_DIR, "traffic", f"{w['traffic']}.json")),
            limits=_load_json(os.path.join(BENCH_DIR, "limits",
                                           f"{name}.json")),
            end_to_end=tuple(m for m in self.metrics
                             if m.end_to_end and self._reports(m, name)),
            per_layer=tuple(m for m in self.metrics
                            if not m.end_to_end and self._reports(m, name)),
        )


def reader(metric_name: str):
    """The ``read(ctx)`` function of ``metrics/<metric_name>.py``."""
    path = os.path.join(BENCH_DIR, "metrics", f"{metric_name}.py")
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + metric_name.replace(".", "_").replace("-", "_"),
        path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
