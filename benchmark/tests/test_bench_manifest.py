"""The manifest keeps to the benchmark's contract, and every file a cell
needs is found by its name."""
from __future__ import annotations

import json
import os

import pytest

from conftest import BENCH_DIR, ROOT
from yardstick import manifest

DATA = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
M = manifest.Manifest(ROOT)


def _names():
    yield from (c["name"] for c in DATA["configs"])
    yield from (w["name"] for w in DATA["workloads"])
    yield from (w["config"] for w in DATA["workloads"])
    yield from (w["traffic"] for w in DATA["workloads"])
    yield from (m["name"] for m in DATA["end_to_end"] + DATA["per_layer"])
    for c in DATA["configs"]:
        yield from c["reduced"]


def test_keys_and_sizes():
    assert set(DATA) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(DATA)) < 64 * 1024
    assert 1 <= DATA["run_seconds"] <= 51
    assert DATA["paths"] == ["benchmark"]
    assert all(w["chips"] in (1, 4) for w in DATA["workloads"])
    assert len({(w["config"], w["traffic"]) for w in DATA["workloads"]}) \
        == len(DATA["workloads"])


@pytest.mark.parametrize("name", sorted(set(_names())))
def test_name_characters(name):
    assert manifest.NAME_RE.match(name), name


@pytest.mark.parametrize("metric", DATA["end_to_end"] + DATA["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_entry(metric):
    assert manifest.UNIT_RE.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    allowed = {"name", "unit", "better", "source", "workloads"}
    if metric in DATA["end_to_end"]:
        allowed |= {"bound"}
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        allowed |= {"layer", "moves"}
        assert metric["moves"] in {m["name"] for m in DATA["end_to_end"]}
        assert "\n" not in metric["layer"] and len(metric["layer"]) <= 200
    assert set(metric) <= allowed
    assert os.path.exists(os.path.join(BENCH_DIR, "metrics",
                                       f"{metric['name']}.py"))


@pytest.mark.parametrize("cell", [w["name"] for w in DATA["workloads"]])
def test_cell_files_found_by_name(cell):
    c = M.cell(cell)
    assert c.config["name"] == c.config_name
    assert c.traffic["kind"] in ("replan", "batch")
    assert set(c.limits) == ({"step_gap", "control_gap", "radius_gap"}
                             if c.traffic["kind"] == "replan"
                             else {"step_gap_cond", "cost_gap"})
    names = {m.name for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer
    for m in c.end_to_end + c.per_layer:
        assert callable(manifest.reader(m.name))


def test_configs_copy_the_yaml():
    """Each configuration file's problem and solver values equal the YAML
    the port reads."""
    yaml = pytest.importorskip("yaml")
    for conf in DATA["configs"]:
        c = json.load(open(os.path.join(ROOT, conf["file"])))
        raw = yaml.safe_load(open(os.path.join(ROOT, c["yaml"])))
        for group in ("problem", "solver"):
            for key, value in c[group].items():
                got = raw[key]
                if isinstance(value, list):
                    assert [float(x) for x in value] == \
                        [float(x) for x in got], key
                elif isinstance(value, dict):
                    assert {k: float(v) for k, v in value.items()} == \
                        {k: float(v) for k, v in got.items()}, key
                elif isinstance(value, str):
                    assert value == got, key
                else:
                    assert float(value) == float(got), key
        assert c["source"] == conf["source"]
        assert conf["reduced"] == []


def test_overrides_reach_the_program_and_the_reference():
    """A configuration's ``overrides`` replace the YAML's values for the
    port, the traffic and the reference alike; the rest is still held
    against the YAML, and an override of a value the file does not copy
    is refused."""
    from reference import Reference
    from yardstick import program

    c = json.load(open(os.path.join(BENCH_DIR, "configs",
                                    "mini_cheetah.json")))
    c["overrides"] = {"linear_solver": "cyclic_reduction",
                      "controller_frequency": 30}
    run = manifest.applied(c)
    assert run["solver"]["linear_solver"] == "cyclic_reduction"
    assert run["solver"]["controller_frequency"] == 30
    assert c["solver"]["linear_solver"] == "pentadiagonal_lu"
    loaded = program.load(run, "cpu")
    assert loaded.params.linear_solver.value == "cyclic_reduction"
    assert loaded.yaml_config.controller_frequency == 30
    assert Reference(run, "cpu").solver["linear_solver"] == \
        "cyclic_reduction"
    c["overrides"] = {"no_such_value": 1}
    with pytest.raises(ValueError):
        manifest.applied(c)
    stale = manifest.applied(json.load(open(os.path.join(
        BENCH_DIR, "configs", "mini_cheetah.json"))))
    stale["solver"]["contact_stiffness"] = 1
    with pytest.raises(ValueError):
        program.load(stale, "cpu")
    c["overrides"] = {"method": "linesearch"}
    with pytest.raises(ValueError):
        Reference(manifest.applied(c), "cpu")
