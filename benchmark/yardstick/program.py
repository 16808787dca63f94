"""The benchmark's one door into the program under test, ``idto_tpu_torch``:
its example registry, its MPC step, its batch solve and its counters.

The model is built through the port's own registry at the YAML settings,
with the configuration's ``overrides`` put in their place; the
configuration as it is run is held against what the port read, so that a
changed YAML cannot change a cell unseen.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Loaded:
    model: object
    yaml_config: object
    prob: object
    params: object
    q_guess: object


def _same(a, b) -> bool:
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            _same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return (isinstance(b, (list, tuple)) and len(a) == len(b)
                and all(_same(x, y) for x, y in zip(a, b)))
    if isinstance(a, (bool, str)) or a is None:
        return a == b
    return float(a) == float(b)


def check_copy(config: dict, yaml_config) -> None:
    """Raise where the configuration's problem and solver values (the
    YAML's, with its overrides applied) differ from what the port read."""
    for group in ("problem", "solver"):
        for key, value in config[group].items():
            got = getattr(yaml_config, key)
            if not _same(value, got):
                raise ValueError(
                    f"{config['name']}: {group} value {key} is {got!r} in "
                    f"the YAML the port reads, {value!r} in the "
                    "benchmark's configuration file")


def load(config: dict, device) -> Loaded:
    """The configuration's example through the port's registry, with the
    configuration's ``overrides`` applied to the YAML it read."""
    import torch

    from idto_tpu_torch.examples.config import (
        build_initial_guess, build_problem, build_solver_params)
    from idto_tpu_torch.examples.registry import load_example

    if config["dtype"] != "float64":
        raise ValueError("the benchmark's configurations run in float64")
    out = Loaded(*load_example(config["example"], dtype=torch.float64,
                               device=device))
    overrides = config.get("overrides", {})
    if overrides:
        cfg = dataclasses.replace(out.yaml_config, **overrides)
        out = Loaded(out.model, cfg,
                     build_problem(cfg, out.model, dtype=torch.float64,
                                   device=device),
                     build_solver_params(cfg),
                     build_initial_guess(cfg, dtype=torch.float64,
                                         device=device))
    check_copy(config, out.yaml_config)
    return out


def relative_mask(loaded: Loaded) -> np.ndarray:
    rel = loaded.yaml_config.q_nom_relative_to_q_init
    return np.asarray(rel if rel is not None else [False] * loaded.model.nq,
                      dtype=bool)


def broadcast_problem(prob, batch):
    from idto_tpu_torch.parallel.batching import broadcast_problem as bp

    return bp(prob, batch)


def mpc_params(params, iters):
    from idto_tpu_torch.mpc.controller import make_mpc_params

    return make_mpc_params(params, iters)


def mpc_initialize(model, probs, params, q_guesses):
    from idto_tpu_torch.mpc.controller import mpc_initialize as init

    return init(model, probs, params, q_guesses)


def mpc_step(model, probs, params, rel, carry, x0, t_now):
    from idto_tpu_torch.mpc.controller import mpc_step as step

    return step(model, probs, params, rel, carry, x0, t_now)


def solve_batch(model, probs, params, q_guesses):
    from idto_tpu_torch.parallel.batching import solve_batch as solve

    return solve(model, probs, params, q_guesses)


def capture_seconds_by_region() -> dict:
    """{region: seconds of its warm-ups and captures} so far (the port's
    ``graphs.capture_seconds`` counter)."""
    from idto_tpu_torch.utils import graphs

    return dict(graphs.capture_seconds)


def captures() -> int:
    """Graphs captured so far (the port's ``graphs.captures`` counter)."""
    from idto_tpu_torch.utils import graphs

    return int(graphs.captures)


def release() -> None:
    """Free the captured graphs and their memory pools."""
    import torch

    from idto_tpu_torch.utils import graphs

    graphs.reset()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
