"""Scenario batching (counterpart of ``idto_tpu/parallel/batching.py``,
native path only).  Sharding across several cards is not ported yet."""
from __future__ import annotations

import dataclasses

import torch

from idto_tpu_torch.models.model import Model
from idto_tpu_torch.optimizer.problem import ProblemDefinition


def solve_batch(model: Model, probs: ProblemDefinition, params, q_guesses):
    """Batched solve: ``probs`` tensors lead with the scenario axis (see
    broadcast_problem); q_guesses is (B, T+1, nq).  Returns batched
    (Solution, Stats, WarmStart) from the batch-native trust-region solve,
    or from the linesearch when ``params.method`` is LINESEARCH (the JAX
    package's ``solve_batch`` runs the trust region for those too; its
    single-problem ``solve`` dispatches as this does)."""
    from idto_tpu_torch.optimizer.problem import SolverMethod

    if params.method == SolverMethod.LINESEARCH:
        from idto_tpu_torch.optimizer.linesearch import solve_linesearch

        return solve_linesearch(model, probs, params, q_guesses)
    from idto_tpu_torch.optimizer.batched import solve_trust_region_batched

    return solve_trust_region_batched(model, probs, params, q_guesses)


def broadcast_problem(prob: ProblemDefinition, batch: int) -> ProblemDefinition:
    """Tile a single problem across a scenario axis (views, no copies)."""
    return prob.replace(**{
        f.name: getattr(prob, f.name).expand(
            (batch,) + tuple(getattr(prob, f.name).shape)
        )
        for f in dataclasses.fields(prob)
        if isinstance(getattr(prob, f.name), torch.Tensor)
    })
