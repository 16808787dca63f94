"""Scenario batching and sharding across ranks (counterpart of
``idto_tpu/parallel/batching.py``).

  * ``solve_batch``: the batch-native solve over a leading scenario axis;
    each scenario carries its own trust radius and accept/reject path.
    ``native=False`` solves the scenarios one at a time on the per-problem
    reference instead.
  * ``solve_batch_sharded``: the scenario axis split over one axis of a
    ``DeviceMesh`` (a process group, ``make_mesh``).  Every rank holds the
    whole batch, as JAX's logical global array does, solves its contiguous
    share with ``solve_batch`` (the CUDA kernel inside, as on one card), and
    gathers the results back to the whole batch; the solves are independent,
    and the only other collective is one summed cost.  PyTorch has no
    partitioner: what ``shard_map`` does, this does by hand.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from idto_tpu_torch.models.model import Model
from idto_tpu_torch.optimizer.problem import ProblemDefinition
from idto_tpu_torch.parallel import multihost


def solve_batch(model: Model, probs: ProblemDefinition, params, q_guesses,
                native: Optional[bool] = None):
    """Batched solve: ``probs`` tensors lead with the scenario axis (see
    broadcast_problem) or are shared; q_guesses is (B, T+1, nq).  Returns
    batched (Solution, Stats, WarmStart).

    ``native=None`` takes the batch-native solve wherever
    ``can_solve_batched_native`` says it serves the configuration (every
    one but a model with a halfspace-halfspace pair).  That is the
    trust region, or the linesearch when ``params.method`` is LINESEARCH
    (the JAX package's batch-native route runs the trust region for those
    too; its single-problem ``solve`` dispatches as this does).
    ``native=False`` runs the per-problem reference,
    ``solver.solve_trust_region``, one scenario after another, and stacks
    the results: the trust region whatever ``params.method`` says, as in
    the JAX package."""
    from idto_tpu_torch.optimizer.batched import can_solve_batched_native
    from idto_tpu_torch.optimizer.problem import SolverMethod

    if native is None:
        native = can_solve_batched_native(model, params)
    if not native:
        from idto_tpu_torch.optimizer.solver import solve_trust_region

        outs = [solve_trust_region(
            model, map_scenarios(lambda x, b=b: x[b], probs), params,
            q_guesses[b]) for b in range(q_guesses.shape[0])]
        return tuple(_stack_rows([o[i] for o in outs]) for i in range(3))
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


# Dimensions of each ProblemDefinition tensor without a scenario axis.
_UNBATCHED_NDIM = {"q_init": 1, "v_init": 1, "q_nom": 2, "v_nom": 2,
                   "Qq": 1, "Qv": 1, "R": 1, "Qf_q": 1, "Qf_v": 1}


def map_scenarios(fn, probs: ProblemDefinition) -> ProblemDefinition:
    """``probs`` with ``fn`` applied to each field that leads with a
    scenario axis; shared fields stay as they are."""
    return probs.replace(**{
        name: fn(getattr(probs, name))
        for name, ndim in _UNBATCHED_NDIM.items()
        if getattr(probs, name) is not None
        and getattr(probs, name).ndim > ndim
    })


def make_mesh(n_devices: Optional[int] = None, axis: str = "scenario",
              device="cuda", backend: Optional[str] = None):
    """A one-axis ``DeviceMesh`` named ``axis`` over every rank of the
    default process group (``multihost.initialize``; a process alone gets a
    group of one).  The backend follows ``device``: NCCL for ``cuda``,
    gloo for ``cpu``, gloo for CUDA tensors when the group was made so.
    JAX takes the first ``n_devices`` of its devices; a ``DeviceMesh``
    spans its whole default group, so ``n_devices`` is the world size."""
    from torch.distributed.device_mesh import init_device_mesh

    world = multihost.default_group(device, backend)
    n = world if n_devices is None else n_devices
    if n != world:
        raise ValueError(f"a mesh of {n} ranks in a group of {world}: a "
                         "DeviceMesh spans every rank of the default group")
    return init_device_mesh(torch.device(device).type, (n,),
                            mesh_dim_names=(axis,))


def _stack_rows(xs):
    """Unbatched Solutions, Stats or WarmStarts stacked on a new scenario
    axis."""
    return xs[0].replace(**{
        f.name: torch.stack([getattr(x, f.name) for x in xs])
        for f in dataclasses.fields(xs[0])
        if isinstance(getattr(xs[0], f.name), torch.Tensor)
    })


def _gather_rows(x, ax):
    """A batched Solution / Stats / WarmStart with every rank's rows."""
    return x.replace(**{
        f.name: ax.gather(getattr(x, f.name)) for f in dataclasses.fields(x)
        if isinstance(getattr(x, f.name), torch.Tensor)
    })


def solve_batch_sharded(model: Model, probs: ProblemDefinition, params,
                        q_guesses, mesh, axis: str = "scenario"):
    """Data-parallel batched solve over the mesh axis ``axis``.

    The batch must divide the axis.  Each rank solves its contiguous share;
    returns the whole batch's (Solution, Stats, WarmStart) on every rank and
    the mean final cost over all scenarios (each scenario's cost at its last
    iteration, summed over the axis by all_reduce)."""
    import torch.distributed as dist

    ax = multihost.axis_group(mesh, axis)
    B = q_guesses.shape[0]
    rows = ax.rows(B)
    sol, stats, warm = solve_batch(
        model, map_scenarios(lambda x: x[rows], probs), params,
        q_guesses[rows])
    iters = torch.clamp_min(stats.num_iters.to(torch.int64) - 1, 0)
    total = torch.gather(stats.cost, 1, iters[:, None]).sum()
    dist.all_reduce(total, group=ax.group)
    return (*(_gather_rows(x, ax) for x in (sol, stats, warm)), total / B)
