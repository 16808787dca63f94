"""Multi-process scaling layer on ``torch.distributed`` (counterpart of
``idto_tpu/parallel/multihost.py``).

A JAX mesh axis is a process group here.  Each process (rank) drives one
card, or shares one: ``initialize`` wires the processes into one default
group, ``make_global_mesh`` lays them out as a (scenario, horizon)
``DeviceMesh`` with the horizon innermost -- consecutive ranks, the
NVLink-joined cards of one host, carry the distributed cyclic reduction's
halos -- and ``solve_batch_global`` shards the scenario axis, whose only
collectives are the gathered results and one summed cost.

The backend follows the device the caller names: NCCL for ``cuda``, gloo
for ``cpu``, and gloo with CUDA tensors only when the caller asks for it
(``backend="gloo"`` with ``device="cuda"``): that is how two ranks share one
card, since NCCL refuses two ranks on one GPU.  Nothing switches the
backend silently: a mesh on a device that the group's backend does not
serve raises.

Usage on each process (torchrun sets MASTER_ADDR, MASTER_PORT, WORLD_SIZE,
RANK and LOCAL_RANK):

    from idto_tpu_torch.parallel import multihost
    multihost.initialize()                   # False, a no-op, when alone
    mesh = multihost.make_global_mesh(sp=4)  # (scenario, horizon)
    sol, stats, warm, mean_cost = multihost.solve_batch_global(
        model, probs, params, q_guesses, mesh)

A process alone gets a group of one, so the same code runs on one card and
on many.
"""
from __future__ import annotations

import os
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

SCENARIO_AXIS = "scenario"
HORIZON_AXIS = "horizon"


def backend_for(device, backend: Optional[str] = None) -> str:
    """The process-group backend for tensors on ``device``: NCCL for CUDA,
    gloo for the CPU; ``backend="gloo"`` keeps gloo for CUDA tensors."""
    kind = torch.device(device).type
    if backend is None:
        return "nccl" if kind == "cuda" else "gloo"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown backend {backend!r}: nccl or gloo")
    if backend == "nccl" and kind != "cuda":
        raise ValueError(f"NCCL takes CUDA tensors only, not {kind}")
    return backend


def _check_backend(device, backend):
    """Raise unless the default group's backend serves ``device`` (gloo
    serves both; NCCL CUDA only) and is ``backend`` when one is named."""
    have = dist.get_backend()
    kind = torch.device(device).type
    if (backend is not None and backend != have) or (
            kind != "cuda" and have == "nccl"):
        raise ValueError(f"the default group runs {have}, not "
                         f"{backend or 'gloo'} for {kind} tensors")


def default_group(device="cuda", backend: Optional[str] = None) -> int:
    """World size of the default group; a process that has none gets a group
    of one (an in-memory store, no network)."""
    if not dist.is_initialized():
        dist.init_process_group(backend_for(device, backend),
                                store=dist.HashStore(), rank=0, world_size=1)
    _check_backend(device, backend)
    return dist.get_world_size()


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device="cuda",
    backend: Optional[str] = None,
) -> bool:
    """Wire this process into the default process group
    (``torch.distributed.init_process_group``).  The arguments default from
    torchrun's environment: MASTER_ADDR and MASTER_PORT, WORLD_SIZE, RANK.
    ``coordinator_address`` is ``host:port`` (TCP) or a URL such as
    ``file:///path`` or ``tcp://host:port``.  Returns True for a group of
    more than one process, False for the single-process no-op (no address
    and no world size given or in the environment).

    The JAX package also autodetects a Cloud-TPU pod from its metadata
    server; a card has no such service, so that branch has no counterpart.
    """
    env = os.environ
    if coordinator_address is None and env.get("MASTER_ADDR") \
            and env.get("MASTER_PORT"):
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if num_processes is None and env.get("WORLD_SIZE"):
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and env.get("RANK"):
        process_id = int(env["RANK"])
    if coordinator_address is None and num_processes is None:
        return False
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError("a process group needs an address, a world size "
                         "and a rank")
    if dist.is_initialized():
        _check_backend(device, backend)
        return dist.get_world_size() > 1
    if torch.device(device).type == "cuda":
        local = int(env.get("LOCAL_RANK", process_id))
        torch.cuda.set_device(local % torch.cuda.device_count())
    url = (coordinator_address if "://" in coordinator_address
           else f"tcp://{coordinator_address}")
    dist.init_process_group(backend_for(device, backend), init_method=url,
                            world_size=num_processes, rank=process_id)
    return dist.get_world_size() > 1


def mesh_shape(world: int, sp: int, local: int) -> tuple:
    """(scenario, horizon) sizes of ``world`` ranks with horizon groups of
    ``sp``: ``sp`` must divide the world, and nest within a host's
    ``local`` ranks or span whole hosts, so the halo exchanges stay on a
    host's links."""
    if sp < 1 or world % sp:
        raise ValueError(f"{world} ranks not divisible by sp={sp}")
    if sp > 1 and local % sp and sp % local:
        raise ValueError(f"sp={sp} must nest within a host's {local} local "
                         "ranks (or span whole hosts)")
    return world // sp, sp


def make_global_mesh(sp: int = 1, device="cuda",
                     backend: Optional[str] = None):
    """A (scenario, horizon) ``DeviceMesh`` over every rank of the default
    group: ``sp`` consecutive ranks for each horizon group (sequence
    parallelism for the distributed cyclic reduction), the remaining factor
    the scenario axis (``mesh_shape``; a host's ranks are LOCAL_WORLD_SIZE,
    which torchrun sets, or else all of them)."""
    from torch.distributed.device_mesh import init_device_mesh

    world = default_group(device, backend)
    shape = mesh_shape(world, sp,
                       int(os.environ.get("LOCAL_WORLD_SIZE", world)))
    return init_device_mesh(torch.device(device).type, shape,
                            mesh_dim_names=(SCENARIO_AXIS, HORIZON_AXIS))


class AxisGroup(NamedTuple):
    """One mesh axis as seen from this rank."""

    group: object  # the axis's process group
    size: int
    index: int  # this rank's coordinate along the axis

    def rows(self, batch: int) -> slice:
        """This rank's contiguous share of a leading axis of ``batch``."""
        if batch % self.size:
            raise ValueError(f"batch {batch} does not divide the mesh "
                             f"({self.size})")
        share = batch // self.size
        return slice(self.index * share, (self.index + 1) * share)

    def gather(self, x, dim=0):
        """Every rank's ``x`` (equal shapes), concatenated along ``dim`` in
        the axis's order."""
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x.contiguous(), group=self.group)
        return torch.cat(parts, dim=dim)


def axis_group(mesh, axis: str) -> AxisGroup:
    if axis not in (mesh.mesh_dim_names or ()):
        raise ValueError(f"the mesh has no axis {axis!r}: "
                         f"{mesh.mesh_dim_names}")
    dim = mesh.mesh_dim_names.index(axis)
    return AxisGroup(mesh.get_group(dim), mesh.size(dim),
                     mesh.get_local_rank(dim))


def scenario_sharding(mesh) -> AxisGroup:
    """The mesh's scenario axis: a leading scenario axis is split into
    contiguous shares over it (``AxisGroup.rows``), replicated along the
    horizon."""
    return axis_group(mesh, SCENARIO_AXIS)


def shard_scenarios_from_local(mesh, tree):
    """The global scenario batch from each rank's local scenarios: a
    tensor, numpy array or ``ProblemDefinition`` (its fields that lead with
    a scenario axis) of B_local scenarios becomes, on every rank, the batch
    of all ranks' scenarios in the order of the mesh's scenario axis (each
    rank's its rows of the global batch).  The ranks of one horizon group
    pass the same local scenarios."""
    from idto_tpu_torch.parallel.batching import map_scenarios

    sharding = scenario_sharding(mesh)
    device = mesh.device_type

    def make(x):
        t = x if isinstance(x, torch.Tensor) else torch.as_tensor(
            np.asarray(x))
        return sharding.gather(t.to(device))

    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return make(tree)
    return map_scenarios(make, tree)


def solve_batch_global(model, probs, params, q_guesses, mesh):
    """Scenario-data-parallel solve over a (possibly multi-host) mesh.

    probs/q_guesses are the global batch (tensors, e.g. from
    ``shard_scenarios_from_local``), or with q_guesses a numpy array each
    rank's local scenarios, gathered first.  Returns (Solution, Stats,
    WarmStart, mean_cost) with mean_cost summed over every scenario of every
    rank."""
    from idto_tpu_torch.parallel.batching import solve_batch_sharded

    if isinstance(q_guesses, np.ndarray):
        probs = shard_scenarios_from_local(mesh, probs)
        q_guesses = shard_scenarios_from_local(mesh, q_guesses)
    return solve_batch_sharded(model, probs, params, q_guesses, mesh,
                               axis=SCENARIO_AXIS)
