"""Object API in the style of the reference's ``pyidto`` Python bindings
(counterpart of ``idto_tpu/api.py``): ``TrajectoryOptimizer`` with Solve /
CreateWarmStart / SolveFromWarmStart / ResetInitialConditions /
UpdateNominalTrajectory, and a mutable ``WarmStart`` exposing q, Delta, dq
and dqH.

The functional core (``optimizer.solver``) stays stateless; this wrapper
keeps the problem between calls.  Everything runs on the device of the
model's tensors; arrays passed in (numpy or tensors) are moved there.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from idto_tpu_torch.models.model import Model
from idto_tpu_torch.optimizer import solver as _solver
from idto_tpu_torch.optimizer.problem import ProblemDefinition, SolverParameters


class WarmStart:
    """Mutable warm-start handle: set_q / get_q, Delta, and after each
    solve the final dogleg step dq and the final unscaled Newton step dqH
    (host arrays)."""

    def __init__(self, q, Delta):
        self.q = q
        self.Delta = float(Delta)
        self.dq = np.zeros(tuple(q.shape))
        self.dqH = np.zeros(tuple(q.shape))

    def set_q(self, q):
        self.q = torch.as_tensor(np.asarray(q) if not isinstance(
            q, torch.Tensor) else q, dtype=self.q.dtype, device=self.q.device)

    def get_q(self):
        return self.q.detach().cpu().numpy()


class TrajectoryOptimizer:
    def __init__(
        self,
        model: Model,
        prob: ProblemDefinition,
        params: Optional[SolverParameters] = None,
    ):
        self.model = model
        self._dtype = model.mass.dtype
        self._device = model.mass.device
        self._prob = prob.to(device=self._device, dtype=self._dtype)
        self._params = params or SolverParameters()

    def _tensor(self, x):
        if isinstance(x, torch.Tensor):
            return x.to(device=self._device, dtype=self._dtype)
        return torch.as_tensor(np.asarray(x, dtype=np.float64),
                               dtype=self._dtype, device=self._device)

    # -- accessors of the reference bindings --
    @property
    def prob(self) -> ProblemDefinition:
        return self._prob

    @property
    def params(self) -> SolverParameters:
        return self._params

    def time_step(self) -> float:
        return self._prob.dt

    def num_steps(self) -> int:
        return self._prob.num_steps

    # -- solving --
    def Solve(self, q_guess):
        """Solve from scratch (trust region, or linesearch when the
        parameters say so); q_guess (T+1, nq).  Returns (Solution, Stats)."""
        sol, stats, _ = _solver.solve(self.model, self._prob, self._params,
                                      self._tensor(q_guess))
        return sol, stats

    def CreateWarmStart(self, q_guess) -> WarmStart:
        return WarmStart(self._tensor(q_guess), self._params.Delta0)

    def SolveFromWarmStart(self, warm_start: WarmStart):
        """Resume the trust-region solve from ``warm_start`` and update it
        in place.  Returns (Solution, Stats)."""
        warm = _solver.WarmStart(
            q=self._tensor(warm_start.q),
            Delta=torch.tensor(warm_start.Delta, dtype=self._dtype,
                               device=self._device),
            dq=None, dqH=None,
        )
        sol, stats, ws = _solver.solve_from_warm_start(
            self.model, self._prob, self._params, warm)
        warm_start.q = ws.q
        warm_start.Delta = float(ws.Delta)
        warm_start.dq = ws.dq.cpu().numpy()
        warm_start.dqH = ws.dqH.cpu().numpy()
        return sol, stats

    def ResetInitialConditions(self, q0, v0) -> None:
        self._prob = self._prob.replace(q_init=self._tensor(q0),
                                        v_init=self._tensor(v0))

    def UpdateNominalTrajectory(self, q_nom, v_nom) -> None:
        self._prob = self._prob.replace(q_nom=self._tensor(q_nom),
                                        v_nom=self._tensor(v_nom))
