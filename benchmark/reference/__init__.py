"""The plain reference the benchmark holds the port against: float64 (or,
for the control, float32) plain PyTorch, built from the configuration file
and its URDF copy under the benchmark.  It imports nothing of the program
and takes nothing the program made but the outputs it judges and, where
it follows a chain of operations, the state the operation started from.
"""
from __future__ import annotations

import torch

from reference import model as _model
from reference import mpc as _mpc
from reference import solver as _solver


class Reference:
    def __init__(self, config: dict, device, dtype=torch.float64):
        self.device, self.dtype = device, dtype
        self.model = _model.build(config, device, dtype)
        self.base = _mpc.base_problem(self.model, config)
        self.solver = {**config["solver_defaults"], **config["solver"]}
        if self.solver["method"] != "trust_region":
            raise ValueError("the reference follows the trust-region method "
                             f"only, not {self.solver['method']!r}")
        for s in self.model.floating_q_starts:
            if self.base["rel"][s:s + 4].any():
                raise ValueError("a relative quaternion nominal is not in "
                                 "the reference")

    def tensor(self, x):
        return torch.as_tensor(x, device=self.device).to(self.dtype)

    def iterate(self, q, q_init, v_init, q_nom, Delta,
                cond_out=None) -> _solver.Iteration:
        """One trust-region iteration of S problems that differ in their
        initial state and nominal; every argument leads with S.
        ``cond_out`` as in ``solver.iterate``."""
        P = _mpc.batch(self.base, q_init, v_init, q_nom, self.device,
                       self.dtype)
        return _solver.iterate(self.model, self.solver, P, self.tensor(q),
                               self.tensor(Delta), cond_out)

    def warm_guess(self, prev_q, elapsed, q0):
        return _mpc.warm_guess(self.tensor(prev_q), self.tensor(elapsed),
                               self.tensor(q0), self.base["dt"])

    def shifted_nominal(self, q0):
        return _mpc.shifted_nominal(self.base, self.tensor(q0), self.device,
                                    self.dtype)

    def control(self, tau):
        """The first control of each plan: tau_0 on the actuated DoFs."""
        return tau[:, 0] @ self.model.B
