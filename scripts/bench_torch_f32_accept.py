"""Numerical acceptance of the port's penta-diagonal solvers on real
Hessians, in float32 and float64 (counterpart of
``scripts/bench_f32_accept.py``).

    python3 scripts/bench_torch_f32_accept.py [--device {cuda,cpu}]
        [--seed 0] [--out BENCH_TORCH_F32_ACCEPT.json]

On the scaled Gauss-Newton system (H~, g~) the solver factors at three
iterates each of mini_cheetah and spinner (the example's guess, the guess
plus 0.01 N(0, 1) from ``default_rng(seed)``, and the result of a
4-iteration solve from the guess), each of the Thomas solve
(``ops/penta.py``), the level-wise cyclic reduction
(``ops/cyclic_reduction.py``) and the fused kernel (``ops/cr_kernel.py``:
the CUDA kernel on the card) solves H~ x = -g~ in float32 and in float64.
For each it records

  * ``relres``: ||H~ x + g~|| / ||g~|| in the solve's dtype, the statistic
    the solver's per-scenario containment holds against
    ``containment_rtol`` (0.25 in float32, 1e-6 in float64);
  * ``relerr``: ||x - x*|| / ||x*|| against x*, a float64 dense solve
    refined with residuals in extended precision;
  * the same two after one step of refinement with the same factor,
    x1 = x0 + solve(r0), r0 = -g~ - H~ x0 formed in float64 and rounded to
    the dtype (arithmetic of this script only: the package has no
    refinement).

The JSON file names the card and its power limit, holds every case and a
summary: per solver and dtype the worst relres and the share of cases
that pass the containment, and the worst Thomas relres (the solver's
backstop, healthy) against each dtype's ``containment_rtol``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

import numpy as np
import torch

from bench_torch import card
from idto_tpu_torch.examples.registry import load_example
from idto_tpu_torch.ops import cr_kernel, cyclic_reduction, penta
from idto_tpu_torch.optimizer.hessian import (
    gauss_newton_hessian,
    gradient_from_partials,
)
from idto_tpu_torch.optimizer.partials import id_partials_for, nplus_stack
from idto_tpu_torch.optimizer.solver import (
    _scale_factors_from_diag,
    containment_rtol,
    solve,
)
from idto_tpu_torch.parallel.batching import broadcast_problem
from idto_tpu_torch.soa import rollout

EXAMPLES = ("mini_cheetah", "spinner")
SOLVE_ITERATIONS = 4
REFINEMENTS = 3  # of the dense reference solution
PERTURBATION = 1e-15  # relative size of perturbed_bands' rounding
PERTURBED_COPIES = 8  # rounding-level copies of a system (the tests)
DTYPES = {"float32": torch.float32, "float64": torch.float64}


def scaled_system(model, prob, params, q):
    """(H~, g~) the solver factors at iterate q (T+1, nq) on its first
    iteration (D from the Hessian's diagonal, the previous D all ones):
    bands (1, n, k, k) and (1, n, k)."""
    probs = broadcast_problem(prob, 1)
    qs = q[None]
    tau, v = rollout.generalized_forces(model, probs, params.contact, qs)
    parts = id_partials_for(model, probs, params, qs)
    nplus = nplus_stack(model, qs)
    g = gradient_from_partials(model, probs, parts, nplus, qs, v, tau)
    H = gauss_newton_hessian(model, probs, parts, nplus)
    D = _scale_factors_from_diag(penta.extract_diagonal(H),
                                 params.scaling_method, torch.ones_like(qs))
    return penta.scale_by_diagonal(H, D), D * g


def iterates(name, rng, device):
    """The example (model, prob, params) and its three iterates (numpy):
    the guess, the guess plus 0.01 N(0, 1) from ``rng``, a 4-iteration
    solve."""
    model, _, prob, params, q_guess = load_example(name, device=device)
    params = params.replace(max_iterations=SOLVE_ITERATIONS,
                            check_convergence=False)
    sol, _, _ = solve(model, prob, params, q_guess)
    q0 = q_guess.cpu().numpy()
    qs = [q0, q0 + 0.01 * rng.standard_normal(q0.shape), sol.q.cpu().numpy()]
    return model, prob, params, qs


def factored_solvers():
    """name -> (factor(H), apply(factor, b)): b (B, n, k)."""
    return {
        "thomas": (penta.factorize, penta.solve_factorized),
        "cr": (cyclic_reduction.factorize, cyclic_reduction.solve_factorized),
        # One fused launch factors and solves: its "factor" is H itself.
        "cr_kernel": (lambda H: H,
                      lambda H, b: cr_kernel.solve_many(H, b[:, None])[:, 0]),
    }


def _norm(x):
    return float(torch.linalg.vector_norm(x.to(torch.float64)))


def dense_solution(Hs, gs, refinements=REFINEMENTS):
    """x* of H~ x = -g~ for bands (1, n, k, k): a float64 dense LU solve,
    refined with residuals formed in numpy's extended precision
    (``np.longdouble``), so that x* is good to about float64 rounding even
    at the cheetah's condition (~1e10), where a dense solve alone is off
    by ~1e-7 and any two dense solves differ by as much."""
    Hd = penta.to_dense(Hs.to(dtype=torch.float64))[0].cpu().numpy()
    b = -gs.to(torch.float64).reshape(-1).cpu().numpy()
    x = np.linalg.solve(Hd, b)
    H_ext, b_ext = Hd.astype(np.longdouble), b.astype(np.longdouble)
    for _ in range(refinements):
        r = b_ext - H_ext @ x.astype(np.longdouble)
        x = x + np.linalg.solve(Hd, r.astype(np.float64))
    return torch.as_tensor(x, device=gs.device).reshape(gs.shape)


def perturbed_bands(bands, rng, rel=PERTURBATION):
    """Numpy bands {A..E} of a symmetric system with every entry of its
    lower bands (A, B and C's lower triangle) scaled by 1 + rel N(0, 1) from
    ``rng``, then made symmetric again: a copy of the system within its
    rounding, on which a solver's error shows its spread."""
    A, B, C = (bands[x] * (1 + rel * rng.standard_normal(bands[x].shape))
               for x in "ABC")
    C = np.tril(C) + np.swapaxes(np.tril(C, -1), -1, -2)
    D, E = np.zeros_like(B), np.zeros_like(A)
    D[..., :-1, :, :] = np.swapaxes(B[..., 1:, :, :], -1, -2)
    E[..., :-2, :, :] = np.swapaxes(A[..., 2:, :, :], -1, -2)
    return {"A": A, "B": B, "C": C, "D": D, "E": E}


def measure(Hs, gs, x_star):
    """Every solver in every dtype on one system: {column: number}."""
    row = {}
    H64, g64 = Hs.to(dtype=torch.float64), gs.to(torch.float64)
    g_norm = _norm(g64)
    x_norm = _norm(x_star)
    for dname, dtype in DTYPES.items():
        H, g = Hs.to(dtype=dtype), gs.to(dtype)
        for sname, (factor, apply) in factored_solvers().items():
            F = factor(H)
            x = apply(F, -g)
            for tag, xx in (("", x), ("_refined", None)):
                if xx is None:
                    r0 = (-g64 - penta.matvec(H64, x.to(torch.float64)))
                    xx = x + apply(F, r0.to(dtype))
                res = penta.matvec(H, xx) + g
                key = f"{sname}_{dname}{tag}"
                row[f"{key}_relres"] = _norm(res) / max(g_norm, 1e-300)
                row[f"{key}_relerr"] = (_norm(xx.to(torch.float64) - x_star)
                                        / max(x_norm, 1e-300))
    return row


def summarize(cases):
    out = {"max_relres": {}, "containment_pass_share": {},
           "containment_rtol": {}}
    for dname, dtype in DTYPES.items():
        rtol = containment_rtol(dtype)
        out["containment_rtol"][dname] = rtol
        for sname in factored_solvers():
            for tag in ("", "_refined"):
                key = f"{sname}_{dname}{tag}"
                vals = [c[f"{key}_relres"] for c in cases]
                out["max_relres"][key] = max(vals)
                out["containment_pass_share"][key] = (
                    sum(v < rtol for v in vals) / len(vals))
        worst = out["max_relres"][f"thomas_{dname}"]
        out[f"max_healthy_relres_{dname}"] = worst
        out[f"headroom_{dname}"] = rtol / max(worst, 1e-300)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=os.path.join(
        _REPO, "BENCH_TORCH_F32_ACCEPT.json"))
    args = ap.parse_args(argv)
    name, watts, smi = card(args.device)
    rng = np.random.default_rng(args.seed)
    cases = []
    for example in EXAMPLES:
        model, prob, params, qs = iterates(example, rng, args.device)
        for it, q in enumerate(qs):
            Hs, gs = scaled_system(
                model, prob, params,
                torch.as_tensor(q, dtype=torch.float64, device=args.device))
            row = {"example": example, "iterate": it,
                   "T": int(prob.num_steps), "nq": int(model.nq),
                   **measure(Hs, gs, dense_solution(Hs, gs))}
            cases.append(row)
            print(json.dumps(row), flush=True)
    result = {"device": name, "power_limit_w": watts, "nvidia_smi": smi,
              "seed": args.seed, "cases": cases, **summarize(cases)}
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps({k: v for k, v in result.items() if k != "cases"}))
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
