"""The port's penta-diagonal solves across horizons: Thomas, the level-wise
cyclic reduction and the fused CUDA kernel (counterpart of
``scripts/bench_linsolve.py``).

    python3 scripts/bench_torch_linsolve.py [--device {cuda,cpu}]
        [--seed 0] [--out BENCH_TORCH_LINSOLVE.json]

Random SPD block penta-diagonal systems with blocks of k=19 (the
cheetah's nq; the reference's construction, H = L L^T + 0.1 I with L block
lower-triangular of bandwidth two), horizons T = 20, 40, 160, 640 (n = T + 1
block rows) at batches 1, 64 and 256, in float64 (the bench's dtype) and
float32.  Each route factors and solves one right-hand side, as the solver
does once an iteration:

  * ``thomas``: ``penta.solve`` (the YAML's pentadiagonal_lu);
  * ``cr_levels``: ``cyclic_reduction.solve`` (level by level, no kernel);
  * ``cr_kernel``: ``cr_kernel.solve_many`` (one launch of the CUDA kernel,
    the solver's route for ``cyclic_reduction`` up to 64 super-rows);
  * ``cr_hybrid``: ``cyclic_reduction.factorize(H, tail_rows=64)`` then
    ``solve_factorized`` (levels down to 64 super-rows, the kernel on the
    tail), the solver's route past 64 super-rows, timed only there.

Times are medians of 10 calls, each bracketed by CUDA events, after one
warm call; beside them the kernel's bound (``chip_smoke.cr_bound_ms``: the
bytes over the memory rate or the operations over the peak rate, whichever
is longer) and each route's error against the float64 Thomas solution.
The JSON file names the card and its power limit.
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
from chip_smoke import cr_bound_ms
from idto_tpu_torch.ops import cr_kernel, cyclic_reduction, penta
from idto_tpu_torch.utils import timing

K = 19
HORIZONS = (20, 40, 160, 640)
BATCHES = (1, 64, 256)
DTYPES = {"float64": torch.float64, "float32": torch.float32}
TAIL_ROWS = 64
REPS = 10


def spd_penta_batch(batch, n, k, rng, dtype, device):
    """``batch`` SPD penta systems L L^T + 0.1 I, L's row i holding random
    blocks (A_i, B_i, C_i) at columns i-2, i-1, i and C_i shifted by
    3 sqrt(k) I."""
    def t(x):
        return torch.as_tensor(x, dtype=torch.float64, device=device)

    A = rng.standard_normal((batch, n, k, k))
    B = rng.standard_normal((batch, n, k, k))
    C = rng.standard_normal((batch, n, k, k)) + 3 * np.sqrt(k) * np.eye(k)
    A[:, :2] = 0
    B[:, :1] = 0
    A, B, C = t(A), t(B), t(C)

    def shifted(X, s):  # row i holds X's row i - s, zeros above
        return torch.cat([torch.zeros_like(X[:, :s]), X[:, :-s]], dim=1)

    tr = lambda X: X.transpose(-1, -2)  # noqa: E731
    eye = torch.eye(k, dtype=torch.float64, device=device)
    C_ = A @ tr(A) + B @ tr(B) + C @ tr(C) + 0.1 * eye
    B_ = A @ tr(shifted(B, 1)) + B @ tr(shifted(C, 1))  # block (i, i-1)
    A_ = A @ tr(shifted(C, 2))                           # block (i, i-2)
    return penta.make_symmetric_from_lower(A_, B_, C_).to(dtype=dtype)


def hybrid_solve(H, b):
    F = cyclic_reduction.factorize(H, tail_rows=TAIL_ROWS)
    return cyclic_reduction.solve_factorized(F, b)


ROUTES = {
    "thomas": penta.solve,
    "cr_levels": cyclic_reduction.solve,
    "cr_kernel": lambda H, b: cr_kernel.solve_many(H, b[:, None])[:, 0],
    "cr_hybrid": hybrid_solve,
}


def routes_for(n):
    """The routes timed at n block rows: the hybrid only where the
    solver takes it, past TAIL_ROWS super-rows."""
    m = (n + 1) // 2
    return [r for r in ROUTES if r != "cr_hybrid" or m > TAIL_ROWS]


def rel_err(x, ref):
    return float((x.to(torch.float64) - ref).abs().max()
                 / ref.abs().max().clamp_min(1e-300))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=os.path.join(
        _REPO, "BENCH_TORCH_LINSOLVE.json"))
    args = ap.parse_args(argv)
    name, watts, smi = card(args.device)
    rng = np.random.default_rng(args.seed)
    rows = []
    for T in HORIZONS:
        n = T + 1
        for batch in BATCHES:
            H64 = spd_penta_batch(batch, n, K, rng, torch.float64,
                                  args.device)
            b64 = torch.as_tensor(rng.standard_normal((batch, n, K)),
                                  device=args.device)
            x_ref = penta.solve(H64, b64)
            for dname, dtype in DTYPES.items():
                H, b = H64.to(dtype=dtype), b64.to(dtype)
                bound, by = cr_bound_ms(batch, (n + 1) // 2, 2 * K, 1,
                                        b.element_size())
                row = {"T": T, "batch": batch, "k": K, "dtype": dname,
                       "kernel_bound_ms": bound, "kernel_bound_by": by}
                for route in routes_for(n):
                    fn = ROUTES[route]
                    x = fn(H, b)
                    if not bool(torch.isfinite(x).all()):
                        raise RuntimeError(f"{route} T={T} B={batch} "
                                           f"{dname}: non-finite solution")
                    row[f"{route}_ms"] = 1e3 * timing.time_fn(
                        fn, [(H, b)], reps=REPS, device=args.device)
                    row[f"{route}_relerr_vs_thomas_f64"] = rel_err(x, x_ref)
                rows.append(row)
                print(json.dumps(row), flush=True)
            del H64, b64, x_ref
    result = {"device": name, "power_limit_w": watts, "nvidia_smi": smi,
              "seed": args.seed, "reps": REPS, "results": rows}
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
