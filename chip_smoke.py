#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (``idto_tpu_torch``) once on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Phases, each printing its own lines; any failure raises, so the script then
exits non-zero without the final result line:

  1. device   -- a CUDA device is required; its name and power limit.
  2. build    -- compile the cyclic-reduction kernel (csrc/cr_solve.cu)
                 with nvcc from this checkout.
  3. kernel   -- the kernel against its plain PyTorch version and a dense
                 solve, on random SPD block-penta systems: the cheetah
                 shape (n=21 block rows of k=19) in float64 and float32
                 with 1 and 3 right-hand sides, at a small batch (a whole
                 block of warps a system) and at the slice's batch (the
                 launch the main path makes), a block size that takes
                 the kernel's run-time-K engine (k=5), and the horizons
                 T=160 and T=640 (n=161 and n=641) in float64, timed; the
                 shapes of the equality-constraint Schur solve (hopper,
                 spinner, airhockey: R = n_h + 1 right-hand sides in one
                 launch) in both types at B=1 and B=256, timed beside
                 their bound; and the hybrid solve (level-wise cyclic
                 reduction down to 64 super-rows, the kernel on the tail)
                 at T=640 against the fused kernel and the dense solve.
  4. slice    -- the batched mini-cheetah Gauss-Newton trust-region solve
                 (cyclic reduction, float64, 3 iterations) through
                 ``solve_batch`` on the card; the kernel's launch count
                 over that run; the first scenarios against the same solve
                 run by the port on the CPU.
  5. constraints -- the hopper at its YAML settings but for cyclic
                 reduction (float64, B=256, 3 iterations) through
                 ``solve_batch``: two kernel launches an iteration (the
                 Schur solve at R=121 and the Newton step), against the
                 port's CPU run and against the level-wise route
                 (``cr_use_pallas=False``, no launch).
  6. mpc      -- the mini-cheetah replan loop (``mpc_initialize`` with one
                 iteration, one warm replan, ten chained replans 0.016 s
                 apart): one launch a replan, the first replans against
                 the port's CPU run, the median replan time.
  7. times    -- one solve iteration at several batch sizes; the kernel,
                 the whole ``solve_many`` call, the plain version and a
                 dense library solve at the cheetah shape, with CUDA
                 events, beside the least time the card could take; the
                 kernel is held against the plain version at each batch
                 before it is timed.

The last two lines are a JSON object describing each kernel of the paths,
then ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import time

_REPO = os.path.dirname(os.path.abspath(__file__))

# Tolerances.  The kernel runs the plain version's arithmetic in another
# summation order, so float64 agrees to ~1e-15 relative on well-conditioned
# systems; 1e-9 leaves room for condition numbers up to ~1e6.  Float32
# cyclic reduction without pivoting loses a few digits more than LU: 5e-4.
KERNEL_RTOL = {"float64": 1e-9, "float32": 5e-4}
# The slice on the card against the port's CPU run: three trust-region
# iterations of the same float64 algorithm; only summation orders differ.
SLICE_RTOL = 1e-8
# Scenarios allowed to report FACTORIZATION_FAILED (a Newton step that
# failed the residual containment even after the Thomas rescue).
MAX_FAILED = 4
CHEETAH_N, CHEETAH_K = 21, 19
# Further shapes of the kernel phase: (n, k, batch).  k=5 gives blocks of 10,
# a size without a register-tile instantiation; n=161 and n=641 are the
# horizons T=160 and T=640 of the cheetah, at batches that leave room for
# the dense oracle.
RUNTIME_K_SHAPE = (21, 5, 64)
LONG_SHAPES = ((161, 19, 64), (641, 19, 16))
DENSE_SYSTEMS = 4  # systems of a long shape held against the dense solve
# The equality-constraint Schur solve's launches: (n, k, R) of the hopper,
# the spinner and the airhockey example (T = 40, R = n_h + 1), at these
# batches.
SCHUR_SHAPES = ((41, 5, 121), (41, 3, 41), (41, 6, 121))
SCHUR_BATCHES = (1, 256)
# The hybrid solve: (n, k, batch) and the rows left to the kernel.
HYBRID_SHAPE = (641, 19, 16)
HYBRID_TAIL_ROWS = 64
# The constrained solve through the level-wise route against the fused one:
# the same systems through block inverses by LU instead of Gauss-Jordan.
LEVELS_RTOL = 1e-8
# |quaternion| - 1 of the replanned base attitude: the cheetah's YAML does
# not renormalize inside the solve, and the drift grows with chained replans
# as the trust radius doubles (1.1e-2 at the eleventh on a CPU).
QUAT_TOL = 5e-2
# The replans on the card against the port's CPU run.  A warm-started replan
# takes a full Newton step of an ill-conditioned Hessian: on the CPU, cyclic
# reduction's plain version and Thomas, two float64 solvers of the same
# systems, differ by 4e-7 on q and 1.4e-6 on tau at the second replan, and
# the kernel differs from the plain version by as much.
MPC_RTOL = 1e-5
MPC_REPLANS = 10
MPC_DT = 0.016
# Peak rates of one H100 SXM (NVIDIA H100 data sheet): HBM3 bandwidth;
# float64 on the tensor cores and on the FMA pipes; float32 on the FMA
# pipes (the kernel uses no TF32).
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {
    8: {"tensor cores": 66.9e12, "FMA pipes": 33.5e12},
    4: {"FMA pipes": 66.9e12},
}
SLICE_BATCH = 256
KERNEL_BATCHES = (1, 256, 4096)
ITER_BATCHES = (1, 256, 4096)
REPS = 5  # timed calls per measurement
# A solve iteration at a batch above this is timed over 1 call: one takes
# seconds, and the script has a time limit to keep.
FEW_REPS_ABOVE = 256
# Device memory the timing phase may plan to use for one solve iteration.
MEMORY_BUDGET = 0.85


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def rel_err(x, ref):
    return float((x - ref).abs().max() / ref.abs().max().clamp_min(1e-300))


def cuda_time_ms(fn, reps):
    """Median over ``reps`` timed calls of fn after one warm-up call, each
    bracketed by CUDA events on the current stream."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def cr_work(batch, rows, K, R, itemsize):
    """(bytes, flops) of the block cyclic reduction of ``batch`` systems of
    ``rows`` real block rows of size K with R right-hand sides: each input
    read and each output written once (a block-tridiagonal system has no L
    in its first row and no U in its last: 3 rows - 2 blocks); one inverse
    (2 K^3) for each row, six products (2 K^3 each) for each reduced row
    with a row below it and four for one without, less the L' of a level's
    first reduced row and the U' of its last, which multiply nothing; and
    the matrix-vector products of the right-hand sides."""
    n_bytes = batch * ((3 * rows - 2) * K * K + 2 * R * rows * K) * itemsize
    products = matvecs = 0
    n = rows
    while n >= 1:
        n_od, n_ev = n // 2, n - n // 2
        with_below = n_od if n % 2 else max(n_od - 1, 0)
        products += 6 * with_below + 4 * (n_od - with_below)
        if n_od:
            # no L' for the first reduced row; no U' for the last, which a
            # last row without a row below it never had
            products -= 1 + (1 if with_below == n_od else 0)
        # reduced right-hand sides, then the even rows' back substitution
        matvecs += 2 * with_below + (n_od - with_below)
        matvecs += n_ev + (n_ev - 1) + n_od
        n = n_od
    flops = batch * (2 * K**3 * (rows + products) + 2 * K * K * R * matvecs)
    return n_bytes, flops


def cr_bound_ms(batch, rows, K, R, itemsize):
    """(ms, "bytes" or "operations"): the least time the card could take
    for cr_work, the larger of bytes over the memory rate and operations
    over the fastest peak rate of their type."""
    n_bytes, flops = cr_work(batch, rows, K, R, itemsize)
    t_bytes = n_bytes / PEAK_BYTES_PER_S
    t_flops = flops / max(PEAK_FLOPS[itemsize].values())
    if t_bytes >= t_flops:
        return 1e3 * t_bytes, "bytes"
    return 1e3 * t_flops, "operations"


def barrier_chain(rows):
    """Block-level barriers one system passes in the kernel: one after the
    level-0 inverses, one after each level's reductions, one after each
    level's back substitution."""
    levels = rows.bit_length()  # floor(log2 rows) + 1
    return 1 + (levels - 1) + levels


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port's main path needs one")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    # Dense float32 oracles in full float32 (no TF32).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    log("device", f"{name}; nvidia-smi: {smi}; torch {torch.__version__} "
                  f"CUDA {torch.version.cuda}")
    return name, smi


def phase_build():
    from idto_tpu_torch.ops import cr_kernel

    t0 = time.perf_counter()
    path = cr_kernel.build()
    log("build", f"{os.path.relpath(path, _REPO)} in "
                 f"{time.perf_counter() - t0:.2f} s")
    for line in cr_kernel.build.ptxas_log.splitlines():
        if "registers" in line or "spill" in line:
            log("build", line.strip())


def random_spd_penta(batch, n, k, dtype, gen):
    """Random symmetric, strictly diagonally dominant (so SPD) block-penta
    systems on the card."""
    import torch

    from idto_tpu_torch.ops import penta

    def blocks():
        return torch.randn((batch, n, k, k), generator=gen,
                           dtype=torch.float64, device="cuda")

    A, Bl, C = blocks(), blocks(), blocks()
    A[:, :2] = 0.0  # no block (i, i-2) for i < 2
    Bl[:, :1] = 0.0
    H = penta.make_symmetric_from_lower(A, Bl, C)
    # Largest absolute row sum of each system, from its five bands.
    rowsum = sum(X.abs().sum(-1) for X in (H.A, H.B, H.C, H.D, H.E))
    shift = rowsum.flatten(1).amax(1) + 1.0  # (batch,)
    eye = torch.eye(k, dtype=torch.float64, device="cuda")
    return H.replace(C=H.C + shift[:, None, None, None] * eye).to(dtype=dtype)


def dense_solve_inputs(H, rhs):
    """Dense float64 matrices (B, nk, nk) and right-hand sides (B, nk, R)."""
    import torch

    from idto_tpu_torch.ops import penta

    B, R = rhs.shape[:2]
    dense = penta.to_dense(H.to(dtype=torch.float64))
    b = rhs.to(torch.float64).reshape(B, R, -1).transpose(1, 2).contiguous()
    return dense, b


def check_kernel(gen, n, k, B, R, dtype, n_dense=None, timed=False,
                 yardsticks=False):
    """One shape: kernel against plain (all systems) and dense (the first
    ``n_dense``); returns the largest abs difference from the plain one, or
    with ``yardsticks`` a dict of that, the kernel's, the plain version's
    and a dense library solve's time and the bound."""
    import torch

    from idto_tpu_torch.ops import cr_kernel, penta

    name = str(dtype).split(".")[-1]
    tol = KERNEL_RTOL[name]
    H = random_spd_penta(B, n, k, dtype, gen)
    rhs = torch.randn((B, R, n, k), generator=gen, dtype=torch.float64,
                      device="cuda").to(dtype)
    x = cr_kernel.solve_many(H, rhs)
    torch.cuda.synchronize()
    x_plain = cr_kernel.solve_many_reference(H, rhs)
    nd = B if n_dense is None else min(B, n_dense)
    dense = penta.to_dense(
        H.replace(**{f: getattr(H, f)[:nd] for f in "ABCDE"}).to(
            dtype=torch.float64))
    b = rhs[:nd].to(torch.float64).reshape(nd, R, -1).transpose(1, 2)
    x_dense = torch.linalg.solve(dense, b).transpose(1, 2).reshape(
        rhs[:nd].shape)
    e_plain = rel_err(x.double(), x_plain.double())
    e_dense = rel_err(x[:nd].double(), x_dense)
    msg = (f"{name} n={n} k={k} B={B} R={R}: rel err vs plain "
           f"{e_plain:.3e}, vs dense ({nd} systems) {e_dense:.3e} "
           f"(tol {tol:g})")
    if timed:
        L, C, U, bp = cr_kernel._pack(H, rhs)
        ms = cuda_time_ms(
            lambda: cr_kernel.solve_tridiag_kernel(L, C, U, bp), REPS * 2)
        bound, by = cr_bound_ms(B, C.shape[1], C.shape[-1], R,
                                C.element_size())
        msg += (f"; kernel {ms:.4f} ms, bound {bound:.4f} ms ({by}), "
                f"{100 * bound / ms:.1f}% of bound")
    out = float((x - x_plain).abs().max())
    if yardsticks:
        # Yardsticks only: the plain version, and one library call that
        # solves the same systems as dense matrices (assembly not timed).
        p_ms = cuda_time_ms(
            lambda: cr_kernel.solve_tridiag_reference(L, C, U, bp), REPS)
        dense_all, b_all = dense_solve_inputs(H, rhs)
        lib_ms = cuda_time_ms(lambda: torch.linalg.solve(dense_all, b_all),
                              REPS)
        msg += f", plain {p_ms:.3f} ms, library dense solve {lib_ms:.3f} ms"
        out = {"max_abs_err": out, "ms": ms, "plain_ms": p_ms,
               "bound_ms": bound, "bound_by": by, "library_ms": lib_ms}
    log("kernel", msg)
    if not (e_plain <= tol and e_dense <= tol):
        raise AssertionError(f"kernel disagrees ({name}, n={n}, k={k}, R={R})")
    return out


def check_hybrid(gen):
    """The hybrid solve (level-wise to HYBRID_TAIL_ROWS rows, then the
    kernel) against the fused kernel and the dense solve; one launch a
    solve; both timed."""
    import torch

    from idto_tpu_torch.ops import cr_kernel, cyclic_reduction

    n, k, B = HYBRID_SHAPE
    tol = KERNEL_RTOL["float64"]
    H = random_spd_penta(B, n, k, torch.float64, gen)
    rhs = torch.randn((B, 1, n, k), generator=gen, dtype=torch.float64,
                      device="cuda")
    F = cyclic_reduction.factorize(H, tail_rows=HYBRID_TAIL_ROWS)
    before = cr_kernel.launches
    x = cyclic_reduction.solve_factorized(F, rhs)
    torch.cuda.synchronize()
    if cr_kernel.launches != before + 1:
        raise AssertionError("the hybrid solve did not launch the kernel once")
    x_fused = cr_kernel.solve_many(H, rhs)
    nd = DENSE_SYSTEMS
    dense, b = dense_solve_inputs(
        H.replace(**{f: getattr(H, f)[:nd] for f in "ABCDE"}), rhs[:nd])
    x_dense = torch.linalg.solve(dense, b).transpose(1, 2).reshape(
        rhs[:nd].shape)
    e_fused, e_dense = rel_err(x, x_fused), rel_err(x[:nd], x_dense)
    f_ms = cuda_time_ms(
        lambda: cyclic_reduction.factorize(H, tail_rows=HYBRID_TAIL_ROWS),
        REPS)
    s_ms = cuda_time_ms(lambda: cyclic_reduction.solve_factorized(F, rhs),
                        REPS)
    k_ms = cuda_time_ms(lambda: cr_kernel.solve_many(H, rhs), REPS)
    log("kernel", f"hybrid float64 n={n} k={k} B={B}: {len(F.levels)} levels "
                  f"then a kernel tail of {F.tail_LCU[1].shape[1]} rows; rel "
                  f"err vs fused {e_fused:.3e}, vs dense ({nd} systems) "
                  f"{e_dense:.3e} (tol {tol:g}); factorize {f_ms:.3f} ms, "
                  f"solve_factorized {s_ms:.3f} ms, fused solve_many "
                  f"{k_ms:.3f} ms")
    if not (e_fused <= tol and e_dense <= tol):
        raise AssertionError("the hybrid solve disagrees")


def phase_kernel(gen):
    """Kernel against plain and dense at every shape; returns the largest
    float64 abs difference from the plain version at the cheetah shape and
    the numbers of the hopper's Schur solve (float64, the constraints
    path's batch)."""
    import torch

    worst = 0.0
    for dtype in (torch.float64, torch.float32):
        for R in (1, 3):
            for B in (64, SLICE_BATCH):
                err = check_kernel(gen, CHEETAH_N, CHEETAH_K, B, R, dtype)
                if dtype == torch.float64:
                    worst = max(worst, err)
        n, k, B = RUNTIME_K_SHAPE
        check_kernel(gen, n, k, B, 3, dtype)
    for n, k, B in LONG_SHAPES:
        check_kernel(gen, n, k, B, 1, torch.float64, n_dense=DENSE_SYSTEMS,
                     timed=True)
        torch.cuda.empty_cache()
    schur = None
    for n, k, R in SCHUR_SHAPES:
        for dtype in (torch.float64, torch.float32):
            for B in SCHUR_BATCHES:
                main = (n, k, R) == SCHUR_SHAPES[0] and B == SLICE_BATCH \
                    and dtype == torch.float64
                out = check_kernel(gen, n, k, B, R, dtype,
                                   n_dense=DENSE_SYSTEMS, timed=True,
                                   yardsticks=main)
                if main:
                    schur = out
        torch.cuda.empty_cache()
    check_hybrid(gen)
    torch.cuda.empty_cache()
    return worst, schur


def cheetah_inputs(batch, seed, device):
    """mini_cheetah with CR in float64 for ``max_iterations=3``, and
    ``batch`` q guesses: the example's guess plus 0.01 N(0, 1) noise from
    ``seed``, q_0 pinned to q_init."""
    import numpy as np
    import torch

    from idto_tpu_torch.examples.registry import load_example
    from idto_tpu_torch.optimizer.problem import LinearSolverType

    model, _, prob, params, q_guess = load_example(
        "mini_cheetah", dtype=torch.float64, device=device)
    params = params.replace(
        linear_solver=LinearSolverType.CYCLIC_REDUCTION,
        check_convergence=False, max_iterations=3,
    )
    rng = np.random.default_rng(seed)
    qg = q_guess.cpu().numpy()[None] + 0.01 * rng.standard_normal(
        (batch,) + tuple(q_guess.shape))
    qg[:, 0] = prob.q_init.cpu().numpy()
    return model, prob, params, torch.as_tensor(qg, device=device)


def check_solution(sol, stats, tag, monotone=True):
    """Finite outputs, trust-region cost never increasing (without
    equality constraints: with them the merit decides, and its multipliers
    change every iteration), few failures."""
    import torch

    from idto_tpu_torch.optimizer.solver import SolverFlag

    for name in ("q", "v", "tau"):
        if not bool(torch.isfinite(getattr(sol, name)).all()):
            raise AssertionError(f"{tag}: non-finite {name}")
    for name in ("cost", "rho", "delta", "dq_norm", "grad_norm", "h_norm",
                 "merit"):
        if not bool(torch.isfinite(getattr(stats, name)).all()):
            raise AssertionError(f"{tag}: non-finite stats.{name}")
    cost = stats.cost
    if monotone and not bool(
            (cost[:, 1:] <= cost[:, :-1] * (1 + 1e-12)).all()):
        raise AssertionError(f"{tag}: cost increased across an iteration")
    failed = int((stats.solver_flag
                  == int(SolverFlag.FACTORIZATION_FAILED)).sum())
    if failed > MAX_FAILED:
        raise AssertionError(f"{tag}: {failed} scenarios failed")
    return failed


def phase_slice(batch, seed):
    import torch

    from idto_tpu_torch.ops import cr_kernel
    from idto_tpu_torch.parallel.batching import broadcast_problem, solve_batch

    model, prob, params, qg = cheetah_inputs(batch, seed, "cuda")
    probs = broadcast_problem(prob, batch)
    torch.cuda.reset_peak_memory_stats()
    cr_kernel.launches = 0
    t0 = time.perf_counter()
    sol, stats, _ = solve_batch(model, probs, params, qg)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = cr_kernel.launches
    peak = torch.cuda.max_memory_allocated() / 2**30
    if launches < params.max_iterations:
        raise AssertionError(f"kernel launched {launches} times in "
                             f"{params.max_iterations} iterations")
    failed = check_solution(sol, stats, "slice")
    cost = stats.cost
    log("slice", f"mini_cheetah B={batch} T={prob.num_steps} float64 CR, "
                 f"{params.max_iterations} iterations: {seconds:.2f} s "
                 f"(first call), peak {peak:.2f} GiB, kernel launches "
                 f"{launches}, FACTORIZATION_FAILED {failed}, mean cost "
                 f"{cost[:, 0].mean().item():.6e} -> "
                 f"{cost[:, -1].mean().item():.6e}")

    nref = 4
    model_c, prob_c, params_c, qg_c = cheetah_inputs(batch, seed, "cpu")
    qg_c = qg_c[:nref]
    t0 = time.perf_counter()
    sol_c, stats_c, _ = solve_batch(model_c, broadcast_problem(prob_c, nref),
                                    params_c, qg_c)
    log("slice", f"CPU reference B={nref}: {time.perf_counter() - t0:.2f} s")
    check_solution(sol_c, stats_c, "cpu reference")
    e_q = rel_err(sol.q[:nref].cpu(), sol_c.q)
    e_cost = rel_err(stats.cost[:nref].cpu(), stats_c.cost)
    e_rho = float((stats.rho[:nref].cpu() - stats_c.rho).abs().max())
    same_flags = torch.equal(stats.solver_flag[:nref].cpu(),
                             stats_c.solver_flag)
    log("slice", f"card vs CPU, first {nref} scenarios: q {e_q:.3e}, "
                 f"cost {e_cost:.3e}, rho (abs) {e_rho:.3e}, flags "
                 f"{'equal' if same_flags else 'DIFFER'} (tol {SLICE_RTOL:g})")
    if not (e_q <= SLICE_RTOL and e_cost <= SLICE_RTOL
            and e_rho <= SLICE_RTOL and same_flags):
        raise AssertionError("slice on the card disagrees with the CPU run")
    return launches


def hopper_inputs(batch, seed, device, cr_use_pallas=None):
    """hopper at its YAML settings (equality constraints, T=40) but for
    cyclic reduction and ``max_iterations=3``, float64, and ``batch`` q
    guesses: the example's guess plus 0.01 N(0, 1) noise from ``seed``, q_0
    pinned to q_init."""
    import numpy as np
    import torch

    from idto_tpu_torch.examples.registry import load_example
    from idto_tpu_torch.optimizer.problem import LinearSolverType

    model, _, prob, params, q_guess = load_example(
        "hopper", dtype=torch.float64, device=device)
    params = params.replace(
        linear_solver=LinearSolverType.CYCLIC_REDUCTION, max_iterations=3,
        cr_use_pallas=cr_use_pallas,
    )
    rng = np.random.default_rng(seed)
    qg = q_guess.cpu().numpy()[None] + 0.01 * rng.standard_normal(
        (batch,) + tuple(q_guess.shape))
    qg[:, 0] = prob.q_init.cpu().numpy()
    return model, prob, params, torch.as_tensor(qg, device=device)


def phase_constraints(batch, seed):
    """The constrained hopper solve on the card; returns its launches."""
    import torch

    from idto_tpu_torch.ops import cr_kernel
    from idto_tpu_torch.parallel.batching import broadcast_problem, solve_batch

    model, prob, params, qg = hopper_inputs(batch, seed, "cuda")
    probs = broadcast_problem(prob, batch)
    n_h = prob.num_steps * len(model.unactuated_vdofs)
    cr_kernel.launches = 0
    t0 = time.perf_counter()
    sol, stats, _ = solve_batch(model, probs, params, qg)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = cr_kernel.launches
    if launches != 2 * params.max_iterations:
        raise AssertionError(f"kernel launched {launches} times in "
                             f"{params.max_iterations} iterations (the Schur "
                             f"solve and the Newton step make 2 each)")
    failed = check_solution(sol, stats, "constraints", monotone=False)
    ms = cuda_time_ms(
        lambda: solve_batch(model, probs, params.replace(max_iterations=1),
                            qg), REPS)
    log("constraints", f"hopper B={batch} T={prob.num_steps} float64 CR, "
                       f"R={n_h + 1} right-hand sides, "
                       f"{params.max_iterations} iterations: {seconds:.2f} s "
                       f"(first call), kernel launches {launches}, "
                       f"FACTORIZATION_FAILED {failed}, mean h_norm "
                       f"{stats.h_norm[:, 0].mean().item():.6e} -> "
                       f"{stats.h_norm[:, -1].mean().item():.6e}; one "
                       f"iteration {ms:.3f} ms median of {REPS}")

    def compare(tag, other, other_stats, nref, tol):
        errs = {
            "q": rel_err(sol.q[:nref].cpu(), other.q.cpu()),
            "cost": rel_err(stats.cost[:nref].cpu(), other_stats.cost.cpu()),
            "h_norm": rel_err(stats.h_norm[:nref].cpu(),
                              other_stats.h_norm.cpu()),
            "rho (abs)": float((stats.rho[:nref].cpu()
                                - other_stats.rho.cpu()).abs().max()),
        }
        same = torch.equal(stats.solver_flag[:nref].cpu(),
                           other_stats.solver_flag.cpu())
        log("constraints", f"{tag}, first {nref} scenarios: " + ", ".join(
            f"{k} {v:.3e}" for k, v in errs.items())
            + f", flags {'equal' if same else 'DIFFER'} (tol {tol:g})")
        if not (same and all(v <= tol for v in errs.values())):
            raise AssertionError(f"constraints: {tag} disagrees")

    # The level-wise route: the same solve with no kernel launch.
    cr_kernel.launches = 0
    sol_l, stats_l, _ = solve_batch(
        model, probs, params.replace(cr_use_pallas=False), qg)
    torch.cuda.synchronize()
    if cr_kernel.launches != 0:
        raise AssertionError("the level-wise route launched the kernel")
    compare("fused vs level-wise route (cr_use_pallas=False, 0 launches)",
            sol_l, stats_l, batch, LEVELS_RTOL)

    nref = 4
    model_c, prob_c, params_c, qg_c = hopper_inputs(batch, seed, "cpu")
    sol_c, stats_c, _ = solve_batch(model_c, broadcast_problem(prob_c, nref),
                                    params_c, qg_c[:nref])
    check_solution(sol_c, stats_c, "cpu reference", monotone=False)
    compare("card vs CPU", sol_c, stats_c, nref, SLICE_RTOL)
    return launches


def replan_setup(device):
    """The mini-cheetah replan loop as the reference's bench sets it up
    (float64, cyclic reduction, one iteration a solve, every replan from the
    initial state estimate): returns (carry, replan) after
    ``mpc_initialize``, where ``replan(carry, i)`` is the replan at
    t = i MPC_DT and returns (carry, solution)."""
    import numpy as np
    import torch

    from idto_tpu_torch.examples.registry import load_example
    from idto_tpu_torch.mpc import controller as mpc
    from idto_tpu_torch.optimizer.problem import LinearSolverType
    from idto_tpu_torch.parallel.batching import broadcast_problem

    model, cfg, prob, params, q_guess = load_example(
        "mini_cheetah", dtype=torch.float64, device=device)
    params = params.replace(
        linear_solver=LinearSolverType.CYCLIC_REDUCTION, max_iterations=1,
        check_convergence=False)
    mpc_params = mpc.make_mpc_params(params, 1)
    rel = np.asarray(cfg.q_nom_relative_to_q_init)
    probs = broadcast_problem(prob, 1)
    carry, _ = mpc.mpc_initialize(model, probs, params, q_guess[None])
    x0 = torch.cat([prob.q_init, prob.v_init])[None]

    def replan(carry, i):
        return mpc.mpc_step(model, probs, mpc_params, rel, carry, x0,
                            MPC_DT * i)

    return carry, replan


def run_replans(device, n_replans, timed=False):
    """One warm replan at t = 0, then ``n_replans`` chained replans MPC_DT
    apart.  Returns the replans' solutions, their host-clock times in ms
    (around a synchronize, when ``timed``) and the kernel launches each
    made."""
    import torch

    from idto_tpu_torch.ops import cr_kernel

    carry, replan = replan_setup(device)
    sols, times, launches = [], [], []
    for i in range(n_replans + 1):
        before = cr_kernel.launches
        if timed:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        carry, sol = replan(carry, i)
        if timed:
            torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        launches.append(cr_kernel.launches - before)
        sols.append(sol)
    return sols, times, launches


def phase_mpc():
    """The replan loop on the card; returns (launches, mpc_replan_ms)."""
    import torch

    from idto_tpu_torch.ops import cr_kernel

    cr_kernel.launches = 0
    sols, times, launches = run_replans("cuda", MPC_REPLANS, timed=True)
    total = cr_kernel.launches
    if any(n != 1 for n in launches):
        raise AssertionError(f"launches per replan {launches}: expected 1")
    worst_quat = 0.0
    for sol in sols:
        if not bool(torch.isfinite(sol.q).all()
                    and torch.isfinite(sol.tau).all()):
            raise AssertionError("mpc: non-finite replan")
        worst_quat = max(worst_quat, float(
            (sol.q[..., :4].norm(dim=-1) - 1).abs().max()))
    if worst_quat > QUAT_TOL:
        raise AssertionError(f"mpc: base quaternion off unit by {worst_quat}")
    replan_ms = statistics.median(times[1:])
    log("mpc", f"mini_cheetah B=1 float64 CR: initialize, a warm replan "
               f"({times[0]:.1f} ms) and {MPC_REPLANS} chained replans, "
               f"{total} kernel launches (1 a solve), |quat| - 1 <= "
               f"{worst_quat:.2e}; mpc_replan_ms {replan_ms:.3f} median, "
               f"{min(times[1:]):.3f} min, {max(times[1:]):.3f} max")
    nref = 2
    sols_c, _, _ = run_replans("cpu", nref - 1)
    e_q = max(rel_err(a.q.cpu(), b.q) for a, b in zip(sols, sols_c))
    e_tau = max(rel_err(a.tau.cpu(), b.tau) for a, b in zip(sols, sols_c))
    log("mpc", f"card vs CPU, first {nref} replans: q {e_q:.3e}, tau "
               f"{e_tau:.3e} (tol {MPC_RTOL:g})")
    if not (e_q <= MPC_RTOL and e_tau <= MPC_RTOL):
        raise AssertionError("replans on the card disagree with the CPU run")
    return total, replan_ms


def phase_times(seed, reps):
    """Solve-iteration and kernel times; returns the kernel's numbers at
    the main path's batch for the result line."""
    import torch

    from idto_tpu_torch.ops import cr_kernel
    from idto_tpu_torch.parallel.batching import broadcast_problem, solve_batch

    total = torch.cuda.mem_get_info()[1]
    peak_per_scenario = None
    for batch in ITER_BATCHES:
        if peak_per_scenario is not None:
            need = peak_per_scenario * batch
            if need > MEMORY_BUDGET * total:
                log("times", f"iteration B={batch}: not run, predicted peak "
                             f"{need / 2**30:.1f} GiB of {total / 2**30:.1f}")
                continue
        model, prob, params, qg = cheetah_inputs(batch, seed, "cuda")
        params = params.replace(max_iterations=1)
        probs = broadcast_problem(prob, batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        n = reps if batch <= FEW_REPS_ABOVE else 1
        ms = cuda_time_ms(lambda: solve_batch(model, probs, params, qg), n)
        peak = torch.cuda.max_memory_allocated()
        if batch > 1:
            peak_per_scenario = (peak - base) / batch
        log("times", f"iteration B={batch}: {ms:.3f} ms median of {n} "
                     f"(solve_batch, max_iterations=1), peak "
                     f"{peak / 2**30:.3f} GiB")
        del model, prob, params, qg, probs
        torch.cuda.empty_cache()

    from idto_tpu_torch.ops import penta

    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    at_main = None
    for batch in KERNEL_BATCHES:
        H = random_spd_penta(batch, CHEETAH_N, CHEETAH_K, torch.float64, gen)
        rhs = torch.randn((batch, 1, CHEETAH_N, CHEETAH_K), generator=gen,
                          dtype=torch.float64, device="cuda")
        L, C, U, b = cr_kernel._pack(H, rhs)
        rows, K = C.shape[1], C.shape[-1]
        # The launch shape follows the batch, so each batch timed is first
        # held against the plain version.
        err = rel_err(cr_kernel.solve_tridiag_kernel(L, C, U, b),
                      cr_kernel.solve_tridiag_reference(L, C, U, b))
        if not err <= KERNEL_RTOL["float64"]:
            raise AssertionError(f"kernel disagrees at B={batch}: rel err "
                                 f"{err:.3e} vs plain")
        k_ms = cuda_time_ms(
            lambda: cr_kernel.solve_tridiag_kernel(L, C, U, b), reps * 4)
        p_ms = cuda_time_ms(
            lambda: cr_kernel.solve_tridiag_reference(L, C, U, b), reps * 4)
        k2_ms = cuda_time_ms(
            lambda: cr_kernel.solve_tridiag_kernel(L, C, U, b), reps * 4)
        path_ms = cuda_time_ms(lambda: cr_kernel.solve_many(H, rhs), reps * 4)
        # Yardstick only, never on the port's path: one library call that
        # solves the same systems as dense 399 x 399 matrices (dense work,
        # ~50x the flops of the banded solve); the assembly is not timed.
        dense = penta.to_dense(H)
        bd = rhs.reshape(batch, 1, -1).transpose(1, 2).contiguous()
        lib_ms = cuda_time_ms(lambda: torch.linalg.solve(dense, bd), reps)
        del dense, bd
        n_bytes, flops = cr_work(batch, rows, K, 1, C.element_size())
        bound, by = cr_bound_ms(batch, rows, K, 1, C.element_size())
        best = min(k_ms, k2_ms)
        if batch == 1:
            share = (f"no roofline binds one system: {barrier_chain(rows)} "
                     f"block barriers in its chain")
        else:
            share = f"{100 * bound / best:.1f}% of bound"
        rates = ", ".join(
            f"{1e3 * flops / r:.4f} ms at {r / 1e12:g} TFLOP/s ({name})"
            for name, r in PEAK_FLOPS[C.element_size()].items())
        log("times", f"CR solve float64 B={batch} (rows={rows}, K={K}, R=1): "
                     f"kernel {k_ms:.4f} / {k2_ms:.4f} ms, path (solve_many) "
                     f"{path_ms:.4f} ms, plain {p_ms:.4f} ms, library dense "
                     f"solve {lib_ms:.4f} ms (median of {reps * 4}; library "
                     f"{reps}); rel err vs plain {err:.3e}")
        log("times", f"  bound {bound:.4f} ms ({by}): "
                     f"{n_bytes / 1e6:.3f} MB is "
                     f"{1e3 * n_bytes / PEAK_BYTES_PER_S:.4f} ms at 3.35 TB/s; "
                     f"{flops / 1e9:.4f} GFLOP is {rates}; {share}")
        if batch == SLICE_BATCH:
            at_main = {"ms": best, "plain_ms": p_ms, "path_ms": path_ms,
                       "library_ms": lib_ms, "bound_ms": bound,
                       "bound_by": by}
        del H, rhs, L, C, U, b
        torch.cuda.empty_cache()
    return at_main


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random systems and q guesses")
    args = ap.parse_args(argv)

    name, smi = phase_device()
    import torch

    phase_build()
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    max_abs, schur = phase_kernel(gen)
    by_path = {"cheetah_slice": phase_slice(SLICE_BATCH, args.seed)}
    by_path["hopper_constraints"] = phase_constraints(SLICE_BATCH, args.seed)
    by_path["mpc_replan"], replan_ms = phase_mpc()
    times = phase_times(args.seed, REPS)

    print(smi, flush=True)
    print(json.dumps({"kernels": [{
        "name": "cr_solve",
        "route": "cuda",
        "source": "idto_tpu_torch/csrc/cr_solve.cu",
        "replaces": "idto_tpu/ops/cr_pallas.py:134",
        "launches": sum(by_path.values()),
        "launches_by_path": by_path,
        "max_abs_err": max_abs,
        **times,
        # The hopper's Schur solve (rows=21, K=10, R=121, float64, B=256).
        "schur_r121": schur,
        "mpc_replan_ms": replan_ms,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
