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
                 T=160 and T=640 (n=161 and n=641) in float64, timed.
  4. slice    -- the batched mini-cheetah Gauss-Newton trust-region solve
                 (cyclic reduction, float64, 3 iterations) through
                 ``solve_batch`` on the card; the kernel's launch count
                 over that run; the first scenarios against the same solve
                 run by the port on the CPU.
  5. times    -- one solve iteration at several batch sizes; the kernel,
                 the whole ``solve_many`` call, the plain version and a
                 dense library solve at the cheetah shape, with CUDA
                 events, beside the least time the card could take; the
                 kernel is held against the plain version at each batch
                 before it is timed.

The last two lines are a JSON object describing each kernel of the path,
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
# A solve iteration at a batch above this is timed over 2 calls: one takes
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


def check_kernel(gen, n, k, B, R, dtype, n_dense=None, timed=False):
    """One shape: kernel against plain (all systems) and dense (the first
    ``n_dense``); returns the largest abs difference from the plain one."""
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
    log("kernel", msg)
    if not (e_plain <= tol and e_dense <= tol):
        raise AssertionError(f"kernel disagrees ({name}, n={n}, k={k}, R={R})")
    return float((x - x_plain).abs().max())


def phase_kernel(gen):
    """Kernel against plain and dense at every shape; returns the largest
    float64 abs difference from the plain version at the cheetah shape."""
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
    return worst


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


def check_solution(sol, stats, tag):
    """Finite outputs, trust-region cost never increasing, few failures."""
    import torch

    from idto_tpu_torch.optimizer.solver import SolverFlag

    for name in ("q", "v", "tau"):
        if not bool(torch.isfinite(getattr(sol, name)).all()):
            raise AssertionError(f"{tag}: non-finite {name}")
    for name in ("cost", "rho", "delta", "dq_norm", "grad_norm"):
        if not bool(torch.isfinite(getattr(stats, name)).all()):
            raise AssertionError(f"{tag}: non-finite stats.{name}")
    cost = stats.cost
    if not bool((cost[:, 1:] <= cost[:, :-1] * (1 + 1e-12)).all()):
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
        n = reps if batch <= FEW_REPS_ABOVE else 2
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
    max_abs = phase_kernel(gen)
    launches = phase_slice(SLICE_BATCH, args.seed)
    times = phase_times(args.seed, REPS)

    print(smi, flush=True)
    print(json.dumps({"kernels": [{
        "name": "cr_solve",
        "route": "cuda",
        "source": "idto_tpu_torch/csrc/cr_solve.cu",
        "replaces": "idto_tpu/ops/cr_pallas.py:134",
        "launches": launches,
        "max_abs_err": max_abs,
        **times,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
