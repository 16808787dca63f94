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
                 at T=640 against the fused kernel and the dense solve;
                 and the Schur solves of the manipulation examples (kuka,
                 jaco and jaco_ball K=28, dual_jaco and punyo K=42,
                 allegro_hand K=46; R = 241, or 61 at T=10) in both types
                 at B=1 and at the fleet path's batch, timed beside bound,
                 plain version and a dense library solve; the Newton-step
                 launches (R = 1) of the same examples, dual_jaco's only
                 launch among them, and the closed loops' two launches at
                 B=1, likewise.
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
  7. fleet    -- kuka, jaco, jaco_ball, dual_jaco, allegro_hand and punyo,
                 each at its YAML settings and full size but for cyclic
                 reduction (float64, a small batch, two iterations) through
                 ``solve_batch``: two launches an iteration under equality
                 constraints (one for dual_jaco, which has none), the cost
                 not above the initial cost, against the port's CPU run.
  8. closed_loop -- ``run_mpc`` on the hopper (equality constraints,
                 ground contact, PD gains and feed-forward) at its YAML
                 horizon, rates and step, the initial solve cut to two
                 iterations and ``sim_time`` to ten replans: two launches a
                 replan, finite logs, the loop against the port's CPU run;
                 the mean replan and the mean simulated period.  Then
                 ``run_mpc`` on jaco with the stiffer simulation contact of
                 ``load_sim_plant`` for two replans: its YAML gains are
                 unstable under the explicit simulator (in the JAX package
                 too), so the first six substeps are held against the CPU
                 run one by one, the first replan period must stay finite,
                 and the loop must turn non-finite at the substep where the
                 CPU run does.
  9. options  -- the solver options, the object API and the velocity
                 command, in float64, each held against the port's own CPU
                 run of the same inputs: (a) ``TrajectoryOptimizer`` on the
                 cheetah at its YAML size with cyclic reduction, ``Solve``
                 of 3 iterations then ``SolveFromWarmStart`` of 1 (4
                 launches); (b) the velocity-command MPC on the cheetah,
                 ``mpc_initialize`` and 5 replans at 60 Hz, each followed
                 by 17 simulated substeps, the command changing at replans
                 2 and 4 (1 launch a replan); (c) central-difference
                 partials on the cheetah at B=8, 2 iterations (2 launches),
                 against the AUTODIFF run; (d) Armijo on the cheetah and
                 backtracking on the constrained hopper (no launch); (e)
                 ``DENSE_LDLT`` on the cheetah and the exact Hessian on the
                 spinner (no launch); (f) ``verbose``,
                 ``debug_compare_against_dense`` and
                 ``record_iteration_times`` on the cheetah at B=1 (1 launch
                 an iteration).  Informational times: an API iteration, a
                 replan, an FD iteration of each order against AUTODIFF, a
                 linesearch and a dense iteration, and the dense LU solve of
                 a cheetah Hessian against the kernel's.
 10. geometry -- the kernel at this phase's two launch shapes (rows 11,
                 K=38 and K=14, R=1, B=256) against its plain version,
                 timed beside its bound, the plain version and a dense
                 library solve; (a) the cheetah with three cylinder hills
                 at B=256, two iterations, with a warm iteration and the
                 launch count against the plain cheetah's; (b) a pad whose
                 collision geometry is the hull of an OBJ ``<mesh>`` loaded
                 through an SDF file, B=256, T=20, against the box pad and
                 the CPU; (c) one CONVEX-BOX ``contact_wrenches`` and its
                 exact partials at N=5120 against the CPU.
 11. parallel -- the kernel against its plain version, timed, at the two
                 launch shapes of this phase no other phase has (rows 11,
                 K=38, B=128; rows 80, K=38, B=1); then the parallel layer
                 (``idto_tpu_torch/parallel/``) on
                 ``torch.distributed``, in float64: (a) NCCL at world size
                 1 in this process: ``solve_batch_sharded`` on the cheetah
                 at its YAML size (B=256, CR, two iterations: 2 launches),
                 ``solve_sharded`` on random SPD systems of T=160 and
                 T=640, and ``solve_trust_region_horizon_sharded`` on the
                 cheetah at full width over T=159 steps (160 knots); (b)
                 gloo at world size 2, both ranks on the one card with CUDA
                 tensors (NCCL refuses two ranks on one GPU): the
                 scenario-sharded batch (128 a rank, 2 launches a rank),
                 ``solve_sharded`` at T=160 and T=640 and the
                 horizon-sharded cheetah (80 knots a rank, distributed
                 cyclic reduction: no launch).  Each against the same call
                 made single-process on the card; informational times: a
                 per-rank iteration at world size 1 and 2, the horizon
                 solve's and the horizon-sharded iteration's time in
                 collectives.  A failure of either rank fails the phase.
 12. bench    -- ``bench_torch.run`` (the port's benchmark entry) at
                 batches 1 and 8, 2 timed calls, 3 replans, float64, once
                 with Thomas and once with cyclic reduction: every key of
                 its result line present and finite, no kernel launch with
                 Thomas and one a solve with cyclic reduction, and the B=8
                 q of each against the same chain of calls on the CPU.
 13. reference -- the per-problem (AoS) pipeline on the cheetah at its YAML
                 size, float64: the kernel at this phase's B=1 shapes
                 against its plain version; (a) kinematics, dynamics,
                 contact wrenches, step_tau and the exact partials of the
                 AoS modules against the SoA layer on the card and against
                 the CPU; (b) ``solve_trust_region``, 3 iterations, with
                 Thomas and with cyclic reduction (a launch an iteration),
                 against the batch-native ``solve`` at B=1, their ms an
                 iteration, and launches and synchronizations an iteration
                 from the profiler; (c) ``solve_batch(native=False)`` on the
                 constrained hopper at B=4 (the R=121 and R=1 launches of
                 each scenario) against ``native=True``; (d) the hull pad's
                 pair through the AoS ``signed_distance`` against the SoA
                 kernel, beyond the AoS answer's own rounding spread.
 14. times    -- one solve iteration at several batch sizes; the kernel,
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
# The manipulation examples.  Their Schur solves launch the kernel at
# (n, k, R) = (T + 1, nq, 6 T + 1): six unactuated dofs of the free body.
FLEET = ("kuka", "jaco", "jaco_ball", "dual_jaco", "allegro_hand", "punyo")
FLEET_SCHUR_SHAPES = ((41, 14, 241), (41, 21, 241), (41, 23, 241),
                      (11, 14, 61))
# Their Newton-step launches, (T + 1, nq, 1); the last is dual_jaco's only
# launch (T = 20, no equality constraints).
FLEET_STEP_SHAPES = ((41, 14, 1), (41, 21, 1), (41, 23, 1), (11, 14, 1),
                     (21, 21, 1))
FLEET_BATCH = 8
FLEET_ITERS = 2
# The fleet on the card against the port's CPU run: two iterations of the
# same float64 algorithm, the kernel against its plain version.  The scaled
# Hessians reach condition ~1e10 and cyclic reduction does not pivot, so
# summation order shows more than on the cheetah: 2e-17 (dual_jaco) to 4e-10
# (allegro_hand) on q on an NVIDIA H100 80GB HBM3.
FLEET_RTOL = 1e-7
# The closed loop: the hopper, replans after a short initial solve.
CLOSED_LOOP_EXAMPLE = "hopper"
CLOSED_LOOP_REPLANS = 10
CLOSED_LOOP_INIT_ITERS = 2
CLOSED_LOOP_REF_REPLANS = 3
# The loop on the card against the CPU run, plans and simulated states: each
# replan starts from the last one's carry and the simulated state.  The
# hopper's three chained replans differ by 1e-12 on an NVIDIA H100 80GB HBM3
# (the cheetah's, whose Hessian is worse, by 3e-7: MPC_RTOL).
CLOSED_LOOP_RTOL = 1e-8
# The hopper loop's two launches a replan, (n, k, R), at B=1.  (Jaco's, (41,
# 14, 241) and (41, 14, 1), are among the fleet's at B=1.)
CLOSED_LOOP_SHAPES = ((41, 5, 121), (41, 5, 1))
# Jaco's loop: unstable (h Kd / M = 250 on the wrist), so the state grows
# 250-fold a substep, then squares, and overflows in the second replan
# period.  Two replans of ten substeps; the first period is held.
UNSTABLE_LOOP_EXAMPLE = "jaco"
UNSTABLE_LOOP_REPLANS = 2
# The first substeps of that period against the CPU run, each relative to
# its own largest entry (both runs amplify the same rounding differences
# 250-fold a substep along with the state itself: a change of 1e-16 in
# v_init shows as 4e-11 at the sixth substep).  From the seventh on the joint
# angles pass 1e13 rad, where float64 is spaced 2e-3 rad apart and sin and
# cos keep no digit: two runs then differ by factors, and only the substep
# of the overflow is held.
UNSTABLE_LOOP_HELD = 6
UNSTABLE_LOOP_RTOL = 1e-8
# The options phase.  The cheetah at the YAML's own guess is ill-conditioned
# (the scaled Hessian of the first iteration: condition 8.8e9), and cyclic
# reduction solves it to 3e-4..7e-4 of a dense solve, in the JAX package's
# algorithm as in the port's (Thomas: 3e-8).  So rounding differences
# between two runs of one float64 algorithm grow to what these bounds hold,
# each 15-50x the difference measured between the port's Thomas and cyclic
# reduction on the CPU at the same inputs: the API's q 1e-5 (2.0e-7), its
# costs 1e-4, the warm start's steps dq and dqH 1e-2 (3.0e-4).
API_RTOL = {"q": 1e-5, "cost": 1e-4, "step": 1e-2}
API_ITERS = (3, 1)
# The velocity command: the initial solve cut to VC_INIT_ITERS iterations,
# VC_REPLANS replans, the command (vx, vy, wz) from the schedule.  Plans
# and simulated states against the CPU run: five chained replans from the
# YAML's state, each the ill-conditioned step above (5.5e-6 on the plans,
# 9.3e-7 on the simulated q on an H100), so 1e-4.
VC_INIT_ITERS = 2
VC_REPLANS = 5
VC_SCHEDULE = "0: 0.4 0 0; 0.033: 0.4 0 0.3; 0.066: 0.5 0 0"
VC_RTOL = 1e-4
# Finite differences against the exact partials after two iterations: the
# central differences' partials differ from the exact ones by ~1e-10
# (4.4e-8 on q after two iterations on the CPU).
FD_BATCH = 8
FD_ITERS = 2
FD_RTOL = 1e-6
# The linesearch, dense and exact-Hessian solves against the CPU run: the
# same float64 algorithms in other summation orders.  On the CPU a 1e-15
# relative change of the guess moves their q by up to 1.5e-8 (the exact
# Hessian on the spinner; 1.9e-10 Armijo, 3.8e-10 backtracking, 1.2e-11
# dense), so 1e-6.
OPTIONS_RTOL = 1e-6
OPTIONS_ITERS = 2
# Cyclic reduction against a dense solve on those Hessians (3e-4..7e-4 on
# the CPU, as above): the kernel against the dense LU, and each line of the
# dense cross-check through the kernel, held to 1e-2.
CR_VS_DENSE_TOL = 1e-2
# The geometry phase: the cheetah with three cylinder hills (B=256, two
# iterations) and a pad whose collision geometry is the convex hull of a
# box's 8 corners (an OBJ <mesh> in an SDF file) over a ground halfspace
# (B=256, T=20, two iterations); each against the port's CPU run of its
# first scenarios, the pad also against the same pad built as a BOX
# primitive on the card (the hull of a box is the box: the same support
# points, so the solves agree to rounding).  Then one evaluation of the
# contact wrenches and of their exact q partials on the hull pad against
# the cheetah's ground box (a CONVEX-BOX pair: 64 alternating projections,
# each a 48-step Frank-Wolfe projection onto the hull) over N instances.
GEOMETRY_BATCH = 256
GEOMETRY_ITERS = 2
GEOMETRY_NREF = 4
HILLS = 3
GEOMETRY_RTOL = 1e-8
BOX_HULL_RTOL = 1e-10
PAD_HALF = (0.1, 0.1, 0.02)
PAD_T = 20
PAD_K = 7  # the pad's nq: blocks of 7, super-rows of K = 14
WRENCH_N = 5120
WRENCH_NREF = 64  # instances run again on the CPU
# Relative to the largest entry; 6.6e-16 measured on an H100 80GB HBM3 at
# 700 W.  (The hull distance is decided by rounding where Frank-Wolfe has
# not converged, tests/test_torch_convex.py; at these poses card and CPU
# take the same paths.)
WRENCH_RTOL = 1e-9

# The parallel phase: the scenario-sharded cheetah batch (the slice's batch,
# two iterations), the horizon-sharded random SPD systems of T=160 and T=640
# (n = T + 1 block rows of the cheetah's k), and the horizon-sharded trust
# region on the cheetah at full width over T=159 steps (160 knots), at world
# size 1 (NCCL) and 2 (gloo, both ranks on the card).  Each is held against
# the same call made single-process on the card: a rank's share of the batch
# against that share solved alone, and the systems, run the same arithmetic
# (1e-9).  The cheetah at its guess is ill-conditioned (condition ~1e10,
# PERF.md section 6), so two bounds are measured ones, each with its run
# (an H100 80GB HBM3 at 700 W): the whole batch at world size 2 against one
# call of B=256 (5.3e-5 on q: the kernel gives a smaller batch whole blocks
# of warps a system, and its other summation order is amplified in the
# second iteration's Newton step), and the horizon-sharded cheetah, which
# reduces to one row a rank and solves the two-row system by Thomas where
# the single-process kernel reduces to one row (3.9e-7 on q).
PARALLEL_BATCH = 256
PARALLEL_ITERS = 2
PARALLEL_SYSTEMS = (161, 641)
PARALLEL_T = 159
PARALLEL_WORLD = 2
PARALLEL_RTOL = 1e-9
WHOLE_BATCH_RTOL = 1e-3
HORIZON_CHEETAH_RTOL = 1e-5
PARALLEL_DEADLINE = 300  # seconds the two ranks may take, start included

# The bench phase: ``bench_torch.run`` cut to batches 1 and 8, two timed
# calls and three replans.  Card against CPU on the B=8 q after its three
# chained one-iteration solves: Thomas 1e-8 (SLICE_RTOL; measured 5.3e-12);
# cyclic reduction 1e-6 (measured 1.2e-7: the cheetah's iterates have
# condition ~1e10, and the kernel and the plain version reduce in another
# order).
BENCH_BATCHES = (1, 8)
BENCH_ITERS = 2
BENCH_REPLANS = 3
BENCH_SOLVERS = ("penta_lu", "cyclic_reduction")
BENCH_RTOL = {"penta_lu": 1e-8, "cyclic_reduction": 1e-6}
# Keys of the bench's result line that hold numbers at every batch run.
BENCH_KEYS = ("latency_ms_batch1", "flops_per_solve", "measured_tflops",
              "mpc_replan_ms", "value", "vs_baseline",
              "latency_vs_60hz_budget", "power_limit_w", "chunk",
              "cr_kernel_launches")
BENCH_BATCH_KEYS = ("newton_share_batch{}", "peak_gib_batch{}",
                    "rescue_share_batch{}")

# Peak rates of one H100 SXM (NVIDIA H100 data sheet): HBM3 bandwidth;
# float64 on the tensor cores and on the FMA pipes; float32 on the FMA
# pipes (the kernel uses no TF32).
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {
    8: {"tensor cores": 66.9e12, "FMA pipes": 33.5e12},
    4: {"FMA pipes": 66.9e12},
}
SLICE_BATCH = 256
# The reference phase: the per-problem (AoS) pipeline on the cheetah at
# its YAML size.  REFERENCE_STATES seeded states for the physics; AoS
# against SoA (and card against CPU) to PHYSICS_RTOL, the partials to
# PARTIALS_RTOL.  The per-problem solve against the batch-native one at B=1
# through Thomas at tests/test_batched.py's tolerances (REFERENCE_TOL);
# through cyclic reduction to REFERENCE_CR_RTOL on q and the statistics:
# the cheetah's first Hessian has condition ~8.8e9 and cyclic reduction is
# 3e-4..7e-4 off a dense solve there, so the routes' last bits can show
# (measured: 5.3e-19 on q on the card from these guesses, 4.8e-7 on the
# CPU from the YAML guess itself).  The constrained hopper at
# REFERENCE_BATCH scenarios, REFERENCE_HOPPER_ITERS iterations, through
# solve_batch(native=False) against native=True to REFERENCE_HOPPER_RTOL
# (measured 5.2e-14 on tau: the per-problem launches are B=1, the
# batch-native one B=4, another summation order in the kernel; a Thomas
# rescue in the batch-native loop, which the per-problem loop has not,
# would fail it).  The hull pad's pair: AoS against SoA at
# REFERENCE_STATES poses within HULL_TOL beyond twice the AoS answer's own
# spread under 1e-13 shifts of the pad.
REFERENCE_STATES = 32
REFERENCE_ITERS = 3
REFERENCE_BATCH = 4
REFERENCE_HOPPER_ITERS = 2
PHYSICS_RTOL = 1e-11
PARTIALS_RTOL = 1e-9
REFERENCE_TOL = {"q": (1e-7, 1e-9), "tau": (1e-6, 1e-8),
                 "stats": (1e-6, 1e-9), "Delta": (1e-7, 0.0),
                 "dq": (1e-5, 1e-8)}
REFERENCE_CR_RTOL = 1e-6
REFERENCE_HOPPER_RTOL = 1e-9
HULL_TOL = 1e-9
STATS_ROWS = ("cost", "rho", "delta", "dq_norm", "grad_norm", "h_norm",
              "merit", "solver_flag")
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


def rel_err_np(x, ref):
    import numpy as np

    return float(np.abs(x - ref).max() / max(np.abs(ref).max(), 1e-300))


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
        path_ms = cuda_time_ms(lambda: cr_kernel.solve_many(H, rhs), REPS)
        msg += (f", path (solve_many) {path_ms:.3f} ms, plain {p_ms:.3f} ms, "
                f"library dense solve {lib_ms:.3f} ms")
        out = {"max_abs_err": out, "ms": ms, "path_ms": path_ms,
               "plain_ms": p_ms, "bound_ms": bound, "bound_by": by,
               "library_ms": lib_ms}
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
    float64 abs difference from the plain version at the cheetah shape, the
    numbers of the hopper's Schur solve (float64, the constraints path's
    batch), those of the manipulation examples' launches (float64, B=1 and
    the fleet path's batch) and those of the hopper loop's (float64, B=1)."""
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

    def held(shapes, batches):
        """Both types at each shape and batch; the float64 numbers by
        rows, K, R and batch."""
        numbers = {}
        for n, k, R in shapes:
            for dtype in (torch.float64, torch.float32):
                for B in batches:
                    f64 = dtype == torch.float64
                    out = check_kernel(gen, n, k, B, R, dtype,
                                       n_dense=DENSE_SYSTEMS, timed=True,
                                       yardsticks=f64)
                    if f64:
                        numbers[f"rows{(n + 1) // 2}_K{2 * k}_R{R}_B{B}"] = out
            torch.cuda.empty_cache()
        return numbers

    fleet = held(FLEET_SCHUR_SHAPES + FLEET_STEP_SHAPES, (1, FLEET_BATCH))
    loop = held(CLOSED_LOOP_SHAPES, (1,))
    return worst, schur, fleet, loop


def cheetah_inputs(batch, seed, device, iters=3, hills=0):
    """mini_cheetah (with ``hills`` cylinder hills) with CR in float64 for
    ``max_iterations=iters``, and ``batch`` q guesses: the example's guess
    plus 0.01 N(0, 1) noise from ``seed``, q_0 pinned to q_init."""
    import numpy as np
    import torch

    from idto_tpu_torch.examples import registry
    from idto_tpu_torch.optimizer.problem import LinearSolverType

    model, _, prob, params, q_guess = registry.load_example(
        "mini_cheetah", dtype=torch.float64, device=device)
    if hills:
        model = registry._mini_cheetah(hills=hills).finalize(
            dtype=torch.float64, device=device)
    params = params.replace(
        linear_solver=LinearSolverType.CYCLIC_REDUCTION,
        check_convergence=False, max_iterations=iters,
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


def fleet_inputs(name, batch, seed, device, iters=FLEET_ITERS):
    """A manipulation example at its YAML settings but for cyclic reduction
    and ``iters`` iterations, float64, and ``batch`` q guesses: the
    example's guess plus 0.01 N(0, 1) noise from ``seed``, q_0 pinned to
    q_init."""
    import numpy as np
    import torch

    from idto_tpu_torch.examples.registry import load_example
    from idto_tpu_torch.optimizer.problem import LinearSolverType

    model, _, prob, params, q_guess = load_example(
        name, dtype=torch.float64, device=device)
    params = params.replace(
        linear_solver=LinearSolverType.CYCLIC_REDUCTION, max_iterations=iters)
    rng = np.random.default_rng(seed)
    qg = q_guess.cpu().numpy()[None] + 0.01 * rng.standard_normal(
        (batch,) + tuple(q_guess.shape))
    qg[:, 0] = prob.q_init.cpu().numpy()
    return model, prob, params, torch.as_tensor(qg, device=device)


def phase_fleet(seed):
    """The six manipulation examples on the card; returns (launches, ms of
    one iteration by example)."""
    import torch

    from idto_tpu_torch.ops import cr_kernel
    from idto_tpu_torch.parallel.batching import broadcast_problem, solve_batch

    total_mem = torch.cuda.mem_get_info()[1]
    total, iter_ms = 0, {}
    nref = 2
    for name in FLEET:
        model, prob, params, qg = fleet_inputs(name, FLEET_BATCH, seed, "cuda")
        constrained = bool(params.equality_constraints
                           and model.unactuated_vdofs)
        n_h = prob.num_steps * len(model.unactuated_vdofs) if constrained \
            else 0
        # The batch is sized from the peak of one scenario's iteration.
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        solve_batch(model, broadcast_problem(prob, 1),
                    params.replace(max_iterations=1), qg[:1])
        torch.cuda.synchronize()
        peak1 = torch.cuda.max_memory_allocated() - base
        if FLEET_BATCH * peak1 > MEMORY_BUDGET * total_mem:
            raise AssertionError(
                f"fleet: {name} at B={FLEET_BATCH} would need "
                f"{FLEET_BATCH * peak1 / 2**30:.1f} GiB")
        probs = broadcast_problem(prob, FLEET_BATCH)
        torch.cuda.reset_peak_memory_stats()
        cr_kernel.launches = 0
        t0 = time.perf_counter()
        sol, stats, _ = solve_batch(model, probs, params, qg)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = cr_kernel.launches
        total += launches
        peak = torch.cuda.max_memory_allocated() / 2**30
        expected = (2 if constrained else 1) * FLEET_ITERS
        if launches != expected:
            raise AssertionError(f"fleet: {name} launched the kernel "
                                 f"{launches} times, expected {expected}")
        failed = check_solution(sol, stats, f"fleet {name}", monotone=False)
        if failed:
            raise AssertionError(f"fleet: {name}: {failed} scenarios failed")
        cost = stats.cost
        if not bool((cost[:, -1] <= cost[:, 0]).all()):
            raise AssertionError(f"fleet: {name}: cost above the initial cost")
        iter_ms[name] = 1e3 * seconds / FLEET_ITERS
        log("fleet", f"{name} nq={model.nq} T={prob.num_steps} pairs="
                     f"{len(model.geoms.pairs)} R={n_h + 1} B={FLEET_BATCH} "
                     f"float64 CR, {FLEET_ITERS} iterations: {seconds:.2f} s "
                     f"({iter_ms[name]:.0f} ms an iteration, host clock), "
                     f"peak {peak:.3f} GiB (one scenario "
                     f"{peak1 / 2**30:.3f}), kernel launches {launches}, mean "
                     f"cost {cost[:, 0].mean().item():.6e} -> "
                     f"{cost[:, -1].mean().item():.6e}, mean h_norm "
                     f"{stats.h_norm[:, 0].mean().item():.4e} -> "
                     f"{stats.h_norm[:, -1].mean().item():.4e}")

        model_c, prob_c, params_c, qg_c = fleet_inputs(
            name, FLEET_BATCH, seed, "cpu")
        t0 = time.perf_counter()
        sol_c, stats_c, _ = solve_batch(
            model_c, broadcast_problem(prob_c, nref), params_c, qg_c[:nref])
        cpu_s = time.perf_counter() - t0
        errs = {
            "q": rel_err(sol.q[:nref].cpu(), sol_c.q),
            "cost": rel_err(stats.cost[:nref].cpu(), stats_c.cost),
            "h_norm": rel_err(stats.h_norm[:nref].cpu(), stats_c.h_norm)
            if constrained else 0.0,
        }
        log("fleet", f"  card vs CPU ({cpu_s:.1f} s), first {nref} scenarios: "
                     + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
                     + f" (tol {FLEET_RTOL:g})")
        if not all(v <= FLEET_RTOL for v in errs.values()):
            raise AssertionError(f"fleet: {name} on the card disagrees with "
                                 f"the CPU run")
        del model, prob, params, qg, probs, sol, stats
        torch.cuda.empty_cache()
    return total, iter_ms


def closed_loop_run(device, replans, example=CLOSED_LOOP_EXAMPLE):
    """``run_mpc`` on ``example`` on ``device``: cyclic reduction, the
    initial solve cut to CLOSED_LOOP_INIT_ITERS iterations, ``sim_time`` to
    ``replans`` replans, the simulation plant of ``load_sim_plant``.
    Returns (result, plans, the kernel's launch count read at each replan,
    (model, config))."""
    import dataclasses

    import torch

    from idto_tpu_torch.examples.registry import load_example, load_sim_plant
    from idto_tpu_torch.mpc.runner import run_mpc
    from idto_tpu_torch.ops import cr_kernel
    from idto_tpu_torch.optimizer.problem import LinearSolverType

    model, cfg, prob, params, q_guess = load_example(
        example, dtype=torch.float64, device=device)
    params = params.replace(
        linear_solver=LinearSolverType.CYCLIC_REDUCTION,
        max_iterations=CLOSED_LOOP_INIT_ITERS)
    cfg = dataclasses.replace(
        cfg, sim_time=(replans + 0.5) / cfg.controller_frequency)
    sim_model, sim_contact = load_sim_plant(example, params, device=device)
    plans, counts = [], []

    def on_replan(t_now, q_plan):
        plans.append(q_plan)
        counts.append(cr_kernel.launches)

    res = run_mpc(model, cfg, prob, params, q_guess, sim_model=sim_model,
                  sim_contact=sim_contact, on_replan=on_replan)
    return res, plans, counts, (model, cfg)


def first_nonfinite(res):
    """Index of the first substep whose logged q or v is not finite, or
    -1."""
    import numpy as np

    finite = np.isfinite(res.q_log).all(axis=1) & np.isfinite(
        res.v_log).all(axis=1)
    return -1 if finite.all() else int(np.argmin(finite))


def substep_errs(res, ref, substeps):
    """Largest difference of the first ``substeps`` logged q, v and u from
    ``ref``'s, each substep relative to its own largest entry."""
    import numpy as np

    errs = {}
    for key in ("q_log", "v_log", "u_log"):
        x, y = getattr(res, key)[:substeps], getattr(ref, key)[:substeps]
        errs[key] = float((np.abs(x - y).max(axis=1)
                           / np.abs(y).max(axis=1).clip(1e-300)).max())
    return errs


def unstable_loop_on_card():
    """Jaco's loop on the card, launches counted by the caller: returns what
    ``check_unstable_loop`` holds."""
    from idto_tpu_torch.examples.registry import load_example, load_sim_plant
    from idto_tpu_torch.ops import cr_kernel

    before = cr_kernel.launches
    res, plans, counts, (_, cfg) = closed_loop_run(
        "cuda", UNSTABLE_LOOP_REPLANS, UNSTABLE_LOOP_EXAMPLE)
    counts = [n - before for n in counts]
    params = load_example(UNSTABLE_LOOP_EXAMPLE, device="cpu")[3]
    _, sim_contact = load_sim_plant(UNSTABLE_LOOP_EXAMPLE, params,
                                    device="cpu")
    if sim_contact is None or sim_contact == params.contact:
        raise AssertionError("closed_loop: the simulation contact is the "
                             "optimizer's")
    return res, plans, counts, cfg, sim_contact


def check_unstable_loop(res, plans, counts, cfg, sim_contact):
    """Jaco's loop on the card against the CPU run: launches, the first
    substeps one by one, and where it turns non-finite."""
    import numpy as np

    first = 2 * CLOSED_LOOP_INIT_ITERS + 2 * cfg.mpc_iters
    expected = [first + 2 * cfg.mpc_iters * i
                for i in range(UNSTABLE_LOOP_REPLANS)]
    if counts != expected:
        raise AssertionError(f"closed_loop: {UNSTABLE_LOOP_EXAMPLE} launches "
                             f"at each replan {counts}, expected {expected}")
    substeps = max(1, round(1.0 / (cfg.controller_frequency
                                   * cfg.sim_time_step)))
    n_bad = first_nonfinite(res)
    if not (n_bad < 0 or n_bad >= substeps):
        raise AssertionError(f"closed_loop: {UNSTABLE_LOOP_EXAMPLE}'s first "
                             f"replan period is not finite (substep {n_bad})")
    res_c, plans_c, _, _ = closed_loop_run(
        "cpu", UNSTABLE_LOOP_REPLANS, UNSTABLE_LOOP_EXAMPLE)
    n_bad_c = first_nonfinite(res_c)
    errs = substep_errs(res, res_c, UNSTABLE_LOOP_HELD)
    errs["plan"] = rel_err_np(plans[0], plans_c[0])
    log("closed_loop", f"{UNSTABLE_LOOP_EXAMPLE} B=1 float64 CR, sim contact "
                       f"stiffness {sim_contact.stiffness:g} and smoothing "
                       f"{sim_contact.smoothing_factor:g}, "
                       f"{UNSTABLE_LOOP_REPLANS} replans of {substeps} "
                       f"substeps of {cfg.sim_time_step:g} s: launches at "
                       f"each replan {counts}; max |v| by substep "
                       + " ".join(f"{x:.1e}" for x in
                                  np.abs(res.v_log[:substeps]).max(axis=1))
                       + f"; non-finite from substep {n_bad} (CPU run: "
                       f"{n_bad_c}); first {UNSTABLE_LOOP_HELD} substeps, card "
                       f"vs CPU, each relative to its own size: "
                       + ", ".join(f"{k} {e:.3e}" for k, e in errs.items())
                       + f" (tol {UNSTABLE_LOOP_RTOL:g}); mean_solve_time "
                       f"{1e3 * res.mean_solve_time:.1f} ms, one simulated "
                       f"period {1e3 * res.mean_sim_time:.1f} ms")
    if n_bad != n_bad_c:
        raise AssertionError("closed_loop: the card's loop turns non-finite "
                             "at another substep than the CPU run's")
    if not all(e <= UNSTABLE_LOOP_RTOL for e in errs.values()):
        raise AssertionError(f"closed_loop: {UNSTABLE_LOOP_EXAMPLE}'s first "
                             f"substeps on the card disagree with the CPU "
                             f"run")


def phase_closed_loop():
    """The closed loops on the card; returns (launches, ms of a replan, ms
    of a simulated replan period of the hopper)."""
    import numpy as np

    from idto_tpu_torch.ops import cr_kernel

    cr_kernel.launches = 0
    t0 = time.perf_counter()
    res, plans, counts, (model, cfg) = closed_loop_run(
        "cuda", CLOSED_LOOP_REPLANS)
    seconds = time.perf_counter() - t0
    hopper_total = cr_kernel.launches
    unstable = unstable_loop_on_card()
    total = cr_kernel.launches
    # Two launches an iteration (the Schur solve and the Newton step): the
    # initial solve's, then mpc_iters a replan.
    first = 2 * CLOSED_LOOP_INIT_ITERS + 2 * cfg.mpc_iters
    expected = [first + 2 * cfg.mpc_iters * i
                for i in range(CLOSED_LOOP_REPLANS)]
    if counts != expected or hopper_total != expected[-1]:
        raise AssertionError(f"closed_loop: launches at each replan {counts} "
                             f"(total {hopper_total}), expected {expected}")
    substeps = max(1, round(1.0 / (cfg.controller_frequency
                                   * cfg.sim_time_step)))
    steps = CLOSED_LOOP_REPLANS * substeps
    for key, width in (("q_log", model.nq), ("v_log", model.nv),
                       ("u_log", model.nu)):
        x = getattr(res, key)
        if x.shape != (steps, width) or not np.isfinite(x).all():
            raise AssertionError(f"closed_loop: bad {key} {x.shape}")
    if res.times.shape != (steps,) or res.num_solves != CLOSED_LOOP_REPLANS:
        raise AssertionError("closed_loop: wrong number of steps")
    replan_ms = 1e3 * res.mean_solve_time
    period_ms = 1e3 * res.mean_sim_time
    log("closed_loop", f"{CLOSED_LOOP_EXAMPLE} B=1 float64 CR, initial solve "
                       f"of {CLOSED_LOOP_INIT_ITERS} iterations, "
                       f"{CLOSED_LOOP_REPLANS} replans at "
                       f"{cfg.controller_frequency:g} Hz, {substeps} substeps "
                       f"of {cfg.sim_time_step:g} s each: {seconds:.1f} s, "
                       f"{hopper_total} kernel launches (2 a replan), q from "
                       f"{res.q_log[0].round(4).tolist()} to "
                       f"{res.q_log[-1].round(4).tolist()}, max |u| "
                       f"{np.abs(res.u_log).max():.3g}; mean_solve_time "
                       f"{replan_ms:.1f} ms, "
                       f"one simulated period {period_ms:.1f} ms "
                       f"({period_ms / substeps:.1f} ms a substep)")
    res_c, plans_c, _, _ = closed_loop_run("cpu", CLOSED_LOOP_REF_REPLANS)
    e_plan = [rel_err_np(a, b) for a, b in zip(plans, plans_c)]
    n = res_c.q_log.shape[0]
    e_log = {k: rel_err_np(getattr(res, k)[:n], getattr(res_c, k))
             for k in ("q_log", "v_log", "u_log")}
    log("closed_loop", f"card vs CPU, first {CLOSED_LOOP_REF_REPLANS} "
                       f"replans: plans "
                       + ", ".join(f"{e:.3e}" for e in e_plan)
                       + f"; simulated over {n} substeps "
                       + ", ".join(f"{k} {e:.3e}" for k, e in e_log.items())
                       + f" (tol {CLOSED_LOOP_RTOL:g})")
    if not all(e <= CLOSED_LOOP_RTOL for e in e_plan + list(e_log.values())):
        raise AssertionError("closed_loop: the loop on the card disagrees "
                             "with the CPU run")
    check_unstable_loop(*unstable)
    return total, replan_ms, period_ms


def options_inputs(name, device, batch=1, seed=0, **more):
    """An example at its YAML size in float64 on ``device``, cyclic
    reduction and OPTIONS_ITERS iterations unless ``more`` says otherwise,
    and ``batch`` q guesses: the example's guess plus 0.01 N(0, 1) noise
    from ``seed`` (none at batch 1), q_0 pinned to q_init."""
    import numpy as np
    import torch

    from idto_tpu_torch.examples.registry import load_example
    from idto_tpu_torch.optimizer.problem import LinearSolverType

    model, cfg, prob, params, q_guess = load_example(
        name, dtype=torch.float64, device=device)
    params = params.replace(**{
        "linear_solver": LinearSolverType.CYCLIC_REDUCTION,
        "max_iterations": OPTIONS_ITERS, **more})
    qg = q_guess.cpu().numpy()[None].repeat(batch, 0)
    if batch > 1:
        qg = qg + 0.01 * np.random.default_rng(seed).standard_normal(
            qg.shape)
    qg[:, 0] = prob.q_init.cpu().numpy()
    return model, cfg, prob, params, torch.as_tensor(qg, device=device)


def timed(fn):
    """(fn(), host-clock ms around it with a synchronize on each side)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - t0)


def api_run(device):
    """(a): Solve, then SolveFromWarmStart from its result; returns the
    arrays compared, the launches of each call and the host-clock ms of
    each."""
    import torch

    from idto_tpu_torch.api import TrajectoryOptimizer
    from idto_tpu_torch.ops import cr_kernel

    model, _, prob, params, qg = options_inputs("mini_cheetah", device)
    n_solve, n_warm = API_ITERS
    opt = TrajectoryOptimizer(model, prob,
                              params.replace(max_iterations=n_solve))
    warm_opt = TrajectoryOptimizer(model, prob,
                                   params.replace(max_iterations=n_warm))
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    out, launches, ms = {}, [], []

    def measured(call):
        before = cr_kernel.launches
        sync()
        t0 = time.perf_counter()
        sol, stats = call()
        sync()
        ms.append(1e3 * (time.perf_counter() - t0))
        launches.append(cr_kernel.launches - before)
        return sol, stats

    sol, stats = measured(lambda: opt.Solve(qg[0]))
    out.update(solve_q=sol.q, solve_cost=stats.cost)
    ws = warm_opt.CreateWarmStart(sol.q)
    sol, stats = measured(lambda: warm_opt.SolveFromWarmStart(ws))
    out.update(warm_q=sol.q, warm_cost=stats.cost, ws_q=ws.q,
               ws_Delta=torch.tensor(ws.Delta, dtype=torch.float64),
               ws_dq=torch.as_tensor(ws.dq), ws_dqH=torch.as_tensor(ws.dqH))
    return out, launches, ms


def velocity_run(device):
    """(b): the velocity-command loop; returns the plans, the simulated
    q log, the launches and host-clock ms of each replan."""
    import numpy as np
    import torch

    from idto_tpu_torch.examples.registry import load_sim_plant
    from idto_tpu_torch.examples.velocity_command import (
        command_at,
        parse_schedule,
    )
    from idto_tpu_torch.mpc import controller as mpc
    from idto_tpu_torch.mpc.simulator import simulate_segment
    from idto_tpu_torch.ops import cr_kernel
    from idto_tpu_torch.parallel.batching import broadcast_problem

    model, cfg, prob, params, qg = options_inputs(
        "mini_cheetah", device, max_iterations=VC_INIT_ITERS)
    sim_model, sim_contact = load_sim_plant("mini_cheetah", params,
                                            device=device)
    sim_model = sim_model if sim_model is not None else model
    sim_contact = sim_contact if sim_contact is not None else params.contact
    schedule = parse_schedule(VC_SCHEDULE)
    replan = 1.0 / cfg.controller_frequency
    h = cfg.sim_time_step
    substeps = max(1, int(round(replan / h)))
    mpc_params = mpc.make_mpc_params(params, cfg.mpc_iters)
    Kp, Kd = (torch.as_tensor(np.asarray(x, dtype=np.float64),
                              device=device) for x in (cfg.Kp, cfg.Kd))
    probs = broadcast_problem(prob, 1)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    carry, _ = mpc.mpc_initialize(model, probs, params, qg)
    q, v = prob.q_init[None], prob.v_init[None]
    plans, logs, launches, ms, cmds = [], [q.cpu()], [], [], []
    for k in range(VC_REPLANS):
        t_now = k * replan
        cmds.append(command_at(schedule, t_now))
        cmd = torch.tensor(cmds[-1], dtype=torch.float64, device=device)
        before = cr_kernel.launches
        sync()
        t0 = time.perf_counter()
        carry, sol = mpc.mpc_step_velocity_command(
            model, probs, mpc_params, carry, torch.cat([q, v], dim=1), t_now,
            cmd)
        sync()
        ms.append(1e3 * (time.perf_counter() - t0))
        launches.append(cr_kernel.launches - before)
        plans.append(sol.q[0].cpu())
        q, v, log = simulate_segment(sim_model, sim_contact, h, substeps,
                                     carry.stored, Kp, Kd, q, v, t_now,
                                     cfg.feed_forward)
        logs.append(log[0][0].cpu())
    return (torch.stack(plans), torch.cat(logs), launches, ms, cmds,
            substeps, cfg)


def phase_options(seed):
    """The options phase on the card; returns the launches of (a), (b),
    (c) and (f) by path and the informational times."""
    import numpy as np
    import torch

    from idto_tpu_torch.ops import cr_kernel, penta
    from idto_tpu_torch.optimizer import solver
    from idto_tpu_torch.optimizer.problem import (
        GradientsMethod,
        LinearSolverType,
        LinesearchMethod,
        SolverMethod,
    )
    from idto_tpu_torch.parallel.batching import broadcast_problem, solve_batch

    gen = torch.Generator(device="cuda").manual_seed(seed + 2)
    # The kernel at the shapes of this phase's launches: the cheetah's
    # Newton step at B=1 (a, b, f) and B=FD_BATCH (c).
    for B in (1, FD_BATCH):
        check_kernel(gen, CHEETAH_N, CHEETAH_K, B, 1, torch.float64)
    launches, times = {}, {}

    # (a) the object API.
    cr_kernel.launches = 0
    out, n, ms = api_run("cuda")
    launches["api"] = cr_kernel.launches
    if n != list(API_ITERS):
        raise AssertionError(f"options: API launches {n}, expected "
                             f"{list(API_ITERS)}")
    ref, _, _ = api_run("cpu")
    errs = {k: rel_err(out[k].cpu(), ref[k]) for k in out}
    times["api_iteration_ms"] = ms[0] / API_ITERS[0]
    log("options", f"(a) TrajectoryOptimizer mini_cheetah B=1 float64 CR: "
                   f"Solve {ms[0]:.1f} ms ({API_ITERS[0]} iterations, "
                   f"{times['api_iteration_ms']:.1f} ms each), "
                   f"SolveFromWarmStart {ms[1]:.1f} ms (1); launches {n}; "
                   f"card vs CPU " + ", ".join(
                       f"{k} {e:.2e}" for k, e in errs.items())
                   + f" (tol q {API_RTOL['q']:g}, cost {API_RTOL['cost']:g}, "
                   f"dq/dqH {API_RTOL['step']:g})")
    for k, e in errs.items():
        kind = ("step" if k in ("ws_dq", "ws_dqH") else
                "cost" if k.endswith("cost") else "q")
        if e > API_RTOL[kind]:
            raise AssertionError(f"options: API {k} disagrees with the CPU")

    # (b) the velocity-command MPC.
    cr_kernel.launches = 0
    plans, q_log, n, ms, cmds, substeps, cfg = velocity_run("cuda")
    launches["velocity_command"] = cr_kernel.launches
    if n != [cfg.mpc_iters] * VC_REPLANS:
        raise AssertionError(f"options: velocity-command launches {n}")
    if not (torch.isfinite(plans).all() and torch.isfinite(q_log).all()):
        raise AssertionError("options: velocity command went non-finite")
    plans_c, q_log_c, _, _, _, _, _ = velocity_run("cpu")
    e_plan = rel_err(plans, plans_c)
    e_sim = rel_err(q_log, q_log_c)
    # The planned base x displacement over each horizon (T dt = 1 s), and
    # the simulated one over the 5 periods (85 ms: the cheetah starts from
    # rest and first settles, so its sign is printed, not held).
    plan_dx = (plans[:, -1, 4] - plans[:, 0, 4]).tolist()
    dx = float(q_log[-1, 4] - q_log[0, 4])
    times["velocity_replan_ms"] = statistics.median(ms[1:])
    log("options", f"(b) velocity command mini_cheetah B=1 float64 CR: "
                   f"{VC_REPLANS} replans of {substeps} substeps, commands "
                   f"{cmds}, launches {n}, replan ms "
                   + " ".join(f"{x:.1f}" for x in ms)
                   + f" (median after the first "
                   f"{times['velocity_replan_ms']:.1f}); planned base dx "
                   + " ".join(f"{x:+.4f}" for x in plan_dx)
                   + f" m; simulated base dx {dx:+.4f} m "
                   f"dy {float(q_log[-1, 5] - q_log[0, 5]):+.4f} m; card vs "
                   f"CPU plans {e_plan:.2e}, simulated q {e_sim:.2e} (tol "
                   f"{VC_RTOL:g})")
    if not (e_plan <= VC_RTOL and e_sim <= VC_RTOL):
        raise AssertionError("options: velocity command disagrees with CPU")
    if not all(x * c[0] > 0 for x, c in zip(plan_dx, cmds)):
        raise AssertionError("options: a plan moves against the command")

    # (c) finite-difference partials against AUTODIFF; times of each order.
    model, _, prob, params, qg = options_inputs(
        "mini_cheetah", "cuda", FD_BATCH, seed, max_iterations=FD_ITERS)
    probs = broadcast_problem(prob, FD_BATCH)
    cr_kernel.launches = 0
    (sol_fd, st_fd, _), fd_ms = timed(lambda: solve_batch(
        model, probs, params.replace(
            gradients_method=GradientsMethod.CENTRAL_DIFFERENCES), qg))
    launches["fd_partials"] = cr_kernel.launches
    if cr_kernel.launches != FD_ITERS:
        raise AssertionError(f"options: FD launches {cr_kernel.launches}")
    (sol_ad, st_ad, _), ad_ms = timed(
        lambda: solve_batch(model, probs, params, qg))
    e_fd = rel_err(sol_fd.q, sol_ad.q)
    # One iteration of each gradients method, at B=1 and B=FD_BATCH.
    fd_times = {}
    for B in (1, FD_BATCH):
        probs_b = broadcast_problem(prob, B)
        for gm in (GradientsMethod.FORWARD_DIFFERENCES,
                   GradientsMethod.CENTRAL_DIFFERENCES,
                   GradientsMethod.CENTRAL_DIFFERENCES4,
                   GradientsMethod.AUTODIFF):
            p1 = params.replace(gradients_method=gm, max_iterations=1)
            fd_times[f"{gm.value} B={B}"] = min(timed(lambda: solve_batch(
                model, probs_b, p1, qg[:B]))[1] for _ in range(2))
    times["fd_iteration_ms"] = fd_times
    log("options", f"(c) central differences mini_cheetah B={FD_BATCH} "
                   f"float64 CR, {FD_ITERS} iterations: {fd_ms:.0f} ms "
                   f"(AUTODIFF {ad_ms:.0f}), launches {launches['fd_partials']}"
                   f"; q vs the AUTODIFF run {e_fd:.2e} (tol {FD_RTOL:g}); "
                   f"one iteration (best of 2, host clock): " + ", ".join(
                       f"{k} {x:.1f} ms" for k, x in fd_times.items()))
    if not e_fd <= FD_RTOL:
        raise AssertionError("options: FD solve disagrees with AUTODIFF")
    del probs, sol_fd, sol_ad, st_fd, st_ad

    # (d) linesearch and (e) dense: no launch; each against its CPU run.
    cases = (
        ("d", "armijo mini_cheetah", "mini_cheetah", dict(
            method=SolverMethod.LINESEARCH,
            linesearch_method=LinesearchMethod.ARMIJO)),
        ("d", "backtracking hopper", "hopper", dict(
            method=SolverMethod.LINESEARCH,
            linesearch_method=LinesearchMethod.BACKTRACKING)),
        ("e", "dense_ldlt mini_cheetah", "mini_cheetah", dict(
            linear_solver=LinearSolverType.DENSE_LDLT)),
        ("e", "exact_hessian spinner", "spinner", dict(exact_hessian=True)),
    )
    for part, tag, name, more in cases:
        model, _, prob, params, qg = options_inputs(name, "cuda", **more)
        cr_kernel.launches = 0
        (sol, stats, _), ms = timed(lambda: solver.solve(
            model, prob, params, qg[0]))
        if cr_kernel.launches:
            raise AssertionError(f"options: {tag} launched the kernel")
        m_c, _, p_c, pr_c, qg_c = options_inputs(name, "cpu", **more)
        sol_c, stats_c, _ = solver.solve(m_c, p_c, pr_c, qg_c[0])
        errs = {"q": rel_err(sol.q.cpu(), sol_c.q),
                "cost": rel_err(stats.cost.cpu(), stats_c.cost)}
        key = tag.split()[0]
        times[f"{key}_iteration_ms"] = ms / params.max_iterations
        log("options", f"({part}) "
                       f"{tag} B=1 float64: {params.max_iterations} "
                       f"iterations in {ms:.0f} ms, launches 0, cost "
                       + " -> ".join(f"{c:.6e}" for c in
                                     stats.cost.tolist()) + "; card vs CPU "
                       + ", ".join(f"{k} {e:.2e}" for k, e in errs.items())
                       + f" (tol {OPTIONS_RTOL:g})")
        if not all(e <= OPTIONS_RTOL for e in errs.values()):
            raise AssertionError(f"options: {tag} disagrees with the CPU")

    # The dense LU solve of a cheetah Hessian against the kernel's.
    from idto_tpu_torch.optimizer.batched import _prepare_batched

    model, _, prob, params, qg = options_inputs("mini_cheetah", "cuda")
    prep = _prepare_batched(model, broadcast_problem(prob, 1), params, qg,
                            torch.ones_like(qg))
    H, g = prep.H, prep.g_merit[:, None]
    Hd = penta.to_dense(H)
    x_lu = solver._lin_solve_many(solver._dense_factorize(Hd), g)
    x_cr = cr_kernel.solve_many(H, g)
    e_lu = rel_err(x_cr, x_lu)
    lu_ms = cuda_time_ms(lambda: solver._lin_solve_many(
        solver._dense_factorize(Hd), g), REPS * 2)
    cr_ms = cuda_time_ms(lambda: cr_kernel.solve_many(H, g), REPS * 2)
    times["cheetah_hessian_lu_ms"] = lu_ms
    times["cheetah_hessian_cr_ms"] = cr_ms
    log("options", f"(e) a scaled cheetah Hessian (399 x 399, B=1): dense LU "
                   f"factor + solve {lu_ms:.3f} ms, kernel (solve_many) "
                   f"{cr_ms:.3f} ms, median of {REPS * 2}; kernel vs LU "
                   f"{e_lu:.2e} (tol {CR_VS_DENSE_TOL:g})")
    if not e_lu <= CR_VS_DENSE_TOL:
        raise AssertionError("options: kernel and LU disagree on a Hessian")

    # (f) diagnostics through the kernel.
    import contextlib
    import io

    model, _, prob, params, qg = options_inputs(
        "mini_cheetah", "cuda", verbose=True, debug_compare_against_dense=True,
        record_iteration_times=True)
    cr_kernel.launches = 0
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        _, stats, _ = solver.solve(model, prob, params, qg[0])
    launches["diagnostics"] = cr_kernel.launches
    text = buf.getvalue()
    print(text, end="", flush=True)
    iters = int(stats.num_iters)
    errs = [float(ln.split(":")[1]) for ln in text.splitlines()
            if ln.startswith("[debug] sparse vs. dense")]
    rows = [ln for ln in text.splitlines() if ln[:5].strip().isdigit()]
    t = stats.time[:iters].cpu().numpy()
    log("options", f"(f) verbose + debug_compare_against_dense + "
                   f"record_iteration_times mini_cheetah B=1 CR: {iters} "
                   f"iterations, {len(rows)} table rows, launches "
                   f"{launches['diagnostics']}, compare errors "
                   + " ".join(f"{e:.2e}" for e in errs)
                   + f" (tol {CR_VS_DENSE_TOL:g}), iteration times "
                   + " ".join(f"{1e3 * x:.1f}" for x in t) + " ms")
    if not (len(rows) == iters == len(errs) == launches["diagnostics"]
            and max(errs) < CR_VS_DENSE_TOL and (t > 0).all()
            and np.isfinite(t).all()):
        raise AssertionError("options: diagnostics failed")
    return launches, times


PAD_SDF = """<?xml version="1.0"?>
<sdf version="1.7">
  <model name="pad">
    <link name="pad">
      <inertial><mass>1.0</mass>
        <inertia><ixx>1e-3</ixx><iyy>1e-3</iyy><izz>1e-3</izz>
                 <ixy>0</ixy><ixz>0</ixz><iyz>0</iyz></inertia>
      </inertial>
      <collision name="pad_hull">
        <geometry><mesh><uri>pad.obj</uri></mesh></geometry>
      </collision>
    </link>
  </model>
</sdf>
"""


def pad_corners():
    import itertools

    import numpy as np

    return np.array([s * np.asarray(PAD_HALF)
                     for s in itertools.product([-1.0, 1.0], repeat=3)])


def pad_model(device, shape, directory):
    """The pad with its hull loaded from an OBJ through an SDF file
    ("hull"), or built as a BOX ("box"), over a ground halfspace; or the
    hull against the cheetah's ground box ("hull_box_ground")."""
    import numpy as np
    import torch

    from idto_tpu_torch.examples.registry import _add_ground_box
    from idto_tpu_torch.models.model import GeomType, JointType, ModelBuilder
    from idto_tpu_torch.models.sdf import parse_model_file

    if shape.startswith("hull"):
        with open(os.path.join(directory, "pad.obj"), "w") as f:
            f.write("\n".join("v " + " ".join(repr(float(c)) for c in v)
                              for v in pad_corners()) + "\n")
        with open(os.path.join(directory, "pad.sdf"), "w") as f:
            f.write(PAD_SDF)
        b = parse_model_file(os.path.join(directory, "pad.sdf"))
    else:
        b = ModelBuilder()
        b.add_link("pad", "world", JointType.FLOATING, mass=1.0,
                   inertia=np.eye(3) * 1e-3)
        b.add_geometry("pad", GeomType.BOX, list(PAD_HALF), name="pad_box")
    if shape.endswith("box_ground"):
        _add_ground_box(b, z_top=0.0)
    else:
        b.add_geometry("world", GeomType.HALFSPACE, name="ground")
    model = b.finalize(dtype=torch.float64, device=device)
    if shape.startswith("hull") and int(model.geoms.types[0]) != int(
            GeomType.CONVEX):
        raise AssertionError("geometry: the pad's mesh is not a hull")
    return model


def pad_inputs(batch, seed, device, shape, directory):
    """The pad, resting 1 mm deep in the ground, slid 5 cm along x in T=20
    steps of 0.05 s.  Weights: Qq 10 on x, y, z and 1 on the quaternion,
    Qv 0.1, R 1e-3 (the unactuated floating base: R prices the generalized
    forces), final weights 10x; no equality constraints; cyclic reduction;
    q guesses the nominal plus 2 mm N(0, 1) on x, y, z from ``seed``, q_0
    pinned."""
    import numpy as np
    import torch

    from idto_tpu_torch.optimizer.problem import (
        LinearSolverType,
        ProblemDefinition,
        SolverParameters,
    )

    model = pad_model(device, shape, directory)
    T, nv = PAD_T, model.nv
    q0 = np.array([1.0, 0, 0, 0, 0.0, 0.0, PAD_HALF[2] - 1e-3])
    q1 = q0.copy()
    q1[4] = 0.05
    q_nom = q0 + np.linspace(0.0, 1.0, T + 1)[:, None] * (q1 - q0)
    Qq = np.array([1.0] * 4 + [10.0] * 3)

    def t(x):
        return torch.as_tensor(np.asarray(x, dtype=np.float64),
                               device=device)

    prob = ProblemDefinition(
        num_steps=T, dt=0.05, q_init=t(q0), v_init=t(np.zeros(nv)),
        q_nom=t(q_nom), v_nom=t(np.zeros((T + 1, nv))), Qq=t(Qq),
        Qv=t(np.full(nv, 0.1)), R=t(np.full(nv, 1e-3)), Qf_q=t(10 * Qq),
        Qf_v=t(np.full(nv, 1.0)))
    params = SolverParameters(
        max_iterations=GEOMETRY_ITERS, check_convergence=False,
        equality_constraints=False,
        linear_solver=LinearSolverType.CYCLIC_REDUCTION)
    qg = q_nom[None].repeat(batch, 0)
    qg[:, 1:, 4:] += 0.002 * np.random.default_rng(seed).standard_normal(
        (batch, T, 3))
    return model, prob, params, t(qg)


def solve_on(device, inputs, nref=None):
    """solve_batch of (model, prob, params, qg); the first ``nref``
    scenarios only when given.  Returns (Solution, Stats, seconds)."""
    import torch

    from idto_tpu_torch.parallel.batching import broadcast_problem, solve_batch

    model, prob, params, qg = inputs
    if nref is not None:
        qg = qg[:nref]
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    sol, stats, _ = solve_batch(model, broadcast_problem(prob, qg.shape[0]),
                                params, qg)
    if device == "cuda":
        torch.cuda.synchronize()
    return sol, stats, time.perf_counter() - t0


def launch_count(fn):
    """CUDA kernel launches of one call of fn, from torch.profiler's host
    events, its device-busy share and its profiled wall ms.  The profiler's
    raw events are read as they come: building its per-name averages takes
    a minute and more for the ~10^5 launches of a hull evaluation."""
    import collections

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    launches, busy_ns = 0, 0
    host = collections.Counter()
    counts = collections.Counter()
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            busy_ns += e.duration_ns()
            continue
        name = e.name()
        launches += name.startswith("cudaLaunchKernel")
        host[name] += e.duration_ns()
        counts[name] += 1
    log("profile", "host time, nested calls included: " + ", ".join(
        f"{name} {ns / 1e6:.0f} ms ({counts[name]})"
        for name, ns in host.most_common(6)))
    launch_count.host_calls = counts
    return launches, busy_ns / 1e6 / wall_ms, wall_ms


def compare_solves(tag, sol, stats, sol_c, stats_c, tol):
    """Card against the CPU run of the same first scenarios."""
    import torch

    n = sol_c.q.shape[0]
    errs = {"q": rel_err(sol.q[:n].cpu(), sol_c.q),
            "cost": rel_err(stats.cost[:n].cpu(), stats_c.cost),
            "tau": rel_err(sol.tau[:n].cpu(), sol_c.tau)}
    same = torch.equal(stats.solver_flag[:n].cpu(), stats_c.solver_flag)
    log("geometry", f"{tag}: card vs CPU, first {n} scenarios: " + ", ".join(
        f"{k} {e:.3e}" for k, e in errs.items())
        + f", flags {'equal' if same else 'DIFFER'} (tol {tol:g})")
    if not (max(errs.values()) <= tol and same):
        raise AssertionError(f"geometry: {tag} disagrees with the CPU")
    return errs


def phase_geometry(seed):
    """The geometry phase on the card; returns the kernel's launches by
    path and the informational numbers."""
    import tempfile

    import numpy as np
    import torch

    from idto_tpu_torch.contact.force import ContactParams
    from idto_tpu_torch.ops import cr_kernel
    from idto_tpu_torch.soa import contact as soa_contact
    from idto_tpu_torch.soa.partials import _jac_rows

    gen = torch.Generator(device="cuda").manual_seed(seed + 3)
    launches, numbers = {}, {}
    # The kernel at the shapes of this phase's launches (R = 1, B = 256):
    # the cheetah's blocks of 19 and the pad's of 7; timed beside its
    # bound, the plain version and a dense library solve.
    for k in (CHEETAH_K, PAD_K):
        numbers[f"kernel_rows{(CHEETAH_N + 1) // 2}_K{2 * k}_R1_"
                f"B{GEOMETRY_BATCH}"] = check_kernel(
            gen, CHEETAH_N, k, GEOMETRY_BATCH, 1, torch.float64, timed=True,
            yardsticks=True)

    # (a) the cheetah with hills, at full width.
    inputs = cheetah_inputs(GEOMETRY_BATCH, seed, "cuda",
                            iters=GEOMETRY_ITERS, hills=HILLS)
    model = inputs[0]
    pairs = [(int(model.geoms.types[a]), int(model.geoms.types[b]))
             for a, b in model.geoms.pairs]
    torch.cuda.reset_peak_memory_stats()
    cr_kernel.launches = 0
    sol, stats, seconds = solve_on("cuda", inputs)
    launches["hills"] = cr_kernel.launches
    peak = torch.cuda.max_memory_allocated() / 2**30
    failed = check_solution(sol, stats, "hills")
    # One warm iteration of the hills and of the plain cheetah, in turns,
    # then one of each under the profiler.
    plain = cheetah_inputs(GEOMETRY_BATCH, seed, "cuda", iters=1)
    hills_one = inputs[:2] + (inputs[2].replace(max_iterations=1),
                              inputs[3])
    warm = {"hills": [], "plain": []}
    for tag in ("plain", "hills", "hills", "plain"):
        warm[tag].append(1e3 * solve_on(
            "cuda", hills_one if tag == "hills" else plain)[2])
    prof = {tag: launch_count(lambda: solve_on("cuda", x)) for tag, x in (
        ("hills", hills_one), ("plain", plain))}
    numbers.update(
        hills_iteration_ms=min(warm["hills"]),
        plain_iteration_ms=min(warm["plain"]),
        hills_first_call_s=seconds,
        hills_launches_per_iteration=prof["hills"][0],
        plain_launches_per_iteration=prof["plain"][0],
        hills_device_busy_share=prof["hills"][1],
        plain_device_busy_share=prof["plain"][1], hills_peak_gib=peak)
    log("geometry", f"(a) mini_cheetah + {HILLS} hills ({len(pairs)} pairs, "
                    f"{pairs.count((1, 3))} box-cylinder) B={GEOMETRY_BATCH} "
                    f"T={inputs[1].num_steps} float64 CR, {GEOMETRY_ITERS} "
                    f"iterations: {seconds:.2f} s (first call); one warm "
                    f"iteration " + " / ".join(
                        f"{x:.1f}" for x in warm["hills"])
                    + " ms against the plain cheetah's " + " / ".join(
                        f"{x:.1f}" for x in warm["plain"])
                    + f" ms; profiled: {prof['hills'][0]} CUDA launches "
                    f"against {prof['plain'][0]}, device busy "
                    f"{100 * prof['hills'][1]:.1f}% against "
                    f"{100 * prof['plain'][1]:.1f}% (profiled walls "
                    f"{prof['hills'][2]:.0f} / {prof['plain'][2]:.0f} ms); "
                    f"peak {peak:.2f} GiB; kernel launches "
                    f"{launches['hills']}; FACTORIZATION_FAILED {failed}; "
                    f"mean cost {stats.cost[:, 0].mean().item():.6e} -> "
                    f"{stats.cost[:, -1].mean().item():.6e}")
    if launches["hills"] != GEOMETRY_ITERS:
        raise AssertionError("geometry: the hills solve missed the kernel")
    ref = cheetah_inputs(GEOMETRY_BATCH, seed, "cpu", iters=GEOMETRY_ITERS,
                         hills=HILLS)
    sol_c, stats_c, sec_c = solve_on("cpu", ref, GEOMETRY_NREF)
    log("geometry", f"(a) CPU reference B={GEOMETRY_NREF}: {sec_c:.2f} s")
    numbers["hills_vs_cpu"] = compare_solves("(a) hills", sol, stats, sol_c,
                                             stats_c, GEOMETRY_RTOL)

    # (b) the hull pad, loaded from a mesh through an SDF file.
    with tempfile.TemporaryDirectory() as directory:
        inputs = pad_inputs(GEOMETRY_BATCH, seed, "cuda", "hull", directory)
        cr_kernel.launches = 0
        sol, stats, seconds = solve_on("cuda", inputs)
        launches["hull_pad"] = cr_kernel.launches
        check_solution(sol, stats, "hull pad")
        box = pad_inputs(GEOMETRY_BATCH, seed, "cuda", "box", directory)
        sol_b, stats_b, sec_b = solve_on("cuda", box)
        ref = pad_inputs(GEOMETRY_BATCH, seed, "cpu", "hull", directory)
        sol_c, stats_c, sec_c = solve_on("cpu", ref, GEOMETRY_NREF)
    numbers["hull_pad_iteration_ms"] = 1e3 * seconds / GEOMETRY_ITERS
    e_box = {"q": rel_err(sol.q, sol_b.q),
             "cost": rel_err(stats.cost, stats_b.cost)}
    numbers["hull_vs_box"] = e_box
    log("geometry", f"(b) hull pad (OBJ <mesh> in SDF -> CONVEX, over a "
                    f"halfspace) B={GEOMETRY_BATCH} T={PAD_T} float64 CR, "
                    f"{GEOMETRY_ITERS} iterations: {seconds:.2f} s (first "
                    f"call); the BOX pad {sec_b:.2f} s; kernel launches "
                    f"{launches['hull_pad']}; mean cost "
                    f"{stats.cost[:, 0].mean().item():.6e} -> "
                    f"{stats.cost[:, -1].mean().item():.6e}; hull vs box on "
                    f"the card: q {e_box['q']:.3e}, cost {e_box['cost']:.3e} "
                    f"(tol {BOX_HULL_RTOL:g}); CPU reference "
                    f"B={GEOMETRY_NREF} {sec_c:.2f} s")
    if launches["hull_pad"] != GEOMETRY_ITERS:
        raise AssertionError("geometry: the pad's solve missed the kernel")
    if not max(e_box.values()) <= BOX_HULL_RTOL:
        raise AssertionError("geometry: the hull pad is not the box pad")
    numbers["hull_pad_vs_cpu"] = compare_solves(
        "(b) hull pad", sol, stats, sol_c, stats_c, GEOMETRY_RTOL)

    # (c) one evaluation of the wrenches and of their exact q partials on a
    # CONVEX-BOX pair, N instances of the pad near the cheetah's ground box.
    rng = np.random.default_rng(seed + 4)
    quat = rng.standard_normal((WRENCH_N, 4)) * [1.0, 0.1, 0.1, 0.1]
    q = np.concatenate([quat / np.linalg.norm(quat, axis=1, keepdims=True),
                        rng.uniform(-0.05, 0.05, (WRENCH_N, 2)),
                        rng.uniform(-0.01, 0.03, (WRENCH_N, 1))], 1).T
    v = 0.2 * rng.standard_normal((6, WRENCH_N))
    contact = ContactParams()
    out = {}
    for device, n in (("cuda", WRENCH_N), ("cpu", WRENCH_NREF)):
        with tempfile.TemporaryDirectory() as directory:
            model = pad_model(device, "hull_box_ground", directory)
        qd, vd = (torch.as_tensor(x[:, :n], device=device) for x in (q, v))

        def wrenches(x):
            return soa_contact.contact_wrenches(model, x, vd, contact)

        def partials():
            return _jac_rows(wrenches, qd, model.nq)

        if device == "cuda":
            ms = cuda_time_ms(lambda: wrenches(qd), 1)
            jac_ms = cuda_time_ms(partials, 1)
            n_launch, busy, _ = launch_count(lambda: wrenches(qd))
            numbers.update(convex_box_wrenches_ms=ms,
                           convex_box_partials_ms=jac_ms,
                           convex_box_wrench_launches=n_launch,
                           convex_box_device_busy_share=busy)
            log("geometry", f"(c) hull pad vs ground box (CONVEX-BOX) "
                            f"N={n}: contact_wrenches {ms:.1f} ms, "
                            f"{n_launch} CUDA launches, device busy "
                            f"{100 * busy:.1f}%; exact q partials "
                            f"({model.nq} tangents) {jac_ms:.1f} ms")
        out[device] = [x[..., :WRENCH_NREF].cpu() for x in
                       (*wrenches(qd), *partials())]
    names = ("torques", "forces", "d_torques", "d_forces")
    errs = {name: rel_err(x, r)
            for name, x, r in zip(names, out["cuda"], out["cpu"])}
    numbers["convex_box_vs_cpu"] = errs
    log("geometry", f"(c) card vs CPU, first {WRENCH_NREF} instances: "
                    + ", ".join(f"{k} {e:.2e}" for k, e in errs.items())
                    + f" (tol {WRENCH_RTOL:g})")
    if float(out["cpu"][1].abs().max()) <= 1.0:
        raise AssertionError("geometry: the pad is not in contact")
    if not max(errs.values()) <= WRENCH_RTOL:
        raise AssertionError("geometry: CONVEX-BOX wrenches disagree")
    return launches, numbers


def long_cheetah_inputs(device, iters, T=PARALLEL_T):
    """mini_cheetah at its YAML settings but for a horizon of T steps (the
    YAML's nominal and guess spread over T), cyclic reduction, float64,
    ``max_iterations=iters``."""
    import dataclasses

    import torch

    from idto_tpu_torch.examples import config, registry
    from idto_tpu_torch.optimizer.problem import LinearSolverType

    model, cfg, _, params, _ = registry.load_example(
        "mini_cheetah", dtype=torch.float64, device=device)
    cfg = dataclasses.replace(cfg, num_steps=T)
    prob = config.build_problem(cfg, model, dtype=torch.float64,
                                device=device)
    q_guess = config.build_initial_guess(cfg, dtype=torch.float64,
                                         device=device)
    params = params.replace(
        linear_solver=LinearSolverType.CYCLIC_REDUCTION,
        check_convergence=False, max_iterations=iters,
    )
    return model, prob, params, q_guess


def timed_collectives():
    """Wrap torch.distributed's all_gather and all_reduce (the only
    collectives of the parallel layer) to add the synchronized host time
    spent in them to ``spent[0]`` and count them in ``spent[1]``; returns
    (spent, restore)."""
    import torch
    import torch.distributed as dist

    spent = [0.0, 0]
    originals = {name: getattr(dist, name)
                 for name in ("all_gather", "all_reduce")}

    def wrap(fn):
        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            spent[0] += time.perf_counter() - t0
            spent[1] += 1
            return out
        return timed

    for name, fn in originals.items():
        setattr(dist, name, wrap(fn))

    def restore():
        for name, fn in originals.items():
            setattr(dist, name, fn)
    return spent, restore


def synced_ms(fn):
    """Host milliseconds of one call of fn, synchronized before and after;
    returns (ms, fn's result)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0), out


def parallel_rank(rank, world, rendezvous, directory, seed):
    """One gloo rank of the parallel phase's world of ``world`` on the one
    card, with CUDA tensors: the scenario-sharded cheetah batch, the
    horizon-sharded systems and the horizon-sharded trust region; writes
    its results to ``directory``/rank{rank}.pt."""
    import torch

    from idto_tpu_torch.ops import cr_kernel
    from idto_tpu_torch.ops.penta import PentaBands
    from idto_tpu_torch.parallel import horizon, multihost
    from idto_tpu_torch.parallel.batching import (
        broadcast_problem,
        make_mesh,
        solve_batch,
        solve_batch_sharded,
    )

    multihost.initialize(rendezvous, world, rank, device="cuda",
                         backend="gloo")
    out = {"backend": torch.distributed.get_backend()}
    smesh = make_mesh(axis="scenario", device="cuda")
    model, prob, params, qg = cheetah_inputs(PARALLEL_BATCH, seed, "cuda",
                                             iters=PARALLEL_ITERS)
    probs = broadcast_problem(prob, PARALLEL_BATCH)
    cr_kernel.launches = 0
    sol, stats, warm, mean_cost = solve_batch_sharded(
        model, probs, params, qg, smesh)
    torch.cuda.synchronize()
    out["batch_launches"] = cr_kernel.launches
    out.update(batch_q=sol.q.cpu(), batch_cost=stats.cost.cpu(),
               batch_flag=stats.solver_flag.cpu(),
               batch_mean_cost=float(mean_cost))
    # The same per-rank solve made single-process: this rank's share alone.
    rows = multihost.axis_group(smesh, "scenario").rows(PARALLEL_BATCH)
    alone, alone_stats, _ = solve_batch(model, broadcast_problem(
        prob, rows.stop - rows.start), params, qg[rows])
    out["share_vs_alone"] = max(
        rel_err(sol.q[rows], alone.q),
        rel_err(stats.cost[rows], alone_stats.cost))
    one = params.replace(max_iterations=1)
    out["batch_iteration_ms"] = [synced_ms(lambda: solve_batch_sharded(
        model, probs, one, qg, smesh))[0] for _ in range(2)]
    del sol, stats, warm, probs

    hmesh = make_mesh(axis="horizon", device="cuda")
    systems = torch.load(os.path.join(directory, "systems.pt"))
    for n, system in systems.items():
        H = PentaBands(**{f: system[f].cuda() for f in "ABCDE"})
        b = system["b"].cuda()
        horizon.solve_sharded(H, b, hmesh)  # warm
        spent, restore = timed_collectives()
        try:
            ms, x = synced_ms(lambda: horizon.solve_sharded(H, b, hmesh))
        finally:
            restore()
        out[f"system_{n}"] = x.cpu()
        out[f"system_{n}_ms"] = ms
        out[f"system_{n}_collective_ms"] = 1e3 * spent[0]
        out[f"system_{n}_collectives"] = spent[1]

    model, prob, params, qg = long_cheetah_inputs("cuda", PARALLEL_ITERS)
    cr_kernel.launches = 0
    sol, stats, _ = horizon.solve_trust_region_horizon_sharded(
        model, prob, params, qg, hmesh)
    torch.cuda.synchronize()
    out["horizon_launches"] = cr_kernel.launches
    out.update(horizon_q=sol.q.cpu(), horizon_cost=stats.cost.cpu())
    one = params.replace(max_iterations=1)
    spent, restore = timed_collectives()
    try:
        ms, _ = synced_ms(lambda: horizon.solve_trust_region_horizon_sharded(
            model, prob, one, qg, hmesh))
    finally:
        restore()
    out.update(horizon_iteration_ms=ms,
               horizon_collective_ms=1e3 * spent[0],
               horizon_collectives=spent[1])
    torch.save(out, os.path.join(directory, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


def phase_parallel(seed):
    """The parallel layer on the card: (a) NCCL at world size 1 in this
    process, (b) gloo at world size 2, both ranks on the one card with CUDA
    tensors; each result held against the same call made single-process on
    the card.  Returns the kernel's launches by path and the numbers."""
    import tempfile

    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    from idto_tpu_torch.ops import cr_kernel, cyclic_reduction, penta
    from idto_tpu_torch.optimizer.solver import solve
    from idto_tpu_torch.parallel import horizon, multihost
    from idto_tpu_torch.parallel.batching import (
        broadcast_problem,
        make_mesh,
        solve_batch,
        solve_batch_sharded,
    )

    phase_t0 = time.perf_counter()
    launches, numbers = {}, {}
    # The kernel at this phase's launch shapes it has not met before, held
    # against its plain version and timed: a rank's share of the batch at
    # world size 2, and the horizon-sharded cheetah at world size 1 (one
    # system of T + 1 block rows).
    gen = torch.Generator(device="cuda").manual_seed(seed + 5)
    for n, B in ((CHEETAH_N, PARALLEL_BATCH // PARALLEL_WORLD),
                 (PARALLEL_T + 1, 1)):
        numbers[f"kernel_rows{(n + 1) // 2}_K{2 * CHEETAH_K}_R1_B{B}"] = \
            check_kernel(gen, n, CHEETAH_K, B, 1, torch.float64, timed=True,
                         yardsticks=True)
    # (a) NCCL, a group of one.
    smesh = make_mesh(axis="scenario", device="cuda")
    backend = dist.get_backend()
    model, prob, params, qg = cheetah_inputs(PARALLEL_BATCH, seed, "cuda",
                                             iters=PARALLEL_ITERS)
    probs = broadcast_problem(prob, PARALLEL_BATCH)
    cr_kernel.launches = 0
    sol, stats, _, mean_cost = solve_batch_sharded(model, probs, params, qg,
                                                   smesh)
    torch.cuda.synchronize()
    launches["parallel_scenario_ws1"] = cr_kernel.launches
    sol1, stats1, _ = solve_batch(model, probs, params, qg)
    check_solution(sol1, stats1, "parallel single-process")
    iters = (stats1.num_iters.long() - 1).clamp_min(0)
    mean1 = float(stats1.cost.gather(1, iters[:, None]).mean())
    e = {"q": rel_err(sol.q, sol1.q), "cost": rel_err(stats.cost, stats1.cost),
         "mean_cost": abs(float(mean_cost) - mean1) / abs(mean1)}
    # A warm iteration, sharded and plain in turns.
    one = params.replace(max_iterations=1)
    warm = {"sharded": [], "plain": []}
    for tag in ("sharded", "plain", "plain", "sharded"):
        warm[tag].append(synced_ms(
            lambda: solve_batch_sharded(model, probs, one, qg, smesh)
            if tag == "sharded" else solve_batch(model, probs, one, qg))[0])
    ws1_ms = warm["sharded"]
    log("parallel", f"(a) {backend}, world 1: the scenario-sharded cheetah "
                    f"B={PARALLEL_BATCH}, {PARALLEL_ITERS} iterations: "
                    f"{launches['parallel_scenario_ws1']} kernel launches; "
                    "against solve_batch: " + ", ".join(
                        f"{k} {v:.3e}" for k, v in e.items())
                    + f" (tol {PARALLEL_RTOL:g}); a warm iteration "
                    + " / ".join(f"{x:.1f}" for x in ws1_ms)
                    + " ms against solve_batch's " + " / ".join(
                        f"{x:.1f}" for x in warm["plain"]) + " ms")
    if launches["parallel_scenario_ws1"] != PARALLEL_ITERS:
        raise AssertionError("parallel: the sharded batch missed the kernel")
    if not max(e.values()) <= PARALLEL_RTOL:
        raise AssertionError("parallel: the sharded batch disagrees")
    numbers.update(ws1_iteration_ms=min(ws1_ms),
                   plain_iteration_ms=min(warm["plain"]), ws1_vs_single=e)
    ref_batch = (sol1.q.cpu(), stats1.cost.cpu(), mean1)
    del sol, stats, sol1, stats1, probs

    hmesh = make_mesh(axis="horizon", device="cuda")
    systems, ref_x = {}, {}
    for n in PARALLEL_SYSTEMS:
        H = random_spd_penta(1, n, CHEETAH_K, torch.float64, gen)
        b = torch.randn((1, n, CHEETAH_K), generator=gen,
                        dtype=torch.float64, device="cuda")
        x = horizon.solve_sharded(H, b, hmesh)
        ref_x[n] = cyclic_reduction.solve(H, b)
        e_single = rel_err(x, ref_x[n])
        msg = (f"(a) solve_sharded T={n - 1} (n={n}, k={CHEETAH_K}) world 1: "
               f"against cyclic_reduction.solve {e_single:.3e}")
        if n == PARALLEL_SYSTEMS[0]:
            dense, bd = dense_solve_inputs(H, b[:, None])
            e_dense = rel_err(x, torch.linalg.solve(dense, bd).reshape(
                b.shape))
            msg += f", against a dense solve {e_dense:.3e}"
            e_single = max(e_single, e_dense)
        log("parallel", msg + f" (tol {PARALLEL_RTOL:g})")
        if not e_single <= PARALLEL_RTOL:
            raise AssertionError("parallel: solve_sharded disagrees")
        systems[n] = {"b": b.cpu(),
                      **{f: getattr(H, f).cpu() for f in "ABCDE"}}

    lmodel, lprob, lparams, lqg = long_cheetah_inputs("cuda", PARALLEL_ITERS)
    cr_kernel.launches = 0
    t0 = time.perf_counter()
    hsol, hstats, _ = horizon.solve_trust_region_horizon_sharded(
        lmodel, lprob, lparams, lqg, hmesh)
    torch.cuda.synchronize()
    h_s = time.perf_counter() - t0
    launches["parallel_horizon_ws1"] = cr_kernel.launches
    fused = solve(lmodel, lprob, lparams, lqg)
    levels = solve(lmodel, lprob, lparams.replace(cr_use_pallas=False), lqg)
    e = rel_err(hsol.q, fused[0].q)
    log("parallel", f"(a) the horizon-sharded cheetah T={PARALLEL_T} "
                    f"(nq={lmodel.nq}) world 1, {PARALLEL_ITERS} iterations: "
                    f"{h_s:.2f} s (first call), "
                    f"{launches['parallel_horizon_ws1']} kernel launches, "
                    f"cost {hstats.cost[0].item():.6e} -> "
                    f"{hstats.cost[-1].item():.6e}; against solve {e:.3e} "
                    f"(tol {PARALLEL_RTOL:g}); the level-wise route against "
                    f"the fused {rel_err(levels[0].q, fused[0].q):.3e}")
    if not (e <= PARALLEL_RTOL and bool(torch.isfinite(hsol.q).all())):
        raise AssertionError("parallel: the horizon-sharded solve disagrees")
    if launches["parallel_horizon_ws1"] != PARALLEL_ITERS:
        raise AssertionError("parallel: the world-1 horizon solve missed "
                             "the kernel")
    ref_h = {"fused": fused[0].q.cpu(), "levels": levels[0].q.cpu()}
    dist.destroy_process_group()
    del hsol, fused, levels
    torch.cuda.empty_cache()

    # (b) gloo, two ranks on the one card.
    with tempfile.TemporaryDirectory() as directory:
        torch.save(systems, os.path.join(directory, "systems.pt"))
        t0 = time.perf_counter()
        ctx = mp.start_processes(
            parallel_rank, args=(PARALLEL_WORLD, f"file://{directory}/rv",
                                 directory, seed),
            nprocs=PARALLEL_WORLD, join=False, start_method="spawn")
        try:
            while not ctx.join(timeout=5):
                if time.perf_counter() - t0 > PARALLEL_DEADLINE:
                    raise AssertionError(f"parallel: the ranks ran past "
                                         f"{PARALLEL_DEADLINE} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
                    p.join(10)
        ranks_s = time.perf_counter() - t0
        ranks = [torch.load(os.path.join(directory, f"rank{r}.pt"))
                 for r in range(PARALLEL_WORLD)]

    errs = {}
    for r, out in enumerate(ranks):
        launches[f"parallel_scenario_ws2_rank{r}"] = out["batch_launches"]
        errs[r] = {
            "share_vs_alone": out["share_vs_alone"],
            **{f"system_T{n - 1}": rel_err(out[f"system_{n}"], ref_x[n].cpu())
               for n in PARALLEL_SYSTEMS},
        }
        whole = {"q": rel_err(out["batch_q"], ref_batch[0]),
                 "cost": rel_err(out["batch_cost"], ref_batch[1]),
                 "mean_cost": abs(out["batch_mean_cost"] - ref_batch[2])
                 / abs(ref_batch[2])}
        h_fused = rel_err(out["horizon_q"], ref_h["fused"])
        h_levels = rel_err(out["horizon_q"], ref_h["levels"])
        log("parallel", f"(b) {out['backend']} rank {r} of {PARALLEL_WORLD} "
                        f"with CUDA tensors: the cheetah batch "
                        f"{PARALLEL_BATCH // PARALLEL_WORLD} a rank, "
                        f"{out['batch_launches']} kernel launches, a warm "
                        "iteration " + " / ".join(
                            f"{x:.1f}" for x in out["batch_iteration_ms"])
                        + " ms; against the single-process run: " + ", ".join(
                            f"{k} {v:.3e}" for k, v in errs[r].items())
                        + f" (tol {PARALLEL_RTOL:g}); the whole batch "
                        "against the world-1 run at B=256: " + ", ".join(
                            f"{k} {v:.3e}" for k, v in whole.items())
                        + f" (tol {WHOLE_BATCH_RTOL:g}); solve_sharded "
                        + ", ".join(
                            f"T={n - 1} {out[f'system_{n}_ms']:.2f} ms, "
                            f"{out[f'system_{n}_collective_ms']:.2f} ms of "
                            f"it in {out[f'system_{n}_collectives']} "
                            "collectives" for n in PARALLEL_SYSTEMS))
        log("parallel", f"(b) rank {r}: the horizon-sharded cheetah "
                        f"T={PARALLEL_T}, {PARALLEL_ITERS} iterations: cost "
                        f"{out['horizon_cost'][0].item():.6e} -> "
                        f"{out['horizon_cost'][-1].item():.6e}, "
                        f"{out['horizon_launches']} kernel launches; q "
                        f"against the single-process solve {h_fused:.3e} "
                        f"(tol {HORIZON_CHEETAH_RTOL:g}), against its "
                        f"level-wise route {h_levels:.3e}; a warm iteration "
                        f"{out['horizon_iteration_ms']:.1f} ms, of it "
                        f"{out['horizon_collective_ms']:.1f} ms in "
                        f"{out['horizon_collectives']} collectives")
        if out["batch_launches"] != PARALLEL_ITERS:
            raise AssertionError(f"parallel: rank {r}'s batch missed the "
                                 "kernel")
        if out["horizon_launches"]:
            raise AssertionError(f"parallel: rank {r}'s horizon-sharded "
                                 "solve launched the fused kernel")
        if not (max(errs[r].values()) <= PARALLEL_RTOL
                and max(whole.values()) <= WHOLE_BATCH_RTOL):
            raise AssertionError(f"parallel: rank {r} disagrees")
        errs[r].update(whole_batch=whole, horizon_vs_fused=h_fused,
                       horizon_vs_levels=h_levels)
        if not (h_fused <= HORIZON_CHEETAH_RTOL
                and bool(torch.isfinite(out["horizon_q"]).all())):
            raise AssertionError(f"parallel: rank {r}'s horizon-sharded "
                                 "cheetah disagrees")
    if not all(torch.equal(ranks[0][k], ranks[1][k])
               for k in ("batch_q", "horizon_q")):
        raise AssertionError("parallel: the ranks' results differ")
    log("parallel", f"(b) two ranks in {ranks_s:.1f} s (start included); "
                    f"the phase {time.perf_counter() - phase_t0:.1f} s")
    numbers.update(
        ws2_iteration_ms=[min(o["batch_iteration_ms"]) for o in ranks],
        ws2_vs_single=errs,
        horizon_iteration_ms=[o["horizon_iteration_ms"] for o in ranks],
        horizon_collective_ms=[o["horizon_collective_ms"]
                                    for o in ranks],
        system_ms={f"T{n - 1}": [o[f"system_{n}_ms"] for o in ranks]
                   for n in PARALLEL_SYSTEMS},
        system_collective_ms={
            f"T{n - 1}": [o[f"system_{n}_collective_ms"] for o in ranks]
            for n in PARALLEL_SYSTEMS},
    )
    return launches, numbers



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


def phase_bench(seed):
    """``bench_torch.run`` on the card, once a linear solver; returns
    {"bench_<solver>": launches} and {solver: its result line}."""
    import math

    import torch

    import bench_torch

    launches, results = {}, {}
    for solver in BENCH_SOLVERS:
        t0 = time.perf_counter()
        result, last_q = bench_torch.run(
            solver, "float64", "cuda", seed, BENCH_BATCHES, BENCH_ITERS,
            BENCH_REPLANS)
        seconds = time.perf_counter() - t0
        numbers = (list(BENCH_KEYS)
                   + [k.format(b) for k in BENCH_BATCH_KEYS
                      for b in BENCH_BATCHES]
                   + [f"solves_per_s_batch{b}" for b in BENCH_BATCHES
                      if b > 1])
        missing = [k for k in ["metric", "unit", "device", "dtype",
                               "linear_solver"] + numbers
                   if k not in result]
        if missing:
            raise AssertionError(f"bench {solver}: keys missing {missing}")
        bad = [k for k in numbers if not (
            isinstance(result[k], (int, float))
            and math.isfinite(result[k]))]
        if bad:
            raise AssertionError(f"bench {solver}: not a finite number: "
                                 + ", ".join(f"{k}={result[k]}"
                                             for k in bad))
        n = result["cr_kernel_launches"]
        # A launch a solve: the warm and timed calls at each batch, the
        # counted call, mpc_initialize, the warm replan and the replans.
        want = (0 if solver == "penta_lu" else
                len(BENCH_BATCHES) * (BENCH_ITERS + 1) + 1
                + BENCH_REPLANS + 2)
        if n != want:
            raise AssertionError(f"bench {solver}: {n} kernel launches, "
                                 f"expected {want}")
        # The same chain of calls at B=8 on the CPU.
        batch = max(BENCH_BATCHES)
        model, _, prob, params, q_guess = bench_torch.load(
            solver, "float64", "cpu")
        probs, qg = bench_torch.batch_inputs(prob, q_guess, batch, seed)
        _, _, out_c, _, _ = bench_torch.measure_batch(
            bench_torch.make_step(model, params), probs, qg, BENCH_ITERS,
            "cpu")
        err = rel_err(last_q[batch].cpu(), out_c[0])
        log("bench", f"{solver}: {seconds:.1f} s, {n} kernel launches, "
                     f"B={batch} q card vs CPU {err:.3e} (tol "
                     f"{BENCH_RTOL[solver]:g}); {json.dumps(result)}")
        if not err <= BENCH_RTOL[solver]:
            raise AssertionError(f"bench {solver}: card and CPU disagree")
        launches[f"bench_{solver}"] = n
        results[solver] = result
        del last_q
        torch.cuda.empty_cache()
    return launches, results


def reference_states(model, q_guess, n, seed):
    """``n`` seeded states near the guess's knots (q, v, a) as CPU float64
    numpy arrays."""
    import numpy as np

    rng = np.random.default_rng(seed)
    g = q_guess.cpu().numpy()
    q = g[rng.integers(0, len(g), n)] + 0.02 * rng.standard_normal(
        (n, model.nq))
    return (q, 0.3 * rng.standard_normal((n, model.nv)),
            0.2 * rng.standard_normal((n, model.nv)))


def aos_physics(model, contact, prob, q, v, a, traj):
    """The AoS pipeline on the states (vmapped) and the partials of one
    trajectory: a dict of tensors, each shaped (states, ...)."""
    from torch.func import vmap

    from idto_tpu_torch.contact import force
    from idto_tpu_torch.models import dynamics, kinematics
    from idto_tpu_torch.optimizer import partials, trajectory_aos

    m = model
    R, p = vmap(lambda x: kinematics.forward_kinematics(m, x))(q)
    qdot = vmap(lambda x, y: kinematics.v_to_qdot(m, x, y))(q, v)
    tq, f = vmap(lambda x, y: force.contact_wrenches(m, x, y, contact))(q, v)
    out = dict(
        fk_R=R, fk_p=p, qdot=qdot,
        v_back=vmap(lambda x, y: kinematics.qdot_to_v(m, x, y))(q, qdot),
        nplus=vmap(lambda x: kinematics.nplus_matrix(m, x))(q),
        tau=vmap(lambda x, y, z: dynamics.inverse_dynamics(m, x, y, z))(
            q, v, a),
        M=vmap(lambda x: dynamics.mass_matrix(m, x))(q),
        qdd=vmap(lambda x, y, z, t, g: dynamics.forward_dynamics(
            m, x, y, z, (t, g)))(q, v, a, tq, f),
        torques=tq, forces=f,
        step_tau=vmap(lambda x, y, z: trajectory_aos.step_tau(
            m, contact, x, y, z))(q, v, a),
    )
    parts = partials.id_partials(m, prob, contact, traj)
    out.update(dqm=parts[0], dqt=parts[1], dqp=parts[2])
    return out


def soa_physics(model, contact, prob, q, v, a, traj):
    """The SoA layer on the same inputs, in the AoS layout."""
    from idto_tpu_torch.soa import contact as soa_contact
    from idto_tpu_torch.soa import dynamics, kinematics, partials

    m = model
    qs, vs, as_ = q.T, v.T, a.T
    R, p = kinematics.forward_kinematics(m, qs)
    qdot = kinematics.v_to_qdot(m, qs, vs)
    tq, f = soa_contact.contact_wrenches(m, qs, vs, contact)
    parts = partials.id_partials_batched(m, prob, contact, traj[None])
    return dict(
        fk_R=R.permute(3, 2, 0, 1), fk_p=p.permute(2, 1, 0), qdot=qdot.T,
        v_back=kinematics.qdot_to_v(m, qs, qdot).T,
        nplus=kinematics.nplus_matrix(m, qs).permute(2, 0, 1),
        tau=dynamics.inverse_dynamics(m, qs, vs, as_).T,
        M=dynamics.mass_matrix(m, qs).permute(2, 0, 1),
        qdd=dynamics.forward_dynamics(m, qs, vs, as_, (tq, f)).T,
        torques=tq.permute(2, 1, 0), forces=f.permute(2, 1, 0),
        step_tau=soa_contact.step_tau(m, contact, qs, vs, as_).T,
        dqm=parts[0][0], dqt=parts[1][0], dqp=parts[2][0],
    )


def physics_errors(x, ref):
    """{key: relative error}; the partials' keys start with "dq"."""
    return {k: rel_err(x[k].cpu(), ref[k].cpu()) for k in ref}


def check_physics(tag, errs):
    bad = {k: e for k, e in errs.items()
           if e > (PARTIALS_RTOL if k.startswith("dq") else PHYSICS_RTOL)}
    log("reference", f"(a) {tag}: worst " + ", ".join(
        f"{k} {e:.2e}" for k, e in sorted(errs.items(),
                                          key=lambda kv: -kv[1])[:4])
        + f" (tol {PHYSICS_RTOL:g}, partials {PARTIALS_RTOL:g})")
    if bad:
        raise AssertionError(f"reference: {tag} disagrees: {bad}")


def compare_runs(tag, a, b, tol):
    """Two unbatched (Solution, Stats, WarmStart) of one problem: equal
    iteration counts and flags, then each field within ``tol`` (rtol,
    atol) by kind, or one relative bound for every field."""
    import torch

    (sa, ta, wa), (sb, tb, wb) = a, b
    if int(ta.num_iters) != int(tb.num_iters) or int(ta.solver_flag) != int(
            tb.solver_flag):
        raise AssertionError(f"reference: {tag}: iterations or flags differ")
    pairs = {"q": (sa.q, sb.q), "tau": (sa.tau, sb.tau),
             "stats": (torch.stack([ta.cost, ta.rho, ta.delta]),
                       torch.stack([tb.cost, tb.rho, tb.delta])),
             "Delta": (wa.Delta, wb.Delta), "dq": (wa.dq, wb.dq)}
    errs, ok = {}, True
    for kind, (x, y) in pairs.items():
        x, y = x.double().cpu(), y.double().cpu()
        errs[kind] = rel_err(x, y)
        if isinstance(tol, dict):
            rtol, atol = tol[kind]
            ok &= bool(((x - y).abs() <= atol + rtol * y.abs()).all())
        elif kind in ("q", "stats"):
            ok &= errs[kind] <= tol
    log("reference", f"{tag}: " + ", ".join(
        f"{k} {e:.2e}" for k, e in errs.items()) + f" (tol {tol})")
    if not ok:
        raise AssertionError(f"reference: {tag} disagrees")
    return errs


def phase_reference(seed):
    """The per-problem (AoS) pipeline on the card; returns the kernel's
    launches by path and the informational numbers."""
    import numpy as np
    import torch
    from torch.func import vmap

    from idto_tpu_torch.geometry import distance
    from idto_tpu_torch.models.model import GeomType
    from idto_tpu_torch.ops import cr_kernel
    from idto_tpu_torch.optimizer import solver
    from idto_tpu_torch.optimizer.problem import LinearSolverType
    from idto_tpu_torch.parallel.batching import broadcast_problem, solve_batch
    from idto_tpu_torch.soa import contact as soa_contact

    gen = torch.Generator(device="cuda").manual_seed(seed + 5)
    # The kernel at this phase's launch shapes: the cheetah's and the
    # hopper's Newton steps and the hopper's Schur solve, at B=1.
    for n, k, R in ((CHEETAH_N, CHEETAH_K, 1),) + CLOSED_LOOP_SHAPES:
        check_kernel(gen, n, k, 1, R, torch.float64)
    launches, numbers = {}, {}

    # (a) physics: AoS against SoA on the card, and card against CPU.
    inputs = {}
    for device in ("cuda", "cpu"):
        model, prob, params, qg = cheetah_inputs(1, seed, device)
        q, v, a = (torch.as_tensor(x, device=device) for x in
                   reference_states(model, qg[0], REFERENCE_STATES, seed))
        inputs[device] = (model, params.contact, prob, q, v, a, qg[0])
    t0 = time.perf_counter()
    aos = aos_physics(*inputs["cuda"])
    torch.cuda.synchronize()
    aos_s = time.perf_counter() - t0
    if float(aos["forces"].abs().max()) < 1.0:
        raise AssertionError("reference: no contact force at the states")
    check_physics(f"AoS vs SoA on the card, {REFERENCE_STATES} states and "
                  f"a T={inputs['cuda'][2].num_steps} trajectory "
                  f"({aos_s:.2f} s)",
                  physics_errors(aos, soa_physics(*inputs["cuda"])))
    check_physics("AoS card vs CPU",
                  physics_errors(aos, aos_physics(*inputs["cpu"])))

    # (b) the per-problem solve against the batch-native one at B=1.
    model, prob, params, qg = cheetah_inputs(1, seed, "cuda",
                                             iters=REFERENCE_ITERS)
    q0 = qg[0]
    solver.solve_trust_region(model, prob, params.replace(max_iterations=1),
                              q0)  # warm-up: the lazy imports of torch.func
    for name, ls in (("thomas", LinearSolverType.PENTA_LU),
                     ("cr", LinearSolverType.CYCLIC_REDUCTION)):
        p = params.replace(linear_solver=ls)
        torch.cuda.synchronize()
        cr_kernel.launches = 0
        t0 = time.perf_counter()
        ref = solver.solve_trust_region(model, prob, p, q0)
        torch.cuda.synchronize()
        ref_s = time.perf_counter() - t0
        n_ref = cr_kernel.launches
        t0 = time.perf_counter()
        nat = solver.solve(model, prob, p, q0)
        torch.cuda.synchronize()
        nat_s = time.perf_counter() - t0
        iters = int(ref[1].num_iters)
        if name == "cr":
            launches["reference_cheetah"] = n_ref
            if n_ref < iters:
                raise AssertionError(f"reference: {n_ref} kernel launches "
                                     f"in {iters} iterations")
        elif n_ref:
            raise AssertionError("reference: Thomas launched the kernel")
        numbers[f"iteration_ms_{name}"] = 1e3 * ref_s / iters
        numbers[f"native_iteration_ms_{name}"] = 1e3 * nat_s / iters
        log("reference", f"(b) mini_cheetah T={prob.num_steps} float64 "
                         f"{name}: per-problem {1e3 * ref_s / iters:.1f} ms "
                         f"an iteration, batch-native B=1 "
                         f"{1e3 * nat_s / iters:.1f} ms ({iters} iterations;"
                         f" kernel launches {n_ref})")
        for sol, stats, _ in (ref, nat):
            check_solution(sol.replace(q=sol.q[None], v=sol.v[None],
                                       tau=sol.tau[None]),
                           stats.replace(**{f: getattr(stats, f)[None]
                                            for f in STATS_ROWS}),
                           f"reference {name}")
        numbers[f"vs_native_{name}"] = compare_runs(
            f"(b) per-problem vs batch-native, {name}", ref, nat,
            REFERENCE_TOL if name == "thomas" else REFERENCE_CR_RTOL)
    # Launches and synchronizations of an iteration, profiled: a
    # 1-iteration solve (its set-up included) less the rollout that closes
    # it (v and tau at the solution).
    from idto_tpu_torch.optimizer import trajectory_aos
    from idto_tpu_torch.soa import rollout

    one = params.replace(linear_solver=LinearSolverType.PENTA_LU,
                         max_iterations=1)
    for tag, fn, closing in (
            ("per_problem", solver.solve_trust_region,
             lambda: trajectory_aos.generalized_forces(
                 model, prob, one.contact, q0)),
            ("native", solver.solve,
             lambda: rollout.generalized_forces(model, prob, one.contact,
                                                q0[None]))):
        counts = []
        for f in (lambda: fn(model, prob, one, q0), closing):
            n_launch, busy, _ = launch_count(f)
            host = launch_count.host_calls
            counts.append((n_launch, sum(host[c] for c in host
                                         if "Synchronize" in c), busy))
        numbers[f"{tag}_launches_1_iteration"] = counts[0][0] - counts[1][0]
        numbers[f"{tag}_syncs_1_iteration"] = counts[0][1] - counts[1][1]
        numbers[f"{tag}_device_busy"] = counts[0][2]
        log("reference", f"(b) {tag}: {counts[0][0] - counts[1][0]} CUDA "
                         f"launches and {counts[0][1] - counts[1][1]} "
                         f"synchronizations in a 1-iteration solve with its "
                         f"set-up (Thomas; the closing rollout's "
                         f"{counts[1][0]} launches and {counts[1][1]} "
                         f"synchronizations taken off); device busy "
                         f"{100 * counts[0][2]:.1f}% of the solve")

    # (c) the constrained hopper: solve_batch(native=False) against True.
    model, prob, params, qg = hopper_inputs(REFERENCE_BATCH, seed, "cuda")
    params = params.replace(max_iterations=REFERENCE_HOPPER_ITERS)
    probs = broadcast_problem(prob, REFERENCE_BATCH)
    torch.cuda.synchronize()
    cr_kernel.launches = 0
    t0 = time.perf_counter()
    per = solve_batch(model, probs, params, qg, native=False)
    torch.cuda.synchronize()
    per_s = time.perf_counter() - t0
    n_per = cr_kernel.launches
    launches["reference_hopper"] = n_per
    nat = solve_batch(model, probs, params, qg, native=True)
    want = 2 * int(per[1].num_iters.sum())
    if n_per != want:
        raise AssertionError(f"reference: hopper per-problem launches "
                             f"{n_per}, expected {want}")
    check_solution(per[0], per[1], "reference hopper", monotone=False)
    errs = {k: rel_err(x.cpu(), y.cpu()) for k, x, y in (
        ("q", per[0].q, nat[0].q), ("tau", per[0].tau, nat[0].tau),
        ("cost", per[1].cost, nat[1].cost),
        ("h_norm", per[1].h_norm, nat[1].h_norm))}
    numbers["hopper_vs_native"] = errs
    numbers["hopper_iteration_ms"] = 1e3 * per_s / int(
        per[1].num_iters.sum())
    log("reference", f"(c) hopper B={REFERENCE_BATCH} CR, per-problem: "
                     f"{per_s:.2f} s, {n_per} launches (R=121 and R=1 an "
                     f"iteration); vs native=True " + ", ".join(
                         f"{k} {e:.2e}" for k, e in errs.items())
                     + f" (tol {REFERENCE_HOPPER_RTOL:g})")
    if not (torch.equal(per[1].num_iters, nat[1].num_iters)
            and max(errs.values()) <= REFERENCE_HOPPER_RTOL):
        raise AssertionError("reference: hopper per-problem disagrees")

    # (d) the hull pad's pair: AoS signed_distance against the SoA kernel.
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        pad = pad_model("cuda", "hull_box_ground", d)
    g = pad.geoms
    ia, ib = g.pairs[0]
    hull, box_t = GeomType.CONVEX, GeomType.BOX
    if (g.types[ia], g.types[ib]) != (hull, box_t):
        raise AssertionError("reference: the pad's pair is not hull-box")
    rng = np.random.default_rng(seed + 6)
    n = REFERENCE_STATES
    quat = np.array([1.0, 0, 0, 0]) + 0.1 * rng.standard_normal((n, 4))
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    pos = np.c_[rng.uniform(-0.1, 0.1, (n, 2)),
                PAD_HALF[2] + rng.uniform(-0.01, 0.01, n)]

    def poses(shift):
        from idto_tpu_torch.models.rotations import quat_to_rot

        qt = torch.as_tensor(quat.T, device="cuda")
        R_a = torch.movedim(quat_to_rot(qt), (0, 1), (-2, -1))
        p_a = torch.as_tensor(pos + shift, device="cuda")
        R_b = g.R[ib].expand(n, 3, 3)
        p_b = g.p[ib].expand(n, 3)
        return R_a, p_a, R_b, p_b

    verts, box = g.verts[ia], g.params[ib]

    # The poses and three copies moved by 1e-13 along each axis, in one
    # evaluation (its time is set by the loops' launches, not by n).
    shifts = np.concatenate([np.zeros((1, 3)), 1e-13 * np.eye(3)])
    R_a, p_a, R_b, p_b = (torch.cat(x) for x in zip(
        *(poses(sh) for sh in shifts)))
    t0 = time.perf_counter()
    all4 = vmap(lambda Ra, pa, Rb, pb: distance.signed_distance(
        hull, verts, Ra, pa, box_t, box, Rb, pb))(R_a, p_a, R_b, p_b)
    torch.cuda.synchronize()
    aos_ms = 1e3 * (time.perf_counter() - t0)
    got = [x[:n] for x in all4]
    spread = [torch.stack([(x[k * n:(k + 1) * n] - x[:n]).abs()
                           for k in (1, 2, 3)]).amax(dim=0) for x in all4]
    R_a, p_a, R_b, p_b = poses(0.0)
    # SoA: one pair (P = 1), the poses on the instance axis.
    soa = soa_contact._pair_distance(
        hull, verts.T[:, :, None, None], R_a.permute(1, 2, 0)[:, :, None],
        p_a.T[:, None], box_t, box[:, None, None],
        R_b.permute(1, 2, 0)[:, :, None], p_b.T[:, None])
    soa = [soa[0][0]] + [x[:, 0].T for x in soa[1:]]
    worst = 0.0
    for x, y, sp in zip(got, soa, spread):
        err = (x - y).abs().reshape(n, -1).amax(dim=1)
        excess = err - 2.0 * sp.reshape(n, -1).amax(dim=1)
        worst = max(worst, float(excess.max()))
    numbers["hull_pair_aos_ms"] = aos_ms
    log("reference", f"(d) hull pad vs ground box, {n} poses (phi "
                     f"{float(got[0].min()):.4f}..{float(got[0].max()):.4f})"
                     f": AoS {aos_ms:.0f} ms for them and their three "
                     f"shifted copies; AoS vs SoA beyond twice the AoS "
                     f"spread {worst:.2e} (tol {HULL_TOL:g})")
    if worst > HULL_TOL:
        raise AssertionError("reference: the hull pair disagrees")
    return launches, numbers


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random systems and q guesses")
    ap.add_argument("--only", default=None, metavar="PHASE",
                    help="after the device and build phases run this one "
                         "phase (kernel, slice, constraints, mpc, fleet, "
                         "closed_loop, options, geometry, parallel, bench, "
                         "reference, times) "
                         "and stop "
                         "without the result lines")
    args = ap.parse_args(argv)

    name, smi = phase_device()
    import torch

    phase_build()
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    if args.only:
        phase = {
            "kernel": lambda: phase_kernel(gen),
            "slice": lambda: phase_slice(SLICE_BATCH, args.seed),
            "constraints": lambda: phase_constraints(SLICE_BATCH, args.seed),
            "mpc": phase_mpc, "fleet": lambda: phase_fleet(args.seed),
            "closed_loop": phase_closed_loop,
            "options": lambda: phase_options(args.seed),
            "geometry": lambda: phase_geometry(args.seed),
            "parallel": lambda: phase_parallel(args.seed),
            "bench": lambda: phase_bench(args.seed),
            "reference": lambda: phase_reference(args.seed),
            "times": lambda: phase_times(args.seed, REPS),
        }[args.only]
        phase()
        log("only", f"{args.only} passed; no result lines")
        return
    seconds = {}

    def timed_phase(name, fn):
        t0 = time.perf_counter()
        out = fn()
        seconds[name] = time.perf_counter() - t0
        log("time", f"the {name} phase: {seconds[name]:.1f} s")
        return out

    max_abs, schur, fleet_shapes, loop_shapes = timed_phase(
        "kernel", lambda: phase_kernel(gen))
    by_path = {"cheetah_slice": timed_phase(
        "slice", lambda: phase_slice(SLICE_BATCH, args.seed))}
    by_path["hopper_constraints"] = timed_phase(
        "constraints", lambda: phase_constraints(SLICE_BATCH, args.seed))
    by_path["mpc_replan"], replan_ms = timed_phase("mpc", phase_mpc)
    by_path["fleet"], fleet_ms = timed_phase(
        "fleet", lambda: phase_fleet(args.seed))
    by_path["closed_loop"], loop_replan_ms, loop_period_ms = timed_phase(
        "closed_loop", phase_closed_loop)
    options_launches, options_times = timed_phase(
        "options", lambda: phase_options(args.seed))
    by_path.update(options_launches)
    geometry_launches, geometry_numbers = timed_phase(
        "geometry", lambda: phase_geometry(args.seed))
    by_path.update(geometry_launches)
    parallel_launches, parallel_numbers = timed_phase(
        "parallel", lambda: phase_parallel(args.seed))
    by_path.update(parallel_launches)
    bench_launches, bench_results = timed_phase(
        "bench", lambda: phase_bench(args.seed))
    by_path.update(bench_launches)
    reference_launches, reference_numbers = timed_phase(
        "reference", lambda: phase_reference(args.seed))
    by_path.update(reference_launches)
    times = timed_phase("times", lambda: phase_times(args.seed, REPS))

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
        # The manipulation examples' Schur and Newton-step launches
        # (float64): rows, K, R and batch in the key.
        "fleet_shapes": fleet_shapes,
        "fleet_iteration_ms": fleet_ms,
        # The hopper loop's two launches a replan (float64, B=1).
        "closed_loop_shapes": loop_shapes,
        "closed_loop_replan_ms": loop_replan_ms,
        "closed_loop_sim_period_ms": loop_period_ms,
        # The options phase (float64, B=1 unless named).
        "options_ms": options_times,
        # The geometry phase: the hills and the hull pad at B=256, the
        # CONVEX-BOX wrenches at N=5120 (float64).
        "geometry": geometry_numbers,
        # The parallel phase (float64): per-rank iterations at world size 1
        # (NCCL) and 2 (gloo on one card), the horizon-sharded cheetah at
        # T=159 and the share of its collectives.
        "parallel": parallel_numbers,
        # The bench phase: bench_torch's result lines at batches 1 and 8
        # (float64), by linear solver.
        "bench": bench_results,
        # The reference phase (float64): the per-problem (AoS) cheetah
        # iteration against the batch-native one at B=1, their launches and
        # synchronizations an iteration, the errors between the two routes.
        "reference": reference_numbers,
        # Host seconds of each phase of this run.
        "phase_seconds": seconds,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
