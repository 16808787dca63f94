"""The port's measurement entry points against the JAX package, on the
CPU: ``bench_torch.py`` (the counterpart of ``bench.py``),
``scripts/bench_torch_f32_accept.py`` and ``scripts/bench_torch_linsolve.py``
(``scripts/bench_torch_calibrate_timing.py`` is a card measurement only:
its import is checked here).

  * The bench's inputs, one step and a chain of two (whole and
    micro-batched) against goldens/torch_bench_cheetah.npz: ``bench.py``'s
    step (``solve_batch``, scan-Thomas, one iteration) on the same
    numpy-seeded inputs, two chained calls.  Tolerance 1e-8 on q, cost and
    rho, as tests/test_torch_slice.py holds the slice.
  * The bench's result line: every key of ``bench.py``'s, and the port's.
  * The scaled Gauss-Newton systems of the f32 acceptance against
    goldens/torch_f32_accept.npz (the JAX package's, float64, six iterates
    of mini_cheetah and spinner): relative 1e-10 (the same float64
    arithmetic in another summation order); and the port's level-wise
    cyclic reduction's error, its median over the golden's system and eight
    copies of it within its rounding (lower bands scaled by
    1 + 1e-15 N(0, 1)), no more than 3x the largest error of the JAX one
    over the same nine systems, each against a dense solution refined in
    extended precision, so a drift of the port's reduction away from the
    reference's shows.  One system's error is a draw of its rounding: on
    one system the two reductions' errors stand 0.4x to 4.3x apart, over
    the copies each spans 2.5x to 10x, and the medians stand 0.73x to 3.23x apart
    (the spinner's guess: there the port's block inverses, torch's LU,
    round worse than the JAX package's; with numpy's LAPACK LU in their
    place the port's medians are 0.97x to 1.00x the JAX ones).  The
    cheetah's systems have condition ~1e10: both reductions are 1e-4 to
    0.3 off there, and two plain dense solves differ by 1e-8..1e-7.
  * The linsolve script's routes against a dense solve.
  * None of the four entry points, nor ``chip_smoke.py``, nor any module
    of ``idto_tpu_torch``, imports ``jax`` or ``idto_tpu``.

Regenerate the goldens with
``python scripts/make_torch_goldens.py bench f32_accept``.
"""
import ast
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import bench_torch
from idto_tpu_torch.examples.registry import load_example
from idto_tpu_torch.ops import cr_kernel, cyclic_reduction, penta

# One intra-op thread: these tensors are tiny, and several test workers with
# a thread pool each oversubscribe the cores (a solve is then 5-10x slower).
torch.set_num_threads(1)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _script(name):
    """A module of scripts/, loaded from its file (scripts/ is not a
    package and stays off sys.path)."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(_REPO, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


f32_accept = _script("bench_torch_f32_accept")
linsolve = _script("bench_torch_linsolve")

RTOL = 1e-8  # tests/test_torch_slice.py's
SYSTEM_RTOL = 1e-10
CR_ERROR_FACTOR = 3.0
_GOLDENS = os.path.join(_REPO, "goldens")


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


@pytest.fixture(scope="module")
def golden():
    return np.load(os.path.join(_GOLDENS, "torch_bench_cheetah.npz"))


@pytest.fixture(scope="module")
def cheetah():
    model, _, prob, params, q_guess = bench_torch.load(device="cpu")
    probs, qg = bench_torch.batch_inputs(prob, q_guess, 2, seed=0)
    return model, params, probs, qg


def _assert_call(out, golden, i):
    q, cost, rho, newton = out
    assert _rel(q.numpy(), golden[f"q{i}"]) < RTOL
    assert _rel(cost.numpy(), golden[f"cost{i}"]) < RTOL
    # trust ratios are O(1): absolute
    assert np.abs(rho.numpy() - golden[f"rho{i}"]).max() < RTOL
    assert bool(newton.all())


def test_bench_inputs_and_steps_match_jax_golden(cheetah, golden):
    model, params, probs, qg = cheetah
    np.testing.assert_array_equal(qg.numpy(), golden["q_guess"])
    np.testing.assert_array_equal(
        probs.q_init.numpy(),
        load_example("mini_cheetah", device="cpu")[2].q_init.numpy()
        + golden["dq"])
    step = bench_torch.make_step(model, params)
    out1 = step(probs, qg)
    _assert_call(out1, golden, 1)
    _assert_call(step(probs, out1[0]), golden, 2)


def test_bench_micro_batched_chain_matches_jax_golden(cheetah, golden):
    """One scenario a ``solve_batch`` call, a warm call and one chained
    call: the last output is the golden's second call."""
    model, params, probs, qg = cheetah
    step = bench_torch.make_step(model, params, chunk=1)
    dt, per_call, out, peak, rescued = bench_torch.measure_batch(
        step, probs, qg, 1, "cpu")
    _assert_call(out, golden, 2)
    assert len(per_call) == 1 and dt > 0
    assert peak is None  # no device memory on the CPU
    assert rescued == 0.0  # Thomas has no rescue


def test_bench_result_line_has_the_reference_keys(capsys):
    result = bench_torch.main(["--device", "cpu", "--batches", "1,2",
                               "--iters", "1", "--replans", "1"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(line) == result
    for key in ("metric", "unit", "device", "latency_ms_batch1",
                "solves_per_s_batch2", "flops_per_solve", "measured_tflops",
                "mpc_replan_ms", "value", "vs_baseline",
                "latency_vs_60hz_budget", "power_limit_w", "dtype",
                "linear_solver", "chunk", "newton_share_batch1",
                "newton_share_batch2", "peak_gib_batch1", "peak_gib_batch2",
                "rescue_share_batch1", "rescue_share_batch2",
                "cr_kernel_launches"):
        assert key in result, key
    assert result["device"] == "cpu" and result["power_limit_w"] is None
    assert result["peak_gib_batch2"] is None
    assert result["value"] == result["solves_per_s_batch2"]
    assert result["newton_share_batch1"] == result["newton_share_batch2"] \
        == 1.0
    assert result["cr_kernel_launches"] == 0
    assert result["flops_per_solve"] > 0
    assert result["linear_solver"] == "penta_lu"
    assert result["dtype"] == "float64"


def test_time_chain_feeds_each_call_the_last_output():
    from idto_tpu_torch.utils import timing

    seen = []

    def fn(i, out):
        seen.append((i, out))
        return out + 1

    total, per_call, out = timing.time_chain(fn, 10, 3, "cpu")
    assert seen == [(0, 10), (1, 11), (2, 12)] and out == 13
    assert len(per_call) == 3 and total == sum(per_call)


def test_percentile_leaves_ten_samples_beyond_p80():
    xs = list(range(50, 0, -1))
    assert bench_torch.percentile(xs, 80) == 40
    assert bench_torch.percentile(xs, 50) == 25


_ITERATES = [(name, i) for name in f32_accept.EXAMPLES for i in range(3)]


@pytest.fixture(scope="module")
def accept_golden():
    return np.load(os.path.join(_GOLDENS, "torch_f32_accept.npz"))


@pytest.fixture(scope="module")
def systems(accept_golden):
    """The port's scaled system at each golden iterate, computed once."""
    cache = {}

    def get(name, i):
        if (name, i) not in cache:
            model, _, prob, params, _ = load_example(name, device="cpu")
            q = torch.as_tensor(accept_golden[f"{name}_{i}_q"])
            cache[name, i] = f32_accept.scaled_system(model, prob, params, q)
        return cache[name, i]

    return get


@pytest.mark.parametrize("name,i", _ITERATES)
def test_f32_accept_scaled_system_matches_jax(systems, accept_golden, name,
                                              i):
    Hs, gs = systems(name, i)
    for band in "ABCDE":
        assert _rel(getattr(Hs, band)[0].numpy(),
                    accept_golden[f"{name}_{i}_{band}"]) < SYSTEM_RTOL, band
    assert _rel(gs[0].numpy(), accept_golden[f"{name}_{i}_g"]) < SYSTEM_RTOL


@pytest.mark.parametrize("name,i", _ITERATES)
def test_f32_accept_cr_error_stays_near_jax(accept_golden, name, i):
    """Both reductions on the golden's system, bit for bit, and on the same
    eight copies of it within its rounding, each against a refined dense
    solution: the port's median error no more than 3x the JAX one's
    largest."""
    key = f"{name}_{i}"
    bands = {b: accept_golden[f"{key}_{b}"] for b in "ABCDE"}
    gs = torch.as_tensor(accept_golden[f"{key}_g"])[None]
    copies = np.random.default_rng([f32_accept.EXAMPLES.index(name), i])
    errs = []
    for c in range(1 + f32_accept.PERTURBED_COPIES):
        bc = bands if c == 0 else f32_accept.perturbed_bands(bands, copies)
        Hs = penta.PentaBands(**{b: torch.as_tensor(x)[None]
                                 for b, x in bc.items()})
        x_star = f32_accept.dense_solution(Hs, gs)
        x = cyclic_reduction.solve(Hs, -gs)
        errs.append(float(torch.linalg.vector_norm(x - x_star)
                          / torch.linalg.vector_norm(x_star)))
    jax_errs = accept_golden[f"{key}_cr_errs"]
    assert len(errs) == len(jax_errs)
    assert np.median(errs) <= CR_ERROR_FACTOR * np.max(jax_errs)


def test_f32_accept_measures_every_solver_and_dtype(systems):
    Hs, gs = systems("spinner", 0)
    row = f32_accept.measure(Hs, gs, f32_accept.dense_solution(Hs, gs))
    for s in f32_accept.factored_solvers():
        for d in f32_accept.DTYPES:
            for tag in ("", "_refined"):
                for col in ("relres", "relerr"):
                    assert np.isfinite(row[f"{s}_{d}{tag}_{col}"])
        assert row[f"{s}_float64_relres"] < 1e-9
    summary = f32_accept.summarize([row])
    assert summary["containment_rtol"] == {"float32": 0.25, "float64": 1e-6}
    assert summary["max_healthy_relres_float64"] \
        == row["thomas_float64_relres"]


@pytest.mark.parametrize("route,n,k", [
    ("thomas", 5, 3), ("cr_levels", 5, 3), ("cr_kernel", 5, 3),
    ("cr_hybrid", 131, 2),  # 66 super-rows: levels, then the kernel's tail
])
def test_linsolve_routes_match_dense(route, n, k):
    rng = np.random.default_rng(1)
    H = linsolve.spd_penta_batch(2, n, k, rng, torch.float64, "cpu")
    b = torch.as_tensor(rng.standard_normal((2, n, k)))
    assert route in linsolve.routes_for(n)
    dense = penta.to_dense(H)
    assert torch.allclose(dense, dense.transpose(1, 2))
    assert bool((torch.linalg.eigvalsh(dense) > 0).all())
    x_star = torch.linalg.solve(dense, b.reshape(2, -1, 1)).reshape(b.shape)
    launches = cr_kernel.launches
    x = linsolve.ROUTES[route](H, b)
    assert cr_kernel.launches == launches  # the plain version on the CPU
    assert _rel(x.numpy(), x_star.numpy()) < 1e-10


def test_linsolve_hybrid_only_past_its_tail():
    assert "cr_hybrid" not in linsolve.routes_for(21)
    assert "cr_hybrid" in linsolve.routes_for(161)


_ENTRY_POINTS = ("bench_torch.py", "scripts/bench_torch_f32_accept.py",
                 "scripts/bench_torch_linsolve.py",
                 "scripts/bench_torch_calibrate_timing.py",
                 "scripts/bench_torch_linesearch.py", "chip_smoke.py")
# Every module of the port, the per-problem pipeline's included.
_PORT_MODULES = tuple(sorted(
    os.path.relpath(os.path.join(d, f), _REPO)
    for d, _, files in os.walk(os.path.join(_REPO, "idto_tpu_torch"))
    for f in files if f.endswith(".py")))


def _imported_names(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def _is_jax_side(name):
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "idto_tpu")


def _module_name(path):
    """An entry point imports by its file name from its directory; a
    module of the port by its dotted name."""
    if path.startswith("idto_tpu_torch" + os.sep):
        return os.path.splitext(path)[0].replace(os.sep, ".")
    return os.path.splitext(os.path.basename(path))[0]


@pytest.fixture(scope="module")
def fresh_imports():
    """One fresh interpreter imports every entry point and module in turn;
    after each import it records the JAX-side modules loaded so far.
    Returns {path: that list}."""
    paths = _ENTRY_POINTS + _PORT_MODULES
    dirs = sorted({os.path.dirname(os.path.join(_REPO, p))
                   for p in _ENTRY_POINTS})
    code = (
        "import importlib, json, sys; sys.path[:0] = {!r}; out = {{}}\n"
        "for path, name in {!r}:\n"
        "    importlib.import_module(name)\n"
        "    out[path] = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'idto_tpu')]\n"
        "print(json.dumps(out))"
    ).format([_REPO] + dirs, [(p, _module_name(p)) for p in paths])
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=_REPO)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("path", _ENTRY_POINTS + _PORT_MODULES)
def test_entry_point_imports_neither_jax_nor_idto_tpu(path, fresh_imports):
    """No import statement of the file names them, at any depth, and
    importing it in a fresh interpreter (after the entry points and modules
    listed before it, none of which loaded them) loads neither."""
    full = os.path.join(_REPO, path)
    assert not [n for n in _imported_names(full) if _is_jax_side(n)]
    assert fresh_imports[path] == []
