"""CPU-side checks of what ``chip_smoke.py`` and the port's entry points
promise without a card: the kernel's roofline arithmetic, the launch
geometry the records quote, and the default device of the entry points.
"""
import pytest
import torch

import chip_smoke
from idto_tpu_torch import convert
from idto_tpu_torch.examples.registry import load_example


def test_cr_work_is_the_hand_reckoned_count_for_the_cheetah():
    """rows = 11 super-rows of K = 38, one right-hand side, float64."""
    K, rows = 38, 11
    n_bytes, flops = chip_smoke.cr_work(1, rows, K, 1, 8)
    # 11 C, 10 L and 10 U blocks read once (the first row has no L, the
    # last no U); b read and x written once.
    assert n_bytes == (31 * 1444 + 2 * 11 * 38) * 8 == 364_800
    # Levels of 11, 5, 2, 1 rows: 11 inverses; 5 + 2 reduced rows with a
    # row below (6 products) and 1 without (4), less the L' of each level's
    # first reduced row (3) and the U' of the last reduced row of the two
    # levels that end on a row with one below (2); 15 matrix-vector products
    # for the reduced right-hand sides and 26 in the back substitution.
    products = 6 * 7 + 4 * 1 - 3 - 2
    matvecs = (2 * 7 + 1) + (16 + 7 + 2 + 1)
    assert flops == 2 * K**3 * (11 + products) + 2 * K * K * matvecs
    assert flops == 5_825_096
    # The count scales with the batch and the bytes with the item size.
    assert chip_smoke.cr_work(256, rows, K, 1, 8) == (256 * n_bytes,
                                                      256 * flops)
    assert chip_smoke.cr_work(1, rows, K, 1, 4) == (n_bytes // 2, flops)


@pytest.mark.parametrize("batch,itemsize,ms,by", [
    # 4096 systems: 1.494 GB at 3.35 TB/s against 23.9 GFLOP at 66.9
    # TFLOP/s (float64 tensor cores): bytes bind.
    (4096, 8, 4096 * 364_800 / 3.35e12 * 1e3, "bytes"),
    (256, 8, 256 * 364_800 / 3.35e12 * 1e3, "bytes"),
    # float32 halves the bytes and has no faster rate than the FMA pipes'.
    (4096, 4, 4096 * 5_825_096 / 66.9e12 * 1e3, "operations"),
])
def test_cr_bound_ms_takes_the_larger_quotient(batch, itemsize, ms, by):
    bound, bound_by = chip_smoke.cr_bound_ms(batch, 11, 38, 1, itemsize)
    assert bound_by == by
    assert bound == pytest.approx(ms, rel=1e-12)


@pytest.mark.parametrize("rows,barriers", [(1, 2), (2, 4), (11, 8), (81, 14),
                                           (321, 18)])
def test_barrier_chain_counts_the_levels(rows, barriers):
    assert chip_smoke.barrier_chain(rows) == barriers


def test_entry_points_default_to_the_card():
    """Without ``device`` the port asks for the card: with none present
    PyTorch's own error comes up, and nothing lands on the CPU quietly."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works here")
    with pytest.raises((RuntimeError, AssertionError)):
        load_example("pendulum")
    with pytest.raises((RuntimeError, AssertionError)):
        convert.tensor([1.0, 2.0])


def test_entry_points_take_the_cpu_when_asked():
    model, _, prob, _, q_guess = load_example("pendulum", device="cpu")
    assert q_guess.device.type == "cpu"
    assert prob.q_init.device.type == "cpu"
    leaves = [v for v in vars(model).values() if isinstance(v, torch.Tensor)]
    assert leaves and all(v.device.type == "cpu" for v in leaves)
    assert convert.tensor([1.0, 2.0], device="cpu").device.type == "cpu"


def test_cr_work_counts_every_right_hand_side_of_the_schur_solve():
    """The hopper's equality-constraint solve: rows = 21 super-rows of
    K = 10, R = 121 right-hand sides, float64."""
    K, rows, R = 10, 21, 121
    n_bytes, flops = chip_smoke.cr_work(1, rows, K, R, 8)
    # 21 C, 20 L and 20 U blocks; b read and x written once for each of the
    # 121 right-hand sides: 49 KB of bands, 407 KB of vectors.
    assert n_bytes == (61 * 100 + 2 * R * rows * K) * 8 == 455_360
    # Levels of 21, 10, 5, 2, 1 rows.  Reduced rows with a row below: 10,
    # 4, 2, 0; without: 0, 1, 0, 1.  Products 6 and 4 each, less an L' a
    # level and a U' where the last reduced row has a row below (levels 0
    # and 2).  Matrix-vector products: 2 or 1 a reduced row on the way
    # down, n_ev + (n_ev - 1) + n_od a level on the way up.
    products = 6 * 16 + 4 * 2 - 4 - 2
    matvecs = (2 * 16 + 2) + (31 + 14 + 7 + 2 + 1)
    assert flops == 2 * K**3 * (21 + products) + 2 * K * K * R * matvecs
    # The right-hand sides are nine tenths of the work and of the bytes.
    assert 2 * K * K * R * matvecs > 0.9 * flops
    bound, by = chip_smoke.cr_bound_ms(256, rows, K, R, 8)
    assert by == "bytes"
    assert bound == pytest.approx(256 * 455_360 / 3.35e12 * 1e3, rel=1e-12)


def test_smoke_shapes_are_the_examples_own():
    """The Schur shapes chip_smoke.py times are (T + 1, nq, T n_un + 1) of
    the registered examples."""
    shapes = []
    for name in ("hopper", "spinner", "airhockey"):
        model, _, prob, params, _ = load_example(name, device="cpu")
        assert params.equality_constraints
        shapes.append((prob.num_steps + 1, model.nq,
                       prob.num_steps * len(model.unactuated_vdofs) + 1))
    assert tuple(shapes) == chip_smoke.SCHUR_SHAPES
