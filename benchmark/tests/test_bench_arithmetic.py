"""The yardstick's arithmetic: seeded traffic, percentiles, the idle share
from intervals, the trace reduction, the whole-step share and the check
for JAX modules."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from yardstick import imports, stats, trace, traffic


def test_seeded_traffic_repeats_exactly():
    big = 2**31 + 12345

    def kicks(seed):
        k = traffic.Kicks(seed, 1, 18, 0.01, "cpu")
        return torch.stack([k.next() for _ in range(50)])

    a = kicks(big)
    assert torch.equal(a, kicks(big))
    assert not torch.equal(a, kicks(big + 1))
    assert a.shape == (50, 1, 18) and abs(float(a.std()) - 0.01) < 1e-3
    p = traffic.perturbation(big, 256, 19, 0.01)
    assert np.array_equal(p, traffic.perturbation(big, 256, 19, 0.01))
    assert abs(p.std() - 0.01) < 1e-3
    s = traffic.sample(big, 300, 12, (0, 2, 299))
    assert s == traffic.sample(big, 300, 12, (0, 2, 299))
    assert len(s) == 12 and {0, 2, 299} <= set(s) and s == sorted(s)
    assert traffic.sample(big, 3, 12, (0, 2)) == [0, 1, 2]


def test_nearest_rank_percentile():
    xs = list(range(1, 101))
    assert stats.percentile(xs, 95) == 95
    assert stats.percentile(xs[::-1], 95) == 95
    assert stats.percentile([5.0], 95) == 5.0
    assert stats.percentile(list(range(1, 21)), 95) == 19
    with pytest.raises(ValueError):
        stats.percentile([], 95)


def test_idle_share_from_intervals():
    iv = [(0, 2), (1, 3), (5, 6), (9, 12)]
    assert stats.union_length(iv, 0, 10) == 5.0
    assert stats.idle_share_percent(5.0, 10.0) == pytest.approx(50.0)
    assert stats.gaps(iv, 0, 10) == [(6, 9), (3, 5)]


def test_rate_and_mfu():
    assert stats.mfu_percent(6.4e7, 241, 1.0, 67e12) == pytest.approx(
        100 * 6.4e7 * 241 / 67e12)


def test_trace_summary_from_synthetic_events():
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "bench.replan",
         "ts": 0.0, "dur": 50.0},
        {"ph": "X", "cat": "user_annotation", "name": "bench.replan",
         "ts": 50.0, "dur": 150.0},
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 10.0, "dur": 30.0},
        {"ph": "X", "cat": "kernel", "name": "k2", "ts": 20.0, "dur": 40.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 150.0,
         "dur": 10.0},
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 300.0,
         "dur": 10.0},  # outside the stretch
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaStreamSynchronize",
         "ts": 70.0, "dur": 100.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaGraphLaunch",
         "ts": 5.0, "dur": 2.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 60.0,
         "dur": 20.0},
    ]
    s = trace.summarize(ev, ops=2)
    assert s.window_s == pytest.approx(200e-6)
    assert s.busy_s == pytest.approx(60e-6)
    assert s.kernels == 2 and s.host_syncs == 1
    assert s.device_ops[0] == ["k2", pytest.approx(40e-6)]
    assert s.idle_gaps[0] == ["cudaStreamSynchronize", pytest.approx(90e-6)]
    assert stats.idle_share_percent(s.busy_s, s.window_s) == \
        pytest.approx(70.0)


def test_measured_state_interpolates_and_renormalizes():
    q = torch.zeros((1, 3, 7), dtype=torch.float64)
    q[0, :, 0] = 1.0
    q[0, 1, 1] = 1.0  # knot 1: quaternion (1, 1, 0, 0)
    q[0, 1, 4] = 3.0
    v = torch.arange(3, dtype=torch.float64)[None, :, None].expand(1, 3, 6)
    x = traffic.measured_state(q, v, 0.025, 0.05, [0],
                               torch.zeros(1, 6, dtype=torch.float64))
    quat = torch.tensor([1.0, 0.5, 0.0, 0.0], dtype=torch.float64)
    assert torch.allclose(x[0, :4], quat / quat.norm())
    assert x[0, 4] == 1.5 and torch.allclose(x[0, 7:], torch.full((6,), .5,
                                                      dtype=torch.float64))


def test_forbidden_modules_by_whole_top_level_name():
    mods = {"idto_tpu_torch": 1, "idto_tpu_torch.soa": 1, "jaxtyping": 1,
            "numpy": 1}
    assert imports.forbidden_modules(mods) == []
    mods.update({"idto_tpu.models": 1, "jax": 1, "jax._src": 1,
                 "flax.linen": 1, "jaxlib": 1})
    assert imports.forbidden_modules(mods) == [
        "flax.linen", "idto_tpu.models", "jax", "jax._src", "jaxlib"]
