"""The card a run uses, its power limit, and the published peak the
whole-step share is taken against (copied from ``bench_torch.py::card``)."""
from __future__ import annotations

import subprocess

import torch

# NVIDIA H100 SXM data sheet: FP64 tensor-core peak, dense, at 700 W.
FP64_TENSOR_PEAK_FLOPS = 67e12


def nvidia_smi() -> str | None:
    """The ``nvidia-smi`` line "name, power.limit" of card 0, or None
    where the tool is missing or fails."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return None
    return out[0] if out else None


def device_record(count: int, peak_bytes: int) -> dict:
    """The result line's ``device`` entry."""
    return {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": count,
        "memory_peak_bytes": int(peak_bytes),
    }
