"""The benchmark's plain reference for the port's tests.

Importing this module puts ``benchmark/`` on ``sys.path``, so that a test
then imports the benchmark's plain reference (``benchmark/reference/``:
plain PyTorch, no JAX) and its yardstick as the benchmark imports them.
"""
import json
import os
import sys

BENCH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmark")
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)


def punyo_config():
    """punyo's configuration as the plain reference reads it (the YAML's
    values, its URDF copy), a fresh copy for each call."""
    with open(os.path.join(BENCH, "tests", "fixtures", "punyo.json")) as f:
        return json.load(f)


def punyo_contact(config=None):
    """The contact parameters of the plain reference's physics, from the
    YAML's solver values."""
    solver = (config or punyo_config())["solver"]
    contact = {k: solver[k] for k in (
        "dissipation_velocity", "smoothing_factor", "friction_coefficient",
        "stiction_velocity")}
    contact["stiffness"] = solver["contact_stiffness"]
    return contact
