"""Contact model parameters (counterpart of ``idto_tpu/contact/force.py``;
the force law itself lives in ``soa/contact.py``)."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ContactParams:
    stiffness: float = 100.0  # k, N/m
    smoothing_factor: float = 0.01  # sigma, m
    dissipation_velocity: float = 0.1  # m/s
    stiction_velocity: float = 0.05  # vs, m/s
    friction_coefficient: float = 0.5  # mu
