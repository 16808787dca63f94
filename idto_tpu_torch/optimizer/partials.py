"""Inverse-dynamics partials container (counterpart of
``idto_tpu/optimizer/partials.py:IdPartials``; the batch-native exact
partials are ``soa/partials.py``)."""
from __future__ import annotations

from typing import NamedTuple

import torch


class IdPartials(NamedTuple):
    """d tau_t / d q_{t-1}, d q_t, d q_{t+1}: (..., T, nv, nq) each;
    dtau_dqm[..., 0, :, :] is identically zero (q_{-1} does not exist)."""

    dtau_dqm: torch.Tensor
    dtau_dqt: torch.Tensor
    dtau_dqp: torch.Tensor
