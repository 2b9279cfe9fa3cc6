"""Acceptance tables.

Port of the part of ``cuda_fortran_mc_simulation_spin_tpu/core/tables.py``
that the Ising models need.  The reference precomputes exp(-β·ΔE) in a
lookup table; for 2-D Ising ΔE ∈ {-8, -4, 0, 4, 8} and only ΔE = 4 and 8
can reject, so the table collapses to two numbers; in 3-D only ΔE = 4, 8
and 12 can reject, so it collapses to three.
"""

from __future__ import annotations

import numpy as np


def ising2d_accept_probs(beta: float) -> tuple[float, float]:
    """(exp(-4β), exp(-8β)): acceptance of the ΔE = 4 and 8 moves."""
    return (float(np.exp(-4.0 * beta)), float(np.exp(-8.0 * beta)))


def ising3d_accept_probs(beta: float) -> tuple[float, float, float]:
    """(exp(-4β), exp(-8β), exp(-12β)): acceptance of ΔE = 4, 8, 12."""
    return (float(np.exp(-4.0 * beta)), float(np.exp(-8.0 * beta)),
            float(np.exp(-12.0 * beta)))
