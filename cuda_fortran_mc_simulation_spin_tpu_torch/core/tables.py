"""Acceptance tables.

Port of the part of ``cuda_fortran_mc_simulation_spin_tpu/core/tables.py``
that the Ising models need.  The reference precomputes exp(-β·ΔE) in a
lookup table; for 2-D Ising ΔE ∈ {-8, -4, 0, 4, 8} and only ΔE = 4 and 8
can reject, so the table collapses to two numbers; in 3-D only ΔE = 4, 8
and 12 can reject, so it collapses to three.  The int8 kernels compare a
uint32 word against these probabilities scaled to 2^32
(:func:`ising3d_accept_thresholds_u32`; the 2-D pair is
ops/ising2d_pallas.accept_thresholds_u32).
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


def ising3d_accept_thresholds_u32(beta: float) -> list[int]:
    """uint32 cutoffs [t4, t8, t12] = round(exp(-4kβ)·2^32), k = 1..3,
    capped at 2^32 - 1, for the ΔE = 4k moves of the 3-D int8 phase
    (flip iff word < t): JAX ``core/tables.ising3d_accept_thresholds_u32``
    (its line 81)."""
    return [int(min(0xFFFFFFFF, round(float(np.exp(-beta * 4.0 * k))
                                      * 4294967296.0)))
            for k in range(1, 4)]
