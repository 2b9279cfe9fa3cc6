"""Acceptance tables and the clock's per-state (cos, sin).

Port of ``cuda_fortran_mc_simulation_spin_tpu/core/tables.py`` (its
``clock_bond_energy_table`` and ``state_select`` aside: the port gathers
from the q-entry table where JAX selects).  The reference precomputes
exp(-β·ΔE) in a lookup table; for 2-D Ising ΔE ∈ {-8, -4, 0, 4, 8} and
only ΔE = 4 and 8 can reject, so the table collapses to two numbers; in
3-D only ΔE = 4, 8 and 12 can reject, so it collapses to three.  The
int8 kernels compare a uint32 word against these probabilities scaled to
2^32 (:func:`ising3d_accept_thresholds_u32`; the 2-D pair is
ops/ising2d_pallas.accept_thresholds_u32).
"""

from __future__ import annotations

import functools

import numpy as np
import torch


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


# ---------------------------------------------------------------------------
# the q-state clock: per-state (cos, sin) (JAX core/tables.py:25-78)
# ---------------------------------------------------------------------------

# the JAX package's select chains hold q table entries up to this q; past
# it both packages evaluate ops/trig.cos_sin_2pi (no cap on q)
_SELECT_CHAIN_MAX_Q = 16


def clock_unit_vectors(q: int) -> np.ndarray:
    """(q, 2) float64 table of (cos, sin)(2π s / q), JAX
    ``clock_unit_vectors``."""
    ang = 2.0 * np.pi * np.arange(q) / q
    return np.stack([np.cos(ang), np.sin(ang)], axis=1)


@functools.lru_cache(maxsize=None)
def clock_cos_sin_table(q: int) -> torch.Tensor:
    """(2, q) float32 (cos, sin) of each state s in [0, q), the values JAX
    ``state_cos_sin`` gives it: the float64 unit vectors rounded once to
    float32 (its select chain) for q <= 16, else ``cos_sin_2pi(s·(1/q))``
    in float32 (its direct evaluation).  For q = 2 the sin of state 1 is
    float32(sin π) = 1.2e-16, not 0, as there.  Cached: never write to
    it."""
    if q <= _SELECT_CHAIN_MAX_Q:
        return torch.from_numpy(
            clock_unit_vectors(q).T.astype(np.float32).copy())
    from cuda_fortran_mc_simulation_spin_tpu_torch.ops import trig

    s = torch.arange(q, dtype=torch.float32) * trig.f32(1.0 / q)
    return torch.stack(trig.cos_sin_2pi(s))


def clock_sums_table(q: int) -> torch.Tensor:
    """(2, q) float64 (cos, sin)(2π s / q) of the clock's float64 sums
    (ops/clock_measure_pallas.py), with the quarter turns exact: cos and
    sin are 0 or ±1 where 4s is a multiple of q, so q = 2 and 4 give
    integer terms, summed exactly in any order."""
    tab = clock_unit_vectors(q).T.copy()
    quarter = (4 * np.arange(q)) % q == 0
    tab[:, quarter] = np.round(tab[:, quarter])
    return torch.from_numpy(tab)


def state_cos_sin(state: torch.Tensor, q: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos θ, sin θ) float32 of clock states θ = 2π·state/q: a gather
    from :func:`clock_cos_sin_table` (what JAX's select chain or direct
    evaluation gives, bitwise)."""
    tab = clock_cos_sin_table(q).to(state.device)
    idx = state.to(torch.int64)
    return tab[0][idx], tab[1][idx]
