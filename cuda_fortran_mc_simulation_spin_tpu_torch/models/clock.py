"""q-state clock model (planar Potts), ferromagnetic, J = 1, in plain
PyTorch.

Port of ``cuda_fortran_mc_simulation_spin_tpu/models/clock.py``: the
dataclass with its q range check, β, the site count and the dual-colour
layout (core/lattice.py), the all-up (every state 0) and random initial
states, and the exact (m, e) reduction of an int8 state: m = Σcos θ / N,
e = −Σ_bonds cos(θ_i − θ_j) / N over the right and down bonds.

The int8 select-chain sweep of the JAX model belongs to its int8 engine,
which the port does not serve yet (ROADMAP.md queue B item 13): the
relaxation main path runs the bit-sliced packed kernels of
ops/clock_planes.py (q = 6, 4, 3), which start from this model's initial
states.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from cuda_fortran_mc_simulation_spin_tpu_torch.core import lattice, rng
from cuda_fortran_mc_simulation_spin_tpu_torch.models.base import (
    CheckerboardState,
)


def random_states(key: torch.Tensor, shape, q: int, device) -> torch.Tensor:
    """int8 states floor(u·q) in [0, q), u from Philox under ``key``."""
    u = rng.uniform(key, shape, device).to(torch.float64)
    return torch.clamp((u * q).to(torch.int64), max=q - 1).to(torch.int8)


def cos_sin(states: torch.Tensor, q: int):
    """(cos, sin) of 2π·c/q in float64."""
    ang = states.to(torch.float64) * (2.0 * math.pi / q)
    return torch.cos(ang), torch.sin(ang)


@dataclasses.dataclass(frozen=True)
class Clock2D:
    nx: int
    ny: int
    kbt: float
    q: int = 6

    def __post_init__(self):
        lattice.LatticeSpec(self.nx, self.ny)  # validates even dims
        if not 2 <= self.q <= 127:
            raise ValueError(f"q={self.q} out of supported range [2, 127]")

    @property
    def beta(self) -> float:
        return 1.0 / self.kbt

    @property
    def nsites(self) -> int:
        return self.nx * self.ny

    @property
    def color_shape(self) -> tuple[int, int]:
        return (self.ny, self.nx // 2)

    def init_state(self, kind: str, key: torch.Tensor | None = None,
                   device="cpu", batch: tuple[int, ...] = ()
                   ) -> CheckerboardState:
        """``allup`` (every state 0, the reference's init_sixclock_order)
        or ``random`` (uniform states under ``key``, colour a from phase
        key 0 and colour b from phase key 1, as the Ising models key
        theirs) of shape batch + color_shape, int8."""
        shape = tuple(batch) + self.color_shape
        if kind == "allup":
            zero = torch.zeros(shape, dtype=torch.int8, device=device)
            return CheckerboardState(zero, zero.clone())
        if kind == "random":
            return CheckerboardState(
                random_states(rng.phase_key(key, 0), shape, self.q, device),
                random_states(rng.phase_key(key, 1), shape, self.q, device))
        raise ValueError(f"unknown init state {kind!r}")

    def magne_sums(self, state: CheckerboardState):
        """(Σ cos θ, Σ sin θ) over the last two axes, float64."""
        ca, sa = cos_sin(state.a, self.q)
        cb, sb = cos_sin(state.b, self.q)
        return (ca.sum(dim=(-2, -1)) + cb.sum(dim=(-2, -1)),
                sa.sum(dim=(-2, -1)) + sb.sum(dim=(-2, -1)))

    def energy_sum(self, state: CheckerboardState) -> torch.Tensor:
        """−Σ_i cos(θ_i − θ_right) + cos(θ_i − θ_down), float64."""
        ca, sa = cos_sin(state.a, self.q)
        cb, sb = cos_sin(state.b, self.q)
        rac, dac, rbc, dbc = lattice.right_down_neighbors(ca, cb)
        ras, das, rbs, dbs = lattice.right_down_neighbors(sa, sb)
        ea = (ca * (rac + dac) + sa * (ras + das)).sum(dim=(-2, -1))
        eb = (cb * (rbc + dbc) + sb * (rbs + dbs)).sum(dim=(-2, -1))
        return -(ea + eb)

    def observables(self, state: CheckerboardState) -> dict[str, torch.Tensor]:
        mx, my = self.magne_sums(state)
        return {"m": mx / self.nsites, "my": my / self.nsites,
                "e": self.energy_sum(state) / self.nsites}
