"""q-state clock model with helical (skew-periodic) boundaries, in plain
PyTorch.

Port of ``cuda_fortran_mc_simulation_spin_tpu/models/clock_helical.py``:
the reference's flat layout (its committed 501x500 clock geometry), where
site idx neighbours idx±1 and idx±nx modulo nall; odd nx two-colours it by
index parity.  The dataclass, the all-up and random initial states and the
exact flat (m, e) reductions are here; the relaxation main path runs the
bit-sliced packed kernel of ops/clock_helical_multispin.py (q = 6), which
starts from this model's initial states.
"""

from __future__ import annotations

import dataclasses

import torch

from cuda_fortran_mc_simulation_spin_tpu_torch.core import rng
from cuda_fortran_mc_simulation_spin_tpu_torch.models.clock import (
    cos_sin,
    random_states,
)


@dataclasses.dataclass(frozen=True)
class Clock2DHelical:
    nx: int
    ny: int
    kbt: float
    q: int = 6

    def __post_init__(self):
        if self.nx % 2 == 0:
            raise ValueError(
                "helical checkerboard updates require odd nx (the "
                "reference commits 501x500)")
        if not 2 <= self.q <= 127:
            raise ValueError(f"q={self.q} out of supported range [2, 127]")

    @property
    def beta(self) -> float:
        return 1.0 / self.kbt

    @property
    def nsites(self) -> int:
        return self.nx * self.ny

    def init_state(self, kind: str, key: torch.Tensor | None = None,
                   device="cpu", batch: tuple[int, ...] = ()
                   ) -> torch.Tensor:
        """``allup`` (all 0) or ``random`` (uniform states under ``key``)
        flat int8 states of shape batch + (nsites,)."""
        shape = tuple(batch) + (self.nsites,)
        if kind == "allup":
            return torch.zeros(shape, dtype=torch.int8, device=device)
        if kind == "random":
            return random_states(rng.phase_key(key, 0), shape, self.q, device)
        raise ValueError(f"unknown init state {kind!r}")

    def magne_sums(self, flat: torch.Tensor):
        c, s = cos_sin(flat, self.q)
        return c.sum(dim=-1), s.sum(dim=-1)

    def energy_sum(self, flat: torch.Tensor) -> torch.Tensor:
        """−Σ cos(θ_idx − θ_idx+1) + cos(θ_idx − θ_idx+nx), float64."""
        c, s = cos_sin(flat, self.q)
        rx = torch.roll(c, -1, dims=-1) + torch.roll(c, -self.nx, dims=-1)
        ry = torch.roll(s, -1, dims=-1) + torch.roll(s, -self.nx, dims=-1)
        return -(c * rx + s * ry).sum(dim=-1)

    def observables(self, flat: torch.Tensor) -> dict[str, torch.Tensor]:
        mx, my = self.magne_sums(flat)
        return {"m": mx / self.nsites, "my": my / self.nsites,
                "e": self.energy_sum(flat) / self.nsites}
