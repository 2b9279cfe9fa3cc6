"""3-D Ising model (±1 spins, ferromagnetic, J=1) in plain PyTorch.

Port of ``cuda_fortran_mc_simulation_spin_tpu/models/ising3d.py``:
checkerboard Metropolis with ΔE = 2·s·Σ₆nbr, where only ΔE ∈ {4, 8, 12}
can reject (the reference's ws(0:6, 0:1) table collapses to the three
thresholds of core/tables.ising3d_accept_probs), all-up and random
initial states, and the magnetisation and bond-energy sums.

Spins are int8 on the dual-colour layout (nz, ny, nx//2), colour =
(x+y+z) & 1 (core/lattice.py); periodic storage needs even nx, ny, nz.
``sweep`` runs the int8 phase kernel (ops/ising3d_pallas.py) on one
volume or a replica batch; the runners measure through the 3-D mode of
ops/ising2d_measure_pallas.py.  ``phase`` is the float-uniform rule of the
JAX model's ``sweep_jnp``.  At packable shapes the relaxation runs the
bit-packed kernels of ops/ising3d_multispin.py, which start from this
model's initial states and report the same sums.
"""

from __future__ import annotations

import dataclasses

import torch

from cuda_fortran_mc_simulation_spin_tpu_torch.core import lattice, rng, tables
from cuda_fortran_mc_simulation_spin_tpu_torch.models.base import (
    CheckerboardState,
)


@dataclasses.dataclass(frozen=True)
class Ising3D:
    nx: int
    ny: int
    nz: int
    kbt: float

    def __post_init__(self):
        if self.nx % 2 or self.ny % 2 or self.nz % 2:
            raise ValueError(
                "periodic 3-D checkerboard storage requires even dims, got "
                f"({self.nx}, {self.ny}, {self.nz})")

    @property
    def beta(self) -> float:
        return 1.0 / self.kbt

    @property
    def nsites(self) -> int:
        return self.nx * self.ny * self.nz

    @property
    def color_shape(self) -> tuple[int, int, int]:
        return (self.nz, self.ny, self.nx // 2)

    # -- initial states -----------------------------------------------------
    def init_state(self, kind: str, key: torch.Tensor | None = None,
                   device="cpu", batch: tuple[int, ...] = ()
                   ) -> CheckerboardState:
        """``allup`` or ``random`` (+1 iff u < 0.5, u from Philox under
        ``key``) colour arrays of shape batch + color_shape, int8."""
        shape = tuple(batch) + self.color_shape
        if kind == "allup":
            one = torch.ones(shape, dtype=torch.int8, device=device)
            return CheckerboardState(one, one.clone())
        if kind == "random":
            ka, kb = rng.phase_key(key, 0), rng.phase_key(key, 1)
            a = torch.where(rng.uniform(ka, shape, device) < 0.5, 1, -1)
            b = torch.where(rng.uniform(kb, shape, device) < 0.5, 1, -1)
            return CheckerboardState(a.to(torch.int8), b.to(torch.int8))
        raise ValueError(f"unknown init state {kind!r}")

    # -- one checkerboard phase ---------------------------------------------
    def phase(self, spins, other, color: int, u) -> torch.Tensor:
        """Flip iff ΔE ≤ 0 or u < exp(-β·ΔE), ΔE = 2·s·Σ₆nbr."""
        p4, p8, p12 = (torch.tensor(p, dtype=torch.float32)
                       for p in tables.ising3d_accept_probs(self.beta))
        k = spins.to(torch.int32) * lattice.neighbor_sums3d(
            other.to(torch.int32), color)           # ΔE/2 ∈ {-6..6}
        thresh = torch.where(k == 2, p4, torch.where(k == 4, p8, p12))
        accept = (k <= 0) | (u < thresh)
        return torch.where(accept, -spins, spins).to(torch.int8)

    def sweep(self, state: CheckerboardState, key: torch.Tensor
              ) -> CheckerboardState:
        """One MCS (colour 0, then colour 1) of (nz, ny, half) or (R, nz,
        ny, half) arrays under the sweep key ``key`` on the int8 phase
        kernel (ops/ising3d_pallas.sweep), updating them in place."""
        from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
            ising3d_pallas,
        )
        return ising3d_pallas.sweep(self, state, key)

    # -- observables ----------------------------------------------------------
    def magne_sum(self, state: CheckerboardState) -> torch.Tensor:
        """Σ s over the last three axes, int64 exact."""
        a, b = state
        dims = (-3, -2, -1)
        return (a.sum(dim=dims, dtype=torch.int64)
                + b.sum(dim=dims, dtype=torch.int64))

    def energy_sum(self, state: CheckerboardState) -> torch.Tensor:
        """-Σ s·(s_x+ + s_y+ + s_z+), int64 exact.  The products are int8
        values in {-3..3} summed in int64, so a large volume needs no
        int64 copy of the state."""
        a, b = state
        (ra, ya, za), (rb, yb, zb) = lattice.right_down_back_neighbors3d(a, b)
        dims = (-3, -2, -1)
        ea = (a * (ra + ya + za)).sum(dim=dims, dtype=torch.int64)
        eb = (b * (rb + yb + zb)).sum(dim=dims, dtype=torch.int64)
        return -(ea + eb)

    def observables(self, state: CheckerboardState) -> dict[str, torch.Tensor]:
        return {
            "m": self.magne_sum(state).to(torch.float64) / self.nsites,
            "e": self.energy_sum(state).to(torch.float64) / self.nsites,
        }
