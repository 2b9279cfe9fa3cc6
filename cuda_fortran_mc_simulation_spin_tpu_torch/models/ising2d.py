"""2-D Ising model (±1 spins, ferromagnetic, J=1) in plain PyTorch.

Port of ``cuda_fortran_mc_simulation_spin_tpu/models/ising2d.py``:
checkerboard Metropolis with ΔE = 2·s·Σ_nbr, the two-threshold
acceptance (only ΔE ∈ {4, 8} can reject, core/tables.py), all-up and
random initial states, and the magnetisation and bond-energy sums.

Spins are int8 on the dual-colour layout (core/lattice.py).  ``sweep``
runs the int8 phase kernel (ops/ising2d_pallas.py: the CUDA kernel on
CUDA tensors, its plain version on CPU tensors) on one lattice or a
replica batch, as the JAX model dispatches to its Pallas kernel; the
runners measure through ops/ising2d_measure_pallas.py.  ``phase`` is the
float-uniform rule of the JAX model's ``sweep_jnp``.  At packable shapes
the relaxation runs the bit-packed kernels of ops/ising2d_multispin.py,
which start from this model's initial states and report the same sums.
"""

from __future__ import annotations

import dataclasses

import torch

from cuda_fortran_mc_simulation_spin_tpu_torch.core import lattice, rng, tables
from cuda_fortran_mc_simulation_spin_tpu_torch.models.base import (
    CheckerboardState,
)


@dataclasses.dataclass(frozen=True)
class Ising2D:
    nx: int
    ny: int
    kbt: float

    def __post_init__(self):
        lattice.LatticeSpec(self.nx, self.ny)  # validates even dims

    @property
    def beta(self) -> float:
        return 1.0 / self.kbt

    @property
    def nsites(self) -> int:
        return self.nx * self.ny

    @property
    def color_shape(self) -> tuple[int, int]:
        return (self.ny, self.nx // 2)

    @property
    def accept_table(self) -> tuple[float, float]:
        """exp(-β·ΔE) for ΔE = 4, 8 (ΔE ≤ 0 always accepts)."""
        return tables.ising2d_accept_probs(self.beta)

    # -- initial states -----------------------------------------------------
    def init_state(self, kind: str, key: torch.Tensor | None = None,
                   device="cpu", batch: tuple[int, ...] = ()
                   ) -> CheckerboardState:
        """``allup`` or ``random`` (+1 iff u < 0.5, u from Philox under
        ``key``) colour planes of shape batch + color_shape, int8."""
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
        """Metropolis update of one colour array given the other: flip
        iff ΔE ≤ 0 or u < exp(-β·ΔE), ΔE = 2·s·Σnbr."""
        p4, p8 = self.accept_table
        nsum = lattice.neighbor_sums(other.to(torch.int32), color)
        de = 2 * spins.to(torch.int32) * nsum              # ∈ {-8,...,8}
        thresh = torch.where(de == 4, torch.tensor(p4, dtype=torch.float32),
                             torch.tensor(p8, dtype=torch.float32))
        accept = (de <= 0) | (u < thresh)
        return torch.where(accept, -spins, spins).to(torch.int8)

    def sweep(self, state: CheckerboardState, key: torch.Tensor
              ) -> CheckerboardState:
        """One MCS (colour 0, then colour 1) of (ny, half) or (R, ny, half)
        arrays under the sweep key ``key`` on the int8 phase kernel
        (ops/ising2d_pallas.sweep), updating them in place."""
        from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
            ising2d_pallas,
        )
        return ising2d_pallas.sweep(self, state, key)

    # -- observables ----------------------------------------------------------
    def magne_sum(self, state: CheckerboardState) -> torch.Tensor:
        """Σ s_i over the last two axes, int64 exact."""
        a, b = state
        return (a.to(torch.int64).sum(dim=(-2, -1))
                + b.to(torch.int64).sum(dim=(-2, -1)))

    def energy_sum(self, state: CheckerboardState) -> torch.Tensor:
        """-Σ_i s_i (s_right + s_down), int64 exact."""
        a, b = (s.to(torch.int64) for s in state)
        ra, da, rb, db = lattice.right_down_neighbors(a, b)
        return -((a * (ra + da)).sum(dim=(-2, -1))
                 + (b * (rb + db)).sum(dim=(-2, -1)))

    def observables(self, state: CheckerboardState) -> dict[str, torch.Tensor]:
        return {
            "m": self.magne_sum(state).to(torch.float64) / self.nsites,
            "e": self.energy_sum(state).to(torch.float64) / self.nsites,
        }
