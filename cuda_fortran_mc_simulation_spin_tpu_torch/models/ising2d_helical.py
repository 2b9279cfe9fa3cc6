"""2-D Ising with helical (skew-periodic) boundaries, in plain PyTorch.

Port of ``cuda_fortran_mc_simulation_spin_tpu/models/ising2d_helical.py``:
the reference's flat layout, where site idx of a (nall,) array neighbours
idx+-1 and idx+-nx modulo nall, and the checkerboard phases update
idx % 2 == offset.  With odd nx the index parity is a valid two-colouring
(idx+-1 and idx+-nx always have the other parity), so the reference's
committed 1001x1000 geometry runs unchanged; even nx is refused, because
the idx+-nx neighbour would share the updated parity.

The int8 sweep here is the CPU oracle of the physics; the relaxation main
path runs the bit-packed kernel of ops/helical_multispin.py, which starts
from this model's initial states and reports the same sums.
"""

from __future__ import annotations

import dataclasses

import torch

from cuda_fortran_mc_simulation_spin_tpu_torch.core import lattice, rng, tables


@dataclasses.dataclass(frozen=True)
class Ising2DHelical:
    nx: int
    ny: int
    kbt: float

    def __post_init__(self):
        if self.nx % 2 == 0:
            raise ValueError(
                "helical checkerboard updates require odd nx (idx and "
                "idx±nx must differ in parity); the reference's committed "
                "helical sizes are odd×even, e.g. 1001×1000")

    @property
    def beta(self) -> float:
        return 1.0 / self.kbt

    @property
    def nsites(self) -> int:
        return self.nx * self.ny

    # -- initial states -----------------------------------------------------
    def init_state(self, kind: str, key: torch.Tensor | None = None,
                   device="cpu", batch: tuple[int, ...] = ()
                   ) -> torch.Tensor:
        """``allup`` or ``random`` (+1 iff u < 0.5, u from Philox under
        ``key``) flat int8 spins of shape batch + (nsites,)."""
        shape = tuple(batch) + (self.nsites,)
        if kind == "allup":
            return torch.ones(shape, dtype=torch.int8, device=device)
        if kind == "random":
            u = rng.uniform(rng.phase_key(key, 0), shape, device)
            return torch.where(u < 0.5, 1, -1).to(torch.int8)
        raise ValueError(f"unknown init state {kind!r}")

    # -- one checkerboard phase ---------------------------------------------
    def phase(self, flat: torch.Tensor, offset: int, u: torch.Tensor
              ) -> torch.Tensor:
        """Metropolis update of the sites idx % 2 == offset: flip iff
        ΔE ≤ 0 or u < exp(-β·ΔE), ΔE = 2·s·Σnbr."""
        p4, p8 = tables.ising2d_accept_probs(self.beta)
        nsum = lattice.helical_neighbor_sums(flat.to(torch.int32), self.nx)
        de = 2 * flat.to(torch.int32) * nsum
        thresh = torch.where(de == 4, torch.tensor(p4, dtype=torch.float32),
                             torch.tensor(p8, dtype=torch.float32))
        accept = (de <= 0) | (u < thresh)
        mask = lattice.helical_parity_mask(self.nsites, offset, flat.device)
        return torch.where(mask & accept, -flat, flat).to(torch.int8)

    def sweep_with_uniforms(self, flat: torch.Tensor, u: torch.Tensor
                            ) -> torch.Tensor:
        """Offset-0 phase then offset-1 phase, both with the uniforms
        ``u``: the reference draws ONE random batch per MCS for both
        phases."""
        return self.phase(self.phase(flat, 0, u), 1, u)

    def sweep(self, flat: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
        """One MCS under the sweep key ``key``."""
        u = rng.uniform(rng.phase_key(key, 0), flat.shape, flat.device)
        return self.sweep_with_uniforms(flat, u)

    # -- observables ----------------------------------------------------------
    def magne_sum(self, flat: torch.Tensor) -> torch.Tensor:
        """Σ s over the last axis, int64 exact."""
        return flat.to(torch.int64).sum(dim=-1)

    def energy_sum(self, flat: torch.Tensor) -> torch.Tensor:
        """-Σ s(idx)·(s(idx+1) + s(idx+nx)), int64 exact."""
        f = flat.to(torch.int64)
        return -(f * (torch.roll(f, -1, dims=-1)
                      + torch.roll(f, -self.nx, dims=-1))).sum(dim=-1)

    def observables(self, flat: torch.Tensor) -> dict[str, torch.Tensor]:
        return {
            "m": self.magne_sum(flat).to(torch.float64) / self.nsites,
            "e": self.energy_sum(flat).to(torch.float64) / self.nsites,
        }
