"""3-D Ising with the reference's helical (skew-periodic) layout, in plain
PyTorch.

Port of ``cuda_fortran_mc_simulation_spin_tpu/models/ising3d_helical.py``:
one flat (nall,) vector whose site idx neighbours idx+-1, idx+-nx and
idx+-nx·ny modulo nall, checkerboarded by index parity.  ±1 always flips
the parity and ±nx does for odd nx (required, as in 2-D); ±nx·ny flips
it only for odd nx·ny.  So:

- odd nx·ny (the reference's 151x151x150 and 501x501x500): all six
  neighbours lie in the other colour and the two phases are exact;
- even nx·ny (its 1001x1000x1000): the z-neighbours share a site's
  colour, and the reference's stride-2 kernel co-updates them (a race
  that drives e(t) positive).  The exact schedule splits each colour
  phase into two z-plane-parity sub-phases, four per MCS, every
  neighbour settled when read; the z-rings then need even nz, so even
  nx·ny with odd nz is refused.

The int8 sweep here is the CPU oracle of the physics; the relaxation main
path runs the bit-packed kernels of ops/helical3d_multispin.py, which start
from this model's initial states and report the same sums.
"""

from __future__ import annotations

import dataclasses

import torch

from cuda_fortran_mc_simulation_spin_tpu_torch.core import lattice, rng, tables


@dataclasses.dataclass(frozen=True)
class Ising3DHelical:
    nx: int
    ny: int
    nz: int
    kbt: float

    def __post_init__(self):
        if self.nx % 2 == 0:
            raise ValueError(
                "helical 3-D checkerboard updates require odd nx (idx "
                "and idx±nx must differ in parity); the reference's "
                "committed helical sizes are odd, e.g. 151/501/1001")
        if self.nsites % 2:
            raise ValueError(
                "helical parity split requires an even site count "
                f"(got {self.nx}x{self.ny}x{self.nz})")
        if self.nxy % 2 == 0 and self.nz % 2:
            raise ValueError(
                "even nx*ny with odd nz has odd z-rings: no exact "
                "checkerboard schedule exists (non-bipartite even "
                "within a parity color); no reference geometry is of "
                f"this shape (got {self.nx}x{self.ny}x{self.nz})")

    @property
    def beta(self) -> float:
        return 1.0 / self.kbt

    @property
    def nxy(self) -> int:
        return self.nx * self.ny

    @property
    def nsites(self) -> int:
        return self.nx * self.ny * self.nz

    @property
    def z_cross_parity(self) -> bool:
        """True when ±nx·ny flips parity (exact two-colouring)."""
        return self.nxy % 2 == 1

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

    # -- one (sub-)phase -----------------------------------------------------
    def _neighbor_sums(self, flat: torch.Tensor) -> torch.Tensor:
        f = flat.to(torch.int32)
        return sum(torch.roll(f, -d, dims=-1) + torch.roll(f, d, dims=-1)
                   for d in (1, self.nx, self.nxy))

    def _phase(self, flat: torch.Tensor, offset: int, u: torch.Tensor,
               zsub: int | None = None) -> torch.Tensor:
        """Metropolis on the sites idx % 2 == offset (and, given ``zsub``,
        z-plane parity == zsub: the exact even-nx·ny sub-phase): flip iff
        ΔE ≤ 0 or u < exp(-β·ΔE), ΔE = 2·s·Σ₆nbr."""
        p4, p8, p12 = (torch.tensor(p, dtype=torch.float32)
                       for p in tables.ising3d_accept_probs(self.beta))
        half_de = flat.to(torch.int32) * self._neighbor_sums(flat)
        thresh = torch.where(half_de == 2, p4,
                             torch.where(half_de == 4, p8, p12))
        accept = (half_de <= 0) | (u < thresh)
        mask = lattice.helical_parity_mask(self.nsites, offset, flat.device)
        if zsub is not None:
            idx = torch.arange(self.nsites, device=flat.device)
            mask = mask & ((idx // self.nxy) % 2 == zsub)
        return torch.where(mask & accept, -flat, flat).to(torch.int8)

    def sweep_with_uniforms(self, flat: torch.Tensor, u: torch.Tensor
                            ) -> torch.Tensor:
        """Offset-0 then offset-1 (each split into z-parity 0 then 1 when
        nx·ny is even), all with the uniforms ``u``: the reference draws
        ONE random batch per MCS for every phase."""
        zsubs = (None,) if self.z_cross_parity else (0, 1)
        for offset in (0, 1):
            for zsub in zsubs:
                flat = self._phase(flat, offset, u, zsub)
        return flat

    def sweep(self, flat: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
        """One MCS under the sweep key ``key``."""
        u = rng.uniform(rng.phase_key(key, 0), flat.shape, flat.device)
        return self.sweep_with_uniforms(flat, u)

    # -- observables ----------------------------------------------------------
    def magne_sum(self, flat: torch.Tensor) -> torch.Tensor:
        """Σ s over the last axis, int64 exact."""
        return flat.to(torch.int64).sum(dim=-1)

    def energy_sum(self, flat: torch.Tensor) -> torch.Tensor:
        """-Σ s(idx)·(s(idx+1) + s(idx+nx) + s(idx+nx·ny)): the three
        forward helical bonds of every site, int64 exact."""
        f = flat.to(torch.int64)
        return -(f * sum(torch.roll(f, -d, dims=-1)
                         for d in (1, self.nx, self.nxy))).sum(dim=-1)

    def observables(self, flat: torch.Tensor) -> dict[str, torch.Tensor]:
        return {
            "m": self.magne_sum(flat).to(torch.float64) / self.nsites,
            "e": self.energy_sum(flat).to(torch.float64) / self.nsites,
        }
