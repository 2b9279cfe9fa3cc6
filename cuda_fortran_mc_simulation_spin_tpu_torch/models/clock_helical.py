"""q-state clock model with helical (skew-periodic) boundaries, in plain
PyTorch.

Port of ``cuda_fortran_mc_simulation_spin_tpu/models/clock_helical.py``:
the reference's flat layout (its committed 501x500 clock geometry), where
site idx neighbours idx±1 and idx±nx modulo nall; odd nx two-colours it by
index parity.  The dataclass, the all-up and random initial states and the
exact flat (m, e) reductions are here, and the JAX model's masked
Metropolis phase (``_phase``, ``sweep``, ``sweep_batched``, its lines
60-95) at every q, the CPU oracle of the physics.  The relaxation main path
runs the bit-sliced packed kernel of ops/clock_helical_multispin.py (q = 6
where its gate takes the shape) or the masked kernel of
ops/helical_pallas.py, both from this model's initial states.
"""

from __future__ import annotations

import dataclasses

import torch

from cuda_fortran_mc_simulation_spin_tpu_torch.core import lattice, rng, tables
from cuda_fortran_mc_simulation_spin_tpu_torch.models.clock import (
    candidates,
    cos_sin,
    random_states,
)
from cuda_fortran_mc_simulation_spin_tpu_torch.ops.trig import f32


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

    def _phase(self, flat: torch.Tensor, offset: int, u_cand: torch.Tensor,
               u_acc: torch.Tensor) -> torch.Tensor:
        """Metropolis update of the sites idx % 2 == offset, every site
        reading the pre-phase state: candidate c + trunc(u_c (q-1)) + 1
        mod q, (cos, sin) from core/tables.py (the JAX select chain's
        values), the field by ``lattice.helical_neighbor_sums``, accept iff
        u_a < exp(-β max(ΔE, 0)), float32 in the JAX model's order."""
        q = self.q
        co, so = tables.state_cos_sin(flat, q)
        hx = lattice.helical_neighbor_sums(co, self.nx)
        hy = lattice.helical_neighbor_sums(so, self.nx)
        new = candidates(flat, u_cand, q)
        cn, sn = tables.state_cos_sin(new, q)
        de = -((cn - co) * hx + (sn - so) * hy)
        p = torch.exp(f32(-self.beta) * torch.clamp_min(de, 0.0))
        mask = lattice.helical_parity_mask(self.nsites, offset, flat.device)
        accept = mask & (u_acc < p)
        return torch.where(accept, new, flat.to(torch.int32)).to(torch.int8)

    def sweep(self, flat: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
        """Both phases with one batch of 2N uniforms a sweep, shared by the
        two phases as the JAX model's sweep shares them."""
        u_cand = rng.uniform(rng.phase_key(key, 0), flat.shape, flat.device)
        u_acc = rng.uniform(rng.phase_key(key, 1), flat.shape, flat.device)
        flat = self._phase(flat, 0, u_cand, u_acc)
        return self._phase(flat, 1, u_cand, u_acc)

    def sweep_batched(self, flat: torch.Tensor, key: torch.Tensor
                      ) -> torch.Tensor:
        """:meth:`sweep` of (R, nall) states, replica r under
        fold_in(key, r)."""
        keys = rng.fold_in(key, torch.arange(flat.shape[0],
                                             dtype=torch.int64))
        return torch.stack([self.sweep(flat[r], keys[r])
                            for r in range(flat.shape[0])])

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
