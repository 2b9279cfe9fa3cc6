"""q-state clock model (planar Potts), ferromagnetic, J = 1, in plain
PyTorch.

Port of ``cuda_fortran_mc_simulation_spin_tpu/models/clock.py``: the
dataclass with its q range check, β, the site count and the dual-colour
layout (core/lattice.py), the all-up (every state 0) and random initial
states, and the exact (m, e) reduction of an int8 state: m = Σcos θ / N,
e = −Σ_bonds cos(θ_i − θ_j) / N over the right and down bonds.

The Metropolis phase is :func:`metropolis_update`, the oracle of the JAX
model's ``_phase`` (its lines 104-134): the candidate x + floor(u_c·(q-1))
+ 1 mod q, ΔE = −(S_new − S_x)·h in float32 from the per-state (cos, sin)
of core/tables.py, accept iff u_a < exp(−β·max(ΔE, 0)).  ``sweep`` runs
the int8 phase kernel (ops/clock_pallas.py: the CUDA kernel on CUDA
tensors, its plain version on CPU tensors) on one lattice or a replica
batch, as the JAX model dispatches to its Pallas kernel, and
``observables_batched`` the measure kernel (ops/clock_measure_pallas.py).
The packed kernels of ops/clock_planes.py (q = 6, 4, 3 at the shapes their
gates take) start from this model's initial states too.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from cuda_fortran_mc_simulation_spin_tpu_torch.core import lattice, rng, tables
from cuda_fortran_mc_simulation_spin_tpu_torch.models.base import (
    CheckerboardState,
)
from cuda_fortran_mc_simulation_spin_tpu_torch.ops.trig import f32


def random_states(key: torch.Tensor, shape, q: int, device) -> torch.Tensor:
    """int8 states floor(u·q) in [0, q), u from Philox under ``key``."""
    u = rng.uniform(key, shape, device).to(torch.float64)
    return torch.clamp((u * q).to(torch.int64), max=q - 1).to(torch.int8)


def cos_sin(states: torch.Tensor, q: int):
    """(cos, sin) of 2π·c/q in float64."""
    ang = states.to(torch.float64) * (2.0 * math.pi / q)
    return torch.cos(ang), torch.sin(ang)


def candidates(x: torch.Tensor, u_cand: torch.Tensor, q: int
               ) -> torch.Tensor:
    """int32 candidate states x + floor(u_c·(q-1)) + 1 mod q: never x
    (the reference's clock_tableall_gpu_m.f90:142-143); u_c·(q-1) is one
    float32 product, truncated."""
    off = (u_cand.to(torch.float32) * f32(q - 1)).to(torch.int32) + 1
    new = x.to(torch.int32) + off
    return torch.where(new >= q, new - q, new)


def metropolis_update(x: torch.Tensor, o: torch.Tensor, color: int,
                      u_cand: torch.Tensor, u_acc: torch.Tensor, q: int,
                      beta: float) -> torch.Tensor:
    """The new int8 states of colour ``color`` (..., ny, half) given the
    other colour ``o``: h = Σ_nbr (cos, sin) summed as (up + down) +
    (centre + side) (core/lattice.py), ΔE = −((c_new − c_x)·h_x +
    (s_new − s_x)·h_y) and the acceptance exp(−β·max(ΔE, 0)) against
    u_acc, each a float32 operation in the JAX model's order."""
    co, so = tables.state_cos_sin(o, q)
    return update_in_field(x, lattice.neighbor_sums(co, color),
                           lattice.neighbor_sums(so, color), u_cand, u_acc,
                           q, beta)


def update_in_field(x: torch.Tensor, hx: torch.Tensor, hy: torch.Tensor,
                    u_cand: torch.Tensor, u_acc: torch.Tensor, q: int,
                    beta: float) -> torch.Tensor:
    """:func:`metropolis_update` given the float32 field (hx, hy) of the
    sites (a shard's comes from its halos)."""
    new = candidates(x, u_cand, q)
    cx, sx = tables.state_cos_sin(x, q)
    cn, sn = tables.state_cos_sin(new, q)
    de = -((cn - cx) * hx + (sn - sx) * hy)
    p = torch.exp(f32(-beta) * torch.clamp_min(de, 0.0))
    return torch.where(u_acc < p, new, x.to(torch.int32)).to(torch.int8)


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

    # -- one checkerboard phase ---------------------------------------------
    def _phase(self, x, o, color: int, u_cand, u_acc) -> torch.Tensor:
        """Metropolis update of one colour given the other, with injected
        uniforms (:func:`metropolis_update`; JAX ``_phase``)."""
        return metropolis_update(x, o, color, u_cand, u_acc, self.q,
                                 self.beta)

    def sweep(self, state: CheckerboardState, key: torch.Tensor
              ) -> CheckerboardState:
        """One MCS (colour 0, then colour 1) of (ny, half) or (R, ny, half)
        arrays under the sweep key ``key`` on the int8 phase kernel
        (ops/clock_pallas.sweep), updating them in place."""
        from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
            clock_pallas,
        )
        return clock_pallas.sweep(self, state, key)

    # -- observables ----------------------------------------------------------
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

    def observables_batched(self, state: CheckerboardState
                            ) -> dict[str, torch.Tensor]:
        """{m, my, e} float64 (R,) of a replica batch through the measure
        kernel (ops/clock_measure_pallas.measure; JAX
        ``observables_batched``)."""
        from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
            clock_measure_pallas,
        )
        return clock_measure_pallas.measure(self, state)
