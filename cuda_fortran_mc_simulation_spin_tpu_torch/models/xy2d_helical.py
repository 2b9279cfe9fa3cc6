"""2-D XY with helical (skew-periodic) boundaries on a flat layout, in
plain PyTorch.

Port of ``cuda_fortran_mc_simulation_spin_tpu/models/xy2d_helical.py``:
the reference's flat layout (its xy2d_gpu_m.f90, committed at
10001x10000), where site idx of a (nall,) array neighbours idx+-1 and
idx+-nx modulo nall and the checkerboard phases update idx % 2 == offset;
candidate-angle Metropolis and over-relaxation (reflection about the
normalised local field, then |S| renormalised; the reference's
xy2d_gpu_m.f90:139-213).  With odd nx the index parity
is a two-colouring; even nx is refused.

This masked flat engine is the oracle of the physics: the relaxation main
path runs the dense engines of ops/xy2d_helical_dense.py (component planes)
and ops/xy2d_helical_dense_angle.py (angle planes), which start from this
model's initial states.  The state is a pair of float32 component vectors
(``XYFlatState``), ``([R,] nall)`` each; random draws are Philox under the
caller's key, on the caller's device.  Sums are float64 (the JAX model's
are float32).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from cuda_fortran_mc_simulation_spin_tpu_torch.core import lattice, rng
from cuda_fortran_mc_simulation_spin_tpu_torch.ops import trig

_TWO_PI = 2.0 * np.pi
# floor of |h|² and |S'|² under rsqrt (the JAX model's)
_TINY = 1e-30


class XYFlatState(NamedTuple):
    """Flat helical XY state: the x and y spin components, ([R,] nall)."""

    sx: torch.Tensor
    sy: torch.Tensor


@dataclasses.dataclass(frozen=True)
class XY2DHelical:
    nx: int
    ny: int
    kbt: float

    def __post_init__(self):
        if self.nx % 2 == 0:
            raise ValueError(
                "helical checkerboard updates require odd nx "
                "(the reference commits 10001×10000)"
            )

    @property
    def beta(self) -> float:
        return 1.0 / self.kbt

    @property
    def nsites(self) -> int:
        return self.nx * self.ny

    # -- initial states -----------------------------------------------------
    def init_state(self, kind: str, key: torch.Tensor | None = None,
                   device="cpu", batch: tuple[int, ...] = ()
                   ) -> XYFlatState:
        """``allup`` (every spin along +x) or ``random`` (θ = 2πu, u from
        Philox under phase key 0 of ``key``), float32 vectors of shape
        batch + (nsites,)."""
        shape = tuple(batch) + (self.nsites,)
        if kind == "allup":
            return XYFlatState(
                torch.ones(shape, dtype=torch.float32, device=device),
                torch.zeros(shape, dtype=torch.float32, device=device))
        if kind == "random":
            th = rng.uniform(rng.phase_key(key, 0), shape, device) \
                * trig.f32(_TWO_PI)
            return XYFlatState(torch.cos(th), torch.sin(th))
        raise ValueError(f"unknown init state {kind!r}")

    # -- phases (plain PyTorch; the main path runs the dense engines) -------
    def _fields(self, sx, sy):
        return (lattice.helical_neighbor_sums(sx, self.nx),
                lattice.helical_neighbor_sums(sy, self.nx))

    def _phase(self, sx, sy, offset: int, u_cand, u_acc):
        """One masked Metropolis phase of the sites idx % 2 == offset: the
        candidate (cos 2πu, sin 2πu) replaces S iff u_acc <
        exp(-β max(ΔE, 0)), ΔE = -(S' - S)·h."""
        hx, hy = self._fields(sx, sy)
        ang = u_cand * trig.f32(_TWO_PI)
        cx, cy = torch.cos(ang), torch.sin(ang)
        de = -((cx - sx) * hx + (cy - sy) * hy)
        p = torch.exp(trig.f32(-self.beta) * torch.clamp(de, min=0.0))
        mask = lattice.helical_parity_mask(self.nsites, offset, sx.device)
        accept = mask & (u_acc < p)
        return torch.where(accept, cx, sx), torch.where(accept, cy, sy)

    def sweep(self, state: XYFlatState, key: torch.Tensor) -> XYFlatState:
        """Two checkerboard phases; the reference draws the random batches
        once per MCS, shared by both phases
        (xy2d_gpu_m.f90:139-156)."""
        sx, sy = state
        u_cand = rng.uniform(rng.phase_key(key, 0), sx.shape, sx.device)
        u_acc = rng.uniform(rng.phase_key(key, 1), sx.shape, sx.device)
        sx, sy = self._phase(sx, sy, 0, u_cand, u_acc)
        sx, sy = self._phase(sx, sy, 1, u_cand, u_acc)
        return XYFlatState(sx, sy)

    def over_relax_sweep(self, state: XYFlatState) -> XYFlatState:
        """Reflection with renormalization, offset 0 then offset 1
        (the reference's xy2d_gpu_m.f90:177-213)."""
        sx, sy = state
        tiny = trig.f32(_TINY)
        for offset in (0, 1):
            hx, hy = self._fields(sx, sy)
            inv = torch.rsqrt(torch.maximum(hx * hx + hy * hy, tiny))
            nxh, nyh = hx * inv, hy * inv
            d = trig.f32(2.0) * (sx * nxh + sy * nyh)
            rx, ry = d * nxh - sx, d * nyh - sy
            rinv = torch.rsqrt(torch.maximum(rx * rx + ry * ry, tiny))
            mask = lattice.helical_parity_mask(self.nsites, offset, sx.device)
            sx = torch.where(mask, rx * rinv, sx)
            sy = torch.where(mask, ry * rinv, sy)
        return XYFlatState(sx, sy)

    def sweep_batched(self, state: XYFlatState, key: torch.Tensor
                      ) -> XYFlatState:
        """:meth:`sweep` of (R, nall) states, replica r under
        fold_in(key, r)."""
        nrep = state.sx.shape[0]
        keys = rng.fold_in(key, torch.arange(nrep, dtype=torch.int64))
        outs = [self.sweep(XYFlatState(state.sx[r], state.sy[r]), keys[r])
                for r in range(nrep)]
        return XYFlatState(torch.stack([o.sx for o in outs]),
                           torch.stack([o.sy for o in outs]))

    def over_relax_sweep_batched(self, state: XYFlatState) -> XYFlatState:
        # helical_neighbor_sums rolls the last axis: a batch needs no loop
        return self.over_relax_sweep(state)

    # -- observables ----------------------------------------------------------
    def magne_sums(self, state: XYFlatState):
        """(Σ S_x, Σ S_y) over the last axis, float64."""
        return (state.sx.to(torch.float64).sum(dim=-1),
                state.sy.to(torch.float64).sum(dim=-1))

    def energy_sum(self, state: XYFlatState) -> torch.Tensor:
        """-Σ S(idx)·(S(idx+1) + S(idx+nx)) over the last axis, float64."""
        sx, sy = (p.to(torch.float64) for p in state)
        rx = torch.roll(sx, -1, dims=-1) + torch.roll(sx, -self.nx, dims=-1)
        ry = torch.roll(sy, -1, dims=-1) + torch.roll(sy, -self.nx, dims=-1)
        return -(sx * rx + sy * ry).sum(dim=-1)

    def observables(self, state: XYFlatState) -> dict[str, torch.Tensor]:
        mx, my = self.magne_sums(state)
        return {"m": mx / self.nsites, "my": my / self.nsites,
                "e": self.energy_sum(state) / self.nsites}
