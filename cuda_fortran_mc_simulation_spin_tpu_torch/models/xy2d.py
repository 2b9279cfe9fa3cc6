"""2-D XY (planar rotor) model, ferromagnetic, J = 1, in plain PyTorch.

Port of the periodic relaxation part of
``cuda_fortran_mc_simulation_spin_tpu/models/xy2d.py``: the state as two
float32 component planes per checkerboard colour (``XYState``: ax, ay,
bx, by, each ``([R,] ny, nx // 2)``, core/lattice.py's layout), the
all-up and random initial states, one Metropolis colour phase with
injected uniforms (candidate (cos 2πu, sin 2πu) from ops/trig.py,
ΔE = -(S' - S)·h, accept iff u < exp(-β max(ΔE, 0))), one over-relaxation
colour phase (reflection about the normalised local field, then |S|
renormalised), the observables and the numpy test oracles.

The relaxation main path runs the CUDA kernels of ops/xy2d_pallas.py,
which start from this model's initial states; :func:`metropolis_update`
and :func:`reflect` are the per-site float32 arithmetic that those
kernels and their plain versions share.  The disorder protocols' parts of
the JAX model (``field_sweep``, ``rotate*``, ``prep_*``,
``autocorrelation_sum``, ``correlation_sum``) come with their slice
(ROADMAP.md queue A item 8).
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


class XYState(NamedTuple):
    """Dual-colour XY state: x/y spin components per colour."""

    ax: torch.Tensor
    ay: torch.Tensor
    bx: torch.Tensor
    by: torch.Tensor


def metropolis_update(sx, sy, hx, hy, u_cand, u_acc, beta: float):
    """New (sx, sy) of one colour given its local field (hx, hy) and the
    site's uniforms: the candidate (cos 2πu_cand, sin 2πu_cand) replaces S
    iff u_acc < exp(-β max(ΔE, 0)), ΔE = -((c_x - s_x) h_x + (c_y - s_y)
    h_y); float32, one rounding per operation in this order."""
    cx, cy = trig.cos_sin_2pi(u_cand)
    de = -((cx - sx) * hx + (cy - sy) * hy)
    p = torch.exp(torch.maximum(de, trig.f32(0.0)) * trig.f32(-beta))
    accept = u_acc < p
    return torch.where(accept, cx, sx), torch.where(accept, cy, sy)


def reflect(sx, sy, hx, hy):
    """Over-relaxation of one colour: S' = 2(S·n̂)n̂ - S about n̂ = h/|h|,
    then S' / |S'|, with rsqrt(max(·, 1e-30)) both times; float32."""
    tiny = trig.f32(_TINY)
    inv = torch.rsqrt(torch.maximum(hx * hx + hy * hy, tiny))
    nxh = hx * inv
    nyh = hy * inv
    d = trig.f32(2.0) * (sx * nxh + sy * nyh)
    rx = d * nxh - sx
    ry = d * nyh - sy
    rinv = torch.rsqrt(torch.maximum(rx * rx + ry * ry, tiny))
    return rx * rinv, ry * rinv


@dataclasses.dataclass(frozen=True)
class XY2D:
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

    # -- initial states ------------------------------------------------------
    def init_state(self, kind: str, key: torch.Tensor | None = None,
                   device="cpu", batch: tuple[int, ...] = ()) -> XYState:
        """``allup`` (every spin along +x, the reference's set_allup_spin)
        or ``random`` (θ = 2πu, u from Philox under phase key 0 for colour
        a and phase key 1 for colour b), float32 planes of shape batch +
        color_shape."""
        shape = tuple(batch) + self.color_shape
        if kind == "allup":
            one = torch.ones(shape, dtype=torch.float32, device=device)
            zero = torch.zeros(shape, dtype=torch.float32, device=device)
            return XYState(one, zero, one.clone(), zero.clone())
        if kind == "random":
            planes = []
            for phase in (0, 1):
                u = rng.uniform(rng.phase_key(key, phase), shape, device)
                theta = u * trig.f32(_TWO_PI)
                planes += [torch.cos(theta), torch.sin(theta)]
            return XYState(*planes)
        raise ValueError(f"unknown init state {kind!r}")

    # -- phases (plain PyTorch; the main path runs ops/xy2d_pallas.py) --------
    def _field(self, ox, oy, color):
        """h = Σ_nbr S for every site of ``color`` (other-colour planes)."""
        return (lattice.neighbor_sums(ox, color),
                lattice.neighbor_sums(oy, color))

    def _phase(self, sx, sy, ox, oy, color, u_cand, u_acc):
        """One Metropolis colour phase with injected uniforms (the
        reference's ``update_sub``, ``xy2d_periodic_gpu_m.f90:368-397``)."""
        hx, hy = self._field(ox, oy, color)
        return metropolis_update(sx, sy, hx, hy, u_cand, u_acc, self.beta)

    def _or_phase(self, sx, sy, ox, oy, color):
        """One over-relaxation colour phase (the reference's
        ``over_relaxation_sub``, ``xy2d_periodic_gpu_m.f90:418-439``)."""
        hx, hy = self._field(ox, oy, color)
        return reflect(sx, sy, hx, hy)

    # -- observables -----------------------------------------------------------
    def magne_sums(self, state: XYState):
        """(Σ S_x, Σ S_y) over the last two axes, float64."""
        def total(a, b):
            return (a.to(torch.float64).sum(dim=(-2, -1))
                    + b.to(torch.float64).sum(dim=(-2, -1)))
        return total(state.ax, state.bx), total(state.ay, state.by)

    def energy_sum(self, state: XYState) -> torch.Tensor:
        """-Σ S·(S_right + S_down) over the last two axes, float64."""
        ax, ay, bx, by = (p.to(torch.float64) for p in state)
        rax, dax, rbx, dbx = lattice.right_down_neighbors(ax, bx)
        ray, day, rby, dby = lattice.right_down_neighbors(ay, by)
        ea = (ax * (rax + dax) + ay * (ray + day)).sum(dim=(-2, -1))
        eb = (bx * (rbx + dbx) + by * (rby + dby)).sum(dim=(-2, -1))
        return -(ea + eb)

    def observables(self, state: XYState) -> dict[str, torch.Tensor]:
        mx, my = self.magne_sums(state)
        return {"m": mx / self.nsites, "my": my / self.nsites,
                "e": self.energy_sum(state) / self.nsites}

    # -- test oracles ------------------------------------------------------------
    def full_vectors(self, state: XYState) -> np.ndarray:
        """(..., ny, nx, 2) float64 spins of the whole lattice."""
        fx = lattice.merge_checkerboard(state.ax, state.bx)
        fy = lattice.merge_checkerboard(state.ay, state.by)
        return torch.stack([fx, fy], dim=-1).cpu().numpy().astype(
            np.float64)

    @staticmethod
    def energy_sum_numpy(full: np.ndarray) -> float:
        """-Σ over the right and down bonds of a (ny, nx, 2) lattice."""
        e = 0.0
        for ax in (0, 1):
            e -= (full * np.roll(full, -1, axis=ax)).sum()
        return float(e)
