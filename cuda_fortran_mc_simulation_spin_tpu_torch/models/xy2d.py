"""2-D XY (planar rotor) model, ferromagnetic, J = 1, in plain PyTorch.

Port of the periodic relaxation part of
``cuda_fortran_mc_simulation_spin_tpu/models/xy2d.py``: the state as two
float32 component planes per checkerboard colour (``XYState``: ax, ay,
bx, by, each ``([R,] ny, nx // 2)``, core/lattice.py's layout), the
all-up and random initial states, one Metropolis colour phase with
injected uniforms (candidate (cos 2πu, sin 2πu) from ops/trig.py,
ΔE = -(S' - S)·h, accept iff u < exp(-β max(ΔE, 0))), one over-relaxation
colour phase (reflection about the normalised local field, then |S|
renormalised), the observables and the numpy test oracles; and the
disorder protocols' parts: the field-only sweep of the preparations
(``field_sweep``), the global rotations, the finite- and small-magnetisation
preparations and the autocorrelation and two-point correlation sums.

The relaxation main path runs the CUDA kernels of ops/xy2d_pallas.py,
which start from this model's initial states; :func:`metropolis_update`
and :func:`reflect` are the per-site float32 arithmetic that those
kernels and their plain versions share.  The preparations run once a
sample and are plain PyTorch on the device, batched over replicas
(leading axis R): each replica carries its own key, field and
convergence mask, so its prepared state does not depend on the batch it
sits in, and the loop syncs with the host once an iteration.  The port's
sums are float64 (JAX's float32), so rotation angles and the
preparations' convergence tests read float64 magnetisations.
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

    def random_states(self, keys: torch.Tensor, device="cpu") -> XYState:
        """A batch of ``random`` states, replica r drawn under keys[r]
        ((R, 2) keys) exactly as :meth:`init_state` draws it alone."""
        states = [self.init_state("random", k, device=device) for k in keys]
        return XYState(*(torch.stack(p) for p in zip(*states)))

    # -- field-only Metropolis (init-state preparation) ------------------------
    @staticmethod
    def field_uniforms(keys: torch.Tensor, shape, device=None):
        """(u_cand_a, u_acc_a, u_cand_b, u_acc_b), each (R,) + shape
        float32, of one field sweep of R replicas under their keys ((R, 2)):
        colour c draws words 0 and 1 of the Philox counter (0, row, column,
        0) under fold_in(key, c), top 24 bits.  (The JAX model draws four
        threefry planes; the two packages' bits differ.)"""
        ny, half = shape
        y = torch.arange(ny, dtype=torch.int64, device=device).view(ny, 1)
        x = torch.arange(half, dtype=torch.int64, device=device).view(1, half)
        y, x = torch.broadcast_tensors(y, x)
        zero = torch.zeros_like(y)
        ctr = torch.stack([zero, y, x, zero], dim=-1)
        out = []
        for c in (0, 1):
            k = rng.fold_in(keys.to(device), c).view(-1, 1, 1, 2)
            words = rng.philox4x32(ctr, k)
            out += [rng.bits_to_uniform(words[..., 0]),
                    rng.bits_to_uniform(words[..., 1])]
        return tuple(out)

    def field_sweep(self, state: XYState, keys: torch.Tensor, hx, hy,
                    uniforms=None) -> XYState:
        """One sweep coupling only to the external field (hx, hy), per
        replica ((R,) float32 or scalars): the preparation dynamics of the
        reference's metropolis_by_field_sub
        (xy2d_periodic_gpu_m.f90:198-216), JAX ``field_sweep``.  The
        reference's (non-Metropolis) acceptance u <= 1 - exp(ΔE),
        ΔE = -h·(S' - S), on all sites at once (the field has no neighbour
        term, so there is no race), the candidate (cos 2πu, sin 2πu) from
        torch.cos / torch.sin as JAX takes jnp.cos / jnp.sin.  Uniforms
        from :meth:`field_uniforms` under ``keys``, or injected
        (``uniforms``: the four planes)."""
        ax = state.ax
        if uniforms is None:
            uniforms = self.field_uniforms(keys, ax.shape[-2:], ax.device)
        lead = (-1,) + (1,) * 2

        def as_field(h):
            h = torch.as_tensor(h, dtype=torch.float32, device=ax.device)
            return h.view(lead) if h.dim() else h

        hx, hy = as_field(hx), as_field(hy)
        one = trig.f32(1.0)

        def upd(sx, sy, u_cand, u_acc):
            ang = u_cand * trig.f32(_TWO_PI)
            cx, cy = torch.cos(ang), torch.sin(ang)
            de = -(hx * (cx - sx) + hy * (cy - sy))
            accept = u_acc <= one - torch.exp(de)
            return torch.where(accept, cx, sx), torch.where(accept, cy, sy)

        ax, ay = upd(state.ax, state.ay, uniforms[0], uniforms[1])
        bx, by = upd(state.bx, state.by, uniforms[2], uniforms[3])
        return XYState(ax, ay, bx, by)

    # -- global rotation ---------------------------------------------------------
    def rotate(self, state: XYState, theta) -> XYState:
        """Rotate every spin by theta (per replica, (R,) or a scalar;
        rotate_whole_spin_theta_sub, xy2d_periodic_gpu_m.f90:281-293):
        the exact 2-D rotation with float32 cos and sin of the float64
        angle."""
        theta = torch.as_tensor(theta, dtype=torch.float64,
                                device=state.ax.device)
        c = torch.cos(theta).to(torch.float32)
        s = torch.sin(theta).to(torch.float32)
        if theta.dim():
            c, s = c.view(-1, 1, 1), s.view(-1, 1, 1)
        ax, ay, bx, by = state
        return XYState(c * ax - s * ay, s * ax + c * ay,
                       c * bx - s * by, s * bx + c * by)

    def magne_angle(self, state: XYState) -> torch.Tensor:
        """atan2(Σ S_y, Σ S_x), float64, per replica."""
        mx, my = self.magne_sums(state)
        return torch.atan2(my, mx)

    def rotate_magne_toward_xaxis(self, state: XYState) -> XYState:
        """Rotate all spins so Σ S_y = 0 and Σ S_x >= 0
        (xy2d_periodic_gpu_m.f90:219-232)."""
        return self.rotate(state, -self.magne_angle(state))

    def rotate_magne_toward_xaxis_updown_randomly(
            self, state: XYState, keys: torch.Tensor) -> XYState:
        """As above, but align m with +x or -x with probability 1/2 per
        replica, the coin from word 0 of Philox counter 0 under its key
        (the _updown_randomly variant, xy2d_periodic_gpu_m.f90:253-279)."""
        theta = self.magne_angle(state)
        coin = rng.bits_to_uniform(rng.philox4x32(
            torch.zeros(4, dtype=torch.int64), keys)[..., 0])
        flip = (coin < 0.5).to(theta.device)
        return self.rotate(state, -torch.where(flip, theta + np.pi, theta))

    # -- preparation protocols -----------------------------------------------------
    def _densities(self, state: XYState):
        mx, my = self.magne_sums(state)
        return mx / self.nsites, my / self.nsites

    @staticmethod
    def _where(mask, new: XYState, old: XYState) -> XYState:
        m = mask.view(-1, 1, 1)
        return XYState(*(torch.where(m, a, b) for a, b in zip(new, old)))

    def prep_finite_magne(self, keys: torch.Tensor, m0: float,
                          eps: float = 1e-2, max_iter: int = 64,
                          device="cpu") -> XYState:
        """set_finite_magne_spin (xy2d_periodic_gpu_m.f90:126-152) as the
        JAX model redesigns it, for R replicas keyed by keys ((R, 2)): a
        random base state (its colours drawn under phase keys 0 and 1 of
        the key); stage 1 doubles the field from 1 until one field sweep
        of the base overshoots |m| = m0 (cap 2^16, 24 steps), then bisects
        it (key fold_in(phase_key(key, 2), it)) until |m| is within eps·m0
        or max_iter; stage 2, where that fails, iterates damped field
        sweeps along m on the evolving state (key fold_in(phase_key(key,
        3), it), at most 512); then rotates m onto +x.  Every replica runs
        its own loop under a mask."""
        base = self.random_states(keys, device)
        nrep = keys.shape[0]
        k0 = rng.phase_key(keys, 2)
        f32 = dict(dtype=torch.float32, device=device)
        i64 = dict(dtype=torch.int64, device=device)

        def mabs_after(f, it):
            st = self.field_sweep(base, rng.fold_in(k0, it.cpu()), f, 0.0)
            mx, my = self._densities(st)
            return torch.hypot(mx, my), st

        # grow hi until the response overshoots m0
        hi = torch.ones(nrep, **f32)
        it = torch.zeros(nrep, **i64)
        active = torch.ones(nrep, dtype=torch.bool, device=device)
        while bool(active.any()):
            m, _ = mabs_after(hi, torch.zeros(nrep, **i64))
            active &= (m < m0) & (hi < 65536.0) & (it < 24)
            hi = torch.where(active, hi * 2.0, hi)
            it = it + active.long()
        # bisect
        lo = torch.zeros(nrep, **f32)
        it = torch.zeros(nrep, **i64)
        state = base
        active = torch.ones(nrep, dtype=torch.bool, device=device)
        while bool(active.any()):
            f = trig.f32(0.5).to(device) * (lo + hi)
            m, st = mabs_after(f, it)
            go = active & ((m - m0).abs() / m0 >= eps) & (it < max_iter)
            state = self._where(active & ~go, st, state)
            lo = torch.where(go & (m < m0), f, lo)
            hi = torch.where(go & (m >= m0), f, hi)
            it = it + go.long()
            active = go
        # stage 2: damped field sweeps along m on the evolving state
        k2 = rng.phase_key(keys, 3)
        f = torch.ones(nrep, **f32)
        it = torch.zeros(nrep, **i64)
        while True:
            mx, my = self._densities(state)
            mabs = torch.hypot(mx, my)
            active = ((mabs - m0).abs() / m0 >= eps) & (it < 512)
            if not bool(active.any()):
                break
            mabs = mabs.clamp(min=1e-9)
            under = mabs < m0
            s = torch.where(under, f, -0.5 * f)
            st = self.field_sweep(state, rng.fold_in(k2, it.cpu()),
                                  (s * mx / mabs).float(),
                                  (s * my / mabs).float())
            state = self._where(active, st, state)
            f = torch.where(active, torch.clamp(
                torch.where(under, f, 0.5 * f), min=1e-3), f)
            it = it + active.long()
        return self.rotate_magne_toward_xaxis(state)

    def prep_small_magne(self, keys: torch.Tensor, near_magne: float,
                         tol: float | None = None, max_iter: int = 10_000,
                         device="cpu") -> XYState:
        """set_random_small_spin (tol None: drive |m| strictly below
        near_magne) or set_random_near_spin (tol: stop when the relative
        gap is at most tol), field (-mx, -my) a sweep, key fold_in(., 1)
        of the previous one from phase_key(key, 2)
        (xy2d_periodic_gpu_m.f90:156-196); then m onto +x.  Every replica
        runs its own loop under a mask."""
        state = self.random_states(keys, device)
        nrep = keys.shape[0]
        k = rng.phase_key(keys, 2)
        it = torch.zeros(nrep, dtype=torch.int64, device=device)
        while True:
            mx, my = self._densities(state)
            mabs = torch.hypot(mx, my)
            if tol is None:
                unmet = mabs >= near_magne
            else:
                unmet = (mabs - near_magne).abs() / near_magne > tol
            active = unmet & (it < max_iter)
            if not bool(active.any()):
                break
            k = torch.where(active.cpu().view(-1, 1), rng.fold_in(k, 1), k)
            st = self.field_sweep(state, k, (-mx).float(), (-my).float())
            state = self._where(active, st, state)
            it = it + active.long()
        return self.rotate_magne_toward_xaxis(state)

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

    def autocorrelation_sum(self, state: XYState, snap: XYState
                            ) -> torch.Tensor:
        """A = Σ S(t)·S(t0) over the last two axes, float64
        (calc_autocorrelation_sum, xy2d_periodic_gpu_m.f90:536-549)."""
        return sum((p.to(torch.float64) * q.to(torch.float64)).sum(
            dim=(-2, -1)) for p, q in zip(state, snap))

    def correlation_sum(self, state: XYState) -> torch.Tensor:
        """Two-point Σ S(x, y)·S(x + nx/2 - 1, y + ny/2 - 1) over the
        lattice, float64 (calc_correlation_sum,
        xy2d_periodic_gpu_m.f90:551-567)."""
        fx = lattice.merge_checkerboard(state.ax, state.bx).to(torch.float64)
        fy = lattice.merge_checkerboard(state.ay, state.by).to(torch.float64)
        dx, dy = self.nx // 2 - 1, self.ny // 2 - 1

        def shift(v):
            return torch.roll(v, shifts=(-dy, -dx), dims=(-2, -1))

        return (fx * shift(fx) + fy * shift(fy)).sum(dim=(-2, -1))

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
