"""Bit-sliced packed checkerboard Metropolis for the q=3 clock model.

Port of ``cuda_fortran_mc_simulation_spin_tpu/ops/clock3_multispin.py``:
τ ∈ {0, 1, 2} as the q=6 engine's Z₃ planes (t0 = [τ=1], t1 = [τ=2]);
per bond 2cos = 3·eq − 1 with eq = [τ=τ_n], so 2ΔE = 3k, k = n_eq − n_eq′
∈ [−4, 4] from two 4:3 counters.  The proposal r = 1 + rb takes one
random bit plane (exact, no thermometer); acceptance e^(−3βk/2) for
k ∈ [1, 4] is the product of three chains p₁, p₂, p₄
(p_j = e^(−3jβ/2)) gated by the digits of k.  Bound into the scaffold
(ops/clock_planes.py) through :data:`SPEC`; the CUDA algebra is
``csrc/clock_algebra.cuh`` (``decide3``, ``draw_unrolled<3>``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from cuda_fortran_mc_simulation_spin_tpu_torch.ops import clock_planes
from cuda_fortran_mc_simulation_spin_tpu_torch.ops.clock_planes import (
    _fa,
    _not,
    _packbits,
    _pc,
    _unpackbits,
    chain_digits_of,
    nbr_planes,
    real_mask,
    words_rows,
)
from cuda_fortran_mc_simulation_spin_tpu_torch.ops.ising2d_multispin import (
    MASK32,
    _bern_plane,
    _count_planes,
    _u32,
)

OBS_INT32_MAX_SITES = (2 ** 31 - 1) // 4


def accept_digit_planes3(beta: float):
    """Digit tuples of the three gated chains (p₁, p₂, p₄),
    p_j = e^(−3jβ/2)."""
    return tuple(chain_digits_of(float(np.exp(-1.5 * j * beta)))
                 for j in (1.0, 2.0, 4.0))


def pack_clock3_color(plane: torch.Tensor):
    """(..., ny, half) int8 q=3 states -> (t0, t1) packed int32 planes."""
    c = plane.to(torch.int64)
    return _packbits(c == 1), _packbits(c == 2)


def unpack_clock3_color(t0, t1):
    return (_unpackbits(t0) + 2 * _unpackbits(t1)).to(torch.int8)


def draw_planes3(gen, digit3):
    """(rb, B₁, B₂, B₄): one proposal word, then the three chains."""
    rb = gen()
    chains = [_bern_plane(rb.shape, d, gen, rb.device) for d in digit3]
    return (rb, *chains)


def _decide3(xt0, xt1, nt0, nt1, planes4):
    """Packed Metropolis decision of one q=3 phase: returns (t0_new,
    t1_new, eq_fin[4])."""
    rb, b1c, b2c, b4c = planes4
    nrb = _not(rb)
    z = _not(xt0 | xt1)
    t0p = (z & nrb) | (xt1 & rb)
    t1p = (z & rb) | (xt0 & nrb)
    eqb, eqpb = [], []
    for b in range(4):
        eqb.append(_not((xt0 ^ nt0[b]) | (xt1 ^ nt1[b])))
        eqpb.append(_not((t0p ^ nt0[b]) | (t1p ^ nt1[b])))
    p = _count_planes(*eqb)
    n = _count_planes(*eqpb)
    d0, c = _fa(p[0], _not(n[0]), MASK32)
    d1, c = _fa(p[1], _not(n[1]), c)
    d2, co = _fa(p[2], _not(n[2]), c)
    pos = co & (d0 | d1 | d2)
    passes = (_not(d0) | b1c) & (_not(d1) | b2c) & (_not(d2) | b4c)
    accept = _not(pos) | passes
    rej = _not(accept)
    return ((t0p & accept) | (xt0 & rej), (t1p & accept) | (xt1 & rej),
            [(ep & accept) | (e & rej) for e, ep in zip(eqb, eqpb)])


def _m2_color(t0, t1, mask):
    return 3 * _pc(_not(t0 | t1) & mask) - _pc(mask)


def _obs_partial3(new, oth, eq_fin, mask):
    """(2m, 2e) int64 per replica from the phase-b final values, real
    sites only: 2m = Σ_colours 3·pc(τ=0) − N_colour; 2e = 4N_b − 3Σpc(eq)."""
    m2 = _m2_color(*new, mask) + _m2_color(*oth, mask)
    s_eq = sum(_pc(e & mask) for e in eq_fin)
    return m2, 4 * _pc(mask) - 3 * s_eq


def obs_packed3_masked(wa, wb, ny: int):
    """(2m, 2e) int64 per replica of a final state, real sites only."""
    nyw, nb = words_rows(ny)
    mask = real_mask(nyw, wa[0].shape[-1], nb, wa[0].device)
    a = tuple(_u32(p) for p in wa)
    b = tuple(_u32(p) for p in wb)
    n0, n1 = (nbr_planes(p, 1, nb) for p in a)
    s_eq = sum(_pc(_not((b[0] ^ n0[k]) | (b[1] ^ n1[k])) & mask)
               for k in range(4))
    return (_m2_color(*a, mask) + _m2_color(*b, mask),
            4 * _pc(mask) - 3 * s_eq)


def _decide_t(xs, nbrs, rand):
    t0, t1, fin = _decide3(*xs, *nbrs, rand)
    return (t0, t1), fin


SPEC = clock_planes.PlaneSpec(
    name="clock3",
    q=3,
    n_state=2,
    n_rand=4,
    max_sites=OBS_INT32_MAX_SITES,
    obs_scale=0.5,
    accept_digits=accept_digit_planes3,
    draw=draw_planes3,
    decide=_decide_t,
    obs_partial=_obs_partial3,
    obs_masked=obs_packed3_masked,
    pack_color=pack_clock3_color,
    unpack_color=unpack_clock3_color,
)


# the halo mode on a mesh's shards (JAX's sharded_phase_packed3)
sharded_phase_packed3 = functools.partial(
    clock_planes.sharded_phase_packed, SPEC)
sharded_phase_packed3_plain = functools.partial(
    clock_planes.sharded_phase_packed_plain, SPEC)
shard_packed3_ok = clock_planes.shard_ok
