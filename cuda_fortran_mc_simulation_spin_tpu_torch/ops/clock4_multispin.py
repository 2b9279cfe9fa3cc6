"""Bit-sliced packed checkerboard Metropolis for the q=4 clock model.

Port of ``cuda_fortran_mc_simulation_spin_tpu/ops/clock4_multispin.py``:
two binary digit planes per colour (b0, b1), c = b0 + 2·b1; per bond
cos(2π(c−n)/4) is +1, 0 or −1 from a = b0⊕n0 and z = b1⊕n1 (zero iff
a), so ΔE ∈ [−8, 8] comes from two 4:4 side sums.  The proposal
r ∈ {1, 2, 3} is a 12-bit thermometer (categories {1365, 1366, 1365}/4096,
symmetric); acceptance e^(−βΔE) for ΔE ∈ [1, 8] is the product of four
chains p₁, p₂, p₄, p₈ (p_k = e^(−kβ)) gated by the digits of ΔE.  The
fused sums are (m, e) themselves (obs_scale 1).  Bound into the scaffold
(ops/clock_planes.py) through :data:`SPEC`; the CUDA algebra is
``csrc/clock_algebra.cuh`` (``decide4``, ``draw_unrolled<4>``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from cuda_fortran_mc_simulation_spin_tpu_torch.ops import clock_planes
from cuda_fortran_mc_simulation_spin_tpu_torch.ops.clock_planes import (
    _fa,
    _ha,
    _lt_multi,
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

OBS_INT32_MAX_SITES = (2 ** 31 - 1) // 2

_PROP_BITS = 12
_PROP_T = tuple(int(round(k * 4096 / 3)) for k in (1, 2))


def accept_digit_planes4(beta: float):
    """Digit tuples of the four gated chains (p₁, p₂, p₄, p₈),
    p_k = e^(−kβ)."""
    return tuple(chain_digits_of(float(np.exp(-k * beta)))
                 for k in (1.0, 2.0, 4.0, 8.0))


def pack_clock4_color(plane: torch.Tensor):
    """(..., ny, half) int8 q=4 states -> (b0, b1) packed int32 planes."""
    c = plane.to(torch.int64)
    return _packbits(c & 1), _packbits((c >> 1) & 1)


def unpack_clock4_color(b0, b1):
    return (_unpackbits(b0) + 2 * _unpackbits(b1)).to(torch.int8)


def draw_planes4(gen, digit4):
    """(r0, r1, B₁, B₂, B₄, B₈): 12 thermometer words, then the chains."""
    prop = [gen() for _ in range(_PROP_BITS)]
    c1, c2 = _lt_multi(prop, _PROP_T, _PROP_BITS)
    r0 = c1 | _not(c2)                         # r odd
    r1 = _not(c1)                              # r >= 2
    chains = [_bern_plane(prop[0].shape, d, gen, prop[0].device)
              for d in digit4]
    return (r0, r1, *chains)


def _decide4(xb0, xb1, nb0, nb1, planes6):
    """Packed Metropolis decision of one q=4 phase: returns (b0_new,
    b1_new, (a_fin[4], z_fin[4]))."""
    r0, r1, b1c, b2c, b4c, b8c = planes6
    carry = xb0 & r0
    rz = r1 ^ carry
    ab, zb = [], []
    posb, negb, pospb, negpb = [], [], [], []
    for b in range(4):
        a = xb0 ^ nb0[b]
        z = xb1 ^ nb1[b]
        ap = a ^ r0
        zp = z ^ rz
        na, nap = _not(a), _not(ap)
        ab.append(a)
        zb.append(z)
        posb.append(na & _not(z))
        negb.append(na & z)
        pospb.append(nap & _not(zp))
        negpb.append(nap & zp)

    def side_sum(c4a, c4b):
        o1, t1, f1 = _count_planes(*c4a)
        o2, t2, f2 = _count_planes(*c4b)
        s0, c = _ha(o1, o2)
        s1, c = _fa(t1, t2, c)
        s2, c = _fa(f1, f2, c)
        return s0, s1, s2, c

    p = side_sum(posb, negpb)
    n = side_sum(negb, pospb)
    d0, c = _fa(p[0], _not(n[0]), MASK32)
    d1, c = _fa(p[1], _not(n[1]), c)
    d2, c = _fa(p[2], _not(n[2]), c)
    d3, co = _fa(p[3], _not(n[3]), c)
    pos = co & (d0 | d1 | d2 | d3)
    passes = ((_not(d0) | b1c) & (_not(d1) | b2c) & (_not(d2) | b4c)
              & (_not(d3) | b8c))
    accept = _not(pos) | passes
    flip0 = r0 & accept
    flip1 = rz & accept
    return (xb0 ^ flip0, xb1 ^ flip1,
            ([a ^ flip0 for a in ab], [z ^ flip1 for z in zb]))


def _m_color(b0, b1, mask):
    nb0 = _not(b0) & mask
    return _pc(nb0 & _not(b1)) - _pc(nb0 & b1)


def _obs_partial4(new, oth, fin, mask):
    """(m, e) int64 per replica from the phase-b final values, real sites
    only: per site cos = (1−b0)(1−2b1); per bond E = Σneg − Σpos."""
    m = _m_color(*new, mask) + _m_color(*oth, mask)
    e = 0
    for a, z in zip(*fin):
        na = _not(a) & mask
        e = e + _pc(na & z) - _pc(na & _not(z))
    return m, e


def obs_packed4_masked(wa, wb, ny: int):
    """(m, e) int64 per replica of a final state, real sites only."""
    nyw, nb = words_rows(ny)
    mask = real_mask(nyw, wa[0].shape[-1], nb, wa[0].device)
    a = tuple(_u32(p) for p in wa)
    b = tuple(_u32(p) for p in wb)
    n0, n1 = (nbr_planes(p, 1, nb) for p in a)
    e = 0
    for k in range(4):
        na = _not(b[0] ^ n0[k]) & mask
        z = b[1] ^ n1[k]
        e = e + _pc(na & z) - _pc(na & _not(z))
    return _m_color(*a, mask) + _m_color(*b, mask), e


def _decide_t(xs, nbrs, rand):
    b0, b1, fin = _decide4(*xs, *nbrs, rand)
    return (b0, b1), fin


SPEC = clock_planes.PlaneSpec(
    name="clock4",
    q=4,
    n_state=2,
    n_rand=6,
    max_sites=OBS_INT32_MAX_SITES,
    obs_scale=1.0,
    accept_digits=accept_digit_planes4,
    draw=draw_planes4,
    decide=_decide_t,
    obs_partial=_obs_partial4,
    obs_masked=obs_packed4_masked,
    pack_color=pack_clock4_color,
    unpack_color=unpack_clock4_color,
)


# the halo mode on a mesh's shards (JAX's sharded_phase_packed4)
sharded_phase_packed4 = functools.partial(
    clock_planes.sharded_phase_packed, SPEC)
sharded_phase_packed4_plain = functools.partial(
    clock_planes.sharded_phase_packed_plain, SPEC)
shard_packed4_ok = clock_planes.shard_ok
