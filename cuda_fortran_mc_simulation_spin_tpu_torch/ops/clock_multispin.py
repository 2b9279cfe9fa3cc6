"""Bit-sliced packed checkerboard Metropolis for the q=6 clock model.

Port of ``cuda_fortran_mc_simulation_spin_tpu/ops/clock_multispin.py``:
the q=6 bond algebra bound into the shared scaffold
(ops/clock_planes.py) through :data:`SPEC`.  The state is CRT-split,
Z₆ ≅ Z₂ × Z₃: c ↔ (σ = c mod 2, τ = c mod 3), three packed planes per
colour (σ, t0 = [τ=1], t1 = [τ=2]), so that

    2cos(2π(c−n)/6) = ¬x + 3(x⊕eq) − 2,   x = σ⊕σ_n, eq = [τ=τ_n]

and 2ΔE ∈ [−16, 16] comes from four bit-sliced 4:3 counters.  The
proposal r ∈ [1, 5] is a 12-bit thermometer over one shared uniform (the
rounded categories {819, 819, 820, 819, 819}/4096 are symmetric, so
detailed balance is exact); acceptance e^(−βm/2) for m = 2ΔE ∈ [1, 16]
is the product of five Bernoulli chains p₁, p₂, p₄, p₈, p₈ gated by the
binary digits of m.  The same algebra, in CUDA, is
``csrc/clock_algebra.cuh`` (``decide6``, ``draw_unrolled<6>``, ``m2_word6``).
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

# the JAX kernels accumulate (2m, 2e) in int32 (|2e| <= 4N) and cap the
# lattice here; the port sums in int64 and keeps the cap only to route
# alike
OBS_INT32_MAX_SITES = (2 ** 31 - 1) // 4

# proposal thermometer: 12-bit thresholds round(k·4096/5)
_PROP_BITS = 12
_PROP_T = tuple(int(round(k * 4096 / 5)) for k in (1, 2, 3, 4))


def accept_digit_planes(beta: float):
    """Digit tuples of the five gated chains (p₁, p₂, p₄, p₈, p₈),
    p_k = e^(−kβ/2)."""
    return tuple(chain_digits_of(float(np.exp(-0.5 * k * beta)))
                 for k in (1.0, 2.0, 4.0, 8.0, 8.0))


def pack_clock_color(plane: torch.Tensor):
    """(..., ny, half) int8 clock states -> (s, t0, t1) packed int32
    planes (..., nyw, half): s = c mod 2, t0 = [c mod 3 = 1],
    t1 = [c mod 3 = 2]."""
    c = plane.to(torch.int64)
    tau = c % 3
    return _packbits(c & 1), _packbits(tau == 1), _packbits(tau == 2)


def unpack_clock_color(s, t0, t1):
    """Inverse of :func:`pack_clock_color` (c = (3σ + 4τ) mod 6)."""
    tau = _unpackbits(t0) + 2 * _unpackbits(t1)
    return ((3 * _unpackbits(s) + 4 * tau) % 6).to(torch.int8)


def draw_planes(gen, digit5):
    """(ρ, rt1, rt2, B₁, B₂, B₄, B₈a, B₈b) from fresh words: 12 thermometer
    words, then the five chains, in that order."""
    prop = [gen() for _ in range(_PROP_BITS)]
    c1, c2, c3, c4 = _lt_multi(prop, _PROP_T, _PROP_BITS)
    # r = 5 − (c1+c2+c3+c4) ∈ [1, 5] (thermometer: c1 ⊆ c2 ⊆ c3 ⊆ c4)
    rho = MASK32 ^ c1 ^ c2 ^ c3 ^ c4           # r mod 2
    rt1 = c1 | (c4 & _not(c3))                 # r mod 3 == 1
    rt2 = (c2 & _not(c1)) | _not(c4)           # r mod 3 == 2
    chains = [_bern_plane(prop[0].shape, d, gen, prop[0].device)
              for d in digit5]
    return (rho, rt1, rt2, *chains)


def _decide(xs, xt0, xt1, ns, nt0, nt1, planes8):
    """Packed Metropolis decision of one phase (uint32 in int64): returns
    (s_new, t0_new, t1_new, (x_fin[4], w_fin[4]))."""
    rho, rt1, rt2, b1, b2, b4, b8a, b8b = planes8
    z = _not(xt0 | xt1)
    rz = _not(rt1 | rt2)
    t0p = (z & rt1) | (xt0 & rz) | (xt1 & rt2)
    t1p = (z & rt2) | (xt0 & rt1) | (xt1 & rz)
    xb, xpb, wb, wpb = [], [], [], []
    for b in range(4):
        x = xs ^ ns[b]
        eq = _not((xt0 ^ nt0[b]) | (xt1 ^ nt1[b]))
        eqp = _not((t0p ^ nt0[b]) | (t1p ^ nt1[b]))
        xp = x ^ rho
        xb.append(x)
        xpb.append(xp)
        wb.append(x ^ eq)
        wpb.append(xp ^ eqp)
    n_x = _count_planes(*xb)
    n_xp = _count_planes(*xpb)
    n_w = _count_planes(*wb)
    n_wp = _count_planes(*wpb)

    def scaled_sum(na, nw):
        # na + 3·nw = (na + nw) + 2·nw, 5 bits
        b0, c = _ha(na[0], nw[0])
        b1_, c = _fa(na[1], nw[1], c)
        b2_, c = _fa(na[2], nw[2], c)
        b3_ = c
        p1, c = _ha(b1_, nw[0])
        p2, c = _fa(b2_, nw[1], c)
        p3, c = _fa(b3_, nw[2], c)
        return b0, p1, p2, p3, c

    p = scaled_sum(n_xp, n_w)
    n = scaled_sum(n_x, n_wp)
    # D = P − N via P + ~N + 1 (5-bit two's complement)
    d0, c = _fa(p[0], _not(n[0]), MASK32)
    d1, c = _fa(p[1], _not(n[1]), c)
    d2, c = _fa(p[2], _not(n[2]), c)
    d3, c = _fa(p[3], _not(n[3]), c)
    d4, co = _fa(p[4], _not(n[4]), c)
    pos = co & (d0 | d1 | d2 | d3 | d4)        # D >= 1
    g8a = d3 | d4
    passes = ((_not(d0) | b1) & (_not(d1) | b2) & (_not(d2) | b4)
              & (_not(g8a) | b8a) & (_not(d4) | b8b))
    accept = _not(pos) | passes
    rej = _not(accept)
    s_new = xs ^ (rho & accept)
    t0_new = (t0p & accept) | (xt0 & rej)
    t1_new = (t1p & accept) | (xt1 & rej)
    flip = rho & accept
    x_fin = [x ^ flip for x in xb]
    w_fin = [(wp & accept) | (w & rej) for w, wp in zip(wb, wpb)]
    return s_new, t0_new, t1_new, (x_fin, w_fin)


def _m2_color(s, t0, t1, mask):
    """2·Σcos of one colour's real sites: per site (−1)^σ(3[τ=0] − 1)."""
    zz = _not(t0 | t1) & mask
    return 3 * _pc(zz) - 6 * _pc(s & zz) + 2 * _pc(s & mask) - _pc(mask)


def _obs_partial(new, oth, fin, mask):
    """(2m, 2e) int64 per replica from the phase-b final values, real
    sites only: 2m over both colours, 2e = 4N_b + Σx − 3Σw over the four
    bonds of every phase-b site (every lattice bond once)."""
    m2 = _m2_color(*new, mask) + _m2_color(*oth, mask)
    x_fin, w_fin = fin
    s_x = sum(_pc(x & mask) for x in x_fin)
    s_w = sum(_pc(w & mask) for w in w_fin)
    return m2, 4 * _pc(mask) + s_x - 3 * s_w


def obs_packed6_masked(wa, wb, ny: int):
    """(2m, 2e) int64 per replica of a final state (phase b's
    conventions), real sites only: the JAX ``obs_packed6_masked``."""
    nyw, nb = words_rows(ny)
    mask = real_mask(nyw, wa[0].shape[-1], nb, wa[0].device)
    a = tuple(_u32(p) for p in wa)
    b = tuple(_u32(p) for p in wb)
    ns, nt0, nt1 = (nbr_planes(p, 1, nb) for p in a)
    s_x = s_w = 0
    for k in range(4):
        x = b[0] ^ ns[k]
        eq = _not((b[1] ^ nt0[k]) | (b[2] ^ nt1[k]))
        s_x = s_x + _pc(x & mask)
        s_w = s_w + _pc((x ^ eq) & mask)
    m2 = _m2_color(*a, mask) + _m2_color(*b, mask)
    return m2, 4 * _pc(mask) + s_x - 3 * s_w


def _decide_t(xs, nbrs, rand):
    s, t0, t1, fin = _decide(*xs, *nbrs, rand)
    return (s, t0, t1), fin


SPEC = clock_planes.PlaneSpec(
    name="clock6",
    q=6,
    n_state=3,
    n_rand=8,
    max_sites=OBS_INT32_MAX_SITES,
    obs_scale=0.5,
    accept_digits=accept_digit_planes,
    draw=draw_planes,
    decide=_decide_t,
    obs_partial=_obs_partial,
    obs_masked=obs_packed6_masked,
    pack_color=pack_clock_color,
    unpack_color=unpack_clock_color,
)

_b = functools.partial

packed_phase_reference = _b(clock_planes.phase_reference, SPEC)
phase_packed = _b(clock_planes.phase_packed, SPEC)
clock_packable = _b(clock_planes.packable_gate, SPEC)
clock_padded_packable = _b(clock_planes.padded_packable_gate, SPEC)
pack_state = _b(clock_planes.pack_state, SPEC)
unpack_state = _b(clock_planes.unpack_state, SPEC)
sweep_packed6 = _b(clock_planes.sweep_packed, SPEC)
sweep_measure_packed6 = _b(clock_planes.sweep_measure_packed, SPEC)
# the halo mode on a mesh's shards (JAX clock_multispin.py:352-357)
sharded_phase_packed6 = _b(clock_planes.sharded_phase_packed, SPEC)
sharded_phase_packed6_plain = _b(clock_planes.sharded_phase_packed_plain,
                                 SPEC)
shard_packed6_ok = clock_planes.shard_ok
