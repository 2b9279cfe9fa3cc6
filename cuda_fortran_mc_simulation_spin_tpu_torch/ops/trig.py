"""Unit-circle trigonometry of the XY hot paths, in float32.

Port of ``cuda_fortran_mc_simulation_spin_tpu/ops/trig.py``.  The XY
Metropolis kernel draws its candidate spin as (cos 2πu, sin 2πu);
``cos_sin_2pi`` folds the angle to a quarter period and evaluates
degree-3 minimax polynomials in r² (max abs error 1.1e-7 against float64,
|S| - 1 <= 1.3e-7).  ``exp_neg`` (e^-x for x >= 0) and ``atan2_2pi``
(atan2 in turns) serve the angle-storage kernels of a later slice.

Every function is plain float32 mul/add/select on torch tensors of any
device, in the JAX module's order and with its constants rounded to
float32 the same way (a Python float cast once), so that
``csrc/xy2d_pallas.cu``, which spells the same chain with ``__fmul_rn`` /
``__fadd_rn``, gives the same bits as :func:`cos_sin_2pi` on the card.
The quadrant fold keeps ``floor(4u + 0.5)`` and the int32 ``& 3``: together
they are a true mod 4 for negative u as well.
"""

from __future__ import annotations

import numpy as np
import torch

# cos((π/2) r) ≈ C0 + C1 r² + C2 r⁴ + C3 r⁶,  r ∈ [-0.5, 0.5]
_C = (9.9999998075e-01, -1.2336977754e+00,
      2.5360837309e-01, -2.0438343895e-02)
# sin((π/2) r) ≈ r (S0 + S1 r² + S2 r⁴ + S3 r⁶)
_S = (1.5707963234e+00, -6.4596361199e-01,
      7.9681932446e-02, -4.6074307448e-03)

# e^(-r) ≈ Σ _ER[k] r^k on r ∈ [-ln2/2, ln2/2] (Chebyshev, rel 6e-9)
_ER = (9.9999999997e-01, -1.0000000281e+00, 5.0000000844e-01,
       -1.6666455876e-01, 4.1666280339e-02, -8.3719121942e-03,
       1.3944600787e-03)
_LOG2E = 1.4426950408889634
# Cody-Waite ln2 split: hi has 9 mantissa bits, so n·hi is exact for
# the n <= 182 this domain produces; lo mops up the rest
_LN2_HI = 0.693359375
_LN2_LO = -2.1219444005469057e-04
# 1.5·2²³: adding it rounds to an integer held in the low mantissa bits
_MAGIC = 12582912.0

# atan(t)/(2π) on the half-octant |t| <= tan(π/8): odd minimax fit,
# max err 4.6e-8 turns
_AT = (1.5915465081e-01, -5.3026171236e-02,
       3.1232619285e-02, -1.7416252601e-02)
_TAN_PI_8 = 0.41421356237309503


def f32(v: float) -> torch.Tensor:
    """A Python float as a 0-dim float32 tensor (rounded once, as
    ``jnp.float32(v)`` rounds it); it combines with tensors of any
    device as a float32 scalar."""
    return torch.tensor(np.float32(v))


def _poly(w: torch.Tensor, coeffs) -> torch.Tensor:
    """c0 + w (c1 + w (c2 + w c3)), Horner from the top."""
    p = f32(coeffs[-1])
    for c in reversed(coeffs[:-1]):
        p = f32(c) + w * p
    return p


def cos_sin_2pi(u: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos 2πu, sin 2πu) for u ∈ (-1, 1), float32 in and out.

    2πu = (π/2)(n + r) with n = floor(4u + 0.5), |r| <= 1/2; the quarter
    period pair is rotated into place by n mod 4 with selects and one
    sign flip."""
    u = u.to(torch.float32)
    a = u * f32(4.0)
    n = torch.floor(a + f32(0.5))
    r = a - n
    m = n.to(torch.int32) & 3
    w = r * r
    cq = _poly(w, _C)
    sq = r * _poly(w, _S)
    swap = (m & 1) == 1
    c = torch.where(swap, -sq, cq)
    s = torch.where(swap, cq, sq)
    flip = m >= 2
    return torch.where(flip, -c, c), torch.where(flip, -s, s)


def exp_neg(x: torch.Tensor) -> torch.Tensor:
    """e^(-x) for x >= 0, float32: n = round(x·log₂e) by the magic-number
    add, r = x - n·ln2 by the Cody-Waite split, e^(-r) by polynomial and
    2^(-n) written into the exponent bits (n clamped at 126).  Relative
    error <= ~2e-7; exp_neg(0) == 1 exactly."""
    x = x.to(torch.float32)
    t = x * f32(_LOG2E) + f32(_MAGIC)
    n = t - f32(_MAGIC)
    ni = t.view(torch.int32) - 0x4B400000
    r = (x - n * f32(_LN2_HI)) - n * f32(_LN2_LO)
    p = f32(_ER[6])
    for c in (_ER[5], _ER[4], _ER[3], _ER[2], _ER[1], _ER[0]):
        p = p * r + f32(c)
    ni = torch.clamp(ni, max=126)
    scale = ((127 - ni) << 23).to(torch.int32).view(torch.float32)
    return p * scale


def atan2_2pi(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """atan2(y, x) in turns ∈ [-0.5, 0.5], float32: half-octant reduction
    (one divide), a degree-7 odd polynomial and octant fixups in turns.
    Max abs error ~5e-8 turns; atan2_2pi(0, 0) = 0."""
    x = x.to(torch.float32)
    y = y.to(torch.float32)
    ax, ay = x.abs(), y.abs()
    num = torch.minimum(ax, ay)
    den = torch.maximum(ax, ay)
    fold = num > f32(_TAN_PI_8) * den
    s1 = torch.where(fold, num - den, num)
    s2 = torch.where(fold, num + den, den)
    t = s1 / torch.maximum(s2, f32(1e-37))
    r = t * _poly(t * t, _AT)
    r = torch.where(fold, r + f32(0.125), r)
    r = torch.where(ay > ax, f32(0.25) - r, r)
    r = torch.where(x < 0, f32(0.5) - r, r)
    return torch.where(y < 0, -r, r)
