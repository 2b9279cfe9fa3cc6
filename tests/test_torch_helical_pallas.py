"""Port vs JAX on the same numpy inputs: the masked helical kernels' plain
versions (ops/helical_pallas.py) and the helical clock model's phase.

Shapes 33x32 and 65x64 (even N) and 33x31 (odd N: nx and ny odd, the wrap
pairs of one colour), R = 2-3.  The JAX TPU kernels draw the chip's
hardware bits and have no injected mode, so their rule is restated here
from the JAX package's own jnp pieces (``core/lattice.helical_neighbor_
sums`` and ``helical_parity_mask``, ``ops/ising2d_pallas.accept_
thresholds_u32``, ``ops/stencil.bits_to_uniform``, ``ops/trig.cos_sin_
2pi``; the float fields in the kernels' order ((up + dn) + left) + right,
by ``jnp.roll``), every site reading the pre-phase state as the kernels'
single-block mode does.

Tolerances, and why (the rules of tests/test_torch_xy2d_helical.py):
- Ising: integers, bitwise;
- clock and XY against the restated rule: bitwise, except a site whose
  accept decision differs, which must have |u_acc - p| < 1e-6 (p in
  float64; ``jnp.exp`` and XLA's mul-add contraction move p by 1-2 ulp),
  at most 1 site in 1e4;
- against the JAX models' ``_phase`` (another decode: the clock's select
  chain, XY's ``jnp.cos`` of 2πu rounded to float32, and another field
  order): the same, with the decision margin 1e-5, and XY components
  within 5e-7 (the angle's rounding, up to 2.4e-7 near 2π, beside
  cos_sin_2pi's 1.1e-7 and the output's rounding; seen 4.02e-7);
- over-relaxation: one phase within 1e-6 of the rule restated (rsqrt's
  ulps); two phases against the JAX model's sweep (another field order,
  and the second phase reads the first's differences) within
  1e-5·max(1, 1/|h|), h the site's field: a field rounded otherwise
  turns the reflection axis by ~ulp(h)/|h| (seen up to 2.5e-5 at a site
  with |h| < 1);
- sums: Ising exactly; clock and XY within 1e-5 relative of the JAX
  models' float32 sums, and to float64 rounding of a float64 restatement.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_fortran_mc_simulation_spin_tpu.core import lattice as jlattice
from cuda_fortran_mc_simulation_spin_tpu.models.clock_helical import (
    Clock2DHelical as JaxClockHelical,
)
from cuda_fortran_mc_simulation_spin_tpu.models.ising2d_helical import (
    Ising2DHelical as JaxIsingHelical,
)
from cuda_fortran_mc_simulation_spin_tpu.models.xy2d_helical import (
    XY2DHelical as JaxXYHelical,
)
from cuda_fortran_mc_simulation_spin_tpu.ops import helical_pallas as jhp
from cuda_fortran_mc_simulation_spin_tpu.ops import stencil as jstencil
from cuda_fortran_mc_simulation_spin_tpu.ops import trig as jtrig
from cuda_fortran_mc_simulation_spin_tpu.ops.ising2d_pallas import (
    accept_thresholds_u32 as jax_thresholds,
)
from cuda_fortran_mc_simulation_spin_tpu_torch.core import rng
from cuda_fortran_mc_simulation_spin_tpu_torch.engine import sweep
from cuda_fortran_mc_simulation_spin_tpu_torch.models import (
    Clock2DHelical,
    Ising2DHelical,
    XY2DHelical,
)
from cuda_fortran_mc_simulation_spin_tpu_torch.ops import helical_pallas as hp
from cuda_fortran_mc_simulation_spin_tpu_torch.ops import multispin_rng

KBT = 2.26918531421
KBT_CLOCK = 0.8
KBT_XY = 0.89
SHAPES = [(32, 33), (31, 33), (64, 65)]       # (ny, nx)
NREP = 3
MARGIN_RULE = 1e-6
MARGIN_MODEL = 1e-5
XY_ATOL_MODEL = 5e-7


def _words(g, shape):
    return g.integers(0, 2 ** 32, size=shape, dtype=np.uint64)


def _colour_words(words: np.ndarray, n: int, color: int) -> np.ndarray:
    """The flat sites' words of a colour: site idx = 2k + color takes
    words[..., k]; the others 0."""
    out = np.zeros(words.shape[:-1] + (n,), dtype=words.dtype)
    out[..., color::2] = words[..., :hp.colour_sites(n, color)]
    return out


def _jroll_field(v, nx):
    """The TPU kernels' field order, ((up + dn) + left) + right."""
    return (((jnp.roll(v, nx, -1) + jnp.roll(v, -nx, -1))
             + jnp.roll(v, 1, -1)) + jnp.roll(v, -1, -1))


def _jax_ising_rule(flat, offset, bits, beta, nx):
    """The TPU Ising kernel's rule (helical_pallas.py:161-171) on (R, N)
    states (``helical_neighbor_sums`` rolls a flat (N,) lattice)."""
    import jax

    nsum = jax.vmap(lambda f: jlattice.helical_neighbor_sums(f, nx))(flat)
    half_de = flat * nsum
    t4, t8 = jax_thresholds(beta)
    thresh = jnp.where(half_de == 2, jnp.uint32(t4), jnp.uint32(t8))
    pmask = jlattice.helical_parity_mask(flat.shape[-1], offset)
    accept = pmask & ((half_de <= 0) | (bits < thresh))
    return jnp.where(accept, -flat, flat), nsum


def _jax_clock_rule(flat, offset, u_c, u_a, q, beta, nx):
    """The TPU clock kernel's rule (helical_pallas.py:269-329), returning
    the new states and its acceptance probabilities."""
    inv_q = jnp.float32(1.0 / q)
    co, so = jtrig.cos_sin_2pi(flat.astype(jnp.float32) * inv_q)
    hx, hy = _jroll_field(co, nx), _jroll_field(so, nx)
    off = (u_c * (q - 1)).astype(jnp.int32) + 1
    new = flat + off
    new = jnp.where(new >= q, new - q, new)
    cn, sn = jtrig.cos_sin_2pi(new.astype(jnp.float32) * inv_q)
    de = -((cn - co) * hx + (sn - so) * hy)
    p = jnp.exp(jnp.float32(-beta) * jnp.maximum(de, 0.0))
    pmask = jlattice.helical_parity_mask(flat.shape[-1], offset)
    return jnp.where(pmask & (u_a < p), new, flat), p


def _jax_xy_rule(sx, sy, offset, u_c, u_a, beta, nx):
    """The TPU XY kernel's rule (helical_pallas.py:439-456)."""
    hx, hy = _jroll_field(sx, nx), _jroll_field(sy, nx)
    cx, cy = jtrig.cos_sin_2pi(u_c)
    de = -((cx - sx) * hx + (cy - sy) * hy)
    p = jnp.exp(jnp.float32(-beta) * jnp.maximum(de, 0.0))
    pmask = jlattice.helical_parity_mask(sx.shape[-1], offset)
    accept = pmask & (u_a < p)
    return jnp.where(accept, cx, sx), jnp.where(accept, cy, sy), p


def _jax_or_rule(sx, sy, offset, nx):
    """The TPU OR kernel's rule (helical_pallas.py:491-512)."""
    hx, hy = _jroll_field(sx, nx), _jroll_field(sy, nx)
    inv = jax.lax.rsqrt(jnp.maximum(hx * hx + hy * hy, jnp.float32(1e-30)))
    nxh, nyh = hx * inv, hy * inv
    d = 2.0 * (sx * nxh + sy * nyh)
    rx, ry = d * nxh - sx, d * nyh - sy
    rinv = jax.lax.rsqrt(jnp.maximum(rx * rx + ry * ry, jnp.float32(1e-30)))
    pmask = jlattice.helical_parity_mask(sx.shape[-1], offset)
    return jnp.where(pmask, rx * rinv, sx), jnp.where(pmask, ry * rinv, sy)


def _assert_equal_but_borderline(got, want, u_acc, p, margin):
    """``got`` equals ``want`` except at sites whose accept decision is
    within ``margin`` of its probability (at most 1 in 1e4, at least 1)."""
    off = np.asarray(got) != np.asarray(want)
    close = np.abs(np.asarray(u_acc, np.float64)
                   - np.asarray(p, np.float64)) < margin
    close = np.broadcast_to(close, off.shape)
    assert np.all(close[off]), np.argwhere(off & ~close)[:5]
    assert off.sum() <= max(1, off.size // 10000)


def _uniforms(g, shape):
    """float32 uniforms from uint32 words by both packages' bits_to_uniform
    (which agree bitwise)."""
    w = _words(g, shape)
    u = rng.bits_to_uniform(torch.from_numpy(w.astype(np.int64)))
    ju = jstencil.bits_to_uniform(jnp.asarray(w.astype(np.uint32)))
    np.testing.assert_array_equal(u.numpy(), np.asarray(ju))
    return u


# ---------------------------------------------------------------------------
# the phases against the TPU kernels' rules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("color", [0, 1])
@pytest.mark.parametrize("ny,nx", SHAPES)
def test_ising_phase_matches_the_tpu_rule(ny, nx, color):
    """Injected words: the plain phase bitwise against the TPU kernel's
    integer rule (odd N included: both read the pre-phase state)."""
    g = np.random.default_rng(ny + nx + color)
    n = ny * nx
    s = (g.integers(0, 2, size=(NREP, n)) * 2 - 1).astype(np.int8)
    words = _words(g, (NREP, hp.colour_sites(n, 0)))
    got = hp.ising_phase_plain(torch.from_numpy(s),
                               torch.from_numpy(words.astype(np.int64)),
                               color=color, nx=nx, beta=1 / KBT)
    want, _ = _jax_ising_rule(jnp.asarray(s.astype(np.int32)), color,
                              jnp.asarray(_colour_words(words, n, color)
                                          .astype(np.uint32)), 1 / KBT, nx)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("q", [2, 5, 6, 8, 20, 127])
@pytest.mark.parametrize("color", [0, 1])
@pytest.mark.parametrize("ny,nx", SHAPES[:2])
def test_clock_phase_matches_the_tpu_rule(ny, nx, color, q):
    """Injected uniforms: the plain clock phase against the TPU kernel's
    rule at every q, and its table equal to the rule's cos_sin_2pi."""
    g = np.random.default_rng(10 * q + ny + color)
    n = ny * nx
    s = g.integers(0, q, size=(NREP, n)).astype(np.int8)
    uc, ua = (_uniforms(g, (NREP, hp.colour_sites(n, 0))) for _ in range(2))
    got = hp.clock_phase_plain(torch.from_numpy(s), uc, ua, color=color,
                               nx=nx, q=q, beta=1 / KBT_CLOCK)
    ju = [jnp.asarray(hp.spread(u, n, color).numpy()) for u in (uc, ua)]
    want, p = _jax_clock_rule(jnp.asarray(s.astype(np.int32)), color, *ju,
                              q, 1 / KBT_CLOCK, nx)
    _assert_equal_but_borderline(got.numpy(), np.asarray(want), ju[1], p,
                                 MARGIN_RULE)
    c, sn = jtrig.cos_sin_2pi(jnp.arange(q, dtype=jnp.float32)
                              * jnp.float32(1.0 / q))
    np.testing.assert_array_equal(hp.clock_table(q).numpy(),
                                  np.stack([np.asarray(c), np.asarray(sn)]))


@pytest.mark.parametrize("color", [0, 1])
@pytest.mark.parametrize("ny,nx", SHAPES)
def test_xy_phase_matches_the_tpu_rule(ny, nx, color):
    """Injected uniforms: the plain XY phase against the TPU kernel's
    rule (the candidate cos_sin_2pi(u) bitwise where the decisions
    agree)."""
    g = np.random.default_rng(100 + ny + nx + color)
    n = ny * nx
    th = g.uniform(0, 2 * np.pi, size=(NREP, n))
    sx, sy = np.cos(th).astype(np.float32), np.sin(th).astype(np.float32)
    uc, ua = (_uniforms(g, (NREP, hp.colour_sites(n, 0))) for _ in range(2))
    got = hp.xy_phase_plain(torch.from_numpy(sx), torch.from_numpy(sy),
                            (uc, ua), color=color, nx=nx, beta=1 / KBT_XY)
    ju = [jnp.asarray(hp.spread(u, n, color).numpy()) for u in (uc, ua)]
    wx, wy, p = _jax_xy_rule(jnp.asarray(sx), jnp.asarray(sy), color, *ju,
                             1 / KBT_XY, nx)
    for a, b in zip(got, (wx, wy)):
        _assert_equal_but_borderline(a.numpy(), np.asarray(b), ju[1], p,
                                     MARGIN_RULE)


@pytest.mark.parametrize("ny,nx", SHAPES)
def test_xy_or_matches_the_tpu_rule_and_the_jax_model(ny, nx):
    """One OR phase within 1e-6 of the TPU kernel's rule (jax.lax.rsqrt
    against torch.rsqrt); two, offset 0 then 1, within 1e-5 of the JAX
    model's over_relax_sweep (another field order too)."""
    g = np.random.default_rng(7 + ny + nx)
    n = ny * nx
    th = g.uniform(0, 2 * np.pi, size=(NREP, n))
    sx, sy = np.cos(th).astype(np.float32), np.sin(th).astype(np.float32)
    tx, ty = torch.from_numpy(sx), torch.from_numpy(sy)
    for color in (0, 1):
        got = hp.xy_or_phase_plain(tx, ty, color=color, nx=nx)
        want = _jax_or_rule(jnp.asarray(sx), jnp.asarray(sy), color, nx)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=1e-6)
    one = hp.xy_or_phase_plain(tx, ty, color=0, nx=nx)
    two = hp.xy_or_phase_plain(*one, color=1, nx=nx)
    # the field each site reflects about: a rounding of h moves the axis
    # by ~ulp(h)/|h|, so the bound grows where |h| is small
    hmag = torch.where(hp.colour_mask(n, 0),
                       torch.hypot(hp.field(tx, nx), hp.field(ty, nx)),
                       torch.hypot(hp.field(one[0], nx),
                                   hp.field(one[1], nx))).numpy()
    tol = 1e-5 * np.maximum(1.0, 1.0 / hmag)
    jmodel = JaxXYHelical(nx=nx, ny=ny, kbt=KBT_XY)
    for r in range(NREP):
        want = jmodel.over_relax_sweep((jnp.asarray(sx[r]),
                                        jnp.asarray(sy[r])))
        for a, b in zip(two, want):
            assert np.all(np.abs(a[r].numpy() - np.asarray(b)) <= tol[r])


# ---------------------------------------------------------------------------
# against the JAX models' masked phases (the CPU oracles)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("q", [2, 5, 6, 20])
@pytest.mark.parametrize("ny,nx", SHAPES[:2])
def test_clock_phase_matches_the_jax_model(ny, nx, q):
    """The plain masked clock phase and the port's helical clock model
    ``_phase`` against JAX ``Clock2DHelical._phase`` with the same
    uniforms: the model bitwise but for borderline decisions (the same
    select-chain values and field order), the masked phase the same
    with the wider margin (another decode and field order)."""
    g = np.random.default_rng(300 + q + ny)
    n = ny * nx
    s = g.integers(0, q, size=n).astype(np.int8)
    uc, ua = (_uniforms(g, (n,)) for _ in range(2))
    jmodel = JaxClockHelical(nx=nx, ny=ny, kbt=KBT_CLOCK, q=q)
    model = Clock2DHelical(nx=nx, ny=ny, kbt=KBT_CLOCK, q=q)
    for color in (0, 1):
        want = np.asarray(jmodel._phase(jnp.asarray(s), color,
                                        jnp.asarray(uc.numpy()),
                                        jnp.asarray(ua.numpy())))
        mine = model._phase(torch.from_numpy(s), color, uc, ua).numpy()
        _assert_equal_but_borderline(mine, want, ua.numpy(),
                                     _model_clock_p(s, uc, q, nx), 1e-6)
        masked = hp.clock_phase_plain(
            torch.from_numpy(s)[None], uc[color::2][None], ua[color::2][None],
            color=color, nx=nx, q=q, beta=1 / KBT_CLOCK)[0].numpy()
        _assert_equal_but_borderline(masked, want, ua.numpy(),
                                     _model_clock_p(s, uc, q, nx),
                                     MARGIN_MODEL)


def _model_clock_p(s, uc, q, nx):
    """The acceptance probabilities in float64 (the borderline test)."""
    ang = 2 * np.pi * s.astype(np.float64) / q
    c, sn = np.cos(ang), np.sin(ang)

    def h(v):
        return (np.roll(v, -1) + np.roll(v, 1) + np.roll(v, -nx)
                + np.roll(v, nx))
    off = (uc.numpy() * np.float32(q - 1)).astype(np.int32) + 1
    new = (s.astype(np.int32) + off) % q
    cn, snn = np.cos(2 * np.pi * new / q), np.sin(2 * np.pi * new / q)
    de = -((cn - c) * h(c) + (snn - sn) * h(sn))
    return np.exp(-np.maximum(de, 0.0) / KBT_CLOCK)


@pytest.mark.parametrize("q", [2, 5, 6])
@pytest.mark.parametrize("ny,nx", SHAPES[:2])
def test_clock_model_sweep_matches_the_jax_phases(ny, nx, q):
    """The port's helical clock ``sweep_batched``: replica r is ``sweep``
    under fold_in(key, r) bitwise, and each ``sweep`` is JAX
    ``Clock2DHelical._phase`` at offset 0 then 1 on the one batch of
    uniforms the sweep draws (JAX ``sweep`` shares them so), bitwise but
    for borderline decisions of either phase (margin 1e-6, as the model's
    phase above)."""
    g = np.random.default_rng(400 + q + ny)
    n = ny * nx
    s = g.integers(0, q, size=(2, n)).astype(np.int8)
    key = rng.sample_key(rng.base_key(11), q)
    jmodel = JaxClockHelical(nx=nx, ny=ny, kbt=KBT_CLOCK, q=q)
    model = Clock2DHelical(nx=nx, ny=ny, kbt=KBT_CLOCK, q=q)
    got = model.sweep_batched(torch.from_numpy(s), key).numpy()
    keys = rng.fold_in(key, torch.arange(2, dtype=torch.int64))
    for r in range(2):
        one = model.sweep(torch.from_numpy(s[r]), keys[r]).numpy()
        np.testing.assert_array_equal(got[r], one)
        uc = rng.uniform(rng.phase_key(keys[r], 0), (n,))
        ua = rng.uniform(rng.phase_key(keys[r], 1), (n,))
        ju = (jnp.asarray(uc.numpy()), jnp.asarray(ua.numpy()))
        mid = np.asarray(jmodel._phase(jnp.asarray(s[r]), 0, *ju))
        want = np.asarray(jmodel._phase(jnp.asarray(mid), 1, *ju))
        p = np.where(np.arange(n) % 2 == 0, _model_clock_p(s[r], uc, q, nx),
                     _model_clock_p(mid, uc, q, nx))
        _assert_equal_but_borderline(one, want, ua.numpy(), p, 1e-6)


@pytest.mark.parametrize("ny,nx", SHAPES[:2])
def test_xy_phase_matches_the_jax_model(ny, nx):
    """The plain masked XY phase against JAX ``XY2DHelical._phase`` with
    the same uniforms: components within 5e-7 (cos_sin_2pi against
    jnp.cos of 2πu), decisions but borderline ones equal."""
    g = np.random.default_rng(400 + ny)
    n = ny * nx
    th = g.uniform(0, 2 * np.pi, size=n)
    sx, sy = np.cos(th).astype(np.float32), np.sin(th).astype(np.float32)
    uc, ua = (_uniforms(g, (n,)) for _ in range(2))
    jmodel = JaxXYHelical(nx=nx, ny=ny, kbt=KBT_XY)
    for color in (0, 1):
        wx, wy = jmodel._phase(jnp.asarray(sx), jnp.asarray(sy), color,
                               jnp.asarray(uc.numpy()),
                               jnp.asarray(ua.numpy()))
        gx, gy = hp.xy_phase_plain(
            torch.from_numpy(sx)[None], torch.from_numpy(sy)[None],
            (uc[color::2][None], ua[color::2][None]), color=color, nx=nx,
            beta=1 / KBT_XY)
        d = np.maximum(np.abs(gx[0].numpy() - np.asarray(wx)),
                       np.abs(gy[0].numpy() - np.asarray(wy)))
        off = d > XY_ATOL_MODEL
        hx = (np.roll(sx, -1) + np.roll(sx, 1) + np.roll(sx, -nx)
              + np.roll(sx, nx)).astype(np.float64)
        hy = (np.roll(sy, -1) + np.roll(sy, 1) + np.roll(sy, -nx)
              + np.roll(sy, nx)).astype(np.float64)
        ang = 2 * np.pi * uc.numpy().astype(np.float64)
        de = -((np.cos(ang) - sx) * hx + (np.sin(ang) - sy) * hy)
        p = np.exp(-np.maximum(de, 0.0) / KBT_XY)
        assert np.all(np.abs(ua.numpy() - p)[off] < MARGIN_MODEL)
        assert off.sum() <= 1


# ---------------------------------------------------------------------------
# sums, multisweeps, runners
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ny,nx", SHAPES)
def test_sums_match_the_jax_models(ny, nx):
    """The exact sums against JAX's magne_sum / energy_sum (Ising,
    exactly), its clock model's float32 sums and XY observables, and
    ``helical_pallas.xy_observables_packed`` on ``pack``ed planes
    (relative 1e-5)."""
    g = np.random.default_rng(500 + ny + nx)
    n = ny * nx
    s = (g.integers(0, 2, size=(NREP, n)) * 2 - 1).astype(np.int8)
    got = hp.ising_sums(torch.from_numpy(s), nx)
    jm = JaxIsingHelical(nx=nx, ny=ny, kbt=KBT)
    for r in range(NREP):
        assert int(got[r, 0]) == int(jm.magne_sum(jnp.asarray(s[r])))
        assert int(got[r, 1]) == int(jm.energy_sum(jnp.asarray(s[r])))
    q = 5
    c = g.integers(0, q, size=(NREP, n)).astype(np.int8)
    got = hp.clock_sums(torch.from_numpy(c), nx, q).numpy()
    jc = JaxClockHelical(nx=nx, ny=ny, kbt=KBT_CLOCK, q=q)
    for r in range(NREP):
        mx, my = jc.magne_sums(jnp.asarray(c[r]))
        want = [float(mx), float(my), float(jc.energy_sum(jnp.asarray(c[r])))]
        np.testing.assert_allclose(got[r], want, rtol=1e-5, atol=1e-3)
    th = g.uniform(0, 2 * np.pi, size=(NREP, n))
    sx, sy = np.cos(th).astype(np.float32), np.sin(th).astype(np.float32)
    got = hp.xy_sums(torch.from_numpy(sx), torch.from_numpy(sy), nx)
    jx = JaxXYHelical(nx=nx, ny=ny, kbt=KBT_XY)
    px = jhp.pack(jnp.asarray(sx), ny, nx, jnp.float32)
    py = jhp.pack(jnp.asarray(sy), ny, nx, jnp.float32)
    packed = jhp.xy_observables_packed(jx, px, py)
    for r in range(NREP):
        obs = jx.observables((jnp.asarray(sx[r]), jnp.asarray(sy[r])))
        for k, col in (("m", 0), ("my", 1), ("e", 2)):
            dens = float(got[r, col]) / n
            assert dens == pytest.approx(float(obs[k]), rel=1e-5, abs=1e-6)
            assert dens == pytest.approx(float(packed[k][r]), rel=1e-5,
                                         abs=1e-6)
    # float64 restatement: to float64 rounding
    fx, fy = sx.astype(np.float64), sy.astype(np.float64)
    e = -(fx * (np.roll(fx, -1, -1) + np.roll(fx, -nx, -1))
          + fy * (np.roll(fy, -1, -1) + np.roll(fy, -nx, -1))).sum(-1)
    np.testing.assert_allclose(got[:, 2].numpy(), e, rtol=1e-12)


@pytest.mark.parametrize("ny,nx", SHAPES[:2])
def test_multisweeps_are_phase_pairs(ny, nx):
    """S sweeps of a multisweep equal S pairs of plain phases under the
    same keys, bitwise, with the exact sums of each sweep; the injected
    mode given the Philox words draws the same."""
    n = ny * nx
    g = np.random.default_rng(600 + ny)
    s = torch.from_numpy((g.integers(0, 2, size=(NREP, n)) * 2 - 1)
                         .astype(np.int8))
    seeds = multispin_rng.sweep_phase_keys(rng.sample_key(rng.base_key(3), 0),
                                           5)
    m0 = hp.colour_sites(n, 0)
    got, obs = hp.ising_multisweep_plain(s, seeds, beta=1 / KBT, nx=nx)
    x, bits = s, []
    for t in range(5):
        row = []
        for c in (0, 1):
            w = hp.draw_words(seeds[t, c], NREP, m0)
            row.append(w)
            x = hp.ising_phase_plain(x, w, color=c, nx=nx, beta=1 / KBT)
        assert torch.equal(obs[:, t], hp.ising_sums(x, nx))
        bits.append(torch.stack(row))
    assert torch.equal(got, x)
    bits = torch.stack(bits)
    bits = torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits).to(torch.int32)
    inj, _ = hp.ising_multisweep_plain(s, beta=1 / KBT, nx=nx, bits=bits)
    assert torch.equal(inj, got)
    c = torch.from_numpy(g.integers(0, 6, size=(NREP, n)).astype(np.int8))
    got, obs = hp.clock_multisweep_plain(c, seeds, beta=1 / KBT_CLOCK, nx=nx,
                                         q=6)
    x, us = c, []
    for t in range(5):
        for col in (0, 1):
            uc, ua = hp.draw_uniforms(seeds[t, col], NREP, m0)
            us.append((uc, ua))
            x = hp.clock_phase_plain(x, uc, ua, color=col, nx=nx, q=6,
                                     beta=1 / KBT_CLOCK)
        assert torch.equal(obs[:, t], hp.clock_sums(x, nx, 6))
    assert torch.equal(got, x)
    u = tuple(torch.stack([v[k] for v in us]).view(5, 2, NREP, m0)
              for k in (0, 1))
    inj, _ = hp.clock_multisweep_plain(c, beta=1 / KBT_CLOCK, nx=nx, q=6,
                                       u=u)
    assert torch.equal(inj, got)


def test_draws_follow_the_unit_counters():
    """Ising site k takes output k & 3 of counter (r, k >> 2, 0, 0); clock
    and XY site k outputs 2(k & 1), 2(k & 1) + 1 of (r, k >> 1, 0, 0)."""
    key = rng.seeds_from_key(rng.base_key(5), 1)
    w = hp.draw_words(key, 2, 11)
    uc, ua = hp.draw_uniforms(key, 2, 11)
    for r in range(2):
        for k in range(11):
            out = rng.philox4x32(torch.tensor([r, k >> 2, 0, 0]), key)
            assert int(w[r, k]) == int(out[k & 3])
            out = rng.philox4x32(torch.tensor([r, k >> 1, 0, 0]), key)
            assert float(uc[r, k]) == float(rng.bits_to_uniform(
                out[2 * (k & 1)]))
            assert float(ua[r, k]) == float(rng.bits_to_uniform(
                out[2 * (k & 1) + 1]))


@pytest.mark.parametrize("kind", ["ising", "clock", "xy", "xy_or"])
@pytest.mark.parametrize("ny,nx", SHAPES[:2])
def test_runner_is_chunk_independent(kind, ny, nx):
    """The masked runner's series and final state do not depend on the
    host chunk, at even and odd N."""
    if kind == "ising":
        model = Ising2DHelical(nx=nx, ny=ny, kbt=KBT)
    elif kind == "clock":
        model = Clock2DHelical(nx=nx, ny=ny, kbt=KBT_CLOCK, q=5)
    else:
        model = XY2DHelical(nx=nx, ny=ny, kbt=KBT_XY)
    n_or = 1 if kind == "xy_or" else 0
    key = rng.sample_key(rng.base_key(42), 0)
    runs = [sweep.make_masked_runner(model, 7, 2, "random", "cpu",
                                     n_over_relax=n_or, mcs_over_relax=5,
                                     chunk=ch)(key) for ch in (64, 3)]
    for k in runs[0]:
        assert torch.equal(runs[0][k], runs[1][k])
    assert runs[0]["m"].shape == (2, 7)


@pytest.mark.parametrize("ny,nx", SHAPES[:2])
def test_xy_runner_replays_the_phases(ny, nx):
    """The masked XY runner is the plain phases in the JAX schedule: each
    Metropolis sweep's two phases under the sweep's keys, the fused sums
    of the new state; with OR the reflections and the sums after them."""
    model = XY2DHelical(nx=nx, ny=ny, kbt=KBT_XY)
    key = rng.sample_key(rng.base_key(9), 0)
    for n_or in (0, 1):
        series = sweep.make_masked_runner(model, 3, 2, "random", "cpu",
                                          n_over_relax=n_or)(key)
        st = sweep._init_state(model, "random", 2, key, "cpu")
        sx, sy = st
        seeds = multispin_rng.sweep_phase_keys(key, 3)
        for t in range(3):
            for c in (0, 1):
                sx, sy = hp.xy_phase_plain(sx, sy, seeds[t, c], color=c,
                                           nx=nx, beta=model.beta)
            for _ in range(n_or):
                for c in (0, 1):
                    sx, sy = hp.xy_or_phase_plain(sx, sy, color=c, nx=nx)
            obs = hp.xy_sums(sx, sy, nx) / model.nsites
            for k, col in (("m", 0), ("my", 1), ("e", 2)):
                assert torch.equal(series[k][:, t], obs[:, col])


# ---------------------------------------------------------------------------
# odd N: the Jacobi rule and the TPU kernels' fused-energy fault
# ---------------------------------------------------------------------------

def test_odd_n_wrap_pairs_share_a_colour():
    """At odd N idx 0 and N-1, and rows 0 and ny-1 at each x, are
    neighbours of one colour; at even N no neighbours share one."""
    for ny, nx, pairs in ((31, 33, True), (32, 33, False)):
        n = ny * nx
        idx = np.arange(n)
        same = np.zeros(n, bool)
        for d in (1, -1, nx, -nx):
            same |= (idx & 1) == (((idx + d) % n) & 1)
        assert same.any() == pairs
        if pairs:
            rows = np.unique(idx[same] // nx)
            assert set(rows) == {0, ny - 1}


def test_odd_n_phase_is_jacobi():
    """At odd N a phase reads the pre-phase values of its same-colour wrap
    neighbours: the plain phase equals the TPU rule (which reads the whole
    lattice once), and an in-place update in index order, which reads site
    0 after its flip when it updates site N-1, differs.  Words 2^32 - 1:
    flip iff s·Σnbr <= 0."""
    ny, nx = 31, 33
    n = ny * nx
    s = np.ones((1, n), np.int8)
    # site 0 sees three -1 neighbours and flips; site N-1 sees site 0 and
    # one -1 (N-2) among its others: Σnbr 2 before site 0 flips, 0 after
    s[0, [1, nx, n - nx, n - 2]] = -1
    words = np.full((1, hp.colour_sites(n, 0)), 2 ** 32 - 1, np.uint64)
    got = hp.ising_phase_plain(torch.from_numpy(s),
                               torch.from_numpy(words.astype(np.int64)),
                               color=0, nx=nx, beta=1 / KBT)[0].numpy()
    want, _ = _jax_ising_rule(jnp.asarray(s.astype(np.int32)), 0,
                              jnp.asarray(_colour_words(words, n, 0)
                                          .astype(np.uint32)), 1 / KBT, nx)
    np.testing.assert_array_equal(got, np.asarray(want)[0])
    assert got[0] == -1 and got[n - 1] == 1
    seq = s[0].astype(np.int32).copy()
    for idx in range(0, n, 2):
        nsum = (seq[(idx + 1) % n] + seq[idx - 1] + seq[(idx + nx) % n]
                + seq[idx - nx])
        if seq[idx] * nsum <= 0:
            seq[idx] = -seq[idx]
    assert seq[n - 1] == -1 and not np.array_equal(seq, got)


@pytest.mark.parametrize("ny,nx,faulty", [(32, 33, False), (31, 33, True)])
def test_tpu_fused_energy_fails_at_odd_n(ny, nx, faulty):
    """ROADMAP C6: the TPU kernels fuse e = -Σ_{phase 1} s_new·nsum, each
    bond once only where bonds join opposite colours.  On the rule
    restated, that equals the final state's energy at even N and not at
    odd N, where the port's exact sums still hold."""
    n = ny * nx
    g = np.random.default_rng(21 + ny)
    s = (g.integers(0, 2, size=(NREP, n)) * 2 - 1).astype(np.int32)
    words = _words(g, (NREP, hp.colour_sites(n, 0)))
    x = jnp.asarray(s)
    out, nsum = _jax_ising_rule(x, 1, jnp.asarray(
        _colour_words(words, n, 1).astype(np.uint32)), 1 / KBT, nx)
    pmask = jlattice.helical_parity_mask(n, 1)
    fused = -np.asarray(jnp.sum(jnp.where(pmask, out * nsum, 0), axis=-1))
    exact = hp.ising_sums(torch.from_numpy(np.asarray(out).astype(np.int8)),
                          nx)[:, 1].numpy()
    assert (fused != exact).any() == faulty
    port, obs = hp.ising_multisweep_plain(
        torch.from_numpy(s.astype(np.int8)), beta=1 / KBT, nx=nx,
        bits=torch.zeros((1, 2, NREP, hp.colour_sites(n, 0)),
                         dtype=torch.int32))
    assert torch.equal(obs[:, 0], hp.ising_sums(port, nx))


def test_wrappers_take_plain_versions_on_cpu_and_check_arguments():
    """CPU tensors run the plain versions and count no launch; the shape
    checks refuse even nx, ny < 2 and an index that could pass 2^31."""
    hp.reset_launches()
    model = Ising2DHelical(nx=33, ny=31, kbt=KBT)
    flat = model.init_state("allup", batch=(2,))
    key = rng.sample_key(rng.base_key(1), 0)
    got, dens = hp.multisweep(model, flat, key, 3)
    assert got is flat and dens["m"].shape == (2, 3)
    assert all(v == 0 for v in hp.LAUNCHES.values())
    with pytest.raises(ValueError, match="odd nx"):
        hp.check_shape(1, 64 * 32, 32)
    with pytest.raises(ValueError, match="odd nx"):
        hp.check_shape(1, 33, 33)
    with pytest.raises(ValueError, match="2\\^31"):
        hp.check_shape(1, 46341 * 46341, 46341)
    with pytest.raises(ValueError, match="replicas"):
        hp.check_shape(65536, 33 * 32, 33)
    with pytest.raises(ValueError, match="q="):
        hp.clock_multisweep(torch.zeros((1, 33 * 32), dtype=torch.int8),
                            beta=1.0, nx=33, q=128)
