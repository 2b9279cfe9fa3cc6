"""Port vs JAX on the same numpy inputs: the XY disorder slice's model
parts and kernels.

The snapshot-measuring phase (``xy2d_pallas.py:457``), the resident
engine's injected-uniforms phase (``xy2d_resident.py:163``) and the
standalone measurement (``xy2d_measure_pallas.py:121``) in their plain
versions against the JAX kernels in interpret mode or the JAX jnp
oracles; the multisweep's plain version against streamed sweeps; the
model's field sweep, rotations, preparations and correlation sums; the
disorder runner's schedule, chunk invariance, routes and a phase-by-phase
replay through the JAX kernels.

Tolerances are those of ``tests/test_torch_xy2d.py`` (its docstring has
why): the state after a Metropolis phase within 4e-7 a component except
sites whose accept decision differs, which must lie within 1e-6 of the
acceptance boundary and be at most 1 in 1e4; sums within 1e-5 relative
(the JAX kernels sum in float32, the port in float64).  The field sweep
takes torch.cos / torch.sin / torch.exp where JAX takes jnp's, which
differ by 1-2 ulp: held to 4e-7 with the same boundary rule.  A rotation
takes its angle from float64 sums in the port and float32 sums in JAX:
rotated states within 2e-6 a component.  Port against port (plain
multisweep vs streamed sweeps, chunking, routes, batch independence) is
bitwise."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_fortran_mc_simulation_spin_tpu.core import rng as jrng
from cuda_fortran_mc_simulation_spin_tpu.models.xy2d import XY2D as JaxXY
from cuda_fortran_mc_simulation_spin_tpu.models.xy2d import (
    XYState as JaxState,
)
from cuda_fortran_mc_simulation_spin_tpu.ops import xy2d_pallas as jxp
from cuda_fortran_mc_simulation_spin_tpu.ops import xy2d_resident as jxr
from cuda_fortran_mc_simulation_spin_tpu_torch import interop
from cuda_fortran_mc_simulation_spin_tpu_torch.core import rng
from cuda_fortran_mc_simulation_spin_tpu_torch.engine import sweep
from cuda_fortran_mc_simulation_spin_tpu_torch.models import XY2D
from cuda_fortran_mc_simulation_spin_tpu_torch.models.xy2d import XYState
from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
    multispin_rng,
    trig,
    xy2d_measure_pallas,
    xy2d_pallas,
    xy2d_resident,
)

KBT = 0.89
NY, NREP = 16, 2
WIDTHS = [84, 256]      # half 42 (lane-padded to 128 in JAX), 128
STATE_ATOL = 4e-7
SUM_RTOL = 1e-5
BORDER = 1e-6
MAX_FLIP_SHARE = 1e-4
ROT_ATOL = 2e-6


def _lanes(half):
    return -(-half // 128) * 128


def _random_state(g, nx, ny=NY, nrep=NREP) -> XYState:
    th = g.uniform(0.0, 2 * np.pi, size=(2, nrep, ny, nx // 2))
    return XYState(*(torch.from_numpy(f(th[c]).astype(np.float32))
                     for c in (0, 1) for f in (np.cos, np.sin)))


def _clone(st):
    return XYState(*(p.clone() for p in st))


def _by_color(planes, color):
    ax, ay, bx, by = planes
    return (ax, ay, bx, by) if color == 0 else (bx, by, ax, ay)


def _uniforms(g, nx, ny=NY, nrep=NREP):
    return tuple(torch.from_numpy(g.random((nrep, ny, nx // 2),
                                           dtype=np.float32))
                 for _ in range(2))


def _pad(a, width):
    a = np.asarray(a, dtype=np.float32)
    return jnp.asarray(np.pad(a, [(0, 0)] * (a.ndim - 1)
                              + [(0, width - a.shape[-1])]))


def _boundary_ok(got, want, before, color, u, p_fn):
    """Sites that took the same decision agree within STATE_ATOL; the
    others lie within BORDER of the acceptance boundary and are rare.
    ``p_fn(sx, sy, ox, oy, color, u)`` is the float64 threshold the
    acceptance uniform is compared with."""
    gx, gy = (np.asarray(a) for a in got)
    wx, wy = (np.asarray(a) for a in want)
    off = np.maximum(np.abs(gx - wx), np.abs(gy - wy)) > STATE_ATOL
    if off.any():
        p = p_fn(*_by_color(before, color), color, u)
        gap = np.abs(u[1].numpy().astype(np.float64) - p)[off]
        assert np.all(gap < BORDER), gap.max()
        assert off.sum() <= MAX_FLIP_SHARE * off.size, off.sum()
    return int(off.sum())


def _metropolis_p(sx, sy, ox, oy, color, u):
    hx = xy2d_pallas.nbr_sum(ox.double(), color)
    hy = xy2d_pallas.nbr_sum(oy.double(), color)
    cx, cy = (c.double() for c in trig.cos_sin_2pi(u[0]))
    de = -((cx - sx.double()) * hx + (cy - sy.double()) * hy)
    return torch.exp(-de.clamp(min=0.0) / KBT).numpy()


def _assert_sums_close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=SUM_RTOL * max(1.0, np.abs(want).max()))


def _jax_state(st):
    return JaxState(*(jnp.asarray(p.numpy()) for p in st))


# ---------------------------------------------------------------------------
# the snapshot-measuring phase (xy2d_pallas.py:457)
# ---------------------------------------------------------------------------

def _jax_snapshot_phase(st, snap, u):
    """JAX ``_metropolis_phase_b_measure`` in interpret mode on the port's
    state, snapshot and uniforms, zero-padded to its W lanes: ((bx, by)
    cut to half, obs (R, 4))."""
    half = st.ax.shape[-1]
    w = _lanes(half)
    ax, ay, bx, by = (jnp.asarray(p) for p in interop.xy_to_numpy(st, w))
    sn = [jnp.asarray(p) for p in interop.xy_to_numpy(snap, w)]
    got = jxp._metropolis_phase_b_measure(
        bx, by, ax, ay, *sn, jnp.zeros(2, jnp.int32), beta=1.0 / KBT,
        nrep=st.ax.shape[0], ny=st.ax.shape[1], half=w, valid_half=half,
        interpret=True, u_cand=_pad(u[0], w), u_acc=_pad(u[1], w))
    for p in got[:2]:
        np.testing.assert_array_equal(np.asarray(p)[..., half:], 0.0)
    return (tuple(np.asarray(p)[..., :half] for p in got[:2]),
            np.asarray(got[2])[:, 0, :4])


@pytest.mark.parametrize("nx", WIDTHS)
def test_snapshot_phase_matches_jax_kernel(nx):
    """Phase b with the fused (mx, my, e, A) against the t=0 snapshot:
    the plain snapshot mode against JAX ``_metropolis_phase_b_measure``
    (interpret mode, injected uniforms; zero pads at nx = 84), and its
    state bitwise equal to the plain phase without the snapshot."""
    g = np.random.default_rng(300 + nx)
    st, snap = _random_state(g, nx), _random_state(g, nx)
    u = _uniforms(g, nx)
    want, jobs = _jax_snapshot_phase(st, snap, u)
    out = _clone(st)
    got = xy2d_pallas.metropolis_phase(
        *_by_color(out, 1), u, color=1, beta=1 / KBT,
        snap=_by_color(snap, 1))
    assert got[2].shape == (NREP, 4) and got[2].dtype == torch.float64
    _boundary_ok(got[:2], want, st, 1, u, _metropolis_p)
    _assert_sums_close(got[2].numpy(), jobs)
    plain = _clone(st)
    _, _, obs = xy2d_pallas.metropolis_phase(*_by_color(plain, 1), u,
                                             color=1, beta=1 / KBT,
                                             measuring=True)
    assert all(torch.equal(p, q) for p, q in zip(plain, out))
    assert torch.equal(obs, got[2][:, :3])
    model = XY2D(nx=nx, ny=NY, kbt=KBT)
    np.testing.assert_allclose(got[2][:, 3].numpy(),
                               model.autocorrelation_sum(out, snap).numpy(),
                               rtol=1e-6)


def test_sweep_measure_densities():
    """sweep_measure: a Metropolis sweep whose phase b measures against
    the snapshot; densities are the (R, 4) sums over N."""
    g = np.random.default_rng(5)
    st, snap = _random_state(g, 84), _random_state(g, 84)
    model = XY2D(nx=84, ny=NY, kbt=KBT)
    seeds = multispin_rng.sweep_phase_keys(rng.sample_key(rng.base_key(1), 0),
                                           1)[0]
    a = _clone(st)
    a, obs = xy2d_pallas.sweep_measure(model, a, snap, seeds)
    b = _clone(st)
    xy2d_pallas.metropolis_phase(*_by_color(b, 0), seeds[0], color=0,
                                 beta=model.beta)
    _, _, sums = xy2d_pallas.metropolis_phase(
        *_by_color(b, 1), seeds[1], color=1, beta=model.beta,
        snap=_by_color(snap, 1))
    assert all(torch.equal(p, q) for p, q in zip(a, b))
    for j, k in enumerate(("mx", "my", "e", "A")):
        assert torch.equal(obs[k], sums[:, j] / model.nsites)
    full = xy2d_measure_pallas.measure_sums_plain(b, snap)
    np.testing.assert_allclose(sums.numpy(), full.numpy(), rtol=1e-6,
                               atol=1e-4)


# ---------------------------------------------------------------------------
# the resident engine (xy2d_resident.py:163, :257)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("color", [0, 1])
def test_injected_phase_matches_jax_resident_kernel(color):
    """The multisweep's injected mode (plain version) against JAX
    ``phase_with_bits`` in interpret mode and its jnp ``phase_reference``
    on planes zero-padded to 128 lanes (nx = 84); the pads stay put."""
    g = np.random.default_rng(400 + color)
    st = _random_state(g, 84)
    u = _uniforms(g, 84)
    half, w = 42, 128
    planes = [jnp.asarray(p) for p in interop.xy_to_numpy(st, w)]
    sx, sy, ox, oy = _by_color(planes, color)
    uc, ua = _pad(u[0], w), _pad(u[1], w)
    jk = jxr.phase_with_bits(sx + 0, sy + 0, ox, oy, uc, ua, color=color,
                             beta=1 / KBT, nc=half, interpret=True)
    jr = jax.vmap(lambda a, b, c, d, e, f: jxr.phase_reference(
        a, b, c, d, color, e, f, 1 / KBT, half))(sx, sy, ox, oy, uc, ua)
    out = _clone(st)
    got = xy2d_resident.phase_with_bits(*_by_color(out, color), *u,
                                        color=color, beta=1 / KBT)
    for want in (jk, jr):
        for p in want:
            np.testing.assert_array_equal(np.asarray(p)[..., half:], 0.0)
        _boundary_ok(got, [np.asarray(p)[..., :half] for p in want], st,
                     color, u, _metropolis_p)
    ref = _clone(st)
    xy2d_pallas.metropolis_phase(*_by_color(ref, color), u, color=color,
                                 beta=1 / KBT)
    assert all(torch.equal(p, q) for p, q in zip(out, ref))


@pytest.mark.parametrize("snapped", [True, False])
def test_plain_multisweep_is_streamed_sweeps(snapped):
    """multisweep_planes (the plain version on the CPU) equals S streamed
    sweep_measure calls bitwise, state and sums; without a snapshot A is
    0 and the rest unchanged."""
    g = np.random.default_rng(7)
    st, snap = _random_state(g, 84, nrep=3), _random_state(g, 84, nrep=3)
    model = XY2D(nx=84, ny=NY, kbt=KBT)
    key = rng.sample_key(rng.base_key(8), 2)
    seeds = multispin_rng.sweep_phase_keys(key, 5, 3)
    ms = _clone(st)
    obs = xy2d_resident.multisweep_planes(ms, snap if snapped else None,
                                          seeds, beta=model.beta)
    assert obs.shape == (3, 5, 4)
    b = _clone(st)
    for s in range(5):
        b, dens = xy2d_pallas.sweep_measure(model, b, snap, seeds[s])
        for j, k in enumerate(("mx", "my", "e", "A")):
            if k == "A" and not snapped:
                assert torch.all(obs[:, s, j] == 0.0)
            else:
                assert torch.equal(obs[:, s, j] / model.nsites, dens[k]), \
                    (s, k)
    assert all(torch.equal(p, q) for p, q in zip(ms, b))
    _, dens = xy2d_resident.multisweep(model, _clone(st), snap, key, 5, t0=3)
    obs = xy2d_resident.multisweep_planes(_clone(st), snap, seeds,
                                          beta=model.beta)
    assert torch.equal(dens["A"], obs[..., 3] / model.nsites)


def test_resident_route_bound():
    model = XY2D(nx=1500, ny=1500, kbt=KBT)
    bound = xy2d_resident.RESIDENT_MAX_SITES
    assert xy2d_resident.fits(model, 1)
    assert xy2d_resident.fits(model, bound // model.nsites)
    assert not xy2d_resident.fits(model, bound // model.nsites + 1)


# ---------------------------------------------------------------------------
# the standalone measurement (xy2d_measure_pallas.py:121)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nx", WIDTHS)
def test_measure_matches_jax_oracles(nx):
    """measure_sums_plain against the JAX model's magne_sums, energy_sum
    and autocorrelation_sum (float32) and the port model's float64 sums;
    without a snapshot A is 0; the density entries (JAX measure /
    measure_plain names)."""
    g = np.random.default_rng(500 + nx)
    st, snap = _random_state(g, nx), _random_state(g, nx)
    model = XY2D(nx=nx, ny=NY, kbt=KBT)
    jm = JaxXY(nx=nx, ny=NY, kbt=KBT, backend="jnp")
    got = xy2d_measure_pallas.measure_sums(st, snap)
    for r in range(NREP):
        one = JaxState(*(jnp.asarray(p[r].numpy()) for p in st))
        osn = JaxState(*(jnp.asarray(p[r].numpy()) for p in snap))
        mx, my = jm.magne_sums(one)
        want = [mx, my, jm.energy_sum(one), jm.autocorrelation_sum(one, osn)]
        _assert_sums_close(got[r].numpy(), np.asarray(want, np.float64))
    mx, my = model.magne_sums(st)
    exact = torch.stack([mx, my, model.energy_sum(st),
                         model.autocorrelation_sum(st, snap)], dim=-1)
    np.testing.assert_allclose(got.numpy(), exact.numpy(), rtol=1e-12,
                               atol=1e-9)
    bare = xy2d_measure_pallas.measure_sums(st)
    assert torch.equal(bare[:, 3], torch.zeros(NREP, dtype=torch.float64))
    assert torch.equal(bare[:, :3], got[:, :3])
    dens = xy2d_measure_pallas.measure(model, st, snap)
    assert set(dens) == {"mx", "my", "e", "A"}
    assert torch.equal(dens["e"], got[:, 2] / model.nsites)
    assert set(xy2d_measure_pallas.measure_plain(model, st)) == {
        "mx", "my", "e"}


# ---------------------------------------------------------------------------
# the model's disorder parts
# ---------------------------------------------------------------------------

def _jax_field_uniforms(key, shape):
    """The four uniform planes JAX ``field_sweep`` draws under ``key``,
    through its own core/rng.uniform path."""
    k0, k1 = jax.random.split(key)
    return [np.asarray(jrng.uniform(jax.random.fold_in(k, j), shape))
            for k in (k0, k1) for j in (0, 1)]


def _field_p(sx, sy, ox, oy, color, u, h=(0.0, 0.0)):
    """float64 1 - exp(ΔE) of the field sweep (accept iff u <= it)."""
    ang = u[0].double() * 2 * np.pi
    de = -(h[0] * (torch.cos(ang) - sx.double())
           + h[1] * (torch.sin(ang) - sy.double()))
    return (1.0 - torch.exp(de)).numpy()


@pytest.mark.parametrize("hx,hy", [(0.7, 0.0), (-0.3, 1.1)])
def test_field_sweep_matches_jax(hx, hy):
    """field_sweep with JAX's own uniforms (redrawn through the JAX
    core/rng.uniform path) against JAX XY2D.field_sweep, per colour; the
    port's keyed draws give the same with the same planes injected."""
    g = np.random.default_rng(600)
    st = _random_state(g, 84, nrep=1)
    one = XYState(*(p[0] for p in st))
    model = XY2D(nx=84, ny=NY, kbt=KBT)
    jm = JaxXY(nx=84, ny=NY, kbt=KBT, backend="jnp")
    key = jax.random.PRNGKey(11)
    want = jm.field_sweep(_jax_state(one), key, jnp.float32(hx),
                          jnp.float32(hy))
    u = [torch.from_numpy(np.array(a))
         for a in _jax_field_uniforms(key, (NY, 42))]
    got = model.field_sweep(one, None, hx, hy, uniforms=u)
    for c, (sx, sy, ox, oy) in enumerate(((0, 1, 2, 3), (2, 3, 0, 1))):
        before = [one[i][None] for i in (0, 1, 2, 3)]
        _boundary_ok(
            [got[sx][None], got[sy][None]],
            [np.asarray(want[sx])[None], np.asarray(want[sy])[None]],
            before, c, (u[2 * c][None], u[2 * c + 1][None]),
            lambda a, b, _c, _d, _col, uu: _field_p(a, b, None, None, None,
                                                    uu, (hx, hy)))
    keys = rng.fold_in(rng.base_key(3), torch.arange(2))
    drawn = XY2D.field_uniforms(keys, (NY, 42))
    assert all(d.shape == (2, NY, 42) and d.dtype == torch.float32
               for d in drawn)
    batch = XYState(*(p.expand(2, -1, -1).contiguous() for p in one))
    a = model.field_sweep(batch, keys, torch.tensor([hx, hx]),
                          torch.tensor([hy, hy]))
    b = model.field_sweep(batch, None, hx, hy, uniforms=drawn)
    assert all(torch.equal(p, q) for p, q in zip(a, b))


def test_rotations_match_jax():
    """rotate, rotate_magne_toward_xaxis and the updown variant: against
    JAX (ROT_ATOL), Σ S_y ~ 0 with Σ S_x >= 0 and |m| kept after the
    rotation, per replica."""
    g = np.random.default_rng(700)
    st = _random_state(g, 84, nrep=3)
    model = XY2D(nx=84, ny=NY, kbt=KBT)
    jm = JaxXY(nx=84, ny=NY, kbt=KBT, backend="jnp")
    theta = torch.tensor([0.3, -2.0, 4.0], dtype=torch.float64)
    rot = model.rotate(st, theta)
    rotx = model.rotate_magne_toward_xaxis(st)
    for r in range(3):
        one = JaxState(*(jnp.asarray(p[r].numpy()) for p in st))
        want = jm.rotate(one, jnp.float32(theta[r]))
        for p, q in zip(rot, want):
            np.testing.assert_allclose(p[r].numpy(), np.asarray(q), rtol=0,
                                       atol=ROT_ATOL)
        want = jm.rotate_magne_toward_xaxis(one)
        for p, q in zip(rotx, want):
            np.testing.assert_allclose(p[r].numpy(), np.asarray(q), rtol=0,
                                       atol=ROT_ATOL)
    mx0, my0 = model.magne_sums(st)
    mx, my = model.magne_sums(rotx)
    assert torch.all(my.abs() < 1e-4) and torch.all(mx > 0)
    np.testing.assert_allclose(mx.numpy(), torch.hypot(mx0, my0).numpy(),
                               rtol=1e-6)
    keys = rng.fold_in(rng.base_key(9), torch.arange(3))
    ud = model.rotate_magne_toward_xaxis_updown_randomly(st, keys)
    coin = rng.uniform(keys[0], (1,))[0] < 0.5
    mxu, myu = model.magne_sums(ud)
    assert torch.all(myu.abs() < 1e-4)
    np.testing.assert_allclose(mxu.abs().numpy(), mx.numpy(), rtol=1e-6)
    assert bool(mxu[0] < 0) == bool(coin)


def test_correlation_sums_match_jax():
    g = np.random.default_rng(800)
    st, snap = _random_state(g, 84, nrep=1), _random_state(g, 84, nrep=1)
    one, osn = (XYState(*(p[0] for p in s)) for s in (st, snap))
    model = XY2D(nx=84, ny=NY, kbt=KBT)
    jm = JaxXY(nx=84, ny=NY, kbt=KBT, backend="jnp")
    _assert_sums_close(float(model.correlation_sum(one)),
                       float(jm.correlation_sum(_jax_state(one))))
    _assert_sums_close(
        float(model.autocorrelation_sum(one, osn)),
        float(jm.autocorrelation_sum(_jax_state(one), _jax_state(osn))))
    full = model.full_vectors(one)
    shifted = np.roll(full, (-(NY // 2 - 1), -(84 // 2 - 1)), axis=(0, 1))
    np.testing.assert_allclose(float(model.correlation_sum(one)),
                               (full * shifted).sum(), rtol=1e-12)
    both = model.correlation_sum(st)
    assert both.shape == (1,) and both.dtype == torch.float64


PREP_M0, PREP_EPS = 0.3, 1e-2


def test_prep_finite_magne():
    """|m| within eps·m0 of m0 and m along +x in every replica; replica r
    prepared alone equals replica r of the batch, bitwise."""
    model = XY2D(nx=32, ny=32, kbt=KBT)
    keys = rng.fold_in(rng.init_key(rng.sample_key(rng.base_key(12), 0)),
                       torch.arange(4))
    st = model.prep_finite_magne(keys, PREP_M0, eps=PREP_EPS)
    mx, my = (v / model.nsites for v in model.magne_sums(st))
    assert torch.all((mx - PREP_M0).abs() <= PREP_EPS * PREP_M0 * 1.0001), mx
    assert torch.all(my.abs() < 1e-6)
    alone = model.prep_finite_magne(keys[2:3], PREP_M0, eps=PREP_EPS)
    assert all(torch.equal(p[2], q[0]) for p, q in zip(st, alone))


def test_prep_finite_magne_ensemble_matches_jax():
    """The prepared ensemble at 32x32 (m0 = 0.3): <e> over 32 replicas
    within 5 combined standard errors of the JAX preparation's."""
    model = XY2D(nx=32, ny=32, kbt=KBT)
    jm = JaxXY(nx=32, ny=32, kbt=KBT, backend="jnp")
    keys = rng.fold_in(rng.init_key(rng.sample_key(rng.base_key(13), 0)),
                       torch.arange(32))
    e = (model.energy_sum(model.prep_finite_magne(keys, PREP_M0))
         / model.nsites).numpy()
    jkeys = jax.random.split(jax.random.PRNGKey(13), 32)
    jst = jax.vmap(lambda k: jm.prep_finite_magne(k, PREP_M0))(jkeys)
    je = np.asarray(jax.vmap(jm.energy_sum)(jst), np.float64) / model.nsites
    se = np.sqrt(e.var(ddof=1) / e.size + je.var(ddof=1) / je.size)
    assert abs(e.mean() - je.mean()) < 5 * se, (e.mean(), je.mean(), se)


@pytest.mark.parametrize("tol", [None, 0.9])
def test_prep_small_magne(tol):
    """set_random_small_spin drives |m| below near_magne;
    set_random_near_spin stops within tol of it.  The field (-mx, -my)
    only lowers |m|, in steps of ~0.003 at 32x32, so the random start
    (|m| ~ 0.03) reaches [0.0005, 0.0095] from above; m along +x; batch
    independence."""
    model = XY2D(nx=32, ny=32, kbt=KBT)
    keys = rng.fold_in(rng.init_key(rng.sample_key(rng.base_key(14), 0)),
                       torch.arange(3))
    target = 0.01 if tol is None else 0.005
    st = model.prep_small_magne(keys, target, tol=tol)
    mx, my = (v / model.nsites for v in model.magne_sums(st))
    if tol is None:
        assert torch.all(mx < target)
    else:
        assert torch.all((mx - target).abs() / target <= tol)
    assert torch.all(my.abs() < 1e-6) and torch.all(mx >= 0)
    alone = model.prep_small_magne(keys[2:3], target, tol=tol)
    assert all(torch.equal(p[2], q[0]) for p, q in zip(st, alone))


# ---------------------------------------------------------------------------
# the runner
# ---------------------------------------------------------------------------

def _record(monkeypatch):
    """Record the launches the runner makes."""
    calls = []
    for mod, name, tag in ((xy2d_pallas, "metropolis_phase", "M"),
                           (xy2d_pallas, "over_relax_phase", "OR"),
                           (xy2d_measure_pallas, "measure_sums", "MEAS"),
                           (xy2d_resident, "multisweep_planes", "MS")):
        orig = getattr(mod, name)

        def rec(*a, _orig=orig, _tag=tag, **kw):
            if _tag == "M":
                calls.append((_tag, kw["color"], kw.get("snap") is not None))
            elif _tag == "MS":
                calls.append((_tag, a[2].shape[0]))
            else:
                calls.append((_tag,))
            return _orig(*a, **kw)

        monkeypatch.setattr(mod, name, rec)
    return calls


def _expected(mcs, prep, n_or, mcs_or, resident, chunk=64):
    sweep_m = [("M", 0, False), ("M", 1, True)]
    order = []
    t = 1
    while t <= mcs:
        size = min(chunk, mcs - t + 1)
        if resident:
            if prep == "fix1mcs" and t == 1:
                order += sweep_m + [("MEAS",)]
                if size > 1:
                    order.append(("MS", size - 1))
            else:
                order.append(("MS", size))
        else:
            for tt in range(t, t + size):
                if n_or and tt <= mcs_or:
                    order += [("M", 0, False), ("M", 1, False)]
                    order += [("OR",)] * (2 * n_or) + [("MEAS",)]
                else:
                    order += sweep_m
                    if prep == "fix1mcs" and tt == 1:
                        order.append(("MEAS",))
        t += size
    return order


def _route(monkeypatch, resident: bool):
    """Send every batch to the resident route, or none."""
    monkeypatch.setattr(xy2d_resident, "RESIDENT_MAX_SITES",
                        10 ** 12 if resident else 0)


@pytest.mark.parametrize("prep,n_or,mcs_or,resident", [
    ("rotate_first", 0, 0, False), ("rotate_first", 0, 0, True),
    ("fix1mcs", 0, 0, False), ("fix1mcs", 0, 0, True),
    ("fix1mcs", 2, 2, True), ("finite_magne", 1, 0, True),
])
def test_runner_schedule(prep, n_or, mcs_or, resident, monkeypatch):
    """The launches of JAX's batched and resident disorder runners: a
    snapshot-measuring sweep; with OR (t <= mcs_over_relax) a Metropolis
    sweep, n OR sweeps and measure_kernel; fix1mcs re-measures at t=1; the
    resident route one multisweep a chunk (from t=2 after the streamed
    fix1mcs step), never with over-relaxation."""
    _route(monkeypatch, resident)
    calls = _record(monkeypatch)
    model = XY2D(nx=84, ny=NY, kbt=KBT)
    run = sweep.make_xy_disorder_runner(
        model, 4, NREP, prep, init_magne=0.3, n_over_relax=n_or,
        mcs_over_relax=mcs_or, device="cpu", chunk=3)
    series = run(rng.sample_key(rng.base_key(1), 0))
    resident = resident and not n_or
    assert calls == _expected(4, prep, n_or, mcs_or or 4, resident, 3)
    assert {k: tuple(v.shape) for k, v in series.items()} == {
        k: (NREP, 4) for k in ("mx", "my", "e", "A")}
    assert run.engine == (sweep.XY_DISORDER_RESIDENT if resident
                          else sweep.XY_DISORDER_STREAMED)


def test_runner_route_choice():
    model = XY2D(nx=84, ny=NY, kbt=KBT)
    mk = sweep.make_xy_disorder_runner
    assert mk(model, 2, 2, "rotate_first", device="cpu").engine == \
        sweep.XY_DISORDER_RESIDENT
    for kw in (dict(n_over_relax=1), dict(track_correlation=True)):
        assert mk(model, 2, 2, "rotate_first", device="cpu",
                  **kw).engine == sweep.XY_DISORDER_STREAMED
    big = XY2D(nx=1500, ny=1500, kbt=KBT)
    r = xy2d_resident.RESIDENT_MAX_SITES // big.nsites
    assert mk(big, 2, r + 1, "fix1mcs", device="cpu").engine == \
        sweep.XY_DISORDER_STREAMED
    with pytest.raises(ValueError):
        mk(model, 2, 2, "allup", device="cpu")


@pytest.mark.parametrize("prep", ["rotate_first", "fix1mcs"])
def test_runner_chunk_and_route_invariance(prep, monkeypatch):
    """Bitwise the same series for chunks of 2 and of 64 sweeps, resident
    and streamed (keys by the global sweep index)."""
    model = XY2D(nx=84, ny=NY, kbt=KBT)
    key = rng.sample_key(rng.base_key(4), 1)
    runs = []
    for res in (True, False):
        _route(monkeypatch, res)
        runs += [sweep.make_xy_disorder_runner(model, 5, NREP, prep,
                                               device="cpu", chunk=c)(key)
                 for c in (2, 64)]
    for r in runs[1:]:
        for k in runs[0]:
            assert torch.equal(runs[0][k], r[k]), k


def test_runner_track_correlation():
    model = XY2D(nx=84, ny=NY, kbt=KBT)
    key = rng.sample_key(rng.base_key(5), 0)
    run = sweep.make_xy_disorder_runner(model, 2, NREP, "rotate_first",
                                        track_correlation=True, device="cpu")
    series = run(key)
    st, _ = sweep.xy_prepared(model, "rotate_first", NREP, key, "cpu")
    seeds = multispin_rng.sweep_phase_keys(key, 1)
    xy2d_pallas.sweep(model, st, seeds[0])
    assert torch.equal(series["corr"][:, 0],
                       model.correlation_sum(st) / model.nsites)


def test_runner_replayed_through_the_jax_kernels():
    """The slice as a whole: the fix1mcs runner (random start, rotation of
    state and snapshot after sweep 1, then snapshot-measuring sweeps)
    replayed phase by phase on the CPU; every phase held against the JAX
    kernel from the port's state with the port's uniforms (phase b against
    ``_metropolis_phase_b_measure``), the rotation against JAX's, and the
    replay's series equal to the runner's bitwise."""
    model = XY2D(nx=84, ny=NY, kbt=KBT)
    jm = JaxXY(nx=84, ny=NY, kbt=KBT, backend="jnp")
    mcs, key = 3, rng.sample_key(rng.base_key(6), 0)
    series = sweep.make_xy_disorder_runner(model, mcs, NREP, "fix1mcs",
                                           device="cpu")(key)
    st, snap = sweep.xy_prepared(model, "fix1mcs", NREP, key, "cpu")
    seeds = multispin_rng.sweep_phase_keys(key, mcs)
    flips = 0
    for t in range(mcs):
        u0 = xy2d_pallas.draw_uniforms(seeds[t, 0], NREP, NY, 42)
        half, w = 42, 128
        planes = [jnp.asarray(p) for p in interop.xy_to_numpy(st, w)]
        jr = jxp._metropolis_phase(
            *planes, jnp.zeros(2, jnp.int32), color=0, beta=1 / KBT,
            nrep=NREP, ny=NY, half=w, valid_half=half, interpret=True,
            u_cand=_pad(u0[0], w), u_acc=_pad(u0[1], w))
        before = _clone(st)
        xy2d_pallas.metropolis_phase(*_by_color(st, 0), seeds[t, 0], color=0,
                                     beta=model.beta)
        flips += _boundary_ok(st[:2], [np.asarray(p)[..., :half]
                                       for p in jr], before, 0, u0,
                              _metropolis_p)
        u1 = xy2d_pallas.draw_uniforms(seeds[t, 1], NREP, NY, 42)
        want, jobs = _jax_snapshot_phase(st, snap, u1)
        before = _clone(st)
        _, _, obs = xy2d_pallas.metropolis_phase(
            *_by_color(st, 1), seeds[t, 1], color=1, beta=model.beta,
            snap=_by_color(snap, 1))
        flips += _boundary_ok(st[2:], want, before, 1, u1, _metropolis_p)
        _assert_sums_close(obs.numpy(), jobs)
        if t == 0:
            theta = -model.magne_angle(st)
            rot = model.rotate(st, theta), model.rotate(snap, theta)
            for r in range(NREP):
                for port, src in zip(rot, (st, snap)):
                    one = JaxState(*(jnp.asarray(p[r].numpy()) for p in st))
                    jsrc = JaxState(*(jnp.asarray(p[r].numpy())
                                      for p in src))
                    mxj, myj = jm.magne_sums(one)
                    jw = jm.rotate(jsrc, -jnp.arctan2(myj, mxj))
                    for p, q in zip(port, jw):
                        np.testing.assert_allclose(p[r].numpy(),
                                                   np.asarray(q), rtol=0,
                                                   atol=ROT_ATOL)
            st, snap = rot
            obs = xy2d_measure_pallas.measure_sums(st, snap)
        for j, k in enumerate(("mx", "my", "e", "A")):
            assert torch.equal(series[k][:, t], obs[:, j] / model.nsites)
    assert flips <= MAX_FLIP_SHARE * 2 * mcs * NREP * NY * 42
    # fix1mcs: after the rotation m lies along +x
    assert torch.all(series["my"][:, 0].abs() < 1e-7)
    assert torch.all(series["mx"][:, 0] > 0)
