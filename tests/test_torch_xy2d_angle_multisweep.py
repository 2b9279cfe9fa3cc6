"""Port vs JAX on the same numpy inputs: the int16-angle XY multisweep
(ops/xy2d_multisweep.py), its gate, its runner and its switch.

The JAX kernel (``xy2d_multisweep.py:325``) draws from the TPU's hardware
PRNG and has no interpret path (its tests are marked slow and pin the
codec only), so one launch is restated here from JAX's own jnp pieces:
``_cs``, ``_cos_units``, ``_atan2_units`` and ``stencil.row_parity_mask``
on a whole-plane block, the neighbour sum in ``stencil.nbr_sum``'s order
(up + dn) + (centre + side) with the rows and lanes wrapped by
``jnp.roll`` (``pltpu.roll`` has no evaluation rule outside a kernel),
run op by op, with injected candidate words and uniforms.

Tolerances, and why:

- the codec: ``_cs``, ``_cos_units``, ``_atan2_units`` and
  ``rotate_angles`` bitwise; ``to_angles`` equal but where torch's and
  XLA's float32 arctan2 round a half-unit tie apart, at most 1 unit and
  at most 1 site in 1e4 (0 of the 65536 points here);
  ``from_angles`` (torch and XLA cos/sin) within 2 ulp;
- one launch against the restatement: the int16 state bitwise, the
  sums within 1e-6 · nsites (JAX sums in float32, the port in float64);
- the runner: bitwise independent of ``chunk``; fix1mcs's first row the
  component path's sweep, rotation and measurement."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_fortran_mc_simulation_spin_tpu.ops import stencil
from cuda_fortran_mc_simulation_spin_tpu.ops import xy2d_multisweep as jms
from cuda_fortran_mc_simulation_spin_tpu_torch.core import rng
from cuda_fortran_mc_simulation_spin_tpu_torch.engine import sweep
from cuda_fortran_mc_simulation_spin_tpu_torch.models import XY2D
from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
    multispin_rng,
    xy2d_measure_pallas,
    xy2d_multisweep,
    xy2d_pallas,
)
from cuda_fortran_mc_simulation_spin_tpu_torch.runs.__main__ import main

KBT = 0.89
NREP, NY, HALF = 2, 32, 24
SUM_ATOL_PER_SITE = 1e-6
SWITCH = "SPINLAT_XY_ANGLE_MS"


def _int16(g, shape=(NREP, NY, HALF)) -> np.ndarray:
    return g.integers(-2 ** 15, 2 ** 15, size=shape).astype(np.int16)


def _t(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x.copy())


def _key(seed=3):
    return rng.sample_key(rng.base_key(seed), 0)


def test_cs_and_cos_units_match_jax():
    """Every int16 angle, and the unwrapped differences phase b's A takes
    (down to -98303 units, -1.5 turns)."""
    k = np.arange(-98303, 65536, dtype=np.int32)
    got = xy2d_multisweep._cs(torch.from_numpy(k))
    want = jms._cs(jnp.asarray(k))
    for p, w in zip(got, want):
        np.testing.assert_array_equal(p.numpy(), np.asarray(w))
    np.testing.assert_array_equal(
        xy2d_multisweep._cos_units(torch.from_numpy(k)).numpy(),
        np.asarray(jms._cos_units(jnp.asarray(k))))


def test_atan2_units_matches_jax():
    g = np.random.default_rng(1)
    y = g.normal(size=100_000).astype(np.float32) * 4
    x = g.normal(size=100_000).astype(np.float32) * 4
    axes = np.array([0.0, 1.0, -1.0, 0.0, 0.0, 2.5, -2.5], np.float32)
    y = np.concatenate([y, axes, axes[::-1], x[:100]])
    x = np.concatenate([x, axes[::-1], axes, x[:100]])   # y == x, octants
    got = xy2d_multisweep._atan2_units(torch.from_numpy(y),
                                       torch.from_numpy(x))
    want = jms._atan2_units(jnp.asarray(y), jnp.asarray(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_codec_matches_jax():
    g = np.random.default_rng(2)
    k = np.arange(-2 ** 15, 2 ** 15, dtype=np.int16)
    th = k.astype(np.float64) * (2 * np.pi / 65536) + g.uniform(
        -2e-5, 2e-5, size=k.shape)
    sx, sy = np.cos(th).astype(np.float32), np.sin(th).astype(np.float32)
    got = xy2d_multisweep.to_angles(torch.from_numpy(sx),
                                    torch.from_numpy(sy)).numpy()
    want = np.asarray(jms.to_angles(jnp.asarray(sx), jnp.asarray(sy)))
    assert got.dtype == want.dtype == np.int16
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    diff = np.minimum(diff, 65536 - diff)
    assert diff.max() <= 1 and (diff > 0).sum() <= max(1, 1e-4 * k.size)
    assert (diff > 0).sum() == 0
    # from_angles and angles_to_state: torch's and XLA's cos / sin, within
    # 2 ulp
    k2 = k.reshape(1, 256, 256)
    got = (*xy2d_multisweep.from_angles(torch.from_numpy(k)),
           *xy2d_multisweep.angles_to_state(torch.from_numpy(k2),
                                            torch.from_numpy(k2[:, ::-1]
                                                             .copy())))
    want = (*jms.from_angles(jnp.asarray(k).astype(jnp.int32)),
            *jms.angles_to_state(jnp.asarray(k2),
                                 jnp.asarray(k2[:, ::-1].copy())))
    for p, w in zip(got, want):
        np.testing.assert_allclose(p.numpy(), np.asarray(w), rtol=0,
                                   atol=2 * np.finfo(np.float32).eps)
    # rotate_angles: exact int16 adds
    for theta in (0.3, -2.9, 7.0):
        np.testing.assert_array_equal(
            xy2d_multisweep.rotate_angles(torch.from_numpy(k),
                                          theta).numpy(),
            np.asarray(jms.rotate_angles(jnp.asarray(k),
                                         jnp.float32(theta))))


# ---------------------------------------------------------------------------
# one launch restated from JAX's jnp pieces
# ---------------------------------------------------------------------------

def _jnbr(v, color):
    """``stencil.nbr_sum`` on a whole-plane block (the halo rows are the
    wrap rows): (up + dn) + (centre + side), ``row_parity_mask``."""
    parity = stencil.row_parity_mask(v.shape[-2], 0)
    plus, minus = jnp.roll(v, -1, -1), jnp.roll(v, 1, -1)
    side = (jnp.where(parity, plus, minus) if color == 0
            else jnp.where(parity, minus, plus))
    return jnp.roll(v, 1, -2) + jnp.roll(v, -1, -2) + (v + side)


def _jfield(o, color):
    co, so = jms._cs(o.astype(jnp.int32))
    return _jnbr(co, color), _jnbr(so, color), co, so


def _jmetro(x, o, cand, u, beta, color):
    hx, hy, co, so = _jfield(o, color)
    k = x.astype(jnp.int32)
    cx, sx = jms._cs(k)
    cc, cs_ = jms._cs(cand)
    de = -((cc - cx) * hx + (cs_ - sx) * hy)
    p = jnp.exp(jnp.float32(-beta) * jnp.maximum(de, 0.0))
    accept = u < p
    newk = jnp.where(accept, cand, k)
    return (newk.astype(jnp.int16), newk, jnp.where(accept, cc, cx),
            jnp.where(accept, cs_, sx), hx, hy, co, so)


def _jor(x, o, color):
    hx, hy, _, _ = _jfield(o, color)
    phi = jms._atan2_units(hy, hx)
    return (2 * jnp.round(phi).astype(jnp.int32)
            - x.astype(jnp.int32)).astype(jnp.int16)


def _jsums(bx, by, hx, hy, cax, cay, ka, kb, sa, sb):
    def total(v):
        return jnp.sum(v, axis=(-2, -1))
    a = (total(jms._cos_units(sa.astype(jnp.int32) - ka))
         + total(jms._cos_units(sb.astype(jnp.int32) - kb)))
    return jnp.stack([total(cax) + total(bx), total(cay) + total(by),
                      -total(bx * hx + by * hy), a], axis=-1)


def _jmeasure(pa, pb, sa, sb):
    hx, hy, cax, cay = _jfield(pa, 1)
    kb = pb.astype(jnp.int32)
    bx, by = jms._cs(kb)
    return _jsums(bx, by, hx, hy, cax, cay, pa.astype(jnp.int32), kb, sa,
                  sb)


def _jax_launch(pa, pb, sa, sb, words, beta, n_or, or_only):
    """JAX ``_kernel``'s sweep_body on whole planes, S = len(words)."""
    pa, pb, sa, sb = (jnp.asarray(v) for v in (pa, pb, sa, sb))
    rows = []
    for (ca, ua), (cb, ub) in words:
        if or_only:
            for _ in range(max(n_or, 1)):
                pa = _jor(pa, pb, 0)
                pb = _jor(pb, pa, 1)
            rows.append(_jmeasure(pa, pb, sa, sb))
            continue
        pa = _jmetro(pa, pb, jnp.asarray(ca), jnp.asarray(ua), beta, 0)[0]
        pb, newk, bx, by, hx, hy, cax, cay = _jmetro(
            pb, pa, jnp.asarray(cb), jnp.asarray(ub), beta, 1)
        if n_or == 0:
            rows.append(_jsums(bx, by, hx, hy, cax, cay,
                               pa.astype(jnp.int32), newk, sa, sb))
            continue
        for _ in range(n_or):
            pa = _jor(pa, pb, 0)
            pb = _jor(pb, pa, 1)
        rows.append(_jmeasure(pa, pb, sa, sb))
    return np.asarray(pa), np.asarray(pb), np.stack(
        [np.asarray(r) for r in rows], axis=1)


def _injected(g, sweeps):
    shape = (NREP, NY, HALF)
    return [tuple((g.integers(0, 65536, size=shape).astype(np.int32),
                   g.random(shape, dtype=np.float32)) for _ in range(2))
            for _ in range(sweeps)]


@pytest.mark.parametrize("n_or,or_only", [(0, False), (1, False),
                                          (1, True)])
def test_plain_launch_matches_jax_restated(n_or, or_only):
    g = np.random.default_rng(10 + n_or + 2 * or_only)
    pa, pb, sa, sb = (_int16(g) for _ in range(4))
    words = _injected(g, 2)
    model = XY2D(nx=2 * HALF, ny=NY, kbt=KBT)
    tp, tb = _t(pa), _t(pb)
    obs = xy2d_multisweep.multisweep_plain(
        tp, tb, _t(sa), _t(sb),
        [tuple((_t(c), _t(u)) for c, u in w) for w in words],
        beta=model.beta, n_or=n_or, or_only=or_only)
    ja, jb, jobs = _jax_launch(pa, pb, sa, sb, words, model.beta, n_or,
                               or_only)
    np.testing.assert_array_equal(tp.numpy(), ja)
    np.testing.assert_array_equal(tb.numpy(), jb)
    assert not np.array_equal(ja, pa)
    assert obs.shape == (NREP, 2, 4) and obs.dtype == torch.float64
    np.testing.assert_allclose(obs.numpy(), jobs, rtol=0,
                               atol=SUM_ATOL_PER_SITE * model.nsites)


def test_plain_launch_under_philox_is_the_drawn_words():
    """Under (S, 2, 2) keys the plain launch takes word 0 >> 16 and u24 of
    word 1 of each site's counter (replica, row, column, 0)."""
    g = np.random.default_rng(4)
    pa, pb, sa, sb = (_int16(g) for _ in range(4))
    model = XY2D(nx=2 * HALF, ny=NY, kbt=KBT)
    seeds = multispin_rng.sweep_phase_keys(_key(), 2)
    words = []
    for s in range(2):
        pair = []
        for c in range(2):
            gen = multispin_rng.word_stream(seeds[s, c], NREP, NY, HALF)
            pair.append(((gen() >> 16).to(torch.int32),
                         rng.bits_to_uniform(gen())))
        words.append(tuple(pair))
    planes = [_t(v) for v in (pa, pb)]
    got = xy2d_multisweep.multisweep_plain(*planes, _t(sa), _t(sb), seeds,
                                           beta=model.beta)
    want = xy2d_multisweep.multisweep_plain(_t(pa), _t(pb), _t(sa), _t(sb),
                                            words, beta=model.beta)
    assert torch.equal(got, want)


def test_multisweep_wrapper_keys_by_global_sweep():
    """``multisweep`` (JAX's entry): sweeps t0+1 .. t0+S under the keys of
    their global index, densities of the launch's sums; it refuses a
    lattice outside JAX's ``fits_vmem``."""
    g = np.random.default_rng(6)
    pa, pb, sa, sb = (_int16(g) for _ in range(4))
    model = XY2D(nx=2 * HALF, ny=NY, kbt=KBT)
    a, b = _t(pa), _t(pb)
    a, b, dens = xy2d_multisweep.multisweep(model, a, b, _t(sa), _t(sb),
                                            _key(), 3, n_or=1, t0=5)
    qa, qb = _t(pa), _t(pb)
    seeds = multispin_rng.sweep_phase_keys(_key(), 3, 5)
    obs = xy2d_multisweep.multisweep_plain(qa, qb, _t(sa), _t(sb), seeds,
                                           beta=model.beta, n_or=1)
    assert torch.equal(a, qa) and torch.equal(b, qb)
    for j, k in enumerate(("mx", "my", "e", "A")):
        assert torch.equal(dens[k], obs[..., j] / model.nsites)
    big = XY2D(nx=2048, ny=2048, kbt=KBT)
    with pytest.raises(ValueError, match="fits_vmem"):
        xy2d_multisweep.multisweep(big, a, b, a, b, _key(), 1)


def test_or_only_conserves_energy():
    """Pure over-relaxation sweeps keep the energy to the angle quantum's
    rounding (JAX ``tests/test_tpu_kernels.py:276-296`` asks this of the
    kernel)."""
    g = np.random.default_rng(5)
    model = XY2D(nx=64, ny=64, kbt=KBT)
    th = g.uniform(0.0, 2 * np.pi, size=(NREP, 64, 32))
    pa = (np.round(th * 65536 / (2 * np.pi)) % 65536).astype(
        np.int64).astype(np.int16)
    pb = np.zeros_like(pa)        # a smooth b: a low-energy start
    seeds = multispin_rng.sweep_phase_keys(_key(), 4)
    obs = xy2d_multisweep.multisweep_plain(
        _t(pa), _t(pb), _t(pa), _t(pb), seeds, beta=model.beta, n_or=1,
        or_only=True)
    e = obs[..., 2].numpy() / model.nsites
    assert np.all(np.abs(e - e[:, :1]) < 2e-3)


# ---------------------------------------------------------------------------
# the gate, the route order and the runner
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ny,half", [(1536, 768), (1536, 770), (1024, 1152),
                                     (1500, 750), (16, 8), (2048, 1024)])
def test_fits_is_jax_fits_vmem(ny, half):
    assert xy2d_multisweep.fits(ny, half) == jms.fits_vmem(ny, half)


def test_gate_and_route_order(monkeypatch):
    """The int16 gate is JAX's (fits_vmem, ny % 16, the schedule rules)
    and only under SPINLAT_XY_ANGLE_MS=1, which also sets the resident
    route aside; a shape the gate refuses takes the streamed route."""
    monkeypatch.delenv("SPINLAT_XY_PERIODIC_ANGLE", raising=False)

    def route(model, prep="rotate_first", n_or=0, mcs_or=0, corr=False,
              batch=1):
        return sweep.xy_disorder_route(model, batch, prep, 100, n_or,
                                       mcs_or, corr)

    m1536 = XY2D(nx=1536, ny=1536, kbt=KBT)
    m1500 = XY2D(nx=1500, ny=1500, kbt=KBT)
    monkeypatch.delenv(SWITCH, raising=False)
    assert route(m1536) == sweep.XY_DISORDER_RESIDENT
    assert route(m1500) == sweep.XY_DISORDER_RESIDENT
    assert not sweep.xy_multisweep_eligible(m1536, "rotate_first", 100, 0,
                                            0, False)
    monkeypatch.setenv(SWITCH, "1")
    assert route(m1536) == sweep.XY_DISORDER_INT16
    assert route(m1536, batch=8) == sweep.XY_DISORDER_INT16
    assert route(m1536, "fix1mcs") == sweep.XY_DISORDER_INT16
    assert route(m1536, n_or=1) == sweep.XY_DISORDER_INT16
    assert route(m1536, n_or=1, mcs_or=100) == sweep.XY_DISORDER_INT16
    # JAX's refusals: partial OR schedule, fix1mcs with OR, correlation,
    # ny % 16, fits_vmem
    assert route(m1536, n_or=1, mcs_or=50) == sweep.XY_DISORDER_STREAMED
    assert route(m1536, "fix1mcs", n_or=1) == sweep.XY_DISORDER_STREAMED
    assert route(m1536, corr=True) == sweep.XY_DISORDER_STREAMED
    assert route(m1500) == sweep.XY_DISORDER_STREAMED
    assert route(XY2D(nx=2048, ny=2048, kbt=KBT)) == (
        sweep.XY_DISORDER_STREAMED)
    monkeypatch.setenv("SPINLAT_XY_PERIODIC_ANGLE", "1")
    assert route(m1500) == sweep.XY_DISORDER_ANGLE
    assert route(m1536) == sweep.XY_DISORDER_INT16
    monkeypatch.setenv(SWITCH, "0")
    assert route(m1536) == sweep.XY_DISORDER_RESIDENT


@pytest.mark.parametrize("prep,n_or", [("rotate_first", 0), ("fix1mcs", 0),
                                       ("finite_magne", 1)])
def test_runner_is_chunk_independent(prep, n_or, monkeypatch):
    monkeypatch.setenv(SWITCH, "1")
    model = XY2D(nx=48, ny=32, kbt=KBT)
    runs = [sweep.make_xy_disorder_runner(model, 9, 2, prep,
                                          n_over_relax=n_or, device="cpu",
                                          chunk=c) for c in (64, 4, 1)]
    assert runs[0].engine == sweep.XY_DISORDER_INT16
    out = [r(_key(7)) for r in runs]
    for k in ("mx", "my", "e", "A"):
        assert out[0][k].shape == (2, 9)
        for o in out[1:]:
            assert torch.equal(o[k], out[0][k]), k


@pytest.mark.parametrize("prep", ["rotate_first", "fix1mcs"])
def test_runner_is_the_plain_launch(prep, monkeypatch):
    """The int16 runner: the prepared state converted to int16 angles and
    one plain launch of the sweeps' keys; with fix1mcs first the
    component path's sweep 1, the rotation and its measurement, as JAX's
    runner does."""
    monkeypatch.setenv(SWITCH, "1")
    model = XY2D(nx=48, ny=32, kbt=KBT)
    mcs, key = 6, _key(8)
    got = sweep.make_xy_disorder_runner(model, mcs, 2, prep,
                                        device="cpu")(key)
    st, snap = sweep.xy_prepared(model, prep, 2, key, "cpu")
    seeds = multispin_rng.sweep_phase_keys(key, mcs)
    first = []
    if prep == "fix1mcs":
        st = xy2d_pallas.sweep(model, st, seeds[0])
        theta = -model.magne_angle(st)
        st, snap = model.rotate(st, theta), model.rotate(snap, theta)
        first = [xy2d_measure_pallas.measure(model, st, snap)]
    pa, pb = xy2d_multisweep.state_to_angles(st)
    sa, sb = xy2d_multisweep.state_to_angles(snap)
    obs = xy2d_multisweep.multisweep_plain(pa, pb, sa, sb,
                                           seeds[len(first):],
                                           beta=model.beta)
    dens = xy2d_pallas.densities(model, obs)
    for k in ("mx", "my", "e", "A"):
        want = dens[k]
        if first:
            want = torch.cat([first[0][k][:, None], want], dim=1)
        assert torch.equal(got[k], want), k


@pytest.mark.parametrize("nx,engine", [(32, sweep.XY_DISORDER_INT16),
                                       (30, sweep.XY_DISORDER_STREAMED)])
def test_cli_under_switch(tmp_path, monkeypatch, nx, engine):
    """``SPINLAT_XY_ANGLE_MS=1``: the CLI's from-disorder run names the
    int16 engine where JAX's gate takes the shape, and the streamed
    component route at ny % 16 != 0 (never the resident one)."""
    monkeypatch.setenv(SWITCH, "1")
    monkeypatch.delenv("SPINLAT_XY_PERIODIC_ANGLE", raising=False)
    path = tmp_path / "fd.dat"
    assert main(["--model", "xy2d", "--protocol", "from_disorder", "--nx",
                 str(nx), "--ny", str(nx), "--kbt", str(KBT), "--mcs", "5",
                 "--samples", "4", "--replicas", "2", "--fix1mcs",
                 "--device", "cpu", "--output", str(path)]) in (0, None)
    text = path.read_text()
    assert f"# engine: {engine}" in text
    rows = np.array([r.split() for r in text.splitlines()
                     if not r.startswith("#")], float)
    assert rows.shape[0] == 5 and np.all(np.isfinite(rows))
    np.testing.assert_array_equal(rows[:, 2], np.arange(1, 6))
