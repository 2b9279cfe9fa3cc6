"""Port vs JAX on the same numpy inputs: the periodic XY f32-angle engine
(ops/xy2d_pallas_angle.py), its runners and its switch.

The plain versions of the port's two kernels against the JAX kernels
``_angle_metro_phase`` (``:267``), ``_angle_or_phase`` (``:300``) and
``_angle_metro_snap_phase`` (``:405``) in interpret mode with injected
uniforms, at an aligned width (half 128, unpadded in JAX) and an unaligned
one (half 100, which JAX pads to 128 lanes; the port's planes are not
padded, so its planes are held against JAX's real lanes).  Angles are in
turns.

Tolerances, and why:

- a Metropolis phase (plain, measuring, snapshot): the state bitwise
  (the decode and field are the same float32 chain, the candidate
  u - 0.5 and the kept angle are exact, and the accept decisions agree
  on these inputs);
- an over-relaxation phase: bitwise against JAX's ``_or_math`` on the
  field restated with ``jnp.roll`` (op by op, no fusion); against the JAX
  kernel in interpret mode, which contracts the decode and field chains,
  |Δθ|·|h| <= 1e-6 turns (a field error δh moves φ = atan2(h) by
  |δh| / (2π|h|); the rule and bound of
  tests/test_torch_xy2d_helical_angle.py);
- the fused sums within 1e-6 · nsites (JAX sums in float32, the port in
  float64);
- the runners against a loop over the plain phases under the same
  Philox keys: bitwise, and independent of ``chunk``;
- the angle route against the component route: per-t means of e within
  5 combined standard errors (two independent ensembles)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_fortran_mc_simulation_spin_tpu.models.xy2d import (
    XYState as JaxState,
)
from cuda_fortran_mc_simulation_spin_tpu.ops import trig as jtrig
from cuda_fortran_mc_simulation_spin_tpu.ops import (
    xy2d_pallas_angle as jxa,
)
from cuda_fortran_mc_simulation_spin_tpu_torch.core import rng
from cuda_fortran_mc_simulation_spin_tpu_torch.engine import sweep
from cuda_fortran_mc_simulation_spin_tpu_torch.models import XY2D
from cuda_fortran_mc_simulation_spin_tpu_torch.models.xy2d import XYState
from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
    multispin_rng,
    xy2d_measure_pallas,
    xy2d_pallas_angle,
    xy2d_resident,
)
from cuda_fortran_mc_simulation_spin_tpu_torch.runs.__main__ import main

KBT = 0.89
NY, NREP = 16, 2
HALVES = [128, 100]      # aligned; padded to 128 lanes in JAX
SUM_ATOL_PER_SITE = 1e-6
OR_FIELD_ATOL = 1e-6
ANGLE = "SPINLAT_XY_PERIODIC_ANGLE"


def _turns(g, half, ny=NY, nrep=NREP) -> np.ndarray:
    return g.uniform(-0.5, 0.5, size=(nrep, ny, half)).astype(np.float32)


def _pad(x: np.ndarray):
    """JAX's lane-padded plane of a port plane (pad angles 0)."""
    lanes = -(-x.shape[-1] // 128) * 128
    return jnp.asarray(np.pad(x, [(0, 0), (0, 0),
                                  (0, lanes - x.shape[-1])]))


def _jkw(half):
    lanes = -(-half // 128) * 128
    return dict(nrep=NREP, ny=NY, half=lanes,
                valid_half=half if lanes != half else 0, interpret=True)


def _real(x, half) -> np.ndarray:
    return np.asarray(x)[..., :half]


def _t(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x.copy())


def _assert_sums(got, want, nsites):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=0,
                               atol=SUM_ATOL_PER_SITE * nsites)


def _jax_field(o, color):
    """JAX's ``_field_angles`` on a whole plane: the decode of
    ``jtrig.cos_sin_2pi`` and ``stencil.nbr_sum``'s order
    (up + dn) + (centre + side), the rows and columns wrapped by
    ``jnp.roll``."""
    ox, oy = jtrig.cos_sin_2pi(jnp.asarray(o))
    odd = (jnp.arange(o.shape[-2]) % 2 == 1)[:, None]

    def nbr(v):
        plus, minus = jnp.roll(v, -1, -1), jnp.roll(v, 1, -1)
        side = (jnp.where(odd, plus, minus) if color == 0
                else jnp.where(odd, minus, plus))
        return (jnp.roll(v, 1, -2) + jnp.roll(v, -1, -2)) + (v + side)

    return nbr(ox), nbr(oy)


def test_pack_unpack_match_jax():
    g = np.random.default_rng(0)
    th = g.uniform(0.0, 2 * np.pi, size=(2, NREP, NY, 100))
    comps = [f(th[c]).astype(np.float32) for c in (0, 1)
             for f in (np.cos, np.sin)]
    got = xy2d_pallas_angle.pack_angles(XYState(*(_t(c) for c in comps)))
    want = jxa.pack_angles(JaxState(*(jnp.asarray(c) for c in comps)), 100)
    for p, w in zip(got, want):
        np.testing.assert_array_equal(p.numpy(), _real(w, 100))
        np.testing.assert_array_equal(np.asarray(w)[..., 100:], 0.0)
    back = xy2d_pallas_angle.unpack_angles(got)
    jback = jxa.unpack_angles(want, 100)
    for p, w in zip(back, jback):
        np.testing.assert_array_equal(p.numpy(), np.asarray(w))


@pytest.mark.parametrize("measuring", [False, True])
@pytest.mark.parametrize("color", [0, 1])
@pytest.mark.parametrize("half", HALVES)
def test_metro_phase_matches_jax_kernel(half, color, measuring):
    g = np.random.default_rng(10 * half + 2 * color + measuring)
    s, o = _turns(g, half), _turns(g, half)
    uc, ua = (g.random((NREP, NY, half), dtype=np.float32)
              for _ in range(2))
    model = XY2D(nx=2 * half, ny=NY, kbt=KBT)
    res = jxa._angle_metro_phase(
        _pad(s), _pad(o), jnp.zeros(2, jnp.int32), color=color,
        beta=model.beta, measuring=measuring, u_cand=_pad(uc),
        u_acc=_pad(ua), **_jkw(half))
    out = xy2d_pallas_angle.metro_phase_plain(
        _t(s), _t(o), (_t(uc), _t(ua)), color=color, beta=model.beta,
        measuring=measuring)
    if measuring:
        (js, jobs), (ps, pobs) = res, out
        _assert_sums(pobs, np.asarray(jobs)[:, 0, :3], model.nsites)
    else:
        js, ps = res, out
    np.testing.assert_array_equal(ps.numpy(), _real(js, half))
    assert not np.array_equal(ps.numpy(), s)


@pytest.mark.parametrize("half", HALVES)
def test_snapshot_phase_matches_jax_kernel(half):
    g = np.random.default_rng(half)
    a, b, sa, sb = (_turns(g, half) for _ in range(4))
    uc, ua = (g.random((NREP, NY, half), dtype=np.float32)
              for _ in range(2))
    model = XY2D(nx=2 * half, ny=NY, kbt=KBT)
    jb, jobs = jxa._angle_metro_snap_phase(
        _pad(b), _pad(a), _pad(sb), _pad(sa), jnp.zeros(2, jnp.int32),
        beta=model.beta, u_cand=_pad(uc), u_acc=_pad(ua), **_jkw(half))
    pb, pobs = xy2d_pallas_angle.metro_phase_plain(
        _t(b), _t(a), (_t(uc), _t(ua)), color=1, beta=model.beta,
        snap=(_t(sb), _t(sa)))
    np.testing.assert_array_equal(pb.numpy(), _real(jb, half))
    _assert_sums(pobs, np.asarray(jobs)[:, 0, :4], model.nsites)
    # the snapshot mode's state is the measuring phase's
    mb, _ = xy2d_pallas_angle.metro_phase_plain(
        _t(b), _t(a), (_t(uc), _t(ua)), color=1, beta=model.beta,
        measuring=True)
    assert torch.equal(pb, mb)


@pytest.mark.parametrize("measuring", [False, True])
@pytest.mark.parametrize("color", [0, 1])
@pytest.mark.parametrize("half", HALVES)
def test_or_phase_matches_jax(half, color, measuring):
    g = np.random.default_rng(7 * half + 2 * color + measuring)
    s, o = _turns(g, half), _turns(g, half)
    model = XY2D(nx=2 * half, ny=NY, kbt=KBT)
    out = xy2d_pallas_angle.or_phase_plain(_t(s), _t(o), color=color,
                                           measuring=measuring)
    ps = out[0] if measuring else out
    # JAX's _or_math on the restated whole-plane field: bitwise
    hx, hy = _jax_field(o, color)
    want = jxa._or_math(jnp.asarray(s), hx, hy, None)
    np.testing.assert_array_equal(ps.numpy(), np.asarray(want))
    # the JAX kernel in interpret mode: |Δθ|·|h| <= 1e-6 turns
    res = jxa._angle_or_phase(_pad(s), _pad(o), color=color,
                              measuring=measuring, **_jkw(half))
    js = _real(res[0] if measuring else res, half)
    d = ps.numpy() - js
    d = np.abs(d - np.round(d))
    h = np.hypot(np.asarray(hx), np.asarray(hy))
    assert np.max(d * h) <= OR_FIELD_ATOL
    if measuring:
        _assert_sums(out[1], np.asarray(res[1])[:, 0, :3], model.nsites)


def _keys(seed=5, sample=0):
    return rng.sample_key(rng.base_key(seed), sample)


@pytest.mark.parametrize("n_or,mcs_or", [(0, 0), (1, 0), (2, 5)])
def test_relaxation_runner_is_the_plain_phases(n_or, mcs_or, monkeypatch):
    """The angle route of make_xy_runner: a loop over the plain phases
    under the sweeps' Philox keys, bitwise, at every chunk."""
    monkeypatch.setenv(ANGLE, "1")
    model = XY2D(nx=32, ny=16, kbt=KBT)
    mcs, batch, key = 8, 2, _keys()
    runs = [sweep.make_xy_runner(model, mcs, batch, "random", n_or, mcs_or,
                                 device="cpu", chunk=c)
            for c in (64, 3)]
    assert runs[0].engine == sweep.XY_ANGLE_ENGINE
    got = [r(key) for r in runs]
    st = sweep._init_state(model, "random", batch, key, "cpu")
    a, b = xy2d_pallas_angle.pack_angles(st)
    seeds = multispin_rng.sweep_phase_keys(key, mcs)
    beta = model.beta
    want = {"m": [], "my": [], "e": []}
    for t in range(1, mcs + 1):
        xy2d_pallas_angle.metro_phase_plain(a, b, seeds[t - 1, 0], color=0,
                                            beta=beta)
        with_or = n_or > 0 and t <= (mcs_or or mcs)
        out = xy2d_pallas_angle.metro_phase_plain(
            b, a, seeds[t - 1, 1], color=1, beta=beta,
            measuring=not with_or)
        if with_or:
            for j in range(n_or):
                xy2d_pallas_angle.or_phase_plain(a, b, color=0)
                out = xy2d_pallas_angle.or_phase_plain(
                    b, a, color=1, measuring=j == n_or - 1)
        obs = out[1]
        for j, k in enumerate(want):
            want[k].append(obs[:, j] / model.nsites)
    for k in want:
        w = torch.stack(want[k], dim=1)
        for g in got:
            assert torch.equal(g[k], w), k


@pytest.mark.parametrize("prep,n_or", [("rotate_first", 0), ("fix1mcs", 0),
                                       ("rotate_first", 1), ("fix1mcs", 2)])
def test_disorder_runner_is_the_plain_phases(prep, n_or, monkeypatch):
    """The angle route of make_xy_disorder_runner (JAX's padded angle
    runner's schedule): a loop over the plain phases, the rotation on the
    decoded planes and the measure of the decoded planes, bitwise, at
    every chunk."""
    monkeypatch.setenv(ANGLE, "1")
    monkeypatch.setattr(xy2d_resident, "RESIDENT_MAX_SITES", 0)
    model = XY2D(nx=32, ny=16, kbt=KBT)
    mcs, batch, key = 7, 2, _keys(6)
    runs = [sweep.make_xy_disorder_runner(model, mcs, batch, prep,
                                          n_over_relax=n_or, device="cpu",
                                          chunk=c) for c in (64, 2)]
    assert runs[0].engine == sweep.XY_DISORDER_ANGLE
    got = [r(key) for r in runs]
    st, snap = sweep.xy_prepared(model, prep, batch, key, "cpu")
    a, b = xy2d_pallas_angle.pack_angles(st)
    sa, sb = xy2d_pallas_angle.pack_angles(snap)
    seeds = multispin_rng.sweep_phase_keys(key, mcs)
    want = {k: [] for k in ("mx", "my", "e", "A")}

    def decoded():
        return (xy2d_pallas_angle.unpack_angles((a, b)),
                xy2d_pallas_angle.unpack_angles((sa, sb)))

    for t in range(1, mcs + 1):
        xy2d_pallas_angle.metro_phase_plain(a, b, seeds[t - 1, 0], color=0,
                                            beta=model.beta)
        out = xy2d_pallas_angle.metro_phase_plain(
            b, a, seeds[t - 1, 1], color=1, beta=model.beta,
            snap=None if n_or else (sb, sa))
        if n_or == 0:
            obs = {k: out[1][:, j] / model.nsites
                   for j, k in enumerate(want)}
        if prep == "fix1mcs" and t == 1:
            cur, snp = decoded()
            theta = -model.magne_angle(cur)
            a[:], b[:] = xy2d_pallas_angle.pack_angles(
                model.rotate(cur, theta))
            sa[:], sb[:] = xy2d_pallas_angle.pack_angles(
                model.rotate(snp, theta))
        for _ in range(n_or):
            xy2d_pallas_angle.or_phase_plain(a, b, color=0)
            xy2d_pallas_angle.or_phase_plain(b, a, color=1)
        if n_or or (prep == "fix1mcs" and t == 1):
            obs = xy2d_measure_pallas.measure(model, *decoded())
        for k in want:
            want[k].append(obs[k])
    for k in want:
        w = torch.stack(want[k], dim=1)
        for g in got:
            assert torch.equal(g[k], w), k


def test_switch_routing(monkeypatch):
    """Unset or 0, periodic XY keeps component planes (the parent's route
    and engine line); 1 takes the angle engine on the relaxation at every
    schedule and on the streamed disorder runner; the resident route
    still takes the batches it fits, as in JAX, and track_correlation
    stays on component planes (JAX's padded runner refuses it)."""
    model = XY2D(nx=32, ny=16, kbt=KBT)
    for value in (None, "0", "1"):
        if value is None:
            monkeypatch.delenv(ANGLE, raising=False)
        else:
            monkeypatch.setenv(ANGLE, value)
        want = (sweep.XY_ANGLE_ENGINE if value == "1" else sweep.XY_ENGINE)
        for n_or in (0, 1):
            assert sweep.make_xy_runner(model, 4, 2, n_over_relax=n_or,
                                        device="cpu").engine == want
        assert sweep.make_xy_disorder_runner(
            model, 4, 2, "rotate_first",
            device="cpu").engine == sweep.XY_DISORDER_RESIDENT
        streamed = (sweep.XY_DISORDER_ANGLE if value == "1"
                    else sweep.XY_DISORDER_STREAMED)
        for prep, n_or in (("fix1mcs", 1), ("finite_magne", 2)):
            assert sweep.make_xy_disorder_runner(
                model, 4, 2, prep, n_over_relax=n_or,
                device="cpu").engine == streamed
        assert sweep.make_xy_disorder_runner(
            model, 4, 2, "rotate_first", n_over_relax=1,
            track_correlation=True,
            device="cpu").engine == sweep.XY_DISORDER_STREAMED


def test_angle_route_agrees_with_component_route(monkeypatch):
    """Two independent ensembles at 32x32, kbt 0.89 from all-up: the
    per-t means of e on the angle route and on the component route agree
    within 5 combined standard errors (the same Markov chain)."""
    model = XY2D(nx=32, ny=32, kbt=KBT)
    mcs, batch = 20, 64
    series = {}
    for value, seed in (("0", 1), ("1", 2)):
        monkeypatch.setenv(ANGLE, value)
        run = sweep.make_xy_runner(model, mcs, batch, device="cpu")
        series[value] = run(_keys(seed))["e"].numpy()
    m0, m1 = (series[v].mean(0) for v in ("0", "1"))
    s0, s1 = (series[v].std(0, ddof=1) / np.sqrt(batch) for v in ("0", "1"))
    z = np.abs(m0 - m1) / np.sqrt(s0 ** 2 + s1 ** 2)
    assert np.all(z < 5.0), z.max()
    assert np.all(m1 < -0.5)


def _run_cli(argv, path, monkeypatch, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert main(argv + ["--device", "cpu", "--output", str(path)]) in (
        0, None)
    return path.read_text()


@pytest.mark.parametrize("protocol", ["relaxation", "from_disorder"])
def test_cli_writes_dat_under_switch(tmp_path, monkeypatch, protocol):
    """The CLI under SPINLAT_XY_PERIODIC_ANGLE=1 names the angle engine
    and writes the table the component route writes, row for row."""
    monkeypatch.setattr(xy2d_resident, "RESIDENT_MAX_SITES", 0)
    argv = ["--model", "xy2d", "--protocol", protocol, "--nx", "32",
            "--ny", "16", "--kbt", str(KBT), "--mcs", "6", "--samples", "4",
            "--replicas", "2"]
    if protocol == "relaxation":
        argv += ["--n-over-relax", "1"]
    text = _run_cli(argv, tmp_path / "a.dat", monkeypatch, {ANGLE: "1"})
    ref = _run_cli(argv, tmp_path / "c.dat", monkeypatch, {ANGLE: "0"})
    engine = (sweep.XY_ANGLE_ENGINE if protocol == "relaxation"
              else sweep.XY_DISORDER_ANGLE)
    assert f"# engine: {engine}" in text
    rows = [r for r in text.splitlines() if not r.startswith("#")]
    ref_rows = [r for r in ref.splitlines() if not r.startswith("#")]
    assert len(rows) == len(ref_rows) == 6
    for r, w in zip(rows, ref_rows):
        got, want = np.array(r.split(), float), np.array(w.split(), float)
        assert got.shape == want.shape and np.all(np.isfinite(got))
        np.testing.assert_array_equal(got[:3], want[:3])
