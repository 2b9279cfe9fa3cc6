"""Port vs JAX on the same numpy inputs: the periodic XY slice.

The trig helpers, the model (init states, observables, its phases), the
plain Metropolis and over-relaxation phases against the JAX kernels in
interpret mode (lane-unaligned nx = 84: half 42 in W = 128 lanes; aligned
nx = 256), the runner's schedule, its chunk invariance and its replay
through the JAX kernels, interop and the CLI.

Tolerances, and why.  The JAX package holds its own padded kernel to its
jnp phase at atol 4e-7, not bitwise (tests/test_xy2d_padded.py): XLA
contracts or reorders mul-add chains that torch runs one rounding at a
time, ``jnp.exp`` and ``torch.exp`` differ by 1 ulp on ~10% of inputs
and ``lax.rsqrt`` and ``torch.rsqrt`` by up to 2 ulp.  So:

- the state after a Metropolis phase: |Δ| <= 4e-7 a component, except a
  site whose accept decision differs; such a site has |u_acc - p| < 1e-6
  (p in float64) and at most 1 site in 1e4 may differ;
- the state after an over-relaxation phase: |Δ| <= 1e-6;
- the fused sums: relative 1e-5 (the JAX kernels sum in float32, the port
  in float64);
- runners: replayed phase by phase, each phase started in both packages
  from the port's state with the port's uniforms, so that a borderline
  decision cannot spread;
- the CLI: m and e within 5 combined standard errors at every t (the
  packages draw different random streams).
Port against port (model vs plain phase, chunking) is bitwise."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_fortran_mc_simulation_spin_tpu.models.xy2d import XY2D as JaxXY
from cuda_fortran_mc_simulation_spin_tpu.ops import trig as jtrig
from cuda_fortran_mc_simulation_spin_tpu.ops import xy2d_pallas as jxp
from cuda_fortran_mc_simulation_spin_tpu.runs.__main__ import main as jax_main
from cuda_fortran_mc_simulation_spin_tpu_torch import interop
from cuda_fortran_mc_simulation_spin_tpu_torch.core import rng
from cuda_fortran_mc_simulation_spin_tpu_torch.engine import sweep
from cuda_fortran_mc_simulation_spin_tpu_torch.models import XY2D
from cuda_fortran_mc_simulation_spin_tpu_torch.models.xy2d import XYState
from cuda_fortran_mc_simulation_spin_tpu_torch.ops import multispin_rng, trig
from cuda_fortran_mc_simulation_spin_tpu_torch.ops import xy2d_pallas as xp
from cuda_fortran_mc_simulation_spin_tpu_torch.runs.__main__ import main

KBT = 0.89
NY, NREP = 16, 2
WIDTHS = [84, 256]      # half 42 (W = 128, lane-padded in JAX), 128
STATE_ATOL = 4e-7
OR_ATOL = 1e-6
SUM_RTOL = 1e-5
BORDER = 1e-6
MAX_FLIP_SHARE = 1e-4


def _lanes(half):
    return -(-half // 128) * 128


def _random_state(g, nx, ny=NY, nrep=NREP) -> XYState:
    th = g.uniform(0.0, 2 * np.pi, size=(2, nrep, ny, nx // 2))
    return XYState(*(torch.from_numpy(f(th[c]).astype(np.float32))
                     for c in (0, 1) for f in (np.cos, np.sin)))


def _clone(st):
    return XYState(*(p.clone() for p in st))


def _by_color(planes, color):
    """(sx, sy, ox, oy) of the colour updated."""
    ax, ay, bx, by = planes
    return (ax, ay, bx, by) if color == 0 else (bx, by, ax, ay)


def _pad(a, width):
    a = np.asarray(a, dtype=np.float32)
    return jnp.asarray(np.pad(a, [(0, 0)] * (a.ndim - 1)
                              + [(0, width - a.shape[-1])]))


def _jax_phase(st, color, beta=None, u=None, measuring=False):
    """The JAX phase kernel in interpret mode on the port's state (and
    uniforms), zero-padded to its W lanes.  Returns ((sx, sy) cut to half,
    obs (R, 3) or None)."""
    half = st.ax.shape[-1]
    w = _lanes(half)
    sx, sy, ox, oy = _by_color(
        [jnp.asarray(p) for p in interop.xy_to_numpy(st, w)], color)
    kw = dict(color=color, nrep=st.ax.shape[0], ny=st.ax.shape[1], half=w,
              valid_half=half if w != half else 0, measuring=measuring,
              interpret=True)
    if u is None:
        res = jxp._over_relax_phase(sx, sy, ox, oy, **kw)
    else:
        res = jxp._metropolis_phase(
            sx, sy, ox, oy, jnp.zeros(2, jnp.int32), beta=float(beta),
            u_cand=_pad(u[0], w), u_acc=_pad(u[1], w), **kw)
    out = tuple(np.asarray(p)[..., :half] for p in res[:2])
    for p in res[:2]:
        np.testing.assert_array_equal(np.asarray(p)[..., half:], 0.0)
    obs = np.asarray(res[2])[:, 0, :3] if measuring else None
    return out, obs


def _accept_prob(sx, sy, ox, oy, color, u_cand, beta):
    """float64 acceptance probability of every site."""
    hx = xp.nbr_sum(ox.double(), color)
    hy = xp.nbr_sum(oy.double(), color)
    cx, cy = (c.double() for c in trig.cos_sin_2pi(u_cand))
    de = -((cx - sx.double()) * hx + (cy - sy.double()) * hy)
    return torch.exp(-beta * de.clamp(min=0.0)).numpy()


def _assert_metropolis_close(got, want, before, color, u, beta):
    """The state tolerance of the module docstring: sites that took the
    same decision within STATE_ATOL, the others borderline and rare."""
    gx, gy = (np.asarray(a) for a in got)
    wx, wy = (np.asarray(a) for a in want)
    d = np.maximum(np.abs(gx - wx), np.abs(gy - wy))
    off = d > STATE_ATOL
    if off.any():
        sx, sy, ox, oy = _by_color(before, color)
        p = _accept_prob(sx, sy, ox, oy, color, u[0], beta)
        gap = np.abs(u[1].numpy().astype(np.float64) - p)[off]
        assert np.all(gap < BORDER), gap.max()
        assert off.sum() <= MAX_FLIP_SHARE * off.size, off.sum()
    return int(off.sum())


def _assert_sums_close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=SUM_RTOL * max(1.0, np.abs(want).max()))


# ---------------------------------------------------------------------------
# trig
# ---------------------------------------------------------------------------

def test_trig_matches_jax():
    """cos_sin_2pi over (-1, 1), exp_neg over [0, 30] and atan2_2pi on
    random pairs: equal to the JAX module's on the CPU (both evaluate the
    same float32 chain op by op), and within tests/test_trig.py's
    accuracy of float64."""
    g = np.random.default_rng(1)
    u = np.concatenate([g.uniform(-1, 1, 100000),
                        [-0.875, -0.5, -0.25, 0.0, 0.25, 0.5, 0.75]]
                       ).astype(np.float32)
    c, s = trig.cos_sin_2pi(torch.from_numpy(u))
    jc, js = jtrig.cos_sin_2pi(jnp.asarray(u))
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_allclose(c.numpy(), np.cos(2 * np.pi * u.astype(
        np.float64)), atol=2e-7)
    x = np.concatenate([g.uniform(0, 30, 100000), [0.0]]).astype(np.float32)
    e = trig.exp_neg(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(e, np.asarray(jtrig.exp_neg(
        jnp.asarray(x))))
    assert e[-1] == 1.0
    want = np.exp(-x.astype(np.float64))
    assert np.max(np.abs(e - want) / want) < 3e-7
    y, xx = (g.normal(size=100000).astype(np.float32) for _ in range(2))
    a = trig.atan2_2pi(torch.from_numpy(y), torch.from_numpy(xx)).numpy()
    np.testing.assert_array_equal(a, np.asarray(jtrig.atan2_2pi(
        jnp.asarray(y), jnp.asarray(xx))))
    assert float(trig.atan2_2pi(torch.zeros(1), torch.zeros(1))[0]) == 0.0


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------

def test_init_states():
    model = XY2D(nx=84, ny=NY, kbt=KBT)
    up = model.init_state("allup", batch=(NREP,))
    jup = JaxXY(nx=84, ny=NY, kbt=KBT).init_state("allup")
    for p, q in zip(up, jup):
        assert p.shape == (NREP, NY, 42) and p.dtype == torch.float32
        np.testing.assert_array_equal(p[0].numpy(), np.asarray(q))
    key = rng.sample_key(rng.base_key(3), 0)
    st = model.init_state("random", key, batch=(NREP,))
    again = model.init_state("random", key, batch=(NREP,))
    for p, q in zip(st, again):
        assert torch.equal(p, q)
    for x, y in ((st.ax, st.ay), (st.bx, st.by)):
        np.testing.assert_allclose(torch.hypot(x, y).numpy(), 1.0,
                                   atol=2e-7)
    assert not torch.equal(st.ax, st.bx)
    # the angles are uniform: the magnetisation is O(sqrt N), not O(N)
    m = model.observables(st)["m"]
    assert np.all(np.abs(m.numpy()) < 5.0 / np.sqrt(model.nsites))
    with pytest.raises(ValueError):
        model.init_state("finite_magne", key)


@pytest.mark.parametrize("nx", WIDTHS)
def test_observables_match_jax_and_numpy(nx):
    """magne_sums / energy_sum / observables against JAX XY2D (float32
    sums) and energy_sum_numpy on full_vectors (float64)."""
    g = np.random.default_rng(nx)
    st = _random_state(g, nx, nrep=1)
    model = XY2D(nx=nx, ny=NY, kbt=KBT)
    jmodel = JaxXY(nx=nx, ny=NY, kbt=KBT, backend="jnp")
    one = XYState(*(p[0] for p in st))
    obs = model.observables(one)
    jobs = jmodel.observables(XYState(*(jnp.asarray(p.numpy())
                                        for p in one)))
    for k in ("m", "my", "e"):
        _assert_sums_close(obs[k].numpy(), np.asarray(jobs[k]))
    full = model.full_vectors(one)
    assert full.shape == (NY, nx, 2)
    np.testing.assert_allclose(float(model.energy_sum(one)),
                               XY2D.energy_sum_numpy(full), rtol=1e-12)
    np.testing.assert_allclose(
        float(model.magne_sums(one)[0]), full[..., 0].sum(), rtol=1e-12)
    # batched: per replica
    both = model.observables(_random_state(g, nx))
    assert both["e"].shape == (NREP,)


@pytest.mark.parametrize("nx", WIDTHS)
@pytest.mark.parametrize("color", [0, 1])
def test_model_phases_match_jax_and_the_plain_phase(nx, color):
    """The model's jnp-style phases: Metropolis against JAX XY2D._phase
    (state tolerance), OR against JAX XY2D._or_phase (OR_ATOL), and both
    bitwise equal to the ops module's plain phases (one arithmetic, the
    field in the kernel's order)."""
    g = np.random.default_rng(10 + nx + color)
    st = _random_state(g, nx, nrep=1)
    model = XY2D(nx=nx, ny=NY, kbt=KBT)
    jmodel = JaxXY(nx=nx, ny=NY, kbt=KBT, backend="jnp")
    u = tuple(torch.from_numpy(g.random((1, NY, nx // 2),
                                        dtype=np.float32)) for _ in range(2))
    sx, sy, ox, oy = _by_color(st, color)
    got = model._phase(sx[0], sy[0], ox[0], oy[0], color, u[0][0], u[1][0])
    want = jmodel._phase(*(jnp.asarray(p[0].numpy())
                           for p in (sx, sy, ox, oy)), color,
                         jnp.asarray(u[0][0].numpy()),
                         jnp.asarray(u[1][0].numpy()))
    _assert_metropolis_close([a[None] for a in got],
                             [np.asarray(a)[None] for a in want], st, color,
                             u, model.beta)
    plain = _clone(st)
    xp.metropolis_phase(*_by_color(plain, color), u, color=color,
                        beta=model.beta)
    px, py, _, _ = _by_color(plain, color)
    assert torch.equal(px[0], got[0]) and torch.equal(py[0], got[1])

    got = model._or_phase(sx[0], sy[0], ox[0], oy[0], color)
    want = jmodel._or_phase(*(jnp.asarray(p[0].numpy())
                              for p in (sx, sy, ox, oy)), color)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=OR_ATOL)
    plain = _clone(st)
    xp.over_relax_phase(*_by_color(plain, color), color=color)
    px, py, _, _ = _by_color(plain, color)
    assert torch.equal(px[0], got[0]) and torch.equal(py[0], got[1])


# ---------------------------------------------------------------------------
# the plain phases against the JAX kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("measuring", [False, True])
@pytest.mark.parametrize("color", [0, 1])
@pytest.mark.parametrize("nx", WIDTHS)
def test_metropolis_phase_matches_jax_kernel(nx, color, measuring):
    """Injected uniforms: the plain phase against JAX
    ``_metropolis_phase(interpret=True)`` on the same state, zero-padded
    to W = 128 lanes at nx = 84; the sums against its float32 sums."""
    g = np.random.default_rng(100 + nx + 2 * color + measuring)
    st = _random_state(g, nx)
    model = XY2D(nx=nx, ny=NY, kbt=KBT)
    u = tuple(torch.from_numpy(g.random((NREP, NY, nx // 2),
                                        dtype=np.float32)) for _ in range(2))
    want, jobs = _jax_phase(st, color, model.beta, u, measuring)
    got = xp.metropolis_phase(*_by_color(_clone(st), color), u, color=color,
                              beta=model.beta, measuring=measuring)
    _assert_metropolis_close(got[:2], want, st, color, u, model.beta)
    if measuring:
        _assert_sums_close(got[2].numpy(), jobs)


@pytest.mark.parametrize("measuring", [False, True])
@pytest.mark.parametrize("color", [0, 1])
def test_over_relax_phase_matches_jax_kernel(color, measuring):
    """The plain OR phase against JAX ``_over_relax_phase(interpret=True)``
    at the lane-unaligned width; |S| = 1 after it and the colour's share
    of the energy conserved."""
    g = np.random.default_rng(200 + 2 * color + measuring)
    st = _random_state(g, 84)
    want, jobs = _jax_phase(st, color, measuring=measuring)
    model = XY2D(nx=84, ny=NY, kbt=KBT)
    e0 = model.energy_sum(st)
    out = _clone(st)
    got = xp.over_relax_phase(*_by_color(out, color), color=color,
                              measuring=measuring)
    for a, b in zip(got[:2], want):
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=OR_ATOL)
    np.testing.assert_allclose(torch.hypot(got[0], got[1]).numpy(), 1.0,
                               atol=1e-6)
    np.testing.assert_allclose(model.energy_sum(out).numpy(), e0.numpy(),
                               rtol=0, atol=1e-4)
    if measuring:
        _assert_sums_close(got[2].numpy(), jobs)
        # the fused e sums each site's float32 S·h: float32 rounding
        np.testing.assert_allclose(got[2][:, 2].numpy(),
                                   model.energy_sum(out).numpy(), rtol=1e-6)


def test_philox_uniforms_are_the_drawn_words():
    """A Philox-keyed phase equals the injected phase fed
    draw_uniforms(key), which are words 0 and 1 of counter (replica, row,
    column, 0), top 24 bits."""
    g = np.random.default_rng(7)
    st = _random_state(g, 84)
    seeds = rng.seeds_from_key(rng.sample_key(rng.base_key(2), 0), 1)
    u = xp.draw_uniforms(seeds, NREP, NY, 42)
    words = rng.philox4x32(torch.tensor([1, 3, 5, 0]), seeds)
    assert float(u[0][1, 3, 5]) == float(rng.bits_to_uniform(words[0]))
    assert float(u[1][1, 3, 5]) == float(rng.bits_to_uniform(words[1]))
    a, b = _clone(st), _clone(st)
    xp.metropolis_phase(*_by_color(a, 1), seeds, color=1, beta=1 / KBT)
    xp.metropolis_phase(*_by_color(b, 1), u, color=1, beta=1 / KBT)
    for p, q in zip(a, b):
        assert torch.equal(p, q)


# ---------------------------------------------------------------------------
# the runner
# ---------------------------------------------------------------------------

def _record(monkeypatch):
    """Record the phases the sweeps launch: (kind, colour, measuring)."""
    calls = []
    metro, over = xp.metropolis_phase, xp.over_relax_phase

    def m(*a, color, measuring=False, **kw):
        calls.append(("M", color, measuring))
        return metro(*a, color=color, measuring=measuring, **kw)

    def o(*a, color, measuring=False, **kw):
        calls.append(("OR", color, measuring))
        return over(*a, color=color, measuring=measuring, **kw)

    monkeypatch.setattr(xp, "metropolis_phase", m)
    monkeypatch.setattr(xp, "over_relax_phase", o)
    return calls


def _expected_order(mcs, n_or, mcs_or):
    order = []
    for t in range(1, mcs + 1):
        if n_or > 0 and t <= (mcs_or or mcs):
            order += [("M", 0, False), ("M", 1, False)]
            for _ in range(n_or - 1):
                order += [("OR", 0, False), ("OR", 1, False)]
            order += [("OR", 0, False), ("OR", 1, True)]
        else:
            order += [("M", 0, False), ("M", 1, True)]
    return order


@pytest.mark.parametrize("n_or,mcs_or", [(0, 0), (1, 0), (2, 0), (2, 2),
                                         (1, 1)])
def test_runner_launch_order(n_or, mcs_or, monkeypatch):
    """The schedule of JAX make_xy_padded_runner: Metropolis, n - 1 plain
    OR sweeps, one measuring OR sweep while t <= mcs_over_relax, then
    measuring Metropolis sweeps."""
    calls = _record(monkeypatch)
    model = XY2D(nx=84, ny=NY, kbt=KBT)
    run = sweep.make_xy_runner(model, 3, NREP, "allup", n_over_relax=n_or,
                               mcs_over_relax=mcs_or, device="cpu")
    series = run(rng.sample_key(rng.base_key(1), 0))
    assert calls == _expected_order(3, n_or, mcs_or)
    assert {k: tuple(v.shape) for k, v in series.items()} == {
        k: (NREP, 3) for k in ("m", "my", "e")}
    assert run.engine == sweep.XY_ENGINE


@pytest.mark.parametrize("n_or", [0, 1])
def test_runner_is_chunk_invariant(n_or):
    """Bitwise the same series for chunks of 2 and of 64 sweeps (keys by
    the global sweep index), random start."""
    model = XY2D(nx=84, ny=NY, kbt=KBT)
    key = rng.sample_key(rng.base_key(4), 1)
    kw = dict(n_over_relax=n_or, mcs_over_relax=3, device="cpu")
    a = sweep.make_xy_runner(model, 5, NREP, "random", chunk=2, **kw)(key)
    b = sweep.make_xy_runner(model, 5, NREP, "random", **kw)(key)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_runner_replayed_through_the_jax_kernels():
    """The slice as a whole: the port's runner (random start, OR for
    t <= 1, then Metropolis) replayed phase by phase on the CPU; every
    phase is held against the JAX kernel started from the port's state
    with the port's uniforms, and the replay's series equal the
    runner's bitwise."""
    model = XY2D(nx=84, ny=NY, kbt=KBT)
    mcs, key = 2, rng.sample_key(rng.base_key(6), 0)
    run = sweep.make_xy_runner(model, mcs, NREP, "random", n_over_relax=1,
                               mcs_over_relax=1, device="cpu")
    series = run(key)
    st = sweep._init_state(model, "random", NREP, key, "cpu")
    seeds = multispin_rng.sweep_phase_keys(key, mcs)
    flips = 0
    for t in range(mcs):
        for color in (0, 1):
            u = xp.draw_uniforms(seeds[t, color], NREP, NY, 42)
            measuring = color == 1 and t == 1
            want, jobs = _jax_phase(st, color, model.beta, u, measuring)
            before = _clone(st)
            got = xp.metropolis_phase(*_by_color(st, color), seeds[t, color],
                                      color=color, beta=model.beta,
                                      measuring=measuring)
            flips += _assert_metropolis_close(got[:2], want, before, color,
                                              u, model.beta)
            if measuring:
                _assert_sums_close(got[2].numpy(), jobs)
                obs = got[2]
        if t == 0:
            for color in (0, 1):
                want, jobs = _jax_phase(st, color, measuring=color == 1)
                got = xp.over_relax_phase(*_by_color(st, color), color=color,
                                          measuring=color == 1)
                for a, b in zip(got[:2], want):
                    np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                               atol=OR_ATOL)
            _assert_sums_close(got[2].numpy(), jobs)
            obs = got[2]
        for j, k in enumerate(("m", "my", "e")):
            assert torch.equal(series[k][:, t], obs[:, j] / model.nsites)
    assert flips <= MAX_FLIP_SHARE * 4 * NREP * NY * 42


def test_xy_cli_on_cuda_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present; chip_smoke.py drives --device cuda")
    out = tmp_path / "x.dat"
    with pytest.raises(RuntimeError, match="cuda"):
        main(["--model", "xy2d", "--nx", "32", "--ny", "32",
              "--n-over-relax", "1", "--output", str(out)])
    assert not out.exists()


def test_over_relaxation_on_other_models_raises_value_error(tmp_path):
    """Over-relaxation is defined for the XY model only (the JAX package
    has over_relax_sweep only on its XY models, and its generic runner
    fails on the others), so Ising raises ValueError; helical XY outside
    the dense gate (odd ny) runs it on the masked helical kernels."""
    out = tmp_path / "x.dat"
    with pytest.raises(ValueError, match="XY model only"):
        main(["--model", "ising2d", "--nx", "256", "--ny", "256",
              "--n-over-relax", "1", "--device", "cpu", "--output",
              str(out)])
    assert not out.exists()
    assert main(["--model", "xy2d", "--nx", "33", "--ny", "31", "--mcs", "3",
                 "--samples", "1", "--n-over-relax", "1", "--device", "cpu",
                 "--output", str(out)]) == 0
    assert "# engine: helical_pallas XY (masked streaming)" in \
        out.read_text().splitlines()


# ---------------------------------------------------------------------------
# interop and the CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nx", WIDTHS)
def test_interop_round_trip(nx):
    g = np.random.default_rng(nx + 5)
    st = _random_state(g, nx)
    w = _lanes(nx // 2)
    planes = interop.xy_to_numpy(st, width=w)
    assert all(p.shape == (NREP, NY, w) and p.dtype == np.float32
               for p in planes)
    for p in planes:
        np.testing.assert_array_equal(p[..., nx // 2:], 0.0)
    back = interop.xy_from_numpy(*planes, half=nx // 2)
    for p, q in zip(back, st):
        assert torch.equal(p, q)
    assert all(torch.equal(p, q) for p, q in zip(
        interop.xy_from_numpy(*interop.xy_to_numpy(st)), st))


def _split(path):
    lines = path.read_text().splitlines()
    head = [s for s in lines if s.startswith("#")]
    rows = np.array([s.split() for s in lines if not s.startswith("#")],
                    dtype=np.float64)
    return head, rows


def test_cli_matches_jax(tmp_path):
    """--model xy2d with over-relaxation for t <= 10 of 20: the same
    headers as the JAX CLI (mcs_over_relax, n_over_relax included) but for
    the engine stamp; m(t), e(t) within 5 combined standard errors."""
    flags = ["--model", "xy2d", "--nx", "32", "--ny", "32", "--kbt",
             str(KBT), "--mcs", "20", "--samples", "16", "--replicas", "8",
             "--n-over-relax", "1", "--mcs-over-relax", "10"]
    port, jax_dat = tmp_path / "port.dat", tmp_path / "jax.dat"
    assert main(flags + ["--device", "cpu", "--output", str(port)]) == 0
    assert jax_main(flags + ["--output", str(jax_dat)]) == 0
    head, rows = _split(port)
    jhead, jrows = _split(jax_dat)
    assert [h for h in head if not h.startswith("# engine:")] == [
        h for h in jhead if not h.startswith("# engine:")]
    assert "# mcs_over_relax: 10" in head and "# n_over_relax: 1" in head
    assert f"# engine: {sweep.XY_ENGINE}" in head
    assert rows.shape == jrows.shape == (20, 10)
    np.testing.assert_array_equal(rows[:, :3], jrows[:, :3])
    n, ns = rows[0, 0], rows[0, 1]
    for col, var_col in ((3, 7), (4, 8)):
        se = np.sqrt((rows[:, var_col] + jrows[:, var_col]) / (n * ns))
        z = np.abs(rows[:, col] - jrows[:, col]) / se
        assert np.all(z < 5.0), (col, z)
