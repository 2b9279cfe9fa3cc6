"""Port vs JAX on the same numpy inputs: helical XY (odd nx), the flat
model, the dense ragged layout, the component engine, the runner and the
CLI.

Shapes: nx = 65 (nc = 33 in a 128-lane JAX plane: pad columns) and
nx = 255 (nc = 128 = W: no pad), ny 16-64, R <= 2.  The JAX kernels run
in interpret mode on the CPU, as tests/test_xy2d_helical_dense.py runs
them.

Tolerances, and why (the rules of tests/test_torch_xy2d.py's docstring):
XLA contracts or reorders mul-add chains that torch runs one rounding at a
time, and ``jnp.exp`` / ``lax.rsqrt`` differ from ``torch.exp`` /
``torch.rsqrt`` by 1-2 ulp.  So:

- the state after a Metropolis phase: |Δ| <= 4e-7 a component, except a
  site whose accept decision differs; such a site has |u_acc - p| < 1e-6
  (p in float64) and at most 1 site in 1e4 may differ;
- the state after an over-relaxation phase: |Δ| <= 1e-6;
- the fused sums: relative 1e-5 (the JAX kernels sum in float32, the port
  in float64);
- the flat model against the JAX model: the same Metropolis rule (its
  candidate is cos/sin of 2πu, whose float32 values torch and XLA round
  alike to 1 ulp, inside the 4e-7); its OR sweep, two phases of which the
  second reads the first's output, to 1e-5 (``MODEL_OR_ATOL``: phase 0's
  rsqrt differences enter phase 1's field; measured up to 4.9e-6 on ~1%
  of sites over six seeds);
- the CLI: m and e within 5 combined standard errors at every t (the
  packages draw different random streams).
Port against port (the dense phase against the flat masked oracle in the
dense order, chunking, Philox against injected uniforms) is bitwise; so
are the layout against JAX's ``dense_pack`` and the plain phases against
JAX's whole-plane references where neither exp nor rsqrt enters."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_fortran_mc_simulation_spin_tpu.models.xy2d_helical import (
    XY2DHelical as JaxHelical,
)
from cuda_fortran_mc_simulation_spin_tpu.ops import xy2d_helical_dense as jhd
from cuda_fortran_mc_simulation_spin_tpu.runs.__main__ import main as jax_main
from cuda_fortran_mc_simulation_spin_tpu_torch import interop
from cuda_fortran_mc_simulation_spin_tpu_torch.core import lattice, rng
from cuda_fortran_mc_simulation_spin_tpu_torch.engine import sweep
from cuda_fortran_mc_simulation_spin_tpu_torch.models import (
    XY2DHelical,
    build_model,
)
from cuda_fortran_mc_simulation_spin_tpu_torch.config import RunConfig
from cuda_fortran_mc_simulation_spin_tpu_torch.models.xy2d_helical import (
    XYFlatState,
)
from cuda_fortran_mc_simulation_spin_tpu_torch.ops import trig
from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
    xy2d_helical_dense as hd,
)
from cuda_fortran_mc_simulation_spin_tpu_torch.ops import xy2d_pallas as xp
from cuda_fortran_mc_simulation_spin_tpu_torch.runs.__main__ import main

KBT = 0.89
NREP = 2
SHAPES = [(65, 16), (255, 16)]     # (nx, ny): nc 33 in W 128; nc = W = 128
STATE_ATOL = 4e-7
OR_ATOL = 1e-6
MODEL_OR_ATOL = 1e-5
SUM_RTOL = 1e-5
BORDER = 1e-6
MAX_FLIP_SHARE = 1e-4


def _flat(g, nx, ny, nrep=NREP) -> XYFlatState:
    th = g.uniform(0.0, 2 * np.pi, size=(nrep, nx * ny))
    return XYFlatState(torch.from_numpy(np.cos(th).astype(np.float32)),
                       torch.from_numpy(np.sin(th).astype(np.float32)))


def _planes(g, nx, ny, nrep=NREP):
    return list(hd.pack_state(_flat(g, nx, ny, nrep), ny, nx))


def _by_color(planes, color):
    """(sx, sy, ox, oy) of the colour updated."""
    ax, ay, bx, by = planes
    return [ax, ay, bx, by] if color == 0 else [bx, by, ax, ay]


def _uniforms(g, shape):
    return tuple(torch.from_numpy(g.random(shape, dtype=np.float32))
                 for _ in range(2))


def _wide(planes, nx):
    """Port planes as the JAX engine's (R, ny, W) jnp planes."""
    return tuple(jnp.asarray(p) for p in interop.xy_helical_to_numpy(
        planes, jhd.dense_width(nx)))


def _jax_phase(planes, color, nx, u=None, measuring=False):
    """The JAX kernel in interpret mode on the port's planes (and
    uniforms).  Returns (the updated colour's (sx, sy) cut to nc, obs
    (R, 3) or None)."""
    nrep, ny, nc = planes[0].shape
    kw = dict(color=color, nrep=nrep, ny=ny, nc=nc, measuring=measuring,
              interpret=True)
    if u is None:
        res = jhd._dense_or_phase(_wide(planes, nx), **kw)
    else:
        uc, ua = _wide(u, nx)
        res = jhd._dense_phase(_wide(planes, nx), jnp.zeros(2, jnp.int32),
                               uc, ua, beta=1.0 / KBT, **kw)
    out = res[0] if measuring else res
    sx, sy = _by_color(out, color)[:2]
    obs = np.asarray(res[1])[:, 0, :3] if measuring else None
    return (np.asarray(sx)[..., :nc], np.asarray(sy)[..., :nc]), obs


def _accept_prob(before, color, u_cand):
    """float64 acceptance probability of every slot."""
    sx, sy, ox, oy = (p.double() for p in _by_color(before, color))
    hx, hy = hd.field(ox, color), hd.field(oy, color)
    cx, cy = (c.double() for c in trig.cos_sin_2pi(u_cand))
    de = -((cx - sx) * hx + (cy - sy) * hy)
    return torch.exp(-de.clamp(min=0.0) / KBT).numpy()


def _assert_metropolis_close(got, want, before, color, u):
    gx, gy = (np.asarray(a) for a in got)
    wx, wy = (np.asarray(a) for a in want)
    d = np.maximum(np.abs(gx - wx), np.abs(gy - wy))
    off = d > STATE_ATOL
    if off.any():
        p = _accept_prob(before, color, u[0])
        gap = np.abs(u[1].numpy().astype(np.float64) - p)[off]
        assert np.all(gap < BORDER), gap.max()
        assert off.sum() <= MAX_FLIP_SHARE * off.size, off.sum()
    return int(off.sum())


def _assert_sums_close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=SUM_RTOL * max(1.0, np.abs(want).max()))


def _clone(planes):
    return [p.clone() for p in planes]


# ---------------------------------------------------------------------------
# layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nx,ny", SHAPES + [(65, 64)])
def test_dense_pack_matches_jax(nx, ny):
    """dense_pack equals the first nc columns of JAX's, its pad columns
    are copies of column nc - 1 (interop rebuilds the JAX plane bit for
    bit), the validity masks agree and unpack inverts pack."""
    g = np.random.default_rng(nx + ny)
    flat = g.standard_normal((NREP, nx * ny)).astype(np.float32)
    nc = hd.dense_nc(nx)
    ja, jb = jhd.dense_pack(jnp.asarray(flat), ny, nx)
    a, b = hd.dense_pack(torch.from_numpy(flat), ny, nx)
    assert a.shape == (NREP, ny, nc)
    for port, want in ((a, ja), (b, jb)):
        np.testing.assert_array_equal(port.numpy(), np.asarray(want)[..., :nc])
    wide = interop.xy_helical_to_numpy((a, b), jhd.dense_width(nx))
    for port, want in zip(wide, (ja, jb)):
        np.testing.assert_array_equal(port, np.asarray(want))
    for color in (0, 1):
        valid = hd.valid_col(color, ny, nc).numpy()
        np.testing.assert_array_equal(
            valid, np.asarray(jhd.valid_mask(ny, nx, color))[:, :nc])
        np.testing.assert_array_equal(valid,
                                      hd.site_x(ny, nx, color)[1].numpy())
    back = hd.dense_unpack(a, b, ny, nx)
    np.testing.assert_array_equal(back.numpy(), flat)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jhd.dense_unpack(ja, jb, ny, nx)))
    # each valid site once
    assert int(hd.valid_col(0, ny, nc).sum()
               + hd.valid_col(1, ny, nc).sum()) == nx * ny


def test_gate():
    assert hd.fits(XY2DHelical(nx=10001, ny=10000, kbt=KBT))
    assert hd.fits(XY2DHelical(nx=65, ny=18, kbt=KBT))
    assert not hd.fits(XY2DHelical(nx=65, ny=17, kbt=KBT))
    with pytest.raises(ValueError, match="odd nx"):
        XY2DHelical(nx=64, ny=64, kbt=KBT)
    cfg = RunConfig(model="xy2d", nx=65, ny=64)
    assert isinstance(build_model(cfg), XY2DHelical)


# ---------------------------------------------------------------------------
# the flat model
# ---------------------------------------------------------------------------

def test_model_init_and_observables_match_jax():
    model = XY2DHelical(nx=65, ny=16, kbt=KBT)
    jmodel = JaxHelical(nx=65, ny=16, kbt=KBT)
    up = model.init_state("allup", batch=(NREP,))
    for p, q in zip(up, jmodel.init_state("allup")):
        assert p.shape == (NREP, 65 * 16) and p.dtype == torch.float32
        np.testing.assert_array_equal(p[0].numpy(), np.asarray(q))
    key = rng.sample_key(rng.base_key(3), 0)
    st = model.init_state("random", key)
    assert all(torch.equal(p, q) for p, q in zip(
        st, model.init_state("random", key)))
    np.testing.assert_allclose(torch.hypot(*st).numpy(), 1.0, atol=2e-7)
    obs = model.observables(st)
    jobs = jmodel.observables(tuple(jnp.asarray(p.numpy()) for p in st))
    for k in ("m", "my", "e"):
        _assert_sums_close(float(obs[k]), float(jobs[k]))
    # the dense engine's plain observables on the packed state
    dobs = hd.observables(model, [p[None] for p in hd.pack_state(st, 16, 65)])
    # Σ S: the same float32 values; e: float32 site terms against float64
    for k, tol in (("m", 1e-12), ("my", 1e-12), ("e", 1e-6)):
        np.testing.assert_allclose(float(dobs[k][0]), float(obs[k]),
                                   rtol=tol, atol=1e-15)
    with pytest.raises(ValueError):
        model.init_state("finite_magne", key)


def test_model_sweeps_are_their_phases():
    """sweep: phase 0 then phase 1 with one pair of uniform planes drawn
    under phase keys 0 and 1 of the sweep key; sweep_batched: replica r
    swept under fold_in(key, r); over_relax_sweep_batched: each replica's
    own sweep."""
    model = XY2DHelical(nx=65, ny=16, kbt=KBT)
    g = np.random.default_rng(41)
    flat = _flat(g, 65, 16)
    key = rng.sample_key(rng.base_key(5), 2)
    got = model.sweep(XYFlatState(flat.sx[0], flat.sy[0]), key)
    u = tuple(rng.uniform(rng.phase_key(key, p), (model.nsites,))
              for p in (0, 1))
    sx, sy = model._phase(flat.sx[0], flat.sy[0], 0, *u)
    want = model._phase(sx, sy, 1, *u)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert not torch.equal(got.sx, flat.sx[0])
    batched = model.sweep_batched(flat, key)
    keys = rng.fold_in(key, torch.arange(NREP, dtype=torch.int64))
    over = model.over_relax_sweep_batched(flat)
    for r in range(NREP):
        one = XYFlatState(flat.sx[r], flat.sy[r])
        for a, b in zip(batched, model.sweep(one, keys[r])):
            assert torch.equal(a[r], b)
        for a, b in zip(over, model.over_relax_sweep(one)):
            assert torch.equal(a[r], b)


@pytest.mark.parametrize("offset", [0, 1])
def test_model_phases_match_jax(offset):
    """The masked flat phase against JAX XY2DHelical._phase (state
    tolerance) and the OR sweep against JAX's (OR_ATOL)."""
    g = np.random.default_rng(40 + offset)
    model = XY2DHelical(nx=65, ny=16, kbt=KBT)
    jmodel = JaxHelical(nx=65, ny=16, kbt=KBT)
    sx, sy = _flat(g, 65, 16, 1)
    u = _uniforms(g, (model.nsites,))
    got = model._phase(sx[0], sy[0], offset, *u)
    want = jmodel._phase(jnp.asarray(sx[0].numpy()),
                         jnp.asarray(sy[0].numpy()), offset,
                         *(jnp.asarray(v.numpy()) for v in u))
    d = np.maximum(*(np.abs(a.numpy() - np.asarray(b))
                     for a, b in zip(got, want)))
    off = d > STATE_ATOL
    if off.any():
        # a differing site is a borderline decision (float64 p)
        x, y = sx[0].double(), sy[0].double()
        hx = lattice.helical_neighbor_sums(x, 65)
        hy = lattice.helical_neighbor_sums(y, 65)
        ang = 2 * np.pi * u[0].double()
        de = -((torch.cos(ang) - x) * hx + (torch.sin(ang) - y) * hy)
        p = torch.exp(-de.clamp(min=0.0) / KBT).numpy()
        assert np.all(np.abs(u[1].numpy() - p)[off] < BORDER)
        assert off.sum() <= max(1, MAX_FLIP_SHARE * off.size)
    got = model.over_relax_sweep(XYFlatState(sx[0], sy[0]))
    want = jmodel.over_relax_sweep((jnp.asarray(sx[0].numpy()),
                                    jnp.asarray(sy[0].numpy())))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=MODEL_OR_ATOL)


def _flat_oracle(sx, sy, offset, u_cand, u_acc, nx):
    """The masked flat phase in the dense engine's field order and trig:
    ((up + dn) + left) + right, cos_sin_2pi (a bitwise target)."""
    def h(v):
        return ((torch.roll(v, nx, -1) + torch.roll(v, -nx, -1))
                + torch.roll(v, 1, -1)) + torch.roll(v, -1, -1)
    hx, hy = h(sx), h(sy)
    cx, cy = trig.cos_sin_2pi(u_cand)
    de = -((cx - sx) * hx + (cy - sy) * hy)
    p = torch.exp(torch.maximum(de, trig.f32(0.0)) * trig.f32(-1.0 / KBT))
    mask = lattice.helical_parity_mask(sx.shape[-1], offset)
    accept = mask & (u_acc < p)
    return torch.where(accept, cx, sx), torch.where(accept, cy, sy)


@pytest.mark.parametrize("color", [0, 1])
@pytest.mark.parametrize("nx,ny", SHAPES)
def test_dense_phase_equals_the_flat_oracle(nx, ny, color):
    """The dense plain phase equals the flat masked phase bitwise, given
    the same per-site uniforms (the seam, the ragged slot and the row wrap
    included)."""
    g = np.random.default_rng(50 + nx + color)
    flat = _flat(g, nx, ny)
    u = _uniforms(g, (NREP, nx * ny))
    want = _flat_oracle(*flat, color, *u, nx)
    planes = list(hd.pack_state(flat, ny, nx))
    uc = hd.dense_pack(u[0], ny, nx)[color]
    ua = hd.dense_pack(u[1], ny, nx)[color]
    hd.phase(*_by_color(planes, color), (uc, ua), color=color,
             beta=1.0 / KBT)
    got = hd.unpack_state(planes, ny, nx)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the plain phases against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("measuring", [False, True])
@pytest.mark.parametrize("color", [0, 1])
@pytest.mark.parametrize("nx,ny", SHAPES)
def test_phase_matches_jax_kernel(nx, ny, color, measuring):
    """Injected uniforms: the plain Metropolis phase against JAX
    ``_dense_phase(interpret=True)``; the sums against its float32
    sums."""
    g = np.random.default_rng(100 + nx + 2 * color + measuring)
    planes = _planes(g, nx, ny)
    u = _uniforms(g, tuple(planes[0].shape))
    want, jobs = _jax_phase(planes, color, nx, u, measuring)
    q = _clone(planes)
    got = hd.phase(*_by_color(q, color), u, color=color, beta=1.0 / KBT,
                   measuring=measuring)
    _assert_metropolis_close(got[:2], want, planes, color, u)
    if measuring:
        _assert_sums_close(got[2].numpy(), jobs)


@pytest.mark.parametrize("measuring", [False, True])
@pytest.mark.parametrize("color", [0, 1])
@pytest.mark.parametrize("nx,ny", SHAPES)
def test_or_phase_matches_jax_kernel(nx, ny, color, measuring):
    """The plain OR phase against JAX ``_dense_or_phase(interpret=True)``;
    |S| = 1 after it."""
    g = np.random.default_rng(200 + nx + 2 * color + measuring)
    planes = _planes(g, nx, ny)
    want, jobs = _jax_phase(planes, color, nx, measuring=measuring)
    got = hd.or_phase(*_by_color(_clone(planes), color), color=color,
                      measuring=measuring)
    for a, b in zip(got[:2], want):
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=OR_ATOL)
    np.testing.assert_allclose(torch.hypot(got[0], got[1]).numpy(), 1.0,
                               atol=1e-6)
    if measuring:
        _assert_sums_close(got[2].numpy(), jobs)


@pytest.mark.parametrize("color", [0, 1])
@pytest.mark.parametrize("nx,ny", SHAPES)
def test_phases_match_jax_references(nx, ny, color):
    """The plain phases against JAX's whole-plane ``dense_phase_reference``
    and ``dense_or_reference`` (per replica), the other colour untouched
    in both."""
    g = np.random.default_rng(300 + nx + color)
    planes = _planes(g, nx, ny)
    u = _uniforms(g, tuple(planes[0].shape))
    nc = hd.dense_nc(nx)
    q = _clone(planes)
    hd.phase(*_by_color(q, color), u, color=color, beta=1.0 / KBT)
    r = _clone(planes)
    hd.or_phase(*_by_color(r, color), color=color)
    for k in range(NREP):
        one = [jnp.asarray(p[k].numpy()) for p in planes]
        want = jhd.dense_phase_reference(
            *one, color, jnp.asarray(u[0][k].numpy()),
            jnp.asarray(u[1][k].numpy()), 1.0 / KBT, nc)
        _assert_metropolis_close(
            [p[k:k + 1] for p in _by_color(q, color)[:2]],
            [np.asarray(p)[None] for p in _by_color(want, color)[:2]],
            [p[k:k + 1] for p in planes], color,
            tuple(v[k:k + 1] for v in u))
        for a, b in zip(_by_color(q, color)[2:], _by_color(want, color)[2:]):
            np.testing.assert_array_equal(a[k].numpy(), np.asarray(b))
        want = jhd.dense_or_reference(*one, color, nc)
        for a, b in zip(r, want):
            np.testing.assert_allclose(a[k].numpy(), np.asarray(b), rtol=0,
                                       atol=OR_ATOL)


def test_philox_uniforms_are_the_drawn_words():
    """A Philox-keyed phase equals the injected phase fed
    draw_uniforms(key) at (R, ny, nc): words 0 and 1 of counter (replica,
    row, column, 0), top 24 bits."""
    g = np.random.default_rng(7)
    planes = _planes(g, 65, 16)
    seeds = rng.seeds_from_key(rng.sample_key(rng.base_key(2), 0), 1)
    u = xp.draw_uniforms(seeds, NREP, 16, 33)
    a, b = _clone(planes), _clone(planes)
    hd.phase(*_by_color(a, 1), seeds, color=1, beta=1.0 / KBT)
    hd.phase(*_by_color(b, 1), u, color=1, beta=1.0 / KBT)
    for p, q in zip(a, b):
        assert torch.equal(p, q)


def test_or_sweep_conserves_energy():
    """One OR sweep keeps the flat model's energy (float64 of the float32
    state) to float32 rounding and |S| = 1; the fused e equals the
    state's."""
    model = XY2DHelical(nx=65, ny=64, kbt=KBT)
    g = np.random.default_rng(8)
    flat = _flat(g, 65, 64)
    planes = list(hd.pack_state(flat, 64, 65))
    e0 = model.energy_sum(flat)
    planes, obs = hd.over_relax_sweep_measure(model, planes)
    st = hd.unpack_state(planes, 64, 65)
    e1 = model.energy_sum(st)
    np.testing.assert_allclose(e1.numpy(), e0.numpy(), rtol=0,
                               atol=model.nsites * 8 * 2.0 ** -24)
    np.testing.assert_allclose(torch.hypot(*st).numpy(), 1.0, atol=1e-6)
    np.testing.assert_allclose((obs["e"] * model.nsites).numpy(),
                               e1.numpy(), rtol=1e-6)
    np.testing.assert_allclose((obs["m"] * model.nsites).numpy(),
                               model.magne_sums(st)[0].numpy(), rtol=0,
                               atol=1e-9)


# ---------------------------------------------------------------------------
# the runner
# ---------------------------------------------------------------------------

def _record(monkeypatch, mod):
    calls = []
    names = (("sweep", "M"), ("sweep_measure", "Mm"),
             ("over_relax_sweep", "OR"), ("over_relax_sweep_measure", "ORm"),
             ("observables", "obs"))
    for name, tag in names:
        fn = getattr(mod, name)

        def rec(*a, _fn=fn, _tag=tag):
            calls.append(_tag)
            return _fn(*a)
        monkeypatch.setattr(mod, name, rec)
    return calls


def _expected_order(mcs, n_or, mcs_or):
    order = []
    for t in range(1, mcs + 1):
        if n_or == 0:
            order.append("Mm")
        elif t <= (mcs_or or mcs):
            order += ["M"] + ["OR"] * (n_or - 1) + ["ORm"]
        else:
            order += ["M", "obs"]
    return order


@pytest.mark.parametrize("n_or,mcs_or", [(0, 0), (1, 0), (2, 2), (1, 1)])
def test_runner_schedule(n_or, mcs_or, monkeypatch):
    """The schedule of the XY branch of JAX make_helical_runner, on the
    component engine (SPINLAT_XY_DENSE_ANGLE=0), and its engine tag."""
    monkeypatch.setenv("SPINLAT_XY_DENSE_ANGLE", "0")
    calls = _record(monkeypatch, hd)
    model = XY2DHelical(nx=65, ny=16, kbt=KBT)
    run = sweep.make_helical_runner(model, 3, NREP, "allup", device="cpu",
                                    n_over_relax=n_or, mcs_over_relax=mcs_or)
    series = run(rng.sample_key(rng.base_key(1), 0))
    assert calls == _expected_order(3, n_or, mcs_or)
    assert {k: tuple(v.shape) for k, v in series.items()} == {
        k: (NREP, 3) for k in ("m", "my", "e")}
    assert run.engine == sweep.XY_HELICAL_COMPONENT


@pytest.mark.parametrize("engine", ["0", "1"])
@pytest.mark.parametrize("n_or", [0, 1])
def test_runner_is_chunk_invariant(n_or, engine, monkeypatch):
    """Bitwise the same series for chunks of 2 and of 64 sweeps (keys by
    the global sweep index), random start, both engines."""
    monkeypatch.setenv("SPINLAT_XY_DENSE_ANGLE", engine)
    model = XY2DHelical(nx=65, ny=16, kbt=KBT)
    key = rng.sample_key(rng.base_key(4), 1)
    kw = dict(n_over_relax=n_or, mcs_over_relax=3, device="cpu")
    a = sweep.make_xy_helical_runner(model, 5, NREP, "random", chunk=2,
                                     **kw)(key)
    b = sweep.make_xy_helical_runner(model, 5, NREP, "random", **kw)(key)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_runner_replayed_through_the_jax_kernels(monkeypatch):
    """The component engine as a whole: the runner (random start, OR for
    t <= 1, then Metropolis with the plain observables) replayed phase by
    phase; every phase held against the JAX kernel in interpret mode
    started from the port's state with the port's uniforms, and the
    replay's series equal the runner's bitwise."""
    monkeypatch.setenv("SPINLAT_XY_DENSE_ANGLE", "0")
    model = XY2DHelical(nx=65, ny=16, kbt=KBT)
    mcs, key = 2, rng.sample_key(rng.base_key(6), 0)
    series = sweep.make_helical_runner(
        model, mcs, NREP, "random", device="cpu", n_over_relax=1,
        mcs_over_relax=1)(key)
    flat = sweep._init_state(model, "random", NREP, key, "cpu")
    planes = list(hd.pack_state(flat, 16, 65))
    seeds = sweep.multispin_rng.sweep_phase_keys(key, mcs)
    flips = 0
    for t in range(mcs):
        for color in (0, 1):
            u = xp.draw_uniforms(seeds[t, color], NREP, 16, 33)
            want, _ = _jax_phase(planes, color, 65, u)
            before = _clone(planes)
            got = hd.phase(*_by_color(planes, color), seeds[t, color],
                           color=color, beta=model.beta)
            flips += _assert_metropolis_close(got[:2], want, before, color,
                                              u)
        if t == 0:
            for color in (0, 1):
                want, jobs = _jax_phase(planes, color, 65,
                                        measuring=color == 1)
                got = hd.or_phase(*_by_color(planes, color), color=color,
                                  measuring=color == 1)
                for a, b in zip(got[:2], want):
                    np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                               atol=OR_ATOL)
            _assert_sums_close(got[2].numpy(), jobs)
            obs = hd.densities(model, got[2])
        else:
            obs = hd.observables(model, planes)
        for k in ("m", "my", "e"):
            assert torch.equal(series[k][:, t], obs[k])
    assert flips <= MAX_FLIP_SHARE * 4 * NREP * 16 * 33


# ---------------------------------------------------------------------------
# interop, routes and the CLI
# ---------------------------------------------------------------------------

def test_interop_jax_planes_in_same_phase_out():
    """JAX's packed planes (W = 128) carried into the port give its phase:
    the port's OR phase on the converted planes equals JAX's reference on
    the JAX planes, cut to nc; the flat converter gives the same planes."""
    g = np.random.default_rng(9)
    flat = _flat(g, 65, 16)
    jplanes = jhd.pack_state(tuple(jnp.asarray(p.numpy()) for p in flat),
                             16, 65)
    planes = list(interop.xy_helical_from_numpy(
        [np.asarray(p) for p in jplanes], 33))
    for p, q in zip(planes, interop.xy_helical_from_flat(
            *(p.numpy() for p in flat), 16, 65)):
        assert torch.equal(p, q)
    hd.or_phase(*_by_color(planes, 1), color=1)
    want = jhd.dense_or_reference(*(p[0] for p in jplanes), 1, 33)
    for a, b in zip(planes, want):
        np.testing.assert_allclose(a[0].numpy(), np.asarray(b)[:, :33],
                                   rtol=0, atol=OR_ATOL)


def test_shapes_outside_the_gate_raise(tmp_path):
    """Odd ny (outside the dense gate), refused before the masked helical
    kernels were ported, runs on them; the disorder protocols refuse odd
    nx with the JAX package's ValueError."""
    out, served = tmp_path / "x.dat", tmp_path / "odd_ny.dat"
    assert main(["--model", "xy2d", "--nx", "65", "--ny", "63", "--mcs",
                 "2", "--samples", "1", "--device", "cpu", "--output",
                 str(served)]) == 0
    assert "# engine: helical_pallas XY (masked streaming)" in \
        served.read_text().splitlines()
    with pytest.raises(ValueError, match="periodic XY engine"):
        main(["--model", "xy2d", "--nx", "65", "--ny", "64", "--protocol",
              "finite_magne", "--device", "cpu", "--output", str(out)])
    assert not out.exists()


def _split(path):
    lines = path.read_text().splitlines()
    head = [s for s in lines if s.startswith("#")]
    rows = np.array([s.split() for s in lines if not s.startswith("#")],
                    dtype=np.float64)
    return head, rows


@pytest.mark.parametrize("extra", [[], ["--n-over-relax", "1",
                                        "--mcs-over-relax", "10"]])
def test_cli_matches_jax(extra, tmp_path, monkeypatch):
    """--model xy2d at odd nx on the component engine, Metropolis only and
    with over-relaxation for t <= 10 of 20: the same headers as the JAX
    CLI but for the engine stamp; m(t), e(t) within 5 combined standard
    errors at every t."""
    monkeypatch.setenv("SPINLAT_XY_DENSE_ANGLE", "0")
    flags = ["--model", "xy2d", "--nx", "65", "--ny", "32", "--kbt",
             str(KBT), "--mcs", "20", "--samples", "16", "--replicas",
             "8"] + extra
    port, jax_dat = tmp_path / "port.dat", tmp_path / "jax.dat"
    assert main(flags + ["--device", "cpu", "--output", str(port)]) == 0
    assert jax_main(flags + ["--output", str(jax_dat)]) == 0
    head, rows = _split(port)
    jhead, jrows = _split(jax_dat)
    assert [h for h in head if not h.startswith("# engine:")] == [
        h for h in jhead if not h.startswith("# engine:")]
    assert f"# engine: {sweep.XY_HELICAL_COMPONENT}" in head
    assert rows.shape == jrows.shape == (20, 10)
    np.testing.assert_array_equal(rows[:, :3], jrows[:, :3])
    n, ns = rows[0, 0], rows[0, 1]
    for col, var_col in ((3, 7), (4, 8)):
        se = np.sqrt((rows[:, var_col] + jrows[:, var_col]) / (n * ns))
        z = np.abs(rows[:, col] - jrows[:, col]) / se
        assert np.all(z < 5.0), (col, z)


def test_env_selects_the_engine(monkeypatch):
    monkeypatch.delenv("SPINLAT_XY_DENSE_ANGLE", raising=False)
    assert sweep.xy_helical_engine()[1] == sweep.XY_HELICAL_ANGLE
    monkeypatch.setenv("SPINLAT_XY_DENSE_ANGLE", "0")
    assert sweep.xy_helical_engine()[1] == sweep.XY_HELICAL_COMPONENT
    assert os.environ["SPINLAT_XY_DENSE_ANGLE"] == "0"


def _curve(name, max_t):
    rows = []
    path = (os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
            + "/data/production/" + name)
    with open(path) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            row = line.split()
            if float(row[2]) > max_t:
                break
            rows.append(row)
    return np.array(rows, dtype=np.float64)


def test_committed_helical_curves_agree_with_the_periodic_one():
    """The two committed curves the card's Metropolis class is held
    against, checked against each other first: the one-sample helical
    10001x10000 curve and the 32-sample periodic 2000x2000 one (kbt
    0.895 both) agree at every t <= 100 within 5 sigma, sigma^2 =
    N·Var_2000 (1/N_1 + 1/(32 N_2000)) (the one-sample file's variance
    columns are 0).  Measured: largest |z| 2.73 (m, t = 79), 2.37 (e).
    The OR curve's rows carry Nsample 500 at every t."""
    one = _curve("xy2d_10001x10000_mcs10000_s1.dat", 100)
    per = _curve("xy2d_samples32_2000x2000_mcs100.dat", 100)
    assert one.shape == per.shape == (100, 10)
    assert np.all(one[:, 7:] == 0.0) and np.all(one[:, 1] == 1)
    for col, var_col in ((3, 7), (4, 8)):
        sigma = np.sqrt(per[:, var_col] * (1.0 / one[0, 0]
                                           + 1.0 / (per[0, 0] * per[0, 1])))
        z = (one[:, col] - per[:, col]) / sigma
        assert np.all(np.abs(z) < 5.0), (col, np.abs(z).max())
    orc = _curve("xy2d_or_10001x10000_mcs10000_s500.dat", 10000)
    assert orc.shape == (10000, 10) and np.all(orc[:, 1] == 500)
