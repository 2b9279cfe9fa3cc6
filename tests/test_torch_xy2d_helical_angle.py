"""Port vs JAX on the same numpy inputs: the f32-angle engine of helical XY
(ops/xy2d_helical_dense_angle.py), the default helical XY engine.

Shapes as tests/test_torch_xy2d_helical.py: nx = 65 (nc = 33 in a
128-lane JAX plane) and nx = 255 (nc = W = 128), ny 16-32, R = 2.  Angles
are in turns.

Tolerances, and why (the rules of tests/test_torch_xy2d.py's docstring,
read in turns):

- a Metropolis phase writes either the candidate u - 0.5 or the old angle,
  exact in both packages: the states are equal but at sites whose accept
  decision differs (``jnp.exp`` and ``torch.exp`` differ by 1 ulp); such a
  site has |u_acc - p| < 1e-6 (p in float64) and at most 1 site in 1e4
  may differ;
- an over-relaxation phase against JAX's whole-plane reference: bitwise
  (atan2_2pi and cos_sin_2pi are the same float32 chain, no exp or
  rsqrt); against the JAX kernel in interpret mode, which contracts the
  decode and field chains: |Δθ|·|h| <= 1e-6 turns (``OR_FIELD_ATOL``: a
  field error δh moves φ = atan2(h) by |δh| / (2π|h|); measured
  |Δθ|·|h| <= 4.7e-7 over twelve cases, |Δθ| up to 1.6e-6 at |h| = 0.009);
- the fused sums: relative 1e-5 (float32 sums in JAX, float64 here);
- the angle engine against the component engine fed u - 0.5: bitwise in
  the decoded state (JAX's own test has it so); their OR reflections to
  5e-5 in components (JAX's bound: atan2 against two rsqrt roundings,
  amplified at small |h|);
- the CLI: m and e within 5 combined standard errors at every t."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_fortran_mc_simulation_spin_tpu.ops import trig as jtrig
from cuda_fortran_mc_simulation_spin_tpu.ops import xy2d_helical_dense as jhd
from cuda_fortran_mc_simulation_spin_tpu.ops import (
    xy2d_helical_dense_angle as jha,
)
from cuda_fortran_mc_simulation_spin_tpu.runs.__main__ import main as jax_main
from cuda_fortran_mc_simulation_spin_tpu_torch import interop
from cuda_fortran_mc_simulation_spin_tpu_torch.core import rng
from cuda_fortran_mc_simulation_spin_tpu_torch.engine import sweep
from cuda_fortran_mc_simulation_spin_tpu_torch.models import XY2DHelical
from cuda_fortran_mc_simulation_spin_tpu_torch.ops import multispin_rng, trig
from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
    xy2d_helical_dense as hd,
)
from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
    xy2d_helical_dense_angle as ha,
)
from cuda_fortran_mc_simulation_spin_tpu_torch.ops import xy2d_pallas as xp
from cuda_fortran_mc_simulation_spin_tpu_torch.runs.__main__ import main

KBT = 0.89
NREP = 2
SHAPES = [(65, 16), (255, 16)]
OR_FIELD_ATOL = 1e-6
COMPONENT_OR_ATOL = 5e-5
SUM_RTOL = 1e-5
BORDER = 1e-6
MAX_FLIP_SHARE = 1e-4


def _turns(g, nx, ny, nrep=NREP) -> np.ndarray:
    return g.uniform(-0.5, 0.5, size=(nrep, nx * ny)).astype(np.float32)


def _angles(g, nx, ny, nrep=NREP):
    return list(hd.dense_pack(torch.from_numpy(_turns(g, nx, ny, nrep)),
                              ny, nx))


def _uniforms(g, shape):
    return tuple(torch.from_numpy(g.random(shape, dtype=np.float32))
                 for _ in range(2))


def _so(planes, color):
    """(s, o): the colour updated and the other."""
    a, b = planes
    return (a, b) if color == 0 else (b, a)


def _wide(planes, nx):
    return tuple(jnp.asarray(p) for p in interop.xy_helical_to_numpy(
        planes, jhd.dense_width(nx)))


def _accept_prob(planes, color, u_cand):
    s, o = _so(planes, color)
    hx, hy = (h.double() for h in ha.angle_field(o, color))
    sx, sy = (v.double() for v in trig.cos_sin_2pi(s))
    cx, cy = (v.double() for v in trig.cos_sin_2pi(u_cand - 0.5))
    de = -((cx - sx) * hx + (cy - sy) * hy)
    return torch.exp(-de.clamp(min=0.0) / KBT).numpy()


def _assert_angles_close(got, want, before, color, u):
    """Equal but at borderline decisions (the module docstring)."""
    got, want = np.asarray(got), np.asarray(want)
    off = got != want
    if off.any():
        p = _accept_prob(before, color, u[0])
        gap = np.abs(u[1].numpy().astype(np.float64) - p)[off]
        assert np.all(gap < BORDER), gap.max()
        assert off.sum() <= max(1, MAX_FLIP_SHARE * off.size), off.sum()


def _assert_sums_close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=SUM_RTOL * max(1.0, np.abs(want).max()))


def _clone(planes):
    return [p.clone() for p in planes]


def test_atan2_2pi_matches_jax_on_every_octant():
    """atan2_2pi bitwise equal to the JAX module's at the octant borders,
    the axes (signed zeros included), (0, 0) and random points."""
    g = np.random.default_rng(1)
    ang = np.concatenate([np.arange(-8, 9) * np.pi / 8,
                          g.uniform(-np.pi, np.pi, 4000)])
    rad = np.concatenate([np.ones(17), g.uniform(1e-3, 4.0, 4000)])
    y = np.concatenate([rad * np.sin(ang), [0.0, -0.0, 0.0, 1.0, -1.0]])
    x = np.concatenate([rad * np.cos(ang), [0.0, 0.0, -1.0, 0.0, 0.0]])
    y, x = y.astype(np.float32), x.astype(np.float32)
    got = trig.atan2_2pi(torch.from_numpy(y), torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jtrig.atan2_2pi(
        jnp.asarray(y), jnp.asarray(x))))
    np.testing.assert_allclose(got, np.arctan2(y, x) / (2 * np.pi),
                               atol=1e-7)
    assert got[-5] == 0.0
    # the CPU wrapper is the plain version
    assert torch.equal(ha.atan2_2pi(torch.from_numpy(y),
                                    torch.from_numpy(x)),
                       torch.from_numpy(got))


def test_pack_state_matches_jax():
    """Flat components -> angle planes (atan2 in turns, to 1 ulp of 0.5)
    and back to components (cos_sin_2pi of the turns)."""
    g = np.random.default_rng(2)
    th = _turns(g, 65, 16)
    fx = np.cos(2 * np.pi * th).astype(np.float32)
    fy = np.sin(2 * np.pi * th).astype(np.float32)
    got = ha.pack_state((torch.from_numpy(fx), torch.from_numpy(fy)), 16, 65)
    want = jha.pack_state((jnp.asarray(fx), jnp.asarray(fy)), 16, 65)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b)[..., :33],
                                   rtol=0, atol=6e-8)
    back = ha.unpack_state(got, 16, 65)
    jback = jha.unpack_state(tuple(jnp.asarray(p.numpy()) for p in got),
                             16, 65)
    for a, b in zip(back, jback):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_allclose(back.sx.numpy(), fx, atol=2e-7)


@pytest.mark.parametrize("color", [0, 1])
@pytest.mark.parametrize("nx,ny", SHAPES)
def test_angle_phase_matches_jax_kernel(nx, ny, color):
    """Injected uniforms, measuring: the plain Metropolis phase against JAX
    ``_angle_phase(interpret=True)``, the sums against its float32 sums;
    the measuring phase's state equals the plain one's bitwise."""
    g = np.random.default_rng(100 + nx + color)
    planes = _angles(g, nx, ny)
    u = _uniforms(g, tuple(planes[0].shape))
    nc = planes[0].shape[-1]
    uc, ua = _wide(u, nx)
    res = jha._angle_phase(_wide(planes, nx), jnp.zeros(2, jnp.int32), uc,
                           ua, color=color, beta=1.0 / KBT, nrep=NREP, ny=ny,
                           nc=nc, measuring=True, interpret=True)
    q = _clone(planes)
    s, obs = ha.angle_phase(*_so(q, color), u, color=color, beta=1.0 / KBT,
                            measuring=True)
    _assert_angles_close(s.numpy(),
                         np.asarray(_so(res[0], color)[0])[..., :nc],
                         planes, color, u)
    _assert_sums_close(obs.numpy(), np.asarray(res[1])[:, 0, :3])
    r = _clone(planes)
    ha.angle_phase(*_so(r, color), u, color=color, beta=1.0 / KBT)
    assert all(torch.equal(a, b) for a, b in zip(q, r))


@pytest.mark.parametrize("color", [0, 1])
@pytest.mark.parametrize("nx,ny", SHAPES)
def test_angle_or_matches_jax_kernel(nx, ny, color):
    """Measuring: the plain OR phase against JAX
    ``_angle_or_phase(interpret=True)`` within OR_FIELD_ATOL / |h| turns,
    the sums within SUM_RTOL."""
    g = np.random.default_rng(200 + nx + color)
    planes = _angles(g, nx, ny)
    nc = planes[0].shape[-1]
    res = jha._angle_or_phase(_wide(planes, nx), color=color, nrep=NREP,
                              ny=ny, nc=nc, measuring=True, interpret=True)
    q = _clone(planes)
    s, o = _so(q, color)
    hx, hy = ha.angle_field(o, color)
    s, obs = ha.angle_or_phase(s, o, color=color, measuring=True)
    d = np.abs(s.numpy() - np.asarray(_so(res[0], color)[0])[..., :nc])
    d = np.minimum(d, 1.0 - d)    # -0.5 and 0.5 turns are one angle
    assert np.all(d * torch.hypot(hx, hy).numpy() <= OR_FIELD_ATOL), d.max()
    _assert_sums_close(obs.numpy(), np.asarray(res[1])[:, 0, :3])


@pytest.mark.parametrize("color", [0, 1])
@pytest.mark.parametrize("nx,ny", SHAPES)
def test_angle_phases_match_jax_references(nx, ny, color):
    """The plain phases against JAX's whole-plane
    ``angle_phase_reference`` (borderline decisions only) and
    ``angle_or_reference`` (bitwise), the other colour untouched."""
    g = np.random.default_rng(300 + nx + color)
    planes = _angles(g, nx, ny)
    u = _uniforms(g, tuple(planes[0].shape))
    nc = planes[0].shape[-1]
    one = [jnp.asarray(p.numpy()) for p in planes]
    want = jax.vmap(lambda a, b, uc, ua: jha.angle_phase_reference(
        a, b, color, uc, ua, 1.0 / KBT, nc))(
        *one, *(jnp.asarray(v.numpy()) for v in u))
    q = _clone(planes)
    ha.angle_phase(*_so(q, color), u, color=color, beta=1.0 / KBT)
    _assert_angles_close(_so(q, color)[0].numpy(), _so(want, color)[0],
                         planes, color, u)
    np.testing.assert_array_equal(_so(q, color)[1].numpy(),
                                  np.asarray(_so(want, color)[1]))
    want = jax.vmap(lambda a, b: jha.angle_or_reference(a, b, color, nc))(
        *one)
    r = _clone(planes)
    ha.angle_or_phase(*_so(r, color), color=color)
    for a, b in zip(r, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("color", [0, 1])
@pytest.mark.parametrize("nx,ny", SHAPES)
def test_angle_equals_component_fed_shifted_uniforms(nx, ny, color):
    """The same Markov chain: an angle Metropolis phase, decoded, equals
    the component phase on the decoded state fed u - 0.5, bitwise; the
    sums are equal too.  The OR reflections agree to COMPONENT_OR_ATOL."""
    g = np.random.default_rng(400 + nx + color)
    planes = _angles(g, nx, ny)
    u = _uniforms(g, tuple(planes[0].shape))
    comp = [c for p in planes for c in trig.cos_sin_2pi(p)]
    a = _clone(planes)
    _, obs = ha.angle_phase(*_so(a, color), u, color=color, beta=1.0 / KBT,
                            measuring=True)
    sx, sy, ox, oy = comp if color == 0 else comp[2:] + comp[:2]
    _, _, cobs = hd.phase(sx, sy, ox, oy, (u[0] - trig.f32(0.5), u[1]),
                          color=color, beta=1.0 / KBT, measuring=True)
    dx, dy = trig.cos_sin_2pi(_so(a, color)[0])
    assert torch.equal(dx, sx) and torch.equal(dy, sy)
    assert torch.equal(obs, cobs)
    comp = [c for p in planes for c in trig.cos_sin_2pi(p)]
    b = _clone(planes)
    ha.angle_or_phase(*_so(b, color), color=color)
    sx, sy, ox, oy = comp if color == 0 else comp[2:] + comp[:2]
    hd.or_phase(sx, sy, ox, oy, color=color)
    dx, dy = trig.cos_sin_2pi(_so(b, color)[0])
    np.testing.assert_allclose(dx.numpy(), sx.numpy(), rtol=0,
                               atol=COMPONENT_OR_ATOL)
    np.testing.assert_allclose(dy.numpy(), sy.numpy(), rtol=0,
                               atol=COMPONENT_OR_ATOL)


def test_angle_or_sweep_conserves_energy():
    """One OR sweep keeps the decoded state's energy (JAX's bound,
    tests/test_xy2d_dense_angle.py: 3e-3 sqrt(N) + 1e-2) and |S| = 1 to
    the decode's accuracy; the fused e equals the decoded state's to
    float32 rounding of its site terms."""
    model = XY2DHelical(nx=65, ny=64, kbt=KBT)
    g = np.random.default_rng(8)
    planes = _angles(g, 65, 64, 1)
    e0 = model.energy_sum(ha.unpack_state(planes, 64, 65))
    planes, obs = ha.over_relax_sweep_measure(model, planes)
    st = ha.unpack_state(planes, 64, 65)
    e1 = model.energy_sum(st)
    assert abs(float(e1 - e0)) < 3e-3 * model.nsites ** 0.5 + 1e-2
    np.testing.assert_allclose(
        torch.hypot(st.sx.double(), st.sy.double()).numpy(), 1.0, atol=2e-7)
    np.testing.assert_allclose((obs["e"] * model.nsites).numpy(),
                               e1.numpy(), rtol=1e-6)


def test_angle_philox_uniforms_are_the_drawn_words():
    g = np.random.default_rng(7)
    planes = _angles(g, 65, 16)
    seeds = rng.seeds_from_key(rng.sample_key(rng.base_key(2), 0), 0)
    u = xp.draw_uniforms(seeds, NREP, 16, 33)
    a, b = _clone(planes), _clone(planes)
    ha.angle_phase(*_so(a, 0), seeds, color=0, beta=1.0 / KBT)
    ha.angle_phase(*_so(b, 0), u, color=0, beta=1.0 / KBT)
    assert all(torch.equal(p, q) for p, q in zip(a, b))


def _tile_field_model(o, color):
    """angle_tile_kernel's field restated on numpy float32, tile by tile
    over ``tile_grid``'s launch: each tile's decoded other-colour rows and
    columns with their halo, the seams read directly.  Returns (hx, hy)
    (NaN where the slot is not a valid site) and each slot's visits."""
    nrep, ny, nc = o.shape
    tx_n = ty_n = ha.TILE
    gx, gy = ha.tile_grid(ny, nc)
    ox, oy = (v.numpy() for v in trig.cos_sin_2pi(o))
    dec = np.stack([ox, oy], axis=-1)
    h = np.full((nrep, ny, nc, 2), np.nan, dtype=np.float32)
    visits = np.zeros((ny, nc), dtype=np.int64)
    for bx in range(gx):
        x0 = bx * tx_n
        cols = np.arange(x0 - 1, x0 + tx_n + 1)
        inside = (cols >= 0) & (cols < nc)
        for by in range(gy):
            for y0 in range(by * ty_n, ny, gy * ty_n):
                nrow = min(ty_n, ny - y0)
                rows = (np.arange(y0 - 1, y0 + nrow + 1)) % ny
                t = np.zeros((nrep, nrow + 2, tx_n + 2, 2), np.float32)
                t[:, :, inside] = dec[:, rows][:, :, cols[inside]]
                for ty in range(nrow):
                    y = y0 + ty
                    long_row = (color == 0) == (y % 2 == 0)
                    for tx in range(tx_n):
                        i = x0 + tx
                        if i >= nc:
                            continue
                        visits[y, i] += 1
                        if i >= (nc if long_row else nc - 1):
                            continue
                        up, dn = t[:, ty, tx + 1], t[:, ty + 2, tx + 1]
                        lf = t[:, ty + 1, tx + (0 if long_row else 1)]
                        rt = t[:, ty + 1, tx + (1 if long_row else 2)]
                        if long_row and i == 0:
                            lf = dec[:, (y - 1) % ny, nc - 1]
                        if long_row and i == nc - 1:
                            rt = dec[:, (y + 1) % ny, 0]
                        h[:, y, i] = ((up + dn) + lf) + rt
    return h[..., 0], h[..., 1], visits


@pytest.mark.parametrize("nx,ny,walk", [
    (3, 2, None), (67, 18, None), (131, 34, None), (259, 10, None),
    (63, 32, None), (65, 64, None), (127, 66, None), (5, 96, None),
    (129, 2, None), (195, 40, None), (61, 6, None), (97, 62, None),
    (67, 50, 1), (67, 98, 2), (33, 130, 1)])
def test_tile_grid_and_field_match_the_plain_field(nx, ny, walk,
                                                   monkeypatch):
    """The tile kernel's tiling, Metropolis and over-relaxation modes (the
    grid ``tile_grid`` gives, the halo rows and columns, the seams)
    restated in numpy: every slot is
    visited once and every valid site's field equals ``angle_field``
    bitwise.  Shapes: nc = 2 (nx = 3) at ny = 2, nc and ny whole tiles,
    one slot or row past a tile, nc not a multiple of the tile width, ny
    not a multiple of its rows, and (walk) a grid of that many row blocks,
    each walking several tile rows."""
    nc = hd.dense_nc(nx)
    gx, gy = ha.tile_grid(ny, nc)
    assert gx == -(-nc // ha.TILE) and 1 <= gy <= -(-ny // ha.TILE)
    if walk is not None:
        monkeypatch.setattr(ha, "tile_grid", lambda ny, nc: (gx, walk))
    g = np.random.default_rng(nx + ny)
    planes = _angles(g, nx, ny)
    for color in (0, 1):
        _, o = _so(planes, color)
        hx, hy, visits = _tile_field_model(o, color)
        assert np.all(visits == 1)
        want_x, want_y = (v.numpy() for v in ha.angle_field(o, color))
        valid = hd.valid_col(color, ny, hd.dense_nc(nx)).numpy()
        assert np.array_equal(np.isnan(hx[0]), ~valid)
        assert np.array_equal(hx[:, valid], want_x[:, valid])
        assert np.array_equal(hy[:, valid], want_y[:, valid])


class _FakeLib:
    """Records the C calls of a wrapper in place of the built library."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def call(*args):
            self.calls.append((name, args))
            return 0
        return call


@pytest.mark.parametrize("measuring", [False, True])
@pytest.mark.parametrize("nx,ny", [(10001, 10000), (65, 64), (131, 34),
                                   (3, 2), (67, 98)])
def test_or_launch_sizes_partials_by_tile_grid(nx, ny, measuring,
                                               monkeypatch):
    """The OR wrapper launches the tile kernel's grid: it passes
    ``tile_grid``'s row blocks, and a measuring launch's partials hold
    its blocks a replica (as the Metropolis wrapper's do), not the old
    grid-stride ``xy2d_helical_dense.blocks``.  The launch itself is
    recorded, not run (no card here)."""
    from contextlib import nullcontext
    nc = hd.dense_nc(nx)
    gx, gy = ha.tile_grid(ny, nc)
    lib = _FakeLib()
    sizes = []
    real = ha.tile_scratch
    monkeypatch.setattr(ha, "_on_cpu", lambda t: False)
    monkeypatch.setattr(ha, "check_dense", lambda *p: None)
    monkeypatch.setattr(ha, "_stream", lambda t: None)
    monkeypatch.setattr(ha, "_lib", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", lambda d: nullcontext())
    monkeypatch.setattr(ha, "tile_scratch", lambda s, m: sizes.append(
        real(s, m)) or sizes[-1])
    s = torch.zeros((2, ny, nc), dtype=torch.float32)
    ha.angle_or_phase(s, s.clone(), color=1, measuring=measuring)
    (name, args), = lib.calls
    assert name == "xya_over_relax"
    assert args[4:9] == (2, ny, nc, gy, 1)
    partials, obs = sizes[0]
    if measuring:
        assert partials.shape == (2, gx * gy, 3) and obs.shape == (2, 3)
        assert gx * gy <= ha.MAX_TILE_BLOCKS
    else:
        assert partials is None and obs is None


def test_angle_runner_replayed_through_the_jax_references(monkeypatch):
    """The default engine as a whole: the runner (random start, OR for
    t <= 1, then Metropolis with the plain observables) replayed phase by
    phase, every phase held against JAX's references started from the
    port's state with the port's uniforms; the replay's series equal the
    runner's bitwise."""
    monkeypatch.delenv("SPINLAT_XY_DENSE_ANGLE", raising=False)
    model = XY2DHelical(nx=65, ny=16, kbt=KBT)
    mcs, key = 3, rng.sample_key(rng.base_key(6), 0)
    run = sweep.make_helical_runner(model, mcs, NREP, "random",
                                    device="cpu", n_over_relax=1,
                                    mcs_over_relax=1)
    assert run.engine == sweep.XY_HELICAL_ANGLE
    series = run(key)
    flat = sweep._init_state(model, "random", NREP, key, "cpu")
    planes = list(ha.pack_state(flat, 16, 65))
    seeds = multispin_rng.sweep_phase_keys(key, mcs)
    for t in range(mcs):
        for color in (0, 1):
            u = xp.draw_uniforms(seeds[t, color], NREP, 16, 33)
            # JAX reads clones: on the CPU it may alias a numpy buffer and
            # run after the port's in-place update of ``planes``
            before = _clone(planes)
            want = jax.vmap(lambda a, b, uc, ua, c=color:
                            jha.angle_phase_reference(
                                a, b, c, uc, ua, model.beta, 33))(
                *(jnp.asarray(p.numpy()) for p in before),
                *(jnp.asarray(v.numpy()) for v in u))
            ha.angle_phase(*_so(planes, color), seeds[t, color],
                           color=color, beta=model.beta)
            _assert_angles_close(_so(planes, color)[0].numpy(),
                                 _so(want, color)[0], before, color, u)
        if t == 0:
            for color in (0, 1):
                want = jax.vmap(lambda a, b, c=color: jha.angle_or_reference(
                    a, b, c, 33))(*(jnp.asarray(p.numpy())
                                    for p in _clone(planes)))
                out = ha.angle_or_phase(*_so(planes, color), color=color,
                                        measuring=color == 1)
                np.testing.assert_array_equal(
                    _so(planes, color)[0].numpy(),
                    np.asarray(_so(want, color)[0]))
            obs = hd.densities(model, out[1])
        else:
            obs = ha.observables(model, planes)
        for k in ("m", "my", "e"):
            assert torch.equal(series[k][:, t], obs[k])


def test_angle_interop_jax_planes_in_same_phase_out():
    """JAX's angle planes (W = 128) into the port, one OR phase, equal to
    JAX's reference on its planes, cut to nc; the flat converter packs the
    same planes as the port's pack_state."""
    g = np.random.default_rng(9)
    th = _turns(g, 65, 16)
    jplanes = jha.dense_pack(jnp.asarray(th), 16, 65)
    planes = list(interop.xy_helical_from_numpy(
        [np.asarray(p) for p in jplanes], 33))
    ha.angle_or_phase(*_so(planes, 0), color=0)
    want = jax.vmap(lambda a, b: jha.angle_or_reference(a, b, 0, 33))(
        *jplanes)
    for a, b in zip(planes, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b)[..., :33])
    fx = np.cos(2 * np.pi * th).astype(np.float32)
    fy = np.sin(2 * np.pi * th).astype(np.float32)
    for p, q in zip(interop.xy_helical_from_flat(fx, fy, 16, 65, angle=True),
                    ha.pack_state((torch.from_numpy(fx),
                                   torch.from_numpy(fy)), 16, 65)):
        assert torch.equal(p, q)


def _split(path):
    lines = path.read_text().splitlines()
    head = [s for s in lines if s.startswith("#")]
    rows = np.array([s.split() for s in lines if not s.startswith("#")],
                    dtype=np.float64)
    return head, rows


@pytest.mark.parametrize("extra", [[], ["--n-over-relax", "1"]])
def test_angle_cli_matches_jax(extra, tmp_path, monkeypatch):
    """The default engine through the CLI at odd nx, Metropolis only and
    with over-relaxation at every t: the JAX CLI's headers but for the
    engine stamp; m(t), e(t) within 5 combined standard errors."""
    monkeypatch.delenv("SPINLAT_XY_DENSE_ANGLE", raising=False)
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
    assert f"# engine: {sweep.XY_HELICAL_ANGLE}" in head
    assert rows.shape == jrows.shape == (20, 10)
    n, ns = rows[0, 0], rows[0, 1]
    for col, var_col in ((3, 7), (4, 8)):
        se = np.sqrt((rows[:, var_col] + jrows[:, var_col]) / (n * ns))
        z = np.abs(rows[:, col] - jrows[:, col]) / se
        assert np.all(z < 5.0), (col, z)
