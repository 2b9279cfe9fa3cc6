"""The clock and XY halo kernels' plain versions against the JAX package.

- ``clock_planes.sharded_phase_packed`` (q = 6, 4, 3: bit rows and word
  columns, injected random planes, the fused partials) against JAX's
  ``sharded_phase_packed{6,4,3}`` in interpret mode at its test shape
  (2 x 256^2, ``tests/test_clock_multispin.py:432-540``): bitwise;
- ``clock_pallas.sharded_phase`` (int8, rows and columns, injected
  uniforms) against JAX's in interpret mode at ``R, L, HALF = 2, 64,
  128`` (``tests/test_shard_pallas.py``): the states bitwise, the
  (Σ cos, Σ sin, e) partials to a relative 1e-5 (JAX sums in float32, the
  port in float64);
- ``xy2d_pallas.sharded_phase`` and ``sharded_or_phase`` against JAX's
  there: a component within 4e-7 (Metropolis) or 1e-6 (OR), a site
  whose decision differs only where |u_acc - p| < 1e-6 and at most 1 in
  1e4 (the tolerances of ``tests/test_torch_xy2d.py``, which says why),
  the partials to a relative 1e-5;
- every plain version, with Philox words, equal bit for bit to the
  matching block of the unsharded plain phase, at offsets that cut the
  int8 clock's unit of two columns (odd col0), and the snapshot mode's
  partials to float64 rounding.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_fortran_mc_simulation_spin_tpu.ops import clock3_multispin as jc3
from cuda_fortran_mc_simulation_spin_tpu.ops import clock4_multispin as jc4
from cuda_fortran_mc_simulation_spin_tpu.ops import clock_multispin as jc6
from cuda_fortran_mc_simulation_spin_tpu.ops import clock_pallas as jck
from cuda_fortran_mc_simulation_spin_tpu.ops import xy2d_pallas as jxy
from cuda_fortran_mc_simulation_spin_tpu_torch.core import lattice, rng
from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
    clock3_multispin,
    clock4_multispin,
    clock_multispin,
    clock_pallas,
    clock_planes as cp,
    trig,
    xy2d_pallas as xp,
)

R, L, HALF = 2, 64, 128          # JAX's test_shard_pallas shapes
KBT_CLOCK, KBT_XY = 0.91, 0.89
SEEDS = np.array([12345, -678], np.int32)
PAIRS = {6: (clock_multispin, jc6.sharded_phase_packed6),
         4: (clock4_multispin, jc4.sharded_phase_packed4),
         3: (clock3_multispin, jc3.sharded_phase_packed3)}
STATE_ATOL, OR_ATOL, SUM_RTOL = 4e-7, 1e-6, 1e-5
BORDER, MAX_FLIP_SHARE = 1e-6, 1e-4


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _words(g, shape):
    return g.integers(-2 ** 31, 2 ** 31, size=shape,
                      dtype=np.int64).astype(np.int32)


def _clock_colors(g, q, nrep, ny, nx):
    full = g.integers(0, q, size=(nrep, ny, nx)).astype(np.int8)
    a, b = lattice.split_checkerboard(_t(full))
    return a, b


def _rand_planes(g, spec, shape):
    """Injected random planes; for q = 6 a valid (rt1, rt2) Z3 encoding
    and no null proposal, as the JAX test builds them."""
    planes = [_words(g, shape) for _ in range(spec.n_rand)]
    if spec.q == 6:
        planes[2] &= ~planes[1]
        planes[0] |= ~(planes[1] | planes[2])
    return planes


@pytest.mark.parametrize("q", [6, 4, 3])
@pytest.mark.parametrize("color,cols", [(0, False), (1, False), (0, True),
                                        (1, True)])
def test_packed_clock_plain_matches_jax_halo_kernel(q, color, cols):
    """New planes and, for the measuring phase b, the (m, e) partials
    bitwise against JAX's sharded kernel on the same injected planes and
    halos (boundary bits of valid states, random word columns)."""
    port, jfn = PAIRS[q]
    spec = port.SPEC
    g = np.random.default_rng(100 + 10 * q + 2 * color + cols)
    a, b = _clock_colors(g, q, 2, 256, 256)
    wa, wb = spec.pack_color(a), spec.pack_color(b)
    x, o = (wa, wb) if color == 0 else (wb, wa)
    shape = tuple(x[0].shape)
    rand = _rand_planes(g, spec, shape)
    # boundary bits: the top and bottom rows of valid packed states
    ha, _ = _clock_colors(g, q, 2, 64, 256)
    hp = spec.pack_color(ha)
    hup = tuple(((p[:, :1] >> 31) & 1).contiguous() for p in hp)
    hdn = tuple((p[:, 1:2] & 1).contiguous() for p in hp)
    kw, jkw, offs = {}, {}, [0, 8]
    if cols:
        lf = tuple(_t(_words(g, (2, shape[1], 1))) for _ in x)
        rt = tuple(_t(_words(g, (2, shape[1], 1))) for _ in x)
        kw = dict(halo_lf=lf, halo_rt=rt)
        jkw = dict(halo_lf=tuple(jnp.asarray(p.numpy()) for p in lf),
                   halo_rt=tuple(jnp.asarray(p.numpy()) for p in rt))
        offs = [0, 8, HALF]
    measuring = color == 1

    def j(planes):
        return tuple(jnp.asarray(p.numpy()) for p in planes)

    want = jfn(j(x), j(o), j(hup), j(hdn), jnp.asarray(SEEDS),
               jnp.asarray(offs, jnp.int32), color=color, beta=1.0 / 0.8,
               inject=tuple(jnp.asarray(r) for r in rand), interpret=True,
               measuring=measuring, **jkw)
    got = cp.sharded_phase_packed(spec, x, o, hup, hdn, _t(SEEDS), offs,
                                  color=color, beta=1.0 / 0.8,
                                  inject=[_t(r) for r in rand],
                                  measuring=measuring, **kw)
    if measuring:
        (gp, gm, ge), (wp, wm, we) = got, want
        np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))
        np.testing.assert_array_equal(ge.numpy(), np.asarray(we))
    else:
        gp, wp = got, want
    for g_, w_ in zip(gp, wp):
        np.testing.assert_array_equal(g_.numpy(), np.asarray(w_))


def _int8_case(g, q=6):
    x = g.integers(0, q, size=(R, L, HALF)).astype(np.int8)
    o = g.integers(0, q, size=(R, L, HALF)).astype(np.int8)
    hu = g.integers(0, q, size=(R, 1, HALF)).astype(np.int8)
    hd = g.integers(0, q, size=(R, 1, HALF)).astype(np.int8)
    hl = g.integers(0, q, size=(R, L, 1)).astype(np.int8)
    hr = g.integers(0, q, size=(R, L, 1)).astype(np.int8)
    uc = g.random(size=(R, L, HALF), dtype=np.float32)
    ua = g.random(size=(R, L, HALF), dtype=np.float32)
    return x, o, hu, hd, hl, hr, uc, ua


@pytest.mark.parametrize("color,cols", [(0, False), (1, False), (0, True),
                                        (1, True)])
def test_int8_clock_plain_matches_jax_halo_kernel(color, cols):
    g = np.random.default_rng(200 + 2 * color + cols)
    x, o, hu, hd, hl, hr, uc, ua = _int8_case(g)
    kw, jkw, offs = {}, {}, [0, 2 * L]
    if cols:
        kw = dict(halo_lf=_t(hl), halo_rt=_t(hr))
        jkw = dict(halo_lf=jnp.asarray(hl), halo_rt=jnp.asarray(hr))
        offs = [0, 2 * L, HALF]
    beta = 1.0 / KBT_CLOCK
    measuring = color == 1
    want = jck.sharded_phase(
        jnp.asarray(x), jnp.asarray(o), jnp.asarray(hu), jnp.asarray(hd),
        jnp.asarray(SEEDS), jnp.asarray(offs, jnp.int32), color=color, q=6,
        beta=beta, u_cand=jnp.asarray(uc), u_acc=jnp.asarray(ua),
        interpret=True, measuring=measuring, **jkw)
    got = clock_pallas.sharded_phase(
        _t(x), _t(o), _t(hu), _t(hd), _t(SEEDS), offs, color=color, q=6,
        beta=beta, u_cand=_t(uc), u_acc=_t(ua), measuring=measuring, **kw)
    if not measuring:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        return
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    for a, b in zip(got[1:], want[1:]):
        b = np.asarray(b, np.float64)
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=SUM_RTOL * max(1.0, np.abs(b).max()))


def _xy_case(g):
    def unit(shape):
        th = g.uniform(0.0, 2 * np.pi, size=shape)
        return np.cos(th).astype(np.float32), np.sin(th).astype(np.float32)

    sx, sy = unit((R, L, HALF))
    ox, oy = unit((R, L, HALF))
    (hux, huy), (hdx, hdy) = unit((R, 1, HALF)), unit((R, 1, HALF))
    (lfx, lfy), (rtx, rty) = unit((R, L, 1)), unit((R, L, 1))
    uc = g.random(size=(R, L, HALF), dtype=np.float32)
    ua = g.random(size=(R, L, HALF), dtype=np.float32)
    return (sx, sy, ox, oy, (hux, hdx), (huy, hdy), (lfx, rtx), (lfy, rty),
            uc, ua)


def _accept_prob(sx, sy, ox, oy, halos_x, halos_y, cols_x, cols_y, color,
                 u_cand, beta, row0):
    """float64 acceptance probability of every site of a shard."""
    def wide(p):
        return tuple(v.double() for v in p) if p is not None else None

    hx = lattice.neighbor_sums_halo(ox.double(), color, row0,
                                    *wide(halos_x), *(wide(cols_x) or
                                                      (None, None)))
    hy = lattice.neighbor_sums_halo(oy.double(), color, row0,
                                    *wide(halos_y), *(wide(cols_y) or
                                                      (None, None)))
    cx, cy = (c.double() for c in trig.cos_sin_2pi(u_cand))
    de = -((cx - sx.double()) * hx + (cy - sy.double()) * hy)
    return torch.exp(-beta * de.clamp(min=0.0)).numpy()


@pytest.mark.parametrize("color,cols", [(0, False), (1, False), (0, True),
                                        (1, True)])
def test_xy_plain_matches_jax_halo_kernel(color, cols):
    g = np.random.default_rng(300 + 2 * color + cols)
    sx, sy, ox, oy, hx, hy, cx, cy, uc, ua = _xy_case(g)
    kw, jkw, offs = {}, {}, [0, 2 * L]
    if cols:
        kw = dict(cols_x=tuple(map(_t, cx)), cols_y=tuple(map(_t, cy)))
        jkw = dict(cols_x=tuple(map(jnp.asarray, cx)),
                   cols_y=tuple(map(jnp.asarray, cy)))
        offs = [0, 2 * L, HALF]
    beta = 1.0 / KBT_XY
    measuring = color == 1
    want = jxy.sharded_phase(
        *(jnp.asarray(p) for p in (sx, sy, ox, oy)),
        tuple(map(jnp.asarray, hx)), tuple(map(jnp.asarray, hy)),
        jnp.asarray(SEEDS), jnp.asarray(offs, jnp.int32), color=color,
        beta=beta, u_cand=jnp.asarray(uc), u_acc=jnp.asarray(ua),
        interpret=True, measuring=measuring, **jkw)
    before = tuple(map(_t, (sx, sy, ox, oy)))
    got = xp.sharded_phase(
        *(p.clone() for p in before), tuple(map(_t, hx)),
        tuple(map(_t, hy)), _t(SEEDS), offs, color=color, beta=beta,
        u_cand=_t(uc), u_acc=_t(ua), measuring=measuring, **kw)
    d = np.maximum(np.abs(got[0].numpy() - np.asarray(want[0])),
                   np.abs(got[1].numpy() - np.asarray(want[1])))
    off = d > STATE_ATOL
    if off.any():
        p = _accept_prob(*before, tuple(map(_t, hx)), tuple(map(_t, hy)),
                         kw.get("cols_x"), kw.get("cols_y"), color, _t(uc),
                         beta, offs[1])
        assert np.all(np.abs(ua.astype(np.float64) - p)[off] < BORDER)
        assert off.sum() <= MAX_FLIP_SHARE * off.size
    if measuring:
        for j, w in enumerate(want[2]):
            w = np.asarray(w, np.float64)
            np.testing.assert_allclose(
                got[2][:, j].numpy(), w, rtol=0,
                atol=SUM_RTOL * max(1.0, np.abs(w).max()))


@pytest.mark.parametrize("color,cols", [(0, False), (1, True)])
def test_xy_or_plain_matches_jax_halo_kernel(color, cols):
    g = np.random.default_rng(400 + 2 * color + cols)
    sx, sy, ox, oy, hx, hy, cx, cy, _, _ = _xy_case(g)
    kw, jkw, offs = {}, {}, [0, 2 * L]
    if cols:
        kw = dict(cols_x=tuple(map(_t, cx)), cols_y=tuple(map(_t, cy)))
        jkw = dict(cols_x=tuple(map(jnp.asarray, cx)),
                   cols_y=tuple(map(jnp.asarray, cy)))
        offs = [0, 2 * L, HALF]
    want = jxy.sharded_or_phase(
        *(jnp.asarray(p) for p in (sx, sy, ox, oy)),
        tuple(map(jnp.asarray, hx)), tuple(map(jnp.asarray, hy)),
        jnp.asarray(offs, jnp.int32), color=color, interpret=True, **jkw)
    got = xp.sharded_or_phase(
        *map(_t, (sx, sy, ox, oy)), tuple(map(_t, hx)), tuple(map(_t, hy)),
        offs, color=color, **kw)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=OR_ATOL)


def _blocks(t, y0, rows, c0, cols):
    """Block, halo rows (up, dn) and columns (lf, rt) of the other colour
    ``t`` (R, ny, half) for the shard at (y0, c0), periodic."""
    ny, half = t.shape[-2:]
    blk = t[:, y0:y0 + rows, c0:c0 + cols].contiguous()
    up = t[:, (y0 - 1) % ny][:, None, c0:c0 + cols].contiguous()
    dn = t[:, (y0 + rows) % ny][:, None, c0:c0 + cols].contiguous()
    lf = t[:, y0:y0 + rows, (c0 - 1) % half][..., None].contiguous()
    rt = t[:, y0:y0 + rows, (c0 + cols) % half][..., None].contiguous()
    return blk, (up, dn), (lf, rt)


@pytest.mark.parametrize("y0,c0", [(0, 0), (4, 11), (0, 11), (4, 0)])
def test_plain_versions_draw_the_unsharded_words(y0, c0):
    """With Philox words a shard's phase is the matching block of the
    unsharded phase: the int8 clock at col0 = 11 (a cut unit of two), XY
    (its snapshot mode's partials summing over the shards to the
    unsharded sums), and the packed clock at global word offsets."""
    g = np.random.default_rng(5 + y0 + c0)
    seeds = rng.seeds_from_key(rng.base_key(9), 1)
    sl = (slice(None), slice(y0, y0 + 4), slice(c0, c0 + 11))
    for q in (2, 5, 7):
        a = _t(g.integers(0, q, size=(R, 8, 22)).astype(np.int8))
        b = _t(g.integers(0, q, size=(R, 8, 22)).astype(np.int8))
        for color in (0, 1):
            want = clock_pallas.phase_plain(a, b, seeds, color=color, q=q,
                                            beta=1.1)
            ob, rows, cols = _blocks(b, y0, 4, c0, 11)
            got = clock_pallas.sharded_phase_plain(
                a[sl], ob, *rows, seeds, (0, y0, c0), color=color, q=q,
                beta=1.1, halo_lf=cols[0], halo_rt=cols[1])
            assert torch.equal(got, want[sl])
    th = torch.from_numpy(g.uniform(0, 2 * np.pi, size=(6, R, 8, 22)))
    planes = [torch.cos(th[k]).float() if k % 2 == 0
              else torch.sin(th[k - 1]).float() for k in range(4)]
    snap = [torch.cos(th[4]).float(), torch.sin(th[4]).float(),
            torch.cos(th[5]).float(), torch.sin(th[5]).float()]
    wx, wy = planes[0].clone(), planes[1].clone()
    xp.metropolis_phase_plain(wx, wy, planes[2], planes[3], seeds, color=0,
                              beta=1.1)
    obx, rx, cx = _blocks(planes[2], y0, 4, c0, 11)
    oby, ry, cy = _blocks(planes[3], y0, 4, c0, 11)
    gx, gy = planes[0][sl].clone(), planes[1][sl].clone()
    xp.sharded_phase_plain(gx, gy, obx, oby, rx, ry, seeds, (0, y0, c0),
                           color=0, beta=1.1, cols_x=cx, cols_y=cy)
    assert torch.equal(gx, wx[sl]) and torch.equal(gy, wy[sl])
    # the snapshot mode's partials over a (2, 2) split sum to the whole's
    whole = [p.clone() for p in planes]
    _, _, want = xp.metropolis_phase_plain(*whole, seeds, color=0, beta=1.1,
                                           snap=snap)
    total = torch.zeros_like(want)
    for yy in (0, 4):
        for cc in (0, 11):
            s = (slice(None), slice(yy, yy + 4), slice(cc, cc + 11))
            bx_, rx_, cx_ = _blocks(planes[2], yy, 4, cc, 11)
            by_, ry_, cy_ = _blocks(planes[3], yy, 4, cc, 11)
            _, _, part = xp.sharded_phase_plain(
                planes[0][s].clone(), planes[1][s].clone(), bx_, by_, rx_,
                ry_, seeds, (0, yy, cc), color=0, beta=1.1, cols_x=cx_,
                cols_y=cy_, snap=[p[s].contiguous() for p in snap])
            total += part
    torch.testing.assert_close(total, want, rtol=1e-13, atol=1e-12)
    # the packed clock q = 6: word rows 2.. and words 32.. of (R, 4, 64)
    spec = clock_multispin.SPEC
    ca, cb = _clock_colors(g, 6, R, 128, 128)
    xa, xb = spec.pack_color(ca), spec.pack_color(cb)
    want = cp.phase_plain(spec, xa, xb, seeds, color=1, beta=1.25,
                          measuring=True)
    blk = (slice(None), slice(2, 4), slice(32, 64))
    hup = tuple(((p[:, 1:2, 32:] >> 31) & 1).contiguous() for p in xb)
    hdn = tuple((p[:, 0:1, 32:] & 1).contiguous() for p in xb)
    got = cp.sharded_phase_packed_plain(
        spec, tuple(p[blk] for p in xa), tuple(p[blk] for p in xb), hup,
        hdn, seeds, (0, 2, 32), color=1, beta=1.25,
        halo_lf=tuple(p[:, 2:4, 31:32].contiguous() for p in xb),
        halo_rt=tuple(p[:, 2:4, 0:1].contiguous() for p in xb))
    for g_, w_ in zip(got, want[0]):
        assert torch.equal(g_, w_[blk])


def test_shard_gates():
    """shard_ok takes every local block (JAX's half % 128 and rows % 8 are
    TPU tiling); the q-modules bind the halo mode as JAX's do."""
    for mod in (clock_multispin, clock4_multispin, clock3_multispin):
        ok = getattr(mod, f"shard_packed{mod.SPEC.q}_ok")
        assert ok((2, 1, 1)) and ok((4, 3, 130))
        assert not ok((2, 8))
        assert getattr(mod, f"sharded_phase_packed{mod.SPEC.q}").args == (
            mod.SPEC,)
