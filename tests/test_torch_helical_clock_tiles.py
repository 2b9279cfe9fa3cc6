"""The masked helical clock multisweep's tiles, replayed on the CPU.

``csrc/helical_pallas.cu`` ``clock_multisweep_kernel`` streams each clock
phase through the Ising multisweep's tiles (``hp.THREADS`` aligned 16-B
vectors of one replica, staged in shared memory a tile ahead), from the
constants the wrapper passes (``hp.ising_tiles``).  These tests walk that
launch in numpy, lane by lane, from the same constants: the vectors staged
for a tile (each lane's own and the vectors under its up and down windows,
the ones before and after the tile) and what each lane reads of them (its
own, the neighbour lanes' edge bytes, its window pairs through the byte
shift network); where each byte comes from (the state in range, the
state at the wrapped index, or at odd N the seam snapshot); the four
clock units a lane draws (where its first colour site is odd, the second
half of one, three whole ones and the first half of the next lane's first
unit, by a shuffle, lane 31 drawing it itself), or its injected
uniforms; the clock rule on the staged float32 (cos, sin) table; the
stores; the fused float64 sums a tile at even N and the odd-N pass over
the final state.

Every colour site must be stored once, by the lane that holds it; every
neighbour a site reads must be the pre-phase value of the index the plain
version reads; each phase through the tiles must equal
``hp.clock_phase_plain`` bitwise, and S sweeps ``hp.clock_multisweep_
plain`` bitwise in the state, the sums to float64 rounding (1e-12 of
their scale: the kernel adds in another order).  The plain versions are
held against the JAX package in tests/test_torch_helical_pallas.py.

Shapes (R, ny, nx): 33x32 and 65x64 (even N), 33x31 (odd N), (3, 30, 35)
and (5, 31, 35) (replica bases not 16-B aligned, so lanes whose first
colour site is odd and the shuffle), (2, 2, 3) (N below one vector);
states at an aligned address and 3 bytes past one; q = 2, 5, 6.
"""

import numpy as np
import pytest
import torch
from test_torch_helical_pallas_tiles import (
    LANES,
    LAST,
    SHAPES,
    V,
    T,
    _check_reads,
    _lane_reads,
    _philox,
    _stage_ising,
    _u24,
    _walk,
    _window16,
)

from cuda_fortran_mc_simulation_spin_tpu_torch.core import rng
from cuda_fortran_mc_simulation_spin_tpu_torch.ops import helical_pallas as hp
from cuda_fortran_mc_simulation_spin_tpu_torch.ops import multispin_rng

KBT = 0.8
QS = [2, 5, 6]
SWEEPS = 2
_BYTES = np.arange(16, dtype=np.uint8)


def _tables(q: int):
    """The staged tables: float32 (cos, sin) for the update, float64 for
    the sums, (2, 128) each, zero past q."""
    return hp.table_rows(q).numpy(), hp.table_rows(q, torch.float64).numpy()


def _windows(reads, g):
    """A lane's neighbour bytes as the kernel forms them: the up and down
    windows (bytes ou .. and od .. of the staged pairs), the left (the top
    byte of the lane before's vector, then its own) and the right (its
    own, then the next lane's low byte); each (values, sources, indices),
    (T, 16)."""
    sel_u = _window16(_BYTES, _BYTES + 16, g["ou"])
    sel_d = _window16(_BYTES, _BYTES + 16, g["od"])
    own, left, right = reads["own"], reads["left"], reads["right"]
    out = {"own": own}
    for name, sel in (("up", sel_u), ("dn", sel_d)):
        if name in reads:
            out[name] = tuple(q[:, sel] for q in reads[name])
    out["left"] = tuple(np.concatenate([lf[:, None], ow[:, :15]], axis=1)
                        for lf, ow in zip(left, own))
    out["right"] = tuple(np.concatenate([ow[:, 1:], rt[:, None]], axis=1)
                         for rt, ow in zip(right, own))
    return out


def _lane_uniforms(r, k0, key, m0, u, ks, inc):
    """(u_cand, u_acc) (T, 8) of a lane's eight colour sites k0 .. k0 + 7:
    from the injected rows ``u``, or from the units the kernel draws,
    units u0 .. u0 + 3 (u0 = k0 >> 1) and, where k0 is odd, the first
    half of unit u0 + 4 from the next lane (a shuffle; lane 31 draws it)."""
    if u is not None:
        at = np.clip(ks, 0, m0 - 1)
        return (np.where(inc, u[0][r][at], 0.0).astype(np.float32),
                np.where(inc, u[1][r][at], 0.0).astype(np.float32))
    u0 = k0 >> 1
    odd_k = int(k0[0]) & 1
    assert ((k0 & 1) == odd_k).all()
    units = [_philox(r, u0 + m, key) for m in range(4)]
    nxt = np.where(LAST[:, None], _philox(r, u0 + 4, key),
                   np.roll(units[0], -1, axis=0))
    w = np.concatenate(units + [nxt], axis=1)
    first = 2 * (np.arange(8) + odd_k)
    return _u24(w[:, first]), _u24(w[:, first + 1])


def _clock_tiles_phase(x: np.ndarray, color: int, nx: int, q: int,
                       beta: float, offset: int, key=None, u=None):
    """One clock phase of (R, N) int8 states through the kernel's tiles:
    (new states, stores per site, (R, tpr, 3) fused tile partials of
    colour 1 at even N, e not negated)."""
    nrep, n = x.shape
    g = hp.ising_tiles(nrep, n, nx, offset)
    tab, tab64 = _tables(q)
    m0 = hp.colour_sites(n, 0)
    odd = n % 2 == 1
    fused = color == 1 and not odd
    new = x.copy()
    stores = np.zeros((nrep, n), np.int64)
    parts = np.zeros((nrep, g["tpr"], 3))
    want_u = None if key is None else hp.draw_uniforms(key, nrep, m0)
    for r, ts in _walk(min(5, nrep * g["tpr"]), nrep, g["tpr"]):
        st = x[r]
        seam = np.concatenate([st[:nx], st[n - nx:]]) if odd else None
        rb = g["off0"] + r * n
        vl = (rb + n - 1) // V
        v = rb // V + T * ts + LANES
        warp = np.repeat(v[::32] <= vl, 32)
        valid = v <= vl
        a = V * v - rb
        w = _windows(_lane_reads(
            _stage_ising(st, seam, int(a[0]), vl - int(v[0]), nx, g), valid),
            g)
        p0 = (color - a) & 1
        k0 = (a + p0 - color) >> 1
        assert (p0 == p0[0]).all()
        pos = int(p0[0]) + 2 * np.arange(8)
        idx = a[:, None] + pos
        ks = k0[:, None] + np.arange(8)
        live = warp[:, None] & valid[:, None] & (idx >= 0) & (idx < n)
        assert (ks[live] == (idx[live] - color) // 2).all()
        for name, off in (("up", -nx), ("dn", nx), ("left", -1),
                          ("right", 1)):
            _, src, ind = w[name]
            _check_reads(src[:, pos], ind[:, pos], (idx + off) % n, odd,
                         live)
        assert (w["own"][2][:, pos][live] == idx[live]).all()
        assert (w["own"][1][:, pos][live] == 0).all()
        uc, ua = _lane_uniforms(r, k0, key, m0, u, ks, live)
        if want_u is not None:
            for got, want in zip((uc, ua), want_u):
                assert (got[live] == want.numpy()[r][ks[live]]).all()
        st8 = [w[k][0][:, pos].astype(np.int64) & 127
               for k in ("own", "up", "dn", "left", "right")]
        xs, ou, od, ol, orr = st8
        hx = ((tab[0][ou] + tab[0][od]) + tab[0][ol]) + tab[0][orr]
        hy = ((tab[1][ou] + tab[1][od]) + tab[1][ol]) + tab[1][orr]
        nw = xs + (uc * np.float32(q - 1)).astype(np.int32) + 1
        nw = np.where(nw >= q, nw - q, nw)
        de = -((tab[0][nw] - tab[0][xs]) * hx + (tab[1][nw] - tab[1][xs])
               * hy)
        prob = torch.exp(torch.from_numpy(
            np.float32(-beta) * np.maximum(de, np.float32(0)))).numpy()
        out = np.where(ua < prob, nw, xs)
        new[r, idx[live]] = out[live]
        np.add.at(stores[r], idx[live], 1)
        if fused:
            go, gl = tab64[:, out], tab64[:, ol]
            gu, gd, gr = tab64[:, ou], tab64[:, od], tab64[:, orr]
            term = np.stack([
                go[0] + gl[0], go[1] + gl[1],
                go[0] * ((gu[0] + gd[0]) + (gl[0] + gr[0]))
                + go[1] * ((gu[1] + gd[1]) + (gl[1] + gr[1]))], axis=-1)
            parts[r, ts] = term[live].sum(axis=0)
    return new, stores, parts


def _clock_tiles_measure(x: np.ndarray, nx: int, q: int, offset: int):
    """The odd-N pass's (R, tpr, 3) tile partials of (R, N) states: the
    own vector, the right byte and the down window, all from the state."""
    nrep, n = x.shape
    g = hp.ising_tiles(nrep, n, nx, offset)
    tab64 = _tables(q)[1]
    parts = np.zeros((nrep, g["tpr"], 3))
    for r, ts in _walk(min(3, nrep * g["tpr"]), nrep, g["tpr"]):
        rb = g["off0"] + r * n
        vl = (rb + n - 1) // V
        v = rb // V + T * ts + LANES
        a = V * v - rb
        w = _windows(_lane_reads(_stage_ising(x[r], None, int(a[0]),
                                              vl - int(v[0]), nx, g,
                                              up=False), v <= vl), g)
        idx = a[:, None] + np.arange(V)
        live = (v <= vl)[:, None] & (idx >= 0) & (idx < n)
        assert (w["dn"][2][live] == ((idx + nx) % n)[live]).all()
        assert (w["right"][2][live] == ((idx + 1) % n)[live]).all()
        sv, rv, dv = (w[k][0].astype(np.int64) & 127
                      for k in ("own", "right", "dn"))
        term = np.stack([tab64[0][sv], tab64[1][sv],
                         tab64[0][sv] * (tab64[0][rv] + tab64[0][dv])
                         + tab64[1][sv] * (tab64[1][rv] + tab64[1][dv])],
                        axis=-1)
        parts[r, ts] = term[live].sum(axis=0)
    return parts


def _sums(parts):
    """The (R, 3) sums xy::reduce_kernel writes from the tile partials."""
    tot = parts.sum(axis=1)
    tot[:, 2] = -tot[:, 2]
    return tot


def _states(shape, q, seed):
    nrep, ny, nx = shape
    g = np.random.default_rng(seed)
    return g, g.integers(0, q, size=(nrep, ny * nx), dtype=np.int8)


def _assert_sums(got, want, n):
    scale = np.maximum(np.abs(want), 2 * n)
    assert (np.abs(got - want) / scale).max() <= 1e-12


@pytest.mark.parametrize("q", QS)
@pytest.mark.parametrize("offset", [0, 3])
@pytest.mark.parametrize("color", [0, 1])
@pytest.mark.parametrize("nrep,ny,nx", SHAPES)
def test_clock_phase_through_the_tiles(nrep, ny, nx, color, offset, q):
    n = ny * nx
    g, x = _states((nrep, ny, nx), q, 13 * n + nrep + color + q)
    m0 = hp.colour_sites(n, 0)
    key = rng.seeds_from_key(rng.base_key(n + color + q), color)
    inj = tuple(rng.bits_to_uniform(torch.from_numpy(
        g.integers(0, 2 ** 32, size=(nrep, m0), dtype=np.uint64)
        .astype(np.int64))).numpy() for _ in range(2))
    beta = 1 / KBT
    mask = hp.colour_mask(n, color).numpy()
    for kw, uni in ((dict(key=key), hp.draw_uniforms(key, nrep, m0)),
                    (dict(u=inj), tuple(torch.from_numpy(v) for v in inj))):
        new, stores, parts = _clock_tiles_phase(x, color, nx, q, beta,
                                                offset, **kw)
        want = hp.clock_phase_plain(torch.from_numpy(x), *uni, color=color,
                                    nx=nx, q=q, beta=beta).numpy()
        np.testing.assert_array_equal(new, want)
        assert (stores[:, mask] == 1).all() and (stores[:, ~mask] == 0).all()
        exact = hp.clock_sums(torch.from_numpy(new), nx, q).numpy()
        if color == 1 and n % 2 == 0:
            _assert_sums(_sums(parts), exact, n)
        if n % 2:
            _assert_sums(_sums(_clock_tiles_measure(new, nx, q, offset)),
                         exact, n)


@pytest.mark.parametrize("q", QS)
@pytest.mark.parametrize("nrep,ny,nx", [(3, 32, 33), (3, 31, 33),
                                        (5, 31, 35)])
def test_clock_multisweep_through_the_tiles(nrep, ny, nx, q):
    """S sweeps of replayed phases (colour 0, then colour 1, under the
    sweep's phase keys): the states equal clock_multisweep_plain bitwise,
    each sweep's sums (fused at even N, the pass at odd N) its sums to
    float64 rounding."""
    n = ny * nx
    _, x = _states((nrep, ny, nx), q, 7 * n + q)
    seeds = multispin_rng.sweep_phase_keys(rng.base_key(3 + q), SWEEPS, 5)
    beta = 1 / KBT
    cur, obs = x, []
    for s in range(SWEEPS):
        for c in (0, 1):
            cur, _, parts = _clock_tiles_phase(cur, c, nx, q, beta, 3,
                                               key=seeds[s, c])
        if n % 2:
            parts = _clock_tiles_measure(cur, nx, q, 3)
        obs.append(_sums(parts))
    want, wobs = hp.clock_multisweep_plain(torch.from_numpy(x), seeds,
                                           beta=beta, nx=nx, q=q)
    np.testing.assert_array_equal(cur, want.numpy())
    _assert_sums(np.stack(obs, axis=1), wobs.numpy(), n)


def test_partials_fill_every_tile():
    """The sums' partials: one a tile, tpr a (replica, sweep), as the
    wrapper allocates them (the tiles past a shorter replica's last
    vector add zeros)."""
    for nrep, ny, nx in SHAPES + [(100, 500, 501), (64, 1000, 1001)]:
        n = ny * nx
        for off in (0, 3, 8):
            t = hp.ising_tiles(nrep, n, nx, off)
            most = max((off + r * n + n - 1) // V - (off + r * n) // V + 1
                       for r in range(nrep))
            assert t["tpr"] == -(-most // T)
    assert hp.ising_tiles(100, 500 * 501, 501)["tpr"] == 62
