"""The masked helical kernels' tiles, replayed on the CPU.

``csrc/helical_pallas.cu`` streams an Ising phase through tiles of
``hp.THREADS`` 16-B vectors of one replica at aligned addresses, and an XY
phase through blocks of ``hp.THREADS`` float4 vectors, from the constants
the wrappers pass (``hp.ising_tiles``, ``hp.xy_tiles``).  These tests walk
that launch in numpy, lane by lane, from the same constants: the aligned
vectors staged in shared memory for an Ising tile (each lane's own and the
vectors under its up and down windows, the ones before and after the
tile) and what each lane reads of them (its own, the neighbours' edge
bytes, its window pairs); the vectors an XY lane loads (its own, the pair
under each window) and its left and right sites from the neighbour lanes
or, in lanes 0 and 31, their own loads; where each element comes from
(the state in range, the state at the wrapped index, or at odd N the seam
snapshot), the
kernels' byte and float shift networks, the Philox units a lane draws and
the words or uniforms it picks, the per-element path at a replica's ends
and the stores.  Every colour site must be stored once, by the lane that
holds it; every neighbour a site reads must be the pre-phase value of the
index the plain version reads; and the phase computed through the windows
must equal ``ising_phase_plain`` and ``xy_phase_plain`` bitwise, and the
TPU rules restated in tests/test_torch_helical_pallas.py (Ising bitwise,
XY but for its accept-borderline sites, that file's tolerance).  The sums
taken through the tiles (the fused ones at even N, the odd-N pass, the XY
measure mode) must equal the plain sums: exactly (Ising), or to float64
rounding (XY: the kernel adds in another order).

Shapes (R, ny, nx): 33x32 and 65x64 (even N), 33x31 (odd N), (3, 30, 35)
and (5, 31, 35) (replica bases not 16-B aligned), (2, 2, 3) (N below one
vector); state pointers at an aligned address and 3 bytes (Ising) or one
float (XY) past one, and XY planes at differing offsets (every float
alone).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_helical_pallas import (
    KBT,
    KBT_XY,
    MARGIN_RULE,
    _assert_equal_but_borderline,
    _jax_ising_rule,
    _jax_xy_rule,
)

from cuda_fortran_mc_simulation_spin_tpu_torch.core import rng
from cuda_fortran_mc_simulation_spin_tpu_torch.models.xy2d import (
    metropolis_update,
)
from cuda_fortran_mc_simulation_spin_tpu_torch.ops import helical_pallas as hp

T = hp.THREADS
V = hp.VEC_BYTES
LANES = np.arange(T)
LAST = LANES % 32 == 31
FIRST = LANES % 32 == 0
# the restated TPU Ising rule, jitted (one compile a shape; integers, so
# XLA's fusion changes nothing; the XY rule runs op by op as that file
# runs it, its tolerance being for that)
_ising_rule = jax.jit(_jax_ising_rule, static_argnums=(1, 3, 4))
SHAPES = [(3, 32, 33), (3, 64, 65), (3, 31, 33), (3, 30, 35), (5, 31, 35),
          (2, 2, 3)]


# ---------------------------------------------------------------------------
# the walk and the shift networks
# ---------------------------------------------------------------------------

def _walk(blocks: int, nrep: int, tpr: int) -> list:
    """The Ising tiles (r, ts) the cooperative grid's blocks visit: block
    b from (b // tpr, b % tpr) (one division), then ``blocks`` tiles on,
    stepped as the kernel steps them (step_r, step_s = divmod(blocks,
    tpr), no division)."""
    step_r, step_s = divmod(blocks, tpr)
    seen = []
    for b in range(blocks):
        r, ts = divmod(b, tpr)
        while r < nrep:
            seen.append((r, ts))
            ts += step_s
            r += step_r
            if ts >= tpr:
                ts -= tpr
                r += 1
    return seen


@pytest.mark.parametrize("nrep,tpr", [(1, 245), (128, 245), (16, 245),
                                      (4, 3907), (3, 1), (2, 1), (5, 2)])
def test_tile_walk_visits_every_tile_once(nrep, tpr):
    for blocks in {1, 7, 132, 528, 1056, nrep * tpr}:
        blocks = min(blocks, nrep * tpr)
        seen = _walk(blocks, nrep, tpr)
        assert sorted(seen) == [(r, ts) for r in range(nrep)
                                for ts in range(tpr)]


def _window16(lo: np.ndarray, hi: np.ndarray, sh: int) -> np.ndarray:
    """csrc window16: bytes sh .. sh + 15 of the 32 bytes lo, hi (uint8,
    (..., 16) each) by the kernel's two word selects and funnel shift."""
    p = np.concatenate([lo, hi], axis=-1).copy().view("<u4").astype(
        np.uint64)
    t = p[..., 2:8] if sh & 8 else p[..., 0:6]
    u = t[..., 1:6] if sh & 4 else t[..., 0:5]
    out = ((u[..., 1:5] << np.uint64(32)) | u[..., 0:4]) >> np.uint64(
        8 * (sh & 3))
    return (out & np.uint64(0xFFFFFFFF)).astype("<u4").view(np.uint8)


def _window4(lo: np.ndarray, hi: np.ndarray, sh: int) -> np.ndarray:
    """csrc window4: elements sh .. sh + 3 of the pair (..., 4) each."""
    p = np.concatenate([lo, hi], axis=-1)
    t = p[..., 2:8] if sh & 2 else p[..., 0:6]
    return t[..., 1:5] if sh & 1 else t[..., 0:4]


def test_window_networks_select_their_elements():
    lo, hi = np.arange(16, dtype=np.uint8), np.arange(16, 32, dtype=np.uint8)
    for sh in range(16):
        np.testing.assert_array_equal(_window16(lo, hi, sh),
                                      np.arange(sh, sh + 16))
    for sh in range(4):
        np.testing.assert_array_equal(
            _window4(np.arange(4), np.arange(4, 8), sh), np.arange(sh, sh + 4))


def test_tile_constants():
    """tpr and nblk are the tiles the longest replica's vectors fill,
    brute-forced."""
    for nrep, ny, nx in SHAPES + [(128, 1000, 1001), (16, 1001, 1001),
                                  (1, 10000, 10001), (2, 4001, 4001)]:
        n = ny * nx
        for off in range(16):
            g = hp.ising_tiles(nrep, n, nx, off)
            most = max((off + r * n + n - 1) // V - (off + r * n) // V + 1
                       for r in range(nrep))
            assert g["tpr"] == -(-most // T)
            assert (g["ou"] + nx) % V == 0 and (g["od"] - nx) % V == 0
        for offs in ((0, 0, 0, 0), (4, 4, 4, 4), (12, 12, 12, 12),
                     (0, 4, 0, 0)):
            g = hp.xy_tiles(nrep, n, nx, offs, measuring=nrep % 2 == 1)
            o = g["off0"]
            most = max((o + r * n + n - 1) // 4 - (o + r * n) // 4 + 1
                       for r in range(nrep))
            assert g["nblk"] == -(-most // (T * g["vpt"]))
            assert g["vec"] == int(len(set(offs)) == 1)


# ---------------------------------------------------------------------------
# the Ising tiles
# ---------------------------------------------------------------------------

def _fetch(state: np.ndarray, seam, u: np.ndarray):
    """Elements of one replica at unwrapped sites u as the kernel reads
    them (a vector in range, else element by element): (values, source,
    index); source 0 the state in range, 1 the state at the wrapped index
    u mod N, 2 the snapshot (at odd N in a phase, a wrapped site of row 0
    or ny-1)."""
    n = state.shape[-1]
    j = u % n
    wrapped = (u < 0) | (u >= n)
    vals = state[j]
    src = wrapped.astype(np.int64)
    if seam is not None:
        nx = seam.shape[-1] // 2
        snap = wrapped & ((j < nx) | (j >= n - nx))
        at = np.clip(np.where(j < nx, j, j - (n - 2 * nx)), 0, 2 * nx - 1)
        vals = np.where(snap, seam[at], vals)
        src = np.where(snap, 2, src)
    return vals, src, j


def _stage_ising(state, seam, a0: int, last: int, nx: int, g: dict,
                 up: bool = True):
    """csrc stage_tile: a tile's staged vectors as (values, sources,
    indices, staged), own (T + 2, 16) with own[k] the tile's vector k - 1,
    up and dn (T + 1, 16) the aligned vectors under lane k's windows; a
    lane stages its three while it is at most one past the replica's last
    vector (``last``, tile-relative), threads 0-3 the vector before the
    tile and, where its last lane holds one of the replica, the three
    after it."""
    k = np.arange(T + 1)
    lanes = k[:T] <= last + 1
    own_ok = np.concatenate([[last >= 0], lanes, [last >= T - 1]])
    win_ok = np.concatenate([lanes, [last >= T - 1]])
    out = {"own": _fetch(state, seam, a0 - V + V * np.arange(T + 2)[:, None]
                         + np.arange(V)) + (own_ok,)}
    for name, first, on in (("up", a0 - nx - g["ou"], up),
                            ("dn", a0 + nx - g["od"], True)):
        if on:
            out[name] = _fetch(state, seam, first + V * k[:, None]
                               + np.arange(V)) + (win_ok,)
    return out


def _lane_reads(stage: dict, use: np.ndarray):
    """The lanes' reads of their staged windows, as csrc ising_tile makes
    them: own[t + 1], the top byte of own[t] (left), the low byte of
    own[t + 2] (right), the pairs up[t], up[t + 1] and dn[t], dn[t + 1];
    every one read by a lane in ``use`` was staged."""
    ov, osrc, oidx, ook = stage["own"]
    assert ook[:T][use].all() and ook[1:T + 1][use].all() \
        and ook[2:][use].all()
    res = {"own": (ov[1:T + 1], osrc[1:T + 1], oidx[1:T + 1]),
           "left": tuple(q[:T, V - 1] for q in (ov, osrc, oidx)),
           "right": tuple(q[2:, 0] for q in (ov, osrc, oidx))}
    for name in ("up", "dn"):
        if name in stage:
            vals, src, idx, ok = stage[name]
            assert ok[:T][use].all() and ok[1:][use].all()
            res[name] = tuple(np.concatenate([q[:T], q[1:]], axis=1)
                              for q in (vals, src, idx))
    return res


def _philox(r: int, units: np.ndarray, key) -> np.ndarray:
    ctr = torch.zeros(units.shape + (4,), dtype=torch.int64)
    ctr[..., 0] = r
    ctr[..., 1] = torch.from_numpy(units.astype(np.int64)) & 0xFFFFFFFF
    return rng.philox4x32(ctr, torch.as_tensor(key, dtype=torch.int64)
                          ).numpy()


def _check_reads(src, idx, want_idx, odd_phase: bool, use):
    """The used neighbours (``use``) read the plain version's indices, and
    at odd N in a phase a wrapped one reads the snapshot."""
    assert (idx[use] == want_idx[use]).all()
    if odd_phase:
        assert (src[use] != 1).all()


def _ising_tiles_phase(x: np.ndarray, color: int, nx: int, beta: float,
                       offset: int, key=None, bits=None):
    """One Ising phase of (R, N) int8 states through the kernel's tiles:
    (new states, stores per site, (R, 2) fused sums of colour 1)."""
    nrep, n = x.shape
    g = hp.ising_tiles(nrep, n, nx, offset)
    t4, t8 = hp.accept_thresholds_u32(beta)
    mc = hp.colour_sites(n, color)
    odd = n % 2 == 1
    new = x.copy()
    stores = np.zeros((nrep, n), np.int64)
    sums = np.zeros((nrep, 2), np.int64)
    for r in range(nrep):
        st = x[r]
        seam = np.concatenate([st[:nx], st[n - nx:]]) if odd else None
        rb = g["off0"] + r * n
        vl = (rb + n - 1) // V
        for ts in range(g["tpr"]):
            v = rb // V + T * ts + np.arange(T)
            warp = np.repeat(v[::32] <= vl, 32)
            valid = v <= vl
            a = V * v - rb
            reads = _lane_reads(
                _stage_ising(st, seam, int(a[0]), vl - int(v[0]), nx, g),
                valid)
            (own, osrc, oidx), left, right = (reads[k] for k in
                                              ("own", "left", "right"))
            up, usrc, uidx = reads["up"]
            dn, dsrc, didx = reads["dn"]
            # the networks, on the bytes and on their pair positions
            sel_u = _window16(np.arange(16, dtype=np.uint8),
                              np.arange(16, 32, dtype=np.uint8), g["ou"])
            sel_d = _window16(np.arange(16, dtype=np.uint8),
                              np.arange(16, 32, dtype=np.uint8), g["od"])
            u8 = up.astype(np.int8).view(np.uint8)
            d8 = dn.astype(np.int8).view(np.uint8)
            np.testing.assert_array_equal(
                _window16(u8[:, :16], u8[:, 16:], g["ou"]), u8[:, sel_u])
            np.testing.assert_array_equal(
                _window16(d8[:, :16], d8[:, 16:], g["od"]), d8[:, sel_d])
            lv = np.concatenate([left[0][:, None], own[:, :15]], axis=1)
            rv = np.concatenate([own[:, 1:], right[0][:, None]], axis=1)
            ls = np.concatenate([left[1][:, None], osrc[:, :15]], axis=1)
            rs = np.concatenate([osrc[:, 1:], right[1][:, None]], axis=1)
            li = np.concatenate([left[2][:, None], oidx[:, :15]], axis=1)
            ri = np.concatenate([oidx[:, 1:], right[2][:, None]], axis=1)
            nsum = (up[:, sel_u].astype(np.int64) + dn[:, sel_d]) + (
                lv.astype(np.int64) + rv)
            # colour c's sites: bytes p0 + 2i, colour sites k0 + i
            p0 = (color - a) & 1
            k0 = (a + p0 - color) >> 1
            om = k0 & 3
            assert (p0 == p0[0]).all() and (om == om[0]).all()
            p0, om = int(p0[0]), int(om[0])
            ks = k0[:, None] + np.arange(8)
            if bits is None:
                u0 = k0 >> 2
                w0, w1 = _philox(r, u0, key), _philox(r, u0 + 1, key)
                w2 = np.zeros_like(w0)
                if om:
                    w2 = np.where(LAST[:, None],
                                  _philox(r, u0 + 2, key),
                                  np.roll(w0, -1, axis=0))
                w = np.concatenate([w0, w1, w2], axis=1)
                t = w[:, 2:11] if om & 2 else w[:, 0:9]
                wd = t[:, 1:9] if om & 1 else t[:, 0:8]
                want = hp.draw_words(key, nrep, hp.colour_sites(n, 0))[r]
                inc = (ks >= 0) & (ks < mc)
                assert (wd[inc] == want.numpy()[ks[inc]]).all()
            else:
                inc = (ks >= 0) & (ks < mc)
                wd = np.where(inc, bits[r][np.clip(ks, 0, mc - 1)], 0)
            pos = p0 + 2 * np.arange(8)
            idx = a[:, None] + pos
            live = warp[:, None] & valid[:, None] & (idx >= 0) & (idx < n)
            for src, ind, off, sel in ((usrc, uidx, -nx, sel_u),
                                       (dsrc, didx, nx, sel_d)):
                _check_reads(src[:, sel][:, pos], ind[:, sel][:, pos],
                             (idx + off) % n, odd, live)
            _check_reads(ls[:, pos], li[:, pos], (idx - 1) % n, odd, live)
            _check_reads(rs[:, pos], ri[:, pos], (idx + 1) % n, odd, live)
            s = own[:, pos].astype(np.int64)
            kk = s * nsum[:, pos]
            acc = (kk <= 0) | (wd < np.where(kk == 2, t4, t8))
            out = np.where(acc & live, -s, s)
            new[r, idx[live]] = out[live]
            np.add.at(stores[r], idx[live], 1)
            if color == 1 and not odd:
                vb = warp[:, None] & valid[:, None] & (oidx == (
                    a[:, None] + np.arange(V))) & (osrc == 0)
                full = own.astype(np.int64).copy()
                full[:, pos] = out
                sums[r, 0] += full[vb].sum()
                sums[r, 1] -= (out * nsum[:, pos])[live].sum()
    return new, stores, sums


def _ising_tiles_measure(x: np.ndarray, nx: int, offset: int) -> np.ndarray:
    """The odd-N pass's (m, e) of (R, N) states through the tiles: the own
    vector, the right byte and the down window, all from the state."""
    nrep, n = x.shape
    g = hp.ising_tiles(nrep, n, nx, offset)
    sums = np.zeros((nrep, 2), np.int64)
    for r in range(nrep):
        st = x[r]
        rb = g["off0"] + r * n
        vl = (rb + n - 1) // V
        for ts in range(g["tpr"]):
            v = rb // V + T * ts + np.arange(T)
            a = V * v - rb
            reads = _lane_reads(_stage_ising(st, None, int(a[0]),
                                             vl - int(v[0]), nx, g,
                                             up=False), v <= vl)
            own, right = reads["own"][0], reads["right"]
            dn, _, didx = reads["dn"]
            sel = np.arange(g["od"], g["od"] + V)
            rv = np.concatenate([own[:, 1:], right[0][:, None]], axis=1)
            idx = a[:, None] + np.arange(V)
            live = (v <= vl)[:, None] & (idx >= 0) & (idx < n)
            assert (didx[:, sel][live] == ((idx + nx) % n)[live]).all()
            s = own.astype(np.int64)
            sums[r, 0] += s[live].sum()
            sums[r, 1] -= (s * (rv.astype(np.int64) + dn[:, sel]))[live].sum()
    return sums


@pytest.mark.parametrize("offset", [0, 3])
@pytest.mark.parametrize("color", [0, 1])
@pytest.mark.parametrize("nrep,ny,nx", SHAPES)
def test_ising_phase_through_the_tiles(nrep, ny, nx, color, offset):
    n = ny * nx
    g = np.random.default_rng(7 * n + nrep + color)
    x = (g.integers(0, 2, size=(nrep, n)) * 2 - 1).astype(np.int8)
    key = rng.seeds_from_key(rng.base_key(n + color), color)
    bits = g.integers(0, 2 ** 32, size=(nrep, hp.colour_sites(n, 0)),
                      dtype=np.uint64).astype(np.int64)
    beta = 1 / KBT
    for kw, words in ((dict(key=key), hp.draw_words(key, nrep,
                                                    hp.colour_sites(n, 0))),
                      (dict(bits=bits), torch.from_numpy(bits))):
        new, stores, sums = _ising_tiles_phase(x, color, nx, beta, offset,
                                               **kw)
        want = hp.ising_phase_plain(torch.from_numpy(x), words, color=color,
                                    nx=nx, beta=beta).numpy()
        np.testing.assert_array_equal(new, want)
        mask = hp.colour_mask(n, color).numpy()
        assert (stores[:, mask] == 1).all() and (stores[:, ~mask] == 0).all()
        rule, _ = _ising_rule(
            jnp.asarray(x.astype(np.int32)), color,
            jnp.asarray(hp.spread(words, n, color).numpy().astype(np.uint32)),
            beta, nx)
        np.testing.assert_array_equal(new, np.asarray(rule))
        exact = hp.ising_sums(torch.from_numpy(new), nx).numpy()
        if color == 1 and n % 2 == 0:
            np.testing.assert_array_equal(sums, exact)
        if n % 2:
            np.testing.assert_array_equal(_ising_tiles_measure(new, nx,
                                                               offset), exact)


# ---------------------------------------------------------------------------
# the XY tiles
# ---------------------------------------------------------------------------

def _pair(state, seam, first: np.ndarray, width: int):
    """An XY lane's window pair: the aligned vectors at ``first`` and the
    next; (values, sources, indices), (T, 2 width) each."""
    return _fetch(state, seam, first[:, None] + np.arange(2 * width))


def _neighbours(state, seam, a: np.ndarray, width: int):
    """An XY lane's own vector and its left and right sites: the
    neighbour lanes' last and first, lanes 0 and 31 their own loads."""
    own = _fetch(state, seam, a[:, None] + np.arange(width))
    left = _fetch(state, seam, np.where(FIRST, a - 1,
                                        np.roll(a + width - 1, 1)))
    right = _fetch(state, seam, np.where(LAST, a + width, np.roll(a, -1)))
    assert (left[2] == (a - 1) % state.shape[-1]).all()
    assert (right[2] == (a + width) % state.shape[-1]).all()
    return own, left, right


def _u24(w: np.ndarray) -> np.ndarray:
    return rng.bits_to_uniform(torch.from_numpy(w.astype(np.int64))).numpy()


def _xy_tiles_phase(sx: np.ndarray, sy: np.ndarray, color: int, nx: int,
                    beta: float, offsets, rand, mode: str):
    """One XY launch through the kernel's blocks (each thread vpt
    vectors, THREADS apart): mode "phase" the (4, R, N) fields (hx, hy)
    and uniforms (u_cand, u_acc) the colour sites read and the stores per
    site; mode "measure" the (R, 3) sums of sx, sy before the minus of
    e."""
    nrep, n = sx.shape
    g = hp.xy_tiles(nrep, n, nx, offsets, measuring=mode != "phase")
    W = V // 4
    fields = np.zeros((4, nrep, n), np.float32)   # hx, hy, uc, ua
    stores = np.zeros((nrep, n), np.int64)
    sums = np.zeros((nrep, 3))
    for r in range(nrep):
        px, py = sx[r], sy[r]
        rb = g["off0"] + r * n
        vl = (rb + n - 1) // W
        for bx, j in np.ndindex(g["nblk"], g["vpt"]):
            v = rb // W + T * (bx * g["vpt"] + j) + LANES
            warp = np.repeat(v[::32] <= vl, 32)
            if not warp.any():
                continue
            valid = v <= vl
            a = W * v - rb
            idx = a[:, None] + np.arange(W)
            live = (warp & valid)[:, None] & (idx >= 0) & (idx < n)
            (ox, _, oi), lx, rx = _neighbours(px, None, a, W)
            (oy, _, _), ly, ry = _neighbours(py, None, a, W)
            assert (oi[live] == idx[live]).all()
            dxp, _, dxi = _pair(px, None, a + nx - g["sd"], W)
            dyp = _pair(py, None, a + nx - g["sd"], W)[0]
            dx = _window4(dxp[:, :W], dxp[:, W:], g["sd"])
            dy = _window4(dyp[:, :W], dyp[:, W:], g["sd"])
            dsel = _window4(np.arange(W), np.arange(W, 2 * W), g["sd"])
            assert (dxi[:, dsel][live] == ((idx + nx) % n)[live]).all()
            rvx = np.concatenate([ox[:, 1:], rx[0][:, None]], axis=1)
            rvy = np.concatenate([oy[:, 1:], ry[0][:, None]], axis=1)
            if mode == "measure":
                f64 = np.float64
                sums[r, 0] += ox[live].astype(f64).sum()
                sums[r, 1] += oy[live].astype(f64).sum()
                sums[r, 2] += (ox.astype(f64) * (rvx.astype(f64) + dx) + oy
                               * (rvy.astype(f64) + dy))[live].sum()
                continue
            uxp, _, uxi = _pair(px, None, a - nx - g["su"], W)
            uyp = _pair(py, None, a - nx - g["su"], W)[0]
            ux = _window4(uxp[:, :W], uxp[:, W:], g["su"])
            uy = _window4(uyp[:, :W], uyp[:, W:], g["su"])
            usel = _window4(np.arange(W), np.arange(W, 2 * W), g["su"])
            assert (uxi[:, usel][live] == ((idx - nx) % n)[live]).all()
            lvx = np.concatenate([lx[0][:, None], ox[:, :3]], axis=1)
            lvy = np.concatenate([ly[0][:, None], oy[:, :3]], axis=1)
            hx = ((ux + dx) + lvx) + rvx
            hy = ((uy + dy) + lvy) + rvy
            # the vector's colour sites a + i0, a + i0 + 2: colour sites
            # ka, ka + 1 of units ka >> 1 (and the next where ka is odd)
            i0 = (color - a) & 1
            ka = (a + i0 - color) >> 1
            assert (i0 == i0[0]).all() and ((ka & 1) == (ka[0] & 1)).all()
            if isinstance(rand, tuple):
                m0 = hp.colour_sites(n, 0)
                kq = np.clip(ka[:, None] + np.arange(2), 0, m0 - 1)
                uc, ua = (u.numpy()[r][kq] for u in rand)
            else:
                w0 = _philox(r, ka >> 1, rand)
                if ka[0] & 1 == 0:
                    q = w0
                else:
                    w1 = _philox(r, (ka >> 1) + 1, rand)
                    q = np.concatenate([w0[:, 2:], w1[:, :2]], axis=1)
                uc, ua = _u24(q[:, 0::2]), _u24(q[:, 1::2])
            site = live & ((idx & 1) == color)
            for k, f in enumerate((hx, hy, uc[:, [0, 0, 1, 1]],
                                   ua[:, [0, 0, 1, 1]])):
                fields[k, r, idx[site]] = f[site]
            np.add.at(stores[r], idx[live], 1)
    return fields, stores, sums


@pytest.mark.parametrize("offsets", [(0, 0, 0, 0), (4, 4, 4, 4),
                                     (0, 4, 8, 0)])
@pytest.mark.parametrize("color", [0, 1])
@pytest.mark.parametrize("nrep,ny,nx", SHAPES)
def test_xy_phase_through_the_tiles(nrep, ny, nx, color, offsets):
    n = ny * nx
    g = np.random.default_rng(11 * n + nrep + color)
    th = g.uniform(0, 2 * np.pi, size=(nrep, n))
    sx, sy = np.cos(th).astype(np.float32), np.sin(th).astype(np.float32)
    beta = 1 / KBT_XY
    m0 = hp.colour_sites(n, 0)
    key = rng.seeds_from_key(rng.base_key(n + 5), color)
    inj = tuple(rng.bits_to_uniform(torch.from_numpy(
        g.integers(0, 2 ** 32, size=(nrep, m0), dtype=np.uint64)
        .astype(np.int64))) for _ in range(2))
    tx, ty = torch.from_numpy(sx), torch.from_numpy(sy)
    mask = hp.colour_mask(n, color)
    for rand in (key, inj):
        fields, stores, _ = _xy_tiles_phase(sx, sy, color, nx, beta,
                                            offsets, rand, "phase")
        assert (stores == 1).all()
        hx, hy, uc, ua = (torch.from_numpy(f) for f in fields)
        np.testing.assert_array_equal(hx[:, mask], hp.field(tx, nx)[:, mask])
        np.testing.assert_array_equal(hy[:, mask], hp.field(ty, nx)[:, mask])
        # the plain version's update over the whole planes, the fields
        # and uniforms those of the tiles
        fx, fy = metropolis_update(tx, ty, hx, hy, uc, ua, beta)
        got = (torch.where(mask, fx, tx), torch.where(mask, fy, ty))
        want = hp.xy_phase_plain(tx, ty, rand, color=color, nx=nx, beta=beta)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
        u_all = (rand if isinstance(rand, tuple)
                 else hp.draw_uniforms(rand, nrep, m0))
        np.testing.assert_array_equal(
            uc[:, mask].numpy(),
            u_all[0][:, :hp.colour_sites(n, color)].numpy())
        if rand is not key:
            continue
        ju = [jnp.asarray(hp.spread(u, n, color).numpy()) for u in u_all]
        wx, wy, p = _jax_xy_rule(jnp.asarray(sx), jnp.asarray(sy), color,
                                 *ju, beta, nx)
        for a, b in zip(got, (wx, wy)):
            _assert_equal_but_borderline(a.numpy(), np.asarray(b), ju[1], p,
                                         MARGIN_RULE)
    _, _, sums = _xy_tiles_phase(sx, sy, color, nx, beta, offsets[:2], None,
                                 "measure")
    sums[:, 2] = -sums[:, 2]
    want = hp.xy_sums(tx, ty, nx).numpy()
    scale = np.maximum(np.abs(want), n)
    assert (np.abs(sums - want) / scale).max() <= 1e-12
