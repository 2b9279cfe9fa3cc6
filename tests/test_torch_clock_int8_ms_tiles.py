"""The int8 clock multisweep kernel's tiles, replayed on the CPU.

``csrc/clock_multisweep.cu`` ``multisweep_kernel`` runs S sweeps (phase a,
then phase b) of (R, ny, half) int8 clock states in one cooperative
launch, each phase in tiles of whole rows of one replica (chunks of a row
past ``c8ms.CHUNK_COLS`` columns), from the constants the wrapper passes
(``c8ms.ms_tiles``).  These tests walk that launch in numpy, tile by tile
and thread by thread, from the same constants: the grid's walk over the
tiles by carries (no division), the four byte ranges a tile stages (its
sites, the other colour's rows y0 .. widened a column each side in a
chunk, and the rows before and after it, wrapped), copied into a
shared-memory image from the 16-B aligned vectors that cover them at the
tensors' real byte offsets; the four-byte windows each word of four sites
reads from that image (two aligned words and a funnel shift), the row's
wrap patched into the side window; the two Philox calls of each word
under the phase's round keys; the site rule on the staged (cos, sin)
table; the stores into the image and the write-back in aligned vectors
and ragged bytes; and phase b's fused float64 terms, a partial a tile.

Every site must be stored exactly once a phase, by the tile holding it,
and no byte outside the tiles' ranges (or the tensor) written; every
neighbour a site reads must be the pre-phase value at the index the plain
version reads; S >= 3 sweeps through the replayed words must equal
``c8ms.multisweep_plain`` and S pairs of plain phases bitwise, and the
sums, taken over the tiles' partials, equal the plain fused sums to
float64 rounding (1e-12 of their scale).  The kernel's own refusal of bad
constants is ``c8ms.check_ms_tiles``'s, which the wrapper calls first.

Shapes (R, ny, half): (2, 12, 5) (an odd half, rows off the 4-byte grid, a
masked last word and a half unit), (1, 33, 500) (the resident class's
rows, 4-byte but not 16-byte aligned; one replica: tiles of 2 rows, 128
threads a row, and a last band of one row), (1, 4, 4102) (chunks, a
masked last word); q = 2, 5, 6 and 127; tensors at an aligned address and
3 bytes past one.  Beside them the resident class's own tiles (32 rows, 32
threads a row, 1000^2 x 16) replayed on (1, 70, 500): two whole tiles and
a band of 6 rows.
"""

import numpy as np
import pytest
import torch
from test_torch_ising3d_int8_tiles import (
    Tensor,
    _funnel,
    philox_rk,
    round_keys,
)

from cuda_fortran_mc_simulation_spin_tpu_torch.core import rng
from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
    clock_multisweep as c8ms,
)
from cuda_fortran_mc_simulation_spin_tpu_torch.ops import clock_pallas as c8p
from cuda_fortran_mc_simulation_spin_tpu_torch.ops import multispin_rng

KBT = 0.91
SHAPES = [(2, 12, 5), (1, 33, 500), (1, 4, 4102)]
QS = [2, 5, 6, 127]
SWEEPS = 3
M32 = 0xFFFFFFFF


def walk(blocks: int, nrep: int, nty: int, nch: int) -> list:
    """The tiles (r, yt, cx) the cooperative grid's blocks visit: block b
    from its index (three divisions once a launch), then ``blocks`` tiles
    on by the carries of (step_r, step_y, step_c), as the kernel steps."""
    per = nty * nch
    step_r, rest = divmod(blocks, per)
    step_y, step_c = divmod(rest, nch)
    seen = []
    for b in range(blocks):
        r, rest = divmod(b, per)
        yt, cx = divmod(rest, nch)
        while r < nrep:
            seen.append((b, r, yt, cx))
            cx += step_c
            if cx >= nch:
                cx -= nch
                yt += 1
            yt += step_y
            if yt >= nty:
                yt -= nty
                r += 1
            r += step_r
    return seen


@pytest.mark.parametrize("nrep,nty,nch", [(16, 63, 1), (1, 3, 1),
                                          (2, 4, 2), (5, 1, 3), (3, 7, 1)])
def test_walk_visits_every_tile_once(nrep, nty, nch):
    for blocks in {1, 2, 7, 132, 528, 1056, nrep * nty * nch}:
        blocks = min(blocks, nrep * nty * nch)
        seen = sorted(t[1:] for t in walk(blocks, nrep, nty, nch))
        assert seen == [(r, y, c) for r in range(nrep) for y in range(nty)
                        for c in range(nch)]


def _tables(q: int):
    """The staged (cos, sin) tables: float32 for the update, float64 for
    the sums, (2, 128) each, zero past q."""
    return (c8p.table_rows(q).numpy(),
            c8p.table_rows(q, torch.float64).numpy())


def replay_phase(xt: Tensor, ot: Tensor, shape, rk, *, color: int, q: int,
                 beta: float, measuring: bool, gen, blocks: int = 5,
                 tiles=None):
    """One colour phase of the launch on the tensors' bytes: xt updated in
    place, with the constants ``tiles`` (else ms_tiles').  Returns the (R,
    nty nch, 3) tile partials (phase b) and the neighbours each site read,
    (5, R, ny, half) (up, down, centre, side, own)."""
    nrep, ny, half = shape
    t = tiles or c8ms.ms_tiles(nrep, ny, half)
    c8ms.check_ms_tiles(t, ny, half)
    rows, lux, cw, nch, nty = (t[k] for k in ("rows", "lux", "cw", "nch",
                                              "nty"))
    buf, ux = t["buf"], 1 << lux
    tr = c8ms.THREADS >> lux
    assert rows % tr == 0 and t["smem"] <= 48 * 1024
    tab, tab64 = _tables(q)
    qm1 = np.float32(q - 1)
    neg_beta = np.float32(-beta)
    plane = ny * half
    pre = xt.mem.copy()
    o_flat = ot.mem[ot.off:ot.off + ot.n]
    writes = np.zeros(xt.mem.size, np.int64)
    owner = np.full(xt.mem.size, -1, np.int64)
    read = np.full((5,) + tuple(shape), -1, np.int64)
    partials = np.zeros((nrep, nty * nch, 3))
    for _, r, yt, cx in walk(min(blocks, nrep * nty * nch), nrep, nty, nch):
        c0 = cx * cw
        ncw = min(cw, half - c0)
        clo, chi = (c0 - 1 if c0 > 0 else 0), min(c0 + ncw + 1, half)
        y0 = yt * rows
        nr = min(rows, ny - y0)
        lx = (nr - 1) * half + ncw
        lc = (nr - 1) * half + chi - clo
        yu, yd = (y0 - 1) % ny, (y0 + nr) % ny
        base = r * plane
        # (tensor, first byte, length) of the four ranges
        spans = [(xt, base + y0 * half + c0, lx),
                 (ot, base + y0 * half + clo, lc),
                 (ot, base + yu * half + c0, ncw),
                 (ot, base + yd * half + c0, ncw)]
        sm = gen.integers(0, 256, t["smem"], dtype=np.uint8)
        sh = []
        ends = [*(b - 16 for b in buf[1:]), t["smem"]]
        for (ten, start, ln), b, end in zip(spans, buf, ends):
            s = (ten.off + start) % 16
            nv = (s + ln + 15) // 16
            # the vectors, and the 8 bytes past them a window's second
            # word may reach, fit their room
            assert b + 16 * nv + 8 <= end
            sm[b:b + 16 * nv] = ten.vectors(start - s, nv)
            sh.append(s)
        shx, shc, shu, shd = sh
        # the own range was staged at its pre-phase values
        a0 = xt.off + base + y0 * half + c0
        assert (xt.mem[a0:a0 + lx] == pre[a0:a0 + lx]).all()
        # thread (ty, tx) takes words tx, tx + ux, ... of rows ty, ty +
        # tr, ...: every word of the tile once
        ty, j = np.meshgrid(np.arange(nr), np.arange(-(-ncw // 4)),
                            indexing="ij")
        ty, j = ty.ravel(), j.ravel()
        tid = ((ty % tr) << lux) | (j % ux)
        assert len(set(zip(tid, ty // tr, j // ux))) == len(tid)
        assert tid.max() < c8ms.THREADS
        y = y0 + ty
        cg = c0 + 4 * j
        nv = np.minimum(4, c0 + ncw - cg)
        d = np.where((color == 0) == ((y & 1) == 1), 1, -1)
        row = ty * half
        px = buf[0] + shx + row
        pc = buf[1] + shc + row + (c0 - clo) - (d < 0)
        pu = np.where(ty == 0, buf[2] + shu,
                      buf[1] + shc + row - half + (c0 - clo))
        pd = np.where(ty == nr - 1, buf[3] + shd,
                      buf[1] + shc + row + half + (c0 - clo))
        sw = sm.view("<u4").astype(np.uint64)

        def words(p):
            k = (p >> 2) + j
            return sw[k], sw[k + 1], 8 * (p & 3)

        def win(p):
            lo, hi, s = words(p)
            return _funnel(lo, hi, s)

        xv, uv, dv = win(px), win(pu), win(pd)
        lo, hi, sc = words(pc)
        lower = _funnel(lo, hi, sc)
        upper = _funnel(lo, hi, sc + 8, clamp=True)
        orow = base + y * half
        fix_r = (d > 0) & (cg + 3 >= half - 1)
        fix_l = (d < 0) & (cg == 0)
        for i in np.flatnonzero(fix_r):
            kb = half - 1 - cg[i]
            assert 0 <= kb < 4
            w = int(upper[i]) & ~(0xFF << (8 * kb))
            upper[i] = w | (int(o_flat[orow[i]]) << (8 * kb))
        for i in np.flatnonzero(fix_l):
            lower[i] = (int(lower[i]) & ~0xFF) | int(o_flat[orow[i]
                                                            + half - 1])
        cv = np.where(d > 0, lower, upper)
        sv = np.where(d > 0, upper, lower)
        ctr = np.stack([np.full_like(y, r), y, cg >> 1, np.zeros_like(y)],
                       axis=-1).astype(np.uint64)
        w0 = philox_rk(ctr, rk)
        ctr[:, 2] += 1
        w1 = philox_rk(ctr, rk)
        ws = np.concatenate([w0, w1], axis=1)
        nxv = xv.copy()
        terms = np.zeros((len(j), 3))
        for k in range(4):
            ok = k < nv
            # the masked words' byte k (the kernel's __byte_perm)
            idx = [(((v & np.uint64(0x7F7F7F7F)) >> np.uint64(8 * k))
                    & np.uint64(0xFF)).astype(np.int64)
                   for v in (uv, dv, cv, sv, xv)]
            for n_, v in enumerate(idx):
                read[n_, r, y[ok], cg[ok] + k] = v[ok]
            ou, od, oc, os_, xk = idx
            hx = (tab[0][ou] + tab[0][od]) + (tab[0][oc] + tab[0][os_])
            hy = (tab[1][ou] + tab[1][od]) + (tab[1][oc] + tab[1][os_])
            uc = rng.bits_to_uniform(torch.from_numpy(
                ws[:, 2 * k].astype(np.int64))).numpy()
            ua = rng.bits_to_uniform(torch.from_numpy(
                ws[:, 2 * k + 1].astype(np.int64))).numpy()
            nw = xk + (uc * qm1).astype(np.int32) + 1
            nw = np.where(nw >= q, nw - q, nw)
            de = -((tab[0][nw] - tab[0][xk]) * hx
                   + (tab[1][nw] - tab[1][xk]) * hy)
            prob = torch.exp(torch.from_numpy(
                neg_beta * np.maximum(de, np.float32(0)))).numpy()
            out = np.where(ua < prob, nw, xk)
            keep = nxv & ~np.uint64(0xFF << (8 * k))
            nxv = np.where(ok, keep | (out.astype(np.uint64)
                                       << np.uint64(8 * k)), nxv)
            if measuring:
                go, gc = tab64[:, out], tab64[:, oc]
                gu, gd, gs = tab64[:, ou], tab64[:, od], tab64[:, os_]
                term = np.stack([
                    go[0] + gc[0], go[1] + gc[1],
                    go[0] * ((gu[0] + gd[0]) + (gc[0] + gs[0]))
                    + go[1] * ((gu[1] + gd[1]) + (gc[1] + gs[1]))], axis=1)
                terms += np.where(ok[:, None], term, 0.0)
        for k in range(4):
            ok = k < nv
            sm[px[ok] + 4 * j[ok] + k] = (
                (nxv[ok] >> np.uint64(8 * k)) & np.uint64(0xFF)).astype(
                    np.uint8)
        if measuring:
            partials[r, yt * nch + cx] = terms.sum(axis=0)
        # the write-back: whole vectors in the range, bytes at its ragged
        # ends
        a = xt.off + base + y0 * half + c0 - shx
        for v in range((shx + lx + 15) // 16):
            lo_b = 16 * v - shx
            for b in range(16):
                if 0 <= lo_b + b < lx:
                    writes[a + 16 * v + b] += 1
                    owner[a + 16 * v + b] = (r * nty + yt) * nch + cx
                    xt.mem[a + 16 * v + b] = sm[buf[0] + 16 * v + b]
    # every site written once a phase, by the tile holding it
    sites = np.zeros(xt.mem.size, bool)
    sites[xt.off:xt.off + xt.n] = True
    assert (writes[sites] == 1).all() and (writes[~sites] == 0).all()
    r_, y_, c_ = np.meshgrid(*(np.arange(n) for n in shape), indexing="ij")
    want = (r_ * nty + y_ // rows) * nch + c_ // cw
    assert np.array_equal(owner[sites].reshape(shape), want)
    return partials, read


def replay(a, b, seeds, *, q, beta, offsets=(0, 0), gen=None, blocks=5,
           tiles=None):
    """S = len(seeds) sweeps of the launch on numpy planes a, b (int8 (R,
    ny, half)) at byte offsets ``offsets`` mod 16.  Returns the new (a, b),
    the (R, S, 3) sums (e negated, as reduce_kernel writes it) and each
    phase's neighbour reads."""
    gen = gen or np.random.default_rng(0)
    at, bt = Tensor(a, offsets[0]), Tensor(b, offsets[1])
    obs, reads = [], []
    for s in range(seeds.shape[0]):
        for phase, (x, o) in enumerate(((at, bt), (bt, at))):
            pre = (x.mem[x.off:x.off + x.n].view(np.int8).reshape(a.shape)
                   .copy(), o.mem[o.off:o.off + o.n].view(np.int8)
                   .reshape(a.shape).copy())
            part, read = replay_phase(
                x, o, a.shape, round_keys(seeds[s, phase]), color=phase, q=q,
                beta=beta, measuring=phase == 1, gen=gen, blocks=blocks,
                tiles=tiles)
            reads.append((pre, read))
            if phase:
                tot = part.sum(axis=1)
                tot[:, 2] = -tot[:, 2]
                obs.append(tot)

    def planes(t):
        return t.mem[t.off:t.off + t.n].view(np.int8).reshape(a.shape).copy()

    return planes(at), planes(bt), np.stack(obs, axis=1), reads


def _plain_reads(x, o, color):
    """The five states the plain version reads at each site: up, down,
    centre, side (c + d, d = +1 iff colour 0 on an odd row or colour 1 on
    an even one) and the site's own, each masked to the table."""
    nrep, ny, half = o.shape
    y = np.arange(ny).reshape(1, -1, 1)
    d = np.where((color == 0) == ((y & 1) == 1), 1, -1)
    c = np.arange(half).reshape(1, 1, -1)
    side = np.take_along_axis(o, np.broadcast_to((c + d) % half, o.shape),
                              axis=2)
    return np.stack([np.roll(o, 1, axis=1), np.roll(o, -1, axis=1), o, side,
                     x]).astype(np.int64) & 127


def _states(shape, q, seed):
    g = np.random.default_rng(seed)
    return (g, g.integers(0, q, size=shape, dtype=np.int8),
            g.integers(0, q, size=shape, dtype=np.int8))


def test_tiles_cover_shapes():
    """The constants: whole-row tiles up to CHUNK_COLS columns, chunks past
    them; rows a multiple of THREADS / 2^lux; ranges in order, 16-B
    aligned, inside 48 KB; each accepted by check_ms_tiles."""
    t = c8ms.ms_tiles(16, 1000, 500)
    assert (t["rows"], t["lux"], t["cw"], t["nch"], t["nty"]) == (32, 5, 500,
                                                                  1, 32)
    # one replica: shorter tiles, then more threads a row, up to a thread
    # a word, for MIN_TILES tiles
    t = c8ms.ms_tiles(1, 1000, 500)
    assert (t["rows"], t["lux"], t["nty"]) == (2, 7, 500)
    t = c8ms.ms_tiles(4, 1000, 500)
    assert (t["rows"], t["lux"], t["nty"]) == (4, 6, 250)
    t = c8ms.ms_tiles(1, 4, 4102)
    assert (t["rows"], t["lux"], t["cw"], t["nch"]) == (1, 8, 4096, 2)
    for nrep, ny, half in ((1, 2, 1), (2, 12, 5), (1, 33, 500), (3, 7, 1024),
                           (1, 9, 1025), (2, 3, 4096), (1, 4, 9000),
                           (1, 2, 100003), (8, 2000, 1000), (1, 2000, 1000),
                           (64, 1000, 500)):
        t = c8ms.ms_tiles(nrep, ny, half)
        assert t["rows"] % (c8ms.THREADS >> t["lux"]) == 0
        assert t["nch"] * t["cw"] >= half and t["nty"] * t["rows"] >= ny
        # at most a thread a word of the row (rounded up to a power of 2)
        words = -(-min(t["cw"], half) // 4)
        assert t["lux"] <= max(c8ms.MIN_LUX, (words - 1).bit_length())
        assert all(b % 16 == 0 for b in t["buf"])
        assert list(t["buf"]) == sorted(t["buf"]) and t["smem"] <= 48 * 1024
        c8ms.check_ms_tiles(t, ny, half)
        assert list(c8ms._tiles_arg(nrep, ny, half)) == [
            t["rows"], t["lux"], t["cw"], t["nch"], t["nty"], *t["buf"],
            t["smem"]]


@pytest.mark.parametrize("field,change", [
    ("rows", lambda t: t["rows"] - 4), ("lux", lambda t: 1),
    ("lux", lambda t: 9), ("cw", lambda t: t["cw"] - 1),
    ("nch", lambda t: 2), ("nty", lambda t: t["nty"] - 1),
    ("nty", lambda t: t["nty"] + 1),
    ("buf", lambda t: (t["buf"][0], t["buf"][1] - 16, *t["buf"][2:])),
    ("buf", lambda t: (t["buf"][0] + 4, *t["buf"][1:])),
    ("smem", lambda t: t["smem"] - 16), ("smem", lambda t: 48 * 1024 + 1)])
def test_bad_constants_are_refused(field, change):
    """Constants the launch cannot run on, refused before a launch: rows
    not a multiple of a pass, lux outside 2 .. 8, columns or chunks not
    covering a row (or an empty chunk), row tiles too few or one empty,
    ranges overlapping or off the 16-B grid, shared memory short or past
    48 KB."""
    t = dict(c8ms.ms_tiles(16, 1000, 500))
    t[field] = change(t)
    with pytest.raises(ValueError, match="tiles"):
        c8ms.check_ms_tiles(t, 1000, 500)
    c8ms.check_ms_tiles(c8ms.ms_tiles(16, 1000, 500), 1000, 500)
    t = dict(c8ms.ms_tiles(1, 4, 4102), cw=4098)
    with pytest.raises(ValueError, match="tiles"):
        c8ms.check_ms_tiles(t, 4, 4102)


@pytest.mark.parametrize("offsets", [(0, 0), (3, 3)])
@pytest.mark.parametrize("q", QS)
@pytest.mark.parametrize("shape", SHAPES)
def test_replay_equals_plain_multisweep(shape, q, offsets):
    """S sweeps through the replayed tiles: every site stored once a
    phase, every neighbour read at its pre-phase value; the states equal
    multisweep_plain and S plain phase pairs bitwise, the sums the plain
    fused sums within 1e-12 of their scale."""
    g, a, b = _states(shape, q, 101 * q + sum(shape) + offsets[0])
    seeds = multispin_rng.sweep_phase_keys(
        rng.sample_key(rng.base_key(5), 2), SWEEPS, 7)
    beta = 1 / KBT
    na, nb, obs, reads = replay(a, b, seeds, q=q, beta=beta,
                                offsets=offsets, gen=g)
    for k, ((px, po), read) in enumerate(reads):
        np.testing.assert_array_equal(read, _plain_reads(px, po, k % 2))
    wa, wb, wobs = c8ms.multisweep_plain(torch.from_numpy(a.copy()),
                                         torch.from_numpy(b.copy()), seeds,
                                         q=q, beta=beta)
    np.testing.assert_array_equal(na, wa.numpy())
    np.testing.assert_array_equal(nb, wb.numpy())
    pa, pb = torch.from_numpy(a.copy()), torch.from_numpy(b.copy())
    for s in range(SWEEPS):
        pa = c8p.phase_plain(pa, pb, seeds[s, 0], color=0, q=q, beta=beta)
        pb = c8p.phase_plain(pb, pa, seeds[s, 1], color=1, q=q, beta=beta)
    np.testing.assert_array_equal(na, pa.numpy())
    np.testing.assert_array_equal(nb, pb.numpy())
    scale = 2 * shape[1] * shape[2]
    assert np.abs(obs - wobs.numpy()).max() <= 1e-12 * scale


@pytest.mark.parametrize("q", [2, 6])
def test_replay_on_the_class_tiles(q):
    """The resident class's tile shape (ms_tiles at 1000^2 x 16) on a
    shorter replica: the same checks as above."""
    shape = (1, 70, 500)
    t = dict(c8ms.ms_tiles(16, 1000, 500), nty=3)
    assert (t["rows"], t["lux"]) == (32, 5)
    g, a, b = _states(shape, q, 17 + q)
    seeds = multispin_rng.sweep_phase_keys(rng.base_key(21), SWEEPS)
    na, nb, obs, reads = replay(a, b, seeds, q=q, beta=1 / KBT, gen=g,
                                tiles=t, offsets=(3, 0))
    for k, ((px, po), read) in enumerate(reads):
        np.testing.assert_array_equal(read, _plain_reads(px, po, k % 2))
    wa, wb, wobs = c8ms.multisweep_plain(torch.from_numpy(a.copy()),
                                         torch.from_numpy(b.copy()), seeds,
                                         q=q, beta=1 / KBT)
    np.testing.assert_array_equal(na, wa.numpy())
    np.testing.assert_array_equal(nb, wb.numpy())
    assert np.abs(obs - wobs.numpy()).max() <= 1e-12 * 2 * 70 * 500


def test_replay_is_independent_of_the_grid():
    """The tiles' partials do not depend on which block takes a tile: one
    block or every tile its own block give the same states and sums."""
    shape, q = (2, 12, 5), 6
    _, a, b = _states(shape, q, 3)
    seeds = multispin_rng.sweep_phase_keys(rng.base_key(9), SWEEPS)
    one = replay(a, b, seeds, q=q, beta=1 / KBT, blocks=1)
    t = c8ms.ms_tiles(*shape)
    every = replay(a, b, seeds, q=q, beta=1 / KBT,
                   blocks=shape[0] * t["nty"] * t["nch"])
    for x, y in zip(one[:3], every[:3]):
        np.testing.assert_array_equal(x, y)
