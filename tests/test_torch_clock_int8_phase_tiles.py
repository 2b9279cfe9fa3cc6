"""The int8 clock phase kernel's tiles, replayed on the CPU.

``csrc/clock_pallas.cu`` ``phase_kernel`` runs one colour phase of (R, ny,
half) int8 clock states, one tile a block: whole rows of one replica
(chunks of a row past ``CHUNK_COLS`` columns), from the constants the
wrapper passes (``clock_pallas.phase_tiles``: ``ising2d_multisweep.
ms_tiles`` at 8 KB a tile, checked by ``check_ms_tiles``).  These tests walk that launch in numpy, block by
block and thread by thread, from the same constants: the grid (chunks,
row tiles, replicas) and its walk over row tiles gridDim.y apart, the four
byte ranges a tile stages (its sites, the other colour's rows y0 ..
widened a column each side in a chunk, and the rows before and after it,
wrapped or, in the halo mode, the halo rows at the shard's edges), copied
into a shared-memory image from the 16-B aligned vectors that cover them
at the tensors' real byte offsets; the four-byte windows each word of
four sites reads from that image (two aligned words and a funnel shift),
the row's wrap or the column halo patched into the side window; at an odd
col0 the words a column early; the two Philox calls of each word at the
global counter under the phase's round keys, or the injected uniforms;
the site rule on the staged (cos, sin) table; the stores into the image
and the write-back in aligned vectors and ragged bytes; and the measuring
halo mode's fused float64 terms, a partial a tile.

Every site must be stored exactly once, by the tile holding it, and no
byte outside the tiles' ranges (or the tensor) written; every neighbour a
site reads must be the pre-phase value at the index the plain version
reads (the halos at the shard's edges); the phase must equal
``phase_plain`` (``sharded_phase_plain`` in the halo mode) bitwise, and
the sums, taken over the tiles' partials, equal the plain sums to float64
rounding (1e-12 of their scale).

Shapes (R, ny, half): (2, 12, 5) (an odd half: rows off the 4-byte grid,
a masked last word), (1, 33, 250) (half neither a multiple of 4 nor of
16, a partial last tile), (1, 4, 4102) (chunks, a masked last word); q =
2, 5, 6 and 127; tensors at an aligned address and 3 and 11 bytes past
one; shards at global offsets with an odd and an even col0, with the
column halos and without them, one chunked; the streamed class's tiles
(2000^2 x 16) and the multisweeps' larger ones on a shorter replica.
"""

import numpy as np
import pytest
import torch
from test_torch_clock_int8_ms_tiles import _plain_reads, _tables
from test_torch_ising3d_int8_tiles import (
    Tensor,
    _funnel,
    philox_rk,
    round_keys,
)

from cuda_fortran_mc_simulation_spin_tpu_torch.core import rng
from cuda_fortran_mc_simulation_spin_tpu_torch.ops import clock_pallas as c8p
from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
    ising2d_multisweep as i8ms,
)

KBT = 0.91
SHAPES = [(2, 12, 5), (1, 33, 250), (1, 4, 4102)]
QS = [2, 5, 6, 127]
MAX_GRID = 65535


def replay_phase(xt: Tensor, ot: Tensor, shape, rk, *, color: int, q: int,
                 beta: float, gen, inject=None, halo=None, measuring=False,
                 tiles=None, grid_y=MAX_GRID):
    """One colour phase of the launch on the tensors' bytes: xt updated in
    place, with the constants ``tiles`` (else phase_tiles') and at most
    ``grid_y`` blocks along the row tiles.  ``inject``: (u_cand, u_acc)
    float32 arrays; ``halo``: {"up", "dn": Tensor (R, 1, half), "lf",
    "rt": arrays (R, ny, 1) or None, "offs": (rep0, row0, col0)}.
    Returns the (R, nty nch, 3) tile partials (``measuring``) and the
    neighbours each site read, (5, R, ny, half) (up, down, centre, side,
    own)."""
    nrep, ny, half = shape
    t = tiles or c8p.phase_tiles(nrep, ny, half)
    i8ms.check_ms_tiles(t, ny, half)
    rows, lux, cw, nch, nty = (t[k] for k in ("rows", "lux", "cw", "nch",
                                              "nty"))
    buf, ux = t["buf"], 1 << lux
    tr = c8p.THREADS >> lux
    tab, tab64 = _tables(q)
    qm1 = np.float32(q - 1)
    neg_beta = np.float32(-beta)
    rep0, row0, col0 = halo["offs"] if halo else (0, 0, 0)
    lf = rt = None
    if halo:
        lf, rt = halo["lf"], halo["rt"]
    lo = col0 & 1
    plane = ny * half
    o_flat = ot.mem[ot.off:ot.off + ot.n]
    writes = np.zeros(xt.mem.size, np.int64)
    owner = np.full(xt.mem.size, -1, np.int64)
    read = np.full((5,) + tuple(shape), -1, np.int64)
    partials = np.zeros((nrep, nty * nch, 3))
    gy = min(nty, grid_y)
    blocks = [(cx, yt, r) for r in range(nrep) for by in range(gy)
              for cx in range(nch) for yt in range(by, nty, gy)]
    assert sorted(blocks) == sorted((cx, yt, r) for r in range(nrep)
                                    for yt in range(nty)
                                    for cx in range(nch))
    for cx, yt, r in blocks:
        c0 = cx * cw
        ncw = min(cw, half - c0)
        clo, chi = (c0 - 1 if c0 > 0 else 0), min(c0 + ncw + 1, half)
        y0 = yt * rows
        nr = min(rows, ny - y0)
        lx = (nr - 1) * half + ncw
        lc = (nr - 1) * half + chi - clo
        base = r * plane
        up = ((halo["up"], r * half + c0) if halo and y0 == 0 else
              (ot, base + (y0 - 1) % ny * half + c0))
        dn = ((halo["dn"], r * half + c0) if halo and y0 + nr == ny else
              (ot, base + (y0 + nr) % ny * half + c0))
        # (tensor, first byte, length) of the four ranges
        spans = [(xt, base + y0 * half + c0, lx),
                 (ot, base + y0 * half + clo, lc), (*up, ncw), (*dn, ncw)]
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
        # thread (ty, tx) takes words tx, tx + ux, ... of rows ty, ty +
        # tr, ...: every word of the tile once
        ty, j = np.meshgrid(np.arange(nr), np.arange((ncw + lo + 3) // 4),
                            indexing="ij")
        ty, j = ty.ravel(), j.ravel()
        tid = ((ty % tr) << lux) | (j % ux)
        assert len(set(zip(tid, ty // tr, j // ux))) == len(tid)
        assert tid.max() < c8p.THREADS
        y = y0 + ty
        col = c0 + 4 * j - lo
        k0 = np.where(col < c0, c0 - col, 0)
        nv = np.minimum(4, c0 + ncw - col)
        d = np.where((color == 0) == (((row0 + y) & 1) == 1), 1, -1)
        row = ty * half
        px = buf[0] + shx + row - lo
        pc = buf[1] + shc + row + (c0 - clo) - lo - (d < 0)
        pu = np.where(ty == 0, buf[2] + shu,
                      buf[1] + shc + row - half + (c0 - clo)) - lo
        pd = np.where(ty == nr - 1, buf[3] + shd,
                      buf[1] + shc + row + half + (c0 - clo)) - lo
        assert min(px.min(), pc.min(), pu.min(), pd.min()) >= 0
        sw = sm.view("<u4").astype(np.uint64)

        def words(p):
            k = (p >> 2) + j
            return sw[k], sw[k + 1], 8 * (p & 3)

        def win(p):
            lo_, hi, s = words(p)
            return _funnel(lo_, hi, s)

        xv, uv, dv = win(px), win(pu), win(pd)
        lw, hw, sc = words(pc)
        lower = _funnel(lw, hw, sc)
        upper = _funnel(lw, hw, sc + 8, clamp=True)
        orow = base + y * half
        for i in np.flatnonzero((d > 0) & (col + 3 >= half - 1)):
            kb = half - 1 - col[i]
            assert 0 <= kb < 4
            v = (int(rt[r, y[i], 0]) if rt is not None
                 else int(o_flat[orow[i]]))
            upper[i] = (int(upper[i]) & ~(0xFF << (8 * kb))) | (
                (v & 0xFF) << (8 * kb))
        for i in np.flatnonzero((d < 0) & (col <= 0)):
            kb = -col[i]
            v = (int(lf[r, y[i], 0]) if lf is not None
                 else int(o_flat[orow[i] + half - 1]))
            lower[i] = (int(lower[i]) & ~(0xFF << (8 * kb))) | (
                (v & 0xFF) << (8 * kb))
        cv = np.where(d > 0, lower, upper)
        sv = np.where(d > 0, upper, lower)
        if inject is None:
            j0 = (col0 + c0 - lo) >> 1
            assert ((col0 + col) % 2 == 0).all()
            ctr = np.stack([np.full_like(y, rep0 + r), row0 + y,
                            j0 + 2 * j, np.zeros_like(y)],
                           axis=-1).astype(np.uint64)
            w0 = philox_rk(ctr, rk)
            ctr[:, 2] += 1
            ws = np.concatenate([w0, philox_rk(ctr, rk)], axis=1)
        nxv = xv.copy()
        terms = np.zeros((len(j), 3))
        for k in range(4):
            ok = (k >= k0) & (k < nv)
            # the masked words' byte k (the kernel's __byte_perm)
            idx = [(((v & np.uint64(0x7F7F7F7F)) >> np.uint64(8 * k))
                    & np.uint64(0xFF)).astype(np.int64)
                   for v in (uv, dv, cv, sv, xv)]
            for n_, v in enumerate(idx):
                read[n_, r, y[ok], col[ok] + k] = v[ok]
            ou, od, oc, os_, xk = idx
            hx = (tab[0][ou] + tab[0][od]) + (tab[0][oc] + tab[0][os_])
            hy = (tab[1][ou] + tab[1][od]) + (tab[1][oc] + tab[1][os_])
            if inject is None:
                uc = rng.bits_to_uniform(torch.from_numpy(
                    ws[:, 2 * k].astype(np.int64))).numpy()
                ua = rng.bits_to_uniform(torch.from_numpy(
                    ws[:, 2 * k + 1].astype(np.int64))).numpy()
            else:
                at = np.clip(col + k, 0, half - 1)
                uc, ua = (u[r, y, at] for u in inject)
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
            ok = (k >= k0) & (k < nv)
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
    # every site written once, by the tile holding it
    sites = np.zeros(xt.mem.size, bool)
    sites[xt.off:xt.off + xt.n] = True
    assert (writes[sites] == 1).all() and (writes[~sites] == 0).all()
    r_, y_, c_ = np.meshgrid(*(np.arange(n) for n in shape), indexing="ij")
    want = (r_ * nty + y_ // rows) * nch + c_ // cw
    assert np.array_equal(owner[sites].reshape(shape), want)
    return partials, read


def _planes(t: Tensor, shape):
    return t.mem[t.off:t.off + t.n].view(np.int8).reshape(shape).copy()


def _halo_reads(x, o, color, up, dn, lf, rt, row0):
    """The five states the plain sharded phase reads at each site: the
    rows above and below (the halo rows past the shard's edges), the
    centre, the side (c + d by global row parity; past the edges the
    column halos, or the shard's own other end without them) and the
    site's own, each masked to the table."""
    nrep, ny, half = o.shape
    y = np.arange(ny).reshape(1, -1, 1)
    d = np.where((color == 0) == (((row0 + y) & 1) == 1), 1, -1)
    c = np.arange(half).reshape(1, 1, -1)
    ext = np.concatenate([lf if lf is not None else o[:, :, -1:], o,
                          rt if rt is not None else o[:, :, :1]], axis=2)
    side = np.take_along_axis(ext, np.broadcast_to(c + d + 1, o.shape),
                              axis=2)
    above = np.concatenate([up, o[:, :-1]], axis=1)
    below = np.concatenate([o[:, 1:], dn], axis=1)
    return np.stack([above, below, o, side, x]).astype(np.int64) & 127


def _states(shape, q, seed):
    g = np.random.default_rng(seed)
    return (g, g.integers(0, q, size=shape, dtype=np.int8),
            g.integers(0, q, size=shape, dtype=np.int8))


def _uniforms(g, shape):
    return [g.random(shape, dtype=np.float32) for _ in range(2)]


@pytest.mark.parametrize("offsets", [(0, 0), (3, 11)])
@pytest.mark.parametrize("q", QS)
@pytest.mark.parametrize("shape", SHAPES)
def test_replay_equals_plain_phase(shape, q, offsets):
    """Both colours, Philox and injected uniforms: every site stored once,
    every neighbour read at its pre-phase value; the states equal
    ``phase_plain`` bitwise."""
    g, a, b = _states(shape, q, 101 * q + sum(shape) + offsets[0])
    beta = 1 / KBT
    inj = _uniforms(g, shape)
    for color in (0, 1):
        x, o = (a, b) if color == 0 else (b, a)
        seeds = rng.seeds_from_key(rng.base_key(5 + q), color)
        for inject in (None, inj):
            xt, ot = Tensor(x, offsets[0]), Tensor(o, offsets[1])
            _, read = replay_phase(xt, ot, shape, round_keys(seeds),
                                   color=color, q=q, beta=beta, gen=g,
                                   inject=inject)
            np.testing.assert_array_equal(read, _plain_reads(x, o, color))
            kw = (dict(u_cand=torch.from_numpy(inject[0]),
                       u_acc=torch.from_numpy(inject[1]))
                  if inject is not None else {})
            want = c8p.phase_plain(torch.from_numpy(x.copy()),
                                   torch.from_numpy(o.copy()),
                                   None if kw else seeds, color=color, q=q,
                                   beta=beta, **kw)
            np.testing.assert_array_equal(_planes(xt, shape), want.numpy())


# (shape, (rep0, row0, col0), column halos, byte offsets)
SHARDS = [((2, 9, 23), (1, 5, 11), True, (0, 3)),
          ((2, 9, 23), (1, 5, 11), False, (11, 0)),
          ((2, 8, 22), (0, 3, 0), True, (3, 3)),
          ((2, 8, 22), (0, 4, 0), False, (0, 0)),
          ((1, 3, 4102), (0, 7, 5), True, (3, 0))]


@pytest.mark.parametrize("q", [2, 5, 127])
@pytest.mark.parametrize("shard", SHARDS)
def test_replay_equals_plain_sharded_phase(shard, q):
    """The halo mode: a shard at global (rep0, row0, col0), its halo rows,
    with and without the column halos (odd col0: words a column early,
    the shard's first and last sites in units cut by its edges); both
    colours, Philox and injected uniforms, measuring: every site stored
    once, every neighbour read the plain version's; the states equal
    ``sharded_phase_plain`` bitwise, the sums its sums within 1e-12 of
    their scale."""
    shape, offs, cols, offsets = shard
    nrep, ny, half = shape
    g, a, b = _states(shape, q, 7 * q + sum(offs) + half)
    up, dn = (g.integers(0, q, size=(nrep, 1, half), dtype=np.int8)
              for _ in range(2))
    lf, rt = ((g.integers(0, q, size=(nrep, ny, 1), dtype=np.int8)
               for _ in range(2)) if cols else (None, None))
    beta = 1 / KBT
    inj = _uniforms(g, shape)
    for color in (0, 1):
        x, o = (a, b) if color == 0 else (b, a)
        seeds = rng.seeds_from_key(rng.base_key(9 + q), color)
        for inject, measuring in ((None, False), (inj, False),
                                  (None, True)):
            xt, ot = Tensor(x, offsets[0]), Tensor(o, offsets[1])
            halo = dict(up=Tensor(up, offsets[1]), dn=Tensor(dn, 5), lf=lf,
                        rt=rt, offs=offs)
            part, read = replay_phase(
                xt, ot, shape, round_keys(seeds), color=color, q=q,
                beta=beta, gen=g, inject=inject, halo=halo,
                measuring=measuring)
            np.testing.assert_array_equal(
                read, _halo_reads(x, o, color, up, dn, lf, rt, offs[1]))
            kw = dict(color=color, q=q, beta=beta, measuring=measuring)
            if cols:
                kw.update(halo_lf=torch.from_numpy(lf),
                          halo_rt=torch.from_numpy(rt))
            if inject is not None:
                kw.update(u_cand=torch.from_numpy(inject[0]),
                          u_acc=torch.from_numpy(inject[1]))
            want = c8p.sharded_phase_plain(
                torch.from_numpy(x.copy()), torch.from_numpy(o.copy()),
                torch.from_numpy(up), torch.from_numpy(dn), seeds,
                offs if cols or offs[2] else offs[:2], **kw)
            new = want[0] if measuring else want
            np.testing.assert_array_equal(_planes(xt, shape), new.numpy())
            if measuring:
                got = part.sum(axis=1)
                got[:, 2] = -got[:, 2]
                plain = torch.stack(want[1:], dim=-1).numpy()
                assert np.abs(got - plain).max() <= 1e-12 * 2 * ny * half


@pytest.mark.parametrize("q", [5, 6])
@pytest.mark.parametrize("tile_bytes", [8192, 16384])
def test_replay_on_the_class_tiles(q, tile_bytes):
    """The streamed class's tile shape (phase_tiles at 2000^2 x 16: 8
    rows, 64 threads a row; the multisweeps' 16 rows at 16 KB) on a
    shorter replica, and the mesh class's shard tiles (16, 1000, 500): the
    same checks as above."""
    shape = (1, 37, 1000)
    t = i8ms.ms_tiles(16, 2000, 1000, tile_bytes)
    assert (t["rows"], t["lux"]) == (tile_bytes // 1024, 6)
    t = dict(t, nty=-(-37 // t["rows"]))
    g, a, b = _states(shape, q, 17 + q)
    seeds = rng.seeds_from_key(rng.base_key(21), 1)
    xt, ot = Tensor(b, 0), Tensor(a, 3)
    _, read = replay_phase(xt, ot, shape, round_keys(seeds), color=1, q=q,
                           beta=1 / KBT, gen=g, tiles=t)
    np.testing.assert_array_equal(read, _plain_reads(b, a, 1))
    want = c8p.phase_plain(torch.from_numpy(b.copy()),
                           torch.from_numpy(a.copy()), seeds, color=1, q=q,
                           beta=1 / KBT)
    np.testing.assert_array_equal(_planes(xt, shape), want.numpy())
    assert c8p.phase_tiles(16, 2000, 1000) == i8ms.ms_tiles(16, 2000, 1000,
                                                          8192)
    t = c8p.phase_tiles(16, 1000, 500)
    assert (t["rows"], t["lux"], t["nty"]) == (16, 5, 63)


def test_replay_is_independent_of_the_grid():
    """Row tiles walked gridDim.y apart (the kernel's loop past 65535 row
    tiles) give the states and partials of a block a tile."""
    shape, q = (2, 40, 5), 6
    g, a, b = _states(shape, q, 3)
    # four rows a tile, a thread a row (ms_tiles' own pick is one tile)
    buf, end = [], 0
    for n in i8ms._spans(4, 5, 5):
        buf.append(end + 16)
        end = buf[-1] + n
    t = dict(rows=4, lux=8, cw=5, nch=1, nty=10, buf=tuple(buf), smem=end)
    i8ms.check_ms_tiles(t, 40, 5)
    seeds = rng.seeds_from_key(rng.base_key(9), 1)
    up, dn = (g.integers(0, q, size=(2, 1, 5), dtype=np.int8)
              for _ in range(2))
    out = []
    for grid_y in (MAX_GRID, 3, 1):
        xt, ot = Tensor(b, 0), Tensor(a, 0)
        halo = dict(up=Tensor(up, 0), dn=Tensor(dn, 0), lf=None, rt=None,
                    offs=(0, 2, 0))
        part, _ = replay_phase(xt, ot, shape, round_keys(seeds), color=1,
                               q=q, beta=1 / KBT, gen=g, halo=halo,
                               measuring=True, tiles=t, grid_y=grid_y)
        out.append((_planes(xt, shape), part))
    for p, part in out[1:]:
        np.testing.assert_array_equal(p, out[0][0])
        np.testing.assert_array_equal(part, out[0][1])


def test_wrapper_checks_the_tiles():
    """The wrapper's constants are phase_tiles', checked before the
    launch: ms_tiles at TILE_BYTES a tile."""
    for shape in SHAPES + [(16, 2000, 1000), (16, 1000, 500)]:
        t = c8p.phase_tiles(*shape)
        i8ms.check_ms_tiles(t, *shape[1:])
        assert list(i8ms._tiles_arg(*shape, c8p.TILE_BYTES)) == [
            t["rows"], t["lux"], t["cw"], t["nch"], t["nty"], *t["buf"],
            t["smem"]]
    bad = dict(i8ms.ms_tiles(16, 2000, 1000), nty=1)
    with pytest.raises(ValueError, match="tiles"):
        i8ms.check_ms_tiles(bad, 2000, 1000)
