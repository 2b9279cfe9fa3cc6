"""The int8 clock measure kernel's tiles, replayed on the CPU.

``csrc/clock_measure_pallas.cu`` ``measure_kernel`` sums per replica the
float64 (Σ cos θ, Σ sin θ, E) of (R, ny, half) int8 colour planes in tiles
of whole rows (chunks of a row past ``CHUNK_COLS`` columns), from the
constants the wrapper passes (``c8m.measure_tiles``).  These tests walk
that launch in numpy from the same constants, block by block and thread
row by thread row: the byte ranges a tile stages (both colours' tile rows
and their row after the tile) copied into a shared-memory image from the
16-B aligned vectors that cover them at the tensors' real byte offsets,
into the slot of the tile's step (two slots in turns); each thread's
walk down its segment of rows, a group of four columns at a
time, each row's (cos, sin) gathered once from the float64 table and
carried into the next step as the down neighbours' values; the right
neighbours from the same row's other colour, one column on by the row's
parity, the column after the group from the byte beside its words or the
row's wrap (from shared memory with whole rows, from device memory in a
chunk); the ragged group's sites masked to state 127, whose table entry
is (0, 0).

Every site must be summed exactly once and read its right and down
neighbours at the indices the plain version reads; the sums must equal
``c8m.measure_sums_plain`` bitwise at q = 2 and 4 (integer terms) and
within 1e-12 of the sums' scale at q = 3, 5, 6 and 127 (float64 terms
added in another order).

Shapes: odd half with its masked tail (63, 9, 7, 1), ny = 2, rows past the
chunk width (half 4102: two chunks, a ragged last group), R = 1 and 5;
tensors at an aligned address and a few bytes past one.
"""

import numpy as np
import pytest
import torch
from test_torch_ising3d_int8_tiles import Tensor

from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
    clock_measure_pallas as c8m,
)
from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
    clock_pallas as c8p,
)

M32 = 0xFFFFFFFF
SHAPES = [(1, 2, 1), (5, 130, 63), (1, 6, 4102), (5, 2, 7), (1, 34, 250),
          (5, 8, 9)]
# the smoke's launches of the kernel (R, ny, half): the clock checks'
# 130x126 x 3, the classes' 1000^2 x 16, 2000^2 x 16 and 1000^2 x 1, the
# tile edges (chip_smoke.CLOCK8_EDGES) and the CUDA tests' shapes
SMOKE_LAUNCHES = [(3, 130, 63), (16, 1000, 500), (16, 2000, 1000),
                  (1, 1000, 500), (2, 6, 4102), (2, 64, 128), (1, 2, 1)]
OFFSETS = [(0, 0), (3, 7), (11, 5)]


def _states(g, q, shape):
    return g.integers(0, q, size=shape, dtype=np.int8)


def replay(a, b, q: int, offsets=(0, 0)):
    """measure_kernel on numpy int8 (R, ny, half) planes; ``offsets`` the
    tensors' byte offsets mod 16 (a tile's slot is its step's parity in
    the block's walk).  Returns ((R, 3) float64 (Σ cos, Σ sin,
    E), the times each site of each colour was summed (2, R, ny, half),
    the states each site read as its right and down neighbours (4, R, ny,
    half): a's right, a's down, b's right, b's down)."""
    nrep, ny, half = a.shape
    t = c8m.measure_tiles(ny, half)
    rows, lux, rpt, cw, nch, nty, nblk = (
        t[k] for k in ("rows", "lux", "rpt", "cw", "nch", "nty", "nblk"))
    assert rows == (1 if nch > 1 else (c8m.THREADS >> lux) * rpt)
    assert nty * rows >= ny > (nty - 1) * rows and nblk <= nty * nch
    assert nch * cw >= half > (nch - 1) * cw and t["smem"] <= 48 * 1024
    buf, ux, tr = t["buf"], 1 << lux, c8m.THREADS >> lux
    tab = c8p.table_rows(q, torch.float64).numpy()
    assert np.all(tab[:, 127] == 0)
    ten = {"a": Tensor(a, offsets[0]), "b": Tensor(b, offsets[1])}
    flat = {"a": a.view(np.uint8).ravel(), "b": b.view(np.uint8).ravel()}
    partials = np.zeros((nrep, nblk, 3))
    seen = np.zeros((2,) + a.shape, np.int64)
    read = np.full((4,) + a.shape, -1, np.int64)
    assert len(buf) == 8
    ends = dict(zip(buf, [p - 16 for p in buf[1:]] + [t["smem"]]))
    gen = np.random.default_rng(2)
    for blk in range(nblk):
        step = 0
        for r in range(nrep):
            sums = np.zeros(3)
            for f in range(blk, nty * nch, nblk):
                slot = buf[4 * (step % 2):]
                step += 1
                yt, cx = divmod(f, nch)
                c0 = cx * cw
                ncw = min(cw, half - c0)
                y0 = yt * rows
                nr = min(rows, ny - y0)
                yd = 0 if y0 + nr == ny else y0 + nr
                lx = (nr - 1) * half + ncw
                rep = r * ny * half
                sm = gen.integers(0, 256, t["smem"], dtype=np.uint8)

                def stage(c, start, ln, at):
                    s = (ten[c].off + start) % 16
                    nv = (s + ln + 15) // 16
                    assert at + 16 * nv + 8 <= ends[at]
                    sm[at:at + 16 * nv] = ten[c].vectors(start - s, nv)
                    return at + s

                pa0 = stage("a", rep + y0 * half + c0, lx, slot[0])
                pb0 = stage("b", rep + y0 * half + c0, lx, slot[1])
                pa_dn = stage("a", rep + yd * half + c0, ncw, slot[2])
                pb_dn = stage("b", rep + yd * half + c0, ncw, slot[3])
                sw = sm.view("<u4").astype(np.uint64)
                cnext = 0 if c0 + ncw == half else c0 + ncw
                j = np.arange(-(-ncw // 4))
                nv = np.minimum(4, ncw - 4 * j)
                vm = np.where(nv == 4, M32, (1 << (8 * nv)) - 1).astype(
                    np.uint64)
                keep, pad = vm & 0x7F7F7F7F, ~vm & 0x7F7F7F7F
                last = 4 * j + 4 >= ncw

                def row(pa, pb):
                    """The group words' states (masked: 127) of both
                    colours and each colour's byte after the group."""
                    out = []
                    for p in (pa, pb):
                        i = (p >> 2) + j
                        assert (i + 1 < sw.size).all()
                        s8 = np.uint64(8 * (p & 3))
                        w = (((sw[i + 1] << np.uint64(32)) | sw[i]) >> s8) \
                            & np.uint64(M32)
                        w = (w & keep) | pad
                        nxt = (sw[i + 1] >> s8) & np.uint64(0x7F)
                        st = np.stack([(w >> np.uint64(8 * k)) & np.uint64(
                            0xFF) for k in range(4)], axis=-1).astype(int)
                        out += [st, nxt.astype(int)]
                    return out

                for ty in range(tr):
                    s0, s1 = ty * rpt, min(ty * rpt + rpt, nr)
                    if s0 >= nr:
                        continue
                    cur = row(pa0 + s0 * half, pb0 + s0 * half)
                    for ry in range(s0, s1):
                        if ry + 1 < nr:
                            nxt = row(pa0 + (ry + 1) * half,
                                      pb0 + (ry + 1) * half)
                        else:
                            nxt = row(pa_dn, pb_dn)
                        y = y0 + ry
                        odd = y & 1
                        sa, xa, sb, xb = cur
                        x = xb if odd else xa
                        if nch == 1:
                            wrap = int(sm[(pb0 if odd else pa0) + ry * half])
                        else:
                            c = "b" if odd else "a"
                            wrap = int(flat[c][rep + y * half + cnext])
                        x = np.where(last, wrap & 0x7F, x)
                        shifted = sb if odd else sa
                        ext = np.concatenate([shifted[:, 1:], x[:, None]],
                                             axis=1)
                        for g in np.nonzero(nv < 4)[0]:
                            ext[g, nv[g] - 1] = x[g]
                        ra = ext if odd else sb
                        rb = sa if odd else ext
                        da, db = nxt[2], nxt[0]
                        c, s = tab[0], tab[1]
                        ok = np.arange(4)[None, :] < nv[:, None]
                        assert np.all(sa[~ok] == 127) and np.all(
                            sb[~ok] == 127)
                        e = ((c[sa] * (c[ra] + c[da]) + s[sa] * (s[ra]
                                                                 + s[da]))
                             + (c[sb] * (c[rb] + c[db]) + s[sb] * (s[rb]
                                                                   + s[db])))
                        sums += [(c[sa] + c[sb]).sum(), (s[sa] + s[sb]).sum(),
                                 e.sum()]
                        gj, k = np.nonzero(ok)
                        col = c0 + 4 * gj + k
                        seen[0, r, y, col] += 1
                        seen[1, r, y, col] += 1
                        for n, v in enumerate((ra, da, rb, db)):
                            read[n, r, y, col] = v[gj, k]
                        cur = nxt
            partials[r, blk] = sums
    obs = partials.sum(axis=1)
    obs[:, 2] *= -1
    return obs, seen, read


def _plain_neighbours(a, b):
    """The states the plain version reads as a's right and down and b's
    right and down neighbours (core/lattice.right_down_neighbors)."""
    nrep, ny, half = a.shape
    y = np.arange(ny).reshape(1, -1, 1)
    c = np.arange(half).reshape(1, 1, -1)
    odd = y & 1
    ar = np.take_along_axis(b, np.broadcast_to((c + odd) % half, b.shape),
                            axis=2)
    br = np.take_along_axis(a, np.broadcast_to((c + 1 - odd) % half,
                                               a.shape), axis=2)
    return np.stack([ar, np.roll(b, -1, axis=1), br, np.roll(a, -1, axis=1)])


def _scaled(got, want, nsites):
    return float((np.abs(got - want)
                  / np.maximum(np.abs(want), nsites)).max())


@pytest.mark.parametrize("q", [2, 4, 3, 5, 6, 127])
@pytest.mark.parametrize("shape", SHAPES)
def test_replay_matches_plain(shape, q):
    g = np.random.default_rng(q + sum(shape))
    a, b = _states(g, q, shape), _states(g, q, shape)
    want = c8m.measure_sums_plain(torch.from_numpy(a), torch.from_numpy(b),
                                  q).numpy()
    nbrs = _plain_neighbours(a.astype(np.int64), b.astype(np.int64))
    for offsets in OFFSETS[:2 if shape[2] > 1000 else 3]:
        got, seen, read = replay(a, b, q, offsets)
        assert np.all(seen == 1), offsets
        np.testing.assert_array_equal(read, nbrs)
        if q in (2, 4):
            np.testing.assert_array_equal(got, want)
        else:
            assert _scaled(got, want, 2 * shape[1] * shape[2]) < 1e-12


@pytest.mark.parametrize("nrep,ny,half", SMOKE_LAUNCHES)
def test_smoke_launch_tiles(nrep, ny, half):
    """The constants of every launch the smoke and the CUDA tests make, as
    the C entry checks them (tiles_ok restated): one tile a block at the
    classes' shapes, rows of whole rows under the chunk width, each row's
    (cos, sin) gathered at most 1.5 times a site."""
    t = c8m.measure_tiles(ny, half)
    assert 0 <= t["lux"] <= 8 and t["rpt"] >= 1
    assert t["nty"] * t["rows"] >= ny > (t["nty"] - 1) * t["rows"]
    assert 1 <= t["nblk"] <= min(t["nty"] * t["nch"], c8m.MEASURE_BLOCKS)
    assert all(p % 16 == 0 for p in t["buf"]) and t["smem"] <= 48 * 1024
    if half <= c8m.CHUNK_COLS:
        assert t["nch"] == 1 and t["cw"] == half
    if (ny, half) in ((2000, 1000), (1000, 500)):
        assert t["nblk"] == t["nty"] * t["nch"] == 250
        assert (t["rpt"] + 1) / t["rpt"] <= 1.5
    assert len(t["buf"]) == 8 and t["buf"][4] > t["buf"][3]
    partials, ticket = c8m._scratch("cpu", nrep, t["nblk"])
    assert partials.shape == (nrep, t["nblk"], 3) and int(ticket[0]) == 0
    assert c8m._scratch("cpu", nrep, t["nblk"])[0] is partials
