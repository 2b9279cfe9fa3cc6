"""The int8 2-D Ising multisweep kernel's tiles, replayed on the CPU.

``csrc/ising2d_multisweep.cu`` ``multisweep_kernel`` runs S sweeps (phase
a, then phase b) of (R, ny, half) int8 ±1 planes in one cooperative
launch, each phase in tiles of whole rows of one replica (chunks of a row
past ``i8ms.CHUNK_COLS`` columns), from the constants the wrapper passes
(``i8ms.ms_tiles``, the int8 clock multisweep's too).  These tests walk
that launch in numpy, tile by tile and thread by thread, from the same
constants: the grid's walk over the tiles by carries (no division), the
four byte ranges a tile stages (its sites, the other colour's rows y0 ..
widened a column each side in a chunk, and the rows before and after it,
wrapped), copied into a shared-memory image from the 16-B aligned vectors
that cover them at the tensors' real byte offsets; the four-byte windows
each unit of four sites reads from that image (two aligned words and a
funnel shift), the row's wrap patched into the side window; the unit's
Philox call under the phase's round keys; the byte-SIMD count and
acceptance; the stores into the image and the write-back in aligned
vectors and ragged bytes; and phase b's fused (m, e), the tile's int64
atomic adds.

``replay_phase`` replays the tile body itself (``csrc/ising_int8.cuh``
``tile``), which the int8 2-D phase kernel runs too:
``tests/test_torch_ising_int8_phase_tiles.py`` takes it with that
kernel's grid, halo rows and columns, column offsets and injected words.

Every site must be stored exactly once a phase, by the tile holding it,
and no byte outside the tiles' ranges (or the tensor) written; every
neighbour a site reads must be the pre-phase value at the index the plain
version reads; S sweeps through the replayed words must equal
``i8ms.multisweep_plain`` and S pairs of plain phases with the plain
measure, bitwise, the int64 sums exactly.  The kernel's own refusal of
bad constants is ``i8ms.check_ms_tiles``'s, which the wrapper calls
first.

Shapes (R, ny, half): (2, 12, 5) (half neither a multiple of 4 nor of
16: rows off the 4-byte grid, a masked last unit), (1, 33, 500) (the
resident class's rows, 4-byte but not 16-byte aligned; one replica:
tiles of 2 rows, 128 threads a row, and a last band of one row), (1, 4,
4102) (chunks, a masked last unit); planes at an aligned address, 3 bytes
past one and at two offsets.  Beside them the resident class's own tiles
(32 rows, 32 threads a row, 1000^2 x 16) replayed on (1, 70, 500): two
whole tiles and a band of 6 rows.
"""

import numpy as np
import pytest
import torch
from test_torch_clock_int8_ms_tiles import walk
from test_torch_ising3d_int8_tiles import (
    SIGN,
    Tensor,
    _as_i8,
    _byte,
    _funnel,
    philox_rk,
    round_keys,
)

from cuda_fortran_mc_simulation_spin_tpu_torch.core import rng
from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
    clock_multisweep as c8ms,
)
from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
    ising2d_measure_pallas as i8m,
)
from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
    ising2d_multisweep as i8ms,
)
from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
    ising2d_pallas as i2p,
)
from cuda_fortran_mc_simulation_spin_tpu_torch.ops import multispin_rng

KBT = 2.269185314213022
SHAPES = [(2, 12, 5), (1, 33, 500), (1, 4, 4102)]
SWEEPS = 3
M32 = 0xFFFFFFFF


def _popc(v: np.ndarray) -> np.ndarray:
    return np.array([bin(int(w)).count("1") for w in v], np.int64)


def flip_bytes(k2, lv):
    """The kernel's flip bytes (1 where a site flips) of 2K a byte (the
    neighbours differing, doubled) and L a byte (the thresholds the word
    lies below): (2K + 2L + 12) & 16."""
    return ((k2 + np.uint64(2) * lv + np.uint64(0x0C0C0C0C))
            >> np.uint64(4)) & np.uint64(0x01010101)


def replay_phase(xt: Tensor, ot: Tensor, shape, rk, *, color: int, t4: int,
                 t8: int, measuring: bool, gen, blocks: int = 5,
                 tiles=None, order=None, halo=None, inject=None,
                 direct=False):
    """One colour phase of the tile body (csrc/ising_int8.cuh tile, which
    the multisweep and the phase kernel run) on the tensors' bytes: xt
    updated in place, with the constants ``tiles`` (else ms_tiles'), the
    tiles (r, yt, cx) taken in ``order`` (else the multisweep grid's walk
    of ``blocks`` blocks).  ``halo``: {"up", "dn": Tensor (R, 1, half),
    "lf", "rt": arrays (R, ny, 1) or None, "offs": (rep0, row0, col0)},
    the phase kernel's halo mode; ``inject``: (R, ny, half) uint32 words
    in place of Philox's; ``direct``: each thread stores its word's new
    bytes to the tensor (the phase kernel's DIRECT), in place of the
    tile's copy and its write-back.  Returns the (R, 2) int64 (m, e) the
    tiles add
    (``measuring``) and the neighbours each site read, (4, R, ny, half)
    (up, down, centre, side)."""
    nrep, ny, half = shape
    t = tiles or i8ms.ms_tiles(nrep, ny, half)
    i8ms.check_ms_tiles(t, ny, half)
    rows, lux, cw, nch, nty = (t[k] for k in ("rows", "lux", "cw", "nch",
                                              "nty"))
    buf, ux = t["buf"], 1 << lux
    tr = i8ms.THREADS >> lux
    assert rows % tr == 0 and t["smem"] <= 48 * 1024
    rep0, row0, col0 = halo["offs"] if halo else (0, 0, 0)
    lf, rt = (halo["lf"], halo["rt"]) if halo else (None, None)
    # a shard's rows start their words col0 % 4 columns early
    early = col0 & 3
    plane = ny * half
    pre = xt.mem.copy()
    o_flat = ot.mem[ot.off:ot.off + ot.n]
    writes = np.zeros(xt.mem.size, np.int64)
    owner = np.full(xt.mem.size, -1, np.int64)
    read = np.full((4,) + tuple(shape), 99, np.int64)
    obs = np.zeros((nrep, 2), np.int64)
    if order is None:
        order = [w[1:] for w in walk(min(blocks, nrep * nty * nch), nrep,
                                     nty, nch)]
    for r, yt, cx in order:
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
        # the own range was staged at its pre-phase values
        a0 = xt.off + base + y0 * half + c0
        assert (xt.mem[a0:a0 + lx] == pre[a0:a0 + lx]).all()
        # thread (ty, tx) takes words tx, tx + ux, ... of rows ty, ty +
        # tr, ...: every word of the tile once
        ty, j = np.meshgrid(np.arange(nr), np.arange((ncw + early + 3) // 4),
                            indexing="ij")
        ty, j = ty.ravel(), j.ravel()
        tid = ((ty % tr) << lux) | (j % ux)
        assert len(set(zip(tid, ty // tr, j // ux))) == len(tid)
        assert tid.max() < i8ms.THREADS
        y = y0 + ty
        cg = c0 + 4 * j - early      # the word's first column
        k0 = np.where(cg < c0, c0 - cg, 0)
        nv = np.minimum(4, c0 + ncw - cg)
        d = np.where((color == 0) == (((row0 + y) & 1) == 1), 1, -1)
        row = ty * half
        px = buf[0] + shx + row - early
        pc = buf[1] + shc + row + (c0 - clo) - early - (d < 0)
        pu = np.where(ty == 0, buf[2] + shu,
                      buf[1] + shc + row - half + (c0 - clo)) - early
        pd = np.where(ty == nr - 1, buf[3] + shd,
                      buf[1] + shc + row + half + (c0 - clo)) - early
        assert min(px.min(), pc.min(), pu.min(), pd.min()) >= 0
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

        # the row's ends: the column halos, or the wrap from memory
        def end(halo_col, i, k):
            if halo_col is not None:
                return int(halo_col[r, y[i], 0])
            return int(o_flat[orow[i] + k])

        for i in np.flatnonzero((d > 0) & (cg + 3 >= half - 1)):
            kb = half - 1 - cg[i]
            assert 0 <= kb < 4
            upper[i] = (int(upper[i]) & ~(0xFF << (8 * kb))) | (
                (end(rt, i, 0) & 0xFF) << (8 * kb))
        for i in np.flatnonzero((d < 0) & (cg <= 0)):
            kb = -cg[i]
            lower[i] = (int(lower[i]) & ~(0xFF << (8 * kb))) | (
                (end(lf, i, half - 1) & 0xFF) << (8 * kb))
        centre = np.where(d > 0, lower, upper)
        side = np.where(d > 0, upper, lower)
        for k in range(4):
            ok = (k >= k0) & (k < nv)
            for n_, w in enumerate((uv, dv, centre, side)):
                read[n_, r, y[ok], cg[ok] + k] = _as_i8(_byte(w[ok], k))
        k2 = np.zeros_like(xv)
        for w in (lower, upper, uv, dv):
            k2 += (xv ^ w) & np.uint64(SIGN)
        if inject is None:
            # a word is one global unit: one Philox call
            assert ((col0 + cg) % 4 == 0).all()
            ctr = np.stack([np.full_like(y, rep0 + r), row0 + y,
                            (col0 + cg) >> 2, np.zeros_like(y)],
                           axis=-1).astype(np.uint64)
            wv = philox_rk(ctr, rk)
        else:
            wv = np.zeros((len(j), 4), np.uint64)
            for k in range(4):
                ok = (k >= k0) & (k < nv)
                wv[ok, k] = inject[r, y[ok], cg[ok] + k]
        lv = np.zeros_like(xv)
        for k in range(4):
            lv |= ((wv[:, k] < t4).astype(np.uint64) + (wv[:, k] < t8)) \
                << np.uint64(8 * k)
        f = flip_bytes(k2, lv)
        nxv = xv ^ (f * np.uint64(0xFE))
        tile_id = (r * nty + yt) * nch + cx
        for k in range(4):
            ok = (k >= k0) & (k < nv)
            if direct:
                at = xt.off + base + y[ok] * half + cg[ok] + k
                np.add.at(writes, at, 1)
                owner[at] = tile_id
                xt.mem[at] = _byte(nxv[ok], k)
            else:
                sm[px[ok] + 4 * j[ok] + k] = _byte(nxv[ok], k)
        if measuring:
            vm = (np.where(nv == 4, M32, (1 << (8 * nv)) - 1)
                  & (M32 << (8 * k0))).astype(np.uint64)
            n = nv - k0
            obs[r, 0] += int((2 * n - 2 * (
                _popc(nxv & np.uint64(SIGN) & vm)
                + _popc(centre & np.uint64(SIGN) & vm))).sum())
            kp2 = k2 ^ ((k2 ^ (np.uint64(0x08080808) - k2))
                        & (f * np.uint64(0xFF)))
            bsum = (((kp2 & vm) * np.uint64(0x01010101)) & np.uint64(M32)) \
                >> np.uint64(24)
            obs[r, 1] += int((bsum.astype(np.int64) - 4 * n).sum())
        if direct:
            continue
        # the write-back: whole vectors in the range, bytes at its ragged
        # ends
        a = xt.off + base + y0 * half + c0 - shx
        for v in range((shx + lx + 15) // 16):
            lo_b = 16 * v - shx
            for b in range(16):
                if 0 <= lo_b + b < lx:
                    writes[a + 16 * v + b] += 1
                    owner[a + 16 * v + b] = tile_id
                    xt.mem[a + 16 * v + b] = sm[buf[0] + 16 * v + b]
    # every site written once a phase, by the tile holding it
    sites = np.zeros(xt.mem.size, bool)
    sites[xt.off:xt.off + xt.n] = True
    assert (writes[sites] == 1).all() and (writes[~sites] == 0).all()
    r_, y_, c_ = np.meshgrid(*(np.arange(n) for n in shape), indexing="ij")
    want = (r_ * nty + y_ // rows) * nch + c_ // cw
    assert np.array_equal(owner[sites].reshape(shape), want)
    return obs, read


def replay(a, b, seeds, *, beta, offsets=(0, 0), gen=None, blocks=5,
           tiles=None):
    """S = len(seeds) sweeps of the launch on numpy planes a, b (int8 (R,
    ny, half)) at byte offsets ``offsets`` mod 16.  Returns the new (a,
    b), the (R, S, 2) int64 (m, e) and each phase's neighbour reads."""
    gen = gen or np.random.default_rng(0)
    t4, t8 = i2p.accept_thresholds_u32(beta)
    assert t8 <= t4
    at, bt = Tensor(a, offsets[0]), Tensor(b, offsets[1])
    obs, reads = [], []

    def planes(t):
        return t.mem[t.off:t.off + t.n].view(np.int8).reshape(a.shape).copy()

    for s in range(seeds.shape[0]):
        for phase, (x, o) in enumerate(((at, bt), (bt, at))):
            pre = planes(o)
            sums, read = replay_phase(
                x, o, a.shape, round_keys(seeds[s, phase]), color=phase,
                t4=t4, t8=t8, measuring=phase == 1, gen=gen, blocks=blocks,
                tiles=tiles)
            reads.append((pre, read))
            if phase:
                obs.append(sums)
    return planes(at), planes(bt), np.stack(obs, axis=1), reads


def _plain_reads(o, color):
    """The four spins the plain version reads at each site: up, down,
    centre, side (c + d, d = +1 iff colour 0 on an odd row or colour 1 on
    an even one)."""
    nrep, ny, half = o.shape
    y = np.arange(ny).reshape(1, -1, 1)
    d = np.where((color == 0) == ((y & 1) == 1), 1, -1)
    c = np.arange(half).reshape(1, 1, -1)
    side = np.take_along_axis(o, np.broadcast_to((c + d) % half, o.shape),
                              axis=2)
    return np.stack([np.roll(o, 1, axis=1), np.roll(o, -1, axis=1), o,
                     side]).astype(np.int64)


def _states(shape, seed):
    g = np.random.default_rng(seed)
    return (g, *((g.integers(0, 2, size=shape, dtype=np.int8) * 2 - 1)
                 .astype(np.int8) for _ in range(2)))


def _check_against_plain(a, b, seeds, beta, na, nb, obs):
    """The replayed states and sums against multisweep_plain and against
    S plain phase pairs with the plain measure: bitwise, exactly."""
    wa, wb, wobs = i8ms.multisweep_plain(torch.from_numpy(a.copy()),
                                         torch.from_numpy(b.copy()), seeds,
                                         beta=beta)
    np.testing.assert_array_equal(na, wa.numpy())
    np.testing.assert_array_equal(nb, wb.numpy())
    np.testing.assert_array_equal(obs, wobs.numpy())
    pa, pb = torch.from_numpy(a.copy()), torch.from_numpy(b.copy())
    sums = []
    for s in range(seeds.shape[0]):
        pa = i2p.phase_plain(pa, pb, seeds[s, 0], color=0, beta=beta)
        pb = i2p.phase_plain(pb, pa, seeds[s, 1], color=1, beta=beta)
        sums.append(i8m.measure_sums_plain(pa, pb))
    np.testing.assert_array_equal(na, pa.numpy())
    np.testing.assert_array_equal(nb, pb.numpy())
    np.testing.assert_array_equal(obs, torch.stack(sums, dim=1).numpy())


def test_flip_bytes_are_the_scalar_rule():
    """The byte-SIMD flip and fused energy term against the scalar rule:
    every K differing neighbours (0 .. 4) and every word position relative
    to the thresholds (below t8, in [t8, t4), at or above t4), a byte each,
    with the other bytes of the word any of the cases."""
    beta = 1 / KBT
    t4, t8 = i2p.accept_thresholds_u32(beta)
    cases = [(kk, w) for kk in range(5) for w in (0, t8, t4)]
    g = np.random.default_rng(3)
    for _ in range(40):
        pick = [cases[i] for i in g.integers(0, len(cases), 4)]
        k2 = sum(np.uint64(2 * kk) << np.uint64(8 * i)
                 for i, (kk, _) in enumerate(pick))
        lv = sum(np.uint64(int(w < t4) + int(w < t8)) << np.uint64(8 * i)
                 for i, (_, w) in enumerate(pick))
        f = flip_bytes(np.uint64(k2), np.uint64(lv))
        for i, (kk, w) in enumerate(pick):
            k = 4 - 2 * kk
            want = k <= 0 or w < (t4 if k == 2 else t8)
            assert int(_byte(f, i)) == int(want)
            # the fused term 2K' of the new spin: K, or 4 - K if it flipped
            kp2 = np.uint64(k2) ^ ((np.uint64(k2) ^ (np.uint64(0x08080808)
                                                      - np.uint64(k2)))
                                   & (f * np.uint64(0xFF)))
            assert int(_byte(kp2, i)) == 2 * (4 - kk if want else kk)


@pytest.mark.parametrize("nrep,nty,nch", [(16, 32, 1), (1, 500, 1),
                                          (2, 4, 2), (5, 1, 3)])
def test_walk_visits_every_tile_once(nrep, nty, nch):
    for blocks in {1, 7, 132, 528, 1056, nrep * nty * nch}:
        blocks = min(blocks, nrep * nty * nch)
        seen = sorted(t[1:] for t in walk(blocks, nrep, nty, nch))
        assert seen == [(r, y, c) for r in range(nrep) for y in range(nty)
                        for c in range(nch)]


def test_tiles_cover_shapes():
    """The constants: whole-row tiles up to CHUNK_COLS columns, chunks past
    them; rows a multiple of THREADS / 2^lux; ranges in order, 16-B
    aligned, inside 48 KB; each accepted by check_ms_tiles; the clock
    multisweep takes the same."""
    assert c8ms.ms_tiles is i8ms.ms_tiles
    t = i8ms.ms_tiles(16, 1000, 500)
    assert (t["rows"], t["lux"], t["cw"], t["nch"], t["nty"]) == (32, 5, 500,
                                                                  1, 32)
    t = i8ms.ms_tiles(1, 1000, 500)
    assert (t["rows"], t["lux"], t["nty"]) == (2, 7, 500)
    t = i8ms.ms_tiles(1, 4, 4102)
    assert (t["rows"], t["lux"], t["cw"], t["nch"]) == (1, 8, 4096, 2)
    for nrep, ny, half in ((1, 2, 1), (2, 12, 5), (1, 33, 500), (3, 7, 1024),
                           (1, 9, 1025), (2, 3, 4096), (1, 4, 9000),
                           (8, 4000, 2000), (16, 1000, 500), (64, 1000, 500)):
        t = i8ms.ms_tiles(nrep, ny, half)
        assert t["rows"] % (i8ms.THREADS >> t["lux"]) == 0
        assert t["nch"] * t["cw"] >= half and t["nty"] * t["rows"] >= ny
        assert list(t["buf"]) == sorted(t["buf"]) and t["smem"] <= 48 * 1024
        i8ms.check_ms_tiles(t, ny, half)
        assert list(i8ms._tiles_arg(nrep, ny, half)) == [
            t["rows"], t["lux"], t["cw"], t["nch"], t["nty"], *t["buf"],
            t["smem"]]


@pytest.mark.parametrize("field,change", [
    ("rows", lambda t: t["rows"] + 1), ("lux", lambda t: 9),
    ("cw", lambda t: t["cw"] + 4), ("nty", lambda t: t["nty"] - 1),
    ("buf", lambda t: (t["buf"][0] + 8, *t["buf"][1:])),
    ("smem", lambda t: t["smem"] - 16)])
def test_bad_constants_are_refused(field, change):
    """Constants the launch cannot run on, refused before a launch."""
    t = dict(i8ms.ms_tiles(16, 1000, 500))
    t[field] = change(t)
    with pytest.raises(ValueError, match="tiles"):
        i8ms.check_ms_tiles(t, 1000, 500)


@pytest.mark.parametrize("offsets", [(0, 0), (3, 3), (7, 12)])
@pytest.mark.parametrize("shape", SHAPES)
def test_replay_equals_plain_multisweep(shape, offsets):
    """S sweeps through the replayed tiles: every site stored once a
    phase, every neighbour read at its pre-phase value; the states equal
    multisweep_plain and S plain phase pairs bitwise, the sums the plain
    fused sums and the plain measure exactly."""
    g, a, b = _states(shape, 31 * sum(shape) + offsets[0])
    seeds = multispin_rng.sweep_phase_keys(
        rng.sample_key(rng.base_key(5), 2), SWEEPS, 7)
    beta = 1 / KBT
    na, nb, obs, reads = replay(a, b, seeds, beta=beta, offsets=offsets,
                                gen=g)
    for k, (po, read) in enumerate(reads):
        np.testing.assert_array_equal(read, _plain_reads(po, k % 2))
    _check_against_plain(a, b, seeds, beta, na, nb, obs)


@pytest.mark.parametrize("beta", [0.1, 1e3])
def test_replay_at_other_temperatures(beta):
    """The rule where almost every site flips (beta 0.1) and where none
    that costs energy does (beta 1e3, t4 = t8 = 0)."""
    shape = (2, 12, 5)
    g, a, b = _states(shape, 11)
    seeds = multispin_rng.sweep_phase_keys(rng.base_key(13), SWEEPS)
    na, nb, obs, _ = replay(a, b, seeds, beta=beta, offsets=(3, 0), gen=g)
    _check_against_plain(a, b, seeds, beta, na, nb, obs)


def test_replay_on_the_class_tiles():
    """The resident class's tile shape (ms_tiles at 1000^2 x 16) on a
    shorter replica: the same checks as above."""
    shape = (1, 70, 500)
    t = dict(i8ms.ms_tiles(16, 1000, 500), nty=3)
    assert (t["rows"], t["lux"]) == (32, 5)
    g, a, b = _states(shape, 17)
    seeds = multispin_rng.sweep_phase_keys(rng.base_key(21), SWEEPS)
    na, nb, obs, reads = replay(a, b, seeds, beta=1 / KBT, gen=g, tiles=t,
                                offsets=(3, 0))
    for k, (po, read) in enumerate(reads):
        np.testing.assert_array_equal(read, _plain_reads(po, k % 2))
    _check_against_plain(a, b, seeds, 1 / KBT, na, nb, obs)


def test_replay_is_independent_of_the_grid():
    """The states and sums do not depend on which block takes a tile: one
    block or every tile its own block give the same."""
    shape = (2, 12, 5)
    _, a, b = _states(shape, 3)
    seeds = multispin_rng.sweep_phase_keys(rng.base_key(9), SWEEPS)
    one = replay(a, b, seeds, beta=1 / KBT, blocks=1)
    t = i8ms.ms_tiles(*shape)
    every = replay(a, b, seeds, beta=1 / KBT,
                   blocks=shape[0] * t["nty"] * t["nch"])
    for x, y in zip(one[:3], every[:3]):
        np.testing.assert_array_equal(x, y)
