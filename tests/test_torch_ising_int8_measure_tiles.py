"""The int8 Ising measure kernel's tiles, replayed on the CPU.

``csrc/ising2d_measure_pallas.cu`` ``measure_kernel`` sums the exact (m,
e) of (R, ny, half) int8 planes or (R, nz, ny, half) volumes in tiles of
whole rows of one plane (chunks of a row past ``CHUNK_COLS`` columns),
from the constants the wrapper passes (``i8m.measure_tiles``).  These
tests walk that launch in numpy, block by block and thread by thread,
from the same constants: the byte ranges a tile stages (both colours'
tile rows, the row after the tile, and in 3-D the tile's rows of plane
z + 1), copied into a shared-memory image from the 16-B aligned vectors
that cover them at the tensors' real byte offsets; the four-byte windows
each unit reads there (two aligned words and a funnel shift), the right
window one byte on with the row's wrap patched into its end byte; the
ragged tail's mask; and the sums four sites a word, ``__dp4a`` emulated
on int32.

Every site must be summed exactly once and read its right, down and back
neighbours at the indices the plain version reads; the sums must equal
``i8m.measure_sums_plain`` bitwise and, through it, the JAX models' exact
sums (``tests/test_torch_ising_int8.py``'s oracle).

Shapes: 2-D and 3-D, half % 4 in {0, 1, 2, 3}, ny = 2 and nz = 2 (the
least the wrapper admits), several replicas, rows past the chunk width
(half 4102 and 4100: two chunks, a masked last unit); tensors at an
aligned address and a few bytes past one.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_ising3d_int8_tiles import Tensor, _byte, _funnel, _spins

from cuda_fortran_mc_simulation_spin_tpu.models.base import (
    CheckerboardState as JaxState,
)
from cuda_fortran_mc_simulation_spin_tpu.models.ising2d import (
    Ising2D as JaxIsing2D,
)
from cuda_fortran_mc_simulation_spin_tpu.models.ising3d import (
    Ising3D as JaxIsing3D,
)
from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
    ising2d_measure_pallas as i8m,
)
from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
    ising2d_pallas as i2p,
)
from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
    ising3d_pallas as i3p,
)

M32 = 0xFFFFFFFF
SHAPES_2D = [(3, 2, 5), (2, 6, 6), (2, 4, 8), (1, 34, 63), (1, 2, 4102)]
SHAPES_3D = [(2, 2, 2, 3), (1, 4, 6, 250), (2, 2, 4, 9), (1, 2, 2, 4100)]
# the smoke's launches of the kernel (R, [nz,] ny, half): 130x126 x 3,
# 10x12x14 x 2, the int8 classes' 1000^2 x 16, 4000^2 x 8, 1000^2 x 1
# and 500^3 x 2, and its edge checks (chip_smoke.INT8_MEASURE_EDGES)
SMOKE_LAUNCHES = [(3, 126, 63), (2, 14, 12, 5), (16, 1000, 500),
                  (8, 4000, 2000), (1, 1000, 500), (2, 500, 500, 250),
                  (2, 2, 4102), (1, 2, 2, 4100), (2, 4, 6, 250)]


def _dp4a(u, v) -> np.ndarray:
    """__dp4a(u, v, 0): the sum of the four signed byte products of
    uint32 words (uint64 arrays)."""
    total = np.zeros(np.shape(u), np.int64)
    for k in range(4):
        bu = _byte(u, k).view(np.int8).astype(np.int64)
        bv = _byte(v, k).view(np.int8).astype(np.int64)
        total += bu * bv
    return total


def replay(a, b, offsets=(0, 0), tiles=None):
    """measure_kernel on numpy colour planes a, b (int8 (R, ny, half) or
    (R, nz, ny, half)); ``offsets`` the tensors' byte offsets mod 16;
    ``tiles`` the constants (measure_tiles of the shape by default).  A
    block's shared memory persists along a replica's run of planes, the
    two tile slots swapping from plane to plane.  Returns ((R, 2) int64
    (m, e), the number of times each site was summed, the six neighbours
    each site read: a's right, down, back, b's right, down, back)."""
    dims = a.ndim - 1
    if dims == 2:
        a, b = a[:, None], b[:, None]
    nrep, nz, ny, half = a.shape
    t = tiles or i8m.measure_tiles(nz, ny, half, dims)
    rows, lux, cw, nch, nty, zrun, nzg = (
        t[k] for k in ("rows", "lux", "cw", "nch", "nty", "zrun", "nzg"))
    assert nzg * zrun >= nz > (nzg - 1) * zrun and (dims == 3 or zrun == 1)
    buf, ux = t["buf"], 1 << lux
    tr = i2p.THREADS >> lux
    assert rows % tr == 0 and t["smem"] <= 48 * 1024
    ten = {"a": Tensor(a, offsets[0]), "b": Tensor(b, offsets[1])}
    flat = {"a": a.view(np.uint8).ravel(), "b": b.view(np.uint8).ravel()}
    plane = ny * half
    obs = np.zeros((nrep, 2), np.int64)
    seen = np.zeros(a.shape, np.int64)
    read = np.full((6,) + a.shape, 99, np.int64)
    gen = np.random.default_rng(1)
    nbuf = 6 if dims == 3 else 4
    # the room of each buffer: up to the next one's guard, or the end
    ends = dict(zip(buf[:nbuf], [*(buf[k + 1] - 16 for k in range(nbuf - 1)),
                                 t["smem"]]))
    for bx in range(nch):
        c0 = bx * cw
        ncw = min(cw, half - c0)
        cnext = 0 if c0 + ncw == half else c0 + ncw
        for by in range(min(nty, 65535)):
            for bg in range(min(nzg, 65535)):
                for g in range(bg, nzg, 65535):
                    z0, z1 = g * zrun, min(g * zrun + zrun, nz)
                    for yt in range(by, nty, 65535):
                        y0 = yt * rows
                        nr = min(rows, ny - y0)
                        lx = (nr - 1) * half + ncw
                        yd = 0 if y0 + nr == ny else y0 + nr
                        at, dn = y0 * half + c0, yd * half + c0
                        for r in range(nrep):
                            sm = gen.integers(0, 256, t["smem"],
                                              dtype=np.uint8)

                            def stage(c, start, ln, at_):
                                """cp.async of tensor c's bytes [start,
                                start + ln) to sm[at_ + sh], sh the
                                start's offset mod 16 (returned)."""
                                s = (ten[c].off + start) % 16
                                nv = (s + ln + 15) // 16
                                # the vectors, and the 8 bytes past them
                                # a window's second word may reach, fit
                                assert at_ + 16 * nv + 8 <= ends[at_]
                                sm[at_:at_ + 16 * nv] = ten[c].vectors(
                                    start - s, nv)
                                return s

                            rep = r * nz * plane
                            cur = [buf[0], buf[1]]
                            nxt = [buf[4], buf[5]]
                            sh = [stage(c, rep + z0 * plane + at, lx, p)
                                  for c, p in zip("ab", cur)]
                            shn = [0, 0]
                            for z in range(z0, z1):
                                zo = rep + z * plane
                                shd = [stage(c, zo + dn, ncw, buf[2 + k])
                                       for k, c in enumerate("ab")]
                                if dims == 3:
                                    zn = rep + (z + 1) % nz * plane + at
                                    shn = [stage(c, zn, lx, p)
                                           for c, p in zip("ab", nxt)]
                                slots = ([p + q for p, q in zip(cur, sh)]
                                         + [buf[2] + shd[0], buf[3] + shd[1]]
                                         + [p + q for p, q in zip(nxt, shn)])
                                _units(sm, t, slots, z, y0, nr, c0, ncw,
                                       cnext, half, tr, ux, dims, flat, zo,
                                       r, obs, seen, read)
                                cur, nxt, sh = nxt, cur, shn
    if dims == 2:
        seen, read = seen[:, 0], read[:, :, 0]
    return obs, seen, read


def _units(sm, t, slots, z, y0, nr, c0, ncw, cnext, half, tr, ux, dims,
           flat, zo, r, obs, seen, read):
    """One plane of one tile of one replica: every thread's units,
    vectorised; ``slots`` the shared-memory positions of the first bytes
    of a's and b's tile rows, their rows after the tile and (3-D) their
    back rows."""
    qa, qb, qad, qbd, qaz, qbz = slots
    ry, j = np.meshgrid(np.arange(nr), np.arange(-(-ncw // 4)),
                        indexing="ij")
    ry, j = ry.ravel(), j.ravel()
    tid = ((ry % tr) * ux) | (j % ux)
    assert len(set(zip(tid, ry // tr, j // ux))) == len(tid)
    y = y0 + ry
    odd = ((y + z) & 1).astype(bool)
    nv = np.minimum(4, ncw - 4 * j)
    row = ry * half
    pa, pb = qa + row, qb + row
    pad = np.where(ry == nr - 1, qad, pa + half)
    pbd = np.where(ry == nr - 1, qbd, pb + half)
    paz, pbz = qaz + row, qbz + row
    ps = np.where(odd, pb, pa)
    sw = sm.view("<u4").astype(np.uint64)

    def words(p):
        k = (p >> 2) + j
        assert (k + 1 < sw.size).all()
        return sw[k], sw[k + 1], 8 * (p & 3)

    def win(p):
        lo, hi, s = words(p)
        return _funnel(lo, hi, s)

    if t["nch"] == 1:
        wrap = sm[ps].astype(np.uint64)
    else:
        at = zo + y * half + cnext
        wrap = np.where(odd, flat["b"][at], flat["a"][at]).astype(np.uint64)
    sa, sb = win(pa), win(pb)
    lo, hi, s = words(ps)
    rt = _funnel(lo, hi, s + 8, clamp=True)
    last = 4 * j + nv == ncw
    k = np.where(last, nv - 1, 0).astype(np.uint64)
    patched = (rt & ~(np.uint64(0xFF) << (np.uint64(8) * k))) | \
        (wrap << (np.uint64(8) * k))
    rt = np.where(last, patched, rt) & np.uint64(M32)
    vm = np.where(nv == 4, M32, (1 << (8 * nv)) - 1).astype(np.uint64)
    sam, sbm = sa & vm, sb & vm
    ones = np.full_like(sa, 0x01010101)
    m = _dp4a(sam, ones) + _dp4a(sbm, ones)
    bd, ad = win(pbd), win(pad)
    bonds = (_dp4a(sam, sb) + _dp4a(np.where(odd, sam, sbm), rt)
             + _dp4a(sam, bd) + _dp4a(sbm, ad))
    nbrs = [np.where(odd, rt, sb), bd, None, np.where(odd, sa, rt), ad, None]
    if dims == 3:
        bz, az = win(pbz), win(paz)
        bonds += _dp4a(sam, bz) + _dp4a(sbm, az)
        nbrs[2], nbrs[5] = bz, az
    obs[r, 0] += int(m.sum())
    obs[r, 1] -= int(bonds.sum())
    cg = c0 + 4 * j
    for kk in range(4):
        ok = kk < nv
        seen[r, z, y[ok], cg[ok] + kk] += 1
        for q, w in enumerate(nbrs):
            if w is not None:
                read[q, r, z, y[ok], cg[ok] + kk] = _byte(
                    w[ok], kk).view(np.int8)


def _plain_neighbours(a, b):
    """The six neighbours the plain version reads at each site (volume
    axes (R, nz, ny, half)): a's right b[c + parity], down b[y + 1], back
    b[z + 1]; b's right a[c + 1 - parity], down, back (periodic)."""
    nrep, nz, ny, half = a.shape
    z = np.arange(nz).reshape(-1, 1, 1)
    y = np.arange(ny).reshape(1, -1, 1)
    c = np.arange(half).reshape(1, 1, -1)
    odd = (y + z) & 1
    ar = np.take_along_axis(b, np.broadcast_to((c + odd) % half, b.shape),
                            axis=3)
    br = np.take_along_axis(a, np.broadcast_to((c + 1 - odd) % half,
                                               a.shape), axis=3)
    return np.stack([ar, np.roll(b, -1, axis=2), np.roll(b, -1, axis=1), br,
                     np.roll(a, -1, axis=2), np.roll(a, -1, axis=1)])


def _jax_sums(a, b):
    """The JAX models' exact (magne_sum, energy_sum) of each replica."""
    if a.ndim == 3:
        model = JaxIsing2D(nx=2 * a.shape[-1], ny=a.shape[1],
                           kbt=2.26918531421, backend="jnp")
    else:
        model = JaxIsing3D(nx=2 * a.shape[-1], ny=a.shape[2], nz=a.shape[1],
                           kbt=4.51152, backend="jnp")
    states = [JaxState(jnp.asarray(a[r]), jnp.asarray(b[r]))
              for r in range(a.shape[0])]
    return [[int(model.magne_sum(s)), int(model.energy_sum(s))]
            for s in states]


@pytest.mark.parametrize("shape", SHAPES_2D + SHAPES_3D)
@pytest.mark.parametrize("offsets", [(0, 0), (3, 1)])
def test_replay_equals_plain_and_jax(shape, offsets):
    """Every site summed once, its neighbours the plain version's, the
    (m, e) of every replica measure_sums_plain's bitwise and the JAX
    models' exact sums."""
    g = np.random.default_rng(sum(shape) + offsets[0])
    a, b = _spins(g, shape), _spins(g, shape)
    obs, seen, read = replay(a, b, offsets)
    assert (seen == 1).all()
    vol = (lambda v: v) if a.ndim == 4 else (lambda v: v[:, None])
    want_read = _plain_neighbours(vol(a), vol(b)).astype(np.int64)
    if a.ndim == 3:
        want_read, read = want_read[[0, 1, 3, 4], :, 0], read[[0, 1, 3, 4]]
    np.testing.assert_array_equal(read, want_read)
    want = i8m.measure_sums_plain(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(obs, want.numpy())
    if shape[-1] < 1000:
        assert obs.tolist() == _jax_sums(a, b)


def test_tiles_thin_small_lattices_and_keep_the_phase_tiles_elsewhere():
    """measure_tiles: the phase's tiles where they give MEASURE_BLOCKS
    blocks and a warp a row (4000^2), 32 threads a row at 500^3 (its rows
    32, 8 KB) in runs of 3 planes (2672 blocks), thinner rows and more
    threads a row where the blocks are too few (1000^2 x 1: 500 blocks of
    2 rows, one unit a thread), chunks past CHUNK_COLS; ranges in order,
    16-B aligned, inside 48 KB; the 14 ints the kernel takes."""
    t, p = i8m.measure_tiles(1, 4000, 2000, 2), i3p.phase_tiles(4000, 2000)
    assert all(t[k] == p[k] for k in ("rows", "lux", "cw", "nch", "nty"))
    t = i8m.measure_tiles(500, 500, 250, 3)
    assert (t["rows"], t["lux"], t["nty"], t["zrun"], t["nzg"]) == (
        32, 5, 16, 3, 167)
    t = i8m.measure_tiles(1, 1000, 500, 2)
    assert (t["rows"], t["lux"], t["nty"]) == (2, 7, 500)
    t = i8m.measure_tiles(1, 3, 4102, 2)
    assert (t["rows"], t["cw"], t["nch"]) == (1, 4096, 2)
    for nz, ny, half, dims in ((1, 2, 1, 2), (2, 2, 3, 3), (1, 126, 63, 2),
                               (7, 9, 1025, 3), (2, 4, 100003, 3)):
        t = i8m.measure_tiles(nz, ny, half, dims)
        assert t["rows"] % (i2p.THREADS >> t["lux"]) == 0
        assert t["nch"] * t["cw"] >= half and t["nty"] * t["rows"] >= ny
        assert t["nzg"] * t["zrun"] >= nz > (t["nzg"] - 1) * t["zrun"]
        assert dims == 3 or t["zrun"] == 1
        used = t["buf"][:6 if dims == 3 else 4]
        assert all(x % 16 == 0 for x in used) and list(used) == sorted(used)
        assert t["buf"][len(used):] == (0,) * (6 - len(used))
        assert t["smem"] <= 48 * 1024
        assert list(i8m._tiles_arg(nz, ny, half, dims)) == [
            t["rows"], t["lux"], t["cw"], t["nch"], t["nty"], t["zrun"],
            t["nzg"], *t["buf"], t["smem"]]


@pytest.mark.parametrize("shape,zrun", [((1, 7, 4, 9), 3), ((2, 5, 6, 250), 2),
                                        ((1, 3, 2, 4100), 2),
                                        ((1, 2, 3, 5), 2)])
def test_replay_walks_runs_of_planes(shape, zrun):
    """Runs of several planes a block (a short last run, a run that wraps
    to plane 0's rows as its last back plane, chunks): the slots swap from
    plane to plane and the replay still sums every site once with the
    plain neighbours, equal to measure_sums_plain."""
    g = np.random.default_rng(sum(shape) + zrun)
    a, b = _spins(g, shape), _spins(g, shape)
    t = dict(i8m.measure_tiles(*shape[1:], 3), zrun=zrun,
             nzg=-(-shape[1] // zrun))
    obs, seen, read = replay(a, b, (3, 6), tiles=t)
    assert (seen == 1).all()
    np.testing.assert_array_equal(read, _plain_neighbours(a, b))
    want = i8m.measure_sums_plain(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(obs, want.numpy())


@pytest.mark.parametrize("launch", SMOKE_LAUNCHES)
def test_smoke_launches_tile_every_row(launch):
    """At each launch the smoke makes: the tiles cover every row, plane
    and column once, and every staged range with its 32 bytes of room fits
    before the next."""
    dims = len(launch) - 1
    nz, ny, half = (1, *launch[1:]) if dims == 2 else launch[1:]
    t = i8m.measure_tiles(nz, ny, half, dims)
    starts = [yt * t["rows"] for yt in range(t["nty"])]
    assert starts[-1] < ny <= starts[-1] + t["rows"]
    assert t["nzg"] * t["zrun"] >= nz > (t["nzg"] - 1) * t["zrun"]
    assert t["nch"] * t["cw"] >= half > (t["nch"] - 1) * t["cw"]
    lx = (t["rows"] - 1) * half + min(t["cw"], half)
    need = [lx, lx, min(t["cw"], half), min(t["cw"], half), lx, lx]
    nbuf = 6 if dims == 3 else 4
    for k in range(nbuf):
        end = t["buf"][k + 1] - 16 if k + 1 < nbuf else t["smem"]
        assert t["buf"][k] + i3p.span_bytes(need[k]) <= end
