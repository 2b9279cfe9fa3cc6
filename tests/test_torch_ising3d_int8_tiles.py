"""The int8 3-D phase kernel's tiles, replayed on the CPU.

``csrc/ising3d_pallas.cu`` ``tile_kernel`` runs one colour phase of (R,
nz, ny, half) int8 volumes in tiles of whole rows of one plane (chunks of
a row past ``i3p.CHUNK_COLS`` columns), from the constants the wrapper
passes (``i3p.phase_tiles``).  These tests walk that launch in numpy,
block by block and thread by thread, from the same constants: the six
byte ranges a tile stages (its sites, the other colour at z, z - 1, z + 1
or the halo planes, and the rows before and after it), copied into a
shared-memory image from the 16-B aligned vectors that cover them at the
tensors' real byte offsets; the four-byte windows each unit reads from
that image (two aligned words and a funnel shift), the row's wrap patched
into the side window; the Philox counter and round keys of each unit, or
its injected words; the byte-SIMD count and acceptance; the stores into
the image and the write-back in aligned vectors and ragged bytes.

Every site must be stored exactly once, by the block that holds it, and
no byte outside the blocks' ranges (or the tensor) written; every
neighbour a site reads must be the pre-phase value at the index the plain
version reads; the phase through the windows must equal
``i3p.phase_plain`` (``i3p.sharded_phase_plain`` in the halo mode)
bitwise, and JAX's 3-D stencil with the three-threshold rule, as
tests/test_torch_ising_int8.py runs it; the halo mode's fused (m, e) must
equal the plain partials exactly.

Shapes (R, nz, ny, half): (2, 14, 12, 5) (half % 4 = 1: rows off the
4-byte grid, a masked last unit), (1, 2, 40, 250) (the 500^3 class's
rows, two apart mod 4, a partial last tile), (1, 2, 3, 4102) (chunks, a
masked last unit), a z-shard (2, 3, 6, 7) with its halo planes at global
offsets (1, 5); tensors at an aligned address and 3 bytes past one.
"""

import numpy as np
import pytest
import torch
from test_torch_ising_int8 import _jax_phase

from cuda_fortran_mc_simulation_spin_tpu.core import (
    tables as jtables,
)
from cuda_fortran_mc_simulation_spin_tpu_torch.core import rng, tables
from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
    ising2d_pallas as i2p,
)
from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
    ising3d_pallas as i3p,
)

KBT_3D = 4.51152
M32 = 0xFFFFFFFF
W0, W1 = 0x9E3779B9, 0xBB67AE85
M0, M1 = 0xD2511F53, 0xCD9E8D57
SIGN = 0x02020202
SHAPES = [(2, 14, 12, 5), (1, 2, 40, 250), (1, 2, 3, 4102)]


def round_keys(key) -> list[tuple[int, int]]:
    """csrc/philox.cuh philox_round_keys: round r's key (s0 + r W0, s1 +
    r W1) mod 2^32."""
    s0, s1 = (int(v) & M32 for v in key)
    return [((s0 + r * W0) & M32, (s1 + r * W1) & M32) for r in range(10)]


def philox_rk(ctr: np.ndarray, rk) -> np.ndarray:
    """csrc/philox.cuh philox_rk on uint64 counters (..., 4): ten rounds
    under the given round keys."""
    c = [ctr[..., i].astype(np.uint64) for i in range(4)]
    for kx, ky in rk:
        p0, p1 = np.uint64(M0) * c[0], np.uint64(M1) * c[2]
        hi0, lo0 = p0 >> np.uint64(32), p0 & np.uint64(M32)
        hi1, lo1 = p1 >> np.uint64(32), p1 & np.uint64(M32)
        c = [hi1 ^ c[1] ^ np.uint64(kx), lo1, hi0 ^ c[3] ^ np.uint64(ky),
             lo0]
    return np.stack(c, axis=-1)


def _spins(g, shape):
    return (g.integers(0, 2, size=shape, dtype=np.int8) * 2 - 1).astype(
        np.int8)


class Tensor:
    """A tensor's bytes in a 16-B aligned allocation, ``off`` bytes past
    its start (the tensor's data_ptr mod 16), the allocation filled to the
    next 16-B boundary with bytes no site holds."""

    def __init__(self, arr: np.ndarray, off: int):
        raw = np.ascontiguousarray(arr).view(np.uint8).ravel()
        self.off, self.n = off, raw.size
        self.mem = np.full(-(-(off + raw.size) // 16) * 16, 0x5A, np.uint8)
        self.mem[off:off + raw.size] = raw

    def vectors(self, start: int, nv: int) -> np.ndarray:
        """The nv aligned 16-B vectors from byte ``start`` of the
        tensor (start + off a multiple of 16), which must lie in the
        allocation."""
        a = self.off + start
        assert a % 16 == 0 and a >= 0 and a + 16 * nv <= self.mem.size
        return self.mem[a:a + 16 * nv]


def _funnel(lo, hi, sh, clamp=False):
    """__funnelshift_r(lo, hi, sh) (__funnelshift_rc with ``clamp``) on
    uint64 arrays of 32-bit words."""
    sh = np.asarray(sh, dtype=np.uint64)
    sh = np.minimum(sh, 32) if clamp else sh & np.uint64(31)
    return (((hi << np.uint64(32)) | lo) >> sh) & np.uint64(M32)


def _byte(w, k):
    return ((w >> np.uint64(8 * k)) & np.uint64(0xFF)).astype(np.uint8)


def _as_i8(b):
    return b.astype(np.uint8).view(np.int8)


def replay(x, o, *, color, beta, seeds=None, bits=None, halos=None,
           offs=(0, 0), measuring=False, offsets=(0, 0, 0), gen=None):
    """tile_kernel on numpy volumes x, o (int8 (R, nz, ny, half)); halos
    (zm, zp) the halo mode's planes at global offs = (rep0, z0);
    ``offsets`` the byte offsets mod 16 of x, o and the halos.  Returns
    (new x, (m, e) per replica, the per-site neighbours read)."""
    nrep, nz, ny, half = x.shape
    t = i3p.phase_tiles(ny, half)
    rows, lux, cw, nch, nty = (t[k] for k in ("rows", "lux", "cw", "nch",
                                              "nty"))
    buf, ux = t["buf"], 1 << lux
    tr = i2p.THREADS >> lux
    assert rows % tr == 0 and t["smem"] <= 48 * 1024
    halo = halos is not None
    rep0, z0 = offs if halo else (0, 0)
    xt, ot = Tensor(x, offsets[0]), Tensor(o, offsets[1])
    ht = [Tensor(h, offsets[2]) for h in halos] if halo else None
    t4, t8, t12 = tables.ising3d_accept_thresholds_u32(beta)
    assert t12 <= t8 <= t4
    rk = round_keys(seeds) if bits is None else None
    plane = ny * half
    writes = np.zeros(xt.mem.size, np.int64)
    owner = np.full(xt.mem.size, -1, np.int64)
    obs = np.zeros((nrep, 2), np.int64)
    read = np.full((6,) + x.shape, 99, np.int64)
    gen = gen or np.random.default_rng(0)
    blocks = [(bx, by, bz) for bx in range(nch)
              for by in range(min(nty, 65535)) for bz in range(min(nz, 65535))]
    for bid, (bx, by, bz) in enumerate(blocks):
        c0 = bx * cw
        ncw = min(cw, half - c0)
        clo, chi = (c0 - 1 if c0 > 0 else 0), min(c0 + ncw + 1, half)
        for z in range(bz, nz, 65535):
            zm, zp = (z - 1) % nz, (z + 1) % nz
            zg = z0 + z
            for yt in range(by, nty, 65535):
                y0 = yt * rows
                nr = min(rows, ny - y0)
                lx = (nr - 1) * half + ncw
                lc = (nr - 1) * half + chi - clo
                yu, yd = (y0 - 1) % ny, (y0 + nr) % ny
                for r in range(nrep):
                    zo = (r * nz + z) * plane
                    at = y0 * half + c0
                    # (tensor, first byte, length) of the six ranges
                    src_m = ((ht[0], r * plane + at) if halo and z == 0
                             else (ot, (r * nz + zm) * plane + at))
                    src_p = ((ht[1], r * plane + at) if halo and z == nz - 1
                             else (ot, (r * nz + zp) * plane + at))
                    spans = [(xt, zo + at, lx),
                             (ot, zo + y0 * half + clo, lc),
                             (*src_m, lx), (*src_p, lx),
                             (ot, zo + yu * half + c0, ncw),
                             (ot, zo + yd * half + c0, ncw)]
                    sm = gen.integers(0, 256, t["smem"], dtype=np.uint8)
                    sh = []
                    ends = [*(b - 16 for b in buf[1:]), t["smem"]]
                    for (ten, start, ln), b, end in zip(spans, buf, ends):
                        s = (ten.off + start) % 16
                        nv = (s + ln + 15) // 16
                        # the vectors, and the 8 bytes past them a
                        # window's second word may reach, fit its room
                        assert b + 16 * nv + 8 <= end
                        sm[b:b + 16 * nv] = ten.vectors(start - s, nv)
                        sh.append(s)
                    shx, shc, shm, shp, shu, shd = sh
                    # every thread's units: thread (ty, tx) takes
                    # units tx, tx + ux, ... of rows ty, ty + tr, ...
                    ty, j = np.meshgrid(np.arange(nr),
                                        np.arange(-(-ncw // 4)),
                                        indexing="ij")
                    ty, j = ty.ravel(), j.ravel()
                    tid = ((ty % tr) << lux) | (j % ux)
                    assert len(set(zip(tid, ty // tr, j // ux))) == len(tid)
                    y = y0 + ty
                    cg = c0 + 4 * j
                    nv = np.minimum(4, c0 + ncw - cg)
                    d = np.where(((zg + y) & 1) ^ color, 1, -1)
                    row = ty * half
                    px = buf[0] + shx + row
                    pc = buf[1] + shc + row + (c0 - clo) + np.where(d < 0,
                                                                    -1, 0)
                    pu = np.where(ty == 0, buf[4] + shu,
                                  buf[1] + shc + row - half + (c0 - clo))
                    pd = np.where(ty == nr - 1, buf[5] + shd,
                                  buf[1] + shc + row + half + (c0 - clo))
                    pm = buf[2] + shm + row
                    pp = buf[3] + shp + row
                    sw = sm.view("<u4").astype(np.uint64)

                    def words(p):
                        k = (p >> 2) + j
                        return sw[k], sw[k + 1], 8 * (p & 3)

                    def win(p):
                        lo, hi, s = words(p)
                        return _funnel(lo, hi, s)

                    xv = win(px)
                    lo, hi, sc = words(pc)
                    lower = _funnel(lo, hi, sc)
                    upper = _funnel(lo, hi, sc + 8, clamp=True)
                    orow = (r * nz + z) * plane + y * half
                    o_flat = o.view(np.uint8).ravel()
                    fix_r = (d > 0) & (cg + 3 >= half - 1) & (cg <= half - 1)
                    fix_l = (d < 0) & (cg == 0)
                    kb = np.where(fix_r, half - 1 - cg, 0)
                    for i in np.flatnonzero(fix_r):
                        w = int(upper[i]) & ~(0xFF << (8 * kb[i]))
                        upper[i] = w | (int(o_flat[orow[i]]) << (8 * kb[i]))
                    for i in np.flatnonzero(fix_l):
                        w = int(lower[i]) & ~0xFF
                        lower[i] = w | int(o_flat[orow[i] + half - 1])
                    nb = [lower, upper, win(pu), win(pd), win(pm), win(pp)]
                    # the neighbours each site read: centre, side, up,
                    # down, z - 1, z + 1
                    centre = np.where(d > 0, lower, upper)
                    side = np.where(d > 0, upper, lower)
                    for k in range(4):
                        ok = k < nv
                        for q, w in enumerate((centre, side, nb[2], nb[3],
                                               nb[4], nb[5])):
                            read[q, r, z, y[ok], cg[ok] + k] = _as_i8(
                                _byte(w[ok], k))
                    k2 = np.zeros_like(xv)
                    for w in nb:
                        k2 += (xv ^ w) & np.uint64(SIGN)
                    if bits is not None:
                        lv = np.zeros_like(xv)
                        for k in range(4):
                            ok = k < nv
                            wk = bits[r, z, y[ok], cg[ok] + k].astype(
                                np.uint64)
                            lv[ok] |= ((wk < t4).astype(np.uint64)
                                       + (wk < t8) + (wk < t12)) << \
                                np.uint64(8 * k)
                    else:
                        ctr = np.stack([np.full_like(y, rep0 + r),
                                        zg * ny + y, cg >> 2,
                                        np.zeros_like(y)], axis=-1)
                        wv = philox_rk(ctr.astype(np.uint64), rk)
                        lv = np.zeros_like(xv)
                        for k in range(4):
                            wk = wv[..., k]
                            lv |= ((wk < t4).astype(np.uint64) + (wk < t8)
                                   + (wk < t12)) << np.uint64(8 * k)
                    f = ((k2 + np.uint64(2) * lv + np.uint64(0x0A0A0A0A))
                         >> np.uint64(4)) & np.uint64(0x01010101)
                    nxv = xv ^ (f * np.uint64(0xFE))
                    for k in range(4):
                        ok = k < nv
                        sm[px[ok] + 4 * j[ok] + k] = _byte(nxv[ok], k)
                    if measuring:
                        vm = np.where(nv == 4, M32,
                                      (1 << (8 * nv)) - 1).astype(np.uint64)
                        pc_ = np.array([bin(int(v)).count("1") for v in
                                        (nxv & np.uint64(SIGN) & vm)])
                        po_ = np.array([bin(int(v)).count("1") for v in
                                        (centre & np.uint64(SIGN) & vm)])
                        obs[r, 0] += int((2 * nv - 2 * (pc_ + po_)).sum())
                        kp2 = k2 ^ ((k2 ^ (np.uint64(0x0C0C0C0C) - k2))
                                    & (f * np.uint64(0xFF)))
                        bsum = ((((kp2 & vm) * np.uint64(0x01010101))
                                 & np.uint64(M32)) >> np.uint64(24))
                        obs[r, 1] += int((bsum.astype(np.int64)
                                          - 6 * nv).sum())
                    # the write-back: whole vectors in the range, bytes
                    # at its ragged ends
                    start = zo + at
                    a = xt.off + start - shx
                    for v in range((shx + lx + 15) // 16):
                        lo_b = 16 * v - shx
                        for b in range(16):
                            if 0 <= lo_b + b < lx:
                                writes[a + 16 * v + b] += 1
                                owner[a + 16 * v + b] = bid * nrep + r
                                xt.mem[a + 16 * v + b] = sm[buf[0] + 16 * v
                                                            + b]
    # every site written once, by the block (and replica turn) holding it
    sites = np.zeros(xt.mem.size, bool)
    sites[xt.off:xt.off + xt.n] = True
    assert (writes[sites] == 1).all() and (writes[~sites] == 0).all()
    r_, z_, y_, c_ = np.meshgrid(*(np.arange(n) for n in x.shape),
                                 indexing="ij")
    want_bid = ((c_ // cw) * min(nty, 65535) + (y_ // rows)) * min(
        nz, 65535) + z_
    assert np.array_equal(owner[sites].reshape(x.shape),
                          want_bid * nrep + r_)
    new = xt.mem[xt.off:xt.off + xt.n].view(np.int8).reshape(x.shape)
    return new, obs, read


def _plain_neighbours(o, color, halos=None, z0=0):
    """The six neighbours the plain version reads at each site: centre,
    side (c + d, d = +1 iff (z0 + z + y) & 1 differs from the colour),
    up, down, z - 1, z + 1 (periodic, or the halo planes)."""
    nrep, nz, ny, half = o.shape
    z = np.arange(nz).reshape(-1, 1, 1)
    y = np.arange(ny).reshape(1, -1, 1)
    d = np.where(((z0 + z + y) & 1) ^ color, 1, -1)
    c = np.arange(half).reshape(1, 1, -1)
    side = np.take_along_axis(
        o, np.broadcast_to((c + d) % half, o.shape), axis=3)
    zm = np.roll(o, 1, axis=1)
    zp = np.roll(o, -1, axis=1)
    if halos is not None:
        zm[:, :1], zp[:, -1:] = halos
    return np.stack([o, side, np.roll(o, 1, axis=2), np.roll(o, -1, axis=2),
                     zm, zp]).astype(np.int64)


def _inputs(shape, seed):
    g = np.random.default_rng(seed)
    x, o = _spins(g, shape), _spins(g, shape)
    u = g.integers(0, 2 ** 32, size=shape, dtype=np.uint64).astype(np.uint32)
    return g, x, o, u


def test_tiles_cover_shapes():
    """The constants: whole-row tiles up to CHUNK_COLS columns, chunks past
    them; rows a multiple of THREADS / 2^lux; ranges in order, 16-B
    aligned, inside 48 KB."""
    t = i3p.phase_tiles(500, 250)
    assert (t["rows"], t["lux"], t["cw"], t["nch"], t["nty"]) == (32, 3, 250,
                                                                  1, 16)
    t = i3p.phase_tiles(3, 4102)
    assert (t["rows"], t["lux"], t["cw"], t["nch"]) == (1, 8, 4096, 2)
    for ny, half in ((2, 1), (12, 5), (500, 500), (7, 1024), (9, 1025),
                     (3, 4096), (4, 9000), (2, 100003)):
        t = i3p.phase_tiles(ny, half)
        assert t["rows"] % (i2p.THREADS >> t["lux"]) == 0
        assert t["nch"] * t["cw"] >= half and t["nty"] * t["rows"] >= ny
        assert all(b % 16 == 0 for b in t["buf"])
        assert list(t["buf"]) == sorted(t["buf"]) and t["smem"] <= 48 * 1024
        assert list(i3p._tiles_arg(ny, half)) == [
            t["rows"], t["lux"], t["cw"], t["nch"], t["nty"], *t["buf"],
            t["smem"]]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("color", [0, 1])
@pytest.mark.parametrize("offsets", [(0, 0, 0), (3, 3, 3), (3, 0, 0)])
def test_replay_equals_plain_phase(shape, color, offsets):
    """Philox words: the replayed launch stores each site once, reads the
    plain version's neighbours, and equals phase_plain bitwise."""
    g, x, o, _ = _inputs(shape, sum(shape) + color)
    key = rng.seeds_from_key(rng.base_key(11), color)
    beta = 1 / KBT_3D
    new, _, read = replay(x, o, color=color, beta=beta, seeds=key,
                          offsets=offsets, gen=g)
    np.testing.assert_array_equal(read, _plain_neighbours(o, color))
    want = i3p.phase_plain(torch.from_numpy(x), torch.from_numpy(o), key,
                           color=color, beta=beta)
    np.testing.assert_array_equal(new, want.numpy())


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("color", [0, 1])
@pytest.mark.parametrize("beta", [1 / KBT_3D, 0.1, 1e3])
def test_replay_with_injected_words_equals_plain_and_jax(shape, color, beta):
    """Injected words: the replay equals phase_plain and JAX's 3-D stencil
    with the three-threshold rule bitwise (three temperatures: every
    threshold taken, t4 near 2^32, t4 = t8 = t12 = 0)."""
    g, x, o, u = _inputs(shape, 7 * sum(shape) + color)
    new, _, _ = replay(x, o, color=color, beta=beta, bits=u,
                       offsets=(3, 0, 0), gen=g)
    bits = torch.from_numpy(u.view(np.int32).copy())
    want = i3p.phase_plain(torch.from_numpy(x), torch.from_numpy(o),
                           color=color, beta=beta, bits=bits)
    np.testing.assert_array_equal(new, want.numpy())
    jax_want = _jax_phase(x, o, color, u,
                          jtables.ising3d_accept_thresholds_u32(beta), 3)
    np.testing.assert_array_equal(new, jax_want)


@pytest.mark.parametrize("color,measuring", [(0, False), (1, True),
                                             (0, True)])
@pytest.mark.parametrize("offsets", [(0, 0, 0), (3, 3, 3)])
@pytest.mark.parametrize("injected", [False, True])
def test_replay_halo_mode(color, measuring, offsets, injected):
    """A z-shard (2, 3, 6, 7) at global offsets (1, 5) with its halo
    planes: the replay reads the halo planes past its first and last
    plane, keys parity and Philox by the global plane, equals
    sharded_phase_plain bitwise, and its fused (m, e) equal the plain
    partials exactly."""
    shape, offs = (2, 3, 6, 7), (1, 5)
    g, x, o, u = _inputs(shape, 40 + color + 2 * measuring)
    zm, zp = _spins(g, (2, 1, 6, 7)), _spins(g, (2, 1, 6, 7))
    key = rng.seeds_from_key(rng.base_key(13), color)
    beta = 1 / KBT_3D
    new, obs, read = replay(x, o, color=color, beta=beta, seeds=key,
                            bits=u if injected else None, halos=(zm, zp),
                            offs=offs, measuring=measuring,
                            offsets=offsets, gen=g)
    np.testing.assert_array_equal(
        read, _plain_neighbours(o, color, (zm, zp), offs[1]))
    bits = torch.from_numpy(u.view(np.int32).copy()) if injected else None
    want = i3p.sharded_phase_plain(
        torch.from_numpy(x), torch.from_numpy(o), torch.from_numpy(zm),
        torch.from_numpy(zp), key, offs, color=color, beta=beta, bits=bits,
        measuring=measuring)
    if measuring:
        want, m, e = want
        np.testing.assert_array_equal(obs, torch.stack([m, e], 1).numpy())
    np.testing.assert_array_equal(new, want.numpy())


def test_round_keys_drive_the_plain_philox():
    """philox_rk under philox_round_keys(key) equals core/rng.philox4x32
    under key, on the counters of a tile's units."""
    key = rng.seeds_from_key(rng.base_key(3), 1)
    ctr = np.array([[1, 5 * 12 + 3, 7, 0], [0, 2 ** 31, 2 ** 32 - 1, 0]],
                   np.uint64)
    got = philox_rk(ctr, round_keys(key))
    want = rng.philox4x32(torch.from_numpy(ctr.astype(np.int64)), key)
    np.testing.assert_array_equal(got.astype(np.int64), want.numpy())
