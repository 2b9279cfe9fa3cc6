"""The int8 2-D Ising phase kernel's tiles, replayed on the CPU.

``csrc/ising2d_pallas.cu`` ``phase_kernel`` runs one colour phase of (R,
ny, half) int8 ±1 planes, one tile a block, on the tile body it shares
with the cooperative multisweep (``csrc/ising_int8.cuh`` ``tile``): whole
rows of one replica (chunks of a row past ``CHUNK_COLS`` columns), from
the constants the wrapper passes (``ising2d_pallas.phase_tiles``:
``ising2d_multisweep.ms_tiles`` at ``TILE_BYTES`` a tile, checked by
``check_ms_tiles``).  These tests walk that launch in numpy through the
multisweep test's replay of the tile body
(``test_torch_ising_int8_ms_tiles.replay_phase``), block by block and
thread by thread: the grid (chunks, row tiles, replicas) and its walk
over row tiles gridDim.y apart, the four byte ranges a tile stages (its
sites, the other colour's rows y0 .. widened a column each side in a
chunk, and the rows before and after it, wrapped or, in the halo mode,
the halo rows at the shard's edges), copied into a shared-memory image
from the 16-B aligned vectors that cover them at the tensors' real byte
offsets; the four-byte windows each word of four sites reads there, the
row's wrap or the column halo patched into the side window; at col0 % 4
!= 0 the words col0 % 4 columns early; each word's Philox call at the
global counter under the phase's round keys, or the injected words; the
byte-SIMD rule and each thread's stores of its word's new bytes to the
tensor; and the measuring halo mode's fused int64 (m, e), a tile's
atomic adds.

Every site must be stored exactly once, by the tile holding it, and no
byte outside the tiles' ranges (or the tensor) written; every neighbour a
site reads must be the pre-phase value at the index the plain version
reads (the halos at the shard's edges); the phase must equal
``phase_plain`` (``sharded_phase_plain`` in the halo mode) bitwise, and
the sums the plain sums exactly.

Shapes (R, ny, half): (3, 130, 63) (a masked last unit, rows off the
4-byte grid), (1, 33, 250) (rows 2-B aligned, a partial last tile), (1, 4,
4102) (chunks, a masked last unit); tensors at an aligned address and 3
and 11 bytes past one; shards at col0 % 4 = 0 .. 3, with the column halos
and without them, one chunked; the streamed class's tiles (4000^2 x 8),
the samples class's (1000^2 x 1) and the mesh class's shard tiles on
shorter replicas; a grid shorter than the row tiles.
"""

import numpy as np
import pytest
import torch
from test_torch_ising3d_int8_tiles import Tensor, round_keys
from test_torch_ising_int8_ms_tiles import (
    _plain_reads,
    _states,
    replay_phase,
)

from cuda_fortran_mc_simulation_spin_tpu_torch.core import rng
from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
    ising2d_multisweep as i8ms,
)
from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
    ising2d_pallas as i2p,
)
from cuda_fortran_mc_simulation_spin_tpu_torch.ops import multispin_rng

KBT = 2.269185314213022
SHAPES = [(3, 130, 63), (1, 33, 250), (1, 4, 4102)]
MAX_GRID = 65535
M32 = 0xFFFFFFFF


def phase_order(nrep: int, nty: int, nch: int, grid_y: int = MAX_GRID
                ) -> list:
    """The tiles (r, yt, cx) the phase kernel's blocks take: a grid
    (chunks, min(row tiles, grid_y), replicas), block (cx, by, r) taking
    row tiles by, by + gy, ...; every tile once."""
    gy = min(nty, grid_y)
    order = [(r, yt, cx) for r in range(nrep) for by in range(gy)
             for cx in range(nch) for yt in range(by, nty, gy)]
    assert sorted(order) == [(r, y, c) for r in range(nrep)
                             for y in range(nty) for c in range(nch)]
    return order


def _planes(t: Tensor, shape):
    return t.mem[t.off:t.off + t.n].view(np.int8).reshape(shape).copy()


def replay(x, o, seeds, *, color, beta, gen, offsets=(0, 0), bits=None,
           halo=None, measuring=False, tiles=None, grid_y=MAX_GRID):
    """One launch of the phase kernel on numpy planes x, o (int8 (R, ny,
    half)) at byte offsets ``offsets`` mod 16, with the constants
    ``tiles`` (else phase_tiles'), each thread storing its new word to x
    itself; ``bits`` injected int32 words, ``halo`` as replay_phase takes
    it.  Returns the new x, the (R, 2) int64 (m, e)
    and the neighbours each site read."""
    shape = x.shape
    t = tiles or i2p.phase_tiles(*shape)
    t4, t8 = i2p.accept_thresholds_u32(beta)
    xt, ot = Tensor(x, offsets[0]), Tensor(o, offsets[1])
    obs, read = replay_phase(
        xt, ot, shape, round_keys(seeds), color=color, t4=t4, t8=t8,
        measuring=measuring, gen=gen, tiles=t,
        order=phase_order(shape[0], t["nty"], t["nch"], grid_y), halo=halo,
        inject=None if bits is None else bits.astype(np.int64) & M32,
        direct=True)
    return _planes(xt, shape), obs, read


def _halo_reads(o, color, up, dn, lf, rt, row0):
    """The four spins the plain sharded phase reads at each site: the rows
    above and below (the halo rows past the shard's edges), the centre,
    the side (c + d by global row parity; past the edges the column
    halos, or the shard's own other end without them)."""
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
    return np.stack([above, below, o, side]).astype(np.int64)


def _bits(g, shape):
    return g.integers(-2 ** 31, 2 ** 31, size=shape, dtype=np.int64).astype(
        np.int32)


def _t(a):
    return torch.from_numpy(a.copy())


@pytest.mark.parametrize("offsets", [(0, 0), (3, 11), (11, 3)])
@pytest.mark.parametrize("shape", SHAPES)
def test_replay_equals_plain_phase(shape, offsets):
    """Both colours, Philox and injected words: every site stored once,
    every neighbour read at its pre-phase value; the states equal
    ``phase_plain`` bitwise."""
    g, a, b = _states(shape, 5 * sum(shape) + offsets[0])
    beta = 1 / KBT
    bits = _bits(g, shape)
    for color in (0, 1):
        x, o = (a, b) if color == 0 else (b, a)
        seeds = rng.seeds_from_key(rng.base_key(5), color)
        for inj in (None, bits):
            new, _, read = replay(x, o, seeds, color=color, beta=beta, gen=g,
                                  offsets=offsets, bits=inj)
            np.testing.assert_array_equal(read, _plain_reads(o, color))
            want = i2p.phase_plain(
                _t(x), _t(o), None if inj is not None else seeds,
                color=color, beta=beta,
                bits=None if inj is None else torch.from_numpy(inj))
            np.testing.assert_array_equal(new, want.numpy())


# (shape, (rep0, row0, col0), column halos, byte offsets): col0 % 4 = 0
# .. 3, with the column halos and without them, one chunked
SHARDS = [((2, 9, 23), (1, 5, 11), True, (0, 3)),
          ((2, 9, 23), (1, 5, 9), False, (11, 0)),
          ((2, 9, 23), (0, 4, 10), True, (3, 11)),
          ((2, 8, 22), (0, 3, 0), True, (3, 3)),
          ((2, 8, 22), (0, 4, 0), False, (0, 0)),
          ((1, 3, 4102), (0, 7, 5), True, (3, 0))]


@pytest.mark.parametrize("shard", SHARDS)
def test_replay_equals_plain_sharded_phase(shard):
    """The halo mode: a shard at global (rep0, row0, col0), its halo rows,
    with and without the column halos (col0 % 4 != 0: words col0 % 4
    columns early, the shard's first and last sites in units cut by its
    edges); both colours, Philox and injected words, plain and measuring:
    every site stored once, every neighbour read the plain version's;
    the states equal ``sharded_phase_plain`` bitwise, the sums its sums
    exactly."""
    shape, offs, cols, offsets = shard
    nrep, ny, half = shape
    g, a, b = _states(shape, 7 * sum(offs) + half)
    up, dn = (_states((nrep, 1, half), 3 + k)[1] for k in range(2))
    lf, rt = ((_states((nrep, ny, 1), 5 + k)[1] for k in range(2)) if cols
              else (None, None))
    beta = 1 / KBT
    bits = _bits(g, shape)
    for color in (0, 1):
        x, o = (a, b) if color == 0 else (b, a)
        seeds = rng.seeds_from_key(rng.base_key(9), color)
        for inj in (None, bits):
            for measuring in (False, True):
                halo = dict(up=Tensor(up, offsets[1]), dn=Tensor(dn, 5),
                            lf=lf, rt=rt, offs=offs)
                new, obs, read = replay(
                    x, o, seeds, color=color, beta=beta, gen=g,
                    offsets=offsets, bits=inj, halo=halo,
                    measuring=measuring)
                np.testing.assert_array_equal(
                    read, _halo_reads(o, color, up, dn, lf, rt, offs[1]))
                kw = dict(color=color, beta=beta, measuring=measuring)
                if cols:
                    kw.update(halo_lf=_t(lf), halo_rt=_t(rt))
                if inj is not None:
                    kw.update(bits=torch.from_numpy(inj))
                want = i2p.sharded_phase_plain(
                    _t(x), _t(o), _t(up), _t(dn), seeds,
                    offs if cols or offs[2] else offs[:2], **kw)
                np.testing.assert_array_equal(
                    new, (want[0] if measuring else want).numpy())
                if measuring:
                    np.testing.assert_array_equal(
                        obs, torch.stack(want[1:], dim=-1).numpy())


def test_replay_on_the_class_tiles():
    """The classes' tile shapes on shorter replicas: phase_tiles at 4000^2
    x 8 (the streamed class: 8 rows, 128 threads a row) on (1, 19, 2000),
    at 1000^2 x 1 (the samples class: 2 rows of 128 threads, ms_tiles'
    500 tiles of a small launch) on (1, 7, 500), and at the mesh class's
    shard (8, 2000, 1000) (16 rows, 64 threads a row) in the halo mode,
    measuring, on (1, 37, 1000) at col0 = 1000: the same checks as
    above."""
    beta = 1 / KBT
    seeds = rng.seeds_from_key(rng.base_key(21), 1)
    for cls, shape, (rows, lux) in (((8, 4000, 2000), (1, 19, 2000), (8, 7)),
                                    ((1, 1000, 500), (1, 7, 500), (2, 7))):
        t = i2p.phase_tiles(*cls)
        assert (t["rows"], t["lux"]) == (rows, lux)
        t = dict(t, nty=-(-shape[1] // rows))
        g, a, b = _states(shape, 17 + shape[2])
        new, _, read = replay(b, a, seeds, color=1, beta=beta, gen=g,
                              offsets=(0, 3), tiles=t)
        np.testing.assert_array_equal(read, _plain_reads(a, 1))
        want = i2p.phase_plain(_t(b), _t(a), seeds, color=1, beta=beta)
        np.testing.assert_array_equal(new, want.numpy())
    t = i2p.phase_tiles(8, 2000, 1000)
    assert (t["rows"], t["lux"], t["nty"]) == (16, 6, 125)
    shape, offs = (1, 37, 1000), (3, 2000, 1000)
    t = dict(t, nty=3)
    g, a, b = _states(shape, 23)
    up, dn, lf, rt = (_states(s, 29 + k)[1] for k, s in enumerate(
        [(1, 1, 1000)] * 2 + [(1, 37, 1)] * 2))
    halo = dict(up=Tensor(up, 11), dn=Tensor(dn, 0), lf=lf, rt=rt,
                offs=offs)
    new, obs, _ = replay(b, a, seeds, color=1, beta=beta, gen=g,
                         halo=halo, measuring=True, tiles=t)
    want = i2p.sharded_phase_plain(_t(b), _t(a), _t(up), _t(dn), seeds,
                                   offs, color=1, beta=beta, halo_lf=_t(lf),
                                   halo_rt=_t(rt), measuring=True)
    np.testing.assert_array_equal(new, want[0].numpy())
    np.testing.assert_array_equal(obs, torch.stack(want[1:], -1).numpy())


def test_replay_is_independent_of_the_grid():
    """Row tiles walked gridDim.y apart (the kernel's loop past 65535 row
    tiles) give the states and sums of a block a tile."""
    shape = (2, 40, 5)
    g, a, b = _states(shape, 3)
    # four rows a tile, a thread a row (ms_tiles' own pick is one tile)
    buf, end = [], 0
    for n in i8ms._spans(4, 5, 5):
        buf.append(end + 16)
        end = buf[-1] + n
    t = dict(rows=4, lux=8, cw=5, nch=1, nty=10, buf=tuple(buf), smem=end)
    i8ms.check_ms_tiles(t, 40, 5)
    seeds = rng.seeds_from_key(rng.base_key(9), 1)
    up, dn = (_states((2, 1, 5), 11 + k)[1] for k in range(2))
    out = []
    for grid_y in (MAX_GRID, 3, 1):
        halo = dict(up=Tensor(up, 0), dn=Tensor(dn, 0), lf=None, rt=None,
                    offs=(0, 2, 0))
        new, obs, _ = replay(b, a, seeds, color=1, beta=1 / KBT, gen=g,
                             halo=halo, measuring=True, tiles=t,
                             grid_y=grid_y)
        out.append((new, obs))
    for new, obs in out[1:]:
        np.testing.assert_array_equal(new, out[0][0])
        np.testing.assert_array_equal(obs, out[0][1])


@pytest.mark.parametrize("shape", [(2, 12, 5), (1, 33, 500)])
def test_one_body_for_both_callers(shape):
    """The tile body the phase kernel and the multisweep share: a sweep of
    two phase-kernel launches (phase_tiles, one tile a block, direct
    stores; phase b in the halo mode at offset 0 with the periodic rows as
    halos, measuring) equals one sweep of the multisweep's replay
    (ms_tiles, its grid's walk, the write-back), states bitwise and the
    fused sums exactly, and multisweep_plain."""
    g, a, b = _states(shape, 41 + shape[1])
    seeds = multispin_rng.sweep_phase_keys(rng.base_key(13), 1)
    beta = 1 / KBT
    na, _, _ = replay(a, b, seeds[0, 0], color=0, beta=beta, gen=g)
    halo = dict(up=Tensor(na[:, -1:], 3), dn=Tensor(na[:, :1], 0), lf=None,
                rt=None, offs=(0, 0, 0))
    nb, obs, _ = replay(b, na, seeds[0, 1], color=1, beta=beta, gen=g,
                        halo=halo, measuring=True)
    t4, t8 = i2p.accept_thresholds_u32(beta)
    at, bt = Tensor(a, 0), Tensor(b, 0)
    for phase, (x, o) in enumerate(((at, bt), (bt, at))):
        sums, _ = replay_phase(x, o, shape, round_keys(seeds[0, phase]),
                               color=phase, t4=t4, t8=t8,
                               measuring=phase == 1, gen=g)
    np.testing.assert_array_equal(na, _planes(at, shape))
    np.testing.assert_array_equal(nb, _planes(bt, shape))
    np.testing.assert_array_equal(obs, sums)
    wa, wb, wobs = i8ms.multisweep_plain(_t(a), _t(b), seeds, beta=beta)
    np.testing.assert_array_equal(na, wa.numpy())
    np.testing.assert_array_equal(nb, wb.numpy())
    np.testing.assert_array_equal(obs, wobs[:, 0].numpy())


def test_wrapper_checks_the_tiles():
    """The wrapper's constants are phase_tiles', built once a shape and
    checked before the launch: ms_tiles at TILE_BYTES a tile; constants
    the kernel cannot run on are refused."""
    for shape in SHAPES + [(8, 4000, 2000), (1, 1000, 500),
                           (8, 2000, 1000)]:
        t = i2p.phase_tiles(*shape)
        assert t == i8ms.ms_tiles(*shape, i2p.TILE_BYTES)
        i8ms.check_ms_tiles(t, *shape[1:])
        arg = i2p._phase_tiles_arg(*shape)
        assert arg is i2p._phase_tiles_arg(*shape)
        assert list(arg) == [t["rows"], t["lux"], t["cw"], t["nch"],
                             t["nty"], *t["buf"], t["smem"]]
    good = i2p.phase_tiles(8, 4000, 2000)
    for bad in (dict(good, nty=1), dict(good, rows=good["rows"] + 1),
                dict(good, smem=good["smem"] - 16)):
        with pytest.raises(ValueError, match="tiles"):
            i8ms.check_ms_tiles(bad, 4000, 2000)
