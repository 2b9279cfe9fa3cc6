"""The unrolled Bernoulli chains and the grid of the 2-D bit-packed
kernels, on the CPU.

``csrc/ising2d_multispin.cu`` (``phase_kernel`` and ``multisweep_kernel``)
draws the B4 and B8 planes of a word by ``csrc/bernoulli.cuh``
``chain_planes``, folding Philox words as the launch's table
``ops/multispin_rng.chain_table((q4, q8, 0))`` says (the third chain
draws nothing).  Here the table is replayed in PyTorch over the Philox
words of the 2-D counter (replica, Y, X, draw / 4), as the kernel folds
them (``test_torch_ising3d_chains._replay``), and held bitwise against
the plain chains of ``ops/ising2d_multispin`` (``_bern_plane``) and,
through the packed phase given the replayed planes, against the JAX
package's bitwise oracles (``packed_phase_reference`` and, at a shard's
global offsets, ``packed_sharded_phase_reference``).  The multisweep's
walk over its tiles (``multisweep_grid``'s blocks of ``per`` tiles, the
first tile decoded once, carries after it, the sums added once a
replica) is replayed too."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_ising3d_chains import _replay

from cuda_fortran_mc_simulation_spin_tpu.ops import ising2d_multispin as jmsb
from cuda_fortran_mc_simulation_spin_tpu_torch.core import rng
from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
    ising2d_multispin as msb,
)
from cuda_fortran_mc_simulation_spin_tpu_torch.ops import multispin_rng

MASK32 = 0xFFFFFFFF
KBT = 2.26918531421
# Tc; a high and two low temperatures (kbt 1e9: both chains draw twenty
# words; kbt 0.5: B8 draws none; kbt 0.2: neither draws)
KBTS = [KBT, 1e9, 0.5, 0.2]
# digits (q4, q8) with a chain boundary inside a Philox call (e4 = 3,
# e8 = 9), on a call's first draw (e4 = 4, e8 = 8), after the last draw
# (q8 = 0: e4 = e8 = n = 20) and with no B4 chain (e4 = 0)
QS = [(1 << 17, 1 << 14), (1 << 16, 1 << 16), ((1 << 20) - 1, 0),
      (0, 5 << 10)]


def _words(seed, shape):
    g = np.random.default_rng(seed)
    return torch.from_numpy(g.integers(-2 ** 31, 2 ** 31, size=shape,
                                       dtype=np.int64).astype(np.int32))


def _stream(key, shape, offs=(0, 0, 0)):
    """The 2-D kernels' Philox words of (R, nyp, half) planes: counter
    (rep0 + r, wrow0 + Y, col0 + X, draw / 4)."""
    return multispin_rng.word_stream(key, *shape, None, *offs)


def _planes(q, key, shape, offs=(0, 0, 0)):
    """The replayed (B4, B8) planes as int32, and the third chain's."""
    p4, p8, p12 = (torch.as_tensor(p, dtype=torch.int64).expand(shape)
                   for p in _replay(multispin_rng.chain_table((*q, 0)),
                                    _stream(key, shape, offs)))
    return msb._i32(p4 & MASK32), msb._i32(p8 & MASK32), p12


def test_table_is_the_chains_of_q4_q8_and_an_empty_third():
    """The wrappers pass the 65 words of chain_table((q4, q8, 0)), which
    check_chain_table takes; the third chain ends where the second does."""
    q4, q8 = msb.chain_words(1 / KBT)
    table = tuple(msb._table(q4, q8))
    assert table == multispin_rng.chain_table((q4, q8, 0))
    assert len(table) == 4 * multispin_rng.CHAIN_CALLS + 5
    assert multispin_rng.check_chain_table(table) == table
    e4, e8, n_all = table[-3:]
    assert (e4, e8 - e4, n_all) == (msb.chain_draws(q4), msb.chain_draws(q8),
                                    e8)


@pytest.mark.parametrize("q", [msb.chain_words(1 / k) for k in KBTS] + QS)
def test_chain_table_replay_gives_the_plain_chain_planes(q):
    """The table replayed over the 2-D counter's words gives the plain
    chains' B4 and B8 planes bitwise, word by word, and a zero third."""
    key = rng.seeds_from_key(rng.base_key(6), 1)
    shape = (2, 3, 5)
    gen = _stream(key, shape)
    want = [msb._bern_plane(shape, msb._digits(qx), gen) for qx in q]
    p4, p8, p12 = _planes(q, key, shape)
    assert torch.equal(msb._u32(p4), want[0] & MASK32)
    assert torch.equal(msb._u32(p8), want[1] & MASK32)
    assert not p12.any()


@pytest.mark.parametrize("kbt", KBTS)
@pytest.mark.parametrize("color", [0, 1])
def test_replayed_chains_drive_the_plain_phase_and_the_jax_oracle(kbt,
                                                                  color):
    """The packed phase given the replayed planes equals
    phase_packed_plain under the same key bitwise (the planes wrap in y
    and x: nyp = 2, half = 4), and the JAX package's oracle given the same
    planes, replica by replica."""
    shape = (2, 2, 4)
    x, o = _words(10 + color, shape), _words(20 + color, shape)
    key = rng.seeds_from_key(rng.base_key(8), color)
    p4, p8, _ = _planes(msb.chain_words(1 / kbt), key, shape)
    got = msb.packed_phase_reference(x, o, color, p4, p8)
    assert torch.equal(got, msb.phase_packed_plain(x, o, key, color=color,
                                                   beta=1 / kbt))
    for r in range(shape[0]):
        jref = jmsb.packed_phase_reference(
            jnp.asarray(x[r].numpy()), jnp.asarray(o[r].numpy()), color,
            jnp.asarray(p4[r].numpy()), jnp.asarray(p8[r].numpy()))
        np.testing.assert_array_equal(got[r].numpy(), np.asarray(jref))


@pytest.mark.parametrize("cols", [False, True])
@pytest.mark.parametrize("color", [0, 1])
def test_replayed_chains_follow_a_shards_global_counter(cols, color):
    """A shard's planes at global offsets (rep0, wrow0, col0) draw the
    unsharded planes' words: the replay at the shard's counter gives the
    planes the plain sharded phase draws, and the halo mode given them
    equals JAX's packed_sharded_phase_reference with the same halo rows
    (and word columns), replica by replica."""
    shape = (2, 3, 4)
    offs = (1, 5, 7) if cols else (1, 5)
    x, o = _words(30 + color, shape), _words(40 + color, shape)
    g = np.random.default_rng(50 + color)
    hup, hdn = (torch.from_numpy(g.integers(0, 2, size=(2, 1, 4),
                                            dtype=np.int32))
                for _ in range(2))
    lf = rt = None
    if cols:
        lf, rt = _words(60, (2, 3, 1)), _words(61, (2, 3, 1))
    key = rng.seeds_from_key(rng.base_key(2), color)
    q = msb.chain_words(1 / KBT)
    p4, p8, _ = _planes(q, key, shape, offs + (0,) * (3 - len(offs)))
    kw = dict(color=color, beta=1 / KBT, halo_lf=lf, halo_rt=rt)
    got = msb.sharded_phase_packed_plain(x, o, hup, hdn, key, offs, b4=p4,
                                         b8=p8, **kw)
    assert torch.equal(got, msb.sharded_phase_packed_plain(
        x, o, hup, hdn, key, offs, **kw))
    for r in range(shape[0]):
        jcols = ({} if not cols else
                 {"halo_lf": jnp.asarray(lf[r].numpy()),
                  "halo_rt": jnp.asarray(rt[r].numpy())})
        jref = jmsb.packed_sharded_phase_reference(
            jnp.asarray(x[r].numpy()), jnp.asarray(o[r].numpy()), color,
            jnp.asarray(p4[r].numpy()), jnp.asarray(p8[r].numpy()),
            jnp.asarray(hup[r].numpy()), jnp.asarray(hdn[r].numpy()),
            **jcols)
        np.testing.assert_array_equal(got[r].numpy(), np.asarray(jref))


def _walk(nrep, nyp, half, blocks, per):
    """multisweep_kernel's walk of one measuring phase: block b's tiles
    from b·per on (the first decoded, then carries x -> y -> replica), its
    sums added at each replica's end and after its last tile.  Returns
    the (r, tile row, tile column) each tile visit names and the replicas
    each block adds to, in order."""
    tiles_x, tiles_y = half // 32, nyp // 8
    tiles_rep = tiles_x * tiles_y
    visits, adds = [], []
    for b in range(blocks):
        first = b * per
        count = min(per, nrep * tiles_rep - first)
        r = first // tiles_rep
        ty = (first - r * tiles_rep) // tiles_x
        tx = first - r * tiles_rep - ty * tiles_x
        pending, mine = False, []
        for _ in range(count):
            visits.append((r, ty, tx))
            pending = True
            tx += 1
            if tx == tiles_x:
                tx = 0
                ty += 1
                if ty == tiles_y:
                    ty = 0
                    mine.append(r)
                    pending = False
                    r += 1
        if pending:
            mine.append(r)
        adds.append(mine)
    return visits, adds


@pytest.mark.parametrize("shape,resident,sms", [
    ((16, 64, 1024), 660, 132),     # 2048^2 x 16 at five blocks an SM
    ((16, 64, 1024), 396, 132),     # three blocks an SM
    ((4, 32, 128), 660, 132),       # 1024^2 x 4 (fewer tiles than blocks)
    ((3, 8, 96), 5, 2),             # replicas across a block's tiles
    ((1, 16, 32), 1, 1)])
def test_multisweep_walk_covers_every_tile_once(shape, resident, sms):
    """The grid multisweep_grid picks is resident, covers every tile of a
    phase exactly once, adds each replica's sums once for each block that
    touches it (and only those), and the busiest SM takes the fewest tiles
    any per from the resident grid's least to twice it would give."""
    nrep, nyp, half = shape
    tiles = nrep * (nyp // 8) * (half // 32)
    blocks, per = msb.multisweep_grid(tiles, resident, sms)
    assert 1 <= blocks <= resident and (blocks - 1) * per < tiles <= \
        blocks * per
    visits, adds = _walk(nrep, nyp, half, blocks, per)
    assert sorted(visits) == [(r, y, x) for r in range(nrep)
                              for y in range(nyp // 8)
                              for x in range(half // 32)]
    for b, mine in enumerate(adds):
        touched = sorted({v[0] for v in visits[b * per:(b + 1) * per]})
        assert mine == touched

    def busiest(p):
        return -(-(-(-tiles // p)) // sms) * p

    p0 = -(-tiles // resident)
    assert busiest(per) == min(busiest(p) for p in range(p0, 2 * p0 + 1))


def test_multisweep_grid_at_the_resident_class():
    """2048^2 x 16: 4096 tiles on 660 resident blocks of 132 SMs gives 512
    blocks of 8 tiles (32 tiles on the busiest SM, against 35 for 586
    blocks of 7); a bad grid raises."""
    assert msb.multisweep_grid(4096, 660, 132) == (512, 8)
    with pytest.raises(ValueError):
        msb.multisweep_grid(4096, 0, 132)


def test_wrappers_refuse_planes_past_32_bit_indices():
    """The kernels index with 32 bits: planes of 2^31 words or more are
    refused before any launch (the check reads only the shape)."""
    big = torch.empty((1, 1, 1)).expand(1, 2 ** 16, 2 ** 15)
    with pytest.raises(ValueError, match="32-bit"):
        msb._check_indices(big)
    msb._check_indices(torch.empty((1, 1, 1)).expand(1, 2 ** 15, 2 ** 15 - 1))
