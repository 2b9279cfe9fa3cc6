"""The unrolled Bernoulli chains of the 3-D Ising kernels, on the CPU.

``csrc/bernoulli.cuh`` ``chain_planes`` draws the B4, B8, B12 planes of a
word by folding Philox words as a per-launch table says
(``ops/multispin_rng.chain_table``); the helical and the periodic 3-D
phase kernels both follow it.  Here the table is replayed in PyTorch over
the Philox words of the periodic 3-D counter (replica, z·nyp + Y, X,
draw / 4), as the kernel folds them, and held bitwise against the plain
chains of ``ops/ising3d_multispin`` and, through the packed phase given
the replayed planes, against the JAX package's bitwise oracle
(``packed_phase3d_reference``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_fortran_mc_simulation_spin_tpu.ops import ising3d_multispin as jms3
from cuda_fortran_mc_simulation_spin_tpu_torch.core import rng
from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
    helical3d_multispin as h3,
)
from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
    ising2d_multispin as msb,
)
from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
    ising3d_multispin as ms3,
)
from cuda_fortran_mc_simulation_spin_tpu_torch.ops import multispin_rng

MASK32 = 0xFFFFFFFF
# the 3-D classes' kbt; a high and a low temperature (kbt 1e9: every chain
# draws twenty words; kbt 0.5: B8 and B12 draw none; kbt 0.2: no chain
# draws)
KBTS = [4.51152, 1e9, 0.5, 0.2]
# digits (q4, q8, q12) with a chain boundary inside a Philox call (e4 = 3,
# e8 = 9), on a call's first draw (e4 = 4) and after the last draw
QS = [(1 << 17, 1 << 14, 5), (1 << 16, 1 << 16, 1 << 16),
      ((1 << 20) - 1, 0, 0)]


def _volume_words(seed, shape):
    g = np.random.default_rng(seed)
    return torch.from_numpy(g.integers(-2 ** 31, 2 ** 31, size=shape,
                                       dtype=np.int64).astype(np.int32))


def _replay(table, gen):
    """chain_planes over whole planes: draw n of ``gen`` (word n % 4 of
    Philox call n // 4) folded by ``table`` as the kernel folds it, a fast
    call's four draws straight, the others draw by draw, the calls in
    pairs (a pair's second call past the last draw drawn and dropped)."""
    calls = multispin_rng.CHAIN_CALLS
    digit, (live, fast, e4, e8, n_all) = table[:4 * calls], table[4 * calls:]
    b = p4 = p8 = 0
    for c0 in range(0, calls, 2):
        if not live >> c0 & 1:
            break
        words = {c: [gen() for _ in range(4)]
                 for c in range(c0, min(c0 + 2, calls))}
        for c, w in words.items():
            if not live >> c & 1:
                continue
            for j in range(4):
                n = 4 * c + j
                if not fast >> c & 1:
                    if n >= n_all:
                        continue
                    if n == e4:
                        p4, b = b, 0
                    if n == e8:
                        p8, b = b, 0
                d = digit[n]
                b = (w[j] & b) | (w[j] & d) | (b & d)
    if e4 == n_all:
        p4, b = b, 0
    if e8 == n_all:
        p8, b = b, 0
    return p4, p8, b


def _stream(key, shape, offs=(0, 0)):
    """The periodic 3-D kernels' Philox words of a (R, nz, nyp, half)
    volume: counter (rep0 + r, (z0 + z)·nyp + Y, X, draw / 4)."""
    nrep, nz, nyp, half = shape
    gen = multispin_rng.word_stream(key, nrep, nz * nyp, half, None,
                                    offs[0], offs[1] * nyp)
    return lambda: gen().reshape(shape)


def test_chain_table_moved_is_the_helical_one():
    """The table and its call count live in ops/multispin_rng; the helical
    3-D wrappers name the same objects, and the periodic 3-D wrapper
    passes its 65 words."""
    assert h3.chain_table is multispin_rng.chain_table
    assert h3.CHAIN_CALLS == multispin_rng.CHAIN_CALLS == 15
    assert msb.CHAIN_BITS == multispin_rng.CHAIN_BITS == 20
    q = ms3.chain_words3d(1 / 4.51152)
    assert tuple(ms3._table(q)) == multispin_rng.chain_table(q)
    assert len(ms3._table(q)) == 4 * multispin_rng.CHAIN_CALLS + 5


@pytest.mark.parametrize("q", [ms3.chain_words3d(1 / k) for k in KBTS] + QS)
def test_chain_table_replay_gives_the_plain_chain_planes(q):
    """The table replayed over the periodic 3-D counter's words gives the
    plain chains' B4, B8, B12 planes bitwise, word by word."""
    key = rng.seeds_from_key(rng.base_key(6), 1)
    shape = (2, 3, 2, 5)
    table = multispin_rng.chain_table(tuple(q))
    want_gen = _stream(key, shape)
    want = [msb._bern_plane(shape, msb._digits(qx), want_gen) for qx in q]
    got = _replay(table, _stream(key, shape))
    for g, w in zip(got, want):
        g = torch.as_tensor(g, dtype=torch.int64).expand(shape)
        assert torch.equal(g & MASK32, w & MASK32)


@pytest.mark.parametrize("kbt", KBTS)
@pytest.mark.parametrize("color", [0, 1])
def test_replayed_chains_drive_the_plain_phase_and_the_jax_oracle(kbt,
                                                                  color):
    """The packed phase given the replayed planes equals phase3d_plain
    under the same key bitwise (the volume wraps in z, y and x: nz = 2,
    nyp = 2, half = 4), and equals the JAX package's oracle given the same
    planes, replica by replica."""
    shape = (2, 2, 2, 4)
    x, o = _volume_words(10 + color, shape), _volume_words(20 + color, shape)
    key = rng.seeds_from_key(rng.base_key(8), color)
    table = multispin_rng.chain_table(ms3.chain_words3d(1 / kbt))
    p4, p8, p12 = (torch.as_tensor(p, dtype=torch.int64).expand(shape)
                   for p in _replay(table, _stream(key, shape)))
    planes = [msb._i32(p & MASK32) for p in (p4, p8, p12)]
    got = ms3.packed_phase3d_reference(x, o, color, *planes)
    assert torch.equal(got, ms3.phase3d_plain(x, o, key, color=color,
                                              beta=1 / kbt))
    for r in range(shape[0]):
        jref = jms3.packed_phase3d_reference(
            jnp.asarray(x[r].numpy()), jnp.asarray(o[r].numpy()), color,
            *(jnp.asarray(p[r].numpy()) for p in planes))
        np.testing.assert_array_equal(got[r].numpy(), np.asarray(jref))


def test_replayed_chains_follow_a_shards_global_counter():
    """A z-shard's planes at offsets (rep0, z0) draw the unsharded
    volume's words: the replay at the shard's counter gives the planes
    the plain sharded phase draws."""
    shape, offs = (1, 2, 3, 4), (1, 3)
    key = rng.seeds_from_key(rng.base_key(2), 0)
    q = ms3.chain_words3d(1 / 4.51152)
    table = multispin_rng.chain_table(q)
    want_gen = _stream(key, shape, offs)
    want = [msb._bern_plane(shape, msb._digits(qx), want_gen) for qx in q]
    got = _replay(table, _stream(key, shape, offs))
    for g, w in zip(got, want):
        assert torch.equal(torch.as_tensor(g).expand(shape) & MASK32,
                           w & MASK32)
