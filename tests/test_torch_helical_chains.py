"""The unrolled Bernoulli chains of the helical 2-D bit-packed kernel, on
the CPU.

``csrc/helical_multispin.cu`` ``multisweep_kernel`` draws the B4 and B8
planes of a word by ``csrc/bernoulli.cuh`` ``chain_planes``, folding
Philox words as the launch's table ``ops/multispin_rng.chain_table((q4,
q8, 0))`` says (the third chain draws nothing), under the round keys of
each (sweep, phase) key.  Here the table is replayed in PyTorch over the
Philox words of the helical counter (replica, word, 0, draw / 4), as the
kernel folds them (``test_torch_ising3d_chains._replay``), and held
bitwise against the plain chains of ``ops/ising2d_multispin``
(``_bern_plane``), which the plain multisweep draws, and, through the
packed phase given the replayed planes, against the JAX package's bitwise
oracles (``packed_helical_phase_reference`` and the Pallas kernel
``phase_packed_with_bits`` in interpret mode) at its tests' shapes.  The
wrapper's table and its refusal of a bad one are checked too."""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_ising2d_chains import KBTS, QS
from test_torch_ising3d_chains import _replay

from cuda_fortran_mc_simulation_spin_tpu.ops import helical_multispin as jhms
from cuda_fortran_mc_simulation_spin_tpu_torch import interop
from cuda_fortran_mc_simulation_spin_tpu_torch.core import rng
from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
    helical_multispin as hms,
)
from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
    ising2d_multispin as msb,
)
from cuda_fortran_mc_simulation_spin_tpu_torch.ops import multispin_rng

MASK32 = 0xFFFFFFFF
KBT = 2.26918531421
# the JAX helical tests' shape (M = 4128 = 129 words exactly) and a
# partial last word (M = 4061, 29 bits)
SHAPES = [(129, 64), (131, 62)]


def _words(seed, shape):
    g = np.random.default_rng(seed)
    return torch.from_numpy(g.integers(-2 ** 31, 2 ** 31, size=shape,
                                       dtype=np.int64).astype(np.int32))


def _stream(key, nrep, nw):
    """The helical kernel's Philox words of (R, W) colour vectors: counter
    (r, g, 0, draw / 4), as the plain phase draws them."""
    gen = multispin_rng.word_stream(key, nrep, nw, 1)
    return lambda: gen().reshape(nrep, nw)


def _planes(q, key, nrep, nw):
    """The replayed (B4, B8) planes as int32, and the third chain's."""
    p4, p8, p12 = (torch.as_tensor(p, dtype=torch.int64).expand(nrep, nw)
                   for p in _replay(multispin_rng.chain_table((*q, 0)),
                                    _stream(key, nrep, nw)))
    return msb._i32(p4 & MASK32), msb._i32(p8 & MASK32), p12


@pytest.mark.parametrize("q", [msb.chain_words(1 / k) for k in KBTS] + QS)
def test_chain_table_replay_gives_the_plain_chain_planes(q):
    """The table replayed over the helical counter's words gives the plain
    chains' B4 and B8 planes bitwise, word by word, and a zero third."""
    key = rng.seeds_from_key(rng.base_key(16), 1)
    nrep, nw = 3, 37
    gen = _stream(key, nrep, nw)
    want = [msb._bern_plane((nrep, nw), msb._digits(qx), gen) for qx in q]
    p4, p8, p12 = _planes(q, key, nrep, nw)
    assert torch.equal(msb._u32(p4), want[0] & MASK32)
    assert torch.equal(msb._u32(p8), want[1] & MASK32)
    assert not p12.any()


@pytest.mark.parametrize("kbt", KBTS)
@pytest.mark.parametrize("nx,ny", SHAPES)
def test_replayed_chains_drive_the_plain_phase_and_the_jax_oracles(nx, ny,
                                                                   kbt):
    """Both colours' packed phases given the replayed planes equal the
    plain phase under the same key bitwise, and on the valid bits the JAX
    package's oracle and its Pallas kernel in interpret mode given the
    same planes."""
    m = nx * ny // 2
    nrep, nw = 2, hms.words(m)
    q4, q8 = msb.chain_words(1 / kbt)
    vm = hms.valid_mask(m)
    for color, offs in enumerate(hms.helical_offsets(nx)):
        x, o = _words(nx + color, (nrep, nw)), _words(ny + color, (nrep, nw))
        key = rng.seeds_from_key(rng.base_key(nx), color)
        p4, p8, _ = _planes((q4, q8), key, nrep, nw)
        got = hms.packed_helical_phase_reference(x, o, offs, p4, p8, m)
        assert torch.equal(got, hms._phase_plain(x, o, key, offs, m, q4, q8,
                                                 False))
        jx, jo, j4, j8 = (jnp.asarray(interop.helical_to_numpy(v, m))
                          for v in (x, o, p4, p8))
        jref = interop.helical_from_numpy(np.stack([
            np.asarray(jhms.packed_helical_phase_reference(
                jx[r], jo[r], offs, j4[r], j8[r], m))
            for r in range(nrep)]), m)
        jker = interop.helical_from_numpy(
            jhms.phase_packed_with_bits(jx, jo, j4, j8, offs=offs, m=m,
                                        interpret=True), m)
        for want in (jref, jker):
            assert torch.equal(msb._u32(got) & vm, msb._u32(want) & vm)


def test_replayed_multisweep_is_the_plain_multisweep():
    """Two sweeps of phases given the replayed planes, each (sweep, phase)
    under its own key, equal multisweep_plain bitwise, (m, e) included."""
    nx, ny = 131, 62
    m, nrep = nx * ny // 2, 2
    nw = hms.words(m)
    wa, wb = _words(1, (nrep, nw)), _words(2, (nrep, nw))
    seeds = hms.sweep_seed_pairs(rng.sample_key(rng.base_key(3), 0), 2)
    q = msb.chain_words(1 / KBT)
    offs_a, offs_b = hms.helical_offsets(nx)
    ka, kb, kobs = hms.multisweep_plain(wa, wb, seeds, beta=1 / KBT, nx=nx,
                                        m=m)
    ra, rb = wa, wb
    for s in range(2):
        p4, p8, _ = _planes(q, seeds[s, 0], nrep, nw)
        ra = hms.packed_helical_phase_reference(ra, rb, offs_a, p4, p8, m)
        p4, p8, _ = _planes(q, seeds[s, 1], nrep, nw)
        rb = hms.packed_helical_phase_reference(rb, ra, offs_b, p4, p8, m)
    assert torch.equal(ra, ka) and torch.equal(rb, kb)
    ones, twos, fours = hms._counts(msb._u32(ra), offs_b, m)
    want = hms._obs_sums(msb._u32(rb), msb._u32(ra), ones, twos, fours, m)
    assert torch.equal(kobs[:, -1], want)


class _FakeLib:
    """The helical library's entry point, recording the chain table it
    was given instead of launching."""

    def __init__(self):
        self.tables = []

    def helical_multisweep(self, *args):
        table = args[-2]
        self.tables.append(tuple(table))
        return 0


def test_wrapper_passes_the_chain_table_of_its_digits(monkeypatch):
    """multisweep_planes hands the kernel the checked table of
    chain_table((q4, q8, 0)) of its beta; the bits mode an empty one."""
    fake = _FakeLib()
    monkeypatch.setattr(hms, "_lib", lambda: fake)
    monkeypatch.setattr(hms, "_on_cpu", lambda t: False)
    monkeypatch.setattr(hms, "_check_vectors", lambda *a, **k: None)
    monkeypatch.setattr(hms, "staged_fits", lambda nw, dev: True)
    monkeypatch.setattr(hms, "keys_to", lambda seeds, dev: seeds)
    monkeypatch.setattr(hms, "_stream", lambda t: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda d: _Null())
    nx, ny = 131, 62
    m = nx * ny // 2
    wa = wb = torch.zeros((2, hms.words(m)), dtype=torch.int32)
    seeds = hms.sweep_seed_pairs(rng.base_key(4), 3)
    for kbt in KBTS:
        hms.multisweep_planes(wa, wb, seeds, beta=1 / kbt, nx=nx, m=m)
        q4, q8 = msb.chain_words(1 / kbt)
        assert fake.tables[-1] == multispin_rng.chain_table((q4, q8, 0))
    hms.phase_packed_with_bits(wa, wb, wa, wb, offs=(0, -1, 65, -66), m=m)
    assert fake.tables[-1] == multispin_rng.chain_table((0, 0, 0))
    assert hms._table is msb._table


class _Null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


@pytest.mark.parametrize("ends", [(5, 4, 20), (0, 30, 20), (0, 0, 61),
                                  (-1, 0, 0)])
def test_a_bad_chain_table_is_refused(ends):
    """A table whose ends the unrolled loop cannot follow is refused by
    the host check the wrappers run before the C entry point checks it
    again (chain_table_ok); a table of the wrong length too."""
    table = list(multispin_rng.chain_table(msb.chain_words(1 / KBT) + (0,)))
    table[-3:] = ends
    with pytest.raises(ValueError):
        multispin_rng.check_chain_table(table)
    with pytest.raises(ValueError):
        multispin_rng.check_chain_table(table[:-1])
    assert ctypes.sizeof(msb._table(0, 0)) == 65 * 4
