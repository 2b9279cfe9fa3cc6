"""The helical 3-D resident multisweep's chains, replayed on the CPU.

``csrc/helical3d_multispin.cu`` ``multisweep_kernel`` runs S sweeps of
odd-nx·ny colour vectors in one launch.  At each (sweep, phase) every
thread derives the round keys of that phase's key (``seeds[2s + phase]``
of the flat (S, 2, 2) int32 keys, ``philox_round_keys``) and draws its
B4, B8, B12 planes by ``chain_planes`` from the launch's ChainTable (the
table ``phase_kernel`` takes, ``ops/multispin_rng.chain_table``), at the
Philox counter (replica, word, 0, draw / 4).  Here that walk is replayed
in PyTorch: the keys read from the flat buffer as the kernel reads them,
the round keys and the ten rounds restated, the table folded as the
kernel folds it (``tests/test_torch_ising3d_chains._replay``), then the
packed phase given the planes and the fused (m, e) of every sweep's phase
b; over S >= 3 sweeps it must equal ``helical3d_multispin.multisweep_plain``
bitwise, at the 3-D classes' and the chain tests' temperatures and at
digit triples with chain boundaries inside a Philox call.  The wrapper's
table check refuses a table the kernel cannot follow, as the C entry
point does.
"""

import numpy as np
import pytest
import torch
from test_torch_ising3d_chains import KBTS, QS, _replay
from test_torch_ising3d_int8_tiles import philox_rk, round_keys

from cuda_fortran_mc_simulation_spin_tpu_torch.core import rng
from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
    helical3d_multispin as h3,
)
from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
    helical_multispin as hms,
)
from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
    ising3d_multispin as ms3,
)
from cuda_fortran_mc_simulation_spin_tpu_torch.ops import multispin_rng

M32 = 0xFFFFFFFF
# odd nx·ny geometries (nx, ny, nz): M = 50 (2 words, 18 pad bits) and
# M = 147 (5 words)
GEOMS = [(5, 5, 4), (7, 7, 6)]
SWEEPS = 3


def _geom(nx, ny, nz):
    return dict(nx=nx, nxy=nx * ny, m=nx * ny * nz // 2)


def _vectors(seed, nrep, m):
    g = np.random.default_rng(seed)
    return tuple(torch.from_numpy(g.integers(
        -2 ** 31, 2 ** 31, size=(nrep, hms.words(m)), dtype=np.int64).astype(
            np.int32)) for _ in range(2))


def _word_gen(rk, nrep, nw):
    """The kernel's draws for every word of every replica: draw n is
    output n % 4 of philox_rk at counter (replica, word, 0, n / 4)."""
    r, g = np.meshgrid(np.arange(nrep), np.arange(nw), indexing="ij")
    state = {"n": 0, "buf": None}

    def gen():
        n = state["n"]
        if n % 4 == 0:
            ctr = np.stack([r, g, np.zeros_like(r), np.full_like(r, n // 4)],
                           axis=-1).astype(np.uint64)
            state["buf"] = philox_rk(ctr, rk).astype(np.int64)
        state["n"] = n + 1
        return torch.from_numpy(state["buf"][..., n % 4])

    return gen


def replay_multisweep(wa, wb, seeds, q, *, nx, nxy, m):
    """multisweep_kernel's S sweeps: keys from the flat int32 buffer, round
    keys a phase, the table's chains, the packed phase and phase b's sums."""
    flat = seeds.to(torch.int32).contiguous().view(-1)
    table = multispin_rng.chain_table(tuple(q))
    offs_a, offs_b, _ = h3.helical3d_offsets(nx, nxy)
    nrep, nw = wa.shape
    obs = []
    for s in range(seeds.shape[0]):
        for phase in (0, 1):
            x, o = (wb, wa) if phase else (wa, wb)
            key = (int(flat[(2 * s + phase) * 2]) & M32,
                   int(flat[(2 * s + phase) * 2 + 1]) & M32)
            p4, p8, p12 = (torch.as_tensor(p, dtype=torch.int64).expand(
                nrep, nw) for p in _replay(
                    table, _word_gen(round_keys(key), nrep, nw)))
            offs = offs_b if phase else offs_a
            new = h3.packed_phase_reference(x, o, offs, (), p4, p8, p12, m)
            if phase:
                counts = h3._counts(h3._u32(new), h3._u32(o), offs, (), m)
                obs.append(h3._obs_sums(h3._u32(new), h3._u32(o), *counts,
                                        m, True))
                wb = new
            else:
                wa = new
    return wa, wb, torch.stack(obs, dim=1)


def _check(wa, wb, seeds, q, geom, monkeypatch, beta):
    if q is not None:
        monkeypatch.setattr(h3, "chain_words3d", lambda _beta: q)
    want = h3.multisweep_plain(wa, wb, seeds, beta=beta, **geom)
    got = replay_multisweep(wa, wb, seeds, q or ms3.chain_words3d(beta),
                            **geom)
    vm = h3.valid_mask(geom["m"])
    for g, w in zip(got[:2], want[:2]):
        assert torch.equal(h3._u32(g) & vm, h3._u32(w) & vm)
    assert torch.equal(got[2], want[2])


@pytest.mark.parametrize("geom", GEOMS)
@pytest.mark.parametrize("kbt", KBTS)
def test_replayed_multisweep_equals_plain(geom, kbt, monkeypatch):
    """At the classes' and the chain tests' temperatures (every chain
    drawing twenty words, B8/B12 drawing none, no chain drawing), S = 3
    replayed sweeps equal the plain multisweep: vectors and every
    sweep's (m, e)."""
    nx, ny, nz = geom
    g = _geom(nx, ny, nz)
    wa, wb = _vectors(nx + nz, 2, g["m"])
    seeds = multispin_rng.sweep_phase_keys(rng.base_key(int(kbt) + 3),
                                           SWEEPS)
    _check(wa, wb, seeds, None, g, monkeypatch, 1 / kbt)


@pytest.mark.parametrize("q", QS)
def test_replayed_multisweep_at_chain_boundaries(q, monkeypatch):
    """Digit triples whose chain boundaries fall inside a Philox call, on
    a call's first draw and after the last draw: the replay's table walk
    equals the plain chains over S = 4 sweeps."""
    g = _geom(7, 7, 6)
    wa, wb = _vectors(sum(q) % 97, 3, g["m"])
    seeds = multispin_rng.sweep_phase_keys(rng.base_key(q[0] % 89), 4)
    _check(wa, wb, seeds, q, g, monkeypatch, 1 / 4.51152)


def test_keys_read_from_the_flat_buffer_are_the_sweep_keys():
    """seeds[2s + phase] of the flat (S, 2, 2) int32 buffer the wrapper
    passes is the (sweep, phase) key the plain version draws under."""
    seeds = multispin_rng.sweep_phase_keys(rng.base_key(5), 4)
    flat = h3._i32(seeds).contiguous().view(-1)
    for s in range(4):
        for phase in (0, 1):
            got = [int(flat[(2 * s + phase) * 2 + i]) & M32 for i in (0, 1)]
            assert got == [int(v) for v in seeds[s, phase]]


@pytest.mark.parametrize("kbt", KBTS)
def test_multisweep_args_pass_the_phase_kernels_table(kbt):
    """The multisweep's launch constants: each colour's six cross offsets
    mod M and the ChainTable the phase kernel takes at the same beta."""
    g = _geom(151, 151, 150)
    offs_a, offs_b, table = h3.multisweep_args(beta=1 / kbt, **g)
    a, b, _ = h3.helical3d_offsets(151, 151 * 151)
    assert list(offs_a) == [d % g["m"] for d in a]
    assert list(offs_b) == [d % g["m"] for d in b]
    assert tuple(table) == multispin_rng.chain_table(
        ms3.chain_words3d(1 / kbt))


@pytest.mark.parametrize("bad", ["e4_past_e8", "n_past_60", "short",
                                 "negative"])
def test_a_bad_table_is_refused(bad, monkeypatch):
    """check_chain_table refuses a table the unrolled chains cannot follow
    (chain ends out of order or past 60 draws, a table of other than 65
    words), and the multisweep wrapper's launch constants go through it."""
    good = list(multispin_rng.chain_table(ms3.chain_words3d(1 / 4.51152)))
    assert multispin_rng.check_chain_table(good) == tuple(good)
    t = list(good)
    if bad == "e4_past_e8":
        t[-3], t[-2] = t[-2] + 1, t[-2]
    elif bad == "n_past_60":
        t[-1] = 4 * multispin_rng.CHAIN_CALLS + 1
    elif bad == "short":
        t = t[:-1]
    else:
        t[-3] = -1
    with pytest.raises(ValueError):
        multispin_rng.check_chain_table(t)
    monkeypatch.setattr(multispin_rng, "chain_table", lambda q: tuple(t))
    with pytest.raises(ValueError):
        h3.multisweep_args(beta=1 / 4.51152, **_geom(151, 151, 150))
