"""The unrolled draw of the helical packed clock kernel, on the CPU.

``csrc/clock_helical_multispin.cu`` draws a word's eight random planes in
one unrolled line (``csrc/clock_algebra.cuh`` ``draw_unrolled<6>``) that
follows the launch's table, ``multispin_rng.clock_draw_table`` of the
wrapper's chains (``clock_planes._table_arg`` of ``clock_multispin.SPEC``:
the 12 thermometer words, then the five chains of
``chain_words(accept_digit_planes(beta))``), under the round keys of each
(sweep, phase) key.  Here the table is replayed over the Philox words of
the helical counter (replica, word, 0, draw / 4), as the kernel folds them
(``test_torch_clock_draw._replay``), and held bitwise against the plain
draw of the plain phase (``clock_helical_multispin._phase_plain``: the
word stream at (replica, word, 0) through ``clock_multispin.draw_planes``)
at the helical class's kbt 0.8, at 0.91 and at a high temperature; the
replayed planes then drive ``packed_helical_phase6_reference`` to the
plain phase's states, and S sweeps of such phases under the (S, 2, 2)
keys give ``multisweep_plain``'s states and sums.  The kernel takes one
block a replica, so every word is written once a phase, by one thread.
"""

import numpy as np
import pytest
import torch
from test_torch_clock_draw import _replayed_planes

from cuda_fortran_mc_simulation_spin_tpu_torch.core import rng
from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
    clock_helical_multispin as chm,
)
from cuda_fortran_mc_simulation_spin_tpu_torch.ops import clock_planes as cp
from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
    helical_multispin as hms,
)
from cuda_fortran_mc_simulation_spin_tpu_torch.ops import multispin_rng

MASK32 = 0xFFFFFFFF
KBTS = [0.8, 0.91, 1e9]


def _table(beta: float):
    """The wrapper's launch table: clock_planes._table_arg of the q = 6
    spec, the helical chains."""
    table = tuple(chm._table_arg(chm.SPEC, float(beta)))
    qs, ks = cp.chain_words(chm.accept_digit_planes(beta))
    assert table == multispin_rng.clock_draw_table(12, tuple(qs), tuple(ks))
    return table


def _plain_planes(key, nrep: int, nw: int, beta: float):
    """The plain phase's eight planes: the word stream at (replica, word,
    0) through draw_planes, as _phase_plain draws them."""
    stream = multispin_rng.word_stream(key, nrep, nw, 1)
    return chm.draw_planes(lambda: stream().reshape(nrep, nw),
                           chm.accept_digit_planes(beta))


def _replayed(key, nrep: int, nw: int, beta: float):
    """The kernel's planes of every word: the table replayed over the
    helical counter (replica, word, 0, call), as (R, W) int64."""
    planes = _replayed_planes(chm.SPEC, _table(beta), key, (nrep, nw, 1))
    return [p.reshape(nrep, nw) for p in planes]


def _triplets(g, nrep: int, m: int):
    flat = torch.from_numpy(g.integers(0, 6, size=(nrep, m), dtype=np.int8))
    return chm.pack_clock_flat(flat, m)


@pytest.mark.parametrize("kbt", KBTS)
def test_replay_gives_the_plain_draw(kbt):
    """The table replayed over (replica, word, 0, call) gives the plain
    draw's eight planes bitwise, word by word, for several replicas."""
    beta = 1 / kbt
    key = rng.seeds_from_key(rng.base_key(31), 1)
    nrep, nw = 3, 7
    got = _replayed(key, nrep, nw, beta)
    want = _plain_planes(key, nrep, nw, beta)
    assert len(got) == len(want) == 8
    for g_, w_ in zip(got, want):
        assert torch.equal(g_ & MASK32, w_ & MASK32)


@pytest.mark.parametrize("kbt", KBTS)
@pytest.mark.parametrize("nx,ny", [(31, 30), (13, 12)])
def test_replayed_planes_drive_the_plain_phase(nx, ny, kbt):
    """One phase of each colour given the replayed planes
    (``packed_helical_phase6_reference``, the kernel's injected mode)
    equals the plain phase under the same key, bitwise."""
    m = nx * ny // 2
    nw = hms.words(m)
    beta = 1 / kbt
    g = np.random.default_rng(nx + int(kbt))
    a3, b3 = _triplets(g, 2, m), _triplets(g, 2, m)
    digit5 = chm.accept_digit_planes(beta)
    for color, offs in enumerate(hms.helical_offsets(nx)):
        x3, o3 = (a3, b3) if color == 0 else (b3, a3)
        key = rng.seeds_from_key(rng.base_key(41), color)
        planes = _replayed(key, 2, nw, beta)
        got = chm.packed_helical_phase6_reference(x3, o3, offs, planes, m)
        want, _ = chm._phase_plain(x3, o3, key, offs, m, digit5)
        for g_, w_ in zip(got, want):
            assert torch.equal(g_, chm._i32(w_))


def test_replayed_sweeps_give_the_plain_multisweep():
    """S = 3 sweeps of phases on the replayed planes under the (S, 2, 2)
    keys (each (sweep, phase) its own round keys) equal
    ``multisweep_plain``'s states, and their final state's sums its last
    sums."""
    nx, ny, beta = 31, 30, 1 / 0.8
    m = nx * ny // 2
    nw = hms.words(m)
    g = np.random.default_rng(5)
    a3, b3 = _triplets(g, 2, m), _triplets(g, 2, m)
    seeds = multispin_rng.sweep_phase_keys(
        rng.sample_key(rng.base_key(13), 2), 3, 4)
    offs_a, offs_b = hms.helical_offsets(nx)
    wa, wb = a3, b3
    for s in range(seeds.shape[0]):
        wa = chm.packed_helical_phase6_reference(
            wa, wb, offs_a, _replayed(seeds[s, 0], 2, nw, beta), m)
        wb = chm.packed_helical_phase6_reference(
            wb, wa, offs_b, _replayed(seeds[s, 1], 2, nw, beta), m)
    pa, pb, obs = chm.multisweep_plain(a3, b3, seeds, beta=beta, nx=nx, m=m)
    vm = hms.valid_mask(m, None)
    for g_, w_ in zip(wa + wb, pa + pb):
        assert torch.equal(hms._u32(g_) & vm, hms._u32(w_) & vm)
    assert torch.equal(chm.obs_packed6_reference(wa, wb, nx, m), obs[:, -1])


def test_table_is_refused_where_the_draw_cannot_follow_it():
    """The table's draw count stays within the 38 calls the unrolled line
    holds at every temperature the class runs; a longer draw is refused on
    the host."""
    for kbt in (0.05, 0.8, 0.91, 1e9):
        table = _table(1 / kbt)
        assert len(table) == 167 and table[-1] <= 4 * multispin_rng.CLOCK_CALLS
    with pytest.raises(ValueError):
        multispin_rng.clock_draw_table(12, ((1 << 28) - 1,) * 6, (28,) * 6)
