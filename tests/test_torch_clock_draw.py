"""The unrolled draw of the periodic packed clock kernel, on the CPU.

``csrc/clock_planes.cu`` draws a word's random planes in one unrolled line
(``csrc/clock_algebra.cuh`` ``draw_unrolled``) that follows a per-launch
table, ``ops/multispin_rng.clock_draw_table``: the proposal words (12
thermometer words for q = 6 and 4, one for q = 3), then chain after chain
of ``_chain_len`` digits, each draw folded into its chain by a digit from
the table.  Here the table is replayed in PyTorch over the Philox words of
the kernel's counter (replica, word row, column, draw / 4), as the kernel
folds them (the proposal calls, then the chain calls in pairs, a fast
call's four draws straight, the others draw by draw), and held bitwise
against ``draw_planes_plain``; the planes it gives drive the plain phase,
which equals ``phase_plain`` and the JAX package's oracle
(``phase_reference``) and its kernel in interpret mode; and a shard's
global offsets give the unsharded lattice's planes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_fortran_mc_simulation_spin_tpu.ops import clock3_multispin as jc3
from cuda_fortran_mc_simulation_spin_tpu.ops import clock4_multispin as jc4
from cuda_fortran_mc_simulation_spin_tpu.ops import clock_multispin as jc6
from cuda_fortran_mc_simulation_spin_tpu.ops import clock_planes as jcp
from cuda_fortran_mc_simulation_spin_tpu_torch import interop
from cuda_fortran_mc_simulation_spin_tpu_torch.core import lattice, rng
from cuda_fortran_mc_simulation_spin_tpu_torch.ops import clock3_multispin
from cuda_fortran_mc_simulation_spin_tpu_torch.ops import clock4_multispin
from cuda_fortran_mc_simulation_spin_tpu_torch.ops import clock_multispin
from cuda_fortran_mc_simulation_spin_tpu_torch.ops import clock_planes as cp
from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
    ising2d_multispin as msb,
)
from cuda_fortran_mc_simulation_spin_tpu_torch.ops import multispin_rng

MASK32 = 0xFFFFFFFF
PAIRS = {6: (clock_multispin, jc6), 4: (clock4_multispin, jc4),
         3: (clock3_multispin, jc3)}
# the clock classes' kbt (0.91 padded, 0.8 aligned); a high temperature
# (every chain 12 digits, all ones) and low ones (chains of up to 28
# digits, some drawing none)
KBTS = [0.91, 0.8, 1e9, 0.12, 0.05]
# explicit chains ((q, k), ...): 6-digit chains, five chains of 28 digits
# (the table's 152 draws), empty chains between non-empty ones, a chain
# end on a call's first draw and inside a call
CHAINS = [((5, 6), (33, 6), (1, 6), (63, 6), (32, 6)),
          (((1 << 28) - 1, 28),) * 5,
          ((0, 13), ((1 << 28) - 1, 28), (0, 28), (9, 6), (0, 1)),
          ((1 << 11, 12), (3, 4), (1, 1), (7, 3), ((1 << 20) + 1, 28))]


def _table_parts(table):
    """(digit, live, fast, at_end, ends, n_all) of a table: the masks as
    integers."""
    calls = multispin_rng.CLOCK_CALLS
    digit = table[:4 * calls]
    live_lo, live_hi, fast_lo, fast_hi = table[4 * calls:4 * calls + 4]
    at_end = sum(w << (32 * k)
                 for k, w in enumerate(table[4 * calls + 4:4 * calls + 9]))
    ends = table[4 * calls + 9:4 * calls + 14]
    return (digit, live_lo | live_hi << 32, fast_lo | fast_hi << 32, at_end,
            ends, table[-1])


def _fold(w, b, d):
    return (w & b) | (w & d) | (b & d)


def _replay(table, gen, n_prop: int, nc: int):
    """draw_unrolled over whole planes: (proposal words, the nc chains).
    The calls holding the proposal words first, their other draws folded
    draw by draw; then the chain calls in pairs (a pair's second call past
    the last draw drawn and dropped), a fast call's four draws straight,
    the others draw by draw, a chain ending at a draw (its ``at_end`` bit
    set) taking the running chain (an empty one 0); last the chains ending
    at n_all."""
    calls = multispin_rng.CLOCK_CALLS
    digit, live, fast, at_end, ends, n_all = _table_parts(table)
    tc = -(-n_prop // 4)
    first = [gen() for _ in range(4 * tc)]
    state = {"b": 0, "out": [0] * nc}

    def chain_draw(d, w):
        if at_end >> d & 1:
            for i in range(nc):
                if d == ends[i]:
                    state["out"][i], state["b"] = state["b"], 0
        state["b"] = _fold(w, state["b"], digit[d])

    for d in range(n_prop, 4 * tc):
        if d < n_all:
            chain_draw(d, first[d])
    for c0 in range(tc, calls, 2):
        if not live >> c0 & 1:
            break
        words = {c: [gen() for _ in range(4)]
                 for c in range(c0, min(c0 + 2, calls))}
        for c, w in words.items():
            if not live >> c & 1:
                continue
            for j in range(4):
                d = 4 * c + j
                if fast >> c & 1:
                    state["b"] = _fold(w[j], state["b"], digit[d])
                elif d < n_all:
                    chain_draw(d, w[j])
    for i in range(nc):
        if ends[i] == n_all:
            state["out"][i], state["b"] = state["b"], 0
    return first[:n_prop], state["out"]


def _proposal_planes(spec, words):
    """The proposal planes of the given proposal words (the spec's draw
    with empty chains, which draw none)."""
    it = iter(words)
    zero = tuple((0,) * len(d) for d in spec.accept_digits(1.0))
    return spec.draw(lambda: next(it), zero)[:spec.n_rand - len(zero)]


def _stream(key, shape, offs=(0, 0, 0)):
    return multispin_rng.word_stream(key, *shape, None, *offs)


def _replayed_planes(spec, table, key, shape, offs=(0, 0, 0)):
    n_prop = cp.proposal_words(spec.q)
    nc = len(spec.accept_digits(1.0))
    prop, chains = _replay(table, _stream(key, shape, offs), n_prop, nc)
    return [torch.as_tensor(p, dtype=torch.int64).expand(shape) & MASK32
            for p in (*_proposal_planes(spec, prop), *chains)]


def _words(g, shape, n):
    return [torch.from_numpy(g.integers(-2 ** 31, 2 ** 31, size=shape,
                                        dtype=np.int64).astype(np.int32))
            for _ in range(n)]


def test_table_layout_and_refusals():
    """167 words: 152 digits, the live and fast masks as (low, high)
    words, the chain-end mask as five words, five chain ends and the draws
    in all; the longest draw fills the 38 calls; a draw past them and a
    digit past 2^k are refused."""
    calls = multispin_rng.CLOCK_CALLS
    assert calls == 38 and multispin_rng.CLOCK_CHAINS == cp.MAX_CHAINS
    qs, ks = zip(*CHAINS[1])
    table = multispin_rng.clock_draw_table(12, qs, ks)
    digit, live, fast, at_end, ends, n_all = _table_parts(table)
    assert len(table) == 167 and n_all == 152 == 4 * calls
    assert ends == (40, 68, 96, 124, 152)
    assert at_end == sum(1 << e for e in ends[:-1])
    # empty chains end where the one before them does: one bit each end
    _, _, _, at_end, ends, n_all = _table_parts(
        multispin_rng.clock_draw_table(12, *zip(*CHAINS[2])))
    assert ends == (12, 40, 40, 46, 46) and n_all == 46
    assert at_end == 1 << 12 | 1 << 40
    assert live == (1 << calls) - 1
    # calls 0-2 hold the thermometer, calls 10, 17, 24, 31 a chain end
    assert fast == sum(1 << c for c in range(3, calls)
                       if c not in (10, 17, 24, 31))
    assert digit[:12] == (0,) * 12 and set(digit[12:]) == {MASK32}
    with pytest.raises(ValueError):
        multispin_rng.clock_draw_table(13, qs, ks)
    with pytest.raises(ValueError):
        multispin_rng.clock_draw_table(12, (64,), (6,))
    # kbt 0.91, q = 6: 81 chain digits, 78 of them drawn (trailing zero
    # digits draw none), 90 draws in 23 calls
    q6 = cp.draw_table(clock_multispin.SPEC, 1 / 0.91)
    qs, ks = cp.chain_words(clock_multispin.SPEC.accept_digits(1 / 0.91))
    assert sum(ks) == 81
    assert q6[-1] == 12 + sum(map(msb.chain_draws, qs, ks)) == 90
    assert _table_parts(q6)[1] == (1 << 23) - 1


@pytest.mark.parametrize("kbt", KBTS)
@pytest.mark.parametrize("q", [6, 4, 3])
def test_replay_gives_the_plain_draw_planes(q, kbt):
    """The table of ``draw_table`` replayed over the kernel's counter gives
    ``draw_planes_plain``'s planes bitwise, word by word."""
    spec = PAIRS[q][0].SPEC
    key = rng.seeds_from_key(rng.base_key(q), 1)
    shape = (2, 3, 5)
    want = cp.draw_planes_plain(spec, key, *shape, 1 / kbt)
    got = _replayed_planes(spec, cp.draw_table(spec, 1 / kbt), key, shape)
    assert len(got) == len(want) == spec.n_rand
    for g_, w_ in zip(got, want):
        assert torch.equal(g_, w_ & MASK32)


@pytest.mark.parametrize("chains", CHAINS)
@pytest.mark.parametrize("q", [6, 3])
def test_replay_of_explicit_chains(q, chains):
    """Chains of 6 to 28 digits, five of 28 (152 draws), empty chains and
    chain ends on and inside a call: the replay gives the plain chains
    (``_bern_plane``) drawn after the proposal words, in order."""
    spec = PAIRS[q][0].SPEC
    nc = len(spec.accept_digits(1.0))
    qs, ks = zip(*chains[:nc])
    key = rng.seeds_from_key(rng.base_key(40 + q), 0)
    shape = (1, 2, 3)
    n_prop = cp.proposal_words(q)
    table = multispin_rng.clock_draw_table(n_prop, qs, ks)
    gen = _stream(key, shape)
    prop = [gen() for _ in range(n_prop)]
    want = [msb._bern_plane(shape, msb._digits(qx, k), gen)
            for qx, k in zip(qs, ks)]
    got_prop, got = _replay(table, _stream(key, shape), n_prop, nc)
    for g_, w_ in zip(got_prop, prop):
        assert torch.equal(g_ & MASK32, w_ & MASK32)
    for g_, w_ in zip(got, want):
        assert torch.equal(torch.as_tensor(g_).expand(shape) & MASK32,
                           w_ & MASK32)


@pytest.mark.parametrize("q", [6, 4, 3])
@pytest.mark.parametrize("ny", [256, 248])
def test_replayed_planes_drive_the_plain_phase_and_jax(q, ny):
    """The packed phase given the replayed planes equals ``phase_plain``
    under the same key (states and the fused sums, both colours); at the
    aligned shape it equals the JAX oracle ``phase_reference``, at the
    padded one the JAX kernel in interpret mode (after its refresh), given
    the same planes."""
    port, jmod = PAIRS[q]
    spec, jspec = port.SPEC, jmod.SPEC
    half, beta = 128, 1 / 0.91
    nyw, nb = cp.words_rows(ny)
    g = np.random.default_rng(q + ny)
    full = g.integers(0, q, size=(1, ny, 2 * half)).astype(np.int8)
    a, b = lattice.split_checkerboard(torch.from_numpy(full))
    pa, pb = spec.pack_color(a), spec.pack_color(b)
    pad = jcp.padded_spec(ny, half)
    for color in (0, 1):
        key = rng.seeds_from_key(rng.base_key(7), color)
        x, o = (pa, pb) if color == 0 else (pb, pa)
        rand = _replayed_planes(spec, cp.draw_table(spec, beta), key,
                                (1, nyw, half))
        measuring = color == 1
        got = cp.phase_reference(spec, x, o, color, rand, ny=ny,
                                 measuring=measuring)
        want = cp.phase_plain(spec, x, o, key, color=color, beta=beta,
                              ny=ny, measuring=measuring)
        new = got[0] if measuring else got
        for g_, w_ in zip(new, want[0] if measuring else want):
            assert torch.equal(g_, w_)
        if measuring:
            assert torch.equal(got[1], want[1])
        # the JAX side on its own layout, given the same planes
        cols = (a, b) if color == 0 else (b, a)
        if pad is None:
            jx = tuple(jspec.pack_color(jnp.asarray(cols[0].numpy())))
            jo = tuple(jspec.pack_color(jnp.asarray(cols[1].numpy())))
            jrand = tuple(jnp.asarray(cp._i32(r).numpy()) for r in rand)
            jnew = jcp.phase_reference(jspec, jx, jo, color, jrand)
        else:
            jx = jcp.pack_color_padded(jspec, jnp.asarray(cols[0].numpy()),
                                       pad)
            jo = jcp.refresh_padded(jcp.pack_color_padded(
                jspec, jnp.asarray(cols[1].numpy()), pad), pad)
            shp = jx[0].shape
            jrand = tuple(jnp.asarray(np.pad(
                cp._i32(r).numpy(), ((0, 0), (0, shp[-2] - nyw),
                                     (0, shp[-1] - half))))
                for r in rand)
            jnew = jcp.phase_packed(
                jspec, jx, jo, jnp.zeros((2,), jnp.int32), color=color,
                beta=beta, inject=jrand, interpret=True)
        jwant = interop.clock_from_numpy([np.asarray(p) for p in jnew], ny,
                                         half)
        for g_, w_ in zip(new, jwant):
            assert torch.equal(g_, w_)


@pytest.mark.parametrize("q", [6, 3])
def test_replay_follows_a_shards_global_counter(q):
    """A shard at global (rep0, wrow0, col0) draws the unsharded planes'
    words: the replay at the shard's counter equals the slice of the
    whole lattice's plain planes, and the plain sharded phase's draw."""
    spec = PAIRS[q][0].SPEC
    beta = 1 / 0.8
    key = rng.seeds_from_key(rng.base_key(11), 0)
    whole = cp.draw_planes_plain(spec, key, 3, 4, 6, beta)
    offs, shape = (1, 2, 3), (2, 2, 3)
    got = _replayed_planes(spec, cp.draw_table(spec, beta), key, shape,
                           offs)
    for g_, w_ in zip(got, whole):
        assert torch.equal(g_, w_[1:3, 2:4, 3:6] & MASK32)
    g = np.random.default_rng(q)
    x = _words(g, shape, spec.n_state)
    o = _words(g, shape, spec.n_state)
    hup = [torch.from_numpy(g.integers(0, 2, size=(2, 1, 3)).astype(
        np.int32)) for _ in range(spec.n_state)]
    hdn = [torch.from_numpy(g.integers(0, 2, size=(2, 1, 3)).astype(
        np.int32)) for _ in range(spec.n_state)]
    lf = [w[:, :, :1].contiguous() for w in _words(g, shape, spec.n_state)]
    rt = [w[:, :, :1].contiguous() for w in _words(g, shape, spec.n_state)]
    kw = dict(color=0, beta=beta, halo_lf=lf, halo_rt=rt, measuring=True)
    want = cp.sharded_phase_packed_plain(spec, x, o, hup, hdn, key, offs,
                                         **kw)
    inj = cp.sharded_phase_packed_plain(spec, x, o, hup, hdn, key, offs,
                                        inject=got, **kw)
    for w_, i_ in zip(want[0], inj[0]):
        assert torch.equal(w_, i_)
    assert torch.equal(want[1], inj[1]) and torch.equal(want[2], inj[2])
