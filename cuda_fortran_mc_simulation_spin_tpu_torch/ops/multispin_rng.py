"""Random words of the bit-packed engines, keyed by logical coordinates.

Port of ``cuda_fortran_mc_simulation_spin_tpu/ops/multispin_rng.py``.  In
JAX the words for word rows [8g, 8g+8) of one (sample, t, phase) come
from the TPU's hardware PRNG seeded by (s0, s1 ^ (wrow_g*K_row +
rep_g*K_rep)); those bits have no GPU counterpart.  Here every word is
drawn from Philox4x32-10:

    key     = (s0, s1) of the (sample, t, phase)   (core/rng.seeds_from_key)
    counter = (replica, word row, column, n // 4)
    word    = output n % 4                         for draw n = 0, 1, ...

The 3-D engine stacks its z-planes along the word rows (word row z·nyp +
Y) and the helical engines name word g of a colour vector as (g, 0), so
one counter layout serves them all; a word index below 2^32 (the helical
3-D engine's 15.6 M words a colour at 1001x1000x1000) never aliases.  The CUDA kernels evaluate the same
function per thread (``csrc/philox.cuh`` ``philox_rk``); :func:`word_stream`
is its plain PyTorch version on whole planes.  Because the counter names the word's
global position, the bits depend on neither the tiling, the host chunking
nor the kernel, and every run is deterministic.

The periodic 2-D and the 3-D Ising kernels (``csrc/ising2d_multispin.cu``,
``csrc/ising3d_multispin.cu``, ``csrc/helical3d_multispin.cu``) draw their
Bernoulli chains (two in 2-D, the third empty) from these words in one
unrolled line (``csrc/bernoulli.cuh`` ``chain_planes``) that follows a
per-launch table, :func:`chain_table`; the packed clock kernels, periodic
and helical (``csrc/clock_planes.cu``, ``csrc/clock_helical_multispin.cu``),
draw their proposal words and chains the same way
(``csrc/clock_algebra.cuh`` ``draw_unrolled``) from
:func:`clock_draw_table`.
"""

from __future__ import annotations

import functools
from typing import Callable

import torch

from cuda_fortran_mc_simulation_spin_tpu_torch.core import rng

CHAIN_BITS = 20    # Bernoulli-chain resolution: P quantized to 2^-20
# Philox calls of the unrolled chains: 60 draws, three chains of
# CHAIN_BITS digits (CHAIN_CALLS in csrc/bernoulli.cuh)
CHAIN_CALLS = 15
# Philox calls of the unrolled clock draw: 152 draws, 12 thermometer words
# and five chains of 28 digits (DRAW_CALLS in csrc/clock_algebra.cuh)
CLOCK_CALLS = 38
CLOCK_CHAINS = 5
_ONES = 0xFFFFFFFF


def word_stream(key, nrep: int, nyp: int, half: int, device=None,
                rep0: int = 0, row0: int = 0, col0: int = 0
                ) -> Callable[[], torch.Tensor]:
    """``gen()`` returning draw 0, 1, ... as (nrep, nyp, half) uint32
    planes (int64 tensors) under the phase key ``key`` ((2,) uint32); a
    shard of a mesh passes its global offsets (replica, word row, word
    column), so that it draws the unsharded planes' words."""
    key = torch.as_tensor(key, dtype=torch.int64).to(device)

    def ax(n, start):
        return torch.arange(start, start + n, dtype=torch.int64,
                            device=device)

    r = ax(nrep, rep0).view(-1, 1, 1)
    y = ax(nyp, row0).view(1, -1, 1)
    x = ax(half, col0).view(1, 1, -1)
    r, y, x = torch.broadcast_tensors(r, y, x)
    state = {"n": 0, "buf": None}

    def gen() -> torch.Tensor:
        n = state["n"]
        if n % 4 == 0:
            ctr = torch.stack([r, y, x, torch.full_like(r, n // 4)], dim=-1)
            state["buf"] = rng.philox4x32(ctr, key)
        state["n"] = n + 1
        return state["buf"][..., n % 4]

    return gen


def keys_to(seeds, device) -> torch.Tensor:
    """The (S, 2, 2) phase keys as int32 (two's complement of the uint32
    words) on ``device`` without waiting for the card: copied from a
    pinned host tensor with ``non_blocking``.  PyTorch's pinned-memory
    allocator keeps that host block from reuse until the copy, recorded on
    the current stream, has completed, so the keys stay alive.  A copy
    from pageable memory instead synchronises the stream: the card sits
    idle from the previous launch's end to this one's."""
    keys = torch.as_tensor(seeds).to(torch.int64)
    keys = torch.where(keys >= 2 ** 31, keys - 2 ** 32, keys).to(
        torch.int32).contiguous()
    if keys.device.type == "cpu":
        return keys.pin_memory().to(device, non_blocking=True)
    return keys.to(device)


def sweep_phase_keys(key, sweeps: int, t0: int = 0, phases: int = 2
                     ) -> torch.Tensor:
    """(sweeps, phases, 2) uint32 Philox keys of (sub-)phases 0 ..
    phases-1 of global sweeps t0+1 .. t0+sweeps of the sample keyed by
    ``key``: ``seeds_from_key(sweep_key(key, t), p)``.  Two phases a
    sweep for the checkerboard engines, four for the helical 3-D engine
    at even nx·ny (colour a z-parity 0, 1, then colour b), so every
    sub-phase draws under its own key."""
    ts = t0 + torch.arange(1, sweeps + 1, dtype=torch.int64)
    keys = rng.sweep_key(key, ts)
    return torch.stack([rng.seeds_from_key(keys, p) for p in range(phases)],
                       dim=1)


@functools.lru_cache(maxsize=64)
def chain_table(q: tuple[int, int, int]) -> tuple[int, ...]:
    """The table of the chains B4, B8, B12 of digits ``q`` (each
    round(p·2^20)) that ``csrc/bernoulli.cuh`` ``chain_planes`` follows,
    the 65 words of its ChainTable: for draw n = 0 .. 59 its digit
    (all ones on a one digit, 0 on a zero digit; draw n is word n % 4 of
    Philox call n // 4), then bit masks ``live`` (call c has a draw below
    n_all) and ``fast`` (draws 4c .. 4c + 3 all lie below n_all in one
    chain), then e4, e8, n_all: the chains take draws [0, e4), [e4, e8)
    and [e8, n_all), each from its lowest one digit up to digit
    CHAIN_BITS - 1, as ``ops/ising2d_multispin._bern_plane`` draws them (a
    chain of q = 0 draws none)."""
    digit, ends = [], []
    for qx in q:
        if not 0 <= qx < 1 << CHAIN_BITS:
            raise ValueError(f"chain digits q = {qx} outside [0, 2^"
                             f"{CHAIN_BITS})")
        if qx:
            low = (qx & -qx).bit_length() - 1
            digit += [_ONES if (qx >> k) & 1 else 0
                      for k in range(low, CHAIN_BITS)]
        ends.append(len(digit))
    e4, e8, n_all = ends
    live = fast = 0
    for c in range(CHAIN_CALLS):
        lo = 4 * c
        if lo < n_all:
            live |= 1 << c
        if lo + 4 <= n_all and not any(lo <= e < lo + 4 for e in (e4, e8)):
            fast |= 1 << c
    digit += [0] * (4 * CHAIN_CALLS - n_all)
    return (*digit, live, fast, e4, e8, n_all)


def check_chain_table(table) -> tuple[int, ...]:
    """``table`` if ``csrc/bernoulli.cuh`` ``chain_table_ok`` takes it (65
    words, 0 <= e4 <= e8 <= n_all <= 4·CHAIN_CALLS: the chains the
    unrolled loop can follow), else ValueError; the C entry points refuse
    such a table too."""
    table = tuple(int(v) for v in table)
    if len(table) != 4 * CHAIN_CALLS + 5:
        raise ValueError(f"a chain table has {4 * CHAIN_CALLS + 5} words, "
                         f"got {len(table)}")
    e4, e8, n_all = table[-3:]
    if not 0 <= e4 <= e8 <= n_all <= 4 * CHAIN_CALLS:
        raise ValueError(f"chain table ends (e4, e8, n) = {(e4, e8, n_all)} "
                         f"outside 0 <= e4 <= e8 <= n <= {4 * CHAIN_CALLS}")
    return table


def _masks(ok) -> tuple[int, int]:
    """Bit c of (lo, hi) set where ``ok(c)``, c < 64."""
    m = sum(1 << c for c in range(CLOCK_CALLS) if ok(c))
    return m & _ONES, m >> 32


@functools.lru_cache(maxsize=64)
def clock_draw_table(n_prop: int, qs: tuple[int, ...],
                     ks: tuple[int, ...]) -> tuple[int, ...]:
    """The table of a packed clock word's draw that ``csrc/
    clock_algebra.cuh`` ``draw_unrolled`` follows, the 167 words of its
    DrawTable: ``n_prop`` proposal words (12 thermometer words, or q = 3's
    one) are draws [0, n_prop); then chain i (digits ``qs[i]`` =
    round(p·2^k), ``ks[i]`` = k of them; at most five, padded with empty
    chains) takes draws [end[i-1], end[i]), from its lowest one digit up to
    digit k - 1, as ``ops/ising2d_multispin._bern_plane`` draws it (a chain
    of q = 0 draws none).  Words: for draw n = 0 .. 151 its digit (all ones
    on a one digit, 0 on a zero digit or a proposal word; draw n is word
    n % 4 of Philox call n // 4), then the masks ``live`` (call c has a
    draw below n_all) and ``fast`` (draws 4c .. 4c + 3 are all chain draws
    below n_all, no chain end among them) as (low, high) 32-bit words, the
    mask ``ends`` (bit d: a chain ends at draw d < n_all) as five 32-bit
    words, end[0 .. 4] and n_all."""
    if len(qs) != len(ks) or len(qs) > CLOCK_CHAINS:
        raise ValueError(f"at most {CLOCK_CHAINS} chains, got {len(qs)}")
    digit, ends = [0] * n_prop, []
    for qx, k in zip(qs, ks):
        if not 0 <= qx < 1 << k:
            raise ValueError(f"chain digits q = {qx} outside [0, 2^{k})")
        if qx:
            low = (qx & -qx).bit_length() - 1
            digit += [_ONES if (qx >> b) & 1 else 0 for b in range(low, k)]
        ends.append(len(digit))
    n_all = len(digit)
    if n_all > 4 * CLOCK_CALLS:
        raise ValueError(f"{n_all} draws pass the table's "
                         f"{4 * CLOCK_CALLS}")
    ends += [n_all] * (CLOCK_CHAINS - len(ends))
    live = _masks(lambda c: 4 * c < n_all)
    fast = _masks(lambda c: n_prop <= 4 * c and 4 * c + 4 <= n_all and
                  not any(4 * c <= e < 4 * c + 4 for e in ends))
    at_end = sum(1 << e for e in set(ends) if e < n_all)
    digit += [0] * (4 * CLOCK_CALLS - n_all)
    return (*digit, *live, *fast,
            *((at_end >> (32 * k)) & _ONES for k in range(5)), *ends, n_all)
