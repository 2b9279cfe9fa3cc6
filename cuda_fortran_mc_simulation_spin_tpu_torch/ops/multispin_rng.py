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
function per thread (``csrc/philox.cuh`` ``WordStream``); :func:`word_stream`
is its plain PyTorch version on whole planes.  Because the counter names the word's
global position, the bits depend on neither the tiling, the host chunking
nor the kernel, and every run is deterministic.
"""

from __future__ import annotations

from typing import Callable

import torch

from cuda_fortran_mc_simulation_spin_tpu_torch.core import rng


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
