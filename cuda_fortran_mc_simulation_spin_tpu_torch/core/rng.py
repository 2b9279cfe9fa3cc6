"""Counter-based random streams on Philox4x32-10.

Port of ``cuda_fortran_mc_simulation_spin_tpu/core/rng.py``.  The JAX
package keys every draw by its logical coordinates through threefry
``fold_in`` chains; here the same key tree is rebuilt on Philox4x32-10
(Salmon et al., "Parallel random numbers: as easy as 1, 2, 3", SC'11),
the generator the CUDA kernels evaluate in-kernel
(``csrc/philox.cuh``).  The two packages draw different bits from the
same seed; each is deterministic, and the tree has the same shape:

    base_key(seed, stream) -> sample_key(., sample)
        -> sweep_key(., t)     (purpose domain _DOM_SWEEP)
        -> init_key(.)         (purpose domain _DOM_INIT)
        (_DOM_PREPARE stays reserved; the XY preparations draw under
        phase keys 2 and 3 of a replica's init key, beside the random
        start's 0 and 1)
    seeds_from_key(sweep_key, phase) -> (s0, s1), the Philox key of the
        random words of one (sample, t, phase) in the packed kernels.

A key is an int64 tensor of shape (..., 2) holding two uint32 words.
``fold_in(key, v)`` is Philox4x32-10 of the counter (v, 0, 0, 0) under
``key``, truncated to two words: a bijection in v for a fixed key, so
children of one node never collide.  The purpose domains stay disjoint
for the reason the JAX module gives (its lines 48-58): sweep-t keys sit
one level below the _DOM_SWEEP child, so no init key can equal
the key of any sweep index t.

Arithmetic runs on int64 tensors that hold uint32 values, so the plain
version works on any device and matches the kernel's uint32 algebra
bitwise; 32x32-bit products are split into 16-bit halves so that no
intermediate leaves int64.
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
PHILOX_M0 = 0xD2511F53
PHILOX_M1 = 0xCD9E8D57
PHILOX_W0 = 0x9E3779B9
PHILOX_W1 = 0xBB67AE85
PHILOX_ROUNDS = 10

_DOM_SWEEP, _DOM_INIT, _DOM_PREPARE = 0, 1, 2


def _mulhilo(m: int, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) 32-bit words of the 64-bit product m * b (b: uint32 in
    int64), with every intermediate below 2^49."""
    lo16 = m * (b & 0xFFFF)
    hi16 = m * (b >> 16)
    lo = (lo16 + ((hi16 & 0xFFFF) << 16)) & MASK32
    hi = (hi16 + (lo16 >> 16)) >> 16
    return hi, lo


def philox4x32(ctr: torch.Tensor, key: torch.Tensor,
               rounds: int = PHILOX_ROUNDS) -> torch.Tensor:
    """Philox4x32 (default 10 rounds) of counters (..., 4) under keys
    (..., 2), broadcasting; uint32 words in int64, result (..., 4)."""
    c0, c1, c2, c3 = (ctr[..., j] for j in range(4))
    k0, k1 = key[..., 0], key[..., 1]
    for r in range(rounds):
        if r:
            k0 = (k0 + PHILOX_W0) & MASK32
            k1 = (k1 + PHILOX_W1) & MASK32
        hi0, lo0 = _mulhilo(PHILOX_M0, c0)
        hi1, lo1 = _mulhilo(PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return torch.stack(torch.broadcast_tensors(c0, c1, c2, c3), dim=-1)


def _as_u32(v, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.int64, device=like.device) & MASK32


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """Child key of ``key`` for the integer(s) ``data`` (broadcasting)."""
    d = _as_u32(data, key)
    zero = torch.zeros_like(d)
    ctr = torch.stack([d, zero, zero, zero], dim=-1)
    return philox4x32(ctr, key)[..., :2]


def base_key(seed: int, stream: int = 0) -> torch.Tensor:
    """Root key for one run. ``stream`` is the reference's `n_skip` slot."""
    root = torch.tensor([seed & MASK32, (seed >> 32) & MASK32],
                        dtype=torch.int64)
    return fold_in(root, stream)


def sample_key(key: torch.Tensor, sample) -> torch.Tensor:
    return fold_in(key, sample)


def sweep_key(key: torch.Tensor, t) -> torch.Tensor:
    """Key for sweep t (int or int tensor) of the history keyed by ``key``."""
    return fold_in(fold_in(key, _DOM_SWEEP), t)


def init_key(key: torch.Tensor) -> torch.Tensor:
    """Key for the initial-state draw of the history keyed by ``key``."""
    return fold_in(key, _DOM_INIT)


def phase_key(key: torch.Tensor, phase: int) -> torch.Tensor:
    return fold_in(key, phase)


def seeds_from_key(key: torch.Tensor, phase) -> torch.Tensor:
    """(..., 2) uint32 Philox key (s0, s1) of the random words of one
    checkerboard phase, from a sweep key: the port's counterpart of
    ``ops/ising2d_pallas.seeds_from_key`` (its lines 153-164)."""
    return fold_in(key, phase)


def random_bits(key: torch.Tensor, shape, device=None) -> torch.Tensor:
    """uint32 words (in int64) of the given shape: word n is the first
    Philox output of the counter (n, 0, 0, 0) under ``key``."""
    n = 1
    for s in shape:
        n *= int(s)
    idx = torch.arange(n, dtype=torch.int64, device=device)
    zero = torch.zeros_like(idx)
    ctr = torch.stack([idx & MASK32, idx >> 32, zero, zero], dim=-1)
    return philox4x32(ctr, key.to(idx.device))[..., 0].reshape(tuple(shape))


def bits_to_uniform(bits: torch.Tensor) -> torch.Tensor:
    """uint32 words -> f32 uniform in [0, 1) from the top 24 bits (exactly
    representable), as the JAX module does."""
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))


def uniform(key: torch.Tensor, shape, device=None) -> torch.Tensor:
    """U[0, 1) f32 of the given shape under ``key``."""
    return bits_to_uniform(random_bits(key, shape, device))
