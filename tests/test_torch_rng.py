"""Port: Philox4x32-10 and the key tree (core/rng.py), and the packed
engines' word streams (ops/multispin_rng.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_fortran_mc_simulation_spin_tpu.core import rng as jrng
from cuda_fortran_mc_simulation_spin_tpu_torch.core import rng
from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
    ising2d_multispin as msb,
    multispin_rng,
)

# Random123's known-answer vectors for philox4x32_10 (kat_vectors)
KAT = [
    ([0, 0, 0, 0], [0, 0],
     [0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]),
    ([0xFFFFFFFF] * 4, [0xFFFFFFFF] * 2,
     [0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD]),
    ([0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344],
     [0xA4093822, 0x299F31D0],
     [0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1]),
]


@pytest.mark.parametrize("ctr,key,want", KAT)
def test_philox_known_answers(ctr, key, want):
    got = rng.philox4x32(torch.tensor(ctr), torch.tensor(key))
    assert got.tolist() == want


def test_philox_broadcasts_like_scalar_calls():
    ctr = torch.tensor([[1, 2, 3, 4], [5, 6, 7, 8], [9, 10, 11, 12]])
    key = torch.tensor([77, 0xDEADBEEF])
    batched = rng.philox4x32(ctr, key)
    for i in range(3):
        assert batched[i].tolist() == rng.philox4x32(ctr[i], key).tolist()


def test_key_tree_purpose_domains_are_disjoint():
    """No sweep-t key equals the init key (the reason the JAX module
    keeps the domains apart), and samples and streams differ."""
    k = rng.sample_key(rng.base_key(42), 3)
    sweeps = rng.sweep_key(k, torch.arange(0, 4096))
    keys = {tuple(v) for v in sweeps.tolist()}
    assert len(keys) == 4096
    assert tuple(rng.init_key(k).tolist()) not in keys
    assert (rng.sample_key(rng.base_key(42), 4).tolist() != k.tolist())
    assert rng.base_key(42, 1).tolist() != rng.base_key(42, 0).tolist()


def test_seed_pairs_match_per_sweep_derivation():
    """sweep_seed_pairs (the multisweep's keys) equals the per-sweep
    derivation the streaming path uses."""
    k = rng.sample_key(rng.base_key(5), 0)
    pairs = msb.sweep_seed_pairs(k, 9, t0=17)
    for s in range(9):
        sk = rng.sweep_key(k, 17 + s + 1)
        assert pairs[s].tolist() == msb._phase_seeds(sk).tolist()
        for ph in (0, 1):
            assert pairs[s, ph].tolist() == rng.seeds_from_key(
                sk, ph).tolist()


def test_word_stream_is_philox_at_global_coordinates():
    """Draw n of word (r, Y, i) is word n % 4 of Philox at counter
    (r, Y, i, n // 4) under the phase key."""
    key = torch.tensor([0x12345678, 0x9ABCDEF0])
    gen = multispin_rng.word_stream(key, 2, 3, 5)
    draws = [gen() for _ in range(6)]
    for r, y, x in [(0, 0, 0), (1, 2, 4), (1, 0, 3)]:
        for n in range(6):
            want = rng.philox4x32(torch.tensor([r, y, x, n // 4]), key)
            assert int(draws[n][r, y, x]) == int(want[n % 4])


def test_bits_to_uniform_matches_jax():
    bits = np.random.default_rng(0).integers(0, 2 ** 32, 4096,
                                             dtype=np.uint64)
    want = np.asarray(jrng.bits_to_uniform(jnp.asarray(bits.astype(
        np.uint32))))
    got = rng.bits_to_uniform(torch.from_numpy(bits.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want)


def test_uniform_statistics():
    u = rng.uniform(rng.base_key(1), (256, 256))
    assert u.dtype == torch.float32
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    n = u.numel()
    assert abs(float(u.mean()) - 0.5) < 5 * (1 / 12 / n) ** 0.5
