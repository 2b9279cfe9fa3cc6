"""CUDA kernels against their plain versions on the card (bitwise).

These need an NVIDIA GPU with nvcc; without one they skip (the check is
made inside the fixture, never at import).  chip_smoke.py runs the same
checks, at the main path's shapes, on the card."""

import numpy as np
import pytest
import torch

from cuda_fortran_mc_simulation_spin_tpu_torch.core import rng
from cuda_fortran_mc_simulation_spin_tpu_torch.models import Ising2D
from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
    ising2d_multispin as msb,
)

KBT = 2.26918531421


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


def _planes(dev, nrep=2, ny=512, nx=512, seed=0):
    g = np.random.default_rng(seed)
    return [torch.from_numpy(g.integers(-2 ** 31, 2 ** 31,
                                        size=(nrep, ny // 32, nx // 2),
                                        dtype=np.int64).astype(np.int32)
                             ).to(dev) for _ in range(4)]


@pytest.mark.cuda
@pytest.mark.parametrize("color", [0, 1])
def test_phase_kernel_matches_plain(cuda, color):
    x, o, b4, b8 = _planes(cuda, seed=color)
    seeds = rng.seeds_from_key(rng.base_key(3), color)
    assert torch.equal(
        msb.phase_packed_with_bits(x, o, b4, b8, color=color),
        msb.packed_phase_reference(x, o, color, b4, b8))
    got, obs = msb.phase_packed(x, o, seeds, color=color, beta=1 / KBT,
                                measuring=True)
    want, wobs = msb.phase_packed_plain(x, o, seeds, color=color,
                                        beta=1 / KBT, measuring=True)
    assert torch.equal(got, want) and torch.equal(obs, wobs)


@pytest.mark.cuda
def test_multisweep_kernel_matches_phase_pairs(cuda):
    wa, wb = _planes(cuda, seed=5)[:2]
    seeds = msb.sweep_seed_pairs(rng.sample_key(rng.base_key(1), 0), 8)
    ka, kb, kobs = msb.multisweep_planes(wa, wb, seeds, beta=1 / KBT)
    pa, pb, obs = wa, wb, []
    for s in range(8):
        pa = msb.phase_packed(pa, pb, seeds[s, 0], color=0, beta=1 / KBT)
        pb, o = msb.phase_packed(pb, pa, seeds[s, 1], color=1,
                                 beta=1 / KBT, measuring=True)
        obs.append(o)
    assert torch.equal(ka, pa) and torch.equal(kb, pb)
    assert torch.equal(kobs, torch.stack(obs, dim=1))


@pytest.mark.cuda
def test_cuda_runner_equals_cpu_runner(cuda):
    """The main path's runner gives the same series on the card as its
    plain versions on the CPU."""
    from cuda_fortran_mc_simulation_spin_tpu_torch.engine import sweep
    model = Ising2D(nx=256, ny=256, kbt=KBT)
    key = rng.sample_key(rng.base_key(42), 0)
    for resident in (True, False):
        on_card = sweep._make_packed_runner(model, 10, 2, "allup", resident,
                                            cuda, 4)(key)
        on_cpu = sweep._make_packed_runner(model, 10, 2, "allup", resident,
                                           "cpu", 4)(key)
        for k in ("m", "e"):
            assert torch.equal(on_card[k].cpu(), on_cpu[k])
