"""Port-internal bitwise properties of the packed engine on the CPU
(plain versions): multisweep = streaming phase pairs, runner results
independent of host chunking and of the route, and the wrappers' CPU
dispatch."""

import numpy as np
import pytest
import torch

from cuda_fortran_mc_simulation_spin_tpu_torch.core import rng
from cuda_fortran_mc_simulation_spin_tpu_torch.engine import sweep
from cuda_fortran_mc_simulation_spin_tpu_torch.models import Ising2D
from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
    ising2d_multispin as msb,
)

KBT = 2.26918531421


def _planes(nrep, ny, nx, seed):
    g = np.random.default_rng(seed)
    return [torch.from_numpy(g.integers(-2 ** 31, 2 ** 31,
                                        size=(nrep, ny // 32, nx // 2),
                                        dtype=np.int64).astype(np.int32))
            for _ in range(2)]


@pytest.mark.parametrize("sweeps", [1, 5])
def test_plain_multisweep_equals_streaming_pairs(sweeps):
    """S plain multisweep sweeps == S plain phase pairs with the same
    keys, in state and in the (R, S) observables."""
    wa, wb = _planes(2, 256, 256, sweeps)
    seeds = msb.sweep_seed_pairs(rng.sample_key(rng.base_key(3), 1), sweeps,
                                 t0=40)
    ma, mb, mobs = msb.multisweep_planes_plain(wa, wb, seeds, beta=1 / KBT)
    pa, pb, obs = wa, wb, []
    for s in range(sweeps):
        pa = msb.phase_packed_plain(pa, pb, seeds[s, 0], color=0,
                                    beta=1 / KBT)
        pb, o = msb.phase_packed_plain(pb, pa, seeds[s, 1], color=1,
                                       beta=1 / KBT, measuring=True)
        obs.append(o)
    assert mobs.shape == (2, sweeps, 2) and mobs.dtype == torch.int64
    assert torch.equal(ma, pa) and torch.equal(mb, pb)
    assert torch.equal(mobs, torch.stack(obs, dim=1))


def test_model_level_multisweep_equals_measured_sweeps():
    """multisweep_packed (global-t keys) == sweep_measure_packed one sweep
    at a time with rng.sweep_key of the same global t."""
    model = Ising2D(nx=256, ny=256, kbt=KBT)
    wa, wb = _planes(3, 256, 256, 11)
    key = rng.sample_key(rng.base_key(42), 2)
    ma, mb, mo = msb.multisweep_packed(model, wa, wb, key, 4, t0=8)
    sa, sb, ms, es = wa, wb, [], []
    for t in range(9, 13):
        sa, sb, o = msb.sweep_measure_packed(model, sa, sb,
                                             rng.sweep_key(key, t))
        ms.append(o["m"])
        es.append(o["e"])
    assert torch.equal(ma, sa) and torch.equal(mb, sb)
    assert torch.equal(mo["m"], torch.stack(ms, 1))
    assert torch.equal(mo["e"], torch.stack(es, 1))
    assert mo["m"].dtype == torch.float64
    # sweep_packed is the same sweep without the observables
    pa, pb = msb.sweep_packed(model, wa, wb, rng.sweep_key(key, 9))
    qa, qb, _ = msb.sweep_measure_packed(model, wa, wb,
                                         rng.sweep_key(key, 9))
    assert torch.equal(pa, qa) and torch.equal(pb, qb)


@pytest.mark.parametrize("resident", [True, False])
@pytest.mark.parametrize("init_kind", ["allup", "random"])
def test_runner_is_independent_of_host_chunking(resident, init_kind):
    model = Ising2D(nx=256, ny=256, kbt=KBT)
    key = rng.sample_key(rng.base_key(42), 0)
    outs = [sweep._make_packed_runner(model, 13, 2, init_kind, resident,
                                      "cpu", chunk)(key)
            for chunk in (13, 4, 64)]
    for o in outs[1:]:
        for k in ("m", "e"):
            assert o[k].shape == (2, 13)
            assert torch.equal(o[k], outs[0][k])


def test_resident_and_streaming_routes_are_bitwise_equal():
    """The two routes consume the same Philox words, so the multisweep
    and the streamed phase pairs give one trajectory."""
    model = Ising2D(nx=256, ny=256, kbt=KBT)
    key = rng.sample_key(rng.base_key(1), 5)
    res = sweep._make_packed_runner(model, 9, 2, "allup", True, "cpu",
                                    4)(key)
    stm = sweep._make_packed_runner(model, 9, 2, "allup", False, "cpu",
                                    4)(key)
    for k in ("m", "e"):
        assert torch.equal(res[k], stm[k])


def test_make_multispin_runner_routes_and_tags():
    small = sweep.make_multispin_runner(Ising2D(256, 256, KBT), 3, 1,
                                        device="cpu")
    assert small.engine.endswith("(resident multisweep)")
    # the slice's two classes: 2048^2 x 16 resident, 8192^2 x 4 streaming
    assert msb.multisweep_fits(16, *Ising2D(2048, 2048, KBT).color_shape)
    big = Ising2D(nx=8192, ny=8192, kbt=KBT)
    assert msb.multisweep_fits(1, *big.color_shape)
    assert not msb.multisweep_fits(4, *big.color_shape)
    assert sweep.make_multispin_runner(big, 3, 4, device="cpu").engine \
        .endswith("(streaming phase pairs)")
    out = small(rng.sample_key(rng.base_key(0), 0))
    assert out["m"].shape == (1, 3)
    assert float(out["m"][0, 0]) < 1.0


def test_wrappers_take_plain_versions_on_cpu_and_count_no_launch():
    msb.reset_launches()
    model = Ising2D(nx=256, ny=256, kbt=KBT)
    wa, wb = _planes(1, 256, 256, 2)
    key = rng.sample_key(rng.base_key(0), 0)
    msb.multisweep_packed(model, wa, wb, key, 2)
    msb.sweep_measure_packed(model, wa, wb, rng.sweep_key(key, 1))
    msb.phase_packed_with_bits(wa, wb, wa, wb, color=0)
    h = torch.zeros((wa.shape[0], 1, wa.shape[2]), dtype=torch.int32)
    msb.sharded_phase_packed(wa, wb, h, h, (0, 0), (0, 0), color=1,
                             beta=0.2, measuring=True)
    assert msb.LAUNCHES == {"phase": 0, "phase_measuring": 0,
                            "multisweep": 0, "shard_phase": 0}


def test_kernel_argument_checks():
    wa, wb = _planes(1, 256, 256, 4)
    with pytest.raises(ValueError, match="CUDA"):
        msb._check_planes(wa, wb)
    with pytest.raises(ValueError, match="int32"):
        msb._check_planes(wa.to(torch.int64), wb)
    with pytest.raises(ValueError, match="nyp"):
        msb._check_planes(torch.zeros((1, 4, 128), dtype=torch.int32))
    with pytest.raises(ValueError, match="device"):
        msb.phase_packed(wa.to("meta"), wb.to("meta"), (0, 0), color=0,
                         beta=0.4)


def test_chain_draws_count_chain_words():
    assert msb.chain_draws(0) == 0
    assert msb.chain_draws(1) == 20               # only d_20 set
    assert msb.chain_draws(1 << 19) == 1          # only d_1 set
    assert msb.chain_draws(0b1010 << 8) == 20 - 9
