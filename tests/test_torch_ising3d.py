"""Port vs JAX on the same numpy inputs: the periodic 3-D Ising slice.

The dual-colour 3-D lattice algebra and packing (bitwise), the packed
phase with injected Bernoulli planes (against the JAX kernel in
interpret mode and the JAX oracle, at (8, 256, 128) and both colours),
the int8 model given the same uniforms, the fused exact (m, e), the plain
multisweep against streamed phase pairs, the runner's routes, and the CLI
against the JAX CLI (statistically: Philox against threefry)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_fortran_mc_simulation_spin_tpu.core import lattice as jlattice
from cuda_fortran_mc_simulation_spin_tpu.models.base import (
    CheckerboardState as JaxState,
)
from cuda_fortran_mc_simulation_spin_tpu.models.ising3d import (
    Ising3D as JaxIsing3D,
)
from cuda_fortran_mc_simulation_spin_tpu.ops import ising2d_multispin as jms2
from cuda_fortran_mc_simulation_spin_tpu.ops import ising3d_multispin as jms3
from cuda_fortran_mc_simulation_spin_tpu.runs.__main__ import main as jax_main
from cuda_fortran_mc_simulation_spin_tpu_torch import interop
from cuda_fortran_mc_simulation_spin_tpu_torch.core import lattice, rng
from cuda_fortran_mc_simulation_spin_tpu_torch.engine import sweep
from cuda_fortran_mc_simulation_spin_tpu_torch.models import Ising3D
from cuda_fortran_mc_simulation_spin_tpu_torch.models.base import (
    CheckerboardState,
)
from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
    ising2d_multispin as msb,
)
from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
    ising3d_multispin as ms3,
)
from cuda_fortran_mc_simulation_spin_tpu_torch.runs.__main__ import main

KBT = 4.51152
NZ, NY, HALF = 8, 256, 128        # the JAX tests' packed shape


def _spins(g, shape):
    return (g.integers(0, 2, size=shape, dtype=np.int8) * 2 - 1).astype(
        np.int8)


def _words(g, shape):
    return g.integers(-2 ** 31, 2 ** 31, size=shape,
                      dtype=np.int64).astype(np.int32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("shape", [(4, 6, 8), (8, 32, 64), (2, 256, 256)])
def test_split_merge_and_packing_match_jax(shape):
    full = _spins(np.random.default_rng(shape[1]), shape)
    ja, jb = jlattice.split_checkerboard3d(jnp.asarray(full))
    a, b = lattice.split_checkerboard3d(_t(full))
    np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(b.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(
        lattice.merge_checkerboard3d(a, b).numpy(), full)
    if shape[1] % 32 == 0:
        state = interop.checkerboard_from_numpy(np.array(ja), np.array(jb))
        wa, wb = interop.packed_from_numpy(
            np.asarray(jms2.pack_color(ja)), np.asarray(jms2.pack_color(jb)))
        assert torch.equal(msb.pack_color(state.a), wa)
        assert torch.equal(msb.pack_color(state.b), wb)
        back = interop.packed_to_numpy(wa, wb)
        np.testing.assert_array_equal(back[0], np.asarray(
            jms2.pack_color(ja)))


@pytest.mark.parametrize("color", [0, 1])
def test_neighbor_sums3d_match_jax(color):
    other = _spins(np.random.default_rng(color), (6, 8, 10))
    np.testing.assert_array_equal(
        lattice.neighbor_sums3d(_t(other).to(torch.int32), color).numpy(),
        np.asarray(jlattice.neighbor_sums3d(jnp.asarray(other, jnp.int32),
                                            color)))


def test_chain_words_match_jax_digits():
    beta = 1 / KBT
    for q, p in zip(ms3.chain_words3d(beta),
                    (np.exp(-4 * beta), np.exp(-8 * beta),
                     np.exp(-12 * beta))):
        assert msb._digits(q) == list(jms2.chain_digits(float(p)))


@pytest.mark.parametrize("color", [0, 1])
def test_phase_with_bits_matches_jax_kernel_and_oracle(color):
    g = np.random.default_rng(21 + color)
    shp = (1, NZ, NY // 32, HALF)
    wa, wb, b4, b8, b12 = (_words(g, shp) for _ in range(5))
    x, o = (wa, wb) if color == 0 else (wb, wa)
    got = ms3.phase3d_packed_with_bits(_t(x), _t(o), _t(b4), _t(b8), _t(b12),
                                       color=color)
    jgot = jms3.phase3d_packed_with_bits(
        *(jnp.asarray(v) for v in (x, o, b4, b8, b12)), color=color,
        interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jgot))
    jref = jms3.packed_phase3d_reference(
        *(jnp.asarray(v[0]) for v in (x, o)), color,
        *(jnp.asarray(v[0]) for v in (b4, b8, b12)))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(jref))


@pytest.mark.parametrize("color", [0, 1])
def test_model_phase_matches_jax_and_packed_decision(color):
    """The int8 phase given the same uniforms equals JAX's, and the packed
    phase given the Bernoulli planes u < p equals it too."""
    g = np.random.default_rng(40 + color)
    shape = (4, 32, 16)
    a, b = _spins(g, shape), _spins(g, shape)
    u = g.random(shape, dtype=np.float32)
    model = Ising3D(nx=32, ny=32, nz=4, kbt=KBT)
    jm = JaxIsing3D(nx=32, ny=32, nz=4, kbt=KBT)
    x, o = (a, b) if color == 0 else (b, a)
    got = model.phase(_t(x), _t(o), color, _t(u))
    want = jm._phase(jnp.asarray(x), jnp.asarray(o), color, jnp.asarray(u))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    p4, p8, p12 = (np.float32(p) for p in
                   (np.exp(-4 / KBT), np.exp(-8 / KBT), np.exp(-12 / KBT)))
    planes = [msb.pack_color(_t(np.where(u < p, 1, -1).astype(np.int8)))
              for p in (p4, p8, p12)]
    packed = ms3.packed_phase3d_reference(
        msb.pack_color(_t(x)), msb.pack_color(_t(o)), color, *planes)
    np.testing.assert_array_equal(msb.unpack_color(packed).numpy(),
                                  got.numpy())


@pytest.mark.parametrize("color", [0, 1])
def test_measuring_phase_obs_equal_exact_sums(color):
    """The plain measuring phase's (m, e) equal Ising3D.magne_sum and
    energy_sum of the state it leaves, in the port and in JAX."""
    g = np.random.default_rng(60 + color)
    shp = (2, NZ, NY // 32, HALF)
    x, o = _t(_words(g, shp)), _t(_words(g, shp))
    seeds = rng.seeds_from_key(rng.base_key(3), color)
    new, obs = ms3.phase3d_packed(x, o, seeds, color=1, beta=1 / KBT,
                                  measuring=True)
    assert torch.equal(new, ms3.phase3d_packed(x, o, seeds, color=1,
                                               beta=1 / KBT))
    model = Ising3D(nx=2 * HALF, ny=NY, nz=NZ, kbt=KBT)
    state = CheckerboardState(msb.unpack_color(o), msb.unpack_color(new))
    exact = torch.stack([model.magne_sum(state), model.energy_sum(state)], -1)
    assert torch.equal(obs, exact)
    jm = JaxIsing3D(nx=2 * HALF, ny=NY, nz=NZ, kbt=KBT)
    js = JaxState(jnp.asarray(state.a[0].numpy()),
                  jnp.asarray(state.b[0].numpy()))
    assert int(obs[0, 0]) == int(jm.magne_sum(js))
    assert int(obs[0, 1]) == int(jm.energy_sum(js))


@pytest.mark.parametrize("sweeps", [1, 3])
def test_plain_multisweep_equals_phase_pairs(sweeps):
    g = np.random.default_rng(sweeps)
    shp = (2, 4, 8, 128)
    wa, wb = _t(_words(g, shp)), _t(_words(g, shp))
    seeds = ms3.sweep_seed_pairs(rng.sample_key(rng.base_key(5), 1), sweeps,
                                 t0=17)
    ma, mb, mobs = ms3.multisweep3d_planes(wa, wb, seeds, beta=1 / KBT)
    pa, pb, obs = wa, wb, []
    for s in range(sweeps):
        pa = ms3.phase3d_packed(pa, pb, seeds[s, 0], color=0, beta=1 / KBT)
        pb, ob = ms3.phase3d_packed(pb, pa, seeds[s, 1], color=1,
                                    beta=1 / KBT, measuring=True)
        obs.append(ob)
    assert mobs.shape == (2, sweeps, 2) and mobs.dtype == torch.int64
    assert torch.equal(ma, pa) and torch.equal(mb, pb)
    assert torch.equal(mobs, torch.stack(obs, dim=1))


def test_multisweep_is_absorbing_at_low_temperature():
    """At kbt = 0.05 every move off the all-up state is rejected (p4 =
    e^-80 quantizes to 0): m = 1 and e = -3 exactly at every sweep."""
    model = Ising3D(nx=256, ny=256, nz=4, kbt=0.05)
    up = torch.full((2, 4, 8, 128), -1, dtype=torch.int32)
    _, _, obs = ms3.multisweep_packed3d(model, up, up,
                                        rng.sample_key(rng.base_key(0), 0), 3)
    assert torch.all(obs["m"] == 1.0) and torch.all(obs["e"] == -3.0)


def test_model_level_entries_agree():
    model = Ising3D(nx=256, ny=256, nz=4, kbt=KBT)
    g = np.random.default_rng(8)
    wa, wb = _t(_words(g, (1, 4, 8, 128))), _t(_words(g, (1, 4, 8, 128)))
    key = rng.sample_key(rng.base_key(42), 2)
    ma, mb, mo = ms3.multisweep_packed3d(model, wa, wb, key, 2, t0=4)
    sa, sb = wa, wb
    for j, t in enumerate((5, 6)):
        sa, sb, o = ms3.sweep_measure_packed3d(model, sa, sb,
                                               rng.sweep_key(key, t))
        assert torch.equal(o["m"], mo["m"][:, j])
        assert torch.equal(o["e"], mo["e"][:, j])
    assert torch.equal(ma, sa) and torch.equal(mb, sb)
    pa, pb = ms3.sweep_packed3d(model, wa, wb, rng.sweep_key(key, 5))
    qa, qb, _ = ms3.sweep_measure_packed3d(model, wa, wb,
                                           rng.sweep_key(key, 5))
    assert torch.equal(pa, qa) and torch.equal(pb, qb)


@pytest.mark.parametrize("init_kind", ["allup", "random"])
def test_runner_routes_are_one_trajectory(init_kind):
    """Resident and streaming routes and any host chunking give the same
    series."""
    model = Ising3D(nx=256, ny=256, nz=2, kbt=KBT)
    key = rng.sample_key(rng.base_key(1), 3)
    outs = [sweep._make_packed_runner(
        model, 5, 2, init_kind, resident, "cpu", chunk,
        multisweep=ms3.multisweep_packed3d,
        sweep_measure=ms3.sweep_measure_seeded3d)(key)
        for resident, chunk in ((True, 5), (True, 2), (False, 3))]
    for o in outs[1:]:
        for k in ("m", "e"):
            assert o[k].shape == (2, 5)
            assert torch.equal(o[k], outs[0][k])


def test_route_rule_and_tags():
    small = Ising3D(nx=256, ny=256, nz=256, kbt=KBT)
    big = Ising3D(nx=512, ny=512, nz=512, kbt=KBT)
    assert ms3.multisweep3d_fits(4, *small.color_shape)
    assert not ms3.multisweep3d_fits(8, *big.color_shape)
    assert sweep.make_multispin3d_runner(small, 1, 4, device="cpu").engine \
        == "ising3d_multispin bit-packed (resident multisweep)"
    assert sweep.make_multispin3d_runner(big, 1, 8, device="cpu").engine \
        == "ising3d_multispin bit-packed (streaming z-plane phases)"
    assert ms3.packable3d(256, 128) == jms3.packable3d(256, 128)
    assert ms3.packable3d(128, 128) == jms3.packable3d(128, 128)


def test_wrappers_take_plain_versions_on_cpu_and_check_arguments():
    ms3.reset_launches()
    w = torch.zeros((1, 2, 8, 128), dtype=torch.int32)
    ms3.phase3d_packed_with_bits(w, w, w, w, w, color=0)
    ms3.phase3d_packed(w, w, (0, 0), color=1, beta=0.2, measuring=True)
    ms3.multisweep3d_planes(w, w, ms3.sweep_seed_pairs(rng.base_key(0), 1),
                            beta=0.2)
    h = torch.zeros((1, 1, 8, 128), dtype=torch.int32)
    ms3.sharded_phase3d_packed(w, w, h, h, (0, 0), (0, 2), color=1,
                               beta=0.2, measuring=True)
    assert ms3.LAUNCHES == {"phase": 0, "phase_measuring": 0,
                            "multisweep": 0, "shard_phase": 0}
    with pytest.raises(ValueError, match="CUDA"):
        ms3._check_volumes(w, w)
    with pytest.raises(ValueError, match="nyp"):
        ms3._check_volumes(torch.zeros((1, 2, 4, 128), dtype=torch.int32))
    with pytest.raises(ValueError, match="device"):
        ms3.phase3d_packed(w.to("meta"), w.to("meta"), (0, 0), color=0,
                           beta=0.2)


def _split_dat(path):
    lines = path.read_text().splitlines()
    head = [s for s in lines if s.startswith("#")]
    rows = np.array([s.split() for s in lines if not s.startswith("#")],
                    dtype=np.float64)
    return head, rows


def test_cli_matches_jax_cli(tmp_path):
    """The port CLI (plain versions) against the JAX CLI at 256x256x4:
    equal headers except `# engine:` (with `nx, ny: 256 256 4`), m(t),
    e(t) within 5 combined standard errors at every t."""
    flags = ["--model", "ising3d", "--nx", "256", "--ny", "256", "--nz",
             "4", "--kbt", "4.51152", "--mcs", "20", "--samples", "16",
             "--replicas", "4"]
    port, jax_out = tmp_path / "port.dat", tmp_path / "jax.dat"
    assert main(flags + ["--device", "cpu", "--output", str(port)]) == 0
    assert jax_main(flags + ["--output", str(jax_out)]) == 0
    head, rows = _split_dat(port)
    jhead, jrows = _split_dat(jax_out)
    assert [h for h in head if not h.startswith("# engine:")] == [
        h for h in jhead if not h.startswith("# engine:")]
    assert "# nx, ny: 256 256 4" in head
    assert "# engine: ising3d_multispin bit-packed (resident multisweep)" \
        in head
    assert rows.shape == jrows.shape == (20, 10)
    np.testing.assert_array_equal(rows[:, :3], jrows[:, :3])
    n, ns = rows[0, 0], rows[0, 1]
    for col, var_col in ((3, 7), (4, 8)):
        se = np.sqrt((rows[:, var_col] + jrows[:, var_col]) / (n * ns))
        z = np.abs(rows[:, col] - jrows[:, col]) / se
        assert np.all(z < 5.0), (col, z)
