"""Port vs JAX on the same numpy inputs: the helical 2-D Ising slice.

The flat even/odd packing and the modular bit shift (bitwise on the
valid bits), the packed phase with injected Bernoulli planes (against
the JAX kernel in interpret mode and the flat oracle), the int8 model,
the plain multisweep's fused (m, e) against the exact sums, the runner,
and the CLI against the JAX CLI (statistically: Philox against
threefry).  Shapes: 129x64 (M = 4128 = 129 words exactly, the JAX
tests' shape) and 131x62 (M = 4061, a partial last word of 29 bits)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_fortran_mc_simulation_spin_tpu.core import lattice as jlattice
from cuda_fortran_mc_simulation_spin_tpu.models.ising2d_helical import (
    Ising2DHelical as JaxHelical,
)
from cuda_fortran_mc_simulation_spin_tpu.ops import helical_multispin as jhms
from cuda_fortran_mc_simulation_spin_tpu.runs.__main__ import main as jax_main
from cuda_fortran_mc_simulation_spin_tpu_torch import interop
from cuda_fortran_mc_simulation_spin_tpu_torch.core import lattice, rng
from cuda_fortran_mc_simulation_spin_tpu_torch.engine import sweep
from cuda_fortran_mc_simulation_spin_tpu_torch.models import Ising2DHelical
from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
    helical_multispin as hms,
)
from cuda_fortran_mc_simulation_spin_tpu_torch.runs.__main__ import main

KBT = 2.26918531421
SHAPES = [(129, 64), (131, 62)]
D_LIST = [0, 1, -1, 31, 32, 33, -64, 500, -501, 2047, -2048, 4127]


def _spins(g, shape):
    return (g.integers(0, 2, size=shape, dtype=np.int8) * 2 - 1).astype(
        np.int8)


def _words(g, shape):
    return g.integers(-2 ** 31, 2 ** 31, size=shape,
                      dtype=np.int64).astype(np.int32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("nx,ny", SHAPES)
def test_pack_flat_matches_jax(nx, ny):
    m = nx * ny // 2
    flat = _spins(np.random.default_rng(nx), (3, m))
    want = np.asarray(jhms.pack_flat(jnp.asarray(flat), m))
    got = hms.pack_flat(_t(flat), m)
    assert got.dtype == torch.int32 and got.shape == (3, hms.words(m))
    np.testing.assert_array_equal(interop.helical_to_numpy(got, m), want)
    np.testing.assert_array_equal(interop.helical_from_numpy(want, m).numpy(),
                                  got.numpy())
    np.testing.assert_array_equal(hms.unpack_flat(got, m).numpy(), flat)
    np.testing.assert_array_equal(
        hms.unpack_flat(got, m).numpy(),
        np.asarray(jhms.unpack_flat(jnp.asarray(want), m)))


@pytest.mark.parametrize("nx,ny", SHAPES)
@pytest.mark.parametrize("d", D_LIST)
def test_shift_mod_matches_roll_and_jax(nx, ny, d):
    """out(j) = in((j + d) mod M) on every valid bit, as np.roll and the
    JAX capacity-domain shift give it."""
    m = nx * ny // 2
    flat = _spins(np.random.default_rng(abs(d) + nx), (2, m))
    w = hms.pack_flat(_t(flat), m)
    got = hms.unpack_flat(hms.shift_mod(w, d, m), m).numpy()
    np.testing.assert_array_equal(got, np.roll(flat, -d, axis=-1))
    jw = jnp.asarray(interop.helical_to_numpy(w, m))
    jgot = np.stack([np.asarray(jhms.unpack_flat(
        jhms._shift_mod_impl(jw[r], d, m, jhms._jnp_roll).astype(jnp.int32),
        m)) for r in range(2)])
    np.testing.assert_array_equal(got, jgot)


def test_shift_mod_below_one_word():
    """M < 32: the 32 bits of a word wrap around the vector more than
    once."""
    m = 13
    flat = _spins(np.random.default_rng(5), (m,))
    w = hms.pack_flat(_t(flat), m)
    for d in (0, 1, 5, -3, 12):
        got = hms.unpack_flat(hms.shift_mod(w, d, m), m).numpy()
        np.testing.assert_array_equal(got, np.roll(flat, -d))


def test_helical_offsets_and_fits_match_jax():
    for nx in (129, 131, 1001):
        assert hms.helical_offsets(nx) == jhms.helical_offsets(nx)
    for nx, ny in [(129, 64), (131, 62), (1001, 1000), (2001, 2000),
                   (4097, 2048), (4095, 2048), (3, 2)]:
        ours = hms.fits(Ising2DHelical(nx, ny, KBT))
        assert ours == jhms.fits(JaxHelical(nx, ny, KBT)), (nx, ny)


@pytest.mark.parametrize("nx,ny", SHAPES)
@pytest.mark.parametrize("color", [0, 1])
def test_phase_with_bits_matches_jax_kernel_and_flat_oracle(nx, ny, color):
    """The port's injected-bits phase (its plain version on the CPU)
    against the JAX Pallas kernel in interpret mode, on the valid bits,
    and against the flat ±1 oracle of both packages."""
    m = nx * ny // 2
    g = np.random.default_rng(nx * 10 + color)
    a, b = _spins(g, (2, m)), _spins(g, (2, m))
    b4u = g.random((2, m)) < 0.3
    b8u = g.random((2, m)) < 0.05
    x, o = (a, b) if color == 0 else (b, a)
    offs = hms.helical_offsets(nx)[color]
    xw, ow = hms.pack_flat(_t(x), m), hms.pack_flat(_t(o), m)
    b4 = hms.pack_flat(_t(b4u.astype(np.int8) * 2 - 1), m)
    b8 = hms.pack_flat(_t(b8u.astype(np.int8) * 2 - 1), m)
    got = hms.phase_packed_with_bits(xw, ow, b4, b8, offs=offs, m=m)
    jgot = jhms.phase_packed_with_bits(
        *(jnp.asarray(interop.helical_to_numpy(v, m))
          for v in (xw, ow, b4, b8)), offs=offs, m=m, interpret=True)
    np.testing.assert_array_equal(
        hms.unpack_flat(got, m).numpy(),
        np.asarray(jhms.unpack_flat(jgot, m)))
    want = hms.flat_phase_reference(_t(x), _t(o), offs, _t(b4u), _t(b8u))
    np.testing.assert_array_equal(hms.unpack_flat(got, m).numpy(),
                                  want.numpy())
    jwant = jhms.flat_phase_reference(jnp.asarray(x[0]), jnp.asarray(o[0]),
                                      offs, jnp.asarray(b4u[0]),
                                      jnp.asarray(b8u[0]))
    np.testing.assert_array_equal(want[0].numpy(), np.asarray(jwant))


@pytest.mark.parametrize("nx,ny", SHAPES)
def test_lattice_helical_stencil_matches_jax(nx, ny):
    flat = _spins(np.random.default_rng(ny), (nx * ny,))
    np.testing.assert_array_equal(
        lattice.helical_neighbor_sums(_t(flat).to(torch.int32), nx).numpy(),
        np.asarray(jlattice.helical_neighbor_sums(
            jnp.asarray(flat, jnp.int32), nx)))
    for off in (0, 1):
        np.testing.assert_array_equal(
            lattice.helical_parity_mask(nx * ny, off).numpy(),
            np.asarray(jlattice.helical_parity_mask(nx * ny, off)))


@pytest.mark.parametrize("nx,ny", SHAPES)
def test_model_sweep_and_observables_match_jax(nx, ny):
    """One MCS with the same injected uniforms (one batch for both
    phases, as the reference draws it), then the exact sums."""
    g = np.random.default_rng(nx + ny)
    flat = _spins(g, (nx * ny,))
    u = g.random(nx * ny, dtype=np.float32)
    model = Ising2DHelical(nx, ny, KBT)
    jm = JaxHelical(nx, ny, KBT)
    got = model.sweep_with_uniforms(_t(flat), _t(u))
    want = jm._phase(jm._phase(jnp.asarray(flat), 0, jnp.asarray(u)), 1,
                     jnp.asarray(u))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(model.magne_sum(got)) == int(jm.magne_sum(want))
    assert int(model.energy_sum(got)) == int(jm.energy_sum(want))
    assert model.sweep(_t(flat), rng.sweep_key(rng.base_key(1), 1)).shape \
        == (nx * ny,)
    with pytest.raises(ValueError, match="odd nx"):
        Ising2DHelical(130, 64, KBT)


def _exact(model, wa, wb):
    m = model.nsites // 2
    flat = hms.merge_flat(hms.unpack_flat(wa, m), hms.unpack_flat(wb, m))
    return torch.stack([model.magne_sum(flat), model.energy_sum(flat)], -1)


@pytest.mark.parametrize("nx,ny", SHAPES)
def test_plain_multisweep_obs_equal_exact_sums(nx, ny):
    """Each sweep's fused (m, e), pad bits masked, equal the model's exact
    sums of the unpacked state; S sweeps in one call equal S calls of one
    sweep, in state and observables."""
    model = Ising2DHelical(nx, ny, KBT)
    m = model.nsites // 2
    g = np.random.default_rng(nx)
    wa = hms.pack_flat(_t(_spins(g, (2, m))), m)
    wb = hms.pack_flat(_t(_spins(g, (2, m))), m)
    seeds = hms.sweep_seed_pairs(rng.sample_key(rng.base_key(4), 1), 3)
    ma, mb, mobs = hms.multisweep_planes(wa, wb, seeds, beta=model.beta,
                                         nx=nx, m=m)
    assert mobs.shape == (2, 3, 2) and mobs.dtype == torch.int64
    pa, pb = wa, wb
    for s in range(3):
        pa, pb, o = hms.multisweep_planes(pa, pb, seeds[s:s + 1],
                                          beta=model.beta, nx=nx, m=m)
        np.testing.assert_array_equal(o[:, 0].numpy(), mobs[:, s].numpy())
        np.testing.assert_array_equal(o[:, 0].numpy(),
                                      _exact(model, pa, pb).numpy())
    vm = hms.valid_mask(m)
    assert torch.equal(hms._u32(ma) & vm, hms._u32(pa) & vm)
    assert torch.equal(hms._u32(mb) & vm, hms._u32(pb) & vm)


def test_pad_bits_do_not_reach_valid_sites_or_obs():
    """Garbage in the pad bits of the inputs changes no valid bit and no
    observable."""
    nx, ny = 131, 62
    model = Ising2DHelical(nx, ny, KBT)
    m = model.nsites // 2
    g = np.random.default_rng(9)
    wa = hms.pack_flat(_t(_spins(g, (1, m))), m)
    wb = hms.pack_flat(_t(_spins(g, (1, m))), m)
    pad = hms._i32(~hms.valid_mask(m) & hms.MASK32)
    seeds = hms.sweep_seed_pairs(rng.sample_key(rng.base_key(2), 0), 2)
    clean = hms.multisweep_planes(wa, wb, seeds, beta=model.beta, nx=nx, m=m)
    dirty = hms.multisweep_planes(wa | pad, wb | pad, seeds,
                                  beta=model.beta, nx=nx, m=m)
    for c, d in zip(clean[:2], dirty[:2]):
        assert torch.equal(hms.unpack_flat(c, m), hms.unpack_flat(d, m))
    assert torch.equal(clean[2], dirty[2])


@pytest.mark.parametrize("init_kind", ["allup", "random"])
def test_runner_is_independent_of_host_chunking(init_kind):
    model = Ising2DHelical(131, 62, KBT)
    key = rng.sample_key(rng.base_key(42), 0)
    outs = [sweep._make_packed_runner(
        model, 11, 2, init_kind, True, "cpu", c,
        multisweep=hms.multisweep,
        init_planes=sweep._init_helical_planes)(key) for c in (11, 4)]
    outs.append(sweep.make_helical_runner(model, 11, 2, init_kind,
                                          device="cpu")(key))
    for k in ("m", "e"):
        assert outs[0][k].shape == (2, 11)
        assert torch.equal(outs[0][k], outs[1][k])
        assert torch.equal(outs[0][k], outs[2][k])
    assert sweep.make_helical_runner(model, 1, 1, device="cpu").engine == \
        "helical_multispin (flat even/odd bit-packed)"


def test_wrappers_take_plain_versions_on_cpu_and_check_arguments():
    hms.reset_launches()
    m = 131 * 62 // 2
    w = hms.pack_flat(torch.ones((1, m), dtype=torch.int8), m)
    hms.phase_packed_with_bits(w, w, w, w, offs=(0, 1, 66, -65), m=m)
    hms.multisweep_planes(w, w, hms.sweep_seed_pairs(rng.base_key(0), 1),
                          beta=1 / KBT, nx=131, m=m)
    assert hms.LAUNCHES == {"multisweep": 0}
    with pytest.raises(ValueError, match="CUDA"):
        hms._check_vectors(m, w, w)
    with pytest.raises(ValueError, match="W ="):
        hms._check_vectors(m + 64, w)
    with pytest.raises(ValueError, match="device"):
        hms.multisweep_planes(w.to("meta"), w.to("meta"),
                              hms.sweep_seed_pairs(rng.base_key(0), 1),
                              beta=0.4, nx=131, m=m)


def _split_dat(path):
    lines = path.read_text().splitlines()
    head = [s for s in lines if s.startswith("#")]
    rows = np.array([s.split() for s in lines if not s.startswith("#")],
                    dtype=np.float64)
    return head, rows


def test_cli_matches_jax_cli(tmp_path):
    """The port CLI (plain versions) against the JAX CLI at 131x62: equal
    headers except `# engine:`, m(t), e(t) within 5 combined standard
    errors at every t (different random streams, so not bitwise)."""
    flags = ["--model", "ising2d", "--nx", "131", "--ny", "62", "--mcs",
             "20", "--samples", "16", "--replicas", "4"]
    port, jax_out = tmp_path / "port.dat", tmp_path / "jax.dat"
    assert main(flags + ["--device", "cpu", "--output", str(port)]) == 0
    assert jax_main(flags + ["--output", str(jax_out)]) == 0
    head, rows = _split_dat(port)
    jhead, jrows = _split_dat(jax_out)
    assert [h for h in head if not h.startswith("# engine:")] == [
        h for h in jhead if not h.startswith("# engine:")]
    assert "# engine: helical_multispin (flat even/odd bit-packed)" in head
    assert "# nx, ny: 131 62" in head
    assert rows.shape == jrows.shape == (20, 10)
    np.testing.assert_array_equal(rows[:, :3], jrows[:, :3])
    n, ns = rows[0, 0], rows[0, 1]
    for col, var_col in ((3, 7), (4, 8)):
        se = np.sqrt((rows[:, var_col] + jrows[:, var_col]) / (n * ns))
        z = np.abs(rows[:, col] - jrows[:, col]) / se
        assert np.all(z < 5.0), (col, z)
