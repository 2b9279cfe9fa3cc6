"""Port vs JAX on the same numpy inputs: the dual-colour lattice algebra
(core/lattice.py), the int8 two-threshold Ising2D phase given the same
uniforms, the exact observables, and packed vs canonical decisions."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_fortran_mc_simulation_spin_tpu.core import lattice as jlattice
from cuda_fortran_mc_simulation_spin_tpu.models.base import (
    CheckerboardState as JaxState,
)
from cuda_fortran_mc_simulation_spin_tpu.models.ising2d import (
    Ising2D as JaxIsing2D,
)
from cuda_fortran_mc_simulation_spin_tpu_torch.core import lattice, rng
from cuda_fortran_mc_simulation_spin_tpu_torch.models import Ising2D
from cuda_fortran_mc_simulation_spin_tpu_torch.models.base import (
    CheckerboardState,
)
from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
    ising2d_multispin as msb,
)

KBT = 2.26918531421
SHAPES = [(16, 32), (64, 128), (256, 256)]


def _spins(g, shape):
    return (g.integers(0, 2, size=shape, dtype=np.int8) * 2 - 1).astype(
        np.int8)


@pytest.mark.parametrize("ny,nx", SHAPES)
def test_split_merge_match_jax(ny, nx):
    full = _spins(np.random.default_rng(ny), (ny, nx))
    ja, jb = jlattice.split_checkerboard(jnp.asarray(full))
    a, b = lattice.split_checkerboard(torch.from_numpy(full))
    np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(b.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(lattice.merge_checkerboard(a, b).numpy(),
                                  full)


@pytest.mark.parametrize("ny,nx", SHAPES)
@pytest.mark.parametrize("color", [0, 1])
def test_neighbor_sums_match_jax(ny, nx, color):
    other = _spins(np.random.default_rng(nx + color), (ny, nx // 2))
    want = jlattice.neighbor_sums(jnp.asarray(other), color,
                                  accum_dtype=jnp.int32)
    got = lattice.neighbor_sums(torch.from_numpy(other).to(torch.int32),
                                color)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("ny,nx", SHAPES)
def test_observables_match_jax(ny, nx):
    g = np.random.default_rng(ny * nx)
    a, b = _spins(g, (ny, nx // 2)), _spins(g, (ny, nx // 2))
    jm = JaxIsing2D(nx=nx, ny=ny, kbt=KBT)
    m = Ising2D(nx=nx, ny=ny, kbt=KBT)
    js = JaxState(jnp.asarray(a), jnp.asarray(b))
    st = CheckerboardState(torch.from_numpy(a), torch.from_numpy(b))
    assert int(m.magne_sum(st)) == int(jm.magne_sum(js))
    assert int(m.energy_sum(st)) == int(jm.energy_sum(js))
    full = np.asarray(lattice.merge_checkerboard(st.a, st.b), np.int64)
    assert int(m.energy_sum(st)) == JaxIsing2D.energy_sum_numpy(full)
    obs = m.observables(st)
    assert float(obs["m"]) == int(jm.magne_sum(js)) / (nx * ny)
    # a replica batch reduces per replica
    batch = CheckerboardState(torch.stack([st.a, st.b]),
                              torch.stack([st.b, st.a]))
    assert m.magne_sum(batch).shape == (2,)


@pytest.mark.parametrize("color", [0, 1])
@pytest.mark.parametrize("kbt", [KBT, 1.5])
def test_int8_phase_matches_jax_given_uniforms(color, kbt):
    """Ising2D.phase (the physics oracle) is bitwise the JAX model's
    phase for the same spins and uniforms."""
    g = np.random.default_rng(int(kbt * 10) + color)
    ny, nx = 64, 128
    x, o = _spins(g, (ny, nx // 2)), _spins(g, (ny, nx // 2))
    u = g.random((ny, nx // 2), dtype=np.float32)
    want = JaxIsing2D(nx=nx, ny=ny, kbt=kbt, backend="jnp")._phase(
        jnp.asarray(x), jnp.asarray(o), color, jnp.asarray(u))
    got = Ising2D(nx=nx, ny=ny, kbt=kbt).phase(
        torch.from_numpy(x), torch.from_numpy(o), color, torch.from_numpy(u))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_accept_table_matches_jax():
    assert Ising2D(8, 8, KBT).accept_table == JaxIsing2D(
        8, 8, KBT).accept_table


@pytest.mark.parametrize("color", [0, 1])
def test_packed_decision_equals_canonical_stencil(color):
    """The packed phase flips exactly the sites that the canonical
    int8 rule flips, given the same Bernoulli planes."""
    g = np.random.default_rng(40 + color)
    ny, half = 512, 128
    a, b = _spins(g, (ny, half)), _spins(g, (ny, half))
    b4u = g.random((ny, half)) < 0.3
    b8u = g.random((ny, half)) < 0.05
    x, o = (a, b) if color == 0 else (b, a)
    nsum = lattice.neighbor_sums(torch.from_numpy(o).to(torch.int32), color)
    half_de = torch.from_numpy(x).to(torch.int32) * nsum
    accept = (half_de <= 0) | torch.where(half_de == 2,
                                          torch.from_numpy(b4u),
                                          torch.from_numpy(b8u))
    want = torch.where(accept, -torch.from_numpy(x), torch.from_numpy(x))
    as_plane = (lambda m: msb.pack_color(
        torch.from_numpy(m.astype(np.int8) * 2 - 1)))
    got = msb.packed_phase_reference(
        msb.pack_color(torch.from_numpy(x)),
        msb.pack_color(torch.from_numpy(o)), color,
        as_plane(b4u), as_plane(b8u))
    np.testing.assert_array_equal(msb.unpack_color(got).numpy(),
                                  want.numpy())


def test_init_states():
    m = Ising2D(nx=64, ny=32, kbt=KBT)
    up = m.init_state("allup", batch=(3,))
    assert up.a.shape == (3, 32, 32) and up.a.dtype == torch.int8
    assert int(m.magne_sum(up).sum()) == 3 * 64 * 32
    k = rng.init_key(rng.sample_key(rng.base_key(42), 0))
    r1, r2 = m.init_state("random", k), m.init_state("random", k)
    assert torch.equal(r1.a, r2.a) and torch.equal(r1.b, r2.b)
    assert set(torch.unique(r1.a).tolist()) == {-1, 1}
    assert abs(float(m.observables(r1)["m"])) < 0.1
    with pytest.raises(ValueError):
        m.init_state("finite_magne", k)
    with pytest.raises(ValueError):
        Ising2D(nx=63, ny=32, kbt=KBT)


def test_int8_sweep_relaxes_from_allup():
    """One int8 sweep from all-up at Tc leaves m near its exact
    first-sweep value (0.92097, one sweep of the two-colour rule)."""
    m = Ising2D(nx=256, ny=256, kbt=KBT)
    st = m.sweep(m.init_state("allup"), rng.sweep_key(rng.base_key(0), 1))
    mag = float(m.observables(st)["m"])
    sigma = (0.2718 / m.nsites) ** 0.5
    assert abs(mag - 0.9209737) < 5 * sigma
