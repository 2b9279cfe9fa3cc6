"""Port vs JAX on the same numpy inputs: the int8 periodic Ising kernels'
plain versions (ops/ising2d_pallas.py, ops/ising3d_pallas.py,
ops/ising2d_measure_pallas.py, ops/ising2d_multisweep.py).

Tolerances: none.  Every state and every integer sum is held bitwise:
the phases with injected words against the JAX Pallas kernels in
interpret mode (their ``sharded_phase`` over the whole lattice, the
halos the periodic wrap, as tests/test_shard_pallas.py runs them) and,
at shapes those kernels cannot tile, against JAX's neighbour sums and the
integer-threshold rule; the measure sums against the JAX models' exact
sums; the plain multisweep against plain phase pairs and the plain
measure under the same keys.  States cross through ``interop``, and JAX
gets arrays of its own (never a buffer the port updates in place)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_fortran_mc_simulation_spin_tpu.core import lattice as jlattice
from cuda_fortran_mc_simulation_spin_tpu.core import rng as jrng
from cuda_fortran_mc_simulation_spin_tpu.core import tables as jtables
from cuda_fortran_mc_simulation_spin_tpu.models.base import (
    CheckerboardState as JaxState,
)
from cuda_fortran_mc_simulation_spin_tpu.models.ising2d import (
    Ising2D as JaxIsing2D,
)
from cuda_fortran_mc_simulation_spin_tpu.models.ising3d import (
    Ising3D as JaxIsing3D,
)
from cuda_fortran_mc_simulation_spin_tpu.ops import ising2d_pallas as ji2p
from cuda_fortran_mc_simulation_spin_tpu.ops import ising3d_pallas as ji3p
from cuda_fortran_mc_simulation_spin_tpu_torch import interop
from cuda_fortran_mc_simulation_spin_tpu_torch.core import rng, tables
from cuda_fortran_mc_simulation_spin_tpu_torch.models import Ising2D, Ising3D
from cuda_fortran_mc_simulation_spin_tpu_torch.models.base import (
    CheckerboardState,
)
from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
    ising2d_measure_pallas as i8m,
)
from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
    ising2d_multisweep as i8ms,
)
from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
    ising2d_pallas as i2p,
)
from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
    ising3d_pallas as i3p,
)
from cuda_fortran_mc_simulation_spin_tpu_torch.ops import multispin_rng

KBT = 2.26918531421
KBT_3D = 4.51152
BETAS = (1 / KBT, 1 / KBT_3D, 1e-12, 1e3)   # Tc, 3-D Tc, beta -> 0, -> inf


def _spins(g, shape):
    return (g.integers(0, 2, size=shape, dtype=np.int8) * 2 - 1).astype(
        np.int8)


def _bits(g, shape):
    """uint32 words (numpy) for JAX and the same words as int32 for the
    port."""
    u = g.integers(0, 2 ** 32, size=shape, dtype=np.uint64).astype(np.uint32)
    return u, torch.from_numpy(u.view(np.int32).copy())


@pytest.mark.parametrize("beta", BETAS)
def test_thresholds_equal_jax(beta):
    assert i2p.accept_thresholds_u32(beta) == ji2p.accept_thresholds_u32(
        beta)
    assert tables.ising3d_accept_thresholds_u32(beta) == \
        jtables.ising3d_accept_thresholds_u32(beta)


def test_words_layout():
    """Site (r, row, c) takes output c & 3 of the Philox counter
    (r, row, c >> 2, 0): one call feeds four adjacent sites, and a ragged
    last unit (half = 7) leaves its spare output unused."""
    key = rng.seeds_from_key(rng.sweep_key(rng.base_key(5), 3), 1)
    w = i2p.draw_words(key, 2, 3, 7)
    assert w.shape == (2, 3, 7) and w.dtype == torch.int64
    for r, row, c in ((0, 0, 0), (1, 2, 6), (0, 1, 5), (1, 0, 3)):
        ctr = torch.tensor([r, row, c >> 2, 0], dtype=torch.int64)
        assert int(w[r, row, c]) == int(rng.philox4x32(ctr, key)[c & 3])
    # the 3-D words are the 2-D ones over nz * ny rows
    x = torch.ones((2, 3, 4, 7), dtype=torch.int8)
    bits = i2p.draw_words(key, 2, 12, 7).reshape(2, 3, 4, 7)
    got = i3p.phase_plain(x, -x, key, color=0, beta=0.3)
    want = i3p.phase_plain(x, -x, color=0, beta=0.3,
                           bits=(bits & 0xFFFFFFFF).to(torch.int32))
    assert torch.equal(got, want)


@pytest.mark.parametrize("color", [0, 1])
def test_2d_phase_matches_jax_pallas_kernel(color):
    """The plain int8 phase, given injected words, equals the JAX Pallas
    kernel in interpret mode bitwise (R = 2, 64x256)."""
    g = np.random.default_rng(10 + color)
    shape = (2, 64, 128)
    a, b = _spins(g, shape), _spins(g, shape)
    ubits, tbits = _bits(g, shape)
    beta = 1 / KBT
    x, o = (a, b) if color == 0 else (b, a)
    jx, jo = jnp.asarray(x.copy()), jnp.asarray(o.copy())
    want = ji2p.sharded_phase(
        jx, jo, jo[:, -1:], jo[:, :1], ji2p.seeds_from_key(jrng.base_key(2),
                                                           0),
        jnp.array([0, 0], jnp.int32), color=color, beta=beta,
        bits=jnp.asarray(ubits), interpret=True)
    st = interop.checkerboard_from_numpy(x, o)
    got = i2p.phase_plain(st.a, st.b, color=color, beta=beta, bits=tbits)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _jax_phase(x, o, color, ubits, thresholds, dims):
    """JAX's neighbour sums with the integer-threshold rule of the TPU
    kernels (tests/test_shard_pallas.py:26-34), at any shape."""
    nbr = jlattice.neighbor_sums if dims == 2 else jlattice.neighbor_sums3d
    nsum = jax.vmap(lambda o1: nbr(o1, color))(jnp.asarray(o))
    xi = jnp.asarray(x).astype(jnp.int32)
    k = xi * nsum.astype(jnp.int32)
    t = thresholds
    thresh = jnp.where(k == 2, jnp.uint32(t[0]),
                       jnp.where(k == 4, jnp.uint32(t[1]),
                                 jnp.uint32(t[-1])))
    accept = (k <= 0) | (jnp.asarray(ubits) < thresh)
    return np.asarray(jnp.where(accept, -xi, xi).astype(jnp.int8))


@pytest.mark.parametrize("color", [0, 1])
@pytest.mark.parametrize("shape", [(3, 10, 3), (3, 130, 63), (1, 2, 1)])
def test_2d_phase_at_untiled_shapes_matches_jax_rule(color, shape):
    """Shapes the JAX kernel cannot tile (10x6, 130x126 with a ragged last
    unit, 2x2): bitwise equal to JAX's stencil and integer rule."""
    g = np.random.default_rng(sum(shape) + color)
    x, o = _spins(g, shape), _spins(g, shape)
    ubits, tbits = _bits(g, shape)
    beta = 1 / KBT
    want = _jax_phase(x, o, color, ubits, ji2p.accept_thresholds_u32(beta),
                      2)
    st = interop.checkerboard_from_numpy(x, o)
    got = i2p.phase_plain(st.a, st.b, color=color, beta=beta, bits=tbits)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("color", [0, 1])
def test_3d_phase_matches_jax_pallas_kernel(color):
    """The plain int8 3-D phase equals the JAX 3-D Pallas kernel in
    interpret mode bitwise (R = 2, 4x8x256)."""
    g = np.random.default_rng(20 + color)
    shape = (2, 4, 8, 128)
    a, b = _spins(g, shape), _spins(g, shape)
    ubits, tbits = _bits(g, shape)
    beta = 1 / KBT_3D
    x, o = (a, b) if color == 0 else (b, a)
    jx, jo = jnp.asarray(x.copy()), jnp.asarray(o.copy())
    want = ji3p.sharded_phase(
        jx, jo, jo[:, -1:], jo[:, :1], ji2p.seeds_from_key(jrng.base_key(41),
                                                           0),
        jnp.array([0, 0], jnp.int32), color=color, beta=beta,
        bits=jnp.asarray(ubits), interpret=True)
    st = interop.checkerboard_from_numpy(x, o)
    got = i3p.phase_plain(st.a, st.b, color=color, beta=beta, bits=tbits)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("color", [0, 1])
def test_3d_phase_at_untiled_shape_matches_jax_rule(color):
    """10x12x14 x 2 (half = 5, a ragged unit): bitwise equal to JAX's 3-D
    stencil and the three-threshold rule."""
    g = np.random.default_rng(30 + color)
    shape = (2, 14, 12, 5)
    x, o = _spins(g, shape), _spins(g, shape)
    ubits, tbits = _bits(g, shape)
    beta = 1 / KBT_3D
    want = _jax_phase(x, o, color, ubits,
                      jtables.ising3d_accept_thresholds_u32(beta), 3)
    st = interop.checkerboard_from_numpy(x, o)
    got = i3p.phase_plain(st.a, st.b, color=color, beta=beta, bits=tbits)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dims,shape", [
    (2, (3, 130, 63)), (2, (2, 64, 128)), (3, (2, 14, 12, 5)),
    (3, (2, 4, 8, 128))])
def test_measure_equals_jax_exact_sums(dims, shape):
    """The plain measure's (m, e) equal the JAX models' magne_sum and
    energy_sum of each replica, exactly."""
    g = np.random.default_rng(sum(shape))
    a, b = _spins(g, shape), _spins(g, shape)
    if dims == 2:
        jmodel = JaxIsing2D(nx=2 * shape[-1], ny=shape[1], kbt=KBT,
                            backend="jnp")
    else:
        jmodel = JaxIsing3D(nx=2 * shape[-1], ny=shape[2], nz=shape[1],
                            kbt=KBT_3D, backend="jnp")
    want = [(int(jmodel.magne_sum(JaxState(jnp.asarray(a[r]),
                                           jnp.asarray(b[r])))),
             int(jmodel.energy_sum(JaxState(jnp.asarray(a[r]),
                                            jnp.asarray(b[r])))))
            for r in range(shape[0])]
    st = interop.checkerboard_from_numpy(a, b)
    got = i8m.measure_sums(*st)
    assert got.dtype == torch.int64
    assert got.tolist() == [list(w) for w in want]
    model = (Ising2D(nx=2 * shape[-1], ny=shape[1], kbt=KBT) if dims == 2
             else Ising3D(nx=2 * shape[-1], ny=shape[2], nz=shape[1],
                          kbt=KBT_3D))
    obs = i8m.measure(model, st)
    assert torch.equal(obs["m"], got[:, 0].double() / model.nsites)
    assert torch.equal(obs["e"], got[:, 1].double() / model.nsites)


def test_multisweep_plain_equals_phase_pairs_and_jax_observables():
    """S plain multisweep sweeps equal S plain phase pairs under the same
    per-sweep keys, state bitwise; the fused (m, e) of each sweep equal
    the plain measure of that state and the JAX model's exact sums."""
    g = np.random.default_rng(7)
    shape = (3, 10, 7)
    a0, b0 = _spins(g, shape), _spins(g, shape)
    beta = 1 / KBT
    seeds = multispin_rng.sweep_phase_keys(rng.sample_key(rng.base_key(3),
                                                          1), 6, 4)
    st = interop.checkerboard_from_numpy(a0, b0)
    ka, kb, kobs = i8ms.multisweep_plain(st.a, st.b, seeds, beta=beta)
    assert kobs.shape == (3, 6, 2) and kobs.dtype == torch.int64
    pa, pb = st.a.clone(), st.b.clone()
    jmodel = JaxIsing2D(nx=14, ny=10, kbt=KBT, backend="jnp")
    for s in range(6):
        pa = i2p.phase_plain(pa, pb, seeds[s, 0], color=0, beta=beta)
        pb = i2p.phase_plain(pb, pa, seeds[s, 1], color=1, beta=beta)
        assert torch.equal(kobs[:, s], i8m.measure_sums_plain(pa, pb))
        na, nb = interop.checkerboard_to_numpy(CheckerboardState(pa, pb))
        for r in range(3):
            js = JaxState(jnp.asarray(na[r]), jnp.asarray(nb[r]))
            assert kobs[r, s].tolist() == [int(jmodel.magne_sum(js)),
                                           int(jmodel.energy_sum(js))]
    assert torch.equal(ka, pa) and torch.equal(kb, pb)


def test_wrappers_take_plain_versions_on_cpu_in_place():
    """On CPU tensors each wrapper runs its plain version, updates the
    given planes in place and launches nothing."""
    for mod in (i2p, i3p, i8m, i8ms):
        mod.reset_launches()
    g = np.random.default_rng(9)
    seeds = multispin_rng.sweep_phase_keys(rng.sample_key(rng.base_key(1),
                                                          0), 3)
    st = interop.checkerboard_from_numpy(*(_spins(g, (2, 6, 5))
                                           for _ in range(2)))
    want = i2p.phase_plain(st.a, st.b, seeds[0, 0], color=0, beta=0.4)
    a = st.a
    assert i2p.metropolis_phase(st.a, st.b, seeds[0, 0], color=0,
                                beta=0.4) is a
    assert torch.equal(a, want)
    wa, wb, wobs = i8ms.multisweep_plain(st.a, st.b, seeds, beta=0.4)
    ka, kb, kobs = i8ms.multisweep_planes(st.a, st.b, seeds, beta=0.4)
    assert ka is st.a and torch.equal(ka, wa) and torch.equal(kb, wb)
    assert torch.equal(kobs, wobs)
    v = interop.checkerboard_from_numpy(*(_spins(g, (2, 4, 6, 3))
                                          for _ in range(2)))
    want = i3p.phase_plain(v.b, v.a, seeds[1, 1], color=1, beta=0.2)
    i3p.metropolis_phase(v.b, v.a, seeds[1, 1], color=1, beta=0.2)
    assert torch.equal(v.b, want)
    assert torch.equal(i8m.measure_sums(*v), i8m.measure_sums_plain(*v))
    for mod in (i2p, i3p, i8m, i8ms):
        assert not any(mod.LAUNCHES.values())


def test_model_sweeps_dispatch_to_the_int8_ops_in_place():
    """``sweep`` on (ny, half) arrays and on a replica batch runs the int8
    phase under the sweep's two phase keys, in place, bitwise."""
    key = rng.sweep_key(rng.sample_key(rng.base_key(4), 0), 1)
    seeds = i2p.phase_seeds(key)
    for model, shape, mod in (
            (Ising2D(nx=12, ny=6, kbt=KBT), (6, 6), i2p),
            (Ising3D(nx=6, ny=4, nz=4, kbt=KBT_3D), (4, 4, 3), i3p)):
        g = np.random.default_rng(len(shape))
        a, b = _spins(g, (2,) + shape), _spins(g, (2,) + shape)
        st = interop.checkerboard_from_numpy(a, b)
        wa = mod.phase_plain(st.a, st.b, seeds[0], color=0,
                             beta=model.beta)
        wb = mod.phase_plain(st.b, wa, seeds[1], color=1, beta=model.beta)
        one = interop.checkerboard_from_numpy(a[0], b[0])
        model.sweep(one, key)
        assert torch.equal(one.a, wa[0]) and torch.equal(one.b, wb[0])
        model.sweep(st, key)
        assert torch.equal(st.a, wa) and torch.equal(st.b, wb)


def test_launch_bounds_refused():
    """A launch whose unit index could pass 2^31, or with more replicas
    than the grid's y extent, is refused before it reaches the card."""
    i2p.check_launch(16, 1000, 500)
    with pytest.raises(ValueError, match="2\\^31"):
        i2p.check_launch(1, 2 ** 20, 2 ** 13 + 1)
    with pytest.raises(ValueError, match="replicas"):
        i2p.check_launch(65536, 2, 1)
    assert i2p.units(63) == 16 and i2p.units(500) == 125
