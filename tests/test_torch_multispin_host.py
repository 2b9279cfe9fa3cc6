"""Port vs JAX, bitwise on the same numpy inputs: the host side of the
bit-packed engine (ops/ising2d_multispin.py) and the phase with
injected Bernoulli planes, on (ny, nx) in {(256, 256), (512, 256),
(256, 512)} and both colours."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_fortran_mc_simulation_spin_tpu.models.base import (
    CheckerboardState as JaxState,
)
from cuda_fortran_mc_simulation_spin_tpu.models.ising2d import (
    Ising2D as JaxIsing2D,
)
from cuda_fortran_mc_simulation_spin_tpu.ops import ising2d_multispin as jmsb
from cuda_fortran_mc_simulation_spin_tpu_torch.core import rng
from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
    ising2d_multispin as msb,
)

SHAPES = [(256, 256), (512, 256), (256, 512)]
CASES = [(ny, nx, color) for ny, nx in SHAPES for color in (0, 1)]


def _spins(g, shape):
    return (g.integers(0, 2, size=shape, dtype=np.int8) * 2 - 1).astype(
        np.int8)


def _words(g, shape):
    return g.integers(-2 ** 31, 2 ** 31, size=shape,
                      dtype=np.int64).astype(np.int32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("ny,nx", SHAPES)
def test_pack_unpack_match_jax(ny, nx):
    g = np.random.default_rng(ny * 7 + nx)
    for plane in (_spins(g, (2, ny, nx // 2)), _spins(g, (ny, nx // 2))):
        want = np.asarray(jmsb.pack_color(jnp.asarray(plane)))
        got = msb.pack_color(_t(plane))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(msb.unpack_color(got).numpy(),
                                      np.asarray(jmsb.unpack_color(
                                          jnp.asarray(want))))
        np.testing.assert_array_equal(msb.unpack_color(got).numpy(), plane)


@pytest.mark.parametrize("ny,nx", SHAPES)
def test_popcount_sum_matches_jax(ny, nx):
    w = _words(np.random.default_rng(abs(nx - ny) + 3), (3, ny // 32, nx // 2))
    assert int(msb.popcount_sum(_t(w))) == int(jmsb.popcount_sum(
        jnp.asarray(w)))


@pytest.mark.parametrize("kbt", [0.5, 1.5, 2.0, 2.26918531421, 3.0, 50.0])
def test_chain_digits_match_jax(kbt):
    beta = 1.0 / kbt
    for p in (np.exp(-4.0 * beta), np.exp(-8.0 * beta), 0.0, 1.0, 0.5):
        assert msb.chain_digits(float(p)) == jmsb.chain_digits(float(p))
        assert msb.chain_digits(float(p), 12) == jmsb.chain_digits(
            float(p), 12)
    q4, q8 = msb.chain_words(beta)
    assert msb._digits(q4) == jmsb.chain_digits(float(np.exp(-4.0 * beta)))
    assert msb._digits(q8) == jmsb.chain_digits(float(np.exp(-8.0 * beta)))


@pytest.mark.parametrize("kbt", [1.0, 2.26918531421, 4.0])
def test_bern_plane_matches_jax_on_injected_words(kbt):
    """Same random words in, same Bernoulli plane out; chain_draws counts
    the words the kernel's chain consumes."""
    g = np.random.default_rng(int(kbt * 100))
    shape = (16, 128)
    words = [_words(g, shape) for _ in range(2 * msb.CHAIN_BITS)]
    for p in (np.exp(-4.0 / kbt), np.exp(-8.0 / kbt)):
        digits = jmsb.chain_digits(float(p))
        jit = iter(words)
        want = np.asarray(jmsb._bern_plane(
            shape, digits,
            lambda: jnp.asarray(next(jit)).astype(jnp.uint32)))
        used = []

        def gen():
            used.append(1)
            return msb._u32(_t(words[len(used) - 1]))

        got = msb._bern_plane(shape, digits, gen)
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
        q = sum(d << (msb.CHAIN_BITS - 1 - j) for j, d in enumerate(digits))
        assert len(used) == msb.chain_draws(q)


def _phase_inputs(ny, nx, color, nrep=2):
    g = np.random.default_rng(ny + 3 * nx + color)
    shape = (nrep, ny // 32, nx // 2)
    return [_words(g, shape) for _ in range(4)]


@pytest.mark.parametrize("ny,nx,color", CASES)
def test_packed_phase_reference_matches_jax_reference(ny, nx, color):
    x, o, b4, b8 = _phase_inputs(ny, nx, color)
    got = msb.packed_phase_reference(_t(x), _t(o), color, _t(b4), _t(b8))
    for r in range(x.shape[0]):
        want = jmsb.packed_phase_reference(
            jnp.asarray(x[r]), jnp.asarray(o[r]), color,
            jnp.asarray(b4[r]), jnp.asarray(b8[r]))
        np.testing.assert_array_equal(got[r].numpy(), np.asarray(want))


@pytest.mark.parametrize("ny,nx,color", CASES)
def test_phase_with_bits_matches_jax_kernel_interpret(ny, nx, color):
    """The port's injected-bits phase (on the CPU: its plain version) is
    bitwise the JAX Pallas kernel run in interpret mode."""
    x, o, b4, b8 = _phase_inputs(ny, nx, color)
    want = jmsb.phase_packed_with_bits(
        jnp.asarray(x), jnp.asarray(o), jnp.asarray(b4), jnp.asarray(b8),
        color=color, interpret=True)
    got = msb.phase_packed_with_bits(_t(x), _t(o), _t(b4), _t(b8),
                                     color=color)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("ny,nx,color", CASES)
def test_measuring_phase_sums_equal_jax_model_sums(ny, nx, color):
    """The fused (m, e) of the port's measuring phase equals the JAX
    model's exact magne_sum / energy_sum of the unpacked state."""
    x, o = _phase_inputs(ny, nx, color)[:2]
    seeds = rng.seeds_from_key(rng.base_key(ny + nx), color)
    new, obs = msb.phase_packed(_t(x), _t(o), seeds, color=color,
                                beta=1 / 2.26918531421, measuring=True)
    wa, wb = (o, new.numpy()) if color else (new.numpy(), o)
    model = JaxIsing2D(nx=nx, ny=ny, kbt=2.26918531421)
    for r in range(x.shape[0]):
        st = JaxState(jmsb.unpack_color(jnp.asarray(wa[r])),
                      jmsb.unpack_color(jnp.asarray(wb[r])))
        assert int(obs[r, 0]) == int(model.magne_sum(st))
        assert int(obs[r, 1]) == int(model.energy_sum(st))


def test_pack_state_roundtrip_matches_jax():
    g = np.random.default_rng(9)
    a, b = _spins(g, (256, 128)), _spins(g, (256, 128))
    from cuda_fortran_mc_simulation_spin_tpu_torch.models.base import (
        CheckerboardState,
    )
    wa, wb, batched = msb.pack_state(CheckerboardState(_t(a), _t(b)))
    jwa, jwb, jbatched = jmsb.pack_state(JaxState(jnp.asarray(a),
                                                  jnp.asarray(b)))
    assert batched == jbatched is False
    np.testing.assert_array_equal(wa.numpy(), np.asarray(jwa))
    np.testing.assert_array_equal(wb.numpy(), np.asarray(jwb))
    st = msb.unpack_state(wa, wb, batched)
    np.testing.assert_array_equal(st.a.numpy(), a)
    np.testing.assert_array_equal(st.b.numpy(), b)
    assert msb.OBS_INT32_MAX_SITES == jmsb.OBS_INT32_MAX_SITES
    assert msb.packable(256, 128) == jmsb.packable(256, 128)
    assert msb.packable(128, 128) == jmsb.packable(128, 128)


def test_jax_backend_is_cpu():
    assert jax.default_backend() == "cpu"
