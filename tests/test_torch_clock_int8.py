"""Port vs JAX on the same numpy inputs: the int8 clock kernels' plain
versions (core/tables.py state_cos_sin, ops/clock_pallas.py,
ops/clock_measure_pallas.py, ops/clock_multisweep.py).

Tolerances.  The per-state (cos, sin) and the phases are held bitwise:
the plain phase with injected uniforms against JAX's ``Clock2D._phase``
(the jnp oracle JAX's tests/test_shard_pallas.py holds its Pallas kernel
to) and against the Pallas kernel itself in interpret mode
(``clock_pallas.sharded_phase`` with periodic halos): both spell the same
float32 operations in the same order, and XLA's exp and torch's agree on
every case here.  The measure's float64 sums against JAX's float32
``observables`` within 1e-5 relative (float32 against float64) and against
the port's float64 model within 1e-12; the plain multisweep's states
against plain phase pairs bitwise, its fused sums against the plain
measure within 1e-12.  JAX gets arrays of its own (never a buffer the port
updates in place)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_fortran_mc_simulation_spin_tpu.core import tables as jtables
from cuda_fortran_mc_simulation_spin_tpu.models.base import (
    CheckerboardState as JaxState,
)
from cuda_fortran_mc_simulation_spin_tpu.models.clock import (
    Clock2D as JaxClock,
)
from cuda_fortran_mc_simulation_spin_tpu.ops import clock_pallas as jcp
from cuda_fortran_mc_simulation_spin_tpu.ops import ising2d_pallas as ji2p
from cuda_fortran_mc_simulation_spin_tpu_torch.core import rng, tables
from cuda_fortran_mc_simulation_spin_tpu_torch.models import Clock2D
from cuda_fortran_mc_simulation_spin_tpu_torch.models.base import (
    CheckerboardState,
)
from cuda_fortran_mc_simulation_spin_tpu_torch.models.clock import candidates
from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
    clock_measure_pallas as c8m,
)
from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
    clock_multisweep as c8ms,
)
from cuda_fortran_mc_simulation_spin_tpu_torch.ops import clock_pallas as c8p
from cuda_fortran_mc_simulation_spin_tpu_torch.ops import multispin_rng

KBT = 0.91
KBT_ISING = 2.26918531421


def _states(g, q, shape):
    return g.integers(0, q, size=shape, dtype=np.int8)


def _uniforms(g, shape):
    """float32 uniforms on the 24-bit grid the kernels draw from."""
    return (g.integers(0, 2 ** 24, size=shape) * 2.0 ** -24).astype(
        np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


@pytest.mark.parametrize("q", [2, 3, 5, 6, 8, 16, 17, 20, 127])
def test_state_cos_sin_equals_jax_bitwise(q):
    s = np.arange(q, dtype=np.int32)
    jc, js = jtables.state_cos_sin(jnp.asarray(s), q)
    c, sn = tables.state_cos_sin(torch.from_numpy(s), q)
    np.testing.assert_array_equal(c.numpy().view(np.int32),
                                  np.asarray(jc).view(np.int32))
    np.testing.assert_array_equal(sn.numpy().view(np.int32),
                                  np.asarray(js).view(np.int32))
    if q == 2:
        assert sn[1] != 0 and abs(float(sn[1])) < 2e-16


def test_words_layout_and_candidates():
    """Site (r, row, c) takes outputs 2(c & 1) and 2(c & 1) + 1 of the
    Philox counter (r, row, c >> 1, 0): one call feeds two adjacent sites,
    and a ragged last unit (half = 7) leaves its spare outputs unused.
    The candidate is never the current state, at every uniform the
    kernels can draw."""
    key = rng.seeds_from_key(rng.sweep_key(rng.base_key(5), 3), 1)
    wc, wa = c8p.draw_words(key, 2, 3, 7)
    assert wc.shape == wa.shape == (2, 3, 7) and wc.dtype == torch.int64
    for r, row, c in ((0, 0, 0), (1, 2, 6), (0, 1, 5), (1, 0, 3)):
        ctr = torch.tensor([r, row, c >> 1, 0], dtype=torch.int64)
        out = rng.philox4x32(ctr, key)
        assert int(wc[r, row, c]) == int(out[2 * (c & 1)])
        assert int(wa[r, row, c]) == int(out[2 * (c & 1) + 1])
    uc, ua = c8p.draw_uniforms(key, 2, 3, 7)
    assert torch.equal(uc, rng.bits_to_uniform(wc))
    u = torch.arange(2 ** 24, dtype=torch.float32) * 2.0 ** -24
    for q in (2, 3, 5, 6, 20, 127):
        for x in (0, q - 1, q // 2):
            new = candidates(torch.full_like(u, x, dtype=torch.int8), u, q)
            assert int(new.min()) >= 0 and int(new.max()) < q
            assert not bool((new == x).any())


def _jax_phase(jmodel, x, o, color, uc, ua):
    return np.asarray(jax.vmap(
        lambda a, b, c, d: jmodel._phase(a, b, color, c, d))(
        jnp.asarray(x), jnp.asarray(o), jnp.asarray(uc), jnp.asarray(ua)))


@pytest.mark.parametrize("color", [0, 1])
@pytest.mark.parametrize("q", [2, 5, 6, 20])
@pytest.mark.parametrize("shape", [(3, 130, 63), (2, 64, 128)])
def test_phase_matches_jax_oracle(q, color, shape):
    """The plain phase with injected uniforms equals JAX's
    ``Clock2D._phase`` (jnp) at a ragged shape and at the Pallas test's."""
    g = np.random.default_rng(100 * q + 10 * color + shape[1])
    x, o = _states(g, q, shape), _states(g, q, shape)
    uc, ua = _uniforms(g, shape), _uniforms(g, shape)
    kbt = KBT_ISING if q == 2 else KBT
    jmodel = JaxClock(nx=2 * shape[2], ny=shape[1], kbt=kbt, q=q,
                      backend="jnp")
    want = _jax_phase(jmodel, x, o, color, uc, ua)
    got = c8p.phase_plain(_t(x), _t(o), color=color, q=q, beta=1 / kbt,
                          u_cand=_t(uc), u_acc=_t(ua)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("color", [0, 1])
@pytest.mark.parametrize("q", [2, 5, 6, 20])
def test_phase_matches_jax_pallas_kernel(q, color):
    """The plain phase equals the JAX Pallas kernel in interpret mode
    (``sharded_phase`` over the whole lattice, the halos the periodic
    wrap) with injected uniforms, at R, L, HALF = 2, 64, 128."""
    shape = (2, 64, 128)
    g = np.random.default_rng(7 * q + color)
    x, o = _states(g, q, shape), _states(g, q, shape)
    uc, ua = _uniforms(g, shape), _uniforms(g, shape)
    jx, jo = jnp.asarray(x), jnp.asarray(o)
    want = np.asarray(jcp.sharded_phase(
        jx, jo, jo[:, -1:], jo[:, :1], ji2p.seeds_from_key(
            jax.random.PRNGKey(9), 0), jnp.array([0, 0], jnp.int32),
        color=color, q=q, beta=1 / KBT, u_cand=jnp.asarray(uc),
        u_acc=jnp.asarray(ua), interpret=True))
    got = c8p.phase_plain(_t(x), _t(o), color=color, q=q, beta=1 / KBT,
                          u_cand=_t(uc), u_acc=_t(ua)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("q", [2, 4, 5, 6, 20])
@pytest.mark.parametrize("shape", [(3, 130, 63), (2, 64, 128)])
def test_measure_matches_jax_and_the_model(q, shape):
    """The plain measure's (Σ cos, Σ sin, E) against JAX's float32
    ``observables`` (1e-5 relative) and the port's float64 model (1e-12);
    at q = 2 and 4 the sums are integers."""
    g = np.random.default_rng(q + shape[1])
    a, b = _states(g, q, shape), _states(g, q, shape)
    model = Clock2D(nx=2 * shape[2], ny=shape[1], kbt=KBT, q=q)
    got = c8m.measure_sums(_t(a), _t(b), q)
    assert got.shape == (shape[0], 3) and got.dtype == torch.float64
    jmodel = JaxClock(nx=model.nx, ny=model.ny, kbt=KBT, q=q, backend="jnp")
    jobs = jax.vmap(jmodel.observables)(JaxState(jnp.asarray(a),
                                                 jnp.asarray(b)))
    dens = c8m.measure(model, CheckerboardState(_t(a), _t(b)))
    for k in ("m", "my", "e"):
        np.testing.assert_allclose(dens[k].numpy(),
                                   np.asarray(jobs[k], np.float64),
                                   rtol=1e-5, atol=1e-5)
    obs = model.observables(CheckerboardState(_t(a), _t(b)))
    n = model.nsites
    for k, col in (("m", 0), ("my", 1), ("e", 2)):
        np.testing.assert_allclose(got[:, col].numpy(), obs[k].numpy() * n,
                                   rtol=1e-12, atol=1e-12 * n)
    if q in (2, 4):
        assert torch.equal(got, torch.round(got))


def test_multisweep_plain_equals_phase_pairs_and_measure():
    """S plain multisweep sweeps equal S plain phase pairs under the same
    per-sweep keys, states bitwise; the fused sums of each sweep equal the
    plain measure of that state within 1e-12 relative."""
    g = np.random.default_rng(7)
    shape = (3, 10, 7)
    q = 5
    a0, b0 = _states(g, q, shape), _states(g, q, shape)
    seeds = multispin_rng.sweep_phase_keys(rng.sample_key(rng.base_key(3),
                                                          1), 6, 4)
    ka, kb, kobs = c8ms.multisweep_plain(_t(a0), _t(b0), seeds, q=q,
                                         beta=1 / KBT)
    assert kobs.shape == (3, 6, 3) and kobs.dtype == torch.float64
    pa, pb = _t(a0), _t(b0)
    for s in range(6):
        pa = c8p.phase_plain(pa, pb, seeds[s, 0], color=0, q=q,
                             beta=1 / KBT)
        pb = c8p.phase_plain(pb, pa, seeds[s, 1], color=1, q=q,
                             beta=1 / KBT)
        np.testing.assert_allclose(kobs[:, s].numpy(),
                                   c8m.measure_sums_plain(pa, pb, q).numpy(),
                                   rtol=1e-12, atol=1e-12 * 140)
    assert torch.equal(ka, pa) and torch.equal(kb, pb)


def test_wrappers_take_plain_versions_on_cpu_in_place():
    """On CPU tensors each wrapper runs its plain version, updates the
    given planes in place and launches nothing."""
    for mod in (c8p, c8m, c8ms):
        mod.reset_launches()
    g = np.random.default_rng(9)
    q = 6
    seeds = multispin_rng.sweep_phase_keys(rng.sample_key(rng.base_key(1),
                                                          0), 3)
    a, b = _t(_states(g, q, (2, 6, 5))), _t(_states(g, q, (2, 6, 5)))
    want = c8p.phase_plain(a, b, seeds[0, 0], color=0, q=q, beta=0.4)
    assert c8p.metropolis_phase(a, b, seeds[0, 0], color=0, q=q,
                                beta=0.4) is a
    assert torch.equal(a, want)
    uc, ua = _t(_uniforms(g, (2, 6, 5))), _t(_uniforms(g, (2, 6, 5)))
    want = c8p.phase_plain(b, a, color=1, q=q, beta=0.4, u_cand=uc,
                           u_acc=ua)
    c8p.metropolis_phase(b, a, color=1, q=q, beta=0.4, u_cand=uc, u_acc=ua)
    assert torch.equal(b, want)
    with pytest.raises(ValueError, match="both"):
        c8p.metropolis_phase(b, a, color=1, q=q, beta=0.4, u_cand=uc)
    wa, wb, wobs = c8ms.multisweep_plain(a, b, seeds, q=q, beta=0.4)
    ka, kb, kobs = c8ms.multisweep_planes(a, b, seeds, q=q, beta=0.4)
    assert ka is a and torch.equal(ka, wa) and torch.equal(kb, wb)
    assert torch.equal(kobs, wobs)
    assert torch.equal(c8m.measure_sums(a, b, q),
                       c8m.measure_sums_plain(a, b, q))
    for mod in (c8p, c8m, c8ms):
        assert not any(mod.LAUNCHES.values())


def test_model_sweep_dispatches_to_the_int8_op_in_place():
    """``sweep`` on (ny, half) arrays and on a replica batch runs the int8
    phase under the sweep's two phase keys, in place, bitwise; the batched
    observables are the measure op's."""
    key = rng.sweep_key(rng.sample_key(rng.base_key(4), 0), 1)
    seeds = c8p.phase_seeds(key)
    model = Clock2D(nx=12, ny=6, kbt=KBT, q=7)
    g = np.random.default_rng(3)
    a, b = _states(g, 7, (2, 6, 6)), _states(g, 7, (2, 6, 6))
    st = CheckerboardState(_t(a), _t(b))
    wa = c8p.phase_plain(st.a, st.b, seeds[0], color=0, q=7,
                         beta=model.beta)
    wb = c8p.phase_plain(st.b, wa, seeds[1], color=1, q=7, beta=model.beta)
    one = CheckerboardState(_t(a[0]), _t(b[0]))
    model.sweep(one, key)
    assert torch.equal(one.a, wa[0]) and torch.equal(one.b, wb[0])
    model.sweep(st, key)
    assert torch.equal(st.a, wa) and torch.equal(st.b, wb)
    obs = model.observables_batched(st)
    assert torch.equal(obs["e"], c8m.measure_sums_plain(wa, wb, 7)[:, 2]
                       / model.nsites)


def test_launch_bounds_refused():
    """A launch whose unit index could pass 2^31, with more replicas than
    the grid's y extent, or with a q the tables do not hold is refused
    before it reaches the card."""
    c8p.check_launch(16, 1000, 500, 127)
    with pytest.raises(ValueError, match="2\\^31"):
        c8p.check_launch(1, 2 ** 20, 2 ** 12 + 1, 6)
    with pytest.raises(ValueError, match="replicas"):
        c8p.check_launch(65536, 2, 1, 6)
    with pytest.raises(ValueError, match="q=128"):
        c8p.check_launch(1, 2, 1, 128)
    assert c8p.units(63) == 32 and c8p.units(500) == 250
    rows = c8p.table_rows(5)
    assert rows.shape == (2, c8p.TABLE) and not rows[:, 5:].any()
    assert torch.equal(rows[:, :5], tables.clock_cos_sin_table(5))
