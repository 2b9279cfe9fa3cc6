"""Port vs JAX on the same numpy inputs: the helical 3-D Ising slice.

Deterministic parts are held bitwise (tolerance 0) on the valid bits:
offsets and z-parity masks, the int8 model's (sub-)phases and sweep with
injected uniforms, the packed oracle, the phase with injected Bernoulli
planes against the three JAX kernel sites that compute it
(``phase_packed_with_bits`` :197, ``_stream_phase`` :452 and
``_halo_phase`` :838, in interpret mode), the energy against
``_halo_energy`` :938, ``_energy_all_packed`` and a numpy brute force.
The JAX multisweep (:290) draws the chip's PRNG, so the port's multisweep
is held bitwise against its own streamed phases under the same keys, and
its fused (m, e) exactly against the JAX sums of the final state.  The
CLIs draw different streams (Philox against threefry) and are held within
5 combined standard errors.

Geometries: odd nx·ny 7x5x6 (M = 105), 9x7x4 (M = 126, 30 bits in the last
word) and 3x3x2 (M = 9 < 32); even nx·ny 9x8x6 (zh = 36) and 5x4x4
(M = 40); the JAX halo tests' 17x16x242 and 17x15x258 for the block
kernel."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_fortran_mc_simulation_spin_tpu.models.ising3d_helical import (
    Ising3DHelical as JaxModel,
)
from cuda_fortran_mc_simulation_spin_tpu.ops import helical3d_multispin as jh3
from cuda_fortran_mc_simulation_spin_tpu.ops.helical_multispin import (
    valid_mask as jax_valid_mask,
)
from cuda_fortran_mc_simulation_spin_tpu.ops.ising2d_multispin import (
    chain_digits,
)
from cuda_fortran_mc_simulation_spin_tpu.runs.__main__ import main as jax_main
from cuda_fortran_mc_simulation_spin_tpu_torch import interop
from cuda_fortran_mc_simulation_spin_tpu_torch.config import RunConfig
from cuda_fortran_mc_simulation_spin_tpu_torch.core import rng
from cuda_fortran_mc_simulation_spin_tpu_torch.engine import protocols, sweep
from cuda_fortran_mc_simulation_spin_tpu_torch.models import (
    Ising3D,
    Ising3DHelical,
    build_model,
)
from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
    helical3d_multispin as h3,
)
from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
    ising2d_multispin as ms2,
)
from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
    ising3d_multispin as ms3,
)
from cuda_fortran_mc_simulation_spin_tpu_torch.ops import multispin_rng
from cuda_fortran_mc_simulation_spin_tpu_torch.ops.ising2d_multispin import (
    MASK32,
)
from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
    helical_multispin as hms,
)
from cuda_fortran_mc_simulation_spin_tpu_torch.runs.__main__ import main

KBT = 4.511454583186711
ODD = [(7, 5, 6), (9, 7, 4), (3, 3, 2)]
EVEN = [(9, 8, 6), (5, 4, 4)]
GEOMS = ODD + EVEN
HALO_SELF, HALO_CROSS = (17, 16, 242), (17, 15, 258)


def _spins(g, shape):
    return (g.integers(0, 2, size=shape, dtype=np.int8) * 2 - 1).astype(
        np.int8)


def _words(g, shape):
    return g.integers(-2 ** 31, 2 ** 31, size=shape,
                      dtype=np.int64).astype(np.int32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _unpack_jax(w, m):
    """JAX words of any layout -> ±1 (R, m) numpy."""
    return hms.unpack_flat(interop.helical3d_from_numpy(np.asarray(w), m),
                           m).numpy()


@pytest.mark.parametrize("dims", GEOMS)
def test_offsets_and_zmask_match_jax(dims):
    nx, ny, nz = dims
    nxy, m = nx * ny, nx * ny * nz // 2
    assert h3.helical3d_offsets(nx, nxy) == jh3.helical3d_offsets(nx, nxy)
    if nxy % 2 == 0:
        want = jh3.zmask_plane(nxy, jh3.grid_rows(m))
        np.testing.assert_array_equal(
            hms._i32(h3.zmask_words(nxy, m)).numpy(),
            interop.helical_from_numpy(np.asarray(want), m).numpy())


@pytest.mark.parametrize("dims", GEOMS)
def test_model_phases_and_sweep_match_jax(dims):
    """Every (sub-)phase and the whole MCS with the same injected
    uniforms (one batch for all phases), then the exact sums."""
    nx, ny, nz = dims
    model, jm = Ising3DHelical(nx, ny, nz, KBT), JaxModel(nx, ny, nz, KBT)
    g = np.random.default_rng(nx * ny * nz)
    flat = _spins(g, (model.nsites,))
    u = g.random(model.nsites, dtype=np.float32)
    for offset in (0, 1):
        for zsub in (None, 0, 1):
            got = model._phase(_t(flat), offset, _t(u), zsub)
            want = jm._phase(jnp.asarray(flat), offset, jnp.asarray(u), zsub)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    got = model.sweep_with_uniforms(_t(flat), _t(u))
    want = jnp.asarray(flat)
    for offset in (0, 1):
        for zsub in ((None,) if jm.z_cross_parity else (0, 1)):
            want = jm._phase(want, offset, jnp.asarray(u), zsub)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(model.magne_sum(got)) == int(jm.magne_sum(want))
    assert int(model.energy_sum(got)) == int(jm.energy_sum(want))
    f = flat.astype(np.int64)
    brute = -sum(int((f * np.roll(f, -d)).sum()) for d in (1, nx, nx * ny))
    assert int(model.energy_sum(_t(flat))) == brute
    assert model.sweep(_t(flat), rng.sweep_key(rng.base_key(1), 1)).shape \
        == (model.nsites,)


@pytest.mark.parametrize("dims", GEOMS)
@pytest.mark.parametrize("color", [0, 1])
def test_packed_reference_and_bits_phase_match_jax(dims, color):
    """The port's packed oracle and its phase with injected planes (the
    plain version on the CPU) against the JAX packed oracle and
    ``phase_packed_with_bits`` (:197, interpret mode, every z-parity
    sub-phase against the oracle), and the flat ±1 oracles of both
    packages."""
    nx, ny, nz = dims
    nxy, m = nx * ny, nx * ny * nz // 2
    g = np.random.default_rng(nx * 100 + nz * 10 + color)
    x, o = _spins(g, (2, m)), _spins(g, (2, m))
    flags = [g.random((2, m)) < p for p in (0.4, 0.15, 0.05)]
    offs_cross, offs_self = h3._stencil(nx, nxy, color)
    xw, ow = hms.pack_flat(_t(x), m), hms.pack_flat(_t(o), m)
    bits = [hms.pack_flat(_t(f.astype(np.int8) * 2 - 1), m) for f in flags]
    jw = [jnp.asarray(interop.helical3d_to_numpy(v, m))
          for v in (xw, ow, *bits)]
    for zsub in ([None] if nxy % 2 else [None, 0, 1]):
        jz = None if zsub is None else jh3.zmask_plane(nxy, jh3.grid_rows(m))
        zf = None if zsub is None else _t(
            (np.arange(m) // (nxy // 2)) % 2 == 0)
        got = h3.phase_packed_with_bits(xw, ow, *bits, color=color, nx=nx,
                                        nxy=nxy, m=m, zsub=zsub)
        want = jax.vmap(lambda *v, z=zsub, jz=jz: jh3.packed_phase_reference(
            *v[:2], offs_cross, offs_self, *v[2:], m, zmask=jz,
            zsub=z or 0))(*jw)
        np.testing.assert_array_equal(hms.unpack_flat(got, m).numpy(),
                                      _unpack_jax(want, m))
        flat = h3.flat_phase_reference(_t(x), _t(o), offs_cross, offs_self,
                                       *(_t(f) for f in flags), zmask=zf,
                                       zsub=zsub or 0)
        np.testing.assert_array_equal(hms.unpack_flat(got, m).numpy(),
                                      flat.numpy())
        jflat = jh3.flat_phase_reference(
            jnp.asarray(x[0]), jnp.asarray(o[0]), offs_cross, offs_self,
            *(jnp.asarray(f[0]) for f in flags),
            zmask=None if zf is None else jnp.asarray(zf.numpy()),
            zsub=zsub or 0)
        np.testing.assert_array_equal(flat[0].numpy(), np.asarray(jflat))
        if zsub is None:
            jgot = jh3.phase_packed_with_bits(*jw, offs_cross=offs_cross,
                                              offs_self=offs_self, m=m,
                                              interpret=True)
            np.testing.assert_array_equal(_unpack_jax(jgot, m),
                                          hms.unpack_flat(got, m).numpy())


@pytest.mark.parametrize("measuring", [False, True])
def test_bits_phase_matches_jax_stream_kernel(measuring):
    """The JAX streaming kernel (:452) on its one-block grid, phase b with
    injected planes: the port's phase bitwise, and its fused (m, e) equal
    to the sum of the JAX kernel's block partials."""
    nx, ny, nz = 33, 32, 30
    nxy, m = nx * ny, nx * ny * nz // 2
    rows = jh3.stream_rows(m)
    g = np.random.default_rng(4)
    a, b = _spins(g, (2, m)), _spins(g, (2, m))
    wa, wb = hms.pack_flat(_t(a), m), hms.pack_flat(_t(b), m)
    jbits = [_words(g, (2, rows, 128)) for _ in range(3)]
    bits = [interop.helical3d_from_numpy(v, m) for v in jbits]
    offs_cross, offs_self = h3._stencil(nx, nxy, 1)
    out, obs = jh3._stream_phase(
        jnp.asarray(interop.helical3d_to_numpy(wb, m, rows)),
        jnp.asarray(interop.helical3d_to_numpy(wa, m, rows)),
        jnp.zeros((2,), jnp.int32), offs_cross=offs_cross,
        offs_self=offs_self, m=m, rows=rows, nrep=2,
        d4=tuple(chain_digits(0.3)), d8=tuple(chain_digits(0.1)),
        d12=tuple(chain_digits(0.03)), measuring=measuring,
        bits=[jnp.asarray(v) for v in jbits], interpret=True)
    got = h3.phase_packed_with_bits(wb, wa, *bits, color=1, nx=nx, nxy=nxy,
                                    m=m)
    np.testing.assert_array_equal(hms.unpack_flat(got, m).numpy(),
                                  _unpack_jax(out, m))
    if measuring:
        x, o = hms._u32(wb), hms._u32(wa)
        b1, b2, b4c = h3._counts(x, o, offs_cross, offs_self, m)
        sums = h3._obs_sums(hms._u32(got), o, b1, b2, b4c, m, True)
        jsums = np.asarray(obs)[:, :, :2].astype(np.int64).sum(axis=1)
        np.testing.assert_array_equal(sums.numpy(), jsums)


@pytest.mark.parametrize("dims,color,zsub", [
    (HALO_SELF, 0, 0), (HALO_SELF, 0, 1), (HALO_SELF, 1, 0),
    (HALO_SELF, 1, 1), (HALO_CROSS, 0, None), (HALO_CROSS, 1, None)])
def test_bits_phase_matches_jax_halo_kernel(dims, color, zsub):
    """The JAX block-halo kernel (:838) with block_rows=8 on its ring-pad
    layout, with the z-parity mask: the port's phase on the flat words,
    bitwise on the valid bits (interop clears the ring pad)."""
    nx, ny, nz = dims
    nxy, m = nx * ny, nx * ny * nz // 2
    k = jh3._halo_pad_k(nx, nxy)
    rows = jh3.halo_rows(m, k, 8)
    g = np.random.default_rng(nz + color)
    a, b = _spins(g, (2, m)), _spins(g, (2, m))
    ja = jh3.pack_flat_halo(jnp.asarray(a), m, nx, nxy, 8)
    jb = jh3.pack_flat_halo(jnp.asarray(b), m, nx, nxy, 8)
    wa, wb = interop.helical3d_from_numpy(ja, m), interop.helical3d_from_numpy(
        jb, m)
    np.testing.assert_array_equal(wa.numpy(), hms.pack_flat(_t(a), m).numpy())
    jbits = [_words(g, (2, rows, 128)) for _ in range(3)]
    bits = [interop.helical3d_from_numpy(v, m) for v in jbits]
    offs_cross, offs_self = h3._stencil(nx, nxy, color)
    x, o = (ja, jb) if color == 0 else (jb, ja)
    jout = jh3.halo_phase_with_bits(
        x, o, *(jnp.asarray(v) for v in jbits), offs_cross=offs_cross,
        offs_self=offs_self, m=m, block_rows=8,
        zmask=None if zsub is None else jh3.zmask_plane(nxy, rows),
        zsub=zsub or 0, interpret=True)
    xw, ow = (wa, wb) if color == 0 else (wb, wa)
    got = h3.phase_packed_with_bits(xw, ow, *bits, color=color, nx=nx,
                                    nxy=nxy, m=m, zsub=zsub)
    np.testing.assert_array_equal(hms.unpack_flat(got, m).numpy(),
                                  _unpack_jax(jout, m))


@pytest.mark.parametrize("dims", [HALO_SELF, HALO_CROSS])
def test_energy_matches_jax_halo_energy_and_funnel_energy(dims):
    """energy_kernel's plain version against ``_halo_energy`` (:938,
    interpret, block_rows=8), ``_energy_all_packed``, ``magne_sum_packed``
    and the flat model's exact sums, exactly."""
    nx, ny, nz = dims
    nxy, m = nx * ny, nx * ny * nz // 2
    model = Ising3DHelical(nx, ny, nz, KBT)
    k = jh3._halo_pad_k(nx, nxy)
    rows = jh3.halo_rows(m, k, 8)
    g = np.random.default_rng(22)
    flat = _spins(g, (2, model.nsites))
    a, b = flat[:, 0::2], flat[:, 1::2]
    ja = jh3.pack_flat_halo(jnp.asarray(a), m, nx, nxy, 8)
    jb = jh3.pack_flat_halo(jnp.asarray(b), m, nx, nxy, 8)
    wa, wb = hms.pack_flat(_t(a), m), hms.pack_flat(_t(b), m)
    got = h3.energy_sums(wa, wb, nx=nx, nxy=nxy, m=m)
    jhalo = jh3._halo_energy(ja, jb, nx=nx, nxy=nxy, m=m, rows=rows, nrep=2,
                             block_rows=8, interpret=True)
    pw = [jnp.asarray(interop.helical3d_to_numpy(w, m)) for w in (wa, wb)]
    jall = jh3._energy_all_packed(*pw, nx, nxy, m,
                                  jax_valid_mask(jh3.grid_rows(m), m)[None])
    np.testing.assert_array_equal(got[:, 1].numpy(),
                                  np.asarray(jhalo).astype(np.int64))
    np.testing.assert_array_equal(got[:, 1].numpy(),
                                  np.asarray(jall).astype(np.int64))
    np.testing.assert_array_equal(
        got[:, 0].numpy(),
        np.asarray(jh3.magne_sum_packed(*pw, m)).astype(np.int64))
    np.testing.assert_array_equal(got[:, 0].numpy(),
                                  model.magne_sum(_t(flat)).numpy())
    np.testing.assert_array_equal(got[:, 1].numpy(),
                                  model.energy_sum(_t(flat)).numpy())


@pytest.mark.parametrize("dims", ODD[:2])
def test_multisweep_plain_equals_streamed_phases_and_jax_sums(dims):
    """S sweeps of the plain multisweep equal S streamed phase pairs under
    the same keys, bitwise in state and (m, e); each sweep's fused (m, e)
    equals the JAX ``_energy_all_packed`` and ``magne_sum_packed`` of that
    sweep's state."""
    nx, ny, nz = dims
    model = Ising3DHelical(nx, ny, nz, KBT)
    nxy, m = model.nxy, model.nsites // 2
    g = np.random.default_rng(nx)
    wa = hms.pack_flat(_t(_spins(g, (2, m))), m)
    wb = hms.pack_flat(_t(_spins(g, (2, m))), m)
    seeds = h3.sweep_keys(model, rng.sample_key(rng.base_key(4), 1), 3)
    ka, kb, kobs = h3.multisweep_planes(wa, wb, seeds, beta=model.beta,
                                        nx=nx, nxy=nxy, m=m)
    assert kobs.shape == (2, 3, 2) and kobs.dtype == torch.int64
    vm = hms.valid_mask(m)
    jvm = jax_valid_mask(jh3.grid_rows(m), m)[None]
    pa, pb = wa, wb
    for s in range(3):
        pa, pb, obs = h3.sweep_measure_seeded(model, pa, pb, seeds[s])
        for k, col in (("m", 0), ("e", 1)):
            assert torch.equal(obs[k], kobs[:, s, col].double() / model.nsites)
        pw = [jnp.asarray(interop.helical3d_to_numpy(w, m)) for w in (pa, pb)]
        np.testing.assert_array_equal(
            kobs[:, s, 1].numpy(),
            np.asarray(jh3._energy_all_packed(*pw, nx, nxy, m, jvm)).astype(
                np.int64))
        np.testing.assert_array_equal(
            kobs[:, s, 0].numpy(),
            np.asarray(jh3.magne_sum_packed(*pw, m)).astype(np.int64))
    assert torch.equal(hms._u32(ka) & vm, hms._u32(pa) & vm)
    assert torch.equal(hms._u32(kb) & vm, hms._u32(pb) & vm)


@pytest.mark.parametrize("dims", [(9, 7, 4), (9, 8, 6)])
def test_pad_bits_do_not_reach_valid_sites_or_obs(dims):
    """Ones in the pad bits of the inputs change no valid bit and no
    observable, on either route and at either parity."""
    nx, ny, nz = dims
    model = Ising3DHelical(nx, ny, nz, KBT)
    m = model.nsites // 2
    g = np.random.default_rng(9)
    wa = hms.pack_flat(_t(_spins(g, (1, m))), m)
    wb = hms.pack_flat(_t(_spins(g, (1, m))), m)
    pad = hms._i32(~hms.valid_mask(m) & hms.MASK32)
    key = rng.sample_key(rng.base_key(2), 0)
    routes = [h3.multisweep_stream] + ([h3.multisweep] if h3.fits(model)
                                       else [])
    for route in routes:
        clean = route(model, wa, wb, key, 2)
        dirty = route(model, wa | pad, wb | pad, key, 2)
        for c, d in zip(clean[:2], dirty[:2]):
            assert torch.equal(hms.unpack_flat(c, m), hms.unpack_flat(d, m))
        for k in ("m", "e"):
            assert torch.equal(clean[2][k], dirty[2][k])


def test_even_nxy_measuring_phase_gives_m_only():
    """With self reads the fused identity does not hold: the measuring
    phase reports the exact m and e = 0; energy_sums gives both."""
    nx, ny, nz = 9, 8, 6
    model = Ising3DHelical(nx, ny, nz, KBT)
    m = model.nsites // 2
    g = np.random.default_rng(3)
    flat = _t(_spins(g, (2, model.nsites)))
    a, b = hms.split_flat(flat)
    wa, wb = hms.pack_flat(a, m), hms.pack_flat(b, m)
    new, obs = h3.phase_packed(wb, wa, rng.base_key(5), color=1, nx=nx,
                               nxy=model.nxy, m=m, beta=model.beta, zsub=1,
                               measuring=True)
    final = hms.merge_flat(hms.unpack_flat(wa, m), hms.unpack_flat(new, m))
    assert torch.equal(obs[:, 0], model.magne_sum(final))
    assert torch.equal(obs[:, 1], torch.zeros(2, dtype=torch.int64))
    assert torch.equal(
        h3.energy_sums(wa, new, nx=nx, nxy=model.nxy, m=m),
        torch.stack([model.magne_sum(final), model.energy_sum(final)], -1))


def test_interop_layouts_round_trip():
    """to_numpy gives the JAX ``pack_flat`` and ``pack_flat_stream``
    planes exactly (pad bits cleared); from_numpy takes any of the three
    layouts back."""
    nx, ny, nz = 9, 7, 4
    m = nx * ny * nz // 2
    flat = _spins(np.random.default_rng(1), (2, m))
    w = hms.pack_flat(_t(flat), m)
    dirty = w | hms._i32(~hms.valid_mask(m) & hms.MASK32)
    jflat = jnp.asarray(flat)
    np.testing.assert_array_equal(interop.helical3d_to_numpy(dirty, m),
                                  np.asarray(jh3.pack_flat(jflat, m)))
    rows = jh3.stream_rows(m)
    np.testing.assert_array_equal(
        interop.helical3d_to_numpy(dirty, m, rows),
        np.asarray(jh3.pack_flat_stream(jflat, m)))
    for jw in (jh3.pack_flat(jflat, m), jh3.pack_flat_stream(jflat, m)):
        assert torch.equal(interop.helical3d_from_numpy(np.asarray(jw), m), w)


def test_gates_routes_and_refusals():
    with pytest.raises(ValueError, match="odd nx"):
        Ising3DHelical(16, 17, 17, KBT)
    with pytest.raises(ValueError, match="even site count"):
        Ising3DHelical(17, 17, 17, KBT)
    with pytest.raises(ValueError, match="odd z-rings"):
        Ising3DHelical(17, 16, 17, KBT)
    cfg = RunConfig(model="ising3d", nx=151, ny=151, nz=150, kbt=KBT, mcs=2,
                    tot_sample=1)
    assert isinstance(build_model(cfg), Ising3DHelical)
    cfg = RunConfig(model="ising3d", nx=16, ny=16, nz=16, kbt=KBT, mcs=2,
                    tot_sample=1)
    assert isinstance(build_model(cfg), Ising3D)   # even nx: periodic
    small = Ising3DHelical(151, 151, 150, KBT)
    mid = Ising3DHelical(501, 501, 500, 4.51152174982078)
    app = Ising3DHelical(1001, 1000, 1000, KBT)
    assert small.z_cross_parity and mid.z_cross_parity
    assert not app.z_cross_parity
    assert h3.fits(small) and not h3.fits(mid) and not h3.fits(app)
    assert all(h3.fits_stream(x) for x in (small, mid, app))
    assert hms.words(small.nsites // 2) == 53440
    assert hms.words(app.nsites // 2) == 15640625
    assert sweep.make_helical_runner(small, 1, 1, device="cpu").engine == \
        "helical3d_multispin (resident multisweep)"
    for model in (mid, app):
        assert sweep.make_helical_runner(model, 1, 1, device="cpu").engine \
            == "helical3d_multispin (streamed phases)"
    huge = Ising3DHelical(2049, 1024, 1024, KBT)
    assert not h3.fits_stream(huge)
    cfg = RunConfig(model="ising3d", nx=2049, ny=1024, nz=1024, kbt=KBT,
                    mcs=2, tot_sample=1)
    with pytest.raises(NotImplementedError, match="queue A item 4a"):
        protocols._check_route(cfg, huge)


def test_wrappers_take_plain_versions_on_cpu_and_check_arguments():
    h3.reset_launches()
    model = Ising3DHelical(9, 7, 4, KBT)
    m = model.nsites // 2
    w = hms.pack_flat(torch.ones((1, m), dtype=torch.int8), m)
    kw = dict(nx=9, nxy=63, m=m)
    h3.phase_packed_with_bits(w, w, w, w, w, color=0, **kw)
    h3.phase_packed(w, w, rng.base_key(0), color=1, beta=0.2, **kw)
    h3.energy_sums(w, w, **kw)
    h3.multisweep(model, w, w, rng.base_key(0), 1)
    assert h3.LAUNCHES == {"phase": 0, "phase_measuring": 0, "energy": 0,
                           "multisweep": 0}
    with pytest.raises(ValueError, match="CUDA"):
        h3._check(m, w, w)
    with pytest.raises(ValueError, match="W ="):
        h3._check(m + 64, w)
    with pytest.raises(ValueError, match="32-bit"):
        h3._check(h3.MAX_SITES, w)
    with pytest.raises(ValueError, match="odd nx"):
        h3.multisweep_planes(w, w, h3.sweep_keys(model, rng.base_key(0), 1),
                             beta=0.2, nx=9, nxy=72, m=m)
    with pytest.raises(ValueError, match="device"):
        h3.energy_sums(w.to("meta"), w.to("meta"), **kw)


# chain digits (q4, q8, q12): the kernel's kbt 4.5115 and others whose
# chains differ in trailing zeros, chains of no draw (q = 0), of one draw
# (q = 2^19), of twenty (odd q, 2^20 - 1), boundaries inside a Philox call
# and on a call's first draw, and the CLI's extremes (kbt 0.5: q8 = q12 =
# 0; kbt 1e9: every chain 2^20 - 1)
CHAIN_QS = [ms3.chain_words3d(1 / kbt) for kbt in (4.511454583186711, 0.5,
                                                   1e9, 3.0, 8.0)] + [
    (0, 0, 0), (1 << 19, 0, 1), (0, (1 << 20) - 1, 0), (3 << 18, 1, 0),
    (1 << 16, 1 << 16, 1 << 16), (5, 0, 0), (1 << 3, 0, (1 << 20) - 1)]


def _replay_chain_table(table, gen):
    """phase_kernel's chain_planes on torch words: draw n of ``gen``
    (word n % 4 of Philox call n // 4) folded by the table as the kernel
    folds it, fast calls straight and the others draw by draw."""
    digit, (live, fast, e4, e8, n_all) = table[:60], table[60:]
    b = p4 = p8 = 0
    for c in range(h3.CHAIN_CALLS):
        if not live >> c & 1:
            break
        w = [gen() for _ in range(4)]
        for j in range(4):
            n = 4 * c + j
            if not fast >> c & 1:
                if n >= n_all:
                    continue
                if n == e4:
                    p4, b = b, 0
                if n == e8:
                    p8, b = b, 0
            d = digit[n]
            b = (w[j] & b) | (w[j] & d) | (b & d)
    if e4 == n_all:
        p4, b = b, 0
    if e8 == n_all:
        p8, b = b, 0
    return p4, p8, b


@pytest.mark.parametrize("q", CHAIN_QS)
def test_chain_table_replays_the_plain_chains(q):
    """The unrolled chains' table (``chain_table``, the host half of
    phase_kernel's chain_planes) replayed on Philox words gives the plain
    chains' B4, B8, B12 planes of the same digits, bitwise, and draws as
    many words as they do."""
    key = rng.seeds_from_key(rng.base_key(3), 1)
    table = h3.chain_table(tuple(q))
    assert len(table) == 4 * h3.CHAIN_CALLS + 5
    plain = multispin_rng.word_stream(key, 2, 37, 1)
    want = [ms2._bern_plane((2, 37, 1), ms2._digits(qx), plain) for qx in q]
    assert table[-1] == sum(ms2.chain_draws(qx) for qx in q)
    replay = multispin_rng.word_stream(key, 2, 37, 1)
    got = _replay_chain_table(table, replay)
    for g, w_ in zip(got, want):
        g = torch.as_tensor(g, dtype=torch.int64).expand(2, 37, 1)
        assert torch.equal(g & MASK32, w_ & MASK32)
    with pytest.raises(ValueError, match="outside"):
        h3.chain_table((1 << 20, 0, 0))


def _split_dat(path):
    lines = path.read_text().splitlines()
    head = [s for s in lines if s.startswith("#")]
    rows = np.array([s.split() for s in lines if not s.startswith("#")],
                    dtype=np.float64)
    return head, rows


@pytest.mark.parametrize("dims", [(7, 5, 6), (9, 8, 6)])
def test_cli_dat_is_independent_of_chunking_and_route(dims, tmp_path,
                                                      monkeypatch):
    """Same seed, same .dat: at chunks of 64 and of 3 sweeps, and (odd
    nx·ny) on the resident and the streamed route; only the `# engine:`
    line names the route."""
    nx, ny, nz = dims
    flags = ["--model", "ising3d", "--nx", str(nx), "--ny", str(ny), "--nz",
             str(nz), "--kbt", repr(KBT), "--mcs", "7", "--samples", "4",
             "--replicas", "2", "--device", "cpu", "--output"]
    outs = [tmp_path / "a.dat"]
    assert main(flags + [str(outs[0])]) == 0
    monkeypatch.setattr(sweep, "DEFAULT_CHUNK", 3)
    outs.append(tmp_path / "b.dat")
    assert main(flags + [str(outs[1])]) == 0
    if nx * ny % 2:
        monkeypatch.setattr(h3, "fits", lambda model: False)
        outs.append(tmp_path / "c.dat")
        assert main(flags + [str(outs[2])]) == 0
    texts = [[s for s in p.read_text().splitlines()
              if not s.startswith("# engine:")] for p in outs]
    for t in texts[1:]:
        assert t == texts[0]
    engines = [[s for s in p.read_text().splitlines()
                if s.startswith("# engine:")] for p in outs]
    want = ("resident multisweep" if nx * ny % 2 else "streamed phases")
    assert want in engines[0][0]
    if nx * ny % 2:
        assert "streamed phases" in engines[2][0]


def test_cli_matches_jax_cli(tmp_path):
    """The port CLI (plain versions) against the JAX CLI at 9x8x6 (even
    nx·ny, the four sub-phases): equal headers except `# engine:`, m(t),
    e(t) within 5 combined standard errors at every t (different random
    streams, so not bitwise)."""
    flags = ["--model", "ising3d", "--nx", "9", "--ny", "8", "--nz", "6",
             "--kbt", repr(KBT), "--mcs", "12", "--samples", "32",
             "--replicas", "8"]
    port, jax_out = tmp_path / "port.dat", tmp_path / "jax.dat"
    assert main(flags + ["--device", "cpu", "--output", str(port)]) == 0
    assert jax_main(flags + ["--output", str(jax_out)]) == 0
    head, rows = _split_dat(port)
    jhead, jrows = _split_dat(jax_out)
    assert [h for h in head if not h.startswith("# engine:")] == [
        h for h in jhead if not h.startswith("# engine:")]
    assert "# nx, ny: 9 8 6" in head
    assert rows.shape == jrows.shape == (12, 10)
    np.testing.assert_array_equal(rows[:, :3], jrows[:, :3])
    n, ns = rows[0, 0], rows[0, 1]
    for col, var_col in ((3, 7), (4, 8)):
        se = np.sqrt((rows[:, var_col] + jrows[:, var_col]) / (n * ns))
        z = np.abs(rows[:, col] - jrows[:, col]) / se
        assert np.all(z < 5.0), (col, z)
