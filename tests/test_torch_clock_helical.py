"""Port vs JAX on the same numpy inputs: the helical q=6 clock slice.

The flat triplet packing, the packed phase with injected planes (against
the JAX kernel in interpret mode, the JAX packed oracle and the per-site
flat oracle, on the valid bits), the fused (2m, 2e, my2) against the JAX
state sums and the model's exact reduction, the slice as a whole (the
port's runner replayed phase by phase through the JAX oracle), the gates
and the CLI.  Shapes: 61x50 (M = 1525, a partial last word of 21 bits)
and 129x64 (M = 4128, the JAX helical tests' whole words)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_fortran_mc_simulation_spin_tpu.ops import (
    clock_helical_multispin as jchm,
)
from cuda_fortran_mc_simulation_spin_tpu_torch import interop
from cuda_fortran_mc_simulation_spin_tpu_torch.core import rng
from cuda_fortran_mc_simulation_spin_tpu_torch.engine import sweep
from cuda_fortran_mc_simulation_spin_tpu_torch.models import Clock2DHelical
from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
    clock_helical_multispin as chm,
)
from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
    helical_multispin as hms,
)
from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
    ising2d_multispin as msb,
)
from cuda_fortran_mc_simulation_spin_tpu_torch.runs.__main__ import main

SHAPES = [(61, 50), (129, 64)]
KBT = 0.8


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _valid(w, m):
    return hms._u32(w) & hms.valid_mask(m)


def _jax(planes, m):
    return tuple(jnp.asarray(p) for p in
                 interop.clock_helical_to_numpy(planes, m))


def _from_jax(planes, m):
    return interop.clock_helical_from_numpy([np.asarray(p) for p in planes],
                                            m)


def _per_rep(fn, *planes, **kw):
    """A JAX oracle of one replica's (rows, 128) planes over the replica
    axis (tuple arguments are plane tuples)."""
    nrep = planes[0][0].shape[0]
    outs = [fn(*(tuple(p[r] for p in arg) for arg in planes), **kw)
            for r in range(nrep)]
    return tuple(jnp.stack([o[k] for o in outs]) for k in range(len(outs[0])))


def _jax_phase(offs, m):
    return lambda x, o, p: jchm.packed_helical_phase6_reference(x, o, offs,
                                                                p, m)


@pytest.mark.parametrize("nx,ny", SHAPES)
def test_pack_flat_matches_jax(nx, ny):
    m = nx * ny // 2
    flat = np.random.default_rng(nx).integers(0, 6, size=(3, m)).astype(
        np.int8)
    got = chm.pack_clock_flat(_t(flat), m)
    want = jchm.pack_clock_flat(jnp.asarray(flat), m)
    for g_, w_ in zip(got, _from_jax(want, m)):
        assert g_.shape == (3, hms.words(m)) and torch.equal(g_, w_)
    np.testing.assert_array_equal(chm.unpack_clock_flat(*got, m).numpy(),
                                  flat)
    for g_, w_ in zip(got, _from_jax(_jax(got, m), m)):
        assert torch.equal(g_, w_)


def _planes8(g, shape):
    p = [g.integers(-2 ** 31, 2 ** 31, size=shape,
                    dtype=np.int64).astype(np.int32) for _ in range(8)]
    p[2] &= ~p[1]
    p[0] |= ~(p[1] | p[2])
    return p


@pytest.mark.parametrize("nx,ny", SHAPES)
def test_phase_matches_jax_kernel_and_oracles(nx, ny):
    """The plain phase with injected planes against the JAX kernel in
    interpret mode and the JAX packed oracle (both colours), and the
    per-site flat oracle of both packages, on the valid bits."""
    m = nx * ny // 2
    g = np.random.default_rng(ny)
    flat = g.integers(0, 6, size=(2, 2 * m)).astype(np.int8)
    a, b = hms.split_flat(_t(flat))
    pa, pb = chm.pack_clock_flat(a, m), chm.pack_clock_flat(b, m)
    ja, jb = _jax(pa, m), _jax(pb, m)
    p8 = _planes8(g, (2, hms.words(m)))
    jp8 = _jax(tuple(_t(p) for p in p8), m)
    for color, offs in enumerate(hms.helical_offsets(nx)):
        x, o = (pa, pb) if color == 0 else (pb, pa)
        jx, jo = (ja, jb) if color == 0 else (jb, ja)
        got = chm.packed_helical_phase6_reference(x, o, offs,
                                                  [_t(p) for p in p8], m)
        for want in (jchm.phase_packed_with_bits(jx, jo, jp8, offs=offs,
                                                 m=m, interpret=True),
                     _per_rep(_jax_phase(offs, m), jx, jo, jp8)):
            for g_, w_ in zip(got, _from_jax(want, m)):
                assert torch.equal(_valid(g_, m), _valid(w_, m))
        # the flat oracle on the sites: r from (rho, rt1, rt2), chains
        bits = [hms.unpack_flat(_t(p), m).to(torch.int64).add(1) // 2
                for p in p8]
        tau = bits[1] + 2 * bits[2]
        r = (3 * bits[0] + 4 * tau) % 6
        chains = [c.bool() for c in bits[3:]]
        xs = chm.unpack_clock_flat(*x, m)
        os_ = chm.unpack_clock_flat(*o, m)
        want_flat = chm.flat_phase6_reference(xs, os_, offs, r, chains)
        np.testing.assert_array_equal(
            chm.unpack_clock_flat(*got, m).numpy(), want_flat.numpy())
        for rep in range(2):   # the JAX flat oracle takes one replica
            np.testing.assert_array_equal(
                want_flat[rep].numpy(),
                np.asarray(jchm.flat_phase6_reference(
                    jnp.asarray(xs[rep].numpy()),
                    jnp.asarray(os_[rep].numpy()), offs,
                    jnp.asarray(r[rep].numpy()),
                    [jnp.asarray(c[rep].numpy()) for c in chains])))


@pytest.mark.parametrize("nx,ny", SHAPES)
def test_fused_sums_match_jax_and_the_model(nx, ny):
    """The plain multisweep's per-sweep (2m, 2e, my2) equal the JAX state
    sums (obs_packed6_reference) of each sweep's state and, as
    densities, the model's exact reduction."""
    m = nx * ny // 2
    model = Clock2DHelical(nx, ny, KBT)
    flat = model.init_state("random", rng.base_key(nx), batch=(2,))
    a, b = hms.split_flat(flat)
    wa, wb = chm.pack_clock_flat(a, m), chm.pack_clock_flat(b, m)
    seeds = msb.sweep_seed_pairs(rng.base_key(3), 3)
    ka, kb, obs = chm.multisweep_plain(wa, wb, seeds, beta=model.beta,
                                       nx=nx, m=m)
    np.testing.assert_array_equal(
        obs[:, -1].numpy(),
        np.stack([np.asarray(v) for v in _per_rep(
            jchm.obs_packed6_reference, _jax(ka, m), _jax(kb, m), nx=nx,
            m=m)], -1))
    assert torch.equal(obs[:, -1], chm.obs_packed6_reference(ka, kb, nx, m))
    dens = chm.densities(obs[:, -1], model.nsites)
    final = hms.merge_flat(chm.unpack_clock_flat(*ka, m),
                           chm.unpack_clock_flat(*kb, m))
    want = model.observables(final)
    for k in ("m", "e", "my"):
        np.testing.assert_allclose(dens[k].numpy(), want[k].numpy(),
                                   rtol=0, atol=1e-12)


@pytest.mark.parametrize("nx,ny", SHAPES)
def test_runner_replayed_through_the_jax_oracle(nx, ny):
    """The slice as a whole: the port's helical runner on the CPU,
    replayed phase by phase through the JAX packed oracle on the planes
    the port draws; the final state and every sweep's (m, e, my) agree
    bitwise."""
    m = nx * ny // 2
    model = Clock2DHelical(nx, ny, KBT)
    mcs, batch = 3, 2
    key = rng.sample_key(rng.base_key(4), 2)
    run = sweep.make_helical_runner(model, mcs, batch, "random",
                                    device="cpu")
    assert run.engine == "clock_helical_multispin (bit-sliced packed)"
    series = run(key)
    wa, wb = sweep._init_helical_planes(model, "random", batch, key, "cpu",
                                        pack=chm.pack_clock_flat)
    ja, jb = _jax(wa, m), _jax(wb, m)
    seeds = msb.sweep_seed_pairs(key, mcs)
    offs = hms.helical_offsets(nx)
    digit5 = chm.accept_digit_planes(model.beta)
    nw = hms.words(m)
    for t in range(mcs):
        for color in (0, 1):
            stream = msb.multispin_rng.word_stream(seeds[t, color], batch,
                                                   nw, 1)
            planes = chm.draw_planes(lambda: stream().reshape(batch, nw),
                                     digit5)
            jp = _jax(tuple(msb._i32(p) for p in planes), m)
            if color == 0:
                ja = _per_rep(_jax_phase(offs[0], m), ja, jb, jp)
            else:
                jb = _per_rep(_jax_phase(offs[1], m), jb, ja, jp)
        m2, e2, my2 = (np.asarray(v, np.float64) for v in
                       _per_rep(jchm.obs_packed6_reference, ja, jb, nx=nx,
                                m=m))
        n = model.nsites
        np.testing.assert_array_equal(series["m"][:, t].numpy(),
                                      m2 * (0.5 / n))
        np.testing.assert_array_equal(series["e"][:, t].numpy(),
                                      e2 * (0.5 / n))
        np.testing.assert_array_equal(series["my"][:, t].numpy(),
                                      my2 * (np.sqrt(3.0) / 2.0 / n))
    ka, kb, _ = chm.multisweep(model, wa, wb, key, mcs)
    for g_, w_ in zip(ka + kb, _from_jax(ja, m) + _from_jax(jb, m)):
        assert torch.equal(_valid(g_, m), _valid(w_, m))


def test_gates_match_jax():
    from cuda_fortran_mc_simulation_spin_tpu.models.clock_helical import (
        Clock2DHelical as JaxHelical,
    )
    for nx, ny, q in ((501, 500, 6), (61, 50, 6), (501, 500, 4),
                      (2049, 2048, 6), (4097, 4096, 6), (1001, 1000, 6)):
        assert chm.fits(Clock2DHelical(nx, ny, KBT, q)) == jchm.fits(
            JaxHelical(nx, ny, KBT, q)), (nx, ny, q)


@pytest.mark.parametrize("flags", [
    ["--nx", "61", "--ny", "50", "--q", "4"],
    ["--nx", "61", "--ny", "51"],
])
def test_unserved_helical_clock_raises_b13(flags, tmp_path):
    """The helical clock the packed kernel refuses (q != 6; q = 6 at odd
    nx*ny; past its bound, here 4097x4096, whose route is checked without
    running it on the CPU), refused naming B13 before the masked helical
    kernel was ported, runs on that kernel."""
    out = tmp_path / "x.dat"
    assert main(["--model", "clock", "--mcs", "2", "--samples", "2",
                 "--device", "cpu", "--output", str(out)] + flags) == 0
    assert "# engine: helical_pallas multisweep (masked clock)" in \
        out.read_text().splitlines()
    big = Clock2DHelical(4097, 4096, KBT)
    assert not chm.fits(big)
    assert sweep.make_helical_runner(big, 1, 1, device="cpu").engine == \
        sweep.MASKED_CLOCK


def test_cli_writes_the_dat(tmp_path):
    path = tmp_path / "h.dat"
    assert main(["--model", "clock", "--nx", "61", "--ny", "50", "--kbt",
                 "0.8", "--mcs", "5", "--samples", "4", "--replicas", "2",
                 "--device", "cpu", "--output", str(path)]) == 0
    lines = path.read_text().splitlines()
    assert "# nx, ny: 61 50" in lines
    assert "# engine: clock_helical_multispin (bit-sliced packed)" in lines
    rows = np.array([s.split() for s in lines if not s.startswith("#")],
                    dtype=np.float64)
    assert rows.shape == (5, 10) and np.all(np.isfinite(rows))
    assert rows[:, 2].tolist() == [1, 2, 3, 4, 5]
    assert np.all(rows[:, 3] > 0.5) and np.all(rows[:, 4] < -1.0)
