"""The domain-decomposed clock and XY runs (parallel/domain.py, the mesh
branches of engine/protocols.py, ``--mesh``) on CPU meshes.

Tolerances: the states after a mesh run are held bitwise against the
port's unsharded engines (every kernel keys its words by global
coordinates); so are the packed clock's densities (exact integer sums).
The int8 clock's and XY's densities are float64 sums taken in another
order (per shard, then the psum), so they are held within 1e-12 of the
unsharded run's at densities of magnitude <= 2: one changed site would
move a density by at least ~1/N, far more.  The mesh curves against the
JAX package's mesh runners (Philox against threefry) within 5 combined
standard errors at every t; the CLI's headers, row layout and N, sample,
t columns against the JAX CLI's exactly."""

import dataclasses
import io

import jax
import numpy as np
import pytest
import torch

from cuda_fortran_mc_simulation_spin_tpu.core import rng as jrng
from cuda_fortran_mc_simulation_spin_tpu.engine import protocols as jprotocols
from cuda_fortran_mc_simulation_spin_tpu.config import RunConfig as JaxConfig
from cuda_fortran_mc_simulation_spin_tpu.models.clock import (
    Clock2D as JaxClock2D,
)
from cuda_fortran_mc_simulation_spin_tpu.models.xy2d import XY2D as JaxXY2D
from cuda_fortran_mc_simulation_spin_tpu.parallel import (
    domain as jdomain,
    mesh as jmesh,
)
from cuda_fortran_mc_simulation_spin_tpu.runs.__main__ import main as jax_main
from cuda_fortran_mc_simulation_spin_tpu_torch import interop
from cuda_fortran_mc_simulation_spin_tpu_torch.config import RunConfig
from cuda_fortran_mc_simulation_spin_tpu_torch.core import rng
from cuda_fortran_mc_simulation_spin_tpu_torch.engine import protocols, sweep
from cuda_fortran_mc_simulation_spin_tpu_torch.models import Clock2D, XY2D
from cuda_fortran_mc_simulation_spin_tpu_torch.models.base import (
    CheckerboardState,
)
from cuda_fortran_mc_simulation_spin_tpu_torch.models.xy2d import XYState
from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
    clock_pallas,
    clock_planes,
    multispin_rng,
    xy2d_measure_pallas,
    xy2d_pallas,
)
from cuda_fortran_mc_simulation_spin_tpu_torch.parallel import (
    domain,
    mesh as mesh_mod,
)
from cuda_fortran_mc_simulation_spin_tpu_torch.runs.__main__ import main

KEY = rng.sample_key(rng.base_key(42), 0)
SHAPES = [(1, 1), (1, 4), (2, 2), (1, 2, 2)]
BOUND = 1e-12


def _mesh(*shape):
    return mesh_mod.make_mesh(*shape, device_type="cpu")


def _close(got: dict, want: dict, exact: bool) -> None:
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape
        if exact:
            assert torch.equal(got[k], want[k]), k
        else:
            assert float((got[k] - want[k]).abs().max()) <= BOUND, k


# (model, route, unsharded sweep(model, state, seeds) -> (state, obs));
# half 22 of the int8 clock puts the x split's second shard at column 11,
# inside a unit of two columns
def _packed_sweep(spec):
    def one(model, st, seeds):
        wa, wb, obs = clock_planes.sweep_measure_seeded(spec, model, *st,
                                                        seeds)
        return (wa, wb), obs
    return one


def _int8_sweep(model, st, seeds):
    st = clock_pallas.sweep_seeded(model, st, seeds)
    return st, None


def _xy_sweep(model, st, seeds, do_or=False, n_or=0):
    if do_or:
        st = xy2d_pallas.sweep(model, st, seeds)
        for _ in range(n_or - 1):
            st = xy2d_pallas.or_sweep(model, st)
        return xy2d_pallas.or_sweep_measured(model, st)
    return xy2d_pallas.sweep_measured(model, st, seeds)


CLOCK_CASES = {
    "packed q=6": (lambda: Clock2D(nx=64, ny=128, kbt=0.8, q=6), "clock6"),
    "packed q=4": (lambda: Clock2D(nx=64, ny=128, kbt=0.8, q=4), "clock4"),
    "packed q=3": (lambda: Clock2D(nx=64, ny=128, kbt=0.8, q=3), "clock3"),
    "int8 q=5": (lambda: Clock2D(nx=44, ny=24, kbt=0.91, q=5), None),
}


@pytest.mark.parametrize("case", sorted(CLOCK_CASES))
@pytest.mark.parametrize("init", ["allup", "random"])
def test_clock_mesh_states_equal_unsharded_bitwise(case, init):
    """Three mesh sweeps of every mesh shape leave the gathered state of
    the unsharded engine bit for bit; the packed densities are equal,
    the int8 ones within the bound of the exact float64 sums."""
    make, route = CLOCK_CASES[case]
    model = make()
    seeds = multispin_rng.sweep_phase_keys(KEY, 3)
    base = sweep._init_state(model, init, 4, KEY, "cpu")
    if route:
        spec = domain.CLOCK_PACKED[route].SPEC
        ref, one = (spec.pack_color(base.a), spec.pack_color(base.b)), \
            _packed_sweep(spec)
    else:
        ref, one = CheckerboardState(base.a.clone(), base.b.clone()), \
            _int8_sweep
    want_obs = []
    for j in range(3):
        ref, obs = one(model, ref, seeds[j])
        want_obs.append(obs)
    if not route:
        from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
            clock_measure_pallas,
        )
        want_obs[-1] = clock_measure_pallas.measure(model, ref)
    for shape in SHAPES:
        msh = _mesh(*shape)
        packed = domain._shard_packed_mode(model, msh, 4)
        assert packed == route
        state = domain._init_blocks(model, msh, 4, init, KEY, packed)
        step = domain._make_local_step(model, msh, packed=packed)
        for j in range(3):
            state, obs = step(state, seeds[j])
        a, b = domain.gather_state(state, msh)
        for got, want in zip((a, b), (ref[0], ref[1])):
            if route:
                assert all(torch.equal(g, w) for g, w in zip(got, want))
            else:
                assert torch.equal(got, want), shape
        _close(obs, want_obs[-1], exact=bool(route))


@pytest.mark.parametrize("n_or", [0, 1, 2])
@pytest.mark.parametrize("init", ["allup", "random"])
def test_xy_mesh_states_equal_unsharded_bitwise(n_or, init):
    """Mesh steps (Metropolis, then n_or OR sweeps on steps 1-2) leave the
    gathered XY state of the unsharded phases bit for bit; the densities
    within the bound."""
    model = XY2D(nx=44, ny=16, kbt=0.89)
    seeds = multispin_rng.sweep_phase_keys(KEY, 3)
    ref = sweep._init_state(model, init, 4, KEY, "cpu")
    ref = XYState(*(p.clone() for p in ref))
    want = None
    for j in range(3):
        ref, want = _xy_sweep(model, ref, seeds[j], j < 2 and n_or > 0,
                              n_or)
    for shape in SHAPES:
        msh = _mesh(*shape)
        state = domain._init_blocks(model, msh, 4, init, KEY, None)
        step = domain._make_local_step(model, msh, n_over_relax=n_or)
        for j in range(3):
            state, obs = step(state, seeds[j], j < 2)
        got = domain.gather_state(state, msh)
        assert all(torch.equal(g, w) for g, w in zip(got, ref)), shape
        _close(obs, want, exact=False)


def test_xy_measure_and_rotation_on_shards():
    """xy_measure (per-shard sums with halos) equals the unsharded
    measure within the bound, and the fix1mcs rotation of the shards
    rotates the gathered state and snapshot as the model's does."""
    model = XY2D(nx=44, ny=16, kbt=0.89)
    keys = rng.fold_in(rng.base_key(3), torch.arange(4, dtype=torch.int64))
    st = model.random_states(keys)
    snap = model.random_states(keys + 1)
    want = xy2d_measure_pallas.measure(model, st, snap)
    theta = -model.magne_angle(st)
    rot = model.rotate(st, theta), model.rotate(snap, theta)
    for shape in SHAPES:
        msh = _mesh(*shape)
        sst, ssnap = domain.shard_xy(st, msh), domain.shard_xy(snap, msh)
        _close(domain.xy_measure(model, sst, ssnap, msh), want, exact=False)
        domain._xy_rotate(model, sst, ssnap, msh)
        for got, ref in zip((sst, ssnap), rot):
            assert all(torch.equal(g, w) for g, w in
                       zip(domain.gather_state(got, msh), ref)), shape


RUNNERS = {
    "clock6": (lambda: Clock2D(nx=256, ny=128, kbt=0.8, q=6),
               sweep.make_clock_multispin_runner, {}, True),
    "clock5": (lambda: Clock2D(nx=44, ny=24, kbt=0.91, q=5),
               sweep.make_batch_runner, {}, False),
    "xy": (lambda: XY2D(nx=44, ny=16, kbt=0.89), sweep.make_xy_runner, {},
           False),
    "xy or": (lambda: XY2D(nx=44, ny=16, kbt=0.89), sweep.make_xy_runner,
              {"n_over_relax": 1, "mcs_over_relax": 3}, False),
}


@pytest.mark.parametrize("case", sorted(RUNNERS))
def test_mesh_runner_series_match_unsharded(case):
    make, unsharded, kw, exact = RUNNERS[case]
    model = make()
    want = unsharded(model, 5, 4, "random", device="cpu", **kw)(KEY)
    # the packed clock's unsharded gate needs half % 128: two shapes
    for shape in SHAPES if not exact else [(1, 4), (1, 2, 2)]:
        got = domain.make_sharded_sample_runner(model, _mesh(*shape), 5, 4,
                                                "random", **kw)(KEY)
        _close(got, want, exact)


@pytest.mark.parametrize("prep,n_or", [("rotate_first", 0),
                                       ("fix1mcs", 0), ("fix1mcs", 1),
                                       ("finite_magne", 0)])
def test_xy_disorder_mesh_runner_matches_unsharded(prep, n_or):
    """The disorder runner on every mesh shape against the unsharded one
    (whose route at this size is the resident multisweep, or the
    streamed phases with over-relaxation), corr included."""
    model = XY2D(nx=44, ny=16, kbt=0.89)
    kw = dict(n_over_relax=n_or, mcs_over_relax=3,
              track_correlation=prep == "fix1mcs")
    want = sweep.make_xy_disorder_runner(model, 5, 4, prep, device="cpu",
                                         **kw)(KEY)
    shapes = SHAPES if prep != "finite_magne" else [(2, 2), (1, 2, 2)]
    for shape in shapes:
        got = domain.make_sharded_xy_disorder_runner(
            model, _mesh(*shape), 5, 4, prep, **kw)(KEY)
        _close(got, want, exact=False)


def _z_check(port: dict, jser: dict, keys, batch: int) -> None:
    for k, jk in keys:
        p = port[k].numpy()
        j = np.asarray(jser[jk], np.float64)
        se = np.sqrt(p.var(axis=0, ddof=1) / batch
                     + j.var(axis=0, ddof=1) / batch)
        z = np.abs(p.mean(axis=0) - j.mean(axis=0)) / np.maximum(se, 1e-12)
        assert np.all(z < 5.0), (k, z)


@pytest.mark.parametrize("model", ["clock", "xy or"])
def test_mesh_curve_agrees_with_the_jax_mesh_runner(model):
    """16x16 from all-up on a (2, 4) mesh: the port's mesh runner and
    JAX's ``make_sharded_sample_runner`` give per-t means within 5
    combined standard errors at every t."""
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device CPU mesh (tests/conftest.py)")
    mcs, batch = 12, 64
    kw = {"n_over_relax": 1} if model == "xy or" else {}
    if model == "clock":
        port_model = Clock2D(nx=16, ny=16, kbt=0.91, q=6)
        jmodel = JaxClock2D(nx=16, ny=16, kbt=0.91, q=6, backend="jnp")
        keys = (("m", "m"), ("my", "my"), ("e", "e"))
    else:
        port_model = XY2D(nx=16, ny=16, kbt=0.89)
        jmodel = JaxXY2D(nx=16, ny=16, kbt=0.89, backend="jnp")
        keys = (("m", "m"), ("my", "my"), ("e", "e"))
    port = domain.make_sharded_sample_runner(port_model, _mesh(2, 4), mcs,
                                             batch, **kw)(KEY)
    jrun = jdomain.make_sharded_sample_runner(jmodel, jmesh.make_mesh(2, 4),
                                              mcs, batch, **kw)
    jser = jax.device_get(jrun(jrng.sample_key(jrng.base_key(42), 0)))
    _z_check(port, jser, keys, batch)


def test_disorder_mesh_curve_agrees_with_the_jax_mesh_runner():
    """fix1mcs at 16x16 on a (2, 4) mesh: the port's sharded disorder
    runner and JAX's ``_xy_disorder_mesh_runner`` give per-t means of mx,
    my, e and A within 5 combined standard errors at every t."""
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device CPU mesh (tests/conftest.py)")
    mcs, batch = 8, 64
    port = domain.make_sharded_xy_disorder_runner(
        XY2D(nx=16, ny=16, kbt=0.89), _mesh(2, 4), mcs, batch,
        "fix1mcs")(KEY)
    cfg = JaxConfig(model="xy2d", nx=16, ny=16, kbt=0.89, mcs=mcs,
                    tot_sample=batch, replicas=batch, mesh_dp=2, mesh_y=4,
                    rotate_after_first_mcs=True)
    jmodel = JaxXY2D(nx=16, ny=16, kbt=0.89, backend="jnp")
    jrun = jprotocols._xy_disorder_mesh_runner(jmodel, cfg, "fix1mcs", batch)
    jser = jax.device_get(jrun(jrng.sample_key(jrng.base_key(42), 0)))
    _z_check(port, jser, [(k, k) for k in ("mx", "my", "e", "A")], batch)


def _split(path):
    lines = path.read_text().splitlines()
    head = [s for s in lines if s.startswith("#")]
    rows = np.array([s.split() for s in lines if not s.startswith("#")],
                    dtype=np.float64)
    return head, rows


BASE = ["--mcs", "6", "--samples", "8", "--replicas", "8"]
CLI = {
    "clock packed": ["--model", "clock", "--q", "6", "--nx", "256", "--ny",
                     "256", "--kbt", "0.8", "--mesh", "2,2"],
    "clock int8": ["--model", "clock", "--q", "5", "--nx", "44", "--ny",
                   "24", "--kbt", "0.91", "--mesh", "1,2,2"],
    "xy2d": ["--model", "xy2d", "--nx", "44", "--ny", "16", "--kbt", "0.89",
             "--mesh", "2,2,2"],
    "xy2d or": ["--model", "xy2d", "--nx", "44", "--ny", "16", "--kbt",
                "0.89", "--n-over-relax", "1", "--mesh", "1,2,2"],
    "from_disorder fix1mcs": ["--model", "xy2d", "--protocol",
                              "from_disorder", "--fix1mcs", "--nx", "32",
                              "--ny", "16", "--kbt", "0.89", "--mesh",
                              "2,2,2"],
    "finite_magne": ["--model", "xy2d", "--protocol", "finite_magne",
                     "--nx", "32", "--ny", "16", "--kbt", "0.89",
                     "--init-magne", "0.05", "--mesh", "2,4"],
}


@pytest.mark.parametrize("case", sorted(CLI))
def test_cli_mesh_matches_jax_cli(case, tmp_path):
    """--mesh with --device cpu writes the JAX CLI's headers, its engine
    stamp included, and its row layout; N, sample and t exactly; the rows
    equal the port's unsharded CLI run's (bitwise for the packed clock,
    else within a relative 1e-10: moments of densities held to 1e-12)."""
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device CPU mesh (tests/conftest.py)")
    flags = CLI[case] + BASE
    path, jpath = tmp_path / "port.dat", tmp_path / "jax.dat"
    upath = tmp_path / "unsharded.dat"
    assert main(flags + ["--device", "cpu", "--output", str(path)]) == 0
    assert jax_main(flags + ["--output", str(jpath)]) == 0
    mesh_at = flags.index("--mesh")
    assert main(flags[:mesh_at] + flags[mesh_at + 2:]
                + ["--device", "cpu", "--output", str(upath)]) == 0
    head, rows = _split(path)
    jhead, jrows = _split(jpath)
    assert head == jhead
    assert rows.shape == jrows.shape and rows.shape[0] == 6
    np.testing.assert_array_equal(rows[:, :3], jrows[:, :3])
    urows = _split(upath)[1]
    if case == "clock packed":
        np.testing.assert_array_equal(rows, urows)
    else:
        np.testing.assert_allclose(rows, urows, rtol=1e-10, atol=1e-14)


def test_samples_ignore_the_mesh_as_in_jax(tmp_path):
    """--protocol samples on XY with --mesh runs its histories unsharded,
    as the JAX package does: the same rows as without the mesh."""
    flags = ["--model", "xy2d", "--protocol", "samples", "--nx", "32",
             "--ny", "16", "--kbt", "0.89", "--mcs", "4", "--samples", "2",
             "--init-state", "random", "--device", "cpu"]
    path, upath = tmp_path / "m.dat", tmp_path / "u.dat"
    assert main(flags + ["--mesh", "1,2", "--output", str(path)]) == 0
    assert main(flags + ["--output", str(upath)]) == 0
    assert path.read_text() == upath.read_text()


def test_routes_and_gates():
    """The packed clock mesh route under JAX's semantic terms and its
    SPINLAT_CLOCK_PACKED=0 switch (which also sends the unsharded clock to
    the int8 kernels); XY and the int8 clock take none."""
    clock = Clock2D(nx=256, ny=128, kbt=0.8, q=6)
    assert domain._shard_packed_mode(clock, _mesh(1, 4), 4) == "clock6"
    assert domain._shard_packed_mode(clock, _mesh(1, 8), 4) is None
    assert domain._shard_packed_mode(clock, _mesh(3, 1), 4) is None
    assert domain._shard_packed_mode(Clock2D(nx=256, ny=128, kbt=0.8, q=5),
                                     _mesh(1, 4), 4) is None
    assert domain._shard_packed_mode(XY2D(nx=16, ny=16, kbt=0.89),
                                     _mesh(1, 2), 2) is None
    assert sweep.clock_route(clock) is not None
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SPINLAT_CLOCK_PACKED", "0")
        assert domain._shard_packed_mode(clock, _mesh(1, 4), 4) is None
        assert sweep.clock_route(clock) is None
    cfg = dataclasses.replace(RunConfig(model="clock", nx=16, ny=16, mcs=2,
                                        tot_sample=2, replicas=2), mesh_y=2)
    out = io.StringIO()
    protocols.run_relaxation(cfg, out=out, err=io.StringIO(), device="cpu")
    assert "# engine: domain-sharded mesh (1,2,1)" in out.getvalue()


def test_interop_xy_and_clock_plane_shards():
    """A JAX global XY state and packed clock planes into the port's shards
    and back, unchanged."""
    msh = _mesh(2, 2, 2)
    g = np.random.default_rng(4)
    planes = [g.random((4, 16, 8), dtype=np.float32) for _ in range(4)]
    st = interop.xy_shards_from_numpy(*planes, msh)
    back = interop.xy_shards_to_numpy(st, msh)
    for a, b in zip(back, planes):
        np.testing.assert_array_equal(a, b)
    words = [g.integers(-2 ** 31, 2 ** 31, (4, 4, 8), dtype=np.int64)
             .astype(np.int32) for _ in range(6)]
    sh = interop.clock_shards_from_numpy(words[:3], words[3:], msh)
    a, b = interop.clock_shards_to_numpy(sh, msh)
    for x, y in zip((*a, *b), words):
        np.testing.assert_array_equal(x, y)
