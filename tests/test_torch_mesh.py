"""The domain-decomposed Ising runs (parallel/mesh.py, parallel/domain.py,
the mesh branch of engine/protocols.py, ``--mesh``) on CPU meshes.

Tolerances: the mesh runner's series are held bitwise against the port's
unsharded runners (every kernel keys its words by global coordinates);
the mesh curve against the JAX package's mesh runner (Philox against
threefry) within 5 combined standard errors at every t; the CLI's headers,
row layout and N, sample, t columns against the JAX CLI's exactly; the
refusals by their messages, the JAX package's where it has one."""

import io

import jax
import numpy as np
import pytest
import torch

from cuda_fortran_mc_simulation_spin_tpu.core import rng as jrng
from cuda_fortran_mc_simulation_spin_tpu.models.ising2d import (
    Ising2D as JaxIsing2D,
)
from cuda_fortran_mc_simulation_spin_tpu.parallel import (
    domain as jdomain,
    mesh as jmesh,
)
from cuda_fortran_mc_simulation_spin_tpu.runs.__main__ import main as jax_main
from cuda_fortran_mc_simulation_spin_tpu_torch import interop
from cuda_fortran_mc_simulation_spin_tpu_torch.config import RunConfig
from cuda_fortran_mc_simulation_spin_tpu_torch.core import rng
from cuda_fortran_mc_simulation_spin_tpu_torch.engine import protocols, sweep
from cuda_fortran_mc_simulation_spin_tpu_torch.models import (
    Clock2D,
    Ising2D,
    Ising2DHelical,
    Ising3D,
    XY2D,
)
from cuda_fortran_mc_simulation_spin_tpu_torch.parallel import (
    domain,
    mesh as mesh_mod,
)
from cuda_fortran_mc_simulation_spin_tpu_torch.runs.__main__ import main

KBT, KBT3 = 2.26918531421, 4.51152
KEY = rng.sample_key(rng.base_key(42), 0)


def _mesh(*shape):
    return mesh_mod.make_mesh(*shape, device_type="cpu")


def _equal(x, y):
    return all(torch.equal(x[k], y[k]) for k in ("m", "e"))


# (model, the unsharded runner of its route, the mesh route, mesh shapes);
# the packed shapes are below the unsharded CLI's packed gate, so the
# packed runners are called directly
CASES = {
    "packed 2-D": (lambda: Ising2D(nx=64, ny=128, kbt=KBT),
                   sweep.make_multispin_runner, "2d",
                   [(1, 1), (1, 4), (2, 2), (1, 2, 2)]),
    # half 22: the x split's second shard starts at column 11, inside a
    # unit of four columns
    "int8 2-D": (lambda: Ising2D(nx=44, ny=24, kbt=KBT),
                 sweep.make_batch_runner, None,
                 [(1, 1), (1, 4), (2, 2), (1, 2, 2)]),
    "packed 3-D": (lambda: Ising3D(nx=16, ny=32, nz=8, kbt=KBT3),
                   sweep.make_multispin3d_runner, "3d",
                   [(1, 1), (1, 4), (2, 2)]),
    "int8 3-D": (lambda: Ising3D(nx=12, ny=10, nz=8, kbt=KBT3),
                 sweep.make_batch_runner, None, [(1, 1), (1, 4), (2, 2)]),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("init", ["allup", "random"])
def test_mesh_runner_equals_unsharded_bitwise(case, init):
    make_model, unsharded, route, shapes = CASES[case]
    model = make_model()
    mcs = 5 if route else 7
    want = unsharded(model, mcs, 4, init, device="cpu")(KEY)
    for shape in shapes:
        run = domain.make_sharded_sample_runner(model, _mesh(*shape), mcs,
                                                4, init)
        assert run.packed == route
        got = run(KEY)
        assert got["m"].shape == (4, mcs)
        assert _equal(got, want), shape


def test_mesh_step_measures_the_gathered_state():
    """make_sharded_step's fused densities equal the model's exact sums
    of the gathered state, and a shard draws what the unsharded phase
    draws, on a (2, 2, 2) mesh."""
    from cuda_fortran_mc_simulation_spin_tpu_torch.ops import ising2d_pallas
    from cuda_fortran_mc_simulation_spin_tpu_torch.models.base import (
        CheckerboardState,
    )
    model = Ising2D(nx=24, ny=16, kbt=KBT)
    msh = _mesh(2, 2, 2)
    st = domain.replicated_init(model, msh, 4, "random", rng.base_key(1))
    a0, b0 = domain.gather_state(st, msh)
    step = domain.make_sharded_step(model, msh)
    st, obs = step(st, rng.base_key(2))
    a, b = domain.gather_state(st, msh)
    state = CheckerboardState(a, b)
    n = model.nsites
    assert torch.equal(obs["m"], model.magne_sum(state).double() / n)
    assert torch.equal(obs["e"], model.energy_sum(state).double() / n)
    ref = ising2d_pallas.sweep(model, CheckerboardState(a0, b0),
                               rng.base_key(2))
    assert torch.equal(ref.a, a) and torch.equal(ref.b, b)


def test_mesh_curve_agrees_with_the_jax_mesh_runner():
    """16x16 from all-up at Tc on a (2, 4) mesh: the port's mesh runner
    and JAX's ``make_sharded_sample_runner`` give per-t means of m and e
    within 5 combined standard errors at every t."""
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device CPU mesh (tests/conftest.py)")
    mcs, batch = 20, 128
    port = domain.make_sharded_sample_runner(
        Ising2D(nx=16, ny=16, kbt=KBT), _mesh(2, 4), mcs, batch)(KEY)
    jrun = jdomain.make_sharded_sample_runner(
        JaxIsing2D(nx=16, ny=16, kbt=KBT, backend="jnp"),
        jmesh.make_mesh(2, 4), mcs, batch)
    jser = jax.device_get(jrun(jrng.sample_key(jrng.base_key(42), 0)))
    for k in ("m", "e"):
        p = port[k].numpy()
        j = np.asarray(jser[k], np.float64)
        se = np.sqrt(p.var(axis=0, ddof=1) / batch
                     + j.var(axis=0, ddof=1) / batch)
        z = np.abs(p.mean(axis=0) - j.mean(axis=0)) / np.maximum(se, 1e-12)
        assert np.all(z < 5.0), (k, z)


def _split(path):
    lines = path.read_text().splitlines()
    head = [s for s in lines if s.startswith("#")]
    rows = np.array([s.split() for s in lines if not s.startswith("#")],
                    dtype=np.float64)
    return head, rows


CLI = {
    "ising2d": ["--model", "ising2d", "--nx", "32", "--ny", "32", "--mcs",
                "8", "--samples", "16", "--replicas", "8", "--mesh",
                "2,2,2"],
    "ising3d": ["--model", "ising3d", "--nx", "8", "--ny", "8", "--nz",
                "8", "--kbt", "4.51152", "--mcs", "8", "--samples", "16",
                "--replicas", "8", "--mesh", "2,4"],
}


@pytest.mark.parametrize("model", sorted(CLI))
def test_cli_mesh_matches_jax_cli(model, tmp_path):
    """--mesh with --device cpu writes the JAX CLI's headers, its engine
    stamp included, and its row layout; N, sample and t exactly; the
    series equal the port's unsharded CLI run's."""
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device CPU mesh (tests/conftest.py)")
    path, jpath = tmp_path / "port.dat", tmp_path / "jax.dat"
    upath = tmp_path / "unsharded.dat"
    assert main(CLI[model] + ["--device", "cpu", "--output", str(path)]) == 0
    assert jax_main(CLI[model] + ["--output", str(jpath)]) == 0
    assert main(CLI[model][:-2] + ["--device", "cpu", "--output",
                                   str(upath)]) == 0
    head, rows = _split(path)
    jhead, jrows = _split(jpath)
    assert head == jhead
    assert rows.shape == jrows.shape == (8, 10)
    np.testing.assert_array_equal(rows[:, :3], jrows[:, :3])
    np.testing.assert_array_equal(rows, _split(upath)[1])


def test_refusals():
    """JAX's ValueErrors for the shapes it cannot shard, by its messages,
    for the Ising, clock and XY models (lead % (2·y), half % x, replicas
    % dp); a clock and an XY mesh run, refused before this slice, now go
    through."""
    msh = _mesh(1, 2)
    for model in (Clock2D(nx=16, ny=16, kbt=0.91, q=6),
                  XY2D(nx=16, ny=16, kbt=0.89)):
        out = domain.make_sharded_sample_runner(model, msh, 2, 2)(KEY)
        assert out["m"].shape == (2, 2)
    for name in ("clock", "xy2d"):
        cfg = RunConfig(model=name, nx=16, ny=16, mcs=2, tot_sample=2,
                        replicas=2, mesh_y=2)
        protocols.run_relaxation(cfg, out=io.StringIO(), err=io.StringIO(),
                                 device="cpu")
    # JAX's messages
    from cuda_fortran_mc_simulation_spin_tpu.models.clock import (
        Clock2D as JaxClock2D,
    )
    from cuda_fortran_mc_simulation_spin_tpu.models.xy2d import (
        XY2D as JaxXY2D,
    )
    pairs = ((JaxIsing2D(nx=16, ny=12, kbt=KBT, backend="jnp"),
              Ising2D(nx=16, ny=12, kbt=KBT)),
             (JaxClock2D(nx=12, ny=12, kbt=0.91, q=5, backend="jnp"),
              Clock2D(nx=12, ny=12, kbt=0.91, q=5)),
             (JaxXY2D(nx=12, ny=12, kbt=0.89, backend="jnp"),
              XY2D(nx=12, ny=12, kbt=0.89)))
    for jmodel, model in pairs:
        x = 3 if isinstance(model, Ising2D) else 4     # half 8 or 6
        for shape, replicas in (((1, 4), 4), ((3, 1), 4), ((1, 1, x), x)):
            with pytest.raises(ValueError) as port:
                domain.make_sharded_sample_runner(model, _mesh(*shape), 2,
                                                  replicas)
            if np.prod(shape) <= len(jax.devices()):
                with pytest.raises(ValueError) as want:
                    jdomain.make_sharded_sample_runner(
                        jmodel, jmesh.make_mesh(*shape), 2, replicas)
                assert str(port.value) == str(want.value)
    with pytest.raises(ValueError, match="decomposes over z only"):
        domain.make_sharded_sample_runner(
            Ising3D(nx=8, ny=8, nz=8, kbt=KBT3), _mesh(1, 2, 2), 2, 2)
    for model in (pairs[0][1], pairs[1][1]):
        with pytest.raises(ValueError, match="an XY-model feature"):
            domain.make_sharded_sample_runner(model, _mesh(1, 2), 2, 2,
                                              n_over_relax=1)
    with pytest.raises(ValueError) as port:
        mesh_mod.make_mesh(1, 4, devices=[torch.device("cpu")] * 3)
    with pytest.raises(ValueError) as want:
        jmesh.make_mesh(1, 4, devices=jax.devices()[:3])
    assert str(port.value) == str(want.value)
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="needs 2 devices, have 0"):
            mesh_mod.make_mesh(1, 2)


def test_helical_models_on_a_mesh_fail_as_in_jax(tmp_path):
    """The JAX package's mesh path fails on a helical model (it has no
    colour planes to shard: AttributeError); the port refuses it with a
    ValueError before it writes anything."""
    if len(jax.devices()) < 2:
        pytest.skip("needs the 8-device CPU mesh (tests/conftest.py)")
    flags = ["--model", "ising2d", "--nx", "17", "--ny", "16", "--mcs",
             "2", "--samples", "2", "--replicas", "2", "--mesh", "1,2"]
    with pytest.raises(AttributeError, match="color_shape"):
        jax_main(flags + ["--output", str(tmp_path / "j.dat")])
    with pytest.raises(ValueError, match="no domain decomposition"):
        main(flags + ["--device", "cpu", "--output",
                      str(tmp_path / "p.dat")])
    assert not (tmp_path / "p.dat").exists()
    with pytest.raises(ValueError, match="no domain decomposition"):
        domain.make_sharded_sample_runner(Ising2DHelical(17, 16, KBT),
                                          _mesh(1, 2), 2, 2)


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("shape", [(2, 2, 2), (1, 4)])
def test_interop_round_trip_matches_jax_sharding(packed, shape):
    """A JAX global state into the port's shards and back, unchanged; each
    shard is the block JAX's mesh places on the same mesh position."""
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device CPU mesh (tests/conftest.py)")
    jmodel = JaxIsing2D(nx=128, ny=128, kbt=KBT, backend="jnp")
    jm = jmesh.make_mesh(*shape)
    st = jdomain.replicated_init(jmodel, jm, 4, "random", jrng.base_key(3))
    a, b = (np.asarray(v) for v in st)
    msh = _mesh(*shape)
    if packed:
        from cuda_fortran_mc_simulation_spin_tpu.ops import ising2d_multispin
        a, b = (np.asarray(ising2d_multispin.pack_color(v)) for v in (a, b))
    shards = interop.shards_from_numpy(a, b, msh)
    back = interop.shards_to_numpy(shards, msh)
    np.testing.assert_array_equal(back[0], a)
    np.testing.assert_array_equal(back[1], b)
    if packed:
        return
    devs = np.asarray(jm.devices).reshape(msh.devices.shape)
    for shard in st.a.addressable_shards:
        c = tuple(int(i) for i in np.argwhere(devs == shard.device)[0])
        np.testing.assert_array_equal(shards.a[c].numpy(),
                                      np.asarray(shard.data))
