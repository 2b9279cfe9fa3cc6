"""The int8 periodic Ising slice as a whole: the generic runners
(engine/sweep.py make_batch_runner, make_sample_runner,
make_multisweep_runner), the route order of ``_make_runner``, the CLI
against the JAX CLI at shapes the bit-packed engines refuse, and
``--protocol samples`` on Ising 2-D and 3-D.

Tolerances: the three runners' series, and a series at two host chunks,
are held bitwise (they draw the same words); curves against the JAX
package (Philox against threefry) within 5 combined standard errors at
every t; headers, row layouts and the N, sample, t columns exactly."""

import jax
import numpy as np
import pytest
import torch

from cuda_fortran_mc_simulation_spin_tpu.core import rng as jrng
from cuda_fortran_mc_simulation_spin_tpu.engine import sweep as jsweep
from cuda_fortran_mc_simulation_spin_tpu.models.ising2d import (
    Ising2D as JaxIsing2D,
)
from cuda_fortran_mc_simulation_spin_tpu.runs.__main__ import main as jax_main
from cuda_fortran_mc_simulation_spin_tpu_torch.config import RunConfig
from cuda_fortran_mc_simulation_spin_tpu_torch.core import rng
from cuda_fortran_mc_simulation_spin_tpu_torch.engine import protocols, sweep
from cuda_fortran_mc_simulation_spin_tpu_torch.models import (
    Ising2D,
    Ising3D,
    build_model,
)
from cuda_fortran_mc_simulation_spin_tpu_torch.runs.__main__ import main

KBT = 2.26918531421
KBT_3D = 4.51152


def _equal(x, y):
    return all(torch.equal(x[k], y[k]) for k in ("m", "e"))


@pytest.mark.parametrize("init", ["allup", "random"])
def test_runners_give_the_same_series(init):
    """The batched, the multisweep and the per-history runner draw the same
    words for the same (sample, t, phase, replica, site): equal series,
    bitwise; the history is replica 0 of its call key."""
    model = Ising2D(nx=14, ny=10, kbt=KBT)
    key = rng.sample_key(rng.base_key(42), 3)
    batch = sweep.make_batch_runner(model, 9, 3, init, device="cpu")(key)
    multi = sweep.make_multisweep_runner(model, 9, 3, init,
                                         device="cpu")(key)
    one = sweep.make_sample_runner(model, 9, init, device="cpu")(key)
    assert batch["m"].shape == (3, 9) and one["m"].shape == (9,)
    assert _equal(batch, multi)
    assert _equal({k: v[0] for k, v in batch.items()}, one)
    assert not torch.equal(batch["m"][0], batch["m"][1])


@pytest.mark.parametrize("dims", [2, 3])
def test_series_independent_of_the_host_chunk(dims):
    """Sweep t draws under rng.sweep_key(call_key, t) whatever the chunk:
    one sweep a chunk gives the DEFAULT_CHUNK series bitwise."""
    model = (Ising2D(nx=10, ny=6, kbt=KBT) if dims == 2
             else Ising3D(nx=6, ny=4, nz=6, kbt=KBT_3D))
    key = rng.sample_key(rng.base_key(7), 0)
    makers = [sweep.make_batch_runner]
    if dims == 2:
        makers.append(sweep.make_multisweep_runner)
    for make in makers:
        full = make(model, 7, 2, "random", device="cpu")(key)
        one = make(model, 7, 2, "random", device="cpu", chunk=1)(key)
        assert _equal(full, one)


def test_relaxation_agrees_with_the_jax_jnp_runner():
    """32x32 from all-up at Tc: the port's batched runner and the JAX
    package's (``make_batch_runner`` on a jnp model) give per-t means of
    m and e within 5 combined standard errors at every t."""
    mcs, batch = 20, 256
    port = sweep.make_batch_runner(Ising2D(nx=32, ny=32, kbt=KBT), mcs,
                                   batch, device="cpu")(
        rng.sample_key(rng.base_key(1), 0))
    jrun = jsweep.make_batch_runner(
        JaxIsing2D(nx=32, ny=32, kbt=KBT, backend="jnp"), mcs, batch)
    jser = jax.device_get(jrun(jrng.sample_key(jrng.base_key(1), 0)))
    for k in ("m", "e"):
        p = port[k].numpy()
        j = np.asarray(jser[k], np.float64)
        se = np.sqrt(p.var(axis=0, ddof=1) / batch
                     + j.var(axis=0, ddof=1) / batch)
        z = np.abs(p.mean(axis=0) - j.mean(axis=0)) / np.maximum(se, 1e-12)
        assert np.all(z < 5.0), (k, z)


def _cfg(**kw):
    base = dict(model="ising2d", nx=1000, ny=1000, kbt=KBT, mcs=1,
                tot_sample=16, replicas=16)
    base.update(kw)
    return RunConfig(**base)


@pytest.mark.parametrize("kw,batch,engine", [
    (dict(nx=2048, ny=2048), 16,
     "ising2d_multispin bit-packed (resident multisweep)"),
    (dict(), 16, "int8 multisweep (cooperative)"),
    (dict(), 1, "int8 multisweep (cooperative)"),
    (dict(nx=4000, ny=4000), 8, "phase engine (batched)"),
    (dict(nx=6000, ny=6000), 1, "phase engine (single history)"),
    (dict(model="ising3d", nx=512, ny=512, nz=512, kbt=KBT_3D), 8,
     "ising3d_multispin bit-packed (streaming z-plane phases)"),
    (dict(model="ising3d", nx=500, ny=500, nz=500, kbt=KBT_3D), 2,
     "phase engine (batched)"),
    (dict(model="ising3d", nx=12, ny=10, nz=8, kbt=KBT_3D), 1,
     "phase engine (single history)"),
])
def test_route_order(kw, batch, engine):
    """The JAX package's order: packable shapes on the bit-packed engines;
    else (2-D) the int8 multisweep while batch·nx·ny bytes fit its bound;
    else the per-history runner at one replica, the batched one above."""
    cfg = _cfg(**kw)
    runner = protocols._make_runner(cfg, build_model(cfg), batch, "cpu")
    assert runner.engine == engine


def _split(path):
    lines = path.read_text().splitlines()
    head = [s for s in lines if s.startswith("#")]
    rows = np.array([s.split() for s in lines if not s.startswith("#")],
                    dtype=np.float64)
    return head, rows


def _same_head(head, jhead):
    def drop(h):
        return [s for s in h if not s.startswith("# engine:")]
    assert drop(head) == drop(jhead)


CLI = {
    "ising2d": ["--model", "ising2d", "--nx", "128", "--ny", "128", "--mcs",
                "12", "--samples", "16", "--replicas", "8"],
    "ising3d": ["--model", "ising3d", "--nx", "12", "--ny", "10", "--nz",
                "8", "--kbt", "4.51152", "--mcs", "12", "--samples", "32",
                "--replicas", "8"],
}


@pytest.mark.parametrize("model", sorted(CLI))
def test_cli_matches_jax_headers_and_columns(model, tmp_path):
    """--device cpu at shapes the bit-packed engines refuse writes the JAX
    CLI's header lines (the `# engine:` line aside) and its columns; m(t)
    and e(t) within 5 combined standard errors at every t."""
    path, jpath = tmp_path / "port.dat", tmp_path / "jax.dat"
    assert main(CLI[model] + ["--device", "cpu", "--output", str(path)]) == 0
    assert jax_main(CLI[model] + ["--output", str(jpath)]) == 0
    head, rows = _split(path)
    jhead, jrows = _split(jpath)
    _same_head(head, jhead)
    assert rows.shape == jrows.shape == (12, 10)
    np.testing.assert_array_equal(rows[:, :3], jrows[:, :3])
    n, ns = rows[0, 0], rows[0, 1]
    for col, var_col in ((3, 7), (4, 8)):
        se = np.sqrt((rows[:, var_col] + jrows[:, var_col]) / (n * ns))
        z = np.abs(rows[:, col] - jrows[:, col]) / np.maximum(se, 1e-12)
        assert np.all(z < 5.0), (col, z)


@pytest.mark.parametrize("model", sorted(CLI))
def test_samples_protocol_writes_jax_rows(model, tmp_path):
    """--protocol samples writes the JAX package's sample rows (N, sample,
    t, m, e) under its headers; each row's m and e are densities of a
    +-1 lattice."""
    flags = CLI[model][:-4] + ["--samples", "3", "--protocol", "samples"]
    path, jpath = tmp_path / "port.dat", tmp_path / "jax.dat"
    assert main(flags + ["--device", "cpu", "--output", str(path)]) == 0
    assert jax_main(flags + ["--output", str(jpath)]) == 0
    head, rows = _split(path)
    jhead, jrows = _split(jpath)
    _same_head(head, jhead)
    assert rows.shape == jrows.shape == (36, 5)
    np.testing.assert_array_equal(rows[:, :3], jrows[:, :3])
    n = rows[0, 0]
    assert np.all(np.abs(rows[:, 3]) <= 1.0)
    # m·N is an integer, up to the rounding of the printed density
    np.testing.assert_allclose(rows[:, 3] * n, np.round(rows[:, 3] * n),
                               rtol=0, atol=1e-9)
    dims = 2 if model == "ising2d" else 3
    assert np.all(rows[:, 4] >= -dims) and np.all(rows[:, 4] <= dims)


def test_samples_protocol_refuses_other_starts_as_jax(tmp_path):
    flags = CLI["ising2d"][:-4] + ["--samples", "2", "--protocol", "samples",
                                   "--init-state", "finite_magne"]
    with pytest.raises(ValueError, match="allup/random") as port:
        main(flags + ["--device", "cpu", "--output",
                      str(tmp_path / "x.dat")])
    with pytest.raises(ValueError, match="allup/random") as jax_err:
        jax_main(flags + ["--output", str(tmp_path / "j.dat")])
    assert str(port.value) == str(jax_err.value)


@pytest.mark.parametrize("model", ["ising3d", "clock"])
def test_over_relaxation_outside_xy_raises_value_error(model, tmp_path):
    """Over-relaxation exists only for the XY model (a ValueError, not a
    port gap), on Ising 3-D and clock as on Ising 2-D."""
    flags = (CLI["ising3d"] if model == "ising3d" else
             ["--model", "clock", "--nx", "256", "--ny", "256"])
    with pytest.raises(ValueError, match="XY model only"):
        main(flags + ["--n-over-relax", "1", "--device", "cpu", "--output",
                      str(tmp_path / "x.dat")])
