"""The int8 clock slice as a whole: the generic runners on the clock
(engine/sweep.py make_batch_runner, make_sample_runner,
make_multisweep_runner), the route order of ``_make_runner``, the CLI
against the JAX CLI at shapes and q the packed clock engines refuse, and
``--protocol samples`` on the clock.

Tolerances: the batched and the per-history runner's series, and a series
at two host chunks, are held bitwise (they draw the same words and
measure alike); the multisweep runner's states are those of the batched
one bitwise, its fused sums equal the measure kernel's within 1e-12
(another order of the same float64 terms); curves against the JAX package
(Philox against threefry) within 5 combined standard errors at every t;
headers, row layouts and the N, sample, t columns exactly."""

import jax
import numpy as np
import pytest
import torch

from cuda_fortran_mc_simulation_spin_tpu.core import rng as jrng
from cuda_fortran_mc_simulation_spin_tpu.engine import sweep as jsweep
from cuda_fortran_mc_simulation_spin_tpu.models.clock import (
    Clock2D as JaxClock,
)
from cuda_fortran_mc_simulation_spin_tpu.runs.__main__ import main as jax_main
from cuda_fortran_mc_simulation_spin_tpu_torch.config import RunConfig
from cuda_fortran_mc_simulation_spin_tpu_torch.core import rng
from cuda_fortran_mc_simulation_spin_tpu_torch.engine import protocols, sweep
from cuda_fortran_mc_simulation_spin_tpu_torch.models import (
    Clock2D,
    build_model,
)
from cuda_fortran_mc_simulation_spin_tpu_torch.runs.__main__ import main

KBT = 0.91
KEYS = ("m", "my", "e")


def _equal(x, y):
    return all(torch.equal(x[k], y[k]) for k in KEYS)


@pytest.mark.parametrize("init", ["allup", "random"])
@pytest.mark.parametrize("q", [2, 5])
def test_runners_agree(init, q):
    """The batched, the multisweep and the per-history runner draw the same
    words for the same (sample, t, phase, replica, site): the batched and
    per-history series bitwise (the history is replica 0 of its call
    key), the multisweep's within 1e-12 (its fused sums)."""
    model = Clock2D(nx=14, ny=10, kbt=KBT, q=q)
    key = rng.sample_key(rng.base_key(42), 3)
    batch = sweep.make_batch_runner(model, 9, 3, init, device="cpu")(key)
    multi = sweep.make_multisweep_runner(model, 9, 3, init,
                                         device="cpu")(key)
    one = sweep.make_sample_runner(model, 9, init, device="cpu")(key)
    assert set(batch) == set(KEYS) and batch["m"].shape == (3, 9)
    assert one["m"].shape == (9,)
    assert _equal({k: v[0] for k, v in batch.items()}, one)
    for k in KEYS:
        np.testing.assert_allclose(multi[k].numpy(), batch[k].numpy(),
                                   rtol=0, atol=1e-12)
    assert not torch.equal(batch["m"][0], batch["m"][1])


def test_series_independent_of_the_host_chunk():
    """Sweep t draws under rng.sweep_key(call_key, t) whatever the chunk:
    one sweep a chunk gives the DEFAULT_CHUNK series bitwise, on both the
    batched and the multisweep runner."""
    model = Clock2D(nx=10, ny=6, kbt=KBT, q=7)
    key = rng.sample_key(rng.base_key(7), 0)
    for make in (sweep.make_batch_runner, sweep.make_multisweep_runner):
        full = make(model, 7, 2, "random", device="cpu")(key)
        one = make(model, 7, 2, "random", device="cpu", chunk=1)(key)
        assert _equal(full, one)


def test_relaxation_agrees_with_the_jax_jnp_runner():
    """32x32, q = 5, from all-up: the port's batched runner and the JAX
    package's (``make_batch_runner`` on a jnp model) give per-t means of
    m, my and e within 5 combined standard errors at every t."""
    mcs, batch = 12, 128
    port = sweep.make_batch_runner(Clock2D(nx=32, ny=32, kbt=KBT, q=5), mcs,
                                   batch, device="cpu")(
        rng.sample_key(rng.base_key(1), 0))
    jrun = jsweep.make_batch_runner(
        JaxClock(nx=32, ny=32, kbt=KBT, q=5, backend="jnp"), mcs, batch)
    jser = jax.device_get(jrun(jrng.sample_key(jrng.base_key(1), 0)))
    for k in KEYS:
        p = port[k].numpy()
        j = np.asarray(jser[k], np.float64)
        se = np.sqrt(p.var(axis=0, ddof=1) / batch
                     + j.var(axis=0, ddof=1) / batch)
        z = np.abs(p.mean(axis=0) - j.mean(axis=0)) / np.maximum(se, 1e-12)
        assert np.all(z < 5.0), (k, z)


def _cfg(**kw):
    base = dict(model="clock", nx=1000, ny=1000, kbt=KBT, q=6, mcs=1,
                tot_sample=16, replicas=16)
    base.update(kw)
    return RunConfig(**base)


@pytest.mark.parametrize("kw,batch,engine", [
    (dict(nx=256, ny=256), 16, "clock q=6 bit-sliced packed"),
    (dict(nx=128, ny=128), 16, "int8 multisweep (cooperative)"),
    (dict(q=5), 16, "int8 multisweep (cooperative)"),
    (dict(q=5, nx=2000, ny=2000), 16, "phase engine (batched)"),
    (dict(q=5, nx=6000, ny=6000), 1, "phase engine (single history)"),
    (dict(q=20, nx=130, ny=126), 1, "int8 multisweep (cooperative)"),
])
def test_route_order(kw, batch, engine):
    """The JAX package's order: the packed q = 6, 4, 3 engines where their
    gates take the shape; else the int8 multisweep while batch·nx·ny bytes
    fit its bound; else the per-history runner at one replica, the
    batched one above."""
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


def _cli(q):
    return ["--model", "clock", "--q", str(q), "--nx", "64", "--ny", "64",
            "--kbt", "2.26918531421" if q == 2 else str(KBT), "--mcs", "10"]


@pytest.mark.parametrize("q", [2, 5])
def test_cli_matches_jax_headers_and_columns(q, tmp_path):
    """--device cpu at 64x64 (a shape the packed engines refuse) writes the
    JAX CLI's header lines (the `# engine:` line aside) and its columns;
    m(t) and e(t) within 5 combined standard errors at every t."""
    flags = _cli(q) + ["--samples", "32", "--replicas", "8"]
    path, jpath = tmp_path / "port.dat", tmp_path / "jax.dat"
    assert main(flags + ["--device", "cpu", "--output", str(path)]) == 0
    assert jax_main(flags + ["--output", str(jpath)]) == 0
    head, rows = _split(path)
    jhead, jrows = _split(jpath)
    _same_head(head, jhead)
    assert "# engine: int8 multisweep (cooperative)" in head
    assert rows.shape == jrows.shape == (10, 10)
    np.testing.assert_array_equal(rows[:, :3], jrows[:, :3])
    n, ns = rows[0, 0], rows[0, 1]
    for col, var_col in ((3, 7), (4, 8)):
        se = np.sqrt((rows[:, var_col] + jrows[:, var_col]) / (n * ns))
        z = np.abs(rows[:, col] - jrows[:, col]) / np.maximum(se, 1e-12)
        assert np.all(z < 5.0), (col, z)


@pytest.mark.parametrize("q", [2, 5])
def test_samples_protocol_writes_jax_rows(q, tmp_path):
    """--protocol samples writes the JAX package's sample rows (N, sample,
    t, m, e, m_y) under its headers; per-t means of m, e and m_y over the
    histories within 5 combined standard errors of JAX's."""
    flags = _cli(q) + ["--samples", "12", "--protocol", "samples"]
    path, jpath = tmp_path / "port.dat", tmp_path / "jax.dat"
    assert main(flags + ["--device", "cpu", "--output", str(path)]) == 0
    assert jax_main(flags + ["--output", str(jpath)]) == 0
    head, rows = _split(path)
    jhead, jrows = _split(jpath)
    _same_head(head, jhead)
    assert "# engine: phase engine (single history)" in head
    assert rows.shape == jrows.shape == (120, 6)
    np.testing.assert_array_equal(rows[:, :3], jrows[:, :3])
    assert np.all(np.abs(rows[:, 3]) <= 1.0)
    assert np.all(rows[:, 4] >= -2.0) and np.all(rows[:, 4] <= 2.0)
    p = rows[:, 3:].reshape(12, 10, 3)
    j = jrows[:, 3:].reshape(12, 10, 3)
    se = np.sqrt(p.var(axis=0, ddof=1) / 12 + j.var(axis=0, ddof=1) / 12)
    z = np.abs(p.mean(axis=0) - j.mean(axis=0)) / np.maximum(se, 1e-9)
    assert np.all(z < 5.0), z


def test_samples_protocol_refuses_other_starts_as_jax(tmp_path):
    flags = _cli(5) + ["--samples", "2", "--protocol", "samples",
                       "--init-state", "finite_magne"]
    with pytest.raises(ValueError, match="allup/random") as port:
        main(flags + ["--device", "cpu", "--output",
                      str(tmp_path / "x.dat")])
    with pytest.raises(ValueError, match="allup/random") as jax_err:
        jax_main(flags + ["--output", str(tmp_path / "j.dat")])
    assert str(port.value) == str(jax_err.value)


@pytest.mark.parametrize("flags", [
    ["--nx", "256", "--ny", "256", "--q", "5"],
    ["--nx", "60", "--ny", "72"],
    ["--nx", "256", "--ny", "256", "--q", "8"],
])
def test_formerly_refused_clock_shapes_run(flags, tmp_path):
    """Clock shapes and q the packed engines refuse, refused before the
    int8 clock kernels were ported, now run on the CPU through the plain
    versions of those kernels."""
    out = tmp_path / "x.dat"
    assert main(["--model", "clock", "--mcs", "2", "--samples", "2",
                 "--device", "cpu", "--output", str(out)] + flags) == 0
    head, rows = _split(out)
    assert "# engine: int8 multisweep (cooperative)" in head
    assert rows.shape == (2, 10) and np.all(np.isfinite(rows))
