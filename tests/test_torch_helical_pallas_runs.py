"""The masked helical slice as a whole: the route order and the JAX
package's switches, the port's CLI (--device cpu, the kernels' plain
versions) against the JAX CLI on the same flags for every helical 2-D
model at even and odd N, and --protocol samples on every helical model.

The two packages draw different random streams (Philox against threefry)
and the JAX CLI runs its jnp masked engine on the CPU, so the curves are
held statistically: m(t) and e(t) within 5 combined standard errors at
every t; the .dat layout and the N, Nsample, t columns exactly."""

import numpy as np
import pytest

from cuda_fortran_mc_simulation_spin_tpu.runs.__main__ import main as jax_main
from cuda_fortran_mc_simulation_spin_tpu_torch.engine import sweep
from cuda_fortran_mc_simulation_spin_tpu_torch.models import (
    Clock2DHelical,
    Ising2DHelical,
    XY2DHelical,
)
from cuda_fortran_mc_simulation_spin_tpu_torch.runs.__main__ import main

RUN = ["--mcs", "20", "--samples", "32", "--replicas", "4"]


def _split(path):
    lines = path.read_text().splitlines()
    head = [s for s in lines if s.startswith("#")]
    rows = np.array([s.split() for s in lines if not s.startswith("#")],
                    dtype=np.float64)
    return head, rows


def _no_engine(head):
    return [h for h in head if not h.startswith("# engine:")]


@pytest.mark.parametrize("switch,model,masked_tag", [
    ("SPINLAT_HELICAL_PACKED", Ising2DHelical(33, 32, 2.27),
     sweep.MASKED_ISING),
    ("SPINLAT_CLOCK_HELICAL_PACKED", Clock2DHelical(33, 32, 0.8, 6),
     sweep.MASKED_CLOCK),
    ("SPINLAT_XY_DENSE", XY2DHelical(33, 32, 0.89), sweep.MASKED_XY),
])
def test_route_order_and_switches(switch, model, masked_tag, monkeypatch):
    """The JAX package's order: the packed or dense engine where its gate
    takes the shape, the masked kernels where it does not (odd N here) or
    where the JAX switch is 0."""
    assert not sweep.helical_masked(model)
    assert sweep.make_helical_runner(model, 1, 1, device="cpu").engine \
        != masked_tag
    monkeypatch.setenv(switch, "0")
    assert sweep.helical_masked(model)
    assert sweep.make_helical_runner(model, 1, 1, device="cpu").engine \
        == masked_tag
    monkeypatch.delenv(switch)
    odd = type(model)(**{**model.__dict__, "ny": 31})
    assert sweep.helical_masked(odd)
    assert sweep.make_helical_runner(odd, 1, 1, device="cpu").engine == \
        masked_tag


@pytest.mark.parametrize("flags,tag", [
    (["--model", "ising2d", "--nx", "33", "--ny", "31"], sweep.MASKED_ISING),
    (["--model", "clock", "--q", "5", "--nx", "33", "--ny", "32", "--kbt",
      "0.8"], sweep.MASKED_CLOCK),
    (["--model", "clock", "--q", "6", "--nx", "33", "--ny", "31", "--kbt",
      "0.8"], sweep.MASKED_CLOCK),
    (["--model", "xy2d", "--nx", "33", "--ny", "31", "--kbt", "0.89"],
     sweep.MASKED_XY),
    (["--model", "xy2d", "--nx", "33", "--ny", "31", "--kbt", "0.89",
      "--n-over-relax", "1"], sweep.MASKED_XY),
])
def test_cli_matches_jax(flags, tag, tmp_path):
    """The port's CLI on the masked kernels' plain versions against the
    JAX CLI: the same headers (but the engine) and columns, the same N,
    Nsample and t, m and e within 5 combined standard errors at every t."""
    port, jax_out = tmp_path / "port.dat", tmp_path / "jax.dat"
    assert main(flags + RUN + ["--device", "cpu", "--output",
                               str(port)]) == 0
    assert jax_main(flags + RUN + ["--output", str(jax_out)]) == 0
    head, rows = _split(port)
    jhead, jrows = _split(jax_out)
    assert f"# engine: {tag}" in head
    assert _no_engine(head) == _no_engine(jhead)
    assert rows.shape == jrows.shape == (20, 10)
    np.testing.assert_array_equal(rows[:, :3], jrows[:, :3])
    n, ns = rows[0, 0], rows[0, 1]
    for col, var_col in ((3, 7), (4, 8)):
        se = np.sqrt((rows[:, var_col] + jrows[:, var_col]) / (n * ns))
        z = np.abs(rows[:, col] - jrows[:, col]) / np.maximum(se, 1e-300)
        assert np.all(z < 5.0), (col, z)


@pytest.mark.parametrize("flags,ncols", [
    (["--model", "ising2d", "--nx", "33", "--ny", "32"], 5),
    (["--model", "ising2d", "--nx", "33", "--ny", "31"], 5),
    (["--model", "clock", "--q", "6", "--nx", "33", "--ny", "32", "--kbt",
      "0.8"], 6),
    (["--model", "xy2d", "--nx", "33", "--ny", "31", "--kbt", "0.89"], 6),
    (["--model", "ising3d", "--nx", "9", "--ny", "7", "--nz", "4", "--kbt",
      "4.5"], 5),
])
def test_samples_text_matches_jax(flags, ncols, tmp_path):
    """--protocol samples on every helical model: the JAX CLI's headers
    (but the engine) and rows N, sample, t, m, e [, m_y], one history at a
    time on the per-history runner (the masked kernels in 2-D, the helical
    3-D kernels in 3-D)."""
    run = ["--protocol", "samples", "--mcs", "4", "--samples", "3"]
    port, jax_out = tmp_path / "port.dat", tmp_path / "jax.dat"
    assert main(flags + run + ["--device", "cpu", "--output",
                               str(port)]) == 0
    assert jax_main(flags + run + ["--output", str(jax_out)]) == 0
    head, rows = _split(port)
    jhead, jrows = _split(jax_out)
    assert "# engine: phase engine (single history)" in head
    assert _no_engine(head) == _no_engine(jhead)
    assert rows.shape == jrows.shape == (12, ncols)
    np.testing.assert_array_equal(rows[:, :3], jrows[:, :3])
    assert np.all(np.isfinite(rows)) and np.all(np.abs(rows[:, 3]) <= 1.0)
