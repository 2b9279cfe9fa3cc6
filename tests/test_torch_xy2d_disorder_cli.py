"""The XY disorder protocols as a whole: the port's CLI (--device cpu, the
kernels' plain versions) against the JAX CLI, the three .dat writers
against JAX's on the same accumulators, checkpoint resume (bitwise, and
from a checkpoint the JAX package wrote), and the routes that raise.

The two packages draw different random streams (Philox vs threefry), so
the curves are compared statistically: <|m|> (or <m>), <e> and <A> within
5 combined standard errors at every t, each package's standard error from
its own table (second moments or N·Var columns); headers equal except the
`# engine:` stamp."""

import dataclasses
import io

import numpy as np
import pytest
import torch

from cuda_fortran_mc_simulation_spin_tpu.core import stats as jstats
from cuda_fortran_mc_simulation_spin_tpu.io import datfmt as jdatfmt
from cuda_fortran_mc_simulation_spin_tpu.runs.__main__ import main as jax_main
from cuda_fortran_mc_simulation_spin_tpu_torch import interop
from cuda_fortran_mc_simulation_spin_tpu_torch.config import RunConfig
from cuda_fortran_mc_simulation_spin_tpu_torch.core import stats
from cuda_fortran_mc_simulation_spin_tpu_torch.engine import protocols, sweep
from cuda_fortran_mc_simulation_spin_tpu_torch.io import datfmt
from cuda_fortran_mc_simulation_spin_tpu_torch.runs.__main__ import main

BASE = ["--model", "xy2d", "--nx", "64", "--ny", "64", "--kbt", "0.89",
        "--mcs", "20", "--samples", "16"]
CASES = {
    "from_disorder": ["--protocol", "from_disorder", "--replicas", "4"],
    "fix1mcs": ["--protocol", "from_disorder", "--fix1mcs", "--replicas",
                "4"],
    "finite_magne": ["--protocol", "finite_magne", "--init-magne", "0.1",
                     "--replicas", "4"],
    "samples": ["--protocol", "samples", "--init-state", "finite_magne",
                "--init-magne", "0.1"],
}


def _split(path):
    lines = path.read_text().splitlines()
    head = [s for s in lines if s.startswith("#")]
    rows = np.array([s.split() for s in lines if not s.startswith("#")],
                    dtype=np.float64)
    return head, rows


def _z(m1, v1, n1, m2, v2, n2):
    return np.abs(m1 - m2) / np.sqrt(v1 / n1 + v2 / n2)


def _moments(case, rows):
    """{name: (mean, per-sample variance)} at every t, and the samples."""
    if case == "samples":
        n = int(rows[:, 1].max())
        per = rows[:, 3:].reshape(n, -1, 4)
        return {k: (per[..., j].mean(0), per[..., j].var(0, ddof=1))
                for k, j in (("m_x", 0), ("e", 1), ("A", 3))}, n
    n = rows[0, 1]
    if case == "finite_magne":
        nall = rows[0, 0]
        return {"m": (rows[:, 3], rows[:, 7] / nall),
                "e": (rows[:, 4], rows[:, 8] / nall),
                "A": (rows[:, 10], rows[:, 12] / nall)}, n
    return {"|m|": (rows[:, 3], rows[:, 5] - rows[:, 3] ** 2),
            "e": (rows[:, 4], rows[:, 6] - rows[:, 4] ** 2),
            "A": (rows[:, 9], rows[:, 10] - rows[:, 9] ** 2)}, n


@pytest.mark.parametrize("case", list(CASES))
def test_cli_matches_jax(case, tmp_path):
    """Port CLI vs JAX CLI at 64x64: the same headers but for the engine
    stamp, the same row layout and N, Nsample, t columns; the curves
    within 5 combined standard errors at every t."""
    flags = BASE + CASES[case]
    port, jax_dat = tmp_path / "port.dat", tmp_path / "jax.dat"
    assert main(flags + ["--device", "cpu", "--output", str(port)]) == 0
    assert jax_main(flags + ["--output", str(jax_dat)]) == 0
    head, rows = _split(port)
    jhead, jrows = _split(jax_dat)
    assert [h for h in head if not h.startswith("# engine:")] == [
        h for h in jhead if not h.startswith("# engine:")]
    assert "# initial state: disorder" in head
    assert f"# engine: {sweep.XY_DISORDER_RESIDENT}" in head
    assert rows.shape == jrows.shape
    np.testing.assert_array_equal(rows[:, :3], jrows[:, :3])
    assert np.all(np.isfinite(rows))
    pm, n = _moments(case, rows)
    jm, jn = _moments(case, jrows)
    for k in pm:
        z = _z(*pm[k], n, *jm[k], jn)
        assert np.all(z < 5.0), (k, z)
    if case == "fix1mcs":
        # rotated after the first sweep: <mx> = <|m|> and <my> = 0 at t=1
        np.testing.assert_allclose(rows[0, 11], rows[0, 3], rtol=1e-12)
        assert abs(rows[0, 12]) < 1e-9


def _accumulators(pkg, g, length=6, corr=True):
    """Both packages' accumulators filled with the same random series."""
    mod = stats if pkg == "port" else jstats
    accs = {k: mod.VarianceCovarianceKahan((length,))
            for k in ("op_abs", "op_xy", "op", "op_y")}
    accs["ac"] = mod.VarianceKahan((length,))
    if corr:
        accs["corr"] = mod.VarianceKahan((length,))
    for _ in range(3):
        mx, my, e, a, c = g.normal(size=(5, 4, length))
        accs["op_abs"].add_data(np.hypot(mx, my), e)
        accs["op_xy"].add_data(mx, my)
        accs["op"].add_data(mx, e)
        accs["op_y"].add_data(my, e)
        accs["ac"].add_data(a)
        if corr:
            accs["corr"].add_data(c)
    return accs


class _Out:
    def __init__(self):
        self.text = ""

    def write(self, s):
        self.text += s


@pytest.mark.parametrize("corr", [False, True])
@pytest.mark.parametrize("times", [None, (2, 4, 5, 6, 9, 12)])
def test_disorder_writers_match_jax(corr, times):
    """write_parameters_from_disorder, write_abs_parameters_from_disorder
    and write_sample_series give JAX's text on the same accumulators and
    series (with and without the correlation columns and a times
    schedule)."""
    p = _accumulators("port", np.random.default_rng(1), corr=corr)
    j = _accumulators("jax", np.random.default_rng(1), corr=corr)
    for name in ("write_parameters_from_disorder",
                 "write_abs_parameters_from_disorder"):
        a, b = _Out(), _Out()
        pa = ((p["op"], p["op_y"]) if "abs" not in name
              else (p["op_abs"], p["op_xy"]))
        ja = ((j["op"], j["op_y"]) if "abs" not in name
              else (j["op_abs"], j["op_xy"]))
        getattr(datfmt, name)(a, 4096, 6, *pa, p["ac"], times=times,
                              correlation=p.get("corr"))
        getattr(jdatfmt, name)(b, 4096, 6, *ja, j["ac"], times=times,
                               correlation=j.get("corr"))
        assert a.text == b.text and a.text.count("\n") == 7
    g = np.random.default_rng(2)
    series = {k: g.normal(size=6) for k in ("mx", "e", "my", "A", "corr")}
    order = ("mx", "e", "my", "A") + (("corr",) if corr else ())
    a, b = _Out(), _Out()
    datfmt.write_sample_series(a, 4096, 3, series, order=order, times=times)
    jdatfmt.write_sample_series(b, 4096, 3, series, order=order, times=times)
    assert a.text == b.text


def test_checkpoint_resume_is_exact(tmp_path):
    """Two time-sliced legs of the fix1mcs protocol through a checkpoint
    give the uninterrupted run's .dat; a checkpoint the JAX CLI wrote
    after 8 samples resumes in the port (the accumulators' state carried
    across), ending at the full sample count."""
    flags = BASE + CASES["fix1mcs"] + ["--device", "cpu"]
    full, leg, ck = tmp_path / "full.dat", tmp_path / "leg.dat", \
        tmp_path / "ck.npz"
    assert main(flags + ["--output", str(full)]) == 0
    legs = flags + ["--output", str(leg), "--checkpoint", str(ck),
                    "--checkpoint-every", "4", "--max-samples-this-run", "8"]
    assert main(legs) == 0
    assert main(legs) == 0
    assert leg.read_text() == full.read_text()

    jck, mixed = tmp_path / "jck.npz", tmp_path / "mixed.dat"
    jflags = BASE + CASES["fix1mcs"]
    assert jax_main(jflags + ["--output", str(tmp_path / "j.dat"),
                              "--checkpoint", str(jck),
                              "--max-samples-this-run", "8"]) == 0
    assert main(flags + ["--output", str(mixed), "--checkpoint",
                         str(jck)]) == 0
    _, rows = _split(mixed)
    assert rows.shape == (20, 16) and np.all(rows[:, 1] == 16)
    acc = stats.VarianceKahan((20,))
    with np.load(jck) as z:
        acc.load_state_dict(interop.stats_state_from_numpy(
            {k[3:]: z[k] for k in z.files if k.startswith("ac.")}))
    assert acc.num_sample() == 16


def test_interop_carries_a_jax_prepared_state():
    """A JAX finite-magne state and its snapshot cross into the port
    (xy_from_numpy): the port's measurement of it equals the JAX sums
    (A against itself is N)."""
    import jax
    from cuda_fortran_mc_simulation_spin_tpu.models.xy2d import XY2D as JXY

    from cuda_fortran_mc_simulation_spin_tpu_torch.models import XY2D
    from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
        xy2d_measure_pallas,
    )
    jm = JXY(nx=32, ny=32, kbt=0.89, backend="jnp")
    jst = jm.prep_finite_magne(jax.random.PRNGKey(3), 0.3)
    st = interop.xy_from_numpy(*(np.asarray(p)[None] for p in jst))
    snap = interop.xy_from_numpy(*(np.asarray(p)[None] for p in jst))
    obs = xy2d_measure_pallas.measure_sums(st, snap)[0].numpy()
    mx, my = jm.magne_sums(jst)
    np.testing.assert_allclose(obs[:3], [float(mx), float(my),
                                         float(jm.energy_sum(jst))],
                               rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(obs[3], 32 * 32, rtol=1e-6)
    model = XY2D(nx=32, ny=32, kbt=0.89)
    assert torch.equal(model.magne_sums(st)[0], torch.tensor(
        [obs[0]], dtype=torch.float64))


def test_disorder_routes_that_raise(tmp_path):
    """Odd nx (helical XY) raises the JAX ValueError; on a mesh the JAX
    package's ValueErrors for shapes it cannot shard (rows % (2·y),
    columns % x) and a run that goes through; --device cuda without a
    card raises before any output."""
    out = tmp_path / "x.dat"
    with pytest.raises(ValueError, match="periodic XY engine"):
        main(BASE[:2] + ["--nx", "33", "--ny", "32", "--protocol",
                         "from_disorder", "--device", "cpu", "--output",
                         str(out)])
    cfg = dataclasses.replace(RunConfig(model="xy2d", nx=32, ny=32, mcs=2,
                                        tot_sample=2, replicas=2),
                              mesh_dp=2)
    accs = protocols.run_from_disorder(cfg, out=io.StringIO(),
                                       err=io.StringIO(), device="cpu")
    assert accs["ac"].state_dict()["n"] == 2
    for mesh, match in (({"mesh_y": 3}, "2\\*domain_shards=6"),
                        ({"mesh_x": 3}, "divisible by the mesh's x=3")):
        with pytest.raises(ValueError, match=match):
            protocols.run_from_disorder(dataclasses.replace(cfg, mesh_dp=1,
                                                            **mesh),
                                        out=io.StringIO(),
                                        err=io.StringIO(), device="cpu")
    if not torch.cuda.is_available():
        for case in ("from_disorder", "samples"):
            with pytest.raises(RuntimeError, match="cuda"):
                main(BASE + CASES[case] + ["--output", str(out)])
    assert not out.exists()
