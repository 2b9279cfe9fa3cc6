"""The slice as a whole: the port's CLI (--device cpu, so the kernels'
plain versions run) against the JAX CLI for the same flags, determinism,
checkpoint resume, and the routes the port refuses.  The routes the port
once refused and now runs are in ``test_torch_cli_routes.py`` and, with
``--protocol samples``, ``test_torch_cli_samples.py`` (files of their own,
so that the test workers can share them out)."""

import numpy as np
import pytest
import torch

from cuda_fortran_mc_simulation_spin_tpu.runs.__main__ import main as jax_main
from cuda_fortran_mc_simulation_spin_tpu_torch.runs.__main__ import main

FLAGS = ["--model", "ising2d", "--nx", "256", "--ny", "256", "--mcs", "20",
         "--samples", "16", "--replicas", "4"]


def _split(path):
    lines = path.read_text().splitlines()
    head = [s for s in lines if s.startswith("#")]
    rows = np.array([s.split() for s in lines if not s.startswith("#")],
                    dtype=np.float64)
    return head, rows


@pytest.fixture(scope="module")
def port_dat(tmp_path_factory):
    path = tmp_path_factory.mktemp("port") / "port.dat"
    assert main(FLAGS + ["--device", "cpu", "--output", str(path)]) == 0
    return path


def test_cli_matches_jax_headers_and_statistics(port_dat, tmp_path):
    """Header lines and column layout equal the JAX CLI's; m(t), e(t)
    agree within 5 combined standard errors at every t.  The two packages
    draw different random streams (Philox vs threefry), so the comparison
    of the curves is statistical, not bitwise."""
    jpath = tmp_path / "jax.dat"
    assert jax_main(FLAGS + ["--output", str(jpath)]) == 0
    head, rows = _split(port_dat)
    jhead, jrows = _split(jpath)
    # the `# engine:` stamp names the route, which differs (the JAX
    # package takes its jnp engine on the CPU)
    assert [h for h in head if not h.startswith("# engine:")] == [
        h for h in jhead if not h.startswith("# engine:")]
    assert "# engine: ising2d_multispin bit-packed (resident multisweep)" \
        in head
    assert rows.shape == jrows.shape == (20, 10)
    np.testing.assert_array_equal(rows[:, :3], jrows[:, :3])
    n, ns = rows[0, 0], rows[0, 1]
    for col, var_col in ((3, 7), (4, 8)):
        se = np.sqrt((rows[:, var_col] + jrows[:, var_col]) / (n * ns))
        z = np.abs(rows[:, col] - jrows[:, col]) / se
        assert np.all(z < 5.0), (col, z)


def test_same_seed_gives_identical_dat(port_dat, tmp_path):
    again = tmp_path / "again.dat"
    assert main(FLAGS + ["--device", "cpu", "--output", str(again)]) == 0
    assert again.read_text() == port_dat.read_text()
    other = tmp_path / "other.dat"
    assert main(FLAGS + ["--device", "cpu", "--seed", "43", "--output",
                         str(other)]) == 0
    assert other.read_text() != port_dat.read_text()


def test_checkpoint_resume_is_exact(port_dat, tmp_path):
    """Two time-sliced legs through a checkpoint give the uninterrupted
    run's .dat; the registry records the route and the device."""
    ck, out, reg = tmp_path / "ck.npz", tmp_path / "leg.dat", \
        tmp_path / "reg.log"
    leg = FLAGS + ["--device", "cpu", "--output", str(out), "--checkpoint",
                   str(ck), "--checkpoint-every", "4",
                   "--max-samples-this-run", "8", "--registry", str(reg)]
    assert main(leg) == 0
    assert main(leg) == 0
    assert out.read_text() == port_dat.read_text()
    assert '"device": "cpu"' in reg.read_text()
    assert "resident multisweep" in reg.read_text()


def test_measure_times_schedule(tmp_path):
    out = tmp_path / "st.dat"
    assert main(FLAGS + ["--device", "cpu", "--measure-times", "1", "5",
                         "20", "--output", str(out)]) == 0
    _, rows = _split(out)
    assert rows[:, 2].tolist() == [1, 5, 20]


def test_cuda_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present; chip_smoke.py drives --device cuda")
    out = tmp_path / "x.dat"
    with pytest.raises(RuntimeError, match="cuda"):
        main(FLAGS + ["--output", str(out)])
    assert not out.exists()
    assert not (tmp_path / "x.dat.partial").exists()


@pytest.mark.parametrize("extra,match", [
    (["--profile-dir", "p"], "profiler"),
    (["--backend", "jnp"], "backend"),
    (["--model", "ising3d", "--nx", "2049", "--ny", "1024", "--nz", "1024"],
     "queue A item 4a"),
])
def test_unserved_routes_raise(extra, match, tmp_path):
    out = tmp_path / "x.dat"
    with pytest.raises(NotImplementedError, match=match):
        main(FLAGS + extra + ["--device", "cpu", "--output", str(out)])
    assert not out.exists()


@pytest.mark.parametrize("protocol", ["from_disorder", "finite_magne"])
def test_disorder_protocols_on_ising_raise_the_jax_value_error(
        protocol, tmp_path):
    """The disorder protocols need the periodic XY engine: on another
    model both packages raise the same ValueError."""
    out, jout = tmp_path / "x.dat", tmp_path / "j.dat"
    flags = FLAGS + ["--protocol", protocol]
    with pytest.raises(ValueError, match="periodic XY engine") as port:
        main(flags + ["--device", "cpu", "--output", str(out)])
    with pytest.raises(ValueError, match="periodic XY engine") as jax:
        jax_main(flags + ["--output", str(jout)])
    assert str(port.value) == str(jax.value)
    assert not out.exists()
