"""The port's CLI on the CPU (the kernels' plain versions) with
``--protocol samples`` on the routes it once refused: Ising 2-D, the
clock, the helical clock and helical Ising.  The other formerly refused
routes are in ``test_torch_cli_routes.py``; the flags and checks are
``test_torch_cli.py``'s."""

import numpy as np
import pytest
from test_torch_cli import FLAGS, _split

from cuda_fortran_mc_simulation_spin_tpu_torch.runs.__main__ import main


@pytest.mark.parametrize("extra,engine", [
    (["--protocol", "samples"], "phase engine (single history)"),
    (["--protocol", "samples", "--model", "clock"],
     "phase engine (single history)"),
    (["--protocol", "samples", "--model", "clock", "--nx", "33", "--ny",
      "32"], "phase engine (single history)"),
    (["--protocol", "samples", "--nx", "33", "--ny", "32"],
     "phase engine (single history)"),
])
def test_formerly_refused_routes_run(extra, engine, tmp_path):
    """Periodic Ising at an unpackable shape, --protocol samples on Ising
    2-D and on the clock, and the clock at q = 5, refused before the int8
    kernels were ported, and the helical shapes refused before the masked
    helical kernels were ported (--protocol samples on the helical clock
    and helical Ising, the helical clock at q = 5, helical XY and Ising at
    odd ny), now run on the CPU through the plain versions of those
    kernels."""
    out = tmp_path / "x.dat"
    assert main(FLAGS + extra + ["--device", "cpu", "--output",
                                 str(out)]) == 0
    head, rows = _split(out)
    assert f"# engine: {engine}" in head
    assert rows.shape[0] == (16 * 20 if "samples" in extra else 20)
    assert np.all(np.isfinite(rows))
