"""Output writers matching the reference's .dat conventions.

Port of the relaxation part of
``cuda_fortran_mc_simulation_spin_tpu/io/datfmt.py``: the same text for
the same accumulator.  stdout is the dataset: `# key: value` header lines
followed by fixed-column whitespace-separated rows.  Fortran's `g0` float
edit descriptor is approximated with `%.17g`, which round-trips f64
exactly.
"""

from __future__ import annotations

from typing import IO, Mapping

import numpy as np

from cuda_fortran_mc_simulation_spin_tpu_torch.core.stats import (
    VarianceCovarianceKahan,
)


def g0(v) -> str:
    if isinstance(v, (bool, np.bool_)):
        return "T" if v else "F"
    if isinstance(v, (int, np.integer)):
        return str(int(v))
    if isinstance(v, str):
        return v
    return format(float(v), ".17g")


def write_header(out: IO[str], fields: Mapping[str, object]) -> None:
    """`# key: value` header block (both stdout and stderr in the
    reference; callers decide the streams)."""
    for k, v in fields.items():
        if isinstance(v, tuple):
            out.write(f"# {k}: " + " ".join(g0(x) for x in v) + "\n")
        else:
            out.write(f"# {k}: {g0(v)}\n")


def write_relaxation_table(
    out: IO[str], nall: int, mcs: int, op: VarianceCovarianceKahan
) -> None:
    """The reference relaxation app's 10-column table: N, Nsample, t,
    <m>, <e>, <m²>, <e²>, N·Var[m], N·Var[e], N·Cov[m,e]."""
    n = op.num_sample()
    m1, m2 = op.mean1(), op.mean2()
    s1, s2 = op.square_mean1(), op.square_mean2()
    v1, v2, cv = op.var1(), op.var2(), op.cov()
    for i in range(mcs):
        row = [nall, n, i + 1, m1[i], m2[i], s1[i], s2[i],
               nall * v1[i], nall * v2[i], nall * cv[i]]
        out.write(" ".join(g0(v) for v in row) + "\n")


def write_specific_times_table(out: IO[str], nall: int, times,
                               op: VarianceCovarianceKahan) -> None:
    """The relaxation table at the 1-based sweep ``times`` only (the
    specific-times schedule)."""
    n = op.num_sample()
    m1, m2 = op.mean1(), op.mean2()
    s1, s2 = op.square_mean1(), op.square_mean2()
    v1, v2, cv = op.var1(), op.var2(), op.cov()
    for j, t in enumerate(times):
        row = [nall, n, t, m1[j], m2[j], s1[j], s2[j],
               nall * v1[j], nall * v2[j], nall * cv[j]]
        out.write(" ".join(g0(v) for v in row) + "\n")
