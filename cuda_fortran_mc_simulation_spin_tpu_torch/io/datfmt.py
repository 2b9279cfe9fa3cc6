"""Output writers matching the reference's .dat conventions.

Port of ``cuda_fortran_mc_simulation_spin_tpu/io/datfmt.py``: the same
text for the same accumulators (the relaxation tables, the disorder
protocols' two tables and the per-sample series).  stdout is the dataset: `# key: value` header lines
followed by fixed-column whitespace-separated rows.  Fortran's `g0` float
edit descriptor is approximated with `%.17g`, which round-trips f64
exactly.
"""

from __future__ import annotations

from typing import IO, Mapping

import numpy as np

from cuda_fortran_mc_simulation_spin_tpu_torch.core.stats import (
    VarianceCovarianceKahan,
    VarianceKahan,
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


def write_parameters_from_disorder(
    out: IO[str],
    nall: int,
    mcs: int,
    order_parameter: VarianceCovarianceKahan,   # (m, e)
    order_parameter_y: VarianceCovarianceKahan,  # (my, e)
    autocorrelation: VarianceKahan,
    times=None,
    correlation: VarianceKahan | None = None,
) -> None:
    """The reference's output_parameters_from_disorder
    (output_utilities_m.f90:7-25): N, Nsample, t, <m>, <e>, <m²>, <e²>,
    N·Var[mx], N·Var[e], N·Cov[mx,e], <A>, <A²>, N·Var[A], <m_y>; with
    ``correlation`` (the two-point accumulator) also <corr>, <corr²>."""
    cols = (
        "# N, Nsample, time, <m>, <e>, <m^2>, <e^2>, N*Var[mx], N*Var[e],"
        " N*Cov[mx,e], <A>, <A^2>, N*Var[A], <m_y>"
    )
    if correlation is not None:
        cols += ", <corr>, <corr^2>"
    out.write(cols + "\n")
    n = order_parameter.num_sample()
    m1, m2 = order_parameter.mean1(), order_parameter.mean2()
    s1, s2 = order_parameter.square_mean1(), order_parameter.square_mean2()
    v1, v2 = order_parameter.var1(), order_parameter.var2()
    cv = order_parameter.cov()
    am, asq, av = (autocorrelation.mean(), autocorrelation.square_mean(),
                   autocorrelation.var())
    my1 = order_parameter_y.mean1()
    times = times if times is not None else range(1, mcs + 1)
    for i, t in enumerate(times):
        row = [nall, n, int(t), m1[i], m2[i], s1[i], s2[i],
               nall * v1[i], nall * v2[i], nall * cv[i],
               am[i], asq[i], nall * av[i], my1[i]]
        if correlation is not None:
            row += [correlation.mean()[i], correlation.square_mean()[i]]
        out.write(" ".join(g0(v) for v in row) + "\n")


def write_abs_parameters_from_disorder(
    out: IO[str],
    nall: int,
    mcs: int,
    order_parameter_abs: VarianceCovarianceKahan,  # (|m|, e)
    order_parameter_xy: VarianceCovarianceKahan,   # (mx, my)
    autocorrelation: VarianceKahan,
    times=None,
    correlation: VarianceKahan | None = None,
) -> None:
    """The reference's output_abs_parameters_from_disorder
    (output_utilities_m.f90:27-51), with χ = <m²> - (<mx>² + <my>²)
    (:42); with ``correlation`` also <corr>, <corr²>."""
    cols = (
        "# N, Nsample, time, <|m|>, <e>, <m^2>, <e^2>, <|m|e>,"
        " (<m^2> - (<mx>^2 + <my>^2)), <A>, <A^2>, <mx>, <my>, <mx^2>,"
        " <my^2>, <mx*my>"
    )
    if correlation is not None:
        cols += ", <corr>, <corr^2>"
    out.write(cols + "\n")
    n = order_parameter_abs.num_sample()
    a1, a2 = order_parameter_abs.mean1(), order_parameter_abs.mean2()
    as1 = order_parameter_abs.square_mean1()
    as2 = order_parameter_abs.square_mean2()
    a12 = order_parameter_abs.mean_v1v2()
    xm, ym = order_parameter_xy.mean1(), order_parameter_xy.mean2()
    xs, ys = (order_parameter_xy.square_mean1(),
              order_parameter_xy.square_mean2())
    xy = order_parameter_xy.mean_v1v2()
    am, asq = autocorrelation.mean(), autocorrelation.square_mean()
    times = times if times is not None else range(1, mcs + 1)
    for i, t in enumerate(times):
        chi = as1[i] - (xm[i] ** 2 + ym[i] ** 2)
        row = [nall, n, int(t), a1[i], a2[i], as1[i], as2[i], a12[i], chi,
               am[i], asq[i], xm[i], ym[i], xs[i], ys[i], xy[i]]
        if correlation is not None:
            row += [correlation.mean()[i], correlation.square_mean()[i]]
        out.write(" ".join(g0(v) for v in row) + "\n")


def write_sample_series(
    out: IO[str], nall: int, sample_index: int,
    series: Mapping[str, np.ndarray], order: tuple[str, ...],
    times=None,
) -> None:
    """Raw per-sample rows of the *_samples apps
    (xy2d_periodic_gpu_relaxation_from_disorder_finite_magne_samples.f90:
    40-58): N, sample, t, then the observables in ``order``; ``times``
    are the rows' 1-based sweeps (default 1..len)."""
    mcs = len(next(iter(series.values())))
    times = times if times is not None else range(1, mcs + 1)
    for i, t in enumerate(times):
        row = [nall, sample_index, int(t)]
        row += [series[k][i] for k in order]
        out.write(" ".join(g0(v) for v in row) + "\n")
