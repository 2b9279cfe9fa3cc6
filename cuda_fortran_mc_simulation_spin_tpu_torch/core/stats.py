"""Kahan-compensated streaming ensemble statistics.

Port of ``cuda_fortran_mc_simulation_spin_tpu/core/stats.py``, kept in
numpy float64 as there: the device hands the host one small observable
array per batch of samples, so this is cold path.  The arithmetic is the
JAX package's, operation for operation, so the same series give bitwise
equal accumulators and the same checkpoint ``state_dict``.

Reimplements the capability of the reference's external
``Numerical_utilities`` dependency: ``variance_kahan`` and
``variance_covariance_kahan`` accumulators, used per time step to
aggregate observables over Monte Carlo samples.

- Accumulators are vectorized over the time axis: one ``add_data`` call
  folds in a whole per-sample time series (shape (mcs,) or (replicas,
  mcs)).
- ``var`` is the unbiased sample variance n/(n-1)·(<v²>−<v>²) from
  compensated moment sums; ``square_mean`` is exposed separately because
  the reference's output derives χ = <m²> − (<mx>² + <my>²) from square
  means.
"""

from __future__ import annotations

import numpy as np


class _KahanSum:
    """Compensated elementwise vector summation."""

    __slots__ = ("s", "c")

    def __init__(self, shape):
        self.s = np.zeros(shape, dtype=np.float64)
        self.c = np.zeros(shape, dtype=np.float64)

    def add(self, v: np.ndarray) -> None:
        y = v - self.c
        t = self.s + y
        self.c = (t - self.s) - y
        self.s = t

    def total(self) -> np.ndarray:
        return self.s


class VarianceKahan:
    """Vectorized analog of `variance_kahan` (one variable).

    API parity: add_data, mean, square_mean, var, num_sample.
    """

    def __init__(self, shape):
        self._n = 0
        self._sum = _KahanSum(shape)
        self._sumsq = _KahanSum(shape)

    # -- checkpoint serialization (io/checkpoint.py) -------------------
    def state_dict(self) -> dict:
        return {
            "n": self._n,
            "sum_s": self._sum.s, "sum_c": self._sum.c,
            "sumsq_s": self._sumsq.s, "sumsq_c": self._sumsq.c,
        }

    def load_state_dict(self, d: dict) -> None:
        self._n = int(d["n"])
        self._sum.s, self._sum.c = np.array(d["sum_s"]), np.array(d["sum_c"])
        self._sumsq.s = np.array(d["sumsq_s"])
        self._sumsq.c = np.array(d["sumsq_c"])

    def add_data(self, v: np.ndarray) -> None:
        v = np.asarray(v, dtype=np.float64)
        if v.ndim == len(self._sum.s.shape) + 1:
            # batch of samples (replicas first axis): reduce the replica
            # axis with numpy's pairwise summation, then one compensated
            # fold — one host pass regardless of batch size
            self._n += v.shape[0]
            self._sum.add(v.sum(axis=0))
            self._sumsq.add((v * v).sum(axis=0))
            return
        self._n += 1
        self._sum.add(v)
        self._sumsq.add(v * v)

    def num_sample(self) -> int:
        return self._n

    def mean(self) -> np.ndarray:
        return self._sum.total() / self._n

    def square_mean(self) -> np.ndarray:
        return self._sumsq.total() / self._n

    def var(self) -> np.ndarray:
        if self._n < 2:
            return np.zeros_like(self._sum.total())
        n = self._n
        m = self.mean()
        return (self.square_mean() - m * m) * (n / (n - 1.0))


class VarianceCovarianceKahan:
    """Vectorized analog of `variance_covariance_kahan` (two variables).

    API parity: add_data(v1,v2), mean1/2, square_mean1/2, var1/2, cov,
    mean_v1v2, num_sample.
    """

    def __init__(self, shape):
        self._n = 0
        self._sum1 = _KahanSum(shape)
        self._sum2 = _KahanSum(shape)
        self._sumsq1 = _KahanSum(shape)
        self._sumsq2 = _KahanSum(shape)
        self._sum12 = _KahanSum(shape)

    def state_dict(self) -> dict:
        out = {"n": self._n}
        for name in ("sum1", "sum2", "sumsq1", "sumsq2", "sum12"):
            ks = getattr(self, f"_{name}")
            out[f"{name}_s"] = ks.s
            out[f"{name}_c"] = ks.c
        return out

    def load_state_dict(self, d: dict) -> None:
        self._n = int(d["n"])
        for name in ("sum1", "sum2", "sumsq1", "sumsq2", "sum12"):
            ks = getattr(self, f"_{name}")
            ks.s = np.array(d[f"{name}_s"])
            ks.c = np.array(d[f"{name}_c"])

    def add_data(self, v1: np.ndarray, v2: np.ndarray) -> None:
        v1 = np.asarray(v1, dtype=np.float64)
        v2 = np.asarray(v2, dtype=np.float64)
        if v1.ndim == len(self._sum1.s.shape) + 1:
            # replica batch: pairwise-sum the replica axis, fold once
            self._n += v1.shape[0]
            self._sum1.add(v1.sum(axis=0))
            self._sum2.add(v2.sum(axis=0))
            self._sumsq1.add((v1 * v1).sum(axis=0))
            self._sumsq2.add((v2 * v2).sum(axis=0))
            self._sum12.add((v1 * v2).sum(axis=0))
            return
        self._n += 1
        self._sum1.add(v1)
        self._sum2.add(v2)
        self._sumsq1.add(v1 * v1)
        self._sumsq2.add(v2 * v2)
        self._sum12.add(v1 * v2)

    def num_sample(self) -> int:
        return self._n

    def mean1(self) -> np.ndarray:
        return self._sum1.total() / self._n

    def mean2(self) -> np.ndarray:
        return self._sum2.total() / self._n

    def square_mean1(self) -> np.ndarray:
        return self._sumsq1.total() / self._n

    def square_mean2(self) -> np.ndarray:
        return self._sumsq2.total() / self._n

    def mean_v1v2(self) -> np.ndarray:
        return self._sum12.total() / self._n

    def _unbias(self) -> float:
        return self._n / (self._n - 1.0) if self._n > 1 else 0.0

    def var1(self) -> np.ndarray:
        m = self.mean1()
        return (self.square_mean1() - m * m) * self._unbias()

    def var2(self) -> np.ndarray:
        m = self.mean2()
        return (self.square_mean2() - m * m) * self._unbias()

    def cov(self) -> np.ndarray:
        return (self.mean_v1v2() - self.mean1() * self.mean2()) * self._unbias()
