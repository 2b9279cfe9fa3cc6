"""The periodic XY observables in one pass on the card: a CUDA kernel and
its plain version.

Port of ``cuda_fortran_mc_simulation_spin_tpu/ops/xy2d_measure_pallas.py``
(the module keeps its name so that its JAX counterpart is found by name;
it launches a CUDA kernel, not a Pallas one).
``csrc/xy2d_measure_pallas.cu`` ``measure_kernel`` replaces ``_kernel``
(pallas_call at ``:121``): per replica (Σ S_x, Σ S_y, e, A) of (R, ny,
nx/2) float32 planes, e = -Σ S·(S_right + S_down) with each bond once and
A = Σ S·S0 against the t=0 snapshot (0 without one).  The disorder
protocols run it where the sums cannot ride on a Metropolis phase: after
the over-relaxation sweeps, and for the fix1mcs row at t=1 after the
rotation.

Every site term is float64 of the widened float32 spins, in the same
order in the kernel and in :func:`measure_sums_plain`, so the two differ
only in the order of the float64 sums (1e-15 relative); the kernel sums
per block and then per replica in a fixed order, so runs repeat bitwise.
The JAX kernel sums in float32.

A wrapper takes the plain version for a CPU tensor; for a CUDA tensor it
launches the kernel or raises.  ``LAUNCHES`` counts launches.
"""

from __future__ import annotations

import ctypes

import torch

from cuda_fortran_mc_simulation_spin_tpu_torch.core import lattice
from cuda_fortran_mc_simulation_spin_tpu_torch.models.xy2d import XYState
from cuda_fortran_mc_simulation_spin_tpu_torch.ops import _build
from cuda_fortran_mc_simulation_spin_tpu_torch.ops.ising2d_multispin import (
    _on_cpu,
    _stream,
)
from cuda_fortran_mc_simulation_spin_tpu_torch.ops.xy2d_pallas import (
    _check_planes,
    densities,
    scratch,
    snapshot_pointers,
)

LAUNCHES = {"measure": 0, "measure_snapshot": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def measure_sums_plain(st: XYState, snap: XYState | None = None
                       ) -> torch.Tensor:
    """Plain version of ``measure_kernel``: (R, 4) float64 (Σ S_x, Σ S_y,
    e, A) of (R, ny, half) planes, A = 0 without a snapshot."""
    ax, ay, bx, by = (p.to(torch.float64) for p in st)
    rax, dax, rbx, dbx = lattice.right_down_neighbors(ax, bx)
    ray, day, rby, dby = lattice.right_down_neighbors(ay, by)
    e = (ax * (rax + dax) + ay * (ray + day)) + (
        bx * (rbx + dbx) + by * (rby + dby))

    def total(v):
        return v.sum(dim=(-2, -1))

    a = torch.zeros_like(total(ax))
    if snap is not None:
        sax, say, sbx, sby = (p.to(torch.float64) for p in snap)
        a = total((ax * sax + ay * say) + (bx * sbx + by * sby))
    return torch.stack([total(ax + bx), total(ay + by), -total(e), a],
                       dim=-1)


def _lib() -> ctypes.CDLL:
    lib = _build.load("xy2d_measure_pallas")
    if lib.xy_measure.argtypes is not None:
        return lib
    lib.xy_measure.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 3
                               + [ctypes.c_void_p])
    lib.xy_measure.restype = ctypes.c_int
    lib.xy_measure_error_string.argtypes = [ctypes.c_int]
    lib.xy_measure_error_string.restype = ctypes.c_char_p
    return lib


def measure_sums(st: XYState, snap: XYState | None = None) -> torch.Tensor:
    """(R, 4) float64 (Σ S_x, Σ S_y, e, A) of (R, ny, half) planes:
    ``measure_kernel`` on CUDA tensors, :func:`measure_sums_plain` on CPU
    tensors."""
    if _on_cpu(st.ax):
        return measure_sums_plain(st, snap)
    _check_planes(*st, *(() if snap is None else snap))
    nrep, ny, half = st.ax.shape
    partials, obs = scratch(st.ax, True)
    lib = _lib()
    with torch.cuda.device(st.ax.device):
        code = lib.xy_measure(*(p.data_ptr() for p in st),
                              snapshot_pointers(snap), partials.data_ptr(),
                              obs.data_ptr(), nrep, ny, half, _stream(st.ax))
    if code != 0:
        msg = lib.xy_measure_error_string(code).decode()
        raise RuntimeError(f"xy2d measure_kernel: CUDA error {code} ({msg})")
    LAUNCHES["measure"] += 1
    if snap is not None:
        LAUNCHES["measure_snapshot"] += 1
    return obs


def measure(model, st: XYState, snap: XYState) -> dict[str, torch.Tensor]:
    """{mx, my, e, A} densities (R,) float64 of (R, ny, half) planes
    against the snapshot (JAX ``measure``)."""
    return densities(model, measure_sums(st, snap))


def measure_plain(model, st: XYState) -> dict[str, torch.Tensor]:
    """{mx, my, e} densities without a snapshot (JAX ``measure_plain``)."""
    obs = densities(model, measure_sums(st))
    return {k: obs[k] for k in ("mx", "my", "e")}
