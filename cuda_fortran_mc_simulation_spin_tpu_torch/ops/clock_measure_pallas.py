"""The int8 clock observables in one pass on the card: a CUDA kernel and its
plain version.

Port of ``cuda_fortran_mc_simulation_spin_tpu/ops/clock_measure_pallas.py``
(the module keeps its name so that its JAX counterpart is found by name;
it launches a CUDA kernel, not a Pallas one).
``csrc/clock_measure_pallas.cu`` ``measure_kernel`` replaces ``_kernel``
(pallas_call at ``:85``, ``_measure`` -> ``measure``): per replica
(Σ cos θ, Σ sin θ, E) of (R, ny, nx/2) int8 states, E = −Σ cos(θ −
θ_right) + cos(θ − θ_down), each bond once.

Sums: every term is float64, from core/tables.clock_sums_table, summed
per block in a fixed order and then per replica in a fixed order (no float
atomics), so runs repeat bitwise; the plain version sums the same float64
terms in another order, and the two agree to float64 rounding (exactly at
q = 2 and 4, whose terms are integers).  The JAX kernel sums float32.

A wrapper takes the plain version for a CPU tensor; for a CUDA tensor it
launches the kernel or raises.  ``LAUNCHES`` counts launches.
"""

from __future__ import annotations

import ctypes

import torch

from cuda_fortran_mc_simulation_spin_tpu_torch.core import lattice
from cuda_fortran_mc_simulation_spin_tpu_torch.models.base import (
    CheckerboardState,
)
from cuda_fortran_mc_simulation_spin_tpu_torch.ops import _build, clock_pallas
from cuda_fortran_mc_simulation_spin_tpu_torch.ops.clock_pallas import (
    gather64,
)
from cuda_fortran_mc_simulation_spin_tpu_torch.ops.ising2d_multispin import (
    _on_cpu,
    _stream,
    per_site,
)
from cuda_fortran_mc_simulation_spin_tpu_torch.ops.ising2d_pallas import (
    check_int8,
    raise_on,
)

LAUNCHES = {"measure": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def measure_sums_plain(a: torch.Tensor, b: torch.Tensor, q: int
                       ) -> torch.Tensor:
    """Plain version of ``measure_kernel``: (R, 3) float64 (Σ cos, Σ sin,
    E) of (R, ny, half) colour planes, E = −Σ over the right and down
    bonds of c·c' + s·s'."""
    ca, sa = gather64(a, q)
    cb, sb = gather64(b, q)
    rac, dac, rbc, dbc = lattice.right_down_neighbors(ca, cb)
    ras, das, rbs, dbs = lattice.right_down_neighbors(sa, sb)
    dims = (-2, -1)
    mx = ca.sum(dim=dims) + cb.sum(dim=dims)
    my = sa.sum(dim=dims) + sb.sum(dim=dims)
    e = -((ca * (rac + dac) + sa * (ras + das)).sum(dim=dims)
          + (cb * (rbc + dbc) + sb * (rbs + dbs)).sum(dim=dims))
    return torch.stack([mx, my, e], dim=-1)


def _lib() -> ctypes.CDLL:
    lib = _build.load("clock_measure_pallas")
    if lib.clock_int8_measure.argtypes is not None:
        return lib
    lib.clock_int8_measure.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    lib.clock_int8_measure.restype = ctypes.c_int
    lib.clock_int8_measure_error_string.argtypes = [ctypes.c_int]
    lib.clock_int8_measure_error_string.restype = ctypes.c_char_p
    return lib


def blocks(ny: int, half: int) -> int:
    """Blocks of 256 units (two sites each) a replica's rows fill."""
    return -(-ny * clock_pallas.units(half) // clock_pallas.THREADS)


def measure_sums(a: torch.Tensor, b: torch.Tensor, q: int) -> torch.Tensor:
    """(R, 3) float64 (Σ cos, Σ sin, E) of (R, ny, half) int8 planes:
    ``measure_kernel`` on CUDA tensors, :func:`measure_sums_plain` on CPU
    tensors."""
    if _on_cpu(a):
        return measure_sums_plain(a, b, q)
    check_int8(a, b)
    if a.dim() != 3:
        raise ValueError(f"state must be (R, ny, half), got "
                         f"{tuple(a.shape)}")
    nrep, ny, half = a.shape
    clock_pallas.check_launch(nrep, ny, half, q)
    tab = clock_pallas.device_table(q, a.device, torch.float64)
    partials = torch.empty((nrep, blocks(ny, half), 3), dtype=torch.float64,
                           device=a.device)
    obs = torch.empty((nrep, 3), dtype=torch.float64, device=a.device)
    lib = _lib()
    with torch.cuda.device(a.device):
        code = lib.clock_int8_measure(a.data_ptr(), b.data_ptr(),
                                      tab.data_ptr(), partials.data_ptr(),
                                      obs.data_ptr(), nrep, ny, half, q,
                                      _stream(a))
    raise_on(code, lib.clock_int8_measure_error_string,
             "clock measure_kernel")
    LAUNCHES["measure"] += 1
    return obs


def densities(sums: torch.Tensor, nsites: int) -> dict[str, torch.Tensor]:
    """{m, my, e} float64 densities of (..., 3) float64 sums."""
    return {k: per_site(sums[..., j], nsites)
            for j, k in enumerate(("m", "my", "e"))}


def measure(model, state: CheckerboardState) -> dict[str, torch.Tensor]:
    """{m, my, e} float64 densities (R,) of a replica batch (JAX
    ``measure``)."""
    return densities(measure_sums(*state, model.q), model.nsites)
