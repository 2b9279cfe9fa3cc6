"""The int8 3-D Ising checkerboard phase on the card: a CUDA kernel and its
plain version.

Port of ``cuda_fortran_mc_simulation_spin_tpu/ops/ising3d_pallas.py``
(the module keeps its name so that its JAX counterpart is found by name;
it launches a CUDA kernel, not a Pallas one).  ``csrc/ising3d_pallas.cu``
``phase_kernel`` replaces ``_phase_kernel`` (pallas_call at ``:85``,
``_metropolis_phase``): one colour phase of (R, nz, ny, nx/2) int8 ±1
volumes (colour (x+y+z) & 1, core/lattice.py), in place: six neighbours,
and with k = s·Σ₆nbr flip iff k <= 0 or word < t_k, (t4, t8, t12) =
``core/tables.ising3d_accept_thresholds_u32``.  Every even nx, ny, nz.

Random words: those of ops/ising2d_pallas.py with the row index
z·ny + y (:func:`ising2d_pallas.draw_words` over nz·ny rows).

A wrapper takes the plain version for a CPU tensor; for a CUDA tensor it
launches the kernel or raises.  ``LAUNCHES`` counts launches.
"""

from __future__ import annotations

import ctypes

import torch

from cuda_fortran_mc_simulation_spin_tpu_torch.core import lattice, tables
from cuda_fortran_mc_simulation_spin_tpu_torch.models.base import (
    CheckerboardState,
)
from cuda_fortran_mc_simulation_spin_tpu_torch.ops import _build
from cuda_fortran_mc_simulation_spin_tpu_torch.ops.ising2d_multispin import (
    _on_cpu,
    _stream,
)
from cuda_fortran_mc_simulation_spin_tpu_torch.ops.ising2d_pallas import (
    as_words,
    batched,
    check_int8,
    check_launch,
    draw_words,
    flip,
    phase_seeds,
    raise_on,
    seed_words,
)

LAUNCHES = {"phase": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def phase_plain(x: torch.Tensor, other: torch.Tensor, seeds=None, *,
                color: int, beta: float, bits: torch.Tensor | None = None
                ) -> torch.Tensor:
    """Plain version of ``phase_kernel``: the new (R, nz, ny, half) int8
    colour volume ``x`` given the other colour, with the words of
    ``draw_words`` under ``seeds`` or the injected int32 ``bits``."""
    nrep, nz, ny, half = x.shape
    words = (as_words(bits) if bits is not None
             else draw_words(seeds, nrep, nz * ny, half, x.device
                             ).reshape(x.shape))
    nsum = lattice.neighbor_sums3d(other.to(torch.int32), color)
    return flip(x, nsum, words, tables.ising3d_accept_thresholds_u32(beta))


def _lib() -> ctypes.CDLL:
    lib = _build.load("ising3d_pallas")
    if lib.ising3d_int8_phase.argtypes is not None:
        return lib
    lib.ising3d_int8_phase.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_uint] * 5
        + [ctypes.c_void_p])
    lib.ising3d_int8_phase.restype = ctypes.c_int
    lib.ising3d_int8_error_string.argtypes = [ctypes.c_int]
    lib.ising3d_int8_error_string.restype = ctypes.c_char_p
    return lib


def metropolis_phase(x: torch.Tensor, other: torch.Tensor, seeds=None, *,
                     color: int, beta: float,
                     bits: torch.Tensor | None = None) -> torch.Tensor:
    """One colour phase of (R, nz, ny, half) int8 volumes, updating ``x``
    in place (returned): ``phase_kernel`` on CUDA tensors,
    :func:`phase_plain` on CPU tensors."""
    if _on_cpu(x):
        return x.copy_(phase_plain(x, other, seeds, color=color, beta=beta,
                                   bits=bits))
    check_int8(x, other, bits=bits)
    nrep, nz, ny, half = x.shape
    check_launch(nrep, nz * ny, half)
    t4, t8, t12 = tables.ising3d_accept_thresholds_u32(beta)
    s0, s1 = (0, 0) if seeds is None else seed_words(seeds)
    lib = _lib()
    with torch.cuda.device(x.device):
        code = lib.ising3d_int8_phase(
            x.data_ptr(), other.data_ptr(),
            None if bits is None else bits.data_ptr(), nrep, nz, ny, half,
            color, s0, s1, t4, t8, t12, _stream(x))
    raise_on(code, lib.ising3d_int8_error_string, "ising3d phase_kernel")
    LAUNCHES["phase"] += 1
    return x


def sweep_seeded(model, state: CheckerboardState, seeds
                 ) -> CheckerboardState:
    """One 3-D MCS under the sweep's (2, 2) phase keys, in place."""
    a, b = batched(state, 3)
    metropolis_phase(a, b, seeds[0], color=0, beta=model.beta)
    metropolis_phase(b, a, seeds[1], color=1, beta=model.beta)
    return state


def sweep(model, state: CheckerboardState, key) -> CheckerboardState:
    """One 3-D MCS under the sweep key ``key`` on (nz, ny, half) or
    (R, nz, ny, half) int8 arrays, in place (JAX ``sweep``)."""
    return sweep_seeded(model, state, phase_seeds(key))
