"""S int8 2-D Ising sweeps in one launch on the card: a CUDA kernel and its
plain version.

Port of ``cuda_fortran_mc_simulation_spin_tpu/ops/ising2d_multisweep.py``
(the module keeps its name so that its JAX counterpart is found by name;
it launches a CUDA kernel, not a Pallas one).
``csrc/ising2d_multisweep.cu`` ``multisweep_kernel`` replaces ``_kernel``
(pallas_call at ``:128``, ``_multisweep`` -> ``multisweep``): S full
sweeps (phase a, then phase b) of (R, ny, nx/2) int8 planes, in place, with
the exact (m, e) of every sweep fused into phase b as JAX's ``:84-90``
fuses them (m = Σ new + Σ o, e = -Σ new·nsum).  Sweep s, phase p draws the
words of ops/ising2d_pallas.py under ``seeds[s, p]``
(``multispin_rng.sweep_phase_keys``), so S sweeps equal S pairs of
``phase_kernel`` launches and the measure kernel, bitwise.

The route bound.  The TPU kernel keeps one replica in VMEM and JAX gates it
per replica (``fits_vmem``, a VMEM budget).  Here the planes stay in
device memory, and the runner takes this kernel while the batch's planes,
batch·nx·ny bytes, stay within ``MULTISWEEP_MAX_BYTES``: at or below it one
cooperative launch of S sweeps beats 3·S streamed launches (the host's
launch cost a sweep), above it the streamed phases win, as the bit-packed
route's ``_MS_BATCH_WORDS`` (ops/ising2d_multispin.py, ROADMAP B2).  The
constant is read on the card by ``chip_smoke.py`` (PERF.md §6).

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
from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
    _build,
    ising2d_measure_pallas,
    multispin_rng,
)
from cuda_fortran_mc_simulation_spin_tpu_torch.ops.ising2d_multispin import (
    _i32,
    _on_cpu,
    _stream,
)
from cuda_fortran_mc_simulation_spin_tpu_torch.ops.ising2d_pallas import (
    accept_thresholds_u32,
    check_int8,
    check_launch,
    phase_plain,
    raise_on,
)

# bytes of the batch's int8 planes (batch·nx·ny) up to which the runner
# takes this kernel (module docstring)
MULTISWEEP_MAX_BYTES = 32 << 20

LAUNCHES = {"multisweep": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def fits(batch: int, ny: int, half: int) -> bool:
    """The runner takes the multisweep kernel for ``batch`` replicas of
    (ny, half) colour planes."""
    return batch * ny * 2 * half <= MULTISWEEP_MAX_BYTES


def multisweep_plain(a: torch.Tensor, b: torch.Tensor, seeds, *,
                     beta: float):
    """Plain version of ``multisweep_kernel``: S = len(seeds) sweeps of
    (R, ny, half) int8 planes under the (S, 2, 2) keys; returns the new
    (a, b) and the (R, S, 2) int64 (m, e) fused into each phase b."""
    obs = []
    for s in range(seeds.shape[0]):
        a = phase_plain(a, b, seeds[s, 0], color=0, beta=beta)
        nsum = lattice.neighbor_sums(a.to(torch.int32), 1)
        b = phase_plain(b, a, seeds[s, 1], color=1, beta=beta)
        dims = (-2, -1)
        m = (b.sum(dim=dims, dtype=torch.int64)
             + a.sum(dim=dims, dtype=torch.int64))
        e = -(b.to(torch.int32) * nsum).sum(dim=dims, dtype=torch.int64)
        obs.append(torch.stack([m, e], dim=-1))
    return a, b, torch.stack(obs, dim=1)


def _lib() -> ctypes.CDLL:
    lib = _build.load("ising2d_multisweep")
    if lib.ising2d_int8_multisweep.argtypes is not None:
        return lib
    lib.ising2d_int8_multisweep.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_uint] * 2
        + [ctypes.c_void_p])
    lib.ising2d_int8_multisweep.restype = ctypes.c_int
    lib.ising2d_int8_multisweep_grid.argtypes = [
        ctypes.POINTER(ctypes.c_int)]
    lib.ising2d_int8_multisweep_grid.restype = ctypes.c_int
    lib.ising2d_int8_multisweep_error_string.argtypes = [ctypes.c_int]
    lib.ising2d_int8_multisweep_error_string.restype = ctypes.c_char_p
    return lib


def multisweep_planes(a: torch.Tensor, b: torch.Tensor, seeds, *,
                      beta: float):
    """S = len(seeds) sweeps under the (S, 2, 2) keys, updating the
    (R, ny, half) int8 planes ``a``, ``b`` in place: ``multisweep_kernel``
    (one launch) on CUDA tensors, :func:`multisweep_plain` on CPU tensors.
    Returns (a, b, obs), obs the (R, S, 2) int64 (m, e) of every sweep."""
    if _on_cpu(a):
        na, nb, obs = multisweep_plain(a, b, seeds, beta=beta)
        return a.copy_(na), b.copy_(nb), obs
    check_int8(a, b)
    nrep, ny, half = a.shape
    check_launch(nrep, ny, half)
    sweeps = int(seeds.shape[0])
    t4, t8 = accept_thresholds_u32(beta)
    seeds_dev = _i32(seeds).contiguous().to(a.device)
    # zeroed: the kernel adds each block's sums with an atomic
    obs = torch.zeros((nrep, sweeps, 2), dtype=torch.int64, device=a.device)
    lib = _lib()
    with torch.cuda.device(a.device):
        code = lib.ising2d_int8_multisweep(
            a.data_ptr(), b.data_ptr(), seeds_dev.data_ptr(), obs.data_ptr(),
            nrep, ny, half, sweeps, t4, t8, _stream(a))
    raise_on(code, lib.ising2d_int8_multisweep_error_string,
             "ising2d multisweep_kernel")
    LAUNCHES["multisweep"] += 1
    return a, b, obs


def grid_blocks() -> int:
    """Blocks of the cooperative grid on the current device."""
    lib = _lib()
    blocks = ctypes.c_int(0)
    raise_on(lib.ising2d_int8_multisweep_grid(ctypes.byref(blocks)),
             lib.ising2d_int8_multisweep_error_string,
             "ising2d_int8_multisweep_grid")
    return blocks.value


def multisweep(model, state: CheckerboardState, key, sweeps: int,
               t0: int = 0):
    """Advance ``sweeps`` MCS of a replica batch (R, ny, half) in place,
    with per-sweep {m, e} densities (R, sweeps) float64; ``key`` is the
    sample key and ``t0`` the global sweep index already completed (JAX
    ``multisweep``)."""
    a, b, obs = multisweep_planes(
        state.a, state.b, multispin_rng.sweep_phase_keys(key, sweeps, t0),
        beta=model.beta)
    return CheckerboardState(a, b), ising2d_measure_pallas.densities(
        obs, model.nsites)
