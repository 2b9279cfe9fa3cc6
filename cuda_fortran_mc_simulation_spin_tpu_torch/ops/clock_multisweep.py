"""S int8 q-state clock sweeps in one launch on the card: a CUDA kernel and
its plain version.

Port of ``cuda_fortran_mc_simulation_spin_tpu/ops/clock_multisweep.py``
(the module keeps its name so that its JAX counterpart is found by name;
it launches a CUDA kernel, not a Pallas one).  ``csrc/clock_multisweep.cu``
``multisweep_kernel`` replaces ``_kernel`` (pallas_call at ``:127``,
``_multisweep`` -> ``multisweep``): S full sweeps (phase a, then phase b)
of (R, ny, nx/2) int8 states, in place, with each sweep's (Σ cos, Σ sin,
E) fused into phase b as JAX's ``:87-95`` fuses them (Σ over both colours'
(cos, sin), E = −Σ_b S_new·h, each a-b bond once).  Sweep s, phase p
draws the words of ops/clock_pallas.py under ``seeds[s, p]``
(``multispin_rng.sweep_phase_keys``), so S sweeps equal S pairs of
``phase_kernel`` launches bitwise in the state, and their sums equal the
measure kernel's to float64 rounding (another order of the same float64
terms).

The route bound.  The TPU kernel keeps one replica in VMEM and JAX gates it
per replica (``ising2d_multisweep.fits_vmem``, a VMEM budget).  Here the
planes stay in device memory, and the runner takes this kernel while the
batch's planes, batch·nx·ny bytes, stay within ``MULTISWEEP_MAX_BYTES``:
at or below it one cooperative launch of S sweeps beats 3·S streamed
launches.  The value is the int8 Ising engine's
(ops/ising2d_multisweep.py); ``chip_smoke.py`` reads both routes for the
clock at q = 6, and on an H100 (700 W) streamed/multisweep read 4.82 at
1000^2 x 1 (1 MiB), 1.68 at 1000^2 x 16 (15.3 MiB), 1.76 at 2000^2 x 8
(30.5 MiB) and 1.72 at 2000^2 x 16 (61 MiB, over the bound): since the
kernel's tiles the multisweep wins above the bound too, where the first
design tied from ~15 MiB up (PERF.md §6; raising the bound is ROADMAP
B13's).

The kernel takes tiles of whole rows of one replica, or chunks of a row
past ``CHUNK_COLS`` columns, staged in shared memory from the 16-B
aligned vectors that cover each of a tile's four byte ranges, four sites
a thread a step; :func:`ms_tiles` computes its launch constants (the
kernel takes them as passed; they are the int8 Ising multisweep's,
ops/ising2d_multisweep.py), and
``tests/test_torch_clock_int8_ms_tiles.py`` replays that launch on the
CPU.

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
    clock_measure_pallas,
    clock_pallas,
    multispin_rng,
)
from cuda_fortran_mc_simulation_spin_tpu_torch.ops.ising2d_multispin import (
    _i32,
    _on_cpu,
    _stream,
)
# the tiles are the int8 Ising multisweep's (its constants and check
# re-exported: the tests replay this launch from them)
from cuda_fortran_mc_simulation_spin_tpu_torch.ops.ising2d_multisweep import (
    CHUNK_COLS,  # noqa: F401
    MIN_LUX,  # noqa: F401
    THREADS,  # noqa: F401
    _tiles_arg,
    check_ms_tiles,  # noqa: F401
    ms_tiles,
)
from cuda_fortran_mc_simulation_spin_tpu_torch.ops.ising2d_pallas import (
    check_int8,
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


def fused_sums(a: torch.Tensor, b: torch.Tensor, q: int) -> torch.Tensor:
    """(R, 3) float64 sums fused into a phase b, from the final planes:
    Σ cos and Σ sin of both colours and E = −Σ_b S·h, h the b sites'
    float64 neighbour sums in the kernel's order (up + dn) + (o + side)."""
    ca, sa = clock_measure_pallas.gather64(a, q)
    cb, sb = clock_measure_pallas.gather64(b, q)
    hx = lattice.neighbor_sums(ca, 1)
    hy = lattice.neighbor_sums(sa, 1)
    dims = (-2, -1)
    return torch.stack([ca.sum(dim=dims) + cb.sum(dim=dims),
                        sa.sum(dim=dims) + sb.sum(dim=dims),
                        -(cb * hx + sb * hy).sum(dim=dims)], dim=-1)


def multisweep_plain(a: torch.Tensor, b: torch.Tensor, seeds, *, q: int,
                     beta: float):
    """Plain version of ``multisweep_kernel``: S = len(seeds) sweeps of
    (R, ny, half) int8 planes under the (S, 2, 2) keys; returns the new
    (a, b) and the (R, S, 3) float64 sums fused into each phase b."""
    obs = []
    for s in range(seeds.shape[0]):
        a = clock_pallas.phase_plain(a, b, seeds[s, 0], color=0, q=q,
                                     beta=beta)
        b = clock_pallas.phase_plain(b, a, seeds[s, 1], color=1, q=q,
                                     beta=beta)
        obs.append(fused_sums(a, b, q))
    return a, b, torch.stack(obs, dim=1)


def _lib() -> ctypes.CDLL:
    lib = _build.load("clock_multisweep")
    if lib.clock_int8_multisweep.argtypes is not None:
        return lib
    tiles = ctypes.POINTER(ctypes.c_int)
    lib.clock_int8_multisweep.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
        + [ctypes.c_float, tiles, ctypes.c_void_p])
    lib.clock_int8_multisweep.restype = ctypes.c_int
    lib.clock_int8_multisweep_grid.argtypes = [
        tiles, ctypes.POINTER(ctypes.c_int)]
    lib.clock_int8_multisweep_grid.restype = ctypes.c_int
    lib.clock_int8_multisweep_error_string.argtypes = [ctypes.c_int]
    lib.clock_int8_multisweep_error_string.restype = ctypes.c_char_p
    return lib


def multisweep_planes(a: torch.Tensor, b: torch.Tensor, seeds, *, q: int,
                      beta: float):
    """S = len(seeds) sweeps under the (S, 2, 2) keys, updating the
    (R, ny, half) int8 planes ``a``, ``b`` in place: ``multisweep_kernel``
    (one launch) on CUDA tensors, :func:`multisweep_plain` on CPU tensors.
    Returns (a, b, obs), obs the (R, S, 3) float64 (Σ cos, Σ sin, E) of
    every sweep."""
    if _on_cpu(a):
        na, nb, obs = multisweep_plain(a, b, seeds, q=q, beta=beta)
        return a.copy_(na), b.copy_(nb), obs
    check_int8(a, b)
    nrep, ny, half = a.shape
    clock_pallas.check_launch(nrep, ny, half, q)
    sweeps = int(seeds.shape[0])
    dev = a.device
    seeds_dev = _i32(seeds).contiguous().to(dev)
    tab = clock_pallas.device_table(q, dev)
    tab64 = clock_pallas.device_table(q, dev, torch.float64)
    tiles = ms_tiles(nrep, ny, half)
    partials = torch.empty((nrep, sweeps, tiles["nty"] * tiles["nch"], 3),
                           dtype=torch.float64, device=dev)
    obs = torch.empty((nrep, sweeps, 3), dtype=torch.float64, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        code = lib.clock_int8_multisweep(
            a.data_ptr(), b.data_ptr(), seeds_dev.data_ptr(),
            tab.data_ptr(), tab64.data_ptr(), partials.data_ptr(),
            obs.data_ptr(), nrep, ny, half, q, sweeps, -float(beta),
            _tiles_arg(nrep, ny, half), _stream(a))
    raise_on(code, lib.clock_int8_multisweep_error_string,
             "clock multisweep_kernel")
    LAUNCHES["multisweep"] += 1
    return a, b, obs


def grid_blocks(nrep: int, ny: int, half: int) -> int:
    """Blocks of the cooperative grid on the current device for (nrep, ny,
    half) planes (the tiles' shared memory sets it)."""
    lib = _lib()
    blocks = ctypes.c_int(0)
    raise_on(lib.clock_int8_multisweep_grid(_tiles_arg(nrep, ny, half),
                                            ctypes.byref(blocks)),
             lib.clock_int8_multisweep_error_string,
             "clock_int8_multisweep_grid")
    return blocks.value


def multisweep(model, state: CheckerboardState, key, sweeps: int,
               t0: int = 0):
    """Advance ``sweeps`` MCS of a replica batch (R, ny, half) in place,
    with per-sweep {m, my, e} densities (R, sweeps) float64; ``key`` is the
    sample key and ``t0`` the global sweep index already completed (JAX
    ``multisweep``)."""
    a, b, obs = multisweep_planes(
        state.a, state.b, multispin_rng.sweep_phase_keys(key, sweeps, t0),
        q=model.q, beta=model.beta)
    return CheckerboardState(a, b), clock_measure_pallas.densities(
        obs, model.nsites)
