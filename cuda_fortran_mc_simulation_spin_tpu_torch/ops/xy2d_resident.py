"""S Metropolis sweeps of the periodic XY model in one launch on the card:
a cooperative CUDA kernel and its plain version.

Port of ``cuda_fortran_mc_simulation_spin_tpu/ops/xy2d_resident.py`` (the
module keeps its name so that its JAX counterpart is found by name; it
launches a CUDA kernel, not a Pallas one).  ``csrc/xy2d_resident.cu``
``multisweep_kernel`` replaces

- ``_ms_kernel`` (pallas_call at ``:257``, ``multisweep``): S sweeps of
  the (R, ny, nx/2) float32 component planes with each sweep's
  (Σ S_x, Σ S_y, e, A) fused into its phase b, A against the t=0
  snapshot;
- ``_phase_bits_kernel`` (``:163``, ``phase_with_bits``): in its injected
  mode, one phase with injected uniforms.

The JAX kernel holds state and snapshot in VMEM and pads nx/2 to 128
lanes with seam substitutions; here the planes stay unpadded in device
memory (the literal 1500x1500's 750 columns included) and a cooperative
grid waits at a grid barrier between phases.  What the launch saves on
the card is the host's cost of S streamed sweeps; :func:`fits` is the
route bound between the two (PERF.md §6).

Keys: the (S, 2, 2) phase keys of ``multispin_rng.sweep_phase_keys`` and
the counter (replica, row, column, 0) of ``metropolis_kernel``, so S
sweeps here equal S streamed ``xy2d_pallas.sweep_measure`` calls bitwise
in the state, and in the sums too (each 256-site item is one block of the
streamed launch, reduced in the same fixed order).
:func:`multisweep_planes_plain` is the plain version: S plain streamed
sweeps.

A wrapper takes the plain version for a CPU tensor; for a CUDA tensor it
launches the kernel or raises.  ``LAUNCHES`` counts launches.
"""

from __future__ import annotations

import ctypes

import torch

from cuda_fortran_mc_simulation_spin_tpu_torch.models.xy2d import XYState
from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
    _build,
    multispin_rng,
    xy2d_pallas,
)
from cuda_fortran_mc_simulation_spin_tpu_torch.ops.ising2d_multispin import (
    _i32,
    _on_cpu,
    _stream,
)

LAUNCHES = {"multisweep": 0, "phase_bits": 0}

# The route bound: batches of at most this many sites (replicas x nx x ny)
# run the resident multisweep, larger ones streamed sweep_measure calls.
# Set at the crossover that chip_smoke.py phase 5 measures (PERF.md §6).
RESIDENT_MAX_SITES = 3 * 1500 * 1500


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def fits(model, batch: int) -> bool:
    """True when the resident multisweep is the route for ``batch``
    replicas of ``model``."""
    return batch * model.nsites <= RESIDENT_MAX_SITES


def _snap_order(snap: XYState, color: int):
    """Snapshot planes in a phase's (sx, sy, ox, oy) order."""
    return ((snap.ax, snap.ay, snap.bx, snap.by) if color == 0
            else (snap.bx, snap.by, snap.ax, snap.ay))


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def multisweep_planes_plain(st: XYState, snap: XYState | None, seeds, *,
                            beta: float) -> torch.Tensor:
    """Plain version of ``multisweep_kernel``: S = len(seeds) streamed
    plain sweeps of ``st`` in place; returns the (R, S, 4) float64
    per-sweep sums (A = 0 without a snapshot)."""
    ax, ay, bx, by = st
    rows = []
    for s in range(seeds.shape[0]):
        xy2d_pallas.metropolis_phase_plain(ax, ay, bx, by, seeds[s, 0],
                                           color=0, beta=beta)
        if snap is None:
            _, _, obs = xy2d_pallas.metropolis_phase_plain(
                bx, by, ax, ay, seeds[s, 1], color=1, beta=beta,
                measuring=True)
            obs = torch.cat([obs, torch.zeros_like(obs[:, :1])], dim=1)
        else:
            _, _, obs = xy2d_pallas.metropolis_phase_plain(
                bx, by, ax, ay, seeds[s, 1], color=1, beta=beta,
                snap=_snap_order(snap, 1))
        rows.append(obs)
    return torch.stack(rows, dim=1)


def phase_with_bits_plain(sx, sy, ox, oy, u_cand, u_acc, *, color: int,
                          beta: float):
    """Plain version of the injected mode: one phase with injected
    uniforms, in place (``xy2d_pallas.metropolis_phase_plain``)."""
    return xy2d_pallas.metropolis_phase_plain(sx, sy, ox, oy,
                                              (u_cand, u_acc), color=color,
                                              beta=beta)


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

_VOID = ctypes.c_void_p
_INT = ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = _build.load("xy2d_resident")
    if lib.xy_multisweep.argtypes is not None:
        return lib
    lib.xy_multisweep.argtypes = ([_VOID] * 10 + [_INT] * 5
                                  + [ctypes.c_float, _VOID])
    lib.xy_multisweep.restype = _INT
    lib.xy_multisweep_grid.argtypes = [ctypes.POINTER(_INT)]
    lib.xy_multisweep_grid.restype = _INT
    lib.xy_multisweep_error_string.argtypes = [_INT]
    lib.xy_multisweep_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(code: int, lib) -> None:
    if code != 0:
        msg = lib.xy_multisweep_error_string(code).decode()
        raise RuntimeError(f"xy2d multisweep_kernel: CUDA error {code} "
                           f"({msg})")


def grid_blocks() -> int:
    """Blocks of the cooperative grid on the current device."""
    lib = _lib()
    out = _INT(0)
    _raise_on(lib.xy_multisweep_grid(ctypes.byref(out)), lib)
    return out.value


def _launch(st, snap, seeds, ucand, uacc, sweeps, color, beta,
            measuring):
    planes = list(st) + ([] if snap is None else list(snap))
    extra = [] if ucand is None else [ucand, uacc]
    xy2d_pallas._check_planes(*planes, *extra)
    nrep, ny, half = st.ax.shape
    dev = st.ax.device
    seeds_dev = None
    if seeds is not None:
        seeds_dev = _i32(torch.as_tensor(seeds)).contiguous().to(dev)
    partials = obs = None
    if measuring:
        partials, obs = xy2d_pallas.scratch(st.ax, True, rows=nrep * sweeps)
    lib = _lib()
    ptr = xy2d_pallas._ptr
    with torch.cuda.device(dev):
        code = lib.xy_multisweep(
            *(p.data_ptr() for p in st), xy2d_pallas.snapshot_pointers(snap),
            ptr(seeds_dev), ptr(ucand), ptr(uacc), ptr(partials), ptr(obs),
            nrep, ny, half, sweeps, color, -float(beta), _stream(st.ax))
    _raise_on(code, lib)
    return obs


def multisweep_planes(st: XYState, snap: XYState | None, seeds, *,
                      beta: float) -> torch.Tensor:
    """S = len(seeds) sweeps of ``st`` in place under the (S, 2, 2)
    per-(sweep, phase) keys: ``multisweep_kernel`` on CUDA tensors,
    :func:`multisweep_planes_plain` on CPU tensors.  Returns the (R, S, 4)
    float64 per-sweep (Σ S_x, Σ S_y, e, A)."""
    if _on_cpu(st.ax):
        return multisweep_planes_plain(st, snap, seeds, beta=beta)
    sweeps = int(seeds.shape[0])
    obs = _launch(st, snap, seeds, None, None, sweeps, 0, beta, True)
    LAUNCHES["multisweep"] += 1
    return obs.view(st.ax.shape[0], sweeps, xy2d_pallas.NSUMS)


def phase_with_bits(sx, sy, ox, oy, u_cand, u_acc, *, color: int,
                    beta: float):
    """One phase of colour ``color`` with injected uniforms, in place: the
    kernel's injected mode on CUDA tensors (JAX ``phase_with_bits``),
    :func:`phase_with_bits_plain` on CPU tensors.  Returns (sx, sy)."""
    if _on_cpu(sx):
        return phase_with_bits_plain(sx, sy, ox, oy, u_cand, u_acc,
                                     color=color, beta=beta)
    st = (XYState(sx, sy, ox, oy) if color == 0
          else XYState(ox, oy, sx, sy))
    _launch(st, None, None, u_cand, u_acc, 1, color, beta, False)
    LAUNCHES["phase_bits"] += 1
    return sx, sy


def multisweep(model, st: XYState, snap: XYState | None, key, sweeps: int,
               t0: int = 0):
    """Sweeps t0+1 .. t0+sweeps of the sample keyed by ``key`` on
    (R, ny, half) planes, in place: returns (st, {mx, my, e, A} densities
    (R, sweeps) float64) (JAX ``multisweep``, keyed by the global sweep
    index)."""
    seeds = multispin_rng.sweep_phase_keys(key, sweeps, t0)
    obs = multisweep_planes(st, snap, seeds, beta=model.beta)
    return st, xy2d_pallas.densities(model, obs)
