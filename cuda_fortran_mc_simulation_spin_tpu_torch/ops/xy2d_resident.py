"""S Metropolis sweeps of the periodic XY model in one launch on the card:
a cooperative CUDA kernel in two modes, and its plain version.

Port of ``cuda_fortran_mc_simulation_spin_tpu/ops/xy2d_resident.py`` (the
module keeps its name so that its JAX counterpart is found by name; it
launches a CUDA kernel, not a Pallas one).  ``_ms_kernel`` (pallas_call
at ``:257``, ``multisweep``): S sweeps of the (R, ny, nx/2) float32
component planes with each sweep's (Σ S_x, Σ S_y, e, A) fused into its
phase b, A against the t=0 snapshot.  ``csrc/xy2d_resident.cu`` holds it
in two modes, each replica a ring of blocks with flags between phases
(``csrc/xy2d_ring.cuh``):

- ``smem_multisweep_kernel``, where the batch fits the grid's shared
  memory (:func:`smem_layout`; one 1500x1500 or 1000x1000 replica, up to
  ~3.4 M sites on the H100): the lattice held in the SMs' shared memory
  for the S sweeps;
- ``gmem_multisweep_kernel``, past the fit (:func:`gmem_layout`; under
  the route bound :data:`RESIDENT_MAX_SITES`, e.g. 1500x1500 x 2 or x 3,
  1000x1000 x 4-6, 512x512 x 25): the planes in device memory, updated in
  place, a block holding as many of the chunks no neighbour reads in
  shared memory as fit; where there are more replicas than block slots
  (64x64 x 1600, 32x32 x 6000) each block is a ring of one and takes
  whole replicas in turn.  ``multisweep_planes(..., grid=True)`` forces
  it.

JAX's ``_phase_bits_kernel`` (``:163``, ``phase_with_bits``: one phase
with injected uniforms) is the injected mode of ``metropolis_kernel``:
:func:`phase_with_bits` launches it through ``xy2d_pallas``.

The JAX kernel holds state and snapshot in VMEM and pads nx/2 to 128
lanes with seam substitutions; here the planes stay unpadded (the literal
1500x1500's 750 columns included).  What one launch saves on the card is
the host's cost of S streamed sweeps; :func:`fits` is the route bound
between the two (PERF.md §6).

Keys: the (S, 2, 2) phase keys of ``multispin_rng.sweep_phase_keys`` and
the counter (replica, row, column, 0) of ``metropolis_kernel``, so S
sweeps here, in either mode, equal S streamed
``xy2d_pallas.sweep_measure`` calls bitwise in the state, and in the sums
too (each 256-site chunk is one block of the streamed launch, reduced in
the same fixed order).  :func:`multisweep_planes_plain` is the plain
version: S plain streamed sweeps.

A wrapper takes the plain version for a CPU tensor; for a CUDA tensor it
launches the kernel or raises.  ``LAUNCHES`` counts launches, the
device-memory mode under ``"multisweep"``.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

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

LAUNCHES = {"multisweep": 0, "multisweep_smem": 0}

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


# the sites of a chunk: one block of the streamed metropolis_kernel
CHUNK = 256
# shared memory a chunk takes beside its sites in a ring block
# (csrc/xy2d_ring.cuh CHUNK_BYTES): its 8 warps' 4 float64 sums and its
# first site's (row, column)
CHUNK_BYTES = 4 * 8 * 8 + 8


class SmemLayout(NamedTuple):
    """The ring of ``smem_multisweep_kernel``: ``blocks`` blocks a replica,
    block j owning chunks ``bounds[j]`` .. ``bounds[j + 1] - 1`` of 256
    sites, at most ``cap`` sites a block, in ``smem_bytes`` of shared
    memory a block."""
    blocks: int
    bounds: tuple[int, ...]
    cap: int
    smem_bytes: int


def ring_bounds(nrep: int, ny: int, half: int,
                sms: int) -> tuple[int, tuple[int, ...], int] | None:
    """The ring of a shared-memory multisweep (``csrc/xy2d_ring.cuh``; this
    module's and ``xy2d_multisweep``'s) for ``nrep`` replicas of (ny,
    half) sites a colour on ``sms`` block slots: (blocks a ring, bounds,
    cap), or None where no ring of one block a replica fits.

    Each replica gets its own ring of ``sms // nrep`` blocks at most, each
    owning a contiguous run of whole chunks, as even as the chunks allow;
    the ring shrinks until every block owns at least ``half`` real sites,
    so a block's halos (the other colour's ``half`` sites before and after
    its range) lie in its two ring neighbours' ranges; ``cap`` is the most
    sites a block owns, in whole chunks."""
    n = ny * half
    chunks = -(-n // CHUNK)
    per = sms // nrep
    if per < 1:
        return None
    nb = min(per, chunks)
    while True:
        bounds = tuple(j * chunks // nb for j in range(nb + 1))
        owned = [min(b * CHUNK, n) - a * CHUNK
                 for a, b in zip(bounds, bounds[1:])]
        if min(owned) >= half or nb == 1:
            break
        nb -= 1
    return nb, bounds, max(b - a for a, b in zip(bounds, bounds[1:])) * CHUNK


def smem_layout(nrep: int, ny: int, half: int, sms: int,
                smem_bytes: int) -> SmemLayout | None:
    """The fit rule of the two modes: the ring layout of
    ``smem_multisweep_kernel`` (:func:`ring_bounds`) for ``nrep`` replicas
    of (ny, half) sites a colour, on ``sms`` block slots (SMs x blocks an
    SM) of at most ``smem_bytes`` shared memory each; None where the batch
    does not fit (then ``gmem_multisweep_kernel`` runs it).  A block's shared
    memory: its sites and both halos in both colours, (cap + 2 half) x
    2 colours x 8 B, and 264 B a chunk (its warps' sums, its first
    site)."""
    ring = ring_bounds(nrep, ny, half, sms)
    if ring is None:
        return None
    nb, bounds, cap = ring
    need = 16 * (cap + 2 * half) + cap // CHUNK * CHUNK_BYTES
    if need > smem_bytes:
        return None
    return SmemLayout(nb, bounds, cap, need)


class GmemLayout(NamedTuple):
    """The rings of ``gmem_multisweep_kernel``: ``rings`` rings of
    ``blocks`` blocks at once, ring t taking replicas t, t + rings, ... in
    turn; block j of a ring owning chunks ``bounds[j]`` .. ``bounds[j + 1]
    - 1`` of 256 sites, at most ``cap`` sites, of which it holds at most
    ``hold`` chunks in shared memory, in ``smem_bytes`` of shared memory a
    block (its chunks' sums and first sites, its held sites)."""
    blocks: int
    bounds: tuple[int, ...]
    cap: int
    rings: int
    hold: int
    smem_bytes: int


# shared memory a held chunk takes (csrc/xy2d_resident.cu HELD_BYTES): its
# 256 sites of both colours as float2
HELD_BYTES = 2 * CHUNK * 8


def gmem_layout(nrep: int, ny: int, half: int, slots: int,
                smem_bytes: int) -> GmemLayout | None:
    """The rule of the device-memory mode for ``nrep`` replicas of (ny,
    half) sites a colour on ``slots`` block slots of at most
    ``smem_bytes`` shared memory each: :func:`ring_bounds`' rings, one a
    replica, where the replicas fit the slots; past that, every slot a
    ring of one block (the whole replica) taking replicas in turn.  A
    block holds as many of its chunks in shared memory as the rest of
    ``smem_bytes`` takes, beside its sums (264 B a chunk); None where the
    sums alone pass it (past ~880 chunks a block, far past the route
    bound)."""
    live = min(nrep, slots)
    nb, bounds, cap = ring_bounds(live, ny, half, slots)
    need = cap // CHUNK * CHUNK_BYTES
    if need > smem_bytes:
        return None
    hold = min(cap // CHUNK, (smem_bytes - need) // HELD_BYTES)
    return GmemLayout(nb, bounds, cap, min(nrep, slots // nb), hold,
                      need + hold * HELD_BYTES)


def _snap_order(snap: XYState, color: int):
    """Snapshot planes in a phase's (sx, sy, ox, oy) order."""
    return ((snap.ax, snap.ay, snap.bx, snap.by) if color == 0
            else (snap.bx, snap.by, snap.ax, snap.ay))


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def multisweep_planes_plain(st: XYState, snap: XYState | None, seeds, *,
                            beta: float) -> torch.Tensor:
    """Plain version of both modes: S = len(seeds) streamed
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
    """Plain version of :func:`phase_with_bits`: one phase with injected
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
    return bind(_build.load("xy2d_resident"))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` (a build of ``csrc/xy2d_resident.cu``) with its C functions'
    argument types set."""
    if lib.xy_multisweep_gmem.argtypes is not None:
        return lib
    lib.xy_multisweep_gmem.argtypes = ([_VOID] * 10 + [_INT] * 9
                                       + [ctypes.c_float, _VOID])
    lib.xy_multisweep_smem.argtypes = ([_VOID] * 11 + [_INT] * 7
                                       + [ctypes.c_float, _VOID])
    for fn in (lib.xy_multisweep_gmem, lib.xy_multisweep_smem):
        fn.restype = _INT
    for fn in (lib.xy_multisweep_smem_limits, lib.xy_multisweep_gmem_limits):
        fn.argtypes = [ctypes.POINTER(_INT)] * 5
        fn.restype = _INT
    lib.xy_multisweep_error_string.argtypes = [_INT]
    lib.xy_multisweep_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(code: int, lib, name: str = "gmem_multisweep_kernel") -> None:
    if code != 0:
        msg = lib.xy_multisweep_error_string(code).decode()
        raise RuntimeError(f"xy2d {name}: CUDA error {code} ({msg})")


_LIMITS: dict[tuple, tuple[int, int]] = {}


def _limits(dev: torch.device, mode: str) -> tuple[int, int]:
    lib = _lib()
    key = (id(lib), dev.index, mode)
    if key not in _LIMITS:
        name = f"{mode}_multisweep_kernel"
        with torch.cuda.device(dev):
            _LIMITS[key] = read_limits(
                getattr(lib, f"xy_multisweep_{mode}_limits"),
                lambda code: _raise_on(code, lib, name), name)
    return _LIMITS[key]


def smem_limits(dev: torch.device) -> tuple[int, int]:
    """(block slots, shared memory a block) of ``smem_multisweep_kernel``
    on CUDA device ``dev``: the SMs times the blocks an SM holds by the
    kernel's threads and registers (one of 1024 threads on the H100), and
    the shared memory each of them may take."""
    return _limits(dev, "smem")


def gmem_limits(dev: torch.device) -> tuple[int, int]:
    """The same of ``gmem_multisweep_kernel``, for :func:`gmem_layout`."""
    return _limits(dev, "gmem")


def read_limits(limits_fn, raise_on, name: str) -> tuple[int, int]:
    """(block slots, shared memory a block) on the current device from a
    ring kernel's C limits function (``csrc/xy2d_ring.cuh``
    ``ring::smem_limits``: SMs, blocks an SM, the opt-in shared memory a
    block, an SM's, the runtime's reserve a block); ``raise_on`` raises on
    its error code."""
    vals = [_INT(0) for _ in range(5)]
    raise_on(limits_fn(*(ctypes.byref(v) for v in vals)))
    sms, per_sm, smem_block, smem_sm, reserved = (v.value for v in vals)
    if per_sm < 1:
        raise RuntimeError(f"{name}: no block fits an SM")
    return sms * per_sm, min(smem_block, smem_sm // per_sm - reserved)


def device_layout(st: XYState) -> SmemLayout | None:
    """:func:`smem_layout` of ``st``'s planes on their CUDA device."""
    return smem_layout(*st.ax.shape, *smem_limits(st.ax.device))


def device_gmem_layout(st: XYState) -> GmemLayout | None:
    """:func:`gmem_layout` of ``st``'s planes on their CUDA device."""
    return gmem_layout(*st.ax.shape, *gmem_limits(st.ax.device))


# (library, device, planes' shape, grid) -> the launch's mode ("multisweep"
# for the device-memory one, LAUNCHES' key), its layout and its bounds on
# the device: worked out once a shape, since a copy to the card from
# pageable host memory waits for the card, and the runner's next launch
# would wait behind it
_RINGS: dict[tuple, tuple[str, NamedTuple, torch.Tensor]] = {}


def _ring(st: XYState, grid: bool) -> tuple[str, NamedTuple, torch.Tensor]:
    key = (id(_lib()), st.ax.device, tuple(st.ax.shape), grid)
    if key not in _RINGS:
        mode, layout = "multisweep_smem", None if grid else device_layout(st)
        if layout is None:
            mode, layout = "multisweep", device_gmem_layout(st)
        if layout is None:
            raise RuntimeError(
                f"xy2d gmem_multisweep_kernel: no layout for planes of shape "
                f"{tuple(st.ax.shape)} (a block's sums pass its shared "
                "memory)")
        _RINGS[key] = (mode, layout, torch.tensor(
            layout.bounds, dtype=torch.int32, device=st.ax.device))
    return _RINGS[key]


def _launch(st, snap, seeds, beta, ring):
    """One launch in the mode of ``ring`` (:func:`_ring`); returns the
    (R S, 4) float64 sums."""
    planes = list(st) + ([] if snap is None else list(snap))
    xy2d_pallas._check_planes(*planes)
    nrep, ny, half = st.ax.shape
    sweeps = int(seeds.shape[0])
    dev = st.ax.device
    # staged at once, so the host need not wait for the card's queue
    seeds_dev = _i32(torch.as_tensor(seeds)).contiguous().to(
        dev, non_blocking=True)
    partials, obs = xy2d_pallas.scratch(st.ax, True, rows=nrep * sweeps)
    lib = _lib()
    args = (*(p.data_ptr() for p in st), xy2d_pallas.snapshot_pointers(snap),
            seeds_dev.data_ptr(), partials.data_ptr(), obs.data_ptr())
    mode, layout, bounds = ring
    with torch.cuda.device(dev):
        if mode == "multisweep":
            flags = torch.empty((layout.rings * layout.blocks,),
                                dtype=torch.int32, device=dev)
            code = lib.xy_multisweep_gmem(
                *args, bounds.data_ptr(), flags.data_ptr(), nrep, ny, half,
                sweeps, layout.blocks, layout.rings, layout.cap, layout.hold,
                layout.smem_bytes, -float(beta), _stream(st.ax))
            _raise_on(code, lib)
            return obs
        blocks = nrep * layout.blocks
        edges = torch.empty((blocks, 2, 2 * half, 2), dtype=torch.float32,
                            device=dev)
        flags = torch.empty((blocks,), dtype=torch.int32, device=dev)
        code = lib.xy_multisweep_smem(
            *args, bounds.data_ptr(), edges.data_ptr(), flags.data_ptr(),
            nrep, ny, half, sweeps, layout.blocks, layout.cap,
            layout.smem_bytes, -float(beta), _stream(st.ax))
    _raise_on(code, lib, "smem_multisweep_kernel")
    return obs


def multisweep_planes(st: XYState, snap: XYState | None, seeds, *,
                      beta: float, grid: bool = False) -> torch.Tensor:
    """S = len(seeds) sweeps of ``st`` in place under the (S, 2, 2)
    per-(sweep, phase) keys; returns the (R, S, 4) float64 per-sweep
    (Σ S_x, Σ S_y, e, A).  On CPU tensors :func:`multisweep_planes_plain`;
    on CUDA tensors one launch: ``smem_multisweep_kernel`` where
    :func:`smem_layout` fits the batch on the card, else
    ``gmem_multisweep_kernel`` on :func:`gmem_layout` (``grid`` forces the
    latter); raises where neither has a layout."""
    if _on_cpu(st.ax):
        return multisweep_planes_plain(st, snap, seeds, beta=beta)
    ring = _ring(st, grid)
    obs = _launch(st, snap, seeds, beta, ring)
    LAUNCHES[ring[0]] += 1
    return obs.view(st.ax.shape[0], int(seeds.shape[0]), xy2d_pallas.NSUMS)


def phase_with_bits(sx, sy, ox, oy, u_cand, u_acc, *, color: int,
                    beta: float):
    """One phase of colour ``color`` with injected uniforms, in place (JAX
    ``phase_with_bits``): ``metropolis_kernel``'s injected mode
    (``xy2d_pallas.metropolis_phase``) on CUDA tensors,
    :func:`phase_with_bits_plain` on CPU tensors.  Returns (sx, sy)."""
    if _on_cpu(sx):
        return phase_with_bits_plain(sx, sy, ox, oy, u_cand, u_acc,
                                     color=color, beta=beta)
    return xy2d_pallas.metropolis_phase(sx, sy, ox, oy, (u_cand, u_acc),
                                        color=color, beta=beta)


def multisweep(model, st: XYState, snap: XYState | None, key, sweeps: int,
               t0: int = 0):
    """Sweeps t0+1 .. t0+sweeps of the sample keyed by ``key`` on
    (R, ny, half) planes, in place: returns (st, {mx, my, e, A} densities
    (R, sweeps) float64) (JAX ``multisweep``, keyed by the global sweep
    index)."""
    seeds = multispin_rng.sweep_phase_keys(key, sweeps, t0)
    obs = multisweep_planes(st, snap, seeds, beta=model.beta)
    return st, xy2d_pallas.densities(model, obs)
