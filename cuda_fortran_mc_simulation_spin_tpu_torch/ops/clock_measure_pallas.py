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

The kernel walks tiles of whole rows staged in shared memory by cp.async
(chunks of a row past ``CHUNK_COLS`` columns), each thread down a segment
of consecutive rows four columns at a time, each site's (cos, sin)
gathered once; :func:`measure_tiles` computes its launch constants (the
kernel takes them as passed), and
``tests/test_torch_clock_int8_measure_tiles.py`` replays the launch on the
CPU.  The last block to finish adds the block partials (a ticket in a
scratch the wrapper keeps per device and shape, :func:`_scratch`), so a
call is one launch and allocates only its result.

A wrapper takes the plain version for a CPU tensor; for a CUDA tensor it
launches the kernel or raises.  ``LAUNCHES`` counts launches.
"""

from __future__ import annotations

import ctypes
import functools

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
from cuda_fortran_mc_simulation_spin_tpu_torch.ops.ising2d_multisweep import (
    CHUNK_COLS,
)
from cuda_fortran_mc_simulation_spin_tpu_torch.ops.ising2d_pallas import (
    check_int8,
    raise_on,
)
from cuda_fortran_mc_simulation_spin_tpu_torch.ops.ising3d_pallas import (
    span_bytes,
    stage_layout,
)

LAUNCHES = {"measure": 0}
THREADS = clock_pallas.THREADS
# blocks a launch at most: two an SM of an H100 (the kernel's launch
# bound, 128 registers)
MEASURE_BLOCKS = 2 * 132
# rows a thread walks down at most: a row's (cos, sin) are gathered once,
# the row below a walk once more
MEASURE_RPT = 8
# bytes of a colour's tile rows at most, and of shared memory a block
MEASURE_TILE_BYTES = 8192
MEASURE_SMEM = 48 * 1024


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
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
        + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])
    lib.clock_int8_measure.restype = ctypes.c_int
    lib.clock_int8_measure_error_string.argtypes = [ctypes.c_int]
    lib.clock_int8_measure_error_string.restype = ctypes.c_char_p
    return lib


def measure_tiles(ny: int, half: int) -> dict:
    """Launch constants of ``measure_kernel`` on (R, ny, half) planes:
    2^``lux`` threads along a row (the groups of four columns a row holds,
    up to THREADS), each of the THREADS >> lux thread rows walking ``rpt``
    consecutive rows (MEASURE_RPT, halved while fewer than MEASURE_BLOCKS /
    2 tiles would be left, down to 2; capped by MEASURE_TILE_BYTES and by
    48 KB of shared memory), so a tile of ``rows`` rows; past CHUNK_COLS
    columns one row's chunk of ``cw`` columns a tile, ``nch`` chunks a
    row, one thread row; ``nty`` row tiles; ``nblk`` blocks, at most
    MEASURE_BLOCKS and the tiles of a replica; ``buf`` the byte offsets in
    shared memory of each of two tile slots' a and b tile rows and a and b
    rows after the tile (a block stages its next tile while it sums the
    one before; :func:`ising3d_pallas.stage_layout`), ``smem`` the bytes
    in all."""

    def layout(rows, cw):
        lx = (min(rows, ny) - 1) * half + min(cw, half)
        return stage_layout(
            ([span_bytes(lx)] * 2 + [span_bytes(min(cw, half))] * 2) * 2)

    if half > CHUNK_COLS:
        cw, nch, lux, rpt, rows = CHUNK_COLS, -(-half // CHUNK_COLS), 8, 1, 1
    else:
        cw, nch = half, 1
        lux = min(THREADS.bit_length() - 1, (-(-half // 4) - 1).bit_length())
        tr = THREADS >> lux
        rpt = max(1, min(MEASURE_RPT, MEASURE_TILE_BYTES // (tr * half),
                         -(-ny // tr)))
        while rpt > 2 and -(-ny // (tr * rpt)) < MEASURE_BLOCKS // 2:
            rpt //= 2
        while rpt > 1 and layout(tr * rpt, cw)[1] > MEASURE_SMEM:
            rpt -= 1
        rows = tr * rpt
    nty = -(-ny // rows)
    buf, end = layout(rows, cw)
    return {"rows": rows, "lux": lux, "cw": cw, "nch": nch, "nty": nty,
            "rpt": rpt, "nblk": min(nty * nch, MEASURE_BLOCKS), "buf": buf,
            "smem": end}


@functools.lru_cache(maxsize=64)
def _tiles_arg(ny: int, half: int) -> ctypes.Array:
    """:func:`measure_tiles` as the 16 ints of the kernel's Tiles, built
    once a shape (the samples class launches it once a sweep)."""
    t = measure_tiles(ny, half)
    vals = [t["rows"], t["lux"], t["cw"], t["nch"], t["nty"], t["rpt"],
            t["nblk"], *t["buf"], t["smem"]]
    return (ctypes.c_int * len(vals))(*vals)


@functools.lru_cache(maxsize=16)
def _scratch(device: str, nrep: int, nblk: int):
    """The kernel's (R, nblk, 3) float64 block partials and its uint32
    ticket (zero; every launch leaves it zero), kept per device and shape.
    The launches that share them must not overlap: the port makes every
    call on a device's current stream, one after another.  Launches of
    one shape on two streams at once would mix their partials and could
    leave the ticket nonzero; such a caller needs a scratch a stream."""
    dev = torch.device(device)
    return (torch.empty((nrep, nblk, 3), dtype=torch.float64, device=dev),
            torch.zeros(1, dtype=torch.int32, device=dev))


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
    tiles = _tiles_arg(ny, half)
    partials, ticket = _scratch(str(a.device), nrep, tiles[6])  # nblk
    obs = torch.empty((nrep, 3), dtype=torch.float64, device=a.device)
    lib = _lib()
    with torch.cuda.device(a.device):
        code = lib.clock_int8_measure(a.data_ptr(), b.data_ptr(),
                                      tab.data_ptr(), partials.data_ptr(),
                                      ticket.data_ptr(), obs.data_ptr(),
                                      nrep, ny, half, q, tiles, _stream(a))
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
