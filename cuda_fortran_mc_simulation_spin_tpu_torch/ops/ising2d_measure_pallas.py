"""The int8 Ising observables in one pass on the card: a CUDA kernel and
its plain version.

Port of ``cuda_fortran_mc_simulation_spin_tpu/ops/ising2d_measure_pallas.py``
(the module keeps its name so that its JAX counterpart is found by name;
it launches a CUDA kernel, not a Pallas one).
``csrc/ising2d_measure_pallas.cu`` ``measure_kernel<2>`` replaces
``_kernel`` (pallas_call at ``:74``, ``_measure`` -> ``measure``): per
replica the exact (Σ s, E) of (R, ny, nx/2) int8 planes, E = -Σ s·(s_right
+ s_down).  ``measure_kernel<3>`` does the same for (R, nz, ny, nx/2)
volumes, E = -Σ s·(s_x+ + s_y+ + s_z+): the JAX package sums the 3-D
observables in jnp outside any kernel (``models/ising3d.py:144-171``),
and in PyTorch their int64 temporaries at 500^3 x 2 would cost gigabytes.

The sums are int64 and exact, so kernel and plain version agree bitwise;
the JAX kernel accumulates f32 across row blocks.  The batched runners
measure every sweep through it (JAX ``observables_batched``).

The kernel walks the tiles of ``csrc/ising3d_pallas.cu`` ``tile_kernel``
(whole rows of one plane staged in shared memory by cp.async, chunks of
a row past ``CHUNK_COLS`` columns; in 3-D runs of planes, each plane's
rows staged once) and sums four sites a 32-bit word;
:func:`measure_tiles` computes its launch constants beside
``ops/ising3d_pallas.phase_tiles`` (the kernel takes them as passed), and
``tests/test_torch_ising_int8_measure_tiles.py`` replays that launch on
the CPU.

A wrapper takes the plain version for a CPU tensor; for a CUDA tensor it
launches the kernel or raises.  ``LAUNCHES`` counts launches of the 2-D
and of the 3-D kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from cuda_fortran_mc_simulation_spin_tpu_torch.core import lattice
from cuda_fortran_mc_simulation_spin_tpu_torch.models.base import (
    CheckerboardState,
)
from cuda_fortran_mc_simulation_spin_tpu_torch.ops import _build
from cuda_fortran_mc_simulation_spin_tpu_torch.ops.ising2d_multispin import (
    _on_cpu,
    _stream,
    per_site,
)
from cuda_fortran_mc_simulation_spin_tpu_torch.ops.ising2d_pallas import (
    THREADS,
    check_int8,
    check_launch,
    raise_on,
    units,
)
from cuda_fortran_mc_simulation_spin_tpu_torch.ops.ising3d_pallas import (
    TILE_BYTES,
    phase_tiles,
    span_bytes,
    stage_layout,
)

LAUNCHES = {"measure2d": 0, "measure3d": 0}

# the tiles of a launch spread over at least this many blocks where the
# lattice allows (four per SM of an H100): thinner tiles, more threads
# along a row, shorter runs of planes
MEASURE_BLOCKS = 4 * 132
# planes a block walks in 3-D, staging each plane's rows once (the run's
# first twice), while the runs keep 4·MEASURE_BLOCKS blocks
MEASURE_ZRUN = 8
# threads along a row at the least: a warp within one row (shared loads
# of 32 consecutive words) where a row has as many units
MEASURE_MIN_LUX = 5


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def measure_sums_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of ``measure_kernel``: (R, 2) int64 exact (m, e) of
    (R, ny, half) colour planes or (R, nz, ny, half) volumes.  The bond
    products are int8 values summed in int64, so no int64 copy of the
    state is made."""
    if a.dim() == 4:
        (ra, ya, za), (rb, yb, zb) = lattice.right_down_back_neighbors3d(
            a, b)
        na, nb = ra + ya + za, rb + yb + zb
    else:
        ra, da, rb, db = lattice.right_down_neighbors(a, b)
        na, nb = ra + da, rb + db
    dims = tuple(range(1, a.dim()))
    m = a.sum(dim=dims, dtype=torch.int64) + b.sum(dim=dims,
                                                    dtype=torch.int64)
    e = -((a * na).sum(dim=dims, dtype=torch.int64)
          + (b * nb).sum(dim=dims, dtype=torch.int64))
    return torch.stack([m, e], dim=-1)


def measure_tiles(nz: int, ny: int, half: int, dims: int) -> dict:
    """Launch constants of ``measure_kernel`` on (R, ny, half) planes
    (``dims`` 2, nz 1) or (R, nz, ny, half) volumes: those of
    :func:`ising3d_pallas.phase_tiles` (``rows`` rows a tile, 2^``lux``
    threads along a row, ``cw`` columns a tile, ``nch`` chunks a row,
    ``nty`` row tiles a plane), with at least 2^MEASURE_MIN_LUX threads a
    row where the units allow, and whole rows thinned toward
    MEASURE_BLOCKS blocks a launch (one unit a thread at the most);
    ``zrun`` planes a block walks (1 in 2-D; in 3-D up to MEASURE_ZRUN,
    keeping 4·MEASURE_BLOCKS blocks) in ``nzg`` runs; ``buf`` the byte
    offsets in shared memory of the staged ranges: a's and b's tile rows,
    the row after the tile of each, and in 3-D a second slot of tile rows
    of each (plane z + 1's; the two slots swap from plane to plane; 16-B
    aligned after a 16-byte guard; 0 where 2-D has none), ``smem`` the
    bytes in all."""
    t = phase_tiles(ny, half)
    lux, cw, nch, rows = t["lux"], t["cw"], t["nch"], t["rows"]
    if nch == 1:
        top = max(lux, min(THREADS.bit_length() - 1,
                           (units(half) - 1).bit_length()))
        lux = max(lux, min(MEASURE_MIN_LUX, top))
        while lux < top and nz * -(-ny // (THREADS >> lux)) < MEASURE_BLOCKS:
            lux += 1
        tr = THREADS >> lux
        rows = tr * max(1, min(TILE_BYTES // (tr * half), -(-ny // tr),
                               ny * nz // (tr * MEASURE_BLOCKS)))
    nty = -(-ny // rows)
    zrun = 1 if dims == 2 else max(1, min(
        MEASURE_ZRUN, nz * nty * nch // (4 * MEASURE_BLOCKS)))
    lx = (rows - 1) * half + min(cw, half)
    need = [span_bytes(lx)] * 2 + [span_bytes(min(cw, half))] * 2
    if dims == 3:
        need += [span_bytes(lx)] * 2
    buf, end = stage_layout(need)
    return {"rows": rows, "lux": lux, "cw": cw, "nch": nch, "nty": nty,
            "zrun": zrun, "nzg": -(-nz // zrun),
            "buf": buf + (0,) * (6 - len(buf)), "smem": end}


@functools.lru_cache(maxsize=64)
def _tiles_arg(nz: int, ny: int, half: int, dims: int) -> ctypes.Array:
    """:func:`measure_tiles` as the 14 ints of the kernel's Tiles (cached:
    a launch of the samples class's lattice takes ~0.005 ms on the card,
    less than the constants' Python)."""
    t = measure_tiles(nz, ny, half, dims)
    words = [t["rows"], t["lux"], t["cw"], t["nch"], t["nty"], t["zrun"],
             t["nzg"], *t["buf"], t["smem"]]
    return (ctypes.c_int * len(words))(*words)


def _lib() -> ctypes.CDLL:
    lib = _build.load("ising2d_measure_pallas")
    if lib.ising_int8_measure.argtypes is not None:
        return lib
    lib.ising_int8_measure.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
        + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])
    lib.ising_int8_measure.restype = ctypes.c_int
    lib.ising_int8_measure_error_string.argtypes = [ctypes.c_int]
    lib.ising_int8_measure_error_string.restype = ctypes.c_char_p
    return lib


def measure_sums(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(R, 2) int64 exact (m, e) of (R, ny, half) planes or (R, nz, ny,
    half) volumes: ``measure_kernel`` on CUDA tensors,
    :func:`measure_sums_plain` on CPU tensors."""
    if _on_cpu(a):
        return measure_sums_plain(a, b)
    check_int8(a, b)
    dims = a.dim() - 1
    if dims not in (2, 3):
        raise ValueError(f"state must be (R, ny, half) or (R, nz, ny, "
                         f"half), got {tuple(a.shape)}")
    nrep, *vol, half = a.shape
    nz, ny = (1, *vol) if dims == 2 else vol
    check_launch(nrep, nz * ny, half)
    # zeroed: the kernel adds each block's sums with an atomic
    obs = torch.zeros((nrep, 2), dtype=torch.int64, device=a.device)
    lib = _lib()
    with torch.cuda.device(a.device):
        code = lib.ising_int8_measure(a.data_ptr(), b.data_ptr(),
                                      obs.data_ptr(), nrep, dims, nz, ny,
                                      half, _tiles_arg(nz, ny, half, dims),
                                      _stream(a))
    raise_on(code, lib.ising_int8_measure_error_string,
             "ising measure_kernel")
    LAUNCHES[f"measure{dims}d"] += 1
    return obs


def densities(sums: torch.Tensor, nsites: int) -> dict[str, torch.Tensor]:
    """{m, e} float64 densities of (..., 2) int64 sums."""
    return {"m": per_site(sums[..., 0], nsites),
            "e": per_site(sums[..., 1], nsites)}


def measure(model, state: CheckerboardState) -> dict[str, torch.Tensor]:
    """{m, e} float64 densities (R,) of a replica batch (JAX
    ``measure``)."""
    return densities(measure_sums(*state), model.nsites)
