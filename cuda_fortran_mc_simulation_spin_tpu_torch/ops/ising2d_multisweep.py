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

The kernel takes tiles of whole rows of one replica, or chunks of a row
past ``CHUNK_COLS`` columns, staged in shared memory from the 16-B
aligned vectors that cover each of a tile's four byte ranges, four sites
a 32-bit word; :func:`ms_tiles` computes its launch constants (the kernel
takes them as passed; the int8 clock multisweep, ops/clock_multisweep.py,
takes the same tiles), and ``tests/test_torch_ising_int8_ms_tiles.py``
replays that launch on the CPU.

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
    _on_cpu,
    _stream,
)
from cuda_fortran_mc_simulation_spin_tpu_torch.ops.ising2d_pallas import (
    THREADS,
    accept_thresholds_u32,
    check_int8,
    check_launch,
    phase_plain,
    raise_on,
)
from cuda_fortran_mc_simulation_spin_tpu_torch.ops.ising3d_pallas import (
    span_bytes,
    stage_layout,
)

# bytes of the batch's int8 planes (batch·nx·ny) up to which the runner
# takes this kernel (module docstring)
MULTISWEEP_MAX_BYTES = 32 << 20

LAUNCHES = {"multisweep": 0}

# words of four sites a thread takes along a row of a whole-row tile
# (2^lux threads a row, at least 2^MIN_LUX); past CHUNK_COLS columns the
# tiles are chunks of CHUNK_COLS columns, one row a tile
TILE_WORDS = 4
MIN_LUX = 2
CHUNK_COLS = 4096
# a whole-row tile takes up to TILE_BYTES of sites (more rows a thread
# where a row is short)
TILE_BYTES = 16384
# a launch takes at least MIN_TILES tiles where its batch allows (about a
# block's of this kernel's cooperative grid, 4 blocks an SM on the H100's
# 132 SMs, two of the clock's, 2 an SM), so a small batch takes shorter
# tiles and more threads a row
MIN_TILES = 512


def _spans(rows: int, cw: int, half: int) -> list[int]:
    """Shared-memory bytes of a tile's four staged ranges: its own sites,
    the other colour's rows (two columns wider in a chunk), the rows
    before and after it."""
    lx = (rows - 1) * half + min(cw, half)
    return [span_bytes(lx), span_bytes(lx + 2), span_bytes(min(cw, half)),
            span_bytes(min(cw, half))]


def ms_tiles(nrep: int, ny: int, half: int,
             tile_bytes: int = TILE_BYTES) -> dict:
    """Launch constants of the 2-D int8 multisweeps (this module's
    ``multisweep_kernel`` and the clock's) on (nrep, ny, half) planes:
    ``rows`` rows a tile and 2^``lux`` threads along a row (thread t
    takes rows (t >> lux) + i THREADS / 2^lux, words of four sites (t &
    (2^lux - 1)) + k 2^lux of each; TILE_WORDS words a thread and up to
    TILE_BYTES a tile where that leaves MIN_TILES tiles, else fewer rows
    and then more threads a row, up to a thread a word), ``cw`` columns a
    tile (half, or CHUNK_COLS with ``rows`` 1), ``nch`` chunks a row,
    ``nty`` row tiles a replica, ``buf`` the byte offsets in shared memory
    of the four staged ranges (the tile's own sites, the other colour's
    rows y0 .. (a chunk widened by a column each side), its rows y0 - 1
    and y0 + rows; each 16-B aligned after a 16-byte guard) and ``smem``
    the bytes in all.  The blocks walk the tiles in the order (replica,
    row tile, chunk); the clock's fused sums of a (replica, sweep) are nty
    nch tile partials, in that order (yt nch + cx).  ``tile_bytes``
    replaces TILE_BYTES (the int8 clock phase kernel's smaller tiles,
    ops/clock_pallas.phase_tiles)."""
    if half <= CHUNK_COLS:
        words = -(-half // 4)
        top = THREADS.bit_length() - 1
        lux = min(top, max(MIN_LUX, (-(-words // TILE_WORDS) - 1)
                           .bit_length()))
        top = min(top, max(lux, (words - 1).bit_length()))
        while True:
            tr = THREADS >> lux
            k = max(1, min(tile_bytes // (tr * half), -(-ny // tr)))
            while k > 1 and nrep * -(-ny // (tr * k)) < MIN_TILES:
                k -= 1
            if nrep * -(-ny // (tr * k)) >= MIN_TILES or lux == top:
                break
            lux += 1
        rows = tr * k
        cw, nch = half, 1
    else:
        lux, rows, cw = THREADS.bit_length() - 1, 1, CHUNK_COLS
        nch = -(-half // cw)
    buf, end = stage_layout(_spans(rows, cw, half))
    return {"rows": rows, "lux": lux, "cw": cw, "nch": nch,
            "nty": -(-ny // rows), "buf": buf, "smem": end}


def check_ms_tiles(t: dict, ny: int, half: int) -> None:
    """Refuse constants the multisweep kernels cannot run on (their own
    ``tiles8::row_tiles_ok``, which refuses them again): rows not a
    multiple of a pass, 2^lux threads a row outside 4 .. 256, columns or
    chunks that do not cover a row or leave a chunk empty, chunks not of
    whole words or past CHUNK_COLS, row tiles too few or one empty, staged
    ranges that overlap or leave the 16-B grid, shared memory short or
    past 48 KB."""
    rows, lux, cw, nch, nty = (t[k] for k in ("rows", "lux", "cw", "nch",
                                              "nty"))
    ok = (2 <= lux <= 8 and rows >= 1 and rows % (THREADS >> lux) == 0
          and cw >= 1 and nch >= 1 and (nch - 1) * cw < half <= nch * cw
          and (nch == 1 and cw == half
               or cw % 4 == 0 and rows == 1 and cw <= CHUNK_COLS)
          and nty >= 1 and (nty - 1) * rows < ny <= nty * rows
          and nty * nch < 2 ** 31)
    if ok:
        end = 0
        for b, n in zip(t["buf"], _spans(rows, cw, half)):
            ok = ok and b % 16 == 0 and b >= end + 16
            end = b + n
        ok = ok and len(t["buf"]) == 4 and end <= t["smem"] <= 48 * 1024
    if not ok:
        raise ValueError(f"multisweep tiles {t} do not fit (R, {ny}, "
                         f"{half}) planes")


def _tiles_arg(nrep: int, ny: int, half: int,
               tile_bytes: int = TILE_BYTES) -> ctypes.Array:
    """:func:`ms_tiles` as the 10 ints of the kernels' RowTiles
    (csrc/byte_tiles.cuh), checked."""
    t = ms_tiles(nrep, ny, half, tile_bytes)
    check_ms_tiles(t, ny, half)
    words = [t["rows"], t["lux"], t["cw"], t["nch"], t["nty"], *t["buf"],
             t["smem"]]
    return (ctypes.c_int * len(words))(*words)


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
    tiles = ctypes.POINTER(ctypes.c_int)
    lib.ising2d_int8_multisweep.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_uint] * 2
        + [tiles, ctypes.c_void_p])
    lib.ising2d_int8_multisweep.restype = ctypes.c_int
    lib.ising2d_int8_multisweep_grid.argtypes = [
        tiles, ctypes.POINTER(ctypes.c_int)]
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
    seeds_dev = multispin_rng.keys_to(seeds, a.device)
    # zeroed: the kernel adds each block's sums with an atomic
    obs = torch.zeros((nrep, sweeps, 2), dtype=torch.int64, device=a.device)
    lib = _lib()
    with torch.cuda.device(a.device):
        code = lib.ising2d_int8_multisweep(
            a.data_ptr(), b.data_ptr(), seeds_dev.data_ptr(), obs.data_ptr(),
            nrep, ny, half, sweeps, t4, t8, _tiles_arg(nrep, ny, half),
            _stream(a))
    raise_on(code, lib.ising2d_int8_multisweep_error_string,
             "ising2d multisweep_kernel")
    LAUNCHES["multisweep"] += 1
    return a, b, obs


def grid_blocks(nrep: int, ny: int, half: int) -> int:
    """Blocks of the cooperative grid on the current device for (nrep, ny,
    half) planes (the tiles' shared memory sets it)."""
    lib = _lib()
    blocks = ctypes.c_int(0)
    raise_on(lib.ising2d_int8_multisweep_grid(_tiles_arg(nrep, ny, half),
                                              ctypes.byref(blocks)),
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
