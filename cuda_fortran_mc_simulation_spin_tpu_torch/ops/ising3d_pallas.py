"""The int8 3-D Ising checkerboard phase on the card: a CUDA kernel and its
plain version.

Port of ``cuda_fortran_mc_simulation_spin_tpu/ops/ising3d_pallas.py``
(the module keeps its name so that its JAX counterpart is found by name;
it launches a CUDA kernel, not a Pallas one).  ``csrc/ising3d_pallas.cu``
``tile_kernel`` replaces ``_phase_kernel`` (pallas_call at ``:85``,
``_metropolis_phase``): one colour phase of (R, nz, ny, nx/2) int8 ±1
volumes (colour (x+y+z) & 1, core/lattice.py), in place: six neighbours,
and with k = s·Σ₆nbr flip iff k <= 0 or word < t_k, (t4, t8, t12) =
``core/tables.ising3d_accept_thresholds_u32``.  Every even nx, ny, nz.

Random words: those of ops/ising2d_pallas.py with the row index
z·ny + y (:func:`ising2d_pallas.draw_words` over nz·ny rows).

The kernel (``tile_kernel``) takes tiles of whole rows of one plane,
or chunks of a row past ``CHUNK_COLS`` columns, staged in shared memory
from the 16-B aligned vectors that cover each of a tile's six byte
ranges; :func:`phase_tiles` computes its launch constants (the kernel
takes them as passed), and ``tests/test_torch_ising3d_int8_tiles.py``
replays that launch on the CPU.

``tile_kernel<true, .>``, the halo mode of the kernel, replaces
``_halo_phase_kernel`` (pallas_call at ``:237``, :func:`sharded_phase`):
the phase on a z-shard of a (dp, y) mesh (parallel/domain.py), the planes before and after the shard from the
exchanged halo planes, parity and words keyed by the global plane z0 + z,
with the shard's exact int64 (m, e) partials when ``measuring`` (JAX's
int32 partials and their 2^31/3 bound have no counterpart).

A wrapper takes the plain version for a CPU tensor; for a CUDA tensor it
launches the kernel or raises.  ``LAUNCHES`` counts launches.
"""

from __future__ import annotations

import ctypes

import torch

from cuda_fortran_mc_simulation_spin_tpu_torch.core import tables
from cuda_fortran_mc_simulation_spin_tpu_torch.models.base import (
    CheckerboardState,
)
from cuda_fortran_mc_simulation_spin_tpu_torch.ops import _build
from cuda_fortran_mc_simulation_spin_tpu_torch.ops.ising2d_multispin import (
    _on_cpu,
    _stream,
    offsets,
)
from cuda_fortran_mc_simulation_spin_tpu_torch.ops.ising2d_pallas import (
    THREADS,
    as_words,
    batched,
    check_halos,
    check_int8,
    check_launch,
    draw_words_at,
    flip,
    phase_seeds,
    raise_on,
    seed_words,
    shard_sums,
    units,
)

LAUNCHES = {"phase": 0, "halo_phase": 0}

# units a thread takes along a row of a whole-row tile (2^lux threads a
# row, at least 2^MIN_LUX); past CHUNK_COLS columns the tiles are chunks
# of CHUNK_COLS columns, one row a tile
TILE_UNITS = 8
MIN_LUX = 2
CHUNK_COLS = 4096
# a whole-row tile takes up to TILE_BYTES of sites (more rows a thread
# where a row is short)
TILE_BYTES = 8192


def span_bytes(length: int) -> int:
    """Shared-memory bytes of a staged range of ``length`` bytes: the 16-B
    vectors that cover it at any address, and 32 bytes after them."""
    return 16 * (-(-length // 16) + 2)


def stage_layout(need) -> tuple[tuple[int, ...], int]:
    """Byte offsets in shared memory of staged ranges of ``need`` bytes
    each, in order (16-B aligned, each after a 16-byte guard), and the
    bytes they take in all: the layout every tile kernel's C entry checks
    (``tiles8::spans_ok``)."""
    buf, end = [], 0
    for n in need:
        buf.append(end + 16)
        end = buf[-1] + n
    return tuple(buf), end


def phase_tiles(ny: int, half: int) -> dict:
    """Launch constants of ``tile_kernel`` on (R, nz, ny, half) volumes:
    ``rows`` rows a tile and 2^``lux`` threads along a row (thread t takes
    rows (t >> lux) + i THREADS / 2^lux, units (t & (2^lux - 1)) + k
    2^lux of each), ``cw`` columns a tile (half, or CHUNK_COLS with
    ``rows`` 1), ``nch`` chunks a row, ``nty`` row tiles a plane, ``buf``
    the byte offsets in shared memory of the six staged ranges (the
    tile's x, the other colour at z, z - 1, z + 1, rows y0 - 1 and y0 +
    rows; each 16-B aligned after a 16-byte guard) and ``smem`` the bytes
    in all."""
    n_units = units(half)
    if half <= CHUNK_COLS:
        lux = min(THREADS.bit_length() - 1, max(
            MIN_LUX, (-(-n_units // TILE_UNITS) - 1).bit_length()))
        tr = THREADS >> lux
        rows = tr * max(1, min(TILE_BYTES // (tr * half), -(-ny // tr)))
        cw, nch = half, 1
    else:
        lux, rows, cw = THREADS.bit_length() - 1, 1, CHUNK_COLS
        nch = -(-half // cw)
    lx = (rows - 1) * half + min(cw, half)
    buf, end = stage_layout([span_bytes(lx), span_bytes(lx + 2),
                             span_bytes(lx), span_bytes(lx),
                             span_bytes(min(cw, half)),
                             span_bytes(min(cw, half))])
    return {"rows": rows, "lux": lux, "cw": cw, "nch": nch,
            "nty": -(-ny // rows), "buf": buf, "smem": end}


def _tiles_arg(ny: int, half: int) -> ctypes.Array:
    """:func:`phase_tiles` as the 12 ints of the kernel's Tiles."""
    t = phase_tiles(ny, half)
    words = [t["rows"], t["lux"], t["cw"], t["nch"], t["nty"], *t["buf"],
             t["smem"]]
    return (ctypes.c_int * len(words))(*words)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def phase_plain(x: torch.Tensor, other: torch.Tensor, seeds=None, *,
                color: int, beta: float, bits: torch.Tensor | None = None
                ) -> torch.Tensor:
    """Plain version of ``tile_kernel``: the new (R, nz, ny, half) int8
    colour volume ``x`` given the other colour, with the words of
    ``draw_words`` under ``seeds`` or the injected int32 ``bits``."""
    # the periodic lattice is the z-shard at offset 0 whose halos are its
    # own edge planes
    return sharded_phase_plain(x, other, other[:, -1:], other[:, :1], seeds,
                               (0, 0), color=color, beta=beta, bits=bits)


def halo_neighbor_sums3d(other: torch.Tensor, halo_zm, halo_zp, color: int,
                         z0: int) -> torch.Tensor:
    """int32 six-neighbour sums of a z-shard's colour given the other
    colour's (R, L, ny, half) block and its exchanged planes (R, 1, ny,
    half); parity (z0 + z + y) & 1 (JAX ``lattice.neighbor_sums3d_halo``)."""
    o = other.to(torch.int32)
    zm = torch.cat([halo_zm.to(torch.int32), o[:, :-1]], dim=1)
    zp = torch.cat([o[:, 1:], halo_zp.to(torch.int32)], dim=1)
    ys = torch.roll(o, 1, dims=-2) + torch.roll(o, -1, dims=-2)
    minus = torch.roll(o, 1, dims=-1)
    plus = torch.roll(o, -1, dims=-1)
    L, ny = o.shape[1:3]
    z = torch.arange(L, device=o.device).view(L, 1)
    y = torch.arange(ny, device=o.device).view(1, ny)
    odd = ((z0 + z + y) & 1).bool().view(L, ny, 1)
    if color == 0:
        lr = o + torch.where(odd, plus, minus)
    else:
        lr = o + torch.where(odd, minus, plus)
    return zm + zp + ys + lr


def sharded_phase_plain(x, other, halo_zm, halo_zp, seeds, offs, *,
                        color: int, beta: float, bits=None,
                        measuring: bool = False):
    """Plain version of ``tile_kernel<true, .>``: the new (R, L, ny, half)
    int8 shard ``x``; offs = (rep0, z0).  Words: injected int32 ``bits``,
    else Philox at the global rows (z0 + z)·ny + y.  With ``measuring``
    also the (R,) int64 (m, e) partials."""
    rep0, z0 = offsets(offs)
    nrep, L, ny, half = x.shape
    if bits is not None:
        words = as_words(bits)
    else:
        rows = ((z0 + torch.arange(L)).view(L, 1) * ny
                + torch.arange(ny).view(1, ny)).reshape(-1)
        words = draw_words_at(seeds, rep0, nrep, rows, 0, half,
                              x.device).reshape(x.shape)
    nsum = halo_neighbor_sums3d(other, halo_zm, halo_zp, color, z0)
    new = flip(x, nsum, words, tables.ising3d_accept_thresholds_u32(beta))
    if not measuring:
        return new
    return (new, *shard_sums(new, other, nsum))


def _lib() -> ctypes.CDLL:
    lib = _build.load("ising3d_pallas")
    if lib.ising3d_int8_phase.argtypes is not None:
        return lib
    tiles = ctypes.POINTER(ctypes.c_int)
    lib.ising3d_int8_phase.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_uint] * 5
        + [tiles, ctypes.c_void_p])
    lib.ising3d_int8_phase.restype = ctypes.c_int
    lib.ising3d_int8_halo_phase.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_uint] * 5
        + [tiles, ctypes.c_void_p])
    lib.ising3d_int8_halo_phase.restype = ctypes.c_int
    lib.ising3d_int8_error_string.argtypes = [ctypes.c_int]
    lib.ising3d_int8_error_string.restype = ctypes.c_char_p
    return lib


def metropolis_phase(x: torch.Tensor, other: torch.Tensor, seeds=None, *,
                     color: int, beta: float,
                     bits: torch.Tensor | None = None) -> torch.Tensor:
    """One colour phase of (R, nz, ny, half) int8 volumes, updating ``x``
    in place (returned): ``tile_kernel`` on CUDA tensors,
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
            color, s0, s1, t4, t8, t12, _tiles_arg(ny, half), _stream(x))
    raise_on(code, lib.ising3d_int8_error_string, "ising3d tile_kernel")
    LAUNCHES["phase"] += 1
    return x


def sharded_phase(x: torch.Tensor, other: torch.Tensor, halo_zm, halo_zp,
                  seeds, offs, *, color: int, beta: float,
                  bits: torch.Tensor | None = None, measuring: bool = False):
    """One colour phase of a z-sharded (R, L, ny, half) int8 block,
    updating ``x`` in place (returned; with ``measuring`` also the (R,)
    int64 (m, e) partials): ``tile_kernel<true, .>`` on CUDA tensors,
    :func:`sharded_phase_plain` on CPU tensors.  halo_zm/halo_zp (R, 1,
    ny, half) are the other colour's planes before and after the shard,
    offs = (rep0, z0); JAX's ``sharded_phase`` (``:237``)."""
    if _on_cpu(x):
        res = sharded_phase_plain(x, other, halo_zm, halo_zp, seeds, offs,
                                  color=color, beta=beta, bits=bits,
                                  measuring=measuring)
        if not measuring:
            return x.copy_(res)
        x.copy_(res[0])
        return (x, *res[1:])
    check_int8(x, other, bits=bits)
    check_halos(x, halo_zm, halo_zp)
    nrep, L, ny, half = x.shape
    if (halo_zm.shape != (nrep, 1, ny, half)
            or halo_zp.shape != halo_zm.shape):
        raise ValueError("halos must be the (R, 1, ny, half) planes of the "
                         "shard")
    rep0, z0 = offsets(offs)
    check_launch(nrep, L * ny, half)
    t4, t8, t12 = tables.ising3d_accept_thresholds_u32(beta)
    s0, s1 = (0, 0) if seeds is None else seed_words(seeds)
    # zeroed: the kernel adds each block's sums with an atomic
    obs = (torch.zeros((nrep, 2), dtype=torch.int64, device=x.device)
           if measuring else None)
    lib = _lib()
    with torch.cuda.device(x.device):
        code = lib.ising3d_int8_halo_phase(
            x.data_ptr(), other.data_ptr(),
            None if bits is None else bits.data_ptr(), halo_zm.data_ptr(),
            halo_zp.data_ptr(), None if obs is None else obs.data_ptr(),
            nrep, L, ny, half, color, rep0, z0, s0, s1, t4, t8, t12,
            _tiles_arg(ny, half), _stream(x))
    raise_on(code, lib.ising3d_int8_error_string,
             "ising3d tile_kernel<true, .>")
    LAUNCHES["halo_phase"] += 1
    if measuring:
        return x, obs[:, 0], obs[:, 1]
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
