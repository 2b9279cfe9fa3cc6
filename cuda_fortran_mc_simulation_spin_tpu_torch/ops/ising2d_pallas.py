"""The int8 2-D Ising checkerboard phase on the card: a CUDA kernel and its
plain version.

Port of ``cuda_fortran_mc_simulation_spin_tpu/ops/ising2d_pallas.py``
(the module keeps its name so that its JAX counterpart is found by name;
it launches a CUDA kernel, not a Pallas one).  ``csrc/ising2d_pallas.cu``
``phase_kernel`` replaces ``_phase_kernel`` (pallas_call at ``:126``,
``_metropolis_phase``): one colour phase of (R, ny, nx/2) int8 ±1 planes
(core/lattice.py), in place, under the integer rule of the TPU kernel:
with k = s·Σnbr (ΔE/2), flip iff k <= 0 or word < (k == 2 ? t4 : t8),
t4, t8 = :func:`accept_thresholds_u32` (a uint32 compare).  It serves
every even nx and ny: JAX's tiling gates (nx/2 % 128, ny % 32) are TPU
artefacts.

Random words.  Each site draws one uint32 from Philox4x32-10
(``csrc/philox.cuh``):

    key     = seeds_from_key(sweep_key, phase)  the (sample, t, phase) key
    counter = (replica, row, column >> 2, 0)    row = z·ny + y in 3-D
    word    = output (column & 3)

so one Philox call feeds four adjacent sites of a row (the kernels' unit,
``csrc/ising_int8.cuh``), and the last unit of a row whose nx/2 is not a
multiple of 4 leaves its spare outputs unused.  The plain version
(:func:`draw_words`), the two phase kernels, the multisweep kernel and
every route of the runners draw these words, so a trajectory depends on
neither the kernel, the route nor the host chunking.  The JAX kernel draws
the TPU's hardware bits; its ``sharded_phase`` takes injected words
(``bits=``, ``:397``), as the kernel here does (the mode the checks use).

``phase_kernel<true, .>``, the halo mode of ``phase_kernel``, replaces
``_halo_phase_kernel`` (pallas_call at ``:397``, :func:`sharded_phase`):
the phase on a shard of a (y[, x]) mesh (parallel/domain.py), with the rows and columns past the shard's edges
from the exchanged halos, parity and words keyed by global (replica,
row, column), and the shard's exact (m, e) partials with ``measuring``.
A shard whose column offset is not a multiple of 4 cuts a unit; the
kernel draws by global unit (:func:`draw_words_at`), so its words are
the unsharded lattice's at every x split.  JAX keeps int32 partials and
refuses a local block past 2^30 sites; the port's are int64 and need no
bound.

The kernel takes tiles of whole rows of one replica, or chunks of a row
past ``CHUNK_COLS`` columns, staged in shared memory from the 16-B aligned
vectors that cover each of a tile's four byte ranges, four sites a thread
a step, one tile a block (no grid barrier, no division in the walk), on
the tile body of the int8 multisweep (``csrc/ising_int8.cuh``); its launch
constants are the multisweep's (``ising2d_multisweep.ms_tiles``,
:func:`phase_tiles`, checked before every launch), and
``tests/test_torch_ising_int8_phase_tiles.py`` replays the launch on the
CPU.

A wrapper takes the plain version for a CPU tensor; for a CUDA tensor it
launches the kernel or raises.  ``LAUNCHES`` counts launches.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from cuda_fortran_mc_simulation_spin_tpu_torch.core import rng
from cuda_fortran_mc_simulation_spin_tpu_torch.models.base import (
    CheckerboardState,
)
from cuda_fortran_mc_simulation_spin_tpu_torch.ops import _build
from cuda_fortran_mc_simulation_spin_tpu_torch.ops.ising2d_multispin import (
    _on_cpu,
    _stream,
    offsets,
)

MASK32 = 0xFFFFFFFF
THREADS = 256            # threads a block
MAX_REPLICAS = 65535     # the grid's z extent
LAUNCHES = {"phase": 0, "halo_phase": 0}
# sites a whole-row tile of the phase kernel takes at most, the
# multisweep's (3% faster than 8 KB at 4000^2 x 8 and 11% than 4 KB on an
# H100, the same at the mesh shard and at 1000^2 x 1, where ms_tiles'
# MIN_TILES cuts the tile to 2 rows; PERF.md §6)
TILE_BYTES = 16384


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def accept_thresholds_u32(beta: float) -> tuple[int, int]:
    """uint32 cutoffs (t4, t8) = round(exp(-β·ΔE)·2^32) for ΔE = 4, 8,
    capped at 2^32 - 1: flip iff word < t (JAX
    ``accept_thresholds_u32``, its lines 58-68)."""
    def cut(p):
        return int(min(0xFFFFFFFF, round(p * 4294967296.0)))

    return cut(np.exp(-4.0 * beta)), cut(np.exp(-8.0 * beta))


def units(half: int) -> int:
    """Units of four sites a row of ``half`` columns holds."""
    return -(-half // 4)


def phase_tiles(nrep: int, ny: int, half: int) -> dict:
    """The phase kernel's launch constants on (nrep, ny, half) planes:
    ``ising2d_multisweep.ms_tiles`` at TILE_BYTES a tile (the kernel takes
    them as ``_phase_tiles_arg`` passes them, after ``check_ms_tiles``)."""
    # imported here: ising2d_multisweep imports this module
    from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
        ising2d_multisweep,
    )
    return ising2d_multisweep.ms_tiles(nrep, ny, half, TILE_BYTES)


@functools.lru_cache(maxsize=64)
def _phase_tiles_arg(nrep: int, ny: int, half: int):
    """:func:`phase_tiles` as the kernel's 10 ints, checked, built once a
    shape: a one-replica history launches twice a sweep."""
    from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
        ising2d_multisweep,
    )
    return ising2d_multisweep._tiles_arg(nrep, ny, half, TILE_BYTES)


def check_launch(nrep: int, rows: int, half: int) -> None:
    """Refuse a launch whose unit index within a replica could pass 2^31
    or whose replicas exceed the grid's z extent (the kernels index
    memory with 64-bit offsets, their units with 32-bit ones)."""
    if not 1 <= nrep <= MAX_REPLICAS:
        raise ValueError(f"{nrep} replicas: a launch takes 1 .. "
                         f"{MAX_REPLICAS}")
    if rows * units(half) + THREADS >= 2 ** 31:
        raise ValueError(f"{rows} rows of {half} columns: the unit index "
                         "of a replica would pass 2^31")


def draw_words(seeds, nrep: int, rows: int, half: int,
               device=None) -> torch.Tensor:
    """(nrep, rows, half) uint32 words (in int64) of one phase under the
    Philox key ``seeds`` ((2,) uint32): site (r, row, c) takes output
    c & 3 of the counter (r, row, c >> 2, 0)."""
    return draw_words_at(seeds, 0, nrep, torch.arange(rows), 0, half,
                         device)


def draw_words_at(seeds, rep0: int, nrep: int, rows: torch.Tensor,
                  col0: int, half: int, device=None) -> torch.Tensor:
    """:func:`draw_words` of a shard: (nrep, len(rows), half) words of
    replicas rep0 .., global rows ``rows`` (int64) and columns col0 ..
    col0 + half - 1, each from its global unit's Philox call."""
    key = torch.as_tensor(seeds, dtype=torch.int64).to(device)
    j0 = col0 >> 2
    nu = ((col0 + half - 1) >> 2) - j0 + 1
    r = torch.arange(rep0, rep0 + nrep, dtype=torch.int64,
                     device=device).view(-1, 1, 1)
    y = rows.to(device=device, dtype=torch.int64).view(1, -1, 1)
    j = torch.arange(j0, j0 + nu, dtype=torch.int64,
                     device=device).view(1, 1, -1)
    r, y, j = torch.broadcast_tensors(r, y, j)
    ctr = torch.stack([r, y, j, torch.zeros_like(r)], dim=-1)
    out = rng.philox4x32(ctr, key)                  # (nrep, rows, nu, 4)
    lo = col0 - 4 * j0
    return out.reshape(nrep, y.shape[1], 4 * nu)[..., lo:lo + half]


def as_words(bits: torch.Tensor) -> torch.Tensor:
    """Injected words, raw 32-bit int32 (the kernels' uint32), as uint32
    values in int64."""
    return bits.to(torch.int64) & MASK32


def flip(x: torch.Tensor, nsum: torch.Tensor, words: torch.Tensor,
         thresholds) -> torch.Tensor:
    """The int8 rule of both phase kernels: with k = s·nsum, flip iff
    k <= 0 or word < t_k (t_2, t_4, t_6 = ``thresholds``; in 2-D k <= 4
    and the pair (t4, t8))."""
    k = x.to(torch.int32) * nsum
    t4, t8, t_last = thresholds[0], thresholds[1], thresholds[-1]
    t = torch.where(k == 2, t4, torch.where(k == 4, t8, t_last))
    accept = (k <= 0) | (words < t)
    return torch.where(accept, -x, x).to(torch.int8)


def phase_plain(x: torch.Tensor, other: torch.Tensor, seeds=None, *,
                color: int, beta: float, bits: torch.Tensor | None = None
                ) -> torch.Tensor:
    """Plain version of ``phase_kernel``: the new (R, ny, half) int8 colour
    plane ``x`` given the other colour, with the words of
    :func:`draw_words` under ``seeds`` or the injected int32 ``bits``."""
    # the periodic lattice is the shard at offset 0 whose halos are its
    # own edge rows
    return sharded_phase_plain(x, other, other[:, -1:], other[:, :1], seeds,
                               (0, 0), color=color, beta=beta, bits=bits)


def halo_neighbor_sums(other: torch.Tensor, halo_up, halo_dn, color: int,
                       row0: int, halo_lf=None, halo_rt=None
                       ) -> torch.Tensor:
    """int32 four-neighbour sums of a shard's colour given the other
    colour's (R, L, half) block, its exchanged rows (R, 1, half) and,
    with an x split, columns (R, L, 1); row parity from the global row
    row0 + y (JAX ``lattice.neighbor_sums_halo``, ``_halo2d``)."""
    o = other.to(torch.int32)
    up = torch.cat([halo_up.to(torch.int32), o[:, :-1]], dim=1)
    dn = torch.cat([o[:, 1:], halo_dn.to(torch.int32)], dim=1)
    if halo_lf is None:
        minus = torch.roll(o, 1, dims=-1)
        plus = torch.roll(o, -1, dims=-1)
    else:
        minus = torch.cat([halo_lf.to(torch.int32), o[..., :-1]], dim=-1)
        plus = torch.cat([o[..., 1:], halo_rt.to(torch.int32)], dim=-1)
    L = o.shape[1]
    odd = ((row0 + torch.arange(L, device=o.device)) & 1).bool().view(L, 1)
    if color == 0:
        lr = o + torch.where(odd, plus, minus)
    else:
        lr = o + torch.where(odd, minus, plus)
    return up + dn + lr


def shard_sums(new: torch.Tensor, other: torch.Tensor, nsum: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """A measuring phase b's (m, e) int64 partials (R,) of a shard: m over
    both colours, e = -Σ s_new·nsum (the other colour is final, so each
    bond of the shard's sites is counted once)."""
    dims = tuple(range(1, new.dim()))
    m = (new.sum(dim=dims, dtype=torch.int64)
         + other.sum(dim=dims, dtype=torch.int64))
    e = -(new.to(torch.int64) * nsum).sum(dim=dims)
    return m, e


def sharded_phase_plain(x, other, halo_up, halo_dn, seeds, offs, *,
                        color: int, beta: float, halo_lf=None, halo_rt=None,
                        bits=None, measuring: bool = False):
    """Plain version of ``phase_kernel<true, .>``: the new (R, L, half) int8
    shard ``x`` given the other colour's block and halos; offs = (rep0,
    row0[, col0]).  Words: injected int32 ``bits``, else Philox at the
    shard's global coordinates (:func:`draw_words_at`).  With
    ``measuring`` also the (R,) int64 (m, e) partials."""
    rep0, row0, *rest = offsets(offs)
    col0 = rest[0] if rest else 0
    nrep, L, half = x.shape
    if bits is not None:
        words = as_words(bits)
    else:
        words = draw_words_at(seeds, rep0, nrep, row0 + torch.arange(L),
                              col0, half, x.device)
    nsum = halo_neighbor_sums(other, halo_up, halo_dn, color, row0,
                              halo_lf, halo_rt)
    new = flip(x, nsum, words, accept_thresholds_u32(beta))
    if not measuring:
        return new
    return (new, *shard_sums(new, other, nsum))


def check_int8(x: torch.Tensor, *others: torch.Tensor,
               bits: torch.Tensor | None = None) -> None:
    """The kernels take distinct contiguous int8 tensors of one shape on
    one CUDA device (and int32 words of that shape)."""
    for t in (x, *others):
        if t.shape != x.shape or t.dtype != torch.int8:
            raise ValueError(f"planes must be int8 {tuple(x.shape)}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    for t in (x, *others, *(() if bits is None else (bits,))):
        if not t.is_cuda or t.device != x.device:
            raise ValueError("tensors must lie on one CUDA device")
        if not t.is_contiguous():
            raise ValueError("tensors must be contiguous")
    if bits is not None and (bits.shape != x.shape
                             or bits.dtype != torch.int32):
        raise ValueError(f"bits must be int32 {tuple(x.shape)}, got "
                         f"{bits.dtype} {tuple(bits.shape)}")
    if len({t.data_ptr() for t in (x, *others)}) != 1 + len(others):
        raise ValueError("the colour planes must not share storage")


def raise_on(code: int, error_string, what: str) -> None:
    if code != 0:
        msg = error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def seed_words(seeds) -> tuple[int, int]:
    return tuple(int(v) & MASK32 for v in torch.as_tensor(seeds).tolist())


def _lib() -> ctypes.CDLL:
    lib = _build.load("ising2d_pallas")
    if lib.ising2d_int8_phase.argtypes is not None:
        return lib
    tiles = ctypes.POINTER(ctypes.c_int)
    lib.ising2d_int8_phase.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_uint] * 4
        + [tiles, ctypes.c_void_p])
    lib.ising2d_int8_phase.restype = ctypes.c_int
    lib.ising2d_int8_halo_phase.argtypes = (
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_uint] * 4
        + [tiles, ctypes.c_void_p])
    lib.ising2d_int8_halo_phase.restype = ctypes.c_int
    lib.ising2d_int8_error_string.argtypes = [ctypes.c_int]
    lib.ising2d_int8_error_string.restype = ctypes.c_char_p
    return lib


def metropolis_phase(x: torch.Tensor, other: torch.Tensor, seeds=None, *,
                     color: int, beta: float,
                     bits: torch.Tensor | None = None) -> torch.Tensor:
    """One colour phase of (R, ny, half) int8 planes, updating ``x`` in
    place (returned): ``phase_kernel`` on CUDA tensors,
    :func:`phase_plain` on CPU tensors.  Words from Philox under
    ``seeds`` ((2,) uint32), or the injected int32 ``bits``."""
    if _on_cpu(x):
        return x.copy_(phase_plain(x, other, seeds, color=color, beta=beta,
                                   bits=bits))
    check_int8(x, other, bits=bits)
    nrep, ny, half = x.shape
    check_launch(nrep, ny, half)
    t4, t8 = accept_thresholds_u32(beta)
    s0, s1 = (0, 0) if seeds is None else seed_words(seeds)
    lib = _lib()
    with torch.cuda.device(x.device):
        code = lib.ising2d_int8_phase(
            x.data_ptr(), other.data_ptr(),
            None if bits is None else bits.data_ptr(), nrep, ny, half,
            color, s0, s1, t4, t8, _phase_tiles_arg(nrep, ny, half),
            _stream(x))
    raise_on(code, lib.ising2d_int8_error_string, "ising2d phase_kernel")
    LAUNCHES["phase"] += 1
    return x


def check_halos(x: torch.Tensor, *halos) -> None:
    """Exchanged halos: contiguous int8 on the shard's device."""
    for h in halos:
        if h is None:
            continue
        if h.dtype != torch.int8 or h.device != x.device:
            raise ValueError(f"halos must be int8 on {x.device}, got "
                             f"{h.dtype} on {h.device}")
        if not h.is_contiguous():
            raise ValueError("halos must be contiguous")


def sharded_phase(x: torch.Tensor, other: torch.Tensor, halo_up, halo_dn,
                  seeds, offs, *, color: int, beta: float, halo_lf=None,
                  halo_rt=None, bits: torch.Tensor | None = None,
                  measuring: bool = False):
    """One colour phase of a (y[, x])-sharded (R, L, half) int8 block,
    updating ``x`` in place (returned; with ``measuring`` also the (R,)
    int64 (m, e) partials): ``phase_kernel<true, .>`` on CUDA tensors,
    :func:`sharded_phase_plain` on CPU tensors.  halo_up/halo_dn (R, 1,
    half) are the other colour's rows above and below the shard,
    halo_lf/halo_rt (R, L, 1) its columns left and right with an x split
    (offs then (rep0, row0, col0), else (rep0, row0)); JAX's
    ``sharded_phase`` (``:397``)."""
    if _on_cpu(x):
        res = sharded_phase_plain(x, other, halo_up, halo_dn, seeds, offs,
                                  color=color, beta=beta, halo_lf=halo_lf,
                                  halo_rt=halo_rt, bits=bits,
                                  measuring=measuring)
        if not measuring:
            return x.copy_(res)
        x.copy_(res[0])
        return (x, *res[1:])
    check_int8(x, other, bits=bits)
    check_halos(x, halo_up, halo_dn, halo_lf, halo_rt)
    nrep, L, half = x.shape
    if (halo_up.shape != (nrep, 1, half) or halo_dn.shape != halo_up.shape
            or (halo_lf is None) != (halo_rt is None)
            or (halo_lf is not None
                and (halo_lf.shape != (nrep, L, 1)
                     or halo_rt.shape != (nrep, L, 1)))):
        raise ValueError("halos must be (R, 1, half) rows and (R, L, 1) "
                         "columns of the shard")
    rep0, row0, *rest = offsets(offs)
    col0 = rest[0] if rest else 0
    check_launch(nrep, L, half)
    t4, t8 = accept_thresholds_u32(beta)
    s0, s1 = (0, 0) if seeds is None else seed_words(seeds)
    # zeroed: the kernel adds each block's sums with an atomic
    obs = (torch.zeros((nrep, 2), dtype=torch.int64, device=x.device)
           if measuring else None)
    lib = _lib()
    with torch.cuda.device(x.device):
        code = lib.ising2d_int8_halo_phase(
            x.data_ptr(), other.data_ptr(),
            None if bits is None else bits.data_ptr(), halo_up.data_ptr(),
            halo_dn.data_ptr(),
            None if halo_lf is None else halo_lf.data_ptr(),
            None if halo_rt is None else halo_rt.data_ptr(),
            None if obs is None else obs.data_ptr(), nrep, L, half, color,
            rep0, row0, col0, s0, s1, t4, t8,
            _phase_tiles_arg(nrep, L, half), _stream(x))
    raise_on(code, lib.ising2d_int8_error_string,
             "ising2d phase_kernel<true, .>")
    LAUNCHES["halo_phase"] += 1
    if measuring:
        return x, obs[:, 0], obs[:, 1]
    return x


def phase_seeds(key) -> torch.Tensor:
    """(2, 2) Philox keys of phases a and b of the sweep keyed by ``key``."""
    return rng.seeds_from_key(key, torch.arange(2, dtype=torch.int64))


def batched(state: CheckerboardState, dims: int) -> CheckerboardState:
    """``state`` with a replica axis: (ny, half) colour arrays (3-D: (nz,
    ny, half)) as views of one replica, so that updates in place reach
    the caller's arrays."""
    if state.a.dim() == dims:
        return CheckerboardState(state.a[None], state.b[None])
    return state


def sweep_seeded(model, state: CheckerboardState, seeds
                 ) -> CheckerboardState:
    """One MCS (colour 0, then colour 1) under the sweep's (2, 2) phase
    keys (a row of ``multispin_rng.sweep_phase_keys``), updating the
    state's arrays in place (returned)."""
    a, b = batched(state, 2)
    metropolis_phase(a, b, seeds[0], color=0, beta=model.beta)
    metropolis_phase(b, a, seeds[1], color=1, beta=model.beta)
    return state


def sweep(model, state: CheckerboardState, key) -> CheckerboardState:
    """One MCS under the sweep key ``key`` on (ny, half) or (R, ny, half)
    int8 arrays, in place (JAX ``sweep``)."""
    return sweep_seeded(model, state, phase_seeds(key))
