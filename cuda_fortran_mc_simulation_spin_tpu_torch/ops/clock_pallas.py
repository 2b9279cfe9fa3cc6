"""The int8 q-state clock checkerboard phase on the card: a CUDA kernel and
its plain version.

Port of ``cuda_fortran_mc_simulation_spin_tpu/ops/clock_pallas.py`` (the
module keeps its name so that its JAX counterpart is found by name; it
launches a CUDA kernel, not a Pallas one).  ``csrc/clock_pallas.cu``
``phase_kernel`` replaces ``_phase_kernel`` (pallas_call at ``:106``,
``_metropolis_phase``): one colour phase of (R, ny, nx/2) int8 states in
[0, q), in place, under the rule of models/clock.metropolis_update, for
every 2 <= q <= 127 and every even nx and ny (JAX's tiling gates, nx/2 %
128 and ny % 32, are TPU artefacts).  The JAX kernel evaluates (cos, sin)
by q-way select chains (Mosaic has no fast gather); the kernel here reads
them from the q-entry float32 table of core/tables.py, the same values.

Random words.  Each site draws two uint32 words from Philox4x32-10
(``csrc/philox.cuh``):

    key     = seeds_from_key(sweep_key, phase)  the (sample, t, phase) key
    counter = (replica, row, column >> 1, 0)
    words   = outputs 2·(column & 1) (candidate) and 2·(column & 1) + 1
              (acceptance), each a uniform from its top 24 bits

so one Philox call feeds two adjacent sites of a row (a unit,
``csrc/clock_int8.cuh``), and the last unit of a row whose nx/2 is odd
leaves its spare outputs unused.  The plain version (:func:`draw_uniforms`),
the phase kernel, the multisweep kernel and every route of the runners
draw these words, so a trajectory depends on neither the kernel, the
route nor the host chunking.  The JAX kernel draws the TPU's hardware
bits; its ``sharded_phase`` takes injected uniforms (``u_cand=``,
``u_acc=``), as the kernel here does (the mode the checks use).

``phase_kernel<true, .>``, the halo mode of ``phase_kernel``, replaces
``_halo_phase_kernel`` (pallas_call at ``:294``, :func:`sharded_phase`):
the phase on a shard of a (y[, x]) mesh (parallel/domain.py), with the
rows and columns past the shard's edges from the exchanged halos, parity
and words keyed by global (replica, row, column), and with ``measuring``
the shard's float64 (Σ cos, Σ sin, e) partials, per tile in a fixed order
and then per replica (``xy::reduce_kernel``).  A shard whose column offset
is odd cuts a unit; the kernel draws by global unit
(:func:`draw_uniforms_at`), so its words are the unsharded lattice's at
every x split.  JAX sums its partials in float32.

The kernel takes tiles of whole rows of one replica, or chunks of a row
past ``CHUNK_COLS`` columns, staged in shared memory from the 16-B aligned
vectors that cover each of a tile's four byte ranges, four sites a thread
a step, one tile a block (no grid barrier, no division in the walk); its
launch constants are the int8 multisweeps' (``ising2d_multisweep.
ms_tiles``) at smaller tiles (:func:`phase_tiles`, checked before every
launch), and ``tests/test_torch_clock_int8_phase_tiles.py`` replays the
launch on the CPU.

A wrapper takes the plain version for a CPU tensor; for a CUDA tensor it
launches the kernel or raises.  ``LAUNCHES`` counts launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from cuda_fortran_mc_simulation_spin_tpu_torch.core import (
    lattice,
    rng,
    tables,
)
from cuda_fortran_mc_simulation_spin_tpu_torch.models.base import (
    CheckerboardState,
)
from cuda_fortran_mc_simulation_spin_tpu_torch.models.clock import (
    metropolis_update,
    update_in_field,
)
from cuda_fortran_mc_simulation_spin_tpu_torch.ops import _build
from cuda_fortran_mc_simulation_spin_tpu_torch.ops.ising2d_multispin import (
    _on_cpu,
    _stream,
    offsets,
)
from cuda_fortran_mc_simulation_spin_tpu_torch.ops.ising2d_multisweep import (
    _tiles_arg,
    ms_tiles,
)
from cuda_fortran_mc_simulation_spin_tpu_torch.ops.ising2d_pallas import (
    batched,
    check_halos,
    check_int8,
    phase_seeds,
    raise_on,
    seed_words,
)

THREADS = 256            # threads a block
MAX_REPLICAS = 65535     # the grid's y extent
TABLE = 128              # entries of a kernel table (csrc/clock_int8.cuh)
LAUNCHES = {"phase": 0, "halo_phase": 0, "halo_phase_measuring": 0}
# sites a whole-row tile of the phase kernel takes at most: half the
# multisweeps' (one tile a block, so more blocks a launch; 2-3% faster at
# 2000^2 x 16 and 5-11% at the mesh class's shard on an H100, PERF.md §6)
TILE_BYTES = 8192


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def units(half: int) -> int:
    """Units of two sites a row of ``half`` columns holds."""
    return -(-half // 2)


def phase_tiles(nrep: int, ny: int, half: int) -> dict:
    """The phase kernel's launch constants on (nrep, ny, half) planes:
    ``ising2d_multisweep.ms_tiles`` at TILE_BYTES a tile (the kernel takes
    them as ``_tiles_arg`` passes them, after ``check_ms_tiles``)."""
    return ms_tiles(nrep, ny, half, TILE_BYTES)


@functools.lru_cache(maxsize=64)
def _phase_tiles_arg(nrep: int, ny: int, half: int):
    """:func:`phase_tiles` as the kernel's 10 ints, checked, built once a
    shape: a one-replica history launches twice a sweep, and building them
    anew cost its class ~29 us of the host a launch on the card's machine
    (PERF.md §6)."""
    return _tiles_arg(nrep, ny, half, TILE_BYTES)


def check_launch(nrep: int, rows: int, half: int, q: int) -> None:
    """Refuse a launch whose unit index within a replica could pass 2^31,
    whose replicas exceed the grid's y extent, or whose q the tables do
    not hold (the kernels index memory with 64-bit offsets, their units
    with 32-bit ones)."""
    if not 1 <= nrep <= MAX_REPLICAS:
        raise ValueError(f"{nrep} replicas: a launch takes 1 .. "
                         f"{MAX_REPLICAS}")
    if not 2 <= q < TABLE:
        raise ValueError(f"q={q}: the kernels' tables hold 2 <= q < {TABLE}")
    if rows * units(half) + THREADS >= 2 ** 31:
        raise ValueError(f"{rows} rows of {half} columns: the unit index "
                         "of a replica would pass 2^31")


@functools.lru_cache(maxsize=None)
def _table(q: int, device: str, dtype: torch.dtype) -> torch.Tensor:
    return table_rows(q, dtype).to(device)


def table_rows(q: int, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(2, TABLE) (cos, sin) rows of the q states, zero past q: the
    float32 table of the update (core/tables.clock_cos_sin_table), or with
    ``dtype`` float64 the sums' (core/tables.clock_sums_table)."""
    vals = (tables.clock_cos_sin_table(q) if dtype == torch.float32
            else tables.clock_sums_table(q))
    out = torch.zeros((2, TABLE), dtype=dtype)
    out[:, :q] = vals
    return out


def device_table(q: int, device, dtype: torch.dtype = torch.float32
                 ) -> torch.Tensor:
    """:func:`table_rows` on ``device``, built once a (q, device, dtype);
    the kernels only read it."""
    return _table(q, str(torch.device(device)), dtype)


def draw_words(seeds, nrep: int, rows: int, half: int, device=None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """(candidate, acceptance) uint32 words (in int64), each (nrep, rows,
    half), of one phase under the Philox key ``seeds`` ((2,) uint32): site
    (r, row, c) takes outputs 2(c & 1) and 2(c & 1) + 1 of the counter
    (r, row, c >> 1, 0)."""
    return draw_words_at(seeds, 0, nrep, 0, rows, 0, half, device)


def draw_words_at(seeds, rep0: int, nrep: int, row0: int, rows: int,
                  col0: int, half: int, device=None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`draw_words` of a shard: replicas rep0 .., rows row0 .. and
    columns col0 .. col0 + half - 1, each site from its global unit's
    Philox call."""
    key = torch.as_tensor(seeds, dtype=torch.int64).to(device)
    j0 = col0 >> 1
    nu = ((col0 + half - 1) >> 1) - j0 + 1
    r = torch.arange(rep0, rep0 + nrep, dtype=torch.int64,
                     device=device).view(-1, 1, 1)
    y = torch.arange(row0, row0 + rows, dtype=torch.int64,
                     device=device).view(1, -1, 1)
    j = torch.arange(j0, j0 + nu, dtype=torch.int64,
                     device=device).view(1, 1, -1)
    r, y, j = torch.broadcast_tensors(r, y, j)
    ctr = torch.stack([r, y, j, torch.zeros_like(r)], dim=-1)
    out = rng.philox4x32(ctr, key).view(nrep, rows, nu, 2, 2)
    lo = col0 - 2 * j0
    out = out.reshape(nrep, rows, 2 * nu, 2)[:, :, lo:lo + half]
    return out[..., 0], out[..., 1]


def draw_uniforms(seeds, nrep: int, rows: int, half: int, device=None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """(u_cand, u_acc) float32 of one phase under ``seeds``: the words of
    :func:`draw_words` through their top 24 bits (rng.bits_to_uniform)."""
    wc, wa = draw_words(seeds, nrep, rows, half, device)
    return rng.bits_to_uniform(wc), rng.bits_to_uniform(wa)


def phase_plain(x: torch.Tensor, other: torch.Tensor, seeds=None, *,
                color: int, q: int, beta: float,
                u_cand: torch.Tensor | None = None,
                u_acc: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of ``phase_kernel``: the new (R, ny, half) int8 colour
    plane ``x`` given the other colour, with the uniforms of
    :func:`draw_uniforms` under ``seeds`` or the injected float32
    ``u_cand``, ``u_acc``."""
    if u_cand is None:
        u_cand, u_acc = draw_uniforms(seeds, *x.shape, x.device)
    return metropolis_update(x, other, color, u_cand, u_acc, q, beta)


def gather64(state: torch.Tensor, q: int):
    """float64 (cos, sin) of the states from core/tables.clock_sums_table."""
    tab = tables.clock_sums_table(q).to(state.device)
    idx = state.to(torch.int64)
    return tab[0][idx], tab[1][idx]


def _field(o: torch.Tensor, halos, color: int, row0: int, gather):
    """(hx, hy) of a shard's colour in the kernel's order: ``gather`` maps
    states to their (cos, sin) (float32 for the update, float64 for the
    sums), ``halos`` = (up, dn, lf, rt), the last two None without an x
    split."""
    co, so = gather(o)
    hs = [None if h is None else gather(h) for h in halos]
    return tuple(
        lattice.neighbor_sums_halo(
            v, color, row0, *(None if h is None else h[k] for h in hs))
        for k, v in enumerate((co, so)))


def sharded_phase_plain(x, other, halo_up, halo_dn, seeds, offs, *,
                        color: int, q: int, beta: float, halo_lf=None,
                        halo_rt=None, u_cand=None, u_acc=None,
                        measuring: bool = False):
    """Plain version of ``phase_kernel<true, .>``: the new (R, L, half)
    int8 shard ``x`` given the other colour's block and halos; offs =
    (rep0, row0[, col0]).  Uniforms injected (``u_cand``, ``u_acc``), else
    from Philox at the shard's global coordinates (:func:`draw_words_at`).
    With ``measuring`` also the (R,) float64 (Σ cos, Σ sin, e) partials:
    Σ over the new states and the other colour's, e = -Σ S_new·h from
    the float64 table (each bond of the shard's sites once)."""
    rep0, row0, *rest = offsets(offs)
    col0 = rest[0] if rest else 0
    nrep, L, half = x.shape
    if u_cand is None:
        wc, wa = draw_words_at(seeds, rep0, nrep, row0, L, col0, half,
                               x.device)
        u_cand, u_acc = rng.bits_to_uniform(wc), rng.bits_to_uniform(wa)
    halos = (halo_up, halo_dn, halo_lf, halo_rt)
    hx, hy = _field(other, halos, color, row0,
                    lambda v: tables.state_cos_sin(v, q))
    new = update_in_field(x, hx, hy, u_cand, u_acc, q, beta)
    if not measuring:
        return new
    hx64, hy64 = _field(other, halos, color, row0, lambda v: gather64(v, q))
    cn, sn = gather64(new, q)
    co, so = gather64(other, q)
    dims = (-2, -1)
    mx = cn.sum(dim=dims) + co.sum(dim=dims)
    my = sn.sum(dim=dims) + so.sum(dim=dims)
    e = -(cn * hx64 + sn * hy64).sum(dim=dims)
    return new, mx, my, e


def check_uniforms(x: torch.Tensor, *planes: torch.Tensor) -> None:
    """Injected uniforms are contiguous float32 planes of x's shape on its
    device."""
    for u in planes:
        if u.shape != x.shape or u.dtype != torch.float32:
            raise ValueError(f"uniforms must be float32 {tuple(x.shape)}, "
                             f"got {u.dtype} {tuple(u.shape)}")
        if u.device != x.device or not u.is_contiguous():
            raise ValueError("uniforms must be contiguous on the planes' "
                             "device")


def _lib() -> ctypes.CDLL:
    lib = _build.load("clock_pallas")
    if lib.clock_int8_phase.argtypes is not None:
        return lib
    tiles = ctypes.POINTER(ctypes.c_int)
    lib.clock_int8_phase.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
        + [ctypes.c_float, ctypes.c_uint, ctypes.c_uint, tiles,
           ctypes.c_void_p])
    lib.clock_int8_phase.restype = ctypes.c_int
    lib.clock_int8_halo_phase.argtypes = (
        [ctypes.c_void_p] * 12 + [ctypes.c_int] * 8
        + [ctypes.c_float, ctypes.c_uint, ctypes.c_uint, tiles,
           ctypes.c_void_p])
    lib.clock_int8_halo_phase.restype = ctypes.c_int
    lib.clock_int8_error_string.argtypes = [ctypes.c_int]
    lib.clock_int8_error_string.restype = ctypes.c_char_p
    return lib


def metropolis_phase(x: torch.Tensor, other: torch.Tensor, seeds=None, *,
                     color: int, q: int, beta: float,
                     u_cand: torch.Tensor | None = None,
                     u_acc: torch.Tensor | None = None) -> torch.Tensor:
    """One colour phase of (R, ny, half) int8 states, updating ``x`` in
    place (returned): ``phase_kernel`` on CUDA tensors, :func:`phase_plain`
    on CPU tensors.  Uniforms from Philox under ``seeds`` ((2,) uint32),
    or the injected ``u_cand``, ``u_acc``."""
    if (u_cand is None) != (u_acc is None):
        raise ValueError("inject both u_cand and u_acc, or neither")
    if _on_cpu(x):
        return x.copy_(phase_plain(x, other, seeds, color=color, q=q,
                                   beta=beta, u_cand=u_cand, u_acc=u_acc))
    check_int8(x, other)
    if u_cand is not None:
        check_uniforms(x, u_cand, u_acc)
    nrep, ny, half = x.shape
    check_launch(nrep, ny, half, q)
    s0, s1 = (0, 0) if seeds is None else seed_words(seeds)
    tab = device_table(q, x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        code = lib.clock_int8_phase(
            x.data_ptr(), other.data_ptr(), tab.data_ptr(),
            None if u_cand is None else u_cand.data_ptr(),
            None if u_acc is None else u_acc.data_ptr(), nrep, ny, half, q,
            color, -float(beta), s0, s1, _phase_tiles_arg(nrep, ny, half),
            _stream(x))
    raise_on(code, lib.clock_int8_error_string, "clock phase_kernel")
    LAUNCHES["phase"] += 1
    return x


def sharded_phase(x: torch.Tensor, other: torch.Tensor, halo_up, halo_dn,
                  seeds, offs, *, color: int, q: int, beta: float,
                  halo_lf=None, halo_rt=None,
                  u_cand: torch.Tensor | None = None,
                  u_acc: torch.Tensor | None = None,
                  measuring: bool = False):
    """One colour phase of a (y[, x])-sharded (R, L, half) int8 block,
    updating ``x`` in place (returned; with ``measuring`` also the (R,)
    float64 (Σ cos, Σ sin, e) partials): ``phase_kernel<true, .>`` on CUDA
    tensors, :func:`sharded_phase_plain` on CPU tensors.  halo_up/halo_dn
    (R, 1, half) are the other colour's rows above and below the shard,
    halo_lf/halo_rt (R, L, 1) its columns with an x split (offs then
    (rep0, row0, col0), else (rep0, row0)); JAX's ``sharded_phase``
    (``:222``)."""
    if (u_cand is None) != (u_acc is None):
        raise ValueError("inject both u_cand and u_acc, or neither")
    if _on_cpu(x):
        res = sharded_phase_plain(x, other, halo_up, halo_dn, seeds, offs,
                                  color=color, q=q, beta=beta,
                                  halo_lf=halo_lf, halo_rt=halo_rt,
                                  u_cand=u_cand, u_acc=u_acc,
                                  measuring=measuring)
        if not measuring:
            return x.copy_(res)
        x.copy_(res[0])
        return (x, *res[1:])
    check_int8(x, other)
    check_halos(x, halo_up, halo_dn, halo_lf, halo_rt)
    if u_cand is not None:
        check_uniforms(x, u_cand, u_acc)
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
    # a shard at an odd col0 touches one unit more than units(half)
    check_launch(nrep, L, half + 2, q)
    s0, s1 = (0, 0) if seeds is None else seed_words(seeds)
    tab = device_table(q, x.device)
    tiles = _phase_tiles_arg(nrep, L, half)
    lib = _lib()
    partials = obs = tab64 = None
    if measuring:
        tab64 = device_table(q, x.device, torch.float64)
        # a partial a tile: nty row tiles of nch chunks
        partials = torch.empty((nrep, tiles[4] * tiles[3], 3),
                               dtype=torch.float64, device=x.device)
        obs = torch.empty((nrep, 3), dtype=torch.float64, device=x.device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(x.device):
        code = lib.clock_int8_halo_phase(
            x.data_ptr(), other.data_ptr(), tab.data_ptr(), ptr(tab64),
            ptr(u_cand), ptr(u_acc), halo_up.data_ptr(), halo_dn.data_ptr(),
            ptr(halo_lf), ptr(halo_rt), ptr(partials), ptr(obs), nrep, L,
            half, q, color, rep0, row0, col0, -float(beta), s0, s1, tiles,
            _stream(x))
    raise_on(code, lib.clock_int8_error_string,
             "clock phase_kernel<true, .>")
    LAUNCHES["halo_phase"] += 1
    if measuring:
        LAUNCHES["halo_phase_measuring"] += 1
        return x, obs[:, 0], obs[:, 1], obs[:, 2]
    return x


def sweep_seeded(model, state: CheckerboardState, seeds
                 ) -> CheckerboardState:
    """One MCS (colour 0, then colour 1) under the sweep's (2, 2) phase
    keys (a row of ``multispin_rng.sweep_phase_keys``), updating the
    state's arrays in place (returned)."""
    a, b = batched(state, 2)
    kw = dict(q=model.q, beta=model.beta)
    metropolis_phase(a, b, seeds[0], color=0, **kw)
    metropolis_phase(b, a, seeds[1], color=1, **kw)
    return state


def sweep(model, state: CheckerboardState, key) -> CheckerboardState:
    """One MCS under the sweep key ``key`` on (ny, half) or (R, ny, half)
    int8 arrays, in place (JAX ``sweep``)."""
    return sweep_seeded(model, state, phase_seeds(key))
