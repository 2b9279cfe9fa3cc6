"""The masked helical kernels on the card: four CUDA kernels and their plain
versions, for every helical 2-D shape (odd nx, any ny >= 2).

Port of ``cuda_fortran_mc_simulation_spin_tpu/ops/helical_pallas.py`` (the
module keeps its name so that its JAX counterpart is found by name; it
launches CUDA kernels, not Pallas ones).  ``csrc/helical_pallas.cu`` holds

- ``ising_multisweep_kernel``, which replaces ``_ising_kernel`` (pallas_call
  at ``:216``, ``_ising_multisweep`` -> ``ising_multisweep``): S helical
  Metropolis sweeps (colour 0, then colour 1) of (R, N) int8 ±1 states, in
  place, flip iff s·Σnbr <= 0 or word < (s·Σnbr == 2 ? t4 : t8)
  (:func:`accept_thresholds_u32`), with the exact int64 (m, e) of every
  sweep (the TPU kernel's float32 sums are exact only below 2^24 sites);
- ``clock_multisweep_kernel``, which replaces ``_clock_kernel`` (``:373``,
  ``_clock_multisweep`` -> ``clock_multisweep``): the same at any
  2 <= q <= 127, candidate c + trunc(u(q-1)) + 1 mod q, (cos, sin) of a
  state from the q-entry float32 table of ``cos_sin_2pi(k·(1/q))``
  (:func:`clock_table`), accept iff u < exp(-β max(ΔE, 0)); float64 sums,
  a partial a tile;
- ``xy_phase_kernel``, which replaces ``_xy_phase_kernel`` (``:555``,
  ``_xy_phase``): one Metropolis phase of (R, N) float32 component planes,
  out of place, the candidate ``cos_sin_2pi(u)``; with ``measuring`` the
  float64 (Σ S_x, Σ S_y, E) of the new state; and, as its measure mode, the
  same sums of a state with no update (JAX's ``xy_observables_packed``);
- ``xy_phase_kernel``'s over-relaxation mode, which replaces
  ``_xy_or_kernel`` (``:579``, ``_xy_or_phase``): one over-relaxation
  phase, S' = 2(S·n̂)n̂ - S, then S'/|S'| (rsqrt as JAX's), out of place.

Layout.  The port keeps the flat (R, N) states of the models: site idx of
a replica neighbours idx ± 1 and idx ± nx mod N, and colour c holds the
sites idx = 2k + c (k < (N + 1 - c) // 2), the reference's idx % 2 phases.
That is what the TPU kernels compute on their (ny, W) view with the x-seam
fixups; the 128-lane padding (``lane_width``, ``pack``, ``unpack``), the
row tiling (``pick_ty``), single-block mode and the VMEM budgets
(``ising_fits_vmem``, ``single_block_ok``) are TPU layout and are not
ported.  Every field is summed ((up + dn) + left) + right, up = idx - nx,
the TPU kernels' order.

Odd N.  With nx and ny odd the index parity is no two-colouring: idx N-1
and idx 0 are neighbours of one colour, and so are row ny-1 and row 0 at
the same x (nx·(ny-1) is even).  A phase reads the pre-phase values of such
neighbours (Jacobi), as JAX's jnp ``_phase`` and the TPU kernels'
single-block mode (the mode every odd ny takes) do: the XY kernels write
out of place, and the multisweep kernels read rows 0 and ny-1 from a
snapshot taken before each phase.  The energy is the exact
-Σ s_i (s_{i+1} + s_{i+nx}) of the state: at even N the kernels fuse it
into the colour-1 phase (-Σ_1 s·Σnbr, each bond once, as the TPU kernels
do), at odd N they take it in a pass over the final state, because there
the TPU kernels' fused identity counts some wrap bonds twice with stale
partners and others not at all (ROADMAP.md C6).

Random words.  Every draw is keyed as the port's other kernels key theirs:
the Philox4x32-10 key ``seeds_from_key(sweep_key, phase)`` of the (sample,
t, phase), phase = colour, and the counter (replica, unit, 0, 0), a unit
being four colour sites of the Ising kernel (site k takes output k & 3 of
unit k >> 2) or two of the clock and XY kernels (site k takes outputs
2(k & 1) for its candidate and 2(k & 1) + 1 for its acceptance, each a
uniform from its top 24 bits, of unit k >> 1).  So kernel and plain agree
bitwise, and a run depends on neither the route nor the chunk.  The TPU
kernels draw fresh bits every phase, where JAX's jnp ``sweep`` shares one
batch between a sweep's two phases; the port follows the kernels.

The clock's q = 6 here decodes by ``cos_sin_2pi``, not the packed helical
clock's rounded tables (ROADMAP C4), as the TPU masked kernel does.

Tiles.  The two multisweeps stream each phase through tiles of 256 16-B
vectors of one replica at aligned addresses, staged in shared memory a
tile ahead (a vector holds four Ising units or four clock units of its
colour); the XY kernel's four modes through blocks of 256 aligned float4
vectors a step, in registers (:func:`ising_tiles`, :func:`xy_tiles`: the
launch constants, computed here alone; the kernels take them as passed).
A thread reads its own vector, the aligned vectors under its up and down
windows and its ±1 neighbours before it stores its vector, and only the
vectors that reach past a replica (a replica base that is not 16-B
aligned, the wrap mod N, at odd N the seam rows' snapshot) go element by
element.

A wrapper takes the plain version for a CPU tensor; for a CUDA tensor it
launches the kernel or raises.  ``LAUNCHES`` counts launches.
"""

from __future__ import annotations

import ctypes
import functools
import os

import torch

from cuda_fortran_mc_simulation_spin_tpu_torch.core import rng, tables
from cuda_fortran_mc_simulation_spin_tpu_torch.models.clock_helical import (
    Clock2DHelical,
)
from cuda_fortran_mc_simulation_spin_tpu_torch.models.xy2d import (
    metropolis_update,
    reflect,
)
from cuda_fortran_mc_simulation_spin_tpu_torch.models.xy2d_helical import (
    XYFlatState,
)
from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
    _build,
    multispin_rng,
    trig,
)
from cuda_fortran_mc_simulation_spin_tpu_torch.ops.ising2d_multispin import (
    _on_cpu,
    _stream,
    per_site,
)
from cuda_fortran_mc_simulation_spin_tpu_torch.ops.ising2d_pallas import (
    accept_thresholds_u32,
    raise_on,
    seed_words,
)

THREADS = 256            # threads a block
MAX_REPLICAS = 65535     # the XY grid's y extent
TABLE = 128              # entries of the clock kernel's tables
ISING_UNIT = 4           # colour sites a Philox call feeds (Ising)
PAIR_UNIT = 2            # (clock, XY)
VEC_BYTES = 16           # a thread's aligned vector: 16 int8 sites, 4 float32
XY_VPT = (1, 4)          # vectors a thread of the XY phase kernel: a phase,
                         # a measuring launch (fewer partials to reduce)
XY_OR_VPT = 2            # and in its over-relaxation mode
LAUNCHES = {"ising_multisweep": 0, "clock_multisweep": 0, "xy_phase": 0,
            "xy_phase_measuring": 0, "xy_measure": 0, "xy_or": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def switched_off(name: str) -> bool:
    """The JAX package's switch ``name`` (``SPINLAT_HELICAL_PACKED``,
    ``SPINLAT_CLOCK_HELICAL_PACKED``, ``SPINLAT_XY_DENSE``; its
    engine/sweep.py:680, :690, :810) is 0: its packed or dense engine
    steps aside for the masked kernels."""
    return os.environ.get(name) == "0"


def colour_sites(n: int, color: int) -> int:
    """Sites idx = 2k + color of an N-site lattice."""
    return (n + 1 - color) // 2


def check_shape(nrep: int, n: int, nx: int) -> None:
    """Refuse what the kernels do not take: odd nx >= 3, ny = N / nx >= 2,
    1 .. MAX_REPLICAS replicas, and N small enough that no site index a
    kernel forms (a tile's last vector + nx) can pass 2^31 (they index a
    replica with 32-bit offsets and the batch with 64-bit ones)."""
    if nx < 3 or nx % 2 == 0 or n % nx or n // nx < 2:
        raise ValueError(f"N={n}, nx={nx}: the masked helical kernels take "
                         "odd nx >= 3 and ny >= 2")
    if not 1 <= nrep <= MAX_REPLICAS:
        raise ValueError(f"{nrep} replicas: a launch takes 1 .. "
                         f"{MAX_REPLICAS}")
    if n + 2 * nx + 32 * THREADS >= 2 ** 31:
        raise ValueError(f"N={n}: a site index of a replica would pass 2^31")


# ---------------------------------------------------------------------------
# the flat helical stencil and the random draws (plain PyTorch)
# ---------------------------------------------------------------------------

def field(v: torch.Tensor, nx: int) -> torch.Tensor:
    """Neighbour sum of every site of flat (..., N) values,
    ((up + dn) + left) + right with up = idx - nx, left = idx - 1."""
    return (((torch.roll(v, nx, -1) + torch.roll(v, -nx, -1))
             + torch.roll(v, 1, -1)) + torch.roll(v, -1, -1))


def colour_mask(n: int, color: int, device=None) -> torch.Tensor:
    """(N,) bool mask of the sites of ``color``: idx % 2 == color."""
    return (torch.arange(n, device=device) & 1) == color


def spread(per_site: torch.Tensor, n: int, color: int) -> torch.Tensor:
    """(R, m) values of the colour's sites k -> (R, N) at idx = 2k + color,
    zero elsewhere."""
    out = torch.zeros(per_site.shape[:-1] + (n,), dtype=per_site.dtype,
                      device=per_site.device)
    out[..., color::2] = per_site[..., :colour_sites(n, color)]
    return out


def _counters(nrep: int, m: int, unit: int, device) -> torch.Tensor:
    r = torch.arange(nrep, dtype=torch.int64, device=device).view(-1, 1)
    j = torch.arange(-(-m // unit), dtype=torch.int64,
                     device=device).view(1, -1)
    r, j = torch.broadcast_tensors(r, j)
    zero = torch.zeros_like(r)
    return torch.stack([r, j, zero, zero], dim=-1)


def draw_words(seeds, nrep: int, m: int, device=None) -> torch.Tensor:
    """(nrep, m) uint32 words (in int64) of the Ising kernel's colour sites
    under the Philox key ``seeds``: site k takes output k & 3 of the counter
    (r, k >> 2, 0, 0)."""
    key = torch.as_tensor(seeds, dtype=torch.int64).to(device)
    out = rng.philox4x32(_counters(nrep, m, ISING_UNIT, device), key)
    return out.reshape(nrep, -1)[:, :m]


def draw_uniforms(seeds, nrep: int, m: int, device=None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """(u_cand, u_acc) float32 (nrep, m) of the clock and XY kernels'
    colour sites under ``seeds``: site k takes outputs 2(k & 1) and
    2(k & 1) + 1 of the counter (r, k >> 1, 0, 0), each through its top
    24 bits."""
    key = torch.as_tensor(seeds, dtype=torch.int64).to(device)
    out = rng.philox4x32(_counters(nrep, m, PAIR_UNIT, device), key)
    out = out.reshape(nrep, -1, 2)[:, :m]
    return rng.bits_to_uniform(out[..., 0]), rng.bits_to_uniform(out[..., 1])


# ---------------------------------------------------------------------------
# Ising: plain versions
# ---------------------------------------------------------------------------

def ising_phase_plain(s: torch.Tensor, words: torch.Tensor, *, color: int,
                      nx: int, beta: float) -> torch.Tensor:
    """One masked Ising phase of (R, N) int8 states given the colour sites'
    (R, m) uint32 words: the TPU kernel's integer rule, every site reading
    the pre-phase state."""
    n = s.shape[-1]
    t4, t8 = accept_thresholds_u32(beta)
    nsum = field(s.to(torch.int32), nx)
    k = s.to(torch.int32) * nsum
    w = spread(words, n, color)
    accept = (k <= 0) | (w < torch.where(k == 2, t4, t8))
    mask = colour_mask(n, color, s.device)
    return torch.where(mask & accept, -s, s).to(torch.int8)


def ising_sums(s: torch.Tensor, nx: int) -> torch.Tensor:
    """(R, 2) int64 exact (Σ s, -Σ s_i (s_{i+1} + s_{i+nx}))."""
    f = s.to(torch.int64)
    e = -(f * (torch.roll(f, -1, -1) + torch.roll(f, -nx, -1))).sum(dim=-1)
    return torch.stack([f.sum(dim=-1), e], dim=-1)


def _words_of(seeds, bits, s: int, c: int, nrep: int, m0: int, device):
    if bits is not None:
        return bits[s, c].to(torch.int64) & 0xFFFFFFFF
    return draw_words(seeds[s, c], nrep, m0, device)


def ising_multisweep_plain(x: torch.Tensor, seeds=None, *, beta: float,
                           nx: int, bits: torch.Tensor | None = None):
    """Plain version of ``ising_multisweep_kernel``: S sweeps of (R, N)
    int8 states under the (S, 2, 2) keys ``seeds`` or the injected int32
    words ``bits`` (S, 2, R, ceil(N/2)); returns the new states and the
    (R, S, 2) int64 (m, e) after each sweep."""
    nrep, n = x.shape
    m0 = colour_sites(n, 0)
    sweeps = (bits if bits is not None else seeds).shape[0]
    obs = []
    for s in range(sweeps):
        for c in (0, 1):
            w = _words_of(seeds, bits, s, c, nrep, m0, x.device)
            x = ising_phase_plain(x, w, color=c, nx=nx, beta=beta)
        obs.append(ising_sums(x, nx))
    return x, torch.stack(obs, dim=1)


# ---------------------------------------------------------------------------
# clock: plain versions
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def clock_table(q: int) -> torch.Tensor:
    """(2, q) float32 (cos, sin) of the states k: ``cos_sin_2pi(k·(1/q))``
    with k and 1/q rounded to float32, the TPU masked kernel's decode.
    Cached: never write to it."""
    k = torch.arange(q, dtype=torch.float32) * trig.f32(1.0 / q)
    return torch.stack(trig.cos_sin_2pi(k))


def table_rows(q: int, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(2, TABLE) rows of the kernel's table, zero past q: float32
    :func:`clock_table`, or float64 ``core/tables.clock_sums_table`` (the
    sums')."""
    vals = clock_table(q) if dtype == torch.float32 else \
        tables.clock_sums_table(q)
    out = torch.zeros((2, TABLE), dtype=dtype)
    out[:, :q] = vals
    return out


@functools.lru_cache(maxsize=None)
def _device_table(q: int, device: str, dtype: torch.dtype) -> torch.Tensor:
    return table_rows(q, dtype).to(device)


def clock_phase_plain(s: torch.Tensor, u_cand: torch.Tensor,
                      u_acc: torch.Tensor, *, color: int, nx: int, q: int,
                      beta: float) -> torch.Tensor:
    """One masked clock phase of (R, N) int8 states given the colour sites'
    (R, m) float32 uniforms, in the TPU kernel's float32 order."""
    n = s.shape[-1]
    tab = clock_table(q).to(s.device)
    idx = s.to(torch.int64)
    cx, sx = tab[0][idx], tab[1][idx]
    hx, hy = field(cx, nx), field(sx, nx)
    uc = spread(u_cand, n, color)
    new = s.to(torch.int32) + (uc * trig.f32(q - 1)).to(torch.int32) + 1
    new = torch.where(new >= q, new - q, new)
    cn, sn = tab[0][new.to(torch.int64)], tab[1][new.to(torch.int64)]
    de = -((cn - cx) * hx + (sn - sx) * hy)
    p = torch.exp(trig.f32(-beta) * torch.clamp_min(de, 0.0))
    accept = spread(u_acc, n, color) < p
    mask = colour_mask(n, color, s.device)
    return torch.where(mask & accept, new, s.to(torch.int32)).to(torch.int8)


def clock_sums(s: torch.Tensor, nx: int, q: int) -> torch.Tensor:
    """(R, 3) float64 (Σ cos, Σ sin, -Σ cos(θ_i - θ_j) over the bonds
    i, i+1 and i, i+nx) from the float64 table."""
    tab = tables.clock_sums_table(q).to(s.device)
    idx = s.to(torch.int64)
    c, sn = tab[0][idx], tab[1][idx]
    e = -(c * (torch.roll(c, -1, -1) + torch.roll(c, -nx, -1))
          + sn * (torch.roll(sn, -1, -1) + torch.roll(sn, -nx, -1))
          ).sum(dim=-1)
    return torch.stack([c.sum(dim=-1), sn.sum(dim=-1), e], dim=-1)


def clock_multisweep_plain(x: torch.Tensor, seeds=None, *, beta: float,
                           nx: int, q: int, u: tuple | None = None):
    """Plain version of ``clock_multisweep_kernel``: S sweeps of (R, N) int8
    states under the (S, 2, 2) keys ``seeds`` or the injected float32
    (u_cand, u_acc), each (S, 2, R, ceil(N/2)); returns the new states and
    the (R, S, 3) float64 sums after each sweep."""
    nrep, n = x.shape
    m0 = colour_sites(n, 0)
    sweeps = (u[0] if u is not None else seeds).shape[0]
    obs = []
    for s in range(sweeps):
        for c in (0, 1):
            uc, ua = ((u[0][s, c], u[1][s, c]) if u is not None
                      else draw_uniforms(seeds[s, c], nrep, m0, x.device))
            x = clock_phase_plain(x, uc, ua, color=c, nx=nx, q=q, beta=beta)
        obs.append(clock_sums(x, nx, q))
    return x, torch.stack(obs, dim=1)


# ---------------------------------------------------------------------------
# XY: plain versions
# ---------------------------------------------------------------------------

def xy_sums(sx: torch.Tensor, sy: torch.Tensor, nx: int) -> torch.Tensor:
    """(R, 3) float64 (Σ S_x, Σ S_y, -Σ S_i·(S_{i+1} + S_{i+nx}))."""
    fx, fy = sx.to(torch.float64), sy.to(torch.float64)
    e = -(fx * (torch.roll(fx, -1, -1) + torch.roll(fx, -nx, -1))
          + fy * (torch.roll(fy, -1, -1) + torch.roll(fy, -nx, -1))
          ).sum(dim=-1)
    return torch.stack([fx.sum(dim=-1), fy.sum(dim=-1), e], dim=-1)


def xy_phase_plain(sx: torch.Tensor, sy: torch.Tensor, rand, *, color: int,
                   nx: int, beta: float, measuring: bool = False):
    """Plain version of ``xy_phase_kernel``: the new (R, N) float32 planes
    after one Metropolis phase of ``color``; ``rand`` is a Philox key
    ((2,) uint32) or the colour sites' injected (u_cand, u_acc), (R, m)
    each.  With ``measuring`` also the (R, 3) float64 sums of the new
    state."""
    nrep, n = sx.shape
    if isinstance(rand, (tuple, list)):
        u_cand, u_acc = rand
    else:
        u_cand, u_acc = draw_uniforms(rand, nrep, colour_sites(n, 0),
                                      sx.device)
    hx, hy = field(sx, nx), field(sy, nx)
    fx, fy = metropolis_update(sx, sy, hx, hy, spread(u_cand, n, color),
                               spread(u_acc, n, color), beta)
    mask = colour_mask(n, color, sx.device)
    fx, fy = torch.where(mask, fx, sx), torch.where(mask, fy, sy)
    if not measuring:
        return fx, fy
    return fx, fy, xy_sums(fx, fy, nx)


def xy_or_phase_plain(sx: torch.Tensor, sy: torch.Tensor, *, color: int,
                      nx: int):
    """Plain version of ``xy_phase_kernel``'s over-relaxation mode: the new
    (R, N) planes after one over-relaxation phase of ``color``."""
    n = sx.shape[-1]
    fx, fy = reflect(sx, sy, field(sx, nx), field(sy, nx))
    mask = colour_mask(n, color, sx.device)
    return torch.where(mask, fx, sx), torch.where(mask, fy, sy)


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

_VOID = ctypes.c_void_p
_INT = ctypes.c_int
_UINT = ctypes.c_uint


def _lib() -> ctypes.CDLL:
    lib = _build.load("helical_pallas")
    if lib.hp_ising_multisweep.argtypes is not None:
        return lib
    lib.hp_ising_multisweep.argtypes = (
        [_VOID] * 5 + [_INT] * 4 + [_UINT] * 2 + [_INT] * 2 + [_VOID])
    lib.hp_clock_multisweep.argtypes = (
        [_VOID] * 9 + [_INT] * 5 + [ctypes.c_float] + [_INT] * 2 + [_VOID])
    lib.hp_xy_phase.argtypes = (
        [_VOID] * 8 + [_INT] * 5 + [ctypes.c_float, _UINT, _UINT]
        + [_INT] * 4 + [_VOID])
    lib.hp_xy_or.argtypes = [_VOID] * 4 + [_INT] * 8 + [_VOID]
    lib.hp_grid_blocks.argtypes = [_INT, _INT, ctypes.POINTER(_INT)]
    for fn in (lib.hp_ising_multisweep, lib.hp_clock_multisweep,
               lib.hp_xy_phase, lib.hp_xy_or, lib.hp_grid_blocks):
        fn.restype = _INT
    lib.hp_error_string.argtypes = [_INT]
    lib.hp_error_string.restype = ctypes.c_char_p
    return lib


def _check(x: torch.Tensor, dtype: torch.dtype, *others: torch.Tensor
           ) -> None:
    """The kernels take contiguous (R, N) tensors of ``dtype`` on one CUDA
    device (``others`` of x's shape and type, in distinct storage)."""
    if x.dim() != 2:
        raise ValueError(f"states must be (R, N), got {tuple(x.shape)}")
    for t in (x, *others):
        if t.shape != x.shape or t.dtype != dtype:
            raise ValueError(f"states must be {dtype} {tuple(x.shape)}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if not t.is_cuda or t.device != x.device or not t.is_contiguous():
            raise ValueError("states must be contiguous on one CUDA device")
    if len({t.data_ptr() for t in (x, *others)}) != 1 + len(others):
        raise ValueError("the planes must not share storage")


def _check_injected(ref: torch.Tensor, shape, dtype, *planes) -> None:
    for p in planes:
        if tuple(p.shape) != tuple(shape) or p.dtype != dtype:
            raise ValueError(f"injected randomness must be {dtype} "
                             f"{tuple(shape)}, got {p.dtype} "
                             f"{tuple(p.shape)}")
        if p.device != ref.device or not p.is_contiguous():
            raise ValueError("injected randomness must be contiguous on the "
                             "states' device")


def _seam(x: torch.Tensor, nx: int) -> torch.Tensor | None:
    """The (R, 2 nx) snapshot scratch of rows 0 and ny-1 at odd N."""
    if x.shape[-1] % 2 == 0:
        return None
    return torch.empty((x.shape[0], 2 * nx), dtype=x.dtype, device=x.device)


def _replica_vectors(nrep: int, n: int, off0: int, width: int) -> int:
    """The most aligned vectors of ``width`` elements one replica of n
    elements touches, replica r starting off0 + r n elements past an
    aligned address (the residues repeat within 16 replicas)."""
    return max((off0 + r * n) % width + n - 1 for r in
               range(min(nrep, 16))) // width + 1


def ising_tiles(nrep: int, n: int, nx: int, offset: int = 0) -> dict:
    """Launch constants of the multisweep kernels on (R, N) int8
    states whose first byte lies ``offset`` bytes past a 16-B aligned
    address (``data_ptr() % 16``): ``off0`` that offset, ``tpr`` the tiles
    of THREADS vectors a replica (the longest's), ``ou`` = -nx mod 16 and
    ``od`` = nx mod 16 (the up window of a vector at site a is bytes ou ..
    ou + 15 of the aligned pair at a - nx - ou; the down window bytes od ..
    of the pair at a + nx - od).  Tile ts of replica r holds vectors
    (off0 + r N) // 16 + THREADS ts + t, t < THREADS, while they touch the
    replica; block b of the grid takes tiles b, b + blocks, ... (replica
    major).  The clock kernel's float64 sums of a (replica, sweep) are tpr
    tile partials, in tile order."""
    off0 = offset % VEC_BYTES
    span = _replica_vectors(nrep, n, off0, VEC_BYTES)
    return {"off0": off0, "tpr": -(-span // THREADS), "ou": -nx % VEC_BYTES,
            "od": nx % VEC_BYTES}


def xy_tiles(nrep: int, n: int, nx: int, offsets=(0,),
             measuring: bool = False, vpt: int | None = None) -> dict:
    """Launch constants of ``xy_phase_kernel`` on (R, N) float32 planes
    whose pointers lie ``offsets`` bytes past 16-B aligned addresses (the
    planes it reads and writes): ``vec`` 1 where they share one offset
    (16-B vector loads and stores; else every float alone, tiled from
    each replica's start), ``off0`` that offset in floats, ``vpt`` the
    float4 vectors a thread takes (``vpt`` if given, else XY_VPT: more in
    the ``measuring`` modes, whose partials reduce_kernel adds), ``nblk``
    the grid's blocks a
    replica (each vpt THREADS vectors: thread t of block b takes vectors
    b vpt THREADS + j THREADS + t, j < vpt, in that order, and its sums
    in that order and site by site are its share of the block's
    partial), ``su`` = -nx mod 4 and ``sd`` = nx mod 4."""
    width = VEC_BYTES // 4
    vec = len(set(offsets)) == 1 and offsets[0] % 4 == 0
    off0 = offsets[0] // 4 if vec else 0
    span = _replica_vectors(nrep, n, off0, width)
    vpt = vpt or XY_VPT[bool(measuring)]
    return {"off0": off0, "vpt": vpt, "nblk": -(-span // (THREADS * vpt)),
            "su": -nx % width, "sd": nx % width, "vec": int(vec)}


def ising_multisweep(x: torch.Tensor, seeds=None, *, beta: float, nx: int,
                     bits: torch.Tensor | None = None):
    """S sweeps of (R, N) int8 states, in place (returned): ``ising_
    multisweep_kernel`` (one launch) on CUDA tensors,
    :func:`ising_multisweep_plain` on CPU tensors.  Keys (S, 2, 2) or
    injected int32 words (S, 2, R, ceil(N/2)).  Returns (x, obs), obs the
    (R, S, 2) int64 (m, e) of every sweep."""
    if _on_cpu(x):
        new, obs = ising_multisweep_plain(x, seeds, beta=beta, nx=nx,
                                          bits=bits)
        return x.copy_(new), obs
    _check(x, torch.int8)
    nrep, n = x.shape
    check_shape(nrep, n, nx)
    if bits is not None:
        sweeps = bits.shape[0]
        _check_injected(x, (sweeps, 2, nrep, colour_sites(n, 0)),
                        torch.int32, bits)
        seeds_dev = torch.zeros((sweeps, 2, 2), dtype=torch.int32,
                                device=x.device)
    else:
        sweeps = int(seeds.shape[0])
        seeds_dev = multispin_rng.keys_to(seeds, x.device)
    t4, t8 = accept_thresholds_u32(beta)
    seam = _seam(x, nx)
    tiles = ising_tiles(nrep, n, nx, x.data_ptr())
    # zeroed: the kernel adds each block's sums with an atomic
    obs = torch.zeros((nrep, sweeps, 2), dtype=torch.int64, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        code = lib.hp_ising_multisweep(
            x.data_ptr(), None if seam is None else seam.data_ptr(),
            seeds_dev.data_ptr(), None if bits is None else bits.data_ptr(),
            obs.data_ptr(), nrep, n, nx, sweeps, t4, t8, tiles["off0"],
            tiles["tpr"], _stream(x))
    raise_on(code, lib.hp_error_string, "helical ising_multisweep_kernel")
    LAUNCHES["ising_multisweep"] += 1
    return x, obs


def clock_multisweep(x: torch.Tensor, seeds=None, *, beta: float, nx: int,
                     q: int, u: tuple | None = None):
    """S sweeps of (R, N) int8 clock states, in place (returned):
    ``clock_multisweep_kernel`` (one launch) on CUDA tensors,
    :func:`clock_multisweep_plain` on CPU tensors.  Keys (S, 2, 2) or
    injected float32 (u_cand, u_acc), (S, 2, R, ceil(N/2)) each.  Returns
    (x, obs), obs the (R, S, 3) float64 (Σ cos, Σ sin, E)."""
    if not 2 <= q < TABLE:
        raise ValueError(f"q={q}: the kernel's tables hold 2 <= q < {TABLE}")
    if _on_cpu(x):
        new, obs = clock_multisweep_plain(x, seeds, beta=beta, nx=nx, q=q,
                                          u=u)
        return x.copy_(new), obs
    _check(x, torch.int8)
    nrep, n = x.shape
    check_shape(nrep, n, nx)
    if u is not None:
        sweeps = u[0].shape[0]
        _check_injected(x, (sweeps, 2, nrep, colour_sites(n, 0)),
                        torch.float32, *u)
        seeds_dev = torch.zeros((sweeps, 2, 2), dtype=torch.int32,
                                device=x.device)
    else:
        sweeps = int(seeds.shape[0])
        seeds_dev = multispin_rng.keys_to(seeds, x.device)
    dev = x.device
    tab = _device_table(q, str(dev), torch.float32)
    tab64 = _device_table(q, str(dev), torch.float64)
    seam = _seam(x, nx)
    tiles = ising_tiles(nrep, n, nx, x.data_ptr())
    partials = torch.empty((nrep, sweeps, tiles["tpr"], 3),
                           dtype=torch.float64, device=dev)
    obs = torch.empty((nrep, sweeps, 3), dtype=torch.float64, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        code = lib.hp_clock_multisweep(
            x.data_ptr(), None if seam is None else seam.data_ptr(),
            seeds_dev.data_ptr(), None if u is None else u[0].data_ptr(),
            None if u is None else u[1].data_ptr(), tab.data_ptr(),
            tab64.data_ptr(), partials.data_ptr(), obs.data_ptr(), nrep, n,
            nx, q, sweeps, -float(beta), tiles["off0"], tiles["tpr"],
            _stream(x))
    raise_on(code, lib.hp_error_string, "helical clock_multisweep_kernel")
    LAUNCHES["clock_multisweep"] += 1
    return x, obs


def grid_blocks(kind: int, odd: bool) -> int:
    """Blocks of a multisweep kernel's cooperative grid on the current
    device (``kind`` 0 Ising, 1 clock; ``odd`` the odd-N instantiation)."""
    lib = _lib()
    blocks = _INT(0)
    raise_on(lib.hp_grid_blocks(kind, int(odd), ctypes.byref(blocks)),
             lib.hp_error_string, "hp_grid_blocks")
    return blocks.value


# xy_phase_kernel's modes (csrc/helical_pallas.cu)
_UPDATE, _FUSED, _MEASURE = 0, 1, 2


def _xy_launch(sx, sy, out, mode: int, *, color: int = 0, nx: int,
               beta: float = 1.0, rand=None):
    """One launch of ``xy_phase_kernel``; returns the (R, 3) sums where
    the mode measures, else None."""
    nrep, n = sx.shape
    dev = sx.device
    injected = isinstance(rand, (tuple, list))
    if injected:
        _check_injected(sx, (nrep, colour_sites(n, 0)), torch.float32, *rand)
    s0, s1 = (0, 0) if rand is None or injected else seed_words(rand)
    planes = (sx, sy) + (() if out is None else tuple(out))
    tiles = xy_tiles(nrep, n, nx, [p.data_ptr() % VEC_BYTES for p in planes],
                     mode != _UPDATE)
    partials = obs = None
    if mode != _UPDATE:
        partials = torch.empty((nrep, tiles["nblk"], 3), dtype=torch.float64,
                               device=dev)
        obs = torch.empty((nrep, 3), dtype=torch.float64, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        code = lib.hp_xy_phase(
            sx.data_ptr(), sy.data_ptr(),
            None if out is None else out[0].data_ptr(),
            None if out is None else out[1].data_ptr(),
            rand[0].data_ptr() if injected else None,
            rand[1].data_ptr() if injected else None,
            None if partials is None else partials.data_ptr(),
            None if obs is None else obs.data_ptr(), nrep, n, nx, color,
            mode, -float(beta), s0, s1, tiles["off0"], tiles["vpt"],
            tiles["nblk"], tiles["vec"], _stream(sx))
    raise_on(code, lib.hp_error_string, "helical xy_phase_kernel")
    return obs


def _xy_out(sx, sy, out):
    if out is None:
        return torch.empty_like(sx), torch.empty_like(sy)
    _check(sx, torch.float32, sy, *out)
    return out


def xy_phase(sx: torch.Tensor, sy: torch.Tensor, rand, *, color: int,
             nx: int, beta: float, measuring: bool = False, out=None):
    """One Metropolis phase of ``color`` on (R, N) float32 planes, out of
    place: ``xy_phase_kernel`` on CUDA tensors, :func:`xy_phase_plain` on
    CPU tensors.  ``rand``: a Philox key or the injected (u_cand, u_acc).
    ``out``: the (ox, oy) planes to write (distinct from the inputs), or
    new ones.  Returns (ox, oy), and with ``measuring`` the (R, 3) float64
    sums of the new state: fused into the launch at even N, from a measure
    launch over the new planes at odd N."""
    if _on_cpu(sx):
        res = xy_phase_plain(sx, sy, rand, color=color, nx=nx, beta=beta,
                             measuring=measuring)
        if out is None:
            return res
        out[0].copy_(res[0])
        out[1].copy_(res[1])
        return (*out, *res[2:])
    _check(sx, torch.float32, sy)
    check_shape(*sx.shape, nx)
    out = _xy_out(sx, sy, out)
    fused = measuring and sx.shape[-1] % 2 == 0
    obs = _xy_launch(sx, sy, out, _FUSED if fused else _UPDATE, color=color,
                     nx=nx, beta=beta, rand=rand)
    LAUNCHES["xy_phase_measuring" if fused else "xy_phase"] += 1
    if not measuring:
        return out
    if not fused:
        obs = xy_measure(*out, nx=nx)
    return (*out, obs)


def xy_measure(sx: torch.Tensor, sy: torch.Tensor, *, nx: int
               ) -> torch.Tensor:
    """(R, 3) float64 sums of (R, N) planes: ``xy_phase_kernel``'s measure
    mode on CUDA tensors, :func:`xy_sums` on CPU tensors."""
    if _on_cpu(sx):
        return xy_sums(sx, sy, nx)
    _check(sx, torch.float32, sy)
    check_shape(*sx.shape, nx)
    obs = _xy_launch(sx, sy, None, _MEASURE, nx=nx)
    LAUNCHES["xy_measure"] += 1
    return obs


def xy_or_phase(sx: torch.Tensor, sy: torch.Tensor, *, color: int, nx: int,
                out=None):
    """One over-relaxation phase of ``color``, out of place:
    ``xy_phase_kernel``'s over-relaxation mode on CUDA tensors (the tiles
    of :func:`xy_tiles`, XY_OR_VPT vectors a thread),
    :func:`xy_or_phase_plain` on CPU tensors.  Returns the (ox, oy)
    planes (``out`` or new ones)."""
    if _on_cpu(sx):
        res = xy_or_phase_plain(sx, sy, color=color, nx=nx)
        if out is None:
            return res
        out[0].copy_(res[0])
        out[1].copy_(res[1])
        return out
    _check(sx, torch.float32, sy)
    nrep, n = sx.shape
    check_shape(nrep, n, nx)
    out = _xy_out(sx, sy, out)
    tiles = xy_tiles(nrep, n, nx, [p.data_ptr() % VEC_BYTES
                                   for p in (sx, sy, *out)], vpt=XY_OR_VPT)
    lib = _lib()
    with torch.cuda.device(sx.device):
        code = lib.hp_xy_or(sx.data_ptr(), sy.data_ptr(), out[0].data_ptr(),
                            out[1].data_ptr(), nrep, n, nx, color,
                            tiles["off0"], tiles["vpt"], tiles["nblk"],
                            tiles["vec"], _stream(sx))
    raise_on(code, lib.hp_error_string,
             "helical xy_phase_kernel (over-relaxation)")
    LAUNCHES["xy_or"] += 1
    return out


# ---------------------------------------------------------------------------
# model-level entries (the JAX module's ising_multisweep, clock_multisweep,
# xy_sweep_packed, xy_sweep_measure_packed, xy_over_relax_sweep_packed and
# xy_observables_packed, on flat states)
# ---------------------------------------------------------------------------

def ising_densities(obs: torch.Tensor, nsites: int) -> dict:
    return {"m": per_site(obs[..., 0], nsites),
            "e": per_site(obs[..., 1], nsites)}


def planar_densities(obs: torch.Tensor, nsites: int) -> dict:
    """{m, my, e} of (..., 3) float64 sums (the clock's, XY's)."""
    return {k: per_site(obs[..., j], nsites)
            for j, k in enumerate(("m", "my", "e"))}


def multisweep(model, flat: torch.Tensor, key, sweeps: int, t0: int = 0):
    """Advance ``sweeps`` MCS of (R, N) Ising or clock states in place,
    with per-sweep densities {m, e} (clock: also {my}), (R, sweeps)
    float64; ``key`` is the call key and ``t0`` the global sweep index
    already completed, so sweep t draws under sweep_key(key, t)."""
    seeds = multispin_rng.sweep_phase_keys(key, sweeps, t0)
    if isinstance(model, Clock2DHelical):
        flat, obs = clock_multisweep(flat, seeds, beta=model.beta,
                                     nx=model.nx, q=model.q)
        return flat, planar_densities(obs, model.nsites)
    flat, obs = ising_multisweep(flat, seeds, beta=model.beta, nx=model.nx)
    return flat, ising_densities(obs, model.nsites)


class XYPlanes:
    """A batch's flat (R, N) XY planes and a spare pair the out-of-place
    phases write into; each phase swaps the two."""

    def __init__(self, state: XYFlatState):
        self.cur = (state.sx.contiguous(), state.sy.contiguous())
        self.spare = (torch.empty_like(self.cur[0]),
                      torch.empty_like(self.cur[1]))

    def _swap(self, res) -> None:
        self.cur, self.spare = (res[0], res[1]), self.cur

    def phase(self, model, rand, color: int, measuring: bool = False):
        res = xy_phase(*self.cur, rand, color=color, nx=model.nx,
                       beta=model.beta, measuring=measuring, out=self.spare)
        self._swap(res)
        return res[2] if measuring else None

    def or_phase(self, model, color: int) -> None:
        self._swap(xy_or_phase(*self.cur, color=color, nx=model.nx,
                               out=self.spare))


def xy_sweep(model, planes: XYPlanes, seeds) -> None:
    """One Metropolis MCS (colour 0, then colour 1) under the sweep's
    (2, 2) phase keys."""
    planes.phase(model, seeds[0], 0)
    planes.phase(model, seeds[1], 1)


def xy_sweep_measure(model, planes: XYPlanes, seeds) -> dict:
    """:func:`xy_sweep` with the densities of the new state."""
    planes.phase(model, seeds[0], 0)
    return planar_densities(planes.phase(model, seeds[1], 1, measuring=True),
                            model.nsites)


def xy_over_relax_sweep(model, planes: XYPlanes) -> None:
    planes.or_phase(model, 0)
    planes.or_phase(model, 1)


def xy_observables(model, planes: XYPlanes) -> dict:
    """{m, my, e} densities (R,) of the current planes."""
    return planar_densities(xy_measure(*planes.cur, nx=model.nx),
                            model.nsites)
