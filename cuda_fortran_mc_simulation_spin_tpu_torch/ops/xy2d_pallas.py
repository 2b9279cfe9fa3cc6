"""The periodic XY phases on the card: two CUDA kernels and their plain
versions.

Port of the single-device periodic part of
``cuda_fortran_mc_simulation_spin_tpu/ops/xy2d_pallas.py`` (the module
keeps its name so that its JAX counterpart is found by name; it launches
CUDA kernels, not Pallas ones).  ``csrc/xy2d_pallas.cu`` holds

- ``metropolis_kernel``, which replaces ``_metropolis_kernel``
  (pallas_call at ``:226``, ``_metropolis_phase``): one colour phase of
  the float32 component planes, uniforms from Philox or injected, and with
  ``measuring`` the per-replica (Σ S_x, Σ S_y, e) over both colours.  Its
  snapshot mode (``snap``) replaces ``_metropolis_measure_kernel``
  (``:457``, ``_metropolis_phase_b_measure``): the same phase with the
  autocorrelation A = Σ S·S0 against the t=0 snapshot fused beside the
  sums;
- ``over_relax_kernel``, which replaces ``_over_relax_kernel`` (``:265``,
  ``_over_relax_phase``): one reflection phase, the same sums optional.

Their halo modes run a mesh's shards (parallel/domain.py):

- ``metropolis_kernel<N, true>`` replaces ``_halo_metropolis_kernel``
  (pallas_call at ``:726``, :func:`sharded_phase`; its field
  ``_halo_field`` ``:499``), the snapshot mode included, so a disorder
  sweep on a mesh measures A in its phase b;
- ``over_relax_kernel<true>`` replaces ``_halo_or_kernel`` (``:770``,
  :func:`sharded_or_phase`), with the fused sums of its measuring phase b
  (JAX measures after OR in a separate pass, ``_xy_local_obs``).

The rows past a shard's edges come from the exchanged (up, dn) halos of
each component, with an x split the columns from the exchanged columns;
parity and the Philox counter from the shard's global (replica, row,
column), so a shard draws the unsharded lattice's uniforms.  Their plain
versions are :func:`sharded_phase_plain` and
:func:`sharded_or_phase_plain`.

Layout: (R, ny, nx/2) float32 planes for every even nx, with the
checkerboard of core/lattice.py.  The JAX engine pads nx/2 to a multiple
of 128 lanes (``pad_planes``) and substitutes the x wrap at the real seam
(``stencil.lr_sum_padded``); that is TPU layout, so the port keeps
unpadded planes and wraps column 0 <-> column half-1 directly.  A phase
updates its colour in place: it reads only that colour's own old value
and the other colour, so no site reads what another writes.

The field is built in the kernel's order, ``(up + dn) + (o + side)``
(``stencil.nbr_sum``), in the plain version as in the kernel.

Random words: the Philox key of the (sample, t, phase)
(``rng.seeds_from_key``) and the counter (replica, row, column, 0); word 0
gives u_cand and word 1 u_acc, each from its top 24 bits
(``rng.bits_to_uniform``).  :func:`draw_uniforms` is the plain version of
that draw.

Sums: each f32 value (S_x, S_y, S·h, and with a snapshot the per-colour
S·S0) is widened to float64 and summed in float64: per block in the
kernel, then per replica in a fixed order by a second small kernel, so
runs repeat bitwise; the plain version sums the same float32 values in
float64, and the two agree to float64 rounding.  The JAX kernels sum in
float32.

Bitwise kernel = plain on the card for the state: the kernel spells the
float32 chain with ``__fmul_rn`` / ``__fadd_rn`` / ``__fsub_rn`` (no FMA
contraction) in the order of models/xy2d.py's :func:`metropolis_update`
and :func:`reflect`, and calls ``expf`` and ``rsqrtf`` as ``torch.exp``
and ``torch.rsqrt`` do on CUDA tensors.

A wrapper takes the plain version for a CPU tensor; for a CUDA tensor it
launches the kernel or raises.  ``LAUNCHES`` counts launches.  The sweep
entries are those of the JAX padded API (``padded_sweep``,
``padded_sweep_measure``, ``padded_or_sweep``, ``padded_or_sweep_measure``)
as :func:`sweep`, :func:`sweep_measured`, :func:`or_sweep` and
:func:`or_sweep_measured`, and JAX's ``sweep_measure`` (the disorder
protocols' sweep with A) as :func:`sweep_measure`.
"""

from __future__ import annotations

import ctypes

import torch

from cuda_fortran_mc_simulation_spin_tpu_torch.core import lattice, rng
from cuda_fortran_mc_simulation_spin_tpu_torch.core.lattice import _odd_rows
from cuda_fortran_mc_simulation_spin_tpu_torch.models.xy2d import (
    XYState,
    metropolis_update,
    reflect,
)
from cuda_fortran_mc_simulation_spin_tpu_torch.ops import _build, multispin_rng
from cuda_fortran_mc_simulation_spin_tpu_torch.ops.ising2d_multispin import (
    MASK32,
    _on_cpu,
    _stream,
    offsets,
    per_site,
)

LAUNCHES = {"metropolis": 0, "metropolis_measuring": 0,
            "metropolis_snapshot": 0, "over_relax": 0,
            "over_relax_measuring": 0, "halo_metropolis": 0,
            "halo_metropolis_measuring": 0, "halo_metropolis_snapshot": 0,
            "halo_over_relax": 0, "halo_over_relax_measuring": 0}

# threads of a block of either kernel (csrc/xy2d_pallas.cu THREADS)
THREADS = 256


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

def nbr_sum(o: torch.Tensor, color: int) -> torch.Tensor:
    """4-neighbour sum of every site of ``color`` from the other colour's
    (..., ny, half) plane, in the kernel's order (up + dn) + (o + side):
    rows wrap at ny, columns at half."""
    odd = _odd_rows(o.shape[-2], o.device)
    up = torch.roll(o, 1, dims=-2)
    dn = torch.roll(o, -1, dims=-2)
    minus = torch.roll(o, 1, dims=-1)   # column i - 1
    plus = torch.roll(o, -1, dims=-1)   # column i + 1
    side = (torch.where(odd, plus, minus) if color == 0
            else torch.where(odd, minus, plus))
    return (up + dn) + (o + side)


def draw_uniforms(seeds, nrep: int, ny: int, half: int, device=None,
                  rep0: int = 0, row0: int = 0, col0: int = 0):
    """(u_cand, u_acc), (nrep, ny, half) float32, that a phase under the
    Philox key ``seeds`` draws: words 0 and 1 of counter (replica, row,
    column, 0); a shard's at its global offsets (rep0, row0, col0)."""
    gen = multispin_rng.word_stream(seeds, nrep, ny, half, device, rep0,
                                    row0, col0)
    return rng.bits_to_uniform(gen()), rng.bits_to_uniform(gen())


def _obs_plain(fx, fy, ox, oy, hx, hy, snap=None) -> torch.Tensor:
    """(R, 3) float64 (Σ S_x, Σ S_y, -Σ_b S·h): the updated colour and the
    other one; each bond once, from the updated colour's field.  With the
    snapshot planes ``snap`` (of the updated colour and the other, as the
    phase's planes) also A = Σ S·S0 from the float32 terms of each colour:
    (R, 4)."""
    def total(v):
        return v.to(torch.float64).sum(dim=(-2, -1))
    sums = [total(fx) + total(ox), total(fy) + total(oy),
            -total(fx * hx + fy * hy)]
    if snap is not None:
        snsx, snsy, snox, snoy = snap
        sums.append(total(fx * snsx + fy * snsy)
                    + total(ox * snox + oy * snoy))
    return torch.stack(sums, dim=-1)


def metropolis_phase_plain(sx, sy, ox, oy, rand, *, color: int,
                           beta: float, measuring: bool = False,
                           snap=None):
    """Plain version of ``metropolis_kernel``: one Metropolis phase of
    colour ``color`` on (R, ny, half) float32 planes, in place.  ``rand``
    is a Philox key ((2,) uint32) or injected (u_cand, u_acc) planes.
    Returns (sx, sy), and with ``measuring`` also the (R, 3) float64
    sums; with the t=0 snapshot ``snap`` ((sx, sy, ox, oy) of the
    snapshot, in the phase's order) the (R, 4) sums with A."""
    if isinstance(rand, (tuple, list)):
        u_cand, u_acc = rand
    else:
        u_cand, u_acc = draw_uniforms(rand, *sx.shape, sx.device)
    hx, hy = nbr_sum(ox, color), nbr_sum(oy, color)
    fx, fy = metropolis_update(sx, sy, hx, hy, u_cand, u_acc, beta)
    sx.copy_(fx)
    sy.copy_(fy)
    if not (measuring or snap is not None):
        return sx, sy
    return sx, sy, _obs_plain(sx, sy, ox, oy, hx, hy, snap)


def over_relax_phase_plain(sx, sy, ox, oy, *, color: int,
                           measuring: bool = False):
    """Plain version of ``over_relax_kernel``: one reflection phase of
    colour ``color``, in place; with ``measuring`` also the (R, 3)
    float64 sums."""
    hx, hy = nbr_sum(ox, color), nbr_sum(oy, color)
    fx, fy = reflect(sx, sy, hx, hy)
    sx.copy_(fx)
    sy.copy_(fy)
    if not measuring:
        return sx, sy
    return sx, sy, _obs_plain(sx, sy, ox, oy, hx, hy)


def _shard_field(ox, oy, halos_x, halos_y, color: int, row0: int,
                 cols_x=None, cols_y=None):
    """(hx, hy) of a shard's colour from the other colour's blocks, their
    (up, dn) halo rows and, with an x split, (left, right) columns, in the
    kernel's order (core/lattice.neighbor_sums_halo)."""
    return tuple(
        lattice.neighbor_sums_halo(o, color, row0, *h,
                                   *(c if c is not None else (None, None)))
        for o, h, c in ((ox, halos_x, cols_x), (oy, halos_y, cols_y)))


def sharded_phase_plain(sx, sy, ox, oy, halos_x, halos_y, seeds, offs, *,
                        color: int, beta: float, cols_x=None, cols_y=None,
                        u_cand=None, u_acc=None, measuring: bool = False,
                        snap=None):
    """Plain version of ``metropolis_kernel<N, true>``: one Metropolis
    phase of a (y[, x])-sharded (R, L, half) block, in place, given the
    other colour's blocks, their (up, dn) halo rows ``halos_x``,
    ``halos_y`` and with an x split their (left, right) columns
    ``cols_x``, ``cols_y``; offs = (rep0, row0[, col0]).  Uniforms
    injected, else from Philox at the shard's global coordinates.
    Returns (sx, sy), and with ``measuring`` also the shard's (R, 3)
    float64 partials (Σ S_x, Σ S_y, e); with the snapshot ``snap`` (the
    phase's (sx, sy, ox, oy) order) the (R, 4) partials with A."""
    rep0, row0, *rest = offsets(offs)
    col0 = rest[0] if rest else 0
    if u_cand is None:
        u_cand, u_acc = draw_uniforms(seeds, *sx.shape, sx.device, rep0,
                                      row0, col0)
    hx, hy = _shard_field(ox, oy, halos_x, halos_y, color, row0, cols_x,
                          cols_y)
    fx, fy = metropolis_update(sx, sy, hx, hy, u_cand, u_acc, beta)
    sx.copy_(fx)
    sy.copy_(fy)
    if not (measuring or snap is not None):
        return sx, sy
    return sx, sy, _obs_plain(sx, sy, ox, oy, hx, hy, snap)


def sharded_or_phase_plain(sx, sy, ox, oy, halos_x, halos_y, offs, *,
                           color: int, cols_x=None, cols_y=None,
                           measuring: bool = False):
    """Plain version of ``over_relax_kernel<true>``: one reflection phase
    of a shard, in place; with ``measuring`` also its (R, 3) float64
    partials."""
    row0 = offsets(offs)[1]
    hx, hy = _shard_field(ox, oy, halos_x, halos_y, color, row0, cols_x,
                          cols_y)
    fx, fy = reflect(sx, sy, hx, hy)
    sx.copy_(fx)
    sy.copy_(fy)
    if not measuring:
        return sx, sy
    return sx, sy, _obs_plain(sx, sy, ox, oy, hx, hy)


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

_VOID = ctypes.c_void_p
_INT = ctypes.c_int
_UINT = ctypes.c_uint


def snapshot_pointers(planes):
    """A C array of the four snapshot planes' device pointers, or None."""
    if planes is None:
        return None
    return (_VOID * 4)(*(p.data_ptr() for p in planes))


def _lib() -> ctypes.CDLL:
    lib = _build.load("xy2d_pallas")
    if lib.xy_metropolis.argtypes is not None:
        return lib
    lib.xy_metropolis.argtypes = (
        [_VOID] * 9 + [_INT] * 4 + [ctypes.c_float, _UINT, _UINT, _VOID])
    lib.xy_over_relax.argtypes = [_VOID] * 6 + [_INT] * 4 + [_VOID]
    lib.xy_halo_metropolis.argtypes = (
        [_VOID] * 10 + [_INT] * 7 + [ctypes.c_float, _UINT, _UINT, _VOID])
    lib.xy_halo_over_relax.argtypes = [_VOID] * 7 + [_INT] * 7 + [_VOID]
    for fn in (lib.xy_metropolis, lib.xy_over_relax, lib.xy_halo_metropolis,
               lib.xy_halo_over_relax):
        fn.restype = _INT
    lib.xy_error_string.argtypes = [_INT]
    lib.xy_error_string.restype = ctypes.c_char_p
    return lib


def _check_planes(*planes: torch.Tensor) -> None:
    """The kernels take float32 contiguous (R, ny, half) planes on one
    CUDA device."""
    ref = planes[0]
    if ref.dim() != 3:
        raise ValueError(f"planes must be (R, ny, half), got {ref.shape}")
    nrep, ny, half = ref.shape
    if ny < 2 or half < 1 or nrep > 65535 or ny * half >= 2 ** 31:
        raise ValueError(f"kernel shape out of range: {tuple(ref.shape)}")
    for p in planes:
        if p.shape != ref.shape or p.dtype != torch.float32:
            raise ValueError(f"planes must be float32 {tuple(ref.shape)}, "
                             f"got {p.dtype} {tuple(p.shape)}")
        if p.device != ref.device or not p.is_cuda:
            raise ValueError("planes must lie on one CUDA device")
        if not p.is_contiguous():
            raise ValueError("planes must be contiguous")


# sums a block and a replica: (Σ S_x, Σ S_y, e), and A where there is a
# snapshot (csrc/xy2d_site.cuh)
NSUMS = 4


def scratch(sx: torch.Tensor, measuring: bool, rows: int | None = None,
            nsums: int = NSUMS):
    """(partials, obs) of a measuring launch: per-block float64 sums
    (rows, blocks, nsums) and their totals (rows, nsums), rows = R by
    default; else (None, None)."""
    if not measuring:
        return None, None
    nrep, ny, half = sx.shape
    rows = nrep if rows is None else rows
    blocks = -(-ny * half // THREADS)
    return (torch.empty((rows, blocks, nsums), dtype=torch.float64,
                        device=sx.device),
            torch.empty((rows, nsums), dtype=torch.float64,
                        device=sx.device))


def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def _raise_on(code: int, lib, name: str) -> None:
    if code != 0:
        msg = lib.xy_error_string(code).decode()
        raise RuntimeError(f"xy2d {name}: CUDA error {code} ({msg})")


def _launch_metropolis(sx, sy, ox, oy, rand, color, beta, measuring,
                       snap=None):
    planes = [sx, sy, ox, oy] + ([] if snap is None else list(snap))
    if isinstance(rand, (tuple, list)):
        u_cand, u_acc = rand
        _check_planes(*planes, u_cand, u_acc)
        s0 = s1 = 0
    else:
        _check_planes(*planes)
        u_cand = u_acc = None
        s0, s1 = (int(v) & MASK32 for v in torch.as_tensor(rand).tolist())
    nrep, ny, half = sx.shape
    measuring = measuring or snap is not None
    partials, obs = scratch(sx, measuring, nsums=3 if snap is None else 4)
    lib = _lib()
    with torch.cuda.device(sx.device):
        code = lib.xy_metropolis(
            sx.data_ptr(), sy.data_ptr(), ox.data_ptr(), oy.data_ptr(),
            _ptr(u_cand), _ptr(u_acc), snapshot_pointers(snap),
            _ptr(partials), _ptr(obs), nrep, ny, half, color, -float(beta),
            s0, s1, _stream(sx))
    _raise_on(code, lib, "metropolis_kernel")
    LAUNCHES["metropolis"] += 1
    if snap is not None:
        LAUNCHES["metropolis_snapshot"] += 1
        return sx, sy, obs
    if measuring:
        LAUNCHES["metropolis_measuring"] += 1
        return sx, sy, obs
    return sx, sy


def _launch_over_relax(sx, sy, ox, oy, color, measuring):
    _check_planes(sx, sy, ox, oy)
    nrep, ny, half = sx.shape
    partials, obs = scratch(sx, measuring, nsums=3)
    lib = _lib()
    with torch.cuda.device(sx.device):
        code = lib.xy_over_relax(
            sx.data_ptr(), sy.data_ptr(), ox.data_ptr(), oy.data_ptr(),
            _ptr(partials), _ptr(obs), nrep, ny, half, color, _stream(sx))
    _raise_on(code, lib, "over_relax_kernel")
    LAUNCHES["over_relax"] += 1
    if measuring:
        LAUNCHES["over_relax_measuring"] += 1
        return sx, sy, obs
    return sx, sy


def metropolis_phase(sx, sy, ox, oy, rand, *, color: int, beta: float,
                     measuring: bool = False, snap=None):
    """One Metropolis phase of colour ``color`` on (R, ny, half) float32
    planes, updated in place: ``metropolis_kernel`` on CUDA tensors,
    :func:`metropolis_phase_plain` on CPU tensors.  ``rand`` is the
    phase's Philox key or injected (u_cand, u_acc) planes.  Returns
    (sx, sy), and with ``measuring`` also the (R, 3) float64 sums
    (Σ S_x, Σ S_y, e) over both colours; with the t=0 snapshot ``snap``
    (four planes in the phase's (sx, sy, ox, oy) order; the snapshot
    mode) the (R, 4) sums with A = Σ S·S0."""
    if _on_cpu(sx):
        return metropolis_phase_plain(sx, sy, ox, oy, rand, color=color,
                                      beta=beta, measuring=measuring,
                                      snap=snap)
    return _launch_metropolis(sx, sy, ox, oy, rand, color, beta, measuring,
                              snap)


def over_relax_phase(sx, sy, ox, oy, *, color: int,
                     measuring: bool = False):
    """One over-relaxation phase of colour ``color``, in place:
    ``over_relax_kernel`` on CUDA tensors, :func:`over_relax_phase_plain`
    on CPU tensors."""
    if _on_cpu(sx):
        return over_relax_phase_plain(sx, sy, ox, oy, color=color,
                                      measuring=measuring)
    return _launch_over_relax(sx, sy, ox, oy, color, measuring)


def _halo_pointers(sx, halos_x, halos_y, cols_x, cols_y):
    """The kernels' (upx, upy, dnx, dny, lfx, lfy, rtx, rty) pointer array
    after checking the halos: contiguous float32 on the shard's device,
    rows (R, 1, half) and columns (R, L, 1)."""
    nrep, L, half = sx.shape
    if (cols_x is None) != (cols_y is None):
        raise ValueError("pass column halos of both components, or none")
    groups = [(tuple(halos_x) + tuple(halos_y), (nrep, 1, half))]
    if cols_x is not None:
        groups.append((tuple(cols_x) + tuple(cols_y), (nrep, L, 1)))
    for planes, shape in groups:
        for h in planes:
            if (h.shape != shape or h.dtype != torch.float32
                    or h.device != sx.device or not h.is_contiguous()):
                raise ValueError(f"halos must be contiguous float32 {shape} "
                                 f"on {sx.device}, got {h.dtype} "
                                 f"{tuple(h.shape)} on {h.device}")
    (upx, dnx), (upy, dny) = halos_x, halos_y
    lfx = lfy = rtx = rty = None
    if cols_x is not None:
        (lfx, rtx), (lfy, rty) = cols_x, cols_y
    return (_VOID * 8)(*(_ptr(t) for t in (upx, upy, dnx, dny, lfx, lfy,
                                            rtx, rty)))


def sharded_phase(sx, sy, ox, oy, halos_x, halos_y, seeds, offs, *,
                  color: int, beta: float, cols_x=None, cols_y=None,
                  u_cand=None, u_acc=None, measuring: bool = False,
                  snap=None):
    """One Metropolis phase of a (y[, x])-sharded (R, L, half) block of
    component planes, updated in place: ``metropolis_kernel<N, true>`` on
    CUDA tensors, :func:`sharded_phase_plain` on CPU tensors.  The
    arguments are JAX's ``sharded_phase`` (``:663``): ``halos_x``,
    ``halos_y`` the other colour's (up, dn) rows a component, ``cols_x``,
    ``cols_y`` its (left, right) columns with an x split (offs then (rep0,
    row0, col0)), injected ``u_cand``, ``u_acc`` or Philox words under
    ``seeds``.  Returns (sx, sy), and with ``measuring`` also the (R, 3)
    float64 partials (Σ S_x, Σ S_y, e); with ``snap`` (four t=0 snapshot
    blocks in the phase's order) the (R, 4) partials with A."""
    if _on_cpu(sx):
        return sharded_phase_plain(
            sx, sy, ox, oy, halos_x, halos_y, seeds, offs, color=color,
            beta=beta, cols_x=cols_x, cols_y=cols_y, u_cand=u_cand,
            u_acc=u_acc, measuring=measuring, snap=snap)
    planes = [sx, sy, ox, oy] + ([] if snap is None else list(snap))
    if u_cand is not None:
        _check_planes(*planes, u_cand, u_acc)
        s0 = s1 = 0
    else:
        _check_planes(*planes)
        s0, s1 = (int(v) & MASK32 for v in torch.as_tensor(seeds).tolist())
    halos = _halo_pointers(sx, halos_x, halos_y, cols_x, cols_y)
    rep0, row0, *rest = offsets(offs)
    col0 = rest[0] if rest else 0
    nrep, L, half = sx.shape
    measuring = measuring or snap is not None
    partials, obs = scratch(sx, measuring, nsums=3 if snap is None else 4)
    lib = _lib()
    with torch.cuda.device(sx.device):
        code = lib.xy_halo_metropolis(
            sx.data_ptr(), sy.data_ptr(), ox.data_ptr(), oy.data_ptr(),
            _ptr(u_cand), _ptr(u_acc), snapshot_pointers(snap), halos,
            _ptr(partials), _ptr(obs), nrep, L, half, color, rep0, row0,
            col0, -float(beta), s0, s1, _stream(sx))
    _raise_on(code, lib, "metropolis_kernel<N, true>")
    LAUNCHES["halo_metropolis"] += 1
    if snap is not None:
        LAUNCHES["halo_metropolis_snapshot"] += 1
    elif measuring:
        LAUNCHES["halo_metropolis_measuring"] += 1
    return (sx, sy, obs) if measuring else (sx, sy)


def sharded_or_phase(sx, sy, ox, oy, halos_x, halos_y, offs, *,
                     color: int, cols_x=None, cols_y=None,
                     measuring: bool = False):
    """One over-relaxation phase of a (y[, x])-sharded block, in place:
    ``over_relax_kernel<true>`` on CUDA tensors,
    :func:`sharded_or_phase_plain` on CPU tensors (JAX's
    ``sharded_or_phase``, ``:741``); with ``measuring`` also the (R, 3)
    float64 partials."""
    if _on_cpu(sx):
        return sharded_or_phase_plain(sx, sy, ox, oy, halos_x, halos_y,
                                      offs, color=color, cols_x=cols_x,
                                      cols_y=cols_y, measuring=measuring)
    _check_planes(sx, sy, ox, oy)
    halos = _halo_pointers(sx, halos_x, halos_y, cols_x, cols_y)
    rep0, row0, *rest = offsets(offs)
    col0 = rest[0] if rest else 0
    nrep, L, half = sx.shape
    partials, obs = scratch(sx, measuring, nsums=3)
    lib = _lib()
    with torch.cuda.device(sx.device):
        code = lib.xy_halo_over_relax(
            sx.data_ptr(), sy.data_ptr(), ox.data_ptr(), oy.data_ptr(),
            halos, _ptr(partials), _ptr(obs), nrep, L, half, color, rep0,
            row0, col0, _stream(sx))
    _raise_on(code, lib, "over_relax_kernel<true>")
    LAUNCHES["halo_over_relax"] += 1
    if measuring:
        LAUNCHES["halo_over_relax_measuring"] += 1
        return sx, sy, obs
    return sx, sy


# ---------------------------------------------------------------------------
# sweeps (the JAX padded API, on unpadded planes)
# ---------------------------------------------------------------------------

def _densities(model, obs) -> dict[str, torch.Tensor]:
    return {k: per_site(obs[:, j], model.nsites)
            for j, k in enumerate(("m", "my", "e"))}


def sweep(model, st: XYState, seeds) -> XYState:
    """One Metropolis MCS of (R, ny, half) planes, in place, given the
    sweep's (2, 2) phase keys (JAX ``padded_sweep``)."""
    ax, ay, bx, by = st
    metropolis_phase(ax, ay, bx, by, seeds[0], color=0, beta=model.beta)
    metropolis_phase(bx, by, ax, ay, seeds[1], color=1, beta=model.beta)
    return st


def densities(model, obs) -> dict[str, torch.Tensor]:
    """(R, 4) float64 sums -> the disorder protocols' {mx, my, e, A}
    densities (R,)."""
    return {k: per_site(obs[..., j], model.nsites)
            for j, k in enumerate(("mx", "my", "e", "A"))}


def sweep_measure(model, st: XYState, snap: XYState, seeds):
    """One Metropolis MCS of (R, ny, half) planes, in place, given the
    sweep's (2, 2) phase keys, phase b in the snapshot mode against the
    t=0 snapshot ``snap``: returns (st, {mx, my, e, A} densities (R,)
    float64) (JAX ``sweep_measure``, ``xy2d_pallas.py:472``)."""
    ax, ay, bx, by = st
    metropolis_phase(ax, ay, bx, by, seeds[0], color=0, beta=model.beta)
    _, _, obs = metropolis_phase(bx, by, ax, ay, seeds[1], color=1,
                                 beta=model.beta,
                                 snap=(snap.bx, snap.by, snap.ax, snap.ay))
    return st, densities(model, obs)


def sweep_measured(model, st: XYState, seeds):
    """:func:`sweep` with the (m, my, e) densities (R,) float64 fused into
    phase b (JAX ``padded_sweep_measure``)."""
    ax, ay, bx, by = st
    metropolis_phase(ax, ay, bx, by, seeds[0], color=0, beta=model.beta)
    _, _, obs = metropolis_phase(bx, by, ax, ay, seeds[1], color=1,
                                 beta=model.beta, measuring=True)
    return st, _densities(model, obs)


def or_sweep(model, st: XYState) -> XYState:
    """One over-relaxation sweep, in place (JAX ``padded_or_sweep``)."""
    ax, ay, bx, by = st
    over_relax_phase(ax, ay, bx, by, color=0)
    over_relax_phase(bx, by, ax, ay, color=1)
    return st


def or_sweep_measured(model, st: XYState):
    """:func:`or_sweep` with the densities fused into the colour-1 phase
    (JAX ``padded_or_sweep_measure``)."""
    ax, ay, bx, by = st
    over_relax_phase(ax, ay, bx, by, color=0)
    _, _, obs = over_relax_phase(bx, by, ax, ay, color=1, measuring=True)
    return st, _densities(model, obs)
