"""The dense dual-colour engine of helical XY (odd nx), component planes:
two CUDA kernels and their plain versions.

Port of ``cuda_fortran_mc_simulation_spin_tpu/ops/xy2d_helical_dense.py``.
With nx odd the flat-index parity equals the (x + y) parity, so the helical
checkerboard splits into two dense ragged colour arrays of width
nc = (nx + 1) // 2:

  A[y, i] = site (y, x = 2i + (y & 1))      (flat parity 0)
  B[y, i] = site (y, x = 2i + 1 - (y & 1))  (flat parity 1)

Even and odd rows alternate between nc and nc - 1 valid slots a colour.
All four neighbours of an A site live in B, and the reverse: up and down
are the same column in rows y -+ 1 (the helical +-nx is vertical, rows
wrapping at ny); left and right are columns i + p - 1 and i + p for
colour 0 and i - p and i + 1 - p for colour 1 (p = y & 1); and at the
helical x-seam, x = 0's left is the up-row's column nc - 1 and
x = nx - 1's right the down-row's column 0 (each exists on one row parity
a colour).  ``csrc/xy2d_helical_dense.cu`` holds

- ``phase_kernel``, which replaces ``_phase_kernel`` (pallas_call at
  ``:454``, ``_dense_phase``): one Metropolis colour phase, the candidate
  (cos 2πu, sin 2πu) accepted iff u' < exp(-β max(ΔE, 0)), uniforms from
  Philox or injected, and with ``measuring`` the per-replica
  (Σ S_x, Σ S_y, e) over both colours' valid slots;
- ``or_kernel``, which replaces ``_or_kernel`` (``:499``,
  ``_dense_or_phase``): one reflection phase with renormalisation, the same
  sums optional.

Layout: (R, ny, nc) float32 planes.  The JAX engine pads nc to a multiple
of 128 lanes (``dense_width``) and tiles rows by 8 (``fits`` asks
ny % 8 == 0): TPU layout.  The port's gate (:func:`fits`) is odd nx and
even ny, the shapes whose index parity is a two-colouring across the
wraps.  The ragged slot (column nc - 1 on the rows where the colour has
nc - 1 sites) is never updated nor counted; :func:`dense_pack` fills it
with its row's last site, as JAX's ``dense_pack`` does, so that a port
plane equals the first nc columns of the JAX plane bit for bit.  A phase
reads only the other colour, so it updates in place with no race.

The field is built in JAX's order, ((up + dn) + left) + right, in the
plain version as in the kernel; the per-site update is models/xy2d.py's
:func:`metropolis_update` and :func:`reflect` (the periodic engine's), with
the invalid slots kept.  Random words: Philox under the (sample, t, phase)
key, counter (replica, row, column, 0), words 0 and 1 give u_cand and
u_acc from their top 24 bits (ops/xy2d_pallas.draw_uniforms).  Sums: each
float32 value (S_x, S_y, S·h) widened to float64, summed per block and
then per replica in a fixed order (``csrc/xy2d_site.cuh``); the plain
version sums the same float32 values in float64, and the two agree to
float64 rounding.  Bitwise kernel = plain on the card for the state, as
for the periodic engine.

A wrapper takes the plain version for a CPU tensor; for a CUDA tensor it
launches the kernel or raises.  ``LAUNCHES`` counts launches.
"""

from __future__ import annotations

import ctypes

import torch

from cuda_fortran_mc_simulation_spin_tpu_torch.models.xy2d import (
    metropolis_update,
    reflect,
)
from cuda_fortran_mc_simulation_spin_tpu_torch.models.xy2d_helical import (
    XYFlatState,
)
from cuda_fortran_mc_simulation_spin_tpu_torch.ops import _build
from cuda_fortran_mc_simulation_spin_tpu_torch.ops.ising2d_multispin import (
    MASK32,
    _on_cpu,
    _stream,
    per_site,
)
from cuda_fortran_mc_simulation_spin_tpu_torch.ops.xy2d_pallas import (
    THREADS,
    _check_planes,
    _ptr,
    draw_uniforms,
)

LAUNCHES = {"phase": 0, "phase_measuring": 0, "or": 0, "or_measuring": 0}

# blocks a replica of a launch at most: the threads walk the slots in a
# grid-stride loop (csrc/xy2d_helical_dense.cuh says why 32768), so a
# measuring launch leaves at most this many partial sums a replica
MAX_BLOCKS = 32768


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def dense_nc(nx: int) -> int:
    return (nx + 1) // 2


def fits(model) -> bool:
    """The dense engines' gate on this card: odd nx and even ny (JAX's
    ``fits`` also asks ny % 8 == 0, its 8-row tiling)."""
    return model.nx % 2 == 1 and model.ny % 2 == 0 and model.ny >= 2


# ---------------------------------------------------------------------------
# layout
# ---------------------------------------------------------------------------

def _p0row(ny: int, device) -> torch.Tensor:
    """(ny, 1) mask of the even rows."""
    return ((torch.arange(ny, device=device) & 1) == 0).view(ny, 1)


def _col(nc: int, device) -> torch.Tensor:
    return torch.arange(nc, device=device).view(1, nc)


def site_x(ny: int, nx: int, color: int, device=None):
    """(x, valid), each (ny, nc): the lattice x of every slot of colour
    ``color`` (clipped to nx - 1 at the ragged slot) and whether the slot
    holds a site of that colour."""
    nc = dense_nc(nx)
    p = (torch.arange(ny, device=device) & 1).view(ny, 1)
    i = _col(nc, device)
    x = 2 * i + p if color == 0 else 2 * i + 1 - p
    return torch.clamp(x, max=nx - 1), x <= nx - 1


def valid_col(color: int, ny: int, nc: int, device=None) -> torch.Tensor:
    """(ny, nc) validity by JAX's ``_valid_col``: column i < nc on the
    colour's long rows (colour 0 even, colour 1 odd), i < nc - 1 else."""
    p0row = _p0row(ny, device)
    long_row = p0row if color == 0 else ~p0row
    lim = torch.where(long_row, nc, nc - 1)
    return _col(nc, device) < lim


def dense_pack(flat: torch.Tensor, ny: int, nx: int):
    """(..., nall) flat plane -> (a, b) dense colour planes (..., ny, nc);
    the ragged slot holds its row's last site."""
    grid = flat.reshape(flat.shape[:-1] + (ny, nx))
    yidx = torch.arange(ny, device=flat.device).view(ny, 1)
    out = []
    for color in (0, 1):
        x, _ = site_x(ny, nx, color, flat.device)
        out.append(grid[..., yidx, x].contiguous())
    return out[0], out[1]


def dense_unpack(a: torch.Tensor, b: torch.Tensor, ny: int, nx: int
                 ) -> torch.Tensor:
    """(a, b) dense planes -> flat (..., nall), the inverse of
    :func:`dense_pack` (the ragged slots are dropped)."""
    lead = a.shape[:-2]
    grid = torch.zeros(lead + (ny, nx), dtype=a.dtype, device=a.device)
    yidx = torch.arange(ny, device=a.device).view(ny, 1).expand(
        ny, dense_nc(nx))
    for color, plane in ((0, a), (1, b)):
        x, v = site_x(ny, nx, color, a.device)
        grid[..., yidx[v], x[v]] = plane[..., v]
    return grid.reshape(lead + (ny * nx,))


def _nbrs_dense(o, oup, odn, color: int, col, p0row):
    """(up, dn, left, right) other-colour neighbour planes of every slot
    of ``color``: JAX's ``_nbrs_dense`` with torch.roll on the last axis
    (o: other-colour values; oup/odn: o rolled down/up one row)."""
    nc = o.shape[-1]
    minus = torch.roll(o, 1, dims=-1)    # column i - 1
    plus = torch.roll(o, -1, dims=-1)    # column i + 1
    if color == 0:
        left = torch.where(p0row, minus, o)
        right = torch.where(p0row, o, plus)
        seam = p0row
    else:
        left = torch.where(p0row, o, minus)
        right = torch.where(p0row, plus, o)
        seam = ~p0row
    # helical x-seam: x = 0's left = up-row's last slot, x = nx-1's right =
    # down-row's first slot
    left = torch.where(seam & (col == 0), oup[..., nc - 1:nc], left)
    right = torch.where(seam & (col == nc - 1), odn[..., 0:1], right)
    return oup, odn, left, right


def field(o: torch.Tensor, color: int) -> torch.Tensor:
    """Neighbour sum of every slot of ``color`` from one component of the
    other colour's (..., ny, nc) plane, ((up + dn) + left) + right."""
    ny, nc = o.shape[-2:]
    up, dn, left, right = _nbrs_dense(
        o, torch.roll(o, 1, dims=-2), torch.roll(o, -1, dims=-2), color,
        _col(nc, o.device), _p0row(ny, o.device))
    return ((up + dn) + left) + right


def obs_plain(fx, fy, ox, oy, hx, hy, color: int) -> torch.Tensor:
    """(R, 3) float64 (Σ S_x, Σ S_y, -Σ S·h) over the valid slots of both
    colours, (fx, fy) the colour updated, its field (hx, hy); each bond
    once."""
    ny, nc = fx.shape[-2:]
    v = valid_col(color, ny, nc, fx.device)
    ov = valid_col(1 - color, ny, nc, fx.device)

    def total(t, mask):
        return torch.where(mask, t, 0.0).to(torch.float64).sum(dim=(-2, -1))
    return torch.stack([total(fx, v) + total(ox, ov),
                        total(fy, v) + total(oy, ov),
                        -total(fx * hx + fy * hy, v)], dim=-1)


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

def phase_plain(sx, sy, ox, oy, rand, *, color: int, beta: float,
                measuring: bool = False):
    """Plain version of ``phase_kernel``: one Metropolis phase of colour
    ``color`` on (R, ny, nc) float32 planes, in place; ``rand`` is a
    Philox key ((2,) uint32) or injected (u_cand, u_acc) planes.  Returns
    (sx, sy), and with ``measuring`` also the (R, 3) float64 sums."""
    if isinstance(rand, (tuple, list)):
        u_cand, u_acc = rand
    else:
        u_cand, u_acc = draw_uniforms(rand, *sx.shape, sx.device)
    hx, hy = field(ox, color), field(oy, color)
    v = valid_col(color, *sx.shape[-2:], sx.device)
    fx, fy = metropolis_update(sx, sy, hx, hy, u_cand, u_acc, beta)
    sx.copy_(torch.where(v, fx, sx))
    sy.copy_(torch.where(v, fy, sy))
    if not measuring:
        return sx, sy
    return sx, sy, obs_plain(sx, sy, ox, oy, hx, hy, color)


def or_phase_plain(sx, sy, ox, oy, *, color: int, measuring: bool = False):
    """Plain version of ``or_kernel``: one reflection phase of colour
    ``color``, in place; with ``measuring`` also the (R, 3) float64
    sums."""
    hx, hy = field(ox, color), field(oy, color)
    v = valid_col(color, *sx.shape[-2:], sx.device)
    fx, fy = reflect(sx, sy, hx, hy)
    sx.copy_(torch.where(v, fx, sx))
    sy.copy_(torch.where(v, fy, sy))
    if not measuring:
        return sx, sy
    return sx, sy, obs_plain(sx, sy, ox, oy, hx, hy, color)


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

_VOID = ctypes.c_void_p
_INT = ctypes.c_int
_UINT = ctypes.c_uint


def _lib() -> ctypes.CDLL:
    lib = _build.load("xy2d_helical_dense")
    if lib.xyh_phase.argtypes is not None:
        return lib
    lib.xyh_phase.argtypes = (
        [_VOID] * 8 + [_INT] * 5 + [ctypes.c_float, _UINT, _UINT, _VOID])
    lib.xyh_over_relax.argtypes = [_VOID] * 6 + [_INT] * 5 + [_VOID]
    for fn in (lib.xyh_phase, lib.xyh_over_relax):
        fn.restype = _INT
    lib.xyh_error_string.argtypes = [_INT]
    lib.xyh_error_string.restype = ctypes.c_char_p
    return lib


def raise_on(code: int, lib, name: str) -> None:
    """Raise for a non-zero CUDA error code of either helical library
    (both export ``xyh_error_string``)."""
    if code != 0:
        msg = lib.xyh_error_string(code).decode()
        raise RuntimeError(f"helical xy2d {name}: CUDA error {code} ({msg})")


def check_dense(*planes: torch.Tensor) -> None:
    """The kernels take float32 contiguous (R, ny, nc) planes on one CUDA
    device, ny even and nc >= 2."""
    _check_planes(*planes)
    ny, nc = planes[0].shape[-2:]
    if ny % 2 or nc < 2:
        raise ValueError(f"dense helical planes need even ny and nc >= 2, "
                         f"got {tuple(planes[0].shape)}")


def blocks(ny: int, nc: int) -> int:
    """The grid's width of a launch over (ny, nc) slots a replica: the
    kernels take it from here, and a measuring launch's partials too."""
    return min(-(-ny * nc // THREADS), MAX_BLOCKS)


def scratch(sx: torch.Tensor, measuring: bool):
    """(nblk, partials, obs) of a launch: its grid's width, and where it
    measures the per-block float64 sums (R, nblk, 3) and their totals
    (R, 3), else None for both."""
    nrep, ny, nc = sx.shape
    nblk = blocks(ny, nc)
    if not measuring:
        return nblk, None, None
    return (nblk,
            torch.empty((nrep, nblk, 3), dtype=torch.float64,
                        device=sx.device),
            torch.empty((nrep, 3), dtype=torch.float64, device=sx.device))


def seed_words(rand) -> tuple[int, int]:
    return tuple(int(v) & MASK32 for v in torch.as_tensor(rand).tolist())


def phase(sx, sy, ox, oy, rand, *, color: int, beta: float,
          measuring: bool = False):
    """One Metropolis phase of colour ``color`` on (R, ny, nc) float32
    planes, in place: ``phase_kernel`` on CUDA tensors,
    :func:`phase_plain` on CPU tensors.  ``rand`` is the phase's Philox
    key or injected (u_cand, u_acc) planes.  Returns (sx, sy), and with
    ``measuring`` also the (R, 3) float64 sums (Σ S_x, Σ S_y, e)."""
    if _on_cpu(sx):
        return phase_plain(sx, sy, ox, oy, rand, color=color, beta=beta,
                           measuring=measuring)
    if isinstance(rand, (tuple, list)):
        u_cand, u_acc = rand
        check_dense(sx, sy, ox, oy, u_cand, u_acc)
        s0 = s1 = 0
    else:
        check_dense(sx, sy, ox, oy)
        u_cand = u_acc = None
        s0, s1 = seed_words(rand)
    nrep, ny, nc = sx.shape
    nblk, partials, obs = scratch(sx, measuring)
    lib = _lib()
    with torch.cuda.device(sx.device):
        code = lib.xyh_phase(
            sx.data_ptr(), sy.data_ptr(), ox.data_ptr(), oy.data_ptr(),
            _ptr(u_cand), _ptr(u_acc), _ptr(partials), _ptr(obs), nrep, ny,
            nc, nblk, color, -float(beta), s0, s1, _stream(sx))
    raise_on(code, lib, "phase_kernel")
    LAUNCHES["phase"] += 1
    if measuring:
        LAUNCHES["phase_measuring"] += 1
        return sx, sy, obs
    return sx, sy


def or_phase(sx, sy, ox, oy, *, color: int, measuring: bool = False):
    """One over-relaxation phase of colour ``color``, in place:
    ``or_kernel`` on CUDA tensors, :func:`or_phase_plain` on CPU
    tensors."""
    if _on_cpu(sx):
        return or_phase_plain(sx, sy, ox, oy, color=color,
                              measuring=measuring)
    check_dense(sx, sy, ox, oy)
    nrep, ny, nc = sx.shape
    nblk, partials, obs = scratch(sx, measuring)
    lib = _lib()
    with torch.cuda.device(sx.device):
        code = lib.xyh_over_relax(
            sx.data_ptr(), sy.data_ptr(), ox.data_ptr(), oy.data_ptr(),
            _ptr(partials), _ptr(obs), nrep, ny, nc, nblk, color,
            _stream(sx))
    raise_on(code, lib, "or_kernel")
    LAUNCHES["or"] += 1
    if measuring:
        LAUNCHES["or_measuring"] += 1
        return sx, sy, obs
    return sx, sy


# ---------------------------------------------------------------------------
# sweeps (the JAX module's surface; seeds: the sweep's (2, 2) phase keys)
# ---------------------------------------------------------------------------

def pack_state(state, ny: int, nx: int):
    """((R, nall), (R, nall)) flat XY state -> (ax, ay, bx, by) dense
    colour planes (R, ny, nc)."""
    fx, fy = state
    ax, bx = dense_pack(fx, ny, nx)
    ay, by = dense_pack(fy, ny, nx)
    return ax, ay, bx, by


def unpack_state(planes, ny: int, nx: int) -> XYFlatState:
    ax, ay, bx, by = planes
    return XYFlatState(dense_unpack(ax, bx, ny, nx),
                       dense_unpack(ay, by, ny, nx))


def densities(model, obs) -> dict[str, torch.Tensor]:
    """(R, 3) float64 sums -> the {m, my, e} densities (R,)."""
    return {k: per_site(obs[:, j], model.nsites)
            for j, k in enumerate(("m", "my", "e"))}


def sweep(model, planes, seeds):
    """One Metropolis MCS, in place, given the sweep's (2, 2) phase
    keys."""
    ax, ay, bx, by = planes
    phase(ax, ay, bx, by, seeds[0], color=0, beta=model.beta)
    phase(bx, by, ax, ay, seeds[1], color=1, beta=model.beta)
    return planes


def sweep_measure(model, planes, seeds):
    """:func:`sweep` with the (m, my, e) densities fused into phase b."""
    ax, ay, bx, by = planes
    phase(ax, ay, bx, by, seeds[0], color=0, beta=model.beta)
    _, _, obs = phase(bx, by, ax, ay, seeds[1], color=1, beta=model.beta,
                      measuring=True)
    return planes, densities(model, obs)


def over_relax_sweep(model, planes):
    ax, ay, bx, by = planes
    or_phase(ax, ay, bx, by, color=0)
    or_phase(bx, by, ax, ay, color=1)
    return planes


def over_relax_sweep_measure(model, planes):
    """One OR sweep with the densities fused into the second colour
    phase."""
    ax, ay, bx, by = planes
    or_phase(ax, ay, bx, by, color=0)
    _, _, obs = or_phase(bx, by, ax, ay, color=1, measuring=True)
    return planes, densities(model, obs)


def observables(model, planes) -> dict[str, torch.Tensor]:
    """{m, my, e} densities (R,) of the dense planes, plain PyTorch (the
    OR schedule's sweeps after mcs_over_relax, as JAX's XLA pass)."""
    ax, ay, bx, by = planes
    hx, hy = field(ax, 1), field(ay, 1)
    return densities(model, obs_plain(bx, by, ax, ay, hx, hy, 1))
