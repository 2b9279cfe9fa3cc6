"""The dense dual-colour engine of helical XY on float32 angle planes: two
CUDA kernels and their plain versions.

Port of ``cuda_fortran_mc_simulation_spin_tpu/ops/xy2d_helical_dense_angle.py``,
the JAX package's default helical XY engine.  One float32 angle in turns
(θ/2π in [-0.5, 0.5]) a site instead of two components: half the bytes of
ops/xy2d_helical_dense.py, in the same ragged (R, ny, nc) layout with the
same neighbour algebra (imported from there).  The kernels decode
(cos, sin) with ops/trig.cos_sin_2pi, and the over-relaxation reflection
is θ' = 2φ − θ with φ = atan2_2pi(h_y, h_x), wrapped by tp − rint(tp)
(round half to even, as ``jnp.round``).  It is the same Markov chain as
the component engine: the candidate is stored as cand = u − 0.5 and
decoded, so a Metropolis phase equals the component one fed u − 0.5,
bitwise in the decoded state.  ``csrc/xy2d_helical_dense_angle.cu`` holds

- ``angle_tile_kernel<false, .>``, which replaces ``_angle_phase_kernel``
  (pallas_call at ``:269``, ``_angle_phase``): one Metropolis colour
  phase, uniforms from Philox or injected, with ``measuring`` the
  per-replica (Σ S_x, Σ S_y, e); a block decodes the other colour's tile
  and its one-slot halo once into shared memory (:func:`tile_grid` sizes
  its grid);
- ``angle_tile_kernel<true, .>``, its over-relaxation mode, which
  replaces ``_angle_or_kernel`` (``:308``, ``_angle_or_phase``): one
  reflection phase on the same tiles and grid, the same sums optional;
- ``atan2_kernel``, the device ``atan2_2pi`` over a vector: no path runs
  it; ``chip_smoke.py`` holds the device function against
  ops/trig.atan2_2pi with it.

Random words, sums and the bitwise contract as in
ops/xy2d_helical_dense.py; the divide of atan2_2pi is ``__fdiv_rn`` on
the card, as torch's float32 division rounds.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from cuda_fortran_mc_simulation_spin_tpu_torch.models.xy2d_helical import (
    XYFlatState,
)
from cuda_fortran_mc_simulation_spin_tpu_torch.ops import _build, trig
from cuda_fortran_mc_simulation_spin_tpu_torch.ops.ising2d_multispin import (
    _on_cpu,
    _stream,
)
from cuda_fortran_mc_simulation_spin_tpu_torch.ops.xy2d_helical_dense import (
    check_dense,
    densities,
    dense_pack,
    dense_unpack,
    field,
    fits,  # noqa: F401  (the same gate as the component engine)
    obs_plain,
    raise_on,
    seed_words,
    valid_col,
)
from cuda_fortran_mc_simulation_spin_tpu_torch.ops.xy2d_pallas import (
    _ptr,
    draw_uniforms,
)

LAUNCHES = {"phase": 0, "phase_measuring": 0, "or": 0, "or_measuring": 0,
            "atan2": 0}

# the Metropolis kernel's tile: TILE slots x TILE rows (TX, TY in its
# source)
TILE = 32
# blocks a replica at most: past it a block walks several tile rows, so a
# measuring launch leaves at most this many partial sums a replica.  At
# 10001x10000 it gives 104 row blocks, each walking three tile rows; the
# uncapped grid's 313 read 4% slower a plain phase and 11% measuring on
# the card (PERF.md §6)
MAX_TILE_BLOCKS = 16384

_TWO_PI = 2.0 * np.pi


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

def angle_field(o: torch.Tensor, color: int):
    """(hx, hy) of every slot of ``color`` from the other colour's angle
    plane: decoded, then summed as ops/xy2d_helical_dense.field sums."""
    ox, oy = trig.cos_sin_2pi(o)
    return field(ox, color), field(oy, color)


def metro_math(s, hx, hy, u_cand, u_acc, beta: float, valid=None):
    """JAX's ``_metro_math``: the new angle and its decoded components;
    the candidate angle is u_cand - 0.5 turns.  Sites where ``valid`` is
    False keep their angle (None: every site is real)."""
    sx, sy = trig.cos_sin_2pi(s)
    cand = u_cand - trig.f32(0.5)
    cx, cy = trig.cos_sin_2pi(cand)
    de = -((cx - sx) * hx + (cy - sy) * hy)
    p = torch.exp(torch.maximum(de, trig.f32(0.0)) * trig.f32(-beta))
    accept = u_acc < p
    if valid is not None:
        accept = valid & accept
    return (torch.where(accept, cand, s), torch.where(accept, cx, sx),
            torch.where(accept, cy, sy))


def or_math(s, hx, hy, valid=None):
    """JAX's ``_or_math``: θ' = 2φ − θ, φ = atan2_2pi(hy, hx), wrapped to
    [-0.5, 0.5] turns; a zero field gives θ' = −θ."""
    phi = trig.atan2_2pi(hy, hx)
    tp = trig.f32(2.0) * phi - s
    tp = tp - torch.round(tp)
    return tp if valid is None else torch.where(valid, tp, s)


def angle_phase_plain(s, o, rand, *, color: int, beta: float,
                      measuring: bool = False):
    """Plain version of ``angle_tile_kernel``: one Metropolis phase of
    colour ``color`` on (R, ny, nc) angle planes, ``s`` updated in place;
    ``rand`` a Philox key or injected (u_cand, u_acc) planes.  Returns s,
    and with ``measuring`` (s, (R, 3) float64 sums)."""
    if isinstance(rand, (tuple, list)):
        u_cand, u_acc = rand
    else:
        u_cand, u_acc = draw_uniforms(rand, *s.shape, s.device)
    hx, hy = angle_field(o, color)
    v = valid_col(color, *s.shape[-2:], s.device)
    fin, fx, fy = metro_math(s, hx, hy, u_cand, u_acc, beta, v)
    s.copy_(fin)
    if not measuring:
        return s
    ox, oy = trig.cos_sin_2pi(o)
    return s, obs_plain(fx, fy, ox, oy, hx, hy, color)


def angle_or_phase_plain(s, o, *, color: int, measuring: bool = False):
    """Plain version of ``angle_tile_kernel<true, .>``: one reflection
    phase of
    colour ``color``, ``s`` in place; with ``measuring`` also the sums of
    the decoded new state."""
    hx, hy = angle_field(o, color)
    v = valid_col(color, *s.shape[-2:], s.device)
    s.copy_(or_math(s, hx, hy, v))
    if not measuring:
        return s
    fx, fy = trig.cos_sin_2pi(s)
    ox, oy = trig.cos_sin_2pi(o)
    return s, obs_plain(fx, fy, ox, oy, hx, hy, color)


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

_VOID = ctypes.c_void_p
_INT = ctypes.c_int
_UINT = ctypes.c_uint


def _lib() -> ctypes.CDLL:
    lib = _build.load("xy2d_helical_dense_angle")
    if lib.xya_phase.argtypes is not None:
        return lib
    lib.xya_phase.argtypes = (
        [_VOID] * 6 + [_INT] * 5 + [ctypes.c_float, _UINT, _UINT, _VOID])
    lib.xya_over_relax.argtypes = [_VOID] * 4 + [_INT] * 5 + [_VOID]
    lib.xya_atan2.argtypes = [_VOID] * 3 + [ctypes.c_longlong, _VOID]
    for fn in (lib.xya_phase, lib.xya_over_relax, lib.xya_atan2):
        fn.restype = _INT
    lib.xyh_error_string.argtypes = [_INT]
    lib.xyh_error_string.restype = ctypes.c_char_p
    return lib


def tile_grid(ny: int, nc: int) -> tuple[int, int]:
    """(column tiles, row blocks) of a launch (Metropolis or OR) over (ny, nc)
    slots a replica in :data:`TILE` x :data:`TILE` tiles: block (bx, by)
    takes column tile bx and tile rows by, by + row blocks, ...; at most
    :data:`MAX_TILE_BLOCKS` blocks a replica, and the row blocks within a
    CUDA grid's 65535."""
    gx = -(-nc // TILE)
    rows = -(-ny // TILE)
    return gx, min(rows, max(1, MAX_TILE_BLOCKS // gx), 65535)


def tile_scratch(s: torch.Tensor, measuring: bool, nsums: int = 3):
    """(partials, obs) of a tile launch: where it measures, the per-block
    float64 sums (R, blocks of :func:`tile_grid`, nsums) and their totals
    (R, nsums); else (None, None).  The periodic angle kernels' tiles too
    (ops/xy2d_pallas_angle.py; nsums 4 in the snapshot mode)."""
    if not measuring:
        return None, None
    nrep, ny, nc = s.shape
    gx, gy = tile_grid(ny, nc)
    return (torch.empty((nrep, gx * gy, nsums), dtype=torch.float64,
                        device=s.device),
            torch.empty((nrep, nsums), dtype=torch.float64,
                        device=s.device))


def angle_phase(s, o, rand, *, color: int, beta: float,
                measuring: bool = False):
    """One Metropolis phase of colour ``color`` on (R, ny, nc) float32
    angle planes, ``s`` in place: ``angle_tile_kernel`` on CUDA tensors,
    :func:`angle_phase_plain` on CPU tensors.  Returns s, and with
    ``measuring`` (s, (R, 3) float64 sums)."""
    if _on_cpu(s):
        return angle_phase_plain(s, o, rand, color=color, beta=beta,
                                 measuring=measuring)
    if isinstance(rand, (tuple, list)):
        u_cand, u_acc = rand
        check_dense(s, o, u_cand, u_acc)
        s0 = s1 = 0
    else:
        check_dense(s, o)
        u_cand = u_acc = None
        s0, s1 = seed_words(rand)
    nrep, ny, nc = s.shape
    _, gy = tile_grid(ny, nc)
    partials, obs = tile_scratch(s, measuring)
    lib = _lib()
    with torch.cuda.device(s.device):
        code = lib.xya_phase(
            s.data_ptr(), o.data_ptr(), _ptr(u_cand), _ptr(u_acc),
            _ptr(partials), _ptr(obs), nrep, ny, nc, gy, color,
            -float(beta), s0, s1, _stream(s))
    raise_on(code, lib, "angle_tile_kernel")
    LAUNCHES["phase"] += 1
    if measuring:
        LAUNCHES["phase_measuring"] += 1
        return s, obs
    return s


def angle_or_phase(s, o, *, color: int, measuring: bool = False):
    """One over-relaxation phase of colour ``color`` on angle planes, ``s``
    in place: ``angle_tile_kernel``'s over-relaxation mode on CUDA tensors
    (the tiles and grid of :func:`angle_phase`),
    :func:`angle_or_phase_plain` on CPU tensors."""
    if _on_cpu(s):
        return angle_or_phase_plain(s, o, color=color, measuring=measuring)
    check_dense(s, o)
    nrep, ny, nc = s.shape
    _, gy = tile_grid(ny, nc)
    partials, obs = tile_scratch(s, measuring)
    lib = _lib()
    with torch.cuda.device(s.device):
        code = lib.xya_over_relax(
            s.data_ptr(), o.data_ptr(), _ptr(partials), _ptr(obs), nrep, ny,
            nc, gy, color, _stream(s))
    raise_on(code, lib, "angle_tile_kernel (over-relaxation)")
    LAUNCHES["or"] += 1
    if measuring:
        LAUNCHES["or_measuring"] += 1
        return s, obs
    return s


def atan2_2pi(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """atan2(y, x) in turns, float32: the kernels' device function over
    contiguous CUDA vectors (``atan2_kernel``), ops/trig.atan2_2pi on CPU
    tensors."""
    if _on_cpu(y):
        return trig.atan2_2pi(y, x)
    if (y.shape != x.shape or y.dtype != torch.float32
            or x.dtype != torch.float32 or not y.is_contiguous()
            or not x.is_contiguous() or x.device != y.device):
        raise ValueError("atan2_2pi takes two contiguous float32 tensors "
                         "of one shape on one CUDA device")
    out = torch.empty_like(y)
    lib = _lib()
    with torch.cuda.device(y.device):
        code = lib.xya_atan2(y.data_ptr(), x.data_ptr(), out.data_ptr(),
                             y.numel(), _stream(y))
    raise_on(code, lib, "atan2_kernel")
    LAUNCHES["atan2"] += 1
    return out


# ---------------------------------------------------------------------------
# sweeps — the surface of ops/xy2d_helical_dense, on (a, b) angle planes
# ---------------------------------------------------------------------------

def pack_state(state, ny: int, nx: int):
    """((R, nall), (R, nall)) flat XY component state -> (a, b) dense
    angle planes (R, ny, nc) in turns."""
    fx, fy = state
    turns = torch.atan2(fy, fx) * trig.f32(1.0 / _TWO_PI)
    return dense_pack(turns, ny, nx)


def unpack_state(planes, ny: int, nx: int) -> XYFlatState:
    a, b = planes
    return XYFlatState(*trig.cos_sin_2pi(dense_unpack(a, b, ny, nx)))


def sweep(model, planes, seeds):
    a, b = planes
    angle_phase(a, b, seeds[0], color=0, beta=model.beta)
    angle_phase(b, a, seeds[1], color=1, beta=model.beta)
    return planes


def sweep_measure(model, planes, seeds):
    a, b = planes
    angle_phase(a, b, seeds[0], color=0, beta=model.beta)
    _, obs = angle_phase(b, a, seeds[1], color=1, beta=model.beta,
                         measuring=True)
    return planes, densities(model, obs)


def over_relax_sweep(model, planes):
    a, b = planes
    angle_or_phase(a, b, color=0)
    angle_or_phase(b, a, color=1)
    return planes


def over_relax_sweep_measure(model, planes):
    a, b = planes
    angle_or_phase(a, b, color=0)
    _, obs = angle_or_phase(b, a, color=1, measuring=True)
    return planes, densities(model, obs)


def observables(model, planes) -> dict[str, torch.Tensor]:
    """{m, my, e} densities (R,) of the angle planes, plain PyTorch."""
    a, b = planes
    hx, hy = angle_field(a, 1)
    bx, by = trig.cos_sin_2pi(b)
    ax, ay = trig.cos_sin_2pi(a)
    return densities(model, obs_plain(bx, by, ax, ay, hx, hy, 1))
