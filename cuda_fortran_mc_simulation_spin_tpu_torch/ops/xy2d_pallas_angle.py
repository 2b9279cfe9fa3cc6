"""The periodic XY engine on float32 angle planes: two CUDA kernels and
their plain versions.

Port of ``cuda_fortran_mc_simulation_spin_tpu/ops/xy2d_pallas_angle.py``
(the module keeps its name so that its JAX counterpart is found by name;
it launches CUDA kernels, not Pallas ones).  One float32 angle in turns
(θ/2π in [-0.5, 0.5)) a site instead of the two components of
ops/xy2d_pallas.py: the same Markov chain (uniform candidate angle, the
same acceptance compare), |S| = 1 by construction, and over-relaxation
as angle arithmetic θ' = 2φ − θ with φ = atan2_2pi(h_y, h_x), wrapped by
tp − rint(tp) (round half to even, as ``jnp.round``).
``csrc/xy2d_pallas_angle.cu`` holds

- ``angle_metro_kernel``, which replaces ``_angle_metro_kernel``
  (pallas_call at ``:267``, ``_angle_metro_phase``): one Metropolis
  colour phase on a decode-once tile a block (the helical angle phase's
  design and grid, ``xy2d_helical_dense_angle.tile_grid``),
  uniforms from Philox or injected, with ``measuring`` the
  per-replica (Σ S_x, Σ S_y, e) over both colours; its snapshot mode
  replaces ``_angle_metro_snap_kernel`` (``:405``,
  ``_angle_metro_snap_phase``): the same phase with
  A = Σ cos 2π(θ − θ0) of both colours against the t=0 angle snapshots;
- ``angle_or_kernel``, which replaces ``_angle_or_kernel`` (``:300``,
  ``_angle_or_phase``): one reflection phase on the same tiles and grid,
  the same sums optional.

Layout: (R, ny, nx/2) float32 angle planes for every even nx, with the
checkerboard of core/lattice.py and the neighbours of ops/xy2d_pallas.py
(unpadded: the JAX engine's 128-lane pad, its ``valid_half`` masks and
tile picking are TPU layout).  A phase updates its colour in place.

Random words, the field's order and the sums are those of
ops/xy2d_pallas.py: Philox under the (sample, t, phase) key and counter
(replica, row, column, 0), word 0 u_cand and word 1 u_acc; the decoded
field (up + dn) + (centre + side); float64 sums of the float32 site
terms, per block then per replica in a fixed order on the card, so the
kernel equals its plain version bitwise in the state and to float64
rounding in the sums (JAX sums in float32).  The kernels spell every
float32 operation with ``__fmul_rn`` / ``__fadd_rn`` / ``__fsub_rn`` in
the order of the plain versions, and the divide of atan2_2pi is
``__fdiv_rn``, as torch's float32 division rounds.

A wrapper takes the plain version for a CPU tensor; for a CUDA tensor it
launches the kernel or raises.  ``LAUNCHES`` counts launches.  The sweep
entries are JAX's: :func:`sweep_angle`, :func:`sweep_measure_angle`,
:func:`or_sweep_angle`, :func:`or_sweep_measure_angle` and
:func:`sweep_measure_snap_angle`, each on an (a, b) pair of angle planes
and the sweep's (2, 2) phase keys.
"""

from __future__ import annotations

import ctypes

import torch

from cuda_fortran_mc_simulation_spin_tpu_torch.models.xy2d import XYState
from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
    _build,
    trig,
    xy2d_helical_dense_angle,
)
from cuda_fortran_mc_simulation_spin_tpu_torch.ops.ising2d_multispin import (
    MASK32,
    _on_cpu,
    _stream,
    per_site,
)
from cuda_fortran_mc_simulation_spin_tpu_torch.ops.xy2d_pallas import (
    _check_planes,
    _obs_plain,
    _ptr,
    densities,
    draw_uniforms,
    nbr_sum,
)

LAUNCHES = {"metro": 0, "metro_measuring": 0, "metro_snapshot": 0,
            "or": 0, "or_measuring": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def pack_angles(state: XYState) -> tuple[torch.Tensor, torch.Tensor]:
    """XYState component planes -> (a, b) angle planes in turns,
    atan2_2pi of each site (JAX ``pack_angles`` without the lane pad)."""
    return (trig.atan2_2pi(state.ay, state.ax),
            trig.atan2_2pi(state.by, state.bx))


def unpack_angles(planes) -> XYState:
    """(a, b) angle planes -> XYState component planes (cos_sin_2pi)."""
    a, b = planes
    return XYState(*trig.cos_sin_2pi(a), *trig.cos_sin_2pi(b))


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

def field_angles(o: torch.Tensor, color: int):
    """JAX's ``_field_angles``: ((ox, oy), (hx, hy)), the other colour's
    decoded plane and the field at every site of ``color``."""
    ox, oy = trig.cos_sin_2pi(o)
    return (ox, oy), (nbr_sum(ox, color), nbr_sum(oy, color))


def _snap_sum(fin, o, snap) -> torch.Tensor:
    """(R,) float64 A = Σ cos 2π(θ − θ0) of both colours: the updated
    colour's final angles and the other's against the snapshots ``snap``
    ((of the colour updated, of the other))."""
    sns, sno = snap
    ca = trig.cos_sin_2pi(fin - sns)[0].to(torch.float64)
    cb = trig.cos_sin_2pi(o - sno)[0].to(torch.float64)
    return ca.sum(dim=(-2, -1)) + cb.sum(dim=(-2, -1))


def metro_phase_plain(s, o, rand, *, color: int, beta: float,
                      measuring: bool = False, snap=None):
    """Plain version of ``angle_metro_kernel``: one Metropolis phase of
    colour ``color`` on (R, ny, half) angle planes, ``s`` updated in
    place; ``rand`` is a Philox key ((2,) uint32) or injected
    (u_cand, u_acc) planes.  Returns s; with ``measuring`` (s, (R, 3)
    float64 sums); with ``snap``, the t=0 angle snapshots (of the colour
    updated, of the other), (s, (R, 4) sums with A)."""
    if isinstance(rand, (tuple, list)):
        u_cand, u_acc = rand
    else:
        u_cand, u_acc = draw_uniforms(rand, *s.shape, s.device)
    (ox, oy), (hx, hy) = field_angles(o, color)
    fin, fx, fy = xy2d_helical_dense_angle.metro_math(
        s, hx, hy, u_cand, u_acc, beta)
    s.copy_(fin)
    if not (measuring or snap is not None):
        return s
    obs = _obs_plain(fx, fy, ox, oy, hx, hy)
    if snap is not None:
        obs = torch.cat([obs, _snap_sum(fin, o, snap)[:, None]], dim=1)
    return s, obs


def or_phase_plain(s, o, *, color: int, measuring: bool = False):
    """Plain version of ``angle_or_kernel``: one reflection phase of
    colour ``color``, ``s`` in place; with ``measuring`` also the (R, 3)
    float64 sums of the decoded new state."""
    (ox, oy), (hx, hy) = field_angles(o, color)
    s.copy_(xy2d_helical_dense_angle.or_math(s, hx, hy))
    if not measuring:
        return s
    fx, fy = trig.cos_sin_2pi(s)
    return s, _obs_plain(fx, fy, ox, oy, hx, hy)


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

_VOID = ctypes.c_void_p
_INT = ctypes.c_int
_UINT = ctypes.c_uint


def metro_blocks(ny: int, half: int) -> int:
    """Blocks a replica of an ``angle_metro_kernel`` or ``angle_or_kernel``
    launch over (ny, half) sites, so the partial sums a measuring launch
    leaves a replica: the helical angle phase's tiles and cap
    (ops/xy2d_helical_dense_angle.tile_grid; ``TILE`` columns of a
    colour's half-plane x ``TILE`` rows, at most ``MAX_TILE_BLOCKS``
    blocks a replica), over (ny, half)."""
    gx, gy = xy2d_helical_dense_angle.tile_grid(ny, half)
    return gx * gy


def _lib() -> ctypes.CDLL:
    lib = _build.load("xy2d_pallas_angle")
    if lib.xya_metro.argtypes is not None:
        return lib
    lib.xya_metro.argtypes = (
        [_VOID] * 8 + [_INT] * 5 + [ctypes.c_float, _UINT, _UINT, _VOID])
    lib.xya_or.argtypes = [_VOID] * 4 + [_INT] * 5 + [_VOID]
    for fn in (lib.xya_metro, lib.xya_or):
        fn.restype = _INT
    lib.xya_error_string.argtypes = [_INT]
    lib.xya_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(code: int, lib, name: str) -> None:
    if code != 0:
        msg = lib.xya_error_string(code).decode()
        raise RuntimeError(f"xy2d angle {name}: CUDA error {code} ({msg})")


def metro_phase(s, o, rand, *, color: int, beta: float,
                measuring: bool = False, snap=None):
    """One Metropolis phase of colour ``color`` on (R, ny, half) float32
    angle planes, ``s`` in place: ``angle_metro_kernel`` on CUDA tensors,
    :func:`metro_phase_plain` on CPU tensors (same arguments and
    results).  The kernel refuses a shape whose plane index could reach
    2^31 or more than 65535 replicas."""
    if _on_cpu(s):
        return metro_phase_plain(s, o, rand, color=color, beta=beta,
                                 measuring=measuring, snap=snap)
    planes = [s, o] + ([] if snap is None else list(snap))
    if isinstance(rand, (tuple, list)):
        u_cand, u_acc = rand
        _check_planes(*planes, u_cand, u_acc)
        s0 = s1 = 0
    else:
        _check_planes(*planes)
        u_cand = u_acc = None
        s0, s1 = (int(v) & MASK32 for v in torch.as_tensor(rand).tolist())
    nrep, ny, half = s.shape
    gy = xy2d_helical_dense_angle.tile_grid(ny, half)[1]
    partials, obs = xy2d_helical_dense_angle.tile_scratch(
        s, measuring or snap is not None, 3 if snap is None else 4)
    sns, sno = (None, None) if snap is None else snap
    lib = _lib()
    with torch.cuda.device(s.device):
        code = lib.xya_metro(
            s.data_ptr(), o.data_ptr(), _ptr(u_cand), _ptr(u_acc), _ptr(sns),
            _ptr(sno), _ptr(partials), _ptr(obs), nrep, ny, half, gy, color,
            -float(beta), s0, s1, _stream(s))
    _raise_on(code, lib, "angle_metro_kernel")
    LAUNCHES["metro"] += 1
    if snap is not None:
        LAUNCHES["metro_snapshot"] += 1
        return s, obs
    if measuring:
        LAUNCHES["metro_measuring"] += 1
        return s, obs
    return s


def or_phase(s, o, *, color: int, measuring: bool = False):
    """One over-relaxation phase of colour ``color`` on angle planes, ``s``
    in place: ``angle_or_kernel`` on CUDA tensors, :func:`or_phase_plain`
    on CPU tensors."""
    if _on_cpu(s):
        return or_phase_plain(s, o, color=color, measuring=measuring)
    _check_planes(s, o)
    nrep, ny, half = s.shape
    gy = xy2d_helical_dense_angle.tile_grid(ny, half)[1]
    partials, obs = xy2d_helical_dense_angle.tile_scratch(s, measuring)
    lib = _lib()
    with torch.cuda.device(s.device):
        code = lib.xya_or(s.data_ptr(), o.data_ptr(), _ptr(partials),
                          _ptr(obs), nrep, ny, half, gy, color, _stream(s))
    _raise_on(code, lib, "angle_or_kernel")
    LAUNCHES["or"] += 1
    if measuring:
        LAUNCHES["or_measuring"] += 1
        return s, obs
    return s


# ---------------------------------------------------------------------------
# sweeps (JAX's wrappers, on (a, b) angle planes and (2, 2) phase keys)
# ---------------------------------------------------------------------------

def _planar(model, obs) -> dict[str, torch.Tensor]:
    return {k: per_site(obs[:, j], model.nsites)
            for j, k in enumerate(("m", "my", "e"))}


def sweep_angle(model, planes, seeds):
    """One Metropolis MCS of the (a, b) angle planes, in place."""
    a, b = planes
    metro_phase(a, b, seeds[0], color=0, beta=model.beta)
    metro_phase(b, a, seeds[1], color=1, beta=model.beta)
    return planes


def sweep_measure_angle(model, planes, seeds):
    """:func:`sweep_angle` with the (m, my, e) densities (R,) float64
    fused into phase b."""
    a, b = planes
    metro_phase(a, b, seeds[0], color=0, beta=model.beta)
    _, obs = metro_phase(b, a, seeds[1], color=1, beta=model.beta,
                         measuring=True)
    return planes, _planar(model, obs)


def or_sweep_angle(model, planes):
    """One over-relaxation sweep (both colours), in place."""
    a, b = planes
    or_phase(a, b, color=0)
    or_phase(b, a, color=1)
    return planes


def or_sweep_measure_angle(model, planes):
    """:func:`or_sweep_angle` with the densities fused into the colour-1
    phase: the OR schedule's measuring sweep."""
    a, b = planes
    or_phase(a, b, color=0)
    _, obs = or_phase(b, a, color=1, measuring=True)
    return planes, _planar(model, obs)


def sweep_measure_snap_angle(model, planes, snaps, seeds):
    """One Metropolis MCS with the fused {mx, my, e, A} densities (R,)
    float64 against the t=0 angle snapshots ``snaps`` = (sa, sb): the
    disorder protocols' sweep on angle planes."""
    a, b = planes
    sa, sb = snaps
    metro_phase(a, b, seeds[0], color=0, beta=model.beta)
    _, obs = metro_phase(b, a, seeds[1], color=1, beta=model.beta,
                         snap=(sb, sa))
    return planes, densities(model, obs)
