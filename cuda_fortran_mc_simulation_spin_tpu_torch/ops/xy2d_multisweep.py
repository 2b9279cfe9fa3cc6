"""S sweeps of the periodic XY model on int16 angle planes in one launch
on the card: a cooperative CUDA kernel and its plain version.

Port of ``cuda_fortran_mc_simulation_spin_tpu/ops/xy2d_multisweep.py``
(the module keeps its name so that its JAX counterpart is found by name;
it launches a CUDA kernel, not a Pallas one).  Spins are 16-bit
fixed-point angles θ = k·2π/2^16, one int16 (R, ny, nx/2) plane a colour:
a q = 65536 clock model whose |S| = 1 holds exactly and whose global
rotations are int16 adds.  ``csrc/xy2d_multisweep.cu``
``smem_multisweep_kernel`` and ``gmem_multisweep_kernel``, two modes of
one function, replace ``_kernel`` (pallas_call at ``:325``,
``_multisweep``): S sweeps a launch, each a Metropolis phase a and b
(the candidate the top 16 bits of a random word), with ``n_or`` > 0
then n_or over-relaxation sweeps (θ' = 2 round(φ) − θ, φ the
octant-reduced A&S atan2 polynomial in 2^16 units) and a measure pass,
and each sweep's (Σ S_x, Σ S_y, e, A) against the t=0 snapshot planes;
``or_only`` runs max(n_or, 1) over-relaxation sweeps and the measure pass
only (JAX's microcanonical test mode).

The TPU kernel keeps the planes in VMEM for the S sweeps.  Here, as in
ops/xy2d_resident.py, two modes, each replica a ring of blocks with ring
flags between phases (``csrc/xy2d_ring.cuh``), chosen by the fit rule
:func:`smem_layout`:

- ``smem_multisweep_kernel``, where the batch fits the grid's shared
  memory (one 1536x1536 replica on the H100, its snapshot too): the int16
  planes held in the SMs' shared memory for the S sweeps, each
  other-colour angle decoded once a phase into a shared float32 (cos,
  sin) plane;
- ``gmem_multisweep_kernel``, past the fit (:func:`gmem_layout`; e.g.
  1536x1536 x 2 and x 3 on rings of 66 and 44 blocks): the planes in
  device memory (and, at the route's sizes, in L2), updated in place, a
  block holding the chunks no neighbour reads in shared memory as int16
  and, where room is left, decoding the other colour there once a phase;
  where one ring a replica does not fit (1536x1536 x 23 and more, 64x64
  x 1600) the rings take whole replicas in turn.
  ``multisweep_planes(..., grid=True)`` forces it.

Both fold the measure pass after the over-relaxation sweeps into the
last over-relaxation phase b (colour a does not change in it).

JAX runs it only when asked (``SPINLAT_XY_ANGLE_MS=1``), and so does the
port (engine/sweep.py); :func:`fits` is JAX's ``fits_vmem``, the route's
bound on a replica, and admits batches of any number of replicas.

Random words: Philox under the (sweep, phase) key of
``multispin_rng.sweep_phase_keys`` and counter (replica, row, column, 0)
(where JAX keys its hardware PRNG by the launch); the candidate is word
0 >> 16, an int32 in [0, 65535] that is wrapped to int16 only when
stored: phase b's fused sums and A use the unwrapped value, as JAX's
do.  The uniform is the top 24 bits of word 1.

Sums: every site term is JAX's float32 term (the decoded components, the
bond products S·h, cos 2π(θ0 − θ)/2^16 units), widened and summed in
float64, per 256-site chunk and then per (replica, sweep) in a fixed
order on the card, the same in both modes (JAX sums in float32).  The
kernels spell each float32 operation with ``__fmul_rn`` / ``__fadd_rn``
/ ``__fsub_rn`` in the order of the plain versions, the divide of the
atan2 polynomial with ``__fdiv_rn``, and round with ``rintf`` (half to
even, as ``torch.round``), so each mode equals :func:`multisweep_plain`
bitwise in the state and to float64 rounding in the sums.

A wrapper takes the plain version for a CPU tensor; for a CUDA tensor it
launches the kernel or raises.  ``LAUNCHES`` counts launches, the
device-memory mode under ``"multisweep"``.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from cuda_fortran_mc_simulation_spin_tpu_torch.core import rng
from cuda_fortran_mc_simulation_spin_tpu_torch.models.xy2d import XYState
from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
    _build,
    multispin_rng,
    trig,
    xy2d_pallas,
    xy2d_resident,
)
from cuda_fortran_mc_simulation_spin_tpu_torch.ops.ising2d_multispin import (
    _on_cpu,
    _stream,
)

LAUNCHES = {"multisweep": 0, "multisweep_smem": 0}

_TWO_PI = float(2.0 * np.pi)
_TO_RAD = np.float32(_TWO_PI / 65536.0)
_INV_TURN = np.float32(1.0 / 65536.0)   # int16 angle units -> turns
_UNITS = 65536.0 / _TWO_PI               # radians -> int16 angle units
# the A&S 4.4.49 polynomial of atan on [0, 1] (JAX ``_atan2_units``)
_ATAN = (0.99997726, -0.33262347, 0.19354346, -0.11643287, 0.05265332,
         -0.01172120)

# JAX's VMEM budget of the state and snapshot planes (``fits_vmem``)
VMEM_ANGLE_BUDGET = 9 << 20
# threads of a block (csrc/xy2d_multisweep.cu THREADS)
THREADS = 256


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def fits(ny: int, half: int) -> bool:
    """JAX's ``fits_vmem``: the four int16 planes (state and snapshot)
    of one replica within 9 MiB."""
    return 4 * ny * half * 2 <= VMEM_ANGLE_BUDGET


class SmemLayout(NamedTuple):
    """The ring of ``smem_multisweep_kernel``: ``blocks`` blocks a replica,
    block j owning chunks ``bounds[j]`` .. ``bounds[j + 1] - 1`` of 256
    sites, at most ``cap`` sites a block, in ``smem_bytes`` of shared
    memory a block; ``snap``: the snapshot's sites held there too."""
    blocks: int
    bounds: tuple[int, ...]
    cap: int
    smem_bytes: int
    snap: bool


def smem_need(cap: int, half: int, snap: bool) -> int:
    """Shared memory a block of ``cap`` sites takes: the other colour
    decoded, a float32 (cos, sin) a site and halo site, 8 (cap + 2 half);
    264 B a chunk; the int16 sites of both colours, 4 cap, and with
    ``snap`` the snapshot's, 4 cap more."""
    return (8 * (cap + 2 * half)
            + cap // xy2d_resident.CHUNK * xy2d_resident.CHUNK_BYTES
            + 4 * cap * (2 if snap else 1))


def smem_layout(nrep: int, ny: int, half: int, sms: int,
                smem_bytes: int) -> SmemLayout | None:
    """The fit rule of the two modes: the ring layout of
    ``smem_multisweep_kernel`` for ``nrep`` replicas of (ny, half) sites a
    colour, on ``sms`` block slots (SMs x blocks an SM) of at most
    ``smem_bytes`` shared memory each (the ring of
    ``xy2d_resident.ring_bounds``), with the snapshot held in shared memory
    where it fits and in device memory where only the state does; None
    where the state does not fit (then ``gmem_multisweep_kernel`` runs
    it, :func:`gmem_layout`)."""
    ring = xy2d_resident.ring_bounds(nrep, ny, half, sms)
    if ring is None:
        return None
    nb, bounds, cap = ring
    for snap in (True, False):
        need = smem_need(cap, half, snap)
        if need <= smem_bytes:
            return SmemLayout(nb, bounds, cap, need, snap)
    return None


class GmemLayout(NamedTuple):
    """The rings of ``gmem_multisweep_kernel``: ``rings`` rings of
    ``blocks`` blocks at once, ring t taking replicas t, t + rings, ... in
    turn; block j of a ring owning chunks ``bounds[j]`` .. ``bounds[j + 1]
    - 1`` of 256 sites, at most ``cap`` sites, of which it holds at most
    ``hold`` chunks in shared memory as int16 and decodes at most ``dec``
    of those (and ``half`` sites either side) once a phase, in
    ``smem_bytes`` of shared memory a block."""
    blocks: int
    bounds: tuple[int, ...]
    cap: int
    rings: int
    hold: int
    dec: int
    smem_bytes: int


# shared memory a held chunk takes (csrc/xy2d_multisweep.cu HELD_BYTES):
# its 256 int16 sites of both colours
HELD_BYTES = 2 * xy2d_resident.CHUNK * 2


def _room(bounds, n: int, half: int) -> int:
    """The most chunks a block of a ring of more than one can hold: those
    between its edge chunks (``csrc/xy2d_ring.cuh`` ``ring::Walk``: the
    chunks holding its first and last ``half`` sites)."""
    chunk = xy2d_resident.CHUNK
    most = 0
    for a, b in zip(bounds, bounds[1:]):
        nch, m = b - a, min((b - a) * chunk, n - a * chunk)
        head = min(-(-half // chunk), nch)
        tail = min(nch - (m - half) // chunk, nch - head)
        most = max(most, nch - head - tail)
    return most


def gmem_need(cap: int, half: int, hold: int, dec: int) -> int:
    """Shared memory a block of ``gmem_multisweep_kernel`` takes: 264 B a
    chunk of ``cap``; the held chunks' int16 sites of both colours, 1 KB a
    chunk; with ``dec`` > 0 the decoded plane, a float2 a site of ``dec``
    chunks and of ``half`` sites either side."""
    decoded = 8 * (dec * xy2d_resident.CHUNK + 2 * half) if dec else 0
    return (cap // xy2d_resident.CHUNK * xy2d_resident.CHUNK_BYTES
            + hold * HELD_BYTES + decoded)


def _gmem_rings(rings: int, ny: int, half: int, slots: int,
                smem_bytes: int) -> GmemLayout | None:
    """:func:`gmem_layout`'s layout of ``rings`` rings at once, or None
    where a block's sums (264 B a chunk) pass ``smem_bytes``."""
    nb, bounds, cap = xy2d_resident.ring_bounds(rings, ny, half, slots)
    need = gmem_need(cap, half, 0, 0)
    if need > smem_bytes:
        return None
    room = cap // xy2d_resident.CHUNK if nb == 1 else _room(
        bounds, ny * half, half)
    hold = min(room, (smem_bytes - need) // HELD_BYTES)
    left = smem_bytes - need - hold * HELD_BYTES
    dec = min(hold, max(left // 8 - 2 * half, 0) // xy2d_resident.CHUNK)
    return GmemLayout(nb, bounds, cap, rings, hold, dec,
                      gmem_need(cap, half, hold, dec))


def _decodes_all(lay: GmemLayout | None, ny: int, half: int) -> bool:
    """Every block of ``lay`` holds and decodes all the chunks no neighbour
    reads (all of a ring of one's)."""
    if lay is None:
        return False
    room = lay.cap // xy2d_resident.CHUNK if lay.blocks == 1 else _room(
        lay.bounds, ny * half, half)
    return lay.dec == lay.hold == room


def _most(test, hi: int) -> int:
    """The most r in 1 .. hi for which ``test(r)`` holds, or 0, by
    bisection: ``test`` holds below any r where it holds (fewer rings,
    more blocks a ring, fewer chunks a block)."""
    lo = 0
    while lo < hi:
        mid = (lo + hi + 1) // 2
        lo, hi = (mid, hi) if test(mid) else (lo, mid - 1)
    return lo


def gmem_layout(nrep: int, ny: int, half: int, slots: int,
                smem_bytes: int) -> GmemLayout | None:
    """The rule of the device-memory mode for ``nrep`` replicas of (ny,
    half) sites a colour on ``slots`` block slots of at most
    ``smem_bytes`` shared memory each: ``xy2d_resident.ring_bounds``'
    rings of ``slots // rings`` blocks at most, ``rings`` at once, each
    taking replicas in turn.  Beside its sums (264 B a chunk) a block
    holds as many of the chunks no neighbour reads (all of a ring of
    one's) as fit, then decodes as many of them as the rest takes.

    One ring a replica where the sums of that many fit (one turn: 1536^2
    x 2 and x 3).  Past that (1536^2 x 23 and more, more replicas than
    block slots) the replicas take turns on as many rings as still hold
    and decode every chunk no neighbour reads (at 1536^2 two rings of 66
    blocks: a ring that decodes none runs a replica ~1.6 times slower,
    PERF.md §6 row 49b), or where none do on as many as fit their sums;
    then on as few as take the replicas in as many turns.  None only
    where one ring of the most blocks still passes ``smem_bytes`` with
    its sums, which no lattice of JAX's bounds (``fits``, ny a multiple
    of 16) does on an H100."""
    def lay(r):
        return _gmem_rings(r, ny, half, slots, smem_bytes)

    # a ring's blocks own no more chunks as rings are fewer
    fit = _most(lambda r: lay(r) is not None, min(nrep, slots))
    if fit == 0:
        return None
    if fit < nrep:
        fit = _most(lambda r: _decodes_all(lay(r), ny, half), fit) or fit
    turns = -(-nrep // fit)
    return lay(-(-nrep // turns))


# ---------------------------------------------------------------------------
# the codec
# ---------------------------------------------------------------------------

def to_angles(sx: torch.Tensor, sy: torch.Tensor) -> torch.Tensor:
    """float32 component planes -> int16 angle plane: round(atan2(sy, sx)
    in 2^16 units), half to even, wrapped mod 2^16."""
    th = torch.atan2(sy, sx) * trig.f32(_UNITS)
    return torch.round(th).to(torch.int32).to(torch.int16)


def from_angles(k: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """int16 (or int32) angles -> float32 (cos θ, sin θ)."""
    th = k.to(torch.float32) * trig.f32(_TO_RAD)
    return torch.cos(th), torch.sin(th)


def rotate_angles(k: torch.Tensor, theta) -> torch.Tensor:
    """Global rotation by ``theta`` radians: an int16 add mod 2^16 of
    round(theta in 2^16 units)."""
    theta = torch.as_tensor(theta, dtype=torch.float32, device=k.device)
    dk = torch.round(theta * trig.f32(_UNITS)).to(torch.int32).to(
        torch.int16)
    return k + dk


def state_to_angles(state: XYState) -> tuple[torch.Tensor, torch.Tensor]:
    """(R, ny, half) XYState component planes -> int16 angle planes."""
    return to_angles(state.ax, state.ay), to_angles(state.bx, state.by)


def angles_to_state(pa: torch.Tensor, pb: torch.Tensor) -> XYState:
    return XYState(*from_angles(pa), *from_angles(pb))


def _cs(k: torch.Tensor):
    """(cos, sin) of int angle units: cos_sin_2pi of k / 2^16 turns."""
    return trig.cos_sin_2pi(k.to(torch.float32) * trig.f32(_INV_TURN))


def _cos_units(dk: torch.Tensor) -> torch.Tensor:
    """cos of an angle-unit difference (the autocorrelation term)."""
    return _cs(dk)[0]


def _atan2_units(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """atan2(y, x) in 2^16 angle units, float32: the octant-reduced A&S
    4.4.49 polynomial of JAX ``_atan2_units`` (|err| < 1e-5 rad), in its
    order."""
    ax, ay = x.abs(), y.abs()
    lo = torch.minimum(ax, ay)
    hi = torch.maximum(ax, ay)
    z = lo / torch.maximum(hi, trig.f32(1e-30))
    z2 = z * z
    p = trig.f32(_ATAN[-1])
    for c in reversed(_ATAN[:-1]):
        p = trig.f32(c) + z2 * p
    a = z * p
    a = torch.where(ay > ax, trig.f32(np.pi / 2) - a, a)
    a = torch.where(x < 0, trig.f32(np.pi) - a, a)
    a = torch.where(y < 0, -a, a)
    return a * trig.f32(_UNITS)


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------

def _field(o: torch.Tensor, color: int):
    """(hx, hy, co, so): the field at every site of ``color`` from the
    other colour's int16 plane, (up + dn) + (centre + side) of its decoded
    components, and those components."""
    co, so = _cs(o.to(torch.int32))
    return (xy2d_pallas.nbr_sum(co, color), xy2d_pallas.nbr_sum(so, color),
            co, so)


def _total(v: torch.Tensor) -> torch.Tensor:
    return v.to(torch.float64).sum(dim=(-2, -1))


def _sums(bx, by, hx, hy, cax, cay, ka, kb, sa, sb) -> torch.Tensor:
    """(R, 4) float64 (Σ S_x, Σ S_y, -Σ_b S_b·h_b, A) with colour b's
    components (bx, by) and angles kb, colour a's decoded (cax, cay) and
    angles ka, and the snapshots sa, sb."""
    a = (_total(_cos_units(sa.to(torch.int32) - ka))
         + _total(_cos_units(sb.to(torch.int32) - kb)))
    return torch.stack([_total(cax) + _total(bx), _total(cay) + _total(by),
                        -_total(bx * hx + by * hy), a], dim=-1)


def _words(rand, nrep: int, ny: int, half: int, device):
    """(candidate int32 in [0, 65535], uniform float32) planes of a phase:
    ``rand`` a Philox key (words 0 and 1 of counter (replica, row,
    column, 0)) or an injected (candidate, uniform) pair."""
    if isinstance(rand, (tuple, list)):
        cand, u = rand
        return cand.to(torch.int32), u
    gen = multispin_rng.word_stream(rand, nrep, ny, half, device)
    return (gen() >> 16).to(torch.int32), rng.bits_to_uniform(gen())


def _metropolis(x, o, rand, color: int, beta: float):
    """One Metropolis phase of the int16 plane ``x`` in place; returns
    (newk int32, unwrapped; the new components; the field; the other
    colour's decoded components)."""
    hx, hy, co, so = _field(o, color)
    k = x.to(torch.int32)
    cx, sx = _cs(k)
    cand, u = _words(rand, *x.shape, x.device)
    cc, cs = _cs(cand)
    de = -((cc - cx) * hx + (cs - sx) * hy)
    p = torch.exp(torch.maximum(de, trig.f32(0.0)) * trig.f32(-beta))
    accept = u < p
    newk = torch.where(accept, cand, k)
    x.copy_(newk.to(torch.int16))
    return (newk, torch.where(accept, cc, cx), torch.where(accept, cs, sx),
            hx, hy, co, so)


def _over_relax(x, o, color: int) -> None:
    """θ' = 2 round(φ) − θ, φ = _atan2_units(h_y, h_x), in place."""
    hx, hy, _, _ = _field(o, color)
    phi = _atan2_units(hy, hx)
    x.copy_((2 * torch.round(phi).to(torch.int32)
             - x.to(torch.int32)).to(torch.int16))


def _measure(pa, pb, sa, sb) -> torch.Tensor:
    """(R, 4) float64 sums of the state: the field at the b sites from a."""
    hx, hy, cax, cay = _field(pa, 1)
    kb = pb.to(torch.int32)
    bx, by = _cs(kb)
    return _sums(bx, by, hx, hy, cax, cay, pa.to(torch.int32), kb, sa, sb)


def multisweep_plain(pa, pb, sa, sb, rand, *, beta: float, n_or: int = 0,
                     or_only: bool = False) -> torch.Tensor:
    """Plain version of both modes: S sweeps of the int16
    planes (pa, pb) in place, snapshot planes (sa, sb); ``rand`` is the
    (S, 2, 2) per-(sweep, phase) Philox keys or S injected pairs
    ((cand_a, u_a), (cand_b, u_b)), the candidates int in [0, 65535].
    Returns the (R, S, 4) float64 per-sweep (Σ S_x, Σ S_y, e, A)."""
    rows = []
    for s in range(len(rand)):
        if or_only:
            for _ in range(max(n_or, 1)):
                _over_relax(pa, pb, 0)
                _over_relax(pb, pa, 1)
            rows.append(_measure(pa, pb, sa, sb))
            continue
        _metropolis(pa, pb, rand[s][0], 0, beta)
        newk, bx, by, hx, hy, cax, cay = _metropolis(pb, pa, rand[s][1], 1,
                                                     beta)
        if n_or == 0:
            rows.append(_sums(bx, by, hx, hy, cax, cay, pa.to(torch.int32),
                              newk, sa, sb))
            continue
        for _ in range(n_or):
            _over_relax(pa, pb, 0)
            _over_relax(pb, pa, 1)
        rows.append(_measure(pa, pb, sa, sb))
    return torch.stack(rows, dim=1)


# ---------------------------------------------------------------------------
# CUDA wrapper
# ---------------------------------------------------------------------------

_VOID = ctypes.c_void_p
_INT = ctypes.c_int


def _lib() -> ctypes.CDLL:
    return bind(_build.load("xy2d_multisweep"))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` (a build of ``csrc/xy2d_multisweep.cu``) with its C
    functions' argument types set."""
    if lib.xyi_multisweep_gmem.argtypes is not None:
        return lib
    lib.xyi_multisweep_gmem.argtypes = ([_VOID] * 9 + [_INT] * 12
                                        + [ctypes.c_float, _VOID])
    lib.xyi_multisweep_smem.argtypes = ([_VOID] * 10 + [_INT] * 10
                                        + [ctypes.c_float, _VOID])
    for fn in (lib.xyi_multisweep_gmem, lib.xyi_multisweep_smem):
        fn.restype = _INT
    for fn in (lib.xyi_smem_limits, lib.xyi_gmem_limits):
        fn.argtypes = [ctypes.POINTER(_INT)] * 5
        fn.restype = _INT
    lib.xyi_error_string.argtypes = [_INT]
    lib.xyi_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(code: int, lib, name: str = "gmem_multisweep_kernel") -> None:
    if code != 0:
        msg = lib.xyi_error_string(code).decode()
        raise RuntimeError(f"xy2d int16 {name}: CUDA error {code} ({msg})")


_LIMITS: dict[tuple, tuple[int, int]] = {}


def _limits(dev: torch.device, mode: str) -> tuple[int, int]:
    lib = _lib()
    key = (id(lib), dev.index, mode)
    if key not in _LIMITS:
        name = f"{mode}_multisweep_kernel"
        with torch.cuda.device(dev):
            _LIMITS[key] = xy2d_resident.read_limits(
                getattr(lib, f"xyi_{mode}_limits"),
                lambda code: _raise_on(code, lib, name), name)
    return _LIMITS[key]


def smem_limits(dev: torch.device) -> tuple[int, int]:
    """(block slots, shared memory a block) of ``smem_multisweep_kernel``
    on CUDA device ``dev`` (one block of 1024 threads an SM on the
    H100)."""
    return _limits(dev, "smem")


def gmem_limits(dev: torch.device) -> tuple[int, int]:
    """The same of ``gmem_multisweep_kernel``, for :func:`gmem_layout`."""
    return _limits(dev, "gmem")


def device_layout(pa: torch.Tensor) -> SmemLayout | None:
    """:func:`smem_layout` of the (R, ny, half) planes ``pa``'s shape on
    their CUDA device."""
    return smem_layout(*pa.shape, *smem_limits(pa.device))


def device_gmem_layout(pa: torch.Tensor) -> GmemLayout | None:
    """:func:`gmem_layout` of the (R, ny, half) planes ``pa``'s shape on
    their CUDA device."""
    return gmem_layout(*pa.shape, *gmem_limits(pa.device))


# (library, device, planes' shape, grid) -> the launch's mode ("multisweep"
# for the device-memory one, LAUNCHES' key), its layout and its bounds on
# the device: worked out once a shape, since a copy to the card from
# pageable host memory waits for the card's queue
_RINGS: dict[tuple, tuple[str, NamedTuple, torch.Tensor]] = {}


def _ring(pa: torch.Tensor, grid: bool) -> tuple[str, NamedTuple,
                                                  torch.Tensor]:
    key = (id(_lib()), pa.device, tuple(pa.shape), grid)
    if key not in _RINGS:
        mode, layout = "multisweep_smem", None if grid else device_layout(pa)
        if layout is None:
            mode, layout = "multisweep", device_gmem_layout(pa)
        if layout is None:
            raise RuntimeError(
                "xy2d int16 gmem_multisweep_kernel: no layout for planes of "
                f"shape {tuple(pa.shape)} (a block's sums pass its shared "
                "memory)")
        _RINGS[key] = (mode, layout, torch.tensor(
            layout.bounds, dtype=torch.int32, device=pa.device))
    return _RINGS[key]


def _check(planes) -> None:
    ref = planes[0]
    if ref.dim() != 3:
        raise ValueError(f"planes must be (R, ny, half), got {ref.shape}")
    nrep, ny, half = ref.shape
    if ny < 2 or half < 1 or nrep > 65535 or nrep * ny * half >= 2 ** 31:
        raise ValueError(f"kernel shape out of range: {tuple(ref.shape)}")
    for p in planes:
        if (p.shape != ref.shape or p.dtype != torch.int16 or not p.is_cuda
                or p.device != ref.device or not p.is_contiguous()):
            raise ValueError("planes must be contiguous int16 "
                             f"{tuple(ref.shape)} on one CUDA device")


def multisweep_planes(pa, pb, sa, sb, seeds, *, beta: float, n_or: int = 0,
                      or_only: bool = False, grid: bool = False
                      ) -> torch.Tensor:
    """S = len(seeds) sweeps of the int16 planes in place under the
    (S, 2, 2) per-(sweep, phase) keys: on CUDA tensors one launch,
    ``smem_multisweep_kernel`` where :func:`smem_layout` fits the batch on
    the card, else ``gmem_multisweep_kernel`` on :func:`gmem_layout`
    (``grid`` forces the latter); on CPU tensors :func:`multisweep_plain`.
    Returns the (R, S, 4) float64 per-sweep (Σ S_x, Σ S_y, e, A).  The
    kernels refuse a batch whose site index could reach 2^31; raises where
    neither mode has a layout."""
    if _on_cpu(pa):
        return multisweep_plain(pa, pb, sa, sb, seeds, beta=beta, n_or=n_or,
                                or_only=or_only)
    _check([pa, pb, sa, sb])
    nrep, ny, half = pa.shape
    sweeps = int(seeds.shape[0])
    dev = pa.device
    mode, layout, bounds = _ring(pa, grid)
    # from pinned memory, so the host need not wait for the card's queue
    seeds_dev = multispin_rng.keys_to(seeds, dev)
    nblk = -(-ny * half // THREADS)
    partials = torch.empty((nrep * sweeps, nblk, 4), dtype=torch.float64,
                           device=dev)
    obs = torch.empty((nrep, sweeps, 4), dtype=torch.float64, device=dev)
    lib = _lib()
    args = (pa.data_ptr(), pb.data_ptr(), sa.data_ptr(), sb.data_ptr(),
            seeds_dev.data_ptr(), partials.data_ptr(), obs.data_ptr(),
            bounds.data_ptr())
    with torch.cuda.device(dev):
        if mode == "multisweep":
            flags = torch.empty((layout.rings * layout.blocks,),
                                dtype=torch.int32, device=dev)
            code = lib.xyi_multisweep_gmem(
                *args, flags.data_ptr(), nrep, ny, half, sweeps, n_or,
                int(or_only), layout.blocks, layout.rings, layout.cap,
                layout.hold, layout.dec, layout.smem_bytes, -float(beta),
                _stream(pa))
        else:
            blocks = nrep * layout.blocks
            edges = torch.empty((blocks, 2, 2 * half), dtype=torch.int16,
                                device=dev)
            flags = torch.empty((blocks,), dtype=torch.int32, device=dev)
            code = lib.xyi_multisweep_smem(
                *args, edges.data_ptr(), flags.data_ptr(), nrep, ny, half,
                sweeps, n_or, int(or_only), layout.blocks, layout.cap,
                layout.smem_bytes, int(layout.snap), -float(beta),
                _stream(pa))
    if mode == "multisweep":
        _raise_on(code, lib)
    else:
        _raise_on(code, lib, "smem_multisweep_kernel")
    LAUNCHES[mode] += 1
    return obs


def multisweep(model, pa, pb, sa, sb, key, sweeps: int, n_or: int = 0,
               or_only: bool = False, t0: int = 0):
    """Sweeps t0+1 .. t0+sweeps of the sample keyed by ``key`` (JAX
    ``multisweep``, keyed by the global sweep index): returns
    (pa, pb, {mx, my, e, A} densities (R, sweeps) float64)."""
    ny, half = model.color_shape
    if not fits(ny, half):
        raise ValueError(
            f"lattice {ny}x{2 * half} does not fit the int16 XY multisweep "
            "(JAX's fits_vmem); use the phase-kernel path")
    seeds = multispin_rng.sweep_phase_keys(key, sweeps, t0)
    obs = multisweep_planes(pa, pb, sa, sb, seeds, beta=model.beta,
                            n_or=n_or, or_only=or_only)
    return pa, pb, xy2d_pallas.densities(model, obs)
