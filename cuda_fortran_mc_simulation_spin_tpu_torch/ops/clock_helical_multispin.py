"""Bit-sliced packed q=6 clock Metropolis for the helical (odd-nx) geometry.

Port of ``cuda_fortran_mc_simulation_spin_tpu/ops/clock_helical_multispin.py``:
the flat even/odd colour split of ops/helical_multispin.py (dense colour
vectors of M = nall/2 sites whose neighbours sit at four constant modular
offsets) with the CRT q=6 state of ops/clock_multispin.py (three planes a
colour: σ, t0 = [τ=1], t1 = [τ=2]) and its decision, reused verbatim.  A
colour vector is (R, W) int32 words, W = ceil(M/32), bit k of word g =
colour index 32g + k, as in the Ising helical engine; the pad bits
[M, 32W) may hold garbage and are masked in every sum.

The CUDA kernel is ``csrc/clock_helical_multispin.cu`` ``multisweep_kernel``:
S sweeps on one replica's resident planes a block, staged in shared
memory when both triplets fit (501x500: 6 x 15.3 KiB) and in device
memory otherwise, with the exact per-sweep (2m, 2e, my2); and, as its
injected mode, one phase of colour a with 8 given planes.  It replaces
``clock_helical_multispin.py:_ms_kernel`` (pallas_call at :310) and
``_phase_bits_kernel`` (:196).  Beside it is its plain PyTorch version
(:func:`multisweep_plain`, :func:`packed_helical_phase6_reference`), with
the same Philox words (key = the (sample, t, phase) key, counter =
(replica, word, 0, draw/4)).  The kernel draws them in one unrolled line
from a per-launch table (``multispin_rng.clock_draw_table`` of this
module's chains, the periodic packed clock's ``clock_planes._table_arg``;
``tests/test_torch_clock_helical_draw.py`` replays it on the CPU).  A
wrapper takes the plain version for a CPU tensor; for a CUDA tensor it
launches the kernel or raises.  ``LAUNCHES`` counts launches.
"""

from __future__ import annotations

import ctypes
import math

import torch

from cuda_fortran_mc_simulation_spin_tpu_torch.ops import _build, multispin_rng
from cuda_fortran_mc_simulation_spin_tpu_torch.ops.clock_multispin import (
    OBS_INT32_MAX_SITES,
    SPEC,
    _decide,
    accept_digit_planes,
    draw_planes,
)
from cuda_fortran_mc_simulation_spin_tpu_torch.ops.clock_planes import (
    _not,
    _pc,
    _table_arg,
)
from cuda_fortran_mc_simulation_spin_tpu_torch.ops.helical_multispin import (
    helical_offsets,
    pack_flat,
    shift_mod,
    unpack_flat,
    valid_mask,
    words,
)
from cuda_fortran_mc_simulation_spin_tpu_torch.ops.ising2d_multispin import (
    _i32,
    _on_cpu,
    _stream,
    _u32,
    sweep_seed_pairs,
)

# the JAX package's gate: grid_rows(M) <= 512 rows of 128 words
MAX_WORDS = 512 * 128

_SQRT3_2 = math.sqrt(3.0) / 2.0

# 2*cos(2*pi*d/6) for d = 0..5 (the flat oracle)
_TWOCOS = (2, 1, -1, -2, -1, 1)

LAUNCHES = {"multisweep": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def fits(model) -> bool:
    """The packed helical clock engine serves ``model`` (the JAX gate):
    q = 6, odd nx, even nsites, and at most MAX_WORDS words a colour."""
    m = model.nsites // 2
    return (getattr(model, "q", None) == 6 and model.nx % 2 == 1
            and model.nsites % 2 == 0
            and model.nsites <= OBS_INT32_MAX_SITES
            and 1 <= words(m) <= MAX_WORDS)


def pack_clock_flat(flat: torch.Tensor, m: int):
    """(..., m) int8 clock states 0..5 -> (σ, t0, t1) (..., W) int32."""
    c = flat.to(torch.int64)
    tau = c % 3
    return pack_flat(c & 1, m), pack_flat(tau == 1, m), pack_flat(tau == 2, m)


def unpack_clock_flat(s, t0, t1, m: int) -> torch.Tensor:
    """Inverse of :func:`pack_clock_flat` (c = (3σ + 4τ) mod 6)."""
    def bits(w):
        return (unpack_flat(w, m).to(torch.int64) + 1) >> 1
    tau = bits(t0) + 2 * bits(t1)
    return ((3 * bits(s) + 4 * tau) % 6).to(torch.int8)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def flat_phase6_reference(x_flat, o_flat, offs, r_sites, chain5):
    """Per-site integer Metropolis on flat colour vectors: ``r_sites`` the
    proposal offsets in [1, 5], ``chain5`` five boolean chain-pass
    vectors (B₁, B₂, B₄, B₈a, B₈b)."""
    x = x_flat.to(torch.int64)
    o = o_flat.to(torch.int64)
    cand = (x + r_sites.to(torch.int64)) % 6
    tc = torch.tensor(_TWOCOS, dtype=torch.int64, device=x.device)
    d_cur = d_new = 0
    for d in offs:
        nbr = torch.roll(o, -d, dims=-1)
        d_cur = d_cur + tc[(x - nbr) % 6]
        d_new = d_new + tc[(cand - nbr) % 6]
    big_d = d_cur - d_new
    mm = torch.clamp(big_d, min=0)
    gates = [mm & 1, (mm >> 1) & 1, (mm >> 2) & 1,
             ((mm >> 3) & 1) | ((mm >> 4) & 1), (mm >> 4) & 1]
    passes = torch.ones_like(x, dtype=torch.bool)
    for g, b in zip(gates, chain5):
        passes = passes & ((g == 0) | b)
    return torch.where((big_d <= 0) | passes, cand, x).to(torch.int8)


def _nbr_tuples(oplanes, offs, m: int):
    return tuple(tuple(_u32(shift_mod(p, d, m)) for d in offs)
                 for p in oplanes)


def packed_helical_phase6_reference(xplanes, oplanes, offs, planes8, m: int):
    """Plain packed phase of (..., W) triplets with injected planes: the
    plain version of the kernel's injected mode."""
    xs = tuple(_u32(p) for p in xplanes)
    ns, nt0, nt1 = _nbr_tuples(oplanes, offs, m)
    s, t0, t1, _ = _decide(*xs, ns, nt0, nt1,
                           tuple(_u32(p) for p in planes8))
    return tuple(_i32(p) for p in (s, t0, t1))


def _m2_my2(s, t0, t1, vm):
    """(2Σcos, Σsin/(√3/2)) of one colour's valid sites, (R,) int64."""
    zz = _not(t0 | t1) & vm
    m2 = (3 * _pc(zz, -1) - 6 * _pc(s & zz, -1) + 2 * _pc(s & vm, -1)
          - _pc(vm, -1))
    ns = _not(s)
    my2 = (_pc(((s & t0) | (ns & t1)) & vm, -1)
           - _pc(((ns & t0) | (s & t1)) & vm, -1))
    return m2, my2


def obs_packed6_reference(wa3, wb3, nx: int, m: int) -> torch.Tensor:
    """(R, 3) int64 (2m, 2e, my2) of a final state: the bonds of every
    b site against its four a neighbours (every bond once)."""
    vm = valid_mask(m, wa3[0].device)
    a3 = tuple(_u32(p) for p in wa3)
    b3 = tuple(_u32(p) for p in wb3)
    m2a, my2a = _m2_my2(*a3, vm)
    m2b, my2b = _m2_my2(*b3, vm)
    ns, nt0, nt1 = _nbr_tuples(a3, helical_offsets(nx)[1], m)
    s_x = s_w = 0
    for k in range(4):
        x = b3[0] ^ ns[k]
        eq = _not((b3[1] ^ nt0[k]) | (b3[2] ^ nt1[k]))
        s_x = s_x + _pc(x & vm, -1)
        s_w = s_w + _pc((x ^ eq) & vm, -1)
    return torch.stack([m2a + m2b, 4 * m + s_x - 3 * s_w, my2a + my2b], -1)


def _phase_plain(xplanes, oplanes, seeds, offs, m: int, digit5):
    nrep, nw = xplanes[0].shape
    stream = multispin_rng.word_stream(seeds, nrep, nw, 1,
                                       xplanes[0].device)

    def gen():
        return stream().reshape(nrep, nw)

    planes8 = draw_planes(gen, digit5)
    xs = tuple(_u32(p) for p in xplanes)
    ns, nt0, nt1 = _nbr_tuples(oplanes, offs, m)
    s, t0, t1, fin = _decide(*xs, ns, nt0, nt1, planes8)
    return (s, t0, t1), fin


def multisweep_plain(wa3, wb3, seeds, *, beta: float, nx: int, m: int):
    """Plain version of ``multisweep_kernel``: S = len(seeds) sweeps on
    (R, W) triplets under the (S, 2, 2) keys; returns (wa3, wb3, obs),
    obs the (R, S, 3) int64 (2m, 2e, my2) of every sweep."""
    offs_a, offs_b = helical_offsets(nx)
    digit5 = accept_digit_planes(beta)
    vm = valid_mask(m, wa3[0].device)
    obs = []
    for s in range(seeds.shape[0]):
        a3, _ = _phase_plain(wa3, wb3, seeds[s, 0], offs_a, m, digit5)
        wa3 = tuple(_i32(p) for p in a3)
        b3, (x_fin, w_fin) = _phase_plain(wb3, wa3, seeds[s, 1], offs_b, m,
                                          digit5)
        wb3 = tuple(_i32(p) for p in b3)
        m2a, my2a = _m2_my2(*a3, vm)
        m2b, my2b = _m2_my2(*b3, vm)
        s_x = sum(_pc(x & vm, -1) for x in x_fin)
        s_w = sum(_pc(w & vm, -1) for w in w_fin)
        obs.append(torch.stack([m2a + m2b, 4 * m + s_x - 3 * s_w,
                                my2a + my2b], -1))
    return wa3, wb3, torch.stack(obs, dim=1)


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

_VOID = ctypes.c_void_p
_INT = ctypes.c_int
_UINT = ctypes.c_uint


def _lib() -> ctypes.CDLL:
    lib = _build.load("clock_helical_multispin")
    if lib.clock_helical_multisweep.argtypes is not None:
        return lib
    lib.clock_helical_multisweep.argtypes = (
        [_VOID] * 12 + [_VOID, _VOID, _VOID]
        + [_INT] * 6 + [_INT] * 8 + [ctypes.POINTER(_UINT), _VOID])
    lib.clock_helical_multisweep.restype = _INT
    lib.clock_helical_smem_optin.argtypes = [ctypes.POINTER(_INT)]
    lib.clock_helical_smem_optin.restype = _INT
    lib.clock_helical_error_string.argtypes = [_INT]
    lib.clock_helical_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(lib, code: int, what: str) -> None:
    if code != 0:
        msg = lib.clock_helical_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def _check(m: int, *vecs: torch.Tensor) -> None:
    """The kernel takes int32 contiguous (R, W) vectors on one CUDA
    device, W = ceil(m/32) <= MAX_WORDS."""
    ref = vecs[0]
    if ref.dim() != 2 or ref.shape[1] != words(m) \
            or not 1 <= ref.shape[1] <= MAX_WORDS:
        raise ValueError(f"colour vectors of {m} sites need (R, "
                         f"{words(m)}) with W <= {MAX_WORDS}, got "
                         f"{tuple(ref.shape)}")
    for v in vecs:
        if v.shape != ref.shape or v.dtype != torch.int32:
            raise ValueError(f"vectors must be int32 {tuple(ref.shape)}, "
                             f"got {v.dtype} {tuple(v.shape)}")
        if v.device != ref.device or not v.is_cuda:
            raise ValueError("vectors must lie on one CUDA device")
        if not v.is_contiguous():
            raise ValueError("vectors must be contiguous")


_SMEM_OPTIN: dict[int, int] = {}


def staged_fits(nw: int, device) -> bool:
    """Both triplets of a replica (6 x W words) fit the block's shared
    memory, so the kernel stages them there; else it works in device
    memory."""
    dev = torch.device(device).index
    if dev is None:
        dev = torch.cuda.current_device()
    if dev not in _SMEM_OPTIN:
        lib = _lib()
        val = _INT(0)
        with torch.cuda.device(dev):
            _raise_on(lib, lib.clock_helical_smem_optin(ctypes.byref(val)),
                      "clock_helical_smem_optin")
        _SMEM_OPTIN[dev] = val.value
    return 6 * nw * 4 <= _SMEM_OPTIN[dev]


def _launch(wa3, wb3, m: int, offs_a, offs_b, *, seeds=None, planes8=None,
            beta: float = 1.0):
    bits = planes8 is not None
    inj = table = None
    if bits:
        inj = torch.stack([_i32(p) if p.dtype != torch.int32 else p
                           for p in planes8]).contiguous()
        _check(m, *wa3, *wb3, *inj)
    else:
        _check(m, *wa3, *wb3)
        # the C entry refuses a table draw_table_ok does not take
        table = _table_arg(SPEC, float(beta))
    lib = _lib()
    nrep, nw = wa3[0].shape
    staged = staged_fits(nw, wa3[0].device)
    sweeps = 1 if bits else int(seeds.shape[0])
    seeds_dev = (None if bits
                 else multispin_rng.keys_to(seeds, wa3[0].device))
    outs_a = [torch.empty_like(p) for p in wa3]
    outs_b = [torch.empty_like(p) for p in wb3]
    obs = None if bits else torch.empty((nrep, sweeps, 3), dtype=torch.int64,
                                        device=wa3[0].device)
    with torch.cuda.device(wa3[0].device):
        code = lib.clock_helical_multisweep(
            *[p.data_ptr() for p in (*wa3, *wb3, *outs_a, *outs_b)],
            None if bits else seeds_dev.data_ptr(),
            inj.data_ptr() if bits else None,
            None if bits else obs.data_ptr(),
            nrep, nw, m, sweeps, int(bits), int(staged),
            *[d % m for d in offs_a], *[d % m for d in offs_b],
            table, _stream(wa3[0]))
    _raise_on(lib, code, "clock helical multisweep_kernel")
    LAUNCHES["multisweep"] += 1
    return tuple(outs_a), tuple(outs_b), obs


def phase_packed_with_bits(xplanes, oplanes, planes8, *, offs, m: int):
    """One q=6 helical phase of (R, W) triplets with injected (ρ, rt1,
    rt2, B…) planes: the injected mode of ``multisweep_kernel`` on CUDA
    tensors, :func:`packed_helical_phase6_reference` on CPU tensors."""
    if _on_cpu(xplanes[0]):
        return packed_helical_phase6_reference(xplanes, oplanes, offs,
                                               planes8, m)
    return _launch(xplanes, oplanes, m, offs, offs, planes8=planes8)[0]


def multisweep_planes(wa3, wb3, seeds, *, beta: float, nx: int, m: int):
    """S = len(seeds) helical clock sweeps under the (S, 2, 2) keys:
    ``multisweep_kernel`` (one launch) on CUDA tensors,
    :func:`multisweep_plain` on CPU tensors.  Returns (wa3, wb3, obs),
    obs the (R, S, 3) int64 (2m, 2e, my2) of every sweep."""
    if _on_cpu(wa3[0]):
        return multisweep_plain(wa3, wb3, seeds, beta=beta, nx=nx, m=m)
    offs_a, offs_b = helical_offsets(nx)
    return _launch(wa3, wb3, m, offs_a, offs_b, seeds=seeds, beta=beta)


def densities(obs: torch.Tensor, nsites: int) -> dict[str, torch.Tensor]:
    """(m, e, my) float64 densities of (..., 3) (2m, 2e, my2) sums."""
    return {"m": obs[..., 0].to(torch.float64) * (0.5 / nsites),
            "e": obs[..., 1].to(torch.float64) * (0.5 / nsites),
            "my": obs[..., 2].to(torch.float64) * (_SQRT3_2 / nsites)}


def multisweep(model, wa3, wb3, key, sweeps: int, t0: int = 0):
    """Advance ``sweeps`` helical clock MCS on packed triplets with the
    per-sweep {m, e, my} densities (R, sweeps) float64.  ``key`` is the
    sample key and ``t0`` the global sweep index already completed."""
    wa3, wb3, obs = multisweep_planes(
        wa3, wb3, sweep_seed_pairs(key, sweeps, t0), beta=model.beta,
        nx=model.nx, m=model.nsites // 2)
    return wa3, wb3, densities(obs, model.nsites)

