"""Bit-packed (multispin) checkerboard Metropolis for Ising3D.

Port of ``cuda_fortran_mc_simulation_spin_tpu/ops/ising3d_multispin.py``:
the 2-D engine (ops/ising2d_multispin.py) lifted to the 6-neighbour
stencil.  The packed layout is the JAX package's, (R, nz, ny//32, nx//2)
int32: bit k of word row Y of plane z is lattice row 32Y + k of one
colour, so packed words compare bitwise with JAX directly.  Per word:

- z+-1 neighbours are the same word of the adjacent planes (periodic);
- y+-1 are one-bit funnel shifts carrying from the adjacent word rows;
- x+-1 are the neighbouring words under the masks 0xAAAAAAAA/0x55555555,
  which swap on odd z because the dual-colour x offset follows (y+z)
  parity (core/lattice.split_checkerboard3d);
- the count is a bit-sliced 6:3 counter (:func:`_count6`), and the only
  rejecting moves, ΔE ∈ {4, 8, 12}, are accepted through three Bernoulli
  planes from 20-digit chains (:func:`_flip_plane3d`).

The CUDA kernels are in ``csrc/ising3d_multispin.cu``: ``phase_kernel``
(one phase, optional fused exact (m, e), optional injected planes) and
``multisweep_kernel`` (S sweeps in one cooperative launch).  Both draw the
three chains in one unrolled line that follows a per-launch table
(``ops/multispin_rng.chain_table``, passed with the phase key), as the
helical 3-D phase does.  Beside each is
its plain PyTorch version here, with the same Philox words: key = the
(sample, t, phase) key, counter = (replica, z·(ny/32) + word row, column,
draw/4) (ops/multispin_rng.py).  A wrapper takes the plain version for a
CPU tensor; for a CUDA tensor it launches the kernel or raises.
``LAUNCHES`` counts kernel launches per kernel.

``phase_kernel<true>``, the halo mode of ``phase_kernel``, replaces
``_sharded_phase3d_kernel`` (pallas_call at ``:638``, :func:`sharded_phase3d_packed`): one phase on a z-shard of a
(dp, y) mesh (parallel/domain.py), the planes before and after the shard
from the exchanged packed halo planes, the side masks and the Philox
counter from the global plane z0 + z, so a shard draws what the unsharded
volume draws.
"""

from __future__ import annotations

import ctypes

import torch

from cuda_fortran_mc_simulation_spin_tpu_torch.core import tables
from cuda_fortran_mc_simulation_spin_tpu_torch.ops import _build, multispin_rng
from cuda_fortran_mc_simulation_spin_tpu_torch.ops.ising2d_multispin import (
    CHAIN_BITS,
    MASK32,
    PACK,
    _EVEN_BITS,
    _ODD_BITS,
    _bern_plane,
    _check_shard_planes,
    _count_planes,
    _digits,
    _i32,
    _on_cpu,
    _pc_plane,
    _phase_seeds,
    _stream,
    _u32,
    chain_digits,
    offsets,
    per_site,
    sweep_seed_pairs,
)

_TILE_Y, _TILE_X = 8, 32  # CUDA tile: word rows x words

# words of one colour volume of the whole batch up to which the runner
# takes the multisweep kernel.  This is not a crossover: measured on an
# H100 (chip_smoke.py phase 5, PERF.md), streamed phase pairs were 15-19%
# faster per sweep than the multisweep at every batch from 1 Mi to 16 Mi
# words in one run (80 registers hold the multisweep to 3 blocks an SM),
# while at 1 Mi words a run on a slower host found the multisweep faster.
# The bound exists only to keep the 256^3 x 4 class (1 Mi words) on the
# multisweep kernel, so that the port's counterpart of the JAX package's
# :409 stays on a main path; it goes, with the route or with a measured
# crossover, when ROADMAP queue B item 5 is decided.
_MS3_BATCH_WORDS = 1 << 20

LAUNCHES = {"phase": 0, "phase_measuring": 0, "multisweep": 0,
            "shard_phase": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def packable3d(ny: int, half: int) -> bool:
    """Shape is served by the multispin engine (the JAX criterion)."""
    return ny % (PACK * 8) == 0 and half % 128 == 0


def multisweep3d_fits(batch: int, nz: int, ny: int, half: int) -> bool:
    """The runner takes the multisweep kernel for ``batch`` replicas of
    (nz, ny, half) colour volumes: the port's counterpart of the JAX
    package's VMEM bound ``multisweep3d_fits_vmem``.  Both kernels keep
    the volumes in device memory; the bound is ``_MS3_BATCH_WORDS``."""
    return batch * nz * (ny // PACK) * half <= _MS3_BATCH_WORDS


def chain_words3d(beta: float) -> tuple[int, int, int]:
    """(q4, q8, q12): the B4/B8/B12 chain digits as the integers
    round(p·2^20) that the CUDA kernels take."""
    return tuple(sum(d << (CHAIN_BITS - 1 - j)
                     for j, d in enumerate(chain_digits(p)))
                 for p in tables.ising3d_accept_probs(beta))


def _count6(zm, zp, up, dn, ctr, side):
    """Bit-sliced 6-input counter -> (b1, b2, b4) planes of the
    neighbour-up count c = b1 + 2·b2 + 4·b4 ∈ [0, 6]."""
    s1, c1 = zm ^ zp, zm & zp
    s2, c2 = up ^ dn, up & dn
    s3, c3 = ctr ^ side, ctr & side
    b1 = s1 ^ s2 ^ s3
    t2 = (s1 & s2) | (s3 & (s1 ^ s2))       # carry of the ones layer
    w1, w2, _ = _count_planes(c1, c2, c3, t2)   # Σ ≤ 3: w4 unreachable
    return b1, w1, w2


def _flip_plane3d(x, b1, b2, b4, p4, p8, p12):
    """Packed 3-D Metropolis decision (uint32 in int64): flip mask of
    spin plane ``x`` given the count planes and Bernoulli planes."""
    nx_, nb1, nb2, nb4 = (~v & MASK32 for v in (x, b1, b2, b4))
    c4p = b4 & nb1 & nb2
    c5p = b4 & b1          # c = 7 is impossible, so b4&b1 ⇔ c == 5
    c6p = b4 & b2
    c2p = b2 & nb1 & nb4
    c1p = b1 & nb2 & nb4
    c0p = nb1 & nb2 & nb4
    need4 = (x & c4p) | (nx_ & c2p)
    need8 = (x & c5p) | (nx_ & c1p)
    need12 = (x & c6p) | (nx_ & c0p)
    return ((~(need4 | need8 | need12) & MASK32)
            | (need4 & p4) | (need8 & p8) | (need12 & p12))


def _neighbour_counts3d(o: torch.Tensor, color: int, hzm=None, hzp=None,
                        z0: int = 0):
    """(b1, b2, b4) of the six neighbours of every site of the colour
    that ``o`` (the other colour, uint32 in int64, (..., nz, nyp, half))
    surrounds; for a z-shard starting at global plane ``z0`` the halo
    planes ``hzm``/``hzp`` (uint32 in int64, (..., 1, nyp, half)) before
    and after it, by default the volume's own edge planes (periodic)."""
    if hzm is None:
        hzm, hzp = o[..., -1:, :, :], o[..., :1, :, :]
    zm = torch.cat([hzm, o[..., :-1, :, :]], dim=-3)
    zp = torch.cat([o[..., 1:, :, :], hzp], dim=-3)
    w_prev = torch.roll(o, 1, dims=-2)
    w_next = torch.roll(o, -1, dims=-2)
    up = ((o << 1) & MASK32) | (w_prev >> 31)
    dn = (o >> 1) | ((w_next << 31) & MASK32)
    minus = torch.roll(o, 1, dims=-1)
    plus = torch.roll(o, -1, dims=-1)
    nz = o.shape[-3]
    z_odd = ((z0 + torch.arange(nz, device=o.device)) & 1).bool().view(
        nz, 1, 1)
    modd = torch.where(z_odd, _EVEN_BITS, _ODD_BITS)
    meven = torch.where(z_odd, _ODD_BITS, _EVEN_BITS)
    if color == 0:
        side = (plus & modd) | (minus & meven)
    else:
        side = (minus & modd) | (plus & meven)
    return _count6(zm, zp, up, dn, o, side)


def packed_phase3d_reference(xw, ow, color: int, b4, b8, b12):
    """Plain packed 3-D phase on full (..., nz, nyp, half) volumes with
    given Bernoulli planes: the plain version of the phase kernel's
    injected-bits mode."""
    x = _u32(xw)
    b1, b2, b4c = _neighbour_counts3d(_u32(ow), color)
    return _i32(x ^ _flip_plane3d(x, b1, b2, b4c, _u32(b4), _u32(b8),
                                  _u32(b12)))


def _obs_sums3d(new, o, b1, b2, b4c) -> torch.Tensor:
    """(R, 2) int64 exact (m, e) of the whole lattice from phase b: the
    counts come from the final other colour, so e = -Σ_b s_b·(2c-6)
    covers every bond once; Σ s·(2c-6) = 4Σ(bit·c) - 12Σbit - 2Σc + 6N."""
    def pc(u):
        return _pc_plane(u).sum(dim=(-3, -2, -1))

    n = new.shape[-3] * new.shape[-2] * new.shape[-1] * PACK
    s_x = pc(new)
    s_c = pc(b1) + 2 * pc(b2) + 4 * pc(b4c)
    s_xc = pc(new & b1) + 2 * pc(new & b2) + 4 * pc(new & b4c)
    m = 2 * (s_x + pc(o)) - 2 * n
    e = -(4 * s_xc - 12 * s_x - 2 * s_c + 6 * n)
    return torch.stack([m, e], dim=-1)


def phase3d_plain(xw, ow, seeds, *, color: int, beta: float,
                  measuring: bool = False):
    """Plain version of ``phase_kernel`` with Philox words: one colour
    phase of (R, nz, nyp, half) int32 volumes under the phase key
    ``seeds`` ((2,) uint32).  Returns the new volume, and with
    ``measuring`` also the (R, 2) int64 exact (m, e) sums."""
    # the periodic volume is the z-shard at offset 0 whose halos are its
    # own edge planes
    res = sharded_phase3d_packed_plain(
        xw, ow, ow[:, -1:], ow[:, :1], seeds, (0, 0), color=color,
        beta=beta, measuring=measuring)
    if not measuring:
        return res
    return res[0], torch.stack(res[1:], dim=-1)


def sharded_phase3d_packed_plain(xw, ow, hzm, hzp, seeds, offs, *,
                                 color: int, beta: float, b4=None, b8=None,
                                 b12=None, measuring: bool = False):
    """Plain version of ``phase_kernel<true>``: the new (R, L, nyp, half)
    int32 shard volume given the other colour's and its halo planes;
    offs = (rep0, z0).  Bernoulli planes injected (``b4``, ``b8``,
    ``b12``), or from Philox words at the shard's global word rows
    (z0 + z)·nyp + Y.  With ``measuring`` also the (R,) int64 (m, e)
    partials."""
    rep0, z0 = offsets(offs)
    nrep, nz, nyp, half = xw.shape
    x, o = _u32(xw), _u32(ow)
    b1, b2, b4c = _neighbour_counts3d(o, color, _u32(hzm), _u32(hzp), z0)
    if b4 is None:
        stream = multispin_rng.word_stream(seeds, nrep, nz * nyp, half,
                                           xw.device, rep0, z0 * nyp)

        def gen():
            return stream().reshape(x.shape)

        q4, q8, q12 = chain_words3d(beta)
        p4 = _bern_plane(x.shape, _digits(q4), gen, xw.device)
        p8 = _bern_plane(x.shape, _digits(q8), gen, xw.device)
        p12 = _bern_plane(x.shape, _digits(q12), gen, xw.device)
    else:
        p4, p8, p12 = _u32(b4), _u32(b8), _u32(b12)
    new = x ^ _flip_plane3d(x, b1, b2, b4c, p4, p8, p12)
    if not measuring:
        return _i32(new)
    obs = _obs_sums3d(new, o, b1, b2, b4c)
    return _i32(new), obs[:, 0], obs[:, 1]


def multisweep3d_plain(wa, wb, seeds, *, beta: float):
    """Plain version of ``multisweep_kernel``: S = len(seeds) sweeps of
    phase pairs under the (S, 2, 2) keys; returns (wa, wb, obs) with obs
    the (R, S, 2) int64 (m, e) of every sweep."""
    obs = []
    for s in range(seeds.shape[0]):
        wa = phase3d_plain(wa, wb, seeds[s, 0], color=0, beta=beta)
        wb, o = phase3d_plain(wb, wa, seeds[s, 1], color=1, beta=beta,
                              measuring=True)
        obs.append(o)
    return wa, wb, torch.stack(obs, dim=1)


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

_VOID = ctypes.c_void_p
_INT = ctypes.c_int
_UINT = ctypes.c_uint
_TABLE = ctypes.POINTER(_UINT)


def _table(q) -> ctypes.Array:
    """The kernels' ChainTable of chain digits ``q`` (65 words), checked
    as the C entry points check it."""
    return (_UINT * (4 * multispin_rng.CHAIN_CALLS + 5))(
        *multispin_rng.check_chain_table(
            multispin_rng.chain_table(tuple(q))))


def _lib() -> ctypes.CDLL:
    lib = _build.load("ising3d_multispin")
    if lib.ising3d_phase.argtypes is not None:
        return lib
    lib.ising3d_phase.argtypes = [
        _VOID, _VOID, _VOID, _VOID, _VOID, _VOID, _VOID,
        _INT, _INT, _INT, _INT, _INT, _UINT, _UINT, _TABLE, _VOID]
    lib.ising3d_phase.restype = _INT
    lib.ising3d_multisweep.argtypes = [
        _VOID, _VOID, _VOID, _VOID, _VOID, _VOID,
        _INT, _INT, _INT, _INT, _INT, _TABLE, _VOID]
    lib.ising3d_multisweep.restype = _INT
    lib.ising3d_shard_phase.argtypes = (
        [_VOID] * 9 + [_INT] * 5 + [_UINT] * 4 + [_TABLE, _VOID])
    lib.ising3d_shard_phase.restype = _INT
    lib.ising3d_multisweep_grid.argtypes = [ctypes.POINTER(_INT)]
    lib.ising3d_multisweep_grid.restype = _INT
    lib.ising3d_error_string.argtypes = [_INT]
    lib.ising3d_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(lib, code: int, what: str) -> None:
    if code != 0:
        msg = lib.ising3d_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def _check_volumes(*vols: torch.Tensor) -> None:
    """The kernels take int32 contiguous (R, nz, nyp, half) volumes on one
    CUDA device with nyp % 8 == 0 and half % 32 == 0, and Philox counter
    fields that do not overflow: z·nyp + Y < 2^32."""
    ref = vols[0]
    if ref.dim() != 4:
        raise ValueError(f"volumes must be (R, nz, nyp, half), got "
                         f"{ref.shape}")
    _, nz, nyp, half = ref.shape
    if nyp % _TILE_Y or half % _TILE_X:
        raise ValueError(f"kernel needs nyp % {_TILE_Y} == 0 and half % "
                         f"{_TILE_X} == 0, got {tuple(ref.shape)}")
    if ref.numel() >= 2 ** 31 or nz * nyp >= 2 ** 32:
        raise ValueError(f"volume {tuple(ref.shape)} is too large for the "
                         "kernel's 32-bit tile and counter indices")
    for v in vols:
        if v.shape != ref.shape or v.dtype != torch.int32:
            raise ValueError(f"volumes must be int32 {tuple(ref.shape)}, "
                             f"got {v.dtype} {tuple(v.shape)}")
        if v.device != ref.device or not v.is_cuda:
            raise ValueError("volumes must lie on one CUDA device")
        if not v.is_contiguous():
            raise ValueError("volumes must be contiguous")


def _launch_phase(xw, ow, seeds, color, q, bits=None, measuring=False):
    _check_volumes(xw, ow, *(bits or ()))
    lib = _lib()
    nrep, nz, nyp, half = xw.shape
    out = torch.empty_like(xw)
    # zeroed: the kernel adds each block's sums with an atomic
    obs = (torch.zeros((nrep, 2), dtype=torch.int64, device=xw.device)
           if measuring else None)
    s0, s1 = (int(v) & MASK32 for v in seeds)
    b4, b8, b12 = bits or (None, None, None)
    with torch.cuda.device(xw.device):
        code = lib.ising3d_phase(
            xw.data_ptr(), out.data_ptr(), ow.data_ptr(),
            None if b4 is None else b4.data_ptr(),
            None if b8 is None else b8.data_ptr(),
            None if b12 is None else b12.data_ptr(),
            None if obs is None else obs.data_ptr(),
            nrep, nz, nyp, half, color, s0, s1, _table(q), _stream(xw))
    _raise_on(lib, code, "ising3d phase_kernel")
    LAUNCHES["phase"] += 1
    if measuring:
        LAUNCHES["phase_measuring"] += 1
        return out, obs
    return out


def phase3d_packed(xw, ow, seeds, *, color: int, beta: float,
                   measuring: bool = False):
    """One colour phase of (R, nz, nyp, half) int32 volumes with Philox
    words under ``seeds`` ((2,) uint32 key): ``phase_kernel`` on a CUDA
    tensor, :func:`phase3d_plain` on a CPU tensor.  Returns the new
    volume, and with ``measuring`` also the (R, 2) int64 (m, e) sums."""
    if _on_cpu(xw):
        return phase3d_plain(xw, ow, seeds, color=color, beta=beta,
                             measuring=measuring)
    return _launch_phase(xw, ow, seeds, color, chain_words3d(beta),
                         measuring=measuring)


def phase3d_packed_with_bits(xw, ow, b4, b8, b12, *, color: int
                             ) -> torch.Tensor:
    """One packed 3-D phase with injected Bernoulli planes: the bitwise-
    testable mode of ``phase_kernel`` (plain:
    :func:`packed_phase3d_reference`)."""
    if _on_cpu(xw):
        return packed_phase3d_reference(xw, ow, color, b4, b8, b12)
    return _launch_phase(xw, ow, (0, 0), color, (0, 0, 0), (b4, b8, b12))


def multisweep3d_planes(wa, wb, seeds, *, beta: float):
    """S = len(seeds) sweeps under the (S, 2, 2) per-(sweep, phase) keys:
    ``multisweep_kernel`` (one launch) on CUDA tensors,
    :func:`multisweep3d_plain` on CPU tensors.  Returns (wa, wb, obs) with
    obs the (R, S, 2) int64 (m, e) of every sweep."""
    if _on_cpu(wa):
        return multisweep3d_plain(wa, wb, seeds, beta=beta)
    _check_volumes(wa, wb)
    lib = _lib()
    nrep, nz, nyp, half = wa.shape
    sweeps = int(seeds.shape[0])
    seeds_dev = _i32(seeds).contiguous().to(wa.device)
    wa_out, wb_out = torch.empty_like(wa), torch.empty_like(wb)
    # zeroed: the kernel adds each block's sums with an atomic
    obs = torch.zeros((nrep, sweeps, 2), dtype=torch.int64, device=wa.device)
    with torch.cuda.device(wa.device):
        code = lib.ising3d_multisweep(
            wa.data_ptr(), wb.data_ptr(), wa_out.data_ptr(),
            wb_out.data_ptr(), seeds_dev.data_ptr(), obs.data_ptr(), nrep,
            nz, nyp, half, sweeps, _table(chain_words3d(beta)), _stream(wa))
    _raise_on(lib, code, "ising3d multisweep_kernel")
    LAUNCHES["multisweep"] += 1
    return wa_out, wb_out, obs


def sharded_phase3d_packed(xw, ow, hzm, hzp, seeds, offs, *, color: int,
                           beta: float, b4=None, b8=None, b12=None,
                           measuring: bool = False):
    """One packed colour phase of a z-sharded (R, L, nyp, half) int32
    block: ``phase_kernel<true>`` on CUDA tensors,
    :func:`sharded_phase3d_packed_plain` on CPU tensors.  hzm/hzp (R, 1,
    nyp, half) are the other colour's packed planes before and after the
    shard, offs = (rep0, z0); ``b4``/``b8``/``b12`` inject the Bernoulli
    planes.  Returns the new volume, and with ``measuring`` also the (R,)
    int64 (m, e) partials (JAX's ``sharded_phase3d_packed``, ``:638``)."""
    if _on_cpu(xw):
        return sharded_phase3d_packed_plain(
            xw, ow, hzm, hzp, seeds, offs, color=color, beta=beta, b4=b4,
            b8=b8, b12=b12, measuring=measuring)
    nrep, nz, nyp, half = xw.shape
    bits = [] if b4 is None else [b4, b8, b12]
    _check_shard_planes(xw, ow, [hzm, hzp], bits)
    if hzm.shape != (nrep, 1, nyp, half) or hzp.shape != hzm.shape:
        raise ValueError("halos must be the (R, 1, nyp, half) planes of "
                         "the shard")
    rep0, z0 = offsets(offs)
    if (z0 + nz) * nyp >= 2 ** 32:
        raise ValueError("the Philox word row would pass 2^32")
    q = (0, 0, 0) if b4 is not None else chain_words3d(beta)
    s0, s1 = (0, 0) if seeds is None else (int(v) & MASK32 for v in seeds)
    out = torch.empty_like(xw)
    # zeroed: the kernel adds each block's sums with an atomic
    obs = (torch.zeros((nrep, 2), dtype=torch.int64, device=xw.device)
           if measuring else None)

    def ptr(t):
        return None if t is None else t.data_ptr()

    lib = _lib()
    with torch.cuda.device(xw.device):
        code = lib.ising3d_shard_phase(
            xw.data_ptr(), out.data_ptr(), ow.data_ptr(), hzm.data_ptr(),
            hzp.data_ptr(), ptr(b4), ptr(b8), ptr(b12), ptr(obs), nrep, nz,
            nyp, half, color, rep0, z0, s0, s1, _table(q), _stream(xw))
    _raise_on(lib, code, "ising3d phase_kernel<true>")
    LAUNCHES["shard_phase"] += 1
    if measuring:
        return out, obs[:, 0], obs[:, 1]
    return out


def multisweep_grid_blocks() -> int:
    """Blocks of the cooperative multisweep grid on the current device."""
    lib = _lib()
    blocks = _INT(0)
    _raise_on(lib, lib.ising3d_multisweep_grid(ctypes.byref(blocks)),
              "ising3d_multisweep_grid")
    return blocks.value


# ---------------------------------------------------------------------------
# model-level entries (the JAX module's public functions)
# ---------------------------------------------------------------------------

def _densities(obs: torch.Tensor, nsites: int) -> dict[str, torch.Tensor]:
    return {"m": per_site(obs[..., 0], nsites),
            "e": per_site(obs[..., 1], nsites)}


def multisweep_packed3d(model, wa, wb, key, sweeps: int, t0: int = 0):
    """Advance ``sweeps`` 3-D MCS on packed volumes with per-sweep (m, e)
    densities (R, sweeps) float64.  ``key`` is the sample key and ``t0``
    the global sweep index already completed: the same keys as the
    streaming phases, so both routes give one trajectory."""
    wa, wb, obs = multisweep3d_planes(
        wa, wb, sweep_seed_pairs(key, sweeps, t0), beta=model.beta)
    return wa, wb, _densities(obs, model.nsites)


def sweep_measure_seeded3d(model, wa, wb, seeds):
    """One MCS under the sweep's (2, 2) phase keys (a row of
    ``sweep_seed_pairs``) with the fused (m, e) densities (R,) float64
    from phase b."""
    wa = phase3d_packed(wa, wb, seeds[0], color=0, beta=model.beta)
    wb, obs = phase3d_packed(wb, wa, seeds[1], color=1, beta=model.beta,
                             measuring=True)
    return wa, wb, _densities(obs, model.nsites)


def sweep_measure_packed3d(model, wa, wb, key):
    """One MCS under the sweep key ``key`` with the fused (m, e)."""
    return sweep_measure_seeded3d(model, wa, wb, _phase_seeds(key))


def sweep_packed3d(model, wa, wb, key):
    """One full MCS on packed colour volumes (R, nz, ny//32, half)."""
    seeds = _phase_seeds(key)
    wa = phase3d_packed(wa, wb, seeds[0], color=0, beta=model.beta)
    wb = phase3d_packed(wb, wa, seeds[1], color=1, beta=model.beta)
    return wa, wb
