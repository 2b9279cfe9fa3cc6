"""Bit-packed (multispin) checkerboard Metropolis for Ising2D.

Port of ``cuda_fortran_mc_simulation_spin_tpu/ops/ising2d_multispin.py``.
32 spins of one checkerboard colour share an int32 word: bit k of word
row Y is lattice row 32Y + k.  A phase is boolean algebra on words:

- y+-1 neighbours are one-bit funnel shifts carrying from the adjacent
  word row; x+-1 neighbours are the neighbouring words; the row-parity
  side select of the dual-colour layout (core/lattice.py) is the masks
  0xAAAAAAAA / 0x55555555, because bit parity is row parity;
- the 4-neighbour count is bit-sliced into ones/twos/fours planes;
- the only rejecting moves are (up, count 3|4) and (down, count 1|0),
  ΔE = 4 and 8; they are accepted through Bernoulli planes B4 ~ e^{-4β}
  and B8 ~ e^{-8β} built from 20-digit chains of random words.

The CUDA kernels are in ``csrc/ising2d_multispin.cu``: ``phase_kernel``
(one phase, optional fused exact (m, e), optional injected B planes) and
``multisweep_kernel`` (S sweeps in one cooperative launch).  Beside each
is its plain PyTorch version in this module, with the same Philox words
(ops/multispin_rng.py) and the same algebra; the kernels draw the B4 and
B8 chains in one unrolled line that follows the launch's table
(``multispin_rng.chain_table((q4, q8, 0))``, passed with the phase key),
the plain versions chain by chain (:func:`_bern_plane`), and
``tests/test_torch_ising2d_chains.py`` holds the two equal on the CPU.
The multisweep's grid is :func:`multisweep_grid`.  A wrapper takes the plain
version for a CPU tensor; for a CUDA tensor it launches the kernel or
raises.  ``LAUNCHES`` counts kernel launches per kernel.

Plain versions hold uint32 words in int64 tensors (``_u32``) so that
shifts are logical; planes cross module boundaries as int32, as in JAX.

``phase_kernel<true>``, the halo mode of ``phase_kernel``, replaces
``_sharded_phase_kernel`` (pallas_call at ``:783``,
:func:`sharded_phase_packed`): one phase on a shard of a (y[, x])
mesh (parallel/domain.py).  The carries into the shard's first and out of
its last word row are the exchanged boundary bits (0/1 planes,
parallel/halo.exchange_halo_rows_packed), the words past its columns with
an x split the exchanged word columns; the Philox counter is the word's
global position, so a shard draws what the unsharded plane draws (JAX's
granule keying and ``w_total`` are TPU artefacts).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from cuda_fortran_mc_simulation_spin_tpu_torch.core import rng, tables
from cuda_fortran_mc_simulation_spin_tpu_torch.models.base import (
    CheckerboardState,
)
from cuda_fortran_mc_simulation_spin_tpu_torch.ops import _build, multispin_rng

PACK = 32          # spins per word
# the JAX kernels accumulate (m, e) in int32 and cap the lattice here;
# the port accumulates in int64 and needs no cap (kept for reference)
OBS_INT32_MAX_SITES = (2 ** 31 - 1) // 3
CHAIN_BITS = multispin_rng.CHAIN_BITS  # P quantized to 2^-20
MASK32 = 0xFFFFFFFF
_ODD_BITS = 0xAAAAAAAA   # word bits at odd lattice rows
_EVEN_BITS = 0x55555555
_TILE_Y, _TILE_X = 8, 32  # CUDA tile: word rows x words

# words of one colour plane of the whole batch up to which the runner
# takes the multisweep kernel.  Measured on an H100 (chip_smoke.py phase
# 5, PERF.md): a multisweep sweep costs ~0.16 ms per Mi words at any
# size, a streamed phase pair ~0.125 ms per Mi words but no less than
# the host's ~0.2 ms for its launches; so the multisweep is faster at
# 1 Mi words and slower at 4 Mi.  The JAX package's bound (a replica in
# VMEM) is no limit here: both kernels keep the planes in device memory.
_MS_BATCH_WORDS = 1 << 20

LAUNCHES = {"phase": 0, "phase_measuring": 0, "multisweep": 0,
            "shard_phase": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def packable(ny: int, half: int) -> bool:
    """Shape is served by the multispin engine (the JAX criterion)."""
    return ny % (PACK * 8) == 0 and half % 128 == 0


def multisweep_fits(batch: int, ny: int, half: int) -> bool:
    """The runner takes the multisweep kernel for ``batch`` replicas of
    (ny, half) colour planes."""
    return batch * (ny // PACK) * half <= _MS_BATCH_WORDS


def _u32(w: torch.Tensor) -> torch.Tensor:
    return w.to(torch.int64) & MASK32


def _i32(u: torch.Tensor) -> torch.Tensor:
    u = u.to(torch.int64)
    return torch.where(u >= 2 ** 31, u - 2 ** 32, u).to(torch.int32)


def pack_color(plane: torch.Tensor) -> torch.Tensor:
    """(..., ny, half) ±1 int8 colour plane -> (..., ny//32, half) int32
    with bit k of word row Y = (spin at row 32Y+k) > 0."""
    ny, half = plane.shape[-2:]
    bits = (plane > 0).to(torch.int64).reshape(
        plane.shape[:-2] + (ny // PACK, PACK, half))
    weights = torch.tensor([1 << k for k in range(PACK)], dtype=torch.int64,
                           device=plane.device).view(PACK, 1)
    return _i32((bits * weights).sum(dim=-2))


def unpack_color(w: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_color` (to ±1 int8)."""
    k = torch.arange(PACK, dtype=torch.int64, device=w.device).view(PACK, 1)
    bits = (_u32(w).unsqueeze(-2) >> k) & 1          # (..., nyp, 32, half)
    shape = w.shape[:-2] + (w.shape[-2] * PACK, w.shape[-1])
    return (bits * 2 - 1).reshape(shape).to(torch.int8)


def _pc_plane(u: torch.Tensor) -> torch.Tensor:
    """Per-word set-bit count (SWAR) of uint32 words in int64."""
    u = u - ((u >> 1) & 0x55555555)
    u = (u & 0x33333333) + ((u >> 2) & 0x33333333)
    u = (u + (u >> 4)) & 0x0F0F0F0F
    return ((u * 0x01010101) & MASK32) >> 24


def popcount_sum(w: torch.Tensor) -> torch.Tensor:
    """Total set-bit (spin-up) count over packed planes, int64."""
    return _pc_plane(_u32(w)).sum()


def chain_digits(p: float, k: int = CHAIN_BITS) -> list[int]:
    """Binary digits d₁..d_k (MSB first) of p rounded to k bits."""
    q = int(round(min(max(p, 0.0), 1.0) * (1 << k)))
    if q >= (1 << k):
        # p rounds to 1: clamp to 1 - 2^-k (the ΔE ≤ 0 branch is
        # separate, so this only touches absurdly high temperatures)
        q = (1 << k) - 1
    return [(q >> (k - 1 - j)) & 1 for j in range(k)]


def chain_words(beta: float) -> tuple[int, int]:
    """(q4, q8): the B4/B8 chain digits as the integers round(p·2^20)
    that the CUDA kernels take (digit j is bit 19 - j)."""
    q4, q8 = (sum(d << (CHAIN_BITS - 1 - j)
                  for j, d in enumerate(chain_digits(p)))
              for p in tables.ising2d_accept_probs(beta))
    return q4, q8


def _digits(q: int, k: int = CHAIN_BITS) -> list[int]:
    """Chain digits d_1..d_k of the integer q = round(p·2^k)."""
    return [(q >> (k - 1 - j)) & 1 for j in range(k)]


def digits_int(digits) -> int:
    """The integer q = round(p·2^k) of the chain digits d_1..d_k (MSB
    first): what the CUDA kernels take, with k."""
    k = len(digits)
    return sum(d << (k - 1 - j) for j, d in enumerate(digits))


def chain_draws(q: int, k: int = CHAIN_BITS) -> int:
    """Random words one Bernoulli chain of k digits ``q`` consumes."""
    if q == 0:
        return 0
    return k - ((q & -q).bit_length() - 1)


def _bern_plane(shape, digits, gen, device=None) -> torch.Tensor:
    """Bernoulli(0.d₁d₂…) word plane from fresh random words ``gen()``.

    LSB→MSB: B ← r|B on digit 1, r&B on digit 0; trailing zero digits
    are skipped (they only mask an all-zero start)."""
    j = len(digits) - 1
    while j >= 0 and digits[j] == 0:
        j -= 1
    if j < 0:
        return torch.zeros(shape, dtype=torch.int64, device=device)
    b = gen()  # digit j is 1: B = r | 0
    for d in reversed(digits[:j]):
        r = gen()
        b = (r | b) if d else (r & b)
    return b


def _count_planes(n1, n2, n3, n4):
    """Bit-sliced count of 4 one-bit planes -> (ones, twos, fours)."""
    s1 = n1 ^ n2
    c1 = n1 & n2
    s2 = n3 ^ n4
    c2 = n3 & n4
    ones = s1 ^ s2
    c3 = s1 & s2
    twos = c1 ^ c2 ^ c3
    fours = (c1 & c2) | (c3 & (c1 ^ c2))
    return ones, twos, fours


def _flip_plane(x, ones, twos, fours, b4, b8):
    """Packed Metropolis decision: flip mask for spin plane ``x`` given
    the neighbour-count planes and the Bernoulli planes (uint32 in int64)."""
    nx_ = ~x & MASK32
    nf = ~fours & MASK32
    c3p = twos & ones & nf
    c1p = ones & ~twos & nf
    c0p = ~(ones | twos | fours) & MASK32
    need4 = (x & c3p) | (nx_ & c1p)
    need8 = (x & fours) | (nx_ & c0p)
    return (~(need4 | need8) & MASK32) | (need4 & b4) | (need8 & b8)


def _side(minus, plus, color: int):
    """The side neighbour plane: bit parity is row parity."""
    if color == 0:
        return (plus & _ODD_BITS) | (minus & _EVEN_BITS)
    return (minus & _ODD_BITS) | (plus & _EVEN_BITS)


def _neighbour_counts(o: torch.Tensor, color: int):
    """(ones, twos, fours) of the four neighbours of every site of the
    colour that ``o`` (the other colour, uint32 in int64, (..., nyp,
    half)) surrounds; periodic: the halos are its own edge bits."""
    return _shard_neighbour_counts(o, color, (o[..., -1:, :] >> 31) & 1,
                                   o[..., :1, :] & 1)


def offsets(offs) -> tuple[int, ...]:
    """A shard's global offsets (rep0, row0[, col0]) as Python ints."""
    return tuple(int(v) for v in torch.as_tensor(offs).tolist())


def _shard_neighbour_counts(o, color: int, hup01, hdn01, halo_lf=None,
                            halo_rt=None):
    """(ones, twos, fours) of a shard's colour given the other colour
    ``o`` (uint32 in int64, (..., Lp, half)): the carry into word row 0 is
    bit 0 of ``hup01`` spliced in at bit 31, the carry out of the last
    word row bit 0 of ``hdn01`` ((..., 1, half)); with an x split the side
    words past the edges are the word columns ``halo_lf``/``halo_rt``
    ((..., Lp, 1)), else periodic (JAX ``packed_sharded_phase_reference``)."""
    syn_up = (_u32(hup01) << 31) & MASK32
    w_prev = torch.cat([syn_up, o[..., :-1, :]], dim=-2)
    w_next = torch.cat([o[..., 1:, :], _u32(hdn01)], dim=-2)
    up = ((o << 1) & MASK32) | (w_prev >> 31)
    dn = (o >> 1) | ((w_next << 31) & MASK32)
    if halo_lf is None:
        minus = torch.roll(o, 1, dims=-1)
        plus = torch.roll(o, -1, dims=-1)
    else:
        minus = torch.cat([_u32(halo_lf), o[..., :-1]], dim=-1)
        plus = torch.cat([o[..., 1:], _u32(halo_rt)], dim=-1)
    return _count_planes(up, dn, o, _side(minus, plus, color))


def sharded_phase_packed_plain(xw, ow, hup01, hdn01, seeds, offs, *,
                               color: int, beta: float, halo_lf=None,
                               halo_rt=None, b4=None, b8=None,
                               measuring: bool = False):
    """Plain version of ``phase_kernel<true>``: the new (R, Lp, half)
    int32 shard plane given the other colour's and its halos; offs =
    (rep0, wrow0[, col0]).  Bernoulli planes injected (``b4``, ``b8``), or
    from Philox words at the shard's global word positions.  With
    ``measuring`` also the (R,) int64 (m, e) partials."""
    rep0, wrow0, *rest = offsets(offs)
    col0 = rest[0] if rest else 0
    nrep, nyp, half = xw.shape
    x, o = _u32(xw), _u32(ow)
    ones, twos, fours = _shard_neighbour_counts(o, color, hup01, hdn01,
                                                halo_lf, halo_rt)
    if b4 is None:
        gen = multispin_rng.word_stream(seeds, nrep, nyp, half, xw.device,
                                        rep0, wrow0, col0)
        q4, q8 = chain_words(beta)
        p4 = _bern_plane(x.shape, _digits(q4), gen, xw.device)
        p8 = _bern_plane(x.shape, _digits(q8), gen, xw.device)
    else:
        p4, p8 = _u32(b4), _u32(b8)
    new = x ^ _flip_plane(x, ones, twos, fours, p4, p8)
    if not measuring:
        return _i32(new)
    obs = _obs_sums(new, o, ones, twos, fours)
    return _i32(new), obs[:, 0], obs[:, 1]


def packed_phase_reference(xw, ow, color: int, b4, b8) -> torch.Tensor:
    """Plain packed phase on full (..., nyp, half) planes with given
    Bernoulli planes (periodic wrap via roll): the plain version of the
    kernel's injected-bits mode."""
    x = _u32(xw)
    ones, twos, fours = _neighbour_counts(_u32(ow), color)
    flip = _flip_plane(x, ones, twos, fours, _u32(b4), _u32(b8))
    return _i32(x ^ flip)


def _obs_sums(new, o, ones, twos, fours) -> torch.Tensor:
    """(R, 2) int64 exact (m, e) sums of the whole lattice from phase b:
    the counts come from the final other-colour values, so
    e = -Σ_b s_b·(2c-4) covers every bond once."""
    def pc(u):
        return _pc_plane(u).sum(dim=(-2, -1))

    nx_sites = new.shape[-2] * new.shape[-1] * PACK
    s_x = pc(new)
    s_c = pc(ones) + 2 * pc(twos) + 4 * pc(fours)
    s_xc = pc(new & ones) + 2 * pc(new & twos) + 4 * pc(new & fours)
    m = 2 * (s_x + pc(o)) - 2 * nx_sites
    e = -(4 * s_xc - 8 * s_x - 2 * s_c + 4 * nx_sites)
    return torch.stack([m, e], dim=-1)


def phase_packed_plain(xw, ow, seeds, *, color: int, beta: float,
                       measuring: bool = False):
    """Plain version of ``phase_kernel`` with Philox words: one colour
    phase of (R, nyp, half) int32 planes under the phase key ``seeds``
    ((2,) uint32).  Returns the new plane, and with ``measuring`` also
    the (R, 2) int64 exact (m, e) sums."""
    # the periodic plane is the shard at offset 0 whose halos are its own
    # edge bits
    res = sharded_phase_packed_plain(
        xw, ow, (ow[:, -1:] >> 31) & 1, ow[:, :1] & 1, seeds, (0, 0),
        color=color, beta=beta, measuring=measuring)
    if not measuring:
        return res
    return res[0], torch.stack(res[1:], dim=-1)


def multisweep_planes_plain(wa, wb, seeds, *, beta: float):
    """Plain version of ``multisweep_kernel``: S = len(seeds) sweeps of
    phase pairs under the (S, 2, 2) keys; returns (wa, wb, obs) with obs
    the (R, S, 2) int64 (m, e) of every sweep."""
    obs = []
    for s in range(seeds.shape[0]):
        wa = phase_packed_plain(wa, wb, seeds[s, 0], color=0, beta=beta)
        wb, o = phase_packed_plain(wb, wa, seeds[s, 1], color=1, beta=beta,
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


@functools.lru_cache(maxsize=64)
def _table(q4: int, q8: int) -> ctypes.Array:
    """The kernels' ChainTable of the chains B4, B8 (digits q4, q8) and an
    empty third chain: the 65 words of ``multispin_rng.chain_table``,
    checked as the C entry points check them (cached, as a launch's
    constant)."""
    return (_UINT * (4 * multispin_rng.CHAIN_CALLS + 5))(
        *multispin_rng.check_chain_table(
            multispin_rng.chain_table((q4, q8, 0))))


def _lib() -> ctypes.CDLL:
    lib = _build.load("ising2d_multispin")
    if lib.ising2d_phase.argtypes is not None:
        return lib
    lib.ising2d_phase.argtypes = [
        _VOID, _VOID, _VOID, _VOID, _VOID, _VOID, _INT, _INT, _INT, _INT,
        _UINT, _UINT, _TABLE, _VOID]
    lib.ising2d_phase.restype = _INT
    lib.ising2d_multisweep.argtypes = [
        _VOID, _VOID, _VOID, _VOID, _VOID, _VOID, _INT, _INT, _INT, _INT,
        _INT, _INT, _TABLE, _VOID]
    lib.ising2d_multisweep.restype = _INT
    lib.ising2d_shard_phase.argtypes = (
        [_VOID] * 10 + [_INT] * 4 + [_UINT] * 5 + [_TABLE, _VOID])
    lib.ising2d_shard_phase.restype = _INT
    lib.ising2d_multisweep_grid.argtypes = [ctypes.POINTER(_INT),
                                            ctypes.POINTER(_INT)]
    lib.ising2d_multisweep_grid.restype = _INT
    lib.ising2d_error_string.argtypes = [_INT]
    lib.ising2d_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(lib, code: int, what: str) -> None:
    if code != 0:
        msg = lib.ising2d_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def _check_planes(*planes: torch.Tensor) -> None:
    """The kernels take int32 contiguous (R, nyp, half) planes on one
    CUDA device with nyp % 8 == 0 and half % 32 == 0, of fewer than 2^31
    words (the kernels' 32-bit indices)."""
    ref = planes[0]
    if ref.dim() != 3:
        raise ValueError(f"planes must be (R, nyp, half), got {ref.shape}")
    _, nyp, half = ref.shape
    if nyp % _TILE_Y or half % _TILE_X:
        raise ValueError(f"kernel needs nyp % {_TILE_Y} == 0 and half % "
                         f"{_TILE_X} == 0, got {tuple(ref.shape)}")
    _check_indices(ref)
    for p in planes:
        if p.shape != ref.shape or p.dtype != torch.int32:
            raise ValueError(f"planes must be int32 {tuple(ref.shape)}, "
                             f"got {p.dtype} {tuple(p.shape)}")
        if p.device != ref.device or not p.is_cuda:
            raise ValueError("planes must lie on one CUDA device")
        if not p.is_contiguous():
            raise ValueError("planes must be contiguous")


def _check_indices(ref: torch.Tensor) -> None:
    if ref.numel() >= 2 ** 31:
        raise ValueError(f"planes {tuple(ref.shape)} are too large for the "
                         "kernels' 32-bit indices")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def per_site(sums: torch.Tensor, nsites: int) -> torch.Tensor:
    """float64 ``sums / nsites``, correctly rounded on the card as on the
    CPU: PyTorch's CUDA division by a Python number multiplies by its
    reciprocal (up to 1 ulp off the quotient); by a tensor on the sums'
    device it divides."""
    return sums.to(torch.float64) / torch.full(
        (), nsites, dtype=torch.float64, device=sums.device)


def _on_cpu(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"no kernel for device {t.device}")


def _launch_phase(xw, ow, seeds, color, q4, q8, b4=None, b8=None,
                  measuring=False):
    extra = () if b4 is None else (b4, b8)
    _check_planes(xw, ow, *extra)
    lib = _lib()
    nrep, nyp, half = xw.shape
    out = torch.empty_like(xw)
    # zeroed: the kernel adds each block's sums with an atomic
    obs = (torch.zeros((nrep, 2), dtype=torch.int64, device=xw.device)
           if measuring else None)
    s0, s1 = (int(v) & MASK32 for v in seeds)
    with torch.cuda.device(xw.device):
        code = lib.ising2d_phase(
            xw.data_ptr(), out.data_ptr(), ow.data_ptr(),
            None if b4 is None else b4.data_ptr(),
            None if b8 is None else b8.data_ptr(),
            None if obs is None else obs.data_ptr(),
            nrep, nyp, half, color, s0, s1, _table(q4, q8), _stream(xw))
    _raise_on(lib, code, "ising2d phase_kernel")
    LAUNCHES["phase"] += 1
    if measuring:
        LAUNCHES["phase_measuring"] += 1
        return out, obs
    return out


def phase_packed(xw, ow, seeds, *, color: int, beta: float,
                 measuring: bool = False):
    """One colour phase of (R, nyp, half) int32 planes with Philox words
    under ``seeds`` ((2,) uint32 key): ``phase_kernel`` on a CUDA tensor,
    :func:`phase_packed_plain` on a CPU tensor.  Returns the new plane,
    and with ``measuring`` also the (R, 2) int64 exact (m, e) sums."""
    if _on_cpu(xw):
        return phase_packed_plain(xw, ow, seeds, color=color, beta=beta,
                                  measuring=measuring)
    q4, q8 = chain_words(beta)
    return _launch_phase(xw, ow, seeds, color, q4, q8, measuring=measuring)


def phase_packed_with_bits(xw, ow, b4, b8, *, color: int) -> torch.Tensor:
    """One packed phase with injected Bernoulli planes: the bitwise-
    testable mode of ``phase_kernel`` (plain: packed_phase_reference)."""
    if _on_cpu(xw):
        return packed_phase_reference(xw, ow, color, b4, b8)
    return _launch_phase(xw, ow, (0, 0), color, 0, 0, b4, b8)


def multisweep_planes(wa, wb, seeds, *, beta: float):
    """S = len(seeds) sweeps under the (S, 2, 2) per-(sweep, phase) keys:
    ``multisweep_kernel`` (one launch) on CUDA tensors,
    :func:`multisweep_planes_plain` on CPU tensors.  Returns
    (wa, wb, obs) with obs the (R, S, 2) int64 (m, e) of every sweep."""
    if _on_cpu(wa):
        return multisweep_planes_plain(wa, wb, seeds, beta=beta)
    _check_planes(wa, wb)
    lib = _lib()
    nrep, nyp, half = wa.shape
    sweeps = int(seeds.shape[0])
    q4, q8 = chain_words(beta)
    blocks, per = multisweep_grid(
        nrep * (nyp // _TILE_Y) * (half // _TILE_X), *_resident_grid())
    seeds_dev = _i32(seeds).contiguous().to(wa.device)
    wa_out, wb_out = torch.empty_like(wa), torch.empty_like(wb)
    # zeroed: the kernel adds each block's sums with an atomic
    obs = torch.zeros((nrep, sweeps, 2), dtype=torch.int64, device=wa.device)
    with torch.cuda.device(wa.device):
        code = lib.ising2d_multisweep(
            wa.data_ptr(), wb.data_ptr(), wa_out.data_ptr(),
            wb_out.data_ptr(), seeds_dev.data_ptr(), obs.data_ptr(), nrep,
            nyp, half, sweeps, blocks, per, _table(q4, q8), _stream(wa))
    _raise_on(lib, code, "ising2d multisweep_kernel")
    LAUNCHES["multisweep"] += 1
    return wa_out, wb_out, obs


def _check_shard_planes(xw, ow, halos, bits) -> None:
    for p in (xw, ow, *bits):
        if p.shape != xw.shape or p.dtype != torch.int32:
            raise ValueError(f"planes must be int32 {tuple(xw.shape)}, got "
                             f"{p.dtype} {tuple(p.shape)}")
    for p in (xw, ow, *bits, *halos):
        if not p.is_cuda or p.device != xw.device:
            raise ValueError("planes and halos must lie on one CUDA device")
        if not p.is_contiguous() or p.dtype != torch.int32:
            raise ValueError("planes and halos must be contiguous int32")
    _check_indices(xw)


def sharded_phase_packed(xw, ow, hup01, hdn01, seeds, offs, *, color: int,
                         beta: float, halo_lf=None, halo_rt=None, b4=None,
                         b8=None, measuring: bool = False):
    """One packed colour phase of a (y[, x])-sharded (R, Lp, half) int32
    block: ``phase_kernel<true>`` on CUDA tensors,
    :func:`sharded_phase_packed_plain` on CPU tensors.  hup01/hdn01 (R, 1,
    half) are the other colour's boundary bits above and below the shard
    (0/1 int32), halo_lf/halo_rt (R, Lp, 1) its word columns left and
    right with an x split (offs then (rep0, wrow0, col0), else (rep0,
    wrow0)); ``b4``/``b8`` inject the Bernoulli planes.  Returns the new
    plane, and with ``measuring`` also the (R,) int64 (m, e) partials
    (JAX's ``sharded_phase_packed``, ``:783``)."""
    if _on_cpu(xw):
        return sharded_phase_packed_plain(
            xw, ow, hup01, hdn01, seeds, offs, color=color, beta=beta,
            halo_lf=halo_lf, halo_rt=halo_rt, b4=b4, b8=b8,
            measuring=measuring)
    nrep, nyp, half = xw.shape
    halos = [hup01, hdn01] + ([] if halo_lf is None else [halo_lf, halo_rt])
    bits = [] if b4 is None else [b4, b8]
    _check_shard_planes(xw, ow, halos, bits)
    if (hup01.shape != (nrep, 1, half) or hdn01.shape != hup01.shape
            or (halo_lf is not None
                and (halo_lf.shape != (nrep, nyp, 1)
                     or halo_rt.shape != (nrep, nyp, 1)))):
        raise ValueError("halos must be (R, 1, half) bit rows and (R, Lp, "
                         "1) word columns of the shard")
    rep0, wrow0, *rest = offsets(offs)
    col0 = rest[0] if rest else 0
    q4, q8 = (0, 0) if b4 is not None else chain_words(beta)
    s0, s1 = (0, 0) if seeds is None else (int(v) & MASK32 for v in seeds)
    out = torch.empty_like(xw)
    # zeroed: the kernel adds each block's sums with an atomic
    obs = (torch.zeros((nrep, 2), dtype=torch.int64, device=xw.device)
           if measuring else None)

    def ptr(t):
        return None if t is None else t.data_ptr()

    lib = _lib()
    with torch.cuda.device(xw.device):
        code = lib.ising2d_shard_phase(
            xw.data_ptr(), out.data_ptr(), ow.data_ptr(), hup01.data_ptr(),
            hdn01.data_ptr(), ptr(halo_lf), ptr(halo_rt), ptr(b4), ptr(b8),
            ptr(obs), nrep, nyp, half, color, rep0, wrow0, col0, s0, s1,
            _table(q4, q8), _stream(xw))
    _raise_on(lib, code, "ising2d phase_kernel<true>")
    LAUNCHES["shard_phase"] += 1
    if measuring:
        return out, obs[:, 0], obs[:, 1]
    return out


def _resident_grid() -> tuple[int, int]:
    """(resident blocks of the cooperative multisweep grid, SMs) on the
    current device."""
    lib = _lib()
    blocks, sms = _INT(0), _INT(0)
    _raise_on(lib, lib.ising2d_multisweep_grid(ctypes.byref(blocks),
                                               ctypes.byref(sms)),
              "ising2d_multisweep_grid")
    return blocks.value, sms.value


def multisweep_grid_blocks() -> int:
    """Blocks of the cooperative multisweep grid on the current device."""
    return _resident_grid()[0]


def multisweep_grid(tiles: int, resident: int, sms: int) -> tuple[int, int]:
    """(blocks, per): the multisweep's grid for ``tiles`` tiles of 8 x 32
    words a phase, block b taking tiles [b·per, (b + 1)·per), at most
    ``resident`` blocks on ``sms`` SMs.  The resident blocks spread
    evenly over the SMs, so a phase lasts as long as the busiest SM's
    ceil(blocks / sms)·per tiles: the least such per, from the fewest
    tiles a resident grid allows to twice that (2048^2 x 16: 4096 tiles,
    660 blocks resident on 132 SMs, gives 512 blocks of 8 tiles, 32 on
    the busiest SM, where 586 blocks of 7 give 35)."""
    if tiles < 1 or resident < 1 or sms < 1:
        raise ValueError(f"no multisweep grid for {tiles} tiles on "
                         f"{resident} resident blocks, {sms} SMs")
    p0 = -(-tiles // resident)

    def busiest(per):
        return -(-(-(-tiles // per)) // sms) * per

    per = min(range(p0, 2 * p0 + 1), key=lambda p: (busiest(p), p))
    return -(-tiles // per), per


# ---------------------------------------------------------------------------
# model-level entries (the JAX module's public functions)
# ---------------------------------------------------------------------------

def sweep_seed_pairs(key, sweeps: int, t0: int = 0) -> torch.Tensor:
    """(sweeps, 2, 2) uint32 per-(sweep, phase) Philox keys for global
    sweep indices t0+1 .. t0+sweeps of the sample keyed by ``key``: the
    derivation the streaming path applies one sweep at a time, so a
    multisweep reproduces it bitwise."""
    return multispin_rng.sweep_phase_keys(key, sweeps, t0)


def _densities(obs: torch.Tensor, nsites: int) -> dict[str, torch.Tensor]:
    return {"m": per_site(obs[..., 0], nsites),
            "e": per_site(obs[..., 1], nsites)}


def multisweep_packed(model, wa, wb, key, sweeps: int, t0: int = 0):
    """Advance ``sweeps`` MCS with per-sweep (m, e) densities (R, sweeps)
    float64.  ``key`` is the sample key and ``t0`` the global sweep index
    already completed."""
    wa, wb, obs = multisweep_planes(
        wa, wb, sweep_seed_pairs(key, sweeps, t0), beta=model.beta)
    return wa, wb, _densities(obs, model.nsites)


def _phase_seeds(key) -> torch.Tensor:
    """(2, 2) Philox keys of phases a and b of the sweep keyed by ``key``."""
    return rng.seeds_from_key(key, torch.arange(2, dtype=torch.int64))


def sweep_measure_packed(model, wa, wb, key):
    """One MCS under the sweep key ``key`` with the fused (m, e)
    densities (R,) float64 from phase b."""
    return sweep_measure_seeded(model, wa, wb, _phase_seeds(key))


def sweep_measure_seeded(model, wa, wb, seeds):
    """:func:`sweep_measure_packed` given the sweep's (2, 2) phase keys
    (a row of :func:`sweep_seed_pairs`), so that a runner derives the
    keys of a whole chunk in one call."""
    wa = phase_packed(wa, wb, seeds[0], color=0, beta=model.beta)
    wb, obs = phase_packed(wb, wa, seeds[1], color=1, beta=model.beta,
                           measuring=True)
    return wa, wb, _densities(obs, model.nsites)


def sweep_packed(model, wa, wb, key):
    """One full MCS on packed colour planes (R, ny//32, half) int32."""
    seeds = _phase_seeds(key)
    wa = phase_packed(wa, wb, seeds[0], color=0, beta=model.beta)
    wb = phase_packed(wb, wa, seeds[1], color=1, beta=model.beta)
    return wa, wb


def pack_state(state: CheckerboardState):
    a, b = state
    batched = a.dim() == 3
    if not batched:
        a, b = a[None], b[None]
    return pack_color(a), pack_color(b), batched


def unpack_state(wa, wb, batched: bool) -> CheckerboardState:
    a, b = unpack_color(wa), unpack_color(wb)
    if not batched:
        a, b = a[0], b[0]
    return CheckerboardState(a, b)
