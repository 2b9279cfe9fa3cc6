"""Bit-packed multispin Metropolis for the helical (odd-nx) Ising geometry.

Port of ``cuda_fortran_mc_simulation_spin_tpu/ops/helical_multispin.py``.
With odd nx the flat helical lattice two-colours by index parity, and
splitting it gives dense colour vectors a[j] = s[2j], b[j] = s[2j+1] of
length M = nall/2 whose neighbour maps are four constant offsets:

    a[j] reads b[(j + d) mod M],  d ∈ {0, -1, +h, -(h+1)}
    b[j] reads a[(j + d) mod M],  d ∈ {0, +1, +(h+1), -h}

with h = (nx-1)/2.  32 consecutive colour indices share an int32 word:
the port's layout is flat (R, W) words, W = ceil(M/32), bit k of word g =
colour index 32g + k.  (The JAX package stores the same words in a
(rows, 128) grid with rows a multiple of 8, a TPU tiling; flat word g is
the same word in both, see interop.py.)  A neighbour plane is one modular
bit shift (:func:`shift_mod`); the pad bits [M, 32W) of the last word are
never a source for a valid site, so they may hold garbage after a flip,
and the fused measurement masks them.  Acceptance reuses the 4:3 counter
and Bernoulli chains of ops/ising2d_multispin.py.

The CUDA kernel is ``multisweep_kernel`` in ``csrc/helical_multispin.cu``:
S sweeps on resident colour vectors with the exact (m, e) of every sweep,
and, as a mode, one phase with injected Bernoulli planes.  Beside it is
its plain PyTorch version in this module, with the same Philox words
(ops/multispin_rng.py, counter (replica, word, 0, draw/4)) and the same
algebra; the kernel draws the B4 and B8 chains in one unrolled line that
follows the launch's table (``multispin_rng.chain_table((q4, q8, 0))``,
the periodic 2-D kernels' table), the plain version chain by chain
(``_bern_plane``), and ``tests/test_torch_helical_chains.py`` holds the
two equal on the CPU.  A wrapper takes the plain version for a CPU
tensor; for a CUDA tensor it launches the kernel or raises.  ``LAUNCHES``
counts launches.
"""

from __future__ import annotations

import ctypes

import torch

from cuda_fortran_mc_simulation_spin_tpu_torch.ops import _build, multispin_rng
from cuda_fortran_mc_simulation_spin_tpu_torch.ops.ising2d_multispin import (
    _TABLE,
    MASK32,
    PACK,
    _bern_plane,
    _count_planes,
    _digits,
    _flip_plane,
    _i32,
    _on_cpu,
    _pc_plane,
    _stream,
    _table,
    _u32,
    chain_words,
    per_site,
    sweep_seed_pairs,
)
from cuda_fortran_mc_simulation_spin_tpu_torch.ops.multispin_rng import keys_to

# largest colour vector served, in words: the JAX package's bound (1024
# rows of 128 words), so the port admits every helical lattice it admits
MAX_WORDS = 1024 * 128

LAUNCHES = {"multisweep": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def words(m: int) -> int:
    """Words of a colour vector of m sites."""
    return -(-m // PACK)


def helical_offsets(nx: int) -> tuple[tuple[int, ...], tuple[int, ...]]:
    """(offsets for colour a, offsets for colour b), h = (nx-1)//2."""
    h = (nx - 1) // 2
    return (0, -1, h, -(h + 1)), (0, 1, h + 1, -h)


def fits(model) -> bool:
    """The helical multispin kernel serves ``model``: odd nx, even nsites,
    and a colour vector of at most MAX_WORDS words (2 x 512 KiB a
    replica)."""
    m = model.nsites // 2
    return (model.nx % 2 == 1 and model.nsites % 2 == 0
            and 1 <= words(m) <= MAX_WORDS)


def split_flat(flat: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., nall) spins -> (a, b) even/odd colour vectors."""
    return flat[..., 0::2], flat[..., 1::2]


def merge_flat(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.stack([a, b], dim=-1).reshape(a.shape[:-1] + (-1,))


def pack_flat(flat: torch.Tensor, m: int) -> torch.Tensor:
    """(..., m) ±1 int8 colour vector -> (..., W) int32 words with bit k
    of word g = (site 32g + k) > 0; pad bits zero."""
    w = words(m)
    bits = (flat > 0).to(torch.int64)
    bits = torch.nn.functional.pad(bits, (0, w * PACK - m))
    bits = bits.reshape(flat.shape[:-1] + (w, PACK))
    weights = torch.tensor([1 << k for k in range(PACK)], dtype=torch.int64,
                           device=flat.device)
    return _i32((bits * weights).sum(dim=-1))


def unpack_flat(w: torch.Tensor, m: int) -> torch.Tensor:
    """Inverse of :func:`pack_flat` (to ±1 int8, pad dropped)."""
    k = torch.arange(PACK, dtype=torch.int64, device=w.device)
    bits = (_u32(w).unsqueeze(-1) >> k) & 1
    flat = bits.reshape(w.shape[:-1] + (-1,))[..., :m]
    return (flat * 2 - 1).to(torch.int8)


def valid_mask(m: int, device=None) -> torch.Tensor:
    """(W,) uint32 (in int64) mask of the bits of each word that hold a
    site; the pad bits of the last word are 0."""
    g = torch.arange(words(m), dtype=torch.int64, device=device)
    nbits = torch.clamp(m - g * PACK, 0, PACK)
    return torch.where(nbits == PACK, MASK32, (1 << nbits) - 1)


def _read_lin(u: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """32 bits of the word sequence ``u`` (..., W) from bit ``pos`` (W,)
    on; bits past the last word read as 0."""
    nw = u.shape[-1]
    i, sh = pos >> 5, pos & 31
    lo = u[..., i]
    hi = torch.where(i + 1 < nw, u[..., torch.clamp(i + 1, max=nw - 1)], 0)
    return (lo >> sh) | ((hi << (PACK - sh)) & MASK32)


def shift_mod(w: torch.Tensor, d: int, m: int) -> torch.Tensor:
    """Modular bit shift of colour vectors (..., W): out bit f = in bit
    (f + d) mod m for every site f < m (pad bits of the result are
    unspecified).  Word g reads the 32 bits from (32g + d) mod m on, and
    where they run past bit m - 1 it continues at bit 0."""
    u = _u32(w)
    d %= m
    g = torch.arange(u.shape[-1], dtype=torch.int64, device=u.device)
    start = (g * PACK + d) % m
    n = torch.clamp(m - start, max=PACK)        # bits before the wrap
    out = _read_lin(u, start) & ((1 << n) - 1)
    got = n
    head = _read_lin(u, torch.zeros_like(start))
    while bool((got < PACK).any()):
        take = torch.clamp(PACK - got, max=m)
        piece = (head & ((1 << take) - 1)) << got
        out = out | torch.where(got < PACK, piece & MASK32, 0)
        got = torch.where(got < PACK, got + take, got)
    return _i32(out)


def _counts(o: torch.Tensor, offs, m: int):
    """(ones, twos, fours) of the neighbours at ``offs`` in the other
    colour ``o`` (uint32 in int64)."""
    n1, n2, n3, n4 = (_u32(shift_mod(o, d, m)) for d in offs)
    return _count_planes(n1, n2, n3, n4)


def packed_helical_phase_reference(xw, ow, offs, b4, b8, m: int):
    """Plain packed phase on (..., W) words with given Bernoulli planes:
    the plain version of the kernel's injected-bits mode."""
    x = _u32(xw)
    ones, twos, fours = _counts(_u32(ow), offs, m)
    return _i32(x ^ _flip_plane(x, ones, twos, fours, _u32(b4), _u32(b8)))


def flat_phase_reference(x_flat, o_flat, offs, b4u, b8u):
    """Unpacked flat oracle: the helical Metropolis decision on ±1 colour
    vectors given boolean Bernoulli planes."""
    o32 = o_flat.to(torch.int32)
    nsum = sum(torch.roll(o32, -d, dims=-1) for d in offs)
    half_de = x_flat.to(torch.int32) * nsum
    accept = (half_de <= 0) | torch.where(half_de == 2, b4u, b8u)
    return torch.where(accept, -x_flat, x_flat)


def _obs_sums(new, o, ones, twos, fours, m: int) -> torch.Tensor:
    """(R, 2) int64 exact (m, e) of the whole lattice from phase b, pad
    bits masked: each a-b bond has one odd end, so e = -Σ_b s_b·(2c-4)
    covers every bond once."""
    vm = valid_mask(m, new.device)

    def pc(u):
        return _pc_plane(u & vm).sum(dim=-1)

    s_x = pc(new)
    s_c = pc(ones) + 2 * pc(twos) + 4 * pc(fours)
    s_xc = pc(new & ones) + 2 * pc(new & twos) + 4 * pc(new & fours)
    mm = 2 * (s_x + pc(o)) - 2 * m
    e = -(4 * s_xc - 8 * s_x - 2 * s_c + 4 * m)
    return torch.stack([mm, e], dim=-1)


def _phase_plain(xw, ow, seeds, offs, m: int, q4: int, q8: int,
                 measuring: bool):
    nrep, nw = xw.shape
    x, o = _u32(xw), _u32(ow)
    ones, twos, fours = _counts(o, offs, m)
    stream = multispin_rng.word_stream(seeds, nrep, nw, 1, xw.device)

    def gen():
        return stream().reshape(nrep, nw)

    b4 = _bern_plane(x.shape, _digits(q4), gen, xw.device)
    b8 = _bern_plane(x.shape, _digits(q8), gen, xw.device)
    new = x ^ _flip_plane(x, ones, twos, fours, b4, b8)
    if not measuring:
        return _i32(new)
    return _i32(new), _obs_sums(new, o, ones, twos, fours, m)


def multisweep_plain(wa, wb, seeds, *, beta: float, nx: int, m: int):
    """Plain version of ``multisweep_kernel``: S = len(seeds) sweeps on
    (R, W) colour vectors under the (S, 2, 2) per-(sweep, phase) Philox
    keys; returns (wa, wb, obs) with obs the (R, S, 2) int64 (m, e)."""
    offs_a, offs_b = helical_offsets(nx)
    q4, q8 = chain_words(beta)
    obs = []
    for s in range(seeds.shape[0]):
        wa = _phase_plain(wa, wb, seeds[s, 0], offs_a, m, q4, q8, False)
        wb, o = _phase_plain(wb, wa, seeds[s, 1], offs_b, m, q4, q8, True)
        obs.append(o)
    return wa, wb, torch.stack(obs, dim=1)


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

_VOID = ctypes.c_void_p
_INT = ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = _build.load("helical_multispin")
    if lib.helical_multisweep.argtypes is not None:
        return lib
    lib.helical_multisweep.argtypes = [
        _VOID, _VOID, _VOID, _VOID, _VOID, _VOID, _VOID, _VOID,
        _INT, _INT, _INT, _INT, _INT, _INT,
        _INT, _INT, _INT, _INT, _INT, _INT, _INT, _INT,
        _TABLE, _VOID]
    lib.helical_multisweep.restype = _INT
    lib.helical_smem_optin.argtypes = [ctypes.POINTER(_INT)]
    lib.helical_smem_optin.restype = _INT
    lib.helical_error_string.argtypes = [_INT]
    lib.helical_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(lib, code: int, what: str) -> None:
    if code != 0:
        msg = lib.helical_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def _check_vectors(m: int, *vecs: torch.Tensor,
                   max_words: int = MAX_WORDS) -> None:
    """The kernel takes int32 contiguous (R, W) colour vectors on one CUDA
    device, W = ceil(m/32) <= ``max_words``."""
    ref = vecs[0]
    if ref.dim() != 2:
        raise ValueError(f"colour vectors must be (R, W), got {ref.shape}")
    if ref.shape[1] != words(m) or not 1 <= ref.shape[1] <= max_words:
        raise ValueError(f"colour vectors of {m} sites need W = {words(m)} "
                         f"<= {max_words} words, got {tuple(ref.shape)}")
    for v in vecs:
        if v.shape != ref.shape or v.dtype != torch.int32:
            raise ValueError(f"colour vectors must be int32 "
                             f"{tuple(ref.shape)}, got {v.dtype} "
                             f"{tuple(v.shape)}")
        if v.device != ref.device or not v.is_cuda:
            raise ValueError("colour vectors must lie on one CUDA device")
        if not v.is_contiguous():
            raise ValueError("colour vectors must be contiguous")


_SMEM_OPTIN: dict[int, int] = {}


def staged_fits(nw: int, device) -> bool:
    """Both colour vectors of a replica fit the block's shared memory,
    so the kernel stages them there; else it works in device memory."""
    dev = torch.device(device).index
    if dev is None:
        dev = torch.cuda.current_device()
    if dev not in _SMEM_OPTIN:
        lib = _lib()
        val = _INT(0)
        with torch.cuda.device(dev):
            _raise_on(lib, lib.helical_smem_optin(ctypes.byref(val)),
                      "helical_smem_optin")
        _SMEM_OPTIN[dev] = val.value
    return 2 * nw * 4 <= _SMEM_OPTIN[dev]


def _launch(wa, wb, m: int, offs_a, offs_b, *, seeds=None, b4=None,
            b8=None, q4=0, q8=0):
    """One launch: S = len(seeds) full sweeps with Philox words and the
    chains of digits (q4, q8), or (with b4/b8) one phase of ``wa`` given
    ``wb`` with injected planes; staged in shared memory where
    :func:`staged_fits`."""
    bits = b4 is not None
    _check_vectors(m, wa, wb, *((b4, b8) if bits else ()))
    lib = _lib()
    nrep, nw = wa.shape
    staged = staged_fits(nw, wa.device)
    sweeps = 1 if bits else int(seeds.shape[0])
    seeds_dev = None if bits else keys_to(seeds, wa.device)
    wa_out, wb_out = torch.empty_like(wa), torch.empty_like(wb)
    obs = None if bits else torch.empty((nrep, sweeps, 2), dtype=torch.int64,
                                        device=wa.device)
    da = [d % m for d in offs_a]
    db = [d % m for d in offs_b]
    with torch.cuda.device(wa.device):
        code = lib.helical_multisweep(
            wa.data_ptr(), wb.data_ptr(), wa_out.data_ptr(),
            wb_out.data_ptr(),
            None if bits else seeds_dev.data_ptr(),
            b4.data_ptr() if bits else None,
            b8.data_ptr() if bits else None,
            None if bits else obs.data_ptr(),
            nrep, nw, m, sweeps, int(bits), int(staged),
            *da, *db, _table(q4, q8), _stream(wa))
    _raise_on(lib, code, "helical multisweep_kernel")
    LAUNCHES["multisweep"] += 1
    return wa_out, wb_out, obs


def phase_packed_with_bits(xw, ow, b4, b8, *, offs, m: int) -> torch.Tensor:
    """One packed phase of (R, W) colour vectors with injected Bernoulli
    planes, the colour ``xw`` reading ``ow`` at ``offs``: the injected-bits
    mode of ``multisweep_kernel`` on CUDA tensors,
    :func:`packed_helical_phase_reference` on CPU tensors."""
    if _on_cpu(xw):
        return packed_helical_phase_reference(xw, ow, offs, b4, b8, m)
    return _launch(xw, ow, m, offs, offs, b4=b4, b8=b8)[0]


def multisweep_planes(wa, wb, seeds, *, beta: float, nx: int, m: int):
    """S = len(seeds) helical sweeps under the (S, 2, 2) keys:
    ``multisweep_kernel`` (one launch) on CUDA tensors,
    :func:`multisweep_plain` on CPU tensors.  Returns (wa, wb, obs) with
    obs the (R, S, 2) int64 (m, e) of every sweep."""
    if _on_cpu(wa):
        return multisweep_plain(wa, wb, seeds, beta=beta, nx=nx, m=m)
    q4, q8 = chain_words(beta)
    offs_a, offs_b = helical_offsets(nx)
    return _launch(wa, wb, m, offs_a, offs_b, seeds=seeds, q4=q4, q8=q8)


# ---------------------------------------------------------------------------
# model-level entries
# ---------------------------------------------------------------------------

def multisweep(model, wa, wb, key, sweeps: int, t0: int = 0):
    """Advance ``sweeps`` helical MCS on packed colour vectors (R, W)
    with per-sweep (m, e) densities (R, sweeps) float64.  ``key`` is the
    sample key and ``t0`` the global sweep index already completed, so
    the trajectory does not depend on how a run is chunked."""
    wa, wb, obs = multisweep_planes(
        wa, wb, sweep_seed_pairs(key, sweeps, t0), beta=model.beta,
        nx=model.nx, m=model.nsites // 2)
    return wa, wb, {"m": per_site(obs[..., 0], model.nsites),
                    "e": per_site(obs[..., 1], model.nsites)}

