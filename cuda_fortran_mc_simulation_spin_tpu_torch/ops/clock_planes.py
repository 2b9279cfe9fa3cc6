"""Shared scaffolding of the bit-sliced packed clock engines (q = 6, 4, 3).

Port of the single-device half of
``cuda_fortran_mc_simulation_spin_tpu/ops/clock_planes.py``.  A clock
state is a tuple of ``n_state`` bit planes per checkerboard colour (3 for
q=6, 2 for q=4 and q=3), each packed 32 sites a word along y exactly as
the Ising engine packs spins (ops/ising2d_multispin.py): bit k of word row
Y is lattice row 32Y + k.  Only the bond algebra differs between the q's;
each q-module (ops/clock_multispin.py, clock4_multispin.py,
clock3_multispin.py) supplies a :class:`PlaneSpec` with its proposal
draw, packed Metropolis decision, fused observables and pack/unpack.

Layout.  The port keeps (R, nyw, half) int32 planes, nyw = ceil(ny/32),
for every even shape: aligned (ny % 32 == 0, nb = 0) or not (nb = ny % 32
real bits in the top word, whose pad bits are kept 0).  The JAX package
pads non-aligned shapes to (nyp, halfp), a multiple of (8, 128), and
rewrites the pad positions a phase reads (``_refresh_plane``); here the
periodic wrap is built per word from the real words instead, the same
words ``_refresh_plane`` writes:

- the top word's centre gets rows 0.. in its pad bits,
  ``(o[top] & low) | (o[0] << nb)``, so its in-word shift reads the wrap
  neighbour of row ny - 1;
- word row 0 reads bit 31 of ``o[top] << (32 - nb)``, row ny - 1, as its
  modular ``w_prev``;
- x wraps at ``half`` (no lane padding).

So the real sites equal the JAX padded engine's bitwise (given the same
random planes) with no refresh pass.  A phase clears the pad bits of its
output and the fused observables count real sites only.

Kernel.  ``csrc/clock_planes.cu`` ``phase_kernel<Q>`` replaces
``clock_planes.py:_phase_kernel`` (pallas_call at :313, ``phase_packed``)
for all three q: one colour phase, random planes from Philox words (key =
the (sample, t, phase) key, counter = (replica, word row, column,
draw/4), ops/multispin_rng.py; drawn in one unrolled line that follows
the launch's :func:`draw_table`) or injected, and with ``measuring`` the
exact per-replica (2m, 2e) sums (m, e for q=4) in int64.  Beside it is
the plain PyTorch version, :func:`phase_plain` (Philox) and
:func:`phase_reference` (injected).  A wrapper takes the plain version
for a CPU tensor; for a CUDA tensor it launches the kernel or raises.
``LAUNCHES`` counts launches.

``phase_kernel<Q, true>``, the halo mode of ``phase_kernel<Q>``, replaces
``clock_planes.py:_sharded_phase_kernel`` (pallas_call at :875,
:func:`sharded_phase_packed`, reached in JAX as
``clock_multispin.sharded_phase_packed6``, ``clock4_multispin.
sharded_phase_packed4`` and ``clock3_multispin.sharded_phase_packed3``):
the phase on a shard of a (y[, x]) mesh (parallel/domain.py), the bit rows
past its edges from the exchanged 0/1 halo planes (one a state plane) and,
with an x split, the word columns past its edges from the exchanged word
columns; Philox words at the shard's global (replica, word row, column),
so a shard draws the unsharded lattice's words.  Its plain version is
:func:`sharded_phase_packed_plain`.

Plain versions hold uint32 words in int64 tensors (``_u32``): NOT is
``x ^ MASK32`` (:func:`_not`) and a left shift is masked.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, NamedTuple

import numpy as np
import torch

from cuda_fortran_mc_simulation_spin_tpu_torch.ops import _build, multispin_rng
from cuda_fortran_mc_simulation_spin_tpu_torch.ops.ising2d_multispin import (
    _EVEN_BITS,
    _ODD_BITS,
    MASK32,
    PACK,
    _i32,
    _on_cpu,
    _pc_plane,
    _phase_seeds,
    _stream,
    _u32,
    chain_digits,
    digits_int,
    offsets,
    packable,
)

LAUNCHES = {"phase": 0, "phase_measuring": 0, "shard_phase": 0}

# most chains a spec draws (q=6: p1, p2, p4, p8, p8)
MAX_CHAINS = 5


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


class PlaneSpec(NamedTuple):
    """The q-specific pieces of a packed clock engine.

    ``decide(xs, nbrs, rand) -> (new, fin)``: packed Metropolis decision
    of one phase: ``xs`` the centre-colour state planes, ``nbrs`` per
    state plane the 4-tuple (up, dn, ctr, side) of neighbour planes of
    the other colour, ``rand`` the n_rand random planes; returns the new
    planes and the final-value bond planes ``fin`` that
    ``obs_partial(new, oth, fin, mask) -> (m, e)`` reduces to the (R,)
    int64 sums (scaled by ``obs_scale / nsites`` to densities).
    ``draw(gen, digits)`` produces the n_rand planes from fresh
    ``gen()`` words; ``digits = accept_digits(beta)``.
    ``obs_masked(wa, wb, ny)`` computes the same sums from a final
    state (the JAX package's ``obs_packed*_masked``)."""

    name: str
    q: int
    n_state: int
    n_rand: int
    max_sites: int
    obs_scale: float
    accept_digits: Callable
    draw: Callable
    decide: Callable
    obs_partial: Callable
    obs_masked: Callable
    pack_color: Callable
    unpack_color: Callable


# ---------------------------------------------------------------------------
# bit-sliced word-plane helpers shared by every bond algebra
# ---------------------------------------------------------------------------

def _not(a):
    return a ^ MASK32


def _ha(a, b):
    return a ^ b, a & b


def _fa(a, b, c):
    t = a ^ b
    return t ^ c, (a & b) | (c & t)


def _lt_multi(planes, thresholds, bits):
    """[u < T] for each constant T over ONE shared uniform whose binary
    digits (MSB first) are ``planes``: the LSB->MSB lt-recurrence."""
    outs = []
    for t_val in thresholds:
        digs = [(t_val >> (bits - 1 - j)) & 1 for j in range(bits)]
        lt = torch.zeros_like(planes[0])
        for j in range(bits - 1, -1, -1):
            nr = _not(planes[j])
            lt = (nr | lt) if digs[j] else (nr & lt)
        outs.append(lt)
    return outs


def _chain_len(p: float) -> int:
    """Digits for a Bernoulli chain: ~12 significant bits below the
    leading zeros of p."""
    if p <= 0.0:
        return 28
    return int(min(28, max(6, np.ceil(-np.log2(min(p, 1.0))) + 12)))


def chain_digits_of(p: float) -> tuple[int, ...]:
    """Digits of the clock chain of probability p: ``_chain_len(p)`` of
    them (ops/ising2d_multispin.chain_digits)."""
    return tuple(chain_digits(p, _chain_len(p)))


def chain_words(digits) -> tuple[list[int], list[int]]:
    """([q], [k]) per chain: the integers round(p·2^k) and digit counts
    that the CUDA kernels take, padded with zero chains to MAX_CHAINS."""
    qs = [digits_int(d) for d in digits]
    ks = [len(d) for d in digits]
    pad = MAX_CHAINS - len(qs)
    return qs + [0] * pad, ks + [1] * pad


def proposal_words(q: int) -> int:
    """Random words a word's proposal draws before its chains: the 12-bit
    thermometer for q = 6 and 4, one word for q = 3."""
    return 1 if q == 3 else 12


def draw_table(spec: "PlaneSpec", beta: float) -> tuple[int, ...]:
    """The kernel's draw table of ``spec`` at ``beta``: the proposal words
    and the chains of ``spec.accept_digits(beta)``
    (``multispin_rng.clock_draw_table``, 167 words)."""
    qs, ks = chain_words(spec.accept_digits(beta))
    return multispin_rng.clock_draw_table(proposal_words(spec.q), tuple(qs),
                                          tuple(ks))


@functools.lru_cache(maxsize=64)
def _table_arg(spec: "PlaneSpec", beta: float):
    """:func:`draw_table` as the kernels' ctypes argument, built once (a
    streamed run launches twice a sweep)."""
    table = draw_table(spec, beta)
    return (_UINT * len(table))(*table)


def _pc(u, dims=(-2, -1)):
    """Per-replica set-bit count of uint32 words (int64 tensors)."""
    return _pc_plane(u).sum(dim=dims)


# ---------------------------------------------------------------------------
# layout: pack / unpack, the real-site mask, the wrapped neighbours
# ---------------------------------------------------------------------------

def words_rows(ny: int) -> tuple[int, int]:
    """(nyw, nb): word rows of a colour array of ny rows, and the real
    bits of its top word (0: all 32)."""
    return -(-ny // PACK), ny % PACK


def _packbits(bits: torch.Tensor) -> torch.Tensor:
    """(..., ny, half) 0/1 -> (..., nyw, half) int32 words, the pad rows
    of the top word 0."""
    ny, half = bits.shape[-2:]
    nyw, _ = words_rows(ny)
    b = bits.to(torch.int64)
    if nyw * PACK != ny:
        b = torch.nn.functional.pad(b, (0, 0, 0, nyw * PACK - ny))
    b = b.reshape(bits.shape[:-2] + (nyw, PACK, half))
    weights = torch.tensor([1 << k for k in range(PACK)], dtype=torch.int64,
                           device=bits.device).view(PACK, 1)
    return _i32((b * weights).sum(dim=-2))


def _unpackbits(w: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`_packbits` (to 0/1 int64, all 32·nyw rows)."""
    k = torch.arange(PACK, dtype=torch.int64, device=w.device).view(PACK, 1)
    bits = (_u32(w).unsqueeze(-2) >> k) & 1          # (..., nyw, 32, half)
    return bits.reshape(w.shape[:-2] + (w.shape[-2] * PACK, w.shape[-1]))


def real_mask(nyw: int, half: int, nb: int, device=None) -> torch.Tensor:
    """(nyw, half) uint32 (in int64) plane with the real-site bits set."""
    m = torch.full((nyw, half), MASK32, dtype=torch.int64, device=device)
    if nb:
        m[nyw - 1] = (1 << nb) - 1
    return m


def nbr_planes(o: torch.Tensor, color: int, nb: int = 0):
    """(up, dn, ctr, side) neighbour planes of the other colour's packed
    plane ``o`` ((..., nyw, half) uint32 in int64), periodic in y over
    the 32·(nyw-1) + nb real rows (nb = 0: all 32 of the top word) and in
    x over ``half``.  With nb = 0 this is the JAX ``_nbr_planes_jnp``."""
    nyw = o.shape[-2]
    if nb:
        low = (1 << nb) - 1
        top = (o[..., -1, :] & low) | ((o[..., 0, :] << nb) & MASK32)
        c = torch.cat([o[..., :-1, :], top.unsqueeze(-2)], dim=-2)
        wrap = (o[..., -1:, :] << (PACK - nb)) & MASK32
        w_prev = torch.cat([wrap, o[..., :nyw - 1, :]], dim=-2)
    else:
        c = o
        w_prev = torch.roll(o, 1, dims=-2)
    w_next = torch.roll(o, -1, dims=-2)
    up = ((c << 1) & MASK32) | (w_prev >> 31)
    dn = (c >> 1) | ((w_next << 31) & MASK32)
    minus = torch.roll(o, 1, dims=-1)
    plus = torch.roll(o, -1, dims=-1)
    if color == 0:
        side = (plus & _ODD_BITS) | (minus & _EVEN_BITS)
    else:
        side = (minus & _ODD_BITS) | (plus & _EVEN_BITS)
    return up, dn, c, side


# ---------------------------------------------------------------------------
# plain phase (the kernel's plain version)
# ---------------------------------------------------------------------------

def _geometry(planes, ny: int | None):
    nyw, half = planes[0].shape[-2:]
    if ny is None:
        ny = nyw * PACK
    if words_rows(ny)[0] != nyw:
        raise ValueError(f"{ny} rows need {words_rows(ny)[0]} word rows, "
                         f"planes have {nyw}")
    return nyw, half, ny % PACK


def _decide_plain(spec: PlaneSpec, xplanes, oplanes, color: int, rand,
                  ny: int | None):
    nyw, half, nb = _geometry(xplanes, ny)
    xs = tuple(_u32(p) for p in xplanes)
    os_ = tuple(_u32(p) for p in oplanes)
    nbrs = tuple(nbr_planes(o, color, nb) for o in os_)
    new, fin = spec.decide(xs, nbrs, tuple(_u32(p) for p in rand))
    mask = real_mask(nyw, half, nb, xs[0].device)
    return tuple(p & mask for p in new), os_, fin, mask


def phase_reference(spec: PlaneSpec, xplanes, oplanes, color: int, rand,
                    ny: int | None = None, measuring: bool = False):
    """Plain packed phase of (..., nyw, half) plane tuples with the given
    random planes: the plain version of the kernel's injected mode.
    ``ny`` (default 32·nyw) sets the real rows; pad bits come out 0.
    With ``measuring`` also the (..., 2) int64 sums over the real sites."""
    new, os_, fin, mask = _decide_plain(spec, xplanes, oplanes, color, rand,
                                        ny)
    out = tuple(_i32(p) for p in new)
    if not measuring:
        return out
    return out, torch.stack(spec.obs_partial(new, os_, fin, mask), dim=-1)


def draw_planes_plain(spec: PlaneSpec, seeds, nrep: int, nyw: int,
                      half: int, beta: float, device=None):
    """The n_rand random planes (uint32 in int64, (nrep, nyw, half)) a
    phase under the Philox key ``seeds`` draws: what :func:`phase_plain`
    and the kernel use, for feeding an injected-planes oracle."""
    gen = multispin_rng.word_stream(seeds, nrep, nyw, half, device)
    return spec.draw(gen, spec.accept_digits(beta))


def phase_plain(spec: PlaneSpec, xplanes, oplanes, seeds, *, color: int,
                beta: float, ny: int | None = None, measuring: bool = False):
    """Plain version of ``phase_kernel`` with Philox words: one colour
    phase of (R, nyw, half) int32 plane tuples under the phase key
    ``seeds``.  Returns the new planes, and with ``measuring`` also the
    (R, 2) int64 sums (2m, 2e) (q=4: (m, e)) over the real sites."""
    nrep, nyw, half = xplanes[0].shape
    rand = draw_planes_plain(spec, seeds, nrep, nyw, half, beta,
                             xplanes[0].device)
    new, os_, fin, mask = _decide_plain(spec, xplanes, oplanes, color, rand,
                                        ny)
    out = tuple(_i32(p) for p in new)
    if not measuring:
        return out
    m, e = spec.obs_partial(new, os_, fin, mask)
    return out, torch.stack([m, e], dim=-1)


# ---------------------------------------------------------------------------
# CUDA wrapper
# ---------------------------------------------------------------------------

_VOID = ctypes.c_void_p
_INT = ctypes.c_int
_UINT = ctypes.c_uint


def _lib() -> ctypes.CDLL:
    lib = _build.load("clock_planes")
    if lib.clock_phase.argtypes is not None:
        return lib
    lib.clock_phase.argtypes = (
        [_INT] + [_VOID] * 9 + [_VOID, _VOID]
        + [_INT] * 6 + [_UINT, _UINT, _VOID, _VOID])
    lib.clock_phase.restype = _INT
    lib.clock_halo_phase.argtypes = (
        [_INT, _VOID, _VOID, _VOID] + [_INT] * 8 + [_UINT, _UINT, _VOID,
                                                    _VOID])
    lib.clock_halo_phase.restype = _INT
    lib.clock_error_string.argtypes = [_INT]
    lib.clock_error_string.restype = ctypes.c_char_p
    return lib


def _check_planes(*planes: torch.Tensor) -> None:
    """The kernel takes int32 contiguous (R, nyw, half) planes on one
    CUDA device."""
    ref = planes[0]
    if ref.dim() != 3:
        raise ValueError(f"planes must be (R, nyw, half), got {ref.shape}")
    for p in planes:
        if p.shape != ref.shape or p.dtype != torch.int32:
            raise ValueError(f"planes must be int32 {tuple(ref.shape)}, "
                             f"got {p.dtype} {tuple(p.shape)}")
        if p.device != ref.device or not p.is_cuda:
            raise ValueError("planes must lie on one CUDA device")
        if not p.is_contiguous():
            raise ValueError("planes must be contiguous")


def _random_args(spec: PlaneSpec, xplanes, oplanes, seeds, beta: float,
                 inject):
    """(stacked injected planes or None, the draw table or None, s0, s1) of
    a launch, after checking its planes: the injected mode, or Philox words
    under ``seeds`` with the draw table of ``beta``."""
    if inject is None:
        _check_planes(*xplanes, *oplanes)
        s0, s1 = (int(v) & MASK32 for v in torch.as_tensor(seeds).tolist())
        return None, _table_arg(spec, float(beta)), s0, s1
    if len(inject) != spec.n_rand:
        raise ValueError(f"{spec.name} injects {spec.n_rand} planes")
    inj = torch.stack([_i32(p) if p.dtype != torch.int32 else p
                       for p in inject]).contiguous()
    _check_planes(*xplanes, *oplanes, *inj)
    return inj, None, 0, 0


def _launch(spec: PlaneSpec, xplanes, oplanes, color: int, ny: int | None,
            seeds=None, beta: float = 1.0, inject=None,
            measuring: bool = False):
    nrep, nyw, half = xplanes[0].shape
    _, _, nb = _geometry(xplanes, ny)
    if nyw < 2 or half < 2:
        raise ValueError(f"kernel needs nyw >= 2 and half >= 2, got "
                         f"{tuple(xplanes[0].shape)}")
    inj, table, s0, s1 = _random_args(spec, xplanes, oplanes, seeds, beta,
                                      inject)
    lib = _lib()
    outs = [torch.empty_like(p) for p in xplanes]
    pad3 = [None] * (3 - spec.n_state)
    # zeroed: the kernel adds each block's sums with an atomic
    obs = (torch.zeros((nrep, 2), dtype=torch.int64, device=xplanes[0].device)
           if measuring else None)
    with torch.cuda.device(xplanes[0].device):
        code = lib.clock_phase(
            spec.q,
            *[p.data_ptr() for p in xplanes], *pad3,
            *[p.data_ptr() for p in outs], *pad3,
            *[p.data_ptr() for p in oplanes], *pad3,
            None if inj is None else inj.data_ptr(),
            None if obs is None else obs.data_ptr(),
            nrep, nyw, half, nb, color, int(inj is not None), s0, s1,
            table, _stream(xplanes[0]))
    if code != 0:
        msg = lib.clock_error_string(code).decode()
        raise RuntimeError(f"clock phase_kernel: CUDA error {code} ({msg})")
    LAUNCHES["phase"] += 1
    if measuring:
        LAUNCHES["phase_measuring"] += 1
        return tuple(outs), obs
    return tuple(outs)


def phase_packed(spec: PlaneSpec, xplanes, oplanes, seeds, *, color: int,
                 beta: float, ny: int | None = None,
                 measuring: bool = False):
    """One colour phase of (R, nyw, half) int32 plane tuples with Philox
    words under ``seeds``: ``phase_kernel`` on CUDA tensors,
    :func:`phase_plain` on CPU tensors.  Returns the new planes, and with
    ``measuring`` also the (R, 2) int64 sums over the real sites."""
    if _on_cpu(xplanes[0]):
        return phase_plain(spec, xplanes, oplanes, seeds, color=color,
                           beta=beta, ny=ny, measuring=measuring)
    return _launch(spec, xplanes, oplanes, color, ny, seeds=seeds,
                   beta=beta, measuring=measuring)


def phase_packed_inject(spec: PlaneSpec, xplanes, oplanes, rand, *,
                        color: int, ny: int | None = None,
                        measuring: bool = False):
    """One phase with injected random planes: the bitwise-testable mode
    of ``phase_kernel`` on CUDA tensors, :func:`phase_reference` on CPU
    tensors."""
    if _on_cpu(xplanes[0]):
        return phase_reference(spec, xplanes, oplanes, color, rand, ny,
                               measuring)
    return _launch(spec, xplanes, oplanes, color, ny, inject=rand,
                   measuring=measuring)


# ---------------------------------------------------------------------------
# the halo mode: a shard of a (y[, x]) mesh
# ---------------------------------------------------------------------------

def shard_nbr_planes(o, color: int, up01, dn01, halo_lf=None, halo_rt=None):
    """(up, dn, ctr, side) neighbour planes of a shard's other colour
    ``o`` ((R, Lp, half) uint32 in int64): the carry into word row 0 is
    bit 0 of ``up01`` spliced in at bit 31, the carry out of the last word
    row bit 0 of ``dn01`` ((R, 1, half) 0/1); with an x split the side
    words past the edges are the word columns ``halo_lf``/``halo_rt``
    ((R, Lp, 1)), else periodic in x (JAX ``sharded_phase_reference``)."""
    w_prev = torch.cat([(_u32(up01) & 1) << 31, o[..., :-1, :]], dim=-2)
    w_next = torch.cat([o[..., 1:, :], _u32(dn01) & 1], dim=-2)
    up = ((o << 1) & MASK32) | (w_prev >> 31)
    dn = (o >> 1) | ((w_next << 31) & MASK32)
    if halo_lf is None:
        minus = torch.roll(o, 1, dims=-1)
        plus = torch.roll(o, -1, dims=-1)
    else:
        minus = torch.cat([_u32(halo_lf), o[..., :-1]], dim=-1)
        plus = torch.cat([o[..., 1:], _u32(halo_rt)], dim=-1)
    if color == 0:
        side = (plus & _ODD_BITS) | (minus & _EVEN_BITS)
    else:
        side = (minus & _ODD_BITS) | (plus & _EVEN_BITS)
    return up, dn, o, side


def sharded_phase_packed_plain(spec: PlaneSpec, xplanes, oplanes, hup, hdn,
                               seeds, offs, *, color: int, beta: float,
                               halo_lf=None, halo_rt=None, inject=None,
                               measuring: bool = False):
    """Plain version of ``phase_kernel<Q, true>``: the new (R, Lp, half)
    int32 shard planes given the other colour's planes, their 0/1 halo
    rows ``hup``/``hdn`` and, with an x split, word columns
    ``halo_lf``/``halo_rt`` (n_state-tuples each); offs = (rep0, wrow0[,
    col0]).  Random planes injected (``inject``), or from Philox words at
    the shard's global word positions.  With ``measuring`` also the (R,)
    int64 (2m, 2e) partials ((m, e) for q = 4), as JAX's."""
    rep0, wrow0, *rest = offsets(offs)
    col0 = rest[0] if rest else 0
    nrep, nyw, half = xplanes[0].shape
    xs = tuple(_u32(p) for p in xplanes)
    os_ = tuple(_u32(p) for p in oplanes)
    lfs = halo_lf if halo_lf is not None else (None,) * spec.n_state
    rts = halo_rt if halo_rt is not None else (None,) * spec.n_state
    nbrs = tuple(shard_nbr_planes(o, color, u, d, lf, rt)
                 for o, u, d, lf, rt in zip(os_, hup, hdn, lfs, rts))
    if inject is None:
        gen = multispin_rng.word_stream(seeds, nrep, nyw, half,
                                        xplanes[0].device, rep0, wrow0, col0)
        rand = spec.draw(gen, spec.accept_digits(beta))
    else:
        rand = tuple(_u32(p) for p in inject)
    new, fin = spec.decide(xs, nbrs, rand)
    out = tuple(_i32(p) for p in new)
    if not measuring:
        return out
    mask = real_mask(nyw, half, 0, xs[0].device)
    m, e = spec.obs_partial(new, os_, fin, mask)
    return out, m, e


def shard_ok(local_shape: tuple[int, ...]) -> bool:
    """A local packed (R, Lp, half) word block the halo mode takes: any
    such shape (JAX's terms, half % 128 and Lp % 8, are its TPU tiling;
    the semantic ones, whole words a y shard, are the gate's in
    parallel/domain.py)."""
    return len(local_shape) == 3 and min(local_shape) >= 1


def _halo_args(xplanes, hup, hdn, halo_lf, halo_rt):
    """Check a shard's halos: int32 contiguous on the planes' device, rows
    (R, 1, half) and columns (R, Lp, 1), a tuple of n_state each."""
    nrep, nyw, half = xplanes[0].shape
    n = len(xplanes)
    cols = halo_lf is not None
    if (halo_rt is not None) != cols:
        raise ValueError("pass both halo_lf and halo_rt, or neither")
    groups = [(hup, (nrep, 1, half)), (hdn, (nrep, 1, half))]
    if cols:
        groups += [(halo_lf, (nrep, nyw, 1)), (halo_rt, (nrep, nyw, 1))]
    for planes, shape in groups:
        if len(planes) != n:
            raise ValueError(f"{n} halo planes a side, got {len(planes)}")
        for h in planes:
            if (h.shape != shape or h.dtype != torch.int32
                    or h.device != xplanes[0].device
                    or not h.is_contiguous()):
                raise ValueError(f"halos must be contiguous int32 {shape} "
                                 f"on {xplanes[0].device}, got {h.dtype} "
                                 f"{tuple(h.shape)} on {h.device}")


def sharded_phase_packed(spec: PlaneSpec, xplanes, oplanes, hup, hdn, seeds,
                         offs, *, color: int, beta: float, halo_lf=None,
                         halo_rt=None, inject=None, measuring: bool = False):
    """One packed clock phase of a (y[, x])-sharded block: returns the new
    (R, Lp, half) planes, and with ``measuring`` also the (R,) int64
    partials: ``phase_kernel<Q, true>`` on CUDA tensors,
    :func:`sharded_phase_packed_plain` on CPU tensors.  The arguments are
    JAX's ``sharded_phase_packed`` (``:796``): hup/hdn n_state-tuples of
    (R, 1, half) 0/1 int32 rows (``halo.exchange_halo_rows_packed`` a
    plane), halo_lf/halo_rt of (R, Lp, 1) word columns with an x split
    (offs then (rep0, wrow0, col0)), ``inject`` the n_rand random planes."""
    if _on_cpu(xplanes[0]):
        return sharded_phase_packed_plain(
            spec, xplanes, oplanes, hup, hdn, seeds, offs, color=color,
            beta=beta, halo_lf=halo_lf, halo_rt=halo_rt, inject=inject,
            measuring=measuring)
    nrep, nyw, half = xplanes[0].shape
    rep0, wrow0, *rest = offsets(offs)
    col0 = rest[0] if rest else 0
    _halo_args(xplanes, hup, hdn, halo_lf, halo_rt)
    inj, table, s0, s1 = _random_args(spec, xplanes, oplanes, seeds, beta,
                                      inject)
    outs = [torch.empty_like(p) for p in xplanes]
    obs = (torch.zeros((nrep, 2), dtype=torch.int64, device=xplanes[0].device)
           if measuring else None)

    def three(planes):
        return [p.data_ptr() for p in planes] + [None] * (3 - len(planes))

    none3 = [None] * 3
    ptrs = (three(xplanes) + three(outs) + three(oplanes) + three(hup)
            + three(hdn)
            + (three(halo_lf) if halo_lf is not None else none3)
            + (three(halo_rt) if halo_rt is not None else none3))
    lib = _lib()
    with torch.cuda.device(xplanes[0].device):
        code = lib.clock_halo_phase(
            spec.q, (_VOID * 21)(*ptrs),
            None if inj is None else inj.data_ptr(),
            None if obs is None else obs.data_ptr(), nrep, nyw, half, color,
            int(inj is not None), rep0, wrow0, col0, s0, s1, table,
            _stream(xplanes[0]))
    if code != 0:
        msg = lib.clock_error_string(code).decode()
        raise RuntimeError(f"clock phase_kernel<Q, true>: CUDA error {code} "
                           f"({msg})")
    LAUNCHES["shard_phase"] += 1
    if measuring:
        return tuple(outs), obs[:, 0], obs[:, 1]
    return tuple(outs)


# ---------------------------------------------------------------------------
# gates (the JAX package's, so that both route a shape alike)
# ---------------------------------------------------------------------------

def packable_gate(spec: PlaneSpec, model) -> bool:
    """Shape/parameter gate of the aligned packed engine."""
    if getattr(model, "q", None) != spec.q:
        return False
    ny, half = model.color_shape
    return packable(ny, half) and model.nsites <= spec.max_sites


class PadSpec(NamedTuple):
    """The JAX package's pad geometry (its planes are (nyp, halfp)); the
    port keeps (nyw, half) planes and uses this only to route alike and
    to convert states (interop.py)."""

    ny: int       # real site rows per colour array
    half: int     # real lanes (nx / 2)
    nyw: int      # real word rows = ceil(ny / 32)
    nb: int       # ny % 32 (real bits in the partial top word)
    nyp: int      # padded word rows (multiple of 8)
    halfp: int    # padded lanes (multiple of 128)


def padded_spec(ny: int, half: int) -> PadSpec | None:
    """Pad geometry of a colour array, or None if the shape is either
    aligned (the plain engine) or not padded-servable."""
    if ny % 2 or ny < 4 or half < 2:
        return None
    nyw = -(-ny // PACK)
    nb = ny % PACK
    y_aligned = nb == 0 and nyw % 8 == 0
    halfp = -(-half // 128) * 128
    if y_aligned and halfp == half:
        return None
    if halfp != half and halfp - half < 2:
        return None
    if nb and nyw < 2:
        return None
    nyp = nyw if y_aligned else -(-(nyw + 1) // 8) * 8
    return PadSpec(ny, half, nyw, nb, nyp, halfp)


# below this real/padded occupancy the JAX package takes its int8 engine
_PAD_MIN_OCCUPANCY = 0.35


def padded_packable_gate(spec: PlaneSpec, model) -> bool:
    """Shape/parameter gate of the padded packed engine."""
    if getattr(model, "q", None) != spec.q:
        return False
    ny, half = model.color_shape
    pad = padded_spec(ny, half)
    if pad is None:
        return False
    occ = (ny / (pad.nyp * PACK)) * (half / pad.halfp)
    return occ >= _PAD_MIN_OCCUPANCY and model.nsites <= spec.max_sites


# ---------------------------------------------------------------------------
# state and sweep entries
# ---------------------------------------------------------------------------

def pack_state(spec: PlaneSpec, state):
    """CheckerboardState of int8 states -> (wa, wb, batched) plane tuples."""
    a, b = state
    batched = a.dim() == 3
    if not batched:
        a, b = a[None], b[None]
    return spec.pack_color(a), spec.pack_color(b), batched


def unpack_state(spec: PlaneSpec, wa, wb, ny: int, batched: bool):
    from cuda_fortran_mc_simulation_spin_tpu_torch.models.base import (
        CheckerboardState,
    )
    a = spec.unpack_color(*wa)[..., :ny, :]
    b = spec.unpack_color(*wb)[..., :ny, :]
    if not batched:
        a, b = a[0], b[0]
    return CheckerboardState(a, b)


def _densities(spec: PlaneSpec, model, obs) -> dict[str, torch.Tensor]:
    scale = spec.obs_scale / model.nsites
    return {"m": obs[..., 0].to(torch.float64) * scale,
            "e": obs[..., 1].to(torch.float64) * scale}


def sweep_measure_seeded(spec: PlaneSpec, model, wa, wb, seeds):
    """One MCS given the sweep's (2, 2) phase keys, with the (m, e)
    densities (R,) float64 fused into phase b."""
    ny = model.color_shape[0]
    wa = phase_packed(spec, wa, wb, seeds[0], color=0, beta=model.beta,
                      ny=ny)
    wb, obs = phase_packed(spec, wb, wa, seeds[1], color=1, beta=model.beta,
                           ny=ny, measuring=True)
    return wa, wb, _densities(spec, model, obs)


def sweep_measure_packed(spec: PlaneSpec, model, wa, wb, key):
    """One MCS under the sweep key ``key`` with fused (m, e) densities."""
    return sweep_measure_seeded(spec, model, wa, wb, _phase_seeds(key))


def sweep_packed(spec: PlaneSpec, model, wa, wb, key):
    """One full MCS on packed plane tuples."""
    seeds = _phase_seeds(key)
    ny = model.color_shape[0]
    wa = phase_packed(spec, wa, wb, seeds[0], color=0, beta=model.beta,
                      ny=ny)
    wb = phase_packed(spec, wb, wa, seeds[1], color=1, beta=model.beta,
                      ny=ny)
    return wa, wb
