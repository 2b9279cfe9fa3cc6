"""Bit-packed multispin Metropolis for the helical 3-D Ising geometry.

Port of ``cuda_fortran_mc_simulation_spin_tpu/ops/helical3d_multispin.py``:
the reference's committed 151x151x150, 501x501x500 and 1001x1000x1000.
Splitting the flat lattice by index parity gives colour vectors a[j] =
s[2j], b[j] = s[2j+1] of M = nall/2 sites whose neighbours are six
constant modular offsets (h = (nx-1)/2; g = (nx·ny-1)/2 for odd nx·ny):

    odd nx·ny    a reads b at {0, -1, h, -(h+1), g, -(g+1)},
                 b reads a at {1, 0, h+1, -h, g+1, -g};
    even nx·ny   a reads b at {0, -1, h, -(h+1)}, b reads a at
                 {1, 0, h+1, -h}, and each colour reads itself at
                 ±nx·ny/2 (its z-neighbours).

With even nx·ny each colour phase splits into two z-plane-parity
sub-phases (models/ising3d_helical.py): four a sweep, each flipping only
sites whose z-plane (colour index // (nx·ny/2)) has parity ``zsub``.
Words and neighbour planes are those of ops/helical_multispin.py (flat
(R, W) words, :func:`shift_mod`); the count and the three Bernoulli chains
those of ops/ising3d_multispin.py.

The CUDA kernels are in ``csrc/helical3d_multispin.cu``:

- ``phase_kernel``: one (sub-)phase with Philox words or injected planes,
  with the fused exact (m, e) (m only at even nx·ny); its Bernoulli chains
  are drawn in a fully unrolled loop from a per-launch table
  (``ops/multispin_rng.chain_table``, the table the periodic 3-D kernels
  follow too);
- ``energy_kernel``: the exact (m, e) of the final vectors, which the
  even-nx·ny route needs every sweep; runs of ``ENERGY_RUN`` words a
  thread, each plane's words loaded once as aligned 16-B vectors, its
  launch constants from :func:`energy_runs` (replayed on the CPU by
  ``tests/test_torch_helical3d_energy_runs.py``);
- ``multisweep_kernel``: S sweeps in one launch at odd nx·ny, its chains
  drawn as ``phase_kernel`` draws them, from the same table, under the
  round keys of each (sweep, phase) key.

Beside each is its plain PyTorch version here, with the same Philox words
(ops/multispin_rng.py, counter (replica, word, 0, draw/4)) under the key of
each (sample, t, sub-phase).  A wrapper takes the plain version for a CPU
tensor; for a CUDA tensor it launches the kernel or raises.  ``LAUNCHES``
counts launches per kernel.

Route (PERF.md section 6): the resident multisweep when nx·ny is odd and a
colour vector has at most ``helical_multispin.MAX_WORDS`` words (151^3);
streamed phase launches otherwise (501^3, 1001x1000x1000).  The JAX
package's ring-pad halo layout (``ring_fill``, ``pack_flat_halo``) is a
TPU layout and has no counterpart: the kernels read across the wrap.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from cuda_fortran_mc_simulation_spin_tpu_torch.ops import _build, multispin_rng
from cuda_fortran_mc_simulation_spin_tpu_torch.ops.helical_multispin import (
    MAX_WORDS,
    _check_vectors,
    shift_mod,
    valid_mask,
    words,
)
from cuda_fortran_mc_simulation_spin_tpu_torch.ops.ising2d_multispin import (
    MASK32,
    PACK,
    _bern_plane,
    _digits,
    _i32,
    _on_cpu,
    _pc_plane,
    _stream,
    _u32,
)
from cuda_fortran_mc_simulation_spin_tpu_torch.ops.ising3d_multispin import (
    _TABLE,
    _count6,
    _densities,
    _flip_plane3d,
    _table,
    chain_words3d,
)
# the unrolled chains' table (its tests name it here)
from cuda_fortran_mc_simulation_spin_tpu_torch.ops.multispin_rng import (
    CHAIN_CALLS,
    chain_table,
)

# colour sites up to which the kernels index bits in 32-bit ints (a read
# position is below 2M); 1001x1000x1000 has M = 500,500,000
MAX_SITES = 1 << 30
# replicas of one launch: the phase and energy grids put them on y
MAX_REPLICAS = 65535

LAUNCHES = {"phase": 0, "phase_measuring": 0, "energy": 0, "multisweep": 0}
# energy_kernel: words a thread a step (its ENERGY_RUN; runs of 8 beat
# runs of 4 on an H100, PERF.md §6, chip_time_ising.py --helical3d's
# variant build), threads a block, and blocks a launch (four an SM, the
# kernel's launch bound), spread over the replicas
ENERGY_RUN = 8
ENERGY_THREADS = 256
ENERGY_BLOCKS = 4 * 132


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def helical3d_offsets(nx: int, nxy: int
                      ) -> tuple[tuple[int, ...], tuple[int, ...],
                                 tuple[int, ...]]:
    """(cross offsets of colour a, cross offsets of colour b, self
    offsets) in colour-index space."""
    h = (nx - 1) // 2
    if nxy % 2 == 1:
        g = (nxy - 1) // 2
        return ((0, -1, h, -(h + 1), g, -(g + 1)),
                (1, 0, h + 1, -h, g + 1, -g), ())
    return ((0, -1, h, -(h + 1)), (1, 0, h + 1, -h),
            (nxy // 2, -(nxy // 2)))


def _stencil(nx: int, nxy: int, color: int):
    """(cross offsets, self offsets) of the colour ``color``."""
    offs_a, offs_b, offs_s = helical3d_offsets(nx, nxy)
    return (offs_b if color else offs_a), offs_s


def zmask_words(nxy: int, m: int, device=None) -> torch.Tensor:
    """(W,) uint32 (in int64) words whose bit p is set iff colour index p
    lies in an even z-plane, (p // (nxy/2)) % 2 == 0 (nxy even): the JAX
    package's ``zmask_plane`` on the flat word layout.  Flat sites 2j and
    2j+1 share a z-plane, so one mask serves both colours."""
    zh = nxy // 2
    base = torch.arange(words(m), dtype=torch.int64, device=device) * PACK
    out = torch.zeros_like(base)
    for k in range(PACK):
        out |= (((base + k) // zh) % 2 == 0).to(torch.int64) << k
    return out


def fits(model) -> bool:
    """The resident multisweep kernel serves ``model``: odd nx·ny (every
    neighbour in the other colour) and a colour vector of at most
    MAX_WORDS words (151x151x150 has 53,440)."""
    m = model.nsites // 2
    return model.nxy % 2 == 1 and words(m) <= MAX_WORDS and fits_stream(model)


def fits_stream(model) -> bool:
    """The streamed phase and energy kernels serve ``model``: odd nx and an
    even site count (the model's own gates) and fewer than MAX_SITES sites
    a colour."""
    return (model.nx % 2 == 1 and model.nsites % 2 == 0
            and 1 <= model.nsites // 2 < MAX_SITES)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _counts(x, o, offs_cross, offs_self, m: int):
    """(b1, b2, b4) of the six neighbour planes of colour ``x``: the other
    colour ``o`` at ``offs_cross``, ``x`` itself at ``offs_self``."""
    planes = [_u32(shift_mod(o, d, m)) for d in offs_cross]
    planes += [_u32(shift_mod(x, d, m)) for d in offs_self]
    return _count6(*planes)


def _zsub_mask(zmask, zsub: int) -> torch.Tensor:
    zm = _u32(zmask)
    return zm if zsub == 0 else ~zm & MASK32


def packed_phase_reference(xw, ow, offs_cross, offs_self, b4, b8, b12,
                           m: int, zmask=None, zsub: int = 0):
    """Plain packed (sub-)phase on (..., W) words with given Bernoulli
    planes: the plain version of the phase kernel's injected-bits mode.
    With ``zmask`` (:func:`zmask_words`) only the sites of z-parity
    ``zsub`` flip."""
    x = _u32(xw)
    b1, b2, b4c = _counts(x, _u32(ow), offs_cross, offs_self, m)
    flip = _flip_plane3d(x, b1, b2, b4c, _u32(b4), _u32(b8), _u32(b12))
    if zmask is not None:
        flip = flip & _zsub_mask(zmask, zsub)
    return _i32(x ^ flip)


def flat_phase_reference(x_flat, o_flat, offs_cross, offs_self, b4u, b8u,
                         b12u, zmask=None, zsub: int = 0):
    """Unpacked ±1 colour-vector oracle given boolean Bernoulli planes;
    ``zmask`` (bool, colour-index space) gates flips to one z-parity."""
    o32, x32 = o_flat.to(torch.int32), x_flat.to(torch.int32)
    nsum = sum(torch.roll(o32, -d, dims=-1) for d in offs_cross)
    for d in offs_self:
        nsum = nsum + torch.roll(x32, -d, dims=-1)
    half_de = x32 * nsum
    accept = (half_de <= 0) | torch.where(
        half_de == 2, b4u, torch.where(half_de == 4, b8u, b12u))
    if zmask is not None:
        accept = accept & (zmask if zsub == 0 else ~zmask)
    return torch.where(accept, -x_flat, x_flat).to(torch.int8)


def _obs_sums(new, o, b1, b2, b4c, m: int, energy: bool) -> torch.Tensor:
    """(R, 2) int64 exact (m, e) from a measuring phase of colour b, pad
    bits masked.  At odd nx·ny phase b's counts are against the final a
    and each bond has one b end: e = -Σ_b s_b·(2c-6).  With self reads
    (even nx·ny) that identity fails and e is 0 (energy_kernel's job)."""
    vm = valid_mask(m, new.device)

    def pc(u):
        return _pc_plane(u & vm).sum(dim=-1)

    s_x = pc(new)
    mm = 2 * (s_x + pc(o)) - 2 * m
    if not energy:
        return torch.stack([mm, torch.zeros_like(mm)], dim=-1)
    s_c = pc(b1) + 2 * pc(b2) + 4 * pc(b4c)
    s_xc = pc(new & b1) + 2 * pc(new & b2) + 4 * pc(new & b4c)
    e = -(4 * s_xc - 12 * s_x - 2 * s_c + 6 * m)
    return torch.stack([mm, e], dim=-1)


def phase_plain(xw, ow, seeds, *, color: int, nx: int, nxy: int, m: int,
                beta: float, zsub: int | None = None,
                measuring: bool = False):
    """Plain version of ``phase_kernel`` with Philox words: one
    (sub-)phase of the (R, W) colour ``color`` under the key ``seeds``
    ((2,) uint32), only z-parity ``zsub`` when given.  Returns the new
    vector, and with ``measuring`` also the (R, 2) int64 (m, e) sums."""
    offs_cross, offs_self = _stencil(nx, nxy, color)
    nrep, nw = xw.shape
    x, o = _u32(xw), _u32(ow)
    b1, b2, b4c = _counts(x, o, offs_cross, offs_self, m)
    stream = multispin_rng.word_stream(seeds, nrep, nw, 1, xw.device)

    def gen():
        return stream().reshape(nrep, nw)

    p4, p8, p12 = (_bern_plane(x.shape, _digits(q), gen, xw.device)
                   for q in chain_words3d(beta))
    flip = _flip_plane3d(x, b1, b2, b4c, p4, p8, p12)
    if zsub is not None:
        flip = flip & _zsub_mask(zmask_words(nxy, m, xw.device), zsub)
    new = x ^ flip
    if not measuring:
        return _i32(new)
    return _i32(new), _obs_sums(new, o, b1, b2, b4c, m, not offs_self)


def multisweep_plain(wa, wb, seeds, *, beta: float, nx: int, nxy: int,
                     m: int):
    """Plain version of ``multisweep_kernel`` (odd nx·ny): S = len(seeds)
    sweeps of phase pairs under the (S, 2, 2) keys; returns (wa, wb, obs)
    with obs the (R, S, 2) int64 (m, e) of every sweep."""
    kw = dict(nx=nx, nxy=nxy, m=m, beta=beta)
    obs = []
    for s in range(seeds.shape[0]):
        wa = phase_plain(wa, wb, seeds[s, 0], color=0, **kw)
        wb, o = phase_plain(wb, wa, seeds[s, 1], color=1, measuring=True,
                            **kw)
        obs.append(o)
    return wa, wb, torch.stack(obs, dim=1)


def _energy_pairs(nx: int, nxy: int):
    """(source colour, neighbour colour, offset) of the three forward
    bonds +1, +nx, +nx·ny of every site of both colours: flat site 2j+c
    reaches 2j+c+δ, colour (c+δ) % 2 at index j + (c+δ)//2."""
    h = (nx - 1) // 2
    pairs = [(0, 1, 0), (0, 1, h), (1, 0, 1), (1, 0, h + 1)]
    if nxy % 2 == 1:
        g = (nxy - 1) // 2
        return pairs + [(0, 1, g), (1, 0, g + 1)]
    return pairs + [(0, 0, nxy // 2), (1, 1, nxy // 2)]


def energy_plain(wa, wb, *, nx: int, nxy: int, m: int) -> torch.Tensor:
    """(R,) int64 energy sum of (R, W) colour vectors at either parity of
    nx·ny: -Σ s·s' over every bond = Σ (2·disagreements - M) over the six
    forward-bond planes (JAX ``_energy_all_packed``)."""
    vm = valid_mask(m, wa.device)
    cols = (_u32(wa), _u32(wb))
    e = torch.zeros(wa.shape[0], dtype=torch.int64, device=wa.device)
    for src, nbr, d in _energy_pairs(nx, nxy):
        sh = _u32(shift_mod(cols[nbr], d, m))
        e += 2 * _pc_plane((cols[src] ^ sh) & vm).sum(dim=-1) - m
    return e


def magne_sum(wa, wb, m: int) -> torch.Tensor:
    """(R,) int64 Σ s over both colours (JAX ``magne_sum_packed``)."""
    vm = valid_mask(m, wa.device)
    return sum(2 * _pc_plane(_u32(w) & vm).sum(dim=-1) - m
               for w in (wa, wb))


def energy_sums_plain(wa, wb, *, nx: int, nxy: int, m: int) -> torch.Tensor:
    """Plain version of ``energy_kernel``: (R, 2) int64 (m, e) sums."""
    return torch.stack([magne_sum(wa, wb, m),
                        energy_plain(wa, wb, nx=nx, nxy=nxy, m=m)], dim=-1)


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

_VOID = ctypes.c_void_p
_INT = ctypes.c_int
_UINT = ctypes.c_uint
_INTS = ctypes.POINTER(ctypes.c_int)


def _lib() -> ctypes.CDLL:
    lib = _build.load("helical3d_multispin")
    if lib.helical3d_phase.argtypes is not None:
        return lib
    lib.helical3d_phase.argtypes = [
        _VOID, _VOID, _VOID, _VOID, _VOID, _VOID, _VOID,
        _INT, _INT, _INT, _INT, _INTS, _INT, _INT,
        _UINT, _UINT, _TABLE, _VOID]
    lib.helical3d_phase.restype = _INT
    lib.helical3d_energy.argtypes = [
        _VOID, _VOID, _VOID, _INT, _INT, _INT, _INTS, _INT, _INTS, _VOID]
    lib.helical3d_energy.restype = _INT
    lib.helical3d_multisweep.argtypes = [
        _VOID, _VOID, _VOID, _VOID, _VOID, _VOID, _INT, _INT, _INT, _INT,
        _INTS, _INTS, _TABLE, _VOID]
    lib.helical3d_multisweep.restype = _INT
    lib.helical3d_error_string.argtypes = [_INT]
    lib.helical3d_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(lib, code: int, what: str) -> None:
    if code != 0:
        msg = lib.helical3d_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def _check(m: int, *vecs: torch.Tensor) -> None:
    """int32 contiguous (R, W) vectors on one CUDA device, with M below
    MAX_SITES and R at most MAX_REPLICAS."""
    if not 1 <= m < MAX_SITES:
        raise ValueError(f"M = {m} sites a colour: the kernels index bits "
                         f"in 32-bit ints and take M < {MAX_SITES}")
    _check_vectors(m, *vecs, max_words=words(MAX_SITES))
    if vecs[0].shape[0] > MAX_REPLICAS:
        raise ValueError(f"{vecs[0].shape[0]} replicas: a launch takes at "
                         f"most {MAX_REPLICAS}")


def _offsets(offs, m: int):
    """Offsets mod M as the kernels' int[6]."""
    return (ctypes.c_int * 6)(*(d % m for d in offs))


def _launch_phase(xw, ow, seeds, *, color, nx, nxy, m, q, bits=None,
                  zsub=None, measuring=False):
    _check(m, xw, ow, *(bits or ()))
    lib = _lib()
    offs_cross, offs_self = _stencil(nx, nxy, color)
    nrep, nw = xw.shape
    out = torch.empty_like(xw)
    # zeroed: the kernel adds each block's sums with an atomic
    obs = (torch.zeros((nrep, 2), dtype=torch.int64, device=xw.device)
           if measuring else None)
    s0, s1 = (int(v) & MASK32 for v in seeds)
    b4, b8, b12 = bits or (None, None, None)
    with torch.cuda.device(xw.device):
        code = lib.helical3d_phase(
            xw.data_ptr(), out.data_ptr(), ow.data_ptr(),
            None if b4 is None else b4.data_ptr(),
            None if b8 is None else b8.data_ptr(),
            None if b12 is None else b12.data_ptr(),
            None if obs is None else obs.data_ptr(),
            nrep, nw, m, len(offs_cross), _offsets(offs_cross + offs_self, m),
            -1 if zsub is None else zsub, nxy // 2, s0, s1,
            _table(q), _stream(xw))
    _raise_on(lib, code, "helical3d phase_kernel")
    LAUNCHES["phase"] += 1
    if measuring:
        LAUNCHES["phase_measuring"] += 1
        return out, obs
    return out


def phase_packed(xw, ow, seeds, *, color: int, nx: int, nxy: int, m: int,
                 beta: float, zsub: int | None = None,
                 measuring: bool = False):
    """One (sub-)phase of (R, W) colour vectors with Philox words under
    ``seeds``: ``phase_kernel`` on a CUDA tensor, :func:`phase_plain` on a
    CPU tensor.  Returns the new vector, and with ``measuring`` also the
    (R, 2) int64 (m, e) sums (e = 0 at even nx·ny)."""
    kw = dict(color=color, nx=nx, nxy=nxy, m=m, zsub=zsub,
              measuring=measuring)
    if _on_cpu(xw):
        return phase_plain(xw, ow, seeds, beta=beta, **kw)
    return _launch_phase(xw, ow, seeds, q=chain_words3d(beta), **kw)


def phase_packed_with_bits(xw, ow, b4, b8, b12, *, color: int, nx: int,
                           nxy: int, m: int, zsub: int | None = None
                           ) -> torch.Tensor:
    """One packed (sub-)phase with injected Bernoulli planes: the bitwise-
    testable mode of ``phase_kernel`` (plain:
    :func:`packed_phase_reference`)."""
    if _on_cpu(xw):
        offs_cross, offs_self = _stencil(nx, nxy, color)
        zmask = None if zsub is None else zmask_words(nxy, m, xw.device)
        return packed_phase_reference(xw, ow, offs_cross, offs_self, b4, b8,
                                      b12, m, zmask=zmask, zsub=zsub or 0)
    return _launch_phase(xw, ow, (0, 0), color=color, nx=nx, nxy=nxy, m=m,
                         q=(0, 0, 0), bits=(b4, b8, b12), zsub=zsub)


def energy_runs(nrep: int, nx: int, nxy: int, m: int) -> dict:
    """``energy_kernel``'s launch constants (the entry point takes them as
    passed, after its own check), for runs of ``run`` = ENERGY_RUN words
    a thread a step: ``nruns`` runs a replica, ceil((W + 3) / run), run t
    holding words run·t - c .. (c the replica's first word of colour a mod
    4, so that its words lie on the 16-B grid); ``bulk``, the runs t <
    bulk (t >= 1, or t = 0 at c = 0) whose windows read no word past W - 1
    and no plane wraps past M, for every c; ``blocks`` a replica,
    ENERGY_BLOCKS a launch spread over the replicas; each plane's word
    offset ``q`` and bit shift ``sh`` (its offset d mod M is
    ``_energy_pairs``'s)."""
    run = ENERGY_RUN
    nw = words(m)
    d = [dd % m for _, _, dd in _energy_pairs(nx, nxy)]
    nruns = -(-(nw + 3) // run)
    bulk = 0
    if d[0] == 0 and d[2] == 1:
        # the last bulk run's first word, K t: its windows end at word
        # K t + run + 3 + q <= W - 1, its planes at bit 32 (K t + run) + d
        top = min(nw - 4 - run - max(dd >> 5 for dd in d),
                  (m - max(d)) // 32 - run)
        bulk = min(nruns, top // run + 1) if top >= 0 else 0
    return {"run": run, "nruns": nruns, "bulk": bulk,
            "blocks": max(1, min(-(-nruns // ENERGY_THREADS),
                                 ENERGY_BLOCKS // nrep)),
            "q": tuple(dd >> 5 for dd in d),
            "sh": tuple(dd & 31 for dd in d)}


@functools.lru_cache(maxsize=64)
def _energy_runs_arg(nrep: int, nx: int, nxy: int, m: int) -> ctypes.Array:
    """:func:`energy_runs` as the kernel's 15 ints (EnergyRuns), built
    once a shape."""
    t = energy_runs(nrep, nx, nxy, m)
    vals = [t["nruns"], t["bulk"], t["blocks"], *t["q"], *t["sh"]]
    return (ctypes.c_int * len(vals))(*vals)


def energy_sums(wa, wb, *, nx: int, nxy: int, m: int) -> torch.Tensor:
    """(R, 2) int64 exact (m, e) of the (R, W) colour vectors:
    ``energy_kernel`` on CUDA tensors, :func:`energy_sums_plain` on CPU
    tensors."""
    if _on_cpu(wa):
        return energy_sums_plain(wa, wb, nx=nx, nxy=nxy, m=m)
    _check(m, wa, wb)
    lib = _lib()
    nrep, nw = wa.shape
    pairs = _energy_pairs(nx, nxy)
    # zeroed: each block adds its sums with an atomic
    obs = torch.zeros((nrep, 2), dtype=torch.int64, device=wa.device)
    with torch.cuda.device(wa.device):
        code = lib.helical3d_energy(
            wa.data_ptr(), wb.data_ptr(), obs.data_ptr(), nrep, nw, m,
            _offsets([d for _, _, d in pairs], m), int(nxy % 2 == 0),
            _energy_runs_arg(nrep, nx, nxy, m), _stream(wa))
    _raise_on(lib, code, "helical3d energy_kernel")
    LAUNCHES["energy"] += 1
    return obs


def multisweep_args(*, beta: float, nx: int, nxy: int, m: int):
    """``multisweep_kernel``'s launch constants: each colour's six cross
    offsets mod M (int[6]) and the ChainTable of ``beta``'s chains, the
    table ``phase_kernel`` takes (checked: a table the kernel cannot follow
    raises ValueError)."""
    offs_a, offs_b, _ = helical3d_offsets(nx, nxy)
    return (_offsets(offs_a, m), _offsets(offs_b, m),
            _table(chain_words3d(beta)))


def multisweep_planes(wa, wb, seeds, *, beta: float, nx: int, nxy: int,
                      m: int):
    """S = len(seeds) sweeps under the (S, 2, 2) keys at odd nx·ny:
    ``multisweep_kernel`` (one launch) on CUDA tensors,
    :func:`multisweep_plain` on CPU tensors.  Returns (wa, wb, obs) with
    obs the (R, S, 2) int64 (m, e) of every sweep."""
    if nxy % 2 == 0:
        raise ValueError("the multisweep serves odd nx*ny only; even nx*ny "
                         "takes the streamed z-parity sub-phases")
    if _on_cpu(wa):
        return multisweep_plain(wa, wb, seeds, beta=beta, nx=nx, nxy=nxy,
                                m=m)
    _check(m, wa, wb)
    offs_a, offs_b, table = multisweep_args(beta=beta, nx=nx, nxy=nxy, m=m)
    lib = _lib()
    nrep, nw = wa.shape
    sweeps = int(seeds.shape[0])
    seeds_dev = _i32(seeds).contiguous().to(wa.device)
    wa_out, wb_out = torch.empty_like(wa), torch.empty_like(wb)
    # zeroed: the kernel adds each sweep's block sums with an atomic
    obs = torch.zeros((nrep, sweeps, 2), dtype=torch.int64, device=wa.device)
    with torch.cuda.device(wa.device):
        code = lib.helical3d_multisweep(
            wa.data_ptr(), wb.data_ptr(), wa_out.data_ptr(),
            wb_out.data_ptr(), seeds_dev.data_ptr(), obs.data_ptr(), nrep,
            nw, m, sweeps, offs_a, offs_b, table, _stream(wa))
    _raise_on(lib, code, "helical3d multisweep_kernel")
    LAUNCHES["multisweep"] += 1
    return wa_out, wb_out, obs


# ---------------------------------------------------------------------------
# model-level entries
# ---------------------------------------------------------------------------

def sub_phases(model) -> tuple[tuple[int, int | None], ...]:
    """(colour, zsub) of the (sub-)phases of one sweep, in order; sub-phase
    i draws under key i of the sweep (ops/multispin_rng.sweep_phase_keys)."""
    if model.z_cross_parity:
        return ((0, None), (1, None))
    return ((0, 0), (0, 1), (1, 0), (1, 1))


def sweep_keys(model, key, sweeps: int, t0: int = 0) -> torch.Tensor:
    """(sweeps, sub-phases, 2) Philox keys of global sweeps t0+1 ..
    t0+sweeps of the sample keyed by ``key``."""
    return multispin_rng.sweep_phase_keys(key, sweeps, t0,
                                          len(sub_phases(model)))


def sweep_measure_seeded(model, wa, wb, seeds):
    """One MCS of streamed (sub-)phase launches under the sweep's keys (a
    row of :func:`sweep_keys`), with the (m, e) densities (R,) float64:
    fused into phase b at odd nx·ny, from ``energy_kernel`` at even."""
    kw = dict(nx=model.nx, nxy=model.nxy, m=model.nsites // 2,
              beta=model.beta)
    if model.z_cross_parity:
        wa = phase_packed(wa, wb, seeds[0], color=0, **kw)
        wb, obs = phase_packed(wb, wa, seeds[1], color=1, measuring=True,
                               **kw)
    else:
        for i, (color, zsub) in enumerate(sub_phases(model)):
            if color == 0:
                wa = phase_packed(wa, wb, seeds[i], color=0, zsub=zsub, **kw)
            else:
                wb = phase_packed(wb, wa, seeds[i], color=1, zsub=zsub, **kw)
        obs = energy_sums(wa, wb, nx=model.nx, nxy=model.nxy,
                          m=model.nsites // 2)
    return wa, wb, _densities(obs, model.nsites)


def multisweep(model, wa, wb, key, sweeps: int, t0: int = 0):
    """The resident route: ``sweeps`` MCS in one multisweep launch (odd
    nx·ny), per-sweep (m, e) densities (R, sweeps) float64.  ``key`` is the
    sample key and ``t0`` the global sweep index already completed, so the
    trajectory equals :func:`multisweep_stream`'s, whatever the chunking."""
    wa, wb, obs = multisweep_planes(
        wa, wb, sweep_keys(model, key, sweeps, t0), beta=model.beta,
        nx=model.nx, nxy=model.nxy, m=model.nsites // 2)
    return wa, wb, _densities(obs, model.nsites)


def multisweep_stream(model, wa, wb, key, sweeps: int, t0: int = 0):
    """The streamed route: ``sweeps`` MCS of (sub-)phase launches at
    either parity of nx·ny, with the per-sweep (m, e) densities (R,
    sweeps) float64."""
    series = {"m": [], "e": []}
    for row in sweep_keys(model, key, sweeps, t0):
        wa, wb, obs = sweep_measure_seeded(model, wa, wb, row)
        for k in series:
            series[k].append(obs[k])
    return wa, wb, {k: torch.stack(v, dim=1) for k, v in series.items()}
