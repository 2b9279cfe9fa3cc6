"""CUDA kernels against their plain versions on the card (bitwise).

These need an NVIDIA GPU with nvcc; without one they skip (the check is
made inside the fixture, never at import).  chip_smoke.py runs the same
checks, at the main path's shapes, on the card.  On a machine with a card
and no JAX: ``python -m pytest tests/test_torch_cuda.py --noconftest``
(tests/conftest.py sets up JAX for the JAX package's tests)."""

import numpy as np
import pytest
import torch

from cuda_fortran_mc_simulation_spin_tpu_torch.core import rng
from cuda_fortran_mc_simulation_spin_tpu_torch.engine import sweep
from cuda_fortran_mc_simulation_spin_tpu_torch.models import Ising2D
from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
    ising2d_multispin as msb,
)

KBT = 2.26918531421


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


def _planes(dev, nrep=2, ny=512, nx=512, seed=0):
    g = np.random.default_rng(seed)
    return [torch.from_numpy(g.integers(-2 ** 31, 2 ** 31,
                                        size=(nrep, ny // 32, nx // 2),
                                        dtype=np.int64).astype(np.int32)
                             ).to(dev) for _ in range(4)]


@pytest.mark.cuda
@pytest.mark.parametrize("color", [0, 1])
def test_phase_kernel_matches_plain(cuda, color):
    x, o, b4, b8 = _planes(cuda, seed=color)
    seeds = rng.seeds_from_key(rng.base_key(3), color)
    assert torch.equal(
        msb.phase_packed_with_bits(x, o, b4, b8, color=color),
        msb.packed_phase_reference(x, o, color, b4, b8))
    got, obs = msb.phase_packed(x, o, seeds, color=color, beta=1 / KBT,
                                measuring=True)
    want, wobs = msb.phase_packed_plain(x, o, seeds, color=color,
                                        beta=1 / KBT, measuring=True)
    assert torch.equal(got, want) and torch.equal(obs, wobs)


@pytest.mark.cuda
def test_multisweep_kernel_matches_phase_pairs(cuda):
    wa, wb = _planes(cuda, seed=5)[:2]
    seeds = msb.sweep_seed_pairs(rng.sample_key(rng.base_key(1), 0), 8)
    ka, kb, kobs = msb.multisweep_planes(wa, wb, seeds, beta=1 / KBT)
    pa, pb, obs = wa, wb, []
    for s in range(8):
        pa = msb.phase_packed(pa, pb, seeds[s, 0], color=0, beta=1 / KBT)
        pb, o = msb.phase_packed(pb, pa, seeds[s, 1], color=1,
                                 beta=1 / KBT, measuring=True)
        obs.append(o)
    assert torch.equal(ka, pa) and torch.equal(kb, pb)
    assert torch.equal(kobs, torch.stack(obs, dim=1))


@pytest.mark.cuda
def test_cuda_runner_equals_cpu_runner(cuda):
    """The main path's runner gives the same series on the card as its
    plain versions on the CPU."""
    model = Ising2D(nx=256, ny=256, kbt=KBT)
    key = rng.sample_key(rng.base_key(42), 0)
    for resident in (True, False):
        on_card = sweep._make_packed_runner(model, 10, 2, "allup", resident,
                                            cuda, 4)(key)
        on_cpu = sweep._make_packed_runner(model, 10, 2, "allup", resident,
                                           "cpu", 4)(key)
        for k in ("m", "e"):
            assert torch.equal(on_card[k].cpu(), on_cpu[k])


def _helical_vectors(dev, nrep, m, seed):
    from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
        helical_multispin as hms,
    )
    g = np.random.default_rng(seed)
    return [torch.from_numpy(g.integers(-2 ** 31, 2 ** 31,
                                        size=(nrep, hms.words(m)),
                                        dtype=np.int64).astype(np.int32)
                             ).to(dev) for _ in range(4)]


@pytest.mark.cuda
@pytest.mark.parametrize("nx,ny", [(131, 62), (1001, 1000), (2001, 2000)])
def test_helical_kernel_matches_plain(cuda, nx, ny):
    """Injected-bits mode on the valid bits; S sweeps against its plain
    version and against S one-sweep launches; the fused (m, e) against the
    exact sums of the unpacked state.  2001x2000 (2 x 244 KiB a replica)
    is over the shared memory, so the kernel works in device memory."""
    from cuda_fortran_mc_simulation_spin_tpu_torch.models import (
        Ising2DHelical,
    )
    from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
        helical_multispin as hms,
    )
    m = nx * ny // 2
    model = Ising2DHelical(nx, ny, KBT)
    x, o, b4, b8 = _helical_vectors(cuda, 2, m, nx)
    for offs in hms.helical_offsets(nx):
        got = hms.phase_packed_with_bits(x, o, b4, b8, offs=offs, m=m)
        want = hms.packed_helical_phase_reference(x, o, offs, b4, b8, m)
        assert torch.equal(hms.unpack_flat(got, m), hms.unpack_flat(want, m))
    seeds = hms.sweep_seed_pairs(rng.sample_key(rng.base_key(2), 0), 4)
    kw = dict(beta=1 / KBT, nx=nx, m=m)
    assert hms.staged_fits(hms.words(m), cuda) == (nx < 2001)
    ka, kb, kobs = hms.multisweep_planes(x, o, seeds, **kw)
    pa, pb, pobs = hms.multisweep_plain(x, o, seeds, **kw)
    vm = hms.valid_mask(m, cuda)
    for w, want in zip((ka, kb), (pa, pb)):
        assert torch.equal(hms._u32(w) & vm, hms._u32(want) & vm)
    assert torch.equal(kobs, pobs)
    sa, sb = x, o
    for s in range(4):
        sa, sb, so = hms.multisweep_planes(sa, sb, seeds[s:s + 1], **kw)
        assert torch.equal(so[:, 0], kobs[:, s])
    flat = hms.merge_flat(hms.unpack_flat(ka, m), hms.unpack_flat(kb, m))
    exact = torch.stack([model.magne_sum(flat), model.energy_sum(flat)], -1)
    assert torch.equal(kobs[:, -1], exact)


@pytest.mark.cuda
@pytest.mark.parametrize("kbt", [KBT, 1e9, 0.5, 0.2])
@pytest.mark.parametrize("nx,ny,nrep", [(131, 62, 3), (1001, 1000, 1),
                                        (2001, 2000, 1)])
def test_helical_kernel_wraps_at_chain_edges(cuda, kbt, nx, ny, nrep):
    """The unrolled chains at Tc and at the chain edges (kbt 1e9: both
    chains draw twenty words; 0.5: B8 draws none; 0.2: neither draws),
    staged and in device memory: S = 3 sweeps against the plain version
    and three one-sweep launches, the (m, e) bitwise."""
    from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
        helical_multispin as hms,
    )
    m = nx * ny // 2
    x, o, _, _ = _helical_vectors(cuda, nrep, m, nx + nrep)
    seeds = hms.sweep_seed_pairs(rng.sample_key(rng.base_key(7), 1), 3)
    kw = dict(beta=1 / kbt, nx=nx, m=m)
    ka, kb, kobs = hms.multisweep_planes(x, o, seeds, **kw)
    pa, pb, pobs = hms.multisweep_plain(x, o, seeds, **kw)
    vm = hms.valid_mask(m, cuda)
    for w, want in zip((ka, kb), (pa, pb)):
        assert torch.equal(hms._u32(w) & vm, hms._u32(want) & vm)
    assert torch.equal(kobs, pobs)
    sa, sb = x, o
    for s in range(3):
        sa, sb, so = hms.multisweep_planes(sa, sb, seeds[s:s + 1], **kw)
        assert torch.equal(so[:, 0], kobs[:, s])
    assert torch.equal(hms._u32(sa) & vm, hms._u32(ka) & vm)


@pytest.mark.cuda
def test_helical_entry_refuses_a_bad_chain_table(cuda):
    """The C entry point checks the table again (chain_table_ok): ends
    past the 60 draws are refused before any launch."""
    import ctypes

    from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
        helical_multispin as hms,
    )
    from cuda_fortran_mc_simulation_spin_tpu_torch.ops import multispin_rng
    nx, ny = 131, 62
    m = nx * ny // 2
    x, o, _, _ = _helical_vectors(cuda, 1, m, 3)
    out = [torch.empty_like(x), torch.empty_like(o)]
    seeds = hms.keys_to(hms.sweep_seed_pairs(rng.base_key(1), 1), cuda)
    obs = torch.empty((1, 1, 2), dtype=torch.int64, device=cuda)
    table = list(multispin_rng.chain_table(msb.chain_words(1 / KBT) + (0,)))
    table[-1] = 61
    bad = (ctypes.c_uint * len(table))(*table)
    lib = hms._lib()
    da, db = ([d % m for d in offs] for offs in hms.helical_offsets(nx))
    code = lib.helical_multisweep(
        x.data_ptr(), o.data_ptr(), out[0].data_ptr(), out[1].data_ptr(),
        seeds.data_ptr(), None, None, obs.data_ptr(), 1, hms.words(m), m, 1,
        0, 1, *da, *db, bad, msb._stream(x))
    assert code != 0


@pytest.mark.cuda
@pytest.mark.parametrize("color", [0, 1])
def test_ising3d_phase_kernel_matches_plain(cuda, color):
    from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
        ising3d_multispin as ms3,
    )
    g = np.random.default_rng(color)
    x, o, b4, b8, b12 = (torch.from_numpy(g.integers(
        -2 ** 31, 2 ** 31, size=(2, 4, 8, 128), dtype=np.int64).astype(
            np.int32)).to(cuda) for _ in range(5))
    assert torch.equal(
        ms3.phase3d_packed_with_bits(x, o, b4, b8, b12, color=color),
        ms3.packed_phase3d_reference(x, o, color, b4, b8, b12))
    seeds = rng.seeds_from_key(rng.base_key(3), color)
    got, obs = ms3.phase3d_packed(x, o, seeds, color=color, beta=1 / 4.51152,
                                  measuring=True)
    want, wobs = ms3.phase3d_plain(x, o, seeds, color=color,
                                   beta=1 / 4.51152, measuring=True)
    assert torch.equal(got, want) and torch.equal(obs, wobs)


@pytest.mark.cuda
def test_ising3d_multisweep_kernel_matches_phase_pairs(cuda):
    from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
        ising3d_multispin as ms3,
    )
    g = np.random.default_rng(7)
    wa, wb = (torch.from_numpy(g.integers(
        -2 ** 31, 2 ** 31, size=(2, 4, 8, 128), dtype=np.int64).astype(
            np.int32)).to(cuda) for _ in range(2))
    seeds = ms3.sweep_seed_pairs(rng.sample_key(rng.base_key(1), 0), 6)
    beta = 1 / 4.51152
    ka, kb, kobs = ms3.multisweep3d_planes(wa, wb, seeds, beta=beta)
    pa, pb, obs = wa, wb, []
    for s in range(6):
        pa = ms3.phase3d_packed(pa, pb, seeds[s, 0], color=0, beta=beta)
        pb, o = ms3.phase3d_packed(pb, pa, seeds[s, 1], color=1, beta=beta,
                                   measuring=True)
        obs.append(o)
    assert torch.equal(ka, pa) and torch.equal(kb, pb)
    assert torch.equal(kobs, torch.stack(obs, dim=1))
    qa, qb, qobs = ms3.multisweep3d_plain(wa, wb, seeds, beta=beta)
    assert torch.equal(ka, qa) and torch.equal(kb, qb)
    assert torch.equal(kobs, qobs)


def _h3():
    from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
        helical3d_multispin as h3,
    )
    return h3


# odd nx*ny with a partial last word (M = 126: 30 bits), even nx*ny with
# several z-planes a word (zh = 36), and the 151^3 and 101x100x100 classes
H3_SHAPES = [(9, 7, 4), (9, 8, 6), (151, 151, 150), (101, 100, 100)]
KBT3 = 4.511454583186711


@pytest.mark.cuda
@pytest.mark.parametrize("nx,ny,nz", H3_SHAPES)
def test_helical3d_phase_kernel_matches_plain(cuda, nx, ny, nz):
    """phase_kernel against its plain version on the valid bits, in every
    mode: injected bits, Philox words, each z-parity sub-phase (even
    nx*ny), and the fused (m, e)."""
    from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
        helical_multispin as hms,
    )
    h3 = _h3()
    nxy, m = nx * ny, nx * ny * nz // 2
    x, o, b4, b8 = _helical_vectors(cuda, 2, m, nx)
    b12 = _helical_vectors(cuda, 2, m, nx + 1)[0]
    vm = hms.valid_mask(m, cuda)
    kw = dict(nx=nx, nxy=nxy, m=m)
    zsubs = (None,) if nxy % 2 else (0, 1)
    for color in (0, 1):
        for zsub in zsubs:
            got = h3.phase_packed_with_bits(x, o, b4, b8, b12, color=color,
                                            zsub=zsub, **kw)
            want = h3.phase_packed_with_bits(
                *(v.cpu() for v in (x, o, b4, b8, b12)), color=color,
                zsub=zsub, **kw)
            assert torch.equal(hms._u32(got.cpu()) & vm.cpu(),
                               hms._u32(want) & vm.cpu())
            seeds = rng.seeds_from_key(rng.base_key(5), 2 * color + (zsub or 0))
            got, gobs = h3.phase_packed(x, o, seeds, color=color, zsub=zsub,
                                        beta=1 / KBT3, measuring=True, **kw)
            want, wobs = h3.phase_plain(x, o, seeds, color=color, zsub=zsub,
                                        beta=1 / KBT3, measuring=True, **kw)
            assert torch.equal(hms._u32(got) & vm, hms._u32(want) & vm)
            assert torch.equal(gobs, wobs)


# temperatures whose chain digits (q4, q8, q12) differ in trailing zeros:
# the classes' 4.5115 (3, 0, 1), 3.0 (1, 0, 0), 8.0 (0, 1, 0); 0.5 has
# q8 = q12 = 0 (chains of no draw, the boundaries after the last draw);
# 0.2 has every q = 0 (no draw at all); 1e9 every q = 2^20 - 1 (60 draws)
H3_CHAIN_KBTS = [4.511454583186711, 3.0, 8.0, 0.5, 0.2, 1e9]


@pytest.mark.cuda
@pytest.mark.parametrize("kbt", H3_CHAIN_KBTS)
@pytest.mark.parametrize("nx,ny,nz", [(9, 7, 4), (9, 8, 6)])
def test_helical3d_phase_kernel_chain_edges(cuda, kbt, nx, ny, nz):
    """phase_kernel's unrolled chains against the plain chains at digits
    of every kind, on the valid bits and the fused (m, e): both colours,
    each z-parity sub-phase at even nx*ny."""
    from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
        helical_multispin as hms,
        ising3d_multispin as ms3,
    )
    h3 = _h3()
    q = ms3.chain_words3d(1 / kbt)
    low = [(v & -v).bit_length() - 1 if v else None for v in q]
    assert {0.5: q[1:] == (0, 0), 0.2: q == (0, 0, 0),
            1e9: q == (2 ** 20 - 1,) * 3}.get(kbt, len(set(low)) > 1)
    nxy, m = nx * ny, nx * ny * nz // 2
    x, o = _helical_vectors(cuda, 3, m, nz)[:2]
    vm = hms.valid_mask(m, cuda)
    kw = dict(nx=nx, nxy=nxy, m=m, beta=1 / kbt)
    for color in (0, 1):
        for zsub in (None,) if nxy % 2 else (0, 1):
            seeds = rng.seeds_from_key(rng.base_key(9), 2 * color + (zsub or 0))
            got, gobs = h3.phase_packed(x, o, seeds, color=color, zsub=zsub,
                                        measuring=True, **kw)
            want, wobs = h3.phase_plain(x, o, seeds, color=color, zsub=zsub,
                                        measuring=True, **kw)
            assert torch.equal(hms._u32(got) & vm, hms._u32(want) & vm)
            assert torch.equal(gobs, wobs)


def _volumes(dev, shape, seed, n):
    g = np.random.default_rng(seed)
    return [torch.from_numpy(g.integers(-2 ** 31, 2 ** 31, size=shape,
                                        dtype=np.int64).astype(np.int32)
                             ).to(dev) for _ in range(n)]


@pytest.mark.cuda
@pytest.mark.parametrize("kbt", [KBT, 0.5, 1e9, 0.2])
def test_phase_kernel_wraps_at_chain_edges(cuda, kbt):
    """The 2-D phase_kernel where every neighbour wraps (nyp = 8 word rows,
    half = 32 words: one tile) at chain digits of every kind (kbt 1e9:
    both chains draw twenty words; 0.5: B8 none; 0.2: neither): injected
    planes, Philox words plain and measuring, both colours, bitwise
    against the plain versions; and the halo mode on a ragged shard at
    global offsets, with and without word-column halos."""
    x, o, b4, b8 = _planes(cuda, nrep=3, ny=256, nx=64, seed=21)
    for color in (0, 1):
        assert torch.equal(
            msb.phase_packed_with_bits(x, o, b4, b8, color=color),
            msb.packed_phase_reference(x, o, color, b4, b8))
        seeds = rng.seeds_from_key(rng.base_key(15), color)
        kw = dict(color=color, beta=1 / kbt)
        assert torch.equal(msb.phase_packed(x, o, seeds, **kw),
                           msb.phase_packed_plain(x, o, seeds, **kw))
        got, obs = msb.phase_packed(x, o, seeds, measuring=True, **kw)
        want, wobs = msb.phase_packed_plain(x, o, seeds, measuring=True,
                                            **kw)
        assert torch.equal(got, want) and torch.equal(obs, wobs)
        sx, so = x[:, :5, :19].contiguous(), o[:, :5, :19].contiguous()
        up, dn = ((t[:, :1] & 1).contiguous() for t in (b4[:, :1, :19],
                                                       b8[:, :1, :19]))
        lf, rt = (t[:, :5, :1].contiguous() for t in (b4, b8))
        for cols in ({}, dict(halo_lf=lf, halo_rt=rt)):
            offs = (2, 9, 3) if cols else (2, 9)
            got = msb.sharded_phase_packed(sx, so, up, dn, seeds, offs,
                                           measuring=True, **kw, **cols)
            want = msb.sharded_phase_packed_plain(sx, so, up, dn, seeds,
                                                  offs, measuring=True,
                                                  **kw, **cols)
            assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("kbt", [KBT, 0.5, 1e9])
@pytest.mark.parametrize("nrep", [1, 5])
def test_multisweep_kernel_wraps_at_chain_edges(cuda, kbt, nrep):
    """multisweep_kernel where every neighbour wraps, 4 sweeps, against
    streamed phase pairs and its plain version (state and the exact (m, e)
    of every sweep); five replicas of 2 x 2 tiles spread a block's tiles
    over replicas."""
    wa, wb = _planes(cuda, nrep=nrep, ny=512, nx=128, seed=23)[:2]
    seeds = msb.sweep_seed_pairs(rng.sample_key(rng.base_key(4), 1), 4)
    beta = 1 / kbt
    ka, kb, kobs = msb.multisweep_planes(wa, wb, seeds, beta=beta)
    pa, pb, obs = wa, wb, []
    for s in range(4):
        pa = msb.phase_packed(pa, pb, seeds[s, 0], color=0, beta=beta)
        pb, o = msb.phase_packed(pb, pa, seeds[s, 1], color=1, beta=beta,
                                 measuring=True)
        obs.append(o)
    assert torch.equal(ka, pa) and torch.equal(kb, pb)
    assert torch.equal(kobs, torch.stack(obs, dim=1))
    qa, qb, qobs = msb.multisweep_planes_plain(wa, wb, seeds, beta=beta)
    assert torch.equal(ka, qa) and torch.equal(kb, qb)
    assert torch.equal(kobs, qobs)


@pytest.mark.cuda
@pytest.mark.parametrize("kbt", H3_CHAIN_KBTS)
def test_ising3d_phase_kernel_wraps_at_chain_edges(cuda, kbt):
    """The periodic 3-D phase_kernel where every neighbour wraps (nz = 2
    planes, nyp = 8 word rows, half = 32 words: one column tile) at chain
    digits of every kind: injected planes, Philox words plain and
    measuring, both colours, bitwise against the plain versions."""
    from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
        ising3d_multispin as ms3,
    )
    x, o, b4, b8, b12 = _volumes(cuda, (3, 2, 8, 32), 11, 5)
    for color in (0, 1):
        assert torch.equal(
            ms3.phase3d_packed_with_bits(x, o, b4, b8, b12, color=color),
            ms3.packed_phase3d_reference(x, o, color, b4, b8, b12))
        seeds = rng.seeds_from_key(rng.base_key(13), color)
        kw = dict(color=color, beta=1 / kbt)
        assert torch.equal(ms3.phase3d_packed(x, o, seeds, **kw),
                           ms3.phase3d_plain(x, o, seeds, **kw))
        got, obs = ms3.phase3d_packed(x, o, seeds, measuring=True, **kw)
        want, wobs = ms3.phase3d_plain(x, o, seeds, measuring=True, **kw)
        assert torch.equal(got, want) and torch.equal(obs, wobs)


@pytest.mark.cuda
@pytest.mark.parametrize("kbt", [4.51152, 0.5, 1e9])
def test_ising3d_multisweep_kernel_wraps_at_chain_edges(cuda, kbt):
    """multisweep_kernel on a volume where every neighbour wraps, 4 sweeps,
    against streamed phase pairs and its plain version (state and the
    exact (m, e) of every sweep)."""
    from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
        ising3d_multispin as ms3,
    )
    wa, wb = _volumes(cuda, (3, 2, 8, 64), 17, 2)
    seeds = ms3.sweep_seed_pairs(rng.sample_key(rng.base_key(4), 1), 4)
    beta = 1 / kbt
    ka, kb, kobs = ms3.multisweep3d_planes(wa, wb, seeds, beta=beta)
    pa, pb, obs = wa, wb, []
    for s in range(4):
        pa = ms3.phase3d_packed(pa, pb, seeds[s, 0], color=0, beta=beta)
        pb, o = ms3.phase3d_packed(pb, pa, seeds[s, 1], color=1, beta=beta,
                                   measuring=True)
        obs.append(o)
    assert torch.equal(ka, pa) and torch.equal(kb, pb)
    assert torch.equal(kobs, torch.stack(obs, dim=1))
    qa, qb, qobs = ms3.multisweep3d_plain(wa, wb, seeds, beta=beta)
    assert torch.equal(ka, qa) and torch.equal(kb, qb)
    assert torch.equal(kobs, qobs)


@pytest.mark.cuda
@pytest.mark.parametrize("nx,ny,nz", H3_SHAPES)
def test_helical3d_energy_kernel_matches_plain_and_exact_sums(cuda, nx, ny,
                                                              nz):
    from cuda_fortran_mc_simulation_spin_tpu_torch.models import (
        Ising3DHelical,
    )
    from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
        helical_multispin as hms,
    )
    h3 = _h3()
    model = Ising3DHelical(nx, ny, nz, KBT3)
    m = model.nsites // 2
    wa, wb = _helical_vectors(cuda, 3, m, ny)[:2]
    kw = dict(nx=nx, nxy=model.nxy, m=m)
    got = h3.energy_sums(wa, wb, **kw)
    assert torch.equal(got, h3.energy_sums_plain(wa, wb, **kw))
    flat = hms.merge_flat(hms.unpack_flat(wa, m), hms.unpack_flat(wb, m))
    assert torch.equal(got[:, 0], model.magne_sum(flat))
    assert torch.equal(got[:, 1], model.energy_sum(flat))


@pytest.mark.cuda
@pytest.mark.parametrize("nx,ny,nz", [(9, 7, 4), (151, 151, 150)])
def test_helical3d_multisweep_kernel_matches_streamed_phases(cuda, nx, ny,
                                                             nz):
    """S sweeps in one launch against S streamed phase-kernel pairs and
    against the plain version, on the valid bits and the (m, e)."""
    from cuda_fortran_mc_simulation_spin_tpu_torch.models import (
        Ising3DHelical,
    )
    from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
        helical_multispin as hms,
    )
    h3 = _h3()
    model = Ising3DHelical(nx, ny, nz, KBT3)
    m = model.nsites // 2
    wa, wb = _helical_vectors(cuda, 2, m, nz)[:2]
    key = rng.sample_key(rng.base_key(6), 0)
    ka, kb, kobs = h3.multisweep(model, wa, wb, key, 6, t0=3)
    sa, sb, sobs = h3.multisweep_stream(model, wa, wb, key, 6, t0=3)
    pa, pb, pobs = h3.multisweep_plain(
        wa, wb, h3.sweep_keys(model, key, 6, 3), beta=model.beta, nx=nx,
        nxy=model.nxy, m=m)
    vm = hms.valid_mask(m, cuda)
    for got, *wants in ((ka, sa, pa), (kb, sb, pb)):
        for want in wants:
            assert torch.equal(hms._u32(got) & vm, hms._u32(want) & vm)
    for k, col in (("m", 0), ("e", 1)):
        assert torch.equal(kobs[k], sobs[k])
        assert torch.equal(kobs[k],
                           msb.per_site(pobs[..., col], model.nsites))


# the clock kernels: periodic q = 6, 4, 3 on an aligned shape (256x256)
# and padded ones (248x248: 24 real bits in the top word; 2000x2000, the
# reference's literal geometry); helical q = 6 staged in shared memory
# (61x50: a partial last word; 501x500) and in device memory (1001x1000)
KBT_CLOCK = 0.91


def _clock_planes(dev, nrep, nyw, half, n, seed, ny):
    from cuda_fortran_mc_simulation_spin_tpu_torch.ops import clock_planes
    g = np.random.default_rng(seed)
    mask = clock_planes.real_mask(nyw, half, ny % 32).numpy()
    return [torch.from_numpy((g.integers(0, 2 ** 32, size=(nrep, nyw, half),
                                         dtype=np.int64) & mask).astype(
        np.uint32).view(np.int32)).to(dev) for _ in range(n)]


@pytest.mark.cuda
@pytest.mark.parametrize("q", [6, 4, 3])
@pytest.mark.parametrize("ny,nx", [(256, 256), (248, 248), (2000, 2000)])
def test_clock_phase_kernel_matches_plain(cuda, q, ny, nx):
    """phase_kernel against its plain version, bitwise, both colours, in
    injected and Philox mode, measuring and not."""
    from cuda_fortran_mc_simulation_spin_tpu_torch.ops import clock_planes
    spec = sweep.CLOCK_SPECS[q]
    half, nyw = nx // 2, -(-ny // 32)
    planes = _clock_planes(cuda, 2, nyw, half, 2 * spec.n_state
                           + spec.n_rand, q + ny, ny)
    x = tuple(planes[:spec.n_state])
    o = tuple(planes[spec.n_state:2 * spec.n_state])
    rand = planes[2 * spec.n_state:]
    if q == 6:
        rand[2] = rand[2] & ~rand[1]
        rand[0] = rand[0] | ~(rand[1] | rand[2])
    for color in (0, 1):
        got = clock_planes.phase_packed_inject(spec, x, o, rand,
                                               color=color, ny=ny)
        want = clock_planes.phase_reference(spec, x, o, color, rand, ny)
        for g_, w_ in zip(got, want):
            assert torch.equal(g_, w_)
        seeds = rng.seeds_from_key(rng.base_key(4), color)
        for measuring in (False, True):
            got = clock_planes.phase_packed(spec, x, o, seeds, color=color,
                                            beta=1 / KBT_CLOCK, ny=ny,
                                            measuring=measuring)
            want = clock_planes.phase_plain(spec, x, o, seeds, color=color,
                                            beta=1 / KBT_CLOCK, ny=ny,
                                            measuring=measuring)
            if measuring:
                assert torch.equal(got[1], want[1])
                got, want = got[0], want[0]
            for g_, w_ in zip(got, want):
                assert torch.equal(g_, w_)


@pytest.mark.cuda
@pytest.mark.parametrize("q", [6, 4, 3])
@pytest.mark.parametrize("kbt", [0.8, 1e9, 0.12, 0.05])
def test_clock_phase_kernel_draw_table_matches_plain(cuda, q, kbt):
    """phase_kernel's unrolled draw (its launch's table) against the plain
    version at the clock classes' and extreme temperatures (chains of 12
    digits, all ones; of up to 28 digits, some empty), both colours,
    measuring and not, on a ragged shape: 3 x 200 rows (7 word rows, 8
    real rows in the top one, a partial word-row tile) x 140 columns (70
    words, a partial column tile)."""
    from cuda_fortran_mc_simulation_spin_tpu_torch.ops import clock_planes
    spec = sweep.CLOCK_SPECS[q]
    ny, half = 200, 70
    nyw = -(-ny // 32)
    planes = _clock_planes(cuda, 3, nyw, half, 2 * spec.n_state, q, ny)
    x = tuple(planes[:spec.n_state])
    o = tuple(planes[spec.n_state:])
    for color in (0, 1):
        seeds = rng.seeds_from_key(rng.base_key(5), color)
        for measuring in (False, True):
            kw = dict(color=color, beta=1 / kbt, ny=ny, measuring=measuring)
            got = clock_planes.phase_packed(spec, x, o, seeds, **kw)
            want = clock_planes.phase_plain(spec, x, o, seeds, **kw)
            if measuring:
                assert torch.equal(got[1], want[1])
                got, want = got[0], want[0]
            for g_, w_ in zip(got, want):
                assert torch.equal(g_, w_)


@pytest.mark.cuda
def test_clock_runner_equals_cpu_runner(cuda):
    """The periodic clock runner gives the same series on the card as its
    plain versions on the CPU (padded 248x248, q = 6)."""
    from cuda_fortran_mc_simulation_spin_tpu_torch.models import Clock2D
    model = Clock2D(nx=248, ny=248, kbt=KBT_CLOCK, q=6)
    key = rng.sample_key(rng.base_key(42), 0)
    on_card = sweep.make_clock_multispin_runner(model, 6, 2, "random",
                                                device=cuda)(key)
    on_cpu = sweep.make_clock_multispin_runner(model, 6, 2, "random",
                                               device="cpu")(key)
    for k in ("m", "e"):
        assert torch.equal(on_card[k].cpu(), on_cpu[k])


@pytest.mark.cuda
@pytest.mark.parametrize("nx,ny", [(61, 50), (501, 500), (1001, 1000)])
def test_clock_helical_kernel_matches_plain(cuda, nx, ny):
    """Injected mode on the valid bits; S sweeps against the plain version
    and S one-sweep launches; the fused (2m, 2e, my2) against the sums of
    the final state."""
    from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
        clock_helical_multispin as chm,
    )
    from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
        helical_multispin as hms,
    )
    m = nx * ny // 2
    vm = hms.valid_mask(m, cuda)
    g = np.random.default_rng(nx)
    vecs = [torch.from_numpy(g.integers(-2 ** 31, 2 ** 31,
                                        size=(2, hms.words(m)),
                                        dtype=np.int64).astype(np.int32)
                             ).to(cuda) for _ in range(14)]
    a3, b3, p8 = tuple(vecs[:3]), tuple(vecs[3:6]), vecs[6:]
    p8[2] = p8[2] & ~p8[1]
    p8[0] = p8[0] | ~(p8[1] | p8[2])
    for offs in hms.helical_offsets(nx):
        got = chm.phase_packed_with_bits(a3, b3, p8, offs=offs, m=m)
        want = chm.packed_helical_phase6_reference(a3, b3, offs, p8, m)
        for g_, w_ in zip(got, want):
            assert torch.equal(hms._u32(g_) & vm, hms._u32(w_) & vm)
    assert chm.staged_fits(hms.words(m), cuda) == (nx < 1001)
    seeds = hms.sweep_seed_pairs(rng.sample_key(rng.base_key(2), 0), 4)
    kw = dict(beta=1 / 0.8, nx=nx, m=m)
    ka, kb, kobs = chm.multisweep_planes(a3, b3, seeds, **kw)
    pa, pb, pobs = chm.multisweep_plain(a3, b3, seeds, **kw)
    for g_, w_ in zip(ka + kb, pa + pb):
        assert torch.equal(hms._u32(g_) & vm, hms._u32(w_) & vm)
    assert torch.equal(kobs, pobs)
    sa, sb = a3, b3
    for s in range(4):
        sa, sb, so = chm.multisweep_planes(sa, sb, seeds[s:s + 1], **kw)
        assert torch.equal(so[:, 0], kobs[:, s])
    assert torch.equal(kobs[:, -1], chm.obs_packed6_reference(ka, kb, nx, m))


KBT_XY = 0.89


def _xy_planes(dev, nrep, ny, nx, seed):
    """A random XY state (ax, ay, bx, by) of float32 unit vectors."""
    g = np.random.default_rng(seed)
    th = g.uniform(0.0, 2 * np.pi, size=(2, nrep, ny, nx // 2))
    return [torch.from_numpy(f(th[c]).astype(np.float32)).to(dev)
            for c in (0, 1) for f in (np.cos, np.sin)]


def _xy_sums_close(got, want):
    """The kernel's and the plain version's float64 sums of the same
    float32 values, added in other orders: 1e-9 relative."""
    scale = want.abs().clamp(min=1.0)
    assert torch.all((got - want).abs() <= 1e-9 * scale), (got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("ny,nx", [(16, 84), (256, 200), (2000, 2000)])
def test_xy_kernels_match_plain(cuda, ny, nx):
    """metropolis_kernel (injected and Philox uniforms) and
    over_relax_kernel against their plain versions on the same CUDA
    tensors, both colours, measuring and not: the state bitwise, the sums
    to float64 rounding."""
    from cuda_fortran_mc_simulation_spin_tpu_torch.ops import xy2d_pallas
    planes = _xy_planes(cuda, 2, ny, nx, nx + ny)
    g = np.random.default_rng(ny)
    u = tuple(torch.from_numpy(g.random((2, ny, nx // 2), dtype=np.float32)
                               ).to(cuda) for _ in range(2))
    for color in (0, 1):
        order = (0, 1, 2, 3) if color == 0 else (2, 3, 0, 1)
        seeds = rng.seeds_from_key(rng.base_key(8), color)
        for measuring in (False, True):
            runs = (
                (xy2d_pallas.metropolis_phase,
                 xy2d_pallas.metropolis_phase_plain,
                 dict(beta=1 / KBT_XY), (u,)),
                (xy2d_pallas.metropolis_phase,
                 xy2d_pallas.metropolis_phase_plain,
                 dict(beta=1 / KBT_XY), (seeds,)),
                (xy2d_pallas.over_relax_phase,
                 xy2d_pallas.over_relax_phase_plain, {}, ()))
            for kernel, plain, kw, extra in runs:
                a = [planes[i].clone() for i in order]
                b = [planes[i].clone() for i in order]
                got = kernel(*a, *extra, color=color, measuring=measuring,
                             **kw)
                want = plain(*b, *extra, color=color, measuring=measuring,
                             **kw)
                assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
                if measuring:
                    _xy_sums_close(got[2], want[2])


@pytest.mark.cuda
def test_xy_runner_on_card_replays_plain_phases(cuda):
    """The XY runner with over-relaxation on the card: its series equal a
    replay of the plain phases on the card with the same keys, to float64
    rounding of the sums."""
    from cuda_fortran_mc_simulation_spin_tpu_torch.models import XY2D
    from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
        multispin_rng,
        xy2d_pallas,
    )
    model = XY2D(nx=200, ny=256, kbt=KBT_XY)
    key = rng.sample_key(rng.base_key(42), 0)
    series = sweep.make_xy_runner(model, 4, 2, "random", n_over_relax=2,
                                  mcs_over_relax=2, device=cuda)(key)
    st = sweep._init_state(model, "random", 2, key, cuda)
    seeds = multispin_rng.sweep_phase_keys(key, 4)
    for t in range(4):
        ax, ay, bx, by = st
        xy2d_pallas.metropolis_phase_plain(ax, ay, bx, by, seeds[t, 0],
                                           color=0, beta=model.beta)
        out = xy2d_pallas.metropolis_phase_plain(
            bx, by, ax, ay, seeds[t, 1], color=1, beta=model.beta,
            measuring=t >= 2)
        if t < 2:
            for last in (False, True):
                xy2d_pallas.over_relax_phase_plain(ax, ay, bx, by, color=0)
                out = xy2d_pallas.over_relax_phase_plain(
                    bx, by, ax, ay, color=1, measuring=last)
        for j, k in enumerate(("m", "my", "e")):
            _xy_sums_close(series[k][:, t] * model.nsites, out[2][:, j])


def _xy_state(planes):
    from cuda_fortran_mc_simulation_spin_tpu_torch.models.xy2d import XYState
    return XYState(*(p.clone() for p in planes))


@pytest.mark.cuda
@pytest.mark.parametrize("ny,nx", [(16, 84), (256, 200), (1500, 1500)])
def test_xy_snapshot_phase_and_measure_match_plain(cuda, ny, nx):
    """metropolis_kernel's snapshot mode (injected and Philox uniforms,
    both colours) and measure_kernel (with and without a snapshot)
    against their plain versions on the same CUDA tensors: the state
    bitwise, the sums to float64 rounding."""
    from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
        xy2d_measure_pallas,
        xy2d_pallas,
    )
    planes = _xy_planes(cuda, 2, ny, nx, nx + ny + 1)
    snap = _xy_planes(cuda, 2, ny, nx, nx + ny + 2)
    g = np.random.default_rng(ny + 1)
    u = tuple(torch.from_numpy(g.random((2, ny, nx // 2), dtype=np.float32)
                               ).to(cuda) for _ in range(2))
    for color in (0, 1):
        order = (0, 1, 2, 3) if color == 0 else (2, 3, 0, 1)
        sn = [snap[i] for i in order]
        seeds = rng.seeds_from_key(rng.base_key(9), color)
        for rand in (u, seeds):
            a = [planes[i].clone() for i in order]
            b = [planes[i].clone() for i in order]
            got = xy2d_pallas.metropolis_phase(*a, rand, color=color,
                                               beta=1 / KBT_XY, snap=sn)
            want = xy2d_pallas.metropolis_phase_plain(
                *b, rand, color=color, beta=1 / KBT_XY, snap=sn)
            assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
            assert got[2].shape == (2, 4)
            _xy_sums_close(got[2], want[2])
    st, sn = _xy_state(planes), _xy_state(snap)
    for s in (None, sn):
        _xy_sums_close(xy2d_measure_pallas.measure_sums(st, s),
                       xy2d_measure_pallas.measure_sums_plain(st, s))


@pytest.mark.cuda
@pytest.mark.parametrize("ny,nx,nrep", [(256, 200, 2), (64, 1500, 3)])
def test_xy_multisweep_matches_streamed_sweeps(cuda, ny, nx, nrep):
    """multisweep_planes (the fit rule's mode): S = 8 sweeps equal 8
    streamed snapshot-measuring sweeps on the card bitwise, state and
    sums, and its plain version; phase_with_bits equals the plain
    phase."""
    from cuda_fortran_mc_simulation_spin_tpu_torch.models import XY2D
    from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
        multispin_rng,
        xy2d_pallas,
        xy2d_resident,
    )
    model = XY2D(nx=nx, ny=ny, kbt=KBT_XY)
    planes = _xy_planes(cuda, nrep, ny, nx, 3)
    snap = _xy_state(_xy_planes(cuda, nrep, ny, nx, 4))
    seeds = multispin_rng.sweep_phase_keys(rng.sample_key(rng.base_key(5), 0),
                                           8)
    ms = _xy_state(planes)
    kobs = xy2d_resident.multisweep_planes(ms, snap, seeds, beta=model.beta)
    st = _xy_state(planes)
    for s in range(8):
        st, obs = xy2d_pallas.sweep_measure(model, st, snap, seeds[s])
        for j, k in enumerate(("mx", "my", "e", "A")):
            assert torch.equal(msb.per_site(kobs[:, s, j], model.nsites),
                               obs[k])
    assert all(torch.equal(p, q) for p, q in zip(ms, st))
    pl = _xy_state(planes)
    pobs = xy2d_resident.multisweep_planes_plain(pl, snap, seeds,
                                                 beta=model.beta)
    assert all(torch.equal(p, q) for p, q in zip(ms, pl))
    _xy_sums_close(kobs, pobs)
    g = np.random.default_rng(nx)
    u = [torch.from_numpy(g.random((nrep, ny, nx // 2), dtype=np.float32)
                          ).to(cuda) for _ in range(2)]
    for color in (0, 1):
        order = (0, 1, 2, 3) if color == 0 else (2, 3, 0, 1)
        a = [planes[i].clone() for i in order]
        b = [planes[i].clone() for i in order]
        xy2d_resident.phase_with_bits(*a, *u, color=color, beta=model.beta)
        xy2d_resident.phase_with_bits_plain(*b, *u, color=color,
                                            beta=model.beta)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.cuda
@pytest.mark.parametrize("prep", ["rotate_first", "fix1mcs"])
def test_xy_disorder_routes_agree_on_card(cuda, prep, monkeypatch):
    """The disorder runner's resident and streamed routes on the card give
    the same series bitwise (fix1mcs: the streamed first sweep, then the
    multisweep from t = 2)."""
    from cuda_fortran_mc_simulation_spin_tpu_torch.models import XY2D
    from cuda_fortran_mc_simulation_spin_tpu_torch.ops import xy2d_resident
    model = XY2D(nx=200, ny=256, kbt=KBT_XY)
    key = rng.sample_key(rng.base_key(43), 0)
    runs = []
    for bound in (10 ** 12, 0):
        monkeypatch.setattr(xy2d_resident, "RESIDENT_MAX_SITES", bound)
        run = sweep.make_xy_disorder_runner(model, 70, 2, prep, device=cuda)
        assert run.engine == (sweep.XY_DISORDER_RESIDENT if bound
                              else sweep.XY_DISORDER_STREAMED)
        runs.append(run(key))
    for k in ("mx", "my", "e", "A"):
        assert runs[0][k].shape == (2, 70)
        assert torch.equal(runs[0][k], runs[1][k]), k


def _multisweep_against_streamed(cuda, ny, nx, nrep, sweeps, grid):
    """One multisweep launch of ``sweeps`` sweeps (``grid`` forcing the
    device-memory mode, else the fit rule's) against as many streamed
    snapshot-measuring sweeps on the card: the state and the sums
    bitwise; the launch counted in its mode's key."""
    from cuda_fortran_mc_simulation_spin_tpu_torch.models import XY2D
    from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
        multispin_rng,
        xy2d_pallas,
        xy2d_resident,
    )
    model = XY2D(nx=nx, ny=ny, kbt=KBT_XY)
    planes = _xy_planes(cuda, nrep, ny, nx, 7 + ny)
    snap = _xy_state(_xy_planes(cuda, nrep, ny, nx, 8 + ny))
    seeds = multispin_rng.sweep_phase_keys(
        rng.sample_key(rng.base_key(6), 1), sweeps)
    ms = _xy_state(planes)
    xy2d_resident.reset_launches()
    kobs = xy2d_resident.multisweep_planes(ms, snap, seeds, beta=model.beta,
                                           grid=grid)
    key = ("multisweep" if grid or xy2d_resident.device_layout(ms) is None
           else "multisweep_smem")
    assert xy2d_resident.LAUNCHES[key] == 1
    st = _xy_state(planes)
    for s in range(sweeps):
        st, obs = xy2d_pallas.sweep_measure(model, st, snap, seeds[s])
        for j, k in enumerate(("mx", "my", "e", "A")):
            assert torch.equal(msb.per_site(kobs[:, s, j], model.nsites),
                               obs[k]), (s, k)
    assert all(torch.equal(p, q) for p, q in zip(ms, st))


@pytest.mark.cuda
@pytest.mark.parametrize("ny,nx,nrep,sweeps", [(1500, 1500, 1, 8),
                                               (1000, 1000, 1, 5),
                                               (8, 1500, 1, 8),
                                               (256, 200, 5, 3),
                                               (2, 6, 3, 4)])
def test_xy_smem_multisweep_matches_streamed_sweeps(cuda, ny, nx, nrep,
                                                    sweeps):
    """smem_multisweep_kernel equals S streamed sweep_measure calls
    bitwise, state and sums: the literal 1500x1500 (a last chunk of 136
    sites), 1000x1000, 8 x 1500 (a ring shrunk to blocks of at least a
    row: 24 chunks on 7 blocks), five replicas each on its own ring, and
    one-block rings of a tiny lattice; the layout is the fit rule's."""
    from cuda_fortran_mc_simulation_spin_tpu_torch.models.xy2d import XYState
    from cuda_fortran_mc_simulation_spin_tpu_torch.ops import xy2d_resident
    st = XYState(*_xy_planes(cuda, nrep, ny, nx, 1))
    layout = xy2d_resident.device_layout(st)
    assert layout is not None
    n = ny * nx // 2
    owned = [min(b * 256, n) - a * 256
             for a, b in zip(layout.bounds, layout.bounds[1:])]
    assert min(owned) >= nx // 2
    if (ny, nx) == (8, 1500):
        assert layout.blocks == 7
    _multisweep_against_streamed(cuda, ny, nx, nrep, sweeps, False)


@pytest.mark.cuda
@pytest.mark.parametrize("ny,nx,nrep", [(1500, 1500, 2), (1500, 1500, 3),
                                        (1000, 1000, 5), (64, 64, 1600),
                                        (64, 1500, 3)])
def test_xy_grid_multisweep_matches_streamed_sweeps(cuda, ny, nx, nrep):
    """gmem_multisweep_kernel (the device-memory mode) equals 8 streamed
    sweep_measure calls bitwise, state and sums: by the fit rule past the
    shared-memory fit at 1500x1500 x 2 and x 3 (rings of 66 and 44
    blocks), 1000x1000 x 5 and 64x64 x 1600 (more replicas than block
    slots: rings of one taking replicas in turn), and forced at 64 x 1500
    x 3."""
    from cuda_fortran_mc_simulation_spin_tpu_torch.models.xy2d import XYState
    from cuda_fortran_mc_simulation_spin_tpu_torch.ops import xy2d_resident
    st = XYState(*_xy_planes(cuda, nrep, ny, nx, 1))
    past_fit = xy2d_resident.device_layout(st) is None
    assert past_fit == ((ny, nx) != (64, 1500))
    layout = xy2d_resident.device_gmem_layout(st)
    assert (layout.blocks == 1) == (nrep == 1600)
    _multisweep_against_streamed(cuda, ny, nx, nrep, 8, not past_fit)


@pytest.mark.cuda
@pytest.mark.parametrize("ny,nx,nrep", [(10000, 10001, 1), (64, 65, 4),
                                        (34, 131, 3)])
def test_xy_helical_angle_or_tile_matches_plain(cuda, ny, nx, nrep):
    """angle_tile_kernel's over-relaxation mode against its plain version
    on the same CUDA tensors, both colours, plain and measuring: the
    state bitwise (the reference's 10001x10000 and small odd-nx shapes
    with seams and ragged tiles), the sums to 1e-12 relative; the
    measuring launch's partials are tile_grid's blocks."""
    from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
        xy2d_helical_dense_angle as ha,
    )
    _, ang = _helical_planes(cuda, nrep, ny, nx, ny + 3)
    gx, gy = ha.tile_grid(ny, (nx + 1) // 2)
    assert ha.tile_scratch(ang[0], True)[0].shape == (nrep, gx * gy, 3)
    for color in (0, 1):
        order = (0, 1) if color == 0 else (1, 0)
        for measuring in (False, True):
            a = [ang[i].clone() for i in order]
            b = [ang[i].clone() for i in order]
            got = ha.angle_or_phase(*a, color=color, measuring=measuring)
            want = ha.angle_or_phase_plain(*b, color=color,
                                           measuring=measuring)
            assert all(torch.equal(p, q) for p, q in zip(a, b))
            if measuring:
                _sums_close_1e12(got[-1], want[-1])


def _helical_planes(dev, nrep, ny, nx, seed):
    """Dense helical XY planes of a random flat state: (ax, ay, bx, by)
    components and (a, b) angles in turns, of one state."""
    from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
        xy2d_helical_dense,
        trig,
    )
    g = np.random.default_rng(seed)
    turns = torch.from_numpy(g.uniform(-0.5, 0.5, size=(nrep, nx * ny))
                             .astype(np.float32)).to(dev)
    ang = list(xy2d_helical_dense.dense_pack(turns, ny, nx))
    comp = [c.contiguous() for p in ang for c in trig.cos_sin_2pi(p)]
    return comp, ang


def _sums_close_1e12(got, want):
    """float64 sums of the same float32 values in two orders: 1e-12
    relative (of max(|want|, 1))."""
    scale = want.abs().clamp(min=1.0)
    assert torch.all((got - want).abs() <= 1e-12 * scale), (got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("ny,nx,nrep", [(16, 65, 2), (64, 65, 4),
                                        (256, 201, 2)])
def test_xy_helical_kernels_match_plain(cuda, ny, nx, nrep):
    """The four dense helical XY kernels (component and angle, Metropolis
    with injected and Philox uniforms, over-relaxation), both colours,
    measuring and not, against their plain versions on the same CUDA
    tensors: the state bitwise, the sums to 1e-12 relative."""
    from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
        xy2d_helical_dense as hd,
        xy2d_helical_dense_angle as ha,
    )
    comp, ang = _helical_planes(cuda, nrep, ny, nx, nx + ny)
    g = np.random.default_rng(ny + nx)
    u = tuple(torch.from_numpy(g.random(tuple(ang[0].shape),
                                        dtype=np.float32)).to(cuda)
              for _ in range(2))
    for color in (0, 1):
        corder = (0, 1, 2, 3) if color == 0 else (2, 3, 0, 1)
        aorder = (0, 1) if color == 0 else (1, 0)
        seeds = rng.seeds_from_key(rng.base_key(12), color)
        for measuring in (False, True):
            runs = (
                (hd.phase, hd.phase_plain, comp, corder,
                 dict(beta=1 / KBT_XY), (u,)),
                (hd.phase, hd.phase_plain, comp, corder,
                 dict(beta=1 / KBT_XY), (seeds,)),
                (hd.or_phase, hd.or_phase_plain, comp, corder, {}, ()),
                (ha.angle_phase, ha.angle_phase_plain, ang, aorder,
                 dict(beta=1 / KBT_XY), (u,)),
                (ha.angle_phase, ha.angle_phase_plain, ang, aorder,
                 dict(beta=1 / KBT_XY), (seeds,)),
                (ha.angle_or_phase, ha.angle_or_phase_plain, ang, aorder,
                 {}, ()))
            for kernel, plain, planes, order, kw, extra in runs:
                a = [planes[i].clone() for i in order]
                b = [planes[i].clone() for i in order]
                got = kernel(*a, *extra, color=color, measuring=measuring,
                             **kw)
                want = plain(*b, *extra, color=color, measuring=measuring,
                             **kw)
                assert all(torch.equal(p, q) for p, q in zip(a, b))
                if measuring:
                    _sums_close_1e12(got[-1], want[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("ny,nx,nrep,walk", [(2, 3, 3, None),
                                             (18, 3, 2, None),
                                             (2, 131, 2, None),
                                             (34, 131, 3, None),
                                             (18, 259, 2, None),
                                             (32, 63, 2, None),
                                             (64, 65, 2, None),
                                             (50, 67, 2, 1),
                                             (98, 67, 2, 2)])
def test_xy_helical_angle_phase_ragged_tiles(cuda, ny, nx, nrep, walk,
                                             monkeypatch):
    """angle_tile_kernel against its plain version on the same CUDA
    tensors: nc = 2 (nx = 3), ny = 2, nc and ny whole tiles and one past
    them, nc not a multiple of the tile width, ny not a multiple of its
    rows, R > 1, and (walk) a grid of that many row blocks, each walking
    several tile rows; both colours, measuring and not, injected and
    Philox uniforms.  The state bitwise, the sums to 1e-12 relative."""
    from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
        xy2d_helical_dense_angle as ha,
    )
    if walk is not None:
        gx = ha.tile_grid(ny, (nx + 1) // 2)[0]
        monkeypatch.setattr(ha, "tile_grid", lambda ny, nc: (gx, walk))
    _, ang = _helical_planes(cuda, nrep, ny, nx, nx * ny)
    g = np.random.default_rng(ny * nx)
    u = tuple(torch.from_numpy(g.random(tuple(ang[0].shape),
                                        dtype=np.float32)).to(cuda)
              for _ in range(2))
    for color in (0, 1):
        order = (0, 1) if color == 0 else (1, 0)
        seeds = rng.seeds_from_key(rng.base_key(14), color)
        for rand in (u, seeds):
            for measuring in (False, True):
                a = [ang[i].clone() for i in order]
                b = [ang[i].clone() for i in order]
                got = ha.angle_phase(*a, rand, color=color, beta=1 / KBT_XY,
                                     measuring=measuring)
                want = ha.angle_phase_plain(*b, rand, color=color,
                                            beta=1 / KBT_XY,
                                            measuring=measuring)
                assert all(torch.equal(p, q) for p, q in zip(a, b))
                if measuring:
                    _sums_close_1e12(got[-1], want[-1])


@pytest.mark.cuda
def test_xy_helical_atan2_matches_plain(cuda):
    """The device atan2_2pi against ops/trig.atan2_2pi on the card,
    bitwise, on points of every octant, the axes and (0, 0)."""
    from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
        trig,
        xy2d_helical_dense_angle as ha,
    )
    g = np.random.default_rng(3)
    y = np.concatenate([g.standard_normal(1 << 20), [0.0, 0.0, 1.0, -1.0]])
    x = np.concatenate([g.standard_normal(1 << 20), [0.0, -1.0, 0.0, 0.0]])
    y, x = (torch.from_numpy(v.astype(np.float32)).to(cuda) for v in (y, x))
    got = ha.atan2_2pi(y, x)
    assert torch.equal(got, trig.atan2_2pi(y, x))
    assert float(got[-4]) == 0.0


@pytest.mark.cuda
def test_xy_helical_launches_refuse_index_overflow(cuda):
    """The two grid-stride helical entry points refuse, before any
    launch, a shape whose grid-stride index would pass 2^31 (ny * nc below
    2^31 but within a grid's width of it) and an empty grid; the angle
    phases (Metropolis and over-relaxation), whose tiles index a replica
    in 32 bits with no grid-stride index, refuse an empty grid, a grid
    whose blocks a replica pass 2^31 and row blocks outside a grid's
    1 .. 65535: cudaErrorInvalidValue."""
    from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
        xy2d_helical_dense as hd,
        xy2d_helical_dense_angle as ha,
    )
    ny, nc = 2, 2 ** 30 - 64
    nblk = hd.blocks(ny, nc)
    for grid in (nblk, 0):
        shape = (1, ny, nc, grid, 0)
        assert hd._lib().xyh_phase(*[None] * 8, *shape, -1.0, 0, 0,
                                   None) == 1
        assert hd._lib().xyh_over_relax(*[None] * 6, *shape, None) == 1
        assert ha._lib().xya_over_relax(*[None] * 4, *shape, None) == 1
    for row_blocks in (0, 65536):
        assert ha._lib().xya_phase(*[None] * 6, 1, ny, nc, row_blocks, 0,
                                   -1.0, 0, 0, None) == 1
        assert ha._lib().xya_over_relax(*[None] * 4, 1, ny, nc, row_blocks,
                                        0, None) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["0", "1"])
def test_xy_helical_runner_on_card_replays_plain_phases(cuda, engine,
                                                        monkeypatch):
    """The helical XY runner with over-relaxation on the card, both
    engines: its series equal a replay of the plain phases on the card
    with the same keys, to 1e-12 relative."""
    from cuda_fortran_mc_simulation_spin_tpu_torch.models import XY2DHelical
    from cuda_fortran_mc_simulation_spin_tpu_torch.ops import multispin_rng
    monkeypatch.setenv("SPINLAT_XY_DENSE_ANGLE", engine)
    mod, _ = sweep.xy_helical_engine()
    model = XY2DHelical(nx=201, ny=256, kbt=KBT_XY)
    key = rng.sample_key(rng.base_key(43), 0)
    series = sweep.make_helical_runner(model, 4, 2, "random", device=cuda,
                                       n_over_relax=2, mcs_over_relax=2)(key)
    flat = sweep._init_state(model, "random", 2, key, cuda)
    planes = list(mod.pack_state(flat, 256, 201))
    seeds = multispin_rng.sweep_phase_keys(key, 4)
    angle = engine == "1"
    metro = mod.angle_phase_plain if angle else mod.phase_plain
    over = mod.angle_or_phase_plain if angle else mod.or_phase_plain

    def by_color(c):
        if angle:
            return planes if c == 0 else planes[::-1]
        return planes if c == 0 else planes[2:] + planes[:2]

    for t in range(4):
        metro(*by_color(0), seeds[t, 0], color=0, beta=model.beta)
        out = metro(*by_color(1), seeds[t, 1], color=1, beta=model.beta,
                    measuring=t >= 2)
        if t < 2:
            for last in (False, True):
                over(*by_color(0), color=0)
                out = over(*by_color(1), color=1, measuring=last)
        for j, k in enumerate(("m", "my", "e")):
            _sums_close_1e12(series[k][:, t] * model.nsites, out[-1][:, j])


# ---------------------------------------------------------------------------
# the int8 periodic Ising kernels (ops/ising2d_pallas.py, ising3d_pallas.py,
# ising2d_measure_pallas.py, ising2d_multisweep.py)
# ---------------------------------------------------------------------------

def _int8(dev, shape, seed, n=2):
    g = np.random.default_rng(seed)
    return [torch.from_numpy((g.integers(0, 2, size=shape, dtype=np.int8)
                              * 2 - 1).astype(np.int8)).to(dev)
            for _ in range(n)]


def _int8_words(dev, shape, seed):
    g = np.random.default_rng(seed)
    return torch.from_numpy(g.integers(-2 ** 31, 2 ** 31, size=shape,
                                       dtype=np.int64).astype(np.int32)
                            ).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3, 130, 63), (2, 64, 128), (1, 2, 1),
                                   (1, 4, 4102), (2, 14, 12, 5),
                                   (2, 8, 16, 128)])
def test_int8_phase_kernels_match_plain(cuda, shape):
    """The 2-D and 3-D int8 phase kernels against their plain versions on
    the same CUDA tensors, injected and Philox words, both colours, at
    ragged and aligned shapes: bitwise; the measure kernel exact."""
    from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
        ising2d_measure_pallas as i8m,
        ising2d_pallas as i2p,
        ising3d_pallas as i3p,
    )
    mod, beta = (i2p, 1 / KBT) if len(shape) == 3 else (i3p, 1 / 4.51152)
    a, b = _int8(cuda, shape, sum(shape))
    bits = _int8_words(cuda, shape, len(shape))
    for color in (0, 1):
        x, o = (a, b) if color == 0 else (b, a)
        seeds = rng.seeds_from_key(rng.base_key(9), color)
        for kw in (dict(bits=bits), dict(seeds=seeds)):
            want = mod.phase_plain(x, o, color=color, beta=beta, **kw)
            got = mod.metropolis_phase(x.clone(), o, color=color, beta=beta,
                                       **kw)
            assert torch.equal(got, want)
    assert torch.equal(i8m.measure_sums(a, b), i8m.measure_sums_plain(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 2, 4102), (1, 2, 2, 4100),
                                   (2, 4, 6, 250), (3, 2, 5)])
@pytest.mark.parametrize("off", [0, 3])
def test_int8_measure_tiles_off_grid(cuda, shape, off):
    """The int8 measure kernel on views off the 16-B grid, whole-row tiles
    and chunks (half 4102, 4100), 2-D and 3-D: exactly the plain sums."""
    from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
        ising2d_measure_pallas as i8m,
    )
    a, b = _int8(cuda, shape, 3 * sum(shape))
    assert torch.equal(i8m.measure_sums(_off_grid(a, off),
                                        _off_grid(b, (off + 5) % 16)),
                       i8m.measure_sums_plain(a, b))


def _off_grid(t, off):
    """A contiguous copy of ``t`` whose first byte lies ``off`` bytes past
    a 16-B aligned address."""
    buf = torch.empty(t.numel() + 32, dtype=t.dtype, device=t.device)
    base = (-buf.data_ptr()) % 16
    v = buf[base + off:base + off + t.numel()].view(t.shape)
    assert v.data_ptr() % 16 == off
    return v.copy_(t)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 6, 10, 250), (1, 2, 3, 4102),
                                   (3, 4, 5, 1)])
@pytest.mark.parametrize("off", [0, 3])
def test_int8_3d_tiles_off_grid(cuda, shape, off):
    """The int8 3-D tile kernel on views off the 16-B grid, whole-row
    tiles (half 250, 1) and chunks (half 4102): both colours, Philox and
    injected words, and its halo mode measuring at offsets (1, 5),
    bitwise equal to the plain versions."""
    from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
        ising3d_pallas as i3p,
    )
    beta = 1 / 4.51152
    a, b = _int8(cuda, shape, sum(shape))
    zm, zp = _int8(cuda, (shape[0], 1) + shape[2:], off + 1)
    bits = _int8_words(cuda, shape, len(shape))
    for color in (0, 1):
        x, o = (a, b) if color == 0 else (b, a)
        seeds = rng.seeds_from_key(rng.base_key(9), color)
        for kw in (dict(bits=bits), dict(seeds=seeds)):
            want = i3p.phase_plain(x, o, color=color, beta=beta, **kw)
            got = i3p.metropolis_phase(_off_grid(x, off),
                                       _off_grid(o, (off * 5) % 16),
                                       color=color, beta=beta, **kw)
            assert torch.equal(got, want)
        want = i3p.sharded_phase_plain(x, o, zm, zp, seeds, (1, 5),
                                       color=color, beta=beta,
                                       measuring=True)
        got = i3p.sharded_phase(_off_grid(x, off), _off_grid(o, off),
                                _off_grid(zm, off), zp, seeds, (1, 5),
                                color=color, beta=beta, measuring=True)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,col0", [((2, 6, 250), 1), ((3, 5, 63), 2),
                                        ((1, 3, 4102), 5), ((2, 4, 1), 3)])
@pytest.mark.parametrize("off", [0, 3, 11])
def test_int8_2d_tiles_off_grid(cuda, shape, col0, off):
    """The int8 2-D phase kernel on views off the 16-B grid, whole-row
    tiles (half 250, 63, 1) and chunks (half 4102): both colours, Philox
    and injected words, and its halo mode with column halos at col0 % 4
    = 1 .. 3, plain and measuring, bitwise equal to the plain
    versions."""
    from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
        ising2d_pallas as i2p,
    )
    beta = 1 / KBT
    R, L, H = shape
    a, b = _int8(cuda, shape, sum(shape) + off)
    up, dn = _int8(cuda, (R, 1, H), off + 1)
    lf, rt = _int8(cuda, (R, L, 1), off + 2)
    bits = _int8_words(cuda, shape, off)
    for color in (0, 1):
        x, o = (a, b) if color == 0 else (b, a)
        seeds = rng.seeds_from_key(rng.base_key(9), color)
        for kw in (dict(bits=bits), dict(seeds=seeds)):
            want = i2p.phase_plain(x, o, color=color, beta=beta, **kw)
            got = i2p.metropolis_phase(_off_grid(x, off),
                                       _off_grid(o, (off * 5) % 16),
                                       color=color, beta=beta, **kw)
            assert torch.equal(got, want)
            for measuring in (False, True):
                hkw = dict(color=color, beta=beta, halo_lf=lf, halo_rt=rt,
                           measuring=measuring,
                           bits=kw.get("bits"))
                args = (up, dn, kw.get("seeds"), (1, 5, col0))
                want = i2p.sharded_phase_plain(x, o, *args, **hkw)
                got = i2p.sharded_phase(_off_grid(x, off),
                                        _off_grid(o, (off * 3) % 16),
                                        _off_grid(up, off), dn, *args[2:],
                                        **hkw)
                assert _same(got, want), (color, kw.keys(), measuring)


@pytest.mark.cuda
def test_int8_phase_entry_refuses_bad_tiles(cuda):
    """The int8 2-D phase's C entries refuse tile constants that do not
    cover the planes and thresholds with t8 > t4, launching nothing; the
    plane is left as it was."""
    import ctypes

    from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
        ising2d_pallas as i2p,
    )
    shape = (2, 64, 128)
    a, b = _int8(cuda, shape, 5)
    x = a.clone()
    t = i2p.phase_tiles(*shape)
    t4, t8 = i2p.accept_thresholds_u32(1 / KBT)
    lib = i2p._lib()
    stream = torch.cuda.current_stream().cuda_stream

    def arg(d):
        words = [d["rows"], d["lux"], d["cw"], d["nch"], d["nty"], *d["buf"],
                 d["smem"]]
        return (ctypes.c_int * len(words))(*words)

    for tiles, th in ((dict(t, nty=t["nty"] - 1), (t4, t8)),
                      (dict(t, smem=t["smem"] - 16), (t4, t8)),
                      (t, (t8, t4 + 1))):
        assert lib.ising2d_int8_phase(
            x.data_ptr(), b.data_ptr(), None, *shape, 0, 1, 2, *th,
            arg(tiles), stream) != 0
        assert lib.ising2d_int8_halo_phase(
            x.data_ptr(), b.data_ptr(), None, b[:, :1].data_ptr(),
            b[:, -1:].data_ptr(), None, None, None, *shape, 0, 0, 0, 0, 1,
            2, *th, arg(tiles), stream) != 0
    torch.cuda.synchronize()
    assert torch.equal(x, a)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3, 130, 63), (16, 1000, 500)])
def test_int8_multisweep_matches_phase_pairs_and_plain(cuda, shape):
    """S multisweep sweeps equal S phase-kernel pairs with measure_kernel
    (state and sums bitwise) and the plain multisweep."""
    from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
        ising2d_measure_pallas as i8m,
        ising2d_multisweep as i8ms,
        ising2d_pallas as i2p,
    )
    from cuda_fortran_mc_simulation_spin_tpu_torch.ops import multispin_rng
    a, b = _int8(cuda, shape, 3)
    seeds = multispin_rng.sweep_phase_keys(rng.sample_key(rng.base_key(2),
                                                          0), 8)
    ka, kb, kobs = i8ms.multisweep_planes(a.clone(), b.clone(), seeds,
                                          beta=1 / KBT)
    pa, pb, obs = a.clone(), b.clone(), []
    for s in range(8):
        i2p.metropolis_phase(pa, pb, seeds[s, 0], color=0, beta=1 / KBT)
        i2p.metropolis_phase(pb, pa, seeds[s, 1], color=1, beta=1 / KBT)
        obs.append(i8m.measure_sums(pa, pb))
    assert torch.equal(ka, pa) and torch.equal(kb, pb)
    assert torch.equal(kobs, torch.stack(obs, dim=1))
    qa, qb, qobs = i8ms.multisweep_plain(a, b, seeds, beta=1 / KBT)
    assert torch.equal(ka, qa) and torch.equal(kb, qb)
    assert torch.equal(kobs, qobs)


@pytest.mark.cuda
def test_int8_runners_on_card_equal_cpu_runners(cuda):
    """The three generic runners give on the card the series their plain
    versions give on the CPU: the exact (m, e) sums bitwise (the densities
    sums / N may differ in their last bit: the card's division by a
    scalar multiplies by its reciprocal)."""
    from cuda_fortran_mc_simulation_spin_tpu_torch.models import Ising3D
    key = rng.sample_key(rng.base_key(5), 1)
    m2 = Ising2D(nx=126, ny=130, kbt=KBT)
    m3 = Ising3D(nx=10, ny=12, nz=14, kbt=4.51152)
    for make, model, args in (
            (sweep.make_batch_runner, m2, (3,)),
            (sweep.make_multisweep_runner, m2, (3,)),
            (sweep.make_sample_runner, m2, ()),
            (sweep.make_batch_runner, m3, (2,))):
        on_card = make(model, 6, *args, "random", device=cuda)(key)
        on_cpu = make(model, 6, *args, "random", device="cpu")(key)
        for k in ("m", "e"):
            got = (on_card[k].cpu() * model.nsites).round()
            assert torch.equal(got, (on_cpu[k] * model.nsites).round())
            assert torch.allclose(on_card[k].cpu(), on_cpu[k], rtol=1e-15,
                                  atol=0)


def _clock8(dev, shape, q, seed):
    g = np.random.default_rng(seed)
    return [torch.from_numpy(g.integers(0, q, size=shape, dtype=np.int8)
                             ).to(dev) for _ in range(2)]


def _scaled(got, want, nsites):
    """|got - want| against the sums' scale, max(|want|, nsites)."""
    return float(((got - want).abs()
                  / want.abs().clamp(min=float(nsites))).max())


@pytest.mark.cuda
@pytest.mark.parametrize("q", [2, 3, 4, 5, 6, 8, 20, 127])
@pytest.mark.parametrize("shape", [(3, 130, 63), (2, 64, 128), (1, 2, 1)])
def test_clock8_phase_and_measure_kernels_match_plain(cuda, q, shape):
    """The int8 clock phase kernel against its plain version on the same
    CUDA tensors, injected and Philox uniforms, both colours: bitwise; the
    measure kernel within 1e-12 of the sums' scale, exactly at q = 2, 4."""
    from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
        clock_measure_pallas as c8m,
        clock_pallas as c8p,
    )
    a, b = _clock8(cuda, shape, q, q + sum(shape))
    g = np.random.default_rng(q)
    uc, ua = (torch.from_numpy((g.integers(0, 2 ** 24, size=shape)
                                * 2.0 ** -24).astype(np.float32)).to(cuda)
              for _ in range(2))
    for color in (0, 1):
        x, o = (a, b) if color == 0 else (b, a)
        seeds = rng.seeds_from_key(rng.base_key(9), color)
        for kw in (dict(u_cand=uc, u_acc=ua), dict(seeds=seeds)):
            want = c8p.phase_plain(x, o, color=color, q=q, beta=1 / 0.91,
                                   **kw)
            got = c8p.metropolis_phase(x.clone(), o, color=color, q=q,
                                       beta=1 / 0.91, **kw)
            assert torch.equal(got, want)
    got, want = c8m.measure_sums(a, b, q), c8m.measure_sums_plain(a, b, q)
    assert _scaled(got, want, 2 * shape[1] * shape[2]) <= 1e-12
    if q in (2, 4):
        assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("q,shape", [(6, (3, 130, 63)), (2, (16, 1000, 500)),
                                     (20, (2, 64, 128))])
def test_clock8_multisweep_matches_phase_pairs_and_plain(cuda, q, shape):
    """S int8 clock multisweep sweeps equal S phase-kernel pairs (states
    bitwise; the fused sums within 1e-12 of measure_kernel's) and the
    plain multisweep."""
    from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
        clock_measure_pallas as c8m,
        clock_multisweep as c8ms,
        clock_pallas as c8p,
    )
    from cuda_fortran_mc_simulation_spin_tpu_torch.ops import multispin_rng
    a, b = _clock8(cuda, shape, q, 3)
    seeds = multispin_rng.sweep_phase_keys(rng.sample_key(rng.base_key(2),
                                                          0), 8)
    kw = dict(q=q, beta=1 / 0.91)
    ka, kb, kobs = c8ms.multisweep_planes(a.clone(), b.clone(), seeds, **kw)
    pa, pb, obs = a.clone(), b.clone(), []
    for s in range(8):
        c8p.metropolis_phase(pa, pb, seeds[s, 0], color=0, **kw)
        c8p.metropolis_phase(pb, pa, seeds[s, 1], color=1, **kw)
        obs.append(c8m.measure_sums(pa, pb, q))
    nsites = 2 * shape[1] * shape[2]
    assert torch.equal(ka, pa) and torch.equal(kb, pb)
    assert _scaled(kobs, torch.stack(obs, dim=1), nsites) <= 1e-12
    qa, qb, qobs = c8ms.multisweep_plain(a, b, seeds, **kw)
    assert torch.equal(ka, qa) and torch.equal(kb, qb)
    assert _scaled(kobs, qobs, nsites) <= 1e-12


@pytest.mark.cuda
def test_clock8_launches_refused(cuda):
    """A q the kernels' tables do not hold and float64 uniforms are
    refused before a launch."""
    from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
        clock_pallas as c8p,
    )
    a, b = _clock8(cuda, (1, 4, 4), 6, 1)
    with pytest.raises(ValueError, match="q=128"):
        c8p.metropolis_phase(a, b, rng.base_key(1), color=0, q=128,
                             beta=1.0)
    u = torch.zeros((1, 4, 4), dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError, match="float32"):
        c8p.metropolis_phase(a, b, color=0, q=6, beta=1.0, u_cand=u,
                             u_acc=u)


# ---------------------------------------------------------------------------
# the masked helical kernels (ops/helical_pallas.py)
# ---------------------------------------------------------------------------

def _hp_scaled(got, want, n):
    return float(((got - want).abs()
                  / want.abs().clamp(min=float(n))).max())


@pytest.mark.cuda
@pytest.mark.parametrize("nrep,ny,nx", [(3, 32, 33), (3, 31, 33),
                                        (2, 64, 65), (1, 3, 3),
                                        (3, 30, 35), (5, 31, 35),
                                        (2, 2, 3)])
def test_helical_pallas_kernels_match_plain(cuda, nrep, ny, nx):
    """The four masked kernels against their plain versions at even and
    odd N, replica bases that are not 16-B aligned and N below one
    vector: multisweeps with injected and Philox randomness (states
    bitwise, Ising sums exactly, clock sums within 1e-12 of their scale),
    the XY phase (both colours, injected and Philox, measuring and not),
    the OR phase and the measure mode."""
    from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
        helical_pallas as hp,
    )
    n = ny * nx
    m0 = hp.colour_sites(n, 0)
    g = np.random.default_rng(n + nrep)
    seeds = hp.multispin_rng.sweep_phase_keys(
        rng.sample_key(rng.base_key(7), 0), 3)
    x = torch.from_numpy((g.integers(0, 2, size=(nrep, n)) * 2 - 1)
                         .astype(np.int8)).to(cuda)
    bits = torch.from_numpy(g.integers(-2 ** 31, 2 ** 31, size=(3, 2, nrep,
                                                                m0))
                            .astype(np.int32)).to(cuda)
    for kw in (dict(bits=bits), dict(seeds=seeds)):
        got = hp.ising_multisweep(x.clone(), beta=1 / KBT, nx=nx, **kw)
        want = hp.ising_multisweep_plain(x, beta=1 / KBT, nx=nx, **kw)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for q in (2, 5, 6, 127):
        c = torch.from_numpy(g.integers(0, q, size=(nrep, n))
                             .astype(np.int8)).to(cuda)
        u = tuple(torch.from_numpy(
            (g.integers(0, 2 ** 24, size=(3, 2, nrep, m0)) * 2.0 ** -24)
            .astype(np.float32)).to(cuda) for _ in range(2))
        for kw in (dict(u=u), dict(seeds=seeds)):
            got = hp.clock_multisweep(c.clone(), beta=1.25, nx=nx, q=q, **kw)
            want = hp.clock_multisweep_plain(c, beta=1.25, nx=nx, q=q, **kw)
            assert torch.equal(got[0], want[0])
            assert _hp_scaled(got[1], want[1], n) <= 1e-12
    th = torch.from_numpy(g.uniform(0, 2 * np.pi, size=(nrep, n))
                          .astype(np.float32)).to(cuda)
    sx, sy = torch.cos(th).contiguous(), torch.sin(th).contiguous()
    u = tuple(torch.from_numpy((g.integers(0, 2 ** 24, size=(nrep, m0))
                                * 2.0 ** -24).astype(np.float32)).to(cuda)
              for _ in range(2))
    for color in (0, 1):
        for rand in (u, rng.seeds_from_key(rng.base_key(3), color)):
            for measuring in (False, True):
                kw = dict(color=color, nx=nx, beta=1 / 0.89,
                          measuring=measuring)
                got = hp.xy_phase(sx, sy, rand, **kw)
                want = hp.xy_phase_plain(sx, sy, rand, **kw)
                assert torch.equal(got[0], want[0])
                assert torch.equal(got[1], want[1])
                if measuring:
                    assert _hp_scaled(got[2], want[2], 2 * n) <= 1e-12
        got = hp.xy_or_phase(sx, sy, color=color, nx=nx)
        want = hp.xy_or_phase_plain(sx, sy, color=color, nx=nx)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert _hp_scaled(hp.xy_measure(sx, sy, nx=nx), hp.xy_sums(sx, sy, nx),
                      2 * n) <= 1e-12


def _hp_offset(t, elems):
    """t's values in a view starting ``elems`` elements past the 16-B
    aligned start of a larger buffer (the caching allocator aligns it)."""
    buf = torch.empty(t.numel() + elems, dtype=t.dtype, device=t.device)
    assert buf.data_ptr() % 16 == 0
    return buf[elems:].view(t.shape).copy_(t)


@pytest.mark.cuda
@pytest.mark.parametrize("nrep,ny,nx", [(3, 32, 33), (3, 31, 33),
                                        (3, 30, 35), (5, 31, 35),
                                        (2, 2, 3)])
def test_helical_pallas_kernels_match_plain_off_the_vector_grid(
        cuda, nrep, ny, nx):
    """The masked Ising multisweep and the XY phase on views whose first
    element is not 16-B aligned, against their plain versions bitwise:
    Ising x at 3 and 8 bytes past the grid (injected and Philox words);
    XY planes at 1 float past it with out planes at the same offset (the
    vector path, off0 = 1) and at another (element by element), measuring
    and not, and the measure mode at offsets 3/3 and 1/2 floats."""
    from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
        helical_pallas as hp,
    )
    n = ny * nx
    m0 = hp.colour_sites(n, 0)
    g = np.random.default_rng(7 * n + nrep)
    seeds = hp.multispin_rng.sweep_phase_keys(
        rng.sample_key(rng.base_key(8), 0), 3)
    x = torch.from_numpy((g.integers(0, 2, size=(nrep, n)) * 2 - 1)
                         .astype(np.int8)).to(cuda)
    bits = torch.from_numpy(g.integers(-2 ** 31, 2 ** 31, size=(3, 2, nrep,
                                                                m0))
                            .astype(np.int32)).to(cuda)
    for off in (3, 8):
        for kw in (dict(bits=bits), dict(seeds=seeds)):
            xo = _hp_offset(x, off)
            assert xo.data_ptr() % 16 == off
            got = hp.ising_multisweep(xo, beta=1 / KBT, nx=nx, **kw)
            want = hp.ising_multisweep_plain(x, beta=1 / KBT, nx=nx, **kw)
            assert got[0].data_ptr() == xo.data_ptr()
            assert torch.equal(got[0], want[0])
            assert torch.equal(got[1], want[1])
    th = torch.from_numpy(g.uniform(0, 2 * np.pi, size=(nrep, n))
                          .astype(np.float32)).to(cuda)
    sx, sy = torch.cos(th).contiguous(), torch.sin(th).contiguous()
    u = tuple(torch.from_numpy((g.integers(0, 2 ** 24, size=(nrep, m0))
                                * 2.0 ** -24).astype(np.float32)).to(cuda)
              for _ in range(2))
    sxo, syo = _hp_offset(sx, 1), _hp_offset(sy, 1)
    for out_off in (1, 0, 2):
        for color in (0, 1):
            for rand in (u, rng.seeds_from_key(rng.base_key(5), color)):
                for measuring in (False, True):
                    kw = dict(color=color, nx=nx, beta=1 / 0.89,
                              measuring=measuring)
                    out = (_hp_offset(sx, out_off), _hp_offset(sy, out_off))
                    got = hp.xy_phase(sxo, syo, rand, out=out, **kw)
                    want = hp.xy_phase_plain(sx, sy, rand, **kw)
                    assert torch.equal(got[0], want[0])
                    assert torch.equal(got[1], want[1])
                    if measuring:
                        assert _hp_scaled(got[2], want[2], 2 * n) <= 1e-12
    for ox, oy in ((3, 3), (1, 2)):
        got = hp.xy_measure(_hp_offset(sx, ox), _hp_offset(sy, oy), nx=nx)
        assert _hp_scaled(got, hp.xy_sums(sx, sy, nx), 2 * n) <= 1e-12


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["ising", "clock", "xy", "xy_or"])
@pytest.mark.parametrize("ny", [32, 31])
def test_helical_pallas_runner_on_card_replays_plain_versions(
        cuda, kind, ny, monkeypatch):
    """The masked runner on the card against the same runner with every
    wrapper taking its plain version on the card's tensors: Ising's
    densities bitwise; the clock's and XY's (states bitwise, float64 sums
    in another order) within 1e-12.  Against the CPU only Ising would
    hold: float32 exp and rsqrt differ between the CPU and the card."""
    from cuda_fortran_mc_simulation_spin_tpu_torch.models import (
        Clock2DHelical,
        Ising2DHelical,
        XY2DHelical,
    )
    from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
        helical_pallas as hp,
    )
    nx = 33
    model = {"ising": Ising2DHelical(nx, ny, KBT),
             "clock": Clock2DHelical(nx, ny, 0.8, 5)}.get(
        kind, XY2DHelical(nx, ny, 0.89))
    n_or = 1 if kind == "xy_or" else 0
    key = rng.sample_key(rng.base_key(42), 0)

    def run():
        return sweep.make_masked_runner(model, 70, 2, "random", cuda,
                                        n_over_relax=n_or)(key)
    hp.reset_launches()
    kernels = run()
    assert sum(hp.LAUNCHES.values()) > 0
    monkeypatch.setattr(hp, "_on_cpu", lambda t: True)
    hp.reset_launches()
    plain = run()
    assert sum(hp.LAUNCHES.values()) == 0
    for k in plain:
        if kind == "ising":
            assert torch.equal(kernels[k], plain[k])
        else:
            assert float((kernels[k] - plain[k]).abs().max()) <= 1e-12


@pytest.mark.cuda
@pytest.mark.parametrize("ny", [32, 31])
def test_helical_pallas_ising_runner_on_card_equals_cpu_runner(cuda, ny):
    """The masked Ising runner on the card and on the CPU: the same integer
    states and int64 sums, so densities bitwise (ising2d_multispin.per_site
    divides on the card, where a Python-number divisor would multiply by
    its reciprocal and move quotients by 1 ulp)."""
    from cuda_fortran_mc_simulation_spin_tpu_torch.models import (
        Ising2DHelical,
    )
    model = Ising2DHelical(33, ny, KBT)
    key = rng.sample_key(rng.base_key(42), 0)
    card = sweep.make_masked_runner(model, 70, 2, "random", cuda)(key)
    cpu = sweep.make_masked_runner(model, 70, 2, "random", "cpu")(key)
    for k in cpu:
        assert torch.equal(card[k].cpu(), cpu[k])


@pytest.mark.cuda
def test_helical_pallas_launches_refused(cuda):
    """Even nx, a q the tables do not hold, and shared output planes are
    refused before a launch."""
    from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
        helical_pallas as hp,
    )
    x = torch.zeros((1, 64 * 32), dtype=torch.int8, device=cuda)
    seeds = hp.multispin_rng.sweep_phase_keys(rng.base_key(1), 1)
    with pytest.raises(ValueError, match="odd nx"):
        hp.ising_multisweep(x, seeds, beta=1.0, nx=64)
    with pytest.raises(ValueError, match="q=128"):
        hp.clock_multisweep(x, seeds, beta=1.0, nx=33, q=128)
    sx = torch.ones((1, 33 * 32), device=cuda)
    with pytest.raises(ValueError, match="storage"):
        hp.xy_or_phase(sx, sx.clone(), color=0, nx=33, out=(sx, sx))


def _turns(dev, shape, seed):
    g = np.random.default_rng(seed)
    return [torch.from_numpy(g.uniform(-0.5, 0.5, size=shape).astype(
        np.float32)).to(dev) for _ in range(4)]


@pytest.mark.cuda
@pytest.mark.parametrize("ny,nx", [(16, 84), (256, 200), (64, 1500)])
def test_xy_angle_kernels_match_plain(cuda, ny, nx):
    """angle_metro_kernel (injected and Philox uniforms; plain, measuring
    and the snapshot mode) and angle_or_kernel (plain and measuring)
    against their plain versions on the same CUDA tensors, both colours:
    the state bitwise, the sums to float64 rounding."""
    from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
        xy2d_pallas_angle as xa,
    )
    shape = (2, ny, nx // 2)
    a, b, sa, sb = _turns(cuda, shape, nx + ny)
    g = np.random.default_rng(ny)
    u = tuple(torch.from_numpy(g.random(shape, dtype=np.float32)).to(cuda)
              for _ in range(2))
    for color in (0, 1):
        s, o = (a, b) if color == 0 else (b, a)
        snap = (sa, sb) if color == 0 else (sb, sa)
        seeds = rng.seeds_from_key(rng.base_key(8), color)
        runs = [(xa.metro_phase, xa.metro_phase_plain, (rand,),
                 dict(beta=1 / KBT_XY, **mode))
                for rand in (u, seeds)
                for mode in ({}, {"measuring": True}, {"snap": snap})]
        runs += [(xa.or_phase, xa.or_phase_plain, (), {"measuring": m})
                 for m in (False, True)]
        for kernel, plain, extra, kw in runs:
            ks, ps = s.clone(), s.clone()
            got = kernel(ks, o, *extra, color=color, **kw)
            want = plain(ps, o, *extra, color=color, **kw)
            assert torch.equal(ks, ps)
            if isinstance(want, tuple):
                _xy_sums_close(got[1], want[1])


# periodic angle tiles: half 5000 (the literal 10000^2 class's, not a
# multiple of 32) at a few rows, rows not a multiple of 32, half < 32,
# ny = 2, and a grid capped at MAX_TILE_BLOCKS a replica (1024 column
# tiles x 16 row blocks, each walking two tile rows of 544)
XY_ANGLE_TILE_SHAPES = [(6, 10000, 1), (34, 10000, 2), (2, 10, 2),
                        (2, 64, 3), (4, 40, 2), (33, 62, 2), (2, 2, 1),
                        (544, 65536, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("ny,nx,nrep", XY_ANGLE_TILE_SHAPES)
def test_xy_angle_metro_tile_ragged(cuda, ny, nx, nrep):
    """angle_metro_kernel's decode-once tile at ragged shapes and a capped
    grid: injected and Philox uniforms, plain, measuring and the snapshot
    mode, both colours, the state bitwise against the plain version and
    the sums to float64 rounding; a second launch on the same inputs
    repeats the sums bitwise."""
    from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
        xy2d_helical_dense_angle as xha,
        xy2d_pallas_angle as xa,
    )
    half = nx // 2
    gx, gy = xha.tile_grid(ny, half)
    assert gx * 32 >= half and gy <= -(-ny // 32)
    assert gx * gy <= xha.MAX_TILE_BLOCKS or gy == 1
    if (ny, nx) == (544, 65536):
        assert gy < -(-ny // 32)
    assert xa.metro_blocks(ny, half) == gx * gy
    shape = (nrep, ny, half)
    a, b, sa, sb = _turns(cuda, shape, nx + ny + nrep)
    g = np.random.default_rng(ny + nrep)
    u = tuple(torch.from_numpy(g.random(shape, dtype=np.float32)).to(cuda)
              for _ in range(2))
    for color in (0, 1):
        s, o = (a, b) if color == 0 else (b, a)
        snap = (sa, sb) if color == 0 else (sb, sa)
        seeds = rng.seeds_from_key(rng.base_key(12), color)
        for rand in (u, seeds):
            for mode in ({}, {"measuring": True}, {"snap": snap}):
                kw = dict(color=color, beta=1 / KBT_XY, **mode)
                ks, ps, ks2 = s.clone(), s.clone(), s.clone()
                got = xa.metro_phase(ks, o, rand, **kw)
                want = xa.metro_phase_plain(ps, o, rand, **kw)
                assert torch.equal(ks, ps)
                assert ks.numel() < 64 or not torch.equal(ks, s)
                if mode:
                    _xy_sums_close(got[1], want[1])
                    again = xa.metro_phase(ks2, o, rand, **kw)
                    assert torch.equal(again[1], got[1])


@pytest.mark.cuda
@pytest.mark.parametrize("ny,nx,nrep", XY_ANGLE_TILE_SHAPES)
def test_xy_angle_or_tile_ragged(cuda, ny, nx, nrep):
    """angle_or_kernel on the Metropolis kernel's tiles and grid at ragged
    shapes and a capped grid: plain and measuring, both colours, the state
    bitwise against the plain version, the sums to float64 rounding from
    at most MAX_TILE_BLOCKS partials a replica, a second launch repeating
    them bitwise."""
    from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
        xy2d_helical_dense_angle as xha,
        xy2d_pallas_angle as xa,
    )
    shape = (nrep, ny, nx // 2)
    a, b, _, _ = _turns(cuda, shape, nx + ny + 3 * nrep)
    partials, _ = xha.tile_scratch(a, True)
    assert partials.shape[1] == xa.metro_blocks(ny, nx // 2)
    assert partials.shape[1] <= xha.MAX_TILE_BLOCKS
    for color in (0, 1):
        s, o = (a, b) if color == 0 else (b, a)
        for measuring in (False, True):
            ks, ps, ks2 = s.clone(), s.clone(), s.clone()
            got = xa.or_phase(ks, o, color=color, measuring=measuring)
            want = xa.or_phase_plain(ps, o, color=color, measuring=measuring)
            assert torch.equal(ks, ps)
            if measuring:
                _xy_sums_close(got[1], want[1])
                again = xa.or_phase(ks2, o, color=color, measuring=True)
                assert torch.equal(again[1], got[1])


@pytest.mark.cuda
@pytest.mark.parametrize("grid", [False, True])
@pytest.mark.parametrize("shape,n_or,or_only", [
    ((2, 32, 24), 0, False), ((2, 32, 24), 1, False),
    ((2, 32, 24), 2, True), ((1, 1536, 768), 0, False),
    ((1, 1536, 768), 1, False), ((1, 1536, 768), 1, True),
    ((3, 64, 750), 1, False), ((1, 2048, 1024), 0, False),
    ((2, 1536, 768), 0, False), ((5, 6, 250), 0, False),
    ((2, 1536, 768), 1, False), ((2, 1536, 768), 2, True),
    ((3, 1536, 768), 0, False), ((32, 1536, 768), 0, False),
    ((133, 32, 16), 1, False)])
def test_xy_int16_multisweep_matches_plain(cuda, shape, n_or, or_only, grid):
    """Both modes of the int16 multisweep against its plain version on the
    same CUDA tensors, S = 3 sweeps: the int16 state bitwise, the sums to
    float64 rounding.  The shared-memory mode where the fit rule takes the
    batch (small and ragged shapes, the main path's 1536x1536 x 1, its
    snapshot in shared memory; 2048x2048 x 1, its snapshot in device
    memory; 5 x 6x500, blocks of a few rows), the device-memory mode past
    it and wherever ``grid`` forces it: 1536x1536 x 2 on rings of 66
    blocks holding and decoding all 64 chunks between their edge chunks
    (Metropolis only, with an OR sweep and OR only, the measure folded
    into the last OR phase b), x 3 on rings of 44 decoding part of their
    99 held chunks, x 32 (whose sums would not fit one ring a replica) in
    16 turns on 2 rings of 66 blocks, and 133 x 32x32 on 67 rings of one
    block, 66 taking two replicas in turn; the launch is counted under
    the mode the rule picked."""
    from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
        xy2d_multisweep as xi,
    )
    g = np.random.default_rng(shape[1] + n_or)
    planes = [torch.from_numpy(g.integers(-2 ** 15, 2 ** 15, size=shape)
                               .astype(np.int16)).to(cuda)
              for _ in range(4)]
    seeds = xi.multispin_rng.sweep_phase_keys(rng.base_key(9), 3)
    ka, kb = planes[0].clone(), planes[1].clone()
    pa, pb = planes[0].clone(), planes[1].clone()
    smem = not grid and xi.device_layout(planes[0]) is not None
    past = shape in ((2, 1536, 768), (3, 1536, 768), (32, 1536, 768),
                     (133, 32, 16))
    assert smem == (not grid and not past)
    if not smem:
        lay = xi.device_gmem_layout(planes[0])
        # blocks a ring, rings, held chunks, all of them decoded (x 3:
        # some, as many as the card's shared memory takes)
        want = {(2, 1536, 768): (66, 2, 64, True),
                (3, 1536, 768): (44, 3, 99, False),
                (32, 1536, 768): (66, 2, 64, True),
                (133, 32, 16): (1, 67, 2, True)}
        if shape in want:
            assert (lay.blocks, lay.rings, lay.hold,
                    lay.dec == lay.hold) == want[shape]
            assert lay.dec > 0
    xi.reset_launches()
    got = xi.multisweep_planes(ka, kb, *planes[2:], seeds, beta=1 / KBT_XY,
                               n_or=n_or, or_only=or_only, grid=grid)
    assert xi.LAUNCHES == {"multisweep": int(not smem),
                           "multisweep_smem": int(smem)}
    want = xi.multisweep_plain(pa, pb, *planes[2:], seeds, beta=1 / KBT_XY,
                               n_or=n_or, or_only=or_only)
    assert torch.equal(ka, pa) and torch.equal(kb, pb)
    assert not torch.equal(ka, planes[0])
    _xy_sums_close(got, want)


@pytest.mark.cuda
def test_xy_int16_or_only_conserves_energy(cuda):
    """The kernel's pure over-relaxation sweeps (or_only) keep the energy
    to the angle quantum's rounding, as JAX's tests/test_tpu_kernels.py:
    276-296 asks of its kernel."""
    from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
        xy2d_multisweep as xi,
    )
    g = np.random.default_rng(3)
    shape = (2, 256, 128)
    pa = torch.from_numpy(g.integers(-2 ** 15, 2 ** 15, size=shape).astype(
        np.int16)).to(cuda)
    pb = torch.zeros_like(pa)
    seeds = xi.multispin_rng.sweep_phase_keys(rng.base_key(4), 8)
    obs = xi.multisweep_planes(pa, pb, pa.clone(), pb.clone(), seeds,
                               beta=1 / KBT_XY, n_or=1, or_only=True)
    e = obs[..., 2] / (2 * 256 * 128)
    assert float((e - e[:, :1]).abs().max()) < 2e-3


@pytest.mark.cuda
def test_xy_int16_launch_refuses_bad_planes(cuda):
    from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
        xy2d_multisweep as xi,
    )
    x = torch.zeros((1, 32, 16), dtype=torch.int16, device=cuda)
    seeds = xi.multispin_rng.sweep_phase_keys(rng.base_key(1), 1)
    with pytest.raises(ValueError, match="int16"):
        xi.multisweep_planes(x, x.float(), x, x, seeds, beta=1.0)


@pytest.mark.cuda
@pytest.mark.parametrize("angle", ["0", "1"])
def test_xy_runner_densities_on_card_equal_cpu_runner(cuda, angle,
                                                      monkeypatch):
    """The XY relaxation runner (component or angle planes) on the card
    and on the CPU from all-up at kbt 1e-30: a candidate is taken only at
    ΔE <= 0, where its S_x rounds to 1, so every S_x stays 1, each S·h
    rounds to 4 and the few small S_y add exactly in float64 in any
    order; the sums agree exactly and so must the densities, which divide
    by a tensor on the sums' device (xy2d_pallas.densities; a Python-number
    divisor would multiply on the card by its reciprocal, ROADMAP C8)."""
    from cuda_fortran_mc_simulation_spin_tpu_torch.models import XY2D
    monkeypatch.setenv("SPINLAT_XY_PERIODIC_ANGLE", angle)
    model = XY2D(nx=48, ny=30, kbt=1e-30)
    key = rng.sample_key(rng.base_key(42), 0)
    card = sweep.make_xy_runner(model, 40, 3, device=cuda)(key)
    cpu = sweep.make_xy_runner(model, 40, 3, device="cpu")(key)
    for k in cpu:
        assert torch.equal(card[k].cpu(), cpu[k]), k
    assert float(cpu["my"].abs().max()) > 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("prep", ["rotate_first", "fix1mcs"])
def test_xy_angle_and_int16_runners_replay_plain_on_card(cuda, prep,
                                                         monkeypatch):
    """The streamed angle disorder route and the int16 route on the card
    against the same runners with every wrapper sent to its plain version
    on the same CUDA tensors (the same draws, the same expf): the series
    agree to float64 rounding of the sums."""
    from cuda_fortran_mc_simulation_spin_tpu_torch.models import XY2D
    from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
        xy2d_measure_pallas,
        xy2d_multisweep,
        xy2d_pallas,
        xy2d_pallas_angle,
        xy2d_resident,
    )
    monkeypatch.setattr(xy2d_resident, "RESIDENT_MAX_SITES", 0)
    model = XY2D(nx=64, ny=32, kbt=KBT_XY)
    key = rng.sample_key(rng.base_key(7), 0)
    mods = (xy2d_measure_pallas, xy2d_multisweep, xy2d_pallas,
            xy2d_pallas_angle)
    for switch in ("SPINLAT_XY_PERIODIC_ANGLE", "SPINLAT_XY_ANGLE_MS"):
        monkeypatch.setenv(switch, "1")
        for n_or in ((0, 1) if prep == "rotate_first" else (0,)):
            def run():
                return sweep.make_xy_disorder_runner(
                    model, 70, 2, prep, n_over_relax=n_or, device=cuda)
            assert run().engine in (sweep.XY_DISORDER_ANGLE,
                                    sweep.XY_DISORDER_INT16)
            card = run()(key)
            with monkeypatch.context() as m:
                for mod in mods:
                    m.setattr(mod, "_on_cpu", lambda t: True)
                plain = run()(key)
            for name in plain:
                assert torch.allclose(card[name], plain[name], rtol=0,
                                      atol=1e-12), name
        monkeypatch.delenv(switch)


# ---------------------------------------------------------------------------
# the sharded halo kernels and the mesh (parallel/domain.py)
# ---------------------------------------------------------------------------

def _shard_spins(g, shape, dev):
    return torch.from_numpy(
        (g.integers(0, 2, size=shape) * 2 - 1).astype(np.int8)).to(dev)


def _shard_words(g, shape, dev):
    return torch.from_numpy(g.integers(-2 ** 31, 2 ** 31, size=shape,
                                       dtype=np.int64).astype(np.int32)
                            ).to(dev)


def _same(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    return all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("color", [0, 1])
@pytest.mark.parametrize("col0", [None, 0, 3, 130, 1])
def test_int8_halo_kernel_matches_plain(cuda, color, col0):
    """ising2d_pallas.sharded_phase on the card against its plain version:
    Philox and injected words, with and without column halos (col0 % 4 !=
    0 cuts a unit), plain and measuring."""
    from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
        ising2d_pallas as i2p,
    )
    g = np.random.default_rng(color)
    R, L, H = 3, 34, 63
    x, o = _shard_spins(g, (R, L, H), cuda), _shard_spins(g, (R, L, H), cuda)
    up, dn = _shard_spins(g, (R, 1, H), cuda), _shard_spins(g, (R, 1, H), cuda)
    kw = dict(color=color, beta=1 / KBT)
    offs = (2, 68) if col0 is None else (2, 68, col0)
    if col0 is not None:
        kw.update(halo_lf=_shard_spins(g, (R, L, 1), cuda),
                  halo_rt=_shard_spins(g, (R, L, 1), cuda))
    seeds = rng.seeds_from_key(rng.base_key(4), color)
    bits = _shard_words(g, (R, L, H), cuda)
    for extra in ({}, {"bits": bits}, {"measuring": True}):
        got = i2p.sharded_phase(x.clone(), o, up, dn, seeds, offs, **kw,
                                **extra)
        want = i2p.sharded_phase_plain(x, o, up, dn, seeds, offs, **kw,
                                       **extra)
        assert _same(got, want), extra


@pytest.mark.cuda
@pytest.mark.parametrize("color", [0, 1])
def test_int8_3d_halo_kernel_matches_plain(cuda, color):
    from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
        ising3d_pallas as i3p,
    )
    g = np.random.default_rng(10 + color)
    R, L, NY, H = 2, 4, 10, 13
    x, o = (_shard_spins(g, (R, L, NY, H), cuda) for _ in range(2))
    zm, zp = (_shard_spins(g, (R, 1, NY, H), cuda) for _ in range(2))
    seeds = rng.seeds_from_key(rng.base_key(5), color)
    bits = _shard_words(g, (R, L, NY, H), cuda)
    kw = dict(color=color, beta=1 / 4.51152)
    for extra in ({}, {"bits": bits}, {"measuring": True}):
        got = i3p.sharded_phase(x.clone(), o, zm, zp, seeds, (4, 6), **kw,
                                **extra)
        want = i3p.sharded_phase_plain(x, o, zm, zp, seeds, (4, 6), **kw,
                                       **extra)
        assert _same(got, want), extra


@pytest.mark.cuda
@pytest.mark.parametrize("color", [0, 1])
@pytest.mark.parametrize("cols", [False, True])
def test_packed_shard_kernel_matches_plain(cuda, color, cols):
    g = np.random.default_rng(20 + color)
    R, LP, H = 2, 3, 40
    x, o = (_shard_words(g, (R, LP, H), cuda) for _ in range(2))
    up = torch.from_numpy(g.integers(0, 2, (R, 1, H)).astype(np.int32))
    dn = torch.from_numpy(g.integers(0, 2, (R, 1, H)).astype(np.int32))
    up, dn = up.to(cuda), dn.to(cuda)
    kw = dict(color=color, beta=1 / KBT)
    offs = (2, 5)
    if cols:
        offs = (2, 5, 40)
        kw.update(halo_lf=_shard_words(g, (R, LP, 1), cuda),
                  halo_rt=_shard_words(g, (R, LP, 1), cuda))
    seeds = rng.seeds_from_key(rng.base_key(6), color)
    b4, b8 = (_shard_words(g, (R, LP, H), cuda) for _ in range(2))
    for extra in ({}, {"b4": b4, "b8": b8}, {"measuring": True}):
        got = msb.sharded_phase_packed(x, o, up, dn, seeds, offs, **kw,
                                       **extra)
        want = msb.sharded_phase_packed_plain(x, o, up, dn, seeds, offs,
                                              **kw, **extra)
        assert _same(got, want), extra


@pytest.mark.cuda
@pytest.mark.parametrize("color", [0, 1])
def test_packed3d_shard_kernel_matches_plain(cuda, color):
    from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
        ising3d_multispin as ms3,
    )
    g = np.random.default_rng(30 + color)
    R, L, NYP, H = 2, 4, 3, 20
    x, o = (_shard_words(g, (R, L, NYP, H), cuda) for _ in range(2))
    zm, zp = (_shard_words(g, (R, 1, NYP, H), cuda) for _ in range(2))
    seeds = rng.seeds_from_key(rng.base_key(7), color)
    bits = {k: _shard_words(g, (R, L, NYP, H), cuda)
            for k in ("b4", "b8", "b12")}
    kw = dict(color=color, beta=1 / 4.51152)
    for extra in ({}, bits, {"measuring": True}):
        got = ms3.sharded_phase3d_packed(x, o, zm, zp, seeds, (2, 6), **kw,
                                         **extra)
        want = ms3.sharded_phase3d_packed_plain(x, o, zm, zp, seeds, (2, 6),
                                                **kw, **extra)
        assert _same(got, want), extra


# ragged z-shards (R, L, nyp, half) at global offsets (rep0, z0): partial
# column tiles, word rows not a multiple of 8, an odd z0, one plane with
# both halos, one word
PACKED3D_RAGGED_SHARDS = [((3, 5, 9, 45), (1, 3)), ((2, 1, 17, 33), (4, 7)),
                          ((1, 1, 1, 1), (0, 0)), ((2, 3, 8, 70), (0, 2))]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,offs", PACKED3D_RAGGED_SHARDS)
def test_packed3d_shard_kernel_ragged_shards(cuda, shape, offs):
    """phase_kernel<true> at ragged shard shapes, both colours, injected
    planes, Philox words plain and measuring, at the 3-D classes' kbt and
    a kbt whose chains draw no word: bitwise against the plain version."""
    from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
        ising3d_multispin as ms3,
    )
    g = np.random.default_rng(sum(shape))
    R, L, NYP, H = shape
    x, o, b4, b8, b12 = (_shard_words(g, shape, cuda) for _ in range(5))
    zm, zp = (_shard_words(g, (R, 1, NYP, H), cuda) for _ in range(2))
    for color in (0, 1):
        seeds = rng.seeds_from_key(rng.base_key(21), color)
        for kbt in (4.51152, 0.2):
            kw = dict(color=color, beta=1 / kbt)
            for extra in ({}, {"b4": b4, "b8": b8, "b12": b12},
                          {"measuring": True}):
                got = ms3.sharded_phase3d_packed(x, o, zm, zp, seeds, offs,
                                                 **kw, **extra)
                want = ms3.sharded_phase3d_packed_plain(
                    x, o, zm, zp, seeds, offs, **kw, **extra)
                assert _same(got, want), (color, kbt, extra)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["packed2d", "int8_2d", "packed3d",
                                  "int8_3d"])
def test_mesh_on_one_card_equals_unsharded(cuda, case):
    """A (1, 4) mesh over one card repeated (and (1, 2, 2) in 2-D) gives
    the unsharded route's series bit for bit, through the halo kernels."""
    from cuda_fortran_mc_simulation_spin_tpu_torch.models import Ising3D
    from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
        ising2d_pallas as i2p,
        ising3d_multispin as ms3,
        ising3d_pallas as i3p,
    )
    from cuda_fortran_mc_simulation_spin_tpu_torch.parallel import (
        domain,
        mesh as mesh_mod,
    )
    model, unsharded, mod, shapes = {
        "packed2d": (Ising2D(nx=256, ny=256, kbt=KBT),
                     sweep.make_multispin_runner, msb,
                     [(1, 4), (1, 2, 2)]),
        "int8_2d": (Ising2D(nx=44, ny=24, kbt=KBT),
                    sweep.make_batch_runner, i2p, [(1, 4), (1, 2, 2)]),
        "packed3d": (Ising3D(nx=256, ny=256, nz=8, kbt=4.51152),
                     sweep.make_multispin3d_runner, ms3, [(1, 4)]),
        "int8_3d": (Ising3D(nx=12, ny=10, nz=8, kbt=4.51152),
                    sweep.make_batch_runner, i3p, [(1, 4)]),
    }[case]
    key = rng.sample_key(rng.base_key(42), 0)
    want = unsharded(model, 6, 2, "random", device=cuda)(key)
    for shape in shapes:
        msh = mesh_mod.make_mesh(*shape, devices=[cuda] * 4)
        mod.reset_launches()
        got = domain.make_sharded_sample_runner(model, msh, 6, 2,
                                                "random")(key)
        key_name = "shard_phase" if case.startswith("packed") else \
            "halo_phase"
        assert mod.LAUNCHES[key_name] == 4 * 2 * 6
        for k in ("m", "e"):
            assert torch.equal(got[k], want[k]), (shape, k)


# ---------------------------------------------------------------------------
# the clock and XY halo modes and their mesh runs
# ---------------------------------------------------------------------------

def _sums_close(got, want, scale):
    """float64 partials taken in another order: within 1e-12 of the
    sums' scale (the sites summed)."""
    for a, b in zip(got, want):
        assert float((a - b).abs().max()) <= 1e-12 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("q", [6, 4, 3])
@pytest.mark.parametrize("cols", [False, True])
def test_packed_clock_halo_kernel_matches_plain(cuda, q, cols):
    """clock_planes.sharded_phase_packed on the card against its plain
    version: Philox and injected planes, both colours, plain and
    measuring, with and without word columns, shards of one, three and
    nine word rows (a partial word-row tile) and partial column tiles."""
    from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
        clock3_multispin,
        clock4_multispin,
        clock_multispin,
        clock_planes as cp,
    )
    spec = {6: clock_multispin, 4: clock4_multispin,
            3: clock3_multispin}[q].SPEC
    g = np.random.default_rng(40 + q)
    for nyw, half in ((1, 33), (3, 70), (9, 40)):
        R = 2
        a, b = (torch.from_numpy(g.integers(0, q, (R, 32 * nyw, half))
                                 .astype(np.int8)).to(cuda)
                for _ in range(2))
        x, o = spec.pack_color(a), spec.pack_color(b)
        bits = [_shard_words(g, (R, 1, half), cuda) & 1 for _ in range(6)]
        kw = dict(beta=1 / 0.8)
        offs = (2, 6)
        if cols:
            offs = (2, 6, 40)
            kw.update(halo_lf=tuple(_shard_words(g, (R, nyw, 1), cuda)
                                    for _ in x),
                      halo_rt=tuple(_shard_words(g, (R, nyw, 1), cuda)
                                    for _ in x))
        inj = tuple(_shard_words(g, (R, nyw, half), cuda)
                    for _ in range(spec.n_rand))
        for color in (0, 1):
            seeds = rng.seeds_from_key(rng.base_key(8), color)
            for extra in ({}, {"inject": inj}, {"measuring": True}):
                args = (spec, x, o, tuple(bits[:len(x)]),
                        tuple(bits[3:3 + len(x)]), seeds, offs)
                got = cp.sharded_phase_packed(*args, color=color, **kw,
                                              **extra)
                want = cp.sharded_phase_packed_plain(*args, color=color,
                                                     **kw, **extra)
                if extra.get("measuring"):
                    got, want = (*got[0], *got[1:]), (*want[0], *want[1:])
                assert all(torch.equal(u, v) for u, v in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("q", [2, 5, 6, 20])
@pytest.mark.parametrize("col0", [None, 0, 11])
def test_int8_clock_halo_kernel_matches_plain(cuda, q, col0):
    """clock_pallas.sharded_phase on the card against its plain version:
    Philox and injected uniforms, both colours, plain and measuring, with
    and without column halos; col0 = 11 cuts a unit of two columns."""
    from cuda_fortran_mc_simulation_spin_tpu_torch.ops import clock_pallas
    g = np.random.default_rng(50 + q)
    R, L, H = 3, 9, 23

    def states(shape):
        return torch.from_numpy(g.integers(0, q, shape).astype(np.int8)
                                ).to(cuda)

    x, o, up, dn = (states(s) for s in ((R, L, H), (R, L, H), (R, 1, H),
                                         (R, 1, H)))
    kw = dict(q=q, beta=1 / 0.91)
    offs = (1, 5) if col0 is None else (1, 5, col0)
    if col0 is not None:
        kw.update(halo_lf=states((R, L, 1)), halo_rt=states((R, L, 1)))
    uc, ua = (torch.rand((R, L, H), device=cuda) for _ in range(2))
    for color in (0, 1):
        seeds = rng.seeds_from_key(rng.base_key(9), color)
        for extra in ({}, {"u_cand": uc, "u_acc": ua}, {"measuring": True}):
            got = clock_pallas.sharded_phase(x.clone(), o, up, dn, seeds,
                                             offs, color=color, **kw,
                                             **extra)
            want = clock_pallas.sharded_phase_plain(x, o, up, dn, seeds,
                                                    offs, color=color, **kw,
                                                    **extra)
            if extra.get("measuring"):
                assert torch.equal(got[0], want[0])
                _sums_close(got[1:], want[1:], 2 * L * H)
            else:
                assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("col0", [None, 0, 11])
def test_xy_halo_kernels_match_plain(cuda, col0):
    """xy2d_pallas.sharded_phase (plain, measuring, snapshot mode; Philox
    and injected) and sharded_or_phase (plain, measuring) on the card:
    states bitwise, sums to float64 rounding."""
    from cuda_fortran_mc_simulation_spin_tpu_torch.ops import xy2d_pallas
    g = np.random.default_rng(60)
    R, L, H = 2, 9, 23

    def unit(shape):
        th = torch.from_numpy(g.uniform(0, 2 * np.pi, shape)).to(cuda)
        return torch.cos(th).float(), torch.sin(th).float()

    (sx, sy), (ox, oy) = unit((R, L, H)), unit((R, L, H))
    (ux, uy), (dx, dy) = unit((R, 1, H)), unit((R, 1, H))
    kw = dict(halos_x=(ux, dx), halos_y=(uy, dy))
    offs = (2, 7) if col0 is None else (2, 7, col0)
    if col0 is not None:
        (lx, ly), (rx, ry) = unit((R, L, 1)), unit((R, L, 1))
        kw.update(cols_x=(lx, rx), cols_y=(ly, ry))
    snap = [p for pair in (unit((R, L, H)), unit((R, L, H))) for p in pair]
    uc, ua = (torch.rand((R, L, H), device=cuda) for _ in range(2))
    for color in (0, 1):
        seeds = rng.seeds_from_key(rng.base_key(10), color)
        for extra in ({}, {"u_cand": uc, "u_acc": ua}, {"measuring": True},
                      {"snap": snap}):
            got = xy2d_pallas.sharded_phase(
                sx.clone(), sy.clone(), ox, oy, seeds=seeds, offs=offs,
                color=color, beta=1 / 0.89, **kw, **extra)
            want = xy2d_pallas.sharded_phase_plain(
                sx.clone(), sy.clone(), ox, oy, seeds=seeds, offs=offs,
                color=color, beta=1 / 0.89, **kw, **extra)
            assert torch.equal(got[0], want[0]) and torch.equal(got[1],
                                                                 want[1])
            if len(got) == 3:
                _sums_close(got[2].T, want[2].T, 2 * L * H)
        for measuring in (False, True):
            got = xy2d_pallas.sharded_or_phase(
                sx.clone(), sy.clone(), ox, oy, offs=offs, color=color,
                measuring=measuring, **kw)
            want = xy2d_pallas.sharded_or_phase_plain(
                sx.clone(), sy.clone(), ox, oy, offs=offs, color=color,
                measuring=measuring, **kw)
            assert torch.equal(got[0], want[0]) and torch.equal(got[1],
                                                                 want[1])
            if measuring:
                _sums_close(got[2].T, want[2].T, 2 * L * H)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["clock6", "clock5", "xy_or", "fix1mcs"])
def test_clock_xy_mesh_on_the_card_equals_unsharded(cuda, case):
    """The mesh runners over one card repeated, through the halo modes:
    the packed clock's series bitwise against the same mesh on the CPU
    (exact integer sums, no float arithmetic); the int8 clock's and XY's
    within 1e-12 of the unsharded runner's on the card (the same kernels'
    arithmetic, float64 sums in another order; the card's expf and
    rsqrtf are not the CPU's, so the CPU is no bitwise reference for
    them)."""
    from cuda_fortran_mc_simulation_spin_tpu_torch.models import (
        Clock2D,
        XY2D,
    )
    from cuda_fortran_mc_simulation_spin_tpu_torch.parallel import (
        domain,
        mesh as mesh_mod,
    )
    key = rng.sample_key(rng.base_key(42), 0)
    shape = (2, 2) if case == "clock6" else (1, 2, 2)
    xy = XY2D(nx=44, ny=16, kbt=0.89)
    kw = {"n_over_relax": 1, "mcs_over_relax": 3} if case == "xy_or" else {}

    def mesh_run(dev):
        msh = mesh_mod.make_mesh(*shape, devices=[dev] * 4)
        if case == "clock6":
            return domain.make_sharded_sample_runner(
                Clock2D(nx=128, ny=128, kbt=0.8, q=6), msh, 6, 4,
                "random")(key)
        if case == "clock5":
            return domain.make_sharded_sample_runner(
                Clock2D(nx=44, ny=24, kbt=0.91, q=5), msh, 6, 4,
                "random")(key)
        if case == "xy_or":
            return domain.make_sharded_sample_runner(xy, msh, 6, 4,
                                                     "random", **kw)(key)
        return domain.make_sharded_xy_disorder_runner(xy, msh, 6, 4,
                                                      "fix1mcs")(key)

    got = {k: v.cpu() for k, v in mesh_run(cuda).items()}
    if case == "clock6":
        want = mesh_run(torch.device("cpu"))
    elif case == "clock5":
        want = sweep.make_batch_runner(Clock2D(nx=44, ny=24, kbt=0.91, q=5),
                                       6, 4, "random", device=cuda)(key)
    elif case == "xy_or":
        want = sweep.make_xy_runner(xy, 6, 4, "random", device=cuda,
                                    **kw)(key)
    else:
        want = sweep.make_xy_disorder_runner(xy, 6, 4, "fix1mcs",
                                             device=cuda)(key)
    for k, v in want.items():
        if case == "clock6":
            assert torch.equal(got[k], v.cpu()), k
        else:
            assert float((got[k] - v.cpu()).abs().max()) <= 1e-12, k
