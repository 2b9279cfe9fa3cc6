"""The fit rule and ring walk of the int16 XY multisweep's shared-memory
mode (ops/xy2d_multisweep.smem_layout, csrc/xy2d_ring.cuh), on the CPU.

``smem_multisweep_kernel`` runs on the card only (tests/test_torch_cuda.py
holds it bitwise against ``multisweep_plain`` there).  Held here:

- the fit rule: the int16 class's 1536x1536 x 1 fits with its snapshot;
  a state that fits without its snapshot keeps the snapshot in device
  memory; batches past the fit (1536x1536 x 2) are None; the layout's
  invariants for every shape hypothesis draws;
- the walk of a block's sites as the kernel makes it (four groups of 256
  threads over the chunks, the edge chunks first; a site's row, column and
  side slot from its chunk's first site and the thread's offset): every
  site of a replica once a phase, each reading its four neighbours' true
  slots in the decoded plane, its halos the ring neighbours' edge sites;
- the wrapper's choice between the two modes (the device-memory mode,
  ``gmem_multisweep_kernel``, on its layout past the fit or where forced),
  against a recording stand-in for the built library."""

from contextlib import nullcontext

import pytest
import torch
from hypothesis import given, settings, strategies as st

from cuda_fortran_mc_simulation_spin_tpu_torch.ops import xy2d_multisweep as xi
from cuda_fortran_mc_simulation_spin_tpu_torch.ops import xy2d_resident as xr

# the H100: 132 SMs, one block of 1024 threads an SM, 227 KB of shared
# memory a block less the runtime's 1 KB
SMS = 132
SMEM = 232448 - 1024
CHUNK = 256
GROUPS = 4


def _owned(layout, n):
    return [min(b * CHUNK, n) - a * CHUNK
            for a, b in zip(layout.bounds, layout.bounds[1:])]


def _need(cap, half, snap):
    """A block's bytes: the other colour decoded (8 B a site and halo
    site), 264 B a chunk, both colours' int16 sites and with ``snap`` the
    snapshot's."""
    return 8 * (cap + 2 * half) + cap // CHUNK * 264 + 4 * cap * (1 + snap)


def _check(layout, nrep, ny, half, sms, smem):
    n = ny * half
    chunks = -(-n // CHUNK)
    assert layout.blocks >= 1 and nrep * layout.blocks <= sms
    assert layout.bounds[0] == 0 and layout.bounds[-1] == chunks
    assert all(a < b for a, b in zip(layout.bounds, layout.bounds[1:]))
    owned = _owned(layout, n)
    assert sum(owned) == n and min(owned) >= half
    assert layout.cap == max(b - a for a, b in zip(
        layout.bounds, layout.bounds[1:])) * CHUNK
    assert layout.smem_bytes == _need(layout.cap, half, layout.snap)
    assert layout.smem_bytes <= smem
    if not layout.snap:
        assert _need(layout.cap, half, True) > smem
    assert (layout.blocks, layout.bounds, layout.cap) == xr.ring_bounds(
        nrep, ny, half, sms)


def test_main_path_shape_fits_with_its_snapshot():
    """1536x1536 x 1 (the int16 from-disorder class): a ring of 132 blocks
    of at most 35 chunks, 164,888 B a block with the snapshot."""
    layout = xi.smem_layout(1, 1536, 768, SMS, SMEM)
    assert (layout.blocks, layout.cap, layout.smem_bytes, layout.snap) == (
        132, 35 * CHUNK, 164888, True)
    _check(layout, 1, 1536, 768, SMS, SMEM)


def test_state_without_its_snapshot():
    """2048x2048 x 1: the state fits, the snapshot stays in device
    memory."""
    layout = xi.smem_layout(1, 2048, 1024, SMS, SMEM)
    assert layout.snap is False and layout.cap == 63 * CHUNK
    _check(layout, 1, 2048, 1024, SMS, SMEM)


@pytest.mark.parametrize("nrep,n", [(2, 1536), (3, 1536), (1, 4096),
                                    (133, 32)])
def test_past_the_fit_is_none(nrep, n):
    """1536x1536 x 2 and x 3 (the int16 route admits them: the
    device-memory mode's batches), 4096x4096 x 1 and more replicas than
    blocks."""
    assert xi.smem_layout(nrep, n, n // 2, SMS, SMEM) is None


@settings(max_examples=300, deadline=None)
@given(nrep=st.integers(1, 140), ny=st.integers(2, 3000),
       half=st.integers(1, 1600), sms=st.sampled_from([1, 2, 66, 132, 264]),
       smem=st.sampled_from([4096, 115712, SMEM]))
def test_layout_invariants(nrep, ny, half, sms, smem):
    """Any batch on any slots and shared memory: the layout, where there
    is one, is the resident ring's (every chunk once, blocks of at least a
    row, halos in the ring neighbours), under the limit, with the
    snapshot wherever it fits; None only where even the state overflows."""
    layout = xi.smem_layout(nrep, ny, half, sms, smem)
    if layout is not None:
        _check(layout, nrep, ny, half, sms, smem)
        return
    ring = xr.ring_bounds(nrep, ny, half, sms)
    assert ring is None or _need(ring[2], half, False) > smem


def _walk(h, m, nch):
    """csrc/xy2d_ring.cuh ring::Walk: (head, tail, edges, chunk(p))."""
    head = min(-(-h // CHUNK), nch)
    tail = min(nch - (m - h) // CHUNK, nch - head)
    edges = head + tail

    def chunk(p):
        return p if p < head else (nch - tail + (p - head) if p < edges
                                   else p - tail)
    return edges, chunk


def _slot(yi, dy, di, h, c, l):
    """csrc/xy2d_ring.cuh ring::Slot: (y, i, ls)."""
    y, i = yi[0] + dy, yi[1] + di
    if i >= h:
        i -= h
        y += 1
    plus = (c == 0) == (y % 2 == 1)
    ls = (l - i if i == h - 1 else l + 1) if plus else \
        (l - i + h - 1 if i == 0 else l - 1)
    return y, i, ls


@pytest.mark.parametrize("ny,half,sms", [(1536, 768, SMS), (32, 24, 5),
                                         (8, 750, SMS), (12, 100, 7),
                                         (6, 256, 3)])
def test_ring_walk_visits_every_site_once_with_its_neighbours(ny, half,
                                                              sms):
    """The kernel's walk of one replica's ring, both colours: groups g
    take walk positions g, g + 4, ...; thread t of a group takes site
    (c0 + chunk(p)) 256 + t.  Every site once a phase, at (y, i) =
    divmod(w, half); its slots l -+ half and its side slot hold the
    decoded plane's (y -+ 1, i) and (y, i -+ 1) (wrapping) of the other
    colour, all inside the block's span; the halo slots are the ring
    neighbours' edge sites; the edge chunks hold the first and last
    ``half`` owned sites."""
    layout = xi.smem_layout(1, ny, half, sms, SMEM)
    assert layout is not None
    n, h, nb = ny * half, half, layout.blocks
    starts = [a * CHUNK for a in layout.bounds[:-1]]
    ends = [min(b * CHUNK, n) for b in layout.bounds[1:]]
    for c in (0, 1):
        seen = [0] * n
        for j in range(nb):
            c0 = layout.bounds[j]
            nch = layout.bounds[j + 1] - c0
            lo, m = c0 * CHUNK, min(nch * CHUNK, n - c0 * CHUNK)
            rows = [divmod((c0 + q) * CHUNK, h) for q in range(nch)]
            edges, chunk = _walk(h, m, nch)
            assert sorted(chunk(p) for p in range(nch)) == list(range(nch))
            edge_sites = {(c0 + chunk(p)) * CHUNK + t - lo
                          for p in range(edges) for t in range(CHUNK)}
            assert set(range(h)) | set(range(m - h, m)) <= edge_sites

            def site_at(l):
                """The global site of the decoded plane's slot l."""
                return (lo - h + l) % n
            for l in range(h):      # halos: the ring neighbours' edges
                assert starts[(j - 1) % nb] <= site_at(l) < ends[(j - 1) % nb]
                assert starts[(j + 1) % nb] <= site_at(h + m + l) < \
                    ends[(j + 1) % nb]
            for g in range(GROUPS):
                for p in range(g, nch, GROUPS):
                    q = chunk(p)
                    for t in range(CHUNK):
                        w = (c0 + q) * CHUNK + t
                        if w >= n:
                            continue
                        seen[w] += 1
                        l = w - lo + h
                        dy, di = divmod(t, h)
                        y, i, ls = _slot(rows[q], dy, di, h, c, l)
                        assert (y, i) == divmod(w, h)
                        plus = (c == 0) == (y % 2 == 1)
                        side = (i + 1) % h if plus else (i - 1) % h
                        for slot, (yy, ii) in ((l - h, ((y - 1) % ny, i)),
                                               (l + h, ((y + 1) % ny, i)),
                                               (l, (y, i)), (ls, (y, side))):
                            assert 0 <= slot < m + 2 * h
                            assert site_at(slot) == yy * h + ii
        assert seen == [1] * n


class _FakeLib:
    """Records the C calls of the wrapper in place of the built library."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def call(*args):
            self.calls.append((name, args))
            return 0
        return call


@pytest.mark.parametrize("n,nrep,grid,n_or,want", [
    (1536, 1, False, 0, "xyi_multisweep_smem"),
    (1536, 1, False, 1, "xyi_multisweep_smem"),
    (1536, 2, False, 0, "xyi_multisweep_gmem"),
    (1536, 1, True, 0, "xyi_multisweep_gmem"),
    (32, 3, False, 2, "xyi_multisweep_smem")])
def test_launch_mode_follows_the_fit_rule(n, nrep, grid, n_or, want,
                                          monkeypatch):
    """multisweep_planes launches the shared-memory mode where the layout
    fits and the device-memory mode past it, or where ``grid`` forces it;
    the shared-memory launch takes the layout's ring, cap, bytes and
    snapshot flag, the device-memory launch its gmem_layout (blocks a
    ring, rings, cap, held and decoded chunks, bytes), and the launch is
    counted under its mode.  The launch is recorded, not run (no card
    here)."""
    lib = _FakeLib()
    monkeypatch.setattr(xi, "_on_cpu", lambda t: False)
    monkeypatch.setattr(xi, "_check", lambda planes: None)
    monkeypatch.setattr(xi, "_stream", lambda t: None)
    monkeypatch.setattr(xi.multispin_rng, "keys_to", lambda seeds, dev: seeds)
    monkeypatch.setattr(xi, "_lib", lambda: lib)
    monkeypatch.setattr(xi, "smem_limits", lambda dev: (SMS, SMEM))
    monkeypatch.setattr(xi, "gmem_limits", lambda dev: (SMS, SMEM))
    monkeypatch.setattr(xi, "_RINGS", {})
    monkeypatch.setattr(torch.cuda, "device", lambda d: nullcontext())
    planes = [torch.zeros((nrep, n, n // 2), dtype=torch.int16)
              for _ in range(4)]
    seeds = torch.zeros((3, 2, 2), dtype=torch.int32)
    xi.reset_launches()
    obs = xi.multisweep_planes(*planes, seeds, beta=1.0, n_or=n_or,
                               grid=grid)
    assert obs.shape == (nrep, 3, 4)
    (name, args), = lib.calls
    assert name == want
    if want == "xyi_multisweep_smem":
        layout = xi.smem_layout(nrep, n, n // 2, SMS, SMEM)
        assert args[10:20] == (nrep, n, n // 2, 3, n_or, 0, layout.blocks,
                               layout.cap, layout.smem_bytes,
                               int(layout.snap))
        assert xi.LAUNCHES == {"multisweep": 0, "multisweep_smem": 1}
    else:
        layout = xi.gmem_layout(nrep, n, n // 2, SMS, SMEM)
        assert args[9:21] == (nrep, n, n // 2, 3, n_or, 0, layout.blocks,
                              layout.rings, layout.cap, layout.hold,
                              layout.dec, layout.smem_bytes)
        assert xi.LAUNCHES == {"multisweep": 1, "multisweep_smem": 0}
