"""The fit rule and ring layout of the resident XY multisweep's
shared-memory mode (ops/xy2d_resident.smem_layout), on the CPU.

``smem_multisweep_kernel`` runs on the card only (tests/test_torch_cuda.py
holds it bitwise against streamed sweeps there); what the kernel relies on
is the layout this pure function computes, held here for every shape
hypothesis draws and at the main path's 1500x1500 and 1000x1000:

- every chunk of 256 sites of a replica is owned by exactly one block of
  its ring, in whole chunks, in order;
- every block owns at least ``half`` real sites, so the other colour's
  ``half`` sites before and after its range (its halos) lie in its two
  ring neighbours' ranges (or its own, on a ring of one or two);
- the shared memory a block takes is under the limit passed in, and the
  layout is None past the fit.

The wrapper's choice between the two modes (the fit rule, or a forced
mode) is held against a recording stand-in for the built library."""

from contextlib import nullcontext

import pytest
import torch
from hypothesis import given, settings, strategies as st

from cuda_fortran_mc_simulation_spin_tpu_torch.models.xy2d import XYState
from cuda_fortran_mc_simulation_spin_tpu_torch.ops import xy2d_resident as xr

# the H100: 132 SMs, 227 KB of shared memory a block at one block an SM
SMS = 132
SMEM = 232448
CHUNK = 256


def _owned(layout, n):
    """Real sites each block of a ring owns."""
    return [min(b * CHUNK, n) - a * CHUNK
            for a, b in zip(layout.bounds, layout.bounds[1:])]


def _need(cap, half):
    """Shared memory a block of ``cap`` sites takes: both colours' sites
    and halos as float2, and 264 B a chunk (8 warps' 4 float64 sums, the
    chunk's first (row, column))."""
    return 16 * (cap + 2 * half) + cap // CHUNK * 264


def _check(layout, nrep, ny, half, sms, smem):
    n = ny * half
    chunks = -(-n // CHUNK)
    assert layout.blocks >= 1 and nrep * layout.blocks <= sms
    assert len(layout.bounds) == layout.blocks + 1
    assert layout.bounds[0] == 0 and layout.bounds[-1] == chunks
    assert all(a < b for a, b in zip(layout.bounds, layout.bounds[1:]))
    owned = _owned(layout, n)
    assert sum(owned) == n
    assert min(owned) >= half
    assert layout.cap == max(b - a for a, b in zip(
        layout.bounds, layout.bounds[1:])) * CHUNK
    assert max(owned) <= layout.cap
    assert layout.smem_bytes == _need(layout.cap, half)
    assert layout.smem_bytes <= smem
    # the halos: sites [lo - half, lo) and [hi, hi + half) modulo n lie in
    # the ring neighbours' ranges
    starts = [a * CHUNK for a in layout.bounds[:-1]]
    ends = [min(b * CHUNK, n) for b in layout.bounds[1:]]
    nb = layout.blocks
    for j in range(nb):
        prev, nxt = (j - 1) % nb, (j + 1) % nb
        for w in (starts[j] - half, starts[j] - 1):
            w %= n
            assert starts[prev] <= w < ends[prev] or nb == 1
        for w in (ends[j], ends[j] + half - 1):
            w %= n
            assert starts[nxt] <= w < ends[nxt] or nb == 1


@pytest.mark.parametrize("nrep,n,blocks,cap,smem", [
    (1, 1500, 132, 34 * CHUNK, 172240),
    (1, 1000, 132, 15 * CHUNK, 81400),
    (2, 1000, 66, 30 * CHUNK, 146800)])
def test_main_path_shapes_fit(nrep, n, blocks, cap, smem):
    """The from-disorder class's 1500x1500 x 1 and the samples class's
    1000x1000 x 1 fit, on one block an SM; so does 1000x1000 x 2, each
    replica on its own ring of 66."""
    layout = xr.smem_layout(nrep, n, n // 2, SMS, SMEM)
    assert (layout.blocks, layout.cap, layout.smem_bytes) == (blocks, cap,
                                                              smem)
    _check(layout, nrep, n, n // 2, SMS, SMEM)


@pytest.mark.parametrize("nrep,n", [(2, 1500), (3, 1500), (1, 2000),
                                    (133, 16)])
def test_past_the_fit_is_none(nrep, n):
    """1500x1500 x 2 and x 3 (under the route bound: the device-memory
    mode's batches), 2000x2000 x 1, and more replicas than blocks."""
    assert xr.smem_layout(nrep, n, n // 2, SMS, SMEM) is None


def test_ring_shrinks_to_blocks_of_a_row():
    """8 x 1500: 6000 sites, 24 chunks of which the last holds 112; a
    ring of 24 one-chunk blocks (256 sites, a third of a 750-site row)
    shrinks to 7 blocks of 3 or 4 chunks, the last 880 real sites."""
    layout = xr.smem_layout(1, 8, 750, SMS, SMEM)
    assert layout.blocks == 7
    assert _owned(layout, 6000) == [768, 768, 1024, 768, 1024, 768, 880]


@settings(max_examples=300, deadline=None)
@given(nrep=st.integers(1, 140), ny=st.integers(2, 3000),
       half=st.integers(1, 1600), sms=st.sampled_from([1, 2, 66, 132, 264]),
       smem=st.sampled_from([4096, 115712, SMEM]))
def test_layout_invariants(nrep, ny, half, sms, smem):
    """Any (nrep, ny, even nx = 2 half) on any slots and shared memory:
    the layout, where there is one, owns every chunk once in whole chunks,
    blocks of at least a row, halos in the ring neighbours, under the
    limit; None only past the fit (too many replicas, or a state the
    shared memory cannot hold even on the widest ring)."""
    layout = xr.smem_layout(nrep, ny, half, sms, smem)
    if layout is not None:
        _check(layout, nrep, ny, half, sms, smem)
        return
    per = sms // nrep
    if per < 1:
        return
    # None: even the smallest cap the ring could take overflows
    n = ny * half
    chunks = -(-n // CHUNK)
    fewest = -(-chunks // min(per, chunks)) * CHUNK
    assert _need(fewest, half) > smem


class _FakeLib:
    """Records the C calls of the wrapper in place of the built library."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def call(*args):
            self.calls.append((name, args))
            return 0
        return call


@pytest.mark.parametrize("n,nrep,grid,want", [
    (1500, 1, False, "xy_multisweep_smem"),
    (1500, 2, False, "xy_multisweep_gmem"),
    (1000, 1, True, "xy_multisweep_gmem"),
    (16, 3, False, "xy_multisweep_smem"),
    (1500, 2, True, "xy_multisweep_gmem")])
def test_launch_mode_follows_the_fit_rule(n, nrep, grid, want, monkeypatch):
    """multisweep_planes launches the shared-memory mode where the layout
    fits and the device-memory mode past it, or where ``grid`` forces it;
    each launch takes its layout's ring, cap and bytes, and is counted
    under its mode.  The launch itself is recorded, not run (no card
    here)."""
    from cuda_fortran_mc_simulation_spin_tpu_torch.ops import xy2d_pallas
    lib = _FakeLib()
    monkeypatch.setattr(xr, "_on_cpu", lambda t: False)
    monkeypatch.setattr(xy2d_pallas, "_check_planes", lambda *p: None)
    monkeypatch.setattr(xr, "_stream", lambda t: None)
    monkeypatch.setattr(xr, "_lib", lambda: lib)
    monkeypatch.setattr(xr, "smem_limits", lambda dev: (SMS, SMEM))
    monkeypatch.setattr(xr, "gmem_limits", lambda dev: (SMS, SMEM))
    monkeypatch.setattr(xr, "_RINGS", {})
    monkeypatch.setattr(torch.cuda, "device", lambda d: nullcontext())
    planes = XYState(*(torch.zeros((nrep, n, n // 2)) for _ in range(4)))
    seeds = torch.zeros((3, 2, 2), dtype=torch.int32)
    xr.reset_launches()
    obs = xr.multisweep_planes(planes, planes, seeds, beta=1.0, grid=grid)
    assert obs.shape == (nrep, 3, 4)
    (name, args), = lib.calls
    assert name == want
    if want == "xy_multisweep_smem":
        layout = xr.smem_layout(nrep, n, n // 2, SMS, SMEM)
        assert args[11:18] == (nrep, n, n // 2, 3, layout.blocks, layout.cap,
                               layout.smem_bytes)
        assert xr.LAUNCHES == {"multisweep": 0, "multisweep_smem": 1}
    else:
        layout = xr.gmem_layout(nrep, n, n // 2, SMS, SMEM)
        assert args[10:19] == (nrep, n, n // 2, 3, layout.blocks,
                               layout.rings, layout.cap, layout.hold,
                               layout.smem_bytes)
        assert xr.LAUNCHES == {"multisweep": 1, "multisweep_smem": 0}
