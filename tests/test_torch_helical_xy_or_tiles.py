"""The masked helical XY over-relaxation launch, replayed on the CPU.

``csrc/helical_pallas.cu`` runs one over-relaxation phase as the OVER mode
of ``xy_phase_kernel``: blocks of ``hp.THREADS`` aligned float4 vectors of
one replica, ``hp.XY_OR_VPT`` vectors a thread, from the constants the
wrapper passes (``hp.xy_tiles``, as ``xy_or_phase`` calls it).  This test
walks that launch in numpy, lane by lane, from the same constants: the
vectors each lane loads (its own, the aligned pair under its up and down
windows), its left and right sites from the neighbour lanes or, in lanes
0 and 31, its own loads, the per-element path at a replica's ends, on
planes whose offsets differ or at a small N; then the window networks and
the stores.

Every site must be stored exactly once, by the lane that holds it, and no
float outside its replica; every neighbour a site reads must be the
pre-phase value at the index the plain version reads; the reflection
through the replayed fields must equal ``xy_or_phase_plain`` bitwise, and
the TPU kernel's rule as tests/test_torch_helical_pallas.py restates it
from JAX's jnp pieces within that file's 1e-6 (jax.lax.rsqrt against
torch.rsqrt).

Shapes (R, ny, nx): 33x32 and 65x64 (even N), 33x31 (odd N: the wrap
pairs of one colour read their pre-phase values, out of place), (3, 30,
35) and (5, 31, 35) (replica bases off the 16-B grid), (2, 2, 3) (N below
one vector: every lane on the per-element path); planes at offsets 0 and
4-12 B, shared, and mismatched (every float alone).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_helical_pallas import MARGIN_RULE, _jax_or_rule
from test_torch_helical_pallas_tiles import (
    LANES,
    SHAPES,
    T,
    V,
    _neighbours,
    _pair,
    _window4,
)

from cuda_fortran_mc_simulation_spin_tpu_torch.models.xy2d import reflect
from cuda_fortran_mc_simulation_spin_tpu_torch.ops import helical_pallas as hp

W = V // 4
OFFSETS = [(0, 0, 0, 0), (4, 4, 4, 4), (12, 12, 12, 12), (0, 4, 8, 0),
           (8, 8, 8, 4)]


def _or_tiles(sx: np.ndarray, sy: np.ndarray, color: int, nx: int,
              offsets):
    """One over-relaxation launch through the kernel's blocks: the (2, R,
    N) field (hx, hy) each colour site reads, in the kernel's order, and
    the stores per float of each replica's span (the floats of the
    replica, and the ones before and after it that its vectors touch)."""
    nrep, n = sx.shape
    g = hp.xy_tiles(nrep, n, nx, offsets, vpt=hp.XY_OR_VPT)
    assert g["vpt"] == hp.XY_OR_VPT
    fields = np.zeros((2, nrep, n), np.float32)
    stores = np.zeros((nrep, n + 2 * W), np.int64)
    for r in range(nrep):
        px, py = sx[r], sy[r]
        rb = g["off0"] + r * n
        vl = (rb + n - 1) // W
        for bx, j in np.ndindex(g["nblk"], g["vpt"]):
            v = rb // W + T * (bx * g["vpt"] + j) + LANES
            warp = np.repeat(v[::32] <= vl, 32)
            if not warp.any():
                continue
            valid = v <= vl
            a = W * v - rb
            idx = a[:, None] + np.arange(W)
            live = (warp & valid)[:, None] & (idx >= 0) & (idx < n)
            (ox, _, oi), lx, rx = _neighbours(px, None, a, W)
            (oy, _, _), ly, ry = _neighbours(py, None, a, W)
            assert (oi[live] == idx[live]).all()
            # the window pairs: the down pair at a + nx - sd, the up pair
            # at a - nx - su, each element the float at its index mod N
            wins = []
            for first, sh, off in ((a + nx - g["sd"], g["sd"], nx),
                                   (a - nx - g["su"], g["su"], -nx)):
                xp, _, xi = _pair(px, None, first, W)
                yp = _pair(py, None, first, W)[0]
                sel = _window4(np.arange(W), np.arange(W, 2 * W), sh)
                assert (xi[:, sel][live] == ((idx + off) % n)[live]).all()
                wins.append((_window4(xp[:, :W], xp[:, W:], sh),
                             _window4(yp[:, :W], yp[:, W:], sh)))
            (dx, dy), (ux, uy) = wins
            lvx = np.concatenate([lx[0][:, None], ox[:, :W - 1]], axis=1)
            lvy = np.concatenate([ly[0][:, None], oy[:, :W - 1]], axis=1)
            rvx = np.concatenate([ox[:, 1:], rx[0][:, None]], axis=1)
            rvy = np.concatenate([oy[:, 1:], ry[0][:, None]], axis=1)
            hx = ((ux + dx) + lvx) + rvx
            hy = ((uy + dy) + lvy) + rvy
            site = live & ((idx & 1) == color)
            fields[0, r, idx[site]] = hx[site]
            fields[1, r, idx[site]] = hy[site]
            # a whole vector (planes sharing an offset, in the replica)
            # is stored as one float4, the others float by float, only
            # inside the replica
            whole = (g["vec"] == 1) & (a >= 0) & (a <= n - W)
            stored = (warp & valid)[:, None] & (
                whole[:, None] | ((idx >= 0) & (idx < n)))
            np.add.at(stores[r], idx[stored] + W, 1)
    return fields, stores


@pytest.mark.parametrize("offsets", OFFSETS)
@pytest.mark.parametrize("nrep,ny,nx", SHAPES)
def test_xy_or_through_the_tiles(nrep, ny, nx, offsets):
    n = ny * nx
    g = np.random.default_rng(13 * n + nrep + offsets[1])
    th = g.uniform(0, 2 * np.pi, size=(nrep, n))
    sx, sy = np.cos(th).astype(np.float32), np.sin(th).astype(np.float32)
    tx, ty = torch.from_numpy(sx), torch.from_numpy(sy)
    tiles = hp.xy_tiles(nrep, n, nx, offsets, vpt=hp.XY_OR_VPT)
    assert tiles["vec"] == int(len(set(offsets)) == 1)
    for color in (0, 1):
        fields, stores = _or_tiles(sx, sy, color, nx, offsets)
        # every float of the replica once; none before or after it
        assert (stores[:, W:W + n] == 1).all()
        assert not stores[:, :W].any() and not stores[:, W + n:].any()
        mask = hp.colour_mask(n, color)
        hx, hy = (torch.from_numpy(f) for f in fields)
        np.testing.assert_array_equal(hx[:, mask], hp.field(tx, nx)[:, mask])
        np.testing.assert_array_equal(hy[:, mask], hp.field(ty, nx)[:, mask])
        fx, fy = reflect(tx, ty, hx, hy)
        got = (torch.where(mask, fx, tx), torch.where(mask, fy, ty))
        want = hp.xy_or_phase_plain(tx, ty, color=color, nx=nx)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
        rule = _jax_or_rule(jnp.asarray(sx), jnp.asarray(sy), color, nx)
        for a, b in zip(got, rule):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=MARGIN_RULE)


def test_xy_or_tiles_cover_the_launch():
    """The OR launch's constants: XY_OR_VPT float4 vectors a thread,
    blocks enough for the longest replica's vectors, vectors only where
    every plane shares a 4-B multiple offset."""
    for nrep, ny, nx in SHAPES + [(1, 10000, 10001), (2, 4001, 4001)]:
        n = ny * nx
        for offs in OFFSETS + [(2, 2, 2, 2)]:
            g = hp.xy_tiles(nrep, n, nx, offs, vpt=hp.XY_OR_VPT)
            o = g["off0"]
            most = max((o + r * n + n - 1) // W - (o + r * n) // W + 1
                       for r in range(nrep))
            assert g["nblk"] == -(-most // (T * hp.XY_OR_VPT))
            assert g["vec"] == int(len(set(offs)) == 1 and offs[0] % 4 == 0)
            assert (g["su"] + nx) % W == 0 and (g["sd"] - nx) % W == 0
