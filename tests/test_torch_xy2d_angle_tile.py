"""The periodic XY angle Metropolis tile's host sizing and index walk.

``csrc/xy2d_pallas_angle.cu`` ``angle_metro_kernel`` runs a grid of
``ops/xy2d_pallas_angle.metro_blocks`` blocks a replica (the helical
tile's ``tile_grid`` over (ny, half)): block (bx, by) takes column tile bx
and tile rows by, by + row blocks, ...; each tile loads the other
colour's rows y0 - 1 .. y0 + 32 and columns x0 - 1 .. x0 + 32, each
wrapped once.  These tests walk that grid and that load in Python: every
site is updated once, the grid stays capped, and the tile slots a site
reads hold its four neighbours and its centre of the periodic layout
(``ops/xy2d_pallas.nbr_sum``)."""

import numpy as np
import pytest
import torch

from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
    xy2d_helical_dense_angle as xha,
)
from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
    xy2d_pallas as xyp,
)
from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
    xy2d_pallas_angle as xya,
)

TX = TY = xha.TILE
THREADS = 256

# (ny, half): the classes' 10000^2 (half 5000, ragged) and 2000^2, 1000^2,
# ragged rows, half < 32, ny = 2, and grids past the cap
SIZES = [(10000, 5000), (2000, 1000), (1000, 500), (1500, 750), (2, 1),
         (2, 5), (33, 31), (64, 32), (70, 65), (544, 32768),
         (4000, 524288)]


def _walk(ny, half):
    """(tiles a block walks: (bx, by) -> [y0, ...]) of the kernel's loop
    ``for y0 = by·TY; y0 < ny; y0 += gridDim.y·TY``."""
    gx, gy = xha.tile_grid(ny, half)
    return {(bx, by): list(range(by * TY, ny, gy * TY))
            for bx in range(gx) for by in range(gy)}


@pytest.mark.parametrize("ny,half", SIZES)
def test_metro_grid_is_capped_and_counted(ny, half):
    gx, gy = xha.tile_grid(ny, half)
    assert gx == -(-half // TX)
    assert 1 <= gy <= min(-(-ny // TY), 65535)
    assert gx * gy <= xha.MAX_TILE_BLOCKS or gy == 1
    # capped only where the uncapped grid would pass the cap
    assert (gy < -(-ny // TY)) == (gx * -(-ny // TY) > xha.MAX_TILE_BLOCKS)
    assert xya.metro_blocks(ny, half) == gx * gy


@pytest.mark.parametrize("ny,half", SIZES[:9])
def test_metro_walk_updates_every_site_once(ny, half):
    count = np.zeros((ny, half), dtype=np.int64)
    for (bx, _), y0s in _walk(ny, half).items():
        for y0 in y0s:
            count[y0:y0 + TY, bx * TX:bx * TX + TX] += 1
    assert (count == 1).all()


def _fetch(ny, half, x0, y0):
    """fetch_tile's loads: tile slot k -> the (row, column) it holds, or
    None where it loads 0 (past the rows of a short tile, or a column
    past half after one wrap)."""
    sw = TX + 2
    nload = (min(TY, ny - y0) + 2) * sw
    loads = (sw * (TY + 2) + THREADS - 1) // THREADS * THREADS
    slots = {}
    for k in range(loads):
        ry, cx = divmod(k, sw)
        xx = x0 - 1 + cx
        xx = xx + half if xx < 0 else (xx - half if xx >= half else xx)
        yy = y0 - 1 + ry
        yy = yy + ny if yy < 0 else (yy - ny if yy >= ny else yy)
        slots[k] = (yy, xx) if k < nload and xx < half else None
    return slots


@pytest.mark.parametrize("ny,half", [(2, 1), (2, 5), (4, 33), (33, 31),
                                     (70, 65), (3, 2)])
@pytest.mark.parametrize("color", [0, 1])
def test_tile_slots_hold_each_sites_neighbours(ny, half, color):
    """Each valid site's up, dn, centre and side slot of its tile hold the
    other colour's (y -+ 1, i), (y, i) and the side column of the
    periodic layout: the field the kernel adds is nbr_sum's."""
    sw = TX + 2
    o = torch.arange(ny * half, dtype=torch.float64).reshape(1, ny, half)
    up = torch.roll(o, 1, dims=-2)[0]
    dn = torch.roll(o, -1, dims=-2)[0]
    side = (xyp.nbr_sum(o, color) - (up + dn) - o)[0]
    for (bx, _), y0s in _walk(ny, half).items():
        for y0 in y0s:
            slots = _fetch(ny, half, bx * TX, y0)
            for y in range(y0, min(y0 + TY, ny)):
                for i in range(bx * TX, min(bx * TX + TX, half)):
                    c = (y - y0 + 1) * sw + (i - bx * TX + 1)
                    plus = (color == 0) == (y % 2 == 1)
                    got = [slots[k] for k in (c - sw, c + sw, c,
                                              c + 1 if plus else c - 1)]
                    assert None not in got
                    val = [yy * half + xx for yy, xx in got]
                    assert val[:3] == [up[y, i], dn[y, i], o[0, y, i]]
                    assert val[3] == side[y, i]
