"""The periodic XY angle over-relaxation tile, replayed on the CPU.

``csrc/xy2d_pallas_angle.cu`` ``angle_or_kernel`` runs the Metropolis
kernel's decode-once tiles (``angle_tiles<3, true>``) on its grid:
``ops/xy2d_pallas_angle.metro_blocks`` blocks a replica (the helical
tile's ``tile_grid`` over (ny, half), capped at ``MAX_TILE_BLOCKS``),
block (bx, by) taking column tile bx and tile rows by, by + row blocks,
...; a tile's other-colour angles are fetched into slots
(``test_torch_xy2d_angle_tile._fetch``), decoded once, and each site's
field added from its up, down, centre and side slots in the plain order
(up + dn) + (centre + side).  Here that launch is walked in PyTorch and
numpy, thread by thread: every site is reflected exactly once, the
partials a replica stay within the cap, the reflected angles from the
slots equal ``or_phase_plain`` bitwise (and lie within 1e-6 turns·|h| of
JAX's ``_angle_or_phase`` in interpret mode, whose decode and field
chains XLA contracts), and the float64 sums in the kernel's order (each
thread's sites in its walk, the warp's shuffle tree, the block's warps,
then ``reduce_kernel``'s strided sums and tree) are within 1e-12 of
their scale of the plain sums.

Shapes: those of ``test_torch_xy2d_angle_tile.py``: ragged half (65,
31, 5), half < 32, ny = 2, several tile rows a block, and grids past the
cap (walked, not computed)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_xy2d_angle_tile import SIZES, _fetch, _walk

from cuda_fortran_mc_simulation_spin_tpu.ops import (
    xy2d_pallas_angle as jxa,
)
from cuda_fortran_mc_simulation_spin_tpu_torch.ops import trig
from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
    xy2d_helical_dense_angle as xha,
)
from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
    xy2d_pallas_angle as xya,
)

TX = TY = xha.TILE
THREADS, ROWS = 256, 256 // xha.TILE
SW = TX + 2
OR_FIELD_ATOL = 1e-6
SUM_RTOL = 1e-12
# (nrep, ny, half) of the computed replays: ragged half, half < 32,
# ny = 2, several tile rows a block (a cap of two blocks, forced below)
REPLAYS = [(2, 2, 1), (2, 2, 5), (2, 4, 33), (1, 34, 31), (2, 70, 65),
           (1, 96, 40)]


def _turns(seed, shape) -> torch.Tensor:
    g = np.random.default_rng(seed)
    return torch.from_numpy(g.uniform(-0.5, 0.5, size=shape).astype(
        np.float32))


def _sites(ny, half, color):
    """The launch's sites in walk order: per block (by·gx + bx), per step
    of its tile-row loop, per thread t and its rows j: (block, thread,
    step, j, y, i, up, dn, ce, sd) with the four slots' (row, column) of
    the other colour, from fetch_tile's loads."""
    gx = xha.tile_grid(ny, half)[0]
    out = []
    for (bx, by), y0s in _walk(ny, half).items():
        x0 = bx * TX
        for step, y0 in enumerate(y0s):
            slots = _fetch(ny, half, x0, y0)
            for t in range(THREADS):
                tx, ty0 = t % TX, t // TX
                for j in range(TY // ROWS):
                    ty = ty0 + j * ROWS
                    y, i = y0 + ty, x0 + tx
                    if y >= ny or i >= half:
                        continue
                    c = (ty + 1) * SW + (tx + 1)
                    plus = (color == 0) == (y % 2 == 1)
                    sd = c + 1 if plus else c - 1
                    out.append((by * gx + bx, t, step, j, y, i,
                                slots[c - SW], slots[c + SW], slots[c],
                                slots[sd]))
    return out


def _replay(s, o, color):
    """angle_or_kernel on (R, ny, half) float32 planes: (new s, the times
    each site was written, (R, blocks, 3) partials, (R, 3) totals)."""
    nrep, ny, half = s.shape
    sites = _sites(ny, half, color)
    gx, gy = xha.tile_grid(ny, half)
    nblk = gx * gy
    ox, oy = trig.cos_sin_2pi(o)
    ys = torch.tensor([v[4] for v in sites])
    xs = torch.tensor([v[5] for v in sites])

    def gather(plane, k):
        yy = torch.tensor([v[k][0] for v in sites])
        xx = torch.tensor([v[k][1] for v in sites])
        return plane[:, yy, xx]

    up, dn, ce, sd = ((gather(ox, k), gather(oy, k)) for k in (6, 7, 8, 9))
    hx = (up[0] + dn[0]) + (ce[0] + sd[0])
    hy = (up[1] + dn[1]) + (ce[1] + sd[1])
    new = xha.or_math(s[:, ys, xs], hx, hy)
    out = s.clone()
    out[:, ys, xs] = new
    count = np.zeros((ny, half), np.int64)
    np.add.at(count, (ys.numpy(), xs.numpy()), 1)
    # float64 sums in the kernel's order
    fx, fy = trig.cos_sin_2pi(new)
    terms = [fx.double() + ce[0].double(), fy.double() + ce[1].double(),
             (fx * hx + fy * hy).double()]
    blk = np.array([v[0] for v in sites])
    thr = np.array([v[1] for v in sites])
    step = np.array([v[2] for v in sites])
    jj = np.array([v[3] for v in sites])
    nsteps = int(step.max()) + 1
    order = (step * (TY // ROWS) + jj)
    partials = np.zeros((nrep, nblk, 3))
    for k, term in enumerate(terms):
        acc = np.zeros((nrep, nblk, THREADS))
        seq = np.zeros((nrep, nblk, THREADS, nsteps * (TY // ROWS)))
        seq[:, blk, thr, order] = term.numpy()
        for n in range(seq.shape[-1]):
            acc = acc + seq[..., n]
        partials[..., k] = _block_sum(acc)
    return out, count, partials, _reduce(partials)


def _block_sum(acc):
    """xy::block_sums of per-thread sums (..., THREADS): each warp's
    shuffle-down tree (a lane past 31 reads its own value), then thread
    k adds the warps' lane-0 sums in order."""
    v = acc.reshape(acc.shape[:-1] + (THREADS // 32, 32))
    for off in (16, 8, 4, 2, 1):
        shifted = np.concatenate([v[..., off:], v[..., 32 - off:]], axis=-1)
        v = v + shifted
    total = np.zeros(acc.shape[:-1])
    for w in range(THREADS // 32):
        total = total + v[..., w, 0]
    return total


def _reduce(partials):
    """xy::reduce_kernel<3>: thread t adds blocks t, t + 256, ...; then the
    tree over 256 threads; e negated."""
    nrep, nblk, n = partials.shape
    t = np.zeros((nrep, THREADS, n))
    for b in range(nblk):
        t[:, b % THREADS] = t[:, b % THREADS] + partials[:, b]
    half = THREADS // 2
    while half:
        t[:, :half] = t[:, :half] + t[:, half:2 * half]
        half //= 2
    obs = t[:, 0].copy()
    obs[:, 2] = -obs[:, 2]
    return obs


@pytest.mark.parametrize("ny,half", SIZES)
def test_or_grid_is_the_metro_grid_and_capped(ny, half):
    """The OR launch's partials a replica are metro_blocks, at most the cap
    (or one row block a column tile past it), and its walk covers every
    site once."""
    gx, gy = xha.tile_grid(ny, half)
    nblk = xya.metro_blocks(ny, half)
    assert nblk == gx * gy
    assert nblk <= xha.MAX_TILE_BLOCKS or gy == 1
    if ny * half <= 1 << 22:
        count = np.zeros((ny, half), dtype=np.int64)
        for (bx, _), y0s in _walk(ny, half).items():
            for y0 in y0s:
                count[y0:y0 + TY, bx * TX:bx * TX + TX] += 1
        assert (count == 1).all()


@pytest.mark.parametrize("shape", REPLAYS)
@pytest.mark.parametrize("color", [0, 1])
def test_replayed_or_tiles_equal_the_plain_phase(shape, color, monkeypatch):
    """Every site is reflected once from its tile's slots, the new angles
    equal or_phase_plain bitwise, and the replayed partials' totals are
    within 1e-12 of their scale of the plain sums.  (1, 96, 40) runs
    with the cap at two blocks: each block walks three tile rows."""
    if shape == (1, 96, 40):
        monkeypatch.setattr(xha, "MAX_TILE_BLOCKS", 2)
        assert xha.tile_grid(96, 40) == (2, 1)
    nrep, ny, half = shape
    s = _turns(ny * half + color, shape)
    o = _turns(ny * half + 7, shape)
    got, count, partials, obs = _replay(s, o, color)
    assert (count == 1).all()
    assert partials.shape[1] == xya.metro_blocks(ny, half)
    want, wobs = xya.or_phase_plain(s.clone(), o, color=color,
                                    measuring=True)
    assert torch.equal(got, want)
    scale = np.array([2.0, 2.0, 4.0]) * ny * half
    np.testing.assert_allclose(obs, wobs.numpy(), rtol=0,
                               atol=SUM_RTOL * scale.max())


@pytest.mark.parametrize("half", [100, 33])
@pytest.mark.parametrize("color", [0, 1])
def test_replayed_or_tiles_against_the_jax_kernel(half, color):
    """The replayed angles against JAX's _angle_or_phase in interpret mode
    on its lane-padded planes (ny 16): |Δθ|·|h| <= 1e-6 turns, the bound
    of tests/test_torch_xy2d_angle_periodic.py (XLA contracts the JAX
    kernel's decode and field chains)."""
    nrep, ny = 2, 16
    s = _turns(3 * half + color, (nrep, ny, half))
    o = _turns(5 * half + color, (nrep, ny, half))
    got = _replay(s, o, color)[0]
    lanes = -(-half // 128) * 128

    def pad(x):
        return jnp.asarray(np.pad(x.numpy(), [(0, 0), (0, 0),
                                              (0, lanes - half)]))

    res = jxa._angle_or_phase(pad(s), pad(o), color=color, nrep=nrep, ny=ny,
                              half=lanes,
                              valid_half=half if lanes != half else 0,
                              interpret=True)
    js = np.asarray(res)[..., :half]
    ox, oy = trig.cos_sin_2pi(o)
    h = torch.hypot(xya.nbr_sum(ox, color), xya.nbr_sum(oy, color)).numpy()
    d = got.numpy() - js
    d = np.abs(d - np.round(d))
    assert np.max(d * h) <= OR_FIELD_ATOL


class _FakeLib:
    """The angle library's OR entry point, recording its arguments
    instead of launching."""

    def __init__(self):
        self.calls = []

    def xya_or(self, *args):
        self.calls.append(args)
        return 0


@pytest.mark.parametrize("measuring", [False, True])
@pytest.mark.parametrize("ny,half", [(4000, 2000), (10000, 5000), (34, 31),
                                     (544, 32768)])
def test_or_wrapper_passes_the_tile_grid(ny, half, measuring, monkeypatch):
    """or_phase hands the kernel the Metropolis tile's row blocks and, when
    it measures, partials of (R, metro_blocks, 3): at most MAX_TILE_BLOCKS
    a replica (the one-thread-a-site grid left ny·half/256).  The launch
    is recorded, not run (no card here)."""
    from contextlib import nullcontext
    lib = _FakeLib()
    monkeypatch.setattr(xya, "_on_cpu", lambda t: False)
    monkeypatch.setattr(xya, "_check_planes", lambda *p: None)
    monkeypatch.setattr(xya, "_stream", lambda t: None)
    monkeypatch.setattr(xya, "_lib", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", lambda d: nullcontext())
    sizes = []
    real = xha.tile_scratch
    monkeypatch.setattr(xha, "tile_scratch", lambda s, m, *n: sizes.append(
        real(s, m, *n)) or sizes[-1])
    s = torch.zeros((2, 1, 1)).expand(2, ny, half)
    xya.or_phase(s, s, color=1, measuring=measuring)
    (args,) = lib.calls
    gy = xha.tile_grid(ny, half)[1]
    assert args[4:9] == (2, ny, half, gy, 1)
    (partials, obs), = sizes
    assert (partials is None) == (obs is None) == (not measuring)
    if measuring:
        nblk = xya.metro_blocks(ny, half)
        assert partials.shape == (2, nblk, 3) and obs.shape == (2, 3)
        assert args[2:4] == (partials.data_ptr(), obs.data_ptr())
        assert nblk <= min(xha.MAX_TILE_BLOCKS, -(-ny * half // 256))
