"""Checkerboard (two-colour) lattice storage and neighbour stencils.

Port of ``cuda_fortran_mc_simulation_spin_tpu/core/lattice.py`` (its 2-D,
3-D and helical parts).  A 2-D state is a pair of dense arrays ``(a, b)``
of shape ``(ny, nx // 2)`` (optionally with a leading replica axis):

- ``a[y, i]`` holds the site ``(y, x = 2*i + (y & 1))``   (colour 0)
- ``b[y, i]`` holds the site ``(y, x = 2*i + 1 - (y & 1))`` (colour 1)

Every site's four nearest neighbours live in the other colour array.
With ``p = y & 1``, a colour-0 site ``(y, 2i+p)`` has up/down
``b[y∓1, i]`` and left/right ``b[y, i+p-1]`` / ``b[y, i+p]``; a colour-1
site ``(y, 2i+1-p)`` has left/right ``a[y, i-p]`` / ``a[y, i+1-p]``.
Periodic boundaries wrap by ``torch.roll``.  The bit-packed layout of
ops/ising2d_multispin.py packs 32 rows of each colour into one word.

A 3-D state is the same pair with a z axis in front, ``(nz, ny, nx//2)``,
colour = (x+y+z) & 1: the row parity above becomes the plane+row parity
(y+z) & 1.  A helical 2-D state is one flat ``(nall,)`` vector whose site
idx neighbours idx+-1 and idx+-nx modulo nall.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class LatticeSpec:
    """Static description of a periodic 2-D lattice."""

    nx: int
    ny: int

    def __post_init__(self):
        if self.nx % 2 != 0:
            raise ValueError(
                f"periodic checkerboard storage requires even nx, got {self.nx}"
            )
        if self.ny % 2 != 0:
            # odd ny breaks colour consistency across the y wraparound seam
            raise ValueError(
                f"periodic checkerboard storage requires even ny, got {self.ny}"
            )


def _odd_rows(ny: int, device) -> torch.Tensor:
    """(ny, 1) mask of the odd lattice rows."""
    return (torch.arange(ny, device=device) & 1).bool().view(ny, 1)


def split_checkerboard(full: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., ny, nx) full lattice -> (a, b) colour arrays (..., ny, nx//2)."""
    ny, nx = full.shape[-2:]
    pairs = full.reshape(full.shape[:-1] + (nx // 2, 2))
    odd = _odd_rows(ny, full.device)
    even_x, odd_x = pairs[..., 0], pairs[..., 1]
    return torch.where(odd, odd_x, even_x), torch.where(odd, even_x, odd_x)


def merge_checkerboard(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`split_checkerboard`."""
    ny, half = a.shape[-2:]
    odd = _odd_rows(ny, a.device)
    even_x = torch.where(odd, b, a)
    odd_x = torch.where(odd, a, b)
    return torch.stack([even_x, odd_x], dim=-1).reshape(
        a.shape[:-1] + (half * 2,))


def neighbor_sums(other: torch.Tensor, color: int) -> torch.Tensor:
    """Sum of the 4 nearest neighbours of every site of ``color`` given
    the opposite colour array ``other`` (..., ny, nx//2), periodic."""
    ny = other.shape[-2]
    odd = _odd_rows(ny, other.device)
    up = torch.roll(other, 1, dims=-2)
    down = torch.roll(other, -1, dims=-2)
    minus = torch.roll(other, 1, dims=-1)   # value from i-1
    plus = torch.roll(other, -1, dims=-1)   # value from i+1
    if color == 0:
        lr = other + torch.where(odd, plus, minus)
    else:
        lr = other + torch.where(odd, minus, plus)
    return up + down + lr


def neighbor_sums_halo(other: torch.Tensor, color: int, row0: int,
                       halo_up: torch.Tensor, halo_dn: torch.Tensor,
                       halo_lf: torch.Tensor | None = None,
                       halo_rt: torch.Tensor | None = None) -> torch.Tensor:
    """:func:`neighbor_sums` of a shard's colour given the other colour's
    (..., L, w) block, summed (up + down) + (centre + side): the rows past
    the shard's edges are the exchanged ``halo_up``/``halo_dn`` (..., 1,
    w), the columns the exchanged ``halo_lf``/``halo_rt`` (..., L, 1) with
    an x split, else periodic in x; row parity from the global row row0 +
    y (JAX ``lattice.neighbor_sums_halo``)."""
    up = torch.cat([halo_up, other[..., :-1, :]], dim=-2)
    down = torch.cat([other[..., 1:, :], halo_dn], dim=-2)
    if halo_lf is None:
        minus = torch.roll(other, 1, dims=-1)
        plus = torch.roll(other, -1, dims=-1)
    else:
        minus = torch.cat([halo_lf, other[..., :-1]], dim=-1)
        plus = torch.cat([other[..., 1:], halo_rt], dim=-1)
    L = other.shape[-2]
    odd = ((row0 + torch.arange(L, device=other.device)) & 1).bool()
    odd = odd.view(L, 1)
    if color == 0:
        lr = other + torch.where(odd, plus, minus)
    else:
        lr = other + torch.where(odd, minus, plus)
    return up + down + lr


def right_down_neighbors_halo(a: torch.Tensor, b: torch.Tensor, row0: int,
                              dn_a: torch.Tensor, dn_b: torch.Tensor,
                              rt_a: torch.Tensor | None = None,
                              rt_b: torch.Tensor | None = None):
    """:func:`right_down_neighbors` of a shard's (..., L, w) blocks: the
    row below the last from ``dn_a``/``dn_b`` (..., 1, w), the column right
    of the last from ``rt_a``/``rt_b`` (..., L, 1) with an x split, else
    periodic in x; parity from the global row row0 + y."""
    L = a.shape[-2]
    odd = ((row0 + torch.arange(L, device=a.device)) & 1).bool().view(L, 1)

    def right(v, rt):
        if rt is None:
            return torch.roll(v, -1, dims=-1)
        return torch.cat([v[..., 1:], rt], dim=-1)

    right_a = torch.where(odd, right(b, rt_b), b)
    down_a = torch.cat([b[..., 1:, :], dn_b], dim=-2)
    right_b = torch.where(odd, a, right(a, rt_a))
    down_b = torch.cat([a[..., 1:, :], dn_a], dim=-2)
    return right_a, down_a, right_b, down_b


def right_down_neighbors(a: torch.Tensor, b: torch.Tensor):
    """Per-site right and down neighbour values for both colours, for the
    bond energy E = -Σ S·(S_right + S_down).

    Returns (right_of_a, down_of_a, right_of_b, down_of_b)."""
    ny = a.shape[-2]
    odd = _odd_rows(ny, a.device)
    right_a = torch.where(odd, torch.roll(b, -1, dims=-1), b)
    down_a = torch.roll(b, -1, dims=-2)
    right_b = torch.where(odd, a, torch.roll(a, -1, dims=-1))
    down_b = torch.roll(a, -1, dims=-2)
    return right_a, down_a, right_b, down_b


# ---------------------------------------------------------------------------
# 3-D checkerboard (colour = (x+y+z) & 1), storage (..., nz, ny, nx//2)
# ---------------------------------------------------------------------------

def _odd_planes_rows(nz: int, ny: int, device) -> torch.Tensor:
    """(nz, ny, 1) mask of the (z, y) with odd y + z."""
    z = torch.arange(nz, device=device).view(nz, 1)
    y = torch.arange(ny, device=device).view(1, ny)
    return ((z + y) & 1).bool().view(nz, ny, 1)


def split_checkerboard3d(full: torch.Tensor
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., nz, ny, nx) -> (a, b) colour arrays (..., nz, ny, nx//2):
    a[z, y, i] = S[z, y, 2i + ((y+z) & 1)]."""
    nz, ny, nx = full.shape[-3:]
    pairs = full.reshape(full.shape[:-1] + (nx // 2, 2))
    odd = _odd_planes_rows(nz, ny, full.device)
    return (torch.where(odd, pairs[..., 1], pairs[..., 0]),
            torch.where(odd, pairs[..., 0], pairs[..., 1]))


def merge_checkerboard3d(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`split_checkerboard3d`."""
    nz, ny, half = a.shape[-3:]
    odd = _odd_planes_rows(nz, ny, a.device)
    even_x = torch.where(odd, b, a)
    odd_x = torch.where(odd, a, b)
    return torch.stack([even_x, odd_x], dim=-1).reshape(
        a.shape[:-1] + (half * 2,))


def neighbor_sums3d(other: torch.Tensor, color: int) -> torch.Tensor:
    """Sum of the 6 nearest neighbours of every site of ``color`` given
    the opposite colour array ``other`` (..., nz, ny, nx//2), periodic."""
    nz, ny = other.shape[-3:-1]
    odd = _odd_planes_rows(nz, ny, other.device)
    zs = torch.roll(other, 1, dims=-3) + torch.roll(other, -1, dims=-3)
    ys = torch.roll(other, 1, dims=-2) + torch.roll(other, -1, dims=-2)
    minus = torch.roll(other, 1, dims=-1)
    plus = torch.roll(other, -1, dims=-1)
    if color == 0:
        lr = other + torch.where(odd, plus, minus)
    else:
        lr = other + torch.where(odd, minus, plus)
    return zs + ys + lr


def right_down_back_neighbors3d(a: torch.Tensor, b: torch.Tensor):
    """(x+, y+, z+) neighbour values per colour, for the bond energy.

    Returns ((right_a, yp_a, zp_a), (right_b, yp_b, zp_b))."""
    nz, ny = a.shape[-3:-1]
    odd = _odd_planes_rows(nz, ny, a.device)
    right_a = torch.where(odd, torch.roll(b, -1, dims=-1), b)
    right_b = torch.where(odd, a, torch.roll(a, -1, dims=-1))
    return ((right_a, torch.roll(b, -1, dims=-2), torch.roll(b, -1, dims=-3)),
            (right_b, torch.roll(a, -1, dims=-2), torch.roll(a, -1, dims=-3)))


# ---------------------------------------------------------------------------
# helical (skew-periodic) flat lattice
# ---------------------------------------------------------------------------

def helical_neighbor_sums(flat: torch.Tensor, nx: int) -> torch.Tensor:
    """4-neighbour sums under helical boundaries on a flat (..., nall)
    lattice: site idx neighbours idx+-1 and idx+-nx modulo nall."""
    return (torch.roll(flat, -1, dims=-1) + torch.roll(flat, 1, dims=-1)
            + torch.roll(flat, -nx, dims=-1) + torch.roll(flat, nx, dims=-1))


def helical_parity_mask(nall: int, offset: int, device=None) -> torch.Tensor:
    """Boolean mask of the sites of one helical checkerboard phase:
    idx % 2 == offset."""
    return (torch.arange(nall, device=device) & 1) == offset
