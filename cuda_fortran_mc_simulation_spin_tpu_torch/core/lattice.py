"""Checkerboard (two-colour) lattice storage and neighbour stencils.

Port of the 2-D part of ``cuda_fortran_mc_simulation_spin_tpu/core/
lattice.py``.  A 2-D state is a pair of dense arrays ``(a, b)`` of shape
``(ny, nx // 2)`` (optionally with a leading replica axis):

- ``a[y, i]`` holds the site ``(y, x = 2*i + (y & 1))``   (colour 0)
- ``b[y, i]`` holds the site ``(y, x = 2*i + 1 - (y & 1))`` (colour 1)

Every site's four nearest neighbours live in the other colour array.
With ``p = y & 1``, a colour-0 site ``(y, 2i+p)`` has up/down
``b[y∓1, i]`` and left/right ``b[y, i+p-1]`` / ``b[y, i+p]``; a colour-1
site ``(y, 2i+1-p)`` has left/right ``a[y, i-p]`` / ``a[y, i+1-p]``.
Periodic boundaries wrap by ``torch.roll``.  The bit-packed layout of
ops/ising2d_multispin.py packs 32 rows of each colour into one word.
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
