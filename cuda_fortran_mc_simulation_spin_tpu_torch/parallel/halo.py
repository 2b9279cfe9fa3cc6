"""Halo exchange between the shards of a mesh.

Port of ``cuda_fortran_mc_simulation_spin_tpu/parallel/halo.py``.  JAX
sends each shard's boundary rows to its neighbours with ``lax.ppermute``
inside ``shard_map``; here one process holds every shard, so each
function takes the shards along one mesh axis (a list, in axis order) and
returns, for each shard, its halos as new contiguous tensors on its own
device: a copy of the neighbour's boundary row, plane or column, across
cards a peer copy.  Periodic along the axis; at axis size 1 a shard's
halos are its own (last, first), as in JAX.
"""

from __future__ import annotations

import torch


def _send(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A contiguous copy of ``t`` on ``device``."""
    return torch.empty(t.shape, dtype=t.dtype, device=device).copy_(t)


def _pass(lasts, firsts, shards):
    """Shard i's (halo before, halo after) = (last of i - 1, first of
    i + 1), periodic, each sent to shard i's device."""
    n = len(shards)
    before = [_send(lasts[(i - 1) % n], shards[i].device) for i in range(n)]
    after = [_send(firsts[(i + 1) % n], shards[i].device) for i in range(n)]
    return before, after


def exchange_halo_rows(shards: list[torch.Tensor], row_axis: int = 0
                       ) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
    """(halo_up, halo_dn) of each y-shard: the last row (along
    ``row_axis``) of the previous shard and the first row of the next.
    In 3-D the rows are z-planes."""
    lasts = [s.narrow(row_axis, s.shape[row_axis] - 1, 1) for s in shards]
    firsts = [s.narrow(row_axis, 0, 1) for s in shards]
    return _pass(lasts, firsts, shards)


def exchange_halo_rows_packed(shards: list[torch.Tensor]
                              ) -> tuple[list[torch.Tensor],
                                         list[torch.Tensor]]:
    """(halo_up01, halo_dn01) of each y-shard of BIT-PACKED (R, Lp, half)
    int32 planes (bit k of word row Y is lattice row 32Y + k): the
    previous shard's last lattice row (bit 31 of its last word row) and
    the next shard's first (bit 0 of its first), as 0/1 int32 planes
    (R, 1, half)."""
    tops = [s[:, :1, :] & 1 for s in shards]
    bots = [(s[:, -1:, :] >> 31) & 1 for s in shards]
    return _pass(bots, tops, shards)


def exchange_halo_cols(shards: list[torch.Tensor], col_axis: int = -1
                       ) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
    """(halo_left, halo_right) of each x-shard: the last column of the
    previous shard and the first column of the next.  The four-neighbour
    stencil has no diagonal, so rows and columns exchange independently."""
    return exchange_halo_rows(shards, row_axis=col_axis % shards[0].dim())
