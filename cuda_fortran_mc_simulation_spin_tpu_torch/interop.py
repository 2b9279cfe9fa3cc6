"""State carried between the JAX package and the port, as numpy arrays.

The functions below take the JAX package's state as numpy arrays
(``np.asarray`` of its jax arrays, copied here because those are
read-only) and build the port's on the CPU (``.to(device)`` moves them),
and the reverse, so that tests feed both packages one state and a
checkpoint moves between them.  This module imports neither package's
JAX code.

A mesh's shards (:func:`shards_from_numpy`, :func:`shards_to_numpy`)
split and join those global arrays as the JAX mesh shards them.

Both packages store these states the same way, so the converters take
any leading shape: the dual-colour ``CheckerboardState`` int8 planes
(..., ny, nx//2) and 3-D volumes (..., nz, ny, nx//2); the packed int32
planes (..., ny//32, nx//2) of the 2-D multispin engine and volumes
(..., nz, ny//32, nx//2) of the 3-D one; and the Kahan accumulators'
``state_dict``.  The helical colour vectors differ only in shape: JAX
keeps the flat words in a (..., rows, 128) grid (rows a multiple of 8),
the port in (..., W), W = ceil(M/32); flat word g is the same word in
both, and the JAX grid's extra words are zero.  The helical 3-D engine
keeps the same words; its JAX streaming layouts add zero rows
(``pack_flat_stream``) or a ring pad that copies head and tail bits past
bit M (``pack_flat_halo``), so the 3-D converters clear the bits past M.

The clock engines keep a tuple of such planes a colour (3 for q=6, 2 for
q=4 and q=3).  Periodic: the JAX package pads a shape that is not aligned
to (nyp, halfp) planes whose pad rows and lanes it rewrites before each
phase; the port keeps (nyw, half), nyw = ceil(ny/32), with the pad bits
of the top word 0 (ops/clock_planes.py), so the converters slice or
zero-pad and clear those bits.  Helical q=6: three colour vectors a
colour, converted as the helical 3-D words are.

Periodic XY: four float32 planes (ax, ay, bx, by), the state and, for
the disorder protocols, the t=0 snapshot alike.  The JAX lane-padded and
resident engines keep them (..., ny, W), W the next multiple of 128
lanes, with zero pads; the port keeps (..., ny, nx/2), so the converters
cut or zero-pad the lanes.  The accumulators' ``state_dict`` converters
serve every Kahan accumulator, the disorder protocols' ``VarianceKahan``
(A, the correlation) as the covariance ones.

Helical XY (odd nx): the dense engines keep ragged colour planes, four
component planes (ax, ay, bx, by) or two angle planes (a, b) in turns.
JAX keeps them (..., ny, W), W a multiple of 128 lanes, its pad columns
copies of column nc - 1 (``dense_pack`` clips the slot to the row's last
site); the port keeps (..., ny, nc), nc = (nx + 1) // 2, equal to the first
nc columns bit for bit, so the converters cut or pad by that copy.  The
flat (..., nall) states of the masked engine pack into the port's planes
with ``xy_helical_from_flat``.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from cuda_fortran_mc_simulation_spin_tpu_torch.models.base import (
    CheckerboardState,
)


def checkerboard_from_numpy(a, b) -> CheckerboardState:
    """int8 colour planes (numpy) -> the port's CheckerboardState."""
    return CheckerboardState(
        torch.from_numpy(np.array(a, dtype=np.int8)),
        torch.from_numpy(np.array(b, dtype=np.int8)))


def checkerboard_to_numpy(state: CheckerboardState
                          ) -> tuple[np.ndarray, np.ndarray]:
    """The port's CheckerboardState -> int8 colour planes (numpy)."""
    return (state.a.cpu().numpy().astype(np.int8),
            state.b.cpu().numpy().astype(np.int8))


def packed_from_numpy(wa, wb) -> tuple[torch.Tensor, torch.Tensor]:
    """Packed int32 planes (numpy) -> the port's packed planes."""
    return tuple(
        torch.from_numpy(np.array(w, dtype=np.int32))
        for w in (wa, wb))


def packed_to_numpy(wa, wb) -> tuple[np.ndarray, np.ndarray]:
    return (wa.cpu().numpy().astype(np.int32),
            wb.cpu().numpy().astype(np.int32))


def shards_from_numpy(a, b, mesh):
    """A JAX global replica-batched state (numpy) -> the port's
    ``ShardedState`` on ``mesh`` (parallel/domain.py): int8 colour planes
    (R, ny, nx//2) or volumes (R, nz, ny, nx//2), or the packed int32
    words of either engine; replicas over dp, the leading lattice axis
    over y, the last over x, as the JAX mesh's PartitionSpec splits them."""
    from cuda_fortran_mc_simulation_spin_tpu_torch.parallel import domain
    return domain.shard_state(*(torch.from_numpy(np.array(v)) for v in (a, b)),
                              mesh)


def shards_to_numpy(state, mesh) -> tuple[np.ndarray, np.ndarray]:
    """The port's ``ShardedState`` -> the global (a, b) numpy arrays, in
    the dtype of its blocks (int8 planes or int32 words)."""
    from cuda_fortran_mc_simulation_spin_tpu_torch.parallel import domain
    return tuple(t.numpy() for t in domain.gather_state(
        state, mesh, torch.device("cpu")))


def clock_shards_from_numpy(wa, wb, mesh):
    """JAX packed clock planes of a replica batch (two tuples of
    (R, nyw, half) int32 numpy planes, aligned shapes) -> the port's
    ``ShardedState`` of plane tuples on ``mesh``, as the JAX mesh splits
    them (replicas over dp, word rows over y, words over x)."""
    from cuda_fortran_mc_simulation_spin_tpu_torch.parallel import domain
    return domain.shard_state(
        *(tuple(torch.from_numpy(np.array(p, dtype=np.int32)) for p in w)
          for w in (wa, wb)), mesh)


def clock_shards_to_numpy(state, mesh):
    """The port's sharded packed clock state -> (a, b) tuples of global
    int32 numpy planes."""
    from cuda_fortran_mc_simulation_spin_tpu_torch.parallel import domain
    return tuple(tuple(p.numpy() for p in c) for c in domain.gather_state(
        state, mesh, torch.device("cpu")))


def xy_shards_from_numpy(ax, ay, bx, by, mesh):
    """A JAX global XY state (four (R, ny, nx//2) float32 numpy planes,
    unpadded) -> the port's sharded ``XYState`` on ``mesh``."""
    from cuda_fortran_mc_simulation_spin_tpu_torch.parallel import domain
    return domain.shard_xy(xy_from_numpy(ax, ay, bx, by), mesh)


def xy_shards_to_numpy(state, mesh) -> tuple[np.ndarray, ...]:
    """The port's sharded ``XYState`` -> four global float32 planes."""
    from cuda_fortran_mc_simulation_spin_tpu_torch.parallel import domain
    return xy_to_numpy(domain.gather_state(state, mesh, torch.device("cpu")))


def helical_from_numpy(w, m: int) -> torch.Tensor:
    """JAX helical words (..., rows, 128) int32 (numpy) -> the port's
    (..., W) colour vectors for M = ``m`` sites."""
    w = np.asarray(w, dtype=np.int32)
    flat = w.reshape(w.shape[:-2] + (-1,))[..., :-(-m // 32)]
    return torch.from_numpy(np.array(flat))


def helical_to_numpy(w: torch.Tensor, m: int,
                     rows: int | None = None) -> np.ndarray:
    """The port's (..., W) colour vectors -> the JAX grid (..., rows, 128)
    int32, by default rows = the JAX package's grid_rows(m), extra words
    zero."""
    nw = -(-m // 32)
    if rows is None:
        rows = -(-nw // (128 * 8)) * 8    # word rows of 128, a multiple of 8
    flat = w.cpu().numpy().astype(np.int32)
    pad = np.zeros(flat.shape[:-1] + (rows * 128 - nw,), dtype=np.int32)
    return np.concatenate([flat, pad], axis=-1).reshape(
        flat.shape[:-1] + (rows, 128))


def _clear_past(w: np.ndarray, m: int) -> np.ndarray:
    """Words with the bits past site m - 1 of the last word cleared."""
    w = np.array(w, dtype=np.int32)
    if m % 32:
        w[..., -1] &= np.int32((1 << (m % 32)) - 1)
    return w


def helical3d_from_numpy(w, m: int) -> torch.Tensor:
    """JAX helical 3-D words (..., rows, 128) int32 (numpy), in the layout
    of ``pack_flat``, ``pack_flat_stream`` or ``pack_flat_halo`` -> the
    port's (..., W) colour vectors, the bits past M cleared."""
    return torch.from_numpy(_clear_past(helical_from_numpy(w, m).numpy(), m))


def helical3d_to_numpy(w: torch.Tensor, m: int,
                       rows: int | None = None) -> np.ndarray:
    """The port's (..., W) colour vectors -> the JAX ``pack_flat`` grid (or
    ``pack_flat_stream``'s, given its ``rows``), the bits past M cleared as
    the JAX packing leaves them."""
    nw = -(-m // 32)
    cleared = torch.from_numpy(_clear_past(w.cpu().numpy()[..., :nw], m))
    return helical_to_numpy(cleared, m, rows)


def _clock_mask(ny: int, half: int) -> np.ndarray:
    nyw = -(-ny // 32)
    mask = np.full((nyw, half), -1, dtype=np.int32)
    if ny % 32:
        mask[-1] = (1 << (ny % 32)) - 1
    return mask


def clock_from_numpy(planes, ny: int, half: int) -> tuple[torch.Tensor, ...]:
    """JAX clock planes (..., nyp, halfp) int32 (numpy), aligned or padded
    -> the port's (..., nyw, half) planes with the pad bits cleared."""
    nyw = -(-ny // 32)
    mask = _clock_mask(ny, half)
    return tuple(torch.from_numpy(
        np.array(np.asarray(p, dtype=np.int32)[..., :nyw, :half] & mask))
        for p in planes)


def clock_to_numpy(planes, ny: int, half: int) -> tuple[np.ndarray, ...]:
    """The port's (..., nyw, half) clock planes -> the JAX layout: the
    same words for an aligned shape, else the padded (..., nyp, halfp)
    planes with zero pads (the JAX engine rewrites the pads it reads)."""
    from cuda_fortran_mc_simulation_spin_tpu_torch.ops import clock_planes
    pad = clock_planes.padded_spec(ny, half)
    out = []
    for p in planes:
        w = p.cpu().numpy().astype(np.int32) & _clock_mask(ny, half)
        if pad is not None:
            full = np.zeros(w.shape[:-2] + (pad.nyp, pad.halfp), np.int32)
            full[..., :w.shape[-2], :half] = w
            w = full
        out.append(w)
    return tuple(out)


def clock_helical_from_numpy(planes, m: int) -> tuple[torch.Tensor, ...]:
    """JAX helical clock triplet (..., rows, 128) int32 (numpy) -> the
    port's (..., W) colour vectors, the bits past M cleared."""
    return tuple(helical3d_from_numpy(p, m) for p in planes)


def clock_helical_to_numpy(planes, m: int, rows: int | None = None
                           ) -> tuple[np.ndarray, ...]:
    """The port's helical clock triplet -> the JAX (..., rows, 128) grid,
    the bits past M cleared."""
    return tuple(helical3d_to_numpy(p, m, rows) for p in planes)


def xy_from_numpy(ax, ay, bx, by, half: int | None = None):
    """JAX XY planes (..., ny, W) float32 (numpy), lane-padded or not ->
    the port's ``XYState`` of (..., ny, half) planes (half defaults to W,
    unpadded planes)."""
    from cuda_fortran_mc_simulation_spin_tpu_torch.models.xy2d import (
        XYState,
    )
    return XYState(*(
        torch.from_numpy(np.array(np.asarray(p, dtype=np.float32)[
            ..., :half]))
        for p in (ax, ay, bx, by)))


def xy_to_numpy(state, width: int | None = None
                ) -> tuple[np.ndarray, ...]:
    """The port's ``XYState`` -> four float32 planes (numpy), zero-padded
    to ``width`` lanes when given (the JAX padded kernels' W)."""
    out = []
    for p in state:
        a = p.cpu().numpy().astype(np.float32)
        if width is not None and width > a.shape[-1]:
            pad = [(0, 0)] * (a.ndim - 1) + [(0, width - a.shape[-1])]
            a = np.pad(a, pad)
        out.append(a)
    return tuple(out)


def xy_helical_from_numpy(planes, nc: int) -> tuple[torch.Tensor, ...]:
    """JAX dense helical XY planes (..., ny, W) float32 (numpy; the
    component quadruple or the angle pair) -> the port's (..., ny, nc)
    planes: their first nc columns."""
    return tuple(torch.from_numpy(np.array(
        np.asarray(p, dtype=np.float32)[..., :nc])) for p in planes)


def xy_helical_to_numpy(planes, width: int | None = None
                        ) -> tuple[np.ndarray, ...]:
    """The port's dense helical XY planes -> float32 numpy planes, padded
    to ``width`` columns (the JAX planes' W) with copies of column nc - 1,
    as the JAX ``dense_pack`` fills its pad."""
    out = []
    for p in planes:
        a = p.cpu().numpy().astype(np.float32)
        if width is not None and width > a.shape[-1]:
            reps = np.repeat(a[..., -1:], width - a.shape[-1], axis=-1)
            a = np.concatenate([a, reps], axis=-1)
        out.append(a)
    return tuple(out)


def xy_helical_from_flat(sx, sy, ny: int, nx: int, angle: bool = False
                         ) -> tuple[torch.Tensor, ...]:
    """Flat helical XY components (..., nall) (numpy, the JAX model's
    state) -> the port's dense planes: (ax, ay, bx, by), or with
    ``angle`` the (a, b) angle planes in turns."""
    from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
        xy2d_helical_dense,
        xy2d_helical_dense_angle,
    )
    mod = xy2d_helical_dense_angle if angle else xy2d_helical_dense
    flat = tuple(torch.from_numpy(np.array(np.asarray(v, dtype=np.float32)))
                 for v in (sx, sy))
    return tuple(mod.pack_state(flat, ny, nx))


def stats_state_from_numpy(d: Mapping[str, object]) -> dict:
    """A Kahan accumulator's ``state_dict`` (numpy values) as the port's
    accumulators take it: float64 arrays and an int count."""
    return {k: int(v) if k == "n" else np.array(v, dtype=np.float64)
            for k, v in d.items()}


def stats_state_to_numpy(acc) -> dict:
    """The port accumulator's ``state_dict`` with numpy float64 arrays
    (what the JAX package's ``load_state_dict`` takes)."""
    return stats_state_from_numpy(acc.state_dict())
