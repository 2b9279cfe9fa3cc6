"""State carried between the JAX package and the port, as numpy arrays.

Both packages store a 2-D state the same way: the dual-colour
``CheckerboardState`` int8 planes (..., ny, nx//2), or the packed int32
planes (..., ny//32, nx//2) of the multispin engine, and the Kahan
accumulators' ``state_dict``.  These functions take the JAX package's
state as numpy arrays (``np.asarray`` of its jax arrays) and build the
port's on the CPU (``.to(device)`` moves them), and the reverse, so that tests feed both packages one state and
a checkpoint moves between them.  This module imports neither package's
JAX code.
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
        torch.from_numpy(np.ascontiguousarray(a, dtype=np.int8)),
        torch.from_numpy(np.ascontiguousarray(b, dtype=np.int8)))


def checkerboard_to_numpy(state: CheckerboardState
                          ) -> tuple[np.ndarray, np.ndarray]:
    """The port's CheckerboardState -> int8 colour planes (numpy)."""
    return (state.a.cpu().numpy().astype(np.int8),
            state.b.cpu().numpy().astype(np.int8))


def packed_from_numpy(wa, wb) -> tuple[torch.Tensor, torch.Tensor]:
    """Packed int32 planes (numpy) -> the port's packed planes."""
    return tuple(
        torch.from_numpy(np.ascontiguousarray(w, dtype=np.int32))
        for w in (wa, wb))


def packed_to_numpy(wa, wb) -> tuple[np.ndarray, np.ndarray]:
    return (wa.cpu().numpy().astype(np.int32),
            wb.cpu().numpy().astype(np.int32))


def stats_state_from_numpy(d: Mapping[str, object]) -> dict:
    """A Kahan accumulator's ``state_dict`` (numpy values) as the port's
    accumulators take it: float64 arrays and an int count."""
    return {k: int(v) if k == "n" else np.array(v, dtype=np.float64)
            for k, v in d.items()}


def stats_state_to_numpy(acc) -> dict:
    """The port accumulator's ``state_dict`` with numpy float64 arrays
    (what the JAX package's ``load_state_dict`` takes)."""
    return stats_state_from_numpy(acc.state_dict())
