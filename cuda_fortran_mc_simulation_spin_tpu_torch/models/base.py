"""Model state.

Port of ``cuda_fortran_mc_simulation_spin_tpu/models/base.py``: a
two-colour lattice state is a NamedTuple of two tensors (core/lattice.py
describes the layout).  The port's models are plain dataclasses whose
methods take and return tensors on an explicit device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class CheckerboardState(NamedTuple):
    """Two-colour lattice state (see core/lattice.py)."""

    a: torch.Tensor  # colour 0, shape ([R,] ny, nx//2)
    b: torch.Tensor  # colour 1, same shape
