"""Device mesh construction.

Port of ``cuda_fortran_mc_simulation_spin_tpu/parallel/mesh.py``.  The JAX
mesh is one controller's ``jax.sharding.Mesh``; its counterpart here is a
grid of ``torch.device``s that one process drives, with the JAX axes:

- ``dp``  replicas: independent histories, each shard a slice of them;
- ``y``   the lattice's leading dimension (rows in 2-D, z-planes in 3-D),
  split with halo exchange (parallel/halo.py);
- ``x``   (when x > 1) the colour planes' columns, split likewise.

Each shard is a tensor of its own on its mesh device (parallel/domain.py).
By default a CUDA mesh takes the visible cards, one shard a card, and
refuses a mesh larger than they are; a CPU mesh repeats
``torch.device("cpu")``, the counterpart of the JAX tests' virtual host
devices.  An explicit ``devices`` list may name one card several times:
the shards then share it, and a halo exchange is a copy within it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (dp, y[, x]) grid of devices.  ``devices`` is a (dp, y, x) object
    array (x = 1 without an x axis); ``shape`` maps the axis names to
    their sizes, with "x" only when the mesh has that axis, as JAX's
    ``Mesh.shape`` does."""

    devices: np.ndarray
    axis_names: tuple[str, ...]

    @property
    def shape(self) -> dict[str, int]:
        dp, y, x = self.devices.shape
        out = {"dp": dp, "y": y}
        if "x" in self.axis_names:
            out["x"] = x
        return out

    def device(self, d: int, yi: int, xi: int = 0) -> torch.device:
        return self.devices[d, yi, xi]

    def coords(self):
        """(d, yi, xi) of every shard, row-major."""
        return list(np.ndindex(*self.devices.shape))


def make_mesh(dp: int = 1, y: int = 1, x: int = 1, devices=None,
              device_type: str = "cuda") -> Mesh:
    """(dp, y[, x]) mesh: replicas x lattice rows x lattice columns.

    x = 1 builds the two-axis mesh.  ``devices`` defaults to the visible
    cards, or for ``device_type="cpu"`` to the host repeated.  Raises
    JAX's ValueError when the devices are too few."""
    n = dp * y * x
    if devices is None:
        if device_type == "cpu":
            devices = [torch.device("cpu")] * n
        elif device_type == "cuda":
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
        else:
            raise ValueError(f"no mesh devices of type {device_type!r}")
    devices = [torch.device(d) for d in devices]
    if n > len(devices):
        raise ValueError(
            f"mesh dp={dp} × y={y} × x={x} needs {n} devices, "
            f"have {len(devices)}"
        )
    grid = np.empty(n, dtype=object)
    grid[:] = devices[:n]
    names = ("dp", "y") if x == 1 else ("dp", "y", "x")
    return Mesh(grid.reshape(dp, y, x), names)


def single_device_mesh(device_type: str = "cuda") -> Mesh:
    return make_mesh(1, 1, device_type=device_type)
