"""Run configuration.

Port of ``cuda_fortran_mc_simulation_spin_tpu/config.py``: one runtime
dataclass for every tunable of the reference's apps.  The fields, their
order and their defaults are the JAX package's, so that
io/checkpoint.config_fingerprint gives the same fingerprint in both
packages and a checkpoint written by one loads in the other.  The device
is not part of the configuration: it does not change the physics, and
entry points take it as an argument (:func:`resolve_device`).
"""

from __future__ import annotations

import dataclasses
from typing import Literal, Sequence

import torch

ModelName = Literal["ising2d", "ising3d", "clock", "xy2d"]
InitState = Literal[
    "allup",        # set_allup_spin (ordered start)
    "random",       # set_random_spin (disorder start)
    "finite_magne",  # set_finite_magne_spin(m0) + rotate toward x-axis
    "small_magne",   # set_random_small_spin (drive |m| below threshold)
    "near_magne",    # set_random_near_spin (drive |m| near threshold)
]


@dataclasses.dataclass(frozen=True)
class RunConfig:
    model: ModelName = "ising2d"
    nx: int = 128
    ny: int = 128
    nz: int = 1                     # ising3d only
    q: int = 6                      # clock only (reference: state<=50)
    kbt: float = 2.26918531421      # 2D Ising Tc
    mcs: int = 100                  # sweeps per sample
    tot_sample: int = 10            # independent MC histories
    seed: int = 42                  # reference's constant seed
    stream: int = 0                 # ensemble-split slot (≅ n_skip, §5.4)

    init_state: InitState = "allup"
    init_magne: float = 0.02        # finite_magne / small / near target
    near_magne_tol: float = 0.01    # near_magne relative tolerance

    # over-relaxation schedule (xy2d): after each Metropolis sweep while
    # t <= mcs_over_relax, run n_over_relax reflection sweeps
    n_over_relax: int = 0
    mcs_over_relax: int = 0

    # protocol switches
    rotate_after_first_mcs: bool = False   # from_disorder_fix1mcs variant
    track_correlation: bool = False        # two-point C at (nx/2-1, ny/2-1)
    per_sample_output: bool = False        # *_samples apps: raw time series

    # observable schedule: None = every sweep; else measure only at these
    # 1-based times (the reference's *_specific_times "bin" protocol)
    measure_times: Sequence[int] | None = None

    # replica axis: independent histories advanced together per device
    # step
    replicas: int = 1

    # execution knobs (use_pallas is the JAX package's kernel switch; the
    # port serves only its default, None)
    use_pallas: bool | None = None
    samples_per_call: int = 1        # batch of samples folded per dispatch
    # stop this invocation after folding this many samples (checkpoint
    # and exit cleanly) — time-sliced production runs; the next
    # invocation with the same config resumes where this one stopped.
    # Excluded from the checkpoint fingerprint (scheduling, not physics).
    max_samples_this_run: int | None = None

    # multi-device mesh of the JAX package (replicas over dp, rows over
    # y, colour-array columns over x); the port serves it for the
    # periodic Ising models
    mesh_dp: int = 1
    mesh_y: int = 1
    mesh_x: int = 1

    def __post_init__(self):
        if self.measure_times is not None:
            times = tuple(int(t) for t in self.measure_times)
            bad = [t for t in times if not (1 <= t <= self.mcs)]
            if bad:
                raise ValueError(
                    f"measure_times {bad} outside [1, mcs={self.mcs}]"
                )
            object.__setattr__(self, "measure_times", times)

    @property
    def nsites(self) -> int:
        n = self.nx * self.ny
        if self.model == "ising3d":
            n *= self.nz
        return n


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for ``cpu``.  Raises when CUDA is asked for and there is no card; it
    never carries on on the CPU instead."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is "
            "False; pass device='cpu' (--device cpu) to run the plain "
            "PyTorch versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev
