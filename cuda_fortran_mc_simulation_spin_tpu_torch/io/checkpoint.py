"""Ensemble checkpoint / exact resume.

Port of ``cuda_fortran_mc_simulation_spin_tpu/io/checkpoint.py``: the
same ``.npz`` layout and the same config fingerprint, so a checkpoint
written by either package loads in the other.  Per-history random
streams are keyed by the (sample, sweep) counters (core/rng.py), so a
checkpoint holds only the accumulator state (Kahan sums, f64), the number
of samples folded in, and the config fingerprint that refuses resuming a
different run.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Mapping

import numpy as np


# run-scheduling knobs that don't affect the physics of any sample:
# per-sample streams are keyed by (seed, stream, call index), so
# extending tot_sample or time-slicing a run resumes exactly
_SCHEDULING_FIELDS = ("tot_sample", "max_samples_this_run")


def config_fingerprint(cfg) -> str:
    d = dataclasses.asdict(cfg)
    for k in _SCHEDULING_FIELDS:
        d.pop(k, None)
    return hashlib.sha256(
        json.dumps(d, sort_keys=True, default=str).encode()
    ).hexdigest()[:16]


def save(path: str, cfg, samples_done: int,
         accumulators: Mapping[str, object]) -> None:
    arrays: dict[str, np.ndarray] = {}
    for name, acc in accumulators.items():
        for k, v in acc.state_dict().items():
            arrays[f"{name}.{k}"] = np.asarray(v)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(
            f,
            __fingerprint__=np.bytes_(config_fingerprint(cfg).encode()),
            __samples_done__=np.int64(samples_done),
            **arrays,
        )
    os.replace(tmp, path)


def load(path: str, cfg, accumulators: Mapping[str, object]) -> int:
    """Restore accumulators in place; returns samples_done.

    Raises ValueError on config mismatch.
    """
    with np.load(path) as z:
        fp = bytes(z["__fingerprint__"]).decode()
        if fp != config_fingerprint(cfg):
            raise ValueError(
                f"checkpoint {path} was written by a different config "
                f"(fingerprint {fp})"
            )
        samples_done = int(z["__samples_done__"])
        for name, acc in accumulators.items():
            prefix = f"{name}."
            d = {
                k[len(prefix):]: z[k]
                for k in z.files
                if k.startswith(prefix)
            }
            acc.load_state_dict(d)
    return samples_done
