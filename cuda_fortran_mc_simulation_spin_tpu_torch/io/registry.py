"""Run registry: append-only log of completed runs, one JSON object per
line (port of ``cuda_fortran_mc_simulation_spin_tpu/io/registry.py``).
"""

from __future__ import annotations

import dataclasses
import json
import time


def append(log_path: str, cfg, elapsed_sec: float, output_path: str | None,
           extra: dict | None = None) -> None:
    rec = {
        "timestamp": time.strftime("%Y-%m-%d %H:%M:%S"),
        "elapsed_sec": round(elapsed_sec, 3),
        "output": output_path,
        **dataclasses.asdict(cfg),
    }
    if extra:
        rec.update(extra)
    with open(log_path, "a") as f:
        f.write(json.dumps(rec, default=str) + "\n")
