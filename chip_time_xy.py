"""CUDA-event times of the periodic XY relaxation's phase kernels at the
over-relaxation class's launch shape, 4000x4000 x 8 (one colour, 8 x 4000
x 2000 float32 sites): metropolis_kernel and over_relax_kernel, each
without and with the fused float64 sums, on a random state.

    python3 chip_time_xy.py [--reps 200] [--rounds 3]

Run it from the root of a checkout; it needs one NVIDIA GPU and builds
csrc/xy2d_pallas.cu on first use.  It uses only the phase wrappers'
public API, so to compare two commits copy it into both checkouts and run
it from each in turns on one card (A, B, B, A).  Prints the card's
nvidia-smi name and power limit, the ptxas register report of the build,
and last one JSON line {mode: [ms a launch, one per round]}.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
NREP, NY, HALF = 8, 4000, 2000
KBT = 0.89


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_time_xy: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
        xy2d_pallas as xyp,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    planes = []
    for _ in range(2):
        th = torch.rand((NREP, NY, HALF), generator=gen, device=dev) * 6.2832
        planes += [torch.cos(th), torch.sin(th)]
    ax, ay, bx, by = planes
    key = torch.tensor([12345, 678], dtype=torch.int64)
    beta = 1.0 / KBT
    modes = {
        "metropolis": lambda: xyp.metropolis_phase(
            ax, ay, bx, by, key, color=0, beta=beta),
        "metropolis_measuring": lambda: xyp.metropolis_phase(
            bx, by, ax, ay, key, color=1, beta=beta, measuring=True),
        "over_relax": lambda: xyp.over_relax_phase(ax, ay, bx, by, color=0),
        "over_relax_measuring": lambda: xyp.over_relax_phase(
            bx, by, ax, ay, color=1, measuring=True),
    }
    times = {m: [] for m in modes}
    for _ in range(args.rounds):
        for mode, fn in modes.items():
            for _ in range(3):
                fn()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(args.reps):
                fn()
            end.record()
            end.synchronize()
            times[mode].append(start.elapsed_time(end) / args.reps)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(smi.strip())
    log = ROOT / ".build" / "libxy2d_pallas.log"
    if log.exists():
        for line in log.read_text().splitlines():
            if "Compiling entry" in line or "registers" in line:
                print(line.strip())
    print(json.dumps(times))
    return 0


if __name__ == "__main__":
    sys.exit(main())
