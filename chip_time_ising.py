"""CUDA-event times of the periodic Ising kernels at the smoke's launch
shapes: the int8 S-sweep kernel (1000x1000 x 16, S = 64), the int8 phase
kernels (4000x4000 x 8; 500^3 x 2) and the bit-packed phase kernels,
measuring (8192x8192 x 4; 512^3 x 8), each on a random state, with the
resident blocks of the int8 S-sweep grid; with ``--clock``, the clock
kernels whose headers the halo modes share: the bit-sliced q = 6 phase,
measuring, at 2000x2000 x 40 (padded) and 2048x2048 x 16, the int8 clock
phase at 2000x2000 x 16 (q = 5) and its S-sweep kernel at 1000x1000 x 16
(q = 2, S = 64).

    python3 chip_time_ising.py [--reps 50] [--rounds 3] [--clock]

Run it from the root of a checkout; it needs one NVIDIA GPU and builds
the kernels on first use.  It uses only the wrappers' public API, so to
compare two commits copy it into both checkouts and run it from each in
turns on one card (A, B, B, A).  Prints the card's nvidia-smi name and
power limit, the ptxas register report of the build, and last one JSON
line {mode: [ms a launch, one per round], "int8_multisweep_blocks": n}.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
KBT_2D, KBT_3D = 2.269185314213022, 4.51152
LIBS = ["ising2d_multisweep", "ising2d_pallas", "ising3d_pallas",
        "ising2d_multispin", "ising3d_multispin"]
CLOCK_LIBS = ["clock_planes", "clock_pallas", "clock_multisweep"]
KBT_CLOCK, KBT_CLOCK_08 = 0.91, 0.8


def clock_modes(gen, dev, seeds):
    """The clock kernels at the smoke's launch shapes, on random states."""
    from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
        clock_multispin as c6,
        clock_multisweep as c8ms,
        clock_pallas as c8p,
        clock_planes as cp,
    )

    def states(shape, q):
        return torch.randint(0, q, shape, generator=gen, device=dev,
                             dtype=torch.int64).to(torch.int8)

    def packed(ny, nx, nrep):
        a, b = states((nrep, ny, nx // 2), 6), states((nrep, ny, nx // 2), 6)
        return c6.SPEC.pack_color(a), c6.SPEC.pack_color(b)

    pa, pb = packed(2000, 2000, 40)
    qa, qb = packed(2048, 2048, 16)
    sa, sb = states((16, 2000, 1000), 5), states((16, 2000, 1000), 5)
    ra, rb = states((16, 1000, 500), 2), states((16, 1000, 500), 2)
    key = seeds[0, 0]
    return {
        "clock_packed_2000_measuring": lambda: cp.phase_packed(
            c6.SPEC, pb, pa, key, color=1, beta=1 / KBT_CLOCK, ny=2000,
            measuring=True),
        "clock_packed_2048_measuring": lambda: cp.phase_packed(
            c6.SPEC, qb, qa, key, color=1, beta=1 / KBT_CLOCK_08,
            measuring=True),
        "clock_int8_phase": lambda: c8p.metropolis_phase(
            sa, sb, key, color=0, q=5, beta=1 / KBT_CLOCK),
        "clock_int8_multisweep": lambda: c8ms.multisweep_planes(
            ra, rb, seeds, q=2, beta=1 / KBT_2D),
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--clock", action="store_true",
                    help="time the clock kernels instead")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_time_ising: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
        ising2d_multispin as msb,
        ising2d_multisweep as i8ms,
        ising2d_pallas as i2p,
        ising3d_multispin as ms3,
        ising3d_pallas as i3p,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    key = torch.tensor([12345, 678], dtype=torch.int64)
    seeds = msb.sweep_seed_pairs(key, 64)
    phase_key = seeds[0, 0]
    b2, b3 = 1.0 / KBT_2D, 1.0 / KBT_3D

    def spins(shape):
        bits = torch.randint(0, 2, shape, generator=gen, device=dev)
        return (2 * bits - 1).to(torch.int8)

    def words(shape):
        return torch.randint(-2 ** 31, 2 ** 31, shape, generator=gen,
                             device=dev, dtype=torch.int64).to(torch.int32)

    ra, rb = spins((16, 1000, 500)), spins((16, 1000, 500))
    sa, sb = spins((8, 4000, 2000)), spins((8, 4000, 2000))
    libs = LIBS
    if args.clock:
        modes, libs = clock_modes(gen, dev, seeds), CLOCK_LIBS
    else:
        modes = ising_modes(spins, words, msb, i8ms, i2p, ms3, i3p, seeds,
                            phase_key, b2, b3)
    times = {m: [] for m in modes}
    for _ in range(args.rounds):
        for mode, fn in modes.items():
            for _ in range(3):
                fn()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            reps = max(1, args.reps // 10) if "multisweep" in mode \
                else args.reps
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            end.synchronize()
            times[mode].append(start.elapsed_time(end) / reps)
    if not args.clock:
        times["int8_multisweep_blocks"] = i8ms.grid_blocks()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(smi.strip())
    for lib in libs:
        log = ROOT / ".build" / f"lib{lib}.log"
        if log.exists():
            for line in log.read_text().splitlines():
                if "Compiling entry" in line or "registers" in line:
                    print(line.strip())
    print(json.dumps(times))
    return 0


def ising_modes(spins, words, msb, i8ms, i2p, ms3, i3p, seeds, phase_key,
                b2, b3):
    """The Ising kernels at the smoke's launch shapes, on random states."""
    ra, rb = spins((16, 1000, 500)), spins((16, 1000, 500))
    sa, sb = spins((8, 4000, 2000)), spins((8, 4000, 2000))
    va, vb = spins((2, 500, 500, 250)), spins((2, 500, 500, 250))
    wa, wb = words((4, 256, 4096)), words((4, 256, 4096))
    xa, xb = words((8, 512, 16, 256)), words((8, 512, 16, 256))
    return {
        "int8_multisweep": lambda: i8ms.multisweep_planes(ra, rb, seeds,
                                                          beta=b2),
        "int8_phase": lambda: i2p.metropolis_phase(sa, sb, phase_key,
                                                   color=0, beta=b2),
        "int8_3d_phase": lambda: i3p.metropolis_phase(va, vb, phase_key,
                                                      color=0, beta=b3),
        "packed_phase_measuring": lambda: msb.phase_packed(
            wb, wa, phase_key, color=1, beta=b2, measuring=True),
        "packed_3d_phase_measuring": lambda: ms3.phase3d_packed(
            xb, xa, phase_key, color=1, beta=b3, measuring=True),
    }


if __name__ == "__main__":
    sys.exit(main())
