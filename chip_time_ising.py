"""CUDA-event times of the periodic Ising kernels at the smoke's launch
shapes: the int8 S-sweep kernel (1000x1000 x 16, S = 64), the int8 phase
kernels (4000x4000 x 8; 500^3 x 2) and the bit-packed phase kernels,
measuring (8192x8192 x 4; 512^3 x 8), each on a random state, with the
resident blocks of the int8 S-sweep grid; beside them the periodic 3-D
bit-packed kernels at the 3-D classes' other launches: the plain phase a
at 512^3 x 8, the halo mode (measuring and plain) at the mesh 3-D
class's shard (4, 128, 16, 256) of 512^3 x 8 on (2,4), timed as a CUDA
graph of 50 launches (median of 9 windows, chip_smoke.graph_time_ms),
and the 3-D multisweep at 256^3 x 4, S = 64, with the SASS of
phase_kernel and multisweep_kernel; beside the int8 3-D phase (500^3 x
2) its halo mode at the mesh int8 3-D class's shard (1, 250, 500, 250) of
500^3 x 2 on (2,2), measuring and plain, graph-timed, with the SASS of
the int8 3-D tile_kernel; with ``--clock``, the clock
kernels whose headers the halo modes share: the bit-sliced q = 6 phase,
measuring, at 2000x2000 x 40 (padded) and 2048x2048 x 16, the int8 clock
phase at 2000x2000 x 16 (q = 5) and its S-sweep kernel at 1000x1000 x 16
(q = 2, S = 64 and 40; q = 6, S = 64), with the SASS of its
multisweep_kernel; beside them the bit-sliced
phase plain (colour a) at
both shapes, measuring at 2048x2048 x 16 for q = 4 and 3, and its halo
mode (measuring and plain) at the mesh packed clock class's shard (8, 32,
512) of 2048x2048 x 16 on (2,2,2), graph-timed, with the SASS of
phase_kernel; with ``--helical3d``, the helical 3-D phase kernel at
the even streamed class's launch, 1001x1000x1000 x 2 (colour a, z-parity
sub-phases 0 and 1), and at the odd streamed class's, 501x501x500 x 2
(colour b, plain and measuring), on random vectors, and the helical
3-D resident multisweep (multisweep_kernel) at its class's launch,
151x151x150 x 128 with S = 64, and at the samples protocol's 151x151x150
x 1 with S = 8, with the SASS of both kernels; with ``--masked``,
the masked helical Ising multisweep (csrc/helical_pallas.cu
ising_multisweep_kernel) at its four main-path launches, 1001x1000 x 128,
4001x4000 x 4, 1001x1001 x 16 and the samples class's 1001x1000 x 1, S =
16 sweeps each, with its SASS, and beside it the masked clock multisweep
of the same source (clock_multisweep_kernel) at its class's 501x500 x
100, q = 6, S = 16; with ``--samples``, the four int8 kernels
of the one-replica samples classes at 1000x1000 x 1 (the Ising phase and
measure kernels, the clock's at q = 6), each event-timed as the smoke
times them and as a CUDA graph of 50 launches (the kernel alone, without
the wrapper's host work); with ``--registers``,
no timing: every csrc/*.cu built anew and the ptxas registers of each of
its kernels, one JSON line {library: {kernel: registers}} (the kernel's
mangled name without the anonymous namespace's per-file hash), to hold
the includers of a shared header unchanged across two checkouts.

    python3 chip_time_ising.py [--reps 50] [--rounds 3]
                               [--clock | --helical3d | --masked |
                                --samples | --registers]

Run it from the root of a checkout; it needs one NVIDIA GPU and builds
the kernels on first use.  It uses only the wrappers' public API, so to
compare two commits copy it into both checkouts and run it from each in
turns on one card (A, B, B, A).  Prints the card's nvidia-smi name and
power limit, the ptxas register report of the build, with ``--helical3d``
and ``--clock`` the SASS of phase_kernel (both also of
multisweep_kernel, the default mode also of the int8 3-D tile_kernel;
``--masked``: of
ising_multisweep_kernel; instructions, the instructions of each loop,
the commonest opcodes; where cuobjdump exists), and last one JSON line
{mode: [ms a launch, one per round]} (``"int8_multisweep_blocks": n``
and ``"packed_3d_multisweep_blocks": n`` beside the Ising modes).
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import re
import shutil
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
# the helical 3-D classes' temperatures: 1001x1000x1000 and 501x501x500
KBT_H3, KBT_H3_501 = 4.511454583186711, 4.51152174982078
# the masked Ising multisweep's main-path launches (R, ny, nx): its three
# classes' and the samples class's (chip_smoke.HP_ISING_SHAPES)
MASKED_SHAPES = ((128, 1000, 1001), (4, 4000, 4001), (16, 1001, 1001),
                 (1, 1000, 1001))
MASKED_SWEEPS = 16
_SASS_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
                        r"([A-Z][A-Z0-9_.]*)([^;]*);")


def sass_report(lib: str, names: tuple[str, ...]) -> None:
    """For each function of ``.build/lib<lib>.so`` whose mangled name holds
    one of ``names``: its SASS instructions, the instructions of each loop
    (a backward branch: the span from its target to it), its integer
    divisions by a run-time value (the I2F.U32.RP that opens each such
    sequence) and the ten commonest opcodes; nothing where cuobjdump is
    missing."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        print("sass: cuobjdump not found")
        return
    dump = subprocess.run([tool, "-sass", str(ROOT / ".build" /
                                              f"lib{lib}.so")],
                          capture_output=True, text=True).stdout
    for part in dump.split("Function : ")[1:]:
        name = part.split(None, 1)[0]
        if not any(n in name for n in names):
            continue
        ops, loops = collections.Counter(), []
        for addr, op, rest in _SASS_LINE.findall(part):
            ops[op] += 1
            target = re.search(r"\b0x([0-9a-f]+)\b", rest)
            if op.startswith("BRA") and target and \
                    int(target.group(1), 16) < int(addr, 16):
                loops.append((int(addr, 16) - int(target.group(1), 16))
                             // 16 + 1)
        div = sum(n for op, n in ops.items()
                  if op.startswith("I2F") and ".RP" in op)
        print(f"sass {lib} {name}: {sum(ops.values())} instructions; "
              f"loops {loops}; integer divisions (I2F .RP) {div}; "
              + ", ".join(f"{op} {n}" for op, n in ops.most_common(10)))


_ANON = re.compile(r"\d+_GLOBAL__N__[0-9a-f]{8}_\d+_\w+?_cu_\w{8}")


def register_report() -> dict[str, dict[str, int]]:
    """{library: {kernel: registers}} of every csrc/*.cu, built anew (the
    ptxas report in .build/lib<name>.log)."""
    from cuda_fortran_mc_simulation_spin_tpu_torch.ops import _build
    names = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    _build.build(names, force=True)
    out = {}
    for name in names:
        regs, kernel = {}, None
        log = _build.library_path(name).with_suffix(".log").read_text()
        for line in log.splitlines():
            entry = re.search(r"Compiling entry function '([^']+)'", line)
            if entry:
                kernel = _ANON.sub("", entry.group(1))
            used = re.search(r"Used (\d+) registers", line)
            if used and kernel is not None:
                regs[kernel] = int(used.group(1))
                kernel = None
        out[name] = regs
    return out


def graph_ms(fn, launches: int = 50, windows: int = 9) -> float:
    """Median ms a call of ``fn`` over ``windows`` replays of one CUDA
    graph of ``launches`` captured calls, as the smoke times its halo
    modes (chip_smoke.graph_time_ms)."""
    from chip_smoke import graph_time_ms
    return graph_time_ms(fn, launches, windows)[0]


def helical3d_modes(words):
    """The helical 3-D phase kernel at both streamed classes' launches,
    on random vectors."""
    from cuda_fortran_mc_simulation_spin_tpu_torch.core import rng
    from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
        helical3d_multispin as h3,
        helical_multispin as hms,
        multispin_rng,
    )
    key = rng.seeds_from_key(rng.base_key(17), 0)
    even = dict(nx=1001, nxy=1001 * 1000, m=1001 * 1000 * 1000 // 2,
                beta=1 / KBT_H3)
    odd = dict(nx=501, nxy=501 * 501, m=501 * 501 * 500 // 2,
               beta=1 / KBT_H3_501)
    res = dict(nx=151, nxy=151 * 151, m=151 * 151 * 150 // 2,
               beta=1 / KBT_H3)
    ea, eb = (words((2, hms.words(even["m"]))) for _ in range(2))
    oa, ob = (words((2, hms.words(odd["m"]))) for _ in range(2))
    ra, rb = (words((128, hms.words(res["m"]))) for _ in range(2))
    sa, sb = (words((1, hms.words(res["m"]))) for _ in range(2))
    seeds = multispin_rng.sweep_phase_keys(
        torch.tensor([12345, 678], dtype=torch.int64), 64)
    return {
        "helical3d_1001_zsub0": lambda: h3.phase_packed(
            ea, eb, key, color=0, zsub=0, **even),
        "helical3d_1001_zsub1": lambda: h3.phase_packed(
            ea, eb, key, color=0, zsub=1, **even),
        "helical3d_501": lambda: h3.phase_packed(ob, oa, key, color=1,
                                                 **odd),
        "helical3d_501_measuring": lambda: h3.phase_packed(
            ob, oa, key, color=1, measuring=True, **odd),
        "helical3d multisweep 151x151x150 x 128 S=64": lambda: (
            h3.multisweep_planes(ra, rb, seeds, **res)),
        "helical3d multisweep 151x151x150 x 1 S=8": lambda: (
            h3.multisweep_planes(sa, sb, seeds[:8], **res)),
    }


def masked_modes(spins, gen, dev):
    """The masked helical Ising multisweep at MASKED_SHAPES and the masked
    clock multisweep at 501x500 x 100, q = 6, S = MASKED_SWEEPS, on random
    states (updated in place, launch after launch)."""
    from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
        helical_pallas as hp,
        multispin_rng,
    )
    seeds = multispin_rng.sweep_phase_keys(
        torch.tensor([12345, 678], dtype=torch.int64), MASKED_SWEEPS)
    modes = {}
    for nrep, ny, nx in MASKED_SHAPES:
        x = spins((nrep, ny * nx))
        modes[f"masked multisweep {ny}x{nx} x {nrep} S={MASKED_SWEEPS}"] = (
            lambda x=x, nx=nx: hp.ising_multisweep(x, seeds, beta=1 / KBT_2D,
                                                   nx=nx))
    c = torch.randint(0, 6, (100, 500 * 501), generator=gen, device=dev,
                      dtype=torch.int64).to(torch.int8)
    modes[f"masked clock multisweep 500x501 x 100 q=6 S={MASKED_SWEEPS}"] = (
        lambda: hp.clock_multisweep(c, seeds, beta=1 / KBT_CLOCK_08, nx=501,
                                    q=6))
    return modes


def samples_modes(spins, gen, dev, key):
    """Rows 24, 27, 20 and 23 (the int8 Ising phase and measure kernels,
    the int8 clock's at q = 6) at the samples classes' one-replica launch,
    1000x1000 x 1 (colour planes (1, 1000, 500)), each event-timed and as
    a CUDA graph ("graph " modes)."""
    from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
        clock_measure_pallas as c8m,
        clock_pallas as c8p,
        ising2d_measure_pallas as i8m,
        ising2d_pallas as i2p,
    )
    a, b = spins((1, 1000, 500)), spins((1, 1000, 500))
    ca, cb = (torch.randint(0, 6, (1, 1000, 500), generator=gen, device=dev,
                            dtype=torch.int64).to(torch.int8)
              for _ in range(2))
    calls = {
        "row24 int8_phase 1000^2 x 1": lambda: i2p.metropolis_phase(
            a, b, key, color=0, beta=1 / KBT_2D),
        "row27 int8_measure 1000^2 x 1": lambda: i8m.measure_sums(a, b),
        "row20 clock8_phase 1000^2 x 1 q=6": lambda: c8p.metropolis_phase(
            ca, cb, key, color=0, q=6, beta=1 / KBT_CLOCK),
        "row23 clock8_measure 1000^2 x 1 q=6": lambda: c8m.measure_sums(
            ca, cb, 6),
    }
    modes = dict(calls)
    modes.update({f"graph {k}": fn for k, fn in calls.items()})
    return modes


def clock_modes(gen, dev, seeds):
    """The clock kernels at the smoke's launch shapes, on random states."""
    from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
        clock3_multispin as c3,
        clock4_multispin as c4,
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
    ca, cb = states((16, 1000, 500), 6), states((16, 1000, 500), 6)
    key = seeds[0, 0]
    # the mesh packed clock class's shard (8, 32, 512) of 2048^2 x 16 on
    # (2,2,2): its halo rows and word columns from its own other colour
    ha, hb = packed(32 * 32, 1024, 8)
    halo = dict(hup=tuple(((p[:, -1:] >> 31) & 1).contiguous() for p in hb),
                hdn=tuple((p[:, :1] & 1).contiguous() for p in hb),
                halo_lf=tuple(p[:, :, -1:].contiguous() for p in hb),
                halo_rt=tuple(p[:, :, :1].contiguous() for p in hb))
    modes = {
        "clock_packed_2000_measuring": lambda: cp.phase_packed(
            c6.SPEC, pb, pa, key, color=1, beta=1 / KBT_CLOCK, ny=2000,
            measuring=True),
        "clock_packed_2000": lambda: cp.phase_packed(
            c6.SPEC, pa, pb, key, color=0, beta=1 / KBT_CLOCK, ny=2000),
        "clock_packed_2048_measuring": lambda: cp.phase_packed(
            c6.SPEC, qb, qa, key, color=1, beta=1 / KBT_CLOCK_08,
            measuring=True),
        "clock_packed_2048": lambda: cp.phase_packed(
            c6.SPEC, qa, qb, key, color=0, beta=1 / KBT_CLOCK_08),
        "graph clock_shard_measuring": lambda: cp.sharded_phase_packed(
            c6.SPEC, ha, hb, halo["hup"], halo["hdn"], key, (0, 32, 512),
            color=1, beta=1 / KBT_CLOCK_08, measuring=True,
            halo_lf=halo["halo_lf"], halo_rt=halo["halo_rt"]),
        "graph clock_shard": lambda: cp.sharded_phase_packed(
            c6.SPEC, ha, hb, halo["hup"], halo["hdn"], key, (0, 32, 512),
            color=0, beta=1 / KBT_CLOCK_08, halo_lf=halo["halo_lf"],
            halo_rt=halo["halo_rt"]),
    }
    # q = 4 and q = 3 on the aligned shape, measuring
    for spec in (c4.SPEC, c3.SPEC):
        a, b = (spec.pack_color(states((16, 2048, 1024), spec.q))
                for _ in range(2))
        modes[f"clock{spec.q}_packed_2048_measuring"] = (
            lambda spec=spec, a=a, b=b: cp.phase_packed(
                spec, b, a, key, color=1, beta=1 / KBT_CLOCK_08,
                measuring=True))
    return {
        **modes,
        "clock_int8_phase": lambda: c8p.metropolis_phase(
            sa, sb, key, color=0, q=5, beta=1 / KBT_CLOCK),
        "clock_int8_multisweep": lambda: c8ms.multisweep_planes(
            ra, rb, seeds, q=2, beta=1 / KBT_2D),
        "clock_int8_multisweep S=40": lambda: c8ms.multisweep_planes(
            ra, rb, seeds[:40], q=2, beta=1 / KBT_2D),
        "clock_int8_multisweep q=6": lambda: c8ms.multisweep_planes(
            ca, cb, seeds, q=6, beta=1 / KBT_CLOCK),
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--clock", action="store_true",
                    help="time the clock kernels instead")
    ap.add_argument("--helical3d", action="store_true",
                    help="time the helical 3-D phase kernel instead")
    ap.add_argument("--masked", action="store_true",
                    help="time the masked helical Ising multisweep instead")
    ap.add_argument("--samples", action="store_true",
                    help="time the samples classes' one-replica int8 "
                    "kernels instead, also as CUDA graphs")
    ap.add_argument("--registers", action="store_true",
                    help="print every kernel's ptxas registers instead")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_time_ising: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    if args.registers:
        print(json.dumps(register_report(), sort_keys=True))
        return 0
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

    libs = LIBS
    if args.clock:
        modes, libs = clock_modes(gen, dev, seeds), CLOCK_LIBS
    elif args.helical3d:
        modes, libs = helical3d_modes(words), ["helical3d_multispin"]
    elif args.masked:
        modes, libs = masked_modes(spins, gen, dev), ["helical_pallas"]
    elif args.samples:
        modes, libs = samples_modes(spins, gen, dev, phase_key), [
            "ising2d_pallas", "ising2d_measure_pallas", "clock_pallas",
            "clock_measure_pallas"]
    else:
        modes = ising_modes(spins, words, msb, i8ms, i2p, ms3, i3p, seeds,
                            phase_key, b2, b3)
    times = {m: [] for m in modes}
    for _ in range(args.rounds):
        for mode, fn in modes.items():
            if mode.startswith("graph "):
                times[mode].append(graph_ms(fn))
                continue
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
    if not (args.clock or args.helical3d or args.masked or args.samples):
        times["int8_multisweep_blocks"] = i8ms.grid_blocks()
        times["packed_3d_multisweep_blocks"] = ms3.multisweep_grid_blocks()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(smi.strip())
    for lib in libs:
        log = ROOT / ".build" / f"lib{lib}.log"
        if log.exists():
            for line in log.read_text().splitlines():
                if ("Compiling entry" in line or "registers" in line
                        or "stack frame" in line):
                    print(line.strip())
    if args.helical3d:
        sass_report("helical3d_multispin", ("phase_kernel",
                                            "multisweep_kernel"))
    elif args.masked:
        sass_report("helical_pallas", ("ising_multisweep_kernel",))
    elif args.clock:
        sass_report("clock_planes", ("phase_kernel",))
        sass_report("clock_multisweep", ("multisweep_kernel",))
    elif not args.samples:
        sass_report("ising3d_multispin", ("phase_kernel",
                                          "multisweep_kernel"))
        sass_report("ising3d_pallas", ("tile_kernel",))
    print(json.dumps(times))
    return 0


def ising_modes(spins, words, msb, i8ms, i2p, ms3, i3p, seeds, phase_key,
                b2, b3):
    """The Ising kernels at the smoke's launch shapes, on random states."""
    ra, rb = spins((16, 1000, 500)), spins((16, 1000, 500))
    sa, sb = spins((8, 4000, 2000)), spins((8, 4000, 2000))
    va, vb = spins((2, 500, 500, 250)), spins((2, 500, 500, 250))
    # the mesh int8 3-D class's shard of 500^3 x 2 on (2,2) and its halo
    # planes
    ia, ib = spins((1, 250, 500, 250)), spins((1, 250, 500, 250))
    izm, izp = spins((1, 1, 500, 250)), spins((1, 1, 500, 250))
    wa, wb = words((4, 256, 4096)), words((4, 256, 4096))
    xa, xb = words((8, 512, 16, 256)), words((8, 512, 16, 256))
    # the mesh 3-D class's shard of 512^3 x 8 on (2,4) and its halo planes
    ha, hb = words((4, 128, 16, 256)), words((4, 128, 16, 256))
    hzm, hzp = words((4, 1, 16, 256)), words((4, 1, 16, 256))
    ya, yb = words((4, 256, 8, 128)), words((4, 256, 8, 128))
    return {
        "int8_multisweep": lambda: i8ms.multisweep_planes(ra, rb, seeds,
                                                          beta=b2),
        "int8_phase": lambda: i2p.metropolis_phase(sa, sb, phase_key,
                                                   color=0, beta=b2),
        "int8_3d_phase": lambda: i3p.metropolis_phase(va, vb, phase_key,
                                                      color=0, beta=b3),
        "graph int8_3d_shard_measuring": lambda: i3p.sharded_phase(
            ib, ia, izm, izp, phase_key, (0, 250), color=1, beta=b3,
            measuring=True),
        "graph int8_3d_shard": lambda: i3p.sharded_phase(
            ia, ib, izm, izp, phase_key, (0, 250), color=0, beta=b3),
        "packed_phase_measuring": lambda: msb.phase_packed(
            wb, wa, phase_key, color=1, beta=b2, measuring=True),
        "packed_3d_phase_measuring": lambda: ms3.phase3d_packed(
            xb, xa, phase_key, color=1, beta=b3, measuring=True),
        "packed_3d_phase": lambda: ms3.phase3d_packed(
            xa, xb, phase_key, color=0, beta=b3),
        "graph packed_3d_shard_measuring": lambda: ms3.sharded_phase3d_packed(
            hb, ha, hzm, hzp, phase_key, (4, 256), color=1, beta=b3,
            measuring=True),
        "graph packed_3d_shard": lambda: ms3.sharded_phase3d_packed(
            ha, hb, hzm, hzp, phase_key, (4, 256), color=0, beta=b3),
        "packed_3d_multisweep": lambda: ms3.multisweep3d_planes(
            ya, yb, seeds, beta=b3),
    }


if __name__ == "__main__":
    sys.exit(main())
