"""CUDA-event times of the periodic Ising kernels at the smoke's launch
shapes: the int8 S-sweep kernel (1000x1000 x 16, S = 64 and 40, with the
SASS of its multisweep_kernel), the int8 phase
kernels (4000x4000 x 8; 500^3 x 2) and the bit-packed phase kernels,
measuring (8192x8192 x 4; 512^3 x 8), each on a random state, with the
resident blocks of the int8 S-sweep grid; beside them the periodic 3-D
bit-packed kernels at the 3-D classes' other launches: the plain phase a
at 512^3 x 8, the halo mode (measuring and plain) at the mesh 3-D
class's shard (4, 128, 16, 256) of 512^3 x 8 on (2,4), timed as a CUDA
graph of 50 launches (median of 9 windows, chip_smoke.graph_time_ms),
and the 3-D multisweep at 256^3 x 4, S = 64, with the SASS of
phase_kernel and multisweep_kernel; beside the int8 2-D phase (4000x4000
x 8) its halo mode at the mesh int8 2-D class's shard (8, 2000, 1000) of
4000x4000 x 8 on (1,2,2) with its halo rows and columns, measuring and
plain, graph-timed, with the SASS of the int8 2-D phase_kernel; beside
the int8 3-D phase (500^3 x
2) its halo mode at the mesh int8 3-D class's shard (1, 250, 500, 250) of
500^3 x 2 on (2,2), measuring and plain, graph-timed, with the SASS of
the int8 3-D tile_kernel; the periodic 2-D bit-packed kernels at the 2-D
classes' other launches: the multisweep at 2048x2048 x 16 with S = 64
and 40, the halo mode (measuring and plain) at the mesh class's shard
(4, 64, 4096) of 8192x8192 x 4 on (1,4), graph-timed, with the SASS of
phase_kernel and multisweep_kernel and the multisweep grid's resident
blocks; the int8 measure kernel at 500^3 x 2 and 4000x4000 x 8, with its
SASS; with ``--clock``, the clock
kernels whose headers the halo modes share: the bit-sliced q = 6 phase,
measuring, at 2000x2000 x 40 (padded) and 2048x2048 x 16, the int8 clock
phase at 2000x2000 x 16 (q = 5) and its S-sweep kernel at 1000x1000 x 16
(q = 2, S = 64 and 40; q = 6, S = 64), with the SASS of its
multisweep_kernel; beside them the bit-sliced
phase plain (colour a) at
both shapes, measuring at 2048x2048 x 16 for q = 4 and 3, and its halo
mode (measuring and plain) at the mesh packed clock class's shard (8, 32,
512) of 2048x2048 x 16 on (2,2,2), graph-timed, with the SASS of
phase_kernel; and the int8 clock phase at the samples class's 1000x1000 x
1 (q = 6) and its halo mode (measuring and plain) at the mesh int8 clock
class's shard (16, 1000, 500) of 2000x2000 x 16 on (1,2,2) (q = 5), both
graph-timed, and the helical clock multisweep at its class's 501x500 x
100 (q = 6, kbt 0.8, S = 64 and 40) and its injected mode, and the int8
clock measure kernel (row 23) at the streamed class's 2000x2000 x 16 (q =
5) and, graph-timed, at the samples class's 1000x1000 x 1 (q = 6), with
the SASS of the int8 clock phase_kernel, the helical clock
multisweep_kernel and the measure_kernel;
with ``--clock-variants``, the int8 clock phase at 2000x2000 x 16 and
1000x1000 x 1 and its halo mode at the mesh shard, through the C entries
on its library (4 blocks an SM under its launch bound) and on builds
without the bound's minimum and at 5 blocks an SM, each at tiles of up to
8 (the library's), 16 and 4 KB of sites, and the helical clock
multisweep at 501x500 x 100, S = 64 and 40, as the launch alone on its
library (1024 threads a block, the round keys in shared memory) and on
builds of 512 threads and with each thread's round keys in registers
(into .build/variants/), each held bitwise against the wrapper; with
``--helical3d``, the helical 3-D phase kernel at
the even streamed class's launch, 1001x1000x1000 x 2 (colour a, z-parity
sub-phases 0 and 1), and at the odd streamed class's, 501x501x500 x 2
(colour b, plain and measuring), on random vectors, and the helical
3-D resident multisweep (multisweep_kernel) at its class's launch,
151x151x150 x 128 with S = 64, and at the samples protocol's 151x151x150
x 1 with S = 8, and the energy kernel (row 15) at the even class's
1001x1000x1000 x 2 through its wrapper and, as the launch alone, on its
library (runs of 8 words) and on a build of its source with runs of 4
(into .build/variants/, held bitwise against the wrapper), with the SASS
of the three kernels; with ``--helical``, the
helical 2-D multisweep (csrc/helical_multispin.cu multisweep_kernel) at
its class's launch, 1001x1000 x 128, with S = 64 and 40, each also as the
launch alone (the C entry point on keys already on the card, without
the wrapper's key copy), and its injected-bits mode at 1001x1000 x 128,
with the SASS of multisweep_kernel; with ``--masked``,
the masked helical Ising multisweep (csrc/helical_pallas.cu
ising_multisweep_kernel) at its four main-path launches, 1001x1000 x 128,
4001x4000 x 4, 1001x1001 x 16 and the samples class's 1001x1000 x 1, S =
16 sweeps each, and at 1001x1000 x 128 with S = 64, and beside it the
masked clock multisweep of the same source (clock_multisweep_kernel) at
its class's 501x500 x 100, q = 6, S = 16 and 64, with the SASS of both;
with ``--samples``, the four int8 kernels
of the one-replica samples classes at 1000x1000 x 1 (the Ising phase and
measure kernels, the clock's at q = 6), each event-timed as the smoke
times them and as a CUDA graph of 50 launches (the kernel alone, without
the wrapper's host work); with ``--ms-grids``, the 2-D bit-packed
multisweep (row 3) at 2048x2048 x 16, S = 64, at the grid its wrapper
picks (ops/ising2d_multispin.multisweep_grid) and at the grid of the
fewest tiles a block, and the same for a build of its source with the
kernel capped at 64 registers (__launch_bounds__(256, 4): four blocks an
SM; built into .build/variants/), each launch held bitwise against the
wrapper's; with ``--key-variants``, rows 26 and 31 at their classes'
launches through the wrapper, as the launch alone and on builds with their
round keys in registers (into .build/variants/), each held bitwise against
the wrapper; with ``--measure-variants``, the int8 measure kernel (row 27)
at 500^3 x 2 and 4000x4000 x 8 on its library and on builds raising its
blocks an SM to 6 and 8 (__launch_bounds__), and at 500^3 x 2 with runs
of 1, 2, 4 and 8 planes a block, each held against the library's sums;
with ``--phase-variants``, rows 24-25 through their C entries at tiles
of up to 16 (the library's), 8 and 4 KB of sites, and on builds that
write the new words back from the tile's copy (the multisweep's way) and
whose kernel returns at once (the launch's floor; into
.build/variants/), each launch but the last held bitwise against the
wrapper: the phase at 4000x4000 x 8 and, graph-timed, at 1000x1000 x 1
(there also at tiles of 1 and 4 rows), the halo mode at the mesh shard,
measuring and plain; with ``--dat DIR``, no timing of kernels: the three
int8 2-D classes that launch rows 24-25 (streamed 4000x4000 x 8, 8
samples; samples 1000x1000, 16 histories; mesh 4000x4000 x 8 on (1,2,2)
on the card repeated; 200 MCS from all-up) into DIR/*.dat, one JSON line
of their walls and flip attempts/s, for compare_dat.py across two trees;
with ``--registers``,
no timing: every csrc/*.cu built anew and the ptxas registers of each of
its kernels, one JSON line {library: {kernel: registers}} (the kernel's
mangled name without the anonymous namespace's per-file hash), to hold
the includers of a shared header unchanged across two checkouts.

    python3 chip_time_ising.py [--reps 50] [--rounds 3]
                               [--clock | --clock-variants | --helical |
                                --helical3d | --masked |
                                --samples | --ms-grids |
                                --key-variants | --measure-variants |
                                --phase-variants | --dat DIR |
                                --registers]

Run it from the root of a checkout; it needs one NVIDIA GPU and builds
the kernels on first use.  It uses only the wrappers' public API, so to
compare two commits copy it into both checkouts and run it from each in
turns on one card (A, B, B, A).  Prints the card's nvidia-smi name and
power limit, the ptxas register report of the build, with ``--helical3d``
and ``--clock`` the SASS of phase_kernel (both also of
multisweep_kernel, the default mode also of the int8 3-D tile_kernel;
``--masked``: of
ising_multisweep_kernel and clock_multisweep_kernel; instructions, the instructions of each loop,
the commonest opcodes; where cuobjdump exists), and last one JSON line
{mode: [ms a launch, one per round]} (``"int8_multisweep_blocks": n``,
``"packed_3d_multisweep_blocks": n`` and ``"packed_2d_multisweep_blocks":
n`` beside the Ising modes).
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
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
KBT_2D, KBT_3D = 2.269185314213022, 4.51152
LIBS = ["ising2d_multisweep", "ising2d_pallas", "ising3d_pallas",
        "ising2d_multispin", "ising3d_multispin", "ising2d_measure_pallas"]
CLOCK_LIBS = ["clock_planes", "clock_pallas", "clock_multisweep",
              "clock_helical_multispin", "clock_measure_pallas"]
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


def energy_run_launch(h3, wa, wb, geom: dict, run: int):
    """Row 15's launch alone on (wa, wb) in runs of ``run`` words: on the
    library (its ENERGY_RUN) or on a build of its source with
    ENERGY_RUN = ``run`` (into .build/variants/), with the constants
    energy_runs gives for that run; held bitwise against the wrapper."""
    from unittest import mock
    lib = h3._lib()
    if run != h3.ENERGY_RUN:
        lib = variant_lib(
            "helical3d_multispin", "constexpr int ENERGY_RUN = 8;",
            f"constexpr int ENERGY_RUN = {run};", f"run{run}", lib,
            ("helical3d_energy",))
    nrep, nw = wa.shape
    nx, nxy, m = geom["nx"], geom["nxy"], geom["m"]
    with mock.patch.object(h3, "ENERGY_RUN", run):
        runs = h3._energy_runs_arg.__wrapped__(nrep, nx, nxy, m)
    d = h3._offsets([dd for _, _, dd in h3._energy_pairs(nx, nxy)], m)

    def launch():
        obs = torch.zeros((nrep, 2), dtype=torch.int64, device=wa.device)
        code = lib.helical3d_energy(
            wa.data_ptr(), wb.data_ptr(), obs.data_ptr(), nrep, nw, m, d,
            int(nxy % 2 == 0), runs, torch.cuda.current_stream().cuda_stream)
        if code:
            raise RuntimeError(f"energy runs of {run}: code {code}")
        return obs
    if not torch.equal(launch(), h3.energy_sums(wa, wb, **geom)):
        raise RuntimeError(f"energy runs of {run} differ from the wrapper")
    return launch


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
    geom = {k: even[k] for k in ("nx", "nxy", "m")}
    modes = {"helical3d energy 1001x1000x1000 x 2": lambda: h3.energy_sums(
        ea, eb, **geom)}
    if hasattr(h3, "energy_runs"):
        # the launch alone in runs of 8 and 4 words (a tree before the
        # runs has one design)
        for run in (8, 4):
            modes[f"helical3d energy 1001x1000x1000 x 2 launch run={run}"] = (
                energy_run_launch(h3, ea, eb, geom, run))
    return {
        **modes,
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


def helical_modes(words, dev):
    """The helical 2-D multisweep at its class's launch, 1001x1000 x 128,
    S = 64 and 40, through the wrapper and as the launch alone, and its
    injected-bits mode, on random vectors."""
    from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
        helical_multispin as hms,
        ising2d_multispin as msb,
        multispin_rng,
    )
    nx, ny, nrep = 1001, 1000, 128
    m, beta = nx * ny // 2, 1 / KBT_2D
    nw = hms.words(m)
    wa, wb, b4, b8 = (words((nrep, nw)) for _ in range(4))
    seeds = multispin_rng.sweep_phase_keys(
        torch.tensor([12345, 678], dtype=torch.int64), 64)
    seeds_dev = msb._i32(seeds).contiguous().to(dev)
    out = [torch.empty_like(wa), torch.empty_like(wb)]
    obs = torch.empty((nrep, 64, 2), dtype=torch.int64, device=dev)
    q4, q8 = msb.chain_words(beta)
    # the chains' argument: the launch table, or (q4, q8) before it
    chains = ((hms._table(q4, q8),) if hasattr(hms, "keys_to")
              else (q4, q8))
    da, db = ([d % m for d in offs] for offs in hms.helical_offsets(nx))
    staged = int(hms.staged_fits(nw, dev))

    def alone(sweeps):
        lib = hms._lib()
        code = lib.helical_multisweep(
            wa.data_ptr(), wb.data_ptr(), out[0].data_ptr(),
            out[1].data_ptr(), seeds_dev.data_ptr(), None, None,
            obs.data_ptr(), nrep, nw, m, sweeps, 0, staged, *da, *db,
            *chains, msb._stream(wa))
        assert code == 0, code

    offs = hms.helical_offsets(nx)[0]
    return {
        "helical multisweep 1001x1000 x 128 S=64": lambda: (
            hms.multisweep_planes(wa, wb, seeds, beta=beta, nx=nx, m=m)),
        "helical multisweep 1001x1000 x 128 S=40": lambda: (
            hms.multisweep_planes(wa, wb, seeds[:40], beta=beta, nx=nx,
                                  m=m)),
        "helical multisweep 1001x1000 x 128 S=64, launch alone": lambda: (
            alone(64)),
        "helical multisweep 1001x1000 x 128 S=40, launch alone": lambda: (
            alone(40)),
        "helical bits mode 1001x1000 x 128": lambda: (
            hms.phase_packed_with_bits(wa, wb, b4, b8, offs=offs, m=m)),
    }


def masked_modes(spins, gen, dev):
    """The masked helical Ising multisweep at MASKED_SHAPES with S =
    MASKED_SWEEPS (the first also with S = 64) and the masked clock
    multisweep at 501x500 x 100, q = 6, S = MASKED_SWEEPS and 64, on
    random states (updated in place, launch after launch)."""
    from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
        helical_pallas as hp,
        multispin_rng,
    )
    seeds = multispin_rng.sweep_phase_keys(
        torch.tensor([12345, 678], dtype=torch.int64), 64)
    modes = {}
    for k, (nrep, ny, nx) in enumerate(MASKED_SHAPES):
        x = spins((nrep, ny * nx))
        for sweeps in (MASKED_SWEEPS, 64)[:2 if k == 0 else 1]:
            modes[f"masked multisweep {ny}x{nx} x {nrep} S={sweeps}"] = (
                lambda x=x, nx=nx, s=sweeps: hp.ising_multisweep(
                    x, seeds[:s], beta=1 / KBT_2D, nx=nx))
    c = torch.randint(0, 6, (100, 500 * 501), generator=gen, device=dev,
                      dtype=torch.int64).to(torch.int8)
    for sweeps in (MASKED_SWEEPS, 64):
        modes[f"masked clock multisweep 500x501 x 100 q=6 S={sweeps}"] = (
            lambda s=sweeps: hp.clock_multisweep(
                c, seeds[:s], beta=1 / KBT_CLOCK_08, nx=501, q=6))
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


def int8_class_dat(out: Path) -> dict:
    """The three int8 2-D classes that run rows 24-25, from all-up as
    chip_smoke.py runs them, each into out/<class>.dat (``--dat``): the
    streamed 4000x4000 x 8 (8 samples, 200 MCS) and the samples class
    (1000x1000, 16 histories of 200 MCS) through the CLI, the mesh class
    (4000x4000 x 8 on (1,2,2), the card repeated) through
    protocols.run_relaxation.  Returns {class: {"wall_s", "rate"}}, rate
    in flip attempts/s of the wall."""
    from chip_smoke import KBT

    from cuda_fortran_mc_simulation_spin_tpu_torch.config import RunConfig
    from cuda_fortran_mc_simulation_spin_tpu_torch.engine import protocols
    from cuda_fortran_mc_simulation_spin_tpu_torch.runs.__main__ import (
        main as cli_main,
    )
    out.mkdir(parents=True, exist_ok=True)
    model = ["--model", "ising2d", "--kbt", repr(KBT), "--mcs", "200",
             "--init-state", "allup", "--device", "cuda"]
    runs = {
        "streamed_4000": (4000 ** 2 * 200 * 8, model + [
            "--nx", "4000", "--ny", "4000", "--samples", "8", "--replicas",
            "8"]),
        "samples_1000": (1000 ** 2 * 200 * 16, model + [
            "--protocol", "samples", "--nx", "1000", "--ny", "1000",
            "--samples", "16"]),
    }
    res = {}
    for name, (flips, argv) in runs.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc = cli_main(argv + ["--output", str(out / f"{name}.dat")])
        torch.cuda.synchronize()
        if rc != 0:
            raise RuntimeError(f"{name}: the CLI exited {rc}")
        wall = time.perf_counter() - t0
        res[name] = {"wall_s": wall, "rate": flips / wall}
    dev = torch.device("cuda")
    cfg = RunConfig(model="ising2d", nx=4000, ny=4000, nz=1, kbt=KBT,
                    mcs=200, tot_sample=8, replicas=8, mesh_dp=1, mesh_y=2,
                    mesh_x=2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with (out / "mesh_122.dat").open("w") as f, open(os.devnull, "w") as e:
        protocols.run_relaxation(cfg, out=f, err=e, device=dev,
                                 mesh_devices=[dev] * 4)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    res["mesh_122"] = {"wall_s": wall, "rate": 4000 ** 2 * 200 * 8 / wall}
    return res


# the int8 2-D phase kernel's tile sizes of --phase-variants: the
# library's (ops/ising2d_pallas.TILE_BYTES) first
I8_TILE_BYTES = (16384, 8192, 4096)


def phase_variant_modes(spins, dev, key):
    """Rows 24-25 through their C entries (``--phase-variants``): on the
    library at each tile size of I8_TILE_BYTES, and at the library's on
    builds of its source (into .build/variants/) that stage the new words
    and write them back as the multisweep does, and whose kernel returns
    at once (the launch's floor, not held against the wrapper); every
    other launch held bitwise against the wrapper.  The phase at the
    streamed class's 4000x4000 x 8 (events) and, graph-timed, the samples
    class's 1000x1000 x 1 (there also the library at tiles of 1 and 4
    rows), and the halo mode at the mesh class's shard (8, 2000, 1000) of
    4000x4000 x 8 on (1,2,2) with its halo rows and columns, measuring
    and plain."""
    import ctypes

    from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
        ising2d_multisweep as i8ms,
        ising2d_pallas as i2p,
        ising3d_pallas as i3p,
    )
    base = i2p._lib()
    names = ("ising2d_int8_phase", "ising2d_int8_halo_phase")
    call = "    ising8::tile<MEASURE, HALO, INJECT, true>("
    # tag: (library, held against the wrapper, tile sizes)
    libs = {"library": (base, True, I8_TILE_BYTES)}
    for tag, new in (("staged write-back", call.replace("true>", "false>")),
                     ("empty kernel", "    if (false)" + call[3:])):
        libs[tag] = (variant_lib("ising2d_pallas", call, new,
                                 tag.replace(" ", "_").replace("-", ""),
                                 base, names),
                     tag != "empty kernel", I8_TILE_BYTES[:1])
    beta = 1 / KBT_2D
    t4, t8 = i2p.accept_thresholds_u32(beta)
    s0, s1 = i2p.seed_words(key)

    def stream():
        # the current stream at the call: a graph captures on its own
        return torch.cuda.current_stream().cuda_stream

    def rows_tiles(ny, half, rows, lux):
        # tiles of `rows` whole rows, 2^lux threads a row
        buf, end = i3p.stage_layout(i8ms._spans(rows, half, half))
        t = dict(rows=rows, lux=lux, cw=half, nch=1, nty=-(-ny // rows),
                 buf=buf, smem=end)
        i8ms.check_ms_tiles(t, ny, half)
        words = [rows, lux, half, 1, t["nty"], *buf, end]
        return (ctypes.c_int * len(words))(*words)

    modes = {}
    for shape in ((8, 4000, 2000), (1, 1000, 500)):
        a0, b0 = spins(shape), spins(shape)
        want = i2p.metropolis_phase(a0.clone(), b0, key, color=0, beta=beta)
        for tag, (lib, check, sizes) in libs.items():
            tiles = {str(n): i8ms._tiles_arg(*shape, n) for n in sizes}
            if shape[0] == 1 and tag == "library":
                tiles.update({"rows 1": rows_tiles(1000, 500, 1, 8),
                              "rows 4": rows_tiles(1000, 500, 4, 7)})
            for size, tl in tiles.items():
                def phase(x=a0.clone(), tl=tl, shape=shape, b0=b0, lib=lib):
                    code = lib.ising2d_int8_phase(
                        x.data_ptr(), b0.data_ptr(), None, *shape, 0, s0,
                        s1, t4, t8, tl, stream())
                    if code:
                        raise RuntimeError(f"int8 phase launch: {code}")
                    return x
                x = a0.clone()
                phase(x=x)
                if check and not torch.equal(x, want):
                    raise RuntimeError(f"int8 phase {shape} {size} {tag} "
                                       "differs")
                label = (f"int8_phase {'x'.join(map(str, shape))}, {tag}, "
                         f"tiles {size}")
                modes[("graph " if shape[0] == 1 else "") + label] = phase
    shape = (8, 2000, 1000)
    ka, kb = spins(shape), spins(shape)
    up, dn = spins((8, 1, 1000)), spins((8, 1, 1000))
    lf, rt = spins((8, 2000, 1)), spins((8, 2000, 1))
    want = i2p.sharded_phase(ka.clone(), kb, up, dn, key, (0, 2000, 1000),
                             color=1, beta=beta, halo_lf=lf, halo_rt=rt,
                             measuring=True)
    obs = torch.zeros((8, 2), dtype=torch.int64, device=dev)
    for tag, (lib, check, sizes) in libs.items():
        for nbytes in sizes:
            tiles = i8ms._tiles_arg(*shape, nbytes)
            for measuring in (True, False):
                def halo(x=ka.clone(), tiles=tiles, measuring=measuring,
                         lib=lib):
                    code = lib.ising2d_int8_halo_phase(
                        x.data_ptr(), kb.data_ptr(), None, up.data_ptr(),
                        dn.data_ptr(), lf.data_ptr(), rt.data_ptr(),
                        obs.data_ptr() if measuring else None, *shape, 1,
                        0, 2000, 1000, s0, s1, t4, t8, tiles, stream())
                    if code:
                        raise RuntimeError(f"int8 halo launch: {code}")
                    return x
                x = ka.clone()
                obs.zero_()
                halo(x=x)
                if check and (not torch.equal(x, want[0]) or (
                        measuring and not (
                            torch.equal(obs[:, 0], want[1])
                            and torch.equal(obs[:, 1], want[2])))):
                    raise RuntimeError(f"int8 halo {tag} {nbytes} "
                                       f"{measuring} differs")
                modes[f"graph int8_shard "
                      f"{'measuring' if measuring else 'plain'}, {tag}, "
                      f"tiles {nbytes}"] = halo
    return modes


def variant_lib(lib: str, old, new, tag: str, base, names):
    """csrc/<lib>.cu with ``old`` replaced by ``new`` (or, ``old`` a list of
    (old, new) pairs, each replaced), built into
    .build/variants/lib<lib>_<tag>.so (its ptxas report printed), loaded
    with the argument types of ``base``'s functions ``names``."""
    import ctypes

    from cuda_fortran_mc_simulation_spin_tpu_torch.ops import _build
    src = (_build.CSRC / f"{lib}.cu").read_text()
    pairs = old if isinstance(old, list) else [(old, new)]
    for o, n in pairs[:-1]:
        assert o in src, o
        src = src.replace(o, n)
    old, new = pairs[-1]
    assert old in src, old
    vdir = _build.BUILD_DIR / "variants"
    vdir.mkdir(parents=True, exist_ok=True)
    path = vdir / f"{lib}_{tag}.cu"
    path.write_text(src.replace(old, new))
    out = vdir / f"lib{lib}_{tag}.so"
    built = subprocess.run(
        [_build.nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
         str(out), str(path)], capture_output=True, text=True, check=True)
    for line in (built.stdout + built.stderr).splitlines():
        if "registers" in line or "spill" in line:
            print(f"variant {lib} {tag}:", line.strip())
    var = ctypes.CDLL(str(out))
    for name in names:
        getattr(var, name).argtypes = getattr(base, name).argtypes
        getattr(var, name).restype = getattr(base, name).restype
    return var


def measure_variant_modes(spins, dev):
    """Row 27 at 500^3 x 2 and 4000x4000 x 8 on the library and on builds
    of its source with the kernel's blocks an SM raised by
    __launch_bounds__(256, 6) and (256, 8) (at most 40 and 32 registers),
    and at 500^3 x 2 with runs of 1, 2, 4 and 8 planes a block, each
    launch held against the library's sums (``--measure-variants``)."""
    import ctypes

    from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
        ising2d_measure_pallas as i8m,
    )
    base = i8m._lib()
    old = "__launch_bounds__(THREADS)\n    measure_kernel"
    libs = {"": base}
    for mb in (6, 8):
        libs[f"mb{mb} "] = variant_lib(
            "ising2d_measure_pallas", old,
            f"__launch_bounds__(THREADS, {mb})\n    measure_kernel",
            f"mb{mb}", base, ("ising_int8_measure",))
    modes = {}
    for label, shape in (("3d 500^3 x 2", (2, 500, 500, 250)),
                         ("2d 4000^2 x 8", (8, 4000, 2000))):
        a, b = spins(shape), spins(shape)
        dims = len(shape) - 1
        nrep, *vol, half = shape
        nz, ny = (1, *vol) if dims == 2 else vol
        want = i8m.measure_sums(a, b)
        for tag, lib in libs.items():
            def run(lib=lib, a=a, b=b, dims=dims, nrep=nrep, nz=nz, ny=ny,
                    half=half):
                obs = torch.zeros((nrep, 2), dtype=torch.int64, device=dev)
                code = lib.ising_int8_measure(
                    a.data_ptr(), b.data_ptr(), obs.data_ptr(), nrep, dims,
                    nz, ny, half, i8m._tiles_arg(nz, ny, half, dims),
                    torch.cuda.current_stream().cuda_stream)
                if code:
                    raise RuntimeError(f"measure variant: {code}")
                return obs
            if not torch.equal(run(), want):
                raise RuntimeError(f"{tag}{label} differs")
            modes[f"int8_measure {tag}{label}"] = run
    # the library at other runs of planes a block in 3-D
    a, b = spins((2, 500, 500, 250)), spins((2, 500, 500, 250))
    want = i8m.measure_sums(a, b)
    for zrun in (1, 2, 4, 8):
        t = dict(i8m.measure_tiles(500, 500, 250, 3), zrun=zrun,
                 nzg=-(-500 // zrun))
        words = [t["rows"], t["lux"], t["cw"], t["nch"], t["nty"], zrun,
                 t["nzg"], *t["buf"], t["smem"]]

        def run(words=words):
            obs = torch.zeros((2, 2), dtype=torch.int64, device=dev)
            code = base.ising_int8_measure(
                a.data_ptr(), b.data_ptr(), obs.data_ptr(), 2, 3, 500, 500,
                250, (ctypes.c_int * len(words))(*words),
                torch.cuda.current_stream().cuda_stream)
            if code:
                raise RuntimeError(f"measure zrun: {code}")
            return obs
        if not torch.equal(run(), want):
            raise RuntimeError(f"zrun {zrun} differs")
        modes[f"int8_measure 3d 500^3 x 2 zrun={zrun}"] = run
    return modes


def key_variant_modes(spins, gen, dev, seeds):
    """Rows 26 and 31 at their classes' launches (the int8 2-D multisweep
    at 1000x1000 x 16, S = 64; the masked clock at 501x500 x 100, q = 6,
    S = 16): through the wrapper, as the launch alone (the C entry on keys
    already on the card) and on a build of the source whose round keys
    stay in registers, every thread taking its own, as their first tile
    designs had them (built into .build/variants/), each launch held
    bitwise against the wrapper's (``--key-variants``)."""
    from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
        helical_pallas as hp,
        ising2d_multisweep as i8ms,
        multispin_rng,
    )
    keys = multispin_rng.keys_to(seeds, dev)
    stream = torch.cuda.current_stream().cuda_stream
    shared = ("      __shared__ uint2 rk[10];\n      if (threadIdx.x == 0)\n",
              "      uint2 rk[10];\n      if (true)\n")
    modes = {}
    # row 26
    base = i8ms._lib()
    var = variant_lib("ising2d_multisweep", *shared, "regkeys", base,
                      ("ising2d_int8_multisweep",))
    a0, b0 = spins((16, 1000, 500)), spins((16, 1000, 500))
    t4, t8 = i8ms.accept_thresholds_u32(1 / KBT_2D)
    tiles = i8ms._tiles_arg(16, 1000, 500)

    def int8_alone(lib, a, b):
        obs = torch.zeros((16, 64, 2), dtype=torch.int64, device=dev)
        code = lib.ising2d_int8_multisweep(
            a.data_ptr(), b.data_ptr(), keys.data_ptr(), obs.data_ptr(), 16,
            1000, 500, 64, t4, t8, tiles, stream)
        if code:
            raise RuntimeError(f"int8 multisweep launch: {code}")
        return a, b, obs

    want = i8ms.multisweep_planes(a0.clone(), b0.clone(), seeds,
                                  beta=1 / KBT_2D)
    for tag, lib in (("launch alone", base), ("keys in registers", var)):
        got = int8_alone(lib, a0.clone(), b0.clone())
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise RuntimeError(f"int8 multisweep, {tag}, differs")
    a, b = a0.clone(), b0.clone()
    modes["int8_multisweep S=64"] = lambda: i8ms.multisweep_planes(
        a, b, seeds, beta=1 / KBT_2D)
    modes["int8_multisweep S=64, launch alone"] = lambda: int8_alone(
        base, a, b)
    modes["int8_multisweep S=64, keys in registers"] = lambda: int8_alone(
        var, a, b)
    # row 31
    hbase = hp._lib()
    hvar = variant_lib("helical_pallas", *shared, "regkeys", hbase,
                       ("hp_clock_multisweep",))
    c0 = torch.randint(0, 6, (100, 500 * 501), generator=gen, device=dev,
                       dtype=torch.int64).to(torch.int8)
    tab = hp._device_table(6, str(dev), torch.float32)
    tab64 = hp._device_table(6, str(dev), torch.float64)
    sw = MASKED_SWEEPS

    def clock_alone(lib, x):
        g = hp.ising_tiles(100, 250500, 501, x.data_ptr())
        part = torch.empty((100, sw, g["tpr"], 3), dtype=torch.float64,
                           device=dev)
        obs = torch.empty((100, sw, 3), dtype=torch.float64, device=dev)
        code = lib.hp_clock_multisweep(
            x.data_ptr(), None, keys.data_ptr(), None, None, tab.data_ptr(),
            tab64.data_ptr(), part.data_ptr(), obs.data_ptr(), 100, 250500,
            501, 6, sw, -1 / KBT_CLOCK_08, g["off0"], g["tpr"], stream)
        if code:
            raise RuntimeError(f"masked clock launch: {code}")
        return x, obs

    want = hp.clock_multisweep(c0.clone(), seeds[:sw], beta=1 / KBT_CLOCK_08,
                               nx=501, q=6)
    for tag, lib in (("launch alone", hbase), ("keys in registers", hvar)):
        got = clock_alone(lib, c0.clone())
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise RuntimeError(f"masked clock, {tag}, differs")
    c = c0.clone()
    label = f"masked clock multisweep 500x501 x 100 q=6 S={sw}"
    modes[label] = lambda: hp.clock_multisweep(
        c, seeds[:sw], beta=1 / KBT_CLOCK_08, nx=501, q=6)
    modes[f"{label}, launch alone"] = lambda: clock_alone(hbase, c)
    modes[f"{label}, keys in registers"] = lambda: clock_alone(hvar, c)
    return modes


def ms_grid_modes(words, msb, seeds, b2):
    """Row 3 at the 2-D resident class's launch, 2048x2048 x 16, S = 64, at
    its wrapper's grid and at the fewest tiles a block, on the library
    and on a variant capped at 64 registers (``--ms-grids``)."""
    import ctypes
    import math

    base = msb._lib()
    var = variant_lib(
        "ising2d_multispin",
        "__launch_bounds__(TILE_X * TILE_Y)\n    multisweep_kernel",
        "__launch_bounds__(TILE_X * TILE_Y, 4)\n    multisweep_kernel",
        "mb4", base, ("ising2d_multisweep", "ising2d_multisweep_grid"))
    pa, pb = words((16, 64, 1024)), words((16, 64, 1024))
    sweeps = int(seeds.shape[0])
    seeds_dev = msb._i32(seeds).contiguous().to(pa.device)
    table = msb._table(*msb.chain_words(b2))

    def call(lib, blocks, per):
        def run():
            wa, wb = torch.empty_like(pa), torch.empty_like(pb)
            obs = torch.zeros((16, sweeps, 2), dtype=torch.int64,
                              device=pa.device)
            code = lib.ising2d_multisweep(
                pa.data_ptr(), pb.data_ptr(), wa.data_ptr(), wb.data_ptr(),
                seeds_dev.data_ptr(), obs.data_ptr(), 16, 64, 1024, sweeps,
                blocks, per, table, torch.cuda.current_stream().cuda_stream)
            if code:
                raise RuntimeError(f"multisweep at {blocks}x{per}: {code}")
            return wa, wb, obs
        return run

    want = msb.multisweep_planes(pa, pb, seeds, beta=b2)
    tiles, modes = 16 * 8 * 32, {}
    for tag, lib in (("", base), ("mb4 ", var)):
        res, sms = ctypes.c_int(), ctypes.c_int()
        lib.ising2d_multisweep_grid(ctypes.byref(res), ctypes.byref(sms))
        p0 = math.ceil(tiles / res.value)
        for blocks, per in sorted({msb.multisweep_grid(tiles, res.value,
                                                       sms.value),
                                   (math.ceil(tiles / p0), p0)}):
            fn = call(lib, blocks, per)
            if not all(torch.equal(g, w) for g, w in zip(fn(), want)):
                raise RuntimeError(f"{tag}{blocks}x{per} differs")
            modes[f"packed_multisweep {tag}{blocks}x{per} (resident "
                  f"{res.value})"] = fn
    return modes


def helical_clock_words(gen, dev, nrep: int = 100):
    """Random (s, t0, t1) triplets of both colours at 501x500 x nrep and
    the colour's sites m and words."""
    from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
        helical_multispin as hms,
    )
    m = 501 * 500 // 2
    nw = hms.words(m)
    vecs = [torch.randint(-2 ** 31, 2 ** 31, (nrep, nw), generator=gen,
                          device=dev, dtype=torch.int64).to(torch.int32)
            for _ in range(14)]
    return tuple(vecs[:3]), tuple(vecs[3:6]), vecs[6:], m


def helical_clock_modes(gen, dev, seeds):
    """Rows 18-19: the helical clock multisweep at its class's launch,
    501x500 x 100, q = 6, kbt 0.8, with S = 64 and 40, and its injected
    mode (one phase on 8 given planes)."""
    from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
        clock_helical_multispin as chm,
        helical_multispin as hms,
    )
    a3, b3, planes, m = helical_clock_words(gen, dev)
    offs = hms.helical_offsets(501)[0]
    kw = dict(beta=1 / KBT_CLOCK_08, nx=501, m=m)
    return {
        "helical clock multisweep 501x500 x 100 S=64": lambda: (
            chm.multisweep_planes(a3, b3, seeds, **kw)),
        "helical clock multisweep 501x500 x 100 S=40": lambda: (
            chm.multisweep_planes(a3, b3, seeds[:40], **kw)),
        "helical clock bits mode 501x500 x 100": lambda: (
            chm.phase_packed_with_bits(a3, b3, planes, offs=offs, m=m)),
    }


# the variant builds of --clock-variants: the int8 clock phase kernel
# (row 20, with its halo mode row 21; 4 blocks an SM under its launch
# bound, 64 registers) without the bound's minimum and at 5 blocks an SM
# (51 registers), and the helical clock multisweep
# (rows 18-19, 1024 threads a block, the round keys in shared memory)
# with 512 threads and with every thread holding its own round keys in
# registers, as its first redesign did
C8_BOUNDS = ("__global__ void __launch_bounds__(THREADS, 4) phase_kernel("
             "Args a)")
HC_THREADS = ("constexpr int THREADS = 1024;",
              "constexpr int THREADS = 512;")
HC_REG_KEYS = [("  __shared__ uint2 rk[10];  // the round keys of the (sweep, "
                "phase)\n", "  uint2 rk[10];\n"),
               ("        if (tid == 0)\n          philox_round_keys(",
                "        if (true)\n          philox_round_keys(")]
# the phase's tiles: phase_tiles' (whole-row tiles up to 8 KB of sites)
# and tiles of up to 16 KB (the multisweeps') and 4 KB
C8_TILE_BYTES = (8192, 16384, 4096)


def clock_variant_modes(gen, dev, seeds):
    """Rows 20-21 and 18-19 on their libraries and on variant builds
    (``--clock-variants``, into .build/variants/), each launch held
    bitwise against the wrapper: the int8 phase at 2000x2000 x 16, q = 5
    (events) and 1000x1000 x 1, q = 6, and its halo mode at the mesh
    class's shard (16, 1000, 500), measuring and plain (graphs), through
    the C entries on each build and at each tile size of C8_TILE_BYTES;
    the helical clock multisweep at 501x500 x 100, S = 64 and 40, as the
    launch alone (keys and table already on the card) on each build."""
    import ctypes

    from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
        clock_helical_multispin as chm,
        clock_pallas as c8p,
        helical_multispin as hms,
        ising2d_multisweep as i8ms,
        multispin_rng,
    )
    def stream():
        # the current stream at the call: a graph captures on its own
        return torch.cuda.current_stream().cuda_stream

    modes = {}
    # rows 20-21
    base = c8p._lib()
    names = ("clock_int8_phase", "clock_int8_halo_phase")
    libs = {"library": base}
    for nb, bound in (("no minimum", "(THREADS)"), (5, "(THREADS, 5)")):
        libs[f"bounds {nb}"] = variant_lib(
            "clock_pallas", C8_BOUNDS,
            C8_BOUNDS.replace("(THREADS, 4)", bound), f"b{nb}".replace(
                " ", "_"), base, names)

    def states(shape, q):
        return torch.randint(0, q, shape, generator=gen, device=dev,
                             dtype=torch.int64).to(torch.int8)

    def tiles_of(nrep, ny, half, nbytes):
        old = i8ms.TILE_BYTES
        i8ms.TILE_BYTES = nbytes
        try:
            t = i8ms.ms_tiles(nrep, ny, half)
        finally:
            i8ms.TILE_BYTES = old
        i8ms.check_ms_tiles(t, ny, half)
        words = [t["rows"], t["lux"], t["cw"], t["nch"], t["nty"], *t["buf"],
                 t["smem"]]
        return (ctypes.c_int * len(words))(*words)

    key = seeds[0, 0]
    s0, s1 = (int(v) & 0xFFFFFFFF for v in key)
    for q, shape in ((5, (16, 2000, 1000)), (6, (1, 1000, 500))):
        a0, b0 = states(shape, q), states(shape, q)
        tab = c8p.device_table(q, dev)
        want = c8p.metropolis_phase(a0.clone(), b0, key, color=0, q=q,
                                    beta=1 / KBT_CLOCK)
        for nbytes in C8_TILE_BYTES:
            tiles = tiles_of(*shape, nbytes)
            for tag, lib in libs.items():
                def phase(lib=lib, x=a0.clone(), tiles=tiles, q=q,
                          shape=shape, b0=b0, tab=tab):
                    code = lib.clock_int8_phase(
                        x.data_ptr(), b0.data_ptr(), tab.data_ptr(), None,
                        None, *shape, q, 0, -1 / KBT_CLOCK, s0, s1, tiles,
                        stream())
                    if code:
                        raise RuntimeError(f"clock phase launch: {code}")
                    return x
                x = a0.clone()
                phase(x=x)
                if not torch.equal(x, want):
                    raise RuntimeError(f"clock phase {tag} {nbytes} differs")
                label = (f"clock8 phase {'x'.join(map(str, shape))} q={q}, "
                         f"{tag}, tiles {nbytes}")
                if shape[0] == 1:
                    label = "graph " + label
                modes[label] = phase
    # row 21 at its shard, its halos from its own other colour
    ka, kb = states((16, 1000, 500), 5), states((16, 1000, 500), 5)
    lf, rt = kb[:, :, -1:].contiguous(), kb[:, :, :1].contiguous()
    up, dn = kb[:, -1:].contiguous(), kb[:, :1].contiguous()
    tab, tab64 = c8p.device_table(5, dev), c8p.device_table(5, dev,
                                                            torch.float64)
    want = c8p.sharded_phase(ka.clone(), kb, up, dn, key, (0, 1000, 500),
                             color=1, q=5, beta=1 / KBT_CLOCK,
                             measuring=True, halo_lf=lf, halo_rt=rt)
    for nbytes in C8_TILE_BYTES:
        tiles = tiles_of(16, 1000, 500, nbytes)
        part = torch.empty((16, tiles[4] * tiles[3], 3), dtype=torch.float64,
                           device=dev)
        obs = torch.empty((16, 3), dtype=torch.float64, device=dev)
        for tag, lib in libs.items():
            for measuring in (True, False):
                def halo(lib=lib, x=ka.clone(), tiles=tiles,
                         measuring=measuring, part=part, obs=obs):
                    code = lib.clock_int8_halo_phase(
                        x.data_ptr(), kb.data_ptr(), tab.data_ptr(),
                        tab64.data_ptr(), None, None, up.data_ptr(),
                        dn.data_ptr(), lf.data_ptr(), rt.data_ptr(),
                        part.data_ptr() if measuring else None,
                        obs.data_ptr() if measuring else None, 16, 1000,
                        500, 5, 1, 0, 1000, 500, -1 / KBT_CLOCK, s0, s1,
                        tiles, stream())
                    if code:
                        raise RuntimeError(f"clock halo launch: {code}")
                    return x
                x = ka.clone()
                halo(x=x)
                if not torch.equal(x, want[0]):
                    raise RuntimeError(f"clock halo {tag} {nbytes} differs")
                if measuring and not torch.allclose(
                        obs.T, torch.stack(want[1:]), rtol=1e-12, atol=0):
                    raise RuntimeError(f"clock halo sums {tag} {nbytes}")
                modes[f"graph clock8 shard (16, 1000, 500) "
                      f"{'measuring' if measuring else 'plain'}, {tag}, "
                      f"tiles {nbytes}"] = halo
    # rows 18-19
    a3, b3, _, m = helical_clock_words(gen, dev)
    nw = hms.words(m)
    beta = 1 / KBT_CLOCK_08
    keys = multispin_rng.keys_to(seeds, dev)
    table = chm._table_arg(chm.SPEC, beta)
    da, db = ([d % m for d in offs] for offs in hms.helical_offsets(501))
    staged = int(chm.staged_fits(nw, dev))
    hbase = chm._lib()
    hnames = ("clock_helical_multisweep", "clock_helical_smem_optin")
    hlibs = {
        "1024 threads, keys in shared memory": hbase,
        "512 threads, keys in shared memory": variant_lib(
            "clock_helical_multispin", [HC_THREADS], None, "t512", hbase,
            hnames),
        "1024 threads, keys in registers": variant_lib(
            "clock_helical_multispin", HC_REG_KEYS, None, "regkeys", hbase,
            hnames),
        "512 threads, keys in registers": variant_lib(
            "clock_helical_multispin", [HC_THREADS, *HC_REG_KEYS], None,
            "t512_regkeys", hbase, hnames),
    }
    outs = [torch.empty_like(a3[0]) for _ in range(6)]
    hobs = torch.empty((100, 64, 3), dtype=torch.int64, device=dev)

    def alone(lib, sweeps):
        code = lib.clock_helical_multisweep(
            *[w.data_ptr() for w in (*a3, *b3, *outs)], keys.data_ptr(),
            None, hobs.data_ptr(), 100, nw, m, sweeps, 0, staged, *da, *db,
            table, stream())
        if code:
            raise RuntimeError(f"helical clock launch: {code}")

    vm = hms.valid_mask(m, dev)
    want = chm.multisweep_planes(a3, b3, seeds, beta=beta, nx=501, m=m)
    for tag, lib in hlibs.items():
        alone(lib, 64)
        if not (all(torch.equal(hms._u32(g) & vm, hms._u32(w) & vm)
                    for g, w in zip(outs, want[0] + want[1]))
                and torch.equal(hobs, want[2])):
            raise RuntimeError(f"helical clock, {tag}, differs")
        for sweeps in (64, 40):
            modes[f"helical clock multisweep S={sweeps}, {tag}"] = (
                lambda lib=lib, s=sweeps: alone(lib, s))
    return modes


def clock_modes(gen, dev, seeds):
    """The clock kernels at the smoke's launch shapes, on random states."""
    from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
        clock3_multispin as c3,
        clock4_multispin as c4,
        clock_measure_pallas as c8m,
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
    # row 20 at the samples class's launch (1000^2 x 1, q = 6) and row 21
    # at the mesh int8 clock class's shard (16, 1000, 500) of 2000^2 x 16
    # on (1,2,2), q = 5, its halos from its own other colour, as graphs
    ta, tb = states((1, 1000, 500), 6), states((1, 1000, 500), 6)
    ka, kb = states((16, 1000, 500), 5), states((16, 1000, 500), 5)
    khalo = dict(halo_lf=kb[:, :, -1:].contiguous(),
                 halo_rt=kb[:, :, :1].contiguous())
    kup, kdn = kb[:, -1:].contiguous(), kb[:, :1].contiguous()
    modes.update({
        "graph clock_int8_phase 1000^2 x 1 q=6": lambda: c8p.metropolis_phase(
            ta, tb, key, color=0, q=6, beta=1 / KBT_CLOCK),
        "graph clock_int8_shard_measuring": lambda: c8p.sharded_phase(
            kb, ka, kup, kdn, key, (0, 1000, 500), color=1, q=5,
            beta=1 / KBT_CLOCK, measuring=True, **khalo),
        "graph clock_int8_shard": lambda: c8p.sharded_phase(
            ka, kb, kup, kdn, key, (0, 1000, 500), color=0, q=5,
            beta=1 / KBT_CLOCK, **khalo),
    })
    modes.update(helical_clock_modes(gen, dev, seeds))
    # row 23, the int8 clock measure, at the streamed class's launch and,
    # graph-timed, at the samples class's
    ma, mb = states((1, 1000, 500), 6), states((1, 1000, 500), 6)
    modes.update({
        "clock_int8_measure 2000^2 x 16 q=5": lambda: c8m.measure_sums(
            sa, sb, 5),
        "graph clock_int8_measure 1000^2 x 1 q=6": lambda: c8m.measure_sums(
            ma, mb, 6),
    })
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
    ap.add_argument("--helical", action="store_true",
                    help="time the helical 2-D multisweep instead")
    ap.add_argument("--helical3d", action="store_true",
                    help="time the helical 3-D phase kernel instead")
    ap.add_argument("--masked", action="store_true",
                    help="time the masked helical Ising multisweep instead")
    ap.add_argument("--clock-variants", action="store_true",
                    help="time rows 20-21 and 18-19 on variant builds "
                    "instead")
    ap.add_argument("--samples", action="store_true",
                    help="time the samples classes' one-replica int8 "
                    "kernels instead, also as CUDA graphs")
    ap.add_argument("--ms-grids", action="store_true",
                    help="time the 2-D multisweep's grid choices instead")
    ap.add_argument("--key-variants", action="store_true",
                    help="time rows 26 and 31 as the launch alone and with "
                    "their round keys in registers instead")
    ap.add_argument("--measure-variants", action="store_true",
                    help="time the int8 measure kernel's builds instead")
    ap.add_argument("--phase-variants", action="store_true",
                    help="time rows 24-25 at other tile sizes instead")
    ap.add_argument("--dat", metavar="DIR", default=None,
                    help="run the int8 2-D classes into DIR/*.dat instead")
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
    if args.dat:
        print(json.dumps(int8_class_dat(Path(args.dat))))
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
    elif args.clock_variants:
        modes, libs = clock_variant_modes(gen, dev, seeds), [
            "clock_pallas", "clock_helical_multispin"]
    elif args.helical:
        modes, libs = helical_modes(words, dev), ["helical_multispin"]
    elif args.helical3d:
        modes, libs = helical3d_modes(words), ["helical3d_multispin"]
    elif args.masked:
        modes, libs = masked_modes(spins, gen, dev), ["helical_pallas"]
    elif args.ms_grids:
        modes, libs = ms_grid_modes(words, msb, seeds, b2), [
            "ising2d_multispin"]
    elif args.key_variants:
        modes, libs = key_variant_modes(spins, gen, dev, seeds), [
            "ising2d_multisweep", "helical_pallas"]
    elif args.measure_variants:
        modes, libs = measure_variant_modes(spins, dev), [
            "ising2d_measure_pallas"]
    elif args.phase_variants:
        modes, libs = phase_variant_modes(spins, dev, phase_key), [
            "ising2d_pallas"]
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
    if not (args.clock or args.helical or args.helical3d or args.masked
            or args.samples or args.ms_grids or args.measure_variants
            or args.key_variants or args.clock_variants
            or args.phase_variants):
        # the grid of the tiles at 1000^2 x 16 (a tree before them: one
        # grid for every shape)
        times["int8_multisweep_blocks"] = (
            i8ms.grid_blocks(16, 1000, 500) if hasattr(i8ms, "ms_tiles")
            else i8ms.grid_blocks())
        times["packed_3d_multisweep_blocks"] = ms3.multisweep_grid_blocks()
        times["packed_2d_multisweep_blocks"] = msb.multisweep_grid_blocks()
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
    if args.helical:
        sass_report("helical_multispin", ("multisweep_kernel",))
    elif args.helical3d:
        sass_report("helical3d_multispin", ("phase_kernel",
                                            "energy_kernel",
                                            "multisweep_kernel"))
    elif args.masked:
        sass_report("helical_pallas", ("ising_multisweep_kernel",
                                       "clock_multisweep_kernel"))
    elif args.clock:
        sass_report("clock_planes", ("phase_kernel",))
        sass_report("clock_multisweep", ("multisweep_kernel",))
        sass_report("clock_pallas", ("phase_kernel",))
        sass_report("clock_helical_multispin", ("multisweep_kernel",))
        sass_report("clock_measure_pallas", ("measure_kernel",))
    elif not (args.samples or args.ms_grids or args.measure_variants
              or args.key_variants or args.clock_variants
              or args.phase_variants):
        sass_report("ising3d_multispin", ("phase_kernel",
                                          "multisweep_kernel"))
        sass_report("ising3d_pallas", ("tile_kernel",))
        sass_report("ising2d_pallas", ("phase_kernel",))
        sass_report("ising2d_multispin", ("phase_kernel",
                                          "multisweep_kernel"))
        sass_report("ising2d_measure_pallas", ("measure_kernel",))
        sass_report("ising2d_multisweep", ("multisweep_kernel",))
    print(json.dumps(times))
    return 0


def ising_modes(spins, words, msb, i8ms, i2p, ms3, i3p, seeds, phase_key,
                b2, b3):
    """The Ising kernels at the smoke's launch shapes, on random states."""
    from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
        ising2d_measure_pallas as i8m,
    )

    ra, rb = spins((16, 1000, 500)), spins((16, 1000, 500))
    sa, sb = spins((8, 4000, 2000)), spins((8, 4000, 2000))
    va, vb = spins((2, 500, 500, 250)), spins((2, 500, 500, 250))
    # the mesh int8 2-D class's shard of 4000^2 x 8 on (1,2,2), its halo
    # rows and columns
    ja, jb = spins((8, 2000, 1000)), spins((8, 2000, 1000))
    jup, jdn = spins((8, 1, 1000)), spins((8, 1, 1000))
    jlf, jrt = spins((8, 2000, 1)), spins((8, 2000, 1))
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
    # the 2-D resident class's planes, 2048^2 x 16
    pa, pb = words((16, 64, 1024)), words((16, 64, 1024))
    # the mesh packed 2-D class's shard of 8192^2 x 4 on (1,4) and its halo
    # bit rows
    qa, qb = words((4, 64, 4096)), words((4, 64, 4096))
    qup, qdn = ((words((4, 1, 4096)) & 1).contiguous() for _ in range(2))
    return {
        "int8_multisweep": lambda: i8ms.multisweep_planes(ra, rb, seeds,
                                                          beta=b2),
        "int8_multisweep S=40": lambda: i8ms.multisweep_planes(
            ra, rb, seeds[:40], beta=b2),
        "int8_phase": lambda: i2p.metropolis_phase(sa, sb, phase_key,
                                                   color=0, beta=b2),
        "graph int8_shard_measuring": lambda: i2p.sharded_phase(
            jb, ja, jup, jdn, phase_key, (0, 2000, 1000), color=1, beta=b2,
            halo_lf=jlf, halo_rt=jrt, measuring=True),
        "graph int8_shard": lambda: i2p.sharded_phase(
            ja, jb, jup, jdn, phase_key, (0, 2000, 1000), color=0, beta=b2,
            halo_lf=jlf, halo_rt=jrt),
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
        "packed_multisweep": lambda: msb.multisweep_planes(pa, pb, seeds,
                                                           beta=b2),
        "packed_multisweep S=40": lambda: msb.multisweep_planes(
            pa, pb, seeds[:40], beta=b2),
        "graph packed_shard_measuring": lambda: msb.sharded_phase_packed(
            qb, qa, qup, qdn, phase_key, (0, 64), color=1, beta=b2,
            measuring=True),
        "graph packed_shard": lambda: msb.sharded_phase_packed(
            qa, qb, qup, qdn, phase_key, (0, 64), color=0, beta=b2),
        "int8_measure_3d": lambda: i8m.measure_sums(va, vb),
        "int8_measure_2d": lambda: i8m.measure_sums(sa, sb),
    }


if __name__ == "__main__":
    sys.exit(main())
