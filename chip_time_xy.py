"""CUDA-event times of the periodic XY relaxation's phase kernels at the
over-relaxation class's launch shape, 4000x4000 x 8 (one colour, 8 x 4000
x 2000 float32 sites): metropolis_kernel and over_relax_kernel, each
without and with the fused float64 sums, on a random state, and the
resident disorder multisweep (xy2d_resident.cu, which shares
csrc/xy2d_site.cuh) at the from-disorder class's 1500x1500 x 1, S = 64,
against a snapshot; with
``--helical``, the four dense helical XY kernels at the helical classes'
launch, 10001x10000 x 1 (component and angle planes, Metropolis and OR,
colour a plain and colour b measuring); with ``--periodic-angle``, the
periodic engines' A/B: the component kernels (metropolis_kernel,
over_relax_kernel) and the f32-angle ones (angle_metro_kernel,
angle_or_kernel), colour a plain and colour b measuring, at the
Metropolis classes' launches 2000x2000 x 32 and 10000x10000 x 1, the
angle snapshot mode at the finite-magne class's 1000x1000 x 20, and
reduce_kernel alone (xy2d_site.cuh, built into a probe library) on the
partials of one measuring angle launch at both Metropolis shapes, timed
as a CUDA graph (chip_time_ising.graph_ms), angle_or_kernel also at the
over-relaxation class's 4000x4000 x 8, with the SASS of
angle_metro_kernel, its snapshot mode's kernel and angle_or_kernel; with
``--resident``, the resident disorder multisweep's two modes at every
launch the disorder classes make (1500x1500 x 1, S = 64 and 40;
1000x1000 x 1, S = 64 and 36; the device-memory mode forced there too)
and past the shared-memory fit (1500x1500 x 2 and x 3, S = 64 and 8),
each also in a measurement build of csrc/xy2d_resident.cu with the site
updates compiled out (-DXY_RESIDENT_NO_SITES: the ring waits, the loads
and stores and the sums left), and the device-memory mode's variant
builds (GMEM_VARIANTS: two blocks of 512 threads an SM, no chunk held
in shared memory, the snapshot through the read-only cache, a site's own
device-memory read through L2) past the fit at S = 64, each held
bitwise against the library, with the SASS of both kernels; with
``--routes``, the XY disorder runner's two routes
(chip_smoke.compare_xy_routes) at chip_smoke.XY_ROUTE_SHAPES, --rounds
times; with ``--int16``, the int16 multisweep (csrc/xy2d_multisweep.cu)
at the int16 class's launches, 1536x1536 x 1 with S = 64 and 40, and
S = 16 with one over-relaxation sweep, in the mode its wrapper routes
them to, its device-memory mode forced at S = 64, and past the
shared-memory fit at 1536x1536 x 2 and x 3 (S = 64 and 8; x 2 also S =
16 with an OR sweep), x 32 and 64x64 x 1600, there also the
shared-memory mode on slices of the batch one launch after another, and
the device-memory mode's variant builds (INT16_GMEM_VARIANTS: no decoded
plane, the snapshot read evict-first) at x 2 and x 3, S = 64, each held
bitwise against the library, with the SASS of its kernels (a tenth of
--reps a mode); copied into the parent's checkout it times the parent's
grid-barrier mode under the same labels; with ``--masked``, the masked
helical XY kernels (csrc/helical_pallas.cu) at their classes' launches,
10001x10000 x 1 and 4001x4001 x 2: xy_phase_kernel's four modes (a
phase, colour 0; the fused phase, colour 1, at even N; the measure mode;
the over-relaxation phase, colour 0), each out of place into spare
planes, the over-relaxation also at 10001x10000 x 1 on planes one float
past the 16-B grid (vectors from off0 = 1) and with its output planes at
another offset than its input (every float alone), with the SASS of the
kernel's modes; with ``--or-variants``, angle_or_kernel plain and
measuring at 4000x4000 x 8 and 10000x10000 x 1 on its library and on
builds held to 4 and 5 blocks an SM (``__launch_bounds__``, built into
.build/variants/), each held bitwise against the library.

    python3 chip_time_xy.py [--reps 200] [--rounds 3] [--helical]
                            [--periodic-angle] [--resident] [--routes]
                            [--int16] [--masked] [--or-variants]

Run it from the root of a checkout; it needs one NVIDIA GPU and builds
csrc/xy2d_pallas.cu (csrc/xy2d_helical_dense*.cu,
csrc/xy2d_pallas_angle.cu) on first use.  It uses only the phase wrappers'
public API, so to compare two commits copy it into both checkouts and run
it from each in turns on one card (A, B, B, A).  Prints the card's
nvidia-smi name and power limit, the ptxas register report of the build,
with ``--helical`` the SASS of the helical kernels (chip_time_ising.
sass_report), and last one JSON line {mode: [ms a launch, one per
round]}.
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
HX, HY = 10001, 10000
KBT = 0.89


def helical_modes(dev, gen, key, beta):
    """The eight helical XY modes on one random 10001x10000 state."""
    from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
        trig,
        xy2d_helical_dense as xhd,
        xy2d_helical_dense_angle as xha,
    )
    turns = torch.rand((1, HX * HY), generator=gen, device=dev) - 0.5
    a, b = xhd.dense_pack(turns, HY, HX)
    ax, ay, bx, by = (c.contiguous() for p in (a, b)
                      for c in trig.cos_sin_2pi(p))
    return {
        "component_phase": lambda: xhd.phase(ax, ay, bx, by, key, color=0,
                                             beta=beta),
        "component_phase_measuring": lambda: xhd.phase(
            bx, by, ax, ay, key, color=1, beta=beta, measuring=True),
        "component_or": lambda: xhd.or_phase(ax, ay, bx, by, color=0),
        "component_or_measuring": lambda: xhd.or_phase(
            bx, by, ax, ay, color=1, measuring=True),
        "angle_phase": lambda: xha.angle_phase(a, b, key, color=0,
                                               beta=beta),
        "angle_phase_measuring": lambda: xha.angle_phase(
            b, a, key, color=1, beta=beta, measuring=True),
        "angle_or": lambda: xha.angle_or_phase(a, b, color=0),
        "angle_or_measuring": lambda: xha.angle_or_phase(
            b, a, color=1, measuring=True),
    }


# the --resident variants: tag -> the nvcc defines of its build
RESIDENT_BUILDS = {"": [], "nosites": ["-DXY_RESIDENT_NO_SITES"]}


def resident_builds():
    """The RESIDENT_BUILDS of csrc/xy2d_resident.cu, compiled together
    into .build/libxy2d_resident[_tag].so (ptxas report beside each),
    each bound as ops/xy2d_resident binds its library."""
    import ctypes
    import os
    from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
        _build,
        xy2d_resident as xyr,
    )
    _build.BUILD_DIR.mkdir(exist_ok=True)
    procs = {}
    for tag, defines in RESIDENT_BUILDS.items():
        out = _build.library_path("xy2d_resident" + (f"_{tag}" if tag
                                                      else ""))
        cmd = _build.build_command("xy2d_resident", out) + defines
        procs[tag] = (out, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True))
    libs = {}
    for tag, (out, proc) in procs.items():
        log = proc.communicate(timeout=_build.BUILD_TIMEOUT_S)[0]
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc xy2d_resident {tag}: {log}")
        libs[tag] = xyr.bind(ctypes.CDLL(os.fspath(out)))
    return libs


# the --resident variants of gmem_multisweep_kernel, built from its
# source with one text replaced (chip_time_ising.variant_lib): tag ->
# (old, new)
_SNAP = ("__ldcs(a.sbx + base + w), __ldcs(a.sby + base + w),\n"
         "                          __ldcs(a.sax + base + w), "
         "__ldcs(a.say + base + w)")
GMEM_VARIANTS = {
    # two blocks of 512 threads an SM, rings twice as long
    "g2": ("constexpr int GMEM_GROUPS = GROUPS;",
           "constexpr int GMEM_GROUPS = 2;"),
    # no chunk held in shared memory: every site in device memory
    "nohold": ("min(ring.hold, max(room, 0))", "min(0, max(room, 0))"),
    # the snapshot read through the read-only cache (not evict-first)
    "ldg": (_SNAP, _SNAP.replace("__ldcs", "__ldg")),
    # a site's own device-memory read through L2 too
    "owncg": ("mine ? sh[w - sa] : make_float2(sx[w], sy[w]);",
              "mine ? sh[w - sa] : make_float2(__ldcg(sx + w), "
              "__ldcg(sy + w));"),
}
# (n, replicas, S) of the disorder classes' launches and past the fit
RESIDENT_RUNS = ((1500, 1, 64), (1500, 1, 40), (1000, 1, 64), (1000, 1, 36),
                 (1500, 2, 64), (1500, 2, 8), (1500, 3, 64), (1500, 3, 8))


def gmem_variant_libs(base):
    """GMEM_VARIANTS built into .build/variants/ and bound as the
    library."""
    from chip_time_ising import variant_lib
    from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
        xy2d_resident as xyr,
    )
    return {tag: xyr.bind(variant_lib("xy2d_resident", old, new, tag, base,
                                      ()))
            for tag, (old, new) in GMEM_VARIANTS.items()}


def resident_modes(dev, gen, key, beta):
    """Both modes of the resident multisweep at RESIDENT_RUNS: the fit
    rule's mode, and where the shared-memory mode fits also the
    device-memory (grid-barrier, in a tree before it) mode forced, in each
    build of :func:`resident_builds`; where the checkout has the
    device-memory ring mode, also its GMEM_VARIANTS at 1500x1500 x 2 and
    x 3, S = 64, each launch's state and sums held bitwise against the
    library's.  A random state and snapshot a shape."""
    from cuda_fortran_mc_simulation_spin_tpu_torch.models.xy2d import XYState
    from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
        multispin_rng,
        xy2d_resident as xyr,
    )
    libs = resident_builds()
    if hasattr(xyr, "gmem_layout"):
        libs.update(gmem_variant_libs(libs[""]))
    seeds = multispin_rng.sweep_phase_keys(key, 64).to(dev)
    states = {}
    for n, nrep in {(n, nrep) for n, nrep, _ in RESIDENT_RUNS}:
        th = torch.rand((4, nrep, n, n // 2), generator=gen,
                        device=dev) * 6.2832
        states[n, nrep] = tuple(XYState(torch.cos(th[i]), torch.sin(th[i]),
                                        torch.cos(th[i + 1]),
                                        torch.sin(th[i + 1]))
                                for i in (0, 2))

    def run(lib, st, snap, sweeps, grid):
        xyr._lib = lambda: lib
        return xyr.multisweep_planes(st, snap, seeds[:sweeps], beta=beta,
                                     grid=grid)

    def check(lib, tag, st, snap):
        a = XYState(*(p.clone() for p in st))
        b = XYState(*(p.clone() for p in st))
        want = run(libs[""], a, snap, 8, False).clone()
        got = run(lib, b, snap, 8, False)
        if not (all(torch.equal(p, q) for p, q in zip(a, b))
                and torch.equal(got, want)):
            raise RuntimeError(f"variant {tag} differs from the library")

    modes = {}
    for tag, lib in libs.items():
        name = f" [{tag}]" if tag else ""
        for n, nrep, sweeps in RESIDENT_RUNS:
            st, snap = states[n, nrep]
            xyr._lib = lambda lib=lib: lib
            fits = xyr.device_layout(st) is not None
            if tag in GMEM_VARIANTS:
                if fits or sweeps != 64:
                    continue
                check(lib, tag, st, snap)
            label = f"{n}^2 x {nrep} S={sweeps}{name}"
            for grid in (False, True) if fits else (False,):
                modes[f"{'forced ' if grid else ''}{label}"] = (
                    lambda lib=lib, st=st, snap=snap, sweeps=sweeps,
                    grid=grid: run(lib, st, snap, sweeps, grid))
    return modes


# the int16 class's lattice (1536x1536: JAX's gate takes ny % 16 == 0)
INT16_N = 1536
# the --int16 variants of gmem_multisweep_kernel, built from its source
# with one text replaced (chip_time_ising.variant_lib): tag -> (old, new)
INT16_GMEM_VARIANTS = {
    # held int16 only: no decoded plane, every other-colour read decoded
    # per read
    "nodec": ("const int dq = min(rg.dec, qb - qa);", "const int dq = 0;"),
    # the snapshot read evict-first (not through the read-only cache)
    "ldcs": ("__ldg(a.sa + base + w), __ldg(a.sb + base + w)",
             "__ldcs(a.sa + base + w), __ldcs(a.sb + base + w)"),
}
# (label, replicas, n, S, n_or, forced): the int16 class's launches in the
# shared-memory mode (1536^2 x 1, S = 64 and 40, and S = 16 with an OR
# sweep), the device-memory mode forced at 1536^2 x 1, S = 64, and past
# the fit (1536^2 x 2 and x 3, S = 64 and 8; x 2, S = 16 with an OR
# sweep; x 32, past one ring a replica: turns on two rings; 64^2 x 1600,
# more replicas than block slots)
INT16_RUNS = (("1536^2 x 1 S=64", 1, INT16_N, 64, 0, False),
              ("1536^2 x 1 S=40", 1, INT16_N, 40, 0, False),
              ("1536^2 x 1 S=16 n_or=1", 1, INT16_N, 16, 1, False),
              ("grid 1536^2 x 1 S=64", 1, INT16_N, 64, 0, True),
              ("1536^2 x 2 S=64", 2, INT16_N, 64, 0, False),
              ("1536^2 x 2 S=8", 2, INT16_N, 8, 0, False),
              ("1536^2 x 2 S=16 n_or=1", 2, INT16_N, 16, 1, False),
              ("1536^2 x 3 S=64", 3, INT16_N, 64, 0, False),
              ("1536^2 x 3 S=8", 3, INT16_N, 8, 0, False),
              ("1536^2 x 32 S=64", 32, INT16_N, 64, 0, False),
              ("64^2 x 1600 S=64", 1600, 64, 64, 0, False))


def int16_modes(dev, gen, key, beta):
    """The int16 multisweep (csrc/xy2d_multisweep.cu) at INT16_RUNS, in
    the mode the wrapper routes each to, the device-memory mode (the
    grid-barrier mode in a tree before it) forced where the wrapper has
    that switch; where the checkout has the device-memory ring mode, also
    its INT16_GMEM_VARIANTS at 1536^2 x 2 and x 3, S = 64, each launch's
    state and sums held bitwise against the library's.  Past the fit, at
    S = 64 and at x 2, S = 8, also the shared-memory mode launched on
    slices of the batch, the most replicas it fits a launch, one launch
    after another (its Philox counter restarts at each slice's first
    replica, so only its time compares).  Random int16 state and snapshot
    planes a shape."""
    import inspect
    from chip_time_ising import variant_lib
    from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
        multispin_rng,
        xy2d_multisweep as xyi,
    )
    seeds = multispin_rng.sweep_phase_keys(key, 64)
    forced = "grid" in inspect.signature(xyi.multisweep_planes).parameters
    libs = {"": xyi._lib()}
    if hasattr(xyi, "gmem_layout"):
        for tag, (old, new) in INT16_GMEM_VARIANTS.items():
            libs[tag] = xyi.bind(variant_lib("xy2d_multisweep", old, new,
                                             f"int16_{tag}", libs[""], ()))
    planes = {}
    for _, nrep, n, _, _, _ in INT16_RUNS:
        planes.setdefault((nrep, n), [
            torch.randint(-2 ** 15, 2 ** 15, (nrep, n, n // 2),
                          generator=gen, device=dev,
                          dtype=torch.int32).to(torch.int16)
            for _ in range(4)])

    own = xyi._lib

    def run(lib, pl, sweeps, n_or, grid):
        xyi._lib = lambda: lib
        try:
            kw = dict(beta=beta, n_or=n_or,
                      **({"grid": True} if grid else {}))
            return xyi.multisweep_planes(*pl, seeds[:sweeps], **kw)
        finally:
            xyi._lib = own

    def slices(pl, k, sweeps, n_or):
        for r0 in range(0, pl[0].shape[0], k):
            xyi.multisweep_planes(*(p[r0:r0 + k] for p in pl),
                                  seeds[:sweeps], beta=beta, n_or=n_or)

    limits = xyi.smem_limits(dev)

    def slice_size(nrep, n):
        """The most replicas of n x n the shared-memory mode fits, or
        None where it fits them all."""
        if xyi.smem_layout(nrep, n, n // 2, *limits) is not None:
            return None
        return max(k for k in range(1, nrep)
                   if xyi.smem_layout(k, n, n // 2, *limits) is not None)

    def check(lib, tag, pl):
        a, b = [p.clone() for p in pl[:2]], [p.clone() for p in pl[:2]]
        want = run(libs[""], a + pl[2:], 8, 0, False).clone()
        got = run(lib, b + pl[2:], 8, 0, False)
        if not (all(torch.equal(p, q) for p, q in zip(a, b))
                and torch.equal(got, want)):
            raise RuntimeError(f"variant {tag} differs from the library")

    modes = {}
    for tag, lib in libs.items():
        for label, nrep, n, sweeps, n_or, grid in INT16_RUNS:
            if grid and not forced:
                continue
            pl = planes[nrep, n]
            if tag:
                if nrep not in (2, 3) or sweeps != 64 or n_or:
                    continue
                check(lib, tag, pl)
            modes[f"int16 {label}{f' [{tag}]' if tag else ''}"] = (
                lambda lib=lib, pl=pl, sweeps=sweeps, n_or=n_or, grid=grid:
                run(lib, pl, sweeps, n_or, grid))
            k = None if tag or grid or n_or else slice_size(nrep, n)
            if k is not None and (sweeps == 64 or nrep == 2):
                modes[f"int16 {label} [slices of {k}]"] = (
                    lambda pl=pl, k=k, sweeps=sweeps, n_or=n_or:
                    slices(pl, k, sweeps, n_or))
    return modes


# the masked helical XY classes' launches (R, ny, nx)
MASKED_SHAPES = ((1, HY, HX), (2, 4001, 4001))


def masked_modes(dev, gen, key, beta):
    """The masked XY kernels at MASKED_SHAPES on random planes."""
    from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
        helical_pallas as hp,
        multispin_rng,
    )
    seeds = multispin_rng.sweep_phase_keys(key, 1)[0]
    modes = {}
    for nrep, ny, nx in MASKED_SHAPES:
        th = torch.rand((nrep, ny * nx), generator=gen, device=dev) * 6.2832
        sx, sy = torch.cos(th), torch.sin(th)
        out = (torch.empty_like(sx), torch.empty_like(sy))
        tag = f"{ny}x{nx} x {nrep}"
        modes[f"masked_phase {tag}"] = (
            lambda sx=sx, sy=sy, out=out, nx=nx: hp.xy_phase(
                sx, sy, seeds[0], color=0, nx=nx, beta=beta, out=out))
        if ny * nx % 2 == 0:
            modes[f"masked_phase_fused {tag}"] = (
                lambda sx=sx, sy=sy, out=out, nx=nx: hp.xy_phase(
                    sx, sy, seeds[1], color=1, nx=nx, beta=beta,
                    measuring=True, out=out))
        modes[f"masked_measure {tag}"] = (
            lambda sx=sx, sy=sy, nx=nx: hp.xy_measure(sx, sy, nx=nx))
        modes[f"masked_or {tag}"] = (
            lambda sx=sx, sy=sy, out=out, nx=nx: hp.xy_or_phase(
                sx, sy, color=0, nx=nx, out=out))
    # the over-relaxation off the 16-B grid at 10001x10000 x 1: every
    # plane one float past it, then the outputs back on it
    nrep, ny, nx = MASKED_SHAPES[0]
    n = ny * nx
    off = [torch.empty(n + 1, device=dev)[1:].view(nrep, n)
           for _ in range(4)]
    th = torch.rand((nrep, n), generator=gen, device=dev) * 6.2832
    off[0].copy_(torch.cos(th))
    off[1].copy_(torch.sin(th))
    out = (torch.empty_like(th), torch.empty_like(th))
    tag = f"{ny}x{nx} x {nrep}"
    modes[f"masked_or off-grid {tag}"] = lambda: hp.xy_or_phase(
        off[0], off[1], color=0, nx=nx, out=(off[2], off[3]))
    modes[f"masked_or mixed offsets {tag}"] = lambda: hp.xy_or_phase(
        off[0], off[1], color=0, nx=nx, out=out)
    return modes


# the periodic A/B's launches (R, ny, nx)
ANGLE_SHAPES = ((32, 2000, 2000), (1, 10000, 10000))
# the angle over-relaxation class's launch (R, ny, nx), timed beside them
OR_SHAPE = (8, 4000, 4000)
# the angle snapshot mode's launch (R, ny, nx): the finite-magne class
SNAP_SHAPE = (20, 1000, 1000)

_REDUCE_PROBE = """#include "xy2d_site.cuh"
extern "C" int xy_reduce3(const void* part, void* obs, int nrep, int nblk,
                          void* stream) {
  xy::reduce_kernel<3><<<nrep, xy::THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(part), static_cast<double*>(obs), nblk);
  return static_cast<int>(cudaGetLastError());
}
"""


def reduce_probe():
    """``xy_reduce3(partials, obs, nrep, nblk, stream)``: xy2d_site.cuh's
    reduce_kernel<3> alone, compiled from a probe source in .build/."""
    import ctypes
    from cuda_fortran_mc_simulation_spin_tpu_torch.ops import _build
    _build.BUILD_DIR.mkdir(exist_ok=True)
    src = _build.BUILD_DIR / "xy_reduce_probe.cu"
    src.write_text(_REDUCE_PROBE)
    out = _build.library_path("xy_reduce_probe")
    cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
           str(out), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          timeout=_build.BUILD_TIMEOUT_S)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc xy_reduce_probe: {proc.stderr}")
    fn = ctypes.CDLL(str(out)).xy_reduce3
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def metro_blocks(xya, ny: int, half: int) -> int:
    """Blocks a replica of one measuring angle Metropolis launch, so the
    partials it leaves: the wrapper's tile grid where the checkout's
    module has one, else one block a 256 sites (one thread a site)."""
    if hasattr(xya, "metro_blocks"):
        return xya.metro_blocks(ny, half)
    return -(-ny * half // 256)


def periodic_angle_modes(dev, gen, key, beta):
    """Both periodic engines' four modes at each of ANGLE_SHAPES, on one
    random state a shape (the angle planes and their decoded components)."""
    from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
        trig,
        xy2d_pallas as xyp,
        xy2d_pallas_angle as xya,
    )
    modes = {}
    for nrep, ny, nx in ANGLE_SHAPES:
        a, b = (torch.rand((nrep, ny, nx // 2), generator=gen, device=dev)
                - 0.5 for _ in range(2))
        ax, ay, bx, by = (c for p in (a, b) for c in trig.cos_sin_2pi(p))
        tag = f"{ny}x{nx}x{nrep}"
        modes.update({
            f"component_metropolis {tag}": lambda ax=ax, ay=ay, bx=bx,
            by=by: xyp.metropolis_phase(ax, ay, bx, by, key, color=0,
                                        beta=beta),
            f"component_metropolis_measuring {tag}": lambda ax=ax, ay=ay,
            bx=bx, by=by: xyp.metropolis_phase(bx, by, ax, ay, key,
                                               color=1, beta=beta,
                                               measuring=True),
            f"component_or {tag}": lambda ax=ax, ay=ay, bx=bx, by=by:
            xyp.over_relax_phase(ax, ay, bx, by, color=0),
            f"component_or_measuring {tag}": lambda ax=ax, ay=ay, bx=bx,
            by=by: xyp.over_relax_phase(bx, by, ax, ay, color=1,
                                        measuring=True),
            f"angle_metropolis {tag}": lambda a=a, b=b: xya.metro_phase(
                a, b, key, color=0, beta=beta),
            f"angle_metropolis_measuring {tag}": lambda a=a, b=b:
            xya.metro_phase(b, a, key, color=1, beta=beta, measuring=True),
            f"angle_or {tag}": lambda a=a, b=b: xya.or_phase(a, b, color=0),
            f"angle_or_measuring {tag}": lambda a=a, b=b: xya.or_phase(
                b, a, color=1, measuring=True),
        })
    reduce3 = reduce_probe()
    for nrep, ny, nx in ANGLE_SHAPES:
        nblk = metro_blocks(xya, ny, nx // 2)
        part = torch.rand((nrep, nblk, 3), generator=gen, device=dev,
                          dtype=torch.float64)
        obs = torch.empty((nrep, 3), dtype=torch.float64, device=dev)

        def reduce(part=part, obs=obs, nrep=nrep, nblk=nblk):
            code = reduce3(part.data_ptr(), obs.data_ptr(), nrep, nblk,
                           torch.cuda.current_stream().cuda_stream)
            if code:
                raise RuntimeError(f"xy_reduce3: CUDA error {code}")
        modes[f"graph reduce_kernel {ny}x{nx}x{nrep} ({nblk} blocks)"] = \
            reduce
    nrep, ny, nx = SNAP_SHAPE
    a, b, sa, sb = (torch.rand((nrep, ny, nx // 2), generator=gen,
                               device=dev) - 0.5 for _ in range(4))
    modes[f"angle_snapshot {ny}x{nx}x{nrep}"] = lambda: xya.metro_phase(
        b, a, key, color=1, beta=beta, snap=(sb, sa))
    nrep, ny, nx = OR_SHAPE
    c, d = (torch.rand((nrep, ny, nx // 2), generator=gen, device=dev)
            - 0.5 for _ in range(2))
    tag = f"{ny}x{nx}x{nrep}"
    modes[f"angle_or {tag}"] = lambda: xya.or_phase(c, d, color=0)
    modes[f"angle_or_measuring {tag}"] = lambda: xya.or_phase(
        d, c, color=1, measuring=True)
    return modes


def or_variant_modes(dev, gen):
    """angle_or_kernel (row 40), plain and measuring, at the OR class's
    4000x4000 x 8 and at 10000x10000 x 1, on the library and on builds of
    its source with the kernel held to 4 and 5 blocks an SM
    (__launch_bounds__(256, k): at most 64 and 48 registers; built into
    .build/variants/), each launch's state and sums held bitwise against
    the library's (``--or-variants``)."""
    from chip_time_ising import variant_lib
    from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
        ising2d_multispin as msb,
        xy2d_helical_dense_angle as xha,
        xy2d_pallas_angle as xya,
    )
    base = xya._lib()
    old = "__launch_bounds__(THREADS)\n    angle_or_kernel"
    libs = {"": base}
    for k in (4, 5):
        libs[f"mb{k} "] = variant_lib(
            "xy2d_pallas_angle", old,
            f"__launch_bounds__(THREADS, {k})\n    angle_or_kernel",
            f"or_mb{k}", base, ("xya_or",))
    modes = {}
    for nrep, ny, nx in (OR_SHAPE, (1, 10000, 10000)):
        half = nx // 2
        a, b = (torch.rand((nrep, ny, half), generator=gen, device=dev)
                - 0.5 for _ in range(2))
        gy = xha.tile_grid(ny, half)[1]
        part = torch.empty((nrep, xya.metro_blocks(ny, half), 3),
                           dtype=torch.float64, device=dev)
        obs = torch.empty((nrep, 3), dtype=torch.float64, device=dev)
        want = {}
        for measuring in (False, True):
            ref = a.clone()
            got = xya.or_phase(ref, b, color=1, measuring=measuring)
            want[measuring] = (ref, got[1].clone() if measuring else None)
        for tag, lib in libs.items():
            for measuring in (False, True):
                def run(lib=lib, s=a.clone(), measuring=measuring,
                        b=b, nrep=nrep, ny=ny, half=half, gy=gy,
                        part=part, obs=obs, tag=tag):
                    code = lib.xya_or(
                        s.data_ptr(), b.data_ptr(),
                        part.data_ptr() if measuring else None,
                        obs.data_ptr() if measuring else None, nrep, ny,
                        half, gy, 1, msb._stream(s))
                    if code:
                        raise RuntimeError(f"xya_or {tag}: CUDA error {code}")
                    return s
                s = run(s=a.clone())
                ref, sums = want[measuring]
                if not torch.equal(s, ref) or (
                        measuring and not torch.equal(obs, sums)):
                    raise RuntimeError(f"variant {tag} differs at {ny}^2")
                label = "measuring " if measuring else ""
                modes[f"{tag}angle_or {label}{ny}x{nx}x{nrep}"] = run
    return modes


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--helical", action="store_true",
                    help="time the helical XY kernels instead")
    ap.add_argument("--periodic-angle", action="store_true",
                    help="time the periodic component and angle kernels "
                    "at 2000x2000 x 32 and 10000x10000 x 1 instead")
    ap.add_argument("--resident", action="store_true",
                    help="time the resident multisweep's two modes and "
                    "their measurement builds instead")
    ap.add_argument("--routes", action="store_true",
                    help="read the XY disorder routes at chip_smoke's "
                    "XY_ROUTE_SHAPES, --rounds times, instead")
    ap.add_argument("--int16", action="store_true",
                    help="time the int16 multisweep's modes instead")
    ap.add_argument("--masked", action="store_true",
                    help="time the masked helical XY kernels instead")
    ap.add_argument("--or-variants", action="store_true",
                    help="time the angle OR kernel's builds instead")
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
    key = torch.tensor([12345, 678], dtype=torch.int64)
    beta = 1.0 / KBT
    if args.periodic_angle:
        return report(periodic_angle_modes(dev, gen, key, beta), args,
                      ["xy2d_pallas", "xy2d_pallas_angle"],
                      sass=("angle_metro_kernel", "angle_metro_snap_kernel",
                            "angle_or_kernel"))
    if args.or_variants:
        return report(or_variant_modes(dev, gen), args,
                      ["xy2d_pallas_angle"], sass=("angle_or_kernel",))
    if args.masked:
        return report(masked_modes(dev, gen, key, beta), args,
                      ["helical_pallas"],
                      sass=("xy_phase_kernel",))
    if args.int16:
        return report(int16_modes(dev, gen, key, beta), dict(
            vars(args), reps=max(1, args.reps // 10)), ["xy2d_multisweep"],
            sass=("multisweep_kernel",))
    if args.routes:
        return route_readings(dev, key, args.rounds)
    if args.resident:
        return report(resident_modes(dev, gen, key, beta), args,
                      [f"xy2d_resident{'_' + t if t else ''}"
                       for t in RESIDENT_BUILDS],
                      sass=("multisweep_kernel",))
    if args.helical:
        return report(helical_modes(dev, gen, key, beta), args,
                      ["xy2d_helical_dense", "xy2d_helical_dense_angle"],
                      sass=("phase_kernel", "or_kernel", "tile_kernel"))
    planes = []
    for _ in range(2):
        th = torch.rand((NREP, NY, HALF), generator=gen, device=dev) * 6.2832
        planes += [torch.cos(th), torch.sin(th)]
    ax, ay, bx, by = planes
    modes = {
        "metropolis": lambda: xyp.metropolis_phase(
            ax, ay, bx, by, key, color=0, beta=beta),
        "metropolis_measuring": lambda: xyp.metropolis_phase(
            bx, by, ax, ay, key, color=1, beta=beta, measuring=True),
        "over_relax": lambda: xyp.over_relax_phase(ax, ay, bx, by, color=0),
        "over_relax_measuring": lambda: xyp.over_relax_phase(
            bx, by, ax, ay, color=1, measuring=True),
    }
    from cuda_fortran_mc_simulation_spin_tpu_torch.models.xy2d import XYState
    from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
        multispin_rng,
        xy2d_resident as xyr,
    )
    th = torch.rand((4, 1, 1500, 750), generator=gen, device=dev) * 6.2832
    st = XYState(torch.cos(th[0]), torch.sin(th[0]), torch.cos(th[1]),
                 torch.sin(th[1]))
    snap = XYState(torch.cos(th[2]), torch.sin(th[2]), torch.cos(th[3]),
                   torch.sin(th[3]))
    seeds = multispin_rng.sweep_phase_keys(key, 64).to(dev)
    modes["resident_multisweep"] = lambda: xyr.multisweep_planes(
        st, snap, seeds, beta=beta)
    return report(modes, args, ["xy2d_pallas", "xy2d_resident"])


def route_readings(dev, key, rounds: int) -> int:
    """chip_smoke.compare_xy_routes (ms a sweep of one resident launch of
    64 sweeps against 64 streamed ones, at XY_ROUTE_SHAPES) ``rounds``
    times in turns: prints the card's line and one JSON line {"nx x
    replicas": [[resident, streamed] ms a sweep, one per round]}."""
    import chip_smoke
    from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
        multispin_rng,
        xy2d_pallas as xyp,
        xy2d_resident as xyr,
    )
    seeds = multispin_rng.sweep_phase_keys(key, 64)
    out = {}
    for _ in range(rounds):
        for nx, nrep, res, stream in chip_smoke.compare_xy_routes(
                xyp, xyr, dev, seeds):
            out.setdefault(f"{nx} x {nrep}", []).append([res, stream])
    print(chip_smoke.nvidia_smi_line())
    print(json.dumps(out))
    return 0


def report(modes, args, libs, sass=()) -> int:
    """Time every mode ``args.rounds`` times in turns; print the card's
    line, the libraries' ptxas report, the SASS report of their functions
    whose names hold one of ``sass``, and the JSON line of times."""
    from chip_time_ising import graph_ms
    if isinstance(args, dict):
        args = argparse.Namespace(**args)
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
    for lib in libs:
        log = ROOT / ".build" / f"lib{lib}.log"
        if log.exists():
            for line in log.read_text().splitlines():
                if ("Compiling entry" in line or "registers" in line
                        or "stack frame" in line):
                    print(line.strip())
    if sass:
        from chip_time_ising import sass_report
        for lib in libs:
            sass_report(lib, sass)
    print(json.dumps(times))
    return 0


if __name__ == "__main__":
    sys.exit(main())
