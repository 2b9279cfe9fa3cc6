"""Chip smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path, the 2-D Ising NER relaxation at Tc through
the CLI, on the card, and holds every kernel of that path against its
plain PyTorch version.  Phases (each prints a progress line on stderr):

1. build the CUDA sources (csrc/*.cu) from scratch with nvcc;
2. kernel = plain version, bitwise, at 1024^2 x 4 replicas and at the
   main path's shapes: the phase kernel with injected bits, with Philox
   bits and with the fused exact (m, e); the multisweep kernel over 64
   sweeps against 64 phase-kernel pairs and against its plain version;
   then <m>, <e> after one sweep from all-up over 2.7e10 sites against
   their exact values;
3. main path, resident class: 2048^2, 16 replicas, 64 samples, 1000 MCS
   through the multisweep kernel;
4. main path, streaming class: 8192^2, 4 replicas, 4 samples, 200 MCS
   through the measuring phase kernel;
   both checked against data/production/ising2d_1001x1000_mcs1000_s1440000.dat
   within 5 standard errors of the port's mean;
5. times with CUDA events, beside each kernel's bound and its plain
   version's time; then the runner's two routes (one multisweep launch
   per S sweeps, or S streamed phase pairs) at the main path's shapes
   and between them.

It prints the kernels' JSON line, the card's `nvidia-smi` name and power
limit, and last the device line.  It exits non-zero, printing no result,
without a card, and when any phase fails.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
REFERENCE_DAT = (ROOT / "data" / "production"
                 / "ising2d_1001x1000_mcs1000_s1440000.dat")
KBT = 2.26918531421
SIGMAS = 5.0
# H100 SXM peaks at 700 W.  HBM3 bytes/s: NVIDIA data sheet.  32-bit
# integer instructions/s: an assumption, the SMs' issue limit of 132 SMs
# x 4 schedulers x 32 lanes at 1.98 GHz (the clock implied by the data
# sheet's 67 TFLOP/s of FP32 = 132 x 128 lanes x 2 x 1.98 GHz).  The
# CUDA C++ Programming Guide's throughput table gives compute capability
# 9.0 only 64 integer add/logic/shift results per clock and SM, so the
# limit holds only if IMAD (on the FMA pipe) issues alongside LOP3 and
# IADD3 (on the ALU pipe); at 64 per clock every bound would double
PEAK_BYTES_S = 3.35e12
PEAK_INT32_OPS_S = 132 * 128 * 1.98e9
# minimum 32-bit instructions per word and phase: a Philox4x32-10 call
# is 10 rounds of 2 wide multiplies (hi and lo at once) and 2 three-input
# xors, plus 9 key bumps of 2 adds; the Bernoulli chains fold two words
# per three-input logic op; the stencil, count and flip are 24 logic ops;
# the fused (m, e) adds 7 popcounts and 9 integer adds
OPS_PER_PHILOX = 10 * 4 + 9 * 2
OPS_STENCIL_FLIP = 24
OPS_MEASURE = 16

T0 = time.perf_counter()


def log(msg: str) -> None:
    print(f"[chip_smoke {time.perf_counter() - T0:7.1f}s] {msg}",
          file=sys.stderr, flush=True)


def fail(msg: str) -> None:
    raise RuntimeError(msg)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def phase_ops_per_word(msb, beta: float, measuring: bool) -> int:
    q4, q8 = msb.chain_words(beta)
    draws = msb.chain_draws(q4) + msb.chain_draws(q8)
    ops = (math.ceil(draws / 4) * OPS_PER_PHILOX + math.ceil(draws / 2)
           + OPS_STENCIL_FLIP)
    return ops + (OPS_MEASURE if measuring else 0)


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = ops / PEAK_INT32_OPS_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def cuda_time_ms(fn, reps: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def random_planes(shape, seed: int, dev) -> list[torch.Tensor]:
    g = np.random.default_rng(seed)
    return [torch.from_numpy(g.integers(-2 ** 31, 2 ** 31, size=shape,
                                        dtype=np.int64).astype(np.int32)
                             ).to(dev) for _ in range(4)]


def max_abs_err(pairs) -> int:
    err = 0
    for got, want in pairs:
        if got.shape != want.shape:
            fail(f"shape {tuple(got.shape)} != {tuple(want.shape)}")
        d = (got.to(torch.int64) - want.to(torch.int64)).abs().max()
        err = max(err, int(d))
    return err


def check_kernels(msb, rng, dev, shapes) -> dict[str, int]:
    """Kernel vs plain version on the same CUDA tensors, bitwise; returns
    the largest absolute difference seen per kernel (0 when equal)."""
    from cuda_fortran_mc_simulation_spin_tpu_torch.models import Ising2D

    beta = 1.0 / KBT
    errs = {"phase": 0, "multisweep": 0}
    for nrep, ny, nx, sweeps in shapes:
        shape = (nrep, ny // 32, nx // 2)
        x, o, b4, b8 = random_planes(shape, seed=ny + nrep, dev=dev)
        key = rng.sample_key(rng.base_key(7), ny)
        seeds = msb.sweep_seed_pairs(key, sweeps)
        for color in (0, 1):
            e = max_abs_err([(
                msb.phase_packed_with_bits(x, o, b4, b8, color=color),
                msb.packed_phase_reference(x, o, color, b4, b8))])
            e_r = max_abs_err([(
                msb.phase_packed(x, o, seeds[0, color], color=color,
                                 beta=beta),
                msb.phase_packed_plain(x, o, seeds[0, color], color=color,
                                       beta=beta))])
            got, got_obs = msb.phase_packed(x, o, seeds[0, color],
                                            color=color, beta=beta,
                                            measuring=True)
            want, want_obs = msb.phase_packed_plain(
                x, o, seeds[0, color], color=color, beta=beta,
                measuring=True)
            e_m = max_abs_err([(got, want), (got_obs, want_obs)])
            # the fused sums against the model's exact sums of the state
            model_state = msb.unpack_state(*((o, got) if color else
                                             (got, o)), True)
            model = Ising2D(nx=nx, ny=ny, kbt=KBT)
            exact = torch.stack([model.magne_sum(model_state),
                                 model.energy_sum(model_state)], dim=-1)
            e_x = max_abs_err([(got_obs, exact)])
            errs["phase"] = max(errs["phase"], e, e_r, e_m, e_x)
            log(f"  phase kernel {nrep}x{ny}x{nx} colour {color}: "
                f"bits {e}, philox {e_r}, measuring {e_m}, "
                f"(m, e) vs exact sums {e_x}")
        wa, wb = x, o
        ka, kb, k_obs = msb.multisweep_planes(wa, wb, seeds, beta=beta)
        obs = []
        pa, pb = wa, wb
        for s in range(sweeps):
            pa = msb.phase_packed(pa, pb, seeds[s, 0], color=0, beta=beta)
            pb, ob = msb.phase_packed(pb, pa, seeds[s, 1], color=1,
                                      beta=beta, measuring=True)
            obs.append(ob)
        e_pairs = max_abs_err([(ka, pa), (kb, pb),
                               (k_obs, torch.stack(obs, dim=1))])
        qa, qb, q_obs = msb.multisweep_planes_plain(wa, wb, seeds, beta=beta)
        e_plain = max_abs_err([(ka, qa), (kb, qb), (k_obs, q_obs)])
        errs["multisweep"] = max(errs["multisweep"], e_pairs, e_plain)
        log(f"  multisweep kernel {nrep}x{ny}x{nx} S={sweeps}: vs "
            f"{sweeps} phase pairs {e_pairs}, vs plain {e_plain}")
    torch.cuda.synchronize()
    for name, e in errs.items():
        if e != 0:
            fail(f"{name} kernel differs from its plain version "
                 f"(max abs err {e})")
    return errs


def first_sweep_exact(msb, beta: float) -> tuple[float, float]:
    """Exact E[m], E[e] per site after one sweep from all-up, for the
    chains' quantized acceptances p4, p8.  Phase a flips each site with
    p8 (all four neighbours up); a phase-b site with c up neighbours flips
    surely for c <= 2, with p4 for c = 3 and p8 for c = 4."""
    q4, q8 = msb.chain_words(beta)
    p4, p8 = q4 / 2 ** 20, q8 / 2 ** 20
    all4, three = (1 - p8) ** 4, 4 * p8 * (1 - p8) ** 3
    flip_b = (1 - all4 - three) + three * p4 + all4 * p8
    m1 = 0.5 * (1 - 2 * p8) + 0.5 * (1 - 2 * flip_b)
    # a bond (a0, b0): b0's other three neighbours are up with 1 - p8
    up3, two3 = (1 - p8) ** 3, 3 * p8 * (1 - p8) ** 2
    flip_if_a0_up = (1 - up3 - two3) + two3 * p4 + up3 * p8
    flip_if_a0_down = (1 - up3) + up3 * p4
    bond = ((1 - p8) * (1 - 2 * flip_if_a0_up)
            - p8 * (1 - 2 * flip_if_a0_down))
    return m1, -2 * bond


def check_first_sweep(msb, rng, dev, ref_row, iters: int) -> None:
    """<m>(1), <e>(1) of the phase kernel over iters x 4 x 8192^2 sites
    against their exact values, within SIGMAS standard errors (variance
    from the reference's N·Var at t = 1): a test of the in-kernel
    Bernoulli chains far sharper than the reference curve."""
    beta = 1.0 / KBT
    m1, e1 = first_sweep_exact(msb, beta)
    up = torch.full((4, 8192 // 32, 4096), -1, dtype=torch.int32,
                    device=dev)
    total = torch.zeros(2, dtype=torch.int64, device=dev)
    base = rng.base_key(2024)
    for it in range(iters):
        seeds = msb.sweep_seed_pairs(rng.sample_key(base, it), 1)[0]
        wa = msb.phase_packed(up, up, seeds[0], color=0, beta=beta)
        _, obs = msb.phase_packed(up, wa, seeds[1], color=1, beta=beta,
                                  measuring=True)
        total += obs.sum(dim=0)
    nsites = iters * up.numel() * 64
    for name, got, want, nvar in (("m", int(total[0]) / nsites, m1,
                                   ref_row[7]),
                                  ("e", int(total[1]) / nsites, e1,
                                   ref_row[8])):
        z = (got - want) / math.sqrt(nvar / nsites)
        log(f"  first sweep <{name}> {got:.9f} exact {want:.9f} over "
            f"{nsites:.3g} sites, z {z:+.2f}")
        if abs(z) > SIGMAS:
            fail(f"first-sweep <{name}> is {z:+.2f} sigma from exact")


ROUTE_SHAPES = ((2048, 16), (4096, 4), (8192, 1), (8192, 4))


def compare_routes(msb, dev, beta: float, seeds) -> None:
    """ms per sweep of the runner's two chunk routes, CUDA events, at the
    main path's shapes and between them: one multisweep launch of S
    sweeps (resident) against S streamed phase pairs, host loop included
    (streaming).  Both give the same trajectory; this says which is
    faster where."""
    from cuda_fortran_mc_simulation_spin_tpu_torch.models import Ising2D

    sweeps = seeds.shape[0]
    for nx, nrep in ROUTE_SHAPES:
        model = Ising2D(nx=nx, ny=nx, kbt=KBT)
        wa, wb = random_planes((nrep, nx // 32, nx // 2), nx + nrep, dev)[:2]

        def resident():
            msb.multisweep_planes(wa, wb, seeds, beta=beta)

        def streaming():
            a, b = wa, wb
            for j in range(sweeps):
                a, b, _ = msb.sweep_measure_seeded(model, a, b, seeds[j])

        res_ms = cuda_time_ms(resident, reps=3, warmup=1) / sweeps
        str_ms = cuda_time_ms(streaming, reps=3, warmup=1) / sweeps
        ens_mib = 2 * wa.numel() * 4 / 2 ** 20
        log(f"  route {nx}^2 x {nrep} ({ens_mib:.0f} MiB of planes, "
            f"multisweep_fits {msb.multisweep_fits(nrep, nx, nx // 2)}): "
            f"resident {res_ms:.5f} ms/sweep, streaming {str_ms:.5f} "
            f"ms/sweep, streaming/resident {str_ms / res_ms:.3f}")


def read_dat(path: Path) -> np.ndarray:
    rows = [line.split() for line in path.read_text().splitlines()
            if line and not line.startswith("#")]
    return np.array(rows, dtype=np.float64)


def check_against_reference(table: np.ndarray, ref: np.ndarray, nsites: int,
                            samples: int, mcs: int, times) -> None:
    """<m>(t), <e>(t) within SIGMAS standard errors of the port's mean,
    with the variance taken from the reference's own N·Var columns."""
    if table.shape != (mcs, 10) or not np.all(np.isfinite(table)):
        fail(f"table shape {table.shape} (want ({mcs}, 10)) or non-finite")
    if not np.all(table[:, 1] == samples) or not np.all(
            table[:, 2] == np.arange(1, mcs + 1)):
        fail("Nsample or t column is wrong")
    for t in times:
        row, rrow = table[t - 1], ref[t - 1]
        for name, col, var_col in (("m", 3, 7), ("e", 4, 8)):
            sigma = math.sqrt(rrow[var_col] / (nsites * samples))
            z = (row[col] - rrow[col]) / sigma
            log(f"  t={t:5d} <{name}> port {row[col]:.9f} reference "
                f"{rrow[col]:.9f} sigma {sigma:.3e} z {z:+.2f}")
            if abs(z) > SIGMAS:
                fail(f"<{name}>({t}) is {z:+.2f} sigma from the reference")


def run_main_path(main_fn, msb, out_dir: Path, nx: int, replicas: int,
                  samples: int, mcs: int, ref: np.ndarray, times):
    path = out_dir / f"ising2d_{nx}.dat"
    argv = ["--model", "ising2d", "--nx", str(nx), "--ny", str(nx),
            "--kbt", repr(KBT), "--mcs", str(mcs), "--samples",
            str(samples), "--replicas", str(replicas), "--init-state",
            "allup", "--device", "cuda", "--output", str(path)]
    msb.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rc = main_fn(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(msb.LAUNCHES)
    if rc != 0:
        fail(f"CLI exited {rc}")
    rate = nx * nx * mcs * samples / wall
    log(f"  {nx}^2 x {samples} samples x {mcs} MCS: {wall:.2f} s, "
        f"{rate:.4g} flip attempts/s end to end, launches {launches}")
    check_against_reference(read_dat(path), ref, nx * nx, samples, mcs,
                            times)
    return launches, wall, rate


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this "
              "script needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from cuda_fortran_mc_simulation_spin_tpu_torch.core import rng
    from cuda_fortran_mc_simulation_spin_tpu_torch.ops import _build
    from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
        ising2d_multispin as msb,
    )
    from cuda_fortran_mc_simulation_spin_tpu_torch.runs.__main__ import (
        main as cli_main,
    )

    dev = torch.device("cuda")
    smi = nvidia_smi_line()
    log(f"device {torch.cuda.get_device_name(0)} | {smi} | torch "
        f"{torch.__version__} CUDA {torch.version.cuda}")

    # 1. build from scratch
    log("phase 1: build csrc/*.cu with nvcc")
    sources = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    for name in sources:
        _build.library_path(name).unlink(missing_ok=True)
    t0 = time.perf_counter()
    secs = _build.build(sources, force=True)
    build_s = time.perf_counter() - t0
    log(f"  built {sources} in {build_s:.1f} s ({secs})")
    for name in sources:
        for line in _build.library_path(name).with_suffix(
                ".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")
    log(f"  multisweep cooperative grid: {msb.multisweep_grid_blocks()} "
        "blocks resident")

    # 2. kernels against their plain versions
    log("phase 2: kernels vs plain versions (bitwise)")
    errs = check_kernels(msb, rng, dev, [
        (4, 1024, 1024, 64),     # the bring-up size
        (16, 2048, 2048, 64),    # resident main-path shape
        (4, 8192, 8192, 1),      # streaming main-path shape
    ])

    if not REFERENCE_DAT.exists():
        fail(f"reference curve {REFERENCE_DAT} is missing")
    ref = read_dat(REFERENCE_DAT)
    log("phase 2b: first sweep from all-up against its exact expectation")
    check_first_sweep(msb, rng, dev, ref[0], iters=100)
    with tempfile.TemporaryDirectory() as tmp:
        # 3. resident class through the multisweep kernel
        log("phase 3: main path, resident class (2048^2 x 16 replicas)")
        res_launch, res_wall, res_rate = run_main_path(
            cli_main, msb, Path(tmp), 2048, 16, 64, 1000, ref,
            (1, 10, 100, 1000))
        if res_launch["multisweep"] == 0:
            fail("resident main path launched no multisweep kernel")
        # 4. streaming class through the measuring phase kernel
        log("phase 4: main path, streaming class (8192^2 x 4 replicas)")
        str_launch, str_wall, str_rate = run_main_path(
            cli_main, msb, Path(tmp), 8192, 4, 4, 200, ref,
            (1, 10, 100, 200))
        if str_launch["phase_measuring"] == 0:
            fail("streaming main path launched no measuring phase kernel")

    # 5. times at the main path's shapes
    log("phase 5: kernel times (CUDA events)")
    beta = 1.0 / KBT
    key = rng.sample_key(rng.base_key(11), 0)
    seeds = msb.sweep_seed_pairs(key, 64)
    x, o = random_planes((4, 8192 // 32, 4096), 3, dev)[:2]
    words = x.numel()
    k1_ms = cuda_time_ms(lambda: msb.phase_packed(
        x, o, seeds[0, 1], color=1, beta=beta, measuring=True), reps=20)
    k1_plain_ms = cuda_time_ms(lambda: msb.phase_packed_plain(
        x, o, seeds[0, 1], color=1, beta=beta, measuring=True), reps=2,
        warmup=1)
    k1_bound, k1_by = bound_ms(
        3 * 4 * words + 2 * 8 * x.shape[0],
        words * phase_ops_per_word(msb, beta, True))
    log(f"  phase kernel 8192^2 x 4, measuring: {k1_ms:.4f} ms/launch "
        f"({words * 32 / k1_ms * 1e3:.4g} flip attempts/s), plain "
        f"{k1_plain_ms:.2f} ms, bound {k1_bound:.4f} ms ({k1_by})")
    wa, wb = random_planes((16, 2048 // 32, 1024), 5, dev)[:2]
    words2 = wa.numel()
    k2_ms = cuda_time_ms(lambda: msb.multisweep_planes(
        wa, wb, seeds, beta=beta), reps=5)
    k2_plain_ms = cuda_time_ms(lambda: msb.multisweep_planes_plain(
        wa, wb, seeds, beta=beta), reps=1, warmup=0)
    sweeps = seeds.shape[0]
    k2_bound, k2_by = bound_ms(
        4 * 4 * words2 + 2 * 8 * wa.shape[0] * sweeps,
        words2 * sweeps * (phase_ops_per_word(msb, beta, False)
                           + phase_ops_per_word(msb, beta, True)))
    log(f"  multisweep kernel 2048^2 x 16, S={sweeps}: {k2_ms:.3f} ms/launch"
        f" ({k2_ms / sweeps:.4f} ms/sweep, "
        f"{words2 * 2 * 32 * sweeps / k2_ms * 1e3:.4g} flip attempts/s), "
        f"plain {k2_plain_ms:.1f} ms, bound {k2_bound:.4f} ms ({k2_by})")

    compare_routes(msb, dev, beta, seeds)

    src = "cuda_fortran_mc_simulation_spin_tpu_torch/csrc/ising2d_multispin.cu"
    ref_py = "cuda_fortran_mc_simulation_spin_tpu/ops/ising2d_multispin.py"
    kernels = [
        {"name": "ising2d_multispin.phase_kernel", "route": "cuda",
         "source": src, "replaces": f"{ref_py}:355",
         "launches": res_launch["phase"] + str_launch["phase"],
         "max_abs_err": errs["phase"], "ms": k1_ms,
         "plain_ms": k1_plain_ms, "bound_ms": k1_bound, "bound_by": k1_by,
         "library_ms": None},
        {"name": "ising2d_multispin.multisweep_kernel", "route": "cuda",
         "source": src, "replaces": f"{ref_py}:495",
         "launches": res_launch["multisweep"] + str_launch["multisweep"],
         "max_abs_err": errs["multisweep"], "ms": k2_ms,
         "plain_ms": k2_plain_ms, "bound_ms": k2_bound, "bound_by": k2_by,
         "library_ms": None},
    ]
    for k in kernels:
        if k["launches"] == 0:
            fail(f"{k['name']} was not launched on the main path")
    log(f"main path: resident {res_rate:.4g} flip attempts/s "
        f"({res_wall:.2f} s), streaming {str_rate:.4g} flip attempts/s "
        f"({str_wall:.2f} s); build {build_s:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
