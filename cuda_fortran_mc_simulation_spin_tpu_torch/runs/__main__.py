"""CLI entry point of the port.

Port of ``cuda_fortran_mc_simulation_spin_tpu/runs/__main__.py``: the same
flags, plus ``--device {cuda,cpu}`` (default cuda; with no card, cuda
raises)::

    python -m cuda_fortran_mc_simulation_spin_tpu_torch.runs \\
        --model ising2d --nx 2048 --ny 2048 --kbt 2.26918531421 \\
        --mcs 1000 --samples 64 --replicas 16 --output ising2d.dat

Periodic Ising runs at every even shape: nx and ny multiples of 256 on
the bit-packed kernels, others on the int8 ones (the multisweep while the
batch's planes fit its bound, else phase and measure launches a sweep)::

    python -m cuda_fortran_mc_simulation_spin_tpu_torch.runs \
        --model ising2d --nx 1000 --ny 1000 --kbt 2.26918531421 \
        --mcs 1000 --samples 64 --replicas 16 --output ising2d_1000.dat

Odd ``--nx`` runs the helical 2-D lattice (``--nx 1001 --ny 1000``, the
reference's geometry); ``--model ising3d`` with even dims the periodic
3-D one (``--nx 512 --ny 512 --nz 512 --kbt 4.51152``, or ``--nx 500
--ny 500 --nz 500`` on the int8 kernels) and with odd
``--nx`` the helical 3-D one (``--nx 151 --ny 151 --nz 150``, ``--nx 501
--ny 501 --nz 500`` or ``--nx 1001 --ny 1000 --nz 1000``, the reference's
geometries).  ``--model clock`` runs the q-state clock model on even dims
at every 2 <= ``--q`` <= 127: q = 6, 4 and 3 on the bit-sliced packed
kernels where their gates take the shape (``--nx 2000 --ny 2000 --kbt
0.91``, the reference's literal geometry, or aligned ``--nx 2048 --ny
2048``), every other (q, shape) on the int8 kernels (``--q 5 --nx 1000
--ny 1000``; the multisweep while the batch's planes fit its bound, else
phase and measure launches a sweep); and helical at odd ``--nx``, every
q (``--nx 501 --ny 500 --kbt 0.8``; q = 6 on the bit-sliced packed kernel
where its gate takes the shape, every other q and shape on the masked
helical kernel).
``--model xy2d`` runs the periodic XY relaxation on even dims, Metropolis
only or with ``--n-over-relax N`` over-relaxation sweeps after each
Metropolis sweep while t <= ``--mcs-over-relax`` (default: every t)::

    python -m cuda_fortran_mc_simulation_spin_tpu_torch.runs \\
        --model xy2d --nx 4000 --ny 4000 --kbt 0.89 --mcs 1000 \\
        --samples 16 --replicas 8 --n-over-relax 1 --output xy_or.dat

Odd ``--nx`` runs helical XY: with even ``--ny`` on the dense engines
(f32-angle planes; ``SPINLAT_XY_DENSE_ANGLE=0`` selects component
planes), with odd ``--ny`` on the masked helical kernels, at the
reference's geometry::

    python -m cuda_fortran_mc_simulation_spin_tpu_torch.runs \\
        --model xy2d --nx 10001 --ny 10000 --kbt 0.89 --mcs 1000 \\
        --samples 4 --n-over-relax 1 --mcs-over-relax 1000 \\
        --output xy_helical_or.dat

and the XY disorder protocols (even nx only): ``--protocol
from_disorder`` (a random start rotated onto +x; ``--fix1mcs`` rotates
after the first sweep),
``finite_magne`` (``--init-magne``), ``samples`` (one row a sweep and
history; the start from ``--init-state``; also on periodic Ising 2-D and
3-D, the helical Ising models, rows N, sample, t, m, e, and on the
clock and helical XY, rows N, sample, t, m, e, m_y) and
``finite_magne_samples``::

    python -m cuda_fortran_mc_simulation_spin_tpu_torch.runs \\
        --model xy2d --protocol from_disorder --nx 1500 --ny 1500 \\
        --kbt 0.89 --mcs 1000 --samples 64 --output xy_fd.dat

Every helical 2-D shape the packed and dense engines refuse (helical Ising
past the packed bound or at odd nx*ny, the helical clock at q != 6 or odd
nx*ny, helical XY at odd --ny) runs on the masked helical kernels, and so
do all of them under the JAX package's switches
``SPINLAT_HELICAL_PACKED=0``, ``SPINLAT_CLOCK_HELICAL_PACKED=0`` and
``SPINLAT_XY_DENSE=0``.  Periodic XY takes component planes by default;
the JAX package's ``SPINLAT_XY_PERIODIC_ANGLE=1`` sends the relaxation
and the streamed disorder runs to its f32-angle engine, and
``SPINLAT_XY_ANGLE_MS=1`` the disorder runs its int16-angle gate takes
(e.g. 1536x1536) to the int16-angle multisweep.  The ``# engine:`` line
names the route taken.

``--mesh DP,Y[,X]`` runs every periodic model (Ising 2-D and 3-D, the
clock, XY and its disorder protocols) domain-sharded over a mesh of
DP·Y·X cards (replicas over DP, rows or z-planes over Y, colour-array
columns over X, 2-D only), with the same series as the unsharded run bit
for bit where both take the same engine (Ising packed or int8, the
packed clock; the float64 sums of the int8 clock and XY within 1e-12;
README.md); ``--protocol samples`` runs its histories unsharded, and a
helical shape on a mesh raises ValueError, as in the JAX package.  With
``--device cpu`` the mesh repeats the host and runs the kernels' plain
versions::

    python -m cuda_fortran_mc_simulation_spin_tpu_torch.runs \
        --model ising2d --nx 8192 --ny 8192 --mcs 200 --samples 4 \
        --replicas 4 --mesh 1,4 --output ising2d_mesh.dat

stdout (or --output) = the dataset; stderr = progress.  --registry
appends a JSON run record.  --checkpoint enables exact resume.  Flags of
routes the port does not serve yet raise with the ROADMAP.md item that
ports them: --profile-dir, --backend other than auto, and helical 3-D
at 2^30 sites a colour or more.  --n-over-relax on Ising or clock
raises ValueError: over-relaxation is defined for the XY model only.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from cuda_fortran_mc_simulation_spin_tpu_torch.config import RunConfig
from cuda_fortran_mc_simulation_spin_tpu_torch.engine import protocols
from cuda_fortran_mc_simulation_spin_tpu_torch.io import registry


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="cuda_fortran_mc_simulation_spin_tpu_torch")
    p.add_argument("--model", default="ising2d",
                   choices=["ising2d", "ising3d", "clock", "xy2d"])
    p.add_argument("--protocol", default="relaxation",
                   choices=sorted(protocols.PROTOCOLS))
    p.add_argument("--nx", type=int, default=128)
    p.add_argument("--ny", type=int, default=128)
    p.add_argument("--nz", type=int, default=1)
    p.add_argument("--q", type=int, default=6)
    p.add_argument("--kbt", type=float, default=2.26918531421)
    p.add_argument("--mcs", type=int, default=100)
    p.add_argument("--samples", type=int, default=10)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--stream", type=int, default=0,
                   help="ensemble-split slot (the reference's n_skip)")
    p.add_argument("--init-state", default="allup",
                   choices=["allup", "random", "finite_magne",
                            "small_magne", "near_magne"])
    p.add_argument("--init-magne", type=float, default=0.02)
    p.add_argument("--n-over-relax", type=int, default=0)
    p.add_argument("--mcs-over-relax", type=int, default=0)
    p.add_argument("--fix1mcs", action="store_true",
                   help="rotate to x-axis after the first MCS")
    p.add_argument("--track-correlation", action="store_true",
                   help="record the two-point correlation at offset "
                        "(nx/2-1, ny/2-1) (XY disorder protocols)")
    p.add_argument("--replicas", type=int, default=1)
    p.add_argument("--samples-per-call", type=int, default=1)
    p.add_argument("--max-samples-this-run", type=int, default=None,
                   help="stop after folding this many samples "
                        "(checkpoint + clean exit; rerun to resume)")
    p.add_argument("--measure-times", type=int, nargs="*", default=None,
                   help="specific 1-based sweep times to record")
    p.add_argument("--backend", default="auto",
                   choices=["auto", "jnp", "pallas"])
    p.add_argument("--output", default=None, help="dataset path (- = stdout)")
    p.add_argument("--registry", default=None, help="run-registry log path")
    p.add_argument("--checkpoint", default=None, help="checkpoint path")
    p.add_argument("--checkpoint-every", type=int, default=0)
    p.add_argument("--profile-dir", default=None,
                   help="profiler trace directory (not served by the port)")
    p.add_argument("--mesh", default=None, metavar="DP,Y[,X]",
                   help="multi-chip mesh: replicas over DP devices, "
                        "lattice rows over Y, optionally columns over X "
                        "(e.g. 2,4 or 1,2,2)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda (default) runs the CUDA kernels; cpu runs "
                        "their plain PyTorch versions")
    return p.parse_args(argv)


def _refuse_unserved(a: argparse.Namespace) -> None:
    if a.profile_dir:
        raise NotImplementedError(
            "--profile-dir: the port has no profiler hook yet (ROADMAP.md "
            "queue A item 10)")
    if a.backend != "auto":
        raise NotImplementedError(
            f"--backend {a.backend}: the port serves one route per shape "
            "(the CUDA kernels, or their plain versions with --device cpu)")


def config_from_args(a: argparse.Namespace) -> RunConfig:
    mesh_dp, mesh_y, mesh_x = 1, 1, 1
    if a.mesh:
        parts = [int(v) for v in a.mesh.split(",")]
        if len(parts) == 2:
            mesh_dp, mesh_y = parts
        else:
            mesh_dp, mesh_y, mesh_x = parts
    return RunConfig(
        model=a.model, nx=a.nx, ny=a.ny, nz=a.nz, q=a.q, kbt=a.kbt,
        mcs=a.mcs, tot_sample=a.samples, seed=a.seed, stream=a.stream,
        init_state=a.init_state, init_magne=a.init_magne,
        n_over_relax=a.n_over_relax, mcs_over_relax=a.mcs_over_relax,
        rotate_after_first_mcs=a.fix1mcs,
        track_correlation=a.track_correlation, replicas=a.replicas,
        samples_per_call=a.samples_per_call,
        max_samples_this_run=a.max_samples_this_run,
        measure_times=a.measure_times, mesh_dp=mesh_dp, mesh_y=mesh_y,
        mesh_x=mesh_x,
    )


class _LazyFile:
    """File that comes into existence on first write(), so that a run cut
    off before its first byte leaves no empty ``.partial`` behind."""

    def __init__(self, path: str):
        self._path = path
        self._f = None

    @property
    def created(self) -> bool:
        return self._f is not None

    def write(self, s: str) -> int:
        if self._f is None:
            self._f = open(self._path, "w")
        return self._f.write(s)

    def flush(self) -> None:
        if self._f is not None:
            self._f.flush()

    def close(self) -> None:
        if self._f is not None:
            self._f.close()


def main(argv=None) -> int:
    a = parse_args(argv)
    _refuse_unserved(a)
    cfg = config_from_args(a)
    protocol = protocols.PROTOCOLS[a.protocol]
    kwargs = {"device": a.device}
    if a.checkpoint:
        kwargs.update(checkpoint_path=a.checkpoint,
                      checkpoint_every=a.checkpoint_every)
    protocols.LAST_ENGINE = None
    t0 = time.time()
    if a.output and a.output != "-":
        # atomic dataset write: rows land in <output>.partial and the
        # final name appears only when the protocol completes
        tmp = a.output + ".partial"
        if os.path.exists(tmp) and os.path.getsize(tmp) == 0:
            os.unlink(tmp)  # stale litter from a killed run
        out = _LazyFile(tmp)
        try:
            protocol(cfg, out=out, err=sys.stderr, **kwargs)
        finally:
            out.close()
        if out.created:
            os.replace(tmp, a.output)
    else:
        protocol(cfg, out=sys.stdout, err=sys.stderr, **kwargs)
    if a.registry:
        registry.append(a.registry, cfg, time.time() - t0,
                        a.output, {"protocol": a.protocol,
                                   "engine": protocols.LAST_ENGINE,
                                   "device": a.device})
    return 0


if __name__ == "__main__":
    sys.exit(main())
