"""NER protocols: relaxation and the XY disorder protocols.

Port of ``cuda_fortran_mc_simulation_spin_tpu/engine/protocols.py``:
per-sample initial states, the sweep/measure runners, host-side Kahan
aggregation, and the reference-format ``.dat`` tables on ``out`` with
progress on ``err`` (stdout = dataset, stderr = progress).

- ``relaxation`` serves the bit-packed routes (periodic 2-D and 3-D
  multispin, helical 2-D and 3-D multispin, the bit-sliced clock engines:
  periodic q = 6, 4, 3, aligned and padded, helical q = 6), the generic
  runners on the int8 kernels for periodic Ising 2-D and 3-D and the
  periodic clock (every q) at every even shape the packed routes do not
  take (the int8 multisweep, the per-history and the batched runner, in
  the JAX package's order), the
  periodic XY phases and the dense helical XY engines (odd nx, even ny;
  angle planes by default, component planes with
  ``SPINLAT_XY_DENSE_ANGLE=0``), with and without over-relaxation, and
  the masked helical kernels (ops/helical_pallas.py) for every helical 2-D
  shape the packed and dense engines refuse, or all of them under the JAX
  package's switches ``SPINLAT_HELICAL_PACKED=0``,
  ``SPINLAT_CLOCK_HELICAL_PACKED=0`` and ``SPINLAT_XY_DENSE=0``; periodic
  XY on component planes, or on f32-angle planes under
  ``SPINLAT_XY_PERIODIC_ANGLE=1``;
- ``from_disorder`` (with ``rotate_after_first_mcs``: the fix1mcs app),
  ``finite_magne``, ``samples`` and ``finite_magne_samples`` serve the
  periodic XY model through ``sweep.make_xy_disorder_runner`` (the
  snapshot-measuring phase, the standalone measurement and the resident
  multisweep; under the JAX package's ``SPINLAT_XY_PERIODIC_ANGLE=1`` the
  streamed runs on its f32-angle engine, under ``SPINLAT_XY_ANGLE_MS=1``
  the runs its gate takes on the int16-angle multisweep, in JAX's route
  order); ``samples`` serves periodic Ising 2-D and 3-D, the
  periodic clock and the helical models through
  ``sweep.make_sample_runner`` (JAX ``_run_samples_generic``).

A mesh (``cfg.mesh_dp·mesh_y·mesh_x`` > 1) runs every periodic model
domain-sharded (parallel/domain.py, the JAX package's mesh branches of
``_run_accumulating`` and ``_run_xy_disorder``): the cards of
``make_mesh``, the host repeated with ``device="cpu"``, or the devices
given as ``mesh_devices``; ``samples`` runs its histories unsharded
whatever the mesh, as the JAX package does.  The one route of the JAX
package not served, helical 3-D at 2^30 sites a colour or more, raises
NotImplementedError naming the ROADMAP.md item that ports it, and never
falls back; a helical model on a mesh raises ValueError, as the JAX
package fails there.  Over-relaxation on the
Ising and clock models raises ValueError: it is defined for the XY model
only.

Checkpoint/resume: pass ``checkpoint_path``; accumulators are saved
every ``checkpoint_every`` histories and runs resume exactly
(io/checkpoint.py).
"""

from __future__ import annotations

import dataclasses
import sys
import time
from typing import IO

import numpy as np
import torch

from cuda_fortran_mc_simulation_spin_tpu_torch.config import (
    RunConfig,
    resolve_device,
)
from cuda_fortran_mc_simulation_spin_tpu_torch.core import rng, stats
from cuda_fortran_mc_simulation_spin_tpu_torch.engine import sweep as sweep_mod
from cuda_fortran_mc_simulation_spin_tpu_torch.io import checkpoint, datfmt
from cuda_fortran_mc_simulation_spin_tpu_torch.models import (
    Clock2D,
    Clock2DHelical,
    Ising2DHelical,
    Ising3D,
    Ising3DHelical,
    XY2D,
    XY2DHelical,
    build_model,
)
from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
    clock_multisweep,
    helical3d_multispin,
    ising2d_multispin,
    ising2d_multisweep,
    ising3d_multispin,
)


def _header_fields(cfg: RunConfig, model, extra: dict | None = None
                   ) -> dict:
    fields = {
        "size": model.nsites,
        "nx, ny": (cfg.nx, cfg.ny) if cfg.model != "ising3d"
        else (cfg.nx, cfg.ny, cfg.nz),
        "sample": cfg.tot_sample,
        "mcs": cfg.mcs,
        "kbt": cfg.kbt,
        "initial seed": cfg.seed,
        "n_skip": cfg.stream,
    }
    if cfg.n_over_relax > 0:
        fields["mcs_over_relax"] = cfg.mcs_over_relax or cfg.mcs
        fields["n_over_relax"] = cfg.n_over_relax
    fields["method"] = "Metropolis"
    if extra:
        fields.update(extra)
    return fields


def _emit_headers(cfg, model, out, err, extra=None):
    datfmt.write_header(out, _header_fields(cfg, model, extra))
    datfmt.write_header(err, _header_fields(cfg, model, extra))


def _progress(err: IO[str]):
    def cb(done, total):
        err.write(f"Sample: {done} / {total}\n")
        err.flush()
    return cb


def _filter_times(series: dict, cfg: RunConfig) -> dict:
    """Keep only the rows at cfg.measure_times (1-based), if set."""
    if cfg.measure_times is None:
        return series
    idx = np.asarray(cfg.measure_times, dtype=np.int64) - 1
    return {k: np.take(v, idx, axis=-1) for k, v in series.items()}


def _series_len(cfg: RunConfig) -> int:
    return (len(cfg.measure_times) if cfg.measure_times is not None
            else cfg.mcs)


# engine stamped on the most recent run; emitted as a `# engine:` line
# and a registry field by runs/__main__.py
LAST_ENGINE: str | None = None


def _stamp_engine(runner, err) -> None:
    global LAST_ENGINE
    LAST_ENGINE = runner.engine
    err.write(f"# engine: {LAST_ENGINE}\n")


def _ensemble_loop(cfg, runner, fold, err, accs, base, batch, start,
                   checkpoint_path, checkpoint_every):
    """Run batches keyed by the global call index, fold them into the
    accumulators, checkpoint on cadence, and honour the
    --max-samples-this-run budget (checkpoint + clean stop)."""
    progress = _progress(err)
    budget = cfg.max_samples_this_run
    if budget and not checkpoint_path:
        raise ValueError(
            "max_samples_this_run needs --checkpoint (the next "
            "invocation resumes from it)")
    done = start
    for call in range(start // batch, cfg.tot_sample // batch):
        series = runner(rng.sample_key(base, call))
        series = {k: v.cpu().numpy().astype(np.float64)
                  for k, v in series.items()}
        fold(_filter_times(series, cfg))
        done = (call + 1) * batch
        progress(done, cfg.tot_sample)
        if (checkpoint_path and checkpoint_every
                and done % checkpoint_every == 0):
            checkpoint.save(checkpoint_path, cfg, done, accs)
        if budget and done - start >= budget and done < cfg.tot_sample:
            err.write(f"# stopping after {done - start} samples this "
                      f"run ({done} / {cfg.tot_sample} total); resume "
                      "with the same command\n")
            break
    if checkpoint_path:
        checkpoint.save(checkpoint_path, cfg, done, accs)


def _meshed(cfg) -> bool:
    return cfg.mesh_dp * cfg.mesh_y * cfg.mesh_x > 1


def _check_route(cfg, model) -> None:
    """Raise for every route of the JAX package that the port does not
    serve yet, naming the ROADMAP.md item that ports it.  ``build_model``
    admits the Ising, clock and XY models; every periodic shape and every
    helical 2-D shape is served (the helical 2-D ones the packed and dense
    engines refuse on the masked helical kernels), and so are the periodic
    models on a mesh, so what is left is helical 3-D at 2^30 sites a
    colour or more, which the JAX package sends to its generic jnp runner
    (its ``sweep.py:665-675``).  A helical model on a mesh raises
    ValueError (the JAX package fails on it).  Over-relaxation on the
    Ising and clock models raises ValueError."""
    if _meshed(cfg) and isinstance(
            model, (Ising2DHelical, Ising3DHelical, Clock2DHelical,
                    XY2DHelical)):
        raise ValueError(
            f"{type(model).__name__}: the helical layouts have no domain "
            "decomposition; run them without --mesh")
    if isinstance(model, (XY2D, XY2DHelical)):
        return
    if cfg.n_over_relax > 0:
        raise ValueError(
            f"over-relaxation is defined for the XY model only, not the "
            f"{cfg.model} model (the JAX package defines over_relax_sweep "
            "only in models/xy2d.py and models/xy2d_helical.py; its generic "
            "runner fails on other models)")
    if isinstance(model, Ising3DHelical):
        if not helical3d_multispin.fits_stream(model):
            raise NotImplementedError(
                f"helical {cfg.nx}x{cfg.ny}x{cfg.nz} has "
                f"{model.nsites // 2} sites a colour, not below the "
                f"{helical3d_multispin.MAX_SITES} the packed helical 3-D "
                "kernels index; the JAX package runs it on its generic "
                "runner, whose port is not done yet (ROADMAP.md queue A "
                "item 4a)")


def _int8_runner(cfg, model, batch: int, device):
    """The JAX package's last two routes: at one replica the per-history
    runner, else the batched one (int8 phase and measure kernels)."""
    if batch == 1:
        return sweep_mod.make_sample_runner(model, cfg.mcs, cfg.init_state,
                                            device=device)
    return sweep_mod.make_batch_runner(model, cfg.mcs, batch,
                                       cfg.init_state, device=device)


def _make_runner(cfg, model, batch: int, device):
    """The route of the JAX package's ``_run_accumulating`` for the
    served models.  Periodic Ising and clock in its order, without the
    TPU's gates: packable shapes on the bit-packed engines (the clock:
    ``sweep.clock_route``, q = 6, 4, 3); else (Ising 2-D, clock) the int8
    multisweep while the batch fits ``ising2d_multisweep.fits`` or
    ``clock_multisweep.fits``; else the per-history runner at one replica
    and the batched one above."""
    if isinstance(model, XY2D):
        return sweep_mod.make_xy_runner(
            model, cfg.mcs, batch, cfg.init_state,
            n_over_relax=cfg.n_over_relax,
            mcs_over_relax=cfg.mcs_over_relax, device=device)
    if isinstance(model, XY2DHelical):
        return sweep_mod.make_helical_runner(
            model, cfg.mcs, batch, cfg.init_state, device=device,
            n_over_relax=cfg.n_over_relax,
            mcs_over_relax=cfg.mcs_over_relax)
    if isinstance(model, Clock2D):
        if sweep_mod.clock_route(model) is not None:
            return sweep_mod.make_clock_multispin_runner(
                model, cfg.mcs, batch, cfg.init_state, device=device)
        if clock_multisweep.fits(batch, *model.color_shape):
            return sweep_mod.make_multisweep_runner(
                model, cfg.mcs, batch, cfg.init_state, device=device)
        return _int8_runner(cfg, model, batch, device)
    if isinstance(model, (Ising2DHelical, Ising3DHelical, Clock2DHelical)):
        # the packed helical engines, else the masked helical kernels
        return sweep_mod.make_helical_runner(
            model, cfg.mcs, batch, cfg.init_state, device=device)
    if isinstance(model, Ising3D):
        if ising3d_multispin.packable3d(*model.color_shape[1:]):
            return sweep_mod.make_multispin3d_runner(
                model, cfg.mcs, batch, cfg.init_state, device=device)
        return _int8_runner(cfg, model, batch, device)
    if ising2d_multispin.packable(*model.color_shape):
        return sweep_mod.make_multispin_runner(
            model, cfg.mcs, batch, cfg.init_state, device=device)
    if ising2d_multisweep.fits(batch, *model.color_shape):
        return sweep_mod.make_multisweep_runner(
            model, cfg.mcs, batch, cfg.init_state, device=device)
    return _int8_runner(cfg, model, batch, device)


def _mesh_runner(cfg, model, batch: int, device, mesh_devices):
    """The JAX package's mesh branch (its ``_run_accumulating``): the
    domain-sharded runner over a (dp, y[, x]) mesh of the visible cards,
    the host repeated for a CPU ``device``, or ``mesh_devices``."""
    from cuda_fortran_mc_simulation_spin_tpu_torch.parallel import (
        domain,
        mesh as mesh_mod,
    )
    msh = mesh_mod.make_mesh(cfg.mesh_dp, cfg.mesh_y, cfg.mesh_x,
                             devices=mesh_devices,
                             device_type=torch.device(device).type)
    runner = domain.make_sharded_sample_runner(
        model, msh, cfg.mcs, batch, cfg.init_state,
        n_over_relax=cfg.n_over_relax, mcs_over_relax=cfg.mcs_over_relax)
    runner.engine = (f"domain-sharded mesh ({cfg.mesh_dp},{cfg.mesh_y},"
                     f"{cfg.mesh_x})")
    return runner


def _run_accumulating(cfg, model, accumulators, fold, err,
                      checkpoint_path=None, checkpoint_every=0,
                      device="cuda", mesh_devices=None):
    """Shared ensemble loop: batch runner + Kahan fold + checkpointing."""
    base = rng.base_key(cfg.seed, cfg.stream)
    batch = cfg.replicas * cfg.samples_per_call
    if cfg.tot_sample % max(batch, 1):
        raise ValueError("tot_sample must be divisible by the batch size")
    if _meshed(cfg):
        runner = _mesh_runner(cfg, model, max(batch, 1), device,
                              mesh_devices)
    else:
        runner = _make_runner(cfg, model, max(batch, 1), device)
    _stamp_engine(runner, err)
    start = 0
    if checkpoint_path:
        try:
            done = checkpoint.load(checkpoint_path, cfg, accumulators)
            start = (done // batch) * batch
            err.write(f"# resumed at sample {done}\n")
        except FileNotFoundError:
            pass
    _ensemble_loop(cfg, runner, fold, err, accumulators, base, batch,
                   start, checkpoint_path, checkpoint_every)


def run_relaxation(cfg: RunConfig, out: IO[str] = sys.stdout,
                   err: IO[str] = sys.stderr,
                   checkpoint_path: str | None = None,
                   checkpoint_every: int = 0, device="cuda",
                   mesh_devices=None) -> stats.VarianceCovarianceKahan:
    """The reference's ising2d/ising3d/clock/xy2d relaxation and XY
    over-relaxation apps: ordered (or random) start, per-sweep m and e,
    their variances and covariance.  On a mesh (``cfg.mesh_*``),
    ``mesh_devices`` names its devices in mesh order (a card may repeat),
    as the JAX tests build their virtual mesh; by default the visible
    cards, or the host for a CPU ``device``."""
    dev = resolve_device(device)
    model = build_model(cfg)
    _check_route(cfg, model)
    _emit_headers(cfg, model, out, err)
    op = stats.VarianceCovarianceKahan((_series_len(cfg),))

    def fold(series):
        op.add_data(series["m"], series["e"])

    t0 = time.time()
    _run_accumulating(cfg, model, {"op": op}, fold, err,
                      checkpoint_path, checkpoint_every, dev, mesh_devices)
    err.write(f"# elapsed: {time.time() - t0:.3f}s\n")
    out.write(f"# engine: {LAST_ENGINE}\n")
    if cfg.measure_times is None:
        datfmt.write_relaxation_table(out, model.nsites, cfg.mcs, op)
    else:
        datfmt.write_specific_times_table(out, model.nsites,
                                          cfg.measure_times, op)
    return op


# ---------------------------------------------------------------------------
# XY disorder protocols (autocorrelation-carrying runners)
# ---------------------------------------------------------------------------

def _check_disorder(cfg: RunConfig) -> None:
    """The disorder protocols run on the periodic XY engine only (the JAX
    package's ValueError)."""
    if cfg.model != "xy2d" or cfg.nx % 2:
        raise ValueError(
            "disorder protocols need the periodic XY engine: use even "
            f"nx (got nx={cfg.nx}, which selects the helical layout)")


def _xy_disorder_mesh_runner(cfg: RunConfig, model, prep: str, batch: int,
                             device, mesh_devices=None):
    """The JAX package's mesh branch of ``_run_xy_disorder`` (its
    ``_xy_disorder_mesh_runner``): the domain-sharded disorder runner over
    a (dp, y[, x]) mesh of the visible cards, the host repeated for a CPU
    ``device``, or ``mesh_devices``.  It never takes the int16-angle
    route, as JAX's ``_xy_multisweep_eligible`` refuses a mesh."""
    from cuda_fortran_mc_simulation_spin_tpu_torch.parallel import (
        domain,
        mesh as mesh_mod,
    )
    msh = mesh_mod.make_mesh(cfg.mesh_dp, cfg.mesh_y, cfg.mesh_x,
                             devices=mesh_devices,
                             device_type=torch.device(device).type)
    runner = domain.make_sharded_xy_disorder_runner(
        model, msh, cfg.mcs, batch, prep, init_magne=cfg.init_magne,
        near_magne_tol=cfg.near_magne_tol, n_over_relax=cfg.n_over_relax,
        mcs_over_relax=cfg.mcs_over_relax,
        track_correlation=cfg.track_correlation)
    runner.engine = (f"XY disorder domain-sharded mesh ({cfg.mesh_dp},"
                     f"{cfg.mesh_y},{cfg.mesh_x})")
    return runner


def _xy_disorder_runner(cfg: RunConfig, model, prep: str, batch: int,
                        device):
    return sweep_mod.make_xy_disorder_runner(
        model, cfg.mcs, batch, prep, init_magne=cfg.init_magne,
        near_magne_tol=cfg.near_magne_tol, n_over_relax=cfg.n_over_relax,
        mcs_over_relax=cfg.mcs_over_relax,
        track_correlation=cfg.track_correlation, device=device)


def _run_xy_disorder(cfg: RunConfig, prep: str, out, err,
                     header_extra: dict, checkpoint_path=None,
                     checkpoint_every=0, device="cuda", mesh_devices=None):
    """The shared ensemble of the disorder protocols: a replica batch a
    call, the five accumulators ((|m|, e), (mx, my), (mx, e), (my, e) and
    A; with ``track_correlation`` also the two-point correlation),
    checkpoint/resume; on a mesh (``cfg.mesh_*``) the domain-sharded
    runner.  Returns (model, accumulators)."""
    dev = resolve_device(device)
    _check_disorder(cfg)
    model = build_model(cfg)
    _emit_headers(cfg, model, out, err, header_extra)
    length = _series_len(cfg)
    op_abs = stats.VarianceCovarianceKahan((length,))   # (|m|, e)
    op_xy = stats.VarianceCovarianceKahan((length,))    # (mx, my)
    op = stats.VarianceCovarianceKahan((length,))       # (mx, e)
    op_y = stats.VarianceCovarianceKahan((length,))     # (my, e)
    ac = stats.VarianceKahan((length,))
    accs = {"op_abs": op_abs, "op_xy": op_xy, "op": op, "op_y": op_y,
            "ac": ac}
    if cfg.track_correlation:
        accs["corr"] = stats.VarianceKahan((length,))

    base = rng.base_key(cfg.seed, cfg.stream)
    batch = max(cfg.replicas, 1)
    if cfg.tot_sample % batch:
        raise ValueError("tot_sample must be divisible by replicas")
    if _meshed(cfg):
        runner = _xy_disorder_mesh_runner(cfg, model, prep, batch, dev,
                                          mesh_devices)
    else:
        runner = _xy_disorder_runner(cfg, model, prep, batch, dev)
    _stamp_engine(runner, err)

    start = 0
    if checkpoint_path:
        try:
            start = checkpoint.load(checkpoint_path, cfg, accs)
            err.write(f"# resumed at sample {start}\n")
        except FileNotFoundError:
            pass

    def fold(series):
        op_abs.add_data(np.hypot(series["mx"], series["my"]), series["e"])
        op_xy.add_data(series["mx"], series["my"])
        op.add_data(series["mx"], series["e"])
        op_y.add_data(series["my"], series["e"])
        ac.add_data(series["A"])
        if cfg.track_correlation:
            accs["corr"].add_data(series["corr"])

    t0 = time.time()
    _ensemble_loop(cfg, runner, fold, err, accs, base, batch,
                   (start // batch) * batch, checkpoint_path,
                   checkpoint_every)
    err.write(f"# elapsed: {time.time() - t0:.3f}s\n")
    out.write(f"# engine: {LAST_ENGINE}\n")
    return model, accs


def run_from_disorder(cfg: RunConfig, out: IO[str] = sys.stdout,
                      err: IO[str] = sys.stderr,
                      checkpoint_path: str | None = None,
                      checkpoint_every: int = 0, device="cuda",
                      mesh_devices=None) -> dict:
    """xy2d_periodic_gpu_relaxation_from_disorder (and its _fix1mcs
    variant with cfg.rotate_after_first_mcs): a random start rotated onto
    +x (fix1mcs: rotated, with the snapshot, after the first sweep);
    writes output_abs_parameters_from_disorder.  ``mesh_devices`` as for
    :func:`run_relaxation`."""
    prep = "fix1mcs" if cfg.rotate_after_first_mcs else "rotate_first"
    model, accs = _run_xy_disorder(
        cfg, prep, out, err, {"initial state": "disorder"},
        checkpoint_path, checkpoint_every, device, mesh_devices)
    datfmt.write_abs_parameters_from_disorder(
        out, model.nsites, _series_len(cfg), accs["op_abs"], accs["op_xy"],
        accs["ac"], times=cfg.measure_times, correlation=accs.get("corr"))
    return accs


def run_finite_magne(cfg: RunConfig, out: IO[str] = sys.stdout,
                     err: IO[str] = sys.stderr,
                     checkpoint_path: str | None = None,
                     checkpoint_every: int = 0, device="cuda",
                     mesh_devices=None) -> dict:
    """..._from_disorder_finite_magne: prepare |m| = cfg.init_magne along
    +x, then relax; writes output_parameters_from_disorder
    (xy2d_periodic_gpu_relaxation_from_disorder_finite_magne.f90:40-75)."""
    extra = {"initial state": "disorder",
             "Initial finite magne": cfg.init_magne}
    model, accs = _run_xy_disorder(cfg, "finite_magne", out, err, extra,
                                   checkpoint_path, checkpoint_every, device,
                                   mesh_devices)
    datfmt.write_parameters_from_disorder(
        out, model.nsites, _series_len(cfg), accs["op"], accs["op_y"],
        accs["ac"], times=cfg.measure_times, correlation=accs.get("corr"))
    return accs


# the preparation of the samples protocol by cfg.init_state (others:
# rotate_first)
_PREP_FOR_INIT = {
    "random": "rotate_first",
    "finite_magne": "finite_magne",
    "small_magne": "small_magne",
    "near_magne": "near_magne",
}


def _run_samples_generic(cfg: RunConfig, model, out, err, device) -> None:
    """Per-sample raw series of the Ising and clock models and helical XY
    (JAX ``_run_samples_generic``, its ``protocols.py:1152-1179``): plain
    Metropolis histories on ``sweep.make_sample_runner`` (the helical 2-D
    models on the masked helical kernels, helical 3-D on its helical
    kernels), rows N, sample, t, m, e, and m_y where the series has it
    (the clock, XY), as JAX appends it.  A mesh is ignored, as there."""
    if cfg.init_state not in ("allup", "random"):
        raise ValueError(
            f"init_state={cfg.init_state!r} requires the periodic XY "
            f"engine (--model xy2d with even nx); model {cfg.model!r} "
            "supports allup/random starts"
        )
    # the JAX package runs these histories unsharded whatever the mesh
    _check_route(dataclasses.replace(cfg, n_over_relax=0, mesh_dp=1,
                                     mesh_y=1, mesh_x=1), model)
    _emit_headers(cfg, model, out, err)
    base = rng.base_key(cfg.seed, cfg.stream)
    runner = sweep_mod.make_sample_runner(model, cfg.mcs, cfg.init_state,
                                          device=device)
    _stamp_engine(runner, err)
    out.write(f"# engine: {LAST_ENGINE}\n")
    progress = _progress(err)
    for s in range(cfg.tot_sample):
        series = runner(rng.sample_key(base, s))
        series = {k: v.cpu().numpy().astype(np.float64)
                  for k, v in series.items()}
        order = ("m", "e") + (("my",) if "my" in series else ())
        datfmt.write_sample_series(out, model.nsites, s + 1,
                                   _filter_times(series, cfg),
                                   order=order, times=cfg.measure_times)
        progress(s + 1, cfg.tot_sample)


def run_samples(cfg: RunConfig, out: IO[str] = sys.stdout,
                err: IO[str] = sys.stderr, device="cuda") -> None:
    """Raw per-sample time series, no aggregation: the *_samples apps
    (xy2d_periodic_gpu_relaxation_from_disorder_finite_magne_samples.f90:
    40-58), one history a sample keyed by its sample key.  Periodic XY:
    the preparation from cfg.init_state, rows N, sample, t, m_x, e, m_y, A
    (and corr) under the reference's literal header.  Every other model
    (the JAX XY helical model has no rotation, so it is one of them):
    :func:`_run_samples_generic`.  A mesh is ignored: the JAX package runs
    these histories unsharded."""
    dev = resolve_device(device)
    if cfg.model != "xy2d" or cfg.nx % 2:
        _run_samples_generic(cfg, build_model(cfg), out, err, dev)
        return
    _check_disorder(cfg)
    model = build_model(cfg)
    prep = _PREP_FOR_INIT.get(cfg.init_state, "rotate_first")
    extra = {"initial state": "disorder"}
    if prep == "finite_magne":
        extra["Initial finite magne"] = cfg.init_magne
    _emit_headers(cfg, model, out, err, extra)
    base = rng.base_key(cfg.seed, cfg.stream)
    runner = _xy_disorder_runner(cfg, model, prep, 1, dev)
    _stamp_engine(runner, err)
    out.write(f"# engine: {LAST_ENGINE}\n")
    progress = _progress(err)
    order = ("mx", "e", "my", "A")
    # sic: the reference's literal header, typo included
    # (..._finite_magne_samples.f90:40)
    header_cols = "# N, smaple, time, m_x, e, m_y, A"
    if cfg.track_correlation:
        order += ("corr",)
        header_cols += ", corr"
    out.write(header_cols + "\n")
    for s in range(cfg.tot_sample):
        series = runner(rng.sample_key(base, s))
        series = {k: v[0].cpu().numpy().astype(np.float64)
                  for k, v in series.items()}
        datfmt.write_sample_series(out, model.nsites, s + 1,
                                   _filter_times(series, cfg), order=order,
                                   times=cfg.measure_times)
        progress(s + 1, cfg.tot_sample)


def run_finite_magne_samples(cfg: RunConfig, out: IO[str] = sys.stdout,
                             err: IO[str] = sys.stderr,
                             device="cuda") -> None:
    """..._finite_magne_samples: :func:`run_samples` with the
    finite-magnetisation preparation."""
    run_samples(dataclasses.replace(cfg, init_state="finite_magne"), out,
                err, device)


PROTOCOLS = {
    "relaxation": run_relaxation,
    "from_disorder": run_from_disorder,
    "finite_magne": run_finite_magne,
    "finite_magne_samples": run_finite_magne_samples,
    "samples": run_samples,
}
