"""Monte Carlo schedules of the bit-packed engines and the periodic XY one.

Port of the multispin part of
``cuda_fortran_mc_simulation_spin_tpu/engine/sweep.py``
(``_host_chunk_runner``, ``_make_packed_runner``,
``make_multispin_runner``, ``make_multispin3d_runner``,
``make_clock_multispin_runner``, ``make_helical_runner`` with its packed,
dense and masked branches in the JAX package's order, the generic runners
``make_sample_runner``, ``make_batch_runner`` and
``make_multisweep_runner`` on the int8 Ising 2-D and 3-D and int8 clock
kernels and, for the helical models, on the masked helical kernels,
``xy_padded_eligible`` / ``make_xy_padded_runner`` as
:func:`make_xy_runner` (component or, under ``SPINLAT_XY_PERIODIC_ANGLE=1``,
f32-angle planes), and the XY disorder runners of ``engine/protocols.py``,
``_xy_disorder_batched_runner``, ``_xy_disorder_resident_runner``,
``_xy_disorder_padded_runner`` (its angle branch) and
``_xy_disorder_multisweep_runner`` (int16 angles, under
``SPINLAT_XY_ANGLE_MS=1``), in the route order of its
``_run_xy_disorder``, as :func:`make_xy_disorder_runner`).
A ``lax.scan`` there is a Python loop over kernel launches here.  The JAX runner sizes its dispatches from TPU
rates to stay under the TPU worker's deadline; the port has no such
deadline and chunks by a fixed sweep count (``DEFAULT_CHUNK`` = 64, the
multisweep kernel's S).  Sweep keys are pure functions of the global
sweep index, so the result is bitwise independent of the chunk.

Keying: sweep t of the call keyed by ``call_key`` uses
``rng.sweep_key(call_key, t)``; the initial state of replica r uses
``fold_in(rng.init_key(call_key), r)``, as in the JAX package.
"""

from __future__ import annotations

import functools
import os
from typing import Callable

import torch

from cuda_fortran_mc_simulation_spin_tpu_torch.core import rng
from cuda_fortran_mc_simulation_spin_tpu_torch.models.clock import Clock2D
from cuda_fortran_mc_simulation_spin_tpu_torch.models.clock_helical import (
    Clock2DHelical,
)
from cuda_fortran_mc_simulation_spin_tpu_torch.models.ising2d import Ising2D
from cuda_fortran_mc_simulation_spin_tpu_torch.models.ising2d_helical import (
    Ising2DHelical,
)
from cuda_fortran_mc_simulation_spin_tpu_torch.models.ising3d import Ising3D
from cuda_fortran_mc_simulation_spin_tpu_torch.models.ising3d_helical import (
    Ising3DHelical,
)
from cuda_fortran_mc_simulation_spin_tpu_torch.models.xy2d import (
    XY2D,
    XYState,
)
from cuda_fortran_mc_simulation_spin_tpu_torch.models.xy2d_helical import (
    XY2DHelical,
)
from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
    clock3_multispin,
    clock4_multispin,
    clock_helical_multispin,
    clock_measure_pallas,
    clock_multispin,
    clock_multisweep,
    clock_pallas,
    clock_planes,
    helical3d_multispin,
    helical_multispin,
    helical_pallas,
    ising2d_measure_pallas,
    ising2d_multispin,
    ising2d_multisweep,
    ising2d_pallas,
    ising3d_multispin,
    ising3d_pallas,
    multispin_rng,
    xy2d_helical_dense,
    xy2d_helical_dense_angle,
    xy2d_measure_pallas,
    xy2d_multisweep,
    xy2d_pallas,
    xy2d_pallas_angle,
    xy2d_resident,
)

DEFAULT_CHUNK = 64


def _tag(run, name: str):
    """Stamp the runner with the engine it routes to (emitted as the
    `# engine:` line and a registry field)."""
    run.engine = name
    return run


def _host_chunk_runner(init_fn, chunk_fn, mcs: int, dispatch_chunk: int):
    """`init_fn(key) -> carry`; `chunk_fn(carry, key, t0, size) ->
    (carry, {k: (batch, size)})`.  Returns `run(call_key) -> {k: (batch,
    mcs)}` looping chunks of at most ``dispatch_chunk`` sweeps."""
    def run(call_key: torch.Tensor) -> dict[str, torch.Tensor]:
        carry = init_fn(call_key)
        parts, t0 = [], 0
        while t0 < mcs:
            size = min(dispatch_chunk, mcs - t0)
            carry, part = chunk_fn(carry, call_key, t0, size)
            parts.append(part)
            t0 += size
        return {k: torch.cat([p[k] for p in parts], dim=1) for k in parts[0]}

    return run


def _init_state(model, init_kind: str, batch: int, call_key, device):
    """Initial state of a batch of replicas (CheckerboardState, XYState,
    or flat states for a helical model); replica r of a random start is
    keyed by fold_in(init_key, r)."""
    if init_kind == "allup":
        return model.init_state("allup", device=device, batch=(batch,))
    keys = rng.fold_in(rng.init_key(call_key),
                       torch.arange(batch, dtype=torch.int64))
    states = [model.init_state(init_kind, keys[r], device=device)
              for r in range(batch)]
    if isinstance(states[0], torch.Tensor):
        return torch.stack(states)
    return type(states[0])(*(torch.stack(p) for p in zip(*states)))


def _init_planes(model, init_kind: str, batch: int, call_key, device,
                 pack=ising2d_multispin.pack_color):
    """Packed (wa, wb) initial planes (2-D) or volumes (3-D) of a batch of
    replicas; the 3-D layout packs along y exactly as the 2-D one, and
    the clock engines pass their ``pack`` (a plane tuple a colour)."""
    state = _init_state(model, init_kind, batch, call_key, device)
    return pack(state.a), pack(state.b)


def _init_helical_planes(model, init_kind: str, batch: int, call_key,
                         device, pack=helical_multispin.pack_flat):
    """Packed (wa, wb) flat colour vectors of a batch of helical replicas,
    keyed as :func:`_init_planes` keys them (the helical clock engine
    passes its triplet ``pack``)."""
    flat = _init_state(model, init_kind, batch, call_key, device)
    m = model.nsites // 2
    a, b = helical_multispin.split_flat(flat)
    return pack(a, m), pack(b, m)


def _make_packed_runner(model, mcs: int, batch: int, init_kind: str,
                        resident: bool, device, chunk: int,
                        multisweep=ising2d_multispin.multisweep_packed,
                        sweep_measure=ising2d_multispin.sweep_measure_seeded,
                        init_planes=_init_planes):
    """Init + pack once (``init_planes``), then chunks of either
    ``multisweep(model, wa, wb, key, size, t0)`` calls (``resident``) or
    streamed ``sweep_measure`` phase pairs, with the per-sweep fused (m, e)
    either way; the defaults are the 2-D engine's entries,
    ops/ising3d_multispin.py has the 3-D ones and ops/helical_multispin.py
    and ops/helical3d_multispin.py the helical ones."""

    def init_fn(call_key):
        return init_planes(model, init_kind, batch, call_key, device)

    if resident:
        def chunk_fn(c, call_key, t0, size):
            wa, wb, obs = multisweep(model, c[0], c[1], call_key, size,
                                     t0=t0)
            return (wa, wb), obs
    else:
        def chunk_fn(c, call_key, t0, size):
            # the chunk's phase keys in one batched derivation on the host
            seeds = ising2d_multispin.sweep_seed_pairs(call_key, size, t0)
            wa, wb = c
            series = {"m": [], "e": []}
            for j in range(size):
                wa, wb, obs = sweep_measure(model, wa, wb, seeds[j])
                for k in series:
                    series[k].append(obs[k])
            return (wa, wb), {k: torch.stack(v, dim=1)
                              for k, v in series.items()}

    return _host_chunk_runner(init_fn, chunk_fn, mcs, chunk)


def make_multispin_runner(model, mcs: int, batch: int,
                          init_kind: str = "allup", device="cuda"
                          ) -> Callable[[torch.Tensor], dict[str, torch.Tensor]]:
    """`run(call_key) -> {m, e: (batch, mcs) float64}` on the bit-packed
    kernels.  Batches within the multisweep bound run S-sweep multisweep
    launches; larger ones stream phase pairs."""
    resident = ising2d_multispin.multisweep_fits(batch, *model.color_shape)
    return _tag(_make_packed_runner(
        model, mcs, batch, init_kind, resident, device, DEFAULT_CHUNK,
    ), "ising2d_multispin bit-packed "
       + ("(resident multisweep)" if resident
          else "(streaming phase pairs)"))


def make_multispin3d_runner(model, mcs: int, batch: int,
                            init_kind: str = "allup", device="cuda"
                            ) -> Callable[[torch.Tensor], dict[str, torch.Tensor]]:
    """3-D counterpart of :func:`make_multispin_runner`
    (ops/ising3d_multispin.py): batches within the multisweep bound run
    S-sweep multisweep launches; larger ones stream z-plane phase pairs."""
    resident = ising3d_multispin.multisweep3d_fits(batch, *model.color_shape)
    return _tag(_make_packed_runner(
        model, mcs, batch, init_kind, resident, device, DEFAULT_CHUNK,
        multisweep=ising3d_multispin.multisweep_packed3d,
        sweep_measure=ising3d_multispin.sweep_measure_seeded3d,
    ), "ising3d_multispin bit-packed "
       + ("(resident multisweep)" if resident
          else "(streaming z-plane phases)"))


# ---------------------------------------------------------------------------
# the generic runners on the int8 Ising and clock kernels (JAX sweep.py:83,
# :159, :593)
# ---------------------------------------------------------------------------

def _int8_ops(model):
    """The int8 phase module of a periodic Ising or clock model."""
    if isinstance(model, Ising3D):
        return ising3d_pallas
    if isinstance(model, Ising2D):
        return ising2d_pallas
    if isinstance(model, Clock2D):
        return clock_pallas
    raise ValueError(f"{model!r} has no int8 phase kernel in the port")


def _int8_measure(model, st) -> torch.Tensor:
    """The measure kernel's sums of a replica batch: (R, 2) int64 (m, e)
    of an Ising model, (R, 3) float64 (Σ cos, Σ sin, E) of a clock one."""
    if isinstance(model, Clock2D):
        return clock_measure_pallas.measure_sums(*st, model.q)
    return ising2d_measure_pallas.measure_sums(*st)


def _int8_densities(model, sums: torch.Tensor) -> dict[str, torch.Tensor]:
    """{m, e} (Ising) or {m, my, e} (clock) float64 densities."""
    mod = (clock_measure_pallas if isinstance(model, Clock2D)
           else ising2d_measure_pallas)
    return mod.densities(sums, model.nsites)


def make_batch_runner(model, mcs: int, batch: int, init_kind: str = "allup",
                      device="cuda", chunk: int = DEFAULT_CHUNK
                      ) -> Callable[[torch.Tensor], dict[str, torch.Tensor]]:
    """`run(call_key) -> {m, e: (batch, mcs) float64}` (clock: also {my})
    advancing a replica batch a sweep at a time on the int8 phase kernels
    (ops/ising2d_pallas.py, ops/ising3d_pallas.py or ops/clock_pallas.py)
    and measuring it with the measure kernel (ops/ising2d_measure_pallas.py
    or ops/clock_measure_pallas.py), the kernels behind the JAX models'
    ``sweep_batched`` and ``observables_batched`` that the JAX package's
    ``make_batch_runner`` calls.  Sweep t draws under
    ``rng.sweep_key(call_key, t)`` and its phase p under
    ``seeds_from_key(., p)``, the keys of a chunk in one batched derivation,
    so a run is bitwise independent of ``chunk``.  JAX's ``prepare`` and
    ``measure`` hooks serve only the XY model, whose runners are
    :func:`make_xy_runner` and :func:`make_xy_disorder_runner`.  The
    helical models' phases are the JAX models' masked ``sweep``: the
    helical 2-D ones run :func:`make_masked_runner` (the masked helical
    kernels, with the fused sums; XY also {my}), helical 3-D its helical
    kernels (:func:`make_helical_runner`)."""
    if isinstance(model, HELICAL_2D):
        return _tag(make_masked_runner(model, mcs, batch, init_kind, device,
                                       chunk=chunk), "phase engine (batched)")
    if isinstance(model, Ising3DHelical):
        return _tag(make_helical_runner(model, mcs, batch, init_kind,
                                        device), "phase engine (batched)")
    ops = _int8_ops(model)

    def init_fn(call_key):
        return _init_state(model, init_kind, batch, call_key, device)

    def chunk_fn(st, call_key, t0, size):
        seeds = multispin_rng.sweep_phase_keys(call_key, size, t0)
        sums = []
        for j in range(size):
            st = ops.sweep_seeded(model, st, seeds[j])
            sums.append(_int8_measure(model, st))
        return st, _int8_densities(model, torch.stack(sums, dim=1))

    return _tag(_host_chunk_runner(init_fn, chunk_fn, mcs, chunk),
                "phase engine (batched)")


def make_sample_runner(model, mcs: int, init_kind: str = "allup",
                       device="cuda", chunk: int = DEFAULT_CHUNK
                       ) -> Callable[[torch.Tensor], dict[str, torch.Tensor]]:
    """`run(sample_key) -> {m, e: (mcs,) float64}` for one history: the
    JAX package's ``make_sample_runner``, on the kernels of
    :func:`make_batch_runner` with one replica.  The history is replica 0
    of its key (its start keyed by fold_in(init_key, 0)), so it equals the
    batched and multisweep runners' replica 0 bitwise."""
    run = make_batch_runner(model, mcs, 1, init_kind, device, chunk)

    def one(sample_key: torch.Tensor) -> dict[str, torch.Tensor]:
        return {k: v[0] for k, v in run(sample_key).items()}

    return _tag(one, "phase engine (single history)")


def make_multisweep_runner(model, mcs: int, batch: int,
                           init_kind: str = "allup", device="cuda",
                           chunk: int = DEFAULT_CHUNK
                           ) -> Callable[[torch.Tensor],
                                         dict[str, torch.Tensor]]:
    """`run(call_key) -> {m, e: (batch, mcs) float64}` (clock: also {my})
    on the int8 multisweep kernel (ops/ising2d_multisweep.py, or
    ops/clock_multisweep.py for the clock, JAX ``sweep.py:593-636``): one
    launch of up to ``chunk`` sweeps with the fused sums of each, as the
    JAX package's ``make_multisweep_runner``.  Its sweeps draw the words of
    :func:`make_batch_runner`'s, so the two give the same states bitwise
    (Ising: the same series; clock: sums to float64 rounding)."""
    if isinstance(model, Clock2D):
        ms = clock_multisweep.multisweep
    elif isinstance(model, Ising2D):
        ms = ising2d_multisweep.multisweep
    else:
        raise ValueError(f"{model!r}: the int8 multisweep serves Ising2D "
                         "and Clock2D")

    def init_fn(call_key):
        return _init_state(model, init_kind, batch, call_key, device)

    def chunk_fn(st, call_key, t0, size):
        return ms(model, st, call_key, size, t0)

    return _tag(_host_chunk_runner(init_fn, chunk_fn, mcs, chunk),
                "int8 multisweep (cooperative)")


CLOCK_SPECS = {6: clock_multispin.SPEC, 4: clock4_multispin.SPEC,
               3: clock3_multispin.SPEC}


def clock_route(model) -> tuple[clock_planes.PlaneSpec, bool] | None:
    """(spec, padded) of the packed clock engine that serves ``model``
    (the JAX package's aligned and padded gates), or None; None too under
    the JAX package's ``SPINLAT_CLOCK_PACKED=0`` (its ``protocols.py:
    149``), which sends every clock to the int8 kernels."""
    spec = CLOCK_SPECS.get(model.q)
    if spec is None or os.environ.get("SPINLAT_CLOCK_PACKED") == "0":
        return None
    if clock_planes.packable_gate(spec, model):
        return spec, False
    if clock_planes.padded_packable_gate(spec, model):
        return spec, True
    return None


def make_clock_multispin_runner(model, mcs: int, batch: int,
                                init_kind: str = "allup", device="cuda"
                                ) -> Callable[[torch.Tensor],
                                              dict[str, torch.Tensor]]:
    """`run(call_key) -> {m, e: (batch, mcs) float64}` on the bit-sliced
    packed clock engine of ``model.q`` (ops/clock_planes.py): streamed
    phase pairs, the measuring one second, as the JAX package's only
    clock route.  Aligned shapes and the padded ones (the reference's
    literal 2000x2000) share one kernel; the port keeps (nyw, half)
    planes for both."""
    route = clock_route(model)
    if route is None:
        raise ValueError(f"{model.nx}x{model.ny} q={model.q} is neither "
                         "aligned- nor padded-packable")
    spec, padded = route
    return _tag(_make_packed_runner(
        model, mcs, batch, init_kind, False, device, DEFAULT_CHUNK,
        sweep_measure=functools.partial(clock_planes.sweep_measure_seeded,
                                        spec),
        init_planes=functools.partial(_init_planes, pack=spec.pack_color),
    ), f"clock q={model.q} bit-sliced packed"
       + (" (padded)" if padded else ""))


HELICAL_2D = (Ising2DHelical, Clock2DHelical, XY2DHelical)
MASKED_ISING = "helical_pallas multisweep (masked Ising)"
MASKED_CLOCK = "helical_pallas multisweep (masked clock)"
MASKED_XY = "helical_pallas XY (masked streaming)"


def helical_masked(model) -> bool:
    """A helical 2-D model goes to the masked kernels: the JAX package's
    order, the packed (Ising, q = 6 clock) or dense (XY) engine first where
    its gate takes the shape and its switch (``SPINLAT_HELICAL_PACKED``,
    ``SPINLAT_CLOCK_HELICAL_PACKED``, ``SPINLAT_XY_DENSE``) is not 0, else
    the masked ones (JAX ``sweep.py:680-702``, ``:810``, ``:955-987``)."""
    if isinstance(model, XY2DHelical):
        return (not xy2d_helical_dense.fits(model)
                or helical_pallas.switched_off("SPINLAT_XY_DENSE"))
    if isinstance(model, Clock2DHelical):
        return (not clock_helical_multispin.fits(model)
                or helical_pallas.switched_off("SPINLAT_CLOCK_HELICAL_PACKED"))
    if isinstance(model, Ising2DHelical):
        return (not helical_multispin.fits(model)
                or helical_pallas.switched_off("SPINLAT_HELICAL_PACKED"))
    return False


def make_masked_runner(model, mcs: int, batch: int, init_kind: str = "allup",
                       device="cuda", n_over_relax: int = 0,
                       mcs_over_relax: int = 0, chunk: int = DEFAULT_CHUNK
                       ) -> Callable[[torch.Tensor], dict[str, torch.Tensor]]:
    """`run(call_key) -> {m, e: (batch, mcs) float64}` (clock, XY: also
    {my}) on the masked helical kernels (ops/helical_pallas.py), the
    masked branches of the JAX package's ``make_helical_runner``
    (``sweep.py:886-942``, ``:1015-1040``) on flat (R, N) states: Ising and
    clock one multisweep launch of up to ``chunk`` sweeps with the sums of
    each; XY streamed out-of-place phases, with no over-relaxation a
    Metropolis sweep whose colour-1 phase measures, else a Metropolis
    sweep, for t <= mcs_over_relax (default mcs) ``n_over_relax``
    over-relaxation sweeps, and the measure launch, as JAX measures with
    ``xy_observables_packed``.  Keys follow the global sweep index, so a
    run is bitwise independent of ``chunk``."""
    if isinstance(model, XY2DHelical):
        mcs_or = mcs_over_relax or mcs

        def init_xy(call_key):
            return helical_pallas.XYPlanes(
                _init_state(model, init_kind, batch, call_key, device))

        def chunk_xy(planes, call_key, t0, size):
            seeds = multispin_rng.sweep_phase_keys(call_key, size, t0)
            series = {"m": [], "my": [], "e": []}
            for j in range(size):
                if n_over_relax == 0:
                    obs = helical_pallas.xy_sweep_measure(model, planes,
                                                          seeds[j])
                else:
                    helical_pallas.xy_sweep(model, planes, seeds[j])
                    if t0 + j + 1 <= mcs_or:
                        for _ in range(n_over_relax):
                            helical_pallas.xy_over_relax_sweep(model, planes)
                    obs = helical_pallas.xy_observables(model, planes)
                for k in series:
                    series[k].append(obs[k])
            return planes, {k: torch.stack(v, dim=1)
                            for k, v in series.items()}

        return _tag(_host_chunk_runner(init_xy, chunk_xy, mcs, chunk),
                    MASKED_XY)
    if not isinstance(model, (Ising2DHelical, Clock2DHelical)):
        raise ValueError(f"{model!r}: the masked helical kernels serve the "
                         "helical 2-D models")

    def init_fn(call_key):
        return _init_state(model, init_kind, batch, call_key, device)

    def chunk_fn(flat, call_key, t0, size):
        return helical_pallas.multisweep(model, flat, call_key, size, t0)

    return _tag(_host_chunk_runner(init_fn, chunk_fn, mcs, chunk),
                MASKED_CLOCK if isinstance(model, Clock2DHelical)
                else MASKED_ISING)


def make_helical_runner(model, mcs: int, batch: int,
                        init_kind: str = "allup", device="cuda",
                        n_over_relax: int = 0, mcs_over_relax: int = 0
                        ) -> Callable[[torch.Tensor], dict[str, torch.Tensor]]:
    """`run(call_key) -> {m, e: (batch, mcs) float64}` on the helical
    kernels, keyed by the global sweep index as the periodic runners are,
    in the JAX package's order (:func:`helical_masked`).  2-D Ising
    (ops/helical_multispin.py): one flat even/odd bit-packed multisweep
    launch per chunk of sweeps.  3-D (ops/helical3d_multispin.py): the
    resident multisweep where ``helical3d_multispin.fits`` (odd nx·ny,
    151^3), else streamed (sub-)phase launches (501^3, and 1001x1000x1000
    with its four z-parity sub-phases and an energy launch a sweep).  q=6
    clock (ops/clock_helical_multispin.py): one bit-sliced resident
    multisweep launch per chunk.  XY (:func:`make_xy_helical_runner`, also
    {my}): the dense engines' streamed phases, with ``n_over_relax`` /
    ``mcs_over_relax``.  Every other helical 2-D shape, q and switch:
    :func:`make_masked_runner`."""
    if isinstance(model, HELICAL_2D) and helical_masked(model):
        return make_masked_runner(model, mcs, batch, init_kind, device,
                                  n_over_relax, mcs_over_relax)
    if isinstance(model, XY2DHelical):
        return make_xy_helical_runner(model, mcs, batch, init_kind,
                                      n_over_relax, mcs_over_relax, device)
    if isinstance(model, Clock2DHelical):
        return _tag(_make_packed_runner(
            model, mcs, batch, init_kind, True, device, DEFAULT_CHUNK,
            multisweep=clock_helical_multispin.multisweep,
            init_planes=functools.partial(
                _init_helical_planes,
                pack=clock_helical_multispin.pack_clock_flat),
        ), "clock_helical_multispin (bit-sliced packed)")
    if isinstance(model, Ising3DHelical):
        resident = helical3d_multispin.fits(model)
        # both routes advance a chunk in one call with the fused (m, e)
        return _tag(_make_packed_runner(
            model, mcs, batch, init_kind, True, device, DEFAULT_CHUNK,
            multisweep=(helical3d_multispin.multisweep if resident
                        else helical3d_multispin.multisweep_stream),
            init_planes=_init_helical_planes,
        ), "helical3d_multispin " + ("(resident multisweep)" if resident
                                     else "(streamed phases)"))
    return _tag(_make_packed_runner(
        model, mcs, batch, init_kind, True, device, DEFAULT_CHUNK,
        multisweep=helical_multispin.multisweep,
        init_planes=_init_helical_planes,
    ), "helical_multispin (flat even/odd bit-packed)")


XY_ENGINE = "xy2d periodic component planes (CUDA phases)"
XY_HELICAL_ANGLE = "xy2d_helical_dense_angle f32-angle planes (CUDA phases)"
XY_HELICAL_COMPONENT = ("xy2d_helical_dense ragged dual-colour component "
                        "planes (CUDA phases)")


def xy_helical_engine():
    """(module, tag) of the dense helical XY engine: the f32-angle one by
    default, as in the JAX package; ``SPINLAT_XY_DENSE_ANGLE=0`` selects
    the component one, as there (its ``sweep.py:822``)."""
    if os.environ.get("SPINLAT_XY_DENSE_ANGLE", "1") == "1":
        return xy2d_helical_dense_angle, XY_HELICAL_ANGLE
    return xy2d_helical_dense, XY_HELICAL_COMPONENT


def make_xy_helical_runner(model, mcs: int, batch: int,
                           init_kind: str = "allup", n_over_relax: int = 0,
                           mcs_over_relax: int = 0, device="cuda",
                           chunk: int = DEFAULT_CHUNK
                           ) -> Callable[[torch.Tensor],
                                         dict[str, torch.Tensor]]:
    """`run(call_key) -> {m, my, e: (batch, mcs) float64}` on the dense
    helical XY engine of :func:`xy_helical_engine`, with the schedule of
    the XY branch of the JAX package's ``make_helical_runner``
    (``sweep.py:768-822``; the reference's xy2d_gpu_relaxation.f90 and
    xy2d_gpu_over_relaxation.f90): with no over-relaxation a Metropolis
    sweep whose phase b measures; otherwise a Metropolis sweep, then for
    t <= mcs_over_relax (default mcs) n_over_relax - 1 OR sweeps and one
    whose second colour phase measures, and for later t the observables
    of the state (plain PyTorch).  The initial flat state of replica r is
    keyed by fold_in(init_key, r) and packed once; phase keys of a chunk
    come from one batched derivation keyed by the global sweep index, so a
    run is bitwise independent of ``chunk``."""
    if not isinstance(model, XY2DHelical):
        raise ValueError(f"{model!r} is not a helical XY model")
    if not xy2d_helical_dense.fits(model):
        raise ValueError(f"helical XY {model.nx}x{model.ny} is outside the "
                         "dense engines' gate (odd nx, even ny)")
    mod, tag = xy_helical_engine()
    mcs_or = mcs_over_relax or mcs

    def init_fn(call_key):
        flat = _init_state(model, init_kind, batch, call_key, device)
        return mod.pack_state(flat, model.ny, model.nx)

    def chunk_fn(planes, call_key, t0, size):
        seeds = multispin_rng.sweep_phase_keys(call_key, size, t0)
        series = {"m": [], "my": [], "e": []}
        for j in range(size):
            if n_over_relax == 0:
                planes, obs = mod.sweep_measure(model, planes, seeds[j])
            else:
                planes = mod.sweep(model, planes, seeds[j])
                if t0 + j + 1 <= mcs_or:
                    for _ in range(n_over_relax - 1):
                        planes = mod.over_relax_sweep(model, planes)
                    planes, obs = mod.over_relax_sweep_measure(model, planes)
                else:
                    obs = mod.observables(model, planes)
            for k in series:
                series[k].append(obs[k])
        return planes, {k: torch.stack(v, dim=1) for k, v in series.items()}

    return _tag(_host_chunk_runner(init_fn, chunk_fn, mcs, chunk), tag)


def periodic_angle() -> bool:
    """The JAX package's ``SPINLAT_XY_PERIODIC_ANGLE`` switch set to 1:
    the periodic XY relaxation and streamed disorder runners take the
    f32-angle engine (ops/xy2d_pallas_angle.py).  Unset or 0 they keep
    component planes, the route JAX itself takes off the TPU (its
    ``sweep.py:1117``, ``protocols.py:792``)."""
    return os.environ.get("SPINLAT_XY_PERIODIC_ANGLE") == "1"


XY_ANGLE_ENGINE = "xy2d periodic f32-angle planes (CUDA phases)"

# the engines of the periodic XY relaxation: (sweep, or_sweep,
# or_sweep_measured, sweep_measured) on the runner's state
_XY_COMPONENT_OPS = (xy2d_pallas.sweep, xy2d_pallas.or_sweep,
                     xy2d_pallas.or_sweep_measured,
                     xy2d_pallas.sweep_measured)
_XY_ANGLE_OPS = (xy2d_pallas_angle.sweep_angle,
                 xy2d_pallas_angle.or_sweep_angle,
                 xy2d_pallas_angle.or_sweep_measure_angle,
                 xy2d_pallas_angle.sweep_measure_angle)


def make_xy_runner(model, mcs: int, batch: int, init_kind: str = "allup",
                   n_over_relax: int = 0, mcs_over_relax: int = 0,
                   device="cuda", chunk: int = DEFAULT_CHUNK
                   ) -> Callable[[torch.Tensor], dict[str, torch.Tensor]]:
    """`run(call_key) -> {m, my, e: (batch, mcs) float64}` on the periodic
    XY phase kernels, with the schedule of the JAX package's
    ``make_xy_padded_runner`` (the reference app
    ``xy2d_periodic_gpu_over_relaxation.f90``, lines 42-45): for
    t <= mcs_over_relax (default mcs) with n_over_relax > 0, a Metropolis
    sweep, n_over_relax - 1 over-relaxation sweeps and one whose colour-1
    phase measures; otherwise a Metropolis sweep whose phase b measures.
    Phase keys of a chunk come from one batched derivation keyed by the
    global sweep index, so a run is bitwise independent of ``chunk``.
    It serves every periodic XY2D (even nx and ny) on unpadded
    (R, ny, nx/2) planes: component planes (ops/xy2d_pallas.py), or under
    :func:`periodic_angle` float32 angle planes (ops/xy2d_pallas_angle.py,
    packed once from the initial state), as the JAX package's switch
    chooses between its two engines (``sweep.py:1142-1163``)."""
    if not isinstance(model, XY2D):
        raise ValueError(f"{model!r} is not a periodic XY model")
    mcs_or = mcs_over_relax or mcs
    angle = periodic_angle()
    sweep, or_sweep, or_sweep_measured, sweep_measured = (
        _XY_ANGLE_OPS if angle else _XY_COMPONENT_OPS)

    def init_fn(call_key):
        st = _init_state(model, init_kind, batch, call_key, device)
        return xy2d_pallas_angle.pack_angles(st) if angle else st

    def chunk_fn(st, call_key, t0, size):
        seeds = multispin_rng.sweep_phase_keys(call_key, size, t0)
        series = {"m": [], "my": [], "e": []}
        for j in range(size):
            if n_over_relax > 0 and t0 + j + 1 <= mcs_or:
                st = sweep(model, st, seeds[j])
                for _ in range(n_over_relax - 1):
                    st = or_sweep(model, st)
                st, obs = or_sweep_measured(model, st)
            else:
                st, obs = sweep_measured(model, st, seeds[j])
            for k in series:
                series[k].append(obs[k])
        return st, {k: torch.stack(v, dim=1) for k, v in series.items()}

    return _tag(_host_chunk_runner(init_fn, chunk_fn, mcs, chunk),
                XY_ANGLE_ENGINE if angle else XY_ENGINE)


# the XY disorder protocols' preparations (JAX ``_xy_init_for_prep``)
XY_PREPS = ("rotate_first", "fix1mcs", "finite_magne", "small_magne",
            "near_magne")


def xy_prepared(model, prep: str, batch: int, call_key, device,
                init_magne: float = 0.02, near_magne_tol: float = 0.01
                ) -> tuple[XYState, XYState]:
    """(state, t=0 snapshot) of a batch of replicas under ``prep``, replica
    r keyed by fold_in(init_key(call_key), r): ``rotate_first`` a random
    start rotated so m lies along +x (the from-disorder app), ``fix1mcs``
    a random start (rotated after the first sweep), ``finite_magne``,
    ``small_magne`` and ``near_magne`` the model's preparations."""
    keys = rng.fold_in(rng.init_key(call_key),
                       torch.arange(batch, dtype=torch.int64))
    if prep in ("rotate_first", "fix1mcs"):
        st = model.random_states(keys, device)
        if prep == "rotate_first":
            st = model.rotate_magne_toward_xaxis(st)
    elif prep == "finite_magne":
        st = model.prep_finite_magne(keys, init_magne, device=device)
    elif prep == "small_magne":
        st = model.prep_small_magne(keys, init_magne, device=device)
    elif prep == "near_magne":
        st = model.prep_small_magne(keys, init_magne, tol=near_magne_tol,
                                    device=device)
    else:
        raise ValueError(f"unknown preparation {prep!r}")
    return st, XYState(*(p.clone() for p in st))


XY_DISORDER_RESIDENT = "xy2d disorder component planes (resident multisweep)"
XY_DISORDER_STREAMED = "xy2d disorder component planes (streamed phases)"
XY_DISORDER_ANGLE = "xy2d disorder f32-angle planes (streamed phases)"
XY_DISORDER_INT16 = "xy2d disorder int16-angle planes (multisweep, opt-in)"


def xy_angle_ms() -> bool:
    """The JAX package's opt-in ``SPINLAT_XY_ANGLE_MS=1``."""
    return os.environ.get("SPINLAT_XY_ANGLE_MS") == "1"


def xy_multisweep_eligible(model, prep: str, mcs: int, n_over_relax: int,
                           mcs_over_relax: int,
                           track_correlation: bool) -> bool:
    """JAX's ``_xy_multisweep_eligible`` (its ``protocols.py:562-590``),
    the gate of the int16-angle multisweep: only under
    ``SPINLAT_XY_ANGLE_MS=1``; no ``track_correlation``; under
    over-relaxation only the full schedule (``mcs_over_relax`` 0 or mcs)
    and not with fix1mcs; and JAX's own bounds, ``fits_vmem`` (the four
    int16 planes of a replica within 9 MiB) and ny a multiple of 16.  The
    same bounds as JAX's, so that one command line selects the same
    engine in both packages (the literal 1500x1500, ny % 16 = 12, takes
    the streamed route in both)."""
    if not xy_angle_ms() or track_correlation:
        return False
    if n_over_relax > 0 and (mcs_over_relax not in (0, mcs)
                             or prep == "fix1mcs"):
        return False
    ny, half = model.color_shape
    return xy2d_multisweep.fits(ny, half) and ny % 16 == 0


def xy_disorder_route(model, batch: int, prep: str, mcs: int,
                      n_over_relax: int = 0, mcs_over_relax: int = 0,
                      track_correlation: bool = False) -> str:
    """The engine tag of the disorder runner, in JAX's route order
    (``protocols.py:1010-1030``): the resident multisweep where it serves
    the run, unless ``SPINLAT_XY_ANGLE_MS=1`` sets it aside (as JAX's
    ``_xy_resident_eligible`` does); then the int16-angle multisweep where
    :func:`xy_multisweep_eligible` takes the run; else streamed phases,
    on angle planes under :func:`periodic_angle` unless
    ``track_correlation`` (JAX's padded runner refuses it), else on
    component planes."""
    if (n_over_relax == 0 and not track_correlation and not xy_angle_ms()
            and xy2d_resident.fits(model, batch)):
        return XY_DISORDER_RESIDENT
    if xy_multisweep_eligible(model, prep, mcs, n_over_relax,
                              mcs_over_relax, track_correlation):
        return XY_DISORDER_INT16
    if periodic_angle() and not track_correlation:
        return XY_DISORDER_ANGLE
    return XY_DISORDER_STREAMED


def make_xy_disorder_runner(model, mcs: int, batch: int, prep: str, *,
                            init_magne: float = 0.02,
                            near_magne_tol: float = 0.01,
                            n_over_relax: int = 0, mcs_over_relax: int = 0,
                            track_correlation: bool = False, device="cuda",
                            chunk: int = DEFAULT_CHUNK
                            ) -> Callable[[torch.Tensor],
                                          dict[str, torch.Tensor]]:
    """`run(call_key) -> {mx, my, e, A[, corr]: (batch, mcs) float64}`, the
    densities of the XY disorder protocols against the t=0 snapshot, on
    the periodic XY kernels, on the route of :func:`xy_disorder_route`
    with the schedules of the JAX package's ``_xy_disorder_batched_runner``
    and ``_xy_disorder_resident_runner`` (component planes),
    ``_xy_disorder_padded_runner`` (angle planes) and
    ``_xy_disorder_multisweep_runner`` (int16 angles) (the reference's
    from-disorder apps, xy2d_periodic_gpu_relaxation_from_disorder*.f90):

    - streamed, no over-relaxation: a Metropolis sweep whose phase b
      measures against the snapshot (``xy2d_pallas.sweep_measure``, or
      ``xy2d_pallas_angle.sweep_measure_snap_angle``);
    - streamed, ``n_over_relax`` > 0: a Metropolis sweep, while
      t <= ``mcs_over_relax`` (default mcs) n_over_relax over-relaxation
      sweeps, then ``xy2d_measure_pallas.measure`` (of the decoded planes
      on the angle route); on component planes later sweeps measure as
      above;
    - ``fix1mcs``: after sweep 1, state and snapshot rotated by
      -atan2(Σ S_y, Σ S_x) (angle planes decoded, rotated and packed
      again) and the row re-measured by ``measure``;
    - resident: one ``xy2d_resident`` multisweep launch a chunk, from t=1,
      or from t=2 after the streamed fix1mcs step;
    - int16: :func:`_xy_int16_runner`.

    Keys follow the global sweep index t, so a run is bitwise independent
    of ``chunk``, and the resident and streamed component routes draw the
    same words (the same state, and the same sums)."""
    if not isinstance(model, XY2D):
        raise ValueError(f"{model!r} is not a periodic XY model")
    if prep not in XY_PREPS:
        raise ValueError(f"unknown preparation {prep!r}")
    route = xy_disorder_route(model, batch, prep, mcs, n_over_relax,
                              mcs_over_relax, track_correlation)
    prepare = functools.partial(xy_prepared, model, prep, batch,
                                device=device, init_magne=init_magne,
                                near_magne_tol=near_magne_tol)
    if route == XY_DISORDER_INT16:
        return _tag(_xy_int16_runner(model, mcs, prep, n_over_relax,
                                     prepare, chunk), route)
    resident = route == XY_DISORDER_RESIDENT
    angle = route == XY_DISORDER_ANGLE
    fix1 = prep == "fix1mcs"
    mcs_or = mcs_over_relax or mcs

    def init_fn(call_key):
        # the call's phase keys in one batched derivation on the host: one
        # a chunk cost the host more than a 64-sweep multisweep launch at
        # one 1500x1500 replica takes on the card (PERF.md §6)
        st, snap = prepare(call_key=call_key)
        if angle:
            st = xy2d_pallas_angle.pack_angles(st)
            snap = xy2d_pallas_angle.pack_angles(snap)
        return st, snap, multispin_rng.sweep_phase_keys(call_key, mcs)

    def components(st, snap):
        if angle:
            return (xy2d_pallas_angle.unpack_angles(st),
                    xy2d_pallas_angle.unpack_angles(snap))
        return st, snap

    def rotate(st, snap):
        st, snap = components(st, snap)
        theta = -model.magne_angle(st)
        st, snap = model.rotate(st, theta), model.rotate(snap, theta)
        if angle:
            return (xy2d_pallas_angle.pack_angles(st),
                    xy2d_pallas_angle.pack_angles(snap))
        return st, snap

    def measure(st, snap):
        return xy2d_measure_pallas.measure(model, *components(st, snap))

    def one_sweep(st, snap, seeds_t, t):
        if n_over_relax > 0 and (angle or t <= mcs_or):
            if angle:
                st = xy2d_pallas_angle.sweep_angle(model, st, seeds_t)
            else:
                st = xy2d_pallas.sweep(model, st, seeds_t)
            if fix1 and t == 1:
                st, snap = rotate(st, snap)
            if t <= mcs_or:
                for _ in range(n_over_relax):
                    st = (xy2d_pallas_angle.or_sweep_angle(model, st) if angle
                          else xy2d_pallas.or_sweep(model, st))
            obs = measure(st, snap)
        else:
            if angle:
                st, obs = xy2d_pallas_angle.sweep_measure_snap_angle(
                    model, st, snap, seeds_t)
            else:
                st, obs = xy2d_pallas.sweep_measure(model, st, snap, seeds_t)
            if fix1 and t == 1:
                st, snap = rotate(st, snap)
                obs = measure(st, snap)
        if track_correlation:
            obs = dict(obs, corr=ising2d_multispin.per_site(
                model.correlation_sum(st), model.nsites))
        return st, snap, {k: v[:, None] for k, v in obs.items()}

    def chunk_fn(carry, call_key, t0, size):
        st, snap, keys = carry
        seeds = keys[t0:t0 + size]
        # sweeps streamed: all, or on the resident route fix1mcs's first
        streamed = int(fix1 and t0 == 0) if resident else size
        parts = []
        for j in range(streamed):
            st, snap, obs = one_sweep(st, snap, seeds[j], t0 + j + 1)
            parts.append(obs)
        if streamed < size:
            obs = xy2d_resident.multisweep_planes(st, snap, seeds[streamed:],
                                                  beta=model.beta)
            parts.append(xy2d_pallas.densities(model, obs))
        return (st, snap, keys), {k: torch.cat([p[k] for p in parts], dim=1)
                                  for k in parts[0]}

    return _tag(_host_chunk_runner(init_fn, chunk_fn, mcs, chunk), route)


def _xy_int16_runner(model, mcs: int, prep: str, n_over_relax: int,
                     prepare, chunk: int):
    """`run(call_key)` of the int16-angle route (JAX
    ``_xy_disorder_multisweep_runner``, its ``protocols.py:593-664``): the
    prepared state and snapshot converted to int16 angles, then one
    ``xy2d_multisweep`` launch of up to ``chunk`` sweeps (64 by default)
    a chunk, each sweep followed by ``n_over_relax`` over-relaxation
    sweeps; with fix1mcs, sweep 1, the rotation and its measurement on
    component planes first, as in JAX (``:633-640``).  Sweep t draws under
    the keys of the global index t (where JAX keys a launch), so a run is
    bitwise independent of ``chunk``."""
    fix1 = prep == "fix1mcs"

    def init_fn(call_key):
        st, snap = prepare(call_key=call_key)
        return st, snap, multispin_rng.sweep_phase_keys(call_key, mcs)

    def chunk_fn(carry, call_key, t0, size):
        st, snap, keys = carry
        parts = []
        if isinstance(st, XYState):
            if fix1:
                st = xy2d_pallas.sweep(model, st, keys[0])
                theta = -model.magne_angle(st)
                st, snap = model.rotate(st, theta), model.rotate(snap, theta)
                obs = xy2d_measure_pallas.measure(model, st, snap)
                parts.append({k: v[:, None] for k, v in obs.items()})
            st = xy2d_multisweep.state_to_angles(st)
            snap = xy2d_multisweep.state_to_angles(snap)
        first = t0 + len(parts)
        if first < t0 + size:
            obs = xy2d_multisweep.multisweep_planes(
                *st, *snap, keys[first:t0 + size], beta=model.beta,
                n_or=n_over_relax)
            parts.append(xy2d_pallas.densities(model, obs))
        return (st, snap, keys), {k: torch.cat([p[k] for p in parts], dim=1)
                                  for k in parts[0]}

    return _host_chunk_runner(init_fn, chunk_fn, mcs, chunk)
