"""Monte Carlo schedules of the bit-packed Ising2D engine.

Port of the multispin part of
``cuda_fortran_mc_simulation_spin_tpu/engine/sweep.py``
(``_host_chunk_runner``, ``_make_packed_runner``,
``make_multispin_runner``).  A ``lax.scan`` there is a Python loop over
kernel launches here.  The JAX runner sizes its dispatches from TPU
rates to stay under the TPU worker's deadline; the port has no such
deadline and chunks by a fixed sweep count (``DEFAULT_CHUNK`` = 64, the
multisweep kernel's S).  Sweep keys are pure functions of the global
sweep index, so the result is bitwise independent of the chunk.

Keying: sweep t of the call keyed by ``call_key`` uses
``rng.sweep_key(call_key, t)``; the initial state of replica r uses
``fold_in(rng.init_key(call_key), r)``, as in the JAX package.
"""

from __future__ import annotations

from typing import Callable

import torch

from cuda_fortran_mc_simulation_spin_tpu_torch.core import rng
from cuda_fortran_mc_simulation_spin_tpu_torch.models.base import (
    CheckerboardState,
)
from cuda_fortran_mc_simulation_spin_tpu_torch.ops import ising2d_multispin

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


def _init_planes(model, init_kind: str, batch: int, call_key, device):
    """Packed (wa, wb) initial planes of a batch of replicas."""
    if init_kind == "allup":
        state = model.init_state("allup", device=device, batch=(batch,))
    else:
        keys = rng.fold_in(rng.init_key(call_key),
                           torch.arange(batch, dtype=torch.int64))
        states = [model.init_state(init_kind, keys[r], device=device)
                  for r in range(batch)]
        state = CheckerboardState(torch.stack([s.a for s in states]),
                                  torch.stack([s.b for s in states]))
    return (ising2d_multispin.pack_color(state.a),
            ising2d_multispin.pack_color(state.b))


def _make_packed_runner(model, mcs: int, batch: int, init_kind: str,
                        resident: bool, device, chunk: int):
    """Init + pack once, then chunks of either multisweeps (``resident``)
    or streamed phase pairs, with the per-sweep fused (m, e) either way."""
    def init_fn(call_key):
        return _init_planes(model, init_kind, batch, call_key, device)

    if resident:
        def chunk_fn(c, call_key, t0, size):
            wa, wb, obs = ising2d_multispin.multisweep_packed(
                model, c[0], c[1], call_key, size, t0=t0)
            return (wa, wb), obs
    else:
        def chunk_fn(c, call_key, t0, size):
            # the chunk's phase keys in one batched derivation on the host
            seeds = ising2d_multispin.sweep_seed_pairs(call_key, size, t0)
            wa, wb = c
            series = {"m": [], "e": []}
            for j in range(size):
                wa, wb, obs = ising2d_multispin.sweep_measure_seeded(
                    model, wa, wb, seeds[j])
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
