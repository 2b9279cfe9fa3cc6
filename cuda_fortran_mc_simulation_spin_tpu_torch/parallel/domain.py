"""Lattice domain decomposition over a (dp, y[, x]) mesh: the Ising models.

Port of the Ising part of ``cuda_fortran_mc_simulation_spin_tpu/parallel/
domain.py``.  JAX runs one ``shard_map`` program over its mesh; here one
process holds every shard as a tensor of its own on its mesh device
(parallel/mesh.py) and drives them in turn:

- ``dp`` splits the replicas: shard (d, ., .) holds replicas d·R/dp ..;
- ``y`` splits the lattice's leading dimension, rows in 2-D and z-planes
  in 3-D, with halo exchange (parallel/halo.py);
- ``x`` (2-D only) splits the colour planes' columns, with column halos.

A phase exchanges the other colour's halos between all shards, then
launches the halo kernel of each shard: the packed ones
(ops/ising2d_multispin.sharded_phase_packed,
ops/ising3d_multispin.sharded_phase3d_packed) where the shape packs, the
int8 ones (ops/ising2d_pallas.sharded_phase, ops/ising3d_pallas.sharded_
phase) otherwise, their plain versions on CPU shards.  Phase b measures:
each shard's exact int64 (m, e) partials are summed in a fixed order (the
psum), so the densities are exact.  Every kernel keys its random words by
global coordinates, so a sharded trajectory equals the unsharded runner's
of the same engine (engine/sweep.py: the packed runners, or the int8
batched one) bit for bit at every mesh shape, which is more than the JAX
package's guarantee (invariance to the mesh shape on its jnp route).

A sharded state is a :class:`ShardedState`: per colour, a dict from the
shard's mesh coordinates (d, yi, xi) to its local block, int8 (R/dp, L,
w) planes or (R/dp, nz/y, ny, half) volumes, or their packed words.

Not ported here: the clock and XY models (ROADMAP.md A9, the next slice),
and JAX's separate observable pass (``_ising_local_obs``,
``_ising3d_local_obs``), which its jnp route needs and the port's fused
measuring phases replace on every route.
"""

from __future__ import annotations

import dataclasses

import torch

from cuda_fortran_mc_simulation_spin_tpu_torch.core import rng
from cuda_fortran_mc_simulation_spin_tpu_torch.engine import sweep as sweep_mod
from cuda_fortran_mc_simulation_spin_tpu_torch.models import (
    Clock2D,
    Ising2D,
    Ising3D,
    XY2D,
)
from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
    ising2d_multispin as msb,
    ising2d_pallas,
    ising3d_multispin as ms3,
    ising3d_pallas,
    multispin_rng,
)
from cuda_fortran_mc_simulation_spin_tpu_torch.parallel import halo
from cuda_fortran_mc_simulation_spin_tpu_torch.parallel.mesh import Mesh


@dataclasses.dataclass
class ShardedState:
    """The two colours of a sharded lattice: {(d, yi, xi): block}."""

    a: dict
    b: dict


def _split(t: torch.Tensor, n: int, dim: int) -> list[torch.Tensor]:
    size = t.shape[dim] // n
    return [t.narrow(dim, i * size, size) for i in range(n)]


def shard_tensor(t: torch.Tensor, mesh: Mesh) -> dict:
    """Blocks of a global (R, lead, ..., w) tensor on the mesh: replicas
    over dp, the leading lattice dimension over y, the last over x; each
    block a contiguous copy on its device."""
    dp, ny_, nx_ = mesh.devices.shape
    out = {}
    for d, rep in enumerate(_split(t, dp, 0)):
        for yi, rows in enumerate(_split(rep, ny_, 1)):
            for xi, blk in enumerate(_split(rows, nx_, t.dim() - 1)):
                out[(d, yi, xi)] = halo._send(blk, mesh.device(d, yi, xi))
    return out


def gather_tensor(blocks: dict, mesh: Mesh, device=None) -> torch.Tensor:
    """The global tensor of :func:`shard_tensor`'s blocks, on ``device``
    (default the first shard's)."""
    dp, ny_, nx_ = mesh.devices.shape
    device = device or mesh.device(0, 0, 0)
    last = blocks[(0, 0, 0)].dim() - 1
    return torch.cat([
        torch.cat([
            torch.cat([blocks[(d, yi, xi)].to(device) for xi in range(nx_)],
                      dim=last)
            for yi in range(ny_)], dim=1)
        for d in range(dp)], dim=0)


def shard_state(a: torch.Tensor, b: torch.Tensor, mesh: Mesh
                ) -> ShardedState:
    return ShardedState(shard_tensor(a, mesh), shard_tensor(b, mesh))


def gather_state(state: ShardedState, mesh: Mesh, device=None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    return (gather_tensor(state.a, mesh, device),
            gather_tensor(state.b, mesh, device))


def replicated_init(model, mesh: Mesh, replicas: int, kind: str, key
                    ) -> ShardedState:
    """A replica-batched int8 state sharded over (dp, y[, x]).  Replica r
    starts from ``model.init_state(kind, fold_in(key, r))``: the port's
    runners fold the replica index in, where JAX's ``replicated_init``
    splits the key."""
    dev = mesh.device(0, 0, 0)
    keys = rng.fold_in(key, torch.arange(replicas, dtype=torch.int64))
    states = [model.init_state(kind, keys[r], device=dev)
              for r in range(replicas)]
    return shard_state(torch.stack([s.a for s in states]),
                       torch.stack([s.b for s in states]), mesh)


# ---------------------------------------------------------------------------
# the exchanges
# ---------------------------------------------------------------------------

def _along(blocks: dict, mesh: Mesh, axis: int, fn, **kw):
    """Apply a halo exchange ``fn`` to every line of shards along mesh
    axis ``axis`` (1: y, 2: x); returns two dicts of halos by coordinate."""
    shape = mesh.devices.shape
    before, after = {}, {}
    for c in mesh.coords():
        if c[axis] != 0:
            continue
        line = []
        for i in range(shape[axis]):
            k = list(c)
            k[axis] = i
            line.append(tuple(k))
        bs, as_ = fn([blocks[k] for k in line], **kw)
        for k, u, w in zip(line, bs, as_):
            before[k], after[k] = u, w
    return before, after


def _xch(blocks: dict, mesh: Mesh):
    """Halo rows (2-D) or planes (3-D) of local blocks over the y axis."""
    return _along(blocks, mesh, 1, halo.exchange_halo_rows, row_axis=1)


def _xch_c(blocks: dict, mesh: Mesh):
    """Halo columns of (R, L, w) local blocks over the x axis."""
    return _along(blocks, mesh, 2, halo.exchange_halo_cols, col_axis=2)


def _halos4(blocks: dict, mesh: Mesh, packed_rows: bool = False) -> dict:
    """{coord: ((up, dn), column keywords)} of a colour's blocks: rows
    (3-D: planes) over y, as boundary bits with ``packed_rows``, and with
    an x axis the columns over x."""
    if packed_rows:
        up, dn = _along(blocks, mesh, 1, halo.exchange_halo_rows_packed)
    else:
        up, dn = _xch(blocks, mesh)
    cols = {c: {} for c in blocks}
    if "x" in mesh.axis_names:
        lf, rt = _xch_c(blocks, mesh)
        cols = {c: {"halo_lf": lf[c], "halo_rt": rt[c]} for c in blocks}
    return {c: ((up[c], dn[c]), cols[c]) for c in blocks}


def _offsets(blocks: dict, mesh: Mesh) -> dict:
    """{coord: (rep0, row0[, col0])}: the block's global offsets in its
    own units (replicas, rows, word rows or planes, columns or words)."""
    has_x = "x" in mesh.axis_names
    out = {}
    for (d, yi, xi), t in blocks.items():
        offs = (d * t.shape[0], yi * t.shape[1])
        out[(d, yi, xi)] = offs + ((xi * t.shape[-1],) if has_x else ())
    return out


# ---------------------------------------------------------------------------
# routes
# ---------------------------------------------------------------------------

def _shard_packed_mode(model, mesh: Mesh, replicas: int,
                       n_over_relax: int = 0) -> str | None:
    """The packed route of the sharded sweep: "2d" or "3d" on the
    bit-packed halo kernels, else None (the int8 ones).  The JAX
    package's gate without its TPU tiling terms (half % 128, local word
    rows % 8); its semantic terms stay: 32 rows a word in every y shard
    (ny % (32·y)), whole words an x shard (half % x), no x split in 3-D,
    replicas % dp, and the lattice within ``OBS_INT32_MAX_SITES`` (the
    port's partials are int64, but the bound keeps JAX's route).  JAX's
    ``SPINLAT_SHARD_PACKED=0`` switch has no counterpart."""
    is2d = isinstance(model, Ising2D)
    is3d = isinstance(model, Ising3D)
    if not (is2d or is3d) or n_over_relax:
        return None
    ysh = mesh.shape["y"]
    xsh = mesh.shape.get("x", 1)
    if (xsh > 1 and is3d) or replicas % mesh.shape["dp"]:
        return None
    if model.nsites > msb.OBS_INT32_MAX_SITES:
        return None
    if is2d:
        ny, half = model.color_shape
        return "2d" if not (ny % (32 * ysh) or half % xsh) else None
    nz, ny, _ = model.color_shape
    return "3d" if not (nz % (2 * ysh) or ny % 32) else None


def _check_replicas(replicas: int, mesh: Mesh) -> None:
    dp = mesh.shape["dp"]
    if replicas % dp != 0:
        raise ValueError(
            f"replica batch {replicas} must be divisible by the mesh's "
            f"dp={dp} (each dp shard holds replicas/dp histories)"
        )


def _check_model(model, mesh: Mesh, n_over_relax: int = 0) -> None:
    """JAX ``_make_local_step``'s refusals, and the port's own for the
    models whose sharded sweeps are not ported yet."""
    if isinstance(model, (Clock2D, XY2D)):
        raise NotImplementedError(
            f"the {type(model).__name__} model on a mesh is not ported yet "
            "(ROADMAP.md queue A item 9, its clock and XY part)")
    if not isinstance(model, (Ising2D, Ising3D)):
        # the JAX package's mesh path fails on the helical layouts too
        # (they have no color_shape to shard)
        raise ValueError(
            f"{type(model).__name__}: the helical layouts have no domain "
            "decomposition; run them without --mesh")
    ysh = mesh.shape["y"]
    xsh = mesh.shape.get("x", 1)
    lead = model.color_shape[0]
    if lead % (2 * ysh) != 0:
        raise ValueError(
            f"leading lattice dim {lead} must be divisible by "
            f"2*domain_shards={2 * ysh} (checkerboard parity per shard)"
        )
    if xsh > 1:
        if isinstance(model, Ising3D):
            raise ValueError(
                "the x mesh axis shards 2-D color-array columns; "
                "Ising3D decomposes over z only (use mesh (dp, y))"
            )
        half = model.color_shape[-1]
        if half % xsh != 0:
            raise ValueError(
                f"color-array width {half} must be divisible by the "
                f"mesh's x={xsh}"
            )
    if n_over_relax > 0:
        raise ValueError(
            "over-relaxation is an XY-model feature; "
            f"got model {type(model).__name__}"
        )


# ---------------------------------------------------------------------------
# local sweeps: both phases on every shard, phase b measuring
# ---------------------------------------------------------------------------

def _psum(parts: dict, mesh: Mesh) -> torch.Tensor:
    """(R,) int64 totals of per-shard (R/dp,) partials: the spatial
    shards of each dp block summed in mesh order on the first shard's
    device, the dp blocks concatenated."""
    dev = mesh.device(0, 0, 0)
    dp = mesh.devices.shape[0]
    rows = []
    for d in range(dp):
        total = None
        for c in mesh.coords():
            if c[0] == d:
                p = parts[c].to(dev)
                total = p if total is None else total + p
        rows.append(total)
    return torch.cat(rows)


def _run_phase(fn, x: dict, o: dict, halos: dict, offs: dict, seeds,
               color, beta, mesh, measuring):
    """One phase on every shard, given the other colour's exchanged
    ``halos`` (:func:`_halos4`); returns the new blocks and, when
    ``measuring``, the psummed (m, e)."""
    out, ms, es = {}, {}, {}
    for c in mesh.coords():
        rows, cols = halos[c]
        res = fn(x[c], o[c], *rows, seeds, offs[c], color=color, beta=beta,
                 measuring=measuring, **cols)
        if measuring:
            out[c], ms[c], es[c] = res
        else:
            out[c] = res
    if not measuring:
        return out, None
    return out, (_psum(ms, mesh), _psum(es, mesh))


def _local_sweep(model, state: ShardedState, seeds, mesh: Mesh,
                 packed: str | None, want_obs: bool):
    """One MCS of every shard under the sweep's (2, 2) phase keys:
    ``_ising_local_sweep_packed``, ``_ising3d_local_sweep_packed``,
    ``_ising_local_sweep`` and ``_ising3d_local_sweep`` of JAX in one.
    Returns (state, (m, e) int64 sums or None)."""
    is3d = isinstance(model, Ising3D)
    beta = model.beta
    if packed == "2d":
        fn = msb.sharded_phase_packed
    elif packed == "3d":
        fn = ms3.sharded_phase3d_packed
    elif is3d:
        fn = ising3d_pallas.sharded_phase
    else:
        fn = ising2d_pallas.sharded_phase
    offs = _offsets(state.a, mesh)
    rows01 = packed == "2d"
    a, _ = _run_phase(fn, state.a, state.b,
                      _halos4(state.b, mesh, rows01), offs, seeds[0], 0,
                      beta, mesh, False)
    b, obs = _run_phase(fn, state.b, a, _halos4(a, mesh, rows01), offs,
                        seeds[1], 1, beta, mesh, want_obs)
    return ShardedState(a, b), obs


def _densities(obs, model) -> dict[str, torch.Tensor]:
    m, e = obs
    return {"m": msb.per_site(m, model.nsites),
            "e": msb.per_site(e, model.nsites)}


def _make_local_step(model, mesh: Mesh, n_over_relax: int = 0,
                     with_obs: bool = True, packed: str | None = None):
    """(state, seeds) -> (state, {m, e: (R,) float64}) or just the state
    (``with_obs=False``) under the sweep's (2, 2) phase keys: one MCS of
    a :class:`ShardedState`, int8 blocks or, with ``packed`` ("2d", "3d"),
    packed words.  Raises the JAX package's ValueErrors for shapes it
    cannot shard, and NotImplementedError for the clock and XY models."""
    _check_model(model, mesh, n_over_relax)

    def local_step(state: ShardedState, seeds):
        state, obs = _local_sweep(model, state, seeds, mesh, packed,
                                  with_obs)
        if not with_obs:
            return state
        return state, _densities(obs, model)

    return local_step


def make_sharded_step(model, mesh: Mesh):
    """(state, key) -> (state, {obs: (R,)}) on int8 sharded states
    (:func:`replicated_init`), one MCS under the sweep key ``key``."""
    step = _make_local_step(model, mesh)
    return lambda state, key: step(state, ising2d_pallas.phase_seeds(key))


def _init_blocks(model, mesh: Mesh, replicas: int, init_kind: str,
                 call_key, packed: str | None) -> ShardedState:
    """The sharded start of a call: all-up blocks made on their devices,
    a random start drawn globally as the unsharded runners draw it
    (replica r from fold_in(init_key, r)) and sharded; packed when the
    route is."""
    dev = mesh.device(0, 0, 0)
    if init_kind == "allup":
        dp, ny_, nx_ = mesh.devices.shape
        shape = list(model.color_shape)
        shape[0] //= ny_
        shape[-1] //= nx_
        if packed:
            shape[-2] //= msb.PACK
        local = (replicas // dp, *shape)
        fill, dtype = (-1, torch.int32) if packed else (1, torch.int8)
        blocks = {c: torch.full(local, fill, dtype=dtype,
                                device=mesh.device(*c))
                  for c in mesh.coords()}
        return ShardedState(blocks, {c: t.clone()
                                     for c, t in blocks.items()})
    st = sweep_mod._init_state(model, init_kind, replicas, call_key, dev)
    a, b = (st.a, st.b)
    if packed:
        a, b = msb.pack_color(a), msb.pack_color(b)
    return shard_state(a, b, mesh)


def make_sharded_sample_runner(model, mesh: Mesh, mcs: int, replicas: int,
                               init_kind: str = "allup",
                               n_over_relax: int = 0,
                               mcs_over_relax: int = 0,
                               chunk: int = sweep_mod.DEFAULT_CHUNK):
    """run(call_key) -> {m, e: (replicas, mcs) float64}: full histories
    of a replica batch, domain-sharded over the mesh, the series on the
    first shard's device.  Sweep t draws under ``rng.sweep_key(call_key,
    t)`` and replica r starts from ``fold_in(init_key(call_key), r)``, as
    in the unsharded runners; it equals the series of the one of its
    engine (packed or int8) bit for bit.  The
    over-relaxation arguments are JAX's; on the Ising models
    ``n_over_relax`` > 0 raises its ValueError."""
    del mcs_over_relax  # an XY schedule; n_over_relax > 0 raises below
    packed = _shard_packed_mode(model, mesh, replicas, n_over_relax)
    step = _make_local_step(model, mesh, n_over_relax=n_over_relax,
                            packed=packed)
    _check_replicas(replicas, mesh)

    def init_fn(call_key):
        return _init_blocks(model, mesh, replicas, init_kind, call_key,
                            packed)

    def chunk_fn(state, call_key, t0, size):
        seeds = multispin_rng.sweep_phase_keys(call_key, size, t0)
        series = {"m": [], "e": []}
        for j in range(size):
            state, obs = step(state, seeds[j])
            for k in series:
                series[k].append(obs[k])
        return state, {k: torch.stack(v, dim=1) for k, v in series.items()}

    run = sweep_mod._host_chunk_runner(init_fn, chunk_fn, mcs, chunk)
    run.packed = packed
    return run
