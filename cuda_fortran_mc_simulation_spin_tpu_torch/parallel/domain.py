"""Lattice domain decomposition over a (dp, y[, x]) mesh: every periodic
model.

Port of ``cuda_fortran_mc_simulation_spin_tpu/parallel/domain.py``.  JAX
runs one ``shard_map`` program over its mesh; here one process holds every
shard as a tensor of its own on its mesh device (parallel/mesh.py) and
drives them in turn:

- ``dp`` splits the replicas: shard (d, ., .) holds replicas d·R/dp ..;
- ``y`` splits the lattice's leading dimension, rows in 2-D and z-planes
  in 3-D, with halo exchange (parallel/halo.py);
- ``x`` (2-D only) splits the colour planes' columns, with column halos.

A phase exchanges the other colour's halos between all shards, then
launches the halo kernel of each shard, their plain versions on CPU
shards:

- Ising: the packed ones (ops/ising2d_multispin.sharded_phase_packed,
  ops/ising3d_multispin.sharded_phase3d_packed) where the shape packs,
  the int8 ones (ops/ising2d_pallas.sharded_phase, ops/ising3d_pallas.
  sharded_phase) otherwise;
- the clock: the bit-sliced q = 6, 4, 3 engines (ops/clock_planes.
  sharded_phase_packed, a tuple of word planes a colour) where the shape
  packs, the int8 one (ops/clock_pallas.sharded_phase) at every other q
  and shape;
- XY: four component planes (ops/xy2d_pallas.sharded_phase, its snapshot
  mode, and sharded_or_phase), whatever ``SPINLAT_XY_PERIODIC_ANGLE``
  says, as JAX's mesh branch precedes its angle routes.

Phase b measures: each shard's partials (exact int64 for Ising and the
packed clock; float64 for the int8 clock and XY) are summed in a fixed
order (the psum).  Every kernel keys its random words by global
coordinates, so a sharded trajectory equals the unsharded runner's of the
same engine (engine/sweep.py) bit for bit at every mesh shape, which is
more than the JAX package's guarantee (invariance to the mesh shape on
its jnp route); the integer densities are bitwise equal too, the float64
ones to float64 rounding (the psum adds in another order).

A sharded state is a :class:`ShardedState` (per colour a dict from the
shard's mesh coordinates (d, yi, xi) to its local block: int8 (R/dp, L,
w) planes or (R/dp, nz/y, ny, half) volumes, packed words, or for the
packed clock a tuple of word planes), or for XY an ``XYState`` of four
such dicts.

Not ported: JAX's separate observable pass (``_ising_local_obs``,
``_clock_local_obs``, ``_xy_local_obs``), which its jnp route needs and
the port's fused measuring phases replace on every route.  The XY
disorder protocols' measurement after over-relaxation and at fix1mcs's
t = 1, which JAX computes in jnp outside any Pallas kernel, is per-shard
PyTorch sums with exchanged halo rows here (:func:`xy_measure`).
"""

from __future__ import annotations

import dataclasses
import functools
import os

import torch

from cuda_fortran_mc_simulation_spin_tpu_torch.core import rng
from cuda_fortran_mc_simulation_spin_tpu_torch.engine import sweep as sweep_mod
from cuda_fortran_mc_simulation_spin_tpu_torch.core import lattice
from cuda_fortran_mc_simulation_spin_tpu_torch.models import (
    Clock2D,
    Ising2D,
    Ising3D,
    XY2D,
)
from cuda_fortran_mc_simulation_spin_tpu_torch.models.xy2d import XYState
from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
    clock3_multispin,
    clock4_multispin,
    clock_multispin,
    clock_pallas,
    clock_planes,
    ising2d_multispin as msb,
    ising2d_pallas,
    ising3d_multispin as ms3,
    ising3d_pallas,
    multispin_rng,
    xy2d_pallas,
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


def _shard(t, mesh: Mesh) -> dict:
    """:func:`shard_tensor`, or of a tuple of planes a tuple a shard."""
    if isinstance(t, torch.Tensor):
        return shard_tensor(t, mesh)
    parts = [shard_tensor(p, mesh) for p in t]
    return {c: tuple(q[c] for q in parts) for c in parts[0]}


def _gather(blocks: dict, mesh: Mesh, device=None):
    """:func:`gather_tensor`, or of blocks that are tuples of planes the
    tuple of gathered planes."""
    first = blocks[(0, 0, 0)]
    if isinstance(first, torch.Tensor):
        return gather_tensor(blocks, mesh, device)
    return tuple(gather_tensor({c: t[k] for c, t in blocks.items()}, mesh,
                               device) for k in range(len(first)))


def shard_state(a, b, mesh: Mesh) -> ShardedState:
    """The two colours (tensors, or tuples of packed clock planes) on the
    mesh."""
    return ShardedState(_shard(a, mesh), _shard(b, mesh))


def gather_state(state, mesh: Mesh, device=None):
    """The global colours of a :class:`ShardedState` ((a, b), each a
    tensor or a tuple of planes), or the four planes of a sharded
    ``XYState``."""
    if isinstance(state, XYState):
        return XYState(*(gather_tensor(p, mesh, device) for p in state))
    return _gather(state.a, mesh, device), _gather(state.b, mesh, device)


def shard_xy(st: XYState, mesh: Mesh) -> XYState:
    """A global XYState's four planes on the mesh: an XYState of dicts."""
    return XYState(*(shard_tensor(p, mesh) for p in st))


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


def _plane_halos(blocks: dict, mesh: Mesh) -> dict:
    """:func:`_halos4` of packed clock blocks (a tuple of word planes a
    shard): {coord: ((ups, dns), column keywords)}, a tuple a side, the
    rows as boundary bits (JAX ``_clock_local_sweep_packed``'s h3)."""
    n = len(blocks[(0, 0, 0)])
    per = [_halos4({c: t[k] for c, t in blocks.items()}, mesh, True)
           for k in range(n)]
    out = {}
    for c in blocks:
        rows = tuple(tuple(h[c][0][i] for h in per) for i in range(2))
        cols = {key: tuple(h[c][1][key] for h in per)
                for key in per[0][c][1]}
        out[c] = (rows, cols)
    return out


def _xy_halos(ox: dict, oy: dict, mesh: Mesh) -> dict:
    """{coord: keywords} of the XY halo kernels: the other colour's (up,
    dn) rows of each component, and with an x axis its (left, right)
    columns (JAX ``_xy_offs_cols``)."""
    hx, hy = _halos4(ox, mesh), _halos4(oy, mesh)
    out = {}
    for c in ox:
        kw = dict(halos_x=hx[c][0], halos_y=hy[c][0])
        if hx[c][1]:
            kw.update(cols_x=(hx[c][1]["halo_lf"], hx[c][1]["halo_rt"]),
                      cols_y=(hy[c][1]["halo_lf"], hy[c][1]["halo_rt"]))
        out[c] = kw
    return out


def _offsets(blocks: dict, mesh: Mesh) -> dict:
    """{coord: (rep0, row0[, col0])}: the block's global offsets in its
    own units (replicas, rows, word rows or planes, columns or words)."""
    has_x = "x" in mesh.axis_names
    out = {}
    for (d, yi, xi), t in blocks.items():
        if not isinstance(t, torch.Tensor):
            t = t[0]
        offs = (d * t.shape[0], yi * t.shape[1])
        out[(d, yi, xi)] = offs + ((xi * t.shape[-1],) if has_x else ())
    return out


# ---------------------------------------------------------------------------
# routes
# ---------------------------------------------------------------------------

# the bit-sliced clock engines' q-modules by route name
CLOCK_PACKED = {"clock6": clock_multispin, "clock4": clock4_multispin,
                "clock3": clock3_multispin}


def _shard_packed_mode(model, mesh: Mesh, replicas: int,
                       n_over_relax: int = 0) -> str | None:
    """The packed route of the sharded sweep: "2d" or "3d" (Ising),
    "clock6", "clock4" or "clock3" on the bit-packed halo kernels, else
    None (the int8 ones, or XY's component planes).  The JAX package's
    gate without its TPU tiling terms (half % 128, local word rows % 8);
    its semantic terms stay: 32 rows a word in every y shard (ny %
    (32·y)), whole words an x shard (half % x), no x split in 3-D,
    replicas % dp, and the lattice within ``OBS_INT32_MAX_SITES`` (the
    port's partials are int64, but the bound keeps JAX's route); for the
    clock also the q-engine's own site bound and JAX's
    ``SPINLAT_CLOCK_PACKED=0`` switch.  JAX's ``SPINLAT_SHARD_PACKED=0``
    has no counterpart."""
    is2d = isinstance(model, Ising2D)
    is3d = isinstance(model, Ising3D)
    clock = None
    if isinstance(model, Clock2D):
        clock = {6: "clock6", 4: "clock4", 3: "clock3"}.get(model.q)
    if not (is2d or is3d or clock) or n_over_relax:
        return None
    ysh = mesh.shape["y"]
    xsh = mesh.shape.get("x", 1)
    if (xsh > 1 and is3d) or replicas % mesh.shape["dp"]:
        return None
    if model.nsites > msb.OBS_INT32_MAX_SITES:
        return None
    if clock:
        if (os.environ.get("SPINLAT_CLOCK_PACKED") == "0"
                or model.nsites > CLOCK_PACKED[clock].OBS_INT32_MAX_SITES):
            return None
        ny, half = model.color_shape
        if ny % (32 * ysh) or half % xsh:
            return None
        local = (replicas // mesh.shape["dp"], ny // 32 // ysh, half // xsh)
        return clock if clock_planes.shard_ok(local) else None
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
    """JAX ``_make_local_step``'s refusals."""
    if not isinstance(model, (Ising2D, Ising3D, Clock2D, XY2D)):
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
    if n_over_relax > 0 and not isinstance(model, XY2D):
        raise ValueError(
            "over-relaxation is an XY-model feature; "
            f"got model {type(model).__name__}"
        )


# ---------------------------------------------------------------------------
# local sweeps: both phases on every shard, phase b measuring
# ---------------------------------------------------------------------------

def _psum(parts: dict, mesh: Mesh) -> torch.Tensor:
    """(R, ...) totals of per-shard (R/dp, ...) partials, int64 or
    float64: the spatial shards of each dp block summed in mesh order on
    the first shard's device, the dp blocks concatenated."""
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
    ``halos`` (:func:`_halos4`, :func:`_plane_halos`); returns the new
    blocks and, when ``measuring``, the psummed partials ((m, e), or the
    int8 clock's (Σ cos, Σ sin, e))."""
    out, parts = {}, {}
    for c in mesh.coords():
        rows, cols = halos[c]
        res = fn(x[c], o[c], *rows, seeds, offs[c], color=color, beta=beta,
                 measuring=measuring, **cols)
        if measuring:
            out[c], *parts[c] = res
        else:
            out[c] = res
    if not measuring:
        return out, None
    n = len(parts[(0, 0, 0)])
    return out, tuple(_psum({c: p[k] for c, p in parts.items()}, mesh)
                      for k in range(n))


def _phase_fn(model, packed: str | None):
    """The halo kernel of a shard's phase and its halo exchange."""
    if packed in CLOCK_PACKED:
        return (functools.partial(clock_planes.sharded_phase_packed,
                                  CLOCK_PACKED[packed].SPEC), _plane_halos)
    if packed == "2d":
        return (msb.sharded_phase_packed,
                functools.partial(_halos4, packed_rows=True))
    if packed == "3d":
        return ms3.sharded_phase3d_packed, _halos4
    if isinstance(model, Clock2D):
        return (functools.partial(clock_pallas.sharded_phase, q=model.q),
                _halos4)
    if isinstance(model, Ising3D):
        return ising3d_pallas.sharded_phase, _halos4
    return ising2d_pallas.sharded_phase, _halos4


def _local_sweep(model, state: ShardedState, seeds, mesh: Mesh,
                 packed: str | None, want_obs: bool):
    """One MCS of every shard under the sweep's (2, 2) phase keys:
    ``_ising_local_sweep_packed``, ``_ising3d_local_sweep_packed``,
    ``_clock_local_sweep_packed``, ``_ising_local_sweep``,
    ``_ising3d_local_sweep`` and ``_clock_local_sweep`` of JAX in one.
    Returns (state, the psummed partials or None)."""
    beta = model.beta
    fn, halos = _phase_fn(model, packed)
    offs = _offsets(state.a, mesh)
    a, _ = _run_phase(fn, state.a, state.b, halos(state.b, mesh), offs,
                      seeds[0], 0, beta, mesh, False)
    b, obs = _run_phase(fn, state.b, a, halos(a, mesh), offs, seeds[1], 1,
                        beta, mesh, want_obs)
    return ShardedState(a, b), obs


def _densities(obs, model, packed: str | None = None
               ) -> dict[str, torch.Tensor]:
    """float64 densities of the psummed partials, as the unsharded
    runners of the same engine compute them: {m, e} (Ising; the packed
    clock's (2m, 2e) or (m, e) scaled by its engine's ``obs_scale``),
    {m, my, e} (the int8 clock)."""
    if packed in CLOCK_PACKED:
        return clock_planes._densities(CLOCK_PACKED[packed].SPEC, model,
                                       torch.stack(obs, dim=-1))
    keys = ("m", "my", "e") if len(obs) == 3 else ("m", "e")
    return {k: msb.per_site(v, model.nsites) for k, v in zip(keys, obs)}


# ---------------------------------------------------------------------------
# XY: four component planes, Metropolis and over-relaxation phases
# ---------------------------------------------------------------------------

def _xy_phase(st: XYState, color: int, seeds, beta, mesh: Mesh,
              measuring: bool = False, snap: XYState | None = None,
              over_relax: bool = False):
    """One phase of colour ``color`` on every shard, in place: Metropolis
    under ``seeds`` (with ``snap`` in the snapshot mode), or with
    ``over_relax`` the reflection.  Returns the psummed (R, 3) float64
    sums ((R, 4) with ``snap``) when it measures, else None."""
    pairs = ((st.ax, st.ay), (st.bx, st.by))
    own, oth = pairs if color == 0 else pairs[::-1]
    halos = _xy_halos(*oth, mesh)
    offs = _offsets(st.ax, mesh)
    parts = {}
    for c in mesh.coords():
        planes = (own[0][c], own[1][c], oth[0][c], oth[1][c])
        if over_relax:
            res = xy2d_pallas.sharded_or_phase(
                *planes, offs=offs[c], color=color, measuring=measuring,
                **halos[c])
        else:
            sn = None
            if snap is not None:
                spairs = ((snap.ax, snap.ay), (snap.bx, snap.by))
                s_own, s_oth = spairs if color == 0 else spairs[::-1]
                sn = (s_own[0][c], s_own[1][c], s_oth[0][c], s_oth[1][c])
            res = xy2d_pallas.sharded_phase(
                *planes, seeds=seeds, offs=offs[c], color=color, beta=beta,
                measuring=measuring, snap=sn, **halos[c])
        if measuring or snap is not None:
            parts[c] = res[2]
    return _psum(parts, mesh) if parts else None


def _xy_sweep(model, st: XYState, seeds, mesh: Mesh, measuring=False,
              snap=None):
    """One Metropolis MCS of a sharded XY state, in place, phase b
    measuring (with ``snap`` in the snapshot mode); returns the psummed
    sums or None."""
    _xy_phase(st, 0, seeds[0], model.beta, mesh)
    return _xy_phase(st, 1, seeds[1], model.beta, mesh, measuring, snap)


def _xy_or_sweep(st: XYState, mesh: Mesh, measuring=False):
    """One over-relaxation sweep of a sharded XY state, in place, phase b
    measuring."""
    _xy_phase(st, 0, None, None, mesh, over_relax=True)
    return _xy_phase(st, 1, None, None, mesh, measuring, over_relax=True)


def _xy_step(model, mesh: Mesh, n_over_relax: int, with_obs: bool):
    """(state, seeds, do_or) -> (state, {m, my, e}) or the state: one MCS
    on the schedule of the port's unsharded XY runner (engine/sweep.
    make_xy_runner): a Metropolis sweep, and with ``do_or`` n_over_relax
    OR sweeps; the last phase b measures (JAX measures after OR in a
    separate pass, ``_xy_local_obs``)."""
    def local_step(st: XYState, seeds, do_or: bool = False):
        if n_over_relax > 0 and do_or:
            _xy_sweep(model, st, seeds, mesh)
            for _ in range(n_over_relax - 1):
                _xy_or_sweep(st, mesh)
            sums = _xy_or_sweep(st, mesh, with_obs)
        else:
            sums = _xy_sweep(model, st, seeds, mesh, with_obs)
        if not with_obs:
            return st
        return st, {k: msb.per_site(sums[:, j], model.nsites)
                    for j, k in enumerate(("m", "my", "e"))}

    return local_step


def _make_local_step(model, mesh: Mesh, n_over_relax: int = 0,
                     with_obs: bool = True, packed: str | None = None):
    """(state, seeds[, do_or]) -> (state, densities) or just the state
    (``with_obs=False``) under the sweep's (2, 2) phase keys: one MCS of
    a :class:`ShardedState` (int8 blocks, or with ``packed`` packed words
    or clock plane tuples) or of a sharded ``XYState`` (``do_or``: this
    step's over-relaxation sweeps, XY only).  Raises the JAX package's
    ValueErrors for shapes it cannot shard."""
    _check_model(model, mesh, n_over_relax)
    if isinstance(model, XY2D):
        return _xy_step(model, mesh, n_over_relax, with_obs)

    def local_step(state: ShardedState, seeds, do_or: bool = False):
        del do_or  # an XY schedule
        state, obs = _local_sweep(model, state, seeds, mesh, packed,
                                  with_obs)
        if not with_obs:
            return state
        return state, _densities(obs, model, packed)

    return local_step


def make_sharded_step(model, mesh: Mesh):
    """(state, key) -> (state, {obs: (R,)}) on int8 sharded states
    (:func:`replicated_init`; XY: a sharded ``XYState``), one MCS under
    the sweep key ``key``, without over-relaxation (as JAX's)."""
    step = _make_local_step(model, mesh)
    return lambda state, key: step(state, ising2d_pallas.phase_seeds(key))


def _init_blocks(model, mesh: Mesh, replicas: int, init_kind: str,
                 call_key, packed: str | None):
    """The sharded start of a call: Ising all-up blocks made on their
    devices; every other start drawn on the mesh's first device as the
    unsharded runners draw it (replica r from fold_in(init_key, r)) and
    sharded; packed when the route is."""
    dev = mesh.device(0, 0, 0)
    if isinstance(model, XY2D):
        return shard_xy(
            sweep_mod._init_state(model, init_kind, replicas, call_key, dev),
            mesh)
    if init_kind == "allup" and isinstance(model, (Ising2D, Ising3D)):
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
    pack = (CLOCK_PACKED[packed].SPEC.pack_color if packed in CLOCK_PACKED
            else msb.pack_color if packed else None)
    if pack is None:
        return shard_state(st.a, st.b, mesh)
    return shard_state(pack(st.a), pack(st.b), mesh)


def make_sharded_sample_runner(model, mesh: Mesh, mcs: int, replicas: int,
                               init_kind: str = "allup",
                               n_over_relax: int = 0,
                               mcs_over_relax: int = 0,
                               chunk: int = sweep_mod.DEFAULT_CHUNK):
    """run(call_key) -> {m, e: (replicas, mcs) float64} (the int8 clock
    and XY also {my}): full histories of a replica batch, domain-sharded
    over the mesh, the series on the first shard's device.  Sweep t draws
    under ``rng.sweep_key(call_key, t)`` and replica r starts from
    ``fold_in(init_key(call_key), r)``, as in the unsharded runners; its
    states equal those of the unsharded runner of its engine (packed,
    int8, or XY component planes) bit for bit, and so do its densities
    where the partials are integers (Ising, the packed clock), else to
    float64 rounding.  XY follows ``make_xy_runner``'s over-relaxation
    schedule (``n_over_relax`` OR sweeps after each Metropolis sweep with
    t <= ``mcs_over_relax``, default mcs); on the Ising and clock models
    ``n_over_relax`` > 0 raises JAX's ValueError."""
    packed = _shard_packed_mode(model, mesh, replicas, n_over_relax)
    step = _make_local_step(model, mesh, n_over_relax=n_over_relax,
                            packed=packed)
    _check_replicas(replicas, mesh)
    mcs_or = mcs_over_relax or mcs

    def init_fn(call_key):
        return _init_blocks(model, mesh, replicas, init_kind, call_key,
                            packed)

    def chunk_fn(state, call_key, t0, size):
        seeds = multispin_rng.sweep_phase_keys(call_key, size, t0)
        series = {}
        for j in range(size):
            state, obs = step(state, seeds[j], t0 + j + 1 <= mcs_or)
            for k, v in obs.items():
                series.setdefault(k, []).append(v)
        return state, {k: torch.stack(v, dim=1) for k, v in series.items()}

    run = sweep_mod._host_chunk_runner(init_fn, chunk_fn, mcs, chunk)
    run.packed = packed
    return run


# ---------------------------------------------------------------------------
# the XY disorder protocols on a mesh
# ---------------------------------------------------------------------------

def xy_measure(model, st: XYState, snap: XYState, mesh: Mesh
               ) -> dict[str, torch.Tensor]:
    """{mx, my, e, A} densities (R,) of a sharded XY state against its
    sharded t=0 snapshot: each shard's float64 site terms of the
    unsharded ``measure_kernel`` (ops/xy2d_measure_pallas.
    measure_sums_plain), its right and down bonds past its edges from the
    next shards' first column and row (exchanged halos), summed per shard
    in PyTorch and psummed.  JAX computes these sums in jnp outside any
    Pallas kernel; the disorder protocols take them where they measure
    outside a phase: after over-relaxation and at fix1mcs's t = 1."""
    dn = [_xch(p, mesh)[1] for p in st]
    rt = ([_xch_c(p, mesh)[1] for p in st] if "x" in mesh.axis_names
          else [dict.fromkeys(st.ax) for _ in st])
    offs = _offsets(st.ax, mesh)

    def wide(t):
        return None if t is None else t.to(torch.float64)

    def total(v):
        return v.sum(dim=(-2, -1))

    parts = {}
    for c in mesh.coords():
        ax, ay, bx, by = (wide(p[c]) for p in st)
        d = [wide(h[c]) for h in dn]
        r = [wide(h[c]) for h in rt]
        row0 = offs[c][1]
        rax, dax, rbx, dbx = lattice.right_down_neighbors_halo(
            ax, bx, row0, d[0], d[2], r[0], r[2])
        ray, day, rby, dby = lattice.right_down_neighbors_halo(
            ay, by, row0, d[1], d[3], r[1], r[3])
        e = (ax * (rax + dax) + ay * (ray + day)) + (
            bx * (rbx + dbx) + by * (rby + dby))
        sax, say, sbx, sby = (wide(p[c]) for p in snap)
        a = (ax * sax + ay * say) + (bx * sbx + by * sby)
        parts[c] = torch.stack([total(ax + bx), total(ay + by), -total(e),
                                total(a)], dim=-1)
    return xy2d_pallas.densities(model, _psum(parts, mesh))


def _xy_rotate(model, st: XYState, snap: XYState, mesh: Mesh) -> None:
    """fix1mcs's rotation, in place: every shard of the state and of the
    snapshot by -atan2(Σ S_y, Σ S_x) of its replica, the sums psummed,
    all shards of a replica by the same angle (JAX ``rot_one``)."""
    parts = {c: torch.stack(model.magne_sums(XYState(*(p[c] for p in st))),
                            dim=-1) for c in mesh.coords()}
    sums = _psum(parts, mesh)
    theta = -torch.atan2(sums[:, 1], sums[:, 0])
    for c in mesh.coords():
        n = st.ax[c].shape[0]
        th = theta[c[0] * n:(c[0] + 1) * n].to(st.ax[c].device)
        for planes in (st, snap):
            new = model.rotate(XYState(*(p[c] for p in planes)), th)
            for p, v in zip(planes, new):
                p[c].copy_(v)


def make_sharded_xy_disorder_runner(model, mesh: Mesh, mcs: int,
                                    replicas: int, prep: str, *,
                                    init_magne: float = 0.02,
                                    near_magne_tol: float = 0.01,
                                    n_over_relax: int = 0,
                                    mcs_over_relax: int = 0,
                                    track_correlation: bool = False,
                                    chunk: int = sweep_mod.DEFAULT_CHUNK):
    """run(call_key) -> {mx, my, e, A[, corr]: (replicas, mcs) float64}:
    the XY disorder protocols domain-sharded over the mesh (JAX
    ``make_sharded_xy_disorder_runner``, which takes its preparation and
    measurement as functions; here ``prep`` names one of
    ``engine/sweep.xy_prepared``'s).  The schedule is the unsharded
    streamed route's (``sweep.make_xy_disorder_runner``): a Metropolis
    sweep whose phase b measures against the snapshot in the halo
    kernel's snapshot mode; while t <= ``mcs_over_relax`` with
    over-relaxation, a Metropolis sweep, ``n_over_relax`` OR sweeps and
    :func:`xy_measure`; with fix1mcs the rotation after sweep 1
    (:func:`_xy_rotate`) and its row measured again.  The preparation
    runs on the mesh's first device and is then sharded, as a random
    Ising start is; ``track_correlation`` gathers the state there for its
    sum.  The states equal the unsharded runner's bit for bit, the
    densities to float64 rounding."""
    if prep not in sweep_mod.XY_PREPS:
        raise ValueError(f"unknown preparation {prep!r}")
    _check_model(model, mesh, n_over_relax)
    _check_replicas(replicas, mesh)
    dev = mesh.device(0, 0, 0)
    fix1 = prep == "fix1mcs"
    mcs_or = mcs_over_relax or mcs

    def init_fn(call_key):
        st, snap = sweep_mod.xy_prepared(
            model, prep, replicas, call_key, dev, init_magne=init_magne,
            near_magne_tol=near_magne_tol)
        return (shard_xy(st, mesh), shard_xy(snap, mesh),
                multispin_rng.sweep_phase_keys(call_key, mcs))

    def one_sweep(st, snap, seeds, t):
        if n_over_relax > 0 and t <= mcs_or:
            _xy_sweep(model, st, seeds, mesh)
            if fix1 and t == 1:
                _xy_rotate(model, st, snap, mesh)
            for _ in range(n_over_relax):
                _xy_or_sweep(st, mesh)
            obs = xy_measure(model, st, snap, mesh)
        else:
            sums = _xy_sweep(model, st, seeds, mesh, snap=snap)
            obs = xy2d_pallas.densities(model, sums)
            if fix1 and t == 1:
                _xy_rotate(model, st, snap, mesh)
                obs = xy_measure(model, st, snap, mesh)
        if track_correlation:
            obs = dict(obs, corr=msb.per_site(
                model.correlation_sum(gather_state(st, mesh)),
                model.nsites))
        return {k: v[:, None] for k, v in obs.items()}

    def chunk_fn(carry, call_key, t0, size):
        st, snap, keys = carry
        parts = [one_sweep(st, snap, keys[t0 + j], t0 + j + 1)
                 for j in range(size)]
        return carry, {k: torch.cat([p[k] for p in parts], dim=1)
                       for k in parts[0]}

    return sweep_mod._host_chunk_runner(init_fn, chunk_fn, mcs, chunk)
