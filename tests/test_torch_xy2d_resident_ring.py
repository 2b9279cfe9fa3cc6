"""The device-memory mode of the resident XY multisweep
(``csrc/xy2d_resident.cu`` ``gmem_multisweep_kernel``), replayed on the
CPU.

The kernel runs on the card only (tests/test_torch_cuda.py holds it
bitwise against streamed sweeps there).  What it relies on is held here:

- the layout rule ``ops/xy2d_resident.gmem_layout``: every chunk of a
  replica owned once, in whole chunks and in order; a block of a ring of
  more than one owns at least ``half`` real sites; batches with more
  replicas than block slots are covered by rings of one taking replicas
  in turn; the main path's batches past the shared-memory fit all get a
  layout;
- the launch's schedule: each block's walk (its edge chunks first, the
  flag, its other chunks), its flag waits and its in-place stores,
  replayed under adversarial interleavings of the blocks (each block
  stalled in turn, random, one block run as far as it goes): every read
  of a site sees the value of the right phase, and no block writes a
  site before every read of its previous value is done; a schedule that
  publishes before its edge chunks is caught;
- the walk's index arithmetic (``ring::chunk_rows``, ``ring::Walk``,
  ``ring::Slot``, the row wraps) and its held sites (the chunks a block
  keeps in shared memory, their copies in the planes stale until the
  write back; each read from where the kernel's rule takes it) with the
  plain site rule: S sweeps equal ``multisweep_planes_plain`` bitwise in
  the state, the sums to float64 rounding, each chunk's partial written
  once a sweep.

The wrapper's launch in this mode (its C arguments, its count, its
refusal where no layout fits) is held against a recording stand-in for
the built library."""

from contextlib import nullcontext

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from cuda_fortran_mc_simulation_spin_tpu_torch.core import rng
from cuda_fortran_mc_simulation_spin_tpu_torch.models import XY2D
from cuda_fortran_mc_simulation_spin_tpu_torch.models.xy2d import (
    XYState,
    metropolis_update,
)
from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
    multispin_rng,
    xy2d_pallas,
)
from cuda_fortran_mc_simulation_spin_tpu_torch.ops import xy2d_resident as xr

# the H100: 132 SMs, one block of 1024 threads an SM, 227 KB a block
SMS = 132
SMEM = 232448
CHUNK = 256

# the batches the device-memory mode serves on the main path (nx, nrep):
# past the shared-memory fit, and more replicas than block slots
MAIN_PATH = ((1500, 2), (1500, 3), (1000, 4), (1000, 5), (1000, 6),
             (512, 25), (64, 1600), (32, 6000))


def _owned(bounds, n):
    """Real sites each block of a ring owns."""
    return [min(b * CHUNK, n) - a * CHUNK for a, b in zip(bounds, bounds[1:])]


def _check_layout(lay, nrep, ny, half, slots, smem):
    n = ny * half
    chunks = -(-n // CHUNK)
    nb = lay.blocks
    assert nb >= 1 and 1 <= lay.rings <= nrep
    assert lay.rings * nb <= slots
    assert len(lay.bounds) == nb + 1
    assert lay.bounds[0] == 0 and lay.bounds[-1] == chunks
    assert all(a < b for a, b in zip(lay.bounds, lay.bounds[1:]))
    owned = _owned(lay.bounds, n)
    assert sum(owned) == n
    assert lay.cap == max(b - a for a, b in zip(lay.bounds,
                                                  lay.bounds[1:])) * CHUNK
    assert 0 <= lay.hold <= lay.cap // CHUNK
    assert lay.smem_bytes == (lay.cap // CHUNK * xr.CHUNK_BYTES
                              + lay.hold * xr.HELD_BYTES) <= smem
    # as many held chunks as the shared memory takes
    assert (lay.hold == lay.cap // CHUNK
            or lay.smem_bytes + xr.HELD_BYTES > smem)
    if nb > 1:
        # a ring a replica, every block at least half sites: its halos lie
        # in its two ring neighbours' ranges
        assert lay.rings == nrep and min(owned) >= half
        starts = [a * CHUNK for a in lay.bounds[:-1]]
        ends = [min(b * CHUNK, n) for b in lay.bounds[1:]]
        for j in range(nb):
            prev, nxt = (j - 1) % nb, (j + 1) % nb
            for w in (starts[j] - half, starts[j] - 1):
                assert starts[prev] <= w % n < ends[prev]
            for w in (ends[j], ends[j] + half - 1):
                assert starts[nxt] <= w % n < ends[nxt]
    # ring t takes replicas t, t + rings, ...: each replica exactly once
    taken = sorted(r for t in range(lay.rings)
                   for r in range(t, nrep, lay.rings))
    assert taken == list(range(nrep))
    if nrep > slots:
        assert nb == 1 and lay.rings == slots


@pytest.mark.parametrize("nx,nrep", MAIN_PATH)
def test_main_path_batches_get_a_layout(nx, nrep):
    """Every batch the old grid-barrier mode served on the main path gets
    a device-memory layout (and none fits the shared memory): 1500^2 x 2
    and x 3 on rings of 66 and 44 blocks, 1000^2 x 4-6, 512^2 x 25 on
    rings of 5, and the many-replica batches on rings of one."""
    half = nx // 2
    assert xr.smem_layout(nrep, nx, half, SMS, SMEM) is None
    lay = xr.gmem_layout(nrep, nx, half, SMS, SMEM)
    assert lay is not None
    _check_layout(lay, nrep, nx, half, SMS, SMEM)
    want = {(1500, 2): 66, (1500, 3): 44, (512, 25): 5, (64, 1600): 1,
            (32, 6000): 1}
    if (nx, nrep) in want:
        assert lay.blocks == want[nx, nrep]


@settings(max_examples=300, deadline=None)
@given(nrep=st.integers(1, 400), ny=st.integers(2, 3000),
       half=st.integers(1, 1600), slots=st.sampled_from([1, 2, 3, 66, 132,
                                                         264]),
       smem=st.sampled_from([4096, 115712, SMEM]))
def test_gmem_layout_invariants(nrep, ny, half, slots, smem):
    """Any (nrep, ny, even nx = 2 half) on any block slots and shared
    memory: the layout owns every chunk once, in whole chunks and in
    order; a ring of more than one block is one replica's, each block
    owning at least half sites; the rings take every replica once (rings
    of one in turn past the slots); None only where a block's sums pass
    the shared memory."""
    lay = xr.gmem_layout(nrep, ny, half, slots, smem)
    if lay is None:
        nb, bounds, cap = xr.ring_bounds(min(nrep, slots), ny, half, slots)
        assert cap // CHUNK * xr.CHUNK_BYTES > smem
        return
    _check_layout(lay, nrep, ny, half, slots, smem)


# ---------------------------------------------------------------------------
# the kernel's walk and index arithmetic, restated
# ---------------------------------------------------------------------------

def _walk(h, m, nch):
    """ring::Walk: the chunk of each position of a block's walk, and the
    positions of its edge chunks (the first and last h owned sites)."""
    head = min(-(-h // CHUNK), nch)
    tail = min(nch - (m - h) // CHUNK, nch - head)
    edges = head + tail

    def chunk(p):
        if p < head:
            return p
        return nch - tail + (p - head) if p < edges else p - tail
    return [chunk(p) for p in range(nch)], edges


class _Block:
    """Block b of a launch on layout ``lay``: its ring, range and walk."""

    def __init__(self, lay, ny, h, b):
        n = ny * h
        nb = lay.blocks
        self.t, j = divmod(b, nb)
        self.prev = self.t * nb + (j - 1) % nb
        self.next = self.t * nb + (j + 1) % nb
        self.c0 = lay.bounds[j]
        self.nch = lay.bounds[j + 1] - self.c0
        m = min(self.nch * CHUNK, n - self.c0 * CHUNK)
        self.alone = nb == 1
        self.order, edges = _walk(h, m, self.nch)
        self.edges = 0 if self.alone else edges
        # ring::chunk_rows: each chunk's first site as (row, column)
        w0 = (self.c0 + np.arange(self.nch)) * CHUNK
        self.rows = np.stack([w0 // h, w0 - w0 // h * h], axis=1)
        # the held chunks qa .. qb - 1 (the first past the head edge chunks,
        # all of a ring of one), sites sa .. sb - 1
        self.qa = 0 if self.alone else min(-(-h // CHUNK), self.nch)
        room = self.nch if self.alone else self.nch - edges
        self.qb = self.qa + min(lay.hold, max(room, 0))
        self.sa = (self.c0 + self.qa) * CHUNK
        self.sb = (min((self.c0 + self.qb) * CHUNK, n) if self.qb > self.qa
                   else self.sa)
        self.n, self.h = n, h

    def all_held(self, q):
        """Every other-colour read of chunk q lies in the held sites."""
        w0 = (self.c0 + q) * CHUNK
        return ((w0 - self.h >= self.sa and w0 + CHUNK + self.h <= self.sb)
                or (self.sa == 0 and self.sb == self.n))


def _sites(blk, q, ny, h, c):
    """The sites of chunk q of a block for colour c, as the kernel's threads
    find them (ring::Slot from the chunk's first site and the thread's
    offset; rows wrapping at the replica): (w, up, dn, side) for w < n."""
    n = ny * h
    tg = np.arange(CHUNK)
    dy, di = tg // h, tg - tg // h * h
    w = (blk.c0 + q) * CHUNK + tg
    keep = w < n
    w, dy, di = w[keep], dy[keep], di[keep]
    y = blk.rows[q, 0] + dy
    i = blk.rows[q, 1] + di
    wrap = i >= h
    i = np.where(wrap, i - h, i)
    y = np.where(wrap, y + 1, y)
    assert np.array_equal(y * h + i, w) and np.all(y < ny)
    plus = (c == 0) == ((y & 1) == 1)
    side = np.where(plus, np.where(i == h - 1, w - i, w + 1),
                    np.where(i == 0, w - i + h - 1, w - 1))
    up = np.where(w < h, w - h + n, w - h)
    dn = np.where(w >= n - h, w + h - n, w + h)
    return w, up, dn, side, y, i


# ---------------------------------------------------------------------------
# the schedule: flag waits and in-place stores under adversarial orders
# ---------------------------------------------------------------------------

def _program(lay, nrep, ny, h, sweeps, b, publish_at=None):
    """Block b's launch as events: ("wait", global phase), ("publish",
    count), ("chunk", replica, phase, chunk).  ``publish_at`` moves the
    flag to that walk position (a broken kernel, for the negative test)."""
    blk = _Block(lay, ny, h, b)
    at = blk.edges if publish_at is None else publish_at
    done = 0
    for r in range(blk.t, nrep, lay.rings):
        for k in range(2 * sweeps):
            if not blk.alone and done > 0:
                yield ("wait", done)
            for p, q in enumerate(blk.order):
                if p == at and not blk.alone:
                    yield ("publish", done + 1)
                yield ("chunk", r, k, q)
            if at >= blk.nch and not blk.alone:
                yield ("publish", done + 1)
            done += 1


def _expected_reads(lay, ny, h):
    """How many times a phase of the other colour reads each site of each
    colour (a site's four reads; duplicates where a row is one column)."""
    n = ny * h
    counts = np.zeros((2, n), dtype=np.int64)
    for b in range(lay.blocks):
        blk = _Block(lay, ny, h, b)
        for q in range(blk.nch):
            for c in (0, 1):
                w, up, dn, side, _, _ = _sites(blk, q, ny, h, c)
                for v in (w, up, dn, side):
                    np.add.at(counts[1 - c], v, 1)
    return counts


def _run_schedule(lay, nrep, ny, h, sweeps, pick, publish_at=None):
    """Runs every block's program in the order ``pick(runnable, step)``
    chooses (the blocks whose next event can run); returns the first
    violation as a string, or None.  versions[r, x, w] counts the writes
    of site w of colour x; a read in phase k must see the count of the
    phases of its colour before k, and a write must find every read of the
    previous phase done."""
    n = ny * h
    blocks = lay.rings * lay.blocks
    progs = [_program(lay, nrep, ny, h, sweeps, b, publish_at)
             for b in range(blocks)]
    nxt = [next(p, None) for p in progs]
    info = [_Block(lay, ny, h, b) for b in range(blocks)]
    flags = [0] * blocks
    versions = np.zeros((nrep, 2, n), dtype=np.int64)
    reads = np.zeros((nrep, 2, n), dtype=np.int64)
    want_reads = _expected_reads(lay, ny, h)
    step = 0

    def runnable(b):
        ev = nxt[b]
        if ev is None:
            return False
        if ev[0] != "wait":
            return True
        blk = info[b]
        return flags[blk.prev] >= ev[1] and flags[blk.next] >= ev[1]

    while any(ev is not None for ev in nxt):
        ready = [b for b in range(blocks) if runnable(b)]
        if not ready:
            return "deadlock"
        b = pick(ready, step)
        step += 1
        ev = nxt[b]
        if ev[0] == "publish":
            flags[b] = ev[1]
        elif ev[0] == "chunk":
            _, r, k, q = ev
            c = k & 1
            w, up, dn, side, _, _ = _sites(info[b], q, ny, h, c)
            seen = (k + c) // 2  # phases of the other colour before k
            for v in (w, up, dn, side):
                if np.any(versions[r, 1 - c, v] != seen):
                    return (f"block {b} phase {k} read colour {1 - c} of "
                            f"the wrong phase")
                np.add.at(reads[r, 1 - c], v, 1)
            if np.any(versions[r, c, w] != (k + 1 - c) // 2):
                return f"block {b} phase {k} updated a site twice"
            if np.any(reads[r, c, w] != (want_reads[c, w] if k else 0)):
                return (f"block {b} phase {k} wrote colour {c} before every "
                        "read of the last phase")
            reads[r, c, w] = 0
            versions[r, c, w] += 1
        nxt[b] = next(progs[b], None)
    if not np.all(versions == sweeps):
        return "a site missed an update"
    return None


def _pickers(blocks):
    """Adversarial orders: each block stalled while any other can run,
    random orders, one block run as far as it goes, round robin."""
    out = {f"stall {s}": (lambda s: lambda ready, step: next(
        (b for b in ready if b != s), s))(s) for s in range(blocks)}
    for seed in range(3):
        g = np.random.default_rng(seed)
        out[f"random {seed}"] = (lambda g: lambda ready, step: int(
            g.choice(ready)))(g)
    out["greedy"] = lambda ready, step: ready[-1]
    out["round robin"] = lambda ready, step: ready[step % len(ready)]
    return out


# (nrep, ny, half, slots): rings of 3 blocks with a ragged last chunk; a
# ring of 2 (prev = next); rings of one taking replicas in turn; four
# one-chunk blocks whose head chunk is their only edge; rows of an odd 77
# sites on rings of 2
SCHEDULES = [(2, 6, 300, 8), (1, 4, 300, 2), (5, 4, 10, 2), (1, 8, 128, 4),
             (2, 6, 77, 4)]


@pytest.mark.parametrize("nrep,ny,half,slots", SCHEDULES)
def test_schedule_reads_the_right_phase(nrep, ny, half, slots):
    """Under every adversarial order of the blocks, 3 sweeps of the
    launch's schedule read every site at the right phase and write no
    site a neighbour has yet to read."""
    lay = xr.gmem_layout(nrep, ny, half, slots, SMEM)
    for name, pick in _pickers(lay.rings * lay.blocks).items():
        assert _run_schedule(lay, nrep, ny, half, 3, pick) is None, name


@pytest.mark.parametrize("nrep,ny,half,slots", [(2, 6, 300, 8),
                                                (1, 8, 128, 4)])
def test_schedule_catches_an_early_flag(nrep, ny, half, slots):
    """A kernel that set its flag before its edge chunks would let a
    neighbour read a site of the last phase: some adversarial order shows
    it."""
    lay = xr.gmem_layout(nrep, ny, half, slots, SMEM)
    found = [_run_schedule(lay, nrep, ny, half, 2, pick, publish_at=0)
             for pick in _pickers(lay.rings * lay.blocks).values()]
    assert any(f is not None for f in found)


# ---------------------------------------------------------------------------
# the walk with the plain site rule against the plain multisweep
# ---------------------------------------------------------------------------

def _replay(st, snap, seeds, beta, lay, ny, h):
    """S sweeps of ``st`` ((ax, ay, bx, by) numpy float32 planes, flattened
    a replica, updated in place) as the launch walks them: every block of
    every ring, its chunks in walk order; its held sites copied out at the
    start and written back at the end, the planes' copies of them stale in
    between; each read from the held copy or the planes by the kernel's
    rule (a chunk whose reads all lie in the held sites reads the copy
    alone), each site's field in the kernel's order (up + dn) + (centre +
    side); the update by the plain rule on the gathered sites, each new
    spin stored where its site lives; the sums of each chunk into its
    partial, written once.  Returns the (R, S, 4) sums."""
    nrep, n = st[0].shape
    planes = np.stack(st).reshape(2, 2, nrep, n)  # colour, component
    sweeps = seeds.shape[0]
    nblk = -(-n // CHUNK)
    partials = np.full((nrep, sweeps, nblk, 4), np.nan)
    blocks = [_Block(lay, ny, h, b) for b in range(lay.rings * lay.blocks)]
    runs = [(blk, r) for blk in blocks for r in range(blk.t, nrep, lay.rings)]
    held = {(id(blk), r): planes[:, :, r, blk.sa:blk.sb].copy()
            for blk, r in runs}

    def read(blk, r, col, q, x, mine=None):
        """Sites x of colour col as block blk reads them in chunk q."""
        copy = held[id(blk), r][col]
        o = x - blk.sa
        if mine is None and blk.all_held(q):
            assert np.all((o >= 0) & (o < blk.sb - blk.sa))
            return copy[:, o]
        inside = (o >= 0) & (o < blk.sb - blk.sa) if mine is None else mine
        out = planes[col][:, r, x].copy()
        out[:, inside] = copy[:, o[inside]]
        return out

    for s in range(sweeps):
        for c in (0, 1):
            own = np.full((2, nrep, n), np.nan, dtype=np.float32)
            field = np.full((2, nrep, n), np.nan, dtype=np.float32)
            centre = np.full((2, nrep, n), np.nan, dtype=np.float32)
            visits = np.zeros((nrep, n), dtype=np.int64)
            for blk, r in runs:
                for q in blk.order:
                    w, up, dn, side, _, _ = _sites(blk, q, ny, h, c)
                    ce, u, d, sd = (read(blk, r, 1 - c, q, x)
                                    for x in (w, up, dn, side))
                    field[:, r, w] = (u + d) + (ce + sd)
                    centre[:, r, w] = ce
                    mine = np.full(w.shape, blk.qa <= q < blk.qb)
                    own[:, r, w] = read(blk, r, c, q, w, mine)
                    visits[r, w] += 1
            assert np.all(visits == 1)
            u_cand, u_acc = xy2d_pallas.draw_uniforms(seeds[s, c], nrep, ny,
                                                      h)
            new = np.stack([f.reshape(nrep, n).numpy() for f in
                            metropolis_update(
                                *(torch.from_numpy(p).view(nrep, ny, h)
                                  for p in (own[0], own[1], field[0],
                                            field[1])),
                                u_cand, u_acc, beta)])
            for blk, r in runs:
                for q in blk.order:
                    w = _sites(blk, q, ny, h, c)[0]
                    if blk.qa <= q < blk.qb:
                        held[id(blk), r][c][:, w - blk.sa] = new[:, r, w]
                    else:
                        planes[c][:, r, w] = new[:, r, w]
                    if c == 0:
                        continue
                    f64 = np.float64
                    fx, fy = new[:, r, w]
                    ox, oy = centre[:, r, w]
                    hx, hy = field[:, r, w]
                    sn = [p[r, w] for p in snap]  # (ax, ay, bx, by)
                    terms = (fx.astype(f64) + ox, fy.astype(f64) + oy,
                             (fx * hx + fy * hy).astype(f64),
                             (fx * sn[2] + fy * sn[3]).astype(f64)
                             + (ox * sn[0] + oy * sn[1]).astype(f64))
                    chunk = blk.c0 + q
                    assert np.all(np.isnan(partials[r, s, chunk]))
                    partials[r, s, chunk] = [t.sum() for t in terms]
    for blk, r in runs:
        planes[:, :, r, blk.sa:blk.sb] = held[id(blk), r]
    for p, q in zip(st, planes.reshape(4, nrep, n)):
        p[:] = q
    assert not np.any(np.isnan(partials))
    obs = partials.sum(axis=2)
    obs[..., 2] *= -1.0
    return obs


def _planes(nrep, ny, nx, seed):
    """(ax, ay, bx, by) float32 planes of random unit vectors."""
    g = np.random.default_rng(seed)
    th = g.uniform(0.0, 2.0 * np.pi, size=(2, nrep, ny, nx // 2))
    return [f(t).astype(np.float32) for t in th for f in (np.cos, np.sin)]


# (nrep, ny, nx, slots, shared memory a block): rings of 3 with a ragged
# last chunk, rings of 2 on rows of an odd 77 pairs (no chunk to hold);
# rings of one taking 5 replicas in turn, each held whole; a ring of 2
# blocks of 5 chunks holding their 3 interior chunks (the middle one's
# reads all held) and 2 of them (none all held); rings of one taking 3
# replicas in turn, 2 of 4 chunks held
REPLAYS = [(2, 6, 600, 8, SMEM), (2, 6, 154, 4, SMEM), (5, 4, 20, 2, SMEM),
           (1, 40, 128, 2, SMEM), (1, 40, 128, 2, 5 * 264 + 2 * 4096),
           (3, 8, 256, 1, 4 * 264 + 2 * 4096)]


@pytest.mark.parametrize("nrep,ny,nx,slots,smem", REPLAYS)
def test_walk_replay_matches_plain_multisweep(nrep, ny, nx, slots, smem):
    """4 sweeps replayed on the launch's walk, its held sites in their
    copies, equal multisweep_planes_plain bitwise in the state; the sums
    agree to float64 rounding (1e-12 relative: another order of the same
    float32 terms)."""
    model = XY2D(nx=nx, ny=ny, kbt=0.89)
    half = nx // 2
    lay = xr.gmem_layout(nrep, ny, half, slots, smem)
    want_hold = {(1, 40, 128, 2, SMEM): 3, (1, 40, 128, 2, 5 * 264 + 8192): 2,
                 (3, 8, 256, 1, 4 * 264 + 8192): 2}
    if (nrep, ny, nx, slots, smem) in want_hold:
        blocks = [_Block(lay, ny, half, b) for b in range(lay.blocks)]
        assert {b.qb - b.qa for b in blocks} == {
            want_hold[nrep, ny, nx, slots, smem]}
    seeds = multispin_rng.sweep_phase_keys(rng.sample_key(rng.base_key(9),
                                                          nrep), 4)
    state = _planes(nrep, ny, nx, 3 + ny)
    snap = _planes(nrep, ny, nx, 4 + ny)
    plain = XYState(*(torch.from_numpy(p.copy()) for p in state))
    want = xr.multisweep_planes_plain(
        plain, XYState(*(torch.from_numpy(p) for p in snap)), seeds,
        beta=model.beta)
    flat = [p.reshape(nrep, -1).copy() for p in state]
    got = _replay(flat, [p.reshape(nrep, -1) for p in snap],
                  seeds, model.beta, lay, ny, half)
    for p, q in zip(flat, plain):
        assert np.array_equal(p, q.reshape(nrep, -1).numpy())
    scale = np.maximum(np.abs(want.numpy()), 1.0)
    assert np.all(np.abs(got - want.numpy()) <= 1e-12 * scale)


# ---------------------------------------------------------------------------
# the wrapper's launch in this mode
# ---------------------------------------------------------------------------

class _FakeLib:
    """Records the C calls of the wrapper in place of the built library."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def call(*args):
            self.calls.append((name, args))
            return 0
        return call


def _fake(monkeypatch, slots=SMS, smem=SMEM):
    lib = _FakeLib()
    monkeypatch.setattr(xr, "_on_cpu", lambda t: False)
    monkeypatch.setattr(xy2d_pallas, "_check_planes", lambda *p: None)
    monkeypatch.setattr(xr, "_stream", lambda t: None)
    monkeypatch.setattr(xr, "_lib", lambda: lib)
    monkeypatch.setattr(xr, "smem_limits", lambda dev: (slots, smem))
    monkeypatch.setattr(xr, "gmem_limits", lambda dev: (slots, smem))
    monkeypatch.setattr(xr, "_RINGS", {})
    monkeypatch.setattr(torch.cuda, "device", lambda d: nullcontext())
    return lib


@pytest.mark.parametrize("nx,nrep", [(1500, 2), (64, 1600), (16, 3)])
def test_gmem_launch_takes_the_layout(nx, nrep, monkeypatch):
    """multisweep_planes past the fit (and forced at a batch that fits)
    launches xy_multisweep_gmem with gmem_layout's blocks a ring, rings,
    cap and bytes, and a flag a block; counted under "multisweep"."""
    lib = _fake(monkeypatch)
    planes = XYState(*(torch.zeros((nrep, nx, nx // 2)) for _ in range(4)))
    seeds = torch.zeros((3, 2, 2), dtype=torch.int32)
    xr.reset_launches()
    grid = xr.smem_layout(nrep, nx, nx // 2, SMS, SMEM) is not None
    obs = xr.multisweep_planes(planes, planes, seeds, beta=1.0, grid=grid)
    assert obs.shape == (nrep, 3, 4)
    (name, args), = lib.calls
    assert name == "xy_multisweep_gmem"
    lay = xr.gmem_layout(nrep, nx, nx // 2, SMS, SMEM)
    assert args[10:19] == (nrep, nx, nx // 2, 3, lay.blocks, lay.rings,
                           lay.cap, lay.hold, lay.smem_bytes)
    assert args[19] == -1.0
    assert xr.LAUNCHES == {"multisweep": 1, "multisweep_smem": 0}


def test_no_layout_raises(monkeypatch):
    """Where a block's sums pass its shared memory there is no layout: the
    wrapper raises and launches nothing (no quiet fallback)."""
    lib = _fake(monkeypatch, slots=1, smem=4096)
    planes = XYState(*(torch.zeros((1, 256, 128)) for _ in range(4)))
    seeds = torch.zeros((2, 2, 2), dtype=torch.int32)
    with pytest.raises(RuntimeError, match="no layout"):
        xr.multisweep_planes(planes, None, seeds, beta=1.0)
    assert lib.calls == []
