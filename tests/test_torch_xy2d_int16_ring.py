"""The device-memory mode of the int16 XY multisweep
(``csrc/xy2d_multisweep.cu`` ``gmem_multisweep_kernel``), replayed on the
CPU.

The kernel runs on the card only (tests/test_torch_cuda.py holds it
bitwise against ``multisweep_plain`` there).  What it relies on is held
here:

- the layout rule ``ops/xy2d_multisweep.gmem_layout``: every chunk of a
  replica owned once, in whole chunks and in order; the held chunks lie
  between a block's edge chunks, so no neighbour reads them; the decoded
  plane (the first held chunks and ``half`` sites either side) holds only
  the block's own sites and covers every read of the chunks it serves;
  the bytes within the limit, as many chunks held and then decoded as
  they allow; one ring a replica where their sums fit, else turns on as
  many rings as hold and decode every chunk no neighbour reads (or fit
  their sums), then as few as take the replicas in as many turns, so
  that every batch of JAX's bounds has a layout on the H100 (1536x1536
  x 23 and more on two rings of 66 blocks, more replicas than block slots
  on rings of one);
- the launch's schedule with over-relaxation phases and ``or_only``: each
  block's decode of its own sites before its flag wait, its walk (its
  edge chunks first, the flag, its other chunks) and its in-place
  stores, under adversarial interleavings: every read sees the value of
  the right phase, no write comes before the last phase's reads; the
  measure folded into the last OR phase b reads the right phase, while a
  separate measure pass that neither waits nor publishes reads colour-a
  sites a neighbour has already rewritten in the next sweep;
- the walk with its held and decoded sites and the plain site rule: S
  sweeps equal ``multisweep_plain`` bitwise in the state and the sums to
  float64 rounding, with n_or = 0, 1, ``or_only``, rings of one and rings
  of several blocks taking replicas in turn.

The wrapper's launch in this mode (its C arguments, its count, its
refusal where no layout fits) is held against a recording stand-in for
the built library."""

import functools
from contextlib import nullcontext

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from cuda_fortran_mc_simulation_spin_tpu_torch.core import rng
from cuda_fortran_mc_simulation_spin_tpu_torch.ops import trig
from cuda_fortran_mc_simulation_spin_tpu_torch.ops import xy2d_multisweep as xi
from cuda_fortran_mc_simulation_spin_tpu_torch.ops import xy2d_resident as xr

# the H100: 132 SMs, one block of 1024 threads an SM, 227 KB of shared
# memory a block less the runtime's 1 KB
SMS = 132
SMEM = 232448 - 1024
CHUNK = 256
BETA = 1.0 / 0.89


def _walk(h, m, nch):
    """ring::Walk: the chunk of each position of a block's walk, the
    number of edge chunks (those holding the first and last h owned
    sites) and of head chunks."""
    head = min(-(-h // CHUNK), nch)
    tail = min(nch - (m - h) // CHUNK, nch - head)
    edges = head + tail

    def chunk(p):
        if p < head:
            return p
        return nch - tail + (p - head) if p < edges else p - tail
    return [chunk(p) for p in range(nch)], edges, head


class _Block:
    """Block b of a launch on layout ``lay``, as the kernel sets it up: its
    ring, range, walk, held chunks and decoded plane."""

    def __init__(self, lay, ny, h, b):
        n = ny * h
        nb = lay.blocks
        self.t, j = divmod(b, nb)
        self.prev = self.t * nb + (j - 1) % nb
        self.next = self.t * nb + (j + 1) % nb
        self.c0 = lay.bounds[j]
        self.nch = lay.bounds[j + 1] - self.c0
        self.lo = self.c0 * CHUNK
        self.m = min(self.nch * CHUNK, n - self.lo)
        self.alone = nb == 1
        self.order, edges, head = _walk(h, self.m, self.nch)
        self.edges = 0 if self.alone else edges
        # ring::chunk_rows: each chunk's first site as (row, column)
        w0 = (self.c0 + np.arange(self.nch)) * CHUNK
        self.rows = np.stack([w0 // h, w0 - w0 // h * h], axis=1)
        # the held chunks qa .. qb - 1, sites sa .. sb - 1
        self.qa = 0 if self.alone else head
        room = self.nch if self.alone else self.nch - edges
        self.qb = self.qa + min(lay.hold, max(room, 0))
        self.sa = (self.c0 + self.qa) * CHUNK
        self.sb = (min((self.c0 + self.qb) * CHUNK, n) if self.qb > self.qa
                   else self.sa)
        # the decoded plane: slot l holds site dlo + l (modulo n)
        dq = min(lay.dec, self.qb - self.qa)
        self.db = min((self.c0 + self.qa + dq) * CHUNK, n) if dq else self.sa
        self.dlo = self.sa - h
        self.dspan = self.db - self.sa + 2 * h if dq else 0
        self.n, self.h = n, h

    def all_dec(self, q):
        """Every site of chunk q lies in sa .. db - 1: its reads at slots
        of the decoded plane."""
        w0 = (self.c0 + q) * CHUNK
        return w0 >= self.sa and min(w0 + CHUNK, self.n) <= self.db

    def slots(self, w, side):
        """The decoded plane's slots of the four reads (up, dn, centre,
        side) of sites w of a chunk in it, as the kernel takes them: w -
        dlo -+ half, w - dlo and the side's, rows unwrapped."""
        return (w - self.h - self.dlo, w + self.h - self.dlo, w - self.dlo,
                side - self.dlo)

    def dec_sites(self):
        """The sites of the decoded plane's slots, in slot order."""
        return (self.dlo + np.arange(self.dspan)) % self.n


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
    return w, up, dn, side


# ---------------------------------------------------------------------------
# the layout rule
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _blocks_hold_their_own(lay, ny, half):
    """Each block of a ring of ``lay`` holds no chunk a neighbour reads,
    and its decoded plane holds its own sites and every read of the
    chunks it serves (once a ring: batches on the same rings share it)."""
    span = lay.dec * CHUNK + 2 * half if lay.dec else 0
    for blk in (_Block(lay, ny, half, b) for b in range(lay.blocks)):
        assert blk.qb - blk.qa <= lay.hold
        assert blk.dspan <= span
        if not blk.alone and blk.sb > blk.sa:
            # no neighbour reads a held site: the neighbours read the
            # first and last half sites, and the decoded plane's margins
            # are this block's own edge sites
            assert blk.lo + half <= blk.sa < blk.sb <= blk.lo + blk.m - half
            if blk.dspan:
                assert blk.lo <= blk.dlo
                assert blk.dlo + blk.dspan <= blk.lo + blk.m
        for q in range(blk.nch):
            if not blk.all_dec(q):
                continue
            assert blk.qa <= q < blk.qb
            for c in (0, 1):
                w, up, dn, side = _sites(blk, q, ny, half, c)
                for o, x in zip(blk.slots(w, side), (up, dn, w, side)):
                    assert np.all((o >= 0) & (o < blk.dspan))
                    assert np.array_equal(blk.dec_sites()[o], x)
    return True


def _check_layout(lay, nrep, ny, half, slots, smem):
    n = ny * half
    chunks = -(-n // CHUNK)
    nb = lay.blocks
    assert nb >= 1 and 1 <= lay.rings <= nrep and lay.rings * nb <= slots
    assert lay.bounds[0] == 0 and lay.bounds[-1] == chunks
    assert all(a < b for a, b in zip(lay.bounds, lay.bounds[1:]))
    owned = [min(b * CHUNK, n) - a * CHUNK
             for a, b in zip(lay.bounds, lay.bounds[1:])]
    assert sum(owned) == n
    assert lay.cap == max(b - a for a, b in zip(lay.bounds,
                                                  lay.bounds[1:])) * CHUNK
    assert 0 <= lay.dec <= lay.hold <= lay.cap // CHUNK
    # the bytes: 264 B a chunk, 1 KB a held chunk, the decoded plane
    span = lay.dec * CHUNK + 2 * half if lay.dec else 0
    assert lay.smem_bytes == (lay.cap // CHUNK * 264 + lay.hold * 1024
                              + 8 * span) <= smem
    blocks = [_Block(lay, ny, half, b) for b in range(nb)]
    # as many chunks held as a block has room for (those between its edge
    # chunks) or the bytes take, then as many of them decoded
    room = max(max(b.nch - b.edges for b in blocks), 0)
    assert max(b.qb - b.qa for b in blocks) == lay.hold <= room
    assert (lay.hold == room
            or lay.cap // CHUNK * 264 + (lay.hold + 1) * 1024 > smem)
    if lay.dec < lay.hold:
        more = 8 * ((lay.dec + 1) * CHUNK + 2 * half)
        assert lay.cap // CHUNK * 264 + lay.hold * 1024 + more > smem
    assert _blocks_hold_their_own(lay._replace(rings=1), ny, half)
    if nb > 1:
        assert min(owned) >= half
    taken = sorted(r for t in range(lay.rings)
                   for r in range(t, nrep, lay.rings))
    assert taken == list(range(nrep))
    # one turn where one ring a replica fits its sums; else as few turns
    # as rings that decode all they hold allow (or, where none do, rings
    # whose sums fit); then as few rings as take the replicas in those
    # turns
    turns = -(-nrep // lay.rings)
    assert lay.rings == -(-nrep // turns)
    assert (lay.blocks, lay.bounds, lay.cap) == xr.ring_bounds(
        lay.rings, ny, half, slots)

    def sums_fit(r):
        return r <= min(nrep, slots) and xr.ring_bounds(
            r, ny, half, slots)[2] // CHUNK * 264 <= smem

    def decodes_all(r):
        other = sums_fit(r) and xi._gmem_rings(r, ny, half, slots, smem)
        return bool(other) and other.dec == other.hold == max(
            b.nch - b.edges for b in (_Block(other, ny, half, k)
                                      for k in range(other.blocks)))
    if turns > 1:
        assert not sums_fit(nrep)
        more = -(-nrep // (turns - 1))
        if lay.dec == lay.hold == room:
            assert not decodes_all(more)
        else:
            assert not decodes_all(1) and not sums_fit(more)


@pytest.mark.parametrize("n,nrep,want", [
    (1536, 2, (66, 2, 64, 64, 227376)), (1536, 3, (44, 3, 99, 43, 229448)),
    (1536, 23, (66, 2, 64, 64, 227376)), (1536, 133, (66, 2, 64, 64, 227376)),
    (1024, 45, (33, 4, 59, 59, 206072)),
    (64, 1600, (1, 124, 8, 8, 27200)), (32, 133, (1, 67, 2, 2, 6928))])
def test_main_path_batches_get_a_layout(n, nrep, want):
    """The int16 batches past the shared-memory fit: 1536x1536 x 2 on
    rings of 66 blocks holding and decoding all 64 chunks between their
    edge chunks (227,376 B a block), x 3 on rings of 44 holding 99 and
    decoding 43; x 23 and x 133, whose sums would not fit one ring a
    replica, in turns on the two rings of 66 blocks that decode all they
    hold, and 1024x1024 x 45 on 4 rings of 33 in 12 turns; more replicas
    than block slots on rings of one, each holding and decoding its whole
    replica, 124 rings in 13 turns and 67 in 2."""
    assert xi.smem_layout(nrep, n, n // 2, SMS, SMEM) is None
    lay = xi.gmem_layout(nrep, n, n // 2, SMS, SMEM)
    assert (lay.blocks, lay.rings, lay.hold, lay.dec,
            lay.smem_bytes) == want
    _check_layout(lay, nrep, n, n // 2, SMS, SMEM)


@settings(max_examples=200, deadline=None)
@given(nrep=st.integers(1, 300), ny=st.integers(2, 400),
       half=st.integers(1, 400), slots=st.sampled_from([1, 2, 3, 66, 132]),
       smem=st.sampled_from([4096, 20000, 115712, SMEM]))
def test_gmem_layout_invariants(nrep, ny, half, slots, smem):
    """Any (nrep, ny, even nx = 2 half) on any block slots and shared
    memory: the layout owns every chunk once; no neighbour reads a held
    chunk; the decoded plane holds the block's own sites and covers every
    read of the chunks it serves; the bytes within the limit; one turn
    where it fits, else the rings that decode all they hold, balanced
    over the turns; None only where the sums of one ring of the most
    blocks pass the limit."""
    lay = xi.gmem_layout(nrep, ny, half, slots, smem)
    if lay is None:
        cap = xr.ring_bounds(1, ny, half, slots)[2]
        assert cap // CHUNK * 264 > smem
        return
    _check_layout(lay, nrep, ny, half, slots, smem)


@settings(max_examples=60, deadline=None)
@given(data=st.data())
def test_every_batch_of_jax_bounds_gets_a_layout(data):
    """Every batch the int16 route takes (JAX's bounds: the four int16
    planes of a replica within 9 MiB, ny a multiple of 16) whose sites
    the kernel can index has a layout on the H100's block slots and
    shared memory, of any number of replicas: the rings fit their sums,
    take every replica and lie within the slots."""
    ny = 16 * data.draw(st.integers(1, 96))
    half = data.draw(st.integers(1, xi.VMEM_ANGLE_BUDGET // (8 * ny)))
    nrep = data.draw(st.integers(1, min(65535,
                                        (2 ** 31 - 1) // (ny * half))))
    assert xi.fits(ny, half)
    lay = xi.gmem_layout(nrep, ny, half, SMS, SMEM)
    assert lay is not None
    assert lay.smem_bytes <= SMEM and lay.rings * lay.blocks <= SMS
    assert 1 <= lay.rings <= nrep
    assert lay.bounds[-1] == -(-ny * half // CHUNK)
    if lay.blocks > 1:
        assert min(b - a for a, b in zip(lay.bounds, lay.bounds[1:])
                   ) * CHUNK >= half


# ---------------------------------------------------------------------------
# the schedule: flag waits and in-place stores under adversarial orders
# ---------------------------------------------------------------------------

def _per(n_or, or_only):
    """Updating phases a sweep: two Metropolis (but with or_only) and two
    an OR sweep."""
    return (0 if or_only else 2) + 2 * (max(n_or, 1) if or_only else n_or)


def _program(lay, nrep, ny, h, sweeps, per, b, fused=True, publish_at=None):
    """Block b's launch as events: ("decode", replica, phase), ("wait",
    count), ("publish", count), ("chunk", replica, phase, chunk) and,
    without ``fused``, a measure pass after each sweep's last phase that
    neither waits nor publishes, ("measure", replica, phases so far).
    ``publish_at`` moves the flag to that walk position (a broken kernel,
    for the negative test)."""
    blk = _Block(lay, ny, h, b)
    at = blk.edges if publish_at is None else publish_at
    done = 0
    for r in range(blk.t, nrep, lay.rings):
        for s in range(sweeps):
            for i in range(per):
                k = s * per + i
                yield ("decode", r, k)
                if not blk.alone and done > 0:
                    yield ("wait", done)
                for p, q in enumerate(blk.order):
                    if p == at and not blk.alone:
                        yield ("publish", done + 1)
                    yield ("chunk", r, k, q)
                if at >= blk.nch and not blk.alone:
                    yield ("publish", done + 1)
                done += 1
            if not fused:
                yield ("measure", r, (s + 1) * per)


def _expected_reads(lay, ny, h):
    """How many times a phase of the other colour reads each site of each
    colour (a site's four reads; duplicates where a row is one column)."""
    counts = np.zeros((2, ny * h), dtype=np.int64)
    for b in range(lay.blocks):
        blk = _Block(lay, ny, h, b)
        for q in range(blk.nch):
            for c in (0, 1):
                for v in _sites(blk, q, ny, h, c):
                    np.add.at(counts[1 - c], v, 1)
    return counts


def _run_schedule(lay, nrep, ny, h, sweeps, per, pick, fused=True,
                  publish_at=None):
    """Runs every block's program in the order ``pick(runnable, step)``
    chooses; returns the first violation as a string, or None.
    versions[r, x, w] counts the writes of site w of colour x; a read in
    phase k (or a measure pass after k phases) must see the count of the
    phases of its colour before k, and a write must find every read of the
    previous phase done."""
    n = ny * h
    blocks = lay.rings * lay.blocks
    progs = [_program(lay, nrep, ny, h, sweeps, per, b, fused, publish_at)
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
        blk = info[b]
        if ev[0] == "publish":
            flags[b] = ev[1]
        elif ev[0] == "decode":
            _, r, k = ev
            o = 1 - (k & 1)
            if np.any(versions[r, o, blk.dec_sites()] != (k + 1 - o) // 2):
                return f"block {b} phase {k} decoded the wrong phase"
        elif ev[0] == "measure":
            _, r, k = ev
            for q in range(blk.nch):
                w, up, dn, side = _sites(blk, q, ny, h, 1)
                if (np.any(versions[r, 1, w] != k // 2) or any(
                        np.any(versions[r, 0, v] != k // 2)
                        for v in (w, up, dn, side))):
                    return (f"block {b}'s measure pass after phase {k - 1} "
                            "read a site of another phase")
        elif ev[0] == "chunk":
            _, r, k, q = ev
            c = k & 1
            w, up, dn, side = _sites(blk, q, ny, h, c)
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
    if not np.all(versions == sweeps * per // 2):
        return "a site missed an update"
    return None


def _pickers(blocks):
    """Adversarial orders: each block stalled while any other can run,
    random orders, one block run as far as it goes, round robin."""
    out = {f"stall {s}": (lambda s: lambda ready, step: next(
        (b for b in ready if b != s), s))(s) for s in range(blocks)}
    for seed in range(2):
        g = np.random.default_rng(seed)
        out[f"random {seed}"] = (lambda g: lambda ready, step: int(
            g.choice(ready)))(g)
    out["greedy"] = lambda ready, step: ready[-1]
    out["round robin"] = lambda ready, step: ready[step % len(ready)]
    return out


# (nrep, ny, half, slots, shared memory): rings of 3 with a ragged last
# chunk holding and decoding; a ring of 2 (prev = next); rings of one
# taking replicas in turn; four one-chunk blocks whose head chunk is their
# only edge; two rings of 2 blocks taking 5 replicas in turn (the sums of
# 4 rings of one would not fit; these hold and decode their 2 interior
# chunks)
SCHEDULES = [(2, 6, 300, 8, SMEM), (1, 4, 300, 2, SMEM), (5, 4, 10, 2, SMEM),
             (1, 8, 128, 4, SMEM), (5, 16, 128, 4, 9248)]


@pytest.mark.parametrize("n_or,or_only", [(0, False), (1, False), (2, True)])
@pytest.mark.parametrize("nrep,ny,half,slots,smem", SCHEDULES)
def test_schedule_reads_the_right_phase(nrep, ny, half, slots, smem, n_or,
                                        or_only):
    """Under every adversarial order of the blocks, 2 sweeps of the
    launch's schedule (Metropolis only, with an OR sweep, OR only with
    two) decode and read every site at the right phase and write no site
    a neighbour has yet to read; the measure folded into the last phase
    reads the same."""
    lay = xi.gmem_layout(nrep, ny, half, slots, smem)
    if smem < SMEM:
        assert (lay.blocks, lay.rings, lay.hold, lay.dec) == (2, 2, 2, 2)
    per = _per(n_or, or_only)
    for name, pick in _pickers(lay.rings * lay.blocks).items():
        assert _run_schedule(lay, nrep, ny, half, 2, per, pick) is None, name


def test_schedule_catches_an_early_flag():
    """A kernel that set its flag before its edge chunks would let a
    neighbour read a site of the last phase: some adversarial order shows
    it."""
    lay = xi.gmem_layout(2, 6, 300, 8, SMEM)
    found = [_run_schedule(lay, 2, 6, 300, 2, 4, pick, publish_at=0)
             for pick in _pickers(lay.rings * lay.blocks).values()]
    assert any(f is not None for f in found)


@pytest.mark.parametrize("nrep,ny,half,slots", [(2, 6, 300, 8),
                                                (1, 8, 128, 4)])
def test_separate_measure_pass_reads_a_rewritten_site(nrep, ny, half,
                                                      slots):
    """With the planes in device memory a measure pass after the last OR
    phase b that neither waits nor publishes (the shared-memory mode's
    former pass) reads colour-a edge sites that a neighbour, having waited
    only on the block's flag of phase b, rewrites in the next sweep's
    phase a: some adversarial order shows it, with an OR sweep and OR
    only.  The measure folded into phase b passes every order."""
    lay = xi.gmem_layout(nrep, ny, half, slots, SMEM)
    pickers = _pickers(lay.rings * lay.blocks)
    for per in (_per(1, False), _per(1, True)):
        found = [_run_schedule(lay, nrep, ny, half, 2, per, pick,
                               fused=False) for pick in pickers.values()]
        assert any(f is not None and "measure pass" in f for f in found)
        for name, pick in pickers.items():
            assert _run_schedule(lay, nrep, ny, half, 2, per,
                                 pick) is None, name


# ---------------------------------------------------------------------------
# the walk with the plain site rule against the plain multisweep
# ---------------------------------------------------------------------------

def _cs(k):
    return xi._cs(torch.from_numpy(np.asarray(k, dtype=np.int32)))


def _replay(pa, pb, snap_a, snap_b, seeds, lay, ny, h, n_or, or_only):
    """S sweeps of the int16 planes (pa, pb: numpy (R, n), updated in
    place) as the launch walks them: every block of every ring, its chunks
    in walk order; its held sites copied out at the start and written back
    at the end, the planes' copies of them stale in between; each phase's
    decoded plane taken from where the kernel reads it (held or the
    planes) before the phase; each read from the decoded plane, the held
    copy or the planes by the kernel's rule (a chunk whose reads all lie
    in the decoded plane reads it alone), the field in the kernel's order
    (up + dn) + (centre + side); the update by the plain rule on the
    gathered sites, each new angle stored where its site lives; the last
    phase of a sweep measuring, each chunk's partial written once.
    Returns the (R, S, 4) sums."""
    nrep, n = pa.shape
    planes = np.stack([pa, pb])  # colour, replica, site
    sweeps = seeds.shape[0]
    per = _per(n_or, or_only)
    nblk = -(-n // CHUNK)
    partials = np.full((nrep, sweeps, nblk, 4), np.nan)
    blocks = [_Block(lay, ny, h, b) for b in range(lay.rings * lay.blocks)]
    runs = [(blk, r) for blk in blocks for r in range(blk.t, nrep, lay.rings)]
    held = {(id(blk), r): planes[:, r, blk.sa:blk.sb].copy()
            for blk, r in runs}
    f32 = trig.f32

    def angle(blk, r, col, x):
        """angle_at: sites x of colour col, held or from the planes."""
        o = x - blk.sa
        inside = (o >= 0) & (o < blk.sb - blk.sa)
        out = planes[col, r, x].astype(np.int32)
        out[inside] = held[id(blk), r][col][o[inside]]
        return out

    for s in range(sweeps):
        for i in range(per):
            c, o = i & 1, 1 - (i & 1)
            reflect, measuring = or_only or i >= 2, i == per - 1
            dec = {(id(blk), r): angle(blk, r, o, blk.dec_sites())
                   for blk, r in runs}
            # the other colour's four reads, the site's own angle and
            # colour a's angle at a b site, as gathered
            got = np.full((6, nrep, n), -10 ** 6, dtype=np.int32)
            for blk, r in runs:
                d = dec[id(blk), r]
                for q in blk.order:
                    w, up, dn, side = _sites(blk, q, ny, h, c)
                    slots = blk.slots(w, side)
                    for j, x in enumerate((up, dn, w, side)):
                        if blk.all_dec(q):
                            assert np.all((slots[j] >= 0)
                                          & (slots[j] < blk.dspan))
                            got[j, r, w] = d[slots[j]]
                            continue
                        off = x - blk.dlo
                        inside = (off >= 0) & (off < blk.dspan)
                        v = angle(blk, r, o, x)
                        v[inside] = d[off[inside]]
                        got[j, r, w] = v
                    mine = blk.qa <= q < blk.qb
                    got[4, r, w] = (held[id(blk), r][c][w - blk.sa] if mine
                                    else planes[c, r, w])
                    got[5, r, w] = angle(blk, r, o, w)
            assert np.all(got[:5] > -10 ** 6)
            g = torch.from_numpy(got).view(6, nrep, ny, h)
            comps = [_cs(g[j].numpy()) for j in range(4)]
            hx = (comps[0][0] + comps[1][0]) + (comps[2][0] + comps[3][0])
            hy = (comps[0][1] + comps[1][1]) + (comps[2][1] + comps[3][1])
            k = g[4]
            if reflect:
                phi = xi._atan2_units(hy, hx)
                new = (2 * torch.round(phi).to(torch.int32) - k).to(
                    torch.int16).to(torch.int32)
                bx, by = xi._cs(new)
            else:
                cx, sx = xi._cs(k)
                cand, u = xi._words(seeds[s][c], nrep, ny, h, "cpu")
                cc, cs = xi._cs(cand)
                de = -((cc - cx) * hx + (cs - sx) * hy)
                p = torch.exp(torch.maximum(de, f32(0.0)) * f32(-BETA))
                accept = u < p
                new = torch.where(accept, cand, k)
                bx, by = torch.where(accept, cc, cx), torch.where(accept, cs,
                                                                  sx)
            flat = [t.reshape(nrep, n).numpy() for t in (new, bx, by, hx, hy)]
            for blk, r in runs:
                for q in blk.order:
                    w = _sites(blk, q, ny, h, c)[0]
                    nw = flat[0][r, w].astype(np.int16)
                    if blk.qa <= q < blk.qb:
                        held[id(blk), r][c][w - blk.sa] = nw
                    else:
                        planes[c, r, w] = nw
                    if not measuring:
                        continue
                    f64 = np.float64
                    kb, fx, fy, fhx, fhy = (f[r, w] for f in flat)
                    ox, oy = (t.reshape(nrep, n).numpy()[r, w]
                              for t in comps[2])
                    ca = _cs(snap_a[r, w].astype(np.int32) - got[5, r, w])[0]
                    cb = _cs(snap_b[r, w].astype(np.int32) - kb)[0]
                    terms = (fx.astype(f64) + ox, fy.astype(f64) + oy,
                             (fx * fhx + fy * fhy).astype(f64),
                             ca.numpy().astype(f64) + cb.numpy())
                    chunk = blk.c0 + q
                    assert np.all(np.isnan(partials[r, s, chunk]))
                    partials[r, s, chunk] = [t.sum() for t in terms]
    for blk, r in runs:
        planes[:, r, blk.sa:blk.sb] = held[id(blk), r]
    pa[:], pb[:] = planes
    assert not np.any(np.isnan(partials))
    obs = partials.sum(axis=2)
    obs[..., 2] *= -1.0
    return obs


# (nrep, ny, nx, slots, shared memory a block): rings of 3 with a ragged
# last chunk; a ring of 2 blocks of 5 chunks holding and decoding their 3
# interior chunks (the middle one's reads all decoded), holding 3 and
# decoding 1, holding 2 and decoding none; rings of one taking 5 replicas
# in turn, each held and decoded whole; rings of one taking 3 replicas in
# turn, all 4 chunks held and 1 decoded (its plane's first half sites the
# replica's last, wrapped), and 2 of 4 held, none decoded; two rings of 2
# blocks taking 5 replicas in turn, each block holding and decoding its 2
# interior chunks (the sums of 4 rings of one would not fit)
REPLAYS = [(2, 6, 600, 8, SMEM), (1, 40, 128, 2, SMEM),
           (1, 40, 128, 2, 5 * 264 + 3 * 1024 + 8 * (256 + 128)),
           (1, 40, 128, 2, 5 * 264 + 2 * 1024), (5, 4, 20, 2, SMEM),
           (3, 8, 256, 1, 4 * 264 + 4 * 1024 + 8 * (256 + 256)),
           (3, 8, 256, 1, 4 * 264 + 2 * 1024), (5, 16, 256, 4, 9248)]


@pytest.mark.parametrize("n_or,or_only", [(0, False), (1, False), (2, True)])
@pytest.mark.parametrize("nrep,ny,nx,slots,smem", REPLAYS)
def test_walk_replay_matches_plain_multisweep(nrep, ny, nx, slots, smem,
                                              n_or, or_only):
    """3 sweeps replayed on the launch's walk, its held and decoded sites
    where the kernel keeps them, equal multisweep_plain bitwise in the
    int16 state (Metropolis only, with an OR sweep and OR only with two);
    the sums agree to float64 rounding (1e-12 relative: another order of
    the same float32 terms)."""
    half = nx // 2
    lay = xi.gmem_layout(nrep, ny, half, slots, smem)
    want_split = {(1, 40, 128, 2, SMEM): (3, 3),
                  (1, 40, 128, 2, 5 * 264 + 3 * 1024 + 8 * 384): (3, 1),
                  (1, 40, 128, 2, 5 * 264 + 2 * 1024): (2, 0),
                  (5, 4, 20, 2, SMEM): (1, 1),
                  (3, 8, 256, 1, 4 * 264 + 4 * 1024 + 8 * 512): (4, 1),
                  (3, 8, 256, 1, 4 * 264 + 2 * 1024): (2, 0),
                  (5, 16, 256, 4, 9248): (2, 2)}
    if (nrep, ny, nx, slots, smem) in want_split:
        assert (lay.hold, lay.dec) == want_split[nrep, ny, nx, slots, smem]
    if (nrep, ny, nx, slots, smem) == (5, 16, 256, 4, 9248):
        assert (lay.blocks, lay.rings) == (2, 2)
    _replay_matches_plain(lay, nrep, ny, half, n_or, or_only)


@pytest.mark.parametrize("n_or,or_only", [(0, False), (1, True)])
def test_walk_replay_one_ring_takes_every_replica(n_or, or_only):
    """The kernel takes any number of rings up to the replicas: one ring
    of 2 blocks, each holding and decoding its 3 interior chunks, taking 3
    replicas in turn (its held sites written back and the next replica's
    loaded and decoded between them) equals multisweep_plain as above."""
    lay = xi.gmem_layout(1, 40, 64, 2, SMEM)._replace(rings=1)
    assert (lay.blocks, lay.hold, lay.dec) == (2, 3, 3)
    _replay_matches_plain(lay, 3, 40, 64, n_or, or_only)


def _replay_matches_plain(lay, nrep, ny, half, n_or, or_only):
    nx = 2 * half
    seeds = xi.multispin_rng.sweep_phase_keys(
        rng.sample_key(rng.base_key(9), nrep), 3)
    g = np.random.default_rng(ny + nx + n_or)
    pa, pb, sa, sb = (g.integers(-2 ** 15, 2 ** 15, size=(nrep, ny, half))
                      .astype(np.int16) for _ in range(4))
    ta, tb = torch.from_numpy(pa.copy()), torch.from_numpy(pb.copy())
    want = xi.multisweep_plain(ta, tb, torch.from_numpy(sa),
                               torch.from_numpy(sb), seeds, beta=BETA,
                               n_or=n_or, or_only=or_only)
    fa, fb = pa.reshape(nrep, -1).copy(), pb.reshape(nrep, -1).copy()
    got = _replay(fa, fb, sa.reshape(nrep, -1), sb.reshape(nrep, -1), seeds,
                  lay, ny, half, n_or, or_only)
    assert np.array_equal(fa, ta.reshape(nrep, -1).numpy())
    assert np.array_equal(fb, tb.reshape(nrep, -1).numpy())
    assert not np.array_equal(fa, pa.reshape(nrep, -1))
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
    monkeypatch.setattr(xi, "_on_cpu", lambda t: False)
    monkeypatch.setattr(xi, "_check", lambda planes: None)
    monkeypatch.setattr(xi, "_stream", lambda t: None)
    monkeypatch.setattr(xi, "_lib", lambda: lib)
    monkeypatch.setattr(xi, "smem_limits", lambda dev: (slots, smem))
    monkeypatch.setattr(xi, "gmem_limits", lambda dev: (slots, smem))
    monkeypatch.setattr(xi, "_RINGS", {})
    monkeypatch.setattr(xi.multispin_rng, "keys_to", lambda seeds, dev: seeds)
    monkeypatch.setattr(torch.cuda, "device", lambda d: nullcontext())
    return lib


@pytest.mark.parametrize("n,nrep,n_or,or_only", [
    (1536, 2, 0, False), (1536, 3, 1, False), (1536, 32, 0, False),
    (64, 1600, 2, True), (16, 3, 0, False)])
def test_gmem_launch_takes_the_layout(n, nrep, n_or, or_only, monkeypatch):
    """multisweep_planes past the fit (and forced at a batch that fits)
    launches xyi_multisweep_gmem with gmem_layout's blocks a ring, rings,
    cap, held and decoded chunks and bytes, and a flag a block; counted
    under "multisweep"."""
    lib = _fake(monkeypatch)
    # the planes' shape alone: the launch is recorded, not run
    planes = [torch.zeros((1, n, n // 2), dtype=torch.int16).expand(
        nrep, -1, -1) for _ in range(4)]
    seeds = torch.zeros((3, 2, 2), dtype=torch.int32)
    xi.reset_launches()
    grid = xi.smem_layout(nrep, n, n // 2, SMS, SMEM) is not None
    obs = xi.multisweep_planes(*planes, seeds, beta=1.0, n_or=n_or,
                               or_only=or_only, grid=grid)
    assert obs.shape == (nrep, 3, 4)
    (name, args), = lib.calls
    assert name == "xyi_multisweep_gmem"
    lay = xi.gmem_layout(nrep, n, n // 2, SMS, SMEM)
    assert args[9:21] == (nrep, n, n // 2, 3, n_or, int(or_only), lay.blocks,
                          lay.rings, lay.cap, lay.hold, lay.dec,
                          lay.smem_bytes)
    assert args[21] == -1.0
    assert xi.LAUNCHES == {"multisweep": 1, "multisweep_smem": 0}


def test_no_layout_raises(monkeypatch):
    """Where a block's sums pass its shared memory there is no layout: the
    wrapper raises and launches nothing (no quiet fallback)."""
    lib = _fake(monkeypatch, slots=1, smem=4096)
    planes = [torch.zeros((1, 256, 128), dtype=torch.int16)
              for _ in range(4)]
    seeds = torch.zeros((2, 2, 2), dtype=torch.int32)
    with pytest.raises(RuntimeError, match="no layout"):
        xi.multisweep_planes(*planes, seeds, beta=1.0)
    assert lib.calls == []
