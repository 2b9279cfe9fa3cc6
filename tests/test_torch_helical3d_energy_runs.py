"""The helical 3-D energy kernel's runs, replayed on the CPU.

``csrc/helical3d_multispin.cu`` ``energy_kernel`` sums the exact (m, e)
of (R, W) colour vectors in runs of K words a thread, from the constants
the wrapper passes (``h3.energy_runs``).  These tests walk that launch in
numpy from the same constants, warp by warp: run t of a replica holds
words K t - c .., c the replica's first word of colour a mod 4 at the
tensor's real word offset; a bulk run loads six windows as the 16-B
vectors that hold them, takes the vector past its own from the next lane
(as the shuffle does) or loads it (lane 31, the last bulk run), picks the
plane's words at its offset in the vector and funnel-shifts them by d &
31; every other run reads each word's six planes modularly (read_circ).

Every word must be summed exactly once, no bulk window may read a word
past W - 1 of its replica or before the 16-B vector that holds the
tensor's first word, and the sums must equal ``h3.energy_sums_plain``
bitwise (which ``tests/test_torch_helical3d.py`` holds against the JAX
package's ``_halo_energy`` and ``_energy_all_packed``).

Shapes: odd and even nx·ny; M % 32 = 0 and not; a replica shorter than
one run (M = 30); bulk runs and the runs where a plane wraps (the seam);
R = 1 and 3; vectors at an aligned address and a few words past one,
the two colours at different offsets.
"""

import numpy as np
import pytest
import torch

from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
    helical3d_multispin as h3,
)
from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
    helical_multispin as hms,
)

M32 = 0xFFFFFFFF
# (nx, ny, nz): odd nx·ny M = 30 (one word), 105 (M % 32 = 9), 20475
# (M % 32 = 27); even nx·ny M = 60, 35991 (M % 32 = 23, h = 64, the far
# planes 3999 bits on), 5280 (M % 32 = 0)
SHAPES = [(5, 3, 4), (7, 5, 6), (65, 63, 10), (5, 4, 6), (129, 62, 9),
          (33, 32, 10)]
# the smoke's launches (R, nx, ny, nz): its check shapes at even nx·ny
# and the even streamed class's, and its edges
SMOKE_LAUNCHES = [(2, 1001, 1000, 1000), (1, 1001, 1000, 1000),
                  (3, 129, 62, 9), (2, 65, 63, 10), (1, 7, 5, 6)]


def _words(g, nrep: int, m: int) -> np.ndarray:
    """(R, W) uint32 words, pad bits random too."""
    return g.integers(0, 2 ** 32, size=(nrep, hms.words(m)),
                      dtype=np.uint64).astype(np.uint32)


def _read_circ(bits: np.ndarray, start: int) -> int:
    """32 bits of the circular bit sequence from ``start`` on."""
    m = bits.size
    idx = (start + np.arange(32)) % m
    return int((bits[idx].astype(np.uint64) << np.arange(32,
                                                          dtype=np.uint64)
                ).sum())


def _popc(x: int) -> int:
    return bin(x & M32).count("1")


def replay(wa, wb, nx: int, nxy: int, m: int, offsets=(0, 0)):
    """energy_kernel on numpy (R, W) uint32 vectors; ``offsets`` the two
    tensors' first words mod 4 (their real addresses' 16-B offsets).
    Returns ((R, 2) int64 (m, e), the times each word was summed)."""
    nrep, nw = wa.shape
    t = h3.energy_runs(nrep, nx, nxy, m)
    k_run, nruns, bulk = t["run"], t["nruns"], t["bulk"]
    q, sh = t["q"], t["sh"]
    d = [dd % m for _, _, dd in h3._energy_pairs(nx, nxy)]
    self_z = nxy % 2 == 0
    assert nruns * k_run >= nw + 3 and 1 <= t["blocks"] <= 65535
    assert all(dd >> 5 == qq and dd & 31 == ss
               for dd, qq, ss in zip(d, q, sh))
    if bulk:
        assert d[0] == 0 and d[2] == 1
    obs = np.zeros((nrep, 2), np.int64)
    seen = np.zeros((nrep, nw), np.int64)
    stride = t["blocks"] * h3.ENERGY_THREADS
    cols = {"a": wa, "b": wb}
    off = {"a": offsets[0], "b": offsets[1]}
    nbr = ["b", "b", "a", "a", "a" if self_z else "b",
           "b" if self_z else "a"]
    for rep in range(nrep):
        bits = {c: ((v[rep].astype(np.uint64)[:, None]
                     >> np.arange(32, dtype=np.uint64)) & 1
                    ).astype(np.uint8).ravel()[:m]
                for c, v in cols.items()}
        # each colour's first word of this replica mod 4, in the tensor
        mod4 = {c: (off[c] + rep * nw) % 4 for c in cols}
        c0 = mod4["a"]
        r = [(mod4[nbr[k]] + q[k] - c0) % 4 for k in range(6)]
        r_own_b = (mod4["b"] - c0) % 4

        def vectors(col, base, n):
            """n words from the replica's word ``base`` on, ``base`` on
            the 16-B grid, inside the vectors that hold the tensor."""
            assert (off[col] + rep * nw + base) % 4 == 0
            assert off[col] + rep * nw + base >= off[col] - off[col] % 4
            assert base + n - 1 <= nw - 1, "read past word W - 1"
            out = np.zeros(n, np.uint32)
            lo = max(base, 0)
            out[lo - base:] = cols[col][rep][lo:base + n]
            if base < 0:  # the words before a replica: the previous one's
                flat = cols[col].ravel()
                at = rep * nw + base
                out[:lo - base] = flat[at:rep * nw] if at >= 0 else 0
            return out

        for b in range(t["blocks"]):
            for warp in range(h3.ENERGY_THREADS // 32):
                t0 = b * h3.ENERGY_THREADS + warp * 32
                while t0 < nruns:
                    runs = [t0 + lane for lane in range(32)]
                    if t0 < bulk:
                        # each lane's windows (own vectors) first, then
                        # the vector past them, from the next lane
                        wins = {}
                        for lane, tr in enumerate(runs):
                            g0 = tr * k_run - c0
                            if tr < bulk and g0 >= 0:
                                wins[lane] = [
                                    vectors("a", g0, k_run),
                                    vectors("b", g0 - r_own_b, k_run),
                                    *(vectors(nbr[k], g0 + q[k] - r[k], k_run)
                                      for k in (1, 3, 4, 5))]
                        for lane, tr in enumerate(runs):
                            if lane not in wins:
                                continue
                            g0 = tr * k_run - c0
                            if lane == 31 or tr + 1 >= bulk:
                                past = [vectors(col, base + k_run, 4)
                                        for col, base in (
                                            ("a", g0), ("b", g0 - r_own_b),
                                            *((nbr[k], g0 + q[k] - r[k])
                                              for k in (1, 3, 4, 5)))]
                            else:
                                assert lane + 1 in wins
                                past = [v[:4] for v in wins[lane + 1]]
                            full = [np.concatenate([v, p]).astype(np.uint64)
                                    for v, p in zip(wins[lane], past)]
                            offs = [0, r_own_b, r[1], r[3], r[4], r[5]]
                            win = [f[o:o + k_run + 1]
                                   for f, o in zip(full, offs)]
                            av, bv = win[0], win[1]

                            def pop(src, w, s):
                                return sum(_popc(int(src[j]) ^ int(
                                    ((w[j] | (w[j + 1] << 32)) >> s)
                                    & M32)) for j in range(k_run))

                            sm = sum(_popc(int(av[j])) + _popc(int(bv[j]))
                                     for j in range(k_run))
                            se = (pop(av, bv, 0) + pop(bv, av, 1)
                                  + pop(av, win[2], sh[1])
                                  + pop(bv, win[3], sh[3])
                                  + pop(av, win[4], sh[4])
                                  + pop(bv, win[5], sh[5]))
                            obs[rep, 0] += 2 * sm - 64 * k_run
                            obs[rep, 1] += 2 * se - 6 * 32 * k_run
                            seen[rep, g0:g0 + k_run] += 1
                    for tr in runs:
                        g0 = tr * k_run - c0
                        if (tr < bulk and g0 >= 0) or tr >= nruns:
                            continue
                        for g in range(max(g0, 0), min(g0 + k_run, nw)):
                            nb = min(32, m - 32 * g)
                            vm = (1 << nb) - 1
                            av = int(cols["a"][rep, g])
                            bv = int(cols["b"][rep, g])
                            obs[rep, 0] += 2 * (_popc(av & vm)
                                                + _popc(bv & vm)) - 2 * nb
                            for k in range(6):
                                src = av if k in (0, 1, 4) else bv
                                n = _read_circ(bits[nbr[k]],
                                               (32 * g + d[k]) % m)
                                obs[rep, 1] += 2 * _popc((src ^ n) & vm) - nb
                            seen[rep, g] += 1
                    t0 += stride
    return obs, seen


def _plain(wa, wb, nx, nxy, m):
    ta, tb = (torch.from_numpy(v.view(np.int32).copy()) for v in (wa, wb))
    return h3.energy_sums_plain(ta, tb, nx=nx, nxy=nxy, m=m).numpy()


@pytest.mark.parametrize("offsets", [(0, 0), (1, 3), (3, 2)])
@pytest.mark.parametrize("nrep", [1, 3])
@pytest.mark.parametrize("nx,ny,nz", SHAPES)
def test_replay_matches_plain(nx, ny, nz, nrep, offsets):
    nxy, m = nx * ny, nx * ny * nz // 2
    g = np.random.default_rng(nx * ny + nz + nrep + h3.ENERGY_RUN)
    wa, wb = _words(g, nrep, m), _words(g, nrep, m)
    got, seen = replay(wa, wb, nx, nxy, m, offsets)
    assert np.all(seen == 1), offsets
    np.testing.assert_array_equal(got, _plain(wa, wb, nx, nxy, m))


@pytest.mark.parametrize("nx,ny,nz", SHAPES)
def test_runs_cover_bulk_and_seam(nx, ny, nz):
    """Where a replica holds more than a few runs, most are bulk and the
    seam's runs (a plane past M) are not; a replica shorter than one run
    has none."""
    nxy, m = nx * ny, nx * ny * nz // 2
    t = h3.energy_runs(3, nx, nxy, m)
    nw, d = hms.words(m), [dd % m for _, _, dd in h3._energy_pairs(nx, nxy)]
    if nw < t["run"]:
        assert t["bulk"] == 0
        return
    # the first run past the bulk reads a plane across M or past W - 1
    k = t["run"]
    g_end = t["bulk"] * k
    assert (32 * (g_end + k) + max(d) > m
            or g_end + k + 3 + max(q for q in t["q"]) > nw - 1)
    if nw > 64 * k + max(d) // 32:
        assert t["bulk"] * k > nw // 2


@pytest.mark.parametrize("nrep,nx,ny,nz", SMOKE_LAUNCHES)
def test_smoke_launches_are_served(nrep, nx, ny, nz):
    """The constants of every launch the smoke makes: the runs the C entry
    accepts (energy_runs_ok restated), most of a replica on the bulk."""
    nxy, m = nx * ny, nx * ny * nz // 2
    nw = hms.words(m)
    t = h3.energy_runs(nrep, nx, nxy, m)
    d = [dd % m for _, _, dd in h3._energy_pairs(nx, nxy)]
    assert t["nruns"] == -(-(nw + 3) // t["run"])
    assert 1 <= t["blocks"] <= 65535 and 0 <= t["bulk"] <= t["nruns"]
    assert t["blocks"] * nrep <= max(h3.ENERGY_BLOCKS, nrep)
    if t["bulk"]:
        last = (t["bulk"] - 1) * t["run"]
        assert last + t["run"] + 3 + max(t["q"]) <= nw - 1
        assert 32 * (last + t["run"]) + max(d) <= m
    if nx == 1001:
        # the far planes' words, ~nxy / 64 a replica, are the tail
        assert nw - t["bulk"] * t["run"] < nxy // 64 + 2 * t["run"] + 8
