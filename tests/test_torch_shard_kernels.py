"""The four sharded halo kernels' plain versions and the halo exchange
against the JAX package.

- ``ising2d_pallas.sharded_phase`` (int8 2-D, rows and columns),
  ``ising3d_pallas.sharded_phase`` (int8 3-D, z-planes),
  ``ising2d_multispin.sharded_phase_packed`` (bit rows and word columns)
  and ``ising3d_multispin.sharded_phase3d_packed`` (packed z-planes): the
  port's plain versions (what the CPU runs, and what each CUDA kernel is
  held against on the card) against JAX's halo kernels in interpret mode,
  on the same injected words or Bernoulli planes, at JAX's own test shapes
  (``tests/test_shard_pallas.py``), both colours, measuring, and with
  column halos where the kernel has them: new states and (m, e) partials
  bitwise.
- ``parallel/halo.py`` against JAX's ``halo.py`` inside ``shard_map`` on
  the 8-device CPU mesh, bitwise, at axis sizes 1, 2 and 4.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from cuda_fortran_mc_simulation_spin_tpu.ops import (
    ising2d_multispin as jmsb,
    ising2d_pallas as ji2p,
    ising3d_multispin as jms3,
    ising3d_pallas as ji3p,
)
from cuda_fortran_mc_simulation_spin_tpu.parallel import halo as jhalo
from cuda_fortran_mc_simulation_spin_tpu_torch.core import rng
from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
    ising2d_multispin as msb,
    ising2d_pallas as i2p,
    ising3d_multispin as ms3,
    ising3d_pallas as i3p,
)
from cuda_fortran_mc_simulation_spin_tpu_torch.parallel import halo

R, L, HALF = 2, 64, 128          # JAX's test_shard_pallas shapes
KBT, KBT3 = 2.26918531421, 4.51152
SEEDS = np.array([12345, -678], np.int32)


def _spins(g, shape):
    return (g.integers(0, 2, size=shape) * 2 - 1).astype(np.int8)


def _words(g, shape):
    return g.integers(-2 ** 31, 2 ** 31, size=shape,
                      dtype=np.int64).astype(np.int32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return np.asarray(x).astype(np.int64)


def _check(got, want, measuring):
    """Port result (tensor, or (tensor, m, e)) against JAX's."""
    if not measuring:
        got, want = (got,), (want,)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy().astype(np.int64), _np(b))


@pytest.mark.parametrize("color,cols", [(0, False), (1, False), (0, True),
                                        (1, True)])
def test_int8_2d_plain_matches_jax_halo_kernel(color, cols):
    g = np.random.default_rng(10 + 2 * color + cols)
    x, o = _spins(g, (R, L, HALF)), _spins(g, (R, L, HALF))
    hu, hd = _spins(g, (R, 1, HALF)), _spins(g, (R, 1, HALF))
    bits = _words(g, (R, L, HALF))
    measuring = color == 1
    kw, jkw, offs = {}, {}, [0, 2 * L]
    if cols:
        hl, hr = _spins(g, (R, L, 1)), _spins(g, (R, L, 1))
        kw = dict(halo_lf=_t(hl), halo_rt=_t(hr))
        jkw = dict(halo_lf=jnp.asarray(hl), halo_rt=jnp.asarray(hr))
        offs = [0, 2 * L, HALF]
    beta = 1.0 / KBT
    want = ji2p.sharded_phase(
        jnp.asarray(x), jnp.asarray(o), jnp.asarray(hu), jnp.asarray(hd),
        jnp.asarray(SEEDS), jnp.asarray(offs, jnp.int32), color=color,
        beta=beta, bits=jnp.asarray(bits.view(np.uint32)), interpret=True,
        measuring=measuring, **jkw)
    got = i2p.sharded_phase(_t(x), _t(o), _t(hu), _t(hd), _t(SEEDS), offs,
                            color=color, beta=beta, bits=_t(bits),
                            measuring=measuring, **kw)
    _check(got, want, measuring)


@pytest.mark.parametrize("color", [0, 1])
def test_int8_3d_plain_matches_jax_halo_kernel(color):
    g = np.random.default_rng(20 + color)
    shape = (R, 4, L, HALF)
    x, o = _spins(g, shape), _spins(g, shape)
    zm, zp = _spins(g, (R, 1, L, HALF)), _spins(g, (R, 1, L, HALF))
    bits = _words(g, shape)
    measuring = color == 1
    offs = [2, 8]
    want = ji3p.sharded_phase(
        jnp.asarray(x), jnp.asarray(o), jnp.asarray(zm), jnp.asarray(zp),
        jnp.asarray(SEEDS), jnp.asarray(offs, jnp.int32), color=color,
        beta=1.0 / KBT3, bits=jnp.asarray(bits.view(np.uint32)),
        interpret=True, measuring=measuring)
    got = i3p.sharded_phase(_t(x), _t(o), _t(zm), _t(zp), _t(SEEDS), offs,
                            color=color, beta=1.0 / KBT3, bits=_t(bits),
                            measuring=measuring)
    _check(got, want, measuring)


@pytest.mark.parametrize("color,cols", [(0, False), (1, False), (0, True),
                                        (1, True)])
def test_packed_2d_plain_matches_jax_halo_kernel(color, cols):
    g = np.random.default_rng(30 + 2 * color + cols)
    shape = (R, 8, HALF)
    x, o, b4, b8 = (_words(g, shape) for _ in range(4))
    hu = g.integers(0, 2, size=(R, 1, HALF)).astype(np.int32)
    hd = g.integers(0, 2, size=(R, 1, HALF)).astype(np.int32)
    measuring = color == 1
    kw, jkw, offs = {}, {}, [2, 8]
    if cols:
        hl, hr = _words(g, (R, 8, 1)), _words(g, (R, 8, 1))
        kw = dict(halo_lf=_t(hl), halo_rt=_t(hr))
        jkw = dict(halo_lf=jnp.asarray(hl), halo_rt=jnp.asarray(hr),
                   w_total=2 * HALF)
        offs = [2, 8, HALF]
    want = jmsb.sharded_phase_packed(
        jnp.asarray(x), jnp.asarray(o), jnp.asarray(hu), jnp.asarray(hd),
        jnp.asarray(SEEDS), jnp.asarray(offs, jnp.int32), color=color,
        beta=1.0 / KBT, b4=jnp.asarray(b4), b8=jnp.asarray(b8),
        interpret=True, measuring=measuring, **jkw)
    got = msb.sharded_phase_packed(_t(x), _t(o), _t(hu), _t(hd), _t(SEEDS),
                                   offs, color=color, beta=1.0 / KBT,
                                   b4=_t(b4), b8=_t(b8),
                                   measuring=measuring, **kw)
    _check(got, want, measuring)


@pytest.mark.parametrize("color", [0, 1])
def test_packed_3d_plain_matches_jax_halo_kernel(color):
    g = np.random.default_rng(40 + color)
    shape = (R, 4, 8, HALF)
    x, o, b4, b8, b12 = (_words(g, shape) for _ in range(5))
    zm, zp = _words(g, (R, 1, 8, HALF)), _words(g, (R, 1, 8, HALF))
    measuring = color == 1
    offs = [2, 8]
    want = jms3.sharded_phase3d_packed(
        jnp.asarray(x), jnp.asarray(o), jnp.asarray(zm), jnp.asarray(zp),
        jnp.asarray(SEEDS), jnp.asarray(offs, jnp.int32), color=color,
        beta=1.0 / KBT3, b4=jnp.asarray(b4), b8=jnp.asarray(b8),
        b12=jnp.asarray(b12), interpret=True, measuring=measuring)
    got = ms3.sharded_phase3d_packed(_t(x), _t(o), _t(zm), _t(zp),
                                     _t(SEEDS), offs, color=color,
                                     beta=1.0 / KBT3, b4=_t(b4), b8=_t(b8),
                                     b12=_t(b12), measuring=measuring)
    _check(got, want, measuring)


def test_plain_versions_draw_the_unsharded_words():
    """With Philox words (no injection) a shard's phase is the matching
    block of the unsharded phase: int8 2-D at an x offset that cuts a
    unit of four columns (col0 = 11), packed 2-D and 3-D at global word
    offsets."""
    g = np.random.default_rng(5)
    seeds = rng.seeds_from_key(rng.base_key(9), 1)
    beta = 1.0 / KBT
    # int8 2-D: (R, 8, 22) split into (R, 4, 11) blocks
    a, b = _t(_spins(g, (R, 8, 22))), _t(_spins(g, (R, 8, 22)))
    want = i2p.phase_plain(a, b, seeds, color=1, beta=beta)
    for y0, c0 in ((0, 0), (4, 11), (0, 11)):
        blk = (slice(None), slice(y0, y0 + 4), slice(c0, c0 + 11))
        hu = b[:, (y0 - 1) % 8][:, None, c0:c0 + 11]
        hd = b[:, (y0 + 4) % 8][:, None, c0:c0 + 11]
        hl = b[:, y0:y0 + 4, (c0 - 1) % 22][..., None]
        hr = b[:, y0:y0 + 4, (c0 + 11) % 22][..., None]
        got = i2p.sharded_phase_plain(a[blk], b[blk], hu, hd, seeds,
                                      (0, y0, c0), color=1, beta=beta,
                                      halo_lf=hl, halo_rt=hr)
        assert torch.equal(got, want[blk])
    # packed 2-D: (R, 4, 64) words, the block of word rows 2.. and words
    # 32..
    wa, wb = _t(_words(g, (R, 4, 64))), _t(_words(g, (R, 4, 64)))
    want = msb.phase_packed_plain(wa, wb, seeds, color=0, beta=beta)
    blk = (slice(None), slice(2, 4), slice(32, 64))
    hu = (wb[:, 1:2, 32:] >> 31) & 1
    hd = wb[:, 0:1, 32:] & 1
    got = msb.sharded_phase_packed_plain(
        wa[blk], wb[blk], hu, hd, seeds, (0, 2, 32), color=0, beta=beta,
        halo_lf=wb[:, 2:4, 31:32].contiguous(),
        halo_rt=wb[:, 2:4, 0:1].contiguous())
    assert torch.equal(got, want[blk])
    # packed 3-D: (R, 4, 2, 32) volumes, planes 2..3
    va, vb = _t(_words(g, (R, 4, 2, 32))), _t(_words(g, (R, 4, 2, 32)))
    want = ms3.phase3d_plain(va, vb, seeds, color=1, beta=1.0 / KBT3)
    got = ms3.sharded_phase3d_packed_plain(
        va[:, 2:], vb[:, 2:], vb[:, 1:2], vb[:, 0:1], seeds, (0, 2),
        color=1, beta=1.0 / KBT3)
    assert torch.equal(got, want[:, 2:])


# ---------------------------------------------------------------------------
# parallel/halo.py against JAX's halo.py in shard_map
# ---------------------------------------------------------------------------

def _jax_halos(fn, glob, n, axis_name, dim, **kw):
    """JAX's exchange ``fn`` inside shard_map over ``n`` CPU devices, the
    global array split along ``dim``; returns each shard's two halos."""
    mesh = Mesh(np.asarray(jax.devices()[:n]), (axis_name,))
    spec = [None] * glob.ndim
    spec[dim] = axis_name
    spec = P(*spec)

    def body(local):
        return fn(local, axis_name, n, **kw)

    out = jax.shard_map(body, mesh=mesh, in_specs=(spec,),
                        out_specs=(spec, spec), check_vma=False)(
        jnp.asarray(glob))
    return [np.split(np.asarray(h), n, axis=dim) for h in out]


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("kind", ["rows", "packed", "cols"])
def test_halo_exchange_matches_jax(kind, n):
    if len(jax.devices()) < n:
        pytest.skip("needs the 8-device CPU mesh (tests/conftest.py)")
    g = np.random.default_rng(n)
    if kind == "rows":
        glob = _spins(g, (2, 4 * n, 6))
        want = _jax_halos(jhalo.exchange_halo_rows, glob, n, "y", 1,
                          row_axis=1)
        got = halo.exchange_halo_rows(
            [_t(s) for s in np.split(glob, n, axis=1)], row_axis=1)
    elif kind == "packed":
        glob = _words(g, (2, 2 * n, 6))
        want = _jax_halos(jhalo.exchange_halo_rows_packed, glob, n, "y", 1)
        got = halo.exchange_halo_rows_packed(
            [_t(s) for s in np.split(glob, n, axis=1)])
    else:
        glob = _spins(g, (2, 4, 3 * n))
        want = _jax_halos(functools.partial(jhalo.exchange_halo_cols,
                                            col_axis=2),
                          glob, n, "x", 2)
        got = halo.exchange_halo_cols(
            [_t(s) for s in np.split(glob, n, axis=2)], col_axis=2)
    for side in range(2):
        for i in range(n):
            np.testing.assert_array_equal(got[side][i].numpy(),
                                          want[side][i])
            assert got[side][i].is_contiguous()
