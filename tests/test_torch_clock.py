"""Port vs JAX on the same numpy inputs: the periodic clock slice (q = 6, 4,
3).

Packing, the packed phase with injected random planes (against the JAX
kernel in interpret mode, both colours, with its fused and masked (2m, 2e)
or (m, e)), the proposal thermometer and the chains, the slice as a whole
(the port's runner replayed phase by phase through the JAX oracle on the
planes it draws), the routing gates and refusals, interop and the CLI.
Shapes: 256x256 (aligned, the JAX tests' shape) and 248x248 (padded:
24 real rows in the top word, the smallest padded shape the JAX gates send
to the packed engine at this width)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_fortran_mc_simulation_spin_tpu.models.clock import (
    Clock2D as JaxClock,
)
from cuda_fortran_mc_simulation_spin_tpu.ops import clock3_multispin as jc3
from cuda_fortran_mc_simulation_spin_tpu.ops import clock4_multispin as jc4
from cuda_fortran_mc_simulation_spin_tpu.ops import clock_multispin as jc6
from cuda_fortran_mc_simulation_spin_tpu.ops import clock_planes as jcp
from cuda_fortran_mc_simulation_spin_tpu.ops import (
    ising2d_multispin as jmsb,
)
from cuda_fortran_mc_simulation_spin_tpu.runs.__main__ import main as jax_main
from cuda_fortran_mc_simulation_spin_tpu_torch import interop
from cuda_fortran_mc_simulation_spin_tpu_torch.core import lattice, rng
from cuda_fortran_mc_simulation_spin_tpu_torch.engine import sweep
from cuda_fortran_mc_simulation_spin_tpu_torch.models import Clock2D
from cuda_fortran_mc_simulation_spin_tpu_torch.ops import clock3_multispin
from cuda_fortran_mc_simulation_spin_tpu_torch.ops import clock4_multispin
from cuda_fortran_mc_simulation_spin_tpu_torch.ops import clock_multispin
from cuda_fortran_mc_simulation_spin_tpu_torch.ops import clock_planes as cp
from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
    ising2d_multispin as msb,
)
from cuda_fortran_mc_simulation_spin_tpu_torch.runs.__main__ import main

PAIRS = {6: (clock_multispin, jc6), 4: (clock4_multispin, jc4),
         3: (clock3_multispin, jc3)}
JAX_MASKED = {6: jc6.obs_packed6_masked, 4: jc4.obs_packed4_masked,
              3: jc3.obs_packed3_masked}
SHAPES = [(256, 256), (248, 248)]
KBT = 0.91


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _colors(g, q, nrep, ny, nx):
    """(a, b) int8 colour arrays (nrep, ny, nx//2) of random states."""
    full = g.integers(0, q, size=(nrep, ny, nx)).astype(np.int8)
    a, b = lattice.split_checkerboard(_t(full))
    return a.numpy(), b.numpy()


def _jax_pack(jspec, a, ny, half):
    pad = jcp.padded_spec(ny, half)
    if pad is None:
        return tuple(np.asarray(p) for p in jspec.pack_color(jnp.asarray(a)))
    return tuple(np.asarray(p) for p in
                 jcp.pack_color_padded(jspec, jnp.asarray(a), pad))


def _rand_planes(g, spec, shape):
    planes = [g.integers(-2 ** 31, 2 ** 31, size=shape,
                         dtype=np.int64).astype(np.int32)
              for _ in range(spec.n_rand)]
    if spec.q == 6:
        # a valid (rt1, rt2) Z3 encoding and no null proposal
        planes[2] &= ~planes[1]
        planes[0] |= ~(planes[1] | planes[2])
    return planes


@pytest.mark.parametrize("q", [6, 4, 3])
@pytest.mark.parametrize("ny,nx", SHAPES)
def test_pack_unpack_matches_jax(q, ny, nx):
    port, jmod = PAIRS[q]
    half = nx // 2
    a, _ = _colors(np.random.default_rng(q + ny), q, 2, ny, nx)
    got = port.SPEC.pack_color(_t(a))
    assert all(p.dtype == torch.int32 and p.shape == (2, -(-ny // 32), half)
               for p in got)
    want = _jax_pack(jmod.SPEC, a, ny, half)
    for g_, w_ in zip(got, interop.clock_from_numpy(want, ny, half)):
        assert torch.equal(g_, w_)
    np.testing.assert_array_equal(
        port.SPEC.unpack_color(*got)[..., :ny, :].numpy(), a)


@pytest.mark.parametrize("q", [6, 4, 3])
@pytest.mark.parametrize("ny,nx", SHAPES)
def test_phase_matches_jax_kernel_interpret(q, ny, nx):
    """The plain phase with injected planes against JAX, both colours:
    padded, against the JAX kernel in interpret mode after its refresh,
    with the fused (phase b) sums against the kernel's masked sums;
    aligned, against the JAX oracle phase_reference that the JAX tests
    hold that kernel to.  The fused sums against obs_packed*_masked, all
    on the real sites, exactly."""
    port, jmod = PAIRS[q]
    spec, jspec = port.SPEC, jmod.SPEC
    half = nx // 2
    g = np.random.default_rng(10 * q + ny)
    a, b = _colors(g, q, 2, ny, nx)
    ja, jb = _jax_pack(jspec, a, ny, half), _jax_pack(jspec, b, ny, half)
    pa, pb = spec.pack_color(_t(a)), spec.pack_color(_t(b))
    pad = jcp.padded_spec(ny, half)
    rand = _rand_planes(g, spec, ja[0].shape)
    nyw = pa[0].shape[-2]
    prand = [_t(r[..., :nyw, :half]) for r in rand]
    for color in (0, 1):
        jx, jo = (ja, jb) if color == 0 else (jb, ja)
        px, po = (pa, pb) if color == 0 else (pb, pa)
        jo = tuple(jnp.asarray(p) for p in jo)
        if pad is not None:
            jo = jcp.refresh_padded(jo, pad)
        measuring = color == 1
        jx = tuple(jnp.asarray(p) for p in jx)
        jrand = tuple(jnp.asarray(r) for r in rand)
        if pad is None:
            res = jcp.phase_reference(jspec, jx, jo, color, jrand)
            if measuring:
                res = (res, None)
        else:
            res = jcp.phase_packed(
                jspec, jx, jo, jnp.zeros((2,), jnp.int32), color=color,
                beta=1 / KBT, inject=jrand, interpret=True,
                measuring=measuring, obs_mask=jcp.pad_mask(pad))
        got = cp.phase_reference(spec, px, po, color, prand, ny=ny,
                                 measuring=measuring)
        jnew = res[0] if measuring else res
        pnew = got[0] if measuring else got
        want = interop.clock_from_numpy([np.asarray(p) for p in jnew], ny,
                                        half)
        for g_, w_ in zip(pnew, want):
            assert torch.equal(g_, w_)
        if measuring:
            jm, je = JAX_MASKED[q](jo, jnew, pad or jcp.PadSpec(
                ny, half, ny // 32, 0, ny // 32, half))
            np.testing.assert_array_equal(got[1].numpy()[:, 0],
                                          np.asarray(jm))
            np.testing.assert_array_equal(got[1].numpy()[:, 1],
                                          np.asarray(je))
            if res[1] is not None:
                jobs = np.asarray(res[1])[:, 0, :2]
                np.testing.assert_array_equal(got[1].numpy(), jobs)
            pm, pe = spec.obs_masked(pa, pnew, ny)
            np.testing.assert_array_equal(pm.numpy(), np.asarray(jm))
            np.testing.assert_array_equal(pe.numpy(), np.asarray(je))


def _cycling_gen(words):
    it = iter(words)
    return lambda: next(it)


@pytest.mark.parametrize("q", [6, 4, 3])
def test_draw_planes_match_jax_bitwise(q):
    """The same fresh words give the same random planes: the thermometer
    first, then each chain of ``_chain_len`` digits, in order."""
    port, jmod = PAIRS[q]
    beta = 1 / KBT
    assert port.SPEC.accept_digits(beta) == jmod.SPEC.accept_digits(beta)
    words = np.random.default_rng(q).integers(0, 2 ** 32, size=(400, 8, 64),
                                              dtype=np.int64)
    got = port.SPEC.draw(_cycling_gen([_t(w) for w in words]),
                         port.SPEC.accept_digits(beta))
    want = jmod.SPEC.draw((8, 64), _cycling_gen(
        [jnp.asarray(w.astype(np.uint32)) for w in words]),
        jmod.SPEC.accept_digits(beta))
    for g_, w_ in zip(got, want):
        np.testing.assert_array_equal(g_.numpy(), np.asarray(w_, np.int64))


@pytest.mark.parametrize("q,counts", [(6, [819, 819, 820, 819, 819]),
                                      (4, [1365, 1366, 1365])])
def test_thermometer_category_counts(q, counts):
    """Over all 4096 12-bit uniforms the proposal r takes each value the
    rounded number of times, symmetric about its middle."""
    port, _ = PAIRS[q]
    u = np.arange(4096)
    prop = [_t(np.where((u >> (11 - j)) & 1, msb.MASK32, 0))
            for j in range(12)]
    zeros = [torch.zeros(4096, dtype=torch.int64)] * 200
    planes = port.SPEC.draw(_cycling_gen(prop + zeros),
                            port.SPEC.accept_digits(1.0))
    bits = [(p.numpy() & 1) for p in planes]
    if q == 6:
        rho, rt1, rt2 = bits[:3]
        tau = rt1 + 2 * rt2
        r = np.array([next(v for v in range(1, 6)
                           if v % 2 == rh and v % 3 == t)
                      for rh, t in zip(rho, tau)])
        assert not np.any((rt1 == 1) & (rt2 == 1))
    else:
        r0, r1 = bits[:2]
        r = np.where(r1 == 1, 2 + r0, 1)        # r odd, r >= 2
    assert np.bincount(r, minlength=len(counts) + 1)[1:].tolist() == counts


@pytest.mark.parametrize("p", [np.exp(-0.5 / 0.91), np.exp(-4 / 0.91),
                               np.exp(-6 / 0.8), 0.3])
def test_chain_probabilities(p):
    """A chain of ``_chain_len(p)`` digits: its words the JAX chain's on
    the same words, its draw count chain_draws(q, k), and its bit rate
    q / 2^k within 5 sigma."""
    digits = cp.chain_digits_of(float(p))
    assert len(digits) == jcp._chain_len(float(p))
    assert list(digits) == jmsb.chain_digits(float(p), len(digits))
    q, k = msb.digits_int(digits), len(digits)
    assert abs(q / 2 ** k - p) <= 2 ** -k
    words = np.random.default_rng(k).integers(0, 2 ** 32, size=(40, 4096),
                                              dtype=np.int64)
    used = []

    def gen():
        used.append(1)
        return _t(words[len(used) - 1])

    plane = msb._bern_plane((4096,), list(digits), gen)
    assert len(used) == msb.chain_draws(q, k)
    want = jmsb._bern_plane((4096,), list(digits), _cycling_gen(
        [jnp.asarray(w.astype(np.uint32)) for w in words]))
    np.testing.assert_array_equal(plane.numpy(), np.asarray(want, np.int64))
    n = 4096 * 32
    rate = sum(bin(int(v)).count("1") for v in plane.numpy()) / n
    assert abs(rate - q / 2 ** k) < 5 * np.sqrt(p * (1 - p) / n)


def _pad_rand(planes, jshape):
    """The port's (R, nyw, half) random planes in the JAX layout: real
    words in place, pads zero (a pad site's decision is never read)."""
    out = []
    for p in planes:
        w = np.zeros(jshape, np.int64)
        w[..., :p.shape[-2], :p.shape[-1]] = p.numpy()
        out.append(jnp.asarray(w.astype(np.uint32).view(np.int32)))
    return tuple(out)


@pytest.mark.parametrize("q,ny,nx", [(6, 256, 256), (6, 248, 248),
                                     (4, 248, 248), (3, 248, 248)])
def test_runner_replayed_through_the_jax_oracle(q, ny, nx):
    """The slice as a whole: the port's runner on the CPU, replayed phase
    by phase through the JAX phase oracle on the planes the port draws;
    every state and every sweep's (m, e) agree bitwise."""
    port, jmod = PAIRS[q]
    spec, jspec = port.SPEC, jmod.SPEC
    model = Clock2D(nx=nx, ny=ny, kbt=KBT, q=q)
    half, mcs, batch = nx // 2, 3, 2
    key = rng.sample_key(rng.base_key(5), 1)
    run = sweep.make_clock_multispin_runner(model, mcs, batch, "random",
                                            device="cpu")
    series = run(key)
    assert run.engine == f"clock q={q} bit-sliced packed" + (
        " (padded)" if ny % 32 else "")
    wa, wb = sweep._init_planes(model, "random", batch, key, "cpu",
                                pack=spec.pack_color)
    pad = jcp.padded_spec(ny, half)
    ja, jb = (tuple(jnp.asarray(p) for p in interop.clock_to_numpy(w, ny,
                                                                  half))
              for w in (wa, wb))
    jpad = pad or jcp.PadSpec(ny, half, ny // 32, 0, ny // 32, half)
    seeds = msb.sweep_seed_pairs(key, mcs)
    nyw = wa[0].shape[-2]
    for t in range(mcs):
        for color in (0, 1):
            rand = cp.draw_planes_plain(spec, seeds[t, color], batch, nyw,
                                        half, model.beta)
            jx, jo = (ja, jb) if color == 0 else (jb, ja)
            if pad is not None:
                jo = jcp.refresh_padded(jo, pad)
            new = jcp.phase_reference(jspec, jx, jo, color,
                                      _pad_rand(rand, ja[0].shape))
            if color == 0:
                ja = new
            else:
                jb = new
        wa, wb, _ = cp.sweep_measure_seeded(spec, model, wa, wb, seeds[t])
        for w, j in ((wa, ja), (wb, jb)):
            for g_, w_ in zip(w, interop.clock_from_numpy(
                    [np.asarray(p) for p in j], ny, half)):
                assert torch.equal(g_, w_)
        ja_r = jcp.refresh_padded(ja, pad) if pad is not None else ja
        m2, e2 = JAX_MASKED[q](ja_r, jb, jpad)
        scale = spec.obs_scale / model.nsites
        np.testing.assert_array_equal(
            series["m"][:, t].numpy(),
            np.asarray(m2).astype(np.float64) * scale)
        np.testing.assert_array_equal(
            series["e"][:, t].numpy(),
            np.asarray(e2).astype(np.float64) * scale)


@pytest.mark.parametrize("q", [6, 4, 3])
def test_fused_sums_equal_the_model_reduction(q):
    """The plain phase's fused (m, e) densities equal the model's exact
    reduction of the unpacked state (float64, to rounding)."""
    port, _ = PAIRS[q]
    spec = port.SPEC
    model = Clock2D(nx=248, ny=248, kbt=KBT, q=q)
    state = model.init_state("random", rng.base_key(q), batch=(2,))
    wa, wb, _ = cp.pack_state(spec, state)
    seeds = msb.sweep_seed_pairs(rng.base_key(9), 1)[0]
    wa, wb, obs = cp.sweep_measure_seeded(spec, model, wa, wb, seeds)
    want = model.observables(cp.unpack_state(spec, wa, wb, 248, True))
    for k in ("m", "e"):
        np.testing.assert_allclose(
            obs[k].numpy(), want[k].numpy(), rtol=0, atol=1e-12,
            err_msg=f"{k}: fused {obs[k].tolist()!r}, model "
                    f"{want[k].tolist()!r}; state under base_key({q}), "
                    f"phase keys {seeds.tolist()}, torch threads "
                    f"{torch.get_num_threads()}")


def test_q6_bindings_absorb_and_measure():
    """The q=6 module's bound sweeps: at kbt -> 0 an ordered state stays
    ordered (padded shape), and the fused densities of a warm sweep equal
    the model's reduction of the state it leaves."""
    cold = Clock2D(nx=248, ny=248, kbt=1e-4, q=6)
    wa, wb, batched = clock_multispin.pack_state(cold.init_state("allup"))
    key = rng.base_key(17)
    for t in range(3):
        wa, wb = clock_multispin.sweep_packed6(cold, wa, wb,
                                               rng.sweep_key(key, t))
    assert all(int(p.abs().sum()) == 0 for p in wa + wb)
    warm = Clock2D(nx=248, ny=248, kbt=0.9, q=6)
    wa, wb, batched = clock_multispin.pack_state(
        warm.init_state("random", rng.base_key(2)))
    wa, wb, obs = clock_multispin.sweep_measure_packed6(
        warm, wa, wb, rng.sweep_key(key, 10))
    want = warm.observables(clock_multispin.unpack_state(wa, wb, 248,
                                                         batched))
    for k in ("m", "e"):
        assert abs(float(obs[k][0]) - float(want[k])) < 1e-12


def test_q6_phase_bindings_match_the_jax_module():
    """The q=6 module's phase and gate bindings against their JAX
    namesakes: phase_packed (Philox planes) equals the JAX oracle
    packed_phase_reference fed the planes it draws, and the packable gates
    give the JAX module's answers."""
    g = np.random.default_rng(3)
    a, b = _colors(g, 6, 2, 256, 256)
    pa, pb = (clock_multispin.SPEC.pack_color(_t(c)) for c in (a, b))
    ja, jb = (_jax_pack(jc6.SPEC, c, 256, 128) for c in (a, b))
    seeds = msb.sweep_seed_pairs(rng.base_key(21), 1)[0]
    for color in (0, 1):
        px, po = (pa, pb) if color == 0 else (pb, pa)
        jx, jo = (ja, jb) if color == 0 else (jb, ja)
        got = clock_multispin.phase_packed(px, po, seeds[color],
                                           color=color, beta=1 / KBT)
        rand = cp.draw_planes_plain(clock_multispin.SPEC, seeds[color], 2,
                                    8, 128, 1 / KBT)
        mine = clock_multispin.packed_phase_reference(
            px, po, color, [cp._i32(r) for r in rand])
        want = jc6.packed_phase_reference(
            tuple(jnp.asarray(p) for p in jx),
            tuple(jnp.asarray(p) for p in jo), color,
            _pad_rand(rand, jx[0].shape))
        for g_, m_, w_ in zip(got, mine, want):
            assert torch.equal(g_, m_)
            np.testing.assert_array_equal(g_.numpy(), np.asarray(w_))
    for nx, ny in ((256, 256), (2000, 2000), (248, 248), (60, 72)):
        model = Clock2D(nx=nx, ny=ny, kbt=KBT, q=6)
        jmodel = JaxClock(nx=nx, ny=ny, kbt=KBT, q=6, backend="jnp")
        assert clock_multispin.clock_packable(model) == \
            jc6.clock_packable(jmodel)
        assert clock_multispin.clock_padded_packable(model) == \
            jc6.clock_padded_packable(jmodel)


def test_init_states():
    model = Clock2D(nx=64, ny=64, kbt=KBT, q=6)
    up = model.init_state("allup", batch=(2,))
    assert up.a.shape == (2, 64, 32) and int(up.a.abs().sum()) == 0
    r = model.init_state("random", rng.base_key(1))
    assert r.a.dtype == torch.int8
    assert 0 <= int(r.a.min()) and int(r.b.max()) <= 5
    counts = np.bincount(torch.cat([r.a, r.b]).flatten().numpy(),
                         minlength=6)
    assert counts.min() > 0.8 * 64 * 64 / 6
    obs = model.observables(up)
    assert obs["m"].tolist() == [1.0, 1.0]
    assert obs["e"].tolist() == [-2.0, -2.0]
    with pytest.raises(ValueError):
        Clock2D(nx=64, ny=64, kbt=KBT, q=1)


@pytest.mark.parametrize("nx,ny,q", [
    (256, 256, 6), (2048, 2048, 6), (2000, 2000, 6), (1000, 1000, 6),
    (248, 248, 4), (256, 256, 3), (60, 72, 6), (256, 256, 5),
    (2000, 2000, 8), (256, 258, 6)])
def test_gates_match_jax(nx, ny, q):
    port = PAIRS.get(q, PAIRS[6])[0]
    jmod = PAIRS.get(q, PAIRS[6])[1]
    model = Clock2D(nx=nx, ny=ny, kbt=KBT, q=q)
    jmodel = JaxClock(nx=nx, ny=ny, kbt=KBT, q=q, backend="jnp")
    half = nx // 2
    assert tuple(cp.padded_spec(ny, half) or ()) == tuple(
        jcp.padded_spec(ny, half) or ())
    assert cp.packable_gate(port.SPEC, model) == jcp.packable_gate(
        jmod.SPEC, jmodel)
    assert cp.padded_packable_gate(port.SPEC, model) == \
        jcp.padded_packable_gate(jmod.SPEC, jmodel)
    served = (q in PAIRS and (jcp.packable_gate(jmod.SPEC, jmodel)
                              or jcp.padded_packable_gate(jmod.SPEC, jmodel)))
    assert (sweep.clock_route(model) is not None) == served


@pytest.mark.parametrize("flags", [
    ["--nx", "255", "--ny", "256", "--q", "5"],
    ["--nx", "61", "--ny", "72", "--q", "3"],
    ["--nx", "255", "--ny", "256", "--q", "8"],
])
def test_unserved_clock_shapes_raise_b13(flags, tmp_path):
    """The helical clock at q != 6 (odd nx), refused naming B13 before the
    masked helical kernels were ported, runs on them now; the periodic
    shapes and q this test refused before the int8 clock kernels were
    ported run too (tests/test_torch_clock_int8_runs.py
    test_formerly_refused_clock_shapes_run)."""
    out = tmp_path / "x.dat"
    assert main(["--model", "clock", "--mcs", "2", "--samples", "2",
                 "--device", "cpu", "--output", str(out)] + flags) == 0
    assert "# engine: helical_pallas multisweep (masked clock)" in \
        out.read_text().splitlines()


@pytest.mark.parametrize("q", [6, 4, 3])
@pytest.mark.parametrize("ny,nx", SHAPES)
def test_interop_round_trip(q, ny, nx):
    port, _ = PAIRS[q]
    a, _ = _colors(np.random.default_rng(q * nx), q, 3, ny, nx)
    planes = port.SPEC.pack_color(_t(a))
    back = interop.clock_from_numpy(
        interop.clock_to_numpy(planes, ny, nx // 2), ny, nx // 2)
    for g_, w_ in zip(back, planes):
        assert torch.equal(g_, w_)


CLI = ["--model", "clock", "--nx", "248", "--ny", "248", "--kbt", "0.91",
       "--mcs", "12", "--samples", "16", "--replicas", "4"]


def _split(path):
    lines = path.read_text().splitlines()
    head = [s for s in lines if s.startswith("#")]
    rows = np.array([s.split() for s in lines if not s.startswith("#")],
                    dtype=np.float64)
    return head, rows


def test_cli_writes_the_dat_and_matches_jax(tmp_path):
    """The port's CLI on the CPU writes the 10-column table with the JAX
    CLI's headers; m(t), e(t) agree within 5 combined standard errors
    (Philox against threefry, packed against the JAX int8 engine)."""
    path, jpath = tmp_path / "port.dat", tmp_path / "jax.dat"
    assert main(CLI + ["--device", "cpu", "--output", str(path)]) == 0
    assert jax_main(CLI + ["--output", str(jpath)]) == 0
    head, rows = _split(path)
    jhead, jrows = _split(jpath)
    assert [h for h in head if not h.startswith("# engine:")] == [
        h for h in jhead if not h.startswith("# engine:")]
    assert "# engine: clock q=6 bit-sliced packed (padded)" in head
    assert rows.shape == jrows.shape == (12, 10)
    np.testing.assert_array_equal(rows[:, :3], jrows[:, :3])
    n, ns = rows[0, 0], rows[0, 1]
    for col, var_col in ((3, 7), (4, 8)):
        se = np.sqrt((rows[:, var_col] + jrows[:, var_col]) / (n * ns))
        assert np.all(np.abs(rows[:, col] - jrows[:, col]) / se < 5.0)

