"""Port vs JAX: Kahan statistics (bitwise), .dat text (identical),
checkpoints (JAX-written loads in the port and back), the run registry,
and the interop round trips."""

import dataclasses
import io
import json

import numpy as np
import pytest
import torch

from cuda_fortran_mc_simulation_spin_tpu import config as jconfig
from cuda_fortran_mc_simulation_spin_tpu.core import stats as jstats
from cuda_fortran_mc_simulation_spin_tpu.engine import protocols as jprot
from cuda_fortran_mc_simulation_spin_tpu.io import checkpoint as jckpt
from cuda_fortran_mc_simulation_spin_tpu.io import datfmt as jdat
from cuda_fortran_mc_simulation_spin_tpu.io import registry as jreg
from cuda_fortran_mc_simulation_spin_tpu_torch import config, interop
from cuda_fortran_mc_simulation_spin_tpu_torch.core import stats
from cuda_fortran_mc_simulation_spin_tpu_torch.io import (
    checkpoint,
    datfmt,
    registry,
)


def _series(seed, batches=5, replicas=4, mcs=30):
    g = np.random.default_rng(seed)
    return [(g.normal(0.7, 0.1, (replicas, mcs)),
             g.normal(-1.4, 0.05, (replicas, mcs)))
            for _ in range(batches)]


def _fill(mod, series):
    op = mod.VarianceCovarianceKahan((series[0][0].shape[-1],))
    vk = mod.VarianceKahan((series[0][0].shape[-1],))
    for i, (m, e) in enumerate(series):
        if i % 2:
            op.add_data(m, e)
            vk.add_data(m)
        else:
            for r in range(m.shape[0]):
                op.add_data(m[r], e[r])
                vk.add_data(m[r])
    return op, vk


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kahan_accumulators_bitwise_equal_to_jax(seed):
    ser = _series(seed)
    op, vk = _fill(stats, ser)
    jop, jvk = _fill(jstats, ser)
    for name in ("mean1", "mean2", "square_mean1", "square_mean2", "var1",
                 "var2", "cov", "mean_v1v2"):
        np.testing.assert_array_equal(getattr(op, name)(),
                                      getattr(jop, name)())
    for name in ("mean", "square_mean", "var"):
        np.testing.assert_array_equal(getattr(vk, name)(),
                                      getattr(jvk, name)())
    assert op.num_sample() == jop.num_sample() == 20
    for k, v in op.state_dict().items():
        np.testing.assert_array_equal(v, jop.state_dict()[k])


def test_relaxation_text_identical_to_jax():
    op, _ = _fill(stats, _series(3))
    jop, _ = _fill(jstats, _series(3))
    cfg = config.RunConfig(nx=256, ny=256, mcs=30, tot_sample=20)
    jcfg = jconfig.RunConfig(nx=256, ny=256, mcs=30, tot_sample=20)
    fields = {"size": 65536, "nx, ny": (256, 256), "kbt": 2.26918531421,
              "method": "Metropolis", "flag": True}
    out, jout = io.StringIO(), io.StringIO()
    datfmt.write_header(out, fields)
    jdat.write_header(jout, fields)
    datfmt.write_relaxation_table(out, 65536, 30, op)
    jdat.write_relaxation_table(jout, 65536, 30, jop)
    assert out.getvalue() == jout.getvalue()
    times = (1, 7, 30)
    out, jout = io.StringIO(), io.StringIO()
    op_t, _ = _fill(stats, [(m[:, :3], e[:, :3]) for m, e in _series(4)])
    jop_t, _ = _fill(jstats, [(m[:, :3], e[:, :3]) for m, e in _series(4)])
    datfmt.write_specific_times_table(out, 65536, times, op_t)
    jprot._write_specific_times_table(jout, 65536, times, jop_t)
    assert out.getvalue() == jout.getvalue()
    assert datfmt.g0(np.float64(0.1)) == jdat.g0(np.float64(0.1))
    assert cfg.nsites == jcfg.nsites


CONFIGS = [
    {},
    {"nx": 2048, "ny": 2048, "mcs": 1000, "tot_sample": 64, "replicas": 16},
    {"seed": 7, "stream": 3, "init_state": "random",
     "measure_times": [1, 5, 9], "mcs": 10},
]


@pytest.mark.parametrize("kw", CONFIGS)
def test_run_config_fields_and_fingerprint_match_jax(kw):
    cfg, jcfg = config.RunConfig(**kw), jconfig.RunConfig(**kw)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert checkpoint.config_fingerprint(cfg) == jckpt.config_fingerprint(
        jcfg)


def test_jax_checkpoint_loads_in_port_and_back(tmp_path):
    ser = _series(5)
    jop, _ = _fill(jstats, ser)
    kw = {"nx": 256, "ny": 256, "mcs": 30, "tot_sample": 40}
    path = str(tmp_path / "ck.npz")
    jckpt.save(path, jconfig.RunConfig(**kw), 20, {"op": jop})
    op = stats.VarianceCovarianceKahan((30,))
    assert checkpoint.load(path, config.RunConfig(**kw), {"op": op}) == 20
    for k, v in jop.state_dict().items():
        np.testing.assert_array_equal(op.state_dict()[k], v)
    np.testing.assert_array_equal(op.var1(), jop.var1())
    with pytest.raises(ValueError, match="different config"):
        checkpoint.load(path, config.RunConfig(**{**kw, "seed": 1}),
                        {"op": stats.VarianceCovarianceKahan((30,))})
    # and the port's checkpoint loads in the JAX package
    path2 = str(tmp_path / "ck2.npz")
    checkpoint.save(path2, config.RunConfig(**kw), 20, {"op": op})
    jop2 = jstats.VarianceCovarianceKahan((30,))
    assert jckpt.load(path2, jconfig.RunConfig(**kw), {"op": jop2}) == 20
    np.testing.assert_array_equal(jop2.cov(), jop.cov())


def test_registry_record_matches_jax_keys(tmp_path):
    p, jp = tmp_path / "reg.log", tmp_path / "jreg.log"
    registry.append(str(p), config.RunConfig(), 1.5, "o.dat", {"x": 1})
    jreg.append(str(jp), jconfig.RunConfig(), 1.5, "o.dat", {"x": 1})
    rec, jrec = json.loads(p.read_text()), json.loads(jp.read_text())
    rec.pop("timestamp")
    jrec.pop("timestamp")
    assert rec == jrec


def test_interop_round_trips():
    g = np.random.default_rng(8)
    a = (g.integers(0, 2, (2, 64, 32), dtype=np.int8) * 2 - 1)
    b = (g.integers(0, 2, (2, 64, 32), dtype=np.int8) * 2 - 1)
    st = interop.checkerboard_from_numpy(a, b)
    assert st.a.dtype == torch.int8
    ra, rb = interop.checkerboard_to_numpy(st)
    np.testing.assert_array_equal(ra, a)
    np.testing.assert_array_equal(rb, b)
    wa = g.integers(-2 ** 31, 2 ** 31, (2, 2, 32)).astype(np.int32)
    wb = g.integers(-2 ** 31, 2 ** 31, (2, 2, 32)).astype(np.int32)
    ta, tb = interop.packed_from_numpy(wa, wb)
    assert ta.dtype == torch.int32
    for got, want in zip(interop.packed_to_numpy(ta, tb), (wa, wb)):
        np.testing.assert_array_equal(got, want)
    jop, _ = _fill(jstats, _series(6))
    op = stats.VarianceCovarianceKahan((30,))
    op.load_state_dict(interop.stats_state_from_numpy(jop.state_dict()))
    jop2 = jstats.VarianceCovarianceKahan((30,))
    jop2.load_state_dict(interop.stats_state_to_numpy(op))
    np.testing.assert_array_equal(jop2.var2(), jop.var2())
    assert jop2.num_sample() == jop.num_sample()
