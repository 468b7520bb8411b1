"""``mcmc_jl_tpu_torch.utils.profiling`` against the JAX package's
``utils/profiling.py``, on the CPU: tests/test_stats.py's
``test_throughput_report`` on the port, ``throughput_report`` against the
JAX one on the same draws and run time, and ``trace`` writing a Chrome trace
of a run."""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mcmc_jl_tpu as mc
from mcmc_jl_tpu.utils import profiling as jprof
from mcmc_jl_tpu.utils.table import Table as JTable
import mcmc_jl_tpu_torch as mt
from mcmc_jl_tpu_torch.utils import profiling as tprof
from mcmc_jl_tpu_torch.utils.table import Table

torch.set_num_threads(1)


def _gaussian_chain(steps=1200, burnin=200, leap_step=0.75):
    """tests/test_stats.py ``_gaussian_chain`` on the port."""
    m = mt.model(lambda v: -(v * v).sum(), grad=lambda v: -2 * v,
                 init=np.ones(3), dtype=torch.float64, device="cpu")
    return mt.run(m * mt.HMC(leap_step) * mt.SerialMC(steps=steps,
                                                      burnin=burnin))


def test_throughput_report():
    """tests/test_stats.py:168 on the port."""
    chain = _gaussian_chain(steps=1200, burnin=200)
    rep = tprof.throughput_report(chain, n_chains=1, n_leaps=10)
    assert rep["steps_per_sec"] > 0
    assert rep["leapfrog_per_sec"] == rep["steps_per_sec"] * 10
    assert "ess_per_sec" in rep and rep["ess_per_sec"] > 0

    sink = []
    with tprof.timed("block", sink=sink):
        pass
    assert sink and sink[0]["label"] == "block" and sink[0]["seconds"] >= 0


def _jax_chain(chain):
    """The JAX package's MCMCChain of the port chain's kept draws, range
    and run time."""
    names = list(chain.samples.columns)
    return mc.MCMCChain(range=chain.range,
                        samples=JTable(jnp.asarray(chain.samples.values),
                                       names),
                        gradients=JTable(np.zeros((0, len(names))), names),
                        diagnostics={}, task=None, run_time=chain.run_time)


@pytest.mark.parametrize("n_chains,n_leaps", [(1, None), (4096, 10)])
def test_throughput_report_matches_jax(n_chains, n_leaps):
    """On the same kept draws, range and run time, the port's report has
    the JAX package's keys and values: ``ess_per_param`` and every rate to
    1e-10."""
    chain = _gaussian_chain(steps=1500, burnin=300)
    chain.run_time = 0.8125
    rep = tprof.throughput_report(chain, n_chains=n_chains, n_leaps=n_leaps)
    want = jprof.throughput_report(_jax_chain(chain), n_chains=n_chains,
                                   n_leaps=n_leaps)
    assert set(rep) == set(want)
    np.testing.assert_allclose(rep["ess_per_param"], want["ess_per_param"],
                               rtol=1e-10)
    for k in ("run_time_s", "steps_per_sec", "ess_per_sec") + (
            ("leapfrog_per_sec",) if n_leaps else ()):
        np.testing.assert_allclose(rep[k], want[k], rtol=1e-10)
    assert rep["steps_per_sec"] == 1500 * n_chains / 0.8125


def test_throughput_report_one_row():
    """A chain of one kept row: the same keys as the JAX package's report,
    the same rates."""
    chain = _gaussian_chain(steps=20, burnin=19)
    chain.samples = Table(chain.samples.values[:1], chain.samples.columns)
    rep = tprof.throughput_report(chain)
    want = jprof.throughput_report(_jax_chain(chain))
    assert set(rep) == set(want)
    assert rep["steps_per_sec"] == want["steps_per_sec"]


def test_trace_writes_a_chrome_trace(tmp_path):
    """``trace`` on the CPU: the block runs, ``logdir`` is yielded, and a
    Chrome trace that names the block's operators lands in it."""
    logdir = str(tmp_path / "tr")
    with tprof.trace(logdir) as d:
        chain = _gaussian_chain(steps=30, burnin=10)
    assert d == logdir and chain.samples.values.shape == (20, 3)
    path = os.path.join(logdir, tprof.TRACE_FILE)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any(n.startswith("aten::") for n in names), sorted(names)[:20]
