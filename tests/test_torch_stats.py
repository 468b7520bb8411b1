"""(e) The port's chain statistics (mcmc_jl_tpu_torch/stats, ops/acf.py)
against the JAX package's on one numpy chain, in float64."""
import io
import re

import numpy as np
import pytest
import torch

import mcmc_jl_tpu as mc
import mcmc_jl_tpu_torch as mt
from mcmc_jl_tpu.core.chain import MCMCChain as JChain
from mcmc_jl_tpu.ops.acf import autocov as jax_autocov
from mcmc_jl_tpu.utils.table import Table as JTable
from mcmc_jl_tpu_torch.core.chain import MCMCChain as TChain
from mcmc_jl_tpu_torch.ops.acf import autocov
from mcmc_jl_tpu_torch.stats import mcmc_quantile, mean_rb
from mcmc_jl_tpu_torch.utils.table import Table as TTable

torch.set_num_threads(1)
RTOL = 1e-10


def _chain_data(n=1500, p=3, seed=0):
    """An AR(1) chain per column (phi = 0.5, 0.8, -0.3) and accept flags."""
    rng = np.random.default_rng(seed)
    phi = np.array([0.5, 0.8, -0.3])[:p]
    x = np.zeros((n, p))
    e = rng.standard_normal((n, p))
    for i in range(1, n):
        x[i] = phi * x[i - 1] + e[i]
    acc = rng.random(n) < 0.7
    return x, acc


def _chains():
    x, acc = _chain_data()
    cols = ["a", "b", "c"]
    diags = {"accept": acc, "step": np.arange(1, x.shape[0] + 1)}
    jc = JChain(range=range(1, x.shape[0] + 1), samples=JTable(x, cols),
                gradients=JTable(np.zeros((0, 3)), cols), diagnostics=diags,
                task=None)
    tc = TChain(range=range(1, x.shape[0] + 1), samples=TTable(x, cols),
                gradients=TTable(np.zeros((0, 3)), cols), diagnostics=diags,
                task=None)
    return jc, tc


def test_autocov_matches_jax():
    x, _ = _chain_data()
    np.testing.assert_allclose(autocov(x, 50).numpy(),
                               np.asarray(jax_autocov(x, 50)), rtol=RTOL,
                               atol=1e-12)
    np.testing.assert_allclose(autocov(x[:, 0]).numpy(),
                               np.asarray(jax_autocov(x[:, 0])), rtol=RTOL,
                               atol=1e-12)


def test_mean_and_acceptance_match_jax():
    jc, tc = _chains()
    np.testing.assert_allclose(mt.mean(tc), mc.mean(jc), rtol=RTOL)
    np.testing.assert_allclose(mt.mean(tc, pars=[0, 2]), mc.mean(jc, pars=[0, 2]),
                               rtol=RTOL)
    assert mt.acceptance(tc) == mc.acceptance(jc)
    assert mt.acceptance(tc, reject=True) == mc.acceptance(jc, reject=True)
    assert mt.acceptance(tc, lags=np.arange(1, 200)) == mc.acceptance(
        jc, lags=np.arange(1, 200))


@pytest.mark.parametrize("vtype", ["iid", "bm", "imse", "ipse"])
def test_var_and_mcse_match_jax(vtype):
    jc, tc = _chains()
    np.testing.assert_allclose(mt.var(tc, vtype=vtype), mc.var(jc, vtype=vtype),
                               rtol=RTOL)
    np.testing.assert_allclose(mt.mcse(tc, vtype=vtype),
                               mc.mcse(jc, vtype=vtype), rtol=RTOL)


@pytest.mark.parametrize("vtype", ["bm", "imse", "ipse"])
def test_ess_and_actime_match_jax(vtype):
    jc, tc = _chains()
    np.testing.assert_allclose(mt.ess(tc, vtype=vtype), mc.ess(jc, vtype=vtype),
                               rtol=RTOL)
    np.testing.assert_allclose(mt.actime(tc, vtype=vtype),
                               mc.actime(jc, vtype=vtype), rtol=RTOL)


def test_quantiles_match_jax():
    jc, tc = _chains()
    est_t, se_t = mcmc_quantile(tc, [0.1, 0.5, 0.9])
    est_j, se_j = mc.mcmc_quantile(jc, [0.1, 0.5, 0.9])
    np.testing.assert_allclose(est_t, est_j, rtol=RTOL)
    np.testing.assert_allclose(se_t, se_j, rtol=RTOL)


def _numbers(text):
    return [float(v) for v in re.findall(r"-?\d+\.?\d*(?:e[-+]?\d+)?", text)]


def test_describe_matches_jax():
    """Same report, line by line: labels equal, numbers within RTOL."""
    jc, tc = _chains()
    out_j, out_t = io.StringIO(), io.StringIO()
    mc.describe(jc, io=out_j)
    mt.describe(tc, io=out_t)
    lines_j = out_j.getvalue().splitlines()
    lines_t = out_t.getvalue().splitlines()
    assert len(lines_j) == len(lines_t)
    for a, b in zip(lines_t, lines_j):
        assert re.sub(r"[-\d.e+]+", "#", a) == re.sub(r"[-\d.e+]+", "#", b)
        np.testing.assert_allclose(_numbers(a), _numbers(b), rtol=1e-8)


def test_mean_rb_matches_jax():
    """Rao-Blackwell mean over stored trajectories, same arrays."""
    rng = np.random.default_rng(3)
    n, nl, p = 200, 4, 2
    x = rng.standard_normal((n, p))
    diags = {"accept": np.ones(n, bool),
             "leaps_pars": rng.standard_normal((n, nl + 1, p)),
             "leaps_H": rng.standard_normal((n, nl + 1)) * 0.1,
             "leaps_n": np.full(n, nl)}
    cols = ["a", "b"]
    jc = JChain(range=range(1, n + 1), samples=JTable(x, cols),
                gradients=JTable(np.zeros((0, p)), cols), diagnostics=diags,
                task=None)
    tc = TChain(range=range(1, n + 1), samples=TTable(x, cols),
                gradients=TTable(np.zeros((0, p)), cols), diagnostics=diags,
                task=None)
    np.testing.assert_allclose(mean_rb(tc), mc.mean_rb(jc), rtol=RTOL)
