"""The ten torch examples (``examples_torch/``), scaled for CI, held to the
gates of tests/test_examples.py on the CPU (eight schools, the vaso
parity and the funnel in tests/test_torch_examples_posteriors.py).

Each example is loaded by path under a module name of its own
(``examples_torch_<name>``): tests/test_examples.py imports the JAX
examples by their bare names, and one worker may run both files.

The port's generic engine runs chains as one batch, so where the JAX
tests run one long chain these run a batch of shorter ones, and hold the
pooled mean by the spread of the per-chain means.  Linear regression has a
closed-form posterior (Gaussian prior and likelihood: the ridge
posterior); the port is held to it."""
import functools
import importlib.util
import pathlib
import re

import numpy as np
import pytest
import torch

import mcmc_jl_tpu_torch as mt

torch.set_num_threads(1)
F64 = torch.float64
EXAMPLES = pathlib.Path(__file__).parent.parent / "examples_torch"
NAMES = ("eight_schools", "funnel", "linear_regression",
         "logistic_regression", "model_comparison", "ornstein",
         "parallel_serialmc", "poisson_regression", "probit_regression",
         "warmstart_logistic")


@functools.lru_cache(maxsize=None)
def load_example(name):
    """``examples_torch/<name>.py`` as the module ``examples_torch_<name>``."""
    spec = importlib.util.spec_from_file_location(
        f"examples_torch_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def pooled(chains):
    """Draws of several chains as one (rows, d) array."""
    return np.concatenate([c.samples.values for c in chains])


def mean_se(chains):
    """The pooled mean of several independent chains and its standard
    error, from the spread of the per-chain means."""
    cm = np.stack([c.samples.values.mean(0) for c in chains])
    return cm.mean(0), cm.std(0, ddof=1) / np.sqrt(len(cm))


@pytest.mark.parametrize("name", NAMES)
def test_example_imports_only_the_port(name):
    """Each example loads on a machine without a card (nothing runs at
    import), imports no JAX module, and has a ``main``."""
    mod = load_example(name)
    assert mod.__name__ == f"examples_torch_{name}"
    assert callable(mod.main)
    src = (EXAMPLES / f"{name}.py").read_text()
    assert not re.search(r"^\s*(import|from)\s+(jax|mcmc_jl_tpu)\b(?!_torch)",
                         src, re.M)
    assert "import mcmc_jl_tpu_torch as mt" in src


def test_linear_regression_posterior_matches_analytic():
    """tests/test_examples.py's ridge-posterior gates on the example's data
    and model (16 chains): HMC within |z| < 5 of the exact mean and 15% of
    its sd, RAM within |z| < 6."""
    lr = load_example("linear_regression")
    X, Y, _ = lr.make_data(seed=1, n=200, nbeta=5)
    m = lr.make_model(X, Y, gradient=True, device="cpu", dtype=F64)
    P = X.T @ X + np.eye(5)
    cov = np.linalg.inv(P)
    mean = cov @ (X.T @ Y)

    cs = mt.run(m * mt.HMC(10, 0.05) * mt.SerialMC(steps=400, burnin=150),
                chains=16, seed=0)
    mu, se = mean_se(cs)
    z = np.abs(mu - mean) / se
    assert np.all(z < 5), (z, mu, mean)
    sd = pooled(cs).std(axis=0, ddof=1)
    np.testing.assert_allclose(sd, np.sqrt(np.diag(cov)), rtol=0.15)

    cs2 = mt.run(m * mt.RAM(1.0, 0.3) * mt.SerialMC(range(1000, 3001, 2)),
                 chains=16, seed=1)
    mu2, se2 = mean_se(cs2)
    z2 = np.abs(mu2 - mean) / se2
    assert np.all(z2 < 6), z2


def test_logistic_regression_example():
    """HMC and NUTS on the example's DSL model (8 chains each) agree within
    MC error and correlate with the generating coefficients."""
    lre = load_example("logistic_regression")
    X, Y, beta0 = lre.make_data(n=300, nbeta=6)
    m = lre.make_model(X, Y, nbeta=6, device="cpu", dtype=F64)
    c_hmc = mt.run(m * mt.HMC(5, 0.1) * mt.SerialMC(range(200, 501)),
                   chains=8, seed=0)
    c_nuts = mt.run(m * mt.NUTS() * mt.SerialMC(range(150, 401)), chains=8,
                    seed=1)
    assert np.mean([mt.acceptance(c) for c in c_hmc]) > 40
    (mh, sh), (mn, sn) = mean_se(c_hmc), mean_se(c_nuts)
    diff = np.abs(mh - mn)
    assert np.all(diff < 6 * (sh + sn) + 0.05), (diff, sh, sn)
    assert np.corrcoef(mh, beta0)[0, 1] > 0.9


def test_ornstein_example():
    """RAM (8 chains) recovers the generating (tau, sigma, mu) loosely on a
    short series; NUTS runs on it, on the generic engine: a data-bearing
    target has no target_spec."""
    orn = load_example("ornstein")
    x = orn.make_series(duration=400)
    m = orn.make_model(x, device="cpu", dtype=F64)
    assert m.target_spec is None
    cs = mt.run(m * mt.RAM() * mt.SerialMC(range(1000, 2001)), chains=8,
                seed=0)
    est = mean_se(cs)[0]  # tau, sigma, mu
    assert 2 < est[0] < 100, est
    assert 0.05 < est[1] < 0.3, est
    assert 8 < est[2] < 12, est
    c2 = mt.run(m * mt.NUTS() * mt.SerialMC(range(20, 41)), seed=1)
    assert "ndoublings" in c2.diagnostics


def test_probit_example_manifold_samplers():
    """SMMALA and PMALA agree with RWM on the vaso posterior mean (8 chains
    each); RMHMC with a tuner runs finite."""
    pr = load_example("probit_regression")
    X, y = pr.make_data(n=60)
    m = pr.make_model(X, y, device="cpu", dtype=F64)
    assert m.hasgradient and m.hastensor and m.hasdtensor

    def run(s, seed):
        return mt.run(m * s * mt.SerialMC(range(300, 1001)), chains=8,
                      seed=seed)

    c_rwm = run(mt.RWM(0.5), 0)
    c_smm = run(mt.SMMALA(0.5), 1)
    c_pml = run(mt.PMALA(0.5), 2)
    assert np.mean([mt.acceptance(c) for c in c_smm]) > 20
    m_rwm, s_rwm = mean_se(c_rwm)
    for c in (c_smm, c_pml):
        m_c, s_c = mean_se(c)
        diff = np.abs(m_rwm - m_c)
        assert np.all(diff < 8 * (s_rwm + s_c) + 0.1), (diff, s_rwm, s_c)

    c_rm = mt.run(m * mt.RMHMC(3, 0.5, mt.EmpMCTuner(0.8)) *
                  mt.SerialMC(range(100, 301)), chains=4, seed=3)
    assert all(np.all(np.isfinite(c.samples.values)) for c in c_rm)


def test_fd_gradient_of_probit_analytic_derivatives():
    """The example's closed-form gradient against torch.func's, and its
    metric tensor positive definite at a moderate theta."""
    pr = load_example("probit_regression")
    X, y = pr.make_data(n=40)
    m = pr.make_model(X, y, device="cpu", dtype=F64)
    theta = torch.tensor(np.random.default_rng(0).standard_normal(m.size)
                         * 0.3, dtype=F64)
    _, g_analytic = m.evalallg(theta)
    g_auto = torch.func.grad(m.eval)(theta)
    np.testing.assert_allclose(g_analytic.numpy(), g_auto.numpy(),
                               rtol=1e-6, atol=1e-8)
    G = m.evalt(theta).numpy()
    assert np.all(np.linalg.eigvalsh(G) > 0)


def test_poisson_regression_example():
    """The Poisson GLM with exposure offsets: the posterior covers the
    truth within 6 combined sigmas of MC error and Fisher sd."""
    ex = load_example("poisson_regression")
    X, Y, log_e, beta_true = ex.make_data(n=250, seed=7)
    m = ex.make_model(X, Y, log_e, device="cpu", dtype=F64)
    chain = mt.run(m * mt.NUTS() * mt.SerialMC(steps=2000, burnin=800),
                   seed=0)
    est = chain.samples.values.mean(axis=0)
    se = np.sqrt(mt.var(chain))
    fisher_sd = np.sqrt(np.diag(np.linalg.inv(
        X.T @ (np.exp(log_e + X @ beta_true)[:, None] * X)
        + 0.01 * np.eye(3))))
    assert np.all(np.abs(est - beta_true) < 6 * (se + fisher_sd)), (
        est, beta_true, se, fisher_sd)


def test_model_comparison_example():
    """ASMC's logZ of the example's M1 within 0.4 of the analytic
    conjugate evidence, with the example's own ``prior_sample``."""
    mcmp = load_example("model_comparison")
    exact = mcmp.analytic_logz()
    m1 = mcmp.make_model(device="cpu", dtype=F64)
    smc = mt.run(
        m1 * mt.RWM(0.4) * mt.ASMC(particles=1024, moves=2,
                                   logprior=mcmp.logprior,
                                   prior_sample=mcmp.prior_sample),
        seed=1)
    assert abs(smc.diagnostics["logz"] - exact) < 0.4


def test_acc_outside_trace_raises():
    load_example("eight_schools")
    with pytest.raises(RuntimeError):
        mt.acc(1.0)


def test_warmstart_example():
    """The warm-start example recovers the generating coefficients (on the
    CPU its run takes the generic engine, as the JAX one does off the
    TPU)."""
    ws = load_example("warmstart_logistic")
    chains = ws.main(n=200, nbeta=4, chains=4, steps=600, burnin=200,
                     device="cpu")
    X, Y, beta0 = ws.make_data(200, 4)
    pooled_mean = np.mean([c.samples.values.mean(0) for c in chains], axis=0)
    sd = np.mean([np.sqrt(mt.var(c)) for c in chains], axis=0)
    assert np.all(np.abs(pooled_mean - beta0) < 5 * sd + 0.5), (pooled_mean,
                                                                beta0)


def test_parallel_serialmc_example():
    """The ten HMC(0.75) chains through prun on a one-entry CPU mesh
    (``default_mesh(devices=["cpu"])``): the README's acceptance (about
    80%) on every chain, and the N(0, I/2) moments pooled."""
    ps = load_example("parallel_serialmc")
    chains = ps.main(device="cpu", steps=1000, burnin=200)
    assert len(chains) == 10
    acc = [mt.acceptance(c) for c in chains]
    assert all(60 < a < 95 for a in acc), acc
    x = pooled(chains)
    assert np.all(np.abs(x.mean(0)) < 0.1) and np.all(
        np.abs(x.var(0) - 0.5) < 0.1), (x.mean(0), x.var(0))
