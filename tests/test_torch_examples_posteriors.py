"""The three heaviest gates of tests/test_examples.py on the torch examples
(``examples_torch/``), on the CPU: eight schools against its exact (mu,
tau) marginal by quadrature, the vaso probit's three manifold samplers
against each other, and the funnel's v-marginal by WALNUTS and
``slice_sample``.  The examples load by path as in
tests/test_torch_examples.py."""
import pathlib

import numpy as np
import torch

import mcmc_jl_tpu_torch as mt
from test_torch_examples import load_example, mean_se, pooled

torch.set_num_threads(1)
F64 = torch.float64


def test_eight_schools_matches_exact_quadrature():
    """NUTS with mass adaptation through run_until (8 chains, the JAX
    test's gates): the (mu, tau) posterior against the exact marginal by
    quadrature."""
    es = load_example("eight_schools")
    m = es.make_model(device="cpu", dtype=F64)
    res = mt.run_until(m, mt.NUTS(mass_adapt=True), n_chains=8,
                       rhat_target=1.02, min_ess=600, check_every=400,
                       max_steps=4000, seed=3)
    assert res.converged, res.history
    draws = res.samples.reshape(-1, m.size)
    mu, tau = draws[:, 0], np.exp(draws[:, 1])
    mu_mean, mu_sd, tau_median = es.exact_posterior()
    se = mu_sd / np.sqrt(res.min_ess)
    assert abs(mu.mean() - mu_mean) < 6 * se + 0.2, (mu.mean(), mu_mean)
    assert abs(mu.std() - mu_sd) < 0.5, (mu.std(), mu_sd)
    assert abs(np.median(tau) - tau_median) < 0.6, (np.median(tau),
                                                    tau_median)


def test_probit_vaso_posterior_parity():
    """The vendored vaso data (39 rows, read from examples/vaso.txt): the
    posterior means of SMMALA, PMALA and RMHMC (8 chains each) agree within
    6 standard errors + 0.05."""
    pr = load_example("probit_regression")
    X, y = pr.make_data()
    assert X.shape == (39, 3)
    assert pathlib.Path(pr.VASO).parts[-2:] == ("examples", "vaso.txt")
    ref = np.loadtxt(pr.VASO)
    assert ref.shape == (39, 3) and set(np.unique(ref[:, 2])) <= {0.0, 1.0}

    m = pr.make_model(X, y, device="cpu", dtype=F64)

    def run(s, r, seed):
        return mt.run(m * s * mt.SerialMC(r), chains=8, seed=seed)

    chains = {
        "SMMALA": run(mt.SMMALA(0.5), range(300, 1001), 1),
        "PMALA": run(mt.PMALA(0.5), range(300, 1001), 2),
        "RMHMC": run(mt.RMHMC(3, 0.5, mt.EmpMCTuner(0.8)), range(200, 451),
                     3),
    }
    stats = {k: mean_se(c) for k, c in chains.items()}
    names = list(chains)
    for i in range(len(names)):
        for j in range(i + 1, len(names)):
            (ma, sa), (mb, sb) = stats[names[i]], stats[names[j]]
            diff = np.abs(ma - mb)
            tol = 6 * (sa + sb) + 0.05
            assert np.all(diff < tol), (names[i], names[j], diff, tol)


def test_funnel_example():
    """WALNUTS (8 chains) and ``slice_sample`` both reach the funnel's
    v-marginal N(0, 9) on the example's model: the JAX test's variance
    floors (5.5 and 5.0), and the mean within 5 standard errors of 0 (by
    the spread of the chain means for WALNUTS, by the chain's IMSE MCSE
    for the slice sampler: its v-mean over 2000 draws moves by about 1
    from seed to seed, so the JAX test's fixed |mean| < 1 is no gate on
    one stream)."""
    funnel = load_example("funnel")
    m = funnel.make_model(device="cpu", dtype=F64)
    cs = mt.run(m * mt.WALNUTS(maxdoublings=6, max_halvings=5)
                * mt.SerialMC(steps=150, burnin=50), chains=8, seed=0)
    v = pooled(cs)[:, 0]
    mu, se = mean_se(cs)
    assert abs(mu[0]) < 5 * se[0] and v.var() > 5.5, (mu[0], se[0], v.var())

    xs = mt.slice_sample(m.eval, torch.zeros(funnel.DIM_X + 1, dtype=F64),
                         1500, widths=5.0, seed=0)
    vs = np.asarray(xs)[500:, 0]
    mcse = float(mt.mcse(vs[:, None])[0])
    assert abs(vs.mean()) < 5 * mcse and vs.var() > 5.0, (vs.mean(), mcse,
                                                          vs.var())
