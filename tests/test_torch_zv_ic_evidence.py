"""The port's zero-variance estimators (stats/zv.py), information criteria
(stats/ic.py) and evidence estimators (stats/evidence.py) against the JAX
package's, on the CPU in float64, and the port's top-level surface against
the JAX package's.

Tolerance: rtol 1e-10 (both packages run the same numpy operations in the
same order on float64 inputs; the pointwise log-likelihood is one float64
expression per draw in each)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mcmc_jl_tpu as mc
from mcmc_jl_tpu.stats import evidence as jev
from mcmc_jl_tpu.stats import ic as jic
from mcmc_jl_tpu.stats import zv as jzv
import mcmc_jl_tpu_torch as mt
from mcmc_jl_tpu_torch.core.chain import MCMCChain
from mcmc_jl_tpu_torch.stats import evidence as tev
from mcmc_jl_tpu_torch.stats import ic as tic
from mcmc_jl_tpu_torch.stats import zv as tzv
from mcmc_jl_tpu_torch.utils.table import Table

torch.set_num_threads(1)
RTOL = 1e-10
F64 = torch.float64

#: names of the JAX package's surface that the port does not have yet:
#: none, the port exports every one
STILL_TO_PORT = set()


def _gauss_draws(n=600, d=3, seed=0):
    """Draws of N(mu, diag(s^2)) with their log-density gradients."""
    rng = np.random.default_rng(seed)
    mu, s = np.array([0.5, -1.0, 2.0])[:d], np.array([1.0, 0.5, 2.0])[:d]
    x = mu + s * rng.standard_normal((n, d))
    return x, -(x - mu) / s ** 2


def _same_dict(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k], dtype=np.float64),
                                   np.asarray(want[k], dtype=np.float64),
                                   rtol=RTOL, atol=0, err_msg=k)


@pytest.mark.parametrize("fn", ["linear_zv", "quadratic_zv", "linearZv",
                                "quadraticZv"])
def test_zv_on_arrays_matches_jax(fn):
    x, g = _gauss_draws()
    got_x, got_a = getattr(tzv, fn)(x, g)
    want_x, want_a = getattr(jzv, fn)(x, g)
    np.testing.assert_allclose(got_a, want_a, rtol=RTOL, atol=1e-14)
    np.testing.assert_allclose(got_x, want_x, rtol=RTOL, atol=1e-14)
    # the control variates remove almost all variance of a Gaussian's mean
    assert np.all(got_x.var(0) < 1e-3 * x.var(0))


@pytest.mark.parametrize("sampler", ["MALA", "Barker"])
def test_zv_on_chain_with_stored_gradients(sampler):
    """A port chain of a gradient sampler keeps its gradients; both
    estimators on it equal the JAX functions on its arrays."""
    mu = torch.tensor([0.5, -1.0], dtype=F64)
    m = mt.model(lambda v: -0.5 * ((v - mu) ** 2).sum(), gradient=True,
                 init=np.zeros(2), dtype=F64, device="cpu")
    s = mt.MALA(0.5) if sampler == "MALA" else mt.Barker(1.0)
    c = mt.run(m * s * mt.SerialMC(steps=400, burnin=100), seed=3)
    assert c.gradients.shape == c.samples.shape == (300, 2)
    x, g = c.samples.values, c.gradients.values
    np.testing.assert_allclose(g, -(x - mu.numpy()), rtol=1e-12)
    for fn in ("linear_zv", "quadratic_zv"):
        got_x, got_a = getattr(mt, fn)(c)
        want_x, want_a = getattr(jzv, fn)(x, g)
        np.testing.assert_allclose(got_a, want_a, rtol=RTOL, atol=1e-14)
        np.testing.assert_allclose(got_x, want_x, rtol=RTOL, atol=1e-14)
        assert np.all(got_x.var(0) <= x.var(0))


def test_zv_needs_gradients():
    m = mt.model(lambda v: -0.5 * (v * v).sum(), init=np.zeros(2),
                 dtype=F64, device="cpu")
    c = mt.run(m * mt.RWM(0.5) * mt.SerialMC(steps=50), seed=0)
    with pytest.raises(AssertionError, match="stored gradients"):
        mt.linear_zv(c)


def _ll_matrix(S=400, N=6, seed=1):
    """An (S, N) pointwise log-likelihood with one heavy-tailed column
    (its importance ratios 1/p(y|theta) have an infinite variance)."""
    rng = np.random.default_rng(seed)
    theta = 0.3 * rng.standard_normal(S)
    y = np.array([0.1, -0.4, 0.8, 0.0, 1.2])[:N - 1]
    ll = -0.5 * (y[None, :] - theta[:, None]) ** 2 - 0.5 * np.log(2 * np.pi)
    heavy = -0.5 * (3.0 * rng.standard_t(2.0, S)) ** 2
    return np.column_stack([ll, heavy])


def test_waic_matches_jax():
    ll = _ll_matrix()
    _same_dict(tic.waic(ll), jic.waic(ll))
    _same_dict(mt.waic(ll), jic.waic(ll))


def test_psis_loo_matches_jax_with_a_heavy_tail():
    ll = _ll_matrix()
    got, want = tic.psis_loo(ll), jic.psis_loo(ll)
    _same_dict(got, want)
    assert got["pareto_k"][-1] > 0.7, got["pareto_k"]
    assert np.all(got["pareto_k"][:-1] < 0.7), got["pareto_k"]


@pytest.mark.parametrize("S", [20, 24], ids=["raw_is", "smoothed"])
def test_psis_loo_few_draws_matches_jax(S):
    """Below 25 draws the tail is too short to fit (raw IS, k̂ = -inf);
    from 25 on it is smoothed."""
    ll = _ll_matrix(S=S, seed=4)
    got, want = tic.psis_loo(ll), jic.psis_loo(ll)
    np.testing.assert_array_equal(np.isneginf(got["pareto_k"]),
                                  np.isneginf(want["pareto_k"]))
    fin = np.isfinite(want["pareto_k"])
    np.testing.assert_allclose(got["pareto_k"][fin], want["pareto_k"][fin],
                               rtol=RTOL)
    for k in ("elpd_loo", "p_loo", "looic", "se", "pointwise"):
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, err_msg=k)


def test_compare_matches_jax():
    a, b = _ll_matrix(seed=1), _ll_matrix(seed=2) - 0.05
    tres = {"a": mt.psis_loo(a), "b": mt.waic(b), "c": mt.psis_loo(b)}
    jres = {"a": jic.psis_loo(a), "b": jic.waic(b), "c": jic.psis_loo(b)}
    got, want = mt.compare_elpd(tres), mc.compare_elpd(jres)
    assert [r[0] for r in got] == [r[0] for r in want]
    np.testing.assert_allclose(np.array([r[1:] for r in got]),
                               np.array([r[1:] for r in want]), rtol=RTOL,
                               atol=1e-12)


def test_pointwise_loglik_matches_jax():
    """The per-observation log-likelihood of a logistic regression over
    posterior-like draws: torch.func.vmap in the port, jit(vmap) in JAX."""
    rng = np.random.default_rng(5)
    X = np.column_stack([np.ones(30), rng.standard_normal((30, 2))])
    Y = (rng.random(30) < 0.4).astype(np.float64)
    draws = 0.5 * rng.standard_normal((200, 3))
    Xt, Yt = torch.tensor(X), torch.tensor(Y)

    def tpw(th):
        z = Xt @ th
        return Yt * z - torch.nn.functional.softplus(z)

    def jpw(th):
        z = jnp.asarray(X) @ th
        return jnp.asarray(Y) * z - jnp.logaddexp(0.0, z)

    got = mt.pointwise_loglik(tpw, draws, device="cpu")
    want = jic.pointwise_loglik(jpw, draws)
    assert got.shape == want.shape == (200, 30) and got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=RTOL)
    # a tensor of draws stays on its device and dtype
    got_t = mt.pointwise_loglik(tpw, torch.tensor(draws))
    np.testing.assert_array_equal(got_t, got)
    assert np.isfinite(mt.waic(got)["waic"])
    assert np.all(np.isfinite(mt.psis_loo(got)["pareto_k"]))


def _ladder(S=300, K=6, seed=2):
    rng = np.random.default_rng(seed)
    betas = np.linspace(0.0, 1.0, K) ** 3
    ll = -3.0 - 2.0 * betas[None, :] + rng.standard_normal((S, K)) \
        * (1.0 + betas[None, :])
    return ll, betas


@pytest.mark.parametrize("burnin", [0, 50])
def test_evidence_matches_jax(burnin):
    ll, betas = _ladder()
    for fn in ("logz_ti", "logz_ss"):
        got = getattr(mt, fn)(ll, betas, burnin=burnin)
        want = getattr(jev, fn)(ll, betas, burnin=burnin)
        np.testing.assert_allclose(got, want, rtol=RTOL, err_msg=fn)
    # a chain carrying the ladder's diagnostics reads them
    c = MCMCChain(range=range(1, 301), samples=Table(np.zeros((300, 1)),
                                                      ["x"]),
                  gradients=Table(np.zeros((0, 1)), ["x"]),
                  diagnostics={"replica_ll": ll, "betas": betas}, task=None)
    assert tev.logz_ti(c, burnin=burnin) == mt.logz_ti(ll, betas,
                                                       burnin=burnin)
    assert tev.logz_ss(c, burnin=burnin) == mt.logz_ss(ll, betas,
                                                       burnin=burnin)


def test_evidence_refusals_match_jax():
    """A chain without the ladder's diagnostics (a SerialMC chain) raises
    the reference's ValueError, and stepping-stone needs beta_0 = 0."""
    m = mt.model(lambda v: -0.5 * (v * v).sum(), init=np.zeros(1),
                 dtype=F64, device="cpu")
    c = mt.run(m * mt.RWM(0.5) * mt.SerialMC(steps=20), seed=0)
    for fn in ("logz_ti", "logz_ss"):
        with pytest.raises(ValueError, match="replica_ll"):
            getattr(mt, fn)(c)
    ll, betas = _ladder()
    with pytest.raises(ValueError, match="beta_0 = 0"):
        mt.logz_ss(ll, betas + 0.1)
    with pytest.raises(ValueError, match="beta_0 = 0"):
        jev.logz_ss(ll, betas + 0.1)


def test_top_level_surface_covers_jax():
    """Every name the JAX package exports (STILL_TO_PORT is empty) is
    exported by the port and present on it."""
    want = set(mc.__all__) - STILL_TO_PORT
    missing = sorted(want - set(mt.__all__))
    assert not missing, missing
    assert all(hasattr(mt, n) for n in mt.__all__)
    assert STILL_TO_PORT <= set(mc.__all__)
    assert not STILL_TO_PORT & set(mt.__all__)
    assert mt.MCMCLikModel is mt.LogDensityModel
    assert mt.distributions.Beta is mt.Beta
