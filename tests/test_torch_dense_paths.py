"""The port's dense metric (``mass_adapt="dense"``) end to end on the CPU:
HMC, HMCDA and NUTS on the generic engine against the gates of
tests/test_mass_adapt.py (a rho = 0.95 Gaussian of mixed scales), the warm
pipeline on GLMs (the pooled factor folded into the design and the matrix
prior of kernels 3b, 4 and 8, whose plain versions run here) against the
generic engine and the JAX package's warm route, the fused continuation of
such runs, and the routes of a dense catalog target (the z-space target on
kernels 5 and 8b, tests/test_torch_dense_target.py)."""
import logging

import numpy as np
import pytest
import torch

import mcmc_jl_tpu as mc
import mcmc_jl_tpu_torch as mt
from mcmc_jl_tpu_torch.core.task import MCMCTask
from mcmc_jl_tpu_torch.ops import glm_bign
from mcmc_jl_tpu_torch.ops import glm_kernels as gk
from mcmc_jl_tpu_torch.ops import nuts_kernels as nk
from mcmc_jl_tpu_torch.ops import target_kernels as tk
from mcmc_jl_tpu_torch.ops import warmstart as tws
from mcmc_jl_tpu_torch.parallel import pchains
from mcmc_jl_tpu_torch.samplers.base import tree_map

torch.set_num_threads(1)
F64 = torch.float64
MODS = (gk, glm_bign, nk, tk)

CORR = 0.95
SCALES = np.array([3.0, 1.0, 0.5, 2.0])


def _corr_model():
    """tests/test_mass_adapt.py's correlated Gaussian, float64, with its
    analytic gradient (half the time of torch.func's on the CPU)."""
    d = len(SCALES)
    sig = (np.full((d, d), CORR) + (1 - CORR) * np.eye(d)) \
        * np.outer(SCALES, SCALES)
    prec = torch.as_tensor(np.linalg.inv(sig))
    return sig, mt.model(lambda v: -0.5 * (v @ prec @ v),
                         grad=lambda v: -(prec @ v), init=np.zeros(d),
                         check_init=False, dtype=F64, device="cpu")


def _corr_data(n=120, seed=5):
    """tests/test_warmfused.py's correlated design."""
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((n, 2))
    X = np.column_stack([np.ones(n), z[:, 0], 0.95 * z[:, 0] + 0.3 * z[:, 1],
                         rng.standard_normal(n)])
    beta = np.array([0.3, 1.0, -0.8, 0.5])
    Y = (rng.random(n) < 1.0 / (1.0 + np.exp(-X @ beta))).astype(np.float64)
    return X, Y


def _plain_calls():
    return {k: v for mod in MODS for k, v in mod.PLAIN_CALLS.items() if v}


def _reset():
    for mod in MODS:
        mod.reset_counts()


def _pooled(chains):
    return np.concatenate([c.samples.values for c in chains])


def _min_ess(chains):
    """Worst coordinate of the chains' summed ESS."""
    return float(np.min(np.sum([mt.ess(c) for c in chains], axis=0)))


def _z(a, b):
    """max |mean difference| / se of two sets of per-chain means."""
    se = np.sqrt(a.var(0, ddof=1) / len(a) + b.var(0, ddof=1) / len(b))
    return float(np.max(np.abs(a.mean(0) - b.mean(0)) / se))


def _chain_means(chains):
    return np.stack([c.samples.values.mean(0) for c in chains])


# ---- the generic engine ------------------------------------------------------

GENERIC = {
    # sampler maker, its diagonal rival, steps, burn-in, ESS gain, cov relerr
    "hmc": (lambda ma: mt.HMC(10, 0.25, mass_adapt=ma), True, 1500, 600, 5.0,
            0.15),
    "hmcda": (lambda ma: mt.HMCDA(len=2.0, mass_adapt=ma), "diag-win", 1500,
              600, 3.0, 0.2),
    "nuts": (lambda ma: mt.NUTS(mass_adapt=ma), "diag-win", 800, 400, 3.0,
             0.2),
}


@pytest.mark.parametrize("name", list(GENERIC))
def test_dense_metric_beats_diag_on_correlated_target(name):
    """The gates of tests/test_mass_adapt.py on the port's generic engine,
    4 chains each (a quarter to a half of the JAX test's transitions a
    chain, as many or more in all): the dense run's pooled covariance
    within the relative
    error of the JAX test (0.15 for HMC, 0.2 for HMCDA and NUTS), its
    worst-coordinate ESS (summed over the chains) more than 5x (HMC) or 3x
    the diagonal metric's, HMC's acceptance above 80%, and the adapted
    factors reconstructing the target covariance (L L' ~ Sigma)."""
    make, rival, steps, burnin, gain, relerr = GENERIC[name]
    sig, m = _corr_model()
    r = mt.SerialMC(steps=steps, burnin=burnin)
    c_diag = mt.run(m * make(rival) * r, chains=4, seed=0)
    c_dense = mt.run(m * make("dense") * r, chains=4, seed=0)
    x = _pooled(c_dense)
    err = np.abs(np.cov(x.T) - sig).max() / sig.max()
    assert err < relerr, err
    assert _min_ess(c_dense) > gain * _min_ess(c_diag), (
        _min_ess(c_diag), _min_ess(c_dense))
    if name == "hmc":
        assert min(mt.acceptance(c) for c in c_dense) > 80
    for c in c_dense:
        L = c.task.state.mass.scale.numpy()
        assert L.shape == (4, 4) and np.allclose(L, np.tril(L))
        np.testing.assert_allclose(L @ L.T, sig, rtol=0.5,
                                   atol=0.3 * sig.max())
    # the metric is frozen after burn-in: a resume keeps it bit for bit
    c1 = mt.resume(c_dense[0], steps=20)
    np.testing.assert_array_equal(c1.task.state.mass.scale.numpy(),
                                  c_dense[0].task.state.mass.scale.numpy())


def test_dense_hmc_store_leaps_maps_trajectories_back():
    """store_leaps under the dense metric records the trajectory in theta:
    its last live row is the proposal (accepted or not), its first the
    state the transition started from."""
    _, m = _corr_model()
    c = mt.run(m * mt.HMC(5, 0.2, store_leaps=True, mass_adapt="dense")
               * mt.SerialMC(steps=400, burnin=300), seed=1)
    lp = c.diagnostics["leaps_pars"]
    assert lp.shape == (100, 6, 4)
    acc = np.asarray(c.diagnostics["accept"], bool)
    np.testing.assert_allclose(lp[acc, -1], c.samples.values[acc],
                               rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(lp[1:, 0], c.samples.values[:-1], rtol=1e-12)


# ---- the warm pipeline on GLMs -------------------------------------------------


def _held(m, cf, X):
    """lp is the model's log-density and the gradient its gradient at the
    last kept draws (the fold is a reparametrization, not another target);
    the tolerances of tests/test_warmfused.py."""
    c0 = cf[0]
    rows = torch.as_tensor(c0.samples.values[-5:])
    lp, g = m.evalallg(rows)
    np.testing.assert_allclose(c0.diagnostics["logtarget"][-5:], lp.numpy(),
                               rtol=1e-4, atol=5e-3)
    np.testing.assert_allclose(c0.gradients.values[-5:], g.numpy(),
                               rtol=2e-3, atol=2e-2)


WARM = {
    # sampler, kernel whose plain version the sampling phase runs, its
    # calls there, steps, burn-in, N, lowered BIGN_THRESHOLD
    "hmc": (lambda: mt.HMC(6, 0.1, mass_adapt="dense"), "glm_multistep_rows",
            600 // 8, 1000, 400, 120, None),
    "hmc_bign": (lambda: mt.HMC(6, 0.1, mass_adapt="dense"),
                 "glm_logp_grad_tiled", None, 900, 400, 150, 100),
    "hmcda": (lambda: mt.HMCDA(len=1.0, mass_adapt="dense"),
              "glm_multistep_rows", 600 // 8, 1000, 400, 120, None),
    "nuts": (lambda: mt.NUTS(maxdoublings=6, mass_adapt="dense"),
             "glm_nuts_transition", 600, 1000, 400, 120, None),
}


@pytest.mark.parametrize("name", list(WARM))
def test_warmfused_dense_matches_generic(name, monkeypatch):
    """Ports of tests/test_warmfused.py's dense cases
    (test_warmfused_dense_mass_matches_generic, _dense_bign_route, and the
    dense NUTS case on a GLM): run(task, chains=8, fused=True) takes the
    warm or NUTS route, its sampling phase runs the kernel's plain version
    with the (d, d) prior on the folded design (the tiled evaluation above
    the threshold, lowered here), and agrees with the generic engine
    (per-chain means within 5 standard errors); lp and gradients un-fold to
    the model's; the final states keep each chain's dense accumulator and
    resume through the fused continuation on the same kernel, bit for bit
    twice."""
    make, kernel, calls, steps, burnin, n, thresh = WARM[name]
    if thresh is not None:
        monkeypatch.setattr(glm_bign, "BIGN_THRESHOLD", thresh)
    X, Y = _corr_data(n=n)
    m = mt.model(glm=("logistic", X, Y), dtype=F64, device="cpu")
    task = m * make() * mt.SerialMC(steps=steps, burnin=burnin)
    route = "nuts" if name == "nuts" else "warm"
    assert pchains._route(MCMCTask(m, task.sampler, task.runner),
                          True) == route
    _reset()
    cf = mt.run(task, chains=8, seed=0, fused=True)
    plain = _plain_calls()
    assert set(plain) == {kernel}, plain
    if calls is not None:
        assert plain[kernel] == calls
    cg = mt.run(task, chains=8, seed=1, fused=False)
    assert _z(_chain_means(cf), _chain_means(cg)) < 5
    assert mt.acceptance(cf[0]) > 40
    _held(m, cf, X)
    st = cf[0].task.state
    assert st.mass.scale.shape == (4, 4) and st.i.item() == steps + 1
    # each chain keeps its own factor: the continuation pools them again
    assert not torch.equal(st.mass.scale, cf[1].task.state.mass.scale)
    assert pchains.continuation_route(m, task.sampler, 8, True) == route
    _reset()
    r1 = mt.resume(cf, steps=40, fused=True)
    assert set(_plain_calls()) == {kernel}
    r2 = mt.resume(cf, steps=40, fused=True)
    np.testing.assert_array_equal(_pooled(r1), _pooled(r2))
    assert np.all(np.isfinite(_pooled(r1)))
    assert r1[0].task.pos == steps + 40
    torch.testing.assert_close(r1[0].task.state.mass.scale, st.mass.scale,
                               rtol=0, atol=0)


def test_dense_warm_route_matches_jax():
    """The slice as a whole: the port's warm route and the JAX package's
    (its CPU route) on dense HMC on the correlated GLM, 8 chains each:
    per-chain means within 5 standard errors, the diagonals of the chains'
    mean adapted covariance L L' within 50% of each other (each is the
    mean of 8 windowed estimates)."""
    X, Y = _corr_data()
    runner = dict(steps=700, burnin=300)
    jc = mc.run(mc.model(glm=("logistic", X, Y))
                * mc.HMC(6, 0.1, mass_adapt="dense") * mc.SerialMC(**runner),
                chains=8, seed=0, fused=True)
    tc = mt.run(mt.model(glm=("logistic", X, Y), dtype=F64, device="cpu")
                * mt.HMC(6, 0.1, mass_adapt="dense") * mt.SerialMC(**runner),
                chains=8, seed=0, fused=True)
    assert set(tc[0].diagnostics) == set(jc[0].diagnostics)
    assert tc[0].samples.shape == jc[0].samples.shape == (400, 4)
    assert _z(_chain_means(tc), _chain_means(jc)) < 5
    sig = np.mean([c.task.state.mass.scale.numpy()
                   @ c.task.state.mass.scale.numpy().T for c in tc], 0)
    jsig = np.mean([np.asarray(c.task.state.mass.scale)
                    @ np.asarray(c.task.state.mass.scale).T for c in jc], 0)
    np.testing.assert_allclose(np.diag(sig), np.diag(jsig), rtol=0.5)


# ---- the dense metric on catalog targets --------------------------------------


def test_dense_catalog_target_takes_the_kernels(caplog):
    """A dense metric on a catalog target runs the z-space target (``z ->
    target(z L')``) on kernels 5 and 8b: warm_eligible admits HMC, HMCDA
    and NUTS with mass_adapt="dense", _route sends them to the warm and
    NUTS routes and continuation_route continues them there, and no
    refusal is logged; run(fused=True) runs the dense kernels' plain
    versions and keeps each chain's dense accumulator; the continuation
    takes any stored factor (a scaled one here).  The diagonal metric on
    the same model still takes the warm route, and a dense catalog target
    above D_MAX takes the generic engine with its reason."""
    def ex(a, b):
        mt.tilde(a, mt.Gamma(3.0, 0.2))
        mt.tilde(b, mt.Normal(1.0, 2.0))

    m = mt.model(ex, gradient=True, device="cpu", a=np.full(2, 0.6),
                 b=np.array([1.0]))
    assert m.target_spec is not None
    r = mt.SerialMC(steps=60, burnin=30)
    cases = ((mt.HMC(5, 0.05, mass_adapt="dense"), "warm",
              "target_leapfrogs_dense"),
             (mt.HMCDA(mass_adapt="dense"), "warm", "target_leapfrogs_dense"),
             (mt.NUTS(4, mass_adapt="dense"), "nuts",
              "target_nuts_transition_dense"))
    for s, route, kernel in cases:
        caplog.clear()
        with caplog.at_level(logging.INFO):
            assert tws.warm_eligible(MCMCTask(m, s, r))
            assert pchains._route(MCMCTask(m, s, r), True) == route
            assert pchains.continuation_route(m, s, 4, True) == route
        assert "z-space wrapper" not in caplog.text, caplog.text
        assert "generic" not in caplog.text, caplog.text
        assert tws._continue_refusal(MCMCTask(m, s, None)) is None
        _reset()
        cs = mt.run(m * s * r, chains=2, seed=0, fused=True)
        assert _plain_calls() == {kernel: 30} and len(cs) == 2
        assert cs[0].task.state.mass.scale.shape == (3, 3)
        states = tree_map(lambda *xs: torch.stack(xs),
                          *[c.task.state for c in cs])
        states = states.replace(mass=states.mass.replace(
            scale=2.0 * states.mass.scale))
        _reset()
        infos, out = tws.make_fused_continuation(m, s, states)(
            states, 5, torch.Generator().manual_seed(1))
        assert _plain_calls() == {kernel: 5}
        assert torch.isfinite(infos["ppars"]).all()
        assert torch.equal(out.i, states.i + 5)
    assert pchains._route(MCMCTask(m, mt.HMC(5, 0.05, mass_adapt="diag"), r),
                          True) == "warm"

    def ex_big(x):
        mt.tilde(x, mt.Normal(0.0, 1.0))

    big = mt.model(ex_big, gradient=True, device="cpu",
                   x=np.zeros(tk.D_MAX + 1))
    assert big.target_spec is not None
    for s, _, _ in cases:
        caplog.clear()
        with caplog.at_level(logging.INFO):
            assert not tws.warm_eligible(MCMCTask(big, s, r))
            assert pchains._route(MCMCTask(big, s, r), True) is False
            assert pchains.continuation_route(big, s, 4, True) is False
        assert caplog.text.count(f"d = {tk.D_MAX + 1} > {tk.D_MAX}") == 3, \
            caplog.text
