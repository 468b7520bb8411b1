"""The port's exact-NUTS path as a whole against the JAX package's:
model(glm=...) * NUTS * SerialMC through run(task, chains=N) on the CPU,
where the warm route runs its kernels' plain versions and the JAX package
runs warmfused_nuts_exact_chains in interpret mode; routing; exact resume;
NUTS states carried over from the JAX package."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import mcmc_jl_tpu as mc
from mcmc_jl_tpu.parallel import run_chains as jax_run_chains
import mcmc_jl_tpu_torch as mt
from mcmc_jl_tpu_torch.core.task import MCMCTask
from mcmc_jl_tpu_torch.ops import glm_kernels as gk
from mcmc_jl_tpu_torch.ops import nuts_kernels as nk
from mcmc_jl_tpu_torch.ops import warmstart
from mcmc_jl_tpu_torch.parallel import pchains

torch.set_num_threads(1)

KEYS = {"accept", "epsilon", "ndoublings", "diverging", "logtarget", "step"}


def _data(n=80, d=3, seed=7):
    """tests/test_pallas_nuts.py's data."""
    rng = np.random.default_rng(seed)
    X = np.column_stack([np.ones(n), rng.standard_normal((n, d - 1))])
    beta = rng.standard_normal(d) * 0.7
    Y = (rng.random(n) < 1.0 / (1.0 + np.exp(-X @ beta))).astype(np.float64)
    return X, Y


def _pooled(chains):
    x = np.concatenate([c.samples.values for c in chains])
    return x.mean(0), x.std(0)


@pytest.mark.parametrize("mass_adapt", [False, "diag"])
def test_warm_route_matches_jax(mass_adapt):
    """Same info keys per chain, the same kept range; pooled means within
    5 standard errors (pooled-ESS floor 200), sd within 30%, frozen step
    within 25% of the JAX package's warm route."""
    X, Y = _data()
    runner = dict(steps=240, burnin=80)
    s = dict(maxdoublings=5, mass_adapt=mass_adapt)
    jm = mc.model(glm=("logistic", X, Y))
    tm = mt.model(glm=("logistic", X, Y), dtype=torch.float64, device="cpu")
    jc = mc.run(jm * mc.NUTS(**s) * mc.SerialMC(**runner), chains=8, seed=0,
                fused=True)
    nk.reset_counts()
    tc = mt.run(tm * mt.NUTS(**s) * mt.SerialMC(**runner), chains=8, seed=0,
                fused=True)
    assert nk.PLAIN_CALLS["glm_nuts_transition"] == 160  # steps - burnin
    assert not any(nk.LAUNCHES.values())
    assert len(tc) == 8
    assert set(tc[0].diagnostics) == set(jc[0].diagnostics) == KEYS
    assert tc[0].range == jc[0].range
    assert tc[0].samples.shape == jc[0].samples.shape == (160, 3)
    assert tc[0].samples.columns == jc[0].samples.columns
    mu, sd = _pooled(tc)
    mu_j, sd_j = _pooled(jc)
    z = np.abs(mu - mu_j) / (sd_j * np.sqrt(2.0 / 200.0))
    assert np.all(z < 5), z
    np.testing.assert_allclose(sd, sd_j, rtol=0.3)
    eps = tc[0].diagnostics["epsilon"]
    assert np.all(eps == eps[0])  # frozen over the sampling phase
    jeps = jc[0].diagnostics["epsilon"][0]
    assert abs(eps[0] / jeps - 1) < 0.25, (eps[0], jeps)
    nd = np.stack([c.diagnostics["ndoublings"] for c in tc])
    assert nd.min() >= 1 and nd.max() <= 5
    st = tc[0].task.state
    assert isinstance(st, mt.NUTSState) and st.pars.dtype == torch.float64
    assert st.i.item() == 241 and st.epsilon.item() == pytest.approx(eps[0])
    lp, g = tm.evalallg(st.pars)
    torch.testing.assert_close(st.logtarget, lp)
    torch.testing.assert_close(st.grad, g)
    np.testing.assert_allclose(tc[0].samples.values[-1], st.pars.numpy(),
                               rtol=1e-6)


def test_generic_route_and_resume():
    """fused=False runs the generic engine (no kernel, no plain version);
    resume of a chain from either route continues on the generic engine and
    repeats exactly from the same stored generator state."""
    X, Y = _data(seed=8)
    tm = mt.model(glm=("logistic", X, Y), dtype=torch.float64, device="cpu")
    task = tm * mt.NUTS(maxdoublings=4) * mt.SerialMC(steps=120, burnin=40)
    nk.reset_counts()
    cg = mt.run(task, chains=4, seed=1, fused=False)
    assert not any(nk.PLAIN_CALLS.values())
    assert set(cg[0].diagnostics) == KEYS
    cf = mt.run(task, chains=4, seed=1, fused=True)
    for c in (cg[1], cf[2]):
        r1, r2 = mt.resume(c, steps=30), mt.resume(c, steps=30)
        np.testing.assert_array_equal(r1.samples.values, r2.samples.values)
        assert r1.task.pos == 150 and r1.samples.shape == (30, 3)
        assert np.all(np.isfinite(r1.diagnostics["epsilon"]))
        assert not np.array_equal(mt.resume(r1, steps=30).samples.values,
                                  r1.samples.values)


def test_routing():
    """Routes are decided up front: "nuts" for an exact NUTS with a burn-in
    on a GLM the kernels take; "warm" for the warm handoff, as in the JAX
    package (pchains.py:283); the generic engine for no burn-in, a custom
    link, too deep a tree, or "auto" off the card; the dense metric folds
    into the NUTS kernels' matrix prior."""
    X, Y = _data()
    m = mt.model(glm=("logistic", X, Y), device="cpu")
    r = mt.SerialMC(steps=30, burnin=10)
    route = lambda s, rr=r, mm=m, f=True: pchains._route(  # noqa: E731
        MCMCTask(mm, s, rr), f)
    assert route(mt.NUTS()) == "nuts"
    assert route(mt.NUTS(mass_adapt="diag-win", multinomial=True)) == "nuts"
    assert route(mt.HMC(3, 0.1)) == "hmc"
    assert not route(mt.NUTS(), f="auto")  # CPU model
    assert not route(mt.NUTS(), f=False)
    assert route(mt.NUTS(warm_handoff=True)) == "warm"
    assert not route(mt.NUTS(), rr=mt.SerialMC(steps=30))
    assert not route(mt.NUTS(maxdoublings=nk.MAX_DOUBLINGS + 1))
    custom = (lambda z, y: z * y - torch.logaddexp(z, torch.zeros_like(z)),
              lambda z, y: y - torch.sigmoid(z))
    assert not route(mt.NUTS(), mm=mt.model(glm=(custom, X, Y),
                                            device="cpu"))
    gen = mt.model(lambda v: -(v * v).sum(), gradient=True, init=np.zeros(2),
                   device="cpu")
    assert not route(mt.NUTS(), mm=gen)
    assert warmstart._pick_k_trans(1000) == 8
    assert warmstart._pick_k_trans(997) == 1
    assert warmstart._nuts_hw_route(m, 1000) == (False, 1)  # CPU model
    # the dense metric folds into the NUTS kernels' matrix prior
    assert route(mt.NUTS(mass_adapt="dense")) == "nuts"
    # the warm handoff samples through the Halton multistep kernel (3b's
    # plain version here), never the NUTS kernels
    nk.reset_counts()
    gk.reset_counts()
    cs = mt.run(m * mt.NUTS(maxdoublings=3, warm_handoff=True)
                * mt.SerialMC(steps=20, burnin=5), chains=2, fused=True)
    assert not any(nk.PLAIN_CALLS.values()) and len(cs) == 2
    assert gk.PLAIN_CALLS["glm_multistep_rows"] == 3  # 15 = 3 launches of 5
    assert "nleaps" in cs[0].diagnostics


def _as_dict(state):
    return {f.name: (_as_dict(getattr(state, f.name))
                     if dataclasses.is_dataclass(getattr(state, f.name))
                     else np.asarray(getattr(state, f.name)))
            for f in dataclasses.fields(state)}


def test_jax_nuts_state_carries_over():
    """A JAX NUTSState converts to the port's, matches the port's model at
    its positions, and continues on the generic engine in the same law as
    the JAX package continues it (pooled means within 5 standard errors)."""
    X, Y = _data(seed=9)
    jm = mc.model(glm=("logistic", X, Y))
    js = mc.NUTS(maxdoublings=5, mass_adapt="diag")
    _, jstates, _ = jax_run_chains(jm, js, mc.SerialMC(steps=100, burnin=80),
                                   8, seed=2)
    spec = jm.glm_spec
    tm = mt.glm_model_from_spec(spec.kind, spec.X, spec.Y, spec.weights,
                                spec.offsets, spec.prior_prec,
                                dtype=torch.float64, device="cpu")
    st = mt.nuts_state_from_numpy(_as_dict(jax.device_get(jstates)),
                                  device="cpu")
    assert isinstance(st, mt.NUTSState) and st.pars.shape == (8, 3)
    assert st.i.dtype == torch.int32 and st.mass.count.dtype == torch.int32
    lp, g = tm.evalallg(st.pars)
    np.testing.assert_allclose(lp.numpy(), np.asarray(jstates.logtarget),
                               rtol=1e-10)
    np.testing.assert_allclose(g.numpy(), np.asarray(jstates.grad),
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_array_equal(st.epsilon.numpy(),
                                  np.asarray(jstates.epsilon))
    runner = dict(steps=200)
    infos, final, _ = pchains.run_chains(
        tm, mt.NUTS(maxdoublings=5, mass_adapt="diag"),
        mt.SerialMC(**runner), 8, states=st)
    jinfos, _, _ = jax_run_chains(jm, js, mc.SerialMC(**runner), 8,
                                  states=jstates, seed=3)
    assert torch.all(final.i == st.i + 200)
    x = infos["ppars"].numpy().reshape(-1, 3)
    xj = np.asarray(jinfos["ppars"]).reshape(-1, 3)
    z = np.abs(x.mean(0) - xj.mean(0)) / (xj.std(0) * np.sqrt(2.0 / 200.0))
    assert np.all(z < 5), z
