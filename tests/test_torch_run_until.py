"""The port's convergence-gated runner (runners/convergence.py) against the
JAX package's, on the CPU in float64.

- tests/test_convergence.py's gates on its configurations, in both
  packages: convergence on a Gaussian, ``max_steps``, resume-ready states.
- With ``fused=True`` the frozen blocks after the warmup route through
  ``make_fused_continuation`` (built once; checked with a spy, as the JAX
  test does): adaptive HMC on the "warm" route (kernel 3b's plain version
  here), exact NUTS on the "nuts" route (kernel 9 or 8's); with
  ``fused=False`` every block stays on the generic engine.
- ``init_chains``'s ``jitter``.
- A JAX run's ``ConvergenceResult.states`` carried over by
  ``utils.convert``: the port freezes the same hyper-parameters from
  them (the first move of a frozen block) and continues them."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mcmc_jl_tpu as mc
from mcmc_jl_tpu.ops import warmstart as jws
import mcmc_jl_tpu_torch as mt
from mcmc_jl_tpu_torch.ops import warmstart as tws
from mcmc_jl_tpu_torch.parallel import pchains
from mcmc_jl_tpu_torch.samplers.base import make_generator

from test_torch_ensemble import as_dict

torch.set_num_threads(1)
F64 = torch.float64


def _gauss_pair(d=3, sigma=2.0):
    """tests/test_convergence.py's Gaussian in both packages."""
    return (mc.model(lambda v: -0.5 * jnp.sum((v / sigma) ** 2),
                     gradient=True, init=jnp.zeros(d), check_init=False),
            mt.model(lambda v: -0.5 * ((v / sigma) ** 2).sum(),
                     gradient=True, init=np.zeros(d), check_init=False,
                     dtype=F64, device="cpu"))


def _glm_pair():
    """tests/test_convergence.py's logistic GLM (N 80, d 3)."""
    rng = np.random.default_rng(7)
    X = np.column_stack([np.ones(80), rng.standard_normal((80, 2))])
    Y = (rng.random(80) < 1.0 / (1.0 + np.exp(-X @ [0.3, 1.0, -0.5]))
         ).astype(float)
    return (mc.model(glm=("logistic", X, Y)),
            mt.model(glm=("logistic", X, Y), dtype=F64, device="cpu"))


def test_run_until_converges_on_gaussian():
    """tests/test_convergence.py's first gate, in both packages."""
    for p, m in zip((mt, mc), reversed(_gauss_pair())):
        res = p.run_until(m, p.HMC(6, 0.8), n_chains=8, rhat_target=1.02,
                          min_ess=300, check_every=250, max_steps=4000,
                          seed=0)
        assert res.converged, (p.__name__, res.history)
        assert res.max_rhat <= 1.02 and res.min_ess >= 300
        assert res.samples.ndim == 3 and res.samples.shape[1] == 8
        pooled = res.samples.reshape(-1, 3)
        se = 2.0 / np.sqrt(res.min_ess)
        assert np.all(np.abs(pooled.mean(0)) < 5 * se)
        assert np.all(np.abs(pooled.std(0) - 2.0) < 0.35)
        steps = [h[0] for h in res.history]
        assert steps == sorted(steps) and steps[-1] == res.steps_run


def test_run_until_respects_max_steps_and_resumes():
    """The max_steps stop, and the final states and generator state
    continuing through ``run_chains`` from the stored positions."""
    _, m = _gauss_pair()
    res = mt.run_until(m, mt.HMC(4, 0.8), n_chains=4, rhat_target=1.0001,
                       min_ess=10 ** 7, check_every=200, max_steps=600,
                       seed=1)
    assert not res.converged and res.steps_run == 600
    assert len(res.history) >= 1
    assert res.samples.shape == (300, 4, 3)
    infos, states, _ = pchains.run_chains(
        m, mt.HMC(4, 0.8), mt.SerialMC(steps=50), 4,
        generator=make_generator("cpu", state=res.key), states=res.states)
    assert infos["ppars"].shape == (50, 4, 3)
    assert torch.all(torch.isfinite(infos["plogtarget"]))
    assert torch.all(states.i == 651)


def test_init_chains_jitter():
    """``jitter`` spreads the start around ``model.init`` by that many
    standard normals from the generator; none keeps it exactly."""
    _, m = _gauss_pair()
    s = mt.HMC(4, 0.8)
    st = pchains.init_chains(m, s, 4000, make_generator("cpu", 0),
                             jitter=0.1)
    sd = st.pars.std(0)
    assert torch.all((sd > 0.09) & (sd < 0.11)), sd
    assert torch.all(st.pars.mean(0).abs() < 0.01)
    close0 = pchains.init_chains(m, s, 5, make_generator("cpu", 0))
    assert torch.all(close0.pars == 0)
    again = pchains.init_chains(m, s, 4000, make_generator("cpu", 0),
                                jitter=0.1)
    assert torch.equal(again.pars, st.pars)


def _spy(monkeypatch):
    calls, built = [], []
    orig = tws.make_fused_continuation

    def spy(*a, **kw):
        built.append(1)
        fn = orig(*a, **kw)

        def counted(*fa, **fkw):
            calls.append(1)
            return fn(*fa, **fkw)

        return counted

    monkeypatch.setattr(tws, "make_fused_continuation", spy)
    return calls, built


ROUTES = {
    "warm": (lambda p: p.HMC(5, 0.05, p.EmpMCTuner(0.8, adapt_step=50)),
             dict(check_every=200, max_steps=2000)),
    "nuts": (lambda p: p.NUTS(maxdoublings=4),
             dict(check_every=100, warmup=100, max_steps=600)),
}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_run_until_fused_continuation_blocks(route, monkeypatch):
    """tests/test_convergence.py's fused test: past the warmup every block
    routes through one ``make_fused_continuation`` and the gates still
    pass; with ``fused=False`` none does, and the two runs agree."""
    jm, tm = _glm_pair()
    make, kw = ROUTES[route]
    s = make(mt)
    assert pchains.continuation_route(tm, s, 4, True) == route
    calls, built = _spy(monkeypatch)
    res = mt.run_until(tm, s, n_chains=4, rhat_target=1.1, min_ess=50,
                       seed=0, fused=True, **kw)
    assert calls and built == [1], "fused continuation blocks not routed"
    assert len(calls) == res.steps_run // kw["check_every"] - 1
    assert res.converged, res.history
    assert np.all(np.isfinite(res.samples))
    calls.clear()
    built.clear()
    res_g = mt.run_until(tm, s, n_chains=4, rhat_target=1.1, min_ess=50,
                         seed=0, fused=False, **kw)
    assert not calls and not built
    assert res_g.converged
    assert abs(res.samples.mean() - res_g.samples.mean()) < 0.2
    jres = mc.run_until(jm, make(mc), n_chains=4, rhat_target=1.1,
                        min_ess=50, seed=0, fused=False, **kw)
    assert jres.converged
    assert abs(res.samples.mean() - jres.samples.mean()) < 0.2


def test_jax_run_until_states_continue_in_the_port():
    """A JAX ``run_until``'s final adaptive-HMC states, carried over by
    ``hmc_state_from_numpy``: the port's frozen continuation freezes the
    JAX package's step and leap count from them at 1e-12, and continues
    them through it (and through the generic engine) at the JAX run's
    moments."""
    jm, tm = _glm_pair()
    js = mc.HMC(5, 0.05, mc.EmpMCTuner(0.8, adapt_step=50))
    ts = mt.HMC(5, 0.05, mt.EmpMCTuner(0.8, adapt_step=50))
    jres = mc.run_until(jm, js, n_chains=8, rhat_target=1.1, min_ess=50,
                        check_every=200, max_steps=600, seed=3, fused=False)
    states = mt.hmc_state_from_numpy(as_dict(jax.device_get(jres.states)),
                                     device="cpu")
    assert states.pars.shape == (8, 3)
    want = jws._freeze(js, jres.states)
    got = tws._freeze(ts, states)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-12)
    assert got[1] == want[1]
    cont = tws.make_fused_continuation(tm, ts, states)
    infos, new = cont(states, 400, make_generator("cpu", 1))
    assert infos["ppars"].shape == (400, 8, 3)
    assert torch.all(new.i == states.i + 400)
    x = infos["ppars"].numpy().reshape(-1, 3)
    ref = jres.samples.reshape(-1, 3)
    assert np.all(np.abs(x.mean(0) - ref.mean(0)) < 0.15)
    ginfos, _, _ = pchains.run_chains(tm, ts, mt.SerialMC(steps=50), 8,
                                      generator=make_generator("cpu", 2),
                                      states=states)
    assert torch.all(torch.isfinite(ginfos["plogtarget"]))
