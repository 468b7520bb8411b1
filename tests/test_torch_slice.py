"""The port's main path as a whole against the JAX package's: model(glm=...)
* HMC * SerialMC through run(task, chains=N), fused and generic, on the CPU
(where the fused route runs the kernels' plain versions); routing; state
carried over from the JAX package; exact resume."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import mcmc_jl_tpu as mc
import mcmc_jl_tpu_torch as mt
from mcmc_jl_tpu.parallel import run_chains as jax_run_chains
from mcmc_jl_tpu_torch.core.task import MCMCTask
from mcmc_jl_tpu_torch.ops import glm_bign
from mcmc_jl_tpu_torch.ops.glm_hmc import run_glm_hmc, run_glm_hmc_multistep
from mcmc_jl_tpu_torch.parallel import pchains

torch.set_num_threads(1)


def _data(n=90, d=4, seed=3):
    """tests/test_glm_routing.py's data."""
    rng = np.random.default_rng(seed)
    X = np.column_stack([np.ones(n), rng.standard_normal((n, d - 1))])
    beta = rng.standard_normal(d) * 0.7
    Y = (rng.random(n) < 1.0 / (1.0 + np.exp(-X @ beta))).astype(np.float64)
    return X, Y


def _pooled_mean(chains):
    return np.mean([c.samples.values.mean(0) for c in chains], axis=0)


@pytest.fixture(scope="module")
def runs():
    X, Y = _data()
    runner_kw = dict(steps=800, burnin=200)
    jm = mc.model(glm=("logistic", X, Y))
    jtask = jm * mc.HMC(5, 0.1) * mc.SerialMC(**runner_kw)
    tm = mt.model(glm=("logistic", X, Y), dtype=torch.float64, device="cpu")
    ttask = tm * mt.HMC(5, 0.1) * mt.SerialMC(**runner_kw)
    return {
        "jax": mc.run(jtask, chains=8, seed=0, fused=True),
        "port_fused": mt.run(ttask, chains=8, seed=0, fused=True),
        "port_generic": mt.run(ttask, chains=8, seed=1, fused=False),
        "model": tm,
    }


@pytest.mark.parametrize("other", ["port_fused", "port_generic"])
def test_slice_matches_jax(runs, other):
    """(f) pooled means within 6 se + 0.05 of the JAX package's fused run
    (the gate of tests/test_glm_routing.py); same kept range and keys."""
    jc, tc = runs["jax"], runs[other]
    assert len(tc) == len(jc) == 8
    se = np.sqrt(np.mean([mc.var(c) for c in jc], axis=0) / 8)
    mu_j, mu_t = _pooled_mean(jc), _pooled_mean(tc)
    assert np.all(np.abs(mu_t - mu_j) < 6 * se + 0.05), (mu_t, mu_j, se)
    assert tc[0].range == jc[0].range
    assert tc[0].samples.shape == jc[0].samples.shape
    assert tc[0].gradients.shape == jc[0].gradients.shape
    assert set(tc[0].diagnostics) == set(jc[0].diagnostics)
    assert tc[0].samples.columns == jc[0].samples.columns
    assert abs(np.mean([mt.acceptance(c) for c in tc])
               - np.mean([mc.acceptance(c) for c in jc])) < 10


def test_port_fused_matches_port_generic(runs):
    """(f) the fused driver and the generic engine agree."""
    fc, gc = runs["port_fused"], runs["port_generic"]
    se = np.sqrt(np.mean([mt.var(c) for c in gc], axis=0) / 8)
    assert np.all(np.abs(_pooled_mean(fc) - _pooled_mean(gc)) < 6 * se + 0.05)


def test_fused_final_state_resumes(runs):
    """Fused final states are float64 HMCStates whose cached lp/grad equal
    the model's at the position; resume continues through the generic path,
    and repeating a resume from the same chain repeats it exactly."""
    c0, m = runs["port_fused"][0], runs["model"]
    st = c0.task.state
    assert isinstance(st, mt.HMCState) and st.pars.dtype == torch.float64
    lp, g = m.evalallg(st.pars)
    torch.testing.assert_close(st.logtarget, lp)
    torch.testing.assert_close(st.grad, g)
    np.testing.assert_allclose(c0.diagnostics["logtarget"][-1],
                               m.eval(st.pars).item(), rtol=1e-4)
    c1 = mt.resume(c0, steps=60)
    c2 = mt.resume(c0, steps=60)
    assert c1.samples.shape == (60, 4) and c1.task.pos == 860
    np.testing.assert_array_equal(c1.samples.values, c2.samples.values)
    c3 = mt.resume(c1, steps=30)
    assert not np.array_equal(c3.samples.values[:30], c1.samples.values[:30])


def test_serial_resume_is_exact():
    """run(200) then resume(100) equals itself when repeated, and the
    generator state travels on the task."""
    X, Y = _data(seed=5)
    m = mt.model(glm=("logistic", X, Y), dtype=torch.float64, device="cpu")
    task = m * mt.HMC(3, 0.15) * mt.SerialMC(steps=200, burnin=50)
    a = mt.run(task, seed=4)
    b = mt.run(task, seed=4)
    np.testing.assert_array_equal(a.samples.values, b.samples.values)
    ra, rb = mt.resume(a, steps=100), mt.resume(b, steps=100)
    np.testing.assert_array_equal(ra.samples.values, rb.samples.values)
    assert isinstance(a.task.key, torch.Tensor)


def _as_dict(state):
    return {f.name: (_as_dict(getattr(state, f.name))
                     if dataclasses.is_dataclass(getattr(state, f.name))
                     else np.asarray(getattr(state, f.name)))
            for f in dataclasses.fields(state)}


def test_jax_state_carries_over():
    """(g) a JAX run_chains final state converts to the port's HMCState,
    matches the port's model at its positions, and runs on."""
    X, Y = _data(seed=6)
    jm = mc.model(glm=("logistic", X, Y))
    s = mc.HMC(4, 0.1)
    _, jstates, _ = jax_run_chains(jm, s, mc.SerialMC(steps=30), 4, seed=2)
    spec = jm.glm_spec
    tm = mt.glm_model_from_spec(spec.kind, spec.X, spec.Y, spec.weights,
                                spec.offsets, spec.prior_prec,
                                dtype=torch.float64, device="cpu")
    st = mt.hmc_state_from_numpy(_as_dict(jax.device_get(jstates)),
                                 device="cpu")
    assert st.pars.shape == (4, 4) and st.i.dtype == torch.int32
    lp, g = tm.evalallg(st.pars)
    np.testing.assert_allclose(lp.numpy(), np.asarray(jstates.logtarget),
                               rtol=1e-10)
    np.testing.assert_allclose(g.numpy(), np.asarray(jstates.grad),
                               rtol=1e-10, atol=1e-12)
    ts = mt.HMC(4, 0.1)
    infos, final, _ = pchains.run_chains(tm, ts, mt.SerialMC(steps=20), 4,
                                         states=st)
    assert infos["ppars"].shape == (20, 4, 4)
    assert torch.all(final.i == st.i + 20)
    one = MCMCTask(tm, ts, mt.SerialMC(steps=10),
                   state=pchains.tree_map(lambda a: a[1], st))
    c = mt.resume(one, steps=25)
    assert np.all(np.isfinite(c.samples.values))


def test_routing():
    """Up-front routing: fused=False never, "auto" only for float32 CUDA
    models, True for what the kernels take; custom links go to the generic
    engine, N above the threshold to the N-tiled kernel's driver."""
    X, Y = _data()
    m = mt.model(glm=("logistic", X, Y), device="cpu")
    r = mt.SerialMC(steps=20)
    t = MCMCTask(m, mt.HMC(3, 0.1), r)
    assert pchains._fused_eligible(t)
    assert pchains._route(t, True)
    assert not pchains._route(t, "auto")  # CPU model
    assert not pchains._route(t, False)
    for s in (mt.HMC(3, 0.1, mt.EmpMCTuner(0.8)), mt.HMC(3, 0.1, True)):
        assert not pchains._fused_eligible(MCMCTask(m, s, r))
    custom = (lambda z, y: z * y - torch.logaddexp(z, torch.zeros_like(z)),
              lambda z, y: y - torch.sigmoid(z))
    mc_ = mt.model(glm=(custom, X, Y), device="cpu")
    assert not pchains._route(MCMCTask(mc_, mt.HMC(3, 0.1), r), True)
    n = glm_bign.BIGN_THRESHOLD + 1
    big = mt.model(glm=("logistic", np.ones((n, 2)), np.zeros(n)),
                   device="cpu")
    assert pchains._route(MCMCTask(big, mt.HMC(3, 0.1), r), True) == "hmc"
    gen = mt.model(lambda v: -(v * v).sum(), gradient=True, init=np.zeros(2),
                   device="cpu")
    assert not pchains._fused_eligible(MCMCTask(gen, mt.HMC(3, 0.1), r))
    # the JAX package's eligibility rule gives the same answers
    jm = mc.model(glm=("logistic", X, Y))
    from mcmc_jl_tpu.core.task import MCMCTask as JTask
    from mcmc_jl_tpu.parallel.pchains import _fused_eligible as jax_eligible

    assert jax_eligible(JTask(jm, mc.HMC(3, 0.1), mc.SerialMC(steps=20)))


@pytest.mark.parametrize("integrator", ["leapfrog", "2stage"])
def test_glm_drivers_on_cpu(integrator):
    """run_glm_hmc (composed and fused-step: same generator draws, same
    chains) and run_glm_hmc_multistep on the plain versions."""
    X, Y = _data(n=60, seed=7)
    a, ia = run_glm_hmc(X, Y, 8, 60, n_leaps=4, eps=0.1, seed=3,
                        integrator=integrator, device="cpu")
    b, ib = run_glm_hmc(X, Y, 8, 60, n_leaps=4, eps=0.1, seed=3,
                        integrator=integrator, fused_step=True, device="cpu")
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    assert torch.equal(ia["accept"], ib["accept"])
    assert 0.5 < ia["accept"].float().mean() <= 1.0
    th, infos = run_glm_hmc_multistep(X, Y, 8, 60, thin=20, n_leaps=4,
                                      eps=0.1, seed=3, integrator=integrator,
                                      collect=True, device="cpu")
    assert infos["ppars"].shape == (3, 8, 4) and th.shape == (8, 4)
    assert torch.all(torch.isfinite(infos["plogtarget"]))
