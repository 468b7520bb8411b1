"""The warm-start pipeline's custom-target arms (ops/warmstart.py) against
the JAX package's and against the port's own generic engine, on the CPU:
``warm_eligible`` and the routes on catalog DSL models, non-catalog models
refused with a logged reason, the catalog model's gradient pass against
the model and the JAX model, ``_eps_row`` bit for bit, and each warm
target pipeline (exact NUTS, adaptive HMC with a diagonal metric, HMCDA,
adaptive MALA) through ``run(task, chains=N, fused=True)``, where the
wrappers run their plain versions: per-chain means within |z| < 5 of the
generic engine and of the exact moments, the generic engine's diagnostic
keys, frozen hyper-parameters and a repeatable ``resume``."""
import logging
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mcmc_jl_tpu as mc
from mcmc_jl_tpu.core.task import MCMCTask as JTask
from mcmc_jl_tpu.ops import warmstart as jws
import mcmc_jl_tpu_torch as mt
from mcmc_jl_tpu_torch.core.task import MCMCTask
from mcmc_jl_tpu_torch.ops import nuts_kernels as nk
from mcmc_jl_tpu_torch.ops import target_kernels as tk
from mcmc_jl_tpu_torch.ops import warmstart as tws
from mcmc_jl_tpu_torch.parallel import pchains

torch.set_num_threads(1)
Z_MAX = 5.0
# an anisotropic catalog target: sds 0.35 and 2 (exact moments below)
EXACT_MEAN = np.array([0.6, 0.6, 1.0])
EXACT_SD = np.array([math.sqrt(3) * 0.2, math.sqrt(3) * 0.2, 2.0])


def _ex(p):
    def ex(a, b):
        p.tilde(a, p.Gamma(3.0, 0.2))
        p.tilde(b, p.Normal(1.0, 2.0))
    return ex


def _models():
    init = dict(a=np.full(2, 0.6), b=np.array([1.0]))
    return (mc.model(_ex(mc), gradient=True, **init),
            mt.model(_ex(mt), gradient=True, device="cpu", **init))


def test_warm_eligibility_and_routes_match_jax():
    """warm_eligible agrees with the JAX package's on a catalog DSL model
    for every sampler both admit or refuse; the routes are "nuts" for exact
    NUTS and "warm" for the adaptive samplers, ChEES and the warm handoff,
    "target" for plain HMC and MALA."""
    jm, tm = _models()
    assert tm.target_spec is not None and tm.target_spec.has_rows
    tun, ttun = mc.EmpMCTuner(0.8, adapt_step=50), mt.EmpMCTuner(0.8,
                                                                 adapt_step=50)
    r, tr = mc.SerialMC(steps=600, burnin=200), mt.SerialMC(steps=600,
                                                            burnin=200)
    pairs = [
        (mc.HMC(5, 0.1, tun), mt.HMC(5, 0.1, ttun), "warm"),
        (mc.HMC(5, 0.1, mass_adapt="diag"), mt.HMC(5, 0.1, mass_adapt="diag"),
         "warm"),
        (mc.HMC(5, 0.1, tun, mass_adapt="diag-win"),
         mt.HMC(5, 0.1, ttun, mass_adapt="diag-win"), "warm"),
        (mc.HMCDA(), mt.HMCDA(), "warm"),
        (mc.HMCDA(mass_adapt="diag", integrator="2stage"),
         mt.HMCDA(mass_adapt="diag", integrator="2stage"), "warm"),
        (mc.MALA(0.05, tun), mt.MALA(0.05, ttun), "warm"),
        (mc.ChEESHMC(len0=0.5), mt.ChEESHMC(len0=0.5), "warm"),
        (mc.ChEESHMC(mass_adapt="diag", integrator="3stage"),
         mt.ChEESHMC(mass_adapt="diag", integrator="3stage"), "warm"),
        (mc.NUTS(), mt.NUTS(), "nuts"),
        (mc.NUTS(4, mass_adapt="diag", multinomial=True),
         mt.NUTS(4, mass_adapt="diag", multinomial=True), "nuts"),
        (mc.MALA(0.05), mt.MALA(0.05), "target"),
        (mc.HMC(5, 0.1), mt.HMC(5, 0.1), "target"),
        (mc.HMC(5, 0.1, tun, store_leaps=True),
         mt.HMC(5, 0.1, ttun, store_leaps=True), False),
    ]
    for js, ts, route in pairs:
        want = jws.warm_eligible(JTask(jm, js, r))
        assert tws.warm_eligible(MCMCTask(tm, ts, tr)) == want, ts
        assert pchains._route(MCMCTask(tm, ts, tr), True) == route, ts
    # no burn-in window; the warm handoff, admitted by both packages, takes
    # the warm route (kernel 5), not the NUTS kernels
    assert not tws.warm_eligible(MCMCTask(tm, mt.NUTS(),
                                          mt.SerialMC(steps=100)))
    assert jws.warm_eligible(JTask(jm, mc.NUTS(warm_handoff=True), r))
    assert tws.warm_eligible(MCMCTask(tm, mt.NUTS(warm_handoff=True), tr))
    assert pchains._route(MCMCTask(tm, mt.NUTS(warm_handoff=True), tr),
                          True) == "warm"
    assert not pchains._route(MCMCTask(tm, mt.NUTS(nk.MAX_DOUBLINGS + 1),
                                       tr), True)
    assert not pchains._route(MCMCTask(tm, mt.NUTS(), tr), "auto")  # CPU


def test_non_catalog_models_run_generic_with_a_reason(caplog):
    """A DSL model with a derived quantity and a callable model have no
    target_spec: the adaptive samplers and NUTS run on the generic engine
    and the log says why; a catalog target above D_MAX is refused too."""
    def ex(x):
        mt.tilde(2.0 * x, mt.Gamma(3.0, 0.2))

    opaque = mt.model(ex, x=np.full(2, 0.3), gradient=True, device="cpu")
    callable_m = mt.model(lambda v: -(v * v).sum(), gradient=True,
                          init=np.zeros(2), device="cpu")
    r = mt.SerialMC(steps=30, burnin=10)
    for m in (opaque, callable_m):
        assert m.target_spec is None
        for s in (mt.NUTS(3), mt.HMCDA(), mt.ChEESHMC(),
                  mt.MALA(0.05, mt.EmpMCTuner(0.5))):
            caplog.clear()
            with caplog.at_level(logging.INFO):
                assert not tws.warm_eligible(MCMCTask(m, s, r))
                assert not pchains._route(MCMCTask(m, s, r), True)
            assert "not a product of catalog densities" in caplog.text
    nk.reset_counts()
    tk.reset_counts()
    cs = mt.run(opaque * mt.NUTS(3) * r, chains=2, fused=True)
    assert len(cs) == 2 and cs[0].samples.shape == (20, 2)
    assert not any({**nk.PLAIN_CALLS, **tk.PLAIN_CALLS}.values())
    big = mt.model(lambda x: mt.tilde(x, mt.Normal(0.0, 1.0)),
                   x=np.zeros(tk.D_MAX + 1), gradient=True, device="cpu")
    assert big.target_spec is not None
    caplog.clear()
    with caplog.at_level(logging.INFO):
        assert not tws.warm_eligible(MCMCTask(big, mt.HMCDA(), r))
    assert f"d = {tk.D_MAX + 1} > {tk.D_MAX}" in caplog.text


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_catalog_evalallg_matches_autodiff_and_jax(dtype):
    """The (logp, gradient) pass that serves a catalog DSL model's
    evalallg on the card (target_logp_grad; on the CPU its plain version)
    equals the model's evalallg and the JAX package's model gradient, for
    all ten families, out of the support (-inf and a zero gradient: the
    pass sanitizes as the model does) and at Laplace's loc (-1/scale)."""
    fams = [(mt.Normal(0.5, 2.0), mc.Normal(0.5, 2.0)),
            (mt.Uniform(-1.0, 3.0), mc.Uniform(-1.0, 3.0)),
            (mt.Exponential(2.0), mc.Exponential(2.0)),
            (mt.Gamma(2.0, 1.5), mc.Gamma(2.0, 1.5)),
            (mt.Weibull(1.5, 2.0), mc.Weibull(1.5, 2.0)),
            (mt.Cauchy(0.0, 1.0), mc.Cauchy(0.0, 1.0)),
            (mt.LogNormal(0.0, 0.5), mc.LogNormal(0.0, 0.5)),
            (mt.Beta(2.0, 3.0), mc.Beta(2.0, 3.0)),
            (mt.Laplace(0.0, 1.0), mc.Laplace(0.0, 1.0)),
            (mt.TDist(5.0), mc.TDist(5.0))]
    keys = [f"p{j}" for j in range(len(fams))]

    def ex(p, k):
        def f(**v):
            for key, pair in zip(keys, fams):
                p.tilde(v[key], pair[k])
        return f

    x0 = dict(zip(keys, [0.5, 1.0, 1.0, 2.0, 1.5, 0.0, 1.1, 0.4, 0.0, 0.0]))
    tm = mt.model(ex(mt, 0), gradient=True, device="cpu", dtype=dtype, **x0)
    jm = mc.model(ex(mc, 1), gradient=True, **x0)
    assert tm.target_spec is not None
    rng = np.random.default_rng(5)
    theta = np.array(list(x0.values())) + 0.4 * rng.standard_normal((64, 10))
    theta[:, [2, 3, 4, 6]] = np.abs(theta[:, [2, 3, 4, 6]]) + 0.05
    theta[:, 7] = np.clip(theta[:, 7], 0.05, 0.95)  # inside the supports
    theta[:8, 8] = 0.0  # Laplace exactly at loc
    theta[8:12, 2] = -0.3  # Exponential out of its support
    theta[12:16, 7] = 1.2  # Beta out of its support
    th = torch.as_tensor(theta, dtype=dtype)
    lp, g = tm.evalallg(th)
    tk.reset_counts()
    lp_ad, g_ad = tk.target_logp_grad(tm.target_spec, th)
    assert tk.PLAIN_CALLS["target_logp_grad"] == 1
    out = ~torch.isfinite(lp_ad)
    assert out[8:16].all() and not out[16:].any()
    assert torch.equal(torch.isfinite(lp), ~out) and (g[out] == 0).all()
    assert torch.equal(lp_ad[out], lp[out]) and (g_ad[out] == 0).all()
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32 else \
        dict(rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(lp[~out], lp_ad[~out], **tol)
    torch.testing.assert_close(g[~out], g_ad[~out], **tol)
    assert torch.all(g[:8, 8] == -1.0)
    jlp, jg = jax.vmap(jm.evalallg)(jnp.asarray(theta))
    np.testing.assert_allclose(lp[16:].double().numpy(), np.asarray(jlp)[16:],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(g[16:].double().numpy(), np.asarray(jg)[16:],
                               rtol=1e-5, atol=1e-5)
    lp1, g1 = tm.evalallg(th[20])  # one chain: a (d,) state
    torch.testing.assert_close(lp1, lp[20])
    torch.testing.assert_close(g1, g[20])


@pytest.mark.parametrize("s", [None, "row"])
def test_eps_row_bit_equal_to_jax(s):
    """_eps_row: eps * s in float64 rounded once to float32, unpadded; the
    scalar step as the kernels round it."""
    eps = 0.0123456789
    sv = None if s is None else np.array([0.35, 2.0, 1.7, 0.2, 12.0])
    ours = tws._eps_row(eps, None if sv is None else torch.as_tensor(sv))
    theirs = np.asarray(jws._eps_row(eps, sv, 5, 128))
    if s is None:
        assert isinstance(ours, float)
        assert np.float32(ours).view(np.uint32) == theirs.view(np.uint32)
    else:
        assert ours.dtype == torch.float32 and ours.shape == (5,)
        np.testing.assert_array_equal(ours.numpy().view(np.uint32),
                                      theirs[:5].view(np.uint32))


WARM = {
    # name: (sampler, runner, kernel, plain calls of it)
    "nuts": (lambda: mt.NUTS(4), (90, 30), "target_nuts_transition", 60),
    "nuts_diag_multinomial": (
        lambda: mt.NUTS(4, mass_adapt="diag", multinomial=True), (100, 40),
        "target_nuts_transition", 60),
    "hmc_diag": (lambda: mt.HMC(3, 0.05, mt.EmpMCTuner(
        0.8, adapt_step=25, target_path=0.5), mass_adapt="diag"), (300, 100),
        "target_leapfrogs", 200),
    "hmcda": (lambda: mt.HMCDA(len=0.5), (200, 80), "target_leapfrogs", 120),
    "mala": (lambda: mt.MALA(0.01, mt.EmpMCTuner(0.574, adapt_step=50)),
             (900, 300), "target_leapfrogs", 600),
}


@pytest.mark.parametrize("name", list(WARM))
def test_warm_target_pipeline(name):
    """run(task, chains=16, fused=True) on the anisotropic catalog model
    takes the warm route's target arm: the kernel's plain version once per
    sampling transition (NUTS) or per trajectory; the kept draws agree with
    the generic engine and the exact moments; the infos carry the generic
    engine's keys; the final states are exact (lp and gradient at the last
    draw) with the adaptation frozen, and resume repeats."""
    make, (steps, burnin), kernel, calls = WARM[name]
    _, m = _models()
    task = m * make() * mt.SerialMC(steps=steps, burnin=burnin)
    C = 16
    nk.reset_counts()
    tk.reset_counts()
    cf = mt.run(task, chains=C, seed=0, fused=True)
    plain = {**nk.PLAIN_CALLS, **tk.PLAIN_CALLS}
    assert plain.pop(kernel) == calls and not any(plain.values()), plain
    cg = mt.run(task, chains=C, seed=1, fused=False)
    a = np.stack([c.samples.values.mean(0) for c in cf])
    b = np.stack([c.samples.values.mean(0) for c in cg])
    se = np.sqrt(a.var(0, ddof=1) / C + b.var(0, ddof=1) / C)
    assert np.all(np.abs(a.mean(0) - b.mean(0)) / se < Z_MAX), (a.mean(0),
                                                                b.mean(0))
    se_a = a.std(0, ddof=1) / math.sqrt(C)
    assert np.all(np.abs(a.mean(0) - EXACT_MEAN) / se_a < Z_MAX), a.mean(0)
    pooled = np.concatenate([c.samples.values for c in cf])
    np.testing.assert_allclose(pooled.std(0), EXACT_SD, rtol=0.35)
    c0 = cf[0]
    assert c0.samples.shape == (steps - burnin, 3)
    assert set(c0.diagnostics) == set(cg[0].diagnostics)
    st = c0.task.state
    assert st.i.item() == steps + 1 and st.pars.dtype == m.dtype
    lp, g = m.evalallg(st.pars)
    torch.testing.assert_close(st.logtarget, lp)
    torch.testing.assert_close(st.grad, g)
    np.testing.assert_allclose(c0.samples.values[-1], st.pars.numpy(),
                               rtol=1e-6)
    frozen = [c.task.state for c in cf]
    if name.startswith("nuts"):
        eps = c0.diagnostics["epsilon"]
        assert np.all(eps == eps[0])  # frozen over the sampling phase
        assert len({s.epsilon.item() for s in frozen}) == 1
    elif name == "hmcda":
        assert len({s.leap_step.item() for s in frozen}) == 1
    else:
        assert len({s.tune.step_size.item() for s in frozen}) == 1
        assert all(s.tune.accepted.item() == 0 for s in frozen)
    r1, r2 = mt.resume(c0, steps=15), mt.resume(c0, steps=15)
    np.testing.assert_array_equal(r1.samples.values, r2.samples.values)
    assert r1.task.pos == steps + 15


# The warm target paths' ten-parameter catalog model (chip_smoke.py
# _ten_bare, after benchmarks/benchunits/bare_distribs.py:41-61): one named
# parameter per family, sds from 0.2 to 12, started at the means.
TEN = [("Normal", (3.0, 12.0), 3.0), ("Normal", (1.0, 1.0), 1.0),
       ("Weibull", (3.0, 1.0), 0.893), ("Uniform", (0.0, 2.0), 1.0),
       ("Beta", (3.0, 2.0), 0.6), ("Gamma", (3.0, 0.2), 0.6),
       ("Gamma", (1.0, 2.0), 2.0), ("Exponential", (0.2,), 0.2),
       ("LogNormal", (2.0, 0.1), 7.426093896757824),
       ("Weibull", (1.0, 1.0), 1.0)]


def _ten_models(dtype=torch.float64):
    def ex_for(p):
        def ex(**q):
            for j, (fam, args, _) in enumerate(TEN):
                p.tilde(q[f"p{j}"], getattr(p, fam)(*args))
        return ex

    init = {f"p{j}": x0 for j, (_, _, x0) in enumerate(TEN)}
    return (mc.model(ex_for(mc), gradient=True, **init),
            mt.model(ex_for(mt), gradient=True, device="cpu", dtype=dtype,
                     **init))


def _per_chain_z(a, b):
    """max |difference of pooled means| / se over coordinates, for two sets
    of independent chains (kept steps, chains, d): the per-chain means'
    spread gives the se, mixed or not."""
    ma, mb = a.mean(0), b.mean(0)
    se = np.sqrt(ma.var(0, ddof=1) / len(ma) + mb.var(0, ddof=1) / len(mb))
    return float(np.max(np.abs(ma.mean(0) - mb.mean(0)) / se))


def test_dyn_target_phase_matches_jax_on_ten_bare_distributions():
    """Adaptive HMC with a diagonal metric on the ten-parameter catalog
    model sat at z 4.91 against the exact moments on the card.  Both
    packages' sampling phases (``_dyn_target_phase``: the Halton-jittered
    trajectory kernel with the metric on the step row; JAX in interpret
    mode) run from one frozen (eps, nl, s) and one start: the chip run's
    trajectory length T = 2 nl eps = 0.4 at ten times its step (eps 0.01,
    nl 20 in place of 0.0010 and 200), s the exact sds.  Their first and
    second moments agree chain set against chain set (|z| < 5 on every
    coordinate) with the same acceptance: the phase carries no bias of the
    port, and the z on the card is the reference's slow mixing."""
    mj, mtm = _ten_models()
    d, C, steps, eps, nl = len(TEN), 64, 150, 0.01, 20
    sd = np.array([float(getattr(mt, f)(*a).std()) for f, a, _ in TEN])
    rng = np.random.default_rng(0)
    x0 = np.array([x for _, _, x in TEN]) + 0.1 * sd * rng.standard_normal(
        (C, d))
    assert all(math.isfinite(float(mtm.evalallg(torch.tensor(x))[0]))
               for x in x0)
    T, max_leaps = 2.0 * nl * eps, 2 * nl
    (_, _, _), inf_j, fold = jws._dyn_target_phase(
        mj, "leapfrog", eps, T, max_leaps, sd,
        type("W", (), {"pars": jnp.asarray(x0)}), steps, 1,
        jax.random.PRNGKey(3), C, True, None)
    assert fold is None  # diagonal metric: on the step row, no z-space fold
    (_, _, _), inf_t = tws._dyn_target_phase(
        mtm, "leapfrog", eps, T, max_leaps, torch.tensor(sd),
        type("W", (), {"pars": torch.tensor(x0)}), steps, 1,
        torch.Generator().manual_seed(3))
    a = np.asarray(inf_j["ppars"], np.float64)[..., :d]
    b = inf_t["ppars"].double().numpy()
    assert a.shape == b.shape == (steps, C, d)
    np.testing.assert_array_equal(np.asarray(inf_j["nleaps"]),
                                  inf_t["nleaps"].numpy())
    assert _per_chain_z(a, b) < Z_MAX
    assert _per_chain_z(a * a, b * b) < Z_MAX
    acc_j = float(np.mean(np.asarray(inf_j["accept"])))
    acc_t = float(inf_t["accept"].float().mean())
    assert abs(acc_j - acc_t) < 0.05, (acc_j, acc_t)


CROSS = {  # sampler, (steps, burnin): the chip run's warm target paths
    "nuts": (lambda p: p.NUTS(maxdoublings=6), (1500, 500)),
    "mala": (lambda p: p.MALA(0.002, p.EmpMCTuner(0.574, adapt_step=50)),
             (1000, 200)),
    "chees": (lambda p: p.ChEESHMC(len0=0.5, max_leaps=64), (1000, 200)),
    "hmc_diag": (lambda p: p.HMC(10, 0.02, p.EmpMCTuner(0.8, adapt_step=50),
                                 mass_adapt="diag"), (2000, 500)),
}


@pytest.mark.parametrize("name", list(CROSS))
def test_metric_free_samplers_cross_normal_3_12_no_better_in_jax(name):
    """On the card, unit-metric NUTS, adaptive MALA and ChEES did not cross
    Normal(3, 12) (sd 12) of the ten-parameter model in the run's
    transitions.  The JAX package's samplers (16 chains, its own engine)
    do no better: the pooled sd of that coordinate stays under half of 12,
    while adaptive HMC with a diagonal metric reaches more than half.
    The port's MALA and ChEES (the warm route, plain kernel versions) stay
    under half as well.  So this is the samplers' mixing on this model,
    not a fault of the port."""
    make, (steps, burnin) = CROSS[name]
    mj, m32 = _ten_models(torch.float32)  # float32: the warm route's type
    runs = [mc.run(mj * make(mc) * mc.SerialMC(steps=steps, burnin=burnin),
                   chains=16, seed=0, fused=False)]
    if name in ("mala", "chees"):
        tk.reset_counts()
        runs.append(mt.run(m32 * make(mt) * mt.SerialMC(steps=steps,
                                                        burnin=burnin),
                           chains=16, seed=0, fused=True))
        assert tk.PLAIN_CALLS["target_leapfrogs"] == steps - burnin
    for cs in runs:
        x = np.stack([np.asarray(c.samples.values, np.float64) for c in cs])
        assert x.shape == (16, steps - burnin, len(TEN))
        assert np.all(np.isfinite(x))
        sd0 = float(x[..., 0].std())
        if name == "hmc_diag":
            assert sd0 > 6.0, sd0
        else:
            assert sd0 < 6.0, sd0
