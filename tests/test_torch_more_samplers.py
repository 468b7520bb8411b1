"""The port's Barker, IMH, RAM and WALNUTS (samplers/barker.py, imh.py,
ram.py, walnuts.py) and the standalone slice sampler (samplers/slice.py)
against the JAX package's, on the CPU in float64.

- Each deterministic part is held exactly (1e-12) on given inputs: Barker's
  log-ratio and accept decision on the draws of a JAX step replayed from
  its key, RAM's factor update on the same, and WALNUTS's chosen level,
  endpoint and ``bad`` flag for fixed states and momenta.
- Whole runs through ``parallel.pchains.run_chains`` against the JAX
  ``run_chains`` on the same logistic GLM (tests/test_torch_nuts.py's):
  pooled means within 5 standard errors (from the spread of the per-chain
  means in each package), sd within 30%, acceptance within 0.05.
- A run then two resumes repeat their draws; JAX states carried over by the
  converters continue; every new sampler takes the generic engine with a
  logged reason on a float32 catalog model and on a GLM."""
import dataclasses
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mcmc_jl_tpu as mc
from mcmc_jl_tpu.parallel import run_chains as jax_run_chains
from mcmc_jl_tpu.samplers.base import RunCtx as JRunCtx
from mcmc_jl_tpu.samplers.integrators import leapfrog as jleapfrog
import mcmc_jl_tpu_torch as mt
from mcmc_jl_tpu_torch.ops import (glm_bign, glm_kernels, nuts_kernels,
                                   rwm_kernels, target_kernels)
from mcmc_jl_tpu_torch.parallel import pchains
from mcmc_jl_tpu_torch.samplers.barker import barker_log_ratio
from mcmc_jl_tpu_torch.samplers.ram import ram_factor_update

torch.set_num_threads(1)
F64 = torch.float64
EXACT = 1e-12


def _data(n=80, d=3, seed=7):
    """tests/test_pallas_nuts.py's data."""
    rng = np.random.default_rng(seed)
    X = np.column_stack([np.ones(n), rng.standard_normal((n, d - 1))])
    beta = rng.standard_normal(d) * 0.7
    Y = (rng.random(n) < 1.0 / (1.0 + np.exp(-X @ beta))).astype(np.float64)
    return X, Y


def _models():
    X, Y = _data()
    return (mc.model(glm=("logistic", X, Y)),
            mt.model(glm=("logistic", X, Y), dtype=F64, device="cpu"))


def _laplace():
    """Mode and covariance of the GLM posterior's Laplace approximation
    (numpy Newton steps): the IMH proposal is centred there, twice as
    wide."""
    X, Y = _data()
    th = np.zeros(X.shape[1])
    for _ in range(30):
        p = 1.0 / (1.0 + np.exp(-X @ th))
        H = X.T @ (X * (p * (1 - p))[:, None]) + np.eye(len(th))
        th = th + np.linalg.solve(H, X.T @ (Y - p) - th)
    return th, np.linalg.inv(H)


def _imh_pair():
    mode, cov = _laplace()
    return (mc.IMH(mc.MvNormal(jnp.asarray(mode), jnp.asarray(2.0 * cov))),
            mt.IMH(mt.MvNormal(torch.tensor(mode), torch.tensor(2.0 * cov))))


def _pair(name):
    """(JAX sampler, port sampler, chains, steps, burnin)."""
    if name == "barker":
        return (mc.Barker(0.3, mc.EmpMCTuner(0.57, adapt_step=25)),
                mt.Barker(0.3, mt.EmpMCTuner(0.57, adapt_step=25)), 32, 500,
                100)
    if name == "imh":
        return (*_imh_pair(), 32, 300, 50)
    if name == "ram":
        return mc.RAM(0.5, 0.3), mt.RAM(0.5, 0.3), 32, 600, 200
    multinomial, mass = {"walnuts_slice": (False, False),
                         "walnuts_multinomial": (True, False),
                         "walnuts_slice_diag": (False, "diag"),
                         "walnuts_multinomial_diag": (True, "diag")}[name]
    kw = dict(maxdoublings=5, multinomial=multinomial, mass_adapt=mass)
    return mc.WALNUTS(**kw), mt.WALNUTS(**kw), 16, 200, 60


RUNS = ["barker", "imh", "ram", "walnuts_slice", "walnuts_multinomial",
        "walnuts_slice_diag", "walnuts_multinomial_diag"]


def _chain_z(a, b):
    """|difference of pooled means| in standard errors estimated from the
    spread of the per-chain means (a, b: (kept, chains, d))."""
    ma, mb = a.mean(0), b.mean(0)
    se = np.sqrt(ma.var(0, ddof=1) / len(ma) + mb.var(0, ddof=1) / len(mb))
    return np.abs(ma.mean(0) - mb.mean(0)) / se


@pytest.mark.parametrize("name", RUNS)
def test_run_chains_matches_jax(name):
    jm, tm = _models()
    js, ts, C, steps, burn = _pair(name)
    infos, st, _ = pchains.run_chains(tm, ts, mt.SerialMC(steps=steps,
                                                          burnin=burn),
                                      C, seed=0)
    jinfos, jst, _ = jax_run_chains(jm, js, mc.SerialMC(steps=steps,
                                                        burnin=burn), C,
                                    seed=0)
    assert set(infos) == set(jinfos)
    x = infos["ppars"][burn:].numpy()
    xj = np.asarray(jinfos["ppars"])[burn:]
    assert x.shape == xj.shape == (steps - burn, C, 3)
    z = _chain_z(x, xj)
    assert np.all(z < 5), z
    np.testing.assert_allclose(x.reshape(-1, 3).std(0),
                               xj.reshape(-1, 3).std(0), rtol=0.3)
    acc = infos["accept"][burn:].double().mean().item()
    jacc = np.asarray(jinfos["accept"])[burn:].mean()
    assert abs(acc - jacc) < 0.05, (acc, jacc)
    assert torch.all(st.i == steps + 1)
    if name == "barker":  # the tuner moved every chain's step
        assert torch.all(st.tune.step_size != 0.3)
        assert "pgrads" in infos and "grads" in infos
    if name == "ram":
        assert st.S.shape == (C, 3, 3)
        assert torch.all(torch.isfinite(st.S))
        scale = infos["scale"].numpy()
        np.testing.assert_allclose(
            np.median(scale[-1]), np.median(np.asarray(jinfos["scale"])[-1]),
            rtol=0.3)
    if name.startswith("walnuts"):
        assert infos["irreversible"].dtype == torch.bool
        eps = np.median(np.exp(st.lebar.numpy()))
        jeps = np.median(np.exp(np.asarray(jst.lebar)))
        assert abs(eps / jeps - 1) < 0.25, (eps, jeps)


def _one_chain_state(js, jm, key):
    return js.init(jm, jnp.asarray([-0.5, 0.1, 0.9]), key)


@pytest.mark.parametrize("seed", range(4))
def test_barker_step_matches_jax(seed):
    """Replay a JAX Barker step's draws from its key: the port's log-ratio
    gives the same accept decision and the same new state."""
    jm, tm = _models()
    js = mc.Barker(0.8)
    key = jax.random.PRNGKey(seed)
    state = _one_chain_state(js, jm, jax.random.PRNGKey(100 + seed))
    new, info = js.step(jm, JRunCtx(burnin=0), state, key)
    k_z, k_b, k_acc = jax.random.split(key, 3)
    shape = state.pars.shape
    z = 0.8 * jax.random.normal(k_z, shape, dtype=jnp.float64)
    u = jax.random.uniform(k_b, shape, dtype=jnp.float64)
    w = jnp.where(u < jax.nn.sigmoid(z * state.grad), z, -z)
    lp, g = tm.evalallg(torch.tensor(np.asarray(state.pars)))
    plp, pg = tm.evalallg(torch.tensor(np.asarray(state.pars + w)))
    ratio = barker_log_ratio(lp, g, plp, pg, torch.tensor(np.asarray(w)))
    want = (float(jm.eval(state.pars + w)) - float(state.logtarget)
            + float(jnp.sum(jax.nn.softplus(-w * state.grad)
                            - jax.nn.softplus(w * jm.evalg(state.pars + w)))))
    np.testing.assert_allclose(float(ratio), want, rtol=EXACT, atol=EXACT)
    logu = float(jnp.log(jax.random.uniform(k_acc, (), dtype=jnp.float64)))
    accept = bool(ratio > 0) or bool(ratio > logu)
    assert accept == bool(info["accept"])
    want_pars = np.asarray(state.pars + w) if accept else np.asarray(
        state.pars)
    np.testing.assert_allclose(np.asarray(new.pars), want_pars, rtol=EXACT)


@pytest.mark.parametrize("seed", range(4))
def test_ram_factor_update_matches_jax(seed):
    """Replay a JAX RAM step's normal draw from its key: the port's factor
    update equals the JAX step's new factor."""
    jm, tm = _models()
    js = mc.RAM(0.7, 0.3)
    rng = np.random.default_rng(seed)
    state = _one_chain_state(js, jm, jax.random.PRNGKey(seed))
    A = rng.standard_normal((3, 3)) * 0.3
    S0 = np.linalg.cholesky(A @ A.T + 0.2 * np.eye(3))
    state = state.replace(S=jnp.asarray(S0), i=jnp.asarray(seed * 7 + 2,
                                                           jnp.int32))
    key = jax.random.PRNGKey(50 + seed)
    new, info = js.step(jm, JRunCtx(burnin=0), state, key)
    k_prop, _ = jax.random.split(key)
    rvec = jax.random.normal(k_prop, (3,), dtype=jnp.float64)
    ratio = jm.eval(state.pars + state.S @ rvec) - state.logtarget
    got = ram_factor_update(torch.tensor(S0), torch.tensor(np.asarray(rvec)),
                            torch.tensor(float(ratio), dtype=F64),
                            torch.tensor(int(state.i)), 0.3)
    np.testing.assert_allclose(got.numpy(), np.asarray(new.S), rtol=EXACT,
                               atol=EXACT)
    np.testing.assert_allclose(float(info["scale"]), np.trace(S0),
                               rtol=EXACT)
    # batched over chains: one factorization for all
    Sb = torch.tensor(np.stack([S0, 2.0 * S0]))
    rb = torch.tensor(np.stack([np.asarray(rvec)] * 2))
    gb = ram_factor_update(Sb, rb, torch.tensor([float(ratio)] * 2,
                                                dtype=F64),
                           torch.tensor([int(state.i)] * 2), 0.3)
    np.testing.assert_allclose(gb[0].numpy(), got.numpy(), rtol=EXACT)


def test_ram_keeps_a_factor_that_does_not_factorize():
    """An update whose product overflows keeps the old factor, as the JAX
    step does (cholesky_ex's info or a non-finite entry)."""
    jm, _ = _models()
    js = mc.RAM(1.0, 0.3)
    S0 = np.diag([1.0, 1e200, 1.0])
    state = _one_chain_state(js, jm, jax.random.PRNGKey(0)).replace(
        S=jnp.asarray(S0))
    new, _ = js.step(jm, JRunCtx(burnin=0), state, jax.random.PRNGKey(1))
    np.testing.assert_array_equal(np.asarray(new.S), S0)
    r = torch.tensor([0.3, 1.0, -0.2], dtype=F64)
    got = ram_factor_update(torch.tensor(np.stack([S0, np.eye(3)])),
                            torch.stack([r, r]),
                            torch.tensor([0.0, 0.0], dtype=F64),
                            torch.tensor([1, 1]), 0.3)
    np.testing.assert_array_equal(got[0].numpy(), S0)
    assert torch.all(torch.isfinite(got[1])) and not torch.equal(
        got[1], torch.eye(3, dtype=F64))


def _gauss_pair():
    """tests/test_walnuts.py's correlated Gaussian with its gradient."""
    A = np.array([[1.0, 0.3, 0.0], [0.3, 2.0, 0.2], [0.0, 0.2, 0.5]])
    mu = np.array([0.5, -0.3, 0.2])
    jm = mc.model(lambda v: -0.5 * (v - mu) @ jnp.asarray(A) @ (v - mu),
                  gradient=True, init=jnp.asarray(mu + 0.5),
                  check_init=False)
    At, mut = torch.tensor(A), torch.tensor(mu)
    tm = mt.model(lambda v: -0.5 * (v - mut) @ At @ (v - mut),
                  grad=lambda v: -At @ (v - mut), init=mu + 0.5, dtype=F64,
                  device="cpu", check_init=False)
    return jm, tm


@pytest.mark.parametrize("eps", [0.05, 0.9, 1.6, 2.6, 6.0])
def test_walnuts_level_and_bad_match_jax(eps):
    """For fixed states and momenta and a macro step from small (l = 0) to
    far past stability (some chains bad at max_halvings): the same chosen
    level (read
    off JAX's endpoint as the 2^l-leapfrog path it equals), endpoint, bad
    and halved flags as JAX's _leaf_advance, chain by chain."""
    jm, tm = _gauss_pair()
    rng = np.random.default_rng(11)
    C, L = 24, 4
    x = rng.standard_normal((C, 3)) * 1.5
    m = rng.standard_normal((C, 3))
    sign = np.where(np.arange(C) % 2 == 0, 1.0, -1.0)
    js, ts = mc.WALNUTS(delta=0.5, max_halvings=L), mt.WALNUTS(
        delta=0.5, max_halvings=L)
    lp, g = tm.evalallg(torch.tensor(x))
    es = torch.tensor(sign * eps).unsqueeze(-1)
    got = ts._walk(tm, torch.tensor(x), lp, torch.tensor(m), g, es)
    jout = jax.vmap(lambda p, l_, mm, gg, e: js._leaf_advance(
        jm, p, l_, mm, gg, e, None))(
            jnp.asarray(x), jnp.asarray(lp.numpy()), jnp.asarray(m),
            jnp.asarray(g.numpy()), jnp.asarray(sign * eps))
    jp, jlp, jg, jmm, jbad, jhalved = (np.asarray(a) for a in jout)
    p, lp1, g1, m1, bad, sel = (a.numpy() for a in got)
    np.testing.assert_allclose(p, jp, rtol=EXACT, atol=EXACT)
    np.testing.assert_allclose(m1, jmm, rtol=EXACT, atol=EXACT)
    np.testing.assert_allclose(g1, jg, rtol=EXACT, atol=EXACT)
    np.testing.assert_allclose(lp1, jlp, rtol=EXACT, atol=EXACT)
    np.testing.assert_array_equal(bad, jbad)
    np.testing.assert_array_equal(sel > 0, jhalved)
    # JAX's level: the 2^l micro-leapfrog path its endpoint is
    for c in range(C):
        ends = []
        for lvl in range(L + 1):
            n = 1 << lvl
            q, mm, gg = jnp.asarray(x[c]), jnp.asarray(m[c]), jnp.asarray(
                g[c].numpy())
            for _ in range(n):
                q, _, gg, mm = jleapfrog(jm, q, mm, gg, sign[c] * eps / n)
            ends.append(np.asarray(q))
        jl = int(np.argmin([np.abs(e - jp[c]).max() for e in ends]))
        assert jl == sel[c], (c, jl, sel[c])
    # the leaf API: halved = l > 0; an inactive chain comes back as given
    active = torch.tensor(np.arange(C) % 3 != 0)
    leaf = ts._leaf_advance(tm, torch.tensor(x), lp, torch.tensor(m), g, es,
                            None, active=active)
    np.testing.assert_array_equal(leaf[5].numpy(), (sel > 0) & active.numpy())
    np.testing.assert_array_equal(leaf[4].numpy()[active.numpy()],
                                  bad[active.numpy()])
    assert not leaf[4][~active].any()
    if eps == 0.05:
        assert np.all(sel == 0) and not bad.any()
    if eps == 6.0:
        assert bad.any() and (sel == L).any()
    if eps in (1.6, 2.6):
        assert (sel > 0).any()


def _task(name, tm):
    _, ts, C, steps, burn = _pair(name)
    return tm * ts * mt.SerialMC(steps=steps // 5, burnin=burn // 5), C


@pytest.mark.parametrize("name", ["barker", "imh", "ram",
                                  "walnuts_multinomial_diag"])
def test_run_then_two_resumes_repeat(name):
    """run(chains=4), then resume(list) twice from the same chains: the
    same draws, pos advanced; and a single-chain run resumed twice."""
    _, tm = _models()
    task, _ = _task(name, tm)
    cs = mt.run(task, chains=4, seed=3)
    r1, r2 = mt.resume(cs, steps=12), mt.resume(cs, steps=12)
    for a, b in zip(r1, r2):
        np.testing.assert_array_equal(a.samples.values, b.samples.values)
        assert a.task.pos == b.task.pos == task.runner.len + 12
    assert not np.array_equal(r1[0].samples.values, r1[1].samples.values)
    c = mt.run(task, seed=5)
    assert c.task.state.pars.shape == (3,)
    s1, s2 = mt.resume(c, steps=10), mt.resume(c, steps=10)
    np.testing.assert_array_equal(s1.samples.values, s2.samples.values)


def _as_dict(state):
    return {f.name: (_as_dict(getattr(state, f.name))
                     if dataclasses.is_dataclass(getattr(state, f.name))
                     else np.asarray(getattr(state, f.name)))
            for f in dataclasses.fields(state)}


@pytest.mark.parametrize("name", ["barker", "imh", "ram",
                                  "walnuts_multinomial_diag"])
def test_jax_state_continues_in_the_port(name):
    """JAX final states carried over by the converters continue in the
    port: same positions and counters at the start, and the continuation's
    means agree with the JAX run's kept draws."""
    jm, tm = _models()
    js, ts, C, steps, burn = _pair(name)
    jinfos, jst, _ = jax_run_chains(jm, js, mc.SerialMC(steps=steps,
                                                        burnin=burn), C,
                                    seed=1)
    convert = {"barker": mt.barker_state_from_numpy,
               "imh": mt.imh_state_from_numpy,
               "ram": mt.ram_state_from_numpy}.get(
                   name, mt.nuts_state_from_numpy)
    st = convert(_as_dict(jax.device_get(jst)), device="cpu")
    np.testing.assert_array_equal(st.pars.numpy(), np.asarray(jst.pars))
    assert st.i.dtype == torch.int32 and torch.all(st.i == steps + 1)
    if name == "imh":  # the carried candidate density is the port's
        np.testing.assert_allclose(ts._logc(st.pars).numpy(),
                                   st.logcandidate.numpy(), rtol=1e-10)
    cont = 150
    infos, new, _ = pchains.run_chains(tm, ts, mt.SerialMC(steps=cont), C,
                                       seed=2, states=st)
    assert torch.all(new.i == steps + 1 + cont)
    x = infos["ppars"].numpy()
    assert np.all(np.isfinite(x))
    xj = np.asarray(jinfos["ppars"])[burn:]
    z = _chain_z(x, xj)
    assert np.all(z < 5), z


@pytest.mark.parametrize("name", ["barker", "imh", "ram", "walnuts"])
def test_new_samplers_take_the_generic_engine(name, caplog):
    """On a float32 catalog model and on a GLM, each new sampler routes to
    the generic engine with a logged reason, in a run and in a resume, and
    no kernel or plain version runs (WALNUTS never reaches 8, 8b or 9)."""
    X, Y = _data()
    models = [
        mt.model(lambda x: mt.tilde(x, mt.Gamma(3.0, 0.2)),
                 x=np.full(4, 0.7), gradient=True, dtype=torch.float32,
                 device="cpu"),
        mt.model(glm=("logistic", X, Y), dtype=torch.float32, device="cpu")]
    assert models[0].target_spec is not None
    mode, cov = _laplace()
    samplers = {"barker": mt.Barker(0.3, mt.EmpMCTuner(0.57, adapt_step=5)),
                "ram": mt.RAM(0.5),
                "walnuts": mt.WALNUTS(multinomial=True, maxdoublings=4)}
    mods = (glm_kernels, nuts_kernels, glm_bign, target_kernels, rwm_kernels)
    for m in models:
        d = m.size
        s = samplers.get(name) or mt.IMH(mt.MvNormal(
            torch.full((d,), 0.6) if d == 4 else torch.tensor(mode),
            torch.eye(d) * 0.3 if d == 4 else torch.tensor(2 * cov)))
        task = m * s * mt.SerialMC(steps=12, burnin=6)
        caplog.clear()
        with caplog.at_level(logging.INFO):
            assert pchains._route(task, True) is False
        why = ("adapts each macro step's micro steps" if name == "walnuts"
               else "no fused CUDA route")
        assert why in caplog.text and "generic" in caplog.text, caplog.text
        for mod in mods:
            mod.reset_counts()
        caplog.clear()
        with caplog.at_level(logging.INFO):
            cs = mt.run(task, chains=6, fused=True)
            mt.resume(cs, steps=4, fused=True)
        assert "continuing 6" in caplog.text and "generic" in caplog.text
        assert ("adapts each macro step's micro steps" if name == "walnuts"
                else "has no fused continuation") in caplog.text
        for mod in mods:
            assert not any(mod.LAUNCHES.values()), mod.LAUNCHES
            assert not any(mod.PLAIN_CALLS.values()), mod.PLAIN_CALLS
        assert np.all(np.isfinite(np.stack([c.samples.values for c in cs])))


def test_slice_sample_funnel_matches_jax():
    """tests/test_runners.py's 2-D case (Neal's funnel, 8000 iterations,
    widths 5): the same moment gates in both packages, on the port's
    CPU tensors."""
    def tlog(q):
        v, x = q[0], q[1]
        return -0.5 * (v / 3.0) ** 2 + (-0.5 * (x / torch.exp(v / 2.0)) ** 2
                                        - v / 2.0)

    def jlog(q):
        v, x = q[0], q[1]
        return -0.5 * (v / 3.0) ** 2 + (-0.5 * (x / jnp.exp(v / 2.0)) ** 2
                                        - v / 2.0)

    hist = mt.slice_sample(tlog, torch.zeros(2, dtype=F64), 8000,
                           widths=torch.tensor([5.0, 5.0]), seed=1)
    jh = mc.slice_sample(jlog, jnp.zeros(2), 8000,
                         widths=jnp.array([5.0, 5.0]), seed=1)
    assert hist.shape == jh.shape == (8000, 2) and hist.dtype == np.float64
    for h in (hist, jh):
        v = h[:, 0]
        assert abs(v.mean()) < 0.5
        assert abs(v.std() - 3.0) < 0.6
    # the two packages' v-means within 5 standard errors (ESS ~ n/10)
    se = np.sqrt((hist[:, 0].var() + jh[:, 0].var()) / 800.0)
    assert abs(hist[:, 0].mean() - jh[:, 0].mean()) < 5 * se


def test_slice_sample_interfaces():
    """The scalar interface returns (niter,); burn-in rows are dropped; a
    coordinate whose interval shrinks to a point is abandoned, not
    raised; numpy draws of N(1, 0.5^2) have its moments."""
    h = mt.slice_sample(lambda x: -0.5 * ((x - 1.0) / 0.5) ** 2,
                        torch.tensor(0.0, dtype=F64), 3000, burnin=100,
                        seed=3)
    assert h.shape == (3000,) and h.dtype == np.float64
    assert abs(h.mean() - 1.0) < 0.1 and abs(h.std() - 0.5) < 0.05
    jh = mc.slice_sample(lambda x: -0.5 * ((x - 1.0) / 0.5) ** 2, 0.0, 50,
                         burnin=10)
    assert jh.shape == h[:50].shape
    x0 = torch.tensor([0.25, -0.5], dtype=F64)
    spike = mt.slice_sample(
        lambda x: torch.where((x == x0).all(), 0.0, -torch.inf),
        x0, 3, step_out=False)
    np.testing.assert_array_equal(spike, np.tile(x0.numpy(), (3, 1)))
