"""The port's PTMC, ASMC and AIES (runners/ptmc.py, asmc.py, aies.py)
against the JAX package's, on the CPU in float64.

- Each runner's move on injected draws is held to the JAX function's at
  1e-12: PTMC's ``untempered`` and swap (plain and prior tempering, the
  beta = 0 rung, gradients, an IMH ladder's cached candidate density) over
  several steps of a frozen sampler with the JAX run's uniforms, and after
  one real HMC, RWM and IMH step; ASMC's stages (delta, logZ increment,
  reweighting, ESS, the resample decision, the final equalization) with the
  JAX run's comb uniforms; ``_resample_idx`` on the same uniforms (equal
  indices); AIES's red-black half steps on the JAX run's draws, NaN
  ratios rejected.  The JAX draws are replayed from the JAX run's keys.
- Multinomial resampling is held by a chi-square test on counts.
- The JAX tests' statistical gates on the same configurations: PTMC
  crosses the bimodal target's modes, prior-tempered PTMC's TI and
  stepping-stone evidence, ASMC's conjugate logZ lies within 0.25, AIES
  recovers the affine-scaled Gaussian.
- Resumes, and JAX states carried over by ``utils.convert`` and continued
  (their first move the JAX move on the same draws)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mcmc_jl_tpu as mc
from mcmc_jl_tpu.runners import aies as jaies
from mcmc_jl_tpu.runners import asmc as jasmc
from mcmc_jl_tpu.runners import ptmc as jptmc
from mcmc_jl_tpu.samplers.base import RunCtx as JRunCtx
import mcmc_jl_tpu_torch as mt
from mcmc_jl_tpu_torch.runners import aies as taies
from mcmc_jl_tpu_torch.runners import asmc as tasmc
from mcmc_jl_tpu_torch.runners import ptmc as tptmc
from mcmc_jl_tpu_torch.samplers.base import RunCtx, make_generator

torch.set_num_threads(1)
F64 = torch.float64
EXACT = 1e-12
L2PI = float(np.log(2 * np.pi))


def as_dict(state):
    return {f.name: (as_dict(getattr(state, f.name))
                     if dataclasses.is_dataclass(getattr(state, f.name))
                     else np.asarray(getattr(state, f.name)))
            for f in dataclasses.fields(state)}


def close(got, want, tol=EXACT, err_msg=""):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol,
                               err_msg=err_msg)


# -- frozen samplers: their step is the identity, so a runner's own moves
#    are all that changes the state ------------------------------------------

class JFrozenRWM(mc.RWM):
    def step(self, model, ctx, state, key):
        return state, {"ppars": state.pars, "plogtarget": state.logtarget,
                       "logtarget": state.logtarget,
                       "accept": jnp.asarray(True)}


class JFrozenHMC(mc.HMC):
    def step(self, model, ctx, state, key):
        return state, {"ppars": state.pars, "plogtarget": state.logtarget,
                       "logtarget": state.logtarget,
                       "accept": jnp.asarray(True)}


def _frozen_info(state):
    return {"ppars": state.pars, "plogtarget": state.logtarget,
            "pars": state.pars, "logtarget": state.logtarget,
            "accept": torch.ones(state.logtarget.shape, dtype=torch.bool)}


class TFrozenRWM(mt.RWM):
    def step(self, model, ctx, state, generator):
        return state, _frozen_info(state)


class TFrozenHMC(mt.HMC):
    def step(self, model, ctx, state, generator):
        return state, _frozen_info(state)


# -- a two-parameter conjugate regression with a N(0, I) prior --------------

def _regression(n=30, seed=5):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n)
    y = 0.4 + 0.9 * x + rng.standard_normal(n)
    return x, y


def _reg_pair():
    """(JAX model, JAX logprior, port model, port logprior) of
    y_i ~ N(a + b x_i, 1), (a, b) ~ N(0, I)."""
    x, y = _regression()
    jx, jy = jnp.asarray(x), jnp.asarray(y)
    tx, ty = torch.tensor(x), torch.tensor(y)
    n = len(x)

    def jprior(th):
        return -0.5 * jnp.dot(th, th) - L2PI

    def jlogp(th):
        r = jy - th[0] - th[1] * jx
        return -0.5 * jnp.dot(r, r) - n / 2 * L2PI + jprior(th)

    def tprior(th):
        return -0.5 * (th * th).sum() - L2PI

    def tlogp(th):
        r = ty - th[0] - th[1] * tx
        return -0.5 * (r * r).sum() - n / 2 * L2PI + tprior(th)

    return (mc.model(jlogp, gradient=True, init=jnp.zeros(2)), jprior,
            mt.model(tlogp, gradient=True, init=np.zeros(2), dtype=F64,
                     device="cpu"), tprior)


def _ladder_start(jm, js, betas, jprior, seed, W):
    """W JAX ladders (W, K) initialized at scattered positions."""
    K = len(betas)
    th = np.random.default_rng(seed).standard_normal((W, K, 2)) * 0.8
    bv = jnp.asarray(betas)

    def one(th_w, k):
        return jax.vmap(lambda b, t, kk: js.init(
            jptmc._tempered_view(jm, b, jprior), t, kk))(
            bv, th_w, jax.random.split(k, K))

    return jax.vmap(one)(jnp.asarray(th), jax.random.split(
        jax.random.PRNGKey(seed), W))


PTMC_FROZEN = {
    # name: (sampler pair, state converter, betas, prior tempering, W, steps)
    "rwm_plain": ((JFrozenRWM(0.5), TFrozenRWM(0.5)),
                  mt.rwm_state_from_numpy, (0.1, 0.35, 0.7, 1.0), False, 1, 6),
    "hmc_prior_b0": ((JFrozenHMC(5, 0.1), TFrozenHMC(5, 0.1)),
                     mt.hmc_state_from_numpy, (0.0, 0.05, 0.3, 0.6, 1.0),
                     True, 2, 6),
}


@pytest.mark.parametrize("name", sorted(PTMC_FROZEN))
def test_ptmc_swaps_match_jax(name, monkeypatch):
    """Several steps of a frozen sampler, every step a swap (both
    parities): the port's loop on the JAX run's uniforms gives the JAX
    run's states, cold-rung rows, replica_ll and nswaps at 1e-12, W ladders
    as one batch."""
    (js, ts), conv, betas, prior, W, steps = PTMC_FROZEN[name]
    jm, jprior, tm, tprior = _reg_pair()
    jprior, tprior = (jprior, tprior) if prior else (None, None)
    K = len(betas)
    S0 = _ladder_start(jm, js, betas, jprior, 3, W)
    keys = jax.random.split(jax.random.PRNGKey(11), W)
    jS, jys = jax.vmap(lambda st, k: jptmc._ptmc_scan(
        jm, js, JRunCtx(burnin=0), st, k, steps=steps, swap_period=1,
        betas=betas, logprior=jprior))(S0, keys)

    def uniforms(w):
        for k in jax.random.split(keys[w], steps):
            yield np.asarray(jax.random.uniform(jax.random.split(k)[1], (K,),
                                                jnp.float64))

    draws = zip(*[uniforms(w) for w in range(W)])
    monkeypatch.setattr(tptmc, "_swap_uniforms",
                        lambda *a: torch.tensor(np.stack(next(draws))))
    flat = jax.tree_util.tree_map(lambda a: a.reshape((W * K,) + a.shape[2:]),
                                  S0)
    st = conv(as_dict(jax.device_get(flat)), device="cpu")
    tS, tys = tptmc._ptmc_loop(tm, ts, RunCtx(), st, make_generator("cpu", 0),
                               steps=steps, swap_period=1, betas=betas,
                               logprior=tprior)
    jflat = as_dict(jax.device_get(jax.tree_util.tree_map(
        lambda a: a.reshape((W * K,) + a.shape[2:]), jS)))
    for f in ("pars", "logtarget") + (("grad",) if "grad" in jflat else ()):
        close(getattr(tS, f), jflat[f], err_msg=f)
    for k in ("ppars", "plogtarget", "nswaps", "replica_ll"):
        close(tys[k], jys[k], err_msg=k)
    assert tys["nswaps"].sum() > 0 and tys["replica_ll"].shape == (W, steps,
                                                                   K)


def _jax_imh():
    mu, cov = np.array([0.3, 0.7]), np.array([[0.3, 0.05], [0.05, 0.2]])
    return mc.IMH(mc.MvNormal(jnp.asarray(mu), jnp.asarray(cov)))


PTMC_STEP = {
    "hmc_plain": (lambda: mc.HMC(4, 0.15), mt.hmc_state_from_numpy,
                  (0.2, 0.5, 1.0), False),
    "rwm_prior_b0": (lambda: mc.RWM(0.4), mt.rwm_state_from_numpy,
                     (0.0, 0.1, 0.4, 1.0), True),
    "hmc_prior_b0": (lambda: mc.HMC(4, 0.15), mt.hmc_state_from_numpy,
                     (0.0, 0.2, 0.6, 1.0), True),
    "imh_plain": (_jax_imh, mt.imh_state_from_numpy,
                  (0.25, 0.5, 0.75, 1.0), False),
}


@pytest.mark.parametrize("name", sorted(PTMC_STEP))
def test_ptmc_untempered_and_swap_after_a_step_match_jax(name):
    """One real step of every rung (JAX), then the port's ``untempered``
    and swap on the JAX run's uniform give the JAX run's ladder at 1e-12:
    gradients rebuilt at each rung's own beta, the beta = 0 rung's fresh
    likelihood, IMH's cached candidate density travelling with the
    position."""
    make, conv, betas, prior = PTMC_STEP[name]
    js = make()
    jm, jprior, tm, tprior = _reg_pair()
    jprior, tprior = (jprior, tprior) if prior else (None, None)
    K = len(betas)
    S0 = jax.tree_util.tree_map(lambda a: a[0],
                                _ladder_start(jm, js, betas, jprior, 4, 1))
    key = jax.random.PRNGKey(21)
    jS, jys = jptmc._ptmc_scan(jm, js, JRunCtx(burnin=0), S0, key, steps=1,
                               swap_period=1, betas=betas, logprior=jprior)
    k_step, k_swap = jax.random.split(jax.random.split(key, 1)[0])
    bv = jnp.asarray(betas)
    S1, _ = jax.jit(jax.vmap(lambda s, k, b: js.step(
        jptmc._tempered_view(jm, b, jprior), JRunCtx(burnin=0), s, k)))(
        S0, jax.random.split(k_step, K), bv)
    u = torch.tensor(np.asarray(jax.random.uniform(k_swap, (K,),
                                                   jnp.float64)))[None]
    st = conv(as_dict(jax.device_get(S1)), device="cpu")
    tb = torch.tensor(betas, dtype=F64)
    pri, gpri, ll, gll = tptmc._untempered(tm, st, tb, tprior,
                                           prior and betas[0] == 0.0)
    new, new_ll, nswaps = tptmc._swap(st, u, 1, tb, pri, gpri, ll, gll)
    want = as_dict(jax.device_get(jS))
    for f in ("pars", "logtarget", "grad", "logcandidate"):
        if f in want:
            close(getattr(new, f), want[f], err_msg=f)
    close(new_ll[0], jys["replica_ll"][0])
    close(nswaps[0], jys["nswaps"][0])


def _bimodal_pair(st=0.35):
    jm = mc.model(lambda v: jnp.sum(jnp.logaddexp(
        mc.Normal(-4.0, st).logpdf(v), mc.Normal(4.0, st).logpdf(v))),
        init=jnp.asarray([4.0]), gradient=True)
    tm = mt.model(lambda v: torch.logaddexp(
        mt.Normal(-4.0, st).logpdf(v), mt.Normal(4.0, st).logpdf(v)).sum(),
        init=np.array([4.0]), gradient=True, dtype=F64, device="cpu")
    return jm, tm


def test_ptmc_crosses_modes_and_swaps():
    """tests/test_ptmc.py's gate on its configuration, in both packages."""
    jm, tm = _bimodal_pair()
    kw = dict(steps=8000, burnin=1000, swap_period=5,
              betas=(0.02, 0.08, 0.25, 0.6, 1.0))
    for p, m in ((mt, tm), (mc, jm)):
        chain = p.run(m * p.RWM(0.5) * p.PTMC(**kw), seed=0)
        x = chain.samples.values[:, 0]
        assert 0.2 < np.mean(x < 0) < 0.8, (p.__name__, np.mean(x < 0))
        assert chain.diagnostics["nswaps"].sum() > 50
        assert 3.0 < x.std() < 5.0
        assert chain.diagnostics["replica_ll"].shape == (8000, 5)


def test_ptmc_walkers_batch_and_resume():
    """walkers = 4 ladders as one batch: each cold rung crosses the modes,
    the walkers differ; resume(list) continues every ladder from its stored
    state and generator state (the same bits twice)."""
    _, tm = _bimodal_pair()
    runner = mt.PTMC(steps=3000, burnin=500, swap_period=5,
                     betas=(0.02, 0.08, 0.25, 0.6, 1.0), walkers=4)
    chains = mt.run(tm, mt.RWM(0.5), runner, seed=0)
    assert isinstance(chains, list) and len(chains) == 4
    for c in chains:
        x = c.samples.values[:, 0]
        assert (x < -1).mean() > 0.03 and (x > 1).mean() > 0.03
        assert c.task.state.pars.shape == (5, 1)
    assert not np.allclose(chains[0].samples.values, chains[1].samples.values)
    more = mt.resume(chains, steps=300)
    again = mt.resume(chains, steps=300)
    assert len(more) == 4 and more[0].samples.values.shape == (300, 1)
    for a, b in zip(more, again):
        np.testing.assert_array_equal(a.samples.values, b.samples.values)
    assert more[0].task.pos == 3300
    assert sum(c.diagnostics["nswaps"].sum() for c in more) > 10


def test_ptmc_jax_ladder_continues_in_the_port():
    """A JAX PTMC chain's ladder state, carried over by the sampler's
    converter, resumes in the port: the cold rung keeps both modes."""
    jm, tm = _bimodal_pair()
    runner = mc.PTMC(steps=500, burnin=100, swap_period=5,
                     betas=(0.02, 0.1, 0.4, 1.0))
    jc = mc.run(jm * mc.RWM(0.5) * runner, seed=0)
    state = mt.rwm_state_from_numpy(as_dict(jax.device_get(jc.task.state)),
                                    device="cpu")
    assert state.pars.shape == (4, 1)
    task = mt.MCMCTask(tm, mt.RWM(0.5), mt.PTMC(
        steps=500, burnin=100, swap_period=5, betas=(0.02, 0.1, 0.4, 1.0)),
        state=state)
    more = mt.resume(task, steps=2500)
    x = more.samples.values[:, 0]
    assert more.samples.values.shape == (2500, 1)
    assert 0.15 < np.mean(x < 0) < 0.85
    assert more.diagnostics["nswaps"].sum() > 10


def test_tempered_view_refuses_other_rows():
    """Every chain must be evaluated with its own beta: a call on a subset
    of the batch's rows raises."""
    _, tm = _bimodal_pair()
    view = tptmc._tempered_view(tm, torch.tensor([0.5, 1.0], dtype=F64))
    lp = view.eval(torch.zeros(2, 1, dtype=F64))
    close(lp, 0.5 * tm.eval(torch.zeros(2, 1, dtype=F64)) * torch.tensor(
        [1.0, 2.0], dtype=F64))
    with pytest.raises(ValueError, match="its own beta"):
        view.evalallg(torch.zeros(1, 1, dtype=F64))


# -- ASMC --------------------------------------------------------------------

def _conjugate(p, n=20, seed=3):
    """tests/test_asmc.py's conjugate model in package ``p``."""
    rng = np.random.default_rng(seed)
    y = rng.standard_normal(n) + 0.7
    sy, yy = y.sum(), (y * y).sum()
    logz = -n / 2 * L2PI - 0.5 * np.log(1.0 + n) \
        - 0.5 * (yy - sy ** 2 / (1.0 + n))
    if p is mc:
        yd = jnp.asarray(y)

        def logprior(th):
            return -0.5 * th[0] ** 2 - 0.5 * L2PI

        def logp(th):
            return -0.5 * jnp.sum((yd - th[0]) ** 2) - n / 2 * L2PI \
                + logprior(th)

        m = mc.model(logp, gradient=True, init=jnp.zeros(1))
        prior_sample = lambda k: jax.random.normal(k, (1,))  # noqa: E731
    else:
        yd = torch.tensor(y)

        def logprior(th):
            return -0.5 * th[0] ** 2 - 0.5 * L2PI

        def logp(th):
            return -0.5 * ((yd - th[0]) ** 2).sum() - n / 2 * L2PI \
                + logprior(th)

        m = mt.model(logp, gradient=True, init=np.zeros(1), dtype=F64,
                     device="cpu")
        prior_sample = lambda g, k: torch.randn(  # noqa: E731
            (k, 1), generator=g, dtype=F64)
    return (m, logprior, prior_sample, float(logz), sy / (n + 1.0),
            1.0 / np.sqrt(n + 1.0))


@pytest.mark.parametrize("method", ["systematic", "stratified"])
def test_asmc_stages_match_jax(method, monkeypatch):
    """A frozen sampler's annealing on the regression posterior (several
    stages): on the JAX run's comb uniforms the port gives its stage
    count, schedule, ESS, logZ and final equalized particles at 1e-12."""
    jm, jprior, tm, tprior = _reg_pair()
    N = 256
    th0 = np.random.default_rng(9).standard_normal((N, 2))
    kw = dict(particles=N, target_ess=0.5, moves=1, resampling=method)
    jr = mc.ASMC(logprior=jprior, prior_sample=lambda k: None, **kw)
    js = JFrozenRWM(0.5)
    view0 = jptmc._tempered_view(jm, 0.0, jprior)
    jst = jax.vmap(lambda t: js.init(view0, t, None))(jnp.asarray(th0))
    key = jax.random.PRNGKey(5)
    out = jasmc._asmc_loop(jm, js, jr, jst, jnp.asarray(th0), key)
    n_stages = int(out["n_stages"])
    assert n_stages >= 3

    shape = () if method == "systematic" else (N,)
    us, k = [], key
    for _ in range(n_stages):
        k, _, k_res, _ = jax.random.split(k, 4)
        us.append(jax.random.uniform(k_res, shape, jnp.float64))
    us.append(jax.random.uniform(jax.random.fold_in(k, 777), shape,
                                 jnp.float64))
    draws = iter(us)
    monkeypatch.setattr(tasmc, "_comb_draw",
                        lambda *a: torch.tensor(np.asarray(next(draws))))
    tr = mt.ASMC(logprior=tprior, prior_sample=lambda g, n: None, **kw)
    ts = TFrozenRWM(0.5)
    th = torch.tensor(th0)
    zero = torch.zeros((), dtype=F64)
    tst = ts.init(tptmc._tempered_view(tm, zero, tprior), th)
    got = tasmc._asmc_loop(tm, ts, tr, tst, th, make_generator("cpu", 0))
    assert got["n_stages"] == n_stages
    for k in ("betas", "ess"):
        close(got[k], np.asarray(out[k])[:n_stages], err_msg=k)
    close(got["logZ"], out["logZ"])
    close(got["pars"], out["pars"])
    assert got["beta"] == pytest.approx(1.0)


def test_asmc_stage_weights_match_jax():
    """One stage's reweighting by hand against the JAX loop's first stage
    (max_stages = 1): delta, the logZ increment and the ESS; the resample
    decision fires at the ESS target."""
    jm, jprior, tm, tprior = _reg_pair()
    N = 300
    th0 = np.random.default_rng(2).standard_normal((N, 2))
    jr = mc.ASMC(particles=N, max_stages=1, logprior=jprior,
                 prior_sample=lambda k: None)
    js = JFrozenRWM(0.5)
    jst = jax.vmap(lambda t: js.init(jptmc._tempered_view(jm, 0.0, jprior),
                                     t, None))(jnp.asarray(th0))
    out = jasmc._asmc_loop(jm, js, jr, jst, jnp.asarray(th0),
                           jax.random.PRNGKey(0))
    th = torch.tensor(th0)
    ll = tm.eval(th) - tptmc._prior_fns(tprior)[0](th)
    logW = torch.full((N,), -np.log(N), dtype=F64)
    delta, inc, logW2, ess = tasmc._stage_weights(
        logW, ll, torch.zeros((), dtype=F64), 0.5 * N)
    close(delta, out["beta"])
    close(inc, out["logZ"])
    close(ess, np.asarray(out["ess"])[0])
    close(tasmc._ess_of(logW2), ess)
    assert bool(ess <= 0.5 * N + 1.0)


@pytest.mark.parametrize("method", ["systematic", "stratified"])
def test_resample_idx_matches_jax(method):
    """The comb resamplers on the JAX draw's uniforms: equal indices."""
    rng = np.random.default_rng(1)
    N = 500
    logW = rng.standard_normal(N) * 2.0
    for s in range(4):
        key = jax.random.PRNGKey(s)
        want = np.asarray(jasmc._resample_idx(key, jnp.asarray(logW), N,
                                              method))
        u = jax.random.uniform(key, () if method == "systematic" else (N,),
                               jnp.float64)
        got = tasmc._comb_idx(torch.softmax(torch.tensor(logW), 0),
                              torch.tensor(np.asarray(u)))
        np.testing.assert_array_equal(got.numpy(), want)


def test_multinomial_resampling_chi_square():
    """Multinomial ancestors' counts against N * w: a chi-square test."""
    from scipy import stats

    w = np.array([0.4, 0.25, 0.15, 0.1, 0.06, 0.04])
    N, reps = 600, 20
    g = make_generator("cpu", 3)
    counts = np.zeros(len(w))
    logW = torch.tensor(np.log(w) + 1.7)
    for _ in range(reps):
        idx = tasmc._resample_idx(g, logW, N, "multinomial")
        counts += np.bincount(idx.numpy(), minlength=len(w))
    expect = w * N * reps
    p = stats.chisquare(counts, expect).pvalue
    assert p > 1e-3, (counts, expect, p)


def test_asmc_conjugate_logz_and_posterior():
    """tests/test_asmc.py's gates on its configuration, in both
    packages."""
    for p in (mt, mc):
        m, logprior, prior_sample, logz, mu, sd = _conjugate(p)
        runner = p.ASMC(particles=2048, target_ess=0.5, moves=3,
                        logprior=logprior, prior_sample=prior_sample)
        chain = p.run(m * p.RWM(0.5) * runner, seed=0)
        d = chain.diagnostics
        assert abs(d["logz"] - logz) < 0.25, (p.__name__, d["logz"], logz)
        x = chain.samples.values[:, 0]
        assert abs(x.mean() - mu) < 4 * sd / np.sqrt(200)
        assert abs(x.std(ddof=1) - sd) < 0.25 * sd
        b = d["betas"]
        assert b[-1] == pytest.approx(1.0)
        assert np.all(np.diff(np.concatenate([[0.0], b])) > 0)
        assert d["n_stages"] >= 2
        assert np.all(d["ess"][:-1] < 0.6 * 2048)


def test_asmc_hmc_moves_and_resume():
    """HMC rejuvenation through the prior-tempered view (tests/test_asmc.py
    ``test_asmc_hmc_moves_match_rwm``), then resume: more moves at the full
    posterior, the same bits twice from one chain, and again from the
    result."""
    m, logprior, prior_sample, logz, mu, sd = _conjugate(mt)
    runner = mt.ASMC(particles=1024, target_ess=0.5, moves=2,
                     logprior=logprior, prior_sample=prior_sample)
    chain = mt.run(m * mt.HMC(5, 0.3) * runner, seed=1)
    assert abs(chain.diagnostics["logz"] - logz) < 0.3
    assert abs(chain.samples.values[:, 0].mean() - mu) < 0.1
    assert np.mean(chain.diagnostics["accept"]) > 0.5
    assert tuple(chain.task.state.shape) == (1024, 1)
    c2 = mt.resume(chain, steps=20)
    c3 = mt.resume(chain, steps=20)
    np.testing.assert_array_equal(c2.samples.values, c3.samples.values)
    x = c2.samples.values[:, 0]
    assert abs(x.mean() - mu) < 6 * sd / np.sqrt(100) + 0.05
    assert abs(x.std() - sd) < 0.1
    assert c2.diagnostics["accept"] > 0.1
    assert c2.task.pos == chain.task.pos + 20
    c4 = mt.resume(c2, steps=5)
    assert np.all(np.isfinite(c4.samples.values))


def test_asmc_jax_ensemble_continues_in_the_port():
    """A JAX ASMC chain's final particles, carried over, resume in the
    port at the full posterior."""
    jm, jprior, jps, _, mu, sd = _conjugate(mc)
    jc = mc.run(jm * mc.RWM(0.5) * mc.ASMC(particles=512, logprior=jprior,
                                           prior_sample=jps), seed=0)
    m, logprior, ps, _, _, _ = _conjugate(mt)
    th = mt.ensemble_from_numpy(jax.device_get(jc.task.state), device="cpu")
    assert th.dtype == F64 and th.shape == (512, 1)
    task = mt.MCMCTask(m, mt.RWM(0.5), mt.ASMC(particles=512,
                                               logprior=logprior,
                                               prior_sample=ps),
                       state=th, pos=jc.task.pos)
    c = mt.resume(task, steps=20)
    x = c.samples.values[:, 0]
    assert abs(x.mean() - mu) < 6 * sd / np.sqrt(100) + 0.05
    assert abs(x.std() - sd) < 0.1


# -- AIES --------------------------------------------------------------------

def _aies_pair(kind):
    """(JAX per-vector log-density, the port's over rows), d 3: a
    correlated Gaussian, or one whose log-density is NaN past x_0 = 1 and
    -inf below x_1 = -1.5 (NaN and -inf - -inf ratios both reject)."""
    P = np.array([[2.0, 0.6, 0.0], [0.6, 1.0, 0.3], [0.0, 0.3, 0.5]])
    jP, tP = jnp.asarray(P), torch.tensor(P)

    def jf(v):
        lp = -0.5 * v @ jP @ v
        if kind == "nan":
            lp = jnp.where(v[0] > 1.0, jnp.nan, lp)
            lp = jnp.where(v[1] < -1.5, -jnp.inf, lp)
        return lp

    def tf(v):
        lp = -0.5 * torch.einsum("ci,ij,cj->c", v, tP, v)
        if kind == "nan":
            lp = torch.where(v[:, 0] > 1.0, torch.nan, lp)
            lp = torch.where(v[:, 1] < -1.5, -torch.inf, lp)
        return lp

    return jf, tf


@pytest.mark.parametrize("kind", ["gauss", "nan"])
def test_aies_half_steps_match_jax(kind, monkeypatch):
    """The red-black sweeps on the JAX run's draws (stretch uniforms,
    partners, log-uniforms), from a JAX AIES run's ensemble carried over
    (``ensemble_from_numpy``): the port's ensemble, rows and accept flags
    equal the JAX run's at 1e-12."""
    jf, tf = _aies_pair(kind)
    W, d, a, steps = 16, 3, 2.0, 5
    jm = mc.model(jf, init=jnp.zeros(d), check_init=False)
    jc = mc.run(jm * mc.AIES(steps=30, walkers=W, jitter=0.4), seed=1)
    pars0, lp0 = jax.device_get(jc[0].task.state)
    if kind == "nan":  # walkers on both bad sides start at -inf
        pars0 = np.array(pars0)
        pars0[:2, 1] = -2.0
        lp0 = np.asarray(jax.vmap(jf)(jnp.asarray(pars0)))
    key = jax.random.PRNGKey(17)
    (jp, jl), jys = jaies._aies_scan(jf, jnp.asarray(pars0), jnp.asarray(lp0),
                                     key, steps=steps, a=a, d=d)
    H = W // 2

    def half_draws():
        for k in jax.random.split(key, steps):
            for kh in jax.random.split(k):
                kz, kj, ku = jax.random.split(kh, 3)
                yield (torch.tensor(np.asarray(jax.random.uniform(
                           kz, (H,), jnp.float64))),
                       torch.tensor(np.asarray(jax.random.randint(
                           kj, (H,), 0, H)), dtype=torch.int64),
                       torch.tensor(np.asarray(jnp.log(jax.random.uniform(
                           ku, (H,), jnp.float64)))))

    draws = half_draws()
    monkeypatch.setattr(taies, "_half_draws", lambda *a: next(draws))
    tp0, tl0 = mt.ensemble_from_numpy(pars0, lp0, device="cpu")
    (tp, tl), tys = taies._aies_loop(tf, tp0, tl0, make_generator("cpu", 0),
                                     steps=steps, a=a)
    close(tp, jp)
    close(tl, jl)
    for k in ("ppars", "plogtarget"):
        close(tys[k], jys[k], err_msg=k)
    np.testing.assert_array_equal(tys["accept"].numpy(),
                                  np.asarray(jys["accept"]))
    acc = tys["accept"].numpy()
    assert 0 < acc.sum() < acc.size
    if kind == "nan":
        assert torch.all(tys["ppars"][:, :, 0] <= 1.0)


def test_aies_affine_scaled_gaussian():
    """tests/test_aies.py's affine-invariance gate on its configuration, in
    both packages: the ill-conditioned posterior's scales are recovered,
    and the mixing matches the isotropic one's within a factor 2."""
    d, s = 3, np.array([100.0, 1.0, 0.01])
    r = dict(steps=2000, burnin=500, walkers=16)
    js, ts = jnp.asarray(s), torch.tensor(s)
    pairs = (
        (mt, mt.model(lambda v: -0.5 * (v * v).sum(), init=np.zeros(d),
                      check_init=False, dtype=F64, device="cpu"),
         mt.model(lambda v: -0.5 * ((v / ts) ** 2).sum(), init=np.zeros(d),
                  check_init=False, dtype=F64, device="cpu").with_scale(ts)),
        (mc, mc.model(lambda v: -0.5 * jnp.dot(v, v), init=jnp.zeros(d),
                      check_init=False),
         mc.model(lambda v: -0.5 * jnp.dot(v / js, v / js),
                  init=jnp.zeros(d), check_init=False).with_scale(js)))
    for p, m_iso, m_bad in pairs:
        ess_iso = np.mean([np.min(p.ess(c)) for c in
                           p.run(m_iso * p.AIES(**r), seed=1)])
        bad = p.run(m_bad * p.AIES(**r), seed=1)
        ess_bad = np.mean([np.min(p.ess(c)) for c in bad])
        assert 0.5 < ess_bad / ess_iso < 2.0, (p.__name__, ess_iso, ess_bad)
        x = np.concatenate([c.samples.values for c in bad], axis=0)
        np.testing.assert_allclose(x.std(axis=0, ddof=1), s, rtol=0.25)


def test_aies_resume_continues_ensemble():
    """tests/test_aies.py's resume test on the port: any walker's chain
    resumes the whole ensemble, the same bits from any of them, and the
    list form resumes once."""
    m = mt.model(lambda v: -0.5 * (v * v).sum(), init=np.zeros(2),
                 check_init=False, dtype=F64, device="cpu")
    chains = mt.run(m * mt.AIES(steps=400, burnin=100, walkers=16), seed=0)
    assert len(chains) == 16 and chains[0].samples.nrow == 300
    pars0, _ = chains[0].task.state
    cont = mt.resume(chains[0], steps=200)
    assert len(cont) == 16 and cont[0].samples.nrow == 200
    first = np.stack([c.samples.values[0] for c in cont])
    assert np.abs(first - pars0.numpy()).max() < 3.0
    cont2 = mt.resume(chains[3], steps=200)
    np.testing.assert_array_equal(cont[5].samples.values,
                                  cont2[5].samples.values)
    cont3 = mt.resume(chains, steps=50)
    assert len(cont3) == 16 and cont3[0].samples.nrow == 50
    assert cont3[0].task.pos == 450


VALIDATION = {
    "ptmc_descending": lambda p: p.PTMC(betas=(1.0, 0.5)),
    "ptmc_no_target": lambda p: p.PTMC(betas=(0.2, 0.7)),
    "ptmc_b0_without_prior": lambda p: p.PTMC(betas=(0.0, 0.5, 1.0)),
    "asmc_no_prior": lambda p: p.ASMC(logprior=None,
                                      prior_sample=lambda *a: 0.0),
    "asmc_no_sampler": lambda p: p.ASMC(logprior=lambda t: 0.0,
                                        prior_sample=None),
    "aies_odd": lambda p: p.AIES(walkers=7),
    "aies_scale": lambda p: p.AIES(a=1.0),
    "aies_too_few": lambda p: p.run(p.model(
        lambda v: -(v * v).sum(), init=np.zeros(4), check_init=False,
        **({} if p is mc else dict(device="cpu")))
        * p.AIES(steps=10, walkers=8), seed=0),
}


@pytest.mark.parametrize("name", sorted(VALIDATION))
def test_validation_matches_jax(name):
    for p in (mt, mc):
        with pytest.raises(AssertionError):
            VALIDATION[name](p)


def test_dispatch_refusals():
    """Mixed runner types, a list of PTMC tasks and prun of an ensemble
    runner raise TypeError, as the JAX package refuses them."""
    m = mt.model(lambda v: -(v * v).sum(), init=np.zeros(1), device="cpu")
    mixed = [m * mt.RWM(0.5) * mt.SerialMC(steps=10),
             m * mt.RWM(0.5) * mt.SeqMC(steps=2)]
    with pytest.raises(TypeError, match="same runner type"):
        mt.run(mixed)
    ladders = [m * mt.RWM(0.5) * mt.PTMC(steps=10, betas=(0.5, 1.0))] * 2
    with pytest.raises(TypeError, match="unknown runner type"):
        mt.run(ladders)
    with pytest.raises(TypeError, match="prun supports SerialMC"):
        mt.prun(ladders)


def test_prior_tempered_ptmc_evidence():
    """tests/test_evidence.py ``test_logz_rwm`` on its configuration (the
    JAX package's run is that test): thermodynamic integration within 0.35
    and stepping-stone within 0.25 of the analytic logZ, from the ladder's
    replica_ll and betas; swaps happen and the rungs' mean log-likelihood
    rises with beta."""
    m, logprior, _, logz, _, _ = _conjugate(mt)
    betas = tuple(float((k / 7) ** 5) for k in range(8))
    chain = mt.run(m * mt.RWM(0.8) * mt.PTMC(
        steps=4000, burnin=500, swap_period=5, betas=betas,
        logprior=logprior), seed=0)
    ti = mt.logz_ti(chain, burnin=500)
    ss = mt.logz_ss(chain, burnin=500)
    assert abs(ti - logz) < 0.35, (ti, logz)
    assert abs(ss - logz) < 0.25, (ss, logz)
    assert chain.diagnostics["nswaps"].sum() > 50
    ll = chain.diagnostics["replica_ll"]
    assert ll.shape == (4000, 8)
    assert np.all(np.diff(ll[500:].mean(axis=0)) > -0.5)
