"""The port's SeqMC and SerialTempMC (runners/seqmc.py, serialtempmc.py)
against the JAX package's, on the CPU in float64.

- Moves on injected draws at 1e-12: SeqMC's ladder passes (weight update,
  the reference-exact ``logtarget`` reset after every pass, the
  variance and ESS triggers, systematic and stratified resampling on the
  JAX run's comb uniforms) with frozen samplers against ``_seqmc_scan``;
  ``_resample`` on the same uniforms (equal indices); SerialTempMC's rung
  pick, swap and Wang-Landau step with a deterministic drift sampler on
  the JAX run's rung picks and log-uniforms against ``_temp_scan``.
- Multinomial resampling is held by a chi-square test on counts.
- tests/test_runners.py's moment gates on its configurations, in both
  packages; resumes; JAX ladder states carried over by ``utils.convert``
  and continued, their first move the JAX move on the same draws."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mcmc_jl_tpu as mc
from mcmc_jl_tpu.runners import seqmc as jseqmc
from mcmc_jl_tpu.runners import serialtempmc as jtemp
from mcmc_jl_tpu.samplers.base import RunCtx as JRunCtx
import mcmc_jl_tpu_torch as mt
from mcmc_jl_tpu_torch.runners import asmc as tasmc
from mcmc_jl_tpu_torch.runners import seqmc as tseqmc
from mcmc_jl_tpu_torch.runners import serialtempmc as ttemp
from mcmc_jl_tpu_torch.samplers.base import RunCtx, make_generator
from mcmc_jl_tpu_torch.samplers.rwm import RWMState

from test_torch_ensemble import (JFrozenRWM, TFrozenRWM, as_dict, close)

torch.set_num_threads(1)
F64 = torch.float64


def _abs_normal(p, st, x0, gradient=False):
    """tests/test_runners.py's |x| ~ Normal(1, st) DSL model."""
    if p is mc:
        def ex(x, _st=st):
            mc.tilde(jnp.abs(x), mc.Normal(1.0, _st))
        return mc.model(ex, x=x0, gradient=gradient)

    def ex(x, _st=st):
        mt.tilde(torch.abs(x), mt.Normal(1.0, _st))
    return mt.model(ex, x=x0, gradient=gradient, dtype=F64, device="cpu")


def _gauss(p, sd, mu=0.0):
    """A 1-d N(mu, sd^2) callable model in package ``p``."""
    if p is mc:
        return mc.model(lambda v: -0.5 * jnp.sum(((v - mu) / sd) ** 2),
                        init=jnp.asarray([0.3]))
    return mt.model(lambda v: -0.5 * (((v - mu) / sd) ** 2).sum(),
                    init=np.array([0.3]), dtype=F64, device="cpu")


# -- SeqMC -------------------------------------------------------------------

SEQ_CASES = {
    # name: (resampling, trigger, ess_trigger)
    "systematic_always": ("systematic", np.inf, None),
    "stratified_ess": ("stratified", 1e-10, 0.7),
    "never": ("systematic", 0.0, None),
}


@pytest.mark.parametrize("name", sorted(SEQ_CASES))
def test_seqmc_passes_match_jax(name, monkeypatch):
    """Frozen samplers on a ladder of three Gaussians: the port's loop on
    the JAX run's comb uniforms gives the JAX run's particles, weights and
    weight variances at every pass, at 1e-12.  With no resampling the
    weights show the logtarget reset (each pass's first update is ll0 - 0,
    not a ratio against the last target)."""
    method, trigger, ess_trigger = SEQ_CASES[name]
    sds, npart, steps = (3.0, 1.5, 0.8), 64, 4
    jms = [_gauss(mc, s, 0.2 * i) for i, s in enumerate(sds)]
    tms = [_gauss(mt, s, 0.2 * i) for i, s in enumerate(sds)]
    pars = np.random.default_rng(0).standard_normal((npart, 1)) * 2.0
    js, ts = JFrozenRWM(0.5), TFrozenRWM(0.5)
    jst = tuple(jax.vmap(lambda th, _m=m: js.init(_m, th, None))(
        jnp.asarray(pars)) for m in jms)
    key = jax.random.PRNGKey(4)
    ctxs = (JRunCtx(burnin=0),) * 3
    jS, (jp, jW, jv) = jseqmc._seqmc_scan(
        tuple(jms), (js,) * 3, ctxs, jst, jnp.asarray(pars),
        jnp.zeros(npart), key, steps=steps, trigger=trigger,
        ess_trigger=ess_trigger, resampling=method)

    shape = () if method == "systematic" else (npart,)
    us = [jax.random.uniform(jax.random.fold_in(k, 2 * ti + 1), shape,
                             jnp.float64)
          for k in jax.random.split(key, steps) for ti in range(3)]
    draws = iter(us)
    monkeypatch.setattr(tasmc, "_comb_draw",
                        lambda *a: torch.tensor(np.asarray(next(draws))))
    th = torch.tensor(pars)
    tst = [ts.init(m, th) for m in tms]
    tS, tp, tlogW, ys = tseqmc._seqmc_loop(
        tms, [ts] * 3, [RunCtx()] * 3, tst, th, torch.zeros(npart, dtype=F64),
        make_generator("cpu", 0), steps=steps, trigger=trigger,
        ess_trigger=ess_trigger, resampling=method)
    close(ys["pars"], jp)
    close(ys["W"], jW)
    close(ys["var"], jv)
    for a, b in zip(tS, jS):
        close(a.pars, b.pars)
        close(a.logtarget, b.logtarget)
    if name == "never":  # the reset: pass 2's weights restart from ll0 - 0
        w = ys["W"].numpy()
        assert not np.allclose(w[1], w[0])


@pytest.mark.parametrize("method", ["systematic", "stratified"])
def test_seqmc_resample_matches_jax(method):
    """``_resample`` on the JAX draw's uniforms: equal particles, zeroed
    log-weights and log-targets (the low-variance comb of
    tests/test_runners.py)."""
    logW = jnp.log(jnp.asarray([0.5, 0.25, 0.125, 0.125])) + jnp.log(4.0)
    pars, lt = jnp.arange(4.0)[:, None], jnp.arange(4.0) * 0.1
    for s in range(16):
        key = jax.random.PRNGKey(s)
        want = jseqmc._resample(pars, logW, lt, key, trigger=np.inf,
                                ess_trigger=None, method=method)
        u = jax.random.uniform(key, () if method == "systematic" else (4,),
                               jnp.float64)
        W = torch.exp(torch.tensor(np.asarray(logW)))
        idx = tasmc._comb_idx(W / W.sum(), torch.tensor(np.asarray(u)))
        got = tseqmc._resample_given(
            torch.tensor(np.asarray(pars)), torch.tensor(np.asarray(logW)),
            torch.tensor(np.asarray(lt)), idx, torch.tensor(True))
        for a, b in zip(got, want):
            close(a, b)


def test_seqmc_multinomial_chi_square():
    """Multinomial resampling (the reference's scheme) of fixed weights:
    the ancestors' counts against N * w by a chi-square test."""
    from scipy import stats

    w = np.array([0.5, 0.2, 0.15, 0.1, 0.05])
    N, reps = 500, 20
    pars = torch.arange(5.0, dtype=F64)[:, None].repeat_interleave(
        torch.tensor([100] * 5), 0)
    logW = torch.log(torch.tensor(np.repeat(w / 100, 100) * N))
    g = make_generator("cpu", 5)
    counts = np.zeros(5)
    for _ in range(reps):
        p2, w2, _ = tseqmc._resample(pars, logW, torch.zeros(N, dtype=F64), g,
                                     trigger=np.inf, ess_trigger=None)
        assert torch.all(w2 == 0)
        counts += np.bincount(p2[:, 0].long().numpy(), minlength=5)
    p = stats.chisquare(counts, w * N * reps).pvalue
    assert p > 1e-3, (counts, p)


def _readme_targets(p, runner_kw):
    nmod = 6
    sts = np.logspace(1, -1, nmod)
    return [_abs_normal(p, st, 0.0) * p.RWM(float(st)) * p.SeqMC(**runner_kw)
            for st in sts]


@pytest.mark.parametrize("resampling", ["multinomial", "systematic"])
def test_seqmc_readme_example2(resampling):
    """tests/test_runners.py's README example 2 (and its systematic
    variant) on its configuration, in both packages."""
    kw = dict(steps=10, burnin=0)
    if resampling == "systematic":
        kw.update(ess_trigger=0.5, resampling="systematic")
    particles = np.random.default_rng(0).standard_normal((300, 1))
    for p in (mt, mc):
        chain = p.run(_readme_targets(p, kw), particles=particles)
        assert chain.samples.shape == (3000, 1)
        assert chain.samples.columns == ["x"]
        w = chain.diagnostics["weigths"]
        assert w.shape == (3000,) and np.all(np.isfinite(w))
        assert np.all(np.isfinite(chain.samples.values))
        xs = chain.samples["x"]
        est = np.abs(np.sum(w / w.sum() * np.abs(xs)))
        assert 0.5 < est < 1.5, (p.__name__, est)


def test_seqmc_resume_carries_sampler_states():
    """tests/test_runners.py's resume tests on the port: the particles,
    weights and per-target NUTS dual-averaging states carry over, and the
    resumed run draws on from the stored generator state."""
    targets = [_abs_normal(mt, st, 0.0, gradient=True)
               * mt.NUTS(maxdoublings=4)
               * mt.SeqMC(steps=4, burnin=0) for st in (1.0, 0.5)]
    chain = mt.run(targets,
                   particles=np.random.default_rng(1).standard_normal((50, 1)))
    carry = chain.task[-1].state
    assert set(carry) == {"pars", "logW", "states"}
    assert carry["pars"].shape == (50, 1) and carry["logW"].shape == (50,)
    eps_before = carry["states"][0].epsilon.clone()
    assert eps_before.shape == (50,)
    chain2 = mt.resume(chain.task, steps=3)
    assert chain2.samples.shape == (150, 1)
    eps_after = chain2.task[-1].state["states"][0].epsilon
    assert not torch.allclose(eps_after, eps_before)
    assert np.all(np.isfinite(chain2.samples.values))
    again = mt.resume(chain.task, steps=3)
    np.testing.assert_array_equal(chain2.samples.values, again.samples.values)
    assert chain2.task[0].pos == 7


def test_seqmc_jax_ladder_continues_in_the_port(monkeypatch):
    """A JAX SeqMC run's carried particles, weights and RWM states,
    carried over by ``seqmc_state_from_numpy``: the port's first ladder
    pass from them with frozen samplers on the JAX run's uniforms equals
    the JAX one from the same carry; then a real resume runs."""
    jt = _readme_targets(mc, dict(steps=3, burnin=0, ess_trigger=0.5,
                                  resampling="systematic"))
    jc = mc.run(jt, particles=np.random.default_rng(2).standard_normal(
        (120, 1)))
    jcarry = jc.task[-1].state
    carry = mt.seqmc_state_from_numpy(
        {"pars": jcarry["pars"], "logW": jcarry["logW"],
         "states": [as_dict(s) for s in jcarry["states"]]},
        mt.rwm_state_from_numpy, device="cpu")
    assert isinstance(carry["states"][0], RWMState)
    assert carry["pars"].dtype == F64

    jms = [t.model for t in jt]
    tt = _readme_targets(mt, dict(steps=3, burnin=0, ess_trigger=0.5,
                                  resampling="systematic"))
    tms = [t.model for t in tt]
    js, ts = JFrozenRWM(0.5), TFrozenRWM(0.5)
    key = jax.random.PRNGKey(8)
    jstates = tuple(jax.tree_util.tree_map(jnp.asarray, s)
                    for s in jcarry["states"])
    _, (jp, jW, _) = jseqmc._seqmc_scan(
        tuple(jms), (js,) * 6, (JRunCtx(burnin=0),) * 6, jstates,
        jnp.asarray(jcarry["pars"]), jnp.asarray(jcarry["logW"]), key,
        steps=1, trigger=1e-10, ess_trigger=0.5, resampling="systematic")
    k = jax.random.split(key, 1)[0]
    draws = iter([jax.random.uniform(jax.random.fold_in(k, 2 * ti + 1), (),
                                     jnp.float64) for ti in range(6)])
    monkeypatch.setattr(tasmc, "_comb_draw",
                        lambda *a: torch.tensor(np.asarray(next(draws))))
    _, _, _, ys = tseqmc._seqmc_loop(
        tms, [ts] * 6, [RunCtx()] * 6, carry["states"], carry["pars"],
        carry["logW"], make_generator("cpu", 0), steps=1, trigger=1e-10,
        ess_trigger=0.5, resampling="systematic")
    close(ys["pars"], jp)
    close(ys["W"], jW)
    monkeypatch.undo()

    tasks = [mt.MCMCTask(t.model, t.sampler, t.runner, state=carry)
             for t in tt]
    c = mt.resume(tasks, steps=5)
    assert c.samples.shape == (600, 1)
    w = c.diagnostics["weigths"]
    est = np.abs(np.sum(w / w.sum() * np.abs(c.samples["x"])))
    assert 0.5 < est < 1.5, est


# -- SerialTempMC ------------------------------------------------------------

class JDrift(mc.RWM):
    """A deterministic step: x -> x + scale."""

    def step(self, model, ctx, state, key):
        new = state.pars + self.scale
        lp = model.eval(new)
        return (state.replace(pars=new, logtarget=lp, i=state.i + 1),
                {"ppars": new, "plogtarget": lp, "pars": state.pars,
                 "logtarget": state.logtarget, "accept": jnp.asarray(True)})


class TDrift(mt.RWM):
    def step(self, model, ctx, state, generator):
        new = state.pars + self.scale
        lp = model.eval(new)
        return (state.replace(pars=new, logtarget=lp, i=state.i + 1),
                {"ppars": new, "plogtarget": lp, "pars": state.pars,
                 "logtarget": state.logtarget,
                 "accept": torch.ones((), dtype=torch.bool)})


@pytest.mark.parametrize("adapt", [False, True])
def test_serialtempmc_swaps_match_jax(adapt, monkeypatch):
    """A drift sampler on a ladder of four Gaussians: on the JAX run's rung
    picks and log-uniforms the port's walker (positions, rungs), its
    weights (Wang-Landau) and the rung states equal the JAX ``_temp_scan``
    run's at 1e-12."""
    sds = (4.0, 2.0, 1.0, 0.5)
    steps, burnin, period = 60, 10, 2
    jms = [_gauss(mc, s) for s in sds]
    tms = [_gauss(mt, s) for s in sds]
    js, ts = JDrift(0.05), TDrift(0.05)
    jstates = [js.init(m, m.init, None) for m in jms]
    ctx = JRunCtx(burnin=burnin)
    _, info0 = js.step(jms[0], ctx, jstates[0], None)
    stacked = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *jstates)
    key = jax.random.PRNGKey(6)
    jS, jlogW, jpars, jat = jtemp._temp_scan(
        tuple(jms), (js,) * 4, (ctx,) * 4, stacked, info0["ppars"],
        info0["plogtarget"], key, steps=steps, swap_period=period,
        adapt_weights=adapt, stacked=True)

    def draws():
        for i, k in enumerate(jax.random.split(key, steps), start=1):
            if i % period == 0:
                _, k_pick, k_acc = jax.random.split(k, 3)
                yield (int(jax.random.randint(k_pick, (), 0, 3,
                                              dtype=jnp.int32)),
                       torch.tensor(float(jnp.log(jax.random.uniform(
                           k_acc, ()))), dtype=F64))

    it = draws()
    monkeypatch.setattr(ttemp, "_swap_draws", lambda *a: next(it))
    runner = mt.SerialTempMC(steps=steps, burnin=burnin, swap_period=period,
                             adapt_weights=adapt)
    chain = mt.run([m * ts * runner for m in tms])
    close(chain.samples.values, np.asarray(jpars)[burnin:])
    np.testing.assert_array_equal(chain.diagnostics["mod"],
                                  np.asarray(jat)[burnin:] + 1)
    close(chain.diagnostics["logW"], jlogW)
    assert len(np.unique(chain.diagnostics["mod"])) > 1
    rungs = chain.task[-1].state["states"]
    close(torch.stack([s.pars for s in rungs]), jS.pars)
    close(torch.stack([s.logtarget for s in rungs]), jS.logtarget)


def test_serialtempmc_helpers():
    """The rung pick skips the current rung; a NaN ratio rejects; the
    Wang-Landau step lowers the current rung's weight by 1/i."""
    assert [ttemp._pick_rung(r, 1) for r in range(3)] == [0, 2, 3]
    logW = torch.zeros(3, dtype=F64)
    nan = torch.tensor(float("nan"), dtype=F64)
    assert not ttemp._swap_take(nan, torch.tensor(0.0, dtype=F64), logW, 0, 1,
                                torch.tensor(-5.0, dtype=F64))
    assert ttemp._swap_take(torch.tensor(0.0, dtype=F64),
                            torch.tensor(-1.0, dtype=F64), logW, 0, 1,
                            torch.tensor(0.5, dtype=F64))
    close(ttemp._wang_landau(logW, 2, 4), [0.0, 0.0, -0.25])


def test_serialtempmc():
    """tests/test_runners.py ``test_serialtempmc`` on its configuration, in
    both packages; then resume continues the walker and the rung states."""
    sts = np.logspace(0.5, -0.5, 4)
    chains = {}
    for p in (mt, mc):
        tasks = [_abs_normal(p, st, 0.5) * p.RWM(float(st))
                 * p.SerialTempMC(steps=2000, burnin=200, swap_period=5)
                 for st in sts]
        chains[p] = chain = p.run(tasks)
        assert chain.samples.shape == (1800, 1)
        assert np.all(np.isfinite(chain.samples.values))
        rungs = chain.diagnostics["mod"]
        assert rungs.min() >= 1 and rungs.max() <= 4
        assert len(np.unique(rungs)) > 1
    more = mt.resume(chains[mt].task, steps=200)
    assert more.samples.shape == (200, 1)
    assert np.all(np.isfinite(more.samples.values))


def test_serialtempmc_heterogeneous_and_resume():
    """tests/test_runners.py's mixed ladder (RWM, MALA, NUTS) on the one
    host loop; ``compiled=False`` is the same run; resume continues from
    the carried rung states and walker, the same bits twice."""
    def ex1(x):
        mt.tilde(torch.abs(x), mt.Normal(1.0, 2.0))

    def ex2(x):
        mt.tilde(torch.abs(x), mt.Normal(1.0, 0.5))

    m1 = mt.model(ex1, x=0.5, gradient=True, dtype=F64, device="cpu")
    m2 = mt.model(ex2, x=0.5, gradient=True, dtype=F64, device="cpu")
    tasks = [m1 * mt.RWM(1.0) * mt.SerialTempMC(steps=300, burnin=50),
             m2 * mt.MALA(0.3) * mt.SerialTempMC(steps=300, burnin=50),
             m2 * mt.NUTS(maxdoublings=4)
             * mt.SerialTempMC(steps=300, burnin=50)]
    chain = mt.run(tasks)
    assert chain.samples.shape == (250, 1)
    assert np.all(np.isfinite(chain.samples.values))
    assert set(np.unique(chain.diagnostics["mod"])) <= {1, 2, 3}
    host = mt.run(tasks, compiled=False)
    np.testing.assert_array_equal(host.samples.values, chain.samples.values)
    carry = chain.task[-1].state
    assert len(carry["states"]) == 3 and carry["pars"].shape == (1,)
    more = mt.resume(chain.task, steps=40)
    again = mt.resume(chain.task, steps=40)
    assert more.samples.shape == (40, 1)
    np.testing.assert_array_equal(more.samples.values, again.samples.values)
    assert more.task[0].pos == 340


def test_serialtempmc_jax_rungs_continue_in_the_port():
    """A JAX ``_temp_scan`` run's rung states (stacked) and walker, carried
    over by ``serialtempmc_state_from_numpy``, continue in the port: the
    first steps with the drift sampler on the JAX run's draws equal the
    JAX continuation from the same states."""
    sds = (3.0, 1.0, 0.5)
    jms = [_gauss(mc, s) for s in sds]
    tms = [_gauss(mt, s) for s in sds]
    js, ts = mc.RWM(0.8), TDrift(0.05)
    ctx = JRunCtx(burnin=0)
    jstates = jax.tree_util.tree_map(
        lambda *xs: jnp.stack(xs), *[js.init(m, m.init, None) for m in jms])
    jS, jlogW, jpars, jat = jtemp._temp_scan(
        tuple(jms), (js,) * 3, (ctx,) * 3, jstates, jms[0].init,
        jms[0].eval(jms[0].init), jax.random.PRNGKey(0), steps=50,
        swap_period=3, adapt_weights=True, stacked=True)
    # the JAX scan starts its walker on rung 0 with zero weights: continue
    # the last position there
    at, pars = 0, np.asarray(jpars[-1])
    lt = float(jms[at].eval(jnp.asarray(pars)))
    carry = mt.serialtempmc_state_from_numpy(
        as_dict(jax.device_get(jS)), mt.rwm_state_from_numpy, at, pars, lt,
        np.zeros(3), device="cpu")
    assert len(carry["states"]) == 3 and carry["at"] == at
    assert abs(float(jlogW.sum())) > 0
    jd = JDrift(0.05)
    key = jax.random.PRNGKey(1)
    jS2, jlogW2, jpars2, jat2 = jtemp._temp_scan(
        tuple(jms), (jd,) * 3, (ctx,) * 3, jS, jnp.asarray(pars),
        jnp.asarray(lt), key, steps=1, swap_period=1, adapt_weights=False,
        stacked=True)
    _, k_pick, k_acc = jax.random.split(jax.random.split(key, 1)[0], 3)
    raw = int(jax.random.randint(k_pick, (), 0, 2, dtype=jnp.int32))
    log_u = torch.tensor(float(jnp.log(jax.random.uniform(k_acc, ()))),
                         dtype=F64)
    target = ttemp._pick_rung(raw, at)
    st = ts.reset(tms[target], carry["states"][target], carry["pars"])
    st, info = ts.step(tms[target], RunCtx(), st, None)
    take = ttemp._swap_take(carry["logtarget"], info["logtarget"],
                            carry["logW"], at, target, log_u)
    new_at = target if take else at
    new_pars = info["ppars"] if take else carry["pars"]
    assert new_at == int(jat2[0])
    close(new_pars, jpars2[0])
    close(st.pars, jS2.pars[target])

    tasks = [m * mt.RWM(0.8) * mt.SerialTempMC(steps=50, burnin=0)
             for m in tms]
    for t in tasks:
        t.state = carry
    more = mt.resume(tasks, steps=100)
    assert more.samples.shape == (100, 1)
    assert np.all(np.isfinite(more.samples.values))
