"""The port's RMHMC, ERMLMC and RMLMC (samplers/rmhmc.py, lagrangian.py)
against the JAX package's, on the CPU in float64 (dtypes pinned on both
sides); the models and comparison helpers are tests/test_torch_manifold.py's.

- The batched helpers against ``jax.vmap`` of JAX's on random SPD metrics
  and a dG that is not symmetric in its last two axes, at 1e-12.
- One step on the draws of a JAX step replayed from its key, 8 chains of
  the vaso probit model that span every trajectory length from 1 to
  ``n_leaps`` (and, for RMHMC, both directions): the new state and every
  info entry at 1e-9; with the tuner each chain has its own leap count.  A
  trajectory that reaches a metric that is not positive definite rejects
  in both packages and nothing raises.
- RMHMC's constructor overloads and ERMLMC's and RMLMC's defaults and
  asserts against JAX's.
- Whole runs on tests/test_samplers_stat.py's 3-D Gaussian (its gates) and
  RMHMC on the vaso probit against the JAX package's run; the routes,
  resumes, a JAX state continued and a checkpoint resumed bit for bit."""
import dataclasses
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mcmc_jl_tpu as mc
from mcmc_jl_tpu.parallel import run_chains as jax_run_chains
from mcmc_jl_tpu.samplers import lagrangian as jlg
from mcmc_jl_tpu.samplers import rmhmc as jrm
import mcmc_jl_tpu_torch as mt
from mcmc_jl_tpu_torch.parallel import pchains
from mcmc_jl_tpu_torch.samplers import lagrangian as tlg
from mcmc_jl_tpu_torch.samplers import rmhmc as trm
from mcmc_jl_tpu_torch.samplers.base import RunCtx
from mcmc_jl_tpu_torch.utils.io import load_chain, save_chain
from test_torch_manifold import (EXACT, KERNEL_MODS, STEP, as_dict, close,
                                 fold_pair, gauss_pair, infos_close,
                                 jax_steps, probit_pair, run_gates,
                                 spd_batch, start_points, states_close)

torch.set_num_threads(1)
F64 = torch.float64

SAMPLERS = {
    "rmhmc": (lambda: mc.RMHMC(4, 0.5), lambda: mt.RMHMC(4, 0.5)),
    "rmhmc_tuner": (lambda: mc.RMHMC(4, 0.5, mc.EmpMCTuner(0.8,
                                                           adapt_step=5)),
                    lambda: mt.RMHMC(4, 0.5, mt.EmpMCTuner(0.8,
                                                           adapt_step=5))),
    "ermlmc": (lambda: mc.ERMLMC(4, 0.3), lambda: mt.ERMLMC(4, 0.3)),
    "rmlmc": (lambda: mc.RMLMC(4, 0.3), lambda: mt.RMLMC(4, 0.3)),
}
CONVERT = {"rmhmc": mt.rmhmc_state_from_numpy,
           "ermlmc": mt.lmc_state_from_numpy,
           "rmlmc": mt.lmc_state_from_numpy}


def draws(name, key, nl, d):
    """A JAX step's draws from its key, as each ``step`` splits it:
    RMHMC (z, forward, u_len, log_u), the Lagrangian pair (z, u_len,
    log_u); and the trajectory length ceil(u_len * nl)."""
    rm = name.startswith("rmhmc")
    ks = jax.random.split(key, 4 if rm else 3)
    z = jax.random.normal(ks[0], (d,), dtype=jnp.float64)
    u_len = jax.random.uniform(ks[-2], (), dtype=jnp.float64)
    log_u = jnp.log(jax.random.uniform(ks[-1], (), dtype=jnp.float64))
    out = (z, bool(jax.random.bernoulli(ks[1])), u_len, log_u) if rm else (
        z, u_len, log_u)
    return out, int(np.ceil(float(u_len) * nl))


def covering_keys(name, nls, targets, d):
    """One key per chain whose draws give chain c the trajectory length
    (and, for RMHMC, the direction) ``targets[c]`` under leap count
    ``nls[c]``."""
    keys, seed = [], 0
    for nl, tag in zip(nls, targets):
        while True:
            key = jax.random.PRNGKey(1000 + seed)
            seed += 1
            dr, n = draws(name, key, nl, d)
            if (n, dr[1] if name.startswith("rmhmc") else None) == tag:
                keys.append(key)
                break
    return jnp.stack(keys)


def replay(name, keys, nls, d):
    cols = list(zip(*[draws(name, k, nl, d)[0] for k, nl in zip(keys, nls)]))
    return [torch.tensor(np.asarray(jnp.stack(c)) if isinstance(
        c[0], jax.Array) else np.asarray(c)) for c in cols]


# -- helpers --------------------------------------------------------------------


def test_helpers_match_jax():
    """_metric_pack, _momentum_term, the Lagrangian _geometry, _vxC and
    _slogdet, batched over chains, against jax.vmap of JAX's at 1e-12."""
    G, dG, g = spd_batch(seed=1)
    rng = np.random.default_rng(2)
    m = rng.standard_normal(g.shape)
    Gt, dGt, gt, mt_ = (torch.tensor(a) for a in (G, dG, g, m))
    invG = np.linalg.inv(G)
    pack, traces = trm._metric_pack(torch.tensor(invG), dGt)
    jpack, jtraces = jax.vmap(jrm._metric_pack)(jnp.asarray(invG),
                                                jnp.asarray(dG))
    close(pack.numpy(), jpack, EXACT)
    close(traces.numpy(), jtraces, EXACT)
    invG_m = np.einsum("cab,cb->ca", invG, m)
    close(trm._momentum_term(mt_, pack, torch.tensor(invG_m)).numpy(),
          jax.vmap(jrm._momentum_term)(jnp.asarray(m), jpack,
                                       jnp.asarray(invG_m)), EXACT)
    got = tlg._geometry(gt, Gt, dGt)
    want = jax.vmap(jlg._geometry)(jnp.asarray(g), jnp.asarray(G),
                                   jnp.asarray(dG))
    for a, b in zip(got, want):
        close(a.numpy(), b, EXACT)
    Ct = got[3]
    vxc = tlg._vxC(mt_, Ct)
    jvxc = jax.vmap(jlg._vxC)(jnp.asarray(m), want[3])
    close(vxc.numpy(), jvxc, EXACT)
    M = Gt + 0.7 * vxc  # not symmetric
    assert (M - M.mT).abs().max() > 0.1
    close(tlg._slogdet(M).numpy(), jax.vmap(jlg._slogdet)(jnp.asarray(
        M.numpy())), EXACT)
    # a singular and a NaN system: -inf and NaN, no error
    bad = torch.stack([torch.zeros(4, 4, dtype=F64),
                       torch.full((4, 4), torch.nan, dtype=F64)])
    ld = tlg._slogdet(bad)
    assert ld[0] == -torch.inf and torch.isnan(ld[1])


@pytest.mark.parametrize("name", sorted(SAMPLERS))
def test_step_on_replayed_draws_matches_jax(name):
    """Eight chains spanning every trajectory length 1..n_leaps (RMHMC:
    and both directions; with the tuner, per-chain leap counts 1-4 at an
    adaptation step): one JAX step per chain and the port's move on its
    replayed draws agree at 1e-9 in every state field and info entry."""
    mkj, mkt = SAMPLERS[name]
    js, ts = mkj(), mkt()
    jm, tm, _ = probit_pair()
    C, d = 8, 3
    th = start_points(jm, C, 4)
    jst = jax.vmap(lambda t: js.init(jm, t, None))(jnp.asarray(th))
    states_close(ts.init(tm, torch.tensor(th)), jst, 1e-10)
    burnin = 0
    nls = [4] * C
    if name == "rmhmc":  # every (length, direction) pair
        targets = [(n, f) for n in range(1, 5) for f in (True, False)]
    elif name == "rmhmc_tuner":
        nls = [1, 2, 3, 4, 4, 3, 2, 1]
        targets = list(zip([1, 2, 3, 4, 3, 2, 1, 1], [True, False] * 4))
    else:
        targets = [(n, None) for n in (1, 2, 3, 4, 1, 2, 3, 4)]
    if js.tuner is not None:
        jst = jst.replace(i=jnp.full(C, 5, jnp.int32), tune=jst.tune.replace(
            n_leaps=jnp.asarray(nls, jnp.int32),
            step_size=jnp.linspace(0.3, 0.6, C),
            accepted=jnp.arange(C, dtype=jnp.int32) % 5,
            proposed=jnp.full(C, 4, jnp.int32)))
        burnin = 10
    keys = covering_keys(name, nls, targets, d)
    jnew, jinfo = jax_steps(js, jm, jst, keys, burnin)
    st = CONVERT[name.split("_")[0]](as_dict(jax.device_get(jst)),
                                     device="cpu")
    new, info = ts.move(tm, RunCtx(burnin=burnin), st,
                        *replay(name, keys, nls, d))
    states_close(new, jnew, STEP)
    infos_close(info, jinfo, STEP)
    acc = info["accept"].numpy()
    assert acc.any(), acc
    if js.tuner is not None:
        assert not np.array_equal(new.tune.n_leaps.numpy(), nls)


@pytest.mark.parametrize("name", ["rmhmc", "ermlmc", "rmlmc"])
def test_non_pd_trajectory_rejects_as_jax(name):
    """On the folding metric, trajectories that pass x_0 = 1 meet a metric
    with no Cholesky factor: both packages reject them, the same chains,
    and nothing raises."""
    jm, tm = fold_pair()
    js, ts = {"rmhmc": (mc.RMHMC(4, 0.6), mt.RMHMC(4, 0.6)),
              "ermlmc": (mc.ERMLMC(4, 0.4), mt.ERMLMC(4, 0.4)),
              "rmlmc": (mc.RMLMC(4, 0.4), mt.RMLMC(4, 0.4))}[name]
    C = 16
    th = np.column_stack([np.full(C, 0.4), np.linspace(-0.3, 0.3, C)])
    jst = jax.vmap(lambda t: js.init(jm, t, None))(jnp.asarray(th))
    keys = jax.random.split(jax.random.PRNGKey(5), C)
    jnew, jinfo = jax_steps(js, jm, jst, keys, 0)
    # the first coordinate of every leap's refreshed point: chain c's
    # first n_rand[c] of them are its trajectory (the rest are discarded)
    x0 = []

    def watch(theta):
        x0.append(theta[..., 0].clone())
        return tm.evalalldt(theta)

    draws_t = replay(name, keys, [4] * C, 2)
    st = ts.init(tm, torch.tensor(th))
    new, info = ts.move(dataclasses.replace(tm, evalalldt=watch), RunCtx(),
                        st, *draws_t)
    n_rand = torch.ceil(draws_t[-2] * 4).long()
    past = torch.stack(x0) > 1.0  # (leaps, C)
    folded = (past & (torch.arange(len(x0))[:, None] < n_rand)).any(0).numpy()
    acc = info["accept"].numpy()
    np.testing.assert_array_equal(acc, np.asarray(jinfo["accept"]))
    assert folded.any() and not folded.all(), folded
    assert not acc[folded].any()
    assert acc[~folded].any()
    states_close(new, jnew, STEP)


CTOR = [(), (8,), (0.25,), (8, 0.2), (8, 0.2, 3), ("tuner", 0.5),
        ("tuner", 3, 0.5)]


@pytest.mark.parametrize("args", CTOR, ids=[str(a) for a in CTOR])
def test_rmhmc_constructor_matches_jax(args):
    """RMHMC's reference overloads give the same n_leaps, leap_step,
    n_newton and tuner in both packages."""
    def build(pkg):
        a = list(args)
        if a and a[0] == "tuner":
            a = a[1:] + [pkg.EmpMCTuner(0.8)]
        return pkg.RMHMC(*a)

    j, t = build(mc), build(mt)
    assert (t.n_leaps, t.leap_step, t.n_newton) == (j.n_leaps, j.leap_step,
                                                   j.n_newton)
    assert type(t.leap_step) is float and type(t.n_leaps) is int
    assert (t.tuner is None) == (j.tuner is None)
    if t.tuner is not None:
        assert t.tuner.target_rate == j.tuner.target_rate == 0.8
    assert mt.RMHMC(n_leaps=5, leap_step=0.1) == mt.RMHMC(5, 0.1)


def test_lagrangian_defaults_and_asserts_match_jax():
    """ERMLMC's and RMLMC's defaults, and every assert, as JAX's."""
    for name in ("ERMLMC", "RMLMC"):
        j, t = getattr(mc, name)(), getattr(mt, name)()
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
    for pkg in (mc, mt):
        for bad in (dict(n_leaps=0), dict(leap_step=0.0)):
            for name in ("ERMLMC", "RMLMC"):
                with pytest.raises(AssertionError):
                    getattr(pkg, name)(**bad)
        with pytest.raises(AssertionError):
            pkg.RMLMC(n_newton=0)
        for bad in ((-0.5,), (4, 0.5, 0), (4, -0.1)):
            with pytest.raises(AssertionError):
                pkg.RMHMC(*bad)
        with pytest.raises(ZeroDivisionError):  # 3 / n_leaps, as RMHMC.jl
            pkg.RMHMC(0)


GAUSS = {
    "RMHMC": (lambda: mt.RMHMC(4, 0.6), 32, 160, 40),
    "ERMLMC": (lambda: mt.ERMLMC(4, 0.5), 32, 160, 40),
    "RMLMC": (lambda: mt.RMLMC(4, 0.5), 32, 160, 40),
}


@pytest.mark.parametrize("name", sorted(GAUSS))
def test_run_chains_gaussian_moments(name):
    """tests/test_samplers_stat.py's gates through run_chains."""
    mk, C, steps, burnin = GAUSS[name]
    _, tm = gauss_pair()
    infos, st, _ = pchains.run_chains(tm, mk(), mt.SerialMC(steps=steps,
                                                            burnin=burnin),
                                      C, seed=1)
    x = infos["ppars"][burnin:].numpy()
    run_gates(x, infos["accept"][burnin:].double().mean().item(), name)
    assert torch.all(st.i == steps + 1)
    assert set(infos) == {"ppars", "plogtarget", "pgrads", "pars",
                          "logtarget", "grads", "accept"}


def test_rmhmc_vaso_means_match_jax():
    """RMHMC(3, 0.5, EmpMCTuner(0.8)) on the vaso probit: the port's pooled
    means against the JAX package's run of tests/test_examples.py
    (SerialMC(range(500, 3501))), within 6 (se + se') + 0.05."""
    jm, tm, _ = probit_pair()
    jc = mc.run(jm * mc.RMHMC(3, 0.5, mc.EmpMCTuner(0.8))
                * mc.SerialMC(range(500, 3501)), seed=3)
    jmean = np.asarray(mc.mean(jc))
    jse = np.sqrt(np.asarray(mc.var(jc))
                  / np.maximum(np.asarray(mc.ess(jc)), 4.0))
    C, steps, burn = 16, 300, 100
    ts = mt.RMHMC(3, 0.5, mt.EmpMCTuner(0.8, adapt_step=50))
    infos, st, _ = pchains.run_chains(tm, ts, mt.SerialMC(steps=steps,
                                                         burnin=burn), C,
                                      seed=3)
    x = infos["ppars"][burn:].numpy()
    m = x.mean(0)
    se = m.std(0, ddof=1) / np.sqrt(C)
    diff = np.abs(m.mean(0) - jmean)
    assert np.all(diff < 6 * (se + jse) + 0.05), (diff, se, jse)
    assert st.tune.step_size.unique().numel() > 1  # tuned per chain


@pytest.mark.parametrize("name", ["RMHMC", "ERMLMC", "RMLMC"])
def test_take_the_generic_engine(name, caplog):
    """On a float32 catalog model and on a float32 GLM with tensor and
    dtensor, each routes to the generic engine with a logged reason, in a
    run and in a resume, and no kernel or plain version runs."""
    rng = np.random.default_rng(0)
    X = np.column_stack([np.ones(30), rng.standard_normal((30, 2))])
    Y = (rng.random(30) < 0.5).astype(np.float64)
    kw = dict(tensor=True, dtensor=True, dtype=torch.float32, device="cpu")
    models = [
        mt.model(lambda x: mt.tilde(x, mt.Gamma(3.0, 0.2)),
                 x=np.full(4, 0.7), gradient=True, **kw),
        mt.model(glm=("logistic", X, Y), **kw)]
    s = getattr(mt, name)(3, 0.2)
    for m in models:
        task = m * s * mt.SerialMC(steps=8, burnin=4)
        caplog.clear()
        with caplog.at_level(logging.INFO):
            assert pchains._route(task, True) is False
        assert "no fused CUDA route" in caplog.text, caplog.text
        assert name in caplog.text and "generic" in caplog.text
        for mod in KERNEL_MODS:
            mod.reset_counts()
        caplog.clear()
        with caplog.at_level(logging.INFO):
            cs = mt.run(task, chains=6, fused=True)
            mt.resume(cs, steps=3, fused=True)
        assert "continuing 6" in caplog.text and "generic" in caplog.text
        assert "has no fused continuation" in caplog.text
        for mod in KERNEL_MODS:
            assert not any(mod.LAUNCHES.values()), mod.LAUNCHES
            assert not any(mod.PLAIN_CALLS.values()), mod.PLAIN_CALLS
        assert np.all(np.isfinite(np.stack([c.samples.values for c in cs])))


@pytest.mark.parametrize("name", ["RMHMC", "ERMLMC", "RMLMC"])
def test_run_then_two_resumes_repeat(name):
    """run(chains=4), then resume(list) twice: the same draws, pos
    advanced; a single-chain run resumed twice repeats too."""
    _, tm = gauss_pair()
    s = getattr(mt, name)(3, 0.5, tuner=mt.EmpMCTuner(0.8, adapt_step=5))
    task = tm * s \
        * mt.SerialMC(steps=16, burnin=10)
    cs = mt.run(task, chains=4, seed=3)
    r1, r2 = mt.resume(cs, steps=6), mt.resume(cs, steps=6)
    for a, b in zip(r1, r2):
        np.testing.assert_array_equal(a.samples.values, b.samples.values)
        assert a.task.pos == b.task.pos == task.runner.len + 6
    assert not np.array_equal(r1[0].samples.values, r1[1].samples.values)
    c = mt.run(task, seed=5)
    assert c.task.state.pars.shape == (3,) and c.task.state.G.shape == (3, 3)
    s1, s2 = mt.resume(c, steps=5), mt.resume(c, steps=5)
    np.testing.assert_array_equal(s1.samples.values, s2.samples.values)


@pytest.mark.parametrize("name", ["rmhmc", "ermlmc"])
def test_jax_state_continues_in_the_port(name):
    """JAX final states carried over by the converters continue in the
    port: the same positions, geometry and counters at the start, and the
    continuation meets the Gaussian's gates."""
    jm, tm = gauss_pair()
    js, ts = {"rmhmc": (mc.RMHMC(4, 0.6), mt.RMHMC(4, 0.6)),
              "ermlmc": (mc.ERMLMC(4, 0.5), mt.ERMLMC(4, 0.5))}[name]
    C, steps = 32, 30
    _, jst, _ = jax_run_chains(jm, js, mc.SerialMC(steps=steps, burnin=10),
                               C, seed=1)
    st = CONVERT[name](as_dict(jax.device_get(jst)), device="cpu")
    assert type(st) is {"rmhmc": mt.RMHMCState, "ermlmc": mt.LMCState}[name]
    np.testing.assert_array_equal(st.pars.numpy(), np.asarray(jst.pars))
    np.testing.assert_array_equal(st.G.numpy(), np.asarray(jst.G))
    assert st.i.dtype == torch.int32 and torch.all(st.i == steps + 1)
    cont = 120
    infos, new, _ = pchains.run_chains(tm, ts, mt.SerialMC(steps=cont), C,
                                       seed=2, states=st)
    assert torch.all(new.i == steps + 1 + cont)
    run_gates(infos["ppars"].numpy(),
              infos["accept"].double().mean().item(), name)


def test_rmhmc_checkpoint_resumes_bit_for_bit(tmp_path):
    """save_chain / load_chain of a tuned RMHMC run: the loaded chain has
    the same samples, state and generator, and its resume repeats the live
    chain's resume bit for bit."""
    _, tm = gauss_pair()
    s = mt.RMHMC(3, 0.5, mt.EmpMCTuner(0.8, adapt_step=5))
    c = mt.run(tm * s * mt.SerialMC(steps=20, burnin=10), seed=6)
    p = tmp_path / "rmhmc.npz"
    save_chain(p, c)
    lc = load_chain(p, mt.MCMCTask(tm, s, c.task.runner))
    np.testing.assert_array_equal(lc.samples.values, c.samples.values)
    np.testing.assert_array_equal(lc.task.state.G.numpy(),
                                  c.task.state.G.numpy())
    assert torch.equal(lc.task.state.tune.n_leaps, c.task.state.tune.n_leaps)
    a, b = mt.resume(c, steps=8), mt.resume(lc, steps=8)
    np.testing.assert_array_equal(a.samples.values, b.samples.values)
    np.testing.assert_array_equal(a.gradients.values, b.gradients.values)
    assert a.task.pos == b.task.pos
