"""The port's ChEES-HMC (mcmc_jl_tpu_torch/samplers/chees.py) and its warm
route against the JAX package's, on the CPU: the cross-chain ``pool``
arithmetic on identical states in float64, the batched step with per-chain
leap counts, the engine's pool hook, the generic run against JAX's
statistically, and the warm pipeline (``warmfused_chains``) on a GLM
(Halton multistep kernel; the N-tiled kernel above a lowered threshold)
and on a catalog target (the trajectory kernel) against the generic
engine, where the wrappers run their plain versions."""
import dataclasses
import math

import jax
import numpy as np
import pytest
import torch

import mcmc_jl_tpu as mc
from mcmc_jl_tpu.parallel import run_chains as jax_run_chains
from mcmc_jl_tpu.samplers.base import RunCtx as JRunCtx
import mcmc_jl_tpu_torch as mt
from mcmc_jl_tpu_torch.ops import glm_bign
from mcmc_jl_tpu_torch.ops import glm_kernels as gk
from mcmc_jl_tpu_torch.ops import target_kernels as tk
from mcmc_jl_tpu_torch.parallel import pchains
from mcmc_jl_tpu_torch.samplers.base import RunCtx
from mcmc_jl_tpu_torch.samplers.integrators import leapfrog

torch.set_num_threads(1)
F64 = torch.float64
Z_MAX = 5.0
ADAPTED = ("leap_step", "dual_leap_step", "dual_h", "log_len", "adam_m",
           "adam_v")


def _data(n=120, d=3, seed=3):
    rng = np.random.default_rng(seed)
    X = np.column_stack([np.ones(n), rng.standard_normal((n, d - 1))])
    X[:, 1] *= 3.0  # anisotropic posterior
    beta = rng.standard_normal(d) * 0.5
    Y = (rng.random(n) < 1.0 / (1.0 + np.exp(-X @ beta))).astype(np.float64)
    return X, Y


def _models():
    X, Y = _data()
    return (mc.model(glm=("logistic", X, Y)),
            mt.model(glm=("logistic", X, Y), dtype=F64, device="cpu"))


def _as_dict(state):
    return {f.name: (_as_dict(getattr(state, f.name))
                     if dataclasses.is_dataclass(getattr(state, f.name))
                     else np.asarray(getattr(state, f.name)))
            for f in dataclasses.fields(state)}


def _z(a, b):
    se = np.sqrt(a.var(0, ddof=1) / len(a) + b.var(0, ddof=1) / len(b))
    return float(np.max(np.abs(a.mean(0) - b.mean(0)) / se))


@pytest.mark.parametrize("steps,burnin", [(1, 50), (7, 50), (7, 3)],
                         ids=["first_pool", "adapting", "after_burnin"])
def test_pool_matches_jax_float64(steps, burnin):
    """pool on JAX ChEES states carried over to the port (float64): every
    adapted field equal to JAX's within 1e-12 relative (the chain-axis sums
    may reduce in another order), inside and after the burn-in."""
    jm, _ = _models()
    js = mc.ChEESHMC(len0=0.5, max_leaps=64)
    _, jst, _ = jax_run_chains(jm, js, mc.SerialMC(steps=steps,
                                                   burnin=steps - 1), 16,
                               seed=2)
    jst = jax.device_get(jst)
    st = mt.chees_state_from_numpy(_as_dict(jst), device="cpu")
    assert isinstance(st, mt.ChEESState) and st.pars.dtype == F64
    assert int(st.i[0]) == steps + 1
    jout = js.pool(JRunCtx(burnin=burnin), jst, None)
    out = mt.ChEESHMC(len0=0.5, max_leaps=64).pool(RunCtx(burnin=burnin), st,
                                                   None)
    for name in ADAPTED:
        got, want = getattr(out, name).numpy(), np.asarray(getattr(jout, name))
        assert got.shape == want.shape == (16,)
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0, err_msg=name)
        assert np.all(got == got[0]), name  # shared across chains
    if burnin < steps:  # past the burn-in the pool leaves everything
        for name in ADAPTED:
            np.testing.assert_array_equal(getattr(out, name).numpy(),
                                          np.asarray(getattr(jst, name)))


def test_step_runs_each_chain_to_its_own_leap_count():
    """Before the first pool the chains carry different steps: one batched
    step gives each chain the leap count clip(ceil(halton2(i) T / eps), 1,
    max_leaps) of its own eps and runs it to that count (the others held),
    as leapfrogs of that chain alone would; the stash carries q, q', v and
    the integration time."""
    _, tm = _models()
    s = mt.ChEESHMC(len0=1.0, max_leaps=8)
    gen = torch.Generator().manual_seed(0)
    C = 5
    th0 = tm.init + 0.1 * torch.randn((C, tm.size), generator=gen, dtype=F64)
    st = s.init(tm, th0, gen)
    st = st.replace(leap_step=torch.tensor([0.05, 0.1, 0.2, 0.4, 2.0],
                                           dtype=F64))
    g2 = torch.Generator()
    g2.set_state(gen.get_state())
    m0 = torch.randn(th0.shape, generator=g2, dtype=F64)
    new, info = s.step(tm, RunCtx(burnin=10), st, gen)
    want = [min(math.ceil(0.5 * 1.0 / e), 8) for e in (0.05, 0.1, 0.2, 0.4)]
    assert info["nleaps"].tolist() == want + [1]
    assert info["nleaps"].dtype == torch.int32
    for c in range(C):
        p, m, g = th0[c:c + 1], m0[c:c + 1], st.grad[c:c + 1]
        e = st.leap_step[c]
        for _ in range(int(info["nleaps"][c])):
            p, _, g, m = leapfrog(tm, p, m, g, e)
        torch.testing.assert_close(new.p_prop[c], p[0], rtol=1e-12,
                                   atol=1e-12)
        torch.testing.assert_close(new.p_vel[c], m[0], rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(new.p_prev, th0)
    torch.testing.assert_close(new.p_time, info["nleaps"].to(F64)
                               * st.leap_step)
    assert torch.all(new.i == 2) and torch.equal(info["epsilon"], st.leap_step)


def test_generic_run_matches_jax_and_pools():
    """ChEES on the generic engine (the pool hook after every step) against
    the JAX package's: per-chain means within 5 standard errors, acceptance
    within 0.1, the frozen step within 35%; the frozen trajectory time
    within a factor of 3 (Adam on a 16-chain gradient estimate is noisy:
    seeds 0-3 give T from 0.30 to 0.65 in JAX and 0.36 to 0.88 here); the
    adapted values are shared across chains after the pool."""
    jm, tm = _models()
    C, steps, burn = 16, 400, 150
    make = lambda p: p.ChEESHMC(len0=0.5, max_leaps=64)  # noqa: E731
    infos, st, _ = pchains.run_chains(tm, make(mt), mt.SerialMC(
        steps=steps, burnin=burn), C, seed=0)
    jinfos, jst, _ = jax_run_chains(jm, make(mc), mc.SerialMC(
        steps=steps, burnin=burn), C, seed=0)
    assert set(infos) == set(jinfos)
    a = infos["ppars"][burn:].mean(0).numpy()
    b = np.asarray(jinfos["ppars"])[burn:].mean(0)
    assert _z(a, b) < Z_MAX, (a.mean(0), b.mean(0))
    acc = float(infos["accept"][burn:].double().mean())
    jacc = float(np.mean(np.asarray(jinfos["accept"])[burn:]))
    assert abs(acc - jacc) < 0.1, (acc, jacc)
    for name in ("dual_leap_step", "log_len"):
        x = getattr(st, name)
        assert torch.all(x == x[0]), name
    eps, jeps = st.dual_leap_step[0].item(), float(jst.dual_leap_step[0])
    T, jT = math.exp(st.log_len[0].item()), math.exp(float(jst.log_len[0]))
    assert abs(eps / jeps - 1) < 0.35, (eps, jeps)
    assert abs(math.log(T / jT)) < math.log(3.0), (T, jT)
    assert torch.all(infos["epsilon"][burn:] == eps)
    assert torch.all(st.i == steps + 1)


def _target_model():
    def ex(a, b):
        mt.tilde(a, mt.Gamma(3.0, 0.2))
        mt.tilde(b, mt.Normal(1.0, 2.0))
    return mt.model(ex, a=np.full(2, 0.6), b=np.array([1.0]), gradient=True,
                    device="cpu")


WARM = {"glm": ("glm_multistep_rows", 250 // 5),
        "glm_bign": ("glm_logp_grad_tiled", None),
        "target": ("target_leapfrogs", 250)}


@pytest.mark.parametrize("kind", list(WARM))
def test_warmfused_chees_matches_generic(kind, monkeypatch):
    """run(task, chains=16, fused=True) with ChEES takes the warm route:
    the sampling phase through the kernel's plain version (Halton multistep
    on a GLM, 250 transitions as 50 launches of 5; the tiled evaluation
    above a threshold lowered to 100; the trajectory kernel on a catalog
    target, once per transition) at the frozen eps and T; the draws agree
    with the generic engine; the sampling rows carry the frozen epsilon and
    the Halton leap counts; the final states are exact and resume
    repeats."""
    kernel, calls = WARM[kind]
    if kind == "glm_bign":
        monkeypatch.setattr(glm_bign, "BIGN_THRESHOLD", 100)
    m = _target_model() if kind == "target" else _models()[1]
    steps, burnin, C, max_leaps = 400, 150, 16, 32
    task = m * mt.ChEESHMC(len0=0.5, max_leaps=max_leaps) \
        * mt.SerialMC(steps=steps, burnin=burnin)
    assert pchains._route(task, True) == "warm"
    for mod in (gk, glm_bign, tk):
        mod.reset_counts()
    cf = mt.run(task, chains=C, seed=0, fused=True)
    plain = {**gk.PLAIN_CALLS, **glm_bign.PLAIN_CALLS, **tk.PLAIN_CALLS}
    n = plain.pop(kernel)
    assert (n == calls if calls else n > steps - burnin), n
    assert not any(plain.values()), plain
    cg = mt.run(task, chains=C, seed=1, fused=False)
    a = np.stack([c.samples.values.mean(0) for c in cf])
    b = np.stack([c.samples.values.mean(0) for c in cg])
    assert _z(a, b) < Z_MAX, (a.mean(0), b.mean(0))
    c0 = cf[0]
    assert c0.samples.shape == (steps - burnin, m.size)
    assert set(c0.diagnostics) == set(cg[0].diagnostics)
    st = c0.task.state
    assert isinstance(st, mt.ChEESState) and st.i.item() == steps + 1
    eps, T = st.dual_leap_step.item(), float(np.exp(st.log_len.item()))
    np.testing.assert_allclose(c0.diagnostics["epsilon"], eps, rtol=1e-6)
    want = [gk.halton_leaps(i, eps, T, max_leaps)
            for i in range(burnin + 1, steps + 1)]
    assert c0.diagnostics["nleaps"].tolist() == want
    assert len(set(want)) > 1
    lp, g = m.evalallg(st.pars)
    torch.testing.assert_close(st.logtarget, lp)
    torch.testing.assert_close(st.grad, g)
    r1, r2 = mt.resume(c0, steps=15), mt.resume(c0, steps=15)
    np.testing.assert_array_equal(r1.samples.values, r2.samples.values)
