"""The port's adaptive HMC family (HMC with EmpMCTuner and diagonal mass
adaptation, HMCDA, MALA) and its warm-start pipeline against the JAX
package's, on the CPU: the Halton leap rule bit for bit, the plain version
of the Halton multistep kernel against the Pallas trajectory kernel on
the same injected noise, the samplers on the generic engine, the freeze of
converted JAX warmup states, and run(task, chains=N) through the warm route
at small and large N (where the wrappers run their plain versions)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mcmc_jl_tpu as mc
from mcmc_jl_tpu.core.task import MCMCTask as JTask
from mcmc_jl_tpu.ops import warmstart as jws
from mcmc_jl_tpu.ops.pallas_glm import (glm_hmc_leapfrogs, pad_chains,
                                        pad_design)
from mcmc_jl_tpu.parallel import run_chains as jax_run_chains
from mcmc_jl_tpu.samplers.chees import halton2 as jax_halton2
import mcmc_jl_tpu_torch as mt
from mcmc_jl_tpu_torch.core.task import MCMCTask
from mcmc_jl_tpu_torch.ops import glm_bign
from mcmc_jl_tpu_torch.ops import glm_kernels as gk
from mcmc_jl_tpu_torch.ops import warmstart as tws
from mcmc_jl_tpu_torch.parallel import pchains
from mcmc_jl_tpu_torch.samplers.chees import halton2

torch.set_num_threads(1)
F64 = torch.float64


def _data(n=90, d=4, seed=3, scales=None):
    """tests/test_warmfused.py's data."""
    rng = np.random.default_rng(seed)
    X = np.column_stack([np.ones(n), rng.standard_normal((n, d - 1))])
    if scales is not None:
        X = X / np.asarray(scales)[None, :]
    beta = rng.standard_normal(d) * 0.7
    Y = (rng.random(n) < 1.0 / (1.0 + np.exp(-X @ beta))).astype(np.float64)
    return X, Y


def _models(**kw):
    X, Y = _data(**kw)
    return (mc.model(glm=("logistic", X, Y)),
            mt.model(glm=("logistic", X, Y), dtype=F64, device="cpu"))


def _as_dict(state):
    return {f.name: (_as_dict(getattr(state, f.name))
                     if dataclasses.is_dataclass(getattr(state, f.name))
                     else np.asarray(getattr(state, f.name)))
            for f in dataclasses.fields(state)}


def _chain_means(chains):
    return np.stack([c.samples.values.mean(0) for c in chains])


def _z(a, b):
    """max |mean difference| / se of two sets of independent per-chain
    means (one row per chain)."""
    se = np.sqrt(a.var(0, ddof=1) / len(a) + b.var(0, ddof=1) / len(b))
    return float(np.max(np.abs(a.mean(0) - b.mean(0)) / se))


# ---- the Halton leap rule --------------------------------------------------


def test_halton2_bit_equal_to_jax():
    """halton2 in float32 is the JAX package's float64 sum cast to float32,
    bit for bit, for i in 1..5000 and a few large i."""
    i = np.concatenate([np.arange(1, 5001), [2 ** 20 + 7, 2 ** 24 - 1,
                                             2 ** 24 + 3, 2 ** 31 - 5]])
    ours = halton2(torch.as_tensor(i)).numpy()
    theirs = np.asarray(jax.vmap(lambda k: jax_halton2(k).astype(jnp.float32))(
        jnp.asarray(i, jnp.int32)))
    assert ours.dtype == np.float32
    np.testing.assert_array_equal(ours.view(np.uint32), theirs.view(np.uint32))


def test_kernel_vdc2_formula_matches_halton2():
    """csrc/glm_hmc.cu vdc2: float32 of the bit-reversed index (round to
    nearest) times 2^-32 equals halton2 exactly, for every i < 2^16 and a
    sample of larger ones."""
    i = np.concatenate([np.arange(1 << 16),
                        np.random.default_rng(0).integers(1 << 16, 1 << 31,
                                                          4096)])
    u = i.astype(np.uint32)
    rev = np.zeros_like(u)
    for b in range(32):
        rev |= ((u >> np.uint32(b)) & np.uint32(1)) << np.uint32(31 - b)
    kernel = rev.astype(np.float32) * np.float32(2.0 ** -32)
    np.testing.assert_array_equal(kernel, halton2(torch.as_tensor(i)).numpy())


def _jax_leaps(i, eps, T, max_leaps):
    u = jax_halton2(jnp.asarray(i, jnp.int32)).astype(jnp.float32)
    return int(jnp.clip(jnp.ceil(u * jnp.float32(T) / jnp.float32(eps)), 1,
                        max_leaps).astype(jnp.int32))


@pytest.mark.parametrize("eps,T,max_leaps", [(0.05, 1.0, 40), (0.3, 0.3, 1),
                                             (0.013, 0.7, 100),
                                             (0.1, 2.0, 8)])
def test_halton_leaps_match_jax(eps, T, max_leaps):
    assert [gk.halton_leaps(i, eps, T, max_leaps) for i in range(1, 400)] \
        == [_jax_leaps(i, eps, T, max_leaps) for i in range(1, 400)]


@pytest.mark.parametrize("prior", ["scalar", "row"])
def test_rows_ref_matches_successive_pallas_steps(prior):
    """The plain version of the Halton multistep kernel with injected noise
    == the JAX package's _chees_scan transition around the Pallas trajectory
    kernel (interpret) at the JAX formula's leap counts, with a scalar or a
    (d,) prior row; its nleaps rows equal that formula exactly."""
    n, d, C, k, i0 = 60, 4, 8, 6, 37
    eps, T, max_leaps = 0.2, 0.9, 6
    X, Y = _data(n=n, d=d, seed=6)
    X, Y = X.astype(np.float32), Y.astype(np.float32)
    rng = np.random.default_rng(8)
    theta = (0.2 * rng.standard_normal((C, d))).astype(np.float32)
    z = rng.standard_normal((k, C, d)).astype(np.float32)
    logu = np.log(rng.random((k, C))).astype(np.float32)
    lam = (np.array([1.0, 2.0, 0.5, 1.5], np.float32) if prior == "row"
           else 1.0)
    XTt, Yt = torch.as_tensor(X.T).contiguous(), torch.as_tensor(Y)
    lam_t = torch.as_tensor(lam) if prior == "row" else lam
    th, g, lp, rows = gk.glm_multistep_rows_ref(
        XTt, Yt, torch.as_tensor(theta), eps, T, i0, max_leaps, k_trans=k,
        noise=(torch.as_tensor(z), torch.as_tensor(logu)),
        prior_prec=lam_t)

    want_nl = [_jax_leaps(i0 + t, eps, T, max_leaps) for t in range(k)]
    assert rows["nleaps"].dtype == torch.int32
    assert rows["nleaps"][:, 0].tolist() == want_nl
    assert torch.all(rows["nleaps"] == rows["nleaps"][:, :1])
    assert len(set(want_nl)) > 1
    XT, Y2, d_pad = pad_design(X, Y)
    pl = dict(interpret=True, block_chains=C)
    if prior == "row":
        pl.update(prior_prec=jnp.asarray(np.concatenate(
            [lam, np.ones(d_pad - d, np.float32)]).reshape(1, -1)))
    lp0, g0 = gk.glm_funcs(XTt, Yt, None, None, lam_t, "logistic")[1](
        torch.as_tensor(theta))
    jth, jg = (pad_chains(jnp.asarray(a), d_pad) for a in (theta, g0.numpy()))
    jlp = jnp.asarray(lp0.numpy())
    for t in range(k):
        # the JAX package's _chees_scan body around the Pallas trajectory
        m0 = pad_chains(jnp.asarray(z[t]), d_pad)
        p_th, p_m, p_g, p_lp = glm_hmc_leapfrogs(
            XT, Y2, jth, m0, jg, eps, n_leaps=want_nl[t], **pl)
        ratio = ((-jlp + 0.5 * jnp.sum(m0 * m0, axis=1))
                 - (-p_lp + 0.5 * jnp.sum(p_m * p_m, axis=1)))
        acc = np.asarray(jnp.where(jnp.isnan(ratio), False,
                                   (ratio > 0) | (ratio > logu[t])))
        jth = jnp.where(acc[:, None], p_th, jth)
        jg = jnp.where(acc[:, None], p_g, jg)
        jlp = jnp.where(acc, p_lp, jlp)
        np.testing.assert_array_equal(rows["accept"][t].numpy(), acc)
        np.testing.assert_allclose(rows["ppars"][t].numpy(),
                                   np.asarray(jth)[:, :d], rtol=2e-5,
                                   atol=2e-5)
        np.testing.assert_allclose(rows["plogtarget"][t].numpy(),
                                   np.asarray(jlp), rtol=1e-5, atol=2e-4)
        alpha = np.exp(np.minimum(np.asarray(ratio), 0.0))
        np.testing.assert_allclose(rows["alpha"][t].numpy(), alpha,
                                   rtol=1e-4, atol=1e-5)
    assert 0 < rows["accept"].float().mean() < 1, "want accepts and rejects"
    np.testing.assert_allclose(th.numpy(), np.asarray(jth)[:, :d], rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg)[:, :d], rtol=1e-4,
                               atol=1e-4)


# ---- eligibility, samplers, freeze -----------------------------------------


def test_warm_eligibility_matches_jax():
    """warm_eligible agrees with the JAX package's on GLM posteriors (ChEES
    included); what the port does not take (custom targets that are not a
    product of catalog densities) is refused."""
    jm, tm = _models()
    tun, ttun = mc.EmpMCTuner(0.8, adapt_step=50), mt.EmpMCTuner(0.8,
                                                                 adapt_step=50)
    r, tr = mc.SerialMC(steps=600, burnin=200), mt.SerialMC(steps=600,
                                                            burnin=200)
    pairs = [
        (mc.HMC(5, 0.1, tun), mt.HMC(5, 0.1, ttun)),
        (mc.HMC(5, 0.1, mass_adapt="diag"), mt.HMC(5, 0.1, mass_adapt="diag")),
        (mc.HMC(5, 0.1, tun, mass_adapt="diag-win"),
         mt.HMC(5, 0.1, ttun, mass_adapt="diag-win")),
        (mc.HMCDA(), mt.HMCDA()),
        (mc.HMCDA(mass_adapt="diag", integrator="2stage"),
         mt.HMCDA(mass_adapt="diag", integrator="2stage")),
        (mc.MALA(0.05, tun), mt.MALA(0.05, ttun)),
        (mc.MALA(0.05), mt.MALA(0.05)),
        (mc.HMC(5, 0.1), mt.HMC(5, 0.1)),
        (mc.HMC(5, 0.1, tun, store_leaps=True),
         mt.HMC(5, 0.1, ttun, store_leaps=True)),
        (mc.NUTS(), mt.NUTS()),
        (mc.ChEESHMC(len0=0.5), mt.ChEESHMC(len0=0.5)),
    ]
    for js, ts in pairs:
        want = jws.warm_eligible(JTask(jm, js, r))
        assert tws.warm_eligible(MCMCTask(tm, ts, tr)) == want, ts
    r0 = mt.SerialMC(steps=100, burnin=0)
    assert not tws.warm_eligible(MCMCTask(tm, mt.HMC(5, 0.1, ttun), r0))
    gen = mt.model(lambda v: -(v * v).sum(), gradient=True, init=np.zeros(2),
                   device="cpu")
    assert not tws.warm_eligible(MCMCTask(gen, mt.HMC(5, 0.1, ttun), tr))
    # the warm handoff: admitted by both packages
    assert jws.warm_eligible(JTask(jm, mc.NUTS(warm_handoff=True), r))
    assert tws.warm_eligible(MCMCTask(tm, mt.NUTS(warm_handoff=True), tr))
    # the routes
    route = lambda s: pchains._route(MCMCTask(tm, s, tr), True)  # noqa: E731
    assert route(mt.HMC(5, 0.1, ttun)) == "warm"
    assert route(mt.HMCDA()) == "warm"
    assert route(mt.MALA(0.05, ttun)) == "warm"
    assert route(mt.MALA(0.05)) == "hmc"
    assert route(mt.NUTS()) == "nuts"
    assert route(mt.ChEESHMC()) == "warm"
    assert not pchains._route(MCMCTask(tm, mt.HMCDA(), tr), "auto")


SAMPLERS = {
    "mala": (lambda p: p.MALA(0.02, p.EmpMCTuner(0.574, adapt_step=25)),
             lambda st: st.tune.step_size),
    "hmcda": (lambda p: p.HMCDA(len=1.0), lambda st: st.dual_leap_step),
    "hmcda_diag": (lambda p: p.HMCDA(len=1.0, mass_adapt="diag"),
                   lambda st: st.dual_leap_step),
    "hmc_diag": (lambda p: p.HMC(5, 0.1, p.EmpMCTuner(0.8, adapt_step=25),
                                 mass_adapt="diag"),
                 lambda st: st.tune.step_size),
    "hmc_diag_win": (lambda p: p.HMC(5, 0.1, mass_adapt="diag-win"),
                     lambda st: st.mass.scale[..., 1]),
}


@pytest.mark.parametrize("name", list(SAMPLERS))
def test_generic_sampler_matches_jax(name):
    """MALA, HMCDA and HMC with mass adaptation on the generic engine, in
    float64 from the model's init: the per-chain means of the kept draws of
    16 independent chains agree within 5 standard errors of the two sets,
    and the adapted quantity's median across chains within 25%."""
    make, adapted = SAMPLERS[name]
    jm, tm = _models(scales=np.array([1.0, 3.0, 1.0, 0.3]))
    C, steps, burn = 16, 400, 150
    infos, st, _ = pchains.run_chains(tm, make(mt), mt.SerialMC(
        steps=steps, burnin=burn), C, seed=0)
    jinfos, jst, _ = jax_run_chains(jm, make(mc), mc.SerialMC(
        steps=steps, burnin=burn), C, seed=0)
    assert set(infos) == set(jinfos)
    a = infos["ppars"][burn:].mean(0).numpy()
    b = np.asarray(jinfos["ppars"])[burn:].mean(0)
    assert _z(a, b) < 5, (a.mean(0), b.mean(0))
    acc = float(infos["accept"][burn:].double().mean())
    jacc = float(np.mean(np.asarray(jinfos["accept"])[burn:]))
    assert abs(acc - jacc) < 0.1, (acc, jacc)
    x, jx = np.median(adapted(st).numpy()), np.median(np.asarray(adapted(jst)))
    assert abs(x / jx - 1) < 0.25, (x, jx)
    assert torch.all(st.i == steps + 1)


FREEZE = {
    "hmc_tuner_diag": lambda p: p.HMC(5, 0.1, p.EmpMCTuner(0.8, adapt_step=20),
                                      mass_adapt="diag"),
    "hmc_diag_win": lambda p: p.HMC(5, 0.1, mass_adapt="diag-win"),
    "hmcda_diag": lambda p: p.HMCDA(len=1.0, mass_adapt="diag"),
    "mala": lambda p: p.MALA(0.02, p.EmpMCTuner(0.574, adapt_step=20)),
}
CONVERT = {"HMCState": mt.hmc_state_from_numpy,
           "HMCDAState": mt.hmcda_state_from_numpy,
           "MALAState": mt.mala_state_from_numpy}


@pytest.mark.parametrize("name", list(FREEZE))
def test_freeze_matches_jax(name):
    """_freeze on JAX warmup states carried over to the port gives the JAX
    package's (eps, n_leaps, pooled metric scale)."""
    jm, tm = _models(scales=np.array([1.0, 3.0, 1.0, 0.3]))
    js = FREEZE[name](mc)
    k_init, k_warm = jax.random.split(jax.random.PRNGKey(1))
    jst, _ = jws._warmup(jm, js, mc.SerialMC(steps=300, burnin=200), 7,
                         k_init, k_warm)
    st = CONVERT[type(jst).__name__](_as_dict(jax.device_get(jst)),
                                     device="cpu")
    eps, nl, s = tws._freeze(FREEZE[name](mt), st)
    jeps, jnl, js_ = jws._freeze(js, jst)
    assert eps == pytest.approx(jeps, rel=1e-12) and nl == jnl
    if js_ is None:
        assert s is None
    else:
        np.testing.assert_allclose(s.numpy(), js_, rtol=1e-12)
    if name != "mala":
        assert s is not None


# ---- the warm route through run(task, chains=N) -----------------------------


WARM = {
    "hmc_diag": (lambda: mt.HMC(5, 0.05, mt.EmpMCTuner(0.8, adapt_step=50),
                                mass_adapt="diag"), "glm_multistep_rows"),
    "hmc_diag_bign": (lambda: mt.HMC(5, 0.05, mt.EmpMCTuner(0.8,
                                                            adapt_step=50),
                                     mass_adapt="diag"),
                      "glm_logp_grad_tiled"),
    "hmcda": (lambda: mt.HMCDA(len=1.0), "glm_multistep_rows"),
    "mala_bign": (lambda: mt.MALA(0.02, mt.EmpMCTuner(0.574, adapt_step=50)),
                  "glm_logp_grad_tiled"),
}


@pytest.mark.parametrize("name", list(WARM))
def test_warmfused_matches_generic(name, monkeypatch):
    """run(task, chains=8, fused=True) takes the warm route (the Halton
    multistep kernel's plain version at small N; the tiled evaluation's
    above the threshold, lowered to 100 as tests/test_warmfused.py does)
    and agrees with the generic engine: per-chain means within 5 standard
    errors; final states resume at the frozen hyper-parameters."""
    make, kernel = WARM[name]
    if name.endswith("bign"):
        monkeypatch.setattr(glm_bign, "BIGN_THRESHOLD", 100)
    X, Y = _data(n=150, scales=np.array([1.0, 3.0, 1.0, 0.3]))
    m = mt.model(glm=("logistic", X, Y), dtype=F64, device="cpu")
    task = m * make() * mt.SerialMC(steps=900, burnin=300)
    assert pchains._route(MCMCTask(m, task.sampler, task.runner),
                          True) == "warm"
    gk.reset_counts()
    glm_bign.reset_counts()
    cf = mt.run(task, chains=8, seed=0, fused=True)
    plain = {**gk.PLAIN_CALLS, **glm_bign.PLAIN_CALLS}
    assert plain.pop(kernel) > 0 and not any(plain.values()), plain
    if kernel == "glm_multistep_rows":
        assert gk.PLAIN_CALLS[kernel] == 600 // 8  # _pick_k_trans(600)
    cg = mt.run(task, chains=8, seed=1, fused=False)
    assert _z(_chain_means(cf), _chain_means(cg)) < 5
    c0 = cf[0]
    assert c0.samples.shape == (600, 4) and c0.gradients.shape == (600, 4)
    assert set(c0.diagnostics) == set(cg[0].diagnostics)
    assert mt.acceptance(c0) > 40
    st = c0.task.state
    assert st.pars.dtype == F64 and st.i.item() == 901
    lp, g = m.evalallg(st.pars)
    torch.testing.assert_close(st.logtarget, lp)
    torch.testing.assert_close(st.grad, g)
    np.testing.assert_allclose(c0.samples.values[-1], st.pars.numpy(),
                               rtol=1e-5, atol=1e-6)
    frozen = [c.task.state for c in cf]
    if isinstance(task.sampler, mt.HMCDA):
        assert len({s.leap_step.item() for s in frozen}) == 1
        assert all(s.dual_leap_step.item() == s.leap_step.item()
                   for s in frozen)
    else:
        assert len({s.tune.step_size.item() for s in frozen}) == 1
        assert all(s.tune.accepted.item() == 0 for s in frozen)
    r1, r2 = mt.resume(c0, steps=40), mt.resume(c0, steps=40)
    np.testing.assert_array_equal(r1.samples.values, r2.samples.values)
    assert r1.task.pos == 940


def test_warm_route_matches_jax():
    """The slice as a whole: the port's warm route and the JAX package's
    (interpret mode) on adaptive HMC with a diagonal metric, 8 chains each:
    per-chain means within 5 standard errors, frozen steps within 25%."""
    X, Y = _data(scales=np.array([1.0, 3.0, 1.0, 0.3]))
    runner = dict(steps=500, burnin=200)
    jm = mc.model(glm=("logistic", X, Y))
    tm = mt.model(glm=("logistic", X, Y), dtype=F64, device="cpu")
    jc = mc.run(jm * mc.HMC(5, 0.05, mc.EmpMCTuner(0.8, adapt_step=50),
                            mass_adapt="diag") * mc.SerialMC(**runner),
                chains=8, seed=0, fused=True)
    tc = mt.run(tm * mt.HMC(5, 0.05, mt.EmpMCTuner(0.8, adapt_step=50),
                            mass_adapt="diag") * mt.SerialMC(**runner),
                chains=8, seed=0, fused=True)
    assert set(tc[0].diagnostics) == set(jc[0].diagnostics)
    assert tc[0].samples.shape == jc[0].samples.shape == (300, 4)
    assert _z(_chain_means(tc), _chain_means(jc)) < 5
    eps = tc[0].task.state.tune.step_size.item()
    jeps = float(jc[0].task.state.tune.step_size)
    assert abs(eps / jeps - 1) < 0.25, (eps, jeps)


@pytest.mark.parametrize("bign", [False, True], ids=["small_n", "big_n"])
def test_plain_mala_route(bign, monkeypatch):
    """Plain MALA takes the "hmc" route: one-leapfrog HMC through the Halton
    multistep kernel (T = eps, max_leaps = 1) at small N, the tiled driver
    above the threshold; it agrees with the generic MALA and ends in exact
    MALAStates."""
    if bign:
        monkeypatch.setattr(glm_bign, "BIGN_THRESHOLD", 100)
    X, Y = _data(n=150)
    m = mt.model(glm=("logistic", X, Y), dtype=F64, device="cpu")
    task = m * mt.MALA(0.03) * mt.SerialMC(steps=600, burnin=100)
    gk.reset_counts()
    glm_bign.reset_counts()
    cf = mt.run(task, chains=8, seed=0, fused=True)
    if bign:
        assert glm_bign.PLAIN_CALLS["glm_logp_grad_tiled"] == 601
        assert not any(gk.PLAIN_CALLS.values())
    else:
        assert gk.PLAIN_CALLS["glm_multistep_rows"] == 600 // 8
        assert not any(glm_bign.PLAIN_CALLS.values())
    cg = mt.run(task, chains=8, seed=1, fused=False)
    assert _z(_chain_means(cf), _chain_means(cg)) < 5
    assert abs(np.mean([mt.acceptance(c) for c in cf])
               - np.mean([mt.acceptance(c) for c in cg])) < 10
    st = cf[0].task.state
    assert isinstance(st, mt.MALAState) and st.i.item() == 601
    assert st.tune.step_size.item() == pytest.approx(0.03)
    r1, r2 = mt.resume(cf[0], steps=20), mt.resume(cf[0], steps=20)
    np.testing.assert_array_equal(r1.samples.values, r2.samples.values)
