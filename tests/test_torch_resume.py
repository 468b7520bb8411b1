"""The port's batched resume (``resume(list)`` through
``parallel.pchains.presume_serialmc``) and its fused continuation
(``ops.warmstart.fused_continue_chains``) against the JAX package's, on the
CPU, where the kernels' wrappers run their plain versions:

- from the same adapted states (a JAX ``run(..., fused=True)`` in interpret
  mode, carried over with ``utils.convert``) both continuations keep the
  frozen hyper-parameters, report the same ``epsilon`` and ChEES ``nleaps``
  rows and the same ``i``, and agree in their moments and acceptance;
- the JAX package's four resume tests (tests/test_warmfused.py), run on the
  port;
- ``continuation_route``'s routes and logged reasons, and
  ``continue_eligible`` against the JAX package's;
- two resumes of one list give the same bits, on both engines."""
import dataclasses
import logging
import types

import jax
import numpy as np
import pytest
import torch

import mcmc_jl_tpu as mc
from mcmc_jl_tpu.core.task import MCMCTask as JTask
from mcmc_jl_tpu.ops import warmstart as jws
import mcmc_jl_tpu_torch as mt
from mcmc_jl_tpu_torch.core.task import MCMCTask
from mcmc_jl_tpu_torch.ops import glm_bign
from mcmc_jl_tpu_torch.ops import glm_kernels as gk
from mcmc_jl_tpu_torch.ops import nuts_kernels as nk
from mcmc_jl_tpu_torch.ops import target_kernels as tk
from mcmc_jl_tpu_torch.ops import warmstart as tws
from mcmc_jl_tpu_torch.parallel import pchains
from mcmc_jl_tpu_torch.samplers.base import make_generator, tree_map

torch.set_num_threads(1)
F64 = torch.float64
Z_MAX = 5.0


def _data(n=90, d=4, seed=3):
    """tests/test_warmfused.py's data."""
    rng = np.random.default_rng(seed)
    X = np.column_stack([np.ones(n), rng.standard_normal((n, d - 1))])
    beta = rng.standard_normal(d) * 0.7
    Y = (rng.random(n) < 1.0 / (1.0 + np.exp(-X @ beta))).astype(np.float64)
    return X, Y


def _glm_models(n=90):
    X, Y = _data(n=n)
    return (mc.model(glm=("logistic", X, Y)),
            mt.model(glm=("logistic", X, Y), dtype=F64, device="cpu"))


def _ex(p):
    def ex(a, b):
        p.tilde(a, p.Gamma(3.0, 0.2))
        p.tilde(b, p.Normal(1.0, 2.0))
    return ex


def _target_models():
    """tests/test_torch_warm_target.py's catalog target (d 3)."""
    init = dict(a=np.full(2, 0.6), b=np.array([1.0]))
    return (mc.model(_ex(mc), gradient=True, **init),
            mt.model(_ex(mt), gradient=True, device="cpu", **init))


def _aniso_target():
    """tests/test_warmfused.py's anisotropic Gaussian (variances 4, 0.25,
    1) as a catalog DSL model, the port's custom-target kernels' form."""
    def ex(x, y, z):
        mt.tilde(x, mt.Normal(0.0, 2.0))
        mt.tilde(y, mt.Normal(0.0, 0.5))
        mt.tilde(z, mt.Normal(0.0, 1.0))

    m = mt.model(ex, gradient=True, device="cpu", x=np.array([0.1]),
                 y=np.array([-0.1]), z=np.array([0.2]))
    assert m.target_spec is not None
    return m


def _as_dict(state):
    return {f.name: (_as_dict(getattr(state, f.name))
                     if dataclasses.is_dataclass(getattr(state, f.name))
                     else np.asarray(getattr(state, f.name)))
            for f in dataclasses.fields(state)}


CONVERT = {"HMCState": mt.hmc_state_from_numpy,
           "HMCDAState": mt.hmcda_state_from_numpy,
           "MALAState": mt.mala_state_from_numpy,
           "ChEESState": mt.chees_state_from_numpy,
           "NUTSState": mt.nuts_state_from_numpy}


def _z(a, b):
    """max |mean difference| / se of two sets of per-chain means."""
    se = np.sqrt(a.var(0, ddof=1) / len(a) + b.var(0, ddof=1) / len(b))
    return float(np.max(np.abs(a.mean(0) - b.mean(0)) / se))


# ---- the continuation against the JAX package's, from the same states ------

# sampler maker, target model or not, frozen state fields, extra info rows
CONT = {
    "hmc_diag": (lambda p: p.HMC(5, 0.05, p.EmpMCTuner(0.8, adapt_step=50),
                                 mass_adapt="diag"), False,
                 ("tune.step_size", "tune.n_leaps"), ()),
    "hmcda": (lambda p: p.HMCDA(len=1.0), False,
              ("leap_step", "dual_leap_step"), ()),
    "mala": (lambda p: p.MALA(0.02, p.EmpMCTuner(0.574, adapt_step=20)),
             False, ("tune.step_size",), ()),
    "chees": (lambda p: p.ChEESHMC(len0=0.5, max_leaps=32), False,
              ("leap_step", "dual_leap_step", "log_len"),
              ("epsilon", "nleaps")),
    "nuts_diag": (lambda p: p.NUTS(maxdoublings=5, mass_adapt="diag"), False,
                  ("epsilon", "lebar"), ("epsilon",)),
    "hmc_target": (lambda p: p.HMC(5, 0.1, p.EmpMCTuner(0.8, adapt_step=50)),
                   True, ("tune.step_size", "tune.n_leaps"), ()),
}


def _field(state, path):
    for name in path.split("."):
        state = getattr(state, name)
    return np.asarray(state)


@pytest.mark.parametrize("name", list(CONT))
def test_continuation_matches_jax(name):
    """From JAX's adapted states (8 chains of ``run(..., fused=True)``,
    interpret mode), the port's fused continuation and the JAX package's
    keep the same frozen hyper-parameters (to 1e-12 relative), give the
    same ``epsilon`` and ChEES ``nleaps`` rows and the same ``i``, the same
    info keys and shapes, per-chain means within |z| < 5 and acceptance
    within 0.1."""
    make, target, frozen, rows = CONT[name]
    jm, tm = _target_models() if target else _glm_models()
    C, steps = 8, 64
    runner = mc.SerialMC(steps=150, burnin=100)
    js = make(mc)
    jc = mc.run(jm * js * runner, chains=C, seed=0, fused=True)
    jst = jax.tree_util.tree_map(lambda *xs: jax.numpy.stack(xs),
                                 *[c.task.state for c in jc])
    tst = CONVERT[type(jst).__name__](_as_dict(jax.device_get(jst)),
                                      device="cpu")
    ts = make(mt)
    assert pchains.continuation_route(tm, ts, C, True, tst) \
        == ("nuts" if name.startswith("nuts") else "warm")
    jinfos, jout = jws.fused_continue_chains(jm, js, jst, steps,
                                             jax.random.PRNGKey(5),
                                             interpret=True)
    tinfos, tout = tws.fused_continue_chains(tm, ts, tst, steps,
                                             make_generator("cpu", 5))
    assert set(tinfos) == set(jinfos)
    for k, v in jinfos.items():
        assert tuple(tinfos[k].shape) == tuple(v.shape), k
    np.testing.assert_array_equal(tout.i.numpy(), np.asarray(jout.i))
    assert np.all(tout.i.numpy() == np.asarray(jst.i) + steps)
    for path in frozen:
        want = _field(jout, path)
        np.testing.assert_allclose(_field(tout, path), want, rtol=1e-12)
        np.testing.assert_allclose(_field(tout, path), _field(jst, path),
                                   rtol=1e-12)
    for k in rows:
        np.testing.assert_allclose(tinfos[k].numpy(), np.asarray(jinfos[k]),
                                   rtol=1e-12)
    # the final states are exact: lp and gradient at the last draw
    lp, g = tm.evalallg(tout.pars)
    torch.testing.assert_close(tout.logtarget, lp)
    torch.testing.assert_close(tout.grad, g)
    tp = tinfos["ppars"].double().numpy()
    jp = np.asarray(jinfos["ppars"], np.float64)
    assert _z(tp.mean(0), jp.mean(0)) < Z_MAX
    acc_t = float(tinfos["accept"].double().mean())
    acc_j = float(np.asarray(jinfos["accept"], np.float64).mean())
    assert abs(acc_t - acc_j) < 0.1, (acc_t, acc_j)


def test_plain_hmc_continues_on_the_halton_rule():
    """A fixed-length ``HMC(nl, eps)`` continues, as in the JAX package,
    with the shared Halton leap counts in [1, 2 nl] around nl: the rows'
    leap counts are the JAX formula's at i0 = max(states.i), and a second
    segment extends the sequence."""
    _, tm = _glm_models()
    s = mt.HMC(4, 0.1)
    cs = mt.run(tm * s * mt.SerialMC(steps=40), chains=4, seed=0)
    states = tree_map(lambda *xs: torch.stack(xs), *[c.task.state
                                                     for c in cs])
    assert pchains.continuation_route(tm, s, 4, True) == "warm"
    seen = []
    orig = gk.glm_multistep_rows_ref

    def spy(*a, **k):
        out = orig(*a, **k)
        seen.append(out[3]["nleaps"][:, 0].tolist())
        return out

    cont = tws.make_fused_continuation(tm, s, states)
    gen = make_generator("cpu", 1)
    try:
        gk.glm_multistep_rows_ref = spy
        _, st1 = cont(states, 16, gen)
        _, st2 = cont(st1, 16, gen)
    finally:
        gk.glm_multistep_rows_ref = orig
    nl = [x for launch in seen for x in launch]
    want = [gk.halton_leaps(41 + t, 0.1, 2 * 4 * 0.1, 8) for t in range(32)]
    assert nl == want and min(nl) >= 1 and max(nl) <= 8 and len(set(nl)) > 2
    assert st2.i.tolist() == [41 + 32] * 4


# ---- the JAX package's resume tests (tests/test_warmfused.py), on the port --


def test_fused_resume_list_continues_at_fused_route(monkeypatch):
    """resume(list) of an adapted GLM run re-batches the chains and routes
    the continuation through the fused continuation."""
    _, m = _glm_models()
    s = mt.HMC(5, 0.05, mt.EmpMCTuner(0.8, adapt_step=50))
    task = m * s * mt.SerialMC(steps=600, burnin=200)
    chains = mt.run(task, chains=8, seed=0, fused=True)
    eps_frozen = float(chains[0].task.state.tune.step_size)

    calls = []
    orig = tws.fused_continue_chains

    def spy(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)

    monkeypatch.setattr(tws, "fused_continue_chains", spy)
    gk.reset_counts()
    cont = mt.resume(chains, steps=300, fused=True)
    monkeypatch.undo()
    assert calls, "fused continuation was not routed"
    assert gk.PLAIN_CALLS["glm_multistep_rows"] == 300 // 6
    assert len(cont) == 8

    # bit-coherent states: the continuation keeps the frozen hypers
    assert float(cont[0].task.state.tune.step_size) == eps_frozen
    assert cont[0].samples.shape[0] == 300
    assert cont[0].task.pos == chains[0].task.pos + 300

    # statistics match the original sampling phase
    mu_orig = np.mean([c.samples.values[200:].mean(0) for c in chains],
                      axis=0)
    mu_cont = np.mean([c.samples.values.mean(0) for c in cont], axis=0)
    se = np.sqrt(np.mean([mt.var(c) for c in cont], axis=0) / len(cont))
    assert np.all(np.abs(mu_cont - mu_orig) < 6 * se + 0.05)
    assert np.mean([mt.acceptance(c) for c in cont]) > 40

    # the generic engine (fused=False) also re-batches and stays finite
    calls.clear()
    cont2 = mt.resume(chains, steps=50, fused=False)
    assert not calls and len(cont2) == 8
    assert np.all(np.isfinite(cont2[0].samples.values))


def test_repeated_resume_advances_prng_and_pos():
    """Successive resume() segments draw different streams (the group's
    generator comes from the stored task keys, which each segment stamps
    anew) and accumulate pos per chain."""
    _, m = _glm_models()
    s = mt.HMC(5, 0.05, mt.EmpMCTuner(0.8, adapt_step=50))
    chains = mt.run(m * s * mt.SerialMC(steps=400, burnin=200), chains=4,
                    seed=0, fused=True)
    c2 = mt.resume(chains, steps=50, fused=True)
    c3 = mt.resume(c2, steps=50, fused=True)
    assert not np.allclose(c2[0].samples.values, c3[0].samples.values)
    assert c2[0].task.pos == 400 + 50
    assert c3[0].task.pos == 400 + 100
    # grouped chains with different histories keep their own pos
    mixed = [c3[0], c2[1]]
    c4 = mt.resume(mixed, steps=25, fused=True)
    assert c4[0].task.pos == 525 and c4[1].task.pos == 475


def test_resume_list_heterogeneous_groups():
    """presume_serialmc splits a mixed chain list into groups and resumes
    each (fused where eligible, generic otherwise), in the list's order."""
    _, m = _glm_models()
    r = mt.SerialMC(steps=300, burnin=100)
    a = mt.run(m * mt.HMC(5, 0.05, mt.EmpMCTuner(0.8, adapt_step=50)) * r,
               chains=2, seed=0, fused=True)
    b = mt.run(m * mt.RWM(0.1) * r, chains=2, seed=1)
    mixed = [a[0], b[0], a[1], b[1]]
    cont = mt.resume(mixed, steps=50, fused=True)
    assert len(cont) == 4
    for i, c in enumerate(cont):
        assert c.samples.shape[0] == 50
        assert np.all(np.isfinite(c.samples.values)), i
    # order preserved: HMC chains carry tuner state, RWM chains don't
    assert hasattr(cont[0].task.state, "tune")
    assert not hasattr(cont[1].task.state, "tune")
    assert cont[2].task.sampler is a[1].task.sampler
    assert cont[3].task.pos == b[1].task.pos + 50


def test_fused_resume_target_and_chees():
    """The fused continuation covers the custom-target and ChEES
    families."""
    m = _aniso_target()
    s = mt.HMC(5, 0.1, mt.EmpMCTuner(0.8, adapt_step=50))
    chains = mt.run(m * s * mt.SerialMC(steps=500, burnin=200), chains=4,
                    seed=0, fused=True)
    tk.reset_counts()
    cont = mt.resume(chains, steps=200, fused=True)
    assert tk.PLAIN_CALLS["target_leapfrogs"] == 200
    var = np.mean([c.samples.values.var(0) for c in cont], axis=0)
    assert np.all(np.abs(var / np.array([4.0, 0.25, 1.0]) - 1.0) < 0.6), var

    _, mg = _glm_models()
    sc = mt.ChEESHMC(len0=0.5, max_leaps=32)
    chains = mt.run(mg * sc * mt.SerialMC(steps=500, burnin=200), chains=4,
                    seed=0, fused=True)
    cont = mt.resume(chains, steps=200, fused=True)
    c0 = cont[0]
    assert np.ptp(c0.diagnostics["epsilon"]) < 1e-12  # frozen shared eps
    assert np.ptp(c0.diagnostics["nleaps"]) > 0       # Halton continues
    assert np.all(np.isfinite(c0.samples.values))

    # ChEES continuation on a catalog target (the trajectory kernel)
    st = mt.ChEESHMC(len0=0.5, max_leaps=32)
    chains = mt.run(m * st * mt.SerialMC(steps=500, burnin=200), chains=4,
                    seed=0, fused=True)
    cont = mt.resume(chains, steps=200, fused=True)
    assert np.ptp(cont[0].diagnostics["epsilon"]) < 1e-12
    assert np.all(np.isfinite(cont[0].samples.values))


# ---- routing ----------------------------------------------------------------


def test_continuation_routes_and_reasons(caplog, monkeypatch):
    """continuation_route names the route of each eligible family and
    returns False with a logged reason for each refusal."""
    _, gm = _glm_models()
    tm = _aniso_target()
    tun = mt.EmpMCTuner(0.8, adapt_step=50)
    for m in (gm, tm):
        for s, route in ((mt.HMC(5, 0.1), "warm"),
                         (mt.HMC(5, 0.1, tun, mass_adapt="diag"), "warm"),
                         (mt.HMCDA(integrator="2stage"), "warm"),
                         (mt.MALA(0.05), "warm"), (mt.MALA(0.05, tun), "warm"),
                         (mt.ChEESHMC(), "warm"),
                         (mt.NUTS(4, mass_adapt="diag"), "nuts")):
            assert pchains.continuation_route(m, s, 8, True) == route, s
            assert tws.continue_eligible(MCMCTask(m, s, None))
    callable_m = mt.model(lambda v: -(v * v).sum(), gradient=True,
                          init=np.zeros(2), device="cpu")
    monkeypatch.setattr(glm_bign, "BIGN_THRESHOLD", 50)
    refused = [
        (gm, mt.RWM(0.1), "RWM has no fused continuation"),
        (gm, mt.HMC(5, 0.1, store_leaps=True), "store_leaps=True"),
        (tm, mt.NUTS(warm_handoff=True), "NUTSState.tlen > 0"),
        (gm, mt.NUTS(4), "N = 90 > 50"),
        (tm, mt.NUTS(nk.MAX_DOUBLINGS + 1),
         f"maxdoublings = {nk.MAX_DOUBLINGS + 1} > {nk.MAX_DOUBLINGS}"),
        (callable_m, mt.HMC(5, 0.1, tun), "not a product of catalog"),
    ]
    for m, s, why in refused:
        caplog.clear()
        with caplog.at_level(logging.INFO):
            assert pchains.continuation_route(m, s, 8, True) is False, s
        assert why in caplog.text, (why, caplog.text)
    caplog.clear()
    with caplog.at_level(logging.INFO):
        assert pchains.continuation_route(gm, mt.HMC(5, 0.1), 8,
                                          "auto") is False
        assert pchains.continuation_route(gm, mt.HMC(5, 0.1), 8,
                                          False) is False
    assert "fused='auto' takes CUDA float32 models" in caplog.text
    assert "fused=False" in caplog.text
    # above the threshold the HMC family still continues (the tiled kernel)
    assert pchains.continuation_route(gm, mt.HMC(5, 0.1), 8, True) == "warm"
    # so do warm-handoff states that carry their trajectory time, on a GLM
    # (the tiled kernel) and on a catalog target, as in the JAX package
    timed = types.SimpleNamespace(tlen=torch.full((8,), 1.5, dtype=F64))
    for m in (gm, tm):
        assert pchains.continuation_route(m, mt.NUTS(warm_handoff=True), 8,
                                          True, states=timed) == "warm"


def test_continue_eligible_matches_jax():
    """continue_eligible agrees with the JAX package's on the GLM and a
    catalog target for every sampler both packages build; for the warm
    handoff, with states that carry no trajectory time and with states
    that do."""
    X, Y = _data()
    jg, tg = mc.model(glm=("logistic", X, Y)), mt.model(
        glm=("logistic", X, Y), dtype=F64, device="cpu")
    jt, tt = _target_models()
    pairs = [
        (lambda p: p.HMC(5, 0.1)),
        (lambda p: p.HMC(5, 0.1, p.EmpMCTuner(0.8), mass_adapt="diag-win")),
        (lambda p: p.HMC(5, 0.1, store_leaps=True)),
        (lambda p: p.HMC(5, 0.1, integrator="3stage")),
        (lambda p: p.HMCDA()),
        (lambda p: p.HMCDA(store_leaps=True)),
        (lambda p: p.MALA(0.1)),
        (lambda p: p.ChEESHMC(mass_adapt="diag")),
        (lambda p: p.NUTS(5)),
        (lambda p: p.NUTS(5, multinomial=True, mass_adapt="diag")),
        (lambda p: p.RWM(0.1)),
    ]
    for jm, tm in ((jg, tg), (jt, tt)):
        for make in pairs:
            want = jws.continue_eligible(JTask(jm, make(mc), None))
            assert tws.continue_eligible(MCMCTask(tm, make(mt), None)) \
                == want, make(mt)
    for tlen in (0.0, 1.5):
        jstates = types.SimpleNamespace(tlen=np.full(8, tlen))
        tstates = types.SimpleNamespace(tlen=torch.full((8,), tlen))
        for jm, tm in ((jg, tg), (jt, tt)):
            want = jws.continue_eligible(JTask(jm, mc.NUTS(warm_handoff=True),
                                               None), states=jstates)
            assert want == (tlen > 0)
            assert tws.continue_eligible(MCMCTask(
                tm, mt.NUTS(warm_handoff=True), None), states=tstates) \
                == want
            assert not tws.continue_eligible(MCMCTask(
                tm, mt.NUTS(warm_handoff=True), None))


# ---- determinism ------------------------------------------------------------


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "generic"])
def test_resume_list_is_repeatable(fused):
    """Two resume(list) calls on one list give the same bits; resuming the
    result draws another stream."""
    _, m = _glm_models()
    s = mt.NUTS(4) if fused else mt.HMC(5, 0.05, mt.EmpMCTuner(0.8))
    cs = mt.run(m * s * mt.SerialMC(steps=60, burnin=30), chains=4, seed=2,
                fused=fused)
    nk.reset_counts()
    a = mt.resume(cs, steps=20, fused=fused)
    b = mt.resume(cs, steps=20, fused=fused)
    assert nk.PLAIN_CALLS["glm_nuts_transition"] == (40 if fused else 0)
    for ca, cb in zip(a, b):
        np.testing.assert_array_equal(ca.samples.values, cb.samples.values)
        assert torch.equal(ca.task.key, cb.task.key)
    c = mt.resume(a, steps=20, fused=fused)
    assert not np.array_equal(c[0].samples.values, a[0].samples.values)
    # one chain's resume is the exact single-chain continuation
    r1, r2 = mt.resume(cs[1], steps=10), mt.resume(cs[1], steps=10)
    np.testing.assert_array_equal(r1.samples.values, r2.samples.values)
    assert r1.task.pos == cs[1].task.pos + 10
