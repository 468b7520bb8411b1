"""The NUTS warm handoff, ``NUTS(warm_handoff=True)``, in the port against
the JAX package's (``mcmc_jl_tpu/ops/warmstart.py`` ``warmfused_nuts_chains``
and the handoff arm of ``make_fused_continuation``), on the CPU, where the
kernels' wrappers run their plain versions:

- ``warm_eligible``, ``continue_eligible`` and the two routes agree with
  the JAX package's on a GLM and a catalog target, for states None, with
  ``tlen == 0`` and with ``tlen > 0`` (JAX states through
  ``utils.convert``); a handoff routes "warm", also above
  ``BIGN_THRESHOLD``, where exact NUTS is refused;
- the freeze: ``eps`` and ``T`` on the port's own warmup rows equal the
  JAX formula computed in numpy;
- the continuation from a converted JAX handoff state gives the same
  ``nleaps`` rows as the JAX continuation, bit for bit, and the same
  ``epsilon`` to float32 rounding;
- tests/test_warmfused.py's handoff gates (the GLM against exact NUTS, a
  catalog target's variances, resumes), plus the dense and the large-N
  arms;
- a mesh: each chain shard of the sampling phase is bitwise the unsharded
  continuation of that shard on its own stream."""
import dataclasses
import functools
import logging

import jax
import numpy as np
import pytest
import torch

import mcmc_jl_tpu as mc
from mcmc_jl_tpu.core.task import MCMCTask as JTask
from mcmc_jl_tpu.ops import warmstart as jws
from mcmc_jl_tpu.parallel import pchains as jpchains
import mcmc_jl_tpu_torch as mt
from mcmc_jl_tpu_torch.core.task import MCMCTask
from mcmc_jl_tpu_torch.ops import glm_bign
from mcmc_jl_tpu_torch.ops import glm_kernels as gk
from mcmc_jl_tpu_torch.ops import nuts_kernels as nk
from mcmc_jl_tpu_torch.ops import target_kernels as tk
from mcmc_jl_tpu_torch.ops import warmstart as tws
from mcmc_jl_tpu_torch.parallel import mesh as tmesh
from mcmc_jl_tpu_torch.parallel import pchains
from mcmc_jl_tpu_torch.samplers.base import make_generator, tree_map

torch.set_num_threads(1)
F64 = torch.float64


def _data(n=90, d=4, seed=3):
    """tests/test_warmfused.py's data."""
    rng = np.random.default_rng(seed)
    X = np.column_stack([np.ones(n), rng.standard_normal((n, d - 1))])
    beta = rng.standard_normal(d) * 0.7
    Y = (rng.random(n) < 1.0 / (1.0 + np.exp(-X @ beta))).astype(np.float64)
    return X, Y


def _glm_models(dtype=F64):
    X, Y = _data()
    return (mc.model(glm=("logistic", X, Y)),
            mt.model(glm=("logistic", X, Y), dtype=dtype, device="cpu"))


def _ex(p):
    def ex(a, b):
        p.tilde(a, p.Gamma(3.0, 0.2))
        p.tilde(b, p.Normal(1.0, 2.0))
    return ex


def _target_models():
    """A catalog target of d 3 in both packages."""
    init = dict(a=np.full(2, 0.6), b=np.array([1.0]))
    return (mc.model(_ex(mc), gradient=True, **init),
            mt.model(_ex(mt), gradient=True, device="cpu", **init))


def _aniso_target():
    """tests/test_warmfused.py's anisotropic Gaussian (variances 4, 0.25,
    1) as a catalog DSL model."""
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


def _stack(chains):
    return tree_map(lambda *xs: torch.stack(xs),
                    *[c.task.state for c in chains])


def _pooled_gate(chains_a, chains_b, tol=0.05, nse=6):
    """tests/test_warmfused.py ``_pooled_gate``."""
    mu_a = np.mean([c.samples.values.mean(0) for c in chains_a], axis=0)
    mu_b = np.mean([c.samples.values.mean(0) for c in chains_b], axis=0)
    se = np.sqrt(np.mean([mt.var(c) for c in chains_b], axis=0)
                 / len(chains_b))
    assert np.all(np.abs(mu_a - mu_b) < nse * se + tol), (mu_a, mu_b, se)


@functools.lru_cache(maxsize=None)
def _jax_handoff():
    """JAX's handoff states: 8 chains of ``run(NUTS(5, warm_handoff=True) *
    SerialMC(150, 100), fused=True)`` in interpret mode, stacked, and the
    port's conversion of them."""
    jm, _ = _glm_models()
    js = mc.NUTS(maxdoublings=5, warm_handoff=True)
    jc = mc.run(jm * js * mc.SerialMC(steps=150, burnin=100), chains=8,
                seed=0, fused=True)
    jst = jax.tree_util.tree_map(lambda *xs: jax.numpy.stack(xs),
                                 *[c.task.state for c in jc])
    tst = mt.nuts_state_from_numpy(_as_dict(jax.device_get(jst)),
                                   device="cpu")
    return jst, tst


# ---- eligibility and routing ------------------------------------------------


def test_eligibility_and_routes_match_jax(monkeypatch, caplog):
    """warm_eligible and continue_eligible agree with JAX's on a GLM and a
    catalog target for states None, ``tlen == 0`` and ``tlen > 0``; the
    handoff routes "warm" in ``_route`` and ``continuation_route``, also
    above BIGN_THRESHOLD and past MAX_DOUBLINGS, where exact NUTS takes
    the generic engine; states without a trajectory time continue on the
    generic engine with the reason logged."""
    jst, tst = _jax_handoff()
    assert float(np.min(np.asarray(jst.tlen))) > 0
    np.testing.assert_array_equal(tst.tlen.numpy(), np.asarray(jst.tlen))
    jst0 = jst.replace(tlen=jax.numpy.zeros_like(jst.tlen))
    tst0 = tst.replace(tlen=torch.zeros_like(tst.tlen))
    jg, tg = _glm_models()
    jt, tt = _target_models()
    r, tr = mc.SerialMC(steps=600, burnin=200), mt.SerialMC(steps=600,
                                                            burnin=200)
    for jm, tm in ((jg, tg), (jt, tt)):
        js, ts = (mc.NUTS(4, warm_handoff=True),
                  mt.NUTS(4, warm_handoff=True))
        assert jws.warm_eligible(JTask(jm, js, r))
        assert tws.warm_eligible(MCMCTask(tm, ts, tr))
        assert pchains._route(MCMCTask(tm, ts, tr), True) == "warm"
        assert pchains._route(MCMCTask(tm, mt.NUTS(4), tr), True) == "nuts"
        for j_states, t_states in ((None, None), (jst0, tst0), (jst, tst)):
            want = jws.continue_eligible(JTask(jm, js, None),
                                         states=j_states)
            assert tws.continue_eligible(MCMCTask(tm, ts, None),
                                         states=t_states) == want
            assert want == (j_states is jst)
            route = pchains.continuation_route(tm, ts, 8, True,
                                               states=t_states)
            assert route == ("warm" if want else False)
            # JAX's forced route decides the same
            assert jpchains.continuation_route(
                jm, js, 8, True, states=j_states) == want
    # too deep for the NUTS kernels: a handoff still takes the warm route
    deep = mt.NUTS(nk.MAX_DOUBLINGS + 1, warm_handoff=True)
    assert pchains._route(MCMCTask(tg, deep, tr), True) == "warm"
    assert not pchains._route(MCMCTask(tg, mt.NUTS(nk.MAX_DOUBLINGS + 1),
                                       tr), True)
    # above BIGN_THRESHOLD: exact NUTS is refused, the handoff runs kernel 4
    monkeypatch.setattr(glm_bign, "BIGN_THRESHOLD", 50)
    ts = mt.NUTS(4, warm_handoff=True)
    assert pchains._route(MCMCTask(tg, ts, tr), True) == "warm"
    assert pchains.continuation_route(tg, ts, 8, True, states=tst) == "warm"
    assert not pchains._route(MCMCTask(tg, mt.NUTS(4), tr), True)
    assert pchains.continuation_route(tg, mt.NUTS(4), 8, True) is False
    assert not pchains._route(MCMCTask(tg, ts, tr), "auto")  # CPU model

    # the reason a handoff without a trajectory time continues generic
    caplog.clear()
    with caplog.at_level(logging.INFO):
        assert pchains.continuation_route(tt, ts, 8, True,
                                          states=tst0) is False
    assert "NUTSState.tlen > 0" in caplog.text


# ---- the freeze -------------------------------------------------------------


def test_freeze_matches_the_jax_formula():
    """On the port's own warmup (float64), ``eps`` is the median of
    ``exp(lebar)`` and ``T`` twice the median of ``max(2^j - 1, 1)`` over
    the second half of the ``ndoublings`` rows, times ``eps`` (JAX
    warmstart.py:1366-1375), to 1e-12; the pipeline writes that ``T`` into
    every chain's ``tlen`` and freezes ``epsilon``/``lebar`` at ``eps``;
    the warmup's ``nleaps`` rows are ``2^j - 1``."""
    _, tm = _glm_models()
    s = mt.NUTS(maxdoublings=5, warm_handoff=True)
    runner = mt.SerialMC(steps=140, burnin=61)
    states_w, infos_w = tws._warmup(tm, s, runner, 6,
                                    make_generator("cpu", 3))
    eps, T = tws._handoff_freeze(states_w, infos_w["ndoublings"])
    lebar = states_w.lebar.numpy()
    j = infos_w["ndoublings"].numpy().astype(np.float64)
    assert j.shape == (61, 6)
    want_eps = float(np.median(np.exp(lebar)))
    half = j.shape[0] // 2
    want_T = 2.0 * float(np.median(np.maximum(2.0 ** j[half:] - 1.0,
                                              1.0))) * want_eps
    np.testing.assert_allclose(eps, want_eps, rtol=1e-12)
    np.testing.assert_allclose(T, want_T, rtol=1e-12)
    assert T > 0

    infos, st = tws.warmfused_chains(tm, s, runner, 6,
                                     make_generator("cpu", 3))
    assert set(infos) == {"ppars", "pgrads", "plogtarget", "accept",
                          "epsilon", "nleaps"}
    np.testing.assert_allclose(st.tlen.numpy(), want_T, rtol=1e-12)
    np.testing.assert_allclose(st.epsilon.numpy(), want_eps, rtol=1e-12)
    np.testing.assert_allclose(st.lebar.numpy(), np.log(want_eps),
                               rtol=1e-12)
    assert st.i.tolist() == [141] * 6
    nl = infos["nleaps"].numpy()
    assert nl.dtype == np.int32 and nl.shape == (140, 6)
    np.testing.assert_array_equal(nl[:61], 2 ** j.astype(np.int64) - 1)
    # the sampling rows: the Halton rule at (eps, T) from index burnin + 1
    want = [gk.halton_leaps(62 + t, want_eps, want_T, 32) for t in range(79)]
    assert nl[61:, 0].tolist() == want and np.all(nl[61:] == nl[61:, :1])
    assert np.ptp(infos["epsilon"][61:].numpy()) == 0


# ---- the continuation against JAX's -----------------------------------------


def test_continuation_nleaps_match_jax():
    """From JAX's handoff states (8 chains), the port's fused continuation
    of 16 transitions and the JAX package's (interpret mode) give the same
    ``nleaps`` rows bit for bit, ``epsilon`` equal to float32 rounding, the
    same info keys and shapes, ``i``, and ``tlen`` kept."""
    jst, tst = _jax_handoff()
    jm, tm = _glm_models()
    js = mc.NUTS(maxdoublings=5, warm_handoff=True)
    ts = mt.NUTS(maxdoublings=5, warm_handoff=True)
    steps = 16
    jinfos, jout = jws.fused_continue_chains(jm, js, jst, steps,
                                             jax.random.PRNGKey(5),
                                             interpret=True)
    gk.reset_counts()
    tinfos, tout = tws.fused_continue_chains(tm, ts, tst, steps,
                                             make_generator("cpu", 5))
    assert gk.PLAIN_CALLS["glm_multistep_rows"] == 2  # 16 = 2 launches of 8
    assert set(tinfos) == set(jinfos) == {"ppars", "pgrads", "plogtarget",
                                          "accept", "epsilon", "nleaps"}
    for k, v in jinfos.items():
        assert tuple(tinfos[k].shape) == tuple(v.shape), k
    np.testing.assert_array_equal(tinfos["nleaps"].numpy(),
                                  np.asarray(jinfos["nleaps"]))
    assert np.ptp(tinfos["nleaps"].numpy()) > 0
    np.testing.assert_allclose(tinfos["epsilon"].numpy(),
                               np.asarray(jinfos["epsilon"]), rtol=2e-7)
    np.testing.assert_array_equal(tout.i.numpy(), np.asarray(jout.i))
    np.testing.assert_array_equal(tout.tlen.numpy(), np.asarray(jout.tlen))
    np.testing.assert_allclose(tout.epsilon.numpy(), np.asarray(jout.epsilon),
                               rtol=1e-12)
    np.testing.assert_allclose(tout.lebar.numpy(), np.asarray(jout.lebar),
                               rtol=1e-12)
    acc_t = float(tinfos["accept"].double().mean())
    acc_j = float(np.asarray(jinfos["accept"], np.float64).mean())
    assert abs(acc_t - acc_j) < 0.15, (acc_t, acc_j)


# ---- tests/test_warmfused.py's gates, on the port ---------------------------


def test_handoff_matches_exact_nuts():
    """tests/test_warmfused.py:578: the GLM handoff through kernel 3b's
    plain version against exact NUTS on the generic engine (pooled gate);
    frozen shared ``epsilon``, jittered ``nleaps``, acceptance > 40, the
    state's ``epsilon == exp(lebar)``, and a resume."""
    _, m = _glm_models()
    s = mt.NUTS(maxdoublings=5, warm_handoff=True)
    task = m * s * mt.SerialMC(steps=600, burnin=200)
    gk.reset_counts()
    nk.reset_counts()
    chains_warm = mt.run(task, chains=8, seed=0, fused=True)
    assert gk.PLAIN_CALLS["glm_multistep_rows"] == 400 // 8
    assert not any(nk.PLAIN_CALLS.values())
    chains_gen = mt.run(m * mt.NUTS(maxdoublings=5) * task.runner, chains=8,
                        seed=0, fused=False)
    _pooled_gate(chains_warm, chains_gen)
    c0 = chains_warm[0]
    eps_tail = c0.diagnostics["epsilon"][-300:]
    assert np.ptp(eps_tail) < 1e-12 and eps_tail[0] > 0
    assert np.ptp(c0.diagnostics["nleaps"][-300:]) > 0
    assert mt.acceptance(c0) > 40
    st = c0.task.state
    assert float(st.epsilon) == float(torch.exp(st.lebar))
    c1 = mt.resume(c0, steps=100)
    assert np.all(np.isfinite(c1.samples.values))


def test_handoff_catalog_target():
    """tests/test_warmfused.py:447: the handoff on a catalog target through
    kernel 5's plain version: variances within 50% of (4, 0.25, 1),
    acceptance > 40."""
    m = _aniso_target()
    s = mt.NUTS(maxdoublings=5, warm_handoff=True)
    task = m * s * mt.SerialMC(steps=700, burnin=250)
    assert tws.warm_eligible(MCMCTask(m, s, task.runner))
    tk.reset_counts()
    chains_warm = mt.run(task, chains=8, seed=0, fused=True)
    assert tk.PLAIN_CALLS["target_leapfrogs"] > 0
    var = np.mean([c.samples.values.var(0) for c in chains_warm], axis=0)
    assert np.all(np.abs(var / np.array([4.0, 0.25, 1.0]) - 1.0) < 0.5), var
    assert np.mean([mt.acceptance(c) for c in chains_warm]) > 40
    assert "nleaps" in chains_warm[0].diagnostics


@pytest.mark.parametrize("arm", ["dense", "bign", "target_dense"])
def test_handoff_dense_and_bign_arms(arm, monkeypatch):
    """The dense metric on a GLM (kernel 3b's ``_mat`` variant), the
    large-N arm (``BIGN_THRESHOLD`` lowered: kernel 4) and the dense metric
    on a catalog target (kernel 5 dense), each against exact NUTS on the
    generic engine (pooled gate), with ``tlen`` carried for a resume that
    continues on the same kernel."""
    if arm == "target_dense":
        m = _aniso_target()
    else:
        _, m = _glm_models()
    mass = "dense" if arm != "bign" else "diag"
    s = mt.NUTS(maxdoublings=5, mass_adapt=mass, warm_handoff=True)
    runner = (mt.SerialMC(steps=300, burnin=120) if arm == "target_dense"
              else mt.SerialMC(steps=500, burnin=200))
    if arm == "bign":
        monkeypatch.setattr(glm_bign, "BIGN_THRESHOLD", 50)
    kernel = {"dense": "glm_multistep_rows",
              "bign": "glm_logp_grad_tiled",
              "target_dense": "target_leapfrogs_dense"}[arm]
    priors = []  # kernel 3b's prior: a (d, d) matrix is its _mat variant
    orig = gk.glm_multistep_rows_ref

    def spy(*a, **kw):
        priors.append(np.ndim(kw["prior_prec"]))
        return orig(*a, **kw)

    monkeypatch.setattr(gk, "glm_multistep_rows_ref", spy)
    for mod in (gk, glm_bign, tk, nk):
        mod.reset_counts()
    cw = mt.run(m * s * runner, chains=8, seed=0, fused=True)
    calls = {**gk.PLAIN_CALLS, **glm_bign.PLAIN_CALLS, **tk.PLAIN_CALLS}
    assert calls[kernel] > 0, calls
    assert not any(nk.PLAIN_CALLS.values())
    assert set(priors) == ({2} if arm == "dense" else set())
    cg = mt.run(m * mt.NUTS(maxdoublings=5, mass_adapt=mass) * runner,
                chains=8, seed=0, fused=False)
    _pooled_gate(cw, cg, nse=6, tol=0.1)
    assert float(cw[0].task.state.tlen) > 0
    for mod in (gk, glm_bign, tk):
        mod.reset_counts()
    cont = mt.resume(cw, steps=48, fused=True)
    calls = {**gk.PLAIN_CALLS, **glm_bign.PLAIN_CALLS, **tk.PLAIN_CALLS}
    assert calls[kernel] > 0, calls
    assert "nleaps" in cont[0].diagnostics
    assert np.all(np.isfinite(cont[0].samples.values))


def test_fused_resume_handoff():
    """tests/test_warmfused.py:796: handoff chains carry ``tlen`` and resume
    through the fused continuation, which keeps it, so a second resume
    fuses too; a handoff run on the generic engine has ``tlen == 0`` and
    resumes on the generic engine, with ``ndoublings`` in its rows."""
    _, m = _glm_models()
    s = mt.NUTS(maxdoublings=5, warm_handoff=True)
    chains = mt.run(m * s * mt.SerialMC(steps=500, burnin=200), chains=4,
                    seed=0, fused=True)
    assert float(chains[0].task.state.tlen) > 0.0
    gk.reset_counts()
    cont = mt.resume(chains, steps=200, fused=True)
    assert gk.PLAIN_CALLS["glm_multistep_rows"] == 25
    c0 = cont[0]
    assert np.ptp(c0.diagnostics["epsilon"]) < 1e-12
    assert "nleaps" in c0.diagnostics
    assert np.all(np.isfinite(c0.samples.values))
    assert float(cont[0].task.state.tlen) > 0.0
    gk.reset_counts()
    cont2 = mt.resume(cont, steps=100, fused=True)
    assert gk.PLAIN_CALLS["glm_multistep_rows"] == 20  # 20 launches of 5
    assert np.all(np.isfinite(cont2[0].samples.values))
    assert cont2[0].task.pos == 800

    chains2 = mt.run(m * s * mt.SerialMC(steps=200, burnin=100), chains=2,
                     seed=0, fused=False)
    assert float(chains2[0].task.state.tlen) == 0.0
    gk.reset_counts()
    cont3 = mt.resume(chains2, steps=60, fused=True)
    assert "ndoublings" in cont3[0].diagnostics
    assert not any(gk.PLAIN_CALLS.values())


# ---- a mesh -----------------------------------------------------------------


def test_mesh_shards_bitwise():
    """The handoff's sampling phase on a virtual mesh of 4 CPU entries:
    each chain shard is bitwise the unsharded continuation of that shard
    from the seed the mesh draws for it (unit metric, so every shard
    freezes the same ``(eps, T)``); ``run(..., mesh=)`` runs the whole
    pipeline with finite draws and ``tlen`` carried."""
    _, m = _glm_models(torch.float32)
    s = mt.NUTS(maxdoublings=4, warm_handoff=True)
    mesh = tmesh.Mesh(["cpu"] * 4, ("chains",))
    cs = mt.run(m * s * mt.SerialMC(steps=120, burnin=60), chains=8, seed=0,
                fused=True, mesh=mesh)
    assert all(np.all(np.isfinite(c.samples.values)) for c in cs)
    states = _stack(cs)
    assert torch.all(states.tlen > 0) and np.ptp(states.tlen.numpy()) == 0
    gen = make_generator("cpu", 9)
    seeds = torch.randint(0, 2 ** 62, (4,), generator=make_generator(
        "cpu", 9)).tolist()
    infos, out = tws.make_fused_continuation(m, s, states, mesh=mesh)(
        states, 16, gen)
    for i in range(4):
        sl = slice(2 * i, 2 * i + 2)
        part = tree_map(lambda a: a[sl], states)
        inf_i, out_i = tws.make_fused_continuation(m, s, part)(
            part, 16, make_generator("cpu", seeds[i]))
        assert torch.equal(out_i.pars, out.pars[sl]), i
        for k in inf_i:
            assert torch.equal(inf_i[k], infos[k][:, sl]), (i, k)
