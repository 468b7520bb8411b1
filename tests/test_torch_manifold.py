"""The port's SMMALA and PMALA (samplers/smmala.py, pmala.py) against the
JAX package's, on the CPU in float64 (dtypes pinned on both sides).

- The batched helpers against ``jax.vmap`` of JAX's on random SPD metrics
  and a dG that is not symmetric in its last two axes, at 1e-12.
- One step on the draws of a JAX step replayed from its key, 8 chains of
  the vaso probit model (examples/probit_regression.py, with a torch copy
  of its closed forms held at 1e-10 first): the new state and every info
  entry at 1e-9, with and without the tuner; a proposal whose metric is
  not positive definite rejects in both packages and nothing raises.
- Whole runs through ``parallel.pchains.run_chains`` on
  tests/test_samplers_stat.py's 3-D Gaussian, held to its gates (|z| < 5
  from the spread of the per-chain means, sd within 20%, acceptance above
  5%), and on the vaso probit against the JAX package's runs within
  tests/test_examples.py's tolerance.
- The generic-engine routes, resumes, the converters and ``linear_zv``."""
import dataclasses
import logging
import math
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mcmc_jl_tpu as mc
from mcmc_jl_tpu.parallel import run_chains as jax_run_chains
from mcmc_jl_tpu.samplers import pmala as jpm
from mcmc_jl_tpu.samplers import smmala as jsm
from mcmc_jl_tpu.samplers.base import RunCtx as JRunCtx
import mcmc_jl_tpu_torch as mt
from mcmc_jl_tpu_torch.ops import (glm_bign, glm_kernels, nuts_kernels,
                                   rwm_kernels, target_kernels)
from mcmc_jl_tpu_torch.parallel import pchains
from mcmc_jl_tpu_torch.samplers import pmala as tpm
from mcmc_jl_tpu_torch.samplers import smmala as tsm
from mcmc_jl_tpu_torch.samplers.base import RunCtx

sys.path.insert(0, str(pathlib.Path(__file__).parent.parent / "examples"))
import probit_regression as pr  # noqa: E402

torch.set_num_threads(1)
F64 = torch.float64
EXACT = 1e-12
STEP = 1e-9
LOG2PI = math.log(2 * math.pi)
KERNEL_MODS = (glm_kernels, nuts_kernels, glm_bign, target_kernels,
               rwm_kernels)


# -- models -----------------------------------------------------------------


def probit_torch(X, y, init, priorstd=10.0):
    """A torch copy of examples/probit_regression.py's ``make_model`` closed
    forms (probit_regression.jl:36-67), float64 on the CPU."""
    X = torch.tensor(np.asarray(X), dtype=F64)
    y = torch.tensor(np.asarray(y), dtype=F64)
    npars = X.shape[1]
    priorvar = priorstd ** 2
    lcdf = torch.special.log_ndtr

    def logp(p):
        xp = X @ p
        return (lcdf(xp) @ y + lcdf(-xp) @ (1.0 - y) - 0.5 * (p @ p) / priorvar
                - 0.5 * npars * (LOG2PI + 2 * math.log(priorstd)))

    def grad(p):
        xp = X @ p
        t = torch.exp(-(xp ** 2 + LOG2PI) / 2.0)
        v = (y * t * torch.exp(-lcdf(xp))
             - (1.0 - y) * t * torch.exp(-lcdf(-xp)))
        return X.T @ v - p / priorvar

    def tensor(p):
        xp = X @ p
        vec = torch.exp(-xp ** 2 - lcdf(xp) - lcdf(-xp) - LOG2PI)
        return (X.T * vec) @ X + torch.eye(npars, dtype=F64) / priorvar

    def dtensor(p):
        xp = X @ p
        phi = torch.exp(-(xp ** 2 + LOG2PI) / 2.0)
        Phi = torch.exp(lcdf(xp))
        v01 = torch.exp(-xp ** 2 - 2 * lcdf(xp) - lcdf(-xp) - LOG2PI)
        cols = [(X.T * (v01 * (torch.exp(-(xp ** 2 + LOG2PI) / 2.0
                                         - lcdf(-xp))
                               - 2.0 * (phi + xp * Phi)) * X[:, i])) @ X
                for i in range(npars)]
        return torch.stack(cols, dim=-1)

    return mt.model(logp, grad=grad, tensor=tensor, dtensor=dtensor,
                    init=np.asarray(init), dtype=F64, device="cpu")


def probit_pair():
    """(JAX model, port model, X) on the vaso data (39 rows, d 3)."""
    X, y = pr.make_data()
    jm = pr.make_model(X, y)
    return jm, probit_torch(X, y, jm.init), np.asarray(X)


A = np.array([[1.0, 0.3, 0.0], [0.3, 2.0, 0.2], [0.0, 0.2, 0.5]])
AINV = np.linalg.inv(A)
MU = np.array([0.5, -0.3, 0.2])


def gauss_pair():
    """tests/test_samplers_stat.py's correlated 3-D Gaussian: in JAX with
    tensor and dtensor from autodiff, as that file builds it; in the port
    with their closed forms (G = A, dG = 0), which torch.func's vmapped
    hessian and jacfwd give 10-30x slower on the CPU."""
    Aj, muj = jnp.asarray(A), jnp.asarray(MU)
    jm = mc.model(lambda v: -0.5 * (v - muj) @ Aj @ (v - muj),
                  gradient=True, tensor=True, dtensor=True,
                  init=jnp.asarray(MU + 0.5), check_init=False)
    At, mut = torch.tensor(A), torch.tensor(MU)
    zero = torch.zeros(3, 3, 3, dtype=F64)
    tm = mt.model(lambda v: -0.5 * (v - mut) @ At @ (v - mut),
                  grad=lambda v: -At @ (v - mut),
                  tensor=lambda v: At + 0.0 * v.sum(),
                  dtensor=lambda v: zero + 0.0 * v.sum(), init=MU + 0.5,
                  dtype=F64, device="cpu", check_init=False)
    return jm, tm


def fold_pair():
    """A 2-D standard normal whose metric ``(1 - x_0) I`` stops being
    positive definite past x_0 = 1 (dG[:, :, 0] = -I)."""
    def tensor_j(v):
        return (1.0 - v[0]) * jnp.eye(2)

    def dtensor_j(v):
        return jnp.stack([-jnp.eye(2), jnp.zeros((2, 2))], axis=-1)

    def tensor_t(v):
        return (1.0 - v[0]) * torch.eye(2, dtype=F64)

    def dtensor_t(v):
        return torch.stack([-torch.eye(2, dtype=F64),
                            torch.zeros(2, 2, dtype=F64)], dim=-1)

    jm = mc.model(lambda v: -0.5 * v @ v, grad=lambda v: -v, tensor=tensor_j,
                  dtensor=dtensor_j, init=jnp.asarray([0.5, 0.0]))
    tm = mt.model(lambda v: -0.5 * v @ v, grad=lambda v: -v,
                  tensor=tensor_t, dtensor=dtensor_t, init=[0.5, 0.0],
                  dtype=F64, device="cpu")
    return jm, tm


# -- helpers ------------------------------------------------------------------


def spd_batch(C=5, d=4, seed=0):
    """(G, dG, grad): random SPD metrics, a dG not symmetric in its last
    two axes, and gradients."""
    rng = np.random.default_rng(seed)
    B = rng.standard_normal((C, d, d))
    G = B @ B.transpose(0, 2, 1) + d * np.eye(d)
    dG = rng.standard_normal((C, d, d, d))
    assert np.abs(dG - dG.transpose(0, 1, 3, 2)).max() > 0.1
    return G, dG, rng.standard_normal((C, d))


def close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float64),
                               np.asarray(want, dtype=np.float64), rtol=tol,
                               atol=tol)


def as_dict(state):
    return {f.name: (as_dict(getattr(state, f.name))
                     if dataclasses.is_dataclass(getattr(state, f.name))
                     else np.asarray(getattr(state, f.name)))
            for f in dataclasses.fields(state)}


#: JAX's tuner divides two int32 counters into a float32 acceptance rate
#: (mcmc_jl_tpu/samplers/base.py tuner_update), the port's into the state's
#: dtype: an adapted step agrees to float32 precision, as
#: tests/test_torch_core.py holds tuner_update (1e-6)
TUNED = 1e-6


def states_close(got, want, tol):
    """Every leaf of the port's state against the JAX state's (an adapted
    step size at TUNED)."""
    w = as_dict(jax.device_get(want))
    for f in dataclasses.fields(got):
        v = getattr(got, f.name)
        if dataclasses.is_dataclass(v):
            for g in dataclasses.fields(v):
                close(getattr(v, g.name).numpy(), w[f.name][g.name],
                      max(tol, TUNED) if g.name == "step_size" else tol)
        else:
            close(v.numpy(), w[f.name], tol)


def infos_close(got, want, tol):
    assert set(got) == set(want)
    for k, v in want.items():
        if k == "accept":
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(v))
        else:
            close(got[k].numpy(), v, tol)


def chain_z(x, want):
    """max |pooled mean - want| in standard errors from the spread of the
    per-chain means (x: (kept, chains, d))."""
    m = x.mean(0)
    se = m.std(0, ddof=1) / np.sqrt(len(m))
    return np.abs(m.mean(0) - want) / se


def start_points(jm, C, seed, spread=0.3):
    """C starting points near the vaso posterior's bulk (float64)."""
    rng = np.random.default_rng(seed)
    center = np.array([-0.2, 1.5, 1.1])[:jm.size]
    return center + spread * rng.standard_normal((C, jm.size))


PAIRS = {
    "smmala": (lambda: mc.SMMALA(1.0), lambda: mt.SMMALA(1.0), jsm, tsm),
    "pmala": (lambda: mc.PMALA(0.8), lambda: mt.PMALA(0.8), jpm, tpm),
    "smmala_tuner": (lambda: mc.SMMALA(0.7, mc.EmpMCTuner(0.574,
                                                          adapt_step=5)),
                     lambda: mt.SMMALA(0.7, mt.EmpMCTuner(0.574,
                                                          adapt_step=5)),
                     jsm, tsm),
}
CONVERT = {"smmala": mt.smmala_state_from_numpy,
           "pmala": mt.pmala_state_from_numpy}


# -- tests ----------------------------------------------------------------------


def test_helpers_match_jax():
    """_chol_drift, chol_inverse, _logdet_chol and PMALA's _geometry,
    batched over chains, against jax.vmap of JAX's at 1e-12."""
    G, dG, g = spd_batch()
    Gt, dGt, gt = (torch.tensor(a) for a in (G, dG, g))
    L, drift = tsm._chol_drift(Gt, gt)
    jL, jdrift = jax.vmap(jsm._chol_drift)(jnp.asarray(G), jnp.asarray(g))
    close(L.numpy(), jL, EXACT)
    close(drift.numpy(), jdrift, EXACT)
    close(tsm.chol_inverse(L).numpy(), jax.vmap(jsm.chol_inverse)(jL), EXACT)
    close(tsm._logdet_chol(L).numpy(), jax.vmap(jsm._logdet_chol)(jL), EXACT)
    pL, pdrift = tpm._geometry(gt, Gt, dGt)
    jpL, jpdrift = jax.vmap(jpm._geometry)(jnp.asarray(g), jnp.asarray(G),
                                           jnp.asarray(dG))
    close(pL.numpy(), jpL, EXACT)
    close(pdrift.numpy(), jpdrift, EXACT)
    # unbatched: one chain gives the same
    L0, d0 = tsm._chol_drift(Gt[0], gt[0])
    close(L0.numpy(), jL[0], EXACT)
    close(d0.numpy(), jdrift[0], EXACT)


def test_factorizations_give_nan_not_errors():
    """A metric that is not positive definite factorizes to NaN, a singular
    system solves to NaN, and neither raises (chains reject, as
    jnp.linalg's NaN results make JAX's chains reject)."""
    G, _, g = spd_batch(C=3, d=3)
    G[1] = -G[1]
    G[2] = 0.0
    L, drift = tsm._chol_drift(torch.tensor(G), torch.tensor(g))
    assert torch.isfinite(L[0]).all() and torch.isfinite(drift[0]).all()
    assert torch.isnan(drift[1:]).all()
    jL, jdrift = jax.vmap(jsm._chol_drift)(jnp.asarray(G), jnp.asarray(g))
    np.testing.assert_array_equal(np.isnan(L.numpy()), np.isnan(jL))
    np.testing.assert_array_equal(np.isnan(drift.numpy()), np.isnan(jdrift))
    close(L[0].numpy(), jL[0], EXACT)
    x = tsm.solve(torch.tensor(G), torch.tensor(g))
    assert torch.isfinite(x[:2]).all() and torch.isnan(x[2]).all()


def test_probit_model_matches_jax():
    """The torch copy of the probit closed forms: evalalldt at 1e-10."""
    jm, tm, _ = probit_pair()
    th = start_points(jm, 6, 0, spread=1.0)
    got = tm.evalalldt(torch.tensor(th))
    want = jax.vmap(jm.evalalldt)(jnp.asarray(th))
    for a, b in zip(got, want):
        close(a.numpy(), b, 1e-10)
    close(tm.init.numpy(), jm.init, 0.0)


def jax_steps(js, jm, states, keys, burnin):
    return jax.jit(jax.vmap(lambda s, k: js.step(jm, JRunCtx(burnin=burnin),
                                                 s, k)))(states, keys)


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_step_on_replayed_draws_matches_jax(name):
    """Eight chains: JAX's init matches the port's; one JAX step per chain,
    its draws replayed from its key (split into the proposal's and the
    accept test's), gives the port's new state and info at 1e-9.  With
    the tuner every chain is at an adaptation step."""
    mkj, mkt, _, _ = PAIRS[name]
    js, ts = mkj(), mkt()
    jm, tm, _ = probit_pair()
    C = 8
    th = start_points(jm, C, 1)
    jst = jax.vmap(lambda t: js.init(jm, t, None))(jnp.asarray(th))
    st = ts.init(tm, torch.tensor(th))
    states_close(st, jst, 1e-10)
    burnin = 0
    if js.tuner is not None:  # i = 5 = adapt_step <= burnin: adapts
        jst = jst.replace(i=jnp.full(C, 5, jnp.int32),
                          tune=jst.tune.replace(
                              accepted=jnp.arange(C, dtype=jnp.int32) % 5,
                              proposed=jnp.full(C, 4, jnp.int32)))
        burnin = 10
    keys = jax.random.split(jax.random.PRNGKey(7), C)
    jnew, jinfo = jax_steps(js, jm, jst, keys, burnin)
    split = jax.vmap(jax.random.split)(keys)
    noise = jax.vmap(lambda k: jax.random.normal(k, (3,), jnp.float64))(
        split[:, 0])
    log_u = jnp.log(jax.vmap(lambda k: jax.random.uniform(
        k, (), jnp.float64))(split[:, 1]))
    convert = CONVERT[name.split("_")[0]]
    st = convert(as_dict(jax.device_get(jst)), device="cpu")
    new, info = ts.move(tm, RunCtx(burnin=burnin), st,
                        torch.tensor(np.asarray(noise)),
                        torch.tensor(np.asarray(log_u)))
    states_close(new, jnew, STEP)
    infos_close(info, jinfo, STEP)
    acc = info["accept"].numpy()
    assert 0 < acc.sum() < C or name == "smmala_tuner", acc
    if js.tuner is not None:
        assert not np.allclose(new.tune.step_size.numpy(), 0.7)


@pytest.mark.parametrize("name", ["smmala", "pmala"])
def test_non_pd_proposal_rejects_as_jax(name):
    """On the folding metric, proposals past x_0 = 1 have no Cholesky
    factor: both packages reject them, the same chains, and nothing
    raises."""
    jm, tm = fold_pair()
    e = {"smmala": 4.0, "pmala": 0.3}[name]  # PMALA's drift leans to x_0
    js, ts = {"smmala": (mc.SMMALA(e), mt.SMMALA(e)),
              "pmala": (mc.PMALA(e), mt.PMALA(e))}[name]
    C = 16
    th = np.column_stack([np.full(C, 0.5), np.linspace(-0.3, 0.3, C)])
    jst = jax.vmap(lambda t: js.init(jm, t, None))(jnp.asarray(th))
    keys = jax.random.split(jax.random.PRNGKey(3), C)
    jnew, jinfo = jax_steps(js, jm, jst, keys, 0)
    split = jax.vmap(jax.random.split)(keys)
    noise = jax.vmap(lambda k: jax.random.normal(k, (2,), jnp.float64))(
        split[:, 0])
    log_u = jnp.log(jax.vmap(lambda k: jax.random.uniform(
        k, (), jnp.float64))(split[:, 1]))
    st = ts.init(tm, torch.tensor(th))
    new, info = ts.move(tm, RunCtx(), st, torch.tensor(np.asarray(noise)),
                        torch.tensor(np.asarray(log_u)))
    # the proposals, recomputed: which ones left the positive-definite side
    prop = th + (e / 2.0) * st.drift.numpy() + np.sqrt(e) * np.stack(
        [np.linalg.solve(L.T, z) for L, z in zip(st.chol.numpy(),
                                                  np.asarray(noise))])
    folded = prop[:, 0] > 1.0
    assert folded.any() and not folded.all(), prop
    acc = info["accept"].numpy()
    np.testing.assert_array_equal(acc, np.asarray(jinfo["accept"]))
    assert not acc[folded].any()
    states_close(new, jnew, STEP)


def run_gates(x, acc, tag):
    assert np.all(np.isfinite(x)), tag
    z = chain_z(x, MU)
    assert np.all(z < 5), (tag, z)
    np.testing.assert_allclose(x.reshape(-1, 3).std(0),
                               np.sqrt(np.diag(AINV)), rtol=0.2,
                               err_msg=tag)
    assert acc > 0.05, (tag, acc)


GAUSS = {
    "SMMALA": (lambda: mt.SMMALA(1.2), 64, 500, 100),
    "PMALA": (lambda: mt.PMALA(1.2), 64, 300, 60),
    "SMMALA+tuner": (lambda: mt.SMMALA(0.1, mt.EmpMCTuner(0.574)), 64, 600,
                     200),
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
    if "tuner" in name:  # adapted at 100 and 200, per chain
        assert torch.all(st.tune.step_size != 0.1)
        assert st.tune.step_size.unique().numel() > 1


@pytest.mark.parametrize("name", ["SMMALA", "PMALA"])
def test_vaso_means_match_jax(name):
    """The vaso probit: the port's pooled means against the JAX package's
    run of tests/test_examples.py (SerialMC(range(500, 3501))), within
    that file's tolerance 6 (se + se') + 0.05."""
    jm, tm, _ = probit_pair()
    js, ts = {"SMMALA": (mc.SMMALA(0.5), mt.SMMALA(0.5)),
              "PMALA": (mc.PMALA(0.5), mt.PMALA(0.5))}[name]
    jc = mc.run(jm * js * mc.SerialMC(range(500, 3501)), seed=1)
    jmean = np.asarray(mc.mean(jc))
    jse = np.sqrt(np.asarray(mc.var(jc))
                  / np.maximum(np.asarray(mc.ess(jc)), 4.0))
    C, burn = 16, 300
    infos, _, _ = pchains.run_chains(tm, ts, mt.SerialMC(steps=1000,
                                                         burnin=burn), C,
                                     seed=2)
    x = infos["ppars"][burn:].numpy()
    m = x.mean(0)
    se = m.std(0, ddof=1) / np.sqrt(C)
    diff = np.abs(m.mean(0) - jmean)
    assert np.all(diff < 6 * (se + jse) + 0.05), (diff, se, jse)
    assert infos["accept"][burn:].double().mean() > 0.2


@pytest.mark.parametrize("name", ["SMMALA", "PMALA"])
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
    assert models[0].target_spec is not None
    assert models[1].glm_spec is not None
    s = getattr(mt, name)(0.5)
    for m in models:
        task = m * s * mt.SerialMC(steps=12, burnin=6)
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
            mt.resume(cs, steps=4, fused=True)
        assert "continuing 6" in caplog.text and "generic" in caplog.text
        assert "has no fused continuation" in caplog.text
        for mod in KERNEL_MODS:
            assert not any(mod.LAUNCHES.values()), mod.LAUNCHES
            assert not any(mod.PLAIN_CALLS.values()), mod.PLAIN_CALLS
        assert np.all(np.isfinite(np.stack([c.samples.values for c in cs])))


@pytest.mark.parametrize("name", ["SMMALA", "PMALA"])
def test_run_then_two_resumes_repeat(name):
    """run(chains=4), then resume(list) twice: the same draws, pos
    advanced; a single-chain run resumed twice repeats too."""
    _, tm = gauss_pair()
    task = tm * getattr(mt, name)(1.0, mt.EmpMCTuner(0.574, adapt_step=10)) \
        * mt.SerialMC(steps=40, burnin=20)
    cs = mt.run(task, chains=4, seed=3)
    r1, r2 = mt.resume(cs, steps=12), mt.resume(cs, steps=12)
    for a, b in zip(r1, r2):
        np.testing.assert_array_equal(a.samples.values, b.samples.values)
        assert a.task.pos == b.task.pos == task.runner.len + 12
    assert not np.array_equal(r1[0].samples.values, r1[1].samples.values)
    c = mt.run(task, seed=5)
    assert c.task.state.pars.shape == (3,)
    assert c.task.state.chol.shape == (3, 3)
    s1, s2 = mt.resume(c, steps=10), mt.resume(c, steps=10)
    np.testing.assert_array_equal(s1.samples.values, s2.samples.values)


@pytest.mark.parametrize("name", ["smmala", "pmala"])
def test_jax_state_continues_in_the_port(name):
    """JAX final states carried over by the converters continue in the
    port: the same positions, factors and counters at the start, and the
    continuation meets the Gaussian's gates."""
    jm, tm = gauss_pair()
    js = {"smmala": mc.SMMALA(1.2), "pmala": mc.PMALA(1.2)}[name]
    ts = {"smmala": mt.SMMALA(1.2), "pmala": mt.PMALA(1.2)}[name]
    C, steps = 32, 60
    _, jst, _ = jax_run_chains(jm, js, mc.SerialMC(steps=steps, burnin=20),
                               C, seed=1)
    st = CONVERT[name](as_dict(jax.device_get(jst)), device="cpu")
    assert type(st) is {"smmala": mt.SMMALAState,
                        "pmala": mt.PMALAState}[name]
    np.testing.assert_array_equal(st.pars.numpy(), np.asarray(jst.pars))
    np.testing.assert_array_equal(st.chol.numpy(), np.asarray(jst.chol))
    assert st.i.dtype == torch.int32 and torch.all(st.i == steps + 1)
    cont = 150
    infos, new, _ = pchains.run_chains(tm, ts, mt.SerialMC(steps=cont), C,
                                       seed=2, states=st)
    assert torch.all(new.i == steps + 1 + cont)
    run_gates(infos["ppars"].numpy(),
              infos["accept"].double().mean().item(), name)


def test_linear_zv_on_an_smmala_chain():
    """The chain keeps its gradients (info pgrads), so linear_zv runs; on
    a Gaussian it takes out almost all of the variance."""
    _, tm = gauss_pair()
    c = mt.run(tm * mt.SMMALA(1.2) * mt.SerialMC(steps=600, burnin=100),
               seed=4)
    assert c.gradients is not None
    assert c.gradients.values.shape == c.samples.values.shape == (500, 3)
    zv, _ = mt.linear_zv(c)
    raw = c.samples.values.var(0)
    assert np.all(zv.var(0) < 0.05 * raw), (zv.var(0), raw)
