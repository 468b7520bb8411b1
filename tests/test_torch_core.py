"""The port's models, samplers and task layer (mcmc_jl_tpu_torch) against the
JAX package, in float64 on the CPU, on the same numpy inputs."""
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mcmc_jl_tpu as mc
import mcmc_jl_tpu_torch as mt
from mcmc_jl_tpu.samplers import base as jbase
from mcmc_jl_tpu.samplers.integrators import get_integrator as jax_integrator
from mcmc_jl_tpu_torch.samplers import base as tbase
from mcmc_jl_tpu_torch.samplers.integrators import get_integrator

torch.set_num_threads(1)
F64 = torch.float64


def _data(kind, n=50, d=4, seed=0):
    rng = np.random.default_rng(seed)
    X = np.column_stack([np.ones(n), rng.standard_normal((n, d - 1))])
    z = X @ (0.5 * rng.standard_normal(d))
    if kind == "linear":
        Y = z + rng.standard_normal(n)
    elif kind == "poisson":
        Y = rng.poisson(np.exp(0.3 * z)).astype(np.float64)
    else:
        Y = (rng.random(n) < 1.0 / (1.0 + np.exp(-z))).astype(np.float64)
    return X, Y


@pytest.mark.parametrize("kind", ["logistic", "linear", "poisson", "probit"])
def test_glm_model_matches_jax(kind):
    """(d) model(glm=...) eval/evalallg, with weights, offsets and a
    non-unit prior, equal the JAX model's in float64; also batched."""
    X, Y = _data(kind, seed=1)
    rng = np.random.default_rng(2)
    w = rng.uniform(0.5, 2.0, X.shape[0])
    o = 0.1 * rng.standard_normal(X.shape[0])
    jm = mc.model(glm=(kind, X, Y), weights=w, offsets=o, prior_prec=1.7)
    tm = mt.model(glm=(kind, X, Y), weights=w, offsets=o, prior_prec=1.7,
                  dtype=F64, device="cpu")
    th = 0.3 * rng.standard_normal((3, X.shape[1]))
    lp_t, g_t = tm.evalallg(torch.as_tensor(th))
    for c in range(3):
        lp_j, g_j = jm.evalallg(jnp.asarray(th[c]))
        np.testing.assert_allclose(lp_t[c].item(), float(lp_j), rtol=1e-10)
        np.testing.assert_allclose(g_t[c].numpy(), np.asarray(g_j),
                                   rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(tm.eval(torch.as_tensor(th[c])).item(),
                                   float(jm.eval(jnp.asarray(th[c]))),
                                   rtol=1e-10)


def test_callable_model_gradient_matches_jax():
    """(d) callable mode with gradient=True (torch.func vs jax.grad)."""
    A = np.array([[2.0, 0.3, 0.0], [0.3, 1.0, 0.2], [0.0, 0.2, 0.5]])
    jm = mc.model(lambda v: -0.5 * v @ jnp.asarray(A) @ v + jnp.sum(jnp.sin(v)),
                  gradient=True, init=jnp.zeros(3))
    At = torch.as_tensor(A)
    tm = mt.model(lambda v: -0.5 * v @ At @ v + torch.sin(v).sum(),
                  gradient=True, init=np.zeros(3), dtype=F64,
                  device="cpu")
    th = np.random.default_rng(3).standard_normal((4, 3))
    lp_t, g_t = tm.evalallg(torch.as_tensor(th))
    for c in range(4):
        lp_j, g_j = jm.evalallg(jnp.asarray(th[c]))
        np.testing.assert_allclose(lp_t[c].item(), float(lp_j), rtol=1e-10)
        np.testing.assert_allclose(g_t[c].numpy(), np.asarray(g_j),
                                   rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("name", ["leapfrog", "2stage", "3stage"])
def test_integrator_step_matches_jax(name):
    """(d) one step of each integrator on the same GLM model, float64."""
    X, Y = _data("logistic", seed=4)
    jm = mc.model(glm=("logistic", X, Y))
    tm = mt.model(glm=("logistic", X, Y), dtype=F64, device="cpu")
    rng = np.random.default_rng(5)
    th, m = 0.2 * rng.standard_normal(4), rng.standard_normal(4)
    _, g = jm.evalallg(jnp.asarray(th))
    out_j = jax_integrator(name)[0](jm, jnp.asarray(th), jnp.asarray(m), g, 0.1)
    out_t = get_integrator(name)[0](tm, torch.as_tensor(th),
                                    torch.as_tensor(m),
                                    torch.as_tensor(np.array(g)), 0.1)
    for a, b in zip(out_t, out_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-10,
                                   atol=1e-12)


def test_import_leaves_jax_out():
    """(h) no module of the port imports jax or the JAX package: every
    module of the package is imported, then sys.modules is searched."""
    code = ("import importlib, pkgutil, sys, mcmc_jl_tpu_torch as p;"
            "[importlib.import_module(m.name) for m in pkgutil.walk_packages("
            "p.__path__, 'mcmc_jl_tpu_torch.')];"
            "assert 'mcmc_jl_tpu_torch.ops.target_kernels' in sys.modules;"
            "sys.exit(1 if any(m == 'jax' or m.startswith('jax.') "
            "or m == 'mcmc_jl_tpu' or m.startswith('mcmc_jl_tpu.') "
            "for m in sys.modules) else 0)")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_cuda_device_without_card_raises():
    """(i) asking for a CUDA device with no card raises, never falls back."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    X, Y = _data("logistic", seed=6)
    with pytest.raises(RuntimeError, match="cuda"):
        mt.model(glm=("logistic", X, Y), device="cuda")


def test_default_device_is_the_card():
    """(i) with no device given, models, drivers and state conversion go to
    the CUDA card; with no card they raise and name device="cpu", which
    works.  Nothing runs on the CPU unasked."""
    X, Y = _data("logistic", seed=10)
    if torch.cuda.is_available():
        assert mt.model(glm=("logistic", X, Y)).device.type == "cuda"
        return
    from mcmc_jl_tpu_torch.ops.glm_bign import run_glm_hmc_bign
    from mcmc_jl_tpu_torch.ops.glm_hmc import run_glm_hmc

    for call in (lambda: mt.model(glm=("logistic", X, Y)),
                 lambda: mt.glm_model_from_spec("logistic", X, Y),
                 lambda: run_glm_hmc(X, Y, 4, 5),
                 lambda: run_glm_hmc_bign(X, Y, 4, 5),
                 lambda: mt.mala_state_from_numpy({})):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()
    m = mt.model(glm=("logistic", X, Y), device="cpu")
    assert m.device.type == "cpu" and m.glm_spec.X.device.type == "cpu"
    th, _ = run_glm_hmc(X, Y, 4, 5, device="cpu")
    assert th.device.type == "cpu"


@pytest.mark.parametrize("kw", [dict(steps=100, burnin=10),
                                dict(steps=100, burnin=0, thinning=3),
                                dict(steps=range(11, 60, 4))])
def test_serialmc_kept_range_matches_jax(kw):
    a, b = mc.SerialMC(**kw), mt.SerialMC(**kw)
    assert (a.burnin, a.thinning, a.len, a.r) == (b.burnin, b.thinning, b.len,
                                                  b.r)


def test_task_composition():
    X, Y = _data("logistic", seed=7)
    m = mt.model(glm=("logistic", X, Y), device="cpu")
    t = m * mt.HMC(3, 0.1) * mt.SerialMC(steps=20)
    assert isinstance(t, mt.MCMCTask)
    ts = m * [mt.HMC(3, 0.1), mt.HMC(4, 0.1)] * mt.SerialMC(steps=20)
    assert len(ts) == 2 and ts[1].sampler.n_leaps == 4
    with pytest.raises(TypeError, match="missing runner"):
        mt.run(m * mt.HMC(3, 0.1))


def test_metropolis_accept_rejects_nan():
    g = torch.Generator().manual_seed(0)
    ratio = torch.tensor([float("nan"), 1.0, -float("inf"), 0.0])
    acc = tbase.metropolis_accept(g, ratio)
    assert acc.tolist()[:3] == [False, True, False]


def test_tuner_update_matches_jax():
    """EmpMCTuner step/leap update at an adaptation step, per chain."""
    tuner = mc.EmpMCTuner(0.7, adapt_step=5, max_step=50)
    acc = np.array([True, False, True])
    jt = jbase.tuner_init(0.2, 7)
    jt = jt.replace(accepted=jnp.asarray(3, jnp.int32),
                    proposed=jnp.asarray(4, jnp.int32))
    tt = tbase.tuner_init(0.2, 7, shape=(3,), dtype=F64)
    tt = tt.replace(accepted=torch.full((3,), 3, dtype=torch.int32),
                    proposed=torch.full((3,), 4, dtype=torch.int32))
    ttuner = mt.EmpMCTuner(0.7, adapt_step=5, max_step=50)
    out_t = tbase.tuner_update(ttuner, tt, torch.tensor(5), torch.as_tensor(acc),
                               burnin=10, with_leaps=True)
    for c in range(3):
        out_j = jbase.tuner_update(tuner, jt, jnp.asarray(5), jnp.asarray(acc[c]),
                                   10, with_leaps=True)
        # the JAX package divides its int32 counters in float32 (JAX's
        # int32 -> float32 promotion), the port in the step's float64
        np.testing.assert_allclose(out_t.step_size[c].item(),
                                   float(out_j.step_size), rtol=1e-6)
        assert out_t.n_leaps[c].item() == int(out_j.n_leaps)
        assert out_t.accepted[c].item() == int(out_j.accepted)


def test_hmc_tuner_and_store_leaps_run():
    """Adaptive-step HMC on a batch and store_leaps on one chain run through
    the generic engine; mean_rb is close to the plain mean."""
    X, Y = _data("logistic", seed=8)
    m = mt.model(glm=("logistic", X, Y), dtype=F64, device="cpu")
    s = mt.HMC(5, 0.3, mt.EmpMCTuner(0.7, adapt_step=20))
    cs = mt.run(m * s * mt.SerialMC(steps=200, burnin=100), chains=4)
    steps = np.array([c.task.state.tune.step_size.item() for c in cs])
    assert np.all(steps != 0.3) and np.all(np.isfinite(steps))
    c = mt.run(m * mt.HMC(4, 0.15, store_leaps=True)
               * mt.SerialMC(steps=400, burnin=100))
    assert c.diagnostics["leaps_pars"].shape == (300, 5, 4)
    from mcmc_jl_tpu_torch.stats import mean_rb

    np.testing.assert_allclose(mean_rb(c), mt.mean(c), atol=0.1)


def test_unported_options_raise():
    X, Y = _data("logistic", seed=9)
    # the dense metric is ported: it constructs, and runs on a GLM
    s = mt.HMC(5, 0.1, mass_adapt="dense")
    assert s._kind == "dense"
    m = mt.model(glm=("logistic", X, Y), dtype=torch.float64, device="cpu")
    c = mt.run(m * s * mt.SerialMC(steps=60, burnin=30), seed=0)
    assert c.task.state.mass.scale.shape == (m.size, m.size)
    assert np.all(np.isfinite(c.samples.values))
    # tensor= models are ported: the model builds and has its tensor
    m = mt.model(lambda x: mt.tilde(x, mt.Normal(0.0, 1.0)), x=1.0,
                 gradient=True, tensor=True, device="cpu")
    assert m.hastensor and not m.hasdtensor
    np.testing.assert_allclose(m.evalt(m.init).numpy(), [[1.0]])
    # the ~ DSL itself is ported now
    m = mt.model(lambda x: mt.tilde(x, mt.Normal(0.0, 1.0)), x=1.0,
                 device="cpu")
    assert m.size == 1 and m.pmap == {"x": (1, ())}
