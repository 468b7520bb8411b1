"""The port's generic exact NUTS (samplers/nuts.py, the diagonal kinds of
samplers/massadapt.py, find_reasonable_step of samplers/hmcda.py) against
the JAX package's, on the CPU in float64."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mcmc_jl_tpu as mc
from mcmc_jl_tpu.parallel import run_chains as jax_run_chains
from mcmc_jl_tpu.samplers import massadapt as jma
from mcmc_jl_tpu.samplers import nuts as jnuts
from mcmc_jl_tpu.samplers.hmcda import find_reasonable_step as jax_frs
import mcmc_jl_tpu_torch as mt
from mcmc_jl_tpu_torch.parallel import pchains
from mcmc_jl_tpu_torch.samplers import massadapt as tma
from mcmc_jl_tpu_torch.samplers import nuts as tnuts
from mcmc_jl_tpu_torch.samplers.hmcda import find_reasonable_step

torch.set_num_threads(1)


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
            mt.model(glm=("logistic", X, Y), dtype=torch.float64,
                     device="cpu"))


def test_popcount_and_trailing_ones():
    ks = np.arange(256, dtype=np.int32)
    jp = np.asarray(jnuts._popcount(jnp.asarray(ks)))
    jt = np.asarray(jnuts._trailing_ones(jnp.asarray(ks)))
    assert [tnuts._popcount(int(k)) for k in ks] == jp.tolist()
    assert [tnuts._trailing_ones(int(k)) for k in ks] == jt.tolist()


def test_find_reasonable_step_matches_jax():
    """The heuristic draws nothing: from the same state and momentum both
    packages give the same power of two, chain by chain."""
    jm, tm = _models()
    rng = np.random.default_rng(2)
    pars = rng.standard_normal((6, 3)) * np.array([[0.1], [1.0], [3.0], [0.5],
                                                   [2.0], [6.0]])
    m = rng.standard_normal((6, 3))
    lp, g = tm.evalallg(torch.as_tensor(pars))
    eps = find_reasonable_step(tm, torch.as_tensor(pars), lp, g,
                               torch.as_tensor(m))
    jeps = jax.vmap(lambda p, l, gg, mm: jax_frs(jm, p, l, gg, mm, None))(
        jnp.asarray(pars), jnp.asarray(lp.numpy()), jnp.asarray(g.numpy()),
        jnp.asarray(m))
    np.testing.assert_array_equal(eps.numpy(), np.asarray(jeps))
    assert np.all(np.log2(eps.numpy()) == np.round(np.log2(eps.numpy())))
    assert len(set(eps.tolist())) > 1
    # one chain, no batch dimension
    e0 = find_reasonable_step(tm, torch.as_tensor(pars[2]), lp[2], g[2],
                              torch.as_tensor(m[2]))
    assert e0.shape == () and float(e0) == float(jeps[2])


def test_dual_average_matches_jax_formula():
    """One dual-averaging update (samplers/nuts.py step, NUTS.jl:162-169),
    inside and past the adaptation window, on the same (state, alpha)."""
    rng = np.random.default_rng(3)
    n = 7
    i = np.array([1, 2, 10, 500, 999, 1000, 1001], np.int32)
    hbar, mu, lebar = (rng.standard_normal(n) for _ in range(3))
    hbar = 0.01 * hbar  # keeps exp(log eps) finite at i = 1000
    alpha = rng.random(n)
    st = tnuts.NUTSState(
        pars=None, logtarget=None, grad=None, epsilon=None,
        mu=torch.as_tensor(mu), hbar=torch.as_tensor(hbar),
        lebar=torch.as_tensor(lebar), tlen=None, i=torch.as_tensor(i),
        mass=None)
    eps, h, lb = tnuts.dual_average(st, torch.as_tensor(alpha))

    fi = jnp.asarray(i, jnp.float64)
    jh = hbar * (1.0 - 1.0 / (fi + jnuts.T0)) + (jnuts.DELTA - alpha) / (fi + jnuts.T0)
    le = mu - jnp.sqrt(fi) / jnuts.GAM * jh
    jlb = fi ** (-jnuts.KAPPA) * le + (1.0 - fi ** (-jnuts.KAPPA)) * lebar
    inad = i <= jnuts.NADAPT
    np.testing.assert_allclose(eps.numpy(), np.where(inad, np.exp(le), np.exp(lebar)),
                               rtol=1e-14)
    np.testing.assert_allclose(h.numpy(), np.where(inad, jh, hbar), rtol=1e-14)
    np.testing.assert_allclose(lb.numpy(), np.where(inad, jlb, lebar), rtol=1e-14)
    assert (tnuts.DELTA, tnuts.NADAPT, tnuts.GAM, tnuts.KAPPA, tnuts.T0,
            tnuts.DELTAMAX) == (jnuts.DELTA, jnuts.NADAPT, jnuts.GAM,
                                jnuts.KAPPA, jnuts.T0, jnuts.DELTAMAX)


@pytest.mark.parametrize("kind,burnin", [("diag", 120), ("diag-win", 200),
                                         ("diag-win", 60)])
def test_mass_adaptation_matches_jax(kind, burnin):
    """The diagonal accumulators and their scale, step by step on the same
    sample stream (full and shrunk Stan windows)."""
    rng = np.random.default_rng(4)
    C, d = 3, 4
    xs = rng.standard_normal((burnin + 10, C, d)) * np.array([0.5, 1.0, 2.0, 4.0])
    acc = tma.mass_init(tma.mass_kind(kind), d, torch.float64, shape=(C,))
    jacc = jax.vmap(lambda _: jma.mass_init(jma.mass_kind(kind), d,
                                            jnp.float64))(jnp.arange(C))
    jup = jax.jit(jax.vmap(
        lambda a, x, i: jma.mass_update(kind, a, x, i, burnin),
        in_axes=(0, 0, None)))
    for t, x in enumerate(xs, start=1):
        acc = tma.mass_update(kind, acc, torch.as_tensor(x),
                              torch.full((C,), t, dtype=torch.int32), burnin)
        jacc = jup(jacc, jnp.asarray(x), jnp.int32(t))
        for f in ("count", "mean", "m2", "scale", "next_end", "window"):
            np.testing.assert_allclose(getattr(acc, f).numpy(),
                                       np.asarray(getattr(jacc, f)),
                                       rtol=1e-12, err_msg=f"{f} at step {t}")
        s = tma.mass_vector_scale(kind, acc, torch.float64)
        js = jax.vmap(lambda a: jma.mass_vector_scale(kind, a, jnp.float64))(jacc)
        np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-12)
    assert not np.allclose(s.numpy(), 1.0)


def test_dense_metric_raises():
    """The dense metric constructs (it is ported); an unknown metric and a
    depth outside 1..19 raise."""
    assert mt.NUTS(mass_adapt="dense")._kind == "dense"
    with pytest.raises(ValueError, match="mass_adapt"):
        mt.NUTS(mass_adapt="full")
    with pytest.raises(ValueError, match="maxdoublings"):
        mt.NUTS(maxdoublings=0)


@pytest.mark.parametrize("mass_adapt", [False, "diag"])
@pytest.mark.parametrize("multinomial", [False, True],
                         ids=["slice", "multinomial"])
def test_generic_nuts_matches_jax(multinomial, mass_adapt):
    """Pooled means within 5 standard errors (the pooled-ESS floor of
    tests/test_pallas_nuts.py), sd within 30%, and the frozen step
    median exp(lebar) within 25% of the JAX package's generic engine."""
    jm, tm = _models()
    C, steps, burn = 8, 300, 80
    kw = dict(maxdoublings=5, multinomial=multinomial, mass_adapt=mass_adapt)
    infos, st, _ = pchains.run_chains(tm, mt.NUTS(**kw),
                                      mt.SerialMC(steps=steps, burnin=burn),
                                      C, seed=0)
    jinfos, jst, _ = jax_run_chains(jm, mc.NUTS(**kw),
                                    mc.SerialMC(steps=steps, burnin=burn), C,
                                    seed=0)
    assert set(infos) == set(jinfos)
    x = infos["ppars"][burn:].numpy().reshape(-1, 3)
    xj = np.asarray(jinfos["ppars"])[burn:].reshape(-1, 3)
    sd = xj.std(0)
    z = np.abs(x.mean(0) - xj.mean(0)) / (sd * np.sqrt(2.0 / 200.0))
    assert np.all(z < 5), z
    np.testing.assert_allclose(x.std(0), sd, rtol=0.3)
    eps = np.median(np.exp(st.lebar.numpy()))
    jeps = np.median(np.exp(np.asarray(jst.lebar)))
    assert abs(eps / jeps - 1) < 0.25, (eps, jeps)
    nd = infos["ndoublings"].numpy()
    assert nd.min() >= 1 and nd.max() <= 5 and nd.dtype == np.int32
    assert infos["diverging"].dtype == torch.bool
    assert torch.all(st.i == steps + 1)
    if mass_adapt:
        assert torch.all(st.mass.count == burn)


def test_single_chain_run_and_exact_resume():
    """run(task) without chains= steps a one-chain NUTS state; resume from
    the same chain twice repeats its draws."""
    _, tm = _models()
    task = tm * mt.NUTS(maxdoublings=4) * mt.SerialMC(steps=60, burnin=20)
    c = mt.run(task, seed=3)
    assert c.samples.shape == (40, 3)
    assert set(c.diagnostics) >= {"epsilon", "ndoublings", "diverging",
                                  "accept", "logtarget"}
    assert c.task.state.pars.shape == (3,)
    r1, r2 = mt.resume(c, steps=15), mt.resume(c, steps=15)
    np.testing.assert_array_equal(r1.samples.values, r2.samples.values)
    assert r1.task.state.i.item() == 76
