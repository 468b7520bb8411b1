"""The port's regularized incomplete beta function (ops/betainc.py) against
``jax.scipy.special.betainc``, and the Beta, TDist and Binomial cdfs and a
censored model built on it against the JAX package's, on the CPU.

Tolerances: rtol 1e-10 in float64 (the same continued fraction, constants
and stopping rule; lgamma, log and exp round apart in the last bits).  In
float32, 2e-5 relative to the larger of the value and its complement:
where ``x >= (a + 1)/(a + b + 2)`` both compute ``1 - I_{1-x}(b, a)``, so
their float32 rounding of the complement (a few ulps of lgamma(a + b)
near 40 at a + b = 50) is what shows, about 4e-5 of a value near 0.3 in
each package against the float64 value; the float32 logcdf and logccdf
(``log(1 - cdf)`` in both) are compared as probabilities by the same
rule."""
import jax
import jax.numpy as jnp
import jax.scipy.special as jsp
import numpy as np
import pytest
import torch

import mcmc_jl_tpu as mc
from mcmc_jl_tpu.models import distributions as jd
import mcmc_jl_tpu_torch as mt
from mcmc_jl_tpu_torch.models import distributions as td
from mcmc_jl_tpu_torch.ops.betainc import betainc

torch.set_num_threads(1)
F64 = torch.float64
AB = np.array([0.1, 0.3, 0.5, 1.0, 2.5, 7.0, 20.0, 50.0])
XS = np.array([0.0, 1e-12, 1e-6, 0.01, 0.1, 0.3, 0.5, 0.7, 0.9, 0.99,
               1 - 1e-6, 1 - 1e-12, 1.0])


def _grid():
    return np.meshgrid(AB, AB, XS, indexing="ij")


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_betainc_grid_matches_jax(dtype):
    A, B, X = _grid()
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    got = betainc(*(torch.tensor(v, dtype=tdt) for v in (A, B, X)))
    assert got.dtype == tdt and got.shape == A.shape
    want = np.asarray(jsp.betainc(*(jnp.asarray(v, jdt) for v in (A, B, X))),
                      np.float64)
    got = got.double().numpy()
    assert not np.isnan(want).any() and not np.isnan(got).any()
    # both sides of the symmetry switch are on the grid
    fast = X < (A + 1) / (A + B + 2)
    assert fast.sum() > 100 and (~fast).sum() > 100
    if dtype == "float64":
        np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-300)
    else:
        # float32 denormals: XLA flushes them to zero
        tiny = np.finfo(np.float32).tiny
        got = np.where(np.abs(got) < tiny, 0.0, got)
        err = np.abs(got - want) / np.maximum(np.abs(want), np.abs(1 - want))
        assert err.max() < 2e-5, (err.max(), np.unravel_index(err.argmax(),
                                                              err.shape))


def test_betainc_edges_match_jax():
    """a or b zero or infinite, x outside [0, 1], NaN inputs, and Python
    numbers broadcast against a tensor."""
    a = np.array([0.0, 0.0, 2.0, 2.0, np.inf, 2.0, -1.0, 2.0, 2.0, np.nan,
                  0.0])
    b = np.array([2.0, 2.0, 0.0, 0.0, 2.0, np.inf, 2.0, 2.0, 2.0, 2.0, 0.0])
    x = np.array([0.0, 0.5, 0.5, 1.0, 0.5, 0.5, 0.5, -0.1, 1.1, 0.5, 0.5])
    got = betainc(torch.tensor(a), torch.tensor(b), torch.tensor(x)).numpy()
    want = np.asarray(jsp.betainc(a, b, x))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(got[~np.isnan(got)], want[~np.isnan(want)])
    got = betainc(2.0, torch.tensor([1.0, 3.0], dtype=F64), 0.25).numpy()
    np.testing.assert_allclose(got, np.asarray(jsp.betainc(2.0, jnp.array(
        [1.0, 3.0]), 0.25)), rtol=1e-10)


def test_betainc_x_derivatives_match_jax():
    """The gradient and the second derivative in x, under grad, vmap,
    jacfwd and hessian, against jax.grad and jax.hessian."""
    xs = np.array([0.05, 0.2, 0.5, 0.8, 0.97])
    for a, b in ((2.0, 3.0), (0.5, 7.0), (20.0, 2.5)):
        f = lambda x, a=a, b=b: betainc(a, b, x)  # noqa: E731
        jf = lambda x, a=a, b=b: jsp.betainc(a, b, x)  # noqa: E731
        g = torch.func.vmap(torch.func.grad(f))(torch.tensor(xs))
        jg = jax.vmap(jax.grad(jf))(jnp.asarray(xs))
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-10)
        h = torch.func.vmap(torch.func.hessian(f))(torch.tensor(xs))
        jh = jax.vmap(jax.hessian(jf))(jnp.asarray(xs))
        np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=1e-10)
        # plain autograd too
        xt = torch.tensor(xs, requires_grad=True)
        f(xt).sum().backward()
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jg),
                                   rtol=1e-10)


@pytest.mark.parametrize("arg", [0, 1], ids=["a", "b"])
def test_betainc_ab_gradient_raises_as_jax(arg):
    """JAX differentiates betainc in x only: a gradient in a or b raises
    the same ValueError, in reverse and in forward mode."""
    msg = "Betainc gradient with respect to a and b not supported."

    def tf(v):
        args = [torch.tensor(2.0, dtype=F64), torch.tensor(3.0, dtype=F64),
                torch.tensor(0.3, dtype=F64)]
        args[arg] = v
        return betainc(*args)

    def jf(v):
        args = [2.0, 3.0, 0.3]
        args[arg] = v
        return jsp.betainc(*args)

    with pytest.raises(ValueError) as jerr:
        jax.grad(jf)(2.5)
    assert str(jerr.value) == msg
    v = torch.tensor(2.5, dtype=F64)
    for transform in (torch.func.grad, torch.func.jacfwd):
        with pytest.raises(ValueError, match=msg):
            transform(tf)(v)
    vr = v.clone().requires_grad_(True)
    with pytest.raises(ValueError, match=msg):
        tf(vr).backward()


CDFS = [("Beta", (2.0, 3.0), np.array([-0.5, 0.0, 1e-3, 0.3, 0.5, 0.999,
                                       1.0, 2.0])),
        ("Beta", (0.5, 0.5), np.array([0.0, 0.01, 0.5, 0.99, 1.0])),
        ("TDist", (3.0,), np.array([-30.0, -2.0, -0.5, 0.0, 0.5, 2.0,
                                    30.0])),
        ("TDist", (0.7,), np.array([-5.0, -0.1, 0.0, 0.1, 5.0])),
        ("Binomial", (10, 0.3), np.array([-1.0, 0.0, 1.0, 2.5, 3.0, 9.0,
                                          10.0, 11.0])),
        ("Binomial", (25, 0.8), np.array([0.0, 12.0, 20.0, 24.0, 25.0]))]


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("name,params,xs", CDFS,
                         ids=[f"{n}{p}" for n, p, _ in CDFS])
def test_cdfs_match_jax(name, params, xs, dtype):
    tdist, jdist = getattr(td, name)(*params), getattr(jd, name)(*params)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    rtol = 1e-10 if dtype == "float64" else 2e-5
    for meth in ("cdf", "logcdf", "logccdf"):
        got = getattr(tdist, meth)(torch.tensor(xs, dtype=tdt))
        want = np.asarray(getattr(jdist, meth)(jnp.asarray(xs, jdt)),
                          np.float64)
        assert got.dtype == tdt, meth
        got = got.double().numpy()
        np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
        if dtype == "float64":
            fin = np.isfinite(want)
            np.testing.assert_allclose(got[fin], want[fin], rtol=rtol,
                                       atol=1e-300, err_msg=meth)
            continue
        # float32: both packages take logccdf = log(1 - cdf), so compare
        # the probabilities, each to the larger of it and its complement
        if meth != "cdf":
            got, want = np.exp(got), np.exp(want)
        scale = np.maximum(np.abs(want), np.abs(1 - want))
        np.testing.assert_allclose(got / scale, want / scale, rtol=0,
                                   atol=rtol, err_msg=meth)


@pytest.mark.parametrize("name,params", [("Beta", (2.0, 3.0)),
                                         ("TDist", (3.0,)),
                                         ("Binomial", (10, 0.3))])
def test_cdf_gradients_match_jax(name, params):
    """d/dx of logcdf and logccdf against jax.grad (zero for the Binomial,
    whose cdf is a step function of x)."""
    xs = {"Beta": [0.2, 0.5, 0.9], "TDist": [-1.5, 0.3, 2.0],
          "Binomial": [2.0, 3.5, 7.0]}[name]
    tdist, jdist = getattr(td, name)(*params), getattr(jd, name)(*params)
    for meth in ("logcdf", "logccdf", "cdf"):
        g = torch.func.vmap(torch.func.grad(getattr(tdist, meth)))(
            torch.tensor(xs, dtype=F64))
        jg = jax.vmap(jax.grad(getattr(jdist, meth)))(jnp.asarray(xs))
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-10,
                                   atol=1e-14, err_msg=meth)


def test_censored_tdist_model_matches_jax():
    """``y ~ +TDist(v)`` (right-censored at y) with the shift a parameter:
    the log-target and its gradient through the cdf, batched over chains,
    against the JAX model (out of support, both give -inf or a zero
    gradient alike)."""
    ys = np.array([0.5, 1.5, -0.3])

    def tex(mu, v):
        mt.tilde(mu, mt.Normal(0.0, 3.0))
        mt.tilde(v, mt.Gamma(2.0, 2.0))
        mt.tilde(torch.tensor(ys, dtype=F64) - mu, +mt.TDist(4.0))
        mt.tilde(torch.tensor([2.0], dtype=F64) - mu, -mt.TDist(4.0))

    def jex(mu, v):
        mc.tilde(mu, mc.Normal(0.0, 3.0))
        mc.tilde(v, mc.Gamma(2.0, 2.0))
        mc.tilde(jnp.asarray(ys) - mu, +mc.TDist(4.0))
        mc.tilde(jnp.asarray([2.0]) - mu, -mc.TDist(4.0))

    tm = mt.model(tex, mu=0.1, v=1.0, gradient=True, dtype=F64, device="cpu")
    jm = mc.model(jex, mu=0.1, v=1.0, gradient=True)
    th = np.array([[0.1, 1.0], [-1.2, 0.4], [2.5, 3.0], [0.5, -1.0]])
    lp, g = tm.evalallg(torch.tensor(th))
    jlp, jg = jax.vmap(jm.evalallg)(jnp.asarray(th))
    np.testing.assert_array_equal(np.isneginf(lp.numpy()),
                                  np.isneginf(np.asarray(jlp)))
    fin = np.isfinite(np.asarray(jlp))
    assert fin.sum() == 3
    np.testing.assert_allclose(lp.numpy()[fin], np.asarray(jlp)[fin],
                               rtol=1e-10)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-10,
                               atol=1e-14)
    # and it samples on the generic engine
    c = mt.run(tm * mt.NUTS(maxdoublings=4) * mt.SerialMC(steps=40,
                                                          burnin=20), seed=1)
    assert np.all(np.isfinite(c.samples.values))
