"""The port's tensor family of models (models/model.py: ``tensor=``,
``dtensor=``, ``alltensor=``, ``alldtensor=``) and ``debug=True`` against
the JAX package's, on two DSL models and a GLM, on the CPU in float64.

Tolerance: 1e-10 (torch.func.hessian and jacfwd against jax.hessian and
jacfwd of the same float64 expressions)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.fx import GraphModule

import mcmc_jl_tpu as mc
import mcmc_jl_tpu_torch as mt

torch.set_num_threads(1)
F64 = torch.float64
TOL = 1e-10
YS = np.array([0.3, -1.2, 2.0, 0.7])


def _hier():
    """Normal likelihood with a Gamma-distributed scale."""
    def tex(mu, s):
        mt.tilde(mu, mt.Normal(0.0, 2.0))
        mt.tilde(s, mt.Gamma(2.0, 1.0))
        mt.tilde(torch.tensor(YS, dtype=F64), mt.Normal(mu, s))

    def jex(mu, s):
        mc.tilde(mu, mc.Normal(0.0, 2.0))
        mc.tilde(s, mc.Gamma(2.0, 1.0))
        mc.tilde(jnp.asarray(YS), mc.Normal(mu, s))

    return tex, jex, dict(mu=0.1, s=1.3), np.array([[0.2, 1.1], [-0.4, 0.7],
                                                   [1.5, 2.2]])


def _regression():
    """A vector and a matrix parameter: logistic regression with a
    per-group offset matrix (column-major in both packages)."""
    rng = np.random.default_rng(3)
    X = rng.standard_normal((12, 2))
    Y = (rng.random(12) < 0.5).astype(np.float64)

    def tex(beta, off):
        mt.tilde(beta, mt.Normal(0.0, 1.0))
        mt.tilde(off, mt.Laplace(0.0, 0.5))
        z = torch.tensor(X) @ beta + off.reshape(-1).sum()
        mt.tilde(torch.tensor(Y), mt.Bernoulli(torch.sigmoid(z)))

    def jex(beta, off):
        mc.tilde(beta, mc.Normal(0.0, 1.0))
        mc.tilde(off, mc.Laplace(0.0, 0.5))
        z = jnp.asarray(X) @ beta + off.reshape(-1).sum()
        mc.tilde(jnp.asarray(Y), mc.Bernoulli(jax.nn.sigmoid(z)))

    init = dict(beta=np.array([0.1, -0.2]), off=np.array([[0.1, 0.3],
                                                          [-0.2, 0.05]]))
    th = rng.standard_normal((3, 6)) * 0.5
    return tex, jex, init, th


MODELS = {"hier": _hier, "regression": _regression}


def _pair(name, **kw):
    tex, jex, init, th = MODELS[name]()
    tm = mt.model(tex, **init, dtype=F64, device="cpu", **kw)
    jm = mc.model(jex, **init, **kw)
    return tm, jm, th


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_tensor_and_dtensor_true_match_jax(name):
    tm, jm, th = _pair(name, gradient=True, tensor=True, dtensor=True)
    assert tm.hastensor and tm.hasdtensor
    d = tm.size
    G = tm.evalt(torch.tensor(th))
    dG = tm.evaldt(torch.tensor(th))
    assert G.shape == (3, d, d) and dG.shape == (3, d, d, d)
    _close(G, jax.vmap(jm.evalt)(jnp.asarray(th)))
    _close(dG, jax.vmap(jm.evaldt)(jnp.asarray(th)))
    # G is symmetric, and dG[i, j, k] = dG_ij/dtheta_k
    _close(G, G.transpose(-1, -2))
    # one chain, no batch dimension
    _close(tm.evalt(torch.tensor(th[1])), jm.evalt(jnp.asarray(th[1])))
    for got, want in zip(tm.evalalldt(torch.tensor(th)),
                         jax.vmap(jm.evalalldt)(jnp.asarray(th))):
        _close(got, want)
    for got, want in zip(tm.evalallt(torch.tensor(th)),
                         jax.vmap(jm.evalallt)(jnp.asarray(th))):
        _close(got, want)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_callable_tensor_forms_match_jax(name):
    """``tensor=`` and ``dtensor=`` given as functions of one vector, and the
    ``alltensor``/``alldtensor`` tuple forms."""
    tref, jref, th = _pair(name, gradient=True, tensor=True, dtensor=True)
    t1 = lambda v: tref.evalt(v)  # noqa: E731
    dt1 = lambda v: tref.evaldt(v)  # noqa: E731
    all_t = lambda v: (*tref.evalallg(v), tref.evalt(v))  # noqa: E731
    all_dt = lambda v: (*tref.evalallt(v), tref.evaldt(v))  # noqa: E731
    jall_t = lambda v: (*jref.evalallg(v), jref.evalt(v))  # noqa: E731
    jall_dt = lambda v: (*jref.evalallt(v), jref.evaldt(v))  # noqa: E731
    for kw, jkw in (
            (dict(tensor=t1, dtensor=dt1),
             dict(tensor=jref.evalt, dtensor=jref.evaldt)),
            (dict(alltensor=all_t, alldtensor=all_dt),
             dict(alltensor=jall_t, alldtensor=jall_dt)),
            (dict(tensor=t1, dtensor=True), dict(tensor=jref.evalt,
                                                 dtensor=True))):
        tm, jm, _ = _pair(name, gradient=True, **kw)
        jm = mc.model(MODELS[name]()[1], **MODELS[name]()[2], gradient=True,
                      **jkw)
        assert tm.hastensor and tm.hasdtensor
        x = torch.tensor(th)
        _close(tm.evalt(x), jax.vmap(jm.evalt)(jnp.asarray(th)))
        _close(tm.evaldt(x), jax.vmap(jm.evaldt)(jnp.asarray(th)))
        for got, want in zip(tm.evalalldt(x),
                             jax.vmap(jm.evalalldt)(jnp.asarray(th))):
            _close(got, want)


def test_glm_tensor_is_the_fisher_information():
    """On a GLM the tensor is -H(logp) = X' W X + lam I, the Hessian of the
    analytic log-target, held against JAX's and against the formula."""
    rng = np.random.default_rng(2)
    X = np.column_stack([np.ones(40), rng.standard_normal((40, 2))])
    Y = (rng.random(40) < 0.5).astype(np.float64)
    tm = mt.model(glm=("logistic", X, Y), tensor=True, dtype=F64,
                  device="cpu")
    jm = mc.model(glm=("logistic", X, Y), tensor=True)
    th = rng.standard_normal((2, 3)) * 0.3
    G = tm.evalt(torch.tensor(th)).numpy()
    _close(G, jax.vmap(jm.evalt)(jnp.asarray(th)))
    p = 1.0 / (1.0 + np.exp(-th @ X.T))
    want = np.einsum("ni,cn,nj->cij", X, p * (1 - p), X) + np.eye(3)
    np.testing.assert_allclose(G, want, rtol=1e-10)


def test_tensor_asserts_match_jax():
    """A tensor needs a gradient and dtensor=True needs a tensor, in both
    packages."""
    tex, jex, init, _ = _hier()
    with pytest.raises(AssertionError, match="tensor requires a gradient"):
        mt.model(tex, **init, tensor=True, dtype=F64, device="cpu")
    with pytest.raises(AssertionError, match="tensor requires a gradient"):
        mc.model(jex, **init, tensor=True)
    with pytest.raises(AssertionError, match="dtensor=True requires a tensor"):
        mt.model(tex, **init, gradient=True, dtensor=True, dtype=F64,
                 device="cpu")
    with pytest.raises(AssertionError, match="dtensor=True requires a tensor"):
        mc.model(jex, **init, gradient=True, dtensor=True)
    m = mt.model(tex, **init, gradient=True, dtype=F64, device="cpu")
    assert not m.hastensor and not m.hasdtensor
    assert m.evalt is None and m.evalallt is None


@pytest.mark.parametrize("name", sorted(MODELS))
def test_debug_graph_matches_jaxpr(name):
    """``debug=True`` returns the traced log-target instead of a model: a
    GraphModule whose value at theta equals eval_jaxpr of JAX's jaxpr."""
    tex, jex, init, th = MODELS[name]()
    gm = mt.model(tex, **init, debug=True, dtype=F64, device="cpu")
    jx = mc.model(jex, **init, debug=True)
    assert isinstance(gm, GraphModule) and "aten" in gm.code
    assert "log" in gm.code
    m = mt.model(tex, **init, dtype=F64, device="cpu")
    for row in th:
        got = gm(torch.tensor(row))
        (want,) = jax.core.eval_jaxpr(jx.jaxpr, jx.consts, jnp.asarray(row))
        _close(got, want)
        _close(got, m.eval(torch.tensor(row)))
