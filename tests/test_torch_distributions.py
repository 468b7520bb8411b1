"""The port's distribution catalog (mcmc_jl_tpu_torch/models/distributions.py)
against the JAX package's (mcmc_jl_tpu/models/distributions.py) on the same
numpy grids: log-densities (with -inf out of support and for invalid
parameters), gradients by torch.func against jax.grad (0 out of support,
Laplace at its loc), the ported logcdf/logccdf, censoring, Truncated,
MvNormal, moments and sampling, and the kernel rows the custom-target CUDA
kernels read (csrc/target_common.cuh), through a numpy copy of the
kernels' formulas.

Tolerances: rtol 1e-6 in float64 (the two packages do the same operations;
lgamma and log_ndtr implementations differ in the last bits), 1e-5 in
float32, and 1e-5 where a cdf goes through the regularized incomplete gamma
function (torch's and JAX's gammainc differ by about 2e-6 relative)."""
CDF_RTOL = 1e-5
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcmc_jl_tpu.models import distributions as jd
from mcmc_jl_tpu_torch.models import distributions as td

torch.set_num_threads(1)

XS = np.array([-2.0, -0.5, 0.0, 1e-3, 0.3, 0.5, 0.999, 1.0, 2.0, 3.5])
XS_DISCRETE = np.array([-1.0, 0.0, 1.0, 2.0, 2.5, 3.0, 10.0, 11.0])

CASES = [
    ("Normal", (0.5, 2.0)), ("Normal", (0.0, -1.0)),
    ("Uniform", (-1.0, 2.0)), ("Uniform", (1.0, 0.0)),
    ("Exponential", (1.5,)), ("Exponential", (-1.0,)),
    ("Gamma", (3.0, 0.2)), ("Gamma", (0.5, 2.0)), ("Gamma", (-1.0, 1.0)),
    ("Weibull", (1.5, 2.0)), ("Weibull", (0.0, 1.0)),
    ("Cauchy", (-1.0, 0.2)), ("LogNormal", (-1.0, 1.0)),
    ("Beta", (2.0, 3.0)), ("Beta", (0.5, 0.5)), ("Beta", (-1.0, 1.0)),
    ("Laplace", (0.0, 1.0)), ("TDist", (2.2,)), ("TDist", (-1.0,)),
    ("Bernoulli", (0.3,)), ("Binomial", (10, 0.3)), ("Poisson", (2.5,)),
]
DISCRETE = {"Bernoulli", "Binomial", "Poisson"}
CONTINUOUS = ["Normal", "Uniform", "Exponential", "Gamma", "Weibull", "Cauchy",
              "LogNormal", "Beta", "Laplace", "TDist"]


def _grid(name):
    return XS_DISCRETE if name in DISCRETE else XS


def _pair(name, params):
    return getattr(jd, name)(*params), getattr(td, name)(*params)


def _same(a, b, rtol, atol=0.0):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    np.testing.assert_array_equal(np.isneginf(a), np.isneginf(b))
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    fin = np.isfinite(b)
    np.testing.assert_allclose(a[fin], b[fin], rtol=rtol, atol=atol)


@pytest.mark.parametrize("name,params", CASES,
                         ids=[f"{n}{p}" for n, p in CASES])
def test_logpdf_matches_jax(name, params):
    """float64 and float32, -inf where JAX has -inf."""
    jdist, tdist = _pair(name, params)
    xs = _grid(name)
    for np_dt, t_dt, rtol in ((np.float64, torch.float64, 1e-6),
                              (np.float32, torch.float32, 1e-5)):
        want = jdist.logpdf(jnp.asarray(xs, np_dt))
        got = tdist.logpdf(torch.as_tensor(xs, dtype=t_dt))
        assert got.dtype == t_dt
        _same(got.numpy(), want, rtol, atol=1e-6 if np_dt == np.float32
              else 0.0)


@pytest.mark.parametrize("name,params",
                         [c for c in CASES if c[0] not in DISCRETE],
                         ids=[f"{n}{p}" for n, p in CASES if n not in DISCRETE])
def test_grad_matches_jax(name, params):
    """d logpdf / dx by torch.func against jax.grad, elementwise: finite
    everywhere, 0 out of support, -1/scale for Laplace at its loc."""
    jdist, tdist = _pair(name, params)
    want = jax.vmap(jax.grad(lambda x: jdist.logpdf(x)))(
        jnp.asarray(XS, jnp.float64))
    got = torch.func.vmap(torch.func.grad(lambda x: tdist.logpdf(x)))(
        torch.as_tensor(XS, dtype=torch.float64))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-12)
    out = ~torch.isfinite(tdist.logpdf(torch.as_tensor(XS)))
    assert (got[out] == 0).all()


def test_laplace_derivative_at_loc():
    """jax.grad(jnp.abs)(0.0) is 1, so Laplace's derivative at x = loc is
    -1/scale in both packages (torch.abs would give 0)."""
    assert float(jax.grad(jnp.abs)(0.0)) == 1.0
    for loc, scale in ((0.0, 1.0), (1.5, 0.25)):
        want = jax.grad(lambda x: jd.Laplace(loc, scale).logpdf(x))(loc)
        got = torch.func.grad(lambda x: td.Laplace(loc, scale).logpdf(x))(
            torch.tensor(loc, dtype=torch.float64))
        assert float(got) == float(want) == -1.0 / scale


def test_tensor_parameters_match_jax():
    """Batched tensor parameters (the traced path: lgamma in torch), values
    and gradients in x and in the parameters."""
    rng = np.random.default_rng(0)
    x = np.abs(rng.standard_normal(4)) + 0.1
    cases = [("Normal", (rng.standard_normal(4), np.array([1.0, 2.0, -1.0, 0.5]))),
             ("Gamma", (np.array([3.0, 0.5, -1.0, 2.0]), np.array([0.2, 2.0, 1.0, 1.5]))),
             ("Beta", (np.array([2.0, 0.5, 1.0, 3.0]), np.array([3.0, 0.5, -1.0, 1.0]))),
             ("TDist", (np.array([2.2, 4.0, -1.0, 1.0]),)),
             ("Weibull", (np.array([1.5, 3.0, 1.0, 0.5]), np.array([2.0, 1.0, 1.0, 1.0])))]
    for name, params in cases:
        if name == "Beta":
            xx = np.clip(x / (x.max() + 0.1), 0.05, 0.95)
        else:
            xx = x

        def jf(xv, *ps):
            return jnp.sum(jnp.where(jnp.isfinite(lp := getattr(jd, name)(
                *ps).logpdf(xv)), lp, 0.0))

        def tf(xv, *ps):
            lp = getattr(td, name)(*ps).logpdf(xv)
            return torch.where(torch.isfinite(lp), lp, 0.0).sum()

        jl = getattr(jd, name)(*map(jnp.asarray, params)).logpdf(jnp.asarray(xx))
        tl = getattr(td, name)(*map(torch.as_tensor, params)).logpdf(
            torch.as_tensor(xx))
        _same(tl.numpy(), jl, 1e-6)
        argn = tuple(range(1 + len(params)))
        jg = jax.grad(jf, argnums=argn)(jnp.asarray(xx),
                                        *map(jnp.asarray, params))
        tg = torch.func.grad(tf, argnums=argn)(torch.as_tensor(xx),
                                               *map(torch.as_tensor, params))
        for a, b in zip(tg, jg):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-12)


CDF_CASES = [("Normal", (0.5, 2.0)), ("Uniform", (-1.0, 2.0)),
             ("Exponential", (1.5,)), ("Gamma", (3.0, 0.2)),
             ("Weibull", (1.5, 2.0)), ("Cauchy", (-1.0, 0.2)),
             ("LogNormal", (-1.0, 1.0)), ("Laplace", (0.0, 1.0)),
             ("Bernoulli", (0.3,)), ("Poisson", (2.5,))]


@pytest.mark.parametrize("name,params", CDF_CASES,
                         ids=[n for n, _ in CDF_CASES])
def test_logcdf_logccdf_match_jax(name, params):
    jdist, tdist = _pair(name, params)
    xs = _grid(name)
    for meth in ("logcdf", "logccdf"):
        want = getattr(jdist, meth)(jnp.asarray(xs, jnp.float64))
        got = getattr(tdist, meth)(torch.as_tensor(xs, dtype=torch.float64))
        _same(got.numpy(), want, CDF_RTOL, atol=1e-12)


@pytest.mark.parametrize("name,params", [("Beta", (2.0, 3.0)), ("TDist", (3.0,)),
                                         ("Binomial", (10, 0.3))])
def test_betainc_cdfs_raise(name, params):
    """The cdfs on the port's regularized incomplete beta function
    (ops/betainc.py) equal the JAX package's on the grid, and a gradient in
    a distribution parameter that reaches betainc's a or b raises as JAX's
    does (tests/test_torch_betainc.py holds the function itself)."""
    jdist, tdist = _pair(name, params)
    xs = _grid(name)
    for meth in ("cdf", "logcdf", "logccdf"):
        want = getattr(jdist, meth)(jnp.asarray(xs, jnp.float64))
        got = getattr(tdist, meth)(torch.as_tensor(xs, dtype=torch.float64))
        _same(got.numpy(), want, 1e-10, atol=1e-300)
    field = {"Beta": "a", "TDist": "df", "Binomial": "n"}[name]
    with pytest.raises(ValueError, match="Betainc gradient"):
        jax.grad(lambda v: getattr(jd, name)(
            **{**vars(jdist), field: v}).cdf(0.5))(3.0)
    with pytest.raises(ValueError, match="Betainc gradient"):
        torch.func.grad(lambda v: getattr(td, name)(
            **{**vars(tdist), field: v}).cdf(
                torch.tensor(0.5, dtype=torch.float64)))(
            torch.tensor(3.0, dtype=torch.float64))


def test_censoring_truncated_mvnormal_match_jax():
    xs = np.linspace(-2.5, 3.0, 12)
    pairs = [
        (+jd.Normal(0.5, 2.0), +td.Normal(0.5, 2.0)),
        (-jd.Normal(0.5, 2.0), -td.Normal(0.5, 2.0)),
        (+jd.Exponential(1.5), +td.Exponential(1.5)),
        (jd.Truncated(jd.Normal(0.0, 1.0), -1.0, 2.0),
         td.Truncated(td.Normal(0.0, 1.0), -1.0, 2.0)),
        (jd.Truncated(jd.Gamma(3.0, 0.5), None, 1.0),
         td.Truncated(td.Gamma(3.0, 0.5), None, 1.0)),
        (jd.Truncated(jd.Laplace(0.0, 1.0), 0.0, None),
         td.Truncated(td.Laplace(0.0, 1.0), 0.0, None)),
    ]
    for jdist, tdist in pairs:
        _same(tdist.logpdf(torch.as_tensor(xs)).numpy(),
              jdist.logpdf(jnp.asarray(xs)), CDF_RTOL, atol=1e-12)
    tr_j, tr_t = pairs[3]
    for meth in ("logcdf", "logccdf"):
        _same(getattr(tr_t, meth)(torch.as_tensor(xs)).numpy(),
              getattr(tr_j, meth)(jnp.asarray(xs)), CDF_RTOL, atol=1e-12)

    rng = np.random.default_rng(3)
    A = rng.standard_normal((3, 3))
    cov, mu = A @ A.T + 3 * np.eye(3), rng.standard_normal(3)
    x = rng.standard_normal((5, 3))
    np.testing.assert_allclose(
        td.MvNormal(mu, cov).logpdf(torch.as_tensor(x)).numpy(),
        np.asarray(jd.MvNormal(jnp.asarray(mu), jnp.asarray(cov)).logpdf(
            jnp.asarray(x))), rtol=1e-10)


MOMENT_CASES = [("Normal", (0.5, 2.0)), ("Uniform", (-1.0, 2.0)),
                ("Exponential", (1.5,)), ("Gamma", (3.0, 0.2)),
                ("Gamma", (0.5, 2.0)), ("Weibull", (1.5, 2.0)),
                ("Cauchy", (-1.0, 0.2)), ("LogNormal", (-1.0, 1.0)),
                ("Beta", (2.0, 3.0)), ("Laplace", (0.0, 1.0)),
                ("TDist", (2.2,)), ("Bernoulli", (0.3,)),
                ("Binomial", (10, 0.3)), ("Poisson", (2.5,))]


@pytest.mark.parametrize("name,params", MOMENT_CASES,
                         ids=[f"{n}{p}" for n, p in MOMENT_CASES])
def test_moments_and_sampling(name, params):
    """mean/std as JAX gives them, and samples from a torch.Generator whose
    mean lies within 5 standard errors of it (Cauchy: the median)."""
    jdist, tdist = _pair(name, params)
    jm, tm = np.asarray(jdist.mean()), tdist.mean().numpy()
    np.testing.assert_allclose(tm, jm, rtol=1e-10, equal_nan=True)
    js, ts = np.asarray(jdist.std()), tdist.std().numpy()
    np.testing.assert_allclose(ts, js, rtol=1e-10, equal_nan=True)
    g = torch.Generator().manual_seed(7)
    n = 20000
    s = tdist.sample(g, (n,)).double().numpy()
    assert s.shape == (n,) and np.all(np.isfinite(s))
    assert np.all(np.isfinite(tdist.logpdf(torch.as_tensor(s)).numpy()))
    if name == "Cauchy":
        assert abs(np.median(s) - params[0]) < 5 * params[1] * math.pi / 2 \
            / math.sqrt(n)
    elif np.isfinite(js) and js > 0:
        assert abs(s.mean() - float(jm)) < 5 * float(js) / math.sqrt(n)


# ---- kernel rows -----------------------------------------------------------


def _row_logp_grad(code, p, c, x):
    """numpy float64 copy of csrc/target_common.cuh family_eval."""
    p0, p1 = p[0], p[1]
    inf = -np.inf
    with np.errstate(all="ignore"):
        if code == 0:
            z = (x - p0) / p1
            return -0.5 * z * z + c, -z / p1
        if code == 1:
            inside = (x >= p0) & (x <= p1)
            return np.where(inside, c, inf), np.zeros_like(x)
        if code == 2:
            inside = x >= 0
            return (np.where(inside, -x / p0 + c, inf),
                    np.where(inside, -1.0 / p0, 0.0))
        if code == 3:
            inside = x > 0
            return (np.where(inside, (p0 - 1) * np.log(x) - x / p1 + c, inf),
                    np.where(inside, (p0 - 1) / x - 1 / p1, 0.0))
        if code == 4:
            inside = x > 0
            xs = np.where(inside, x, 1.0)
            z = xs / p1
            zk = z ** p0
            return (np.where(inside, c + (p0 - 1) * np.log(z) - zk, inf),
                    np.where(inside, ((p0 - 1) - p0 * zk) / xs, 0.0))
        if code == 5:
            z = (x - p0) / p1
            return c - np.log1p(z * z), -2 * z / (p1 * (1 + z * z))
        if code == 6:
            inside = x > 0
            xs = np.where(inside, x, 1.0)
            z = (np.log(xs) - p0) / p1
            return (np.where(inside, -0.5 * z * z - np.log(xs) + c, inf),
                    np.where(inside, -(z / p1 + 1) / xs, 0.0))
        if code == 7:
            inside = (x > 0) & (x < 1)
            xs = np.where(inside, x, 0.5)
            return (np.where(inside, (p0 - 1) * np.log(xs)
                             + (p1 - 1) * np.log1p(-xs) + c, inf),
                    np.where(inside, (p0 - 1) / xs - (p1 - 1) / (1 - xs), 0.0))
        if code == 8:
            u = x - p0
            return -np.abs(u) / p1 + c, np.where(u >= 0, -1.0, 1.0) / p1
        v = p0
        return c - 0.5 * (v + 1) * np.log1p(x * x / v), -(v + 1) * x / (v + x * x)


ROW_CASES = [c for c in CASES if c[0] in CONTINUOUS]


@pytest.mark.parametrize("name,params", ROW_CASES,
                         ids=[f"{n}{p}" for n, p in ROW_CASES])
def test_kernel_rows_match_jax(name, params):
    """Codes and folded normalizers: the kernels' formulas (in a numpy copy)
    with the row's parameters and constant give JAX's logpdf and jax.grad
    on the grid, -inf and 0 out of support.  Invalid parameters have no
    row (the route then runs the generic engine)."""
    jdist, tdist = _pair(name, params)
    row = tdist.kernel_row()
    want = np.asarray(jdist.logpdf(jnp.asarray(XS)))
    if np.all(np.isneginf(want)):  # invalid parameters
        assert row is None
        return
    code, p, c = row
    assert code == td.FAMILY_CODES[name] and len(p) == 3
    lp, g = _row_logp_grad(code, p, c, XS)
    _same(lp, want, 1e-12, atol=1e-12)
    jg = np.asarray(jax.vmap(jax.grad(lambda x: jdist.logpdf(x)))(
        jnp.asarray(XS)))
    np.testing.assert_allclose(g, jg, rtol=1e-10, atol=1e-12)


def test_kernel_rows_need_scalar_parameters():
    assert td.Normal(torch.zeros(3), 1.0).kernel_row() is None
    assert td.Gamma(np.float32(3.0), 2).kernel_row()[0] == 3
    assert td.Bernoulli(0.3).kernel_row() is None
    assert td.MvNormal(np.zeros(2), np.eye(2)).kernel_row() is None
