"""Natively batched distribution catalog (port of
``mcmc_jl_tpu/models/distributions.py``; reference:
src/dsl/definitions/DistributionsExtensions.jl).

Distributions hold (possibly batched) parameters, Python scalars or
tensors, and every density method is one broadcast tensor expression, so
``tilde(y, Normal(mu_vec, sigma))`` is one batched op and ``torch.func``
differentiates through both ``x`` and the parameters.

Support handling: every ``logpdf`` returns ``-inf`` outside the support (or
for invalid parameters), never an exception, using the "double-where"
pattern: the unsafe expression is evaluated at a safe point, so the
gradient of an out-of-support entry is 0 and never NaN (the reference
throws ``OutOfSupportError`` and maps it to ``(-Inf, 0)`` at the model
boundary, src/dsl/modelparser.jl:64-72).

Parameterizations follow Julia's Distributions.jl: ``Gamma(shape, scale)``,
``Exponential(scale)``, ``Weibull(shape, scale)``, ``LogNormal(meanlog,
sdlog)``, ``TDist(df)``.  Normalizers of Python-scalar parameters are
folded on the host in double (``math.lgamma``), as the JAX package does.

Censoring sugar: ``tilde(y, +D)`` right-censors (``logccdf``) and
``tilde(y, -D)`` left-censors (``logcdf``) (src/dsl/expr_funcs.jl:18-22).

Kernel rows: the ten continuous families with Python-scalar parameters
give :meth:`Distribution.kernel_row`, a family code, three parameters and
the folded normalizer, which the custom-target CUDA kernels evaluate
(``csrc/target_common.cuh``).  A :class:`CatalogTarget` is a product of
such distributions over the coordinates, with their rows; a
:class:`DenseTarget` is one seen through a frozen dense metric,
``z -> target(z L')``, which kernels 5 and 8b take with the factor.

The cdfs of ``Beta``, ``TDist`` and ``Binomial`` go through the
regularized incomplete beta function of ``ops/betainc.py`` (torch has
none), which is differentiable in ``x`` only, as JAX's ``betainc`` is.
"""
from __future__ import annotations

import dataclasses
import math
import numbers

import torch

from ..ops.betainc import betainc

_REGISTRY = {}

LOG2PI = math.log(2.0 * math.pi)
_INF = float("inf")

#: family codes of the custom-target kernels (csrc/target_common.cuh)
FAMILY_CODES = {"Normal": 0, "Uniform": 1, "Exponential": 2, "Gamma": 3,
                "Weibull": 4, "Cauchy": 5, "LogNormal": 6, "Beta": 7,
                "Laplace": 8, "TDist": 9}


def _pyscalar(v):
    """float(v) for a Python or numpy real scalar; else None (tensors keep
    the tensor path, as traced values do in the JAX package)."""
    if isinstance(v, numbers.Real):
        return float(v)
    return None


def _prep(x, *params):
    """``x`` and ``params`` as tensors of one floating dtype on one device:
    the device of the first tensor among them, the dtype promoted over the
    floating tensors (Python scalars follow, as JAX's weak types do)."""
    tens = [p for p in (x, *params) if isinstance(p, torch.Tensor)]
    dev = tens[0].device if tens else None
    dtype = None
    for t in tens:
        if t.is_floating_point():
            dtype = t.dtype if dtype is None else torch.promote_types(
                dtype, t.dtype)
    dtype = dtype or torch.get_default_dtype()
    return [torch.as_tensor(p, dtype=dtype, device=dev) for p in (x, *params)]


def _safe(cond, x, safe_val):
    """Replace out-of-domain x by a harmless value before an unsafe op."""
    return torch.where(cond, x, safe_val)


def _log_of(p):
    """log(p) that returns -inf (not nan) for p <= 0, with a zero gradient
    there."""
    ok = p > 0
    return torch.where(ok, torch.log(_safe(ok, p, 1.0)), -_INF)


def _abs(u):
    """|u| with the derivative +1 at 0, as ``jax.grad(jnp.abs)(0.0)``
    gives (``torch.abs`` gives 0 there)."""
    return torch.where(u >= 0, u, -u)


def _shape(shape, *params):
    return torch.broadcast_shapes(tuple(shape), *(
        tuple(p.shape) for p in params if isinstance(p, torch.Tensor)))


def _draw(fn, generator, shape, *params):
    """``fn(shape, dtype, device)`` draws on the generator's device."""
    dtype = next((p.dtype for p in params
                  if isinstance(p, torch.Tensor) and p.is_floating_point()),
                 torch.get_default_dtype())
    dev = generator.device if generator is not None else None
    return fn(_shape(shape, *params), dtype, dev)


def _f64(v):
    """A moment as a tensor: float64 for Python scalars."""
    if isinstance(v, torch.Tensor):
        return v if v.is_floating_point() else v.to(torch.float64)
    return torch.tensor(float(v), dtype=torch.float64)


def distribution(cls):
    """Register a distribution class as a frozen dataclass."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    _REGISTRY[cls.__name__] = cls
    return cls


class Distribution:
    """Base: elementwise log-density family over broadcastable parameters."""

    def logpdf(self, x):  # elementwise; callers sum
        raise NotImplementedError

    def logcdf(self, x):
        raise NotImplementedError(
            f"{type(self).__name__}.logcdf is not defined")

    def logccdf(self, x):
        raise NotImplementedError(
            f"{type(self).__name__}.logccdf is not defined")

    def cdf(self, x):
        return torch.exp(self.logcdf(x))

    def sample(self, generator, shape=()):
        raise NotImplementedError

    def mean(self):
        raise NotImplementedError

    def std(self):
        raise NotImplementedError

    def kernel_row(self):
        """``(code, (p0, p1, p2), log-normalizer)`` for the custom-target
        kernels, or None: only the ten continuous families with valid
        Python-scalar parameters have one."""
        code = FAMILY_CODES.get(type(self).__name__)
        if code is None:
            return None
        vals = [_pyscalar(getattr(self, f.name))
                for f in dataclasses.fields(self)]
        if any(v is None for v in vals):
            return None
        row = self._row(*vals)
        if row is None:
            return None
        params, norm = row
        return code, tuple(params) + (0.0,) * (3 - len(params)), float(norm)

    # -- censoring sugar: y ~ +D  /  y ~ -D --------------------------------
    def __pos__(self):
        return RightCensored(self)

    def __neg__(self):
        return LeftCensored(self)


@distribution
class RightCensored(Distribution):
    """``y ~ +D``: contributes ``logccdf(D, y)`` (reference expr_funcs.jl:18)."""

    base: Distribution

    def logpdf(self, x):
        return self.base.logccdf(x)


@distribution
class LeftCensored(Distribution):
    """``y ~ -D``: contributes ``logcdf(D, y)`` (reference expr_funcs.jl:21)."""

    base: Distribution

    def logpdf(self, x):
        return self.base.logcdf(x)


@distribution
class Truncated(Distribution):
    """``Truncated(D, lo, hi)``: D conditioned on ``lo <= x <= hi`` (either
    bound may be None).  The log-density is renormalized by the log
    truncation mass, from logcdf/logccdf; x outside the bounds gives
    ``-inf``."""

    base: Distribution
    lo: object = None
    hi: object = None

    def _bound(self, v, like):
        return None if v is None else torch.as_tensor(
            v, dtype=like.dtype, device=like.device)

    def _log_mass(self, like):
        """The log truncation mass, in the dtype of ``like``."""
        lo, hi = self._bound(self.lo, like), self._bound(self.hi, like)
        if lo is None and hi is None:
            return 0.0
        if lo is None:
            return self.base.logcdf(hi)
        if hi is None:
            return self.base.logccdf(lo)
        la = self.base.logcdf(hi)
        lb = self.base.logcdf(lo)
        return la + torch.log1p(-torch.exp(lb - la))

    def _in_bounds(self, x):
        ok = torch.ones_like(x, dtype=torch.bool)
        if self.lo is not None:
            ok = ok & (x >= self.lo)
        if self.hi is not None:
            ok = ok & (x <= self.hi)
        return ok

    def logpdf(self, x):
        lp = self.base.logpdf(x)
        x = torch.as_tensor(x, dtype=lp.dtype, device=lp.device)
        lp = lp - self._log_mass(x)
        return torch.where(self._in_bounds(x), lp, -_INF)

    def logcdf(self, x):
        num = self.base.logcdf(x)
        x = torch.as_tensor(x, dtype=num.dtype, device=num.device)
        if self.lo is not None:
            lo_mass = self.base.logcdf(self._bound(self.lo, x))
            num = num + torch.log1p(-torch.exp(torch.clamp(lo_mass - num,
                                                           max=0.0)))
        out = torch.clamp(num - self._log_mass(x), max=0.0)
        below = (torch.zeros_like(x, dtype=torch.bool) if self.lo is None
                 else x < self.lo)
        above = (torch.zeros_like(x, dtype=torch.bool) if self.hi is None
                 else x > self.hi)
        return torch.where(below, -_INF, torch.where(above, 0.0, out))

    def logccdf(self, x):
        return torch.log1p(-torch.exp(torch.clamp(self.logcdf(x), max=0.0)))


# =========================================================================
# Continuous distributions
# =========================================================================


@distribution
class Normal(Distribution):
    mu: object = 0.0
    sigma: object = 1.0

    def logpdf(self, x):
        x, mu, sigma = _prep(x, self.mu, self.sigma)
        ok = sigma > 0
        s = _safe(ok, sigma, 1.0)
        z = (x - mu) / s
        lp = -0.5 * z * z - torch.log(s) - 0.5 * LOG2PI
        return torch.where(ok, lp, -_INF)

    def _z(self, x):
        x, mu, sigma = _prep(x, self.mu, self.sigma)
        ok = sigma > 0
        return ok, (x - mu) / _safe(ok, sigma, 1.0)

    def logcdf(self, x):
        ok, z = self._z(x)
        return torch.where(ok, torch.special.log_ndtr(z), -_INF)

    def logccdf(self, x):
        ok, z = self._z(x)
        return torch.where(ok, torch.special.log_ndtr(-z), -_INF)

    def sample(self, generator, shape=()):
        return self.mu + self.sigma * _draw(
            lambda s, dt, dev: torch.randn(s, generator=generator, dtype=dt,
                                           device=dev),
            generator, shape, self.mu, self.sigma)

    def mean(self):
        return _f64(self.mu)

    def std(self):
        return _f64(self.sigma)

    @staticmethod
    def _row(mu, sigma):
        if not sigma > 0:
            return None
        return (mu, sigma), -math.log(sigma) - 0.5 * LOG2PI


@distribution
class Uniform(Distribution):
    a: object = 0.0
    b: object = 1.0

    def logpdf(self, x):
        x, a, b = _prep(x, self.a, self.b)
        ok = b > a
        w = _safe(ok, b - a, 1.0)
        inside = ok & (x >= a) & (x <= b)
        return torch.where(inside, -torch.log(w), -_INF)

    def cdf(self, x):
        x, a, b = _prep(x, self.a, self.b)
        return torch.clamp((x - a) / (b - a), 0.0, 1.0)

    def logcdf(self, x):
        c = self.cdf(x)
        return torch.log(_safe(c > 0, c, 1.0)) + torch.where(c > 0, 0.0, -_INF)

    def logccdf(self, x):
        c = 1.0 - self.cdf(x)
        return torch.log(_safe(c > 0, c, 1.0)) + torch.where(c > 0, 0.0, -_INF)

    def sample(self, generator, shape=()):
        u = _draw(lambda s, dt, dev: torch.rand(s, generator=generator,
                                                dtype=dt, device=dev),
                  generator, shape, self.a, self.b)
        return self.a + (self.b - self.a) * u

    def mean(self):
        return 0.5 * (_f64(self.a) + self.b)

    def std(self):
        return (_f64(self.b) - self.a) / math.sqrt(12.0)

    @staticmethod
    def _row(a, b):
        if not b > a:
            return None
        return (a, b), -math.log(b - a)


@distribution
class Exponential(Distribution):
    """Julia convention: Exponential(scale); mean == scale."""

    scale: object = 1.0

    def logpdf(self, x):
        x, scale = _prep(x, self.scale)
        ok = scale > 0
        s = _safe(ok, scale, 1.0)
        inside = ok & (x >= 0)
        xs = _safe(inside, x, 0.0)
        return torch.where(inside, -xs / s - torch.log(s), -_INF)

    def logcdf(self, x):
        x, scale = _prep(x, self.scale)
        s = _safe(scale > 0, scale, 1.0)
        return _log_of(-torch.expm1(-torch.clamp(x, min=0.0) / s))

    def logccdf(self, x):
        x, scale = _prep(x, self.scale)
        s = _safe(scale > 0, scale, 1.0)
        return torch.where(x <= 0, 0.0, -torch.clamp(x, min=0.0) / s)

    def sample(self, generator, shape=()):
        e = _draw(lambda s, dt, dev: torch.empty(s, dtype=dt, device=dev)
                  .exponential_(generator=generator),
                  generator, shape, self.scale)
        return self.scale * e

    def mean(self):
        return _f64(self.scale)

    def std(self):
        return _f64(self.scale)

    @staticmethod
    def _row(s):
        if not s > 0:
            return None
        return (s,), -math.log(s)


@distribution
class Gamma(Distribution):
    """Julia convention: Gamma(shape, scale)."""

    shape: object = 1.0
    scale: object = 1.0

    def logpdf(self, x):
        sa, ss = _pyscalar(self.shape), _pyscalar(self.scale)
        if sa is not None and ss is not None:
            # scalar parameters: the lgamma normalizer folds on the host
            okc = sa > 0 and ss > 0
            a, s = (sa, ss) if okc else (1.0, 1.0)
            (x,) = _prep(x)
            inside = (x > 0) & okc
            xs = _safe(inside, x, 1.0)
            lp = ((a - 1.0) * torch.log(xs) - xs / s
                  - (math.lgamma(a) + a * math.log(s)))
            return torch.where(inside, lp, -_INF)
        x, shape, scale = _prep(x, self.shape, self.scale)
        ok = (shape > 0) & (scale > 0)
        a = _safe(ok, shape, 1.0)
        s = _safe(ok, scale, 1.0)
        inside = ok & (x > 0)
        xs = _safe(inside, x, 1.0)
        lp = ((a - 1.0) * torch.log(xs) - xs / s - torch.lgamma(a)
              - a * torch.log(s))
        return torch.where(inside, lp, -_INF)

    def _args(self, x):
        x, shape, scale = _prep(x, self.shape, self.scale)
        a = _safe(shape > 0, shape, 1.0)
        s = _safe(scale > 0, scale, 1.0)
        return a.expand_as(x + a), torch.clamp(x, min=0.0) / s

    def cdf(self, x):
        return torch.special.gammainc(*self._args(x))

    def logcdf(self, x):
        return _log_of(self.cdf(x))

    def logccdf(self, x):
        return _log_of(torch.special.gammaincc(*self._args(x)))

    def sample(self, generator, shape=()):
        def fn(s, dt, dev):
            a = torch.as_tensor(self.shape, dtype=dt, device=dev)
            return torch._standard_gamma(a.expand(s).contiguous(),
                                         generator=generator)

        return self.scale * _draw(fn, generator, shape, self.shape,
                                  self.scale)

    def mean(self):
        return _f64(self.shape) * self.scale

    def std(self):
        return torch.sqrt(_f64(self.shape)) * self.scale

    @staticmethod
    def _row(a, s):
        if not (a > 0 and s > 0):
            return None
        return (a, s), -(math.lgamma(a) + a * math.log(s))


@distribution
class Weibull(Distribution):
    """Julia convention: Weibull(shape, scale)."""

    shape: object = 1.0
    scale: object = 1.0

    def logpdf(self, x):
        x, shape, scale = _prep(x, self.shape, self.scale)
        ok = (shape > 0) & (scale > 0)
        k = _safe(ok, shape, 1.0)
        s = _safe(ok, scale, 1.0)
        inside = ok & (x > 0)
        z = _safe(inside, x, 1.0) / s
        lp = torch.log(k / s) + (k - 1.0) * torch.log(z) - z ** k
        return torch.where(inside, lp, -_INF)

    def logccdf(self, x):
        x, shape, scale = _prep(x, self.shape, self.scale)
        k = _safe(shape > 0, shape, 1.0)
        s = _safe(scale > 0, scale, 1.0)
        z = torch.clamp(x, min=0.0) / s
        return -(z ** k)

    def cdf(self, x):
        return -torch.expm1(self.logccdf(x))

    def logcdf(self, x):
        return _log_of(self.cdf(x))

    def sample(self, generator, shape=()):
        tiny = torch.finfo(torch.float64).tiny
        u = _draw(lambda s, dt, dev: torch.rand(s, generator=generator,
                                                dtype=dt, device=dev)
                  .clamp_min(tiny), generator, shape, self.shape, self.scale)
        return self.scale * (-torch.log(u)) ** (1.0 / torch.as_tensor(
            self.shape, dtype=u.dtype, device=u.device))

    def mean(self):
        k = _f64(self.shape)
        return self.scale * torch.exp(torch.lgamma(1.0 + 1.0 / k))

    def std(self):
        k = _f64(self.shape)
        m2 = torch.exp(torch.lgamma(1.0 + 2.0 / k))
        m1 = torch.exp(torch.lgamma(1.0 + 1.0 / k))
        return self.scale * torch.sqrt(m2 - m1 * m1)

    @staticmethod
    def _row(k, s):
        if not (k > 0 and s > 0):
            return None
        return (k, s), math.log(k / s)


@distribution
class Cauchy(Distribution):
    loc: object = 0.0
    scale: object = 1.0

    def logpdf(self, x):
        x, loc, scale = _prep(x, self.loc, self.scale)
        ok = scale > 0
        s = _safe(ok, scale, 1.0)
        z = (x - loc) / s
        lp = -torch.log(math.pi * s * (1.0 + z * z))
        return torch.where(ok, lp, -_INF)

    def _z(self, x):
        x, loc, scale = _prep(x, self.loc, self.scale)
        return (x - loc) / scale

    def cdf(self, x):
        return torch.atan(self._z(x)) / math.pi + 0.5

    def logcdf(self, x):
        return _log_of(self.cdf(x))

    def logccdf(self, x):
        return _log_of(torch.atan(-self._z(x)) / math.pi + 0.5)

    def sample(self, generator, shape=()):
        c = _draw(lambda s, dt, dev: torch.empty(s, dtype=dt, device=dev)
                  .cauchy_(generator=generator),
                  generator, shape, self.loc, self.scale)
        return self.loc + self.scale * c

    def mean(self):  # undefined
        return torch.full(tuple(torch.as_tensor(self.loc).shape), math.nan,
                          dtype=torch.float64)

    def std(self):
        return self.mean()

    @staticmethod
    def _row(loc, s):
        if not s > 0:
            return None
        return (loc, s), -math.log(math.pi * s)


@distribution
class LogNormal(Distribution):
    mu: object = 0.0
    sigma: object = 1.0

    def logpdf(self, x):
        x, mu, sigma = _prep(x, self.mu, self.sigma)
        ok = sigma > 0
        s = _safe(ok, sigma, 1.0)
        inside = ok & (x > 0)
        xs = _safe(inside, x, 1.0)
        lx = torch.log(xs)
        z = (lx - mu) / s
        lp = -0.5 * z * z - lx - torch.log(s) - 0.5 * LOG2PI
        return torch.where(inside, lp, -_INF)

    def _z(self, x):
        x, mu, sigma = _prep(x, self.mu, self.sigma)
        inside = x > 0
        lx = torch.log(_safe(inside, x, 1.0))
        return inside, (lx - mu) / sigma

    def logcdf(self, x):
        inside, z = self._z(x)
        return torch.where(inside, torch.special.log_ndtr(z), -_INF)

    def logccdf(self, x):
        inside, z = self._z(x)
        return torch.where(inside, torch.special.log_ndtr(-z), 0.0)

    def sample(self, generator, shape=()):
        return torch.exp(Normal(self.mu, self.sigma).sample(generator, shape))

    def mean(self):
        s = _f64(self.sigma)
        return torch.exp(self.mu + 0.5 * s * s)

    def std(self):
        s = _f64(self.sigma)
        return torch.sqrt(torch.exp(s * s) - 1.0) * self.mean()

    @staticmethod
    def _row(mu, sigma):
        if not sigma > 0:
            return None
        return (mu, sigma), -math.log(sigma) - 0.5 * LOG2PI


@distribution
class Beta(Distribution):
    a: object = 1.0
    b: object = 1.0

    def logpdf(self, x):
        sa, sb = _pyscalar(self.a), _pyscalar(self.b)
        if sa is not None and sb is not None:
            # scalar parameters: log B(a, b) folds on the host
            okc = sa > 0 and sb > 0
            a, b = (sa, sb) if okc else (1.0, 1.0)
            norm = math.lgamma(a) + math.lgamma(b) - math.lgamma(a + b)
            (x,) = _prep(x)
            inside = (x > 0) & (x < 1) & okc
            xs = _safe(inside, x, 0.5)
            lp = ((a - 1.0) * torch.log(xs)
                  + (b - 1.0) * torch.log1p(-xs) - norm)
            return torch.where(inside, lp, -_INF)
        x, pa, pb = _prep(x, self.a, self.b)
        ok = (pa > 0) & (pb > 0)
        a = _safe(ok, pa, 1.0)
        b = _safe(ok, pb, 1.0)
        inside = ok & (x > 0) & (x < 1)
        xs = _safe(inside, x, 0.5)
        lp = ((a - 1.0) * torch.log(xs) + (b - 1.0) * torch.log1p(-xs)
              - (torch.lgamma(a) + torch.lgamma(b) - torch.lgamma(a + b)))
        return torch.where(inside, lp, -_INF)

    def cdf(self, x):
        x, a, b = _prep(x, self.a, self.b)
        return betainc(a, b, torch.clamp(x, 0.0, 1.0))

    def logcdf(self, x):
        return _log_of(self.cdf(x))

    def logccdf(self, x):
        return _log_of(1.0 - self.cdf(x))

    def sample(self, generator, shape=()):
        ga = Gamma(self.a, 1.0).sample(generator, shape)
        gb = Gamma(self.b, 1.0).sample(generator, shape)
        return ga / (ga + gb)

    def mean(self):
        a = _f64(self.a)
        return a / (a + self.b)

    def std(self):
        a, b = _f64(self.a), _f64(self.b)
        return torch.sqrt(a * b / ((a + b) ** 2 * (a + b + 1.0)))

    @staticmethod
    def _row(a, b):
        if not (a > 0 and b > 0):
            return None
        return (a, b), -(math.lgamma(a) + math.lgamma(b) - math.lgamma(a + b))


@distribution
class Laplace(Distribution):
    loc: object = 0.0
    scale: object = 1.0

    def logpdf(self, x):
        x, loc, scale = _prep(x, self.loc, self.scale)
        ok = scale > 0
        s = _safe(ok, scale, 1.0)
        # |x - loc| differentiates to +1 at x = loc, as jax.grad(jnp.abs)
        lp = -_abs(x - loc) / s - torch.log(2.0 * s)
        return torch.where(ok, lp, -_INF)

    def _z(self, x):
        x, loc, scale = _prep(x, self.loc, self.scale)
        return (x - loc) / scale

    def cdf(self, x):
        z = self._z(x)
        return torch.where(z < 0, 0.5 * torch.exp(z), 1.0 - 0.5 * torch.exp(-z))

    def logcdf(self, x):
        z = self._z(x)
        return torch.where(z < 0, z - math.log(2.0),
                           torch.log1p(-0.5 * torch.exp(-torch.abs(z))))

    def logccdf(self, x):
        z = self._z(x)
        return torch.where(z > 0, -z - math.log(2.0),
                           torch.log1p(-0.5 * torch.exp(-torch.abs(z))))

    def sample(self, generator, shape=()):
        u = _draw(lambda s, dt, dev: torch.rand(s, generator=generator,
                                                dtype=dt, device=dev) - 0.5,
                  generator, shape, self.loc, self.scale)
        return self.loc - self.scale * torch.sign(u) * torch.log1p(
            -2.0 * torch.abs(u))

    def mean(self):
        return _f64(self.loc)

    def std(self):
        return math.sqrt(2.0) * _f64(self.scale)

    @staticmethod
    def _row(loc, s):
        if not s > 0:
            return None
        return (loc, s), -math.log(2.0 * s)


@distribution
class TDist(Distribution):
    df: object = 1.0

    def logpdf(self, x):
        sv = _pyscalar(self.df)
        if sv is not None:
            # scalar df: the normalizer folds on the host
            okc = sv > 0
            v = sv if okc else 1.0
            norm = (math.lgamma(0.5 * (v + 1.0)) - math.lgamma(0.5 * v)
                    - 0.5 * math.log(v * math.pi))
            (x,) = _prep(x)
            lp = norm - 0.5 * (v + 1.0) * torch.log1p(x * x / v)
            return torch.where(torch.full_like(x, okc, dtype=torch.bool), lp,
                               -_INF)
        x, df = _prep(x, self.df)
        ok = df > 0
        v = _safe(ok, df, 1.0)
        lp = (torch.lgamma(0.5 * (v + 1.0)) - torch.lgamma(0.5 * v)
              - 0.5 * torch.log(v * math.pi)
              - 0.5 * (v + 1.0) * torch.log1p(x * x / v))
        return torch.where(ok, lp, -_INF)

    def cdf(self, x):
        x, v = _prep(x, self.df)
        ib = betainc(0.5 * v, 0.5, v / (v + x * x))
        return torch.where(x > 0, 1.0 - 0.5 * ib, 0.5 * ib)

    def logcdf(self, x):
        return _log_of(self.cdf(x))

    def logccdf(self, x):
        return _log_of(1.0 - self.cdf(x))

    def sample(self, generator, shape=()):
        z = Normal(0.0, 1.0).sample(generator, _shape(shape, self.df))
        chi2 = 2.0 * Gamma(0.5 * torch.as_tensor(self.df, dtype=z.dtype,
                                                 device=z.device),
                           1.0).sample(generator, z.shape)
        return z / torch.sqrt(chi2 / self.df)

    def mean(self):
        v = _f64(self.df)
        return torch.where(v > 1, 0.0, math.nan).to(v.dtype)

    def std(self):
        v = _f64(self.df)
        return torch.where(v > 2, torch.sqrt(v / (v - 2.0)), math.nan)

    @staticmethod
    def _row(v):
        if not v > 0:
            return None
        return (v,), (math.lgamma(0.5 * (v + 1.0)) - math.lgamma(0.5 * v)
                      - 0.5 * math.log(v * math.pi))


# =========================================================================
# Discrete distributions (derivatives flow through parameters only,
# matching the reference's rules: MCMCDerivRules.jl:105-117)
# =========================================================================


@distribution
class Bernoulli(Distribution):
    p: object = 0.5

    def logpdf(self, x):
        x, pp = _prep(x, self.p)
        ok = (pp >= 0) & (pp <= 1)
        p = torch.clamp(_safe(ok, pp, 0.5), 1e-30, 1.0)
        q = torch.clamp(1.0 - _safe(ok, pp, 0.5), 1e-30, 1.0)
        sup = (x == 0) | (x == 1)
        lp = x * torch.log(p) + (1.0 - x) * torch.log(q)
        return torch.where(ok & sup, lp, -_INF)

    def cdf(self, x):
        x, p = _prep(x, self.p)
        return torch.where(x < 0, 0.0, torch.where(x < 1, 1.0 - p, 1.0))

    def logcdf(self, x):
        return _log_of(self.cdf(x))

    def logccdf(self, x):
        return _log_of(1.0 - self.cdf(x))

    def sample(self, generator, shape=()):
        u = _draw(lambda s, dt, dev: torch.rand(s, generator=generator,
                                                dtype=dt, device=dev),
                  generator, shape, self.p)
        return (u < self.p).to(u.dtype)

    def mean(self):
        return _f64(self.p)

    def std(self):
        p = _f64(self.p)
        return torch.sqrt(p * (1.0 - p))


@distribution
class Binomial(Distribution):
    n: object = 1
    p: object = 0.5

    def logpdf(self, x):
        x, n, pp = _prep(x, self.n, self.p)
        ok = (pp >= 0) & (pp <= 1) & (n >= 0)
        p = torch.clamp(_safe(ok, pp, 0.5), 1e-30, 1.0)
        q = torch.clamp(1.0 - _safe(ok, pp, 0.5), 1e-30, 1.0)
        sup = (x >= 0) & (x <= n) & (x == torch.floor(x))
        xs = _safe(sup, x, 0.0)
        lp = (torch.lgamma(n + 1.0) - torch.lgamma(xs + 1.0)
              - torch.lgamma(n - xs + 1.0) + xs * torch.log(p)
              + (n - xs) * torch.log(q))
        return torch.where(ok & sup, lp, -_INF)

    def cdf(self, x):
        x, n, p = _prep(x, self.n, self.p)
        # floor has a zero derivative: detached, so that the cdf's gradient
        # in x is zero rather than a gradient in betainc's b, which raises
        k = torch.floor(torch.minimum(torch.clamp(x, min=-1.0), n)).detach()
        # P(X <= k) = I_{1-p}(n-k, k+1)
        c = betainc(torch.clamp(n - k, min=1e-12), k + 1.0, 1.0 - p)
        return torch.where(k < 0, 0.0, torch.where(k >= n, 1.0, c))

    def logcdf(self, x):
        return _log_of(self.cdf(x))

    def logccdf(self, x):
        return _log_of(1.0 - self.cdf(x))

    def sample(self, generator, shape=()):
        def fn(s, dt, dev):
            n = torch.as_tensor(self.n, dtype=dt, device=dev).expand(s)
            p = torch.as_tensor(self.p, dtype=dt, device=dev).expand(s)
            return torch.binomial(n.contiguous(), p.contiguous(),
                                  generator=generator)

        return _draw(fn, generator, shape, self.n, self.p)

    def mean(self):
        return _f64(self.n) * self.p

    def std(self):
        n = _f64(self.n)
        return torch.sqrt(n * self.p * (1.0 - self.p))


@distribution
class Poisson(Distribution):
    lam: object = 1.0

    def logpdf(self, x):
        x, lam_ = _prep(x, self.lam)
        ok = lam_ > 0
        lam = _safe(ok, lam_, 1.0)
        sup = (x >= 0) & (x == torch.floor(x))
        xs = _safe(sup, x, 0.0)
        lp = xs * torch.log(lam) - lam - torch.lgamma(xs + 1.0)
        return torch.where(ok & sup, lp, -_INF)

    def cdf(self, x):
        x, lam = _prep(x, self.lam)
        k = torch.floor(x)
        safe_k = torch.clamp(k, min=0.0)
        return torch.where(k < 0, 0.0, torch.special.gammaincc(
            safe_k + 1.0, lam.expand_as(safe_k)))

    def logcdf(self, x):
        return _log_of(self.cdf(x))

    def logccdf(self, x):
        return _log_of(1.0 - self.cdf(x))

    def sample(self, generator, shape=()):
        def fn(s, dt, dev):
            lam = torch.as_tensor(self.lam, dtype=dt, device=dev).expand(s)
            return torch.poisson(lam.contiguous(), generator=generator)

        return _draw(fn, generator, shape, self.lam)

    def mean(self):
        return _f64(self.lam)

    def std(self):
        return torch.sqrt(_f64(self.lam))


# =========================================================================
# Multivariate normal (for IMH proposals and the probit example's prior)
# =========================================================================


@distribution
class MvNormal(Distribution):
    """Multivariate normal with mean vector and covariance matrix."""

    mu: object
    cov: object

    def _chol(self, like):
        cov = torch.as_tensor(self.cov, dtype=like.dtype, device=like.device)
        return torch.linalg.cholesky(cov)

    def logpdf(self, x):
        x, mu = _prep(x, self.mu)
        L = self._chol(x)
        d = mu.shape[-1]
        xm = x - mu  # (..., d)
        batch_shape = xm.shape[:-1]
        z = torch.linalg.solve_triangular(L, xm.reshape(-1, d).T, upper=False)
        quad = (z * z).sum(0).reshape(batch_shape)
        return (-0.5 * quad - torch.log(torch.diagonal(L)).sum()
                - 0.5 * d * LOG2PI)

    def sample(self, generator, shape=()):
        mu = torch.as_tensor(self.mu, dtype=torch.get_default_dtype(),
                             device=generator.device)
        L = self._chol(mu)
        eps = torch.randn(tuple(shape) + (mu.shape[-1],), generator=generator,
                          dtype=mu.dtype, device=mu.device)
        return mu + eps @ L.T

    def mean(self):
        return _f64(torch.as_tensor(self.mu))


def logpdf(d: Distribution, x):
    """Free-function spelling ``logpdf(D, x)`` mirroring the reference DSL."""
    return d.logpdf(x)


def logcdf(d: Distribution, x):
    return d.logcdf(x)


def logccdf(d: Distribution, x):
    return d.logccdf(x)


class CatalogTarget:
    """A custom target over (C, d) chain blocks: ``target(theta)`` is the
    (C, 1) log-density, as a JAX ``logp_block`` gives it.

    Built from per-coordinate distributions, it also carries their kernel
    rows (:meth:`rows`) when every coordinate's family has one; built from
    a plain block function (``block``), it has none."""

    def __init__(self, dists=None, *, d=None, block=None):
        if (dists is None) == (block is None):
            raise ValueError("CatalogTarget takes dists or block")
        self.d = len(dists) if dists is not None else int(d)
        self._block = block
        self._rows = {}
        self._kernel_rows = None  # per coordinate, when every one has a row
        if dists is not None:
            groups, rows = {}, []
            for j, dist in enumerate(dists):
                if not isinstance(dist, Distribution):
                    raise TypeError(f"coordinate {j}: {dist!r} is not a "
                                    f"Distribution")
                row = dist.kernel_row()
                rows.append(row)
                key = (type(dist).__name__, row) if row else id(dist)
                groups.setdefault(key, (dist, []))[1].append(j)
            self._groups = list(groups.values())
            if all(r is not None for r in rows):
                self._kernel_rows = rows

    def __call__(self, theta):
        if self._block is not None:
            return self._block(theta)
        lp = None
        for dist, idx in self._groups:
            cols = theta if len(idx) == self.d else theta[..., idx]
            term = dist.logpdf(cols).sum(-1, keepdim=True)
            lp = term if lp is None else lp + term
        return lp

    @property
    def has_rows(self):
        return self._kernel_rows is not None

    def rows(self, device):
        """(codes (d,) int32, params (d, 4) float32: p0, p1, p2, folded
        log-normalizer) on ``device``; None without kernel rows."""
        if not self.has_rows:
            return None
        dev = torch.device(device)
        if dev not in self._rows:
            rs = self._kernel_rows
            codes = torch.tensor([r[0] for r in rs], dtype=torch.int32)
            params = torch.tensor([list(r[1]) + [r[2]] for r in rs],
                                  dtype=torch.float32)
            self._rows[dev] = (codes.to(dev), params.to(dev))
        return self._rows[dev]

    def __repr__(self):
        kind = "rows" if self.has_rows else "no kernel rows"
        return f"CatalogTarget(d={self.d}, {kind})"


class DenseTarget:
    """A catalog target seen through a frozen dense metric: ``target(z) =
    base(z L')`` over (C, d) chain blocks (the JAX package's ``_dense_wrap``
    in ``ops/warmstart.py``), with ``L`` the (d, d) lower-triangular
    Cholesky factor of the pooled metric, so that unit-metric dynamics in
    ``z`` are dense-metric dynamics in ``theta = z L'``.

    Its value is the base target's log-density at ``theta`` (no log-det
    term), its gradient in ``z`` the row ``g_theta L``.  The kernels take
    the base target's rows and the factor (:meth:`factor`); the plain
    versions differentiate ``__call__`` with ``torch.func``."""

    def __init__(self, base, L):
        if not isinstance(base, CatalogTarget):
            raise TypeError(f"DenseTarget wraps a CatalogTarget, got "
                            f"{type(base).__name__}")
        L = torch.as_tensor(L)
        if tuple(L.shape) != (base.d, base.d):
            raise ValueError(f"the factor is {tuple(L.shape)}, want "
                             f"({base.d}, {base.d})")
        self.base, self.d = base, base.d
        self.L = torch.tril(L.to(torch.float32)).contiguous()
        self._factors = {}

    def __call__(self, z):
        L = self.L.to(device=z.device, dtype=z.dtype)
        return self.base(z @ L.T)

    @property
    def has_rows(self):
        return self.base.has_rows

    def rows(self, device):
        """The base target's kernel rows on ``device``."""
        return self.base.rows(device)

    def factor(self, device):
        """The kernels' copy of the factor on ``device``: a contiguous
        float32 (2, d, d) tensor holding ``L`` and ``L'``, each row-major
        (a warp reads a row of either in one pass)."""
        dev = torch.device(device)
        if dev not in self._factors:
            L = self.L.to(dev)
            self._factors[dev] = torch.stack([L, L.T]).contiguous()
        return self._factors[dev]

    def __repr__(self):
        return f"DenseTarget({self.base!r})"


ALL_DISTRIBUTIONS = [
    Normal, Uniform, Weibull, Gamma, Cauchy, LogNormal, Binomial, Beta,
    Laplace, Bernoulli, TDist, Exponential, Poisson,
]

__all__ = [d.__name__ for d in ALL_DISTRIBUTIONS] + [
    "MvNormal", "Distribution", "RightCensored", "LeftCensored", "Truncated",
    "logpdf", "logcdf", "logccdf", "FAMILY_CODES", "CatalogTarget",
    "DenseTarget",
]
