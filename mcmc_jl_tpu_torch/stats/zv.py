"""Zero-variance MCMC estimators (port of ``mcmc_jl_tpu/stats/zv.py``;
reference: src/stats/zv.jl).

Mira, Solgi & Imparato (2013): post-process the chain with control variates
``z = -grad/2``.  ``linear_zv`` fits per-parameter OLS coefficients from the
covariance of ``[z, theta_i]`` (zv.jl:8-30); ``quadratic_zv`` uses the
k = p(p+3)/2 quadratic feature set including ``2 z .* theta - 1`` and cross
terms (zv.jl:33-68).  Both need the gradients the chain stores, which the
gradient-based samplers keep (``pgrads``).  Host-side numpy, as in the JAX
package.
"""
from __future__ import annotations

import numpy as np

from ..core.chain import MCMCChain


def _mats(chain, grad):
    if isinstance(chain, MCMCChain):
        assert not chain.gradients.empty, (
            "ZV estimators need stored gradients; run with a gradient-based "
            "sampler")
        return (np.asarray(chain.samples.values, dtype=np.float64),
                np.asarray(chain.gradients.values, dtype=np.float64))
    return (np.asarray(chain, dtype=np.float64),
            np.asarray(grad, dtype=np.float64))


def _fit(features, x):
    """OLS coefficients of each column of ``x`` on ``features`` through
    their joint sample covariance: ``a[:, i] = -Cov(f)^-1 Cov(f, x_i)``."""
    k = features.shape[1]
    a = np.empty((k, x.shape[1]))
    for i in range(x.shape[1]):
        cov_all = np.cov(np.column_stack([features, x[:, i]]), rowvar=False)
        a[:, i] = -np.linalg.inv(cov_all[:k, :k]) @ cov_all[:k, k]
    return a


def linear_zv(chain, grad=None):
    """``(x + z a, a)`` with the linear control variates ``z = -grad/2``;
    ``chain`` is an :class:`MCMCChain` with stored gradients, or an (n, p)
    array with ``grad`` beside it."""
    x, g = _mats(chain, grad)
    z = -g / 2.0
    a = _fit(z, x)
    return x + z @ a, a


def quadratic_zv(chain, grad=None):
    """As :func:`linear_zv` with the p(p+3)/2 quadratic features."""
    x, g = _mats(chain, grad)
    nsamples, npars = x.shape
    z = -g / 2.0
    zq = np.empty((nsamples, npars * (npars + 3) // 2))
    zq[:, :npars] = z
    zq[:, npars:2 * npars] = 2.0 * z * x - 1.0
    col = 2 * npars
    for i in range(npars - 1):
        for j in range(i + 1, npars):
            zq[:, col] = x[:, i] * z[:, j] + x[:, j] * z[:, i]
            col += 1
    a = _fit(zq, x)
    return x + zq @ a, a


# reference-spelling aliases (zv.jl exports linearZv / quadraticZv)
linearZv = linear_zv
quadraticZv = quadratic_zv
