"""MCMC quantile estimation with Monte Carlo standard errors.

Implements the reference's open TODO (src/stats/summary.jl:17-18):

    # TODO 1: Compute MCMC quantiles based on
    # Flegal J.M, Galin L.J, Neath R.C. Markov Chain Monte Carlo Estimation
    # of Quantiles. arXiv, 2013
    # TODO 2: Include these MCMC estimates of quantiles in describe()

Method (Flegal, Jones & Neath 2013, §3): the point estimate is the empirical
quantile xi_q.  Its asymptotic variance is sigma^2(q) / (n f(xi_q)^2), where
sigma^2(q) is the long-run variance of the indicator chain I(X_t <= xi_q)
(estimated here by batch means or a Geyer initial-sequence estimator on the
indicators) and f is the stationary density, estimated by a Gaussian kernel
density with Silverman's rule-of-thumb bandwidth.

Port of ``mcmc_jl_tpu/stats/quantile.py``: host-side numpy, as there."""
from __future__ import annotations

import numpy as np

from .var import _columns, mcvar_bm, mcvar_imse, mcvar_ipse, mcvar_iid


def _density_at(col: np.ndarray, point: float) -> float:
    """Gaussian KDE estimate of the stationary density at ``point``
    (Silverman's bandwidth — FJN13 use a KDE for f-hat)."""
    n = col.shape[0]
    sd = np.std(col, ddof=1)
    iqr = np.subtract(*np.percentile(col, [75, 25]))
    scale = min(sd, iqr / 1.34) if iqr > 0 else sd
    h = 0.9 * scale * n ** (-0.2)
    if not np.isfinite(h) or h <= 0:
        return np.nan
    z = (point - col) / h
    return float(np.exp(-0.5 * z * z).sum() / (n * h * np.sqrt(2.0 * np.pi)))


def mcmc_quantile(x, q, pars=None, vtype: str = "bm", **kwargs):
    """Quantile point estimates and their MC standard errors.

    Args:
      x: chain / table / (n, p) array.
      q: quantile level in (0, 1), or a sequence of levels.
      vtype: long-run-variance estimator for the indicator chain
        ("bm" default per FJN13; also "imse", "ipse", "iid").
    Returns:
      (est, se): arrays of shape (len(q), p) — or (p,) for scalar q.
    """
    cols = _columns(x)
    if pars is not None:
        cols = cols[:, pars]
    qs = np.atleast_1d(np.asarray(q, dtype=np.float64))
    assert np.all((qs > 0) & (qs < 1)), "quantile levels must be in (0, 1)"
    mcv = {"bm": mcvar_bm, "imse": mcvar_imse,
           "ipse": mcvar_ipse, "iid": mcvar_iid}[vtype]
    p = cols.shape[1]
    est = np.empty((qs.size, p))
    se = np.empty((qs.size, p))
    for j in range(p):
        col = cols[:, j]
        col = col[np.isfinite(col)]
        kw = dict(kwargs)
        if vtype == "bm" and "batchlen" not in kw:
            # FJN13 recommend b ~ sqrt(n); also keeps small chains valid
            kw["batchlen"] = max(1, int(np.sqrt(col.size)))
        for i, qq in enumerate(qs):
            xi = float(np.quantile(col, qq))
            f = _density_at(col, xi)
            ind = (col <= xi).astype(np.float64)
            # mcvar_* return Var(mean of indicators) = sigma^2(q)/n already
            v_ind = float(mcv(ind[:, None], **kw)[0])
            est[i, j] = xi
            se[i, j] = np.sqrt(v_ind) / f if f > 0 else np.nan
    if np.isscalar(q) or np.ndim(q) == 0:
        return est[0], se[0]
    return est, se
