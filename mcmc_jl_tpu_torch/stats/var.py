"""Monte Carlo variance / standard error estimators.

Port surface of reference src/stats/var.jl: ``mcvar``/``mcse`` with
``vtype`` in {:iid, :bm, :imse, :ipse}.  The autocovariance feeding Geyer's
initial-sequence estimators is computed by FFT with ``torch.fft``
(:mod:`mcmc_jl_tpu_torch.ops.acf`); the short sequential truncation logic runs
host-side (it is O(maxlag) scalar work).

Estimator definitions (all per parameter column):
- iid:  var(x)/n                                         (var.jl:7-15)
- bm:   batch means, default batchlen=100                (var.jl:20-41)
- imse: Geyer initial monotone sequence                  (var.jl:45-91)
- ipse: Geyer initial positive sequence — identical but without the
        monotonization pass                              (var.jl:95-132)

Port of ``mcmc_jl_tpu/stats/var.py``: host-side numpy, as there."""
from __future__ import annotations

import numpy as np

from ..core.chain import MCMCChain
from ..ops.acf import autocov

VTYPES = ("bm", "iid", "imse", "ipse")


def _columns(x):
    """Chain/Table/array -> 2-D numpy array (n, p)."""
    if isinstance(x, MCMCChain):
        x = x.samples.values
    if hasattr(x, "values") and not isinstance(x, np.ndarray):
        x = x.values
    x = np.asarray(x, dtype=np.float64)
    if x.ndim == 1:
        x = x[:, None]
    return x


def mcvar_iid(x, pars=None):
    x = _columns(x)
    if pars is not None:
        x = x[:, pars]
    n = x.shape[0]
    return np.var(x, axis=0, ddof=1) / n


def mcse_iid(x, pars=None):
    return np.sqrt(mcvar_iid(x, pars))


def mcvar_bm(x, pars=None, batchlen: int = 100):
    x = _columns(x)
    if pars is not None:
        x = x[:, pars]
    n = x.shape[0]
    nbatches = n // batchlen
    assert nbatches > 1, (
        "Choose batch size such that the number of batches is greater than one"
    )
    nbsamples = nbatches * batchlen
    bm = x[:nbsamples].reshape(nbatches, batchlen, -1).mean(axis=1)
    return batchlen * np.var(bm, axis=0, ddof=1) / nbsamples


def mcse_bm(x, pars=None, batchlen: int = 100):
    return np.sqrt(mcvar_bm(x, pars, batchlen=batchlen))


def _geyer(x, maxlag=None, monotone=True):
    """Shared IMSE/IPSE core (var.jl:45-91 vs 95-132: the only difference is
    the monotonization), over every column at once: the pair sums
    ``g_j = acv_2j + acv_2j+1`` up to the first that is not positive, made
    non-increasing by a running minimum (IMSE)."""
    x = _columns(x)
    n, p = x.shape
    if maxlag is None:
        maxlag = n - 1
    acv = autocov(x, maxlag).numpy()  # (maxlag+1, p)
    k = int(np.floor((maxlag - 1) / 2))
    g = acv[0:2 * k + 1:2] + acv[1:2 * k + 2:2]  # (k+1, p)
    pos = g > 0
    # m: the number of leading positive pair sums in each column (none for a
    # single row, maxlag 0)
    m = (np.where(pos.all(axis=0), k + 1, np.argmin(pos, axis=0))
         if k >= 0 else np.zeros(p, dtype=int))
    if monotone:
        g = np.minimum.accumulate(g, axis=0)
    keep = np.arange(k + 1)[:, None] < m[None, :]
    v = (-acv[0] + 2 * np.where(keep, g, 0.0).sum(axis=0)) / n
    # Antithetic chains (pair sum Gamma_0 <= 0) can drive the estimate
    # negative — the reference's identical formula would report negative
    # variance/ESS there (var.jl:45-91 has no guard).  Floor it so that
    # ESS <= n*log10(n), the usual super-efficiency cap (cf. Stan).
    floor = acv[0] / (n * max(np.log10(max(n, 10)), 1.0))
    return np.maximum(v, floor)


def mcvar_imse(x, pars=None, maxlag=None):
    x = _columns(x)
    if pars is not None:
        x = x[:, pars]
    return _geyer(x, maxlag=maxlag, monotone=True)


def mcse_imse(x, pars=None, maxlag=None):
    return np.sqrt(mcvar_imse(x, pars, maxlag=maxlag))


def mcvar_ipse(x, pars=None, maxlag=None):
    x = _columns(x)
    if pars is not None:
        x = x[:, pars]
    return _geyer(x, maxlag=maxlag, monotone=False)


def mcse_ipse(x, pars=None, maxlag=None):
    return np.sqrt(mcvar_ipse(x, pars, maxlag=maxlag))


def mcvar(c, pars=None, vtype: str = "imse", **kwargs):
    """Dispatcher mirroring reference ``var(c; vtype=...)`` (var.jl:140-155)."""
    assert vtype in VTYPES, f"Unknown variance type {vtype}"
    if vtype == "bm":
        return mcvar_bm(c, pars, **kwargs)
    if vtype == "iid":
        return mcvar_iid(c, pars)
    if vtype == "imse":
        return mcvar_imse(c, pars, **kwargs)
    return mcvar_ipse(c, pars, **kwargs)


def mcse(c, pars=None, vtype: str = "imse", **kwargs):
    assert vtype in VTYPES, f"Unknown standard error type {vtype}"
    return np.sqrt(mcvar(c, pars, vtype=vtype, **kwargs))


# `var`/`std` names shadow numpy's on chains, as the reference extends
# Base.var/Base.std (var.jl:1)
var = mcvar
std = mcse
