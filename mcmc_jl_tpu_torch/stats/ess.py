"""Effective sample size and integrated autocorrelation time
(reference: src/stats/ess.jl).

``ess = n * var_iid / var_vtype``; ``actime = var_vtype / var_iid``,
with vtype in {bm, imse, ipse}.

Port of ``mcmc_jl_tpu/stats/ess.py``: host-side numpy, as there."""
from __future__ import annotations

from .var import _columns, mcvar, mcvar_iid

ACTYPES = ("bm", "imse", "ipse")


def ess(c, pars=None, vtype: str = "imse", **kwargs):
    assert vtype in ACTYPES, f"Unknown ESS type {vtype}"
    x = _columns(c)
    n = x.shape[0]
    return n * mcvar_iid(x, pars) / mcvar(x, pars, vtype=vtype, **kwargs)


def actime(c, pars=None, vtype: str = "imse", **kwargs):
    assert vtype in ACTYPES, f"Unknown integrated autocorrelation time type {vtype}"
    x = _columns(c)
    return mcvar(x, pars, vtype=vtype, **kwargs) / mcvar_iid(x, pars)
