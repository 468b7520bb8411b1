"""Output analysis layer (port of ``mcmc_jl_tpu/stats/``: the estimators the
main path reports, the cross-chain diagnostics, the zero-variance
estimators, the information criteria and the evidence estimators)."""
from .mean import mean, mean_rb
from .var import mcvar, mcse, var, std, mcvar_iid, mcvar_bm, mcvar_imse, mcvar_ipse
from .ess import ess, actime
from .summary import acceptance, describe, wsample
from .quantile import mcmc_quantile
from .zv import linear_zv, quadratic_zv, linearZv, quadraticZv
from .multichain import rhat, ess_pooled, summarize_chains
from .evidence import logz_ti, logz_ss
from .ic import pointwise_loglik, waic, psis_loo, compare

__all__ = [
    "mean", "mean_rb", "mcvar", "mcse", "var", "std",
    "mcvar_iid", "mcvar_bm", "mcvar_imse", "mcvar_ipse",
    "ess", "actime", "acceptance", "describe", "wsample", "mcmc_quantile",
    "linear_zv", "quadratic_zv", "linearZv", "quadraticZv",
    "rhat", "ess_pooled", "summarize_chains",
    "logz_ti", "logz_ss",
    "pointwise_loglik", "waic", "psis_loo", "compare",
]
