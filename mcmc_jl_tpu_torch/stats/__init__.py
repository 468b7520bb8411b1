"""Output analysis layer (port of ``mcmc_jl_tpu/stats/``: the estimators the
main path reports, and the cross-chain diagnostics)."""
from .mean import mean, mean_rb
from .var import mcvar, mcse, var, std, mcvar_iid, mcvar_bm, mcvar_imse, mcvar_ipse
from .ess import ess, actime
from .summary import acceptance, describe, wsample
from .quantile import mcmc_quantile
from .multichain import rhat, ess_pooled, summarize_chains

__all__ = [
    "mean", "mean_rb", "mcvar", "mcse", "var", "std",
    "mcvar_iid", "mcvar_bm", "mcvar_imse", "mcvar_ipse",
    "ess", "actime", "acceptance", "describe", "wsample", "mcmc_quantile",
    "rhat", "ess_pooled", "summarize_chains",
]
