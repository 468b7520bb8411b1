"""Acceptance rate and chain summary (reference: src/stats/summary.jl).

Port of ``mcmc_jl_tpu/stats/summary.py``: host-side numpy, as there."""
from __future__ import annotations

import sys

import numpy as np

from ..core.chain import MCMCChain
from .var import _columns, mcvar_imse


def acceptance(c: MCMCChain, lags=None, reject: bool = False):
    """Acceptance (or rejection) percentage from the ``accept`` diagnostic
    (summary.jl:6-15)."""
    acc = np.asarray(c.diagnostics["accept"], dtype=np.float64)
    if lags is None:
        lags = slice(None)
        rlen = acc.shape[0]
    else:
        lags = np.asarray(lags)
        assert lags.max() < acc.shape[0] + 1, (
            "Range of acceptance rate not within post-burnin range of MCMC chain"
        )
        lags = lags - 1  # reference lags are 1-based row indices
        rlen = lags.shape[0]
    s = acc[lags].sum()
    if reject:
        return (rlen - s) * 100.0 / rlen
    return s * 100.0 / rlen


def describe(c: MCMCChain, io=None, quantiles=(0.025, 0.25, 0.5, 0.75, 0.975)):
    """Per-column Min/Mean/Max/MC Error/ESS/AC Time/NAs report matching the
    reference's output format (summary.jl:24-55, README.md:127-156), plus
    MCMC quantile estimates with MC standard errors — the reference's own
    TODO (summary.jl:17-18, Flegal-Jones-Neath 2013).  Pass
    ``quantiles=()`` for the reference's exact field set."""
    from .quantile import mcmc_quantile

    io = io or sys.stdout
    x = _columns(c)
    nrows = x.shape[0]
    for i, name in enumerate(c.samples.columns):
        col = x[:, i]
        print(name, file=io)
        nas = int(np.sum(~np.isfinite(col)))
        filtered = col[np.isfinite(col)]
        if filtered.size == 0:
            # the reference `return`s here (summary.jl:31-33), silently
            # truncating the report; we keep summarizing the other columns
            print(f"{name} * All NA * ", file=io)
            continue
        varimse = float(mcvar_imse(filtered[:, None])[0])
        variid = float(np.var(filtered, ddof=1) / nrows)
        stats = [
            ("Min", float(np.min(filtered))),
            ("Mean", float(np.mean(filtered))),
            ("Max", float(np.max(filtered))),
            ("MC Error", float(np.sqrt(varimse))),
            ("ESS", nrows * variid / varimse),
            ("AC Time", varimse / variid),
        ]
        for sname, sval in stats:
            print(f"{sname:<10} {sval}", file=io)
        if quantiles:
            qest, qse = mcmc_quantile(filtered[:, None], list(quantiles))
            for q, e, s in zip(quantiles, qest[:, 0], qse[:, 0]):
                label = f"Q{100 * q:g}%"
                print(f"{label:<10} {e} (MCSE {s:.6g})", file=io)
        print(f"NAs        {nas}", file=io)
        print(f"NA%        {round(nas * 100 / len(col), 2)}%", file=io)
        print(file=io)


def wsample(values, weights, n, seed=0):
    """Weighted resample with replacement (the reference README's
    ``wsample(chain.samples["x"], chain.diagnostics["weigths"], 1000)``
    post-processing of SeqMC output, README.md:272)."""
    rng = np.random.default_rng(seed)
    values = np.asarray(values)
    w = np.asarray(weights, dtype=np.float64)
    p = w / w.sum()
    idx = rng.choice(len(values), size=n, replace=True, p=p)
    return values[idx]
