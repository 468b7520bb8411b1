"""Chain mean estimators (reference: src/stats/mean.jl; port of
``mcmc_jl_tpu/stats/mean.py``).

``mean``: column means.  ``mean_rb``: Rao-Blackwellized HMC mean — weights
every stored leapfrog state by ``exp(H_1 - H_j)`` (mean.jl:11-37), using the
trajectories recorded by ``HMC(storeLeaps=true)`` (HMC.jl:144-151).
"""
from __future__ import annotations

import numpy as np

from ..core.chain import MCMCChain
from .var import _columns


def mean(c, pars=None):
    x = _columns(c)
    if pars is not None:
        x = x[:, pars]
    return np.mean(x, axis=0)


def mean_rb(c: MCMCChain, pars=None, method: str = "hmc"):
    """Rao-Blackwell mean over stored leapfrog trajectories.

    HMC records trajectories as stacked arrays
    ``diagnostics["leaps_pars"]`` (nsamples, nleaps+1, npars) and
    ``diagnostics["leaps_H"]`` (nsamples, nleaps+1) — shape-static scan
    buffers replacing the reference's arrays-of-HMCSample (SURVEY §5).
    """
    assert method == "hmc", f"unknown RB method {method}"
    assert "leaps_pars" in c.diagnostics, (
        "mean_rb requires a chain run with HMC(store_leaps=True)"
    )
    leaps = np.asarray(c.diagnostics["leaps_pars"], dtype=np.float64)
    H = np.asarray(c.diagnostics["leaps_H"], dtype=np.float64)
    nsamples, nstates, npars = leaps.shape
    nleaps = nstates - 1

    # w[i, j] = exp(H_1 - H_{j+1}) (mean.jl:17-21)
    w = np.exp(H[:, :1] - H[:, 1:])  # (nsamples, nleaps)
    x = _columns(c)
    if "leaps_n" in c.diagnostics:
        # tuner-adapted trajectories: rows j >= nl are frozen endpoint
        # copies (shape-static scan buffers) — mask them so the estimator
        # matches the reference's equal-state average over live leaps
        nl = np.asarray(c.diagnostics["leaps_n"], dtype=np.int64)
        mask = np.arange(nleaps)[None, :] < nl[:, None]
        w = w * mask
        denom = (nl + 1.0)[:, None]
    else:
        denom = float(nleaps + 1)
    sums = (x + np.einsum("ij,ijk->ik", w, leaps[:, 1:, :])) / denom
    res = np.mean(sums, axis=0)
    if pars is not None:
        res = res[pars]
    return res
