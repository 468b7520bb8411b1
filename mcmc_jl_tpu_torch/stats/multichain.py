"""Cross-chain diagnostics (port of ``mcmc_jl_tpu/stats/multichain.py``).

The reference is single-chain only (its prun chains never interact and its
stats take one MCMCChain).  With thousands of chains on a leading
dimension, cross-chain diagnostics are natural:

- :func:`rhat` — split-chain potential scale reduction (Gelman-Rubin);
  ``method="rank"`` gives the rank-normalized bulk/tail R-hat of Vehtari,
  Gelman, Simpson, Carpenter & Bürkner (2021), robust to heavy tails and
  nonstationary variance where classic split-R-hat is blind;
- :func:`ess_pooled` — rank-free pooled ESS: per-chain Geyer ESS summed;
- :func:`summarize_chains` — one host-side report for a (steps, chains, d)
  sample block, e.g. the ``ppars`` of
  :func:`mcmc_jl_tpu_torch.parallel.pchains.run_chains`.

Host-side float64 numpy, as in the JAX package; the normal quantile is
``torch.special.ndtri``.
"""
from __future__ import annotations

import numpy as np
import torch

from .var import mcvar_iid, mcvar_imse


def _as_block(x):
    """A (steps, chains, d) float64 array from an array, a tensor or a
    run_chains infos dict."""
    if isinstance(x, dict):
        x = x["ppars"]
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    x = np.asarray(x, dtype=np.float64)
    if x.ndim != 3:
        raise ValueError(f"expected (steps, chains, d), got {x.shape}")
    return x


def _rhat_of(x):
    n = x.shape[0]
    W = x.var(axis=0, ddof=1).mean(axis=0)  # (d,)
    B = n * x.mean(axis=0).var(axis=0, ddof=1)  # (d,)
    return np.sqrt(((n - 1) / n * W + B / n) / W)


def _split_rhat(x):
    n = x.shape[0]
    if n >= 2:
        half = n // 2
        x = np.concatenate([x[:half], x[half:2 * half]], axis=1)
    return _rhat_of(x)


def _rank_normalize(x):
    """Fractional ranks over all draws -> normal scores (Vehtari 2021 eq. 14:
    z = Phi^-1((r - 3/8) / (S + 1/4)))."""
    n, m, d = x.shape
    flat = x.reshape(n * m, d)
    # ordinal ranks: the inverse permutation of one argsort per column
    order = np.argsort(flat, axis=0)
    r = np.empty(flat.shape)
    np.put_along_axis(r, order, np.arange(1.0, n * m + 1)[:, None], axis=0)
    z = torch.special.ndtri(torch.from_numpy((r - 0.375) / (n * m + 0.25)))
    return z.numpy().reshape(n, m, d)


def rhat(x, split: bool = True, method: str = "split"):
    """R-hat per parameter for a (steps, chains, d) block.

    ``method="split"`` — classic split-chain Gelman-Rubin.
    ``method="rank"`` — max(bulk, tail) rank-normalized split-R-hat
    (Vehtari et al. 2021): bulk = split-R-hat of the rank-normal scores;
    tail = the same on the folded draws ``|x - median|``.  ``split=False``
    gives the unsplit classic R-hat."""
    x = _as_block(x)
    if method not in ("split", "rank"):
        raise ValueError(f"unknown method {method!r}")
    if not split:
        if method != "split":
            raise ValueError("method='rank' implies split chains")
        return _rhat_of(x)
    if method == "split":
        return _split_rhat(x)
    bulk = _split_rhat(_rank_normalize(x))
    folded = np.abs(x - np.median(x.reshape(-1, x.shape[2]), axis=0))
    tail = _split_rhat(_rank_normalize(folded))
    return np.maximum(bulk, tail)


def ess_pooled(x):
    """Sum of per-chain Geyer-IMSE ESS, per parameter (every chain's
    columns in one estimator call)."""
    x = _as_block(x)
    n, m, d = x.shape
    cols = x.reshape(n, m * d)
    return (n * mcvar_iid(cols) / mcvar_imse(cols)).reshape(m, d).sum(axis=0)


def summarize_chains(x, param_names=None):
    """Host-side cross-chain report per parameter: mean, sd, MCSE, pooled
    ESS, split R-hat and rank R-hat."""
    x = _as_block(x)
    n, m, d = x.shape
    names = param_names or [f"pars.{i + 1}" for i in range(d)]
    flat = x.reshape(n * m, d)
    ess = ess_pooled(x)
    r_split, r_rank = rhat(x), rhat(x, method="rank")
    rep = {}
    for i, name in enumerate(names):
        sd = float(flat[:, i].std(ddof=1))
        rep[name] = {
            "mean": float(flat[:, i].mean()),
            "sd": sd,
            "mcse": float(sd / np.sqrt(max(ess[i], 1.0))),
            "ess": float(ess[i]),
            "rhat": float(r_split[i]),
            "rhat_rank": float(r_rank[i]),
        }
    return rep
