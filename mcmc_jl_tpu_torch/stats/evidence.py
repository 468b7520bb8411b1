"""Marginal-likelihood (log-evidence) estimators from power-posterior runs
(port of ``mcmc_jl_tpu/stats/evidence.py``).

They take the per-rung log-likelihood draws ``ll[t, k]`` from the power
posteriors ``p_k(theta) ∝ prior(theta) * lik(theta)^beta_k`` as a
(steps, K) array with its ``betas``, or a chain whose diagnostics hold
``replica_ll`` and ``betas`` (the prior-tempered ladder of
``PTMC(logprior=...)``; a chain without them raises ``ValueError``).

- :func:`logz_ti` — thermodynamic integration with the variance-corrected
  trapezoid of Friel & Pettitt (2008) / Friel, Hurn & Wyse (2014):
  ``log Z ≈ Σ Δβ (m_k + m_{k+1})/2 − Δβ² (v_{k+1} − v_k)/12``.
- :func:`logz_ss` — stepping-stone sampling (Xie et al. 2011):
  ``log Z = Σ_k log (1/n) Σ_t exp((β_{k+1} − β_k) ll[t, k])``, which needs
  ``β_0 = 0``.

Host-side numpy, as in the JAX package.
"""
from __future__ import annotations

import numpy as np


def _ll_betas(chain_or_ll, betas, burnin):
    if betas is None:
        d = chain_or_ll.diagnostics
        if "replica_ll" not in d or "betas" not in d:
            raise ValueError(
                "chain has no replica_ll/betas diagnostics — run it with "
                "PTMC(logprior=...)")
        ll, betas = d["replica_ll"], d["betas"]
    else:
        ll = chain_or_ll
    ll = np.asarray(ll, dtype=np.float64)
    betas = np.asarray(betas, dtype=np.float64)
    assert ll.ndim == 2 and ll.shape[1] == betas.shape[0], (
        f"ll {ll.shape} vs betas {betas.shape}")
    assert 0 <= burnin < ll.shape[0]
    return ll[burnin:], betas


def logz_ti(chain_or_ll, betas=None, burnin=0):
    """Thermodynamic-integration log-evidence (corrected trapezoid) from a
    (steps, K) array of per-rung log-likelihood draws and its ``betas``
    (or a chain carrying both); ``burnin`` rows are dropped first.  The
    ladder should start at beta = 0: the integral over [0, beta_0) is not
    counted."""
    ll, betas = _ll_betas(chain_or_ll, betas, burnin)
    m = ll.mean(axis=0)
    v = ll.var(axis=0)
    db = np.diff(betas)
    return float(np.sum(db * (m[1:] + m[:-1]) / 2.0)
                 - np.sum(db ** 2 * (v[1:] - v[:-1]) / 12.0))


def logz_ss(chain_or_ll, betas=None, burnin=0):
    """Stepping-stone log-evidence: draws from rung k bridge beta_k to
    beta_{k+1}; needs beta_0 = 0 for the product to telescope to Z."""
    ll, betas = _ll_betas(chain_or_ll, betas, burnin)
    if betas[0] != 0.0:
        raise ValueError(
            "stepping-stone needs beta_0 = 0 (draws from the prior); "
            f"got beta_0 = {betas[0]}")
    db = np.diff(betas)
    # log-mean-exp per stone, stabilized by the max
    w = db[None, :] * ll[:, :-1]
    mx = w.max(axis=0)
    return float(np.sum(mx + np.log(np.mean(np.exp(w - mx), axis=0))))
