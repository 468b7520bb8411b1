"""Predictive information criteria: WAIC and PSIS-LOO cross-validation
(port of ``mcmc_jl_tpu/stats/ic.py``).

Inputs are a pointwise log-likelihood matrix ``ll[s, n]`` (S posterior
draws x N observations).  :func:`pointwise_loglik` builds it on the device
by mapping a user ``loglik_pw(theta) -> (N,)`` over the kept draws with
``torch.func.vmap``; the criteria themselves are host-side numpy in
float64, summed in the JAX package's order.

- :func:`waic` — Watanabe-Akaike information criterion (Watanabe 2010;
  Gelman, Hwang & Vehtari 2014): ``elpd_waic = lpd - p_waic`` with
  ``p_waic = sum_n Var_s[ll[s, n]]``.
- :func:`psis_loo` — Pareto-smoothed importance-sampling leave-one-out CV
  (Vehtari, Gelman & Gabry 2017): the upper tail of the raw ratios
  ``w_s ∝ 1/p(y_n|theta_s)`` is replaced by quantiles of a generalized
  Pareto distribution fit by the Zhang & Stephens (2009) empirical-Bayes
  method; the per-observation shape ``k̂`` flags unreliable observations
  above 0.7.
- :func:`compare` — rank models by elpd with pairwise-difference SEs.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["pointwise_loglik", "waic", "psis_loo", "compare"]


def pointwise_loglik(loglik_pw, samples, device=None):
    """(S, d) posterior draws -> (S, N) pointwise log-lik matrix (numpy).

    ``loglik_pw(theta) -> (N,)`` returns the per-observation log-likelihood
    contributions (not their sum) for one draw; it is mapped over the draws
    with ``torch.func.vmap`` on the device of ``samples`` when they are a
    tensor, else on ``device`` (the CUDA card by default; pass
    ``device="cpu"`` for the CPU).  Numpy draws keep their dtype."""
    if not isinstance(samples, torch.Tensor):
        from ..models.model import resolve_device

        samples = torch.as_tensor(np.asarray(samples),
                                  device=resolve_device(device))
    with torch.no_grad():
        ll = torch.func.vmap(loglik_pw)(samples)
    return ll.cpu().numpy()


def _logsumexp(a, axis=0):
    m = np.max(a, axis=axis, keepdims=True)
    return (m + np.log(np.sum(np.exp(a - m), axis=axis,
                              keepdims=True))).squeeze(axis)


def waic(ll):
    """WAIC from an (S, N) pointwise log-lik matrix: a dict of elpd_waic,
    p_waic, waic (= -2 elpd), se (of elpd) and the per-observation elpd_i
    vector ``pointwise``."""
    ll = np.asarray(ll, dtype=np.float64)
    S, N = ll.shape
    lpd_i = _logsumexp(ll, axis=0) - np.log(S)  # log mean_s exp(ll)
    p_i = np.var(ll, axis=0, ddof=1)  # posterior var of ll
    elpd_i = lpd_i - p_i
    return {
        "elpd_waic": float(np.sum(elpd_i)),
        "p_waic": float(np.sum(p_i)),
        "waic": float(-2.0 * np.sum(elpd_i)),
        "se": float(np.sqrt(N * np.var(elpd_i, ddof=1))),
        "pointwise": elpd_i,
    }


def _gpd_fit(x):
    """Zhang & Stephens (2009) empirical-Bayes GPD fit to exceedances ``x``
    (ascending).  Returns (khat, sigma) in the Vehtari-2017 sign convention
    (khat > 0 = heavy tail)."""
    n = x.size
    prior_bs, prior_k = 3.0, 10.0
    m = 30 + int(np.sqrt(n))
    jj = np.arange(1, m + 1, dtype=np.float64)
    xstar = x[int(n / 4 + 0.5) - 1]
    if not (xstar > 0 and x[-1] > 0):  # ties at the cutoff: no fit possible
        return np.nan, np.nan
    b = 1.0 / x[-1] + (1.0 - np.sqrt(m / (jj - 0.5))) / (prior_bs * xstar)
    # profile MLE: given b = -xi/sigma, xi_hat(b) = mean log(1 - b x)
    k_b = np.mean(np.log1p(-b[:, None] * x[None, :]), axis=1)
    log_lik = n * (np.log(-b / k_b) - k_b - 1.0)
    w = np.exp(log_lik - np.max(log_lik))  # stable profile-lik weights
    b_post = float(np.sum(b * w / np.sum(w)))
    khat = float(np.mean(np.log1p(-b_post * x)))
    sigma = -khat / b_post
    # weakly-informative regularization toward k=0.5 (Vehtari et al. app. C)
    khat = (n * khat + prior_k * 0.5) / (n + prior_k)
    return khat, sigma


def _gpd_quantiles(p, khat, sigma):
    """Inverse CDF of GPD(k, sigma) at probabilities p (location 0)."""
    if abs(khat) < 1e-12:
        return -sigma * np.log1p(-p)
    return sigma * np.expm1(-khat * np.log1p(-p)) / khat


def _psis_smooth_column(logw, S):
    """Pareto-smooth one observation's log-weights in place; return khat."""
    M = int(min(0.2 * S, 3.0 * np.sqrt(S)))
    if M < 5:
        return -np.inf  # too few draws to fit a tail; raw IS
    order = np.argsort(logw)
    tail_idx = order[-M:]
    cutoff = logw[order[-M - 1]]
    exceed = np.expm1(logw[tail_idx] - cutoff) * np.exp(cutoff)
    srt = np.argsort(exceed)
    x = exceed[srt]
    if x[-1] <= 0 or np.allclose(x[-1], 0.0):
        return -np.inf
    khat, sigma = _gpd_fit(x)
    if not np.isfinite(khat):
        return -np.inf  # degenerate tail: keep raw weights
    if sigma > 0:
        qq = _gpd_quantiles((np.arange(1, M + 1) - 0.5) / M, khat, sigma)
        smoothed = np.log(qq + np.exp(cutoff))
        # order statistics replace the sorted tail; cap at the raw max
        logw[tail_idx[srt]] = np.minimum(smoothed, logw[order[-1]])
    return khat


def psis_loo(ll):
    """PSIS-LOO from an (S, N) pointwise log-lik matrix: a dict of elpd_loo,
    p_loo, looic (= -2 elpd), se, the per-observation elpd_i
    ``pointwise`` and ``pareto_k`` (k̂ per observation; above 0.7 the
    observation's estimate is unreliable)."""
    ll = np.asarray(ll, dtype=np.float64)
    S, N = ll.shape
    lpd_i = _logsumexp(ll, axis=0) - np.log(S)
    elpd_i = np.empty(N)
    khats = np.empty(N)
    for nn in range(N):
        logw = -ll[:, nn]  # IS ratios 1/p(y_n|theta_s)
        logw = logw - np.max(logw)
        khats[nn] = _psis_smooth_column(logw, S)
        # elpd_i = log( sum_s w_s p(y|theta_s) / sum_s w_s )
        elpd_i[nn] = _logsumexp(logw + ll[:, nn]) - _logsumexp(logw)
    return {
        "elpd_loo": float(np.sum(elpd_i)),
        "p_loo": float(np.sum(lpd_i - elpd_i)),
        "looic": float(-2.0 * np.sum(elpd_i)),
        "se": float(np.sqrt(N * np.var(elpd_i, ddof=1))),
        "pointwise": elpd_i,
        "pareto_k": khats,
    }


def compare(results):
    """Rank models by elpd.  ``results`` maps name -> waic()/psis_loo() dict.

    Returns a list of (name, elpd, d_elpd, d_se) sorted best-first, where
    d_elpd is the elpd difference to the best model and d_se its paired SE
    (from the pointwise differences, Vehtari et al. 2017 §5.2)."""
    def _elpd(r):
        return r.get("elpd_loo", r.get("elpd_waic"))

    names = sorted(results, key=lambda k: -_elpd(results[k]))
    best = results[names[0]]["pointwise"]
    out = []
    for name in names:
        d = best - results[name]["pointwise"]
        d_se = float(np.sqrt(d.size * np.var(d, ddof=1)))
        out.append((name, float(_elpd(results[name])), float(np.sum(d)),
                    d_se))
    return out
