"""WALNUTS — within-orbit adaptive leapfrog NUTS (port of
``mcmc_jl_tpu/samplers/walnuts.py``; Bou-Rabee, Carpenter et al.,
arXiv:2506.18746).

Each *macro* leapfrog step of size ``h`` on the orbit grid is integrated
with ``2^l`` micro leapfrog steps of size ``h / 2^l``, where ``l`` is the
smallest value up to ``max_halvings`` whose micro-path energy range
``max_k H(z_k) - min_k H(z_k) <= delta`` (the last level is taken anyway,
marked bad if it fails).  The selection is reversible unless a coarser
``l' < l`` passes from the flipped endpoint; such a macro step is marked
``bad`` and treated like a divergence (its subtree is invalidated), which
keeps detailed balance (see the JAX package's module docstring).  Dual
averaging adapts ``h`` on the share of macro steps run un-halved
(``_adapt_stat = "halvings"``); ``info["irreversible"]`` counts the subtrees
that died to an irreversible step.

Chains choose different ``l``: the levels run as a loop over
``l = 0..max_halvings`` while a chain is undecided (one batched gradient
call per micro step, masks per chain), and the reverse check as a loop over
the coarser levels while a chain needs it.  Only the chains still building
their subtree take part in those decisions.  WALNUTS always runs on the generic
engine: the NUTS kernels integrate fixed-step orbits.
"""
from __future__ import annotations

import dataclasses

import torch

from .integrators import hamiltonian
from .nuts import NUTS


def _integrate(model, pars, lp, m, grad, n, eps):
    """``n`` leapfrogs at step ``eps`` (k, 1) from (pars, lp, m, grad), for
    k chains; returns the endpoint and each chain's energy range over the
    path including the start (a NaN energy anywhere makes it inf, so the
    tolerance fails, as the JAX package's running min/max does).  Each
    micro step is the leapfrog of samplers/integrators.py in three fused
    multiply-adds around one gradient call; the path's energies are taken
    once at the end, from its stacked states."""
    half = 0.5 * eps
    lps, ms = [lp], [m]
    for _ in range(n):
        m = torch.addcmul(m, half, grad)
        pars = torch.addcmul(pars, eps, m)
        lp, grad = model.evalallg(pars)
        m = torch.addcmul(m, half, grad)
        lps.append(lp)
        ms.append(m)
    H = hamiltonian(torch.stack(lps), torch.stack(ms))
    rng = torch.where(torch.isnan(H).any(0), torch.inf,
                      H.amax(0) - H.amin(0))
    return pars, lp, grad, m, rng


@dataclasses.dataclass(frozen=True, repr=False)
class WALNUTS(NUTS):
    #: micro-path energy-range tolerance per macro step
    delta: float = 0.5
    #: maximum step halvings: micro step down to h / 2^max_halvings
    max_halvings: int = 4

    needs_gradient = True
    #: dual averaging regulates eps so ~70% of macro steps run un-halved
    #: (the H-G accept statistic is blind here: micro adaptation keeps
    #: exp(H0-H) near 1 at any macro step, so it would inflate eps forever)
    _adapt_stat = "halvings"

    def __post_init__(self):
        super().__post_init__()
        assert self.delta > 0, "energy tolerance delta must be > 0"
        assert 0 <= self.max_halvings < 10, "max_halvings must be in [0, 10)"

    def _leaf_advance(self, model, pars, lp, m, grad, eps_signed, generator,
                      active=None):
        """One adaptive macro step of size ``eps_signed`` (C, 1) for the
        ``active`` chains (all by default): returns (pars, lp, grad, m, bad,
        halved), per chain.  Every micro step is one batched gradient call
        over all C chains (the model may carry per-chain state, as the
        mass-adapted z-space model does); the levels run while an active
        chain is undecided, and the other chains' results are discarded by
        the caller.  The selection draws nothing."""
        new_pars, new_lp, new_grad, new_m, bad, sel_l = self._walk(
            model, pars, lp, m, grad, eps_signed, active)
        return new_pars, new_lp, new_grad, new_m, bad, sel_l > 0

    def _walk(self, model, pars, lp, m, grad, eps_signed, active=None):
        """The macro step with its chosen level: (pars, lp, grad, m, bad,
        sel_l), each per chain; inactive chains come back neither bad nor
        halved (with level 0's endpoint, which the caller discards)."""
        L = self.max_halvings
        C = pars.shape[0]
        dev = pars.device
        eps_signed = eps_signed.expand(C, 1)
        if active is None:
            active = torch.ones(C, dtype=torch.bool, device=dev)
        sel_l = torch.zeros(C, dtype=torch.int32, device=dev)
        tol_ok = ~active
        done = ~active

        # forward: the smallest passing l, the last one taken regardless;
        # each level's endpoints are kept, and each chain's chosen once
        ends = []
        for lvl in range(L + 1):
            if bool(done.all()):
                break
            n = 1 << lvl
            new = _integrate(model, pars, lp, m, grad, n, eps_signed / n)
            ends.append(new[:4])
            ok = new[4] <= self.delta
            take = ~done & (ok | (lvl >= L))
            sel_l = torch.where(take, lvl, sel_l)
            tol_ok = torch.where(take, ok, tol_ok)
            done = done | take
        if not ends:  # no active chain
            no = torch.zeros(C, dtype=torch.bool, device=dev)
            return pars, lp, grad, m, no, sel_l
        rows = torch.arange(C, device=dev)
        new_pars, new_lp, new_grad, new_m = (
            torch.stack(v)[sel_l, rows] for v in zip(*ends))

        # reverse check: does a coarser l' < sel_l pass from the flipped
        # endpoint?  (l' == sel_l retraces the same micro states and passes
        # by symmetry.)  A failed tolerance is bad already.
        coarser_ok = torch.zeros(C, dtype=torch.bool, device=dev)
        for lvl in range(L):
            need = active & tol_ok & ~coarser_ok & (sel_l > lvl)
            if not bool(need.any()):
                break
            n = 1 << lvl
            rng = _integrate(model, new_pars, new_lp, -new_m, new_grad, n,
                             eps_signed / n)[4]
            coarser_ok = coarser_ok | (need & (rng <= self.delta))
        bad = ~tol_ok | coarser_ok
        return new_pars, new_lp, new_grad, new_m, bad, sel_l
