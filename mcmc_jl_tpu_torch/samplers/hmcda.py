"""Initial step-size heuristic of adaptive HMC (port of
``find_reasonable_step`` from ``mcmc_jl_tpu/samplers/hmcda.py``; reference:
src/samplers/HMCDA.jl:51-69).  ``NUTS.init`` uses it; the ``HMCDA`` sampler
itself is ROADMAP queue 1 item 9.
"""
from __future__ import annotations

import torch

from .integrators import hamiltonian, leapfrog


def find_reasonable_step(model, pars, lp, grad, m, max_iter=100):
    """Doubling/halving heuristic for the initial step size (HMCDA.jl:51-69),
    bounded to ``max_iter`` iterations.

    Uses the acceptance-probability direction ``exp(H0 - H1)`` (as NUTS.jl
    72-82 and Algorithm 4 of Hoffman & Gelman do).  ``pars`` is (d,) or
    (C, d); each chain doubles or halves its own step until its probability
    crosses 1/2, the finished chains held still.  Draws nothing: the result
    is a power of two per chain, of shape ``pars.shape[:-1]``."""
    H0 = hamiltonian(lp, m)

    def accept_prob(eps):
        _, lp1, _, m1 = leapfrog(model, pars, m, grad, eps.unsqueeze(-1))
        p = torch.exp(H0 - hamiltonian(lp1, m1))
        return torch.where(torch.isnan(p), torch.zeros_like(p), p)

    eps = torch.ones(pars.shape[:-1], dtype=pars.dtype, device=pars.device)
    p = accept_prob(eps)
    a = torch.where(p > 0.5, 1.0, -1.0).to(pars.dtype)
    for _ in range(max_iter):
        active = p ** a > 2.0 ** (-a)
        if not bool(active.any()):
            break
        eps = torch.where(active, eps * 2.0 ** a, eps)
        p = torch.where(active, accept_prob(eps), p)
    return eps
