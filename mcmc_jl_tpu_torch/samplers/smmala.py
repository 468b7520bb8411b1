"""Simplified manifold MALA (port of ``mcmc_jl_tpu/samplers/smmala.py``;
reference: src/samplers/SMMALA.jl).

Drift ``(eps/2) G^{-1} grad``, proposal covariance ``eps G^{-1}``,
position-dependent q-ratio with log-det terms (SMMALA.jl:81-100).  Requires
gradient + metric tensor.

The current point's Cholesky factor and drift are carried in the state (they
were computed when that point was the proposal), so a transition takes one
``evalallt`` and one batched Cholesky of the proposed ``G`` plus triangular
solves:

- drift       ``G^{-1} grad = L^{-T} L^{-1} grad``   (two triangular solves)
- sampling    ``x ~ N(0, G^{-1})``: ``x = L^{-T} z`` (one triangular solve)
- q-density   ``diff' G diff = ||L' diff||^2`` and
  ``log det(eps G^{-1}) = d log eps - 2 sum log diag L`` (the common
  ``d/2 log eps`` term cancels between the two densities and is dropped)

Chains sit on a leading dimension: ``G`` is (C, d, d) and every
factorization is one batched call.  A metric that is not positive definite
gives a factor of NaN (``cholesky_ex``, no error check and no host sync), as
``jnp.linalg.cholesky`` does, so the chain rejects.  On a float32 catalog
model on the card every gradient is one launch of the custom-target
gradient pass.  ``step`` draws; ``move`` is the transition given its draws.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .base import (
    EmpMCTuner, RunCtx, Sampler, TuneState, accept_given, state_dataclass,
    tuner_init, tuner_update,
)


@state_dataclass
class SMMALAState:
    pars: torch.Tensor
    logtarget: torch.Tensor
    grad: torch.Tensor
    chol: torch.Tensor  # lower Cholesky factor of G(pars)
    drift: torch.Tensor  # G(pars)^{-1} grad
    tune: TuneState
    i: torch.Tensor


# -- batched linear algebra of the manifold family -------------------------


def cholesky(G):
    """Lower Cholesky factor of the symmetrized ``G`` (..., d, d), as
    ``jnp.linalg.cholesky``; where ``G`` is not positive definite, NaN on
    and below the diagonal."""
    L, info = torch.linalg.cholesky_ex(0.5 * (G + G.mT))
    return torch.where((info != 0)[..., None, None],
                       torch.full_like(L, torch.nan).tril(), L)


def solve(A, b):
    """``A^{-1} b`` for (..., d, d) ``A`` and (..., d) ``b`` by LU (``A``
    need not be symmetric); NaN where ``A`` is singular."""
    x, info = torch.linalg.solve_ex(A, b)
    return torch.where((info != 0)[..., None], torch.nan, x)


def mv(A, x):
    """Batched matrix-vector product ``A @ x``."""
    return (A @ x.unsqueeze(-1)).squeeze(-1)


def lower_t_solve(L, z):
    """``L^{-T} z`` for a lower factor ``L``."""
    return torch.linalg.solve_triangular(L.mT, z.unsqueeze(-1),
                                         upper=True).squeeze(-1)


def _logdet_chol(L):
    return torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1)


def _chol_drift(G, grad):
    """(L, G^{-1} grad) from one Cholesky and two triangular solves."""
    L = cholesky(G)
    y = torch.linalg.solve_triangular(L, grad.unsqueeze(-1), upper=False)
    return L, lower_t_solve(L, y.squeeze(-1))


def chol_inverse(L):
    """``G^{-1}`` from the lower Cholesky factor of ``G`` (two triangular
    solves against the identity; shared by the manifold family)."""
    eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device)
    return torch.linalg.solve_triangular(
        L.mT, torch.linalg.solve_triangular(L, eye, upper=False), upper=True)


def step_sizes(sampler, state, value):
    """The per-chain step (chain shape): the tuner's, or ``value``."""
    pars = state.pars
    if sampler.tuner is not None:
        return state.tune.step_size.to(pars.dtype)
    return torch.full(pars.shape[:-1], float(value), dtype=pars.dtype,
                      device=pars.device)


def log_uniform(generator, like):
    """One ``log(rand())`` per chain of ``like`` (..., d)."""
    return torch.log(torch.rand(like.shape[:-1], generator=generator,
                                dtype=like.dtype, device=like.device))


def manifold_info(state, new, accept):
    return {
        "ppars": new.pars,
        "plogtarget": new.logtarget,
        "pgrads": new.grad,
        "pars": state.pars,
        "logtarget": state.logtarget,
        "grads": state.grad,
        "accept": accept,
    }


# -- the Langevin pair (SMMALA, PMALA) --------------------------------------


def _smmala_geometry(model, theta):
    lp, g, G = model.evalallt(theta)
    return (lp, g, *_chol_drift(G, g))


class _Langevin(Sampler):
    """SMMALA and PMALA: the same proposal and q-ratio, on their own drift
    (``_geometry(model, theta) -> (logp, grad, L, drift)``)."""

    needs_gradient = True
    needs_tensor = True

    def __post_init__(self):
        assert self.scale > 0, f"{type(self).__name__} drift step should be > 0"

    def init(self, model, theta0, generator=None):
        lp, g, L, drift = self._geometry(model, theta0)
        shape = tuple(theta0.shape[:-1])
        return self._state_cls(
            pars=theta0, logtarget=lp, grad=g, chol=L, drift=drift,
            tune=tuner_init(self.scale, 1, shape, theta0.dtype,
                            theta0.device),
            i=torch.ones(shape, dtype=torch.int32, device=theta0.device))

    def reset(self, model, state, theta):
        lp, g, L, drift = self._geometry(model, theta)
        return state.replace(pars=theta, logtarget=lp, grad=g, chol=L,
                             drift=drift)

    def step(self, model, ctx: RunCtx, state, generator):
        noise = torch.randn(state.pars.shape, generator=generator,
                            dtype=state.pars.dtype, device=state.pars.device)
        return self.move(model, ctx, state, noise,
                         log_uniform(generator, state.pars))

    def move(self, model, ctx, state, noise, log_u):
        """The transition given its draws: the proposal's standard normal
        ``noise`` (..., d) and the accept test's ``log_u`` (chain shape)."""
        eps = step_sizes(self, state, self.scale)
        e = eps.unsqueeze(-1)
        L = state.chol
        pars_mean = state.pars + (e / 2.0) * state.drift
        proposed = pars_mean + torch.sqrt(e) * lower_t_solve(L, noise)
        plp, pgrad, pL, p_drift = self._geometry(model, proposed)

        # log q up to the common -d/2 log eps:
        # +logdet L - diff' (G / eps) diff / 2, with diff' G diff = |L'diff|^2
        diff = pars_mean - proposed
        fwd = _logdet_chol(L) - 0.5 / eps * mv(L.mT, diff).square().sum(-1)
        rdiff = proposed + (e / 2.0) * p_drift - state.pars
        rev = _logdet_chol(pL) - 0.5 / eps * mv(pL.mT, rdiff).square().sum(-1)
        ratio = plp + rev - state.logtarget - fwd
        accept = accept_given(ratio, log_u)

        a = accept.unsqueeze(-1)
        new = self._state_cls(
            pars=torch.where(a, proposed, state.pars),
            logtarget=torch.where(accept, plp, state.logtarget),
            grad=torch.where(a, pgrad, state.grad),
            chol=torch.where(a.unsqueeze(-1), pL, state.chol),
            drift=torch.where(a, p_drift, state.drift),
            tune=tuner_update(self.tuner, state.tune, state.i, accept,
                              ctx.burnin),
            i=state.i + 1)
        return new, manifold_info(state, new, accept)


@dataclasses.dataclass(frozen=True, repr=False)
class SMMALA(_Langevin):
    scale: float = 1.0  # driftStep
    tuner: Optional[EmpMCTuner] = None

    _state_cls = SMMALAState
    _geometry = staticmethod(_smmala_geometry)
