"""Lagrangian Monte Carlo samplers (port of
``mcmc_jl_tpu/samplers/lagrangian.py``; Lan et al. 2012).

- :class:`ERMLMC` — explicit Riemannian manifold Lagrangian MC
  (reference: src/samplers/ERMLMC.jl): semi-implicit velocity solves
  ``(G + h/2 vxC) v' = G v - h/2 dphi`` and a ``deltaLogDet`` volume
  correction accumulated into the acceptance ratio (ERMLMC.jl:109-158).
- :class:`RMLMC` — semi-explicit variant (reference: src/samplers/RMLMC.jl):
  fixed-point velocity iteration with ``n_newton`` sweeps
  (RMLMC.jl:119-152); its energy's ``log det`` term enters with the
  opposite sign to ERMLMC (RMLMC.jl:110 vs ERMLMC.jl:105).

Both require gradient + tensor + dtensor.  Shared geometry:
``C = 0.5*(perm(dG,[3 2 1]) + perm(dG,[1 3 2]) - dG)`` (Christoffel-like,
ERMLMC.jl:80) and ``dphi = -grad + 0.5 trace(G^{-1} dG_k)`` (ERMLMC.jl:79).

Chains sit on a leading dimension (``C`` is (C, d, d, d); its permutations
move only the trailing three axes).  The current point's geometry is carried
in the state.  Each chain draws its own trajectory length; the loop runs to
the batch's largest count and freezes every carry of a chain past its own
count, ``deltaLogDet`` included (samplers/rmhmc.py).  The systems
``G + h/2 vxC`` and ``G - h vxC`` are not symmetric: they are solved and
their log-determinants taken by LU.  A metric that is not positive definite
or a singular system gives NaN, and the chain rejects.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .base import (
    EmpMCTuner, RunCtx, Sampler, TuneState, accept_given, state_dataclass,
    tuner_init, tuner_update,
)
from .rmhmc import freeze, trajectory_lengths
from .smmala import (_logdet_chol, chol_inverse, cholesky, log_uniform,
                     lower_t_solve, manifold_info, mv, solve, step_sizes)


@state_dataclass
class LMCState:
    pars: torch.Tensor
    logtarget: torch.Tensor
    grad: torch.Tensor
    # full geometry at pars, carried across transitions: it was computed
    # when this point was the proposal
    G: torch.Tensor
    invG: torch.Tensor
    cholG: torch.Tensor
    dphi: torch.Tensor
    C: torch.Tensor
    tune: TuneState
    i: torch.Tensor


def _geometry(grad, G, dG):
    """(invG, cholG, dphi, C) from the metric and its derivative (one
    Cholesky; the inverse from triangular solves)."""
    cholG = cholesky(G)
    invG = chol_inverse(cholG)
    traces = torch.einsum("...ab,...baj->...j", invG, dG)  # tr(invG dG_j)
    dphi = -grad + 0.5 * traces
    C = 0.5 * (dG.transpose(-3, -1) + dG.transpose(-2, -1) - dG)
    return invG, cholG, dphi, C


def _vxC(v, C):
    """vxC[k, :] = v' C[:, :, k] (ERMLMC.jl:113-115)."""
    return torch.einsum("...a,...abk->...kb", v, C)


def _slogdet(M):
    """log |det M| (the sign dropped), by LU."""
    return torch.linalg.slogdet(M).logabsdet


def _quad(v, G):
    return (v * mv(G, v)).sum(-1)


class _LagrangianBase(Sampler):
    needs_gradient = True
    needs_tensor = True
    needs_dtensor = True

    def init(self, model, theta0, generator=None):
        lp, g, G, dG = model.evalalldt(theta0)
        invG, cholG, dphi, C = _geometry(g, G, dG)
        shape = tuple(theta0.shape[:-1])
        return LMCState(
            pars=theta0, logtarget=lp, grad=g, G=G, invG=invG, cholG=cholG,
            dphi=dphi, C=C,
            tune=tuner_init(self.leap_step, self.n_leaps, shape,
                            theta0.dtype, theta0.device),
            i=torch.ones(shape, dtype=torch.int32, device=theta0.device))

    def reset(self, model, state, theta):
        lp, g, G, dG = model.evalalldt(theta)
        invG, cholG, dphi, C = _geometry(g, G, dG)
        return state.replace(pars=theta, logtarget=lp, grad=g, G=G,
                             invG=invG, cholG=cholG, dphi=dphi, C=C)

    def _energy_logdet_sign(self):
        raise NotImplementedError

    def _velocity_update(self, geom, dld, h):
        raise NotImplementedError

    def step(self, model, ctx: RunCtx, state, generator):
        pars = state.pars
        kw = dict(generator=generator, dtype=pars.dtype, device=pars.device)
        z = torch.randn(pars.shape, **kw)
        u_len = torch.rand(pars.shape[:-1], **kw)
        return self.move(model, ctx, state, z, u_len,
                         log_uniform(generator, pars))

    def _leap(self, model, h, carry):
        """One Lagrangian leap of every chain (ERMLMC.jl:109-158,
        RMLMC.jl:119-152); ``h`` (chain shape)."""
        pars, lp, grad, G, invG, cholG, dphi, C, v, dld = carry
        hv, hm = h.unsqueeze(-1), h[..., None, None]

        v, dld = self._velocity_update((G, invG, dphi, C, v), dld, h)

        pars = pars + hv * v
        lp, grad, G, dG = model.evalalldt(pars)
        invG, cholG, dphi, C = _geometry(grad, G, dG)

        # closing velocity half-update
        if isinstance(self, ERMLMC):  # the opening solve at the new point
            v, dld = self._velocity_update((G, invG, dphi, C, v), dld, h)
        else:  # RMLMC (RMLMC.jl:145-152)
            vxc = _vxC(v, C)
            dld = dld + _slogdet(G - hm * vxc)
            v = v - (0.5 * hv) * mv(invG, mv(vxc, v) + dphi)
        return pars, lp, grad, G, invG, cholG, dphi, C, v, dld

    def move(self, model, ctx, state, z, u_len, log_u):
        """The transition given its draws: the velocity's standard normal
        ``z`` (..., d), the length's uniform ``u_len`` and the accept
        test's ``log_u`` (chain shape)."""
        h = step_sizes(self, state, self.leap_step)
        n_rand, bound = trajectory_lengths(self, state, u_len)
        sgn = self._energy_logdet_sign()

        # velocity ~ N(0, G^{-1}) (ERMLMC.jl:103) via L^{-T} z
        v0 = lower_t_solve(state.cholG, z)
        E0 = (-state.logtarget + sgn * _logdet_chol(state.cholG)
              + 0.5 * _quad(v0, state.G))

        carry = (state.pars, state.logtarget, state.grad, state.G,
                 state.invG, state.cholG, state.dphi, state.C, v0,
                 torch.zeros_like(state.logtarget))
        for j in range(bound):
            carry = freeze(j < n_rand, self._leap(model, h, carry), carry)
        pars, lp, grad, G, invG, cholG, dphi, C, v, dld = carry

        pE = -lp + sgn * _logdet_chol(cholG) + 0.5 * _quad(v, G)
        accept = accept_given(E0 - pE + dld, log_u)

        a = accept.unsqueeze(-1)
        am = a.unsqueeze(-1)
        new = LMCState(
            pars=torch.where(a, pars, state.pars),
            logtarget=torch.where(accept, lp, state.logtarget),
            grad=torch.where(a, grad, state.grad),
            G=torch.where(am, G, state.G),
            invG=torch.where(am, invG, state.invG),
            cholG=torch.where(am, cholG, state.cholG),
            dphi=torch.where(a, dphi, state.dphi),
            C=torch.where(am.unsqueeze(-1), C, state.C),
            tune=tuner_update(self.tuner, state.tune, state.i, accept,
                              ctx.burnin, with_leaps=True),
            i=state.i + 1)
        return new, manifold_info(state, new, accept)


@dataclasses.dataclass(frozen=True, repr=False)
class ERMLMC(_LagrangianBase):
    n_leaps: int = 10
    leap_step: float = 0.1
    tuner: Optional[EmpMCTuner] = None

    def __post_init__(self):
        assert self.n_leaps > 0, "Number of leapfrog steps should be > 0"
        assert self.leap_step > 0, "Leapfrog step size should be > 0"

    def _energy_logdet_sign(self):
        return -1.0  # ERMLMC.jl:105: E = -logp - sum(log(diag(cholG))) + ...

    def _velocity_update(self, geom, dld, h):
        """Opening semi-implicit velocity solve (ERMLMC.jl:112-125)."""
        G, invG, dphi, C, v = geom
        hv, hm = h.unsqueeze(-1), h[..., None, None]
        A = G + (0.5 * hm) * _vxC(v, C)
        dld = dld - _slogdet(A)
        v = solve(A, mv(G, v) - (0.5 * hv) * dphi)
        dld = dld + _slogdet(G - (0.5 * hm) * _vxC(v, C))
        return v, dld


@dataclasses.dataclass(frozen=True, repr=False)
class RMLMC(_LagrangianBase):
    n_leaps: int = 6
    leap_step: float = 0.5
    n_newton: int = 4
    tuner: Optional[EmpMCTuner] = None

    def __post_init__(self):
        assert self.n_leaps > 0, "Number of leapfrog steps should be > 0"
        assert self.leap_step > 0, "Leapfrog step size should be > 0"
        assert self.n_newton > 0, "Number of Newton steps should be > 0"

    def _energy_logdet_sign(self):
        return 1.0  # RMLMC.jl:110: E = -logp + sum(log(diag(cholG))) + ...

    def _velocity_update(self, geom, dld, h):
        """Opening fixed-point velocity iteration (RMLMC.jl:119-131)."""
        G, invG, dphi, C, v = geom
        hv, hm = h.unsqueeze(-1), h[..., None, None]
        lv = v
        vxc = _vxC(lv, C)
        for _ in range(self.n_newton):
            vxc = _vxC(lv, C)
            lv = v - (0.5 * hv) * mv(invG, mv(vxc, lv) + dphi)
        dld = dld - _slogdet(G + hm * vxc)
        return lv, dld
