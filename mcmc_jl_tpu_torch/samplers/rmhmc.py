"""Riemannian manifold HMC (port of ``mcmc_jl_tpu/samplers/rmhmc.py``;
reference: src/samplers/RMHMC.jl; Girolami & Calderhead 2011).

Generalized leapfrog with ``n_newton`` fixed-point iterations for the
implicit momentum and position updates (RMHMC.jl:120-155), a fair +-1
integration direction and trajectory length ``ceil(rand() * n_leaps)``
(RMHMC.jl:117-118), Hamiltonian with the ``log det G`` volume term
(RMHMC.jl:107).  Requires gradient + tensor + dtensor.

Chains sit on a leading dimension (``G`` (C, d, d), ``dG`` (C, d, d, d)).
Each chain draws its own trajectory length: the leapfrog loop runs to the
batch's largest count (``n_leaps``, or the largest tuned count) and every
carry of a chain past its own count is frozen with ``torch.where``, so it
ends where a chain run alone ends.  The gradient at the end of one leap is
the next leap's opening gradient, so a leap takes one ``evalalldt`` for the
refresh and ``n_newton`` ``evalt`` for the implicit position step.  A
metric that is not positive definite or a singular system gives NaN (no
error check, no host sync), and the chain rejects.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from .base import (
    EmpMCTuner, RunCtx, Sampler, TuneState, accept_given, state_dataclass,
    tuner_init, tuner_update,
)
from .smmala import (_logdet_chol, chol_inverse, cholesky, log_uniform,
                     manifold_info, mv, solve, step_sizes)


@state_dataclass
class RMHMCState:
    pars: torch.Tensor
    logtarget: torch.Tensor
    grad: torch.Tensor
    # metric at pars, carried across transitions: it was computed when
    # this point was the proposal
    G: torch.Tensor
    tune: TuneState
    i: torch.Tensor


def _metric_pack(invG, dG):
    """invGxdG[..., :, :, j] = invG @ dG[..., :, :, j] and the trace of
    each (RMHMC.jl:110-113)."""
    invGxdG = torch.einsum("...ab,...bcj->...acj", invG, dG)
    traces = torch.diagonal(invGxdG, dim1=-3, dim2=-2).sum(-1)
    return invGxdG, traces


def _momentum_term(m, invGxdG, invG_m):
    """mt[r] = 0.5 * m' invGxdG[:, :, r] invG m (RMHMC.jl:126-129)."""
    return 0.5 * torch.einsum("...a,...abr,...b->...r", m, invGxdG, invG_m)


def _logdet_term(cholG):
    """The Hamiltonian's log det term as RMHMC.jl:107 spells it (its
    constant cancels in the ratio)."""
    d = cholG.shape[-1]
    return 0.5 * (math.log(2.0) + d * math.log(math.pi)
                  + 2.0 * _logdet_chol(cholG))


def trajectory_lengths(sampler, state, u_len):
    """Per-chain leap counts ``ceil(u * nl)`` and the loop's bound: the
    sampler's ``n_leaps``, or with a tuner the largest tuned count (one
    host read)."""
    dtype = state.pars.dtype
    if sampler.tuner is not None:
        nl = state.tune.n_leaps
        bound = int(nl.max())
    else:
        nl = torch.full(u_len.shape, sampler.n_leaps, dtype=torch.int32,
                        device=u_len.device)
        bound = sampler.n_leaps
    return torch.ceil(u_len * nl.to(dtype)).to(torch.int32), bound


def freeze(active, new, old):
    """Per chain, the new carry where ``active``, else the old."""
    return tuple(torch.where(active.reshape(active.shape
                                            + (1,) * (n.ndim - active.ndim)),
                             n, o)
                 for n, o in zip(new, old))


@dataclasses.dataclass(frozen=True, repr=False)
class RMHMC(Sampler):
    n_leaps: int = 6
    leap_step: float = 0.5
    n_newton: int = 4
    tuner: Optional[EmpMCTuner] = None

    needs_gradient = True
    needs_tensor = True
    needs_dtensor = True

    def __init__(self, *args, n_leaps=None, leap_step=None, n_newton=None,
                 tuner=None):
        """Reference ctor overloads (RMHMC.jl:43-50): ``RMHMC()``,
        ``RMHMC(nLeaps)`` (leapStep=3/nLeaps), ``RMHMC(leapStep)``
        (nLeaps=floor(3/leapStep)), ``RMHMC(nLeaps, leapStep)``, plus
        optional ``nNewton`` int and trailing tuner."""
        pos = list(args)
        if pos and isinstance(pos[-1], EmpMCTuner):
            assert tuner is None
            tuner = pos.pop()
        ints = [a for a in pos if isinstance(a, int)]
        floats = [a for a in pos if isinstance(a, float)]
        if n_leaps is None and ints:
            n_leaps = ints.pop(0)
        if n_newton is None and ints:
            n_newton = ints.pop(0)
        if leap_step is None and floats:
            leap_step = floats.pop(0)
        if n_leaps is None and leap_step is not None:
            n_leaps = max(1, int(3.0 / leap_step))
        if leap_step is None and n_leaps is not None and n_leaps != 6:
            leap_step = 3.0 / n_leaps
        n_leaps = 6 if n_leaps is None else n_leaps
        leap_step = 0.5 if leap_step is None else leap_step
        n_newton = 4 if n_newton is None else n_newton
        assert n_leaps > 0, "Number of leapfrog steps should be > 0"
        assert leap_step > 0, "Leapfrog step size should be > 0"
        assert n_newton > 0, "Number of Newton steps should be > 0"
        object.__setattr__(self, "n_leaps", int(n_leaps))
        object.__setattr__(self, "leap_step", float(leap_step))
        object.__setattr__(self, "n_newton", int(n_newton))
        object.__setattr__(self, "tuner", tuner)

    def init(self, model, theta0, generator=None):
        lp, g, G = model.evalallt(theta0)
        shape = tuple(theta0.shape[:-1])
        return RMHMCState(
            pars=theta0, logtarget=lp, grad=g, G=G,
            tune=tuner_init(self.leap_step, self.n_leaps, shape,
                            theta0.dtype, theta0.device),
            i=torch.ones(shape, dtype=torch.int32, device=theta0.device))

    def reset(self, model, state, theta):
        lp, g, G = model.evalallt(theta)
        return state.replace(pars=theta, logtarget=lp, grad=g, G=G)

    def step(self, model, ctx: RunCtx, state, generator):
        pars = state.pars
        kw = dict(generator=generator, dtype=pars.dtype, device=pars.device)
        z = torch.randn(pars.shape, **kw)
        forward = torch.rand(pars.shape[:-1], **kw) < 0.5
        u_len = torch.rand(pars.shape[:-1], **kw)
        return self.move(model, ctx, state, z, forward, u_len,
                         log_uniform(generator, pars))

    def _leap(self, model, half, carry):
        """One generalized leapfrog step of every chain (RMHMC.jl:120-156)."""
        pars, m, invG, invGxdG, traces, lp, grad, G = carry

        # implicit momentum half-step (fixed point, RMHMC.jl:123-131)
        lm = m
        for _ in range(self.n_newton):
            mt = _momentum_term(lm, invGxdG, mv(invG, lm))
            lm = m + half * (grad - 0.5 * traces + mt)
        m = lm
        invG_m2 = mv(invG, m)

        # implicit position step (fixed point, RMHMC.jl:136-141)
        lp_pars = pars
        for _ in range(self.n_newton):
            invG_m1 = solve(model.evalt(lp_pars), m)
            lp_pars = pars + half * (invG_m1 + invG_m2)
        pars = lp_pars

        # refresh the metric and finish the momentum step (RMHMC.jl:143-156)
        lp, grad, G, dG = model.evalalldt(pars)
        invG = chol_inverse(cholesky(G))
        invGxdG, traces = _metric_pack(invG, dG)
        mt = _momentum_term(m, invGxdG, mv(invG, m))
        m = m + half * (grad - 0.5 * traces + mt)
        return pars, m, invG, invGxdG, traces, lp, grad, G

    def move(self, model, ctx, state, z, forward, u_len, log_u):
        """The transition given its draws: the momentum's standard normal
        ``z`` (..., d), the direction ``forward`` (bool), the length's
        uniform ``u_len`` and the accept test's ``log_u`` (chain shape)."""
        eps = step_sizes(self, state, self.leap_step)
        n_rand, bound = trajectory_lengths(self, state, u_len)

        G0 = state.G
        cholG0 = cholesky(G0)
        invG0 = chol_inverse(cholG0)
        m0 = mv(cholG0, z)
        H0 = (-state.logtarget + _logdet_term(cholG0)
              + 0.5 * (m0 * mv(invG0, m0)).sum(-1))

        invGxdG0, traces0 = _metric_pack(invG0, model.evaldt(state.pars))
        half = (torch.where(forward, 1.0, -1.0).to(eps.dtype)
                * (eps / 2.0)).unsqueeze(-1)

        carry = (state.pars, m0, invG0, invGxdG0, traces0, state.logtarget,
                 state.grad, G0)
        for j in range(bound):
            carry = freeze(j < n_rand, self._leap(model, half, carry), carry)
        pars, m, invG, _, _, plp, pgrad, G = carry

        pH = (-plp + _logdet_term(cholesky(G))
              + 0.5 * (m * mv(invG, m)).sum(-1))
        accept = accept_given(H0 - pH, log_u)

        a = accept.unsqueeze(-1)
        new = RMHMCState(
            pars=torch.where(a, pars, state.pars),
            logtarget=torch.where(accept, plp, state.logtarget),
            grad=torch.where(a, pgrad, state.grad),
            G=torch.where(a.unsqueeze(-1), G, G0),
            tune=tuner_update(self.tuner, state.tune, state.i, accept,
                              ctx.burnin, with_leaps=True),
            i=state.i + 1)
        return new, manifold_info(state, new, accept)
