"""Metropolis-adjusted Langevin algorithm (port of
``mcmc_jl_tpu/samplers/mala.py``; reference: src/samplers/MALA.jl).

Proposal mean ``theta + (eps/2) grad``, Gaussian with variance ``eps``;
asymmetric q-ratio correction (MALA.jl:98-107).  Optional EmpMCTuner adapts
the drift step during burn-in (MALA.jl:36-43, 90-124), per chain.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from .base import (
    EmpMCTuner, RunCtx, Sampler, TuneState, metropolis_accept,
    state_dataclass, tuner_init, tuner_update,
)


@state_dataclass
class MALAState:
    pars: torch.Tensor
    logtarget: torch.Tensor
    grad: torch.Tensor
    tune: TuneState
    i: torch.Tensor


@dataclasses.dataclass(frozen=True, repr=False)
class MALA(Sampler):
    scale: float = 1.0  # driftStep
    tuner: Optional[EmpMCTuner] = None

    needs_gradient = True

    def __post_init__(self):
        assert self.scale > 0, "MALA drift step should be > 0"

    def init(self, model, theta0, generator=None):
        lp, g = model.evalallg(theta0)
        shape = tuple(theta0.shape[:-1])
        return MALAState(
            pars=theta0, logtarget=lp, grad=g,
            tune=tuner_init(self.scale, 1, shape, theta0.dtype,
                            theta0.device),
            i=torch.ones(shape, dtype=torch.int32, device=theta0.device),
        )

    def reset(self, model, state, theta):
        lp, g = model.evalallg(theta)
        return state.replace(pars=theta, logtarget=lp, grad=g)

    def step(self, model, ctx: RunCtx, state, generator):
        pars = state.pars
        if self.tuner is not None:
            eps = state.tune.step_size.to(pars.dtype).unsqueeze(-1)
        else:
            eps = torch.tensor(self.scale, dtype=pars.dtype,
                               device=pars.device)

        pars_mean = pars + (eps / 2.0) * state.grad
        noise = torch.randn(pars.shape, generator=generator, dtype=pars.dtype,
                            device=pars.device)
        proposed = pars_mean + torch.sqrt(eps) * noise
        plp, pgrad = model.evalallg(proposed)

        log_norm = torch.log(2.0 * math.pi * eps) / 2.0
        prob_new_given_old = (-((pars_mean - proposed) ** 2) / (2.0 * eps)
                              - log_norm).sum(-1)
        rev_mean = proposed + (eps / 2.0) * pgrad
        prob_old_given_new = (-((rev_mean - pars) ** 2) / (2.0 * eps)
                              - log_norm).sum(-1)

        ratio = plp + prob_old_given_new - state.logtarget - prob_new_given_old
        accept = metropolis_accept(generator, ratio)
        a = accept.unsqueeze(-1)
        new_pars = torch.where(a, proposed, pars)
        new_lp = torch.where(accept, plp, state.logtarget)
        new_grad = torch.where(a, pgrad, state.grad)

        tune = tuner_update(self.tuner, state.tune, state.i, accept,
                            ctx.burnin)
        info = {
            "ppars": new_pars,
            "plogtarget": new_lp,
            "pgrads": new_grad,
            "pars": pars,
            "logtarget": state.logtarget,
            "grads": state.grad,
            "accept": accept,
        }
        return (MALAState(pars=new_pars, logtarget=new_lp, grad=new_grad,
                          tune=tune, i=state.i + 1),
                info)
