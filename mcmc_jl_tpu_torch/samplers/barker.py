"""Barker proposal MCMC (port of ``mcmc_jl_tpu/samplers/barker.py``;
Livingstone & Zanella 2022, JRSS-B).

A gradient-based proposal that is robust to step-size mis-tuning and scale
heterogeneity.  Per coordinate i:

    z_i ~ N(0, sigma_i^2);  b_i = +1 w.p. sigmoid(z_i * grad_i) else -1
    proposal  y = x + b * z

with ``sigma = eps * model.scale``.  The increment density is
``q(y|x) = 2 N(w) sigmoid(w grad(x))`` for ``w = y - x``, so the exact MH
log-ratio is

    log r = logp(y) - logp(x)
          + sum_i [ softplus(-w_i g_i(x)) - softplus(w_i g_i(y)) ]

(the Gaussian parts cancel).  An optional ``EmpMCTuner`` adapts ``eps``
during burn-in, per chain, toward the Barker-optimal acceptance ~0.57.
Chains sit on a leading dimension; on a catalog model on the card every
proposal's (logp, grad) is one launch of the custom-target gradient pass.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from .base import (
    EmpMCTuner, RunCtx, Sampler, TuneState, metropolis_accept,
    state_dataclass, tuner_init, tuner_update,
)


@state_dataclass
class BarkerState:
    pars: torch.Tensor
    logtarget: torch.Tensor
    grad: torch.Tensor
    tune: TuneState
    i: torch.Tensor


def barker_log_ratio(lp, grad, plp, pgrad, w):
    """The MH log-ratio of a Barker move by ``w`` from (lp, grad) to
    (plp, pgrad), one value per chain."""
    correction = (F.softplus(-w * grad) - F.softplus(w * pgrad)).sum(-1)
    return plp - lp + correction


@dataclasses.dataclass(frozen=True, repr=False)
class Barker(Sampler):
    scale: float = 1.0
    tuner: Optional[EmpMCTuner] = None

    needs_gradient = True

    def __post_init__(self):
        assert self.scale > 0, "Barker proposal scale should be > 0"

    def init(self, model, theta0, generator=None):
        lp, g = model.evalallg(theta0)
        shape = tuple(theta0.shape[:-1])
        return BarkerState(
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
        sigma = eps * model.scale.to(pars.dtype)

        z = sigma * torch.randn(pars.shape, generator=generator,
                                dtype=pars.dtype, device=pars.device)
        p_plus = torch.sigmoid(z * state.grad)
        u = torch.rand(pars.shape, generator=generator, dtype=pars.dtype,
                       device=pars.device)
        w = torch.where(u < p_plus, z, -z)
        proposed = pars + w
        plp, pgrad = model.evalallg(proposed)

        ratio = barker_log_ratio(state.logtarget, state.grad, plp, pgrad, w)
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
        return (BarkerState(pars=new_pars, logtarget=new_lp, grad=new_grad,
                            tune=tune, i=state.i + 1),
                info)
