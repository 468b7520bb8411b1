"""Random-walk Metropolis (port of ``mcmc_jl_tpu/samplers/rwm.py``;
reference: src/samplers/RWM.jl).

Proposal: isotropic Gaussian scaled by ``model.scale * sampler.scale``
(RWM.jl:52,59); accept via the shared NaN-rejecting Metropolis test
(RWM.jl:63).  The generic engine's counterpart of the fused RWM kernel
(ops/rwm_kernels.py).
"""
from __future__ import annotations

import dataclasses

import torch

from .base import RunCtx, Sampler, metropolis_accept, state_dataclass


@state_dataclass
class RWMState:
    pars: torch.Tensor
    logtarget: torch.Tensor
    i: torch.Tensor


@dataclasses.dataclass(frozen=True, repr=False)
class RWM(Sampler):
    scale: float = 1.0
    tuner: object = None  # RWMTuner is abstract-only in the reference (RWM.jl:18)

    def __post_init__(self):
        assert self.scale > 0, "scale should be > 0"

    def init(self, model, theta0, generator=None):
        shape = tuple(theta0.shape[:-1])
        return RWMState(pars=theta0, logtarget=model.eval(theta0),
                        i=torch.ones(shape, dtype=torch.int32,
                                     device=theta0.device))

    def reset(self, model, state, theta):
        return state.replace(pars=theta, logtarget=model.eval(theta))

    def step(self, model, ctx: RunCtx, state, generator):
        pars = state.pars
        scale = model.scale.to(pars.dtype) * self.scale
        proposed = pars + torch.randn(pars.shape, generator=generator,
                                      dtype=pars.dtype,
                                      device=pars.device) * scale
        plogtarget = model.eval(proposed)
        accept = metropolis_accept(generator, plogtarget - state.logtarget)
        a = accept.unsqueeze(-1)
        new_pars = torch.where(a, proposed, pars)
        new_lp = torch.where(accept, plogtarget, state.logtarget)
        info = {
            "ppars": new_pars,
            "plogtarget": new_lp,
            "pars": pars,
            "logtarget": state.logtarget,
            "accept": accept,
        }
        return RWMState(pars=new_pars, logtarget=new_lp, i=state.i + 1), info
