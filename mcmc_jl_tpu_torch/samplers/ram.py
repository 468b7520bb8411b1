"""Robust adaptive Metropolis (port of ``mcmc_jl_tpu/samplers/ram.py``;
Vihola 2012; reference: src/samplers/RAM.jl).

Proposal ``theta + S r`` with a per-chain lower-triangular factor ``S``
(C, d, d), updated every step (the adaptation is always on, not burn-in
gated, RAM.jl:73-79):

    eta = min(1, d * i^(-2/3))
    SS  = S (I + eta (min(1, e^ratio) - rate) r r' / |r|^2) S'
    S   = chol(SS)  (lower)

The factorization is one batched ``torch.linalg.cholesky_ex``; a chain whose
update lost positive-definiteness (``info != 0``) or any finite entry keeps
its old factor.  ``info["scale"]`` is ``trace(S)`` (RAM.jl:65).
"""
from __future__ import annotations

import dataclasses

import torch

from .base import RunCtx, Sampler, metropolis_accept, state_dataclass


@state_dataclass
class RAMState:
    pars: torch.Tensor
    logtarget: torch.Tensor
    S: torch.Tensor
    i: torch.Tensor


def ram_factor_update(S, rvec, ratio, i, rate):
    """The next factor from S (..., d, d), the step's standard normal draw
    ``rvec`` (..., d), its MH log-ratio and the 1-based step ``i``: the
    Cholesky factor of ``S (I + eta (alpha - rate) r r'/r'r) S'``, or S
    where that factorization fails or is not finite."""
    d = rvec.shape[-1]
    dtype = rvec.dtype
    eta = torch.clamp(d * i.to(dtype) ** (-2.0 / 3.0), max=1.0)
    alpha = torch.where(torch.isnan(ratio), 0.0,
                        torch.clamp(torch.exp(ratio), max=1.0))
    outer = (rvec.unsqueeze(-1) * rvec.unsqueeze(-2)
             / (rvec * rvec).sum(-1)[..., None, None])
    eye = torch.eye(d, dtype=dtype, device=rvec.device)
    coef = (eta * (alpha - rate))[..., None, None]
    SS = S @ (eye + coef * outer) @ S.transpose(-1, -2)
    S_new, info = torch.linalg.cholesky_ex(SS)
    keep = (info == 0) & torch.isfinite(S_new).all(-1).all(-1)
    return torch.where(keep[..., None, None], S_new, S)


@dataclasses.dataclass(frozen=True, repr=False)
class RAM(Sampler):
    scale: float = 1.0
    rate: float = 0.234

    def __post_init__(self):
        assert self.scale > 0, "scale should be > 0"
        assert 0.0 < self.rate < 1.0, (
            f"target acceptance rate ({self.rate}) should be between 0 and 1")

    def init(self, model, theta0, generator=None):
        shape = tuple(theta0.shape[:-1])
        s = torch.diag(model.scale.to(theta0.dtype) * self.scale)
        return RAMState(
            pars=theta0, logtarget=model.eval(theta0),
            S=s.expand(shape + s.shape).clone(),
            i=torch.ones(shape, dtype=torch.int32, device=theta0.device),
        )

    def reset(self, model, state, theta):
        return state.replace(pars=theta, logtarget=model.eval(theta))

    def step(self, model, ctx: RunCtx, state, generator):
        pars = state.pars
        rvec = torch.randn(pars.shape, generator=generator, dtype=pars.dtype,
                           device=pars.device)
        proposed = pars + (state.S @ rvec.unsqueeze(-1)).squeeze(-1)
        plp = model.eval(proposed)

        ratio = plp - state.logtarget
        accept = metropolis_accept(generator, ratio)
        new_pars = torch.where(accept.unsqueeze(-1), proposed, pars)
        new_lp = torch.where(accept, plp, state.logtarget)
        S_new = ram_factor_update(state.S, rvec, ratio, state.i, self.rate)

        info = {
            "ppars": new_pars,
            "plogtarget": new_lp,
            "pars": pars,
            "logtarget": state.logtarget,
            "accept": accept,
            "scale": torch.diagonal(state.S, dim1=-2, dim2=-1).sum(-1),
        }
        return (RAMState(pars=new_pars, logtarget=new_lp, S=S_new,
                         i=state.i + 1),
                info)
