"""Independence Metropolis-Hastings (port of ``mcmc_jl_tpu/samplers/imh.py``;
reference: src/samplers/IMH.jl).

Built from a ``(log_candidate, rand_candidate)`` pair, or from a
distribution with ``logpdf``/``sample`` (the reference's
ContinuousMultivariateDistribution constructor, IMH.jl:24-25).  Every
chain draws its own candidate each step; the MH ratio carries the
candidate-density correction (IMH.jl:50).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..models.distributions import Distribution
from .base import RunCtx, Sampler, metropolis_accept, state_dataclass


@state_dataclass
class IMHState:
    pars: torch.Tensor
    logtarget: torch.Tensor
    logcandidate: torch.Tensor
    i: torch.Tensor


def _summed_logpdf(proposal):
    """Per-chain log-density of a Distribution proposal: a multivariate
    family's value per vector, an elementwise family's summed over the
    last dimension."""
    def log_candidate(p):
        lp = proposal.logpdf(p)
        return lp.sum(-1) if lp.shape == p.shape else lp

    return log_candidate


@dataclasses.dataclass(frozen=True, repr=False)
class IMH(Sampler):
    """``IMH(proposal)`` with a Distribution, or
    ``IMH(log_candidate=..., rand_candidate=...)``.

    ``log_candidate(theta)`` maps (..., d) positions to one log-density per
    chain.  ``rand_candidate(generator, shape)`` takes a ``torch.Generator``
    on the model's device, where the JAX package takes a PRNG key, and the
    chains' leading shape (``()`` for one chain, ``(C,)`` for C), and
    returns that many candidates, (*shape, d); each is flattened and cut to
    the model's d, as in the JAX package.  A Distribution proposal (e.g.
    ``MvNormal``) draws all chains' candidates at once."""

    log_candidate: Callable = None
    rand_candidate: Callable = None

    def __init__(self, proposal=None, *, log_candidate=None,
                 rand_candidate=None):
        if proposal is not None:
            assert isinstance(proposal, Distribution), (
                "IMH(proposal) expects a Distribution with logpdf/sample")
            log_candidate = _summed_logpdf(proposal)
            rand_candidate = proposal.sample
        assert log_candidate is not None and rand_candidate is not None, (
            "IMH requires a proposal distribution or (log_candidate, "
            "rand_candidate)")
        object.__setattr__(self, "log_candidate", log_candidate)
        object.__setattr__(self, "rand_candidate", rand_candidate)

    def _logc(self, theta):
        return torch.as_tensor(self.log_candidate(theta), dtype=theta.dtype,
                               device=theta.device)

    def init(self, model, theta0, generator=None):
        shape = tuple(theta0.shape[:-1])
        return IMHState(
            pars=theta0, logtarget=model.eval(theta0),
            logcandidate=self._logc(theta0),
            i=torch.ones(shape, dtype=torch.int32, device=theta0.device),
        )

    def reset(self, model, state, theta):
        return state.replace(pars=theta, logtarget=model.eval(theta),
                             logcandidate=self._logc(theta))

    def step(self, model, ctx: RunCtx, state, generator):
        pars = state.pars
        lead, d = tuple(pars.shape[:-1]), pars.shape[-1]
        draw = torch.as_tensor(self.rand_candidate(generator, lead),
                               dtype=pars.dtype, device=pars.device)
        proposed = draw.reshape(lead + (-1,))[..., :d]
        plp = model.eval(proposed)
        plc = self._logc(proposed)

        # the candidate-density correction (IMH.jl:50)
        ratio = plp - state.logtarget - plc + state.logcandidate
        accept = metropolis_accept(generator, ratio)
        new_pars = torch.where(accept.unsqueeze(-1), proposed, pars)
        new_lp = torch.where(accept, plp, state.logtarget)
        new_lc = torch.where(accept, plc, state.logcandidate)

        info = {
            "ppars": new_pars,
            "plogtarget": new_lp,
            "pars": pars,
            "logtarget": state.logtarget,
            "accept": accept,
        }
        return (IMHState(pars=new_pars, logtarget=new_lp, logcandidate=new_lc,
                         i=state.i + 1),
                info)
