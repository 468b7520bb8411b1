"""Adaptive HMC with Nesterov dual averaging (port of
``mcmc_jl_tpu/samplers/hmcda.py``; reference: src/samplers/HMCDA.jl;
Hoffman & Gelman 2011, Algorithm 5).

- initial step size by the doubling/halving heuristic (HMCDA.jl:51-69),
  bounded to 100 iterations
- ``n_leaps = max(1, round(len / eps))`` each iteration (HMCDA.jl:104)
- dual-averaging update during burn-in, frozen ``exp(log eps-bar)`` after
  (HMCDA.jl:133-141); defaults rate=0.65, len=2, shrinkage=0.05, t0=10,
  step=0.75 (HMCDA.jl:42-43)
- the mass adaptation of HMC (``mass_adapt``: diagonal or dense), side
  by side with the step size.

Every chain of a batch carries its own step and leap count; the trajectory
loop runs to the largest count with the finished chains held still.
:func:`find_reasonable_step` also serves ``NUTS.init``.
"""
from __future__ import annotations

import dataclasses

import torch

from .base import RunCtx, Sampler, _where, state_dataclass
from .integrators import get_integrator, hamiltonian, leapfrog
from .massadapt import (MassAccum, dense_transforms, mass_init, mass_kind,
                        mass_update, mass_vector_scale, z_model)


@state_dataclass
class HMCDAState:
    pars: torch.Tensor
    logtarget: torch.Tensor
    grad: torch.Tensor
    leap_step: torch.Tensor
    dual_leap_step: torch.Tensor
    dual_h: torch.Tensor
    mu: torch.Tensor
    i: torch.Tensor
    mass: MassAccum


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


@dataclasses.dataclass(frozen=True, repr=False)
class HMCDA(Sampler):
    rate: float = 0.65
    len: float = 2.0
    shrinkage: float = 0.05
    t0: float = 10.0
    step_pow: float = 0.75  # the reference's `step` kwarg (t^-step schedule)
    store_leaps: bool = False  # accepted for API parity; trajectories not stored
    #: "leapfrog" | "2stage" | "3stage" (samplers/integrators.py); trajectory
    #: length `len` still counts macro steps of size eps
    integrator: str = "leapfrog"
    #: False | True/"diag" | "diag-win" | "dense" (massadapt.py)
    mass_adapt: object = False

    needs_gradient = True

    def __init__(self, rate=0.65, len=2.0, shrinkage=0.05, t0=10.0, step=0.75,
                 store_leaps=False, step_pow=None, integrator="leapfrog",
                 mass_adapt=False):
        object.__setattr__(self, "rate", float(rate))
        object.__setattr__(self, "len", float(len))
        object.__setattr__(self, "shrinkage", float(shrinkage))
        object.__setattr__(self, "t0", float(t0))
        object.__setattr__(self, "step_pow",
                           float(step if step_pow is None else step_pow))
        object.__setattr__(self, "store_leaps", bool(store_leaps))
        get_integrator(integrator)  # validate early
        object.__setattr__(self, "integrator", integrator)
        mass_kind(mass_adapt)  # validate early
        object.__setattr__(self, "mass_adapt", mass_adapt)
        assert 0.0 < self.rate < 1.0, "Target acceptance rate should be in (0, 1)"
        assert self.len > 0, "len parameter of HMCDA sampler must be positive"
        assert self.shrinkage > 0, "shrinkage parameter must be positive"
        assert self.t0 >= 0, "t0 parameter must be non-negative"

    @property
    def _kind(self):
        return mass_kind(self.mass_adapt)

    def init(self, model, theta0, generator):
        lp, g = model.evalallg(theta0)
        dtype, dev = theta0.dtype, theta0.device
        shape = tuple(theta0.shape[:-1])
        m = torch.randn(theta0.shape, generator=generator, dtype=dtype,
                        device=dev)
        eps = find_reasonable_step(model, theta0, lp, g, m)
        full = lambda v: torch.full(shape, v, dtype=dtype, device=dev)  # noqa: E731
        return HMCDAState(
            pars=theta0, logtarget=lp, grad=g, leap_step=eps,
            dual_leap_step=full(1.0), dual_h=full(0.0),
            mu=torch.log(10.0 * eps),
            i=torch.ones(shape, dtype=torch.int32, device=dev),
            mass=mass_init(self._kind, theta0.shape[-1], dtype, dev, shape),
        )

    def reset(self, model, state, theta):
        lp, g = model.evalallg(theta)
        return state.replace(pars=theta, logtarget=lp, grad=g)

    def step(self, model, ctx: RunCtx, state, generator):
        pars0 = state.pars
        dtype = pars0.dtype
        eps = state.leap_step
        kind = self._kind
        eps_step = eps.unsqueeze(-1)
        work_model, z0, g0 = model, pars0, state.grad
        if kind == "dense":
            # standardized coordinates theta = L z (the HMC dense path)
            fwd, inv, gfwd, ginv = dense_transforms(
                state.mass.scale.to(dtype))
            work_model, z0, g0 = (z_model(model, fwd, gfwd), inv(pars0),
                                  gfwd(state.grad))
        elif kind is not None:
            # diag kinds: vector integrator step eps * scale; the length
            # rule below keeps counting scalar-eps time
            eps_step = eps_step * mass_vector_scale(kind, state.mass, dtype)

        m0 = torch.randn(pars0.shape, generator=generator, dtype=dtype,
                         device=pars0.device)
        H0 = hamiltonian(state.logtarget, m0)
        nl = torch.clamp(torch.round(self.len / eps), min=1).to(torch.int32)
        step_fn, _ = get_integrator(self.integrator)

        carry = (z0, state.logtarget, g0, m0)
        for j in range(int(nl.max())):
            new = step_fn(work_model, carry[0], carry[3], carry[2], eps_step)
            live = j < nl  # chains whose trajectory is still running
            carry = tuple(_where(live, b, a) for a, b in zip(carry, new))
        pars, lp, g, m = carry
        if kind == "dense":  # back to theta-space
            pars, g = fwd(pars), ginv(g)

        p = torch.clamp(torch.exp(H0 - hamiltonian(lp, m)), max=1.0)
        p = torch.where(torch.isnan(p), torch.zeros_like(p), p)
        u = torch.rand(p.shape, generator=generator, dtype=dtype,
                       device=p.device)
        accept = u < p
        a = accept.unsqueeze(-1)
        new_pars = torch.where(a, pars, pars0)
        new_lp = torch.where(accept, lp, state.logtarget)
        new_grad = torch.where(a, g, state.grad)

        # --- dual averaging (HMCDA.jl:133-141) ---------------------------
        i = state.i.to(dtype)
        in_burnin = state.i < ctx.burnin
        eta = 1.0 / (i + self.t0)
        dual_h = (1.0 - eta) * state.dual_h + eta * (self.rate - p)
        eps_adapt = torch.exp(state.mu - torch.sqrt(i) * dual_h
                              / self.shrinkage)
        eta2 = i ** (-self.step_pow)
        dual_eps = torch.exp((1.0 - eta2) * torch.log(state.dual_leap_step)
                             + eta2 * torch.log(eps_adapt))
        new_eps = torch.where(in_burnin, eps_adapt, state.dual_leap_step)
        new_dual_eps = torch.where(in_burnin, dual_eps, state.dual_leap_step)
        new_dual_h = torch.where(in_burnin, dual_h, state.dual_h)

        info = {
            "ppars": new_pars,
            "plogtarget": new_lp,
            "pgrads": new_grad,
            "pars": pars0,
            "logtarget": state.logtarget,
            "grads": state.grad,
            "accept": accept,
        }
        mass = mass_update(kind, state.mass, new_pars, state.i, ctx.burnin)
        return (
            HMCDAState(pars=new_pars, logtarget=new_lp, grad=new_grad,
                       leap_step=new_eps, dual_leap_step=new_dual_eps,
                       dual_h=new_dual_h, mu=state.mu, i=state.i + 1,
                       mass=mass),
            info,
        )
