"""ChEES-HMC: cross-chain adaptive trajectory lengths (port of
``mcmc_jl_tpu/samplers/chees.py``; Hoffman, Radul & Sountsov 2021, "An
Adaptive-MCMC Scheme for Setting Trajectory Lengths in Hamiltonian Monte
Carlo").

All chains run fixed-step leapfrog trajectories of one shared, jittered
length ``clip(ceil(halton2(i) T / eps), 1, max_leaps)``; during burn-in the
engine's pooling hook (:meth:`ChEESHMC.pool`, called by
:func:`mcmc_jl_tpu_torch.parallel.pchains._scan_chains` after every batched
step) adapts ``log T`` by Adam ascent on the ChEES criterion

    ChEES = (1/4) E[ (||q' - E q'||^2 - ||q - E q||^2)^2 ]

minus a cost penalty, and dual-averages the step on the pooled mean
acceptance probability.  Before the first pool every chain carries the step
``find_reasonable_step`` gave it, so the leap counts differ per chain; the
batched step then runs to the largest count and holds the chains that are
done, as the JAX package's vmapped loop does.  A single-chain run samples
correctly but keeps its initial step and length.

Diagonal metric kinds only; ``mass_adapt="dense"`` raises, as in the JAX
package.  As there, the state carries a mass accumulator that the step does
not update, so the metric stays the unit one.
"""
from __future__ import annotations

import dataclasses

import torch

from .base import RunCtx, Sampler, _where, metropolis_accept, state_dataclass
from .hmcda import find_reasonable_step
from .integrators import get_integrator, hamiltonian
from .massadapt import MassAccum, mass_init, mass_kind, mass_vector_scale


def halton2(i, dtype=torch.float32):
    """Radical inverse base 2 of the integer step index ``i`` (an int or an
    integer tensor): the paper's quasi-random jitter of trajectory lengths,
    identical across chains.  Summed in float64 and rounded once to
    ``dtype``, as the JAX package does; exact in float32 for ``i < 2**24``."""
    i = torch.as_tensor(i, dtype=torch.int64)
    bits = torch.arange(32, dtype=torch.int64, device=i.device)
    digits = (i.unsqueeze(-1) >> bits) & 1
    w = torch.full((32,), 0.5, dtype=torch.float64,
                   device=i.device) ** (bits + 1).to(torch.float64)
    return (digits.to(torch.float64) * w).sum(-1).to(dtype)


@state_dataclass
class ChEESState:
    pars: torch.Tensor
    logtarget: torch.Tensor
    grad: torch.Tensor
    # adapted scalars, identical across chains after the first pool
    leap_step: torch.Tensor  # current eps (dual-averaging iterate)
    dual_leap_step: torch.Tensor  # exp(log eps-bar): the post-burn-in eps
    dual_h: torch.Tensor  # dual-averaging error accumulator
    mu: torch.Tensor  # log(10 eps0), per chain
    log_len: torch.Tensor  # log total integration time T
    adam_m: torch.Tensor  # Adam moments for log_len
    adam_v: torch.Tensor
    i: torch.Tensor
    mass: MassAccum
    # the last step's stash, read by the pool hook
    p_prev: torch.Tensor  # q, the position before the step
    p_prop: torch.Tensor  # q', the trajectory's end before the MH test
    p_vel: torch.Tensor  # dq'/dt, the final momentum (unit mass)
    p_alpha: torch.Tensor  # min(1, exp(H0 - H))
    p_time: torch.Tensor  # the integration time n_leaps * eps


@dataclasses.dataclass(frozen=True, repr=False)
class ChEESHMC(Sampler):
    rate: float = 0.651  # pooled-acceptance target of the dual averaging
    len0: float = 1.0  # initial total integration time T
    max_leaps: int = 1024  # cap on leapfrogs per step
    lr: float = 0.025  # Adam learning rate on log T
    #: ascend log(ChEES) - cost_penalty * log(T): past the optimum the raw
    #: criterion is flat in T, and the penalty for the linear cost keeps T
    #: from drifting into over-rotated trajectories
    cost_penalty: float = 1.0
    b1: float = 0.9
    b2: float = 0.999
    shrinkage: float = 0.05  # dual-averaging gamma (NUTS.jl:121-125)
    t0: float = 10.0
    step_pow: float = 0.75  # kappa
    integrator: str = "leapfrog"  # "leapfrog" | "2stage" | "3stage"
    #: False | True/"diag" | "diag-win"; the dense metric is not offered
    mass_adapt: object = False

    needs_gradient = True

    def __post_init__(self):
        assert 0.0 < self.rate < 1.0, "target acceptance rate should be in (0, 1)"
        assert self.len0 > 0, "len0 must be positive"
        assert self.max_leaps > 0, "max_leaps must be positive"
        get_integrator(self.integrator)  # validate early
        if self.mass_adapt == "dense":
            raise ValueError("ChEESHMC supports mass_adapt False/'diag'/"
                             "'diag-win' (dense not offered)")
        mass_kind(self.mass_adapt)

    @property
    def _kind(self):
        return mass_kind(self.mass_adapt)

    # -- protocol ----------------------------------------------------------
    def init(self, model, theta0, generator):
        lp, g = model.evalallg(theta0)
        dtype, dev = theta0.dtype, theta0.device
        shape = tuple(theta0.shape[:-1])
        m = torch.randn(theta0.shape, generator=generator, dtype=dtype,
                        device=dev)
        eps = find_reasonable_step(model, theta0, lp, g, m)
        full = lambda v: torch.full(shape, v, dtype=dtype, device=dev)  # noqa: E731
        return ChEESState(
            pars=theta0, logtarget=lp, grad=g,
            leap_step=eps,
            dual_leap_step=eps,  # the unadapted fallback
            dual_h=full(0.0),
            mu=torch.log(10.0 * eps),
            log_len=torch.log(full(self.len0)),
            adam_m=full(0.0), adam_v=full(0.0),
            i=torch.ones(shape, dtype=torch.int32, device=dev),
            mass=mass_init(self._kind, theta0.shape[-1], dtype, dev, shape),
            p_prev=theta0, p_prop=theta0, p_vel=torch.zeros_like(theta0),
            p_alpha=full(0.0), p_time=full(0.0),
        )

    def reset(self, model, state, theta):
        lp, g = model.evalallg(theta)
        return state.replace(pars=theta, logtarget=lp, grad=g)

    def step(self, model, ctx: RunCtx, state, generator):
        pars0 = state.pars
        dtype = pars0.dtype
        in_warm = state.i <= ctx.burnin
        eps = torch.where(in_warm, state.leap_step, state.dual_leap_step)
        T = torch.exp(state.log_len)
        u = halton2(state.i, dtype).to(pars0.device)
        nl = torch.clamp(torch.ceil(u * T / eps), 1,
                         self.max_leaps).to(torch.int32)

        # per-coordinate preconditioning folded into the integrator; T keeps
        # counting scalar-eps time
        eps_step = eps.unsqueeze(-1)
        if self._kind is not None:
            eps_step = eps_step * mass_vector_scale(self._kind, state.mass,
                                                    dtype)

        m0 = torch.randn(pars0.shape, generator=generator, dtype=dtype,
                         device=pars0.device)
        H0 = hamiltonian(state.logtarget, m0)
        step_fn, _ = get_integrator(self.integrator)
        carry = (pars0, state.logtarget, state.grad, m0)
        for j in range(int(nl.max())):
            new = step_fn(model, carry[0], carry[3], carry[2], eps_step)
            live = j < nl  # chains whose trajectory is still running
            carry = tuple(_where(live, b, a) for a, b in zip(carry, new))
        pars, lp, g, m = carry

        ratio = H0 - hamiltonian(lp, m)
        alpha = torch.where(torch.isnan(ratio), torch.zeros_like(ratio),
                            torch.exp(torch.clamp(ratio, max=0.0)))
        accept = metropolis_accept(generator, ratio)
        a = accept.unsqueeze(-1)
        new_pars = torch.where(a, pars, pars0)
        new_lp = torch.where(accept, lp, state.logtarget)
        new_grad = torch.where(a, g, state.grad)
        info = {
            "ppars": new_pars,
            "plogtarget": new_lp,
            "pgrads": new_grad,
            "pars": pars0,
            "logtarget": state.logtarget,
            "grads": state.grad,
            "accept": accept,
            "alpha": alpha,
            "epsilon": eps,
            "nleaps": nl,
        }
        return state.replace(
            pars=new_pars, logtarget=new_lp, grad=new_grad, i=state.i + 1,
            p_prev=pars0, p_prop=pars, p_vel=m, p_alpha=alpha,
            p_time=nl.to(dtype) * eps,
        ), info

    # -- cross-chain adaptation (engine pool hook) ---------------------------
    def pool(self, ctx: RunCtx, states, info):
        """One pooled adaptation transition on the batched (C, ...) states,
        called by the engine after every step: Adam on log T from the
        alpha-weighted ChEES gradient, dual averaging of eps on the mean
        acceptance probability, both only for steps within the burn-in."""
        del info
        dtype = states.log_len.dtype
        i = (states.i[0] - 1).to(dtype)  # the step just completed
        do = (states.i[0] - 1) <= ctx.burnin

        alpha = states.p_alpha  # (C,)
        q, qp, v = states.p_prev, states.p_prop, states.p_vel  # (C, d)
        wsum = torch.clamp(alpha.sum(), min=1e-20)
        w = alpha / wsum
        qbar = q.mean(0)
        qpbar = (w[:, None] * qp).sum(0)
        qc2 = ((q - qbar) ** 2).sum(1)
        qpc = qp - qpbar
        qpc2 = (qpc ** 2).sum(1)
        delta = qpc2 - qc2
        # ChEES = (1/4) E[delta^2]; d/d(log T) uses dq'/d(log T) = t v'
        chees = (w * delta ** 2).sum() / 4.0
        dchees = (w * delta * (qpc * v).sum(1) * states.p_time).sum() / 2.0
        grad = dchees / torch.clamp(chees, min=1e-20) - self.cost_penalty

        # Adam ascent on log trajectory time
        m_t = self.b1 * states.adam_m[0] + (1 - self.b1) * grad
        v_t = self.b2 * states.adam_v[0] + (1 - self.b2) * grad ** 2
        mhat = m_t / (1 - self.b1 ** i)
        vhat = v_t / (1 - self.b2 ** i)
        step = self.lr * mhat / (torch.sqrt(vhat) + 1e-8)
        eps_now = states.leap_step[0]
        new_log_len = torch.clamp(states.log_len[0] + step,
                                  min=torch.log(eps_now),
                                  max=torch.log(self.max_leaps * eps_now))

        # dual averaging of eps on the pooled mean acceptance probability,
        # anchored on the cross-chain mean of the per-chain mu
        abar = alpha.mean()
        h = ((1.0 - 1.0 / (i + self.t0)) * states.dual_h[0]
             + (self.rate - abar) / (i + self.t0))
        log_eps = states.mu.mean() - torch.sqrt(i) / self.shrinkage * h
        eta = i ** -self.step_pow
        log_ebar = eta * log_eps + (1.0 - eta) * torch.log(
            states.dual_leap_step[0])

        def upd(new, old):
            return torch.where(do, new, old[0]).expand(old.shape).clone()

        return states.replace(
            leap_step=upd(torch.exp(log_eps), states.leap_step),
            dual_leap_step=upd(torch.exp(log_ebar), states.dual_leap_step),
            dual_h=upd(h, states.dual_h),
            log_len=upd(new_log_len, states.log_len),
            adam_m=upd(m_t, states.adam_m),
            adam_v=upd(v_t, states.adam_v),
        )
