"""Hamiltonian Monte Carlo (port of ``mcmc_jl_tpu/samplers/hmc.py``;
reference: src/samplers/HMC.jl).

Semantics matched to the reference:
- leapfrog update (HMC.jl:93-102), Hamiltonian ``-logp + |m|^2/2`` (HMC.jl:91)
- accept test ``rand() < exp(H0 - H)`` (HMC.jl:154)
- optional EmpMCTuner adapting (leapStep, nLeaps) during burn-in
  (HMC.jl:37-47, 167-173)
- ``store_leaps`` records the whole trajectory for Rao-Blackwellized means
  (HMC.jl:144-151) — as (n_leaps+1) rows of (pars, H).
- optional mass adaptation (samplers/massadapt.py): a diagonal metric
  (``mass_adapt=True``/``"diag"`` or ``"diag-win"``) folded into the
  integrator as a per-coordinate step ``eps * scale``, or a dense one
  (``"dense"``) as unit-metric dynamics in ``z = L^-1 theta``.

The state may hold one chain (``pars`` of shape (d,)) or C chains on a
leading dimension; with a tuner every chain carries its own step and leap
count, and the trajectory loop runs to the largest count with the finished
chains held still.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .base import (
    EmpMCTuner, RunCtx, Sampler, TuneState, metropolis_accept, state_dataclass,
    tuner_init, tuner_update,
)
from .integrators import get_integrator, hamiltonian
from .massadapt import (MassAccum, dense_transforms, mass_init, mass_kind,
                        mass_update, mass_vector_scale, z_model)


@state_dataclass
class HMCState:
    pars: torch.Tensor
    logtarget: torch.Tensor
    grad: torch.Tensor
    tune: TuneState
    i: torch.Tensor
    mass: MassAccum


@dataclasses.dataclass(frozen=True, repr=False)
class HMC(Sampler):
    n_leaps: int = 10
    leap_step: float = 0.1
    store_leaps: bool = False
    tuner: Optional[EmpMCTuner] = None
    #: False | True/"diag" (continuous Welford) | "diag-win" | "dense"
    mass_adapt: object = False
    #: "leapfrog" (reference parity) | "2stage" | "3stage"
    integrator: str = "leapfrog"

    needs_gradient = True

    def __init__(self, *args, n_leaps=None, leap_step=None, store_leaps=None,
                 tuner=None, init=None, scale=None, leaps=None,
                 mass_adapt=False, integrator="leapfrog"):
        """Positional-convenience constructors mirroring the reference's
        overloads (HMC.jl:70-80): ``HMC()``, ``HMC(n)``, ``HMC(eps)``,
        ``HMC(n, eps)``, trailing tuner allowed; plus the kwargs form
        ``HMC(init=10, scale=0.1, leaps=False, tuner=None)``."""
        pos = list(args)
        if pos and isinstance(pos[-1], EmpMCTuner):
            assert tuner is None
            tuner = pos.pop()
        for a in pos:
            if isinstance(a, bool):
                assert store_leaps is None
                store_leaps = a
            elif isinstance(a, int):
                assert n_leaps is None
                n_leaps = a
            elif isinstance(a, float):
                assert leap_step is None
                leap_step = a
            else:
                raise TypeError(f"unexpected HMC argument {a!r}")
        n_leaps = n_leaps if n_leaps is not None else (init if init is not None else 10)
        leap_step = leap_step if leap_step is not None else (
            scale if scale is not None else 0.1
        )
        store_leaps = store_leaps if store_leaps is not None else (
            leaps if leaps is not None else False
        )
        assert n_leaps > 0, "inner steps should be > 0"
        assert leap_step > 0, "inner steps scaling should be > 0"
        object.__setattr__(self, "n_leaps", int(n_leaps))
        object.__setattr__(self, "leap_step", float(leap_step))
        object.__setattr__(self, "store_leaps", bool(store_leaps))
        object.__setattr__(self, "tuner", tuner)
        mass_kind(mass_adapt)  # validate early
        object.__setattr__(self, "mass_adapt", mass_adapt)
        get_integrator(integrator)  # validate early
        object.__setattr__(self, "integrator", integrator)

    @property
    def _kind(self):
        return mass_kind(self.mass_adapt)

    # -- protocol ----------------------------------------------------------
    def init(self, model, theta0, generator=None):
        lp, g = model.evalallg(theta0)
        shape = tuple(theta0.shape[:-1])
        return HMCState(
            pars=theta0, logtarget=lp, grad=g,
            tune=tuner_init(self.leap_step, self.n_leaps, shape,
                            theta0.dtype, theta0.device),
            i=torch.ones(shape, dtype=torch.int32, device=theta0.device),
            mass=mass_init(self._kind, theta0.shape[-1], theta0.dtype,
                           theta0.device, shape),
        )

    def reset(self, model, state, theta):
        lp, g = model.evalallg(theta)
        return state.replace(pars=theta, logtarget=lp, grad=g)

    def _max_leaps(self):
        return self.tuner.max_step if self.tuner is not None else self.n_leaps

    def step(self, model, ctx: RunCtx, state, generator):
        pars0 = state.pars
        if self.tuner is not None:
            # per-chain step, broadcast over the parameter dimension
            eps = state.tune.step_size.to(pars0.dtype).unsqueeze(-1)
            nl = state.tune.n_leaps
        else:
            eps = self.leap_step
            nl = None
        kind = self._kind
        work_model, z0, g0, to_theta = model, pars0, state.grad, None
        if kind == "dense":
            # standardized coordinates theta = L z: unit-metric dynamics in
            # z are dynamics with the dense inverse mass L L' in theta
            fwd, inv, gfwd, ginv = dense_transforms(
                state.mass.scale.to(pars0.dtype))
            work_model, z0, g0, to_theta = (z_model(model, fwd, gfwd),
                                            inv(pars0), gfwd(state.grad), fwd)
        elif kind is not None:
            # vector leapfrog step = eps * scale: diagonal mass
            # preconditioning folded into the integrator
            eps = eps * mass_vector_scale(kind, state.mass, pars0.dtype)

        m0 = torch.randn(pars0.shape, generator=generator, dtype=pars0.dtype,
                         device=pars0.device)
        H0 = hamiltonian(state.logtarget, m0)
        step_fn, _ = get_integrator(self.integrator)

        carry = (z0, state.logtarget, g0, m0)

        def advance(carry, j):
            new = step_fn(work_model, carry[0], carry[3], carry[2], eps)
            if nl is None:
                return new
            live = j < nl  # chains whose trajectory is still running
            return tuple(
                torch.where(live.reshape(live.shape + (1,) * (b.ndim - live.ndim)),
                            b, a)
                for a, b in zip(carry, new))

        extra = {}
        if not self.store_leaps:
            n_iter = self.n_leaps if nl is None else int(nl.max())
            for j in range(n_iter):
                carry = advance(carry, j)
        else:
            traj_pars, traj_H = [], []
            for j in range(self._max_leaps()):
                carry = advance(carry, j)
                # dense: trajectories back to theta-space
                traj_pars.append(carry[0] if to_theta is None
                                 else to_theta(carry[0]))
                traj_H.append(hamiltonian(carry[1], carry[3]))
            # rows are stacked on a new axis after the chain dimension, the
            # per-chain layout of the JAX package's (n_leaps+1, d) buffers
            ax = pars0.ndim - 1
            extra = {
                "leaps_pars": torch.stack([pars0] + traj_pars, dim=ax),
                "leaps_H": torch.stack([H0] + traj_H, dim=ax),
                "leaps_n": (nl if nl is not None else torch.full(
                    H0.shape, self.n_leaps, dtype=torch.int32,
                    device=H0.device)),
            }
        pars, lp, g, m = carry
        if kind == "dense":  # back to theta-space
            pars, g = fwd(pars), ginv(g)

        ratio = H0 - hamiltonian(lp, m)
        accept = metropolis_accept(generator, ratio)
        a = accept.unsqueeze(-1)
        new_pars = torch.where(a, pars, state.pars)
        new_lp = torch.where(accept, lp, state.logtarget)
        new_grad = torch.where(a, g, state.grad)

        tune = tuner_update(self.tuner, state.tune, state.i, accept,
                            ctx.burnin, with_leaps=True)
        # mass-warmup accumulator transition on the post-accept position
        mass = mass_update(kind, state.mass, new_pars, state.i, ctx.burnin)

        info = {
            "ppars": new_pars,
            "plogtarget": new_lp,
            "pgrads": new_grad,
            "pars": state.pars,
            "logtarget": state.logtarget,
            "grads": state.grad,
            "accept": accept,
            **extra,
        }
        return (
            HMCState(pars=new_pars, logtarget=new_lp, grad=new_grad, tune=tune,
                     i=state.i + 1, mass=mass),
            info,
        )
