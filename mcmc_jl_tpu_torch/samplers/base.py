"""Common sampler machinery (port of ``mcmc_jl_tpu/samplers/base.py``).

A sampler is a transition kernel on tensors

    ``init(model, theta0, generator) -> state``
    ``step(model, ctx, state, generator) -> (state, info)``

where ``theta0`` is ``(d,)`` for one chain or ``(C, d)`` for C chains on a
leading dimension: every state field and info entry carries the same leading
chain shape.  States are frozen dataclasses of tensors; :func:`tree_map`
walks them the way ``jax.tree_util.tree_map`` walks the JAX package's
pytrees, so resume and per-chain slicing need no per-sampler code.  Where the
JAX package takes a PRNG key, the port takes a ``torch.Generator`` on the
model's device.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


def state_dataclass(cls):
    """Frozen dataclass whose fields are tensors or nested state dataclasses
    (the role of ``pytree_dataclass``); adds ``replace``."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    cls.replace = dataclasses.replace
    return cls


def tree_map(fn, tree, *rest):
    """Apply ``fn`` to every tensor leaf of a state dataclass (or of
    dataclasses of the same structure, leafwise)."""
    if dataclasses.is_dataclass(tree):
        return type(tree)(**{
            f.name: tree_map(fn, getattr(tree, f.name),
                             *(getattr(r, f.name) for r in rest))
            for f in dataclasses.fields(tree)})
    return fn(tree, *rest)


def make_generator(device, seed=None, state=None):
    """A ``torch.Generator`` on ``device``, seeded, or restored from a state
    taken with ``get_state()``."""
    g = torch.Generator(device=torch.device(device))
    if state is not None:
        g.set_state(state)
    elif seed is not None:
        g.manual_seed(int(seed))
    return g


@dataclasses.dataclass(frozen=True)
class RunCtx:
    """Static per-run context handed to ``step`` (burn-in length for
    adaptation gating — the role runner.burnin plays in e.g. HMC.jl:167)."""

    burnin: int = 0


def metropolis_accept(generator, ratio):
    """The reference's accept test ``ratio > 0 || ratio > log(rand())``
    (e.g. RWM.jl:63), made NaN-safe: a NaN ratio (e.g. -inf - -inf) rejects.
    One uniform per entry of ``ratio`` (one per chain)."""
    u = torch.log(torch.rand(ratio.shape, generator=generator,
                             dtype=ratio.dtype, device=ratio.device))
    return accept_given(ratio, u)


def accept_given(ratio, log_u):
    """:func:`metropolis_accept` on a given ``log_u`` (log of the uniform
    draw), for samplers whose transition is a function of its draws."""
    return torch.where(torch.isnan(ratio), False,
                       (ratio > 0) | (ratio > log_u))


def _bcast(mask, x):
    """Broadcast a per-chain mask over the trailing dimensions of ``x``."""
    return mask.reshape(mask.shape + (1,) * (x.ndim - mask.ndim))


def _where(mask, a, b):
    """Per-chain select: ``mask`` has the chain shape, ``a``/``b`` may carry
    trailing dimensions."""
    return torch.where(_bcast(mask, a), a, b)


def mh_select(accept, proposed, current):
    """Select proposed/current fields per chain on acceptance (the
    `if accepted` branch of every reference sampler, as a select)."""
    return tree_map(lambda p, c: torch.where(_bcast(accept, p), p, c),
                    proposed, current)


class Sampler:
    """Base sampler configuration (hyper-parameters are static)."""

    #: capability requirements checked against the model
    needs_gradient = False
    needs_tensor = False
    needs_dtensor = False

    def check(self, model):
        name = type(self).__name__
        if self.needs_gradient and not model.hasgradient:
            raise ValueError(f"{name} sampler requires model with gradient function")
        if self.needs_tensor and not model.hastensor:
            raise ValueError(f"{name} sampler requires model with tensor function")
        if self.needs_dtensor and not model.hasdtensor:
            raise ValueError(
                f"{name} sampler requires model with function of tensor derivatives"
            )

    # -- protocol ----------------------------------------------------------
    def init(self, model, theta0, generator):
        raise NotImplementedError

    def step(self, model, ctx: RunCtx, state, generator):
        raise NotImplementedError

    def reset(self, model, state, theta):
        """Functional replacement of the coroutine reset hook (MCMC.jl:39)."""
        raise NotImplementedError

    # -- composition sugar: model * sampler * runner ------------------------
    def __rmul__(self, other):
        from ..core.task import product

        return product(other, self)

    def __repr__(self):
        if dataclasses.is_dataclass(self):
            args = ", ".join(
                f"{f.name}={getattr(self, f.name)!r}" for f in dataclasses.fields(self)
            )
            return f"{type(self).__name__}({args})"
        return type(self).__name__


# =========================================================================
# Empirical tuner (reference samplers.jl:31-50) — shared by MALA/HMC/manifold
# =========================================================================


@dataclasses.dataclass(frozen=True)
class EmpMCTuner:
    """Empirical burn-in tuner: every ``adapt_step`` iterations rescale the
    step by a logistic factor of the realized acceptance rate
    (reference samplers.jl:31-50; adapt rule MALA.jl:36-39 / HMC.jl:37-43)."""

    target_rate: float
    adapt_step: int = 100
    max_step: int = 200
    target_path: float = 1.0
    verbose: bool = False

    def __post_init__(self):
        if self.adapt_step <= 0:
            raise ValueError("Adaptation step size should be > 0")
        if self.max_step <= 0:
            raise ValueError("Max step should be > 0")
        if not 0 < self.target_rate < 1:
            raise ValueError("Target acceptance rate should be in (0, 1)")


@state_dataclass
class TuneState:
    """Carried adaptation counters (EmpiricalMALATune / EmpiricalHMCTune)."""

    step_size: torch.Tensor  # driftStep or leapStep
    n_leaps: torch.Tensor  # int; unused by MALA-family
    accepted: torch.Tensor  # int
    proposed: torch.Tensor  # int


def tuner_init(step_size, n_leaps=1, shape=(), dtype=None, device=None):
    """Fresh counters with leading chain ``shape``."""
    dtype = dtype or torch.get_default_dtype()
    full = lambda v, dt: torch.full(shape, v, dtype=dt, device=device)  # noqa: E731
    return TuneState(
        step_size=full(float(step_size), dtype),
        n_leaps=full(int(n_leaps), torch.int32),
        accepted=full(0, torch.int32),
        proposed=full(0, torch.int32),
    )


def tuner_update(tuner: Optional[EmpMCTuner], tune: TuneState, i, accepted,
                 burnin, with_leaps=False):
    """One post-step tuner transition.

    Increments counters, and — when ``i <= burnin`` and ``i % adapt_step == 0``
    — applies the logistic step-size update
    ``step *= 1/(1+exp(-11*(rate-target))) + 0.5`` and (for HMC-family)
    ``n_leaps = min(max_step, ceil(target_path / step))``, then zeroes the
    counters (reference MALA.jl:36-43, HMC.jl:37-47, usage HMC.jl:167-173).
    """
    if tuner is None:
        return tune
    acc = tune.accepted + accepted.to(torch.int32)
    prop = tune.proposed + 1
    do_adapt = (i <= burnin) & (torch.remainder(i, tuner.adapt_step) == 0)
    rate = acc.to(tune.step_size.dtype) / torch.clamp(prop, min=1)
    factor = 1.0 / (1.0 + torch.exp(-11.0 * (rate - tuner.target_rate))) + 0.5
    new_step = torch.where(do_adapt, tune.step_size * factor, tune.step_size)
    if with_leaps:
        new_leaps = torch.where(
            do_adapt,
            torch.clamp(torch.ceil(tuner.target_path / new_step),
                        max=tuner.max_step).to(torch.int32),
            tune.n_leaps,
        )
    else:
        new_leaps = tune.n_leaps
    zero = torch.zeros_like(acc)
    return TuneState(
        step_size=new_step,
        n_leaps=new_leaps,
        accepted=torch.where(do_adapt, zero, acc),
        proposed=torch.where(do_adapt, zero, prop),
    )
