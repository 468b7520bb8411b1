"""Sequential / population Monte Carlo runner (port of
``mcmc_jl_tpu/runners/seqmc.py``; reference: src/runners/SeqMC.jl; Jasra,
Stephens & Holmes).

The reference mutates one live coroutine per target, resetting it to each
particle in turn (SeqMC.jl:62-72).  Here particles are the leading batch
dimension: each step walks the target ladder, every particle advances under
each target as one batch ("reset" is writing the batched state's
``pars``), importance weights update per SeqMC.jl:70, and the particles
are resampled on their device when ``var(exp(logW)) < trigger``
(SeqMC.jl:76-88; an ESS-fraction criterion is available via
``ess_trigger``).  The JAX package's ``lax.scan`` is a host loop.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from ..core.chain import MCMCChain
from ..core.task import MCMCTask
from ..samplers.base import RunCtx, make_generator
from ..utils.table import Table
from .asmc import _resample_idx


@dataclasses.dataclass(frozen=True)
class SeqMC:
    steps: int = 1
    burnin: int = 0
    trigger: float = 1e-10
    ess_trigger: Optional[float] = None  # fraction of npart; alternative criterion
    #: "multinomial" (reference parity, SeqMC.jl:79-86) | "systematic" |
    #: "stratified" (the low-variance comb resamplers)
    resampling: str = "multinomial"

    def __post_init__(self):
        assert self.burnin >= 0, f"Burnin rounds ({self.burnin}) should be >= 0"
        assert self.steps > self.burnin, (
            f"Steps ({self.steps}) should be > to burnin ({self.burnin})"
        )
        assert self.resampling in ("multinomial", "systematic", "stratified"), (
            f"unknown resampling {self.resampling!r}"
        )

    def __rmul__(self, other):
        from ..core.task import product

        return product(other, self)


def _target_step(model, sampler, ctx, states, pars, logW, logtarget,
                 generator):
    """Advance every particle one step under one target (SeqMC.jl:66-72)."""
    # "reset" each particle's state to its particle value (SeqMC.jl:67)
    states = sampler.reset(model, states, pars)
    states, infos = sampler.step(model, ctx, states, generator)
    # the log-target at the reset particle (pre-proposal)
    logW = logW + infos["logtarget"] - logtarget
    return states, infos["ppars"], logW, infos["plogtarget"]


def _resample_given(pars, logW, logtarget, idx, do):
    """Where ``do``: the particles at ancestors ``idx`` with zero
    log-weights; else all unchanged."""
    return (torch.where(do, pars[idx], pars),
            torch.where(do, torch.zeros_like(logW), logW),
            torch.where(do, logtarget[idx], logtarget))


def _resample(pars, logW, logtarget, generator, trigger, ess_trigger,
              method="multinomial"):
    """Resample when triggered (SeqMC.jl:76-88), on the particles' device.

    ``method``: "multinomial" (reference parity), or the low-variance comb
    schemes "systematic" (one uniform offset) / "stratified" (one uniform
    per stratum) by inverse-CDF search over the weight cumsum.  The draws
    are taken whether or not the trigger fires, as in the JAX package."""
    W = torch.exp(logW)
    npart = W.shape[0]
    if ess_trigger is not None:
        wn = W / W.sum()
        do = 1.0 / (wn * wn).sum() < ess_trigger * npart
    else:
        do = torch.var(W, correction=1) < trigger
    floor = max(1e-300, torch.finfo(W.dtype).tiny)
    idx = _resample_idx(generator, torch.log(W.clamp(min=floor)), npart,
                        method)
    return _resample_given(pars, logW, logtarget, idx, do)


def _seqmc_loop(models, samplers, ctxs, states, pars, logW, generator, *,
                steps, trigger, ess_trigger, resampling="multinomial"):
    states = list(states)
    logtarget = torch.zeros_like(logW)
    rows = {"pars": [], "W": [], "var": []}
    for _ in range(steps):
        for ti in range(len(samplers)):  # the target ladder (SeqMC.jl:64)
            states[ti], pars, logW, logtarget = _target_step(
                models[ti], samplers[ti], ctxs[ti], states[ti], pars, logW,
                logtarget, generator)
            pars, logW, logtarget = _resample(pars, logW, logtarget,
                                              generator, trigger, ess_trigger,
                                              method=resampling)
        W = torch.exp(logW)
        rows["pars"].append(pars)
        rows["W"].append(W)
        rows["var"].append(torch.var(W, correction=1))
        # reference-exact: the carried log-target resets to zero after every
        # full ladder pass (SeqMC.jl:91 `logtarget = zeros(npart)`), so each
        # pass's first weight update is ll0 - 0, not a telescoping ratio
        # against the previous pass's final target
        logtarget = torch.zeros_like(logW)
    return tuple(states), pars, logW, {k: torch.stack(v)
                                       for k, v in rows.items()}


def run_seqmc(targets, particles=None, seed: int = 0, verbose: bool = False):
    """Run the particles through the ladder of ``targets`` (one task per
    target; the last task's runner sets the run).  A ladder whose last task
    carries a finished run's state (``resume``) continues its particles,
    weights and per-target sampler states on its stored generator
    state."""
    ntargets = len(targets)
    last = targets[-1]
    tsize, runner = last.model.size, last.runner
    steps, burnin = runner.steps, runner.burnin
    assert all(t.model.size == tsize for t in targets), (
        "Models do not have the same parameter vector size"
    )
    for t in targets:
        t.sampler.check(t.model)
    dtype, dev = last.model.dtype, last.model.device

    t0 = time.time()
    carried = last.state if isinstance(last.state, dict) else None
    generator = make_generator(dev, seed,
                               state=None if carried is None else last.key)

    if carried is not None:
        pars = torch.as_tensor(carried["pars"], dtype=dtype, device=dev)
    elif particles is None:
        pars = torch.randn((100, tsize), generator=generator, dtype=dtype,
                           device=dev)
    else:
        pars = torch.as_tensor(np.asarray(particles, dtype=np.float64),
                               dtype=dtype, device=dev)
    if pars.ndim == 1:
        pars = pars[:, None]
    npart = pars.shape[0]

    # per-target batched sampler states (replaces one coroutine per target);
    # exact continuation reuses the carried ones (tuner and dual-averaging
    # adaptation included) when they match the ladder and the particles
    states = None
    if carried is not None:
        c_states = carried.get("states")
        if c_states is not None and len(c_states) == ntargets \
                and c_states[0].pars.shape[0] == npart:
            states = list(c_states)
    if states is None:
        states = [t.sampler.init(t.model, pars, generator) for t in targets]
    logW0 = torch.zeros(npart, dtype=dtype, device=dev)
    if carried is not None and "logW" in carried:
        logW0 = torch.as_tensor(carried["logW"], dtype=dtype, device=dev)

    states, pars, logW, ys = _seqmc_loop(
        [t.model for t in targets], [t.sampler for t in targets],
        [RunCtx(burnin=t.runner.burnin) for t in targets], states, pars,
        logW0, generator, steps=steps, trigger=runner.trigger,
        ess_trigger=runner.ess_trigger, resampling=runner.resampling)

    all_pars = ys["pars"].cpu().numpy()  # (steps, npart, d)
    all_W = ys["W"].cpu().numpy()
    if verbose:
        for i, v in enumerate(ys["var"].cpu().numpy(), start=1):
            print(f"iter {i}, var {float(v)}")

    samples = all_pars[burnin:].reshape(-1, tsize)
    weights = all_W[burnin:].reshape(-1)
    cn = last.model.column_names()
    nkept = steps - burnin
    # the live particle ensemble, for an exact resume (the reference's
    # resume_seqmc re-runs from scratch, SeqMC.jl:125-128)
    floor = max(1e-300, torch.finfo(dtype).tiny)
    final_carry = {
        "pars": pars,
        "logW": torch.log(ys["W"][-1].clamp(min=floor)),
        "states": states,
    }
    key = generator.get_state()
    new_targets = [
        MCMCTask(t.model, t.sampler, t.runner, state=final_carry, key=key,
                 pos=t.pos + steps)
        for t in targets
    ]
    return MCMCChain(
        range=range(burnin + 1, nkept * npart + 1),
        samples=Table(samples, cn),
        gradients=Table(np.zeros((0, tsize)), cn),
        diagnostics={
            "weigths": weights,  # [sic] reference key (SeqMC.jl:119)
            "weights": weights,
            "particle": np.tile(np.arange(1, npart + 1), nkept),
        },
        task=new_targets,
        run_time=time.time() - t0,
    )


def resume_seqmc(targets, steps: int = 100, **kwargs):
    """Continue a SeqMC run: the final particle ensemble, weights and
    per-target sampler states stored in the finished tasks start the new
    run."""
    from .api import run

    new = [
        MCMCTask(t.model, t.sampler,
                 dataclasses.replace(t.runner, steps=steps, burnin=0),
                 state=t.state, key=t.key, pos=t.pos)
        for t in targets
    ]
    return run(new, **kwargs)
