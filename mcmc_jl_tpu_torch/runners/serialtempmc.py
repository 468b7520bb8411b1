"""Serial tempering runner (port of ``mcmc_jl_tpu/runners/serialtempmc.py``;
reference: src/runners/SerialTempMC.jl; Geyer, "Bayes Factors via Serial
Tempering").

An array of tasks forms the temperature ladder; one walker moves through it.
Every ``swap_period`` steps a random other rung is proposed: the walker's
position is written into that rung's sampler state (the functional form of
the reference's live-coroutine ``reset``, SerialTempMC.jl:62), one step is
taken there, and the rung swap is Metropolis-accepted on
``logtarget - logtarget2 + logW2 - logW1`` (SerialTempMC.jl:57-66).  The
reference leaves logW adaptation as a TODO (SerialTempMC.jl:71); an
optional Wang-Landau-style adaptation ships (``adapt_weights=True``).

One host loop serves every ladder, homogeneous or mixing sampler types
(the JAX package compiles one ``lax.scan`` with stacked or tupled rung
states, or runs a host loop with ``compiled=False``).  The finished tasks
carry the rung states and the walker, so ``resume`` continues them.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..core.chain import MCMCChain
from ..core.task import MCMCTask
from ..samplers.base import RunCtx, make_generator
from ..utils.table import Table


@dataclasses.dataclass(frozen=True)
class SerialTempMC:
    steps: int = 1
    burnin: int = 0
    swap_period: int = 5
    adapt_weights: bool = False

    def __post_init__(self):
        assert self.burnin >= 0, f"Burnin rounds ({self.burnin}) should be >= 0"
        assert self.steps > self.burnin, (
            f"Steps ({self.steps}) should be > to burnin ({self.burnin})"
        )

    def __rmul__(self, other):
        from ..core.task import product

        return product(other, self)


def _swap_draws(generator, nmods, dtype, device):
    """A swap step's draws: the raw rung pick, ``randint(0, nmods - 1)``,
    and the log-uniform of its accept test."""
    raw = int(torch.randint(0, nmods - 1, (), generator=generator,
                            device=device))
    return raw, torch.log(torch.rand((), generator=generator, dtype=dtype,
                                     device=device))


def _pick_rung(raw, at):
    """Another rung, uniformly (SerialTempMC.jl:58-60): ``raw`` is a draw
    of ``randint(0, nmods - 1)``, shifted past the current rung ``at``."""
    return raw + 1 if raw >= at else raw


def _swap_take(logtarget, lp_pre, logW, at, at2, log_u):
    """The Metropolis rung swap on tempered weights (SerialTempMC.jl:62-66):
    ``lp_pre`` is rung ``at2``'s log-target at the walker's position (its
    step's pre-step value after the reset); a NaN ratio rejects."""
    ratio = logtarget - lp_pre + logW[at2] - logW[at]
    return bool(torch.where(torch.isnan(ratio), False, log_u < ratio))


def _wang_landau(logW, at, i):
    """The optional weight adaptation after step ``i`` on rung ``at``."""
    logW = logW.clone()
    logW[at] -= 1.0 / i
    return logW


def run_serialtempmc(tasks, seed: int = 0, compiled: bool = True):
    """Run one walker through the ladder of ``tasks``.  ``compiled`` is
    accepted for the JAX package's signature and changes nothing: both of
    its routes are this one host loop.  A ladder whose last task carries a
    finished run's state (``resume``) continues its rung states and walker
    on its stored generator state."""
    nmods = len(tasks)
    last = tasks[-1]
    tsize, runner = last.model.size, last.runner
    steps, burnin, swap_period = runner.steps, runner.burnin, runner.swap_period
    assert all(t.model.size == tsize for t in tasks), (
        "Models do not have the same parameter vector size"
    )
    for t in tasks:
        t.sampler.check(t.model)
    models = [t.model for t in tasks]
    samplers = [t.sampler for t in tasks]
    ctxs = [RunCtx(burnin=t.runner.burnin) for t in tasks]

    t0 = time.time()
    carried = last.state if isinstance(last.state, dict) else None
    generator = make_generator(last.model.device, seed,
                               state=None if carried is None else last.key)
    if carried is not None:
        states = list(carried["states"])
        at, pars = int(carried["at"]), carried["pars"]
        logtarget, logW = carried["logtarget"], carried["logW"]
    else:
        states = [s.init(m, m.init, generator)
                  for m, s in zip(models, samplers)]
        # the walker starts from one step of rung 0 (SerialTempMC.jl:52-55);
        # as in the JAX package's default (compiled) route, the rung states
        # start from their inits
        at = 0
        _, info = samplers[0].step(models[0], ctxs[0], states[0], generator)
        pars, logtarget = info["ppars"], info["plogtarget"]
        logW = torch.zeros(nmods, dtype=pars.dtype, device=pars.device)

    all_pars, all_at = [], []
    for i in range(1, steps + 1):
        do_swap = i % swap_period == 0
        target = at
        if do_swap:
            raw, log_u = _swap_draws(generator, nmods, pars.dtype,
                                     pars.device)
            target = _pick_rung(raw, at)
            st = samplers[target].reset(models[target], states[target], pars)
        else:
            st = states[target]
        states[target], info = samplers[target].step(models[target],
                                                     ctxs[target], st,
                                                     generator)
        # NOTE deliberate deviation from the reference, which carries the
        # stale pre-step lp as the walker's own density (SerialTempMC.jl:52,
        # 72): the walker carries plogtarget, so the swap ratio compares
        # both rungs at the position the walker actually holds
        take = True
        if do_swap:
            take = _swap_take(logtarget, info["logtarget"], logW, at,
                              target, log_u)
            if take:
                at = target
        if take:
            pars, logtarget = info["ppars"], info["plogtarget"]
        if runner.adapt_weights:
            logW = _wang_landau(logW, at, i)
        if i > burnin:
            all_pars.append(pars)
            all_at.append(at)

    samples = torch.stack(all_pars).cpu().numpy()
    carry = {"states": tuple(states), "at": at, "pars": pars,
             "logtarget": logtarget, "logW": logW}
    key = generator.get_state()
    new_tasks = [MCMCTask(t.model, t.sampler, t.runner, state=carry, key=key,
                          pos=t.pos + steps) for t in tasks]
    cn = last.model.column_names()
    return MCMCChain(
        range=range(burnin + 1, steps + 1),
        samples=Table(samples, cn),
        gradients=Table(np.zeros((0, tsize)), cn),
        diagnostics={"mod": np.asarray(all_at, dtype=np.int64) + 1,
                     "logW": logW.cpu().numpy()},
        task=new_tasks,
        run_time=time.time() - t0,
    )


def resume_serialtempmc(tasks, steps: int = 100, **kwargs):
    """Continue a SerialTempMC run from the rung states and walker its
    finished tasks carry."""
    from .api import run

    new = [
        MCMCTask(t.model, t.sampler,
                 dataclasses.replace(t.runner, steps=steps, burnin=0),
                 state=t.state, key=t.key, pos=t.pos)
        for t in tasks
    ]
    return run(new, **kwargs)
