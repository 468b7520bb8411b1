"""SerialMC runner: the single-chain control loop (port of
``mcmc_jl_tpu/runners/serialmc.py``).

The reference's runner is a host loop that ``consume``s a coroutine once per
step and stores rows whose index falls in the kept range
(reference: src/runners/SerialMC.jl:37-85).  Here it is a Python loop over
``sampler.step`` on a one-chain state; the run's ``torch.Generator`` state
is stored on the returned chain's task, so ``resume`` continues exactly.
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
class SerialMC:
    """Keep range semantics identical to the reference (SerialMC.jl:12-35):
    ``SerialMC(steps=, burnin=, thinning=)`` or ``SerialMC(range(a, b, s))``
    keeps 1-based steps ``burnin+1 : thinning : steps``."""

    burnin: int
    thinning: int
    len: int
    r: range

    def __init__(self, steps=None, burnin=0, thinning=1):
        if isinstance(steps, range):
            r = steps
            assert r.step >= 1, "Thinning should be >= 1"
            burnin, thinning = r.start - 1, r.step
            last = r.start + (max(len(r) - 1, 0)) * r.step
            object.__setattr__(self, "burnin", burnin)
            object.__setattr__(self, "thinning", thinning)
            object.__setattr__(self, "len", last)
            object.__setattr__(self, "r", r)
        else:
            steps = 100 if steps is None else steps
            object.__setattr__(self, "burnin", burnin)
            object.__setattr__(self, "thinning", thinning)
            object.__setattr__(self, "len", steps)
            object.__setattr__(self, "r", range(burnin + 1, steps + 1, thinning))
        assert self.burnin >= 0, f"Burnin rounds ({self.burnin}) should be >= 0"
        assert self.len > self.burnin, (
            f"Total MCMC length ({self.len}) should be > to burnin ({self.burnin})"
        )
        assert self.thinning >= 1, f"Thinning ({self.thinning}) should be >= 1"

    def __rmul__(self, other):
        from ..core.task import product

        return product(other, self)


def run_serialmc(task: MCMCTask, seed: int = 0, generator=None) -> MCMCChain:
    """Run one chain.  The generator is, in order: ``generator``, one
    restored from ``task.key`` (a continuation), or a fresh one seeded by
    ``seed`` on the model's device."""
    model, sampler, runner = task.model, task.sampler, task.runner
    sampler.check(model)

    t0 = time.time()
    if generator is None:
        generator = make_generator(model.device, seed=seed, state=task.key)

    if task.state is None:
        state = sampler.init(model, model.init, generator)
        if not bool(torch.isfinite(state.logtarget)):
            raise ValueError("Initial values out of model support, try other values")
    else:
        state = task.state  # exact continuation

    ctx = RunCtx(burnin=runner.burnin)
    rows = {}
    for _ in range(runner.len):
        state, info = sampler.step(model, ctx, state, generator)
        for k, v in info.items():
            rows.setdefault(k, []).append(v)
    infos = {k: torch.stack(v).cpu().numpy() for k, v in rows.items()}

    chain = _chain_from_infos(infos, runner.r, model, task, state,
                              generator.get_state())
    chain.run_time = time.time() - t0
    return chain


def _chain_from_infos(infos, r, model, task, final_state, key):
    keep = np.asarray(list(r)) - 1  # 1-based kept steps -> 0-based rows
    cn = model.column_names()

    samples = Table(infos["ppars"][keep], cn)
    if "pgrads" in infos:
        gradients = Table(infos["pgrads"][keep], cn)
    else:
        gradients = Table(np.zeros((0, model.size)), cn)

    skip = {"ppars", "pgrads", "pars", "grads", "plogtarget", "logtarget"}
    diags = {"step": np.asarray(list(r))}
    for k, v in infos.items():
        if k not in skip:
            diags[k] = v[keep]
    diags["logtarget"] = infos["plogtarget"][keep]

    new_task = MCMCTask(
        model=task.model,
        sampler=task.sampler,
        runner=task.runner,
        state=final_state,
        key=key,
        pos=task.pos + task.runner.len,
    )
    return MCMCChain(range=r, samples=samples, gradients=gradients,
                     diagnostics=diags, task=new_task)


def resume_serialmc(task: MCMCTask, steps: int = 100) -> MCMCChain:
    """Exact resume: continue from the stored state and generator state
    (the reference restarts a fresh SerialMC and loses adaptive state,
    SerialMC.jl:93-97; here the tuner state carries over too)."""
    if not isinstance(task.runner, SerialMC):
        raise TypeError(f"resume_serialmc cannot be called on a task whose "
                        f"runner is {type(task.runner).__name__}")
    new_runner = SerialMC(steps=steps, thinning=task.runner.thinning)
    t = MCMCTask(task.model, task.sampler, new_runner, state=task.state,
                 key=task.key, pos=task.pos)
    return run_serialmc(t)
