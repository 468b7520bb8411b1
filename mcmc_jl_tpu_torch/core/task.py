"""Task composition: ``chain = model * sampler * runner``
(port of ``mcmc_jl_tpu/core/task.py``).

The reference overloads ``*`` eight ways over scalars/arrays of models,
samplers and runners (reference: src/MCMC.jl:87-98) and spins a Julia
coroutine per combination (``spinTask``, samplers.jl:53).  Here a
:class:`MCMCTask` is a *plain record* — the sampler state is an explicit
dataclass of tensors created lazily by the runner, which is what makes exact
resume and batching chains on a leading dimension possible (SURVEY §3.1, §5).
"""
from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass
class MCMCTask:
    """model x sampler x runner (+ live state after a run, for resume)."""

    model: Any
    sampler: Any
    runner: Any
    # Live continuation (replaces the stored coroutine, MCMC.jl:33-39):
    state: Any = None  # sampler state after the last run
    key: Any = None  # torch.Generator state (get_state()) to continue with
    pos: int = 0  # number of steps consumed so far

    def __mul__(self, other):
        raise TypeError("MCMCTask is already fully combined")


class _Partial:
    """model * sampler, awaiting a runner."""

    def __init__(self, models, samplers):
        self.models = models
        self.samplers = samplers

    def __mul__(self, runner):
        runners = runner if isinstance(runner, (list, tuple)) else [runner]
        return _combine(self.models, self.samplers, list(runners))


def _broadcast(*lists):
    n = max(len(l) for l in lists)
    out = []
    for l in lists:
        if len(l) == 1:
            out.append(l * n)
        else:
            assert len(l) == n, "mismatched lengths in model*sampler*runner arrays"
            out.append(l)
    return out


def _combine(models, samplers, runners):
    models, samplers, runners = _broadcast(models, samplers, runners)
    tasks = [MCMCTask(m, s, r) for m, s, r in zip(models, samplers, runners)]
    return tasks[0] if len(tasks) == 1 else tasks


def product(model_or_models, sampler_or_samplers):
    """Build the intermediate model*sampler product (handles arrays on
    either side, covering the reference's 8 ``*`` overloads)."""
    s = sampler_or_samplers
    if not isinstance(s, (list, tuple)) and getattr(
        s, "_samplerless_runner", False
    ):
        # model * AIES(...): runners whose move IS the sampler complete the
        # task directly (no sampler slot)
        m = model_or_models
        if isinstance(m, (list, tuple)):
            return [MCMCTask(mi, None, s) for mi in m]
        return MCMCTask(m, None, s)
    models = (
        list(model_or_models)
        if isinstance(model_or_models, (list, tuple))
        else [model_or_models]
    )
    samplers = (
        list(sampler_or_samplers)
        if isinstance(sampler_or_samplers, (list, tuple))
        else [sampler_or_samplers]
    )
    return _Partial(models, samplers)
