"""run / resume / prun dispatch (port of ``mcmc_jl_tpu/runners/api.py``;
reference: src/runners/runners.jl).

``run`` dispatches on the runner type of a task (or array of tasks);
``resume`` continues a chain; ``prun`` is the multi-chain engine (the
reference's Julia-``pmap`` backend, runners.jl:35-42, redesigned as chains
on a leading tensor dimension — see :mod:`mcmc_jl_tpu_torch.parallel`).
Only the SerialMC runner is ported; the others are the ensemble runners
of the ROADMAP.
"""
from __future__ import annotations

from typing import Optional

from ..core.chain import MCMCChain
from ..core.task import MCMCTask, _Partial
from .serialmc import SerialMC, run_serialmc, resume_serialmc


def _not_ported(runner):
    return NotImplementedError(
        f"runner {type(runner).__name__} is not ported yet (ROADMAP: the "
        f"ensemble runners); the port runs SerialMC")


def _as_task(x, *rest):
    if rest:  # run(model, sampler, runner) sugar (runners.jl:45)
        sampler, runner = rest
        prod = x * sampler
        if isinstance(prod, _Partial):
            prod = prod * runner
        return prod
    return x


def run(x, *rest, seed: int = 0, chains: Optional[int] = None, **kwargs):
    """Run a task / array of tasks / (model, sampler, runner) triple.

    ``chains=N`` runs N identical chains as one batch and returns a list of
    N chains — sugar over :func:`prun`.  ``fused=`` is passed on to it.
    """
    t = _as_task(x, *rest)

    if isinstance(t, _Partial):
        raise TypeError("missing runner: use model * sampler * runner")

    if chains is not None:
        if not isinstance(t, MCMCTask):
            raise TypeError("chains= requires a single task")
        tasks = [MCMCTask(t.model, t.sampler, t.runner) for _ in range(chains)]
        return prun(tasks, seed=seed, **kwargs)

    if isinstance(t, MCMCChain):  # chain continuation alternate (runners.jl:14)
        return run(t.task, seed=seed, **kwargs)

    if isinstance(t, (list, tuple)):
        for ti in t:
            if not isinstance(ti.runner, SerialMC):
                raise _not_ported(ti.runner)
        return [run_serialmc(ti, seed=seed + i, **kwargs) for i, ti in enumerate(t)]

    if not isinstance(t, MCMCTask):
        raise TypeError(f"cannot run {type(t).__name__}")
    if isinstance(t.runner, SerialMC):
        return run_serialmc(t, seed=seed, **kwargs)
    raise _not_ported(t.runner)


def resume(x, *, steps: int = 100, **kwargs):
    """Continue a chain/task where it stopped (runners.jl:48-68) — exactly,
    since the sampler state and the generator state travel on the task.  A
    list of SerialMC chains re-batches by group and continues each group as
    one batch, through the fused kernels where the frozen state allows
    (:func:`mcmc_jl_tpu_torch.parallel.pchains.presume_serialmc`;
    ``fused=`` and ``seed=`` are passed on to it)."""
    if isinstance(x, MCMCChain):
        return resume(x.task, steps=steps, **kwargs)
    if isinstance(x, (list, tuple)):
        last = x[-1]
        runner = last.task.runner if isinstance(last, MCMCChain) \
            else last.runner
        if not isinstance(runner, SerialMC):
            raise _not_ported(runner)
        from ..parallel.pchains import presume_serialmc

        return presume_serialmc(list(x), steps=steps, **kwargs)
    if not isinstance(x, MCMCTask):
        raise TypeError(f"cannot resume {type(x).__name__}")
    if isinstance(x.runner, SerialMC):
        return resume_serialmc(x, steps=steps)
    raise _not_ported(x.runner)


def prun(tasks, seed: int = 0, **kwargs):
    """Parallel multi-chain run (reference runners.jl:35-42): identical
    chains are batched on a leading dimension of one device — see
    :func:`mcmc_jl_tpu_torch.parallel.pchains.prun_serialmc` (``fused=``)."""
    if isinstance(tasks, MCMCTask):
        tasks = [tasks]
    for t in tasks:
        if not isinstance(t.runner, SerialMC):
            raise _not_ported(t.runner)
    from ..parallel.pchains import prun_serialmc

    return prun_serialmc(list(tasks), seed=seed, **kwargs)
