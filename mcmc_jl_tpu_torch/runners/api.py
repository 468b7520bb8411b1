"""run / resume / prun dispatch (port of ``mcmc_jl_tpu/runners/api.py``;
reference: src/runners/runners.jl).

``run`` dispatches on the runner type of a task (or array of tasks);
``resume`` continues a chain; ``prun`` is the multi-chain engine (the
reference's Julia-``pmap`` backend, runners.jl:35-42, redesigned as chains
on a leading tensor dimension — see :mod:`mcmc_jl_tpu_torch.parallel`).
"""
from __future__ import annotations

from typing import Optional

from ..core.chain import MCMCChain
from ..core.task import MCMCTask, _Partial
from .aies import AIES, resume_aies, run_aies
from .asmc import ASMC, resume_asmc, run_asmc
from .ptmc import PTMC, resume_ptmc, run_ptmc
from .seqmc import SeqMC, resume_seqmc, run_seqmc
from .serialmc import SerialMC, run_serialmc, resume_serialmc
from .serialtempmc import SerialTempMC, resume_serialtempmc, run_serialtempmc


def _as_task(x, *rest):
    if rest:  # run(model, sampler, runner) sugar (runners.jl:45)
        sampler, runner = rest
        prod = x * sampler
        if isinstance(prod, _Partial):
            prod = prod * runner
        return prod
    return x


def _same_runner_type(runners):
    first = runners[-1]
    if not all(isinstance(r, type(first)) for r in runners):
        raise TypeError("Runners do not have the same runner type")
    return first


def run(x, *rest, seed: int = 0, chains: Optional[int] = None, **kwargs):
    """Run a task / array of tasks / (model, sampler, runner) triple.

    ``chains=N`` runs N identical chains as one batch and returns a list of
    N chains — sugar over :func:`prun`.  ``fused=`` is passed on to it.
    An array of SerialTempMC or SeqMC tasks is one tempering ladder or one
    target ladder (``particles=`` for SeqMC); a PTMC, AIES or ASMC task
    runs its ensemble.
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
        first = _same_runner_type([ti.runner for ti in t])
        if isinstance(first, SerialMC):
            return [run_serialmc(ti, seed=seed + i, **kwargs)
                    for i, ti in enumerate(t)]
        if isinstance(first, SerialTempMC):
            return run_serialtempmc(list(t), seed=seed, **kwargs)
        if isinstance(first, SeqMC):
            return run_seqmc(list(t), seed=seed, **kwargs)
        raise TypeError(f"unknown runner type {type(first).__name__}")

    if not isinstance(t, MCMCTask):
        raise TypeError(f"cannot run {type(t).__name__}")
    if isinstance(t.runner, SerialMC):
        return run_serialmc(t, seed=seed, **kwargs)
    if isinstance(t.runner, PTMC):
        return run_ptmc(t.model, t.sampler, t.runner, seed=seed, **kwargs)
    if isinstance(t.runner, AIES):
        return run_aies(t.model, t.runner, seed=seed, **kwargs)
    if isinstance(t.runner, ASMC):
        return run_asmc(t.model, t.sampler, t.runner, seed=seed, **kwargs)
    raise TypeError(f"unknown runner type {type(t.runner).__name__}")


def resume(x, *, steps: int = 100, **kwargs):
    """Continue a chain/task where it stopped (runners.jl:48-68) — exactly,
    since the sampler state and the generator state travel on the task.  A
    list of SerialMC chains re-batches by group and continues each group as
    one batch, through the fused kernels where the frozen state allows
    (:func:`mcmc_jl_tpu_torch.parallel.pchains.presume_serialmc`;
    ``fused=`` and ``seed=`` are passed on to it); a SerialTempMC or SeqMC
    ladder continues as one run; a list of PTMC chains (``walkers > 1``)
    resumes one ladder a chain; a list of AIES walker chains resumes the
    shared ensemble once."""
    if isinstance(x, MCMCChain):
        return resume(x.task, steps=steps, **kwargs)
    if isinstance(x, (list, tuple)):
        last = x[-1]
        first = last.task.runner if isinstance(last, MCMCChain) \
            else last.runner
        if isinstance(first, SerialMC):
            from ..parallel.pchains import presume_serialmc

            return presume_serialmc(list(x), steps=steps, **kwargs)
        if isinstance(first, SerialTempMC):
            return resume_serialtempmc(list(x), steps=steps, **kwargs)
        if isinstance(first, SeqMC):
            return resume_seqmc(list(x), steps=steps, **kwargs)
        if isinstance(first, PTMC):  # walkers > 1: one ladder per chain
            return [resume(t, steps=steps, **kwargs) for t in x]
        if isinstance(first, AIES):
            # every walker chain carries the same full-ensemble state:
            # resume once, return the whole new walker-chain list
            return resume(x[-1], steps=steps, **kwargs)
        raise TypeError(f"unknown runner type {type(first).__name__}")
    if not isinstance(x, MCMCTask):
        raise TypeError(f"cannot resume {type(x).__name__}")
    if isinstance(x.runner, SerialMC):
        return resume_serialmc(x, steps=steps)
    if isinstance(x.runner, PTMC):
        return resume_ptmc(x, steps=steps, **kwargs)
    if isinstance(x.runner, AIES):
        return resume_aies(x, steps=steps)
    if isinstance(x.runner, ASMC):
        return resume_asmc(x, steps=steps)
    raise TypeError(f"unknown runner type {type(x.runner).__name__}")


def prun(tasks, seed: int = 0, **kwargs):
    """Parallel multi-chain run (reference runners.jl:35-42): identical
    chains are batched on a leading dimension of one device — see
    :func:`mcmc_jl_tpu_torch.parallel.pchains.prun_serialmc` (``fused=``).
    It takes SerialMC runners; the ensemble runners batch their own
    chains (``PTMC(walkers=)``, ``AIES(walkers=)``, ``ASMC(particles=)``)."""
    if isinstance(tasks, MCMCTask):
        tasks = [tasks]
    first = _same_runner_type([t.runner for t in tasks])
    if not isinstance(first, SerialMC):
        raise TypeError(f"prun supports SerialMC runners, got "
                        f"{type(first).__name__}")
    from ..parallel.pchains import prun_serialmc

    return prun_serialmc(list(tasks), seed=seed, **kwargs)
