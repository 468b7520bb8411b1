"""Convergence-gated runner: sample until cross-chain diagnostics pass (port
of ``mcmc_jl_tpu/runners/convergence.py``).

The reference runs a fixed step count and leaves convergence assessment to
the user.  With many cheap chains on one device the natural workflow is run
until converged: advance all chains ``check_every`` steps at a time (states
carried exactly), then gate on split/rank R-hat (Vehtari et al. 2021) and
pooled ESS over the retained draws.  Once the adaptation window is consumed
the blocks are fixed-kernel MCMC, and those that a fused route takes run
through the CUDA kernels (``make_fused_continuation``: exact NUTS on a GLM
through kernel 9 or 8, the HMC family through kernel 3b or 4, catalog
targets through kernels 5 and 8b).

``run_until`` is deterministic given a seed: stopping early never biases
the retained draws (the gate reads diagnostics only).
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Tuple

import numpy as np

from ..samplers.base import make_generator
from ..stats.multichain import ess_pooled, rhat


@dataclasses.dataclass
class ConvergenceResult:
    """Result of :func:`run_until`.

    ``samples``: (kept_steps, n_chains, d) retained draws (post-warmup,
    second-half window at the stopping point).
    ``history``: [(steps_run, max_rhat, min_ess)] one row per check.
    ``states``: final batched sampler states (resume-ready).
    ``key``: the generator state to continue with (``get_state()``).
    """

    samples: np.ndarray
    converged: bool
    steps_run: int
    rhat: np.ndarray
    ess: np.ndarray
    history: List[Tuple[int, float, float]]
    states: Any
    key: Any

    @property
    def max_rhat(self):
        return float(np.max(self.rhat))

    @property
    def min_ess(self):
        return float(np.min(self.ess))


def run_until(model, sampler, n_chains=8, *, rhat_target=1.01, min_ess=400,
              check_every=500, max_steps=100_000, warmup=None,
              method="rank", seed=0, generator=None, inits=None, jitter=0.1,
              verbose=False, fused="auto"):
    """Run ``n_chains`` chains until R-hat and pooled-ESS gates pass.

    Blocks of ``check_every`` steps are advanced on the model's device
    (states carried exactly, so adaptation behaves as one continuous run
    with ``burnin=warmup``); after each block the gates are evaluated on
    the draws after ``max(warmup, steps_run // 2)``.  Stops when ``max
    R-hat <= rhat_target`` and ``min pooled ESS >= min_ess``, or at
    ``max_steps``.  The chains start at ``model.init`` plus ``jitter``
    standard normals (or at ``inits``).

    ``method``: "rank" (Vehtari-2021 bulk/tail, default) or "split"
    (classic Gelman-Rubin): see :func:`mcmc_jl_tpu_torch.stats.rhat`.

    ``fused``: once ``steps_run >= warmup`` the adaptation state is frozen
    (tuners are burn-in gated), so every further block is fixed-kernel
    MCMC.  :func:`~..parallel.pchains.continuation_route` decides then,
    once, whether those blocks continue through
    :func:`~..ops.warmstart.make_fused_continuation`, built once from the
    states of that moment ("auto": a float32 model on a CUDA device;
    ``True``: whenever the kernels take the shape, their plain versions on
    the CPU; ``False``: the generic engine throughout).
    ``mesh=`` is not taken (ROADMAP: the distributed drivers)."""
    from ..parallel.pchains import (continuation_route, init_chains,
                                    run_chains)

    assert n_chains >= 2, "cross-chain gates need >= 2 chains"
    warmup = check_every if warmup is None else warmup
    sampler.check(model)
    if generator is None:
        generator = make_generator(model.device, seed)
    states = init_chains(model, sampler, n_chains, generator, inits=inits,
                         jitter=jitter)

    class _Blk:  # minimal runner shim for run_chains
        len = check_every
        burnin = warmup
        thinning = 1

    blocks: List[np.ndarray] = []
    history: List[Tuple[int, float, float]] = []
    steps_run = 0
    converged = False
    use_cont = None  # decided once the adaptation window is consumed
    cont_fn = None
    r = e = None
    while steps_run < max_steps:
        if use_cont:
            if cont_fn is None:
                # one freeze and fold: every later block reuses the staged
                # design, prior fold and frozen hyper-parameters
                from ..ops.warmstart import make_fused_continuation

                cont_fn = make_fused_continuation(model, sampler, states)
            infos, states = cont_fn(states, check_every, generator)
        else:
            infos, states, generator = run_chains(
                model, sampler, _Blk, n_chains, generator=generator,
                states=states)
        blocks.append(infos["ppars"].cpu().numpy())
        steps_run += check_every
        if use_cont is None and steps_run >= warmup:
            use_cont = continuation_route(model, sampler, n_chains, fused,
                                          states=states)
        x = np.concatenate(blocks, axis=0)
        keep = x[max(warmup, steps_run // 2):]
        if keep.shape[0] < 4:
            continue
        r = np.asarray(rhat(keep, method=method))
        e = np.asarray(ess_pooled(keep))
        history.append((steps_run, float(np.max(r)), float(np.min(e))))
        if verbose:
            print(f"run_until: {steps_run} steps, max R-hat "
                  f"{np.max(r):.4f}, min ESS {np.min(e):.0f}")
        if np.max(r) <= rhat_target and np.min(e) >= min_ess:
            converged = True
            break

    x = np.concatenate(blocks, axis=0)
    keep = x[max(warmup, steps_run // 2):]
    if r is None:
        r = np.asarray(rhat(keep, method=method))
        e = np.asarray(ess_pooled(keep))
    return ConvergenceResult(
        samples=keep, converged=converged, steps_run=steps_run,
        rhat=r, ess=e, history=history, states=states,
        key=generator.get_state(),
    )
