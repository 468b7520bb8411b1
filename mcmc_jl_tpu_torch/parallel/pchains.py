"""Parallel chain engine (port of ``mcmc_jl_tpu/parallel/pchains.py``).

Replaces the reference's distributed backend — Julia ``pmap`` of whole
chains over worker processes (reference: src/runners/runners.jl:35-42) —
with chains on a leading tensor dimension, advanced together by one Python
loop of batched tensor ops on one device.  Chains are independent, so the
batch is embarrassingly parallel.  Multi-GPU meshes are the ROADMAP item
"the distributed drivers".

``run_chains`` is the engine (returns stacked tensors, kept on the device);
``prun_serialmc`` adapts it to the reference's ``prun`` surface (a list of
per-task chains) and routes groups on GLM posteriors to the fused CUDA
kernels: plain HMC and plain MALA to the HMC drivers (ops/glm_hmc.py; above
``BIGN_THRESHOLD`` observations the N-tiled kernel, ops/glm_bign.py),
adaptive HMC, HMCDA, adaptive MALA, ChEES-HMC and exact NUTS to the
warm-start pipeline (ops/warmstart.py).  On a custom target that is a
product of catalog densities (``model.target_spec``) plain HMC and plain
MALA go to the custom-target kernels (ops/target_kernels.py), and the
adaptive samplers and exact NUTS to the warm-start pipeline's target arms;
other custom targets run on the generic engine.  Samplers that adapt from
cross-chain statistics (ChEES-HMC) expose ``pool``, which the engine calls
after every step.  ``presume_serialmc`` is the batched resume: a list of
chains re-batches by group, and frozen HMC-family and exact-NUTS groups
continue through the same kernels (``continuation_route``,
ops/warmstart.py ``fused_continue_chains``).
"""
from __future__ import annotations

import logging
import time

import numpy as np
import torch

from ..core.chain import MCMCChain
from ..core.task import MCMCTask
from ..samplers.base import RunCtx, make_generator, tree_map
from ..ops import glm_bign
from ..utils.table import Table

log = logging.getLogger(__name__)


def init_chains(model, sampler, n_chains, generator, inits=None,
                jitter=0.0):
    """Batched sampler state for ``n_chains`` chains.

    ``inits``: (n_chains, size) initial positions; default: model.init
    broadcast, plus ``jitter`` times standard normals when ``jitter > 0``
    (drawn from ``generator`` before the sampler's init)."""
    if inits is None:
        inits = model.init.expand(n_chains, model.size).clone()
        if jitter > 0:
            inits = inits + jitter * torch.randn(
                inits.shape, generator=generator, dtype=inits.dtype,
                device=inits.device)
    else:
        inits = torch.as_tensor(inits, dtype=model.dtype, device=model.device)
    return sampler.init(model, inits, generator)


def run_chains(model, sampler, runner, n_chains, generator=None, seed=0,
               inits=None, states=None):
    """Run ``n_chains`` identical chains; returns (infos, final_states,
    generator).

    ``infos`` tensors have shape (steps, n_chains, ...) and stay on the
    model's device until the caller copies them."""
    sampler.check(model)
    if generator is None:
        generator = make_generator(model.device, seed)
    if states is None:
        states = init_chains(model, sampler, n_chains, generator,
                             inits=inits)
    states, infos = _scan_chains(model, sampler, RunCtx(burnin=runner.burnin),
                                 states, generator, runner.len)
    return infos, states, generator


def _scan_chains(model, sampler, ctx, states, generator, steps):
    """``steps`` transitions of a batched state; returns (final states,
    infos stacked over steps).  A sampler with a ``pool(ctx, states,
    info)`` hook (cross-chain adaptation, e.g. ChEES-HMC) has it called
    after every step: it is the sampler's adaptation, not an option."""
    pool = getattr(sampler, "pool", None)
    rows = {}
    for _ in range(steps):
        states, info = sampler.step(model, ctx, states, generator)
        if pool is not None:
            states = pool(ctx, states, info)
        for k, v in info.items():
            rows.setdefault(k, []).append(v)
    return states, {k: torch.stack(v) for k, v in rows.items()}


def _plain_hmc(task):
    from ..samplers.hmc import HMC

    s = task.sampler
    return (
        type(s) is HMC
        and s.tuner is None
        and not s.store_leaps
        and s._kind is None
        # the kernels implement the whole integrator family
        and s.integrator in ("leapfrog", "2stage", "3stage")
    )


def _plain_mala(task):
    from ..samplers.mala import MALA

    s = task.sampler
    # plain MALA is one-leapfrog HMC at eps = sqrt(drift step)
    # (ops/glm_hmc.fused_mala_chains; reference MALA.jl:65-126)
    return type(s) is MALA and s.tuner is None


def _fused_eligible(task):
    """Plain fixed-step HMC, or plain MALA through the one-leapfrog
    equivalence, on a model(glm=...) posterior can route to the fused GLM
    kernels (ops/glm_hmc.py)."""
    return getattr(task.model, "glm_spec", None) is not None \
        and (_plain_hmc(task) or _plain_mala(task))


def _target_eligible(task):
    """Plain fixed-step HMC or plain MALA on a non-GLM model of at most
    1024 parameters can route to the fused custom-target kernels
    (pchains.py ``_target_eligible``), when the model has a
    ``target_spec``."""
    from ..ops.target_kernels import D_MAX

    return (getattr(task.model, "glm_spec", None) is None
            and (_plain_hmc(task) or _plain_mala(task))
            and task.model.size <= D_MAX)


def _kernel_shape_ok(model, route, sampler):
    """What the ported kernels take on ``route``: on a GLM a built-in link
    and d <= D_MAX on every route (kernels 1-4, 8 and 9: the narrow tile up
    to NARROW_D_MAX, the wide tile above), and N <= BIGN_THRESHOLD for
    exact NUTS; on a catalog target d <= the target kernels' D_MAX; for
    exact NUTS maxdoublings <= MAX_DOUBLINGS.  None when they do, else the
    reason."""
    from ..ops.glm_kernels import D_MAX, KIND_CODES
    from ..ops.nuts_kernels import MAX_DOUBLINGS

    if route == "nuts" and sampler.maxdoublings > MAX_DOUBLINGS:
        return (f"maxdoublings = {sampler.maxdoublings} > {MAX_DOUBLINGS}, "
                f"the NUTS kernels' bound")
    spec = model.glm_spec
    if spec is None:
        from ..ops import target_kernels

        if model.target_spec is None:
            return target_kernels.NOT_CATALOG
        if model.size > target_kernels.D_MAX:
            return (f"d = {model.size} > {target_kernels.D_MAX}, the "
                    f"custom-target kernels' bound")
        return None
    if not isinstance(spec.kind, str) or spec.kind not in KIND_CODES:
        return "a custom (ll, resid) link has no CUDA kernel yet"
    N, d = spec.X.shape
    if route == "nuts" and N > glm_bign.BIGN_THRESHOLD:
        return (f"exact NUTS at N = {N} > {glm_bign.BIGN_THRESHOLD} needs a "
                f"large-N NUTS route, not ported yet (ROADMAP: exact NUTS "
                f"above BIGN_THRESHOLD)")
    if d > D_MAX:
        return (f"d = {d} > {D_MAX}, the GLM kernels' bound (ROADMAP: GLMs "
                f"wider than {D_MAX} parameters)")
    return None


def _route(t, fused):
    """Decide before any launch which route a group takes: "hmc" (plain
    HMC or plain MALA through the fused GLM-HMC drivers), "target" (plain
    HMC or plain MALA on a catalog target through the custom-target
    trajectory kernel), "warm" (adaptive HMC, HMCDA, adaptive MALA or
    ChEES-HMC: generic warmup, then the Halton multistep or the N-tiled
    kernel on a GLM, the custom-target trajectory kernel on a catalog
    target), "nuts" (generic warmup, then the exact-NUTS kernels, GLM or
    target mode) or False (the generic engine).  Above ``BIGN_THRESHOLD``
    observations the "hmc" and "warm" routes run the N-tiled gradient
    kernel.

    ``fused=False``: never fused.  ``"auto"``: when the model lives on a
    CUDA device in float32 and the kernels take its shape.  ``True``:
    whenever the kernels take its shape (on the CPU the wrappers then run
    their plain versions)."""
    from ..ops.warmstart import warm_eligible
    from ..samplers.nuts import NUTS

    if fused is False:
        return False
    m = t.model
    if fused == "auto" and not (m.device.type == "cuda"
                                and m.dtype == torch.float32):
        return False
    if _fused_eligible(t):
        route = "hmc"
    elif _target_eligible(t):
        route = "target"
    elif warm_eligible(t):
        # NUTS itself, not a subclass: WALNUTS's adaptive micro-steps are
        # not what the NUTS kernels integrate (warm_eligible refuses it)
        route = "nuts" if type(t.sampler) is NUTS else "warm"
    else:
        log.info("prun: no fused CUDA route takes %s on this model; running "
                 "the generic torch engine", type(t.sampler).__name__)
        return False
    why = _kernel_shape_ok(m, route, t.sampler)
    if why is not None:
        log.info("prun: %s; running the generic torch engine", why)
        return False
    return route


def prun_serialmc(tasks, seed: int = 0, fused="auto"):
    """Reference-``prun`` surface: a list of SerialMC tasks -> list of chains.

    Tasks with identical (model, sampler, runner) are batched into one run;
    heterogeneous lists split into groups.  ``fused``: "auto" (default)
    routes plain HMC and MALA groups, and adaptive HMC, HMCDA, MALA, ChEES
    and exact-NUTS groups with a burn-in, on ``model(glm=...)`` posteriors
    and on models with a ``target_spec``, held in float32 on a CUDA device,
    to the fused CUDA kernels (see :func:`_route`); ``True`` forces the
    fused drivers (their plain versions on the CPU, for tests); ``False``
    always uses the generic engine.  A kernel that fails to build or launch
    raises."""
    t0 = time.time()

    groups = {}
    for idx, t in enumerate(tasks):
        sig = (id(t.model), t.sampler, t.runner)
        groups.setdefault(sig, []).append(idx)

    results = [None] * len(tasks)
    for gi, (sig, idxs) in enumerate(groups.items()):
        t = tasks[idxs[0]]
        n = len(idxs)
        # one generator per group, derived from (seed, group index)
        gen = make_generator(t.model.device, seed * 1_000_003 + gi)
        route = _route(t, fused)
        if route and fused == "auto":
            log.info("prun: routing %d %s chains to the fused CUDA "
                     "kernels (f32, %s route); pass fused=False for the "
                     "generic engine", n, type(t.sampler).__name__, route)
        if route == "hmc":
            from ..ops.glm_hmc import fused_hmc_chains, fused_mala_chains

            glm_fn = fused_mala_chains if _plain_mala(t) else fused_hmc_chains
            infos, final_states = glm_fn(t.model, t.sampler, t.runner, n, gen)
        elif route == "target":
            from ..ops.target_kernels import (fused_mala_target_chains,
                                              fused_target_chains)

            tgt_fn = (fused_mala_target_chains if _plain_mala(t)
                      else fused_target_chains)
            infos, final_states = tgt_fn(t.model, t.sampler, t.runner, n, gen)
        elif route in ("warm", "nuts"):
            from ..ops.warmstart import warmfused_chains

            infos, final_states = warmfused_chains(t.model, t.sampler,
                                                   t.runner, n, gen)
        else:
            infos, final_states, _ = run_chains(t.model, t.sampler, t.runner,
                                                n, generator=gen)
        _package_group(t, t.runner, idxs, infos, final_states, gen, results,
                       t0)
    return results


def _package_group(t, runner, idxs, infos, final_states, generator, results,
                   t0, pos_list=None):
    """Slice kept rows on the device, copy once to the host, and build one
    MCMCChain per task index.  Each chain's task carries its own slice of
    the final state and its own generator state for an exact resume.
    ``pos_list`` (aligned with ``idxs``) gives each task's own step count
    before this run: the chains of a resumed group may have been resumed a
    different number of times."""
    keep_idx = torch.as_tensor(np.asarray(list(runner.r)) - 1,
                               device=infos["plogtarget"].device)
    drop = {"pars", "grads", "logtarget"}
    host = {k: v[keep_idx].cpu().numpy() for k, v in infos.items()
            if k not in drop}
    cn = t.model.column_names()
    # per-chain continuation streams: seeds drawn from the group's generator,
    # stored as generator states (one re-seeded generator, no per-chain
    # device allocation)
    seeds = torch.randint(0, 2 ** 62, (len(idxs),), generator=generator,
                          device=generator.device).tolist()
    g = make_generator(generator.device)
    steps = np.asarray(list(runner.r))
    for ci, idx in enumerate(idxs):
        samples = Table(host["ppars"][:, ci], cn)
        if "pgrads" in host:
            gradients = Table(host["pgrads"][:, ci], cn)
        else:
            gradients = Table(np.zeros((0, t.model.size)), cn)
        skip = {"ppars", "pgrads", "plogtarget"}
        diags = {"step": steps}
        for k, v in host.items():
            if k not in skip:
                diags[k] = v[:, ci]
        diags["logtarget"] = host["plogtarget"][:, ci]
        state_i = tree_map(lambda a: a[ci], final_states)
        g.manual_seed(seeds[ci])
        pos0 = t.pos if pos_list is None else pos_list[ci]
        new_task = MCMCTask(t.model, t.sampler, runner, state=state_i,
                            key=g.get_state(), pos=pos0 + runner.len)
        results[idx] = MCMCChain(
            range=runner.r,
            samples=samples,
            gradients=gradients,
            diagnostics=diags,
            task=new_task,
            run_time=time.time() - t0,
        )


def continuation_route(model, sampler, n, fused="auto", states=None):
    """Decide before any launch how a batch of ``n`` stored states
    continues (pchains.py ``continuation_route``): "warm" (HMC, HMCDA,
    MALA or ChEES through the Halton multistep kernel, the N-tiled kernel
    or the custom-target trajectory kernel), "nuts" (exact NUTS through the
    GLM or target-mode NUTS kernels) or False (the generic engine), with the
    reason logged.  ``fused`` as in :func:`prun_serialmc`: False never
    fuses, "auto" fuses a model held in float32 on a CUDA device, True
    whenever the kernels take the shape (their plain versions on the CPU).
    Nothing is probed: a kernel that fails to build or launch raises."""
    from ..ops.warmstart import _continue_refusal
    from ..samplers.nuts import NUTS

    def generic(why):
        log.info("resume: %s; continuing %d %s chains on the generic torch "
                 "engine", why, n, type(sampler).__name__)
        return False

    if fused is False:
        return generic("fused=False")
    why = _continue_refusal(MCMCTask(model, sampler, None), states)
    if why is not None:
        return generic(why)
    if fused == "auto" and not (model.device.type == "cuda"
                                and model.dtype == torch.float32):
        return generic(f"the model is held in {model.dtype} on "
                       f"{model.device.type}, and fused='auto' takes CUDA "
                       f"float32 models")
    route = "nuts" if type(sampler) is NUTS else "warm"
    why = _kernel_shape_ok(model, route, sampler)
    if why is not None:
        return generic(why)
    return route


def presume_serialmc(chains, steps: int = 100, seed: int = 0, fused="auto"):
    """Batched resume of a list of SerialMC chains or tasks
    (pchains.py ``presume_serialmc``): the long-continuation workflow of
    the reference (runners.jl:48-68) at prun scale.

    The list splits into groups of one model, sampler, runner type and
    thinning, in the list's order; each group's states stack into one
    batch on the model's device and continue ``steps`` transitions under a
    new ``SerialMC(steps=steps, thinning=...)``: frozen HMC-family and
    exact-NUTS states through :func:`~..ops.warmstart.fused_continue_chains`
    when :func:`continuation_route` allows it, every other group on the
    generic engine (its adaptation is burn-in gated and does not fire).  A
    task that has never run resumes alone through ``resume_serialmc``.
    Each chain's ``pos`` advances from its own.

    The group's generator comes from the first member's stored generator
    state (the JAX package's ``fold_in(key, 7)``): one seed drawn from it
    seeds the run, so resuming the same list twice gives the same bits, and
    resuming the result, whose tasks carry new states, draws a new stream.
    The other members' stored states are not used.  A group whose first
    task has no stored generator state takes one from ``seed`` and the
    group's index."""
    from ..ops.warmstart import fused_continue_chains
    from ..runners.serialmc import SerialMC, resume_serialmc

    t0 = time.time()
    tasks = [c.task if isinstance(c, MCMCChain) else c for c in chains]
    groups = {}
    for idx, t in enumerate(tasks):
        sig = (id(t.model), t.sampler, type(t.runner), t.runner.thinning)
        groups.setdefault(sig, []).append(idx)

    results = [None] * len(tasks)
    for gi, idxs in enumerate(groups.values()):
        t = tasks[idxs[0]]
        if any(tasks[i].state is None for i in idxs):
            for i in idxs:
                results[i] = resume_serialmc(tasks[i], steps=steps)
            continue
        n, dev = len(idxs), t.model.device
        new_runner = SerialMC(steps=steps, thinning=t.runner.thinning)
        states = tree_map(lambda *xs: torch.stack([x.to(dev) for x in xs]),
                          *[tasks[i].state for i in idxs])
        if t.key is None:
            gen = make_generator(dev, seed * 1_000_003 + gi)
        else:
            base = make_generator(dev, state=t.key)
            gen = make_generator(dev, torch.randint(
                0, 2 ** 62, (1,), generator=base, device=dev).item())
        route = continuation_route(t.model, t.sampler, n, fused,
                                   states=states)
        if route and fused == "auto":
            log.info("resume: continuing %d %s chains on the fused CUDA "
                     "kernels (f32, %s route); pass fused=False for the "
                     "generic engine", n, type(t.sampler).__name__, route)
        if route:
            infos, final_states = fused_continue_chains(
                t.model, t.sampler, states, steps, gen)
        else:
            infos, final_states, _ = run_chains(t.model, t.sampler,
                                                new_runner, n, generator=gen,
                                                states=states)
        _package_group(t, new_runner, idxs, infos, final_states, gen,
                       results, t0, pos_list=[tasks[i].pos for i in idxs])
    return results
