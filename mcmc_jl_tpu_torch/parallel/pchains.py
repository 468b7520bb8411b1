"""Parallel chain engine (port of ``mcmc_jl_tpu/parallel/pchains.py``).

Replaces the reference's distributed backend — Julia ``pmap`` of whole
chains over worker processes (reference: src/runners/runners.jl:35-42) —
with chains on a leading tensor dimension, advanced together by one Python
loop of batched tensor ops.  Chains are independent, so the batch is
embarrassingly parallel.  Given a ``mesh`` (:mod:`.mesh`), the chain axis
splits over the mesh's ``'chains'`` axis: each shard runs on its entry's
device with its own stream, and shards on distinct devices run
concurrently; only pooled adaptation (``pool_adaptation=True``) and a
sampler's cross-chain ``pool`` hook join them every step, through
:mod:`.collectives`.

``run_chains`` is the engine (returns stacked tensors, kept on the device);
``prun_serialmc`` adapts it to the reference's ``prun`` surface (a list of
per-task chains) and routes groups on GLM posteriors to the fused CUDA
kernels: plain HMC and plain MALA to the HMC drivers (ops/glm_hmc.py; above
``BIGN_THRESHOLD`` observations the N-tiled kernel, ops/glm_bign.py),
adaptive HMC, HMCDA, adaptive MALA, ChEES-HMC, exact NUTS and the NUTS
warm handoff to the warm-start pipeline (ops/warmstart.py).  On a custom
target that is a product of catalog densities (``model.target_spec``) plain
HMC and plain MALA go to the custom-target kernels (ops/target_kernels.py),
and the adaptive samplers, exact NUTS and the warm handoff to the
warm-start pipeline's target arms; other custom targets run on the generic
engine.  Samplers that adapt from cross-chain statistics (ChEES-HMC)
expose ``pool``, which the engine calls after every step.
``presume_serialmc`` is the batched resume: a list of chains re-batches by
group, and frozen HMC-family, exact-NUTS and warm-handoff groups continue
through the same kernels (``continuation_route``, ops/warmstart.py
``fused_continue_chains``).  With a mesh the warm-start pipeline and the
generic engine shard their chains; the plain fused HMC, MALA and
custom-target routes ignore it, as the JAX package's do.
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
from .collectives import (all_gather, get_field, pool_tuner_states,
                          pooled_fields)
from .mesh import (CHAIN_AXIS, chain_axis, concat_chains, default_mesh,
                   gather, group_entries, local_groups, map_chain_shards,
                   model_on, shard_generators, split_chains, to_device)

log = logging.getLogger(__name__)

__all__ = ["run_chains", "init_chains", "prun_serialmc", "default_mesh",
           "CHAIN_AXIS"]


def _sharded(mesh, n_chains):
    """Whether a batch of ``n_chains`` splits over ``mesh``: not without a
    mesh, nor when its chain axis does not divide the batch (the JAX
    package then leaves the batch unsharded too)."""
    if mesh is None:
        return False
    axis = chain_axis(mesh)
    if n_chains % mesh.shape[axis]:
        log.info("mesh: %d chains do not divide the %r axis (%d); the batch "
                 "runs unsharded", n_chains, axis, mesh.shape[axis])
        return False
    return True


def init_chains(model, sampler, n_chains, generator, inits=None,
                jitter=0.0, mesh=None):
    """Batched sampler state for ``n_chains`` chains.

    ``inits``: (n_chains, size) initial positions; default: model.init
    broadcast, plus ``jitter`` times standard normals when ``jitter > 0``
    (drawn from ``generator`` before the sampler's init).  With a ``mesh``
    each chain shard initializes on its device from its own generator
    (seeds drawn from ``generator``); the states are joined on the model's
    device."""
    if inits is None:
        inits = model.init.expand(n_chains, model.size).clone()
        if jitter > 0:
            inits = inits + jitter * torch.randn(
                inits.shape, generator=generator, dtype=inits.dtype,
                device=inits.device)
    else:
        inits = torch.as_tensor(inits, dtype=model.dtype, device=model.device)
    if not _sharded(mesh, n_chains):
        return sampler.init(model, inits, generator)
    return map_chain_shards(
        lambda i, dev, th, gen: sampler.init(model_on(model, dev), th, gen),
        inits, mesh, model.device, generator=generator)


def run_chains(model, sampler, runner, n_chains, generator=None, seed=0,
               inits=None, states=None, jitter=0.0, mesh=None,
               pool_adaptation=False):
    """Run ``n_chains`` identical chains; returns (infos, final_states,
    generator).

    ``infos`` tensors have shape (steps, n_chains, ...) and stay on the
    model's device until the caller copies them.  ``mesh`` splits the
    chains over its ``'chains'`` axis (:func:`_scan_chains`);
    ``pool_adaptation=True`` replaces the adapted step sizes and
    dual-averaging statistics by their cross-chain pool after every step
    (:func:`~.collectives.pool_tuner_states`)."""
    sampler.check(model)
    if generator is None:
        generator = make_generator(model.device, seed)
    if states is None:
        states = init_chains(model, sampler, n_chains, generator,
                             inits=inits, jitter=jitter, mesh=mesh)
    states, infos = _scan_chains(model, sampler, RunCtx(burnin=runner.burnin),
                                 states, generator, runner.len,
                                 pool_adaptation=pool_adaptation, mesh=mesh)
    return infos, states, generator


def _scan_chains(model, sampler, ctx, states, generator, steps,
                 pool_adaptation=False, mesh=None):
    """``steps`` transitions of a batched state; returns (final states,
    infos stacked over steps).  A sampler with a ``pool(ctx, states,
    info)`` hook (cross-chain adaptation, e.g. ChEES-HMC) has it called
    after every step: it is the sampler's adaptation, not an option; with
    ``pool_adaptation`` the adapted scalars are pooled after it.

    With a ``mesh`` the chains split over its chain axis: each shard runs on
    its entry's device from its own generator (seeds drawn from
    ``generator``).  Without pooling the shards never meet
    (:func:`~.mesh.for_each`); with it they advance step by step together
    and the pool reads every shard's values through
    :func:`~.collectives.all_gather`."""
    pool = getattr(sampler, "pool", None)
    if _sharded(mesh, states.pars.shape[0]):
        return _scan_mesh(model, sampler, ctx, states, generator, steps,
                          pool_adaptation, mesh)
    rows = {}
    for _ in range(steps):
        states, info = sampler.step(model, ctx, states, generator)
        if pool is not None:
            states = pool(ctx, states, info)
        if pool_adaptation:
            states = pool_tuner_states(states)
        for k, v in info.items():
            rows.setdefault(k, []).append(v)
    return states, {k: torch.stack(v) for k, v in rows.items()}


def _gather_tree(parts, mesh, axis, entries):
    """Every leaf of the per-shard trees ``parts`` ({i: state dataclass or
    dict of tensors}) gathered over the chain axis: the whole batch's tree,
    as the first shard of this process holds it."""
    from ..samplers.base import tree_map

    order = sorted(parts)
    first = entries[order[0]]

    def leaf(*xs):
        return all_gather({entries[i]: x for i, x in zip(order, xs)}, mesh,
                          axis)[first]

    if isinstance(parts[order[0]], dict):
        return {k: leaf(*(parts[i][k] for i in order))
                for k in parts[order[0]]}
    return tree_map(leaf, *(parts[i] for i in order))


def _scan_mesh(model, sampler, ctx, states, generator, steps,
               pool_adaptation, mesh):
    pool = getattr(sampler, "pool", None)
    if pool is None and not pool_adaptation:
        return map_chain_shards(
            lambda i, dev, st, gen: _scan_chains(model_on(model, dev),
                                                 sampler, ctx, st, gen,
                                                 steps),
            states, mesh, model.device, generator=generator, dim=(0, 1))
    axis = chain_axis(mesh)
    n = mesh.shape[axis]
    items = local_groups(mesh, axis)
    gens = shard_generators(items, generator=generator)
    shard = {i: to_device(split_chains(states, n, i), dev)
             for i, dev in items}
    models = {i: model_on(model, dev) for i, dev in items}
    entries = group_entries(mesh, axis, items)
    fields = pooled_fields(states) if pool_adaptation else ()
    rows = {i: {} for i, _ in items}
    for _ in range(steps):
        infos = {}
        for i, _dev in items:
            shard[i], infos[i] = sampler.step(models[i], ctx, shard[i],
                                              gens[i])
        if pool is not None:
            full = pool(ctx, _gather_tree(shard, mesh, axis, entries),
                        _gather_tree(infos, mesh, axis, entries))
            shard = {i: to_device(split_chains(full, n, i), dev)
                     for i, dev in items}
        if fields:
            full = {path: all_gather(
                {entries[i]: get_field(shard[i], path) for i, _ in items},
                mesh, axis) for path, _ in fields}
            shard = {i: pool_tuner_states(
                shard[i], {p: v[entries[i]] for p, v in full.items()})
                for i, _ in items}
        for i, _dev in items:
            for k, v in infos[i].items():
                rows[i].setdefault(k, []).append(v)
    parts = gather({i: (shard[i], {k: torch.stack(v)
                                   for k, v in rows[i].items()})
                    for i, _ in items}, n)
    return concat_chains(parts, model.device, (0, 1))


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
    and d <= D_MAX (kernels 1-4, 8 and 9: the narrow tile up to
    NARROW_D_MAX, the wide tile up to WIDE_D_MAX, the very-wide tile up to
    XWIDE_D_MAX, the chunked tier above), for exact NUTS also N <=
    BIGN_THRESHOLD; on a catalog target d <= the target kernels' D_MAX; for
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


def _nuts_or_warm(sampler):
    """"nuts" for exact NUTS, whose sampling phase runs the NUTS kernels;
    "warm" for every other warm-start family, the NUTS warm handoff
    included (the Halton rule's dynamic-length HMC)."""
    from ..samplers.nuts import NUTS

    exact = type(sampler) is NUTS and not sampler.warm_handoff
    return "nuts" if exact else "warm"


def _route(t, fused):
    """Decide before any launch which route a group takes: "hmc" (plain
    HMC or plain MALA through the fused GLM-HMC drivers), "target" (plain
    HMC or plain MALA on a catalog target through the custom-target
    trajectory kernel), "warm" (adaptive HMC, HMCDA, adaptive MALA,
    ChEES-HMC or the NUTS warm handoff: generic warmup, then the Halton
    multistep or the N-tiled kernel on a GLM, the custom-target trajectory
    kernel on a catalog target), "nuts" (exact NUTS: generic warmup, then
    the exact-NUTS kernels, GLM or target mode) or False (the generic
    engine).  Above ``BIGN_THRESHOLD`` observations the "hmc" and "warm"
    routes run the N-tiled gradient kernel.

    ``fused=False``: never fused.  ``"auto"``: when the model lives on a
    CUDA device in float32 and the kernels take its shape.  ``True``:
    whenever the kernels take its shape (on the CPU the wrappers then run
    their plain versions)."""
    from ..ops.warmstart import warm_eligible

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
        # not what the NUTS kernels integrate (warm_eligible refuses it);
        # the warm handoff samples as dynamic-length HMC, not on them
        route = _nuts_or_warm(t.sampler)
    else:
        log.info("prun: no fused CUDA route takes %s on this model; running "
                 "the generic torch engine", type(t.sampler).__name__)
        return False
    why = _kernel_shape_ok(m, route, t.sampler)
    if why is not None:
        log.info("prun: %s; running the generic torch engine", why)
        return False
    return route


def prun_serialmc(tasks, seed: int = 0, mesh=None, fused="auto"):
    """Reference-``prun`` surface: a list of SerialMC tasks -> list of chains.

    Tasks with identical (model, sampler, runner) are batched into one run;
    heterogeneous lists split into groups.  ``fused``: "auto" (default)
    routes plain HMC and MALA groups, and adaptive HMC, HMCDA, MALA, ChEES
    and exact-NUTS groups with a burn-in, on ``model(glm=...)`` posteriors
    and on models with a ``target_spec``, held in float32 on a CUDA device,
    to the fused CUDA kernels (see :func:`_route`); ``True`` forces the
    fused drivers (their plain versions on the CPU, for tests); ``False``
    always uses the generic engine.  A kernel that fails to build or launch
    raises.

    ``mesh`` (:mod:`.mesh`) splits each group's chains over its chain axis
    on the warm-start pipeline (warmup and sampling phase) and on the
    generic engine; the plain fused HMC, MALA and custom-target routes
    ignore it, as the JAX package's do (pchains.py:333-352)."""
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
                                                   t.runner, n, gen,
                                                   mesh=mesh)
        else:
            infos, final_states, _ = run_chains(t.model, t.sampler, t.runner,
                                                n, generator=gen, mesh=mesh)
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
    MALA, ChEES or a NUTS warm handoff whose ``states`` carry its
    trajectory time, through the Halton multistep kernel, the N-tiled
    kernel or the custom-target trajectory kernel), "nuts" (exact NUTS
    through the GLM or target-mode NUTS kernels) or False (the generic
    engine), with the reason logged.  ``fused`` as in
    :func:`prun_serialmc`: False never fuses, "auto" fuses a model held in
    float32 on a CUDA device, True whenever the kernels take the shape
    (their plain versions on the CPU).
    Nothing is probed: a kernel that fails to build or launch raises."""
    from ..ops.warmstart import _continue_refusal

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
    route = _nuts_or_warm(sampler)
    why = _kernel_shape_ok(model, route, sampler)
    if why is not None:
        return generic(why)
    return route


def presume_serialmc(chains, steps: int = 100, seed: int = 0, mesh=None,
                     fused="auto"):
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
    group's index.  ``mesh`` splits each group's chains as in
    :func:`prun_serialmc`, the fused continuation's included."""
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
                t.model, t.sampler, states, steps, gen, mesh=mesh)
        else:
            infos, final_states, _ = run_chains(t.model, t.sampler,
                                                new_runner, n, generator=gen,
                                                states=states, mesh=mesh)
        _package_group(t, new_runner, idxs, infos, final_states, gen,
                       results, t0, pos_list=[tasks[i].pos for i in idxs])
    return results
