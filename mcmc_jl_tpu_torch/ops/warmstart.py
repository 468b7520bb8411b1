"""Warm-start pipeline for exact NUTS on GLM posteriors (port of the
exact-NUTS part of ``mcmc_jl_tpu/ops/warmstart.py``).

NUTS freezes its dual-averaged step after adaptation anyway (NUTS.jl
121-125), so an adaptive run is two phases, and the second is what the fused
kernels (:mod:`.nuts_kernels`) run:

1. **Warmup** (``runner.burnin`` transitions): the generic engine runs the
   sampler as it is, with per-chain dual averaging and optional diagonal
   mass adaptation.
2. **Freeze**: eps = the median over chains of ``exp(lebar)``; a diagonal
   metric is pooled as the across-chain RMS of the per-chain scales.
3. **Fused sampling** (``len - burnin`` transitions): the same exact NUTS
   sampler through the tree-build kernels at the frozen step.  A diagonal
   metric folds in exactly: with ``theta = S z`` the posterior in ``z`` is
   again a GLM with design ``X S`` and per-coordinate prior precision
   ``lam s_j^2``, and unit-metric NUTS in ``z`` is diagonal-metric NUTS in
   ``theta``.  Samples and gradients map back as ``theta = s z``,
   ``g_theta = g_z / s``; the log-target is invariant.

The multistep kernel serves the phase when the model is on a CUDA device
and the phase splits into launches of 2..8 transitions; the per-transition
kernel otherwise (on the CPU its plain version).  Other samplers, custom
targets, the dense metric and the fused continuation of a NUTS chain are
not ported yet (ROADMAP queue 1 item 12).
"""
from __future__ import annotations

import numpy as np
import torch


def _warm_ok(model, sampler, runner):
    """True when (model, sampler, runner) can take the warmup -> freeze ->
    fused pipeline: an exact ``NUTS`` on a ``model(glm=...)`` posterior with
    a burn-in window."""
    from ..samplers.nuts import NUTS

    if runner.burnin < 1 or runner.len <= runner.burnin:
        return False
    if getattr(model, "glm_spec", None) is None:
        return False  # custom targets: the target-mode kernel is not ported
    # NUTS(warm_handoff=True) needs the Halton multistep kernel (not ported)
    return type(sampler) is NUTS and not sampler.warm_handoff


def _warmup(model, sampler, runner, n_chains, generator):
    """Phase 1: the adaptive warmup on the generic engine (the sampler's own
    per-chain adaptation, identical to a non-fused run).
    Returns (states, infos over the burn-in)."""
    from ..parallel.pchains import _scan_chains, init_chains
    from ..samplers.base import RunCtx

    states0 = init_chains(model, sampler, n_chains, generator)
    return _scan_chains(model, sampler, RunCtx(burnin=runner.burnin),
                        states0, generator, runner.burnin)


def _pool_mass(kind, states_w):
    """The pooled frozen metric: the across-chain RMS of the per-chain
    scales, a (d,) float64 tensor; None for the unit metric (no adaptation,
    or one that never armed)."""
    from ..samplers.massadapt import mass_vector_scale

    if kind is None:
        return None
    s_c = mass_vector_scale(kind, states_w.mass, states_w.pars.dtype)
    s = torch.sqrt(torch.mean(s_c.to(torch.float64) ** 2, dim=0))
    return None if torch.allclose(s, torch.ones_like(s)) else s


def _fold_theta(theta_w, s):
    """Positions in the kernel's z-space: ``theta / s`` (float64)."""
    theta_w = theta_w.to(torch.float64)
    return theta_w if s is None else theta_w / s


def _fold(spec, states_w, s):
    """Phase 2 fold ``theta = S z``: the kernel-side float32 quantities
    ``(XT (d, N), Y, theta0 (C, d) in z-space, lam, W, O)``; ``lam`` is the
    scalar prior precision, or the (d,) row ``lam s^2`` under a metric."""
    f32 = lambda a: None if a is None else a.to(torch.float32).contiguous()  # noqa: E731
    X = spec.X.to(torch.float64)
    lam = float(spec.prior_prec)
    if s is not None:
        X = X * s
        lam = f32(lam * s * s)
    return (f32(X.T), f32(spec.Y), f32(_fold_theta(states_w.pars, s)), lam,
            f32(spec.weights), f32(spec.offsets))


def _unfold(infos2, thetaF, s, extra_keys=()):
    """Un-fold the metric from the kernel outputs; returns the sampling
    phase's (infos, theta (C, d)) in model coordinates."""
    ppars, pgrads, theta = infos2["ppars"], infos2["pgrads"], thetaF
    if s is not None:
        sj = s.to(torch.float32)
        ppars, pgrads, theta = ppars * sj, pgrads / sj, theta * sj
    infos = {"ppars": ppars, "pgrads": pgrads,
             "plogtarget": infos2["plogtarget"], "accept": infos2["accept"]}
    for k in extra_keys:
        infos[k] = infos2[k]
    return infos, theta


def _unfold_cat(infos_w, infos2, thetaF, s, extra_keys=()):
    """Un-fold the metric and concatenate the warmup's and the sampling
    phase's infos into the whole run's (len, C, ...) arrays, in the
    warmup's types."""
    infos2u, theta = _unfold(infos2, thetaF, s, extra_keys=extra_keys)
    infos = {k: torch.cat([infos_w[k], v.to(infos_w[k].dtype)])
             for k, v in infos2u.items()}
    return infos, theta


def _pick_k_trans(steps):
    """Largest divisor of ``steps`` in [2, 8] (transitions per multistep
    launch); 1 = per-transition launches."""
    for k in range(8, 1, -1):
        if steps % k == 0:
            return k
    return 1


def _nuts_hw_route(model, steps):
    """(use the multistep kernel, k_trans) for a sampling phase of
    ``steps`` transitions: multistep when the model is on a CUDA device and
    ``steps`` splits into launches of 2..8 transitions."""
    kt = _pick_k_trans(steps)
    if model.device.type == "cuda" and kt > 1:
        return True, kt
    return False, 1


def warmfused_nuts_exact_chains(model, sampler, runner, n_chains, generator):
    """Exact No-U-Turn warm pipeline: adaptive warmup (dual averaging and an
    optional diagonal metric) on the generic engine; the sampling phase runs
    the same exact NUTS sampler (per-chain directions, slice or multinomial
    leaf selection, span and overall u-turn rules, divergence gate) through
    the fused tree-build kernels at the frozen step, with the pooled metric
    folded into the design.  Returns ``(infos, final_states)`` in the
    protocol of :func:`mcmc_jl_tpu_torch.parallel.pchains.run_chains`."""
    from .nuts_kernels import _nuts_run, _nuts_run_hw

    spec = model.glm_spec
    states_w, infos_w = _warmup(model, sampler, runner, n_chains, generator)
    # frozen dual-averaged step (exp(log eps-bar)), pooled by the median
    eps = float(np.median(np.exp(states_w.lebar.double().cpu().numpy())))
    s = _pool_mass(sampler._kind, states_w)
    steps2 = runner.len - runner.burnin
    XT, Y, theta0, lam, W, O = _fold(spec, states_w, s)
    use_hw, kt = _nuts_hw_route(model, steps2)
    kw = dict(steps=steps2, maxdoublings=sampler.maxdoublings,
              kind=spec.kind, W=W, O=O, lam=lam,
              multinomial=sampler.multinomial)
    if use_hw:
        (thetaF, _, _), infos2 = _nuts_run_hw(XT, Y, theta0, eps, generator,
                                              k_trans=kt, **kw)
    else:
        (thetaF, _, _), infos2 = _nuts_run(XT, Y, theta0, eps, generator,
                                           **kw)
    infos, theta = _unfold_cat(
        infos_w, infos2, thetaF, s,
        extra_keys=("epsilon", "ndoublings", "diverging"))

    states = sampler.reset(model, states_w, theta.to(model.dtype))
    full = lambda v: torch.full((n_chains,), v, dtype=states.epsilon.dtype,  # noqa: E731
                                device=states.epsilon.device)
    states = states.replace(epsilon=full(eps), lebar=full(float(np.log(eps))),
                            i=states.i + steps2)
    return infos, states
