"""Warm-start pipeline for adaptive samplers on GLM posteriors and catalog
targets (port of the HMC, HMCDA, MALA, ChEES and exact-NUTS parts of
``mcmc_jl_tpu/ops/warmstart.py``).

The adaptive samplers stop adapting at the end of burn-in anyway (the
EmpMCTuner is burn-in gated, HMC.jl:167-173; dual averaging freezes its
averaged step, HMCDA.jl:133-141 and NUTS.jl:121-125), so an adaptive run is
two phases, and the second is what the fused kernels run:

1. **Warmup** (``runner.burnin`` transitions): the generic engine runs the
   sampler as it is, with its per-chain adaptation (EmpMCTuner, dual
   averaging, optional diagonal mass adaptation).
2. **Freeze**: the per-chain adapted step is pooled by the median across
   chains, the trajectory length likewise; a diagonal metric is pooled as
   the across-chain RMS of the per-chain scales.
3. **Fused sampling** (``len - burnin`` transitions) at the frozen values.
   A diagonal metric folds in exactly: with ``theta = S z`` the posterior
   in ``z`` is again a GLM with design ``X S`` and per-coordinate prior
   precision ``lam s_j^2``, and unit-metric dynamics in ``z`` are
   diagonal-metric dynamics in ``theta``.  Samples and gradients map back
   as ``theta = s z``, ``g_theta = g_z / s``; the log-target is invariant.

   - exact NUTS: the same sampler through the NUTS kernels
     (:mod:`.nuts_kernels`);
   - adaptive HMC and HMCDA: fixed-step HMC whose leap count is the shared
     Halton-jittered ``clip(ceil(halton2(i) T / eps), 1, max_leaps)`` with
     ``T = 2 nl eps`` around the frozen ``nl`` (a pooled fixed length
     resonates on near-Gaussian posteriors; the jitter removes it);
   - adaptive MALA: one-leapfrog HMC at ``eps = sqrt(drift step)``
     (``T = eps`` pins every leap count to 1);
   - ChEES-HMC: the same Halton rule at the pooled ``eps`` and ``T`` and
     the sampler's ``max_leaps``.

   On a GLM, up to ``BIGN_THRESHOLD`` observations the Halton multistep
   kernel runs the HMC-family phase, ``_pick_k_trans(steps)`` transitions
   per launch; above it a trajectory loop around the N-tiled gradient
   kernel (:mod:`.glm_bign`).  On a catalog target (a DSL model with a
   ``target_spec``) the HMC-family phase loops around the custom-target
   trajectory kernel with the leap count given at run time, and exact NUTS
   runs the target-mode NUTS kernel; a diagonal metric needs no fold there,
   it rides the kernels' per-coordinate step row ``eps * s``.  On the CPU
   the wrappers run their plain versions.

The only departure from running the generic engine end to end is the
cross-chain pooling of the frozen hyper-parameters: the sampling phase is
still exact MCMC for the model posterior.  Not ported yet (ROADMAP queue
1): ``NUTS(warm_handoff=True)``, the dense metric with its z-space fold on
targets (``dense_target_setup``), data-bearing targets and the fused
continuation of a resumed chain.
"""
from __future__ import annotations

import logging
import math

import numpy as np
import torch

log = logging.getLogger(__name__)

_INTEGRATORS = ("leapfrog", "2stage", "3stage")


def warm_eligible(task):
    """True when the task can take the warmup -> freeze -> fused pipeline:
    an adaptive HMC (EmpMCTuner and/or diagonal mass adaptation), an HMCDA,
    an adaptive MALA, a ChEES-HMC or an exact NUTS, with a burn-in window,
    on a ``model(glm=...)`` posterior or on a model whose ``target_spec`` is
    a catalog target of at most ``D_MAX`` parameters (warmstart.py
    ``_warm_ok``).  Other models, and what the JAX package also admits and
    the port does not yet, are refused with a logged reason."""
    from ..samplers.chees import ChEESHMC
    from ..samplers.hmc import HMC
    from ..samplers.hmcda import HMCDA
    from ..samplers.mala import MALA
    from ..samplers.nuts import NUTS
    from .target_kernels import D_MAX, NOT_CATALOG

    runner = task.runner
    if runner.burnin < 1 or runner.len <= runner.burnin:
        return False
    s = task.sampler
    if isinstance(s, HMC):
        ok = (not s.store_leaps and s.integrator in _INTEGRATORS
              and (s.tuner is not None or s._kind is not None))
    elif isinstance(s, HMCDA):
        ok = not s.store_leaps and s.integrator in _INTEGRATORS
    elif type(s) is MALA:
        ok = s.tuner is not None
    elif isinstance(s, ChEESHMC):
        ok = s.integrator in _INTEGRATORS
    elif type(s) is NUTS:
        if s.warm_handoff:
            log.info("warm start: NUTS(warm_handoff=True) is not ported yet "
                     "(ROADMAP queue 1); running the generic engine")
            return False
        ok = True
    else:
        return False
    m = task.model
    if ok and getattr(m, "glm_spec", None) is None:
        if m.target_spec is None:
            log.info("warm start: %s; running the generic torch engine",
                     NOT_CATALOG)
            return False
        if m.size > D_MAX:
            log.info("warm start: d = %d > %d, the custom-target kernels' "
                     "bound; running the generic torch engine", m.size, D_MAX)
            return False
    return ok


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


def _median(t):
    return float(np.median(t.double().cpu().numpy()))


def _freeze(sampler, states_w):
    """Pool the per-chain adapted hyper-parameters into kernel constants
    ``(eps, n_leaps, s)``; ``s`` is the pooled per-coordinate metric scale
    (None = unit metric).  For MALA ``eps`` is the kernel's leapfrog step
    ``sqrt(drift step)`` and ``n_leaps`` is 1."""
    from ..samplers.hmc import HMC
    from ..samplers.mala import MALA

    if type(sampler) is MALA:
        scale = (_median(states_w.tune.step_size)
                 if sampler.tuner is not None else sampler.scale)
        return math.sqrt(scale), 1, None
    if isinstance(sampler, HMC):
        if sampler.tuner is not None:
            eps = _median(states_w.tune.step_size)
            # round, don't truncate: an even chain count gives half-integer
            # medians
            nl = int(round(_median(states_w.tune.n_leaps)))
        else:
            eps, nl = sampler.leap_step, sampler.n_leaps
        return eps, max(nl, 1), _pool_mass(sampler._kind, states_w)
    # HMCDA: the frozen dual-averaged step (HMCDA.jl:133-141), the
    # trajectory length from the target path length (HMCDA.jl:104)
    eps = _median(states_w.dual_leap_step)
    nl = max(1, int(round(sampler.len / eps)))
    return eps, nl, _pool_mass(sampler._kind, states_w)


def _fold_theta(theta_w, s):
    """Positions in the kernel's z-space: ``theta / s`` (float64)."""
    theta_w = theta_w.to(torch.float64)
    return theta_w if s is None else theta_w / s


def _fold(spec, states_w, s):
    """Phase 2 fold ``theta = S z``: the kernel-side float32 quantities
    ``(XT (d, N), Y, theta0 (C, d) in z-space, lam, W, O)``; ``lam`` is the
    scalar prior precision, or the (d,) row ``lam s^2`` under a metric.
    Nothing pads N, so one fold serves both kernel families."""
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


def _ms_route(spec, steps):
    """(use the Halton multistep kernel, k_trans) for a GLM sampling phase
    of ``steps`` transitions: the multistep kernel up to ``BIGN_THRESHOLD``
    observations, with ``_pick_k_trans(steps)`` transitions per launch (1
    when no divisor in [2, 8] exists); above it the tiled driver.  Decided
    from the shapes alone: a kernel that fails to build or launch raises."""
    from .glm_bign import BIGN_THRESHOLD

    if spec.X.shape[0] > BIGN_THRESHOLD:
        return False, 1
    return True, _pick_k_trans(steps)


def _chees_scan(trajectory, theta0, lp0, g0, eps, T, generator, *, steps,
                i0, max_leaps):
    """``steps`` fixed-step HMC transitions whose shared leap count is the
    Halton rule ``clip(ceil(halton2(i0 + t) T / eps), 1, max_leaps)``
    (warmstart.py ``_chees_scan``).  ``trajectory(theta, m0, g, nl)`` gives
    ``(theta, m, g, lp)`` at the end of ``nl`` leaps.  Returns ((theta, lp,
    grad), post-accept rows ppars/pgrads/plogtarget/accept/alpha/nleaps
    stacked over steps)."""
    from .glm_kernels import _draw, accept_test, halton_leaps

    theta, lp, g = theta0, lp0, g0
    rows = {k: [] for k in ("ppars", "pgrads", "plogtarget", "accept",
                            "alpha", "nleaps")}
    for t in range(steps):
        nl = halton_leaps(i0 + t, eps, T, max_leaps)
        m0, logu = _draw(theta, generator)
        h0 = -lp + 0.5 * (m0 * m0).sum(-1)
        p_th, p_m, p_g, p_lp = trajectory(theta, m0, g, nl)
        h = -p_lp + 0.5 * (p_m * p_m).sum(-1)
        ratio = h0 - h
        accept = accept_test(h0, h, logu)
        a = accept[:, None]
        theta = torch.where(a, p_th, theta)
        g = torch.where(a, p_g, g)
        lp = torch.where(accept, p_lp, lp)
        for k, v in (("ppars", theta), ("pgrads", g), ("plogtarget", lp),
                     ("accept", accept),
                     ("alpha", torch.where(torch.isnan(ratio), 0.0,
                                           torch.exp(ratio.clamp(max=0.0)))),
                     ("nleaps", torch.full(lp.shape, nl, dtype=torch.int32,
                                           device=lp.device))):
            rows[k].append(v)
    return (theta, lp, g), {k: torch.stack(v) for k, v in rows.items()}


def _chees_run_bign(XT, Y, theta0, eps, T, generator, *, steps, i0,
                    max_leaps, kind="logistic", W=None, O=None, lam=1.0,
                    integrator="leapfrog"):
    """The large-N sampling phase: :func:`_chees_scan` with a trajectory
    loop around the N-tiled gradient kernel, one evaluation per drift
    (warmstart.py ``_chees_run_bign``)."""
    from .glm_bign import _tiled_funcs
    from .glm_kernels import _trajectory

    grad_only, logp_grad = _tiled_funcs(XT, Y, W, O, lam, kind)
    lp0, g0 = logp_grad(theta0)

    def trajectory(theta, m0, g, nl):
        return _trajectory(theta, m0, g, eps, grad_only, logp_grad, nl,
                           integrator)

    return _chees_scan(trajectory, theta0, lp0, g0, eps, T, generator,
                       steps=steps, i0=i0, max_leaps=max_leaps)


def _chees_run_ms(XT, Y, theta0, eps, T, generator, *, steps, i0, max_leaps,
                  k_trans, kind="logistic", W=None, O=None, lam=1.0,
                  integrator="leapfrog"):
    """The small-N sampling phase through the Halton multistep kernel:
    ``steps // k_trans`` launches of ``k_trans`` whole transitions, each
    launch seeded from ``generator`` (warmstart.py ``_chees_run_ms``).
    Returns ((theta, lp, grad), rows stacked over steps), as
    :func:`_chees_scan`."""
    from .glm_kernels import glm_multistep_rows

    if steps % k_trans:
        raise ValueError(f"steps ({steps}) must be a multiple of k_trans "
                         f"({k_trans})")
    theta, rows = theta0, []
    for launch in range(steps // k_trans):
        theta, g, lp, r = glm_multistep_rows(
            XT, Y, theta, eps, T, i0 + launch * k_trans, max_leaps,
            k_trans=k_trans, generator=generator, kind=kind, weights=W,
            offsets=O, prior_prec=lam, integrator=integrator)
        rows.append(r)
    return (theta, lp, g), {k: torch.cat([r[k] for r in rows])
                            for k in rows[0]}


def _eps_row(eps, s):
    """The step of the custom-target phases (warmstart.py ``_eps_row``,
    unpadded): the scalar ``eps``, or under a frozen diagonal metric ``s``
    the per-coordinate row ``eps * s``, computed in float64 and rounded once
    to float32."""
    if s is None:
        return float(eps)
    return (eps * s.to(torch.float64)).to(torch.float32)


def _chees_target_run(target, theta0, eps_in, eps, T, generator, *, steps,
                      i0, max_leaps, integrator="leapfrog"):
    """The sampling phase on a catalog target: :func:`_chees_scan` around the
    custom-target trajectory kernel, the Halton leap count given at run
    time (warmstart.py ``_chees_target_run``), through one
    :func:`~.target_kernels.leapfrogs_launcher` for the phase.  ``eps_in``
    is the kernel's step (scalar, or the (d,) row carrying the diagonal
    metric), ``eps`` the scalar the length rule uses.  lp and the gradient
    at the start come from the target's plain evaluation, once."""
    from .target_kernels import leapfrogs_launcher, target_funcs

    lp0, g0 = target_funcs(target)[1](theta0)
    trajectory = leapfrogs_launcher(target, theta0, eps_in, integrator)
    return _chees_scan(trajectory, theta0, lp0, g0.contiguous(), eps, T,
                       generator, steps=steps, i0=i0, max_leaps=max_leaps)


def _dyn_target_phase(model, integrator, eps, T, max_leaps, s, states_w,
                      steps2, i0, generator):
    """The dynamic-length sampling phase on a catalog target, shared by the
    HMC/HMCDA/MALA and ChEES pipelines (warmstart.py ``_dyn_target_phase``,
    unit and diagonal metrics): positions stay in model coordinates, the
    metric rides the step row.  Returns ((theta, lp, grad), rows)."""
    theta0 = states_w.pars.to(torch.float32).contiguous()
    return _chees_target_run(model.target_spec, theta0, _eps_row(eps, s),
                             eps, T, generator, steps=steps2, i0=i0,
                             max_leaps=max_leaps, integrator=integrator)


def _frozen_states(model, sampler, states_w, theta, eps, nl, steps2):
    """Final states of the HMC/HMCDA/MALA pipeline: the warmup's states at
    the sampling phase's final positions (log-target and gradient at the
    model's precision), the adaptation frozen at the pooled values, so a
    resume continues at the same hyper-parameters."""
    from ..samplers.base import TuneState
    from ..samplers.hmc import HMC
    from ..samplers.mala import MALA

    states = sampler.reset(model, states_w, theta.to(model.device,
                                                     model.dtype))
    i = states.i + steps2
    if isinstance(sampler, (HMC, MALA)):
        tune = states.tune
        if sampler.tuner is None:
            return states.replace(i=i)
        full = lambda v, dt: torch.full_like(tune.n_leaps, v, dtype=dt)  # noqa: E731
        zero = torch.zeros_like(tune.accepted)
        # MALA's state keeps the drift step (a variance), not the kernel eps
        frozen = TuneState(
            step_size=full(eps * eps if type(sampler) is MALA else eps,
                           tune.step_size.dtype),
            n_leaps=tune.n_leaps if type(sampler) is MALA
            else full(nl, torch.int32),
            accepted=zero, proposed=zero)
        return states.replace(tune=frozen, i=i)
    # HMCDA
    epsv = torch.full_like(states.leap_step, eps)
    return states.replace(leap_step=epsv, dual_leap_step=epsv, i=i)


def warmfused_hmc_chains(model, sampler, runner, n_chains, generator):
    """Adaptive HMC, HMCDA or MALA: warmup on the generic engine, then the
    sampling phase at the frozen step, leap count and metric through the
    Halton multistep kernel (N up to ``BIGN_THRESHOLD``) or the N-tiled
    gradient kernel (above it).  Returns ``(infos, final_states)`` in the
    protocol of :func:`mcmc_jl_tpu_torch.parallel.pchains.run_chains`:
    infos cover all ``runner.len`` transitions with the post-accept keys
    ``ppars/pgrads/plogtarget/accept``."""
    from ..samplers.mala import MALA

    spec = model.glm_spec
    states_w, infos_w = _warmup(model, sampler, runner, n_chains, generator)
    eps, nl, s = _freeze(sampler, states_w)
    steps2 = runner.len - runner.burnin
    XT, Y, theta0, lam, W, O = _fold(spec, states_w, s)
    # shared per-transition Halton jitter around the frozen nl (uniform on
    # [1, 2 nl], mean about nl); MALA pins the count to exactly 1
    mala = type(sampler) is MALA
    T = eps if mala else 2.0 * nl * eps
    max_leaps = 1 if mala else max(2 * nl, 2)
    kw = dict(steps=steps2, i0=runner.burnin + 1, max_leaps=max_leaps,
              kind=spec.kind, W=W, O=O, lam=lam,
              integrator=getattr(sampler, "integrator", "leapfrog"))
    use_ms, kt = _ms_route(spec, steps2)
    if use_ms:
        (thetaF, _, _), infos2 = _chees_run_ms(XT, Y, theta0, eps, T,
                                               generator, k_trans=kt, **kw)
    else:
        (thetaF, _, _), infos2 = _chees_run_bign(XT, Y, theta0, eps, T,
                                                 generator, **kw)
    infos, theta = _unfold_cat(infos_w, infos2, thetaF, s)
    states = _frozen_states(model, sampler, states_w, theta, eps, nl, steps2)
    return infos, states


def warmfused_target_chains(model, sampler, runner, n_chains, generator):
    """Adaptive HMC, HMCDA or MALA on a catalog target: warmup on the
    generic engine, then the sampling phase at the frozen step, leap count
    and diagonal metric through the custom-target trajectory kernel
    (warmstart.py ``warmfused_target_chains``), with the freeze rules of the
    GLM pipeline.  Returns ``(infos, final_states)`` as
    :func:`warmfused_hmc_chains` does."""
    from ..samplers.mala import MALA

    states_w, infos_w = _warmup(model, sampler, runner, n_chains, generator)
    eps, nl, s = _freeze(sampler, states_w)
    steps2 = runner.len - runner.burnin
    mala = type(sampler) is MALA
    T = eps if mala else 2.0 * nl * eps
    max_leaps = 1 if mala else max(2 * nl, 2)
    (thetaF, _, _), infos2 = _dyn_target_phase(
        model, getattr(sampler, "integrator", "leapfrog"), eps, T, max_leaps,
        s, states_w, steps2, runner.burnin + 1, generator)
    infos, theta = _unfold_cat(infos_w, infos2, thetaF, None)
    states = _frozen_states(model, sampler, states_w, theta, eps, nl, steps2)
    return infos, states


def warmfused_chees_chains(model, sampler, runner, n_chains, generator):
    """ChEES-HMC: the pooled adaptation (dual averaging and Adam on log T
    through the sampler's pool hook) on the generic engine for the burn-in,
    then the sampling phase at the frozen ``eps = median(dual_leap_step)``
    and ``T = exp(median(log_len))`` with the sampler's ``max_leaps``
    (warmstart.py ``warmfused_chees_chains``): on a GLM through the Halton
    multistep kernel (N up to ``BIGN_THRESHOLD``) or the N-tiled gradient
    kernel, on a catalog target through the trajectory kernel.  Infos carry
    ``alpha``/``epsilon``/``nleaps``; the final states are the warmup's,
    reset at the last positions."""
    states_w, infos_w = _warmup(model, sampler, runner, n_chains, generator)
    # the median, as every freeze: after the pool hook the values are shared
    eps = _median(states_w.dual_leap_step)
    T = float(np.exp(np.median(states_w.log_len.double().cpu().numpy())))
    s = _pool_mass(sampler._kind, states_w)
    steps2 = runner.len - runner.burnin
    i0 = runner.burnin + 1
    spec = model.glm_spec
    if spec is None:
        (thetaF, _, _), infos2 = _dyn_target_phase(
            model, sampler.integrator, eps, T, sampler.max_leaps, s, states_w,
            steps2, i0, generator)
        fold_s = None
    else:
        XT, Y, theta0, lam, W, O = _fold(spec, states_w, s)
        kw = dict(steps=steps2, i0=i0, max_leaps=sampler.max_leaps,
                  kind=spec.kind, W=W, O=O, lam=lam,
                  integrator=sampler.integrator)
        use_ms, kt = _ms_route(spec, steps2)
        if use_ms:
            (thetaF, _, _), infos2 = _chees_run_ms(XT, Y, theta0, eps, T,
                                                   generator, k_trans=kt,
                                                   **kw)
        else:
            (thetaF, _, _), infos2 = _chees_run_bign(XT, Y, theta0, eps, T,
                                                     generator, **kw)
        fold_s = s
    infos2["epsilon"] = torch.full_like(infos2["plogtarget"], eps)
    infos, theta = _unfold_cat(infos_w, infos2, thetaF, fold_s,
                               extra_keys=("alpha", "epsilon", "nleaps"))
    states = sampler.reset(model, states_w, theta.to(model.device,
                                                     model.dtype))
    return infos, states.replace(i=states.i + steps2)


def warmfused_nuts_exact_chains(model, sampler, runner, n_chains, generator):
    """Exact No-U-Turn warm pipeline: adaptive warmup (dual averaging and an
    optional diagonal metric) on the generic engine; the sampling phase runs
    the same exact NUTS sampler (per-chain directions, slice or multinomial
    leaf selection, span and overall u-turn rules, divergence gate) through
    the fused tree-build kernels at the frozen step.  On a GLM the pooled
    metric folds into the design; on a catalog target it rides the
    target-mode kernel's step row ``eps * s`` (whose first entry the
    ``epsilon`` rows then report, as in the JAX package).  Returns
    ``(infos, final_states)`` in the protocol of
    :func:`mcmc_jl_tpu_torch.parallel.pchains.run_chains`."""
    from .nuts_kernels import _nuts_run, _nuts_run_hw, _nuts_target_run

    spec = model.glm_spec
    states_w, infos_w = _warmup(model, sampler, runner, n_chains, generator)
    # frozen dual-averaged step (exp(log eps-bar)), pooled by the median
    eps = float(np.median(np.exp(states_w.lebar.double().cpu().numpy())))
    s = _pool_mass(sampler._kind, states_w)
    steps2 = runner.len - runner.burnin
    if spec is None:
        (thetaF, _, _), infos2 = _nuts_target_run(
            model.target_spec, states_w.pars.to(torch.float32).contiguous(),
            _eps_row(eps, s), generator, steps=steps2,
            maxdoublings=sampler.maxdoublings,
            multinomial=sampler.multinomial)
        fold_s = None
    else:
        XT, Y, theta0, lam, W, O = _fold(spec, states_w, s)
        use_hw, kt = _nuts_hw_route(model, steps2)
        kw = dict(steps=steps2, maxdoublings=sampler.maxdoublings,
                  kind=spec.kind, W=W, O=O, lam=lam,
                  multinomial=sampler.multinomial)
        if use_hw:
            (thetaF, _, _), infos2 = _nuts_run_hw(XT, Y, theta0, eps,
                                                  generator, k_trans=kt, **kw)
        else:
            (thetaF, _, _), infos2 = _nuts_run(XT, Y, theta0, eps, generator,
                                               **kw)
        fold_s = s
    infos, theta = _unfold_cat(
        infos_w, infos2, thetaF, fold_s,
        extra_keys=("epsilon", "ndoublings", "diverging"))

    states = sampler.reset(model, states_w, theta.to(model.dtype))
    full = lambda v: torch.full((n_chains,), v, dtype=states.epsilon.dtype,  # noqa: E731
                                device=states.epsilon.device)
    states = states.replace(epsilon=full(eps), lebar=full(float(np.log(eps))),
                            i=states.i + steps2)
    return infos, states
