"""Warm-start pipeline for adaptive samplers on GLM posteriors and catalog
targets (port of the HMC, HMCDA, MALA, ChEES and exact-NUTS parts of
``mcmc_jl_tpu/ops/warmstart.py``).

The adaptive samplers stop adapting at the end of burn-in anyway (the
EmpMCTuner is burn-in gated, HMC.jl:167-173; dual averaging freezes its
averaged step, HMCDA.jl:133-141 and NUTS.jl:121-125), so an adaptive run is
two phases, and the second is what the fused kernels run:

1. **Warmup** (``runner.burnin`` transitions): the generic engine runs the
   sampler as it is, with its per-chain adaptation (EmpMCTuner, dual
   averaging, optional diagonal or dense mass adaptation).
2. **Freeze**: the per-chain adapted step is pooled by the median across
   chains, the trajectory length likewise; a diagonal metric is pooled as
   the across-chain RMS of the per-chain scales, a dense one as the
   Cholesky factor of the chains' mean covariance ``L_c L_c'``.
3. **Fused sampling** (``len - burnin`` transitions) at the frozen values.
   A metric folds in exactly: with ``theta = S z`` the posterior in ``z``
   is again a GLM with design ``X S`` and per-coordinate prior precision
   ``lam s_j^2`` (diagonal ``S``), or with design ``X L`` and the prior
   precision matrix ``A = lam L' L`` (dense ``S = L``), and unit-metric
   dynamics in ``z`` are dynamics with that metric in ``theta``.  Samples
   and gradients map back as ``theta = S z``, ``g_theta = S'^-1 g_z``; the
   log-target is invariant.

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
   it rides the kernels' per-coordinate step row ``eps * s``, and a dense
   metric folds the positions, not the target: the kernels run the z-space
   target ``z -> target(z L')`` at the scalar step
   (:func:`dense_target_setup`).  On the CPU the wrappers run their plain
   versions.

The only departure from running the generic engine end to end is the
cross-chain pooling of the frozen hyper-parameters: the sampling phase is
still exact MCMC for the model posterior.

Phases 2 and 3 are the fused continuation (:func:`make_fused_continuation`)
of the warmup's states (:func:`warmfused_chains`), and a resumed batch
(``resume(list)``, through ``parallel.pchains.presume_serialmc``) runs
them again from stored states: it has ``burnin=0``, so no adaptation fires
and its frozen hyper-parameters are read back from the states with the
same freeze rules.  Given a ``mesh``, the warmup's chains split over its
chain axis on the generic engine and the sampling phase runs shard by
shard (:func:`_mesh_phase`): each chain shard on its entry's device with
its own stream, through the same kernels.  Not ported yet:
``NUTS(warm_handoff=True)`` and its continuation (ROADMAP: the warm
handoff) and data-bearing targets (custom targets).
"""
from __future__ import annotations

import logging
import math
import types

import numpy as np
import torch

log = logging.getLogger(__name__)

_INTEGRATORS = ("leapfrog", "2stage", "3stage")


def warm_eligible(task):
    """True when the task can take the warmup -> freeze -> fused pipeline:
    an adaptive HMC (EmpMCTuner and/or diagonal or dense mass adaptation),
    an HMCDA, an adaptive MALA, a ChEES-HMC or an exact NUTS, with a
    burn-in window, on a ``model(glm=...)`` posterior or on a model whose
    ``target_spec`` is a catalog target of at most ``D_MAX`` parameters
    (warmstart.py ``_warm_ok``), with a unit, diagonal or dense metric.
    Other models, ``NUTS(warm_handoff=True)``, which the JAX package
    also admits and the port does not yet, and subclasses of NUTS
    (WALNUTS), which the JAX package refuses too, are refused with a logged
    reason."""
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
                     "(ROADMAP: the warm handoff); running the generic "
                     "engine")
            return False
        ok = True
    elif isinstance(s, NUTS):
        log.info("warm start: %s; running the generic torch engine",
                 _walnuts_refusal(s))
        return False
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


def _warmup(model, sampler, runner, n_chains, generator, mesh=None):
    """Phase 1: the adaptive warmup on the generic engine (the sampler's own
    per-chain adaptation, identical to a non-fused run); chains split over
    ``mesh``'s chain axis when one is given.
    Returns (states, infos over the burn-in)."""
    from ..parallel.pchains import _scan_chains, init_chains
    from ..samplers.base import RunCtx

    states0 = init_chains(model, sampler, n_chains, generator, mesh=mesh)
    return _scan_chains(model, sampler, RunCtx(burnin=runner.burnin),
                        states0, generator, runner.burnin, mesh=mesh)


def _pool_mass(kind, states_w):
    """The pooled frozen metric, float64: the across-chain RMS of the
    per-chain scales, a (d,) tensor; for the dense kind the lower-triangular
    Cholesky factor (d, d) of the mean of the per-chain covariances
    ``L_c L_c'``.  None for the unit metric (no adaptation, or one that
    never armed)."""
    from ..samplers.massadapt import mass_vector_scale

    if kind is None:
        return None
    if kind == "dense":
        Ls = states_w.mass.scale.to(torch.float64)  # (C, d, d)
        sig = (Ls @ Ls.transpose(-1, -2)).mean(0)
        if torch.allclose(sig, torch.eye(sig.shape[0], dtype=sig.dtype,
                                         device=sig.device)):
            return None
        return torch.linalg.cholesky(sig)
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
    """Positions in the kernel's z-space, ``theta / s`` (diagonal) or
    ``L^-1 theta`` (dense, a triangular solve), in float64 and rounded once
    to a contiguous float32 (C, d) tensor."""
    theta_w = theta_w.to(torch.float64)
    if s is not None and s.ndim == 2:
        theta_w = torch.linalg.solve_triangular(s, theta_w.T,
                                                upper=False).T
    elif s is not None:
        theta_w = theta_w / s
    return theta_w.to(torch.float32).contiguous()


def _fold(spec, s):
    """Phase 2 fold ``theta = S z`` of the design: the kernel-side float32
    quantities ``(XT (d, N), Y, lam, W, O)``; ``lam`` is the scalar prior
    precision, the (d,) row ``lam s^2`` under a diagonal metric, or the
    (d, d) matrix ``A = lam L' L`` (built in float64, then rounded) under a
    dense one, whose design is ``X L``.  Nothing pads N or d, so one fold
    serves both kernel families; :func:`_fold_theta` folds the
    positions."""
    f32 = lambda a: None if a is None else a.to(torch.float32).contiguous()  # noqa: E731
    X = spec.X.to(torch.float64)
    lam = float(spec.prior_prec)
    if s is not None and s.ndim == 2:
        X = X @ s
        lam = f32(lam * (s.T @ s))
    elif s is not None:
        X = X * s
        lam = f32(lam * s * s)
    return (f32(X.T), f32(spec.Y), lam, f32(spec.weights),
            f32(spec.offsets))


def _unfold(infos2, thetaF, s, extra_keys=()):
    """Un-fold the metric from the kernel outputs; returns the sampling
    phase's (infos, theta (C, d)) in model coordinates: ``theta = s z``,
    ``g = g_z / s`` (diagonal) or, in float32 as the JAX package does,
    ``theta_row = z_row L'``, ``g_row = g_z_row L^-1`` (dense)."""
    ppars, pgrads, theta = infos2["ppars"], infos2["pgrads"], thetaF
    if s is not None and s.ndim == 2:
        L = s.to(torch.float32)
        Linv = torch.linalg.inv(s).to(torch.float32)
        ppars, pgrads, theta = ppars @ L.T, pgrads @ Linv, theta @ L.T
    elif s is not None:
        sj = s.to(torch.float32)
        ppars, pgrads, theta = ppars * sj, pgrads / sj, theta * sj
    infos = {"ppars": ppars, "pgrads": pgrads,
             "plogtarget": infos2["plogtarget"], "accept": infos2["accept"]}
    for k in extra_keys:
        infos[k] = infos2[k]
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


def dense_target_setup(model, s, device=None):
    """The kernels' target under a frozen metric ``s`` (None, a (d,)
    diagonal or a (d, d) dense Cholesky factor) (warmstart.py
    ``dense_target_setup``), on ``device`` (default: the model's).
    Returns ``(target, fold_s)``: for the dense kind the z-space target
    ``z -> target(z L')`` and ``fold_s = s`` (positions fold through
    :func:`_fold_theta` and unfold through :func:`_unfold`, and the step is
    the scalar ``eps``); otherwise the model's catalog target and None (a
    diagonal metric rides the step row, positions stay in model
    coordinates)."""
    from ..models.distributions import DenseTarget

    if s is None or s.ndim != 2:
        return model.target_spec, None
    return DenseTarget(model.target_spec,
                       s.to(device if device is not None else model.device)), s


def _target_step(eps, s, fold_s):
    """The custom-target kernels' step: the scalar under a dense fold, else
    :func:`_eps_row`."""
    return float(eps) if fold_s is not None else _eps_row(eps, s)


def _dyn_target_phase(model, integrator, eps, T, max_leaps, s, states_w,
                      steps2, i0, generator):
    """The dynamic-length sampling phase on a catalog target of the
    HMC/HMCDA/MALA and ChEES families (warmstart.py ``_dyn_target_phase``),
    on the device of ``states_w.pars``: under a unit or diagonal metric
    positions stay in model coordinates and the metric rides the step row;
    under a dense one they fold into ``z`` through
    :func:`dense_target_setup`, and the outputs stay in ``z`` (the caller
    unfolds them through the same factor).
    Returns ((theta, lp, grad), rows)."""
    dev = states_w.pars.device
    s = None if s is None else s.to(dev)
    target, fold_s = dense_target_setup(model, s, dev)
    return _chees_target_run(target, _fold_theta(states_w.pars, fold_s),
                             _target_step(eps, s, fold_s), eps, T, generator,
                             steps=steps2, i0=i0, max_leaps=max_leaps,
                             integrator=integrator)


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


# ---- the fused sampling phase: warm pipeline and continuation ----------------


def _continue_refusal(task, states=None):
    """None when a stored task's state can continue through the fused
    kernels, else the reason it cannot (warmstart.py ``continue_eligible``).
    A continuation has ``burnin=0``, so no tuner or dual averaging adapts
    again: the state is frozen and the run is the fixed kernel the fused
    drivers execute.  Every ``_kind`` the port's samplers take (None,
    "diag", "diag-win", "dense") continues, on a GLM and on a catalog
    target, as in the JAX package.  ``states`` is the JAX package's hook
    for the warm handoff's trajectory time, which the port does not
    continue."""
    from ..samplers.chees import ChEESHMC
    from ..samplers.hmc import HMC
    from ..samplers.hmcda import HMCDA
    from ..samplers.mala import MALA
    from ..samplers.nuts import NUTS
    from .target_kernels import D_MAX

    model, s = task.model, task.sampler
    name = type(s).__name__
    if getattr(model, "glm_spec", None) is None and model.size > D_MAX:
        return f"d = {model.size} > {D_MAX}, the custom-target kernels' bound"
    if isinstance(s, (HMC, HMCDA)) and s.store_leaps:
        return f"{name}(store_leaps=True) keeps every leapfrog"
    if isinstance(s, (HMC, HMCDA, ChEESHMC)) \
            and s.integrator not in _INTEGRATORS:
        return f"the {s.integrator!r} integrator has no kernel"
    if type(s) is NUTS and s.warm_handoff:
        return ("NUTS(warm_handoff=True) has no fused continuation in the "
                "port (ROADMAP: the warm handoff)")
    if isinstance(s, NUTS) and type(s) is not NUTS:
        return _walnuts_refusal(s)
    if isinstance(s, (HMC, HMCDA, ChEESHMC)) or type(s) in (MALA, NUTS):
        return None
    return f"{name} has no fused continuation"


def _walnuts_refusal(s):
    """Why a NUTS subclass (WALNUTS) takes no NUTS kernel: the kernels
    integrate fixed-step orbits, and its macro steps adapt their micro
    steps."""
    return (f"{type(s).__name__} adapts each macro step's micro steps, "
            f"which the fixed-step NUTS kernels do not")


def continue_eligible(task, states=None):
    """True when a stored task's state can continue through the fused
    kernels (warmstart.py ``continue_eligible``): HMC (fixed or adapted,
    unit, diagonal or dense metric), HMCDA, MALA, ChEES-HMC or exact NUTS,
    without ``store_leaps`` and with a kernel integrator, on a GLM posterior
    or a model of at most ``D_MAX`` parameters.  ``NUTS(warm_handoff=True)``
    states are refused: the port has no handoff continuation."""
    return _continue_refusal(task, states) is None


def make_fused_continuation(model, sampler, states0, mesh=None):
    """Freeze and fold once from ``states0``; returns ``continue_fn(states,
    steps, generator, i0=None) -> (infos, new_states)``, which reuses the
    folded design, prior and frozen hyper-parameters across segments of the
    same frozen run (warmstart.py ``make_fused_continuation``).  It is the
    sampling phase of the warm pipeline (:func:`warmfused_chains`) as well
    as of a resumed batch.

    The hyper-parameters are read from the states with the warm
    pipeline's freeze: after a warm-fused run they are already pooled and
    equal across chains; after a generic adaptive run the same median and
    RMS pooling applies.
    - HMC, HMCDA, MALA: :func:`_freeze`; ``T = 2 nl eps`` with
      ``max_leaps = max(2 nl, 2)``, or ``T = eps`` and one leap for MALA.
      A fixed-length ``HMC(nl, eps)`` continues with the same shared Halton
      leap counts in ``[1, 2 nl]``, as the JAX package does.
    - ChEES: the median ``dual_leap_step``, ``T = exp(median log_len)``,
      the sampler's ``max_leaps``; rows ``alpha``/``epsilon``/``nleaps``.
    - exact NUTS: ``eps = median(exp(lebar))``; rows
      ``epsilon``/``ndoublings``/``diverging``.
    A diagonal metric folds into the design on a GLM and rides the step row
    on a catalog target; a dense metric folds into the design and the
    matrix prior ``lam L' L`` on a GLM, and into the positions on a catalog
    target, whose kernels run ``z -> target(z L')`` at the scalar step
    (:func:`dense_target_setup`).  Each segment's Halton index starts
    at ``i0``, by default ``max(states.i)``, so successive segments extend
    one sequence.  Routes:
    on a GLM up to ``BIGN_THRESHOLD`` observations the Halton multistep
    kernel (3b) or the NUTS kernels (9 when ``steps`` has a divisor in
    [2, 8] on the card, else 8), above it the N-tiled gradient kernel (4);
    on a catalog target the trajectory kernel (5) or target-mode NUTS (8b).
    Given a ``mesh`` every segment runs shard by shard (:func:`_mesh_phase`),
    the folded design and the target copied once to each device."""
    from ..parallel.mesh import on_devices
    from ..samplers.chees import ChEESHMC
    from ..samplers.mala import MALA
    from ..samplers.nuts import NUTS
    from .nuts_kernels import _nuts_run, _nuts_run_hw, _nuts_target_run

    spec = model.glm_spec
    integrator = getattr(sampler, "integrator", "leapfrog")
    chees = isinstance(sampler, ChEESHMC)
    nuts = type(sampler) is NUTS
    nl = T = max_leaps = None
    if chees:
        eps = _median(states0.dual_leap_step)
        T = float(np.exp(np.median(states0.log_len.double().cpu().numpy())))
        s = _pool_mass(sampler._kind, states0)
        max_leaps = sampler.max_leaps
        extras = ("alpha", "epsilon", "nleaps")
    elif nuts:
        eps = float(np.median(np.exp(states0.lebar.double().cpu().numpy())))
        s = _pool_mass(sampler._kind, states0)
        extras = ("epsilon", "ndoublings", "diverging")
    else:
        eps, nl, s = _freeze(sampler, states0)
        mala = type(sampler) is MALA
        T = eps if mala else 2.0 * nl * eps
        max_leaps = 1 if mala else max(2 * nl, 2)
        extras = ()
    nuts_kw = (dict(maxdoublings=sampler.maxdoublings,
                    multinomial=sampler.multinomial) if nuts else {})
    put = on_devices()  # the replicated inputs, one copy a device

    if spec is not None:
        XT, Y, lam, W, O = _fold(spec, s)
        fold_s = s

        def run_phase(pars, steps, i0, generator, dev):
            theta0 = _fold_theta(pars, put(s, dev))
            XTd, Yd = put(XT, dev), put(Y, dev)
            kw = dict(kind=spec.kind, W=put(W, dev), O=put(O, dev),
                      lam=put(lam, dev))
            if nuts:
                use_hw, kt = _nuts_hw_route(model, steps)
                if use_hw:
                    return _nuts_run_hw(XTd, Yd, theta0, eps, generator,
                                        steps=steps, k_trans=kt, **nuts_kw,
                                        **kw)
                return _nuts_run(XTd, Yd, theta0, eps, generator,
                                 steps=steps, **nuts_kw, **kw)
            hkw = dict(steps=steps, i0=i0, max_leaps=max_leaps,
                       integrator=integrator, **kw)
            use_ms, kt = _ms_route(spec, steps)
            if use_ms:
                return _chees_run_ms(XTd, Yd, theta0, eps, T, generator,
                                     k_trans=kt, **hkw)
            return _chees_run_bign(XTd, Yd, theta0, eps, T, generator, **hkw)
    else:
        _, fold_s = dense_target_setup(model, s)
        eps_in = _target_step(eps, s, fold_s)

        def run_phase(pars, steps, i0, generator, dev):
            if nuts:
                target, _ = dense_target_setup(model, put(s, dev), dev)
                return _nuts_target_run(
                    target, _fold_theta(pars, put(fold_s, dev)),
                    put(eps_in, dev), generator, steps=steps, **nuts_kw)
            return _dyn_target_phase(model, integrator, eps, T, max_leaps, s,
                                     types.SimpleNamespace(pars=pars), steps,
                                     i0, generator)

    def continue_fn(states, steps, generator, i0=None):
        i0 = int(states.i.max()) if i0 is None else i0
        (thetaF, _, _), infos2 = _mesh_phase(
            lambda pars, gen, dev: run_phase(pars, steps, i0, gen, dev),
            states.pars, generator, mesh, model.device)
        if chees:
            infos2["epsilon"] = torch.full_like(infos2["plogtarget"], eps)
        infos, theta = _unfold(infos2, thetaF, fold_s, extra_keys=extras)
        theta = theta.to(model.device, states.pars.dtype)
        if not (chees or nuts):
            return infos, _frozen_states(model, sampler, states, theta, eps,
                                         nl, steps)
        out = sampler.reset(model, states, theta)
        if nuts:
            out = out.replace(epsilon=torch.full_like(out.epsilon, eps),
                              lebar=torch.full_like(out.lebar,
                                                    float(np.log(eps))))
        return infos, out.replace(i=out.i + steps)

    return continue_fn


def _mesh_phase(run_phase, theta0, generator, mesh, device):
    """Run ``run_phase(theta0, generator, device) -> ((theta, lp, grad),
    infos)`` on the positions ``theta0`` (C, d) over an optional mesh
    (warmstart.py ``_mesh_phase``): with more than one entry, chain shard
    ``i`` of the mesh's first axis runs on its entry's device from its own
    generator (:func:`~..parallel.mesh.map_chain_shards`), the shards
    never meet, and their outputs are joined on ``device``; else the whole
    batch runs on ``device``."""
    from ..parallel.mesh import map_chain_shards

    if mesh is None or mesh.devices.size == 1:
        return run_phase(theta0, generator, device)
    axis = mesh.axis_names[0]
    n_chains, n_dev = theta0.shape[0], mesh.shape[axis]
    assert n_chains % n_dev == 0, (
        f"n_chains ({n_chains}) must divide the '{axis}' mesh axis "
        f"({n_dev}) for the sharded sampling phase")
    return map_chain_shards(
        lambda i, dev, th0, gen: run_phase(th0.contiguous(), gen, dev),
        theta0, mesh, device, axis=axis, generator=generator, dim=(0, 1))


def fused_continue_chains(model, sampler, states, steps, generator,
                          mesh=None):
    """One fused continuation of a batch of ``steps`` transitions from
    ``states`` on ``generator`` (warmstart.py ``fused_continue_chains``):
    :func:`make_fused_continuation` applied once, shard by shard over
    ``mesh`` when one is given.  Returns ``(infos, final_states)`` in
    :func:`~..parallel.pchains.run_chains`'s protocol."""
    return make_fused_continuation(model, sampler, states, mesh=mesh)(
        states, steps, generator)


def warmfused_chains(model, sampler, runner, n_chains, generator, mesh=None):
    """The warm pipeline of every family :func:`warm_eligible` admits
    (warmstart.py ``warmfused_hmc_chains``, ``warmfused_target_chains``,
    ``warmfused_chees_chains`` and ``warmfused_nuts_exact_chains``): the
    adaptive warmup on the generic engine for the burn-in, then the
    sampling phase at the frozen hyper-parameters through the fused
    kernels, :func:`make_fused_continuation` of the warmup's states with
    the Halton index starting at ``runner.burnin + 1``.  ``mesh`` splits
    both phases' chains over its chain axis.  Returns ``(infos,
    final_states)`` in the protocol of
    :func:`mcmc_jl_tpu_torch.parallel.pchains.run_chains`: infos cover all
    ``runner.len`` transitions, the warmup's rows and then the sampling
    phase's, in the warmup's types."""
    states_w, infos_w = _warmup(model, sampler, runner, n_chains, generator,
                                mesh=mesh)
    infos2, states = make_fused_continuation(model, sampler, states_w,
                                             mesh=mesh)(
        states_w, runner.len - runner.burnin, generator,
        i0=runner.burnin + 1)
    infos = {k: torch.cat([infos_w[k], v.to(infos_w[k].dtype)])
             for k, v in infos2.items()}
    return infos, states
