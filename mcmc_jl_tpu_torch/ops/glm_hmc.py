"""Fused-kernel HMC driver for GLM posteriors (port of
``mcmc_jl_tpu/ops/glm_hmc.py``).

Couples the GLM kernels (:mod:`.glm_kernels`) with the Metropolis
accept/refresh logic in plain PyTorch: per outer step, momenta are
refreshed, the whole ``n_leaps`` trajectory runs inside one kernel launch,
and the accept test is a (C,)-vector op.  Statistically identical to
``HMC(n_leaps, eps)`` on the same model (same integrator, same accept rule —
reference HMC.jl:136-165).  Kernels compute in float32, as in the JAX
package; :func:`final_hmc_states` re-evaluates the final states at the
model's precision so a resume composes with the generic engine.

Above ``glm_bign.BIGN_THRESHOLD`` observations :func:`fused_hmc_chains`
runs the trajectory loop around the N-tiled gradient kernel instead
(:mod:`.glm_bign`); plain MALA rides both through the one-leapfrog
equivalence (:func:`fused_mala_chains`).

On CPU tensors the kernel wrappers run their plain versions, which is what
``fused=True`` means off the card (the JAX package's ``interpret=True``).
"""
from __future__ import annotations

import torch

from .glm_kernels import (_draw, accept_test, glm_funcs, glm_leapfrogs,
                          glm_multistep, glm_step)


def _run(XT, Y, theta0, eps, generator, *, steps, n_leaps, kind="logistic",
         W=None, O=None, lam=1.0, collect=False, integrator="leapfrog",
         fused_step=False):
    """Run ``steps`` fused-HMC transitions for all chains.

    ``collect=False`` (bench mode) records only (plogtarget, accept) per
    step; ``collect=True`` also the post-accept ppars/pgrads.  Pre-step
    values are not recorded: they duplicate the previous step's post-accept
    values.  ``fused_step=True`` runs each whole transition in one launch of
    the step kernel; ``False`` (composed) launches the trajectory kernel and
    does refresh and accept here.  Both draw the same numbers from
    ``generator`` in the same order, so they give the same chains.
    Returns ((theta, lp, grad), infos stacked over steps)."""
    kw = dict(n_leaps=n_leaps, kind=kind, weights=W, offsets=O,
              prior_prec=lam, integrator=integrator)
    theta = theta0
    lp, g = glm_funcs(XT, Y, W, O, lam, kind)[1](theta0)
    rows = {"plogtarget": [], "accept": []}
    if collect:
        rows.update(ppars=[], pgrads=[])
    for _ in range(steps):
        m0, logu = _draw(theta, generator)
        if fused_step:
            theta, g, lp2, acc = glm_step(XT, Y, theta, g, lp[:, None], m0,
                                          logu[:, None], eps, **kw)
            lp, accept = lp2[:, 0], acc[:, 0] > 0.5
        else:
            p_th, p_m, p_g, p_lp = glm_leapfrogs(XT, Y, theta, m0, g, eps,
                                                 **kw)
            accept = accept_test(-lp + 0.5 * (m0 * m0).sum(-1),
                                 -p_lp + 0.5 * (p_m * p_m).sum(-1), logu)
            a = accept[:, None]
            theta = torch.where(a, p_th, theta)
            g = torch.where(a, p_g, g)
            lp = torch.where(accept, p_lp, lp)
        rows["plogtarget"].append(lp)
        rows["accept"].append(accept)
        if collect:
            rows["ppars"].append(theta)
            rows["pgrads"].append(g)
    return (theta, lp, g), {k: torch.stack(v) for k, v in rows.items()}


def _run_multistep(XT, Y, theta0, eps, generator, *, n_launches, k_trans,
                   n_leaps, kind="logistic", W=None, O=None, lam=1.0,
                   integrator="leapfrog", collect=False):
    """Run ``n_launches`` launches of ``k_trans`` in-kernel transitions.

    Each launch draws its Philox seed from ``generator``; infos carry one
    thinned row per launch: ``plogtarget``/``accept_rate``
    (+ ``ppars``/``pgrads`` with collect).  Returns (theta, infos)."""
    theta = theta0
    rows = {"plogtarget": [], "accept_rate": []}
    if collect:
        rows.update(ppars=[], pgrads=[])
    for _ in range(n_launches):
        theta, g, lp, acc = glm_multistep(
            XT, Y, theta, eps, k_trans=k_trans, n_leaps=n_leaps,
            generator=generator, kind=kind, weights=W, offsets=O,
            prior_prec=lam, integrator=integrator)
        rows["plogtarget"].append(lp)
        rows["accept_rate"].append(acc)
        if collect:
            rows["ppars"].append(theta)
            rows["pgrads"].append(g)
    return theta, {k: torch.stack(v) for k, v in rows.items()}


def _prepare(X, Y, n_chains, seed, generator, inits, device, weights,
             offsets):
    """float32 kernel inputs on ``device`` and the run's generator."""
    from ..models.model import resolve_device
    from ..samplers.base import make_generator

    dev = resolve_device(device)
    f32 = lambda a: None if a is None else torch.as_tensor(  # noqa: E731
        a, dtype=torch.float32, device=dev).reshape(-1)
    XT = torch.as_tensor(X, dtype=torch.float32, device=dev).T.contiguous()
    d = XT.shape[0]
    gen = generator if generator is not None else make_generator(dev, seed)
    if inits is None:
        inits = 0.1 * torch.randn((n_chains, d), generator=gen,
                                  dtype=torch.float32, device=dev)
    theta0 = torch.as_tensor(inits, dtype=torch.float32,
                             device=dev).contiguous()
    return XT, f32(Y), theta0, gen, f32(weights), f32(offsets)


def run_glm_hmc(X, Y, n_chains, steps, n_leaps=10, eps=0.05, seed=0,
                generator=None, inits=None, device=None, kind="logistic",
                weights=None, offsets=None, prior_prec=1.0,
                integrator="leapfrog", fused_step="auto"):
    """Sample a GLM posterior with the fused kernels.

    ``X`` (N, d), ``Y`` (N,); ``weights``/``offsets`` optional (N,);
    ``prior_prec`` is the N(0, 1/lam I) prior precision.
    Returns (theta (C, d), infos {plogtarget, accept} stacked over steps)."""
    XT, Y2, theta0, gen, W, O = _prepare(X, Y, n_chains, seed, generator,
                                         inits, device, weights, offsets)
    (theta, _, _), infos = _run(
        XT, Y2, theta0, float(eps), gen, steps=steps, n_leaps=n_leaps,
        kind=kind, W=W, O=O, lam=float(prior_prec), integrator=integrator,
        fused_step=_choose_fused_step(fused_step))
    return theta, infos


def run_glm_hmc_multistep(X, Y, n_chains, steps, thin=10, n_leaps=10,
                          eps=0.05, seed=0, generator=None, inits=None,
                          device=None, kind="logistic", weights=None,
                          offsets=None, prior_prec=1.0,
                          integrator="leapfrog", collect=False):
    """Sample a GLM posterior with the multi-transition kernel: ``steps``
    transitions as ``steps // thin`` launches of ``thin``; infos carry one
    row per launch (thinned chain)."""
    if steps % thin != 0:
        raise ValueError("steps must be divisible by thin")
    XT, Y2, theta0, gen, W, O = _prepare(X, Y, n_chains, seed, generator,
                                         inits, device, weights, offsets)
    return _run_multistep(
        XT, Y2, theta0, float(eps), gen, n_launches=steps // thin,
        k_trans=thin, n_leaps=n_leaps, kind=kind, W=W, O=O,
        lam=float(prior_prec), integrator=integrator, collect=collect)


def _choose_fused_step(fused_step):
    """Resolve a user ``fused_step`` policy to a bool.

    ``"auto"`` picks the composed path, as the JAX package does; the step
    kernel is taken only when asked for.  There is no compile probe: a
    kernel that fails to build or launch raises."""
    if fused_step not in ("auto", True, False):
        raise ValueError(f"fused_step must be 'auto', True or False, got "
                         f"{fused_step!r}")
    return fused_step is True


def final_hmc_states(model, sampler, n_chains, steps_done, thetaF, lpF, gF):
    """Batched HMCState for resume after a fused-kernel run (float32 kernel
    outputs re-evaluated at model precision so the generic path composes)."""
    from ..samplers.base import tuner_init
    from ..samplers.hmc import HMCState
    from ..samplers.massadapt import mass_init

    dt, dev = model.dtype, model.device
    shape = (n_chains,)
    states = HMCState(
        pars=thetaF.to(dev, dt), logtarget=lpF.to(dev, dt),
        grad=gF.to(dev, dt),
        tune=tuner_init(sampler.leap_step, sampler.n_leaps, shape, dt, dev),
        i=torch.full(shape, steps_done + 1, dtype=torch.int32, device=dev),
        mass=mass_init(None, model.size, dt, dev, shape),
    )
    # refresh logp/grad at model precision for exact resume
    return sampler.reset(model, states, states.pars)


def _glm_inputs(spec):
    """The float32 kernel inputs of a GLM spec: (XT (d, N), Y, W, O)."""
    f32 = lambda a: None if a is None else a.to(torch.float32).contiguous()  # noqa: E731
    return (spec.X.T.to(torch.float32).contiguous(), f32(spec.Y),
            f32(spec.weights), f32(spec.offsets))


def fused_hmc_chains(model, sampler, runner, n_chains, generator,
                     fused_step="auto"):
    """Run ``n_chains`` plain-HMC chains on a ``model(glm=...)`` posterior
    through the fused kernels, returning ``(infos, final_states)`` in the
    protocol of :func:`mcmc_jl_tpu_torch.parallel.pchains.run_chains`
    (float32 compute; post-accept keys only).  Above
    :data:`~mcmc_jl_tpu_torch.ops.glm_bign.BIGN_THRESHOLD` observations the
    trajectory loop runs here around the N-tiled gradient kernel."""
    from . import glm_bign

    spec = model.glm_spec
    if spec is None:
        raise ValueError("fused_hmc_chains requires a model(glm=...) model")
    XT, Y, W, O = _glm_inputs(spec)
    theta0 = model.init.to(torch.float32).expand(n_chains, -1).contiguous()
    kw = dict(steps=runner.len, n_leaps=sampler.n_leaps, kind=spec.kind,
              W=W, O=O, lam=spec.prior_prec, collect=True,
              integrator=sampler.integrator)
    if spec.X.shape[0] > glm_bign.BIGN_THRESHOLD:
        (thetaF, lpF, gF), infos = glm_bign._run_bign(
            XT, Y, theta0, sampler.leap_step, generator, **kw)
    else:
        (thetaF, lpF, gF), infos = _run(
            XT, Y, theta0, sampler.leap_step, generator,
            fused_step=_choose_fused_step(fused_step), **kw)
    states = final_hmc_states(model, sampler, n_chains, runner.len,
                              thetaF, lpF, gF)
    return infos, states


def fused_mala_chains(model, sampler, runner, n_chains, generator):
    """Run plain-MALA chains on a ``model(glm=...)`` posterior through the
    fused kernels (glm_hmc.py ``fused_mala_chains``).

    MALA with drift step (variance) ``s`` is one-leapfrog HMC at
    ``eps = sqrt(s)``: the leapfrog proposal ``theta + (eps^2/2) g + eps m``
    is exactly ``N(theta + (s/2) g, s I)`` and the Hamiltonian MH ratio
    equals MALA's q-corrected one (reference MALA.jl:65-126 vs
    HMC.jl:93-102).  Up to ``BIGN_THRESHOLD`` observations the Halton rows
    kernel runs k transitions per launch with ``T = eps`` and
    ``max_leaps = 1``, which pins every leap count to 1; above it the tiled
    driver runs ``HMC(1, eps)``.  Returns ``(infos, final_states)`` with
    exact-resume MALAStates."""
    import math

    from ..samplers.base import tuner_init
    from ..samplers.hmc import HMC
    from ..samplers.mala import MALAState
    from .warmstart import _chees_run_ms, _ms_route

    spec = model.glm_spec
    eps = math.sqrt(sampler.scale)
    use_ms, kt = _ms_route(spec, runner.len)
    if not use_ms:
        infos, hst = fused_hmc_chains(model, HMC(1, eps), runner, n_chains,
                                      generator)
        pars, i = hst.pars, hst.i
    else:
        XT, Y, W, O = _glm_inputs(spec)
        theta0 = model.init.to(torch.float32).expand(n_chains, -1).contiguous()
        (thetaF, _, _), infos = _chees_run_ms(
            XT, Y, theta0, eps, eps, generator, steps=runner.len, i0=1,
            max_leaps=1, k_trans=kt, kind=spec.kind, W=W, O=O,
            lam=spec.prior_prec)
        infos = {k: infos[k] for k in ("ppars", "pgrads", "plogtarget",
                                       "accept")}
        pars = thetaF.to(model.device, model.dtype)
        i = torch.full((n_chains,), runner.len + 1, dtype=torch.int32,
                       device=model.device)
    tune = tuner_init(sampler.scale, shape=(n_chains,), dtype=model.dtype,
                      device=model.device)
    lp, g = model.evalallg(pars)  # at model precision: an exact resume
    return infos, MALAState(pars=pars, logtarget=lp, grad=g, tune=tune, i=i)
