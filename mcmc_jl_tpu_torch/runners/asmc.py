"""Adaptive annealed SMC sampler (port of ``mcmc_jl_tpu/runners/asmc.py``;
no reference equivalent).

Annealed SMC from the prior to the posterior (Del Moral, Doucet & Jasra
2006) where the inverse-temperature schedule is chosen on the fly by
bisecting each increment so the reweighted ESS hits ``target_ess *
particles`` (Jasra et al. 2011; Chopin & Papaspiliopoulos ch. 17).  Each
stage reweights, bisects, resamples and takes ``moves`` MCMC rejuvenation
steps of every particle at the current power posterior ``logprior + beta *
loglik`` (PTMC's prior-tempered view), all on the particles' device; the
JAX package's ``lax.while_loop`` condition is one host check a stage.
beta, the weights and logZ are computed in the particles' dtype, as in the
JAX package.

The telescoped normalizing-constant increments give the marginal-likelihood
estimate ``log Z = Σ_t log Σ_i W_i^{t-1} exp(δ_t ll_i)``, a third evidence
estimator beside stats/evidence.py's TI and stepping-stone.
``mesh=`` is not taken (ROADMAP: the distributed drivers).
"""
from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch

from ..core.chain import MCMCChain
from ..core.task import MCMCTask
from ..samplers.base import RunCtx, make_generator
from ..utils.table import Table
from .ptmc import _prior_fns, _tempered_view


@dataclasses.dataclass(frozen=True)
class ASMC:
    """Adaptive annealed-SMC runner config.

    ``logprior``: normalized log prior density for one vector (theta ->
    logpi(theta)), lifted over particles with ``torch.func.vmap``.
    ``prior_sample``: ``(generator, n) -> (n, size)`` draws from that prior
    on the generator's device; it stands in for the JAX package's
    ``key -> one draw`` vmapped over keys, since a ``torch.Generator``
    cannot be vmapped.
    ``target_ess``: ESS fraction each adaptive temperature step aims for.
    ``moves``: MCMC rejuvenation steps per temperature stage.
    """

    particles: int = 1024
    target_ess: float = 0.5
    moves: int = 2
    max_stages: int = 50
    resampling: str = "systematic"
    logprior: object = None
    prior_sample: object = None

    def __post_init__(self):
        assert self.particles >= 2
        assert 0.0 < self.target_ess < 1.0
        assert self.moves >= 1
        assert self.max_stages >= 1
        assert self.resampling in ("multinomial", "systematic", "stratified")
        assert self.logprior is not None, "ASMC needs logprior="
        assert self.prior_sample is not None, "ASMC needs prior_sample="

    def __rmul__(self, other):
        from ..core.task import product

        return product(other, self)


def _comb_idx(wn, u):
    """Systematic (``u`` 0-d) or stratified (``u`` one a stratum) ancestor
    indices of normalized weights ``wn`` on their given uniforms."""
    npart = wn.shape[0]
    cum = torch.cumsum(wn, 0)
    pts = (torch.arange(npart, dtype=wn.dtype, device=wn.device) + u) / npart
    return torch.searchsorted(cum, pts, side="left").clamp(0, npart - 1)


def _comb_draw(generator, method, npart, dtype, device):
    """The comb's uniforms: one offset (systematic) or one a stratum."""
    shape = () if method == "systematic" else (npart,)
    return torch.rand(shape, generator=generator, dtype=dtype, device=device)


def _resample_idx(generator, logW, npart, method):
    """Ancestor indices for the three standard schemes, on the weights'
    device."""
    wn = torch.softmax(logW, 0)
    if method == "multinomial":
        return torch.multinomial(wn, npart, replacement=True,
                                 generator=generator)
    return _comb_idx(wn, _comb_draw(generator, method, npart, wn.dtype,
                                    wn.device))


def _ess_of(lw):
    lw = lw - torch.logsumexp(lw, 0)
    return torch.exp(-torch.logsumexp(2.0 * lw, 0))


def _stage_weights(logW, ll, beta, target):
    """One stage's reweighting: bisect delta so ESS(logWn + delta*ll) hits
    ``target`` (ESS falls as delta grows; 30 halvings), or jump straight to
    beta = 1 when that keeps the ESS at the target.  Returns (delta, the
    logZ increment, the new log-weights, their ESS)."""
    logWn = logW - torch.logsumexp(logW, 0)
    hi0 = 1.0 - beta
    lo, hi = torch.zeros_like(beta), hi0
    for _ in range(30):
        mid = 0.5 * (lo + hi)
        small = _ess_of(logWn + mid * ll) < target
        lo, hi = torch.where(small, lo, mid), torch.where(small, mid, hi)
    full = _ess_of(logWn + hi0 * ll) >= target
    delta = torch.where(full, hi0, 0.5 * (lo + hi))
    inc = torch.logsumexp(logWn + delta * ll, 0)
    logW = logWn + delta * ll
    return delta, inc, logW, _ess_of(logW)


def _asmc_loop(model, sampler, runner: ASMC, states, th, generator):
    N, S = runner.particles, runner.max_stages
    prior, _ = _prior_fns(runner.logprior)
    ctx = RunCtx(burnin=0)
    dtype, dev = th.dtype, th.device
    target = runner.target_ess * N
    uniform = torch.full((N,), -math.log(float(N)), dtype=dtype, device=dev)

    i, beta = 0, torch.zeros((), dtype=dtype, device=dev)
    logW, logZ = uniform, torch.zeros((), dtype=dtype, device=dev)
    betas_b, ess_b, acc_b = [], [], []
    while i < S and bool(beta < 1.0):
        ll = model.eval(th) - prior(th)
        delta, inc, logW, ess_new = _stage_weights(logW, ll, beta, target)
        logZ = logZ + inc
        beta = beta + delta

        # resample (skipped only when the clipped final jump kept ESS high)
        do_res = ess_new <= target + 1.0
        idx = _resample_idx(generator, logW, N, runner.resampling)
        th = torch.where(do_res, th[idx], th)
        logW = torch.where(do_res, uniform, logW)

        # MCMC rejuvenation at the new power posterior
        view = _tempered_view(model, beta, runner.logprior)
        states = sampler.reset(view, states, th)
        acc = torch.zeros((), dtype=dtype, device=dev)
        for _ in range(runner.moves):
            states, infos = sampler.step(view, ctx, states, generator)
            th = infos["ppars"]
            acc = acc + infos["accept"].to(dtype).mean()

        betas_b.append(beta)
        ess_b.append(ess_new)
        acc_b.append(acc / runner.moves)
        i += 1

    # final equalization so returned particles are unweighted
    idx = _resample_idx(generator, logW, N, runner.resampling)
    uneven = _ess_of(logW) < N - 1e-6
    th = torch.where(uneven, th[idx], th)
    stack = lambda v: torch.stack(v).cpu().numpy() if v else np.zeros(0)  # noqa: E731
    return dict(n_stages=i, beta=float(beta), pars=th, logZ=float(logZ),
                betas=stack(betas_b), ess=stack(ess_b), accept=stack(acc_b))


def run_asmc(model, sampler, runner: ASMC, seed: int = 0, generator=None):
    """Anneal prior -> posterior; returns an MCMCChain whose samples are the
    final (unweighted) particle ensemble, with diagnostics ``logz``,
    ``betas`` (adaptive schedule), ``ess`` and ``accept`` per stage."""
    sampler.check(model)
    t0 = time.time()
    if generator is None:
        generator = make_generator(model.device, seed)
    N = runner.particles
    th0 = torch.as_tensor(runner.prior_sample(generator, N),
                          dtype=model.dtype, device=model.device)
    th0 = th0.reshape(N, model.size)
    zero = torch.zeros((), dtype=model.dtype, device=model.device)
    states = sampler.init(_tempered_view(model, zero, runner.logprior), th0,
                          generator)

    out = _asmc_loop(model, sampler, runner, states, th0, generator)
    n_stages = out["n_stages"]
    assert out["beta"] >= 1.0 - 1e-9, (
        f"annealing did not reach beta=1 in max_stages={runner.max_stages} "
        f"(reached {out['beta']:.4f}); raise max_stages or target_ess"
    )

    cn = model.column_names()
    return MCMCChain(
        range=range(1, N + 1),
        samples=Table(out["pars"].cpu().numpy(), cn),
        gradients=Table(np.zeros((0, model.size)), cn),
        diagnostics={
            "logz": out["logZ"],
            "n_stages": n_stages,
            "betas": out["betas"],
            "ess": out["ess"],
            "accept": out["accept"],
        },
        # the final (equalized) particle ensemble is the resumable state:
        # beta has reached 1, so continuation = more MCMC rejuvenation moves
        # at the full posterior (resume_asmc)
        task=MCMCTask(model, sampler, runner, state=out["pars"],
                      key=generator.get_state(), pos=n_stages),
        run_time=time.time() - t0,
    )


def resume_asmc(task: MCMCTask, steps: int = 10):
    """Continue an annealed-SMC chain: the stored state is the final
    (unweighted) particle ensemble at beta=1, so resuming runs ``steps``
    more MCMC rejuvenation sweeps of every particle at the full posterior,
    on the chain's stored generator state, and returns a chain over the
    refreshed ensemble."""
    assert isinstance(task.runner, ASMC)
    assert task.state is not None, "ASMC task has no stored ensemble"
    model, sampler = task.model, task.sampler
    t0 = time.time()
    th = task.state
    gen = make_generator(model.device, state=task.key)
    states = sampler.init(model, th, gen)
    ctx = RunCtx(burnin=0)
    acc = torch.zeros((), dtype=th.dtype, device=th.device)
    for _ in range(steps):
        states, infos = sampler.step(model, ctx, states, gen)
        acc = acc + infos["accept"].to(th.dtype).mean()
    th_new = states.pars
    cn = model.column_names()
    return MCMCChain(
        range=range(1, th.shape[0] + 1),
        samples=Table(th_new.cpu().numpy(), cn),
        gradients=Table(np.zeros((0, model.size)), cn),
        diagnostics={"accept": float(acc / steps), "resumed_moves": steps},
        task=MCMCTask(model, sampler, task.runner, state=th_new,
                      key=gen.get_state(), pos=task.pos + steps),
        run_time=time.time() - t0,
    )
