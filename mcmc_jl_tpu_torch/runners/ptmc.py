"""Parallel tempering (replica exchange) runner, batched (port of
``mcmc_jl_tpu/runners/ptmc.py``).

The reference's tempering is *serial* (one walker hopping a task ladder,
SerialTempMC.jl).  Here every rung of every ladder advances together: W
independent ladders of K inverse temperatures are one batch of W·K chains
(row ``w*K + k`` is walker w's rung k) on the power posteriors
``logp_b(theta) = beta * logp(theta)``, and every ``swap_period`` steps the
even or odd neighbour pairs of each ladder exchange positions (Metropolis
on ``(beta_i - beta_j)(ll_j - ll_i)``) as one gather.  The JAX package's
``lax.scan`` is a host loop over the batch; a step without a swap computes
no swap.

Works with any sampler that uses ``model.eval`` / ``model.evalallg`` /
``model.scale`` (RWM, IMH, RAM, MALA, Barker, HMC, HMCDA, NUTS); the chain
returned is the cold rung (beta = 1, the last ladder entry), with the swap
diagnostics.  On a float32 catalog model on the card every gradient is one
launch of the custom-target gradient pass (``model.evalallg``).

With ``logprior=`` the ladder tempers only the likelihood part
(``logp_b = logprior + b*(logp - logprior)``, Friel & Pettitt power
posteriors), which makes ``beta=0`` a proper target (the prior) and turns
the per-rung log-likelihood draws (``diagnostics["replica_ll"]``) into the
inputs of the evidence estimators in ``stats/evidence.py``.  ``logprior``
is written for one parameter vector, as a callable model is, and lifted
over rows with ``torch.func.vmap``; its gradient is ``torch.func.grad``.

With ``mesh=`` the walkers split over the mesh's ``'chains'`` axis: each
shard advances its ladders on its entry's device from its own generator,
and as every ladder lives on one shard, swaps stay local and the shards
never meet.
"""
from __future__ import annotations

import dataclasses
import time
import types
from typing import Tuple

import numpy as np
import torch

from ..core.chain import MCMCChain
from ..core.task import MCMCTask
from ..models.model import _batched
from ..samplers.base import RunCtx, make_generator, tree_map
from ..utils.table import Table


@dataclasses.dataclass(frozen=True)
class PTMC:
    """Parallel-tempering runner config.

    ``betas``: ascending inverse temperatures ending at 1.0 (the target).
    """

    steps: int = 1000
    burnin: int = 0
    swap_period: int = 5
    betas: Tuple[float, ...] = (0.1, 0.3, 0.6, 1.0)
    #: independent ladders run as one batch of walkers * K chains; returns
    #: a list of cold-rung chains when > 1
    walkers: int = 1
    #: normalized log prior density theta -> logpi(theta), for one vector.
    #: When given, the ladder runs power posteriors ``logprior +
    #: beta*loglik``, beta=0 is allowed (it targets the prior), and
    #: ``diagnostics["replica_ll"]`` holds per-rung log-likelihood draws for
    #: stats.evidence.logz_ti / logz_ss.
    logprior: object = None

    def __post_init__(self):
        assert self.burnin >= 0
        assert self.steps > self.burnin
        assert self.swap_period >= 1
        assert self.walkers >= 1
        b = tuple(self.betas)
        assert len(b) >= 2 and all(x >= 0 for x in b), (
            "betas must be non-negative"
        )
        assert all(b[i] < b[i + 1] for i in range(len(b) - 1)), (
            "betas must be ascending"
        )
        assert abs(b[-1] - 1.0) < 1e-12, "last beta must be 1.0 (the target)"
        if b[0] == 0.0:
            assert self.logprior is not None, (
                "beta=0 targets the bare prior: it is only proper with "
                "prior tempering (pass logprior=)"
            )
        object.__setattr__(self, "betas", b)

    def __rmul__(self, other):
        from ..core.task import product

        return product(other, self)


def _prior_fns(logprior):
    """(logprior over rows, (logprior, its gradient) over rows) of a
    per-vector ``logprior``, lifted as the port's callable models are."""
    def one(th):
        return torch.as_tensor(logprior(th), dtype=th.dtype, device=th.device)

    def value_grad(th):
        g, lp = torch.func.grad_and_value(one)(th)
        return lp, g

    return _batched(one), _batched(value_grad)


def _tempered_view(model, beta, logprior=None):
    """The tempered model every chain of a batch sees.

    ``beta`` is a 0-d tensor (one temperature for every row) or one per
    chain row, ``(C,)``, broadcast against ``lp`` and ``g``'s leading
    dimension.  Plain tempering: ``beta * logp``.  Prior tempering
    (``logprior`` given): the power posterior ``logprior + beta * (logp -
    logprior)``.  A call on other rows than ``beta``'s would pair them with
    the wrong temperatures, so it raises."""
    if logprior is not None:
        prior, prior_allg = _prior_fns(logprior)
    bg = beta.unsqueeze(-1) if beta.ndim else beta

    def rows(th):
        if beta.ndim and tuple(th.shape[:-1]) != tuple(beta.shape):
            raise ValueError(
                f"tempered view evaluated on rows {tuple(th.shape[:-1])}, "
                f"but its temperatures are for rows {tuple(beta.shape)}: "
                f"every chain must be evaluated with its own beta")

    def eval_(th):
        rows(th)
        lp = model.eval(th)
        if logprior is None:
            return beta * lp
        pl = prior(th)
        return pl + beta * (lp - pl)

    def evalallg(th):
        rows(th)
        lp, g = model.evalallg(th)
        if logprior is None:
            return beta * lp, bg * g
        pl, gp = prior_allg(th)
        return pl + beta * (lp - pl), gp + bg * (g - gp)

    return types.SimpleNamespace(
        eval=eval_,
        evalallg=None if model.evalallg is None else evalallg,
        scale=model.scale,
        size=model.size,
    )


def _untempered(model, states, betas_v, logprior, has_b0):
    """Per-rung (prior logp, its gradient, tempered-part draws, their
    gradients) of a batch of ``(W*K,)`` rows as ``(W, K, ...)``: plain
    tempering -> (0, None, logp, grad); prior tempering -> the
    log-likelihood and its gradient (Friel-Pettitt power posterior).  The
    beta=0 rung's cached logtarget is the prior alone, so its likelihood
    is evaluated fresh (one more evaluation a step)."""
    K = betas_v.shape[0]
    pars = states.pars
    W, d = pars.shape[0] // K, pars.shape[-1]
    has_grad = hasattr(states, "grad")
    beta_safe = torch.where(betas_v > 0, betas_v, torch.ones_like(betas_v))
    lp_t = states.logtarget.reshape(W, K)
    if logprior is None:
        pri = torch.zeros_like(lp_t)
        gpri = None
    else:
        prior, prior_allg = _prior_fns(logprior)
        if has_grad:
            pri, gpri = prior_allg(pars)
            pri, gpri = pri.reshape(W, K), gpri.reshape(W, K, d)
        else:
            pri, gpri = prior(pars).reshape(W, K), None
    ll = (lp_t - pri) / beta_safe
    gll = None
    if has_grad:
        gpri_a = 0.0 if gpri is None else gpri
        gll = (states.grad.reshape(W, K, d) - gpri_a) / beta_safe[:, None]
    if has_b0:
        p0 = pars.reshape(W, K, d)[:, 0]
        if has_grad:
            lp0, g0 = model.evalallg(p0)
            gll = torch.cat([(g0 - gpri[:, 0])[:, None], gll[:, 1:]], dim=1)
        else:
            lp0 = model.eval(p0)
        ll = torch.cat([(lp0 - pri[:, 0])[:, None], ll[:, 1:]], dim=1)
    return pri, gpri, ll, gll


def _swap(states, u, parity, betas_v, pri, gpri, ll, gll):
    """Even/odd neighbour exchange within each ladder as one gather.
    ``u`` (W, K): one uniform per rung, the left member's taken for its
    pair.  Returns (states, ll, swaps a walker)."""
    W, K = ll.shape
    d = states.pars.shape[-1]
    dev = ll.device
    idx = torch.arange(K, device=dev)
    is_left = (idx % 2) == parity
    partner = torch.where(is_left, idx + 1, idx - 1)
    valid = (partner >= 0) & (partner < K)
    partner = partner.clamp(0, K - 1)

    # the pair's accept test, computed symmetrically so both members decide
    # identically
    ratio = (betas_v - betas_v[partner]) * (ll[:, partner] - ll)
    pair_u = torch.where(is_left, u, u[:, partner])
    acc = valid & (torch.log(pair_u) < ratio)

    src = torch.where(acc, partner, idx)  # (W, K)
    flat = (src + K * torch.arange(W, device=dev)[:, None]).reshape(-1)
    new_ll = torch.gather(ll, 1, src)
    new_lp = torch.gather(pri, 1, src) + betas_v * new_ll
    new = states.replace(pars=states.pars[flat],
                         logtarget=new_lp.reshape(-1))
    if hasattr(states, "grad"):
        gsrc = src[:, :, None].expand(W, K, d)
        gpri_a = 0.0 if gpri is None else torch.gather(gpri, 1, gsrc)
        new = new.replace(grad=(gpri_a + betas_v[:, None]
                                * torch.gather(gll, 1, gsrc)).reshape(-1, d))
    if hasattr(states, "logcandidate"):
        # IMH caches log q(pars); q is temperature-independent, so the
        # cache swaps with the position
        new = new.replace(logcandidate=states.logcandidate[flat])
    nswaps = (valid & acc).sum(dim=1).to(ll.dtype) / 2.0
    return new, new_ll, nswaps


def _swap_uniforms(generator, W, K, dtype, device):
    """One uniform a rung of every ladder, (W, K)."""
    return torch.rand((W, K), generator=generator, dtype=dtype, device=device)


def _ptmc_loop(model, sampler, ctx, states, generator, *, steps, swap_period,
               betas, logprior=None):
    """``steps`` transitions of a batch of ``W*K`` rows (the JAX package's
    ``_ptmc_scan`` over the walkers); returns (final states, per-step
    records stacked on the device)."""
    K = len(betas)
    dtype, dev = states.pars.dtype, states.pars.device
    W, d = states.pars.shape[0] // K, states.pars.shape[-1]
    betas_v = torch.tensor(betas, dtype=dtype, device=dev)
    view = _tempered_view(model, betas_v.repeat(W), logprior)
    has_b0 = logprior is not None and betas[0] == 0.0
    no_swaps = torch.zeros(W, dtype=dtype, device=dev)
    rows = {"ppars": [], "plogtarget": [], "accept": [], "nswaps": [],
            "replica_ll": []}
    for i in range(1, steps + 1):
        states, info = sampler.step(view, ctx, states, generator)
        pri, gpri, ll, gll = _untempered(model, states, betas_v, logprior,
                                         has_b0)
        nswaps = no_swaps
        if i % swap_period == 0:
            u = _swap_uniforms(generator, W, K, dtype, dev)
            states, ll, nswaps = _swap(states, u, (i // swap_period) % 2,
                                       betas_v, pri, gpri, ll, gll)
        rows["ppars"].append(states.pars.reshape(W, K, d)[:, -1])
        rows["plogtarget"].append(states.logtarget.reshape(W, K)[:, -1])
        rows["accept"].append(
            info["accept"].reshape(W, K)[:, -1] if "accept" in info
            else torch.ones(W, dtype=torch.bool, device=dev))
        rows["nswaps"].append(nswaps)
        rows["replica_ll"].append(ll)
    return states, {k: torch.stack(v, dim=1) for k, v in rows.items()}


def _ptmc_mesh(model, sampler, ctx, states, generator, mesh, W, **kw):
    """:func:`_ptmc_loop` shard by shard: the ``W`` ladders split over
    ``mesh``'s ``'chains'`` axis, shard ``i`` on its entry's device from
    its own generator (seeds drawn from ``generator``).  Returns the joined
    (final states, per-step records) on the model's device."""
    from ..parallel.mesh import map_chain_shards, model_on

    n_dev = mesh.shape["chains"]
    assert W % n_dev == 0, (
        f"PTMC walkers ({W}) must divide the mesh 'chains' axis "
        f"({n_dev}) to shard — a mesh with walkers=1 would be a silent "
        f"no-op"
    )
    return map_chain_shards(
        lambda i, dev, st, gen: _ptmc_loop(model_on(model, dev), sampler,
                                           ctx, st, gen, **kw),
        states, mesh, model.device, axis="chains", generator=generator)


def run_ptmc(model, sampler, runner: PTMC, seed: int = 0, generator=None,
             mesh=None, _carry_states=None, _pos=0):
    """Run replica-exchange tempering; returns the cold-rung chain (or a
    list of them with ``walkers > 1``, the ladders advanced as one batch,
    split over ``mesh``'s ``'chains'`` axis when one is given: the axis
    size must divide ``walkers``).  ``_carry_states``: a (K,)-ladder state
    to continue from (the resume path) instead of fresh initialization."""
    sampler.check(model)
    t0 = time.time()
    if generator is None:
        generator = make_generator(model.device, seed)
    K, W = len(runner.betas), runner.walkers
    betas_v = torch.tensor(runner.betas, dtype=model.dtype,
                           device=model.device)
    if _carry_states is not None:
        assert W == 1, "resume continues one walker's ladder at a time"
        states = _carry_states
    else:
        theta0 = model.init.expand(W * K, model.size).clone()
        states = sampler.init(_tempered_view(model, betas_v.repeat(W),
                                             runner.logprior),
                              theta0, generator)
    ctx = RunCtx(burnin=runner.burnin)
    kw = dict(steps=runner.steps, swap_period=runner.swap_period,
              betas=runner.betas, logprior=runner.logprior)
    if mesh is not None:
        final_states, ys = _ptmc_mesh(model, sampler, ctx, states,
                                      generator, mesh, W, **kw)
    else:
        final_states, ys = _ptmc_loop(model, sampler, ctx, states,
                                      generator, **kw)

    keep = slice(runner.burnin, None)
    cn = model.column_names()
    host = {k: v.cpu().numpy() for k, v in ys.items()}
    # per-walker continuation streams, stored as generator states
    seeds = torch.randint(0, 2 ** 62, (W,), generator=generator,
                          device=generator.device).tolist()
    g = make_generator(generator.device)

    def one_chain(w):
        g.manual_seed(seeds[w])
        fstate = tree_map(lambda x: x[w * K:(w + 1) * K], final_states)
        return MCMCChain(
            range=range(runner.burnin + 1, runner.steps + 1),
            samples=Table(host["ppars"][w][keep], cn),
            gradients=Table(np.zeros((0, model.size)), cn),
            diagnostics={
                "accept": host["accept"][w][keep],
                "nswaps": host["nswaps"][w][keep],
                "logtarget": host["plogtarget"][w][keep],
                # (steps, K) per-rung log-likelihood (prior tempering) /
                # untempered logp (plain); burn-in rows kept so evidence
                # estimators can choose their own discard
                "replica_ll": host["replica_ll"][w],
                "betas": np.asarray(runner.betas),
            },
            task=MCMCTask(model, sampler, runner, state=fstate,
                          key=g.get_state(), pos=_pos + runner.steps),
            run_time=time.time() - t0,
        )

    if W == 1:
        return one_chain(0)
    return [one_chain(w) for w in range(W)]


def resume_ptmc(task, steps: int = 100):
    """Exact continuation of a PTMC chain: the whole ladder's sampler
    states (tuner and dual-averaging adaptation included) carry over, and
    the run draws from the chain's stored generator state."""
    runner = dataclasses.replace(task.runner, steps=steps, burnin=0,
                                 walkers=1)
    gen = make_generator(task.model.device, state=task.key)
    return run_ptmc(task.model, task.sampler, runner, generator=gen,
                    _carry_states=task.state, _pos=task.pos)
