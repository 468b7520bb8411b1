"""Affine-invariant ensemble sampler (port of ``mcmc_jl_tpu/runners/aies.py``;
Goodman & Weare 2010) — batched stretch moves in the parallel red-black
scheme of emcee (Foreman-Mackey et al. 2013).

W walkers are one (W, d) batch advanced by two half-ensemble updates a
step: every walker of the active half takes one ``model.eval`` of the
batch, the second half moves against the first half's updated walkers.
No gradients and no tuning; affine invariance makes it immune to the
badly-scaled or correlated targets that force mass-matrix adaptation
elsewhere.

Move: for walker x_k in the active half, pick partner x_j from the other
half, draw z ~ g(z) ∝ 1/sqrt(z) on [1/a, a] (inverse CDF:
z = ((a-1)u + 1)^2 / a), propose y = x_j + z (x_k - x_j), accept with
log-prob (d-1) log z + logp(y) - logp(x_k); a NaN ratio rejects.

Composition: ``run(model * AIES(steps=..., walkers=...))``: no sampler
slot (the move is the sampler); returns a list of per-walker chains, each
of whose tasks carries the whole ``(pars (W, d), lp (W,))`` ensemble.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..core.chain import MCMCChain
from ..core.task import MCMCTask
from ..samplers.base import make_generator
from ..utils.table import Table


@dataclasses.dataclass(frozen=True)
class AIES:
    """Affine-invariant ensemble runner config.

    ``walkers`` must be even and at least 2*(d+1) for a non-degenerate
    complementary ensemble (checked against the model at run time);
    ``a`` is the stretch scale (acceptance falls as ``a`` grows).
    """

    steps: int = 1000
    burnin: int = 0
    walkers: int = 64
    a: float = 2.0
    jitter: float = 0.5  # initial walker ball radius (times model.scale)

    # the stretch move is its own sampler: model * AIES is a complete task
    _samplerless_runner = True

    def __post_init__(self):
        assert self.steps > self.burnin >= 0
        assert self.walkers >= 4 and self.walkers % 2 == 0, (
            "walkers must be even and >= 4"
        )
        assert self.a > 1.0, "stretch scale a must be > 1"

    def __rmul__(self, model):
        # model * AIES(...): the stretch move is the sampler, so the product
        # is already a complete task (sampler slot empty)
        return MCMCTask(model, None, self)


def _half(model_eval, pars, lp, lo, u, j, logu, a):
    """Update walkers ``[lo, lo + H)`` against the complementary half, on
    given draws: ``u`` (H,) uniforms of the stretch, ``j`` (H,) partner
    indices into the other half, ``logu`` (H,) log-uniforms of the accept
    test.  Returns (pars, lp, accepted)."""
    W, d = pars.shape
    H = W // 2
    act, lp_act = pars[lo:lo + H], lp[lo:lo + H]
    oth = pars[(lo + H) % W:(lo + H) % W + H]
    z = ((a - 1.0) * u + 1.0) ** 2 / a
    anchor = oth[j]
    prop = anchor + z[:, None] * (act - anchor)
    lp_prop = model_eval(prop)
    ratio = (d - 1) * torch.log(z) + lp_prop - lp_act
    ratio = torch.where(torch.isnan(ratio), -torch.inf, ratio)
    acc = (ratio > 0) | (ratio > logu)
    new_act = torch.where(acc[:, None], prop, act)
    new_lp = torch.where(acc, lp_prop, lp_act)
    if lo == 0:
        return (torch.cat([new_act, pars[H:]]), torch.cat([new_lp, lp[H:]]),
                acc)
    return torch.cat([pars[:H], new_act]), torch.cat([lp[:H], new_lp]), acc


def _half_draws(generator, H, dtype, device):
    u = torch.rand(H, generator=generator, dtype=dtype, device=device)
    j = torch.randint(0, H, (H,), generator=generator, device=device)
    logu = torch.log(torch.rand(H, generator=generator, dtype=dtype,
                                device=device))
    return u, j, logu


def _aies_loop(model_eval, pars, lp, generator, *, steps, a):
    """(W, d) ensemble advanced ``steps`` red-black sweeps; returns the
    final (pars, lp) and the per-step rows stacked on the device."""
    H = pars.shape[0] // 2
    rows = {"ppars": [], "plogtarget": [], "accept": []}
    for _ in range(steps):
        pars, lp, acc1 = _half(model_eval, pars, lp, 0,
                               *_half_draws(generator, H, pars.dtype,
                                            pars.device), a)
        pars, lp, acc2 = _half(model_eval, pars, lp, H,
                               *_half_draws(generator, H, pars.dtype,
                                            pars.device), a)
        rows["ppars"].append(pars)
        rows["plogtarget"].append(lp)
        rows["accept"].append(torch.cat([acc1, acc2]))
    return (pars, lp), {k: torch.stack(v) for k, v in rows.items()}


def run_aies(model, runner: AIES, seed: int = 0, generator=None,
             _carry_state=None, _pos=0):
    """Run the stretch-move ensemble; returns one chain per walker.

    ``_carry_state``: a ``(pars (W, d), lp (W,))`` ensemble to continue from
    (the resume path) instead of a fresh init ball."""
    t0 = time.time()
    if generator is None:
        generator = make_generator(model.device, seed)
    W, d = runner.walkers, model.size
    assert W >= 2 * (d + 1), (
        f"AIES needs walkers >= 2*(d+1) = {2 * (d + 1)} for a {d}-D model "
        f"(complementary half must span the space); got {W}"
    )
    if _carry_state is not None:
        pars0, lp0 = _carry_state
        assert tuple(pars0.shape) == (W, d), (
            f"carried ensemble shape {tuple(pars0.shape)} != (walkers, d) = "
            f"({W}, {d})")
    else:
        noise = torch.randn((W, d), generator=generator, dtype=model.dtype,
                            device=model.device)
        pars0 = model.init + runner.jitter * model.scale * noise
        lp0 = model.eval(pars0)

    (pars, lp), ys = _aies_loop(model.eval, pars0, lp0, generator,
                                steps=runner.steps, a=runner.a)

    keep = slice(runner.burnin, None)
    cn = model.column_names()
    host = {k: v.cpu().numpy() for k, v in ys.items()}  # (steps, W, ...)
    key = generator.get_state()

    def one_chain(w):
        return MCMCChain(
            range=range(runner.burnin + 1, runner.steps + 1),
            samples=Table(host["ppars"][keep, w], cn),
            gradients=Table(np.zeros((0, d)), cn),
            diagnostics={
                "accept": host["accept"][keep, w],
                "logtarget": host["plogtarget"][keep, w],
            },
            task=MCMCTask(model, None, runner, state=(pars, lp), key=key,
                          pos=_pos + runner.steps),
            run_time=time.time() - t0,
        )

    return [one_chain(w) for w in range(W)]


def resume_aies(task: MCMCTask, steps: int = 100):
    """Exact continuation of the whole walker ensemble: every walker's
    chain carries the full ``(pars, lp)`` ensemble and the same generator
    state, so resuming any of them resumes all walkers alike.  Returns the
    full list of per-walker chains, like :func:`run_aies`."""
    assert isinstance(task.runner, AIES)
    assert task.state is not None, "AIES task has no stored ensemble state"
    runner = dataclasses.replace(task.runner, steps=steps, burnin=0)
    gen = make_generator(task.model.device, state=task.key)
    return run_aies(task.model, runner, generator=gen,
                    _carry_state=task.state, _pos=task.pos)
