"""No-U-Turn sampler (port of ``mcmc_jl_tpu/samplers/nuts.py``; reference:
src/samplers/NUTS.jl; Hoffman & Gelman 2011).

The tree is built iteratively, as in the JAX package: each doubling walks
the 2^j new leapfrog leaves from one edge, picks the subtree proposal by
reservoir sampling (probabilistically identical to the recursive pairwise
``rand() <= n2/(n1+n2)`` merge, NUTS.jl:106), and checks every
power-of-two-aligned sub-span for u-turns against a checkpoint stack of at
most ``maxdoublings`` stored states:

- an even leaf ``k`` is stored at slot ``popcount(k)``;
- at an odd leaf ``k``, the spans ending at ``k`` have start states in slots
  ``popcount(k>>1) - trailing_ones(k) + 1 .. popcount(k>>1)``.

Chains sit on a leading batch dimension and advance in lockstep: every
leaf is one batched leapfrog for all chains, and per-chain masks (``ok``
inside a subtree, ``s`` across doublings) hold the chains whose subtree or
trajectory has stopped, exactly as the vmapped JAX engine does.  The loops
end when no chain runs (one host sync per leaf and per doubling).

Semantics matched to the reference: log-space slice variable
``u = log(rand()) - H0`` (NUTS.jl:141), leaf validity ``u <= -H``,
divergence gate ``u >= deltamax - H`` with deltamax = 100 (NUTS.jl:90-95),
u-turn test ``dot(th+ - th-, m) < 0`` on either endpoint momentum
(NUTS.jl:50), momentum scaled by ``model.scale`` (NUTS.jl:73,138), and the
dual-averaging constants delta = 0.7, nadapt = 1000, gamma = 0.05,
kappa = 0.75, t0 = 10 (NUTS.jl:121-125).  Diagnostics: ``epsilon``,
``ndoublings``, ``diverging``.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from .base import RunCtx, Sampler, _where, state_dataclass, tree_map
from .hmcda import find_reasonable_step
from .integrators import hamiltonian, leapfrog
from .massadapt import (MassAccum, dense_transforms, mass_init, mass_kind,
                        mass_update, mass_vector_scale, z_model)

DELTAMAX = 100.0
# dual-averaging constants (NUTS.jl:121-125)
DELTA = 0.7
NADAPT = 1000
GAM = 0.05
KAPPA = 0.75
T0 = 10.0


@state_dataclass
class NUTSState:
    pars: torch.Tensor
    logtarget: torch.Tensor
    grad: torch.Tensor
    epsilon: torch.Tensor
    mu: torch.Tensor
    hbar: torch.Tensor
    lebar: torch.Tensor
    #: frozen trajectory time of a warm handoff (0 = none has run); a
    #: resume continues the handoff's sampling phase from it
    tlen: torch.Tensor
    i: torch.Tensor
    mass: MassAccum


def _popcount(k):
    """Number of set bits of a non-negative int."""
    return bin(k).count("1")


def _trailing_ones(k):
    """Number of trailing 1-bits of a non-negative int."""
    lsb0 = (k + 1) & -(k + 1)  # lowest zero bit position as power of two
    return _popcount(lsb0 - 1)


def _dot(a, b):
    return (a * b).sum(-1)


def dual_average(state, avg_alpha):
    """One dual-averaging update of the step size (NUTS.jl:162-169) given
    the mean acceptance statistic of the last subtree.  Returns
    ``(epsilon, hbar, lebar)``; past ``NADAPT`` the step is frozen at
    ``exp(lebar)``."""
    dtype = state.hbar.dtype
    i = state.i.to(dtype)
    in_adapt = state.i <= NADAPT
    hbar = state.hbar * (1.0 - 1.0 / (i + T0)) + (DELTA - avg_alpha) / (i + T0)
    le = state.mu - torch.sqrt(i) / GAM * hbar
    lebar = i ** (-KAPPA) * le + (1.0 - i ** (-KAPPA)) * state.lebar
    return (torch.where(in_adapt, torch.exp(le), torch.exp(state.lebar)),
            torch.where(in_adapt, hbar, state.hbar),
            torch.where(in_adapt, lebar, state.lebar))


@dataclasses.dataclass(frozen=True, repr=False)
class NUTS(Sampler):
    maxdoublings: int = 5
    #: False | True/"diag" (continuous Welford) | "diag-win" | "dense"
    mass_adapt: object = False
    #: False = reference-parity slice NUTS (Hoffman-Gelman Alg. 6);
    #: True = multinomial state selection (Betancourt 2017): leaves weighted
    #: by exp(-H), subtree merges by logsumexp-weighted reservoir, outer
    #: merge biased toward the new subtree
    multinomial: bool = False
    #: opt-in warm handoff (ops/warmstart.py ``warmfused_nuts_chains``):
    #: through ``run(..., chains=N)`` the burn-in runs exact NUTS, then the
    #: sampling phase runs dynamic-length HMC at the frozen eps and the
    #: warmup's own trajectory time (kernels 3b, 4 or 5).  Elsewhere, and
    #: on the generic engine, it is exact NUTS
    warm_handoff: bool = False

    needs_gradient = True

    def __post_init__(self):
        if not 0 < self.maxdoublings < 20:
            raise ValueError(
                f"maxdoublings must be in 1..19, got {self.maxdoublings}")
        mass_kind(self.mass_adapt)  # validate early

    @property
    def _kind(self):
        return mass_kind(self.mass_adapt)

    # ------------------------------------------------------------------
    def init(self, model, theta0, generator):
        lp, g = model.evalallg(theta0)
        dtype, dev = theta0.dtype, theta0.device
        shape = tuple(theta0.shape[:-1])
        m = torch.randn(theta0.shape, generator=generator, dtype=dtype,
                        device=dev) * model.scale.to(dtype)
        # initial step size heuristic (NUTS.jl:72-82), bounded
        eps = find_reasonable_step(model, theta0, lp, g, m)
        zeros = lambda: torch.zeros(shape, dtype=dtype, device=dev)  # noqa: E731
        return NUTSState(
            pars=theta0, logtarget=lp, grad=g, epsilon=eps,
            mu=torch.log(10.0 * eps), hbar=zeros(), lebar=zeros(),
            tlen=zeros(),
            i=torch.ones(shape, dtype=torch.int32, device=dev),
            mass=mass_init(self._kind, theta0.shape[-1], dtype, dev, shape,
                           scale0=model.scale),
        )

    def reset(self, model, state, theta):
        lp, g = model.evalallg(theta)
        return state.replace(pars=theta, logtarget=lp, grad=g)

    # ------------------------------------------------------------------
    #: dual-averaging statistic: "accept" (Hoffman-Gelman alpha) or
    #: "halvings" (WALNUTS: fraction of macro steps integrable un-halved)
    _adapt_stat = "accept"

    def _leaf_advance(self, model, pars, lp, m, grad, eps_signed, generator,
                      active=None):
        """Advance the orbit by one macro-grid state from (pars, lp, grad).
        Returns (pars, lp, grad, m, bad, halved): ``bad`` marks a leaf whose
        construction failed beyond the energy gate (always False for plain
        NUTS; WALNUTS uses it for irreversible adaptive steps); ``halved``
        feeds the "halvings" adaptation statistic.  ``active`` marks the
        chains still building their subtree (the others' results are
        discarded): plain NUTS steps every chain, WALNUTS only those."""
        pars, lp, g, m = leapfrog(model, pars, m, grad, eps_signed)
        no = torch.zeros(pars.shape[:-1], dtype=torch.bool, device=pars.device)
        return pars, lp, g, m, no, no

    def _build_subtree(self, model, z_edge, eps_signed, dirn, n_leaves,
                       u_slice, H0, active, generator):
        """Build a subtree of ``n_leaves`` leapfrog leaves from the edge
        state for the ``active`` chains; returns (z_end, prop, n_valid, ok,
        alpha, nalpha, diverged, logweight, irreversible), each per chain.

        Slice mode: proposal = uniform reservoir over slice-valid leaves.
        Multinomial mode: proposal = exp(H0 - H)-weighted reservoir over all
        non-diverged leaves.  One selection uniform is drawn per leaf for
        every chain."""
        pars, m, lp, grad = z_edge
        C, d = pars.shape
        dtype, dev = pars.dtype, pars.device
        md = self.maxdoublings
        ckpt_pars = torch.zeros((C, md, d), dtype=dtype, device=dev)
        ckpt_m = torch.zeros((C, md, d), dtype=dtype, device=dev)
        prop = (pars, lp, grad)
        n = torch.zeros(C, dtype=torch.int32, device=dev)
        lw = torch.full((C,), -math.inf, dtype=dtype, device=dev)
        ok = active.clone()
        no = torch.zeros(C, dtype=torch.bool, device=dev)
        div, irr = no, no
        alpha = torch.zeros(C, dtype=dtype, device=dev)
        nalpha = torch.zeros(C, dtype=torch.int32, device=dev)
        es = eps_signed.unsqueeze(-1)

        for k in range(n_leaves):
            if not bool(ok.any()):
                break
            run = ok
            new = self._leaf_advance(model, pars, lp, m, grad, es, generator,
                                     active=run)
            pars, lp, grad, m = (_where(run, a, b)
                                 for a, b in zip(new[:4], (pars, lp, grad, m)))
            bad, halved = new[4], new[5]
            H = hamiltonian(lp, m)
            diverged = (u_slice >= DELTAMAX - H) | torch.isnan(H) | bad
            leaf_ok = ~diverged
            if self._adapt_stat == "halvings":
                alpha_leaf = torch.where(bad | halved, 0.0, 1.0).to(dtype)
            else:
                alpha_leaf = torch.clamp(torch.exp(H0 - H), max=1.0)
                alpha_leaf = torch.where(torch.isnan(alpha_leaf),
                                         torch.zeros_like(alpha_leaf),
                                         alpha_leaf)

            u_sel = torch.rand(C, generator=generator, dtype=dtype, device=dev)
            if self.multinomial:
                # Boltzmann-weighted reservoir (Betancourt 2017 A.3.1)
                leaf_valid = leaf_ok
                lw_leaf = torch.where(diverged, -math.inf, H0 - H)
                lw_new = torch.logaddexp(lw, lw_leaf)
                take = leaf_ok & (torch.log(u_sel) < lw_leaf - lw_new)
            else:
                leaf_valid = u_slice <= -H  # NUTS.jl:91
                lw_new = lw
                # uniform among valid leaves == recursive n2/(n1+n2)
                take = leaf_valid & (
                    u_sel * (n + leaf_valid.to(torch.int32)).to(dtype) < 1.0)
            take = run & take
            n = torch.where(run, n + leaf_valid.to(torch.int32), n)
            lw = torch.where(run, lw_new, lw)
            prop = tuple(_where(take, a, b)
                         for a, b in zip((pars, lp, grad), prop))

            turned = no
            if k % 2 == 0:
                slot = _popcount(k)
                if slot < md:
                    ckpt_pars[:, slot] = _where(run, pars, ckpt_pars[:, slot])
                    ckpt_m[:, slot] = _where(run, m, ckpt_m[:, slot])
            else:
                # u-turn checks for every span ending at odd leaf k
                hi = _popcount(k >> 1)
                lo = hi - _trailing_ones(k) + 1
                delta = dirn[:, None, None] * (pars[:, None, :]
                                               - ckpt_pars[:, lo:hi + 1])
                turned = ((_dot(delta, ckpt_m[:, lo:hi + 1]) < 0)
                          | (_dot(delta, m[:, None, :]) < 0)).any(-1)
            ok = ok & leaf_ok & ~turned
            div = div | (run & diverged)
            irr = irr | (run & bad)
            alpha = torch.where(run, alpha + alpha_leaf, alpha)
            nalpha = torch.where(run, nalpha + 1, nalpha)

        return ((pars, m, lp, grad), prop, n, ok, alpha, nalpha, div, lw, irr)

    # ------------------------------------------------------------------
    def step(self, model, ctx: RunCtx, state, generator):
        if state.pars.ndim == 1:  # one chain: run it as a batch of one
            new, info = self._step(model, ctx,
                                   tree_map(lambda a: a.unsqueeze(0), state),
                                   generator)
            return (tree_map(lambda a: a[0], new),
                    {k: v[0] for k, v in info.items()})
        return self._step(model, ctx, state, generator)

    def _step(self, model, ctx, state, generator):
        C, d = state.pars.shape
        dtype, dev = state.pars.dtype, state.pars.device
        kind = self._kind
        if kind is not None:
            # Preconditioned NUTS in standardized coordinates theta = S z:
            # a unit-metric tree on lp_z(z) = lp(S z) (grad_z = S' grad_theta)
            # is exactly NUTS with mass M = (S S')^-1.  S is per chain: a
            # vector for the diagonal kinds, the windowed covariance's
            # Cholesky factor (seeded with diag(model.scale)) for "dense".
            if kind == "dense":
                fwd, inv, gfwd, ginv = dense_transforms(
                    state.mass.scale.to(dtype))
            else:
                s_vec = model.scale.to(dtype) * mass_vector_scale(
                    kind, state.mass, dtype)
                fwd = gfwd = lambda v: v * s_vec  # noqa: E731
                inv = ginv = lambda v: v / s_vec  # noqa: E731
            tree_model = z_model(model, fwd, gfwd)
            pars_t, grad_t = inv(state.pars), gfwd(state.grad)
            scale = torch.ones(d, dtype=dtype, device=dev)
        else:
            tree_model = model
            pars_t, grad_t = state.pars, state.grad
            scale = model.scale.to(dtype)

        m0 = torch.randn((C, d), generator=generator, dtype=dtype,
                         device=dev) * scale
        H0 = hamiltonian(state.logtarget, m0)
        if self.multinomial:
            # no slice variable; u_slice = -H0 makes the shared divergence
            # gate read H - H0 >= DELTAMAX (Stan's criterion)
            u_slice = -H0
        else:
            u_slice = torch.log(torch.rand(C, generator=generator,
                                           dtype=dtype, device=dev)) - H0

        eps = state.epsilon
        z_minus = z_plus = (pars_t, m0, state.logtarget, grad_t)
        prop = (pars_t, state.logtarget, grad_t)
        s = torch.ones(C, dtype=torch.bool, device=dev)
        n = torch.ones(C, dtype=torch.int32, device=dev)
        lw = torch.zeros(C, dtype=dtype, device=dev)  # exp(H0 - H0)
        alpha = torch.ones(C, dtype=dtype, device=dev)
        nalpha = torch.ones(C, dtype=torch.int32, device=dev)
        div = torch.zeros(C, dtype=torch.bool, device=dev)
        irr = div
        nd = torch.zeros(C, dtype=torch.int32, device=dev)

        for j in range(self.maxdoublings):
            if not bool(s.any()):
                break
            dirn = torch.where(
                torch.rand(C, generator=generator, dtype=dtype, device=dev)
                < 0.5, 1.0, -1.0).to(dtype)
            go_fwd = dirn > 0
            edge = tuple(_where(go_fwd, p, mn)
                         for p, mn in zip(z_plus, z_minus))
            (z_end, prop1, n1, s1, alpha1, nalpha1, div1, lw1,
             irr1) = self._build_subtree(tree_model, edge, dirn * eps, dirn,
                                         1 << j, u_slice, H0, s, generator)
            z_plus = tuple(_where(s & go_fwd, b, a)
                           for a, b in zip(z_plus, z_end))
            z_minus = tuple(_where(s & ~go_fwd, b, a)
                            for a, b in zip(z_minus, z_end))

            u = torch.rand(C, generator=generator, dtype=dtype, device=dev)
            if self.multinomial:
                # biased progressive merge: prob min(1, W_new/W_old)
                take = s & s1 & (torch.log(u) < lw1 - lw)
                lw = torch.where(s & s1, torch.logaddexp(lw, lw1), lw)
            else:
                # accept subtree proposal with prob n1/n (NUTS.jl:160)
                take = s & s1 & (u * n.to(dtype) < n1.to(dtype))
            prop = tuple(_where(take, b, a) for a, b in zip(prop, prop1))

            # overall u-turn between extreme states (NUTS.jl:165)
            dpars = z_plus[0] - z_minus[0]
            turned = ((_dot(dpars, z_minus[1]) < 0)
                      | (_dot(dpars, z_plus[1]) < 0))
            n = torch.where(s, n + n1, n)
            alpha = torch.where(s, alpha1, alpha)
            nalpha = torch.where(s, nalpha1, nalpha)
            div = div | (s & div1)
            irr = irr | (s & irr1)
            nd = nd + s.to(torch.int32)
            s = s & s1 & ~turned

        new_pars, new_lp, new_grad = prop
        if kind is not None:  # back to theta-space
            new_pars, new_grad = fwd(new_pars), ginv(new_grad)

        avg_alpha = alpha / torch.clamp(nalpha, min=1).to(dtype)
        new_eps, new_hbar, new_lebar = dual_average(state, avg_alpha)
        mass = mass_update(kind, state.mass, new_pars, state.i, ctx.burnin)

        info = {
            "ppars": new_pars,
            "plogtarget": new_lp,
            "pgrads": new_grad,
            "pars": state.pars,
            "logtarget": state.logtarget,
            "grads": state.grad,
            "accept": (new_pars != state.pars).any(-1),
            "epsilon": new_eps,
            "ndoublings": nd,
            "diverging": div,
        }
        if self._adapt_stat == "halvings":
            info["irreversible"] = irr
        return (
            NUTSState(pars=new_pars, logtarget=new_lp, grad=new_grad,
                      epsilon=new_eps, mu=state.mu, hbar=new_hbar,
                      lebar=new_lebar, tlen=state.tlen, i=state.i + 1,
                      mass=mass),
            info,
        )
