"""Mass-matrix warmup (port of ``mcmc_jl_tpu/samplers/massadapt.py``).

- ``mass_adapt=True`` (or ``"diag"``): continuous Welford variance estimate
  over the whole burn-in, folded into the integrator as a per-coordinate
  scale.
- ``mass_adapt="diag-win"``: diagonal metric re-estimated at the end of
  Stan-style expanding, memoryless windows (init buffer 75, doubling
  windows from 25, terminal buffer 50), frozen after burn-in.
- ``mass_adapt="dense"``: full covariance metric from the same windowed
  Welford accumulation; the Cholesky factor ``L`` of the regularized
  estimate ``(n/(n+5)) Sigma + 1e-3 (5/(n+5)) I`` preconditions the
  dynamics in standardized coordinates ``theta = L z`` (kinetic energy
  ``1/2 p' M^{-1} p`` with ``M^{-1} = L L'``).

Every function works on accumulators with a leading chain shape: ``count``
is (...,), ``mean`` is (..., d), ``m2``/``scale`` are (..., d) for the
diagonal kinds and (..., d, d) for the dense kind (``scale`` the
lower-triangular factor).  Window boundaries are functions of the step
counter alone, so all chains of a batch share them.
"""
from __future__ import annotations

import types

import torch

from .base import _where, state_dataclass

# Stan reference-manual adaptation schedule constants
INIT_BUFFER = 75
TERM_BUFFER = 50
BASE_WINDOW = 25
REG = 1e-3  # regularization scale toward the (scaled) identity


def mass_kind(mass_adapt):
    """Normalize the user-facing ``mass_adapt`` flag to an internal kind:
    None, "diag", "diag-win" or "dense"."""
    if mass_adapt is False or mass_adapt is None:
        return None
    if mass_adapt is True:
        return "diag"
    s = str(mass_adapt)
    if s == "diag":
        return "diag"
    if s in ("diag-win", "diag_win", "diag-windowed", "diag_windowed"):
        return "diag-win"
    if s == "dense":
        return "dense"
    raise ValueError(
        f"mass_adapt must be False, True, 'diag', 'diag-win' or 'dense'; "
        f"got {mass_adapt!r}")


@state_dataclass
class MassAccum:
    """Welford accumulators + current metric scale (the JAX package's
    layout; with no adaptation they stay at their initial values)."""

    count: torch.Tensor  # int32 samples in the current window
    mean: torch.Tensor  # (d,)
    m2: torch.Tensor  # (d,) or (d, d)
    scale: torch.Tensor  # (d,) sqrt-variances, or (d, d) lower-tri L
    next_end: torch.Tensor  # int32; -1 = not yet armed
    window: torch.Tensor  # int32 current window length


def mass_init(kind, d, dtype, device=None, shape=(), scale0=None):
    """Fresh accumulator with leading chain ``shape``.  ``scale0`` (a
    scalar or a (d,) tensor, e.g. ``model.scale`` for NUTS) seeds the dense
    metric's diagonal until the first window closes; the diagonal kinds
    start at unit scale and do not read it."""
    vec = tuple(shape) + (d,)
    ints = lambda v: torch.full(shape, v, dtype=torch.int32, device=device)  # noqa: E731
    if kind == "dense":
        diag = torch.ones(d, dtype=dtype, device=device)
        if scale0 is not None:
            diag = diag * torch.as_tensor(scale0, dtype=dtype, device=device)
        scale = torch.diag(diag).expand(vec + (d,)).clone()
        m2 = torch.zeros(vec + (d,), dtype=dtype, device=device)
    else:
        scale = torch.ones(vec, dtype=dtype, device=device)
        m2 = torch.zeros(vec, dtype=dtype, device=device)
    return MassAccum(
        count=ints(0),
        mean=torch.zeros(vec, dtype=dtype, device=device),
        m2=m2,
        scale=scale,
        next_end=ints(-1),
        window=ints(BASE_WINDOW),
    )


def mass_vector_scale(kind, acc: MassAccum, dtype, count_threshold=20):
    """Per-coordinate scale: the live Welford estimate (continuous mode,
    identity until ``count_threshold`` samples) or the frozen last-window
    estimate (windowed mode)."""
    if kind == "diag":
        cnt = acc.count.to(dtype).unsqueeze(-1)
        var = acc.m2 / torch.clamp(cnt - 1.0, min=1.0)
        s = torch.sqrt(torch.clamp(var, 1e-6, 1e6))
        return torch.where((acc.count >= count_threshold).unsqueeze(-1), s,
                           torch.ones_like(s))
    return acc.scale.to(dtype)


def mass_update(kind, acc: MassAccum, x, i, burnin):
    """Post-accept transition of the accumulator at step ``i`` (1-based,
    per chain) given the new positions ``x`` (..., d)."""
    if kind is None:
        return acc
    dtype = x.dtype

    if kind == "diag":  # continuous: accumulate across the whole burn-in
        adapting = i <= burnin
        cnt = acc.count + adapting.to(torch.int32)
        cf = torch.clamp(cnt.to(dtype), min=1.0).unsqueeze(-1)
        delta = x - acc.mean
        mean = _where(adapting, acc.mean + delta / cf, acc.mean)
        m2 = _where(adapting, acc.m2 + delta * (x - mean), acc.m2)
        return acc.replace(count=cnt, mean=mean, m2=m2)

    # windowed kinds: Stan-style buffer shrinking for short adaptation spans
    full = burnin >= INIT_BUFFER + TERM_BUFFER + BASE_WINDOW
    init_buf = INIT_BUFFER if full else (burnin * 15) // 100
    term_buf = TERM_BUFFER if full else burnin // 10
    adapt_end = max(burnin - term_buf, 0)
    next_end = torch.where(acc.next_end < 0,
                           torch.clamp(init_buf + acc.window, max=adapt_end),
                           acc.next_end)
    in_win = (i > init_buf) & (i <= adapt_end)
    cnt = acc.count + in_win.to(torch.int32)
    cf = torch.clamp(cnt.to(dtype), min=1.0).unsqueeze(-1)
    delta = x - acc.mean
    mean = _where(in_win, acc.mean + delta / cf, acc.mean)
    d2 = x - mean
    dense = kind == "dense"
    upd = delta.unsqueeze(-1) * d2.unsqueeze(-2) if dense else delta * d2
    m2 = _where(in_win, acc.m2 + upd, acc.m2)

    # close the window once the counter passes its end (>=: self-healing if
    # the boundary lands before two samples accumulated)
    at_end = in_win & (i >= next_end) & (cnt >= 2)
    n = cnt.to(dtype).unsqueeze(-1)
    w = n / (n + 5.0)
    if dense:
        n, w = n.unsqueeze(-1), w.unsqueeze(-1)
        cov = m2 / torch.clamp(n - 1.0, min=1.0)
        eye = torch.eye(x.shape[-1], dtype=dtype, device=x.device)
        # a chain whose factorization fails (info != 0, or NaN: JAX's
        # cholesky gives NaN where torch's raises) keeps its old factor
        chol, info = torch.linalg.cholesky_ex(w * cov + REG * (1.0 - w) * eye)
        ok = (info == 0) & ~torch.isnan(chol).any(-1).any(-1)
        est = _where(ok, chol, acc.scale)
    else:
        var = m2 / torch.clamp(n - 1.0, min=1.0)
        est = torch.sqrt(w * var + REG * (1.0 - w))
    scale = _where(at_end, est, acc.scale)

    new_window = acc.window * 2
    cand = i + new_window
    # Stan: if the window after next would overrun the adaptation span,
    # extend the next window to the end instead
    cand = torch.where(cand + 2 * new_window > adapt_end,
                       torch.full_like(cand, adapt_end), cand)
    cand = torch.clamp(torch.maximum(cand, i + 1), max=adapt_end)

    return MassAccum(
        count=torch.where(at_end, torch.zeros_like(cnt), cnt),
        mean=_where(at_end, torch.zeros_like(mean), mean),
        m2=_where(at_end, torch.zeros_like(m2), m2),
        scale=scale,
        next_end=torch.where(at_end, cand, next_end),
        window=torch.where(at_end, new_window, acc.window),
    )


def dense_transforms(L):
    """Coordinate maps for the dense metric ``theta = L z``, with ``L``
    (..., d, d) lower-triangular and the points (..., d) rows: returns
    ``(fwd, inv, grad_fwd, grad_inv)`` with ``grad_z = L' grad_theta``
    (chain rule) and its inverse; the inverses are triangular solves."""
    def mv(A, v):
        return (A @ v.unsqueeze(-1)).squeeze(-1)

    def solve(A, v, upper):
        return torch.linalg.solve_triangular(A, v.unsqueeze(-1),
                                             upper=upper).squeeze(-1)

    Lt = L.transpose(-1, -2)
    return (lambda z: mv(L, z), lambda t: solve(L, t, False),
            lambda g: mv(Lt, g), lambda g: solve(Lt, g, True))


def z_model(model, fwd, grad_fwd):
    """``model`` in standardized coordinates: an object whose
    ``evalallg(z)`` is ``(lp(fwd(z)), grad_fwd(grad(fwd(z))))``, for the
    integrators and the NUTS tree."""
    def evalallg(z):
        lp, g = model.evalallg(fwd(z))
        return lp, grad_fwd(g)

    return types.SimpleNamespace(evalallg=evalallg)
