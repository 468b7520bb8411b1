"""Mass-matrix warmup (port of ``mcmc_jl_tpu/samplers/massadapt.py``, the
diagonal kinds).

- ``mass_adapt=True`` (or ``"diag"``): continuous Welford variance estimate
  over the whole burn-in, folded into the integrator as a per-coordinate
  scale.
- ``mass_adapt="diag-win"``: diagonal metric re-estimated at the end of
  Stan-style expanding, memoryless windows (init buffer 75, doubling
  windows from 25, terminal buffer 50), frozen after burn-in.
- ``mass_adapt="dense"`` is ROADMAP queue 1 item 9 and raises here.

Every function works on accumulators with a leading chain shape: ``count``
is (...,), ``mean``/``m2``/``scale`` are (..., d).  Window boundaries are
functions of the step counter alone, so all chains of a batch share them.
"""
from __future__ import annotations

import torch

from .base import _where, state_dataclass

# Stan reference-manual adaptation schedule constants
INIT_BUFFER = 75
TERM_BUFFER = 50
BASE_WINDOW = 25
REG = 1e-3  # regularization scale toward the (scaled) identity


def mass_kind(mass_adapt):
    """Normalize the user-facing ``mass_adapt`` flag to an internal kind:
    None, "diag" or "diag-win"."""
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
        raise NotImplementedError(
            "mass_adapt='dense' is not ported yet (ROADMAP queue 1 item 9); "
            "use False, True/'diag' or 'diag-win'")
    raise ValueError(
        f"mass_adapt must be False, True, 'diag', 'diag-win' or 'dense'; "
        f"got {mass_adapt!r}")


@state_dataclass
class MassAccum:
    """Welford accumulators + current metric scale (the JAX package's
    layout; with no adaptation they stay at their initial values)."""

    count: torch.Tensor  # int32 samples in the current window
    mean: torch.Tensor  # (d,)
    m2: torch.Tensor  # (d,)
    scale: torch.Tensor  # (d,) sqrt-variances
    next_end: torch.Tensor  # int32; -1 = not yet armed
    window: torch.Tensor  # int32 current window length


def mass_init(kind, d, dtype, device=None, shape=(), scale0=None):
    """Fresh accumulator with leading chain ``shape``.  ``scale0`` seeds
    the dense metric in the JAX package; the diagonal kinds start at unit
    scale, so it is accepted and not read."""
    vec = tuple(shape) + (d,)
    ints = lambda v: torch.full(shape, v, dtype=torch.int32, device=device)  # noqa: E731
    return MassAccum(
        count=ints(0),
        mean=torch.zeros(vec, dtype=dtype, device=device),
        m2=torch.zeros(vec, dtype=dtype, device=device),
        scale=torch.ones(vec, dtype=dtype, device=device),
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

    # diag-win: Stan-style buffer shrinking for short adaptation spans
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
    m2 = _where(in_win, acc.m2 + delta * (x - mean), acc.m2)

    # close the window once the counter passes its end (>=: self-healing if
    # the boundary lands before two samples accumulated)
    at_end = in_win & (i >= next_end) & (cnt >= 2)
    n = cnt.to(dtype).unsqueeze(-1)
    w = n / (n + 5.0)
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
