"""Mass-matrix state (port of the part of ``mcmc_jl_tpu/samplers/massadapt.py``
that fixed-metric HMC needs).

``HMCState.mass`` carries a :class:`MassAccum` even with ``mass_adapt=False``
so states keep the JAX package's layout.  The adaptive kinds ("diag",
"diag-win", "dense") are ROADMAP queue 1 item 9 and raise here.
"""
from __future__ import annotations

import torch

from .base import state_dataclass

BASE_WINDOW = 25


def mass_kind(mass_adapt):
    """Normalize the user-facing ``mass_adapt`` flag to an internal kind;
    only ``False``/``None`` (no adaptation) is ported."""
    if mass_adapt is False or mass_adapt is None:
        return None
    raise NotImplementedError(
        f"mass_adapt={mass_adapt!r} is not ported yet (ROADMAP queue 1 item 9); "
        f"use mass_adapt=False")


@state_dataclass
class MassAccum:
    """Welford accumulators + current metric scale (layout of the JAX
    package; with no adaptation they stay at their initial values)."""

    count: torch.Tensor  # int32 samples in the current window
    mean: torch.Tensor  # (d,)
    m2: torch.Tensor  # (d,)
    scale: torch.Tensor  # (d,) sqrt-variances
    next_end: torch.Tensor  # int32; -1 = not yet armed
    window: torch.Tensor  # int32 current window length


def mass_init(kind, d, dtype, device=None, shape=()):
    """Fresh accumulator with leading chain ``shape``."""
    mass_kind(kind)
    vec = shape + (d,)
    ints = lambda v: torch.full(shape, v, dtype=torch.int32, device=device)  # noqa: E731
    return MassAccum(
        count=ints(0),
        mean=torch.zeros(vec, dtype=dtype, device=device),
        m2=torch.zeros(vec, dtype=dtype, device=device),
        scale=torch.ones(vec, dtype=dtype, device=device),
        next_end=ints(-1),
        window=ints(BASE_WINDOW),
    )
