"""Slice sampler (port of ``mcmc_jl_tpu/samplers/slice.py``; Neal 2003;
reference: src/samplers/slice_sample.jl).

A standalone function, as in the reference, which never wires it into the
runner stack.  Coordinate-wise slice sampling of one chain: each sweep
steps every coordinate's interval out (at most ``MAX_STEPOUT`` widths each
way) and shrinks it until a point on the slice is found (at most
``MAX_SHRINK`` tries); a coordinate whose interval shrinks to a point
without one is abandoned for that sweep, not raised (the reference asserts,
slice_sample.jl:99).
"""
from __future__ import annotations

import numpy as np
import torch

from .base import make_generator

MAX_STEPOUT = 1000
MAX_SHRINK = 1000


def slice_sample(logdist, initial, niter, widths=None, step_out=True,
                 burnin=0, seed=0, generator=None, device=None):
    """Multivariate (coordinate-wise) slice sampling of ``logdist``.

    Returns the (niter, D) history (numpy) for a vector ``initial``; a
    scalar ``initial`` returns shape (niter,) (the reference's univariate
    interface, slice_sample.jl:110-113), and ``logdist`` then takes a
    scalar.  It runs on the device of ``initial`` when that is a tensor,
    else on ``device`` (the CUDA card by default; pass ``device="cpu"`` for
    the CPU), in the tensor's floating dtype or the default one.  Draws
    come from ``generator``, by default a new one seeded with ``seed``."""
    if isinstance(initial, torch.Tensor):
        dev = initial.device
        dtype = (initial.dtype if initial.is_floating_point()
                 else torch.get_default_dtype())
    else:
        from ..models.model import resolve_device

        dev, dtype = resolve_device(device), torch.get_default_dtype()
    scalar = np.ndim(initial) == 0
    state = torch.atleast_1d(torch.as_tensor(initial, dtype=dtype,
                                             device=dev)).clone()
    D = state.shape[0]
    if widths is None:
        widths = [1.0] * D
    else:
        widths = np.broadcast_to(np.asarray(
            widths.detach().cpu() if isinstance(widths, torch.Tensor)
            else widths, dtype=np.float64), (D,)).tolist()
    if generator is None:
        generator = make_generator(dev, seed)
    f = (lambda x: logdist(x[0])) if scalar else logdist  # noqa: E731

    def lp_of(x):
        return float(f(x))

    def uniform():
        return float(torch.rand((), generator=generator, dtype=dtype,
                                device=dev))

    def moved(x, dd, v):
        y = x.clone()
        y[dd] = v
        return y

    log_px = lp_of(state)
    history = []
    for _ in range(int(niter) + int(burnin)):
        for dd in range(D):
            log_uprime = np.log(uniform()) + log_px
            w = widths[dd]
            x0 = float(state[dd])
            r = uniform()
            lo, hi = x0 - r * w, x0 + (1.0 - r) * w
            if step_out:
                it = 0
                while it < MAX_STEPOUT and lp_of(moved(state, dd, lo)) > log_uprime:
                    lo -= w
                    it += 1
                it = 0
                while it < MAX_STEPOUT and lp_of(moved(state, dd, hi)) > log_uprime:
                    hi += w
                    it += 1
            # shrink until a point on the slice (slice_sample.jl:85-101)
            for _ in range(MAX_SHRINK):
                xi = uniform() * (hi - lo) + lo
                prop = moved(state, dd, xi)
                lp = lp_of(prop)
                if lp > log_uprime:
                    state, log_px = prop, lp
                    break
                if xi > x0:
                    hi = xi
                elif xi < x0:
                    lo = xi
        history.append(state)
    hist = torch.stack(history[int(burnin):]).cpu().numpy()
    return hist[:, 0] if scalar else hist
