"""ChEES-HMC machinery (port of ``mcmc_jl_tpu/samplers/chees.py``): so far
only :func:`halton2`, the shared jitter of trajectory lengths that the warm
sampling phases of adaptive HMC, HMCDA and MALA use too.  The ``ChEESHMC``
sampler itself, with the engine's cross-chain ``sampler.pool`` hook, is the
next slice (ROADMAP queue 1 item 9).
"""
from __future__ import annotations

import torch


def halton2(i):
    """Radical inverse base 2 of the integer step index ``i`` (an int or an
    integer tensor) as float32: the paper's quasi-random jitter of
    trajectory lengths, identical across chains.  Summed in float64 and
    rounded once, as the JAX package does; exact for ``i < 2**24``."""
    i = torch.as_tensor(i, dtype=torch.int64)
    bits = torch.arange(32, dtype=torch.int64, device=i.device)
    digits = (i.unsqueeze(-1) >> bits) & 1
    w = torch.full((32,), 0.5, dtype=torch.float64,
                   device=i.device) ** (bits + 1).to(torch.float64)
    return (digits.to(torch.float64) * w).sum(-1).to(torch.float32)
