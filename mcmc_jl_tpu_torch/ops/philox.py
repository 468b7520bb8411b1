"""Plain version of ``csrc/philox.cuh``: Philox4x32-10 (Salmon et al.,
SC'11), the 24-bit uniform and the Box-Muller normals that the kernels draw
inside, computed with torch's int64 arithmetic on any device.

It lets a check feed a kernel's own draws to the kernel's plain version:
:func:`.target_kernels.target_multistep_draws`,
:func:`.rwm_kernels.rwm_draws`, :func:`.glm_kernels.glm_multistep_draws`
and :func:`.nuts_kernels.glm_nuts_multistep_draws` lay them out as those
kernels count them, on the device they are asked for (millions of draws
replay on the card in milliseconds).  Words are int64 tensors holding
uint32 values; counters may also be ints or numpy arrays, which start on
the CPU.  The normals and log-uniforms are computed in double and rounded
to float32, so they lie within a few float32 ulps of the kernels'
``logf``, ``sqrtf``, ``cospif`` and ``sinpif``.
"""
from __future__ import annotations

import math

import numpy as np
import torch

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85


def _words(x, device=None):
    """``x`` (a tensor, an int or a numpy array of uint32 values) as an
    int64 tensor: a tensor stays on its device, anything else goes to
    ``device`` (the CPU unless given)."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64)
    return torch.as_tensor(np.asarray(x, dtype=np.int64), device=device)


def _mulhilo(a, m):
    """(high, low) 32-bit words of a * m for int64 tensors a < 2**32 and a
    constant m < 2**32, with no product past 2**48."""
    ah, al = a >> 16, a & 0xFFFF
    p_hi, p_lo = ah * m, al * m
    return (p_hi + (p_lo >> 16)) >> 16, (((p_hi & 0xFFFF) << 16) + p_lo) & \
        0xFFFFFFFF


def philox4x32(ctr, seed):
    """Philox4x32-10 of the counters ``ctr`` (four broadcastable words or
    arrays of them) under the key (low, high 32 bits of the 64-bit
    ``seed``), as ``philox(make_uint4(...), key)`` computes it.  Returns
    four int64 tensors of uint32 values on the device of the counters'
    tensors (the CPU where none is one)."""
    dev = next((c.device for c in ctr if isinstance(c, torch.Tensor)), None)
    x0, x1, x2, x3 = torch.broadcast_tensors(*(_words(c, dev) for c in ctr))
    k0, k1 = int(seed) & 0xFFFFFFFF, (int(seed) >> 32) & 0xFFFFFFFF
    for r in range(10):
        if r:
            k0, k1 = (k0 + _W0) & 0xFFFFFFFF, (k1 + _W1) & 0xFFFFFFFF
        hi0, lo0 = _mulhilo(x0, _M0)
        hi1, lo1 = _mulhilo(x2, _M1)
        x0, x1, x2, x3 = hi1 ^ x1 ^ k0, lo1, hi0 ^ x3 ^ k1, lo0
    return x0, x1, x2, x3


def u01(b):
    """U[0, 1) from the top 24 bits of the word ``b`` (float64, exact)."""
    return (_words(b) >> 8).double() * (1.0 / 16777216.0)


def uniform(b):
    """The kernels' uniform in (0, 1], 1 - U[0, 1), as float32."""
    return (1.0 - u01(b)).float()


def box_muller(b1, b2):
    """The cosine-branch normal of (1 - u1, u2), as float32."""
    return box_muller_pair(b1, b2)[0]


def box_muller_pair(b1, b2):
    """The cosine- and sine-branch normals of (1 - u1, u2), as float32:
    the two independent normals of one Box-Muller pair."""
    r = torch.sqrt(-2.0 * torch.log(1.0 - u01(b1)))
    t = 2.0 * math.pi * u01(b2)
    return (r * torch.cos(t)).float(), (r * torch.sin(t)).float()


def log1m_u01(b):
    """log(1 - u) of the 24-bit uniform, as float32."""
    return torch.log(1.0 - u01(b)).float()
