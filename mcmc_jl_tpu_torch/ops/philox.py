"""Plain version of ``csrc/philox.cuh``: Philox4x32-10 (Salmon et al.,
SC'11), the 24-bit uniform and the Box-Muller normals that the kernels draw
inside, computed on the host with numpy's uint64 arithmetic.

It lets a check feed a kernel's own draws to the kernel's plain version:
:func:`.target_kernels.target_multistep_draws` and
:func:`.rwm_kernels.rwm_draws` lay them out as those kernels count them.
The normals and log-uniforms are computed in double and rounded to
float32, so they lie within a few float32 ulps of the kernels' ``logf``,
``sqrtf``, ``cospif`` and ``sinpif``.
"""
from __future__ import annotations

import numpy as np

_M0, _M1 = np.uint64(0xD2511F53), np.uint64(0xCD9E8D57)
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_LO = np.uint64(0xFFFFFFFF)


def philox4x32(ctr, seed):
    """Philox4x32-10 of the counters ``ctr`` (four broadcastable arrays of
    uint32 words) under the key (low, high 32 bits of the 64-bit ``seed``),
    as ``philox(make_uint4(...), key)`` computes it.  Returns four uint32
    arrays."""
    x0, x1, x2, x3 = (np.array(c, dtype=np.uint64)
                      for c in np.broadcast_arrays(*ctr))
    k0, k1 = int(seed) & 0xFFFFFFFF, (int(seed) >> 32) & 0xFFFFFFFF
    for r in range(10):
        if r:
            k0, k1 = (k0 + _W0) & 0xFFFFFFFF, (k1 + _W1) & 0xFFFFFFFF
        p0, p1 = _M0 * x0, _M1 * x2  # exact: both factors are below 2**32
        x0, x1, x2, x3 = ((p1 >> np.uint64(32)) ^ x1 ^ np.uint64(k0),
                          p1 & _LO,
                          (p0 >> np.uint64(32)) ^ x3 ^ np.uint64(k1),
                          p0 & _LO)
    return tuple(x.astype(np.uint32) for x in (x0, x1, x2, x3))


def u01(b):
    """U[0, 1) from the top 24 bits of ``b`` (float64, exact)."""
    return (b >> np.uint32(8)).astype(np.float64) * (1.0 / 16777216.0)


def box_muller(b1, b2):
    """The cosine-branch normal of (1 - u1, u2), as float32."""
    u1, u2 = 1.0 - u01(b1), u01(b2)
    return (np.sqrt(-2.0 * np.log(u1)) * np.cos(2.0 * np.pi * u2)).astype(
        np.float32)


def box_muller_pair(b1, b2):
    """The cosine- and sine-branch normals of (1 - u1, u2), as float32:
    the two independent normals of one Box-Muller pair."""
    r = np.sqrt(-2.0 * np.log(1.0 - u01(b1)))
    t = 2.0 * np.pi * u01(b2)
    return ((r * np.cos(t)).astype(np.float32),
            (r * np.sin(t)).astype(np.float32))


def log1m_u01(b):
    """log(1 - u) of the 24-bit uniform, as float32."""
    return np.log(1.0 - u01(b)).astype(np.float32)
