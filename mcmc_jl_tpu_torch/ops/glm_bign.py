"""Large-N GLM sampling: the port of ``mcmc_jl_tpu/ops/pallas_glm_bign.py``.

Above :data:`BIGN_THRESHOLD` observations the whole-trajectory kernels stop
paying off (they hold or stream all rows per leapfrog inside one launch per
chain block), and every GLM run switches to a trajectory loop in PyTorch
around one N-tiled (logp, grad) evaluation per drift:

===============================  ===========================================
wrapper (this module)            Pallas kernel it replaces
===============================  ===========================================
:func:`glm_logp_grad_tiled`      ``pallas_glm_bign.py _grad_kernel`` (one
                                 (logp, grad) of all chains, tiled over N)
===============================  ===========================================

written in CUDA C++ for Hopper in ``csrc/glm_bign.cu``, with its plain
PyTorch version :func:`glm_logp_grad_tiled_ref` beside it.  The wrapper runs
the plain version only for tensors on the CPU; for CUDA tensors it launches
the kernel or raises.  Each launch adds one to ``LAUNCHES[name]``, each call
of the plain version one to ``PLAIN_CALLS[name]``.

The kernel masks the ragged last tile of observations itself, so unlike the
JAX package nothing pads N (a padded row would need weight 0: the logistic
``resid(0, 0)`` is -0.5, not 0) and nothing pads d.  It takes d up to
``glm_kernels.D_MAX``: 128 chains a CTA on the narrow chain tile (d <= 32),
16 a CTA on the wide tile above, whose launches count as
``glm_logp_grad_tiled_wide`` (``_mat_wide`` with a matrix prior).
"""
from __future__ import annotations

import ctypes

import torch

from .glm_kernels import (KIND_CODES, NARROW_D_MAX, _check, _counted,
                          _device_branch, _draw, _prior, _prior_args, _ptr,
                          _row, _trajectory, accept_test, glm_funcs)

#: above this many observations a GLM run takes the N-tiled kernel, as in
#: the JAX package (pallas_glm_bign.py BIGN_THRESHOLD)
BIGN_THRESHOLD = 16384

#: launches with a (d, d) prior (the dense fold) count as "..._mat", and
#: launches on the wide tile (d > 32) with "_wide" appended
LAUNCHES = {"glm_logp_grad_tiled": 0, "glm_logp_grad_tiled_mat": 0,
            "glm_logp_grad_tiled_wide": 0, "glm_logp_grad_tiled_mat_wide": 0}
PLAIN_CALLS = {"glm_logp_grad_tiled": 0}

#: the kernel's grid aims at up to this many CTAs, two full waves of the two
#: 256-thread blocks each of the 132 SMs holds (never a third wave of a few
#: blocks, which costs nearly a wave), splitting N into ranges of at least
#: SPLIT_MIN_ROWS observations; on the wide tile (d > 32) two waves of the
#: one 512-thread block an SM holds
SPLIT_CTAS = 528
SPLIT_CTAS_WIDE = 264
SPLIT_MIN_ROWS = 1024
_CHAINS_PER_CTA = 128  # csrc/glm_bign.cu kChains
_CHAINS_PER_CTA_WIDE = 16  # csrc/glm_tile.cuh kTileChains


def reset_counts():
    """Zero the launch and plain-call counters."""
    for counts in (LAUNCHES, PLAIN_CALLS):
        for k in counts:
            counts[k] = 0


def glm_logp_grad_tiled_ref(XT, Y, theta, *, kind="logistic", weights=None,
                            offsets=None, prior_prec=1.0):
    """Plain version of :func:`glm_logp_grad_tiled`."""
    PLAIN_CALLS["glm_logp_grad_tiled"] += 1
    return glm_funcs(XT, Y, weights, offsets, _prior(prior_prec), kind)[1](
        theta)


def splits_for(N, C, d=1):
    """How many contiguous ranges of observations the kernel's grid splits
    N into for C chains of d parameters: as many as fit in
    :data:`SPLIT_CTAS` CTAs (:data:`SPLIT_CTAS_WIDE` above d = 32; at
    least one), no range shorter than :data:`SPLIT_MIN_ROWS`, and every
    range non-empty."""
    wide = d > NARROW_D_MAX
    blocks = -(-C // (_CHAINS_PER_CTA_WIDE if wide else _CHAINS_PER_CTA))
    ctas = SPLIT_CTAS_WIDE if wide else SPLIT_CTAS
    s = max(1, min(ctas // blocks, -(-N // SPLIT_MIN_ROWS)))
    rows = -(-N // s)
    return -(-N // rows)


_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 4 \
    + [ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]


def load_kernels():
    """Build (first use) and bind ``csrc/glm_bign.cu``; returns the library."""
    from .cuda_build import load
    from .glm_kernels import D_MAX

    lib = load("glm_bign")
    if not getattr(lib, "_bound", False):
        lib.glm_logp_grad_tiled.argtypes = _ARGTYPES
        lib.glm_logp_grad_tiled.restype = ctypes.c_int
        lib.bign_error_string.argtypes = [ctypes.c_int]
        lib.bign_error_string.restype = ctypes.c_char_p
        lib.bign_max_dim.restype = ctypes.c_int
        if lib.bign_max_dim() != D_MAX:
            raise RuntimeError("csrc/glm_bign.cu and glm_kernels.D_MAX disagree")
        lib._bound = True
    return lib


def glm_logp_grad_tiled(XT, Y, theta, *, kind="logistic", weights=None,
                        offsets=None, prior_prec=1.0):
    """One (logp, grad) evaluation of a GLM posterior for all chains, tiled
    over the observations.

    Args: ``XT`` (d, N); ``Y`` and the optional ``weights``/``offsets``
    (N,); ``theta`` (C, d); ``prior_prec`` a scalar, a (d,) row or a
    symmetric (d, d) matrix ``A`` (prior gradient ``theta A``; the launch
    counts as ``glm_logp_grad_tiled_mat``).
    Returns (lp (C,), grad (C, d)).  Two launches on the same inputs give
    the same bits."""
    name = "glm_logp_grad_tiled"
    if not _device_branch(name, theta):
        return glm_logp_grad_tiled_ref(XT, Y, theta, kind=kind,
                                       weights=weights, offsets=offsets,
                                       prior_prec=prior_prec)
    N, d, C, W, O = _check(name, XT, Y, weights, offsets, kind,
                           {"theta": theta})
    lam, lamv, lamm = _prior_args(name, prior_prec, d, theta.device)
    splits = splits_for(N, C, d)
    dev = theta.device
    g_o = torch.empty_like(theta)
    lp_o = torch.empty(C, dtype=theta.dtype, device=dev)
    part = torch.empty(splits * C * (d + 1), dtype=torch.float64, device=dev)
    lib = load_kernels()
    with torch.cuda.device(dev):
        code = lib.glm_logp_grad_tiled(
            _ptr(XT), _ptr(_row(Y)), _ptr(W), _ptr(O), _ptr(lamv),
            _ptr(lamm), N, d, C,
            _ptr(theta), _ptr(g_o), _ptr(lp_o), _ptr(part), splits, lam,
            KIND_CODES[kind],
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if code != 0:
        raise RuntimeError(f"{name} launch failed: "
                           f"{lib.bign_error_string(code).decode()} ({code})")
    LAUNCHES[_counted(name, lamm, d)] += 1
    return lp_o, g_o


def _tiled_funcs(XT, Y, W, O, lam, kind):
    """(grad_only, logp_grad) through the tiled evaluation: the shape of
    glm_kernels.glm_funcs, for glm_kernels._trajectory."""
    def logp_grad(theta):
        return glm_logp_grad_tiled(XT, Y, theta.contiguous(), kind=kind,
                                   weights=W, offsets=O, prior_prec=lam)

    return (lambda theta: logp_grad(theta)[1]), logp_grad


def _run_bign(XT, Y, theta0, eps, generator, *, steps, n_leaps,
              kind="logistic", W=None, O=None, lam=1.0,
              integrator="leapfrog", collect=False):
    """``steps`` HMC transitions with one tiled (logp, grad) evaluation per
    drift (pallas_glm_bign.py ``_run_bign``).  Draws the same numbers from
    ``generator`` in the same order as glm_hmc._run, so on the same seed
    the two give the same chains up to the gradients' rounding.
    Returns ((theta, lp, grad), infos stacked over steps)."""
    grad_only, logp_grad = _tiled_funcs(XT, Y, W, O, lam, kind)
    theta = theta0
    lp, g = logp_grad(theta0)
    rows = {"plogtarget": [], "accept": []}
    if collect:
        rows.update(ppars=[], pgrads=[])
    for _ in range(steps):
        m0, logu = _draw(theta, generator)
        p_th, p_m, p_g, p_lp = _trajectory(theta, m0, g, eps, grad_only,
                                           logp_grad, n_leaps, integrator)
        accept = accept_test(-lp + 0.5 * (m0 * m0).sum(-1),
                             -p_lp + 0.5 * (p_m * p_m).sum(-1), logu)
        a = accept[:, None]
        theta = torch.where(a, p_th, theta)
        g = torch.where(a, p_g, g)
        lp = torch.where(accept, p_lp, lp)
        rows["plogtarget"].append(lp)
        rows["accept"].append(accept)
        if collect:
            rows["ppars"].append(theta)
            rows["pgrads"].append(g)
    return (theta, lp, g), {k: torch.stack(v) for k, v in rows.items()}


def run_glm_hmc_bign(X, Y, n_chains, steps, n_leaps=10, eps=0.05, seed=0,
                     generator=None, inits=None, device=None,
                     kind="logistic", weights=None, offsets=None,
                     prior_prec=1.0, integrator="leapfrog", collect=False):
    """Sample a large-N GLM posterior through the tiled kernel; the surface
    of :func:`mcmc_jl_tpu_torch.ops.glm_hmc.run_glm_hmc`.
    Returns (theta (C, d), infos stacked over steps)."""
    from .glm_hmc import _prepare

    XT, Y2, theta0, gen, W, O = _prepare(X, Y, n_chains, seed, generator,
                                         inits, device, weights, offsets)
    (theta, _, _), infos = _run_bign(
        XT, Y2, theta0, float(eps), gen, steps=steps, n_leaps=n_leaps,
        kind=kind, W=W, O=O, lam=float(prior_prec), integrator=integrator,
        collect=collect)
    return theta, infos
