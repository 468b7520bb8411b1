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
``glm_logp_grad_tiled_wide`` (``_mat_wide`` with a matrix prior), and 16 a
CTA on the very-wide tile above ``glm_kernels.WIDE_D_MAX``
(``glm_logp_grad_tiled_xwide``, ``_mat_xwide``), and 16 a CTA on the
chunked tier above ``glm_kernels.XWIDE_D_MAX``, which walks d in column
chunks (``glm_logp_grad_tiled_chunked``, ``_mat_chunked``).  The per-split
double partials take ``splits x C x (d + 1)`` doubles, and the grid keeps
``splits x ceil(C / 16)`` at most :data:`SPLIT_CTAS_WIDE`: at d 8192 at
most 264 x 16 x 8193 doubles, 277 MB, and 4.4 GB at d 131072.  The kernel
keeps no scratch of its own, so its width needs no block cap.
"""
from __future__ import annotations

import ctypes

import torch

from .glm_kernels import (KIND_CODES, NARROW_D_MAX, _check, _counted,
                          _device_branch, _draw, _prior, _prior_args, _ptr,
                          _row, _trajectory, accept_test, glm_funcs)
from .cuda_build import count

#: above this many observations a GLM run takes the N-tiled kernel, as in
#: the JAX package (pallas_glm_bign.py BIGN_THRESHOLD)
BIGN_THRESHOLD = 16384

#: launches with a (d, d) prior (the dense fold) count as "..._mat", and
#: launches on the wide tile (32 < d <= 256) with "_wide" appended, on the
#: very-wide tile (256 < d <= 1024) with "_xwide", on the chunked tier (d >
#: 1024) with "_chunked"
LAUNCHES = {"glm_logp_grad_tiled": 0, "glm_logp_grad_tiled_mat": 0,
            "glm_logp_grad_tiled_wide": 0, "glm_logp_grad_tiled_mat_wide": 0,
            "glm_logp_grad_tiled_xwide": 0,
            "glm_logp_grad_tiled_mat_xwide": 0,
            "glm_logp_grad_tiled_chunked": 0,
            "glm_logp_grad_tiled_mat_chunked": 0}
PLAIN_CALLS = {"glm_logp_grad_tiled": 0}

#: the kernel's grid aims at up to this many CTAs, two full waves of the two
#: 256-thread blocks each of the 132 SMs holds (never a third wave of a few
#: blocks, which costs nearly a wave), splitting N into ranges of at least
#: SPLIT_MIN_ROWS observations; on the wide and very-wide tiles (d > 32)
#: two waves of the one 512-thread block an SM holds
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
    count(LAUNCHES, _counted(name, lamm, d))
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
    return _hmc_loop(theta0, eps, lambda theta: _draw(theta, generator),
                     *_tiled_funcs(XT, Y, W, O, lam, kind), steps=steps,
                     n_leaps=n_leaps, integrator=integrator, collect=collect)


def _hmc_loop(theta0, eps, draw, grad_only, logp_grad, *, steps, n_leaps,
              integrator, collect):
    """The HMC transitions of :func:`_run_bign` and
    :func:`run_glm_hmc_bign_sharded`: ``draw(theta) -> (momenta,
    log-uniforms)`` a transition and the trajectory on ``(grad_only,
    logp_grad)``.  Returns ((theta, lp, grad), infos stacked over
    steps)."""
    theta = theta0
    lp, g = logp_grad(theta0)
    rows = {"plogtarget": [], "accept": []}
    if collect:
        rows.update(ppars=[], pgrads=[])
    for _ in range(steps):
        m0, logu = draw(theta)
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


def _prior_term(prior_prec, d, device):
    """``theta -> P theta`` rows of the prior's precision ``P`` (a scalar, a
    (d,) row or a (d, d) matrix), float32 on ``device``: the prior's
    gradient is ``-P theta`` and its log-density ``-0.5 theta' P theta``."""
    from .glm_kernels import _is_mat

    p = torch.as_tensor(prior_prec)
    if _is_mat(p):
        A = p.to(device=device, dtype=torch.float32)
        return lambda theta: theta @ A
    if p.numel() > 1:
        v = p.reshape(-1).to(device=device, dtype=torch.float32)
        return lambda theta: v * theta
    lam = float(p)
    return lambda theta: lam * theta


def run_glm_hmc_bign_sharded(X, Y, n_chains, steps, mesh=None,
                             chain_axis="chains", data_axis="data",
                             n_leaps=10, eps=0.05, seed=0, generator=None,
                             inits=None, kind="logistic", weights=None,
                             offsets=None, prior_prec=1.0,
                             integrator="leapfrog", collect=False):
    """Large-N GLM HMC over a 2-D ``(chains, data)`` mesh
    (pallas_glm_bign.py ``run_glm_hmc_bign_sharded``): both scale axes
    reach kernel 4.

    The observations are split over ``mesh[data_axis]`` (contiguous
    ranges; the last may be shorter, the kernel takes a ragged last tile,
    so nothing pads N) and the chains over ``mesh[chain_axis]``.  Every
    entry runs :func:`glm_logp_grad_tiled` on its rows with
    ``prior_prec=0``, and the entries of a chain group join their (logp,
    gradient) in ONE :func:`~..parallel.collectives.psum` over the data
    axis a gradient: ``[g | lp]``, (C_loc, d + 1) float32.  The prior (a
    scalar, a (d,) row or a (d, d) matrix) is applied once after it.

    Momenta and log-uniforms come from one stream over the global chain
    axis (each chain group holds a copy of the generator and takes its own
    rows of each draw), so every data entry of a chain takes the same
    numbers and the sharded run is the (1, 1) run, and
    :func:`run_glm_hmc_bign` on the same seed, up to the sums' order.
    ``inits`` default to ``0.1`` standard normals drawn first from that
    stream.  Returns the :func:`run_glm_hmc_bign` surface, ``(theta (C,
    d), infos)``, joined on the first chain group's device."""
    from ..parallel.collectives import psum
    from ..parallel.mesh import (Mesh, axis_groups, concat_chains,
                                 default_devices, for_each, gather,
                                 local_groups)
    from ..samplers.base import make_generator
    from .glm_hmc import _prepare

    if mesh is None:
        mesh = Mesh([default_devices()], (chain_axis, data_axis))
    n_c, n_d = mesh.shape[chain_axis], mesh.shape[data_axis]
    assert n_chains % n_c == 0, (
        f"n_chains ({n_chains}) must divide the '{chain_axis}' axis ({n_c})")
    c_loc = n_chains // n_c
    items = local_groups(mesh, chain_axis)
    dev0 = items[0][1]
    XT, Y2, theta0, gen, W, O = _prepare(X, Y, n_chains, seed, generator,
                                         inits, dev0, weights, offsets)
    d, N = XT.shape
    state = gen.get_state()
    bounds = [(int(r[0]), int(r[-1]) + 1) if len(r) else (0, 0)
              for r in torch.tensor_split(torch.arange(N), n_d)]
    a_d = mesh.axis_names.index(data_axis)
    groups = axis_groups(mesh, chain_axis)
    eps = float(eps)
    f32 = torch.float32

    def one(c, dev):
        g_c = make_generator(dev, state=state)
        shards = {}
        for m in groups[c]:
            if not mesh.is_local(m):
                continue
            lo, hi = bounds[m[a_d]]
            edev = mesh.devices[m]
            shards[m] = (XT[:, lo:hi].to(edev).contiguous(),
                         *(None if v is None else v[lo:hi].to(edev)
                           for v in (Y2, W, O)))
        first = next(iter(shards))
        prior = _prior_term(prior_prec, d, dev)

        def logp_grad(theta):
            parts = {}
            for m, (xt, y, w, o) in shards.items():
                lp_l, g_l = glm_logp_grad_tiled(
                    xt, y, theta.to(mesh.devices[m]).contiguous(), kind=kind,
                    weights=w, offsets=o, prior_prec=0.0)
                parts[m] = torch.cat([g_l, lp_l[:, None]], dim=1)
            packed = psum(parts, mesh, data_axis)[first]
            pt = prior(theta)
            return (packed[:, d] - 0.5 * (pt * theta).sum(1),
                    packed[:, :d] - pt)

        sl = slice(c * c_loc, (c + 1) * c_loc)

        def draw(theta):  # the global chain axis's numbers, this group's rows
            m0 = torch.randn((n_chains, d), generator=g_c, dtype=f32,
                             device=dev)[sl]
            return m0, torch.log(torch.rand((n_chains,), generator=g_c,
                                            dtype=f32, device=dev))[sl]

        (theta, _, _), infos = _hmc_loop(
            theta0[sl].to(dev).contiguous(), eps, draw,
            lambda th: logp_grad(th)[1], logp_grad, steps=steps,
            n_leaps=n_leaps, integrator=integrator, collect=collect)
        return theta, infos

    return concat_chains(gather(for_each(one, items), n_c), dev0, (0, 1))
