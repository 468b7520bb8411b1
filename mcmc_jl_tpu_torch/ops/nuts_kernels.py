"""Fused exact-NUTS kernels: the port of ``mcmc_jl_tpu/ops/pallas_nuts.py``.

Three kernels, written in CUDA C++ for Hopper, replace the Pallas kernel
bodies (GLM mode in ``csrc/glm_nuts.cu``, target mode in
``csrc/target_nuts.cu``):

================================  =========================================
wrapper (this module)             Pallas kernel it replaces
================================  =========================================
:func:`glm_nuts_transition`       ``pallas_nuts.py _nuts_kernel``, GLM mode
                                  (one exact NUTS transition, all noise
                                  pre-drawn)
:func:`glm_nuts_multistep`        ``pallas_nuts.py _nuts_ms_kernel`` (k
                                  transitions, noise drawn inside)
:func:`target_nuts_transition`    ``pallas_nuts.py _nuts_kernel``, target
                                  mode (``_target_transition_inner``): one
                                  transition on a catalog target, a scalar
                                  step or a (d,) step row, or on a dense
                                  target (``z -> target(z L')``, the JAX
                                  package's ``_dense_wrap``) at a scalar
                                  step; one chain per lane up to d = 32,
                                  one warp per chain above
================================  =========================================

Each has a plain PyTorch version beside it (``*_ref``): batched tensor ops
over all chains with per-chain masks, on the same pre-drawn buffers
(:func:`glm_nuts_multistep_draws` replays the draws the multistep kernel
makes inside, so that its plain version can take them).  A
wrapper runs the plain version only for tensors on the CPU; for CUDA tensors
it launches the kernel or raises.  Each launch adds one to
``LAUNCHES[name]``, each call of a plain version one to
``PLAIN_CALLS[name]``.

Layouts follow the JAX package minus its TPU padding: chain states are
(C, d); the directions and merge uniforms are (C, maxdoublings); the leaf
uniforms are (C, 2^maxdoublings), column ``(1 << j) - 1 + k`` for leaf k of
doubling j.  The GLM prior precision is a scalar, a (d,) row (the diagonal
metric fold of the warm-start pipeline) or a symmetric (d, d) matrix (the
dense fold; such launches count as ``<name>_mat``).  The GLM kernels take
d up to :data:`NUTS_D_MAX`: on the narrow tile up to ``NARROW_D_MAX``,
above it on the wide tile up to ``WIDE_D_MAX``, whose launches count as
``<name>_wide`` (and ``<name>_mat_wide``), above that on the very-wide
tile up to ``XWIDE_D_MAX``, counted as ``<name>_xwide`` (and
``<name>_mat_xwide``), and above that on the chunked tier, which walks d
in column chunks of at most 512, counted as ``<name>_chunked`` (and
``<name>_mat_chunked``).  The kernels above the narrow tile keep the
tree's state (on the very-wide tile the walker's momentum and gradient
too, on the chunked tier its position as well) in a scratch buffer that
:func:`_scratch` allocates once for each device, stream, padded width and
depth.
On a catalog target the frozen diagonal metric rides the step instead, as a
(d,) row ``eps * s``, and a dense one is the factor of a
:class:`~..models.distributions.DenseTarget`, whose launches count as
``target_nuts_transition_dense``: the tree runs in ``z`` with a unit metric,
the families at ``theta = z L'``.  The drivers :func:`_nuts_run`, :func:`_nuts_run_hw`
and :func:`_nuts_target_run` return the NUTS info protocol (``ppars``,
``pgrads``, ``plogtarget``, ``accept``, ``epsilon``, ``ndoublings``,
``diverging``).

Not ported: ``nuts_target_kernel_supported`` (a compile probe: the route
decides up front) and data-bearing targets (``consts``), which run on the
generic engine.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ..samplers.base import _where
from ..samplers.nuts import DELTAMAX, _dot, _popcount, _trailing_ones
from .glm_kernels import (D_MAX, KIND_CODES, NARROW_D_MAX, SLICE_DRAW,
                          _arange_for, _check, _counted, _device_branch,
                          _padded, _prior, _prior_args, _ptr, _row,
                          glm_funcs, glm_multistep_draws)
from . import philox
from .target_kernels import (_eps_args, _seed, dense_name, kernel_args,
                             launch, load_library, step_for, target_funcs)
from .cuda_build import count, scratch_buffer

#: largest parameter count of the GLM NUTS kernels (8, 9): the chunked
#: tier's bound glm_kernels.D_MAX, as the HMC kernels' (csrc/glm_nuts.cu
#: nuts_max_dim, csrc/glm_tile.cuh kXChunkDMax)
NUTS_D_MAX = D_MAX
#: deepest tree the kernels build (csrc/glm_nuts.cu kMaxDoublings): the leaf
#: buffer has 2^maxdoublings columns per chain
MAX_DOUBLINGS = 10
#: largest d that :func:`target_nuts_transition` runs one chain per lane
#: (csrc/target_nuts.cu kLaneDMax); above it, one warp per chain
LANE_D_MAX = 32
#: Philox draw numbers of one (chain, transition) in
#: :func:`glm_nuts_multistep` (csrc/glm_nuts.cu): the momenta take
#: 0 .. d/2 - 1 (two normals a draw; below 0x2000 up to NUTS_D_MAX) and the
#: slice uniform ``SLICE_DRAW``, as in
#: :func:`.glm_kernels.glm_multistep_draws`; doubling j's direction and
#: merge uniform ``DIR_DRAW + j`` and ``MERGE_DRAW + j``; leaf
#: ``(1 << j) - 1 + k`` ``LEAF_DRAW`` plus that: five disjoint ranges at
#: every d the kernels take
DIR_DRAW, MERGE_DRAW, LEAF_DRAW = 0x2000, 0x2100, 0x10000

_NAMES = ("glm_nuts_transition", "glm_nuts_multistep",
          "target_nuts_transition", "target_nuts_transition_dense")
_GLM = ("glm_nuts_transition", "glm_nuts_multistep")
LAUNCHES = dict.fromkeys(_NAMES + tuple(n + v for n in _GLM for v in (
    "_mat", "_wide", "_mat_wide", "_xwide", "_mat_xwide", "_chunked",
    "_mat_chunked")), 0)
PLAIN_CALLS = dict.fromkeys(_NAMES, 0)


def reset_counts():
    """Zero the launch and plain-call counters."""
    for counts in (LAUNCHES, PLAIN_CALLS):
        for k in counts:
            counts[k] = 0


def _check_md(maxdoublings):
    if not 1 <= maxdoublings <= MAX_DOUBLINGS:
        raise ValueError(f"maxdoublings = {maxdoublings} outside the "
                         f"kernels' 1..{MAX_DOUBLINGS}")
    return int(maxdoublings)


# ---- plain PyTorch versions ----------------------------------------------


def _transition(logp_grad, theta, lp, grad, eps, m0, logu, dirn, merge_u,
                leaf_u, md, multinomial, leaves=None):
    """One exact NUTS transition for all chains in lockstep, the Pallas
    kernel's algorithm: per-chain masks ``s`` (trajectory running) and
    ``ok`` (subtree running) hold the stopped chains.  ``leaves``, a (C,)
    tensor, gathers each chain's leaf count.
    Returns (theta, grad, lp, ndoublings, diverging)."""
    C, d = theta.shape
    dt, dev = theta.dtype, theta.device
    H0 = -lp + 0.5 * _dot(m0, m0)
    u_slice = -H0 if multinomial else logu - H0  # NUTS.jl:141
    minus = plus = (theta, m0, grad, lp)
    prop = (theta, grad, lp)
    s = torch.ones(C, dtype=torch.bool, device=dev)
    ntot = torch.ones(C, dtype=dt, device=dev)  # n: the initial point
    lwtot = torch.zeros(C, dtype=dt, device=dev)  # lw: exp(H0 - H0)
    nd = torch.zeros(C, dtype=torch.int32, device=dev)
    dv = torch.zeros(C, dtype=torch.bool, device=dev)

    for j in range(md):
        if not bool(s.any()):
            break
        dirn_j = dirn[:, j]
        go = dirn_j > 0
        wp, wm, wg, wlp = (_where(go, a, b) for a, b in zip(plus, minus))
        sp = (wp, wg, wlp)  # proposal seed: the first valid leaf always takes
        n1 = torch.zeros(C, dtype=dt, device=dev)
        lw1 = torch.full((C,), -math.inf, dtype=dt, device=dev)
        ok = s.clone()
        sdv = torch.zeros(C, dtype=torch.bool, device=dev)
        ck_p = torch.zeros((C, md, d), dtype=dt, device=dev)
        ck_m = torch.zeros((C, md, d), dtype=dt, device=dev)
        esw = dirn_j[:, None] * eps  # eps: a float or a (d,) step row

        for k in range(1 << j):
            if not bool(ok.any()):
                break
            run = ok
            if leaves is not None:
                leaves += run
            tm = wm + 0.5 * esw * wg
            tp = wp + esw * tm
            tlp, tg = logp_grad(tp)
            tm = tm + 0.5 * esw * tg
            wp, wm, wg, wlp = (_where(run, a, b) for a, b in
                               zip((tp, tm, tg, tlp), (wp, wm, wg, wlp)))
            H = -wlp + 0.5 * _dot(wm, wm)
            H = torch.where(torch.isnan(H), math.inf, H)
            diverged = u_slice >= DELTAMAX - H  # NUTS.jl:92
            u_leaf = leaf_u[:, (1 << j) - 1 + k]
            if multinomial:
                lw_leaf = torch.where(diverged, -math.inf, H0 - H)
                lw_new = torch.logaddexp(lw1, lw_leaf)
                take = run & ~diverged & (torch.log(u_leaf) < lw_leaf - lw_new)
                lw1 = torch.where(run, lw_new, lw1)
                n1 = n1 + (run & ~diverged).to(dt)
            else:
                valid = u_slice <= -H  # NUTS.jl:91
                nf = n1 + valid.to(dt)
                take = run & valid & (u_leaf * nf < 1.0)
                n1 = torch.where(run, nf, n1)
            sp = tuple(_where(take, a, b) for a, b in zip((wp, wg, wlp), sp))
            sdv = sdv | (run & diverged)
            ok = ok & ~diverged
            if k % 2 == 0:  # checkpoint store at slot popcount(k)
                slot = _popcount(k)
                ck_p[:, slot] = _where(run, wp, ck_p[:, slot])
                ck_m[:, slot] = _where(run, wm, ck_m[:, slot])
            else:  # spans ending at odd k (NUTS.jl:50)
                hi = _popcount(k >> 1)
                lo = hi - _trailing_ones(k) + 1
                delta = dirn_j[:, None, None] * (wp[:, None]
                                                 - ck_p[:, lo:hi + 1])
                turned = ((_dot(delta, ck_m[:, lo:hi + 1]) < 0)
                          | (_dot(delta, wm[:, None]) < 0)).any(-1)
                ok = ok & ~(run & turned)

        # the walker's end is the new edge of the running chains
        walker = (wp, wm, wg, wlp)
        plus = tuple(_where(s & go, a, b) for a, b in zip(walker, plus))
        minus = tuple(_where(s & ~go, a, b) for a, b in zip(walker, minus))
        u = merge_u[:, j]
        if multinomial:
            take = s & ok & (torch.log(u) < lw1 - lwtot)
            lwtot = torch.where(s & ok, torch.logaddexp(lwtot, lw1), lwtot)
        else:
            take = s & ok & (u * ntot < n1)
        prop = tuple(_where(take, a, b) for a, b in zip(sp, prop))
        ntot = ntot + torch.where(s, n1, 0.0)
        dp = plus[0] - minus[0]
        turned = (_dot(dp, minus[1]) < 0) | (_dot(dp, plus[1]) < 0)
        nd = nd + s.to(torch.int32)
        dv = dv | (s & sdv)
        s = s & ok & ~turned
    return prop[0], prop[1], prop[2], nd, dv


def draw_noise(C, d, maxdoublings, generator, dtype=torch.float32,
               device=None):
    """The pre-drawn noise of one transition for C chains, from
    ``generator``: (m0 (C, d), logu (C,), dirn (C, md) in {-1, +1},
    merge_u (C, md), leaf_u (C, 2^md))."""
    device = generator.device if device is None else device
    kw = dict(generator=generator, dtype=dtype, device=device)
    md = maxdoublings
    m0 = torch.randn((C, d), **kw)
    logu = torch.log(torch.rand((C,), **kw))
    dirn = torch.where(torch.rand((C, md), **kw) < 0.5, 1.0, -1.0).to(dtype)
    return m0, logu, dirn, torch.rand((C, md), **kw), \
        torch.rand((C, 1 << md), **kw)


def glm_nuts_transition_ref(XT, Y, theta, lp, grad, eps, m0, logu, dirn,
                            merge_u, leaf_u, *, maxdoublings=6,
                            kind="logistic", weights=None, offsets=None,
                            prior_prec=1.0, multinomial=False):
    """Plain version of :func:`glm_nuts_transition`."""
    PLAIN_CALLS["glm_nuts_transition"] += 1
    _, logp_grad = glm_funcs(XT, Y, weights, offsets, _prior(prior_prec),
                             kind)
    return _transition(logp_grad, theta, lp.reshape(-1), grad, eps, m0,
                       logu.reshape(-1), dirn, merge_u, leaf_u,
                       _check_md(maxdoublings), multinomial)


def target_nuts_transition_ref(target, theta, lp, grad, eps, m0, logu, dirn,
                               merge_u, leaf_u, *, maxdoublings=6,
                               multinomial=False):
    """Plain version of :func:`target_nuts_transition`: the lockstep
    transition with the target's ``torch.func`` gradient."""
    name = "target_nuts_transition"
    eps = step_for(name, target, eps, theta)
    PLAIN_CALLS[dense_name(name, target)] += 1
    return _transition(target_funcs(target)[1], theta, lp.reshape(-1), grad,
                       eps, m0, logu.reshape(-1), dirn, merge_u, leaf_u,
                       _check_md(maxdoublings), multinomial)


def _rows(th, g, lp, acc, nd, dv):
    return {"ppars": th, "pgrads": g, "plogtarget": lp, "accept": acc,
            "ndoublings": nd, "diverging": dv}


def glm_nuts_multistep_draws(seed, C, d, k_trans, maxdoublings, i0=0,
                             device="cpu"):
    """The draws that :func:`glm_nuts_multistep` makes inside under the
    launch seed ``seed``, replayed by :mod:`.philox` and laid out as
    :func:`draw_noise` lays them out, one set per transition: (m0 (k, C, d),
    logu (k, C), dirn (k, C, md) in {-1, +1}, merge_u (k, C, md), leaf_u
    (k, C, 2^md)) for the transitions ``i0 .. i0 + k_trans - 1`` of the
    Philox counter (chain, transition, draw).  The uniforms are exact; the
    normals and log-uniforms lie within a few float32 ulps of the
    kernel's."""
    md = _check_md(maxdoublings)
    ar = _arange_for(device)
    c, t = ar(0, C)[None, :, None], ar(i0, i0 + k_trans)[:, None, None]

    def u(lo, n):  # draws lo .. lo + n - 1: the kernel's uniform in (0, 1]
        return philox.uniform(philox.philox4x32((c, t, ar(lo, lo + n), 0),
                                                seed)[0])

    merge = u(MERGE_DRAW, md)
    dirn = (u(DIR_DRAW, md) < 0.5) * -2.0 + 1.0  # -1 where u < 0.5, else 1
    out = (dirn, merge, u(LEAF_DRAW, 1 << md))
    return (glm_multistep_draws(seed, C, d, k_trans, i0, device)
            + tuple(a.float().contiguous() for a in out))


def glm_nuts_multistep_ref(XT, Y, theta, lp, grad, eps, generator, *,
                           k_trans=8, maxdoublings=6, kind="logistic",
                           weights=None, offsets=None, prior_prec=1.0,
                           multinomial=False, draws=None):
    """Plain version of :func:`glm_nuts_multistep`: the noise of each
    transition comes from ``generator`` (:func:`draw_noise`; another stream
    than the kernel's Philox, so compare statistically), or from ``draws``,
    the kernel's own replayed by :func:`glm_nuts_multistep_draws` (then
    chain by chain)."""
    PLAIN_CALLS["glm_nuts_multistep"] += 1
    md = _check_md(maxdoublings)
    _, logp_grad = glm_funcs(XT, Y, weights, offsets, _prior(prior_prec),
                             kind)
    C, d = theta.shape
    lp = lp.reshape(-1)
    rows = []
    for t in range(k_trans):
        noise = (draw_noise(C, d, md, generator, theta.dtype, theta.device)
                 if draws is None else tuple(a[t] for a in draws))
        th2, g2, lp2, nd, dv = _transition(logp_grad, theta, lp, grad, eps,
                                           *noise, md, multinomial)
        rows.append(_rows(th2, g2, lp2, (th2 != theta).any(-1), nd, dv))
        theta, grad, lp = th2, g2, lp2
    return theta, grad, lp, {k: torch.stack([r[k] for r in rows])
                             for k in rows[0]}


# ---- CUDA kernels ----------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_LL = ctypes.c_longlong
_ARGTYPES = {
    "glm_nuts_transition": [_P] * 6 + [_I] * 3 + [_P] * 13
    + [_F, _F, _I, _I, _I, _P, _P, _LL, _P],
    "glm_nuts_multistep": [_P] * 6 + [_I] * 3 + [_P] * 12
    + [_F, _F, _I, _I, _I, _I, ctypes.c_ulonglong, _P, _P, _LL, _P],
    "glm_nuts_plan": [_I, _I, _I] + [ctypes.POINTER(_I)] * 3
    + [ctypes.POINTER(_LL)],
}


def load_kernels():
    """Build (first use) and bind ``csrc/glm_nuts.cu``; returns the library."""
    from .cuda_build import load

    lib = load("glm_nuts")
    if not getattr(lib, "_bound", False):
        for name, argtypes in _ARGTYPES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.nuts_error_string.argtypes = [ctypes.c_int]
        lib.nuts_error_string.restype = ctypes.c_char_p
        lib.nuts_max_doublings.restype = ctypes.c_int
        lib.nuts_max_dim.restype = ctypes.c_int
        if (lib.nuts_max_doublings() != MAX_DOUBLINGS
                or lib.nuts_max_dim() != NUTS_D_MAX):
            raise RuntimeError("csrc/glm_nuts.cu and nuts_kernels disagree "
                               "on MAX_DOUBLINGS or NUTS_D_MAX")
        lib._bound = True
    return lib


def _launch(name, lamm, d, *args):
    lib = load_kernels()
    code = getattr(lib, name)(*args,
                              _P(torch.cuda.current_stream().cuda_stream))
    if code != 0:
        raise RuntimeError(f"{name} launch failed: "
                           f"{lib.nuts_error_string(code).decode()} ({code})")
    count(LAUNCHES, _counted(name, lamm, d))


_QUEUES = {}


def _queue(dev):
    """The kernels' tile queue on ``dev``'s current stream: one int that
    the blocks take their tiles from, zeroed once here and put back to 0 by
    every launch (launches on one stream run in turn)."""
    key = (dev, torch.cuda.current_stream(dev).cuda_stream)
    if key not in _QUEUES:
        _QUEUES[key] = torch.zeros(1, dtype=torch.int32, device=dev)
    return _QUEUES[key]


_SCRATCH = {}


def _scratch(dev, d, N, md):
    """(buffer, bytes) of the tree state above the narrow tile on
    ``dev``'s current stream: one float32 buffer for each (device, stream,
    padded width, md), so that two widths of one chunk layout share it,
    allocated once and grown when a plan needs more (the kernel checks its
    size; on an H100's 132 SMs 277 MB at d 1024 and md 10, 1.14 GB at d
    4096 and 4.6 GB at d 16384).  (None, 0) on the narrow tile, which keeps
    the tree in shared memory."""
    if d <= NARROW_D_MAX:
        return None, 0
    key = (dev, torch.cuda.current_stream(dev).cuda_stream, _padded(d), md)
    return scratch_buffer(_SCRATCH, key, nuts_plan(d, N, md)["scratch_bytes"],
                          dev)


def nuts_plan(d, N, maxdoublings):
    """How the NUTS kernels run at (d, N, maxdoublings) on the card:
    {"blocks_per_sm", "smem_bytes", "resident", "scratch_bytes"} (resident:
    every row stays in shared memory, never on the very-wide tile or the
    chunked tier; scratch_bytes: the tree state above the narrow tile for
    as many blocks as a launch runs at once, 0 on the narrow tile)."""
    outs = [ctypes.c_int() for _ in range(3)] + [_LL()]
    code = load_kernels().glm_nuts_plan(d, N, _check_md(maxdoublings),
                                        *[ctypes.byref(o) for o in outs])
    if code != 0:
        raise RuntimeError(f"glm_nuts_plan failed ({code})")
    return dict(zip(("blocks_per_sm", "smem_bytes", "resident",
                     "scratch_bytes"), (o.value for o in outs)))


def _check_noise(name, C, md, dev, **bufs):
    want = {"dirn": (C, md), "merge_u": (C, md), "leaf_u": (C, 1 << md),
            "lp": (C,), "logu": (C,)}
    for label, t in bufs.items():
        if (t.device != dev or t.dtype != torch.float32
                or not t.is_contiguous() or tuple(t.shape) != want[label]):
            raise ValueError(
                f"{name}: {label} must be a contiguous float32 {want[label]} "
                f"tensor on {dev}, got {t.dtype} {tuple(t.shape)} on "
                f"{t.device}")


def glm_nuts_transition(XT, Y, theta, lp, grad, eps, m0, logu, dirn,
                        merge_u, leaf_u, *, maxdoublings=6, kind="logistic",
                        weights=None, offsets=None, prior_prec=1.0,
                        multinomial=False):
    """One exact NUTS transition for all chains with pre-drawn noise.

    Args: ``XT`` (d, N); ``Y`` (N,); ``theta``, ``grad``, ``m0`` (C, d);
    ``lp``, ``logu`` (C,); ``dirn``, ``merge_u`` (C, maxdoublings);
    ``leaf_u`` (C, 2^maxdoublings); scalar ``eps``.
    Returns (theta, grad, lp (C,), ndoublings (C,) int32, diverging (C,)
    bool)."""
    name = "glm_nuts_transition"
    if not _device_branch(name, theta):
        return glm_nuts_transition_ref(
            XT, Y, theta, lp, grad, eps, m0, logu, dirn, merge_u, leaf_u,
            maxdoublings=maxdoublings, kind=kind, weights=weights,
            offsets=offsets, prior_prec=prior_prec, multinomial=multinomial)
    md = _check_md(maxdoublings)
    lp, logu = lp.reshape(-1), logu.reshape(-1)
    N, d, C, W, O = _check(name, XT, Y, weights, offsets, kind,
                           {"theta": theta, "grad": grad, "m0": m0},
                           {"lp": lp, "logu": logu})
    _check_noise(name, C, md, theta.device, dirn=dirn, merge_u=merge_u,
                 leaf_u=leaf_u)
    lam, lamv, lamm = _prior_args(name, prior_prec, d, theta.device)
    th_o, g_o = torch.empty_like(theta), torch.empty_like(theta)
    lp_o = torch.empty(C, dtype=theta.dtype, device=theta.device)
    nd_o = torch.empty(C, dtype=torch.int32, device=theta.device)
    dv_o = torch.empty(C, dtype=torch.bool, device=theta.device)
    with torch.cuda.device(theta.device):
        scratch, nbytes = _scratch(theta.device, d, N, md)
        _launch(name, lamm, d, _ptr(XT), _ptr(_row(Y)), _ptr(W), _ptr(O),
                _ptr(lamv), _ptr(lamm), N, d, C, _ptr(theta), _ptr(lp),
                _ptr(grad), _ptr(m0), _ptr(logu), _ptr(dirn), _ptr(merge_u),
                _ptr(leaf_u), _ptr(th_o), _ptr(g_o), _ptr(lp_o), _ptr(nd_o),
                _ptr(dv_o), float(eps), lam, md, KIND_CODES[kind],
                int(multinomial), _ptr(_queue(theta.device)), _ptr(scratch),
                nbytes)
    return th_o, g_o, lp_o, nd_o, dv_o


def load_target_kernels():
    """Build (first use) and bind ``csrc/target_nuts.cu``."""
    lib = load_library("target_nuts", {
        "target_nuts_transition": [_P] * 2 + [_I, _I] + [_P] * 13
        + [_F, _P, _I, _I, _P],
        "target_nuts_transition_dense": [_P] * 3 + [_I, _I] + [_P] * 13
        + [_F, _P, _I, _I, _P],
        "target_nuts_plan": [_I] * 3 + [ctypes.POINTER(_I)] * 3})
    if not getattr(lib, "_md_checked", False):
        lib.target_nuts_max_doublings.restype = ctypes.c_int
        lib.target_nuts_lane_max_dim.restype = ctypes.c_int
        if (lib.target_nuts_max_doublings() != MAX_DOUBLINGS
                or lib.target_nuts_lane_max_dim() != LANE_D_MAX):
            raise RuntimeError("csrc/target_nuts.cu and nuts_kernels "
                               "disagree on MAX_DOUBLINGS or LANE_D_MAX")
        lib._md_checked = True
    return lib


def target_nuts_plan(d, C, maxdoublings):
    """How :func:`target_nuts_transition` runs at (d, C, maxdoublings) on
    the card: {"layout", "blocks_per_sm", "threads", "smem_bytes"}; in the
    lane layout a block of four warps serves 32 chains."""
    outs = [ctypes.c_int() for _ in range(3)]
    code = load_target_kernels().target_nuts_plan(
        d, C, _check_md(maxdoublings), *[ctypes.byref(o) for o in outs])
    if code != 0:
        raise RuntimeError(f"target_nuts_plan failed ({code})")
    return {"layout": target_nuts_layout(d),
            **dict(zip(("blocks_per_sm", "threads", "smem_bytes"),
                       (o.value for o in outs)))}


def target_nuts_layout(d):
    """The layout :func:`target_nuts_transition` launches at dimension
    ``d``, decided up front from d alone: ``"lane"`` (one chain per lane,
    32 chains a warp) for d <= :data:`LANE_D_MAX`, else ``"warp"`` (one
    warp per chain, lanes over coordinates)."""
    return "lane" if d <= LANE_D_MAX else "warp"


def target_nuts_transition(target, theta, lp, grad, eps, m0, logu, dirn,
                           merge_u, leaf_u, *, maxdoublings=6,
                           multinomial=False):
    """One exact NUTS transition for all chains on a catalog target, with
    pre-drawn noise.

    Args: ``target`` a :class:`CatalogTarget` with kernel rows; ``theta``,
    ``grad``, ``m0`` (C, d) with ``grad`` the gradient at ``theta``; ``lp``,
    ``logu`` (C,); ``dirn``, ``merge_u`` (C, maxdoublings); ``leaf_u``
    (C, 2^maxdoublings); ``eps`` a scalar or a (d,) per-coordinate step row
    (the frozen diagonal metric).  On a :class:`DenseTarget` the states are
    in ``z``, lp is the base target's at ``theta = z L'`` and the step a
    scalar.  d up to ``target_kernels.D_MAX``; the
    kernel's layout follows from d (:func:`target_nuts_layout`).
    Returns (theta, grad, lp (C,), ndoublings (C,) int32, diverging (C,)
    bool)."""
    name = "target_nuts_transition"
    if not _device_branch(name, theta):
        return target_nuts_transition_ref(
            target, theta, lp, grad, eps, m0, logu, dirn, merge_u, leaf_u,
            maxdoublings=maxdoublings, multinomial=multinomial)
    md = _check_md(maxdoublings)
    codes, params, C, d = kernel_args(name, target, theta,
                                      (("grad", grad), ("m0", m0)), dense=True)
    lp, logu = lp.reshape(-1), logu.reshape(-1)
    _check_noise(name, C, md, theta.device, dirn=dirn, merge_u=merge_u,
                 leaf_u=leaf_u, lp=lp, logu=logu)
    step_for(name, target, eps, theta)
    eps_s, eps_row = _eps_args(eps, theta)
    dev = theta.device
    entry = dense_name(name, target)
    head = () if entry == name else (_ptr(target.factor(dev)),)
    th_o, g_o = torch.empty_like(theta), torch.empty_like(theta)
    lp_o = torch.empty(C, dtype=theta.dtype, device=dev)
    nd_o = torch.empty(C, dtype=torch.int32, device=dev)
    dv_o = torch.empty(C, dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        launch(load_target_kernels(), LAUNCHES, entry, *head, _ptr(codes),
               _ptr(params), d, C, _ptr(theta), _ptr(lp), _ptr(grad),
               _ptr(m0), _ptr(logu), _ptr(dirn), _ptr(merge_u), _ptr(leaf_u),
               _ptr(th_o), _ptr(g_o), _ptr(lp_o), _ptr(nd_o), _ptr(dv_o),
               eps_s, _ptr(eps_row), md, int(multinomial))
    return th_o, g_o, lp_o, nd_o, dv_o


def glm_nuts_multistep(XT, Y, theta, lp, grad, eps, generator, *, k_trans=8,
                       maxdoublings=6, kind="logistic", weights=None,
                       offsets=None, prior_prec=1.0, multinomial=False):
    """``k_trans`` exact NUTS transitions per launch, every draw (momenta by
    Box-Muller, slice, directions, merge and leaf uniforms) made inside the
    kernel from Philox4x32-10 keyed by a seed drawn from ``generator`` and
    counted by (chain, transition, draw): a generator in the same state
    repeats a launch bitwise, and :func:`glm_nuts_multistep_draws` replays
    the draws.
    Returns (theta, grad, lp (C,), rows) with rows ``ppars``/``pgrads``
    (k, C, d), ``plogtarget`` (k, C), ``accept``/``diverging`` (k, C) bool
    and ``ndoublings`` (k, C) int32, each after its transition."""
    name = "glm_nuts_multistep"
    if not _device_branch(name, theta):
        return glm_nuts_multistep_ref(
            XT, Y, theta, lp, grad, eps, generator, k_trans=k_trans,
            maxdoublings=maxdoublings, kind=kind, weights=weights,
            offsets=offsets, prior_prec=prior_prec, multinomial=multinomial)
    md = _check_md(maxdoublings)
    if k_trans < 1:
        raise ValueError(f"{name}: k_trans must be >= 1, got {k_trans}")
    lp = lp.reshape(-1)
    N, d, C, W, O = _check(name, XT, Y, weights, offsets, kind,
                           {"theta": theta, "grad": grad}, {"lp": lp})
    lam, lamv, lamm = _prior_args(name, prior_prec, d, theta.device)
    seed = _seed(generator)
    dev = theta.device
    th_o, g_o = torch.empty_like(theta), torch.empty_like(theta)
    lp_o = torch.empty(C, dtype=theta.dtype, device=dev)
    r_th = torch.empty((k_trans, C, d), dtype=theta.dtype, device=dev)
    r_g = torch.empty((k_trans, C, d), dtype=theta.dtype, device=dev)
    r_lp = torch.empty((k_trans, C), dtype=theta.dtype, device=dev)
    r_acc = torch.empty((k_trans, C), dtype=torch.bool, device=dev)
    r_nd = torch.empty((k_trans, C), dtype=torch.int32, device=dev)
    r_dv = torch.empty((k_trans, C), dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        scratch, nbytes = _scratch(dev, d, N, md)
        _launch(name, lamm, d, _ptr(XT), _ptr(_row(Y)), _ptr(W), _ptr(O),
                _ptr(lamv), _ptr(lamm), N, d, C, _ptr(theta), _ptr(lp),
                _ptr(grad), _ptr(th_o), _ptr(g_o), _ptr(lp_o), _ptr(r_th),
                _ptr(r_g), _ptr(r_lp), _ptr(r_acc), _ptr(r_nd), _ptr(r_dv),
                float(eps), lam, md,
                KIND_CODES[kind], int(multinomial), int(k_trans), int(seed),
                _ptr(_queue(dev)), _ptr(scratch), nbytes)
    return th_o, g_o, lp_o, _rows(r_th, r_g, r_lp, r_acc, r_nd, r_dv)


# ---- drivers ---------------------------------------------------------------


def _stack(rows, eps):
    infos = {k: torch.cat([r[k] for r in rows]) for k in rows[0]}
    infos["epsilon"] = torch.full(infos["plogtarget"].shape, float(eps),
                                  dtype=infos["plogtarget"].dtype,
                                  device=infos["plogtarget"].device)
    return infos


def _nuts_run(XT, Y, theta0, eps, generator, *, steps, maxdoublings,
              kind="logistic", W=None, O=None, lam=1.0, multinomial=False):
    """``steps`` exact NUTS transitions, one launch of
    :func:`glm_nuts_transition` each, the noise drawn from ``generator``
    before each launch (pallas_nuts.py ``_nuts_run``).
    Returns ((theta, lp, grad), infos stacked over steps)."""
    C, d = theta0.shape
    theta = theta0
    lp, g = glm_funcs(XT, Y, W, O, _prior(lam), kind)[1](theta0)
    rows = []
    for _ in range(steps):
        noise = draw_noise(C, d, maxdoublings, generator, theta.dtype,
                           theta.device)
        th2, g2, lp2, nd, dv = glm_nuts_transition(
            XT, Y, theta, lp, g, eps, *noise, maxdoublings=maxdoublings,
            kind=kind, weights=W, offsets=O, prior_prec=lam,
            multinomial=multinomial)
        rows.append({k: v[None] for k, v in _rows(
            th2, g2, lp2, (th2 != theta).any(-1), nd, dv).items()})
        theta, lp, g = th2, lp2, g2
    return (theta, lp, g), _stack(rows, eps)


def _nuts_run_hw(XT, Y, theta0, eps, generator, *, steps, k_trans,
                 maxdoublings, kind="logistic", W=None, O=None, lam=1.0,
                 multinomial=False):
    """``steps`` exact NUTS transitions as ``steps // k_trans`` launches of
    :func:`glm_nuts_multistep` (pallas_nuts.py ``_nuts_run_hw``); same
    return as :func:`_nuts_run`, another random stream."""
    if steps % k_trans:
        raise ValueError(f"steps ({steps}) must be a multiple of k_trans "
                         f"({k_trans})")
    theta = theta0
    lp, g = glm_funcs(XT, Y, W, O, _prior(lam), kind)[1](theta0)
    rows = []
    for _ in range(steps // k_trans):
        theta, g, lp, r = glm_nuts_multistep(
            XT, Y, theta, lp, g, eps, generator, k_trans=k_trans,
            maxdoublings=maxdoublings, kind=kind, weights=W, offsets=O,
            prior_prec=lam, multinomial=multinomial)
        rows.append(r)
    return (theta, lp, g), _stack(rows, eps)


def _nuts_target_run(target, theta0, eps_in, generator, *, steps,
                     maxdoublings, multinomial=False):
    """``steps`` exact NUTS transitions on a catalog target, one launch of
    :func:`target_nuts_transition` each, the noise drawn from ``generator``
    before each launch; lp and the gradient at the start from the target's
    plain evaluation (pallas_nuts.py ``_nuts_target_run``; on a dense target
    in ``z``: the base target at ``theta = z L'``, the gradient
    ``g_theta L``).  ``eps_in`` is the scalar step or the (d,) row
    ``eps * s``; as in the JAX package, the ``epsilon`` rows then report the
    row's first entry, ``eps * s_0``, and the scalar under a dense target.
    Returns ((theta, lp, grad), infos stacked over steps)."""
    C, d = theta0.shape
    theta = theta0
    lp, g = target_funcs(target)[1](theta0)
    rows = []
    for _ in range(steps):
        noise = draw_noise(C, d, maxdoublings, generator, theta.dtype,
                           theta.device)
        th2, g2, lp2, nd, dv = target_nuts_transition(
            target, theta, lp, g, eps_in, *noise, maxdoublings=maxdoublings,
            multinomial=multinomial)
        rows.append({k: v[None] for k, v in _rows(
            th2, g2, lp2, (th2 != theta).any(-1), nd, dv).items()})
        theta, lp, g = th2, lp2, g2
    eps_diag = eps_in.reshape(-1)[0] if isinstance(eps_in, torch.Tensor) \
        else eps_in
    return (theta, lp, g), _stack(rows, eps_diag)
