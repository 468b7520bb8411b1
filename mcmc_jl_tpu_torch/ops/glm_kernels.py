"""Fused GLM-HMC kernels: the port of ``mcmc_jl_tpu/ops/pallas_glm.py``.

Four kernels, written in CUDA C++ for Hopper in ``csrc/glm_hmc.cu``, replace
the Pallas kernel bodies:

============================  =========================================
wrapper (this module)         Pallas kernel it replaces
============================  =========================================
:func:`glm_leapfrogs`         ``pallas_glm.py _kernel`` (the trajectory)
:func:`glm_step`              ``pallas_glm.py _step_kernel`` (one transition)
:func:`glm_multistep`         ``pallas_glm.py _multistep_kernel``,
                              ``halton=False`` (k transitions, RNG inside)
:func:`glm_multistep_rows`    the same body with ``halton=True,
                              collect_rows=True`` (k transitions of shared
                              Halton-jittered length, per-transition rows)
============================  =========================================

Each has a plain PyTorch version beside it (``*_ref``) that does the same
math.  A wrapper runs the plain version only for tensors on the CPU; for
CUDA tensors it launches the kernel or raises.  Each launch adds one to
``LAUNCHES[name]``, each call of a plain version one to
``PLAIN_CALLS[name]``, so a run can show which of the two it went through.
:func:`glm_multistep_draws` replays the draws :func:`glm_multistep` makes
inside (from the launch seed :func:`_seed` takes from the generator), so
that its plain version can take them.

Layouts follow the JAX package at the public functions, minus its TPU
padding: the transposed design ``XT`` is (d, N), ``Y``/weights/offsets are
(N,) or (1, N), chain states are unpadded (C, d).  The prior is N(0, 1/lam I)
with a scalar ``lam``; :func:`glm_multistep_rows` also takes a (d,) row (the
diagonal-metric fold) or a symmetric (d, d) precision matrix ``A`` (the
dense-metric fold ``lam L' L``: prior gradient ``-theta A``, prior term
``-1/2 theta' A theta``).  A launch with a matrix counts under
``<name>_mat`` in ``LAUNCHES``.  The kernels take the four built-in links;
the plain versions also take a custom ``(ll, resid)`` pair.

The kernels take d up to :data:`D_MAX`: up to :data:`NARROW_D_MAX` on the
narrow chain tile (one thread a coordinate), up to :data:`WIDE_D_MAX` on the
wide tile (one warp a chain, the columns of the gradient split over the
warps), up to :data:`XWIDE_D_MAX` on the very-wide tile (the chain state in
device memory, in a scratch buffer :func:`_slots` allocates;
csrc/glm_tile.cuh), and above it on the chunked tier, which walks d in
column chunks of at most 512 (the proposal's theta in the scratch too).  A
launch on the wide tile counts under ``<name>_wide`` (``<name>_mat_wide``
with a matrix), one on the very-wide tile under ``<name>_xwide``
(``<name>_mat_xwide``), one on the chunked tier under ``<name>_chunked``
(``<name>_mat_chunked``), so a run shows which tile it went through.

:data:`D_MAX` is 16384, a constant although nothing in the chunked tier
depends on d but memory and indexing (its shared memory and registers are
sized by the 512-column chunk; every index that can pass 2^31 is a
``size_t``): it is the widest d at which the kernels are held against
their plain versions on the card.  At d 8192 a block's slot is 5 x 16 x
8192 float32 = 2.6 MB, 346 MB for the 132 blocks of an H100; the exact-NUTS
kernels (8, 9) take the same bound (``nuts_kernels.NUTS_D_MAX``).
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from ..samplers.chees import halton2
from ..samplers.integrators import SCHEDULES
from . import philox
from .cuda_build import count, scratch_buffer

KIND_CODES = {"logistic": 0, "linear": 1, "poisson": 2, "probit": 3}
#: largest parameter count the HMC kernels (1, 2, 3, 3b) and the N-tiled
#: kernel (4) take (csrc/glm_tile.cuh kXChunkDMax: the chunked tier's bound)
D_MAX = 16384
#: largest parameter count of the very-wide tile (csrc/glm_tile.cuh
#: kXWideMax); above it the chunked tier
XWIDE_D_MAX = 1024
#: largest parameter count of the narrow chain tile (csrc/glm_tile.cuh
#: kNarrowMax)
NARROW_D_MAX = 32
#: largest parameter count of the wide chain tile (csrc/glm_tile.cuh
#: kWideMax); above it the very-wide tile
WIDE_D_MAX = 256
#: Philox draw number of the MH (or slice) uniform of one (chain,
#: transition) of the multistep kernels (csrc/glm_tile.cuh kSliceDraw); the
#: momenta take draws 0 .. d/2 - 1
SLICE_DRAW = 0xFFFFFFFF

_NAMES = ("glm_leapfrogs", "glm_step", "glm_multistep", "glm_multistep_rows")
#: launches of the Halton multistep kernel with a (d, d) prior, and launches
#: on the wide tile (d > NARROW_D_MAX), the very-wide tile (d >
#: WIDE_D_MAX) and the chunked tier (d > XWIDE_D_MAX), counted apart
LAUNCHES = dict.fromkeys(
    _NAMES + ("glm_multistep_rows_mat",)
    + tuple(n + t for t in ("_wide", "_xwide", "_chunked")
            for n in _NAMES + ("glm_multistep_rows_mat",)), 0)
PLAIN_CALLS = dict.fromkeys(_NAMES, 0)


def reset_counts():
    """Zero the launch and plain-call counters."""
    for counts in (LAUNCHES, PLAIN_CALLS):
        for k in counts:
            counts[k] = 0


def link_terms(kind):
    """Per-observation log-lik and residual factor for a GLM link.

    ``ll(z, y)`` is the elementwise log-likelihood of linear predictor z;
    ``resid(z, y)`` is r such that d loglik / d theta = r @ X.  ``kind`` is
    a link name or a ``(ll, resid)`` pair of elementwise torch callables.
    Probit uses the exact ``torch.special.log_ndtr``.
    """
    if isinstance(kind, tuple):
        ll_fn, resid_fn = kind
        if not (callable(ll_fn) and callable(resid_fn)):
            raise TypeError("custom link must be a (ll(z, y), resid(z, y)) "
                            "pair of callables")
        return ll_fn, resid_fn
    if kind == "logistic":
        return (
            lambda z, y: z * y - torch.logaddexp(z, torch.zeros_like(z)),
            lambda z, y: y - torch.sigmoid(z),
        )
    if kind == "linear":  # unit-variance Gaussian residuals
        return (
            lambda z, y: -0.5 * (y - z) * (y - z),
            lambda z, y: y - z,
        )
    if kind == "poisson":  # log link; the lgamma(y+1) constant is dropped
        return (
            lambda z, y: y * z - torch.exp(z),
            lambda z, y: y - torch.exp(z),
        )
    if kind == "probit":
        log_ndtr = torch.special.log_ndtr

        def _ll(z, y):
            return y * log_ndtr(z) + (1.0 - y) * log_ndtr(-z)

        def _resid(z, y):
            log_phi = -0.5 * z * z - 0.5 * math.log(2.0 * math.pi)
            w_pos = torch.exp(log_phi - log_ndtr(z))
            w_neg = torch.exp(log_phi - log_ndtr(-z))
            return y * w_pos - (1.0 - y) * w_neg

        return _ll, _resid
    raise ValueError(f"unknown GLM link {kind!r}")


def _scalar_prior(prior_prec):
    """The scalar prior of kernels 1, 2 and 3: the warm pipeline's metric
    folds run kernels 3b, 4 and 8-9, so these take none."""
    if isinstance(prior_prec, torch.Tensor) and prior_prec.numel() != 1:
        raise NotImplementedError(
            "kernels 1, 2 and 3 take a scalar prior precision; the row and "
            "matrix priors of the metric folds run on the Halton multistep, "
            "tiled and NUTS kernels (ROADMAP: matrix prior on kernels "
            "1-3)")
    return float(prior_prec)


def _is_mat(prior_prec):
    """True for a (d, d) prior precision matrix with d > 1 (the dense fold;
    at d = 1 it is a scalar)."""
    return (isinstance(prior_prec, torch.Tensor) and prior_prec.ndim == 2
            and prior_prec.shape[0] == prior_prec.shape[1] > 1)


def _prior(prior_prec):
    """A scalar float, a (d,) tensor, or a (d, d) matrix (the dense fold)."""
    if _is_mat(prior_prec):
        return prior_prec
    if isinstance(prior_prec, torch.Tensor) and prior_prec.numel() > 1:
        return prior_prec.reshape(-1)
    return float(prior_prec)


def _prior_args(name, prior_prec, d, dev):
    """(scalar lam, (d,) row or None, (d, d) matrix or None) as the kernels
    take them."""
    lam = _prior(prior_prec)
    if isinstance(lam, float):
        return lam, None, None
    want = (d, d) if lam.ndim == 2 else (d,)
    if tuple(lam.shape) != want:
        raise ValueError(f"{name}: prior precision has shape "
                         f"{tuple(lam.shape)}, want {want}")
    lam_t = lam.to(device=dev, dtype=torch.float32).contiguous()
    return (1.0, None, lam_t) if lam.ndim == 2 else (1.0, lam_t, None)


def halton_leaps(i, eps, T, max_leaps):
    """The shared leap count of absolute transition ``i`` (warmstart.py
    ``_chees_scan``): ``clip(ceil(halton2(i) * T / eps), 1, max_leaps)``,
    in float32 in that order, as the kernel computes it."""
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)  # noqa: E731
    nl = torch.ceil(halton2(i) * f32(T) / f32(eps))
    return int(torch.clamp(nl, 1, max_leaps))


def _row(v):
    return None if v is None else v.reshape(-1)


# ---- plain PyTorch versions ----------------------------------------------


def glm_funcs(XT, Y, W, O, lam, kind):
    """(grad_only, logp_grad) over the GLM data (pallas_glm.py _glm_funcs).
    ``lam``: a scalar, a (d,) row, or a symmetric (d, d) matrix ``A``,
    whose prior gradient is ``theta A``."""
    ll_fn, resid_fn = link_terms(kind)
    Y, W, O = _row(Y), _row(W), _row(O)
    mat = isinstance(lam, torch.Tensor) and lam.ndim == 2

    def prior_grad(theta):
        return theta @ lam if mat else lam * theta

    def predictor(theta):
        z = theta @ XT
        return z + O if O is not None else z

    def grad_only(theta):
        r = resid_fn(predictor(theta), Y)
        if W is not None:
            r = W * r
        return r @ XT.T - prior_grad(theta)

    def logp_grad(theta):
        z = predictor(theta)
        r, ll = resid_fn(z, Y), ll_fn(z, Y)
        if W is not None:
            r, ll = W * r, W * ll
        pg = prior_grad(theta)
        return ll.sum(-1) - 0.5 * (pg * theta).sum(-1), r @ XT.T - pg

    return grad_only, logp_grad


def _trajectory(theta, m, g, eps, grad_only, logp_grad, n_leaps, integrator):
    """``n_leaps`` macro steps of the SCHEDULES integrator; the last drift
    yields lp from the same pass as its gradient (pallas_glm.py _trajectory).
    Returns (theta, m, g, lp)."""
    schedule = SCHEDULES[integrator]
    last_d = max(i for i, (op, _) in enumerate(schedule) if op == "A")
    lp = None
    for leap in range(n_leaps):
        final = leap == n_leaps - 1
        for j, (op, c) in enumerate(schedule):
            if op == "B":
                m = m + c * eps * g
            else:
                theta = theta + c * eps * m
                if final and j == last_d:
                    lp, g = logp_grad(theta)
                else:
                    g = grad_only(theta)
    return theta, m, g, lp


def accept_test(h0, h, logu):
    """NaN-rejecting Metropolis test on per-chain Hamiltonians."""
    ratio = h0 - h
    ratio = torch.where(torch.isnan(ratio), -torch.inf, ratio)
    return (ratio > 0) | (ratio > logu)


def glm_leapfrogs_ref(XT, Y, theta, m, grad, eps, *, n_leaps=10,
                      kind="logistic", weights=None, offsets=None,
                      prior_prec=1.0, integrator="leapfrog"):
    """Plain version of :func:`glm_leapfrogs`."""
    PLAIN_CALLS["glm_leapfrogs"] += 1
    grad_only, logp_grad = glm_funcs(XT, Y, weights, offsets,
                                     _scalar_prior(prior_prec), kind)
    return _trajectory(theta, m, grad, eps, grad_only, logp_grad, n_leaps,
                       integrator)


def glm_step_ref(XT, Y, theta, grad, lp, m0, logu, eps, *, n_leaps=10,
                 kind="logistic", weights=None, offsets=None, prior_prec=1.0,
                 integrator="leapfrog"):
    """Plain version of :func:`glm_step`."""
    PLAIN_CALLS["glm_step"] += 1
    grad_only, logp_grad = glm_funcs(XT, Y, weights, offsets,
                                     _scalar_prior(prior_prec), kind)
    lp0, logu = lp.reshape(-1), logu.reshape(-1)
    h0 = -lp0 + 0.5 * (m0 * m0).sum(-1)
    th, m, g, lp1 = _trajectory(theta, m0, grad, eps, grad_only, logp_grad,
                                n_leaps, integrator)
    acc = accept_test(h0, -lp1 + 0.5 * (m * m).sum(-1), logu)
    a = acc[:, None]
    return (torch.where(a, th, theta), torch.where(a, g, grad),
            torch.where(acc, lp1, lp0)[:, None], a.to(theta.dtype))


def glm_multistep_ref(XT, Y, theta, eps, *, k_trans=10, n_leaps=10,
                      generator=None, noise=None, kind="logistic",
                      weights=None, offsets=None, prior_prec=1.0,
                      integrator="leapfrog"):
    """Plain version of :func:`glm_multistep`: ``k_trans`` whole transitions.

    The momenta and MH uniforms come from ``noise = (z (k, C, d), logu
    (k, C))`` when given (exact comparisons), else from ``generator``
    (another stream than the kernel's Philox: compare statistically).
    Returns (theta, grad, lp (C,), accept rate (C,))."""
    PLAIN_CALLS["glm_multistep"] += 1
    grad_only, logp_grad = glm_funcs(XT, Y, weights, offsets,
                                     _scalar_prior(prior_prec), kind)
    lp, g = logp_grad(theta)
    n_acc = torch.zeros_like(lp)
    for t in range(k_trans):
        if noise is not None:
            m0, logu = noise[0][t], noise[1][t]
        else:
            m0 = torch.randn(theta.shape, generator=generator,
                             dtype=theta.dtype, device=theta.device)
            logu = torch.log(1.0 - torch.rand(
                theta.shape[:1], generator=generator, dtype=theta.dtype,
                device=theta.device))
        h0 = -lp + 0.5 * (m0 * m0).sum(-1)
        th_p, m, g_p, lp_p = _trajectory(theta, m0, g, eps, grad_only,
                                         logp_grad, n_leaps, integrator)
        a = accept_test(h0, -lp_p + 0.5 * (m * m).sum(-1), logu)
        theta = torch.where(a[:, None], th_p, theta)
        g = torch.where(a[:, None], g_p, g)
        lp = torch.where(a, lp_p, lp)
        n_acc = n_acc + a.to(n_acc.dtype)
    return theta, g, lp, n_acc / k_trans


def glm_multistep_draws(seed, C, d, k_trans, i0=0, device="cpu"):
    """The momenta and MH log-uniforms that :func:`glm_multistep` draws
    inside under the launch seed ``seed`` (:func:`_seed`), replayed by
    :mod:`.philox`: (m0 (k, C, d), logu (k, C)) float32 for the transitions
    ``i0 .. i0 + k_trans - 1``, laid out as ``noise`` of
    :func:`glm_multistep_ref`.  The counter is (chain, transition, draw,
    0): coordinate j is Box-Muller on words 0, 1 (even j) or 2, 3 (odd j)
    of draw j // 2, log u is log(1 - u) of draw ``SLICE_DRAW``
    (csrc/glm_tile.cuh ``momentum``, ``log_uniform``; the multistep NUTS
    kernel draws its momenta and slice the same way).  Within a few float32
    ulps of the kernel's values.  The replay runs on ``device``."""
    ar = _arange_for(device)
    c, t = ar(0, C)[None, :, None], ar(i0, i0 + k_trans)[:, None, None]
    b = philox.philox4x32((c, t, ar(0, (d + 1) // 2), 0), seed)
    # one draw a pair of coordinates: 2 jh from words 0, 1, 2 jh + 1 from 2, 3
    m0 = torch.stack([philox.box_muller(b[0], b[1]),
                      philox.box_muller(b[2], b[3])], -1).reshape(
        k_trans, C, -1)[..., :d]
    logu = philox.log1m_u01(philox.philox4x32(
        (c[..., 0], t[..., 0], SLICE_DRAW, 0), seed)[0])
    return m0.contiguous(), logu.contiguous()


def _arange_for(device):
    """The int64 arange of a replay's counters on ``device``."""
    return lambda lo, hi: torch.arange(lo, hi, dtype=torch.int64,
                                       device=device)


def _draw(theta, generator):
    """One transition's momenta and MH log-uniform from ``generator``."""
    m0 = torch.randn(theta.shape, generator=generator, dtype=theta.dtype,
                     device=theta.device)
    logu = torch.log(torch.rand(theta.shape[:1], generator=generator,
                                dtype=theta.dtype, device=theta.device))
    return m0, logu


def glm_multistep_rows_ref(XT, Y, theta, eps, T, i0, max_leaps, *, k_trans=8,
                           generator=None, noise=None, kind="logistic",
                           weights=None, offsets=None, prior_prec=1.0,
                           integrator="leapfrog"):
    """Plain version of :func:`glm_multistep_rows`: ``k_trans`` whole
    transitions, transition ``t`` integrating the shared leap count
    :func:`halton_leaps` of ``i0 + t``.

    The momenta and MH log-uniforms come from ``noise = (z (k, C, d), logu
    (k, C))`` when given, else from ``generator`` (another stream than the
    kernel's Philox: compare statistically).  Returns (theta, grad, lp (C,),
    rows) with rows ``ppars``/``pgrads`` (k, C, d), ``plogtarget``/``alpha``
    (k, C), ``accept`` (k, C) bool and ``nleaps`` (k, C) int32, each after
    its transition."""
    PLAIN_CALLS["glm_multistep_rows"] += 1
    grad_only, logp_grad = glm_funcs(XT, Y, weights, offsets,
                                     _prior(prior_prec), kind)
    lp, g = logp_grad(theta)
    rows = {k: [] for k in ("ppars", "pgrads", "plogtarget", "accept",
                            "alpha", "nleaps")}
    for t in range(k_trans):
        nl = halton_leaps(i0 + t, eps, T, max_leaps)
        m0, logu = ((noise[0][t], noise[1][t]) if noise is not None
                    else _draw(theta, generator))
        h0 = -lp + 0.5 * (m0 * m0).sum(-1)
        th_p, m, g_p, lp_p = _trajectory(theta, m0, g, eps, grad_only,
                                         logp_grad, nl, integrator)
        h1 = -lp_p + 0.5 * (m * m).sum(-1)
        ratio = h0 - h1
        a = accept_test(h0, h1, logu)
        theta = torch.where(a[:, None], th_p, theta)
        g = torch.where(a[:, None], g_p, g)
        lp = torch.where(a, lp_p, lp)
        for k, v in (("ppars", theta), ("pgrads", g), ("plogtarget", lp),
                     ("accept", a),
                     ("alpha", torch.where(torch.isnan(ratio), 0.0,
                                           torch.exp(ratio.clamp(max=0.0)))),
                     ("nleaps", torch.full(lp.shape, nl, dtype=torch.int32,
                                           device=lp.device))):
            rows[k].append(v)
    return theta, g, lp, {k: torch.stack(v) for k, v in rows.items()}


# ---- CUDA kernels ----------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_LL = ctypes.c_longlong
# the schedule, then the very-wide tile's scratch (pointer, bytes) and the
# stream
_SCHED = [ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_float), _I,
          _P, _LL, _P]
_ARGTYPES = {
    "glm_leapfrogs": [_P] * 4 + [_I] * 3 + [_P] * 7 + [_F, _F, _I, _I]
    + _SCHED,
    "glm_step": [_P] * 4 + [_I] * 3 + [_P] * 9 + [_F, _F, _I, _I] + _SCHED,
    "glm_multistep": [_P] * 4 + [_I] * 3 + [_P] * 5 + [_F, _F, _I, _I, _I,
                                                       ctypes.c_ulonglong]
    + _SCHED,
    "glm_multistep_rows": [_P] * 6 + [_I] * 3 + [_P] * 10 + [_F] * 3
    + [_I] * 4 + [ctypes.c_ulonglong] + _SCHED,
}


def load_kernels():
    """Build (first use) and bind ``csrc/glm_hmc.cu``; returns the library."""
    from .cuda_build import load

    lib = load("glm_hmc")
    if not getattr(lib, "_bound", False):
        for name, argtypes in _ARGTYPES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.glm_error_string.argtypes = [ctypes.c_int]
        lib.glm_error_string.restype = ctypes.c_char_p
        lib.glm_max_dim.restype = ctypes.c_int
        lib.glm_slot_bytes.argtypes = [ctypes.c_int]
        lib.glm_slot_bytes.restype = _LL
        if lib.glm_max_dim() != D_MAX:
            raise RuntimeError("csrc/glm_hmc.cu and glm_kernels.D_MAX disagree")
        lib._bound = True
    return lib


_SLOTS = {}


def _slots(dev, d, C):
    """(buffer, bytes) of the very-wide tile's chain state for C chains of d
    parameters on ``dev``'s current stream: one slot of theta, g, m and the
    proposal's g (4 x 16 x D float32, csrc/glm_tile.cuh xwide_slot_bytes;
    on the chunked tier also the proposal's theta, 5 x 16 x D,
    xchunk_slot_bytes: 2.6 MB at d 8192) for each block a launch runs at
    once, at most one an SM (the tiles' plans take more than half an SM's
    shared memory).  One buffer for each (device, stream, D), allocated once
    and grown when a launch needs more; the kernel runs no more blocks than
    it holds slots for.  (None, 0) at d <= WIDE_D_MAX, where the chain state
    stays in registers."""
    if d <= WIDE_D_MAX:
        return None, 0
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    need = load_kernels().glm_slot_bytes(d) * min(-(-C // 16), sms)
    key = (dev, torch.cuda.current_stream(dev).cuda_stream, (d + 31) // 32)
    return scratch_buffer(_SLOTS, key, need, dev)


@functools.cache
def _sched(integrator):
    """The kick/drift schedule of ``integrator`` as the kernels take it:
    (ops, coefficients, length), ctypes arrays built once per integrator
    (the kernels copy them at launch)."""
    schedule = SCHEDULES[integrator]
    ops = (ctypes.c_int * len(schedule))(*[1 if op == "A" else 0
                                            for op, _ in schedule])
    cs = (ctypes.c_float * len(schedule))(*[c for _, c in schedule])
    return ops, cs, len(schedule)


def _check(name, XT, Y, weights, offsets, kind, states, per_chain=None):
    """Validate what the kernel takes: ``states`` (name -> tensor) must be
    (C, d) and ``per_chain`` ones (C,), with C from ``theta``, and d at most
    the kernels' bound :data:`D_MAX` (the exact-NUTS kernels' too).
    Returns (N, d, C, flat W, flat O)."""
    if kind not in KIND_CODES:
        raise ValueError(f"{name}: the CUDA kernel takes the links "
                         f"{sorted(KIND_CODES)}, got {kind!r}")
    dev = XT.device
    if XT.ndim != 2:
        raise ValueError(f"{name}: XT must be (d, N), got {tuple(XT.shape)}")
    d, N = XT.shape
    if not 1 <= d <= D_MAX:
        raise ValueError(f"{name}: d = {d} outside the kernel's 1..{D_MAX}")
    C = states["theta"].shape[0] if states["theta"].ndim else 0
    per_chain = per_chain or {}
    obs = {"Y": _row(Y), "weights": _row(weights), "offsets": _row(offsets)}
    for label, t in {"XT": XT, **obs, **states, **per_chain}.items():
        if t is None:
            continue
        if t.device != dev or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(
                f"{name}: {label} must be a contiguous float32 tensor on "
                f"{dev}, got {t.dtype} on {t.device}"
                f"{'' if t.is_contiguous() else ' (not contiguous)'}")
    want = {**{k: (N,) for k in obs}, **{k: (C, d) for k in states},
            **{k: (C,) for k in per_chain}}
    for label, t in {**obs, **states, **per_chain}.items():
        if t is not None and tuple(t.shape) != want[label]:
            raise ValueError(f"{name}: {label} has shape {tuple(t.shape)}, "
                             f"want {want[label]}")
    return N, d, C, _row(weights), _row(offsets)


def _ptr(t):
    return _P(None if t is None else t.data_ptr())


def _seed(generator):
    """A launch seed drawn from the run's ``torch.Generator``: a generator
    in the same state gives the same seed, which is how a check replays a
    launch's draws."""
    if generator is None:
        raise ValueError("a kernel that draws inside needs a torch.Generator "
                         "on the card for its launch seed")
    return int(torch.randint(0, 2 ** 62, (1,), generator=generator,
                             device=generator.device).item())


def _padded(d):
    """The kernels' padded width at d (csrc/glm_tile.cuh glm_bound_for)
    above the narrow tile: d to a multiple of 32 up to XWIDE_D_MAX, above
    it n chunks of DC columns, n = ceil(d / 512) and DC = ceil(d / n) to a
    multiple of 32."""
    if d <= XWIDE_D_MAX:
        return -(-d // 32) * 32
    n = -(-d // 512)
    return n * ((-(-d // n) + 31) // 32 * 32)


def _counted(name, lamm, d=0):
    """The launch counter of kernel ``name``: its own, ``<name>_mat`` for
    the variant with a (d, d) prior, and either with ``_wide`` appended for
    a launch on the wide tile (NARROW_D_MAX < d <= WIDE_D_MAX), ``_xwide``
    on the very-wide tile (WIDE_D_MAX < d <= XWIDE_D_MAX) or ``_chunked``
    on the chunked tier (d > XWIDE_D_MAX)."""
    tier = ("_chunked" if d > XWIDE_D_MAX else "_xwide" if d > WIDE_D_MAX
            else "_wide" if d > NARROW_D_MAX else "")
    return name + ("" if lamm is None else "_mat") + tier


def _launch(name, d, C, *args, counted=None):
    """Launch ``name`` on the current stream with ``args``, then the
    very-wide tile's scratch for (d, C) (none at d <= WIDE_D_MAX)."""
    lib = load_kernels()
    scratch, nbytes = _slots(torch.cuda.current_device(), d, C)
    code = getattr(lib, name)(*args, _ptr(scratch), nbytes,
                              _P(torch.cuda.current_stream().cuda_stream))
    if code != 0:
        raise RuntimeError(f"{name} launch failed: "
                           f"{lib.glm_error_string(code).decode()} ({code})")
    count(LAUNCHES, counted or name)


def _device_branch(name, theta):
    """True for CUDA tensors; False for CPU tensors (plain version)."""
    if theta.device.type == "cuda":
        return True
    if theta.device.type == "cpu":
        return False
    raise ValueError(f"{name}: no kernel for device {theta.device}")


def glm_leapfrogs(XT, Y, theta, m, grad, eps, *, n_leaps=10, kind="logistic",
                  weights=None, offsets=None, prior_prec=1.0,
                  integrator="leapfrog"):
    """``n_leaps`` fused macro steps of ``integrator`` for all chains.

    Args: ``XT`` (d, N); ``Y`` (N,); ``theta``, ``m``, ``grad`` (C, d)
    with ``grad`` the gradient at ``theta``; scalar ``eps``.
    Returns (theta, m, grad, logp (C,)) at the end of the trajectory."""
    if not _device_branch("glm_leapfrogs", theta):
        return glm_leapfrogs_ref(XT, Y, theta, m, grad, eps, n_leaps=n_leaps,
                                 kind=kind, weights=weights, offsets=offsets,
                                 prior_prec=prior_prec, integrator=integrator)
    N, d, C, W, O = _check("glm_leapfrogs", XT, Y, weights, offsets, kind,
                           {"theta": theta, "m": m, "grad": grad})
    th_o, m_o, g_o = (torch.empty_like(theta) for _ in range(3))
    lp_o = torch.empty(C, dtype=theta.dtype, device=theta.device)
    with torch.cuda.device(theta.device):
        _launch("glm_leapfrogs", d, C, _ptr(XT), _ptr(_row(Y)), _ptr(W),
                _ptr(O), N, d, C, _ptr(theta), _ptr(m), _ptr(grad),
                _ptr(th_o), _ptr(m_o), _ptr(g_o), _ptr(lp_o), float(eps),
                _scalar_prior(prior_prec), int(n_leaps), KIND_CODES[kind],
                *_sched(integrator),
                counted=_counted("glm_leapfrogs", None, d))
    return th_o, m_o, g_o, lp_o


def glm_step(XT, Y, theta, grad, lp, m0, logu, eps, *, n_leaps=10,
             kind="logistic", weights=None, offsets=None, prior_prec=1.0,
             integrator="leapfrog"):
    """One whole HMC transition with pre-drawn momenta ``m0`` (C, d) and
    log-uniforms ``logu`` (C, 1): trajectory, Hamiltonian, NaN-rejecting
    accept.  ``lp`` (C, 1) is the log-target at ``theta``.
    Returns (theta, grad, lp (C, 1), accept (C, 1) as float)."""
    if not _device_branch("glm_step", theta):
        return glm_step_ref(XT, Y, theta, grad, lp, m0, logu, eps,
                            n_leaps=n_leaps, kind=kind, weights=weights,
                            offsets=offsets, prior_prec=prior_prec,
                            integrator=integrator)
    lp, logu = lp.reshape(-1), logu.reshape(-1)
    N, d, C, W, O = _check("glm_step", XT, Y, weights, offsets, kind,
                           {"theta": theta, "grad": grad, "m0": m0},
                           {"lp": lp, "logu": logu})
    th_o, g_o = torch.empty_like(theta), torch.empty_like(theta)
    lp_o = torch.empty(C, 1, dtype=theta.dtype, device=theta.device)
    acc_o = torch.empty(C, 1, dtype=theta.dtype, device=theta.device)
    with torch.cuda.device(theta.device):
        _launch("glm_step", d, C, _ptr(XT), _ptr(_row(Y)), _ptr(W),
                _ptr(O), N, d, C, _ptr(theta), _ptr(grad), _ptr(lp),
                _ptr(m0), _ptr(logu), _ptr(th_o), _ptr(g_o), _ptr(lp_o),
                _ptr(acc_o),
                float(eps), _scalar_prior(prior_prec), int(n_leaps),
                KIND_CODES[kind], *_sched(integrator),
                counted=_counted("glm_step", None, d))
    return th_o, g_o, lp_o, acc_o


def glm_multistep(XT, Y, theta, eps, *, k_trans=10, n_leaps=10,
                  generator=None, kind="logistic", weights=None,
                  offsets=None, prior_prec=1.0, integrator="leapfrog"):
    """``k_trans`` whole HMC transitions per launch, the momenta (Box-Muller)
    and MH uniforms drawn inside the kernel from Philox4x32-10 keyed by a
    seed drawn from ``generator`` and counted by (chain, transition): a
    generator in the same state repeats a launch bitwise, and
    :func:`glm_multistep_draws` replays its draws.
    Returns (theta, grad, lp (C,), accept rate (C,))."""
    if not _device_branch("glm_multistep", theta):
        return glm_multistep_ref(XT, Y, theta, eps, k_trans=k_trans,
                                 n_leaps=n_leaps, generator=generator,
                                 kind=kind, weights=weights, offsets=offsets,
                                 prior_prec=prior_prec, integrator=integrator)
    N, d, C, W, O = _check("glm_multistep", XT, Y, weights, offsets, kind,
                           {"theta": theta})
    seed = _seed(generator)
    th_o, g_o = torch.empty_like(theta), torch.empty_like(theta)
    lp_o = torch.empty(C, dtype=theta.dtype, device=theta.device)
    acc_o = torch.empty(C, dtype=theta.dtype, device=theta.device)
    with torch.cuda.device(theta.device):
        _launch("glm_multistep", d, C, _ptr(XT), _ptr(_row(Y)), _ptr(W),
                _ptr(O), N, d, C, _ptr(theta), _ptr(th_o), _ptr(g_o),
                _ptr(lp_o), _ptr(acc_o), float(eps), _scalar_prior(prior_prec),
                int(n_leaps), int(k_trans), KIND_CODES[kind], int(seed),
                *_sched(integrator),
                counted=_counted("glm_multistep", None, d))
    return th_o, g_o, lp_o, acc_o


def glm_multistep_rows(XT, Y, theta, eps, T, i0, max_leaps, *, k_trans=8,
                       generator=None, kind="logistic", weights=None,
                       offsets=None, prior_prec=1.0, integrator="leapfrog"):
    """``k_trans`` whole HMC transitions per launch, transition ``t``
    integrating the shared Halton-jittered leap count of absolute transition
    ``i0 + t`` (:func:`halton_leaps`), with per-transition post-accept rows.
    The momenta and MH uniforms are drawn inside the kernel from
    Philox4x32-10 keyed by a seed drawn from ``generator`` and counted by
    (chain, absolute transition, draw): a generator in the same state repeats
    a launch bitwise.  ``prior_prec`` is a scalar, a (d,) row or a symmetric
    (d, d) matrix (the launch then counts as ``glm_multistep_rows_mat``).
    Returns (theta, grad, lp (C,), rows) as :func:`glm_multistep_rows_ref`."""
    name = "glm_multistep_rows"
    if not _device_branch(name, theta):
        return glm_multistep_rows_ref(
            XT, Y, theta, eps, T, i0, max_leaps, k_trans=k_trans,
            generator=generator, kind=kind, weights=weights, offsets=offsets,
            prior_prec=prior_prec, integrator=integrator)
    if k_trans < 1 or max_leaps < 1 or i0 < 0:
        raise ValueError(f"{name}: need k_trans, max_leaps >= 1 and i0 >= 0, "
                         f"got {k_trans}, {max_leaps}, {i0}")
    N, d, C, W, O = _check(name, XT, Y, weights, offsets, kind,
                           {"theta": theta})
    lam, lamv, lamm = _prior_args(name, prior_prec, d, theta.device)
    seed = _seed(generator)
    dev = theta.device
    f32 = lambda *shape: torch.empty(shape, dtype=theta.dtype, device=dev)  # noqa: E731
    th_o, g_o, lp_o = f32(C, d), f32(C, d), f32(C)
    r_th, r_g = f32(k_trans, C, d), f32(k_trans, C, d)
    r_lp, r_acc, r_alpha = (f32(k_trans, C) for _ in range(3))
    r_nl = torch.empty((k_trans, C), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        _launch(name, d, C, _ptr(XT), _ptr(_row(Y)), _ptr(W), _ptr(O),
                _ptr(lamv), _ptr(lamm), N, d, C, _ptr(theta), _ptr(th_o),
                _ptr(g_o), _ptr(lp_o), _ptr(r_th), _ptr(r_g), _ptr(r_lp),
                _ptr(r_acc), _ptr(r_alpha),
                _ptr(r_nl), float(eps), float(T), lam, int(i0),
                int(max_leaps), int(k_trans), KIND_CODES[kind], int(seed),
                *_sched(integrator), counted=_counted(name, lamm, d))
    return th_o, g_o, lp_o, {"ppars": r_th, "pgrads": r_g, "plogtarget": r_lp,
                             "accept": r_acc > 0.5, "alpha": r_alpha,
                             "nleaps": r_nl}
