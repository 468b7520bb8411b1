"""Fused HMC on custom targets: the port of ``mcmc_jl_tpu/ops/pallas_target.py``.

The Pallas kernels differentiate a user's ``logp_block`` inside the kernel
with ``jax.vjp``.  CUDA has no autodiff, so the port splits custom targets
in two (ROADMAP: custom targets):

- a **catalog target** — a product of the ten continuous catalog families
  over the coordinates, each with Python-scalar parameters
  (:func:`coordwise_logp`, or a DSL model's ``target_spec``) — runs on
  hand-written CUDA: each family is an analytic ``(logp, dlogp/dx)``
  device-function pair (``csrc/target_common.cuh``);
- every other model runs on the generic torch engine through
  ``torch.func``; the route decides that up front
  (``parallel/pchains.py``).

Two kernels, in ``csrc/target_hmc.cu``, replace the Pallas kernel bodies:

==============================  ==========================================
wrapper (this module)           Pallas kernel it replaces
==============================  ==========================================
:func:`fused_target_leapfrogs`  ``pallas_target.py _kernel`` (the
                                trajectory; a scalar or (d,) step, a leap
                                count given at run time)
:func:`target_multistep`        ``pallas_target.py _multistep_kernel`` (k
                                transitions, RNG inside)
==============================  ==========================================

The trajectory kernel also takes a :class:`DenseTarget`, a catalog target
seen through a frozen dense metric (``z -> target(z L')``, the JAX
package's ``_dense_wrap``): with a scalar step it evaluates the families at
``theta = z L'`` and returns the gradient in ``z``, ``g_theta L``; such
launches count as ``target_leapfrogs_dense``.  The other kernels refuse a
dense target.

A third, :func:`target_logp_grad` (one (logp, gradient) pass, sanitized as
the model's gradient is), has no Pallas counterpart: it is the generic
engine's ``model.evalallg`` on the card for a catalog DSL model in float32,
where the JAX package's generic engine runs its model's
``jax.value_and_grad`` compiled by XLA.

Each has a plain PyTorch version beside it (``*_ref``) that differentiates
the distributions' ``logpdf`` with ``torch.func`` (never the kernels'
hand-written derivatives).  A wrapper runs the plain version only for
tensors on the CPU; for CUDA tensors it launches the kernel or raises —
also for a target without kernel rows and for d above
:data:`D_MAX`.  Launches count in ``LAUNCHES``, plain calls in
``PLAIN_CALLS``.  Chain states are unpadded (C, d) float32 tensors.

Each kernel has two layouts, decided up front from d
(:func:`target_leapfrogs_layout`, :func:`target_multistep_layout`,
:func:`target_logp_grad_layout`): one chain per lane up to
:data:`LANE_D_MAX`, one warp per chain above.  Code that launches one in a
loop takes it through a launcher (:func:`leapfrogs_launcher`,
:func:`multistep_launcher`, :func:`logp_grad_launcher`), which validates
once what stays fixed over the loop and then launches without the public
wrapper's checks.

Not ported: ``lifted_model_block`` (data-bearing targets run generic) and
``target_kernel_supported`` (no compile probe: the route decides up
front).  :func:`run_target_hmc_sharded` runs the trajectory kernel shard by
shard over a device mesh.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from ..models.distributions import (FAMILY_CODES, CatalogTarget, DenseTarget,
                                    Distribution)
from . import philox
from .glm_kernels import _draw, _sched, _seed, _trajectory, accept_test
from .cuda_build import count

#: largest dimension the kernels take: 32 lanes x 32 coordinates per lane
D_MAX = 1024
#: largest dimension of the lane layout (one chain per lane) of the
#: custom-target kernels; above it, one warp per chain
LANE_D_MAX = 32

#: why a model without a ``target_spec`` runs on the generic engine
NOT_CATALOG = ("the model is not a product of catalog densities over its "
               "parameters (callable mode, derived quantities, acc(), data or "
               "tensor-valued parameters), so the custom-target kernels "
               "cannot take it")

_NAMES = ("target_leapfrogs", "target_leapfrogs_dense", "target_multistep",
          "target_logp_grad")
LAUNCHES = dict.fromkeys(_NAMES, 0)
PLAIN_CALLS = dict.fromkeys(_NAMES, 0)


def reset_counts():
    """Zero the launch and plain-call counters."""
    for counts in (LAUNCHES, PLAIN_CALLS):
        for k in counts:
            counts[k] = 0


def coordwise_logp(dist, d, d_pad=None, safe=0.5):
    """A target that sums a per-coordinate log-density over ``d``
    coordinates (pallas_target.py ``coordwise_logp``).

    ``dist`` is a catalog :class:`Distribution` (every coordinate), a
    sequence of ``d`` of them (a mixed target), or an elementwise callable
    ``logpdf(x)`` (no kernel rows: such a target runs only on the plain
    version).  ``d_pad`` and ``safe`` are kept for the signature: the port
    has no padded lanes."""
    del d_pad, safe
    if isinstance(dist, Distribution):
        return CatalogTarget([dist] * d)
    if isinstance(dist, (list, tuple)):
        if len(dist) != d:
            raise ValueError(f"{len(dist)} distributions for d = {d}")
        return CatalogTarget(dist)
    if callable(dist):
        return CatalogTarget(d=d, block=lambda th: dist(th).sum(
            -1, keepdim=True))
    raise TypeError(f"coordwise_logp takes a Distribution, a sequence of "
                    f"them or a callable, got {type(dist).__name__}")


def model_block_fn(model):
    """The target of a model (pallas_target.py ``model_block_fn``): its
    ``target_spec`` when it has one, else a target without kernel rows
    around ``model.eval``."""
    if model.target_spec is not None:
        return model.target_spec
    return CatalogTarget(d=model.size,
                         block=lambda th: model.eval(th).unsqueeze(-1))


# ---- plain PyTorch versions ----------------------------------------------


def target_funcs(target):
    """(grad_only, logp_grad) of a target by ``torch.func`` (the JAX
    kernel's ``jax.grad`` / ``jax.vjp`` pair); chains are independent, so
    the gradient of the summed log-density is each chain's gradient."""
    def grad_only(theta):
        return torch.func.grad(lambda th: target(th).sum())(theta)

    def logp_grad(theta):
        lp, vjp = torch.func.vjp(target, theta)
        (g,) = vjp(torch.ones_like(lp))
        return lp[:, 0], g

    return grad_only, logp_grad


def _eps(eps, theta):
    """The step as the kernels and plain versions take it: a Python float,
    or a (d,) row on theta's device in its dtype (the diagonal-metric
    fold)."""
    if isinstance(eps, torch.Tensor) or hasattr(eps, "__len__"):
        e = torch.as_tensor(eps, dtype=theta.dtype, device=theta.device)
        if e.numel() == 1:
            return float(e)
        if e.numel() != theta.shape[-1]:
            raise ValueError(f"the step row has {e.numel()} entries, want "
                             f"{theta.shape[-1]}")
        return e.reshape(-1).contiguous()
    return float(eps)


def _eps_args(eps, theta):
    """(scalar eps, (d,) row or None) as the kernels take them."""
    e = _eps(eps, theta)
    return (1.0, e) if isinstance(e, torch.Tensor) else (e, None)


def dense_name(name, target):
    """``name`` of a kernel with ``_dense`` added for a :class:`DenseTarget`:
    the launches and plain calls of its z-space pass count apart."""
    return name + "_dense" if isinstance(target, DenseTarget) else name


def step_for(name, target, eps, theta):
    """The step as :func:`_eps` gives it; a dense target takes a scalar
    (its metric is the factor), so a step row raises."""
    e = _eps(eps, theta)
    if isinstance(target, DenseTarget) and isinstance(e, torch.Tensor):
        raise ValueError(f"{name}: a dense target takes a scalar step, not a "
                         f"step row: its metric is the factor L")
    return e


def refuse_dense(name, target):
    """Raise for a :class:`DenseTarget` on a kernel without the z-space
    pass (every kernel but 5 and 8b)."""
    if isinstance(target, DenseTarget):
        raise ValueError(f"{name}: the kernel has no z-space pass for a dense "
                         f"target (kernels 5 and 8b, target_leapfrogs and "
                         f"target_nuts_transition, have one)")


def target_logp_grad_ref(target, theta):
    """Plain version of :func:`target_logp_grad` (``torch.func``, then the
    model's sanitizing)."""
    from ..models.model import _sanitize_allg

    refuse_dense("target_logp_grad", target)
    PLAIN_CALLS["target_logp_grad"] += 1
    return _sanitize_allg(target_funcs(target)[1])(theta)


def fused_target_leapfrogs_ref(target, theta, m, grad, eps, *, n_leaps=10,
                               integrator="leapfrog"):
    """Plain version of :func:`fused_target_leapfrogs`."""
    name = "target_leapfrogs"
    eps = step_for(name, target, eps, theta)
    PLAIN_CALLS[dense_name(name, target)] += 1
    grad_only, logp_grad = target_funcs(target)
    return _trajectory(theta, m, grad, eps, grad_only, logp_grad,
                       int(n_leaps), integrator)


def target_multistep_ref(target, theta, eps, *, k_trans=10, n_leaps=10,
                         generator=None, noise=None, integrator="leapfrog"):
    """Plain version of :func:`target_multistep`: ``k_trans`` whole
    transitions.  The momenta and MH log-uniforms come from ``noise = (z
    (k, C, d), logu (k, C))`` when given, else from ``generator`` (another
    stream than the kernel's Philox: compare statistically).
    Returns (theta, grad, lp (C,), accept rate (C,))."""
    refuse_dense("target_multistep", target)
    PLAIN_CALLS["target_multistep"] += 1
    grad_only, logp_grad = target_funcs(target)
    eps = _eps(eps, theta)
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


# ---- CUDA kernels ----------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SCHED = [ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_float), _I]
_ARGTYPES = {
    "target_leapfrogs": [_P, _P, _I, _I] + [_P] * 7 + [_F, _P, _I] + _SCHED
    + [_P],
    "target_leapfrogs_dense": [_P, _P, _P, _I, _I] + [_P] * 7
    + [_F, _P, _I] + _SCHED + [_P],
    "target_leapfrogs_plan": [_I] * 2 + [ctypes.POINTER(_I)] * 4,
    "target_leapfrogs_dense_plan": [_I] * 2 + [ctypes.POINTER(_I)] * 4,
    "target_multistep": [_P, _P, _I, _I] + [_P] * 5 + [_F, _P, _I, _I, _I,
                                                       ctypes.c_ulonglong]
    + _SCHED + [_P],
    "target_multistep_plan": [_I] * 2 + [ctypes.POINTER(_I)] * 4,
    "target_logp_grad": [_P, _P, _I, _I] + [_P] * 4,
}


def load_library(source, argtypes):
    """Build (first use) and bind ``csrc/<source>.cu``, a custom-target
    library (its entries ``argtypes``: name -> ctypes types, plus the
    helpers of ``target_common.cuh`` and ``target_lane.cuh``); returns the
    library."""
    from .cuda_build import load

    lib = load(source)
    if not getattr(lib, "_bound", False):
        for name, types in argtypes.items():
            fn = getattr(lib, name)
            fn.argtypes = types
            fn.restype = ctypes.c_int
        lib.target_error_string.argtypes = [ctypes.c_int]
        lib.target_error_string.restype = ctypes.c_char_p
        if (lib.target_max_dim() != D_MAX
                or lib.target_lane_max_dim() != LANE_D_MAX
                or lib.target_n_families() != len(FAMILY_CODES)):
            raise RuntimeError(f"csrc/{source}.cu and ops/target_kernels.py "
                               f"disagree on D_MAX, LANE_D_MAX or the "
                               f"family codes")
        lib._bound = True
    return lib


def load_kernels():
    """Build (first use) and bind ``csrc/target_hmc.cu``."""
    return load_library("target_hmc", _ARGTYPES)


def _ptr(t):
    return _P(None if t is None else t.data_ptr())


def _device_branch(name, theta):
    """True for CUDA tensors; False for CPU tensors (plain version)."""
    if theta.device.type == "cuda":
        return True
    if theta.device.type == "cpu":
        return False
    raise ValueError(f"{name}: no kernel for device {theta.device}")


def check_states(name, d, theta, states=()):
    """Validate a run's states: ``theta`` a contiguous float32 (C, d)
    tensor with 1 <= d <= D_MAX, and each ``(label, tensor)`` of ``states``
    the same on theta's device, or of ``shape`` for a ``(label, tensor,
    shape)``.  Returns C."""
    dev = theta.device
    C, dt = theta.shape if theta.ndim == 2 else (0, 0)
    if dt != d or not 1 <= d <= D_MAX:
        raise ValueError(f"{name}: theta is {tuple(theta.shape)}; the target "
                         f"has d = {d} and the kernel takes 1..{D_MAX}")
    for label, t, *shape in (("theta", theta),) + tuple(states):
        want = tuple(shape[0]) if shape else (C, d)
        if t.device != dev or t.dtype != torch.float32 \
                or not t.is_contiguous() or tuple(t.shape) != want:
            raise ValueError(
                f"{name}: {label} must be a contiguous float32 {want} "
                f"tensor on {dev}, got {t.dtype} {tuple(t.shape)} on "
                f"{t.device}")
    return C


def kernel_rows(name, target, device, dense=False):
    """The kernel rows (codes, params) of a catalog target on ``device``;
    raises for a target without them.  A :class:`DenseTarget` gives its base
    target's rows where ``dense`` (the kernels with a z-space pass) and
    raises elsewhere."""
    if isinstance(target, DenseTarget):
        if not dense:
            refuse_dense(name, target)
        target = target.base
    if not isinstance(target, CatalogTarget) or not target.has_rows:
        raise ValueError(
            f"{name}: the CUDA kernel takes a catalog target (coordwise_logp "
            f"of the continuous families with scalar parameters, or a DSL "
            f"model's target_spec); {target!r} has no kernel rows, so it "
            f"runs on the generic torch engine")
    return target.rows(device)


def kernel_args(name, target, theta, states=(), dense=False):
    """Validate what the kernels take: a target with kernel rows at
    1 <= d <= D_MAX (a dense target where ``dense``, :func:`kernel_rows`)
    and contiguous float32 (C, d) ``states`` on theta's device
    (:func:`check_states`).  Returns (codes, params, C, d)."""
    codes, params = kernel_rows(name, target, theta.device, dense)
    C = check_states(name, target.d, theta, states)
    return codes, params, C, target.d


def lane_layout(name, d):
    """The layout the custom-target kernels launch at dimension ``d``,
    decided up front from d alone: ``"lane"`` (one chain per lane, 32
    chains a block) for 1 <= d <= :data:`LANE_D_MAX`, ``"warp"`` (one warp
    per chain, lanes over coordinates) up to :data:`D_MAX`; raises
    outside."""
    if not 1 <= d <= D_MAX:
        raise ValueError(f"{name}: d = {d} outside the kernel's 1..{D_MAX}")
    return "lane" if d <= LANE_D_MAX else "warp"


def target_leapfrogs_layout(d):
    """The layout :func:`fused_target_leapfrogs` launches at dimension
    ``d`` (:func:`lane_layout`)."""
    return lane_layout("target_leapfrogs", d)


def target_multistep_layout(d):
    """The layout :func:`target_multistep` launches at dimension ``d``
    (:func:`lane_layout`)."""
    return lane_layout("target_multistep", d)


def target_logp_grad_layout(d):
    """The layout :func:`target_logp_grad` launches at dimension ``d``
    (:func:`lane_layout`)."""
    return lane_layout("target_logp_grad", d)


def kernel_plan(lib, name, d, C):
    """How a launch of kernel 5, 6 or 7 runs at (d, C) on the card, as its
    plan entry ``name`` reports it: {"layout" (:func:`lane_layout`),
    "blocks", "warps" (a block), "threads", "smem_bytes",
    "blocks_per_sm"}."""
    outs = [ctypes.c_int() for _ in range(4)]
    code = getattr(lib, name)(d, C, *[ctypes.byref(o) for o in outs])
    if code != 0:
        raise RuntimeError(f"{name}({d}, {C}) failed ({code})")
    blocks, per_sm, threads, smem = (o.value for o in outs)
    return {"layout": lane_layout(name, d), "blocks": blocks,
            "warps": threads // 32, "threads": threads, "smem_bytes": smem,
            "blocks_per_sm": per_sm}


def target_leapfrogs_plan(d, C, dense=False):
    """The trajectory kernel's launch at (d, C) (:func:`kernel_plan`), on a
    dense target with ``dense``."""
    return kernel_plan(load_kernels(), "target_leapfrogs_dense_plan" if dense
                       else "target_leapfrogs_plan", d, C)


def target_multistep_plan(d, C):
    """The multistep kernel's launch at (d, C) (:func:`kernel_plan`)."""
    return kernel_plan(load_kernels(), "target_multistep_plan", d, C)


def _failed(lib, name, code):
    return RuntimeError(f"{name} launch failed: "
                        f"{lib.target_error_string(code).decode()} ({code})")


def launch(lib, counts, name, *args):
    """Call entry ``name`` of ``lib`` on the current stream; raise on a
    CUDA error, else add one to ``counts[name]``."""
    code = getattr(lib, name)(*args,
                              _P(torch.cuda.current_stream().cuda_stream))
    if code != 0:
        raise _failed(lib, name, code)
    count(counts, name)


def lean_launch(lib, counts, name, dev):
    """``call(*args)``: entry ``name`` of ``lib`` on the stream current on
    ``dev`` now, for a run of launches on one device (made current for the
    launch when another is); raises on a CUDA error, else adds one to
    ``counts[name]``."""
    fn = getattr(lib, name)
    with torch.cuda.device(dev):
        stream = _P(torch.cuda.current_stream().cuda_stream)

    def call(*args):
        if dev.index == torch.cuda.current_device():
            code = fn(*args, stream)
        else:
            with torch.cuda.device(dev):
                code = fn(*args, stream)
        if code != 0:
            raise _failed(lib, name, code)
        count(counts, name)

    return call


def target_logp_grad(target, theta):
    """(logp (C,), gradient (C, d)) of a catalog target at ``theta`` (C, d),
    one pass of the custom-target kernels' family rules, sanitized as the
    generic engine's model gradient is (``models/model.py``
    ``_sanitize_allg``: a NaN logp is -inf, and the gradient is 0 where
    logp is not finite and where it is not finite itself).  The kernel's
    layout follows from d (:func:`target_logp_grad_layout`)."""
    name = "target_logp_grad"
    if not _device_branch(name, theta):
        return target_logp_grad_ref(target, theta)
    kernel_args(name, target, theta)
    return logp_grad_launcher(target, theta.device)(theta)


def logp_grad_launcher(target, device):
    """The gradient pass for calls on one device (the generic engine's
    model gradient, once per leaf): the target's kernel rows, the library
    and the stream are resolved once, and the returned ``allg(theta) ->
    (logp (C,), gradient (C, d))`` (as :func:`target_logp_grad`) checks only
    what can change between calls: theta must be a contiguous float32
    (C, d) tensor on ``device``.  Each call returns fresh outputs (the
    NUTS tree keeps earlier leaves' gradients).  On the card it launches
    on the stream that was current on ``device`` when the launcher was
    made; on the CPU ``allg`` is the plain version."""
    name = "target_logp_grad"
    device = torch.device(device)
    d = target.d

    def check(theta):
        if (theta.device != device or theta.dtype != torch.float32
                or not theta.is_contiguous() or theta.ndim != 2
                or theta.shape[1] != d):
            raise ValueError(
                f"{name}: theta must be a contiguous float32 (C, d = {d}) "
                f"tensor on {device}, got {theta.dtype} "
                f"{tuple(theta.shape)} on {theta.device}")

    if device.type == "cpu":
        def plain(theta):
            check(theta)
            return target_logp_grad_ref(target, theta)
        return plain
    if device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {device}")
    codes, params = kernel_rows(name, target, device)
    call = lean_launch(load_kernels(), LAUNCHES, name, device)
    head = (_ptr(codes), _ptr(params), d)

    def allg(theta):
        check(theta)
        C = theta.shape[0]
        g = torch.empty_like(theta)
        lp = torch.empty(C, dtype=theta.dtype, device=device)
        call(*head, C, _P(theta.data_ptr()), _P(g.data_ptr()),
             _P(lp.data_ptr()))
        return lp, g

    allg.inputs = (codes, params)  # alive as long as the launcher
    return allg


def leapfrogs_launcher(target, theta, eps, integrator="leapfrog"):
    """The trajectory kernel for a run of launches on states shaped as
    ``theta`` (the drivers' loop): the target, theta, the step and the
    schedule are checked once, and the returned ``step(theta, m, grad,
    n_leaps) -> (theta, m, grad, logp)`` (as :func:`fused_target_leapfrogs`)
    launches on the run's own tensors without checking them again: they
    must be contiguous float32 (C, d) on theta's device.  On the card the
    four outputs are buffers the launcher owns, written anew by each call
    (a driver consumes them before its next call), on the stream current
    when the launcher was made.  On the CPU ``step`` is the plain version.
    A :class:`DenseTarget` (a scalar step) launches the z-space pass,
    counted as ``target_leapfrogs_dense``."""
    name = "target_leapfrogs"
    C, d = check_states(name, target.d, theta), target.d
    step_for(name, target, eps, theta)
    if not _device_branch(name, theta):
        def plain(th, m, grad, n_leaps):
            return fused_target_leapfrogs_ref(target, th, m, grad, eps,
                                              n_leaps=n_leaps,
                                              integrator=integrator)
        return plain
    codes, params = kernel_rows(name, target, theta.device, dense=True)
    eps_s, eps_row = _eps_args(eps, theta)
    outs = (*(torch.empty_like(theta) for _ in range(3)),
            torch.empty(C, dtype=theta.dtype, device=theta.device))
    entry = dense_name(name, target)
    call = lean_launch(load_kernels(), LAUNCHES, entry, theta.device)
    head = (_ptr(codes), _ptr(params), d, C)
    factor = None
    if entry != name:
        factor = target.factor(theta.device)
        head = (_ptr(factor),) + head
    tail = (*(_ptr(o) for o in outs), eps_s, _ptr(eps_row))
    sched = _sched(integrator)

    def step(th, m, grad, n_leaps):
        call(*head, _P(th.data_ptr()), _P(m.data_ptr()), _P(grad.data_ptr()),
             *tail, int(n_leaps), *sched)
        return outs

    # alive as long as the launcher
    step.inputs = (codes, params, eps_row, factor)
    return step


def fused_target_leapfrogs(target, theta, m, grad, eps, *, n_leaps=10,
                           integrator="leapfrog"):
    """``n_leaps`` fused macro steps of ``integrator`` for all chains on a
    catalog target.

    ``theta``, ``m``, ``grad`` (C, d) with ``grad`` the gradient at
    ``theta``; ``eps`` a scalar or a (d,) per-coordinate row (the
    diagonal-metric fold); ``n_leaps`` an int given at run time.  On a
    :class:`DenseTarget` the states are in ``z``, the step a scalar, and lp
    the base target's at ``theta = z L'``.  The kernel's layout follows from
    d (:func:`target_leapfrogs_layout`).
    Returns (theta, m, grad, logp (C,)) at the end of the trajectory."""
    name = "target_leapfrogs"
    if not _device_branch(name, theta):
        return fused_target_leapfrogs_ref(target, theta, m, grad, eps,
                                          n_leaps=n_leaps,
                                          integrator=integrator)
    check_states(name, target.d, theta, (("m", m), ("grad", grad)))
    return leapfrogs_launcher(target, theta, eps, integrator)(
        theta, m, grad, n_leaps)


def target_multistep(target, theta, eps, *, k_trans=10, n_leaps=10,
                     generator=None, integrator="leapfrog", i0=0):
    """``k_trans`` whole HMC transitions per launch on a catalog target,
    the momenta (Box-Muller) and MH uniforms drawn inside the kernel from
    Philox4x32-10 keyed by a seed drawn from ``generator`` and counted by
    (chain, absolute transition ``i0 + t``, coordinate): a generator in the
    same state repeats a launch bitwise.  The kernel's layout follows from
    d (:func:`target_multistep_layout`).
    Returns (theta, grad, lp (C,), accept rate (C,))."""
    name = "target_multistep"
    if not _device_branch(name, theta):
        return target_multistep_ref(target, theta, eps, k_trans=k_trans,
                                    n_leaps=n_leaps, generator=generator,
                                    integrator=integrator)
    kernel_args(name, target, theta)
    return multistep_launcher(target, theta, eps, integrator)(
        theta, k_trans, n_leaps, generator, i0)


def multistep_launcher(target, theta, eps, integrator="leapfrog"):
    """The multistep kernel for a run of launches on states shaped as
    ``theta`` (:func:`run_target_hmc_multistep`'s loop): the target, theta,
    the step and the schedule are checked once, and the returned
    ``step(theta, k_trans, n_leaps, generator, i0) -> (theta, grad, lp,
    accept rate)`` (as :func:`target_multistep`) launches on the run's own
    theta without checking it again: it must be a contiguous float32
    (C, d) tensor on the first theta's device.  Each launch returns fresh
    outputs (the driver stacks them), on the stream current when the
    launcher was made, and copies its seed to the host (the replay of its
    draws depends on it).  On the CPU ``step`` is the plain version."""
    name = "target_multistep"
    C, d = check_states(name, target.d, theta), target.d
    if not _device_branch(name, theta):
        def plain(th, k_trans, n_leaps, generator, i0):
            del i0  # the plain version's own draws have no counters
            return target_multistep_ref(target, th, eps, k_trans=k_trans,
                                        n_leaps=n_leaps, generator=generator,
                                        integrator=integrator)
        return plain
    codes, params = kernel_rows(name, target, theta.device)
    eps_s, eps_row = _eps_args(eps, theta)
    call = lean_launch(load_kernels(), LAUNCHES, name, theta.device)
    head = (_ptr(codes), _ptr(params), d, C)
    sched = _sched(integrator)

    def step(th, k_trans, n_leaps, generator, i0):
        seed = _seed(generator)
        th_o, g_o = torch.empty_like(th), torch.empty_like(th)
        lp_o = torch.empty(C, dtype=th.dtype, device=th.device)
        acc_o = torch.empty(C, dtype=th.dtype, device=th.device)
        call(*head, _P(th.data_ptr()), _P(th_o.data_ptr()),
             _P(g_o.data_ptr()), _P(lp_o.data_ptr()), _P(acc_o.data_ptr()),
             eps_s, _ptr(eps_row), int(n_leaps), int(k_trans), int(i0), seed,
             *sched)
        return th_o, g_o, lp_o, acc_o

    step.inputs = (codes, params, eps_row)  # alive as long as the launcher
    return step


def target_multistep_draws(seed, C, d, k_trans, i0=0, device="cpu"):
    """The momenta (k, C, d) and MH log-uniforms (k, C) that
    :func:`target_multistep` draws under the launch seed ``seed``, replayed
    by :mod:`.philox` as ``noise`` for :func:`target_multistep_ref`."""
    c = np.arange(C, dtype=np.uint32)[None, :, None]
    t = np.arange(i0, i0 + k_trans, dtype=np.uint32)[:, None, None]
    j = np.arange(d, dtype=np.uint32)
    b = philox.philox4x32((c, t, j, 0), seed)
    bu = philox.philox4x32((c[..., 0], t[..., 0], 0, 1), seed)
    return (torch.from_numpy(philox.box_muller(b[0], b[1])).to(device),
            torch.from_numpy(philox.log1m_u01(bu[0])).to(device))


# ---- drivers ---------------------------------------------------------------


def _run(target, theta0, eps, generator, *, steps, n_leaps,
         integrator="leapfrog", collect=False):
    """Run ``steps`` fused-HMC transitions on a target: the trajectory in
    the kernel (one :func:`leapfrogs_launcher` for the run), momentum
    refresh and the NaN-rejecting accept here (pallas_target.py ``_run``).
    Records ``plogtarget``/``accept`` per step (+ post-accept
    ``ppars``/``pgrads`` with ``collect``).
    Returns ((theta, lp, grad), infos stacked over steps)."""
    theta = theta0
    lp, g = target_funcs(target)[1](theta0)
    g = g.contiguous()
    trajectory = leapfrogs_launcher(target, theta0, eps, integrator)
    rows = {"plogtarget": [], "accept": []}
    if collect:
        rows.update(ppars=[], pgrads=[])
    for _ in range(steps):
        m0, logu = _draw(theta, generator)
        p_th, p_m, p_g, p_lp = trajectory(theta, m0, g, n_leaps)
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


def _prepare(d, n_chains, seed, generator, inits, device):
    """float32 initial states on ``device`` and the run's generator."""
    from ..models.model import resolve_device
    from ..samplers.base import make_generator

    dev = resolve_device(device)
    gen = generator if generator is not None else make_generator(dev, seed)
    if inits is None:
        inits = 0.1 * torch.randn((n_chains, d), generator=gen,
                                  dtype=torch.float32, device=dev)
    theta0 = torch.as_tensor(inits, dtype=torch.float32, device=dev)
    return theta0.expand(n_chains, d).contiguous(), gen


def run_target_hmc(target, d, n_chains, steps, n_leaps=10, eps=0.1, seed=0,
                   generator=None, inits=None, device=None,
                   integrator="leapfrog", collect=False):
    """Sample a catalog target with the fused trajectory kernel
    (pallas_target.py ``run_target_hmc``).  ``eps`` is a scalar or a (d,)
    row.  Returns (theta (C, d), infos {plogtarget, accept} (+ ppars,
    pgrads with ``collect``) stacked over steps)."""
    theta0, gen = _prepare(d, n_chains, seed, generator, inits, device)
    (theta, _, _), infos = _run(target, theta0, eps, gen, steps=steps,
                                n_leaps=n_leaps, integrator=integrator,
                                collect=collect)
    return theta, infos


def run_target_hmc_multistep(target, d, n_chains, steps, thin=10,
                             n_leaps=10, eps=0.1, seed=0, generator=None,
                             inits=None, device=None, integrator="leapfrog",
                             collect=False):
    """Sample a catalog target with the multi-transition kernel (one
    :func:`multistep_launcher` for the run): ``steps`` transitions as
    ``steps // thin`` launches of ``thin``; infos carry one
    row per launch (thinned chain): ``plogtarget``/``accept_rate``
    (+ ``ppars``/``pgrads`` with ``collect``)."""
    if steps % thin != 0:
        raise ValueError("steps must be divisible by thin")
    theta, gen = _prepare(d, n_chains, seed, generator, inits, device)
    step = multistep_launcher(target, theta, eps, integrator)
    rows = {"plogtarget": [], "accept_rate": []}
    if collect:
        rows.update(ppars=[], pgrads=[])
    for i in range(steps // thin):
        theta, g, lp, acc = step(theta, thin, n_leaps, gen, i * thin)
        rows["plogtarget"].append(lp)
        rows["accept_rate"].append(acc)
        if collect:
            rows["ppars"].append(theta)
            rows["pgrads"].append(g)
    return theta, {k: torch.stack(v) for k, v in rows.items()}


def run_target_hmc_sharded(target, d, n_chains, steps, mesh=None,
                           axis="chains", n_leaps=10, eps=0.1, seed=0,
                           generator=None, inits=None, integrator="leapfrog"):
    """Mesh-sharded fused custom-target HMC: chains split over
    ``mesh[axis]`` (pallas_target.py ``run_target_hmc_sharded``), as
    :func:`~.glm_hmc.run_glm_hmc_sharded` does on a GLM: shard ``i`` runs
    the trajectory kernel on its chains on its entry's device from its own
    generator (:func:`~..parallel.mesh.shard_seed` of ``seed`` and ``i``;
    seeds drawn from ``generator`` when one is given), and nothing joins
    the shards until the results are.  ``inits`` default to ``0.1``
    standard normals drawn first from ``generator`` (or one seeded with
    ``seed`` on the first shard's device).  Returns the
    :func:`run_target_hmc` surface, joined on the first shard's device."""
    from ..parallel.mesh import (default_mesh, local_groups,
                                 map_chain_shards, split_sizes)

    mesh = default_mesh(axis) if mesh is None else mesh
    split_sizes(n_chains, mesh.shape[axis], axis=axis)
    dev0 = local_groups(mesh, axis)[0][1]
    theta0, _ = _prepare(d, n_chains, seed, generator, inits, dev0)

    def one(i, dev, th0, gen):
        step = eps.to(dev) if isinstance(eps, torch.Tensor) else eps
        (theta, _, _), infos = _run(target, th0.contiguous(), step, gen,
                                    steps=steps, n_leaps=n_leaps,
                                    integrator=integrator)
        return theta, infos

    return map_chain_shards(one, theta0, mesh, dev0, axis=axis, seed=seed,
                            generator=generator, dim=(0, 1))


def fused_target_chains(model, sampler, runner, n_chains, generator):
    """Run ``n_chains`` plain-HMC chains on a model with a ``target_spec``
    through the fused trajectory kernel, returning ``(infos,
    final_states)`` in the protocol of
    :func:`mcmc_jl_tpu_torch.parallel.pchains.run_chains` (float32
    compute, post-accept keys, exact-resume final states)."""
    from .glm_hmc import final_hmc_states

    target = model.target_spec
    if target is None:
        raise ValueError("fused_target_chains requires a model with a "
                         "target_spec (a product of catalog densities)")
    theta0 = model.init.to(torch.float32).expand(n_chains, -1).contiguous()
    (thetaF, lpF, gF), infos = _run(
        target, theta0, sampler.leap_step, generator, steps=runner.len,
        n_leaps=sampler.n_leaps, integrator=sampler.integrator, collect=True)
    states = final_hmc_states(model, sampler, n_chains, runner.len, thetaF,
                              lpF, gF)
    return infos, states


def fused_mala_target_chains(model, sampler, runner, n_chains, generator):
    """Plain MALA on a catalog target through the trajectory kernel: MALA
    with drift step ``s`` is one-leapfrog HMC at ``eps = sqrt(s)``
    (pallas_target.py ``fused_mala_target_chains``; MALA.jl:65-126).
    Returns ``(infos, final_states)`` with exact-resume MALAStates."""
    from ..samplers.base import tuner_init
    from ..samplers.hmc import HMC
    from ..samplers.mala import MALAState

    infos, hst = fused_target_chains(model, HMC(1, math.sqrt(sampler.scale)),
                                     runner, n_chains, generator)
    tune = tuner_init(sampler.scale, shape=(n_chains,), dtype=model.dtype,
                      device=model.device)
    return infos, MALAState(pars=hst.pars, logtarget=hst.logtarget,
                            grad=hst.grad, tune=tune, i=hst.i)
