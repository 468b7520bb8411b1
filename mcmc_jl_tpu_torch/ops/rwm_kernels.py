"""Fused multi-step random-walk Metropolis on catalog targets: the port of
``mcmc_jl_tpu/ops/pallas_rwm.py``.

One kernel, ``csrc/target_rwm.cu``, replaces the Pallas kernel body
``pallas_rwm.py _rwm_kernel``: :func:`fused_target_rwm_steps` runs
``k_steps`` RWM transitions per launch with a per-coordinate proposal
scale, positions and log-targets in registers.  ``noise="input"`` takes
pre-drawn normals ``z`` (C, k, d) and log-uniforms ``logu`` (C, k) — the
JAX kernel takes them in its lane layout, (C, k * d_pad) and (C, k * 128);
``noise="hw"`` draws them inside the kernel from Philox.  Both modes give
the same chain law.

The plain version :func:`fused_target_rwm_steps_ref` evaluates the
distributions' ``logpdf``; on the CPU the wrapper runs it (with
``noise="hw"`` it draws from ``generator`` instead), on a CUDA tensor the
wrapper launches the kernel or raises.  Targets follow
:mod:`.target_kernels` (a
:class:`~mcmc_jl_tpu_torch.models.distributions.CatalogTarget` with kernel
rows for the kernel).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import philox
from .target_kernels import (_device_branch, _prepare, _ptr, _seed,
                             kernel_args, launch, load_library)

LAUNCHES = {"target_rwm_steps": 0}
PLAIN_CALLS = {"target_rwm_steps": 0}


def reset_counts():
    """Zero the launch and plain-call counters."""
    for counts in (LAUNCHES, PLAIN_CALLS):
        for k in counts:
            counts[k] = 0


def _noise(shape, generator, dtype, device):
    """One launch's normals (C, k, d) and log(1 - u) (C, k)."""
    C, k, d = shape
    z = torch.randn((C, k, d), generator=generator, dtype=dtype, device=device)
    logu = torch.log1p(-torch.rand((C, k), generator=generator, dtype=dtype,
                                   device=device))
    return z, logu


def fused_target_rwm_steps_ref(target, theta, scale_row, *, k_steps, z=None,
                               logu=None, generator=None):
    """Plain version of :func:`fused_target_rwm_steps`: the noise is ``z``
    and ``logu`` when given, else drawn from ``generator``.
    Returns (theta, logp (C,), accept rate (C,))."""
    PLAIN_CALLS["target_rwm_steps"] += 1
    if z is None:
        z, logu = _noise(theta.shape[:1] + (k_steps,) + theta.shape[1:],
                         generator, theta.dtype, theta.device)
    scale = scale_row.reshape(-1)
    lp = target(theta)[:, 0]
    n_acc = torch.zeros_like(lp)
    for k in range(k_steps):
        prop = theta + scale * z[:, k]
        lp_p = target(prop)[:, 0]
        ratio = lp_p - lp
        # NaN (e.g. -inf minus -inf) rejects: the reference's accept rule
        ratio = torch.where(torch.isnan(ratio), -torch.inf, ratio)
        a = (ratio > 0) | (ratio > logu[:, k])
        theta = torch.where(a[:, None], prop, theta)
        lp = torch.where(a, lp_p, lp)
        n_acc = n_acc + a.to(n_acc.dtype)
    return theta, lp, n_acc / k_steps


_P = ctypes.c_void_p
_I = ctypes.c_int


def load_kernels():
    """Build (first use) and bind ``csrc/target_rwm.cu``."""
    return load_library("target_rwm", {"target_rwm_steps": (
        [_P, _P, _I, _I] + [_P] * 7 + [_I, _I, ctypes.c_ulonglong, _I, _P])})


def fused_target_rwm_steps(target, theta, scale_row, *, k_steps, z=None,
                           logu=None, generator=None, noise="hw", i0=0):
    """Run ``k_steps`` fused RWM transitions for all chains.

    ``theta`` (C, d); ``scale_row`` the (d,) proposal scale.  ``noise``:
    "input" reads ``z`` (C, k, d) and ``logu`` (C, k); "hw" draws inside
    the kernel from Philox keyed by a seed drawn from ``generator`` and
    counted by (chain, absolute step ``i0 + s``, coordinate).
    Returns (theta, logp (C,), accept rate (C,))."""
    name = "target_rwm_steps"
    if noise not in ("input", "hw"):
        raise ValueError(f"{name}: noise must be 'input' or 'hw', got "
                         f"{noise!r}")
    if noise == "input" and (z is None or logu is None):
        raise ValueError(f"{name}: noise='input' needs z and logu")
    if not _device_branch(name, theta):
        if noise == "hw":
            z = logu = None
        return fused_target_rwm_steps_ref(target, theta, scale_row,
                                          k_steps=k_steps, z=z, logu=logu,
                                          generator=generator)
    codes, params, C, d = kernel_args(name, target, theta)
    scale = scale_row.reshape(-1)
    checks = [("scale_row", scale, (d,))]
    if noise == "input":
        checks += [("z", z, (C, k_steps, d)), ("logu", logu, (C, k_steps))]
    for label, t, shape in checks:
        if t.device != theta.device or t.dtype != torch.float32 \
                or not t.is_contiguous() or tuple(t.shape) != shape:
            raise ValueError(f"{name}: {label} must be a contiguous float32 "
                             f"{shape} tensor on {theta.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    seed = _seed(generator) if noise == "hw" else 0
    th_o = torch.empty_like(theta)
    lp_o = torch.empty(C, dtype=theta.dtype, device=theta.device)
    acc_o = torch.empty(C, dtype=theta.dtype, device=theta.device)
    with torch.cuda.device(theta.device):
        launch(load_kernels(), LAUNCHES, name, _ptr(codes), _ptr(params), d,
               C, _ptr(theta), _ptr(scale),
               _ptr(z if noise == "input" else None),
               _ptr(logu if noise == "input" else None), _ptr(th_o),
               _ptr(lp_o), _ptr(acc_o), int(k_steps), int(i0), seed,
               int(noise == "hw"))
    return th_o, lp_o, acc_o


def rwm_draws(seed, C, d, k_steps, i0=0, device="cpu"):
    """The normals ``z`` (C, k, d) and log-uniforms ``logu`` (C, k) that
    :func:`fused_target_rwm_steps` draws with ``noise="hw"`` under the
    launch seed ``seed``, replayed by :mod:`.philox` for its plain
    version."""
    c = np.arange(C, dtype=np.uint32)[:, None, None]
    s = np.arange(i0, i0 + k_steps, dtype=np.uint32)[None, :, None]
    j = np.arange(d, dtype=np.uint32)
    b = philox.philox4x32((c, s, j, 2), seed)
    bu = philox.philox4x32((c[..., 0], s[..., 0], 0, 3), seed)
    return (torch.from_numpy(philox.box_muller(b[0], b[1])).to(device),
            torch.from_numpy(philox.log1m_u01(bu[0])).to(device))


def _run(target, theta0, scale_row, generator, *, n_launches, k_steps,
         noise):
    """``n_launches`` launches of ``k_steps`` transitions; one thinned row
    per launch (pallas_rwm.py ``_run``).  Returns (theta, infos)."""
    theta = theta0
    rows = {"ppars": [], "plogtarget": [], "accept_rate": []}
    for i in range(n_launches):
        z = logu = None
        if noise == "input":
            z, logu = _noise((theta.shape[0], k_steps, theta.shape[1]),
                             generator, theta.dtype, theta.device)
        theta, lp, acc = fused_target_rwm_steps(
            target, theta, scale_row, k_steps=k_steps, z=z, logu=logu,
            generator=generator, noise=noise, i0=i * k_steps)
        rows["ppars"].append(theta)
        rows["plogtarget"].append(lp)
        rows["accept_rate"].append(acc)
    return theta, {k: torch.stack(v) for k, v in rows.items()}


def run_target_rwm(target, d, n_chains, steps, scale=0.1, thin=10, seed=0,
                   generator=None, inits=None, device=None, noise=None):
    """Sample a catalog target with the fused RWM kernel
    (pallas_rwm.py ``run_target_rwm``): ``steps`` transitions as
    ``steps // thin`` launches of ``thin``; infos carry one thinned row
    per launch (``ppars``/``plogtarget``/``accept_rate``).  ``scale`` is a
    scalar or a (d,) row.  ``noise`` defaults to "hw" on the card and
    "input" on the CPU."""
    if steps % thin != 0:
        raise ValueError("steps must be divisible by thin")
    theta0, gen = _prepare(d, n_chains, seed, generator, inits, device)
    if noise is None:
        noise = "hw" if theta0.device.type == "cuda" else "input"
    scale_row = torch.broadcast_to(torch.as_tensor(
        scale, dtype=torch.float32, device=theta0.device), (d,)).contiguous()
    return _run(target, theta0, scale_row, gen, n_launches=steps // thin,
                k_steps=thin, noise=noise)
