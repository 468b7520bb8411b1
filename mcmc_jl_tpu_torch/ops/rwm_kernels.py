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

The kernel has two layouts, decided up front from d
(:func:`target_rwm_layout`): one chain per lane up to
``target_kernels.LANE_D_MAX``, one warp per chain above.  The driver takes
it through :func:`rwm_launcher`, which validates a run once.

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

import torch

from . import philox
from .target_kernels import (_P, _device_branch, _prepare, _ptr, _seed,
                             check_states, kernel_plan, kernel_rows,
                             lane_layout, lean_launch, load_library,
                             refuse_dense)

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
    refuse_dense("target_rwm_steps", target)
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


_I = ctypes.c_int


def load_kernels():
    """Build (first use) and bind ``csrc/target_rwm.cu``."""
    return load_library("target_rwm", {
        "target_rwm_steps": [_P, _P, _I, _I] + [_P] * 7
        + [_I, _I, ctypes.c_ulonglong, _I, _P],
        "target_rwm_plan": [_I] * 2 + [ctypes.POINTER(_I)] * 4})


def target_rwm_layout(d):
    """The layout :func:`fused_target_rwm_steps` launches at dimension
    ``d``, decided up front from d alone
    (:func:`~.target_kernels.lane_layout`)."""
    return lane_layout("target_rwm_steps", d)


def target_rwm_plan(d, C):
    """The RWM kernel's launch at (d, C)
    (:func:`~.target_kernels.kernel_plan`)."""
    return kernel_plan(load_kernels(), "target_rwm_plan", d, C)


def rwm_launcher(target, theta, scale_row, *, k_steps, noise="hw"):
    """The RWM kernel for a run of launches on states shaped as ``theta``
    (the driver's loop): the target, theta and the scale are checked once,
    and the returned ``step(theta, i0=0, generator=None, z=None,
    logu=None) -> (theta, logp (C,), accept rate (C,))`` (as
    :func:`fused_target_rwm_steps`) launches on the run's own tensors
    without checking them again, on the stream current when the launcher
    was made.  On the CPU ``step`` is the plain version."""
    name = "target_rwm_steps"
    if noise not in ("input", "hw"):
        raise ValueError(f"{name}: noise must be 'input' or 'hw', got "
                         f"{noise!r}")
    d, scale = target.d, scale_row.reshape(-1)
    C = check_states(name, d, theta)
    hw = noise == "hw"
    if not _device_branch(name, theta):
        def plain(th, i0=0, generator=None, z=None, logu=None):
            del i0
            if hw:
                z = logu = None
            return fused_target_rwm_steps_ref(target, th, scale_row,
                                              k_steps=k_steps, z=z, logu=logu,
                                              generator=generator)
        return plain
    codes, params = kernel_rows(name, target, theta.device)
    check_states(name, d, theta, (("scale_row", scale, (d,)),))
    call = lean_launch(load_kernels(), LAUNCHES, name, theta.device)
    head = (_ptr(codes), _ptr(params), d, C)
    fill = dict(dtype=theta.dtype, device=theta.device)

    def step(th, i0=0, generator=None, z=None, logu=None):
        th_o = torch.empty_like(th)
        lp_o, acc_o = torch.empty(C, **fill), torch.empty(C, **fill)
        call(*head, _P(th.data_ptr()), _P(scale.data_ptr()),
             _ptr(None if hw else z), _ptr(None if hw else logu),
             _P(th_o.data_ptr()), _P(lp_o.data_ptr()), _P(acc_o.data_ptr()),
             int(k_steps), int(i0), _seed(generator) if hw else 0, int(hw))
        return th_o, lp_o, acc_o

    step.inputs = (codes, params, scale)  # alive as long as the launcher
    return step


def fused_target_rwm_steps(target, theta, scale_row, *, k_steps, z=None,
                           logu=None, generator=None, noise="hw", i0=0):
    """Run ``k_steps`` fused RWM transitions for all chains.

    ``theta`` (C, d); ``scale_row`` the (d,) proposal scale.  ``noise``:
    "input" reads ``z`` (C, k, d) and ``logu`` (C, k); "hw" draws inside
    the kernel from Philox keyed by a seed drawn from ``generator`` and
    counted by (chain, absolute step ``i0 + s``, coordinate).
    The kernel's layout follows from d (:func:`target_rwm_layout`).
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
    step = rwm_launcher(target, theta, scale_row, k_steps=k_steps,
                        noise=noise)
    if noise == "input":
        C, d = theta.shape
        check_states(name, d, theta, (("z", z, (C, k_steps, d)),
                                      ("logu", logu, (C, k_steps))))
    return step(theta, i0=i0, generator=generator, z=z, logu=logu)


def rwm_draws(seed, C, d, k_steps, i0=0, device="cpu"):
    """The normals ``z`` (C, k, d) and log-uniforms ``logu`` (C, k) that
    :func:`fused_target_rwm_steps` draws with ``noise="hw"`` under the
    launch seed ``seed``, replayed by :mod:`.philox` for its plain
    version.  Absolute step t of coordinate j takes its normal from
    counter (chain, t // 4, j, 2): words 0 and 1 for t % 4 in {0, 1},
    words 2 and 3 for {2, 3}, the cosine branch at even t and the sine
    branch at odd t; its log-uniform from word t % 4 of counter (chain,
    t // 4, 0, 3)."""
    def ar(lo, hi):
        return torch.arange(lo, hi, dtype=torch.int64, device=device)

    c, t = ar(0, C)[:, None, None], ar(i0, i0 + k_steps)[None, :, None]
    b = philox.philox4x32((c, t >> 2, ar(0, d), 2), seed)
    hi = (t & 2) != 0
    cos, sin = philox.box_muller_pair(torch.where(hi, b[2], b[0]),
                                      torch.where(hi, b[3], b[1]))
    z = torch.where((t & 1) != 0, sin, cos)
    tu = t[..., 0]
    bu = torch.stack(philox.philox4x32((c[..., 0], tu >> 2, 0, 3), seed))
    u = bu.gather(0, (tu & 3).expand(bu.shape[1:])[None])[0]
    return z.contiguous(), philox.log1m_u01(u)


def _run(target, theta0, scale_row, generator, *, n_launches, k_steps,
         noise):
    """``n_launches`` launches of ``k_steps`` transitions through one
    :func:`rwm_launcher`; one thinned row per launch (pallas_rwm.py
    ``_run``).  Returns (theta, infos)."""
    theta = theta0
    step = rwm_launcher(target, theta0, scale_row, k_steps=k_steps,
                        noise=noise)
    rows = {"ppars": [], "plogtarget": [], "accept_rate": []}
    for i in range(n_launches):
        z = logu = None
        if noise == "input":
            z, logu = _noise((theta.shape[0], k_steps, theta.shape[1]),
                             generator, theta.dtype, theta.device)
        theta, lp, acc = step(theta, i0=i * k_steps, generator=generator,
                              z=z, logu=logu)
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
