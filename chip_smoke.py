"""GPU smoke run of the PyTorch/CUDA port (``mcmc_jl_tpu_torch``).

Builds the CUDA kernels from the sources in this checkout (one ``nvcc`` per
source, started together), holds each kernel against its plain PyTorch
version on the card, drives the main paths on Bayesian logistic regression
(d = 10, N = 1000) across 4096 chains through ``run(..., chains=N)`` —
``HMC(10, 0.05)`` under ``SerialMC``, checked against the generic engine,
and exact ``NUTS(maxdoublings=6)`` (warmup on the generic engine, sampling
through the NUTS kernels), checked against the HMC path — runs the HMC step
and multi-transition kernels through their drivers, times the drivers, and
prints one JSON line per phase.  The last three lines are the kernels'
report (with each kernel's launches counted from zero over the one run that
reaches it), the card's name and power limit, and
``{"ok": true, "device": {...}}``.

Run with no arguments on a machine with one CUDA card::

    python3 chip_smoke.py

It exits non-zero without a CUDA device, and on any failed check.
"""
import contextlib
import json
import re
import subprocess
import sys
import time

import numpy as np

SOURCES = {"glm_hmc": "mcmc_jl_tpu_torch/csrc/glm_hmc.cu",
           "glm_nuts": "mcmc_jl_tpu_torch/csrc/glm_nuts.cu"}
# kernel -> (library, the Pallas kernel it replaces)
REPLACES = {
    "glm_leapfrogs": ("glm_hmc", "mcmc_jl_tpu/ops/pallas_glm.py:244"),
    "glm_step": ("glm_hmc", "mcmc_jl_tpu/ops/pallas_glm.py:282"),
    "glm_multistep": ("glm_hmc", "mcmc_jl_tpu/ops/pallas_glm.py:344"),
    "glm_nuts_transition": ("glm_nuts", "mcmc_jl_tpu/ops/pallas_nuts.py:76"),
    "glm_nuts_multistep": ("glm_nuts", "mcmc_jl_tpu/ops/pallas_nuts.py:821"),
}
# kernel vs plain version on the same inputs: both are float32 with sums in
# another order (sequential per chain in the kernel, blocked matmuls in the
# plain version), so differences are a few float32 ulps of each value,
# grown a little over a 10-step trajectory
RTOL, ATOL = 1e-4, 1e-4
LP_RTOL, LP_ATOL = 1e-5, 1e-3
# a gradient component is a sum of N = 1000 terms r_n x_n that largely
# cancel: its rounding error scales with N ulps of the terms, not with the
# (possibly near-zero) result
G_ATOL = 2e-3
# accept decisions may differ only where the MH ratio is this close to logu
ACC_BAND = 1e-4
# step size of the transition check: at the main path's 0.05 nearly every
# proposal is accepted, and the check needs both outcomes
STEP_EPS = 0.12
# statistical agreement, in Monte Carlo standard errors
Z_MAX = 5.0
# NUTS kernel vs plain version on the same pre-drawn noise: a slice, u-turn
# or reservoir decision within float32 rounding of a tie may go the other
# way (the kernel sums lp in double and the dot products in another order),
# so at least this share of chains must take the same discrete path: equal
# ndoublings and diverging, and the same chosen leaf (theta within
# LEAF_ATOL; neighbouring leaves lie eps |m| ~ 1e-2 or more apart)
PATH_AGREE = 0.995
LEAF_ATOL = 1e-3
# multistep NUTS kernel check: mean tree depth of the kernel and of its plain
# version (or the per-transition driver) within this fraction of each other
DEPTH_RTOL = 0.05

CARD = {}


def emit(obj):
    print(json.dumps(obj), flush=True)


def bench_data(n=1000, nbeta=10):
    """bench.py ``_data``: the main path's logistic-regression data, seed 1."""
    rng = np.random.default_rng(1)
    Xh = np.column_stack([np.ones(n), rng.standard_normal((n, nbeta - 1))])
    beta0 = rng.standard_normal(nbeta)
    Yh = (rng.random(n) < 1.0 / (1.0 + np.exp(-Xh @ beta0))).astype(np.float64)
    return Xh, Yh


def phase_device():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this script needs one card", file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    line = smi.stdout.strip().splitlines()[0]
    print(line, flush=True)
    CARD.update(card=line, kind=torch.cuda.get_device_name(0),
                count=torch.cuda.device_count())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "device", "card": line, "torch": torch.__version__,
          "cuda": torch.version.cuda, "count": CARD["count"]})


def phase_build():
    """Both libraries, one nvcc each, started together."""
    from concurrent.futures import ThreadPoolExecutor

    from mcmc_jl_tpu_torch.ops import cuda_build, glm_kernels, nuts_kernels

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        built = dict(zip(SOURCES, pool.map(cuda_build.build, SOURCES)))
    glm_kernels.load_kernels()
    nuts_kernels.load_kernels()
    for name, (path, report) in built.items():
        ptxas, entry = [], "?"
        for ln in report.splitlines():
            # mangled '...<len><name>ILi<D>E...' -> name<D>
            hit = re.search(r"Compiling entry function .*?\d+((?:[a-z]+_)+"
                            r"kernel)ILi(\d+)E", ln)
            if hit:
                entry = f"{hit.group(1)}<{hit.group(2)}>"
            elif "registers" in ln or "spill" in ln:
                ptxas.append(f"{entry}: {ln.strip()}")
        emit({"phase": "build", "source": SOURCES[name],
              "seconds": time.perf_counter() - t0,
              "library": str(path.relative_to(
                  cuda_build.BUILD_ROOT.parent.parent)), "ptxas": ptxas})
        for ln in ptxas:
            if "spill" in ln:
                print(f"ptxas {name} {ln}", flush=True)


def _err(a, b):
    d = (a - b).abs()
    return {"max_abs": float(d.max()),
            "max_rel": float((d / b.abs().clamp_min(1e-6)).max())}


def _close(a, b, rtol, atol):
    return bool(((a - b).abs() <= atol + rtol * b.abs()).all())


def _inputs(C, seed):
    import torch

    from mcmc_jl_tpu_torch.ops.glm_kernels import glm_funcs

    X, Y = bench_data()
    rng = np.random.default_rng(seed)
    d = X.shape[1]
    cuda = lambda a: torch.as_tensor(a, dtype=torch.float32,  # noqa: E731
                                     device="cuda").contiguous()
    XT, Yc = cuda(X.T), cuda(Y)
    theta = cuda(0.1 * rng.standard_normal((C, d)))
    m0 = cuda(rng.standard_normal((C, d)))
    logu = cuda(np.log(rng.random(C)))
    lp, g = glm_funcs(XT, Yc, None, None, 1.0, "logistic")[1](theta)
    return XT, Yc, theta, m0, logu, lp.contiguous(), g.contiguous()


def _other_inputs(kind, N=5000, d=7, C=300, seed=6):
    """A weighted, offset GLM of each link at N = 5000 (past the kernel's
    shared-memory budget) with C = 300 chains (a ragged last block)."""
    import torch

    from mcmc_jl_tpu_torch.ops.glm_kernels import glm_funcs

    rng = np.random.default_rng(seed)
    X = np.column_stack([np.ones(N), rng.standard_normal((N, d - 1))]) * 0.3
    z = X @ rng.standard_normal(d)
    Y = {"linear": z + rng.standard_normal(N),
         "poisson": rng.poisson(np.exp(z)).astype(float)}.get(
        kind, (rng.random(N) < 1 / (1 + np.exp(-z))).astype(float))
    cuda = lambda a: torch.as_tensor(a, dtype=torch.float32,  # noqa: E731
                                     device="cuda").contiguous()
    W, O = cuda(rng.uniform(0.5, 2.0, N)), cuda(0.1 * rng.standard_normal(N))
    XT, Yc = cuda(X.T), cuda(Y)
    theta = cuda(0.05 * rng.standard_normal((C, d)))
    m0 = cuda(rng.standard_normal((C, d)))
    _, g = glm_funcs(XT, Yc, W, O, 1.5, kind)[1](theta)
    kw = dict(n_leaps=3, kind=kind, weights=W, offsets=O, prior_prec=1.5,
              integrator="2stage")
    return {"args": (XT, Yc, theta, m0, g.contiguous(), 0.01), "kw": kw,
            "N": N, "C": C, "d": d}


def phase_kernels(C=4096, eps=0.05, n_leaps=10):
    """Each kernel against its plain version on the card."""
    import torch

    from mcmc_jl_tpu_torch.ops import glm_kernels as gk

    XT, Y, theta, m0, logu, lp, g = _inputs(C, seed=2)
    errors = {}

    # 1: trajectory, same inputs
    out_k = gk.glm_leapfrogs(XT, Y, theta, m0, g, eps, n_leaps=n_leaps)
    out_r = gk.glm_leapfrogs_ref(XT, Y, theta, m0, g, eps, n_leaps=n_leaps)
    torch.cuda.synchronize()
    rep = {n: _err(a, b) for n, a, b in zip(("theta", "m", "g", "lp"),
                                            out_k, out_r)}
    ok = (all(_close(a, b, RTOL, ATOL) for a, b in zip(out_k[:2], out_r[:2]))
          and _close(out_k[2], out_r[2], RTOL, G_ATOL)
          and _close(out_k[3], out_r[3], LP_RTOL, LP_ATOL))
    emit({"phase": "kernel", "name": "glm_leapfrogs", "C": C, "ok": ok, **rep})
    assert ok, "glm_leapfrogs disagrees with glm_leapfrogs_ref"
    errors["glm_leapfrogs"] = max(r["max_abs"] for r in rep.values())

    # 1, other paths: every link with weights and offsets, N past the
    # shared-memory budget (rows streamed tile by tile), a ragged last block
    # of chains, another parameter bound and integrator
    for kind in gk.KIND_CODES:
        oth = _other_inputs(kind)
        o_k = gk.glm_leapfrogs(*oth["args"], **oth["kw"])
        o_r = gk.glm_leapfrogs_ref(*oth["args"], **oth["kw"])
        torch.cuda.synchronize()
        scale = oth["N"] / 1000  # sums of N terms: tolerances grow with N
        ok = (all(_close(a, b, RTOL, ATOL) for a, b in zip(o_k[:2], o_r[:2]))
              and _close(o_k[2], o_r[2], RTOL, G_ATOL * scale)
              and _close(o_k[3], o_r[3], LP_RTOL, LP_ATOL * scale))
        emit({"phase": "kernel", "name": "glm_leapfrogs", "link": kind,
              "N": oth["N"], "C": oth["C"], "d": oth["d"], "ok": ok,
              **{n: _err(a, b) for n, a, b in zip(("theta", "m", "g", "lp"),
                                                  o_k, o_r)}})
        assert ok, f"glm_leapfrogs ({kind}, N={oth['N']}) disagrees"

    # 2: whole transition, same m0 and logu, at a step size large enough
    # (STEP_EPS) that both accepts and rejects occur
    _, m_r, _, lp_r = gk.glm_leapfrogs_ref(XT, Y, theta, m0, g, STEP_EPS,
                                           n_leaps=n_leaps)
    ratio = (-lp + 0.5 * (m0 * m0).sum(-1)) - (-lp_r + 0.5 * (m_r * m_r).sum(-1))
    sk = gk.glm_step(XT, Y, theta, g, lp[:, None], m0, logu[:, None],
                     STEP_EPS, n_leaps=n_leaps)
    sr = gk.glm_step_ref(XT, Y, theta, g, lp[:, None], m0, logu[:, None],
                         STEP_EPS, n_leaps=n_leaps)
    torch.cuda.synchronize()
    ak, ar = sk[3][:, 0] > 0.5, sr[3][:, 0] > 0.5
    differ = ak != ar
    near = (ratio - logu).abs() < ACC_BAND
    same = ~differ
    rep = {n: _err(a[same], b[same]) for n, a, b in
           zip(("theta", "g", "lp"), sk[:3], sr[:3])}
    ok = (bool((~differ | near).all())
          and _close(sk[0][same], sr[0][same], RTOL, ATOL)
          and _close(sk[1][same], sr[1][same], RTOL, G_ATOL)
          and _close(sk[2][same], sr[2][same], LP_RTOL, LP_ATOL)
          and 0 < int(ar.sum()) < C)
    emit({"phase": "kernel", "name": "glm_step", "C": C, "ok": ok,
          "accept_agree": int(same.sum()), "accept_differ": int(differ.sum()),
          "accept_rate": float(ar.float().mean()), **rep})
    assert ok, "glm_step disagrees with glm_step_ref"
    errors["glm_step"] = max(r["max_abs"] for r in rep.values())

    # 3: k transitions, in-kernel Philox vs torch.Generator streams:
    # statistical agreement, and bitwise repeat for one seed
    k = 200
    gen = torch.Generator(device="cuda").manual_seed(3)
    res_k, res_k2 = (gk.glm_multistep(
        XT, Y, theta, eps, k_trans=k, n_leaps=n_leaps,
        generator=torch.Generator(device="cuda").manual_seed(12345))
        for _ in range(2))
    res_r = gk.glm_multistep_ref(XT, Y, theta, eps, k_trans=k,
                                 n_leaps=n_leaps, generator=gen)
    torch.cuda.synchronize()
    bitwise = all(torch.equal(a, b) for a, b in zip(res_k, res_k2))

    def z(a, b):  # per-chain samples a, b -> |mean difference| / se
        se = torch.sqrt(a.var(0) / a.shape[0] + b.var(0) / b.shape[0])
        return ((a.mean(0) - b.mean(0)).abs() / se).max().item()

    z_acc = z(res_k[3], res_r[3])
    z_theta = z(res_k[0], res_r[0])
    ok = (bitwise and z_acc < Z_MAX and z_theta < Z_MAX
          and bool(torch.isfinite(res_k[2]).all()))
    emit({"phase": "kernel", "name": "glm_multistep", "C": C, "k_trans": k,
          "ok": ok, "bitwise_repeat": bitwise,
          "accept_kernel": float(res_k[3].mean()),
          "accept_plain": float(res_r[3].mean()), "z_accept": z_acc,
          "pooled_theta_max_abs_diff": float(
              (res_k[0].mean(0) - res_r[0].mean(0)).abs().max()),
          "z_theta_max": z_theta})
    assert ok, "glm_multistep disagrees with glm_multistep_ref"
    errors["glm_multistep"] = float(
        (res_k[0].mean(0) - res_r[0].mean(0)).abs().max())
    return errors


def _counted(fn):
    """Run ``fn`` with every launch and plain-call count zeroed just before
    it; returns (its result, the launch counts read just after it)."""
    import torch

    from mcmc_jl_tpu_torch.ops import glm_kernels as gk
    from mcmc_jl_tpu_torch.ops import nuts_kernels as nk

    gk.reset_counts()
    nk.reset_counts()
    out = fn()
    torch.cuda.synchronize()
    launches = {**gk.LAUNCHES, **nk.LAUNCHES}
    plain = {**gk.PLAIN_CALLS, **nk.PLAIN_CALLS}
    assert not any(plain.values()), plain
    return out, launches


def phase_main_path(chains=4096, steps=1000, burnin=200, generic_chains=512):
    """The port's main path through its user entry points.  Returns the
    trajectory kernel's launches in ``run`` and each chain's last state
    (chains, d)."""
    import mcmc_jl_tpu_torch as mt

    X, Y = bench_data()
    m = mt.model(glm=("logistic", X, Y), device="cuda")
    task = m * mt.HMC(10, 0.05) * mt.SerialMC(steps=steps, burnin=burnin)

    t0 = time.perf_counter()
    cs, launches = _counted(lambda: mt.run(task, chains=chains, seed=0))
    dt = time.perf_counter() - t0
    rose = launches["glm_leapfrogs"]
    assert launches == {**{k: 0 for k in launches},
                        "glm_leapfrogs": steps}, launches
    assert len(cs) == chains
    samples = np.stack([c.samples.values for c in cs])  # (chains, kept, d)
    assert samples.shape == (chains, steps - burnin, m.size)
    assert np.all(np.isfinite(samples))
    c0 = cs[0]
    pooled = samples.mean(axis=(0, 1))

    # both runs start every chain at the model's init: the per-chain means
    # are independent draws of one law, mixed or not, so their spread gives
    # the standard error of the pooled mean
    cg = mt.run(task, chains=generic_chains, seed=1, fused=False)
    gs = np.stack([c.samples.values for c in cg])
    fm, gm = samples.mean(axis=1), gs.mean(axis=1)
    z = (np.abs(pooled - gm.mean(0))
         / np.sqrt(fm.var(0) / chains + gm.var(0) / generic_chains))

    c1 = mt.resume(c0, steps=100)
    assert c1.samples.values.shape == (100, m.size)
    assert np.all(np.isfinite(c1.samples.values))
    ok = bool(np.all(z < Z_MAX))
    emit({"phase": "main_path", "chains": chains, "steps": steps,
          "seconds": dt, "trajectory_launches": rose,
          "chain0": {"acceptance": mt.acceptance(c0),
                     "mean": mt.mean(c0).tolist(),
                     "ess": mt.ess(c0).tolist(),
                     "actime": mt.actime(c0).tolist()},
          "pooled_mean": pooled.tolist(),
          "generic_pooled_mean": gs.mean(axis=(0, 1)).tolist(),
          "z_max_vs_generic": float(z.max()), "ok": ok,
          "resume_acceptance": mt.acceptance(c1), **CARD})
    assert ok, "fused main path disagrees with the generic engine"
    return ({"glm_leapfrogs": (rose, f"run(..., chains={chains})")},
            samples[:, -1])


def phase_drivers(final, steps=1000, thin=200):
    """The step and multi-transition kernels through the drivers that reach
    them (bench.py's phases: ``_run(fused_step=True)`` and
    ``_run_multistep``), each run once at the main path's size with the
    counts zeroed just before it.

    ``final`` is the main path's state after ``steps`` transitions, one row
    per chain.  The drivers start where it started (the model's init, 0)
    and make as many transitions of the same Markov kernel, so their final
    states have the same law whether or not the chains have mixed: the
    means of the two sets of independent chains must agree within 5
    standard errors."""
    from mcmc_jl_tpu_torch.ops.glm_hmc import run_glm_hmc, run_glm_hmc_multistep

    X, Y = bench_data()
    chains = final.shape[0]
    inits = np.zeros_like(final)
    drivers = {
        "glm_step": ("run_glm_hmc(fused_step=True)", steps, lambda: run_glm_hmc(
            X, Y, chains, steps, n_leaps=10, eps=0.05, seed=2, inits=inits,
            device="cuda", fused_step=True)),
        "glm_multistep": (f"run_glm_hmc_multistep(thin={thin})", steps // thin,
                          lambda: run_glm_hmc_multistep(
                              X, Y, chains, steps, thin=thin, n_leaps=10,
                              eps=0.05, seed=3, inits=inits, device="cuda")),
    }
    counts = {}
    for name, (origin, want, fn) in drivers.items():
        (theta, infos), launches = _counted(fn)
        assert launches == {**{k: 0 for k in launches}, name: want}, launches
        th = theta.double().cpu().numpy()
        assert th.shape == final.shape and np.all(np.isfinite(th))
        z = (np.abs(th.mean(0) - final.mean(0))
             / np.sqrt((th.var(0) + final.var(0)) / chains))
        acc = infos["accept" if name == "glm_step" else "accept_rate"]
        ok = bool(np.all(z < Z_MAX))
        emit({"phase": "driver", "kernel": name, "from": origin,
              "chains": chains, "transitions": steps,
              "launches": launches[name],
              "accept_rate": float(acc.float().mean()),
              "z_max_vs_main_path": float(z.max()), "ok": ok})
        assert ok, f"{origin} disagrees with the main path"
        counts[name] = (launches[name], origin)
    return counts


def _time(fn, reps=3):
    """Median host seconds of ``fn`` after one warm-up; each run ends on
    torch.cuda.synchronize()."""
    import torch

    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def _event_ms(fn, reps=3):
    """Median device milliseconds of one call of ``fn`` (CUDA events)."""
    import torch

    fn()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return float(np.median(ts))


def phase_timing(C=65536, steps=2000, n_leaps=10, eps=0.05, k_trans=200):
    """Leapfrog/s of the drivers at bench.py's shape (bench.py phases 1-2
    plus the step kernel's driver), beside the plain version's."""
    import torch

    from mcmc_jl_tpu_torch.ops import glm_kernels as gk
    from mcmc_jl_tpu_torch.ops.glm_hmc import run_glm_hmc, run_glm_hmc_multistep

    X, Y = bench_data()
    lf = C * steps * n_leaps
    rates = {}
    runs = {
        "multistep": lambda: run_glm_hmc_multistep(
            X, Y, C, steps, thin=k_trans, n_leaps=n_leaps, eps=eps, seed=1,
            device="cuda"),
        "composed": lambda: run_glm_hmc(X, Y, C, steps, n_leaps=n_leaps,
                                        eps=eps, seed=1, device="cuda"),
        "fused_step": lambda: run_glm_hmc(X, Y, C, steps, n_leaps=n_leaps,
                                          eps=eps, seed=1, device="cuda",
                                          fused_step=True),
    }
    for name, fn in runs.items():
        sec = _time(fn)
        rates[name] = lf / sec
        emit({"phase": "timing", "driver": name, "C": C, "transitions": steps,
              "n_leaps": n_leaps, "seconds": sec,
              "leapfrog_per_s": rates[name], **CARD})

    XT, Yc, theta, m0, logu, lp, g = _inputs(C, seed=4)
    gen = torch.Generator(device="cuda").manual_seed(5)
    plain_k = 200
    sec = _time(lambda: gk.glm_multistep_ref(
        XT, Yc, theta, eps, k_trans=plain_k, n_leaps=n_leaps, generator=gen),
        reps=2)
    emit({"phase": "timing", "driver": "plain glm_multistep_ref", "C": C,
          "transitions": plain_k, "n_leaps": n_leaps, "seconds": sec,
          "leapfrog_per_s": C * plain_k * n_leaps / sec, **CARD})
    return rates


def phase_kernel_times(C=65536, n_leaps=10, eps=0.05, k_trans=200):
    """Per-launch device time of each kernel beside its plain version on the
    same inputs, at bench.py's shape."""
    import torch

    from mcmc_jl_tpu_torch.ops import glm_kernels as gk

    XT, Yc, theta, m0, logu, lp, g = _inputs(C, seed=4)
    gen = torch.Generator(device="cuda").manual_seed(5)
    gen_k = torch.Generator(device="cuda").manual_seed(7)
    calls = {
        "glm_leapfrogs": (
            lambda: gk.glm_leapfrogs(XT, Yc, theta, m0, g, eps, n_leaps=n_leaps),
            lambda: gk.glm_leapfrogs_ref(XT, Yc, theta, m0, g, eps,
                                         n_leaps=n_leaps)),
        "glm_step": (
            lambda: gk.glm_step(XT, Yc, theta, g, lp, m0, logu, eps,
                                n_leaps=n_leaps),
            lambda: gk.glm_step_ref(XT, Yc, theta, g, lp, m0, logu, eps,
                                    n_leaps=n_leaps)),
        "glm_multistep": (
            lambda: gk.glm_multistep(XT, Yc, theta, eps, k_trans=k_trans,
                                     n_leaps=n_leaps, generator=gen_k),
            lambda: gk.glm_multistep_ref(XT, Yc, theta, eps, k_trans=k_trans,
                                         n_leaps=n_leaps, generator=gen)),
    }
    ms = {}
    for name, (kern, plain) in calls.items():
        ms[name] = (_event_ms(kern), _event_ms(plain, reps=2))
        emit({"phase": "kernel_time", "name": name, "C": C,
              "k_trans": k_trans if name == "glm_multistep" else 1,
              "ms": ms[name][0], "plain_ms": ms[name][1], **CARD})
    return ms


def _logistic_mode(X, Y, W=None, O=None, lam=1.0, iters=30):
    """Posterior mode of a weighted, offset logistic GLM by Newton steps, so
    that the kernel checks start where the chains sample."""
    W = np.ones(len(Y)) if W is None else W
    O = np.zeros(len(Y)) if O is None else O
    b = np.zeros(X.shape[1])
    for _ in range(iters):
        p = 1.0 / (1.0 + np.exp(-(X @ b + O)))
        g = X.T @ (W * (Y - p)) - lam * b
        H = X.T @ (X * (W * p * (1 - p))[:, None]) + lam * np.eye(len(b))
        b = b + np.linalg.solve(H, g)
    return b


def _laplace_scale(X, Y, lam=1.0):
    """Posterior standard deviations of a logistic GLM from the Laplace
    approximation at the mode: the scales ``s`` that the diagonal-metric
    route folds into the design (``X s``, prior row ``lam s^2``)."""
    b = _logistic_mode(X, Y, lam=lam)
    p = 1.0 / (1.0 + np.exp(-X @ b))
    H = X.T @ (X * (p * (1 - p))[:, None]) + lam * np.eye(len(b))
    return np.sqrt(np.diag(np.linalg.inv(H)))


def _nuts_inputs(C, md, seed, X, Y, W=None, O=None, lam=1.0, spread=0.05):
    """A NUTS transition's inputs on the card: chains near the posterior
    mode and one transition's pre-drawn noise, from numpy seed ``seed``."""
    import torch

    from mcmc_jl_tpu_torch.ops.glm_kernels import glm_funcs

    rng = np.random.default_rng(seed)
    d = X.shape[1]
    cuda = lambda a: None if a is None else torch.as_tensor(  # noqa: E731
        a, dtype=torch.float32, device="cuda").contiguous()
    lam_t = cuda(lam) if np.ndim(lam) else float(lam)
    theta = _logistic_mode(X, Y, W, O, lam) + spread * rng.standard_normal((C, d))
    XT, Yc, Wc, Oc, th = cuda(X.T), cuda(Y), cuda(W), cuda(O), cuda(theta)
    lp, g = glm_funcs(XT, Yc, Wc, Oc, lam_t, "logistic")[1](th)
    noise = (rng.standard_normal((C, d)), np.log(rng.random(C)),
             np.where(rng.random((C, md)) < 0.5, 1.0, -1.0),
             rng.random((C, md)), rng.random((C, 1 << md)))
    args = (XT, Yc, th, lp.contiguous(), g.contiguous())
    kw = dict(maxdoublings=md, weights=Wc, offsets=Oc, prior_prec=lam_t)
    return args, tuple(cuda(a) for a in noise), kw


def _nuts_check(label, args, noise, eps, kw, scale=1.0, full_depth=False):
    """The transition kernel against its plain version on the same inputs;
    ``full_depth``: some chain must build a tree of all maxdoublings
    doublings (the deepest checkpoint slots and span checks).  Returns the
    max abs error of theta on the chains on the same path."""
    import torch

    from mcmc_jl_tpu_torch.ops import nuts_kernels as nk

    out_k = nk.glm_nuts_transition(*args, eps, *noise, **kw)
    out_r = nk.glm_nuts_transition_ref(*args, eps, *noise, **kw)
    torch.cuda.synchronize()
    (thk, gk_, lpk, ndk, dvk), (thr, gr, lpr, ndr, dvr) = out_k, out_r
    same = ((ndk == ndr) & (dvk == dvr)
            & ((thk - thr).abs().amax(-1) <= LEAF_ATOL))
    C = thk.shape[0]
    rep = {n: _err(a[same], b[same]) for n, a, b in
           zip(("theta", "g", "lp"), (thk, gk_, lpk), (thr, gr, lpr))}
    md = kw["maxdoublings"]
    ok = (float(same.float().mean()) >= PATH_AGREE
          and (not full_depth or int(ndr.max()) == md)
          and _close(thk[same], thr[same], RTOL, ATOL)
          and _close(gk_[same], gr[same], RTOL, G_ATOL * scale)
          and _close(lpk[same], lpr[same], LP_RTOL, LP_ATOL * scale))
    emit({"phase": "kernel", "name": "glm_nuts_transition", "case": label,
          "C": C, "eps": eps, "ok": ok, "path_differ": int(C - same.sum()),
          "mean_ndoublings": float(ndr.float().mean()),
          "chains_at_maxdoublings": int((ndr == md).sum()),
          "diverging": int(dvr.sum()), **rep})
    assert ok, f"glm_nuts_transition ({label}) disagrees with its plain version"
    return rep["theta"]["max_abs"]


def phase_nuts_kernels(C=4096, md=6):
    """Both NUTS kernels against their plain versions on the card."""
    import torch

    from mcmc_jl_tpu_torch.ops import nuts_kernels as nk

    X, Y = bench_data()
    err = 0.0
    for label, multinomial, eps in (
            ("slice", False, 0.05), ("slice", False, 0.2),
            ("multinomial", True, 0.05), ("multinomial", True, 0.2)):
        args, noise, kw = _nuts_inputs(C, md, 21, X, Y)
        err = max(err, _nuts_check(f"{label}, eps {eps}", args, noise, eps,
                                   dict(kw, multinomial=multinomial)))
    # deep trees, up to maxdoublings: at eps 0.01 (the posterior sds are
    # about 0.09), and on the diagonal-metric route's folded inputs (design
    # X s, (d,) prior row lam s^2, chains in z = theta / s) at eps 0.1
    args, noise, kw = _nuts_inputs(C, md, 24, X, Y)
    err = max(err, _nuts_check("slice, eps 0.01", args, noise, 0.01,
                               dict(kw, multinomial=False), full_depth=True))
    s = _laplace_scale(X, Y)
    for multinomial in (False, True):
        args, noise, kw = _nuts_inputs(C, md, 25, X * s, Y, lam=s * s,
                                       spread=0.5)
        err = max(err, _nuts_check(
            f"{'multinomial' if multinomial else 'slice'}, folded diagonal "
            f"metric (X s, (d,) prior row), eps 0.1", args, noise, 0.1,
            dict(kw, multinomial=multinomial), full_depth=True))

    # rows streamed through shared memory (N = 5000 past the budget: the
    # lockstep path), a ragged last block (C = 300), weights and offsets
    rng = np.random.default_rng(6)
    N, d7 = 5000, 7
    X7 = np.column_stack([np.ones(N), rng.standard_normal((N, d7 - 1))]) * 0.3
    Y7 = (rng.random(N) < 1 / (1 + np.exp(-X7 @ rng.standard_normal(d7)))
          ).astype(float)
    W7, O7 = rng.uniform(0.5, 2.0, N), 0.1 * rng.standard_normal(N)
    for multinomial in (False, True):
        args, noise, kw = _nuts_inputs(300, md, 22, X7, Y7, W7, O7, lam=1.5)
        err = max(err, _nuts_check(
            f"N 5000 streamed, C 300, d 7, weights+offsets, "
            f"{'multinomial' if multinomial else 'slice'}", args, noise, 0.03,
            dict(kw, multinomial=multinomial), scale=N / 1000))

    # multistep: bitwise repeat from one generator state; then held against
    # its plain version from the same start, K transitions each (Philox
    # streams in the kernel, torch.Generator streams in the plain version):
    # final states of independent chains, per-chain accept rates and the
    # mean tree depth; and, as an extra check, against the per-transition
    # driver the same way
    args, _, kw = _nuts_inputs(C, md, 23, X, Y)
    XT, Yc, th, lp, g = args
    eps, K, kt = 0.05, 64, 8
    r1, r2 = (nk.glm_nuts_multistep(
        *args, eps, torch.Generator(device="cuda").manual_seed(12345),
        k_trans=kt, **kw) for _ in range(2))
    torch.cuda.synchronize()
    bitwise = (all(torch.equal(a, b) for a, b in zip(r1[:3], r2[:3]))
               and all(torch.equal(r1[3][k], r2[3][k]) for k in r1[3]))
    gen = torch.Generator(device="cuda").manual_seed(3)
    drv = dict(steps=K, maxdoublings=md)
    (th_ms, _, _), inf_ms = nk._nuts_run_hw(XT, Yc, th, eps, gen, k_trans=kt,
                                            **drv)
    th_pl, _, _, inf_pl = nk.glm_nuts_multistep_ref(*args, eps, gen,
                                                    k_trans=K, **kw)
    (th_pt, _, _), inf_pt = nk._nuts_run(XT, Yc, th, eps, gen, **drv)
    torch.cuda.synchronize()

    def z(a, b):  # per-chain values a, b -> max |mean difference| / se
        se = torch.sqrt(a.var(0) / a.shape[0] + b.var(0) / b.shape[0])
        return float(((a.mean(0) - b.mean(0)).abs() / se.clamp_min(1e-12))
                     .max())

    def depth(inf):
        return float(inf["ndoublings"].float().mean())

    acc = {n: inf["accept"].float().mean(0)
           for n, inf in (("kernel", inf_ms), ("plain", inf_pl))}
    rep = {"z_theta_max": z(th_ms, th_pl),
           "z_accept": z(acc["kernel"], acc["plain"]),
           "accept_rate": float(acc["kernel"].mean()),
           "accept_rate_plain": float(acc["plain"].mean()),
           "mean_ndoublings": depth(inf_ms),
           "mean_ndoublings_plain": depth(inf_pl),
           "diverging": int(inf_ms["diverging"].sum()),
           "diverging_plain": int(inf_pl["diverging"].sum()),
           "z_theta_max_vs_per_transition": z(th_ms, th_pt),
           "mean_ndoublings_per_transition": depth(inf_pt)}
    ms_err = float((th_ms.mean(0) - th_pl.mean(0)).abs().max())
    ok = (bitwise and rep["z_theta_max"] < Z_MAX and rep["z_accept"] < Z_MAX
          and abs(depth(inf_ms) / depth(inf_pl) - 1) < DEPTH_RTOL
          and rep["z_theta_max_vs_per_transition"] < Z_MAX
          and abs(depth(inf_ms) / depth(inf_pt) - 1) < DEPTH_RTOL
          and bool(torch.isfinite(inf_ms["plogtarget"]).all()))
    emit({"phase": "kernel", "name": "glm_nuts_multistep", "C": C,
          "k_trans": kt, "transitions": K, "ok": ok, "bitwise_repeat": bitwise,
          **rep, "pooled_theta_max_abs_diff": ms_err})
    assert ok, "glm_nuts_multistep disagrees with glm_nuts_multistep_ref"
    return {"glm_nuts_transition": err, "glm_nuts_multistep": ms_err}


@contextlib.contextmanager
def _spans():
    """Host seconds (to a synchronize) of the warm route's phases inside a
    ``run``: warmup on the generic engine, the kernels' sampling phase, and
    packaging into chains.  Wraps the module functions for the duration."""
    import torch

    from mcmc_jl_tpu_torch.ops import nuts_kernels, warmstart
    from mcmc_jl_tpu_torch.parallel import pchains

    spans, saved = {}, []
    for mod, fn, label in ((warmstart, "_warmup", "warmup"),
                           (nuts_kernels, "_nuts_run_hw", "sampling"),
                           (nuts_kernels, "_nuts_run", "sampling"),
                           (pchains, "_package_group", "packaging")):
        orig = getattr(mod, fn)

        def timed(*a, _orig=orig, _label=label, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = _orig(*a, **k)
            torch.cuda.synchronize()
            spans[_label] = spans.get(_label, 0.0) + time.perf_counter() - t0
            return out

        saved.append((mod, fn, orig))
        setattr(mod, fn, timed)
    try:
        yield spans
    finally:
        for mod, fn, orig in saved:
            setattr(mod, fn, orig)


def phase_nuts_main_path(hmc_final, hmc_steps=2000):
    """Exact NUTS through ``run``: the multistep kernel serves
    SerialMC(1500, 500) (1000 = 125 launches of 8), the per-transition
    kernel the diagonal-metric run with SerialMC(1497, 500) (997 is prime).

    Each run's per-chain means must agree with the HMC main path's.  That
    path's kept draws still carry the transient of its start at 0 (chain
    0's autocorrelation times reach 190 of 1000 transitions), so it is
    continued from its final states ``hmc_final`` (chains, d) for
    ``hmc_steps`` more transitions, whose per-chain means are the reference.
    Returns the kernels' launches and what the timing phase starts from."""
    import torch

    import mcmc_jl_tpu_torch as mt
    from mcmc_jl_tpu_torch.ops.glm_hmc import _run
    from mcmc_jl_tpu_torch.samplers.base import tree_map

    chains = len(hmc_final)
    X, Y = bench_data()
    m = mt.model(glm=("logistic", X, Y), device="cuda")
    spec = m.glm_spec
    gen = torch.Generator(device="cuda").manual_seed(4)
    _, hmc = _run(spec.X.T.contiguous(), spec.Y,
                  torch.as_tensor(hmc_final, device="cuda").contiguous(), 0.05,
                  gen, steps=hmc_steps, n_leaps=10, collect=True)
    hmc_means = hmc["ppars"].mean(0).double().cpu().numpy()
    del hmc
    runs = {
        "glm_nuts_multistep": (mt.NUTS(maxdoublings=6), 1500, 125),
        "glm_nuts_transition": (mt.NUTS(maxdoublings=6, mass_adapt="diag"),
                                1497, 997),
    }
    counts, start = {}, None
    for name, (sampler, steps, want) in runs.items():
        origin = (f"run(model(glm=...) * {sampler!r} * SerialMC(steps={steps},"
                  f" burnin=500), chains={chains})")
        task = m * sampler * mt.SerialMC(steps=steps, burnin=500)
        t0 = time.perf_counter()
        with _spans() as spans:
            cs, launches = _counted(lambda: mt.run(task, chains=chains,
                                                   seed=0))
        dt = time.perf_counter() - t0
        assert launches == {**{k: 0 for k in launches}, name: want}, launches
        samples = np.stack([c.samples.values for c in cs])
        assert samples.shape == (chains, steps - 500, m.size)
        assert np.all(np.isfinite(samples))
        dg = {k: np.stack([c.diagnostics[k] for c in cs])
              for k in ("accept", "ndoublings", "diverging", "epsilon")}
        eps = float(dg["epsilon"][0, 0])
        assert np.all(dg["epsilon"] == eps), "eps not frozen after burn-in"
        nm = samples.mean(axis=1)
        z = (np.abs(nm.mean(0) - hmc_means.mean(0))
             / np.sqrt(nm.var(0) / chains + hmc_means.var(0) / chains))
        ok = bool(np.all(z < Z_MAX))
        emit({"phase": "nuts_main_path", "kernel": name, "from": origin,
              "chains": chains, "seconds": dt, "spans_s": spans,
              "launches": launches[name],
              "frozen_eps": eps, "accept_rate": float(dg["accept"].mean()),
              "mean_ndoublings": float(dg["ndoublings"].mean()),
              "diverging_share": float(dg["diverging"].mean()),
              "pooled_mean": nm.mean(0).tolist(),
              "hmc_pooled_mean": hmc_means.mean(0).tolist(),
              "z_max_vs_hmc_main_path": float(z.max()), "ok": ok, **CARD})
        assert ok, f"{origin} disagrees with the HMC main path"
        counts[name] = (launches[name], origin)
        if start is None:  # the unit-metric run's end: timing starts there
            c1 = mt.resume(cs[0], steps=50)  # one chain, generic engine
            assert c1.samples.values.shape == (50, m.size)
            assert np.all(np.isfinite(c1.samples.values))
            states = tree_map(lambda *xs: torch.stack(xs),
                              *[c.task.state for c in cs])
            start = {"model": m, "sampler": sampler, "eps": eps,
                     "states": states}
    return counts, start


def phase_nuts_timing(start, md=6, k_trans=8,
                      sizes=((4096, 200), (65536, 40))):
    """Sampling-phase rates of the NUTS drivers at the frozen step, from the
    main path's final states (tiled to each (chains, transitions) of
    ``sizes``): transitions/s, and gradient evaluations/s
    bounded by the tree depths (a transition of depth n evaluates between
    2^(n-1) and 2^n - 1 leaves).  Then each kernel's per-launch time beside
    its plain version's.  Returns {kernel: (ms, plain ms)}."""
    import torch

    from mcmc_jl_tpu_torch.ops import nuts_kernels as nk
    from mcmc_jl_tpu_torch.parallel.pchains import _scan_chains
    from mcmc_jl_tpu_torch.samplers.base import RunCtx

    m, sampler, eps = start["model"], start["sampler"], start["eps"]
    states = start["states"]
    XT = m.glm_spec.X.T.contiguous()
    Y = m.glm_spec.Y
    th4 = states.pars.contiguous()
    gen = torch.Generator(device="cuda").manual_seed(9)

    def rate(driver, C, steps, fn):
        last = {}
        ms = _event_ms(lambda: last.update(out=fn()))
        nd = last["out"][1]["ndoublings"].double()
        sec = ms / 1e3
        emit({"phase": "nuts_timing", "driver": driver, "C": C,
              "transitions": steps, "seconds": sec,
              "transitions_per_s": C * steps / sec,
              "mean_ndoublings": float(nd.mean()),
              "grad_evals_per_s_min": float((2.0 ** (nd - 1)).sum()) / sec,
              "grad_evals_per_s_max": float((2.0 ** nd - 1).sum()) / sec,
              **CARD})

    for C, steps in sizes:
        th = th4.repeat(C // th4.shape[0], 1)
        kw = dict(steps=steps, maxdoublings=md)
        rate("multistep", C, steps, lambda: nk._nuts_run_hw(
            XT, Y, th, eps, gen, k_trans=k_trans, **kw))
        rate("per-transition", C, steps, lambda: nk._nuts_run(
            XT, Y, th, eps, gen, **kw))
    lp, g = states.logtarget.contiguous(), states.grad.contiguous()
    rate("plain glm_nuts_multistep_ref", th4.shape[0], k_trans, lambda: (
        None, nk.glm_nuts_multistep_ref(XT, Y, th4, lp, g, eps, gen,
                                        k_trans=k_trans, maxdoublings=md)[3]))
    rate("generic engine", th4.shape[0], k_trans, lambda: _scan_chains(
        m, sampler, RunCtx(burnin=0), states, gen, k_trans))

    noise = nk.draw_noise(th4.shape[0], th4.shape[1], md, gen)
    calls = {
        "glm_nuts_transition": (
            lambda: nk.glm_nuts_transition(XT, Y, th4, lp, g, eps, *noise,
                                           maxdoublings=md),
            lambda: nk.glm_nuts_transition_ref(XT, Y, th4, lp, g, eps, *noise,
                                               maxdoublings=md)),
        "glm_nuts_multistep": (
            lambda: nk.glm_nuts_multistep(XT, Y, th4, lp, g, eps, gen,
                                          k_trans=k_trans, maxdoublings=md),
            lambda: nk.glm_nuts_multistep_ref(XT, Y, th4, lp, g, eps, gen,
                                              k_trans=k_trans,
                                              maxdoublings=md)),
    }
    ms = {}
    for name, (kern, plain) in calls.items():
        ms[name] = (_event_ms(kern), _event_ms(plain, reps=2))
        emit({"phase": "kernel_time", "name": name, "C": th4.shape[0],
              "k_trans": k_trans if name == "glm_nuts_multistep" else 1,
              "ms": ms[name][0], "plain_ms": ms[name][1], **CARD})

    return ms


def main():
    phase_device()
    import torch

    phase_build()
    errors = phase_kernels()
    errors.update(phase_nuts_kernels())
    # each kernel's launches, counted from zero over one run of the entry
    # point that reaches it: run(..., chains=N) for the trajectory kernel and
    # the two NUTS kernels, the bench drivers for the other two
    launches, final = phase_main_path()
    launches.update(phase_drivers(final))
    nuts_launches, start = phase_nuts_main_path(final)
    launches.update(nuts_launches)
    missing = [k for k in REPLACES if launches.get(k, (0,))[0] == 0]
    assert not missing, f"kernels never launched on the main path: {missing}"
    phase_timing()
    ms = phase_kernel_times()
    ms.update(phase_nuts_timing(start))
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[lib],
         "replaces": replaces, "launches": launches[name][0],
         "from": launches[name][1], "max_abs_err": errors[name],
         "ms": ms[name][0], "plain_ms": ms[name][1]}
        for name, (lib, replaces) in REPLACES.items()]})
    print(CARD["card"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": CARD["kind"],
                                 "count": CARD["count"]}})
    torch.cuda.synchronize()


if __name__ == "__main__":
    main()
