"""GPU smoke run of the PyTorch/CUDA port (``mcmc_jl_tpu_torch``).

Builds the CUDA kernels from the sources in this checkout, holds each kernel
against its plain PyTorch version on the card, drives the main path —
Bayesian logistic regression (d = 10, N = 1000) sampled by ``HMC(10, 0.05)``
under ``SerialMC`` across 4096 chains through ``run(..., chains=N)`` — checks
it against the generic engine, runs the step and multi-transition kernels
through their drivers, times the drivers at bench.py's shape, and prints one
JSON line per phase.  The last three lines are the kernels' report (with
each kernel's launches counted from zero over the one run that reaches it),
the card's name and power limit, and ``{"ok": true, "device": {...}}``.

Run with no arguments on a machine with one CUDA card::

    python3 chip_smoke.py

It exits non-zero without a CUDA device, and on any failed check.
"""
import json
import subprocess
import sys
import time

import numpy as np

SOURCE = "mcmc_jl_tpu_torch/csrc/glm_hmc.cu"
REPLACES = {
    "glm_leapfrogs": "mcmc_jl_tpu/ops/pallas_glm.py:244",
    "glm_step": "mcmc_jl_tpu/ops/pallas_glm.py:282",
    "glm_multistep": "mcmc_jl_tpu/ops/pallas_glm.py:344",
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
    from mcmc_jl_tpu_torch.ops import cuda_build
    from mcmc_jl_tpu_torch.ops.glm_kernels import load_kernels

    t0 = time.perf_counter()
    path, report = cuda_build.build("glm_hmc")
    load_kernels()
    ptxas = [ln.strip() for ln in report.splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "library": str(path.relative_to(cuda_build.BUILD_ROOT.parent.parent)),
          "ptxas": ptxas})


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
    res_k = gk.glm_multistep(XT, Y, theta, eps, k_trans=k, n_leaps=n_leaps,
                             seed=12345)
    res_k2 = gk.glm_multistep(XT, Y, theta, eps, k_trans=k, n_leaps=n_leaps,
                              seed=12345)
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

    gk.reset_counts()
    out = fn()
    torch.cuda.synchronize()
    launches = dict(gk.LAUNCHES)
    assert not any(gk.PLAIN_CALLS.values()), gk.PLAIN_CALLS
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
    assert launches == {"glm_leapfrogs": steps, "glm_step": 0,
                        "glm_multistep": 0}, launches
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
                                     n_leaps=n_leaps, seed=7),
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


def main():
    phase_device()
    import torch

    phase_build()
    errors = phase_kernels()
    # each kernel's launches, counted from zero over one run of the entry
    # point that reaches it: run(..., chains=N) for the trajectory kernel,
    # the bench drivers for the other two
    launches, final = phase_main_path()
    launches.update(phase_drivers(final))
    missing = [k for k in REPLACES if launches.get(k, (0,))[0] == 0]
    assert not missing, f"kernels never launched on the main path: {missing}"
    phase_timing()
    ms = phase_kernel_times()
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCE,
         "replaces": REPLACES[name], "launches": launches[name][0],
         "from": launches[name][1], "max_abs_err": errors[name],
         "ms": ms[name][0], "plain_ms": ms[name][1]} for name in REPLACES]})
    print(CARD["card"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": CARD["kind"],
                                 "count": CARD["count"]}})
    torch.cuda.synchronize()


if __name__ == "__main__":
    main()
