"""The port's custom-target kernels' plain versions
(mcmc_jl_tpu_torch/ops/target_kernels.py, ops/rwm_kernels.py) against the
JAX package's Pallas kernels (mcmc_jl_tpu/ops/pallas_target.py,
pallas_rwm.py) run in interpret mode on the CPU, on the same numpy inputs
and injected noise; the multi-transition kernel (hardware PRNG in JAX) and
the three entry points statistically; the host replay of the kernels'
Philox draws (ops/philox.py) against Philox4x32-10's known answers; the
"target" route of ``run(..., chains=N)``; RWM on the generic engine; the
converters; the kernels' layouts by d and their launchers.

On the CPU the wrappers run their plain versions; the CUDA kernels are held
against those on the card by chip_smoke.py and by
``test_target_lanes_on_card`` here.  JAX's inputs are padded to 128 lanes
and unpadded after.  Tolerances: rtol 1e-5 and atol 1e-6 for theta, m and
g, 1e-5 for lp (the JAX package's own gate,
tests/test_pallas_target.py:53-60); RWM within tests/test_pallas_rwm.py's
gates; the multi-transition kernel's plain version on injected noise
against transitions composed from the Pallas trajectory kernel within
rtol 1e-5 and atol 1e-5 (the same float32 operations, sums in another
order, over four transitions); statistical gates |z| < 5.  The tests that
run the JAX package
import it themselves, so that the card test runs where JAX is not
installed."""
import dataclasses
import logging
import math
import pathlib

import numpy as np
import pytest
import torch

import mcmc_jl_tpu_torch as mt
from mcmc_jl_tpu_torch.models import distributions as td
from mcmc_jl_tpu_torch.ops import philox
from mcmc_jl_tpu_torch.ops import rwm_kernels as rk
from mcmc_jl_tpu_torch.ops import target_kernels as tk

torch.set_num_threads(1)
Z_MAX = 5.0


def _jax_block(dists, safes):
    """A JAX logp_block with coordinate j ~ dists[j] (lanes past d zero)."""
    import jax
    import jax.numpy as jnp

    def logp_block(theta):
        col = jax.lax.broadcasted_iota(jnp.int32, theta.shape, 1)
        total = jnp.zeros((theta.shape[0], 1), theta.dtype)
        for j, (dist, safe) in enumerate(zip(dists, safes)):
            live = col == j
            x = jnp.where(live, theta, jnp.asarray(safe, theta.dtype))
            total = total + jnp.sum(jnp.where(live, dist.logpdf(x), 0.0),
                                    axis=1, keepdims=True)
        return total

    return logp_block


def _targets(spec, d):
    """(JAX logp_block, port target) for a (name, params, safe) spec or a
    list of them (mixed)."""
    from mcmc_jl_tpu.models import distributions as jd
    from mcmc_jl_tpu.ops.pallas_target import coordwise_logp as j_coordwise

    if isinstance(spec, list):
        jds = [getattr(jd, n)(*p) for n, p, _ in spec]
        return (_jax_block(jds, [s for _, _, s in spec]),
                tk.coordwise_logp([getattr(td, n)(*p) for n, p, _ in spec], d))
    name, params, safe = spec
    jdist = getattr(jd, name)(*params)
    return (j_coordwise(lambda x: jdist.logpdf(x), d, safe=safe),
            tk.coordwise_logp(getattr(td, name)(*params), d))


MIXED = [("Normal", (0.5, 2.0), 0.5), ("Gamma", (3.0, 0.2), 0.5),
         ("Beta", (2.0, 3.0), 0.5), ("Laplace", (0.0, 1.0), 0.0),
         ("TDist", (3.0,), 0.0), ("Weibull", (1.5, 2.0), 1.0)]
TRAJ = [
    # id, target spec, d, center, spread, eps, n_leaps, integrator
    ("normal", ("Normal", (0.5, 2.0), 0.5), 6, 0.5, 1.0, 0.2, 5, "leapfrog"),
    ("gamma", ("Gamma", (3.0, 0.2), 0.5), 4, 0.6, 0.05, 0.02, 5, "leapfrog"),
    ("beta", ("Beta", (2.0, 3.0), 0.5), 4, 0.4, 0.05, 0.01, 5, "leapfrog"),
    ("laplace", ("Laplace", (0.0, 1.0), 0.0), 4, 0.0, 1.0, 0.1, 5,
     "leapfrog"),
    ("tdist", ("TDist", (3.0,), 0.0), 4, 0.0, 1.0, 0.2, 5, "leapfrog"),
    ("mixed_vec_eps", MIXED, 6, np.array([0.5, 0.6, 0.4, 0.0, 0.0, 1.8]),
     np.array([1.0, 0.05, 0.05, 1.0, 1.0, 0.3]),
     np.array([0.1, 0.01, 0.005, 0.1, 0.1, 0.05]), 4, "leapfrog"),
    ("mixed_dyn_len", MIXED, 6, np.array([0.5, 0.6, 0.4, 0.0, 0.0, 1.8]),
     np.array([1.0, 0.05, 0.05, 1.0, 1.0, 0.3]), 0.01, "dyn", "leapfrog"),
    ("normal_2stage", ("Normal", (0.5, 2.0), 0.5), 6, 0.5, 1.0, 0.2, 4,
     "2stage"),
    ("normal_3stage", ("Normal", (0.5, 2.0), 0.5), 6, 0.5, 1.0, 0.2, 4,
     "3stage"),
]


@pytest.mark.parametrize("case", TRAJ, ids=[c[0] for c in TRAJ])
def test_trajectory_matches_pallas_interpret(case):
    import jax
    import jax.numpy as jnp
    from mcmc_jl_tpu.ops.pallas_glm import LANE, pad_chains
    from mcmc_jl_tpu.ops.pallas_target import fused_target_leapfrogs as j_leaps

    f32 = jnp.float32
    label, spec, d, center, spread, eps, n_leaps, integ = case
    C = 8
    rng = np.random.default_rng(len(label))
    theta = (center + spread * rng.standard_normal((C, d))).astype(np.float32)
    if label == "laplace":
        theta[:3, 0] = 0.0  # exactly at loc: derivative -1/scale
    m = rng.standard_normal((C, d)).astype(np.float32)
    jblock, target = _targets(spec, d)
    th_j, m_j = (pad_chains(jnp.asarray(a, f32), LANE) for a in (theta, m))
    g_j = jax.grad(lambda th: jnp.sum(jblock(th)))(th_j)
    eps_j = (jnp.zeros((LANE,), f32).at[:d].set(jnp.asarray(eps, f32))
             if np.ndim(eps) else eps)
    nl_j = jnp.int32(3) if n_leaps == "dyn" else n_leaps
    out_j = j_leaps(jblock, th_j, m_j, g_j, eps_j, n_leaps=nl_j,
                    block_chains=C, interpret=True, integrator=integ)

    th_t, m_t = torch.as_tensor(theta), torch.as_tensor(m)
    _, g_t = tk.target_funcs(target)[1](th_t)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j)[:, :d],
                               rtol=1e-5, atol=1e-6)
    tk.reset_counts()
    nl_t = torch.tensor(3) if n_leaps == "dyn" else n_leaps
    eps_t = torch.as_tensor(eps, dtype=torch.float32) if np.ndim(eps) else eps
    out_t = tk.fused_target_leapfrogs(target, th_t, m_t, g_t, eps_t,
                                      n_leaps=nl_t, integrator=integ)
    assert tk.PLAIN_CALLS["target_leapfrogs"] == 1
    for a, b in zip(out_t[:3], out_j[:3]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b)[:, :d],
                                   rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(out_t[3].numpy(), np.asarray(out_j[3]),
                               rtol=1e-5, atol=1e-5)


def test_trajectory_leaving_the_support_matches_pallas():
    """A Gamma trajectory that leaves the support: lp -inf in both, the
    gradient 0 outside, and theta, m, g as in the Pallas kernel."""
    import jax
    import jax.numpy as jnp
    from mcmc_jl_tpu.ops.pallas_glm import LANE, pad_chains
    from mcmc_jl_tpu.ops.pallas_target import fused_target_leapfrogs as j_leaps

    f32 = jnp.float32
    d, C = 4, 8
    rng = np.random.default_rng(9)
    theta = (0.05 + 0.01 * np.abs(rng.standard_normal((C, d)))).astype(
        np.float32)
    m = (-4.0 - np.abs(rng.standard_normal((C, d)))).astype(np.float32)
    jblock, target = _targets(("Gamma", (3.0, 0.2), 0.5), d)
    th_j, m_j = (pad_chains(jnp.asarray(a, f32), LANE) for a in (theta, m))
    g_j = jax.grad(lambda th: jnp.sum(jblock(th)))(th_j)
    out_j = j_leaps(jblock, th_j, m_j, g_j, 0.05, n_leaps=5, block_chains=C,
                    interpret=True)
    th_t = torch.as_tensor(theta)
    g_t = tk.target_funcs(target)[1](th_t)[1]
    out_t = tk.fused_target_leapfrogs(target, th_t, torch.as_tensor(m), g_t,
                                      0.05, n_leaps=5)
    assert np.all(np.isneginf(np.asarray(out_j[3])))
    assert torch.isneginf(out_t[3]).all()
    assert (out_t[2] == 0).all()
    for a, b in zip(out_t[:3], out_j[:3]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b)[:, :d],
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("spec,center", [
    (("Normal", (0.5, 2.0), 0.5), 0.3), (("Gamma", (2.0, 1.0), 0.5), 0.3)],
    ids=["normal", "gamma_out_of_support_rejects"])
def test_rwm_steps_match_pallas_interpret(spec, center):
    """The same z and log u: the port takes them as (C, k, d) and (C, k),
    JAX in its lane layout (C, k * 128) for both."""
    import jax.numpy as jnp
    from mcmc_jl_tpu.ops.pallas_glm import LANE, pad_chains
    from mcmc_jl_tpu.ops.pallas_rwm import fused_target_rwm_steps as j_rwm

    f32 = jnp.float32
    d, C, K = 4, 8, 6
    rng = np.random.default_rng(0)
    theta = (center + 0.3 * rng.standard_normal((C, d))).astype(np.float32)
    theta = np.abs(theta) if spec[0] == "Gamma" else theta
    z = rng.standard_normal((C, K * LANE)).astype(np.float32)
    logu = np.log(rng.random((C, K))).astype(np.float32)
    jblock, target = _targets(spec, d)
    scale_j = jnp.zeros((1, LANE), f32).at[0, :d].set(0.7)
    th_j, lp_j, acc_j = j_rwm(
        jblock, pad_chains(jnp.asarray(theta), LANE), scale_j, k_steps=K,
        z=jnp.asarray(z), logu=jnp.repeat(jnp.asarray(logu), LANE, axis=1),
        block_chains=C, interpret=True, noise="input")
    z_t = torch.as_tensor(z.reshape(C, K, LANE)[:, :, :d].copy())
    th_t, lp_t, acc_t = rk.fused_target_rwm_steps(
        target, torch.as_tensor(theta), torch.full((d,), 0.7), k_steps=K,
        z=z_t, logu=torch.as_tensor(logu), noise="input")
    np.testing.assert_allclose(th_t.numpy(), np.asarray(th_j)[:, :d],
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(lp_t.numpy(), np.asarray(lp_j), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(acc_t.numpy(), np.asarray(acc_j), atol=1e-6)
    if spec[0] == "Gamma":
        assert torch.isfinite(lp_t).all() and (th_t > 0).all()


def _z_exact(x, mu, sd):
    """|mean - mu| / se over independent draws (all coordinates pooled:
    the targets are separable)."""
    x = np.asarray(x, dtype=np.float64).reshape(-1)
    return abs(x.mean() - mu) / (sd / math.sqrt(x.size))


@pytest.mark.parametrize("name,params,x0,eps", [
    ("Gamma", (3.0, 0.2), 0.6, 0.05), ("Normal", (1.0, 1.0), 1.0, 0.3)])
def test_multistep_statistics(name, params, x0, eps):
    """Kernel 6's plain version (the JAX kernel draws on the TPU's hardware
    PRNG and has no CPU lowering): run_target_hmc_multistep's final states
    against the exact first and second moments, and against JAX
    run_target_hmc (interpret mode) from the same start."""
    from mcmc_jl_tpu.models import distributions as jd
    from mcmc_jl_tpu.ops.pallas_target import coordwise_logp as j_coordwise
    from mcmc_jl_tpu.ops.pallas_target import run_target_hmc as j_run_hmc

    d, C = 3, 256
    dist = getattr(td, name)(*params)
    mu, sd = float(dist.mean()), float(dist.std())
    target = tk.coordwise_logp(dist, d)
    tk.reset_counts()
    th, infos = tk.run_target_hmc_multistep(
        target, d, C, 200, thin=10, n_leaps=5, eps=eps, seed=1,
        inits=np.full((C, d), x0, np.float32), device="cpu")
    assert tk.PLAIN_CALLS["target_multistep"] == 20
    assert infos["accept_rate"].shape == (20, C)
    assert _z_exact(th, mu, sd) < Z_MAX
    assert _z_exact(th ** 2, mu * mu + sd * sd,
                    float(np.std(th.numpy() ** 2))) < Z_MAX
    jdist = getattr(jd, name)(*params)
    jth, _ = j_run_hmc(j_coordwise(lambda x: jdist.logpdf(x), d, safe=x0),
                       d, 32, 60, n_leaps=5, eps=eps, seed=2,
                       inits=np.full((32, d), x0, np.float32), interpret=True)
    a, b = th.numpy().reshape(-1), np.asarray(jth).reshape(-1)
    se = math.sqrt(a.var() / a.size + b.var() / b.size)
    assert abs(a.mean() - b.mean()) / se < Z_MAX
    # the plain version with injected noise is the same function of it
    g = torch.Generator().manual_seed(3)
    th0 = torch.full((16, d), x0)
    noise = (torch.randn((4, 16, d), generator=g),
             torch.log(torch.rand((4, 16), generator=g)))
    r1 = tk.target_multistep_ref(target, th0, eps, k_trans=4, n_leaps=5,
                                 noise=noise)
    r2 = tk.target_multistep_ref(target, th0, eps, k_trans=4, n_leaps=5,
                                 noise=noise)
    assert all(torch.equal(x, y) for x, y in zip(r1, r2))


def test_multistep_ref_matches_pallas_transitions():
    """Kernel 6's plain version on injected noise, chain by chain, against
    k transitions composed from the JAX package's
    ``fused_target_leapfrogs(interpret=True)`` and the accept rule of
    ``pallas_target.py:232-251`` (H from lp and |m|^2, NaN rejected), on
    the same float32 momenta and log-uniforms: d 10 over six families, 16
    chains.  theta, grad and lp within rtol 1e-5 and atol 1e-5, the same
    accept rate on every chain."""
    import jax
    import jax.numpy as jnp
    from mcmc_jl_tpu.ops.pallas_glm import LANE, pad_chains
    from mcmc_jl_tpu.ops.pallas_target import fused_target_leapfrogs as j_leaps

    f32 = jnp.float32
    d, C, k, n_leaps, eps = 10, 16, 4, 5, 0.15
    spec = [MIXED[j % len(MIXED)] for j in range(d)]
    center = np.resize([0.5, 0.6, 0.4, 0.0, 0.0, 1.8], d)
    spread = np.resize([1.0, 0.05, 0.05, 1.0, 1.0, 0.3], d)
    rng = np.random.default_rng(12)
    theta = (center + spread * rng.standard_normal((C, d))).astype(np.float32)
    z = rng.standard_normal((k, C, d)).astype(np.float32)
    logu = np.log1p(-rng.random((k, C))).astype(np.float32)
    jblock, target = _targets(spec, d)

    def logp_grad(th):
        lp, vjp = jax.vjp(jblock, th)
        return lp[:, 0], vjp(jnp.ones_like(lp))[0]

    th_j = pad_chains(jnp.asarray(theta, f32), LANE)
    lp_j, g_j = logp_grad(th_j)
    acc_j = jnp.zeros((C,), f32)
    for t in range(k):
        m0 = pad_chains(jnp.asarray(z[t], f32), LANE)
        h0 = -lp_j + 0.5 * jnp.sum(m0 * m0, axis=1)
        th_p, m, g_p, lp_p = j_leaps(jblock, th_j, m0, g_j, eps,
                                     n_leaps=n_leaps, block_chains=C,
                                     interpret=True)
        ratio = h0 - (-lp_p + 0.5 * jnp.sum(m * m, axis=1))
        ratio = jnp.where(jnp.isnan(ratio), -jnp.inf, ratio)
        a = (ratio > 0) | (ratio > logu[t])
        th_j = jnp.where(a[:, None], th_p, th_j)
        g_j = jnp.where(a[:, None], g_p, g_j)
        lp_j = jnp.where(a, lp_p, lp_j)
        acc_j = acc_j + a.astype(f32)

    tk.reset_counts()
    out = tk.target_multistep_ref(target, torch.as_tensor(theta), eps,
                                  k_trans=k, n_leaps=n_leaps,
                                  noise=(torch.as_tensor(z),
                                         torch.as_tensor(logu)))
    assert tk.PLAIN_CALLS["target_multistep"] == 1
    acc = np.asarray(acc_j) / k
    assert 0.0 < acc.mean() < 1.0  # both outcomes of the test occur
    np.testing.assert_array_equal(out[3].numpy(), acc)
    for a, b in zip(out[:2], (th_j, g_j)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b)[:, :d],
                                   rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out[2].numpy(), np.asarray(lp_j), rtol=1e-5,
                               atol=1e-5)


def test_run_target_rwm_statistics():
    d, C = 3, 128
    target = tk.coordwise_logp(td.Normal(0.5, 2.0), d)
    rk.reset_counts()
    th, infos = rk.run_target_rwm(target, d, C, 600, scale=1.2, thin=10,
                                  seed=4, device="cpu")
    assert rk.PLAIN_CALLS["target_rwm_steps"] == 60
    assert infos["ppars"].shape == (60, C, d)
    acc = float(infos["accept_rate"].mean())
    assert 0.1 < acc < 0.9
    assert _z_exact(th, 0.5, 2.0) < Z_MAX


# Random123's known-answer vectors for Philox4x32-10: (counter, key words
# (k0, k1), output)
PHILOX_KAT = [
    ((0, 0, 0, 0), (0, 0),
     (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF, 0xFFFFFFFF),
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


@pytest.mark.parametrize("ctr, key, want", PHILOX_KAT,
                         ids=["zeros", "ones", "pi"])
def test_philox_replay_known_answers(ctr, key, want):
    """The host replay of csrc/philox.cuh is Philox4x32-10; the 64-bit
    launch seed's low word is k0."""
    got = philox.philox4x32(ctr, key[0] | (key[1] << 32))
    assert tuple(int(x) for x in got) == want


def test_kernel_draws_replayed():
    """The replayed draws of the multi-transition and RWM kernels: their
    layouts, counters absolute over launches and apart between the two
    kernels, N(0, 1) normals and log(1 - U) uniforms, and the plain
    versions taking them."""
    C, d, k, seed = 256, 5, 4, 7
    z, logu = tk.target_multistep_draws(seed, C, d, k, i0=3)
    assert z.shape == (k, C, d) and logu.shape == (k, C)
    assert z.dtype == logu.dtype == torch.float32
    b = philox.philox4x32((17, 3 + 2, 4, 0), seed)
    assert z[2, 17, 4] == torch.tensor(philox.box_muller(b[0], b[1]))
    z1, logu1 = tk.target_multistep_draws(seed, C, d, 1, i0=4)
    assert torch.equal(z1[0], z[1]) and torch.equal(logu1[0], logu[1])
    zr, logur = rk.rwm_draws(seed, C, d, k, i0=3)
    assert zr.shape == (C, k, d) and logur.shape == (C, k)
    assert not bool((zr.transpose(0, 1) == z).any())
    zs = torch.cat([z.reshape(-1), zr.reshape(-1)]).double()
    es = -torch.cat([logu.reshape(-1), logur.reshape(-1)]).double()  # Exp(1)
    assert float(zs.mean().abs()) * math.sqrt(zs.numel()) < Z_MAX
    assert abs(float(zs.var()) - 1.0) < Z_MAX * math.sqrt(2.0 / zs.numel())
    assert abs(float(es.mean()) - 1.0) * math.sqrt(es.numel()) < Z_MAX
    target = tk.coordwise_logp(td.Normal(0.0, 1.0), d)
    th0 = torch.zeros((C, d))
    out = tk.target_multistep_ref(target, th0, 0.3, k_trans=k, n_leaps=3,
                                  noise=(z, logu))
    assert all(bool(torch.isfinite(o).all()) for o in out)
    out = rk.fused_target_rwm_steps_ref(target, th0, torch.ones(d),
                                        k_steps=k, z=zr, logu=logur)
    assert all(bool(torch.isfinite(o).all()) for o in out)


def _catalog_model(dist, x0, d=3):
    return mt.model(lambda x: mt.tilde(x, dist), x=np.full(d, x0),
                    gradient=True, device="cpu")


def test_run_takes_the_target_route():
    """run(..., fused=True) on a DSL catalog model: the trajectory kernel's
    plain version once per transition; the same noise as the generic
    engine, so the two give the same chains; plain MALA too."""
    m = _catalog_model(td.Gamma(3.0, 0.2), 1.1)
    task = m * mt.HMC(5, 0.05) * mt.SerialMC(steps=20, burnin=5)
    tk.reset_counts()
    cs = mt.run(task, chains=16, seed=3, fused=True)
    assert tk.PLAIN_CALLS["target_leapfrogs"] == 20
    cg = mt.run(task, chains=16, seed=3, fused=False)
    a = np.stack([c.samples.values for c in cs])
    b = np.stack([c.samples.values for c in cg])
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    c1 = mt.resume(cs[0], steps=5)
    assert c1.samples.values.shape == (5, 3)

    tk.reset_counts()
    cm = mt.run(m * mt.MALA(0.02) * mt.SerialMC(steps=30, burnin=10),
                chains=8, seed=1, fused=True)
    assert tk.PLAIN_CALLS["target_leapfrogs"] == 30
    assert isinstance(cm[0].task.state, mt.MALAState)
    assert np.all(np.isfinite(cm[0].samples.values))


def test_target_route_statistics():
    """Plain HMC through the target route against the exact moments."""
    dist = td.Normal(1.0, 1.0)
    m = _catalog_model(dist, 1.5)
    cs = mt.run(m * mt.HMC(10, 0.3) * mt.SerialMC(steps=150, burnin=50),
                chains=128, seed=0, fused=True)
    means = np.stack([c.samples.values.mean(0) for c in cs])
    se = means.std(0) / math.sqrt(len(means))
    assert np.all(np.abs(means.mean(0) - 1.0) / se < Z_MAX)


def test_opaque_model_runs_generic_with_a_reason(caplog):
    def ex(x):
        y = 2.0 * x
        mt.tilde(y, mt.Gamma(3.0, 0.2))

    m = mt.model(ex, x=np.full(3, 0.3), gradient=True, device="cpu")
    tk.reset_counts()
    with caplog.at_level(logging.INFO,
                         logger="mcmc_jl_tpu_torch.parallel.pchains"):
        cs = mt.run(m * mt.HMC(5, 0.05) * mt.SerialMC(steps=10), chains=4,
                    fused=True)
    assert tk.PLAIN_CALLS["target_leapfrogs"] == 0
    assert "not a product of catalog densities" in caplog.text
    assert len(cs) == 4


def test_wrappers_refuse_what_the_kernels_cannot_take():
    """What would raise for a CUDA tensor: a target without kernel rows, a
    d that is not the target's or above D_MAX, a wrong dtype."""
    th = torch.zeros((4, 3))
    rowless = tk.coordwise_logp(lambda x: -x * x, 3)
    assert not rowless.has_rows and rowless(th).shape == (4, 1)
    with pytest.raises(ValueError, match="no kernel rows"):
        tk.kernel_args("target_leapfrogs", rowless, th)
    ok = tk.coordwise_logp(td.Normal(0.0, 1.0), 3)
    with pytest.raises(ValueError, match="d = 3"):
        tk.kernel_args("target_leapfrogs", ok, torch.zeros((4, 5)))
    with pytest.raises(ValueError, match="float32"):
        tk.kernel_args("target_leapfrogs", ok, th, (("m", th.double()),))
    big = tk.coordwise_logp(td.Normal(0.0, 1.0), tk.D_MAX + 1)
    with pytest.raises(ValueError, match="1..1024"):
        tk.kernel_args("target_leapfrogs", big, torch.zeros((2, tk.D_MAX + 1)))
    model_t = tk.model_block_fn(_catalog_model(td.Normal(0.0, 1.0), 0.1))
    assert model_t.has_rows


def test_rwm_generic_engine_matches_jax():
    """RWM on the generic engine against the JAX package's RWM: pooled
    per-chain means and acceptance within |z| < 5, and the exact mean."""
    import mcmc_jl_tpu as mc

    C, steps, burnin = 64, 600, 100
    jm = mc.model(lambda x: mc.tilde(x, mc.Normal(1.0, 2.0)), x=np.zeros(2))
    tm = mt.model(lambda x: mt.tilde(x, mt.Normal(1.0, 2.0)), x=np.zeros(2),
                  device="cpu")
    cj = mc.run(jm * mc.RWM(1.5) * mc.SerialMC(steps=steps, burnin=burnin),
                chains=C, seed=0)
    ct = mt.run(tm * mt.RWM(1.5) * mt.SerialMC(steps=steps, burnin=burnin),
                chains=C, seed=0)
    for stat in (lambda c: np.asarray(c.samples.values).mean(0),
                 lambda c: np.array([mt.acceptance(c)])):
        a = np.stack([stat(c) for c in ct])
        b = np.stack([stat(c) for c in cj])
        se = np.sqrt(a.var(0) / C + b.var(0) / C)
        assert np.all(np.abs(a.mean(0) - b.mean(0)) / se < Z_MAX)
    means = np.stack([c.samples.values.mean(0) for c in ct])
    assert np.all(np.abs(means.mean(0) - 1.0)
                  / (means.std(0) / math.sqrt(C)) < Z_MAX)
    assert isinstance(ct[0].task.state, mt.RWMState)


def test_distribution_and_state_converters():
    """distribution_from_fields rebuilds a JAX catalog distribution from its
    class name and numpy fields (scalars stay Python floats, so kernel rows
    survive); rwm_state_from_numpy a JAX RWMState."""
    import jax
    import jax.numpy as jnp

    import mcmc_jl_tpu as mc
    from mcmc_jl_tpu.models import distributions as jd
    from mcmc_jl_tpu.samplers.rwm import RWM as JRWM

    xs = np.linspace(0.05, 3.0, 9)
    for jdist in (jd.Gamma(3.0, 0.2), jd.Normal(jnp.asarray([0.0, 1.0]), 2.0),
                  jd.TDist(4.0), jd.Laplace(0.5, 1.5)):
        fields = dataclasses.asdict(jax.device_get(jdist))
        tdist = mt.distribution_from_fields(type(jdist).__name__,
                                            device="cpu", **fields)
        assert type(tdist).__name__ == type(jdist).__name__
        x = xs[:, None] if np.ndim(getattr(jdist, "mu", 0.0)) else xs
        np.testing.assert_allclose(
            tdist.logpdf(torch.as_tensor(x)).numpy(),
            np.asarray(jdist.logpdf(jnp.asarray(x))), rtol=1e-6)
    assert mt.distribution_from_fields("Gamma", shape=3.0,
                                       scale=0.2).kernel_row() is not None
    tr = mt.distribution_from_fields(
        "Truncated", base=("Normal", {"mu": 0.0, "sigma": 1.0}), lo=-1.0,
        hi=None, device="cpu")
    np.testing.assert_allclose(
        tr.logpdf(torch.as_tensor(xs)).numpy(),
        np.asarray(jd.Truncated(jd.Normal(0.0, 1.0), -1.0).logpdf(
            jnp.asarray(xs))), rtol=1e-6)
    with pytest.raises(ValueError, match="unknown distribution"):
        mt.distribution_from_fields("Nope")

    jm = mc.model(lambda x: mc.tilde(x, mc.Normal(0.0, 1.0)), x=np.zeros(2))
    st = jax.device_get(JRWM(0.5).init(jm, jnp.asarray([0.3, -0.2]), None))
    ts = mt.rwm_state_from_numpy({"pars": st.pars, "logtarget": st.logtarget,
                                  "i": st.i}, device="cpu")
    assert isinstance(ts, mt.RWMState) and ts.i.dtype == torch.int32
    np.testing.assert_allclose(ts.logtarget.numpy(), np.asarray(st.logtarget))


@pytest.mark.parametrize("d", [0, 1, 10, 32, 33, 1000, 1024, 1025])
@pytest.mark.parametrize("layout", [tk.target_leapfrogs_layout,
                                    rk.target_rwm_layout,
                                    tk.target_multistep_layout,
                                    tk.target_logp_grad_layout],
                         ids=["leapfrogs", "rwm", "multistep", "logp_grad"])
def test_layout_by_d(layout, d):
    """Kernels 5, 7 and 6 and the gradient pass choose their layout up
    front from d alone: one chain
    per lane for 1 <= d <= LANE_D_MAX (32), one warp per chain up to D_MAX;
    0 and D_MAX + 1 are refused.  The CUDA sources draw the line at the
    same d (each library reports it when it loads, and load_library
    refuses a mismatch)."""
    if not 1 <= d <= tk.D_MAX:
        with pytest.raises(ValueError, match="outside"):
            layout(d)
        return
    assert layout(d) == ("lane" if d <= tk.LANE_D_MAX else "warp")
    src = (pathlib.Path(tk.__file__).parent.parent / "csrc" /
           "target_lane.cuh").read_text()
    assert f"constexpr int kLaneDMax = {tk.LANE_D_MAX};" in src


def _lean_run(kernel, lean):
    """kernel 5's, 7's or 6's driver on the CPU, through its launcher (lean)
    or through the public wrapper once per launch, from one generator
    state; the gradient pass through the model's launcher
    (``models/model.py`` ``_catalog_allg``, which builds it at its first
    call) or through the public wrapper."""
    d, C = 4, 16
    target = tk.coordwise_logp([td.Normal(0.5, 2.0), td.Gamma(3.0, 0.2),
                                td.Laplace(0.0, 1.0), td.TDist(4.0)], d)
    theta0 = torch.as_tensor(np.full((C, d), 0.6, np.float32))
    gen = torch.Generator().manual_seed(11)
    if kernel == "multistep":
        if lean:
            th, infos = tk.run_target_hmc_multistep(
                target, d, C, 12, thin=4, n_leaps=5, eps=0.05, generator=gen,
                inits=theta0, device="cpu", collect=True)
            return (th, infos["plogtarget"], infos["accept_rate"],
                    infos["pgrads"])
        th, rows = theta0, []
        for i in range(3):
            th, g, lp, acc = tk.target_multistep(target, th, 0.05, k_trans=4,
                                                 n_leaps=5, generator=gen,
                                                 i0=4 * i)
            rows.append((lp, acc, g))
        return (th, *(torch.stack(r) for r in zip(*rows)))
    if kernel == "logp_grad":
        from mcmc_jl_tpu_torch.models.model import _catalog_allg

        ths = [theta0 + 0.1 * torch.randn((C, d), generator=gen)
               for _ in range(3)]
        if lean:
            allg = _catalog_allg(target)
            return tuple(x for th in ths
                         for x in allg(th.reshape(2, C // 2, d)))
        return tuple(x.reshape((2, C // 2) + x.shape[1:]) for th in ths
                     for x in tk.target_logp_grad(target, th))
    if kernel == "leapfrogs":
        if lean:
            (th, lp, g), infos = tk._run(target, theta0, 0.05, gen, steps=6,
                                         n_leaps=5, collect=True)
            return th, lp, g, infos["accept"]
        th, accepts = theta0, []
        lp, g = tk.target_funcs(target)[1](th)
        for _ in range(6):
            m0, logu = tk._draw(th, gen)
            p_th, p_m, p_g, p_lp = tk.fused_target_leapfrogs(
                target, th, m0, g, 0.05, n_leaps=5)
            a = tk.accept_test(-lp + 0.5 * (m0 * m0).sum(-1),
                               -p_lp + 0.5 * (p_m * p_m).sum(-1), logu)
            th = torch.where(a[:, None], p_th, th)
            g = torch.where(a[:, None], p_g, g)
            lp = torch.where(a, p_lp, lp)
            accepts.append(a)
        return th, lp, g, torch.stack(accepts)
    scale = torch.full((d,), 0.8)
    if lean:
        th, infos = rk._run(target, theta0, scale, gen, n_launches=3,
                            k_steps=4, noise="input")
        return th, infos["plogtarget"], infos["accept_rate"]
    th, lps, accs = theta0, [], []
    for i in range(3):
        z, logu = rk._noise((C, 4, d), gen, torch.float32, "cpu")
        th, lp, acc = rk.fused_target_rwm_steps(target, th, scale, k_steps=4,
                                                z=z, logu=logu,
                                                noise="input", i0=4 * i)
        lps.append(lp)
        accs.append(acc)
    return th, torch.stack(lps), torch.stack(accs)


@pytest.mark.parametrize("kernel", ["leapfrogs", "rwm", "multistep",
                                    "logp_grad"])
def test_lean_driver_matches_the_public_wrapper(kernel):
    """The drivers launch through a launcher that validates a run once
    (``leapfrogs_launcher``, ``rwm_launcher``, ``multistep_launcher``), and
    the model's gradient through ``logp_grad_launcher``: on the CPU, where
    both take the plain version, a driver's run (a model gradient's calls)
    equals the same run made through the public wrapper call by call,
    bitwise."""
    lean, public = _lean_run(kernel, True), _lean_run(kernel, False)
    assert all(torch.equal(a, b) for a, b in zip(lean, public))


@pytest.mark.parametrize("bad", ["float64", "shape", "strided"])
@pytest.mark.parametrize("kernel", ["leapfrogs", "rwm", "multistep",
                                    "logp_grad"])
def test_lean_launchers_refuse_a_malformed_state(kernel, bad):
    """The launchers check a run's state once, on the CPU too (the gradient
    pass's launcher at each call, where theta can change): a float64, a
    (C, d + 1) or a non-contiguous theta is refused."""
    target = tk.coordwise_logp(td.Normal(0.0, 1.0), 3)
    theta = {"float64": torch.zeros((8, 3), dtype=torch.float64),
             "shape": torch.zeros((8, 4)),
             "strided": torch.zeros((3, 8)).t()}[bad]
    with pytest.raises(ValueError, match="float32|d = 3"):
        if kernel == "leapfrogs":
            tk.leapfrogs_launcher(target, theta, 0.1)
        elif kernel == "rwm":
            rk.rwm_launcher(target, theta, torch.ones(3), k_steps=2)
        elif kernel == "multistep":
            tk.multistep_launcher(target, theta, 0.1)
        else:
            tk.logp_grad_launcher(target, "cpu")(theta)


@pytest.mark.parametrize("i0", [0, 1, 3, 6])
def test_rwm_draws_known_answers(i0):
    """rwm_draws lays out the RWM kernel's four-steps-a-call draws: the
    normal of absolute step t and coordinate j is the Box-Muller pair of
    words (0, 1) (t % 4 < 2) or (2, 3) of Philox4x32-10 at (chain, t // 4,
    j, 2), its cosine branch at even t and its sine branch at odd t; the
    log-uniform is log(1 - u) of word t % 4 at (chain, t // 4, 0, 3).  Held
    entry by entry against the host Philox (itself held to Random123's
    known answers) in double precision, and the cosine branch against
    ``philox.box_muller``."""
    C, d, k, seed = 5, 3, 7, 0x243F6A8885A308D3
    z, logu = rk.rwm_draws(seed, C, d, k, i0=i0)
    assert z.shape == (C, k, d) and logu.shape == (C, k)
    for c in range(C):
        for s in range(k):
            t = i0 + s
            u = philox.philox4x32((c, t // 4, 0, 3), seed)
            want_u = math.log(1.0 - (int(u[t % 4]) >> 8) / 2.0 ** 24)
            assert logu[c, s].item() == pytest.approx(want_u, rel=1e-6,
                                                      abs=1e-7)
            for j in range(d):
                b = [int(w) for w in philox.philox4x32((c, t // 4, j, 2),
                                                       seed)]
                w1, w2 = (b[2], b[3]) if t % 4 >= 2 else (b[0], b[1])
                r = math.sqrt(-2.0 * math.log(1.0 - (w1 >> 8) / 2.0 ** 24))
                ang = 2.0 * math.pi * (w2 >> 8) / 2.0 ** 24
                want = r * (math.sin(ang) if t % 2 else math.cos(ang))
                assert z[c, s, j].item() == pytest.approx(want, rel=1e-6,
                                                          abs=1e-6)
                if t % 2 == 0:
                    cos = philox.box_muller(np.uint32(w1), np.uint32(w2))
                    assert z[c, s, j].item() == float(cos)


def _min_gap(target, th, scale, z, logu):
    """The smallest |MH ratio - log u| over the steps of the chains ``th``
    on the draws ``z`` (C, k, d), ``logu`` (C, k), as the plain version
    takes them (NaN ratios reject)."""
    lp = target(th)[:, 0]
    gap = torch.full(lp.shape, float("inf"), device=th.device)
    for s in range(z.shape[1]):
        prop = th + scale * z[:, s]
        lp_p = target(prop)[:, 0]
        ratio = lp_p - lp
        ratio = torch.where(torch.isnan(ratio), -torch.inf, ratio)
        gap = torch.minimum(gap, (ratio - logu[:, s]).abs())
        a = (ratio > 0) | (ratio > logu[:, s])
        th = torch.where(a[:, None], prop, th)
        lp = torch.where(a, lp_p, lp)
    return float(gap.max())


def _ms_min_gap(target, th, eps, z, logu, n_leaps):
    """The smallest |MH ratio - log u| over the transitions of the chains
    ``th`` on the momenta ``z`` (k, C, d) and ``logu`` (k, C), as the plain
    version takes them (NaN ratios reject)."""
    lp, g = tk.target_funcs(target)[1](th)
    gap = torch.full(lp.shape, float("inf"), device=th.device)
    for t in range(z.shape[0]):
        th_p, m, g_p, lp_p = tk.fused_target_leapfrogs_ref(
            target, th, z[t], g, eps, n_leaps=n_leaps)
        ratio = (-lp + 0.5 * (z[t] * z[t]).sum(-1)) - (
            -lp_p + 0.5 * (m * m).sum(-1))
        ratio = torch.where(torch.isnan(ratio), -torch.inf, ratio)
        gap = torch.minimum(gap, (ratio - logu[t]).abs())
        a = (ratio > 0) | (ratio > logu[t])
        th = torch.where(a[:, None], th_p, th)
        g = torch.where(a[:, None], g_p, g)
        lp = torch.where(a, lp_p, lp)
    return float(gap.max())


def test_target_lanes_on_card():
    """Kernels 5 and 7 in every layout they launch against their plain
    versions on a card (skips without one; chip_smoke.py runs the same
    checks at the paths' shapes and their edges): the ten families cycled
    over d 10 and 32 (one chain per lane) and d 40 (one warp per chain); C
    397 (a ragged last group).  At d <= 32 kernel 5 also runs on the same
    chains tiled to more groups of 32 than the card has SMs, where it takes
    four warps a block in place of D, and its theta, m and g must come out
    bitwise the same.
    Kernel 5: theta, m and g within rtol and atol 1e-4 (the family
    formulas' rounding grown over 10 leapfrogs), lp within 1e-5 relative
    and 1e-5 per coordinate (a sum in another order), -inf at the same
    chains.  Kernel 7 on input noise and on its own Philox draws replayed
    from step 3 (``rwm_draws``): every chain's theta within 1e-4 (1 +
    |theta|) with the same accept count, or a step whose MH ratio lay
    within 1e-4 of log u; the Philox run repeats bitwise.
    At C 4099 (a ragged last group and more groups than SMs): kernel 6 at
    d 10 (one chain per lane) and 33 (one warp per chain) on its own Philox
    draws replayed by ``target_multistep_draws``, every chain's theta within
    1e-3 (1 + |theta|) with the same accept count, or a transition whose MH
    ratio lay within 1e-4 of log u, and a bitwise repeat; the gradient pass
    at d 1, 10, 32 and 33 within rtol and atol 1e-4 (g) and lp as kernel
    5's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    fams = [td.Normal(0.0, 1.0), td.Uniform(-1.0, 3.0), td.Exponential(2.0),
            td.Gamma(2.0, 1.5), td.Weibull(1.5, 2.0), td.Cauchy(0.0, 1.0),
            td.LogNormal(0.0, 0.5), td.Beta(2.0, 3.0), td.Laplace(0.0, 1.0),
            td.TDist(5.0)]
    x0 = np.array([0.0, 1.0, 2.0, 3.0, 1.8, 0.0, 1.1, 0.4, 0.0, 0.0])
    sd = np.array([1.0, 1.0, 2.0, 2.0, 1.0, 1.0, 0.5, 0.2, 1.0, 1.0])
    C, k, tol, tiles = 397, 12, 1e-4, 16  # 13 groups of 32; 16 x 397: 199
    rng = np.random.default_rng(5)

    def cu(a):
        return torch.as_tensor(a, dtype=torch.float32).cuda().contiguous()

    def gen():
        return torch.Generator(device="cuda").manual_seed(77)

    for d in (10, 32, 40):
        target = tk.coordwise_logp([fams[j % 10] for j in range(d)], d)
        c0, s = np.resize(x0, d), np.resize(sd, d)
        th = cu(c0 + 0.05 * s * rng.standard_normal((C, d)))
        m = cu(rng.standard_normal((C, d)))
        g = tk.target_funcs(target)[1](th)[1].contiguous()
        row = cu(0.02 * s)
        ref = tk.fused_target_leapfrogs_ref(target, th, m, g, row,
                                            n_leaps=10)
        fin = torch.isfinite(ref[3])
        outs = []
        for r in (1, tiles) if d <= tk.LANE_D_MAX else (1,):
            out = tk.fused_target_leapfrogs(
                target, th.repeat(r, 1), m.repeat(r, 1), g.repeat(r, 1),
                row, n_leaps=10)
            for a, b in zip(out[:3], ref[:3]):
                assert torch.allclose(a, b.repeat(r, 1), rtol=tol,
                                      atol=tol), (d, r)
            assert torch.equal(fin.repeat(r), torch.isfinite(out[3])), (d, r)
            assert torch.allclose(out[3][fin.repeat(r)], ref[3][fin].repeat(r),
                                  rtol=1e-5, atol=1e-5 * d), (d, r)
            outs.append(out)
        if len(outs) == 2:
            assert (tk.target_leapfrogs_plan(d, C)["warps"]
                    != tk.target_leapfrogs_plan(d, C * tiles)["warps"])
            assert all(torch.equal(a[:C], b)
                       for a, b in zip(outs[1][:3], outs[0][:3])), d

        scale = cu(0.5 * s)
        noises = {"input": (cu(rng.standard_normal((C, k, d))),
                            cu(np.log1p(-rng.random((C, k))))),
                  "hw": rk.rwm_draws(tk._seed(gen()), C, d, k, i0=3,
                                     device="cuda")}
        for noise, (z, logu) in noises.items():
            if noise == "input":
                out = rk.fused_target_rwm_steps(target, th, scale, k_steps=k,
                                                z=z, logu=logu, noise=noise)
            else:
                def run():
                    return rk.fused_target_rwm_steps(
                        target, th, scale, k_steps=k, noise=noise, i0=3,
                        generator=gen())
                out, again = run(), run()
                assert all(torch.equal(a, b) for a, b in zip(out, again))
            ref = rk.fused_target_rwm_steps_ref(target, th, scale, k_steps=k,
                                                z=z, logu=logu)
            same = ((torch.round(out[2] * k) == torch.round(ref[2] * k))
                    & ((out[0] - ref[0]).abs()
                       <= tol * (1 + ref[0].abs())).all(1))
            parted = (~same).nonzero()[:, 0]
            if len(parted):
                assert _min_gap(target, th[parted], scale, z[parted],
                                logu[parted]) < tol, (d, noise)

    C2, k6 = 4099, 5
    for d in (1, 10, 32, 33):
        target = tk.coordwise_logp([fams[j % 10] for j in range(d)], d)
        c0, s = np.resize(x0, d), np.resize(sd, d)
        th = cu(c0 + 0.05 * s * rng.standard_normal((C2, d)))
        lp_k, g_k = tk.target_logp_grad(target, th)
        lp_r, g_r = tk.target_logp_grad_ref(target, th)
        assert torch.allclose(g_k, g_r, rtol=tol, atol=tol), d
        assert torch.equal(torch.isfinite(lp_k), torch.isfinite(lp_r)), d
        fin = torch.isfinite(lp_r)
        assert torch.allclose(lp_k[fin], lp_r[fin], rtol=1e-5,
                              atol=1e-5 * d), d
        if d not in (10, 33):
            continue
        row = cu(0.02 * s)

        def run():
            return tk.target_multistep(target, th, row, k_trans=k6,
                                       n_leaps=10, generator=gen())
        out, again = run(), run()
        assert all(torch.equal(a, b) for a, b in zip(out, again)), d
        z, logu = tk.target_multistep_draws(tk._seed(gen()), C2, d, k6,
                                            device="cuda")
        ref = tk.target_multistep_ref(target, th, row, k_trans=k6,
                                      n_leaps=10, noise=(z, logu))
        same = ((torch.round(out[3] * k6) == torch.round(ref[3] * k6))
                & ((out[0] - ref[0]).abs()
                   <= 1e-3 * (1 + ref[0].abs())).all(1))
        parted = (~same).nonzero()[:, 0]
        if len(parted):
            assert _ms_min_gap(target, th[parted], row, z[:, parted],
                               logu[:, parted], 10) < tol, d
