"""The port's custom-target kernels' plain versions
(mcmc_jl_tpu_torch/ops/target_kernels.py, ops/rwm_kernels.py) against the
JAX package's Pallas kernels (mcmc_jl_tpu/ops/pallas_target.py,
pallas_rwm.py) run in interpret mode on the CPU, on the same numpy inputs
and injected noise; the multi-transition kernel (hardware PRNG in JAX) and
the three entry points statistically; the host replay of the kernels'
Philox draws (ops/philox.py) against Philox4x32-10's known answers; the
"target" route of ``run(..., chains=N)``; RWM on the generic engine; the
converters.

On the CPU the wrappers run their plain versions; the CUDA kernels are held
against those on the card by chip_smoke.py.  JAX's inputs are padded to
128 lanes and unpadded after.  Tolerances: rtol 1e-5 and atol 1e-6 for
theta, m and g, 1e-5 for lp (the JAX package's own gate,
tests/test_pallas_target.py:53-60); RWM within tests/test_pallas_rwm.py's
gates; statistical gates |z| < 5."""
import dataclasses
import logging
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mcmc_jl_tpu as mc
import mcmc_jl_tpu_torch as mt
from mcmc_jl_tpu.models import distributions as jd
from mcmc_jl_tpu.ops.pallas_glm import LANE, pad_chains
from mcmc_jl_tpu.ops.pallas_rwm import fused_target_rwm_steps as j_rwm
from mcmc_jl_tpu.ops.pallas_target import coordwise_logp as j_coordwise
from mcmc_jl_tpu.ops.pallas_target import fused_target_leapfrogs as j_leaps
from mcmc_jl_tpu.ops.pallas_target import run_target_hmc as j_run_hmc
from mcmc_jl_tpu_torch.models import distributions as td
from mcmc_jl_tpu_torch.ops import philox
from mcmc_jl_tpu_torch.ops import rwm_kernels as rk
from mcmc_jl_tpu_torch.ops import target_kernels as tk

torch.set_num_threads(1)
f32 = jnp.float32
Z_MAX = 5.0


def _jax_block(dists, safes):
    """A JAX logp_block with coordinate j ~ dists[j] (lanes past d zero)."""
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

    from mcmc_jl_tpu.samplers.rwm import RWM as JRWM
    jm = mc.model(lambda x: mc.tilde(x, mc.Normal(0.0, 1.0)), x=np.zeros(2))
    st = jax.device_get(JRWM(0.5).init(jm, jnp.asarray([0.3, -0.2]), None))
    ts = mt.rwm_state_from_numpy({"pars": st.pars, "logtarget": st.logtarget,
                                  "i": st.i}, device="cpu")
    assert isinstance(ts, mt.RWMState) and ts.i.dtype == torch.int32
    np.testing.assert_allclose(ts.logtarget.numpy(), np.asarray(st.logtarget))
