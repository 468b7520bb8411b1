"""The port's sharded drivers on the CPU: the three kernel drivers on their
kernels' plain versions, the warm pipeline, ``prun``/``resume`` and the
ensemble runners with ``mesh=``.

- ``run_glm_hmc_sharded`` (kernel 1) and ``run_target_hmc_sharded``
  (kernel 5): each shard's rows bitwise the unsharded driver on that
  shard's stream (``shard_seed(seed, i)``, the counterpart of
  ``fold_in(k_run, i)``), on a virtual mesh and on two distinct devices.
- ``run_glm_hmc_bign_sharded`` (kernel 4 a data shard, one packed psum a
  gradient): a (2, 4) mesh against the (1, 1) run at 2e-4, with and
  without weights and offsets, the last log-target against a float64
  direct evaluation at 1e-4 (tests/test_bign.py:130,160); the (1, 1) run
  against the unsharded driver on the same seed; a row and a matrix
  prior.
- The warm pipeline on a mesh against the unmeshed port run and against
  the JAX package's mesh run, by moments at 6 SE + 0.05, and ChEES's
  Halton lengths shared by every shard (tests/test_warmfused.py:508,537);
  ``run(..., chains=N, mesh=)`` on the NUTS route, ``resume(list,
  mesh=)``, and the generic and plain fused routes.
- PTMC and ASMC on a mesh in both packages, by the gates of
  tests/test_ptmc.py:96 and tests/test_asmc.py:99; ``run_until`` on a
  mesh through its fused continuation.
- The divisibility errors, with the JAX package's messages."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

import mcmc_jl_tpu as mc
import mcmc_jl_tpu_torch as mt
from mcmc_jl_tpu_torch.ops import glm_bign, glm_hmc, target_kernels
from mcmc_jl_tpu_torch.ops import warmstart as tws
from mcmc_jl_tpu_torch.parallel import collectives as col
from mcmc_jl_tpu_torch.parallel import mesh as tmesh
from mcmc_jl_tpu_torch.parallel.sharded import make_mesh
from mcmc_jl_tpu_torch.samplers.base import make_generator

torch.set_num_threads(1)
F64 = torch.float64
L2PI = float(np.log(2 * np.pi))
CPU4 = tmesh.Mesh(["cpu"] * 4, ("chains",))
THREADS = tmesh.Mesh(["cpu", "cpu:0"], ("chains",))


def _data(n, d, seed=3):
    rng = np.random.default_rng(seed)
    X = np.column_stack([np.ones(n), rng.standard_normal((n, d - 1))])
    beta = rng.standard_normal(d) * 0.7
    Y = (rng.random(n) < 1.0 / (1.0 + np.exp(-X @ beta))).astype(np.float64)
    return X, Y


def _direct(X, Y, theta, w=None, o=None, lam=1.0):
    z = X @ theta.T
    if o is not None:
        z = z + o[:, None]
    ll = z * Y[:, None] - np.logaddexp(0.0, z)
    if w is not None:
        ll = w[:, None] * ll
    lamv = np.asarray(lam) * np.ones(X.shape[1])
    return ll.sum(0) - 0.5 * (theta * theta * lamv).sum(1)


# -- kernels 1 and 5: per-shard bitwise -------------------------------------------

@pytest.mark.parametrize("mesh", [CPU4, THREADS], ids=["virtual", "threads"])
def test_glm_hmc_sharded_shards_bitwise(mesh):
    X, Y = _data(120, 4)
    n = mesh.shape["chains"]
    C = 3 * n
    inits = torch.tensor(np.random.default_rng(0).standard_normal((C, 4)),
                         dtype=torch.float32) * 0.1
    kw = dict(n_leaps=4, eps=0.1, kind="logistic", integrator="2stage")
    theta, infos = glm_hmc.run_glm_hmc_sharded(X, Y, C, 12, mesh=mesh,
                                               seed=7, inits=inits, **kw)
    assert theta.shape == (C, 4) and infos["plogtarget"].shape == (12, C)
    for i in range(n):
        sl = slice(3 * i, 3 * i + 3)
        th_i, inf_i = glm_hmc.run_glm_hmc(
            X, Y, 3, 12, generator=make_generator("cpu", tmesh.shard_seed(
                7, i)), inits=inits[sl], device="cpu", **kw)
        assert torch.equal(th_i, theta[sl]), i
        for k in inf_i:
            assert torch.equal(inf_i[k], infos[k][:, sl]), (i, k)
    # default inits: 0.1 standard normals from the seed's generator first
    th2, _ = glm_hmc.run_glm_hmc_sharded(X, Y, C, 2, mesh=mesh, seed=7,
                                         n_leaps=2)
    assert th2.shape == (C, 4) and torch.isfinite(th2).all()


@pytest.mark.parametrize("mesh", [CPU4, THREADS], ids=["virtual", "threads"])
def test_target_hmc_sharded_shards_bitwise(mesh):
    target = target_kernels.coordwise_logp(mt.Gamma(3.0, 0.2), 5)
    n = mesh.shape["chains"]
    C = 2 * n
    inits = torch.full((C, 5), 0.6)
    theta, infos = target_kernels.run_target_hmc_sharded(
        target, 5, C, 10, mesh=mesh, n_leaps=5, eps=0.05, seed=3,
        inits=inits)
    assert theta.shape == (C, 5) and infos["plogtarget"].shape == (10, C)
    for i in range(n):
        sl = slice(2 * i, 2 * i + 2)
        th_i, inf_i = target_kernels.run_target_hmc(
            target, 5, 2, 10, n_leaps=5, eps=0.05, generator=make_generator(
                "cpu", tmesh.shard_seed(3, i)), inits=inits[sl],
            device="cpu")
        assert torch.equal(th_i, theta[sl]), i
        for k in inf_i:
            assert torch.equal(inf_i[k], infos[k][:, sl]), (i, k)


# -- kernel 4: the (chains, data) mesh -----------------------------------------------

@pytest.mark.parametrize("extras", ["plain", "weights_offsets"])
def test_bign_sharded_data_axis_matches_single(extras):
    X, Y = _data(600, 5)
    kw = dict(n_chains=8, steps=40, n_leaps=3, eps=0.05, seed=0,
              collect=True)
    w = o = None
    if extras == "weights_offsets":
        rng = np.random.default_rng(2)
        w, o = rng.uniform(0.5, 1.5, 600), 0.1 * rng.standard_normal(600)
        kw.update(weights=w, offsets=o, seed=1)
    m24 = make_mesh(2, 4, devices=["cpu"] * 8)
    m11 = make_mesh(1, 1, devices=["cpu"])
    col.reset_counts()
    th_s, inf_s = glm_bign.run_glm_hmc_bign_sharded(X, Y, mesh=m24, **kw)
    assert col.PSUMS == {("data", (4, 6), "float32"): 2 * (1 + 40 * 3)}
    th_1, inf_1 = glm_bign.run_glm_hmc_bign_sharded(X, Y, mesh=m11, **kw)
    np.testing.assert_allclose(th_s.numpy(), th_1.numpy(), rtol=2e-4,
                               atol=2e-5)
    np.testing.assert_allclose(inf_s["plogtarget"].numpy(),
                               inf_1["plogtarget"].numpy(), rtol=2e-4)
    lp_true = _direct(X, Y, th_s.double().numpy(), w=w, o=o)
    np.testing.assert_allclose(inf_s["plogtarget"][-1].numpy(), lp_true,
                               rtol=1e-4)
    # the (1, 1) run is the unsharded driver on the same seed
    th_u, inf_u = glm_bign.run_glm_hmc_bign(X, Y, device="cpu", **kw)
    np.testing.assert_allclose(th_1.numpy(), th_u.numpy(), rtol=2e-4,
                               atol=2e-5)
    assert inf_s["ppars"].shape == (40, 8, 5)


@pytest.mark.parametrize("prior", ["row", "matrix"])
def test_bign_sharded_prior_forms(prior):
    """The prior applied once after the data-axis sum: a (d,) row and a
    (d, d) matrix against the (1, 1) run and the direct log-density."""
    X, Y = _data(300, 3)
    lam = (torch.tensor([0.5, 1.0, 2.0]) if prior == "row" else
           torch.tensor([[1.0, 0.3, 0.0], [0.3, 2.0, 0.1],
                         [0.0, 0.1, 0.7]]))
    kw = dict(n_chains=4, steps=20, n_leaps=3, eps=0.05, seed=2,
              prior_prec=lam)
    th_s, inf_s = glm_bign.run_glm_hmc_bign_sharded(
        X, Y, mesh=make_mesh(2, 2, devices=["cpu"] * 4), **kw)
    th_1, inf_1 = glm_bign.run_glm_hmc_bign_sharded(
        X, Y, mesh=make_mesh(1, 1, devices=["cpu"]), **kw)
    np.testing.assert_allclose(th_s.numpy(), th_1.numpy(), rtol=2e-4,
                               atol=2e-5)
    th = th_s.double().numpy()
    A = lam.double().numpy()
    A = np.diag(A) if A.ndim == 1 else A
    z = X @ th.T
    want = (z * Y[:, None] - np.logaddexp(0.0, z)).sum(0) \
        - 0.5 * np.einsum("ci,ij,cj->c", th, A, th)
    np.testing.assert_allclose(inf_s["plogtarget"][-1].numpy(), want,
                               rtol=1e-4)


# -- the warm pipeline and prun on a mesh ---------------------------------------------

def _moments_close(a, b, d):
    """tests/test_warmfused.py's gate: pooled means within 6 SE + 0.05."""
    a, b = np.asarray(a).reshape(-1, d), np.asarray(b).reshape(-1, d)
    se = b.std(0) / 15
    assert np.all(np.abs(a.mean(0) - b.mean(0)) < 6 * se + 0.05), (
        a.mean(0), b.mean(0), se)


def test_warm_pipeline_mesh_matches_unmeshed_and_jax():
    from mcmc_jl_tpu.ops.warmstart import warmfused_hmc_chains
    from mcmc_jl_tpu.parallel.pchains import default_mesh as jdefault_mesh

    X, Y = _data(90, 4)
    r = (400, 150)
    tm = mt.model(glm=("logistic", X, Y), device="cpu", dtype=torch.float32)
    s = mt.HMC(5, 0.05, mt.EmpMCTuner(0.8, adapt_step=50))
    runner = mt.SerialMC(steps=r[0], burnin=r[1])
    inf_m, st_m = tws.warmfused_chains(tm, s, runner, 16,
                                       make_generator("cpu", 0), mesh=CPU4)
    inf_u, _ = tws.warmfused_chains(tm, s, runner, 16,
                                    make_generator("cpu", 0))
    a = inf_m["ppars"][r[1]:].numpy()
    assert a.shape == (250, 16, 4)
    _moments_close(a, inf_u["ppars"][r[1]:].numpy(), 4)
    assert torch.all(st_m.tune.step_size > 0)
    # the sampling phase's frozen step is one value on every shard
    assert np.ptp(st_m.tune.step_size.numpy()) == 0

    jm = mc.model(glm=("logistic", X, Y))
    js = mc.HMC(5, 0.05, mc.EmpMCTuner(0.8, adapt_step=50))
    jinf, _ = warmfused_hmc_chains(jm, js, mc.SerialMC(steps=r[0],
                                                       burnin=r[1]),
                                   16, jax.random.PRNGKey(0),
                                   mesh=jdefault_mesh())
    _moments_close(a, np.asarray(jinf["ppars"])[r[1]:], 4)


def test_chees_mesh_lengths_shared_across_shards():
    X, Y = _data(90, 4)
    tm = mt.model(glm=("logistic", X, Y), device="cpu", dtype=torch.float32)
    s = mt.ChEESHMC(len0=0.5, max_leaps=32)
    r = mt.SerialMC(steps=260, burnin=100)
    col.reset_counts()
    infos, _ = tws.warmfused_chains(tm, s, r, 16, make_generator("cpu", 1),
                                    mesh=CPU4)
    # the warmup's pool hook reads every shard's states each step
    assert col.psum_count("chains") > 0
    nl = infos["nleaps"][r.burnin:].numpy()
    assert nl.shape == (160, 16)
    assert np.all(nl == nl[:, :1])  # shared by every chain of every shard
    assert np.ptp(nl) > 0  # and step-jittered
    # the warmup's lengths too, after its first (per-chain step) step
    w = infos["nleaps"][1:r.burnin].numpy()
    assert np.all(w == w[:, :1])


def test_run_and_resume_with_mesh():
    """run(..., chains=N, mesh=) on the exact-NUTS warm route, a generic
    route and a plain fused route (which ignores the mesh, as the JAX
    package's does), then resume(list, mesh=) through the fused
    continuation."""
    X, Y = _data(90, 4)
    tm = mt.model(glm=("logistic", X, Y), device="cpu", dtype=torch.float32)
    task = tm * mt.NUTS(maxdoublings=5) * mt.SerialMC(steps=240, burnin=80)
    cs = mt.run(task, chains=8, seed=0, fused=True, mesh=CPU4)
    cu = mt.run(task, chains=8, seed=0, fused=True)
    a = np.stack([c.samples.values for c in cs])
    _moments_close(a, np.stack([c.samples.values for c in cu]), 4)
    more = mt.resume(cs, steps=40, mesh=CPU4, fused=True)
    assert len(more) == 8 and more[0].samples.values.shape == (40, 4)
    assert more[0].task.pos == 280
    again = mt.resume(cs, steps=40, mesh=CPU4, fused=True)
    for x, y in zip(more, again):
        np.testing.assert_array_equal(x.samples.values, y.samples.values)
    # a generic route (RWM): sharded, so a stream of its own
    g_task = tm * mt.RWM(0.3) * mt.SerialMC(steps=30)
    gm = mt.run(g_task, chains=8, seed=0, mesh=CPU4, fused=False)
    gu = mt.run(g_task, chains=8, seed=0, fused=False)
    assert not np.array_equal(gm[0].samples.values, gu[0].samples.values)
    # the plain fused HMC route ignores the mesh: the same bits
    p_task = tm * mt.HMC(4, 0.1) * mt.SerialMC(steps=20)
    pm = mt.run(p_task, chains=8, seed=0, mesh=CPU4, fused=True)
    pu = mt.run(p_task, chains=8, seed=0, fused=True)
    for x, y in zip(pm, pu):
        np.testing.assert_array_equal(x.samples.values, y.samples.values)


def test_warm_target_mesh_dense_and_nuts():
    """A catalog target's warm phases on a mesh: dense adaptive HMC (the
    z-space target on every shard) and exact NUTS (kernel 8b's plain
    version), against the target's exact mean (6 standard errors of the
    per-chain means)."""
    gamma = mt.Gamma(3.0, 0.2)
    m = mt.model(lambda x: mt.tilde(x, gamma), x=np.full(2, 0.6),
                 gradient=True, device="cpu", dtype=torch.float32)
    assert m.target_spec is not None
    for s, steps in ((mt.HMC(6, 0.05, mt.EmpMCTuner(0.8, adapt_step=25),
                             mass_adapt="dense"), (260, 100)),
                     (mt.NUTS(maxdoublings=4), (160, 60))):
        r = mt.SerialMC(steps=steps[0], burnin=steps[1])
        infos, _ = tws.warmfused_chains(m, s, r, 8,
                                        make_generator("cpu", 2), mesh=CPU4)
        x = infos["ppars"][steps[1]:].double().numpy()  # (kept, 8, 2)
        cm = x.mean(0)
        se = cm.std(0, ddof=1) / np.sqrt(len(cm))
        assert np.all(np.abs(cm.mean(0) - 0.6) < 6 * se + 0.02), (
            type(s).__name__, cm.mean(0), se)


# -- the ensemble runners and run_until ------------------------------------------------

def _bimodal(p, st=0.35):
    if p is mc:
        return mc.model(lambda v: jnp.sum(jnp.logaddexp(
            mc.Normal(-4.0, st).logpdf(v), mc.Normal(4.0, st).logpdf(v))),
            init=jnp.asarray([4.0]), gradient=True)
    return mt.model(lambda v: torch.logaddexp(
        mt.Normal(-4.0, st).logpdf(v), mt.Normal(4.0, st).logpdf(v)).sum(),
        init=np.array([4.0]), gradient=True, dtype=F64, device="cpu")


def test_ptmc_walkers_on_a_mesh():
    """tests/test_ptmc.py:96's gates for walkers = 4 on a 4-entry mesh, in
    both packages."""
    for p, mesh in ((mt, CPU4), (mc, JMesh(np.array(jax.devices()[:4]),
                                           ("chains",)))):
        runner = p.PTMC(steps=2000, burnin=400, swap_period=5,
                        betas=(0.02, 0.08, 0.25, 0.6, 1.0), walkers=4)
        chains = p.run(_bimodal(p), p.RWM(0.5), runner, seed=0, mesh=mesh)
        assert isinstance(chains, list) and len(chains) == 4
        for c in chains:
            x = c.samples.values[:, 0]
            assert (x < -1).mean() > 0.03 and (x > 1).mean() > 0.03, (
                p.__name__, (x < -1).mean())
        xs = np.stack([c.samples.values[:, 0] for c in chains])
        assert 0.25 < (xs < 0).mean() < 0.75
        assert not np.allclose(chains[0].samples.values,
                               chains[1].samples.values)
    # the port's ladders live on their shards: resume continues each
    two = mt.run(_bimodal(mt), mt.RWM(0.5),
                 mt.PTMC(steps=200, walkers=2, betas=(0.1, 1.0)), seed=1,
                 mesh=tmesh.Mesh(["cpu"] * 2, ("chains",)))
    more = mt.resume(two, steps=50)
    assert len(more) == 2 and more[0].task.state.pars.shape == (2, 1)


def _conjugate(p, n=20, seed=3):
    rng = np.random.default_rng(seed)
    y = rng.standard_normal(n) + 0.7
    sy, yy = y.sum(), (y * y).sum()
    logz = -n / 2 * L2PI - 0.5 * np.log(1.0 + n) \
        - 0.5 * (yy - sy ** 2 / (1.0 + n))
    if p is mc:
        yd = jnp.asarray(y)

        def logprior(th):
            return -0.5 * th[0] ** 2 - 0.5 * L2PI

        def logp(th):
            return -0.5 * jnp.sum((yd - th[0]) ** 2) - n / 2 * L2PI \
                + logprior(th)

        m = mc.model(logp, gradient=True, init=jnp.zeros(1))
        prior_sample = lambda k: jax.random.normal(k, (1,))  # noqa: E731
    else:
        yd = torch.tensor(y)

        def logprior(th):
            return -0.5 * th[0] ** 2 - 0.5 * L2PI

        def logp(th):
            return -0.5 * ((yd - th[0]) ** 2).sum() - n / 2 * L2PI \
                + logprior(th)

        m = mt.model(logp, gradient=True, init=np.zeros(1), dtype=F64,
                     device="cpu")
        prior_sample = lambda g, k: torch.randn(  # noqa: E731
            (k, 1), generator=g, dtype=F64)
    return m, logprior, prior_sample, float(logz), sy / (n + 1.0)


@pytest.mark.parametrize("sampler", ["RWM", "HMC"])
def test_asmc_sharded_over_mesh(sampler):
    """tests/test_asmc.py:99's gates on an 8-entry mesh, in both packages
    (HMC moves too, through the tempered view's gradient)."""
    from mcmc_jl_tpu.parallel.sharded import make_mesh as jmake_mesh

    for p, mesh in ((mt, make_mesh(8, 1, devices=["cpu"] * 8)),
                    (mc, jmake_mesh(8, 1))):
        m, logprior, prior_sample, logz, mu = _conjugate(p)
        runner = p.ASMC(particles=2048, target_ess=0.5, moves=2,
                        logprior=logprior, prior_sample=prior_sample)
        s = p.RWM(0.5) if sampler == "RWM" else p.HMC(3, 0.1)
        col.reset_counts()
        chain = p.run(m * s * runner, seed=3, mesh=mesh)
        assert abs(chain.diagnostics["logz"] - logz) < 0.3, (
            p.__name__, chain.diagnostics["logz"], logz)
        x = chain.samples.values[:, 0]
        assert abs(x.mean() - mu) < 0.1
        assert chain.samples.values.shape == (2048, 1)
        if p is mt:
            # the stage statistics crossed the shards: gathers of ll and
            # particles and the acceptance sum, every stage
            assert col.psum_count("chains") >= 3 * chain.diagnostics[
                "n_stages"]
            assert np.all(chain.diagnostics["accept"] > 0)


def test_run_until_on_a_mesh():
    X, Y = _data(90, 4)
    tm = mt.model(glm=("logistic", X, Y), device="cpu", dtype=torch.float32)
    s = mt.HMC(5, 0.08, mt.EmpMCTuner(0.8, adapt_step=25))
    kw = dict(n_chains=8, check_every=100, max_steps=600, warmup=100,
              rhat_target=1.05, min_ess=100, fused=True, seed=0)
    res = mt.run_until(tm, s, mesh=CPU4, **kw)
    ref = mt.run_until(tm, s, **kw)
    assert res.converged and res.max_rhat <= 1.05, res.history
    assert res.samples.shape[1:] == (8, 4)
    _moments_close(res.samples, ref.samples, 4)


# -- divisibility errors ----------------------------------------------------------------

def test_divisibility_errors_match_jax():
    from mcmc_jl_tpu.ops.glm_hmc import run_glm_hmc_sharded as jglm
    from mcmc_jl_tpu.ops.pallas_glm_bign import \
        run_glm_hmc_bign_sharded as jbign

    X, Y = _data(64, 3)
    jm4 = JMesh(np.array(jax.devices()[:4]), ("chains",))
    jm22 = JMesh(np.array(jax.devices()[:4]).reshape(2, 2),
                 ("chains", "data"))
    cases = [
        (lambda: jglm(X, Y, 6, 2, mesh=jm4, interpret=True),
         lambda: glm_hmc.run_glm_hmc_sharded(X, Y, 6, 2, mesh=CPU4)),
        (lambda: jbign(X, Y, 3, 2, mesh=jm22, interpret=True),
         lambda: glm_bign.run_glm_hmc_bign_sharded(
             X, Y, 3, 2, mesh=make_mesh(2, 2, devices=["cpu"] * 4))),
    ]
    for jf, tf in cases:
        with pytest.raises(AssertionError) as je:
            jf()
        with pytest.raises(AssertionError) as te:
            tf()
        assert str(te.value) == str(je.value)
    with pytest.raises(AssertionError, match=r"n_chains \(6\) must be "
                       r"divisible by the 'chains' mesh axis size \(4\)"):
        target_kernels.run_target_hmc_sharded(
            target_kernels.coordwise_logp(mt.Gamma(3.0, 0.2), 2), 2, 6, 2,
            mesh=CPU4)
    with pytest.raises(AssertionError, match=r"PTMC walkers \(3\) must "
                       r"divide the mesh 'chains' axis \(4\)"):
        mt.run(_bimodal(mt), mt.RWM(0.5), mt.PTMC(steps=10, walkers=3),
               mesh=CPU4)
    m, logprior, prior_sample, _, _ = _conjugate(mt)
    with pytest.raises(AssertionError, match=r"ASMC particles \(10\) must "
                       r"divide the mesh 'chains' axis \(4\)"):
        mt.run(m * mt.RWM(0.5) * mt.ASMC(particles=10, logprior=logprior,
                                          prior_sample=prior_sample),
               mesh=CPU4)
    with pytest.raises(AssertionError, match=r"n_chains \(6\) must divide "
                       r"the 'chains' mesh axis \(4\) for the sharded "
                       r"sampling phase"):
        tws._mesh_phase(None, torch.zeros(6, 2), None, CPU4, "cpu")
