"""The dense metric on catalog targets (``mass_adapt="dense"`` through kernels
5 and 8b) on the CPU: the port's z-space target
(``models/distributions.py`` ``DenseTarget``, ``z -> target(z L')``) against
the JAX package's ``_dense_wrap`` (``dense_target_setup``), the plain
versions of the trajectory kernel and of target-mode NUTS on it against the
Pallas kernels in interpret mode with the wrapped block and the padded L
row, on the same numpy-seeded inputs and injected noise; HMC, HMCDA and
exact NUTS with a dense metric through ``run(..., chains=8, fused=True)``
(the wrappers run their plain versions here) against the generic engine
and the JAX package, with their resumes; a JAX dense state carried over by
``utils/convert.py`` and continued on the port.

Both sides run in float32 (tests/conftest.py turns on x64).  Tolerances:
the target's lp and gradient in z within rtol 1e-5 (and atol 1e-5 of
their scale); the trajectory's theta, m and g within rtol 1e-5 and atol
1e-5, lp within 1e-5 relative (each pass is two float32 matrix products
summed in another order on each side, over five leapfrogs); NUTS with
equal ``ndoublings`` and ``diverging`` on every chain, theta and gradient
within rtol and atol 1e-5, lp within 1e-4; the runs under
tests/test_warmfused.py's pooled gate (pooled means within 6 Monte Carlo
standard errors plus 0.05).  ``test_dense_target_kernels_match_plain_on_card``
holds the CUDA kernels against the plain versions on a card and skips
without one.  The tests that run the JAX package import it themselves, so
that the card test runs where JAX is not installed."""
import dataclasses

import numpy as np
import pytest
import torch

import mcmc_jl_tpu_torch as mt
from mcmc_jl_tpu_torch.core.task import MCMCTask
from mcmc_jl_tpu_torch.models.distributions import DenseTarget
from mcmc_jl_tpu_torch.ops import nuts_kernels as nk
from mcmc_jl_tpu_torch.ops import target_kernels as tk
from mcmc_jl_tpu_torch.ops import warmstart as tws
from mcmc_jl_tpu_torch.parallel import pchains
from mcmc_jl_tpu_torch.samplers.base import make_generator

torch.set_num_threads(1)
F32 = torch.float32

# family, parameters, centre and spread of the inputs (in the support)
FAMS = [("Normal", (0.5, 2.0), 0.5, 2.0), ("Gamma", (3.0, 0.2), 0.6, 0.1),
        ("Beta", (2.0, 3.0), 0.4, 0.05), ("Laplace", (0.0, 1.0), 0.0, 1.0),
        ("TDist", (5.0,), 0.0, 1.0), ("Weibull", (1.5, 2.0), 1.8, 0.3)]


def _counts(d):
    """Coordinates of each family: family k takes one named parameter of
    ``len(range(k, d, 6))`` entries."""
    return [len(range(k, d, len(FAMS))) for k in range(len(FAMS))]


def _models(d):
    """A catalog DSL model of d coordinates in both packages (JAX, port),
    and the coordinates' centres and spreads in the models' order."""
    import mcmc_jl_tpu as mc

    keys = [(f"p{k}", n) for k, n in enumerate(_counts(d)) if n]

    def ex_for(p):
        def ex(**q):
            for name, _ in keys:
                fam, args, _, _ = FAMS[int(name[1:])]
                p.tilde(q[name], getattr(p, fam)(*args))
        return ex

    init = {name: np.full(n, FAMS[int(name[1:])][2]) for name, n in keys}
    centre = np.concatenate([init[name] for name, _ in keys])
    spread = np.concatenate([np.full(n, FAMS[int(name[1:])][3])
                             for name, n in keys])
    tm = mt.model(ex_for(mt), gradient=True, device="cpu", **init)
    assert tm.target_spec is not None and tm.target_spec.has_rows
    np.testing.assert_allclose(tm.init.numpy(), centre, rtol=1e-6)
    return mc.model(ex_for(mc), gradient=True, **init), tm, centre, spread


def _factor(d, seed):
    """A seeded (d, d) lower-triangular Cholesky factor of an SPD matrix with
    off-diagonal mass (float64)."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((d, d)) / np.sqrt(d)
    return np.linalg.cholesky(A @ A.T + 0.5 * np.eye(d))


def _z_start(L, centre, spread, C, seed):
    """C positions in z whose theta = z L' lie near the centres (inside the
    supports), float32."""
    rng = np.random.default_rng(seed)
    th = centre + 0.3 * spread * rng.standard_normal((C, len(centre)))
    th = np.where(spread < 0.2, np.clip(th, centre - spread,
                                        centre + spread), th)
    return np.linalg.solve(L, th.T).T.astype(np.float32)


def _jax_dense(jm, L):
    """JAX's z-space block bound to its consts (the padded L row last)."""
    from mcmc_jl_tpu.ops import warmstart as jws

    block, consts, fold = jws.dense_target_setup(jm, L)
    assert fold is L
    return block, consts


def _pad(a, width=128):
    import jax.numpy as jnp

    out = np.zeros(a.shape[:-1] + (width,), np.float32)
    out[..., :a.shape[-1]] = a
    return jnp.asarray(out)


# ---- the z-space target -------------------------------------------------------


@pytest.mark.parametrize("d", [3, 10, 33])
def test_dense_target_matches_jax_wrapper(d):
    """lp and the gradient in z of the port's DenseTarget (torch.func on the
    plain evaluation) against jax.value_and_grad of JAX's z-space block, at
    a seeded non-identity factor; lp has no log-det term in either."""
    import jax
    import jax.numpy as jnp

    jm, tm, centre, spread = _models(d)
    L = _factor(d, seed=d)
    z = _z_start(L, centre, spread, 8, seed=d + 1)
    block, consts = _jax_dense(jm, L)

    def f(zz):
        return block(zz, *consts)[:, 0]

    lp_j = np.asarray(f(_pad(z)))
    g_j = np.asarray(jax.grad(lambda zz: jnp.sum(f(zz)))(_pad(z)))[:, :d]
    target = DenseTarget(tm.target_spec, torch.as_tensor(L))
    assert target.L.dtype == F32 and torch.equal(target.L,
                                                 torch.tril(target.L))
    lp_t, g_t = tk.target_funcs(target)[1](torch.as_tensor(z))
    assert lp_t.dtype == F32
    assert np.all(np.isfinite(lp_j))
    np.testing.assert_allclose(lp_t.numpy(), lp_j, rtol=1e-5,
                               atol=1e-5 * np.abs(lp_j).max())
    np.testing.assert_allclose(g_t.numpy(), g_j, rtol=1e-5,
                               atol=1e-5 * np.abs(g_j).max())
    # lp is the model's own at theta = z L'
    th = torch.as_tensor(z, dtype=torch.float64) @ torch.as_tensor(L).T
    np.testing.assert_allclose(lp_t.numpy(), tm.evalallg(th)[0].numpy(),
                               rtol=1e-5, atol=1e-4)


# ---- kernel 5 and kernel 8b on the z-space target -----------------------------


@pytest.mark.parametrize("d", [10, 33])
@pytest.mark.parametrize("integrator", ["leapfrog", "2stage"])
def test_trajectory_dense_matches_pallas_interpret(d, integrator):
    """The trajectory kernel's plain version on the dense target against
    pallas_target.fused_target_leapfrogs in interpret mode on JAX's
    z-space block (consts: the padded L row), injected momenta, five
    leapfrogs at a scalar step; counted as target_leapfrogs_dense."""
    import jax
    import jax.numpy as jnp
    from mcmc_jl_tpu.ops.pallas_target import fused_target_leapfrogs as j_leaps

    jm, tm, centre, spread = _models(d)
    C, eps, n_leaps = 8, 0.02, 5
    L = _factor(d, seed=2 * d)
    z = _z_start(L, centre, spread, C, seed=3)
    m = np.random.default_rng(4).standard_normal((C, d)).astype(np.float32)
    block, consts = _jax_dense(jm, L)
    z_j, m_j = _pad(z), _pad(m)
    g_j = jax.grad(lambda zz: jnp.sum(block(zz, *consts)))(z_j)
    out_j = j_leaps(block, z_j, m_j, g_j, eps, n_leaps=n_leaps,
                    block_chains=C, interpret=True, integrator=integrator,
                    consts=consts)

    target = DenseTarget(tm.target_spec, torch.as_tensor(L))
    z_t = torch.as_tensor(z)
    _, g_t = tk.target_funcs(target)[1](z_t)
    tk.reset_counts()
    out_t = tk.fused_target_leapfrogs(target, z_t, torch.as_tensor(m), g_t,
                                      eps, n_leaps=n_leaps,
                                      integrator=integrator)
    assert tk.PLAIN_CALLS == {**dict.fromkeys(tk.PLAIN_CALLS, 0),
                              "target_leapfrogs_dense": 1}
    for a, b in zip(out_t[:3], out_j[:3]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b)[:, :d],
                                   rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out_t[3].numpy(), np.asarray(out_j[3]),
                               rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="scalar step"):
        tk.fused_target_leapfrogs(target, z_t, torch.as_tensor(m), g_t,
                                  torch.full((d,), eps), n_leaps=1)


@pytest.mark.parametrize("multinomial", [False, True],
                         ids=["slice", "multinomial"])
def test_nuts_dense_matches_pallas_interpret(multinomial):
    """Target-mode NUTS's plain version on the dense target against
    pallas_nuts._target_transition_inner (interpret) on JAX's z-space
    block, one block of 8 chains (the leaf-uniform difference of the
    reference), d 10, injected m0/logu/dirn/merge_u/leaf_u: the same trees
    chain by chain; counted as target_nuts_transition_dense."""
    import jax
    import jax.numpy as jnp
    from mcmc_jl_tpu.ops.pallas_nuts import _target_transition_inner as j_trans

    d, C, md, eps = 10, 8, 4, 0.1
    jm, tm, centre, spread = _models(d)
    L = _factor(d, seed=7)
    z = _z_start(L, centre, spread, C, seed=8)
    rng = np.random.default_rng(9 + multinomial)
    noise = (rng.standard_normal((C, d)).astype(np.float32),
             np.log(rng.random(C)).astype(np.float32),
             np.where(rng.random((C, md)) < 0.5, 1.0, -1.0).astype(np.float32),
             rng.random((C, md)).astype(np.float32),
             rng.random((C, 1 << md)).astype(np.float32))
    block, consts = _jax_dense(jm, L)
    z_j = _pad(z)
    lp_j = block(z_j, *consts)[:, 0]
    g_j = jax.grad(lambda zz: jnp.sum(block(zz, *consts)))(z_j)
    m0, logu, dirn, merge, leaf = noise
    out_j = j_trans(z_j, lp_j, g_j, jnp.float32(eps), _pad(m0),
                    jnp.asarray(logu), _pad(dirn), _pad(merge), _pad(leaf),
                    logp_block=block, maxdoublings=md, block_chains=C,
                    interpret=True, multinomial=multinomial, consts=consts)
    th_j, gj, lpj, nd_j, dv_j = (np.asarray(a) for a in out_j)

    target = DenseTarget(tm.target_spec, torch.as_tensor(L))
    lp_t, g_t = tk.target_funcs(target)[1](torch.as_tensor(z))
    np.testing.assert_allclose(lp_t.numpy(), np.asarray(lp_j), rtol=1e-5,
                               atol=1e-5)
    nk.reset_counts()
    th, g, lp, nd, dv = nk.target_nuts_transition(
        target, torch.as_tensor(z), lp_t, g_t, eps,
        *(torch.as_tensor(a) for a in noise), maxdoublings=md,
        multinomial=multinomial)
    assert nk.PLAIN_CALLS["target_nuts_transition_dense"] == 1
    assert nk.PLAIN_CALLS["target_nuts_transition"] == 0
    np.testing.assert_array_equal(nd.numpy(), nd_j)
    np.testing.assert_array_equal(dv.numpy(), dv_j.astype(bool))
    assert len(set(nd.tolist())) > 1, nd  # trees of several depths
    np.testing.assert_allclose(th.numpy(), th_j[:, :d], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(g.numpy(), gj[:, :d], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(lp.numpy(), lpj, rtol=0, atol=1e-4)


# ---- the slice end to end ----------------------------------------------------


def _pair():
    """tests/test_torch_warm_target.py's catalog model (two Gamma(3, 0.2)
    coordinates and a Normal(1, 2): sds 0.35 and 2) in both packages."""
    import mcmc_jl_tpu as mc

    def ex_for(p):
        def ex(a, b):
            p.tilde(a, p.Gamma(3.0, 0.2))
            p.tilde(b, p.Normal(1.0, 2.0))
        return ex

    init = dict(a=np.full(2, 0.6), b=np.array([1.0]))
    return (mc.model(ex_for(mc), gradient=True, **init),
            mt.model(ex_for(mt), gradient=True, device="cpu", **init))


def _pooled_gate(chains_a, chains_b, var_b, tol=0.05, nse=6):
    """tests/test_warmfused.py's gate: pooled means within ``nse`` Monte
    Carlo standard errors of ``chains_b`` (``var_b`` its chains' variance
    of the mean) plus ``tol``."""
    mu_a = np.mean([c.samples.values.mean(0) for c in chains_a], axis=0)
    mu_b = np.mean([c.samples.values.mean(0) for c in chains_b], axis=0)
    se = np.sqrt(np.mean([var_b(c) for c in chains_b], axis=0)
                 / len(chains_b))
    assert np.all(np.abs(mu_a - mu_b) < nse * se + tol), (mu_a, mu_b, se)


def _plain_calls():
    return {k: v for mod in (tk, nk) for k, v in mod.PLAIN_CALLS.items() if v}


RUNS = {
    # sampler maker, steps, burn-in, the kernel whose plain version runs
    "hmc": (lambda p: p.HMC(6, 0.25, mass_adapt="dense"), 600, 300,
            "target_leapfrogs_dense"),
    "hmcda": (lambda p: p.HMCDA(mass_adapt="dense"), 600, 300,
              "target_leapfrogs_dense"),
    "nuts": (lambda p: p.NUTS(4, mass_adapt="dense"), 500, 300,
             "target_nuts_transition_dense"),
}


@pytest.mark.parametrize("name", list(RUNS))
def test_dense_catalog_run_matches_generic_and_jax(name):
    """run(task, chains=8, fused=True) with a dense metric on a catalog DSL
    model takes the kernel route (the dense trajectory kernel's or target
    NUTS's plain version, once per transition of the sampling phase), agrees
    with the generic engine's dense run and with the JAX package's fused
    run under the pooled gate, keeps the logtarget diagnostic equal to the
    model's log-density at the samples, and continues through
    resume(list) on the same kernel, bit for bit twice."""
    import mcmc_jl_tpu as mc

    make, steps, burnin, kernel = RUNS[name]
    jm, tm = _pair()
    task = tm * make(mt) * mt.SerialMC(steps=steps, burnin=burnin)
    route = "nuts" if name == "nuts" else "warm"
    assert pchains._route(MCMCTask(tm, task.sampler, task.runner),
                          True) == route
    tk.reset_counts()
    nk.reset_counts()
    cf = mt.run(task, chains=8, seed=0, fused=True)
    assert _plain_calls() == {kernel: steps - burnin}
    cg = mt.run(task, chains=8, seed=1, fused=False)
    jc = mc.run(jm * make(mc) * mc.SerialMC(steps=steps, burnin=burnin),
                chains=8, seed=0, fused=True)
    assert set(cf[0].diagnostics) == set(cg[0].diagnostics)
    _pooled_gate(cf, cg, mt.var)
    _pooled_gate(cf, jc, mc.var)
    assert mt.acceptance(cf[0]) > 30
    st = cf[0].task.state
    assert st.mass.scale.shape == (3, 3)
    for c in cf[:2]:
        rows = torch.as_tensor(c.samples.values[-5:])
        lp = tm.evalallg(rows)[0].numpy()
        np.testing.assert_allclose(c.diagnostics["logtarget"][-5:], lp,
                                   rtol=1e-4, atol=5e-3)
    assert pchains.continuation_route(tm, task.sampler, 8, True) == route
    tk.reset_counts()
    nk.reset_counts()
    r1 = mt.resume(cf, steps=30, fused=True)
    assert _plain_calls() == {kernel: 30}
    r2 = mt.resume(cf, steps=30, fused=True)
    np.testing.assert_array_equal(
        np.concatenate([c.samples.values for c in r1]),
        np.concatenate([c.samples.values for c in r2]))
    assert r1[0].task.pos == steps + 30
    assert np.all(np.isfinite(r1[0].samples.values))
    torch.testing.assert_close(r1[0].task.state.mass.scale, st.mass.scale,
                               rtol=0, atol=0)


def _as_dict(state):
    return {f.name: (_as_dict(getattr(state, f.name))
                     if dataclasses.is_dataclass(getattr(state, f.name))
                     else np.asarray(getattr(state, f.name)))
            for f in dataclasses.fields(state)}


@pytest.mark.parametrize("name", ["hmc", "nuts"])
def test_jax_dense_state_continues_on_the_port(name):
    """A JAX dense run's states (8 chains of run(..., fused=True), the dense
    accumulator (C, d, d) among them) carried over by utils/convert.py
    continue on the port's dense continuation: the same pooled factor and
    frozen step, the JAX continuation's info keys, shapes, ``i`` and
    epsilon rows, per-chain means within |z| < 5 of JAX's, and final lp
    and gradient exact at the last draw."""
    import jax
    import mcmc_jl_tpu as mc
    from mcmc_jl_tpu.ops import warmstart as jws

    make = {"hmc": lambda p: p.HMC(5, 0.25, mass_adapt="dense"),
            "nuts": lambda p: p.NUTS(4, mass_adapt="dense")}[name]
    convert = {"hmc": mt.hmc_state_from_numpy,
               "nuts": mt.nuts_state_from_numpy}[name]
    jm, tm = _pair()
    C, steps = 8, 60
    js, ts = make(mc), make(mt)
    jc = mc.run(jm * js * mc.SerialMC(steps=300, burnin=250), chains=C,
                seed=0, fused=True)
    jst = jax.tree_util.tree_map(lambda *xs: jax.numpy.stack(xs),
                                 *[c.task.state for c in jc])
    tst = convert(_as_dict(jax.device_get(jst)), device="cpu")
    assert tst.mass.scale.shape == (C, 3, 3)
    s = tws._pool_mass(ts._kind, tst)
    np.testing.assert_allclose(s.numpy(), jws._pool_mass(js._kind, jst),
                               rtol=1e-10, atol=1e-12)
    assert not np.allclose(s.numpy(), np.diag(np.diag(s.numpy())))
    route = "nuts" if name == "nuts" else "warm"
    assert pchains.continuation_route(tm, ts, C, True, tst) == route
    jinfos, jout = jws.fused_continue_chains(jm, js, jst, steps,
                                             jax.random.PRNGKey(5),
                                             interpret=True)
    tk.reset_counts()
    nk.reset_counts()
    tinfos, tout = tws.fused_continue_chains(tm, ts, tst, steps,
                                             make_generator("cpu", 5))
    kernel = {"hmc": "target_leapfrogs_dense",
              "nuts": "target_nuts_transition_dense"}[name]
    assert set(_plain_calls()) == {kernel}
    assert set(tinfos) == set(jinfos)
    for k, v in jinfos.items():
        assert tuple(tinfos[k].shape) == tuple(v.shape), k
    np.testing.assert_array_equal(tout.i.numpy(), np.asarray(jout.i))
    if name == "nuts":
        np.testing.assert_allclose(tinfos["epsilon"].numpy(),
                                   np.asarray(jinfos["epsilon"]), rtol=1e-6)
    lp, g = tm.evalallg(tout.pars)
    torch.testing.assert_close(tout.logtarget, lp)
    torch.testing.assert_close(tout.grad, g)
    tp = tinfos["ppars"].double().numpy()
    jp = np.asarray(jinfos["ppars"], np.float64)
    ma, mb = tp.mean(0), jp.mean(0)
    se = np.sqrt(ma.var(0, ddof=1) / C + mb.var(0, ddof=1) / C)
    assert np.max(np.abs(ma.mean(0) - mb.mean(0)) / se) < 5.0


# ---- on the card -------------------------------------------------------------


def test_dense_target_kernels_match_plain_on_card():
    """The four dense instantiations (kernels 5 and 8b, lane and warp
    layouts) against their plain versions on a card (skips without one;
    chip_smoke.py runs the same checks at d 1-1024): d 1, 10 and 32 (one
    chain per lane) and 33 and 150 (one warp per chain), C 397 and a
    seeded non-identity factor.  Kernel 5: theta, m and g within rtol and
    atol 1e-4, lp within 1e-5 relative and 1e-5 per coordinate, the same
    bits on a repeat and, at d <= 32, across its two W.  Kernel 8b on
    injected noise: 99.5% of the chains with the plain version's
    ndoublings, divergence and chosen leaf (theta within 1e-3), a bitwise
    repeat.  A step row on a dense target raises (d > 1)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    fams = [mt.Normal(0.5, 2.0), mt.Gamma(3.0, 0.2), mt.Beta(2.0, 3.0),
            mt.Laplace(0.0, 1.0), mt.TDist(5.0), mt.Weibull(1.5, 2.0)]
    C, md, tol = 397, 5, 1e-4
    for d in (1, 10, 32, 33, 150):
        target0 = tk.coordwise_logp([fams[j % 6] for j in range(d)], d)
        centre = np.array([FAMS[j % 6][2] for j in range(d)])
        spread = np.array([FAMS[j % 6][3] for j in range(d)])
        L = _factor(d, seed=d)
        target = DenseTarget(target0, torch.as_tensor(L).cuda())
        z = torch.as_tensor(_z_start(L, centre, spread, C,
                                     seed=1)).cuda().contiguous()
        rng = np.random.default_rng(d)
        m = torch.as_tensor(rng.standard_normal((C, d)),
                            dtype=F32).cuda()
        lp0, g = tk.target_funcs(target)[1](z)
        eps = 0.01
        ref = tk.fused_target_leapfrogs_ref(target, z, m, g, eps, n_leaps=10)
        fin = torch.isfinite(ref[3])
        runs = (1, 16) if d <= tk.LANE_D_MAX else (1,)
        outs = []
        for r in runs:
            tk.reset_counts()
            out = tk.fused_target_leapfrogs(target, z.repeat(r, 1),
                                            m.repeat(r, 1), g.repeat(r, 1),
                                            eps, n_leaps=10)
            assert tk.LAUNCHES["target_leapfrogs_dense"] == 1
            assert tk.LAUNCHES["target_leapfrogs"] == 0
            for a, b in zip(out[:3], ref[:3]):
                assert torch.allclose(a, b.repeat(r, 1), rtol=tol,
                                      atol=tol), (d, r)
            assert torch.equal(torch.isfinite(out[3]), fin.repeat(r)), d
            assert torch.allclose(out[3][fin.repeat(r)],
                                  ref[3][fin].repeat(r), rtol=1e-5,
                                  atol=1e-5 * d), (d, r)
            again = tk.fused_target_leapfrogs(target, z.repeat(r, 1),
                                              m.repeat(r, 1),
                                              g.repeat(r, 1), eps,
                                              n_leaps=10)
            assert all(torch.equal(a, b) for a, b in zip(out, again)), d
            outs.append([o.clone() for o in out])
        if len(outs) == 2:
            assert all(torch.equal(a[:C], b)
                       for a, b in zip(outs[1][:3], outs[0][:3])), d
        if d > 1:  # (a (1,) row is the scalar)
            with pytest.raises(ValueError, match="scalar step"):
                tk.fused_target_leapfrogs(target, z, m, g, torch.full(
                    (d,), eps, device="cuda"), n_leaps=1)

        gen = torch.Generator(device="cuda").manual_seed(d)
        noise = nk.draw_noise(C, d, md, gen, device="cuda")
        kw = dict(maxdoublings=md)
        tr = nk.target_nuts_transition_ref(target, z, lp0, g, eps * 5, *noise,
                                           **kw)
        nk.reset_counts()
        tc = nk.target_nuts_transition(target, z, lp0, g, eps * 5, *noise,
                                       **kw)
        assert nk.LAUNCHES["target_nuts_transition_dense"] == 1
        again = nk.target_nuts_transition(target, z, lp0, g, eps * 5, *noise,
                                          **kw)
        assert all(torch.equal(a, b) for a, b in zip(tc, again)), d
        same = ((tc[3] == tr[3]) & (tc[4] == tr[4])
                & ((tc[0] - tr[0]).abs() <= 1e-3 * (1 + tr[0].abs())).all(1))
        assert float(same.double().mean()) >= 0.995, (d, same.sum())
        assert torch.allclose(tc[1][same], tr[1][same], rtol=1e-3, atol=1e-3)
