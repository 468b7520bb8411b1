"""The port's mesh layer (parallel/mesh.py, collectives.py, sharded.py and
the mesh half of pchains.py) against the JAX package's, on the CPU.

- The mesh surface: ``devices``, ``shape``, ``axis_names``, the
  ``('chains', 'data')`` layout of ``make_mesh``, no CPU fallback when no
  CUDA device is visible, and ``parallel.__all__`` equal to the JAX
  package's.
- ``pool_tuner_states`` on JAX states carried over by ``utils.convert``,
  against JAX's, at 1e-12; the pooled adaptation of a mesh run equal on
  every chain, from a gather that adds zeros (bitwise the unsharded pool of
  the same values).
- ``sharded_glm_model``'s lp and gradient on a (4, 2) mesh of ``"cpu"``
  against JAX's ``value_and_grad`` of the full-data log-density, float64
  at 1e-12 (tests/test_sharded.py:37), and a sharded posterior run.
- ``run_chains(mesh=)``: each shard's chains bitwise the unsharded port run
  on that shard's generators (tests/test_parallel.py:39), on a mesh of
  one device and on one of two distinct devices (one host thread each).
- The scaling gates read from the ``psum`` counter
  (tests/test_scaling_gate.py:45,58,93): no reduction in a chains-only
  sampling loop, exactly ``1 + steps * n_leaps`` packed float32 (C_loc,
  d + 1) reductions a chain group in the data-axis run, and more than
  zero with pooled adaptation.

Virtual meshes repeat the ``"cpu"`` device, the counterpart of the JAX
suite's ``--xla_force_host_platform_device_count=8``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mcmc_jl_tpu as mc
import mcmc_jl_tpu.parallel as jpar
from mcmc_jl_tpu.parallel import collectives as jcol
from mcmc_jl_tpu.parallel.pchains import _scan_chains as jscan
from mcmc_jl_tpu.parallel.pchains import init_chains as jinit_chains
from mcmc_jl_tpu.samplers.base import RunCtx as JRunCtx
import mcmc_jl_tpu_torch as mt
import mcmc_jl_tpu_torch.parallel as tpar
from mcmc_jl_tpu_torch.parallel import collectives as col
from mcmc_jl_tpu_torch.parallel import mesh as tmesh
from mcmc_jl_tpu_torch.parallel.pchains import _scan_chains, run_chains
from mcmc_jl_tpu_torch.parallel.sharded import (make_mesh,
                                                run_chains_sharded,
                                                shard_data,
                                                sharded_glm_model)
from mcmc_jl_tpu_torch.samplers.base import RunCtx, make_generator

torch.set_num_threads(1)
F64 = torch.float64
EXACT = 1e-12
CPU4 = tmesh.Mesh(["cpu"] * 4, ("chains",))
# two distinct devices ("cpu" and "cpu:0"): the shards run in two threads
THREADS = tmesh.Mesh(["cpu", "cpu:0"], ("chains",))


def _as_dict(state):
    return {f.name: (_as_dict(getattr(state, f.name))
                     if dataclasses.is_dataclass(getattr(state, f.name))
                     else np.asarray(getattr(state, f.name)))
            for f in dataclasses.fields(state)}


# -- the mesh surface ---------------------------------------------------------

def test_mesh_surface():
    m = tmesh.Mesh(["cpu"] * 8, ("chains",))
    assert m.devices.size == 8 and m.size == 8
    assert m.shape == {"chains": 8} and m.axis_names == ("chains",)
    assert all(d == torch.device("cpu") for d in m.devices.flat)
    m2 = make_mesh(4, 2, devices=["cpu"] * 8)
    assert m2.shape == {"chains": 4, "data": 2}
    assert m2.devices.shape == (4, 2)
    assert m2.axis_names == ("chains", "data")
    assert tmesh.axis_groups(m2, "chains")[1] == [(1, 0), (1, 1)]
    assert tmesh.axis_groups(m2, "data")[1] == [(0, 1), (1, 1), (2, 1),
                                                (3, 1)]
    assert make_mesh(n_data_devices=4, devices=["cpu"] * 8).shape == {
        "chains": 2, "data": 4}
    d = tpar.default_mesh(devices=["cpu"] * 3)
    assert d.shape == {"chains": 3}
    with pytest.raises(ValueError, match="axis names"):
        tmesh.Mesh(["cpu"] * 2, ("chains", "data"))
    assert tpar.__all__ == jpar.__all__
    for name in tpar.__all__:
        assert hasattr(tpar, name)
    assert tpar.CHAIN_AXIS == jpar.CHAIN_AXIS == "chains"


def test_no_cpu_fallback(monkeypatch):
    """With no CUDA device visible and no devices given, the meshes raise:
    nothing runs on the CPU unasked."""
    from mcmc_jl_tpu_torch.ops.glm_hmc import run_glm_hmc_sharded

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpar.default_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(1, 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_glm_hmc_sharded(np.ones((4, 2)), np.ones(4), 4, 2)


# -- pool_tuner_states --------------------------------------------------------

def _jstates(name):
    jm = mc.model(lambda v: -0.5 * jnp.dot(v, v), grad=lambda v: -v,
                  init=jnp.ones(3))
    sampler = {"hmc": mc.HMC(5, 0.2, mc.EmpMCTuner(0.8, adapt_step=3)),
               "hmcda": mc.HMCDA(),
               "nuts": mc.NUTS(maxdoublings=4)}[name]
    states, _ = jscan(jm, sampler, JRunCtx(burnin=50),
                      jinit_chains(jm, sampler, 6, jax.random.PRNGKey(2),
                                   jitter=0.5), jax.random.PRNGKey(3), 9)
    return states


CONVERT = {"hmc": mt.hmc_state_from_numpy,
           "hmcda": mt.hmcda_state_from_numpy,
           "nuts": mt.nuts_state_from_numpy}


@pytest.mark.parametrize("name", sorted(CONVERT))
def test_pool_tuner_states_matches_jax(name):
    jst = _jstates(name)
    tst = CONVERT[name](_as_dict(jax.device_get(jst)), device="cpu")
    jp = _as_dict(jax.device_get(jcol.pool_tuner_states(jst)))
    tp = col.pool_tuner_states(tst)
    fields = [p for p, _ in col.pooled_fields(tst)]
    assert fields, name
    for path in fields:
        want = jp
        for k in path.split("."):
            want = want[k]
        got = col.get_field(tp, path)
        assert got.dtype == (torch.int32 if path == "tune.n_leaps" else F64)
        np.testing.assert_allclose(got.numpy(), want, rtol=EXACT, atol=0,
                                   err_msg=path)
        assert np.ptp(got.numpy()) == 0, path
    # the untouched fields pass through
    np.testing.assert_array_equal(tp.pars.numpy(), np.asarray(jst.pars))
    if name == "hmc":
        np.testing.assert_array_equal(tp.tune.accepted.numpy(),
                                      np.asarray(jst.tune.accepted))
    # from gathered values: the same pool on a shard of the batch
    full = {p: col.get_field(tst, p) for p in fields}
    half = tmesh.split_chains(tst, 2, 1)
    th = col.pool_tuner_states(half, full)
    for path in fields:
        np.testing.assert_array_equal(col.get_field(th, path).numpy(),
                                      col.get_field(tp, path).numpy()[3:])


def test_all_gather_is_exact():
    """all_gather is a psum of zero-padded slots: the gathered values are
    the shards' own bits, bool and int tensors included."""
    rng = np.random.default_rng(0)
    mesh = make_mesh(4, 2, devices=["cpu"] * 8)
    for dt in (torch.float64, torch.float32, torch.int32, torch.bool):
        x = torch.as_tensor(rng.standard_normal((8, 3)) * 1e3).to(dt)
        parts = {(c, j): x[2 * c:2 * c + 2] for c in range(4)
                 for j in range(2)}
        out = col.all_gather(parts, mesh, "chains")
        assert set(out) == set(parts)
        for v in out.values():
            assert v.dtype == dt and torch.equal(v, x)
    # psum sums in shard order on the group's first device
    parts = {(c, j): torch.full((2,), float(10 ** c + j), dtype=F64)
             for c in range(4) for j in range(2)}
    out = col.psum(parts, mesh, "data")
    assert torch.equal(out[(2, 1)], torch.full((2,), 201.0, dtype=F64))


# -- the data-sharded likelihood -------------------------------------------------

def _setup(n_obs=64, nbeta=4):
    rng = np.random.default_rng(0)
    X = np.column_stack([np.ones(n_obs),
                         rng.standard_normal((n_obs, nbeta - 1))])
    beta = rng.standard_normal(nbeta) * 0.5
    Y = (rng.random(n_obs) < 1.0 / (1.0 + np.exp(-X @ beta))).astype(
        np.float64)
    return X, Y, nbeta


def _loglik_shard(theta, X_blk, Y_blk):
    logits = X_blk @ theta
    return Y_blk @ logits - torch.logaddexp(torch.zeros_like(logits),
                                            logits).sum()


def _prior(theta):
    return -0.5 * theta @ theta


def test_sharded_logp_and_grad_match_jax():
    X, Y, nbeta = _setup()
    mesh = make_mesh(4, 2, devices=["cpu"] * 8)
    mk = sharded_glm_model(_loglik_shard, _prior, nbeta,
                           torch.zeros(nbeta, dtype=F64))
    theta = np.random.default_rng(3).standard_normal((5, nbeta))

    def jlogp(t):
        logits = jnp.asarray(X) @ t
        return (jnp.dot(jnp.asarray(Y), logits)
                - jnp.sum(jnp.logaddexp(0.0, logits)) - 0.5 * t @ t)

    want = [jax.value_and_grad(jlogp)(jnp.asarray(t)) for t in theta]
    col.reset_counts()
    Xt, Yt = torch.tensor(X), torch.tensor(Y)
    for c in range(4):
        model = mk(shard_data((Xt, Yt), mesh, c))
        lp, g = model.evalallg(torch.tensor(theta))
        assert lp.dtype == g.dtype == F64
        for r, (wl, wg) in enumerate(want):
            np.testing.assert_allclose(lp[r].item(), float(wl), rtol=EXACT)
            np.testing.assert_allclose(g[r].numpy(), np.asarray(wg),
                                       rtol=EXACT, atol=1e-12)
        np.testing.assert_allclose(
            model.eval(torch.tensor(theta)).numpy(),
            [float(wl) for wl, _ in want], rtol=EXACT)
    # one packed reduction an evaluation of each chain group
    assert col.PSUMS[("data", (5, nbeta + 1), "float64")] == 4


def test_sharded_posterior_matches_reference():
    """run_chains_sharded on a (4, 2) mesh: the pooled posterior mean of
    the data-sharded HMC run against a long unsharded run of the same
    posterior (tests/test_sharded.py's gate at a smaller size)."""
    X, Y, nbeta = _setup()
    mesh = make_mesh(4, 2, devices=["cpu"] * 8)
    mk = sharded_glm_model(_loglik_shard, _prior, nbeta,
                           torch.zeros(nbeta, dtype=F64))
    final, infos = run_chains_sharded(
        mk, (torch.tensor(X), torch.tensor(Y)), mt.HMC(5, 0.2),
        mt.SerialMC(steps=100), mesh, n_chains=8, seed=0)
    assert infos["ppars"].shape == (100, 8, nbeta)
    assert final.pars.shape == (8, nbeta)
    assert infos["accept"].double().mean() > 0.5
    x = infos["ppars"][30:].reshape(-1, nbeta).numpy()
    m = mt.model(lambda t: _loglik_shard(t, torch.tensor(X), torch.tensor(
        Y)) + _prior(t), gradient=True, init=np.zeros(nbeta), dtype=F64,
        device="cpu")
    ref = mt.run(m * mt.HMC(10, 0.25) * mt.SerialMC(steps=500, burnin=100),
                 chains=8, seed=9, fused=False)
    r = np.concatenate([c.samples.values for c in ref])
    se = r.std(0) / np.sqrt(30)
    assert np.all(np.abs(x.mean(0) - r.mean(0)) < 6 * se), (
        x.mean(0), r.mean(0), se)


# -- run_chains over a mesh ------------------------------------------------------

def _gauss():
    return mt.model(lambda v: -(v * v).sum(), gradient=True,
                    init=np.ones(3), dtype=F64, device="cpu")


@pytest.mark.parametrize("mesh", [CPU4, THREADS], ids=["virtual", "threads"])
@pytest.mark.parametrize("sampler", ["mala", "hmc_tuned"])
def test_run_chains_mesh_equals_per_shard_runs(mesh, sampler):
    """Each shard of run_chains(mesh=) is the unsharded run of its chains
    on its generators, bit for bit: the init generators, then the run's,
    each set drawn from the run's generator."""
    m = _gauss()
    s = {"mala": mt.MALA(0.5),
         "hmc_tuned": mt.HMC(4, 0.3, mt.EmpMCTuner(0.8, adapt_step=7))}[
        sampler]
    runner = mt.SerialMC(steps=40, burnin=20)
    n = mesh.shape["chains"]
    C = 4 * n
    inits = torch.tensor(np.random.default_rng(1).standard_normal((C, 3)))
    infos, states, _ = run_chains(m, s, runner, C, seed=3, inits=inits,
                                  mesh=mesh)
    assert infos["ppars"].shape == (40, C, 3)
    gen = make_generator("cpu", 3)
    items = tmesh.local_groups(mesh, "chains")
    g_init = tmesh.shard_generators(items, generator=gen)
    g_run = tmesh.shard_generators(items, generator=gen)
    for i, _ in items:
        sl = slice(4 * i, 4 * i + 4)
        st = s.init(m, inits[sl], g_init[i])
        st, inf = _scan_chains(m, s, RunCtx(burnin=20), st, g_run[i], 40)
        assert torch.equal(inf["ppars"], infos["ppars"][:, sl]), i
        assert torch.equal(st.pars, states.pars[sl]), i
    # an unsharded run of the same seed draws another stream
    plain, _, _ = run_chains(m, s, runner, C, seed=3, inits=inits)
    assert not torch.equal(plain["ppars"], infos["ppars"])


def test_run_chains_mesh_posterior():
    """Cross-shard split-R-hat and moments on the easy Gaussian
    (tests/test_parallel.py's rhat gate)."""
    m = _gauss()
    infos, _, _ = run_chains(m, mt.HMC(5, 0.3), mt.SerialMC(steps=400,
                                                            burnin=100),
                             8, seed=0, jitter=1.0, mesh=CPU4)
    x = infos["ppars"][100:].numpy()
    n = x.shape[0]
    W = x.var(0, ddof=1).mean(0)
    B = n * x.mean(0).var(0, ddof=1)
    rhat = np.sqrt(((n - 1) / n * W + B / n) / W)
    assert np.all(rhat < 1.05), rhat
    assert abs(x.mean()) < 0.06 and abs(x.var() - 0.5) < 0.06


def test_indivisible_batch_runs_unsharded():
    """A chain count the axis does not divide leaves the batch whole, as
    the JAX package's _shard_chains does: the unsharded run's bits."""
    m = _gauss()
    a, _, _ = run_chains(m, mt.MALA(0.5), mt.SerialMC(steps=10), 6, seed=1,
                         mesh=CPU4)
    b, _, _ = run_chains(m, mt.MALA(0.5), mt.SerialMC(steps=10), 6, seed=1)
    assert torch.equal(a["ppars"], b["ppars"])


def test_pooled_adaptation_on_a_mesh():
    """pool_adaptation=True over the mesh: every chain carries the same
    adapted step (tests/test_pooled_adaptation.py), equal to the pool of
    the chains' unpooled values at the last pooling."""
    m = _gauss()
    s = mt.MALA(2.0, mt.EmpMCTuner(0.574, adapt_step=50))
    runner = mt.SerialMC(steps=300, burnin=250)
    _, pooled, _ = run_chains(m, s, runner, 8, seed=0, jitter=0.3,
                              pool_adaptation=True, mesh=CPU4)
    st = pooled.tune.step_size.numpy()
    assert np.ptp(st) == 0 and not np.isclose(st[0], 2.0)
    _, free, _ = run_chains(m, s, runner, 8, seed=0, jitter=0.3, mesh=CPU4)
    assert np.ptp(free.tune.step_size.numpy()) > 0
    _, hmcda, _ = run_chains(m, mt.HMCDA(), mt.SerialMC(steps=60, burnin=50),
                             4, seed=0, jitter=0.3, pool_adaptation=True,
                             mesh=THREADS)
    assert np.ptp(hmcda.leap_step.numpy()) == 0


# -- the scaling gates, read from the psum counter ----------------------------------

def test_sharded_sampling_loop_is_reduction_free():
    m = mt.model(lambda v: -(v * v).sum(), gradient=True, init=np.ones(8),
                 dtype=F64, device="cpu", check_init=False)
    mesh = tmesh.Mesh(["cpu"] * 2, ("chains",))
    for sampler in (mt.RWM(0.5), mt.HMC(5, 0.2)):
        col.reset_counts()
        run_chains(m, sampler, mt.SerialMC(steps=10), 16, seed=0, mesh=mesh)
        assert col.PSUMS == {}, (type(sampler).__name__, col.PSUMS)


def test_data_axis_run_one_psum_per_gradient():
    """(chains, data) run of the large-N driver: exactly one data-axis
    reduction a gradient evaluation of each chain group (n_leaps a
    transition plus the initial one), each the packed float32 (C_loc,
    d + 1) [g | lp], and nothing else."""
    from mcmc_jl_tpu_torch.ops.glm_bign import run_glm_hmc_bign_sharded

    rng = np.random.default_rng(0)
    X = np.column_stack([np.ones(200), rng.standard_normal((200, 3))])
    Y = (rng.random(200) < 0.5).astype(np.float64)
    steps, n_leaps = 5, 3
    for shape in ((1, 4), (2, 4)):
        mesh = make_mesh(*shape, devices=["cpu"] * 8)
        col.reset_counts()
        run_glm_hmc_bign_sharded(X, Y, n_chains=8, steps=steps,
                                 n_leaps=n_leaps, eps=0.05, seed=0,
                                 mesh=mesh)
        c_loc = 8 // shape[0]
        assert col.PSUMS == {("data", (c_loc, 5), "float32"):
                             shape[0] * (1 + steps * n_leaps)}, col.PSUMS


def test_pooled_adaptation_shows_reduction_contrast():
    m = mt.model(lambda v: -(v * v).sum(), gradient=True, init=np.ones(8),
                 dtype=F64, device="cpu", check_init=False)
    sampler = mt.HMC(5, 0.2, mt.EmpMCTuner(0.8, adapt_step=5))
    mesh = tmesh.Mesh(["cpu"] * 2, ("chains",))
    counts = {}
    for pool in (False, True):
        col.reset_counts()
        run_chains(m, sampler, mt.SerialMC(steps=10), 16, seed=0, mesh=mesh,
                   pool_adaptation=pool)
        counts[pool] = col.psum_count("chains")
    assert counts[False] == 0 and counts[True] > 0, counts
    assert counts[True] == 2 * 10  # step size and leap count, every step


def test_counts_survive_concurrent_shards():
    """Shards on distinct devices launch from one host thread each: the
    launch and reduction counters take every update (16 threads, more than
    the cores, with a shortened switch interval)."""
    import sys
    import threading

    from mcmc_jl_tpu_torch.ops.cuda_build import count

    counts = {"k": 0}
    mesh = tmesh.Mesh(["cpu"] * 2, ("chains",))
    parts = {(0,): torch.ones(3), (1,): torch.ones(3)}
    col.reset_counts()

    def work():
        for _ in range(500):
            count(counts, "k")
            col.psum(parts, mesh, "chains")

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert counts["k"] == 16 * 500
    assert col.PSUMS == {("chains", (3,), "float32"): 16 * 500}
