"""GLMs wider than 32 parameters: the port's GLM kernels 1, 2, 3, 3b and 4
(mcmc_jl_tpu_torch/ops/glm_kernels.py, glm_bign.py) against the JAX
package's Pallas kernels (mcmc_jl_tpu/ops/pallas_glm.py,
pallas_glm_bign.py) in interpret mode on the CPU, at d 33 to 150, on the
same numpy inputs and injected noise; the routes that take such a GLM
through ``run(..., chains=N)`` and ``resume(list)``; and one whole path
from the JAX package's adapted states carried over with ``utils.convert``.

On the CPU the wrappers run their plain versions.  Above d = 32 the CUDA
kernels run on the wide chain tile (csrc/glm_tile.cuh);
``test_wide_kernels_match_plain_on_card`` holds them against the plain
versions on a card, and chip_smoke.py's ``phase_wide_kernels`` at the paths'
shapes.  The JAX package pads d to 128 lanes (256 at d 150); the port pads
nothing.  Tolerances: float32 values to rtol and atol 2e-5 as
tests/test_torch_glm_kernels.py holds them at d 5, lp to 2e-4 (probit adds
the JAX kernel's erf-free log Phi error, 1e-5 an observation)."""
import dataclasses
import logging

import numpy as np
import pytest
import torch

import mcmc_jl_tpu_torch as mt
from mcmc_jl_tpu_torch.core.task import MCMCTask
from mcmc_jl_tpu_torch.ops import glm_bign
from mcmc_jl_tpu_torch.ops import glm_kernels as gk
from mcmc_jl_tpu_torch.ops import philox
from mcmc_jl_tpu_torch.ops import warmstart as tws
from mcmc_jl_tpu_torch.parallel import pchains
from mcmc_jl_tpu_torch.samplers.base import make_generator

torch.set_num_threads(1)

LINKS = ["logistic", "linear", "poisson", "probit"]


def _data(kind, n, d, seed):
    """An intercept and d - 1 standard normal columns scaled by 1 / sqrt(d)
    (tests/test_pallas_glm.py's wide case), float32, and a response of the
    link drawn at a coefficient vector of norm about 1."""
    rng = np.random.default_rng(seed)
    X = np.column_stack([np.ones(n), rng.standard_normal((n, d - 1))]) \
        / np.sqrt(d)
    z = X @ rng.standard_normal(d)
    if kind == "linear":
        Y = z + rng.standard_normal(n)
    elif kind == "poisson":
        Y = rng.poisson(np.exp(z)).astype(np.float64)
    else:
        Y = (rng.random(n) < 1.0 / (1.0 + np.exp(-z))).astype(np.float64)
    return X.astype(np.float32), Y.astype(np.float32)


def _jax():
    """(jax.numpy, the JAX package's pallas_glm): imported here, so that the
    card test runs where JAX is not installed."""
    import jax.numpy as jnp

    from mcmc_jl_tpu.ops import pallas_glm

    return jnp, pallas_glm


def _t(a):
    return torch.as_tensor(np.asarray(a, dtype=np.float32))


def _close(a, b, rtol=2e-5, atol=2e-5):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol)


def _lp_atol(kind, n):
    return n * 1e-5 if kind == "probit" else 2e-4


def _grad_at(XT, Y, theta, **kw):
    """The port's plain (lp, grad) at theta."""
    kw.setdefault("kind", "logistic")
    return gk.glm_funcs(XT, Y, kw.get("weights"), kw.get("offsets"),
                        gk._prior(kw.get("prior_prec", 1.0)), kw["kind"])[1](
        theta)


def _extras(n, seed):
    rng = np.random.default_rng(seed)
    return dict(weights=rng.uniform(0.5, 2.0, n).astype(np.float32),
                offsets=(0.2 * rng.standard_normal(n)).astype(np.float32),
                prior_prec=1.7)


def _as_t(kw):
    return {k: (_t(v) if isinstance(v, np.ndarray) else v)
            for k, v in kw.items()}


# ---- kernels 1, 2, 3, 3b: plain versions against the Pallas kernels ---------

TRAJ_CASES = [(33, "logistic", True), (64, "linear", True),
              (150, "logistic", False), (150, "linear", True),
              (150, "poisson", True), (150, "probit", True)]


@pytest.mark.parametrize("d,kind,extras", TRAJ_CASES)
def test_leapfrogs_ref_matches_pallas_wide(d, kind, extras):
    """Kernel 1's plain trajectory == the Pallas _kernel (interpret) on the
    padded design, at N 120 and d past the narrow tile's 32."""
    jnp, pg = _jax()
    n, C, eps, nl = 120, 8, 0.05, 3
    X, Y = _data(kind, n, d, seed=d)
    rng = np.random.default_rng(d + 1)
    theta = (0.3 * rng.standard_normal((C, d))).astype(np.float32)
    m = rng.standard_normal((C, d)).astype(np.float32)
    kw = _extras(n, d + 2) if extras else {}
    tkw = _as_t(kw)
    XTt, Yt = _t(X.T).contiguous(), _t(Y)
    _, g = _grad_at(XTt, Yt, _t(theta), kind=kind, **tkw)

    XT, Y2, d_pad = pg.pad_design(X, Y)
    assert d_pad == (128 if d <= 128 else 256)
    th_p, m_p, g_p = (pg.pad_chains(jnp.asarray(a, jnp.float32), d_pad)
                      for a in (theta, m, g.numpy()))
    jt, jm, jg, jlp = pg.glm_hmc_leapfrogs(
        XT, Y2, th_p, m_p, g_p, eps, n_leaps=nl, block_chains=C,
        interpret=True, kind=kind, **kw)
    gk.reset_counts()
    pt, pm, pgr, plp = gk.glm_leapfrogs(XTt, Yt, _t(theta), _t(m), g, eps,
                                        n_leaps=nl, kind=kind, **tkw)
    assert gk.PLAIN_CALLS["glm_leapfrogs"] == 1
    assert not any(gk.LAUNCHES.values())
    _close(pt, np.asarray(jt)[:, :d])
    _close(pm, np.asarray(jm)[:, :d])
    _close(pgr, np.asarray(jg)[:, :d], atol=1e-4)
    _close(plp, jlp, atol=_lp_atol(kind, n))
    assert np.all(np.asarray(jg)[:, d:] == 0)


@pytest.mark.parametrize("d", [40, 150])
def test_step_ref_matches_pallas_wide(d):
    """Kernel 2's plain transition with injected m0 and logu == the Pallas
    _step_kernel, on a mix of accepts and rejects."""
    jnp, pg = _jax()
    n, C, nl = 120, 16, 4
    eps = 0.5 if d == 40 else 0.35
    X, Y = _data("logistic", n, d, seed=50 + d)
    rng = np.random.default_rng(51 + d)
    theta = (0.3 * rng.standard_normal((C, d))).astype(np.float32)
    m0 = rng.standard_normal((C, d)).astype(np.float32)
    logu = np.log(rng.random((C, 1))).astype(np.float32)
    XTt, Yt = _t(X.T).contiguous(), _t(Y)
    lp, g = _grad_at(XTt, Yt, _t(theta))

    XT, Y2, d_pad = pg.pad_design(X, Y)
    th_p, g_p, m_p = (pg.pad_chains(jnp.asarray(a, jnp.float32), d_pad)
                      for a in (theta, g.numpy(), m0))
    jt, jg, jlp, jacc = pg.glm_hmc_step(
        XT, Y2, th_p, g_p, jnp.asarray(lp.numpy()[:, None]), m_p,
        jnp.asarray(logu), eps, n_leaps=nl, block_chains=C, interpret=True)
    pt, pgr, plp, pacc = gk.glm_step(XTt, Yt, _t(theta), g, lp[:, None],
                                     _t(m0), _t(logu), eps, n_leaps=nl)
    acc = np.asarray(jacc)[:, 0] > 0.5
    assert acc.any() and not acc.all(), "want a mix of accepts and rejects"
    np.testing.assert_array_equal(pacc.numpy()[:, 0] > 0.5, acc)
    _close(pt, np.asarray(jt)[:, :d])
    _close(pgr, np.asarray(jg)[:, :d], atol=1e-4)
    _close(plp, jlp, atol=2e-4)


def test_multistep_draws_replay_past_32():
    """glm_multistep_draws at d 40 follows the counter (chain, transition,
    j // 2, 0) past coordinate 32 as below it, and its first 32
    coordinates are the d 32 replay's: kernels 3 and 3b draw coordinate j
    of a chain the same way at every width, so the replay holds them draw
    for draw on both tiles."""
    seed, C, k, i0 = 0xABCD_1234_5678, 5, 3, 11
    m40, lu40 = gk.glm_multistep_draws(seed, C, 40, k, i0=i0)
    m32, lu32 = gk.glm_multistep_draws(seed, C, 32, k, i0=i0)
    assert m40.shape == (k, C, 40)
    assert torch.equal(m40[..., :32], m32) and torch.equal(lu40, lu32)
    for j in (32, 33, 38, 39):
        b = philox.philox4x32((4, i0 + 2, j // 2, 0), seed)
        want = (philox.box_muller(b[0], b[1]) if j % 2 == 0
                else philox.box_muller(b[2], b[3]))
        assert m40[2, 4, j].item() == float(want)


def _lower(rng, d):
    L = np.tril(0.3 * rng.standard_normal((d, d)) / np.sqrt(d))
    L[np.arange(d), np.arange(d)] = rng.uniform(0.5, 1.5, d)
    return L


@pytest.mark.parametrize("prior", ["row", "matrix"])
def test_rows_ref_on_replayed_draws_matches_pallas_wide(prior):
    """Kernel 3b's plain version at d 40, fed the replayed draws of a
    glm_multistep_rows launch from absolute transition i0, with a (d,)
    prior row or a (d, d) matrix A = L'L == the Pallas trajectory kernel
    (interpret, the same prior) and the NaN-rejecting test, transition by
    transition at the Halton leap counts: accept decisions equal, rows
    within float32 rounding."""
    jnp, pg = _jax()
    n, d, C, k, i0 = 120, 40, 8, 5, 29
    eps, T, max_leaps = 0.45, 1.6, 6
    X, Y = _data("logistic", n, d, seed=70)
    rng = np.random.default_rng(71)
    theta = (0.3 * rng.standard_normal((C, d))).astype(np.float32)
    if prior == "row":
        lam = rng.uniform(0.5, 2.0, d).astype(np.float32)
        jprior = np.concatenate([lam, np.ones(128 - d, np.float32)])[None]
    else:
        L = _lower(rng, d)
        lam = (L.T @ L).astype(np.float32)
        jprior = lam
    XTt, Yt, lam_t = _t(X.T).contiguous(), _t(Y), _t(lam)
    z, logu = gk.glm_multistep_draws(0x5EED_0F_CAFE, C, d, k, i0=i0)
    th, g, lp, rows = gk.glm_multistep_rows_ref(
        XTt, Yt, _t(theta), eps, T, i0, max_leaps, k_trans=k,
        noise=(z, logu), prior_prec=lam_t)
    nls = [gk.halton_leaps(i0 + t, eps, T, max_leaps) for t in range(k)]
    assert rows["nleaps"].tolist() == [[nl] * C for nl in nls]

    XT, Y2, d_pad = pg.pad_design(X, Y)
    lp0, g0 = _grad_at(XTt, Yt, _t(theta), prior_prec=lam_t)
    jth, jg = (pg.pad_chains(jnp.asarray(a, jnp.float32), d_pad)
               for a in (theta, g0.numpy()))
    jlp = jnp.asarray(lp0.numpy())
    for t in range(k):
        m0 = pg.pad_chains(jnp.asarray(z[t].numpy()), d_pad)
        p_th, p_m, p_g, p_lp = pg.glm_hmc_leapfrogs(
            XT, Y2, jth, m0, jg, eps, n_leaps=nls[t], interpret=True,
            block_chains=C, prior_prec=jnp.asarray(jprior))
        ratio = ((-jlp + 0.5 * jnp.sum(m0 * m0, axis=1))
                 - (-p_lp + 0.5 * jnp.sum(p_m * p_m, axis=1)))
        acc = np.asarray(jnp.where(jnp.isnan(ratio), False,
                                   (ratio > 0) | (ratio > logu[t].numpy())))
        jth = jnp.where(acc[:, None], p_th, jth)
        jg = jnp.where(acc[:, None], p_g, jg)
        jlp = jnp.where(acc, p_lp, jlp)
        np.testing.assert_array_equal(rows["accept"][t].numpy(), acc)
        _close(rows["ppars"][t], np.asarray(jth)[:, :d])
        _close(rows["pgrads"][t], np.asarray(jg)[:, :d], atol=1e-4)
        _close(rows["plogtarget"][t], np.asarray(jlp), atol=2e-4)
    assert 0 < float(rows["accept"].float().mean()) < 1, \
        "want a mix of accepts and rejects"
    _close(th, np.asarray(jth)[:, :d])
    _close(lp, np.asarray(jlp), atol=2e-4)


# ---- kernel 4: the tiled (lp, g) ------------------------------------------

@pytest.mark.parametrize("case", ["logistic", "probit_w_o_row", "poisson_mat"])
def test_tiled_ref_matches_pallas_wide(case):
    """Kernel 4's plain (lp, grad) at d 150 == the Pallas _grad_kernel in
    interpret mode (tile 64, so N = 150 is not a multiple of it): plain,
    with weights, offsets and a (d,) prior row, and with a (d, d) matrix
    prior."""
    from mcmc_jl_tpu.ops.pallas_glm_bign import glm_logp_grad_tiled as jtiled
    from mcmc_jl_tpu.ops.pallas_glm_bign import pad_design_tiled

    jnp, _ = _jax()

    kind = case.split("_")[0]
    n, d, C = 150, 150, 8
    X, Y = _data(kind, n, d, seed=80)
    rng = np.random.default_rng(81)
    theta = (0.3 * rng.standard_normal((C, d))).astype(np.float32)
    w = o = None
    lam = 1.0
    if case.endswith("row"):
        w = rng.uniform(0.5, 2.0, n).astype(np.float32)
        o = (0.2 * rng.standard_normal(n)).astype(np.float32)
        lam = rng.uniform(0.5, 2.0, d).astype(np.float32)
    elif case.endswith("mat"):
        L = _lower(rng, d)
        lam = (L.T @ L).astype(np.float32)
    XTj, Y2, Wj, d_pad, _ = pad_design_tiled(X, Y, weights=w, tile_n=64)
    jkw = dict(weights=Wj, _use_w=Wj is not None)
    if case.endswith("row"):
        O = np.zeros((1, XTj.shape[1]), np.float32)
        O[0, :n] = o
        jkw.update(offsets=jnp.asarray(O), _use_o=True, _unit_prior=False,
                   _vec_prior=True, prior_prec=jnp.asarray(np.concatenate(
                       [lam, np.ones(d_pad - d, np.float32)])[None]))
    elif case.endswith("mat"):
        jkw.update(_unit_prior=False, _mat_prior=True,
                   prior_prec=jnp.asarray(lam))
    jlp, jg = jtiled(XTj, Y2, jnp.asarray(np.pad(theta, ((0, 0),
                                                         (0, d_pad - d)))),
                     tile_n=64, block_chains=C, interpret=True, kind=kind,
                     **jkw)
    glm_bign.reset_counts()
    lp, g = glm_bign.glm_logp_grad_tiled(
        _t(X.T).contiguous(), _t(Y), _t(theta), kind=kind,
        weights=None if w is None else _t(w),
        offsets=None if o is None else _t(o),
        prior_prec=lam if isinstance(lam, float) else _t(lam))
    assert glm_bign.PLAIN_CALLS == {"glm_logp_grad_tiled": 1}
    assert not any(glm_bign.LAUNCHES.values())
    extra = 1e-5 * n if kind == "probit" else 0.0
    np.testing.assert_allclose(lp.numpy(), np.asarray(jlp), rtol=1e-5,
                               atol=2e-4 + extra)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg)[:, :d], rtol=1e-5,
                               atol=1e-4 + extra)


def test_wide_counters_and_splits():
    """A launch past the narrow tile counts under ``<name>_wide`` (and
    ``<name>_mat_wide`` with a matrix prior) up to the wide tile's bound
    256, under ``<name>_xwide`` above it; the tiled kernel's grid takes 16
    chains a CTA there, in two waves of one block an SM."""
    assert gk.XWIDE_D_MAX == 1024 and gk.WIDE_D_MAX == 256
    assert gk.NARROW_D_MAX == 32
    assert gk._counted("glm_leapfrogs", None, 32) == "glm_leapfrogs"
    assert gk._counted("glm_leapfrogs", None, 33) == "glm_leapfrogs_wide"
    assert gk._counted("glm_leapfrogs", None, 256) == "glm_leapfrogs_wide"
    assert gk._counted("glm_leapfrogs", None, 257) == "glm_leapfrogs_xwide"
    assert (gk._counted("glm_multistep_rows", object(), 150)
            == "glm_multistep_rows_mat_wide")
    for name in ("glm_leapfrogs", "glm_step", "glm_multistep",
                 "glm_multistep_rows", "glm_multistep_rows_mat"):
        assert name + "_wide" in gk.LAUNCHES
    assert {"glm_logp_grad_tiled_wide",
            "glm_logp_grad_tiled_mat_wide"} <= set(glm_bign.LAUNCHES)
    for N, C in ((100_000, 512), (20_000, 4096), (1500, 16), (17, 1)):
        s = glm_bign.splits_for(N, C, 150)
        rows = -(-N // s)
        assert -(-N // rows) == s >= 1
        tiles = -(-C // 16)
        assert tiles * s <= max(glm_bign.SPLIT_CTAS_WIDE, tiles)
    assert glm_bign.splits_for(100_000, 512, 150) == 8
    assert glm_bign.splits_for(100_000, 512, 10) == 98


# ---- routes through run(..., chains=N) and resume(list) ---------------------

def _wide_model(n=120, d=40, seed=90):
    X, Y = _data("logistic", n, d, seed)
    return mt.model(glm=("logistic", X, Y), device="cpu")


def test_wide_plain_hmc_takes_the_hmc_route():
    """At d 40 plain HMC routes to "hmc" (kernel 1's driver): the
    trajectory's plain version runs once per transition and nothing else
    runs; the samples are finite and accept."""
    m = _wide_model()
    task = m * mt.HMC(5, 0.1) * mt.SerialMC(steps=60, burnin=20)
    assert pchains._route(MCMCTask(m, task.sampler, task.runner),
                          True) == "hmc"
    gk.reset_counts()
    glm_bign.reset_counts()
    cs = mt.run(task, chains=4, seed=0, fused=True)
    assert gk.PLAIN_CALLS == {"glm_leapfrogs": 60, "glm_step": 0,
                              "glm_multistep": 0, "glm_multistep_rows": 0}
    assert not any(glm_bign.PLAIN_CALLS.values())
    assert cs[0].samples.shape == (40, 40)
    assert np.all(np.isfinite(cs[0].samples.values))
    assert mt.acceptance(cs[0]) > 30


def test_wide_adaptive_hmc_takes_warm_and_resumes_fused(monkeypatch):
    """At d 40 adaptive HMC with a diagonal metric routes to "warm": the
    sampling phase runs the Halton multistep rows (3b) below
    BIGN_THRESHOLD; resume(list) of its chains continues through the fused
    continuation on 3b; above the threshold (lowered to 100) the same run
    takes the tiled kernel (4)."""
    m = _wide_model()
    s = mt.HMC(5, 0.1, mt.EmpMCTuner(0.8, adapt_step=20), mass_adapt="diag")
    task = m * s * mt.SerialMC(steps=96, burnin=48)
    assert pchains._route(MCMCTask(m, s, task.runner), True) == "warm"
    gk.reset_counts()
    glm_bign.reset_counts()
    cs = mt.run(task, chains=4, seed=0, fused=True)
    assert gk.PLAIN_CALLS["glm_multistep_rows"] > 0
    assert not any(glm_bign.PLAIN_CALLS.values())
    assert np.all(np.isfinite(cs[0].samples.values))

    calls = []
    orig = tws.fused_continue_chains
    monkeypatch.setattr(tws, "fused_continue_chains",
                        lambda *a, **kw: calls.append(1) or orig(*a, **kw))
    assert pchains.continuation_route(m, s, 4, True) == "warm"
    gk.reset_counts()
    cont = mt.resume(cs, steps=24, fused=True)
    monkeypatch.undo()
    assert calls and gk.PLAIN_CALLS["glm_multistep_rows"] > 0
    assert cont[0].task.pos == cs[0].task.pos + 24
    assert np.all(np.isfinite(cont[0].samples.values))

    monkeypatch.setattr(glm_bign, "BIGN_THRESHOLD", 100)
    gk.reset_counts()
    glm_bign.reset_counts()
    cs = mt.run(task, chains=4, seed=0, fused=True)
    assert glm_bign.PLAIN_CALLS["glm_logp_grad_tiled"] > 0
    assert not gk.PLAIN_CALLS["glm_multistep_rows"]
    assert np.all(np.isfinite(cs[0].samples.values))


def test_wide_routes_and_reasons(caplog):
    """NUTS at d 40, 256 and 257 takes the exact-NUTS kernels ("nuts") for
    a run and for a continuation (the wide tile, then from d 257 the
    very-wide one), HMC at d 256 and 257 the HMC kernels; no reason is
    logged, and none names exact NUTS on GLMs wider than 256 parameters
    (the item the very-wide NUTS kernel retired)."""
    runner = mt.SerialMC(steps=60, burnin=20)
    for d, hmc, nuts in ((40, "hmc", "nuts"), (256, "hmc", "nuts"),
                         (257, "hmc", "nuts")):
        mw = _wide_model(n=40, d=d, seed=d)
        caplog.clear()
        with caplog.at_level(logging.INFO):
            got = pchains._route(MCMCTask(mw, mt.HMC(5, 0.1), runner), True)
            assert got == hmc
            got = pchains._route(MCMCTask(mw, mt.NUTS(), runner), True)
            assert got == nuts
            assert pchains.continuation_route(mw, mt.NUTS(), 4, True) == nuts
        assert "wider than 256" not in caplog.text
        assert "generic torch engine" not in caplog.text


# ---- one whole path from the JAX package's states ---------------------------

def _as_dict(state):
    return {f.name: (_as_dict(getattr(state, f.name))
                     if dataclasses.is_dataclass(getattr(state, f.name))
                     else np.asarray(getattr(state, f.name)))
            for f in dataclasses.fields(state)}


def test_wide_continuation_matches_jax():
    """From the JAX package's adapted states of a d 40 logistic regression
    (adaptive HMC, diagonal metric, ``run(..., fused=True)`` in interpret
    mode), carried over with ``utils.convert``: the port's fused
    continuation (3b's plain version on the folded design) and the JAX
    package's keep the frozen step size and leap count, advance ``i``
    alike, end on exact (lp, grad), and agree in their per-chain means
    (|z| < 5) and acceptance (within 0.1)."""
    import jax
    import jax.numpy as jnp

    import mcmc_jl_tpu as mc
    from mcmc_jl_tpu.ops import warmstart as jws

    X, Y = _data("logistic", 120, 40, seed=91)
    jm = mc.model(glm=("logistic", X.astype(np.float64),
                       Y.astype(np.float64)))
    tm = mt.model(glm=("logistic", X.astype(np.float64),
                       Y.astype(np.float64)), dtype=torch.float64,
                  device="cpu")
    make = lambda p: p.HMC(5, 0.1, p.EmpMCTuner(0.8, adapt_step=25),  # noqa: E731
                           mass_adapt="diag")
    C, steps = 8, 48
    js = make(mc)
    jc = mc.run(jm * js * mc.SerialMC(steps=150, burnin=100), chains=C,
                seed=0, fused=True)
    jst = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs),
                                 *[c.task.state for c in jc])
    tst = mt.hmc_state_from_numpy(_as_dict(jax.device_get(jst)),
                                  device="cpu")
    ts = make(mt)
    assert pchains.continuation_route(tm, ts, C, True, tst) == "warm"
    jinfos, jout = jws.fused_continue_chains(jm, js, jst, steps,
                                             jax.random.PRNGKey(5),
                                             interpret=True)
    gk.reset_counts()
    tinfos, tout = tws.fused_continue_chains(tm, ts, tst, steps,
                                             make_generator("cpu", 5))
    assert gk.PLAIN_CALLS["glm_multistep_rows"] > 0
    assert set(tinfos) == set(jinfos)
    np.testing.assert_array_equal(tout.i.numpy(), np.asarray(jout.i))
    for path in ("tune.step_size", "tune.n_leaps"):
        a, b = tout, jout
        for name in path.split("."):
            a, b = getattr(a, name), getattr(b, name)
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-12)
    lp, g = tm.evalallg(tout.pars)
    torch.testing.assert_close(tout.logtarget, lp)
    torch.testing.assert_close(tout.grad, g)
    tp = tinfos["ppars"].double().numpy().mean(0)
    jp = np.asarray(jinfos["ppars"], np.float64).mean(0)
    se = np.sqrt(tp.var(0, ddof=1) / C + jp.var(0, ddof=1) / C)
    assert float(np.max(np.abs(tp.mean(0) - jp.mean(0)) / se)) < 5.0
    acc_t = float(tinfos["accept"].double().mean())
    acc_j = float(np.asarray(jinfos["accept"], np.float64).mean())
    assert abs(acc_t - acc_j) < 0.1, (acc_t, acc_j)


# ---- the CUDA kernels against their plain versions on a card ---------------

def test_wide_kernels_match_plain_on_card():
    """Kernels 1, 2, 3, 3b (and _mat) and 4 (and _mat) on the wide tile at
    d 33, 150 and 256 against their plain versions, on a ragged chain
    count (37) and a ragged N (301; 100,003 for kernel 4), each launch
    counted under its ``_wide`` key and repeated bitwise (skips without a
    card; chip_smoke.py phase_wide_kernels holds them at the paths'
    shapes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    cu = lambda a: _t(a).cuda().contiguous()  # noqa: E731
    C, N = 37, 301
    for d in (33, 150, 256):
        X, Y = _data("logistic", N, d, seed=d)
        rng = np.random.default_rng(d + 7)
        theta = cu(0.3 * rng.standard_normal((C, d)))
        m = cu(rng.standard_normal((C, d)))
        XT, Yc = cu(X.T), cu(Y)
        lp, g = _grad_at(XT, Yc, theta)
        gk.reset_counts()
        out = gk.glm_leapfrogs(XT, Yc, theta, m, g, 0.05, n_leaps=4)
        again = gk.glm_leapfrogs(XT, Yc, theta, m, g, 0.05, n_leaps=4)
        ref = gk.glm_leapfrogs_ref(XT, Yc, theta, m, g, 0.05, n_leaps=4)
        assert gk.LAUNCHES["glm_leapfrogs_wide"] == 2
        assert all(torch.equal(a, b) for a, b in zip(out, again))
        for a, b in zip(out, ref):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-3)
        logu = cu(np.log(rng.random((C, 1))))
        sk = gk.glm_step(XT, Yc, theta, g, lp[:, None], m, logu, 0.3,
                         n_leaps=4)
        sk2 = gk.glm_step(XT, Yc, theta, g, lp[:, None], m, logu, 0.3,
                          n_leaps=4)
        assert all(torch.equal(a, b) for a, b in zip(sk, sk2))
        sr = gk.glm_step_ref(XT, Yc, theta, g, lp[:, None], m, logu, 0.3,
                             n_leaps=4)
        assert int((sk[3] != sr[3]).sum()) <= 1
        same = (sk[3] == sr[3])[:, 0]
        torch.testing.assert_close(sk[0][same], sr[0][same], rtol=1e-4,
                                   atol=1e-3)
        gen = lambda: torch.Generator(device="cuda").manual_seed(d)  # noqa: E731
        k = 4
        mk = gk.glm_multistep(XT, Yc, theta, 0.3, k_trans=k, n_leaps=3,
                              generator=gen())
        mk2 = gk.glm_multistep(XT, Yc, theta, 0.3, k_trans=k, n_leaps=3,
                               generator=gen())
        assert all(torch.equal(a, b) for a, b in zip(mk, mk2))
        z, lu = gk.glm_multistep_draws(gk._seed(gen()), C, d, k,
                                       device="cuda")
        mr = gk.glm_multistep_ref(XT, Yc, theta, 0.3, k_trans=k, n_leaps=3,
                                  noise=(z, lu))
        same = (mk[3] == mr[3]) & ((mk[0] - mr[0]).abs().amax(-1) <= 1e-3)
        assert int((~same).sum()) <= 1
        L = _lower(rng, d)
        for prior in (1.3, cu(L.T @ L)):
            rk, rk2 = (gk.glm_multistep_rows(XT, Yc, theta, 0.3, 1.0, 7, 4,
                                             k_trans=k, generator=gen(),
                                             prior_prec=prior)
                       for _ in range(2))
            assert all(torch.equal(a, b) for a, b in zip(rk[:3], rk2[:3]))
            assert all(torch.equal(rk[3][n], rk2[3][n]) for n in rk[3])
            z3, lu3 = gk.glm_multistep_draws(gk._seed(gen()), C, d, k, i0=7,
                                             device="cuda")
            rr = gk.glm_multistep_rows_ref(XT, Yc, theta, 0.3, 1.0, 7, 4,
                                           k_trans=k, noise=(z3, lu3),
                                           prior_prec=prior)
            assert torch.equal(rk[3]["nleaps"], rr[3]["nleaps"])
            same = ((rk[3]["accept"] == rr[3]["accept"]).all(0)
                    & ((rk[0] - rr[0]).abs().amax(-1) <= 1e-3))
            assert int((~same).sum()) <= 1
            lp2, g2 = _grad_at(XT, Yc, rk[0], prior_prec=prior)
            torch.testing.assert_close(rk[1], g2, rtol=1e-4, atol=1e-3)
            torch.testing.assert_close(rk[2], lp2, rtol=1e-4, atol=1e-3)
        assert gk.LAUNCHES["glm_multistep_rows_wide"] == 2
        assert gk.LAUNCHES["glm_multistep_rows_mat_wide"] == 2
        # kernel 4 at a ragged N past one streamed tile, several splits
        Xb, Yb = _data("logistic", 100_003, d, seed=d + 1)
        XTb, Ybc = cu(Xb.T), cu(Yb)
        for prior in (1.0, cu(L.T @ L)):
            glm_bign.reset_counts()
            tk = glm_bign.glm_logp_grad_tiled(XTb, Ybc, theta,
                                              prior_prec=prior)
            tk2 = glm_bign.glm_logp_grad_tiled(XTb, Ybc, theta,
                                               prior_prec=prior)
            assert sum(glm_bign.LAUNCHES.values()) == 2
            assert all(torch.equal(a, b) for a, b in zip(tk, tk2))
            tr = glm_bign.glm_logp_grad_tiled_ref(XTb, Ybc, theta,
                                                  prior_prec=prior)
            torch.testing.assert_close(tk[0], tr[0], rtol=1e-5, atol=1e-2)
            torch.testing.assert_close(tk[1], tr[1], rtol=1e-4, atol=1e-2)
