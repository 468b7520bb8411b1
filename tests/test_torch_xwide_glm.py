"""GLMs wider than 256 parameters: the port's GLM kernels 1, 2, 3b and 4
(mcmc_jl_tpu_torch/ops/glm_kernels.py, glm_bign.py) against the JAX
package's Pallas kernels (mcmc_jl_tpu/ops/pallas_glm.py,
pallas_glm_bign.py) in interpret mode on the CPU, at d 257, 300 and 1024,
on the same numpy inputs and injected or replayed noise; the routes that
take such a GLM through ``run(..., chains=N)`` and ``resume(list)`` (the
HMC family and exact NUTS up to 1024 parameters); and one
continuation from the JAX package's adapted states carried over with
``utils.convert``.

On the CPU the wrappers run their plain versions.  Above d = 256 the CUDA
kernels run on the very-wide chain tile (csrc/glm_tile.cuh);
``test_xwide_kernels_match_plain_on_card`` holds them against the plain
versions on a card, and chip_smoke.py's ``phase_xwide_kernels`` at the
paths' shapes.  The JAX package pads d to 128 lanes (384 at d 257 and
300); the port pads nothing.  Tolerances are those of
tests/test_torch_wide_glm.py: float32 values to rtol and atol 2e-5, the
gradient to atol 1e-4, lp to 2e-4 (probit adds the JAX kernel's erf-free
log Phi error, 1e-5 an observation); at d 1024 the gradient of the
trajectory and the transition is held to atol 2e-4, since each of its
components sums N terms whose theta . x are sums of 1024 products
rounded in another order in XLA's and PyTorch's float32 dots."""
import logging

import numpy as np
import pytest
import torch

import mcmc_jl_tpu_torch as mt
from mcmc_jl_tpu_torch.core.task import MCMCTask
from mcmc_jl_tpu_torch.ops import glm_bign
from mcmc_jl_tpu_torch.ops import glm_kernels as gk
from mcmc_jl_tpu_torch.ops import nuts_kernels as nk
from mcmc_jl_tpu_torch.ops import warmstart as tws
from mcmc_jl_tpu_torch.parallel import pchains
from mcmc_jl_tpu_torch.samplers.base import make_generator
from test_torch_wide_glm import (_as_dict, _as_t, _close, _data, _extras,
                                 _grad_at, _jax, _lower, _lp_atol, _t)

torch.set_num_threads(1)


def _g_atol(d):
    return 2e-4 if d > 512 else 1e-4


# ---- kernels 1 and 2: plain versions against the Pallas kernels -------------

TRAJ_CASES = [(257, "logistic", True), (300, "linear", True),
              (300, "probit", True), (1024, "logistic", False),
              (1024, "poisson", True)]


@pytest.mark.parametrize("d,kind,extras", TRAJ_CASES)
def test_leapfrogs_ref_matches_pallas_xwide(d, kind, extras):
    """Kernel 1's plain trajectory == the Pallas _kernel (interpret) on the
    padded design, at N 48 and d past the wide tile's 256."""
    jnp, pg = _jax()
    n, C, eps, nl = 48, 8, 0.05, 3
    X, Y = _data(kind, n, d, seed=d)
    rng = np.random.default_rng(d + 1)
    theta = (0.3 * rng.standard_normal((C, d))).astype(np.float32)
    m = rng.standard_normal((C, d)).astype(np.float32)
    kw = _extras(n, d + 2) if extras else {}
    tkw = _as_t(kw)
    XTt, Yt = _t(X.T).contiguous(), _t(Y)
    _, g = _grad_at(XTt, Yt, _t(theta), kind=kind, **tkw)

    XT, Y2, d_pad = pg.pad_design(X, Y)
    assert d_pad == -(-d // 128) * 128
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
    _close(pgr, np.asarray(jg)[:, :d], atol=_g_atol(d))
    _close(plp, jlp, atol=_lp_atol(kind, n))
    assert np.all(np.asarray(jg)[:, d:] == 0)


@pytest.mark.parametrize("d,eps", [(257, 0.2), (1024, 0.15)])
def test_step_ref_matches_pallas_xwide(d, eps):
    """Kernel 2's plain transition with injected m0 and logu == the Pallas
    _step_kernel, on a mix of accepts and rejects."""
    jnp, pg = _jax()
    n, C, nl = 48, 16, 4
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
    _close(pgr, np.asarray(jg)[:, :d], atol=_g_atol(d))
    _close(plp, jlp, atol=2e-4)


# ---- kernel 3b: the plain version on replayed draws -------------------------

@pytest.mark.parametrize("prior,d", [("scalar", 257), ("row", 300),
                                     ("matrix", 1024)])
def test_rows_ref_on_replayed_draws_matches_pallas_xwide(prior, d):
    """Kernel 3b's plain version, fed the replayed draws of a
    glm_multistep_rows launch from absolute transition i0, with the scalar
    prior, a (d,) row or a (d, d) matrix A = L'L == the Pallas trajectory
    kernel (interpret, the same prior) and the NaN-rejecting test,
    transition by transition at the Halton leap counts: accept decisions
    equal, rows within float32 rounding."""
    jnp, pg = _jax()
    n, C, k, i0 = 48, 8, 4, 29
    eps, T, max_leaps = 0.25, 0.75, 4
    X, Y = _data("logistic", n, d, seed=70 + d)
    rng = np.random.default_rng(71 + d)
    theta = (0.3 * rng.standard_normal((C, d))).astype(np.float32)
    d_pad = -(-d // 128) * 128
    if prior == "scalar":
        lam_t = jprior = 1.0
    elif prior == "row":
        lam = rng.uniform(0.5, 2.0, d).astype(np.float32)
        lam_t = _t(lam)
        jprior = jnp.asarray(np.concatenate(
            [lam, np.ones(d_pad - d, np.float32)])[None])
    else:
        L = _lower(rng, d)
        lam = (L.T @ L).astype(np.float32)
        lam_t, jprior = _t(lam), jnp.asarray(lam)
    XTt, Yt = _t(X.T).contiguous(), _t(Y)
    z, logu = gk.glm_multistep_draws(0x5EED_0F_CAFE + d, C, d, k, i0=i0)
    th, g, lp, rows = gk.glm_multistep_rows_ref(
        XTt, Yt, _t(theta), eps, T, i0, max_leaps, k_trans=k,
        noise=(z, logu), prior_prec=lam_t)
    nls = [gk.halton_leaps(i0 + t, eps, T, max_leaps) for t in range(k)]
    assert rows["nleaps"].tolist() == [[nl] * C for nl in nls]

    XT, Y2, _ = pg.pad_design(X, Y)
    lp0, g0 = _grad_at(XTt, Yt, _t(theta), prior_prec=lam_t)
    jth, jg = (pg.pad_chains(jnp.asarray(a, jnp.float32), d_pad)
               for a in (theta, g0.numpy()))
    jlp = jnp.asarray(lp0.numpy())
    for t in range(k):
        m0 = pg.pad_chains(jnp.asarray(z[t].numpy()), d_pad)
        p_th, p_m, p_g, p_lp = pg.glm_hmc_leapfrogs(
            XT, Y2, jth, m0, jg, eps, n_leaps=nls[t], interpret=True,
            block_chains=C, prior_prec=jprior)
        ratio = ((-jlp + 0.5 * jnp.sum(m0 * m0, axis=1))
                 - (-p_lp + 0.5 * jnp.sum(p_m * p_m, axis=1)))
        acc = np.asarray(jnp.where(jnp.isnan(ratio), False,
                                   (ratio > 0) | (ratio > logu[t].numpy())))
        jth = jnp.where(acc[:, None], p_th, jth)
        jg = jnp.where(acc[:, None], p_g, jg)
        jlp = jnp.where(acc, p_lp, jlp)
        np.testing.assert_array_equal(rows["accept"][t].numpy(), acc)
        _close(rows["ppars"][t], np.asarray(jth)[:, :d])
        _close(rows["pgrads"][t], np.asarray(jg)[:, :d], atol=_g_atol(d))
        _close(rows["plogtarget"][t], np.asarray(jlp), atol=2e-4)
    assert 0 < float(rows["accept"].float().mean()) < 1, \
        "want a mix of accepts and rejects"
    _close(th, np.asarray(jth)[:, :d])
    _close(lp, np.asarray(jlp), atol=2e-4)


# ---- kernel 4: the tiled (lp, g) ------------------------------------------

@pytest.mark.parametrize("case,d", [("logistic", 257),
                                    ("probit_w_o_row", 300),
                                    ("poisson_mat", 1024)])
def test_tiled_ref_matches_pallas_xwide(case, d):
    """Kernel 4's plain (lp, grad) == the Pallas _grad_kernel in interpret
    mode (tile 32, so N = 60 is not a multiple of it): plain, with
    weights, offsets and a (d,) prior row, and with a (d, d) matrix
    prior."""
    from mcmc_jl_tpu.ops.pallas_glm_bign import glm_logp_grad_tiled as jtiled
    from mcmc_jl_tpu.ops.pallas_glm_bign import pad_design_tiled

    jnp, _ = _jax()

    kind = case.split("_")[0]
    n, C = 60, 8
    X, Y = _data(kind, n, d, seed=80 + d)
    rng = np.random.default_rng(81 + d)
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
    XTj, Y2, Wj, d_pad, _ = pad_design_tiled(X, Y, weights=w, tile_n=32)
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
                     tile_n=32, block_chains=C, interpret=True, kind=kind,
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


def test_xwide_bounds_and_counters():
    """The very-wide tile takes d up to 1024 (XWIDE_D_MAX; the HMC, N-tiled
    and exact-NUTS kernels go on to D_MAX = NUTS_D_MAX on the chunked
    tier); a launch above 256 counts under ``<name>_xwide``
    (``<name>_mat_xwide`` with a matrix prior); the very-wide tile's
    scratch is allocated only above 256; the tiled kernel's grid takes 16
    chains a CTA there, as on the wide tile."""
    assert gk.XWIDE_D_MAX == 1024 and gk.WIDE_D_MAX == 256
    assert nk.NUTS_D_MAX == gk.D_MAX
    assert gk._counted("glm_step", None, 256) == "glm_step_wide"
    assert gk._counted("glm_step", None, 257) == "glm_step_xwide"
    assert (gk._counted("glm_multistep_rows", object(), 1024)
            == "glm_multistep_rows_mat_xwide")
    assert (glm_bign._counted("glm_logp_grad_tiled", object(), 300)
            == "glm_logp_grad_tiled_mat_xwide")
    for name in ("glm_leapfrogs", "glm_step", "glm_multistep",
                 "glm_multistep_rows", "glm_multistep_rows_mat"):
        assert name + "_xwide" in gk.LAUNCHES
    assert {"glm_logp_grad_tiled_xwide",
            "glm_logp_grad_tiled_mat_xwide"} <= set(glm_bign.LAUNCHES)
    for name in ("glm_nuts_transition", "glm_nuts_multistep"):
        assert {name + "_xwide", name + "_mat_xwide"} <= set(nk.LAUNCHES)
        assert gk._counted(name, object(), 1024) == name + "_mat_xwide"
    assert nk._scratch("cpu", 32, 1000, 6) == (None, 0)
    assert gk._slots("cpu", 256, 4096) == (None, 0)
    assert glm_bign.splits_for(20_000, 512, 1024) == 8
    assert glm_bign.splits_for(20_000, 512, 1024) == \
        glm_bign.splits_for(20_000, 512, 150)
    N, C = 40, 3
    for d in (257, 1024):
        gk._check("glm_step", torch.zeros(d, N), torch.zeros(N), None, None,
                  "logistic", {"theta": torch.zeros(C, d)})
        gk._check("glm_nuts_transition", torch.zeros(d, N), torch.zeros(N),
                  None, None, "logistic", {"theta": torch.zeros(C, d)})
    for name, d_max in (("glm_step", gk.D_MAX),
                        ("glm_nuts_transition", nk.NUTS_D_MAX)):
        with pytest.raises(ValueError,
                           match=f"outside the kernel's 1..{d_max}"):
            gk._check(name, torch.zeros(d_max + 1, N), torch.zeros(N), None,
                      None, "logistic", {"theta": torch.zeros(C, d_max + 1)})


# ---- routes through run(..., chains=N) and resume(list) ---------------------

def _xwide_model(n=40, d=300, seed=90):
    X, Y = _data("logistic", n, d, seed)
    return mt.model(glm=("logistic", X, Y), device="cpu")


def test_xwide_routes_and_reasons(caplog):
    """At d 257 and 1024 plain HMC routes to "hmc" (kernel 1's driver),
    adaptive HMC and the NUTS warm handoff to "warm" (3b, or 4 above
    BIGN_THRESHOLD), and their continuations to "warm"; exact NUTS to
    "nuts" (kernels 8 and 9 on the very-wide tile), its continuation too,
    with no reason logged (none names exact NUTS on GLMs wider than 256
    parameters any more); at d 1025 every route stays fused, exact NUTS's
    too (the chunked tier), with no reason logged."""
    runner = mt.SerialMC(steps=60, burnin=20)
    nuts_why = "exact NUTS on GLMs wider than"
    adaptive = mt.HMC(5, 0.1, mt.EmpMCTuner(0.8, adapt_step=20),
                      mass_adapt="diag")
    handoff = mt.NUTS(6, warm_handoff=True)
    for d in (257, 1024, 1025):
        m = _xwide_model(d=d, seed=d)
        caplog.clear()
        with caplog.at_level(logging.INFO):
            assert pchains._route(MCMCTask(m, mt.HMC(5, 0.1), runner),
                                  True) == "hmc"
            for s in (adaptive, handoff):
                assert pchains._route(MCMCTask(m, s, runner), True) == "warm"
            assert pchains.continuation_route(m, adaptive, 4, True) == "warm"
            assert pchains._route(MCMCTask(m, mt.NUTS(), runner),
                                  True) == "nuts"
            assert pchains.continuation_route(m, mt.NUTS(), 4, True) == \
                "nuts"
        assert nuts_why not in caplog.text
        assert f"d = {d} > 256" not in caplog.text
        assert "generic torch engine" not in caplog.text


def test_xwide_plain_and_adaptive_hmc_run_fused():
    """At d 300 plain HMC runs through kernel 1's plain version once a
    transition, and adaptive HMC's sampling phase through 3b's (through
    the tiled kernel's above BIGN_THRESHOLD, lowered to 30); the samples
    are finite and the plain run accepts."""
    m = _xwide_model()
    task = m * mt.HMC(4, 0.1) * mt.SerialMC(steps=24, burnin=8)
    gk.reset_counts()
    glm_bign.reset_counts()
    cs = mt.run(task, chains=3, seed=0, fused=True)
    assert gk.PLAIN_CALLS == {"glm_leapfrogs": 24, "glm_step": 0,
                              "glm_multistep": 0, "glm_multistep_rows": 0}
    assert not any(glm_bign.PLAIN_CALLS.values())
    assert cs[0].samples.shape == (16, 300)
    assert np.all(np.isfinite(cs[0].samples.values))
    assert mt.acceptance(cs[0]) > 30
    s = mt.HMC(4, 0.1, mt.EmpMCTuner(0.8, adapt_step=8), mass_adapt="diag")
    task = m * s * mt.SerialMC(steps=24, burnin=16)
    for bign in (False, True):
        gk.reset_counts()
        glm_bign.reset_counts()
        if bign:
            old, glm_bign.BIGN_THRESHOLD = glm_bign.BIGN_THRESHOLD, 30
        try:
            cs = mt.run(task, chains=3, seed=0, fused=True)
        finally:
            if bign:
                glm_bign.BIGN_THRESHOLD = old
        assert (glm_bign.PLAIN_CALLS["glm_logp_grad_tiled"] > 0) == bign
        assert (gk.PLAIN_CALLS["glm_multistep_rows"] > 0) != bign
        assert np.all(np.isfinite(cs[0].samples.values))


def test_xwide_continuation_matches_jax():
    """From the JAX package's adapted states of a d 300 logistic regression
    (adaptive HMC, diagonal metric, ``run(..., fused=True)`` in interpret
    mode), carried over with ``utils.convert``: the port's fused
    continuation (3b's plain version on the folded design) and the JAX
    package's keep the frozen step size and leap count, advance ``i``
    alike, end on exact (lp, grad), and agree in their per-chain means
    (|z| < 5) and acceptance (within 0.15)."""
    import jax
    import jax.numpy as jnp

    import mcmc_jl_tpu as mc
    from mcmc_jl_tpu.ops import warmstart as jws

    X, Y = _data("logistic", 60, 300, seed=91)
    jm = mc.model(glm=("logistic", X.astype(np.float64),
                       Y.astype(np.float64)))
    tm = mt.model(glm=("logistic", X.astype(np.float64),
                       Y.astype(np.float64)), dtype=torch.float64,
                  device="cpu")
    make = lambda p: p.HMC(4, 0.1, p.EmpMCTuner(0.8, adapt_step=15),  # noqa: E731
                           mass_adapt="diag")
    C, steps = 8, 24
    js = make(mc)
    jc = mc.run(jm * js * mc.SerialMC(steps=48, burnin=32), chains=C,
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
    assert abs(acc_t - acc_j) < 0.15, (acc_t, acc_j)


# ---- the CUDA kernels against their plain versions on a card ---------------

def test_xwide_kernels_match_plain_on_card():
    """Kernels 1, 2, 3, 3b (and _mat) and 4 (and _mat) on the very-wide tile
    at d 257 and 1024 against their plain versions, on a ragged chain count
    (37) and a ragged N (301; 20,003 for kernel 4), each launch counted
    under its ``_xwide`` key and repeated bitwise (skips without a card;
    chip_smoke.py phase_xwide_kernels holds them at the paths' shapes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    cu = lambda a: _t(a).cuda().contiguous()  # noqa: E731
    C, N = 37, 301
    for d in (257, 1024):
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
        assert gk.LAUNCHES["glm_leapfrogs_xwide"] == 2
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
        for prior in (1.3, cu(rng.uniform(0.5, 2.0, d)), cu(L.T @ L)):
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
        assert gk.LAUNCHES["glm_multistep_rows_xwide"] == 4
        assert gk.LAUNCHES["glm_multistep_rows_mat_xwide"] == 2
        # kernel 4 at a ragged N past one flush of rows, several splits
        Xb, Yb = _data("logistic", 20_003, d, seed=d + 1)
        XTb, Ybc = cu(Xb.T), cu(Yb)
        for prior in (1.0, cu(L.T @ L)):
            glm_bign.reset_counts()
            tk = glm_bign.glm_logp_grad_tiled(XTb, Ybc, theta,
                                              prior_prec=prior)
            tk2 = glm_bign.glm_logp_grad_tiled(XTb, Ybc, theta,
                                               prior_prec=prior)
            assert sum(glm_bign.LAUNCHES.values()) == 2
            assert glm_bign.LAUNCHES[glm_bign._counted(
                "glm_logp_grad_tiled",
                None if isinstance(prior, float) else prior, d)] == 2
            assert all(torch.equal(a, b) for a, b in zip(tk, tk2))
            tr = glm_bign.glm_logp_grad_tiled_ref(XTb, Ybc, theta,
                                                  prior_prec=prior)
            torch.testing.assert_close(tk[0], tr[0], rtol=1e-5, atol=1e-2)
            torch.testing.assert_close(tk[1], tr[1], rtol=1e-4, atol=1e-2)
