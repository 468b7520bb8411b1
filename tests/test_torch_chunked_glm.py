"""GLMs wider than 1024 parameters: the port's GLM kernels 1, 2, 3b and 4
(mcmc_jl_tpu_torch/ops/glm_kernels.py, glm_bign.py) against the JAX
package's Pallas kernels (mcmc_jl_tpu/ops/pallas_glm.py,
pallas_glm_bign.py) in interpret mode on the CPU, at d 1056, 2048 and
4096, on the same numpy inputs and injected or replayed noise; the bounds
and counters of the chunked tier; the routes that take such a GLM through
``run(..., chains=N)`` (the HMC family and exact NUTS up to 16384
parameters; tests/test_torch_chunked_nuts.py holds the NUTS kernels); the
Philox draw ranges of kernels 3 and 3b at the bound; and one continuation
from the JAX package's adapted states carried over with
``utils.convert``.

On the CPU the wrappers run their plain versions.  Above d = 1024 the CUDA
kernels run on the chunked tier (csrc/glm_tile.cuh: the very-wide block
walking d in column chunks); ``test_chunked_kernels_match_plain_on_card``
holds them against the plain versions on a card, and chip_smoke.py's
``phase_chunked_kernels`` at the paths' shapes.  The JAX package pads d to
a multiple of 128 (1152 at d 1056); the port pads nothing.  Tolerances are
those of tests/test_torch_xwide_glm.py: float32 values to rtol and atol
2e-5, the gradient to atol 2e-4, lp to 2e-4 (probit adds the JAX kernel's
erf-free log Phi error, 1e-5 an observation)."""
import logging

import numpy as np
import pytest
import torch

import mcmc_jl_tpu_torch as mt
from mcmc_jl_tpu_torch.core.task import MCMCTask
from mcmc_jl_tpu_torch.ops import glm_bign
from mcmc_jl_tpu_torch.ops import glm_kernels as gk
from mcmc_jl_tpu_torch.ops import nuts_kernels as nk
from mcmc_jl_tpu_torch.ops import philox
from mcmc_jl_tpu_torch.ops import warmstart as tws
from mcmc_jl_tpu_torch.parallel import pchains
from mcmc_jl_tpu_torch.samplers.base import make_generator
from test_torch_wide_glm import (_as_dict, _as_t, _close, _data, _extras,
                                 _grad_at, _jax, _lower, _lp_atol, _t)

torch.set_num_threads(1)

G_ATOL = 2e-4  # tests/test_torch_xwide_glm.py's gradient atol above d 512


def _pad(d):
    return -(-d // 128) * 128


# ---- kernels 1 and 2: plain versions against the Pallas kernels -------------

@pytest.mark.parametrize("d,kind,extras", [(1056, "logistic", True),
                                           (2048, "probit", True),
                                           (4096, "logistic", False),
                                           (4096, "poisson", True)])
def test_leapfrogs_ref_matches_pallas_chunked(d, kind, extras):
    """Kernel 1's plain trajectory == the Pallas _kernel (interpret) on the
    padded design, at N 32 and d past the very-wide tile's 1024."""
    jnp, pg = _jax()
    n, C, eps, nl = 32, 8, 0.05, 3
    X, Y = _data(kind, n, d, seed=d)
    rng = np.random.default_rng(d + 1)
    theta = (0.3 * rng.standard_normal((C, d))).astype(np.float32)
    m = rng.standard_normal((C, d)).astype(np.float32)
    kw = _extras(n, d + 2) if extras else {}
    tkw = _as_t(kw)
    XTt, Yt = _t(X.T).contiguous(), _t(Y)
    _, g = _grad_at(XTt, Yt, _t(theta), kind=kind, **tkw)

    XT, Y2, d_pad = pg.pad_design(X, Y)
    assert d_pad == _pad(d)
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
    _close(pgr, np.asarray(jg)[:, :d], atol=G_ATOL)
    _close(plp, jlp, atol=_lp_atol(kind, n))
    assert np.all(np.asarray(jg)[:, d:] == 0)


@pytest.mark.parametrize("d,eps", [(1056, 0.15), (2048, 0.12), (4096, 0.1)])
def test_step_ref_matches_pallas_chunked(d, eps):
    """Kernel 2's plain transition with injected m0 and logu == the Pallas
    _step_kernel, on a mix of accepts and rejects."""
    jnp, pg = _jax()
    n, C, nl = 32, 16, 4
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
    _close(pgr, np.asarray(jg)[:, :d], atol=G_ATOL)
    _close(plp, jlp, atol=2e-4)


# ---- kernel 3b: the plain version on replayed draws -------------------------

@pytest.mark.parametrize("prior,d,eps", [("scalar", 1056, 0.25),
                                         ("row", 2048, 0.25),
                                         ("matrix", 4096, 0.12)])
def test_rows_ref_on_replayed_draws_matches_pallas_chunked(prior, d, eps):
    """Kernel 3b's plain version, fed the replayed draws of a
    glm_multistep_rows launch from absolute transition i0, with the scalar
    prior, a (d,) row or a (d, d) matrix A = L'L == the Pallas trajectory
    kernel (interpret, the same prior) and the NaN-rejecting test,
    transition by transition at the Halton leap counts: accept decisions
    equal, rows within float32 rounding."""
    jnp, pg = _jax()
    n, C, k, i0 = 32, 8, 3, 29
    T, max_leaps = 2 * eps, 3
    X, Y = _data("logistic", n, d, seed=70 + d)
    rng = np.random.default_rng(71 + d)
    theta = (0.3 * rng.standard_normal((C, d))).astype(np.float32)
    d_pad = _pad(d)
    if prior == "scalar":
        lam_t = jprior = 1.0
    elif prior == "row":
        lam = rng.uniform(0.5, 2.0, d).astype(np.float32)
        lam_t = _t(lam)
        jprior = jnp.asarray(np.concatenate(
            [lam, np.ones(d_pad - d, np.float32)])[None])
    else:
        L = _lower(rng, d).astype(np.float32)
        lam = L.T @ L
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
        _close(rows["pgrads"][t], np.asarray(jg)[:, :d], atol=G_ATOL)
        _close(rows["plogtarget"][t], np.asarray(jlp), atol=2e-4)
    assert 0 < float(rows["accept"].float().mean()) < 1, \
        "want a mix of accepts and rejects"
    _close(th, np.asarray(jth)[:, :d])
    _close(lp, np.asarray(jlp), atol=2e-4)


# ---- kernel 4: the tiled (lp, g) ------------------------------------------

@pytest.mark.parametrize("case,d", [("logistic", 1056),
                                    ("probit_w_o_row", 2048),
                                    ("poisson_mat", 4096)])
def test_tiled_ref_matches_pallas_chunked(case, d):
    """Kernel 4's plain (lp, grad) == the Pallas _grad_kernel in interpret
    mode (tile 32, so N = 40 is not a multiple of it): plain, with
    weights, offsets and a (d,) prior row, and with a (d, d) matrix
    prior."""
    from mcmc_jl_tpu.ops.pallas_glm_bign import glm_logp_grad_tiled as jtiled
    from mcmc_jl_tpu.ops.pallas_glm_bign import pad_design_tiled

    jnp, _ = _jax()

    kind = case.split("_")[0]
    n, C = 40, 8
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
        L = _lower(rng, d).astype(np.float32)
        lam = L.T @ L
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


# ---- bounds, counters and draws ---------------------------------------------

def test_chunked_bounds_and_counters():
    """The HMC and N-tiled kernels take d up to D_MAX = 131072 on the chunked
    tier, and so do the exact-NUTS kernels (NUTS_D_MAX); the very-wide
    tile's bound is XWIDE_D_MAX = 1024; a launch above 1024 counts under
    ``<name>_chunked`` (``<name>_mat_chunked`` with a matrix prior), at
    1024 still under ``_xwide``; the tiled kernel's grid takes 16 chains a
    CTA there, as on the wide and very-wide tiles."""
    assert gk.D_MAX == nk.NUTS_D_MAX == 131072
    assert gk.XWIDE_D_MAX == 1024
    for name in ("glm_leapfrogs", "glm_step", "glm_multistep",
                 "glm_multistep_rows"):
        assert gk._counted(name, None, 1024) == name + "_xwide"
        assert gk._counted(name, None, 1025) == name + "_chunked"
        assert gk._counted(name, None, gk.D_MAX) == name + "_chunked"
        assert name + "_chunked" in gk.LAUNCHES
    assert (gk._counted("glm_multistep_rows", object(), 1025)
            == "glm_multistep_rows_mat_chunked")
    assert "glm_multistep_rows_mat_chunked" in gk.LAUNCHES
    assert (glm_bign._counted("glm_logp_grad_tiled", None, 4096)
            == "glm_logp_grad_tiled_chunked")
    assert (glm_bign._counted("glm_logp_grad_tiled", object(), 2048)
            == "glm_logp_grad_tiled_mat_chunked")
    assert {"glm_logp_grad_tiled_chunked",
            "glm_logp_grad_tiled_mat_chunked"} <= set(glm_bign.LAUNCHES)
    for name in ("glm_nuts_transition", "glm_nuts_multistep"):
        assert gk._counted(name, None, 1025) == name + "_chunked"
        assert gk._counted(name, object(), gk.D_MAX) == name + "_mat_chunked"
        assert {name + "_chunked", name + "_mat_chunked"} <= set(nk.LAUNCHES)
    assert gk._slots("cpu", 256, 4096, 0) == (None, 0)
    assert glm_bign.splits_for(20_000, 512, 4096) == \
        glm_bign.splits_for(20_000, 512, 1024) == 8
    N, C = 20, 3
    for name, d_ok, d_max in (("glm_leapfrogs", 1025, gk.D_MAX),
                              ("glm_logp_grad_tiled", 4096, gk.D_MAX),
                              ("glm_nuts_multistep", 1025, gk.D_MAX)):
        for d in (d_ok, d_max):
            gk._check(name, torch.zeros(d, N), torch.zeros(N), None, None,
                      "logistic", {"theta": torch.zeros(C, d)})
        with pytest.raises(ValueError,
                           match=f"outside the kernel's 1..{d_max}"):
            gk._check(name, torch.zeros(d_max + 1, N), torch.zeros(N), None,
                      None, "logistic", {"theta": torch.zeros(C, d_max + 1)})


def test_chunked_draw_ranges_disjoint():
    """Kernels 3 and 3b draw coordinate j of a momentum from Philox draw j
    // 2 (words 0, 1 for even j, 2, 3 for odd) and the MH uniform from
    draw SLICE_DRAW, counted by (chain, transition): at the bound D_MAX
    (131072) the momenta take draws 0 .. 65535, below SLICE_DRAW, so no
    coordinate shares a draw with the uniform; the replay at d = D_MAX
    gives coordinates 0, 65537 and 131071 the normals of their own
    draws."""
    d, C, k, i0, seed = gk.D_MAX, 2, 2, 7, 0xC0FFEE
    assert (d + 1) // 2 - 1 < gk.SLICE_DRAW
    m0, logu = gk.glm_multistep_draws(seed, C, d, k, i0=i0)
    assert m0.shape == (k, C, d) and logu.shape == (k, C)
    for t, c, j in ((0, 0, 0), (1, 1, d - 1), (0, 1, d // 2 + 1)):
        b = philox.philox4x32((c, i0 + t, j // 2, 0), seed)
        want = (philox.box_muller(b[2], b[3]) if j % 2
                else philox.box_muller(b[0], b[1]))
        assert float(m0[t, c, j]) == float(want)
    u = philox.philox4x32((1, i0 + 1, gk.SLICE_DRAW, 0), seed)[0]
    assert float(logu[1, 1]) == float(philox.log1m_u01(u))


# ---- routes through run(..., chains=N) ---------------------------------------

def _chunked_model(n=40, d=2048, seed=90):
    X, Y = _data("logistic", n, d, seed)
    return mt.model(glm=("logistic", X, Y), device="cpu")


def test_chunked_routes_and_reasons(caplog):
    """At d 2048 plain HMC routes to "hmc", adaptive HMC and the NUTS warm
    handoff to "warm", and adaptive HMC's continuation to "warm", with no
    reason logged; exact NUTS (unit and diagonal metrics) and its
    continuation route to "nuts" (kernels 8 and 9 on the chunked tier),
    with no reason logged either; above D_MAX every route is generic,
    exact NUTS's too, with the reason naming the GLM kernels' bound."""
    runner = mt.SerialMC(steps=60, burnin=20)
    adaptive = mt.HMC(5, 0.1, mt.EmpMCTuner(0.8, adapt_step=20),
                      mass_adapt="diag")
    handoff = mt.NUTS(6, warm_handoff=True)
    m = _chunked_model()
    caplog.clear()
    with caplog.at_level(logging.INFO):
        assert pchains._route(MCMCTask(m, mt.HMC(5, 0.1), runner),
                              True) == "hmc"
        for s in (adaptive, handoff):
            assert pchains._route(MCMCTask(m, s, runner), True) == "warm"
        assert pchains.continuation_route(m, adaptive, 4, True) == "warm"
    assert "generic torch engine" not in caplog.text
    caplog.clear()
    with caplog.at_level(logging.INFO):
        for ma in (None, "diag"):
            s = mt.NUTS(6) if ma is None else mt.NUTS(6, mass_adapt=ma)
            assert pchains._route(MCMCTask(m, s, runner), True) == "nuts"
            assert pchains.continuation_route(m, s, 4, True) == "nuts"
    assert "generic torch engine" not in caplog.text
    assert "wider than" not in caplog.text
    wide = _chunked_model(n=4, d=gk.D_MAX + 1)
    caplog.clear()
    with caplog.at_level(logging.INFO):
        for s in (mt.HMC(5, 0.1), adaptive, mt.NUTS(6)):
            assert pchains._route(MCMCTask(wide, s, runner), True) is False
    why = (f"d = {gk.D_MAX + 1} > {gk.D_MAX}, the GLM kernels' bound "
           f"(ROADMAP: GLMs wider than {gk.D_MAX} parameters)")
    assert sum(why in r.getMessage() for r in caplog.records) == 3
    assert "exact NUTS on GLMs wider than" not in caplog.text


def test_chunked_hmc_family_runs_fused():
    """At d 2048 ``run(..., fused=True)``: plain HMC through kernel 1's
    plain version once a transition, adaptive HMC diag's and the NUTS warm
    handoff's sampling phases through 3b's; exact NUTS's sampling phase
    through kernel 8's plain version once a transition (the CPU's route:
    the card takes kernel 9 when the steps split into launches of 2-8) and
    through no HMC kernel; every sample finite."""
    m = _chunked_model(n=32)
    C = 3
    for sampler, runner, name, calls in (
            (mt.HMC(3, 0.1), mt.SerialMC(steps=6, burnin=2),
             "glm_leapfrogs", 6),
            (mt.HMC(3, 0.1, mt.EmpMCTuner(0.8, adapt_step=4),
                    mass_adapt="diag"), mt.SerialMC(steps=12, burnin=4),
             "glm_multistep_rows", None),
            (mt.NUTS(4, warm_handoff=True), mt.SerialMC(steps=12, burnin=6),
             "glm_multistep_rows", None),
            (mt.NUTS(4), mt.SerialMC(steps=6, burnin=3), None, None)):
        gk.reset_counts()
        nk.reset_counts()
        cs = mt.run(m * sampler * runner, chains=C, seed=0, fused=True)
        plain = {k: v for k, v in gk.PLAIN_CALLS.items() if v}
        if name is None:
            assert not plain
            assert nk.PLAIN_CALLS == {**dict.fromkeys(nk.PLAIN_CALLS, 0),
                                      "glm_nuts_transition": 3}
        else:
            assert set(plain) == {name}
            assert calls is None or plain[name] == calls
        v = np.stack([c.samples.values for c in cs])
        assert v.shape == (C, len(runner.r), 2048) and np.all(np.isfinite(v))


def test_chunked_run_until_nuts_blocks_generic(caplog):
    """``run_until(NUTS(3), ...)`` on the d 2048 GLM with ``fused=True``:
    past the warmup its blocks continue through kernel 8's plain version
    once a transition (the CPU's route; no HMC kernel, no reason logged),
    to max_steps; the same with adaptive HMC continues through 3b's plain
    version.  The draws are finite.  (Named for the generic blocks NUTS
    took here before the chunked tier ran kernels 8 and 9.)"""
    m = _chunked_model(n=24)
    for sampler, name in ((mt.NUTS(3), None),
                          (mt.HMC(3, 0.1, mt.EmpMCTuner(0.8, adapt_step=4),
                                  mass_adapt="diag"), "glm_multistep_rows")):
        gk.reset_counts()
        nk.reset_counts()
        caplog.clear()
        with caplog.at_level(logging.INFO):
            res = mt.run_until(m, sampler, n_chains=3, rhat_target=0.5,
                               min_ess=1, check_every=4, warmup=4,
                               max_steps=12, seed=0, fused=True)
        assert res.steps_run == 12 and not res.converged
        assert nk.PLAIN_CALLS == {**dict.fromkeys(nk.PLAIN_CALLS, 0),
                                  **({"glm_nuts_transition": 8}
                                     if name is None else {})}
        plain = {k for k, v in gk.PLAIN_CALLS.items() if v}
        assert plain == (set() if name is None else {name})
        assert "generic torch engine" not in caplog.text
        assert "wider than" not in caplog.text
        assert np.all(np.isfinite(res.samples))


def test_chunked_continuation_matches_jax():
    """From the JAX package's adapted states of a d 2048 logistic
    regression (adaptive HMC, diagonal metric, ``run(..., fused=True)`` in
    interpret mode), carried over with ``utils.convert``: the port's fused
    continuation (3b's plain version on the folded design) and the JAX
    package's keep the frozen step size and leap count, advance ``i``
    alike, end on exact (lp, grad), and agree in their per-chain means
    (|z| < 5) and acceptance (within 0.15)."""
    import jax
    import jax.numpy as jnp

    import mcmc_jl_tpu as mc
    from mcmc_jl_tpu.ops import warmstart as jws

    X, Y = _data("logistic", 40, 2048, seed=91)
    jm = mc.model(glm=("logistic", X.astype(np.float64),
                       Y.astype(np.float64)))
    tm = mt.model(glm=("logistic", X.astype(np.float64),
                       Y.astype(np.float64)), dtype=torch.float64,
                  device="cpu")
    make = lambda p: p.HMC(4, 0.1, p.EmpMCTuner(0.8, adapt_step=10),  # noqa: E731
                           mass_adapt="diag")
    C, steps = 8, 16
    js = make(mc)
    jc = mc.run(jm * js * mc.SerialMC(steps=30, burnin=20), chains=C,
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

def test_chunked_kernels_match_plain_on_card():
    """Kernels 1, 2, 3, 3b (and _mat) and 4 (and _mat) on the chunked tier
    at d 1056 and 2048 against their plain versions, on a ragged chain
    count (37) and a ragged N (601, two row blocks; 3001 for kernel 4,
    several splits), each launch counted under its ``_chunked`` key and
    repeated bitwise (skips without a card; chip_smoke.py
    phase_chunked_kernels holds them at the paths' shapes and up to d
    16384)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    cu = lambda a: _t(a).cuda().contiguous()  # noqa: E731
    C, N = 37, 601
    for d in (1056, 2048):
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
        assert gk.LAUNCHES["glm_leapfrogs_chunked"] == 2
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
        k = 3
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
        assert gk.LAUNCHES["glm_multistep_rows_chunked"] == 4
        assert gk.LAUNCHES["glm_multistep_rows_mat_chunked"] == 2
        # kernel 4 at a ragged N past several row blocks and splits
        Xb, Yb = _data("logistic", 3001, d, seed=d + 1)
        XTb, Ybc = cu(Xb.T), cu(Yb)
        for prior in (1.0, cu(L.T @ L)):
            glm_bign.reset_counts()
            tk = glm_bign.glm_logp_grad_tiled(XTb, Ybc, theta,
                                              prior_prec=prior)
            tk2 = glm_bign.glm_logp_grad_tiled(XTb, Ybc, theta,
                                               prior_prec=prior)
            assert glm_bign.LAUNCHES[glm_bign._counted(
                "glm_logp_grad_tiled",
                None if isinstance(prior, float) else prior, d)] == 2
            assert all(torch.equal(a, b) for a, b in zip(tk, tk2))
            tr = glm_bign.glm_logp_grad_tiled_ref(XTb, Ybc, theta,
                                                  prior_prec=prior)
            torch.testing.assert_close(tk[0], tr[0], rtol=1e-5, atol=1e-2)
            torch.testing.assert_close(tk[1], tr[1], rtol=1e-4, atol=1e-2)
