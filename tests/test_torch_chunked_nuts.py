"""Exact NUTS on GLMs of 1025 to 16384 parameters: the plain versions of the
port's kernels 8 and 9 (mcmc_jl_tpu_torch/ops/nuts_kernels.py) against the
JAX package's Pallas kernels (mcmc_jl_tpu/ops/pallas_nuts.py) in interpret
mode on the CPU at d 1056 and 2048, on the same numpy inputs and injected
noise; kernel 9's Philox draw ranges up to d 16384 and their replay there;
the routes that take such a GLM under NUTS through ``run(..., chains=N)``,
``resume(list)`` and ``run_until`` (and the generic engine above 16384
parameters); and one continuation from the JAX package's adapted states
carried over with ``utils.convert``.

On the CPU the wrappers run their plain versions.  Above d = 1024 the CUDA
kernels run on the chunked tier (csrc/glm_nuts.cu
``nuts_xwide_kernel<MS, true>``, whose gradient walks d in column chunks);
``test_chunked_nuts_kernels_match_plain_on_card`` holds them against the
plain versions on a card, and chip_smoke.py's
``phase_chunked_nuts_kernels`` at the paths' shapes.  The JAX package pads
d to a multiple of 128 (1152 at d 1056); the port pads nothing.
Tolerances are tests/test_torch_xwide_nuts.py's: equal ndoublings and
diverging on every chain, theta within 1e-5 absolute and relative, the
gradient within 1e-5 times its largest component (at least 1; probit adds
2e-5 relative: the JAX kernel's erf-free log Phi), lp within 1e-4; lp also
within 5e-7 relative (four float32 ulps), since with the matrix prior at
d 2048 it reaches -886, where 1e-4 is less than two ulps of float32 and
two sums of N terms and a prior of d^2 in another order differ by 2.5
of them."""
import logging

import numpy as np
import pytest
import torch

import mcmc_jl_tpu_torch as mt
from mcmc_jl_tpu_torch.core.task import MCMCTask
from mcmc_jl_tpu_torch.ops import glm_kernels as gk
from mcmc_jl_tpu_torch.ops import nuts_kernels as nk
from mcmc_jl_tpu_torch.ops import philox
from mcmc_jl_tpu_torch.ops import warmstart as tws
from mcmc_jl_tpu_torch.ops.glm_kernels import glm_funcs
from mcmc_jl_tpu_torch.parallel import pchains
from mcmc_jl_tpu_torch.samplers.base import make_generator
from test_torch_wide_glm import _data, _lower
from test_torch_wide_nuts import _as_dict, _pad, _t

torch.set_num_threads(1)

C, MD = 8, 5

# d, link, step, multinomial, prior ("scalar", "row" with weights and
# offsets, or "matrix"), N; at these posteriors eps 0.3 stops every tree on
# a u-turn before the depth bound and eps 0.01 runs to it
CASES = {
    "1056-slice-shallow": (1056, "logistic", 0.3, False, "scalar", 40),
    "1056-multinomial-deep": (1056, "logistic", 0.01, True, "scalar", 40),
    "2048-probit-weights-offsets-prior-row": (2048, "probit", 0.1, False,
                                              "row", 40),
    "2048-matrix-prior-multinomial": (2048, "logistic", 0.1, True, "matrix",
                                      32),
}


@pytest.mark.parametrize("case", list(CASES))
def test_chunked_transition_matches_jax(case):
    """Kernel 8's plain version against JAX's
    ``glm_nuts_transition(interpret=True)`` at d 1056 (d_pad 1152) and
    2048 on the same start and pre-drawn noise: the same discrete path on
    every chain, theta, g and lp within the module's tolerances."""
    import jax.numpy as jnp
    from mcmc_jl_tpu.ops.pallas_glm import LANE, pad_design
    from mcmc_jl_tpu.ops.pallas_nuts import glm_nuts_transition as jtrans

    d, kind, eps, multinomial, prior, n = CASES[case]
    X, Y = _data(kind, n, d, seed=d + 5)
    rng = np.random.default_rng(d + 15)
    f32 = np.float32
    W = O = None
    lam = 1.0
    if prior == "row":
        W = rng.uniform(0.5, 2.0, n).astype(f32)
        O = (0.1 * rng.standard_normal(n)).astype(f32)
        lam = rng.uniform(0.5, 2.0, d).astype(f32)
    elif prior == "matrix":  # the dense fold: design X L, prior L'L
        L = _lower(rng, d)
        X = (X @ L).astype(f32)
        lam = (L.T @ L).astype(f32)
    theta = (0.3 * rng.standard_normal((C, d))).astype(f32)
    m0 = rng.standard_normal((C, d)).astype(f32)
    logu = np.log(rng.random(C)).astype(f32)
    dirn = np.where(rng.random((C, MD)) < 0.5, 1.0, -1.0).astype(f32)
    merge = rng.random((C, MD)).astype(f32)
    leaf = rng.random((C, 1 << MD)).astype(f32)

    XT = _t(X.T).contiguous()
    Yt = _t(Y)
    prior_t = _t(lam) if prior != "scalar" else 1.0
    lp, g = glm_funcs(XT, Yt, _t(W), _t(O), prior_t, kind)[1](_t(theta))
    nk.reset_counts()
    th_t, g_t, lp_t, nd_t, dv_t = (a.numpy() for a in nk.glm_nuts_transition(
        XT, Yt, _t(theta), lp, g, eps, _t(m0), _t(logu), _t(dirn), _t(merge),
        _t(leaf), maxdoublings=MD, kind=kind, weights=_t(W), offsets=_t(O),
        prior_prec=prior_t, multinomial=multinomial))
    assert nk.PLAIN_CALLS["glm_nuts_transition"] == 1
    assert not any(nk.LAUNCHES.values())

    XTj, Yj, d_pad = pad_design(X, Y)
    assert d_pad == -(-d // 128) * 128
    out = jtrans(
        XTj, Yj, _pad(theta, d_pad), jnp.asarray(lp.numpy()),
        _pad(g.numpy(), d_pad), jnp.float32(eps), _pad(m0, d_pad),
        jnp.asarray(logu), _pad(dirn, LANE, 1.0), _pad(merge, LANE, 0.5),
        _pad(leaf, LANE, 0.5), maxdoublings=MD, interpret=True, kind=kind,
        weights=None if W is None else jnp.asarray(W),
        offsets=None if O is None else jnp.asarray(O),
        prior_prec=jnp.asarray(lam) if prior != "scalar" else 1.0,
        multinomial=multinomial)
    th_j, g_j, lp_j, nd_j, dv_j = (np.asarray(a) for a in out)

    np.testing.assert_array_equal(nd_t, nd_j)
    np.testing.assert_array_equal(dv_t, dv_j)
    assert nd_t.min() >= 1 and nd_t.max() <= MD
    if "deep" in case:
        assert nd_t.min() >= 4
    if "shallow" in case:  # every tree stops on a u-turn
        assert nd_t.max() < MD
    np.testing.assert_allclose(th_t, th_j[:, :d], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(lp_t, lp_j, rtol=5e-7, atol=1e-4)
    g_atol = 1e-5 * max(1.0, float(np.abs(g_j).max()))
    np.testing.assert_allclose(g_t, g_j[:, :d], atol=g_atol,
                               rtol=2e-5 if kind == "probit" else 0)
    assert np.all(g_j[:, d:] == 0)


def test_chunked_multistep_ref_matches_jax_driver():
    """Kernel 9's plain version through the port's multistep driver against
    JAX's per-transition driver at d 1056, the same step: the gates of
    tests/test_torch_xwide_nuts.py's d 300 test (pooled means |z| < 5, sd
    within 30%, depths in range, mean depths within 0.5, no divergences
    after burn-in)."""
    import jax
    import jax.numpy as jnp
    from mcmc_jl_tpu.ops.pallas_glm import pad_chains, pad_design
    from mcmc_jl_tpu.ops.pallas_nuts import _nuts_run as jax_nuts_run

    X, Y = _data("logistic", 60, 1056, seed=6)
    d = X.shape[1]
    Cs, steps, burn, eps = 8, 240, 40, 0.4
    gen = torch.Generator().manual_seed(4)
    nk.reset_counts()
    _, infos = nk._nuts_run_hw(_t(X.T).contiguous(), _t(Y),
                               torch.zeros((Cs, d)), eps, gen, steps=steps,
                               k_trans=8, maxdoublings=5)
    assert nk.PLAIN_CALLS["glm_nuts_multistep"] == steps // 8
    x = infos["ppars"][burn:].numpy()
    assert infos["ppars"].shape == (steps, Cs, d) and np.all(np.isfinite(x))
    nd = infos["ndoublings"].numpy()
    assert nd.min() >= 1 and nd.max() <= 5
    assert infos["accept"][burn:].float().mean() > 0.5
    assert not infos["diverging"][burn:].any()

    XTj, Yj, d_pad = pad_design(X, Y)
    assert d_pad == 1152
    _, jinfos = jax_nuts_run(
        XTj, Yj, pad_chains(jnp.zeros((Cs, d), jnp.float32), d_pad),
        jnp.float32(eps), jax.random.PRNGKey(5), d=d, steps=steps,
        maxdoublings=5, block_chains=Cs, interpret=True, kind="logistic")
    xj = np.asarray(jinfos["ppars"])[burn:]
    mu, mu_j = x.reshape(-1, d).mean(0), xj.reshape(-1, d).mean(0)
    sd = xj.reshape(-1, d).std(0)
    z = np.abs(mu - mu_j) / (sd * np.sqrt(2.0 / 200.0))
    assert np.all(z < 5), (mu, mu_j, z)
    np.testing.assert_allclose(x.reshape(-1, d).std(0), sd, rtol=0.3)
    assert abs(nd[burn:].mean()
               - np.asarray(jinfos["ndoublings"])[burn:].mean()) < 0.5


@pytest.mark.parametrize("d", [2049, 4096, gk.D_MAX])
def test_chunked_draw_ranges_disjoint(d):
    """Kernel 9's five Philox draw ranges within one (chain, transition) at
    the deepest tree (md 10): the momenta take 0 .. d/2 - 1 (up to 0xFFFF
    at D_MAX), the leaves LEAF_DRAW + l, the directions DIR_DRAW + j, the
    merge uniforms MERGE_DRAW + j and the slice uniform, disjoint at d 2049
    (where the momenta first reached the directions' layout before the
    last), 4096 and the bound D_MAX = NUTS_D_MAX = 131072."""
    md = nk.MAX_DOUBLINGS
    assert nk.NUTS_D_MAX == gk.D_MAX == 131072
    ranges = sorted([(0, (d + 1) // 2), (nk.DIR_DRAW, nk.DIR_DRAW + md),
                     (nk.MERGE_DRAW, nk.MERGE_DRAW + md),
                     (nk.LEAF_DRAW, nk.LEAF_DRAW + (1 << md)),
                     (gk.SLICE_DRAW, gk.SLICE_DRAW + 1)])
    for (lo, hi), (lo2, _) in zip(ranges, ranges[1:]):
        assert lo < hi <= lo2, ranges
    assert (d + 1) // 2 > 0x400  # the old layout's first direction collides


def test_chunked_draw_replay_at_the_bound():
    """The host replay of kernel 9's draws at the bound (d 131072) and md
    10: coordinates 0, 8193 and 131071 take the normals of their own
    momentum draws (j // 2,
    words 0, 1 for even j, 2, 3 for odd), the directions and merge uniforms
    their draws at DIR_DRAW + j and MERGE_DRAW + j (the kernel's uniform
    1 - U[0, 1); a direction -1 where it is below 0.5), the last leaf its
    own, and the momenta equal glm_multistep_draws'."""
    d, md, Cs, k, i0, seed = gk.D_MAX, nk.MAX_DOUBLINGS, 2, 2, 5, 0xC0FFEE
    m0, logu, dirn, merge, leaf = nk.glm_nuts_multistep_draws(
        seed, Cs, d, k, md, i0=i0)
    assert m0.shape == (k, Cs, d) and leaf.shape == (k, Cs, 1 << md)
    m0_hmc, logu_hmc = gk.glm_multistep_draws(seed, Cs, d, k, i0=i0)
    assert torch.equal(m0, m0_hmc) and torch.equal(logu, logu_hmc)

    def u(c, t, draw):
        w = philox.philox4x32((c, i0 + t, draw, 0), seed)[0]
        return float(philox.uniform(w))

    for t, c, j in ((0, 0, 0), (1, 1, 8193), (0, 1, d - 1)):
        b = philox.philox4x32((c, i0 + t, j // 2, 0), seed)
        want = (philox.box_muller(b[2], b[3]) if j % 2
                else philox.box_muller(b[0], b[1]))
        assert float(m0[t, c, j]) == float(want)
    for t, c, j in ((0, 0, 0), (1, 1, md - 1)):
        assert float(merge[t, c, j]) == u(c, t, nk.MERGE_DRAW + j)
        ud = u(c, t, nk.DIR_DRAW + j)
        assert float(dirn[t, c, j]) == (-1.0 if ud < 0.5 else 1.0)
    assert float(leaf[1, 0, -1]) == u(0, 1, nk.LEAF_DRAW + (1 << md) - 1)
    assert set(dirn.unique().tolist()) <= {-1.0, 1.0}


# ---- routes through run(..., chains=N), resume(list) and run_until ----------

def _chunked_model(n=32, d=2048, seed=90):
    X, Y = _data("logistic", n, d, seed)
    return mt.model(glm=("logistic", X.astype(np.float64),
                         Y.astype(np.float64)), device="cpu")


@pytest.mark.parametrize("d", [2048, gk.D_MAX, gk.D_MAX + 1])
def test_chunked_nuts_routes_and_reasons(d, caplog):
    """At d 2048 and 131072 (the chunked tier's bound) exact NUTS with the
    unit, diagonal and dense metrics routes to "nuts" (kernels 8 and 9)
    for a run and for its continuation, with no reason logged; at 131073
    each takes the generic engine with the reason naming the GLM kernels'
    bound, and no reason names a NUTS width."""
    runner = mt.SerialMC(steps=60, burnin=20)
    m = _chunked_model(n=4, d=d, seed=d)
    ok = d <= nk.NUTS_D_MAX
    caplog.clear()
    with caplog.at_level(logging.INFO):
        for ma in (None, "diag", "dense"):
            s = mt.NUTS(6) if ma is None else mt.NUTS(6, mass_adapt=ma)
            assert pchains._route(MCMCTask(m, s, runner), True) == (
                "nuts" if ok else False)
            assert pchains.continuation_route(m, s, 4, True) == (
                "nuts" if ok else False)
    why = (f"d = {gk.D_MAX + 1} > {gk.D_MAX}, the GLM kernels' bound "
           f"(ROADMAP: GLMs wider than {gk.D_MAX} parameters)")
    assert sum(why in r.getMessage() for r in caplog.records) == (
        0 if ok else 6)
    assert ("generic torch engine" in caplog.text) == (not ok)
    assert "NUTS kernels' width" not in caplog.text
    assert "exact NUTS on GLMs wider than" not in caplog.text


@pytest.mark.parametrize("mass_adapt", [None, "diag", "dense"])
def test_chunked_nuts_run_and_resume(mass_adapt, monkeypatch):
    """At d 2048 NUTS routes to "nuts" for a run and for its continuation:
    after the generic warmup the sampling phase runs the exact-NUTS
    kernels' plain versions, and resume(list) of the chains continues
    through the same kernels.  With the unit metric the multistep route
    (kernel 9, which the card takes when the steps split into launches of
    2-8 transitions) is forced, as on a card; the diagonal and dense
    metrics take kernel 8 once a transition (the CPU's route)."""
    m = _chunked_model()
    if mass_adapt is None:
        s = mt.NUTS(4)
        monkeypatch.setattr(tws, "_nuts_hw_route", lambda model, steps: (
            True, tws._pick_k_trans(steps)))
        name = "glm_nuts_multistep"
    else:
        s = mt.NUTS(4, mass_adapt=mass_adapt)
        name = "glm_nuts_transition"
    per = (lambda steps: steps // tws._pick_k_trans(steps)) \
        if mass_adapt is None else (lambda steps: steps)
    task = m * s * mt.SerialMC(steps=16, burnin=8)
    assert pchains._route(MCMCTask(m, s, task.runner), True) == "nuts"
    nk.reset_counts()
    cs = mt.run(task, chains=3, seed=0, fused=True)
    assert nk.PLAIN_CALLS == {**dict.fromkeys(nk.PLAIN_CALLS, 0),
                              name: per(8)}
    assert not any(nk.LAUNCHES.values())
    v = np.stack([c.samples.values for c in cs])
    assert v.shape == (3, 8, 2048) and np.all(np.isfinite(v))
    assert np.all(np.stack([c.diagnostics["ndoublings"] for c in cs]) >= 1)
    assert pchains.continuation_route(m, s, 3, True) == "nuts"
    nk.reset_counts()
    cont = mt.resume(cs, steps=6, fused=True)
    assert nk.PLAIN_CALLS == {**dict.fromkeys(nk.PLAIN_CALLS, 0),
                              name: per(6)}
    assert cont[0].task.pos == cs[0].task.pos + 6
    assert np.all(np.isfinite(cont[0].samples.values))


def test_chunked_run_until_nuts_blocks():
    """``run_until(NUTS(4), ...)`` on the d 2048 GLM: past the warmup every
    block continues through kernel 8's plain version (the CPU's route),
    once a transition, to max_steps (the R-hat gate cannot pass), with no
    reason logged, and the draws are finite."""
    m = _chunked_model()
    nk.reset_counts()
    res = mt.run_until(m, mt.NUTS(4), n_chains=3, rhat_target=0.5,
                       min_ess=1, check_every=6, warmup=6, max_steps=18,
                       seed=0, fused=True)
    assert res.steps_run == 18 and not res.converged
    assert nk.PLAIN_CALLS == {**dict.fromkeys(nk.PLAIN_CALLS, 0),
                              "glm_nuts_transition": 12}
    assert np.all(np.isfinite(res.samples))


def test_chunked_nuts_continuation_matches_jax():
    """From the JAX package's adapted states of a d 1056 logistic
    regression (NUTS with a diagonal metric, ``run(..., fused=True)`` in
    interpret mode), carried over with ``utils.convert``: the port's fused
    continuation (kernel 8's plain version on the folded design) and the
    JAX package's keep the frozen step (to 1e-12 relative) and its
    ``epsilon`` rows, advance ``i`` alike, end on exact (lp, grad), and
    agree in their per-chain means (|z| < 5) and acceptance (within
    0.1)."""
    import jax
    import jax.numpy as jnp

    import mcmc_jl_tpu as mc
    from mcmc_jl_tpu.ops import warmstart as jws

    X, Y = _data("logistic", 40, 1056, seed=93)
    X, Y = X.astype(np.float64), Y.astype(np.float64)
    jm = mc.model(glm=("logistic", X, Y))
    tm = mt.model(glm=("logistic", X, Y), dtype=torch.float64, device="cpu")
    make = lambda p: p.NUTS(maxdoublings=4, mass_adapt="diag")  # noqa: E731
    Cs, steps = 8, 20
    js = make(mc)
    jc = mc.run(jm * js * mc.SerialMC(steps=40, burnin=30), chains=Cs,
                seed=0, fused=True)
    jst = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs),
                                 *[c.task.state for c in jc])
    tst = mt.nuts_state_from_numpy(_as_dict(jax.device_get(jst)),
                                   device="cpu")
    ts = make(mt)
    assert pchains.continuation_route(tm, ts, Cs, True, tst) == "nuts"
    jinfos, jout = jws.fused_continue_chains(jm, js, jst, steps,
                                             jax.random.PRNGKey(5),
                                             interpret=True)
    nk.reset_counts()
    tinfos, tout = tws.fused_continue_chains(tm, ts, tst, steps,
                                             make_generator("cpu", 5))
    assert nk.PLAIN_CALLS["glm_nuts_transition"] == steps
    assert set(tinfos) == set(jinfos)
    np.testing.assert_array_equal(tout.i.numpy(), np.asarray(jout.i))
    for name in ("epsilon", "lebar"):
        np.testing.assert_allclose(np.asarray(getattr(tout, name)),
                                   np.asarray(getattr(jout, name)),
                                   rtol=1e-12)
    np.testing.assert_allclose(tinfos["epsilon"].numpy(),
                               np.asarray(jinfos["epsilon"]), rtol=1e-12)
    lp, g = tm.evalallg(tout.pars)
    torch.testing.assert_close(tout.logtarget, lp)
    torch.testing.assert_close(tout.grad, g)
    tp = tinfos["ppars"].double().numpy().mean(0)
    jp = np.asarray(jinfos["ppars"], np.float64).mean(0)
    se = np.sqrt(tp.var(0, ddof=1) / Cs + jp.var(0, ddof=1) / Cs)
    assert float(np.max(np.abs(tp.mean(0) - jp.mean(0)) / se)) < 5.0
    acc_t = float(tinfos["accept"].double().mean())
    acc_j = float(np.asarray(jinfos["accept"], np.float64).mean())
    assert abs(acc_t - acc_j) < 0.1, (acc_t, acc_j)


# ---- the CUDA kernels against their plain versions on a card ---------------

def test_chunked_nuts_kernels_match_plain_on_card():
    """Kernels 8 and 9 (and their _mat forms) on the chunked tier at d 1056
    (three chunks of 352) and 2048 against their plain versions, on a
    ragged chain count (37) and a ragged N (601: two row blocks, the second
    ragged), slice and multinomial, each launch counted under its
    ``_chunked`` key and repeated bitwise (skips without a card;
    chip_smoke.py phase_chunked_nuts_kernels holds them at the paths'
    shapes).  At least 99.5% of the chains (here: all but one of 37) take
    the plain version's discrete path; on those, theta, g and lp agree as
    in tests/test_torch_xwide_nuts.py's card test."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    from mcmc_jl_tpu_torch.ops import target_kernels as tk

    cu = lambda a: torch.as_tensor(a, dtype=torch.float32,  # noqa: E731
                                   device="cuda").contiguous()
    Cc, n = 37, 601
    for i, (d, md, multinomial, prior) in enumerate(
            ((1056, 6, False, "scalar"), (2048, 6, True, "matrix"),
             (1056, 10, False, "scalar"), (2048, 4, False, "row"))):
        X, Y = _data("logistic", n, d, seed=d + i)
        rng = np.random.default_rng(60 + i)
        lam = 1.0
        if prior == "row":
            lam = cu(rng.uniform(0.5, 2.0, d))
        elif prior == "matrix":
            L = _lower(rng, d)
            X, lam = X @ L, cu(L.T @ L)
        XT, Yc = cu(X.T), cu(Y)
        th = cu(0.3 * rng.standard_normal((Cc, d)))
        logp_grad = glm_funcs(XT, Yc, None, None, lam, "logistic")[1]
        lp, g = logp_grad(th)
        kw = dict(maxdoublings=md, prior_prec=lam, multinomial=multinomial)
        eps = 0.05
        suffix = ("_mat" if prior == "matrix" else "") + "_chunked"

        def held(out_k, want, same):
            assert int((~same).sum()) <= 1, (d, md)
            for a, b, atol in zip(out_k[:3], want, (1e-4, 2e-3, 1e-3)):
                torch.testing.assert_close(a[same], b[same], rtol=1e-4,
                                           atol=atol)

        noise = tuple(cu(a) for a in (
            rng.standard_normal((Cc, d)), np.log(rng.random(Cc)),
            np.where(rng.random((Cc, md)) < 0.5, 1.0, -1.0),
            rng.random((Cc, md)), rng.random((Cc, 1 << md))))
        nk.reset_counts()
        out_k = nk.glm_nuts_transition(XT, Yc, th, lp, g, eps, *noise, **kw)
        again = nk.glm_nuts_transition(XT, Yc, th, lp, g, eps, *noise, **kw)
        assert nk.LAUNCHES["glm_nuts_transition" + suffix] == 2
        assert all(torch.equal(a, b) for a, b in zip(out_k, again))
        out_r = nk.glm_nuts_transition_ref(XT, Yc, th, lp, g, eps, *noise,
                                           **kw)
        held(out_k, out_r[:3], (out_k[3] == out_r[3])
             & (out_k[4] == out_r[4])
             & ((out_k[0] - out_r[0]).abs().amax(-1) <= 1e-3))

        def gen():
            return torch.Generator(device="cuda").manual_seed(90 + i)

        k = 3
        out_k = nk.glm_nuts_multistep(XT, Yc, th, lp, g, eps, gen(),
                                      k_trans=k, **kw)
        again = nk.glm_nuts_multistep(XT, Yc, th, lp, g, eps, gen(),
                                      k_trans=k, **kw)
        assert nk.LAUNCHES["glm_nuts_multistep" + suffix] == 2
        assert all(torch.equal(a, b) for a, b in zip(out_k[:3], again[:3]))
        draws = nk.glm_nuts_multistep_draws(tk._seed(gen()), Cc, d, k, md,
                                            device="cuda")
        out_r = nk.glm_nuts_multistep_ref(XT, Yc, th, lp, g, eps, None,
                                          k_trans=k, draws=draws, **kw)
        rk, rr = out_k[3], out_r[3]
        lp_at, g_at = logp_grad(out_k[0])
        held(out_k, (out_r[0], g_at, lp_at),
             (rk["ndoublings"] == rr["ndoublings"]).all(0)
             & (rk["diverging"] == rr["diverging"]).all(0)
             & ((rk["ppars"] - rr["ppars"]).abs().amax((0, 2)) <= 1e-3))
