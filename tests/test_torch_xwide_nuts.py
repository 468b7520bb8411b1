"""Exact NUTS on GLMs of 257 to 1024 parameters: the plain versions of the
port's kernels 8 and 9 (mcmc_jl_tpu_torch/ops/nuts_kernels.py) against the
JAX package's Pallas kernels (mcmc_jl_tpu/ops/pallas_nuts.py) in interpret
mode on the CPU at d 257, 300 and 1024, on the same numpy inputs and
injected noise; kernel 9's Philox draw ranges up to d 1024; the routes
that take such a GLM under NUTS through ``run(..., chains=N)``,
``resume(list)`` and ``run_until`` (and the chunked tier's at 1025
parameters, tests/test_torch_chunked_nuts.py); and one continuation from
the JAX package's adapted states carried over with ``utils.convert``.

On the CPU the wrappers run their plain versions.  Above d = 256 the CUDA
kernels run on the very-wide tile (csrc/glm_nuts.cu nuts_xwide_kernel);
``test_xwide_nuts_kernels_match_plain_on_card`` holds them against the
plain versions on a card, and chip_smoke.py's ``phase_xwide_nuts_kernels``
at the paths' shapes.  The JAX package pads d to 128 lanes (384 at d 257
and 300, 1024 at 1024); the port pads nothing.  Tolerances are the d 150
tests' (tests/test_torch_wide_nuts.py): equal ndoublings and diverging on
every chain, theta and the gradient within 1e-5 absolute (probit adds 2e-5
relative to the gradient: the JAX kernel's erf-free log Phi, whose
absolute error is below 4e-6 an observation), lp within 1e-4.  Past
d 256 two of them follow the values' scale: the Poisson link's
trajectories at d 300 reach |theta| and |g| of 6, where 1e-5 absolute is
40 float32 ulps, so theta is also held to 1e-5 relative, and the gradient
to 1e-5 times its largest component (at least 1): a component near zero
is a sum of N terms of the gradient's scale that cancel, whose rounding
follows those terms, not the sum."""
import logging

import numpy as np
import pytest
import torch

import mcmc_jl_tpu_torch as mt
from mcmc_jl_tpu_torch.core.task import MCMCTask
from mcmc_jl_tpu_torch.ops import glm_kernels as gk
from mcmc_jl_tpu_torch.ops import nuts_kernels as nk
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
    "257-slice-shallow": (257, "logistic", 0.3, False, "scalar", 60),
    "257-multinomial-deep": (257, "logistic", 0.01, True, "scalar", 60),
    "300-probit-weights-offsets-prior-row": (300, "probit", 0.1, False,
                                             "row", 60),
    "300-poisson-weights-offsets-prior-row-multinomial": (
        300, "poisson", 0.1, True, "row", 60),
    "300-matrix-prior-multinomial": (300, "logistic", 0.1, True, "matrix",
                                     60),
    "1024-matrix-prior-slice": (1024, "logistic", 0.1, False, "matrix", 48),
}


@pytest.mark.parametrize("case", list(CASES))
def test_xwide_transition_matches_jax(case):
    """Kernel 8's plain version against JAX's
    ``glm_nuts_transition(interpret=True)`` at d 257, 300 (d_pad 384) and
    1024 on the same start and pre-drawn noise: the same discrete path on
    every chain, theta, g and lp within the module's tolerances."""
    import jax.numpy as jnp
    from mcmc_jl_tpu.ops.pallas_glm import LANE, pad_design
    from mcmc_jl_tpu.ops.pallas_nuts import glm_nuts_transition as jtrans

    d, kind, eps, multinomial, prior, n = CASES[case]
    X, Y = _data(kind, n, d, seed=d + 3)
    rng = np.random.default_rng(d + 13)
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
    np.testing.assert_allclose(lp_t, lp_j, rtol=0, atol=1e-4)
    g_atol = 1e-5 * max(1.0, float(np.abs(g_j).max()))
    np.testing.assert_allclose(g_t, g_j[:, :d], atol=g_atol,
                               rtol=2e-5 if kind == "probit" else 0)
    assert np.all(g_j[:, d:] == 0)


@pytest.mark.parametrize("multinomial", [False, True],
                         ids=["slice", "multinomial"])
def test_xwide_multistep_ref_matches_jax_driver(multinomial):
    """Kernel 9's plain version through the port's multistep driver against
    JAX's per-transition driver at d 300, the same step: the gates of
    tests/test_torch_wide_nuts.py's d 40 test (pooled means |z| < 5, sd
    within 30%, depths in range, mean depths within 0.5, no divergences
    after burn-in)."""
    import jax
    import jax.numpy as jnp
    from mcmc_jl_tpu.ops.pallas_glm import pad_chains, pad_design
    from mcmc_jl_tpu.ops.pallas_nuts import _nuts_run as jax_nuts_run

    X, Y = _data("logistic", 120, 300, seed=5)
    d = X.shape[1]
    Cs, steps, burn, eps = 8, 320, 80, 0.3
    gen = torch.Generator().manual_seed(4)
    nk.reset_counts()
    _, infos = nk._nuts_run_hw(_t(X.T).contiguous(), _t(Y),
                               torch.zeros((Cs, d)), eps, gen, steps=steps,
                               k_trans=8, maxdoublings=6,
                               multinomial=multinomial)
    assert nk.PLAIN_CALLS["glm_nuts_multistep"] == steps // 8
    x = infos["ppars"][burn:].numpy()
    assert infos["ppars"].shape == (steps, Cs, d) and np.all(np.isfinite(x))
    nd = infos["ndoublings"].numpy()
    assert nd.min() >= 1 and nd.max() <= 6
    assert infos["accept"][burn:].float().mean() > 0.5
    assert not infos["diverging"][burn:].any()

    XTj, Yj, d_pad = pad_design(X, Y)
    assert d_pad == 384
    _, jinfos = jax_nuts_run(
        XTj, Yj, pad_chains(jnp.zeros((Cs, d), jnp.float32), d_pad),
        jnp.float32(eps), jax.random.PRNGKey(5), d=d, steps=steps,
        maxdoublings=6, block_chains=Cs, interpret=True, kind="logistic",
        multinomial=multinomial)
    xj = np.asarray(jinfos["ppars"])[burn:]
    mu, mu_j = x.reshape(-1, d).mean(0), xj.reshape(-1, d).mean(0)
    sd = xj.reshape(-1, d).std(0)
    z = np.abs(mu - mu_j) / (sd * np.sqrt(2.0 / 200.0))
    assert np.all(z < 5), (mu, mu_j, z)
    np.testing.assert_allclose(x.reshape(-1, d).std(0), sd, rtol=0.3)
    assert abs(nd[burn:].mean()
               - np.asarray(jinfos["ndoublings"])[burn:].mean()) < 0.5


def test_xwide_draw_ranges_and_replay():
    """Kernel 9's Philox draw numbers within one (chain, transition) at the
    very-wide tile's widest d (1024) and the deepest tree (md 10): the
    momenta take 0 .. 511, the directions, merge uniforms, leaves and the
    slice uniform four more ranges, five disjoint in all; the host replay
    at d 1024 has the kernel's shapes, its momenta and slice are
    glm_multistep_draws', and its directions are +-1."""
    md, d = nk.MAX_DOUBLINGS, gk.XWIDE_D_MAX
    assert d == 1024
    ranges = sorted([(0, (d + 1) // 2), (nk.DIR_DRAW, nk.DIR_DRAW + md),
                     (nk.MERGE_DRAW, nk.MERGE_DRAW + md),
                     (nk.LEAF_DRAW, nk.LEAF_DRAW + (1 << md)),
                     (gk.SLICE_DRAW, gk.SLICE_DRAW + 1)])
    for (lo, hi), (lo2, _) in zip(ranges, ranges[1:]):
        assert lo < hi <= lo2, ranges
    draws = nk.glm_nuts_multistep_draws(11, 3, d, 2, md, i0=4)
    assert [tuple(a.shape) for a in draws] == [
        (2, 3, d), (2, 3), (2, 3, md), (2, 3, md), (2, 3, 1 << md)]
    m0, logu = gk.glm_multistep_draws(11, 3, d, 2, i0=4)
    assert torch.equal(draws[0], m0) and torch.equal(draws[1], logu)
    assert set(draws[2].unique().tolist()) <= {-1.0, 1.0}
    for u in draws[3:]:
        assert bool(((u > 0) & (u <= 1)).all())
    # the three uniform ranges are distinct draws of the same counter
    assert not torch.equal(draws[3], draws[4][..., :md])


def test_philox_words_match_a_uint64_reference():
    """ops/philox.py takes each 32 x 32-bit product of Philox4x32-10 in
    16-bit halves of int64 words (so that it runs on any device): on random
    counters and extreme keys it gives the words of a plain uint64
    implementation bit for bit, and the replay of kernel 9's draws is the
    same on CPU tensors however its counters are laid out."""
    from mcmc_jl_tpu_torch.ops import philox

    def reference(ctr, seed):
        x = [np.asarray(c, dtype=np.uint64) for c in ctr]
        k0, k1 = seed & 0xFFFFFFFF, seed >> 32
        for r in range(10):
            if r:
                k0, k1 = (k0 + 0x9E3779B9) & 0xFFFFFFFF, \
                    (k1 + 0xBB67AE85) & 0xFFFFFFFF
            p0 = np.uint64(0xD2511F53) * x[0]
            p1 = np.uint64(0xCD9E8D57) * x[2]
            x = [(p1 >> np.uint64(32)) ^ x[1] ^ np.uint64(k0),
                 p1 & np.uint64(0xFFFFFFFF),
                 (p0 >> np.uint64(32)) ^ x[3] ^ np.uint64(k1),
                 p0 & np.uint64(0xFFFFFFFF)]
        return x

    rng = np.random.default_rng(3)
    words = [rng.integers(0, 2 ** 32, 64, dtype=np.uint64) for _ in range(4)]
    words[0][:2] = (0, 2 ** 32 - 1)
    for seed in (0, 2 ** 64 - 1, 0x5EED_0F_CAFE):
        got = philox.philox4x32([torch.as_tensor(w.astype(np.int64))
                                 for w in words], seed)
        for w, g in zip(reference(words, seed), got):
            np.testing.assert_array_equal(g.numpy(), w.astype(np.int64))
    draws = nk.glm_nuts_multistep_draws(0xC0FFEE, 5, 257, 3, 7, i0=11)
    later = nk.glm_nuts_multistep_draws(0xC0FFEE, 5, 257, 1, 7, i0=13)
    for a, b in zip(draws, later):
        assert a.is_contiguous() and torch.equal(a[2], b[0])


# ---- routes through run(..., chains=N), resume(list) and run_until ----------

def _xwide_model(n=60, d=300, seed=90):
    X, Y = _data("logistic", n, d, seed)
    return mt.model(glm=("logistic", X.astype(np.float64),
                         Y.astype(np.float64)), device="cpu")


@pytest.mark.parametrize("d", [257, 1024, 1025])
def test_xwide_nuts_routes_and_reasons(d, caplog):
    """At d 257 and 1024 (the very-wide tile) and 1025 (the chunked tier)
    exact NUTS with the unit, diagonal and dense metrics routes to "nuts"
    (kernels 8 and 9) for a run and for its continuation, with no reason
    logged: no reason that names a NUTS width (256, 1024) or the NUTS
    kernels' bound appears."""
    runner = mt.SerialMC(steps=60, burnin=20)
    m = _xwide_model(n=40, d=d, seed=d)
    caplog.clear()
    with caplog.at_level(logging.INFO):
        for ma in (None, "diag", "dense"):
            s = mt.NUTS(6) if ma is None else mt.NUTS(6, mass_adapt=ma)
            assert pchains._route(MCMCTask(m, s, runner), True) == "nuts"
            assert pchains.continuation_route(m, s, 4, True) == "nuts"
    assert "generic torch engine" not in caplog.text
    assert "wider than" not in caplog.text
    assert "NUTS kernels' bound" not in caplog.text


@pytest.mark.parametrize("mass_adapt", [None, "diag", "dense"])
def test_xwide_nuts_run_and_resume(mass_adapt, monkeypatch):
    """At d 300 NUTS routes to "nuts" for a run and for its continuation:
    after the generic warmup the sampling phase runs the exact-NUTS
    kernels' plain versions, and resume(list) of the chains continues
    through the same kernels.  With the unit metric the multistep route
    (kernel 9, which the card takes when the steps split into launches of
    2-8 transitions) is forced, as on a card; the diagonal and dense
    metrics take kernel 8 once a transition (the CPU's route)."""
    m = _xwide_model()
    if mass_adapt is None:
        s = mt.NUTS(5)
        monkeypatch.setattr(tws, "_nuts_hw_route", lambda model, steps: (
            True, tws._pick_k_trans(steps)))
        name = "glm_nuts_multistep"
    else:
        s = mt.NUTS(5, mass_adapt=mass_adapt)
        name = "glm_nuts_transition"
    per = (lambda steps: steps // tws._pick_k_trans(steps)) \
        if mass_adapt is None else (lambda steps: steps)
    task = m * s * mt.SerialMC(steps=24, burnin=16)
    assert pchains._route(MCMCTask(m, s, task.runner), True) == "nuts"
    nk.reset_counts()
    cs = mt.run(task, chains=3, seed=0, fused=True)
    assert nk.PLAIN_CALLS == {**dict.fromkeys(nk.PLAIN_CALLS, 0),
                              name: per(8)}
    assert not any(nk.LAUNCHES.values())
    v = np.stack([c.samples.values for c in cs])
    assert v.shape == (3, 8, 300) and np.all(np.isfinite(v))
    assert np.all(np.stack([c.diagnostics["ndoublings"] for c in cs]) >= 1)
    assert pchains.continuation_route(m, s, 3, True) == "nuts"
    nk.reset_counts()
    cont = mt.resume(cs, steps=6, fused=True)
    assert nk.PLAIN_CALLS == {**dict.fromkeys(nk.PLAIN_CALLS, 0),
                              name: per(6)}
    assert cont[0].task.pos == cs[0].task.pos + 6
    assert np.all(np.isfinite(cont[0].samples.values))


def test_xwide_run_until_nuts_blocks():
    """``run_until(NUTS(6), ...)`` on the d 300 GLM: past the warmup every
    block continues through kernel 8's plain version (the CPU's route),
    once a transition, to max_steps (the R-hat gate cannot pass), and the
    draws are finite."""
    m = _xwide_model()
    nk.reset_counts()
    res = mt.run_until(m, mt.NUTS(6), n_chains=3, rhat_target=0.5,
                       min_ess=1, check_every=10, warmup=10, max_steps=30,
                       seed=0, fused=True)
    assert res.steps_run == 30 and not res.converged
    assert nk.PLAIN_CALLS == {**dict.fromkeys(nk.PLAIN_CALLS, 0),
                              "glm_nuts_transition": 20}
    assert np.all(np.isfinite(res.samples))


def test_xwide_nuts_continuation_matches_jax():
    """From the JAX package's adapted states of a d 300 logistic regression
    (NUTS with a diagonal metric, ``run(..., fused=True)`` in interpret
    mode), carried over with ``utils.convert``: the port's fused
    continuation (kernel 8's plain version on the folded design) and the
    JAX package's keep the frozen step (to 1e-12 relative) and its
    ``epsilon`` rows, advance ``i`` alike, end on exact (lp, grad), and
    agree in their per-chain means (|z| < 5) and acceptance (within
    0.1)."""
    import jax
    import jax.numpy as jnp

    import mcmc_jl_tpu as mc
    from mcmc_jl_tpu.ops import warmstart as jws

    X, Y = _data("logistic", 60, 300, seed=91)
    X, Y = X.astype(np.float64), Y.astype(np.float64)
    jm = mc.model(glm=("logistic", X, Y))
    tm = mt.model(glm=("logistic", X, Y), dtype=torch.float64, device="cpu")
    make = lambda p: p.NUTS(maxdoublings=5, mass_adapt="diag")  # noqa: E731
    Cs, steps = 8, 32
    js = make(mc)
    jc = mc.run(jm * js * mc.SerialMC(steps=60, burnin=40), chains=Cs,
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

def test_xwide_nuts_kernels_match_plain_on_card():
    """Kernels 8 and 9 (and their _mat forms) on the very-wide tile at d 257
    and 1024 against their plain versions, on a ragged chain count (37) and
    a ragged N (301), slice and multinomial, each launch counted under its
    ``_xwide`` key and repeated bitwise (skips without a card;
    chip_smoke.py phase_xwide_nuts_kernels holds them at the paths'
    shapes).  At least 99.5% of the chains (here: all but one of 37) take
    the plain version's discrete path; on those, theta, g and lp agree as
    in tests/test_torch_wide_nuts.py's card test."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    from mcmc_jl_tpu_torch.ops import target_kernels as tk

    cu = lambda a: torch.as_tensor(a, dtype=torch.float32,  # noqa: E731
                                   device="cuda").contiguous()
    Cc, n = 37, 301
    for i, (d, md, multinomial, prior) in enumerate(
            ((257, 6, False, "scalar"), (1024, 6, True, "matrix"),
             (1024, 10, False, "scalar"), (300, 4, False, "row"))):
        X, Y = _data("logistic", n, d, seed=d + i)
        rng = np.random.default_rng(50 + i)
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
        suffix = ("_mat" if prior == "matrix" else "") + "_xwide"

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
