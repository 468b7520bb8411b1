"""Exact NUTS on GLMs wider than 32 parameters: the plain versions of the
port's kernels 8 and 9 (mcmc_jl_tpu_torch/ops/nuts_kernels.py) against the
JAX package's Pallas kernels (mcmc_jl_tpu/ops/pallas_nuts.py) in interpret
mode on the CPU at d 40 and 150, on the same numpy inputs and injected
noise; the Philox draw numbers of kernel 9 at d 256; the routes that take
such a GLM under NUTS through ``run(..., chains=N)`` and ``resume(list)``;
and one whole path from the JAX package's adapted states carried over with
``utils.convert``.

On the CPU the wrappers run their plain versions.  Above d = 32 the CUDA
kernels run on the wide tile (csrc/glm_nuts.cu nuts_wide_kernel);
``test_wide_nuts_kernels_match_plain_on_card`` holds them against the plain
versions on a card, and chip_smoke.py's ``phase_wide_nuts_kernels`` at the
paths' shapes.  The JAX package pads d to 128 lanes (256 at d 150); the
port pads nothing.  Tolerances are tests/test_torch_nuts_kernels.py's:
equal ndoublings and diverging on every chain, theta and the gradient
within 1e-5 absolute (probit adds 2e-5 relative to the gradient: the JAX
kernel's erf-free log Phi), lp within 1e-4."""
import dataclasses

import numpy as np
import pytest
import torch

import mcmc_jl_tpu_torch as mt
from mcmc_jl_tpu_torch.core.task import MCMCTask
from mcmc_jl_tpu_torch.ops import nuts_kernels as nk
from mcmc_jl_tpu_torch.ops import warmstart as tws
from mcmc_jl_tpu_torch.ops.glm_kernels import glm_funcs
from mcmc_jl_tpu_torch.parallel import pchains
from mcmc_jl_tpu_torch.samplers.base import make_generator

torch.set_num_threads(1)

C, MD = 8, 5


def _data(n, d, seed, kind="logistic"):
    """An intercept and d - 1 standard normal columns scaled by 1 / sqrt(d)
    (tests/test_pallas_glm.py's wide case) and a response of the link drawn
    at standard normal coefficients, float32."""
    rng = np.random.default_rng(seed)
    X = np.column_stack([np.ones(n), rng.standard_normal((n, d - 1))]) \
        / np.sqrt(d)
    z = X @ rng.standard_normal(d)
    Y = (rng.random(n) < 1.0 / (1.0 + np.exp(-z))).astype(np.float64)
    return X.astype(np.float32), Y.astype(np.float32)


def _t(a):
    return None if a is None else torch.as_tensor(a)


def _pad(a, width, fill=0.0):
    """(C, k) float32 -> (C, width), the extra columns filled (TPU layout)."""
    import jax.numpy as jnp

    extra = np.full((a.shape[0], width - a.shape[1]), fill, np.float32)
    return jnp.asarray(np.concatenate([a, extra], axis=1))


# link, step, multinomial, prior ("scalar", "row" with weights and offsets,
# or "matrix"); at these posteriors eps 0.3 stops every tree on a u-turn
# before the depth bound and eps 0.01 runs to it
CASES = {
    "slice-shallow": ("logistic", 0.3, False, "scalar"),
    "slice-deep": ("logistic", 0.01, False, "scalar"),
    "multinomial-shallow": ("logistic", 0.3, True, "scalar"),
    "multinomial-deep": ("logistic", 0.01, True, "scalar"),
    "probit-weights-offsets-prior-row": ("probit", 0.1, False, "row"),
    "matrix-prior": ("logistic", 0.1, True, "matrix"),
}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("d", [40, 150])
def test_wide_transition_matches_jax(d, case):
    """Kernel 8's plain version against JAX's
    ``glm_nuts_transition(interpret=True)`` at d 40 and 150 (d_pad 128 and
    256) on the same start and pre-drawn noise: the same discrete path on
    every chain, theta, g and lp within the module's tolerances."""
    import jax.numpy as jnp
    from mcmc_jl_tpu.ops.pallas_glm import LANE, pad_design
    from mcmc_jl_tpu.ops.pallas_nuts import glm_nuts_transition as jtrans

    kind, eps, multinomial, prior = CASES[case]
    n = 60
    X, Y = _data(n, d, seed=d)
    rng = np.random.default_rng(d + 11)
    f32 = np.float32
    W = O = None
    lam = 1.0
    if prior == "row":
        W = rng.uniform(0.5, 2.0, n).astype(f32)
        O = (0.1 * rng.standard_normal(n)).astype(f32)
        lam = rng.uniform(0.5, 2.0, d).astype(f32)
    elif prior == "matrix":  # the dense fold: design X L, prior L'L
        L = np.tril(0.1 * rng.standard_normal((d, d)), -1) \
            + np.diag(rng.uniform(0.7, 1.3, d))
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
    lp, g = glm_funcs(XT, Yt, _t(W), _t(O), _t(lam) if prior != "scalar"
                      else 1.0, kind)[1](_t(theta))
    nk.reset_counts()
    th_t, g_t, lp_t, nd_t, dv_t = (a.numpy() for a in nk.glm_nuts_transition(
        XT, Yt, _t(theta), lp, g, eps, _t(m0), _t(logu), _t(dirn), _t(merge),
        _t(leaf), maxdoublings=MD, kind=kind, weights=_t(W), offsets=_t(O),
        prior_prec=_t(lam) if prior != "scalar" else 1.0,
        multinomial=multinomial))
    assert nk.PLAIN_CALLS["glm_nuts_transition"] == 1
    assert not any(nk.LAUNCHES.values())

    XTj, Yj, d_pad = pad_design(X, Y)
    assert d_pad == (128 if d == 40 else 256)
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
    np.testing.assert_allclose(th_t, th_j[:, :d], rtol=0, atol=1e-5)
    np.testing.assert_allclose(lp_t, lp_j, rtol=0, atol=1e-4)
    np.testing.assert_allclose(g_t, g_j[:, :d], atol=1e-5,
                               rtol=2e-5 if kind == "probit" else 0)


@pytest.mark.parametrize("multinomial", [False, True],
                         ids=["slice", "multinomial"])
def test_wide_multistep_ref_matches_jax_driver(multinomial):
    """Kernel 9's plain version through the port's multistep driver against
    JAX's per-transition driver at d 40, the same step: the gates of
    tests/test_torch_nuts_kernels.py's d 3 test (pooled means |z| < 5, sd
    within 30%, depths in range, mean depths within 0.5, no divergences
    after burn-in)."""
    import jax
    import jax.numpy as jnp
    from mcmc_jl_tpu.ops.pallas_glm import pad_chains, pad_design
    from mcmc_jl_tpu.ops.pallas_nuts import _nuts_run as jax_nuts_run

    X, Y = _data(120, 40, seed=5)
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


def test_draw_ranges_are_disjoint_up_to_d_512():
    """Kernel 9's Philox draw numbers within one (chain, transition): the
    momenta take 0 .. d/2 - 1, below the leaves at LEAF_DRAW at d 512, at
    the very-wide tile's 1024 and up to the kernels' bound NUTS_D_MAX
    (131072; the tree's draws lie just below the slice uniform's, apart
    from d); leaves, directions, merge uniforms and the slice uniform take
    five disjoint ranges at the deepest tree."""
    md = nk.MAX_DOUBLINGS
    assert nk.NUTS_D_MAX == 131072
    for d in (512, 1024, nk.NUTS_D_MAX):
        ranges = sorted([(0, (d - 1) // 2 + 1),
                         (nk.DIR_DRAW, nk.DIR_DRAW + md),
                         (nk.MERGE_DRAW, nk.MERGE_DRAW + md),
                         (nk.LEAF_DRAW, nk.LEAF_DRAW + (1 << md)),
                         (nk.SLICE_DRAW, nk.SLICE_DRAW + 1)])
        for (_, hi), (lo, _) in zip(ranges, ranges[1:]):
            assert hi <= lo, ranges
    m0, logu, dirn, merge, leaf = nk.glm_nuts_multistep_draws(7, 3, 256, 2,
                                                              md)
    assert m0.shape == (2, 3, 256) and leaf.shape == (2, 3, 1 << md)
    assert bool(torch.isfinite(m0).all()) and bool((logu < 0).all())


# ---- routes through run(..., chains=N) and resume(list) ---------------------

def _wide_model(n=120, d=40, seed=90):
    X, Y = _data(n, d, seed)
    return mt.model(glm=("logistic", X.astype(np.float64),
                         Y.astype(np.float64)), device="cpu")


@pytest.mark.parametrize("mass_adapt", [None, "diag", "dense"])
def test_wide_nuts_takes_the_nuts_route(mass_adapt, monkeypatch):
    """At d 40 NUTS routes to "nuts" for a run and for its continuation:
    after the generic warmup the sampling phase runs the exact-NUTS
    kernels' plain versions, and resume(list) of the chains continues
    through the same kernels.  With the unit metric the multistep route
    (kernel 9, which the card takes when the steps split into launches of
    2-8 transitions) is forced, as on a card; the diagonal and dense metrics
    take kernel 8 once a transition (the CPU's route)."""
    m = _wide_model()
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
    task = m * s * mt.SerialMC(steps=30, burnin=20)
    assert pchains._route(MCMCTask(m, s, task.runner), True) == "nuts"
    nk.reset_counts()
    cs = mt.run(task, chains=4, seed=0, fused=True)
    assert nk.PLAIN_CALLS == {**dict.fromkeys(nk.PLAIN_CALLS, 0),
                              name: per(10)}
    assert not any(nk.LAUNCHES.values())
    v = np.stack([c.samples.values for c in cs])
    assert v.shape == (4, 10, 40) and np.all(np.isfinite(v))
    assert np.all(np.stack([c.diagnostics["ndoublings"] for c in cs]) >= 1)
    assert pchains.continuation_route(m, s, 4, True) == "nuts"
    nk.reset_counts()
    cont = mt.resume(cs, steps=8, fused=True)
    assert nk.PLAIN_CALLS == {**dict.fromkeys(nk.PLAIN_CALLS, 0),
                              name: per(8)}
    assert cont[0].task.pos == cs[0].task.pos + 8
    assert np.all(np.isfinite(cont[0].samples.values))


# ---- one whole path from the JAX package's states ---------------------------

def _as_dict(state):
    return {f.name: (_as_dict(getattr(state, f.name))
                     if dataclasses.is_dataclass(getattr(state, f.name))
                     else np.asarray(getattr(state, f.name)))
            for f in dataclasses.fields(state)}


def test_wide_nuts_continuation_matches_jax():
    """From the JAX package's adapted states of a d 40 logistic regression
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

    X, Y = _data(120, 40, seed=91)
    X, Y = X.astype(np.float64), Y.astype(np.float64)
    jm = mc.model(glm=("logistic", X, Y))
    tm = mt.model(glm=("logistic", X, Y), dtype=torch.float64, device="cpu")
    make = lambda p: p.NUTS(maxdoublings=5, mass_adapt="diag")  # noqa: E731
    Cs, steps = 8, 48
    js = make(mc)
    jc = mc.run(jm * js * mc.SerialMC(steps=90, burnin=60), chains=Cs,
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

def test_wide_nuts_kernels_match_plain_on_card():
    """Kernels 8 and 9 (and their _mat forms) on the wide tile at d 33, 150
    and 256 against their plain versions, on a ragged chain count (37) and
    a ragged N (301), slice and multinomial, each launch counted under its
    ``_wide`` key and repeated bitwise (skips without a card;
    chip_smoke.py phase_wide_nuts_kernels holds them at the paths'
    shapes).  At least 99.5% of the chains (here: all but one of 37) take
    the plain version's discrete path; on those, theta, g and lp agree as
    in tests/test_torch_nuts_kernels.py's card test."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    from mcmc_jl_tpu_torch.ops import target_kernels as tk

    cu = lambda a: torch.as_tensor(a, dtype=torch.float32,  # noqa: E731
                                   device="cuda").contiguous()
    Cc, n = 37, 301
    for i, (d, md, multinomial, prior) in enumerate(
            ((33, 6, False, "scalar"), (150, 6, True, "matrix"),
             (256, 10, False, "scalar"), (150, 4, False, "row"))):
        X, Y = _data(n, d, seed=d + i)
        rng = np.random.default_rng(40 + i)
        lam = 1.0
        if prior == "row":
            lam = cu(rng.uniform(0.5, 2.0, d))
        elif prior == "matrix":
            L = np.tril(0.1 * rng.standard_normal((d, d)), -1) \
                + np.diag(rng.uniform(0.7, 1.3, d))
            X, lam = X @ L, cu(L.T @ L)
        XT, Yc = cu(X.T), cu(Y)
        th = cu(0.3 * rng.standard_normal((Cc, d)))
        logp_grad = glm_funcs(XT, Yc, None, None, lam, "logistic")[1]
        lp, g = logp_grad(th)
        kw = dict(maxdoublings=md, prior_prec=lam, multinomial=multinomial)
        eps = 0.05
        suffix = ("_mat" if prior == "matrix" else "") + "_wide"

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
            return torch.Generator(device="cuda").manual_seed(80 + i)

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
