"""The port's dense metric (``mass_adapt="dense"``) against the JAX
package's, on the CPU: the windowed accumulator and the coordinate maps
(samplers/massadapt.py), the freeze and fold of the warm pipeline
(ops/warmstart.py: ``_pool_mass``, ``_fold_theta``, ``_fold``,
``_unfold``), and the matrix prior ``A = lam L'L`` in the plain versions of
kernels 3b, 4, 8 and 9 against the Pallas kernels in interpret mode (3b,
4 and 8 on the same inputs and injected noise, 9 statistically, since it
draws inside).  The samplers on the generic engine and the warm pipeline
on GLMs are in tests/test_torch_dense_paths.py.  The suite turns on x64:
every JAX input is pinned to float32 or float64 as the port's is."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mcmc_jl_tpu as mc
from mcmc_jl_tpu.ops import warmstart as jws
from mcmc_jl_tpu.ops.pallas_glm import LANE, glm_hmc_leapfrogs, pad_chains, \
    pad_design
from mcmc_jl_tpu.samplers import massadapt as jma
import mcmc_jl_tpu_torch as mt
from mcmc_jl_tpu_torch.ops import glm_bign
from mcmc_jl_tpu_torch.ops import glm_kernels as gk
from mcmc_jl_tpu_torch.ops import nuts_kernels as nk
from mcmc_jl_tpu_torch.ops import warmstart as tws
from mcmc_jl_tpu_torch.samplers import massadapt as tma

torch.set_num_threads(1)
F32, F64 = torch.float32, torch.float64


def _corr_data(n=120, seed=5):
    """tests/test_warmfused.py's correlated design (columns 1 and 2 at
    correlation 0.95)."""
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((n, 2))
    X = np.column_stack([np.ones(n), z[:, 0], 0.95 * z[:, 0] + 0.3 * z[:, 1],
                         rng.standard_normal(n)])
    beta = np.array([0.3, 1.0, -0.8, 0.5])
    Y = (rng.random(n) < 1.0 / (1.0 + np.exp(-X @ beta))).astype(np.float64)
    return X, Y


def _as_dict(state):
    return {f.name: (_as_dict(getattr(state, f.name))
                     if dataclasses.is_dataclass(getattr(state, f.name))
                     else np.asarray(getattr(state, f.name)))
            for f in dataclasses.fields(state)}


def _lower(rng, C, d):
    """C random lower-triangular factors with a positive diagonal."""
    L = np.tril(0.4 * rng.standard_normal((C, d, d)))
    L[:, np.arange(d), np.arange(d)] = rng.uniform(0.5, 2.0, (C, d))
    return L


def _fold_mat(rng, d, lam=1.0):
    """A (d, d) dense fold: a lower factor L and A = lam L'L in float32."""
    L = _lower(rng, 1, d)[0]
    return L, (lam * L.T @ L).astype(np.float32)


# ---- the accumulator and the coordinate maps --------------------------------


def test_mass_update_dense_matches_jax():
    """mass_init / mass_update of the dense kind over a fixed sequence of
    positions, 3 chains through the two windows of a burn-in of 60, against
    the JAX package's (vmapped) at every step, rtol 1e-10; chain 2 starts
    from a negative m2, so its first window's covariance is not positive
    definite: both packages keep its old factor there."""
    C, d, T, burnin = 3, 3, 70, 60
    rng = np.random.default_rng(0)
    mix = rng.standard_normal((d, d))
    x = rng.standard_normal((T, C, d)) @ mix.T + np.array([1.0, -2.0, 0.5])
    m2 = np.zeros((C, d, d))
    m2[2] = -50.0 * np.eye(d)
    jacc = jax.vmap(lambda _: jma.mass_init("dense", d, jnp.float64))(
        jnp.arange(C))
    jacc = jacc.replace(m2=jnp.asarray(m2))
    acc = tma.mass_init("dense", d, F64, "cpu", (C,))
    acc = acc.replace(m2=torch.as_tensor(m2))
    assert acc.scale.shape == (C, d, d) and acc.m2.shape == (C, d, d)
    closes, window = [], int(acc.window[0])
    for t in range(T):
        i = t + 1
        jacc = jax.vmap(lambda a, xx: jma.mass_update(
            "dense", a, xx, jnp.int32(i), burnin))(jacc, jnp.asarray(x[t]))
        acc = tma.mass_update("dense", acc, torch.as_tensor(x[t]),
                              torch.full((C,), i, dtype=torch.int32), burnin)
        for f in ("count", "mean", "m2", "scale", "next_end", "window"):
            np.testing.assert_allclose(getattr(acc, f).numpy(),
                                       np.asarray(getattr(jacc, f)),
                                       rtol=1e-10, err_msg=f"{f} at step {i}")
        if int(acc.window[0]) != window:  # a window closed at step i
            window = int(acc.window[0])
            closes.append((i, acc.scale.numpy().copy()))
    assert [i for i, _ in closes] == [34, 54]
    first = closes[0][1]
    assert not np.allclose(first[0], np.eye(d))  # a PD window: new factor
    np.testing.assert_array_equal(first[2], np.eye(d))  # kept its factor
    assert not np.allclose(closes[1][1][2], np.eye(d))
    # one chain of the port's state is the JAX package's unbatched layout
    one = tma.mass_init("dense", d, F64, "cpu", scale0=torch.tensor(
        [1.0, 2.0, 3.0]))
    np.testing.assert_array_equal(
        one.scale.numpy(), np.asarray(jma.mass_init(
            "dense", d, jnp.float64, scale0=jnp.asarray([1.0, 2.0, 3.0])).scale))


def test_dense_transforms_match_jax():
    """theta = L z, its triangular-solve inverse, g_z = L' g and back, for a
    batch of chains each with its own factor (the port's layout) and for
    one chain, against the JAX package's dense_transforms (vmapped)."""
    C, d = 5, 4
    rng = np.random.default_rng(1)
    L = _lower(rng, C, d)
    v = rng.standard_normal((C, d))
    ours = tma.dense_transforms(torch.as_tensor(L))
    theirs = jax.vmap(lambda Lc, vc: tuple(
        f(vc) for f in jma.dense_transforms(Lc)))(jnp.asarray(L),
                                                 jnp.asarray(v))
    for f, want in zip(ours, theirs):
        np.testing.assert_allclose(f(torch.as_tensor(v)).numpy(),
                                   np.asarray(want), rtol=1e-12, atol=1e-14)
    one = tma.dense_transforms(torch.as_tensor(L[0]))
    for f, g in zip(one, jma.dense_transforms(jnp.asarray(L[0]))):
        np.testing.assert_allclose(f(torch.as_tensor(v[0])).numpy(),
                                   np.asarray(g(jnp.asarray(v[0]))),
                                   rtol=1e-12, atol=1e-14)
    fwd, inv, gfwd, ginv = ours
    vt = torch.as_tensor(v)
    torch.testing.assert_close(inv(fwd(vt)), vt)
    torch.testing.assert_close(ginv(gfwd(vt)), vt)


# ---- the freeze and the fold -----------------------------------------------


@pytest.mark.parametrize("name", ["hmc", "nuts"])
def test_fold_matches_jax(name):
    """On JAX dense warmup states of a correlated GLM carried over to the
    port: the pooled factor (_pool_mass), the folded positions L^-1 theta,
    the folded design X L and matrix prior lam L'L (JAX's padded XT and A,
    cut to d and N), and the un-fold of kernel rows (theta = z L', g = g_z
    L^-1), rtol 1e-6."""
    X, Y = _corr_data()
    n, d = X.shape
    jm = mc.model(glm=("logistic", X, Y), prior_prec=0.7)
    make = {"hmc": lambda p: p.HMC(6, 0.1, mass_adapt="dense"),
            "nuts": lambda p: p.NUTS(maxdoublings=4, mass_adapt="dense")}[name]
    js = make(mc)
    k_init, k_warm = jax.random.split(jax.random.PRNGKey(2))
    jst, _ = jws._warmup(jm, js, mc.SerialMC(steps=300, burnin=200), 6,
                         k_init, k_warm)
    convert = {"hmc": mt.hmc_state_from_numpy,
               "nuts": mt.nuts_state_from_numpy}[name]
    st = convert(_as_dict(jax.device_get(jst)), device="cpu")
    assert st.mass.scale.shape == (6, d, d) and st.mass.scale.dtype == F64
    tm = mt.model(glm=("logistic", X, Y), prior_prec=0.7, dtype=F64,
                  device="cpu")

    js_ = jws._pool_mass(js._kind, jst)
    s = tws._pool_mass(make(mt)._kind, st)
    assert s.shape == (d, d) and s.dtype == F64
    np.testing.assert_allclose(s.numpy(), js_, rtol=1e-10, atol=1e-12)
    assert not np.allclose(js_, np.eye(d))

    z = tws._fold_theta(st.pars, s)
    assert z.dtype == F32 and z.is_contiguous()
    np.testing.assert_allclose(z.numpy(), jws._fold_theta(jst.pars, js_),
                               rtol=1e-6, atol=1e-7)
    XT, Yf, lam, W, O = tws._fold(tm.glm_spec, s)
    jXT, jY, _, jz, jlam, jA, _, _ = jws._fold(jm.glm_spec, d, jst, js_)
    np.testing.assert_allclose(XT.numpy(), np.asarray(jXT)[:d, :n],
                               rtol=1e-6, atol=1e-7)
    assert lam.shape == (d, d) and lam.dtype == F32
    np.testing.assert_allclose(lam.numpy(), np.asarray(jA)[:d, :d],
                               rtol=1e-6, atol=1e-7)
    assert jlam == 0.7 and W is None and O is None

    rng = np.random.default_rng(3)
    k = 3
    rows = {"ppars": rng.standard_normal((k, 6, d)).astype(np.float32),
            "pgrads": rng.standard_normal((k, 6, d)).astype(np.float32),
            "plogtarget": rng.standard_normal((k, 6)).astype(np.float32),
            "accept": rng.random((k, 6)) < 0.5}
    thetaF = rng.standard_normal((6, d)).astype(np.float32)
    infos, theta = tws._unfold({kk: torch.as_tensor(v)
                                for kk, v in rows.items()},
                               torch.as_tensor(thetaF), s)
    jinfos, jtheta = jws._unfold({kk: jnp.asarray(v)
                                  for kk, v in rows.items()},
                                 jnp.asarray(thetaF), js_, d)
    for kk in ("ppars", "pgrads"):
        np.testing.assert_allclose(infos[kk].numpy(), np.asarray(jinfos[kk]),
                                   rtol=1e-6, atol=1e-6, err_msg=kk)
    np.testing.assert_allclose(theta.numpy(), np.asarray(jtheta), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(infos["accept"].numpy(), rows["accept"])


def test_pool_mass_of_unarmed_dense_states_is_none():
    """A dense accumulator that never closed a window is the unit metric:
    no fold, in both packages."""
    st = mt.hmc_state_from_numpy(_as_dict(jax.device_get(
        jax.vmap(lambda _: mc.HMC(3, 0.1, mass_adapt="dense").init(
            mc.model(lambda v: -v @ v, gradient=True, init=jnp.zeros(3)),
            jnp.zeros(3), jax.random.PRNGKey(0)))(jnp.arange(4)))),
        device="cpu")
    assert tws._pool_mass("dense", st) is None


# ---- the matrix prior in the plain versions ----------------------------------


@pytest.mark.parametrize("kind", ["logistic", "probit"])
def test_tiled_mat_prior_matches_pallas(kind):
    """Kernel 4's plain (lp, grad) with a (d, d) prior against the Pallas
    _grad_kernel in interpret mode with mat_prior=True (tile 64, so N = 150
    is not a multiple of it), on the same float32 inputs; with weights and
    offsets.  lp to rtol 1e-5 and the gradient to rtol 1e-5 beside an atol
    for its cancelling components; probit adds the JAX kernel's erf-free
    log Phi error (4e-6 an observation)."""
    from mcmc_jl_tpu.ops.pallas_glm_bign import glm_logp_grad_tiled as jtiled
    from mcmc_jl_tpu.ops.pallas_glm_bign import pad_design_tiled

    n, d, C = 150, 5, 8
    rng = np.random.default_rng(4)
    X = np.column_stack([np.ones(n), rng.standard_normal((n, d - 1))]) \
        .astype(np.float32)
    Y = (rng.random(n) < 0.5).astype(np.float32)
    w = rng.uniform(0.5, 2.0, n).astype(np.float32)
    o = (0.2 * rng.standard_normal(n)).astype(np.float32)
    theta = (0.3 * rng.standard_normal((C, d))).astype(np.float32)
    _, A = _fold_mat(rng, d, lam=0.8)

    XTj, Y2, Wj, d_pad, _ = pad_design_tiled(X, Y, weights=w, tile_n=64)
    O = np.zeros((1, XTj.shape[1]), np.float32)
    O[0, :n] = o
    jlp, jg = jtiled(XTj, Y2, jnp.asarray(np.pad(theta, ((0, 0),
                                                         (0, d_pad - d)))),
                     tile_n=64, block_chains=C, interpret=True, kind=kind,
                     weights=Wj, _use_w=True, offsets=jnp.asarray(O),
                     _use_o=True, _unit_prior=False, _mat_prior=True,
                     prior_prec=jnp.asarray(A))
    t = lambda a: torch.as_tensor(a)  # noqa: E731
    gk.reset_counts()
    glm_bign.reset_counts()
    lp, g = glm_bign.glm_logp_grad_tiled(
        t(X.T).contiguous(), t(Y), t(theta), kind=kind, weights=t(w),
        offsets=t(o), prior_prec=t(A))
    assert glm_bign.PLAIN_CALLS == {"glm_logp_grad_tiled": 1}
    assert not any(glm_bign.LAUNCHES.values())
    extra = 4e-6 * n if kind == "probit" else 0.0
    np.testing.assert_allclose(lp.numpy(), np.asarray(jlp), rtol=1e-5,
                               atol=extra)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg)[:, :d], rtol=1e-5,
                               atol=1e-4 + extra)
    # the prior term is the matrix's: against a scalar prior it moves
    lp1, _ = glm_bign.glm_logp_grad_tiled_ref(
        t(X.T).contiguous(), t(Y), t(theta), kind=kind, weights=t(w),
        offsets=t(o))
    quad = np.einsum("ci,ij,cj->c", theta, A, theta)
    np.testing.assert_allclose(
        lp.numpy() - lp1.numpy(),
        -0.5 * quad + 0.5 * (theta * theta).sum(1), rtol=1e-4, atol=1e-4)


NUTS_CASES = {"slice-shallow": (0.15, False), "slice-deep": (0.004, False),
              "multinomial-shallow": (0.15, True),
              "multinomial-deep": (0.004, True)}


@pytest.mark.parametrize("case", list(NUTS_CASES))
def test_nuts_transition_mat_prior_matches_jax(case):
    """Kernel 8's plain transition with a (d, d) prior against JAX's
    glm_nuts_transition(interpret=True) on the same design, start and
    pre-drawn noise, 8 chains: equal ndoublings and diverging on every
    chain, theta within 1e-5, lp within 1e-4, the gradient within 1e-5
    (the gates of tests/test_torch_nuts_kernels.py)."""
    from mcmc_jl_tpu.ops.pallas_nuts import glm_nuts_transition as jtrans

    eps, multinomial = NUTS_CASES[case]
    C, MD, n, d = 8, 5, 80, 3
    rng = np.random.default_rng(11)
    f32 = np.float32
    X = np.column_stack([np.ones(n), rng.standard_normal((n, d - 1))])
    Y = (rng.random(n) < 0.5).astype(np.float64)
    L, A = _fold_mat(rng, d, lam=1.3)
    XL = (X @ L).astype(f32)  # the folded design
    theta = (0.3 * rng.standard_normal((C, d))).astype(f32)
    m0 = rng.standard_normal((C, d)).astype(f32)
    logu = np.log(rng.random(C)).astype(f32)
    dirn = np.where(rng.random((C, MD)) < 0.5, 1.0, -1.0).astype(f32)
    merge = rng.random((C, MD)).astype(f32)
    leaf = rng.random((C, 1 << MD)).astype(f32)

    t = lambda a: torch.as_tensor(a)  # noqa: E731
    XT, Yt = t(XL.T).contiguous(), t(Y.astype(f32))
    lp, g = gk.glm_funcs(XT, Yt, None, None, t(A), "logistic")[1](t(theta))
    nk.reset_counts()
    th_t, g_t, lp_t, nd_t, dv_t = (a.numpy() for a in nk.glm_nuts_transition(
        XT, Yt, t(theta), lp, g, eps, t(m0), t(logu), t(dirn), t(merge),
        t(leaf), maxdoublings=MD, prior_prec=t(A), multinomial=multinomial))
    assert nk.PLAIN_CALLS["glm_nuts_transition"] == 1
    assert not any(nk.LAUNCHES.values())

    def pad(a, width, fill=0.0):
        extra = np.full((a.shape[0], width - a.shape[1]), fill, f32)
        return jnp.asarray(np.concatenate([a, extra], axis=1))

    XTj, Yj, d_pad = pad_design(XL, Y.astype(f32))
    out = jtrans(XTj, Yj, pad(theta, d_pad), jnp.asarray(lp.numpy()),
                 pad(g.numpy(), d_pad), jnp.float32(eps), pad(m0, d_pad),
                 jnp.asarray(logu), pad(dirn, LANE, 1.0),
                 pad(merge, LANE, 0.5), pad(leaf, LANE, 0.5),
                 maxdoublings=MD, interpret=True, prior_prec=jnp.asarray(A),
                 multinomial=multinomial)
    th_j, g_j, lp_j, nd_j, dv_j = (np.asarray(a) for a in out)
    np.testing.assert_array_equal(nd_t, nd_j)
    np.testing.assert_array_equal(dv_t, dv_j)
    if "deep" in case:
        assert nd_t.min() >= 4
    np.testing.assert_allclose(th_t, th_j[:, :d], rtol=0, atol=1e-5)
    np.testing.assert_allclose(lp_t, lp_j, rtol=0, atol=1e-4)
    np.testing.assert_allclose(g_t, g_j[:, :d], rtol=0, atol=1e-5)


def test_rows_mat_prior_matches_successive_pallas_steps():
    """Kernel 3b's plain version with a (d, d) prior and injected noise ==
    the JAX package's _chees_scan transition around the Pallas trajectory
    kernel (interpret, mat_prior) at the same Halton leap counts: accept
    decisions equal, rows within float32 rounding (the gates of
    tests/test_torch_warm_hmc.py's row-prior case)."""
    n, d, C, k, i0 = 60, 4, 8, 6, 37
    eps, T, max_leaps = 0.2, 0.9, 6
    rng = np.random.default_rng(6)
    X = np.column_stack([np.ones(n), rng.standard_normal((n, d - 1))])
    Y = (rng.random(n) < 0.5).astype(np.float32)
    L, A = _fold_mat(rng, d, lam=1.0)
    XL = (X @ L).astype(np.float32)
    theta = (0.2 * rng.standard_normal((C, d))).astype(np.float32)
    z = rng.standard_normal((k, C, d)).astype(np.float32)
    logu = np.log(rng.random((k, C))).astype(np.float32)
    XTt, Yt, At = torch.as_tensor(XL.T).contiguous(), torch.as_tensor(Y), \
        torch.as_tensor(A)
    gk.reset_counts()
    th, g, lp, rows = gk.glm_multistep_rows(
        XTt, Yt, torch.as_tensor(theta), eps, T, i0, max_leaps, k_trans=k,
        generator=torch.Generator().manual_seed(0), prior_prec=At)
    assert gk.PLAIN_CALLS["glm_multistep_rows"] == 1
    assert not any(gk.LAUNCHES.values())
    th, g, lp, rows = gk.glm_multistep_rows_ref(
        XTt, Yt, torch.as_tensor(theta), eps, T, i0, max_leaps, k_trans=k,
        noise=(torch.as_tensor(z), torch.as_tensor(logu)), prior_prec=At)

    XT, Y2, d_pad = pad_design(XL, Y)
    pl = dict(interpret=True, block_chains=C, prior_prec=jnp.asarray(A))
    lp0, g0 = gk.glm_funcs(XTt, Yt, None, None, At, "logistic")[1](
        torch.as_tensor(theta))
    jth, jg = (pad_chains(jnp.asarray(a), d_pad) for a in (theta, g0.numpy()))
    jlp = jnp.asarray(lp0.numpy())
    for t in range(k):
        nl = int(rows["nleaps"][t, 0])
        assert nl == gk.halton_leaps(i0 + t, eps, T, max_leaps)
        m0 = pad_chains(jnp.asarray(z[t]), d_pad)
        p_th, p_m, p_g, p_lp = glm_hmc_leapfrogs(XT, Y2, jth, m0, jg, eps,
                                                 n_leaps=nl, **pl)
        ratio = ((-jlp + 0.5 * jnp.sum(m0 * m0, axis=1))
                 - (-p_lp + 0.5 * jnp.sum(p_m * p_m, axis=1)))
        acc = np.asarray(jnp.where(jnp.isnan(ratio), False,
                                   (ratio > 0) | (ratio > logu[t])))
        jth = jnp.where(acc[:, None], p_th, jth)
        jg = jnp.where(acc[:, None], p_g, jg)
        jlp = jnp.where(acc, p_lp, jlp)
        np.testing.assert_array_equal(rows["accept"][t].numpy(), acc)
        np.testing.assert_allclose(rows["ppars"][t].numpy(),
                                   np.asarray(jth)[:, :d], rtol=2e-5,
                                   atol=2e-5)
        np.testing.assert_allclose(rows["plogtarget"][t].numpy(),
                                   np.asarray(jlp), rtol=1e-5, atol=2e-4)
    assert 0 < rows["accept"].float().mean() < 1, "want accepts and rejects"
    np.testing.assert_allclose(g.numpy(), np.asarray(jg)[:, :d], rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("multinomial", [False, True],
                         ids=["slice", "multinomial"])
def test_nuts_multistep_mat_prior_matches_jax_driver(multinomial):
    """Kernel 9's plain version with a (d, d) prior, through the port's
    multistep driver, against JAX's per-transition driver with the same
    matrix (interpret) at the same step, on a folded correlated GLM: the
    gates of tests/test_torch_nuts_kernels.py (pooled means |z| < 5, sd
    within 30%, depths in range, no divergences after burn-in)."""
    from mcmc_jl_tpu.ops.pallas_nuts import _nuts_run as jax_nuts_run

    X, Y = _corr_data(n=90)
    d = X.shape[1]
    rng = np.random.default_rng(9)
    L, A = _fold_mat(rng, d, lam=1.0)
    XL = (X @ L).astype(np.float32)
    Cs, steps, burn, eps = 8, 320, 80, 0.15
    XT = torch.as_tensor(XL.T).contiguous()
    Yt = torch.as_tensor(Y, dtype=F32)
    nk.reset_counts()
    _, infos = nk._nuts_run_hw(XT, Yt, torch.zeros((Cs, d)), eps,
                               torch.Generator().manual_seed(4), steps=steps,
                               k_trans=8, maxdoublings=6,
                               lam=torch.as_tensor(A),
                               multinomial=multinomial)
    assert nk.PLAIN_CALLS["glm_nuts_multistep"] == steps // 8
    x = infos["ppars"][burn:].numpy()
    assert np.all(np.isfinite(x))
    nd = infos["ndoublings"].numpy()
    assert nd.min() >= 1 and nd.max() <= 6
    assert not infos["diverging"][burn:].any()

    XTj, Yj, d_pad = pad_design(XL, Y.astype(np.float32))
    Ap = np.eye(d_pad, dtype=np.float32)
    Ap[:d, :d] = A
    _, jinfos = jax_nuts_run(
        XTj, Yj, pad_chains(jnp.zeros((Cs, d), jnp.float32), d_pad),
        jnp.float32(eps), jax.random.PRNGKey(5), d=d, steps=steps,
        maxdoublings=6, block_chains=Cs, interpret=True, kind="logistic",
        lam_vec=jnp.asarray(Ap), multinomial=multinomial)
    xj = np.asarray(jinfos["ppars"])[burn:]
    mu, mu_j = x.reshape(-1, d).mean(0), xj.reshape(-1, d).mean(0)
    sd = xj.reshape(-1, d).std(0)
    z = np.abs(mu - mu_j) / (sd * np.sqrt(2.0 / 200.0))
    assert np.all(z < 5), (mu, mu_j, z)
    np.testing.assert_allclose(x.reshape(-1, d).std(0), sd, rtol=0.3)
    assert abs(nd[burn:].mean()
               - np.asarray(jinfos["ndoublings"])[burn:].mean()) < 0.5


def test_prior_shapes_the_wrappers_take():
    """The kernels' prior arguments: a scalar, a (d,) row or a (d, d)
    matrix, anything else refused; a (1, 1) matrix is a scalar.  Kernels 1-3
    take a scalar only."""
    d = 3
    assert gk._prior_args("k", 2.0, d, "cpu")[1:] == (None, None)
    lam, row, mat = gk._prior_args("k", torch.ones(d), d, "cpu")
    assert lam == 1.0 and row.shape == (d,) and mat is None
    lam, row, mat = gk._prior_args("k", torch.eye(d, dtype=F64), d, "cpu")
    assert row is None and mat.shape == (d, d) and mat.dtype == F32
    assert gk._prior(torch.ones(1, 1) * 3) == 3.0
    with pytest.raises(ValueError, match=r"want \(3, 3\)"):
        gk._prior_args("k", torch.eye(4), d, "cpu")
    with pytest.raises(NotImplementedError, match="scalar prior"):
        gk._scalar_prior(torch.eye(d))
