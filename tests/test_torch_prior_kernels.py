"""Kernels 1, 2 and 3 with a (d,) prior row and a symmetric (d, d) prior
matrix, as the Pallas kernels take them (mcmc_jl_tpu/ops/pallas_glm.py
``_lam_input``): the port's plain versions (mcmc_jl_tpu_torch/ops/
glm_kernels.py ``glm_leapfrogs_ref``, ``glm_step_ref``,
``glm_multistep_ref``) against the JAX package's ``glm_hmc_leapfrogs`` and
``glm_hmc_step`` in interpret mode on the CPU, at d 10, 150 and 1056 (the
narrow, wide and chunked tiers' widths on the card), on the same numpy
inputs and injected noise; kernel 3 against successive JAX step kernels (its
JAX form draws on the TPU's PRNG, which has no interpret mode); a row of
ones against the scalar prior bit for bit; the ``_mat`` launch counters;
and the drivers ``run_glm_hmc`` and ``run_glm_hmc_multistep`` with either
form.

On the CPU the wrappers run their plain versions;
``test_prior_kernels_match_plain_on_card`` holds the kernels against them
on a card, and chip_smoke.py's ``phase_prior_kernels`` on every tier.
Tolerances are tests/test_torch_chunked_glm.py's: float32 values to rtol
and atol 2e-5, the gradient to atol 2e-4, lp to 2e-4 (N 1e-5 for Poisson
sums of larger terms).  Dtypes are pinned to float32 on both sides
(tests/conftest.py turns on x64)."""
import numpy as np
import pytest
import torch

from mcmc_jl_tpu_torch.ops import glm_hmc
from mcmc_jl_tpu_torch.ops import glm_kernels as gk
from test_torch_wide_glm import _close, _data, _grad_at, _jax, _lower, _t

torch.set_num_threads(1)

G_ATOL = 2e-4  # tests/test_torch_chunked_glm.py's gradient atol
N_OBS = 32


def _pad(d):
    return -(-d // 128) * 128


def _prior(prior, d, rng):
    """The prior of form ``prior`` as a float32 numpy array: a (d,) row in
    [0.5, 2), or A = L'L of a lower-triangular L with a diagonal in [0.5,
    1.5) (the dense fold's form)."""
    if prior == "row":
        return rng.uniform(0.5, 2.0, d).astype(np.float32)
    L = _lower(rng, d)
    return (L.T @ L).astype(np.float32)


def _case(kind, d, seed, C=8, extras=False):
    """(X, Y, theta, momenta, weights, offsets) float32 at N_OBS rows:
    tests/test_torch_wide_glm.py's design, chains at 0.3 standard
    normals."""
    X, Y = _data(kind, N_OBS, d, seed)
    rng = np.random.default_rng(seed + 1)
    theta = (0.3 * rng.standard_normal((C, d))).astype(np.float32)
    m = rng.standard_normal((C, d)).astype(np.float32)
    W = O = None
    if extras:
        W = rng.uniform(0.5, 2.0, N_OBS).astype(np.float32)
        O = (0.2 * rng.standard_normal(N_OBS)).astype(np.float32)
    return X, Y, theta, m, W, O


def _lp_atol(kind):
    return N_OBS * 1e-5 if kind == "poisson" else 2e-4


TRAJ = [(10, "row", "logistic"), (10, "matrix", "poisson"),
        (150, "row", "poisson"), (150, "matrix", "logistic"),
        (1056, "row", "logistic"), (1056, "matrix", "poisson")]


@pytest.mark.parametrize("d,prior,kind", TRAJ)
def test_leapfrogs_ref_with_prior_matches_pallas(d, prior, kind):
    """Kernel 1's plain trajectory with a (d,) row or a (d, d) matrix prior
    == the Pallas _kernel (interpret) with the same prior (the row padded
    with ones, the matrix with an identity corner by the JAX package), on
    the logistic link and on Poisson with weights and offsets."""
    jnp, pg = _jax()
    C, eps, nl = 8, 0.05, 3
    X, Y, theta, m, W, O = _case(kind, d, d + 3, C, extras=kind == "poisson")
    lam = _prior(prior, d, np.random.default_rng(d + 4))
    tkw = dict(kind=kind, weights=_t(W) if W is not None else None,
               offsets=_t(O) if O is not None else None, prior_prec=_t(lam))
    XTt, Yt = _t(X.T).contiguous(), _t(Y)
    _, g = _grad_at(XTt, Yt, _t(theta), **tkw)

    XT, Y2, d_pad = pg.pad_design(X, Y)
    assert d_pad == _pad(d)
    th_p, m_p, g_p = (pg.pad_chains(jnp.asarray(a, jnp.float32), d_pad)
                      for a in (theta, m, g.numpy()))
    jt, jm, jg, jlp = pg.glm_hmc_leapfrogs(
        XT, Y2, th_p, m_p, g_p, eps, n_leaps=nl, block_chains=C,
        interpret=True, kind=kind, weights=W, offsets=O,
        prior_prec=jnp.asarray(lam))
    gk.reset_counts()
    pt, pm, pgr, plp = gk.glm_leapfrogs(XTt, Yt, _t(theta), _t(m), g, eps,
                                        n_leaps=nl, **tkw)
    assert gk.PLAIN_CALLS["glm_leapfrogs"] == 1
    assert not any(gk.LAUNCHES.values())
    assert pt.dtype == torch.float32
    _close(pt, np.asarray(jt)[:, :d])
    _close(pm, np.asarray(jm)[:, :d])
    _close(pgr, np.asarray(jg)[:, :d], atol=G_ATOL)
    _close(plp, jlp, atol=_lp_atol(kind))


STEP = [(10, "row", 0.6), (10, "matrix", 0.6), (150, "row", 0.3),
        (150, "matrix", 0.3), (1056, "row", 0.15), (1056, "matrix", 0.15)]


@pytest.mark.parametrize("d,prior,eps", STEP)
def test_step_ref_with_prior_matches_pallas(d, prior, eps):
    """Kernel 2's plain transition with injected m0 and logu and a (d,) row
    or (d, d) matrix prior == the Pallas _step_kernel with the same prior,
    on a mix of accepts and rejects."""
    jnp, pg = _jax()
    C, nl = 16, 4
    X, Y, theta, m0, _, _ = _case("logistic", d, 50 + d, C)
    rng = np.random.default_rng(51 + d)
    lam = _prior(prior, d, rng)
    logu = np.log(rng.random((C, 1))).astype(np.float32)
    XTt, Yt = _t(X.T).contiguous(), _t(Y)
    lp, g = _grad_at(XTt, Yt, _t(theta), prior_prec=_t(lam))

    XT, Y2, d_pad = pg.pad_design(X, Y)
    th_p, g_p, m_p = (pg.pad_chains(jnp.asarray(a, jnp.float32), d_pad)
                      for a in (theta, g.numpy(), m0))
    jt, jg, jlp, jacc = pg.glm_hmc_step(
        XT, Y2, th_p, g_p, jnp.asarray(lp.numpy()[:, None]), m_p,
        jnp.asarray(logu), eps, n_leaps=nl, block_chains=C, interpret=True,
        prior_prec=jnp.asarray(lam))
    pt, pgr, plp, pacc = gk.glm_step(XTt, Yt, _t(theta), g, lp[:, None],
                                     _t(m0), _t(logu), eps, n_leaps=nl,
                                     prior_prec=_t(lam))
    acc = np.asarray(jacc)[:, 0] > 0.5
    assert acc.any() and not acc.all(), "want a mix of accepts and rejects"
    np.testing.assert_array_equal(pacc.numpy()[:, 0] > 0.5, acc)
    _close(pt, np.asarray(jt)[:, :d])
    _close(pgr, np.asarray(jg)[:, :d], atol=G_ATOL)
    _close(plp[:, 0], np.asarray(jlp)[:, 0], atol=2e-4)


@pytest.mark.parametrize("d,prior,eps", [(10, "matrix", 0.6),
                                         (150, "row", 0.3)])
def test_multistep_ref_with_prior_matches_successive_pallas_steps(d, prior,
                                                                  eps):
    """Kernel 3's plain k-transition version with injected noise and a
    prior row or matrix == k successive Pallas glm_hmc_step calls with the
    same prior (tests/test_torch_glm_kernels.py's scalar test, with the
    prior)."""
    jnp, pg = _jax()
    C, nl, k = 8, 3, 4
    X, Y, theta, _, _, _ = _case("logistic", d, 60 + d, C)
    rng = np.random.default_rng(61 + d)
    lam = _prior(prior, d, rng)
    z = rng.standard_normal((k, C, d)).astype(np.float32)
    logu = np.log(rng.random((k, C))).astype(np.float32)
    XTt, Yt = _t(X.T).contiguous(), _t(Y)
    lp, g = _grad_at(XTt, Yt, _t(theta), prior_prec=_t(lam))

    XT, Y2, d_pad = pg.pad_design(X, Y)
    th_p, g_p = (pg.pad_chains(jnp.asarray(a, jnp.float32), d_pad)
                 for a in (theta, g.numpy()))
    jlp = jnp.asarray(lp.numpy()[:, None])
    accs = []
    for t in range(k):
        th_p, g_p, jlp, jacc = pg.glm_hmc_step(
            XT, Y2, th_p, g_p, jlp, pg.pad_chains(jnp.asarray(z[t]), d_pad),
            jnp.asarray(logu[t][:, None]), eps, n_leaps=nl, block_chains=C,
            interpret=True, prior_prec=jnp.asarray(lam))
        accs.append(np.asarray(jacc)[:, 0])
    pt, pgr, plp, prate = gk.glm_multistep_ref(
        XTt, Yt, _t(theta), eps, k_trans=k, n_leaps=nl,
        noise=(_t(z), _t(logu)), prior_prec=_t(lam))
    rate = np.mean(accs, axis=0)
    assert 0 < rate.mean() < 1, "want a mix of accepts and rejects"
    np.testing.assert_allclose(prate.numpy(), rate)
    _close(pt, np.asarray(th_p)[:, :d])
    _close(pgr, np.asarray(g_p)[:, :d], atol=G_ATOL)
    _close(plp, np.asarray(jlp)[:, 0], atol=2e-4)


def _three(XTt, Yt, theta, m0, logu, lp, g, prior):
    """Kernels 1, 2 and 3 (plain versions here) at one prior: kernel 3 on
    injected noise (two transitions)."""
    k1 = gk.glm_leapfrogs(XTt, Yt, theta, m0[0], g, 0.3, n_leaps=3,
                          prior_prec=prior)
    k2 = gk.glm_step(XTt, Yt, theta, g, lp[:, None], m0[0], logu[0][:, None],
                     0.3, n_leaps=3, prior_prec=prior)
    k3 = gk.glm_multistep_ref(XTt, Yt, theta, 0.3, k_trans=2, n_leaps=3,
                              noise=(m0, logu), prior_prec=prior)
    return k1 + k2 + k3


@pytest.mark.parametrize("d", [10, 150])
def test_row_of_ones_gives_the_scalar_bits(d):
    """A (d,) row of ones gives kernels 1, 2 and 3 the scalar prior's bits;
    the identity matrix agrees with it to the plain versions' rounding (a
    product with zeros and ones)."""
    C = 8
    X, Y, theta, _, _, _ = _case("logistic", d, 70 + d, C)
    rng = np.random.default_rng(71 + d)
    m0 = _t(rng.standard_normal((2, C, d)))
    logu = _t(np.log(rng.random((2, C))))
    XTt, Yt, th = _t(X.T).contiguous(), _t(Y), _t(theta)
    lp, g = _grad_at(XTt, Yt, th)
    scalar = _three(XTt, Yt, th, m0, logu, lp, g, 1.0)
    ones = _three(XTt, Yt, th, m0, logu, lp, g, torch.ones(d))
    eye = _three(XTt, Yt, th, m0, logu, lp, g, torch.eye(d))
    assert all(torch.equal(a, b) for a, b in zip(scalar, ones))
    for a, b in zip(scalar, eye):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def test_kernels_1_2_3_count_the_matrix_apart():
    """Launches of kernels 1, 2 and 3 with a (d, d) prior count under
    ``<name>_mat`` and the tier's suffix, a row under the kernel's own name;
    the counters hold every such name; on the CPU the wrappers run their
    plain versions and launch nothing."""
    A, row = torch.eye(3), torch.ones(3)
    for name in ("glm_leapfrogs", "glm_step", "glm_multistep"):
        for d, tier in ((10, ""), (40, "_wide"), (300, "_xwide"),
                        (1025, "_chunked"), (gk.D_MAX, "_chunked")):
            assert gk._counted(name, A, d) == name + "_mat" + tier
            assert gk._counted(name, None, d) == name + tier
            assert name + "_mat" + tier in gk.LAUNCHES
    assert len(gk.LAUNCHES) == 4 * 2 * 4
    X, Y, theta, m, _, _ = _case("logistic", 3, 80)
    XTt, Yt, th = _t(X.T).contiguous(), _t(Y), _t(theta)
    lp, g = _grad_at(XTt, Yt, th)
    gk.reset_counts()
    for prior in (row, A):
        gk.glm_leapfrogs(XTt, Yt, th, _t(m), g, 0.1, n_leaps=2,
                         prior_prec=prior)
        gk.glm_step(XTt, Yt, th, g, lp[:, None], _t(m),
                    torch.zeros(8, 1), 0.1, n_leaps=2, prior_prec=prior)
        gk.glm_multistep(XTt, Yt, th, 0.1, k_trans=2, n_leaps=2,
                         generator=torch.Generator().manual_seed(0),
                         prior_prec=prior)
    assert {n: gk.PLAIN_CALLS[n] for n in ("glm_leapfrogs", "glm_step",
                                            "glm_multistep")} == dict.fromkeys(
        ("glm_leapfrogs", "glm_step", "glm_multistep"), 2)
    assert not any(gk.LAUNCHES.values())
    with pytest.raises(ValueError, match=r"want \(3, 3\)"):
        gk._prior_args("glm_step", torch.eye(4), 3, "cpu")


@pytest.mark.parametrize("fused_step", [False, True])
def test_drivers_take_row_and_matrix_priors(fused_step):
    """``run_glm_hmc`` (kernel 1, or 2 with ``fused_step``) and
    ``run_glm_hmc_multistep`` (kernel 3) take the prior as a scalar, a (d,)
    row or a (d, d) matrix: a row of 2s gives the scalar 2's chains bit for
    bit, 2 I the same to rounding; every run finite."""
    d, C, steps = 6, 16, 8
    X, Y = _data("logistic", 60, d, seed=90)
    runs = {}
    for label, prior in (("scalar", 2.0), ("row", torch.full((d,), 2.0)),
                         ("matrix", 2.0 * torch.eye(d, dtype=torch.float64))):
        th, infos = glm_hmc.run_glm_hmc(
            X, Y, C, steps, n_leaps=3, eps=0.2, seed=4, device="cpu",
            prior_prec=prior, fused_step=fused_step)
        thm, infos_m = glm_hmc.run_glm_hmc_multistep(
            X, Y, C, steps, thin=4, n_leaps=3, eps=0.2, seed=4,
            device="cpu", prior_prec=prior)
        assert th.shape == thm.shape == (C, d)
        assert bool(torch.isfinite(th).all() and torch.isfinite(thm).all())
        runs[label] = (th, infos["plogtarget"], thm,
                       infos_m["plogtarget"])
    assert all(torch.equal(a, b) for a, b in zip(runs["scalar"],
                                                 runs["row"]))
    for a, b in zip(runs["scalar"], runs["matrix"]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_prior_kernels_match_plain_on_card():
    """Kernels 1, 2 and 3 with a (d,) row and a (d, d) matrix prior at d 10,
    150, 300 and 1056 (one a tier) against their plain versions on a card
    (kernel 3 on its own Philox draws replayed), each launch counted under
    its name (``_mat`` with the matrix), and a row of ones bitwise the
    scalar kernel (skips without a card; chip_smoke.py phase_prior_kernels
    holds them at 1027 chains and N 1000)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    cu = lambda a: torch.as_tensor(np.asarray(a, np.float32)).cuda()  # noqa: E731
    C, N = 37, 300
    for d in (10, 150, 300, 1056):
        X, Y = _data("logistic", N, d, seed=d)
        rng = np.random.default_rng(d + 1)
        XT, Yc = cu(X.T).contiguous(), cu(Y)
        theta = cu(0.3 * rng.standard_normal((C, d)))
        m = cu(rng.standard_normal((C, d)))
        logu = cu(np.log(rng.random((C, 1))))
        tier = gk._counted("", None, d)
        for prior in ("row", "matrix", "ones"):
            lam = (torch.ones(d, device="cuda") if prior == "ones"
                   else cu(_prior(prior, d, rng)))
            mat = "_mat" if prior == "matrix" else ""
            lp, g = _grad_at(XT, Yc, theta, prior_prec=lam)
            gk.reset_counts()
            out = gk.glm_leapfrogs(XT, Yc, theta, m, g, 0.05, n_leaps=4,
                                   prior_prec=lam)
            ref = gk.glm_leapfrogs_ref(XT, Yc, theta, m, g, 0.05, n_leaps=4,
                                       prior_prec=lam)
            for a, b in zip(out, ref):
                torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-3)
            sk = gk.glm_step(XT, Yc, theta, g, lp[:, None], m, logu, 0.3,
                             n_leaps=4, prior_prec=lam)
            sr = gk.glm_step_ref(XT, Yc, theta, g, lp[:, None], m, logu, 0.3,
                                 n_leaps=4, prior_prec=lam)
            assert int((sk[3] != sr[3]).sum()) <= 1
            same = (sk[3] == sr[3])[:, 0]
            torch.testing.assert_close(sk[0][same], sr[0][same], rtol=1e-4,
                                       atol=1e-3)
            gen = lambda: torch.Generator(device="cuda").manual_seed(d)  # noqa: E731
            mk = gk.glm_multistep(XT, Yc, theta, 0.3, k_trans=2, n_leaps=4,
                                  generator=gen(), prior_prec=lam)
            m0, lu = gk.glm_multistep_draws(gk._seed(gen()), C, d, 2,
                                            device="cuda")
            mr = gk.glm_multistep_ref(XT, Yc, theta, 0.3, k_trans=2,
                                      n_leaps=4, noise=(m0, lu),
                                      prior_prec=lam)
            same = (mk[3] == mr[3]) & ((mk[0] - mr[0]).abs().amax(-1) < 1e-3)
            assert int((~same).sum()) <= 1
            torch.testing.assert_close(mk[0][same], mr[0][same], rtol=1e-4,
                                       atol=1e-3)
            assert {n: gk.LAUNCHES[n + mat + tier] for n in (
                "glm_leapfrogs", "glm_step", "glm_multistep")} == {
                "glm_leapfrogs": 1, "glm_step": 1, "glm_multistep": 1}
            if prior == "ones":
                sc = gk.glm_leapfrogs(XT, Yc, theta, m, g, 0.05, n_leaps=4)
                assert all(torch.equal(a, b) for a, b in zip(out, sc))
