"""The port's exact-NUTS kernel module (ops/nuts_kernels.py) against the JAX
package's Pallas kernels (ops/pallas_nuts.py) on the CPU.

The plain transition takes the same pre-drawn noise as JAX's
``glm_nuts_transition(interpret=True)``, so the two must take the same
discrete path on every chain and agree to float32 rounding.  The multistep
kernel's plain version draws its own noise and is held statistically against
JAX's per-transition driver.  Both sides compute in float32 (the suite turns
on x64, so every JAX input is pinned to float32).  The tests that run the
JAX package import it themselves, so that the card test runs where JAX is
not installed."""
import numpy as np
import pytest
import torch

from mcmc_jl_tpu_torch.ops import nuts_kernels as nk
from mcmc_jl_tpu_torch.ops.glm_kernels import glm_funcs

torch.set_num_threads(1)

C, MD = 16, 5


def _data(n=80, d=3, seed=7):
    """tests/test_pallas_nuts.py's data."""
    rng = np.random.default_rng(seed)
    X = np.column_stack([np.ones(n), rng.standard_normal((n, d - 1))])
    beta = rng.standard_normal(d) * 0.7
    Y = (rng.random(n) < 1.0 / (1.0 + np.exp(-X @ beta))).astype(np.float64)
    return X, Y


def _pad(a, width, fill=0.0):
    """(C, k) float32 -> (C, width), the extra columns filled (TPU layout)."""
    import jax.numpy as jnp

    extra = np.full((a.shape[0], width - a.shape[1]), fill, np.float32)
    return jnp.asarray(np.concatenate([a, extra], axis=1))


def _t(a):
    return None if a is None else torch.as_tensor(a)


CASES = {
    # eps 0.15 gives shallow trees, 0.02 runs to the depth bound
    "slice-shallow": ("logistic", 0.15, False, False),
    "slice-deep": ("logistic", 0.02, False, False),
    "multinomial-shallow": ("logistic", 0.15, True, False),
    "multinomial-deep": ("logistic", 0.02, True, False),
    "probit-weights-offsets-prior-row": ("probit", 0.1, False, True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_transition_matches_jax(case):
    """Same buffers in, the same discrete path out: equal ndoublings and
    diverging on every chain; theta within 1e-5, lp within 1e-4 and the
    gradient within 1e-5 absolute.  For probit the gradient gate adds 2e-5
    relative: the JAX kernel evaluates log Phi with the erf-free
    approximation of ops/special.py (abs err < 4e-6 per observation), the
    port's plain version with torch.special.log_ndtr."""
    import jax.numpy as jnp
    from mcmc_jl_tpu.ops.pallas_glm import LANE, pad_design
    from mcmc_jl_tpu.ops.pallas_nuts import glm_nuts_transition as jax_transition

    kind, eps, multinomial, extra = CASES[case]
    X, Y = _data()
    n, d = X.shape
    rng = np.random.default_rng(11)
    f32 = np.float32
    theta = (np.array([-0.5, 0.0, 1.0]) + 0.3 * rng.standard_normal((C, d))).astype(f32)
    m0 = rng.standard_normal((C, d)).astype(f32)
    logu = np.log(rng.random(C)).astype(f32)
    dirn = np.where(rng.random((C, MD)) < 0.5, 1.0, -1.0).astype(f32)
    merge = rng.random((C, MD)).astype(f32)
    leaf = rng.random((C, 1 << MD)).astype(f32)
    W = rng.uniform(0.5, 2.0, n).astype(f32) if extra else None
    O = (0.1 * rng.standard_normal(n)).astype(f32) if extra else None
    lam = rng.uniform(0.5, 2.0, d).astype(f32) if extra else 1.0

    XT = torch.as_tensor(X.T, dtype=torch.float32).contiguous()
    Yt = torch.as_tensor(Y, dtype=torch.float32)
    prior = _t(lam) if extra else 1.0
    lp, g = glm_funcs(XT, Yt, _t(W), _t(O), prior, kind)[1](_t(theta))
    nk.reset_counts()
    th_t, g_t, lp_t, nd_t, dv_t = (a.numpy() for a in nk.glm_nuts_transition(
        XT, Yt, _t(theta), lp, g, eps, _t(m0), _t(logu), _t(dirn), _t(merge),
        _t(leaf), maxdoublings=MD, kind=kind, weights=_t(W), offsets=_t(O),
        prior_prec=prior, multinomial=multinomial))
    assert nk.PLAIN_CALLS["glm_nuts_transition"] == 1
    assert nk.LAUNCHES["glm_nuts_transition"] == 0

    XTj, Yj, d_pad = pad_design(X, Y)
    out = jax_transition(
        XTj, Yj, _pad(theta, d_pad), jnp.asarray(lp.numpy()),
        _pad(g.numpy(), d_pad), jnp.float32(eps), _pad(m0, d_pad),
        jnp.asarray(logu), _pad(dirn, LANE, 1.0), _pad(merge, LANE, 0.5),
        _pad(leaf, LANE, 0.5), maxdoublings=MD, interpret=True, kind=kind,
        weights=None if W is None else jnp.asarray(W),
        offsets=None if O is None else jnp.asarray(O),
        prior_prec=jnp.asarray(lam) if extra else 1.0,
        multinomial=multinomial)
    th_j, g_j, lp_j, nd_j, dv_j = (np.asarray(a) for a in out)

    np.testing.assert_array_equal(nd_t, nd_j)
    np.testing.assert_array_equal(dv_t, dv_j)
    assert nd_t.min() >= 1 and nd_t.max() <= MD
    if "deep" in case:
        assert nd_t.min() >= 4
    np.testing.assert_allclose(th_t, th_j[:, :d], rtol=0, atol=1e-5)
    np.testing.assert_allclose(lp_t, lp_j, rtol=0, atol=1e-4)
    np.testing.assert_allclose(g_t, g_j[:, :d], atol=1e-5,
                               rtol=2e-5 if kind == "probit" else 0)


@pytest.mark.parametrize("multinomial", [False, True],
                         ids=["slice", "multinomial"])
def test_multistep_ref_matches_jax_driver(multinomial):
    """The multistep kernel's plain version, through the port's multistep
    driver, against JAX's per-transition driver at the same step: the gates
    of tests/test_pallas_nuts.py (pooled means |z| < 5, sd within 30%,
    depths in range, no divergences after burn-in)."""
    import jax
    import jax.numpy as jnp
    from mcmc_jl_tpu.ops.pallas_glm import pad_chains, pad_design
    from mcmc_jl_tpu.ops.pallas_nuts import _nuts_run as jax_nuts_run

    X, Y = _data()
    d = X.shape[1]
    Cs, steps, burn, eps = 8, 320, 80, 0.15
    gen = torch.Generator().manual_seed(4)
    XT = torch.as_tensor(X.T, dtype=torch.float32).contiguous()
    Yt = torch.as_tensor(Y, dtype=torch.float32)
    nk.reset_counts()
    _, infos = nk._nuts_run_hw(XT, Yt, torch.zeros((Cs, d)), eps, gen,
                               steps=steps, k_trans=8, maxdoublings=6,
                               multinomial=multinomial)
    assert nk.PLAIN_CALLS["glm_nuts_multistep"] == steps // 8
    x = infos["ppars"][burn:].numpy()
    assert infos["ppars"].shape == (steps, Cs, d) and np.all(np.isfinite(x))
    nd = infos["ndoublings"].numpy()
    assert nd.min() >= 1 and nd.max() <= 6
    assert infos["accept"][burn:].float().mean() > 0.5
    assert not infos["diverging"][burn:].any()
    assert torch.all(infos["epsilon"] == eps)

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
    assert abs(nd[burn:].mean() - np.asarray(jinfos["ndoublings"])[burn:].mean()) < 0.5


def test_wrappers_check_what_the_kernels_take():
    """Depth outside 1..MAX_DOUBLINGS raises; a (d, d) prior (the dense
    fold) runs the plain version on the CPU, as the plain version with that
    prior computes it; the per-transition driver runs the plain version on
    the CPU and keeps the info protocol."""
    X, Y = _data()
    d = X.shape[1]
    XT = torch.as_tensor(X.T, dtype=torch.float32).contiguous()
    Yt = torch.as_tensor(Y, dtype=torch.float32)
    th = torch.zeros((4, d))
    gen = torch.Generator().manual_seed(0)
    noise = nk.draw_noise(4, d, 3, gen)
    lp, g = glm_funcs(XT, Yt, None, None, 1.0, "logistic")[1](th)
    with pytest.raises(ValueError, match="maxdoublings"):
        nk.glm_nuts_transition(XT, Yt, th, lp, g, 0.1, *noise,
                               maxdoublings=nk.MAX_DOUBLINGS + 1)
    A = torch.eye(d) + 0.1 * torch.ones(d, d)
    nk.reset_counts()
    out = nk.glm_nuts_transition(XT, Yt, th, lp, g, 0.1, *noise,
                                 maxdoublings=3, prior_prec=A)
    assert nk.PLAIN_CALLS["glm_nuts_transition"] == 1
    assert not any(nk.LAUNCHES.values())
    ref = nk.glm_nuts_transition_ref(XT, Yt, th, lp, g, 0.1, *noise,
                                     maxdoublings=3, prior_prec=A)
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    nk.reset_counts()
    (thF, lpF, gF), infos = nk._nuts_run(XT, Yt, th, 0.2, gen, steps=5,
                                         maxdoublings=3)
    assert set(infos) == {"ppars", "pgrads", "plogtarget", "accept",
                          "epsilon", "ndoublings", "diverging"}
    assert infos["ppars"].shape == (5, 4, d)
    assert infos["ndoublings"].dtype == torch.int32
    assert infos["diverging"].dtype == torch.bool
    assert nk.PLAIN_CALLS["glm_nuts_transition"] == 5
    assert not any(nk.LAUNCHES.values())
    torch.testing.assert_close(thF, infos["ppars"][-1])
    with pytest.raises(ValueError, match="multiple of k_trans"):
        nk._nuts_run_hw(XT, Yt, th, 0.2, gen, steps=5, k_trans=2,
                        maxdoublings=3)


@pytest.mark.parametrize("d, md, i0", [(3, 4, 0), (4, 2, 5), (256, 10, 0)])
def test_multistep_draws_follow_the_kernel_counters(d, md, i0):
    """glm_nuts_multistep_draws lays out the multistep kernel's Philox
    draws as draw_noise does, one set per transition, each at its counter
    (chain, transition, draw) as csrc/glm_nuts.cu forms it: momenta two
    normals a draw at draw j // 2, the slice's log-uniform at 0xFFFFFFFF,
    doubling j's direction (u < 0.5 -> -1) and merge uniform at
    0xFFFF0000 + j and 0xFFFF0100 + j, leaf l's at 0xFFFE0000 + l; uniforms
    are 1 - U[0, 1).  At d 256 and md 10 (the wide kernel's bounds) the
    momenta's draw numbers stay below the leaves' and the five ranges are
    disjoint."""
    assert (d - 1) // 2 < nk.LEAF_DRAW
    assert nk.LEAF_DRAW + (1 << md) <= nk.DIR_DRAW
    assert nk.DIR_DRAW + md <= nk.MERGE_DRAW
    assert nk.MERGE_DRAW + md <= nk.SLICE_DRAW
    from mcmc_jl_tpu_torch.ops import philox

    seed, Cs, k = 0x1234_5678_9ABC, 5, 3
    m0, logu, dirn, merge, leaf = nk.glm_nuts_multistep_draws(
        seed, Cs, d, k, md, i0=i0)
    assert m0.shape == (k, Cs, d) and logu.shape == (k, Cs)
    assert dirn.shape == merge.shape == (k, Cs, md)
    assert leaf.shape == (k, Cs, 1 << md)
    assert all(a.dtype == torch.float32 for a in (m0, logu, dirn, merge, leaf))

    def words(c, t, draw):
        return [int(w) for w in philox.philox4x32((c, i0 + t, draw, 0), seed)]

    def u(c, t, draw):
        return np.float32(1.0 - (words(c, t, draw)[0] >> 8) / 16777216.0)

    for t in range(k):
        for c in range(Cs):
            for j in range(d):
                w = np.array(words(c, t, j // 2), dtype=np.uint32)
                want = (philox.box_muller(w[0], w[1]) if j % 2 == 0
                        else philox.box_muller(w[2], w[3]))
                assert m0[t, c, j].item() == float(want)
            w = np.array(words(c, t, nk.SLICE_DRAW)[:1], dtype=np.uint32)
            assert logu[t, c].item() == float(philox.log1m_u01(w)[0])
            for j in range(md):
                ud = u(c, t, nk.DIR_DRAW + j)
                assert dirn[t, c, j].item() == (-1.0 if ud < 0.5 else 1.0)
                assert merge[t, c, j].item() == float(u(c, t,
                                                        nk.MERGE_DRAW + j))
            for leaf_no in range(1 << md):
                assert leaf[t, c, leaf_no].item() == float(
                    u(c, t, nk.LEAF_DRAW + leaf_no))
    assert bool(((merge > 0) & (merge <= 1)).all())
    assert bool(((leaf > 0) & (leaf <= 1)).all())
    # the transition counter is absolute: i0 shifts the sets
    later = nk.glm_nuts_multistep_draws(seed, Cs, d, k - 1, md, i0=i0 + 1)
    for a, b in zip(later, (m0, logu, dirn, merge, leaf)):
        assert torch.equal(a, b[1:])


@pytest.mark.parametrize("multinomial", [False, True],
                         ids=["slice", "multinomial"])
def test_multistep_ref_on_draws_is_the_transitions_chained(multinomial):
    """The multistep plain version fed replayed draws is, bitwise, k calls
    of the transition's plain version fed the same draws one set at a
    time, its rows each call's outputs (accept: theta moved)."""
    X, Y = _data()
    d = X.shape[1]
    Cs, k, md, eps = 12, 4, 5, 0.1
    XT = torch.as_tensor(X.T, dtype=torch.float32).contiguous()
    Yt = torch.as_tensor(Y, dtype=torch.float32)
    rng = np.random.default_rng(3)
    theta = torch.as_tensor(0.3 * rng.standard_normal((Cs, d)),
                            dtype=torch.float32)
    W = torch.as_tensor(rng.uniform(0.5, 2.0, X.shape[0]),
                        dtype=torch.float32)
    lam = torch.as_tensor(rng.uniform(0.5, 2.0, d), dtype=torch.float32)
    kw = dict(maxdoublings=md, weights=W, prior_prec=lam,
              multinomial=multinomial)
    lp, g = glm_funcs(XT, Yt, W, None, lam, "logistic")[1](theta)
    draws = nk.glm_nuts_multistep_draws(99, Cs, d, k, md)
    th_m, g_m, lp_m, rows = nk.glm_nuts_multistep_ref(
        XT, Yt, theta, lp, g, eps, None, k_trans=k, draws=draws, **kw)
    th, gg, ll = theta, g, lp
    for t in range(k):
        out = nk.glm_nuts_transition_ref(XT, Yt, th, ll, gg, eps,
                                         *(a[t] for a in draws), **kw)
        assert torch.equal(rows["ppars"][t], out[0])
        assert torch.equal(rows["pgrads"][t], out[1])
        assert torch.equal(rows["plogtarget"][t], out[2])
        assert torch.equal(rows["ndoublings"][t], out[3])
        assert torch.equal(rows["diverging"][t], out[4])
        assert torch.equal(rows["accept"][t], (out[0] != th).any(-1))
        th, gg, ll = out[:3]
    assert torch.equal(th_m, th) and torch.equal(g_m, gg)
    assert torch.equal(lp_m, ll)
    assert rows["ndoublings"].max() > 1 and rows["accept"].any()


def _card_glm(kind, n, d, seed):
    """A GLM of link ``kind`` with weights, offsets and a (d,) prior row on
    the card, and the coefficients its responses were drawn at:
    (XT, Y, W, O, lam, beta)."""
    rng = np.random.default_rng(seed)
    X = np.column_stack([np.ones(n), rng.standard_normal((n, d - 1))]) * 0.3
    beta = rng.standard_normal(d)
    z = X @ beta
    Y = {"linear": z + rng.standard_normal(n),
         "poisson": rng.poisson(np.exp(z)).astype(float)}.get(
        kind, (rng.random(n) < 1 / (1 + np.exp(-z))).astype(float))
    cu = lambda a: torch.as_tensor(a, dtype=torch.float32,  # noqa: E731
                                   device="cuda").contiguous()
    return (cu(X.T), cu(Y), cu(rng.uniform(0.5, 2.0, n)),
            cu(0.1 * rng.standard_normal(n)), cu(rng.uniform(0.5, 2.0, d)),
            beta)


def test_nuts_kernels_match_plain_on_card():
    """Both NUTS kernels against their plain versions at the chain tile's
    edges on a card (skips without one; chip_smoke.py phase_nuts_kernels
    runs the main-path cases): ragged tiles (C 17 and 300), d 1, 10 and 32
    (tile bounds 8, 16, 32), maxdoublings 1 and 10, rows streamed through
    shared memory, every link with weights, offsets and a (d,) prior row,
    slice and multinomial.  Kernel 8 takes pre-drawn noise, kernel 9 its
    own draws, replayed for its plain version; both repeat bitwise.  At
    least 99.5% of the chains take the plain version's discrete path
    (equal ndoublings and diverging, theta within 1e-3 at every
    transition); on those, theta, the gradient and lp agree to float32
    rounding of N-term sums, kernel 9's gradient and lp with the plain
    version's at its own theta (over k transitions the Hessian amplifies
    theta's float32 drift in them).  Chains start near the coefficients
    the data were drawn at ("near") or at 0 (far from the posterior, large
    gradients); a small step at the posterior builds trees of 2^9 leaves
    and more."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    from mcmc_jl_tpu_torch.ops import target_kernels as tk

    cases = [  # (kind, N, d, C, md, multinomial, eps, near)
        ("logistic", 700, 1, 17, 1, False, 0.1, False),
        ("probit", 3000, 10, 300, 10, True, 0.02, False),   # rows streamed
        ("poisson", 1000, 32, 17, 10, False, 0.005, False),  # rows streamed
        ("poisson", 1000, 32, 17, 10, True, 0.0005, True),
        ("linear", 1000, 10, 300, 6, True, 0.01, True),
        ("logistic", 1000, 10, 300, 10, False, 0.002, True),
    ]
    for i, (kind, n, d, Cc, md, multinomial, eps, near) in enumerate(cases):
        XT, Yc, W, O, lam, beta = _card_glm(kind, n, d, seed=60 + i)
        rng = np.random.default_rng(70 + i)
        th = torch.as_tensor((beta if near else 0.0)
                             + 0.05 * rng.standard_normal((Cc, d)),
                             dtype=torch.float32, device="cuda")
        logp_grad = glm_funcs(XT, Yc, W, O, lam, kind)[1]
        lp, g = logp_grad(th)
        kw = dict(maxdoublings=md, kind=kind, weights=W, offsets=O,
                  prior_prec=lam, multinomial=multinomial)
        scale = max(1.0, n / 1000)
        allowed = int(0.005 * Cc)

        def held(out_k, want, same):
            assert int((~same).sum()) <= allowed, (kind, d, md)
            for a, b, atol in zip(out_k[:3], want,
                                  (1e-4, 2e-3 * scale, 1e-3 * scale)):
                torch.testing.assert_close(a[same], b[same], rtol=1e-4,
                                           atol=atol)

        noise = tuple(torch.as_tensor(a, dtype=torch.float32, device="cuda")
                      for a in (rng.standard_normal((Cc, d)),
                                np.log(rng.random(Cc)),
                                np.where(rng.random((Cc, md)) < 0.5, 1.0,
                                         -1.0),
                                rng.random((Cc, md)),
                                rng.random((Cc, 1 << md))))
        out_k = nk.glm_nuts_transition(XT, Yc, th, lp, g, eps, *noise, **kw)
        again = nk.glm_nuts_transition(XT, Yc, th, lp, g, eps, *noise, **kw)
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
        if near and md == 10:
            assert int(rr["ndoublings"].max()) >= 9, (kind, d)
