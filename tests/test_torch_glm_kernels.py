"""The port's GLM kernels (mcmc_jl_tpu_torch/ops/glm_kernels.py) against the
JAX package's Pallas kernels (mcmc_jl_tpu/ops/pallas_glm.py) run in
interpret mode on the CPU, on the same numpy inputs and injected noise.

On the CPU the port's wrappers run their plain PyTorch versions; the CUDA
kernels themselves are held against those plain versions on the card
(``test_kernels_match_plain_on_card`` and
``test_rows_kernel_matches_plain_on_card`` here, and chip_smoke.py).  The tests
that run the JAX package import it themselves, so that the card test runs
where JAX is not installed."""
import numpy as np
import pytest
import torch

from mcmc_jl_tpu_torch.ops import glm_kernels as gk
from mcmc_jl_tpu_torch.ops import nuts_kernels as nk

torch.set_num_threads(1)

LINKS = ["logistic", "linear", "poisson", "probit"]
INTEGRATORS = ["leapfrog", "2stage", "3stage"]


def _data(kind, n=64, d=5, seed=0):
    rng = np.random.default_rng(seed)
    X = np.column_stack([np.ones(n), rng.standard_normal((n, d - 1))])
    if kind == "poisson":
        X = X * 0.3
    beta = rng.standard_normal(d) * 0.5
    z = X @ beta
    if kind == "linear":
        Y = z + rng.standard_normal(n)
    elif kind == "poisson":
        Y = rng.poisson(np.exp(z)).astype(np.float64)
    else:
        Y = (rng.random(n) < 1.0 / (1.0 + np.exp(-z))).astype(np.float64)
    return X.astype(np.float32), Y.astype(np.float32)


def _state(C, d, seed):
    rng = np.random.default_rng(seed)
    theta = (0.2 * rng.standard_normal((C, d))).astype(np.float32)
    m = rng.standard_normal((C, d)).astype(np.float32)
    return theta, m


def _pallas():
    """(jax.numpy, the JAX package's pallas_glm module)."""
    import jax.numpy as jnp

    from mcmc_jl_tpu.ops import pallas_glm

    return jnp, pallas_glm


def _jax_inputs(X, Y, *arrays):
    jnp, pg = _pallas()
    XT, Y2, d_pad = pg.pad_design(X, Y)
    return (XT, Y2) + tuple(pg.pad_chains(jnp.asarray(a, jnp.float32), d_pad)
                            for a in arrays)


def _t(a):
    return torch.as_tensor(np.asarray(a, dtype=np.float32))


def _grad_at(XT, Y, theta, **kw):
    """Port's plain (lp, grad) at theta through an eps=0 trajectory."""
    _, _, g, lp = gk.glm_leapfrogs_ref(XT, Y, theta, torch.zeros_like(theta),
                                       torch.zeros_like(theta), 0.0,
                                       n_leaps=1, **kw)
    return lp, g


def _lp_atol(kind, n):
    # the JAX kernels use the erf-free log_ndtr (abs err < 4e-6 per
    # observation); the port uses the exact one
    return n * 1e-5 if kind == "probit" else 2e-4


def _close(a, b, rtol=2e-5, atol=2e-5):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol)


CASES = [(k, i, False) for k in LINKS for i in INTEGRATORS] + [
    ("logistic", "leapfrog", True)]


@pytest.mark.parametrize("kind,integrator,extras", CASES)
def test_leapfrogs_ref_matches_pallas(kind, integrator, extras):
    """(a) plain trajectory == Pallas _kernel (interpret) on the same state."""
    n, d, C, eps, nl = 64, 5, 8, 0.05, 4
    X, Y = _data(kind, n, d, seed=1)
    theta, m = _state(C, d, seed=2)
    kw = {}
    if extras:
        rng = np.random.default_rng(3)
        kw = dict(weights=rng.uniform(0.5, 2.0, n).astype(np.float32),
                  offsets=(0.2 * rng.standard_normal(n)).astype(np.float32),
                  prior_prec=2.5)
    XTt, Yt = _t(X.T), _t(Y)
    tkw = {k: (_t(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    _, g = _grad_at(XTt, Yt, _t(theta), kind=kind, **tkw)

    XT, Y2, th_p, m_p, g_p = _jax_inputs(X, Y, theta, m, g.numpy())
    jt, jm, jg, jlp = _pallas()[1].glm_hmc_leapfrogs(
        XT, Y2, th_p, m_p, g_p, eps, n_leaps=nl, block_chains=C,
        interpret=True, kind=kind, integrator=integrator, **kw)
    pt, pm, pg, plp = gk.glm_leapfrogs(XTt, Yt, _t(theta), _t(m), g, eps,
                                       n_leaps=nl, kind=kind,
                                       integrator=integrator, **tkw)
    _close(pt, np.asarray(jt)[:, :d])
    _close(pm, np.asarray(jm)[:, :d])
    _close(pg, np.asarray(jg)[:, :d])
    _close(plp, jlp, atol=_lp_atol(kind, n))


def test_step_ref_matches_pallas():
    """(b) plain transition == Pallas _step_kernel with the same m0 and
    logu, on a mix of accepts and rejects."""
    n, d, C, eps, nl = 72, 5, 16, 0.42, 4
    X, Y = _data("logistic", n, d, seed=9)
    theta, m0 = _state(C, d, seed=4)
    logu = np.log(np.random.default_rng(5).random((C, 1))).astype(np.float32)
    XTt, Yt = _t(X.T), _t(Y)
    lp, g = _grad_at(XTt, Yt, _t(theta))

    jnp, pg = _pallas()
    XT, Y2, th_p, g_p, m_p = _jax_inputs(X, Y, theta, g.numpy(), m0)
    jt, jg, jlp, jacc = pg.glm_hmc_step(XT, Y2, th_p, g_p,
                                        jnp.asarray(lp.numpy()[:, None]), m_p,
                                        jnp.asarray(logu), eps, n_leaps=nl,
                                        block_chains=C, interpret=True)
    pt, pg, plp, pacc = gk.glm_step(XTt, Yt, _t(theta), g, lp[:, None],
                                    _t(m0), _t(logu), eps, n_leaps=nl)
    acc = np.asarray(jacc)[:, 0] > 0.5
    assert acc.any() and not acc.all(), "want a mix of accepts and rejects"
    np.testing.assert_array_equal(pacc.numpy()[:, 0] > 0.5, acc)
    _close(pt, np.asarray(jt)[:, :d])
    _close(pg, np.asarray(jg)[:, :d])
    _close(plp, jlp, atol=2e-4)


def test_multistep_ref_matches_successive_pallas_steps():
    """(c) plain k-transition version with injected noise == k successive
    Pallas glm_hmc_step calls."""
    n, d, C, eps, nl, k = 60, 4, 8, 0.3, 3, 4
    X, Y = _data("logistic", n, d, seed=6)
    theta, _ = _state(C, d, seed=7)
    rng = np.random.default_rng(8)
    z = rng.standard_normal((k, C, d)).astype(np.float32)
    logu = np.log(rng.random((k, C))).astype(np.float32)
    XTt, Yt = _t(X.T), _t(Y)
    lp, g = _grad_at(XTt, Yt, _t(theta))

    th_p, g_p, jlp, accs = _pallas_steps(X, Y, theta, g, lp, z, logu, eps,
                                         nl)
    pt, pg, plp, prate = gk.glm_multistep_ref(
        XTt, Yt, _t(theta), eps, k_trans=k, n_leaps=nl,
        noise=(_t(z), _t(logu)))
    rate = np.mean(accs, axis=0)
    assert 0 < rate.mean() < 1, "want a mix of accepts and rejects"
    np.testing.assert_allclose(prate.numpy(), rate)
    _close(pt, np.asarray(th_p)[:, :d])
    _close(pg, np.asarray(g_p)[:, :d])
    _close(plp, np.asarray(jlp)[:, 0], atol=2e-4)


def _pallas_steps(X, Y, theta, g, lp, z, logu, eps, nl):
    """k successive Pallas glm_hmc_step calls (interpret mode) from (theta,
    g, lp) on the momenta z (k, C, d) and log-uniforms logu (k, C).
    Returns the padded (theta, g, lp (C, 1)) and the accepts per step."""
    jnp, pg = _pallas()
    XT, Y2, th_p, g_p = _jax_inputs(X, Y, theta, np.asarray(g))
    jlp = jnp.asarray(np.asarray(lp)[:, None])
    accs = []
    for t in range(len(z)):
        th_p, g_p, jlp, jacc = pg.glm_hmc_step(
            XT, Y2, th_p, g_p, jlp,
            pg.pad_chains(jnp.asarray(np.asarray(z[t])), XT.shape[0]),
            jnp.asarray(np.asarray(logu[t])[:, None]), eps, n_leaps=nl,
            block_chains=theta.shape[0], interpret=True)
        accs.append(np.asarray(jacc)[:, 0])
    return th_p, g_p, jlp, accs


def test_multistep_draws_replay_the_nuts_layout():
    """The replay of glm_multistep's in-kernel draws is the (m0, logu) part
    of the multistep NUTS kernel's replay under the same seed (both kernels
    draw through csrc/glm_tile.cuh momentum and log_uniform), and follows
    the counter (chain, transition, draw): coordinate j from draw j // 2,
    words (0, 1) for even j and (2, 3) for odd j, log u from draw
    SLICE_DRAW."""
    from mcmc_jl_tpu_torch.ops import philox

    seed, C, d, k, i0 = 0x1234_5678_9ABC, 9, 5, 3, 7
    m0, logu = gk.glm_multistep_draws(seed, C, d, k, i0=i0)
    nuts = nk.glm_nuts_multistep_draws(seed, C, d, k, 4, i0=i0)
    assert m0.shape == (k, C, d) and logu.shape == (k, C)
    assert m0.dtype == logu.dtype == torch.float32
    assert torch.equal(m0, nuts[0]) and torch.equal(logu, nuts[1])
    t, c = 2, 6
    for j in range(d):
        b = philox.philox4x32((c, i0 + t, j // 2, 0), seed)
        want = (philox.box_muller(b[0], b[1]) if j % 2 == 0
                else philox.box_muller(b[2], b[3]))
        assert m0[t, c, j].item() == float(want)
    b = philox.philox4x32((c, i0 + t, gk.SLICE_DRAW, 0), seed)
    assert logu[t, c].item() == float(philox.log1m_u01(b[0]))
    assert torch.isfinite(m0).all() and (logu <= 0).all()


def test_step_refs_on_replayed_draws_match_pallas_steps():
    """k successive plain glm_step_ref calls fed the replayed draws of a
    glm_multistep launch (how chip_smoke.py holds the kernel chain by
    chain) == k successive Pallas glm_hmc_step calls (interpret mode) on
    the same draws, on a mix of accepts and rejects."""
    n, d, C, eps, nl, k = 60, 5, 8, 0.3, 3, 4
    X, Y = _data("logistic", n, d, seed=15)
    theta, _ = _state(C, d, seed=16)
    XTt, Yt = _t(X.T), _t(Y)
    lp, g = _grad_at(XTt, Yt, _t(theta))
    z, logu = gk.glm_multistep_draws(0xC0FFEE, C, d, k)
    th, gr, lpc, accs = _t(theta), g, lp[:, None], []
    for t in range(k):
        th, gr, lpc, acc = gk.glm_step_ref(XTt, Yt, th, gr, lpc, z[t],
                                           logu[t][:, None], eps, n_leaps=nl)
        accs.append(acc[:, 0].numpy())
    th_p, g_p, jlp, jaccs = _pallas_steps(X, Y, theta, g.numpy(), lp.numpy(),
                                          z.numpy(), logu.numpy(), eps, nl)
    assert 0 < np.mean(jaccs) < 1, "want a mix of accepts and rejects"
    np.testing.assert_array_equal(np.array(accs), np.array(jaccs))
    _close(th, np.asarray(th_p)[:, :d])
    _close(gr, np.asarray(g_p)[:, :d])
    _close(lpc[:, 0], np.asarray(jlp)[:, 0], atol=2e-4)


def test_rows_ref_on_replayed_draws_matches_pallas_steps():
    """The plain version of the Halton multistep kernel fed the replayed
    draws of a glm_multistep_rows launch from absolute transition i0 (how
    chip_smoke.py holds kernel 3b chain by chain), with a (d,) prior row,
    == successive Pallas glm_hmc_step calls (interpret mode) on the same
    draws at the Halton leap count of each transition, on a mix of accepts
    and rejects; its nleaps rows are those leap counts."""
    n, d, C, k, i0 = 60, 5, 8, 6, 37
    eps, T, max_leaps = 0.25, 0.9, 5
    X, Y = _data("logistic", n, d, seed=21)
    theta, _ = _state(C, d, seed=22)
    lam = np.array([1.0, 2.0, 0.5, 1.5, 0.8], np.float32)
    XTt, Yt, lam_t = _t(X.T), _t(Y), _t(lam)
    z, logu = gk.glm_multistep_draws(0xBEEF_CAFE, C, d, k, i0=i0)
    th, g, lp, rows = gk.glm_multistep_rows_ref(
        XTt, Yt, _t(theta), eps, T, i0, max_leaps, k_trans=k,
        noise=(z, logu), prior_prec=lam_t)
    nls = [gk.halton_leaps(i0 + t, eps, T, max_leaps) for t in range(k)]
    assert len(set(nls)) > 1
    assert rows["nleaps"].tolist() == [[nl] * C for nl in nls]

    jnp, pg = _pallas()
    lp0, g0 = gk.glm_funcs(XTt, Yt, None, None, lam_t, "logistic")[1](
        _t(theta))
    XT, Y2, th_p, g_p = _jax_inputs(X, Y, theta, g0.numpy())
    d_pad = XT.shape[0]
    prior = jnp.asarray(np.concatenate(
        [lam, np.ones(d_pad - d, np.float32)]).reshape(1, -1))
    jlp = jnp.asarray(lp0.numpy()[:, None])
    for t in range(k):
        th_p, g_p, jlp, jacc = pg.glm_hmc_step(
            XT, Y2, th_p, g_p, jlp,
            pg.pad_chains(jnp.asarray(z[t].numpy()), d_pad),
            jnp.asarray(logu[t].numpy()[:, None]), eps, n_leaps=nls[t],
            block_chains=C, interpret=True, prior_prec=prior)
        np.testing.assert_array_equal(rows["accept"][t].numpy(),
                                      np.asarray(jacc)[:, 0] > 0.5)
        _close(rows["ppars"][t], np.asarray(th_p)[:, :d])
        _close(rows["pgrads"][t], np.asarray(g_p)[:, :d])
        _close(rows["plogtarget"][t], np.asarray(jlp)[:, 0], atol=2e-4)
    assert 0 < float(rows["accept"].float().mean()) < 1, \
        "want a mix of accepts and rejects"
    _close(th, np.asarray(th_p)[:, :d])
    _close(g, np.asarray(g_p)[:, :d])
    _close(lp, np.asarray(jlp)[:, 0], atol=2e-4)


def test_cpu_wrappers_run_plain_versions():
    """On CPU tensors every wrapper runs its plain version and launches
    nothing; the multistep wrapper draws from the generator it is given."""
    X, Y = _data("logistic", 40, 3, seed=10)
    theta, m = _state(4, 3, seed=11)
    XTt, Yt, th = _t(X.T), _t(Y), _t(theta)
    lp, g = _grad_at(XTt, Yt, th)
    gk.reset_counts()
    gk.glm_leapfrogs(XTt, Yt, th, _t(m), g, 0.1, n_leaps=2)
    gk.glm_step(XTt, Yt, th, g, lp[:, None], _t(m), torch.zeros(4, 1), 0.1,
                n_leaps=2)
    gens = [torch.Generator().manual_seed(0) for _ in range(2)]
    a = gk.glm_multistep(XTt, Yt, th, 0.1, k_trans=3, n_leaps=2,
                         generator=gens[0])
    b = gk.glm_multistep(XTt, Yt, th, 0.1, k_trans=3, n_leaps=2,
                         generator=gens[1])
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    assert gk.PLAIN_CALLS == {"glm_leapfrogs": 1, "glm_step": 1,
                              "glm_multistep": 2, "glm_multistep_rows": 0}
    assert not any(gk.LAUNCHES.values())


def test_wrapper_refuses_other_devices():
    th = torch.zeros(2, 3, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        gk.glm_leapfrogs(th.T, th[0], th, th, th, 0.1)


@pytest.mark.parametrize("bad", ["float64", "noncontig", "wide", "link",
                                 "shape", "flat", "flat_theta", "column",
                                 "per_chain", "nuts_wide"])
def test_kernel_input_checks(bad):
    """What the CUDA wrappers refuse, checked before any launch: a state
    that is not (C, d) would make the kernel read past its end; d past the
    kernels' bound (16384 for kernels 1-4, 8 and 9, whose chunked tier
    takes d 1025 to 16384) has no instantiation."""
    N, d, C = 20, 3, 4
    XT, Y = torch.zeros(d, N), torch.zeros(N)
    th, m, lp = torch.zeros(C, d), torch.zeros(C, d), torch.zeros(C)
    kind = "logistic"
    name, d_max = "glm_step", gk.D_MAX
    gk._check("glm_step", XT, Y, None, None, kind, {"theta": th, "m0": m},
              {"lp": lp})
    if bad == "float64":
        th = th.double()
    elif bad == "noncontig":
        th = torch.zeros(d, C).T
    elif bad == "wide":
        assert gk.D_MAX == 16384
        gk._check(name, torch.zeros(gk.D_MAX, N), Y, None, None, kind,
                  {"theta": torch.zeros(C, gk.D_MAX),
                   "m0": torch.zeros(C, gk.D_MAX)}, {"lp": lp})
        XT, th = torch.zeros(gk.D_MAX + 1, N), torch.zeros(C, gk.D_MAX + 1)
        m = torch.zeros(C, gk.D_MAX + 1)
    elif bad == "nuts_wide":  # the NUTS wrapper takes d 33-16384, not 16385
        name, d_max = "glm_nuts_transition", nk.NUTS_D_MAX
        assert d_max == gk.D_MAX == 16384
        for dd in (33, 257, 1025, d_max):
            gk._check(name, torch.zeros(dd, N), Y, None, None, kind,
                      {"theta": torch.zeros(C, dd), "m0": torch.zeros(C, dd)},
                      {"lp": lp})
        XT, th = torch.zeros(d_max + 1, N), torch.zeros(C, d_max + 1)
        m = torch.zeros(C, d_max + 1)
    elif bad == "link":
        kind = (lambda z, y: z, lambda z, y: y)
    elif bad == "shape":
        th = torch.zeros(C, d + 1)
    elif bad == "flat":
        m = torch.zeros(C)
    elif bad == "flat_theta":
        th = torch.zeros(C)
    elif bad == "column":
        th = torch.zeros(C, 1)
    else:
        lp = torch.zeros(C, d)
    with pytest.raises(ValueError):
        gk._check(name, XT, Y, None, None, kind, {"theta": th, "m0": m},
                  {"lp": lp})


def test_kernels_match_plain_on_card():
    """Each CUDA kernel against its plain version on a card (skips without
    one; chip_smoke.py runs the same checks at the main path's shape)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    X, Y = _data("logistic", 300, 6, seed=12)
    theta, m = _state(300, 6, seed=13)
    cu = lambda a: _t(a).cuda().contiguous()  # noqa: E731
    XT, Yc, th, mm = cu(X.T), cu(Y), cu(theta), cu(m)
    lp, g = _grad_at(XT, Yc, th)
    for a, b in zip(gk.glm_leapfrogs(XT, Yc, th, mm, g, 0.05, n_leaps=5),
                    gk.glm_leapfrogs_ref(XT, Yc, th, mm, g, 0.05, n_leaps=5)):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-3)
    r1, r2 = (gk.glm_multistep(
        XT, Yc, th, 0.05, k_trans=5, n_leaps=5,
        generator=torch.Generator(device="cuda").manual_seed(1))
        for _ in range(2))
    assert all(torch.equal(a, b) for a, b in zip(r1, r2))
    # the chain-tile trajectory kernel at its edges: ragged last tiles of
    # 16 chains, d = 1, 10 and 32 (tile bounds 8, 16, 32), rows streamed in
    # cp.async tiles (N past the resident budget: 3000 at d 10, 1500 at
    # d 32), every link with weights and offsets, every integrator; the
    # sums' atol grows with N / 1000
    rng = np.random.default_rng(14)
    edges = [("logistic", "leapfrog", 1, 700, 37),
             ("linear", "2stage", 10, 3000, 300),
             ("poisson", "3stage", 32, 1500, 40),
             ("probit", "leapfrog", 10, 1000, 17)]
    for i, (kind, integrator, d, n, C) in enumerate(edges):
        X, Y = _data(kind, n, d, seed=20 + i)
        theta, m = _state(C, d, seed=30 + i)
        XT, Yc, th, mm = cu(X.T), cu(Y), cu(theta), cu(m)
        kw = dict(kind=kind, weights=cu(rng.uniform(0.5, 2.0, n)),
                  offsets=cu(0.1 * rng.standard_normal(n)), prior_prec=1.3)
        _, g = _grad_at(XT, Yc, th, **kw)
        model = dict(kw)
        kw.update(n_leaps=4, integrator=integrator)
        atol = 1e-3 * max(1.0, n / 1000)
        out = gk.glm_leapfrogs(XT, Yc, th, mm, g, 0.02, **kw)
        ref = gk.glm_leapfrogs_ref(XT, Yc, th, mm, g, 0.02, **kw)
        for a, b in zip(out[:2], ref[:2]):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=atol)
        _held_at_own_theta(XT, Yc, out, atol, **model)
    # the step and multistep kernels on the same tiles, a ragged last tile
    # (C 37, d 6): the step on injected noise, the multistep chain by chain
    # on its own Philox draws replayed, against successive plain steps, at
    # a step size that both accepts and rejects
    X, Y = _data("logistic", 300, 6, seed=17)
    theta, m = _state(37, 6, seed=18)
    XT, Yc, th, mm = cu(X.T), cu(Y), cu(theta), cu(m)
    lp, g = _grad_at(XT, Yc, th)
    logu = cu(np.log(np.random.default_rng(19).random((37, 1))))
    eps, kw = 0.15, dict(n_leaps=5)
    sk = gk.glm_step(XT, Yc, th, g, lp[:, None], mm, logu, eps, **kw)
    sr = gk.glm_step_ref(XT, Yc, th, g, lp[:, None], mm, logu, eps, **kw)
    assert 0 < sr[3].sum() < 37, "want a mix of accepts and rejects"
    for a, b in zip(sk, sr):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-3)
    k = 6
    gen = lambda: torch.Generator(device="cuda").manual_seed(4)  # noqa: E731
    out = gk.glm_multistep(XT, Yc, th, eps, k_trans=k, generator=gen(), **kw)
    z, lu = gk.glm_multistep_draws(gk._seed(gen()), 37, 6, k, device="cuda")
    ts, gs, lps, n_acc = th, g, lp[:, None], 0.0
    for t in range(k):
        ts, gs, lps, acc = gk.glm_step_ref(XT, Yc, ts, gs, lps, z[t],
                                           lu[t][:, None], eps, **kw)
        n_acc = n_acc + acc[:, 0]
    assert 0 < float(n_acc.sum()) < 37 * k, "want accepts and rejects"
    # accept counts: the rate n / k rounds apart in the kernel and here
    torch.testing.assert_close((out[3] * k).round(), n_acc, rtol=0, atol=0)
    torch.testing.assert_close(out[0], ts, rtol=1e-4, atol=1e-3)
    _held_at_own_theta(XT, Yc, out[:1] + (None,) + out[1:3], 1e-3)


def test_rows_kernel_matches_plain_on_card():
    """Kernel 3b (glm_multistep_rows) chain by chain on its own Philox
    draws on a card (skips without one; chip_smoke.py holds it at the
    paths' shapes and its edges): the draws replayed by
    glm_multistep_draws from absolute transition i0 and fed to the plain
    version, with the scalar prior and a (d,) prior row, on a ragged last
    tile (C 333, d 6), at a step that both accepts and rejects.  The nleaps
    rows equal exactly; at most one chain leaves the plain version's accept
    path (a decision within rounding of a tie: the replayed normals lie
    within a few float32 ulps of the kernel's); on the others theta is held
    to rtol 1e-4 and atol 1e-4, and g and lp to the plain (lp, g) at the
    kernel's own theta; a second launch repeats bitwise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    cu = lambda a: _t(a).cuda().contiguous()  # noqa: E731
    C, d, k, i0, eps, T, max_leaps = 333, 6, 6, 41, 0.15, 0.6, 5
    X, Y = _data("logistic", 300, d, seed=23)
    theta, _ = _state(C, d, seed=24)
    XT, Yc, th = cu(X.T), cu(Y), cu(theta)
    for prior in (1.3, cu(np.random.default_rng(25).uniform(0.5, 2.0, d))):
        gen = lambda: torch.Generator(device="cuda").manual_seed(5)  # noqa: E731
        out, out2 = (gk.glm_multistep_rows(
            XT, Yc, th, eps, T, i0, max_leaps, k_trans=k, generator=gen(),
            prior_prec=prior) for _ in range(2))
        assert all(torch.equal(a, b) for a, b in zip(out[:3], out2[:3]))
        assert all(torch.equal(out[3][key], out2[3][key]) for key in out[3])
        z, lu = gk.glm_multistep_draws(gk._seed(gen()), C, d, k, i0=i0,
                                       device="cuda")
        ref = gk.glm_multistep_rows_ref(XT, Yc, th, eps, T, i0, max_leaps,
                                        k_trans=k, noise=(z, lu),
                                        prior_prec=prior)
        assert torch.equal(out[3]["nleaps"], ref[3]["nleaps"])
        assert 0 < float(ref[3]["accept"].float().mean()) < 1
        same = ((out[3]["accept"] == ref[3]["accept"]).all(0)
                & ((out[0] - ref[0]).abs().amax(-1) <= 1e-3))
        assert int((~same).sum()) <= 1, int((~same).sum())
        torch.testing.assert_close(out[0][same], ref[0][same], rtol=1e-4,
                                   atol=1e-4)
        lp, g = gk.glm_funcs(XT, Yc, None, None, prior, "logistic")[1](
            out[0])
        torch.testing.assert_close(out[1], g, rtol=1e-4, atol=1e-3)
        torch.testing.assert_close(out[2], lp, rtol=1e-4, atol=1e-3)


def _held_at_own_theta(XT, Y, out, atol, **kw):
    """A kernel's g and lp (out[2], out[3]) against the plain (lp, g) at the
    kernel's own theta (out[0]): over a trajectory the posterior's stiff
    directions amplify theta's rounding into g and lp (a Hessian of n x
    |x|^2, some 3000 for the linear case at n 3000, turns 1e-6 of theta
    into 3e-3 of g), so these are held where they were computed."""
    lp, g = _grad_at(XT, Y, out[0], **kw)
    torch.testing.assert_close(out[2], g, rtol=1e-4, atol=atol)
    torch.testing.assert_close(out[3], lp, rtol=1e-4, atol=atol)


def test_tile_log1p_polynomial_within_two_ulps():
    """The chain-tile kernels' log1p on [0, 1] (csrc/glm_tile.cuh
    log1p_01: Horner's rule on the coefficients as written there, one
    rounding per fused multiply-add) stays within 2 float32 ulps of
    log1p over the whole interval, as the logistic link's e = exp(-|z|)
    needs."""
    import pathlib
    import re

    src = (pathlib.Path(gk.__file__).parent.parent / "csrc" /
           "glm_tile.cuh").read_text()
    body = src[src.index("float log1p_01(float e)"):]
    body = body[:body.index("return p * e;")]
    coef = [float(c) for c in re.findall(r"(-?\d\.\d+e[+-]\d+)f", body)]
    assert len(coef) == 10 and coef[-1] == 1.0
    x = np.linspace(0.0, 1.0, 200_001).astype(np.float32)
    p = np.full(x.shape, coef[0], np.float64)
    for c in coef[1:]:  # fmaf: exact product and sum, one float32 rounding
        p = (p * x.astype(np.float64) + np.float32(c)).astype(np.float32)
        p = p.astype(np.float64)
    y = (p * x).astype(np.float32).astype(np.float64)
    ref = np.log1p(x.astype(np.float64))
    ulp = np.spacing(np.abs(ref).astype(np.float32)).astype(np.float64)
    assert y[0] == 0.0
    assert np.max(np.abs(y - ref)[1:] / ulp[1:]) < 2.0
