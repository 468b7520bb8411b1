"""The port's large-N GLM path (mcmc_jl_tpu_torch/ops/glm_bign.py) against
the JAX package's (mcmc_jl_tpu/ops/pallas_glm_bign.py): the N-tiled
(logp, grad) evaluation against the Pallas kernel in interpret mode on the
same numpy inputs, the tiled HMC driver against the whole-trajectory driver
and against the JAX package's tiled driver, and the routing of run(...,
chains=N) above the threshold.

On the CPU the wrapper runs its plain version; the CUDA kernel itself is
held against it on the card (``test_tiled_kernel_matches_plain_on_card``
here, and chip_smoke.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcmc_jl_tpu.ops.pallas_glm_bign import glm_logp_grad_tiled as jax_tiled
from mcmc_jl_tpu.ops.pallas_glm_bign import pad_design_tiled
from mcmc_jl_tpu.ops.pallas_glm_bign import run_glm_hmc_bign as jax_run_bign
import mcmc_jl_tpu_torch as mt
from mcmc_jl_tpu_torch.ops import glm_bign
from mcmc_jl_tpu_torch.ops import glm_kernels as gk
from mcmc_jl_tpu_torch.ops.glm_hmc import _run

torch.set_num_threads(1)

LINKS = ["logistic", "linear", "poisson", "probit"]


def _data(kind, n=150, d=5, seed=0):
    rng = np.random.default_rng(seed)
    X = np.column_stack([np.ones(n), rng.standard_normal((n, d - 1))])
    if kind == "poisson":
        X = X * 0.3
    z = X @ (0.5 * rng.standard_normal(d))
    if kind == "linear":
        Y = z + rng.standard_normal(n)
    elif kind == "poisson":
        Y = rng.poisson(np.exp(z)).astype(np.float64)
    else:
        Y = (rng.random(n) < 1.0 / (1.0 + np.exp(-z))).astype(np.float64)
    return X.astype(np.float32), Y.astype(np.float32)


def _t(a):
    return None if a is None else torch.as_tensor(np.asarray(a, np.float32))


@pytest.mark.parametrize("extras", [False, True], ids=["plain", "w_o_vec"])
@pytest.mark.parametrize("kind", LINKS)
def test_tiled_ref_matches_pallas(kind, extras):
    """The tiled (logp, grad) == the Pallas _grad_kernel (interpret, tile 64,
    so N = 150 is not a multiple of the tile) on the same inputs, with
    weights, offsets and a (d,) prior row in the second case."""
    n, d, C = 150, 5, 8
    X, Y = _data(kind, n, d, seed=1)
    rng = np.random.default_rng(2)
    theta = (0.3 * rng.standard_normal((C, d))).astype(np.float32)
    w = o = None
    lam = 1.0
    if extras:
        w = rng.uniform(0.5, 2.0, n).astype(np.float32)
        o = (0.2 * rng.standard_normal(n)).astype(np.float32)
        lam = np.array([1.0, 2.0, 0.5, 3.0, 1.5], np.float32)

    XT, Y2, W, d_pad, _ = pad_design_tiled(X, Y, weights=w, tile_n=64)
    jkw = dict(tile_n=64, block_chains=C, interpret=True, kind=kind,
               weights=W, _use_w=W is not None)
    if extras:
        O = np.zeros((1, XT.shape[1]), np.float32)
        O[0, :n] = o
        jkw.update(offsets=jnp.asarray(O), _use_o=True, _unit_prior=False,
                   _vec_prior=True, prior_prec=np.concatenate(
                       [lam, np.ones(d_pad - d, np.float32)]).reshape(1, -1))
    th_p = jnp.asarray(np.pad(theta, ((0, 0), (0, d_pad - d))))
    jlp, jg = jax_tiled(XT, Y2, th_p, **jkw)

    gk.reset_counts()
    glm_bign.reset_counts()
    lp, g = glm_bign.glm_logp_grad_tiled(
        _t(X.T).contiguous(), _t(Y), _t(theta), kind=kind, weights=_t(w),
        offsets=_t(o), prior_prec=_t(lam) if extras else lam)
    assert glm_bign.PLAIN_CALLS == {"glm_logp_grad_tiled": 1}
    assert not any(glm_bign.LAUNCHES.values())
    # the JAX kernels use the erf-free log_ndtr (abs err < 4e-6 per
    # observation); the port the exact one
    extra = 4e-6 if kind == "probit" else 0.0
    np.testing.assert_allclose(lp.numpy(), np.asarray(jlp), rtol=2e-5,
                               atol=n * extra)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg)[:, :d], rtol=1e-4,
                               atol=1e-4 + n * extra)
    assert np.all(np.asarray(jg)[:, d:] == 0.0)


@pytest.mark.parametrize("N,C", [(1, 1), (150, 8), (1023, 129), (16385, 512),
                                 (100_000, 4096), (1_000_000, 1024),
                                 (3_000_000, 64)])
def test_splits_cover_every_observation(N, C):
    """The kernel's grid splits N into non-empty contiguous ranges that
    cover it (csrc/glm_bign.cu refuses anything else), enough of them to
    fill the card at small C but no more CTAs than SPLIT_CTAS (two waves:
    a third wave of a few CTAs costs nearly a whole one), and none shorter
    than SPLIT_MIN_ROWS unless N itself is."""
    s = glm_bign.splits_for(N, C)
    rows = -(-N // s)
    assert 1 <= s <= 65535
    assert -(-N // rows) == s and (s - 1) * rows < N <= s * rows
    blocks = -(-C // 128)
    assert blocks * s <= max(glm_bign.SPLIT_CTAS, blocks)
    if N >= glm_bign.SPLIT_MIN_ROWS * 2:
        assert rows >= glm_bign.SPLIT_MIN_ROWS // 2
        assert blocks * s >= min(glm_bign.SPLIT_CTAS - blocks + 1,
                                 blocks * (N // glm_bign.SPLIT_MIN_ROWS))


@pytest.mark.parametrize("integrator", ["leapfrog", "2stage"])
def test_run_bign_matches_run(integrator):
    """_run_bign and the whole-trajectory driver _run draw the same numbers
    from one generator in the same order: the same chains up to float32
    rounding of the gradients, the same accept decisions."""
    X, Y = _data("logistic", n=120, d=4, seed=3)
    XT, Yt = _t(X.T).contiguous(), _t(Y)
    theta0 = torch.zeros(8, 4)
    kw = dict(steps=40, n_leaps=4, kind="logistic", lam=1.3, collect=True,
              integrator=integrator)
    (a, lpa, ga), ia = glm_bign._run_bign(
        XT, Yt, theta0, 0.15, torch.Generator().manual_seed(5), **kw)
    (b, lpb, gb), ib = _run(XT, Yt, theta0, 0.15,
                            torch.Generator().manual_seed(5), **kw)
    torch.testing.assert_close(a, b, rtol=0, atol=1e-5)
    torch.testing.assert_close(ia["ppars"], ib["ppars"], rtol=0, atol=1e-5)
    assert torch.equal(ia["accept"], ib["accept"])
    assert 0.3 < ia["accept"].float().mean() < 1.0
    torch.testing.assert_close(lpa, lpb, rtol=1e-5, atol=1e-4)


def test_run_glm_hmc_bign_matches_jax():
    """The port's tiled driver and the JAX package's (interpret mode, tile
    64) sample the same posterior: pooled final positions within 6 standard
    errors + 0.1 (the gate of tests/test_bign.py)."""
    X, Y = _data("logistic", n=200, d=4, seed=4)
    kw = dict(n_chains=16, steps=300, n_leaps=5, eps=0.1)
    th_j, _ = jax_run_bign(X, Y, seed=0, tile_n=64, interpret=True, **kw)
    th_t, infos = glm_bign.run_glm_hmc_bign(X, Y, seed=0, device="cpu",
                                            collect=True, **kw)
    a, b = th_t.double().numpy(), np.asarray(th_j, np.float64)
    se = a.std(0) / np.sqrt(len(a)) + b.std(0) / np.sqrt(len(b))
    assert np.all(np.abs(a.mean(0) - b.mean(0)) < 6 * se + 0.1), (
        a.mean(0), b.mean(0))
    assert set(infos) == {"plogtarget", "accept", "ppars", "pgrads"}
    assert infos["ppars"].shape == (300, 16, 4)
    assert float(infos["accept"].float().mean()) > 0.5


def test_bign_routing_through_run(monkeypatch):
    """N above the threshold (lowered to 100, as tests/test_bign.py does)
    routes run(chains=, fused=True) through the tiled driver: the tiled
    evaluation's plain version runs once per drift plus once at the start,
    nothing else does; resume continues on the generic engine."""
    from mcmc_jl_tpu_torch.core.task import MCMCTask
    from mcmc_jl_tpu_torch.parallel import pchains

    monkeypatch.setattr(glm_bign, "BIGN_THRESHOLD", 100)
    X, Y = _data("logistic", n=150, d=4, seed=5)
    m = mt.model(glm=("logistic", X, Y), device="cpu")
    task = m * mt.HMC(5, 0.1) * mt.SerialMC(steps=300, burnin=100)
    assert pchains._route(MCMCTask(m, task.sampler, task.runner),
                          True) == "hmc"
    gk.reset_counts()
    glm_bign.reset_counts()
    chains = mt.run(task, chains=4, seed=0, fused=True)
    assert glm_bign.PLAIN_CALLS["glm_logp_grad_tiled"] == 300 * 5 + 1
    assert not any(gk.PLAIN_CALLS.values())
    assert not any({**gk.LAUNCHES, **glm_bign.LAUNCHES}.values())
    c0 = chains[0]
    assert c0.samples.shape == (200, 4)
    assert mt.acceptance(c0) > 40
    c1 = mt.resume(c0, steps=50)
    assert c1.task.pos == 350 and np.all(np.isfinite(c1.samples.values))
    # exact NUTS above the threshold stays on the generic engine
    nuts = MCMCTask(m, mt.NUTS(), task.runner)
    assert not pchains._route(nuts, True)


def test_tiled_kernel_matches_plain_on_card():
    """The CUDA kernel against its plain version on a card, and a bitwise
    repeat (skips without one; chip_smoke.py runs the same checks at the
    main paths' shapes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    X, Y = _data("logistic", n=50_000, d=10, seed=6)
    cu = lambda a: _t(a).cuda().contiguous()  # noqa: E731
    XT, Yc = cu(X.T), cu(Y)
    th = cu(0.05 * np.random.default_rng(7).standard_normal((300, 10)))
    lp, g = glm_bign.glm_logp_grad_tiled(XT, Yc, th)
    lp2, g2 = glm_bign.glm_logp_grad_tiled(XT, Yc, th)
    lpr, gr = glm_bign.glm_logp_grad_tiled_ref(XT, Yc, th)
    assert torch.equal(lp, lp2) and torch.equal(g, g2)
    torch.testing.assert_close(lp, lpr, rtol=1e-5, atol=1e-2)
    torch.testing.assert_close(g, gr, rtol=1e-4, atol=5e-2)
    # the chain-tile kernel at its edges: d = 1, 10, 16 and 32 (tile bounds
    # 8, 16, 32), ragged last tiles of chains (128 per block, 16 per warp)
    # and of rows (128 per tile, splits of N), every link with weights,
    # offsets and a (d,) prior row; bitwise repeats
    rng = np.random.default_rng(8)
    edges = [("logistic", 1, 20_001, 300), ("linear", 10, 5000, 129),
             ("poisson", 32, 12_345, 40), ("probit", 16, 3000, 513)]
    for i, (kind, d, n, C) in enumerate(edges):
        X, Y = _data(kind, n, d, seed=40 + i)
        kw = dict(kind=kind, weights=cu(rng.uniform(0.5, 2.0, n)),
                  offsets=cu(0.1 * rng.standard_normal(n)),
                  prior_prec=cu(rng.uniform(0.5, 2.0, d)))
        th = cu(0.05 * rng.standard_normal((C, d)))
        XT, Yc = cu(X.T), cu(Y)
        lp, g = glm_bign.glm_logp_grad_tiled(XT, Yc, th, **kw)
        lp2, g2 = glm_bign.glm_logp_grad_tiled(XT, Yc, th, **kw)
        lpr, gr = glm_bign.glm_logp_grad_tiled_ref(XT, Yc, th, **kw)
        assert torch.equal(lp, lp2) and torch.equal(g, g2)
        torch.testing.assert_close(lp, lpr, rtol=1e-5, atol=1e-2)
        torch.testing.assert_close(g, gr, rtol=1e-4, atol=5e-2)
