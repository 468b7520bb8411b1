"""The port's exact-NUTS kernel module (ops/nuts_kernels.py) against the JAX
package's Pallas kernels (ops/pallas_nuts.py) on the CPU.

The plain transition takes the same pre-drawn noise as JAX's
``glm_nuts_transition(interpret=True)``, so the two must take the same
discrete path on every chain and agree to float32 rounding.  The multistep
kernel's plain version draws its own noise and is held statistically against
JAX's per-transition driver.  Both sides compute in float32 (the suite turns
on x64, so every JAX input is pinned to float32)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcmc_jl_tpu.ops.pallas_glm import LANE, pad_chains, pad_design
from mcmc_jl_tpu.ops.pallas_nuts import _nuts_run as jax_nuts_run
from mcmc_jl_tpu.ops.pallas_nuts import glm_nuts_transition as jax_transition
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
    fold) raises naming the ROADMAP; the per-transition driver runs the plain
    version on the CPU and keeps the info protocol."""
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
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        nk.glm_nuts_transition(XT, Yt, th, lp, g, 0.1, *noise, maxdoublings=3,
                               prior_prec=torch.eye(d))
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
