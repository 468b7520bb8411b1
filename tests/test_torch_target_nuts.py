"""The port's target-mode exact-NUTS transition (kernel 8b,
``mcmc_jl_tpu_torch/ops/nuts_kernels.py`` ``target_nuts_transition``) against
the JAX package's ``_target_transition_inner`` (``pallas_nuts.py``, the
Pallas kernel in target mode) run in interpret mode on the CPU, on the same
numpy-seeded inputs and pre-drawn noise; its driver ``_nuts_target_run``
against JAX's statistically; the ``epsilon`` rows under a step row.

On the CPU the wrapper runs its plain version (the lockstep ``_transition``
with the target's ``torch.func`` gradient); the CUDA kernel is held against
that on the card (``test_target_nuts_matches_plain_on_card`` here, and
chip_smoke.py).  JAX's inputs are padded to 128 lanes (the noise columns
as well) and unpadded after.  Both sides run in float32 (the suite turns
on x64).  Tolerances: equal ``ndoublings`` and ``diverging`` on every
chain; theta and the gradient within 1e-5 absolute, lp within 1e-4 (sums
of a few float32 terms in another order); statistical gates |z| < 5.  The
tests that run the JAX package import it themselves, so that the card
test runs where JAX is not installed."""
import math
import pathlib

import numpy as np
import pytest
import torch

from mcmc_jl_tpu_torch.models import distributions as td
from mcmc_jl_tpu_torch.ops import nuts_kernels as nk
from mcmc_jl_tpu_torch.ops import target_kernels as tk

torch.set_num_threads(1)
Z_MAX = 5.0


def _jax_block(dists, safes):
    """A JAX logp_block with coordinate j ~ dists[j] (lanes past d zero),
    in theta's dtype (some logpdfs promote to float64 under x64)."""
    import jax
    import jax.numpy as jnp

    def logp_block(theta):
        col = jax.lax.broadcasted_iota(jnp.int32, theta.shape, 1)
        total = jnp.zeros((theta.shape[0], 1), theta.dtype)
        for j, (dist, safe) in enumerate(zip(dists, safes)):
            live = col == j
            x = jnp.where(live, theta, jnp.asarray(safe, theta.dtype))
            lp = dist.logpdf(x).astype(theta.dtype)
            total = total + jnp.sum(jnp.where(live, lp, 0.0), axis=1,
                                    keepdims=True)
        return total

    return logp_block


def _port_target(spec):
    """The port's target for a list of (name, params, safe)."""
    return tk.coordwise_logp([getattr(td, n)(*p) for n, p, _ in spec],
                             len(spec))


def _targets(spec):
    """(JAX logp_block, port target) for a list of (name, params, safe)."""
    from mcmc_jl_tpu.models import distributions as jd

    return (_jax_block([getattr(jd, n)(*p) for n, p, _ in spec],
                       [s for _, _, s in spec]),
            _port_target(spec))


def _pad_cols(a, width):
    return np.pad(a, ((0, 0), (0, width - a.shape[1]))).astype(np.float32)


THREE = [("Normal", (0.5, 2.0), 0.5), ("Gamma", (3.0, 0.2), 0.5),
         ("Beta", (2.0, 3.0), 0.5)]
MIXED = [("Normal", (0.0, 1.0), 0.0), ("Uniform", (-1.0, 3.0), 1.0),
         ("Exponential", (2.0,), 1.0), ("Gamma", (2.0, 1.5), 1.0),
         ("Weibull", (1.5, 2.0), 1.0), ("Cauchy", (0.0, 1.0), 0.0),
         ("LogNormal", (0.0, 0.5), 1.0), ("Beta", (2.0, 3.0), 0.5),
         ("Laplace", (0.0, 1.0), 0.0), ("TDist", (5.0,), 0.0)]
CENTER = {"Normal": 0.5, "Uniform": 1.0, "Exponential": 2.0, "Gamma": 0.6,
          "Weibull": 1.8, "Cauchy": 0.0, "LogNormal": 1.1, "Beta": 0.4,
          "Laplace": 0.0, "TDist": 0.0}
SPREAD = {"Normal": 2.0, "Uniform": 1.0, "Exponential": 2.0, "Gamma": 0.35,
          "Weibull": 1.0, "Cauchy": 1.0, "LogNormal": 0.5, "Beta": 0.2,
          "Laplace": 1.0, "TDist": 1.0}

CASES = [
    # id, spec, multinomial, step (fraction of each coordinate's spread)
    (f"{mode}_{depth}_{step}", THREE, mode == "multinomial",
     {"shallow": 0.3, "deep": 0.02}[depth], step == "row")
    for mode in ("slice", "multinomial") for depth in ("shallow", "deep")
    for step in ("scalar", "row")
] + [("mixed_ten_families_row", MIXED, False, 0.1, True),
     ("out_of_support_start", THREE, False, 0.1, False)]


def _inputs(spec, step, row, C, md, seed):
    rng = np.random.default_rng(seed)
    d = len(spec)
    center = np.array([CENTER[n] for n, _, _ in spec])
    spread = np.array([SPREAD[n] for n, _, _ in spec])
    theta = (center + 0.3 * spread * rng.standard_normal((C, d)))
    theta = np.where([n in ("Gamma", "Exponential", "Weibull", "LogNormal")
                      for n, _, _ in spec], np.abs(theta) + 0.05, theta)
    theta = np.where([n == "Beta" for n, _, _ in spec],
                     np.clip(theta, 0.05, 0.95), theta).astype(np.float32)
    eps = (step * spread).astype(np.float32) if row else \
        np.float32(step * float(spread.min()))
    noise = (rng.standard_normal((C, d)).astype(np.float32),
             np.log(rng.random(C)).astype(np.float32),
             np.where(rng.random((C, md)) < 0.5, 1.0, -1.0).astype(np.float32),
             rng.random((C, md)).astype(np.float32),
             rng.random((C, 1 << md)).astype(np.float32))
    return theta, eps, noise


def _jax_transition(jblock, theta, eps, noise, md, multinomial):
    """JAX's _target_transition_inner (interpret) on the padded inputs;
    returns (theta, grad, lp, nd, div) unpadded, and (lp0, g0)."""
    import jax
    import jax.numpy as jnp

    from mcmc_jl_tpu.ops.pallas_glm import LANE, pad_chains
    from mcmc_jl_tpu.ops.pallas_nuts import _target_transition_inner as j_trans

    f32 = jnp.float32
    C, d = theta.shape
    m0, logu, dirn, merge, leaf = noise
    th_j = pad_chains(jnp.asarray(theta, f32), LANE)
    lp_j = jblock(th_j)[:, 0]
    g_j = jax.grad(lambda th: jnp.sum(jblock(th)))(th_j)
    eps_j = (jnp.asarray(_pad_cols(np.asarray(eps)[None], LANE)[0])
             if np.ndim(eps) else f32(eps))
    out = j_trans(th_j, lp_j, g_j, eps_j,
                  pad_chains(jnp.asarray(m0, f32), LANE), jnp.asarray(logu),
                  jnp.asarray(_pad_cols(dirn, LANE)),
                  jnp.asarray(_pad_cols(merge, LANE)),
                  jnp.asarray(_pad_cols(leaf, LANE)), logp_block=jblock,
                  maxdoublings=md, block_chains=C, interpret=True,
                  multinomial=multinomial)
    th, g, lp, nd, dv = (np.asarray(a) for a in out)
    return ((th[:, :d], g[:, :d], lp, nd, dv),
            (np.asarray(lp_j), np.asarray(g_j)[:, :d]))


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_transition_matches_pallas_interpret(case):
    """The plain version and the Pallas kernel on the same inputs and noise,
    chain for chain."""
    label, spec, multinomial, step, row = case
    C, md = 8, 4
    jblock, target = _targets(spec)
    theta, eps, noise = _inputs(spec, step, row, C, md, seed=len(label))
    if label == "out_of_support_start":
        theta[:2, 1] = -0.3  # Gamma coordinate out of support: lp -inf
    want, (lp0, g0) = _jax_transition(jblock, theta, eps, noise, md,
                                      multinomial)
    th_t = torch.as_tensor(theta)
    lp_t, g_t = tk.target_funcs(target)[1](th_t)
    np.testing.assert_allclose(lp_t.numpy(), lp0, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(g_t.numpy(), g0, rtol=1e-5, atol=1e-5)
    nk.reset_counts()
    got = nk.target_nuts_transition(
        target, th_t, torch.tensor(lp0), torch.tensor(g0),
        torch.as_tensor(eps) if row else float(eps),
        *(torch.as_tensor(a) for a in noise), maxdoublings=md,
        multinomial=multinomial)
    assert nk.PLAIN_CALLS["target_nuts_transition"] == 1
    assert not any(nk.LAUNCHES.values())
    th, g, lp, nd, dv = (a.numpy() for a in got)
    assert nd.dtype == np.int32 and dv.dtype == np.bool_
    np.testing.assert_array_equal(nd, want[3])
    np.testing.assert_array_equal(dv, want[4])
    np.testing.assert_allclose(th, want[0], rtol=0, atol=1e-5)
    np.testing.assert_allclose(g, want[1], rtol=0, atol=1e-5)
    np.testing.assert_allclose(lp, want[2], rtol=0, atol=1e-4)
    if "_deep_" in label:
        assert nd.max() == md, nd
    if label == "out_of_support_start":
        assert dv[:2].all() and not np.isfinite(lp0[:2]).any()


def test_wrapper_refuses_what_the_kernel_cannot_take():
    """What would raise before a launch on a CUDA tensor, checked on the
    shapes alone: too deep a tree, a noise buffer of the wrong shape."""
    C, d, md = 4, 3, 3
    target = tk.coordwise_logp(td.Normal(0.0, 1.0), d)
    with pytest.raises(ValueError, match="maxdoublings"):
        nk._check_md(nk.MAX_DOUBLINGS + 1)
    with pytest.raises(ValueError, match="leaf_u"):
        nk._check_noise("target_nuts_transition", C, md, torch.device("cpu"),
                        leaf_u=torch.zeros((C, 1 << (md + 1))))
    with pytest.raises(ValueError, match="no kernel rows"):
        tk.kernel_args("target_nuts_transition",
                       tk.coordwise_logp(lambda x: -x * x, d),
                       torch.zeros((C, d)))
    assert target.has_rows


@pytest.mark.parametrize("row", [False, True], ids=["scalar", "row"])
def test_run_matches_jax_statistically(row):
    """_nuts_target_run (the plain version once per transition, noise from a
    torch generator) against JAX's _nuts_target_run (interpret mode) on
    Normal(0.5, 2) x Gamma(3, 0.2) from one start: the final states'
    per-coordinate means and second moments within |z| < 5 of each other,
    and of the exact moments; the epsilon rows report the scalar step, or
    the row's first entry (a property of the JAX package kept as it is)."""
    import jax
    import jax.numpy as jnp

    from mcmc_jl_tpu.ops.pallas_glm import LANE, pad_chains
    from mcmc_jl_tpu.ops.pallas_nuts import _nuts_target_run as j_run

    f32 = jnp.float32
    spec = [("Normal", (0.5, 2.0), 0.5), ("Gamma", (3.0, 0.2), 0.5)]
    jblock, target = _targets(spec)
    d, md, steps = 2, 5, 25
    s = np.array([2.0, 0.35])
    eps = (0.3 * s).astype(np.float32) if row else np.float32(0.1)
    x0 = np.array([0.5, 0.6], np.float32)
    Ct, Cj = 512, 64
    gen = torch.Generator().manual_seed(3)
    nk.reset_counts()
    (th, _, _), infos = nk._nuts_target_run(
        target, torch.as_tensor(np.tile(x0, (Ct, 1))),
        torch.as_tensor(eps) if row else float(eps), gen, steps=steps,
        maxdoublings=md)
    assert nk.PLAIN_CALLS["target_nuts_transition"] == steps
    (jth, _, _), jinf = j_run(
        jblock, pad_chains(jnp.asarray(np.tile(x0, (Cj, 1))), LANE),
        jnp.asarray(_pad_cols(np.asarray(eps)[None], LANE)[0]) if row
        else f32(eps), jax.random.PRNGKey(4), d=d, steps=steps,
        maxdoublings=md, block_chains=Cj, interpret=True)
    a, b = th.numpy().astype(np.float64), np.asarray(jth)[:, :d]
    exact = np.array([[0.5, 0.6], [0.5 ** 2 + 4.0, 0.6 ** 2 + 3 * 0.04]])
    for k, (x, y) in enumerate(((a, b), (a * a, b * b))):
        se = np.sqrt(x.var(0) / len(x) + y.var(0) / len(y))
        assert np.all(np.abs(x.mean(0) - y.mean(0)) / se < Z_MAX), k
        assert np.all(np.abs(x.mean(0) - exact[k])
                      / (x.std(0) / math.sqrt(len(x))) < Z_MAX), k
    assert set(infos) == set(jinf)
    assert infos["ndoublings"].shape == (steps, Ct)
    want = np.float32(eps[0] if row else eps)
    assert np.all(infos["epsilon"].numpy() == want)
    assert np.all(np.asarray(jinf["epsilon"]) == want)
    acc = float(infos["accept"].double().mean())
    jacc = float(np.mean(np.asarray(jinf["accept"])))
    assert abs(acc - jacc) < 0.1, (acc, jacc)


def test_target_nuts_layout_by_d():
    """Kernel 8b's layout is decided up front from d alone: one chain per
    lane up to LANE_D_MAX, one warp per chain above; the CUDA source
    (the lane layout's header, which target_nuts.cu includes) draws the
    line at the same d (its library also reports it when it
    loads, and load_target_kernels refuses a mismatch)."""
    assert [nk.target_nuts_layout(d) for d in (1, 8, 10, 16, 32, 33, 1000)] \
        == ["lane"] * 5 + ["warp"] * 2
    src = (pathlib.Path(nk.__file__).parent.parent / "csrc" /
           "target_lane.cuh").read_text()
    assert f"constexpr int kLaneDMax = {nk.LANE_D_MAX};" in src


def test_target_nuts_matches_plain_on_card():
    """Kernel 8b against its plain version on injected noise on a card
    (skips without one; chip_smoke.py runs the same checks at the path's
    shape and its edges): the ten-family target at d 10 and 16 (one chain
    per lane) and d 40 (one warp per chain), slice and multinomial, a
    scalar step and a step row, md 1, 6 and 10, a ragged last group of
    32 chains (C 397) and 20,000 chains.  Equal ndoublings and diverging
    and the chosen theta within 1e-3 (1 + |theta|) on at least 99.5% of
    the chains (a slice, u-turn or reservoir decision within rounding of
    a tie may go the other way: the kernel sums lp and the dots in
    another order), g and lp within the same on those, and a bitwise
    repeat."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    tol = 1e-3
    cases = [  # spec, multinomial, step, row, md, C
        (MIXED, False, 0.1, False, 6, 397), (MIXED, True, 0.1, True, 6, 397),
        (MIXED, False, 0.3, True, 1, 397),
        ((MIXED * 2)[:16], False, 0.02, True, 10, 397),
        (MIXED, True, 0.1, True, 6, 20_000),
        (MIXED * 4, False, 0.1, True, 6, 397),
        (MIXED * 4, True, 0.1, False, 6, 397)]
    for i, (spec, multinomial, step, row, md, C) in enumerate(cases):
        target = _port_target(spec)
        theta, eps, noise = _inputs(spec, step, row, C, md, seed=40 + i)
        cu = lambda a: torch.as_tensor(a).cuda().contiguous()  # noqa: E731
        th = cu(theta)
        lp, g = tk.target_funcs(target)[1](th)
        args = (target, th, lp.contiguous(), g.contiguous(),
                cu(eps) if row else float(eps), *(cu(a) for a in noise))
        kw = dict(maxdoublings=md, multinomial=multinomial)
        out, out2 = (nk.target_nuts_transition(*args, **kw) for _ in range(2))
        ref = nk.target_nuts_transition_ref(*args, **kw)
        assert all(torch.equal(a, b) for a, b in zip(out, out2)), i

        def near(a, b):
            return (a - b).abs() <= tol * (1 + b.abs())

        same = ((out[3] == ref[3]) & (out[4] == ref[4])
                & near(out[0], ref[0]).all(1))
        assert float(same.float().mean()) >= 0.995, (i, int((~same).sum()))
        assert near(out[1][same], ref[1][same]).all(), i
        fin = torch.isfinite(ref[2])
        assert torch.where(fin, near(out[2], ref[2]),
                           out[2] == ref[2])[same].all(), i
