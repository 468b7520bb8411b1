"""The port's cross-chain diagnostics (mcmc_jl_tpu_torch/stats/
multichain.py) against the JAX package's on seeded float64 blocks, to
1e-10: split, unsplit and rank-normalized R-hat, pooled ESS and the
per-parameter report; and the inputs the port takes (a run_chains infos
dict, a tensor)."""
import numpy as np
import pytest
import torch

from mcmc_jl_tpu.stats import multichain as jmc
import mcmc_jl_tpu_torch as mt
from mcmc_jl_tpu_torch.stats import multichain as tmc


def _block(n, m, d, seed, ar=0.6):
    """(n, m, d) AR(1) chains with per-chain offsets and a heavy-tailed
    coordinate, float64."""
    rng = np.random.default_rng(seed)
    e = rng.standard_normal((n, m, d))
    e[..., -1] = rng.standard_t(3, (n, m))
    x = np.empty_like(e)
    x[0] = e[0]
    for t in range(1, n):
        x[t] = ar * x[t - 1] + e[t]
    return x + 0.3 * rng.standard_normal((1, m, d))


SHAPES = [(200, 4, 3, 0), (101, 8, 2, 1), (64, 16, 5, 2)]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("how", [dict(), dict(method="rank"),
                                 dict(split=False)],
                         ids=["split", "rank", "unsplit"])
def test_rhat_matches_jax(shape, how):
    x = _block(*shape)
    np.testing.assert_allclose(tmc.rhat(x, **how), jmc.rhat(x, **how),
                               rtol=1e-10, atol=0)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_ess_pooled_matches_jax(shape):
    x = _block(*shape)
    np.testing.assert_allclose(tmc.ess_pooled(x), jmc.ess_pooled(x),
                               rtol=1e-10, atol=0)


def test_summarize_chains_matches_jax():
    x = _block(150, 6, 3, 5)
    names = ["a", "b", "c"]
    ours, theirs = tmc.summarize_chains(x, names), jmc.summarize_chains(x,
                                                                         names)
    assert list(ours) == names
    for name in names:
        assert set(ours[name]) == set(theirs[name])
        for k, v in theirs[name].items():
            assert ours[name][k] == pytest.approx(v, rel=1e-10), (name, k)
    assert list(tmc.summarize_chains(x)) == ["pars.1", "pars.2", "pars.3"]


def test_inputs_and_exports():
    """A run_chains infos dict and a tensor give the array's answers; the
    package exports the three functions; a wrong shape or method raises."""
    x = _block(80, 4, 2, 7)
    t = torch.as_tensor(x)
    np.testing.assert_array_equal(mt.rhat({"ppars": t}), tmc.rhat(x))
    np.testing.assert_array_equal(mt.ess_pooled(t), tmc.ess_pooled(x))
    assert mt.summarize_chains is tmc.summarize_chains
    with pytest.raises(ValueError, match="steps, chains, d"):
        tmc.rhat(x[0])
    with pytest.raises(ValueError, match="unknown method"):
        tmc.rhat(x, method="bulk")
    with pytest.raises(ValueError, match="implies split"):
        tmc.rhat(x, split=False, method="rank")
