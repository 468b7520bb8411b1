"""The matrix-prior variants of kernels 3b, 4, 8 and 9 (a (d, d) prior
``A = L'L``, the dense-metric fold) against their plain versions on a card;
skips without one (chip_smoke.py holds them at their dense paths' shapes).
The cases reach the tile bounds 8, 16 and 32 (d 3, 10 and 32), a ragged
last tile of 16 chains (C 17 and 300), rows resident and streamed through
shared memory (N 700 and 3000), and for kernel 4 a ragged last tile of
rows (N 20,001).  Kernels 3b and 9 draw inside: their plain versions take
the kernels' own Philox draws, replayed.  No JAX here, so the test runs on
the card's machine: ``python3 -m pytest --noconftest -q
tests/test_torch_dense_card.py``."""
import numpy as np
import pytest
import torch

from mcmc_jl_tpu_torch.ops import glm_bign as gb
from mcmc_jl_tpu_torch.ops import glm_kernels as gk
from mcmc_jl_tpu_torch.ops import nuts_kernels as nk
from mcmc_jl_tpu_torch.ops import target_kernels as tk


def _folded_glm(N, d, C, seed):
    """A logistic GLM folded by a random lower factor L: (X L)' on the card,
    Y, A = L'L and C chains in z near 0."""
    rng = np.random.default_rng(seed)
    X = np.column_stack([np.ones(N), rng.standard_normal((N, d - 1))]) * 0.3
    Y = (rng.random(N) < 1 / (1 + np.exp(-X @ rng.standard_normal(d))))
    L = np.tril(0.2 * rng.standard_normal((d, d)))
    L[np.arange(d), np.arange(d)] = rng.uniform(0.5, 1.5, d)
    cuda = lambda a: torch.as_tensor(a, dtype=torch.float32,  # noqa: E731
                                     device="cuda").contiguous()
    return (cuda((X @ L).T), cuda(Y.astype(float)), cuda(L.T @ L),
            cuda(0.3 * rng.standard_normal((C, d))))


def _held(out, want, same, scale, allowed):
    """At most ``allowed`` chains off the plain version's path; on the
    others theta, the gradient and lp to float32 rounding of N-term sums."""
    assert int((~same).sum()) <= allowed
    for a, b, atol in zip(out, want, (1e-4, 2e-3 * scale, 1e-3 * scale)):
        torch.testing.assert_close(a[same], b[same], rtol=1e-4, atol=atol)


CASES = [(700, 3, 17), (3000, 10, 300), (700, 32, 300), (3000, 32, 17)]


def test_mat_prior_kernels_match_plain_on_card():
    """Each variant launches (its ``_mat`` count rises by one a call), repeats
    bitwise, and agrees with its plain version: at least 99.5% of the chains
    on its accept or tree path (at most one of 17), and there theta, the
    gradient and lp within float32 rounding; kernel 4 against its plain
    version in float64 on the same inputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    for i, (N, d, C) in enumerate(CASES):
        XT, Y, A, th = _folded_glm(N, d, C, seed=100 + i)
        logp_grad = gk.glm_funcs(XT, Y, None, None, A, "logistic")[1]
        scale, allowed = max(1.0, N / 1000), max(1, int(0.005 * C))

        def gen():
            return torch.Generator(device="cuda").manual_seed(110 + i)

        # kernel 3b on its replayed draws
        k, eps, T, ml = 4, 0.1, 0.6, 8
        gk.reset_counts()
        out = gk.glm_multistep_rows(XT, Y, th, eps, T, 1, ml, k_trans=k,
                                    generator=gen(), prior_prec=A)
        again = gk.glm_multistep_rows(XT, Y, th, eps, T, 1, ml, k_trans=k,
                                      generator=gen(), prior_prec=A)
        assert gk.LAUNCHES["glm_multistep_rows_mat"] == 2
        assert gk.LAUNCHES["glm_multistep_rows"] == 0
        assert all(torch.equal(a, b) for a, b in zip(out[:3], again[:3]))
        noise = gk.glm_multistep_draws(gk._seed(gen()), C, d, k, i0=1,
                                       device="cuda")
        ref = gk.glm_multistep_rows_ref(XT, Y, th, eps, T, 1, ml, k_trans=k,
                                        noise=noise, prior_prec=A)
        lp_at, g_at = logp_grad(out[0])
        _held(out[:3], (ref[0], g_at, lp_at),
              (out[3]["accept"] == ref[3]["accept"]).all(0)
              & ((out[0] - ref[0]).abs().amax(-1) <= 1e-3), scale, allowed)

        # kernel 4 against float64
        gb.reset_counts()
        lp, g = gb.glm_logp_grad_tiled(XT, Y, th, prior_prec=A)
        assert gb.LAUNCHES == {**dict.fromkeys(gb.LAUNCHES, 0),
                               "glm_logp_grad_tiled_mat": 1}
        lp_r, g_r = gb.glm_logp_grad_tiled_ref(
            XT.double(), Y.double(), th.double(), prior_prec=A.double())
        torch.testing.assert_close(lp, lp_r.float(), rtol=1e-5,
                                   atol=1e-3 * scale)
        torch.testing.assert_close(g, g_r.float(), rtol=1e-4,
                                   atol=2e-3 * scale)

        # kernel 8 on pre-drawn noise, kernel 9 on its replayed draws
        md = 6
        lp0, g0 = logp_grad(th)
        rng = np.random.default_rng(120 + i)
        noise = tuple(torch.as_tensor(a, dtype=torch.float32, device="cuda")
                      for a in (rng.standard_normal((C, d)),
                                np.log(rng.random(C)),
                                np.where(rng.random((C, md)) < 0.5, 1.0,
                                         -1.0),
                                rng.random((C, md)),
                                rng.random((C, 1 << md))))
        kw = dict(maxdoublings=md, prior_prec=A)
        nk.reset_counts()
        out = nk.glm_nuts_transition(XT, Y, th, lp0, g0, 0.2, *noise, **kw)
        assert nk.LAUNCHES["glm_nuts_transition_mat"] == 1
        ref = nk.glm_nuts_transition_ref(XT, Y, th, lp0, g0, 0.2, *noise,
                                         **kw)
        _held(out[:3], ref[:3], (out[3] == ref[3]) & (out[4] == ref[4])
              & ((out[0] - ref[0]).abs().amax(-1) <= 1e-3), scale, allowed)
        k = 3
        out = nk.glm_nuts_multistep(XT, Y, th, lp0, g0, 0.2, gen(),
                                    k_trans=k, **kw)
        again = nk.glm_nuts_multistep(XT, Y, th, lp0, g0, 0.2, gen(),
                                      k_trans=k, **kw)
        assert nk.LAUNCHES["glm_nuts_multistep_mat"] == 2
        assert not nk.LAUNCHES["glm_nuts_multistep"]
        assert all(torch.equal(a, b) for a, b in zip(out[:3], again[:3]))
        draws = nk.glm_nuts_multistep_draws(tk._seed(gen()), C, d, k, md,
                                            device="cuda")
        ref = nk.glm_nuts_multistep_ref(XT, Y, th, lp0, g0, 0.2, None,
                                        k_trans=k, draws=draws, **kw)
        lp_at, g_at = logp_grad(out[0])
        rk, rr = out[3], ref[3]
        _held(out[:3], (ref[0], g_at, lp_at),
              (rk["ndoublings"] == rr["ndoublings"]).all(0)
              & (rk["diverging"] == rr["diverging"]).all(0)
              & ((rk["ppars"] - rr["ppars"]).abs().amax((0, 2)) <= 1e-3),
              scale, allowed)

    # kernel 4 with a ragged last tile of rows
    XT, Y, A, th = _folded_glm(20_001, 7, 300, seed=130)
    lp, g = gb.glm_logp_grad_tiled(XT, Y, th, prior_prec=A)
    lp_r, g_r = gb.glm_logp_grad_tiled_ref(XT.double(), Y.double(),
                                           th.double(), prior_prec=A.double())
    torch.testing.assert_close(lp, lp_r.float(), rtol=1e-5, atol=2e-2)
    torch.testing.assert_close(g, g_r.float(), rtol=1e-4, atol=4e-2)
