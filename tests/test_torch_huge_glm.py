"""GLMs of up to 131072 parameters (2^17, the Pallas kernels' VMEM bound at
N about 190) on every GLM kernel of the port: kernels 1 and 8's plain
versions at d 16416 against the JAX package's Pallas kernels in interpret
mode on the CPU, with a (d,) prior row; kernel 9's Philox draw layout, whose
tree draws lie just below the slice uniform's and apart from d, disjoint at
d 16385, 65536 and 131072 and replayed there; kernels 3 and 3b's draws,
disjoint at every d; the routes at the bound and past it, and the memory
reason a run takes when not even one block's scratch and the chain state
fit; the scratch buffers, one for each (device, stream); and ROADMAP's
unsettled check of the chunked 3b against the generic engine from one
frozen state.

On the CPU the wrappers run their plain versions;
``test_huge_kernels_match_plain_on_card`` holds the kernels at d 32768 on a
card, and chip_smoke.py's ``phase_huge_width`` at d 32768 and 131072.
Tolerances are tests/test_torch_chunked_glm.py's (float32 values to rtol
and atol 2e-5, the gradient to atol 2e-4, lp to 2e-4) and
tests/test_torch_chunked_nuts.py's for kernel 8.  Dtypes are pinned to
float32 on both sides (tests/conftest.py turns on x64)."""
import logging

import numpy as np
import pytest
import torch

import mcmc_jl_tpu_torch as mt
from mcmc_jl_tpu_torch.core.task import MCMCTask
from mcmc_jl_tpu_torch.ops import cuda_build
from mcmc_jl_tpu_torch.ops import glm_kernels as gk
from mcmc_jl_tpu_torch.ops import nuts_kernels as nk
from mcmc_jl_tpu_torch.ops import philox
from mcmc_jl_tpu_torch.ops import warmstart as tws
from mcmc_jl_tpu_torch.parallel import pchains
from mcmc_jl_tpu_torch.samplers.base import RunCtx, TuneState
from test_torch_wide_glm import _close, _data, _grad_at, _jax, _t
from test_torch_wide_nuts import _pad

torch.set_num_threads(1)

G_ATOL = 2e-4
Z_MAX = 5.0
D_EDGE = 16416  # past the old bound 16384: 33 chunks of 512 on the card


def _edge_case(seed, C=8, n=32):
    """tests/test_torch_wide_glm.py's design at D_EDGE, chains at 0.3
    standard normals, a (d,) prior row in [0.5, 2)."""
    X, Y = _data("logistic", n, D_EDGE, seed)
    rng = np.random.default_rng(seed + 1)
    theta = (0.3 * rng.standard_normal((C, D_EDGE))).astype(np.float32)
    lam = rng.uniform(0.5, 2.0, D_EDGE).astype(np.float32)
    return X, Y, theta, lam, rng


def test_leapfrogs_ref_at_d_16416_matches_pallas():
    """Kernel 1's plain trajectory at d 16416 with a (d,) prior row == the
    Pallas _kernel (interpret; d padded to 16512) with the same row."""
    jnp, pg = _jax()
    X, Y, theta, lam, rng = _edge_case(101)
    m = rng.standard_normal(theta.shape).astype(np.float32)
    XTt, Yt = _t(X.T).contiguous(), _t(Y)
    _, g = _grad_at(XTt, Yt, _t(theta), prior_prec=_t(lam))
    XT, Y2, d_pad = pg.pad_design(X, Y)
    assert d_pad == 16512
    th_p, m_p, g_p = (pg.pad_chains(jnp.asarray(a, jnp.float32), d_pad)
                      for a in (theta, m, g.numpy()))
    jt, jm, jg, jlp = pg.glm_hmc_leapfrogs(
        XT, Y2, th_p, m_p, g_p, 0.05, n_leaps=3, block_chains=8,
        interpret=True, prior_prec=jnp.asarray(lam))
    pt, pm, pgr, plp = gk.glm_leapfrogs(XTt, Yt, _t(theta), _t(m), g, 0.05,
                                        n_leaps=3, prior_prec=_t(lam))
    _close(pt, np.asarray(jt)[:, :D_EDGE])
    _close(pm, np.asarray(jm)[:, :D_EDGE])
    _close(pgr, np.asarray(jg)[:, :D_EDGE], atol=G_ATOL)
    _close(plp, jlp, atol=2e-4)


def test_nuts_transition_ref_at_d_16416_matches_pallas():
    """Kernel 8's plain version at d 16416 (N 32, 8 chains, md 4) with a
    (d,) prior row against JAX's ``glm_nuts_transition(interpret=True)`` on
    the same start and pre-drawn noise: the same discrete path on every
    chain, theta, g and lp within tests/test_torch_chunked_nuts.py's
    tolerances."""
    import jax.numpy as jnp
    from mcmc_jl_tpu.ops.pallas_glm import LANE, pad_design
    from mcmc_jl_tpu.ops.pallas_nuts import glm_nuts_transition as jtrans

    md, eps, C = 4, 0.2, 8
    X, Y, theta, lam, rng = _edge_case(103, C)
    m0 = rng.standard_normal((C, D_EDGE)).astype(np.float32)
    logu = np.log(rng.random(C)).astype(np.float32)
    dirn = np.where(rng.random((C, md)) < 0.5, 1.0, -1.0).astype(np.float32)
    merge = rng.random((C, md)).astype(np.float32)
    leaf = rng.random((C, 1 << md)).astype(np.float32)
    XTt, Yt = _t(X.T).contiguous(), _t(Y)
    lp, g = _grad_at(XTt, Yt, _t(theta), prior_prec=_t(lam))
    nk.reset_counts()
    th_t, g_t, lp_t, nd_t, dv_t = (a.numpy() for a in nk.glm_nuts_transition(
        XTt, Yt, _t(theta), lp, g, eps, _t(m0), _t(logu), _t(dirn),
        _t(merge), _t(leaf), maxdoublings=md, prior_prec=_t(lam)))
    assert nk.PLAIN_CALLS["glm_nuts_transition"] == 1
    assert not any(nk.LAUNCHES.values())
    XTj, Yj, d_pad = pad_design(X, Y)
    out = jtrans(
        XTj, Yj, _pad(theta, d_pad), jnp.asarray(lp.numpy()),
        _pad(g.numpy(), d_pad), jnp.float32(eps), _pad(m0, d_pad),
        jnp.asarray(logu), _pad(dirn, LANE, 1.0), _pad(merge, LANE, 0.5),
        _pad(leaf, LANE, 0.5), maxdoublings=md, interpret=True,
        prior_prec=jnp.asarray(lam))
    th_j, g_j, lp_j, nd_j, dv_j = (np.asarray(a) for a in out)
    np.testing.assert_array_equal(nd_t, nd_j)
    np.testing.assert_array_equal(dv_t, dv_j)
    assert nd_t.min() >= 1
    np.testing.assert_allclose(th_t, th_j[:, :D_EDGE], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(lp_t, lp_j, rtol=5e-7, atol=1e-4)
    np.testing.assert_allclose(
        g_t, g_j[:, :D_EDGE], atol=1e-5 * max(1.0, float(np.abs(g_j).max())))


# ---- Philox draw layouts ---------------------------------------------------

@pytest.mark.parametrize("d", [16385, 65536, 131072])
def test_nuts_draw_ranges_disjoint_past_the_old_bound(d):
    """Kernel 9's five draw ranges of one (chain, transition) at md 10: the
    momenta 0 .. d/2 - 1 (from d 16385 they passed the directions' old
    0x2000), the leaves at LEAF_DRAW, the directions at DIR_DRAW, the merge
    uniforms at MERGE_DRAW and the slice at SLICE_DRAW: disjoint, the tree's
    draws just below the slice's, and no width up to D_MAX moves them (the
    momenta stay below the leaves up to d 2^33)."""
    md = nk.MAX_DOUBLINGS
    assert nk.NUTS_D_MAX == gk.D_MAX == 131072
    assert (nk.LEAF_DRAW, nk.DIR_DRAW, nk.MERGE_DRAW) == (
        0xFFFE0000, 0xFFFF0000, 0xFFFF0100)
    ranges = sorted([(0, (d + 1) // 2),
                     (nk.LEAF_DRAW, nk.LEAF_DRAW + (1 << md)),
                     (nk.DIR_DRAW, nk.DIR_DRAW + md),
                     (nk.MERGE_DRAW, nk.MERGE_DRAW + md),
                     (gk.SLICE_DRAW, gk.SLICE_DRAW + 1)])
    assert ranges[0] == (0, (d + 1) // 2)
    for (_, hi), (lo, _) in zip(ranges, ranges[1:]):
        assert hi <= lo, ranges
    assert ranges[-1] == (gk.SLICE_DRAW, gk.SLICE_DRAW + 1)
    assert (d + 1) // 2 > 0x2000  # the directions' draws before this layout


def test_nuts_draw_replay_at_the_bound():
    """The replay of kernel 9's draws at d 131072 and md 10: coordinates 0,
    65537 and 131071 take the normals of their own momentum draws (j // 2,
    words 0, 1 for even j and 2, 3 for odd), the directions, merge
    uniforms and last leaf their own draws, the slice its own; the momenta
    and slice equal glm_multistep_draws'."""
    d, md, C, k, i0, seed = gk.D_MAX, nk.MAX_DOUBLINGS, 2, 2, 9, 0xBADC0DE
    m0, logu, dirn, merge, leaf = nk.glm_nuts_multistep_draws(
        seed, C, d, k, md, i0=i0)
    assert m0.shape == (k, C, d) and leaf.shape == (k, C, 1 << md)
    m0_h, logu_h = gk.glm_multistep_draws(seed, C, d, k, i0=i0)
    assert torch.equal(m0, m0_h) and torch.equal(logu, logu_h)

    def u(c, t, draw):
        return float(philox.uniform(
            philox.philox4x32((c, i0 + t, draw, 0), seed)[0]))

    for t, c, j in ((0, 0, 0), (1, 1, 65537), (0, 1, d - 1)):
        b = philox.philox4x32((c, i0 + t, j // 2, 0), seed)
        want = (philox.box_muller(b[2], b[3]) if j % 2
                else philox.box_muller(b[0], b[1]))
        assert float(m0[t, c, j]) == float(want)
    for t, c, j in ((0, 1, 0), (1, 0, md - 1)):
        assert float(merge[t, c, j]) == u(c, t, nk.MERGE_DRAW + j)
        assert float(dirn[t, c, j]) == (
            -1.0 if u(c, t, nk.DIR_DRAW + j) < 0.5 else 1.0)
    assert float(leaf[1, 1, -1]) == u(1, 1, nk.LEAF_DRAW + (1 << md) - 1)
    b = philox.philox4x32((0, i0 + 1, gk.SLICE_DRAW, 0), seed)[0]
    assert float(logu[1, 0]) == float(philox.log1m_u01(b))


@pytest.mark.parametrize("d", [1, 16385, 131072])
def test_hmc_draws_disjoint_at_every_width(d):
    """Kernels 3 and 3b draw coordinate j from Philox draw j // 2 and the MH
    uniform from SLICE_DRAW = 0xFFFFFFFF: the momenta's last draw (d - 1)
    // 2 lies below it at every d the kernels take, and the replay gives
    the last coordinate its own draw."""
    assert (gk.D_MAX - 1) // 2 < gk.SLICE_DRAW
    seed, C, k, i0 = 0xFEED, 2, 1, 3
    m0, logu = gk.glm_multistep_draws(seed, C, d, k, i0=i0)
    j = d - 1
    b = philox.philox4x32((1, i0, j // 2, 0), seed)
    want = (philox.box_muller(b[2], b[3]) if j % 2
            else philox.box_muller(b[0], b[1]))
    assert float(m0[0, 1, j]) == float(want)
    u = philox.philox4x32((1, i0, gk.SLICE_DRAW, 0), seed)[0]
    assert float(logu[0, 1]) == float(philox.log1m_u01(u))


# ---- routes, memory and scratch --------------------------------------------

def _wide_model(d, n=4, seed=7):
    X, Y = _data("logistic", n, d, seed)
    return mt.model(glm=("logistic", X, Y), device="cpu")


def test_routes_at_the_new_bound(caplog):
    """At d 131072 plain HMC routes to "hmc" and exact NUTS to "nuts" (and
    its continuation), with no reason logged; at 131073 both take the
    generic engine with the GLM kernels' reason, the item's name carrying
    the new bound."""
    runner = mt.SerialMC(steps=20, burnin=10)
    m = _wide_model(gk.D_MAX)
    caplog.clear()
    with caplog.at_level(logging.INFO):
        assert pchains._route(MCMCTask(m, mt.HMC(5, 0.1), runner),
                              True, 64) == "hmc"
        assert pchains._route(MCMCTask(m, mt.NUTS(6), runner), True,
                              64) == "nuts"
        assert pchains.continuation_route(m, mt.NUTS(6), 64, True) == "nuts"
    assert "generic torch engine" not in caplog.text
    wide = _wide_model(gk.D_MAX + 1)
    caplog.clear()
    with caplog.at_level(logging.INFO):
        for s in (mt.HMC(5, 0.1), mt.NUTS(6)):
            assert pchains._route(MCMCTask(wide, s, runner), True) is False
    why = ("d = 131073 > 131072, the GLM kernels' bound (ROADMAP: GLMs "
           "wider than 131072 parameters)")
    assert sum(why in r.getMessage() for r in caplog.records) == 2


def _slot_bytes(d):
    """csrc/glm_hmc.cu glm_slot_bytes, as a stand-in where the library is
    not built: 4 rows of 16 chains' D float32 a block on the very-wide tile,
    5 on the chunked tier, none at d <= 256 (test_slot_and_slice_bytes
    holds the library to it on a card)."""
    if d <= gk.WIDE_D_MAX:
        return 0
    return 4 * 16 * gk._padded(d) * (5 if d > gk.XWIDE_D_MAX else 4)


def _slice_bytes(d, md):
    """csrc/glm_nuts.cu glm_nuts_slice_bytes, as a stand-in where the
    library is not built: 10 + 2 md rows (wide), 12 + 2 md (very-wide) or
    13 + 2 md (chunked) of 16 chains' D float32, none at d <= 32."""
    if d <= gk.NARROW_D_MAX:
        return 0
    rows = 10 if d <= gk.WIDE_D_MAX else 13 if d > gk.XWIDE_D_MAX else 12
    return 4 * 16 * gk._padded(d) * (rows + 2 * md)


def _stand_in_bytes(monkeypatch):
    monkeypatch.setattr(gk, "slot_bytes", _slot_bytes)
    monkeypatch.setattr(nk, "slice_bytes", _slice_bytes)


def test_memory_reason_names_the_bytes(monkeypatch, caplog):
    """A plan that does not hold one block's scratch and the chain state
    (with the rows that kernels 3b and 9 collect) sends the run to the
    generic engine with a reason that names the bytes: ``memory_reason``
    alone, and through the route with the card's free memory given as too
    few bytes; with enough, no reason."""
    _stand_in_bytes(monkeypatch)
    d, C = gk.D_MAX, 64
    per = nk.slice_bytes(d, 6)
    assert per == 4 * 16 * d * (13 + 12)
    rows = gk.ROWS_A_LAUNCH
    state = 4 * (gk.CHAIN_ARRAYS + rows) * C * d
    assert gk.memory_reason(per, d, C, per + state, rows) is None
    why = gk.memory_reason(per, d, C, per + state - 1, rows)
    assert f"({per} bytes)" in why and f"({state} bytes)" in why
    assert f"{per + state - 1} bytes free" in why
    assert "GLMs wider than the card's memory" in why
    assert gk.memory_reason(per, d, C, per + state - 1) is None
    m = _wide_model(d)
    runner = mt.SerialMC(steps=20, burnin=10)
    monkeypatch.setattr(cuda_build, "free_bytes", lambda dev: 10 ** 6)
    caplog.clear()
    with caplog.at_level(logging.INFO):
        for s in (mt.HMC(5, 0.1), mt.NUTS(6)):
            assert pchains._route(MCMCTask(m, s, runner), True, C) is False
        assert pchains.continuation_route(m, mt.NUTS(6), C, True) is False
    assert caplog.text.count("more than the 1000000 bytes free") == 3
    assert f"one block's scratch ({gk.slot_bytes(d)} bytes)" in caplog.text
    monkeypatch.setattr(cuda_build, "free_bytes", lambda dev: 10 ** 12)
    assert pchains._route(MCMCTask(m, mt.NUTS(6), runner), True, C) == "nuts"


def test_routes_off_the_card_build_nothing(monkeypatch):
    """Off the card the route asks no library for its bytes (nothing is
    launched there, and the libraries build only where nvcc is): at d
    131072 plain HMC and exact NUTS route with no memory check."""
    def refuse():
        raise AssertionError("a library was loaded for a CPU route")

    monkeypatch.setattr(gk, "load_kernels", refuse)
    monkeypatch.setattr(nk, "load_kernels", refuse)
    m = _wide_model(gk.D_MAX)
    runner = mt.SerialMC(steps=20, burnin=10)
    assert pchains._route(MCMCTask(m, mt.HMC(5, 0.1), runner), True,
                          64) == "hmc"
    assert pchains._route(MCMCTask(m, mt.NUTS(6), runner), True,
                          64) == "nuts"
    assert pchains._kernel_shape_ok(m, "warm", mt.HMC(5, 0.1), 64) is None


def test_slot_and_slice_bytes():
    """The bytes of one block's scratch as the built libraries count them
    (csrc/glm_hmc.cu glm_slot_bytes, csrc/glm_nuts.cu glm_nuts_slice_bytes)
    at every tier, against the stand-ins above; at d 131072 and md 10 132
    blocks take 36.5 GB, past 2^31 floats from the 33rd block on (skips
    without a card: the libraries build only there)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the libraries build only there")
    for d in (gk.WIDE_D_MAX, 300, gk.XWIDE_D_MAX, 1025, 16416, gk.D_MAX):
        assert gk.slot_bytes(d) == _slot_bytes(d), d
    for d in (gk.NARROW_D_MAX, 40, 150, 300, 1024, 1025, gk.D_MAX):
        for md in (1, 6, nk.MAX_DOUBLINGS):
            assert nk.slice_bytes(d, md) == _slice_bytes(d, md), (d, md)
    assert gk.slot_bytes(gk.D_MAX) == 4 * 16 * gk.D_MAX * 5 == 41943040
    per = nk.slice_bytes(gk.D_MAX, 10)
    assert 132 * per == 36540776448
    assert 32 * per // 4 > 2 ** 31 > 31 * per // 4
    assert 132 * nk.slice_bytes(gk.D_MAX, 4) // 4 > 2 ** 31


def test_scratch_buffers_one_a_device_and_stream(monkeypatch):
    """``_slots`` (kernels 1-3b) and ``_scratch`` (8, 9) keep one buffer for
    each (device, stream) whatever d and md, grown once a launch needs more
    and never shrunk; a growth takes the whole request when the card can
    give it beside the launch's outputs (``reserve``), else the whole
    slices that fit there, one at least; off the card nothing caps it."""
    assert cuda_build.free_bytes("cpu") is None
    _stand_in_bytes(monkeypatch)
    monkeypatch.setattr(gk, "_stream_key", lambda dev: (dev, 7))
    monkeypatch.setattr(gk, "_sm_count", lambda dev: 4)
    monkeypatch.setattr(nk, "_stream_key", lambda dev: (dev, 7))
    monkeypatch.setattr(nk, "nuts_plan", lambda d, N, md: {
        "scratch_bytes": 4 * nk.slice_bytes(d, md)})
    monkeypatch.setattr(gk, "_SLOTS", {})
    monkeypatch.setattr(nk, "_SCRATCH", {})
    sizes = []
    for d, C in ((2048, 64), (300, 64), (4096, 16), (1025, 4096)):
        buf, nbytes = gk._slots("cpu", d, C, 0)
        sizes.append(nbytes)
        assert nbytes >= gk.slot_bytes(d) * min(-(-C // 16), 4)
    assert list(gk._SLOTS) == [("cpu", 7)] and sizes == sorted(sizes)
    assert sizes[-1] == gk.slot_bytes(2048) * 4
    sizes = []
    for d, md, C in ((300, 6, 64), (4096, 10, 16), (40, 4, 4096),
                     (4096, 6, 64)):
        buf, nbytes = nk._scratch("cpu", d, 100, md, C, 0)
        sizes.append(nbytes)
        assert nbytes >= nk.slice_bytes(d, md) * min(-(-C // 16), 4)
    assert list(nk._SCRATCH) == [("cpu", 7)] and sizes == sorted(sizes)
    # the whole request when it fits beside the reserve; else the whole
    # slices that fit, the old buffer counted as free, one at least
    cache, per, want = {}, 1000, 10_000

    def grow(free, reserve=500, c=cache):
        monkeypatch.setattr(cuda_build, "free_bytes", lambda dev: free)
        return cuda_build.scratch_buffer(c, "k", want, "cpu", per,
                                         reserve)[1]

    assert grow(10 ** 6, c={}) == want
    assert grow(want + 500, c={}) == want
    assert grow(want + 499, c={}) == 9 * per
    assert grow(4500) == 4 * per
    assert grow(100) == 4 * per
    assert grow(8000) == want
    assert grow(0, c={}) == per


# ---- ROADMAP's unsettled check: the chunked 3b against the generic engine

def _frozen_start(d, n, C, eps, nl, start, seed=95):
    """A logistic GLM at (n, d) (float32 model), adaptive HMC with a
    diagonal metric, and C chains at ``start`` whose adaptation is frozen
    at (eps, nl, s): s the Laplace sds at 0, every chain's tuner at eps
    and nl, its Welford count past the threshold with variance s^2."""
    X, Y = _data("logistic", n, d, seed=seed)
    m = mt.model(glm=("logistic", X.astype(np.float64),
                      Y.astype(np.float64)), dtype=torch.float32,
                 device="cpu")
    Xd = X.astype(np.float64)
    s = np.sqrt(np.diag(np.linalg.inv(Xd.T @ (Xd * 0.25) + np.eye(d))))
    sampler = mt.HMC(nl, eps, mt.EmpMCTuner(0.8, adapt_step=50),
                     mass_adapt="diag")
    st = pchains.init_chains(m, sampler, C, torch.Generator().manual_seed(0),
                             inits=np.broadcast_to(start, (C, d)).copy())
    full = lambda v, dt: torch.full((C,), v, dtype=dt)  # noqa: E731
    count = 100
    st = st.replace(
        tune=TuneState(step_size=full(eps, torch.float32),
                       n_leaps=full(nl, torch.int32),
                       accepted=full(0, torch.int32),
                       proposed=full(0, torch.int32)),
        mass=st.mass.replace(count=full(count, torch.int32),
                             m2=torch.tensor(s * s * (count - 1),
                                             dtype=torch.float32)
                             .expand(C, d).clone()))
    return m, sampler, st, s


def _both_phases(m, sampler, st, steps, seed=1):
    """The fused sampling phase (``make_fused_continuation``: 3b's plain
    version on the folded design, the Halton rule's leap counts) and the
    generic engine's (``_scan_chains`` with no burn-in: every chain at the
    frozen step, nl leaps) from the same states: their rows."""
    gk.reset_counts()
    fused, _ = tws.make_fused_continuation(m, sampler, st)(
        st, steps, torch.Generator().manual_seed(seed), i0=51)
    assert gk.PLAIN_CALLS["glm_multistep_rows"] >= 1
    _, generic = pchains._scan_chains(m, sampler, RunCtx(burnin=0), st,
                                      torch.Generator().manual_seed(seed + 1),
                                      steps)
    return fused, generic


def _z_rows(a, b, lo):
    """max |z| of the per-chain means over rows lo.. of two chain sets."""
    ma = a["ppars"][lo:].double().mean(0).numpy()
    mb = b["ppars"][lo:].double().mean(0).numpy()
    se = np.sqrt(ma.var(0) / len(ma) + mb.var(0) / len(mb))
    return float(np.max(np.abs(ma.mean(0) - mb.mean(0)) / se))


def test_chunked_3b_and_generic_phase_agree_from_one_frozen_state():
    """ROADMAP §3's unsettled check (adaptive HMC at d 4096 from a start
    shared by all chains: |z| 18 against the generic engine).  At d 1056
    (the chunked tier), 256 chains, from one start shared by every chain
    away from the posterior mean, with the adaptation frozen at the same
    (eps 0.2, 8 leaps, s): 3b's plain version and the generic engine's
    sampling phase agree in their per-chain means over the kept second
    half of 40 rows (|z| < 5), with the frozen values the pipeline pools
    (``_freeze``) equal to the chains'; over all 40 rows the start's
    transient still parts them.  From the posterior mode, where every
    chain starts at the same point, the generic engine's fixed 8 leaps
    accept far less than 3b's Halton-jittered lengths: the energy errors of
    coordinates that start in phase add up at a fixed length.  So the two
    engines' transients differ with the transition law (fixed against
    jittered lengths; on the card also per-chain against pooled steps),
    while from one state 3b's law is the generic engine's."""
    d, n, C, steps, eps, nl = 1056, 64, 256, 40, 0.2, 8
    start = np.random.default_rng(0).standard_normal(d)
    m, sampler, st, s = _frozen_start(d, n, C, eps, nl, start)
    e2, nl2, s2 = tws._freeze(sampler, st)
    assert abs(e2 - eps) < 1e-6 and nl2 == nl
    np.testing.assert_allclose(s2.numpy(), s, rtol=1e-6)
    fused, generic = _both_phases(m, sampler, st, steps)
    assert fused["ppars"].shape == generic["ppars"].shape == (steps, C, d)
    assert _z_rows(fused, generic, steps // 2) < Z_MAX
    acc_f = float(fused["accept"].float().mean())
    acc_g = float(generic["accept"].float().mean())
    assert min(acc_f, acc_g) > 0.8, (acc_f, acc_g)
    # from the mode: one start for all chains, energy errors in phase
    m, sampler, st, _ = _frozen_start(d, n, C, eps, nl, np.zeros(d))
    fused, generic = _both_phases(m, sampler, st, 8)
    acc_f = float(fused["accept"].float().mean())
    acc_g = float(generic["accept"].float().mean())
    assert acc_g < 0.25 < acc_f, (acc_f, acc_g)


@pytest.mark.slow
@pytest.mark.parametrize("d", [1056, 2048])
def test_chunked_3b_and_generic_phase_agree_deeper(d):
    """The deeper sweep of the check above: at d 1056 and 2048, 512 chains,
    from a shared start away from the mean and from a start of each chain
    its own, 120 rows: the per-chain means over the kept last 60 agree
    (|z| < 5)."""
    n, C, steps = 64, 512, 120
    rng = np.random.default_rng(d)
    for start in (rng.standard_normal(d), rng.standard_normal((C, d))):
        m, sampler, st, _ = _frozen_start(d, n, C, 0.2, 8, start)
        fused, generic = _both_phases(m, sampler, st, steps)
        assert _z_rows(fused, generic, steps // 2) < Z_MAX


def test_huge_kernels_match_plain_on_card():
    """Kernels 1, 3b, 4, 8 and 9 at d 32768 (N 300, 37 chains: three tiles,
    the last ragged) against their plain versions on a card, each launch
    counted under its ``_chunked`` key (skips without a card; chip_smoke.py
    phase_huge_width holds them at d 32768 and 131072 and kernel 9's scratch
    past 2^31 floats)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    from mcmc_jl_tpu_torch.ops import glm_bign as gb

    d, N, C = 32768, 300, 37
    cu = lambda a: torch.as_tensor(np.asarray(a, np.float32)).cuda()  # noqa: E731
    X, Y = _data("logistic", N, d, seed=5)
    rng = np.random.default_rng(6)
    XT, Yc = cu(X.T).contiguous(), cu(Y)
    theta = cu(0.3 * rng.standard_normal((C, d)))
    m = cu(rng.standard_normal((C, d)))
    lp, g = _grad_at(XT, Yc, theta)
    gk.reset_counts()
    nk.reset_counts()
    gb.reset_counts()
    out = gk.glm_leapfrogs(XT, Yc, theta, m, g, 0.1, n_leaps=3)
    ref = gk.glm_leapfrogs_ref(XT, Yc, theta, m, g, 0.1, n_leaps=3)
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-3)
    gen = lambda: torch.Generator(device="cuda").manual_seed(3)  # noqa: E731
    rk = gk.glm_multistep_rows(XT, Yc, theta, 0.2, 2.0, 11, 20, k_trans=2,
                               generator=gen())
    m0, lu = gk.glm_multistep_draws(gk._seed(gen()), C, d, 2, i0=11,
                                    device="cuda")
    rr = gk.glm_multistep_rows_ref(XT, Yc, theta, 0.2, 2.0, 11, 20,
                                   k_trans=2, noise=(m0, lu))
    same = (rk[3]["accept"] == rr[3]["accept"]).all(0)
    assert int((~same).sum()) <= 1
    torch.testing.assert_close(rk[0][same], rr[0][same], rtol=1e-4,
                               atol=1e-3)
    lp4, g4 = gb.glm_logp_grad_tiled(XT, Yc, theta)
    torch.testing.assert_close(g4, g, rtol=1e-4, atol=1e-3)
    torch.testing.assert_close(lp4, lp, rtol=1e-5, atol=1e-2)
    md = 4
    noise = (cu(rng.standard_normal((C, d))), cu(np.log(rng.random(C))),
             cu(np.where(rng.random((C, md)) < 0.5, 1.0, -1.0)),
             cu(rng.random((C, md))), cu(rng.random((C, 1 << md))))
    k8 = nk.glm_nuts_transition(XT, Yc, theta, lp, g, 0.2, *noise,
                                maxdoublings=md)
    r8 = nk.glm_nuts_transition_ref(XT, Yc, theta, lp, g, 0.2, *noise,
                                    maxdoublings=md)
    same = (k8[3] == r8[3]) & ((k8[0] - r8[0]).abs().amax(-1) < 1e-3)
    assert int((~same).sum()) <= 1
    k9 = nk.glm_nuts_multistep(XT, Yc, theta, lp, g, 0.2, gen(), k_trans=2,
                               maxdoublings=md)
    draws = nk.glm_nuts_multistep_draws(gk._seed(gen()), C, d, 2, md,
                                        device="cuda")
    r9 = nk.glm_nuts_multistep_ref(XT, Yc, theta, lp, g, 0.2, None,
                                   k_trans=2, maxdoublings=md, draws=draws)
    same = ((k9[3]["ndoublings"] == r9[3]["ndoublings"]).all(0)
            & ((k9[0] - r9[0]).abs().amax(-1) < 1e-3))
    assert int((~same).sum()) <= 1
    assert gk.LAUNCHES["glm_leapfrogs_chunked"] == 1
    assert gk.LAUNCHES["glm_multistep_rows_chunked"] == 1
    assert gb.LAUNCHES["glm_logp_grad_tiled_chunked"] == 1
    assert nk.LAUNCHES["glm_nuts_transition_chunked"] == 1
    assert nk.LAUNCHES["glm_nuts_multistep_chunked"] == 1
