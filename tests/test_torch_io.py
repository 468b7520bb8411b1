"""The port's checkpoints (mcmc_jl_tpu_torch/utils/io.py) on the CPU: the
counterparts of tests/test_io.py's two round trips, a batched one (four
chains of one run saved, loaded into fresh tasks and resumed as a list,
bit for bit the live chains' resume), the file the port writes against
the one the JAX package writes for the same state, the leaves' device and
dtype on load, and a generator state of another device kind, or a JAX
key, refused with a clear message."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import mcmc_jl_tpu as mc
from mcmc_jl_tpu.utils import io as jio
import mcmc_jl_tpu_torch as mt
from mcmc_jl_tpu_torch.core.chain import MCMCChain
from mcmc_jl_tpu_torch.samplers.base import make_generator
from mcmc_jl_tpu_torch.utils.io import (load_chain, load_task_into,
                                        save_chain, save_task)
from mcmc_jl_tpu_torch.utils.table import Table

torch.set_num_threads(1)


def _model(dtype=torch.float64):
    return mt.model(lambda v: -(v * v).sum(-1), grad=lambda v: -2 * v,
                    init=np.ones(2), device="cpu", dtype=dtype)


def test_task_roundtrip(tmp_path):
    m = _model()
    c1 = mt.run(m * mt.MALA(0.5, mt.EmpMCTuner(0.6)) * mt.SerialMC(steps=300),
                seed=5)
    p = str(tmp_path / "task.npz")
    save_task(p, c1.task)

    fresh = mt.MCMCTask(m, c1.task.sampler, c1.task.runner)
    restored = load_task_into(p, fresh)
    np.testing.assert_array_equal(restored.state.pars.numpy(),
                                  c1.task.state.pars.numpy())
    # tuner state survives (the reference loses it on resume)
    np.testing.assert_array_equal(restored.state.tune.step_size.numpy(),
                                  c1.task.state.tune.step_size.numpy())
    assert restored.pos == c1.task.pos

    # resumed run from the restored task == resumed run from the live task
    c_live = mt.resume(c1.task, steps=100)
    c_disk = mt.resume(restored, steps=100)
    np.testing.assert_array_equal(c_live.samples.values, c_disk.samples.values)


def test_chain_roundtrip(tmp_path):
    m = _model()
    c1 = mt.run(m * mt.HMC(5, 0.3) * mt.SerialMC(steps=200, burnin=50), seed=2)
    p = str(tmp_path / "chain.npz")
    save_chain(p, c1)

    fresh = mt.MCMCTask(m, c1.task.sampler, c1.task.runner)
    c2 = load_chain(p, fresh)
    np.testing.assert_array_equal(c1.samples.values, c2.samples.values)
    np.testing.assert_array_equal(c1.gradients.values, c2.gradients.values)
    assert c1.samples.columns == c2.samples.columns
    np.testing.assert_array_equal(np.asarray(c1.diagnostics["accept"]),
                                  np.asarray(c2.diagnostics["accept"]))
    assert c2.range == c1.range
    # and it resumes
    c3 = mt.resume(c2, steps=50)
    assert c3.samples.nrow == 50
    np.testing.assert_array_equal(c3.samples.values,
                                  mt.resume(c1, steps=50).samples.values)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "generic"])
def test_batched_roundtrip(tmp_path, fused):
    """Four chains of one run, saved and loaded into fresh tasks, resume as
    a list bit for bit as the live chains do (the fused continuation of a
    GLM, or the generic engine)."""
    rng = np.random.default_rng(3)
    X = np.column_stack([np.ones(60), rng.standard_normal((60, 2))])
    Y = (rng.random(60) < 0.5).astype(np.float64)
    m = mt.model(glm=("logistic", X, Y), dtype=torch.float64, device="cpu")
    s = mt.HMC(5, 0.05, mt.EmpMCTuner(0.8, adapt_step=20), mass_adapt="diag")
    live = mt.run(m * s * mt.SerialMC(steps=120, burnin=60), chains=4,
                  seed=1, fused=fused)
    loaded = []
    for i, c in enumerate(live):
        p = tmp_path / f"chain{i}.npz"
        save_chain(p, c)
        loaded.append(load_chain(p, mt.MCMCTask(m, s, c.task.runner)))
    for c, lc in zip(live, loaded):
        assert lc.task.pos == c.task.pos
        assert torch.equal(lc.task.key, c.task.key)
        np.testing.assert_array_equal(lc.task.state.mass.scale.numpy(),
                                      c.task.state.mass.scale.numpy())
    a = mt.resume(live, steps=50, fused=fused)
    b = mt.resume(loaded, steps=50, fused=fused)
    for ca, cb in zip(a, b):
        np.testing.assert_array_equal(ca.samples.values, cb.samples.values)
        np.testing.assert_array_equal(ca.task.state.pars.numpy(),
                                      cb.task.state.pars.numpy())
        assert ca.task.pos == cb.task.pos == 170


def test_layout_and_placement(tmp_path):
    """The JAX package's keys; leaves in the fresh task's dtype; a
    generator state of a CUDA generator (16 bytes) refused on a CPU
    model."""
    m = _model()
    c = mt.run(m * mt.HMC(3, 0.2, mt.EmpMCTuner(0.7)) * mt.SerialMC(30),
               seed=4)
    p = tmp_path / "chain.npz"
    save_chain(p, c)
    data = np.load(p)
    assert {"samples", "gradients", "range", "run_time", "meta", "key",
            "pos", "leaf_0"} <= set(data.files)
    assert data["key"].dtype == np.uint8
    n_leaves = sum(k.startswith("leaf_") for k in data.files)
    # pars, logtarget, grad, i, the tuner's four, the mass accumulator's six
    assert n_leaves == 14
    m32 = _model(torch.float32)
    lc = load_chain(p, mt.MCMCTask(m32, c.task.sampler, c.task.runner))
    assert lc.task.state.pars.dtype == torch.float32
    assert lc.task.state.tune.n_leaps.dtype == torch.int32
    np.testing.assert_array_equal(lc.task.state.pars.numpy(),
                                  c.task.state.pars.numpy().astype(np.float32))
    arrays = dict(data)
    arrays["key"] = np.zeros(16, np.uint8)
    np.savez(tmp_path / "cuda_key.npz", **arrays)
    with pytest.raises(ValueError, match="cuda generator"):
        load_task_into(tmp_path / "cuda_key.npz",
                       mt.MCMCTask(m, c.task.sampler, c.task.runner))
    with pytest.raises(ValueError, match="no live state"):
        save_task(tmp_path / "none.npz",
                  mt.MCMCTask(m, c.task.sampler, c.task.runner))


def _as_dict(state):
    return {f.name: (_as_dict(getattr(state, f.name))
                     if dataclasses.is_dataclass(getattr(state, f.name))
                     else np.asarray(getattr(state, f.name)))
            for f in dataclasses.fields(state)}


# sampler maker, the converter of its state
JAX_LAYOUT = {
    "hmc_diag": (lambda p: p.HMC(4, 0.1, p.EmpMCTuner(0.8, adapt_step=10),
                                 mass_adapt="diag"), mt.hmc_state_from_numpy),
    "chees": (lambda p: p.ChEESHMC(len0=0.5, max_leaps=16),
              mt.chees_state_from_numpy),
    "nuts_diag": (lambda p: p.NUTS(maxdoublings=4, mass_adapt="diag"),
                  mt.nuts_state_from_numpy),
    "hmc_dense": (lambda p: p.HMC(4, 0.1, mass_adapt="dense"),
                  mt.hmc_state_from_numpy),
}


@pytest.mark.parametrize("name", list(JAX_LAYOUT))
def test_files_match_the_jax_package(tmp_path, name):
    """One adapted JAX chain on a small GLM, its state carried over with
    ``utils.convert``, saved by both packages' ``save_chain`` and
    ``save_task``: the same keys apart from ``key``, each ``leaf_i`` of the
    same shape, kind and value, the same samples, gradients, diagnostics,
    range, run time and meta.  The port's ``load_chain`` reads the JAX
    package's file to the same samples, diagnostics and range, and refuses
    its JAX key as a continuation with a clear message."""
    make, convert = JAX_LAYOUT[name]
    rng = np.random.default_rng(2)
    X = np.column_stack([np.ones(40), rng.standard_normal((40, 2))])
    Y = (rng.random(40) < 0.5).astype(np.float64)
    jm = mc.model(glm=("logistic", X, Y))
    tm = mt.model(glm=("logistic", X, Y), dtype=torch.float64, device="cpu")
    runner = mc.SerialMC(steps=40, burnin=20)
    jc = mc.run(jm * make(mc) * runner, seed=3)
    ts, truns = make(mt), mt.SerialMC(steps=40, burnin=20)
    state = convert(_as_dict(jax.device_get(jc.task.state)), device="cpu")
    if ts._kind == "dense":  # the dense accumulator carries its matrices
        assert state.mass.scale.shape == state.mass.m2.shape == (3, 3)
        np.testing.assert_array_equal(state.mass.scale.numpy(),
                                      np.asarray(jc.task.state.mass.scale))
        assert not np.allclose(state.mass.scale.numpy(), np.eye(3))
    task = mt.MCMCTask(tm, ts, truns, state=state,
                       key=make_generator("cpu", 0).get_state(),
                       pos=jc.task.pos)
    cols = list(jc.samples.columns)
    tc = MCMCChain(range=jc.range, samples=Table(jc.samples.values, cols),
                   gradients=Table(jc.gradients.values, cols),
                   diagnostics={k: np.asarray(v)
                                for k, v in jc.diagnostics.items()},
                   task=task, run_time=jc.run_time)
    for save_j, save_t, chain in ((jio.save_chain, save_chain, True),
                                  (jio.save_task, save_task, False)):
        pj, pt = tmp_path / f"jax_{chain}.npz", tmp_path / f"port_{chain}.npz"
        save_j(str(pj), jc if chain else jc.task)
        save_t(pt, tc if chain else task)
        fj, ft = np.load(pj), np.load(pt)
        assert set(fj.files) - {"key"} == set(ft.files) - {"key"}
        n_leaves = sum(k.startswith("leaf_") for k in fj.files)
        assert n_leaves == len(jax.tree_util.tree_leaves(jc.task.state))
        for k in fj.files:
            if k == "key":
                continue
            a, b = fj[k], ft[k]
            assert a.shape == b.shape, k
            assert a.dtype.kind == b.dtype.kind, k
            np.testing.assert_array_equal(a, b, err_msg=k)
    assert fj["key"].dtype == np.uint32 and ft["key"].dtype == np.uint8
    back = load_chain(tmp_path / "jax_True.npz")
    np.testing.assert_array_equal(back.samples.values, jc.samples.values)
    np.testing.assert_array_equal(back.gradients.values, jc.gradients.values)
    assert back.samples.columns == jc.samples.columns
    assert back.range == jc.range
    assert set(back.diagnostics) == set(jc.diagnostics)
    for k, v in jc.diagnostics.items():
        np.testing.assert_array_equal(back.diagnostics[k], np.asarray(v))
    with pytest.raises(ValueError, match="JAX package"):
        load_chain(tmp_path / "jax_True.npz",
                   mt.MCMCTask(tm, ts, truns))
