"""The port's ~ DSL (mcmc_jl_tpu_torch/models/dsl.py and the DSL mode of
models/model.py) against the JAX package's on the same model functions
written twice: the parameter layout (1-based offsets, column-major
matrices, column names), unravel/ravel, eval/evalallg (-inf and a zero
gradient out of support), the statements outside a model, and the
``target_spec`` that routes catalog models to the custom-target kernels.

Tolerance: rtol 1e-6 in float64 (same operations in both packages)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mcmc_jl_tpu as mc
import mcmc_jl_tpu_torch as mt
from mcmc_jl_tpu.models.model import _model_vars as jax_model_vars
from mcmc_jl_tpu_torch.models.model import _model_vars

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _float64():
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(old)


@pytest.mark.parametrize("params", [
    {"x": 3.0}, {"x": 3.0, "y": [1.0, 2.0]},
    {"x": 3.0, "y": [[1.0, 2.0], [3.0, 4.0]]},
    {"a": [[1.0, 2.0, 3.0], [4.0, 5.0, 6.0]], "b": 0.5, "c": [7.0]}])
def test_model_vars_layout_matches_jax(params):
    """modelVars (reference expr_funcs.jl:76-91): the golden layouts of
    tests/test_dsl.py, and the same (size, pmap, init) as the JAX package."""
    size, pmap, init = _model_vars(params)
    jsize, jpmap, jinit = jax_model_vars(params)
    assert size == jsize and pmap == jpmap
    np.testing.assert_array_equal(init, jinit)


def _pair(fn_j, fn_t, **params):
    mj = mc.model(fn_j, gradient=True, check_init=False, **params)
    mt_ = mt.model(fn_t, gradient=True, check_init=False, device="cpu",
                   **params)
    return mj, mt_


def test_unravel_ravel_column_names_match_jax():
    def fj(x, y, z):
        mc.tilde(x, mc.Normal(0.0, 1.0))
        mc.tilde(y, mc.Normal(0.0, 1.0))
        mc.tilde(z, mc.Normal(0.0, 1.0))

    def ft(x, y, z):
        mt.tilde(x, mt.Normal(0.0, 1.0))
        mt.tilde(y, mt.Normal(0.0, 1.0))
        mt.tilde(z, mt.Normal(0.0, 1.0))

    y = np.array([[1.0, 2.0, 3.0], [4.0, 5.0, 6.0]])
    mj, mtt = _pair(fj, ft, x=1.0, y=y, z=[0.5, -0.5])
    assert mtt.pmap == mj.pmap and mtt.size == mj.size == 9
    assert mtt.column_names() == mj.column_names()
    np.testing.assert_array_equal(mtt.init.numpy(), np.asarray(mj.init))
    vj, vt = mj.unravel(mj.init), mtt.unravel(mtt.init)
    for k in vj:
        np.testing.assert_array_equal(vt[k].numpy(), np.asarray(vj[k]))
    np.testing.assert_array_equal(vt["y"].numpy(), y)
    theta = mtt.ravel({"x": 1.0, "y": y, "z": [0.5, -0.5]})
    np.testing.assert_array_equal(theta.numpy(), np.asarray(
        mj.ravel({"x": 1.0, "y": y, "z": np.array([0.5, -0.5])})))
    # batched unravel: a leading chain dimension
    batch = torch.stack([mtt.init, 2 * mtt.init])
    np.testing.assert_array_equal(mtt.unravel(batch)["y"][1].numpy(), 2 * y)


def test_eval_and_gradient_match_jax():
    """A model with derived quantities, data and censoring: eval/evalallg
    against JAX at points in and out of support."""
    rng = np.random.default_rng(0)
    X, Y = rng.standard_normal((12, 3)), rng.standard_normal(12)
    Xt, Yt = torch.as_tensor(X), torch.as_tensor(Y)

    def fj(beta, logs, nu):
        mc.tilde(beta, mc.Normal(0.0, 2.0))
        mc.tilde(nu, mc.Gamma(2.0, 1.0))
        mc.tilde(jnp.asarray(Y), mc.Normal(jnp.asarray(X) @ beta,
                                           jnp.exp(logs)))
        mc.tilde(jnp.asarray(1.5), +mc.Exponential(nu))
        mc.acc(-0.5 * logs ** 2)

    def ft(beta, logs, nu):
        mt.tilde(beta, mt.Normal(0.0, 2.0))
        mt.tilde(nu, mt.Gamma(2.0, 1.0))
        mt.tilde(Yt, mt.Normal(Xt @ beta, torch.exp(logs)))
        mt.tilde(torch.tensor(1.5), +mt.Exponential(nu))
        mt.acc(-0.5 * logs ** 2)

    mj, mtt = _pair(fj, ft, beta=np.zeros(3), logs=0.0, nu=1.0)
    assert mtt.target_spec is None
    pts = np.array([[0.1, -0.2, 0.3, 0.1, 1.2], [1.0, 0.5, -1.0, -0.3, 0.4],
                    [0.1, -0.2, 0.3, 0.1, -0.5]])  # last: nu < 0
    for p in pts:
        lj, gj = mj.evalallg(jnp.asarray(p))
        lt, gt = mtt.evalallg(torch.as_tensor(p))
        if np.isfinite(float(lj)):
            np.testing.assert_allclose(float(lt), float(lj), rtol=1e-6)
            np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-6,
                                       atol=1e-12)
        else:
            assert float(lt) == -np.inf and not gt.any()
        np.testing.assert_allclose(float(mtt.eval(torch.as_tensor(p))),
                                   float(mj.eval(jnp.asarray(p))), rtol=1e-6)
    # chains on a leading dimension
    lt, gt = mtt.evalallg(torch.as_tensor(pts))
    assert lt.shape == (3,) and gt.shape == (3, 5)
    assert lt[2] == -np.inf and not gt[2].any()


def test_statements_outside_a_model_raise():
    with pytest.raises(RuntimeError, match="outside a model"):
        mt.tilde(torch.tensor(1.0), mt.Normal(0.0, 1.0))
    with pytest.raises(RuntimeError, match="outside a model"):
        mt.acc(1.0)


def test_target_spec_for_a_catalog_model():
    """Each parameter itself ~ a kernel-row family, once: the spec's
    log-density equals eval at init and elsewhere, row by row."""
    def f(x, s, w):
        mt.tilde(x, mt.Gamma(3.0, 0.2))
        mt.tilde(s, mt.Normal(1.0, 2.0))
        mt.tilde(w, mt.Beta(2.0, 3.0))

    m = mt.model(f, x=np.full(4, 0.6), s=0.5, w=np.full((2, 2), 0.3),
                 gradient=True, device="cpu")
    spec = m.target_spec
    assert spec is not None and spec.d == m.size == 9 and spec.has_rows
    codes, params = spec.rows("cpu")
    assert codes.tolist() == [3] * 4 + [0] + [7] * 4
    assert params.shape == (9, 4) and params.dtype == torch.float32
    th = torch.as_tensor(np.random.default_rng(1).uniform(0.1, 0.9, (5, 9)))
    np.testing.assert_allclose(spec(th)[:, 0].numpy(), m.eval(th).numpy(),
                               rtol=1e-12)


@pytest.mark.parametrize("kind", ["derived", "acc", "tensor_params", "twice",
                                  "untouched", "data", "callable"])
def test_target_spec_is_none_otherwise(kind):
    v = torch.tensor(2.0)

    def derived(x):
        y = x * v
        mt.tilde(y, mt.Gamma(3.0, 0.2))

    def with_acc(x):
        mt.tilde(x, mt.Gamma(3.0, 0.2))
        mt.acc(-x.sum())

    def tensor_params(x):
        mt.tilde(x, mt.Normal(torch.zeros(3), 1.0))

    def twice(x):
        mt.tilde(x, mt.Normal(0.0, 1.0))
        mt.tilde(x, mt.Normal(1.0, 1.0))

    def untouched(x, y):
        mt.tilde(x, mt.Normal(0.0, 1.0))

    def data(x):
        mt.tilde(x, mt.Normal(0.0, 1.0))
        mt.tilde(torch.tensor([0.3, 0.4]), mt.Normal(x[0], 1.0))

    if kind == "callable":
        m = mt.model(lambda th: -(th * th).sum(), init=np.ones(3),
                     gradient=True, device="cpu")
    else:
        fn = {"derived": derived, "acc": with_acc,
              "tensor_params": tensor_params, "twice": twice,
              "untouched": untouched, "data": data}[kind]
        extra = {"y": 1.0} if kind == "untouched" else {}
        m = mt.model(fn, x=np.full(3, 0.5), gradient=True, device="cpu",
                     **extra)
    assert m.target_spec is None
    assert np.isfinite(float(m.eval(m.init)))
