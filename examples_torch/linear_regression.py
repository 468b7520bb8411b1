"""Linear regression, 1000 observations x 10 covariates, on the PyTorch
port (reference: examples/linear_regression.jl).

Model: Normal prior on the coefficients, Gaussian residuals; run RWM
without and RAM with adaptation, and compare the posterior mean with the
generating coefficients.

Run on the CUDA card: ``python examples_torch/linear_regression.py``; on
the CPU: ``python examples_torch/linear_regression.py cpu``.
"""
import sys

import numpy as np
import torch

import mcmc_jl_tpu_torch as mt


def make_data(seed=1, n=1000, nbeta=10):
    """The simulated dataset: X with an intercept column, the generating
    coefficients ``beta0``, Y = X beta0 + N(0, 1) noise (numpy)."""
    rng = np.random.default_rng(seed)
    X = np.column_stack([np.ones(n), rng.standard_normal((n, nbeta - 1))])
    beta0 = rng.standard_normal(nbeta)
    Y = X @ beta0 + rng.standard_normal(n)
    return X, Y, beta0


def make_model(X, Y, gradient=False, device=None, dtype=None):
    """The reference's quote block as a ``~`` DSL function, on ``device``
    (the CUDA card by default)."""
    dt = dtype or torch.get_default_dtype()
    dev = torch.device(device or "cuda")
    Xt = torch.as_tensor(X, dtype=dt, device=dev)
    Yt = torch.as_tensor(Y, dtype=dt, device=dev)

    def ex(vars):
        mt.tilde(vars, mt.Normal(0.0, 1.0))  # Normal prior, std 1.0
        resid = Yt - Xt @ vars
        mt.tilde(resid, mt.Normal(0.0, 1.0))

    return mt.model(ex, gradient=gradient, device=dev, dtype=dt,
                    vars=np.zeros(X.shape[1]))


def main(device=None):
    X, Y, beta0 = make_data()
    m = make_model(X, Y, device=device)

    # random-walk metropolis, thinning 10, no adaptation
    chain01 = mt.run(m * mt.RWM(0.05) * mt.SerialMC(range(10000, 100001, 10)))
    print("RWM acceptance:", mt.acceptance(chain01))  # ~ 3%, too low

    # with adaptation (target acceptance = 30%)
    chain02 = mt.run(m * mt.RAM(1.0, 0.3)
                     * mt.SerialMC(range(10000, 100001, 10)))
    print("RAM acceptance:", mt.acceptance(chain02))  # ~ 30%

    print("posterior mean vs original coefs:")
    print(np.column_stack([mt.mean(chain02), beta0]))
    return chain02


if __name__ == "__main__":
    main(*sys.argv[1:2])
