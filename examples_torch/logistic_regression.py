"""Bayesian logistic regression, 1000 observations x 10 covariates, on the
PyTorch port (reference: examples/logistic_regression.jl): the benchmark
workload (BASELINE.md "binomial 10x1000").

Run on the CUDA card: ``python examples_torch/logistic_regression.py``; on
the CPU: ``python examples_torch/logistic_regression.py cpu``.
"""
import sys

import numpy as np
import torch

import mcmc_jl_tpu_torch as mt


def make_data(seed=1, n=1000, nbeta=10):
    rng = np.random.default_rng(seed)
    X = np.column_stack([np.ones(n), rng.standard_normal((n, nbeta - 1))])
    beta0 = rng.standard_normal(nbeta)
    Y = (rng.random(n) < 1.0 / (1.0 + np.exp(-X @ beta0))).astype(np.float64)
    return X, Y, beta0


def make_model(X, Y, nbeta=10, gradient=True, device=None, dtype=None):
    dt = dtype or torch.get_default_dtype()
    dev = torch.device(device or "cuda")
    Xt = torch.as_tensor(X, dtype=dt, device=dev)
    Yt = torch.as_tensor(Y, dtype=dt, device=dev)

    def ex(vars):
        mt.tilde(vars, mt.Normal(0.0, 1.0))  # Normal prior
        prob = 1.0 / (1.0 + torch.exp(-(Xt @ vars)))
        mt.tilde(Yt, mt.Bernoulli(prob))

    return mt.model(ex, gradient=gradient, device=dev, dtype=dt,
                    vars=np.zeros(nbeta))


def main(device=None):
    X, Y, beta0 = make_data()
    m = make_model(X, Y, device=device)

    chain01 = mt.run(m * mt.RWM(0.05) * mt.SerialMC(range(1000, 10001)))
    mt.describe(chain01)

    chain02 = mt.run(m * mt.HMC(2, 0.1) * mt.SerialMC(range(1000, 10001)))
    print("HMC acceptance:", mt.acceptance(chain02))

    chain03 = mt.run(m * mt.NUTS() * mt.SerialMC(range(1000, 10001)))
    print("NUTS var:", mt.var(chain03))
    return chain03


if __name__ == "__main__":
    main(*sys.argv[1:2])
