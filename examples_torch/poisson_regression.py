"""Poisson regression with exposure offsets via the GLM fast path, on the
PyTorch port.

Counts with unequal exposure windows: y_i ~ Poisson(E_i * exp(x_i' beta)),
a log-link GLM with offset log(E_i), the canonical use of
``model(glm=..., offsets=...)``.  The same model object runs on every
sampler; multi-chain ``run(..., chains=N)`` routes plain HMC to the fused
CUDA trajectory kernel on the card.

(The reference has no GLM front end; its closest workload is the logistic
example, examples/logistic_regression.jl.)

Run on the CUDA card: ``python examples_torch/poisson_regression.py``; on
the CPU: ``python examples_torch/poisson_regression.py cpu``.
"""
import sys

import numpy as np
import torch

import mcmc_jl_tpu_torch as mt


def make_data(n=400, seed=7):
    rng = np.random.default_rng(seed)
    X = np.column_stack([np.ones(n), rng.standard_normal((n, 2))])
    beta = np.array([0.4, 0.8, -0.5])
    exposure = rng.uniform(0.5, 4.0, n)  # observation windows
    lam = exposure * np.exp(X @ beta)
    Y = rng.poisson(lam).astype(np.float64)
    return X, Y, np.log(exposure), beta


def make_model(X, Y, log_exposure, device=None, dtype=None):
    return mt.model(glm=("poisson", X, Y), offsets=log_exposure,
                    prior_prec=0.01, device=torch.device(device or "cuda"),
                    dtype=dtype)


def main(device=None):
    X, Y, log_e, beta_true = make_data()
    m = make_model(X, Y, log_e, device=device)

    chain = mt.run(m * mt.NUTS(mass_adapt="dense")
                   * mt.SerialMC(steps=3000, burnin=1000), seed=0)
    est = chain.samples.values.mean(axis=0)
    se = np.sqrt(mt.var(chain))
    print("acceptance %:", mt.acceptance(chain))
    for i, (b, e, s) in enumerate(zip(beta_true, est, se)):
        print(f"beta[{i}]: true {b:+.3f}  posterior {e:+.3f} +- {s:.4f}")
    mt.describe(chain)
    return chain


if __name__ == "__main__":
    main(*sys.argv[1:2])
