"""Fitting an Ornstein-Uhlenbeck process on the PyTorch port (reference:
examples/ornstein.jl).

Uniform priors on (tau, sigma, mu); AR(1)-style residual likelihood; the
model's scale hint helps the RWM-family samplers (m.scale, reference
ornstein.jl:31).  The likelihood carries the series as data, so every
sampler here runs on the generic engine: the custom-target kernels take
products of catalog densities over the parameters, not data-bearing
targets.

Run on the CUDA card: ``python examples_torch/ornstein.py``; on the CPU:
``python examples_torch/ornstein.py cpu``.
"""
import sys

import numpy as np
import torch

import mcmc_jl_tpu_torch as mt


def make_series(seed=1, duration=1000, mu0=10.0, tau0=20.0, sigma0=0.1):
    rng = np.random.default_rng(seed)
    x = np.empty(duration)
    x[0] = 1.0
    f = np.exp(-1.0 / tau0)
    for i in range(1, duration):
        x[i] = x[i - 1] * f + mu0 * (1 - f) + sigma0 * rng.standard_normal()
    return x


def make_model(x, gradient=True, device=None, dtype=None):
    dt = dtype or torch.get_default_dtype()
    dev = torch.device(device or "cuda")
    xt = torch.as_tensor(np.asarray(x), dtype=dt, device=dev)

    def ex(tau, sigma, mu):
        mt.tilde(tau, mt.Uniform(0.0, 100.0))
        mt.tilde(sigma, mt.Uniform(0.0, 2.0))
        mt.tilde(mu, mt.Uniform(0.0, 20.0))
        fac = torch.exp(-1.0 / tau)
        resid = xt[1:] - xt[:-1] * fac - mu * (1.0 - fac)
        mt.tilde(resid, mt.Normal(0.0, sigma))

    m = mt.model(ex, tau=0.05, sigma=1.0, mu=1.0, gradient=gradient,
                 device=dev, dtype=dt)
    # scale hint for tau, sigma and mu, to help sampling (ornstein.jl:31)
    return m.with_scale([1000.0, 1.0, 10.0])


def main(device=None):
    x = make_series()
    m = make_model(x, device=device)

    chain01 = mt.run(m * mt.RAM() * mt.SerialMC(range(1000, 10001)))
    mt.describe(chain01)
    print("RAM acceptance:", mt.acceptance(chain01))

    chain02 = mt.run(m * mt.HMC(5, 0.002) * mt.SerialMC(range(1000, 10001)))
    print("HMC acceptance:", mt.acceptance(chain02))

    chain03 = mt.run(m * mt.NUTS() * mt.SerialMC(range(500, 1001)))
    print("NUTS ndoublings mean:", chain03.diagnostics["ndoublings"].mean())
    return chain01


if __name__ == "__main__":
    main(*sys.argv[1:2])
