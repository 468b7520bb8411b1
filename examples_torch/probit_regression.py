"""Bayesian probit regression with user-supplied gradient, metric tensor and
tensor derivatives, on the PyTorch port (reference:
examples/probit_regression.jl): the manifold-sampler workload (SMMALA,
PMALA and RMHMC need tensor/dtensor).

Loads the reference's own 39-row vaso dataset (examples/vaso.txt, vendored
verbatim: the reference's test fixture, probit_regression.jl:7-16);
``path=False`` synthesizes an equivalent 2-covariate binary dataset
instead.

Run on the CUDA card: ``python examples_torch/probit_regression.py``; on
the CPU: ``python examples_torch/probit_regression.py cpu``.
"""
import math
import os
import sys

import numpy as np
import torch

import mcmc_jl_tpu_torch as mt

LOG2PI = math.log(2 * math.pi)
VASO = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "examples", "vaso.txt")


def make_data(seed=3, n=39, path=VASO):
    if path:
        raw = np.loadtxt(path)
        covariates, y = raw[:, :-1], raw[:, -1]
    else:
        from scipy.special import ndtr

        rng = np.random.default_rng(seed)
        covariates = rng.standard_normal((n, 2)) * [1.0, 1.0] + [1.3, 1.7]
        z = 0.8 * covariates[:, 0] - 0.5 * covariates[:, 1] + 0.3
        y = (rng.random(n) < ndtr(z)).astype(float)
    nsamples, npars = covariates.shape
    covariates = (covariates - covariates.mean(0)) / covariates.std(0, ddof=1)
    X = np.column_stack([np.ones(nsamples), covariates])
    return X, y


def make_model(X, y, priorstd=10.0, seed=0, device=None, dtype=None):
    dt = dtype or torch.get_default_dtype()
    dev = torch.device(device or "cuda")
    X = torch.as_tensor(np.asarray(X), dtype=dt, device=dev)
    y = torch.as_tensor(np.asarray(y), dtype=dt, device=dev)
    npars = X.shape[1]
    priorvar = priorstd**2
    eye = torch.eye(npars, dtype=dt, device=dev)

    def logcdfn(z):
        return torch.special.log_ndtr(z)

    def log_posterior(pars):
        XPars = X @ pars
        loglik = logcdfn(XPars) @ y + logcdfn(-XPars) @ (1.0 - y)
        logprior = -0.5 * (pars @ pars) / priorvar - 0.5 * npars * (
            LOG2PI + 2 * math.log(priorstd)
        )
        return loglik + logprior

    # analytic derivatives, mirroring the reference's closed forms
    # (probit_regression.jl:36-67)
    def grad_log_posterior(pars):
        XPars = X @ pars
        t = torch.exp(-(XPars**2 + LOG2PI) / 2.0)
        v = (y * t * torch.exp(-logcdfn(XPars))
             - (1.0 - y) * t * torch.exp(-logcdfn(-XPars)))
        return X.T @ v - pars / priorvar

    def tensor(pars):
        XPars = X @ pars
        vec = torch.exp(-XPars**2 - logcdfn(XPars) - logcdfn(-XPars) - LOG2PI)
        return (X.T * vec) @ X + eye / priorvar

    def deriv_tensor(pars):
        XPars = X @ pars
        phi = torch.exp(-(XPars**2 + LOG2PI) / 2.0)
        Phi = torch.exp(logcdfn(XPars))
        v01 = torch.exp(-XPars**2 - 2 * logcdfn(XPars) - logcdfn(-XPars)
                        - LOG2PI)
        cols = []
        for i in range(npars):
            v02 = (
                v01
                * (torch.exp(-(XPars**2 + LOG2PI) / 2.0 - logcdfn(-XPars))
                   - 2.0 * (phi + XPars * Phi))
                * X[:, i]
            )
            cols.append((X.T * v02) @ X)
        return torch.stack(cols, dim=-1)  # (npars, npars, npars), dG[:, :, i]

    rng = np.random.default_rng(seed)
    init = rng.standard_normal(npars) * priorstd * 0.1
    return mt.model(
        log_posterior,
        grad=grad_log_posterior,
        tensor=tensor,
        dtensor=deriv_tensor,
        init=init,
        device=dev,
        dtype=dt,
    )


def main(device=None):
    X, y = make_data()
    m = make_model(X, y, device=device)

    chain01 = mt.run(m * mt.RWM(0.5) * mt.SerialMC(range(1001, 10001)))
    print("RWM acceptance:", mt.acceptance(chain01))

    chain02 = mt.run(m * mt.HMC(0.1) * mt.SerialMC(range(1001, 10001)))
    print("HMC acceptance:", mt.acceptance(chain02))

    chain03 = mt.run(
        m * mt.SMMALA(0.5) * mt.SerialMC(range(1001, 10001))
    )
    print("SMMALA acceptance:", mt.acceptance(chain03))

    chain04 = mt.run(
        m * mt.RMHMC(0.5, mt.EmpMCTuner(0.8, verbose=True))
        * mt.SerialMC(range(5001, 10001))
    )
    print("RMHMC acceptance:", mt.acceptance(chain04))
    return chain04


if __name__ == "__main__":
    main(*sys.argv[1:2])
