"""Adaptive HMC at fused-kernel speed on the PyTorch port: the warm-start
pipeline.

The realistic production run (tuner step-size adaptation plus a diagonal
mass metric during burn-in, then a long sampling phase) goes through
``run(task, chains=N)``: burn-in runs on the generic engine with the
sampler's own adaptation, the frozen hyper-parameters drive the Halton
multistep CUDA kernel for the sampling phase (ops/warmstart.py), and the
chains come back with the standard protocol (exact resume included).
``chip_smoke.py``'s ``phase_examples`` runs ``main`` at 4096 chains on the
card and prints its leapfrog/s and ESS/s (``utils.profiling``).  On the CPU
(``device="cpu"``) the run takes the generic engine, at test-sized
shapes.

Run on the CUDA card: ``python examples_torch/warmstart_logistic.py``; on
the CPU: ``python examples_torch/warmstart_logistic.py cpu``.
"""
import sys

import numpy as np
import torch

import mcmc_jl_tpu_torch as mt


def make_data(n=1000, nbeta=10, seed=1):
    rng = np.random.default_rng(seed)
    X = np.column_stack([np.ones(n), rng.standard_normal((n, nbeta - 1))])
    beta0 = rng.standard_normal(nbeta)
    Y = (rng.random(n) < 1.0 / (1.0 + np.exp(-X @ beta0))).astype(np.float64)
    return X, Y, beta0


def main(n=1000, nbeta=10, chains=8, steps=2000, burnin=500, device=None):
    X, Y, beta0 = make_data(n, nbeta)
    model = mt.model(glm=("logistic", X, Y),
                     device=torch.device(device or "cuda"))

    # EmpMCTuner adapts the step size toward 80% acceptance during burn-in
    # (reference samplers.jl:31-50); mass_adapt="diag" adds a Welford
    # diagonal metric (beyond the reference).  Both freeze at the end of
    # burn-in, which is exactly what lets the sampling phase run fused.
    sampler = mt.HMC(10, 0.02, mt.EmpMCTuner(0.8, adapt_step=50),
                     mass_adapt="diag")
    task = model * sampler * mt.SerialMC(steps=steps, burnin=burnin)

    chains_out = mt.run(task, chains=chains, seed=0)
    acc = np.mean([mt.acceptance(c) for c in chains_out])
    ess = np.mean([np.mean(mt.ess(c)) for c in chains_out])
    print(f"acceptance {acc:.1f}%  mean ESS {ess:.0f} per chain")

    pooled = np.mean([c.samples.values.mean(0) for c in chains_out], axis=0)
    print("posterior mean (first 4):", np.round(pooled[:4], 3))
    print("truth          (first 4):", np.round(beta0[:4], 3))

    # exact resume at the frozen hyper-parameters
    more = mt.resume(chains_out[0], steps=200)
    print("resumed rows:", more.samples.shape[0])
    return chains_out


if __name__ == "__main__":
    main(device=(sys.argv[1] if sys.argv[1:] else None))
