"""Parallel multi-chain run on the PyTorch port (reference:
examples/parallel_serialmc.jl).

The reference farms 10 HMC chains to Julia worker processes with ``prun``;
here the same 10 chains are one batch split over a mesh of the visible
CUDA cards (``parallel.default_mesh``), each shard on its own card.

Run on the CUDA cards: ``python examples_torch/parallel_serialmc.py``; on
the CPU: ``python examples_torch/parallel_serialmc.py cpu``.
"""
import sys

import numpy as np
import torch

import mcmc_jl_tpu_torch as mt
from mcmc_jl_tpu_torch.parallel import default_mesh


def make_model(device=None, dtype=None):
    return mt.model(lambda v: -(v * v).sum(), grad=lambda v: -2 * v,
                    init=np.ones(3), device=torch.device(device or "cuda"),
                    dtype=dtype)


def make_tasks(mymodel, n=10, steps=50000, burnin=5000):
    return mymodel * [mt.HMC(0.75) for _ in range(n)] * mt.SerialMC(
        steps=steps, burnin=burnin)


def main(device=None, steps=50000, burnin=5000):
    mymodel = make_model(device)
    mytasks = make_tasks(mymodel, steps=steps, burnin=burnin)
    # every visible card, or the one device asked for
    mesh = default_mesh(devices=None if device is None else [device])
    mychains = mt.prun(mytasks, mesh=mesh)
    print([mt.acceptance(chain) for chain in mychains])
    return mychains


if __name__ == "__main__":
    main(*sys.argv[1:2])
