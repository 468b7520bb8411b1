"""Parallelism layer: chain batches, device meshes and the reductions
between their shards (reference equivalent: Julia Distributed ``pmap``,
runners.jl:35-42)."""
from .pchains import (run_chains, init_chains, prun_serialmc, default_mesh,
                      CHAIN_AXIS)

__all__ = ["run_chains", "init_chains", "prun_serialmc", "default_mesh",
           "CHAIN_AXIS"]
