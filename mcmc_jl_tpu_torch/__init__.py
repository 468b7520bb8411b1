"""mcmc_jl_tpu_torch — the PyTorch/CUDA port of ``mcmc_jl_tpu``.

The same ``chain = model * sampler * runner`` surface, on PyTorch tensors
and hand-written CUDA kernels for the H100.  Ported so far:
``model(glm=...)``/callable models, fixed-step ``HMC`` and exact ``NUTS``
under ``SerialMC``, many chains through ``run(task, chains=N)``, the fused
GLM-HMC kernels, the fused exact-NUTS kernels behind the warm-start
pipeline, and the chain statistics.  It imports ``torch`` and never
``jax``.

Quick start::

    import mcmc_jl_tpu_torch as mt

    m = mt.model(glm=("logistic", X, Y), device="cuda")
    chains = mt.run(m * mt.HMC(10, 0.05) * mt.SerialMC(steps=1000, burnin=200),
                    chains=4096)
    mt.acceptance(chains[0]); mt.describe(chains[0])
    nuts = mt.run(m * mt.NUTS(maxdoublings=6)
                  * mt.SerialMC(steps=1500, burnin=500), chains=4096)
"""
from .models.model import model, LogDensityModel, GLMSpec
from .core.task import MCMCTask
from .core.chain import MCMCChain
from .samplers import HMC, HMCState, EmpMCTuner, NUTS, NUTSState
from .runners.serialmc import SerialMC
from .runners.api import run, resume, prun
from .stats import (
    mean, mcvar, mcse, var, std, ess, actime, acceptance, describe,
)
from .utils.convert import (glm_model_from_spec, hmc_state_from_numpy,
                            nuts_state_from_numpy)

__version__ = "0.1.0"

__all__ = [
    "model", "LogDensityModel", "GLMSpec", "MCMCTask", "MCMCChain",
    "HMC", "HMCState", "EmpMCTuner", "NUTS", "NUTSState", "SerialMC", "run",
    "resume", "prun",
    "mean", "mcvar", "mcse", "var", "std", "ess", "actime", "acceptance",
    "describe", "glm_model_from_spec", "hmc_state_from_numpy",
    "nuts_state_from_numpy",
]
