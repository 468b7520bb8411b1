"""mcmc_jl_tpu_torch — the PyTorch/CUDA port of ``mcmc_jl_tpu``.

The same ``chain = model * sampler * runner`` surface, on PyTorch tensors
and hand-written CUDA kernels for the H100.  Ported so far:
``model(glm=...)``, callable and ``~`` DSL models over the distribution
catalog; ``HMC`` (fixed step, EmpMCTuner, diagonal mass adaptation),
``HMCDA``, ``MALA``, exact ``NUTS``, ``ChEESHMC`` and ``RWM`` under
``SerialMC``; many chains through ``run(task, chains=N)`` with the fused
GLM-HMC kernels at any N (the N-tiled gradient kernel above 16384
observations), the warm-start pipeline (adaptive HMC/HMCDA/MALA and ChEES
through the Halton multistep kernel or the tiled kernel, exact NUTS through
the NUTS kernels) and the custom-target kernels on DSL models that are a
product of catalog densities (``ops.target_kernels``: plain HMC and MALA,
and the warm sampling phases of adaptive HMC/HMCDA/MALA and ChEES; exact
NUTS through ``ops.nuts_kernels.target_nuts_transition``; fused RWM in
``ops.rwm_kernels``); ``resume(list_of_chains)``, which re-batches a run's
chains and continues frozen HMC-family and exact-NUTS groups on the same
kernels; checkpoints (``utils.io``); and the chain statistics with the
cross-chain diagnostics ``rhat``, ``ess_pooled`` and ``summarize_chains``.  Models live on the CUDA
card unless ``device="cpu"`` is given.  It imports ``torch`` and never
``jax``.

Quick start::

    import mcmc_jl_tpu_torch as mt

    m = mt.model(glm=("logistic", X, Y))  # on the card
    chains = mt.run(m * mt.HMC(10, 0.05) * mt.SerialMC(steps=1000, burnin=200),
                    chains=4096)
    mt.acceptance(chains[0]); mt.describe(chains[0])
    nuts = mt.run(m * mt.NUTS(maxdoublings=6)
                  * mt.SerialMC(steps=1500, burnin=500), chains=4096)

    g = mt.model(lambda x: mt.tilde(x, mt.Gamma(3.0, 0.2)),
                 x=np.full(10, 1.1), gradient=True)  # custom-target kernel
    cs = mt.run(g * mt.HMC(10, 0.05) * mt.SerialMC(300, 100), chains=4096)
"""
from .models.model import model, LogDensityModel, GLMSpec
from .models.distributions import (
    Normal, Uniform, Weibull, Gamma, Cauchy, LogNormal, Binomial, Beta,
    Laplace, Bernoulli, TDist, Exponential, Poisson, MvNormal, Truncated,
    RightCensored, LeftCensored, Distribution, logpdf, logcdf, logccdf,
)
from .models.dsl import tilde, observe, acc, factor
from .core.task import MCMCTask
from .core.chain import MCMCChain
from .samplers import (HMC, HMCState, HMCDA, HMCDAState, EmpMCTuner, MALA,
                       MALAState, NUTS, NUTSState, RWM, RWMState, ChEESHMC,
                       ChEESState)
from .runners.serialmc import SerialMC
from .runners.api import run, resume, prun
from .stats import (
    mean, mcvar, mcse, var, std, ess, actime, acceptance, describe, rhat,
    ess_pooled, summarize_chains,
)
from .utils.convert import (chees_state_from_numpy, distribution_from_fields,
                            glm_model_from_spec, hmc_state_from_numpy,
                            hmcda_state_from_numpy, mala_state_from_numpy,
                            nuts_state_from_numpy, rwm_state_from_numpy)

__version__ = "0.1.0"

__all__ = [
    "model", "LogDensityModel", "GLMSpec", "MCMCTask", "MCMCChain",
    "HMC", "HMCState", "HMCDA", "HMCDAState", "EmpMCTuner", "MALA",
    "MALAState", "NUTS", "NUTSState", "RWM", "RWMState", "ChEESHMC",
    "ChEESState", "SerialMC", "run",
    "resume", "prun", "mean", "mcvar", "mcse", "var", "std", "ess",
    "actime", "acceptance", "describe", "rhat", "ess_pooled",
    "summarize_chains", "Normal", "Uniform", "Weibull",
    "Gamma", "Cauchy", "LogNormal", "Binomial", "Beta", "Laplace",
    "Bernoulli", "TDist", "Exponential", "Poisson", "MvNormal", "Truncated",
    "RightCensored", "LeftCensored", "Distribution", "logpdf", "logcdf",
    "logccdf", "tilde", "observe", "acc", "factor",
    "chees_state_from_numpy", "distribution_from_fields",
    "glm_model_from_spec",
    "hmc_state_from_numpy", "hmcda_state_from_numpy",
    "mala_state_from_numpy", "nuts_state_from_numpy",
    "rwm_state_from_numpy",
]
