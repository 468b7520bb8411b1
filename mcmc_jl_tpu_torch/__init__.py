"""mcmc_jl_tpu_torch — the PyTorch/CUDA port of ``mcmc_jl_tpu``.

The same ``chain = model * sampler * runner`` surface, on PyTorch tensors
and hand-written CUDA kernels for the H100.  Ported so far:
``model(glm=...)``, callable and ``~`` DSL models over the distribution
catalog, with the metric tensors of ``tensor=``/``dtensor=``; ``HMC``
(fixed step, EmpMCTuner, diagonal and dense mass adaptation), ``HMCDA``,
``MALA``, exact ``NUTS``, ``WALNUTS``, ``ChEESHMC``, ``RWM``, ``Barker``,
``IMH`` and ``RAM``, and the manifold tier ``SMMALA``, ``PMALA``,
``RMHMC``, ``ERMLMC`` and ``RMLMC`` under ``SerialMC``, the ensemble
runners ``SeqMC``, ``SerialTempMC``, ``PTMC``, ``AIES`` and ``ASMC``, the
convergence-gated ``run_until`` (its frozen blocks through the fused
continuation), and the standalone ``slice_sample``; many chains through
``run(task, chains=N)`` with the fused GLM-HMC kernels at any N (the N-tiled gradient kernel above 16384
observations), the warm-start pipeline (adaptive HMC/HMCDA/MALA and ChEES
through the Halton multistep kernel or the tiled kernel, exact NUTS through
the NUTS kernels) and the custom-target kernels on DSL models that are a
product of catalog densities (``ops.target_kernels``: plain HMC and MALA,
and the warm sampling phases of adaptive HMC/HMCDA/MALA and ChEES; exact
NUTS through ``ops.nuts_kernels.target_nuts_transition``; fused RWM in
``ops.rwm_kernels``); ``resume(list_of_chains)``, which re-batches a run's
chains and continues frozen HMC-family and exact-NUTS groups on the same
kernels; checkpoints (``utils.io``); and the chain statistics with the
cross-chain diagnostics ``rhat``, ``ess_pooled`` and ``summarize_chains``,
the zero-variance estimators, WAIC and PSIS-LOO, and the evidence
estimators.  Barker, WALNUTS, IMH, RAM and the manifold tier run on the
generic engine (the manifold tier's metric algebra as batched
``torch.linalg`` over chains); on a float32 catalog model on the card every
gradient they take is one launch of the custom-target gradient pass.  Models live on the CUDA
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
from .models import distributions
from .models.dsl import tilde, observe, acc, factor
from .core.task import MCMCTask
from .core.chain import MCMCChain
from .samplers import (HMC, HMCState, HMCDA, HMCDAState, EmpMCTuner, MALA,
                       MALAState, NUTS, NUTSState, RWM, RWMState, ChEESHMC,
                       ChEESState, Barker, BarkerState, IMH, IMHState, RAM,
                       RAMState, WALNUTS, SMMALA, SMMALAState, PMALA,
                       PMALAState, RMHMC, RMHMCState, ERMLMC, RMLMC, LMCState,
                       slice_sample)
from .runners import (SerialMC, SeqMC, SerialTempMC, PTMC, AIES, ASMC, run,
                      resume, prun, run_until, ConvergenceResult)
from .stats import (
    mean, mean_rb, mcvar, mcse, var, std, ess, actime, acceptance, describe,
    wsample, linear_zv, quadratic_zv, linearZv, quadraticZv, rhat,
    ess_pooled, summarize_chains, mcmc_quantile, logz_ti, logz_ss,
    pointwise_loglik, waic, psis_loo,
)
from .stats import compare as compare_elpd
from .utils.convert import (barker_state_from_numpy, chees_state_from_numpy,
                            distribution_from_fields, ensemble_from_numpy,
                            glm_model_from_spec, seqmc_state_from_numpy,
                            serialtempmc_state_from_numpy,
                            hmc_state_from_numpy, hmcda_state_from_numpy,
                            imh_state_from_numpy, lmc_state_from_numpy,
                            mala_state_from_numpy, nuts_state_from_numpy,
                            pmala_state_from_numpy, ram_state_from_numpy,
                            rmhmc_state_from_numpy, rwm_state_from_numpy,
                            smmala_state_from_numpy)

# legacy alias matching the reference's MCMCLikModel typealias (likmodel.jl:69)
MCMCLikModel = LogDensityModel

__version__ = "0.1.0"

__all__ = [
    "model", "LogDensityModel", "MCMCLikModel", "GLMSpec", "MCMCTask",
    "MCMCChain", "distributions",
    "HMC", "HMCState", "HMCDA", "HMCDAState", "EmpMCTuner", "MALA",
    "MALAState", "NUTS", "NUTSState", "RWM", "RWMState", "ChEESHMC",
    "ChEESState", "Barker", "BarkerState", "IMH", "IMHState", "RAM",
    "RAMState", "WALNUTS", "SMMALA", "SMMALAState", "PMALA", "PMALAState",
    "RMHMC", "RMHMCState", "ERMLMC", "RMLMC", "LMCState", "slice_sample",
    "SerialMC", "SeqMC", "SerialTempMC", "PTMC", "AIES", "ASMC",
    "run_until", "ConvergenceResult", "run", "resume", "prun", "mean", "mean_rb", "mcvar", "mcse", "var", "std",
    "ess", "actime", "acceptance", "describe", "wsample", "linear_zv",
    "quadratic_zv", "linearZv", "quadraticZv", "rhat", "ess_pooled",
    "summarize_chains", "mcmc_quantile", "logz_ti", "logz_ss",
    "pointwise_loglik", "waic", "psis_loo", "compare_elpd",
    "Normal", "Uniform", "Weibull",
    "Gamma", "Cauchy", "LogNormal", "Binomial", "Beta", "Laplace",
    "Bernoulli", "TDist", "Exponential", "Poisson", "MvNormal", "Truncated",
    "RightCensored", "LeftCensored", "Distribution", "logpdf", "logcdf",
    "logccdf", "tilde", "observe", "acc", "factor",
    "barker_state_from_numpy", "chees_state_from_numpy",
    "distribution_from_fields", "glm_model_from_spec",
    "hmc_state_from_numpy", "hmcda_state_from_numpy",
    "imh_state_from_numpy", "mala_state_from_numpy",
    "nuts_state_from_numpy", "ram_state_from_numpy",
    "rwm_state_from_numpy", "smmala_state_from_numpy",
    "pmala_state_from_numpy", "rmhmc_state_from_numpy",
    "lmc_state_from_numpy", "ensemble_from_numpy", "seqmc_state_from_numpy",
    "serialtempmc_state_from_numpy",
]
