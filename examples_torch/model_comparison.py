"""Bayesian model comparison on the PyTorch port: marginal likelihoods and
a Bayes factor.

Two nested models for the same data y (n = 40 draws from N(0.8, 1)):

  M1: y_i ~ N(theta, 1), theta ~ N(0, 1)   (has a location parameter)
  M0: y_i ~ N(0, 1)                         (fixed null, logZ = loglik)

log Z(M1) is estimated three independent ways:
  * thermodynamic integration  (``mt.logz_ti``, a prior-tempered PTMC ladder)
  * stepping-stone             (``mt.logz_ss``, the same run)
  * adaptive annealed SMC      (``ASMC``'s diagnostics["logz"])
and checked against the analytic conjugate evidence.  The Bayes factor
log BF10 = logZ(M1) - logZ(M0) then measures the evidence for a nonzero
mean.

Run on the CUDA card: ``python examples_torch/model_comparison.py``; on
the CPU: ``python examples_torch/model_comparison.py cpu``.
"""
import sys

import numpy as np
import torch

import mcmc_jl_tpu_torch as mt

L2PI = float(np.log(2 * np.pi))

# data
rng = np.random.default_rng(7)
n = 40
y = rng.standard_normal(n) + 0.8
_YD = {}  # y as a tensor, one copy a (device, dtype)


def _yd(th):
    key = (th.device, th.dtype)
    if key not in _YD:
        _YD[key] = torch.as_tensor(y, dtype=th.dtype, device=th.device)
    return _YD[key]


def logprior(th):  # normalized N(0,1) prior on theta
    return -0.5 * th[0] ** 2 - 0.5 * L2PI


def logp(th):  # full posterior kernel WITH normalization constants
    return -0.5 * ((_yd(th) - th[0]) ** 2).sum() - n / 2 * L2PI + logprior(th)


def prior_sample(generator, k):
    """``k`` draws of the N(0, 1) prior, (k, 1), on the generator's device."""
    return torch.randn((k, 1), generator=generator, device=generator.device)


def analytic_logz():
    sy, yy = y.sum(), (y * y).sum()
    return -n / 2 * L2PI - 0.5 * np.log(1.0 + n) \
        - 0.5 * (yy - sy ** 2 / (1.0 + n))


def make_model(device=None, dtype=None):
    """M1 on ``device`` (the CUDA card by default)."""
    return mt.model(logp, gradient=True, init=np.zeros(1),
                    device=torch.device(device or "cuda"), dtype=dtype)


def main(device=None):
    m1 = make_model(device)

    # --- TI + stepping-stone from one prior-tempered PTMC run
    betas = tuple(float((k / 9) ** 5) for k in range(10))
    chain = mt.run(
        m1 * mt.HMC(5, 0.3) * mt.PTMC(steps=6000, burnin=1000, betas=betas,
                                      logprior=logprior),
        seed=0,
    )
    ti = mt.logz_ti(chain, burnin=1000)
    ss = mt.logz_ss(chain, burnin=1000)

    # --- annealed SMC (adaptive temperature ladder; logZ for free)
    smc = mt.run(
        m1 * mt.HMC(5, 0.3) * mt.ASMC(particles=4096, moves=2,
                                      logprior=logprior,
                                      prior_sample=prior_sample),
        seed=1,
    )

    exact = analytic_logz()
    logz_m0 = float(-0.5 * ((y ** 2).sum()) - n / 2 * L2PI)  # null: theta=0

    print(f"logZ(M1) exact             {exact:10.4f}")
    print(f"logZ(M1) thermo int.       {ti:10.4f}")
    print(f"logZ(M1) stepping-stone    {ss:10.4f}")
    print(f"logZ(M1) annealed SMC      {smc.diagnostics['logz']:10.4f}  "
          f"({smc.diagnostics['n_stages']} adaptive stages)")
    print(f"logZ(M0) analytic          {logz_m0:10.4f}")
    print(f"log BF10 (M1 vs M0)        {exact - logz_m0:10.4f}")

    # --- predictive comparison: PSIS-LOO (stats/ic.py) from the beta=1
    # rung's posterior draws; elpd ranks out-of-sample fit where log BF
    # ranks prior-inclusive evidence
    post = chain.samples.values  # cold-rung (beta=1) draws, post-burnin

    def ll_pw(th):  # pointwise log-lik of M1 (per observation)
        return -0.5 * (_yd(th) - th[0]) ** 2 - 0.5 * L2PI

    ll1 = mt.pointwise_loglik(ll_pw, post, device=m1.device)
    ll0 = np.broadcast_to(
        (-0.5 * y ** 2 - 0.5 * L2PI)[None, :], ll1.shape
    )  # M0 has no parameters
    loo1, loo0 = mt.psis_loo(ll1), mt.psis_loo(ll0)
    print(f"elpd_loo(M1)               {loo1['elpd_loo']:10.4f}  "
          f"(p_loo {loo1['p_loo']:.2f}, max k-hat "
          f"{loo1['pareto_k'].max():.2f})")
    print(f"elpd_loo(M0)               {loo0['elpd_loo']:10.4f}")
    for name, elpd, d, dse in mt.compare_elpd({"M1": loo1, "M0": loo0}):
        print(f"  rank {name}: elpd {elpd:8.3f}  d_elpd {d:7.3f} +- {dse:.3f}")
    return exact, ti, ss, smc.diagnostics["logz"]


if __name__ == "__main__":
    main(*sys.argv[1:2])
