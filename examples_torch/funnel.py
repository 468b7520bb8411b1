"""Neal's funnel (reference: test/test_ss.jl, its slice-sampler workload)
on the PyTorch port.

v ~ N(0, 3^2); x_i | v ~ N(0, e^v) for i = 1..9.  The classic
varying-curvature target: at the neck (v << 0) the conditional scale of x
is exp(v/2), so any fixed step size either diverges in the neck or crawls
in the mouth.  Three ways to sample it here:

- ``slice_sample``: the reference's approach (step-out and shrink);
- ``NUTS``: fixed step; visibly biased away from the neck at this budget;
- ``WALNUTS``: within-orbit adaptive micro steps resolve the neck.

Run on the CUDA card: ``python examples_torch/funnel.py``; on the CPU:
``python examples_torch/funnel.py cpu``.
"""
import sys

import numpy as np
import torch

import mcmc_jl_tpu_torch as mt

DIM_X = 9


def make_model(gradient=True, device=None, dtype=None):
    def logp(z):
        v, x = z[0], z[1:]
        return (-v * v / 18.0
                - 0.5 * (x * x).sum() * torch.exp(-v)
                - 0.5 * DIM_X * v)

    return mt.model(logp, gradient=gradient, init=np.zeros(DIM_X + 1),
                    check_init=False, device=torch.device(device or "cuda"),
                    dtype=dtype)


def main(device=None):
    m = make_model(device=device)
    runner = mt.SerialMC(steps=8000, burnin=2000)

    for name, sampler in [
        ("NUTS (fixed step)", mt.NUTS(maxdoublings=8)),
        ("WALNUTS", mt.WALNUTS(maxdoublings=8, max_halvings=5)),
    ]:
        chain = mt.run(m, sampler, runner, seed=0)
        v = chain.samples.values[:, 0]
        div = 100.0 * np.mean(np.asarray(chain.diagnostics["diverging"]))
        print(f"{name:18s} E[v]={v.mean():+.2f} (true 0)  "
              f"Var[v]={v.var():.1f} (true 9)  min v={v.min():+.1f}  "
              f"divergent {div:.1f}%")

    # the reference's sampler for this target (test_ss.jl)
    xs = mt.slice_sample(m.eval, torch.zeros(DIM_X + 1, dtype=m.dtype,
                                             device=m.device), 8000,
                         widths=5.0, seed=0)
    v = np.asarray(xs)[2000:, 0]
    print(f"{'slice_sample':18s} E[v]={v.mean():+.2f} (true 0)  "
          f"Var[v]={v.var():.1f} (true 9)")


if __name__ == "__main__":
    main(*sys.argv[1:2])
