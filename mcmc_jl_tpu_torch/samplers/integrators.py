"""Symplectic integrators for Hamiltonian samplers (port of
``mcmc_jl_tpu/samplers/integrators.py``).

Plain leapfrog (reference src/samplers/HMC.jl:93-102) and the minimum-error
two- and three-stage palindromic splitting schemes of Blanes, Casas &
Sanz-Serna (SIAM J. Sci. Comput. 2014).  All are compositions of exact
momentum kicks B(b*eps) and position drifts A(a*eps), so the Metropolis test
``rand() < exp(H0 - H)`` stays exact.

All integrators share the carry signature
``(model, pars, m, grad, eps) -> (pars, logtarget, grad, m)``; ``pars`` may
carry a leading chain dimension, and ``eps`` is a scalar or a tensor that
broadcasts against ``pars``.
"""
from __future__ import annotations

# BCSS (2014) minimum-error coefficients
_B2 = 0.211781  # two-stage
_A3 = 0.29619504261126  # three-stage
_B3 = 0.11888010966548

#: The single source of truth for every scheme: a palindromic sequence of
#: momentum kicks ("B", c) and position drifts ("A", c), coefficients in
#: units of eps.  The generic step functions below, the plain GLM versions
#: and the CUDA kernels (ops/glm_kernels.py, csrc/glm_hmc.cu) all read it.
SCHEDULES = {
    "leapfrog": (("B", 0.5), ("A", 1.0), ("B", 0.5)),
    "2stage": (("B", _B2), ("A", 0.5), ("B", 1.0 - 2.0 * _B2),
               ("A", 0.5), ("B", _B2)),
    "3stage": (("B", _B3), ("A", _A3), ("B", 0.5 - _B3),
               ("A", 1.0 - 2.0 * _A3), ("B", 0.5 - _B3),
               ("A", _A3), ("B", _B3)),
}


def _make_step(name):
    schedule = SCHEDULES[name]
    n_grads = sum(1 for op, _ in schedule if op == "A")

    def step(model, pars, m, grad, eps):
        lp, g = None, grad
        for op, c in schedule:
            if op == "B":
                m = m + c * eps * g
            else:
                pars = pars + c * eps * m
                lp, g = model.evalallg(pars)
        return pars, lp, g, m

    step.__name__ = name
    step.__doc__ = (
        f"{name} splitting scheme "
        f"{' '.join(f'{op}({c:.6g})' for op, c in schedule)}; "
        f"{n_grads} gradient evaluation(s) per step."
    )
    return step, n_grads


def leapfrog(model, pars, m, grad, eps):
    """One leapfrog step (reference HMC.jl:93-102). Returns updated
    (pars, logtarget, grad, momentum)."""
    m_half = m + 0.5 * eps * grad
    new_pars = pars + eps * m_half
    lp, g = model.evalallg(new_pars)
    new_m = m_half + 0.5 * eps * g
    return new_pars, lp, g, new_m


twostage, _ = _make_step("2stage")
threestage, _ = _make_step("3stage")

#: name -> (step_fn, gradient evaluations per step)
INTEGRATORS = {
    "leapfrog": (leapfrog, 1),
    "2stage": (twostage, 2),
    "3stage": (threestage, 3),
}


def get_integrator(name):
    """Resolve an integrator name to (step_fn, grads_per_step)."""
    try:
        return INTEGRATORS[name]
    except KeyError:
        raise ValueError(
            f"unknown integrator {name!r}; one of {sorted(INTEGRATORS)}"
        ) from None


def hamiltonian(lp, m):
    """``-lp + |m|^2 / 2`` over the last dimension (one value per chain)."""
    return -lp + 0.5 * (m * m).sum(dim=-1)
