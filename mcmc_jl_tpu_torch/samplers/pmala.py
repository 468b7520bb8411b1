"""Position-dependent MALA (port of ``mcmc_jl_tpu/samplers/pmala.py``;
reference: src/samplers/PMALA.jl; Xifara et al. 2013).

Like SMMALA, but the drift subtracts the metric-derivative correction
``sum_i (G^{-1} dG_i G^{-1})_{:, i}`` (PMALA.jl:77-80, 94).  Requires
gradient + tensor + dtensor.  The current point's Cholesky factor and full
drift are carried in the state, so a transition takes one ``evalalldt``, one
batched Cholesky and one triangular-solve inverse for the proposed point;
``dG`` is (C, d, d, d) with ``dG[..., i, j, k] = dG_ij / dtheta_k``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .base import EmpMCTuner, TuneState, state_dataclass
from .smmala import _Langevin, chol_inverse, cholesky, mv


@state_dataclass
class PMALAState:
    pars: torch.Tensor
    logtarget: torch.Tensor
    grad: torch.Tensor
    chol: torch.Tensor  # lower Cholesky factor of G(pars)
    drift: torch.Tensor  # G^{-1} grad - sum_i (G^{-1} dG_i G^{-1})_{:, i}
    tune: TuneState
    i: torch.Tensor


def _geometry(grad, G, dG):
    """(L, drift) with drift = G^{-1}grad - sum_i (G^{-1} dG_i G^{-1})_{:,i}
    (PMALA.jl:76-80) from one Cholesky; the inverse from two triangular
    solves against the identity."""
    L = cholesky(G)
    invG = chol_inverse(L)
    # second[a] = sum_i (invG @ dG[:, :, i] @ invG)[a, i]
    second = torch.einsum("...ab,...bci,...ci->...a", invG, dG, invG)
    return L, mv(invG, grad) - second


def _pmala_geometry(model, theta):
    lp, g, G, dG = model.evalalldt(theta)
    return (lp, g, *_geometry(g, G, dG))


@dataclasses.dataclass(frozen=True, repr=False)
class PMALA(_Langevin):
    scale: float = 1.0  # driftStep
    tuner: Optional[EmpMCTuner] = None

    needs_dtensor = True

    _state_cls = PMALAState
    _geometry = staticmethod(_pmala_geometry)
