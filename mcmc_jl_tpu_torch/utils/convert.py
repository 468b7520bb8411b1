"""Carry models and sampler states over from the JAX package.

Works on numpy arrays only, so neither package imports the other: take a JAX
``GLMSpec``'s fields, or a JAX ``HMCState``/``NUTSState``/``MALAState``/
``HMCDAState`` after ``jax.device_get`` turned into a (nested) dict of numpy
arrays, and build the port's counterpart.  ``device=None`` means the CUDA
card, as everywhere in the port; pass ``device="cpu"`` to build on the CPU.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..models.model import model, resolve_device
from ..samplers.base import TuneState
from ..samplers.hmc import HMCState
from ..samplers.hmcda import HMCDAState
from ..samplers.mala import MALAState
from ..samplers.massadapt import MassAccum
from ..samplers.nuts import NUTSState

_NESTED = {"tune": TuneState, "mass": MassAccum}


def glm_model_from_spec(kind, X, Y, weights=None, offsets=None,
                        prior_prec=1.0, device=None, dtype=None):
    """The port's ``model(glm=...)`` from the numpy fields of a JAX
    ``GLMSpec`` (``spec.kind, spec.X, spec.Y, spec.weights, spec.offsets,
    spec.prior_prec``)."""
    return model(glm=(kind, np.asarray(X), np.asarray(Y)),
                 weights=None if weights is None else np.asarray(weights),
                 offsets=None if offsets is None else np.asarray(offsets),
                 prior_prec=float(prior_prec), device=device, dtype=dtype)


def _build(cls, fields, dev, dtype):
    kw = {}
    for f in dataclasses.fields(cls):
        v = fields[f.name]
        if f.name in _NESTED:
            kw[f.name] = _build(_NESTED[f.name], v, dev, dtype)
        else:
            a = np.asarray(v)
            dt = torch.int32 if np.issubdtype(a.dtype, np.integer) else dtype
            kw[f.name] = torch.tensor(a, dtype=dt, device=dev)
    return cls(**kw)


def hmc_state_from_numpy(state, device=None, dtype=None):
    """The port's :class:`HMCState` from a JAX ``HMCState`` given as a dict
    (``pars, logtarget, grad, i`` and nested ``tune``/``mass`` dicts) of
    numpy arrays, e.g. ``{**vars(jax.device_get(s))}`` with the nested
    states turned into dicts too.  Floats keep their precision unless
    ``dtype`` is given; a leading chain dimension is kept."""
    return _state_from_numpy(HMCState, state, device, dtype)


def nuts_state_from_numpy(state, device=None, dtype=None):
    """The port's :class:`NUTSState` from a JAX ``NUTSState`` given as a
    dict (``pars, logtarget, grad, epsilon, mu, hbar, lebar, tlen, i`` and a
    nested ``mass`` dict) of numpy arrays; as :func:`hmc_state_from_numpy`."""
    return _state_from_numpy(NUTSState, state, device, dtype)


def mala_state_from_numpy(state, device=None, dtype=None):
    """The port's :class:`MALAState` from a JAX ``MALAState`` given as a
    dict (``pars, logtarget, grad, i`` and a nested ``tune`` dict) of numpy
    arrays; as :func:`hmc_state_from_numpy`."""
    return _state_from_numpy(MALAState, state, device, dtype)


def hmcda_state_from_numpy(state, device=None, dtype=None):
    """The port's :class:`HMCDAState` from a JAX ``HMCDAState`` given as a
    dict (``pars, logtarget, grad, leap_step, dual_leap_step, dual_h, mu, i``
    and a nested ``mass`` dict) of numpy arrays; as
    :func:`hmc_state_from_numpy`."""
    return _state_from_numpy(HMCDAState, state, device, dtype)


def _state_from_numpy(cls, state, device, dtype):
    dev = resolve_device(device)
    if dtype is None:
        dtype = torch.float64 if np.asarray(state["pars"]).dtype == np.float64 \
            else torch.float32
    return _build(cls, state, dev, dtype)
