"""Carry models, distributions and sampler states over from the JAX package.

Works on numpy arrays only, so neither package imports the other: take a JAX
``GLMSpec``'s fields, a JAX catalog distribution's class name and fields,
or a JAX ``HMCState``/``NUTSState``/``MALAState``/``HMCDAState``/
``ChEESState``/``RWMState``/``BarkerState``/``IMHState``/``RAMState``, or
a manifold sampler's ``SMMALAState``/``PMALAState``/``RMHMCState``/
``LMCState`` after
``jax.device_get`` turned into a (nested) dict of numpy arrays, and build
the port's counterpart (a ``WALNUTS`` state is a ``NUTSState``).  ``device=None`` means the CUDA
card, as everywhere in the port; pass ``device="cpu"`` to build on the CPU.

The ensemble runners' states continue too.  The sampler converters keep a
leading dimension, so a PTMC walker's ladder (``task.state``, (K,)) and
``ConvergenceResult.states`` (n_chains,) convert with the sampler's own
converter; :func:`ensemble_from_numpy` takes AIES's ``(pars, lp)``
ensemble and ASMC's final particles, :func:`seqmc_state_from_numpy` a
SeqMC ladder's particles, weights and per-target sampler states, and
:func:`serialtempmc_state_from_numpy` a SerialTempMC ladder's rung states
and walker.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..models import distributions as dists
from ..models.model import model, resolve_device
from ..samplers.barker import BarkerState
from ..samplers.base import TuneState
from ..samplers.chees import ChEESState
from ..samplers.hmc import HMCState
from ..samplers.hmcda import HMCDAState
from ..samplers.imh import IMHState
from ..samplers.lagrangian import LMCState
from ..samplers.mala import MALAState
from ..samplers.massadapt import MassAccum
from ..samplers.nuts import NUTSState
from ..samplers.pmala import PMALAState
from ..samplers.ram import RAMState
from ..samplers.rmhmc import RMHMCState
from ..samplers.rwm import RWMState
from ..samplers.smmala import SMMALAState

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


def distribution_from_fields(name, device=None, dtype=None, **fields):
    """The port's catalog distribution from a JAX distribution's class name
    and its fields as numpy (``dataclasses.asdict`` after
    ``jax.device_get``), e.g. ``distribution_from_fields("Gamma", shape=3.0,
    scale=0.2)``.  Scalars become Python floats, so the ten continuous
    families keep their kernel rows; arrays become tensors on ``device``
    (the CUDA card by default) in ``dtype``.  A nested ``base`` (censoring,
    ``Truncated``) is given as a ``(name, fields)`` pair or as a port
    distribution."""
    cls = dists._REGISTRY.get(name)
    if cls is None:
        raise ValueError(f"unknown distribution {name!r}; the catalog has "
                         f"{sorted(dists._REGISTRY)}")
    kw = {}
    for key, v in fields.items():
        if isinstance(v, tuple) and len(v) == 2 and isinstance(v[0], str):
            v = distribution_from_fields(v[0], device=device, dtype=dtype,
                                         **v[1])
        elif v is not None and not isinstance(v, dists.Distribution):
            a = np.asarray(v)
            if a.ndim == 0:
                v = float(a)
            else:
                v = torch.tensor(a, dtype=dtype or torch.get_default_dtype(),
                                 device=resolve_device(device))
        kw[key] = v
    return cls(**kw)


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


def chees_state_from_numpy(state, device=None, dtype=None):
    """The port's :class:`ChEESState` from a JAX ``ChEESState`` given as a
    dict (``pars, logtarget, grad, leap_step, dual_leap_step, dual_h, mu,
    log_len, adam_m, adam_v, i``, the ``p_*`` stash and a nested ``mass``
    dict) of numpy arrays; as :func:`hmc_state_from_numpy`."""
    return _state_from_numpy(ChEESState, state, device, dtype)


def rwm_state_from_numpy(state, device=None, dtype=None):
    """The port's :class:`RWMState` from a JAX ``RWMState`` given as a dict
    (``pars, logtarget, i``) of numpy arrays; as
    :func:`hmc_state_from_numpy`."""
    return _state_from_numpy(RWMState, state, device, dtype)


def barker_state_from_numpy(state, device=None, dtype=None):
    """The port's :class:`BarkerState` from a JAX ``BarkerState`` given as
    a dict (``pars, logtarget, grad, i`` and a nested ``tune`` dict) of
    numpy arrays; as :func:`hmc_state_from_numpy`."""
    return _state_from_numpy(BarkerState, state, device, dtype)


def imh_state_from_numpy(state, device=None, dtype=None):
    """The port's :class:`IMHState` from a JAX ``IMHState`` given as a dict
    (``pars, logtarget, logcandidate, i``) of numpy arrays; as
    :func:`hmc_state_from_numpy`."""
    return _state_from_numpy(IMHState, state, device, dtype)


def ram_state_from_numpy(state, device=None, dtype=None):
    """The port's :class:`RAMState` from a JAX ``RAMState`` given as a dict
    (``pars, logtarget, S, i``; ``S`` the (..., d, d) factor) of numpy
    arrays; as :func:`hmc_state_from_numpy`."""
    return _state_from_numpy(RAMState, state, device, dtype)


def smmala_state_from_numpy(state, device=None, dtype=None):
    """The port's :class:`SMMALAState` from a JAX ``SMMALAState`` given as a
    dict (``pars, logtarget, grad, chol, drift, i`` and a nested ``tune``
    dict) of numpy arrays; as :func:`hmc_state_from_numpy`."""
    return _state_from_numpy(SMMALAState, state, device, dtype)


def pmala_state_from_numpy(state, device=None, dtype=None):
    """The port's :class:`PMALAState` from a JAX ``PMALAState`` given as a
    dict (``pars, logtarget, grad, chol, drift, i`` and a nested ``tune``
    dict) of numpy arrays; as :func:`hmc_state_from_numpy`."""
    return _state_from_numpy(PMALAState, state, device, dtype)


def rmhmc_state_from_numpy(state, device=None, dtype=None):
    """The port's :class:`RMHMCState` from a JAX ``RMHMCState`` given as a
    dict (``pars, logtarget, grad, G, i`` and a nested ``tune`` dict) of
    numpy arrays; as :func:`hmc_state_from_numpy`."""
    return _state_from_numpy(RMHMCState, state, device, dtype)


def lmc_state_from_numpy(state, device=None, dtype=None):
    """The port's :class:`LMCState` (ERMLMC, RMLMC) from a JAX ``LMCState``
    given as a dict (``pars, logtarget, grad, G, invG, cholG, dphi, C, i``
    and a nested ``tune`` dict) of numpy arrays; as
    :func:`hmc_state_from_numpy`."""
    return _state_from_numpy(LMCState, state, device, dtype)


def _state_from_numpy(cls, state, device, dtype):
    dev = resolve_device(device)
    if dtype is None:
        dtype = torch.float64 if np.asarray(state["pars"]).dtype == np.float64 \
            else torch.float32
    return _build(cls, state, dev, dtype)


def ensemble_from_numpy(*arrays, device=None, dtype=None):
    """Tensors on ``device`` from numpy arrays: AIES's ``(pars (W, d), lp
    (W,))`` ensemble (``ensemble_from_numpy(pars, lp)``, the state every
    walker's task carries) or ASMC's final particles ``(N, d)``
    (``ensemble_from_numpy(pars)``).  Floats keep the first array's
    precision unless ``dtype`` is given.  One array gives one tensor."""
    dev = resolve_device(device)
    if dtype is None:
        dtype = torch.float64 if np.asarray(arrays[0]).dtype == np.float64 \
            else torch.float32
    out = tuple(torch.tensor(np.asarray(a), dtype=dtype, device=dev)
                for a in arrays)
    return out[0] if len(out) == 1 else out


def _per_target(convert, n):
    return list(convert) if isinstance(convert, (list, tuple)) \
        else [convert] * n


def _rungs(states):
    """Per-rung state dicts from a list of them, or from one dict stacked
    on a leading rung axis (the JAX package's homogeneous ladder)."""
    if isinstance(states, dict):
        n = np.asarray(states["pars"]).shape[0]
        take = lambda t, k: ({f: take(v, k) for f, v in t.items()}  # noqa: E731
                             if isinstance(t, dict) else np.asarray(t)[k])
        return [take(states, k) for k in range(n)]
    return list(states)


def seqmc_state_from_numpy(carry, convert, device=None, dtype=None):
    """The state a finished SeqMC run's tasks carry, from the JAX package's
    (``chain.task[-1].state``: ``pars`` (npart, d), ``logW`` (npart,) and
    ``states``, one per target, each a dict of numpy arrays with a leading
    particle dimension).  ``convert``: the sampler converter above for
    every target, or a list of one a target."""
    pars, logW = ensemble_from_numpy(carry["pars"], carry["logW"],
                                     device=device, dtype=dtype)
    states = carry["states"]
    fns = _per_target(convert, len(states))
    return {"pars": pars, "logW": logW,
            "states": tuple(f(s, device=device, dtype=pars.dtype)
                            for f, s in zip(fns, states))}


def serialtempmc_state_from_numpy(states, convert, at, pars, logtarget,
                                  logW, device=None, dtype=None):
    """The state a finished SerialTempMC run's tasks carry, from the JAX
    package's ``_temp_scan`` (its rung states, one dict a rung or one dict
    stacked on the rung axis, and its ``logW``) and the walker: ``at``
    (0-based rung), ``pars`` (d,) and ``logtarget`` (rung ``at``'s
    log-target there).  ``convert``: the sampler converter above for every
    rung, or a list of one a rung."""
    pars, logtarget, logW = ensemble_from_numpy(
        pars, logtarget, logW, device=device, dtype=dtype)
    rungs = _rungs(states)
    fns = _per_target(convert, len(rungs))
    return {"states": tuple(f(s, device=device, dtype=pars.dtype)
                            for f, s in zip(fns, rungs)),
            "at": int(at), "pars": pars, "logtarget": logtarget,
            "logW": logW}
