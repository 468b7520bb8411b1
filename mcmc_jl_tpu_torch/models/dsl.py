"""The ``~`` model DSL (port of ``mcmc_jl_tpu/models/dsl.py``; reference:
src/dsl/expr_funcs.jl:8-36, src/dsl/modelparser.jl:39-104).

A model is an ordinary Python function of named parameters.  Sampling
statements are spelled with :func:`tilde` (alias :func:`observe`) against an
implicit accumulator that :class:`trace` sets up; ``torch.func`` takes the
place of the reference's source-to-source AD.  ``tilde(y, +D)``
right-censors (logccdf) and ``tilde(y, -D)`` left-censors (logcdf).

Example (reference examples/logistic_regression.jl rewritten)::

    import mcmc_jl_tpu_torch as mt

    def ex(vars):
        mt.tilde(vars, mt.Normal(0.0, 1.0))
        prob = torch.sigmoid(X @ vars)
        mt.tilde(Y, mt.Bernoulli(prob))

    m = mt.model(ex, vars=np.zeros(nbeta), gradient=True)

Out-of-support values contribute ``-inf``, never an exception.

Besides the terms, a trace keeps a record of its statements: ``("tilde",
x, D)`` for each :func:`tilde` and ``("acc", term)`` for each :func:`acc`.
The model layer reads it to recognise a product of catalog densities over
the parameters, which the custom-target CUDA kernels can run
(``LogDensityModel.target_spec``).
"""
from __future__ import annotations

import threading

import torch

from .distributions import Distribution

_STATE = threading.local()


class trace:
    """Context manager that collects the log-likelihood accumulator (the
    reference's ``__acc = LLAcc(0.)`` prologue, modelparser.jl:48-51): each
    :func:`tilde` statement adds the *sum* of its elementwise logpdf."""

    def __enter__(self):
        if not hasattr(_STATE, "stack"):
            _STATE.stack = []
        self.terms, self.records = [], []
        _STATE.stack.append(self)
        return self

    def __exit__(self, *exc):
        _STATE.stack.pop()
        return False

    @property
    def value(self):
        if not self.terms:
            return torch.zeros(())
        acc = self.terms[0]
        for t in self.terms[1:]:
            acc = acc + t
        return acc


def _active(what):
    if not getattr(_STATE, "stack", None):
        raise RuntimeError(
            f"{what} called outside a model trace; statements using ~ "
            f"semantics must run inside a function passed to model(...)")
    return _STATE.stack[-1]


def tilde(x, d: Distribution):
    """``x ~ d``: accumulate ``sum(logpdf(d, x))`` into the active trace."""
    tr = _active("tilde()/observe()")
    tr.terms.append(d.logpdf(x).sum())
    tr.records.append(("tilde", x, d))
    return x


# numpyro-style alias
observe = tilde


def acc(term):
    """``__acc += term``: add a raw log-density increment (summed over
    arrays) to the active trace (AccumulatorDerivRules.jl:19-20) — for
    Jacobian corrections and hand-written likelihood terms."""
    tr = _active("acc()/factor()")
    tr.terms.append(torch.as_tensor(term).sum())
    tr.records.append(("acc", term))
    return term


# numpyro-style alias
factor = acc


def call_with_trace(fn, kwargs):
    """Run ``fn(**kwargs)`` under a fresh accumulator; return the total
    log-likelihood.

    The function's return value is ignored: the model's value *is* the
    accumulator (modelparser.jl:48-51), so ``lambda x: tilde(x, D)`` does
    not count ``x`` twice."""
    with trace() as tr:
        fn(**kwargs)
    return tr.value
