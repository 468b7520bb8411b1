"""Log-density model layer (port of ``mcmc_jl_tpu/models/model.py``;
reference: src/modellers/likmodel.jl:20-58, src/modellers/mcmcmodels.jl).

The model is a frozen record of functions over a flat parameter vector:

- ``eval(theta)``              log-target                      (likmodel.jl:21)
- ``evalg / evalallg``         gradient / (logp, grad)         (likmodel.jl:22,25)
- ``evalt / evalallt``         metric tensor / (logp, grad, G) (likmodel.jl:23,26)
- ``evaldt / evalalldt``       tensor derivatives / all four   (likmodel.jl:24,27)
- ``pmap``                     name -> (offset, shape), 1-based offsets
- ``init`` / ``scale``         initial values and scaling hints

Every function takes ``theta`` of shape (d,) or (C, d) — C chains on a
leading dimension — and returns one log-target per chain.  The model holds
its data on the ``device`` it was given, in ``dtype`` (default
:func:`~mcmc_jl_tpu_torch.utils.dtypes.real_dtype`).

Ported modes: callable (``f`` with ``grad=``, or
``gradient=True`` through ``torch.func``), ``glm=`` (logistic, linear,
poisson or probit link, or a custom ``(ll, resid)`` pair; weights, offsets
and a scalar prior precision) and the ``~`` DSL (named parameters, 1-based
offsets, matrices column-major); the manifold samplers' tensors
(``tensor=``/``dtensor=``, derived with ``torch.func`` or given), and
``debug=True``, which returns the traced log-target.

Out-of-support semantics: the log-target is sanitized to ``-inf`` (NaN ->
-inf) and the gradient to zero whenever the log-target is not finite
(reference src/dsl/modelparser.jl:64-72).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch

from . import dsl
from .distributions import CatalogTarget
from ..utils.dtypes import real_dtype


def resolve_device(device):
    """``device`` as a ``torch.device``.  ``None`` means the CUDA card; with
    no card visible that raises and says to pass ``device="cpu"``, and so
    does asking for CUDA: nothing runs on the CPU unasked."""
    if device is None and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible (torch.cuda.is_available() is False) "
            "and no device was given: pass device=\"cpu\" to run on the CPU")
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(dev)!r} requested but torch.cuda.is_available() is "
            f"False: no CUDA device is visible")
    return dev


def _sanitize_logp(f):
    def eval_(theta):
        lp = f(theta)
        return torch.where(torch.isnan(lp), -torch.inf, lp)

    return eval_


def _sanitize_allg(allg):
    def evalallg(theta):
        lp, g = allg(theta)
        lp = torch.where(torch.isnan(lp), -torch.inf, lp)
        ok = torch.isfinite(lp).unsqueeze(-1)
        g = torch.where(ok, torch.nan_to_num(g, nan=0.0, posinf=0.0,
                                             neginf=0.0), 0.0)
        return lp, g

    return evalallg


def _batched(fn):
    """Lift a per-vector function (d,) -> out to (..., d) inputs with
    ``torch.func.vmap`` over the leading chain dimensions."""
    def call(theta):
        if theta.ndim == 1:
            return fn(theta)
        lead = theta.shape[:-1]
        out = torch.func.vmap(fn)(theta.reshape(-1, theta.shape[-1]))
        if isinstance(out, tuple):
            return tuple(o.reshape(lead + o.shape[1:]) for o in out)
        return out.reshape(lead + out.shape[1:])

    return call


@dataclasses.dataclass(frozen=True)
class LogDensityModel:
    """A likelihood-type model: differentiable log-target over R^size."""

    eval: Callable  # theta -> logp
    evalg: Optional[Callable]  # theta -> grad
    evalallg: Optional[Callable]  # theta -> (logp, grad)
    pmap: dict  # name -> (offset(1-based), shape)
    size: int
    init: torch.Tensor
    scale: torch.Tensor
    #: set for models built via model(glm=...): enables the fused GLM-HMC
    #: routing in prun/run(chains=) (ops/glm_hmc.py)
    glm_spec: Any = None
    #: set for DSL models that are a product of catalog densities over
    #: their parameters: a ``CatalogTarget`` (models/distributions.py) that
    #: enables the fused custom-target routing in prun/run(chains=)
    target_spec: Any = None
    #: the tensor family (reference likmodel.jl:23-27): metric tensor G(theta)
    #: (d, d) per chain, its derivatives dG[i, j, k] = dG_ij/dtheta_k, and
    #: the tuples (logp, grad, G) and (logp, grad, G, dG)
    evalt: Optional[Callable] = None
    evaldt: Optional[Callable] = None
    evalallt: Optional[Callable] = None
    evalalldt: Optional[Callable] = None

    @property
    def device(self):
        return self.init.device

    @property
    def dtype(self):
        return self.init.dtype

    # -- capability predicates (reference mcmcmodels.jl:19-21) -------------
    @property
    def hasgradient(self):
        return self.evalg is not None

    @property
    def hastensor(self):
        return self.evalt is not None

    @property
    def hasdtensor(self):
        return self.evaldt is not None

    # -- parameter <-> named variables (reference expr_funcs.jl:39-91) -----
    def unravel(self, theta):
        """Flat (..., size) tensor -> dict of named parameter tensors
        (matrices stored column-major, like Julia)."""
        return _unravel(theta, self.pmap)

    def ravel(self, values: dict):
        """Dict of named parameter arrays -> flat (size,) tensor."""
        theta = torch.zeros(self.size, dtype=self.dtype, device=self.device)
        for name, (off, _) in self.pmap.items():
            v = torch.as_tensor(values[name], dtype=self.dtype,
                                device=self.device)
            v = v.T.reshape(-1) if v.ndim == 2 else v.reshape(-1)
            theta[off - 1 : off - 1 + v.numel()] = v
        return theta

    def column_names(self):
        """Column names 'k', 'k.i', 'k.i.j' (1-based) exactly as the
        reference builds them (SerialMC.jl:70-79)."""
        cn = [None] * self.size
        for name, (off, shape) in self.pmap.items():
            if len(shape) == 0:
                cn[off - 1] = f"{name}"
            elif len(shape) == 1:
                for i in range(shape[0]):
                    cn[off - 1 + i] = f"{name}.{i + 1}"
            else:
                # column-major like Julia's comprehension over (i, j)
                k = 0
                for j in range(shape[1]):
                    for i in range(shape[0]):
                        cn[off - 1 + k] = f"{name}.{i + 1}.{j + 1}"
                        k += 1
        return cn

    def with_scale(self, scale):
        """A copy whose ``scale`` (the proposal and initial-ball scale) is
        ``scale`` broadcast to (size,)."""
        scale = torch.broadcast_to(torch.as_tensor(
            scale, dtype=self.dtype, device=self.device), (self.size,))
        return dataclasses.replace(self, scale=scale.clone())

    def __mul__(self, other):
        """``model * sampler`` composition sugar (reference MCMC.jl:87-98)."""
        from ..core.task import product

        return product(self, other)

    def __repr__(self):
        caps = " +grad" if self.hasgradient else ""
        return (f"LogDensityModel(size={self.size}, params={list(self.pmap)}"
                f"{caps}, device={self.device})")


def _ispartition(pmap, n):
    """Check pmap tiles [1, n] exactly (reference mcmcmodels.jl:9-15)."""
    c = np.zeros(n)
    for off, shape in pmap.values():
        c[off - 1 : off - 1 + max(1, int(np.prod(shape)))] += 1
    return bool(np.all(c == 1))


def _model_vars(params: dict):
    """kwargs of initial values -> (size, pmap, init vector).

    Mirrors ``modelVars`` (reference expr_funcs.jl:76-91): 1-based offsets in
    declaration order; scalars keep shape (), matrices are stored flattened
    column-major."""
    pmap = {}
    pos = 1
    flat = []
    for name, v in params.items():
        arr = np.asarray(v.detach().cpu() if isinstance(v, torch.Tensor)
                         else v, dtype=np.float64)
        pmap[name] = (pos, arr.shape)
        pos += max(1, arr.size)
        flat.append(arr.reshape(-1, order="F") if arr.ndim == 2
                    else arr.reshape(-1))
    init = np.concatenate(flat) if flat else np.zeros((0,))
    return pos - 1, pmap, init


def _unravel(theta, pmap):
    """Slices of ``theta`` (..., size) by name; shapes of two or more
    dimensions read column-major, as the JAX package's ``unravel``."""
    lead = tuple(theta.shape[:-1])
    out = {}
    for name, (off, shape) in pmap.items():
        n = int(np.prod(shape)) if len(shape) else 1
        sl = theta[..., off - 1 : off - 1 + n]
        if len(shape) == 0:
            out[name] = sl[..., 0]
        elif len(shape) == 1:
            out[name] = sl.reshape(lead + tuple(shape))
        else:  # column-major: reversed shape, then the axes reversed
            k = len(lead)
            rev = sl.reshape(lead + tuple(shape)[::-1])
            out[name] = rev.permute(*range(k),
                                    *reversed(range(k, k + len(shape))))
    return out


def _catalog_spec(f, pmap, init, size):
    """The ``CatalogTarget`` of a DSL model when one run of ``f`` at
    ``init`` records only ``tilde(p, D)`` statements, each with ``p`` one
    of the named parameters itself, ``D`` a family with a kernel row, and
    every parameter once, and when that target's log-density equals the
    model's at ``init``; else None."""
    values = _unravel(init, pmap)
    with dsl.trace() as tr:
        f(**values)
    by_id = {id(v): name for name, v in values.items()}
    dists, seen = [None] * size, set()
    for rec in tr.records:
        if rec[0] != "tilde":
            return None
        _, x, dist = rec
        name = by_id.get(id(x))
        if (name is None or values[name] is not x or name in seen
                or dist.kernel_row() is None):
            return None
        seen.add(name)
        off, shape = pmap[name]
        n = max(1, int(np.prod(shape)))
        dists[off - 1 : off - 1 + n] = [dist] * n
    if len(seen) != len(pmap):
        return None
    spec = CatalogTarget(dists)
    lp_spec = spec(init[None])[0, 0]
    lp = torch.as_tensor(tr.value, dtype=init.dtype, device=init.device)
    if not bool(torch.isclose(lp_spec, lp, rtol=1e-5, atol=1e-6)):
        return None
    return spec


def _catalog_allg(target):
    """(logp, grad) of a catalog DSL model on the card in float32, already
    sanitized as :func:`_sanitize_allg` does: one launch of the
    custom-target kernels' gradient pass for all chains (autodiff of the
    traced DSL launches a few hundred small operations, the sanitizing
    six more), through a launcher built at the first call on each device
    (``ops/target_kernels.py`` ``logp_grad_launcher``), which launches on
    the stream current on that device at that first call."""
    launchers = {}

    def allg(theta):
        flat = theta.reshape(-1, theta.shape[-1]).contiguous()
        fn = launchers.get(flat.device)
        if fn is None:
            from ..ops.target_kernels import logp_grad_launcher

            fn = launchers[flat.device] = logp_grad_launcher(target,
                                                             flat.device)
        lp, g = fn(flat)
        return lp.reshape(theta.shape[:-1]), g.reshape(theta.shape)

    return allg


@dataclasses.dataclass(frozen=True, eq=False)
class GLMSpec:
    """Design/response data of a GLM-family posterior (model(glm=...)), as
    tensors on the model's device and in its dtype.

    Carried on the model so the multi-chain runners can route plain-HMC
    sampling to the fused kernels (ops/glm_kernels.py).  ``eq=False``:
    identity equality/hash, as in the JAX package."""

    kind: Any  # link name or (ll, resid) callable pair
    X: torch.Tensor  # (N, d) design
    Y: torch.Tensor  # (N,) responses
    weights: Optional[torch.Tensor] = None
    offsets: Optional[torch.Tensor] = None
    prior_prec: float = 1.0


def _glm_functions(spec):
    """(logp, grad, logp_grad) of a GLM posterior, batched over chains."""
    from ..ops.glm_kernels import link_terms

    ll_fn, resid_fn = link_terms(spec.kind)
    X, Y, W, O, lam = (spec.X, spec.Y, spec.weights, spec.offsets,
                       spec.prior_prec)

    def predictor(th):
        z = th @ X.T
        return z + O if O is not None else z

    def logp(th):
        ll = ll_fn(predictor(th), Y)
        if W is not None:
            ll = W * ll
        return ll.sum(-1) - 0.5 * lam * (th * th).sum(-1)

    def grad(th):
        r = resid_fn(predictor(th), Y)
        if W is not None:
            r = W * r
        return r @ X - lam * th

    def logp_grad(th):
        z = predictor(th)
        ll, r = ll_fn(z, Y), resid_fn(z, Y)
        if W is not None:
            ll, r = W * ll, W * r
        return (ll.sum(-1) - 0.5 * lam * (th * th).sum(-1),
                r @ X - lam * th)

    return logp, grad, logp_grad


def model(
    f: Optional[Callable] = None,
    *,
    glm: Any = None,
    weights: Any = None,
    offsets: Any = None,
    prior_prec: float = 1.0,
    grad: Optional[Callable] = None,
    tensor: Any = None,
    dtensor: Any = None,
    alltensor: Optional[Callable] = None,
    alldtensor: Optional[Callable] = None,
    init: Any = None,
    scale: Any = 1.0,
    pmap: Optional[dict] = None,
    gradient: bool = False,
    mtype: str = "likelihood",
    check_init: bool = True,
    debug: bool = False,
    device: Any = None,
    dtype: Optional[torch.dtype] = None,
    **params,
) -> LogDensityModel:
    """The model factory — front door of the framework.

    1. **Callable mode** — ``f`` maps a flat parameter vector (d,) to the
       log-target; pass ``init=``.  Optional ``grad``;
       ``gradient=True`` derives the gradient with ``torch.func``.  User
       functions are written for one vector and lifted over chains with
       ``torch.func.vmap``.
    2. **GLM mode** — ``glm=(kind, X, Y)`` with optional ``weights``,
       ``offsets`` and scalar ``prior_prec``: the Bayesian GLM
       ``sum_i w_i ll(x_i'theta + o_i, y_i) - (lam/2)|theta|^2`` with an
       analytic gradient.
    3. **DSL mode** — ``f`` is a function of *named* parameters using
       :func:`~mcmc_jl_tpu_torch.models.dsl.tilde` statements; pass one
       kwarg per parameter giving its initial value (the reference's
       ``model(expr, v=ones(3), gradient=true)``).  A model that is a
       product of catalog densities over its parameters gets a
       ``target_spec``, which routes plain HMC and MALA to the
       custom-target kernels.

    ``tensor=True`` derives the metric tensor as the negative Hessian of
    the log-target (``torch.func.hessian``) and ``dtensor=True`` its
    derivatives (``torch.func.jacfwd``, ``dG[i, j, k] = dG_ij/dtheta_k``);
    a callable gives them for one vector, and ``alltensor``/``alldtensor``
    give ``(logp, grad, G)`` / ``(logp, grad, G, dG)`` at once.  A tensor
    needs a gradient, and ``dtensor=True`` a tensor.

    ``debug=True`` returns the traced log-target instead of a model: the
    ``torch.fx.GraphModule`` that ``make_fx`` records at zeros, whose
    ``.code`` names the operations (the JAX package returns the jaxpr; the
    reference, the generated expression, modelparser.jl:103).

    ``device`` and ``dtype`` say where and in what precision the model's
    data and functions live; the default device is the CUDA card (pass
    ``device="cpu"`` to run on the CPU).
    """
    if mtype != "likelihood":
        raise ValueError(f"unsupported model type {mtype!r}")

    dtype = dtype or real_dtype()
    dev = resolve_device(device)
    as_t = lambda a: torch.tensor(np.asarray(a), dtype=dtype, device=dev)  # noqa: E731

    glm_spec_obj = None
    glm_allg = None
    if glm is not None:  # ---- GLM mode ---------------------------------
        if f is not None:
            raise ValueError("pass either f or glm=..., not both")
        kind, X, Y = glm
        glm_spec_obj = GLMSpec(
            kind=kind, X=as_t(X), Y=as_t(Y),
            weights=None if weights is None else as_t(weights),
            offsets=None if offsets is None else as_t(offsets),
            prior_prec=float(prior_prec),
        )
        f, glm_grad, glm_allg = _glm_functions(glm_spec_obj)
        if grad is None and not gradient:
            grad = glm_grad
        else:
            glm_allg = None
        if init is None:
            init = np.zeros(glm_spec_obj.X.shape[1])
        raw_eval = f
    else:
        if weights is not None or offsets is not None:
            raise ValueError("weights/offsets only apply to glm= models")
        if f is None:
            raise ValueError("model() needs a callable, DSL params or glm=")
    dsl_f = None
    if params:  # ---- DSL mode ------------------------------------------
        if glm is not None:
            raise ValueError("pass either DSL params or glm=..., not both")
        if init is not None or pmap is not None:
            raise ValueError("'init'/'pmap' are not allowed for DSL models "
                             "(use named params)")
        size, pmap, init = _model_vars(params)
        dsl_f, pm = f, pmap

        def f(theta):
            lp = dsl.call_with_trace(dsl_f, _unravel(theta, pm))
            return torch.as_tensor(lp, dtype=theta.dtype, device=theta.device)

    if glm is None:
        raw_eval = _batched(f)
    if init is None:
        init = [1.0]

    init_vec = torch.atleast_1d(torch.as_tensor(
        init.detach().cpu().numpy() if isinstance(init, torch.Tensor)
        else np.asarray(init), dtype=dtype, device=dev))
    size = int(init_vec.shape[0])
    if pmap is None:
        pmap = {"pars": (1, (size,))}  # likmodel.jl:139
    if not _ispartition(pmap, size):
        raise ValueError("param map is not a partition of parameter vector")
    if debug:
        from torch.fx.experimental.proxy_tensor import make_fx

        return make_fx(raw_eval)(torch.zeros(size, dtype=dtype, device=dev))
    scale_vec = torch.broadcast_to(
        torch.as_tensor(scale, dtype=dtype, device=dev), (size,)).clone()

    eval_ = _sanitize_logp(raw_eval)
    target_spec = (None if dsl_f is None
                   else _catalog_spec(dsl_f, pmap, init_vec, size))

    # ---- gradient family (likmodel.jl:121-136 synthesis, via torch.func) --
    if glm_allg is not None:
        evalallg = _sanitize_allg(glm_allg)
        evalg = grad
    elif grad is not None:
        g_b = _batched(grad)
        evalg = g_b
        evalallg = _sanitize_allg(lambda th: (raw_eval(th), g_b(th)))
    elif gradient:
        def _vg(th):
            g, lp = torch.func.grad_and_value(f)(th)
            return lp, g

        evalallg = _sanitize_allg(_batched(_vg))
        if target_spec is not None and dev.type == "cuda" \
                and dtype == torch.float32:
            from ..ops.target_kernels import D_MAX

            if size <= D_MAX:
                evalallg = _catalog_allg(target_spec)
        evalg = lambda th: evalallg(th)[1]  # noqa: E731
    else:
        evalg = evalallg = None

    evalt, evaldt, evalallt, evalalldt = _tensor_family(
        f, evalallg, tensor, dtensor, alltensor, alldtensor)

    mdl = LogDensityModel(
        eval=eval_, evalg=evalg, evalallg=evalallg, pmap=pmap, size=size,
        init=init_vec, scale=scale_vec, glm_spec=glm_spec_obj,
        target_spec=target_spec, evalt=evalt, evaldt=evaldt,
        evalallt=evalallt, evalalldt=evalalldt,
    )

    if check_init:
        lp0 = float(mdl.eval(mdl.init))
        if not np.isfinite(lp0):
            raise ValueError("Initial values out of model support, try other values")

    return mdl


def _tensor_family(f, evalallg, tensor, dtensor, alltensor, alldtensor):
    """(evalt, evaldt, evalallt, evalalldt), batched over chains, from the
    per-vector log-target ``f`` and the ``model()`` options (the JAX
    package's model.py:367-410)."""
    if tensor is True:  # observed information G = -H(logp)
        t1 = lambda th: -torch.func.hessian(f)(th)  # noqa: E731
    elif callable(tensor):
        t1 = tensor
    elif alltensor is not None:
        t1 = lambda th: alltensor(th)[-1]  # noqa: E731
    else:
        t1 = None
    evalt = None if t1 is None else _batched(t1)

    if alltensor is not None:
        evalallt = _batched(alltensor)
    elif evalt is not None:
        assert evalallg is not None, (
            "tensor requires a gradient (pass grad=... or gradient=True)")
        evalallt = lambda th: (*evalallg(th), evalt(th))  # noqa: E731
    else:
        evalallt = None

    if dtensor is True:
        assert t1 is not None, "dtensor=True requires a tensor"
        # jacfwd gives dG[i, j, k] = dG_ij/dtheta_k, the reference layout
        # (PMALA.jl:77-80 indexes dG[:, :, i])
        evaldt = _batched(torch.func.jacfwd(t1))
    elif callable(dtensor):
        evaldt = _batched(dtensor)
    elif alldtensor is not None:
        evaldt = lambda th: evalalldt(th)[-1]  # noqa: E731
    else:
        evaldt = None

    if alldtensor is not None:
        evalalldt = _batched(alldtensor)
    elif evaldt is not None:
        assert evalallt is not None, "dtensor requires tensor"
        evalalldt = lambda th: (*evalallt(th), evaldt(th))  # noqa: E731
    else:
        evalalldt = None
    return evalt, evaldt, evalallt, evalalldt
