"""The regularized incomplete beta function I_x(a, b) in plain torch.

torch has no ``betainc``; the cdfs of ``Beta``, ``TDist`` and ``Binomial``
(models/distributions.py) need it.  The value is the continued fraction of
DLMF 8.17.22-23, evaluated by the modified Lentz method, with the symmetry
``I_x(a, b) = 1 - I_{1-x}(b, a)`` (DLMF 8.17.4) taken where
``x >= (a + 1)/(a + b + 2)``, so that the fraction converges fast: the same
fraction, constants and edge cases as XLA's ``RegularizedIncompleteBeta``,
which ``jax.scipy.special.betainc`` lowers to.  The loop runs until every
entry has converged (|delta - 1| < eps/2), at most 200 iterations in
float32 and 600 in float64.

:func:`betainc` is differentiable in ``x`` only, with
``dI/dx = x^(a-1) (1-x)^(b-1) / B(a, b)``; a gradient in ``a`` or ``b``
raises ``ValueError``, as JAX's does.  It works under ``torch.func``
transforms (``grad``, ``vmap``, ``jacfwd``, ``hessian``) and in float32 and
float64, on any device.
"""
from __future__ import annotations

import torch

#: the JAX package's message for a gradient in a or b
_AB_GRAD = "Betainc gradient with respect to a and b not supported."


def _iterations(dtype):
    return 200 if dtype == torch.float32 else 600


def _betainc_value(a, b, x):
    """I_x(a, b) on broadcast tensors of one floating dtype (no autograd)."""
    dtype = x.dtype
    finfo = torch.finfo(dtype)
    small = finfo.eps / 2
    one = torch.ones((), dtype=dtype, device=x.device)

    a_is_zero = (a == 0) | (b == float("inf"))
    b_is_zero = (b == 0) | (a == float("inf"))
    result_is_zero = (b_is_zero & (x != 1)) | (a_is_zero & (x == 0))
    result_is_one = (a_is_zero & (x != 0)) | (b_is_zero & (x == 1))
    result_is_nan = ((a < 0) | (b < 0) | (x < 0) | (x > 1)
                     | (a_is_zero & b_is_zero)
                     | torch.isnan(a) | torch.isnan(b) | torch.isnan(x))

    fast = x < (a + 1) / (a + b + 2)
    a, b = torch.where(fast, a, b), torch.where(fast, b, a)
    x = torch.where(fast, x, 1 - x)

    # modified Lentz on b0 + a1/(b1 + a2/(b2 + ...)), b0 = 0, b_n = 1:
    # h starts at `small` (b0 = 0), c at h, d at 0
    h = torch.full_like(x, small)
    c = h.clone()
    d = torch.zeros_like(x)
    for it in range(1, _iterations(dtype)):
        if it == 1:
            num = torch.ones_like(x)
        elif it % 2 == 0:
            m = (it - 1) // 2
            if m == 0:
                num = -(a + b) * x / (a + 1)
            else:
                num = (-(a + m) * (a + b + m) * x
                       / ((a + 2 * m) * (a + 2 * m + 1)))
        else:
            m = (it - 1) // 2
            num = m * (b - m) * x / ((a + 2 * m - 1) * (a + 2 * m))
        c = 1 + num / c
        c = torch.where(c.abs() < small, small, c)
        d = 1 + num * d
        d = torch.where(d.abs() < small, small, d)
        d = 1 / d
        delta = c * d
        h = h * delta
        if not bool(((delta - 1).abs() >= small).any()):
            break

    lbeta_small_a = torch.lgamma(b) - torch.lgamma(a + b)
    lbeta = torch.lgamma(a) + lbeta_small_a
    very_small = finfo.tiny * 2
    factor = torch.where(
        a < very_small,
        torch.exp(torch.log1p(-x) * b - lbeta_small_a),
        torch.exp(torch.log(x) * a + torch.log1p(-x) * b - lbeta) / a)
    result = h * factor
    result = torch.where(fast, result, one - result)
    result = torch.where(result_is_zero, 0.0, result)
    result = torch.where(result_is_one, 1.0, result)
    return torch.where(result_is_nan, float("nan"), result)


def _dx(a, b, x):
    """dI_x(a, b)/dx, differentiable (a second derivative of the cdf goes
    through it)."""
    lbeta = torch.lgamma(a) + torch.lgamma(b) - torch.lgamma(a + b)
    return torch.exp((b - 1) * torch.log1p(-x) + (a - 1) * torch.log(x)
                     - lbeta)


class _Betainc(torch.autograd.Function):
    @staticmethod
    def forward(a, b, x):
        return _betainc_value(a, b, x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        # unmaterialized tangents stay None: jvp tells a tangent in a or b
        # from none
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(*inputs)
        ctx.save_for_forward(*inputs)

    @staticmethod
    def backward(ctx, g):
        a, b, x = ctx.saved_tensors
        if ctx.needs_input_grad[0] or ctx.needs_input_grad[1]:
            raise ValueError(_AB_GRAD)
        if g is None or not ctx.needs_input_grad[2]:
            return None, None, None
        return None, None, g * _dx(a, b, x)

    @staticmethod
    def jvp(ctx, a_t, b_t, x_t):
        if a_t is not None or b_t is not None:
            raise ValueError(_AB_GRAD)
        if x_t is None:
            return None
        a, b, x = ctx.saved_tensors
        return x_t * _dx(a, b, x)

    @staticmethod
    def vmap(info, in_dims, a, b, x):
        # the loop's convergence test reads the values: run it on the whole
        # batch at once, the mapped dimension first
        size = info.batch_size
        ins = []
        for t, dim in zip((a, b, x), in_dims):
            t = t.movedim(dim, 0) if dim is not None else t.unsqueeze(0)
            ins.append(t)
        shape = torch.broadcast_shapes(*(t.shape[1:] for t in ins))
        ins = [t.expand((size,) + shape) for t in ins]
        return _Betainc.apply(*ins), 0


def betainc(a, b, x):
    """I_x(a, b), elementwise over broadcast ``a``, ``b``, ``x`` (tensors
    or Python numbers; the dtype and device of the tensors among them)."""
    tens = [t for t in (a, b, x) if isinstance(t, torch.Tensor)]
    dtype = None
    for t in tens:
        if t.is_floating_point():
            dtype = t.dtype if dtype is None else torch.promote_types(
                dtype, t.dtype)
    dtype = dtype or torch.get_default_dtype()
    dev = tens[0].device if tens else None
    a, b, x = (torch.as_tensor(t, dtype=dtype, device=dev) for t in (a, b, x))
    shape = torch.broadcast_shapes(a.shape, b.shape, x.shape)
    return _Betainc.apply(a.expand(shape), b.expand(shape), x.expand(shape))
