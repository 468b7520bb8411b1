"""FFT autocovariance (port of ``mcmc_jl_tpu/ops/acf.py``, on ``torch.fft``).

The reference computes per-lag autocovariance with ``StatsBase.acf``
(reference: src/stats/var.jl:53, 103) — an O(n*maxlag) host loop.  Here the
full autocovariance sequence comes from a zero-padded real FFT in
O(n log n), batched over parameter columns.  Convention matches StatsBase
``acf(x, lags, correlation=false)``: demeaned, biased (divisor n).
"""
from __future__ import annotations

import torch


def autocov(x, maxlag=None):
    """Autocovariance of columns of ``x`` (n, p) for lags 0..maxlag.

    Returns a float64 tensor (maxlag+1, p) on the input's device (the CPU
    for numpy input).  1-D input is treated as one column and returns
    (maxlag+1,).
    """
    x = torch.as_tensor(x, dtype=torch.float64)
    squeeze = x.ndim == 1
    if squeeze:
        x = x[:, None]
    n = x.shape[0]
    if maxlag is None:
        maxlag = n - 1
    xc = x - x.mean(dim=0, keepdim=True)
    nfft = 1
    while nfft < 2 * n:
        nfft *= 2
    f = torch.fft.rfft(xc, n=nfft, dim=0)
    acov = torch.fft.irfft(f * f.conj(), n=nfft, dim=0)[: maxlag + 1] / n
    return acov[:, 0] if squeeze else acov
