"""Floating-point policy (port of ``mcmc_jl_tpu/utils/dtypes.py``).

The JAX package follows x64 mode; the port follows
``torch.get_default_dtype()``: float32 unless a caller sets float64 (as the
parity tests do).  Every literal and buffer derives its dtype from
:func:`real_dtype`.
"""
from __future__ import annotations

import torch


def real_dtype():
    """The default real dtype: ``torch.get_default_dtype()``."""
    return torch.get_default_dtype()
