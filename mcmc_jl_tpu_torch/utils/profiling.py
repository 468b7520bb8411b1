"""Profiling and throughput reporting (port of
``mcmc_jl_tpu/utils/profiling.py``).

The reference's only instrumentation is the wall-clock ``tic()/toq()``
stored in ``MCMCChain.runTime`` (SerialMC.jl:38,84).  Here:

- :func:`trace` wraps ``torch.profiler`` for a Chrome trace of a sampling
  run: the host's operators and, with a CUDA device present, the kernels
  the card ran (each by its symbol, e.g. ``leapfrogs_tile_kernel``);
- :func:`timed` records the wall-clock seconds of a block;
- :func:`throughput_report` turns a chain into the metrics that matter for
  MCMC hardware efficiency: steps/s, (for the HMC family) leapfrog/s, and
  ESS/s per parameter.
"""
from __future__ import annotations

import contextlib
import os
import time

import numpy as np

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(logdir="torch-trace"):
    """Profiler trace of the block: ``with trace("out") as d: run(...)``
    records CPU activity, and CUDA activity when a CUDA device is present,
    and writes a Chrome trace ``<logdir>/trace.json`` (open it in
    ``chrome://tracing`` or Perfetto) when the block ends.  Yields
    ``logdir``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield logdir
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))


@contextlib.contextmanager
def timed(label="block", sink=None):
    """Wall-clock seconds of the block: yields a record ``{"label": ...}``
    that gets ``"seconds"`` when the block ends, and is appended to
    ``sink`` (a list) when one is given."""
    t0 = time.perf_counter()
    rec = {"label": label}
    try:
        yield rec
    finally:
        rec["seconds"] = time.perf_counter() - t0
        if sink is not None:
            sink.append(rec)


def throughput_report(chain, n_chains=1, n_leaps=None):
    """steps/s, leapfrog/s and ESS/s of a finished chain: ``run_time_s``
    (the chain's ``run_time``), ``steps_per_sec`` (every transition of the
    run, burn-in included, times ``n_chains``), ``leapfrog_per_sec``
    (``steps_per_sec * n_leaps``, when ``n_leaps`` is given),
    ``ess_per_param`` (:func:`~..stats.ess.ess` of the kept draws) and
    ``ess_per_sec`` (the smallest ESS times ``n_chains`` over the run
    time).  The ESS keys are left out when the ESS cannot be computed."""
    from ..stats.ess import ess

    if isinstance(chain.range, range):
        nsteps = chain.range.stop - 1
    else:
        nsteps = len(chain.range)
    dt = chain.run_time
    rep = {
        "run_time_s": dt,
        "steps_per_sec": nsteps * n_chains / dt,
    }
    if n_leaps is not None:
        # from steps_per_sec, so that the two rates agree exactly
        rep["leapfrog_per_sec"] = rep["steps_per_sec"] * n_leaps
    try:
        e = np.asarray(ess(chain))
        rep["ess_per_param"] = e
        rep["ess_per_sec"] = float(np.min(e)) * n_chains / dt
    except Exception:  # noqa: BLE001 - as the JAX package: report without it
        pass
    return rep
