"""Samplers ported so far: fixed-metric HMC and its machinery."""
from .base import EmpMCTuner, RunCtx, Sampler, TuneState, tuner_init, tuner_update
from .hmc import HMC, HMCState

__all__ = ["EmpMCTuner", "RunCtx", "Sampler", "TuneState", "tuner_init",
           "tuner_update", "HMC", "HMCState"]
