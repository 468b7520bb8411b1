"""Samplers ported so far: fixed-metric HMC, exact NUTS and their
machinery."""
from .base import EmpMCTuner, RunCtx, Sampler, TuneState, tuner_init, tuner_update
from .hmc import HMC, HMCState
from .nuts import NUTS, NUTSState

__all__ = ["EmpMCTuner", "RunCtx", "Sampler", "TuneState", "tuner_init",
           "tuner_update", "HMC", "HMCState", "NUTS", "NUTSState"]
