"""Samplers ported so far: HMC (fixed step, EmpMCTuner, diagonal mass
adaptation), HMCDA, MALA, exact NUTS, ChEES-HMC, RWM and their machinery."""
from .base import EmpMCTuner, RunCtx, Sampler, TuneState, tuner_init, tuner_update
from .chees import ChEESHMC, ChEESState
from .hmc import HMC, HMCState
from .hmcda import HMCDA, HMCDAState
from .mala import MALA, MALAState
from .nuts import NUTS, NUTSState
from .rwm import RWM, RWMState

__all__ = ["EmpMCTuner", "RunCtx", "Sampler", "TuneState", "tuner_init",
           "tuner_update", "ChEESHMC", "ChEESState", "HMC", "HMCState",
           "HMCDA", "HMCDAState", "MALA", "MALAState", "NUTS", "NUTSState",
           "RWM", "RWMState"]
