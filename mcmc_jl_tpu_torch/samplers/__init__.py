"""Samplers ported so far: HMC (fixed step, EmpMCTuner, diagonal and dense
mass adaptation), HMCDA, MALA, exact NUTS, WALNUTS, ChEES-HMC, RWM, Barker,
IMH, RAM, the manifold tier (SMMALA, PMALA, RMHMC, ERMLMC, RMLMC), the
standalone slice sampler, and their machinery."""
from .base import EmpMCTuner, RunCtx, Sampler, TuneState, tuner_init, tuner_update
from .barker import Barker, BarkerState
from .chees import ChEESHMC, ChEESState
from .hmc import HMC, HMCState
from .hmcda import HMCDA, HMCDAState
from .imh import IMH, IMHState
from .lagrangian import ERMLMC, RMLMC, LMCState
from .mala import MALA, MALAState
from .nuts import NUTS, NUTSState
from .pmala import PMALA, PMALAState
from .ram import RAM, RAMState
from .rmhmc import RMHMC, RMHMCState
from .rwm import RWM, RWMState
from .slice import slice_sample
from .smmala import SMMALA, SMMALAState
from .walnuts import WALNUTS

__all__ = ["EmpMCTuner", "RunCtx", "Sampler", "TuneState", "tuner_init",
           "tuner_update", "Barker", "BarkerState", "ChEESHMC", "ChEESState",
           "HMC", "HMCState", "HMCDA", "HMCDAState", "IMH", "IMHState",
           "MALA", "MALAState", "NUTS", "NUTSState", "RAM", "RAMState",
           "RWM", "RWMState", "WALNUTS", "SMMALA", "SMMALAState", "PMALA",
           "PMALAState", "RMHMC", "RMHMCState", "ERMLMC", "RMLMC",
           "LMCState", "slice_sample"]
