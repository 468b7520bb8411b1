"""Runners: SerialMC, the ensemble runners (SeqMC, SerialTempMC, PTMC,
AIES, ASMC), run_until and the run/resume/prun entry points."""
from .serialmc import SerialMC
from .seqmc import SeqMC
from .serialtempmc import SerialTempMC
from .ptmc import PTMC
from .aies import AIES
from .asmc import ASMC
from .api import run, resume, prun
from .convergence import ConvergenceResult, run_until

__all__ = ["SerialMC", "SeqMC", "SerialTempMC", "PTMC", "AIES", "ASMC", "run",
           "resume", "prun", "run_until", "ConvergenceResult"]
