"""Runners: SerialMC and the run/resume/prun entry points."""
