"""GPU smoke run of the PyTorch/CUDA port (``mcmc_jl_tpu_torch``).

Builds the CUDA kernels from the sources in this checkout (one ``nvcc`` per
source, started together), holds each kernel against its plain PyTorch
version on the card, and drives the main paths on Bayesian logistic
regression (d = 10; ``bench.py``'s data) through ``run(..., chains=N)``:

- N = 1000, 4096 chains: ``HMC(10, 0.05)`` under ``SerialMC``, checked
  against the generic engine; exact ``NUTS(maxdoublings=6)`` (warmup on the
  generic engine, sampling through the NUTS kernels);
- N = 100,000: plain ``HMC(10, 0.005)`` through the N-tiled gradient
  kernel (4096 chains), checked against the generic engine, and adaptive
  HMC through the tiled kernel (512 chains);
- N = 1000: adaptive HMC with a diagonal metric (4096 chains), ``HMCDA``
  and adaptive ``MALA`` (1024 chains) through the Halton multistep kernel,
  and ``ChEESHMC`` (4096 chains, the pooled adaptation on the generic
  engine);

the warm-start runs checked against long continuations of plain HMC; the
custom-target paths (d = 10, ``benchmarks/benchunits/fused_target.py``'s
sizes): ``run(model(x ~ D) * HMC(10, eps) * SerialMC(300, 100),
chains=4096)`` for Gamma(3, 0.2), Normal(1, 1) and Laplace(0, 1), plain
``MALA`` on the Gamma model, ``run_target_hmc_multistep`` and
``run_target_rwm``, each checked against the target's exact moments (the
``run`` paths also against the generic engine); and the adaptive samplers
on a catalog model of ten bare distributions (exact NUTS with and without
a diagonal metric through the target-mode NUTS kernel, adaptive HMC,
MALA and ChEES through the trajectory kernel), checked against the exact
moments.  The dense metric (``mass_adapt="dense"``) runs through the
matrix-prior variants of kernels 3b, 4, 8 and 9: adaptive HMC and NUTS on
the logistic GLM at N = 1000 (4096 chains) and N = 100,000 (512 chains),
the NUTS run's resume, and ``benchmarks/benchunits/mass_metric.py``'s
correlated Gaussian as a linear GLM, held to its known covariance, with
its ESS/s beside the diagonal metric's; the four variants are then held
against their plain versions on those runs' own folds.  GLMs wider than 32
parameters run kernels 1, 2, 3, 3b and 4 (and the _mat variants) on the
wide chain tile: each is held against its plain version at d 33, 64, 150
and 256 (``phase_wide_kernels``), and a logistic regression of d 150
(``wide_data``) drives plain HMC, the drivers of 2 and 3, adaptive HMC with
a diagonal and a dense metric at N 1000 and N 100,000, and one resume,
each held against the generic engine (``phase_wide_paths``).  Exact NUTS
runs there too: kernels 8 and 9 (and _mat) on the wide tile are held
against their plain versions at d 33, 64, 150 and 256
(``phase_wide_nuts_kernels``), and the d 150 model drives ``NUTS(6)``
with the unit, diagonal and dense metrics and two resumes, each held
against the generic engine (``phase_wide_nuts_paths``).  GLMs of 257 to
1024 parameters run kernels 1, 2, 3, 3b and 4 (and the _mat variants) on
the very-wide chain tile: each is held against its plain version at d
257, 512 and 1024 with the scalar, row and matrix priors
(``phase_xwide_kernels``), and a logistic regression of d 1024 drives
plain HMC, the drivers of 2 and 3, and adaptive HMC with a diagonal and a
dense metric at N 1000 and N 20,000, each held against the generic engine
(``phase_xwide_paths``); ``phase_xwide_times`` times them at d 512 and
1024 beside the generic engine.  Exact NUTS runs there too: kernels 8 and
9 (and _mat) on the very-wide tile are held against their plain versions
at d 257, 512 and 1024, kernel 9's five draw ranges disjoint at d 1024
(``phase_xwide_nuts_kernels``); the d 1024 model drives ``NUTS(6)`` with
the unit, diagonal and dense metrics and a resume, each held against
kernel 1's HMC run; NUTS at d 1025 takes the chunked tier with no reason
logged (``phase_xwide_nuts_paths``); ``phase_xwide_nuts_times`` times
the kernels at d 512 and 1024.  GLMs of 1025 to 16384 parameters run
kernels 1, 2, 3, 3b and 4 (and the _mat variants) on the chunked tier:
each is held against its plain version at d 1056, 2048 and 4096 (1 and 4
also at 8192 and 16384; ``phase_chunked_kernels``), and logistic
regressions of d 4096 (N 1000 and 20,000; the dense metric at d 2048)
drive plain HMC, the drivers of 2 and 3, adaptive HMC with a diagonal and
a dense metric and a resume, each held against the generic engine
(``phase_chunked_paths``); ``phase_chunked_times`` times the kernels at
d 4096.  Exact NUTS runs there too: kernels 8 and 9 (and _mat) on the
chunked tier are held against their plain versions at d 1056, 2048 and
4096 (8 also at 16384), kernel 9's five draw ranges disjoint at d 16384
(``phase_chunked_nuts_kernels``); from the posterior mode, the d 4096
model drives ``NUTS(6)`` with the unit and diagonal metrics, and the d
2048 one the dense metric and a resume, each held against the adaptive
HMC run from the same mode; NUTS at d 16385 takes the generic engine with
the GLM kernels' bound as its reason (``phase_chunked_nuts_paths``);
``phase_chunked_nuts_times`` times the kernels at d 4096.  The dense
metric on catalog
targets runs kernels 5 and 8b on the z-space target ``z -> target(z L')``
(their DENSE instantiations): each is held against its plain version at d
1-1024 (``phase_dense_target_kernels``), and dense ``NUTS(6)`` on the ten
bare distributions and dense adaptive HMC on Gamma(3, 0.2) run through
``run(..., chains=4096)``, held against the exact moments and the generic
engine (``phase_dense_target_paths``).  Then
``resume(chains, steps=S)`` continues the chains of nine
of these runs, each as one batch through the kernels its frozen state
takes (3b, 9, 8, 4, 5 and 8b, and 5 and 8b dense), with the frozen
hyper-parameters, ``pos``,
the moments and repeatability checked and the time beside a chain-by-chain
resume; a mixed list keeps its order, and a ``save_chain``/``load_chain``
round trip resumes bit for bit.  Then the samplers that run on the
generic engine in both packages: Barker and WALNUTS on a Gamma catalog
model (every gradient one launch of the gradient pass, never a NUTS
kernel), IMH and RAM on a Normal one, and ``slice_sample``, each held to
its target's exact moments, and WAIC and PSIS-LOO of the HMC main path's
last draws (``phase_generic_samplers``); and the manifold tier (SMMALA,
PMALA, RMHMC, ERMLMC, RMLMC) on ``benchmarks/benchunits/manifold.py``'s
Fisher-metric logistic model, held against kernel 1's HMC on the same
data, with SMMALA and RMHMC on a Gamma catalog model through the gradient
pass, held to its exact moments (``phase_manifold_samplers``); and the
ensemble runners (``phase_ensemble_runners``): ``run_until`` with NUTS
and adaptive HMC on the main path's model at 4096 chains (its frozen
blocks through kernels 9 and 3b), ``benchmarks/benchunits/
population.py``'s PTMC and ASMC and an AIES ensemble held against kernel
1's HMC, ``examples/model_comparison.py``'s evidence by ASMC and by the
prior-tempered PTMC against the exact logZ, ``SeqMC`` and
``SerialTempMC`` on their test gates, and a PTMC ladder on a catalog
model through the gradient pass; the distributed drivers on meshes of
virtual shards of the card (``phase_mesh_paths``); the NUTS warm handoff,
``NUTS(6, warm_handoff=True)``, through kernels 3b (and two resumes), 5
and 4 (``phase_warm_handoff``); and ``examples_torch/
warmstart_logistic.py``'s ``main`` at 2048 chains and its continuation,
with ``utils.profiling.throughput_report``'s leapfrog/s and min-ESS/s, and
one kernel-1 run under ``utils.profiling.trace``, whose Chrome trace must
name the kernel (``phase_examples``).  It also runs the HMC step
and multi-transition kernels through their drivers, times drivers and
kernels beside their plain versions and the least time the card could take
for the same work, and prints one JSON line per phase.
The last four lines are the resume phase's summary, the kernels' report
(with each kernel's launches counted from zero over the one run that
reaches it), the card's name and power limit, and ``{"ok": true,
"device": {...}}``.

Run with no arguments on a machine with one CUDA card::

    python3 chip_smoke.py

It exits non-zero without a CUDA device, and on any failed check.
``python3 chip_smoke.py --times [ROOT] [--only g1,g2]`` builds only the
libraries that the named timing groups need (TIME_GROUPS; default all)
from the package under ROOT and times their kernels (1-4, 8, 9, 3b, 8b
and 5-7; the wide tile's at d 150 and 256 with the group ``wide``, its
paths against the generic engine with ``wide_paths``, the wide NUTS
kernels with ``wide_nuts`` and their paths with ``wide_nuts_paths``, the
very-wide tile's at d 512 and 1024 and its paths' fused and generic
seconds with ``xwide``, the very-wide NUTS kernels with ``xwide_nuts``,
the chunked tier's at d 2048 and 4096 and its paths' fused and generic
seconds with ``chunked``, the chunked NUTS kernels and their paths' with
``chunked_nuts``) at
pinned shapes, the paths that run them and bench.py's drivers, to compare
two trees on one card; ``python3 chip_smoke.py --only chunked_nuts`` runs
the chunked NUTS phases alone (ONLY_GROUPS); ``python3 chip_smoke.py
--sass`` prints the instruction mix of the HMC tile kernels' row loops.
"""
import contextlib
import functools
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

SOURCES = {"glm_hmc": "mcmc_jl_tpu_torch/csrc/glm_hmc.cu",
           "glm_nuts": "mcmc_jl_tpu_torch/csrc/glm_nuts.cu",
           "glm_bign": "mcmc_jl_tpu_torch/csrc/glm_bign.cu",
           "target_hmc": "mcmc_jl_tpu_torch/csrc/target_hmc.cu",
           "target_rwm": "mcmc_jl_tpu_torch/csrc/target_rwm.cu",
           "target_nuts": "mcmc_jl_tpu_torch/csrc/target_nuts.cu"}
# kernel -> (library, the Pallas kernel it replaces)
REPLACES = {
    "glm_leapfrogs": ("glm_hmc", "mcmc_jl_tpu/ops/pallas_glm.py:244"),
    "glm_step": ("glm_hmc", "mcmc_jl_tpu/ops/pallas_glm.py:282"),
    "glm_multistep": ("glm_hmc", "mcmc_jl_tpu/ops/pallas_glm.py:344"),
    "glm_nuts_transition": ("glm_nuts", "mcmc_jl_tpu/ops/pallas_nuts.py:76"),
    "glm_nuts_multistep": ("glm_nuts", "mcmc_jl_tpu/ops/pallas_nuts.py:821"),
    # the halton=True, collect_rows=True variant of the same kernel body
    "glm_multistep_rows": ("glm_hmc", "mcmc_jl_tpu/ops/pallas_glm.py:344"),
    "glm_logp_grad_tiled": ("glm_bign",
                            "mcmc_jl_tpu/ops/pallas_glm_bign.py:44"),
    "target_leapfrogs": ("target_hmc", "mcmc_jl_tpu/ops/pallas_target.py:67"),
    "target_multistep": ("target_hmc",
                         "mcmc_jl_tpu/ops/pallas_target.py:198"),
    "target_rwm_steps": ("target_rwm", "mcmc_jl_tpu/ops/pallas_rwm.py:50"),
    # _nuts_kernel in target mode (its pallas_call at pallas_nuts.py:695)
    "target_nuts_transition": ("target_nuts",
                               "mcmc_jl_tpu/ops/pallas_nuts.py:76"),
    # no Pallas kernel: the generic engine's gradient on a catalog model,
    # which the JAX package leaves to XLA (jax.value_and_grad of the model)
    "target_logp_grad": ("target_hmc", "mcmc_jl_tpu/models/model.py:361"),
    # the mat_prior=True variants (the dense-metric fold's (d, d) prior;
    # the Pallas prior term at pallas_glm.py:170, pallas_glm_bign.py:84,
    # pallas_nuts.py:123-127 and :855-859): one kernel each, selected by a
    # non-null matrix, counted apart
    "glm_multistep_rows_mat": ("glm_hmc",
                               "mcmc_jl_tpu/ops/pallas_glm.py:344"),
    "glm_logp_grad_tiled_mat": ("glm_bign",
                                "mcmc_jl_tpu/ops/pallas_glm_bign.py:44"),
    "glm_nuts_transition_mat": ("glm_nuts",
                                "mcmc_jl_tpu/ops/pallas_nuts.py:76"),
    "glm_nuts_multistep_mat": ("glm_nuts",
                               "mcmc_jl_tpu/ops/pallas_nuts.py:821"),
    # the same kernels on the wide tile (32 < d <= 256; the Pallas kernels
    # pad d to 128 lanes and take any d whose design fits in VMEM), counted
    # apart
    "glm_leapfrogs_wide": ("glm_hmc", "mcmc_jl_tpu/ops/pallas_glm.py:244"),
    "glm_step_wide": ("glm_hmc", "mcmc_jl_tpu/ops/pallas_glm.py:282"),
    "glm_multistep_wide": ("glm_hmc", "mcmc_jl_tpu/ops/pallas_glm.py:344"),
    "glm_multistep_rows_wide": ("glm_hmc",
                                "mcmc_jl_tpu/ops/pallas_glm.py:344"),
    "glm_multistep_rows_mat_wide": ("glm_hmc",
                                    "mcmc_jl_tpu/ops/pallas_glm.py:344"),
    "glm_logp_grad_tiled_wide": ("glm_bign",
                                 "mcmc_jl_tpu/ops/pallas_glm_bign.py:44"),
    "glm_logp_grad_tiled_mat_wide": ("glm_bign",
                                     "mcmc_jl_tpu/ops/pallas_glm_bign.py:44"),
    "glm_nuts_transition_wide": ("glm_nuts",
                                 "mcmc_jl_tpu/ops/pallas_nuts.py:76"),
    "glm_nuts_multistep_wide": ("glm_nuts",
                                "mcmc_jl_tpu/ops/pallas_nuts.py:821"),
    "glm_nuts_transition_mat_wide": ("glm_nuts",
                                     "mcmc_jl_tpu/ops/pallas_nuts.py:76"),
    "glm_nuts_multistep_mat_wide": ("glm_nuts",
                                    "mcmc_jl_tpu/ops/pallas_nuts.py:821"),
    # the HMC-family kernels on the very-wide tile (256 < d <= 1024), counted
    # apart
    "glm_leapfrogs_xwide": ("glm_hmc", "mcmc_jl_tpu/ops/pallas_glm.py:244"),
    "glm_step_xwide": ("glm_hmc", "mcmc_jl_tpu/ops/pallas_glm.py:282"),
    "glm_multistep_xwide": ("glm_hmc", "mcmc_jl_tpu/ops/pallas_glm.py:344"),
    "glm_multistep_rows_xwide": ("glm_hmc",
                                 "mcmc_jl_tpu/ops/pallas_glm.py:344"),
    "glm_multistep_rows_mat_xwide": ("glm_hmc",
                                     "mcmc_jl_tpu/ops/pallas_glm.py:344"),
    "glm_logp_grad_tiled_xwide": ("glm_bign",
                                  "mcmc_jl_tpu/ops/pallas_glm_bign.py:44"),
    "glm_logp_grad_tiled_mat_xwide": ("glm_bign",
                                      "mcmc_jl_tpu/ops/pallas_glm_bign.py:44"),
    # the HMC-family kernels on the chunked tier (1024 < d <= 16384),
    # counted apart
    "glm_leapfrogs_chunked": ("glm_hmc", "mcmc_jl_tpu/ops/pallas_glm.py:244"),
    "glm_step_chunked": ("glm_hmc", "mcmc_jl_tpu/ops/pallas_glm.py:282"),
    "glm_multistep_chunked": ("glm_hmc", "mcmc_jl_tpu/ops/pallas_glm.py:344"),
    "glm_multistep_rows_chunked": ("glm_hmc",
                                   "mcmc_jl_tpu/ops/pallas_glm.py:344"),
    "glm_multistep_rows_mat_chunked": ("glm_hmc",
                                       "mcmc_jl_tpu/ops/pallas_glm.py:344"),
    "glm_logp_grad_tiled_chunked": ("glm_bign",
                                    "mcmc_jl_tpu/ops/pallas_glm_bign.py:44"),
    "glm_logp_grad_tiled_mat_chunked": (
        "glm_bign", "mcmc_jl_tpu/ops/pallas_glm_bign.py:44"),
    # the exact-NUTS kernels on the very-wide tile (256 < d <= 1024),
    # counted apart
    "glm_nuts_transition_xwide": ("glm_nuts",
                                  "mcmc_jl_tpu/ops/pallas_nuts.py:76"),
    "glm_nuts_multistep_xwide": ("glm_nuts",
                                 "mcmc_jl_tpu/ops/pallas_nuts.py:821"),
    "glm_nuts_transition_mat_xwide": ("glm_nuts",
                                      "mcmc_jl_tpu/ops/pallas_nuts.py:76"),
    "glm_nuts_multistep_mat_xwide": ("glm_nuts",
                                     "mcmc_jl_tpu/ops/pallas_nuts.py:821"),
    # the exact-NUTS kernels on the chunked tier (1024 < d <= 16384),
    # counted apart
    "glm_nuts_transition_chunked": ("glm_nuts",
                                    "mcmc_jl_tpu/ops/pallas_nuts.py:76"),
    "glm_nuts_multistep_chunked": ("glm_nuts",
                                   "mcmc_jl_tpu/ops/pallas_nuts.py:821"),
    "glm_nuts_transition_mat_chunked": ("glm_nuts",
                                        "mcmc_jl_tpu/ops/pallas_nuts.py:76"),
    "glm_nuts_multistep_mat_chunked": ("glm_nuts",
                                       "mcmc_jl_tpu/ops/pallas_nuts.py:821"),
    # kernels 5 and 8b on the z-space target of a frozen dense metric (the
    # JAX package's _dense_wrap, mcmc_jl_tpu/ops/warmstart.py:581-624, which
    # feeds the same two Pallas kernels): the DENSE instantiations, counted
    # apart
    "target_leapfrogs_dense": ("target_hmc",
                               "mcmc_jl_tpu/ops/pallas_target.py:67"),
    "target_nuts_transition_dense": ("target_nuts",
                                     "mcmc_jl_tpu/ops/pallas_nuts.py:76"),
}
# kernel vs plain version on the same inputs: both are float32 with sums in
# another order (sequential per chain in the kernel, blocked matmuls in the
# plain version), so differences are a few float32 ulps of each value,
# grown a little over a 10-step trajectory
RTOL, ATOL = 1e-4, 1e-4
LP_RTOL, LP_ATOL = 1e-5, 1e-3
# a gradient component is a sum of N = 1000 terms r_n x_n that largely
# cancel: its rounding error scales with N ulps of the terms, not with the
# (possibly near-zero) result
G_ATOL = 2e-3
# accept decisions may differ only where the MH ratio is this close to logu
ACC_BAND = 1e-4
# step size of the transition check: at the main path's 0.05 nearly every
# proposal is accepted, and the check needs both outcomes
STEP_EPS = 0.12
# statistical agreement, in Monte Carlo standard errors
Z_MAX = 5.0
# kernel 8b vs its plain version: a chosen theta that differs by more than
# this (relative to 1 + |theta|) marks another path; on the chains on the
# same path the gradient and lp are held to it as well (up to 63 leapfrogs
# whose family formulas round apart by a few ulps, lp and the u-turn dots
# summed in another order)
NUTS_T_TOL = 1e-3
# the warm target paths without a metric are held to the exact moments of
# the coordinates with at most this sd (their step is set by the narrowest
# coordinates, sd 0.2; Normal(3, 12) and Gamma(1, 2) are not crossed in
# 800-1000 transitions at that step)
NARROW_SD = 0.75
# NUTS kernel vs plain version on the same pre-drawn noise: a slice, u-turn
# or reservoir decision within float32 rounding of a tie may go the other
# way (the kernel sums lp in double and the dot products in another order),
# so at least this share of chains must take the same discrete path: equal
# ndoublings and diverging, and the same chosen leaf (theta within
# LEAF_ATOL; neighbouring leaves lie eps |m| ~ 1e-2 or more apart)
PATH_AGREE = 0.995
LEAF_ATOL = 1e-3
# multistep NUTS kernel check: mean tree depth of the kernel and of its plain
# version (or the per-transition driver) within this fraction of each other
DEPTH_RTOL = 0.05
# N-tiled kernel vs its plain version run in float64 on the same inputs: a
# gradient component is a sum of N terms w_n r_n x_nj that cancel, so its
# error is held to the L1 mass of the terms (plus the prior's), not to a
# fixed atol
TILED_G_L1, TILED_LP_L1 = 1e-5, 1e-6
# custom-target kernels vs plain versions: every coordinate's derivative is
# computed alone (no sums), the kick and drift round as the plain version
# does, so theta, m and g differ by the family formulas' rounding (logf,
# powf, a division written another way), grown over a 10-step trajectory;
# lp is a sum of d terms in another order, so its atol grows with d
T_RTOL, T_ATOL = 1e-4, 1e-4
T_LP_RTOL, T_LP_ATOL_PER_COORD = 1e-5, 1e-5
# multi-transition and RWM kernels from the same draws (given as input, or
# the kernel's Philox draws replayed on the host to within a few float32
# ulps): the trajectories and proposals round alike, so a chain may leave
# the plain version's path only at a transition whose MH ratio lay this
# close to log u (lp near -15 has a float32 ulp of 1e-6)
T_BAND = 1e-4
# the multi-transition kernel on its replayed draws: momenta a few ulps off
# the kernel's grow over k x 10 leapfrogs, most where Gamma(3, 0.2)'s
# gradient 2/x - 5 is stiff near 0 (a CPU rehearsal with the momenta moved
# by up to 2 ulps, 6 x 4096 chains x 10 transitions: |dtheta| / (1 +
# |theta|) at most 5.3e-5), so theta is held to MS_TOL (1 + |theta|); the
# kernel's lp and gradient are held to the plain version's at the kernel's
# own theta (where the lp and gradient amplify that drift)
MS_TOL = 1e-3
# FP32 operations the bound counts per coordinate: one leapfrog (two kicks
# and a drift of 3 each, the family's derivative about 8, counting logf or
# powf as one) and one RWM step (proposal 2, family log-density about 6,
# the sum and the test 2)
TARGET_LEAP_OPS, TARGET_STEP_OPS = 20, 10
# and one (logp, gradient) pass: the family's log-density and derivative,
# about 10 per coordinate counting logf or powf as one
TARGET_EVAL_OPS = 10
# the floor of the RWM kernel's random numbers: a Philox4x32-10 call is
# ten rounds of two 32 x 32 -> 64-bit products, an IMAD for each word of
# each (40), at 64 IMAD per clock on an SM (the integer pipe's rate)
PHILOX_IMAD, IMAD_PER_CLOCK = 40, 64
# special-function results the custom-target floors count (each logf, sqrtf
# and IEEE division one): an RWM step of a Normal coordinate (half a logf
# and half a sqrtf of its Box-Muller pair, the family's division) and of a
# chain (a quarter of a logf: four log-uniforms a Philox call); a leapfrog
# of a Gamma coordinate (its derivative's two divisions) and its final lp
# (a logf and a division)
RWM_SFU_COORD, RWM_SFU_CHAIN = 2, 0.25
LEAP_SFU_COORD, LP_SFU_COORD = 2, 2
# the card's published peaks (one H100 SXM at 700 W): FP32 outside the
# tensor cores, dense TF32 on them, and HBM bandwidth; a kernel's bound is
# the larger of its operations and its bytes over these
FP32_FLOPS, TF32_FLOPS, HBM_BYTES_S = 67e12, 495e12, 3.35e12
# float32 products on the tensor cores: the GLM tile kernels issue three
# TF32 products (3xTF32) for each float32 one
TF32X3_FLOPS = TF32_FLOPS / 3

# the NUTS kernels' pinned timing shapes (phase_nuts_times): the step that
# the unit-metric NUTS main path froze at (phase_nuts_main_path's
# frozen_eps on an H100 80GB HBM3), and the numpy seed of the chains' start
NUTS_TIME_EPS = 0.08426558971405029
NUTS_TIME_SEED = 71
# kernel 3b's timing shape: the step and leap count that adaptive HMC with
# a diagonal metric froze at on its path (phase_warm_paths' frozen_step and
# frozen_n_leaps on an H100 80GB HBM3), so --times reaches it without the
# warmup
ROWS_TIME_FROZEN = (0.53101646900177, 2)
# kernel 8b's timing shape: the step that unit-metric NUTS on the ten bare
# distributions froze at (phase_warm_target_paths' frozen_eps on an H100
# 80GB HBM3), and the seed of the chains' start (exact draws of each
# coordinate's distribution)
TARGET_NUTS_TIME_EPS = 0.008297648280858994
TARGET_NUTS_TIME_SEED = 72
# kernel 5's timing shape on the ten bare distributions: the step and leap
# count that adaptive HMC with a diagonal metric froze at on its path
# (phase_warm_target_paths' frozen_step and frozen_n_leaps on an H100 80GB
# HBM3)
TARGET_TIME_FROZEN = (0.001015600049868226, 200)

CARD = {}


def emit(obj):
    print(json.dumps(obj), flush=True)


def bench_data(n=1000, nbeta=10):
    """bench.py ``_data``: the main path's logistic-regression data, seed 1."""
    rng = np.random.default_rng(1)
    Xh = np.column_stack([np.ones(n), rng.standard_normal((n, nbeta - 1))])
    beta0 = rng.standard_normal(nbeta)
    Yh = (rng.random(n) < 1.0 / (1.0 + np.exp(-Xh @ beta0))).astype(np.float64)
    return Xh, Yh


def phase_device():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this script needs one card", file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    line = smi.stdout.strip().splitlines()[0]
    print(line, flush=True)
    CARD.update(card=line, kind=torch.cuda.get_device_name(0),
                count=torch.cuda.device_count())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "device", "card": line, "torch": torch.__version__,
          "cuda": torch.version.cuda, "count": CARD["count"]})


def phase_build(names=None):
    """Every library (or those named), one nvcc each, started together."""
    from concurrent.futures import ThreadPoolExecutor

    from mcmc_jl_tpu_torch.ops import (cuda_build, glm_bign, glm_kernels,
                                      nuts_kernels, rwm_kernels,
                                      target_kernels)

    names = tuple(names or SOURCES)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:
        built = dict(zip(names, pool.map(cuda_build.build, names)))
    loaders = {"glm_hmc": glm_kernels.load_kernels,
               "glm_nuts": nuts_kernels.load_kernels,
               "glm_bign": glm_bign.load_kernels,
               "target_hmc": target_kernels.load_kernels,
               "target_rwm": rwm_kernels.load_kernels,
               "target_nuts": nuts_kernels.load_target_kernels}
    for name in names:
        loaders[name]()
    for name, (path, report) in built.items():
        ptxas, entry = [], "?"
        for ln in report.splitlines():
            # mangled '...<len><name>ILi<D>ELb0EE...' -> name<D, 0>
            hit = re.search(r"Compiling entry function .*?\d+((?:[a-z]+_)+"
                            r"kernel)(?:I((?:L[ib]\d+E)+)E)?", ln)
            if hit:
                args = re.findall(r"\d+", hit.group(2) or "")
                entry = hit.group(1) + (f"<{', '.join(args)}>" if args
                                        else "")
            elif "registers" in ln or "spill" in ln:
                ptxas.append(f"{entry}: {ln.strip()}")
        emit({"phase": "build", "source": SOURCES[name],
              "seconds": time.perf_counter() - t0,
              "library": str(path.relative_to(
                  cuda_build.BUILD_ROOT.parent.parent)), "ptxas": ptxas})
        for ln in ptxas:
            if "spill" in ln:
                print(f"ptxas {name} {ln}", flush=True)


def _mat_or_none(prior):
    """``prior`` when it is a (d, d) matrix (the dense fold), else None: the
    wrappers' ``_counted`` then names the variant a check ran."""
    return prior if getattr(prior, "ndim", 0) == 2 else None


def _err(a, b):
    d = (a - b).abs()
    return {"max_abs": float(d.max()),
            "max_rel": float((d / b.abs().clamp_min(1e-6)).max())}


def _cuda(a):
    import torch

    return None if a is None else torch.as_tensor(
        a, dtype=torch.float32, device="cuda").contiguous()


def _z_t(a, b):
    """max |mean difference| / se of two sets of per-chain values (torch,
    one row per chain)."""
    se = (a.var(0) / a.shape[0] + b.var(0) / b.shape[0]).sqrt()
    return float(((a.mean(0) - b.mean(0)).abs() / se.clamp_min(1e-12)).max())


def _z_means(a, b):
    """max |mean difference| / se of two sets of independent per-chain
    means, one row per chain (numpy)."""
    se = np.sqrt(a.var(0) / len(a) + b.var(0) / len(b))
    return float(np.max(np.abs(a.mean(0) - b.mean(0)) / se))


def _close(a, b, rtol, atol):
    return bool(((a - b).abs() <= atol + rtol * b.abs()).all())


def _inputs(C, seed):
    from mcmc_jl_tpu_torch.ops.glm_kernels import glm_funcs

    X, Y = bench_data()
    rng = np.random.default_rng(seed)
    d = X.shape[1]
    XT, Yc = _cuda(X.T), _cuda(Y)
    theta = _cuda(0.1 * rng.standard_normal((C, d)))
    m0 = _cuda(rng.standard_normal((C, d)))
    logu = _cuda(np.log(rng.random(C)))
    lp, g = glm_funcs(XT, Yc, None, None, 1.0, "logistic")[1](theta)
    return XT, Yc, theta, m0, logu, lp.contiguous(), g.contiguous()


def _other_inputs(kind, N=5000, d=7, C=300, seed=6):
    """A weighted, offset GLM of each link at N = 5000 (past the kernel's
    shared-memory budget) with C = 300 chains (a ragged last block)."""
    from mcmc_jl_tpu_torch.ops.glm_kernels import glm_funcs

    rng = np.random.default_rng(seed)
    X = np.column_stack([np.ones(N), rng.standard_normal((N, d - 1))]) * 0.3
    z = X @ rng.standard_normal(d)
    Y = {"linear": z + rng.standard_normal(N),
         "poisson": rng.poisson(np.exp(z)).astype(float)}.get(
        kind, (rng.random(N) < 1 / (1 + np.exp(-z))).astype(float))
    W, O = _cuda(rng.uniform(0.5, 2.0, N)), _cuda(0.1 * rng.standard_normal(N))
    XT, Yc = _cuda(X.T), _cuda(Y)
    theta = _cuda(0.05 * rng.standard_normal((C, d)))
    m0 = _cuda(rng.standard_normal((C, d)))
    _, g = glm_funcs(XT, Yc, W, O, 1.5, kind)[1](theta)
    kw = dict(n_leaps=3, kind=kind, weights=W, offsets=O, prior_prec=1.5,
              integrator="2stage")
    return {"args": (XT, Yc, theta, m0, g.contiguous(), 0.01), "kw": kw,
            "N": N, "C": C, "d": d}


def phase_kernels(C=4096, eps=0.05, n_leaps=10):
    """Each kernel against its plain version on the card."""
    import torch

    from mcmc_jl_tpu_torch.ops import glm_kernels as gk

    XT, Y, theta, m0, logu, lp, g = _inputs(C, seed=2)
    errors = {}

    # 1: trajectory, same inputs
    out_k = gk.glm_leapfrogs(XT, Y, theta, m0, g, eps, n_leaps=n_leaps)
    out_r = gk.glm_leapfrogs_ref(XT, Y, theta, m0, g, eps, n_leaps=n_leaps)
    torch.cuda.synchronize()
    rep = {n: _err(a, b) for n, a, b in zip(("theta", "m", "g", "lp"),
                                            out_k, out_r)}
    ok = (all(_close(a, b, RTOL, ATOL) for a, b in zip(out_k[:2], out_r[:2]))
          and _close(out_k[2], out_r[2], RTOL, G_ATOL)
          and _close(out_k[3], out_r[3], LP_RTOL, LP_ATOL))
    emit({"phase": "kernel", "name": "glm_leapfrogs", "C": C, "ok": ok, **rep})
    assert ok, "glm_leapfrogs disagrees with glm_leapfrogs_ref"
    errors["glm_leapfrogs"] = max(r["max_abs"] for r in rep.values())

    # 1, other paths: every link with weights and offsets, N past the
    # shared-memory budget (rows streamed tile by tile), a ragged last block
    # of chains, another parameter bound and integrator
    for kind in gk.KIND_CODES:
        oth = _other_inputs(kind)
        o_k = gk.glm_leapfrogs(*oth["args"], **oth["kw"])
        o_r = gk.glm_leapfrogs_ref(*oth["args"], **oth["kw"])
        torch.cuda.synchronize()
        scale = oth["N"] / 1000  # sums of N terms: tolerances grow with N
        ok = (all(_close(a, b, RTOL, ATOL) for a, b in zip(o_k[:2], o_r[:2]))
              and _close(o_k[2], o_r[2], RTOL, G_ATOL * scale)
              and _close(o_k[3], o_r[3], LP_RTOL, LP_ATOL * scale))
        emit({"phase": "kernel", "name": "glm_leapfrogs", "link": kind,
              "N": oth["N"], "C": oth["C"], "d": oth["d"], "ok": ok,
              **{n: _err(a, b) for n, a, b in zip(("theta", "m", "g", "lp"),
                                                  o_k, o_r)}})
        assert ok, f"glm_leapfrogs ({kind}, N={oth['N']}) disagrees"

    # 2: whole transition, same m0 and logu, at a step size large enough
    # (STEP_EPS) that both accepts and rejects occur
    errors["glm_step"] = _step_check("bench data", XT, Y, theta, m0, logu,
                                     STEP_EPS, mix=True, n_leaps=n_leaps)

    # 3: k transitions chain by chain on the kernel's own Philox draws,
    # replayed, against k successive glm_step_ref calls, at STEP_EPS
    errors["glm_multistep"] = _multistep_check(
        "bench data", XT, Y, theta, STEP_EPS, k=20, seed=41, mix=True,
        n_leaps=n_leaps)

    # 3, statistically: 200 transitions, in-kernel Philox vs
    # torch.Generator streams, and bitwise repeat for one seed
    k = 200
    gen = torch.Generator(device="cuda").manual_seed(3)
    res_k, res_k2 = (gk.glm_multistep(
        XT, Y, theta, eps, k_trans=k, n_leaps=n_leaps,
        generator=torch.Generator(device="cuda").manual_seed(12345))
        for _ in range(2))
    res_r = gk.glm_multistep_ref(XT, Y, theta, eps, k_trans=k,
                                 n_leaps=n_leaps, generator=gen)
    torch.cuda.synchronize()
    bitwise = all(torch.equal(a, b) for a, b in zip(res_k, res_k2))
    z_acc = _z_t(res_k[3], res_r[3])
    z_theta = _z_t(res_k[0], res_r[0])
    ok = (bitwise and z_acc < Z_MAX and z_theta < Z_MAX
          and bool(torch.isfinite(res_k[2]).all()))
    emit({"phase": "kernel", "name": "glm_multistep", "C": C, "k_trans": k,
          "ok": ok, "bitwise_repeat": bitwise,
          "accept_kernel": float(res_k[3].mean()),
          "accept_plain": float(res_r[3].mean()), "z_accept": z_acc,
          "pooled_theta_max_abs_diff": float(
              (res_k[0].mean(0) - res_r[0].mean(0)).abs().max()),
          "z_theta_max": z_theta})
    assert ok, "glm_multistep disagrees with glm_multistep_ref"
    return errors


def _counted(fn):
    """Run ``fn`` with every launch and plain-call count zeroed just before
    it; returns (its result, the launch counts read just after it)."""
    import torch

    from mcmc_jl_tpu_torch.ops import glm_bign as gb
    from mcmc_jl_tpu_torch.ops import glm_kernels as gk
    from mcmc_jl_tpu_torch.ops import nuts_kernels as nk
    from mcmc_jl_tpu_torch.ops import rwm_kernels as rk
    from mcmc_jl_tpu_torch.ops import target_kernels as tk

    mods = (gk, nk, gb, tk, rk)
    for mod in mods:
        mod.reset_counts()
    out = fn()
    torch.cuda.synchronize()
    launches = {k: v for mod in mods for k, v in mod.LAUNCHES.items()}
    plain = {k: v for mod in mods for k, v in mod.PLAIN_CALLS.items()}
    assert not any(plain.values()), plain
    return out, launches


def phase_main_path(chains=4096, steps=1000, burnin=200, generic_chains=512):
    """The port's main path through its user entry points.  Returns the
    trajectory kernel's launches in ``run``, each chain's last state
    (chains, d) and the chains' tasks (for phase_resume_paths)."""
    import mcmc_jl_tpu_torch as mt

    X, Y = bench_data()
    m = mt.model(glm=("logistic", X, Y), device="cuda")
    task = m * mt.HMC(10, 0.05) * mt.SerialMC(steps=steps, burnin=burnin)

    t0 = time.perf_counter()
    with _spans() as spans:
        cs, launches = _counted(lambda: mt.run(task, chains=chains, seed=0))
    dt = time.perf_counter() - t0
    rose = launches["glm_leapfrogs"]
    assert launches == {**{k: 0 for k in launches},
                        "glm_leapfrogs": steps}, launches
    assert len(cs) == chains
    samples = np.stack([c.samples.values for c in cs])  # (chains, kept, d)
    assert samples.shape == (chains, steps - burnin, m.size)
    assert np.all(np.isfinite(samples))
    c0 = cs[0]
    pooled = samples.mean(axis=(0, 1))

    # both runs start every chain at the model's init: the per-chain means
    # are independent draws of one law, mixed or not, so their spread gives
    # the standard error of the pooled mean
    cg = mt.run(task, chains=generic_chains, seed=1, fused=False)
    gs = np.stack([c.samples.values for c in cg])
    z = _z_means(samples.mean(axis=1), gs.mean(axis=1))

    c1 = mt.resume(c0, steps=100)
    assert c1.samples.values.shape == (100, m.size)
    assert np.all(np.isfinite(c1.samples.values))
    ok = z < Z_MAX
    emit({"phase": "main_path", "chains": chains, "steps": steps,
          "seconds": dt, "spans_s": spans, "trajectory_launches": rose,
          "chain0": {"acceptance": mt.acceptance(c0),
                     "mean": mt.mean(c0).tolist(),
                     "ess": mt.ess(c0).tolist(),
                     "actime": mt.actime(c0).tolist()},
          "pooled_mean": pooled.tolist(),
          "generic_pooled_mean": gs.mean(axis=(0, 1)).tolist(),
          "z_max_vs_generic": z, "ok": ok,
          "resume_acceptance": mt.acceptance(c1), **CARD})
    assert ok, "fused main path disagrees with the generic engine"
    return ({"glm_leapfrogs": (rose, f"run(..., chains={chains})")},
            samples[:, -1], [c.task for c in cs])


def phase_drivers(final, steps=1000, thin=200):
    """The step and multi-transition kernels through the drivers that reach
    them (bench.py's phases: ``_run(fused_step=True)`` and
    ``_run_multistep``), each run once at the main path's size with the
    counts zeroed just before it.

    ``final`` is the main path's state after ``steps`` transitions, one row
    per chain.  The drivers start where it started (the model's init, 0)
    and make as many transitions of the same Markov kernel, so their final
    states have the same law whether or not the chains have mixed: the
    means of the two sets of independent chains must agree within 5
    standard errors."""
    from mcmc_jl_tpu_torch.ops.glm_hmc import run_glm_hmc, run_glm_hmc_multistep

    X, Y = bench_data()
    chains = final.shape[0]
    inits = np.zeros_like(final)
    drivers = {
        "glm_step": ("run_glm_hmc(fused_step=True)", steps, lambda: run_glm_hmc(
            X, Y, chains, steps, n_leaps=10, eps=0.05, seed=2, inits=inits,
            device="cuda", fused_step=True)),
        "glm_multistep": (f"run_glm_hmc_multistep(thin={thin})", steps // thin,
                          lambda: run_glm_hmc_multistep(
                              X, Y, chains, steps, thin=thin, n_leaps=10,
                              eps=0.05, seed=3, inits=inits, device="cuda")),
    }
    counts = {}
    for name, (origin, want, fn) in drivers.items():
        (theta, infos), launches = _counted(fn)
        assert launches == {**{k: 0 for k in launches}, name: want}, launches
        th = theta.double().cpu().numpy()
        assert th.shape == final.shape and np.all(np.isfinite(th))
        z = _z_means(th, final)
        acc = infos["accept" if name == "glm_step" else "accept_rate"]
        ok = z < Z_MAX
        emit({"phase": "driver", "kernel": name, "from": origin,
              "chains": chains, "transitions": steps,
              "launches": launches[name],
              "accept_rate": float(acc.float().mean()),
              "z_max_vs_main_path": z, "ok": ok})
        assert ok, f"{origin} disagrees with the main path"
        counts[name] = (launches[name], origin)
    return counts


def _time(fn, reps=3):
    """Median host seconds of ``fn`` after one warm-up; each run ends on
    torch.cuda.synchronize()."""
    import torch

    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def _event_ms(fn, reps=3):
    """Median device milliseconds of one call of ``fn`` (CUDA events)."""
    import torch

    fn()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return float(np.median(ts))


def phase_timing(C=65536, steps=2000, n_leaps=10, eps=0.05, k_trans=200,
                 reps=3):
    """Leapfrog/s of the drivers at bench.py's shape (bench.py phases 1-2
    plus the step kernel's driver; the median of ``reps`` runs after one
    warm-up), beside the plain version's."""
    import torch

    from mcmc_jl_tpu_torch.ops import glm_kernels as gk
    from mcmc_jl_tpu_torch.ops.glm_hmc import run_glm_hmc, run_glm_hmc_multistep

    X, Y = bench_data()
    lf = C * steps * n_leaps
    rates = {}
    runs = {
        "multistep": lambda: run_glm_hmc_multistep(
            X, Y, C, steps, thin=k_trans, n_leaps=n_leaps, eps=eps, seed=1,
            device="cuda"),
        "composed": lambda: run_glm_hmc(X, Y, C, steps, n_leaps=n_leaps,
                                        eps=eps, seed=1, device="cuda"),
        "fused_step": lambda: run_glm_hmc(X, Y, C, steps, n_leaps=n_leaps,
                                          eps=eps, seed=1, device="cuda",
                                          fused_step=True),
    }
    for name, fn in runs.items():
        sec = _time(fn, reps=reps)
        rates[name] = lf / sec
        emit({"phase": "timing", "driver": name, "C": C, "transitions": steps,
              "n_leaps": n_leaps, "seconds": sec,
              "leapfrog_per_s": rates[name], **CARD})

    XT, Yc, theta, m0, logu, lp, g = _inputs(C, seed=4)
    gen = torch.Generator(device="cuda").manual_seed(5)
    plain_k = 100
    sec = _time(lambda: gk.glm_multistep_ref(
        XT, Yc, theta, eps, k_trans=plain_k, n_leaps=n_leaps, generator=gen),
        reps=2)
    emit({"phase": "timing", "driver": "plain glm_multistep_ref", "C": C,
          "transitions": plain_k, "n_leaps": n_leaps, "seconds": sec,
          "leapfrog_per_s": C * plain_k * n_leaps / sec, **CARD})
    return rates


def _logistic_mode(X, Y, W=None, O=None, lam=1.0, iters=30):
    """Posterior mode of a weighted, offset logistic GLM by Newton steps, so
    that the kernel checks start where the chains sample; ``lam`` a scalar,
    a (d,) row or a (d, d) prior precision matrix."""
    W = np.ones(len(Y)) if W is None else W
    O = np.zeros(len(Y)) if O is None else O
    b = np.zeros(X.shape[1])
    P = np.asarray(lam) if np.ndim(lam) == 2 else lam * np.eye(len(b))
    for _ in range(iters):
        p = 1.0 / (1.0 + np.exp(-(X @ b + O)))
        g = X.T @ (W * (Y - p)) - P @ b
        H = X.T @ (X * (W * p * (1 - p))[:, None]) + P
        b = b + np.linalg.solve(H, g)
    return b


def _laplace_scale(X, Y, lam=1.0):
    """Posterior standard deviations of a logistic GLM from the Laplace
    approximation at the mode: the scales ``s`` that the diagonal-metric
    route folds into the design (``X s``, prior row ``lam s^2``)."""
    b = _logistic_mode(X, Y, lam=lam)
    p = 1.0 / (1.0 + np.exp(-X @ b))
    H = X.T @ (X * (p * (1 - p))[:, None]) + lam * np.eye(len(b))
    return np.sqrt(np.diag(np.linalg.inv(H)))


def _nuts_inputs(C, md, seed, X, Y, W=None, O=None, lam=1.0, spread=0.05):
    """A NUTS transition's inputs on the card: chains near the posterior
    mode and one transition's pre-drawn noise, from numpy seed ``seed``."""
    from mcmc_jl_tpu_torch.ops.glm_kernels import glm_funcs

    rng = np.random.default_rng(seed)
    d = X.shape[1]
    lam_t = _cuda(lam) if np.ndim(lam) else float(lam)
    theta = _logistic_mode(X, Y, W, O, lam) + spread * rng.standard_normal((C, d))
    XT, Yc, Wc, Oc, th = _cuda(X.T), _cuda(Y), _cuda(W), _cuda(O), _cuda(theta)
    lp, g = glm_funcs(XT, Yc, Wc, Oc, lam_t, "logistic")[1](th)
    noise = (rng.standard_normal((C, d)), np.log(rng.random(C)),
             np.where(rng.random((C, md)) < 0.5, 1.0, -1.0),
             rng.random((C, md)), rng.random((C, 1 << md)))
    args = (XT, Yc, th, lp.contiguous(), g.contiguous())
    kw = dict(maxdoublings=md, weights=Wc, offsets=Oc, prior_prec=lam_t)
    return args, tuple(_cuda(a) for a in noise), kw


def _nuts_check(label, args, noise, eps, kw, scale=1.0, full_depth=False):
    """The transition kernel against its plain version on the same inputs;
    ``full_depth``: some chain must build a tree of all maxdoublings
    doublings (the deepest checkpoint slots and span checks).  The kernel
    also repeats bitwise.  Returns the max abs error of theta on the
    chains on the same path."""
    import torch

    from mcmc_jl_tpu_torch.ops import nuts_kernels as nk

    out_k, again = (nk.glm_nuts_transition(*args, eps, *noise, **kw)
                    for _ in range(2))
    out_r = nk.glm_nuts_transition_ref(*args, eps, *noise, **kw)
    torch.cuda.synchronize()
    bitwise = all(torch.equal(a, b) for a, b in zip(out_k, again))
    (thk, gk_, lpk, ndk, dvk), (thr, gr, lpr, ndr, dvr) = out_k, out_r
    same = ((ndk == ndr) & (dvk == dvr)
            & ((thk - thr).abs().amax(-1) <= LEAF_ATOL))
    C = thk.shape[0]
    rep = {n: _err(a[same], b[same]) for n, a, b in
           zip(("theta", "g", "lp"), (thk, gk_, lpk), (thr, gr, lpr))}
    md = kw["maxdoublings"]
    ok = (bitwise and float(same.float().mean()) >= PATH_AGREE
          and (not full_depth or int(ndr.max()) == md)
          and _close(thk[same], thr[same], RTOL, ATOL)
          and _close(gk_[same], gr[same], RTOL, G_ATOL * scale)
          and _close(lpk[same], lpr[same], LP_RTOL, LP_ATOL * scale))
    emit({"phase": "kernel", "name": nk._counted(
        "glm_nuts_transition", _mat_or_none(kw.get("prior_prec")),
        thk.shape[1]),
          "case": label, "C": C, "eps": eps, "ok": ok,
          "bitwise_repeat": bitwise,
          "path_differ": int(C - same.sum()),
          "mean_ndoublings": float(ndr.float().mean()),
          "chains_at_maxdoublings": int((ndr == md).sum()),
          "diverging": int(dvr.sum()), **rep})
    assert ok, f"glm_nuts_transition ({label}) disagrees with its plain version"
    return rep["theta"]["max_abs"]


def _nuts_ms_check(label, args, eps, kw, seed, k=5, scale=1.0,
                   full_depth=False):
    """The multistep kernel against its plain version chain by chain, on
    the kernel's own Philox draws (the launch seed a generator seeded
    ``seed`` gives, replayed by ``glm_nuts_multistep_draws``) over ``k``
    transitions: a chain is on the same path when every transition has
    the same ndoublings and diverging and theta within LEAF_ATOL; on those
    chains the final theta, gradient and lp are held to the transition
    kernel's tolerances.  The kernel also repeats bitwise.  Returns the
    max abs error of theta on the chains on the same path."""
    import torch

    from mcmc_jl_tpu_torch.ops import nuts_kernels as nk
    from mcmc_jl_tpu_torch.ops import target_kernels as tk

    def gen():
        return torch.Generator(device="cuda").manual_seed(seed)

    C, d = args[2].shape
    md = kw["maxdoublings"]
    out_k, out_k2 = (nk.glm_nuts_multistep(*args, eps, gen(), k_trans=k,
                                           **kw) for _ in range(2))
    draws = nk.glm_nuts_multistep_draws(tk._seed(gen()), C, d, k, md,
                                        device="cuda")
    out_r = nk.glm_nuts_multistep_ref(*args, eps, None, k_trans=k,
                                      draws=draws, **kw)
    torch.cuda.synchronize()
    bitwise = (all(torch.equal(a, b) for a, b in zip(out_k[:3], out_k2[:3]))
               and all(torch.equal(out_k[3][n], out_k2[3][n])
                       for n in out_k[3]))
    rk, rr = out_k[3], out_r[3]
    same = ((rk["ndoublings"] == rr["ndoublings"]).all(0)
            & (rk["diverging"] == rr["diverging"]).all(0)
            & ((rk["ppars"] - rr["ppars"]).abs().amax((0, 2)) <= LEAF_ATOL))
    rep = {n: _err(a[same], b[same]) for n, a, b in
           zip(("theta", "g", "lp"), out_k[:3], out_r[:3])}
    nd = rr["ndoublings"]
    ok = (bitwise and float(same.float().mean()) >= PATH_AGREE
          and (not full_depth or int(nd.max()) == md)
          and _close(out_k[0][same], out_r[0][same], RTOL, ATOL)
          and _close(out_k[1][same], out_r[1][same], RTOL, G_ATOL * scale)
          and _close(out_k[2][same], out_r[2][same], LP_RTOL,
                     LP_ATOL * scale)
          and bool((rk["accept"][:, same] == rr["accept"][:, same]).all()))
    emit({"phase": "kernel", "name": nk._counted(
        "glm_nuts_multistep", _mat_or_none(kw.get("prior_prec")), d),
          "case": label, "draws": "the kernel's, replayed", "C": C,
          "k_trans": k, "eps": eps,
          "ok": ok, "bitwise_repeat": bitwise,
          "path_differ": int(C - same.sum()),
          "mean_ndoublings": float(nd.float().mean()),
          "chains_at_maxdoublings": int((nd == md).any(0).sum()),
          "diverging": int(rr["diverging"].sum()), **rep})
    assert ok, (f"glm_nuts_multistep ({label}) disagrees with its plain "
                f"version on its own draws")
    return rep["theta"]["max_abs"]


def _nuts_checks(err, tier, label, args, noise, eps, kw, seed, k,
                 full_depth=False, multistep=True):
    """Kernel 8 (_nuts_check) and, with ``multistep``, kernel 9
    (_nuts_ms_check over k transitions) on one case of a tile above the
    narrow one; each largest theta error into ``err`` under its counter on
    ``tier`` ("_wide", "_xwide" or "_chunked", after "_mat" with a matrix
    prior)."""
    e = {"glm_nuts_transition": _nuts_check(label, args, noise, eps, kw,
                                            full_depth=full_depth)}
    if multistep:
        e["glm_nuts_multistep"] = _nuts_ms_check(
            label, args, eps, kw, seed=seed, k=k, full_depth=full_depth)
    mat = "_mat" if _mat_or_none(kw.get("prior_prec")) is not None else ""
    for name, v in e.items():
        err[name + mat + tier] = max(err[name + mat + tier], v)


def _f64_witness(label, args, eps, kw, seed, k=3):
    """Kernel 9's drift from float64 beside its plain version's: k
    transitions of the kernel on its own Philox draws (a generator seeded
    ``seed``) and of its plain version on those draws replayed, in float32
    and in float64 (inputs, prior and draws widened).  On the chains whose
    discrete path (ndoublings, diverging, theta within LEAF_ATOL at every
    transition) is float64's, the largest theta error of each against
    float64 at each transition and of the final gradient.  Emitted, not
    gated (_nuts_ms_check holds the kernel to the float32 plain version);
    returns the line."""
    import torch

    from mcmc_jl_tpu_torch.ops import nuts_kernels as nk
    from mcmc_jl_tpu_torch.ops import target_kernels as tk

    def gen():
        return torch.Generator(device="cuda").manual_seed(seed)

    XT, Y, th = args[:3]
    C, d = th.shape
    md = kw["maxdoublings"]
    out_k = nk.glm_nuts_multistep(*args, eps, gen(), k_trans=k, **kw)
    draws = nk.glm_nuts_multistep_draws(tk._seed(gen()), C, d, k, md,
                                        device="cuda")
    out_32 = nk.glm_nuts_multistep_ref(*args, eps, None, k_trans=k,
                                       draws=draws, **kw)
    kw64 = {n: v.double() if torch.is_tensor(v) else v for n, v in kw.items()}
    XT64, Y64, th64 = (a.double() for a in (XT, Y, th))
    out_64 = nk.glm_nuts_multistep_ref(
        XT64, Y64, th64, *_lp_grad(XT64, Y64, th64, **kw64), eps, None,
        k_trans=k, draws=[a.double() for a in draws], **kw64)
    r64 = out_64[3]
    line = {"phase": "f64_witness", "name": nk._counted(
        "glm_nuts_multistep", _mat_or_none(kw.get("prior_prec")), d),
        "case": label, "C": C, "k_trans": k, "eps": eps}
    for who, out in (("kernel", out_k), ("plain_float32", out_32)):
        r = out[3]
        same = ((r["ndoublings"] == r64["ndoublings"]).all(0)
                & (r["diverging"] == r64["diverging"]).all(0)
                & ((r["ppars"].double() - r64["ppars"]).abs().amax((0, 2))
                   <= LEAF_ATOL))
        ok = bool(same.any())
        line[who] = {
            "path_differ": int(C - same.sum()),
            "theta_by_transition": [
                float((r["ppars"][t].double() - r64["ppars"][t])[same]
                      .abs().max()) if ok else None for t in range(k)],
            "g_final": float((out[1].double() - out_64[1])[same].abs().max())
            if ok else None,
            "max_abs_g": float(out_64[1].abs().max())}
    emit(line)
    return line


def phase_nuts_kernels(C=4096, md=6):
    """Both NUTS kernels against their plain versions on the card: kernel
    8 on the same pre-drawn noise, kernel 9 on its own draws replayed
    (chain by chain) and statistically against the plain version and the
    per-transition driver on other streams; kernel 9's float64 witness
    (_f64_witness) on a Poisson GLM started at 0."""
    import torch

    from mcmc_jl_tpu_torch.ops import nuts_kernels as nk

    X, Y = bench_data()
    err, ms_err = 0.0, 0.0
    for label, multinomial, eps in (
            ("slice", False, 0.05), ("slice", False, 0.2),
            ("multinomial", True, 0.05), ("multinomial", True, 0.2)):
        args, noise, kw = _nuts_inputs(C, md, 21, X, Y)
        kw = dict(kw, multinomial=multinomial)
        err = max(err, _nuts_check(f"{label}, eps {eps}", args, noise, eps,
                                   kw))
        ms_err = max(ms_err, _nuts_ms_check(f"{label}, eps {eps}", args, eps,
                                            kw, seed=31))
    # deep trees, up to maxdoublings: at eps 0.01 (the posterior sds are
    # about 0.09), and on the diagonal-metric route's folded inputs (design
    # X s, (d,) prior row lam s^2, chains in z = theta / s) at eps 0.1
    args, noise, kw = _nuts_inputs(C, md, 24, X, Y)
    err = max(err, _nuts_check("slice, eps 0.01", args, noise, 0.01,
                               dict(kw, multinomial=False), full_depth=True))
    s = _laplace_scale(X, Y)
    for multinomial in (False, True):
        args, noise, kw = _nuts_inputs(C, md, 25, X * s, Y, lam=s * s,
                                       spread=0.5)
        label = (f"{'multinomial' if multinomial else 'slice'}, folded "
                 f"diagonal metric (X s, (d,) prior row), eps 0.1")
        kw = dict(kw, multinomial=multinomial)
        err = max(err, _nuts_check(label, args, noise, 0.1, kw,
                                   full_depth=True))
        ms_err = max(ms_err, _nuts_ms_check(label, args, 0.1, kw, seed=32,
                                            full_depth=True))

    # rows streamed through shared memory (N = 5000 past the budget), a
    # ragged last tile (C = 300), weights and offsets
    rng = np.random.default_rng(6)
    N, d7 = 5000, 7
    X7 = np.column_stack([np.ones(N), rng.standard_normal((N, d7 - 1))]) * 0.3
    Y7 = (rng.random(N) < 1 / (1 + np.exp(-X7 @ rng.standard_normal(d7)))
          ).astype(float)
    W7, O7 = rng.uniform(0.5, 2.0, N), 0.1 * rng.standard_normal(N)
    for multinomial in (False, True):
        args, noise, kw = _nuts_inputs(300, md, 22, X7, Y7, W7, O7, lam=1.5)
        label = (f"N 5000 streamed, C 300, d 7, weights+offsets, "
                 f"{'multinomial' if multinomial else 'slice'}")
        kw = dict(kw, multinomial=multinomial)
        err = max(err, _nuts_check(label, args, noise, 0.03, kw,
                                   scale=N / 1000))
        ms_err = max(ms_err, _nuts_ms_check(label, args, 0.03, kw, seed=33,
                                            scale=N / 1000))
    # kernel 9 against float64 where its sums are largest: a Poisson GLM
    # (weights, offsets, d 32) started at 0, gradients to about 1e4
    XT, Yc, W, O, th, _ = _glm_case("poisson", 1000, 32, 17, seed=62)
    kwp = dict(kind="poisson", weights=W, offsets=O, prior_prec=1.5,
               maxdoublings=10, multinomial=False)
    _f64_witness("narrow tile, poisson from 0, d 32, C 17, md 10",
                 (XT, Yc, th, *_lp_grad(XT, Yc, th, **kwp)), 0.005, kwp,
                 seed=82)

    # multistep: bitwise repeat from one generator state; then held against
    # its plain version from the same start, K transitions each (Philox
    # streams in the kernel, torch.Generator streams in the plain version):
    # final states of independent chains, per-chain accept rates and the
    # mean tree depth; and, as an extra check, against the per-transition
    # driver the same way
    args, _, kw = _nuts_inputs(C, md, 23, X, Y)
    XT, Yc, th, lp, g = args
    eps, K, kt = 0.05, 64, 8
    r1, r2 = (nk.glm_nuts_multistep(
        *args, eps, torch.Generator(device="cuda").manual_seed(12345),
        k_trans=kt, **kw) for _ in range(2))
    torch.cuda.synchronize()
    bitwise = (all(torch.equal(a, b) for a, b in zip(r1[:3], r2[:3]))
               and all(torch.equal(r1[3][k], r2[3][k]) for k in r1[3]))
    gen = torch.Generator(device="cuda").manual_seed(3)
    drv = dict(steps=K, maxdoublings=md)
    (th_ms, _, _), inf_ms = nk._nuts_run_hw(XT, Yc, th, eps, gen, k_trans=kt,
                                            **drv)
    th_pl, _, _, inf_pl = nk.glm_nuts_multistep_ref(*args, eps, gen,
                                                    k_trans=K, **kw)
    (th_pt, _, _), inf_pt = nk._nuts_run(XT, Yc, th, eps, gen, **drv)
    torch.cuda.synchronize()

    def depth(inf):
        return float(inf["ndoublings"].float().mean())

    acc = {n: inf["accept"].float().mean(0)
           for n, inf in (("kernel", inf_ms), ("plain", inf_pl))}
    rep = {"z_theta_max": _z_t(th_ms, th_pl),
           "z_accept": _z_t(acc["kernel"], acc["plain"]),
           "accept_rate": float(acc["kernel"].mean()),
           "accept_rate_plain": float(acc["plain"].mean()),
           "mean_ndoublings": depth(inf_ms),
           "mean_ndoublings_plain": depth(inf_pl),
           "diverging": int(inf_ms["diverging"].sum()),
           "diverging_plain": int(inf_pl["diverging"].sum()),
           "z_theta_max_vs_per_transition": _z_t(th_ms, th_pt),
           "mean_ndoublings_per_transition": depth(inf_pt)}
    pooled = float((th_ms.mean(0) - th_pl.mean(0)).abs().max())
    ok = (bitwise and rep["z_theta_max"] < Z_MAX and rep["z_accept"] < Z_MAX
          and abs(depth(inf_ms) / depth(inf_pl) - 1) < DEPTH_RTOL
          and rep["z_theta_max_vs_per_transition"] < Z_MAX
          and abs(depth(inf_ms) / depth(inf_pt) - 1) < DEPTH_RTOL
          and bool(torch.isfinite(inf_ms["plogtarget"]).all()))
    emit({"phase": "kernel", "name": "glm_nuts_multistep", "C": C,
          "k_trans": kt, "transitions": K, "ok": ok, "bitwise_repeat": bitwise,
          **rep, "pooled_theta_max_abs_diff": pooled})
    assert ok, "glm_nuts_multistep disagrees with glm_nuts_multistep_ref"
    return {"glm_nuts_transition": err, "glm_nuts_multistep": ms_err}


@contextlib.contextmanager
def _spans():
    """Host seconds (to a synchronize) of a route's phases inside a
    ``run``: warmup on the generic engine, the kernels' sampling phase, and
    packaging into chains.  Wraps the module functions for the duration."""
    import torch

    from mcmc_jl_tpu_torch.ops import (glm_bign, glm_hmc, nuts_kernels,
                                      target_kernels, warmstart)
    from mcmc_jl_tpu_torch.parallel import pchains

    spans, saved = {}, []
    for mod, fn, label in ((warmstart, "_warmup", "warmup"),
                           (glm_hmc, "_run", "sampling"),
                           (nuts_kernels, "_nuts_run_hw", "sampling"),
                           (nuts_kernels, "_nuts_run", "sampling"),
                           (nuts_kernels, "_nuts_target_run", "sampling"),
                           (warmstart, "_chees_run_ms", "sampling"),
                           (warmstart, "_chees_run_bign", "sampling"),
                           (warmstart, "_chees_target_run", "sampling"),
                           (glm_bign, "_run_bign", "sampling"),
                           (target_kernels, "_run", "sampling"),
                           (pchains, "_package_group", "packaging")):
        orig = getattr(mod, fn)

        def timed(*a, _orig=orig, _label=label, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = _orig(*a, **k)
            torch.cuda.synchronize()
            spans[_label] = spans.get(_label, 0.0) + time.perf_counter() - t0
            return out

        saved.append((mod, fn, orig))
        setattr(mod, fn, timed)
    try:
        yield spans
    finally:
        for mod, fn, orig in saved:
            setattr(mod, fn, orig)


def _hmc_reference(hmc_final, hmc_steps=2000, data=None, eps=0.05, seed=4):
    """Per-chain means (chains, d) of the HMC main path continued from its
    final states ``hmc_final`` for ``hmc_steps`` more transitions: the
    reference the NUTS and warm-start runs at N = 1000 are held against.
    The main path's own kept draws still carry the transient of its start
    at 0 (chain 0's autocorrelation times reach 190 of 1000 transitions).
    ``data`` (X, Y) and ``eps`` give kernel 1's HMC(10, eps) on other data
    (default: bench_data())."""
    import torch

    from mcmc_jl_tpu_torch.ops.glm_hmc import _run

    X, Y = bench_data() if data is None else data
    gen = torch.Generator(device="cuda").manual_seed(seed)
    _, hmc = _run(_cuda(X.T), _cuda(Y), _cuda(hmc_final), eps, gen,
                  steps=hmc_steps, n_leaps=10, collect=True)
    return hmc["ppars"].mean(0).double().cpu().numpy()


def phase_nuts_main_path(hmc_means, burnin=60):
    """Exact NUTS through ``run``: the multistep kernel serves
    SerialMC(560, 60) (500 = 100 launches of 5), the per-transition
    kernel the diagonal-metric run with SerialMC(559, 60) (499 is prime);
    the burn-in is cut from the benchmark's 500 to 60 for the script's
    time.

    Each run's per-chain means must agree with ``hmc_means``, the per-chain
    means of the HMC main path's continuation (:func:`_hmc_reference`).
    Returns the kernels' launches, what the timing phase starts from and the
    unit-metric run's tasks (for phase_resume_paths)."""
    import torch

    import mcmc_jl_tpu_torch as mt
    from mcmc_jl_tpu_torch.samplers.base import tree_map

    chains = len(hmc_means)
    X, Y = bench_data()
    m = mt.model(glm=("logistic", X, Y), device="cuda")
    runs = {
        "glm_nuts_multistep": (mt.NUTS(maxdoublings=6), burnin + 500, 100),
        "glm_nuts_transition": (mt.NUTS(maxdoublings=6, mass_adapt="diag"),
                                burnin + 499, 499),
    }
    counts, start = {}, None
    for name, (sampler, steps, want) in runs.items():
        origin = (f"run(model(glm=...) * {sampler!r} * SerialMC(steps={steps},"
                  f" burnin={burnin}), chains={chains})")
        task = m * sampler * mt.SerialMC(steps=steps, burnin=burnin)
        t0 = time.perf_counter()
        with _spans() as spans:
            cs, launches = _counted(lambda: mt.run(task, chains=chains,
                                                   seed=0))
        dt = time.perf_counter() - t0
        assert launches == {**{k: 0 for k in launches}, name: want}, launches
        samples = np.stack([c.samples.values for c in cs])
        assert samples.shape == (chains, steps - burnin, m.size)
        assert np.all(np.isfinite(samples))
        dg = {k: np.stack([c.diagnostics[k] for c in cs])
              for k in ("accept", "ndoublings", "diverging", "epsilon")}
        eps = float(dg["epsilon"][0, 0])
        assert np.all(dg["epsilon"] == eps), "eps not frozen after burn-in"
        nm = samples.mean(axis=1)
        z = _z_means(nm, hmc_means)
        ok = z < Z_MAX
        emit({"phase": "nuts_main_path", "kernel": name, "from": origin,
              "chains": chains, "seconds": dt, "spans_s": spans,
              "launches": launches[name],
              "frozen_eps": eps, "accept_rate": float(dg["accept"].mean()),
              "mean_ndoublings": float(dg["ndoublings"].mean()),
              "diverging_share": float(dg["diverging"].mean()),
              "pooled_mean": nm.mean(0).tolist(),
              "hmc_pooled_mean": hmc_means.mean(0).tolist(),
              "z_max_vs_hmc_main_path": z, "ok": ok, **CARD})
        assert ok, f"{origin} disagrees with the HMC main path"
        counts[name] = (launches[name], origin)
        if start is None:  # the unit-metric run's end: timing starts there
            c1 = mt.resume(cs[0], steps=50)  # one chain, generic engine
            assert c1.samples.values.shape == (50, m.size)
            assert np.all(np.isfinite(c1.samples.values))
            states = tree_map(lambda *xs: torch.stack(xs),
                              *[c.task.state for c in cs])
            start = {"model": m, "sampler": sampler, "eps": eps,
                     "states": states}
            tasks = [c.task for c in cs]
    return counts, start, tasks


def phase_nuts_timing(start, md=6, k_trans=5,
                      sizes=((4096, 200), (65536, 40))):
    """Sampling-phase rates of the NUTS drivers at the frozen step, from the
    main path's final states (tiled to each (chains, transitions) of
    ``sizes``): transitions/s, and gradient evaluations/s
    bounded by the tree depths (a transition of depth n evaluates between
    2^(n-1) and 2^n - 1 leaves).  Then each kernel's per-launch time beside
    its plain version's, with the bound of each launch's work.
    Returns ({kernel: (ms, plain ms)}, {kernel: bound})."""
    import torch

    from mcmc_jl_tpu_torch.ops import nuts_kernels as nk
    from mcmc_jl_tpu_torch.parallel.pchains import _scan_chains
    from mcmc_jl_tpu_torch.samplers.base import RunCtx

    m, sampler, eps = start["model"], start["sampler"], start["eps"]
    states = start["states"]
    XT = m.glm_spec.X.T.contiguous()
    Y = m.glm_spec.Y
    th4 = states.pars.contiguous()
    gen = torch.Generator(device="cuda").manual_seed(9)

    def rate(driver, C, steps, fn):
        last = {}
        ms = _event_ms(lambda: last.update(out=fn()))
        nd = last["out"][1]["ndoublings"].double()
        sec = ms / 1e3
        emit({"phase": "nuts_timing", "driver": driver, "C": C,
              "transitions": steps, "seconds": sec,
              "transitions_per_s": C * steps / sec,
              "mean_ndoublings": float(nd.mean()),
              "grad_evals_per_s_min": float((2.0 ** (nd - 1)).sum()) / sec,
              "grad_evals_per_s_max": float((2.0 ** nd - 1).sum()) / sec,
              **CARD})

    for C, steps in sizes:
        th = th4.repeat(C // th4.shape[0], 1)
        kw = dict(steps=steps, maxdoublings=md)
        rate("multistep", C, steps, lambda: nk._nuts_run_hw(
            XT, Y, th, eps, gen, k_trans=k_trans, **kw))
        rate("per-transition", C, steps, lambda: nk._nuts_run(
            XT, Y, th, eps, gen, **kw))
    lp, g = states.logtarget.contiguous(), states.grad.contiguous()
    rate("plain glm_nuts_multistep_ref", th4.shape[0], k_trans, lambda: (
        None, nk.glm_nuts_multistep_ref(XT, Y, th4, lp, g, eps, gen,
                                        k_trans=k_trans, maxdoublings=md)[3]))
    rate("generic engine", th4.shape[0], k_trans, lambda: _scan_chains(
        m, sampler, RunCtx(burnin=0), states, gen, k_trans))

    ms, work = {}, {}
    for name, t in _nuts_kernel_times(XT, Y, th4, lp, g, eps, md, k_trans,
                                      seed=10).items():
        ms[name] = (t["ms"], t["plain_ms"])
        work[name] = {k: t[k] for k in ("bound_ms", "bound_by")}
    return ms, work


def _nuts_leaves(XT, Y, th, lp, g, eps, md, noise_sets, prior=1.0):
    """Each chain's leaf count (int64, (C,)) over the transitions whose
    noise ``noise_sets`` holds (one draw_noise tuple each), chained from
    (th, lp, g), from the plain version's tree build: the work the NUTS
    kernels' trees need (they build the same trees)."""
    import torch

    from mcmc_jl_tpu_torch.ops import nuts_kernels as nk
    from mcmc_jl_tpu_torch.ops.glm_kernels import glm_funcs

    logp_grad = glm_funcs(XT, Y, None, None, prior, "logistic")[1]
    leaves = torch.zeros(th.shape[0], dtype=torch.int64, device=th.device)
    lp = lp.reshape(-1)
    for noise in noise_sets:
        th, g, lp, _, _ = nk._transition(logp_grad, th, lp, g, eps, *noise,
                                         md, False, leaves=leaves)
    return leaves


def _nuts_kernel_times(XT, Y, th, lp, g, eps, md, k_trans, seed,
                       plain=True, prior=1.0, multistep=True, device_reps=10,
                       event_reps=3):
    """Per-launch time of kernels 8 (one transition on draw_noise from a
    generator seeded ``seed``) and 9 (``k_trans`` transitions, its launch
    seed from a generator seeded ``seed + 1``) on the logistic GLM with
    prior ``prior`` (a matrix runs the _mat variants) from (th, lp, g) at
    step ``eps``: CUDA events (the wrapper's host work included) and
    torch.profiler's device time (the narrow tile's kernel, the wide one's
    above d 32 or the very-wide one's above d 256: the line's phase says
    which), beside the plain
    version's (with ``plain``), the mean depth, the leaves the trees
    need (from the plain version's tree build on the same draws) and the
    tile passes (per tile of 16 chains the most leaves of one chain), the
    bound and the special-function floor of those leaves, and the occupancy
    plan; kernel 9 only with ``multistep``; no device time with
    ``device_reps`` 0.  Emits one line per kernel;
    returns {counted name: that line}."""
    import torch

    from mcmc_jl_tpu_torch.ops import nuts_kernels as nk
    from mcmc_jl_tpu_torch.ops import target_kernels as tk
    from mcmc_jl_tpu_torch.ops.glm_kernels import (NARROW_D_MAX, WIDE_D_MAX,
                                                   XWIDE_D_MAX)

    C, d = th.shape
    N = XT.shape[1]
    lp = lp.reshape(-1)
    tier = ("chunked_" if d > XWIDE_D_MAX else "xwide_" if d > WIDE_D_MAX
            else "wide_" if d > NARROW_D_MAX else "")
    # the chunked tier runs the very-wide kernel's CH instantiation
    symbol = f"nuts_{(tier or 'tile_').replace('chunked_', 'xwide_')}kernel"

    def gen(k):
        return torch.Generator(device="cuda").manual_seed(seed + k)

    noise = nk.draw_noise(C, d, md, gen(0))
    replay = {"glm_nuts_transition": [noise]}
    if multistep:
        draws = nk.glm_nuts_multistep_draws(tk._seed(gen(1)), C, d, k_trans,
                                            md, device="cuda")
        replay["glm_nuts_multistep"] = [tuple(a[t] for a in draws)
                                        for t in range(k_trans)]
    plan = nk.nuts_plan(d, N, md)
    out_lines = {}
    for name in replay:
        leaves = _nuts_leaves(XT, Y, th, lp, g, eps, md, replay[name],
                              prior=prior)
        kw = dict(maxdoublings=md, prior_prec=prior)
        if name == "glm_nuts_transition":
            kern = lambda: nk.glm_nuts_transition(  # noqa: E731
                XT, Y, th, lp, g, eps, *noise, **kw)
            ref = lambda: nk.glm_nuts_transition_ref(  # noqa: E731
                XT, Y, th, lp, g, eps, *noise, **kw)
            inputs = (XT, Y, th, lp, g, noise, prior)
        else:
            kern = lambda: nk.glm_nuts_multistep(  # noqa: E731
                XT, Y, th, lp, g, eps, gen(1), k_trans=k_trans, **kw)
            ref = lambda: nk.glm_nuts_multistep_ref(  # noqa: E731
                XT, Y, th, lp, g, eps, gen(2), k_trans=k_trans, **kw)
            inputs = (XT, Y, th, lp, g, prior)
        out = kern()
        nd = (out[3] if name == "glm_nuts_transition"
              else out[3]["ndoublings"]).double()
        n_leaves = int(leaves.sum())
        per_tile = leaves.new_zeros(-(-C // 16) * 16)
        per_tile[:C] = leaves
        per_tile = per_tile.reshape(-1, 16).amax(1)
        counted = nk._counted(name, _mat_or_none(prior), d)
        line = {"phase": f"{tier}nuts_time",
                "name": counted, "C": C, "N": N, "d": d,
                "k_trans": k_trans if name == "glm_nuts_multistep" else 1,
                "eps": eps, "maxdoublings": md,
                "ms": _event_ms(kern, reps=event_reps),
                "device_ms": _device_ms(kern, symbol, reps=device_reps)
                if device_reps else None,
                "plain_ms": _event_ms(ref, reps=2) if plain else None,
                "mean_ndoublings": float(nd.mean()), "leaves": n_leaves,
                "leaves_per_chain": n_leaves / C,
                "tile_passes": int(per_tile.sum()),
                **_bound(n_leaves, d, N, _nbytes(inputs, out)),
                "sfu_floor_ms": _sfu_floor_ms(n_leaves * N, SFU_PER_LINK)}
        emit({**line, "plan": plan, **CARD})
        out_lines[counted] = line
    return out_lines


def phase_nuts_times(Cs=(4096, 65536), md=6, k_trans=5):
    """Kernels 8 and 9 at pinned shapes, so that two trees time the same
    work (``--times``): bench.py's data, the unit metric, the step
    NUTS_TIME_EPS, chains drawn from the Laplace approximation at the mode
    (numpy seed NUTS_TIME_SEED; the first 4096 of the 65536 are the 4096),
    maxdoublings 6, kernel 9 at 5 transitions a launch (the NUTS main
    path's); at 4096 and 65536 chains, the plain version at 4096 only."""
    from mcmc_jl_tpu_torch.ops.glm_kernels import glm_funcs

    X, Y = bench_data()
    mode, sc = _logistic_mode(X, Y), _laplace_scale(X, Y)
    rng = np.random.default_rng(NUTS_TIME_SEED)
    start = mode + sc * rng.standard_normal((max(Cs), X.shape[1]))
    XT, Yc = _cuda(X.T), _cuda(Y)
    for C in Cs:
        th = _cuda(start[:C])
        lp, g = glm_funcs(XT, Yc, None, None, 1.0, "logistic")[1](th)
        _nuts_kernel_times(XT, Yc, th, lp.contiguous(), g.contiguous(),
                           NUTS_TIME_EPS, md, k_trans, seed=74,
                           plain=C == Cs[0])


def _nbytes(*objs):
    """Bytes of every tensor in ``objs`` (tensors, or tuples and dicts of
    them): each input read once, each output written once."""
    import torch

    n = 0
    for o in objs:
        if isinstance(o, dict):
            n += _nbytes(*o.values())
        elif isinstance(o, (tuple, list)):
            n += _nbytes(*o)
        elif isinstance(o, torch.Tensor):
            n += o.numel() * o.element_size()
    return n


def _bound(evals, d, N, nbytes):
    """The least time (ms) the card could take for ``evals`` GLM gradient
    evaluations (summed over chains) at (d, N) that move ``nbytes``: the
    4 d N float32 operations of each evaluation's two products (theta . x_n
    and r_n x_n; the link's special functions are not counted) at the
    tensor cores' 3xTF32 rate, where the tile kernels compute them, or the
    bytes over the HBM bandwidth, whichever is larger."""
    return _bound_ops(4.0 * d * N * float(evals), nbytes, TF32X3_FLOPS)


def _bound_ops(ops, nbytes, rate=FP32_FLOPS):
    """The least time (ms) for ``ops`` operations that move ``nbytes``:
    the larger of the operations over ``rate`` (FP32 outside the tensor
    cores unless given) and the bytes over the HBM bandwidth."""
    t_ops = float(ops) / rate
    t_bytes = nbytes / HBM_BYTES_S
    return {"bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


_MODES = {}


def _bench_mode(n):
    """bench.py's data at N = n and its posterior mode (cached)."""
    if n not in _MODES:
        X, Y = bench_data(n=n)
        _MODES[n] = (X, Y, _logistic_mode(X, Y, iters=12))
    return _MODES[n]


def _np_leaps(i, eps, T, max_leaps):
    """numpy's shared Halton leap count of transition i: the float32
    radical inverse u of i, then clip(ceil(u T / eps), 1, max_leaps) in
    float32 in that order."""
    u = np.float32(int(f"{i:032b}"[::-1], 2)) * np.float32(2.0 ** -32)
    nl = np.ceil(u * np.float32(T) / np.float32(eps))
    return int(min(max(nl, 1), max_leaps))


def phase_rows_kernel(C=4096, K=64, kt=8, k_chain=8):
    """The Halton multistep kernel against its plain version on the data
    as they are (eps 0.05, T 1.0) and on the diagonal-metric route's folded
    inputs (design X s, (d,) prior row lam s^2, chains in z-space): chain
    by chain on its own replayed draws over ``k_chain`` transitions from
    transition 1 (_rows_check); and statistically, K transitions from one
    start near the posterior mode, as K/kt launches through the warm
    route's driver and as one plain call of K transitions (nleaps rows
    equal exactly, and equal numpy's Halton formula; pooled final theta
    and per-chain accept rates within Z_MAX; a bitwise repeat).  Returns
    the chain-by-chain checks' largest theta error."""
    import torch

    from mcmc_jl_tpu_torch.ops import glm_kernels as gk
    from mcmc_jl_tpu_torch.ops.warmstart import _chees_run_ms

    X, Y, mode = _bench_mode(1000)
    s = _laplace_scale(X, Y)
    d = X.shape[1]
    err = 0.0
    for label, Xc, lam, start, spread, eps, T, ml in (
            ("theta, eps 0.05, T 1.0", X, 1.0, mode, 0.05, 0.05, 1.0, 40),
            ("folded diagonal metric (X s, (d,) prior row), eps 0.25, T 2.0",
             X * s, _cuda(s * s), mode / s, 0.5, 0.25, 2.0, 16)):
        rng = np.random.default_rng(31)
        th0 = _cuda(start + spread * rng.standard_normal((C, d)))
        XT, Yc = _cuda(Xc.T), _cuda(Y)
        kw = dict(prior_prec=lam)
        err = max(err, _rows_check(label, XT, Yc, th0, eps, T, 1, ml,
                                   k_chain, seed=77, **kw))
        r1, r2 = (gk.glm_multistep_rows(
            XT, Yc, th0, eps, T, 1, ml, k_trans=kt,
            generator=torch.Generator(device="cuda").manual_seed(12345), **kw)
            for _ in range(2))
        torch.cuda.synchronize()
        bitwise = (all(torch.equal(a, b) for a, b in zip(r1[:3], r2[:3]))
                   and all(torch.equal(r1[3][k], r2[3][k]) for k in r1[3]))
        gen = torch.Generator(device="cuda").manual_seed(3)
        (th_k, _, _), rows_k = _chees_run_ms(XT, Yc, th0, eps, T, gen,
                                             steps=K, i0=1, max_leaps=ml,
                                             k_trans=kt, lam=lam)
        th_p, _, _, rows_p = gk.glm_multistep_rows_ref(
            XT, Yc, th0, eps, T, 1, ml, k_trans=K, generator=gen, **kw)
        torch.cuda.synchronize()
        want = [_np_leaps(i, eps, T, ml) for i in range(1, K + 1)]
        nl_k = rows_k["nleaps"]
        nl_ok = (torch.equal(nl_k, rows_p["nleaps"])
                 and bool((nl_k == nl_k[:, :1]).all())
                 and nl_k[:, 0].tolist() == want)
        acc_k = rows_k["accept"].float().mean(0)
        acc_p = rows_p["accept"].float().mean(0)
        rep = {"z_theta_max": _z_t(th_k, th_p), "z_accept": _z_t(acc_k, acc_p),
               "accept_rate": float(acc_k.mean()),
               "accept_rate_plain": float(acc_p.mean()),
               "mean_nleaps": float(np.mean(want)),
               "pooled_theta_max_abs_diff": float(
                   (th_k.mean(0) - th_p.mean(0)).abs().max())}
        ok = (bitwise and nl_ok and rep["z_theta_max"] < Z_MAX
              and rep["z_accept"] < Z_MAX
              and bool(torch.isfinite(rows_k["plogtarget"]).all()))
        emit({"phase": "kernel", "name": "glm_multistep_rows", "case": label,
              "C": C, "k_trans": kt, "transitions": K, "ok": ok,
              "bitwise_repeat": bitwise, "nleaps_exact": nl_ok, **rep})
        assert ok, f"glm_multistep_rows ({label}) disagrees with its plain version"
    return {"glm_multistep_rows": err}


def _tiled_case(label, XT, Y, theta, kind="logistic", W=None, O=None,
                lam=1.0, chunk=256):
    """The N-tiled kernel against its plain version run in float64 on the
    same inputs (chunk by chunk of chains), each error held to the L1 mass
    of the terms it sums; and a bitwise repeat.  Returns the largest
    absolute error of lp and g."""
    import torch

    from mcmc_jl_tpu_torch.ops import glm_bign as gb
    from mcmc_jl_tpu_torch.ops.glm_kernels import link_terms

    kw = dict(kind=kind, weights=W, offsets=O, prior_prec=lam)
    lp, g = gb.glm_logp_grad_tiled(XT, Y, theta, **kw)
    lp2, g2 = gb.glm_logp_grad_tiled(XT, Y, theta, **kw)
    torch.cuda.synchronize()
    bitwise = torch.equal(lp, lp2) and torch.equal(g, g2)
    f64 = lambda a: None if a is None else a.double()  # noqa: E731
    XT64, Y64, W64, O64 = (f64(a) for a in (XT, Y, W, O))
    lam64 = lam.double() if hasattr(lam, "double") else float(lam)
    ll_fn, resid_fn = link_terms(kind)
    rel = {"g": 0.0, "lp": 0.0}
    err = {"g": 0.0, "lp": 0.0}
    for c0 in range(0, theta.shape[0], chunk):
        th = theta[c0:c0 + chunk].double()
        lp_r, g_r = gb.glm_logp_grad_tiled_ref(
            XT64, Y64, th, kind=kind, weights=W64, offsets=O64,
            prior_prec=lam64)
        z = th @ XT64
        if O64 is not None:
            z = z + O64
        r, ll = resid_fn(z, Y64), ll_fn(z, Y64)
        if W64 is not None:
            r, ll = W64 * r, W64 * ll
        # the prior's terms: lam theta, or with a (d, d) matrix theta A
        pg = (th.abs() @ lam64.abs() if getattr(lam64, "ndim", 0) == 2
              else (lam64 * th).abs())
        mass = {"g": r.abs() @ XT64.abs().T + pg,
                "lp": ll.abs().sum(-1) + 0.5 * (pg * th.abs()).sum(-1)}
        del z, r, ll
        for key, a, b in (("g", g, g_r), ("lp", lp, lp_r)):
            diff = (a[c0:c0 + chunk].double() - b).abs()
            err[key] = max(err[key], float(diff.max()))
            rel[key] = max(rel[key], float((diff / mass[key]).max()))
    ok = (bitwise and rel["g"] <= TILED_G_L1 and rel["lp"] <= TILED_LP_L1
          and bool(torch.isfinite(lp).all() and torch.isfinite(g).all()))
    emit({"phase": "kernel", "name": gb._counted("glm_logp_grad_tiled",
                                               _mat_or_none(lam)),
          "case": label,
          "C": theta.shape[0], "N": XT.shape[1], "d": XT.shape[0], "ok": ok,
          "bitwise_repeat": bitwise, "max_abs_err_g": err["g"],
          "max_abs_err_lp": err["lp"], "max_err_over_l1_mass_g": rel["g"],
          "max_err_over_l1_mass_lp": rel["lp"]})
    assert ok, f"glm_logp_grad_tiled ({label}) disagrees with its plain version"
    return max(err.values())


def phase_bign_kernels(shapes=((4096, 100_000), (1024, 1_000_000)),
                       ragged=(20_001, 7, 300)):
    """The N-tiled kernel against its plain version: on bench.py's data at
    each (C, N) of ``shapes``, chains near the mode; and every link with
    weights, offsets and a (d,) prior row at ``ragged`` = (N 20,001, a
    ragged last tile; d 7; C 300, a ragged last block of chains)."""
    from mcmc_jl_tpu_torch.ops.glm_kernels import KIND_CODES

    err = 0.0
    for C, N in shapes:
        X, Y, mode = _bench_mode(N)
        rng = np.random.default_rng(41)
        theta = mode + 0.05 * np.sqrt(1000 / N) * rng.standard_normal(
            (C, X.shape[1]))
        err = max(err, _tiled_case(f"bench data, C {C}, N {N}", _cuda(X.T),
                                   _cuda(Y), _cuda(theta)))
    rng = np.random.default_rng(42)
    N, d, C = ragged
    X = np.column_stack([np.ones(N), rng.standard_normal((N, d - 1))]) * 0.3
    z = X @ rng.standard_normal(d)
    W, O = rng.uniform(0.5, 2.0, N), 0.1 * rng.standard_normal(N)
    lam = rng.uniform(0.5, 2.0, d)
    theta = 0.05 * rng.standard_normal((C, d))
    for kind in KIND_CODES:
        Y = {"linear": z + rng.standard_normal(N),
             "poisson": rng.poisson(np.exp(z)).astype(float)}.get(
            kind, (rng.random(N) < 1 / (1 + np.exp(-z))).astype(float))
        err = max(err, _tiled_case(
            f"{kind}, weights+offsets, (d,) prior row, N {N}, d {d}, C {C}",
            _cuda(X.T), _cuda(Y), _cuda(theta), kind, _cuda(W), _cuda(O),
            _cuda(lam)))
    return {"glm_logp_grad_tiled": err}


def _glm_case(kind, N, d, C, seed, scale=0.3):
    """A GLM of link ``kind`` (N observations, d parameters, C chains near
    0) with weights and offsets, the design scaled by ``scale``: (XT, Y, W,
    O, theta, m)."""
    rng = np.random.default_rng(seed)
    X = np.column_stack([np.ones(N), rng.standard_normal((N, d - 1))]) \
        * scale
    z = X @ rng.standard_normal(d)
    Y = {"linear": z + rng.standard_normal(N),
         "poisson": rng.poisson(np.exp(z)).astype(float)}.get(
        kind, (rng.random(N) < 1 / (1 + np.exp(-z))).astype(float))
    return (_cuda(X.T), _cuda(Y), _cuda(rng.uniform(0.5, 2.0, N)),
            _cuda(0.1 * rng.standard_normal(N)),
            _cuda(0.05 * rng.standard_normal((C, d))),
            _cuda(rng.standard_normal((C, d))))


def _lp_grad(XT, Y, theta, **kw):
    """The plain (lp (C,), grad (C, d)) at theta under a check's keywords."""
    from mcmc_jl_tpu_torch.ops import glm_kernels as gk

    lp, g = gk.glm_funcs(XT, Y, kw.get("weights"), kw.get("offsets"),
                         kw.get("prior_prec", 1.0),
                         kw.get("kind", "logistic"))[1](theta)
    return lp.contiguous(), g.contiguous()


def _traj_check(label, XT, Y, theta, m, eps, **kw):
    """glm_leapfrogs against its plain version on the same inputs, at the
    tolerances of phase_kernels (the sums' atol grows with N / 1000).
    Returns the largest absolute error."""
    import torch

    from mcmc_jl_tpu_torch.ops import glm_kernels as gk

    _, g = _lp_grad(XT, Y, theta, **kw)
    out_k = gk.glm_leapfrogs(XT, Y, theta, m, g, eps, **kw)
    out_r = gk.glm_leapfrogs_ref(XT, Y, theta, m, g, eps, **kw)
    torch.cuda.synchronize()
    scale = max(1.0, XT.shape[1] / 1000)
    ok = (all(_close(a, b, RTOL, ATOL) for a, b in zip(out_k[:2], out_r[:2]))
          and _close(out_k[2], out_r[2], RTOL, G_ATOL * scale)
          and _close(out_k[3], out_r[3], LP_RTOL, LP_ATOL * scale)
          and all(bool(torch.isfinite(a).all()) for a in out_k))
    rep = {n: _err(a, b) for n, a, b in zip(("theta", "m", "g", "lp"),
                                            out_k, out_r)}
    emit({"phase": "kernel", "name": "glm_leapfrogs", "case": label,
          "C": theta.shape[0], "N": XT.shape[1], "d": XT.shape[0],
          "integrator": kw.get("integrator", "leapfrog"), "ok": ok, **rep})
    assert ok, f"glm_leapfrogs ({label}) disagrees with glm_leapfrogs_ref"
    return max(r["max_abs"] for r in rep.values())


def _step_check(label, XT, Y, theta, m0, logu, eps, mix=False, **kw):
    """glm_step against its plain version on the same injected noise (m0,
    logu): accept decisions may differ only where the plain version's MH
    ratio lies within ACC_BAND of log u; on the chains that agree theta, g
    and lp are held to phase_kernels' tolerances (the sums' atol grows with
    N / 1000).  With ``mix`` the plain version must both accept and reject.
    Returns the largest absolute error."""
    import torch

    from mcmc_jl_tpu_torch.ops import glm_kernels as gk

    C = theta.shape[0]
    lp, g = _lp_grad(XT, Y, theta, **kw)
    _, m_r, _, lp_r = gk.glm_leapfrogs_ref(XT, Y, theta, m0, g, eps, **kw)
    ratio = ((-lp + 0.5 * (m0 * m0).sum(-1))
             - (-lp_r + 0.5 * (m_r * m_r).sum(-1)))
    args = (XT, Y, theta, g, lp[:, None], m0, logu[:, None], eps)
    sk = gk.glm_step(*args, **kw)
    sr = gk.glm_step_ref(*args, **kw)
    torch.cuda.synchronize()
    ak, ar = sk[3][:, 0] > 0.5, sr[3][:, 0] > 0.5
    differ = ak != ar
    near = (ratio - logu).abs() < ACC_BAND
    same = ~differ
    scale = max(1.0, XT.shape[1] / 1000)
    rep = {n: _err(a[same], b[same]) for n, a, b in
           zip(("theta", "g", "lp"), sk[:3], sr[:3])}
    ok = (bool((~differ | near).all())
          and _close(sk[0][same], sr[0][same], RTOL, ATOL)
          and _close(sk[1][same], sr[1][same], RTOL, G_ATOL * scale)
          and _close(sk[2][same], sr[2][same], LP_RTOL, LP_ATOL * scale)
          and all(bool(torch.isfinite(a).all()) for a in sk)
          and (not mix or 0 < int(ar.sum()) < C))
    emit({"phase": "kernel", "name": "glm_step", "case": label, "C": C,
          "N": XT.shape[1], "d": XT.shape[0], "eps": eps,
          "integrator": kw.get("integrator", "leapfrog"),
          "kind": kw.get("kind", "logistic"), "ok": ok,
          "accept_agree": int(same.sum()), "accept_differ": int(differ.sum()),
          "accept_rate": float(ar.float().mean()), **rep})
    assert ok, f"glm_step ({label}) disagrees with glm_step_ref"
    return max(r["max_abs"] for r in rep.values())


def _multistep_check(label, XT, Y, theta, eps, k, seed, mix=False, **kw):
    """glm_multistep against k successive glm_step_ref calls chain by chain,
    on the kernel's own Philox draws (the launch seed a generator seeded
    ``seed`` gives, replayed by ``glm_multistep_draws``; the replayed
    normals and log-uniforms lie within a few float32 ulps of the
    kernel's).  A chain is on the plain version's accept path when its
    accept count matches and its final theta lies within LEAF_ATOL (a
    transition taken on one side only moves theta by a trajectory, eps |m|
    or more); at least PATH_AGREE of the chains must be, and on those the
    final theta is held to phase_kernels' tolerances, and the kernel's g
    and lp to the plain version's at the kernel's own theta (over k x
    n_leaps drifts the posterior's stiff directions amplify theta's
    rounding into g and lp: a Hessian of some 300 turns 4e-5 of theta
    into 1e-2 of g; their distance to the replayed run is reported).  The
    kernel also repeats bitwise.  With ``mix`` the plain version must both
    accept and reject.  Returns the largest absolute error of theta."""
    import torch

    from mcmc_jl_tpu_torch.ops import glm_kernels as gk

    def gen():
        return torch.Generator(device="cuda").manual_seed(seed)

    C, d = theta.shape
    out_k, out_k2 = (gk.glm_multistep(XT, Y, theta, eps, k_trans=k,
                                      generator=gen(), **kw)
                     for _ in range(2))
    m0, logu = gk.glm_multistep_draws(gk._seed(gen()), C, d, k,
                                      device="cuda")
    lp, g = _lp_grad(XT, Y, theta, **kw)
    th, lp = theta, lp[:, None]
    n_acc = torch.zeros_like(lp)
    for t in range(k):
        th, g, lp, acc = gk.glm_step_ref(XT, Y, th, g, lp, m0[t],
                                         logu[t][:, None], eps, **kw)
        n_acc += acc
    out_r = (th, g, lp[:, 0], n_acc[:, 0] / k)
    torch.cuda.synchronize()
    bitwise = all(torch.equal(a, b) for a, b in zip(out_k, out_k2))
    # accept counts, not rates: a float32 rate n / k rounds apart in the
    # kernel (a division) and in PyTorch (a product with 1 / k on the card)
    same = (((out_k[3] * k).round() == n_acc[:, 0])
            & ((out_k[0] - out_r[0]).abs().amax(-1) <= LEAF_ATOL))
    scale = max(1.0, XT.shape[1] / 1000)
    lp_own, g_own = _lp_grad(XT, Y, out_k[0], **kw)
    rep = {n: _err(a[same], b[same]) for n, a, b in
           zip(("theta", "g", "lp", "g_at_own_theta", "lp_at_own_theta"),
               out_k[:3] + out_k[1:3], out_r[:3] + (g_own, lp_own))}
    rate = float(out_r[3].mean())
    ok = (bitwise and float(same.float().mean()) >= PATH_AGREE
          and _close(out_k[0][same], out_r[0][same], RTOL, ATOL)
          and _close(out_k[1][same], g_own[same], RTOL, G_ATOL * scale)
          and _close(out_k[2][same], lp_own[same], LP_RTOL, LP_ATOL * scale)
          and all(bool(torch.isfinite(a).all()) for a in out_k)
          and (not mix or 0 < rate < 1))
    emit({"phase": "kernel", "name": "glm_multistep", "case": label,
          "draws": "the kernel's, replayed", "C": C, "N": XT.shape[1],
          "d": d, "k_trans": k, "eps": eps,
          "integrator": kw.get("integrator", "leapfrog"),
          "kind": kw.get("kind", "logistic"), "ok": ok,
          "bitwise_repeat": bitwise, "path_differ": int(C - same.sum()),
          "accept_rate": rate, **rep})
    assert ok, (f"glm_multistep ({label}) disagrees with successive "
                f"glm_step_ref calls on its own draws")
    return rep["theta"]["max_abs"]


def _rows_check(label, XT, Y, theta, eps, T, i0, max_leaps, k, seed,
                mix=False, **kw):
    """glm_multistep_rows (kernel 3b) against its plain version chain by
    chain, on the kernel's own Philox draws (the launch seed a generator
    seeded ``seed`` gives, replayed by ``glm_multistep_draws`` from
    absolute transition ``i0``; the replayed normals and log-uniforms lie
    within a few float32 ulps of the kernel's) fed to
    ``glm_multistep_rows_ref``.  The nleaps rows must equal the plain
    version's and numpy's Halton formula exactly.  A chain is on the plain
    version's accept path when its accept row matches at every transition
    and its final theta lies within LEAF_ATOL; at least PATH_AGREE of the
    chains must be, and on those the final theta is held to phase_kernels'
    tolerances and the kernel's g and lp to the plain version's at the
    kernel's own theta (as kernel 3's check holds them).  The kernel also
    repeats bitwise.  With ``mix`` the plain version must both accept and
    reject.  Returns the largest absolute error of theta."""
    import torch

    from mcmc_jl_tpu_torch.ops import glm_kernels as gk

    def gen():
        return torch.Generator(device="cuda").manual_seed(seed)

    C, d = theta.shape
    out_k, out_k2 = (gk.glm_multistep_rows(XT, Y, theta, eps, T, i0,
                                           max_leaps, k_trans=k,
                                           generator=gen(), **kw)
                     for _ in range(2))
    m0, logu = gk.glm_multistep_draws(gk._seed(gen()), C, d, k, i0=i0,
                                      device="cuda")
    out_r = gk.glm_multistep_rows_ref(XT, Y, theta, eps, T, i0, max_leaps,
                                      k_trans=k, noise=(m0, logu), **kw)
    torch.cuda.synchronize()
    rk, rr = out_k[3], out_r[3]
    bitwise = (all(torch.equal(a, b) for a, b in zip(out_k[:3], out_k2[:3]))
               and all(torch.equal(rk[n], out_k2[3][n]) for n in rk))
    want = [_np_leaps(i, eps, T, max_leaps) for i in range(i0, i0 + k)]
    nl_ok = (torch.equal(rk["nleaps"], rr["nleaps"])
             and rk["nleaps"].tolist() == [[nl] * C for nl in want])
    same = ((rk["accept"] == rr["accept"]).all(0)
            & ((out_k[0] - out_r[0]).abs().amax(-1) <= LEAF_ATOL))
    scale = max(1.0, XT.shape[1] / 1000)
    prior = kw.get("prior_prec", 1.0)
    lp_own, g_own = _lp_grad(XT, Y, out_k[0], **kw)
    rep = {n: _err(a[same], b[same]) for n, a, b in
           zip(("theta", "g_at_own_theta", "lp_at_own_theta"),
               (out_k[0], out_k[1], out_k[2]), (out_r[0], g_own, lp_own))}
    rep["alpha"] = _err(rk["alpha"][:, same], rr["alpha"][:, same])
    rate = float(rr["accept"].float().mean())
    ok = (bitwise and nl_ok and float(same.float().mean()) >= PATH_AGREE
          and _close(out_k[0][same], out_r[0][same], RTOL, ATOL)
          and _close(out_k[1][same], g_own[same], RTOL, G_ATOL * scale)
          and _close(out_k[2][same], lp_own[same], LP_RTOL, LP_ATOL * scale)
          and all(bool(torch.isfinite(a).all()) for a in out_k[:3])
          and bool(torch.isfinite(rk["plogtarget"]).all())
          and (not mix or 0 < rate < 1))
    emit({"phase": "kernel", "name": gk._counted("glm_multistep_rows",
                                               _mat_or_none(prior)),
          "case": label, "draws": "the kernel's, replayed", "C": C,
          "N": XT.shape[1],
          "d": d, "k_trans": k, "i0": i0, "eps": eps, "T": T,
          "max_leaps": max_leaps, "nleaps": want,
          "prior": (("(d, d) matrix" if prior.ndim == 2 else "(d,) row")
                    if hasattr(prior, "shape") else prior),
          "integrator": kw.get("integrator", "leapfrog"),
          "kind": kw.get("kind", "logistic"), "ok": ok,
          "bitwise_repeat": bitwise, "nleaps_exact": nl_ok,
          "path_differ": int(C - same.sum()), "accept_rate": rate, **rep})
    assert ok, (f"glm_multistep_rows ({label}) disagrees with its plain "
                f"version on its own draws")
    return rep["theta"]["max_abs"]


def phase_tile_kernels(main_chains=(65536, 4099), k_edge=5):
    """Kernels 1-4, redesigned on the chain-tile gradient, against their
    plain versions at their paths' shapes and at their edges (the 4096-chain
    main-path cases and every link at N 5000 are in phase_kernels, the
    tiled kernel's bench shapes and links in phase_bign_kernels):
    kernels 1, 2 and 3 on bench.py's data at 65536 chains and at 4099 (a
    ragged last tile of 16 chains), 2 and 3 at STEP_EPS (both accepts and
    rejects); d = 1, 8, 16 and 32; rows streamed in cp.async tiles (N 2000
    at d 32, 3000 at d 16, 16,384 at d 10); every link with weights,
    offsets and prior_prec 1.3; every integrator.  Kernel 2 on injected
    noise, kernels 3 and 3b over ``k_edge`` transitions on their own draws
    replayed (3b with a (d,) prior row at every edge, its Halton leap
    counts from transition 501 with T n_leaps eps and max_leaps 2 n_leaps).
    Kernel 4 at d = 1, 16 and 32 with weights, offsets and a (d,) prior
    row."""
    traj, step, multi, rows, tiled = [], [], [], [], []
    for C in main_chains:
        XT, Y, theta, m0, logu, _, _ = _inputs(C, seed=21)
        traj.append(_traj_check(f"bench data, C {C}", XT, Y, theta, m0,
                                0.05, n_leaps=10))
        step.append(_step_check(f"bench data, C {C}", XT, Y, theta, m0,
                                logu, STEP_EPS, mix=True, n_leaps=10))
        multi.append(_multistep_check(f"bench data, C {C}", XT, Y, theta,
                                      STEP_EPS, k_edge, seed=C, mix=True,
                                      n_leaps=10))
        rows.append(_rows_check(
            f"bench data, C {C}, (d,) prior row", XT, Y, theta, STEP_EPS,
            10 * STEP_EPS, 501, 20, k_edge, seed=C + 1, mix=True,
            prior_prec=_cuda(np.linspace(0.5, 2.0, XT.shape[0]))))
    cases = [  # (label, kind, N, d, C, integrator, eps, n_leaps)
        ("d 1", "logistic", 1000, 1, 300, "leapfrog", 0.05, 10),
        ("d 32", "probit", 1000, 32, 300, "3stage", 0.02, 5),
        ("d 32, rows streamed", "logistic", 2000, 32, 300, "2stage", 0.01, 4),
        ("N 16384, rows streamed", "logistic", 16_384, 10, 4096, "leapfrog",
         0.005, 10),
        ("d 16, rows streamed", "poisson", 3000, 16, 333, "3stage", 0.005, 3),
        ("d 8", "linear", 1000, 8, 1000, "leapfrog", 0.01, 6),
    ]
    for i, (label, kind, N, d, C, integ, eps, nl) in enumerate(cases):
        XT, Y, W, O, theta, m = _glm_case(kind, N, d, C, seed=30 + i)
        label = f"{label}, {kind}, weights+offsets"
        kw = dict(n_leaps=nl, kind=kind, weights=W, offsets=O,
                  prior_prec=1.3, integrator=integ)
        traj.append(_traj_check(label, XT, Y, theta, m, eps, **kw))
        logu = _cuda(np.log(np.random.default_rng(50 + i).random(len(theta))))
        step.append(_step_check(label, XT, Y, theta, m, logu, eps, **kw))
        multi.append(_multistep_check(label, XT, Y, theta, eps, k_edge,
                                      seed=60 + i, **kw))
        kw.pop("n_leaps")
        kw["prior_prec"] = _cuda(np.random.default_rng(70 + i).uniform(
            0.5, 2.0, d))
        rows.append(_rows_check(f"{label}, (d,) prior row", XT, Y, theta,
                                eps, nl * eps, 501, 2 * nl, k_edge,
                                seed=80 + i, **kw))
    rng = np.random.default_rng(43)
    for d, kind in ((1, "logistic"), (32, "probit"), (16, "poisson")):
        N, C = 20_001, 300
        XT, Y, W, O, theta, _ = _glm_case(kind, N, d, C, seed=44 + d)
        lam = _cuda(rng.uniform(0.5, 2.0, d))
        tiled.append(_tiled_case(
            f"{kind}, weights+offsets, (d,) prior row, N {N}, d {d}, C {C}",
            XT, Y, theta, kind, W, O, lam))
    return {"glm_leapfrogs": max(traj), "glm_step": max(step),
            "glm_multistep": max(multi), "glm_multistep_rows": max(rows),
            "glm_logp_grad_tiled": max(tiled)}


def _sm_clocks():
    """SMs times the card's maximum SM clock (Hz): clocks a second."""
    import torch

    if "sm_clock_hz" not in CARD:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, check=True)
        CARD["sm_clock_hz"] = 1e6 * float(smi.stdout.split()[0])
        CARD["sms"] = torch.cuda.get_device_properties(0).multi_processor_count
    return CARD["sms"] * CARD["sm_clock_hz"]


def _sfu_floor_ms(links, per_link):
    """The special-function floor (ms) of ``links`` link evaluations with
    ``per_link`` special-function results each: results over 16 per clock
    per SM on every SM at the card's maximum SM clock."""
    return 1e3 * links * per_link / (16 * _sm_clocks())


def _rng_floor_ms(calls):
    """The floor (ms) of ``calls`` Philox4x32-10 calls: their IMADs over
    the integer pipe's rate on every SM at the maximum SM clock."""
    return 1e3 * calls * PHILOX_IMAD / (IMAD_PER_CLOCK * _sm_clocks())


# special-function results per logistic link: expf's exponential and the
# reciprocal (the log term of ll needs none: csrc/glm_tile.cuh forms it by
# a polynomial)
SFU_PER_LINK = 2


def _plan(mod, fn, *args):
    """The occupancy plan a tile kernel's library (that of wrapper module
    ``mod``) reports, or None for a library without one (the kernels
    before the chain-tile redesign)."""
    import ctypes

    lib = mod.load_kernels()
    if not hasattr(lib, fn):
        return None
    outs = [ctypes.c_int() for _ in range(2 if fn == "glm_tiled_plan"
                                          else 3)]
    code = getattr(lib, fn)(*[ctypes.c_int(a) for a in args],
                            *[ctypes.byref(o) for o in outs])
    assert code == 0, f"{fn} failed ({code})"
    keys = ("blocks_per_sm", "smem_bytes", "resident")
    return dict(zip(keys, (o.value for o in outs)))


def phase_tile_times(C1=(4096, 65536),
                     tiled=((4096, 100_000), (1024, 1_000_000),
                            (512, 100_000)),
                     n_leaps=10, eps=0.05, k_trans=200):
    """Per-launch time of kernels 1-4 at the shapes whose launches PERF.md
    counts, beside the plain version, the bound (the link's special
    functions not counted), the special-function floor and the occupancy
    plan: kernels 1, 2 and 3 at each of C1 chains (4096: the main path's
    and the drivers'; 65536: bench.py's), with CUDA events (the wrapper's
    host work included) and torch.profiler's device time; kernel 4 at each
    (C, N) of ``tiled`` (4096 x 1e5: the large-N path; 512 x 1e5: the
    adaptive large-N path), with its two kernels' device time (partials
    and their reduction) and the two products alone beside it (FP32, TF32
    off; a yardstick, not the same function).  Runs on whichever
    package ``mcmc_jl_tpu_torch`` resolves to, so one call can time a
    parent tree.  Returns ({kernel: (ms, plain ms)}, {kernel: bound}) at
    the paths' shapes (kernels 1-3 at C1[0], kernel 4 at tiled[0])."""
    import torch

    from mcmc_jl_tpu_torch.ops import glm_bign as gb
    from mcmc_jl_tpu_torch.ops import glm_kernels as gk

    ms, work = {}, {}

    def report(name, shape, t, bound, floor, plan=None, **more):
        emit({"phase": "tile_time", "name": name, **shape, "ms": t[0],
              "plain_ms": t[1], **bound, "share_of_bound":
              bound["bound_ms"] / t[0], "sfu_floor_ms": floor,
              "plan": plan, **more, **CARD})

    for C in C1:
        XT, Yc, theta, m0, logu, lp, g = _inputs(C, seed=4)
        d, N = XT.shape
        gen = torch.Generator(device="cuda").manual_seed(5)
        gen_k = torch.Generator(device="cuda").manual_seed(7)
        kw = dict(n_leaps=n_leaps)
        # kernel -> (kernel call, plain call, inputs, gradient evaluations,
        # transitions, the __global__ names: this tree's and the
        # one-thread-per-chain kernels' before the chain-tile redesign)
        calls = {
            "glm_leapfrogs": (
                lambda: gk.glm_leapfrogs(XT, Yc, theta, m0, g, eps, **kw),
                lambda: gk.glm_leapfrogs_ref(XT, Yc, theta, m0, g, eps,
                                             **kw),
                (XT, Yc, theta, m0, g), C * n_leaps, 1,
                ("leapfrogs_tile_kernel",)),
            "glm_step": (
                lambda: gk.glm_step(XT, Yc, theta, g, lp, m0, logu, eps,
                                    **kw),
                lambda: gk.glm_step_ref(XT, Yc, theta, g, lp, m0, logu, eps,
                                        **kw),
                (XT, Yc, theta, g, lp, m0, logu), C * n_leaps, 1,
                ("step_tile_kernel", "step_kernel")),
            "glm_multistep": (
                lambda: gk.glm_multistep(XT, Yc, theta, eps,
                                         k_trans=k_trans, generator=gen_k,
                                         **kw),
                lambda: gk.glm_multistep_ref(XT, Yc, theta, eps,
                                             k_trans=k_trans, generator=gen,
                                             **kw),
                (XT, Yc, theta), C * (1 + k_trans * n_leaps), k_trans,
                ("multistep_tile_kernel", "multistep_kernel")),
        }
        for name, (kern, plain, inputs, evals, kt, symbols) in calls.items():
            bound = _bound(evals, d, N, _nbytes(inputs, kern()))
            t = (_event_ms(kern), _event_ms(plain, reps=2))
            report(name, {"C": C, "N": N, "n_leaps": n_leaps,
                          "k_trans": kt}, t, bound,
                   _sfu_floor_ms(evals * N, SFU_PER_LINK),
                   _plan(gk, f"{name}_plan", d, N),
                   device_ms=_device_ms(kern, symbols, reps=3))
            if C == C1[0]:
                ms[name], work[name] = t, bound

    rng = np.random.default_rng(51)
    for C4, N4 in tiled:
        X4, Y4, mode4 = _bench_mode(N4)
        XT4, Y4c = _cuda(X4.T), _cuda(Y4)
        th4 = _cuda(mode4 + 0.01 * rng.standard_normal((C4, X4.shape[1])))
        kern = lambda: gb.glm_logp_grad_tiled(XT4, Y4c, th4)  # noqa: E731
        plain = lambda: gb.glm_logp_grad_tiled_ref(XT4, Y4c,  # noqa: E731
                                                   th4)
        bound = _bound(C4, X4.shape[1], N4, _nbytes((XT4, Y4c, th4), kern()))
        t = (_event_ms(kern), _event_ms(plain, reps=2))
        r4 = torch.randn(C4, N4, device="cuda")
        prod = (_event_ms(lambda: th4 @ XT4)
                + _event_ms(lambda: r4 @ XT4.T))
        del r4
        report("glm_logp_grad_tiled", {"C": C4, "N": N4}, t, bound,
               _sfu_floor_ms(C4 * N4, SFU_PER_LINK),
               _plan(gb, "glm_tiled_plan", X4.shape[1]),
               splits=gb.splits_for(N4, C4),
               two_products_ms_not_the_same_function=prod,
               device_ms=_device_ms(kern, ("partial_tile_kernel",
                                           "reduce_kernel"), reps=3))
        if (C4, N4) == tiled[0]:
            ms["glm_logp_grad_tiled"], work["glm_logp_grad_tiled"] = t, bound
    return ms, work


def _replay_gap(XT, Y, state, m0, logu, eps, n_leaps):
    """One transition of the chains in ``state`` = (theta, g, lp) with both
    kernel families on the same momenta ``m0`` and log-uniforms ``logu``:
    the smaller distance of the two MH ratios from log u, per chain."""
    import torch

    from mcmc_jl_tpu_torch.ops.glm_bign import _tiled_funcs
    from mcmc_jl_tpu_torch.ops.glm_kernels import _trajectory, glm_leapfrogs

    th, g, lp = state
    h0 = -lp + 0.5 * (m0 * m0).sum(-1)
    grad_only, logp_grad = _tiled_funcs(XT, Y, None, None, 1.0, "logistic")
    _, ma, _, lpa = _trajectory(th, m0, g, eps, grad_only, logp_grad,
                                n_leaps, "leapfrog")
    _, mb, _, lpb = glm_leapfrogs(XT, Y, th, m0, g, eps, n_leaps=n_leaps)
    gaps = [(h0 - (-lpx + 0.5 * (mx * mx).sum(-1)) - logu).abs()
            for mx, lpx in ((ma, lpa), (mb, lpb))]
    return torch.minimum(*gaps)


def phase_cross_kernel(C=4096, N=10_000, steps=20, n_leaps=10):
    """The two kernel families on one posterior: the tiled driver _run_bign
    and the composed trajectory-kernel driver _run draw the same numbers
    from one seed in the same order, so their chains must coincide.  A
    chain may take another accept decision only where its MH ratio lies
    within ACC_BAND * N / 1000 of log u (lp, a sum of N terms, carries
    float32 rounding of its size): each such chain's first differing
    transition is replayed with both families from the tiled run's state
    on the same draws.  The chains with the same decisions end within
    1e-4."""
    import torch

    from mcmc_jl_tpu_torch.ops.glm_bign import _run_bign, glm_logp_grad_tiled
    from mcmc_jl_tpu_torch.ops.glm_hmc import _run
    from mcmc_jl_tpu_torch.ops.glm_kernels import _draw

    X, Y, mode = _bench_mode(N)
    rng = np.random.default_rng(43)
    th0 = _cuda(mode + 0.01 * rng.standard_normal((C, X.shape[1])))
    XT, Yc = _cuda(X.T), _cuda(Y)
    eps = 0.05 * np.sqrt(1000 / N)  # the posterior is sqrt(N / 1000) narrower
    kw = dict(steps=steps, n_leaps=n_leaps, collect=True)
    (a, _, _), ia = _run_bign(XT, Yc, th0, eps,
                              torch.Generator(device="cuda").manual_seed(11),
                              **kw)
    (b, _, _), ib = _run(XT, Yc, th0, eps,
                         torch.Generator(device="cuda").manual_seed(11), **kw)
    torch.cuda.synchronize()
    flips = ia["accept"] != ib["accept"]
    same = ~flips.any(0)
    err = float((a - b).abs()[same].max())
    differ = (~same).nonzero().flatten().tolist()
    gaps = []
    if differ:
        gen = torch.Generator(device="cuda").manual_seed(11)
        draws = [_draw(th0, gen) for _ in range(steps)]
        lp0, g0 = glm_logp_grad_tiled(XT, Yc, th0)
        for c in differ:
            t = int(flips[:, c].nonzero()[0])
            sl = slice(c, c + 1)
            state = ((th0[sl], g0[sl], lp0[sl]) if t == 0 else
                     (ia["ppars"][t - 1, sl].contiguous(),
                      ia["pgrads"][t - 1, sl].contiguous(),
                      ia["plogtarget"][t - 1, sl]))
            gaps.append(float(_replay_gap(XT, Yc, state, draws[t][0][sl],
                                          draws[t][1][sl], eps, n_leaps)))
    band = ACC_BAND * N / 1000
    ok = err <= 1e-4 and all(gap < band for gap in gaps)
    emit({"phase": "cross_kernel", "C": C, "N": N, "transitions": steps,
          "eps": eps, "accept_rate": float(ia["accept"].float().mean()),
          "chains_same_decisions": float(same.float().mean()),
          "theta_max_abs_diff": err, "flip_ratio_gaps": gaps,
          "acc_band": band, "ok": ok})
    assert ok, "the tiled and the trajectory-kernel drivers disagree"


def _path(label, task, chains, want, seed=0):
    """``run(task, chains=...)`` with every count zeroed just before it and
    read just after: each kernel launched as ``want`` says (a count, or a
    predicate on it; 0 for the others), no plain version ran.  Returns
    (chains, kept samples (chains, kept, d), launches, seconds, spans)."""
    import mcmc_jl_tpu_torch as mt

    t0 = time.perf_counter()
    with _spans() as spans:
        cs, launches = _counted(lambda: mt.run(task, chains=chains,
                                               seed=seed))
    dt = time.perf_counter() - t0
    for k, n in launches.items():
        w = want.get(k, 0)
        assert (w(n) if callable(w) else n == w), (label, launches)
    samples = np.stack([c.samples.values for c in cs])
    assert samples.shape == (chains, len(task.runner.r), task.model.size)
    assert np.all(np.isfinite(samples))
    return cs, samples, launches, dt, spans


def _origin(m, task, chains):
    r = task.runner
    return (f"run(model(glm=..., N={m.glm_spec.X.shape[0]}) * "
            f"{task.sampler!r} * SerialMC(steps={r.len}, burnin={r.burnin}),"
            f" chains={chains})")


def phase_large_n_paths(chains=4096, chains_adaptive=512, generic_chains=512,
                        N=100_000, ref_steps=1000):
    """N = 100,000 (bench.py's data; the posterior 10 times narrower than at
    N = 1000), every chain starting at the posterior mode:

    1. plain ``HMC(10, 0.005) * SerialMC(200, 50)`` at 4096 chains: the
       tiled driver, once per drift; held against 512 generic-engine chains
       from the same start over the same transitions;
    2. adaptive ``HMC(10, 0.002, EmpMCTuner(0.8, adapt_step=50)) *
       SerialMC(110, 50)`` at 512 chains (``bign.py:73``'s (200, 50) cut
       to keep the script under 600 s): the warm route's sampling phase
       through the tiled kernel; held against 512 of run 1's chains
       continued ``ref_steps`` transitions.
    Returns the tiled kernel's launches in run 1, and run 2's tasks with its
    reference's per-chain means (for phase_resume_paths)."""
    import torch

    import mcmc_jl_tpu_torch as mt
    from mcmc_jl_tpu_torch.ops.glm_bign import _run_bign

    X, Y, mode = _bench_mode(N)
    m = mt.model(glm=("logistic", X, Y), init=mode, device="cuda")
    task = m * mt.HMC(10, 0.005) * mt.SerialMC(steps=200, burnin=50)
    origin = _origin(m, task, chains)
    cs, samples, launches, dt, spans = _path(
        origin, task, chains, {"glm_logp_grad_tiled": 200 * 10 + 1})
    acc = float(np.mean([mt.acceptance(c) for c in cs])) / 100
    del cs
    cg = mt.run(task, chains=generic_chains, seed=1, fused=False)
    gs = np.stack([c.samples.values for c in cg])
    z = _z_means(samples.mean(1), gs.mean(1))
    emit({"phase": "large_n_path", "kernel": "glm_logp_grad_tiled",
          "from": origin, "chains": chains, "seconds": dt, "spans_s": spans,
          "launches": launches["glm_logp_grad_tiled"], "accept_rate": acc,
          "generic_accept_rate": float(np.mean([mt.acceptance(c)
                                                for c in cg])) / 100,
          "pooled_mean": samples.mean((0, 1)).tolist(),
          "generic_pooled_mean": gs.mean((0, 1)).tolist(),
          "z_max_vs_generic": z, "ok": z < Z_MAX, **CARD})
    assert z < Z_MAX, f"{origin} disagrees with the generic engine"
    counts = {"glm_logp_grad_tiled": (launches["glm_logp_grad_tiled"],
                                      origin)}

    spec = m.glm_spec
    t0 = time.perf_counter()
    _, ref = _run_bign(spec.X.T.contiguous(), spec.Y,
                       _cuda(samples[:chains_adaptive, -1]), 0.005,
                       torch.Generator(device="cuda").manual_seed(5),
                       steps=ref_steps, n_leaps=10, collect=True)
    ref_means = ref["ppars"].mean(0).double().cpu().numpy()
    ref_s = time.perf_counter() - t0
    del ref, samples, gs, cg

    task = m * mt.HMC(10, 0.002, mt.EmpMCTuner(0.8, adapt_step=50)) \
        * mt.SerialMC(steps=110, burnin=50)
    origin = _origin(m, task, chains_adaptive)
    cs, samples, launches, dt, spans = _path(
        origin, task, chains_adaptive,
        {"glm_logp_grad_tiled": lambda n: n >= 60 + 1})
    st = cs[0].task.state
    z = _z_means(samples.mean(1), ref_means)
    emit({"phase": "large_n_path", "kernel": "glm_logp_grad_tiled",
          "from": origin, "chains": chains_adaptive, "seconds": dt,
          "spans_s": spans, "launches": launches["glm_logp_grad_tiled"],
          "frozen_eps": st.tune.step_size.item(),
          "frozen_n_leaps": st.tune.n_leaps.item(),
          "accept_rate": float(np.mean([mt.acceptance(c) for c in cs])) / 100,
          "reference": f"{chains_adaptive} chains of HMC(10, 0.005) "
                       f"continued {ref_steps} transitions ({ref_s:.1f} s)",
          "z_max_vs_reference": z, "ok": z < Z_MAX, **CARD})
    assert z < Z_MAX, f"{origin} disagrees with the reference"
    return counts, ([c.task for c in cs], ref_means)


def phase_warm_paths(hmc_means, chains=4096, chains_small=1024):
    """N = 1000, every chain starting at the posterior mode, each run held
    against ``hmc_means`` (:func:`_hmc_reference`):

    - ``HMC(10, 0.02, EmpMCTuner(0.8, adapt_step=50), mass_adapt="diag") *
      SerialMC(2000, 500)`` at 4096 chains (examples/warmstart_logistic.py):
      1500 sampling transitions as 250 launches of 6 of the Halton
      multistep kernel with the folded (d,) prior row;
    - ``HMCDA() * SerialMC(800, 80)`` (cut from (1000, 200) for the
      script's time: 90 launches of 8) and ``MALA(0.002, EmpMCTuner(0.574,
      adapt_step=50)) * SerialMC(1000, 200)`` (100 launches of 8) at 1024
      chains.
    Returns the Halton kernel's launches in the first run, the step and
    leap count that run froze at, and its tasks (for phase_resume_paths)."""
    import mcmc_jl_tpu_torch as mt

    X, Y, mode = _bench_mode(1000)
    m = mt.model(glm=("logistic", X, Y), init=mode, device="cuda")
    runs = (
        (mt.HMC(10, 0.02, mt.EmpMCTuner(0.8, adapt_step=50),
                mass_adapt="diag"), 2000, 500, chains, 250),
        (mt.HMCDA(), 800, 80, chains_small, 90),
        (mt.MALA(0.002, mt.EmpMCTuner(0.574, adapt_step=50)), 1000, 200,
         chains_small, 100),
    )
    counts = {}
    for sampler, steps, burnin, C, want in runs:
        task = m * sampler * mt.SerialMC(steps=steps, burnin=burnin)
        origin = _origin(m, task, C)
        cs, samples, launches, dt, spans = _path(
            origin, task, C, {"glm_multistep_rows": want})
        st = cs[0].task.state
        frozen = ({"frozen_eps": st.leap_step.item()}
                  if isinstance(sampler, mt.HMCDA) else
                  {"frozen_step": st.tune.step_size.item(),
                   "frozen_n_leaps": st.tune.n_leaps.item()})
        z = _z_means(samples.mean(1), hmc_means)
        emit({"phase": "warm_path", "kernel": "glm_multistep_rows",
              "from": origin, "chains": C, "seconds": dt, "spans_s": spans,
              "launches": launches["glm_multistep_rows"], **frozen,
              "accept_rate": float(np.mean([mt.acceptance(c)
                                            for c in cs])) / 100,
              "pooled_mean": samples.mean((0, 1)).tolist(),
              "z_max_vs_hmc_reference": z, "ok": z < Z_MAX, **CARD})
        assert z < Z_MAX, f"{origin} disagrees with the HMC reference"
        if "glm_multistep_rows" not in counts:
            counts["glm_multistep_rows"] = (launches["glm_multistep_rows"],
                                            origin)
            hmc_frozen = (frozen["frozen_step"], frozen["frozen_n_leaps"])
            tasks = [c.task for c in cs]
    return counts, hmc_frozen, tasks


def phase_new_kernel_times(hmc_frozen, C=4096, kt=6, i0=501,
                           family=(16_384, 100_000)):
    """Per-launch device time of the Halton multistep kernel at the shape
    its adaptive HMC path launches it (phase_warm_paths): the frozen step
    and leap count ``hmc_frozen`` = (eps, nl), so T = 2 nl eps and
    max_leaps 2 nl (warmstart.py warmfused_hmc_chains), on the folded
    diagonal metric (design X s, (d,) prior row s^2, chains in z = theta /
    s drawn from the Laplace approximation; s its scales), from absolute
    transition ``i0`` (the first after a burn-in of 500), ``kt``
    transitions (the path's launches carry 6, ``_pick_k_trans``), with
    CUDA events and torch.profiler's device time; beside its plain
    version, its bound, its special-function floor and its occupancy plan;
    and both kernel families per gradient at C 4096 and N 16,384 and
    100,000, where the route switches between them.
    Returns ({kernel: (ms, plain ms)}, {kernel: bound})."""
    import torch

    from mcmc_jl_tpu_torch.ops import glm_bign as gb
    from mcmc_jl_tpu_torch.ops import glm_kernels as gk

    ms, work = {}, {}
    X, Y, mode = _bench_mode(1000)
    d = X.shape[1]
    rng = np.random.default_rng(51)
    sc = _laplace_scale(X, Y)
    eps, nl = hmc_frozen
    T, max_leaps = 2.0 * nl * eps, max(2 * nl, 2)
    XT, Yc = _cuda((X * sc).T), _cuda(Y)
    th = _cuda(mode / sc + rng.standard_normal((C, d)))
    kw = dict(k_trans=kt, prior_prec=_cuda(sc * sc))
    gen_k = torch.Generator(device="cuda").manual_seed(7)
    gen_p = torch.Generator(device="cuda").manual_seed(8)
    args = (XT, Yc, th, eps, T, i0, max_leaps)
    kern = lambda: gk.glm_multistep_rows(*args, generator=gen_k,  # noqa: E731
                                         **kw)
    plain = lambda: gk.glm_multistep_rows_ref(  # noqa: E731
        *args, generator=gen_p, **kw)
    out = kern()
    leaps = int(out[3]["nleaps"][:, 0].sum())
    evals = C * (1 + leaps)
    work["glm_multistep_rows"] = {
        **_bound(evals, d, X.shape[0], _nbytes((XT, Yc, th), out)),
        "device_ms": _device_ms(kern, ("rows_tile_kernel",
                                       "multistep_rows_kernel"), reps=3)}
    ms["glm_multistep_rows"] = (_event_ms(kern), _event_ms(plain, reps=2))
    emit({"phase": "kernel_time", "name": "glm_multistep_rows", "C": C,
          "N": X.shape[0], "k_trans": kt, "eps": eps, "T": T,
          "max_leaps": max_leaps, "i0": i0,
          "ms": ms["glm_multistep_rows"][0],
          "plain_ms": ms["glm_multistep_rows"][1], "leapfrogs": leaps,
          **work["glm_multistep_rows"],
          "sfu_floor_ms": _sfu_floor_ms(evals * X.shape[0], SFU_PER_LINK),
          "plan": _plan(gk, "glm_multistep_rows_plan", d, X.shape[0]),
          **CARD})

    for N5 in family:
        X5, Y5, mode5 = _bench_mode(N5)
        XT5, Y5c = _cuda(X5.T), _cuda(Y5)
        th5 = _cuda(mode5 + 0.01 * rng.standard_normal((C, d)))
        m5 = torch.randn(C, d, device="cuda")
        _, g5 = gb.glm_logp_grad_tiled(XT5, Y5c, th5)
        traj = _event_ms(lambda: gk.glm_leapfrogs(XT5, Y5c, th5, m5, g5,
                                                  1e-3, n_leaps=10)) / 10
        tiled = _event_ms(lambda: gb.glm_logp_grad_tiled(XT5, Y5c, th5))
        emit({"phase": "family_per_gradient", "C": C, "N": N5,
              "trajectory_kernel_ms_per_gradient": traj,
              "tiled_kernel_ms_per_gradient": tiled, **CARD})
    return ms, work


def _target_cases():
    """The reference's 17 bare-distribution configurations
    (benchmarks/benchunits/bare_distribs.py:41-61) with their starting
    points, and a spread s: the kernel checks start at x0 + 0.1 s N(0, 1)
    and step 0.05 s."""
    import math

    import mcmc_jl_tpu_torch as mt

    return [
        ("Normal(1,1)", mt.Normal(1.0, 1.0), 1.0, 1.0),
        ("Normal(3,12)", mt.Normal(3.0, 12.0), 3.0, 12.0),
        ("Weibull(1,1)", mt.Weibull(1.0, 1.0), 1.0, 1.0),
        ("Weibull(3,1)", mt.Weibull(3.0, 1.0), 0.8930, 0.3),
        ("Uniform(0,2)", mt.Uniform(0.0, 2.0), 1.0, 0.5),
        ("TDist(2.2)", mt.TDist(2.2), 1.0, 1.0),
        ("TDist(4)", mt.TDist(4.0), 1.0, 1.0),
        ("Beta(1,2)", mt.Beta(1.0, 2.0), 1.0 / 3.0, 0.2),
        ("Beta(3,2)", mt.Beta(3.0, 2.0), 0.6, 0.2),
        ("Gamma(1,2)", mt.Gamma(1.0, 2.0), 2.0, 2.0),
        ("Gamma(3,0.2)", mt.Gamma(3.0, 0.2), 0.6, 0.35),
        ("Cauchy(0,1)", mt.Cauchy(0.0, 1.0), 1.0, 1.0),
        ("Cauchy(-1,0.2)", mt.Cauchy(-1.0, 0.2), 1.0, 0.2),
        ("Exponential(3)", mt.Exponential(3.0), 3.0, 3.0),
        ("Exponential(0.2)", mt.Exponential(0.2), 0.2, 0.2),
        ("LogNormal(-1,1)", mt.LogNormal(-1.0, 1.0), math.exp(-0.5), 0.5),
        ("LogNormal(2,0.1)", mt.LogNormal(2.0, 0.1), math.exp(2.005), 0.75),
    ]


def _kernel_families():
    """One distribution of each of the ten kernel families, with a point
    near its mean and a scale: [(dist, x0, s)]."""
    import mcmc_jl_tpu_torch as mt

    return [(mt.Normal(0.0, 1.0), 0.0, 1.0), (mt.Uniform(-1.0, 3.0), 1.0, 1.0),
            (mt.Exponential(2.0), 2.0, 2.0), (mt.Gamma(2.0, 1.5), 3.0, 2.0),
            (mt.Weibull(1.5, 2.0), 1.8, 1.0), (mt.Cauchy(0.0, 1.0), 0.0, 1.0),
            (mt.LogNormal(0.0, 0.5), 1.1, 0.5), (mt.Beta(2.0, 3.0), 0.4, 0.2),
            (mt.Laplace(0.0, 1.0), 0.0, 1.0), (mt.TDist(5.0), 0.0, 1.0)]


def _mixed_target(d=10, fams=None):
    """One coordinate of each of the ten kernel families (or of ``fams``),
    cycled over d coordinates; returns (target, a point near each
    coordinate's mean, a per-coordinate scale)."""
    from mcmc_jl_tpu_torch.ops.target_kernels import coordwise_logp

    fams = fams or _kernel_families()
    pick = [fams[j % len(fams)] for j in range(d)]
    return (coordwise_logp([f[0] for f in pick], d),
            np.array([f[1] for f in pick]), np.array([f[2] for f in pick]))


def _lp_close(a, b, d):
    """Per-chain log-targets agree: -inf at the same chains, the finite
    ones within T_LP_RTOL and an atol of T_LP_ATOL_PER_COORD per
    coordinate (a sum of d terms in another order)."""
    import torch

    fin_a, fin_b = torch.isfinite(a), torch.isfinite(b)
    if not torch.equal(fin_a, fin_b) or bool(
            (a[~fin_a] != b[~fin_b]).any()):
        return False
    return _close(a[fin_a], b[fin_b], T_LP_RTOL, T_LP_ATOL_PER_COORD * d)


def _traj_case(label, target, theta, m, eps, n_leaps=10,
               integrator="leapfrog", want_inf=False, outs=None,
               repeat=False, grad=None):
    """Kernel 5 (the public wrapper) against its plain version on the same
    inputs; ``grad`` at theta from the plain version unless given.  The
    kernel's outputs are appended to ``outs`` when given; with ``repeat`` a
    second launch must give the same bits.  Returns (ok, report)."""
    import torch

    from mcmc_jl_tpu_torch.ops import target_kernels as tk

    g = grad
    if g is None:
        g = tk.target_funcs(target)[1](theta)[1].contiguous()
    kw = dict(n_leaps=n_leaps, integrator=integrator)
    out_k = tk.fused_target_leapfrogs(target, theta, m, g, eps, **kw)
    if outs is not None:
        outs.append(out_k)
    out_r = tk.fused_target_leapfrogs_ref(target, theta, m, g, eps, **kw)
    bitwise = None
    if repeat:
        again = tk.fused_target_leapfrogs(target, theta, m, g, eps, **kw)
        bitwise = all(torch.equal(a, b) for a, b in zip(out_k, again))
    torch.cuda.synchronize()
    d = theta.shape[1]
    rep = {n: _err(a, b) for n, a, b in zip(("theta", "m", "g"), out_k[:3],
                                            out_r[:3])}
    fin = torch.isfinite(out_r[3])
    rep["lp"] = _err(out_k[3][fin], out_r[3][fin]) if bool(fin.any()) else {}
    rep["lp_neg_inf"] = int((~fin).sum())
    ok = (all(_close(a, b, T_RTOL, T_ATOL) for a, b in zip(out_k[:3],
                                                            out_r[:3]))
          and _lp_close(out_k[3], out_r[3], d)
          and (not want_inf or not bool(fin.any())) and bitwise is not False)
    if repeat:
        rep["bitwise_repeat"] = bitwise
    emit({"phase": "kernel", "name": _dense_name("target_leapfrogs", target),
          "case": label, "C": theta.shape[0], "d": d,
          "n_leaps": int(n_leaps),
          "integrator": integrator, **_lane_plan(
              _dense_name("target_leapfrogs", target), d, theta.shape[0]),
          "ok": ok, **rep})
    return ok, max([r["max_abs"] for r in rep.values()
                    if isinstance(r, dict) and r] or [0.0])


def _dense_name(name, target):
    """The name a kernel's launches on ``target`` count under: ``_dense``
    added for a dense target (target_kernels.dense_name; the name alone for
    a package without it)."""
    from mcmc_jl_tpu_torch.ops import target_kernels as tk

    fn = getattr(tk, "dense_name", None)
    return name if fn is None else fn(name, target)


def _same_path(k, out_k, out_r):
    """Per chain: the kernel's (theta, lp, accept rate) after ``k``
    transitions end where the plain version's do.  Accept counts, not
    rates: the plain version's n / k on the card multiplies by 1/k, which
    may differ from the kernel's n / k by an ulp."""
    import torch

    (th_k, lp_k, acc_k), (th_r, lp_r, acc_r) = out_k, out_r
    return ((torch.round(acc_k * k) == torch.round(acc_r * k))
            & ((th_k - th_r).abs() <= T_ATOL + T_RTOL * th_r.abs()).all(1)
            & (((lp_k - lp_r).abs() <= T_LP_ATOL_PER_COORD * th_r.shape[1]
                + T_LP_RTOL * lp_r.abs()) | (lp_k == lp_r)))


def _ratio(lp0, lp1):
    """The MH log-ratio lp1 - lp0 (or -H1 + H0), NaN (-inf - -inf) as
    -inf: a rejection, as both the kernels and the plain versions take
    it."""
    import torch

    r = lp1 - lp0
    return torch.where(torch.isnan(r), -torch.inf, r)


def _same_path_err(th_k, th_r, same):
    """max |theta difference| over the chains on the same path."""
    diff = (th_k - th_r).abs().amax(1)[same]
    return float(diff.max()) if diff.numel() else float("inf")


def _parted_report(kernel, label, same, gaps, err, bitwise=None, held=True,
                   **extra):
    """Emit one same-draws check and return whether it passed: every parted
    chain had a transition with |ratio - log u| < T_BAND, the bitwise
    repeat (None: not made) and the caller's other checks (``held``)
    held."""
    share = float(same.float().mean())
    ok = held and bitwise is not False and all(g < T_BAND for g in gaps)
    emit({"phase": "kernel", "name": kernel, "case": label,
          "chains_same_path": share, "parted_min_ratio_gaps": gaps[:20],
          "band": T_BAND, "theta_max_abs_diff_same": err,
          "bitwise_repeat": bitwise, **extra, "ok": ok})
    return ok


def _rwm_case(label, target, theta, scale, k, noise, i0=0):
    """Kernel 7 against its plain version on the same draws over ``k``
    steps.  ``noise`` is (z (C, k, d), logu (C, k)), read by both
    (noise="input"), or a seed: the kernel draws from Philox (noise="hw")
    from absolute step ``i0`` under the launch seed a generator seeded so
    gives, and the plain version gets those draws replayed
    (``rwm_draws``); the kernel then also repeats bitwise.  Every chain ends on
    the plain version's path, or had a step whose MH ratio (replayed by the
    plain version) lay within T_BAND of log u."""
    import torch

    from mcmc_jl_tpu_torch.ops import rwm_kernels as rk
    from mcmc_jl_tpu_torch.ops import target_kernels as tk

    mode = "input" if isinstance(noise, tuple) else "hw"

    def kernel(**kw):
        return rk.fused_target_rwm_steps(target, theta, scale, k_steps=k,
                                         noise=mode, i0=i0, **kw)

    if mode == "input":
        z, logu = noise
        outs = [kernel(z=z, logu=logu)]
    else:
        def gen():
            return torch.Generator(device="cuda").manual_seed(noise)

        outs = [kernel(generator=gen()) for _ in range(2)]
        z, logu = rk.rwm_draws(tk._seed(gen()), *theta.shape, k, i0=i0,
                               device="cuda")
    out_k = outs[0]
    out_r = rk.fused_target_rwm_steps_ref(target, theta, scale, k_steps=k,
                                          z=z, logu=logu)
    torch.cuda.synchronize()
    bitwise = (all(torch.equal(a, b) for a, b in zip(*outs))
               if len(outs) == 2 else None)
    same = _same_path(k, out_k, out_r)
    # replay the chains that parted: the smallest |ratio - log u| over steps
    gaps = []
    if not bool(same.all()):
        idx = (~same).nonzero()[:, 0]
        th, lp = theta[idx], target(theta[idx])[:, 0]
        gap = torch.full((len(idx),), float("inf"), device=theta.device)
        for s in range(k):
            prop = th + scale * z[idx, s]
            lp_p = target(prop)[:, 0]
            ratio = _ratio(lp, lp_p)
            gap = torch.minimum(gap, (ratio - logu[idx, s]).abs())
            a = (ratio > 0) | (ratio > logu[idx, s])
            th = torch.where(a[:, None], prop, th)
            lp = torch.where(a, lp_p, lp)
        gaps = gap.tolist()
    err = _same_path_err(out_k[0], out_r[0], same)
    ok = _parted_report("target_rwm_steps", label, same, gaps, err,
                        bitwise=bitwise, C=theta.shape[0], d=theta.shape[1],
                        k_steps=k, i0=i0, noise=mode,
                        **_lane_plan("target_rwm_steps", theta.shape[1],
                                     theta.shape[0]),
                        accept_rate=float(out_r[2].mean()))
    return ok, err


def _multistep_case(label, target, theta, eps, k, n_leaps, seed):
    """Kernel 6 against its plain version on the kernel's own Philox draws
    (the launch seed a generator seeded ``seed`` gives, replayed by
    ``target_multistep_draws``): at least PATH_AGREE of the chains end on
    the plain version's path (the same accept count, theta within MS_TOL),
    and every other chain had a transition whose MH ratio (replayed by the
    plain version) lay within T_BAND of log u.  The kernel's lp and
    gradient are the plain version's at the kernel's theta, and the kernel
    repeats bitwise."""
    import torch

    from mcmc_jl_tpu_torch.ops import target_kernels as tk

    def gen():
        return torch.Generator(device="cuda").manual_seed(seed)

    C, d = theta.shape
    out_k, out_k2 = (tk.target_multistep(target, theta, eps, k_trans=k,
                                         n_leaps=n_leaps, generator=gen())
                     for _ in range(2))
    z, logu = tk.target_multistep_draws(tk._seed(gen()), C, d, k,
                                        device="cuda")
    out_r = tk.target_multistep_ref(target, theta, eps, k_trans=k,
                                    n_leaps=n_leaps, noise=(z, logu))
    torch.cuda.synchronize()
    bitwise = all(torch.equal(a, b) for a, b in zip(out_k, out_k2))
    (th_k, g_k, lp_k, acc_k), (th_r, _, _, acc_r) = out_k, out_r
    same = ((torch.round(acc_k * k) == torch.round(acc_r * k))
            & ((th_k - th_r).abs() <= MS_TOL * (1 + th_r.abs())).all(1))
    lp_at, g_at = tk.target_funcs(target)[1](th_k)
    own = (_close(g_k, g_at, T_RTOL, T_ATOL)
           and _lp_close(lp_k, lp_at, d))
    gaps = []
    if not bool(same.all()):
        idx = (~same).nonzero()[:, 0]
        lp, g = tk.target_funcs(target)[1](theta[idx])
        th = theta[idx]
        gap = torch.full((len(idx),), float("inf"), device=theta.device)
        for t in range(k):
            m0, lu = z[t, idx], logu[t, idx]
            th_p, m, g_p, lp_p = tk.fused_target_leapfrogs_ref(
                target, th, m0, g, eps, n_leaps=n_leaps)
            h0 = -lp + 0.5 * (m0 * m0).sum(-1)
            ratio = _ratio(-lp_p + 0.5 * (m * m).sum(-1), h0)  # h0 - h1
            gap = torch.minimum(gap, (ratio - lu).abs())
            a = (ratio > 0) | (ratio > lu)
            th = torch.where(a[:, None], th_p, th)
            g = torch.where(a[:, None], g_p, g)
            lp = torch.where(a, lp_p, lp)
        gaps = gap.tolist()
    err = _same_path_err(th_k, th_r, same)
    agree = float(same.float().mean()) >= PATH_AGREE
    ok = _parted_report("target_multistep", label, same, gaps, err,
                        bitwise=bitwise, held=own and agree, C=C, d=d,
                        k_trans=k, n_leaps=n_leaps, lp_grad_at_own_theta=own,
                        path_agree=PATH_AGREE,
                        chains_off_path=int((~same).sum()),
                        accept_rate=float(acc_r.mean()),
                        **_lane_plan("target_multistep", d, C))
    return ok, err


def phase_target_kernels(C=4096, d=10, big_d=1000, k_ms=10, k_stat=50,
                         rwm_C=16_384, k_rwm=100, ragged=4099):
    """The custom-target kernels against their plain versions on the card,
    at their paths' shapes (d 10; kernels 5 and 6 at C chains, 10
    leapfrogs, kernel 6 with k_ms transitions per launch; kernel 7 at rwm_C
    chains, k_rwm steps per launch).

    Kernel 5 (trajectory): the gradient alone (eps 0) and a 10-leapfrog
    trajectory for each of the 17 bare-distribution configurations; a
    mixed target of all ten families with a (d,) step row, a leap count
    given as a tensor, and the 2- and 3-stage integrators; the gradient at
    Laplace's loc; a Gamma trajectory that leaves the support (lp -inf on
    both); d = 1000 (32 coordinates per lane); a bitwise repeat.  Kernel 7
    from the same input noise on Normal(1, 1) and the mixed target, and in
    Philox mode on its own draws replayed for the plain version; kernel 6
    likewise on its replayed draws in both layouts: Gamma(3, 0.2) at d 10,
    the mixed target with a (d,) step row at d 10 and 16 (one chain per
    lane) at C and ``ragged`` chains and at d 33 (one warp per chain).
    The gradient pass, sanitized as the model's gradient is, on the ten
    bare distributions (some chains out of a support, some at a NaN) and
    on the mixed target at d 1, 16, 32 and 33 (``ragged``
    chains) and d 1000.  Kernels 6 (k_stat
    transitions) and 7 in Philox mode against their plain versions drawing
    from a torch generator, from one start: |z| < Z_MAX on pooled final
    theta and on per-chain accept rates.  Returns {kernel: max abs
    error}."""
    import torch

    from mcmc_jl_tpu_torch.ops import rwm_kernels as rk
    from mcmc_jl_tpu_torch.ops import target_kernels as tk

    rng = np.random.default_rng(21)
    errors = {}
    bad = []

    def note(ok, label):
        if not ok:
            bad.append(label)

    main = {"Normal(1,1)": 0.8, "Gamma(3,0.2)": 0.05}
    err5 = 0.0
    for label, dist, x0, s in _target_cases():
        target = tk.coordwise_logp(dist, d)
        theta = _cuda(x0 + 0.1 * s * rng.standard_normal((C, d)))
        m = _cuda(rng.standard_normal((C, d)))
        ok, _ = _traj_case(f"{label} gradient (eps 0)", target, theta, m, 0.0,
                           n_leaps=1)
        note(ok, f"{label} gradient")
        eps = main.get(label, 0.05 * s)
        ok, e = _traj_case(f"{label} eps {eps:g}", target, theta, m, eps)
        note(ok, label)
        if label in main:
            err5 = max(err5, e)

    target, x0, s = _mixed_target(d)
    theta = _cuda(x0 + 0.05 * s * rng.standard_normal((C, d)))
    theta[: C // 2, 8] = 0.0  # Laplace(0, 1) exactly at loc
    m = _cuda(rng.standard_normal((C, d)))
    ok, _ = _traj_case("mixed gradient (eps 0), Laplace at loc", target,
                       theta, m, 0.0, n_leaps=1)
    note(ok, "mixed gradient")
    row = _cuda(0.02 * s)
    for integ in ("leapfrog", "2stage", "3stage"):
        ok, _ = _traj_case(f"mixed, (d,) eps row, n_leaps tensor, {integ}",
                           target, theta, m, row,
                           n_leaps=torch.tensor(7), integrator=integ)
        note(ok, f"mixed {integ}")

    gam = tk.coordwise_logp(_target_cases()[10][1], d)  # Gamma(3, 0.2)
    th_out = _cuda(0.05 + 0.01 * np.abs(rng.standard_normal((C, d))))
    m_out = _cuda(-4.0 - np.abs(rng.standard_normal((C, d))))
    ok, _ = _traj_case("Gamma(3,0.2) leaving the support", gam, th_out, m_out,
                       0.05, want_inf=True)
    note(ok, "Gamma leaving the support")

    big, xb, sb = _mixed_target(big_d)
    th_b = _cuda(xb + 0.05 * sb * rng.standard_normal((C, big_d)))
    m_b = _cuda(rng.standard_normal((C, big_d)))
    ok, _ = _traj_case(f"mixed d = {big_d}", big, th_b, m_b, _cuda(0.01 * sb))
    note(ok, f"mixed d={big_d}")
    del th_b, m_b

    # the gradient pass (the generic engine's evalallg on the card) on the
    # ten bare distributions, with chains out of a support, and at d 1000
    m10, bare = _ten_bare_model()
    th10, _ = _bare_start(bare, C, rng)
    th10[::8, 5] = -0.2  # Gamma(3, 0.2) out of its support: lp -inf
    th10[1::8, 0] = float("nan")  # lp NaN before the sanitizing: -inf
    errg = 0.0
    for label, tgt, th in (("ten bare distributions, one in eight chains "
                            "out of a support and one in eight at a NaN",
                            m10.target_spec, th10),
                           (f"mixed d = {big_d}", big, _cuda(
                               xb + 0.05 * sb
                               * rng.standard_normal((C, big_d))))):
        (lp_k, g_k), (lp_r, g_r) = (tk.target_logp_grad(tgt, th),
                                    tk.target_logp_grad_ref(tgt, th))
        torch.cuda.synchronize()
        ok = _close(g_k, g_r, T_RTOL, T_ATOL) and _lp_close(lp_k, lp_r,
                                                            th.shape[1])
        rep = {"g": _err(g_k, g_r), "lp_neg_inf": int((~torch.isfinite(
            lp_r)).sum())}
        emit({"phase": "kernel", "name": "target_logp_grad", "case": label,
              "C": C, "d": th.shape[1], "ok": ok, **rep})
        note(ok, f"target_logp_grad {label}")
        errg = max(errg, rep["g"]["max_abs"])
    for dd in (1, 16, 32, 33):  # both layouts, a ragged last group
        tgt, xg, sg = _mixed_target(dd)
        th = _cuda(xg + 0.05 * sg * rng.standard_normal((ragged, dd)))
        (lp_k, g_k), (lp_r, g_r) = (tk.target_logp_grad(tgt, th),
                                    tk.target_logp_grad_ref(tgt, th))
        torch.cuda.synchronize()
        ok = _close(g_k, g_r, T_RTOL, T_ATOL) and _lp_close(lp_k, lp_r, dd)
        emit({"phase": "kernel", "name": "target_logp_grad",
              "case": f"mixed d = {dd}", "C": ragged, "d": dd,
              "layout": tk.target_logp_grad_layout(dd), "ok": ok,
              "g": _err(g_k, g_r)})
        note(ok, f"target_logp_grad mixed d = {dd}")
        errg = max(errg, _err(g_k, g_r)["max_abs"])
    errors["target_logp_grad"] = errg

    # bitwise repeat of kernel 5 (no randomness: the same inputs)
    g_main = tk.target_funcs(gam)[1](theta.abs() + 0.3)[1].contiguous()
    r1, r2 = (tk.fused_target_leapfrogs(gam, theta.abs() + 0.3, m, g_main,
                                        0.05) for _ in range(2))
    note(all(torch.equal(a, b) for a, b in zip(r1, r2)), "kernel 5 repeat")
    errors["target_leapfrogs"] = err5

    # kernel 7 on the same draws: input noise, then its own Philox draws
    normal = tk.coordwise_logp(_target_cases()[0][1], d)
    scale = _cuda(np.full(d, 1.1))
    err7 = 0.0
    for label, tgt, th0, sc, noise in (
            ("Normal(1,1), scale 1.1", normal,
             _cuda(0.1 * rng.standard_normal((rwm_C, d))), scale, None),
            ("mixed, per-coordinate scale", target,
             _cuda(x0 + 0.05 * s * rng.standard_normal((rwm_C, d))),
             _cuda(0.5 * s), None),
            ("Normal(1,1), scale 1.1, Philox draws replayed", normal,
             _cuda(0.1 * rng.standard_normal((rwm_C, d))), scale, 33)):
        if noise is None:
            noise = (_cuda(rng.standard_normal((rwm_C, k_rwm, d))),
                     _cuda(np.log1p(-rng.random((rwm_C, k_rwm)))))
        ok, e = _rwm_case(label, tgt, th0, sc, k_rwm, noise)
        note(ok, f"rwm {label}")
        err7 = max(err7, e)
    errors["target_rwm_steps"] = err7

    # kernel 6 on its own Philox draws, in both layouts
    th0 = _cuda(0.6 + 0.05 * rng.standard_normal((C, d)))
    ok, errors["target_multistep"] = _multistep_case(
        "Gamma(3,0.2), eps 0.05, Philox draws replayed", gam, th0, 0.05,
        k_ms, 10, 32)
    note(ok, "target_multistep replayed")
    for dd, Cx in ((10, ragged), (16, C), (16, ragged), (33, C)):
        tgt, xm, sm = _mixed_target(dd)
        thm = _cuda(xm + 0.05 * sm * rng.standard_normal((Cx, dd)))
        ok, e = _multistep_case(
            f"mixed d = {dd}, (d,) row 0.05 s, Philox draws replayed", tgt,
            thm, _cuda(0.05 * sm), k_ms, 10, 37)
        note(ok, f"target_multistep mixed d = {dd}, C {Cx}")
        errors["target_multistep"] = max(errors["target_multistep"], e)
        del thm

    # kernels 6 and 7 with Philox draws against their plain versions drawing
    # from the torch generator: statistical agreement from one start
    th_rw = _cuda(0.1 * rng.standard_normal((rwm_C, d)))
    for name, k, kern, plain, acc in (
            ("target_multistep", k_stat,
             lambda g: tk.target_multistep(gam, th0, 0.05, k_trans=k_stat,
                                           n_leaps=10, generator=g),
             lambda g: tk.target_multistep_ref(gam, th0, 0.05,
                                               k_trans=k_stat, n_leaps=10,
                                               generator=g), 3),
            ("target_rwm_steps", k_rwm,
             lambda g: rk.fused_target_rwm_steps(
                 normal, th_rw, scale, k_steps=k_rwm, noise="hw",
                 generator=g),
             lambda g: rk.fused_target_rwm_steps_ref(
                 normal, th_rw, scale, k_steps=k_rwm, generator=g), 2)):
        res_k = kern(torch.Generator(device="cuda").manual_seed(34))
        res_r = plain(torch.Generator(device="cuda").manual_seed(35))
        z_th = _z_t(res_k[0], res_r[0])
        z_acc = _z_t(res_k[acc][:, None], res_r[acc][:, None])
        ok = z_th < Z_MAX and z_acc < Z_MAX
        emit({"phase": "kernel", "name": name, "case": "statistical",
              "C": res_k[0].shape[0], "k": k, "ok": ok,
              "accept_kernel": float(res_k[acc].mean()),
              "accept_plain": float(res_r[acc].mean()), "z_accept": z_acc,
              "z_theta_max": z_th})
        note(ok, f"{name} statistical")
    assert not bad, f"custom-target kernels disagree: {bad}"
    return errors


def phase_target_lane_kernels(C=4096, big_C=65_536, ragged=4099, k_rwm=20):
    """Kernels 5 and 7 in every layout they launch against their plain
    versions on the card: the ten-family mixed target with a (d,) step row
    at d = 1, 10, 16 and 32 (one chain per lane, template bounds 8, 16, 32)
    and 33 and 1000 (one warp per chain); a ragged last group (C =
    ``ragged``); every kernel family alone (d 10); the 2- and 3-stage
    integrators and a Gamma trajectory that leaves the support.  At d <= 32
    kernel 5 runs at C chains (D warps a block: no more groups than SMs)
    and on the same chains tiled to ``big_C`` (four warps a block), and its
    theta, m and g must come out bitwise the same in both.  Kernel 7 from
    input noise over ``k_rwm`` steps, and on its own Philox draws replayed
    from an absolute step that is not a multiple of four (the draws come
    four steps a Philox call), at ``ragged`` chains.  Returns {kernel: max
    abs error}."""
    import torch

    from mcmc_jl_tpu_torch.ops import target_kernels as tk

    rng = np.random.default_rng(22)
    err5 = err7 = 0.0
    bad = []

    def note(ok, label):
        if not ok:
            bad.append(label)

    def traj(label, target, th, m, eps, **kw):
        """At th's chains and, for d <= 32, tiled to big_C chains: another
        W, the same theta, m and g."""
        nonlocal err5
        Cs, d = th.shape
        reps = -(-big_C // Cs) if d <= 32 else 0
        outs = []
        for r in (1, reps)[:1 + (reps > 0)]:
            ok, e = _traj_case(f"{label}, C {r * Cs}", target,
                               th.repeat(r, 1), m.repeat(r, 1), eps,
                               outs=outs, **kw)
            note(ok, f"kernel 5 {label}, C {r * Cs}")
            err5 = max(err5, e)
        if reps:
            ws = [tk.target_leapfrogs_plan(d, r * Cs)["warps"]
                  for r in (1, reps)]
            same = all(torch.equal(a[:Cs], b)
                       for a, b in zip(outs[1][:3], outs[0][:3]))
            ok = same and ws[0] != ws[1]
            emit({"phase": "kernel", "name": "target_leapfrogs",
                  "case": f"{label}: theta, m, g bitwise at C {Cs} and "
                          f"{reps * Cs}", "warps": ws, "bitwise": same,
                  "ok": ok})
            note(ok, f"kernel 5 {label}: W {ws} bitwise")

    def rwm(label, target, th, scale, noise, k=k_rwm, i0=0):
        nonlocal err7
        ok, e = _rwm_case(label, target, th, scale, k, noise, i0=i0)
        note(ok, f"kernel 7 {label}")
        err7 = max(err7, e)

    def noise(Cn, dd):
        return (_cuda(rng.standard_normal((Cn, k_rwm, dd))),
                _cuda(np.log1p(-rng.random((Cn, k_rwm)))))

    for dd in (1, 10, 16, 32, 33, 1000):
        mixed, x0, sc = _mixed_target(dd)
        th = _cuda(x0 + 0.05 * sc * rng.standard_normal((C, dd)))
        m = _cuda(rng.standard_normal((C, dd)))
        traj(f"mixed ten families, d = {dd}, (d,) row 0.02 s", mixed, th, m,
             _cuda(0.02 * sc))
        thr = _cuda(x0 + 0.05 * sc * rng.standard_normal((ragged, dd)))
        rwm(f"mixed ten families, d = {dd}, scale 0.5 s, input noise", mixed,
            thr, _cuda(0.5 * sc), noise(ragged, dd))
        del th, m, thr

    mixed, x0, sc = _mixed_target(10)
    row = _cuda(0.02 * sc)
    th = _cuda(x0 + 0.05 * sc * rng.standard_normal((ragged, 10)))
    m = _cuda(rng.standard_normal((ragged, 10)))
    traj(f"mixed ten families, C {ragged}", mixed, th, m, row)
    for integ in ("2stage", "3stage"):
        traj(f"mixed ten families, (d,) row, {integ}", mixed, th, m, row,
             n_leaps=7, integrator=integ)
    rwm("mixed ten families, Philox draws replayed from step 3", mixed, th,
        _cuda(0.5 * sc), 36, k=k_rwm + 1, i0=3)

    gam = tk.coordwise_logp(_target_cases()[10][1], 10)  # Gamma(3, 0.2)
    th_out = _cuda(0.05 + 0.01 * np.abs(rng.standard_normal((C, 10))))
    m_out = _cuda(-4.0 - np.abs(rng.standard_normal((C, 10))))
    traj("Gamma(3,0.2) leaving the support", gam, th_out, m_out, 0.05,
         want_inf=True)

    for fam in _kernel_families():
        alone, x0, sc = _mixed_target(10, [fam])
        th = _cuda(x0 + 0.05 * sc * rng.standard_normal((C, 10)))
        m = _cuda(rng.standard_normal((C, 10)))
        traj(f"{fam[0]!r} alone, d = 10, (d,) row 0.05 s", alone, th, m,
             _cuda(0.05 * sc))
        rwm(f"{fam[0]!r} alone, d = 10, scale 0.5 s, input noise", alone, th,
            _cuda(0.5 * sc), noise(C, 10))
    assert not bad, f"kernels 5 and 7 disagree in the lane phase: {bad}"
    return {"target_leapfrogs": err5, "target_rwm_steps": err7}


def _z_exact(a, want):
    """max over columns of |mean - want| / se, with ``a`` one row per
    independent chain (numpy)."""
    se = a.std(0) / np.sqrt(len(a))
    return float(np.max(np.abs(a.mean(0) - want) / se))


def _moments_z(rows, dist):
    """|z| of the per-chain first and second moments (one row per chain)
    against the distribution's exact ones."""
    mu, sd = float(dist.mean()), float(dist.std())
    return max(_z_exact(rows[0], mu), _z_exact(rows[1], mu * mu + sd * sd))


def phase_target_paths(chains=4096, generic_chains=512, rwm_chains=16_384):
    """The custom-target paths at their full sizes (d = 10, float32), each
    with every count zeroed just before it and read just after, no plain
    call, and held against the exact moments of the target:

    - ``run(model(ex, x=np.full(10, x0 + 0.5), gradient=True) * HMC(10, eps)
      * SerialMC(300, 100), chains=4096)`` on ``tilde(x, D)`` for
      Gamma(3, 0.2), Normal(1, 1), Laplace(0, 1) at eps 0.05, 0.8, 0.5
      (benchmarks/benchunits/fused_target.py:46-49): 300 launches of the
      trajectory kernel each; and plain ``MALA(0.02) * SerialMC(1000, 300)``
      on the Gamma model (one leapfrog at eps sqrt(0.02)): 1000 launches;
      each also held against 512 generic-engine chains;
    - ``run_target_hmc_multistep`` on ``coordwise_logp(Gamma(3, 0.2), 10)``,
      4096 chains, 300 transitions, thin 10, eps 0.05 (from 1.1, as
      fused_target.py starts): 30 launches;
    - ``run_target_rwm`` on ``coordwise_logp(Normal(1, 1), 10)``, 16,384
      chains, 10,000 steps, scale 1.1, thin 100 (fused_target.py:93-103):
      100 launches.
    Returns {kernel: (launches, origin)}."""
    import mcmc_jl_tpu_torch as mt
    from mcmc_jl_tpu_torch.ops import rwm_kernels as rk
    from mcmc_jl_tpu_torch.ops import target_kernels as tk

    counts = {}
    gamma = None
    runs = [("Gamma(3,0.2)", mt.Gamma(3.0, 0.2), 0.6, mt.HMC(10, 0.05),
             300, 100),
            ("Normal(1,1)", mt.Normal(1.0, 1.0), 1.0, mt.HMC(10, 0.8),
             300, 100),
            ("Laplace(0,1)", mt.Laplace(0.0, 1.0), 0.0, mt.HMC(10, 0.5),
             300, 100),
            ("Gamma(3,0.2)", mt.Gamma(3.0, 0.2), 0.6, mt.MALA(0.02),
             1000, 300)]
    for name, dist, x0, sampler, steps, burnin in runs:
        m = mt.model(lambda x, _d=dist: mt.tilde(x, _d),
                     x=np.full(10, x0 + 0.5), gradient=True, device="cuda")
        assert m.target_spec is not None, name
        task = m * sampler * mt.SerialMC(steps=steps, burnin=burnin)
        origin = (f"run(model(x ~ {name}, x=fill({x0 + 0.5:g}, 10)) * "
                  f"{sampler!r} * SerialMC({steps}, {burnin}), "
                  f"chains={chains})")
        # the final states' lp and gradient: one gradient pass
        cs, samples, launches, dt, spans = _path(
            origin, task, chains, {"target_leapfrogs": steps,
                                   "target_logp_grad": 1})
        acc = float(np.mean([mt.acceptance(c) for c in cs])) / 100
        del cs
        z_ex = _moments_z((samples.mean(1), (samples ** 2).mean(1)), dist)
        cg = mt.run(task, chains=generic_chains, seed=1, fused=False)
        gs = np.stack([c.samples.values for c in cg])
        z_gen = max(_z_means(samples.mean(1), gs.mean(1)),
                    _z_means((samples ** 2).mean(1), (gs ** 2).mean(1)))
        ok = z_ex < Z_MAX and z_gen < Z_MAX
        emit({"phase": "target_path", "kernel": "target_leapfrogs",
              "layout": tk.target_leapfrogs_layout(10),
              "from": origin, "chains": chains, "seconds": dt,
              "spans_s": spans, "launches": launches["target_leapfrogs"],
              "accept_rate": acc, "pooled_mean": float(samples.mean()),
              "exact_mean": float(dist.mean()),
              "pooled_sd": float(samples.std()),
              "exact_sd": float(dist.std()), "z_max_vs_exact": z_ex,
              "z_max_vs_generic": z_gen, "ok": ok, **CARD})
        assert ok, f"{origin} disagrees with the exact moments or the " \
                   f"generic engine"
        counts.setdefault("target_leapfrogs",
                          (launches["target_leapfrogs"], origin))
        if name == "Gamma(3,0.2)":
            gamma = dist

    for kernel, origin, want, fn, dist in (
            ("target_multistep",
             "run_target_hmc_multistep(coordwise_logp(Gamma(3, 0.2), 10), "
             f"10, {chains}, 300, thin=10, n_leaps=10, eps=0.05)", 30,
             lambda: tk.run_target_hmc_multistep(
                 tk.coordwise_logp(gamma, 10), 10, chains, 300, thin=10,
                 n_leaps=10, eps=0.05, seed=3,
                 inits=np.full((chains, 10), 1.1, np.float32),
                 device="cuda"), gamma),
            ("target_rwm_steps",
             "run_target_rwm(coordwise_logp(Normal(1, 1), 10), 10, "
             f"{rwm_chains}, 10000, scale=1.1, thin=100)", 100,
             lambda: rk.run_target_rwm(
                 tk.coordwise_logp(mt.Normal(1.0, 1.0), 10), 10, rwm_chains,
                 10_000, scale=1.1, thin=100, seed=4, device="cuda"),
             mt.Normal(1.0, 1.0))):
        t0 = time.perf_counter()
        (theta, infos), launches = _counted(fn)
        dt = time.perf_counter() - t0
        assert launches == {**{k: 0 for k in launches}, kernel: want}, \
            launches
        th = theta.double().cpu().numpy()
        assert np.all(np.isfinite(th))
        z_ex = _moments_z((th, th ** 2), dist)
        ok = z_ex < Z_MAX
        emit({"phase": "target_path", "kernel": kernel, "from": origin,
              "layout": rk.target_rwm_layout(10)
              if kernel == "target_rwm_steps"
              else tk.target_multistep_layout(10),
              "seconds": dt, "launches": launches[kernel],
              "accept_rate": float(infos["accept_rate"].mean()),
              "pooled_mean": float(th.mean()),
              "exact_mean": float(dist.mean()), "pooled_sd": float(th.std()),
              "exact_sd": float(dist.std()), "z_max_vs_exact": z_ex,
              "ok": ok, **CARD})
        assert ok, f"{origin} disagrees with the exact moments"
        counts[kernel] = (launches[kernel], origin)
    return counts


def phase_target_times(C=4096, d=10, n_leaps=10, k_trans=10,
                       rwm_chains=16_384, k_rwm=100):
    """Per-launch time of the custom-target kernels beside their plain
    versions and their bounds, at the paths' shapes: kernel 5 on
    Gamma(3, 0.2) (C 4096, d 10, 10 leapfrogs, eps 0.05), kernel 6 with
    k = 10 transitions, kernel 7 in Philox mode on Normal(1, 1) (C 16,384,
    k = 100).  ``ms`` is one call between CUDA events, as for the other
    kernels; ``device_ms`` the kernel alone (:func:`_device_ms`).
    Returns ({kernel: (ms, plain ms)}, {kernel: bound and device_ms})."""
    import torch

    import mcmc_jl_tpu_torch as mt
    from mcmc_jl_tpu_torch.ops import rwm_kernels as rk
    from mcmc_jl_tpu_torch.ops import target_kernels as tk

    rng = np.random.default_rng(41)
    gam = tk.coordwise_logp(mt.Gamma(3.0, 0.2), d)
    th = _cuda(0.6 + 0.1 * rng.standard_normal((C, d)))
    m0 = _cuda(rng.standard_normal((C, d)))
    g = tk.target_funcs(gam)[1](th)[1].contiguous()
    rows = gam.rows(th.device)
    gens = [torch.Generator(device="cuda").manual_seed(s) for s in (1, 2)]
    thr = _cuda(0.1 * rng.standard_normal((rwm_chains, d)))
    scale = _cuda(np.full(d, 1.1))
    normal = tk.coordwise_logp(mt.Normal(1.0, 1.0), d)
    leap = TARGET_LEAP_OPS * d
    calls = {
        "target_leapfrogs": (
            lambda: tk.fused_target_leapfrogs(gam, th, m0, g, 0.05,
                                              n_leaps=n_leaps),
            lambda: tk.fused_target_leapfrogs_ref(gam, th, m0, g, 0.05,
                                                  n_leaps=n_leaps),
            (th, m0, g, rows), C * n_leaps * leap),
        "target_multistep": (
            lambda: tk.target_multistep(gam, th, 0.05, k_trans=k_trans,
                                        n_leaps=n_leaps, generator=gens[0]),
            lambda: tk.target_multistep_ref(gam, th, 0.05, k_trans=k_trans,
                                            n_leaps=n_leaps,
                                            generator=gens[1]),
            (th, rows), C * (1 + k_trans * n_leaps) * leap),
        "target_logp_grad": (
            lambda: tk.target_logp_grad(gam, th),
            lambda: tk.target_logp_grad_ref(gam, th),
            (th, rows), C * TARGET_EVAL_OPS * d),
        "target_rwm_steps": (
            lambda: rk.fused_target_rwm_steps(normal, thr, scale,
                                              k_steps=k_rwm, noise="hw",
                                              generator=gens[0]),
            lambda: rk.fused_target_rwm_steps_ref(normal, thr, scale,
                                                  k_steps=k_rwm,
                                                  generator=gens[1]),
            (thr, scale, normal.rows(thr.device)),
            rwm_chains * (1 + k_rwm) * TARGET_STEP_OPS * d),
    }
    # the floors of kernels 5 and 7 (floor_ms: the larger of the two)
    refills = -(-k_rwm // 4)
    floors = {
        "target_leapfrogs": {"sfu_floor_ms": _sfu_floor_ms(
            C * d, LEAP_SFU_COORD * n_leaps + LP_SFU_COORD)},
        "target_rwm_steps": {
            "rng_floor_ms": _rng_floor_ms(rwm_chains * refills * (d + 1)),
            "sfu_floor_ms": _sfu_floor_ms(
                rwm_chains * k_rwm, RWM_SFU_COORD * d + RWM_SFU_CHAIN)}}
    for f in floors.values():
        f["floor_ms"] = max(f.values())
    ms, work = {}, {}
    for name, (kern, plain, inputs, ops) in calls.items():
        work[name] = {**_bound_ops(ops, _nbytes(inputs, kern())),
                      "device_ms": _device_ms(kern, KERNEL_SYMBOL[name]),
                      **floors.get(name, {})}
        ms[name] = (_event_ms(kern), _event_ms(plain, reps=2))
        extra = {}
        if name == "target_leapfrogs":
            extra = _lean_times(gam, th, m0, g, 0.05, n_leaps,
                                work[name]["device_ms"])
            extra["host_ms"] = (None if work[name]["device_ms"] is None
                                else ms[name][0] - work[name]["device_ms"])
        emit({"phase": "kernel_time", "name": name,
              "C": rwm_chains if name == "target_rwm_steps" else C, "d": d,
              "k": {"target_leapfrogs": 1, "target_multistep": k_trans,
                    "target_rwm_steps": k_rwm, "target_logp_grad": 1}[name],
              "ms": ms[name][0], "plain_ms": ms[name][1], **work[name],
              **extra, "plan": _lane_plan(
                  name, d, rwm_chains if name == "target_rwm_steps" else C),
              **CARD})
    return ms, work


def _lane_plan(name, d, C):
    """Kernel 5's (and its dense instantiation's), 6's or 7's launch plan
    at (d, C), or {} for another kernel or a package without one (before
    the lane layout)."""
    from mcmc_jl_tpu_torch.ops import rwm_kernels as rk
    from mcmc_jl_tpu_torch.ops import target_kernels as tk

    fn = {"target_leapfrogs": getattr(tk, "target_leapfrogs_plan", None),
          "target_leapfrogs_dense": lambda d, C: tk.target_leapfrogs_plan(
              d, C, dense=True),
          "target_multistep": getattr(tk, "target_multistep_plan", None),
          "target_rwm_steps": getattr(rk, "target_rwm_plan", None)}.get(name)
    return {} if fn is None else fn(d, C)


def _lean_times(target, th, m0, g, eps, n_leaps, device_ms):
    """Kernel 5 through ``leapfrogs_launcher`` as the drivers call it: one
    call between CUDA events (``lean_ms``) and its host time beside the
    kernel's ``device_ms``; empty for a package without the launcher."""
    from mcmc_jl_tpu_torch.ops import target_kernels as tk

    if not hasattr(tk, "leapfrogs_launcher"):
        return {}
    step = tk.leapfrogs_launcher(target, th, eps)
    lean = _event_ms(lambda: step(th, m0, g, n_leaps))
    return {"lean_ms": lean, "lean_host_ms": None if device_ms is None
            else lean - device_ms}


def _ten_bare():
    """The warm target paths' model: ten of the reference's
    bare-distribution configurations (benchmarks/benchunits/bare_distribs.py
    :41-61), one named parameter each, with their starting points: finite
    fourth moments, standard deviations from 0.2 to 12."""
    cases = {label: (dist, x0) for label, dist, x0, _ in _target_cases()}
    return [(n, *cases[n]) for n in (
        "Normal(3,12)", "Normal(1,1)", "Weibull(3,1)", "Uniform(0,2)",
        "Beta(3,2)", "Gamma(3,0.2)", "Gamma(1,2)", "Exponential(0.2)",
        "LogNormal(2,0.1)", "Weibull(1,1)")]


def _ten_bare_model(device="cuda"):
    """``model(ex, p0=x0, ..., p9=x9, gradient=True)`` with ``ex`` drawing
    each named parameter from its distribution by ``~``; its target_spec is
    the catalog target the kernels take.  Returns (model, _ten_bare())."""
    import mcmc_jl_tpu_torch as mt

    bare = _ten_bare()
    keys = [f"p{j}" for j in range(len(bare))]

    def ex(**p):
        for k, (_, dist, _) in zip(keys, bare):
            mt.tilde(p[k], dist)

    m = mt.model(ex, gradient=True, device=device,
                 **{k: x0 for k, (_, _, x0) in zip(keys, bare)})
    assert m.target_spec is not None and m.target_spec.has_rows
    return m, bare


def _bare_start(bare, C, rng, spread=0.1):
    """C chains at each coordinate's start plus ``spread`` of its sd times
    N(0, 1), all inside the supports; and the sds."""
    x0 = np.array([x for _, _, x in bare])
    sd = np.array([float(dist.std()) for _, dist, _ in bare])
    return _cuda(x0 + spread * sd * rng.standard_normal((C, len(bare)))), sd


def _target_nuts_case(label, target, theta, eps, seed, md=6,
                      multinomial=False, full_depth=False, want_div=False):
    """Kernel 8b against its plain version on the same inputs and pre-drawn
    noise (lp and gradient at theta from the plain evaluation): at least
    PATH_AGREE of the chains on the same path (equal ndoublings and
    diverging, the chosen theta within NUTS_T_TOL (1 + |theta|)), and on
    those the gradient and lp within the same relative tolerance (-inf at
    the same chains).  ``full_depth``: some chain builds all md doublings;
    ``want_div``: some chain diverges.  Returns (ok, theta's max abs error
    on the same-path chains)."""
    import torch

    from mcmc_jl_tpu_torch.ops import nuts_kernels as nk
    from mcmc_jl_tpu_torch.ops import target_kernels as tk

    C, d = theta.shape
    rng = np.random.default_rng(seed)
    lp, g = tk.target_funcs(target)[1](theta)
    noise = tuple(_cuda(a) for a in (
        rng.standard_normal((C, d)), np.log(rng.random(C)),
        np.where(rng.random((C, md)) < 0.5, 1.0, -1.0), rng.random((C, md)),
        rng.random((C, 1 << md))))
    args = (target, theta, lp.contiguous(), g.contiguous(), eps, *noise)
    kw = dict(maxdoublings=md, multinomial=multinomial)
    out_k = nk.target_nuts_transition(*args, **kw)
    out_r = nk.target_nuts_transition_ref(*args, **kw)
    out_k2 = nk.target_nuts_transition(*args, **kw)
    torch.cuda.synchronize()
    bitwise = all(torch.equal(a, b) for a, b in zip(out_k, out_k2))
    (thk, gk_, lpk, ndk, dvk), (thr, gr, lpr, ndr, dvr) = out_k, out_r

    def near(a, b):
        return (a - b).abs() <= NUTS_T_TOL * (1 + b.abs())

    same = (ndk == ndr) & (dvk == dvr) & near(thk, thr).all(1)
    fin = torch.isfinite(lpr)
    lp_ok = torch.where(fin, near(lpk, lpr), lpk == lpr)
    rep = {n: _err(a[same], b[same]) for n, a, b in
           zip(("theta", "g"), (thk, gk_), (thr, gr))}
    sf = same & fin
    rep["lp"] = _err(lpk[sf], lpr[sf]) if bool(sf.any()) else {}
    share = float(same.float().mean())
    ok = (share >= PATH_AGREE and bitwise
          and bool(near(gk_[same], gr[same]).all())
          and bool(lp_ok[same].all())
          and (not full_depth or int(ndr.max()) == md)
          and (not want_div or int(dvr.sum()) > 0))
    emit({"phase": "kernel",
          "name": _dense_name("target_nuts_transition", target),
          "case": label, "C": C, "d": d, "layout": nk.target_nuts_layout(d),
          "maxdoublings": md, "ok": ok,
          "chains_same_path": share, "path_differ": int(C - same.sum()),
          "bitwise_repeat": bitwise,
          "mean_ndoublings": float(ndr.float().mean()),
          "chains_at_maxdoublings": int((ndr == md).sum()),
          "diverging": int(dvr.sum()), "lp_neg_inf": int((~fin).sum()),
          **rep})
    return ok, rep["theta"]["max_abs"]


def phase_target_nuts_kernels(C=4096, md=6, big_d=1000):
    """Kernel 8b (target_nuts_transition) against its plain version on the
    card, at its path's shape (C chains, d = 10, maxdoublings md) on the
    ten bare distributions: slice and multinomial, a scalar step and a (d,)
    row (0.3 of each sd), a deep case (eps 0.01: trees of all md
    doublings), md 1 and md 10 (the deep case again: trees up to 1023
    leaves), C + 3 chains (a ragged last group of the lane layout), 65536
    chains (its timing shape), an
    out-of-support start (one chain in eight with Gamma(3, 0.2) at -0.2:
    lp -inf, divergences); every kernel family alone (d 10, slice, a (d,)
    row 0.1 s); then the ten-family mixed target with a row at d = 1, 10,
    16 and 32 (one chain per lane, template bounds 8, 16, 32) and 33 and
    big_d (one warp per chain, 4 and 32 coordinates per lane), slice and
    multinomial.  Returns {kernel: max abs theta error on the same-path
    chains}."""
    import torch

    m, bare = _ten_bare_model()
    target = m.target_spec
    rng = np.random.default_rng(51)
    theta, sd = _bare_start(bare, C, rng)
    row = _cuda(0.3 * sd)
    cases = [
        ("ten bare distributions, slice, eps 0.1", theta, 0.1, False, {}),
        ("ten bare distributions, multinomial, eps 0.1", theta, 0.1, True,
         {}),
        ("ten bare distributions, slice, (d,) row 0.3 sd", theta, row, False,
         {}),
        ("ten bare distributions, multinomial, (d,) row 0.3 sd", theta, row,
         True, {}),
        ("ten bare distributions, slice, eps 0.01 (deep)", theta, 0.01, False,
         {"full_depth": True}),
    ]
    out_theta = theta.clone()
    out_theta[::8, 5] = -0.2  # Gamma(3, 0.2) out of its support
    cases.append(("ten bare distributions, out-of-support start, eps 0.1",
                  out_theta, 0.1, False, {"want_div": True}))
    cases.append((f"ten bare distributions, C {C + 3}, eps 0.1",
                  torch.cat([theta, theta[:3]]), 0.1, False, {}))
    cases.append(("ten bare distributions, C 65536, multinomial, eps 0.1",
                  torch.cat([theta] * 16), 0.1, True, {}))
    err, bad = 0.0, []
    for seed, (label, th, eps, multi, extra) in enumerate(cases):
        ok, e = _target_nuts_case(label, target, th, eps, 60 + seed, md=md,
                                  multinomial=multi, **extra)
        err = max(err, e)
        if not ok:
            bad.append(label)
    for mdx, eps in ((1, 0.1), (10, 0.01)):
        label = f"ten bare distributions, slice, md {mdx}, eps {eps}"
        ok, e = _target_nuts_case(label, target, theta, eps, 90 + mdx,
                                  md=mdx)
        err = max(err, e)
        if not ok:
            bad.append(label)
    for i, fam in enumerate(_kernel_families()):
        alone, x0, s = _mixed_target(10, [fam])
        th = _cuda(x0 + 0.05 * s * rng.standard_normal((C, 10)))
        label = f"{fam[0]!r} alone, d = 10, (d,) row 0.1 s, slice"
        ok, e = _target_nuts_case(label, alone, th, _cuda(0.1 * s), 100 + i,
                                  md=md)
        err = max(err, e)
        if not ok:
            bad.append(label)
    for dd, seed in ((1, 72), (10, 70), (16, 73), (32, 74), (33, 75),
                     (big_d, 71)):
        mixed, x0, s = _mixed_target(dd)
        th = _cuda(x0 + 0.05 * s * rng.standard_normal((C, dd)))
        for multi in (False, True):
            label = (f"mixed ten families, d = {dd}, (d,) row 0.1 s, "
                     f"{'multinomial' if multi else 'slice'}")
            ok, e = _target_nuts_case(label, mixed, th, _cuda(0.1 * s),
                                      seed + 10 * multi, md=md,
                                      multinomial=multi)
            err = max(err, e)
            if not ok:
                bad.append(label)
        del th
    assert not bad, f"target_nuts_transition disagrees: {bad}"
    return {"target_nuts_transition": err}


def _bare_z(samples, bare, cols=None):
    """max over coordinates ``cols`` (all by default) of |z| of the per-chain
    first and second moments (samples (chains, kept, d)) against the exact
    ones."""
    cols = slice(None) if cols is None else cols
    mu = np.array([float(dist.mean()) for _, dist, _ in bare])[cols]
    sd = np.array([float(dist.std()) for _, dist, _ in bare])[cols]
    x = samples[..., cols]
    return max(_z_exact(x.mean(1), mu),
               _z_exact((x ** 2).mean(1), mu * mu + sd * sd))


def phase_warm_target_paths(chains=4096, chains_small=1024):
    """The adaptive samplers on a catalog target through ``run(...,
    chains=C)``, float32, on the ten bare distributions (d = 10), each with
    every count zeroed just before it and read just after, no plain call,
    and held against the target's exact first and second moments:

    - ``NUTS(maxdoublings=6) * SerialMC(1100, 100)`` and ``NUTS(6,
      mass_adapt="diag") * SerialMC(1500, 500)`` at 4096 chains
      (benchmarks/benchunits/nuts_fused.py:52-60's sampler and runner, the
      unit-metric run's burn-in cut to 200, then 100, for the script's
      time; the diagonal run's burn-in cut to 250 froze eps 0.119, not
      0.161, and missed the exact moments by |z| 5.75 on an H100;
      the diagonal metric needs its 500: at 300 it missed the exact
      moments at z 6.3): 1000 launches of kernel 8b each;
    - ``HMC(10, 0.02, EmpMCTuner(0.8, adapt_step=50), mass_adapt="diag") *
      SerialMC(3500, 500)`` at 4096 chains (examples/warmstart_logistic.py
      :38's sampler): 3000 launches of kernel 5 with the (d,) step row (the
      sampling phase twice the reference's 1500: the step freezes near
      0.001 and the chains mix slowly, in the JAX package as well,
      tests/test_torch_warm_target.py);
    - ``MALA(0.002, EmpMCTuner(0.574, adapt_step=50)) * SerialMC(1000,
      200)`` at 1024 chains, as the GLM warm path runs: 800 launches of
      kernel 5;
    - ``ChEESHMC(len0=0.5, max_leaps=64) * SerialMC(1000, 200)``
      (benchmarks/benchunits/warmfused.py:223) at 4096 chains: 800
      launches of kernel 5.

    ``HMCDA()`` takes the same arm as MALA but is not driven here: on this
    model its dual averaging drives the step toward 0.001 (the supports'
    edges end trajectories) and its leap count ``round(2 / eps)`` has no
    cap, so its generic warmup ran past 1000 s on one H100; it runs on the
    GLM warm path and in the CPU tests.
    The paths that adapt a diagonal metric are held on all ten
    coordinates.  Without a metric (unit-metric NUTS, MALA, and ChEES,
    whose JAX original never updates its mass accumulator) the step
    is set by the narrowest coordinates and the edges of the supports, and
    the chains do not cross Normal(3, 12) or Gamma(1, 2)'s tail in the
    run: those paths are held on the coordinates with sd at most NARROW_SD
    (six of ten); the z over all ten is reported for every path.
    The generic warmups evaluate the model's gradient through
    ``target_logp_grad``, once per leaf; each path reports those launches,
    and one call of the model's gradient at C chains is timed after the
    runs (host ms a call, :func:`_grad_time`).
    Returns ({kernel 8b and the gradient pass: (launches, origin)}, the
    unit-metric NUTS run's final positions and frozen step, where its
    timing starts, and {"nuts": that run's tasks, "hmc_diag": the adaptive
    HMC-diag run's} for phase_resume_paths)."""
    import torch

    import mcmc_jl_tpu_torch as mt
    from mcmc_jl_tpu_torch.ops import nuts_kernels as nk
    from mcmc_jl_tpu_torch.ops import target_kernels as tk

    m, bare = _ten_bare_model()
    narrow = [j for j, (_, dist, _) in enumerate(bare)
              if float(dist.std()) <= NARROW_SD]
    runs = (
        (mt.NUTS(maxdoublings=6), 1100, 100, chains,
         "target_nuts_transition", narrow),
        (mt.NUTS(maxdoublings=6, mass_adapt="diag"), 1500, 500, chains,
         "target_nuts_transition", None),
        (mt.HMC(10, 0.02, mt.EmpMCTuner(0.8, adapt_step=50),
                mass_adapt="diag"), 3500, 500, chains, "target_leapfrogs",
         None),
        (mt.MALA(0.002, mt.EmpMCTuner(0.574, adapt_step=50)), 1000, 200,
         chains_small, "target_leapfrogs", narrow),
        (mt.ChEESHMC(len0=0.5, max_leaps=64), 1000, 200, chains,
         "target_leapfrogs", narrow),
    )
    counts, start, bad, held = {}, None, [], {}
    for sampler, steps, burnin, C, kernel, cols in runs:
        task = m * sampler * mt.SerialMC(steps=steps, burnin=burnin)
        origin = (f"run(model(ten bare distributions ~, d=10) * {sampler!r} "
                  f"* SerialMC({steps}, {burnin}), chains={C})")
        # the generic warmup's gradients: one pass per leaf
        cs, samples, launches, dt, spans = _path(
            origin, task, C, {kernel: steps - burnin,
                              "target_logp_grad": lambda n: n > 0})
        st = cs[0].task.state
        dg = cs[0].diagnostics
        frozen = {}
        if "epsilon" in dg:
            frozen["frozen_eps"] = float(dg["epsilon"][-1])
        for name in ("leap_step", "dual_leap_step"):
            if hasattr(st, name):
                frozen[name] = float(getattr(st, name))
        if hasattr(st, "tune"):
            frozen.update(frozen_step=st.tune.step_size.item(),
                          frozen_n_leaps=st.tune.n_leaps.item())
        if hasattr(st, "log_len"):
            frozen["frozen_T"] = float(np.exp(st.log_len.item()))
        extra = {}
        if "ndoublings" in dg:
            nd = np.stack([c.diagnostics["ndoublings"] for c in cs])
            dv = np.stack([c.diagnostics["diverging"] for c in cs])
            extra = {"mean_ndoublings": float(nd.mean()),
                     "diverging_share": float(dv.mean())}
        if "nleaps" in dg:
            extra["mean_nleaps"] = float(np.mean(dg["nleaps"]))
        z_all = _bare_z(samples, bare)
        z = z_all if cols is None else _bare_z(samples, bare, cols)
        ok = z < Z_MAX
        emit({"phase": "warm_target_path", "kernel": kernel, "from": origin,
              "layout": (nk.target_nuts_layout
                         if kernel == "target_nuts_transition"
                         else tk.target_leapfrogs_layout)(10),
              "chains": C, "seconds": dt, "spans_s": spans,
              "launches": launches[kernel],
              "gradient_pass_launches": launches["target_logp_grad"],
              **frozen, **extra,
              "accept_rate": float(np.mean([mt.acceptance(c)
                                            for c in cs])) / 100,
              "pooled_mean": samples.mean((0, 1)).tolist(),
              "exact_mean": [float(dist.mean()) for _, dist, _ in bare],
              "pooled_sd": samples.std((0, 1)).tolist(),
              "exact_sd": [float(dist.std()) for _, dist, _ in bare],
              "held_on": "all" if cols is None else [bare[j][0] for j in cols],
              "z_max_vs_exact": z, "z_max_all_coordinates": z_all, "ok": ok,
              **CARD})
        if not ok:
            bad.append(origin)
        if kernel == "target_nuts_transition" and start is None:
            counts[kernel] = (launches[kernel], origin)
            counts["target_logp_grad"] = (launches["target_logp_grad"],
                                          origin)
            start = {"theta": torch.stack([c.task.state.pars for c in cs])
                     .to(torch.float32).contiguous(),
                     "eps": frozen["frozen_eps"]}
            held["nuts"] = [c.task for c in cs]
        if isinstance(sampler, mt.HMC):
            held["hmc_diag"] = [c.task for c in cs]
        del cs, samples
    th, _ = _bare_start(bare, chains, np.random.default_rng(73))
    _grad_time("ten bare distributions, the warm target paths' model",
               m.target_spec, th, model=m)
    assert not bad, f"warm target paths disagree with the exact moments: {bad}"
    return counts, start, held


def phase_chees_glm_path(hmc_means, chains=4096):
    """``ChEESHMC(len0=0.5, max_leaps=64) * SerialMC(1000, 200)`` on the
    logistic 10 x 1000 model from the posterior mode, through ``run(...,
    chains=4096)``: the pooled adaptation on the generic engine, then 800
    sampling transitions as 100 launches of 8 of the Halton multistep
    kernel (3b) at the frozen eps and T; held against ``hmc_means``
    (:func:`_hmc_reference`), as the other warm paths are."""
    import mcmc_jl_tpu_torch as mt

    X, Y, mode = _bench_mode(1000)
    m = mt.model(glm=("logistic", X, Y), init=mode, device="cuda")
    task = m * mt.ChEESHMC(len0=0.5, max_leaps=64) \
        * mt.SerialMC(steps=1000, burnin=200)
    origin = _origin(m, task, chains)
    cs, samples, launches, dt, spans = _path(origin, task, chains,
                                             {"glm_multistep_rows": 100})
    st = cs[0].task.state
    z = _z_means(samples.mean(1), hmc_means)
    emit({"phase": "chees_glm_path", "kernel": "glm_multistep_rows",
          "from": origin, "chains": chains, "seconds": dt, "spans_s": spans,
          "launches": launches["glm_multistep_rows"],
          "frozen_eps": st.dual_leap_step.item(),
          "frozen_T": float(np.exp(st.log_len.item())),
          "mean_nleaps": float(np.mean(cs[0].diagnostics["nleaps"])),
          "accept_rate": float(np.mean([mt.acceptance(c) for c in cs])) / 100,
          "pooled_mean": samples.mean((0, 1)).tolist(),
          "z_max_vs_hmc_reference": z, "ok": z < Z_MAX, **CARD})
    assert z < Z_MAX, f"{origin} disagrees with the HMC reference"


# resume(list)'s segment lengths (phase_resume_paths): 120 transitions are
# 15 launches of 8 of kernels 3b and 9; 101 has no divisor in [2, 8], so
# exact NUTS takes kernel 8, one launch a transition; the large-N path
# integrates about 2 nl leapfrogs a transition through kernel 4, so it
# resumes fewer; the chain-by-chain resume it is timed beside runs the
# path's own segment on RESUME_OLD_CHAINS chains (each chain a run of the
# generic engine), and one transition on each of them for the fixed cost
# of a call
RESUME_STEPS, RESUME_STEPS_PRIME, RESUME_STEPS_BIGN = 120, 101, 40
RESUME_OLD_CHAINS = 1
# ... over at most this many transitions (fewer than the path's own S, to
# keep the script under 600 s)
RESUME_OLD_STEPS = 5
# the state fields a continuation freezes (whichever a sampler's state has)
FROZEN_FIELDS = ("tune.step_size", "tune.n_leaps", "leap_step",
                 "dual_leap_step", "log_len", "lebar", "mass.scale")


def _frozen(tasks):
    """{field: the chains' values stacked} of FROZEN_FIELDS."""
    import torch

    out = {}
    for path in FROZEN_FIELDS:
        vals = []
        for t in tasks:
            v = t.state
            for name in path.split("."):
                v = getattr(v, name, None)
            vals.append(v)
        if vals[0] is not None:
            out[path] = torch.stack(vals)
    return out


def _halton_evals(task, steps):
    """Kernel 4's launches on a large-N continuation: one at the start, one
    a leapfrog of each transition's shared Halton leap count (the freeze of
    warmstart.make_fused_continuation on ``task``'s frozen state)."""
    from mcmc_jl_tpu_torch.ops.glm_kernels import halton_leaps

    st = task.state
    eps, nl = float(st.tune.step_size), int(st.tune.n_leaps)
    i0 = int(st.i)
    return 1 + sum(halton_leaps(i0 + t, eps, 2.0 * nl * eps, max(2 * nl, 2))
                   for t in range(steps))


def _resume_path(label, tasks, steps, want, moments, by_chain=True):
    """``resume(tasks, steps=...)`` with every count zeroed just before it
    and read just after (each kernel launched as ``want`` says, no plain
    call), and its checks: the frozen hyper-parameters are the run's bit
    for bit (exact NUTS re-derives its step from ``lebar``, as the JAX
    package does: ``epsilon`` is held to exp(lebar)), each chain's ``pos``
    advanced by ``steps``, ``moments(samples)`` (chains, steps, d) < Z_MAX,
    a repeat from the same list the same bits, a second resume other
    samples.  Times the batched resume beside RESUME_OLD_CHAINS of the
    chains resumed one by one for the same ``steps``, and for one
    transition each (the fixed cost of a call), unless not ``by_chain``.
    Returns (the resumed chains, the path's summary)."""
    import torch

    import mcmc_jl_tpu_torch as mt

    C = len(tasks)
    before = _frozen(tasks)
    t0 = time.perf_counter()
    with _spans() as spans:
        cs, launches = _counted(lambda: mt.resume(tasks, steps=steps))
    dt = time.perf_counter() - t0
    for k, n in launches.items():
        assert n == want.get(k, 0), (label, launches)
    samples = np.stack([c.samples.values for c in cs])
    assert samples.shape == (C, steps, tasks[0].model.size)
    assert np.all(np.isfinite(samples)), label
    after = _frozen([c.task for c in cs])
    assert set(after) == set(before), label
    frozen_ok = all(torch.equal(after[k], before[k]) for k in before)
    eps_rel = None
    if "lebar" in before:
        eps = torch.stack([c.task.state.epsilon for c in cs]).cpu().numpy()
        lebar = after["lebar"].double().cpu().numpy()
        frozen_ok &= np.array_equal(eps, np.exp(lebar).astype(eps.dtype))
        eps0 = torch.stack([t.state.epsilon for t in tasks]).double()
        eps_rel = float(np.max(np.abs(eps - eps0.cpu().numpy())
                               / eps0.cpu().numpy()))
    pos_ok = all(c.task.pos == t.pos + steps for c, t in zip(cs, tasks))
    z = moments(samples)
    again = mt.resume(tasks, steps=steps)
    repeat_ok = np.array_equal(
        samples, np.stack([c.samples.values for c in again]))
    del again
    second = mt.resume(cs, steps=steps)
    second_differs = not np.array_equal(
        samples, np.stack([c.samples.values for c in second]))
    pos_ok &= all(c.task.pos == t.pos + 2 * steps
                  for c, t in zip(second, tasks))
    del second
    old = tasks[:RESUME_OLD_CHAINS if by_chain else 0]
    old_steps = min(steps, RESUME_OLD_STEPS)
    old_s = []
    for n in (old_steps, 1):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for t in old:
            mt.resume(t, steps=n)
        torch.cuda.synchronize()
        old_s.append(time.perf_counter() - t1)
    ok = (frozen_ok and pos_ok and z < Z_MAX and repeat_ok
          and second_differs)
    row = {"path": label, "chains": C, "steps": steps, "seconds": dt,
           "spans_s": spans,
           "launches": {k: n for k, n in launches.items() if n},
           "per_chain_transition_s": dt / (C * steps),
           "chain_by_chain": {"chains": len(old), "steps": old_steps,
                              "seconds": old_s[0],
                              "per_chain_transition_s":
                                  old_s[0] / (len(old) * old_steps),
                              "one_transition_call_s": old_s[1] / len(old)}
           if old else None}
    emit({"phase": "resume_path", **row, "frozen_bitwise": frozen_ok,
          "nuts_eps_rel_change": eps_rel, "pos_advanced": pos_ok,
          "z_max": z, "repeat_bitwise": repeat_ok,
          "second_differs": second_differs, "ok": ok, **CARD})
    assert ok, f"resume of {label} failed its checks"
    return cs, row


def _resume_checkpoint(cs, steps):
    """``save_chain`` eight resumed GLM chains under the ignored build/,
    ``load_chain`` them into fresh tasks, and require the loaded list's
    resume to equal the live list's bit for bit on the card."""
    import tempfile

    import mcmc_jl_tpu_torch as mt
    from mcmc_jl_tpu_torch.utils.io import load_chain, save_chain

    live = cs[:8]
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(root, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=root) as tmp:
        loaded = []
        for i, c in enumerate(live):
            path = os.path.join(tmp, f"chain{i}.npz")
            save_chain(path, c)
            t = c.task
            loaded.append(load_chain(path, mt.MCMCTask(t.model, t.sampler,
                                                       t.runner)))
    a = mt.resume(live, steps=steps)
    b = mt.resume(loaded, steps=steps)
    ok = all(np.array_equal(x.samples.values, y.samples.values)
             and np.array_equal(x.task.state.pars.cpu().numpy(),
                                y.task.state.pars.cpu().numpy())
             for x, y in zip(a, b))
    emit({"phase": "resume_checkpoint", "chains": len(live), "steps": steps,
          "device": str(loaded[0].task.state.pars.device),
          "bitwise": ok, "ok": ok})
    assert ok, "a checkpoint's resume differs from the live chains'"


def _resume_mixed(hmc_tasks, steps=16, n=8):
    """A mixed list, ``n`` adaptive HMC chains of the GLM batch interleaved
    with ``n`` RWM chains of the same model (the generic engine), resumes
    in its order: the HMC group through kernel 3b, the RWM group as one
    generic batch."""
    import mcmc_jl_tpu_torch as mt
    from mcmc_jl_tpu_torch.ops.warmstart import _pick_k_trans

    m = hmc_tasks[0].model
    rwm = [c.task for c in mt.run(m * mt.RWM(0.05) * mt.SerialMC(steps=20),
                                  chains=n, seed=3)]
    mixed = [t for pair in zip(hmc_tasks[:n], rwm) for t in pair]
    cs, launches = _counted(lambda: mt.resume(mixed, steps=steps))
    want = steps // _pick_k_trans(steps)
    ok = (launches["glm_multistep_rows"] == want
          and sum(launches.values()) == want and len(cs) == 2 * n)
    for c, t in zip(cs, mixed):
        ok &= (c.task.sampler is t.sampler and c.task.pos == t.pos + steps
               and type(c.task.state) is type(t.state)
               and c.samples.shape == (steps, m.size))
    emit({"phase": "resume_mixed", "chains": 2 * n, "steps": steps,
          "launches": {k: v for k, v in launches.items() if v},
          "order_kept": ok, "ok": ok})
    assert ok, "a mixed list's resume lost its order or its route"


def phase_resume_paths(held, hmc_means):
    """``resume(chains, steps=S)`` (``presume_serialmc``) of the chains the
    path phases ran, each once more re-batched onto the kernels its frozen
    state takes, with the checks of :func:`_resume_path`:

    - adaptive HMC diag on the GLM (4096 chains; phase_warm_paths) and the
      main path's plain ``HMC(10, 0.05)`` (4096; the JAX package's Halton
      leap counts in [1, 20]): kernel 3b, S 120;
    - ``NUTS(6)`` (4096; phase_nuts_main_path): kernel 9 at S 120, kernel 8
      at S 101; all four held against ``hmc_means``;
    - adaptive HMC at N 100,000 (512; phase_large_n_paths): kernel 4, S 40,
      held against that phase's reference;
    - adaptive HMC diag and ``NUTS(6)`` on the ten bare distributions
      (4096; phase_warm_target_paths): kernels 5 and 8b with one gradient
      pass (``sampler.reset``), S 120, held against the exact moments (NUTS
      on the coordinates of sd at most NARROW_SD, as its path is);
    - with ``held["dense_target"]`` (phase_dense_target_paths), dense
      ``NUTS(6)`` on the ten bare distributions and dense adaptive HMC on
      Gamma(3, 0.2) (4096): the dense instantiations of kernels 8b and 5
      with one gradient pass, S 120, held as their paths are, without the
      chain-by-chain timing;

    then a mixed list keeps its order, and eight resumed GLM chains go
    through ``save_chain``/``load_chain`` and resume bit for bit as the live
    ones.  Returns one summary row a path."""
    from mcmc_jl_tpu_torch.ops.warmstart import _pick_k_trans

    bare = _ten_bare()
    narrow = [j for j, (_, dist, _) in enumerate(bare)
              if float(dist.std()) <= NARROW_SD]
    S, P, SB = RESUME_STEPS, RESUME_STEPS_PRIME, RESUME_STEPS_BIGN
    glm_z = lambda s: _z_means(s.mean(1), hmc_means)  # noqa: E731
    bign_tasks, bign_ref = held["bign"]
    paths = [
        ("adaptive HMC diag, N 1000, kernel 3b", held["warm"], S,
         {"glm_multistep_rows": S // _pick_k_trans(S)}, glm_z),
        ("HMC(10, 0.05), N 1000, kernel 3b", held["hmc"], S,
         {"glm_multistep_rows": S // _pick_k_trans(S)}, glm_z),
        ("NUTS(6), N 1000, kernel 9", held["nuts"], S,
         {"glm_nuts_multistep": S // _pick_k_trans(S)}, glm_z),
        ("NUTS(6), N 1000, kernel 8", held["nuts"], P,
         {"glm_nuts_transition": P}, glm_z),
        ("adaptive HMC, N 1e5, kernel 4", bign_tasks, SB,
         {"glm_logp_grad_tiled": _halton_evals(bign_tasks[0], SB)},
         lambda s: _z_means(s.mean(1), bign_ref)),
        ("adaptive HMC diag, ten bare distributions, kernel 5",
         held["target"]["hmc_diag"], S,
         {"target_leapfrogs": S, "target_logp_grad": 1},
         lambda s: _bare_z(s, bare)),
        ("NUTS(6), ten bare distributions, kernel 8b",
         held["target"]["nuts"], S,
         {"target_nuts_transition": S, "target_logp_grad": 1},
         lambda s: _bare_z(s, bare, narrow)),
    ]
    rows, glm_resumed = [], None
    for label, tasks, steps, want, moments in paths:
        cs, row = _resume_path(label, tasks, steps, want, moments)
        rows.append(row)
        if glm_resumed is None:
            glm_resumed = cs
        del cs
    dense = held.get("dense_target")
    if dense is not None:
        import mcmc_jl_tpu_torch as mt

        gamma = mt.Gamma(3.0, 0.2)
        for label, tasks, want, moments in (
                ("dense NUTS(6), ten bare distributions, kernel 8b dense",
                 dense["nuts"], {"target_nuts_transition_dense": S,
                                 "target_logp_grad": 1},
                 lambda s: _bare_z(s, bare, narrow)),
                ("dense adaptive HMC, Gamma(3, 0.2), kernel 5 dense",
                 dense["hmc"], {"target_leapfrogs_dense": S,
                                "target_logp_grad": 1},
                 lambda s: _moments_z((s.mean(1), (s ** 2).mean(1)),
                                      gamma))):
            rows.append(_resume_path(label, tasks, S, want, moments,
                                     by_chain=False)[1])
    _resume_mixed(held["warm"])
    _resume_checkpoint(glm_resumed, S)
    return rows


# ---- the dense metric (mass_adapt="dense"): paths, kernels, times ---------

# mass_metric.py's correlated Gaussian (benchmarks/benchunits/mass_metric.py:
# 19-23): marginal sds SCALES, every correlation RHO
GAUSS_SCALES, GAUSS_RHO = np.array([3.0, 1.0, 0.5, 2.0]), 0.95
# chains of the ESS/s estimate (mass_metric.py's ess_chains), scaled to all
ESS_CHAINS = 16


def _gauss_glm():
    """mass_metric.py:46-60: the correlated Gaussian as a linear-link GLM
    with design G, Y = 0 and lam half of P's smallest eigenvalue, so that
    loglik + prior = -1/2 v' P v with P = Sigma^-1 exactly.  Returns
    (Sigma, G, lam)."""
    d = len(GAUSS_SCALES)
    sig = ((np.full((d, d), GAUSS_RHO) + (1 - GAUSS_RHO) * np.eye(d))
           * np.outer(GAUSS_SCALES, GAUSS_SCALES))
    P = np.linalg.inv(sig)
    lam = 0.5 * float(np.linalg.eigvalsh(P).min())
    G = np.linalg.cholesky(P - lam * np.eye(d)).T
    return sig, G, lam


def _pooled_factor(cs):
    """The dense factor the warm pipeline freezes from the chains' states
    (warmstart._pool_mass: the Cholesky factor of the chains' mean L_c L_c'),
    as float64 numpy."""
    import torch

    from mcmc_jl_tpu_torch.ops.warmstart import _pool_mass
    from mcmc_jl_tpu_torch.samplers.base import tree_map

    states = tree_map(lambda *xs: torch.stack(xs),
                      *[c.task.state for c in cs])
    return _pool_mass("dense", states).cpu().numpy()


def _min_ess_per_s(cs, seconds):
    """mass_metric.py's ESS/s: the min-coordinate ESS of the first
    ESS_CHAINS chains summed, scaled to all chains, over the run's
    seconds.  Returns (min-coordinate ESS per chain, ESS/s)."""
    import mcmc_jl_tpu_torch as mt

    n = min(ESS_CHAINS, len(cs))
    tot = sum(float(np.min(mt.ess(c))) for c in cs[:n])
    return tot / n, tot * (len(cs) / n) / seconds


def phase_dense_paths(hmc_means, bign_ref, chains=4096, chains_bign=512,
                      gauss_chains=4096, gauss_steps=(900, 300)):
    """The dense metric through ``run(..., chains=N)``: the adaptive warmup
    on the generic engine, then the pooled factor L frozen and folded into
    the design (X L, prior matrix lam L'L), the sampling phase on the
    matrix-prior variants of kernels 3b, 4, 8 and 9; each run's launches
    counted from zero (a run that takes the generic engine fails):

    - bench.py's logistic GLM (d 10, N 1000, from the mode), 4096 chains:
      ``HMC(10, 0.02, EmpMCTuner(0.8, 50), mass_adapt="dense") *
      SerialMC(2000, 500)`` (3b: 250 launches of 6) and ``NUTS(6,
      mass_adapt="dense") * SerialMC(559, 60)`` (8: 499; the burn-in cut
      to 80, then 60, for the script's time), both held
      against ``hmc_means``; the NUTS run's ``resume(tasks, steps=120)``
      (9: 15 launches of 8) with _resume_path's checks;
    - mass_metric.py's correlated Gaussian as a linear GLM (d 4), 4096
      chains, ``HMC(10, 0.25, mass_adapt="dense") * SerialMC(900, 300)``
      (mass_metric.py's SerialMC(6000, 2000) cut to a fifth, then to
      (900, 300), for the script's time; 3b): the chains' means
      held to 0 and their
      second moments (the
      variances and the rho = 0.95 covariances) to the known Sigma by |z|
      gates; its min-coordinate ESS and ESS/s beside the same run with
      ``mass_adapt=True`` (3b with the (d,) row);
    - N 100,000 (bench.py's data, from the mode), 512 chains, ``HMC(10,
      0.002, EmpMCTuner(0.8, 50), mass_adapt="dense") * SerialMC(110, 50)``
      (benchunits/bign.py:73's sampler, phase_large_n_paths' SerialMC(200,
      50) cut to 110 transitions for the script's 600 s; 4), held against
      ``bign_ref`` (phase_large_n_paths' reference).

    Returns the variants' launches and the folds the kernel checks and
    times take: {"n1000": (L, eps, n_leaps), "n1e5": (L,), "nuts_eps"}."""
    import mcmc_jl_tpu_torch as mt

    counts, folds = {}, {}
    X, Y, mode = _bench_mode(1000)
    m = mt.model(glm=("logistic", X, Y), init=mode, device="cuda")
    for sampler, steps, burnin, name, want in (
            (mt.HMC(10, 0.02, mt.EmpMCTuner(0.8, adapt_step=50),
                    mass_adapt="dense"), 2000, 500,
             "glm_multistep_rows_mat", 250),
            (mt.NUTS(6, mass_adapt="dense"), 559, 60,
             "glm_nuts_transition_mat", 499)):
        task = m * sampler * mt.SerialMC(steps=steps, burnin=burnin)
        origin = _origin(m, task, chains)
        cs, samples, launches, dt, spans = _path(origin, task, chains,
                                                 {name: want})
        st = cs[0].task.state
        L = _pooled_factor(cs)
        if isinstance(sampler, mt.NUTS):
            frozen = {"frozen_eps": float(cs[0].diagnostics["epsilon"][-1])}
            folds["nuts_eps"] = frozen["frozen_eps"]
            nuts_tasks = [c.task for c in cs]
        else:
            frozen = {"frozen_step": st.tune.step_size.item(),
                      "frozen_n_leaps": st.tune.n_leaps.item()}
            folds["n1000"] = (L, frozen["frozen_step"],
                              frozen["frozen_n_leaps"])
        z = _z_means(samples.mean(1), hmc_means)
        emit({"phase": "dense_path", "kernel": name, "from": origin,
              "chains": chains, "seconds": dt, "spans_s": spans,
              "launches": launches[name], **frozen,
              "pooled_factor_diag": np.diag(L).tolist(),
              "accept_rate": float(np.mean([mt.acceptance(c)
                                            for c in cs])) / 100,
              "pooled_mean": samples.mean((0, 1)).tolist(),
              "z_max_vs_hmc_reference": z, "ok": z < Z_MAX, **CARD})
        assert z < Z_MAX, f"{origin} disagrees with the HMC reference"
        counts[name] = (launches[name], origin)
        del cs, samples
    label = "NUTS(6, dense), N 1000, kernel 9"
    _, row = _resume_path(label, nuts_tasks, RESUME_STEPS,
                          {"glm_nuts_multistep_mat": RESUME_STEPS // 8},
                          lambda s: _z_means(s.mean(1), hmc_means),
                          by_chain=False)
    counts["glm_nuts_multistep_mat"] = (
        row["launches"]["glm_nuts_multistep_mat"],
        f"resume(tasks, steps={RESUME_STEPS}) of the {chains} chains of "
        f"run(model(glm=..., N=1000) * NUTS(6, mass_adapt='dense') * "
        f"SerialMC(steps=599, burnin=100), chains={chains})")
    del nuts_tasks

    sig, G, lam = _gauss_glm()
    d = len(sig)
    mg = mt.model(glm=("linear", G, np.zeros(d)), prior_prec=lam,
                  device="cuda")
    steps, burnin = gauss_steps
    kept = steps - burnin
    ess = {}
    for ma, name in (("dense", "glm_multistep_rows_mat"),
                     (True, "glm_multistep_rows")):
        task = mg * mt.HMC(10, 0.25, mass_adapt=ma) \
            * mt.SerialMC(steps=steps, burnin=burnin)
        origin = (f"run(model(glm=('linear', G, 0)) * {task.sampler!r} * "
                  f"SerialMC(steps={steps}, burnin={burnin}), "
                  f"chains={gauss_chains})")
        cs, x, launches, dt, spans = _path(origin, task, gauss_chains,
                                           {name: kept // 8})
        per_chain, per_s = _min_ess_per_s(cs, dt)
        ess[ma] = (per_chain, per_s)
        mu = x.mean(1)  # (chains, d)
        m2 = np.einsum("ctj,ctk->cjk", x, x) / x.shape[1]  # E[x x'] a chain
        C = x.shape[0]
        z_mean = float(np.max(np.abs(mu.mean(0))
                              / (mu.std(0, ddof=1) / np.sqrt(C))))
        z_cov = float(np.max(np.abs(m2.mean(0) - sig)
                             / (m2.std(0, ddof=1) / np.sqrt(C))))
        cov = m2.mean(0)
        corr = cov / np.sqrt(np.outer(np.diag(cov), np.diag(cov)))
        held = ma == "dense"
        ok = not held or (z_mean < Z_MAX and z_cov < Z_MAX)
        emit({"phase": "dense_gauss_path", "kernel": name, "from": origin,
              "chains": C, "seconds": dt, "spans_s": spans,
              "launches": launches[name],
              "accept_rate": float(np.mean([mt.acceptance(c)
                                            for c in cs[:256]])) / 100,
              "pooled_var": np.diag(cov).tolist(),
              "want_var": np.diag(sig).tolist(),
              "pooled_corr_min_max": [float(corr[np.triu_indices(d, 1)].min()),
                                      float(corr[np.triu_indices(d, 1)].max())],
              "want_corr": GAUSS_RHO, "z_max_mean_vs_0": z_mean,
              "z_max_second_moments_vs_sigma": z_cov, "held": held,
              "min_coord_ess_per_chain": per_chain,
              "min_coord_ess_per_s": per_s, "ok": ok, **CARD})
        assert ok, f"{origin} misses the known Sigma"
        if held:
            counts.setdefault(name, (launches[name], origin))
        del cs, x
    emit({"phase": "dense_vs_diag_ess", "target": "mass_metric.py's "
          "correlated Gaussian as a linear GLM", "chains": gauss_chains,
          "kept": kept,
          "dense": {"min_coord_ess_per_chain": ess["dense"][0],
                    "min_coord_ess_per_s": ess["dense"][1]},
          "diag": {"min_coord_ess_per_chain": ess[True][0],
                   "min_coord_ess_per_s": ess[True][1]},
          "ess_per_s_ratio": ess["dense"][1] / ess[True][1], **CARD})

    Xb, Yb, mode_b = _bench_mode(100_000)
    mb = mt.model(glm=("logistic", Xb, Yb), init=mode_b, device="cuda")
    task = mb * mt.HMC(10, 0.002, mt.EmpMCTuner(0.8, adapt_step=50),
                       mass_adapt="dense") * mt.SerialMC(steps=110, burnin=50)
    origin = _origin(mb, task, chains_bign)
    cs, samples, launches, dt, spans = _path(
        origin, task, chains_bign,
        {"glm_logp_grad_tiled_mat": lambda n: n >= 60 + 1})
    st = cs[0].task.state
    folds["n1e5"] = (_pooled_factor(cs),)
    z = _z_means(samples.mean(1), bign_ref)
    emit({"phase": "dense_path", "kernel": "glm_logp_grad_tiled_mat",
          "from": origin, "chains": chains_bign, "seconds": dt,
          "spans_s": spans, "launches": launches["glm_logp_grad_tiled_mat"],
          "frozen_step": st.tune.step_size.item(),
          "frozen_n_leaps": st.tune.n_leaps.item(),
          "accept_rate": float(np.mean([mt.acceptance(c) for c in cs])) / 100,
          "z_max_vs_reference": z, "ok": z < Z_MAX, **CARD})
    assert z < Z_MAX, f"{origin} disagrees with the reference"
    counts["glm_logp_grad_tiled_mat"] = (
        launches["glm_logp_grad_tiled_mat"], origin)
    return counts, folds


def _dense_fold(X, L, lam=1.0):
    """The dense fold of a design by a factor L: (X L, A = lam L'L), float64
    numpy (warmstart._fold)."""
    return X @ L, lam * (L.T @ L)


def _dense_start(L, mode, scale, C, seed):
    """C chains in z = L^-1 theta with theta around ``mode``: each
    coordinate ``scale`` times a normal."""
    rng = np.random.default_rng(seed)
    theta = mode + scale * rng.standard_normal((C, len(mode)))
    return np.linalg.solve(L, theta.T).T


def phase_dense_kernels(folds, C=4096, C_bign=512, md=6, k_chain=8):
    """The matrix-prior variants of kernels 3b, 4, 8 and 9 against their
    plain versions on the card, A = lam L'L from the dense paths' own folds
    (phase_dense_paths): 3b chain by chain on its replayed draws
    (_rows_check) at its path's shape (4096 chains, d 10, N 1000, the
    path's frozen step and leap count); 4 at C 512, N 100,000 (_tiled_case,
    errors over the terms' L1 mass); 8 on the same pre-drawn noise
    (_nuts_check, PATH_AGREE) and 9 on its replayed draws (_nuts_ms_check,
    k 5) at 4096 chains, slice and multinomial, at eps 0.1 (trees to
    maxdoublings) and at the dense NUTS path's frozen step.  Also prints
    the occupancy plans: A is read through the read-only path (4 KB at d
    32), so the plans are the diagonal variants'.  Returns the variants'
    largest errors."""
    from mcmc_jl_tpu_torch.ops import glm_bign as gb
    from mcmc_jl_tpu_torch.ops import glm_kernels as gk
    from mcmc_jl_tpu_torch.ops import nuts_kernels as nk

    X, Y, mode = _bench_mode(1000)
    d, N = X.shape[1], X.shape[0]
    L, eps, nl = folds["n1000"]
    XL, A = _dense_fold(X, L)
    sc = _laplace_scale(X, Y)
    emit({"phase": "dense_plan", "N": N, "d": d,
          "rows": _plan(gk, "glm_multistep_rows_plan", d, N),
          "nuts": nk.nuts_plan(d, N, md),
          "tiled": _plan(gb, "glm_tiled_plan", d),
          "matrix": "read through the read-only path, no shared memory"})
    errors = {}
    th0 = _cuda(_dense_start(L, mode, sc, C, 61))
    errors["glm_multistep_rows_mat"] = _rows_check(
        f"folded dense metric (X L, (d, d) prior), eps {eps}, {nl} leaps",
        _cuda(XL.T), _cuda(Y), th0, eps, 2.0 * nl * eps, 1, max(2 * nl, 2),
        k_chain, seed=79, prior_prec=_cuda(A))

    Xb, Yb, mode_b = _bench_mode(100_000)
    Lb = folds["n1e5"][0]
    XLb, Ab = _dense_fold(Xb, Lb)
    zb = _dense_start(Lb, mode_b, 0.05 * np.sqrt(1000 / 100_000), C_bign, 62)
    errors["glm_logp_grad_tiled_mat"] = _tiled_case(
        f"bench data, C {C_bign}, N 100000, folded dense metric "
        f"(X L, (d, d) prior)", _cuda(XLb.T), _cuda(Yb), _cuda(zb),
        lam=_cuda(Ab))

    err8 = err9 = 0.0
    for eps8 in (0.1, folds["nuts_eps"]):
        for multinomial in (False, True):
            args, noise, kw = _nuts_inputs(C, md, 26, XL, Y, lam=A,
                                           spread=0.5)
            kw = dict(kw, multinomial=multinomial)
            label = (f"{'multinomial' if multinomial else 'slice'}, folded "
                     f"dense metric (X L, (d, d) prior), eps {eps8}")
            deep = eps8 == 0.1
            err8 = max(err8, _nuts_check(label, args, noise, eps8, kw,
                                         full_depth=deep))
            err9 = max(err9, _nuts_ms_check(label, args, eps8, kw, seed=35,
                                            full_depth=deep))
    errors["glm_nuts_transition_mat"] = err8
    errors["glm_nuts_multistep_mat"] = err9
    return errors


def phase_dense_times(folds, C=4096, C_bign=512, kt=6, i0=501, md=6,
                      k_nuts=5):
    """Per-launch time of each matrix-prior variant beside its diagonal-row
    variant (the row diag(A)) at the same shape, with CUDA events (median
    of 3) and torch.profiler's device time (median of 3 calls' mean):
    3b at its dense path's shape (4096 chains, the frozen step and leap
    count, ``kt`` transitions from transition ``i0``), 4 at C 512 and N
    100,000, 8 and 9 at 4096 chains at the dense NUTS path's frozen step
    (9 at ``k_nuts`` transitions); beside the plain version's time and the
    variant's bound (its GLM gradients' 4 d N operations each plus the
    prior's 2 d^2, or its bytes).  Returns ({variant: (ms, plain ms)},
    {variant: bound and device ms})."""
    import torch

    from mcmc_jl_tpu_torch.ops import glm_bign as gb
    from mcmc_jl_tpu_torch.ops import glm_kernels as gk
    from mcmc_jl_tpu_torch.ops import nuts_kernels as nk
    from mcmc_jl_tpu_torch.ops import target_kernels as tk

    ms, work = {}, {}

    def device(fn, symbol):
        runs = [t for t in (_device_ms(fn, symbol, reps=3) for _ in range(3))
                if t is not None]
        return float(np.median(runs)) if runs else None

    def bound(evals, d, N, nbytes):
        return _bound_ops((4.0 * d * N + 2.0 * d * d) * evals, nbytes,
                          TF32X3_FLOPS)

    def line(name, kern, row_kern, plain, symbol, evals, d, N, nbytes,
             **extra):
        t_mat, t_row = _event_ms(kern), _event_ms(row_kern)
        dev_mat, dev_row = device(kern, symbol), device(row_kern, symbol)
        ms[name] = (t_mat, _event_ms(plain, reps=2))
        work[name] = {**bound(evals, d, N, nbytes), "device_ms": dev_mat}
        emit({"phase": "dense_time", "name": name, "C": extra.pop("C"),
              "N": N, "d": d, "ms": t_mat, "device_ms": dev_mat,
              "row_variant_ms": t_row, "row_variant_device_ms": dev_row,
              "plain_ms": ms[name][1], **work[name], **extra, **CARD})

    X, Y, mode = _bench_mode(1000)
    d, N = X.shape[1], X.shape[0]
    L, eps, nl = folds["n1000"]
    XL, A = _dense_fold(X, L)
    XT, Yc, At, row = (_cuda(XL.T), _cuda(Y), _cuda(A),
                       _cuda(np.diag(A).copy()))
    th = _cuda(_dense_start(L, mode, _laplace_scale(X, Y), C, 63))
    T, ml = 2.0 * nl * eps, max(2 * nl, 2)
    gen = lambda k: torch.Generator(device="cuda").manual_seed(k)  # noqa: E731
    args = (XT, Yc, th, eps, T, i0, ml)
    out = gk.glm_multistep_rows(*args, k_trans=kt, generator=gen(7),
                                prior_prec=At)
    leaps = int(out[3]["nleaps"][:, 0].sum())
    line("glm_multistep_rows_mat",
         lambda: gk.glm_multistep_rows(*args, k_trans=kt, generator=gen(7),
                                       prior_prec=At),
         lambda: gk.glm_multistep_rows(*args, k_trans=kt, generator=gen(7),
                                       prior_prec=row),
         lambda: gk.glm_multistep_rows_ref(*args, k_trans=kt,
                                           generator=gen(8), prior_prec=At),
         "rows_tile_kernel", C * (1 + leaps), d, N,
         _nbytes((XT, Yc, th, At), out), C=C, k_trans=kt, eps=eps, T=T,
         max_leaps=ml, leapfrogs=leaps)

    Xb, Yb, mode_b = _bench_mode(100_000)
    Lb = folds["n1e5"][0]
    XLb, Ab = _dense_fold(Xb, Lb)
    XTb, Ybc, Abt = _cuda(XLb.T), _cuda(Yb), _cuda(Ab)
    zb = _cuda(_dense_start(Lb, mode_b, 0.005, C_bign, 64))
    out = gb.glm_logp_grad_tiled(XTb, Ybc, zb, prior_prec=Abt)
    line("glm_logp_grad_tiled_mat",
         lambda: gb.glm_logp_grad_tiled(XTb, Ybc, zb, prior_prec=Abt),
         lambda: gb.glm_logp_grad_tiled(XTb, Ybc, zb,
                                        prior_prec=_cuda(np.diag(Ab).copy())),
         lambda: gb.glm_logp_grad_tiled_ref(XTb, Ybc, zb, prior_prec=Abt),
         ("partial_tile_kernel", "reduce_kernel"), C_bign, d,
         Xb.shape[0], _nbytes((XTb, Ybc, zb, Abt), out), C=C_bign)

    eps8 = folds["nuts_eps"]
    args, _, kw = _nuts_inputs(C, md, 27, XL, Y, lam=A, spread=0.5)
    XTn, Yn, thn, lpn, gn = args
    noise = nk.draw_noise(C, d, md, gen(9))
    draws = nk.glm_nuts_multistep_draws(tk._seed(gen(10)), C, d, k_nuts, md,
                                        device="cuda")
    for name, fn, sets in (
            ("glm_nuts_transition_mat", "transition", [noise]),
            ("glm_nuts_multistep_mat", "multistep",
             [tuple(a[t] for a in draws) for t in range(k_nuts)])):
        leaves = int(_nuts_leaves(XTn, Yn, thn, lpn, gn, eps8, md, sets,
                                  prior=At).sum())
        if fn == "transition":
            call = lambda p: nk.glm_nuts_transition(  # noqa: E731
                *args, eps8, *noise, maxdoublings=md, prior_prec=p)
            plain = lambda: nk.glm_nuts_transition_ref(  # noqa: E731
                *args, eps8, *noise, maxdoublings=md, prior_prec=At)
        else:
            call = lambda p: nk.glm_nuts_multistep(  # noqa: E731
                *args, eps8, gen(10), k_trans=k_nuts, maxdoublings=md,
                prior_prec=p)
            plain = lambda: nk.glm_nuts_multistep_ref(  # noqa: E731
                *args, eps8, gen(11), k_trans=k_nuts, maxdoublings=md,
                prior_prec=At)
        out = call(At)
        line(name, lambda: call(At), lambda: call(row), plain,
             "nuts_tile_kernel", leaves, d, N, _nbytes(args, At, out), C=C,
             eps=eps8, leaves=leaves,
             k_trans=k_nuts if fn == "multistep" else 1)
    return ms, work


def _target_nuts_plan(d, C, md):
    """Kernel 8b's launch plan at (d, C, md), or None for a package without
    one (before the lane layout)."""
    from mcmc_jl_tpu_torch.ops import nuts_kernels as nk

    return nk.target_nuts_plan(d, C, md) \
        if hasattr(nk, "target_nuts_plan") else None


def _target_nuts_kernel_time(target, th, eps, md, seed, plain=True):
    """One launch of kernel 8b on ``target`` from ``th`` (C, d) at step
    ``eps``, one transition's noise drawn from a generator seeded ``seed``:
    ``ms`` one call between CUDA events (the wrapper's host work
    included), ``device_ms`` the kernel alone (torch.profiler); each
    chain's leaves counted by the plain version's lockstep transition on
    the same noise, their sum and largest, and the leaf steps of a warp of
    32 chains (its deepest tree's leaves, summed over the warps: what the
    lane layout runs); the bound from the leaves (TARGET_LEAP_OPS x d FP32
    operations each, plus the z-space pass's on a dense target,
    _dense_pass_ops) or the call's bytes, whichever takes longer; the
    plain version's time when ``plain``; the launch plan.  Returns a
    dict."""
    import torch

    from mcmc_jl_tpu_torch.ops import nuts_kernels as nk
    from mcmc_jl_tpu_torch.ops import target_kernels as tk

    C, d = th.shape
    lp, g = tk.target_funcs(target)[1](th)
    lp, g = lp.contiguous(), g.contiguous()
    noise = nk.draw_noise(C, d, md, torch.Generator(
        device="cuda").manual_seed(seed))

    def kern():
        return nk.target_nuts_transition(target, th, lp, g, eps, *noise,
                                         maxdoublings=md)

    def plain_call():
        return nk.target_nuts_transition_ref(target, th, lp, g, eps, *noise,
                                             maxdoublings=md)

    out = kern()
    leaves = torch.zeros(C, dtype=torch.int64, device="cuda")
    nk._transition(tk.target_funcs(target)[1], th, lp, g, tk._eps(eps, th),
                   *noise, md, False, leaves=leaves)
    leaf_ops = TARGET_LEAP_OPS * d + _dense_pass_ops(target, d)
    warp = torch.nn.functional.pad(leaves, (0, (-C) % 32)).view(-1, 32)
    n_leaves = int(leaves.sum())
    return {"C": C, "d": d, "maxdoublings": md,
            "eps": eps if isinstance(eps, float) else "(d,) row",
            "mean_ndoublings": float(out[3].double().mean()),
            "leaves": n_leaves, "max_leaves": int(leaves.max()),
            "warp_leaf_steps": int(warp.amax(1).sum()),
            "ms": _event_ms(kern), "plain_ms": (_event_ms(plain_call, reps=2)
                                                if plain else None),
            **_bound_ops(leaf_ops * n_leaves,
                         _nbytes((th, lp, g, noise,
                                  _target_inputs(target, th)), out)),
            "device_ms": _device_ms(kern, ("nuts_lane_kernel", "nuts_kernel")),
            "plan": _target_nuts_plan(d, C, md)}


def phase_target_nuts_time(start, md=6):
    """Per-launch time of kernel 8b beside its plain version and its bound,
    at its path's shape: the unit-metric NUTS path's final positions (4096
    chains, d 10) at its frozen step, one transition's noise
    (_target_nuts_kernel_time).  Returns ({kernel: (ms, plain ms)},
    {kernel: bound and device ms})."""
    m, _ = _ten_bare_model()
    name = "target_nuts_transition"
    r = _target_nuts_kernel_time(m.target_spec, start["theta"], start["eps"],
                                 md, seed=9)
    emit({"phase": "kernel_time", "name": name, **r, **CARD})
    return ({name: (r["ms"], r["plain_ms"])},
            {name: {k: r[k] for k in ("bound_ms", "bound_by", "device_ms")}})


def _bare_draws(bare, C, seed):
    """C exact draws of each coordinate's distribution, a float32 (C, d)
    tensor on the card: a start the NUTS path's chains reach."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    return torch.stack([dist.sample(gen, (C,)).to(torch.float32)
                        for _, dist, _ in bare], 1).cuda().contiguous()


def phase_target_nuts_times(Cs=(4096, 65536), md=6):
    """Kernel 8b at its path's shape with a pinned step and start
    (TARGET_NUTS_TIME_EPS; exact draws of the ten bare distributions,
    seed TARGET_NUTS_TIME_SEED) at each of Cs chains, on the ten bare
    distributions and on ten Normals with their means and standard
    deviations (the same start and step; one family in every coordinate,
    so that the family branch is the same in every lane of the
    warp-per-chain layout too): what the family switch costs.  The plain
    version is timed at Cs[0] only.  Runs on whichever package
    ``mcmc_jl_tpu_torch`` resolves to, so one call can time a parent
    tree."""
    import mcmc_jl_tpu_torch as mt
    from mcmc_jl_tpu_torch.ops.target_kernels import coordwise_logp

    m, bare = _ten_bare_model()
    normals = coordwise_logp([mt.Normal(float(dist.mean()),
                                        float(dist.std()))
                              for _, dist, _ in bare], len(bare))
    for C in Cs:
        th = _bare_draws(bare, C, TARGET_NUTS_TIME_SEED)
        for label, target in (("ten bare distributions", m.target_spec),
                              ("ten Normals, the same means and sds",
                               normals)):
            r = _target_nuts_kernel_time(target, th, TARGET_NUTS_TIME_EPS,
                                         md, seed=9, plain=C == Cs[0])
            emit({"phase": "target_nuts_time", "target": label, **r,
                  **CARD})


def _dense_pass_ops(target, d):
    """FP32 operations a gradient pass of a dense target adds for each
    chain: the two triangular products theta = z L' and g_z = g_theta L,
    d (d + 1) multiply-adds each, counted as two operations (0 for a
    catalog target)."""
    return 2 * d * (d + 1) if hasattr(target, "factor") else 0


def _target_inputs(target, th):
    """The target's inputs to a kernel on th's device: its rows, and a dense
    target's factor (L and L')."""
    rows = target.rows(th.device)
    return (rows, target.factor(th.device)) if hasattr(target, "factor") \
        else rows


def _traj_time(label, target, th, eps, n_leaps, seed, plain=False):
    """One launch of kernel 5 on ``target`` from ``th`` (C, d), momenta
    N(0, 1) from numpy seed ``seed``: ``ms`` one call of the public wrapper
    between CUDA events, ``device_ms`` the kernel alone, the lean
    launcher's host time; the bound (TARGET_LEAP_OPS x d operations a
    leapfrog, or the bytes), device ns per chain and leapfrog, and the
    plan.  Emits and returns a dict."""
    from mcmc_jl_tpu_torch.ops import target_kernels as tk

    C, d = th.shape
    m0 = _cuda(np.random.default_rng(seed).standard_normal((C, d)))
    g = tk.target_funcs(target)[1](th)[1].contiguous()
    kern = lambda: tk.fused_target_leapfrogs(  # noqa: E731
        target, th, m0, g, eps, n_leaps=n_leaps)
    name = _dense_name("target_leapfrogs", target)
    dev = _device_ms(kern, KERNEL_SYMBOL["target_leapfrogs"])
    r = {"target": label, "C": C, "d": d, "n_leaps": n_leaps,
         "eps": eps if isinstance(eps, float) else "(d,) row",
         "ms": _event_ms(kern), "device_ms": dev,
         "device_ns_per_chain_leapfrog": None if dev is None
         else 1e6 * dev / (C * n_leaps),
         **_bound_ops((TARGET_LEAP_OPS * d + _dense_pass_ops(target, d))
                      * C * n_leaps,
                      _nbytes((th, m0, g, _target_inputs(target, th)),
                              kern())),
         "plan": _lane_plan(name, d, C),
         **_lean_times(target, th, m0, g, eps, n_leaps, dev)}
    if plain:
        r["plain_ms"] = _event_ms(lambda: tk.fused_target_leapfrogs_ref(
            target, th, m0, g, eps, n_leaps=n_leaps), reps=2)
    emit({"phase": "target_time", "name": name, **r, **CARD})
    return r


def _ms_time(label, target, th, eps, k, n_leaps, seed, plain=False):
    """One launch of kernel 6 on ``target`` from ``th`` (C, d), ``k``
    transitions of ``n_leaps`` leapfrogs, the launch seed from a generator
    seeded ``seed``: ``ms`` one call of the public wrapper between CUDA
    events, ``device_ms`` the kernel alone, ``lean_ms`` one launch through
    ``multistep_launcher`` (the driver's path; absent before it); the
    bound (TARGET_LEAP_OPS x d operations a leapfrog and the start's
    gradient, or the bytes), device ns per chain and leapfrog, and the
    plan.  Emits and returns a dict."""
    import torch

    from mcmc_jl_tpu_torch.ops import target_kernels as tk

    C, d = th.shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    kern = lambda: tk.target_multistep(  # noqa: E731
        target, th, eps, k_trans=k, n_leaps=n_leaps, generator=gen)
    dev = _device_ms(kern, KERNEL_SYMBOL["target_multistep"])
    r = {"target": label, "C": C, "d": d, "k": k, "n_leaps": n_leaps,
         "eps": eps if isinstance(eps, float) else "(d,) row",
         "ms": _event_ms(kern), "device_ms": dev,
         "device_ns_per_chain_leapfrog": None if dev is None
         else 1e6 * dev / (C * k * n_leaps),
         **_bound_ops(TARGET_LEAP_OPS * d * C * (1 + k * n_leaps),
                      _nbytes((th, target.rows(th.device)), kern())),
         "plan": _lane_plan("target_multistep", d, C)}
    if hasattr(tk, "multistep_launcher"):
        step = tk.multistep_launcher(target, th, eps)
        r["lean_ms"] = _event_ms(lambda: step(th, k, n_leaps, gen, 0))
    if plain:
        r["plain_ms"] = _event_ms(lambda: tk.target_multistep_ref(
            target, th, eps, k_trans=k, n_leaps=n_leaps, generator=gen),
            reps=2)
    emit({"phase": "target_time", "name": "target_multistep", **r, **CARD})
    return r


def _grad_time(label, target, th, model=None):
    """One gradient pass on ``target`` at ``th`` (C, d): ``ms`` one call of
    the public wrapper between CUDA events, ``device_ms`` the kernel
    alone, ``lean_ms`` one call through ``logp_grad_launcher`` (absent
    before it) and, for a ``model`` whose target this is, ``model_ms`` one
    call of its ``evalallg`` (the generic engine's call, with its
    sanitizing of -inf and NaN), each with its host ms (events - device);
    the bound (TARGET_EVAL_OPS x d operations a chain, or the bytes) and
    the layout.  Emits and returns a dict."""
    from mcmc_jl_tpu_torch.ops import target_kernels as tk

    C, d = th.shape
    kern = lambda: tk.target_logp_grad(target, th)  # noqa: E731
    dev = _device_ms(kern, KERNEL_SYMBOL["target_logp_grad"])
    r = {"target": label, "C": C, "d": d, "ms": _event_ms(kern),
         "device_ms": dev,
         **_bound_ops(TARGET_EVAL_OPS * d * C,
                      _nbytes((th, target.rows(th.device)), kern())),
         "layout": "lane" if d <= 32 and hasattr(tk, "logp_grad_launcher")
         else "warp"}
    if hasattr(tk, "logp_grad_launcher"):
        allg = tk.logp_grad_launcher(target, th.device)
        r["lean_ms"] = _event_ms(lambda: allg(th))
    if model is not None:
        r["model_ms"] = _event_ms(lambda: model.evalallg(th))
    for key in ("ms", "lean_ms", "model_ms"):
        if key in r and dev is not None:
            r[key.replace("ms", "host_ms")] = r[key] - dev
    emit({"phase": "target_time", "name": "target_logp_grad", **r, **CARD})
    return r


def _rwm_time(label, target, th, scale, k, seed):
    """One launch of kernel 7 in Philox mode on ``target`` from ``th``:
    ``ms`` (events), ``device_ms``, the bound (TARGET_STEP_OPS x d
    operations a step), the floors, device ns per chain and step, the
    plan.  Emits and returns a dict."""
    import torch

    from mcmc_jl_tpu_torch.ops import rwm_kernels as rk

    C, d = th.shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    kern = lambda: rk.fused_target_rwm_steps(  # noqa: E731
        target, th, scale, k_steps=k, noise="hw", generator=gen)
    dev = _device_ms(kern, KERNEL_SYMBOL["target_rwm_steps"])
    rng_ms = _rng_floor_ms(C * -(-k // 4) * (d + 1))
    sfu_ms = _sfu_floor_ms(C * k, RWM_SFU_COORD * d + RWM_SFU_CHAIN)
    r = {"target": label, "C": C, "d": d, "k": k,
         "ms": _event_ms(kern), "device_ms": dev,
         "device_ns_per_chain_step": None if dev is None
         else 1e6 * dev / (C * k),
         **_bound_ops(C * (1 + k) * TARGET_STEP_OPS * d,
                      _nbytes((th, scale, target.rows(th.device)), kern())),
         "rng_floor_ms": rng_ms, "sfu_floor_ms": sfu_ms,
         "floor_ms": max(rng_ms, sfu_ms),
         "plan": _lane_plan("target_rwm_steps", d, C)}
    emit({"phase": "target_time", "name": "target_rwm_steps", **r, **CARD})
    return r


def phase_target_lane_times(Cs=(1024, 4096, 8192, 16_384, 65_536), C=4096,
                            rwm_Cs=(16_384, 65_536), k_rwm=100, n_leaps=10,
                            k_ms=10):
    """Kernels 5 and 7 at pinned shapes in the layouts they launch: kernel 5
    on Gamma(3, 0.2) (eps 0.05, 10 leapfrogs) at each of ``Cs`` chains (on
    both sides of the line where its W changes, one group an SM); on the ten
    bare distributions at C chains from exact draws (seed
    TARGET_NUTS_TIME_SEED) at the adaptive HMC-diag path's frozen step and
    leap count (TARGET_TIME_FROZEN; the row eps times each coordinate's sd, the metric
    the adaptation estimates), and at 10 leapfrogs of that row (the count
    of the Gamma shape), beside ten Normals with the same means and sds
    (one family in every coordinate: what the family branch costs); kernel
    7 in Philox mode on Normal(1, 1) (scale 1.1, k_rwm steps) at d 10 and
    each of ``rwm_Cs`` chains, and in the warp-per-chain layout at d 33
    (16,384 chains) and d 1000 (4096); kernel 6 (``k_ms`` transitions of
    10 leapfrogs) on Gamma(3, 0.2) at each of ``Cs`` chains (both sides of
    its W line) and at d 33 (one warp per chain, C chains), on the ten
    bare distributions at the frozen row, and at d 32 (16,384 chains: four
    warps of eight coordinates); the gradient pass on Gamma at each of
    ``Cs`` chains and at d 32 and 33, and on the ten bare distributions
    through the catalog model's ``evalallg`` as the generic engine calls
    it.  The plain versions at the first shapes only.  Runs on whichever
    package ``mcmc_jl_tpu_torch`` resolves to, so one call can time a
    parent tree."""
    import mcmc_jl_tpu_torch as mt
    from mcmc_jl_tpu_torch.ops.target_kernels import coordwise_logp

    for name in ("target_leapfrogs", "target_multistep", "target_rwm_steps"):
        for dd in (8, 10, 16, 32, 33, 1000):
            for Cx in (C, Cs[-1]):
                plan = _lane_plan(name, dd, Cx)
                if plan:
                    emit({"phase": "plan", "name": name, "d": dd, "C": Cx,
                          **plan})
    d = 10
    rng = np.random.default_rng(42)
    gam = coordwise_logp(mt.Gamma(3.0, 0.2), d)
    for Cx in Cs:
        th = _cuda(0.6 + 0.1 * rng.standard_normal((Cx, d)))
        _traj_time("Gamma(3,0.2)", gam, th, 0.05, n_leaps, 43,
                   plain=Cx == C)
    m, bare = _ten_bare_model()
    normals = coordwise_logp([mt.Normal(float(dist.mean()),
                                        float(dist.std()))
                              for _, dist, _ in bare], d)
    eps, nl = TARGET_TIME_FROZEN
    row = _cuda(eps * np.array([float(dist.std()) for _, dist, _ in bare]))
    th = _bare_draws(bare, C, TARGET_NUTS_TIME_SEED)
    for label, target in (("ten bare distributions", m.target_spec),
                          ("ten Normals, the same means and sds", normals)):
        for leaps in (nl, n_leaps):
            _traj_time(label, target, th, row, leaps, 44, plain=leaps == nl)
    for Cx in Cs:
        thg = _cuda(0.6 + 0.1 * rng.standard_normal((Cx, d)))
        _ms_time("Gamma(3,0.2)", gam, thg, 0.05, k_ms, n_leaps, 46,
                 plain=Cx == C)
        _grad_time("Gamma(3,0.2)", gam, thg)
    _ms_time("ten bare distributions", m.target_spec, th, row, k_ms,
             n_leaps, 47)
    _grad_time("ten bare distributions", m.target_spec, th, model=m)
    for dd, Cx in ((32, 16_384), (33, C)):  # the widest lane block; warp
        gam_d = coordwise_logp(mt.Gamma(3.0, 0.2), dd)
        th_d = _cuda(0.6 + 0.1 * rng.standard_normal((Cx, dd)))
        _ms_time("Gamma(3,0.2)", gam_d, th_d, 0.05, k_ms, n_leaps, 48)
        _grad_time("Gamma(3,0.2)", gam_d, th_d)
    for dd, Cxs in ((d, rwm_Cs), (33, (16_384,)), (1000, (4096,))):
        normal = coordwise_logp(mt.Normal(1.0, 1.0), dd)
        scale = _cuda(np.full(dd, 1.1 if dd == d else 0.1))
        for Cx in Cxs:
            thr = _cuda(0.1 * rng.standard_normal((Cx, dd)))
            _rwm_time("Normal(1,1)", normal, thr, scale, k_rwm, 45)


def phase_target_path_spans(chains=4096, chains_small=1024,
                            rwm_chains=16_384):
    """The spans of the paths whose sampling runs kernels 5, 6 and 7, at the
    configurations of phase_target_paths and phase_warm_target_paths:
    HMC on Gamma(3, 0.2), Normal(1, 1) and Laplace(0, 1) and plain MALA on
    the Gamma model (d 10), adaptive HMC with a diagonal metric, adaptive
    MALA and ChEES on the ten bare distributions, run_target_rwm's
    sampling (16,384 chains, 10,000 steps, thin 100) and
    run_target_hmc_multistep's (4096 chains, 300 transitions, thin 10)."""
    import mcmc_jl_tpu_torch as mt
    from mcmc_jl_tpu_torch.ops import rwm_kernels as rk
    from mcmc_jl_tpu_torch.ops import target_kernels as tk

    def tilde(dist, x0):
        return mt.model(lambda x, _d=dist: mt.tilde(x, _d),
                        x=np.full(10, x0 + 0.5), gradient=True,
                        device="cuda")

    gamma = tilde(mt.Gamma(3.0, 0.2), 0.6)
    bare, _ = _ten_bare_model()
    out = _timed_paths((
        ("HMC(10, 0.05) on Gamma(3,0.2) (kernel 5)", gamma, mt.HMC(10, 0.05),
         300, 100, chains),
        ("HMC(10, 0.8) on Normal(1,1) (kernel 5)",
         tilde(mt.Normal(1.0, 1.0), 1.0), mt.HMC(10, 0.8), 300, 100, chains),
        ("HMC(10, 0.5) on Laplace(0,1) (kernel 5)",
         tilde(mt.Laplace(0.0, 1.0), 0.0), mt.HMC(10, 0.5), 300, 100,
         chains),
        ("MALA(0.02) on Gamma(3,0.2) (kernel 5)", gamma, mt.MALA(0.02), 1000,
         300, chains),
        ("adaptive HMC diag on the ten bare distributions (kernel 5)", bare,
         mt.HMC(10, 0.02, mt.EmpMCTuner(0.8, adapt_step=50),
                mass_adapt="diag"), 3500, 500, chains),
        ("adaptive MALA on the ten bare distributions (kernel 5)", bare,
         mt.MALA(0.002, mt.EmpMCTuner(0.574, adapt_step=50)), 1000, 200,
         chains_small),
        ("ChEES on the ten bare distributions (kernel 5)", bare,
         mt.ChEESHMC(len0=0.5, max_leaps=64), 1000, 200, chains)))
    for label, C, steps, fn in (
            ("run_target_rwm(Normal(1,1), 16384 chains, 10000 steps) "
             "(kernel 7)", rwm_chains, 10_000,
             lambda: rk.run_target_rwm(
                 tk.coordwise_logp(mt.Normal(1.0, 1.0), 10), 10, rwm_chains,
                 10_000, scale=1.1, thin=100, seed=4, device="cuda")),
            ("run_target_hmc_multistep(Gamma(3,0.2), 4096 chains, 300 "
             "transitions) (kernel 6)", chains, 300,
             lambda: tk.run_target_hmc_multistep(
                 tk.coordwise_logp(mt.Gamma(3.0, 0.2), 10), 10, chains, 300,
                 thin=10, n_leaps=10, eps=0.05, seed=3,
                 inits=np.full((chains, 10), 1.1, np.float32),
                 device="cuda"))):
        out[label] = {"sampling_s": _time(fn, reps=3)}
        emit({"phase": "path_spans", "path": label, "chains": C,
              "steps": steps, **out[label], **CARD})
    return out


def _timed_paths(runs):
    """Host seconds (to a synchronize) of ``run(model * sampler *
    SerialMC(steps, burnin), chains=C)`` for each (name, model, sampler,
    steps, burnin, C) of ``runs``, split into warmup, sampling and
    packaging, after a short warm-up run of each.  No checks: the main
    phases hold these paths."""
    import mcmc_jl_tpu_torch as mt

    out = {}
    for name, model, sampler, steps, burnin, C in runs:
        mt.run(model * sampler * mt.SerialMC(steps=60, burnin=50), chains=C)
        task = model * sampler * mt.SerialMC(steps=steps, burnin=burnin)
        t0 = time.perf_counter()
        with _spans() as spans:
            mt.run(task, chains=C, seed=0)
        out[name] = {"total_s": time.perf_counter() - t0, **spans}
        emit({"phase": "path_spans", "path": name, "chains": C,
              "steps": steps, "burnin": burnin, **out[name], **CARD})
    return out


def phase_rows_spans(chains=4096, chains_small=1024):
    """The spans of the four GLM paths whose sampling runs kernel 3b, at
    the configurations of phase_warm_paths and phase_chees_glm_path (N
    1000, every chain from the posterior mode)."""
    import mcmc_jl_tpu_torch as mt

    X, Y, mode = _bench_mode(1000)
    m = mt.model(glm=("logistic", X, Y), init=mode, device="cuda")
    return _timed_paths((
        ("adaptive HMC diag (kernel 3b)", m, mt.HMC(10, 0.02, mt.EmpMCTuner(
            0.8, adapt_step=50), mass_adapt="diag"), 2000, 500, chains),
        ("HMCDA (kernel 3b)", m, mt.HMCDA(), 1000, 200, chains_small),
        ("adaptive MALA (kernel 3b)", m, mt.MALA(0.002, mt.EmpMCTuner(
            0.574, adapt_step=50)), 1000, 200, chains_small),
        ("ChEES (kernel 3b)", m, mt.ChEESHMC(len0=0.5, max_leaps=64), 1000,
         200, chains)))


def phase_target_nuts_spans(chains=4096):
    """The spans of the two paths whose sampling runs kernel 8b, at the
    configurations of phase_warm_target_paths: NUTS(6) with and without a
    diagonal metric on the ten bare distributions, SerialMC(1500, 500)."""
    import mcmc_jl_tpu_torch as mt

    m, _ = _ten_bare_model()
    return _timed_paths((
        ("NUTS(6) on the ten bare distributions (kernel 8b)", m,
         mt.NUTS(maxdoublings=6), 1500, 500, chains),
        ("NUTS(6, diag) on the ten bare distributions (kernel 8b)", m,
         mt.NUTS(maxdoublings=6, mass_adapt="diag"), 1500, 500, chains)))


# each custom-target wrapper's __global__ function, as the profiler names it
KERNEL_SYMBOL = {"target_leapfrogs": ("leapfrogs_lane_kernel",
                                      "leapfrogs_kernel"),
                 "target_multistep": ("multistep_lane_kernel",
                                      "multistep_kernel"),
                 "target_rwm_steps": ("rwm_lane_kernel", "rwm_kernel"),
                 "target_logp_grad": ("logp_grad_lane_kernel",
                                      "logp_grad_kernel")}


def _device_ms(fn, symbol, reps=10):
    """Mean device milliseconds of the kernel named ``symbol`` (or any of a
    tuple of names) over ``reps`` calls of ``fn``, from torch.profiler's
    CUDA activity: the kernel alone, where ``_event_ms`` also counts the
    wrapper's host work between the two events (a short kernel waits for
    it).  None when the profiler records no device time for it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    names = (symbol,) if isinstance(symbol, str) else symbol
    us = [e.device_time_total for e in prof.key_averages()
          if any(n in e.key for n in names)]
    return sum(us) / reps / 1e3 if us and sum(us) > 0 else None


# ---- GLMs wider than 32 parameters: the wide tile's kernels, paths, times --

# the wide paths' width (tests/test_pallas_glm.py's wide case) and the widths
# the kernel checks take: the narrow tile's edge + 1, two wide tiles, the
# paths', and the wide tile's bound (glm_kernels.WIDE_D_MAX)
WIDE_D = 150
WIDE_CHECK_D = (33, 64, 150, 256)
# HMC step of the wide paths at N 1000 (posterior sds about 0.6) and of the
# kernel checks that want both accepts and rejects; at N 100,000 (sds about
# 0.06) the adaptive runs' initial step
WIDE_EPS, WIDE_STEP_EPS, WIDE_BIGN_EPS = 0.1, 0.3, 0.01
# the wide kernels' launch counters, each beside its narrow one
WIDE_KERNELS = ("glm_leapfrogs_wide", "glm_step_wide", "glm_multistep_wide",
                "glm_multistep_rows_wide", "glm_multistep_rows_mat_wide",
                "glm_logp_grad_tiled_wide", "glm_logp_grad_tiled_mat_wide")
_WIDE_MODES = {}


def wide_data(n=1000, d=WIDE_D):
    """bench.py's ``_data`` at d parameters, scaled as
    tests/test_pallas_glm.py's wide case: an intercept and d - 1 standard
    normal columns, all divided by sqrt(d), and a response drawn at
    standard normal coefficients, from numpy seed 1."""
    rng = np.random.default_rng(1)
    X = np.column_stack([np.ones(n), rng.standard_normal((n, d - 1))]) \
        / np.sqrt(d)
    beta0 = rng.standard_normal(d)
    Y = (rng.random(n) < 1.0 / (1.0 + np.exp(-X @ beta0))).astype(np.float64)
    return X, Y


def _wide_mode(n, d=WIDE_D, iters=12):
    """wide_data(n, d), its posterior mode (Newton steps in float64 on the
    card: numpy takes seconds a step at N 100,000) and the Laplace
    approximation's Cholesky factor of the covariance there (cached)."""
    import torch

    if (n, d) not in _WIDE_MODES:
        X, Y = wide_data(n, d)
        Xt = torch.as_tensor(X, device="cuda")
        Yt = torch.as_tensor(Y, device="cuda")
        b = torch.zeros(d, dtype=torch.float64, device="cuda")
        eye = torch.eye(d, dtype=torch.float64, device="cuda")
        for it in range(iters + 1):
            p = torch.sigmoid(Xt @ b)
            H = Xt.T @ (Xt * (p * (1 - p))[:, None]) + eye
            if it < iters:
                b = b + torch.linalg.solve(H, Xt.T @ (Yt - p) - b)
        L = torch.linalg.cholesky(torch.linalg.inv(H))
        _WIDE_MODES[n, d] = (X, Y, b.cpu().numpy(), L.cpu().numpy())
    return _WIDE_MODES[n, d]


def _wide_folds(n, d, C, seed, spread=0.1):
    """The three priors the wide kernels take, each on its own design, with
    C chains near the mode (``spread`` posterior sds): the scalar on X,
    the diagonal fold (X s, row s^2; s the Laplace sds) and the dense fold
    (X L, matrix L'L), chains in z.  {name: (XT, Y, theta, prior)}."""
    X, Y, mode, L = _wide_mode(n, d)
    rng = np.random.default_rng(seed)
    s = np.sqrt(np.sum(L * L, axis=1))
    theta = mode + spread * s * rng.standard_normal((C, d))
    XL, A = _dense_fold(X, L)
    Yc = _cuda(Y)
    return {"scalar": (_cuda(X.T), Yc, _cuda(theta), 1.0),
            "row": (_cuda((X * s).T), Yc, _cuda(theta / s), _cuda(s * s)),
            "matrix": (_cuda(XL.T), Yc,
                       _cuda(np.linalg.solve(L, theta.T).T), _cuda(A))}


def phase_wide_kernels(C=4096, ragged=1027, N=1000, Cb=512, Nb=100_000,
                       k=4, i0=501):
    """Kernels 1, 2, 3, 3b (and _mat) and 4 (and _mat) on the wide tile
    against their plain versions at d 33, 64, 150 and 256 (WIDE_CHECK_D):
    at d 150 at the wide paths' shapes (4096 chains at N 1000, 512 at N
    100,000), at the other widths on a ragged chain count (1027, and 300
    for kernel 4) and a ragged N (100,003 for kernel 4); rows streamed at
    N 1000 at every width, resident at d 33, N 300.  Chains start near
    the posterior mode of wide_data; 2, 3 and 3b at WIDE_STEP_EPS, where
    the plain versions both accept and reject, 3 and 3b over k = 4
    transitions (the host replays their draws: about 1 s for 8 at 4096
    chains and d 150); 3b with the diagonal fold's
    (d,) row and the dense fold's (d, d) matrix; kernel 1 also on every
    link with weights and offsets at d 64.  The tolerances are the narrow
    kernels' (phase_kernels, phase_tile_kernels, _tiled_case).  Returns
    the largest absolute error of each wide kernel."""
    from mcmc_jl_tpu_torch.ops import glm_kernels as gk

    err = dict.fromkeys(WIDE_KERNELS, 0.0)

    def keep(name, e):
        err[name] = max(err[name], e)

    for d in WIDE_CHECK_D:
        Cd = C if d == WIDE_D else ragged
        f = _wide_folds(N, d, Cd, seed=d)
        XT, Yc, th, _ = f["scalar"]
        rng = np.random.default_rng(d + 1)
        m0 = _cuda(rng.standard_normal((Cd, d)))
        logu = _cuda(np.log(rng.random(Cd)))
        label = f"wide tile, d {d}, N {N}, C {Cd}"
        keep("glm_leapfrogs_wide", _traj_check(label, XT, Yc, th, m0,
                                               WIDE_EPS, n_leaps=10))
        keep("glm_step_wide", _step_check(label, XT, Yc, th, m0, logu,
                                          WIDE_STEP_EPS, mix=True,
                                          n_leaps=10))
        keep("glm_multistep_wide", _multistep_check(
            label, XT, Yc, th, WIDE_STEP_EPS, k=k, seed=d, mix=True,
            n_leaps=10))
        for prior, name in (("row", "glm_multistep_rows_wide"),
                            ("matrix", "glm_multistep_rows_mat_wide")):
            XTf, _, thf, lam = f[prior]
            keep(name, _rows_check(f"{label}, {prior} fold", XTf, Yc, thf,
                                   WIDE_STEP_EPS, 10 * WIDE_STEP_EPS, i0,
                                   20, k, seed=d + 2, mix=True,
                                   prior_prec=lam))
        del f, XT, th, m0
    # kernel 1: every link with weights and offsets, the design scaled so
    # that z spreads as in phase_tile_kernels' d 7 cases (0.3 sqrt(7 / d)):
    # at 0.3 the d 64 Poisson posterior is so stiff (counts to 4415) that
    # the 2stage step 0.01 is unstable and any two roundings part in
    # overflow; then rows resident
    for kind in gk.KIND_CODES:
        XT, Yc, W, O, th, m = _glm_case(kind, N, 64, 300, seed=7,
                                        scale=0.3 * np.sqrt(7 / 64))
        keep("glm_leapfrogs_wide", _traj_check(
            f"wide tile, {kind}, weights+offsets, d 64", XT, Yc, th, m, 0.01,
            n_leaps=3, kind=kind, weights=W, offsets=O, prior_prec=1.5,
            integrator="2stage"))
    f = _wide_folds(300, 33, ragged, seed=3)
    XT, Yc, th, _ = f["scalar"]
    keep("glm_leapfrogs_wide", _traj_check(
        "wide tile, rows resident, d 33, N 300", XT, Yc, th,
        _cuda(np.random.default_rng(4).standard_normal((ragged, 33))),
        WIDE_EPS, n_leaps=10))
    # kernel 4
    for d in WIDE_CHECK_D:
        n4, c4 = (Nb, Cb) if d == WIDE_D else (Nb + 3, 300)
        f = _wide_folds(n4, d, c4, seed=d + 5, spread=0.3)
        for prior, name in (("scalar", "glm_logp_grad_tiled_wide"),
                            ("matrix", "glm_logp_grad_tiled_mat_wide")):
            XT, Yc, th, lam = f[prior]
            keep(name, _tiled_case(f"wide tile, d {d}, {prior} prior, "
                                   f"N {n4}, C {c4}", XT, Yc, th, lam=lam))
        del f
    return err


def phase_wide_paths(chains=4096, chains_bign=512, generic_chains=512,
                     steps=300, burnin=100, bign_steps=(70, 50),
                     thin=150, n=1000, n_bign=100_000):
    """A logistic regression of d = 150 (wide_data) through the port's entry
    points, every launch counted from zero over one run and every run held
    within Z_MAX standard errors of per-chain means against the generic
    engine (the route such a GLM took before the wide tile):

    - N 1000 from the model's init: ``run(HMC(10, WIDE_EPS) *
      SerialMC(300, 100), chains=4096)`` (kernel 1, once a transition;
      SerialMC(1000, 200) cut to (600, 200), then (300, 100), for the
      script's time), against the same task on 512 generic-engine chains;
      ``run_glm_hmc(fused_step=True)`` (2) and
      ``run_glm_hmc_multistep(thin=150)`` (3) from the same start for as
      many transitions, against that run's final states (phase_drivers);
      adaptive HMC with a diagonal and with a dense metric, ``HMC(10,
      WIDE_EPS, EmpMCTuner(0.8, 50), mass_adapt=...) * SerialMC(300,
      100)`` at 4096 chains (3b, 3b_mat: 200 sampling transitions as 25
      launches of 8), against the generic run; ``resume(chains, steps=120)``
      of the diagonal run (3b: 15 launches of 8);
    - N 100,000 from the posterior mode: ``HMC(10, WIDE_BIGN_EPS,
      EmpMCTuner(0.8, 50), mass_adapt=...) * SerialMC(70, 50)`` at 512
      chains, diagonal and dense (4, 4_mat; phase_large_n_paths'
      SerialMC(200, 50) cut to 20 sampling transitions, for the script's
      time), against plain ``HMC(10, WIDE_BIGN_EPS)`` on
      512 generic-engine chains from the same start.

    The generic reference runs are timed in full at 512 chains
    (phase_wide_path_times times each task through both routes at the
    same chains).  Returns the wide kernels' launches {name: (count,
    origin)} and the generic engine's per-chain means at N 1000 (the
    reference of phase_wide_nuts_paths)."""
    import mcmc_jl_tpu_torch as mt
    from mcmc_jl_tpu_torch.ops.glm_hmc import (run_glm_hmc,
                                              run_glm_hmc_multistep)

    X, Y, _, _ = _wide_mode(n)
    m = mt.model(glm=("logistic", X, Y), device="cuda")
    d = m.size
    counts = {}
    task = m * mt.HMC(10, WIDE_EPS) * mt.SerialMC(steps=steps, burnin=burnin)
    origin = _origin(m, task, chains)
    cs, samples, launches, dt, spans = _path(
        origin, task, chains, {"glm_leapfrogs_wide": steps})
    acc = float(np.mean([mt.acceptance(c) for c in cs[:512]])) / 100
    final = samples[:, -1]
    del cs
    t0 = time.perf_counter()
    cg = mt.run(task, chains=generic_chains, seed=1, fused=False)
    gen_s = time.perf_counter() - t0
    gmeans = np.stack([c.samples.values for c in cg]).mean(1)
    del cg
    z = _z_means(samples.mean(1), gmeans)
    emit({"phase": "wide_path", "kernel": "glm_leapfrogs_wide",
          "from": origin, "d": d, "chains": chains, "seconds": dt,
          "spans_s": spans, "launches": launches["glm_leapfrogs_wide"],
          "accept_rate": acc, "generic": {"chains": generic_chains,
                                          "seconds": gen_s},
          "z_max_vs_generic": z, "ok": z < Z_MAX, **CARD})
    assert z < Z_MAX, f"{origin} disagrees with the generic engine"
    counts["glm_leapfrogs_wide"] = (launches["glm_leapfrogs_wide"], origin)
    del samples

    inits = np.zeros_like(final)
    for name, origin_d, want, fn in (
            ("glm_step_wide", "run_glm_hmc(fused_step=True)", steps,
             lambda: run_glm_hmc(X, Y, chains, steps, n_leaps=10,
                                 eps=WIDE_EPS, seed=2, inits=inits,
                                 device="cuda", fused_step=True)),
            ("glm_multistep_wide", f"run_glm_hmc_multistep(thin={thin})",
             steps // thin,
             lambda: run_glm_hmc_multistep(X, Y, chains, steps, thin=thin,
                                           n_leaps=10, eps=WIDE_EPS, seed=3,
                                           inits=inits, device="cuda"))):
        t0 = time.perf_counter()
        (theta, _), launches = _counted(fn)
        dt = time.perf_counter() - t0
        assert launches == {**{k: 0 for k in launches}, name: want}, launches
        th = theta.double().cpu().numpy()
        assert th.shape == final.shape and np.all(np.isfinite(th))
        z = _z_means(th, final)
        origin_d = f"{origin_d} at d {d}, N {n}, {chains} chains"
        emit({"phase": "wide_driver", "kernel": name, "from": origin_d,
              "transitions": steps, "seconds": dt,
              "launches": launches[name], "z_max_vs_main_path": z,
              "ok": z < Z_MAX, **CARD})
        assert z < Z_MAX, f"{origin_d} disagrees with the main path"
        counts[name] = (launches[name], origin_d)

    held = None
    for ma, name in (("diag", "glm_multistep_rows_wide"),
                     ("dense", "glm_multistep_rows_mat_wide")):
        sampler = mt.HMC(10, WIDE_EPS, mt.EmpMCTuner(0.8, adapt_step=50),
                         mass_adapt=ma)
        task = m * sampler * mt.SerialMC(steps=steps, burnin=burnin)
        origin = _origin(m, task, chains)
        cs, samples, launches, dt, spans = _path(
            origin, task, chains, {name: (steps - burnin) // 8})
        st = cs[0].task.state
        z = _z_means(samples.mean(1), gmeans)
        emit({"phase": "wide_path", "kernel": name, "from": origin, "d": d,
              "chains": chains, "seconds": dt, "spans_s": spans,
              "launches": launches[name],
              "frozen_step": st.tune.step_size.item(),
              "frozen_n_leaps": st.tune.n_leaps.item(),
              "accept_rate": float(np.mean([mt.acceptance(c)
                                            for c in cs[:512]])) / 100,
              "z_max_vs_generic": z, "ok": z < Z_MAX, **CARD})
        assert z < Z_MAX, f"{origin} disagrees with the generic engine"
        counts[name] = (launches[name], origin)
        if held is None:
            held = [c.task for c in cs]
        del cs, samples
    label = f"adaptive HMC diag, d {d}, N {n}, kernel 3b wide"
    _resume_path(label, held, RESUME_STEPS,
                 {"glm_multistep_rows_wide": RESUME_STEPS // 8},
                 lambda s: _z_means(s.mean(1), gmeans), by_chain=False)
    del held

    nb, bb = bign_steps
    Xb, Yb, mode_b, _ = _wide_mode(n_bign)
    mb = mt.model(glm=("logistic", Xb, Yb), init=mode_b, device="cuda")
    ref_task = mb * mt.HMC(10, WIDE_BIGN_EPS) * mt.SerialMC(steps=nb,
                                                            burnin=bb)
    t0 = time.perf_counter()
    cg = mt.run(ref_task, chains=generic_chains, seed=1, fused=False)
    gen_b = time.perf_counter() - t0
    bmeans = np.stack([c.samples.values for c in cg]).mean(1)
    del cg
    for ma, name in (("diag", "glm_logp_grad_tiled_wide"),
                     ("dense", "glm_logp_grad_tiled_mat_wide")):
        task = mb * mt.HMC(10, WIDE_BIGN_EPS,
                           mt.EmpMCTuner(0.8, adapt_step=50),
                           mass_adapt=ma) * mt.SerialMC(steps=nb, burnin=bb)
        origin = _origin(mb, task, chains_bign)
        cs, samples, launches, dt, spans = _path(
            origin, task, chains_bign,
            {name: lambda n: n >= nb - bb + 1})
        st = cs[0].task.state
        z = _z_means(samples.mean(1), bmeans)
        emit({"phase": "wide_path", "kernel": name, "from": origin, "d": d,
              "chains": chains_bign, "seconds": dt, "spans_s": spans,
              "launches": launches[name],
              "frozen_step": st.tune.step_size.item(),
              "frozen_n_leaps": st.tune.n_leaps.item(),
              "accept_rate": float(np.mean([mt.acceptance(c)
                                            for c in cs])) / 100,
              "generic_reference": {"task": _origin(mb, ref_task,
                                                    generic_chains),
                                    "seconds": gen_b},
              "z_max_vs_generic": z, "ok": z < Z_MAX, **CARD})
        assert z < Z_MAX, f"{origin} disagrees with the generic engine"
        counts[name] = (launches[name], origin)
        del cs, samples
    return counts, gmeans


def phase_wide_path_times(chains=4096, chains_bign=512, steps=60, burnin=20,
                          n=1000, n_bign=100_000):
    """Host seconds (to a synchronize) of each wide path's task over a
    shortened SerialMC(60, 20), through the kernels and through the
    generic engine at the same chains, d and N: what the width cost before
    the wide tile (every such GLM took the generic engine).  Returns
    {path: {"fused_s", "generic_s"}}."""
    import torch

    import mcmc_jl_tpu_torch as mt

    X, Y, _, _ = _wide_mode(n)
    Xb, Yb, mode_b, _ = _wide_mode(n_bign)
    m = mt.model(glm=("logistic", X, Y), device="cuda")
    mb = mt.model(glm=("logistic", Xb, Yb), init=mode_b, device="cuda")
    runner = mt.SerialMC(steps=steps, burnin=burnin)
    ad = lambda eps, ma: mt.HMC(10, eps, mt.EmpMCTuner(  # noqa: E731
        0.8, adapt_step=50), mass_adapt=ma)
    out = {}
    for label, model, sampler, C in (
            ("HMC(10), N 1000, kernel 1", m, mt.HMC(10, WIDE_EPS), chains),
            ("adaptive HMC diag, N 1000, kernel 3b", m, ad(WIDE_EPS, "diag"),
             chains),
            ("adaptive HMC dense, N 1000, kernel 3b_mat", m,
             ad(WIDE_EPS, "dense"), chains),
            ("adaptive HMC diag, N 1e5, kernel 4", mb,
             ad(WIDE_BIGN_EPS, "diag"), chains_bign),
            ("adaptive HMC dense, N 1e5, kernel 4_mat", mb,
             ad(WIDE_BIGN_EPS, "dense"), chains_bign)):
        task = model * sampler * runner
        row = {}
        for key, fused in (("fused_s", "auto"), ("generic_s", False)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mt.run(task, chains=C, seed=0, fused=fused)
            torch.cuda.synchronize()
            row[key] = time.perf_counter() - t0
        out[label] = row
        emit({"phase": "wide_path_time", "path": label,
              "task": _origin(model, task, C), "d": model.size, **row,
              **CARD})
    return out


def _tier_times(tier, ds, at_d, N, Nb, C=4096, Cb=512, n_leaps=10, kt=8,
                i0=501, reps=3, folds=None, symbols=None, width=None,
                x_passes=None):
    """Per-call time of each kernel of ``tier`` ("wide", "xwide" or
    "chunked": the launch counters ``<name>_<tier>``, the kernels
    ``hmc_<tier>_kernel`` and ``partial_<tier>_kernel`` unless ``symbols``
    = (HMC kernel, N-tiled kernel) names them) at each d of ``ds``: kernels
    1, 2, 3 (k_trans ``kt``) and 3b (and _mat; ``kt`` transitions from i0
    at WIDE_STEP_EPS and T 10 eps, so about 10 leaps each) at N and C
    chains, kernel 4 (and _mat) at Nb and Cb chains, on the designs of
    ``folds`` (_wide_folds unless given); with CUDA events (the wrapper's
    host work included), torch.profiler's device time, the plain version
    on the card, the bound (the repo's: 4 d N operations a chain-gradient
    at 3xTF32, or the bytes), the padding waste D / d (D = ``width(d)``, d
    rounded up to 32 unless given) and, with ``x_passes``, the bytes of X
    the tiles read a gradient (``x_passes`` reads of the N x D design by
    each tile of 16 chains).  Returns ({kernel: (ms, plain ms)}, {kernel:
    bound}) at d ``at_d``."""
    import torch

    from mcmc_jl_tpu_torch.ops import glm_bign as gb
    from mcmc_jl_tpu_torch.ops import glm_kernels as gk

    folds = folds or _wide_folds
    hmc_sym, tiled_sym = symbols or (f"hmc_{tier}_kernel",
                                     f"partial_{tier}_kernel")
    width = width or (lambda d: -(-d // 32) * 32)
    ms, work = {}, {}
    for d in ds:
        D = width(d)
        f = folds(N, d, C, seed=d + 9)
        XT, Yc, th, _ = f["scalar"]
        rng = np.random.default_rng(d)
        m0 = _cuda(rng.standard_normal((C, d)))
        logu = _cuda(np.log(rng.random(C)))
        lp, g = _lp_grad(XT, Yc, th)
        lp = lp[:, None].contiguous()
        gen = lambda: torch.Generator(device="cuda").manual_seed(3)  # noqa: E731
        eps = WIDE_STEP_EPS
        T, ml = 10 * eps, 20
        nls = sum(_np_leaps(i, eps, T, ml) for i in range(i0, i0 + kt))
        calls = {
            f"glm_leapfrogs_{tier}": (
                lambda: gk.glm_leapfrogs(XT, Yc, th, m0, g, eps,
                                         n_leaps=n_leaps),
                lambda: gk.glm_leapfrogs_ref(XT, Yc, th, m0, g, eps,
                                             n_leaps=n_leaps),
                (XT, Yc, th, m0, g), C * n_leaps),
            f"glm_step_{tier}": (
                lambda: gk.glm_step(XT, Yc, th, g, lp, m0, logu[:, None],
                                    eps, n_leaps=n_leaps),
                lambda: gk.glm_step_ref(XT, Yc, th, g, lp, m0,
                                        logu[:, None], eps, n_leaps=n_leaps),
                (XT, Yc, th, g, lp, m0, logu), C * n_leaps),
            f"glm_multistep_{tier}": (
                lambda: gk.glm_multistep(XT, Yc, th, eps, k_trans=kt,
                                         n_leaps=n_leaps, generator=gen()),
                lambda: gk.glm_multistep_ref(XT, Yc, th, eps, k_trans=kt,
                                             n_leaps=n_leaps,
                                             generator=gen()),
                (XT, Yc, th), C * (1 + kt * n_leaps)),
        }
        for prior, name in (("row", f"glm_multistep_rows_{tier}"),
                            ("matrix", f"glm_multistep_rows_mat_{tier}")):
            XTf, _, thf, lam = f[prior]
            calls[name] = (
                lambda XTf=XTf, thf=thf, lam=lam: gk.glm_multistep_rows(
                    XTf, Yc, thf, eps, T, i0, ml, k_trans=kt,
                    generator=gen(), prior_prec=lam),
                lambda XTf=XTf, thf=thf, lam=lam: gk.glm_multistep_rows_ref(
                    XTf, Yc, thf, eps, T, i0, ml, k_trans=kt,
                    generator=gen(), prior_prec=lam),
                (XTf, Yc, thf, lam), C * (1 + nls))
        fb = folds(Nb, d, Cb, seed=d + 11, spread=0.3)
        for prior, name in (("scalar", f"glm_logp_grad_tiled_{tier}"),
                            ("matrix", f"glm_logp_grad_tiled_mat_{tier}")):
            XTb, Yb, thb, lam = fb[prior]
            calls[name] = (
                lambda XTb=XTb, Yb=Yb, thb=thb, lam=lam:
                    gb.glm_logp_grad_tiled(XTb, Yb, thb, prior_prec=lam),
                lambda XTb=XTb, Yb=Yb, thb=thb, lam=lam:
                    gb.glm_logp_grad_tiled_ref(XTb, Yb, thb, prior_prec=lam),
                (XTb, Yb, thb, lam), Cb)
        for name, (kern, plain, inputs, evals) in calls.items():
            n_obs = Nb if "tiled" in name else N
            nbytes = _nbytes(inputs, kern())
            bound = _bound(evals, d, n_obs, nbytes)
            t = (_event_ms(kern, reps=reps), _event_ms(plain, reps=2))
            symbols = ((tiled_sym, "reduce_kernel")
                       if "tiled" in name else (hmc_sym,))
            chains = Cb if "tiled" in name else C
            x_bytes = ({"x_bytes_a_gradient": x_passes * -(-chains // 16)
                        * 4 * n_obs * D} if x_passes else {})
            emit({"phase": f"{tier}_time", "name": name, "d": d, "D": D,
                  "padding_waste": D / d, "N": n_obs,
                  "C": chains, "evals": evals,
                  "ms": t[0], "plain_ms": t[1], **bound, **x_bytes,
                  "share_of_bound": bound["bound_ms"] / t[0],
                  "device_ms": _device_ms(kern, symbols, reps=reps),
                  "plan": (_plan(gb, "glm_tiled_plan", d) if "tiled" in name
                           else _plan(gk, "glm_leapfrogs_plan", d, n_obs)),
                  **CARD})
            if d == at_d:
                ms[name], work[name] = t, bound
        del f, fb, calls
    return ms, work


def phase_wide_times(Ns=(1000, 100_000), C=4096, Cb=512, n_leaps=10, kt=8,
                     i0=501, ds=(WIDE_D, 256)):
    """_tier_times of the wide kernels at d 150 (WIDE_D) and at the wide
    tile's bound (256) unless ``ds`` says otherwise, at the wide paths'
    shapes: 1-3b at N 1000 and 4096 chains, 4 at N 100,000 and 512
    chains.  Returns ({kernel: (ms, plain ms)}, {kernel: bound}) at d
    150."""
    return _tier_times("wide", ds, WIDE_D, Ns[0], Ns[1], C, Cb, n_leaps, kt,
                       i0)


# ---- exact NUTS on the wide tile (kernels 8 and 9, 32 < d <= 256) ----------

# the wide NUTS kernels' launch counters
WIDE_NUTS_KERNELS = ("glm_nuts_transition_wide", "glm_nuts_multistep_wide",
                     "glm_nuts_transition_mat_wide",
                     "glm_nuts_multistep_mat_wide")
# step of the wide NUTS checks and times, in the coordinates of each fold
# (posterior sds about 0.65 unfolded, 1 folded): trees of 3-6 doublings
# and both slice outcomes; the deep check at md 10 takes WIDE_NUTS_DEEP_EPS,
# where most trees run to the bound
WIDE_NUTS_EPS, WIDE_NUTS_DEEP_EPS = 0.1, 0.002
# the wide NUTS paths: SerialMC(steps, burnin) for kernel 9 (the sampling
# transitions split into launches of WIDE_NUTS_K) and steps - 3 for kernel
# 8 (a prime count of sampling transitions: one launch a transition)
WIDE_NUTS_RUN = (82, 26)
# the wide NUTS runs' resumes: kernel 9 (launches of 8) and kernel 8 (a
# prime count)
WIDE_NUTS_RESUME = (24, 23)


def _wide_nuts_inputs(XT, Y, th, md, seed, **kw):
    """A NUTS transition's inputs at (XT, Y, th) under a check's keywords
    (prior, link, weights, offsets): (XT, Y, th, lp, g) and one
    transition's pre-drawn noise from numpy seed ``seed``."""
    C, d = th.shape
    lp, g = _lp_grad(XT, Y, th, **kw)
    rng = np.random.default_rng(seed)
    noise = (rng.standard_normal((C, d)), np.log(rng.random(C)),
             np.where(rng.random((C, md)) < 0.5, 1.0, -1.0),
             rng.random((C, md)), rng.random((C, 1 << md)))
    return (XT, Y, th, lp, g), tuple(_cuda(a) for a in noise)


def phase_wide_nuts_kernels(C=4096, ragged=1027, N=1000, md=6, k=3):
    """Kernels 8 and 9 (and their _mat forms) on the wide tile against
    their plain versions, held to the narrow checks' rules (_nuts_check,
    _nuts_ms_check: PATH_AGREE of the chains on the plain version's
    discrete path, theta, g and lp within the narrow tolerances there,
    bitwise repeats): kernel 8 on shared pre-drawn noise, kernel 9 chain by
    chain on its own Philox draws replayed by glm_nuts_multistep_draws.  At
    d 33, 64, 150 and 256 (WIDE_CHECK_D) with chains near the posterior
    mode of wide_data, N 1000 (rows streamed), slice and multinomial at md
    6: 4096 chains at d 150 with the scalar prior, the diagonal fold's (d,)
    row and the dense fold's (d, d) matrix; a ragged 1027 chains at the
    other widths; at d 256 also md 10 (the largest scratch) at
    WIDE_NUTS_DEEP_EPS, where trees reach the bound; every link with
    weights and offsets at d 64 (phase_wide_kernels' design scale).
    Returns the largest theta error of each wide NUTS kernel."""
    from mcmc_jl_tpu_torch.ops import glm_kernels as gk

    err = dict.fromkeys(WIDE_NUTS_KERNELS, 0.0)
    check = functools.partial(_nuts_checks, err, "_wide", k=k)

    for d in WIDE_CHECK_D:
        Cd = C if d == WIDE_D else ragged
        f = _wide_folds(N, d, Cd, seed=d + 20)
        priors = ("scalar", "row", "matrix") if d == WIDE_D else ("scalar",)
        for prior in priors:
            XT, Yc, th, lam = f[prior]
            args, noise = _wide_nuts_inputs(XT, Yc, th, md, d + 21,
                                            prior_prec=lam)
            for multinomial in ((False,) if prior == "row"
                                else (False, True)):
                label = (f"wide tile, d {d}, C {Cd}, {prior} prior, "
                         f"{'multinomial' if multinomial else 'slice'}, "
                         f"md {md}")
                kw = dict(maxdoublings=md, prior_prec=lam,
                          multinomial=multinomial)
                check(label, args, noise, WIDE_NUTS_EPS, kw, seed=d + 22)
        if d == gk.WIDE_D_MAX:  # the deepest trees: md 10, most scratch
            XT, Yc, th, _ = f["scalar"]
            args, noise = _wide_nuts_inputs(XT, Yc, th, 10, d + 23)
            check(f"wide tile, d {d}, C {Cd}, slice, md 10, eps "
                  f"{WIDE_NUTS_DEEP_EPS}", args, noise, WIDE_NUTS_DEEP_EPS,
                  dict(maxdoublings=10), seed=d + 24, k=2, full_depth=True)
        del f
    for i, kind in enumerate(gk.KIND_CODES):
        XT, Yc, W, O, th, _ = _glm_case(kind, N, 64, 300, seed=7,
                                        scale=0.3 * np.sqrt(7 / 64))
        kw = dict(kind=kind, weights=W, offsets=O, prior_prec=1.5)
        args, noise = _wide_nuts_inputs(XT, Yc, th, md, 30 + i, **kw)
        multinomial = kind in ("linear", "probit")
        check(f"wide tile, {kind}, weights+offsets, d 64, C 300, "
              f"{'multinomial' if multinomial else 'slice'}", args, noise,
              0.02, dict(kw, maxdoublings=md, multinomial=multinomial),
              seed=40 + i)
    return err


def _nuts_routes(ds, n=1000):
    """The route of NUTS on wide_data at each d of ``ds``: the exact-NUTS
    kernels, "nuts", for a run and a continuation, up to the kernels'
    bound NUTS_D_MAX (16384, the GLM kernels' D_MAX); above it the generic
    engine, with the reason naming the GLM kernels' bound, for both; no
    reason that names a NUTS width.  Returns {d: (route, reason or
    None)}."""
    import logging

    import mcmc_jl_tpu_torch as mt
    from mcmc_jl_tpu_torch.core.task import MCMCTask
    from mcmc_jl_tpu_torch.ops.nuts_kernels import NUTS_D_MAX
    from mcmc_jl_tpu_torch.parallel import pchains

    seen = []
    handler = logging.Handler()
    handler.emit = lambda rec: seen.append(rec.getMessage())
    log = logging.getLogger(pchains.__name__)
    level = log.level
    log.addHandler(handler)
    log.setLevel(logging.INFO)
    out = {}
    try:
        for d in ds:
            want = "nuts" if d <= NUTS_D_MAX else False
            X, Y = wide_data(n, d)
            m = mt.model(glm=("logistic", X, Y), device="cuda")
            sampler = mt.NUTS(6)
            seen.clear()
            route = pchains._route(MCMCTask(m, sampler, mt.SerialMC(
                steps=WIDE_NUTS_RUN[0], burnin=WIDE_NUTS_RUN[1])), "auto")
            cont = pchains.continuation_route(m, sampler, 4, "auto")
            why = [t for t in seen if "the GLM kernels' bound" in t]
            assert route == cont == want, (d, route, cont, seen)
            assert bool(why) == (want is False) and len(why) in (0, 2), seen
            assert not any("NUTS on GLMs wider than" in t or
                           "NUTS kernels' width" in t for t in seen), seen
            out[d] = (route or "generic engine", why[0] if why else None)
            emit({"phase": "nuts_route", "d": d, "route": out[d][0],
                  "continuation_route": cont or "generic engine",
                  "reason": out[d][1]})
    finally:
        log.removeHandler(handler)
        log.setLevel(level)
    return out


def phase_wide_nuts_paths(gmeans, chains=4096, run=WIDE_NUTS_RUN, n=1000):
    """Exact NUTS on the d 150 logistic regression (wide_data, N 1000, from
    the model's init) through the port's entry points, every launch
    counted from zero over one run, each run's per-chain means held within
    Z_MAX standard errors of ``gmeans`` (the generic engine's, 512 chains,
    phase_wide_paths): ``NUTS(6) * SerialMC(*run)`` (kernel 9 on the wide
    tile), ``NUTS(6, mass_adapt="diag")`` with three steps fewer (a prime
    count of sampling transitions: kernel 8), ``NUTS(6,
    mass_adapt="dense") * SerialMC(*run)`` (9 mat), then
    ``resume(chains, steps=24)`` of the unit-metric run (9) and
    ``resume(chains, steps=23)`` of the dense run (8 mat), with
    _resume_path's checks.  The warmups run on the generic engine (cut to
    26 transitions, and the runs to (82, 26), for the script's time).
    First the routes at d 150, 256 and 257 (_nuts_routes: the kernels
    since d 257 runs on the very-wide tile).  Returns the wide NUTS
    kernels' launches {name: (count, origin)}."""
    import mcmc_jl_tpu_torch as mt
    from mcmc_jl_tpu_torch.ops.warmstart import _pick_k_trans

    _nuts_routes((WIDE_D, 256, 257), n)
    X, Y, _, _ = _wide_mode(n)
    m = mt.model(glm=("logistic", X, Y), device="cuda")
    d = m.size
    steps, burnin = run
    kept = steps - burnin
    counts, held = {}, {}
    for label, sampler, S, name, want in (
            ("unit", mt.NUTS(6), steps, "glm_nuts_multistep_wide",
             kept // _pick_k_trans(kept)),
            ("diag", mt.NUTS(6, mass_adapt="diag"), steps - 3,
             "glm_nuts_transition_wide", kept - 3),
            ("dense", mt.NUTS(6, mass_adapt="dense"), steps,
             "glm_nuts_multistep_mat_wide", kept // _pick_k_trans(kept))):
        assert name != "glm_nuts_transition_wide" or \
            _pick_k_trans(kept - 3) == 1
        task = m * sampler * mt.SerialMC(steps=S, burnin=burnin)
        origin = _origin(m, task, chains)
        cs, samples, launches, dt, spans = _path(origin, task, chains,
                                                 {name: want})
        dg = {k: np.stack([c.diagnostics[k] for c in cs])
              for k in ("accept", "ndoublings", "diverging", "epsilon")}
        z = _z_means(samples.mean(1), gmeans)
        emit({"phase": "wide_nuts_path", "kernel": name, "from": origin,
              "d": d, "chains": chains, "seconds": dt, "spans_s": spans,
              "launches": launches[name],
              "frozen_eps": float(dg["epsilon"][0, -1]),
              "accept_rate": float(dg["accept"].mean()),
              "mean_ndoublings": float(dg["ndoublings"].mean()),
              "diverging_share": float(dg["diverging"].mean()),
              "z_max_vs_generic": z, "ok": z < Z_MAX, **CARD})
        assert z < Z_MAX, f"{origin} disagrees with the generic engine"
        counts[name] = (launches[name], origin)
        if label != "diag":
            held[label] = [c.task for c in cs]
        del cs, samples
    moments = lambda s: _z_means(s.mean(1), gmeans)  # noqa: E731
    for label, name, S in (
            ("unit", "glm_nuts_multistep_wide", WIDE_NUTS_RESUME[0]),
            ("dense", "glm_nuts_transition_mat_wide", WIDE_NUTS_RESUME[1])):
        want = S // _pick_k_trans(S) if "multistep" in name else S
        origin = f"resume(NUTS(6{', dense' if label == 'dense' else ''}) " \
                 f"chains of d {d}, steps={S})"
        _resume_path(origin, held.pop(label), S, {name: want}, moments,
                     by_chain=False)
        counts.setdefault(name, (want, origin))
    return counts


def phase_wide_nuts_times(C=4096, N=1000, md=6, k_trans=5, ds=None):
    """Per-launch time of kernels 8 and 9 (k_trans 5) and their _mat forms
    on the wide tile at each d of ``ds`` (default d 150 (WIDE_D) and 256;
    the full run takes d 150 alone), N 1000, 4096 chains drawn
    from the Laplace approximation at the mode (the scalar prior; the
    dense fold's matrix with chains in z), at WIDE_NUTS_EPS and md 6, with
    _nuts_kernel_times' columns (events, device ms, plain version, leaves,
    tile passes, bound, occupancy and scratch plan); then kernel 8 at d 256
    and md 10 at WIDE_NUTS_DEEP_EPS (the deepest trees, 65 MB of scratch:
    what L2 contention costs a tile pass), without its plain version.
    Returns ({kernel: (ms, plain ms)}, {kernel: bound}) at d 150."""
    from mcmc_jl_tpu_torch.ops import glm_kernels as gk

    ms, work = {}, {}
    for d in (WIDE_D, gk.WIDE_D_MAX) if ds is None else ds:
        f = _wide_folds(N, d, C, seed=d + 31, spread=1.0)
        for prior in ("scalar", "matrix"):
            XT, Yc, th, lam = f[prior]
            lp, g = _lp_grad(XT, Yc, th, prior_prec=lam)
            lines = _nuts_kernel_times(
                XT, Yc, th, lp, g, WIDE_NUTS_EPS, md, k_trans, seed=d + 32,
                prior=lam, device_reps=3)
            if d == WIDE_D:
                for name, t in lines.items():
                    ms[name] = (t["ms"], t["plain_ms"])
                    work[name] = {k: t[k] for k in ("bound_ms", "bound_by")}
        if d == gk.WIDE_D_MAX:
            XT, Yc, th, _ = f["scalar"]
            lp, g = _lp_grad(XT, Yc, th)
            _nuts_kernel_times(XT, Yc, th, lp, g, WIDE_NUTS_DEEP_EPS, 10, 1,
                               seed=d + 33, plain=False, multistep=False,
                               device_reps=3)
        del f
    return ms, work


def phase_wide_nuts_path_times(chains=4096, steps=60, burnin=20, n=1000):
    """Host seconds (to a synchronize) of each wide NUTS path's task over a
    shortened SerialMC(60, 20) (kernel 8's: 59), through the kernels and
    through the generic engine at the same chains: what the width cost
    before the wide NUTS kernels (every such GLM under NUTS took the
    generic engine).  Returns {path: {"fused_s", "generic_s"}}."""
    import torch

    import mcmc_jl_tpu_torch as mt

    X, Y, _, _ = _wide_mode(n)
    m = mt.model(glm=("logistic", X, Y), device="cuda")
    out = {}
    for label, sampler, S in (
            ("NUTS(6), kernel 9", mt.NUTS(6), steps),
            ("NUTS(6, diag), kernel 8", mt.NUTS(6, mass_adapt="diag"),
             steps - 1),
            ("NUTS(6, dense), kernel 9 mat", mt.NUTS(6, mass_adapt="dense"),
             steps)):
        task = m * sampler * mt.SerialMC(steps=S, burnin=burnin)
        row = {}
        for key, fused in (("fused_s", "auto"), ("generic_s", False)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with _spans() as spans:
                mt.run(task, chains=chains, seed=0, fused=fused)
            torch.cuda.synchronize()
            row[key] = time.perf_counter() - t0
            row[key.replace("_s", "_spans_s")] = dict(spans)
        out[label] = row
        emit({"phase": "wide_nuts_path_time", "path": label,
              "task": _origin(m, task, chains), "d": m.size, **row,
              **CARD})
    return out


# ---- GLMs wider than 256 parameters: the very-wide tile's kernels, paths --

# the very-wide paths' width (the kernels' bound D_MAX) and the widths the
# kernel checks take: the wide tile's bound + 1, a middle width, the bound
XWIDE_D = 1024
XWIDE_CHECK_D = (257, 512, 1024)
# the widths the very-wide kernels are timed at
XWIDE_TIME_D = (512, 1024)
# observations of the large-N path (above BIGN_THRESHOLD: kernel 4; X is
# 82 MB at d 1024)
XWIDE_N_BIGN = 20_000
# HMC step of the very-wide paths at N 1000 (posterior sds about 0.9) and at
# N 20,000 (about 0.4)
XWIDE_EPS, XWIDE_BIGN_EPS = 0.1, 0.05
# the very-wide kernels' launch counters
XWIDE_KERNELS = tuple(n.replace("_wide", "_xwide") for n in WIDE_KERNELS)


def phase_xwide_kernels(ragged=1027, N=1000, Cb=512, Nb=XWIDE_N_BIGN, k=4,
                        i0=501):
    """Kernels 1, 2, 3, 3b (and _mat) and 4 (and _mat) on the very-wide
    tile against their plain versions at d 257, 512 and 1024
    (XWIDE_CHECK_D), on a ragged chain count (1027; the host replays the
    Philox draws of 3 and 3b, 1 s for 4 transitions of 1027 chains at d
    1024, 4 s at 4096 chains, so they run k = 4 transitions, and
    phase_xwide_times and phase_xwide_paths take the paths' 4096), kernel
    4 at d 1024 at its path's shape (512 chains, N 20,000), elsewhere on
    300 chains and a ragged N (20,003); every streamed tile count ragged
    (R 64, 32 and 16 rows do not divide N).  Chains start near the
    posterior mode of wide_data; 2, 3 and 3b at WIDE_STEP_EPS, where the
    plain versions both accept and reject; 3b and 4 with the scalar
    prior, the diagonal fold's (d,) row
    and the dense fold's (d, d) matrix; kernel 1 also on every link with
    weights and offsets at d 512.  The tolerances are the narrow and wide
    kernels' (phase_kernels, phase_tile_kernels, _tiled_case).  Returns
    the largest absolute error of each very-wide kernel."""
    from mcmc_jl_tpu_torch.ops import glm_kernels as gk

    err = dict.fromkeys(XWIDE_KERNELS, 0.0)

    def keep(name, e):
        err[name] = max(err[name], e)

    for d in XWIDE_CHECK_D:
        f = _wide_folds(N, d, ragged, seed=d)
        XT, Yc, th, _ = f["scalar"]
        rng = np.random.default_rng(d + 1)
        m0 = _cuda(rng.standard_normal((ragged, d)))
        logu = _cuda(np.log(rng.random(ragged)))
        label = f"very-wide tile, d {d}, N {N}, C {ragged}"
        keep("glm_leapfrogs_xwide", _traj_check(label, XT, Yc, th, m0,
                                                XWIDE_EPS, n_leaps=10))
        keep("glm_step_xwide", _step_check(label, XT, Yc, th, m0, logu,
                                           WIDE_STEP_EPS, mix=True,
                                           n_leaps=10))
        keep("glm_multistep_xwide", _multistep_check(
            label, XT, Yc, th, WIDE_STEP_EPS, k=k, seed=d, mix=True,
            n_leaps=10))
        for prior, name in (("scalar", "glm_multistep_rows_xwide"),
                            ("row", "glm_multistep_rows_xwide"),
                            ("matrix", "glm_multistep_rows_mat_xwide")):
            XTf, _, thf, lam = f[prior]
            keep(name, _rows_check(f"{label}, {prior} prior", XTf, Yc, thf,
                                   WIDE_STEP_EPS, 10 * WIDE_STEP_EPS, i0,
                                   20, k, seed=d + 2, mix=True,
                                   prior_prec=lam))
        del f, XT, th, m0
    # kernel 1: every link with weights and offsets at d 512, the design
    # scaled as the wide phase's d 64 case (0.3 sqrt(7 / d))
    for kind in gk.KIND_CODES:
        XT, Yc, W, O, th, m = _glm_case(kind, N, 512, 300, seed=8,
                                        scale=0.3 * np.sqrt(7 / 512))
        keep("glm_leapfrogs_xwide", _traj_check(
            f"very-wide tile, {kind}, weights+offsets, d 512", XT, Yc, th, m,
            0.01, n_leaps=3, kind=kind, weights=W, offsets=O, prior_prec=1.5,
            integrator="2stage"))
    # kernel 4
    for d in XWIDE_CHECK_D:
        n4, c4 = (Nb, Cb) if d == XWIDE_D else (Nb + 3, 300)
        f = _wide_folds(n4, d, c4, seed=d + 5, spread=0.3)
        for prior, name in (("scalar", "glm_logp_grad_tiled_xwide"),
                            ("row", "glm_logp_grad_tiled_xwide"),
                            ("matrix", "glm_logp_grad_tiled_mat_xwide")):
            XT, Yc, th, lam = f[prior]
            keep(name, _tiled_case(f"very-wide tile, d {d}, {prior} prior, "
                                   f"N {n4}, C {c4}", XT, Yc, th, lam=lam))
        del f
    return err


def phase_xwide_paths(chains=4096, chains_dense=512, chains_bign=512,
                      generic_chains=512, steps=106, burnin=50,
                      bign_steps=(50, 30), thin=53, n=1000,
                      n_bign=XWIDE_N_BIGN):
    """A logistic regression of d = 1024 (wide_data) through the port's
    entry points, every launch counted from zero over one run (a run that
    fell back to the generic engine would launch none) and every run held
    within Z_MAX standard errors of per-chain means against the generic
    engine (the route such a GLM took before the very-wide tile):

    - N 1000 from the model's init: ``run(HMC(10, XWIDE_EPS) *
      SerialMC(106, 50), chains=4096)`` (kernel 1, once a transition),
      against the same task on 512 generic-engine chains;
      ``run_glm_hmc(fused_step=True)`` (2) and
      ``run_glm_hmc_multistep(thin=53)`` (3) from the same start for as
      many transitions, against that run's final states; adaptive HMC
      with a diagonal metric at 4096 chains and a dense one at 512,
      ``HMC(10, XWIDE_EPS, EmpMCTuner(0.8, 50), mass_adapt=...) *
      SerialMC(106, 50)`` (3b, 3b_mat: 56 sampling transitions as 7
      launches of 8), against the generic run (the dense run's generic
      warmup keeps a (d, d) factor and accumulator a chain: 4 GB each at
      4096 chains, so it runs 512);
    - N 20,000 from the posterior mode: ``HMC(10, XWIDE_BIGN_EPS,
      EmpMCTuner(0.8, 50), mass_adapt=...) * SerialMC(50, 30)`` at 512
      chains, diagonal and dense (4, 4_mat), against plain ``HMC(10,
      XWIDE_BIGN_EPS)`` on 512 generic-engine chains from the same start.

    Returns the very-wide kernels' launches {name: (count, origin)} and
    the kernel-1 run's per-chain means (4096, d), phase_xwide_nuts_paths'
    reference."""
    import mcmc_jl_tpu_torch as mt
    from mcmc_jl_tpu_torch.ops.glm_hmc import (run_glm_hmc,
                                              run_glm_hmc_multistep)

    X, Y, _, _ = _wide_mode(n, XWIDE_D)
    m = mt.model(glm=("logistic", X, Y), device="cuda")
    d = m.size
    counts = {}
    task = m * mt.HMC(10, XWIDE_EPS) * mt.SerialMC(steps=steps,
                                                   burnin=burnin)
    origin = _origin(m, task, chains)
    cs, samples, launches, dt, spans = _path(
        origin, task, chains, {"glm_leapfrogs_xwide": steps})
    acc = float(np.mean([mt.acceptance(c) for c in cs[:512]])) / 100
    final = samples[:, -1]
    del cs
    t0 = time.perf_counter()
    cg = mt.run(task, chains=generic_chains, seed=1, fused=False)
    gen_s = time.perf_counter() - t0
    gmeans = np.stack([c.samples.values for c in cg]).mean(1)
    del cg
    z = _z_means(samples.mean(1), gmeans)
    emit({"phase": "xwide_path", "kernel": "glm_leapfrogs_xwide",
          "from": origin, "d": d, "chains": chains, "seconds": dt,
          "spans_s": spans, "launches": launches["glm_leapfrogs_xwide"],
          "accept_rate": acc, "generic": {"chains": generic_chains,
                                          "seconds": gen_s},
          "z_max_vs_generic": z, "ok": z < Z_MAX, **CARD})
    assert z < Z_MAX, f"{origin} disagrees with the generic engine"
    counts["glm_leapfrogs_xwide"] = (launches["glm_leapfrogs_xwide"], origin)
    hmc_means = samples.mean(1)
    del samples

    inits = np.zeros_like(final)
    for name, origin_d, want, fn in (
            ("glm_step_xwide", "run_glm_hmc(fused_step=True)", steps,
             lambda: run_glm_hmc(X, Y, chains, steps, n_leaps=10,
                                 eps=XWIDE_EPS, seed=2, inits=inits,
                                 device="cuda", fused_step=True)),
            ("glm_multistep_xwide", f"run_glm_hmc_multistep(thin={thin})",
             steps // thin,
             lambda: run_glm_hmc_multistep(X, Y, chains, steps, thin=thin,
                                           n_leaps=10, eps=XWIDE_EPS, seed=3,
                                           inits=inits, device="cuda"))):
        t0 = time.perf_counter()
        (theta, _), launches = _counted(fn)
        dt = time.perf_counter() - t0
        assert launches == {**{k: 0 for k in launches}, name: want}, launches
        th = theta.double().cpu().numpy()
        assert th.shape == final.shape and np.all(np.isfinite(th))
        z = _z_means(th, final)
        origin_d = f"{origin_d} at d {d}, N {n}, {chains} chains"
        emit({"phase": "xwide_driver", "kernel": name, "from": origin_d,
              "transitions": steps, "seconds": dt,
              "launches": launches[name], "z_max_vs_main_path": z,
              "ok": z < Z_MAX, **CARD})
        assert z < Z_MAX, f"{origin_d} disagrees with the main path"
        counts[name] = (launches[name], origin_d)

    for ma, name, C in (("diag", "glm_multistep_rows_xwide", chains),
                        ("dense", "glm_multistep_rows_mat_xwide",
                         chains_dense)):
        sampler = mt.HMC(10, XWIDE_EPS, mt.EmpMCTuner(0.8, adapt_step=50),
                         mass_adapt=ma)
        task = m * sampler * mt.SerialMC(steps=steps, burnin=burnin)
        origin = _origin(m, task, C)
        cs, samples, launches, dt, spans = _path(
            origin, task, C, {name: (steps - burnin) // 8})
        st = cs[0].task.state
        z = _z_means(samples.mean(1), gmeans)
        emit({"phase": "xwide_path", "kernel": name, "from": origin, "d": d,
              "chains": C, "seconds": dt, "spans_s": spans,
              "launches": launches[name],
              "frozen_step": st.tune.step_size.item(),
              "frozen_n_leaps": st.tune.n_leaps.item(),
              "accept_rate": float(np.mean([mt.acceptance(c)
                                            for c in cs[:512]])) / 100,
              "z_max_vs_generic": z, "ok": z < Z_MAX, **CARD})
        assert z < Z_MAX, f"{origin} disagrees with the generic engine"
        counts[name] = (launches[name], origin)
        del cs, samples

    nb, bb = bign_steps
    Xb, Yb, mode_b, _ = _wide_mode(n_bign, XWIDE_D)
    mb = mt.model(glm=("logistic", Xb, Yb), init=mode_b, device="cuda")
    ref_task = mb * mt.HMC(10, XWIDE_BIGN_EPS) * mt.SerialMC(steps=nb,
                                                             burnin=bb)
    t0 = time.perf_counter()
    cg = mt.run(ref_task, chains=generic_chains, seed=1, fused=False)
    gen_b = time.perf_counter() - t0
    bmeans = np.stack([c.samples.values for c in cg]).mean(1)
    del cg
    for ma, name in (("diag", "glm_logp_grad_tiled_xwide"),
                     ("dense", "glm_logp_grad_tiled_mat_xwide")):
        task = mb * mt.HMC(10, XWIDE_BIGN_EPS,
                           mt.EmpMCTuner(0.8, adapt_step=50),
                           mass_adapt=ma) * mt.SerialMC(steps=nb, burnin=bb)
        origin = _origin(mb, task, chains_bign)
        cs, samples, launches, dt, spans = _path(
            origin, task, chains_bign,
            {name: lambda n: n >= nb - bb + 1})
        st = cs[0].task.state
        z = _z_means(samples.mean(1), bmeans)
        emit({"phase": "xwide_path", "kernel": name, "from": origin, "d": d,
              "chains": chains_bign, "seconds": dt, "spans_s": spans,
              "launches": launches[name],
              "frozen_step": st.tune.step_size.item(),
              "frozen_n_leaps": st.tune.n_leaps.item(),
              "accept_rate": float(np.mean([mt.acceptance(c)
                                            for c in cs])) / 100,
              "generic_reference": {"task": _origin(mb, ref_task,
                                                    generic_chains),
                                    "seconds": gen_b},
              "z_max_vs_generic": z, "ok": z < Z_MAX, **CARD})
        assert z < Z_MAX, f"{origin} disagrees with the generic engine"
        counts[name] = (launches[name], origin)
        del cs, samples
    return counts, hmc_means


def phase_xwide_times(C=4096, Cb=512, N=1000, Nb=XWIDE_N_BIGN, n_leaps=10,
                      kt=8, i0=501, path_steps=(8, 4), ds=XWIDE_TIME_D,
                      paths=True):
    """_tier_times of the very-wide kernels at d 512 and 1024
    (XWIDE_TIME_D; or the widths ``ds``) at the very-wide paths' shapes:
    1-3b at N 1000 and 4096 chains, 4 at N 20,000 and 512 chains (events
    and device ms over 2 launches).  Then, with ``paths``, the host
    seconds (to a synchronize) of plain HMC(10) over SerialMC(8, 4) at
    4096 chains and N 1000 (kernel 1) at those widths, and of adaptive HMC
    diag over the same runner at N 20,000 and 512 chains (kernel 4) at d
    1024, through the kernels and through the generic engine at the same
    chains.  Returns ({kernel: (ms, plain ms)}, {kernel: bound}) at d
    1024."""
    import torch

    import mcmc_jl_tpu_torch as mt

    ms, work = _tier_times("xwide", ds, XWIDE_D, N, Nb, C, Cb,
                           n_leaps, kt, i0, reps=2)
    if not paths:
        return ms, work
    steps, burnin = path_steps
    runner = mt.SerialMC(steps=steps, burnin=burnin)
    runs = []
    for d in ds:
        X, Y, _, _ = _wide_mode(N, d)
        runs.append((f"HMC(10), d {d}, N {N}, kernel 1",
                     mt.model(glm=("logistic", X, Y), device="cuda"),
                     mt.HMC(10, XWIDE_EPS), C))
    Xb, Yb, mode_b, _ = _wide_mode(Nb, XWIDE_D)
    runs.append((f"adaptive HMC diag, d {XWIDE_D}, N {Nb}, kernel 4",
                 mt.model(glm=("logistic", Xb, Yb), init=mode_b,
                          device="cuda"),
                 mt.HMC(10, XWIDE_BIGN_EPS, mt.EmpMCTuner(0.8, adapt_step=50),
                        mass_adapt="diag"), Cb))
    for label, model, sampler, chains in runs:
        task = model * sampler * runner
        row = {}
        for key, fused in (("fused_s", "auto"), ("generic_s", False)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mt.run(task, chains=chains, seed=0, fused=fused)
            torch.cuda.synchronize()
            row[key] = time.perf_counter() - t0
        emit({"phase": "xwide_path_time", "path": label,
              "task": _origin(model, task, chains), "d": model.size, **row,
              **CARD})
    return ms, work


# ---- exact NUTS on GLMs wider than 256 parameters (kernels 8 and 9) -------

# the very-wide NUTS kernels' launch counters
XWIDE_NUTS_KERNELS = tuple(n.replace("_wide", "_xwide")
                           for n in WIDE_NUTS_KERNELS)
# the very-wide NUTS paths: SerialMC(steps, burnin) for kernel 9 (the kept
# transitions split into launches of 8) and steps - 3 for kernel 8 (a prime
# count of kept transitions: one launch a transition); the dense run's
# resume takes a prime step count too (kernel 8 mat)
XWIDE_NUTS_RUN = (60, 20)
XWIDE_NUTS_RESUME = 13
# the deep check and time: md 10 at WIDE_NUTS_DEEP_EPS on chains that fill
# every resident block once (132 SMs x 16 chains)
XWIDE_NUTS_DEEP_C = 2112


def phase_xwide_nuts_kernels(ragged=1027, N=1000, md=6, k=3):
    """Kernels 8 and 9 (and their _mat forms) on the very-wide tile against
    their plain versions, held to the wide checks' rules (_nuts_check,
    _nuts_ms_check: PATH_AGREE of the chains on the plain version's
    discrete path, theta, g and lp within the narrow tolerances there,
    bitwise repeats): kernel 8 on shared pre-drawn noise, kernel 9 over k
    transitions chain by chain on its own Philox draws replayed by
    glm_nuts_multistep_draws.  On a ragged 1027 chains near the posterior
    mode of wide_data at N 1000 (rows streamed), WIDE_NUTS_EPS, md 6, the
    slice: at d 257 the scalar prior; at d 512 the diagonal fold's (d,)
    row; at d 1024 the scalar prior and the dense fold's (d, d) matrix
    (also multinomial);
    at d 1024 also md 10 at WIDE_NUTS_DEEP_EPS (trees to the bound, the
    largest scratch slice and the last draw numbers of every range, whose
    five ranges are asserted disjoint first); and the Poisson link with
    weights and offsets at d 512 (300 chains, multinomial;
    phase_xwide_kernels' design scale).  At d 1024 (scalar and matrix
    priors, slice) kernel 9's float64 witness (_f64_witness).  Returns the
    largest theta error of each very-wide NUTS kernel."""
    from mcmc_jl_tpu_torch.ops import nuts_kernels as nk

    err = dict.fromkeys(XWIDE_NUTS_KERNELS, 0.0)
    check = functools.partial(_nuts_checks, err, "_xwide", k=k)

    # kernel 9's five draw ranges [lo, hi) of one (chain, transition) at
    # the tile's widest d and the deepest tree, in draw order: momenta,
    # directions, merge uniforms, leaves, the slice uniform
    d, md10 = XWIDE_D, nk.MAX_DOUBLINGS
    ranges = [(0, (d + 1) // 2), (nk.DIR_DRAW, nk.DIR_DRAW + md10),
              (nk.MERGE_DRAW, nk.MERGE_DRAW + md10),
              (nk.LEAF_DRAW, nk.LEAF_DRAW + (1 << md10)),
              (nk.SLICE_DRAW, nk.SLICE_DRAW + 1)]
    disjoint = all(hi <= lo for (_, hi), (lo, _) in zip(ranges, ranges[1:]))
    emit({"phase": "xwide_nuts_draw_ranges", "d": d,
          "maxdoublings": nk.MAX_DOUBLINGS,
          "ranges": [[int(lo), int(hi)] for lo, hi in ranges],
          "disjoint": disjoint})
    assert disjoint, ranges
    cases = {257: (("scalar", (False,)),),
             512: (("row", (False,)),),
             XWIDE_D: (("scalar", (False,)), ("matrix", (False, True)))}
    for d, priors in cases.items():
        f = _wide_folds(N, d, ragged, seed=d + 40)
        for prior, modes in priors:
            XT, Yc, th, lam = f[prior]
            args, noise = _wide_nuts_inputs(XT, Yc, th, md, d + 41,
                                            prior_prec=lam)
            for multinomial in modes:
                label = (f"very-wide tile, d {d}, C {ragged}, {prior} prior, "
                         f"{'multinomial' if multinomial else 'slice'}, "
                         f"md {md}")
                kw = dict(maxdoublings=md, prior_prec=lam,
                          multinomial=multinomial)
                check(label, args, noise, WIDE_NUTS_EPS, kw, seed=d + 42)
                if d == XWIDE_D and not multinomial:
                    _f64_witness(label, args, WIDE_NUTS_EPS, kw, seed=d + 42,
                                 k=k)
        if d == XWIDE_D:  # the deepest trees: md 10, the most scratch
            XT, Yc, th, _ = f["scalar"]
            args, noise = _wide_nuts_inputs(XT, Yc, th, 10, d + 43)
            draws = nk.glm_nuts_multistep_draws(7, 3, d, 2, 10,
                                                device="cuda")
            assert [tuple(a.shape) for a in draws] == [
                (2, 3, d), (2, 3), (2, 3, 10), (2, 3, 10), (2, 3, 1024)]
            check(f"very-wide tile, d {d}, C {ragged}, slice, md 10, eps "
                  f"{WIDE_NUTS_DEEP_EPS}", args, noise, WIDE_NUTS_DEEP_EPS,
                  dict(maxdoublings=10), seed=d + 44, k=2, full_depth=True)
        del f
    XT, Yc, W, O, th, _ = _glm_case("poisson", N, 512, 300, seed=9,
                                    scale=0.3 * np.sqrt(7 / 512))
    kw = dict(kind="poisson", weights=W, offsets=O, prior_prec=1.5)
    args, noise = _wide_nuts_inputs(XT, Yc, th, md, 45, **kw)
    check("very-wide tile, poisson, weights+offsets, d 512, C 300, "
          "multinomial", args, noise, 0.02,
          dict(kw, maxdoublings=md, multinomial=True), seed=46)
    return err


def phase_xwide_nuts_paths(hmc_means, chains=1024, chains_dense=512,
                           run=XWIDE_NUTS_RUN, n=1000):
    """Exact NUTS on the d 1024 logistic regression (wide_data, N 1000,
    from the model's init) through the port's entry points, every launch
    counted from zero over one run (a run that fell back to the generic
    engine would launch none), each run's per-chain means held within
    Z_MAX standard errors of ``hmc_means`` (kernel 1's HMC run of
    phase_xwide_paths, 4096 chains: cheaper than a generic run):
    ``NUTS(6) * SerialMC(*run)`` at 1024 chains (kernel 9 on the very-wide
    tile), ``NUTS(6, mass_adapt="diag")`` with three steps fewer (a prime
    count of kept transitions: kernel 8), ``NUTS(6, mass_adapt="dense") *
    SerialMC(*run)`` at 512 chains (9 mat; the generic warmup keeps a (d,
    d) factor and accumulator a chain, 2 GB each), then
    ``resume(chains, steps=13)`` of the dense run (8 mat) with
    _resume_path's checks.  The warmups run on the generic engine.  First
    the routes at d 1024 and 1025 (_nuts_routes: both "nuts", the second on
    the chunked tier).  Returns the very-wide NUTS kernels' launches {name:
    (count, origin)}."""
    import mcmc_jl_tpu_torch as mt
    from mcmc_jl_tpu_torch.ops.warmstart import _pick_k_trans

    _nuts_routes((XWIDE_D, XWIDE_D + 1), n)
    X, Y, _, _ = _wide_mode(n, XWIDE_D)
    m = mt.model(glm=("logistic", X, Y), device="cuda")
    d = m.size
    steps, burnin = run
    kept = steps - burnin
    counts, held = {}, {}
    for label, sampler, S, C, name, want in (
            ("unit", mt.NUTS(6), steps, chains, "glm_nuts_multistep_xwide",
             kept // _pick_k_trans(kept)),
            ("diag", mt.NUTS(6, mass_adapt="diag"), steps - 3, chains,
             "glm_nuts_transition_xwide", kept - 3),
            ("dense", mt.NUTS(6, mass_adapt="dense"), steps, chains_dense,
             "glm_nuts_multistep_mat_xwide", kept // _pick_k_trans(kept))):
        assert name != "glm_nuts_transition_xwide" or \
            _pick_k_trans(kept - 3) == 1
        task = m * sampler * mt.SerialMC(steps=S, burnin=burnin)
        origin = _origin(m, task, C)
        cs, samples, launches, dt, spans = _path(origin, task, C,
                                                 {name: want})
        dg = {k: np.stack([c.diagnostics[k] for c in cs])
              for k in ("accept", "ndoublings", "diverging", "epsilon")}
        z = _z_means(samples.mean(1), hmc_means)
        emit({"phase": "xwide_nuts_path", "kernel": name, "from": origin,
              "d": d, "chains": C, "seconds": dt, "spans_s": spans,
              "launches": launches[name],
              "frozen_eps": float(dg["epsilon"][0, -1]),
              "accept_rate": float(dg["accept"].mean()),
              "mean_ndoublings": float(dg["ndoublings"].mean()),
              "diverging_share": float(dg["diverging"].mean()),
              "z_max_vs_hmc": z, "ok": z < Z_MAX, **CARD})
        assert z < Z_MAX, f"{origin} disagrees with kernel 1's HMC"
        counts[name] = (launches[name], origin)
        if label == "dense":
            held[label] = [c.task for c in cs]
        del cs, samples
    S = XWIDE_NUTS_RESUME
    assert _pick_k_trans(S) == 1
    origin = f"resume(NUTS(6, dense) chains of d {d}, steps={S})"
    _resume_path(origin, held.pop("dense"), S,
                 {"glm_nuts_transition_mat_xwide": S},
                 lambda s: _z_means(s.mean(1), hmc_means), by_chain=False)
    counts["glm_nuts_transition_mat_xwide"] = (S, origin)
    return counts


def phase_xwide_nuts_times(C=4096, N=1000, md=6, k_trans=2,
                           ds=XWIDE_TIME_D, deep_C=XWIDE_NUTS_DEEP_C):
    """Per-launch time of kernels 8 and 9 (k_trans 2) on the very-wide tile
    at d 512 and 1024 (XWIDE_TIME_D), N 1000, 4096 chains drawn from the
    Laplace approximation at the mode (numpy seed d + 51), at WIDE_NUTS_EPS
    and md 6, with _nuts_kernel_times' columns (events, device ms, plain
    version, leaves, tile passes, bound, occupancy and scratch plan; events
    over 2 launches, device ms over 1 with the scalar prior at d 1024: a
    torch.profiler session costs about 2 s, and at 16 ms a launch and more
    the two agree within 3%), the _mat forms at d 1024 on the dense fold
    (chains in z); then kernel 8 at d 1024 and md 10 at
    WIDE_NUTS_DEEP_EPS on 2112 chains (every resident block's scratch
    slice once, 277 MB: what L2 misses cost a tile pass), events alone,
    without its plain version (phase_build prints nuts_xwide_kernel's
    registers and spills; ``deep_C`` 0, as in the full run, leaves it to
    ``--times``).  Returns ({kernel: (ms, plain ms)}, {kernel: bound}) at
    d 1024."""
    ms, work = {}, {}
    for d in ds:
        f = _wide_folds(N, d, C, seed=d + 51, spread=1.0)
        for prior in ("scalar", "matrix") if d == XWIDE_D else ("scalar",):
            XT, Yc, th, lam = f[prior]
            lp, g = _lp_grad(XT, Yc, th, prior_prec=lam)
            lines = _nuts_kernel_times(
                XT, Yc, th, lp, g, WIDE_NUTS_EPS, md, k_trans, seed=d + 52,
                prior=lam, event_reps=2,
                device_reps=int(d == XWIDE_D and prior == "scalar"))
            if d == XWIDE_D:
                for name, t in lines.items():
                    ms[name] = (t["ms"], t["plain_ms"])
                    work[name] = {k: t[k] for k in ("bound_ms", "bound_by")}
        if d == XWIDE_D and deep_C:
            XT, Yc, th, _ = f["scalar"]
            th = th[:deep_C].contiguous()
            lp, g = _lp_grad(XT, Yc, th)
            _nuts_kernel_times(XT, Yc, th, lp, g, WIDE_NUTS_DEEP_EPS, 10, 1,
                               seed=d + 53, plain=False, multistep=False,
                               device_reps=0, event_reps=2)
        del f
    return ms, work


# ---- GLMs wider than 1024 parameters: the chunked tier (kernels 1-4) ------

# the chunked paths' width (wide_data at d 4096 and N 1000: a p > n
# regression, as on text, hashed or genomic features) and the dense paths'
# (their generic warmup keeps a (d, d) factor and accumulator a chain: 16 MB
# each at d 2048)
CHUNKED_D, CHUNKED_DENSE_D = 4096, 2048
# the widths the kernel checks take: the very-wide tile's bound + 32 (three
# chunks of 352 columns), two and eight chunks of 512; kernels 1 and 4 also
# at 8192 and at the tier's bound, 16384 (glm_kernels.D_MAX)
CHUNKED_CHECK_D = (1056, 2048, 4096)
CHUNKED_EDGE_D = (8192, 16384)
# the widths the chunked kernels are timed at
CHUNKED_TIME_D = (2048, 4096)
# observations of the large-N paths (above BIGN_THRESHOLD: kernel 4; X is
# 328 MB at d 4096)
CHUNKED_N_BIGN = 20_000
# HMC step of the chunked paths at N 1000 (posterior sds 0.8-1 at d 4096;
# from a standard normal start an acceptance of 0.765 at 4096 chains on an
# H100) and the adaptive runs' initial step at N 20,000 (sds 0.5-1).  From
# the mode or from zeros every coordinate's momentum is kinetic energy the
# trajectory cannot keep: at d 4096 and eps 0.2 the energy error is about
# d eps^2 / 8 = 20 and every proposal is rejected (on either engine), so
# the fixed-step N 1000 runs start at one standard
# normal vector (seed CHUNKED_INIT_SEED).  The adaptive runs start at the
# posterior mode (their first steps are 0.02, and the diagonal metric is
# estimated from the burn-in): a start shared by all chains and away from
# the posterior mean leaves its trace in short runs' per-chain means
# (|z| 18 against the generic engine's plain HMC after 90 transitions from
# the standard normal start, 7.7 from zeros, at 4096 chains).
CHUNKED_EPS, CHUNKED_BIGN_EPS = 0.2, 0.1
CHUNKED_INIT_SEED = 3
# SerialMC(steps, burnin, thinning) of the chunked paths at N 1000: 4096
# chains of 4096 coordinates are 64 MB a kept row, so every 8th is kept
CHUNKED_RUN = (66, 26, 8)
# the adaptive runs' SerialMC at N 1000: the tuner adapts once, at step 50
CHUNKED_ADAPTIVE_RUN = (66, 50, 8)
# the chunked kernels' launch counters
CHUNKED_KERNELS = tuple(n.replace("_wide", "_chunked") for n in WIDE_KERNELS)


def _chunked_model(n, d):
    """wide_data(n, d) as a model on the card whose init is one standard
    normal vector (numpy seed CHUNKED_INIT_SEED, the prior's typical set):
    (X, Y, init, model)."""
    import mcmc_jl_tpu_torch as mt

    X, Y, _, _ = _wide_mode(n, d)
    init = np.random.default_rng(CHUNKED_INIT_SEED).standard_normal(d)
    return X, Y, init, mt.model(glm=("logistic", X, Y), init=init,
                                device="cuda")


def _chunked_folds(n, d, C, seed, spread=0.1):
    """_wide_folds computed on the card (numpy's products of the (d, d)
    factor take seconds at d 4096): the scalar prior on X, the diagonal
    fold (X s, row s^2) and the dense fold (X L, matrix L'L), C chains near
    the mode of wide_data(n, d).  {name: (XT, Y, theta, prior)}, float32 on
    the card."""
    import torch

    X, Y, mode, L = _wide_mode(n, d)
    dev = "cuda"
    Xt = torch.as_tensor(X, device=dev)
    Lt = torch.as_tensor(L, device=dev)
    rng = np.random.default_rng(seed)
    s = Lt.square().sum(1).sqrt()
    theta = torch.as_tensor(mode, device=dev) + spread * s * torch.as_tensor(
        rng.standard_normal((C, d)), device=dev)
    f32 = lambda a: a.float().contiguous()  # noqa: E731
    Yc = _cuda(Y)
    z = torch.linalg.solve_triangular(Lt, theta.T, upper=False).T
    return {"scalar": (f32(Xt.T), Yc, f32(theta), 1.0),
            "row": (f32((Xt * s).T), Yc, f32(theta / s), f32(s * s)),
            "matrix": (f32((Xt @ Lt).T), Yc, f32(z), f32(Lt.T @ Lt))}


def _chunked_case(kind, N, d, C, seed, extras=False):
    """A GLM of link ``kind`` at width d drawn on the card (a numpy design
    of N x 16384 takes seconds): wide_data's scaling (an intercept and
    standard normal columns over sqrt(d)), a response at standard normal
    coefficients, C chains at 0.3 standard normals and standard normal
    momenta; with ``extras`` weights in [0.5, 2) and offsets of sd 0.1.
    (XT, Y, W, O, theta, m), float32."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)

    def normal(*shape):
        return torch.randn(*shape, generator=gen, device="cuda",
                           dtype=torch.float64)

    def uniform(*shape):
        return torch.rand(*shape, generator=gen, device="cuda",
                          dtype=torch.float64)

    XT = normal(d, N)
    XT[0] = 1.0
    XT /= d ** 0.5
    z = normal(d) @ XT
    if kind == "linear":
        Y = z + normal(N)
    elif kind == "poisson":
        Y = torch.poisson(torch.exp(z), generator=gen)
    else:
        Y = (uniform(N) < torch.sigmoid(z)).double()
    W = 0.5 + 1.5 * uniform(N) if extras else None
    O = 0.1 * normal(N) if extras else None
    f32 = lambda a: None if a is None else a.float().contiguous()  # noqa: E731
    return (f32(XT), f32(Y), f32(W), f32(O), f32(0.3 * normal(C, d)),
            f32(normal(C, d)))


def phase_chunked_kernels(ragged=1027, N=1000, Cb=512, Nb=CHUNKED_N_BIGN,
                          k=4, i0=501, edge=(67, 1100), edge_b=(37, 2600)):
    """Kernels 1, 2, 3, 3b (and _mat) and 4 (and _mat) on the chunked tier
    against their plain versions, with the very-wide checks' rules and
    tolerances (_traj_check, _step_check, _multistep_check, _rows_check,
    _tiled_case): at d 1056, 2048 and 4096 (CHUNKED_CHECK_D: 3 chunks of
    352 columns, 4 and 8 of 512) on a ragged 1027 chains near the posterior
    mode of wide_data at N 1000 (two row blocks, the second ragged), 2, 3
    and 3b at WIDE_STEP_EPS, where the plain versions both accept and
    reject, 3 and 3b over k transitions chain by chain on their own Philox
    draws replayed on the card, 3b with the scalar prior, the diagonal
    fold's (d,) row and the dense fold's (d, d) matrix; kernel 1 on every
    link with weights and offsets at d 2048; kernel 1 at d 8192 and 16384
    (CHUNKED_EDGE_D; 67 chains, N 1100) on a design drawn on the card;
    kernel 4 at d 4096 at its path's shape (512 chains, N 20,000), at d
    1056 and 2048 on 300 chains and a ragged N 6003 (6 splits of two row
    blocks, the second ragged), each with the scalar prior, the row and the
    matrix, probit with weights, offsets and a row at d 2048, and at d 8192
    and 16384 (37 chains, N 2600) with the scalar prior and a row.  The
    draw ranges of kernels 3 and 3b (momenta 0 .. d/2 - 1, the MH uniform
    SLICE_DRAW) are disjoint at the bound.  Returns the largest absolute
    error of each chunked kernel."""
    import torch

    from mcmc_jl_tpu_torch.ops import glm_kernels as gk

    assert (gk.D_MAX + 1) // 2 - 1 < gk.SLICE_DRAW
    err = dict.fromkeys(CHUNKED_KERNELS, 0.0)

    def keep(name, e):
        err[name] = max(err[name], e)

    for d in CHUNKED_CHECK_D:
        f = _chunked_folds(N, d, ragged, seed=d)
        XT, Yc, th, _ = f["scalar"]
        rng = np.random.default_rng(d + 1)
        m0 = _cuda(rng.standard_normal((ragged, d)))
        logu = _cuda(np.log(rng.random(ragged)))
        label = f"chunked tier, d {d}, N {N}, C {ragged}"
        keep("glm_leapfrogs_chunked", _traj_check(label, XT, Yc, th, m0,
                                                  CHUNKED_EPS, n_leaps=10))
        keep("glm_step_chunked", _step_check(label, XT, Yc, th, m0, logu,
                                             WIDE_STEP_EPS, mix=True,
                                             n_leaps=10))
        keep("glm_multistep_chunked", _multistep_check(
            label, XT, Yc, th, WIDE_STEP_EPS, k=k, seed=d, mix=True,
            n_leaps=10))
        for prior, name in (("scalar", "glm_multistep_rows_chunked"),
                            ("row", "glm_multistep_rows_chunked"),
                            ("matrix", "glm_multistep_rows_mat_chunked")):
            XTf, _, thf, lam = f[prior]
            keep(name, _rows_check(f"{label}, {prior} prior", XTf, Yc, thf,
                                   WIDE_STEP_EPS, 10 * WIDE_STEP_EPS, i0,
                                   20, k, seed=d + 2, mix=True,
                                   prior_prec=lam))
        del f, XT, th, m0
    # kernel 1: every link with weights and offsets at d 2048 (the design
    # scaled as the very-wide phase's d 512 case), then the edge widths
    for kind in gk.KIND_CODES:
        XT, Yc, W, O, th, m = _glm_case(kind, N, 2048, 300, seed=8,
                                        scale=0.3 * np.sqrt(7 / 2048))
        keep("glm_leapfrogs_chunked", _traj_check(
            f"chunked tier, {kind}, weights+offsets, d 2048", XT, Yc, th, m,
            0.01, n_leaps=3, kind=kind, weights=W, offsets=O, prior_prec=1.5,
            integrator="2stage"))
    C1, N1 = edge
    for d in CHUNKED_EDGE_D:
        XT, Yc, _, _, th, m = _chunked_case("logistic", N1, d, C1, seed=d)
        keep("glm_leapfrogs_chunked", _traj_check(
            f"chunked tier, d {d}, N {N1}, C {C1}", XT, Yc, th, m,
            CHUNKED_EPS, n_leaps=4))
        del XT, th, m
    # kernel 4
    for d in CHUNKED_CHECK_D:
        n4, c4 = (Nb, Cb) if d == CHUNKED_D else (6003, 300)
        f = _chunked_folds(n4, d, c4, seed=d + 5, spread=0.3)
        for prior, name in (("scalar", "glm_logp_grad_tiled_chunked"),
                            ("row", "glm_logp_grad_tiled_chunked"),
                            ("matrix", "glm_logp_grad_tiled_mat_chunked")):
            XT, Yc, th, lam = f[prior]
            keep(name, _tiled_case(f"chunked tier, d {d}, {prior} prior, "
                                   f"N {n4}, C {c4}", XT, Yc, th, lam=lam))
        del f
        torch.cuda.empty_cache()
    XT, Yc, W, O, th, _ = _chunked_case("probit", Nb + 3, 2048, 300, seed=9,
                                        extras=True)
    lam = _cuda(np.random.default_rng(9).uniform(0.5, 2.0, 2048))
    keep("glm_logp_grad_tiled_chunked", _tiled_case(
        f"chunked tier, probit, weights+offsets, row prior, d 2048, "
        f"N {Nb + 3}, C 300", XT, Yc, th, kind="probit", W=W, O=O, lam=lam))
    Cb4, Nb4 = edge_b
    for d in CHUNKED_EDGE_D:
        XT, Yc, _, _, th, _ = _chunked_case("logistic", Nb4, d, Cb4,
                                            seed=d + 1)
        lam = _cuda(np.random.default_rng(d).uniform(0.5, 2.0, d))
        for prior, lam_d in (("scalar", 1.0), ("row", lam)):
            keep("glm_logp_grad_tiled_chunked", _tiled_case(
                f"chunked tier, d {d}, {prior} prior, N {Nb4}, C {Cb4}", XT,
                Yc, th, lam=lam_d))
        del XT, th
    torch.cuda.empty_cache()
    return err


def phase_chunked_paths(chains=4096, chains_dense=256, chains_bign=512,
                        chains_dense_bign=128, generic_chains=512,
                        run=CHUNKED_RUN,
                        adaptive_run=CHUNKED_ADAPTIVE_RUN, bign_run=(44, 30),
                        driver_steps=20, resume_chains=512, resume_steps=16,
                        n=1000, n_bign=CHUNKED_N_BIGN):
    """Logistic regressions wider than 1024 parameters (wide_data) through
    the port's entry points, every launch counted from zero over one run (a
    run that fell back to the generic engine would launch none) and every
    run held within Z_MAX standard errors of per-chain means against the
    generic engine on the same task (the route such a GLM took before the
    chunked tier):

    - d 4096, N 1000, from a standard normal init (_chunked_model):
      ``run(HMC(10, CHUNKED_EPS) * SerialMC(66, 26, 8), chains=4096)``
      (kernel 1, once a transition), against the same task on 512
      generic-engine chains; ``run_glm_hmc(fused_step=True)`` (2) and
      ``run_glm_hmc_multistep(thin=20)`` (3) from the same init for 20
      transitions, against that run's final states; from the posterior
      mode, adaptive HMC diag, ``HMC(10, 0.02, EmpMCTuner(0.8, 50),
      mass_adapt="diag") * SerialMC(66, 50, 8)`` at 4096 chains (3b),
      against the generic run, and ``resume(steps=16)`` of 512 of its
      chains (3b; every 8th step kept, as the run's), against the same;
    - d 2048, N 1000, from the mode: the same adaptive HMC with
      ``mass_adapt="dense"`` at 256 chains (3b mat), against plain HMC
      from the standard normal start on 512 generic chains;
    - N 20,000 from the posterior mode: adaptive HMC diag at d 4096, 512
      chains, and dense at d 2048, 128 chains (its generic warmup's (d, d)
      arrays), ``HMC(10, CHUNKED_BIGN_EPS, EmpMCTuner(0.8, 50), mass_adapt
      =...) * SerialMC(44, 30)`` (4, 4 mat), each against plain
      ``HMC(10, CHUNKED_BIGN_EPS)`` on as many generic-engine chains from
      the mode.

    Returns the chunked kernels' launches {name: (count, origin)} and the
    per-chain means of the two adaptive runs from the mode at N 1000, {d
    4096: diagonal metric, d 2048: dense}, against which
    phase_chunked_nuts_paths holds NUTS from the same mode."""
    import mcmc_jl_tpu_torch as mt
    from mcmc_jl_tpu_torch.ops.glm_hmc import (run_glm_hmc,
                                              run_glm_hmc_multistep)

    steps, burnin, thin = run
    runner = mt.SerialMC(steps=steps, burnin=burnin, thinning=thin)
    ra = mt.SerialMC(steps=adaptive_run[0], burnin=adaptive_run[1],
                     thinning=adaptive_run[2])
    counts = {}

    def reference(model, sampler, C, r=runner):
        """Per-chain means of the same task on the generic engine."""
        task = model * sampler * r
        t0 = time.perf_counter()
        cg = mt.run(task, chains=C, seed=1, fused=False)
        dt = time.perf_counter() - t0
        means = np.stack([c.samples.values for c in cg]).mean(1)
        return means, {"task": _origin(model, task, C), "seconds": dt}

    def fused(model, sampler, C, name, want, ref, r=runner, **extra):
        task = model * sampler * r
        origin = _origin(model, task, C)
        cs, samples, launches, dt, spans = _path(origin, task, C,
                                                 {name: want})
        z = _z_means(samples.mean(1), ref[0])
        st = cs[0].task.state
        frozen = ({"frozen_step": st.tune.step_size.item(),
                   "frozen_n_leaps": st.tune.n_leaps.item()}
                  if hasattr(st, "tune") else {})
        emit({"phase": "chunked_path", "kernel": name, "from": origin,
              "d": model.size, "chains": C, "seconds": dt, "spans_s": spans,
              "launches": launches[name], **frozen,
              "accept_rate": float(np.mean([mt.acceptance(c)
                                            for c in cs[:512]])) / 100,
              "generic": ref[1], "z_max_vs_generic": z, "ok": z < Z_MAX,
              **extra, **CARD})
        assert z < Z_MAX, f"{origin} disagrees with the generic engine"
        counts[name] = (launches[name], origin)
        return cs, samples

    def adaptive(eps, ma):
        return mt.HMC(10, eps, mt.EmpMCTuner(0.8, adapt_step=50),
                      mass_adapt=ma)

    X, Y, init, m = _chunked_model(n, CHUNKED_D)
    ref = reference(m, mt.HMC(10, CHUNKED_EPS), generic_chains)
    cs, samples = fused(m, mt.HMC(10, CHUNKED_EPS), chains,
                        "glm_leapfrogs_chunked", steps, ref)
    final = samples[:, -1]
    del cs, samples
    inits = np.tile(init, (chains, 1))
    for name, origin_d, want, fn in (
            ("glm_step_chunked", "run_glm_hmc(fused_step=True)",
             driver_steps,
             lambda: run_glm_hmc(X, Y, chains, driver_steps, n_leaps=10,
                                 eps=CHUNKED_EPS, seed=2, inits=inits,
                                 device="cuda", fused_step=True)),
            ("glm_multistep_chunked", "run_glm_hmc_multistep(thin=20)",
             driver_steps // 20,
             lambda: run_glm_hmc_multistep(X, Y, chains, driver_steps,
                                           thin=20, n_leaps=10,
                                           eps=CHUNKED_EPS, seed=3,
                                           inits=inits, device="cuda"))):
        t0 = time.perf_counter()
        (theta, _), launches = _counted(fn)
        dt = time.perf_counter() - t0
        assert launches == {**{k: 0 for k in launches}, name: want}, launches
        th = theta.double().cpu().numpy()
        assert th.shape == final.shape and np.all(np.isfinite(th))
        z = _z_means(th, final)
        origin_d = (f"{origin_d} at d {CHUNKED_D}, N {n}, {chains} chains, "
                    f"{driver_steps} transitions")
        emit({"phase": "chunked_driver", "kernel": name, "from": origin_d,
              "seconds": dt, "launches": launches[name],
              "z_max_vs_main_path": z, "ok": z < Z_MAX, **CARD})
        assert z < Z_MAX, f"{origin_d} disagrees with the main path"
        counts[name] = (launches[name], origin_d)
    del final, inits
    m_mode = mt.model(glm=("logistic", X, Y),
                      init=_wide_mode(n, CHUNKED_D)[2], device="cuda")
    cs, samples = fused(m_mode, adaptive(0.02, "diag"), chains,
                        "glm_multistep_rows_chunked", lambda k: k > 0, ref,
                        ra)
    means = {CHUNKED_D: samples.mean(1)}
    del samples
    # resume(list) of part of the adaptive run: 3b from its frozen state
    tasks = cs[:resume_chains]
    del cs
    label = f"resume(steps={resume_steps}) of {resume_chains} of those chains"
    t0 = time.perf_counter()
    rs, launches = _counted(lambda: mt.resume(tasks, steps=resume_steps))
    dt = time.perf_counter() - t0
    name = "glm_multistep_rows_chunked"
    assert launches[name] > 0 and sum(launches.values()) == launches[name], \
        launches
    rsamp = np.stack([c.samples.values for c in rs])
    kept = len(range(1, resume_steps + 1, adaptive_run[2]))  # its thinning
    assert rsamp.shape == (resume_chains, kept, CHUNKED_D)
    assert np.all(np.isfinite(rsamp))
    assert all(c.task.pos == t.task.pos + resume_steps
               for c, t in zip(rs, tasks))
    z = _z_means(rsamp.mean(1), ref[0])
    emit({"phase": "chunked_path", "kernel": name, "from": label,
          "d": CHUNKED_D, "chains": resume_chains, "seconds": dt,
          "launches": launches[name], "z_max_vs_generic": z,
          "ok": z < Z_MAX, **CARD})
    assert z < Z_MAX, f"{label} disagrees with the generic engine"
    del rs, rsamp, tasks

    X2, Y2, _, m2 = _chunked_model(n, CHUNKED_DENSE_D)
    ref2 = reference(m2, mt.HMC(10, CHUNKED_EPS), generic_chains)
    _, samples = fused(mt.model(glm=("logistic", X2, Y2),
                                init=_wide_mode(n, CHUNKED_DENSE_D)[2],
                                device="cuda"),
                       adaptive(0.02, "dense"), chains_dense,
                       "glm_multistep_rows_mat_chunked", lambda k: k > 0,
                       ref2, ra)
    means[CHUNKED_DENSE_D] = samples.mean(1)
    del samples

    nb, bb = bign_run
    rb = mt.SerialMC(steps=nb, burnin=bb)
    for d, ma, name, C in (
            (CHUNKED_D, "diag", "glm_logp_grad_tiled_chunked", chains_bign),
            (CHUNKED_DENSE_D, "dense", "glm_logp_grad_tiled_mat_chunked",
             chains_dense_bign)):
        Xb, Yb, mode_b, _ = _wide_mode(n_bign, d)
        mb = mt.model(glm=("logistic", Xb, Yb), init=mode_b, device="cuda")
        refb = reference(mb, mt.HMC(10, CHUNKED_BIGN_EPS), C, rb)
        fused(mb, adaptive(CHUNKED_BIGN_EPS, ma), C, name,
              lambda k: k >= nb - bb + 1, refb, rb)
        del mb
    return counts, means


def phase_chunked_times(C=4096, Cb=512, N=1000, Nb=CHUNKED_N_BIGN,
                        n_leaps=10, kt=4, i0=501, path_steps=(12, 4),
                        ds=CHUNKED_TIME_D, paths=True):
    """_tier_times of the chunked kernels at d 2048 and 4096
    (CHUNKED_TIME_D; or the widths ``ds``) at the chunked paths' shapes:
    1-3b at N 1000 and 4096 chains (3 and 3b over 4 transitions), 4 at N
    20,000 and 512 chains (events and device ms over 2 launches), each
    with the bytes of X its tiles read a gradient (two passes,
    ``x_bytes_a_gradient``).  Then, with ``paths``, the host seconds (to a
    synchronize) of plain HMC(10) over SerialMC(12, 4) at 4096 chains and
    N 1000 (kernel 1) at d 4096 and of adaptive HMC diag over the same
    runner at N 20,000 and 512 chains (kernel 4), through the kernels and
    through the generic engine at the same chains, each also less its
    packaging (which costs both routes alike: 2-3 s for 4096 chains of
    4096 coordinates).  Returns ({kernel: (ms, plain ms)}, {kernel:
    bound}) at d 4096."""
    import torch

    import mcmc_jl_tpu_torch as mt
    from mcmc_jl_tpu_torch.ops.glm_kernels import _padded

    ms, work = _tier_times("chunked", ds, CHUNKED_D, N, Nb, C,
                           Cb, n_leaps, kt, i0, reps=2,
                           folds=_chunked_folds,
                           symbols=("hmc_xwide_kernel",
                                    "partial_xchunk_kernel"),
                           width=_padded, x_passes=2)
    if not paths:
        return ms, work
    steps, burnin = path_steps
    runner = mt.SerialMC(steps=steps, burnin=burnin)
    runs = [(f"HMC(10), d {CHUNKED_D}, N {N}, kernel 1",
             _chunked_model(N, CHUNKED_D)[3], mt.HMC(10, CHUNKED_EPS), C)]
    Xb, Yb, mode_b, _ = _wide_mode(Nb, CHUNKED_D)
    runs.append((f"adaptive HMC diag, d {CHUNKED_D}, N {Nb}, kernel 4",
                 mt.model(glm=("logistic", Xb, Yb), init=mode_b,
                          device="cuda"),
                 mt.HMC(10, CHUNKED_BIGN_EPS,
                        mt.EmpMCTuner(0.8, adapt_step=50),
                        mass_adapt="diag"), Cb))
    for label, model, sampler, chains in runs:
        task = model * sampler * runner
        row = {}
        for key, fused in (("fused", "auto"), ("generic", False)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with _spans() as spans:
                mt.run(task, chains=chains, seed=0, fused=fused)
            torch.cuda.synchronize()
            row[key + "_s"] = time.perf_counter() - t0
            row[key + "_less_packaging_s"] = (row[key + "_s"]
                                             - spans.get("packaging", 0.0))
        emit({"phase": "chunked_path_time", "path": label,
              "task": _origin(model, task, chains), "d": model.size, **row,
              **CARD})
    return ms, work


# ---- GLMs wider than 1024 parameters: exact NUTS on the chunked tier -------

# the chunked NUTS kernels' launch counters
CHUNKED_NUTS_KERNELS = tuple(n.replace("_wide", "_chunked")
                             for n in WIDE_NUTS_KERNELS)
# kernel 8 at the tier's bound (glm_kernels.D_MAX): (d, chains, N) on a
# design drawn on the card; 211 chains, so that PATH_AGREE lets one chain
# leave the plain version's path, as at every other width
CHUNKED_NUTS_EDGE = (16384, 211, 1100)
# the chunked NUTS paths at d 4096: SerialMC(steps, burnin, thinning) for
# kernel 9 (the kept transitions split into launches of 8) and steps - 3
# for kernel 8 (a prime count: one launch a transition), every 4th row kept
# (a row of 1024 chains of 4096 coordinates is 16 MB); the dense run at d
# 2048, SerialMC(steps, burnin), keeps every row, and its resume (8 mat)
# takes a prime step count
CHUNKED_NUTS_RUN = (60, 20, 4)
CHUNKED_NUTS_DENSE_RUN = (36, 20)
CHUNKED_NUTS_RESUME = 11


def phase_chunked_nuts_kernels(ragged=1027, N=1000, md=6, k=3,
                               edge=CHUNKED_NUTS_EDGE):
    """Kernels 8 and 9 (and their _mat forms) on the chunked tier against
    their plain versions, held to the very-wide NUTS checks' rules
    (_nuts_check, _nuts_ms_check: PATH_AGREE of the chains on the plain
    version's discrete path, theta, g and lp within the narrow tolerances
    there, bitwise repeats): kernel 8 on shared pre-drawn noise, kernel 9
    over k transitions chain by chain on its own Philox draws replayed by
    glm_nuts_multistep_draws.  Kernel 9's five draw ranges are asserted
    disjoint first at the bound (d 16384, md 10).  On a ragged 1027 chains
    near the posterior mode of wide_data at N 1000 (two row blocks, the
    second ragged), WIDE_NUTS_EPS, md 6 (_chunked_folds): at d 1056 (three
    chunks of 352) the scalar prior, slice and multinomial, and the
    diagonal fold's (d,) row, then md 10 at WIDE_NUTS_DEEP_EPS (trees to
    the bound: the deepest checkpoint slots and the last draw numbers of
    every range; kernel 9 over 2 transitions); at d 2048 the dense fold's
    (d, d) matrix; at d 4096 the scalar prior and the matrix, multinomial
    (kernel 9 over 2 transitions).  Probit (slice) and Poisson
    (multinomial) with weights and offsets at d 2048 on 300 chains
    (_chunked_case's design), and kernel 8 alone at the tier's bound
    (CHUNKED_NUTS_EDGE: d 16384, 211 chains, N 1100).  Returns the largest
    theta error of each chunked NUTS kernel."""
    import torch

    from mcmc_jl_tpu_torch.ops import nuts_kernels as nk

    err = dict.fromkeys(CHUNKED_NUTS_KERNELS, 0.0)
    check = functools.partial(_nuts_checks, err, "_chunked", k=k)

    # kernel 9's five draw ranges [lo, hi) of one (chain, transition) at
    # the widest d and the deepest tree, in draw order: momenta,
    # directions, merge uniforms, leaves, the slice uniform
    d, md10 = nk.NUTS_D_MAX, nk.MAX_DOUBLINGS
    ranges = [(0, (d + 1) // 2), (nk.DIR_DRAW, nk.DIR_DRAW + md10),
              (nk.MERGE_DRAW, nk.MERGE_DRAW + md10),
              (nk.LEAF_DRAW, nk.LEAF_DRAW + (1 << md10)),
              (nk.SLICE_DRAW, nk.SLICE_DRAW + 1)]
    disjoint = all(hi <= lo for (_, hi), (lo, _) in zip(ranges, ranges[1:]))
    emit({"phase": "chunked_nuts_draw_ranges", "d": d,
          "maxdoublings": md10,
          "ranges": [[int(lo), int(hi)] for lo, hi in ranges],
          "disjoint": disjoint})
    assert disjoint, ranges
    cases = {1056: (("scalar", (False, True)), ("row", (False,))),
             2048: (("matrix", (False,)),),
             CHUNKED_D: (("scalar", (False,)), ("matrix", (True,)))}
    for d, priors in cases.items():
        f = _chunked_folds(N, d, ragged, seed=d + 60)
        for prior, modes in priors:
            XT, Yc, th, lam = f[prior]
            args, noise = _wide_nuts_inputs(XT, Yc, th, md, d + 61,
                                            prior_prec=lam)
            for multinomial in modes:
                label = (f"chunked tier, d {d}, C {ragged}, {prior} prior, "
                         f"{'multinomial' if multinomial else 'slice'}, "
                         f"md {md}")
                # the matrix at d 4096 reads A (64 MB) every leaf: 2
                # transitions of kernel 9
                check(label, args, noise, WIDE_NUTS_EPS,
                      dict(maxdoublings=md, prior_prec=lam,
                           multinomial=multinomial), seed=d + 62,
                      k=2 if d == CHUNKED_D and prior == "matrix" else k)
        if d == 1056:  # the deepest trees: md 10
            XT, Yc, th, _ = f["scalar"]
            args, noise = _wide_nuts_inputs(XT, Yc, th, 10, d + 63)
            check(f"chunked tier, d {d}, C {ragged}, slice, md 10, eps "
                  f"{WIDE_NUTS_DEEP_EPS}", args, noise, WIDE_NUTS_DEEP_EPS,
                  dict(maxdoublings=10), seed=d + 64, k=2, full_depth=True)
        del f, args, noise
        torch.cuda.empty_cache()
    for i, (kind, multinomial) in enumerate((("probit", False),
                                             ("poisson", True))):
        XT, Yc, W, O, th, _ = _chunked_case(kind, N, 2048, 300, seed=10 + i,
                                            extras=True)
        kw = dict(kind=kind, weights=W, offsets=O, prior_prec=1.5)
        args, noise = _wide_nuts_inputs(XT, Yc, th, md, 47 + i, **kw)
        check(f"chunked tier, {kind}, weights+offsets, d 2048, C 300, "
              f"{'multinomial' if multinomial else 'slice'}", args, noise,
              0.02, dict(kw, maxdoublings=md, multinomial=multinomial),
              seed=49 + i)
    d, C8, N8 = edge
    XT, Yc, _, _, th, _ = _chunked_case("logistic", N8, d, C8, seed=d + 2)
    args, noise = _wide_nuts_inputs(XT, Yc, th, md, d + 3)
    check(f"chunked tier, d {d}, N {N8}, C {C8}, slice, md {md}", args,
          noise, WIDE_NUTS_EPS, dict(maxdoublings=md), seed=d + 4,
          multistep=False)
    del XT, th, args, noise
    torch.cuda.empty_cache()
    return err


def phase_chunked_nuts_paths(means, chains=1024, chains_dense=256,
                             run=CHUNKED_NUTS_RUN,
                             dense_run=CHUNKED_NUTS_DENSE_RUN, n=1000):
    """Exact NUTS on the logistic regressions wider than 1024 parameters
    (wide_data, N 1000, from the posterior mode: phase_chunked_paths
    found a start shared by all chains away from the posterior mean kept
    in short runs' per-chain means) through the port's entry points, every
    launch counted from zero over one run (a run that fell back to the
    generic engine would launch none), each run's per-chain means held
    within Z_MAX standard errors of ``means`` (phase_chunked_paths'
    adaptive HMC runs from the same mode: {d: per-chain means}, the
    diagonal metric's at d 4096 through 3b, the dense metric's at d 2048
    through 3b mat): ``NUTS(6) * SerialMC(*run)`` at d 4096 and 1024
    chains (kernel 9 on the chunked tier), ``NUTS(6, mass_adapt="diag")``
    with three steps fewer (a prime count of kept transitions: kernel 8),
    ``NUTS(6, mass_adapt="dense") * SerialMC(*dense_run)`` at d 2048 and
    256 chains (9 mat; the generic warmup keeps a (d, d) factor and
    accumulator a chain, 4 GB each at 256), then ``resume(chains,
    steps=11)`` of the dense run (8 mat) with _resume_path's checks.  The
    warmups run on the generic engine.  First the routes at d 4096 and
    16385 (_nuts_routes).  Returns the chunked NUTS kernels' launches
    {name: (count, origin)}."""
    import mcmc_jl_tpu_torch as mt
    from mcmc_jl_tpu_torch.ops.glm_kernels import D_MAX
    from mcmc_jl_tpu_torch.ops.warmstart import _pick_k_trans

    _nuts_routes((CHUNKED_D, D_MAX + 1), n)
    steps, burnin, thin = run
    kept, kept_dense = steps - burnin, dense_run[0] - dense_run[1]
    counts, held = {}, {}
    for label, d, sampler, S, B, thinning, C, name, want in (
            ("unit", CHUNKED_D, mt.NUTS(6), steps, burnin, thin, chains,
             "glm_nuts_multistep_chunked", kept // _pick_k_trans(kept)),
            ("diag", CHUNKED_D, mt.NUTS(6, mass_adapt="diag"), steps - 3,
             burnin, thin, chains, "glm_nuts_transition_chunked", kept - 3),
            ("dense", CHUNKED_DENSE_D, mt.NUTS(6, mass_adapt="dense"),
             *dense_run, 1, chains_dense, "glm_nuts_multistep_mat_chunked",
             kept_dense // _pick_k_trans(kept_dense))):
        assert name != "glm_nuts_transition_chunked" or \
            _pick_k_trans(kept - 3) == 1
        X, Y, mode, _ = _wide_mode(n, d)
        m = mt.model(glm=("logistic", X, Y), init=mode, device="cuda")
        task = m * sampler * mt.SerialMC(steps=S, burnin=B,
                                         thinning=thinning)
        origin = _origin(m, task, C) + (f", thinning={thinning}"
                                        if thinning > 1 else "")
        cs, samples, launches, dt, spans = _path(origin, task, C,
                                                 {name: want})
        dg = {k: np.stack([c.diagnostics[k] for c in cs])
              for k in ("accept", "ndoublings", "diverging", "epsilon")}
        z = _z_means(samples.mean(1), means[d])
        emit({"phase": "chunked_nuts_path", "kernel": name, "from": origin,
              "d": d, "chains": C, "seconds": dt, "spans_s": spans,
              "launches": launches[name],
              "frozen_eps": float(dg["epsilon"][0, -1]),
              "accept_rate": float(dg["accept"].mean()),
              "mean_ndoublings": float(dg["ndoublings"].mean()),
              "diverging_share": float(dg["diverging"].mean()),
              "z_max_vs_adaptive_hmc": z, "ok": z < Z_MAX, **CARD})
        assert z < Z_MAX, f"{origin} disagrees with adaptive HMC"
        counts[name] = (launches[name], origin)
        if label == "dense":
            held[label] = [c.task for c in cs]
        del cs, samples
    S = CHUNKED_NUTS_RESUME
    assert _pick_k_trans(S) == 1
    origin = f"resume(NUTS(6, dense) chains of d {CHUNKED_DENSE_D}, steps={S})"
    _resume_path(origin, held.pop("dense"), S,
                 {"glm_nuts_transition_mat_chunked": S},
                 lambda s: _z_means(s.mean(1), means[CHUNKED_DENSE_D]),
                 by_chain=False)
    counts["glm_nuts_transition_mat_chunked"] = (S, origin)
    return counts


def phase_chunked_nuts_times(C=4096, N=1000, md=6, k_trans=2,
                             ds=CHUNKED_TIME_D, device_reps=1):
    """Per-launch time of kernels 8 and 9 (k_trans 2) on the chunked tier
    at the pinned shape: wide_data at N 1000, 4096 chains drawn from the
    Laplace approximation at the mode (seed d + 71), WIDE_NUTS_EPS (0.1)
    and md 6, with _nuts_kernel_times' columns (events over 2 launches,
    device ms over ``device_reps`` (1; the full run 0, a profiler session
    costs about 2 s) with the scalar prior at d 4096, the plain version,
    leaves, tile passes,
    bound at the 3xTF32 rate, occupancy and scratch plan) and the bytes of
    X the tiles read a leaf (two passes of the N x D design by every tile
    of 16 chains, ``x_bytes_a_leaf``): the scalar prior at d 2048 and 4096
    (CHUNKED_TIME_D, or ``ds``), the _mat forms on the dense fold (chains
    in z) at d 2048, the dense path's width, and (``ds`` with both) at
    4096.  The full run times d 4096 alone (the _mat forms at 2048).
    Returns ({kernel: (ms, plain ms)}, {kernel: bound}) for the scalar
    forms at d 4096 and the _mat forms at their widest d timed."""
    import torch

    from mcmc_jl_tpu_torch.ops.glm_kernels import _padded

    ms, work = {}, {}
    for d in sorted(set(ds) | {CHUNKED_DENSE_D}):
        f = _chunked_folds(N, d, C, seed=d + 71, spread=1.0)
        priors = (("scalar",) if d in ds else ()) + (
            ("matrix",) if d == CHUNKED_DENSE_D or len(ds) > 1 else ())
        for prior in priors:
            XT, Yc, th, lam = f[prior]
            lp, g = _lp_grad(XT, Yc, th, prior_prec=lam)
            lines = _nuts_kernel_times(
                XT, Yc, th, lp, g, WIDE_NUTS_EPS, md, k_trans, seed=d + 72,
                prior=lam, event_reps=2,
                device_reps=device_reps if (d == CHUNKED_D
                                            and prior == "scalar") else 0)
            x_tile = 8.0 * N * _padded(d)  # a tile's two passes
            for name, t in lines.items():
                emit({"phase": "chunked_nuts_x_reads", "name": name, "d": d,
                      "x_bytes_a_leaf": x_tile * -(-C // 16),
                      "x_bytes_launch": x_tile * t["tile_passes"], **CARD})
                if d == CHUNKED_D or name.startswith(
                        ("glm_nuts_transition_mat", "glm_nuts_multistep_mat")):
                    ms[name] = (t["ms"], t["plain_ms"])
                    work[name] = {k: t[k] for k in ("bound_ms", "bound_by")}
        del f
        torch.cuda.empty_cache()
    return ms, work


def phase_chunked_nuts_path_times(chains=1024, steps=12, burnin=4, n=1000):
    """Host seconds (to a synchronize) of NUTS(6) and NUTS(6, diag) on
    wide_data at d 4096, N 1000, from the posterior mode, over a shortened
    SerialMC(12, 4) (diag: 11, a prime count of kept transitions, kernel
    8), through the chunked kernels and through the generic engine at the
    same 1024 chains, each also less its packaging: what the width cost
    before kernels 8 and 9 took the chunked tier (every such GLM under
    NUTS ran the generic engine).  Returns {path: row}."""
    import torch

    import mcmc_jl_tpu_torch as mt

    X, Y, mode, _ = _wide_mode(n, CHUNKED_D)
    m = mt.model(glm=("logistic", X, Y), init=mode, device="cuda")
    out = {}
    for label, sampler, S in (
            ("NUTS(6), kernel 9", mt.NUTS(6), steps),
            ("NUTS(6, diag), kernel 8", mt.NUTS(6, mass_adapt="diag"),
             steps - 1)):
        task = m * sampler * mt.SerialMC(steps=S, burnin=burnin)
        row = {}
        for key, fused in (("fused", "auto"), ("generic", False)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with _spans() as spans:
                mt.run(task, chains=chains, seed=0, fused=fused)
            torch.cuda.synchronize()
            row[key + "_s"] = time.perf_counter() - t0
            row[key + "_less_packaging_s"] = (row[key + "_s"]
                                             - spans.get("packaging", 0.0))
        out[label] = row
        emit({"phase": "chunked_nuts_path_time", "path": label,
              "task": _origin(m, task, chains), "d": m.size, **row, **CARD})
    return out


# ---- the dense metric on catalog targets: kernels 5 and 8b in z-space -----

# the widths the dense kernel checks take: the lane layout's (template
# bounds 8 and 32) and the warp layout's (4 and 32 coordinates a lane, the
# wide paths' width, the kernels' bound D_MAX)
DENSE_TARGET_D = (1, 10, 32, 33, 150, 1024)
# the widths the dense kernels are timed at beside the non-dense
# instantiation and the plain version
DENSE_TARGET_TIME_D = (10, 33, 150, 1024)


def _dense_factor(s, seed, mix=0.3):
    """A seeded lower-triangular Cholesky factor (float64 numpy) of the SPD
    matrix diag(s) ((1 - mix) I + mix A A' / d) diag(s), A (d, d) standard
    normal: the scales s, with correlations of about mix / sqrt(d) between
    every pair of coordinates."""
    d = len(s)
    A = np.random.default_rng(seed).standard_normal((d, d))
    corr = (1 - mix) * np.eye(d) + mix * (A @ A.T) / d
    return np.linalg.cholesky(corr * np.outer(s, s))


def _dense_mixed(dd, seed):
    """The ten-family mixed target at dd coordinates seen through a seeded
    dense factor of its scales (_dense_factor): (the DenseTarget on the
    card, each coordinate's point and scale, L as float64 numpy)."""
    import torch

    from mcmc_jl_tpu_torch.models.distributions import DenseTarget

    mixed, x0, sc = _mixed_target(dd)
    L = _dense_factor(sc, seed)
    return DenseTarget(mixed, torch.as_tensor(L, device="cuda")), x0, sc, L


def phase_dense_target_kernels(C=4096, ragged=4099, big_C=65_536, md=6):
    """Kernels 5 and 8b on dense targets (their DENSE instantiations, which
    count as target_leapfrogs_dense and target_nuts_transition_dense)
    against their plain versions on the card: the ten-family mixed target
    at each d of DENSE_TARGET_D (1, 10 and 32 one chain per lane; 33, 150
    and 1024 one warp per chain) through a seeded non-identity factor
    (_dense_mixed), C chains from z = L^-1 theta, theta each coordinate's
    point plus 0.05 of its scale times a normal.

    Kernel 5: 10 leapfrogs at the scalar step 0.02 (the lane phase's row
    0.02 s, in theta), theta, m and g within T_RTOL and T_ATOL, lp within
    T_LP_RTOL and T_LP_ATOL_PER_COORD a coordinate (-inf at the same
    chains), a bitwise repeat (_traj_case); at d 10 also on the same chains
    and gradient tiled to big_C (four warps a block where C takes D warps),
    theta, m and g bitwise the same (the gradient is given: the plain
    version's z @ L' rounds by the batch's size), and with the 2stage
    integrator; at d 10 and 33 at ``ragged`` chains (a ragged last group).
    Kernel 8b on injected noise: slice at step 0.01 at every d (trees of
    all md doublings) and at ``ragged`` chains at d 10 and 33, multinomial
    at 0.1 at d 10 and 150 (most trees diverge: the factor moves every
    coordinate, and the narrow supports end them); PATH_AGREE of the
    chains on the plain path, a bitwise repeat (_target_nuts_case).  A step row on a
    dense target raises (d > 1).  Returns {kernel: max abs error}."""
    import torch

    from mcmc_jl_tpu_torch.ops import target_kernels as tk

    rng = np.random.default_rng(81)
    err5 = err8 = 0.0
    bad = []

    def note(ok, label):
        if not ok:
            bad.append(label)

    def traj(label, target, th, m, **kw):
        nonlocal err5
        outs = []
        ok, e = _traj_case(label, target, th, m, 0.02, outs=outs,
                           repeat=True, **kw)
        note(ok, f"kernel 5 dense {label}")
        err5 = max(err5, e)
        return outs[0]

    def nuts(label, target, th, eps, seed, multinomial=False, **kw):
        nonlocal err8
        ok, e = _target_nuts_case(f"{label}, eps {eps}", target, th, eps,
                                  seed, md=md, multinomial=multinomial, **kw)
        note(ok, f"kernel 8b dense {label}")
        err8 = max(err8, e)

    for i, dd in enumerate(DENSE_TARGET_D):
        target, x0, sc, L = _dense_mixed(dd, seed=dd)
        label = f"mixed ten families through a dense factor, d = {dd}"
        th = _cuda(_dense_start(L, x0, 0.05 * sc, C, seed=200 + i))
        m = _cuda(rng.standard_normal((C, dd)))
        g = tk.target_funcs(target)[1](th)[1].contiguous()
        out = traj(f"{label}, C {C}", target, th, m, grad=g)
        nuts(f"{label}, C {C}, slice", target, th, 0.01, 210 + i,
             full_depth=True)
        if dd in (10, 150):
            nuts(f"{label}, C {C}, multinomial", target, th, 0.1, 220 + i,
                 multinomial=True, want_div=True)
        if dd == 10:
            reps = big_C // C
            tiled = traj(f"{label}, C {big_C}", target, th.repeat(reps, 1),
                         m.repeat(reps, 1), grad=g.repeat(reps, 1))
            ws = [tk.target_leapfrogs_plan(dd, c, dense=True)["warps"]
                  for c in (C, big_C)]
            same = all(torch.equal(a[:C], b)
                       for a, b in zip(tiled[:3], out[:3]))
            ok = same and ws[0] != ws[1]
            emit({"phase": "kernel", "name": "target_leapfrogs_dense",
                  "case": f"{label}: theta, m, g bitwise at C {C} and "
                          f"{big_C}", "warps": ws, "bitwise": same,
                  "ok": ok})
            note(ok, f"kernel 5 dense d {dd}: W {ws} bitwise")
            traj(f"{label}, C {C}, 2stage", target, th, m, n_leaps=7,
                 integrator="2stage")
        if dd in (10, 33):
            thr = _cuda(_dense_start(L, x0, 0.05 * sc, ragged, seed=230 + i))
            traj(f"{label}, C {ragged}", target, thr,
                 _cuda(rng.standard_normal((ragged, dd))))
            nuts(f"{label}, C {ragged}, slice", target, thr, 0.01, 240 + i)
        if dd > 1:  # (a (1,) row is the scalar)
            try:
                tk.fused_target_leapfrogs(target, th, m, g, _cuda(0.02 * sc))
                note(False, f"kernel 5 dense d {dd}: a step row was taken")
            except ValueError:
                pass
        del th, m, out, g
    assert not bad, f"the dense kernels disagree: {bad}"
    return {"target_leapfrogs_dense": err5,
            "target_nuts_transition_dense": err8}


def phase_dense_target_paths(chains=4096, generic_chains=512,
                             generic_steps=30):
    """The dense metric on catalog targets through ``run(..., chains=C)``,
    float32, each with every count zeroed just before it and read just
    after, no plain call:

    - ``NUTS(maxdoublings=6, mass_adapt="dense") * SerialMC(1100, 100)`` on
      the ten bare distributions (the unit-metric 8b path's model and
      runner): 1000 launches of target_nuts_transition_dense;
    - ``HMC(10, 0.05, EmpMCTuner(0.8, adapt_step=50), mass_adapt="dense")
      * SerialMC(600, 200)`` on ``model(x ~ Gamma(3, 0.2))`` at d 10 (the
      kernel-5 path's target, phase_target_paths): 400 launches of
      target_leapfrogs_dense;

    the generic warmups' gradients on target_logp_grad.  Each is held
    against the target's exact first and second moments (the ten bare
    distributions on the six coordinates of sd at most NARROW_SD, as the
    unit-metric path is, and the z over all ten reported) and against the
    generic engine's dense run: ``generic_chains`` of the run's chains
    continued ``generic_steps`` transitions by ``resume(...,
    fused=False)`` from the same frozen state (the fused run's warmup is
    the generic engine's own, so the sampling phase is what the routes do
    apart; a whole generic run of the NUTS task at 512 chains would take
    about 90 s), per-chain moments within Z_MAX on the same coordinates.
    Returns ({kernel and the gradient pass: (launches, origin)}, {"nuts":
    the NUTS run's tasks, "hmc": the HMC run's} for phase_resume_paths,
    the folds the dense times take: {"nuts": (L, frozen eps, None, the
    run's final theta), "hmc": (L, frozen eps, frozen leap count, the run's
    final theta)})."""
    import torch

    import mcmc_jl_tpu_torch as mt

    m_bare, bare = _ten_bare_model()
    narrow = [j for j, (_, dist, _) in enumerate(bare)
              if float(dist.std()) <= NARROW_SD]
    gamma = mt.Gamma(3.0, 0.2)
    m_gamma = mt.model(lambda x: mt.tilde(x, gamma), x=np.full(10, 1.1),
                       gradient=True, device="cuda")
    assert m_gamma.target_spec is not None

    def gamma_z(s):
        return _moments_z((s.mean(1), (s ** 2).mean(1)), gamma)

    runs = (
        ("nuts", "ten bare distributions ~, d=10", m_bare,
         mt.NUTS(maxdoublings=6, mass_adapt="dense"), 1100, 100,
         "target_nuts_transition_dense", narrow,
         lambda s, cols=None: _bare_z(s, bare, cols)),
        ("hmc", "x ~ Gamma(3,0.2), x=fill(1.1, 10)", m_gamma,
         mt.HMC(10, 0.05, mt.EmpMCTuner(0.8, adapt_step=50),
                mass_adapt="dense"), 600, 200, "target_leapfrogs_dense",
         None, lambda s, cols=None: gamma_z(s)),
    )
    counts, held, folds, bad = {}, {}, {}, []
    for key, label, m, sampler, steps, burnin, kernel, cols, exact in runs:
        task = m * sampler * mt.SerialMC(steps=steps, burnin=burnin)
        origin = (f"run(model({label}) * {sampler!r} * SerialMC({steps}, "
                  f"{burnin}), chains={chains})")
        cs, samples, launches, dt, spans = _path(
            origin, task, chains, {kernel: steps - burnin,
                                   "target_logp_grad": lambda n: n > 0})
        L = _pooled_factor(cs)
        st = cs[0].task.state
        if key == "nuts":
            eps, nl = float(cs[0].diagnostics["epsilon"][-1]), None
        else:
            eps, nl = st.tune.step_size.item(), st.tune.n_leaps.item()
        z_all = exact(samples)
        z_ex = exact(samples, cols)
        t0 = time.perf_counter()
        gcs = mt.resume([c.task for c in cs[:generic_chains]],
                        steps=generic_steps, fused=False)
        gen_s = time.perf_counter() - t0
        gs = np.stack([c.samples.values for c in gcs])
        sel = slice(None) if cols is None else cols
        a, b = samples[..., sel], gs[..., sel]
        z_gen = max(_z_means(a.mean(1), b.mean(1)),
                    _z_means((a ** 2).mean(1), (b ** 2).mean(1)))
        ok = z_ex < Z_MAX and z_gen < Z_MAX
        extra = {}
        if "ndoublings" in cs[0].diagnostics:
            extra["mean_ndoublings"] = float(np.mean(
                [c.diagnostics["ndoublings"] for c in cs]))
        emit({"phase": "dense_target_path", "kernel": kernel, "from": origin,
              "chains": chains, "seconds": dt, "spans_s": spans,
              "launches": launches[kernel],
              "gradient_pass_launches": launches["target_logp_grad"],
              "frozen_eps": eps, "frozen_n_leaps": nl,
              "factor_diag": np.diag(L).tolist(),
              "factor_offdiag_max": float(np.abs(np.tril(L, -1)).max()),
              "accept_rate": float(np.mean([mt.acceptance(c)
                                            for c in cs])) / 100,
              **extra, "pooled_mean": samples.mean((0, 1)).tolist(),
              "held_on": "all" if cols is None
              else [bare[j][0] for j in cols],
              "z_max_vs_exact": z_ex, "z_max_all_coordinates": z_all,
              "generic": {"chains": generic_chains, "steps": generic_steps,
                          "seconds": gen_s}, "z_max_vs_generic": z_gen,
              "ok": ok, **CARD})
        if not ok:
            bad.append(origin)
        counts[kernel] = (launches[kernel], origin)
        held[key] = [c.task for c in cs]
        folds[key] = (L, eps, nl, torch.stack(
            [c.task.state.pars for c in cs]).double().cpu().numpy())
        del cs, gcs, samples, gs
    assert not bad, f"dense target paths disagree: {bad}"
    return counts, held, folds


def phase_dense_target_times(folds=None, C=4096, md=6,
                             ds=DENSE_TARGET_TIME_D):
    """Per-launch times of kernels 5 and 8b on dense targets beside their
    plain versions and the non-dense instantiation on the base target at
    the same states (theta = z L') and step (what the z-space pass costs),
    with the bound: the catalog kernel's operations (TARGET_LEAP_OPS d a
    leapfrog or leaf) plus the z-space pass's 2 d (d + 1) a gradient pass
    (_dense_pass_ops), or the bytes (the factor's L and L' among the
    inputs).  With ``folds`` (phase_dense_target_paths) first at the paths'
    shapes, which the kernels line reports: kernel 5 on the dense HMC
    path's Gamma target through its frozen factor, at its frozen step and
    leap count from its final positions, and kernel 8b on the ten bare
    distributions through the dense NUTS path's factor at its frozen step
    from its final positions; then both on the mixed ten-family target
    through a seeded factor (_dense_mixed) at each d of ``ds`` (the full
    run takes none, --times all of DENSE_TARGET_TIME_D), C
    chains, kernel 5 10 leapfrogs at 0.02 and 8b at 0.01 (on the dense
    target trees of all md doublings; a tree's leaves differ between the
    two targets: compare 8b by its ms a leaf).  Returns ({kernel: (ms,
    plain ms)}, {kernel: bound and device ms}) at the paths' shapes (empty
    without folds)."""
    import torch

    import mcmc_jl_tpu_torch as mt
    from mcmc_jl_tpu_torch.models.distributions import DenseTarget

    def pair(base, L, theta):
        """(dense target, its start z; the base target, its start)."""
        z = np.linalg.solve(L, np.asarray(theta, np.float64).T).T
        return ((DenseTarget(base, torch.as_tensor(L, device="cuda")),
                 _cuda(z)), (base, _cuda(theta)))

    def nuts_time(label, target, th, eps, seed):
        r = _target_nuts_kernel_time(target, th, eps, md, seed=seed,
                                     plain=hasattr(target, "factor"))
        r["ms_per_leaf"] = r["ms"] / max(r["leaves"], 1)
        emit({"phase": "kernel_time",
              "name": _dense_name("target_nuts_transition", target),
              "target": label, **r, **CARD})
        return r

    ms, work = {}, {}
    keep = ("bound_ms", "bound_by", "device_ms")
    if folds is not None:
        L, eps, nl, theta = folds["hmc"]
        gam = mt.model(lambda x: mt.tilde(x, mt.Gamma(3.0, 0.2)),
                       x=np.full(10, 1.1), gradient=True,
                       device="cuda").target_spec
        label = ("x ~ Gamma(3,0.2) through the dense HMC path's factor, its "
                 "frozen step and leap count")
        (dt, z), (bt, th) = pair(gam, L, theta[:C])
        r = _traj_time(label, dt, z, eps, nl, seed=5, plain=True)
        _traj_time(label, bt, th, eps, nl, seed=5)
        ms["target_leapfrogs_dense"] = (r["ms"], r["plain_ms"])
        work["target_leapfrogs_dense"] = {k: r[k] for k in keep}
        L, eps, _, theta = folds["nuts"]
        m, _ = _ten_bare_model()
        label = ("ten bare distributions through the dense NUTS path's "
                 "factor, its frozen step")
        (dt, z), (bt, th) = pair(m.target_spec, L, theta[:C])
        r = nuts_time(label, dt, z, eps, 9)
        nuts_time(label, bt, th, eps, 9)
        ms["target_nuts_transition_dense"] = (r["ms"], r["plain_ms"])
        work["target_nuts_transition_dense"] = {k: r[k] for k in keep}
    for dd in ds:
        target, x0, sc, L = _dense_mixed(dd, seed=dd)
        rng = np.random.default_rng(300 + dd)
        theta = x0 + 0.05 * sc * rng.standard_normal((C, dd))
        label = f"mixed ten families through a dense factor, d = {dd}"
        for t, th in pair(target.base, L, theta):
            _traj_time(label, t, th, 0.02, 10, seed=6,
                       plain=hasattr(t, "factor"))
            nuts_time(label, t, th, 0.01, 10)
    return ms, work


def step(name, fn, *args, **kw):
    """``fn(*args, **kw)``, then a line with its seconds."""
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    emit({"phase": "seconds", "of": name,
          "seconds": time.perf_counter() - t0})
    return out


def main():
    phase_device()
    import torch

    step("build", phase_build)
    errors = step("kernels", phase_kernels)
    errors.update(step("nuts_kernels", phase_nuts_kernels))
    errors.update(step("rows_kernel", phase_rows_kernel))
    errors.update(step("bign_kernels", phase_bign_kernels))
    for name, e in step("tile_kernels", phase_tile_kernels).items():
        errors[name] = max(errors[name], e)
    step("cross_kernel", phase_cross_kernel)
    errors.update(step("target_kernels", phase_target_kernels))
    for name, e in step("target_lane_kernels",
                        phase_target_lane_kernels).items():
        errors[name] = max(errors[name], e)
    errors.update(step("target_nuts_kernels", phase_target_nuts_kernels))
    errors.update(step("wide_kernels", phase_wide_kernels))
    errors.update(step("wide_nuts_kernels", phase_wide_nuts_kernels))
    errors.update(step("xwide_kernels", phase_xwide_kernels))
    errors.update(step("xwide_nuts_kernels", phase_xwide_nuts_kernels))
    errors.update(step("chunked_kernels", phase_chunked_kernels))
    errors.update(step("chunked_nuts_kernels", phase_chunked_nuts_kernels))
    errors.update(step("dense_target_kernels", phase_dense_target_kernels))
    # each kernel's launches, counted from zero over one run of the entry
    # point that reaches it: run(..., chains=N) for the trajectory kernel,
    # the two NUTS kernels, the Halton multistep kernel and the tiled
    # kernel, the bench drivers for the step and multistep kernels
    # the chains' tasks each path phase hands to phase_resume_paths
    held = {}
    launches, final, held["hmc"] = step("main_path", phase_main_path)
    launches.update(step("drivers", phase_drivers, final))
    hmc_means = step("hmc_reference", _hmc_reference, final)
    nuts_launches, start, held["nuts"] = step(
        "nuts_main_path", phase_nuts_main_path, hmc_means)
    launches.update(nuts_launches)
    bign_launches, held["bign"] = step("large_n_paths", phase_large_n_paths)
    launches.update(bign_launches)
    warm_launches, hmc_frozen, held["warm"] = step(
        "warm_paths", phase_warm_paths, hmc_means)
    launches.update(warm_launches)
    launches.update(step("target_paths", phase_target_paths))
    nuts_t, start_t, held["target"] = step("warm_target_paths",
                                           phase_warm_target_paths)
    launches.update(nuts_t)
    step("chees_glm_path", phase_chees_glm_path, hmc_means)
    # the dense metric's paths, then its four matrix-prior variants held
    # against their plain versions on those paths' own folds
    dense_launches, folds = step("dense_paths", phase_dense_paths, hmc_means,
                                 held["bign"][1])
    launches.update(dense_launches)
    errors.update(step("dense_kernels", phase_dense_kernels, folds))
    # the dense metric on catalog targets (kernels 5 and 8b in z-space)
    dense_t_launches, held["dense_target"], dense_t_folds = step(
        "dense_target_paths", phase_dense_target_paths)
    launches.update(dense_t_launches)
    wide_launches, gmeans = step("wide_paths", phase_wide_paths)
    launches.update(wide_launches)
    launches.update(step("wide_nuts_paths", phase_wide_nuts_paths, gmeans))
    del gmeans
    xwide_launches, xwide_means = step("xwide_paths", phase_xwide_paths)
    launches.update(xwide_launches)
    launches.update(step("xwide_nuts_paths", phase_xwide_nuts_paths,
                         xwide_means))
    del xwide_means
    chunked_launches, chunked_means = step("chunked_paths",
                                           phase_chunked_paths)
    launches.update(chunked_launches)
    launches.update(step("chunked_nuts_paths", phase_chunked_nuts_paths,
                         chunked_means))
    del chunked_means
    resume_rows = step("resume_paths", phase_resume_paths, held, hmc_means)
    del held
    # Barker, WALNUTS, IMH, RAM, slice_sample and the information criteria
    # on the generic engine (Barker and WALNUTS through the gradient pass)
    step("generic_samplers", phase_generic_samplers, final)
    # SMMALA, PMALA, RMHMC, ERMLMC and RMLMC on the generic engine: the
    # Fisher-metric logistic model against kernel 1's HMC, and SMMALA and
    # RMHMC through the gradient pass on a catalog model
    step("manifold_samplers", phase_manifold_samplers)
    # PTMC, ASMC, AIES, SeqMC, SerialTempMC and run_until (its frozen blocks
    # through kernels 9 and 3b; the tempered runners' gradients through the
    # gradient pass on a catalog model)
    step("ensemble_runners", phase_ensemble_runners, hmc_means)
    # the distributed drivers on meshes of virtual shards of the one card:
    # kernels 1, 5 and 4 sharded, run (3b, 9, 8 and 8b a shard), PTMC,
    # ASMC and run_until with mesh=
    mesh_launches = step("mesh_paths", phase_mesh_paths, hmc_means)
    # NUTS(warm_handoff=True): its sampling phase on kernels 3b, 5 and 4,
    # and two resumes on 3b
    step("warm_handoff", phase_warm_handoff, hmc_means)
    # examples_torch/warmstart_logistic.py at 2048 chains and its
    # continuation through throughput_report; a traced kernel-1 call
    step("examples", phase_examples)
    missing = [k for k in REPLACES if launches.get(k, (0,))[0] == 0]
    assert not missing, f"kernels never launched on the main path: {missing}"
    step("timing", phase_timing, steps=200, reps=2)
    # kernels 1-4 at the shapes whose launches are counted above (1-3 also
    # at bench.py's 65536 chains)
    ms, work = step("tile_times", phase_tile_times)
    for more in (step("nuts_timing", phase_nuts_timing, start),
                 step("new_kernel_times", phase_new_kernel_times, hmc_frozen),
                 step("target_kernel_times", phase_target_times),
                 step("target_nuts_time", phase_target_nuts_time, start_t),
                 step("dense_times", phase_dense_times, folds),
                 step("dense_target_times", phase_dense_target_times,
                      dense_t_folds, ds=()),
                 step("wide_times", phase_wide_times, ds=(WIDE_D,)),
                 step("wide_nuts_times", phase_wide_nuts_times,
                      ds=(WIDE_D,)),
                 step("xwide_times", phase_xwide_times, ds=(XWIDE_D,),
                      paths=False),
                 step("xwide_nuts_times", phase_xwide_nuts_times,
                      ds=(XWIDE_D,), deep_C=0),
                 step("chunked_times", phase_chunked_times,
                      ds=(CHUNKED_D,), paths=False),
                 step("chunked_nuts_times", phase_chunked_nuts_times,
                      ds=(CHUNKED_D,), device_reps=0)):
        ms.update(more[0])
        work.update(more[1])
    # the wide paths' generic-against-fused seconds (phase_wide_path_times,
    # phase_wide_nuts_path_times) run in the --times groups wide_paths and
    # wide_nuts_paths, the wide NUTS kernels at d 256 in wide_nuts, the
    # dense catalog kernels across d in dense_target, the wide kernels at d
    # 256 in wide, the very-wide ones at d 512 in xwide and xwide_nuts, the
    # chunked ones at d 2048 in chunked and chunked_nuts, and the very-wide
    # and chunked paths' fused-against-generic seconds in xwide, chunked
    # and chunked_nuts, out of this run for its time
    emit({"resume": resume_rows})
    # no single PyTorch call computes any of these functions: library_ms
    # is null (the two products alone are timed in new_kernel_times)
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[lib],
         "replaces": replaces, "launches": launches[name][0],
         "from": launches[name][1],
         "mesh_launches": mesh_launches.get(name, 0),
         "max_abs_err": errors[name],
         "ms": ms[name][0], "plain_ms": ms[name][1], **work[name],
         "library_ms": None}
        for name, (lib, replaces) in REPLACES.items()]})
    print(CARD["card"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": CARD["kind"],
                                 "count": CARD["count"]}})
    torch.cuda.synchronize()


def phase_generic_samplers(final, chains=4096, walnuts_chains=1024,
                           slice_iters=1000, walnuts_run=(30, 10)):
    """The samplers that run on the generic engine in both packages, at
    d = 10 in float32 on the card, each through ``run(..., chains=N)`` with
    every count zeroed just before it and read just after, and each held
    to the exact moments of its target (every coordinate's mean and second
    moment, |z| < Z_MAX over the per-chain means):

    - ``Barker(0.3, EmpMCTuner(0.57, adapt_step=25)) * SerialMC(400, 100)``
      on ``x ~ Gamma(3, 0.2)``, 4096 chains: every (logp, grad) is one
      launch of the gradient pass ``target_logp_grad`` (one a transition
      and one at init); ``linear_zv`` of chain 0 lowers its variance;
    - ``WALNUTS(multinomial=True, maxdoublings=5) * SerialMC(*walnuts_run)``
      (30, 10; (150, 50) cut for the script's time) on the same
      model, 1024 chains: gradient-pass launches
      counted, and no
      launch of the NUTS kernels 8, 8b or 9 (WALNUTS takes the generic
      engine, pchains._route);
    - ``IMH(MvNormal(1, 4 I))`` and ``RAM(1.0, 0.3)`` with
      ``SerialMC(1000, 200)`` on ``x ~ Normal(1, 1)`` from x = 0, 4096
      chains (they take no gradient).  The IMH proposal is centred on the
      target: off centre, MvNormal(0, 4 I) has an importance weight that
      peaks at 2.36^10 ~ 5300, and independence chains from it are still
      biased after 1000 steps (the same chains simulated in numpy: pooled
      mean 0.968, |z| 6.3 at 4096 chains); centred, the peak is 2^10;
    - ``slice_sample`` on a correlated 2-D Gaussian, ``slice_iters``
      iterations on a CUDA tensor: each mean within Z_MAX standard errors (from its ESS);
    - ``pointwise_loglik`` of the logistic GLM (N 1000) over the HMC main
      path's last draws ``final`` (chains, 10) on the card; ``waic`` and
      ``psis_loo`` of it are finite, the largest k-hat printed.

    Returns {path: seconds}."""
    import torch

    import mcmc_jl_tpu_torch as mt

    seconds = {}
    gamma, normal = mt.Gamma(3.0, 0.2), mt.Normal(1.0, 1.0)
    grad_pass = {"target_logp_grad": lambda n: n > 0}
    runs = [
        ("barker", gamma, 1.1, mt.Barker(0.3, mt.EmpMCTuner(0.57,
                                                            adapt_step=25)),
         400, 100, chains, grad_pass),
        ("walnuts", gamma, 1.1, mt.WALNUTS(multinomial=True, maxdoublings=5),
         *walnuts_run, walnuts_chains, grad_pass),
        ("imh", normal, 0.0, mt.IMH(mt.MvNormal(
            torch.ones(10, device="cuda"),
            4.0 * torch.eye(10, device="cuda"))), 1000, 200, chains, {}),
        ("ram", normal, 0.0, mt.RAM(1.0, 0.3), 1000, 200, chains, {})]
    for name, dist, x0, sampler, steps, burnin, n, want in runs:
        m = mt.model(lambda x, _d=dist: mt.tilde(x, _d), x=np.full(10, x0),
                     gradient=True, device="cuda")
        assert m.target_spec is not None, name
        task = m * sampler * mt.SerialMC(steps=steps, burnin=burnin)
        origin = (f"run(model(x ~ {dist!r}, x=fill({x0:g}, 10)) * "
                  f"{sampler!r} * SerialMC({steps}, {burnin}), chains={n})")
        cs, samples, launches, dt, _ = _path(origin, task, n, want)
        z_ex = _moments_z((samples.mean(1), (samples ** 2).mean(1)), dist)
        grads = launches["target_logp_grad"]
        row = {"phase": "generic_sampler", "sampler": name, "from": origin,
               "chains": n, "seconds": dt, "grad_pass_launches": grads,
               "grad_pass_per_transition": grads / steps,
               "accept_rate": float(np.mean([mt.acceptance(c)
                                             for c in cs])) / 100,
               "pooled_mean": float(samples.mean()),
               "exact_mean": float(dist.mean()),
               "pooled_sd": float(samples.std()),
               "exact_sd": float(dist.std()), "z_max_vs_exact": z_ex}
        if name == "barker":
            assert grads == steps + 1, launches
            zv, _ = mt.linear_zv(cs[0])
            raw = cs[0].samples.values.astype(np.float64).var(0)
            row["zv_var_ratio_max"] = float(np.max(zv.var(0) / raw))
            assert np.all(zv.var(0) <= raw), (zv.var(0), raw)
        if name == "walnuts":
            for k in ("glm_nuts_transition", "glm_nuts_multistep",
                      "target_nuts_transition",
                      "target_nuts_transition_dense"):
                assert launches.get(k, 0) == 0, launches
            row["irreversible_share"] = float(np.mean(np.concatenate(
                [c.diagnostics["irreversible"] for c in cs])))
            row["mean_ndoublings"] = float(np.mean(np.concatenate(
                [c.diagnostics["ndoublings"] for c in cs])))
        ok = z_ex < Z_MAX
        emit({**row, "ok": ok, **CARD})
        assert ok, f"{origin} disagrees with the exact moments"
        seconds[name] = dt
        print(f"generic_samplers {name}: {dt:.3f} s, {grads} gradient-pass "
              f"launches ({grads / steps:.3f} a transition); {CARD['card']}",
              flush=True)

    # the standalone slice sampler on a CUDA tensor
    mu = torch.tensor([1.0, -2.0], device="cuda")
    prec = torch.linalg.inv(torch.tensor([[1.0, 0.6], [0.6, 2.0]],
                                         device="cuda"))

    def gauss(q):
        r = q - mu
        return -0.5 * (r @ prec @ r)

    t0 = time.perf_counter()
    hist = mt.slice_sample(gauss, torch.zeros(2, device="cuda"),
                           slice_iters, widths=2.0, seed=5)
    dt = time.perf_counter() - t0
    assert hist.shape == (slice_iters, 2) and np.all(np.isfinite(hist))
    se = hist.std(0) / np.sqrt(mt.ess(hist))
    z = float(np.max(np.abs(hist.mean(0) - mu.cpu().numpy()) / se))
    ok = z < Z_MAX
    emit({"phase": "generic_sampler", "sampler": "slice_sample",
          "from": f"slice_sample(2-D Gaussian, zeros(2), {slice_iters}, "
                  f"widths=2.0)", "seconds": dt, "mean": hist.mean(0).tolist(),
          "exact_mean": mu.tolist(), "ess": mt.ess(hist).tolist(),
          "z_max_vs_exact": z, "ok": ok, **CARD})
    assert ok, "slice_sample disagrees with its target's mean"
    seconds["slice_sample"] = dt
    print(f"generic_samplers slice_sample: {dt:.3f} s; {CARD['card']}",
          flush=True)

    # information criteria over the HMC main path's last draws
    X, Y = bench_data()
    Xt = torch.tensor(X, dtype=torch.float32, device="cuda")
    Yt = torch.tensor(Y, dtype=torch.float32, device="cuda")

    def loglik_pw(theta):
        z = Xt @ theta
        return Yt * z - torch.nn.functional.softplus(z)

    t0 = time.perf_counter()
    ll = mt.pointwise_loglik(loglik_pw, torch.as_tensor(final,
                                                        device="cuda"))
    w, loo = mt.waic(ll), mt.psis_loo(ll)
    dt = time.perf_counter() - t0
    assert ll.shape == (len(final), X.shape[0]) and np.all(np.isfinite(ll))
    ok = (all(np.isfinite(w[k]) for k in ("elpd_waic", "p_waic", "waic",
                                          "se"))
          and all(np.isfinite(loo[k]) for k in ("elpd_loo", "p_loo", "looic",
                                                "se"))
          and np.all(np.isfinite(loo["pareto_k"])))
    emit({"phase": "generic_sampler", "sampler": "pointwise_loglik",
          "from": f"pointwise_loglik(logistic GLM N {X.shape[0]}, the HMC "
                  f"main path's last draws ({len(final)}, {X.shape[1]}))",
          "seconds": dt, "waic": w["waic"], "p_waic": w["p_waic"],
          "looic": loo["looic"], "p_loo": loo["p_loo"],
          "max_pareto_k": float(np.max(loo["pareto_k"])), "ok": bool(ok),
          **CARD})
    assert ok, "waic / psis_loo of the main path's draws are not finite"
    seconds["pointwise_loglik"] = dt
    print(f"generic_samplers pointwise_loglik + waic + psis_loo: {dt:.3f} s,"
          f" max k-hat {float(np.max(loo['pareto_k'])):.4f}; {CARD['card']}",
          flush=True)
    return seconds


# the manifold workload: benchmarks/benchunits/manifold.py's Fisher-metric
# logistic model (D 8, N 200, seed 11, prior precision 1), and the HMC step
# of its reference run through kernel 1 (its Laplace sds are 0.15-0.28, so
# ten leapfrogs of 0.1 cross them)
MANIFOLD_D, MANIFOLD_N, MANIFOLD_HMC_EPS = 8, 200, 0.1
# the manifold steps on x ~ Gamma(3, 0.2) (d 10, G = 2 / x^2): SMMALA at
# 0.1 accepts about 38%; RMHMC's generalized leapfrog stops converging on
# this metric above a leap of 0.2 (its fixed-point sweeps, the JAX
# package's alike: at 0.3 both accept 89% and the mean is 0.608, |z| 7.2
# at 2048 chains in a CPU run), so RMHMC runs at 0.2 and accepts about 96%
GAMMA_SMMALA_EPS, GAMMA_RMHMC_EPS = 0.1, 0.2


def manifold_data():
    """benchmarks/benchunits/manifold.py ``_posterior``'s data: D 8 (an
    intercept and 7 standard normal covariates), N 200, seed 11."""
    rng = np.random.default_rng(11)
    X = np.column_stack([np.ones(MANIFOLD_N),
                         rng.standard_normal((MANIFOLD_N, MANIFOLD_D - 1))])
    beta = rng.standard_normal(MANIFOLD_D) * 0.6
    Y = (rng.random(MANIFOLD_N) < 1.0 / (1.0 + np.exp(-X @ beta))).astype(
        np.float64)
    return X, Y


def _fisher_logistic(X, Y):
    """The Girolami-Calderhead logistic posterior (prior precision 1) with
    the unit's closed forms (manifold.py:38-64): the gradient, the Fisher
    metric ``X' diag(p(1-p)) X + I`` and its derivative ``dG_k = X'
    diag(p(1-p)(1-2p) x_k) X``, float32 on the card."""
    import torch

    import mcmc_jl_tpu_torch as mt

    Xt, Yt = _cuda(X), _cuda(Y)
    eye = torch.eye(X.shape[1], device="cuda")

    def logp(t):
        z = Xt @ t
        return (Yt * z - torch.nn.functional.softplus(z)).sum() - 0.5 * t @ t

    def grad(t):
        return Xt.T @ (Yt - torch.sigmoid(Xt @ t)) - t

    def tensor(t):
        p = torch.sigmoid(Xt @ t)
        return (Xt * (p * (1.0 - p))[:, None]).T @ Xt + eye

    def dtensor(t):
        p = torch.sigmoid(Xt @ t)
        wp = p * (1.0 - p) * (1.0 - 2.0 * p)
        return torch.einsum("n,na,nb,nk->abk", wp, Xt, Xt, Xt)

    return mt.model(logp, grad=grad, tensor=tensor, dtensor=dtensor,
                    init=np.zeros(X.shape[1]), check_init=False,
                    device="cuda")


def _per_chain(samples):
    """(pooled mean, its standard error from the spread of the per-chain
    means, pooled sd), each (d,), of samples (chains, kept, d)."""
    m = samples.astype(np.float64).mean(1)
    return (m.mean(0), m.std(0, ddof=1) / np.sqrt(len(m)),
            samples.reshape(-1, samples.shape[-1]).astype(np.float64).std(0))


def phase_manifold_samplers(chains=4096, heavy_chains=1024,
                            gamma_chains=1024):
    """The manifold tier (SMMALA, PMALA, RMHMC, ERMLMC, RMLMC) on the
    generic engine, float32 on the card, each through ``run(...,
    chains=N)`` with every count zeroed just before it and read just after:

    - (a) benchmarks/benchunits/manifold.py's Fisher-metric logistic model
      (``manifold_data``, closed-form metric) at the unit's settings:
      ``SMMALA(1.0)`` and ``PMALA(1.0)`` with ``SerialMC(400, 100)`` at
      ``chains``; ``RMHMC(4, 0.5)``, ``ERMLMC(4, 0.3)`` and ``RMLMC(4,
      0.3)`` with ``SerialMC(80, 20)`` (the unit's (120, 30), cut for the
      script's time) at ``heavy_chains``; no kernel
      launches.  Each is held to the reference ``run(model(glm=("logistic",
      X, Y)) * HMC(10, MANIFOLD_HMC_EPS) * SerialMC(600, 200),
      chains=chains)`` through kernel 1 (its launches counted): pooled
      means within Z_MAX standard errors (from the spread of the per-chain
      means in each run), sds within 20%, acceptance above 5%;
    - (b) ``x ~ Gamma(3, 0.2)``, d 10, a float32 catalog model with
      ``gradient=True, tensor=True, dtensor=True``: ``SMMALA *
      SerialMC(400, 150)`` and ``RMHMC(4) * SerialMC(30, 10)`` at
      ``gamma_chains`` (steps GAMMA_SMMALA_EPS, GAMMA_RMHMC_EPS), held to
      the exact moments; every (logp, grad) is
      one launch of the gradient pass ``target_logp_grad`` (SMMALA one a
      transition, RMHMC one a leap), counted and printed a transition.

    Returns {path: seconds}."""
    import mcmc_jl_tpu_torch as mt

    seconds = {}
    X, Y = manifold_data()
    ref_m = mt.model(glm=("logistic", X, Y), device="cuda")
    ref_task = (ref_m * mt.HMC(10, MANIFOLD_HMC_EPS)
                * mt.SerialMC(steps=600, burnin=200))
    origin = _origin(ref_m, ref_task, chains)
    cs, ref, launches, dt, _ = _path(origin, ref_task, chains,
                                     {"glm_leapfrogs": lambda n: n > 0})
    ref_mean, ref_se, ref_sd = _per_chain(ref)
    ref_acc = float(np.mean([mt.acceptance(c) for c in cs])) / 100
    emit({"phase": "manifold_reference", "from": origin, "chains": chains,
          "seconds": dt, "glm_leapfrogs_launches": launches["glm_leapfrogs"],
          "accept_rate": ref_acc, "pooled_mean": ref_mean.tolist(),
          "pooled_sd": ref_sd.tolist(), **CARD})
    seconds["hmc_reference"] = dt
    del cs, ref

    fisher = _fisher_logistic(X, Y)
    runs = [(mt.SMMALA(1.0), chains, 400, 100),
            (mt.PMALA(1.0), chains, 400, 100),
            (mt.RMHMC(4, 0.5), heavy_chains, 80, 20),
            (mt.ERMLMC(4, 0.3), heavy_chains, 80, 20),
            (mt.RMLMC(4, 0.3), heavy_chains, 80, 20)]
    for sampler, n, steps, burnin in runs:
        task = fisher * sampler * mt.SerialMC(steps=steps, burnin=burnin)
        origin = (f"run(Fisher-metric logistic (D {MANIFOLD_D}, N "
                  f"{MANIFOLD_N}) * {sampler!r} * SerialMC({steps}, "
                  f"{burnin}), chains={n})")
        cs, samples, _, dt, _ = _path(origin, task, n, {})
        mean, se, sd = _per_chain(samples)
        z = float(np.max(np.abs(mean - ref_mean) / np.hypot(se, ref_se)))
        sd_err = float(np.max(np.abs(sd / ref_sd - 1.0)))
        acc = float(np.mean([mt.acceptance(c) for c in cs])) / 100
        name = type(sampler).__name__
        ok = z < Z_MAX and sd_err < 0.2 and acc > 0.05
        emit({"phase": "manifold_sampler", "sampler": name, "from": origin,
              "chains": n, "seconds": dt, "transitions_per_s": n * steps / dt,
              "accept_rate": acc, "z_max_vs_hmc": z, "sd_rel_err_max": sd_err,
              "pooled_mean": mean.tolist(), "ok": ok, **CARD})
        assert ok, f"{origin} disagrees with kernel 1's HMC"
        seconds[name] = dt
        print(f"manifold_samplers {name}: {dt:.3f} s, {n * steps / dt:.0f} "
              f"transitions/s, acceptance {acc:.3f}, |z| {z:.2f}; "
              f"{CARD['card']}", flush=True)
        del cs, samples

    gamma = mt.Gamma(3.0, 0.2)
    gm = mt.model(lambda x: mt.tilde(x, gamma), x=np.full(10, 0.6),
                  gradient=True, tensor=True, dtensor=True, device="cuda")
    assert gm.target_spec is not None
    for sampler, steps, burnin in ((mt.SMMALA(GAMMA_SMMALA_EPS), 400, 150),
                                   (mt.RMHMC(4, GAMMA_RMHMC_EPS), 30, 10)):
        task = gm * sampler * mt.SerialMC(steps=steps, burnin=burnin)
        origin = (f"run(model(x ~ {gamma!r}, x=fill(0.6, 10)) * {sampler!r}"
                  f" * SerialMC({steps}, {burnin}), chains={gamma_chains})")
        cs, samples, launches, dt, _ = _path(
            origin, task, gamma_chains, {"target_logp_grad": lambda k: k > 0})
        z_ex = _moments_z((samples.mean(1), (samples ** 2).mean(1)), gamma)
        grads = launches["target_logp_grad"]
        acc = float(np.mean([mt.acceptance(c) for c in cs])) / 100
        name = "gamma_" + type(sampler).__name__
        ok = z_ex < Z_MAX
        emit({"phase": "manifold_sampler", "sampler": name, "from": origin,
              "chains": gamma_chains, "seconds": dt,
              "transitions_per_s": gamma_chains * steps / dt,
              "accept_rate": acc, "grad_pass_launches": grads,
              "grad_pass_per_transition": grads / steps,
              "pooled_mean": float(samples.mean()),
              "exact_mean": float(gamma.mean()),
              "pooled_sd": float(samples.std()),
              "exact_sd": float(gamma.std()), "z_max_vs_exact": z_ex,
              "ok": ok, **CARD})
        assert ok, f"{origin} disagrees with the exact moments"
        seconds[name] = dt
        print(f"manifold_samplers {name}: {dt:.3f} s, "
              f"{gamma_chains * steps / dt:.0f} transitions/s, acceptance "
              f"{acc:.3f}, |z| {z_ex:.2f}, {grads} gradient-pass launches "
              f"({grads / steps:.3f} a transition); {CARD['card']}",
              flush=True)
    return seconds


#: examples/model_comparison.py's prior-tempered PTMC ladder (ten rungs
#: (k/9)^5): its (steps, burnin) of (6000, 1000) cut to (400, 100) for the
#: script's time: a step takes twelve vmapped gradients of the callable
#: model, 20-31 ms on one H100 80GB HBM3 at 700 W (a gradient 1.45-2.6 ms
#: a call from one host to another); CPU runs at (400, 100), seeds 0-3,
#: came within 0.12 (TI) and 0.08 (SS) of the exact logZ
EVIDENCE_PTMC = (400, 100)


def population_model():
    """benchmarks/benchunits/population.py's callable logistic model (d 10,
    N 1000, its ``logprior`` N(0, I)), float32 on the card, with that
    ``logprior``.  Its data are ``bench_data()``'s: the unit draws them
    with the same generator, seed and order."""
    import torch

    import mcmc_jl_tpu_torch as mt

    X, Y = bench_data()
    Xt, Yt = _cuda(X), _cuda(Y)
    d = X.shape[1]
    l2pi = float(np.log(2 * np.pi))

    def logprior(th):
        return -0.5 * (th * th).sum() - d / 2 * l2pi

    def logp(th):
        z = Xt @ th
        return ((Yt * z).sum() - torch.logaddexp(torch.zeros_like(z), z).sum()
                + logprior(th))

    return (mt.model(logp, gradient=True, init=np.zeros(d), check_init=False,
                     device="cuda"), logprior)


def conjugate_model():
    """examples/model_comparison.py's M1: y_i ~ N(theta, 1), theta ~ N(0,
    1), n 40 draws of N(0.8, 1) (seed 7), float32 on the card; returns
    (model, logprior, its exact logZ)."""
    import mcmc_jl_tpu_torch as mt

    rng = np.random.default_rng(7)
    n = 40
    y = rng.standard_normal(n) + 0.8
    yd = _cuda(y)
    l2pi = float(np.log(2 * np.pi))

    def logprior(th):
        return -0.5 * th[0] ** 2 - 0.5 * l2pi

    def logp(th):
        return -0.5 * ((yd - th[0]) ** 2).sum() - n / 2 * l2pi + logprior(th)

    sy, yy = y.sum(), (y * y).sum()
    exact = -n / 2 * l2pi - 0.5 * np.log(1.0 + n) \
        - 0.5 * (yy - sy ** 2 / (1.0 + n))
    return (mt.model(logp, gradient=True, init=np.zeros(1), device="cuda"),
            logprior, float(exact))


def _pooled_z(mean, se, ref_mean, ref_se):
    return float(np.max(np.abs(mean - ref_mean) / np.hypot(se, ref_se)))


def phase_ensemble_runners(hmc_means, chains=4096):
    """The ensemble runners (PTMC, ASMC, AIES, SeqMC, SerialTempMC) and
    ``run_until`` through the port's entry points, float32 on the card,
    each with every count zeroed just before it and read just after:

    1. ``run_until(model(glm=logistic, N 1000), NUTS(6), n_chains=chains,
       check_every=100, warmup=100, rhat_target=1.01, min_ess=400,
       max_steps=600)``: the blocks after the warmup run through
       ``make_fused_continuation``, kernel 9 (or 8); it must converge and
       its retained per-chain means lie within Z_MAX standard errors of
       ``hmc_means`` (``_hmc_reference``, kernel 1's HMC);
    2. the same with ``HMC(10, 0.02, EmpMCTuner(0.8, 50),
       mass_adapt="diag")``, ``check_every=100, warmup=100,
       max_steps=600``: the frozen blocks through kernel 3b;
    3. population.py's ``HMC(5, 0.1) * PTMC(steps=400, swap_period=5,
       betas=((k+1)/8)^2, walkers=32)`` (256 chains) on its callable
       model: the 32 cold rungs, pooled past their first 100 steps,
       against ``hmc_means`` (population.py's data are bench.py's), and
       swaps happen;
    4. its ``ASMC(particles=2048, moves=2, target_ess=0.5)`` with ``HMC(5,
       0.1)``: beta reaches 1, the particle means against ``hmc_means``
       (standard error from target_ess * particles);
    5. model_comparison.py's conjugate model: ``ASMC(particles=4096)``
       with ``HMC(5, 0.3)``, |logZ - exact| < 0.25; the prior-tempered
       ``PTMC`` of ten rungs (k/9)^5, EVIDENCE_PTMC, |TI - exact| < 0.35
       and |SS - exact| < 0.25 (tests/test_evidence.py's tolerances);
    6. ``AIES(steps=1000, burnin=500, walkers=64)`` on population.py's
       model against ``hmc_means`` (standard error from the pooled ESS);
       tests/test_runners.py's SeqMC README example 2 and SerialTempMC
       ladder on their gates; ``HMC(5, 0.05) * PTMC(steps=200, burnin=50,
       betas=(0.25, 0.5, 1.0), walkers=64)`` on ``x ~ Gamma(3, 0.2)``, d
       10, a float32 catalog model: every gradient one launch of the
       gradient pass ``target_logp_grad`` (1 + 5 a step), the cold rungs
       against the exact moments.

    Prints one line for the phase (launches of kernels 9 and 8, 3b and
    the gradient pass over its runs, each run's seconds, each gate);
    returns {run: seconds}."""
    import torch

    import mcmc_jl_tpu_torch as mt

    seconds, gates, counts = {}, {}, {}
    ref_mean = hmc_means.mean(0)
    ref_se = hmc_means.std(0, ddof=1) / np.sqrt(len(hmc_means))

    def timed(name, fn):
        t0 = time.perf_counter()
        out, launches = _counted(fn)
        seconds[name] = time.perf_counter() - t0
        for k, v in launches.items():
            counts[k] = counts.get(k, 0) + v
        return out, launches

    def chain_means(x):  # (kept, chains, d) -> pooled mean, se
        m = x.astype(np.float64).mean(0)
        return m.mean(0), m.std(0, ddof=1) / np.sqrt(len(m))

    X, Y = bench_data()
    glm = mt.model(glm=("logistic", X, Y), device="cuda")
    until = {"run_until_nuts": (mt.NUTS(maxdoublings=6), 100, 100, 600,
                                ("glm_nuts_multistep",
                                 "glm_nuts_transition")),
             "run_until_hmc": (mt.HMC(10, 0.02, mt.EmpMCTuner(0.8, 50),
                                      mass_adapt="diag"), 100, 100, 600,
                               ("glm_multistep_rows",))}
    for name, (sampler, every, warmup, most, kernels) in until.items():
        res, launches = timed(name, lambda: mt.run_until(
            glm, sampler, n_chains=chains, check_every=every, warmup=warmup,
            rhat_target=1.01, min_ess=400, max_steps=most, seed=0))
        fused = sum(launches[k] for k in kernels)
        z = _pooled_z(*chain_means(res.samples), ref_mean, ref_se)
        gates[name] = {"z": z, "converged": res.converged,
                       "steps_run": res.steps_run,
                       "max_rhat": res.max_rhat, "min_ess": res.min_ess,
                       "fused_launches": fused}
        assert fused > 0, (name, launches)
        assert res.converged and z < Z_MAX, (name, gates[name])

    pm, logprior = population_model()
    K = 8
    betas = tuple(float(((k + 1) / K) ** 2) for k in range(K))
    cs, _ = timed("ptmc_population", lambda: mt.run(
        pm * mt.HMC(5, 0.1) * mt.PTMC(steps=400, swap_period=5, betas=betas,
                                      walkers=32), seed=0))
    x = np.stack([c.samples.values[100:] for c in cs], axis=1)
    nswaps = float(sum(c.diagnostics["nswaps"].sum() for c in cs))
    z = _pooled_z(*chain_means(x), ref_mean, ref_se)
    gates["ptmc_population"] = {"z": z, "nswaps": nswaps}
    assert np.all(np.isfinite(x)) and nswaps > 0 and z < Z_MAX, gates

    N = 2048
    prior_sample = lambda g, n: torch.randn((n, 10), generator=g,  # noqa: E731
                                            device="cuda")
    c, _ = timed("asmc_population", lambda: mt.run(
        pm * mt.HMC(5, 0.1) * mt.ASMC(particles=N, moves=2, target_ess=0.5,
                                      logprior=logprior,
                                      prior_sample=prior_sample), seed=0))
    p = c.samples.values.astype(np.float64)
    z = _pooled_z(p.mean(0), p.std(0) / np.sqrt(0.5 * N), ref_mean, ref_se)
    gates["asmc_population"] = {"z": z,
                                "n_stages": c.diagnostics["n_stages"],
                                "logz": c.diagnostics["logz"]}
    assert z < Z_MAX, gates

    cm, cprior, exact = conjugate_model()
    c, _ = timed("asmc_evidence", lambda: mt.run(
        cm * mt.HMC(5, 0.3) * mt.ASMC(
            particles=4096, moves=2, logprior=cprior,
            prior_sample=lambda g, n: torch.randn((n, 1), generator=g,
                                                  device="cuda")), seed=1))
    steps, burnin = EVIDENCE_PTMC
    ladder = tuple(float((k / 9) ** 5) for k in range(10))
    pc, _ = timed("ptmc_evidence", lambda: mt.run(
        cm * mt.HMC(5, 0.3) * mt.PTMC(steps=steps, burnin=burnin,
                                      betas=ladder, logprior=cprior),
        seed=0))
    ti, ss = mt.logz_ti(pc, burnin=burnin), mt.logz_ss(pc, burnin=burnin)
    gates["evidence"] = {"exact": exact, "asmc": c.diagnostics["logz"],
                         "ti": ti, "ss": ss,
                         "asmc_stages": c.diagnostics["n_stages"]}
    assert (abs(c.diagnostics["logz"] - exact) < 0.25
            and abs(ti - exact) < 0.35 and abs(ss - exact) < 0.25), gates

    cs, _ = timed("aies_population", lambda: mt.run(
        pm * mt.AIES(steps=1000, burnin=500, walkers=64), seed=0))
    x = np.stack([c.samples.values for c in cs], axis=1)  # (500, 64, 10)
    ess = mt.ess_pooled(x)
    flat = x.reshape(-1, x.shape[-1]).astype(np.float64)
    z = _pooled_z(flat.mean(0), flat.std(0) / np.sqrt(ess), ref_mean, ref_se)
    acc = float(np.mean([np.mean(c.diagnostics["accept"]) for c in cs]))
    gates["aies_population"] = {"z": z, "min_ess": float(ess.min()),
                                "accept": acc}
    assert z < Z_MAX and 0.05 < acc < 0.9, gates

    def abs_normal(st, x0):
        def ex(x, _st=st):
            mt.tilde(torch.abs(x), mt.Normal(1.0, _st))
        return mt.model(ex, x=x0, device="cuda")

    sts = np.logspace(1, -1, 6)
    particles = np.random.default_rng(0).standard_normal((300, 1))
    c, _ = timed("seqmc", lambda: mt.run(
        [abs_normal(st, 0.0) * mt.RWM(float(st)) * mt.SeqMC(steps=10)
         for st in sts], particles=particles))
    w = c.diagnostics["weigths"].astype(np.float64)
    est = float(np.abs(np.sum(w / w.sum() * np.abs(c.samples["x"]))))
    gates["seqmc"] = {"weighted_abs_x": est}
    assert c.samples.shape == (3000, 1) and 0.5 < est < 1.5, gates

    sts = np.logspace(0.5, -0.5, 4)
    c, _ = timed("serialtempmc", lambda: mt.run(
        [abs_normal(st, 0.5) * mt.RWM(float(st))
         * mt.SerialTempMC(steps=2000, burnin=200, swap_period=5)
         for st in sts]))
    rungs = c.diagnostics["mod"]
    gates["serialtempmc"] = {"rungs_visited": int(len(np.unique(rungs)))}
    assert (c.samples.shape == (1800, 1) and np.all(np.isfinite(
        c.samples.values)) and len(np.unique(rungs)) > 1), gates

    gamma = mt.Gamma(3.0, 0.2)
    gm = mt.model(lambda x: mt.tilde(x, gamma), x=np.full(10, 0.6),
                  gradient=True, device="cuda")
    assert gm.target_spec is not None
    cs, launches = timed("ptmc_catalog", lambda: mt.run(
        gm * mt.HMC(5, 0.05) * mt.PTMC(steps=200, burnin=50,
                                       betas=(0.25, 0.5, 1.0), walkers=64),
        seed=0))
    x = np.stack([c.samples.values for c in cs])  # (64, 150, 10)
    z = _moments_z((x.mean(1), (x ** 2).mean(1)), gamma)
    gates["ptmc_catalog"] = {"z": z,
                             "grad_pass": launches["target_logp_grad"]}
    assert launches["target_logp_grad"] == 1 + 5 * 200, launches
    assert z < Z_MAX, gates

    kept = ("glm_nuts_multistep", "glm_nuts_transition",
            "glm_multistep_rows", "target_logp_grad")
    emit({"phase": "ensemble_runners",
          "launches": {k: counts.get(k, 0) for k in kept},
          "seconds": seconds, "total_s": sum(seconds.values()),
          "gates": gates, **CARD})
    print(f"ensemble_runners: {sum(seconds.values()):.2f} s; " + ", ".join(
        f"{k} {v:.2f} s" for k, v in seconds.items()) + f"; {CARD['card']}",
        flush=True)
    return seconds


MESH_SHARDS = 4  # virtual shards: entries that repeat cuda:0


def _mesh_counted(fn):
    """``_counted`` with the port's reduction counter zeroed too; returns
    (result, kernel launches, psums {(axis, shape, dtype): count})."""
    from mcmc_jl_tpu_torch.parallel import collectives

    collectives.reset_counts()
    out, launches = _counted(fn)
    return out, launches, dict(collectives.PSUMS)


def _direct_lp(X, Y, theta):
    """The logistic posterior's float64 log-density (N(0, I) prior) at the
    rows of ``theta``, in numpy."""
    z = X @ theta.T
    return (z * Y[:, None] - np.logaddexp(0.0, z)).sum(0) \
        - 0.5 * (theta * theta).sum(1)


def phase_mesh_paths(hmc_means, chains=4096):
    """The distributed drivers on meshes whose entries repeat ``cuda:0``
    (virtual shards: one card, shards in turn on it), each through its
    entry point with every count zeroed just before it and read just after:

    1. kernel 1: ``run_glm_hmc_sharded`` on the main path's logistic 10 x
       1000, 4096 chains over 4 shards, HMC(10, 0.05), 100 steps: each
       shard's rows bitwise ``run_glm_hmc`` on 1024 chains with that
       shard's stream (``shard_seed(seed, i)``), no reduction;
    2. kernel 5: ``run_target_hmc_sharded`` on ``x ~ Gamma(3, 0.2)``, d 10,
       the same layout and bitwise rule;
    3. kernel 4: ``run_glm_hmc_bign_sharded`` at N 1e5 from the posterior
       mode, 512 chains on a (2, 2) ``(chains, data)`` mesh, HMC(10,
       0.005), 10 steps, against the (1, 1) run: on the chains whose accept
       decisions agree (at most 2% may not: see the comment below), theta
       within rtol 2e-4, atol 2e-5 and the log-targets within 2e-4; every
       chain's last log-target within 1e-4 of a float64 direct evaluation;
       4 x (1 + steps n_leaps) launches and 2 x (1 + steps n_leaps)
       data-axis psums, each float32 (256, 11);
    4. ``run(..., chains=4096, mesh=make_mesh(4, 1))`` with adaptive HMC
       diag (SerialMC(400, 100), kernel 3b a shard) and NUTS(6)
       (SerialMC(110, 20), kernel 9 a shard) from the posterior mode,
       their per-chain means within Z_MAX of ``hmc_means`` (the generic
       warmups run each shard in turn on the one card, four times the host
       work of one batch: short burn-ins); then ``resume(chains,
       steps=101, mesh=)`` of the NUTS run, kernel 8 a shard; then NUTS(4)
       on ``x ~ Gamma(3, 0.2)``, d 10 (SerialMC(70, 30), target-mode NUTS
       8b a shard; depth 4 as its generic warmup's trees reach depth 6 at
       its small adapted steps, four times the gradient passes), its
       per-chain first and second moments within Z_MAX of the exact ones;
    5. ``HMC(5, 0.05) * PTMC(steps=200, burnin=50, betas=(0.25, 0.5, 1),
       walkers=8)`` on the Gamma model (2 ladders a shard, the gradient
       pass), ``ASMC(particles=4096)`` with ``HMC(5, 0.3)`` on
       model_comparison.py's conjugate model (|logZ - exact| < 0.25) and
       ``run_until`` with ``HMC(10, 0.05, EmpMCTuner(0.8, 25),
       mass_adapt="diag")``, ``check_every=50, warmup=50,
       rhat_target=1.05, max_steps=600`` (kernel 3b a shard in its frozen
       blocks; R-hat 1.01 takes about 450 steps from the mode, eight
       gates of host statistics at 4096 chains), all with
       ``mesh=``.

    No plain version runs.  Prints one line a path (its launches and
    psums) and one for the phase; returns the launches of each kernel on
    the mesh paths."""
    import torch

    import mcmc_jl_tpu_torch as mt
    from mcmc_jl_tpu_torch.ops.glm_bign import run_glm_hmc_bign_sharded
    from mcmc_jl_tpu_torch.ops.glm_hmc import run_glm_hmc, run_glm_hmc_sharded
    from mcmc_jl_tpu_torch.ops.target_kernels import (
        coordwise_logp, run_target_hmc, run_target_hmc_sharded)
    from mcmc_jl_tpu_torch.parallel.mesh import Mesh, shard_seed
    from mcmc_jl_tpu_torch.parallel.sharded import make_mesh
    from mcmc_jl_tpu_torch.samplers.base import make_generator

    n = MESH_SHARDS
    mesh = Mesh(["cuda:0"] * n, ("chains",))
    seconds, gates, mesh_launches = {}, {}, {}

    def path(name, fn, want_kernels):
        t0 = time.perf_counter()
        out, launches, psums = _mesh_counted(fn)
        seconds[name] = time.perf_counter() - t0
        fired = {k: v for k, v in launches.items() if v}
        for k, v in fired.items():
            mesh_launches[k] = mesh_launches.get(k, 0) + v
        emit({"phase": "mesh_path", "path": name, "seconds": seconds[name],
              "launches": fired,
              "psums": {f"{a} {list(sh)} {dt}": c
                        for (a, sh, dt), c in psums.items()}, **CARD})
        for k in want_kernels:
            assert launches.get(k, 0) > 0, (name, k, launches)
        return out, launches, psums

    X, Y = bench_data()
    steps, C = 100, chains
    inits = torch.zeros((C, X.shape[1]), device="cuda")
    (th, inf), launches, psums = path("kernel1_sharded", lambda:
                                      run_glm_hmc_sharded(
                                          X, Y, C, steps, mesh=mesh,
                                          n_leaps=10, eps=0.05, seed=11,
                                          inits=inits), ("glm_leapfrogs",))
    assert launches["glm_leapfrogs"] == n * steps and not psums, launches
    per = C // n
    for i in range(n):
        th_i, inf_i = run_glm_hmc(
            X, Y, per, steps, n_leaps=10, eps=0.05, inits=inits[:per],
            generator=make_generator("cuda", shard_seed(11, i)),
            device="cuda")
        assert torch.equal(th_i, th[i * per:(i + 1) * per]), i
        assert torch.equal(inf_i["plogtarget"],
                           inf["plogtarget"][:, i * per:(i + 1) * per]), i
    gates["kernel1_bitwise_shards"] = n

    gamma = mt.Gamma(3.0, 0.2)
    target = coordwise_logp(gamma, 10)
    t_inits = torch.full((C, 10), 0.6, device="cuda")
    (th, inf), launches, psums = path("kernel5_sharded", lambda:
                                      run_target_hmc_sharded(
                                          target, 10, C, steps, mesh=mesh,
                                          n_leaps=10, eps=0.05, seed=12,
                                          inits=t_inits),
                                      ("target_leapfrogs",))
    assert launches["target_leapfrogs"] == n * steps and not psums, launches
    for i in range(n):
        th_i, _ = run_target_hmc(
            target, 10, per, steps, n_leaps=10, eps=0.05,
            inits=t_inits[:per], device="cuda",
            generator=make_generator("cuda", shard_seed(12, i)))
        assert torch.equal(th_i, th[i * per:(i + 1) * per]), i
    gates["kernel5_bitwise_shards"] = n

    Xb, Yb, mode = _bench_mode(100_000)
    bsteps, bleaps, bC = 10, 10, 512
    b_inits = torch.tensor(mode, dtype=torch.float32,
                           device="cuda").expand(bC, -1).contiguous()
    kw = dict(n_chains=bC, steps=bsteps, n_leaps=bleaps, eps=0.005, seed=13,
              inits=b_inits)
    mesh22 = make_mesh(2, 2, devices=["cuda:0"] * 4)
    (th_s, inf_s), launches, psums = path(
        "kernel4_data_axis", lambda: run_glm_hmc_bign_sharded(
            Xb, Yb, mesh=mesh22, **kw), ("glm_logp_grad_tiled",))
    evals = 1 + bsteps * bleaps
    assert launches["glm_logp_grad_tiled"] == 4 * evals, launches
    assert psums == {("data", (bC // 2, 11), "float32"): 2 * evals}, psums
    th_1, inf_1 = run_glm_hmc_bign_sharded(
        Xb, Yb, mesh=make_mesh(1, 1, devices=["cuda:0"]), **kw)
    # a chain whose accept decisions differ between the two runs has left
    # the other's path: at N 1e5 the float32 log-targets (about -4e4, an
    # ulp 0.004) of the two reduction orders differ by a few ulps, and a
    # ratio that close to its log-uniform decides the other way (about 0.4%
    # of the decisions); the others are held at the stated tolerances
    same = (inf_s["accept"] == inf_1["accept"]).all(0).cpu()
    lp_s = inf_s["plogtarget"].double().cpu().numpy()[:, same]
    lp_1 = inf_1["plogtarget"].double().cpu().numpy()[:, same]
    th_err = float((th_s - th_1).abs()[same.to(th_s.device)].max())
    lp_rel = float(np.max(np.abs(lp_s - lp_1) / np.abs(lp_1)))
    direct = _direct_lp(Xb, Yb, th_s.double().cpu().numpy())
    lp_last = inf_s["plogtarget"][-1].double().cpu().numpy()
    lp_direct = float(np.max(np.abs(lp_last - direct) / np.abs(direct)))
    flipped = int((~same).sum())
    gates["kernel4_vs_1x1"] = {"theta_max_abs": th_err, "lp_max_rel": lp_rel,
                               "last_lp_vs_f64_rel": lp_direct,
                               "chains_with_a_flipped_decision": flipped}
    assert _close(th_s[same.to(th_s.device)], th_1[same.to(th_1.device)],
                  2e-4, 2e-5), gates["kernel4_vs_1x1"]
    assert lp_rel < 2e-4 and lp_direct < 1e-4, gates["kernel4_vs_1x1"]
    assert flipped <= 0.02 * bC, gates["kernel4_vs_1x1"]

    Xm, Ym, mode_m = _bench_mode(1000)
    m = mt.model(glm=("logistic", Xm, Ym), init=mode_m, device="cuda")
    mesh41 = make_mesh(n, 1, devices=["cuda:0"] * n)
    runs = {"warm_hmc_diag": (mt.HMC(10, 0.02, mt.EmpMCTuner(0.8, 50),
                                     mass_adapt="diag"), 400, 100,
                              "glm_multistep_rows"),
            "nuts_kernel9": (mt.NUTS(maxdoublings=6), 110, 20,
                             "glm_nuts_multistep")}
    for name, (sampler, st, burn, kernel) in runs.items():
        task = m * sampler * mt.SerialMC(steps=st, burnin=burn)
        cs, launches, psums = path(name, lambda: mt.run(
            task, chains=chains, seed=0, mesh=mesh41), (kernel,))
        samples = np.stack([c.samples.values for c in cs])
        assert samples.shape == (chains, st - burn, m.size)
        z = _z_means(samples.mean(1), hmc_means)
        gates[name] = {"z": z, "launches": launches[kernel]}
        assert np.all(np.isfinite(samples)) and z < Z_MAX, (name, z)
    # the NUTS chains resumed on the mesh for a prime count of transitions:
    # the fused continuation's per-transition kernel 8, a shard an entry
    more, launches, _ = path("resume_kernel8", lambda: mt.resume(
        cs, steps=101, mesh=mesh41), ("glm_nuts_transition",))
    samples = np.stack([c.samples.values for c in more])
    z = _z_means(samples.mean(1), hmc_means)
    gates["resume_kernel8"] = {"z": z,
                               "launches": launches["glm_nuts_transition"]}
    assert launches["glm_nuts_transition"] == n * 101 and z < Z_MAX, gates

    gm = mt.model(lambda x: mt.tilde(x, gamma), x=np.full(10, 0.6),
                  gradient=True, device="cuda")
    # the warm pipeline on a catalog target: the sampling phase's
    # target-mode NUTS transition (8b), one launch a transition a shard
    tst, tburn = 70, 30
    cs, launches, _ = path("target_nuts_kernel8b", lambda: mt.run(
        gm * mt.NUTS(maxdoublings=4) * mt.SerialMC(steps=tst, burnin=tburn),
        chains=chains, seed=0, mesh=mesh41), ("target_nuts_transition",))
    x = np.stack([c.samples.values for c in cs])
    assert x.shape == (chains, tst - tburn, 10) and np.all(np.isfinite(x))
    z = _moments_z((x.mean(1), (x ** 2).mean(1)), gamma)
    gates["target_nuts_kernel8b"] = {
        "z": z, "launches": launches["target_nuts_transition"]}
    assert launches["target_nuts_transition"] == n * (tst - tburn) \
        and z < Z_MAX, gates["target_nuts_kernel8b"]
    cs, launches, _ = path("ptmc_mesh", lambda: mt.run(
        gm * mt.HMC(5, 0.05) * mt.PTMC(steps=200, burnin=50,
                                       betas=(0.25, 0.5, 1.0), walkers=8),
        seed=0, mesh=mesh), ("target_logp_grad",))
    x = np.stack([c.samples.values for c in cs])
    z = _moments_z((x.mean(1), (x ** 2).mean(1)), gamma)
    gates["ptmc_mesh"] = {"z": z, "grad_pass": launches["target_logp_grad"],
                          "nswaps": float(sum(c.diagnostics["nswaps"].sum()
                                              for c in cs))}
    assert z < Z_MAX and gates["ptmc_mesh"]["nswaps"] > 0, gates["ptmc_mesh"]

    cm, cprior, exact = conjugate_model()
    c, _, psums = path("asmc_mesh", lambda: mt.run(
        cm * mt.HMC(5, 0.3) * mt.ASMC(
            particles=4096, moves=2, logprior=cprior,
            prior_sample=lambda g, k: torch.randn((k, 1), generator=g,
                                                  device="cuda")),
        seed=1, mesh=mesh), ())
    gates["asmc_mesh"] = {"logz": c.diagnostics["logz"], "exact": exact,
                          "n_stages": c.diagnostics["n_stages"],
                          "psums": sum(psums.values())}
    assert abs(c.diagnostics["logz"] - exact) < 0.25, gates["asmc_mesh"]
    assert sum(psums.values()) > 0, psums

    res, launches, _ = path("run_until_mesh", lambda: mt.run_until(
        m, mt.HMC(10, 0.05, mt.EmpMCTuner(0.8, 25), mass_adapt="diag"),
        n_chains=chains, check_every=50, warmup=50, rhat_target=1.05,
        min_ess=400, max_steps=600, seed=0, mesh=mesh41),
        ("glm_multistep_rows",))
    z = _z_means(res.samples.astype(np.float64).mean(0), hmc_means)
    gates["run_until_mesh"] = {"z": z, "converged": res.converged,
                               "steps_run": res.steps_run,
                               "max_rhat": res.max_rhat}
    assert res.converged and z < Z_MAX, gates["run_until_mesh"]

    emit({"phase": "mesh_paths", "shards": n, "launches": mesh_launches,
          "seconds": seconds, "total_s": sum(seconds.values()),
          "gates": gates, **CARD})
    print(f"mesh_paths: {sum(seconds.values()):.2f} s; " + ", ".join(
        f"{k} {v:.2f} s" for k, v in seconds.items()) + f"; {CARD['card']}",
        flush=True)
    return mesh_launches


def phase_warm_handoff(hmc_means, chains=4096, chains_bign=512):
    """The NUTS warm handoff, ``NUTS(6, warm_handoff=True)``: the exact-NUTS
    warmup on the generic engine, then dynamic-length HMC at the frozen
    step and the warmup's own trajectory time through run(...,
    chains=N), each run with every count zeroed just before it and read
    just after, no plain call:

    1. on the main path's logistic 10 x 1000 with the exact-NUTS main
       path's runner, SerialMC(580, 80), 4096 chains: kernel 3b, 100
       launches of 5; per-chain means within Z_MAX of ``hmc_means``;
       ``epsilon`` one value over the sampling rows, ``nleaps`` varying;
    2. ``resume(chains, steps=120)`` twice: 15 launches of 8 of kernel 3b
       each, ``tlen`` kept;
    3. on ``x ~ Gamma(3, 0.2)``, d 10, SerialMC(250, 50), 4096 chains:
       kernel 5, one launch a sampling transition; the per-chain first and
       second moments within Z_MAX of the exact ones;
    4. kernel 4: logistic 10 x 2000 with ``glm_bign.BIGN_THRESHOLD``
       lowered to 1000 for the call, from the posterior mode,
       SerialMC(120, 40), 512 chains: 1 + sum(nleaps) launches; per-chain
       means within Z_MAX of kernel 1's HMC on the same data.
    After each arm, one launch of its kernel at the arm's shape from its
    final positions (3b: 5 transitions at the frozen (eps, T) from the
    first sampling index; 5: the mean leap count at the frozen eps; 4: one
    gradient), timed beside its plain version and its bound
    (:func:`_handoff_kernel_time`).
    Returns {kernel: (launches, origin)} of the three handoff paths."""
    import torch

    import mcmc_jl_tpu_torch as mt
    from mcmc_jl_tpu_torch.ops import glm_bign
    from mcmc_jl_tpu_torch.samplers.base import tree_map

    counts, gates, seconds = {}, {}, {}
    s = mt.NUTS(maxdoublings=6, warm_handoff=True)

    # 1. the GLM arm on kernel 3b
    X, Y = bench_data()
    m = mt.model(glm=("logistic", X, Y), device="cuda")
    task = m * s * mt.SerialMC(steps=580, burnin=80)
    origin = _origin(m, task, chains)
    cs, samples, launches, dt, _ = _path(origin, task, chains,
                                         {"glm_multistep_rows": 100})
    seconds["glm"] = dt
    counts["glm_multistep_rows"] = (launches["glm_multistep_rows"], origin)
    eps = np.stack([c.diagnostics["epsilon"] for c in cs[:64]])
    nl = np.stack([c.diagnostics["nleaps"] for c in cs[:64]])
    st = cs[0].task.state
    z = _z_means(samples.mean(1), hmc_means)
    gates["glm"] = {"z_max_vs_hmc_reference": z,
                    "frozen_eps": float(st.epsilon),
                    "tlen": float(st.tlen),
                    "mean_nleaps": float(nl.mean()),
                    "accept_rate": float(np.mean(
                        [mt.acceptance(c) for c in cs[:256]])) / 100}
    assert z < Z_MAX, (origin, gates["glm"])
    assert np.ptp(eps) == 0 and np.ptp(nl) > 0, "handoff rows"
    assert float(st.tlen) > 0
    pars = lambda cs: torch.stack(  # noqa: E731
        [c.task.state.pars for c in cs]).contiguous()
    times = {"glm_multistep_rows": _handoff_kernel_time(
        "glm_multistep_rows", X, Y, pars(cs), float(st.epsilon),
        float(st.tlen), i0=81)}

    # 2. two resumes, kernel 3b with tlen kept
    for i in (1, 2):
        t0 = time.perf_counter()
        cs, launches = _counted(lambda c=cs: mt.resume(c, steps=120))
        seconds[f"resume{i}"] = time.perf_counter() - t0
        assert launches == {**{k: 0 for k in launches},
                            "glm_multistep_rows": 15}, launches
        tl = tree_map(lambda *xs: torch.stack(xs),
                      *[c.task.state for c in cs[:64]]).tlen
        assert torch.all(tl == float(st.tlen)), "tlen not kept"
        rs = np.stack([c.samples.values for c in cs])
        assert rs.shape == (chains, 120, m.size) and np.all(np.isfinite(rs))
        gates[f"resume{i}"] = {"z_max_vs_hmc_reference":
                               _z_means(rs.mean(1), hmc_means)}
        assert gates[f"resume{i}"]["z_max_vs_hmc_reference"] < Z_MAX
    del cs, samples

    # 3. the catalog arm on kernel 5
    gamma = mt.Gamma(3.0, 0.2)
    mg = mt.model(lambda x: mt.tilde(x, gamma), x=np.full(10, 1.1),
                  gradient=True, device="cuda")
    task = mg * s * mt.SerialMC(steps=250, burnin=50)
    origin = (f"run(model(x ~ Gamma(3,0.2), x=fill(1.1, 10)) * {s!r} * "
              f"SerialMC(250, 50), chains={chains})")
    cs, samples, launches, dt, _ = _path(
        origin, task, chains, {"target_leapfrogs": 200,
                               "target_logp_grad": lambda n: n > 0})
    seconds["target"] = dt
    counts["target_leapfrogs"] = (launches["target_leapfrogs"], origin)
    z = _moments_z((samples.mean(1), (samples ** 2).mean(1)), gamma)
    st = cs[0].task.state
    gates["target"] = {"z_max_vs_exact": z,
                       "pooled_mean": float(samples.mean()),
                       "exact_mean": float(gamma.mean()),
                       "tlen": float(st.tlen)}
    assert z < Z_MAX, (origin, gates["target"])
    n_leaps = int(round(float(cs[0].diagnostics["nleaps"].mean())))
    times["target_leapfrogs"] = _traj_time(
        "Gamma(3, 0.2), the handoff's frozen step", mg.target_spec,
        pars(cs), float(st.epsilon), n_leaps, seed=91, plain=True)
    del cs, samples

    # 4. kernel 4, BIGN_THRESHOLD lowered for the call
    X2, Y2, mode = _bench_mode(2000)
    m2 = mt.model(glm=("logistic", X2, Y2), init=mode, device="cuda")
    task = m2 * s * mt.SerialMC(steps=120, burnin=40)
    saved = glm_bign.BIGN_THRESHOLD
    glm_bign.BIGN_THRESHOLD = 1000
    try:
        origin = _origin(m2, task, chains_bign) + " (BIGN_THRESHOLD 1000)"
        cs, samples, launches, dt, _ = _path(
            origin, task, chains_bign,
            {"glm_logp_grad_tiled": lambda n: n > 80})
    finally:
        glm_bign.BIGN_THRESHOLD = saved
    seconds["bign"] = dt
    nl = cs[0].diagnostics["nleaps"]
    assert launches["glm_logp_grad_tiled"] == 1 + int(nl.sum()), launches
    counts["glm_logp_grad_tiled"] = (launches["glm_logp_grad_tiled"], origin)
    ref = _hmc_reference(np.tile(mode, (chains_bign, 1)).astype(np.float32),
                         600, data=(X2, Y2), eps=0.035, seed=5)
    z = _z_means(samples.mean(1), ref)
    gates["bign"] = {"z_max_vs_kernel1_hmc": z,
                     "tlen": float(cs[0].task.state.tlen)}
    assert z < Z_MAX, (origin, gates["bign"])
    times["glm_logp_grad_tiled"] = _handoff_kernel_time(
        "glm_logp_grad_tiled", X2, Y2, pars(cs))

    emit({"phase": "warm_handoff", "launches": {
        k: v[0] for k, v in counts.items()},
        "from": {k: v[1] for k, v in counts.items()},
        "seconds": seconds, "total_s": sum(seconds.values()),
        "gates": gates, "kernel_times": times, **CARD})
    return counts


def _handoff_kernel_time(name, X, Y, theta, eps=None, T=None, i0=None,
                         k_trans=5, max_leaps=64):
    """One launch of GLM kernel ``name`` at a handoff arm's shape from its
    final positions ``theta`` (C, d) on the card: "glm_multistep_rows",
    ``k_trans`` transitions at the frozen (eps, T) from absolute transition
    ``i0``, or "glm_logp_grad_tiled", one (logp, gradient).  CUDA events
    (median of 3), torch.profiler's device time, the plain version (2), the
    bound (:func:`_bound`).  Returns a dict."""
    import torch

    from mcmc_jl_tpu_torch.ops import glm_bign as gb
    from mcmc_jl_tpu_torch.ops import glm_kernels as gk

    C, d = theta.shape
    XT, Yc = _cuda(X.T), _cuda(Y)
    if name == "glm_multistep_rows":
        gens = [torch.Generator(device="cuda").manual_seed(s)
                for s in (93, 94)]
        args = (XT, Yc, theta, eps, T, i0, max_leaps)
        kern = lambda: gk.glm_multistep_rows(  # noqa: E731
            *args, k_trans=k_trans, generator=gens[0])
        plain = lambda: gk.glm_multistep_rows_ref(  # noqa: E731
            *args, k_trans=k_trans, generator=gens[1])
        symbol = ("rows_tile_kernel",)
        out = kern()
        leaps = int(out[3]["nleaps"][:, 0].sum())
        evals = C * (1 + leaps)
        shape = {"k_trans": k_trans, "eps": eps, "T": T, "i0": i0,
                 "leapfrogs": leaps}
    else:
        kern = lambda: gb.glm_logp_grad_tiled(XT, Yc, theta)  # noqa: E731
        plain = lambda: gb.glm_logp_grad_tiled_ref(  # noqa: E731
            XT, Yc, theta)
        symbol = ("reduce_kernel", "partial_tile_kernel")
        out, evals, shape = kern(), C, {}
    r = {"C": C, "N": X.shape[0], **shape, "ms": _event_ms(kern),
         "device_ms": _device_ms(kern, symbol, reps=3),
         "plain_ms": _event_ms(plain, reps=2),
         **_bound(evals, d, X.shape[0], _nbytes((XT, Yc, theta), out))}
    emit({"phase": "kernel_time", "name": name, "path": "warm handoff", **r,
          **CARD})
    return r


def _load_example(name):
    """``examples_torch/<name>.py`` of this checkout, as the module
    ``examples_torch_<name>``."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "examples_torch", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"examples_torch_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_examples(chains=2048, cont_steps=1000):
    """``examples_torch/warmstart_logistic.py``'s ``main`` on the card at
    2048 chains (its host ESS report is a Geyer call a chain; its
    SerialMC(2000, 500): adaptive HMC with a diagonal
    metric, 250 launches of 6 of kernel 3b), held to the generating
    coefficients as tests/test_examples.py does, then ``resume(chains,
    steps=1000)`` of all of them (kernel 3b, 125 launches of 8);
    ``utils.profiling.throughput_report`` of each: leapfrog/s, steps/s and
    min-ESS/s over the 2048 chains (the run's leapfrogs at its frozen
    count; the continuation's at the mean Halton count of its transitions).
    Then one kernel-1 main-path call, ``run(HMC(10, 0.05) * SerialMC(20),
    chains=2048)``, under ``utils.profiling.trace``: the Chrome trace it
    writes must name the kernel's symbol, ``leapfrogs_tile_kernel``.
    Returns {kernel: launches} of the example's run."""
    import mcmc_jl_tpu_torch as mt
    from mcmc_jl_tpu_torch.ops import glm_kernels as gk
    from mcmc_jl_tpu_torch.utils import profiling

    ws = _load_example("warmstart_logistic")
    t0 = time.perf_counter()
    cs, launches = _counted(lambda: ws.main(chains=chains, device="cuda"))
    dt = time.perf_counter() - t0
    # 250 launches in the run, none in the one-chain resume of its main
    assert launches == {**{k: 0 for k in launches},
                        "glm_multistep_rows": 250}, launches
    X, Y, beta0 = ws.make_data(1000, 10)
    means = np.stack([c.samples.values.mean(0) for c in cs])
    pooled = means.mean(0)
    sd = np.sqrt(np.stack([mt.var(c) for c in cs[:64]]).mean(0))
    assert np.all(np.abs(pooled - beta0) < 5 * sd + 0.5), (pooled, beta0)
    st = cs[0].task.state
    nl, eps = int(st.tune.n_leaps), float(st.tune.step_size)
    rep = profiling.throughput_report(cs[0], n_chains=chains, n_leaps=nl)

    t0 = time.perf_counter()
    cont, c_launches = _counted(lambda: mt.resume(cs, steps=cont_steps))
    c_dt = time.perf_counter() - t0
    assert c_launches == {**{k: 0 for k in c_launches},
                          "glm_multistep_rows": cont_steps // 8}, c_launches
    i0 = int(st.i)
    halton = np.mean([gk.halton_leaps(i0 + t, eps, 2.0 * nl * eps, 2 * nl)
                      for t in range(cont_steps)])
    c_rep = profiling.throughput_report(cont[0], n_chains=chains,
                                        n_leaps=halton)
    cm = np.stack([c.samples.values.mean(0) for c in cont])
    z_cont = _z_means(cm, means)
    assert z_cont < Z_MAX, z_cont
    del cs, cont

    # the trace of one kernel-1 call
    X1, Y1 = bench_data()
    m = mt.model(glm=("logistic", X1, Y1), device="cuda")
    task = m * mt.HMC(10, 0.05) * mt.SerialMC(steps=20)
    logdir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "build", "trace_examples")
    with profiling.trace(logdir) as d:
        _, t_launches = _counted(lambda: mt.run(task, chains=chains))
    assert t_launches["glm_leapfrogs"] == 20, t_launches
    with open(os.path.join(d, profiling.TRACE_FILE)) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    kernel_events = sorted(n for n in names if "leapfrogs_tile_kernel" in n)
    assert kernel_events, "the trace names no leapfrogs_tile_kernel"

    keep = ("run_time_s", "steps_per_sec", "leapfrog_per_sec",
            "ess_per_sec")
    emit({"phase": "examples", "example": "warmstart_logistic",
          "chains": chains, "seconds": dt, "launches": launches[
              "glm_multistep_rows"], "frozen_step": eps,
          "frozen_n_leaps": nl,
          "run": {k: rep[k] for k in keep},
          "min_ess_run": float(np.min(rep["ess_per_param"])),
          "continuation": {"steps": cont_steps, "seconds": c_dt,
                           "launches": c_launches["glm_multistep_rows"],
                           "mean_halton_leaps": halton,
                           "z_vs_run": z_cont,
                           **{k: c_rep[k] for k in keep}},
          "min_ess_continuation": float(np.min(c_rep["ess_per_param"])),
          "trace": {"file": os.path.relpath(os.path.join(
              d, profiling.TRACE_FILE), os.path.dirname(
                  os.path.abspath(__file__))),
              "kernel_events": kernel_events,
              "launches": t_launches["glm_leapfrogs"]}, **CARD})
    print(f"examples: warmstart_logistic run {rep['leapfrog_per_sec']:.4g} "
          f"leapfrog/s, min-ESS/s {rep['ess_per_sec']:.4g}; continuation "
          f"{c_rep['leapfrog_per_sec']:.4g} leapfrog/s, min-ESS/s "
          f"{c_rep['ess_per_sec']:.4g}; {CARD['card']}", flush=True)
    return {"glm_multistep_rows": launches["glm_multistep_rows"]}


def phase_path_spans(chains=4096):
    """Host seconds (to a synchronize) of the paths that run kernels 1, 4,
    8 and 9, split into warmup, sampling and packaging, after a short
    warm-up run of each: ``run(model(glm=logistic, N 1000) * HMC(10, 0.05)
    * SerialMC(1000, 200), chains=4096)`` (the trajectory kernel), the
    large-N path ``HMC(10, 0.005) * SerialMC(200, 50)`` at N 100,000 from
    the posterior mode (the tiled kernel), and the NUTS main paths
    ``NUTS(6) * SerialMC(700, 200)`` (kernel 9) and ``NUTS(6,
    mass_adapt="diag") * SerialMC(699, 200)`` (kernel 8).  Then the
    sampling spans of bench.py's drivers at the same chains, 1000
    transitions of HMC(10, 0.05) from the model's init: the step kernel's
    ``run_glm_hmc(fused_step=True)``, the composed ``run_glm_hmc`` (kernel
    1 and the test in PyTorch) and the multistep kernel's
    ``run_glm_hmc_multistep(thin=200)``.  No checks: the main phases hold
    these paths."""
    import mcmc_jl_tpu_torch as mt
    from mcmc_jl_tpu_torch.ops.glm_hmc import run_glm_hmc, run_glm_hmc_multistep

    X, Y = bench_data()
    Xb, Yb, mode = _bench_mode(100_000)
    m = mt.model(glm=("logistic", X, Y), device="cuda")
    out = _timed_paths((
        ("main path", m, mt.HMC(10, 0.05), 1000, 200, chains),
        ("large-N path", mt.model(glm=("logistic", Xb, Yb), init=mode,
                                  device="cuda"), mt.HMC(10, 0.005), 200, 50,
         chains),
        ("NUTS path, kernel 9", m, mt.NUTS(maxdoublings=6), 700, 200, chains),
        ("NUTS diag path, kernel 8", m,
         mt.NUTS(maxdoublings=6, mass_adapt="diag"), 699, 200, chains)))
    inits = np.zeros((chains, X.shape[1]))
    drivers = {
        "run_glm_hmc(fused_step=True), kernel 2": lambda steps: run_glm_hmc(
            X, Y, chains, steps, seed=2, inits=inits, device="cuda",
            fused_step=True),
        "run_glm_hmc(fused_step=False), kernel 1": lambda steps: run_glm_hmc(
            X, Y, chains, steps, seed=2, inits=inits, device="cuda",
            fused_step=False),
        "run_glm_hmc_multistep(thin=200), kernel 3":
            lambda steps: run_glm_hmc_multistep(
                X, Y, chains, steps, thin=200, seed=3, inits=inits,
                device="cuda"),
    }
    for label, fn in drivers.items():
        out[label] = {"sampling_s": _time(lambda: fn(1000), reps=2)}
        emit({"phase": "path_spans", "path": label, "chains": chains,
              "steps": 1000, **out[label], **CARD})
    return out


def phase_sass(lib="glm_hmc", kernels=("leapfrogs_tile_kernel",
                                       "step_tile_kernel",
                                       "multistep_tile_kernel"), D=16):
    """The instruction mix of the row loops of each named kernel<D> in the
    built library (``cuobjdump -sass``): of the innermost loops (a
    backward branch and its target) that hold tensor-core products, those
    with the most, i.e. the loops of two row groups, one per link kind
    with and without the log-likelihood.  Per loop: its instructions, the
    counts of the classes that bound it (HMMA, MUFU by function, LDS,
    FFMA, DADD, shuffles) and the warp-instructions per chain and
    observation (a warp takes 16 chains of 16 rows per trip).  Emits one
    line per kernel; it is how PERF.md reads what bounds the kernels, as
    ``ncu`` does not run on the card's machine."""
    from collections import Counter

    from mcmc_jl_tpu_torch.ops import cuda_build

    path, _ = cuda_build.build(lib)
    tool = os.path.join(os.path.dirname(cuda_build.find_nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                          text=True, check=True).stdout
    funcs = re.split(r"\n\s*Function : ", sass)[1:]
    for name in kernels:
        body = next(f for f in funcs if re.match(
            rf"\S*\d+{name}ILi{D}E", f))
        # a branch names its target as a label (.L_x_n) or an address
        ops, at, branches = [], {}, []
        for ln in body.splitlines():
            lab = re.match(r"\s*(\.L_x_\d+):", ln)
            if lab:
                at[lab.group(1)] = len(ops)
                continue
            ins = re.match(r"\s*/\*([0-9a-f]+)\*/\s+(@!?U?P\w+\s+)?"
                           r"([A-Z][\w.]*)(.*?);", ln)
            if ins:
                at[int(ins.group(1), 16)] = len(ops)
                ops.append(ins.group(3))
                tgt = re.search(r"BRA[\w.]*\s+(?:.*`\((\.L_x_\d+)\)|"
                                r"(?:\S+,\s*)?(0x[0-9a-f]+))", ln)
                if tgt:
                    branches.append((len(ops) - 1, tgt.group(1)
                                     or int(tgt.group(2), 16)))
        spans = {(at[t], i) for i, t in branches if t in at and at[t] <= i}
        spans = {sp for sp in spans
                 if any(o.startswith("HMMA") for o in ops[sp[0]:sp[1] + 1])}
        # innermost: no other loop with products inside
        inner = [ops[a:b + 1] for a, b in spans
                 if not any(a <= a2 and b2 <= b and (a2, b2) != (a, b)
                            for a2, b2 in spans)]
        most = max((sum(o.startswith("HMMA") for o in lp) for lp in inner),
                   default=0)
        mixes = []
        for lp in inner:
            c = Counter(o.split(".")[0] for o in lp)
            if c["HMMA"] != most:
                continue
            mufu = Counter(o for o in lp if o.startswith("MUFU"))
            mixes.append({"instructions": len(lp), "HMMA": c["HMMA"],
                          "MUFU": dict(mufu), "LDS": c["LDS"],
                          "FFMA": c["FFMA"], "DADD": c["DADD"],
                          "SHFL": c["SHFL"],
                          "per_chain_observation": len(lp) / (16 * 16)})
        emit({"phase": "sass", "kernel": f"{name}<{D}>", "library": lib,
              "instructions": len(ops), "row_loops": mixes,
              **({} if mixes else {"branch_lines": [
                  ln.strip() for ln in body.splitlines() if "BRA" in ln][:4]})})


# --times groups: the libraries each builds and the phases it runs
TIME_GROUPS = {
    "tile": (("glm_hmc", "glm_bign"), ("phase_tile_times",)),
    "nuts": (("glm_nuts",), ("phase_nuts_times",)),
    "paths": (("glm_hmc", "glm_bign", "glm_nuts"), ("phase_path_spans",)),
    "timing": (("glm_hmc",), ("phase_timing",)),
    "rows": (("glm_hmc", "glm_bign"), ("phase_rows_times",)),
    "rows_paths": (("glm_hmc",), ("phase_rows_spans",)),
    "target_nuts": (("target_nuts",), ("phase_target_nuts_times",)),
    "target_nuts_paths": (("target_nuts", "target_hmc"),
                          ("phase_target_nuts_spans",)),
    "target": (("target_hmc", "target_rwm"),
               ("phase_target_times", "phase_target_lane_times")),
    "target_paths": (("target_hmc", "target_rwm"),
                     ("phase_target_path_spans",)),
    "wide": (("glm_hmc", "glm_bign"), ("phase_wide_times",)),
    "wide_paths": (("glm_hmc", "glm_bign"), ("phase_wide_path_times",)),
    "wide_nuts": (("glm_nuts",), ("phase_wide_nuts_times",)),
    "wide_nuts_paths": (("glm_nuts",), ("phase_wide_nuts_path_times",)),
    "dense_target": (("target_hmc", "target_nuts"),
                     ("phase_dense_target_times",)),
    "xwide": (("glm_hmc", "glm_bign"), ("phase_xwide_times",)),
    "xwide_nuts": (("glm_nuts",), ("phase_xwide_nuts_times",)),
    "chunked": (("glm_hmc", "glm_bign"), ("phase_chunked_times",)),
    "chunked_nuts": (("glm_nuts",), ("phase_chunked_nuts_times",
                                     "phase_chunked_nuts_path_times")),
}


def chunked_nuts_main():
    """``python3 chip_smoke.py --only chunked_nuts``: the chunked NUTS
    phases alone, on the libraries they need (glm_hmc, glm_bign, glm_nuts):
    the kernel checks, phase_chunked_paths (whose adaptive runs from the
    mode are the NUTS paths' reference), the NUTS paths and the kernels'
    times at d 4096."""
    phase_device()
    step("build", phase_build, ("glm_hmc", "glm_bign", "glm_nuts"))
    step("chunked_nuts_kernels", phase_chunked_nuts_kernels)
    _, means = step("chunked_paths", phase_chunked_paths)
    step("chunked_nuts_paths", phase_chunked_nuts_paths, means)
    step("chunked_nuts_times", phase_chunked_nuts_times, ds=(CHUNKED_D,))


# the phase groups ``--only`` runs alone
ONLY_GROUPS = {"chunked_nuts": chunked_nuts_main}


def phase_rows_times():
    """Kernel 3b at its adaptive HMC path's shape, with the step and leap
    count pinned (ROWS_TIME_FROZEN): phase_new_kernel_times."""
    return phase_new_kernel_times(ROWS_TIME_FROZEN)


def times_main(groups=tuple(TIME_GROUPS)):
    """``python3 chip_smoke.py --times [ROOT] [--only g1,g2]``: build the
    libraries of the named groups of TIME_GROUPS (default: all) from the
    package under ROOT (default: this checkout) and time them: kernels 1-4
    alone (tile: phase_tile_times), kernels 8 and 9 at pinned shapes
    (nuts: phase_nuts_times), the spans of their paths and of bench.py's
    drivers (paths: phase_path_spans), the drivers' leapfrog/s at 65536
    chains (timing: phase_timing), kernel 3b at its pinned shape (rows)
    and the spans of its four paths (rows_paths), kernel 8b at pinned
    shapes on two targets (target_nuts) and the spans of its two paths
    (target_nuts_paths), kernels 5-7 at their paths' shapes and 5 and 7
    in each layout at pinned shapes (target: phase_target_times,
    phase_target_lane_times), the spans of the kernel-5 and kernel-7
    paths (target_paths), and kernels 5 and 8b on dense targets beside
    their non-dense instantiation at d 10-1024 (dense_target); so that one
    call on one card can time a parent tree and this one in turns."""
    phase_device()
    phase_build(tuple(dict.fromkeys(
        lib for g in groups for lib in TIME_GROUPS[g][0])))
    for g in groups:
        for phase in TIME_GROUPS[g][1]:
            globals()[phase]()


if __name__ == "__main__":
    if sys.argv[1:2] == ["--sass"]:
        phase_sass()
    elif sys.argv[1:2] == ["--only"]:
        for g in sys.argv[2].split(","):
            ONLY_GROUPS[g]()
    elif sys.argv[1:2] == ["--times"]:
        args = sys.argv[2:]
        only = tuple(TIME_GROUPS)
        if "--only" in args:
            at = args.index("--only")
            only = tuple(args[at + 1].split(","))
            args = args[:at] + args[at + 2:]
        if args:  # before anything imports the package
            sys.path.insert(0, os.path.abspath(args[0]))
        times_main(only)
    else:
        main()
