#!/usr/bin/env python3
"""Smoke run of pint_tpu_torch on one NVIDIA GPU: the headline chi2 grid,
the full-width DD fit, the full-width GLS fit with a NANOGrav-style
noise model, the full-width DDK fit in ecliptic coordinates, the
full-width noise-fitting GLS fit that ``Fitter.auto`` picks, with LM,
Powell and the grid API, the full-width wideband fit (TOAs and their
DMs) with the DM family of the delay kernel's row function, the
full-width chromatic noise fit with the chromatic family of the row
function, the full-width spider-binary fit (an FBn orbit, ORBWAVEs
and the planets' Shapiro delays) with the orbit family of the row
function, and the simulate-fit-scan path (the J0740-class set simulated
on the card, fitted, scanned over M2/SINI in checkpointed chunks with a
SIGTERM and resume, and its random models).

Run from the repository root, with no arguments::

    python3 chip_smoke.py

Phases, each printing one JSON line with its numbers and seconds:

1. device: the card (``nvidia-smi`` name and power limit);
2. build: every CUDA kernel of the package (``qs_phase``, ``kepler``,
   ``delay_chain``, ``phase_chain``), compiled with nvcc for sm_90a, one
   nvcc process per source at once;
3. qs_phase_frac: the kernel against its plain PyTorch version on the
   card, at the main path's shapes (the bench tim's 12,500 TOAs at the 9
   grid points): fractions, tangents, the TZR words mode, kernel and
   plain times, and the kernel's least possible time on this card;
4. main_path: ``get_model(j0740_realistic_par())`` ->
   ``get_TOAs(bench_cache/j0740_bench_wide_12500.tim)`` -> ``WLSFitter`` ->
   ``grid_chisq_flat`` over the bench's 3x3 M2/SINI grid (maxiter=2), with
   the kernels' launch counts zeroed just before and read just after: the
   fused ``phase_chain`` launches must run, the unfused ``qs_phase_frac``
   and ``delay_chain`` ones must not;
   grid_timing: warm grid wall time (median of 3) and launches per call;
   grid_profile: one warm grid call under torch.profiler (device busy and
   idle share, kernel launches, the kernels that take the device time);
   plain_grid: the same grid with the phase chain run by the plain
   composition on the card (no kernel); chi2 must agree within 1e-6
   relative;
   reference: the grid on the card on a small simulated J0740 set
   (``tests/data/j0740_sim_200.tim``), whose chi2 must agree within 1e-6
   relative with pint_tpu's, stored beside it by
   ``python tests/torch_port_data.py``.  (The bench tim predates the
   reference's current timing chain: its prefit residuals are spread over
   the whole pulse period, so its chi2 checks consistency, not physics.)
5. dd_main_path: the second path, at full width:
   ``get_model(dd_realistic_par())`` -> ``make_fake_toas_uniform`` (12,500
   TOAs, seed 0, on the card) -> ``write_tim`` into build/ ->
   ``get_TOAs`` -> the perturbed start -> ``WLSFitter.fit_toas(maxiter=3)``
   (the fused loop on the card), with the launch counts zeroed just before
   the fitter is built and read just after the fit; then three warm fits
   from the same start (median wall, launches per fit); status, chi2/dof
   and the pulls of the orbit and spin against the simulated truth;
   kepler_E: the kernel against its plain version on the card, on the DD
   path's own M and e (from the delay_chain kernel, which solves Kepler's
   equation inside the chain on the paths) and on a sweep of e x 4096 M:
   E, tangents, times, the least possible time on this card;
   dd_fused_vs_eager: the same fit through the eager rung on the card
   (values within 1e-3 sigma, uncertainties within 1e-3 relative), and
   the final covariance at the fitted point assembled on the card against
   the same assembled on the CPU;
   dd_fit_profile: one warm fit under torch.profiler;
   dd_reference: the committed 200-TOA DD set fitted on the card, against
   pint_tpu's eager fit stored beside it (``tests/data/dd_sim_200*``):
   values within 1e-3 sigma, uncertainties within 1e-3 relative, chi2
   within 1e-6 relative.
6. gls_main_path: the third path, at full width (``dd_gls_nanograv``):
   ``get_model(dd_noise_realistic_par())`` -> 12,500 epoch-clustered TOAs
   simulated on the card with EFAC/EQUAD-scaled white noise and one
   realization of ECORR and red noise -> ``write_tim`` -> ``get_TOAs`` ->
   the perturbed start -> ``GLSFitter.fit_toas(maxiter=3)`` on the card,
   launch counts zeroed just before and read just after, the plain
   component delays counted (none may run); three warm fits (median wall,
   launches per fit, the ``fit_info["seconds"]`` split); status, chi2/dof,
   pulls, peak memory;
7. ddk_main_path: the fourth path, at full width (12,500 TOAs, 88 fit
   parameters): ``simulate_ddk_ecliptic_realistic`` (ELONG/ELAT free,
   frozen proper motion and parallax, the DDK binary with KIN and KOM
   free; on the card) -> ``write_tim`` -> ``get_TOAs`` -> the perturbed
   start -> ``WLSFitter.fit_toas(maxiter=3)``, the launch counts zeroed
   just before the fitter is built and read just after the fit, the plain
   component delays counted (none may run); three warm fits; status,
   chi2/dof, the normal matrix's condition, the pulls of the orbit, spin,
   KIN and KOM against the simulated truth;
   ddk_fit_profile: one warm DDK fit under torch.profiler;
   ddk_reference: the committed 200-TOA DDK set fitted on the card,
   against pint_tpu's eager fit stored beside it
   (``tests/data/ddk_ecl_sim_200*``) at the DD reference's bars;
   delay_chain: the kernel against the plain component delays on the card
   on the four paths' full-width models and on the other DD and ELL1
   variants of its row function (``examples.variant_par``: DDS, DDH,
   DDGR, DDK in equatorial coordinates, ELL1H in its three modes, ELL1k;
   each on the DD or the grid path's 12,500 TOAs): delay within 1e-12 s, every
   jacfwd column within 1e-10 relative, the DD orbit's E bit-equal to the
   kepler_E kernel's, the multi-lane tangent launch bit-equal to the
   single-lane one at lanes 1, 3, 10, 76 and P; the primal and the
   tangent launch timed at the GLS path's 1 x 10 and 1 x 76 lanes and
   the grid's 9 x 10 and 9 x 76, every lanes-per-thread in turns (1, 2,
   4, 4, 2, 1), each with its least possible time on this card, and the
   DDK path's at 1 x 12 and 1 x 76;
   the grid's 9 x 76 tangents through vmap(jvp) against the plain
   version's; ptxas's registers and spills of every kernel; launches per
   grid call, DD fit and GLS fit;
   phase_chain: the fused kernel on the four paths' full-width models and
   the variants, against the unfused card chain (the delay_chain kernel, PyTorch's
   shift, the qs_phase_frac kernel and its tangent rule): frac, slope and
   dt64 bit-equal at 9 θ sets in the nearest and pulse-number modes, the
   TZR words bit-equal, the tangents through jvp bit-equal at lanes 1, 3,
   10, 76 and P, the grid's vmap over 9 points of a jacfwd one primal and
   one tangent launch and bit-equal, every lanes-per-thread bit-equal to
   the single-lane launch; frac within 1e-12 cycles of the plain phase on
   the delay_chain kernel's delay and within F0 x 1e-12 s of the plain
   composition, the columns within 1e-10 relative of it; the fused
   primal timed at the
   grid's 9 θ sets and the GLS path's 1 against the unfused chain (CUDA
   events around each whole chain, in turns), the fused tangent at 1 x 10,
   1 x 76, 9 x 10 and 9 x 76 lanes (every lanes-per-thread in turns)
   against the delay_chain tangent launch plus the unfused rule, each
   with its least possible time on this card;
   the kDDK instantiation at the DDK path's 1 θ set (primal) and 1 x 12
   and 1 x 88 lanes (tangent);
   ptxas's registers and spills; launches per grid call, DD fit, GLS fit
   and DDK fit;
   gls_card_vs_host: the final GLS solve at the fitted point on the card
   against the same solve on the CPU (step in sigma, uncertainties,
   chi2), each timed;
   gls_fit_profile: one warm GLS fit under torch.profiler (idle share,
   kernels, the top kernels, copies by direction);
   gls_reference: the committed 200-TOA GLS set fitted on the card,
   against pint_tpu's GLS fit stored beside it
   (``tests/data/dd_gls_sim_200*``): values within 1e-3 sigma,
   uncertainties within 1e-3 relative, chi2 within 1e-6 relative, the
   noise realizations within 1e-4 of their rms.
8. auto_noise_fit: the fifth path, at full width (12,500 TOAs, 86 timing
   and 11 noise parameters): ``simulate_dd_noise_fit`` (the GLS
   configuration with per-TOA errors log-uniform over 0.5-3 us; on the
   card) -> ``write_tim`` -> ``get_TOAs`` -> the perturbed start with the
   noise parameters at ``examples.NOISE_FIT_START`` -> ``Fitter.auto``
   (a DownhillGLSFitter) -> ``fit_toas()`` (maxiter 20, two noise fits:
   L-BFGS-B over the likelihood, its gradient by autograd on the card),
   the launch counts zeroed just before the fitter is built and read just
   after, the plain delays and the phase kernel's reverse-mode calls
   counted (none may run); status, chi2/dof, timing pulls against the
   truth, noise values, uncertainties and pulls against the injected
   values, L-BFGS-B evaluations, peak memory, the cold wall and two warm
   walls, the KS normality of the whitened residuals;
   noise_fit_profile: one warm noise fit under torch.profiler;
   noise_lnlike_card_vs_cpu: the likelihood and its gradient at the
   fitted point and at the fit's start on the card against the CPU's
   plain evaluation (1e-9 relative; the gradient's gap 1e-7 of its norm
   at the start), the ms of one of each and of the likelihood's
   Cholesky;
   auto_wls_fit: ``Fitter.auto`` on the DD path's TOAs (a
   DownhillWLSFitter): CONVERGED, chi2/dof, pulls, launches, warm wall;
   lm_fit: ``LMFitter`` from the same start: chi2 within 1e-6 of the
   downhill fit's, values within 0.2 sigma; its damped eigh timed;
   degraded_lm: ``WLSFitter.fit_toas`` with the WLS solve kernels
   poisoned (NaN steps) in this phase only: the fused and eager rungs
   NONFINITE, the LM rung's chi2 within 1e-6 of lm_fit's;
   fitter_reference: on the committed 200-TOA sets, DownhillWLSFitter,
   LMFitter and PowellFitter (the five perturbed parameters free) on
   ``dd_sim_200`` and DownhillGLSFitter's noise fit on
   ``dd_noisefit_sim_200`` against pint_tpu's stored fits;
   grid_api: ``grid_chisq``, ``grid_chisq_derived`` and ``tuple_chisq``
   bit-equal to ``grid_chisq_flat`` on the grid path, and within 1e-6 of
   pint_tpu's stored grid on ``j0740_sim_200``.
9. wideband_main_path: the sixth path, at full width (12,500 TOAs, each
   with a wideband DM: 25,000 rows; 89 timing parameters, the three
   DMEFACs): ``simulate_wideband_realistic`` (the GLS configuration of
   ``wideband_nanograv_par``: NE_SW, two DMJUMPs, DMEFAC/DMEQUAD; on the
   card) -> ``write_tim`` -> ``get_TOAs`` -> the perturbed start (DMJUMPs
   0, DMEFACs 1) -> ``Fitter.auto`` (a WidebandDownhillFitter) ->
   ``fit_toas()``, the launch counts zeroed just before the fitter is
   built and read just after, the plain delays and the phase kernel's
   reverse-mode calls counted (none may run); status, chi2/dof, the pulls
   of the orbit, spin, DMJUMPs, NE_SW and DMEFACs against the truth; two
   warm walls (``wb_fit_warm_s``); ``WidebandTOAFitter.fit_toas(maxiter=
   3)`` cold and three warm (``wb_gls_fit_warm_s``) and
   ``WidebandLMFitter.fit_toas()`` from the same start;
   wideband_profile: one warm ``Fitter.auto`` fit under torch.profiler
   (idle share, kernels, copies by direction);
   wideband_reference: the committed 200-TOA wideband set
   (``tests/data/wb_sim_200*``) fitted on the card by the three wideband
   fitters against pint_tpu's stored fits (timing values 1e-3 sigma,
   uncertainties 1e-3, chi2 1e-6; the downhill fit's chi2 1e-3 and
   DMEFACs 1e-2; LM's values 1e-2 sigma);
   dm_family_chain: the delay_chain and phase_chain kernels against the
   plain delays and the unfused chain (as in phases delay_chain and
   phase_chain) on the DM family's variants (``examples.dm_family_par``:
   NE_SW with SWM 0 and 1, SWX, DMJUMP, FDJUMPDM and FD<k>JUMP on the DD
   path's and the grid path's 12,500 TOAs) and on the wideband path's
   model; both kernels timed at the wideband path's shapes and on the
   SWM 1 variant, with their bounds; ptxas's registers and spills of
   every instantiation, the DM family's among them.
10. chromatic_main_path: the seventh path, at full width (12,500 TOAs in
   3,125 epochs on 430, 820 and 1400 MHz; 91 timing parameters, the
   chromatic and solar-wind GPs' TNCHROMAMP, TNCHROMGAM and TNSWAMP;
   basis 12,500 x 3,305): ``simulate_chromatic_j1713`` (the GLS
   configuration of ``chromatic_j1713_par``: the troposphere, CM with CM1
   and CM2 free, an exponential dip, a chromatic Gaussian event, NE_SW,
   PLChromNoise and PLSWNoise; on the card) -> ``write_tim`` ->
   ``get_TOAs`` -> the perturbed start (``examples.chromatic_start``) ->
   ``Fitter.auto`` (a DownhillGLSFitter) -> ``fit_toas()``, the launch
   counts zeroed just before the fitter is built and read just after,
   the plain delays and the phase kernel's reverse-mode calls counted
   (none may run); status, chi2/dof, the pulls of the orbit, spin and
   chromatic terms and of the three noise parameters against the truth,
   two warm walls (``chrom_fit_warm_s``), peak memory;
   chromatic_profile: one warm fit under torch.profiler (idle share,
   the top kernels, copies by direction);
   chromatic_reference: the committed 200-TOA chromatic set
   (``tests/data/chrom_sim_200*``, DownhillGLSFitter at the noise fit's
   bars) and WaveX set (``tests/data/wavex_sim_200*``, WLSFitter at the
   DD reference's bars) fitted on the card against pint_tpu's stored
   fits;
   chromatic_chain: the delay_chain and phase_chain kernels against the
   plain delays and the unfused chain (as in dm_family_chain) on each
   chromatic-family term alone on DD and ELL1
   (``examples.chromatic_family_par``, on the DD and grid paths' 12,500
   TOAs), on the WaveX family's layout and on the chromatic path's
   model; both kernels timed at the chromatic path's and the WaveX
   layout's shapes with their bounds; ptxas's registers and spills of
   every instantiation, and the fused kernel's registers of the
   instantiations without the chromatic family against those they had
   before it came.
11. orbit_main_path: the eighth path, at full width (12,500 TOAs, 95 fit
   parameters): ``simulate_spider_realistic`` (a redback-class ELL1
   binary, PB 0.198 d, whose orbit is an FBn series with FB0 and FB1 free
   and FB2 frozen, four ORBWAVE harmonics free, PLANET_SHAPIRO; on the
   card) -> ``write_tim`` -> ``get_TOAs`` (the planets' positions loaded)
   -> the perturbed start (``examples.spider_start``) -> ``Fitter.auto``
   (a DownhillWLSFitter) -> ``fit_toas()``, the launch counts zeroed just
   before the fitter is built and read just after the fit, the plain
   delays and the phase kernel's reverse-mode calls counted (none may
   run); status, chi2/dof, the pulls of F0, F1, FB0, FB1, A1, TASC, EPS1,
   EPS2 and each ORBWAVE amplitude against the truth, two warm walls
   (``orbit_fit_warm_s``), peak memory, the whitened normal matrix's
   condition and the fit's largest correlation;
   orbit_profile: one warm fit under torch.profiler;
   orbit_reference: the committed 200-TOA spider set
   (``tests/data/spider_sim_200*``, ``Fitter.auto``) and BT_PIECEWISE set
   (``tests/data/btpw_sim_200*``, ``WLSFitter.fit_toas(maxiter=3)``)
   fitted on the card against pint_tpu's stored fits;
   orbit_chain: the delay_chain and phase_chain kernels against the plain
   delays and the unfused chain (as in chromatic_chain) on each orbit
   term alone on DD and ELL1 (``examples.orbit_family_par``), the planets
   on no binary, BT_PIECEWISE on BT (``examples.btpw_par``), a layout
   with the DM and chromatic families too (``examples.orbit_mixed_par``)
   and the spider path's model, all on the spider path's 12,500 TOAs;
   both kernels timed at the spider path's and the mixed layout's shapes
   with their bounds; ptxas's registers and spills of the orbit family's
   instantiations, and every other kernel's against the parent's
   (``PTXAS_REFERENCE``): identical, or the phase fails.
12. sim_main_path: the ninth path, sim_scan, at full width (12,500 TOAs,
   the headline's par with 70 DMX bins and its 86 fit parameters):
   ``examples.simulate_j0740_realistic`` on the card ->
   ``WLSFitter.fit_toas(maxiter=3)`` (M2 and SINI frozen; chi2/dof in
   SIM_CHI2_PER_DOF, every free parameter within 5 sigma of the par's
   value) -> a fit with M2 and SINI free, whose uncertainties give the
   steps of a 5 x 5 M2/SINI grid centred on the truth -> the
   whole-grid program and ``grid_chisq_flat(chunk_size=4,
   checkpoint=...)`` (7 chunks; within 1e-6 of each other, the chi2
   minimum within one step of the truth) ->
   ``calculate_random_models`` at 100 draws on a fit of the same set
   with RANDOM_MODELS_FROZEN frozen (at most 2 primal and no tangent
   launch, the draws' scatter over the covariance's prediction in
   SCATTER_RATIO); every chunk of the scan OK; the launch counts zeroed
   just before and read just after;
   sim_scan_timing: the chunked scan (``scan_warm_s``) and the random
   models (``random_models_warm_s``), median of 3, launches per call,
   peak memory, one profile of each; every chunk of every timed scan
   OK, and each repeat bit-identical to the first chunked scan;
   sim_scan_faults: a SIGTERM after chunk 2 (``ScanInterrupted``, the
   checkpoint left) and ``resume=True`` (3 chunks restored, every chunk
   OK, bit-identical to the chunked scan), a chunk made non-finite once
   (RETRIED, bit-identical), a chunk that raises beyond its retries
   (REROUTED through one unbatched fit per point, within 1e-6); every
   other chunk OK;
   sim_chain: the fused primal over the 100 draws' θ sets, bit-equal to
   the unfused card chain and within F0 x 1e-12 s of the plain
   composition, timed against its bound; the chain timed at the scan's
   chunk width, primal and tangent.

Then a ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and, last,
``{"ok": true, "device": {...}}``.  Any failure raises: the script exits
non-zero without the last line.  It needs CUDA and the repository beside
it, and exits non-zero otherwise.

``main(Run(...))`` runs the same phases on another device or at other
sizes (``tests/test_torch_smoke_rehearsal.py`` runs them on the CPU at
200 TOAs, ``tests/test_torch_smoke_rehearsal_scan.py`` the sim_scan
path at 300 TOAs), or only some of the paths (``Run.paths``, of
``PATHS``: the first eight run together or not at all, sim_scan alone;
without the first eight no kernels line is printed); with no arguments
it runs every path on the card at full width.
``python3 chip_smoke.py --ptxas-reference CSRC OUT.json`` compiles
another checkout's ``delay_chain.cu`` and ``phase_chain.cu`` (needs
nvcc, no card) and writes their ptxas report in ``PTXAS_REFERENCE``'s
format.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import time
from typing import NamedTuple

REPO = os.path.dirname(os.path.abspath(__file__))
TIM = os.path.join(REPO, "bench_cache", "j0740_bench_wide_12500.tim")
REF_TIM = os.path.join(REPO, "tests", "data", "j0740_sim_200.tim")
REF_JSON = os.path.join(REPO, "tests", "data", "j0740_sim_200_grid_chi2.json")
REF_DMX_BINS = 8
DD_TIM = os.path.join(REPO, "build", "dd_realistic_12500.tim")
DD_REF_TIM = os.path.join(REPO, "tests", "data", "dd_sim_200.tim")
DD_REF_JSON = os.path.join(REPO, "tests", "data", "dd_sim_200_fit.json")
GLS_TIM = os.path.join(REPO, "build", "dd_gls_12500.tim")
GLS_REF_TIM = os.path.join(REPO, "tests", "data", "dd_gls_sim_200.tim")
GLS_REF_JSON = os.path.join(REPO, "tests", "data",
                            "dd_gls_sim_200_gls_fit.json")
DDK_TIM = os.path.join(REPO, "build", "ddk_ecl_12500.tim")
DDK_REF_TIM = os.path.join(REPO, "tests", "data", "ddk_ecl_sim_200.tim")
DDK_REF_JSON = os.path.join(REPO, "tests", "data",
                            "ddk_ecl_sim_200_fit.json")
NOISE_TIM = os.path.join(REPO, "build", "dd_noise_fit_12500.tim")
NOISEFIT_REF_TIM = os.path.join(REPO, "tests", "data",
                                "dd_noisefit_sim_200.tim")
NOISEFIT_REF_JSON = os.path.join(REPO, "tests", "data",
                                 "dd_noisefit_sim_200_fit.json")
WB_TIM = os.path.join(REPO, "build", "wideband_12500.tim")
WB_REF_TIM = os.path.join(REPO, "tests", "data", "wb_sim_200.tim")
WB_REF_JSON = os.path.join(REPO, "tests", "data", "wb_sim_200_fit.json")
CHROM_TIM = os.path.join(REPO, "build", "chromatic_12500.tim")
CHROM_REF_TIM = os.path.join(REPO, "tests", "data", "chrom_sim_200.tim")
CHROM_REF_JSON = os.path.join(REPO, "tests", "data", "chrom_sim_200_fit.json")
WAVEX_REF_TIM = os.path.join(REPO, "tests", "data", "wavex_sim_200.tim")
WAVEX_REF_JSON = os.path.join(REPO, "tests", "data", "wavex_sim_200_fit.json")
SPIDER_TIM = os.path.join(REPO, "build", "spider_12500.tim")
SPIDER_REF_TIM = os.path.join(REPO, "tests", "data", "spider_sim_200.tim")
SPIDER_REF_JSON = os.path.join(REPO, "tests", "data",
                               "spider_sim_200_fit.json")
BTPW_REF_TIM = os.path.join(REPO, "tests", "data", "btpw_sim_200.tim")
BTPW_REF_JSON = os.path.join(REPO, "tests", "data", "btpw_sim_200_fit.json")
#: ptxas's registers, stack and spills of the delay_chain and phase_chain
#: kernels of the 21 template values before the orbit family came,
#: compiled on the card's machine from the sources before it
#: (``python3 chip_smoke.py --ptxas-reference <their csrc> <this file>``)
PTXAS_REFERENCE = os.path.join(REPO, "tests", "data",
                               "chain_ptxas_before_orbit_family.json")
FITTERS_REF_JSON = os.path.join(REPO, "tests", "data",
                                "dd_sim_200_fitters.json")
DD_MAXITER = 3
#: the DD fit's start: offsets [par units] from the simulated truth, as
#: pint_tpu's DD round trip perturbs it (tests/test_binary_dd.py)
DD_PERTURB = {"PB": 1e-7, "A1": 3e-6, "ECC": 1e-6, "OM": 3e-4,
              "F0": 1e-10}
#: the DDK fit's start: the DD fit's, with KIN and KOM moved [deg]
DDK_PERTURB = {**DD_PERTURB, "KIN": 0.05, "KOM": 0.5}
#: the parameters whose pulls test_recover_dd_orbit checks, but DM (70
#: DMX bins over the whole span make DM degenerate)
DD_PULL_PARAMS = ("F0", "F1", "PB", "A1", "T0", "ECC", "OM")
DDK_PULL_PARAMS = DD_PULL_PARAMS + ("KIN", "KOM")
#: the wideband fit's pulls: the orbit and spin, the DMJUMPs and NE_SW
WB_PULL_PARAMS = DD_PULL_PARAMS + ("DMJUMP1", "DMJUMP2", "NE_SW")
#: WidebandTOAFitter's iterations (as the GLS path's)
WB_MAXITER = 3
#: the chromatic fit's pulls: the orbit and spin, and the chromatic terms
CHROM_PULL_PARAMS = DD_PULL_PARAMS + ("CM1", "CM2", "EXPDIPAMP_1",
                                      "EXPDIPTAU_1", "CHROMGAUSS_LOGAMP_1")
#: the spider fit's pulls: spin, the orbit (and each ORBWAVE amplitude)
SPIDER_PULL_PARAMS = ("F0", "F1", "FB0", "FB1", "A1", "TASC", "EPS1",
                      "EPS2")
#: ptxas's registers of the fused phase_chain's primal and the spill
#: stores of its L = 4 tangent before the chromatic family came (PERF.md,
#: "Registers"): the instantiations without it keep them
REF_PHASE_CHAIN_REGISTERS = {
    "none/primal": 66, "ELL1/primal": 80, "DD/primal": 74,
    "DDK/primal": 86}
REF_PHASE_CHAIN_L4_SPILL = {
    "none/tangent_L4": 0, "ELL1/tangent_L4": 64, "DD/tangent_L4": 196,
    "DDK/tangent_L4": 536, "none+DM/tangent_L4": 320,
    "ELL1+DM/tangent_L4": 476, "DD+DM/tangent_L4": 648,
    "DDK+DM/tangent_L4": 1012}
KEPLER_E_SWEEP = (0.0, 1e-5, 0.1, 0.5, 0.9)
OUT_DIR = os.path.join(REPO, "chiprun_out")
GRID_M2 = (0.23, 0.25, 0.27)
GRID_SINI = (0.97, 0.99, 0.995)
SEED = 20261016

#: NVIDIA H100 SXM data sheet: HBM3 bandwidth, and the non-tensor-core
#: float32 and float64 rates (each add, sub, mul or conversion counted
#: as one operation)
MEM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float32": 67e12, "float64": 34e12}
#: float64 matrix products on the tensor cores (H100 SXM data sheet)
PEAK_F64_MATMUL_PER_S = 67e12

#: lane counts at which the multi-lane tangent launch is held bit-equal
#: to the single-lane one (and at the model's P), and the grid's θ sets
LANE_COUNTS = (1, 3, 10, 76)
GRID_POINTS = 9

#: the kernels that every path launches: the delay chain, the Kepler
#: solve and the phase run inside the fused phase_chain launches
ON_PATHS = ("phase_chain_primal", "phase_chain_tangent")
#: the unfused kernels, which the paths no longer launch (each is held
#: against its plain version in its own phase)
OFF_PATHS = ("qs_phase_frac", "delay_chain_primal", "delay_chain_tangent")

#: bars of this run
FRAC_TOL_CYCLES = 1e-12
TANGENT_TOL = 1e-12
CHI2_TOL = 1e-6
KEPLER_TOL_RAD = 1e-13
FIT_SIGMA_TOL = 1e-3
UNC_TOL = 1e-3
PULL_MAX = 5.0
DELAY_TOL_S = 1e-12
COLUMN_TOL = 1e-10
#: the noise realizations share the offset direction, which lies in the
#: near-degenerate DM/offset/FD subspace (tests/test_torch_gls.py)
NOISE_RESID_TOL = 1e-4
#: the noise likelihood on the card against the CPU's plain evaluation:
#: the value, and the gradient's gap over its norm (at the fitted point,
#: over its norm at the fit's start: see lnlike_card_vs_cpu)
LNLIKE_TOL = 1e-9
LNLIKE_GRAD_TOL = 1e-7
#: a noise fit against pint_tpu's: noise values in their sigma, their
#: uncertainties, and chi2, which goes as EFAC^-2 and so moves with the
#: noise values (tests/test_torch_downhill.py)
NOISE_SIGMA_TOL = 1e-2
NOISE_UNC_TOL = 1e-2
NOISEFIT_CHI2_TOL = 1e-3
#: LM's and Powell's values against pint_tpu's [sigma]: each step of
#: both is decided by comparing chi2 values, which carry ~1e-7-1e-6 of
#: rounding on 200 TOAs, so another rounding of the phase (the card's
#: kernel) can flip a decision; LM's stored fit stops at its 50th
#: iteration short of the minimum, Powell at its tolerance, and either
#: then lands a few 1e-3 sigma away (tests/test_torch_lm_powell.py)
TRAJECTORY_SIGMA_TOL = 1e-2
#: LM's fitted values against the downhill WLS fit's [sigma]
LM_VS_WLS_SIGMA = 0.2

#: the paths main() drives, in order.  The first eight share their models
#: and TOAs (phases delay_chain and phase_chain hold all of them), so they
#: run together or not at all; sim_scan builds what it needs itself
PATHS = ("grid", "dd_fit", "gls_fit", "ddk_fit", "noise_fit",
         "wideband_fit", "chromatic_fit", "spider_fit", "sim_scan")
#: the sim_scan path: the simulated set's truth on the grid's axes, the
#: grid's points per axis and its step in the sigma of a fit with both
#: free, the chunk width, the chunk after which a SIGTERM arrives, the
#: random models' draws and seed, the fit's chi2/dof window (12,400 dof
#: give a standard deviation of 0.013), and the window of the draws'
#: scatter over the covariance's prediction
SIM_TRUTH = {"M2": 0.25, "SINI": 0.99}
SCAN_AXIS = 5
SCAN_STEP_SIGMA = 2.0
SCAN_CHUNK = 4
SCAN_SIGTERM_AFTER = 2
RANDOM_MODELS = 100
RANDOM_MODELS_SEED = 1
#: frozen in the random models' fit: with three receiver frequencies the
#: per-frequency constants (FD1-4, DM, the two JUMPs and the offset: eight
#: parameters for three constraints) are degenerate up to the spin
#: frequency's 1e-9 drift, and DM with the sum of the DMX bins exactly;
#: the draw's 1e-12 on the correlation's diagonal then moves the phase by
#: many cycles along them
RANDOM_MODELS_FROZEN = ("FD1", "FD2", "FD3", "FD4", "DM")
SIM_CHI2_PER_DOF = (0.95, 1.05)
SCATTER_RATIO = (0.8, 1.2)


class Run(NamedTuple):
    """Where the phases run and at what size: the card and the full width
    of the paths (TOAs, DMX bins, fit parameters), the grid's tim, and
    where the DD, GLS, DDK and noise-fit tims and the profiles are
    written."""

    dev: str = "cuda"
    tim: str = TIM
    ntoas: int = 12500
    dmx_bins: int = 70
    nfit: int = 86
    dd_tim: str = DD_TIM
    gls_tim: str = GLS_TIM
    out_dir: str = OUT_DIR
    ddk_tim: str = DDK_TIM
    #: the DDK path's fit parameters: the DD path's and KIN, KOM
    ddk_nfit: int = 88
    noise_tim: str = NOISE_TIM
    wb_tim: str = WB_TIM
    #: the wideband path's fit parameters: the DD path's, two DMJUMPs and
    #: NE_SW
    wb_nfit: int = 89
    chrom_tim: str = CHROM_TIM
    #: the chromatic path's fit parameters: the DD path's, CM1, CM2, the
    #: dip's amplitude and timescale and the event's amplitude
    chrom_nfit: int = 91
    #: the chromatic fit's accepted end states and its GP amplitudes (a
    #: small rehearsal's 50 epochs constrain neither the dip, so that its
    #: fit may end DIVERGED, nor the path's GPs, so that it takes
    #: ``examples.CHROM_NOISE_200``'s)
    chrom_status: tuple = ("CONVERGED",)
    chrom_noise: dict = None
    spider_tim: str = SPIDER_TIM
    #: the spider path's fit parameters: spin, astrometry, DM, A1, TASC,
    #: EPS1, EPS2, FB0, FB1, eight ORBWAVE amplitudes, FD1-4, two JUMPs
    #: and the DMX bins
    spider_nfit: int = 95
    #: the layouts orbit_chain holds besides the spider path's model (None:
    #: every one; a small rehearsal may take fewer)
    orbit_layouts: tuple = None
    #: the paths to drive, of PATHS (None: every one)
    paths: tuple = None
    #: the sim_scan path's grid points per axis and chunk width (a small
    #: rehearsal may take a smaller grid)
    scan_axis: int = SCAN_AXIS
    scan_chunk: int = SCAN_CHUNK


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


@contextlib.contextmanager
def phase(name: str, out: dict):
    """Runs the block and prints ``out`` as the phase's line, with its
    seconds and the profiler traces retried, or irregular, inside it."""
    t0, retries = time.perf_counter(), PROFILER_RETRIES[0]
    irregular = len(PROFILER_IRREGULAR)
    yield out
    out["seconds"] = time.perf_counter() - t0
    out["profiler_retries"] = PROFILER_RETRIES[0] - retries
    out["profiler_irregular_traces"] = PROFILER_IRREGULAR[irregular:]
    emit({"phase": name, **out})


def nvidia_smi_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2]


def time_ms(torch, fn, reps: int = 25) -> float:
    """Median milliseconds of ``fn()`` over ``reps`` CUDA-event-timed calls
    after two warm-up calls (inputs stay resident in L2 between calls)."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return median(times)


def cuda_kernels(torch, fn, reps: int = 1, setup=None):
    """The CUDA kernel events of ``reps`` calls of ``fn()`` (after one
    warm-up call), from the profiler's CUPTI trace, and the wall time of
    those calls.  ``setup()``, if given, runs before each of the two
    ``reps=1`` calls, outside the traced window.  Device activity only:
    the host op events of an eager grid call number in the hundreds of
    thousands and take minutes to parse."""
    from torch.profiler import ProfilerActivity, profile

    if setup is not None:
        setup()
    fn()
    if setup is not None:
        setup()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return [ev for ev in prof.events()
            if ev.device_type == torch.autograd.DeviceType.CUDA], wall


#: profiler traces taken for one timing before it gives up
PROFILER_TRIES = 3
#: traces taken again for want of the kernel's events, in this run
PROFILER_RETRIES = [0]
#: traces whose count of the kernel's events was not one per call, in
#: this run: [events, calls, distinct kernel names]
PROFILER_IRREGULAR = []


def device_kernel_ms(torch, fn, name: str, reps: int = 20):
    """Median device time [ms] of the one CUDA kernel whose name contains
    ``name`` that each call of ``fn()`` launches, over a trace of
    ``reps`` calls.  A trace now and then comes back with some of the
    kernel's events missing, or with events of the trace before it: the
    median of the kernel named most often is kept if it has at least half
    of the events, else the trace is taken again, up to PROFILER_TRIES
    traces (None if none had enough).  Each trace taken again counts in
    PROFILER_RETRIES, each with another count than ``reps`` is listed in
    PROFILER_IRREGULAR."""
    for attempt in range(PROFILER_TRIES):
        if attempt:
            PROFILER_RETRIES[0] += 1
        events, _ = cuda_kernels(torch, fn, reps)
        by_name = {}
        for ev in events:
            if name in ev.name:
                by_name.setdefault(ev.name, []).append(ev.device_time_total)
        n = sum(len(t) for t in by_name.values())
        if n != reps:
            PROFILER_IRREGULAR.append([n, reps, len(by_name)])
        times = max(by_name.values(), key=len, default=[])
        if 2 * len(times) >= reps:
            return median(times) / 1e3
    return None


#: kernel families of the grid's device time, by kernel-name substring
#: (the rest is PyTorch's elementwise and indexing kernels)
FAMILIES = (("qs_phase_frac", ("qs_phase",)),
            ("phase_chain", ("phase_chain",)),
            ("kepler_E", ("kepler_E",)),
            ("delay_chain", ("delay_chain",)),
            ("svd", ("gesvd", "svdj", "bdsqr", "gebrd", "orgbr", "ormbr")),
            ("cholesky", ("potrf", "trsm", "trsv")),
            ("eigh", ("sytrd", "ormtr", "orgtr", "syevd", "stedc", "steqr",
                      "larf", "syhemv", "lansy")),
            ("copies", ("Memcpy", "Memset")),
            ("reductions", ("reduce",)),
            ("gemm", ("gemm", "Gemm", "xmma")))


def profile_grid(torch, fn, out_dir: str, top: int = 8,
                 out_name: str = "grid_profile", setup=None) -> dict:
    """One warm call of ``fn()`` under torch.profiler: its wall time, the
    device time summed over its CUDA kernels, the device's idle share of
    the wall time, the number of kernels, their time by family, and the
    kernels that take the most device time.  The full list goes to
    <out_name>.json in ``out_dir``."""
    kernels, wall = cuda_kernels(torch, fn, setup=setup)
    busy_us = sum(ev.device_time_total for ev in kernels)
    by_name = {}
    for ev in kernels:
        n, t = by_name.get(ev.name, (0, 0.0))
        by_name[ev.name] = (n + 1, t + ev.device_time_total)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    families = {}
    for name, (n, t) in ranked:
        fam = next((f for f, keys in FAMILIES
                    if any(k in name for k in keys)), "elementwise_other")
        c, ms = families.get(fam, (0, 0.0))
        families[fam] = (c + n, ms + t * 1e-3)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"{out_name}.json"), "w") as f:
        json.dump([{"name": k, "count": n, "ms": t * 1e-3}
                   for k, (n, t) in ranked], f, indent=1)
    copies = {d: sum(1 for ev in kernels if d in ev.name)
              for d in ("HtoD", "DtoH", "DtoD")}
    copies_ms = {d: sum(ev.device_time_total for ev in kernels
                        if d in ev.name) * 1e-3 for d in copies}
    return {"wall_s": wall, "device_busy_s": busy_us * 1e-6,
            "device_idle_share": 1.0 - busy_us * 1e-6 / wall,
            "cuda_kernels": len(kernels), "copies_by_direction": copies,
            "copies_ms_by_direction": copies_ms,
            "families": {f: {"count": c, "ms": ms}
                         for f, (c, ms) in families.items()},
            "top_kernels": [{"name": k[:80], "count": n, "ms": t * 1e-3}
                            for k, (n, t) in ranked[:top]]}


_UNCOUNTED = [False]


@contextlib.contextmanager
def uncounted():
    """The operations dispatched inside the block are left out of
    :func:`count_ops`."""
    _UNCOUNTED[0] = True
    try:
        yield
    finally:
        _UNCOUNTED[0] = False


def count_ops(torch, fn, extra=()):
    """Elementwise arithmetic operations of ``fn()`` by result dtype: one
    per output element of every add/sub/mul/div/neg/round/conversion the
    plain version dispatches, and of the ops named in ``extra`` (each
    sin or cos counted as ONE operation, so the bound stays a lower
    bound); none inside :func:`uncounted`."""
    from torch.utils._python_dispatch import TorchDispatchMode

    arith = {"add", "sub", "mul", "div", "neg", "round", "rsub",
             "_to_copy", "where", "isnan", *extra}
    counts = {}

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func.overloadpacket.__name__ in arith \
                    and isinstance(out, torch.Tensor) and not _UNCOUNTED[0]:
                dt = str(out.dtype).replace("torch.", "")
                counts[dt] = counts.get(dt, 0) + out.numel()
            return out

    with Count():
        fn()
    return counts


def ops_seconds(ops: dict) -> float:
    """Seconds of ``ops`` (by dtype) at this card's peak rate for each."""
    return sum(n / PEAK_OPS_PER_S.get(dt, PEAK_OPS_PER_S["float32"])
               for dt, n in ops.items())


def least_time(ops: float, nbytes: float,
               rate: float = PEAK_F64_MATMUL_PER_S) -> dict:
    """The least time of a library call's work on this card: ``ops``
    float64 operations at ``rate`` (the tensor-core rate for products,
    PEAK_OPS_PER_S for the rest) or ``nbytes`` at the memory rate,
    whichever is longer."""
    t_ops, t_bytes = ops / rate, nbytes / MEM_BYTES_PER_S
    return {"bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def load(torch, dev: str, tim: str, dmx_bins: int):
    """par + tim -> (model, toas, WLSFitter) on ``dev``, M2/SINI frozen,
    as a user builds them."""
    import warnings

    from pint_tpu_torch.examples import j0740_realistic_par
    from pint_tpu_torch.fitter import WLSFitter
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.toa import get_TOAs

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        model = get_model(j0740_realistic_par(
            dmx_bins=dmx_bins).splitlines())
        toas = get_TOAs(tim, model=model)
    model.M2.frozen = True
    model.SINI.frozen = True
    fitter = WLSFitter(toas, model, device=dev)
    torch.cuda.synchronize()
    return model, toas, fitter


def tzr_pdict(torch, np, model, p: dict, dev):
    """``p`` with the masks of the 1-row TZR batch, as
    ``TimingModel.build_pdict`` forms the TZR phase."""
    ptzr = dict(p)
    ptzr["mask"] = {k: torch.as_tensor(np.asarray(v), device=dev)
                    for k, v in model.build_pdict_numpy(
                        None, model.make_tzr_toas_or_none())[1].items()}
    return ptzr


def check_kernel(torch, np, model, fitter, grid, rec: dict) -> None:
    """qs_phase_frac against its plain version on the rows of the grid:
    outputs, tangents, TZR words, times, bound."""
    from pint_tpu_torch.gridutils import grid_in_axes, stack_grid_pdict
    from pint_tpu_torch.kernels.qs_phase import (PhaseSpec, QSPhaseFrac,
                                                 qs_phase_frac)

    dev = fitter.device
    batch, p = fitter.resids.batch, fitter.resids.pdict
    calc = model.calc
    sd, others = calc._kernel_layout()

    def inputs(pp):
        delay = calc.delay(pp, batch)
        _, _, _, shift, dF = sd.kernel_inputs(pp, batch, delay)
        other = sum(c.phase_f64(pp, batch, delay) for c in others)
        return shift, dF, other

    with torch.no_grad():
        shift, dF, other = (t.contiguous() for t in torch.func.vmap(
            inputs, in_dims=(grid_in_axes(p, list(grid)),))(
                stack_grid_pdict(model, p, grid)))
    pep_day, pep_w, f_w, _, _ = sd.kernel_inputs(p, batch, torch.zeros(
        batch.ntoas, dtype=torch.float64, device=dev))
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    G, N, K = shift.shape[0], shift.shape[1], f_w.shape[0]
    f_scale = torch.tensor([1e-10, 1e-20][:K] + [0.0] * max(0, K - 2),
                           dtype=torch.float64)
    # fit-offset scale spin offsets, so the f64 Taylor term is exercised
    dF = dF + (torch.randn(G, K, generator=gen, dtype=torch.float64)
               * f_scale).to(dev)
    spec = PhaseSpec(batch.tdb_day, batch.tdb_frac_w, pep_day, pep_w, f_w,
                     p["const"]["__tzrphase__"], None, "nearest")

    k_frac, k_slope, k_dt = QSPhaseFrac.call(spec, shift, dF, other)
    p_frac, p_slope, p_dt = spec.plain(shift, dF, other)
    torch.cuda.synchronize()
    frac_err = float(torch.max(torch.abs(k_frac - p_frac)))
    rec.update(rows=G * N, G=G, N=N, K=K, max_abs_frac_err=frac_err,
               frac_bit_equal=bool(torch.equal(k_frac, p_frac)),
               max_rel_slope_err=float(torch.max(
                   torch.abs(k_slope - p_slope) / torch.abs(p_slope))),
               dt_bit_equal=bool(torch.equal(k_dt, p_dt)))
    if frac_err > FRAC_TOL_CYCLES:
        raise AssertionError(f"kernel frac off by {frac_err} cycles")

    # tangents: the kernel's jvp on seeded random tangents, against the
    # same analytic rule on the plain version's outputs, and against
    # autodiff through the plain version's words
    ts = torch.randn(G, N, generator=gen, dtype=torch.float64).to(dev)
    td = (torch.randn(G, K, generator=gen, dtype=torch.float64)
          * f_scale).to(dev)
    to = torch.randn(G, N, generator=gen, dtype=torch.float64).to(dev)
    _, k_tan = torch.func.jvp(lambda s, d, o: QSPhaseFrac.call(
        spec, s, d, o)[0], (shift, dF, other), (ts, td, to))
    _, w_tan = torch.func.jvp(lambda s, d, o: spec.plain(s, d, o)[0],
                              (shift, dF, other), (ts, td, to))
    # the rule, summed term by term: pint_tpu's secant spin frequency
    # sum_k F_k dt^k/(k+1)! plus sum_k dF_k dt^k/k! on d shift, and
    # dt^(k+1)/(k+1)! on d dF_k
    F = f_w.to(torch.float64).sum(dim=-1)
    a_tan = to.clone()
    for k in range(K):
        a_tan = a_tan + (F[k] * p_dt**k / math.factorial(k + 1)
                         + dF[:, k, None] * p_dt**k / math.factorial(k)) * ts
        a_tan = a_tan + p_dt**(k + 1) / math.factorial(k + 1) * td[:, k, None]
    scale = torch.abs(a_tan)
    rel_rule = float(torch.max(torch.abs(k_tan - a_tan) / scale))
    rel_words = float(torch.max(torch.abs(k_tan - w_tan) / scale))
    rec.update(tangent_max_rel_vs_rule=rel_rule,
               tangent_max_rel_vs_word_autodiff=rel_words)
    if rel_rule > TANGENT_TOL:
        raise AssertionError(f"kernel tangent off by {rel_rule}")
    if rel_words > TANGENT_TOL:
        raise AssertionError(
            f"kernel tangent vs word autodiff off by {rel_words}")

    # TZR words mode, on the 1-row TZR batch
    tb = model.tzr_batch
    ptzr = tzr_pdict(torch, np, model, p, dev)
    with torch.no_grad():
        delay_t = calc.delay(ptzr, tb)
        _, _, _, sh_t, dF_t = sd.kernel_inputs(ptzr, tb, delay_t)
        ot_t = sum(c.phase_f64(ptzr, tb, delay_t) for c in others)
    kw = qs_phase_frac(tb.tdb_day, tb.tdb_frac_w, pep_day, pep_w, f_w,
                       sh_t, dF_t, ot_t, mode="words")
    pw = PhaseSpec(tb.tdb_day, tb.tdb_frac_w, pep_day, pep_w, f_w, None,
                   None, "words").plain(sh_t, dF_t, ot_t)[0]
    rec["tzr_words_equal"] = bool(torch.equal(kw, pw))
    rec["tzr_words_match_pdict"] = bool(
        torch.equal(kw[0], p["const"]["__tzrphase__"]))
    if not (rec["tzr_words_equal"] and rec["tzr_words_match_pdict"]):
        raise AssertionError("TZR words mode disagrees")

    def launch():
        return QSPhaseFrac.call(spec, shift, dF, other)

    # the kernel's device time from the profiler; the wrapper call
    # (checks, allocation, ctypes launch) by CUDA events
    call_ms = time_ms(torch, launch)
    dev_ms = device_kernel_ms(torch, launch, "qs_phase_frac_kernel")
    rec.update(wrapper_call_ms=call_ms, device_kernel_ms=dev_ms)
    plain_ms = time_ms(torch, lambda: spec.plain(shift, dF, other), reps=5)
    ops = count_ops(torch, lambda: spec.plain(shift, dF, other))
    nbytes = (8 * N + 12 * N + 8 * G * N + 8 * G * K + 8 * G * N  # in
              + 4 * 4 + 4 * K * 4 + 8                           # consts
              + 3 * 8 * G * N)                                  # out
    t_bytes = nbytes / MEM_BYTES_PER_S
    t_ops = ops_seconds(ops)
    rec.update(ms=dev_ms if dev_ms is not None else call_ms,
               plain_ms=plain_ms, ops=ops, bytes=nbytes,
               bytes_ms=1e3 * t_bytes, ops_ms=1e3 * t_ops,
               bound_ms=1e3 * max(t_bytes, t_ops),
               bound_by="operations" if t_ops >= t_bytes else "bytes")


def dd_load(torch, tim: str, dmx_bins: int, perturb=None, par=None):
    """par + tim -> (model at the perturbed start, toas) of the DD
    configuration (or of ``par(dmx_bins=...)``), as a user loads them."""
    import warnings

    from pint_tpu_torch.examples import dd_realistic_par
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.toa import get_TOAs

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        model = get_model((par or dd_realistic_par)(
            dmx_bins=dmx_bins).splitlines())
        toas = get_TOAs(tim, model=model)
    for name, d in (DD_PERTURB if perturb is None else perturb).items():
        model[name].value += d
    return model, toas


def snapshot(model):
    """The free parameters' values, to put a model back at a fit's start."""
    return {n: model[n].value for n in model.free_params}


def restore(model, snap) -> None:
    for n, v in snap.items():
        model[n].value = v
        model[n].uncertainty = None


def dd_fit(torch, dev: str, model, toas, eager: bool = False,
           maxiter: int = DD_MAXITER):
    """A fresh ``WLSFitter`` on ``dev`` and its ``fit_toas(maxiter=3)``
    (or the eager rung), timed around the fit with a synchronize."""
    import warnings

    from pint_tpu_torch.fitter import WLSFitter

    fitter = WLSFitter(toas, model, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        chi2 = fitter._fit_eager(maxiter=maxiter) if eager else \
            fitter.fit_toas(maxiter=maxiter)
    torch.cuda.synchronize()
    return fitter, chi2, time.perf_counter() - t0


def device_offset(a, b) -> float:
    """a - b of two device values (an MJD's [day, frac] summed) [device
    units]."""
    import numpy as np

    return float(np.sum(np.asarray(a, np.float64) - np.asarray(b, np.float64)))


def fit_gaps(values, uncs, ref_values, ref_uncs):
    """(max |value - ref| / ref sigma, max |unc / ref unc - 1|) over the
    reference's parameters (device values and uncertainties by name)."""
    dev = max(abs(device_offset(values[n], ref_values[n])) / ref_uncs[n]
              for n in ref_values)
    unc = max(abs(uncs[n] / ref_uncs[n] - 1.0) for n in ref_uncs)
    return dev, unc


def fit_state(model, names):
    return ({n: model[n].device_value for n in names},
            {n: model[n].device_uncertainty for n in names})


def check_kepler(torch, fitter, rec: dict) -> None:
    """kepler_E against its plain version on the card: on the DD path's own
    M and e (the delay_chain kernel's, from one primal launch) and on a
    sweep of e x 4096 M in [0, 2pi); E, tangents, times, bound."""
    from pint_tpu_torch.kernels import kepler as kk
    from pint_tpu_torch.models.binary_orbits import kepler_E

    dev = fitter.device
    r = fitter.resids
    _, aux = chain_aux(fitter.model.calc, r.pdict, r.batch)
    M_main, e_main = aux[0].contiguous(), aux[1].contiguous()
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    f64 = torch.float64
    M_sw = (torch.rand(len(KEPLER_E_SWEEP), 4096, generator=gen, dtype=f64)
            * (2.0 * math.pi)).to(dev)
    e_sw = torch.tensor(KEPLER_E_SWEEP, dtype=f64, device=dev)[:, None]
    e_sw = e_sw.expand_as(M_sw).contiguous()
    rec.update(rows=M_main.numel(), e_shape=list(e_main.shape),
               sweep=list(KEPLER_E_SWEEP))
    worst_E, worst_tan = 0.0, 0.0
    for label, (M, e) in (("main", (M_main, e_main)), ("sweep", (M_sw, e_sw))):
        k_E = kk.kepler_E_op(M, e)
        p_E = kepler_E(M, e)
        torch.cuda.synchronize()
        err = float(torch.max(torch.abs(k_E - p_E)))
        dM = torch.randn(M.shape, generator=gen, dtype=f64).to(dev)
        de = (torch.randn(e.shape, generator=gen, dtype=f64) * 1e-3).to(dev)
        _, k_t = torch.func.jvp(kk.kepler_E_op, (M, e), (dM, de))
        _, p_t = torch.func.jvp(kepler_E, (M, e), (dM, de))
        # the tangent's own magnitude: (|dM| + |sin E de|) / (1 - e cos E)
        ec = torch.clamp(e, 0.0, 1.0 - 1e-9)
        scale = (torch.abs(dM) + torch.abs(torch.sin(p_E) * de)) \
            / (1.0 - ec * torch.cos(p_E))
        rel = float(torch.max(torch.abs(k_t - p_t) / scale))
        rec[f"{label}_max_abs_E_err_rad"] = err
        rec[f"{label}_tangent_max_rel"] = rel
        worst_E, worst_tan = max(worst_E, err), max(worst_tan, rel)
    rec.update(max_abs_err=worst_E, tangent_max_rel=worst_tan)
    if not worst_E <= KEPLER_TOL_RAD:
        raise AssertionError(f"kepler_E off by {worst_E} rad")
    if not worst_tan <= TANGENT_TOL:
        raise AssertionError(f"kepler_E tangent off by {worst_tan}")

    def launch():
        return kk.kepler_E_op(M_main, e_main)

    call_ms = time_ms(torch, launch)
    dev_ms = device_kernel_ms(torch, launch, "kepler_E_kernel")
    plain_ms = time_ms(torch, lambda: kepler_E(M_main, e_main), reps=5)
    ops = count_ops(torch, lambda: kepler_E(M_main, e_main),
                    extra=("sin", "cos", "clamp"))
    nbytes = 8 * (M_main.numel() + e_main.numel() + M_main.numel())
    t_bytes = nbytes / MEM_BYTES_PER_S
    t_ops = ops_seconds(ops)
    rec.update(wrapper_call_ms=call_ms, device_kernel_ms=dev_ms,
               ms=dev_ms if dev_ms is not None else call_ms,
               plain_ms=plain_ms, ops=ops, bytes=nbytes,
               bytes_ms=1e3 * t_bytes, ops_ms=1e3 * t_ops,
               bound_ms=1e3 * max(t_bytes, t_ops),
               bound_by="operations" if t_ops >= t_bytes else "bytes")


def chain_aux(calc, p, batch):
    """``(delay, aux)`` of one primal launch of the delay_chain kernel,
    ``aux`` the (3, N) M, e and E of a DD binary's Kepler solve."""
    from pint_tpu_torch.kernels.delay_chain import delay_chain_aux

    return delay_chain_aux(calc, p, batch)


@contextlib.contextmanager
def plain_delays():
    """Counts the plain component-delay chains run inside the block
    (``PhaseCalc.delay_plain``): on the card's paths there must be none."""
    from pint_tpu_torch.models.timing_model import PhaseCalc

    count = {"calls": 0}
    real = PhaseCalc.delay_plain

    def counted(self, p, batch):
        count["calls"] += 1
        return real(self, p, batch)

    PhaseCalc.delay_plain = counted
    try:
        yield count
    finally:
        PhaseCalc.delay_plain = real


def _counted():
    """Every kernel's launch counter, by the name of its kernel line."""
    from pint_tpu_torch.kernels.delay_chain import (DelayChain,
                                                    DelayChainTangent)
    from pint_tpu_torch.kernels.kepler import KeplerE
    from pint_tpu_torch.kernels.phase_chain import (PhaseChain,
                                                    PhaseChainTangent)
    from pint_tpu_torch.kernels.qs_phase import QSPhaseFrac

    return {"qs_phase_frac": QSPhaseFrac, "kepler_E": KeplerE,
            "delay_chain_primal": DelayChain,
            "delay_chain_tangent": DelayChainTangent,
            "phase_chain_primal": PhaseChain,
            "phase_chain_tangent": PhaseChainTangent}


def zero_counts() -> None:
    """Every kernel's launch count to 0."""
    for k in _counted().values():
        k.launches = 0


def counts() -> dict:
    """Every kernel's launch count, by the name of its kernel line."""
    return {name: k.launches for name, k in _counted().items()}


def check_path_launches(label: str, launches: dict) -> None:
    """The path ran the fused kernels and none of the unfused ones."""
    if min(launches[k] for k in ON_PATHS) <= 0 or any(
            launches[k] for k in OFF_PATHS):
        raise AssertionError(f"the {label} did not run the fused phase "
                             f"chain alone: {launches}")


@contextlib.contextmanager
def plain_phase():
    """The qs_phase_frac wrapper runs its plain version inside the block,
    on any device: with the plain component delays, the phase chain is
    then the plain composition with no kernel."""
    from pint_tpu_torch.kernels import qs_phase

    real = qs_phase.run
    qs_phase.run = lambda s, a, b, c: s.plain(a, b, c)
    try:
        yield
    finally:
        qs_phase.run = real


def check_delay_chain(torch, label: str, model, fitter, rec: dict):
    """delay_chain against the plain component delays on one path's
    full-width model and TOAs: the delay, every jacfwd column, and for a
    DD binary E against the kepler_E kernel on the kernel's own M, e."""
    from pint_tpu_torch.kernels import delay_chain as dc
    from pint_tpu_torch.kernels.kepler import kepler_E_op

    r = fitter.resids
    p, b, calc = r.pdict, r.batch, model.calc
    names = fitter.fit_params
    x0 = model.x0(p, names).to(b.device)
    with torch.no_grad():
        k = calc.delay(p, b)
        plain = calc.delay_plain(p, b)
    err = float(torch.max(torch.abs(k - plain)))
    Jk = torch.func.jacfwd(lambda x: calc.delay(
        model.with_x(p, x, names), b))(x0)
    Jp = torch.func.jacfwd(lambda x: calc.delay_plain(
        model.with_x(p, x, names), b))(x0)
    scale = torch.amax(torch.abs(Jp), dim=0)
    per_col = torch.amax(torch.abs(Jk - Jp), dim=0) / torch.where(
        scale > 0, scale, 1.0)
    worst = int(torch.argmax(per_col))
    out = {"ntoas": b.ntoas, "theta_slots": calc.chain_layout.P,
           "max_abs_delay_err_s": err,
           "delay_bit_equal": bool(torch.equal(k, plain)),
           "max_rel_column_err": float(per_col[worst]),
           "worst_column": names[worst]}
    if calc.chain_layout.cfg[1] in dc.DD_FAMILY:
        _, aux = chain_aux(calc, p, b)
        out["E_bit_equal_to_kepler_E"] = bool(torch.equal(
            kepler_E_op(aux[0].contiguous(), aux[1].contiguous()), aux[2]))
    # every lanes-per-thread against the single-lane kernel on random
    # tangents of two θ sets, a ragged last lane block included
    lay, rows, _, thetas, _ = chain_inputs(torch, model, fitter, 2)
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    equal = {}
    for K in LANE_COUNTS + (lay.P,):
        dth = torch.randn(2, K, lay.P, generator=gen,
                          dtype=torch.float64).to(b.device)
        one = dc.run(lay, thetas, dth, rows, lanes=1)
        equal[str(K)] = all(
            torch.equal(dc.run(lay, thetas, dth, rows, lanes=L), one)
            for L in dc.KERNEL_LANES[1:])
    out["lanes_bit_equal_to_single_lane"] = equal
    rec[label] = out
    if not (err <= DELAY_TOL_S and out["max_rel_column_err"] <= COLUMN_TOL
            and out.get("E_bit_equal_to_kepler_E", True)
            and all(equal.values())):
        raise AssertionError(f"delay_chain vs plain on {label}: {out}")
    return err


def chain_inputs(torch, model, fitter, points: int = 1):
    """The delay_chain kernel's inputs on one path at full width: its
    layout and rows, ``points`` fit points (the fitter's, then points a
    hair away, as a grid's), their θ sets (points, P), and the θ tangents
    of the fit parameters, (P, n_fit): one jacfwd lane each."""
    from pint_tpu_torch.kernels import delay_chain as dc

    r = fitter.resids
    p, b, lay = r.pdict, r.batch, model.calc.chain_layout
    names = fitter.fit_params
    rows = [t.contiguous() for t in dc.row_inputs(lay, p, b)]
    x0 = model.x0(p, names).to(b.device)
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    X = x0 + 1e-9 * torch.randn(points, len(names), generator=gen,
                                dtype=torch.float64).to(b.device)
    X[0] = x0
    with torch.no_grad():
        thetas = torch.stack([lay.theta(model.with_x(p, x, names))
                              for x in X])
    T = torch.func.jacfwd(lambda x: lay.theta(model.with_x(p, x, names)))(x0)
    return lay, rows, X, thetas, T


#: what count_ops counts besides the four arithmetic operations
CHAIN_EXTRA_OPS = ("sin", "cos", "log", "sqrt", "atan2", "floor", "clamp",
                   "pow", "exp", "isfinite", "acos", "asin", "abs")


def tangent_counts(torch, model, fitter, params, lanes: int) -> dict:
    """count_ops of the plain delay's ``jvp`` on one path's rows under
    ``vmap`` over ``lanes`` tangents (0: the delay alone), in which only
    ``params`` carry a tangent (the others' are never formed, as if
    exactly-zero tangents were skipped).  The binary's t - epoch tangent
    is counted as the kernel forms it, d dt = d shift = -d delay - 86400
    d epoch, and not through the quad-single words that the plain ``jvp``
    carries it in."""
    from pint_tpu_torch.models import binary_dd, binary_ell1, spindown
    from pint_tpu_torch.models.timing_model import mjd_parts

    r = fitter.resids
    p, b, calc = r.pdict, r.batch, model.calc
    x0 = model.x0(p, params).to(b.device)
    real_dt = spindown.dt_seconds_qs

    def analytic_dt(p_, batch, delay, epoch_name):
        # counts the shift, whose tangent is the kernel's d dt, and not the
        # quad-single words (the value and tangent returned are the plain's)
        _, _, ddays = mjd_parts(p_, epoch_name)
        shift = -delay - ddays * spindown.SECS_PER_DAY  # noqa: F841
        with uncounted():
            return real_dt(p_, batch, delay, epoch_name)

    def f(x):
        return calc.delay_plain(model.with_x(p, x, params), b)

    V = torch.ones(lanes, len(params), dtype=torch.float64, device=b.device)
    fn = (lambda: f(x0)) if lanes == 0 else (lambda: torch.func.vmap(
        lambda v: torch.func.jvp(f, (x0,), (v,))[1])(V))
    binary_dd.dt_seconds_qs = binary_ell1.dt_seconds_qs = analytic_dt
    try:
        with torch.no_grad():
            return count_ops(torch, fn, CHAIN_EXTRA_OPS)
    finally:
        binary_dd.dt_seconds_qs = binary_ell1.dt_seconds_qs = real_dt


def lane_ops(torch, model, fitter, params) -> dict:
    """What one more tangent lane adds to the plain ``jvp`` in which only
    ``params`` carry tangents: c(2) - c(1) of :func:`tangent_counts`."""
    c1, c2 = (tangent_counts(torch, model, fitter, params, k) for k in (1, 2))
    return {dt: n - c1.get(dt, 0) for dt, n in c2.items()
            if n - c1.get(dt, 0) > 0}


def chain_ops(torch, model, fitter):
    """The arithmetic the delay chain needs on one path's rows, by result
    dtype, counted from the plain version.  ``primal``: once per θ set
    and row, its Kepler solve counted through the plain kepler_E.
    ``shared``: the tangents' work that no lane owns (each
    transcendental's derivative factor: cos x of sin x, the square root's
    2 sqrt x, the atan2 denominator, the Kepler solve's sin E and
    1 / (1 - e cos E)), once per θ set and row.  ``lane``: what one more
    tangent lane adds (:func:`lane_ops`).  The derivative factors stay
    unbatched under ``vmap``: shared = c(1) - c(0) - lane."""
    from pint_tpu_torch.models import binary_dd
    from pint_tpu_torch.models.binary_orbits import kepler_E

    r = fitter.resids
    p, b, calc = r.pdict, r.batch, model.calc
    names = fitter.fit_params
    real_E = binary_dd.kepler_E_op
    binary_dd.kepler_E_op = kepler_E
    try:
        with torch.no_grad():
            primal = count_ops(torch, lambda: calc.delay_plain(p, b),
                               CHAIN_EXTRA_OPS)
    finally:
        binary_dd.kepler_E_op = real_E
    c0, c1 = (tangent_counts(torch, model, fitter, names, k) for k in (0, 1))
    lane = lane_ops(torch, model, fitter, names)
    shared = {dt: n - c0.get(dt, 0) - lane.get(dt, 0)
              for dt, n in c1.items()
              if n - c0.get(dt, 0) - lane.get(dt, 0) > 0}
    return primal, shared, lane


def lane_ops_zeros_skipped(torch, model, fitter, params) -> float:
    """A lane's float64 operations, averaged over ``params``, were the
    exactly-zero tangents skipped: each family of parameters (DMX_0001,
    DMX_0002, ... is one) carrying tangents alone, as a lane block of
    that family would (the lanes of a jacfwd are in parameter order)."""
    import re

    fams = {}
    for n in params:
        fams.setdefault(re.sub(r"_?\d+$", "", n), []).append(n)
    return sum(len(ns) * lane_ops(torch, model, fitter, ns).get("float64", 0)
               for ns in fams.values()) / len(params)


def chain_bound(ops, G: int, K: int, N: int, P: int, row_bytes: int) -> dict:
    """The least time of one launch over G θ sets and N rows: the primal
    (K = 0) or K tangent lanes per θ set.  Operations (``ops`` as
    :func:`chain_ops` returns them): the primal once per θ set and row,
    and with tangents the shared derivative factors once per θ set and
    row and each lane's own tangent; bytes: the rows, θ and its tangents
    read once, the output written once."""
    primal, shared, lane = ops
    total = {}
    for part, times in ((primal, G), (shared, G if K else 0),
                        (lane, G * K)):
        for dt, n in part.items():
            total[dt] = total.get(dt, 0) + times * n
    t_ops = ops_seconds(total)
    nbytes = row_bytes + 8 * G * P * (1 + K) + 8 * G * max(K, 1) * N
    t_bytes = nbytes / MEM_BYTES_PER_S
    return dict(ops=total, bytes=nbytes, ops_ms=1e3 * t_ops,
                bytes_ms=1e3 * t_bytes, bound_ms=1e3 * max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes")


def mean_or_none(xs):
    return None if any(x is None for x in xs) else sum(xs) / len(xs)


def time_delay_chain(torch, model, fitter, points: int, rec: dict) -> None:
    """The delay_chain kernel's device time at one path's shapes, over
    ``points`` θ sets: the primal launch, and the tangent launch at the
    lane counts of the path's jacfwds (its nonlinear and its linear fit
    parameters) at every lanes-per-thread, taken in turns (1, 2, 4, 4, 2,
    1) in this call; each launch's least time on this card, its
    reach of it; the plain version's time of the primal."""
    from pint_tpu_torch.kernels import delay_chain as dc

    r = fitter.resids
    p, b, calc = r.pdict, r.batch, model.calc
    lay, rows, X, thetas, T = chain_inputs(torch, model, fitter, points)
    names = fitter.fit_params
    lin, nl = model.partition_linear_params(names)
    ops = chain_ops(torch, model, fitter)
    row_bytes = sum(t.numel() * t.element_size() for t in rows)
    N, P = b.ntoas, lay.P
    # a thread of L lanes does the primal and the shared factors once and
    # each lane's tangent L times: by the counts (float32 at its own
    # rate), the most that L lanes per thread save against L = 1
    row_s, lane_s = ops_seconds(ops[0]) + ops_seconds(ops[1]), \
        ops_seconds(ops[2])
    rec.update(theta_sets=points, ntoas=N, theta_slots=P,
               ops_primal_per_theta_set=ops[0],
               ops_shared_per_theta_set=ops[1],
               ops_per_tangent_lane=ops[2],
               speedup_vs_single_lane_by_ops={
                   **{str(L): (row_s + lane_s) / (row_s / L + lane_s)
                      for L in dc.KERNEL_LANES[1:]},
                   "unbounded": (row_s + lane_s) / lane_s})

    def primal():
        return dc.run(lay, thetas, None, rows)

    ms = device_kernel_ms(torch, primal, "delay_chain_primal")
    bound = chain_bound(ops, points, 0, N, P, row_bytes)
    with torch.no_grad():
        if points == 1:
            plain = lambda: calc.delay_plain(p, b)  # noqa: E731
        else:
            plain = lambda: torch.func.vmap(  # noqa: E731
                lambda x: calc.delay_plain(model.with_x(p, x, names), b))(X)
        plain_ms = time_ms(torch, plain, reps=5)
    rec["primal"] = dict(device_ms=ms, call_ms=time_ms(torch, primal),
                         plain_ms=plain_ms, **bound,
                         reach=None if ms is None else bound["bound_ms"] / ms)
    order = dc.KERNEL_LANES + dc.KERNEL_LANES[::-1]
    rec["tangent"] = {}
    for label, params in (("nonlinear", nl), ("linear", lin)):
        idx = [names.index(n) for n in params]
        K = len(idx)
        dth = T[:, idx].T.contiguous().expand(points, K, P).contiguous()
        times = {str(L): [] for L in dc.KERNEL_LANES}
        for L in order:
            times[str(L)].append(device_kernel_ms(
                torch, lambda: dc.run(lay, thetas, dth, rows, lanes=L),
                "delay_chain_tangent"))
        mean = {L: mean_or_none(t) for L, t in times.items()}
        L = dc.lanes_per_thread(points, K)
        new = mean[str(L)]
        one = mean["1"]
        tb = chain_bound(ops, points, K, N, P, row_bytes)
        # the launch's time as rows / L x (primal + shared) + lanes x a
        # lane's tangent, from L = 2 and 4: the lanes' share, and what
        # L = 1 would take against the lanes' share alone
        t2, t4 = mean["2"], mean["4"]
        lanes_ms = None if None in (t2, t4) else 2.0 * t4 - t2
        rec["tangent"][str(K)] = dict(
            params=label, lanes=K, device_ms_by_lanes_per_thread=times,
            lanes_per_thread=L, ms=new, single_lane_ms=one,
            speedup_vs_single_lane=None if None in (new, one) else one / new,
            **tb, reach=None if new is None else tb["bound_ms"] / new,
            single_lane_reach=None if one is None else tb["bound_ms"] / one,
            ops_per_lane_zero_tangents_skipped={"float64": (
                lane_ops_zeros_skipped(torch, model, fitter, params))},
            lanes_share_ms_at_L4=lanes_ms,
            speedup_vs_single_lane_unbounded_by_time=None
            if one is None or not lanes_ms or lanes_ms <= 0
            else one / lanes_ms)


def tangent_vs_plain(torch, model, fitter, points: int, rec: dict) -> None:
    """The grid's tangents as a user's code reaches them: ``vmap`` over
    ``points`` fit points of the ``jvp`` of ``PhaseCalc.delay`` along the
    linear fit parameters (one tangent launch of points x lanes), against
    the same of the plain version: max abs and relative error, the
    launches, the plain version's time."""
    r = fitter.resids
    p, b, calc = r.pdict, r.batch, model.calc
    _, _, X, _, _ = chain_inputs(torch, model, fitter, points)
    names = fitter.fit_params
    lin, _ = model.partition_linear_params(names)
    E = torch.eye(len(names), dtype=torch.float64,
                  device=b.device)[[names.index(n) for n in lin]]

    def lanes(delay):
        def f(x):
            return delay(model.with_x(p, x, names), b)
        return lambda: torch.func.vmap(lambda x: torch.func.vmap(
            lambda v: torch.func.jvp(f, (x,), (v,))[1])(E))(X)

    with torch.no_grad():
        before = counts()
        k = lanes(calc.delay)()
        after = counts()
        plain = lanes(calc.delay_plain)
        want = plain()
        err = torch.abs(k - want)
        scale = torch.amax(torch.abs(want), dim=-1, keepdim=True)
        rec.update(theta_sets=points, lanes=len(lin),
                   launches={k_: after[k_] - before[k_] for k_ in (
                       "delay_chain_primal", "delay_chain_tangent")},
                   max_abs_err=float(torch.max(err)),
                   max_rel_column_err=float(torch.max(
                       torch.amax(err, dim=-1, keepdim=True)
                       / torch.where(scale > 0, scale, 1.0))),
                   plain_ms=time_ms(torch, plain, reps=3))
    if not rec["max_rel_column_err"] <= COLUMN_TOL:
        raise AssertionError(f"delay_chain tangent vs plain jvp: {rec}")


def chain_registers(build_log: str, kernel: str = "delay_chain") -> dict:
    """ptxas's registers, stack and spills of every delay_chain (or
    phase_chain) kernel (nvcc -Xptxas=-v), by kernel: primal/tangent,
    binary family, lanes per thread."""
    import re

    fams = {"0": "none", "1": "ELL1", "2": "DD", "3": "DDK", "4": "DDTM2",
            "5": "ELL1H", "6": "ELL1K"}
    # the same families with the DM family's terms (csrc kDMFamily = 8),
    # and with the DM and the chromatic family's (kChromFamily = 16)
    base = dict(fams)
    fams.update({str(int(k) + 8): f"{v}+DM" for k, v in base.items()})
    fams.update({str(int(k) + 24): f"{v}+DM+CHROM" for k, v in base.items()})
    # and with the orbit family's too (kOrbitFamily = 32)
    fams.update({str(int(k) + 56): f"{v}+DM+CHROM+ORB"
                 for k, v in base.items()})
    out, cur = {}, None
    for line in build_log.splitlines():
        if "Function properties for" in line or "Compiling entry" in line:
            # a kernel of ours, or another function (a libdevice callee)
            m = re.search(kernel + r"_(primal|tangent_lanes|tangent)"
                          r"ILi(\d+)E(?:Li(\d)E)?", line)
            cur = None if m is None else out.setdefault(
                f"{fams[m.group(2)]}/" + ("primal" if m.group(1) == "primal"
                                          else f"tangent_L{m.group(3) or 1}"),
                {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            cur.update(stack_bytes=int(m.group(1)),
                       spill_store_bytes=int(m.group(2)),
                       spill_load_bytes=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
    return out


def fused_points(torch, model, fitter, X, mode: str = "nearest", pn=None):
    """The fused launch's inputs at the fit points ``X``: its spec, θ
    (points, P), other (points, N) and tensors (with the pulse numbers
    ``pn`` in the use_pulse_numbers mode)."""
    from pint_tpu_torch.kernels import delay_chain as dc
    from pint_tpu_torch.kernels import phase_chain as pc

    r = fitter.resids
    p, b, names = r.pdict, r.batch, fitter.fit_params
    with torch.no_grad():
        ins = [pc.fused_inputs(model.calc, model.with_x(p, x, names), b,
                               mode) for x in X]
    spec, _, _, tensors = ins[0]
    if pn is not None:
        tensors = list(tensors)
        tensors[len(dc.ROWS)] = pn
    others = [o for _, _, o, _ in ins]
    return (spec, torch.stack([t for _, t, _, _ in ins]),
            None if others[0] is None else torch.stack(others), tensors)


def unfused_points(torch, model, fitter, X, mode: str = "nearest",
                   pn=None, delay=None):
    """The unfused chain's qs_phase_frac inputs at the fit points ``X``:
    (spec, shift (points, N), dF (points, K), other (points, N)), the
    delay by ``delay`` (by default the delay_chain kernel)."""
    import dataclasses

    from pint_tpu_torch.kernels import phase_chain as pc

    r = fitter.resids
    p, b, names, calc = r.pdict, r.batch, fitter.fit_params, model.calc
    with torch.no_grad():
        ins = [pc.unfused_inputs(calc, model.with_x(p, x, names), b, mode,
                                 delay=calc.delay if delay is None
                                 else delay) for x in X]
    spec = ins[0][0]
    if pn is not None:
        spec = dataclasses.replace(spec, pulse_number=pn)
    stack = [None if ins[0][i] is None else
             torch.stack([v[i] for v in ins]) for i in (1, 2, 3)]
    return (spec, *stack)


def check_phase_chain(torch, label: str, model, fitter, rec: dict):
    """phase_chain against the unfused card chain (the delay_chain kernel,
    PyTorch's shift, qs_phase_frac and its tangent rule) on one path's
    full-width model and TOAs, and against the plain composition: the
    primal at 9 θ sets in two modes, the TZR words, the tangents through
    jvp at several lane counts, the grid's vmap of a jacfwd, every
    lanes-per-thread against the single-lane launch.  frac is held within
    FRAC_TOL_CYCLES of K3's plain version on the delay_chain kernel's
    delay, and within F0 x DELAY_TOL_S (the delay chain's bar against the
    plain delays, carried into the phase) of the plain composition.
    Returns frac's largest gap to the plain composition [cycles]."""
    import numpy as np

    from pint_tpu_torch.kernels import delay_chain as dc
    from pint_tpu_torch.kernels import phase_chain as pc
    from pint_tpu_torch.kernels import qs_phase

    r = fitter.resids
    p, b, calc = r.pdict, r.batch, model.calc
    dev, N = b.device, b.ntoas
    names = fitter.fit_params
    _, _, X, _, _ = chain_inputs(torch, model, fitter, GRID_POINTS)
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    f64 = torch.float64
    pn = torch.round(torch.rand(N, generator=gen, dtype=f64) * 2e9
                     - 1e9).to(dev)
    pn[::17] = float("nan")
    out = {"ntoas": N, "theta_sets": GRID_POINTS}
    # the primal of one launch over 9 θ sets, at each point
    primal = {}
    for mode in ("nearest", "use_pulse_numbers"):
        mpn = pn if mode == "use_pulse_numbers" else None
        spec, thetas, others, tensors = fused_points(torch, model, fitter,
                                                     X, mode, mpn)
        with torch.no_grad():
            fused = pc.run(spec, thetas, others, tensors)
            want = qs_phase.run(*unfused_points(torch, model, fitter, X,
                                                mode, mpn))
        primal[mode] = {name: bool(torch.equal(a, w)) for name, a, w in
                        zip(("out", "slope", "dt64"), fused, want)}
    out["theta_slots"] = spec.P
    out["primal_bit_equal_to_unfused"] = primal
    # the TZR words on the 1-row TZR batch
    ptzr = tzr_pdict(torch, np, model, p, dev)
    with torch.no_grad():
        kw = pc.fused(calc, ptzr, model.tzr_batch, "words",
                      subtract_tzr=False)
        uw = pc.unfused(calc, ptzr, model.tzr_batch, "words",
                        subtract_tzr=False, delay=calc.delay)
    out["tzr_words_bit_equal_to_unfused"] = bool(torch.equal(kw, uw))
    out["tzr_words_match_pdict"] = bool(
        torch.equal(kw[0], p["const"]["__tzrphase__"]))
    # the plain composition
    x0 = model.x0(p, names).to(dev)

    def at(x):
        return model.with_x(p, x, names)

    def fused_f(x):
        return pc.fused(calc, at(x), b, "nearest")

    def unfused_f(x):
        return pc.unfused(calc, at(x), b, "nearest", delay=calc.delay)

    def plain_f(x):
        return pc.unfused(calc, at(x), b, "nearest")

    with torch.no_grad():
        frac = fused_f(x0)
        # the plain phase on the delay_chain kernel's delay (K3's plain
        # version), and the plain composition (the components' own
        # delays, which the delay chain meets within DELAY_TOL_S on the
        # card, not to the bit: CUDA's libm)
        qspec, shift, dF, other = pc.unfused_inputs(calc, p, b, "nearest",
                                                    delay=calc.delay)
        phase_err = float(torch.max(torch.abs(
            frac - qspec.plain(shift, dF, other)[0])))
        with plain_phase():
            frac_err = float(torch.max(torch.abs(frac - plain_f(x0))))
    frac_bar = float(model.F0.value) * DELAY_TOL_S
    # tangents through the transforms along random fit-parameter
    # directions: one primal and one tangent launch per jvp over K lanes
    tangents, launches = {}, {}
    for K in LANE_COUNTS + (len(names),):
        V = torch.randn(K, len(names), generator=gen, dtype=f64).to(dev)

        def along(fn):
            return torch.func.vmap(lambda v: torch.func.jvp(
                fn, (x0,), (v,))[1])(V)

        before = counts()
        kf = along(fused_f)
        after = counts()
        launches[str(K)] = [after[k] - before[k] for k in ON_PATHS]
        tangents[str(K)] = bool(torch.equal(kf, along(unfused_f)))
    out["tangents_bit_equal_to_unfused"] = tangents
    out["tangent_launches"] = launches
    # the grid's shape: a vmap over 9 points of a jacfwd
    before = counts()
    Jf = torch.func.vmap(torch.func.jacfwd(fused_f))(X)
    after = counts()
    out["grid_jacfwd_launches"] = [after[k] - before[k] for k in ON_PATHS]
    out["grid_jacfwd_bit_equal_to_unfused"] = bool(torch.equal(
        Jf, torch.func.vmap(torch.func.jacfwd(unfused_f))(X)))
    with plain_phase():
        Jp = torch.func.jacfwd(plain_f)(x0)
    scale = torch.amax(torch.abs(Jp), dim=0)
    per_col = torch.amax(torch.abs(Jf[0] - Jp), dim=0) / torch.where(
        scale > 0, scale, 1.0)
    worst = int(torch.argmax(per_col))
    # every lanes-per-thread against the single-lane launch, on random
    # tangents of θ and of other at two θ sets
    spec, thetas, others, tensors = fused_points(torch, model, fitter, X[:2])
    with torch.no_grad():
        _, slope, dt64 = pc.run(spec, thetas, others, tensors)
    equal = {}
    for K in LANE_COUNTS + (spec.P,):
        dth = torch.randn(2, K, spec.P, generator=gen, dtype=f64).to(dev)
        dot = torch.randn(2, K, N, generator=gen, dtype=f64).to(dev)
        one = pc.run(spec, thetas, None, tensors, dth, slope, dt64,
                              dot, lanes=1)
        equal[str(K)] = all(
            torch.equal(pc.run(spec, thetas, None, tensors, dth,
                                        slope, dt64, dot, lanes=L), one)
            for L in dc.KERNEL_LANES[1:])
    out.update(lanes_bit_equal_to_single_lane=equal,
               max_abs_frac_err_vs_plain_phase=phase_err,
               max_abs_frac_err_vs_plain=frac_err,
               frac_bar_vs_plain_cycles=frac_bar,
               max_rel_column_err_vs_plain=float(per_col[worst]),
               worst_column=names[worst])
    rec[label] = out
    ok = (all(all(v.values()) for v in primal.values())
          and out["tzr_words_bit_equal_to_unfused"]
          and out["tzr_words_match_pdict"] and all(tangents.values())
          and all(v == [1, 1] for v in launches.values())
          and out["grid_jacfwd_launches"] == [1, 1]
          and out["grid_jacfwd_bit_equal_to_unfused"]
          and all(equal.values()) and phase_err <= FRAC_TOL_CYCLES
          and frac_err <= frac_bar
          and out["max_rel_column_err_vs_plain"] <= COLUMN_TOL)
    if not ok:
        raise AssertionError(f"phase_chain vs unfused on {label}: {out}")
    return frac_err


def first_time(rec: dict) -> float:
    """A launch's device time from the profiler, or, where no trace held
    its events, its call's time by CUDA events."""
    return rec["device_ms"] if rec["device_ms"] is not None \
        else rec["fused_chain_ms"]


def in_turns(torch, fns: dict, reps: int = 25) -> dict:
    """Median CUDA-event milliseconds of each of ``fns`` (name -> call),
    taken in turns a, b, b, a and averaged."""
    names = list(fns) + list(fns)[::-1]
    times = {n: [] for n in fns}
    for n in names:
        times[n].append(time_ms(torch, fns[n], reps))
    return {n: sum(t) / len(t) for n, t in times.items()}


def time_phase_chain(torch, model, fitter, points: int, rec: dict,
                     sets=("nonlinear", "linear")) -> None:
    """The fused launches' times at one path's shapes over ``points`` θ
    sets, against the unfused chain they replace: the primal (the
    delay_chain primal launch, PyTorch's shift, qs_phase_frac) and the
    tangent at the lane counts of the path's jacfwds (``sets``: its
    nonlinear, linear or all fit parameters; the delay_chain tangent
    launch, the shift's forward rule and QSPhaseFrac.jvp's arithmetic),
    each whole chain timed with CUDA events in turns; the fused kernels'
    device times (the tangent's at every lanes-per-thread too, in turns
    1, 2, 4, 4, 2, 1); each launch's least time on this card (the
    delay chain's counts plus the phase's, as the plain version
    dispatches them) and its reach; the plain composition's times."""
    from pint_tpu_torch.kernels import delay_chain as dc
    from pint_tpu_torch.kernels import phase_chain as pc
    from pint_tpu_torch.kernels import qs_phase

    r = fitter.resids
    p, b, calc = r.pdict, r.batch, model.calc
    names = fitter.fit_params
    lin, nl = model.partition_linear_params(names)
    _, _, X, _, _ = chain_inputs(torch, model, fitter, points)
    spec, thetas, others, tensors = fused_points(torch, model, fitter, X)
    qspec, shift, dF, other = unfused_points(torch, model, fitter, X)
    lay, P4, Ks = spec.layout, spec.layout.P, spec.K
    o_spin, o_pep = P4, P4 + Ks
    rows = tensors[:len(dc.ROWS)]
    theta4 = thetas[:, :P4].contiguous()
    N, P = b.ntoas, spec.P
    ops = chain_ops(torch, model, fitter)
    with torch.no_grad():
        k3_ops = count_ops(torch, lambda: qspec.plain(shift, dF, other))
    row_bytes = sum(t.numel() * t.element_size() for t in rows)
    const_bytes = sum(t.numel() * t.element_size()
                      for t in tensors[len(dc.ROWS):] if t is not None)
    other_bytes = 0 if others is None else 8 * points * N

    def fused_primal():
        return pc.run(spec, thetas, others, tensors)

    def unfused_primal():
        d = dc.run(lay, theta4, None, rows)
        sh = (-d) - (thetas[:, o_pep, None] * 86400.0)
        return qs_phase.run(qspec, sh, thetas[:, o_spin:o_pep], others)

    def plain_primal():
        def f(x):
            return pc.unfused(calc, model.with_x(p, x, names), b, "nearest")
        with plain_phase():
            return torch.func.vmap(f)(X)

    with torch.no_grad():
        _, slope, dt64 = fused_primal()
        turns = in_turns(torch, {"fused": fused_primal,
                                 "unfused": unfused_primal})
        plain_ms = time_ms(torch, plain_primal, reps=3)
    dev_ms = device_kernel_ms(torch, fused_primal, "phase_chain_primal")
    total = {dt: points * n for dt, n in ops[0].items()}
    for dt, n in k3_ops.items():
        total[dt] = total.get(dt, 0) + n
    t_ops = ops_seconds(total)
    nbytes = (row_bytes + const_bytes + 8 * points * P + other_bytes
              + 3 * 8 * points * N)
    t_bytes = nbytes / MEM_BYTES_PER_S
    rec.update(theta_sets=points, ntoas=N, theta_slots=P)
    rec["primal"] = dict(
        device_ms=dev_ms, fused_chain_ms=turns["fused"],
        unfused_chain_ms=turns["unfused"], plain_ms=plain_ms, ops=total,
        bytes=nbytes, ops_ms=1e3 * t_ops, bytes_ms=1e3 * t_bytes,
        bound_ms=1e3 * max(t_ops, t_bytes),
        bound_by="operations" if t_ops >= t_bytes else "bytes",
        reach=None if dev_ms is None else 1e3 * max(t_ops, t_bytes) / dev_ms)
    # the tangent, at the path's nonlinear and linear lane counts
    x0 = model.x0(p, names).to(b.device)
    Tf = torch.func.jacfwd(lambda x: pc.fused_inputs(
        calc, model.with_x(p, x, names), b, "nearest")[1])(x0)   # (P, n)
    rec["tangent"] = {}
    groups = {"nonlinear": nl, "linear": lin, "all": names}
    for label, params in ((g, groups[g]) for g in sets):
        idx = [names.index(n) for n in params]
        K = len(idx)
        E = torch.eye(len(names), dtype=torch.float64, device=b.device)[idx]
        dot = None
        if others is not None:
            with torch.no_grad():
                dot = torch.func.vmap(lambda v: torch.func.jvp(
                    lambda x: pc.fused_inputs(
                        calc, model.with_x(p, x, names), b, "nearest")[2],
                    (x0,), (v,))[1])(E)
            dot = dot.expand(points, K, N).contiguous()
        dth = Tf[:, idx].T.contiguous().expand(points, K, P).contiguous()
        dth4 = dth[..., :P4].contiguous()

        def fused_tangent():
            return pc.run(spec, thetas, None, tensors, dth, slope,
                                   dt64, dot)

        def rule(dd):
            # the shift's forward rule, then QSPhaseFrac.jvp's arithmetic
            dshift = (-dd) - (dth[..., o_pep, None] * 86400.0)
            out = torch.zeros_like(dt64)[:, None] + slope[:, None] * dshift
            pk = dt64[:, None]
            for k in range(Ks):
                out = out + pk * dth[..., o_spin + k, None]
                pk = pk * dt64[:, None] / (k + 2.0)
            return out if dot is None else out + dot

        def unfused_tangent():
            return rule(dc.run(lay, theta4, dth4, rows))

        def plain_tangent():
            def f(x):
                return pc.unfused(calc, model.with_x(p, x, names), b,
                                  "nearest")
            with plain_phase():
                return torch.func.vmap(lambda x: torch.func.vmap(
                    lambda v: torch.func.jvp(f, (x,), (v,))[1])(E))(X)

        with torch.no_grad():
            got = fused_tangent()
            want = plain_tangent()
            err = torch.abs(got - want)
            scale = torch.amax(torch.abs(want), dim=-1, keepdim=True)
            rel = float(torch.max(torch.amax(err, dim=-1, keepdim=True)
                                  / torch.where(scale > 0, scale, 1.0)))
            turns = in_turns(torch, {"fused": fused_tangent,
                                     "unfused": unfused_tangent})
            rule_ops = count_ops(torch, lambda: rule(
                torch.zeros(points, K, N, dtype=torch.float64,
                            device=b.device)))
            t_plain = time_ms(torch, plain_tangent, reps=3)
        ms = device_kernel_ms(torch, fused_tangent, "phase_chain_tangent")
        by_lanes = {str(L): [] for L in dc.KERNEL_LANES}
        for L in dc.KERNEL_LANES + dc.KERNEL_LANES[::-1]:
            by_lanes[str(L)].append(device_kernel_ms(
                torch, lambda: pc.run(spec, thetas, None, tensors, dth,
                                      slope, dt64, dot, lanes=L),
                "phase_chain_tangent"))
        tb = chain_bound(ops, points, K, N, P4, row_bytes)
        tot = dict(tb["ops"])
        for dt, n in rule_ops.items():
            tot[dt] = tot.get(dt, 0) + n
        t_ops = ops_seconds(tot)
        nbytes = (row_bytes + const_bytes + 8 * points * P * (1 + K)
                  + 16 * points * N + 8 * points * K * N
                  * (1 if dot is None else 2))
        t_bytes = nbytes / MEM_BYTES_PER_S
        bound = 1e3 * max(t_ops, t_bytes)
        rec["tangent"][str(K)] = dict(
            params=label, lanes=K,
            lanes_per_thread=dc.lanes_per_thread(points, K), device_ms=ms,
            device_ms_by_lanes_per_thread=by_lanes,
            fused_chain_ms=turns["fused"], unfused_chain_ms=turns["unfused"],
            plain_ms=t_plain, max_abs_err_vs_plain=float(torch.max(err)),
            max_rel_column_err_vs_plain=rel, ops=tot, bytes=nbytes,
            ops_ms=1e3 * t_ops, bytes_ms=1e3 * t_bytes, bound_ms=bound,
            bound_by="operations" if t_ops >= t_bytes else "bytes",
            reach=None if ms is None else bound / ms)
        if not rel <= COLUMN_TOL:
            raise AssertionError(f"phase_chain tangent vs plain: {rel}")


def gls_load(torch, tim: str, dmx_bins: int, perturb=None):
    """par + tim -> (model at the perturbed start, toas) of the GLS
    configuration, as a user loads them."""
    import warnings

    from pint_tpu_torch.examples import dd_noise_realistic_par
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.toa import get_TOAs

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        model = get_model(dd_noise_realistic_par(
            dmx_bins=dmx_bins).splitlines())
        toas = get_TOAs(tim, model=model)
    for name, d in (DD_PERTURB if perturb is None else perturb).items():
        model[name].value += d
    return model, toas


def gls_fit(torch, dev: str, model, toas):
    """A fresh ``GLSFitter`` on ``dev`` and its ``fit_toas(maxiter=3)``,
    timed around the fit with a synchronize."""
    import warnings

    from pint_tpu_torch.fitter import GLSFitter

    fitter = GLSFitter(toas, model, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        chi2 = fitter.fit_toas(maxiter=DD_MAXITER)
    torch.cuda.synchronize()
    return fitter, chi2, time.perf_counter() - t0


def variant_fitters(torch, run: Run, toas, dtoas):
    """``(label, model, WLSFitter)`` of every DD and ELL1 variant of the
    row function but the DDK path's own (``examples.variant_par``), on
    the full-width TOAs of the DD path (the DD family) or of the grid
    (the ELL1 family)."""
    import warnings

    from pint_tpu_torch.examples import VARIANTS, variant_par
    from pint_tpu_torch.fitter import WLSFitter
    from pint_tpu_torch.models import get_model

    out = []
    for kind in VARIANTS:
        if kind == "DDK_ECL":
            continue
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            m = get_model(variant_par(kind, dmx_bins=run.dmx_bins)
                          .splitlines())
        t = dtoas if kind.startswith("DD") else toas
        out.append((kind, m, WLSFitter(t, m, device=run.dev)))
    return out


def noise_load(torch, tim: str, dmx_bins: int, free=None):
    """par + tim -> (model at the noise fit's start, toas) of the
    noise-fitting configuration (``examples.dd_noise_fit_par``, the noise
    parameters of ``free`` free, all 11 by default), as a user loads
    them: the timing start moved by DD_PERTURB, the free noise
    parameters set to ``examples.NOISE_FIT_START``."""
    import warnings

    from pint_tpu_torch.examples import (NOISE_FIT_PARAMS, NOISE_FIT_START,
                                         dd_noise_fit_par)
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.toa import get_TOAs

    free = NOISE_FIT_PARAMS if free is None else free
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        model = get_model(dd_noise_fit_par(dmx_bins=dmx_bins,
                                           free=free).splitlines())
        toas = get_TOAs(tim, model=model)
    for name, d in DD_PERTURB.items():
        model[name].value += d
    for name in free:
        model[name].value = NOISE_FIT_START[name]
    return model, toas


def timed_fit(torch, make, quiet: bool = True, **kw):
    """``make()`` -> a fitter, then its ``fit_toas(**kw)``, timed around
    both with a synchronize: ``(fitter, chi2, seconds)``.  ``quiet``
    drops the fit's warnings."""
    import warnings

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fitter = make()
    with warnings.catch_warnings():
        if quiet:
            warnings.simplefilter("ignore")
        chi2 = fitter.fit_toas(**kw)
    torch.cuda.synchronize()
    return fitter, chi2, time.perf_counter() - t0


@contextlib.contextmanager
def no_backward():
    """Counts the phase_chain kernel's reverse-mode calls inside the block
    (each would raise: the kernel has no reverse mode)."""
    from pint_tpu_torch.kernels.phase_chain import (PhaseChain,
                                                    PhaseChainTangent)

    count = {"calls": 0}
    real = {k: k.backward for k in (PhaseChain, PhaseChainTangent)}

    def counted(fn):
        def backward(ctx, *grads):
            count["calls"] += 1
            return fn(ctx, *grads)
        return staticmethod(backward)

    for k, fn in real.items():
        k.backward = counted(fn)
    try:
        yield count
    finally:
        for k, fn in real.items():
            k.backward = staticmethod(fn)


def noise_pulls(model, truth, names):
    """(value - injected) / uncertainty of each noise parameter with a
    finite uncertainty, None for the rest.  EQUAD and ECORR enter the
    likelihood squared, so their sign is not measured: |value| is held
    against the injected value."""
    out = {}
    for n in names:
        u = model[n].uncertainty
        v = float(model[n].value)
        if n.startswith(("EQUAD", "ECORR")):
            v = abs(v)
        out[n] = None if u is None or not math.isfinite(u) else \
            (v - float(truth[n].value)) / u
    return out


def lnlike_card_vs_cpu(torch, np, model, toas, fitter, names, x_start):
    """The noise likelihood and its gradient on the card against the
    CPU's plain evaluation of the same function, at the fitted point and
    at the fit's start (``x_start``, offsets from the fitted values), and
    the card's ms of one likelihood and one gradient (CUDA events) and of
    the likelihood's Cholesky alone.

    At the fitted point the gradient is what is left of terms of ~1e4
    after L-BFGS-B's stop (~1), so its gap is held against the gradient's
    norm at the start, where the terms do not cancel."""
    from pint_tpu_torch.fitter import _noise_grad, build_noise_lnlike
    from pint_tpu_torch.residuals import Residuals

    out = {}
    vals = {}
    for label, r in (("card", fitter.resids),
                     ("cpu", Residuals(toas, model, device="cpu"))):
        lnl = build_noise_lnlike(model, r.batch, names, r.track_mode)
        grad = _noise_grad(lnl)
        for where, x in (("fitted", np.zeros(len(names))),
                         ("start", np.asarray(x_start, np.float64))):
            xt = torch.as_tensor(x, device=r.device)
            with torch.no_grad():
                ll = float(lnl(xt, r.pdict))
            vals[label, where] = (ll, grad(xt, r.pdict).cpu().numpy())
        if label == "card":
            x = torch.zeros(len(names), dtype=torch.float64, device=r.device)
            with torch.no_grad():
                out["lnlike_ms"] = time_ms(torch, lambda: lnl(x, r.pdict),
                                           reps=5)
            out["grad_ms"] = time_ms(torch, lambda: grad(x, r.pdict),
                                     reps=5)
            # the likelihood's one factorization: the Cholesky of the
            # (K, K) inner matrix of the dense Woodbury form (K the noise
            # basis's columns)
            with torch.no_grad():
                sigma = model.scaled_toa_uncertainty(r.pdict, r.batch) * 1e-6
                U, phi = model.noise_basis(r.pdict), \
                    model.noise_weights(r.pdict)
                inner = (U.T / sigma**2) @ U + torch.diag(1.0 / phi)
                out["cholesky_ms"] = time_ms(
                    torch, lambda: torch.linalg.cholesky(inner), reps=5)
                out["cholesky_size"] = K = int(inner.shape[0])
                # the Woodbury Gram U^T N^-1 U: 2 N K^2 operations, U read
                # and the Gram written once; the Cholesky: K^3 / 3, the
                # matrix read and its factor written once
                out["gram_ms"] = time_ms(
                    torch, lambda: (U.T / sigma**2) @ U, reps=5)
                N = int(U.shape[0])
                out["gram_bound"] = least_time(2.0 * N * K * K,
                                               8.0 * (N * K + K * K))
                out["cholesky_bound"] = least_time(K**3 / 3.0,
                                                   16.0 * K * K)
    g_scale = float(np.linalg.norm(vals["cpu", "start"][1]))
    for where in ("fitted", "start"):
        (lc, gc), (lh, gh) = vals["card", where], vals["cpu", where]
        out[where] = dict(
            lnlike_card=lc, lnlike_cpu=lh, lnlike_rel_gap=abs(lc / lh - 1.0),
            grad_norm=float(np.linalg.norm(gh)),
            grad_gap_rel_own_norm=float(np.linalg.norm(gc - gh)
                                        / np.linalg.norm(gh)),
            grad_gap_rel_start_norm=float(np.linalg.norm(gc - gh) / g_scale),
            grad_cpu=gh.tolist())
    out["lnlike_rel_gap"] = max(out[w]["lnlike_rel_gap"]
                                for w in ("fitted", "start"))
    out["grad_rel_gap"] = max(out["fitted"]["grad_gap_rel_start_norm"],
                              out["start"]["grad_gap_rel_own_norm"])
    return out


def stored_gaps(model, values: dict, uncs: dict):
    """:func:`fit_gaps` of ``model`` against a stored fit, over its
    parameters with a stored uncertainty (pint_tpu leaves a noise
    parameter's unset where its direction is flat)."""
    names = [n for n, u in uncs.items() if u is not None]
    return fit_gaps(*fit_state(model, names), {n: values[n] for n in names},
                    {n: uncs[n] for n in names})


def nan_step(kern):
    """A WLS solve kernel returning NaN steps from finite inputs (what
    pint_tpu's ``faultinject.nan_wls_solver`` does to its own)."""
    def bad(M, r_sec, sigma_sec, threshold=None):
        dpars, Sigma_n, norms, n_bad = kern(M, r_sec, sigma_sec, threshold)
        return dpars * float("nan"), Sigma_n, norms, n_bad
    return bad


def fitter_paths(torch, np, run: Run, dd: dict, grid_ctx: dict) -> dict:
    """The fitters ``Fitter.auto`` picks, LM, Powell and the grid API on
    the card (phases auto_noise_fit ... grid_api, see the module
    docstring).  ``dd``: the DD path's truth, model, TOAs and start;
    ``grid_ctx``: the grid path's fitter and grid.  Returns each new
    path's launches and the library times for the kernel line."""
    import statistics
    import warnings

    from pint_tpu_torch import fitter as tfit
    from pint_tpu_torch.examples import (NOISE_FIT_PARAMS,
                                         simulate_dd_noise_fit)
    from pint_tpu_torch.fitter import (DownhillGLSFitter, DownhillWLSFitter,
                                       Fitter, LMFitter, PowellFitter,
                                       WLSFitter, damped_solve)
    from pint_tpu_torch.toa import write_tim

    out = {"launches": {}}

    # -- the noise-fitting path: Fitter.auto -> DownhillGLSFitter ----------
    with phase("auto_noise_fit", {}) as rec:
        t0 = time.perf_counter()
        ntruth, nsim = simulate_dd_noise_fit(
            ntoas=run.ntoas, seed=0, dmx_bins=run.dmx_bins, device=run.dev)
        torch.cuda.synchronize()
        rec["simulate_s"] = time.perf_counter() - t0
        os.makedirs(os.path.dirname(run.noise_tim), exist_ok=True)
        write_tim(run.noise_tim, nsim)
        t0 = time.perf_counter()
        nmodel, ntoas = noise_load(torch, run.noise_tim, run.dmx_bins)
        rec["setup_s"] = time.perf_counter() - t0
        nstart = snapshot(nmodel)
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        with plain_delays() as plain, no_backward() as back:
            nfit, nchi2, cold_s = timed_fit(
                torch, lambda: Fitter.auto(ntoas, nmodel, device=run.dev))
        noise_launches = counts()
        fr = nfit.fitresult
        names = nfit.fit_params
        noise = nfit.free_noise_params
        pulls = {n: device_offset(nmodel[n].device_value,
                                  ntruth[n].device_value)
                 / nmodel[n].device_uncertainty for n in DD_PULL_PARAMS}
        npulls = noise_pulls(nmodel, ntruth, noise)
        rec.update(fitter=type(nfit).__name__, ntoas=ntoas.ntoas,
                   n_fit=len(names), n_noise=len(noise),
                   status=fr.status.name, iterations=fr.iterations,
                   rung=fr.rung, chi2=nchi2, dof=fr.dof,
                   chi2_per_dof=nchi2 / fr.dof, fit_cold_s=cold_s,
                   launches=noise_launches,
                   plain_delay_chains=plain["calls"],
                   phase_chain_backward_calls=back["calls"], pulls=pulls,
                   noise={n: {"value": float(nmodel[n].value),
                              "uncertainty": nmodel[n].uncertainty,
                              "injected": float(ntruth[n].value),
                              "start": nstart[n]} for n in noise},
                   noise_pulls=npulls,
                   noise_fit_info=nfit.noise_fit_info,
                   lbfgsb_evaluations=[i["nfev"]
                                       for i in nfit.noise_fit_info],
                   peak_mem_bytes=torch.cuda.max_memory_allocated(),
                   device=str(nfit.device))
        walls, per_fit = [], []
        for _ in range(2):
            restore(nmodel, nstart)
            zero_counts()
            wf, _, w = timed_fit(
                torch, lambda: Fitter.auto(ntoas, nmodel, device=run.dev))
            walls.append(w)
            per_fit.append(counts())
        rec.update(noise_fit_warm_s=statistics.median(walls),
                   fit_walls_s=walls, launches_per_warm_fit=per_fit,
                   normality_ks=list(wf.resids.normality("ks")))
    if not isinstance(nfit, DownhillGLSFitter):
        raise AssertionError(f"Fitter.auto gave {type(nfit).__name__}")
    if ntoas.ntoas != run.ntoas or len(names) != run.nfit or \
            len(noise) != len(NOISE_FIT_PARAMS):
        raise AssertionError("not the full-width noise-fit configuration")
    if fr.status.name not in ("CONVERGED", "MAXITER"):
        raise AssertionError(f"noise fit ended {fr.status.name}")
    if not 0.6 < nchi2 / fr.dof < 1.6:
        raise AssertionError(f"noise fit chi2/dof {nchi2 / fr.dof}")
    bad = {n: v for n, v in pulls.items() if not abs(v) < PULL_MAX}
    bad.update({n: v for n, v in npulls.items()
                if v is not None and not abs(v) < PULL_MAX})
    if bad:
        raise AssertionError(f"noise fit pulls {bad}")
    if any(npulls[n] is None for n in noise
           if n.startswith(("EFAC", "ECORR"))):
        raise AssertionError(f"EFAC/ECORR without uncertainty: {npulls}")
    check_path_launches("noise-fit path", noise_launches)
    if plain["calls"] or back["calls"]:
        raise AssertionError(f"{plain['calls']} plain delay chains, "
                             f"{back['calls']} phase_chain backward calls")
    out["launches"]["noise_fit"] = noise_launches

    with phase("noise_fit_profile", {}) as rec:
        holder = {}

        def nsetup():
            restore(nmodel, nstart)
            holder["f"] = Fitter.auto(ntoas, nmodel, device=run.dev)
            torch.cuda.synchronize()

        rec.update(profile_grid(
            torch, lambda: holder["f"].fit_toas(), run.out_dir,
            out_name="noise_fit_profile", setup=nsetup))
        rec["lbfgsb_evaluations"] = [i["nfev"] for i in
                                     holder["f"].noise_fit_info]

    with phase("noise_lnlike_card_vs_cpu", {}) as rec:
        # at the fitted point (the model holds the last fit)
        rec.update(lnlike_card_vs_cpu(
            torch, np, nmodel, ntoas, holder["f"], noise,
            [nstart[n] - nmodel[n].value for n in noise]))
        out["cholesky"] = {k: rec[k] for k in (
            "cholesky_ms", "cholesky_size", "cholesky_bound", "gram_ms",
            "gram_bound")}
    if not (rec["lnlike_rel_gap"] <= LNLIKE_TOL
            and rec["grad_rel_gap"] <= LNLIKE_GRAD_TOL):
        raise AssertionError(
            f"noise lnlike card vs CPU: {rec['lnlike_rel_gap']}, gradient "
            f"{rec['grad_rel_gap']}")

    # -- the smaller phases on the DD path's TOAs ---------------------------
    dmodel, dtoas, truth, start = (dd[k] for k in
                                   ("model", "toas", "truth", "start"))
    with phase("auto_wls_fit", {}) as rec:
        restore(dmodel, start)
        zero_counts()
        wfit, wchi2, cold_s = timed_fit(
            torch, lambda: Fitter.auto(dtoas, dmodel, device=run.dev))
        wls_launches = counts()
        fr = wfit.fitresult
        pulls = {n: device_offset(dmodel[n].device_value,
                                  truth[n].device_value)
                 / dmodel[n].device_uncertainty for n in DD_PULL_PARAMS}
        wls_vals, wls_uncs = fit_state(dmodel, wfit.fit_params)
        restore(dmodel, start)
        zero_counts()
        _, _, warm_s = timed_fit(
            torch, lambda: Fitter.auto(dtoas, dmodel, device=run.dev))
        rec.update(fitter=type(wfit).__name__, status=fr.status.name,
                   iterations=fr.iterations, rung=fr.rung, chi2=wchi2,
                   chi2_per_dof=wchi2 / fr.dof, pulls=pulls,
                   fit_cold_s=cold_s, fit_warm_s=warm_s,
                   launches=wls_launches, launches_per_warm_fit=counts())
    if not isinstance(wfit, DownhillWLSFitter) or \
            isinstance(wfit, DownhillGLSFitter):
        raise AssertionError(f"Fitter.auto gave {type(wfit).__name__}")
    if fr.status.name != "CONVERGED" or not 0.6 < wchi2 / fr.dof < 1.6:
        raise AssertionError(f"downhill WLS fit {fr.status.name}, "
                             f"chi2/dof {wchi2 / fr.dof}")
    bad = {n: v for n, v in pulls.items() if not abs(v) < PULL_MAX}
    if bad:
        raise AssertionError(f"downhill WLS fit pulls {bad}")
    check_path_launches("downhill WLS path", wls_launches)
    out["launches"]["auto_wls_fit"] = wls_launches

    with phase("lm_fit", {}) as rec:
        restore(dmodel, start)
        zero_counts()
        lfit, lchi2, lm_s = timed_fit(
            torch, lambda: LMFitter(dtoas, dmodel, device=run.dev))
        lm_launches = counts()
        fr = lfit.fitresult
        lv, _ = fit_state(dmodel, lfit.fit_params)
        sig = max(abs(device_offset(lv[n], wls_vals[n])) / wls_uncs[n]
                  for n in lfit.fit_params)
        gap = abs(lchi2 / wchi2 - 1.0)
        # LM's one factorization per iteration, alone: the eigh of the
        # damped (P+1, P+1) normal matrix, at the fitted point
        asm = tfit.build_whitened_assembly(
            dmodel, lfit.resids.batch, lfit.fit_params, lfit.track_mode, True)
        with torch.no_grad():
            r, M, sigma, offc = asm.inline(torch.zeros(
                len(lfit.fit_params), dtype=torch.float64,
                device=lfit.device), lfit.resids.pdict)
            Mn = tfit._whiten_normalize(M, r, sigma)[0]
            A = Mn.T @ Mn
            A = A + 1e-3 * torch.diag(torch.diag(A))
            eigh_ms = time_ms(torch, lambda: torch.linalg.eigh(A), reps=10)
            solve_ms = time_ms(torch, lambda: damped_solve(
                r, M, sigma, offc, 1e-3, len(lfit.fit_params)), reps=10)
        # a symmetric eigendecomposition with its vectors: ~9 n^3
        # operations (tridiagonal QR), not on the tensor cores
        n = int(A.shape[0])
        eigh_bound = least_time(9.0 * n**3, 16.0 * n * n,
                                PEAK_OPS_PER_S["float64"])
        rec.update(status=fr.status.name, iterations=fr.iterations,
                   converged=fr.converged, chi2=lchi2, wls_chi2=wchi2,
                   chi2_rel_gap_vs_wls=gap, max_sigma_gap_vs_wls=sig,
                   fit_s=lm_s, launches=lm_launches, eigh_ms=eigh_ms,
                   eigh_size=n, eigh_bound=eigh_bound,
                   damped_solve_ms=solve_ms)
        out["eigh"] = {"eigh_ms": eigh_ms, "eigh_size": n,
                       "eigh_bound": eigh_bound}
    if not fr.converged or gap > CHI2_TOL or sig > LM_VS_WLS_SIGMA:
        raise AssertionError(f"LM fit: chi2 gap {gap}, {sig} sigma")
    check_path_launches("LM path", lm_launches)
    out["launches"]["lm_fit"] = lm_launches

    with phase("degraded_lm", {}) as rec:
        restore(dmodel, start)
        real = {k: getattr(tfit, k) for k in ("fit_wls_svd", "fit_wls_eigh")}
        zero_counts()
        try:
            for k, fn in real.items():
                setattr(tfit, k, nan_step(fn))
            with warnings.catch_warnings(record=True) as w:
                warnings.simplefilter("always")
                gfit, gchi2, deg_s = timed_fit(
                    torch, lambda: WLSFitter(dtoas, dmodel, device=run.dev),
                    quiet=False, maxiter=DD_MAXITER)
        finally:
            for k, fn in real.items():
                setattr(tfit, k, fn)
        deg_launches = counts()
        fr = gfit.fitresult
        statuses = dmodel.fit_provenance["rung_statuses"]
        gap = abs(gchi2 / lchi2 - 1.0)
        rec.update(rung=fr.rung, status=fr.status.name,
                   rung_statuses=statuses, chi2=gchi2, lm_chi2=lchi2,
                   chi2_rel_gap_vs_lm=gap, fit_s=deg_s,
                   degraded_warnings=sum(
                       type(x.message).__name__ == "FitDegradedWarning"
                       for x in w),
                   launches=deg_launches)
    if fr.rung != "lm" or statuses.get("fused") != "NONFINITE" or \
            statuses.get("eager") != "NONFINITE" or \
            statuses.get("lm") not in ("CONVERGED", "MAXITER") or \
            not math.isfinite(gchi2) or gap > CHI2_TOL:
        raise AssertionError(f"degraded chain: {statuses}, chi2 gap {gap}")
    out["launches"]["degraded_lm"] = deg_launches

    with phase("fitter_reference", {}) as rec:
        with open(FITTERS_REF_JSON) as f:
            ref = json.load(f)
        with open(NOISEFIT_REF_JSON) as f:
            nref = json.load(f)
        from pint_tpu_torch.kernels.phase_chain import PhaseChain
        worst = []
        for label, cls, tol in (("downhill_wls", DownhillWLSFitter,
                                 FIT_SIGMA_TOL),
                                ("lm", LMFitter, TRAJECTORY_SIGMA_TOL),
                                ("powell", PowellFitter,
                                 TRAJECTORY_SIGMA_TOL)):
            want = ref[label]
            rmodel, rtoas = dd_load(torch, DD_REF_TIM, REF_DMX_BINS,
                                    perturb=ref["perturb"])
            if label == "powell":
                for n in rmodel.free_params:
                    if n not in ref["powell_params"]:
                        rmodel[n].frozen = True
            PhaseChain.launches = 0
            rf, rchi2, rs = timed_fit(
                torch, lambda: cls(rtoas, rmodel, device=run.dev))
            sig, unc = stored_gaps(rmodel, want["values"],
                                   want["uncertainties"])
            gap = abs(rchi2 / want["chi2"] - 1.0)
            fr = rf.fitresult
            same = (fr.status.name, fr.rung, fr.converged) == (
                want["status"], want["rung"], want["converged"])
            rec[label] = dict(fit_params=len(rf.fit_params), chi2=rchi2,
                              chi2_ref=want["chi2"], max_rel_chi2_gap=gap,
                              max_sigma_gap=sig, max_unc_rel_gap=unc,
                              status=fr.status.name,
                              iterations=fr.iterations, fit_s=rs,
                              launches=PhaseChain.launches,
                              **({"chi2_evaluations":
                                  rf.fit_info["chi2_evaluations"]}
                                 if label == "powell" else {}))
            if rf.fit_params != want["fit_params"] or not same or not (
                    sig <= tol and unc <= UNC_TOL and gap <= CHI2_TOL
                    and PhaseChain.launches > 0):
                worst.append(label)
        rmodel, rtoas = noise_load(torch, NOISEFIT_REF_TIM, REF_DMX_BINS,
                                   free=nref["noise_params"])
        PhaseChain.launches = 0
        rf, rchi2, rs = timed_fit(
            torch, lambda: DownhillGLSFitter(rtoas, rmodel, device=run.dev))
        sig, unc = stored_gaps(rmodel, nref["values"],
                               nref["uncertainties"])
        nsig, nunc = stored_gaps(rmodel, nref["noise_values"],
                                 nref["noise_uncertainties"])
        gap = abs(rchi2 / nref["chi2"] - 1.0)
        fr = rf.fitresult
        rec["downhill_gls_noise"] = dict(
            chi2=rchi2, chi2_ref=nref["chi2"], max_rel_chi2_gap=gap,
            max_sigma_gap=sig, max_unc_rel_gap=unc,
            noise_max_sigma_gap=nsig, noise_max_unc_rel_gap=nunc,
            status=fr.status.name, fit_s=rs, launches=PhaseChain.launches,
            lbfgsb_evaluations=[i["nfev"] for i in rf.noise_fit_info])
        if rf.fit_params != nref["fit_params"] or (
                fr.status.name, fr.rung, fr.converged) != (
                nref["status"], nref["rung"], nref["converged"]) or not (
                sig <= FIT_SIGMA_TOL and unc <= UNC_TOL
                and gap <= NOISEFIT_CHI2_TOL and nsig <= NOISE_SIGMA_TOL
                and nunc <= NOISE_UNC_TOL and PhaseChain.launches > 0):
            worst.append("downhill_gls_noise")
        rec["powell_params"] = ref["powell_params"]
        rec["failed"] = worst
    if worst:
        raise AssertionError(f"fitter references failed: {worst}")

    # -- the grid API over the grid path's fitter ----------------------------
    from pint_tpu_torch.gridutils import (grid_chisq, grid_chisq_derived,
                                          grid_chisq_flat, tuple_chisq)

    def identity(i):
        return lambda *pt: pt[i]

    def wrappers(f, grid, m2, sini):
        pts = list(zip(grid["M2"], grid["SINI"]))
        return {"flat": grid_chisq_flat(f, grid, maxiter=2),
                "grid_chisq": grid_chisq(f, ["M2", "SINI"], [m2, sini])[0],
                "grid_chisq_derived": grid_chisq_derived(
                    f, ["M2", "SINI"], [identity(0), identity(1)],
                    [m2, sini])[0],
                "tuple_chisq": tuple_chisq(f, ["M2", "SINI"], pts)[0]}

    with phase("grid_api", {}) as rec:
        m2, sini = np.array(GRID_M2), np.array(GRID_SINI)
        zero_counts()
        got = wrappers(grid_ctx["fitter"], grid_ctx["grid"], m2, sini)
        rec["launches"] = counts()
        rec["bit_equal_to_flat"] = {
            k: bool(np.array_equal(np.ravel(v), got["flat"]))
            for k, v in got.items() if k != "flat"}
        with open(REF_JSON) as f:
            ref = json.load(f)
        _, _, rfit = load(torch, run.dev, REF_TIM, REF_DMX_BINS)
        rgrid = {k: np.asarray(v) for k, v in ref["grid"].items()}
        rgot = wrappers(rfit, rgrid, np.unique(rgrid["M2"]),
                        np.unique(rgrid["SINI"]))
        want = np.asarray(ref["chi2"])
        rec["reference_max_rel_gap"] = {
            k: float(np.max(np.abs(np.ravel(v) / want - 1.0)))
            for k, v in rgot.items()}
    if not all(rec["bit_equal_to_flat"].values()) or \
            max(rec["reference_max_rel_gap"].values()) > CHI2_TOL:
        raise AssertionError(f"grid API: {rec}")
    check_path_launches("grid API", rec["launches"])
    return out


def wb_load(torch, tim: str, dmx_bins: int, free=None, perturb=None):
    """par + tim -> (model at the wideband fit's start, toas) of the
    wideband configuration (``examples.wideband_nanograv_par``, the
    DMEFACs of ``free`` free, all three by default), as a user loads
    them: the timing start moved by DD_PERTURB, the DMJUMPs at zero and
    the free DMEFACs at 1 (``examples.WB_START``)."""
    import warnings

    from pint_tpu_torch.examples import (WB_NOISE_FREE, WB_START,
                                         wideband_nanograv_par)
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.toa import get_TOAs

    free = WB_NOISE_FREE if free is None else tuple(free)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        model = get_model(wideband_nanograv_par(dmx_bins=dmx_bins,
                                                free=free).splitlines())
        toas = get_TOAs(tim, model=model)
    for name, d in (DD_PERTURB if perturb is None else perturb).items():
        model[name].value += d
    for name, v in WB_START.items():
        if name.startswith("DMJUMP") or name in free:
            model[name].value = v
    return model, toas


def wideband_paths(torch, np, run: Run, ctx: dict) -> dict:
    """The wideband fit on the card and the DM family of the delay
    kernel's row function (phases wideband_main_path ... dm_family_chain,
    see the module docstring).  ``ctx``: the grid path's model and TOAs
    and the DD path's TOAs, on which the DM family's variants run.
    Returns the wideband fits' launches and the timing records."""
    import statistics
    import warnings

    from pint_tpu_torch.examples import (DM_FAMILY, WB_NOISE_FREE,
                                         dm_family_par,
                                         simulate_wideband_realistic)
    from pint_tpu_torch.fitter import (Fitter, WidebandDownhillFitter,
                                       WidebandLMFitter, WidebandTOAFitter,
                                       WLSFitter)
    from pint_tpu_torch.kernels import build as kbuild
    from pint_tpu_torch.kernels.phase_chain import PhaseChain
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.toa import write_tim

    out = {"launches": {}}

    with phase("wideband_main_path", {}) as rec:
        t0 = time.perf_counter()
        truth, sim = simulate_wideband_realistic(
            ntoas=run.ntoas, seed=0, dmx_bins=run.dmx_bins, device=run.dev)
        torch.cuda.synchronize()
        rec["simulate_s"] = time.perf_counter() - t0
        os.makedirs(os.path.dirname(run.wb_tim), exist_ok=True)
        write_tim(run.wb_tim, sim)
        t0 = time.perf_counter()
        model, toas = wb_load(torch, run.wb_tim, run.dmx_bins)
        rec["setup_s"] = time.perf_counter() - t0
        start = snapshot(model)
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        with plain_delays() as plain, no_backward() as back:
            fit, chi2, cold_s = timed_fit(
                torch, lambda: Fitter.auto(toas, model, device=run.dev))
        launches = counts()
        fr = fit.fitresult
        names, noise = fit.fit_params, fit.free_noise_params
        pulls = {n: device_offset(model[n].device_value,
                                  truth[n].device_value)
                 / model[n].device_uncertainty for n in WB_PULL_PARAMS}
        npulls = noise_pulls(model, truth, noise)
        wb = fit.resids
        rec.update(fitter=type(fit).__name__, ntoas=toas.ntoas,
                   dm_rows=len(wb.dm_index), n_fit=len(names),
                   n_noise=len(noise), status=fr.status.name,
                   iterations=fr.iterations, rung=fr.rung, chi2=chi2,
                   dof=fr.dof, chi2_per_dof=chi2 / fr.dof,
                   toa_chi2=wb.toa.calc_chi2(), dm_chi2=wb.calc_dm_chi2(),
                   fit_cold_s=cold_s, fit_info=fit.fit_info,
                   launches=launches, plain_delay_chains=plain["calls"],
                   phase_chain_backward_calls=back["calls"], pulls=pulls,
                   noise={n: {"value": float(model[n].value),
                              "uncertainty": model[n].uncertainty,
                              "injected": float(truth[n].value)}
                          for n in noise},
                   noise_pulls=npulls, noise_fit_info=fit.noise_fit_info,
                   noise_basis_shape=list(model.noise_basis(
                       wb.pdict).shape),
                   peak_mem_bytes=torch.cuda.max_memory_allocated(),
                   device=str(fit.device))
        walls, per_fit = [], []
        for _ in range(2):
            restore(model, start)
            zero_counts()
            _, _, w = timed_fit(
                torch, lambda: Fitter.auto(toas, model, device=run.dev))
            walls.append(w)
            per_fit.append(counts())
        rec.update(wb_fit_warm_s=statistics.median(walls),
                   fit_walls_s=walls, launches_per_warm_fit=per_fit)
        # the wideband GLS fit and LM on the same TOAs, from the start
        gls = {}
        walls = []
        for _ in range(4):
            restore(model, start)
            zero_counts()
            gf, gchi2, w = timed_fit(
                torch, lambda: WidebandTOAFitter(toas, model,
                                                 device=run.dev),
                maxiter=WB_MAXITER)
            walls.append(w)
            gls.setdefault("launches", counts())
        gls.update(status=gf.fitresult.status.name, chi2=gchi2,
                   chi2_per_dof=gchi2 / gf.fitresult.dof,
                   fit_cold_s=walls[0], fit_walls_s=walls[1:],
                   fit_info=gf.fit_info)
        rec["wideband_gls"] = gls
        rec["wb_gls_fit_warm_s"] = statistics.median(walls[1:])
        restore(model, start)
        zero_counts()
        lf, lchi2, lm_s = timed_fit(
            torch, lambda: WidebandLMFitter(toas, model, device=run.dev))
        rec["wideband_lm"] = dict(
            status=lf.fitresult.status.name, iterations=lf.fitresult.
            iterations, chi2=lchi2, fit_s=lm_s, launches=counts())
        out["launches"].update(wideband_fit=launches,
                               wideband_gls_fit=gls["launches"],
                               wideband_lm_fit=rec["wideband_lm"]["launches"])
    if not isinstance(fit, WidebandDownhillFitter):
        raise AssertionError(f"Fitter.auto gave {type(fit).__name__}")
    if toas.ntoas != run.ntoas or len(wb.dm_index) != run.ntoas or \
            len(names) != run.wb_nfit or len(noise) != len(WB_NOISE_FREE):
        raise AssertionError("not the full-width wideband configuration")
    if fr.status.name not in ("CONVERGED", "MAXITER"):
        raise AssertionError(f"wideband fit ended {fr.status.name}")
    if not 0.6 < chi2 / fr.dof < 1.6:
        raise AssertionError(f"wideband fit chi2/dof {chi2 / fr.dof}")
    bad = {n: v for n, v in {**pulls, **npulls}.items()
           if v is not None and not abs(v) < PULL_MAX}
    if bad or any(v is None for v in npulls.values()):
        raise AssertionError(f"wideband fit pulls {pulls}, {npulls}")
    for label, got in (("wideband fit", launches),
                       ("wideband GLS fit", gls["launches"])):
        check_path_launches(label, got)
    if plain["calls"] or back["calls"]:
        raise AssertionError(f"{plain['calls']} plain delay chains, "
                             f"{back['calls']} phase_chain backward calls")

    with phase("wideband_profile", {}) as rec:
        holder = {}

        def setup():
            restore(model, start)
            holder["f"] = Fitter.auto(toas, model, device=run.dev)
            torch.cuda.synchronize()

        rec.update(profile_grid(
            torch, lambda: holder["f"].fit_toas(), run.out_dir,
            out_name="wideband_profile", setup=setup))
        rec["lbfgsb_evaluations"] = [i["nfev"] for i in
                                     holder["f"].noise_fit_info]
        wfit = holder["f"]

    with phase("wideband_reference", {}) as rec:
        with open(WB_REF_JSON) as f:
            ref = json.load(f)
        failed = []
        for label, cls, free, tol, chi2_tol, kw in (
                ("wideband_gls", WidebandTOAFitter, (), FIT_SIGMA_TOL,
                 CHI2_TOL, {"maxiter": ref["maxiter"]}),
                ("wideband_downhill", WidebandDownhillFitter, WB_NOISE_FREE,
                 FIT_SIGMA_TOL, NOISEFIT_CHI2_TOL, {}),
                ("wideband_lm", WidebandLMFitter, (), TRAJECTORY_SIGMA_TOL,
                 CHI2_TOL, {})):
            want = ref[label]
            rmodel, rtoas = wb_load(torch, WB_REF_TIM, REF_DMX_BINS,
                                    free=free, perturb=ref["perturb"])
            PhaseChain.launches = 0
            rf, rchi2, rs = timed_fit(
                torch, lambda: cls(rtoas, rmodel, device=run.dev), **kw)
            sig, unc = stored_gaps(rmodel, want["values"],
                                   want["uncertainties"])
            gap = abs(rchi2 / want["chi2"] - 1.0)
            r = dict(chi2=rchi2, chi2_ref=want["chi2"], max_rel_chi2_gap=gap,
                     max_sigma_gap=sig, max_unc_rel_gap=unc,
                     status=rf.fitresult.status.name, fit_s=rs,
                     launches=PhaseChain.launches)
            ok = (rf.fit_params == want["fit_params"]
                  and r["status"] == want["status"] and sig <= tol
                  and unc <= UNC_TOL and gap <= chi2_tol
                  and PhaseChain.launches > 0)
            if free:
                nsig, nunc = stored_gaps(rmodel, want["noise_values"],
                                         want["noise_uncertainties"])
                r.update(noise_max_sigma_gap=nsig, noise_max_unc_rel_gap=nunc)
                ok = ok and nsig <= NOISE_SIGMA_TOL and nunc <= NOISE_UNC_TOL
            rec[label] = r
            if not ok:
                failed.append(label)
        rec["failed"] = failed
    if failed:
        raise AssertionError(f"wideband references failed: {failed}")

    # -- the DM family in the row function, at the paths' 12,500 TOAs -------
    with phase("dm_family_chain", {}) as rec:
        cases = []
        for kind in DM_FAMILY:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                m = get_model(dm_family_par(kind, dmx_bins=run.dmx_bins)
                              .splitlines())
            t = ctx["dd_toas"] if kind.startswith("DMF_DD") \
                else ctx["grid_toas"]
            cases.append((kind, m, WLSFitter(t, m, device=run.dev)))
        cases.append(("wideband", model, wfit))
        rec["delay_chain"], rec["phase_chain"] = {}, {}
        delay_errs = [check_delay_chain(torch, label, m, f,
                                        rec["delay_chain"])
                      for label, m, f in cases]
        frac_errs = [check_phase_chain(torch, label, m, f,
                                       rec["phase_chain"])
                     for label, m, f in cases]
        rec["layouts"] = {label: {"flags": m.calc.chain_layout.flags,
                                  "theta_slots": m.calc.chain_layout.P}
                          for label, m, _ in cases}
        # the new terms' times at the paths' shapes: the wideband path's
        # layout, and the whole family with SWM 1's quadrature
        rec["timing"] = {"delay_chain": {}, "phase_chain": {}}
        for label, m, f in (cases[-1], cases[1]):
            rec["timing"]["delay_chain"][label] = {}
            time_delay_chain(torch, m, f, 1,
                             rec["timing"]["delay_chain"][label])
            rec["timing"]["phase_chain"][label] = {}
            time_phase_chain(torch, m, f, 1,
                             rec["timing"]["phase_chain"][label])
        rec["registers"] = {
            k: chain_registers(kbuild.build_log(k), k)
            for k in ("delay_chain", "phase_chain")}
        rec.update(max_abs_delay_err_s=max(delay_errs),
                   max_abs_frac_err_vs_plain=max(frac_errs))
    out["timing"] = rec["timing"]
    out["max_abs_delay_err_s"] = max(delay_errs)
    out["max_abs_frac_err"] = max(frac_errs)
    return out

def chrom_load(torch, tim: str, dmx_bins: int, noise=None, perturb=None):
    """par + tim -> (model at the chromatic fit's start, toas) of the
    chromatic configuration (``examples.chromatic_j1713_par``, its GP
    amplitudes updated by ``noise``), as a user loads them: the timing
    start moved by DD_PERTURB, the chromatic terms and the free noise
    parameters moved by ``examples.chromatic_start``."""
    import warnings

    from pint_tpu_torch.examples import chromatic_j1713_par, chromatic_start
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.toa import get_TOAs

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        model = get_model(chromatic_j1713_par(dmx_bins=dmx_bins,
                                              noise=noise).splitlines())
        toas = get_TOAs(tim, model=model)
    for name, d in (DD_PERTURB if perturb is None else perturb).items():
        model[name].value += d
    chromatic_start(model)
    return model, toas


def wavex_load(torch, tim: str):
    """par + tim -> (model, toas) of the WaveX set
    (``examples.wavex_set_model``: the DD par without DMX, with CM, four
    CMX ranges, the troposphere and WaveX/DMWaveX/CMWaveX from the setup
    helpers) at its fit's start: DD_PERTURB, the amplitudes at 0."""
    import warnings

    from pint_tpu_torch import models
    from pint_tpu_torch.examples import wavex_set_model
    from pint_tpu_torch.models import wave
    from pint_tpu_torch.toa import get_TOAs

    model = wavex_set_model(models, wave, inject=False)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        toas = get_TOAs(tim, model=model)
    for name, d in DD_PERTURB.items():
        model[name].value += d
    return model, toas


def registers_vs_reference(regs: dict) -> dict:
    """The fused phase_chain's registers and L = 4 spills of the
    instantiations without the chromatic family against those they had
    before it came (REF_PHASE_CHAIN_REGISTERS, REF_PHASE_CHAIN_L4_SPILL):
    {kernel: [now, then]} where they differ."""
    out = {}
    for k, v in REF_PHASE_CHAIN_REGISTERS.items():
        got = regs.get(k, {}).get("registers")
        if got != v:
            out[k] = [got, v]
    for k, v in REF_PHASE_CHAIN_L4_SPILL.items():
        got = regs.get(k, {}).get("spill_store_bytes")
        if got != v:
            out[k + "_spill"] = [got, v]
    return out


def chromatic_paths(torch, np, run: Run, ctx: dict) -> dict:
    """The chromatic noise fit on the card and the chromatic family of the
    delay kernel's row function (phases chromatic_main_path ...
    chromatic_chain, see the module docstring).  ``ctx``: the grid path's
    and the DD path's TOAs, on which the family's variants run.  Returns
    the chromatic fit's launches and the timing records."""
    import statistics
    import warnings

    from pint_tpu_torch.examples import (CHROM_FAMILY, CHROM_NOISE_200,
                                         CHROM_NOISE_FREE,
                                         chromatic_family_par,
                                         simulate_chromatic_j1713)
    from pint_tpu_torch.fitter import (DownhillGLSFitter, Fitter,
                                       WLSFitter)
    from pint_tpu_torch.kernels import build as kbuild
    from pint_tpu_torch.kernels.phase_chain import PhaseChain
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.toa import write_tim

    out = {"launches": {}}

    with phase("chromatic_main_path", {}) as rec:
        t0 = time.perf_counter()
        truth, sim = simulate_chromatic_j1713(
            ntoas=run.ntoas, seed=0, dmx_bins=run.dmx_bins, device=run.dev,
            noise=run.chrom_noise)
        torch.cuda.synchronize()
        rec["simulate_s"] = time.perf_counter() - t0
        os.makedirs(os.path.dirname(run.chrom_tim), exist_ok=True)
        write_tim(run.chrom_tim, sim)
        t0 = time.perf_counter()
        model, toas = chrom_load(torch, run.chrom_tim, run.dmx_bins,
                                 noise=run.chrom_noise)
        rec["setup_s"] = time.perf_counter() - t0
        start = snapshot(model)
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        with plain_delays() as plain, no_backward() as back:
            fit, chi2, cold_s = timed_fit(
                torch, lambda: Fitter.auto(toas, model, device=run.dev))
        launches = counts()
        fr = fit.fitresult
        names, noise = fit.fit_params, fit.free_noise_params
        pulls = {n: device_offset(model[n].device_value,
                                  truth[n].device_value)
                 / model[n].device_uncertainty for n in CHROM_PULL_PARAMS}
        npulls = noise_pulls(model, truth, noise)
        rec.update(fitter=type(fit).__name__, ntoas=toas.ntoas,
                   n_fit=len(names), n_noise=len(noise),
                   status=fr.status.name, iterations=fr.iterations,
                   rung=fr.rung, chi2=chi2, dof=fr.dof,
                   chi2_per_dof=chi2 / fr.dof, fit_cold_s=cold_s,
                   fit_info=fit.fit_info, launches=launches,
                   plain_delay_chains=plain["calls"],
                   phase_chain_backward_calls=back["calls"], pulls=pulls,
                   noise={n: {"value": float(model[n].value),
                              "uncertainty": model[n].uncertainty,
                              "injected": float(truth[n].value)}
                          for n in noise},
                   noise_pulls=npulls, noise_fit_info=fit.noise_fit_info,
                   noise_basis_shape=list(model.noise_basis(
                       fit.resids.pdict).shape),
                   layout_flags=model.calc.chain_layout.flags,
                   peak_mem_bytes=torch.cuda.max_memory_allocated(),
                   device=str(fit.device))
        walls, per_fit = [], []
        for _ in range(2):
            restore(model, start)
            zero_counts()
            _, _, w = timed_fit(
                torch, lambda: Fitter.auto(toas, model, device=run.dev))
            walls.append(w)
            per_fit.append(counts())
        rec.update(chrom_fit_warm_s=statistics.median(walls),
                   fit_walls_s=walls, launches_per_warm_fit=per_fit)
        out["launches"]["chromatic_fit"] = launches
    if not isinstance(fit, DownhillGLSFitter):
        raise AssertionError(f"Fitter.auto gave {type(fit).__name__}")
    if toas.ntoas != run.ntoas or len(names) != run.chrom_nfit or \
            len(noise) != len(CHROM_NOISE_FREE):
        raise AssertionError("not the full-width chromatic configuration")
    if fr.status.name not in run.chrom_status:
        raise AssertionError(f"chromatic fit ended {fr.status.name}")
    if not 0.6 < chi2 / fr.dof < 1.6:
        raise AssertionError(f"chromatic fit chi2/dof {chi2 / fr.dof}")
    bad = {n: v for n, v in {**pulls, **npulls}.items()
           if v is not None and not abs(v) < PULL_MAX}
    if bad or any(v is None for v in npulls.values()):
        raise AssertionError(f"chromatic fit pulls {pulls}, {npulls}")
    check_path_launches("chromatic fit", launches)
    if plain["calls"] or back["calls"]:
        raise AssertionError(f"{plain['calls']} plain delay chains, "
                             f"{back['calls']} phase_chain backward calls")

    with phase("chromatic_profile", {}) as rec:
        holder = {}

        def setup():
            restore(model, start)
            holder["f"] = Fitter.auto(toas, model, device=run.dev)
            torch.cuda.synchronize()

        rec.update(profile_grid(
            torch, lambda: holder["f"].fit_toas(), run.out_dir,
            out_name="chromatic_profile", setup=setup))
        rec["lbfgsb_evaluations"] = [i["nfev"] for i in
                                     holder["f"].noise_fit_info]
        cfit = holder["f"]

    with phase("chromatic_reference", {}) as rec:
        failed = []
        with open(CHROM_REF_JSON) as f:
            want = json.load(f)
        rmodel, rtoas = chrom_load(torch, CHROM_REF_TIM, REF_DMX_BINS,
                                   noise=CHROM_NOISE_200,
                                   perturb=want["perturb"])
        PhaseChain.launches = 0
        rf, rchi2, rs = timed_fit(
            torch, lambda: DownhillGLSFitter(rtoas, rmodel, device=run.dev))
        sig, unc = stored_gaps(rmodel, want["values"], want["uncertainties"])
        nsig, nunc = stored_gaps(rmodel, want["noise_values"],
                                 want["noise_uncertainties"])
        gap = abs(rchi2 / want["chi2"] - 1.0)
        rec["chromatic"] = dict(
            chi2=rchi2, chi2_ref=want["chi2"], max_rel_chi2_gap=gap,
            max_sigma_gap=sig, max_unc_rel_gap=unc,
            noise_max_sigma_gap=nsig, noise_max_unc_rel_gap=nunc,
            status=rf.fitresult.status.name, ref_status=want["status"],
            fit_s=rs, launches=PhaseChain.launches)
        if not (rf.fit_params == want["fit_params"]
                and rf.fitresult.status.name == want["status"]
                and sig <= FIT_SIGMA_TOL and unc <= UNC_TOL
                and gap <= NOISEFIT_CHI2_TOL and nsig <= NOISE_SIGMA_TOL
                and nunc <= NOISE_UNC_TOL and PhaseChain.launches > 0):
            failed.append("chromatic")
        with open(WAVEX_REF_JSON) as f:
            want = json.load(f)
        rmodel, rtoas = wavex_load(torch, WAVEX_REF_TIM)
        PhaseChain.launches = 0
        rf, rchi2, rs = timed_fit(
            torch, lambda: WLSFitter(rtoas, rmodel, device=run.dev),
            maxiter=want["maxiter"])
        sig, unc = stored_gaps(rmodel, want["values"], want["uncertainties"])
        gap = abs(rchi2 / want["chi2"] - 1.0)
        rec["wavex"] = dict(
            chi2=rchi2, chi2_ref=want["chi2"], max_rel_chi2_gap=gap,
            max_sigma_gap=sig, max_unc_rel_gap=unc,
            status=rf.fitresult.status.name, ref_status=want["status"],
            fit_s=rs, launches=PhaseChain.launches)
        if not (rf.fit_params == want["fit_params"]
                and sig <= FIT_SIGMA_TOL and unc <= UNC_TOL
                and gap <= CHI2_TOL and PhaseChain.launches > 0):
            failed.append("wavex")
        rec["failed"] = failed
    if failed:
        raise AssertionError(f"chromatic references failed: {failed}")

    # -- the chromatic family in the row function, at 12,500 TOAs -----------
    with phase("chromatic_chain", {}) as rec:
        cases = []
        for kind in CHROM_FAMILY:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                m = get_model(chromatic_family_par(
                    kind, dmx_bins=run.dmx_bins).splitlines())
            t = ctx["dd_toas"] if kind.startswith("CHF_DD") \
                else ctx["grid_toas"]
            cases.append((kind, m, WLSFitter(t, m, device=run.dev)))
        wm, _ = wavex_load(torch, WAVEX_REF_TIM)
        cases.append(("wavex", wm, WLSFitter(ctx["dd_toas"], wm,
                                             device=run.dev)))
        cases.append(("chromatic", model, cfit))
        rec["delay_chain"], rec["phase_chain"] = {}, {}
        delay_errs = [check_delay_chain(torch, label, m, f,
                                        rec["delay_chain"])
                      for label, m, f in cases]
        frac_errs = [check_phase_chain(torch, label, m, f,
                                       rec["phase_chain"])
                     for label, m, f in cases]
        rec["layouts"] = {label: {"flags": m.calc.chain_layout.flags,
                                  "theta_slots": m.calc.chain_layout.P}
                          for label, m, _ in cases}
        # the new terms' times at the main path's shapes, and on the
        # WaveX family's layout
        rec["timing"] = {"delay_chain": {}, "phase_chain": {}}
        for label, m, f in (cases[-1], cases[-2]):
            rec["timing"]["delay_chain"][label] = {}
            time_delay_chain(torch, m, f, 1,
                             rec["timing"]["delay_chain"][label])
            rec["timing"]["phase_chain"][label] = {}
            time_phase_chain(torch, m, f, 1,
                             rec["timing"]["phase_chain"][label])
        rec["registers"] = {
            k: chain_registers(kbuild.build_log(k), k)
            for k in ("delay_chain", "phase_chain")}
        rec["phase_chain_registers_changed"] = registers_vs_reference(
            rec["registers"]["phase_chain"])
        rec.update(max_abs_delay_err_s=max(delay_errs),
                   max_abs_frac_err_vs_plain=max(frac_errs))
    out["timing"] = rec["timing"]
    out["max_abs_delay_err_s"] = max(delay_errs)
    out["max_abs_frac_err"] = max(frac_errs)
    return out


def spider_load(torch, tim: str, dmx_bins: int, par=None):
    """par + tim -> (model at the spider fit's start, toas) of the spider
    configuration (``examples.spider_realistic_par``, or ``par``), as a
    user loads them: the planets' positions loaded (the model sets
    PLANET_SHAPIRO), the start moved by ``examples.spider_start``."""
    import warnings

    from pint_tpu_torch.examples import spider_realistic_par, spider_start
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.toa import get_TOAs

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        model = get_model(par or spider_realistic_par(
            dmx_bins=dmx_bins).splitlines())
        toas = get_TOAs(tim, model=model)
    spider_start(model)
    return model, toas


def btpw_load(torch, tim: str, dmx_bins: int):
    """par + tim -> (model at the DD fit's start, toas) of the
    BT_PIECEWISE set (``examples.btpw_par``)."""
    import warnings

    from pint_tpu_torch.examples import btpw_par
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.toa import get_TOAs

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        model = get_model(btpw_par(dmx_bins=dmx_bins).splitlines())
        toas = get_TOAs(tim, model=model)
    for name, d in DD_PERTURB.items():
        model[name].value += d
    return model, toas


def normal_matrix_state(np, fitter) -> dict:
    """The whitened normal matrix of ``fitter`` at its fitted point (its
    design matrix and an offset column, each column scaled to unit
    norm): its condition number; and the pairs of fit parameters with the
    largest correlation in the fit's covariance, over all of them and
    over the orbit's (FB, ORBWAVE, A1, TASC, EPS)."""
    M, names = fitter.get_designmatrix()
    err = fitter.resids.batch.error_us.detach().cpu().numpy() * 1e-6
    A = np.column_stack([M, np.ones(len(err))]) / err[:, None]
    A = A / np.linalg.norm(A, axis=0)
    s = np.linalg.svd(A, compute_uv=False)
    out = {"normal_matrix_condition": float((s[0] / s[-1]) ** 2)}
    C = fitter.parameter_correlation_matrix
    if C is None:
        return out
    C = np.abs(np.asarray(C)[:len(names), :len(names)]) - np.eye(len(names))
    orbit = [k for k, n in enumerate(names)
             if n.startswith(("FB", "ORBWAVE", "A1", "TASC", "EPS"))]
    for key, idx in (("max_abs_correlation", list(range(len(names)))),
                     ("orbit_max_abs_correlation", orbit)):
        sub = C[np.ix_(idx, idx)]
        i, j = np.unravel_index(int(np.argmax(sub)), sub.shape)
        out[key] = {"params": [names[idx[i]], names[idx[j]]],
                    "value": float(sub[i, j])}
    return out


def ptxas_vs_parent(regs: dict) -> dict:
    """The kernels of the 21 template values without the orbit family
    against the parent's ptxas (PTXAS_REFERENCE, written by
    ``python3 chip_smoke.py --ptxas-reference``): {library: {kernel:
    [now, then]}} where registers, stack or spills differ, or a kernel
    is missing."""
    with open(PTXAS_REFERENCE) as f:
        ref = json.load(f)["kernels"]
    out = {}
    for lib, kernels in ref.items():
        for k, want in kernels.items():
            got = regs.get(lib, {}).get(k)
            if got != want:
                out.setdefault(lib, {})[k] = [got, want]
    return out


def orbit_paths(torch, np, run: Run, ctx: dict) -> dict:
    """The spider-binary fit on the card and the orbit family of the delay
    kernel's row function (phases orbit_main_path ... orbit_chain, see the
    module docstring).  Returns the spider fit's launches and the timing
    records."""
    import statistics
    import warnings

    from pint_tpu_torch.examples import (ORBIT_FAMILY, btpw_par,
                                         orbit_family_par, orbit_mixed_par,
                                         simulate_spider_realistic)
    from pint_tpu_torch.fitter import DownhillWLSFitter, Fitter, WLSFitter
    from pint_tpu_torch.kernels import build as kbuild
    from pint_tpu_torch.kernels.phase_chain import PhaseChain
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.toa import write_tim

    out = {"launches": {}}

    with phase("orbit_main_path", {}) as rec:
        t0 = time.perf_counter()
        truth, sim = simulate_spider_realistic(
            ntoas=run.ntoas, seed=0, dmx_bins=run.dmx_bins, device=run.dev)
        torch.cuda.synchronize()
        rec["simulate_s"] = time.perf_counter() - t0
        os.makedirs(os.path.dirname(run.spider_tim), exist_ok=True)
        write_tim(run.spider_tim, sim)
        t0 = time.perf_counter()
        model, toas = spider_load(torch, run.spider_tim, run.dmx_bins)
        rec["setup_s"] = time.perf_counter() - t0
        start = snapshot(model)
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        with plain_delays() as plain, no_backward() as back:
            fit, chi2, cold_s = timed_fit(
                torch, lambda: Fitter.auto(toas, model, device=run.dev))
        launches = counts()
        fr = fit.fitresult
        names = fit.fit_params
        pull_names = SPIDER_PULL_PARAMS + tuple(
            n for n in names if n.startswith("ORBWAVE"))
        pulls = {n: device_offset(model[n].device_value,
                                  truth[n].device_value)
                 / model[n].device_uncertainty for n in pull_names}
        peak = torch.cuda.max_memory_allocated()
        rec.update(fitter=type(fit).__name__, ntoas=toas.ntoas,
                   n_fit=len(names), status=fr.status.name,
                   iterations=fr.iterations, rung=fr.rung, chi2=chi2,
                   dof=fr.dof, chi2_per_dof=chi2 / fr.dof,
                   fit_cold_s=cold_s, launches=launches,
                   plain_delay_chains=plain["calls"],
                   phase_chain_backward_calls=back["calls"], pulls=pulls,
                   planets_loaded=sorted(toas.obs_planet_pos),
                   layout_flags=model.calc.chain_layout.flags,
                   theta_slots=model.calc.chain_layout.P,
                   peak_mem_bytes=peak, device=str(fit.device))
        walls, per_fit = [], []
        for _ in range(2):
            restore(model, start)
            zero_counts()
            _, _, w = timed_fit(
                torch, lambda: Fitter.auto(toas, model, device=run.dev))
            walls.append(w)
            per_fit.append(counts())
        rec.update(orbit_fit_warm_s=statistics.median(walls),
                   fit_walls_s=walls, launches_per_warm_fit=per_fit,
                   **normal_matrix_state(np, fit))
        out["launches"]["spider_fit"] = launches
    if not isinstance(fit, DownhillWLSFitter):
        raise AssertionError(f"Fitter.auto gave {type(fit).__name__}")
    if toas.ntoas != run.ntoas or len(names) != run.spider_nfit:
        raise AssertionError("not the full-width spider configuration")
    if fr.status.name != "CONVERGED":
        raise AssertionError(f"spider fit ended {fr.status.name}")
    if not 0.6 < chi2 / fr.dof < 1.6:
        raise AssertionError(f"spider fit chi2/dof {chi2 / fr.dof}")
    if not all(abs(v) < PULL_MAX for v in pulls.values()):
        raise AssertionError(f"spider fit pulls {pulls}")
    check_path_launches("spider fit", launches)
    if plain["calls"] or back["calls"]:
        raise AssertionError(f"{plain['calls']} plain delay chains, "
                             f"{back['calls']} phase_chain backward calls")

    with phase("orbit_profile", {}) as rec:
        holder = {}

        def setup():
            restore(model, start)
            holder["f"] = Fitter.auto(toas, model, device=run.dev)
            torch.cuda.synchronize()

        rec.update(profile_grid(
            torch, lambda: holder["f"].fit_toas(), run.out_dir,
            out_name="orbit_profile", setup=setup))
        sfit = holder["f"]

    with phase("orbit_reference", {}) as rec:
        failed = []
        for label, ref, load_set, make, kw in (
                ("spider", SPIDER_REF_JSON,
                 lambda: spider_load(torch, SPIDER_REF_TIM, REF_DMX_BINS),
                 lambda m, t: Fitter.auto(t, m, device=run.dev), {}),
                ("btpw", BTPW_REF_JSON,
                 lambda: btpw_load(torch, BTPW_REF_TIM, REF_DMX_BINS),
                 lambda m, t: WLSFitter(t, m, device=run.dev),
                 {"maxiter": DD_MAXITER})):
            with open(ref) as f:
                want = json.load(f)
            rmodel, rtoas = load_set()
            PhaseChain.launches = 0
            rf, rchi2, rs = timed_fit(
                torch, lambda: make(rmodel, rtoas), **kw)
            sig, unc = stored_gaps(rmodel, want["values"],
                                   want["uncertainties"])
            gap = abs(rchi2 / want["chi2"] - 1.0)
            rec[label] = dict(
                fitter=type(rf).__name__, chi2=rchi2, chi2_ref=want["chi2"],
                max_rel_chi2_gap=gap, max_sigma_gap=sig,
                max_unc_rel_gap=unc, status=rf.fitresult.status.name,
                ref_status=want["status"], fit_s=rs,
                launches=PhaseChain.launches)
            if not (rf.fit_params == want["fit_params"]
                    and rf.fitresult.status.name == want["status"]
                    and sig <= FIT_SIGMA_TOL and unc <= UNC_TOL
                    and gap <= CHI2_TOL and PhaseChain.launches > 0):
                failed.append(label)
        rec["failed"] = failed
    if failed:
        raise AssertionError(f"orbit references failed: {failed}")

    # -- the orbit family in the row function, at 12,500 TOAs ---------------
    with phase("orbit_chain", {}) as rec:
        cases = []
        pars = {kind: orbit_family_par(kind, dmx_bins=run.dmx_bins)
                for kind in ORBIT_FAMILY + ("ORB_NONE_PLANET",)}
        pars["ORB_BT_PIECES"] = btpw_par(dmx_bins=run.dmx_bins)
        pars["ORB_MIXED"] = orbit_mixed_par(dmx_bins=run.dmx_bins)
        if run.orbit_layouts is not None:
            pars = {k: v for k, v in pars.items() if k in run.orbit_layouts}
        for kind, par in pars.items():
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                m = get_model(par.splitlines())
            # every layout on the spider path's TOAs: the planets'
            # positions are loaded there
            cases.append((kind, m, WLSFitter(toas, m, device=run.dev)))
        cases.append(("spider", model, sfit))
        rec["delay_chain"], rec["phase_chain"] = {}, {}
        delay_errs = [check_delay_chain(torch, label, m, f,
                                        rec["delay_chain"])
                      for label, m, f in cases]
        frac_errs = [check_phase_chain(torch, label, m, f,
                                       rec["phase_chain"])
                     for label, m, f in cases]
        rec["layouts"] = {label: {"flags": m.calc.chain_layout.flags,
                                  "theta_slots": m.calc.chain_layout.P}
                          for label, m, _ in cases}
        # the new terms' times at the path's shapes, and on the layout
        # that runs every family's terms
        rec["timing"] = {"delay_chain": {}, "phase_chain": {}}
        for label, m, f in cases:
            if label not in ("spider", "ORB_MIXED"):
                continue
            rec["timing"]["delay_chain"][label] = {}
            time_delay_chain(torch, m, f, 1,
                             rec["timing"]["delay_chain"][label])
            rec["timing"]["phase_chain"][label] = {}
            time_phase_chain(torch, m, f, 1,
                             rec["timing"]["phase_chain"][label])
        regs = {k: chain_registers(kbuild.build_log(k), k)
                for k in ("delay_chain", "phase_chain")}
        rec["registers_orbit_family"] = {
            lib: {k: v for k, v in r.items() if "+ORB" in k}
            for lib, r in regs.items()}
        rec["ptxas_changed_vs_parent"] = ptxas_vs_parent(regs)
        rec.update(max_abs_delay_err_s=max(delay_errs),
                   max_abs_frac_err_vs_plain=max(frac_errs))
    if rec["ptxas_changed_vs_parent"]:
        raise AssertionError("the kernels without the orbit family changed "
                             f"ptxas: {rec['ptxas_changed_vs_parent']}")
    out["timing"] = rec["timing"]
    out["max_abs_delay_err_s"] = max(delay_errs)
    out["max_abs_frac_err"] = max(frac_errs)
    return out


def scan_grid(np, sigma: dict, axis: int = SCAN_AXIS) -> dict:
    """The sim_scan path's ``axis`` x ``axis`` M2/SINI grid, flat, centred
    on SIM_TRUTH: each axis's step SCAN_STEP_SIGMA of ``sigma`` (a fit's
    uncertainty with both free), kept so that M2 > 0 and SINI < 1 at the
    grid's edge; returns the axes' steps and values too."""
    half = axis // 2
    steps = {n: min(SCAN_STEP_SIGMA * sigma[n],
                    (SIM_TRUTH[n] if n == "M2" else 1.0 - SIM_TRUTH[n])
                    / (half + 0.5)) for n in SIM_TRUTH}
    axes = {n: SIM_TRUTH[n] + steps[n] * np.arange(-half, half + 1)
            for n in SIM_TRUTH}
    grid = {"M2": np.repeat(axes["M2"], axis),
            "SINI": np.tile(axes["SINI"], axis)}
    return {"steps": steps, "axes": axes, "grid": grid}


def check_primal_at(torch, model, fitter, X, rec: dict) -> float:
    """The fused phase_chain primal at the fit points ``X`` (one launch over
    len(X) θ sets) against the unfused card chain (bit-equal: frac, slope,
    dt64) and against the plain composition (frac within F0 x DELAY_TOL_S,
    K3's bars).  Returns frac's largest gap to the plain composition."""
    from pint_tpu_torch.kernels import phase_chain as pc
    from pint_tpu_torch.kernels import qs_phase

    r = fitter.resids
    p, b, calc, names = r.pdict, r.batch, model.calc, fitter.fit_params
    spec, thetas, others, tensors = fused_points(torch, model, fitter, X)
    with torch.no_grad():
        fused = pc.run(spec, thetas, others, tensors)
        want = qs_phase.run(*unfused_points(torch, model, fitter, X))

        def plain_f(x):
            return pc.unfused(calc, model.with_x(p, x, names), b, "nearest")

        with plain_phase():
            plain = torch.func.vmap(plain_f)(X)
        err = float(torch.max(torch.abs(fused[0] - plain)))
    bar = float(model.F0.value) * DELAY_TOL_S
    rec.update(theta_sets=int(X.shape[0]), ntoas=b.ntoas,
               primal_bit_equal_to_unfused={
                   name: bool(torch.equal(a, w)) for name, a, w in
                   zip(("out", "slope", "dt64"), fused, want)},
               max_abs_frac_err_vs_plain=err, frac_bar_vs_plain_cycles=bar)
    if not (all(rec["primal_bit_equal_to_unfused"].values()) and err <= bar):
        raise AssertionError(f"phase_chain primal at {X.shape[0]} θ sets: "
                             f"{rec}")
    return err


def sim_scan_paths(torch, np, run: Run) -> dict:
    """The simulate-fit-scan path (phases sim_main_path ... sim_chain, see
    the module docstring).  Returns its launches and the timing records of
    the phase chain at its shapes."""
    import statistics
    import warnings

    from pint_tpu_torch import faultinject
    from pint_tpu_torch.examples import (j0740_realistic_par,
                                         simulate_j0740_realistic)
    from pint_tpu_torch.exceptions import ScanInterrupted
    from pint_tpu_torch.fitter import WLSFitter, fit_wls_eigh
    from pint_tpu_torch.gridutils import grid_chisq_flat
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.runtime import ChunkStatus
    from pint_tpu_torch.simulation import calculate_random_models

    out = {"launches": {}}
    os.makedirs(run.out_dir, exist_ok=True)
    ck = os.path.join(run.out_dir, "sim_scan_checkpoint.npz")

    def fresh_checkpoint():
        if os.path.exists(ck):
            os.remove(ck)
        return ck

    # the scans take the card's WLS solve on any device: the eigh of the
    # normal matrix (on the CPU the default is pint_tpu's SVD recipe)
    def scan(**kw):
        return grid_chisq_flat(fit, grid, maxiter=2, kernel=fit_wls_eigh,
                               chunk_size=run.scan_chunk,
                               return_summary=True, **kw)

    def random_models():
        return calculate_random_models(rfit, toas, Nmodels=RANDOM_MODELS,
                                       seed=RANDOM_MODELS_SEED)

    def all_ok(summ):
        """Every chunk of a scan that no failpoint touched ran OK: a
        chunk retried or rerouted there is a fault that the scan hid."""
        return summ.counts() == {"OK": summ.n_chunks}

    def scatter_ratio(f, dphase):
        """Median over TOAs of the draws' scatter over F0 sqrt(diag(M C
        M^T)): M the design matrix with the weighted offset profiled out,
        C as the draws take it (the correlation with 1e-12 on its
        diagonal, rescaled), formed as |M s L| with L its Cholesky factor
        (well scaled, where M C M^T's terms cancel below their
        rounding)."""
        names_ = f.covariance_params
        M, _ = f.get_designmatrix()
        w = 1.0 / np.asarray(toas.error_us, np.float64) ** 2
        Mw = M - (w @ M) / np.sum(w)
        C = np.asarray(f.parameter_covariance_matrix)[:len(names_),
                                                      :len(names_)]
        sd = np.sqrt(np.diag(C))
        L = np.linalg.cholesky(C / np.outer(sd, sd)
                               + 1e-12 * np.eye(len(names_)))
        pred = float(f.model.F0.value) * np.linalg.norm(
            Mw @ (sd[:, None] * L), axis=1)
        return float(np.median(np.std(dphase, axis=0) / pred))

    with phase("sim_main_path", {}) as rec:
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        with plain_delays() as plain, no_backward() as back:
            t0 = time.perf_counter()
            model, toas = simulate_j0740_realistic(
                run.ntoas, seed=0, device=run.dev, dmx_bins=run.dmx_bins)
            torch.cuda.synchronize()
            rec.update(sim_simulate_s=time.perf_counter() - t0,
                       zero_residuals_iterations=toas.
                       zero_residuals_iterations,
                       simulate_launches=counts())
            truth = {n: np.array(model[n].device_value, np.float64)
                     for n in model.free_params}
            # the fit, M2 and SINI frozen as in the headline grid
            fit, chi2, fit_s = timed_fit(
                torch, lambda: WLSFitter(toas, model, device=run.dev),
                maxiter=DD_MAXITER)
            fr = fit.fitresult
            names = fit.fit_params
            pulls = {n: device_offset(model[n].device_value, truth[n])
                     / model[n].device_uncertainty for n in names}
            # the grid's steps: a fit of the same set with M2 and SINI free
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                free = get_model(j0740_realistic_par(
                    dmx_bins=run.dmx_bins).splitlines())
            for n in SIM_TRUTH:
                free[n].frozen = False
            ffit, fchi2, _ = timed_fit(
                torch, lambda: WLSFitter(toas, free, device=run.dev),
                maxiter=DD_MAXITER)
            sig = {n: float(free[n].uncertainty) for n in SIM_TRUTH}
            g = scan_grid(np, sig, run.scan_axis)
            grid = g["grid"]
            # the whole-grid program, then the chunked, checkpointed scan
            t0 = time.perf_counter()
            whole = grid_chisq_flat(fit, grid, maxiter=2,
                                    kernel=fit_wls_eigh)
            torch.cuda.synchronize()
            whole_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            chunked, summ = scan(checkpoint=fresh_checkpoint())
            torch.cuda.synchronize()
            chunked_s = time.perf_counter() - t0
            # the random models: on a fit of the same set with
            # RANDOM_MODELS_FROZEN frozen at the par's values
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                rmodel = get_model(j0740_realistic_par(
                    dmx_bins=run.dmx_bins).splitlines())
            for n in RANDOM_MODELS_FROZEN:
                rmodel[n].frozen = True
            rfit, rchi2, _ = timed_fit(
                torch, lambda: WLSFitter(toas, rmodel, device=run.dev),
                maxiter=DD_MAXITER)
            before = counts()
            t0 = time.perf_counter()
            dphase, draws = random_models()
            torch.cuda.synchronize()
            rm_s = time.perf_counter() - t0
            rm_launches = {k: n - before[k] for k, n in counts().items()}
        launches = counts()
        rel = float(np.max(np.abs(chunked - whole) / np.abs(whole)))
        imin = int(np.argmin(chunked))
        at_min = divmod(imin, run.scan_axis)
        ratio = scatter_ratio(rfit, dphase)
        f0 = float(model.F0.value)
        rec.update(
            ntoas=toas.ntoas, n_fit=len(names), status=fr.status.name,
            iterations=fr.iterations, rung=fr.rung, chi2=chi2, dof=fr.dof,
            chi2_per_dof=chi2 / fr.dof, fit_cold_s=fit_s,
            pulls=pulls, max_abs_pull=max(abs(v) for v in pulls.values()),
            free_fit={"chi2": fchi2, "status": ffit.fitresult.status.name,
                      "values": {n: float(free[n].value) for n in SIM_TRUTH},
                      "sigma": sig},
            grid_steps=g["steps"],
            grid_axes={n: v.tolist() for n, v in g["axes"].items()},
            chi2_whole=whole.tolist(), chi2_chunked=chunked.tolist(),
            max_rel_chunked_vs_whole=rel, whole_grid_s=whole_s,
            chunked_scan_cold_s=chunked_s, chunk_statuses=summ.counts(),
            n_chunks=summ.n_chunks, chi2_min_at=list(at_min),
            random_models_fit={
                "n_fit": len(rfit.fit_params), "chi2": rchi2,
                "chi2_per_dof": rchi2 / rfit.fitresult.dof,
                "status": rfit.fitresult.status.name,
                "n_bad": rfit.fit_info.get("n_bad"),
                "frozen": list(RANDOM_MODELS_FROZEN)},
            random_models_cold_s=rm_s, random_models_launches=rm_launches,
            random_models_shapes=[list(dphase.shape), list(draws.shape)],
            random_models_scatter_ratio=ratio,
            random_models_median_std_us=float(np.median(np.std(
                dphase, axis=0))) / f0 * 1e6,
            plain_delay_chains=plain["calls"],
            phase_chain_backward_calls=back["calls"],
            launches=launches,
            peak_mem_bytes=torch.cuda.max_memory_allocated(),
            device=str(fit.device))
        out["launches"]["sim_scan"] = launches
    if toas.ntoas != run.ntoas or len(names) != run.nfit:
        raise AssertionError("not the full-width simulated configuration")
    if fr.status.name not in ("CONVERGED", "MAXITER"):
        raise AssertionError(f"simulated fit ended {fr.status.name}")
    if not SIM_CHI2_PER_DOF[0] < chi2 / fr.dof < SIM_CHI2_PER_DOF[1]:
        raise AssertionError(f"simulated fit chi2/dof {chi2 / fr.dof}")
    if not rec["max_abs_pull"] < PULL_MAX:
        raise AssertionError(f"simulated fit pulls {pulls}")
    if not (rel <= CHI2_TOL and all_ok(summ) and summ.n_chunks == -(
            -run.scan_axis ** 2 // run.scan_chunk)):
        raise AssertionError(f"chunked scan: {rel}, {summ}")
    if not all(abs(i - run.scan_axis // 2) <= 1 for i in at_min):
        raise AssertionError(f"chi2 minimum at {at_min}, not within one "
                             "step of the truth")
    if dphase.shape != (RANDOM_MODELS, toas.ntoas) or draws.shape != (
            RANDOM_MODELS, len(rfit.fit_params)):
        raise AssertionError(f"random models' shapes {dphase.shape}, "
                             f"{draws.shape}")
    if not (rm_launches["phase_chain_primal"] <= 2
            and rm_launches["phase_chain_tangent"] == 0
            and rm_launches["phase_chain_primal"] > 0
            and plain["calls"] == 0 and back["calls"] == 0):
        raise AssertionError(f"random models: {rm_launches}; on the path "
                             f"{plain['calls']} plain delay chains, "
                             f"{back['calls']} backward calls")
    if not SCATTER_RATIO[0] < ratio < SCATTER_RATIO[1]:
        raise AssertionError(f"random models' scatter ratio {ratio}")
    check_path_launches("simulate-fit-scan path", launches)

    with phase("sim_scan_timing", {}) as rec:
        walls, per_call, repeats, summs = [], [], [], []
        torch.cuda.reset_peak_memory_stats()
        for _ in range(3):
            zero_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            again, s = scan(checkpoint=fresh_checkpoint())
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            per_call.append(counts())
            repeats.append(again)
            summs.append(s)
        rec.update(scan_warm_s=statistics.median(walls), scan_walls_s=walls,
                   launches_per_scan=per_call,
                   peak_mem_bytes=torch.cuda.max_memory_allocated(),
                   deterministic=all(np.array_equal(v, chunked)
                                     for v in repeats),
                   max_rel_repeat_gap=max(float(np.max(np.abs(
                       v - chunked) / np.abs(chunked))) for v in repeats))
        rec["profile"] = profile_grid(
            torch, lambda: summs.append(
                scan(checkpoint=fresh_checkpoint())[1]),
            run.out_dir, out_name="sim_scan_profile")
        rec["chunk_statuses"] = [s.counts() for s in summs]
        walls, per_call = [], []
        torch.cuda.reset_peak_memory_stats()
        for _ in range(3):
            zero_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            random_models()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            per_call.append(counts())
        rec.update(random_models_warm_s=statistics.median(walls),
                   random_models_walls_s=walls,
                   launches_per_random_models=per_call,
                   random_models_peak_mem_bytes=torch.cuda.
                   max_memory_allocated())
        rec["random_models_profile"] = profile_grid(
            torch, random_models, run.out_dir,
            out_name="random_models_profile")
    if not all(all_ok(s) for s in summs):
        raise AssertionError(f"a timed scan hid a fault: {rec}")
    # the resume and the retry below are held bit-identical to the first
    # chunked scan, so the card's program must repeat it exactly
    if not rec["deterministic"]:
        raise AssertionError(f"chunked scans differ on repeat: {rec}")

    def rest_ok(summ, faulted):
        """Every chunk but ``faulted`` ran OK."""
        return all(st == ChunkStatus.OK for i, st in enumerate(
            summ.statuses) if i != faulted)

    with phase("sim_scan_faults", {}) as rec:
        fresh_checkpoint()
        with faultinject.sigterm_midscan(after_chunk=SCAN_SIGTERM_AFTER):
            try:
                scan(checkpoint=ck)
                interrupted = None
            except ScanInterrupted as e:
                interrupted = e
        left = os.path.exists(ck)
        resumed, rs = scan(checkpoint=ck, resume=True)
        with faultinject.chunk_nonfinite(chunks=(1,), times=1):
            retried, ts = scan(checkpoint=fresh_checkpoint())
        with faultinject.chunk_raise(chunks=(1,), times=99):
            rerouted, xs = scan(checkpoint=fresh_checkpoint(),
                                max_retries=2)
        reroute_rel = float(np.max(np.abs(rerouted - chunked)
                                   / np.abs(chunked)))
        rec.update(
            interrupted=None if interrupted is None else {
                "signum": interrupted.signum,
                "chunks_done": interrupted.chunks_done,
                "n_chunks": interrupted.n_chunks},
            checkpoint_left=left, resumed_chunks=rs.resumed_chunks,
            resume_statuses=[s.name for s in rs.statuses],
            resume_bit_identical=bool(np.array_equal(resumed, chunked)),
            retry_statuses=[s.name for s in ts.statuses],
            retry_bit_identical=bool(np.array_equal(retried, chunked)),
            reroute_statuses=[s.name for s in xs.statuses],
            reroute_max_rel_gap=reroute_rel)
    if not (interrupted is not None and left
            and rs.resumed_chunks == SCAN_SIGTERM_AFTER + 1
            and rec["resume_bit_identical"] and all_ok(rs)):
        raise AssertionError(f"SIGTERM and resume: {rec}")
    if not (ts.statuses[1] == ChunkStatus.RETRIED and rest_ok(ts, 1)
            and rec["retry_bit_identical"]):
        raise AssertionError(f"retry: {rec}")
    if not (xs.statuses[1] == ChunkStatus.REROUTED and rest_ok(xs, 1)
            and reroute_rel <= CHI2_TOL):
        raise AssertionError(f"reroute: {rec}")

    # the fused primal at the random models' shape (one launch over the
    # draws' θ sets) and the chain at the scan's chunk width
    with phase("sim_chain", {}) as rec:
        x0 = rmodel.x0(rfit.resids.pdict, rfit.fit_params).to(rfit.device)
        X = x0 + torch.as_tensor(draws, device=rfit.device)
        rec["random_models_primal"] = {}
        err = check_primal_at(torch, rmodel, rfit, X,
                              rec["random_models_primal"])
        rec["timing"] = {"random_models": {}, "scan_chunk": {}}
        time_phase_chain(torch, rmodel, rfit, RANDOM_MODELS,
                         rec["timing"]["random_models"], sets=())
        time_phase_chain(torch, model, fit, run.scan_chunk,
                         rec["timing"]["scan_chunk"])
    out["timing"] = rec["timing"]
    out["max_abs_frac_err"] = err
    return out


def ptxas_reference(csrc: str, path: str) -> int:
    """Compile ``csrc``'s delay_chain.cu and phase_chain.cu (another
    checkout's kernel sources) with the package's nvcc flags, one nvcc
    each at once, and write their kernels' ptxas registers, stack and
    spills to ``path`` as JSON (PTXAS_REFERENCE's format)."""
    import shutil
    import tempfile

    sys.path.insert(0, REPO)
    from pint_tpu_torch.kernels import build as kbuild

    tmp = tempfile.mkdtemp(dir=os.path.join(REPO, "build"))
    try:
        procs = {k: subprocess.Popen(
            [kbuild.nvcc(), *kbuild.NVCC_FLAGS, "-I", csrc, "-o",
             os.path.join(tmp, f"lib{k}.so"), os.path.join(csrc, f"{k}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for k in ("delay_chain", "phase_chain")}
        logs = {k: p.communicate()[0] for k, p in procs.items()}
        if any(p.returncode for p in procs.values()):
            print(json.dumps(logs), file=sys.stderr)
            return 1
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rec = {"what": "ptxas -v of delay_chain.cu and phase_chain.cu of "
                   f"{os.path.relpath(csrc, REPO)}, nvcc flags "
                   + " ".join(kbuild.NVCC_FLAGS),
           "nvcc": subprocess.run([kbuild.nvcc(), "--version"],
                                  capture_output=True,
                                  text=True).stdout.strip().splitlines()[-1],
           "kernels": {k: chain_registers(v, k) for k, v in logs.items()}}
    with open(path, "w") as f:
        json.dump(rec, f, indent=1, sort_keys=True)
        f.write("\n")
    print(json.dumps({k: len(v) for k, v in rec["kernels"].items()}))
    return 0


def main(run: Run = Run()) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "pint_tpu_torch")):
        print("chip_smoke: pint_tpu_torch/ is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    # host caches (ephemeris windows, clock files) stay inside the checkout
    cache = os.path.join(REPO, "build", "cache")
    os.environ.setdefault("PINT_TPU_CACHE", cache)
    os.environ.setdefault("PINT_TPU_CLOCK_DIR", os.path.join(cache, "clock"))

    import numpy as np

    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    with phase("device", {"nvidia_smi": smi, "kind": kind,
                          "count": torch.cuda.device_count(),
                          "torch": torch.__version__,
                          "cuda": torch.version.cuda}):
        pass

    from pint_tpu_torch.kernels import build as kbuild

    with phase("build", {}) as rec:
        libs = kbuild.build_all()
        rec["libraries"] = {k: os.path.relpath(v, REPO)
                            for k, v in libs.items()}

    paths = PATHS if run.paths is None else tuple(run.paths)
    unknown = [p for p in paths if p not in PATHS]
    earlier = [p for p in PATHS[:-1] if p in paths]
    if unknown or len(earlier) not in (0, len(PATHS) - 1):
        raise ValueError(f"paths {paths}: the first eight of {PATHS} run "
                         "together or not at all")
    kernels = earlier_paths(torch, np, run) if earlier else None
    if "sim_scan" in paths:
        sim = sim_scan_paths(torch, np, run)
        if kernels is not None:
            add_sim_scan(kernels, sim)
    if kernels is not None:
        emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


def earlier_paths(torch, np, run: Run) -> list:
    """Phases qs_phase_frac ... orbit_chain: the first eight paths (see the
    module docstring).  Returns the kernels line's list."""
    from pint_tpu_torch.gridutils import grid_chisq_flat
    from pint_tpu_torch.kernels import build as kbuild
    from pint_tpu_torch.kernels import phase_chain
    from pint_tpu_torch.kernels.phase_chain import PhaseChain

    grid = {"M2": np.repeat(np.array(GRID_M2), 3),
            "SINI": np.tile(np.array(GRID_SINI), 3)}

    # -- 3. the kernel against its plain version, at the main path's shapes --
    with phase("qs_phase_frac", {}) as kernel_rec:
        t0 = time.perf_counter()
        model, _, fitter = load(torch, run.dev, run.tim, run.dmx_bins)
        kernel_rec["setup_first_s"] = time.perf_counter() - t0
        check_kernel(torch, np, model, fitter, grid, kernel_rec)

    # -- 4. the main path, as a user drives it --------------------------------
    zero_counts()
    with phase("main_path", {}) as rec:
        t0 = time.perf_counter()
        model, toas, fitter = load(torch, run.dev, run.tim, run.dmx_bins)
        rec["setup_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        chi2 = grid_chisq_flat(fitter, grid, maxiter=2)
        torch.cuda.synchronize()
        rec["grid_cold_s"] = time.perf_counter() - t0
        grid_launches = counts()
        rec.update(ntoas=toas.ntoas, n_free=len(model.free_params),
                   n_fit=len(fitter.fit_params), grid_points=len(chi2),
                   chi2=chi2.tolist(), launches=grid_launches,
                   device=str(fitter.device))
        # read after the count: residuals launch the kernel once more
        rec["prefit_rms_us"] = float(np.std(fitter.resids.time_resids)) * 1e6
        rec["pulse_period_us"] = 1e6 / float(model.F0.value)
    check_path_launches("main path", grid_launches)
    if chi2.shape != (9,) or not np.all(np.isfinite(chi2)):
        raise AssertionError(f"bad grid chi2 {chi2}")
    if toas.ntoas != run.ntoas or len(fitter.fit_params) != run.nfit:
        raise AssertionError("not the full-width configuration")

    with phase("grid_timing", {}) as rec:
        walls = []
        for _ in range(3):
            zero_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            warm = grid_chisq_flat(fitter, grid, maxiter=2)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        grid_call_launches = counts()
        rec.update(grid_warm_s=median(walls), grid_walls_s=walls,
                   launches_per_grid_call=grid_call_launches,
                   max_abs_chi2_change=float(np.max(np.abs(warm - chi2))),
                   peak_mem_bytes=torch.cuda.max_memory_allocated())

    with phase("grid_profile", {}) as rec:
        rec.update(profile_grid(torch, lambda: grid_chisq_flat(
            fitter, grid, maxiter=2), run.out_dir))
        # K6's least work per grid call: each point's Gauss-Newton
        # iterations form the (N, P+1) design matrix's Gram once
        n_col = len(fitter.fit_params) + 1
        ops = len(chi2) * 2 * 2.0 * toas.ntoas * n_col**2
        nbytes = len(chi2) * 2 * 8.0 * toas.ntoas * n_col
        rec.update(solve_bound_ms=1e3 * max(ops / PEAK_F64_MATMUL_PER_S,
                                            nbytes / MEM_BYTES_PER_S),
                   solve_bound_by="operations" if ops / PEAK_F64_MATMUL_PER_S
                   >= nbytes / MEM_BYTES_PER_S else "bytes")

    # the same grid with the phase chain run by the plain composition
    with phase("plain_grid", {}) as rec:
        real_frac = phase_chain.phase_frac
        phase_chain.phase_frac = phase_chain.unfused
        try:
            with plain_phase():
                zero_counts()
                t0 = time.perf_counter()
                chi2_plain = grid_chisq_flat(fitter, grid, maxiter=2)
                torch.cuda.synchronize()
                rec["grid_plain_s"] = time.perf_counter() - t0
                rec["launches"] = sum(counts().values())
        finally:
            phase_chain.phase_frac = real_frac
        gap = float(np.max(np.abs(chi2 - chi2_plain) / np.abs(chi2_plain)))
        rec.update(chi2_plain=chi2_plain.tolist(), max_rel_chi2_gap=gap)
        if rec["launches"] != 0 or not gap <= CHI2_TOL:
            raise AssertionError(f"plain grid chi2 gap {gap}")

    # a small set with a pint_tpu reference, on the card
    with phase("reference", {}) as rec:
        with open(REF_JSON) as f:
            ref = json.load(f)
        _, rtoas, rfit = load(torch, run.dev, REF_TIM, REF_DMX_BINS)
        PhaseChain.launches = 0
        rchi2 = grid_chisq_flat(rfit, {k: np.asarray(v) for k, v in
                                       ref["grid"].items()},
                                maxiter=ref["maxiter"])
        want = np.asarray(ref["chi2"])
        gap = float(np.max(np.abs(rchi2 - want) / want))
        rec.update(ntoas=rtoas.ntoas, n_fit=len(rfit.fit_params),
                   chi2=rchi2.tolist(), chi2_ref=want.tolist(),
                   ref_kernel=ref["kernel"], max_rel_chi2_gap=gap,
                   launches=PhaseChain.launches,
                   prefit_rms_us=float(np.std(
                       rfit.resids.time_resids)) * 1e6)
        if rfit.fit_params != ref["fit_params"] or not gap <= CHI2_TOL \
                or rec["launches"] <= 0:
            raise AssertionError(f"reference grid chi2 gap {gap}")

    # -- 5. the DD slice: simulate -> tim -> fit_toas, as a user drives it ----
    from pint_tpu_torch.examples import simulate_dd_realistic
    from pint_tpu_torch.fitter import WLSFitter, build_wls_step
    from pint_tpu_torch.toa import write_tim

    with phase("dd_main_path", {}) as rec:
        t0 = time.perf_counter()
        truth, sim_toas = simulate_dd_realistic(
            ntoas=run.ntoas, seed=0, dmx_bins=run.dmx_bins, device=run.dev)
        torch.cuda.synchronize()
        rec["simulate_s"] = time.perf_counter() - t0
        os.makedirs(os.path.dirname(run.dd_tim), exist_ok=True)
        write_tim(run.dd_tim, sim_toas)
        t0 = time.perf_counter()
        dmodel, dtoas = dd_load(torch, run.dd_tim, run.dmx_bins)
        rec["setup_s"] = time.perf_counter() - t0
        start = snapshot(dmodel)
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        t0 = time.perf_counter()
        dfit, dchi2, fit_s = dd_fit(torch, run.dev, dmodel, dtoas)
        rec.update(fit_cold_s=fit_s,
                   fitter_and_fit_s=time.perf_counter() - t0)
        # the Kepler solve of the DD orbit runs inside the delay_chain
        # kernel on this path, so kepler_E itself is not launched here
        dd_launches = counts()
        fr = dfit.fitresult
        names = dfit.fit_params
        pulls = {n: device_offset(dmodel[n].device_value,
                                  truth[n].device_value)
                 / dmodel[n].device_uncertainty for n in DD_PULL_PARAMS}
        rec.update(ntoas=dtoas.ntoas, n_fit=len(names),
                   status=fr.status.name,
                   iterations=fr.iterations, rung=fr.rung, chi2=dchi2,
                   dof=fr.dof, chi2_per_dof=dchi2 / fr.dof, **dfit.fit_info,
                   launches=dd_launches, pulls=pulls,
                   peak_mem_bytes=torch.cuda.max_memory_allocated(),
                   device=str(dfit.device))
        fused_vals, fused_uncs = fit_state(dmodel, names)
        walls, per_fit, splits = [], [], []
        for _ in range(3):
            restore(dmodel, start)
            wf = WLSFitter(dtoas, dmodel, device=run.dev)
            zero_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            wchi2 = wf.fit_toas(maxiter=DD_MAXITER)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            per_fit.append(counts())
            splits.append(wf.fit_info["seconds"])
        # the warm fits' wall split (fitter.build_fused_fit): device loop
        # up to the fetch, host solve + final step, write-back, and the
        # rest of fit_toas; shares are of each fit's own wall, median
        for sp, w in zip(splits, walls):
            sp["other"] = w - sum(sp.values())
        rec.update(fit_warm_s=median(walls), fit_walls_s=walls,
                   launches_per_warm_fit=per_fit, fit_warm_split_s=splits,
                   fit_warm_share={k: median([sp[k] / w for sp, w in
                                              zip(splits, walls)])
                                   for k in splits[0]},
                   warm_chi2_change=abs(wchi2 - dchi2))
        rec_dd_per_fit = per_fit
    if dtoas.ntoas != run.ntoas or len(names) != run.nfit:
        raise AssertionError("not the full-width DD configuration")
    if fr.rung != "fused" or fr.status.name not in ("CONVERGED", "MAXITER"):
        raise AssertionError(f"DD fit ended {fr.status.name} on {fr.rung}")
    if not 0.6 < dchi2 / fr.dof < 1.6:
        raise AssertionError(f"DD fit chi2/dof {dchi2 / fr.dof}")
    bad = {n: v for n, v in pulls.items() if not abs(v) < PULL_MAX}
    if bad:
        raise AssertionError(f"DD fit pulls {bad}")
    check_path_launches("DD path", dd_launches)

    with phase("kepler_E", {}) as kepler_rec:
        check_kepler(torch, dfit, kepler_rec)
        kepler_rec["launches"] = dd_launches["kepler_E"]
        kepler_rec["solved_on_the_paths_by"] = "delay_chain"

    with phase("dd_fused_vs_eager", {}) as rec:
        restore(dmodel, start)
        efit, echi2, eager_s = dd_fit(torch, run.dev, dmodel, dtoas,
                                      eager=True)
        ev, eu = fit_state(dmodel, names)
        dev, unc = fit_gaps(fused_vals, fused_uncs, ev, eu)
        rec.update(eager_s=eager_s, eager_status=efit.fitresult.status.name,
                   eager_chi2=echi2, fused_chi2=dchi2,
                   max_sigma_gap=dev, max_unc_rel_gap=unc,
                   eager_fit_info=efit.fit_info)
        # the final covariance at the fitted point (the model now holds
        # the eager fit), assembled on the card and on the CPU: what
        # pint_tpu's CPU re-assembly of it would change here
        outs = {}
        for label, where in (("card", run.dev), ("cpu", "cpu")):
            f = WLSFitter(dtoas, dmodel, device=where)
            step = build_wls_step(dmodel, f.resids.batch, names,
                                  f.track_mode)
            outs[label] = step(np.zeros(len(names)), f.resids.pdict)
        sd = {k: np.sqrt(np.diag(np.asarray(
            o["Sigma_n"], np.float64))) / np.asarray(o["norms"], np.float64)
              for k, o in outs.items()}
        rel = np.abs(sd["card"] / sd["cpu"] - 1.0)
        rec.update(card_vs_cpu_assembly_unc_max_rel=float(np.max(rel)),
                   card_vs_cpu_assembly_worst_param=names[
                       int(np.argmax(rel))],
                   e_min=float(outs["card"]["e_min"]))
        if not (dev <= FIT_SIGMA_TOL and unc <= UNC_TOL):
            raise AssertionError(f"fused vs eager: {dev} sigma, {unc} unc")

    with phase("dd_fit_profile", {}) as rec:
        holder = {}

        def setup():
            restore(dmodel, start)
            holder["f"] = WLSFitter(dtoas, dmodel, device=run.dev)
            torch.cuda.synchronize()

        rec.update(profile_grid(
            torch, lambda: holder["f"].fit_toas(maxiter=DD_MAXITER),
            run.out_dir, out_name="dd_fit_profile", setup=setup))
        # the fused loop's least device work: per Gauss-Newton iteration
        # the solve reads the (N, P+1) whitened design matrix once and
        # forms its Gram (2 N (P+1)^2 float64 operations)
        it = holder["f"].fitresult.iterations
        n_rows, n_col = dtoas.ntoas, len(names) + 1
        t_ops = it * 2.0 * n_rows * n_col**2 / PEAK_OPS_PER_S["float64"]
        t_bytes = it * 8.0 * n_rows * n_col / MEM_BYTES_PER_S
        rec.update(loop_iterations=it,
                   loop_bound_ms=1e3 * max(t_ops, t_bytes),
                   loop_bound_by="operations" if t_ops >= t_bytes
                   else "bytes")

    with phase("dd_reference", {}) as rec:
        with open(DD_REF_JSON) as f:
            ref = json.load(f)
        rmodel, rtoas = dd_load(torch, DD_REF_TIM, REF_DMX_BINS,
                                perturb=ref["perturb"])
        PhaseChain.launches = 0
        rfit, rchi2, _ = dd_fit(torch, run.dev, rmodel, rtoas)
        rv, ru = fit_state(rmodel, rfit.fit_params)
        dev, unc = fit_gaps(rv, ru, ref["values"], ref["uncertainties"])
        gap = abs(rchi2 - ref["chi2"]) / ref["chi2"]
        rec.update(ntoas=rtoas.ntoas, n_fit=len(rfit.fit_params),
                   status=rfit.fitresult.status.name,
                   rung=rfit.fitresult.rung, chi2=rchi2,
                   chi2_ref=ref["chi2"], max_rel_chi2_gap=gap,
                   max_sigma_gap=dev, max_unc_rel_gap=unc,
                   ref_status=ref["status"], launches=PhaseChain.launches)
        if rfit.fit_params != ref["fit_params"] or not (
                dev <= FIT_SIGMA_TOL and unc <= UNC_TOL and gap <= CHI2_TOL
                and rec["launches"] > 0):
            raise AssertionError(
                f"DD reference: {dev} sigma, {unc} unc, chi2 gap {gap}")

    # -- 6. the GLS slice: simulate -> tim -> GLSFitter.fit_toas ------------
    from pint_tpu_torch.examples import simulate_dd_noise_realistic
    from pint_tpu_torch.fitter import (_host_noise_basis,
                                       build_whitened_assembly, gls_solve)

    with phase("gls_main_path", {}) as rec:
        t0 = time.perf_counter()
        gtruth, gsim = simulate_dd_noise_realistic(
            ntoas=run.ntoas, seed=0, dmx_bins=run.dmx_bins, device=run.dev)
        torch.cuda.synchronize()
        rec["simulate_s"] = time.perf_counter() - t0
        write_tim(run.gls_tim, gsim)
        t0 = time.perf_counter()
        gmodel, gtoas = gls_load(torch, run.gls_tim, run.dmx_bins)
        rec["setup_s"] = time.perf_counter() - t0
        gstart = snapshot(gmodel)
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        with plain_delays() as plain:
            gfit, gchi2, fit_s = gls_fit(torch, run.dev, gmodel, gtoas)
        gls_launches = counts()
        fr = gfit.fitresult
        gnames = gfit.fit_params
        gp = gfit.resids.pdict
        U = gmodel.noise_basis(gp)
        pulls = {n: device_offset(gmodel[n].device_value,
                                  gtruth[n].device_value)
                 / gmodel[n].device_uncertainty for n in DD_PULL_PARAMS}
        rec.update(ntoas=gtoas.ntoas, n_fit=len(gnames),
                   noise_basis_shape=list(U.shape),
                   ecorr_block=list(gmodel.ecorr_block(gp)),
                   status=fr.status.name, iterations=fr.iterations,
                   rung=fr.rung, chi2=gchi2, dof=fr.dof,
                   chi2_per_dof=gchi2 / fr.dof, fit_cold_s=fit_s,
                   fit_info=gfit.fit_info, launches=gls_launches,
                   plain_delay_chains=plain["calls"], pulls=pulls,
                   peak_mem_bytes=torch.cuda.max_memory_allocated(),
                   device=str(gfit.device))
        gls_vals, gls_uncs = fit_state(gmodel, gnames)
        walls, per_fit, splits = [], [], []
        for _ in range(3):
            restore(gmodel, gstart)
            zero_counts()
            wf, _, w = gls_fit(torch, run.dev, gmodel, gtoas)
            walls.append(w)
            per_fit.append(counts())
            splits.append(dict(wf.fit_info["seconds"]))
        rec.update(fit_warm_s=median(walls), fit_walls_s=walls,
                   launches_per_warm_fit=per_fit, fit_warm_split_s=splits,
                   fit_warm_share={k: median([sp[k] / w for sp, w in
                                              zip(splits, walls)])
                                   for k in splits[0]})
    if gtoas.ntoas != run.ntoas or len(gnames) != run.nfit:
        raise AssertionError("not the full-width GLS configuration")
    if fr.status.name not in ("CONVERGED", "MAXITER"):
        raise AssertionError(f"GLS fit ended {fr.status.name}")
    if not 0.6 < gchi2 / fr.dof < 1.6:
        raise AssertionError(f"GLS fit chi2/dof {gchi2 / fr.dof}")
    bad = {n: v for n, v in pulls.items() if not abs(v) < PULL_MAX}
    if bad:
        raise AssertionError(f"GLS fit pulls {bad}")
    check_path_launches("GLS path", gls_launches)
    if plain["calls"]:
        raise AssertionError(f"{plain['calls']} plain delay chains on the "
                             "GLS path")

    # -- 7. the DDK slice: ecliptic astrometry and the DDK binary ----------
    from pint_tpu_torch.examples import (ddk_ecliptic_realistic_par,
                                         simulate_ddk_ecliptic_realistic)

    with phase("ddk_main_path", {}) as rec:
        t0 = time.perf_counter()
        ktruth, ksim = simulate_ddk_ecliptic_realistic(
            ntoas=run.ntoas, seed=0, dmx_bins=run.dmx_bins, device=run.dev)
        torch.cuda.synchronize()
        rec["simulate_s"] = time.perf_counter() - t0
        write_tim(run.ddk_tim, ksim)
        t0 = time.perf_counter()
        kmodel, ktoas = dd_load(torch, run.ddk_tim, run.dmx_bins,
                                perturb=DDK_PERTURB,
                                par=ddk_ecliptic_realistic_par)
        rec["setup_s"] = time.perf_counter() - t0
        kstart = snapshot(kmodel)
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        with plain_delays() as plain:
            kfit, kchi2, fit_s = dd_fit(torch, run.dev, kmodel, ktoas)
        ddk_launches = counts()
        fr = kfit.fitresult
        knames = kfit.fit_params
        pulls = {n: device_offset(kmodel[n].device_value,
                                  ktruth[n].device_value)
                 / kmodel[n].device_uncertainty for n in DDK_PULL_PARAMS}
        lin, nl = kmodel.partition_linear_params(knames)
        rec.update(ntoas=ktoas.ntoas, n_fit=len(knames), n_nonlinear=len(nl),
                   n_linear=len(lin),
                   components=[c for c in kmodel.components
                               if c.startswith(("Astrometry", "Binary"))],
                   status=fr.status.name, iterations=fr.iterations,
                   rung=fr.rung, chi2=kchi2, dof=fr.dof,
                   chi2_per_dof=kchi2 / fr.dof, fit_cold_s=fit_s,
                   **kfit.fit_info,
                   normal_matrix_condition=1.0 / kfit.fit_info["e_min"],
                   launches=ddk_launches, plain_delay_chains=plain["calls"],
                   pulls=pulls,
                   peak_mem_bytes=torch.cuda.max_memory_allocated(),
                   device=str(kfit.device))
        walls, ddk_per_fit = [], []
        for _ in range(3):
            restore(kmodel, kstart)
            wf = WLSFitter(ktoas, kmodel, device=run.dev)
            zero_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            wf.fit_toas(maxiter=DD_MAXITER)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            ddk_per_fit.append(counts())
        rec.update(fit_warm_s=median(walls), fit_walls_s=walls,
                   launches_per_warm_fit=ddk_per_fit)
    if ktoas.ntoas != run.ntoas or len(knames) != run.ddk_nfit:
        raise AssertionError("not the full-width DDK configuration")
    if fr.rung != "fused" or fr.status.name not in ("CONVERGED", "MAXITER"):
        raise AssertionError(f"DDK fit ended {fr.status.name} on {fr.rung}")
    if not 0.6 < kchi2 / fr.dof < 1.6:
        raise AssertionError(f"DDK fit chi2/dof {kchi2 / fr.dof}")
    bad = {n: v for n, v in pulls.items() if not abs(v) < PULL_MAX}
    if bad:
        raise AssertionError(f"DDK fit pulls {bad}")
    check_path_launches("DDK path", ddk_launches)
    if plain["calls"]:
        raise AssertionError(f"{plain['calls']} plain delay chains on the "
                             "DDK path")

    with phase("ddk_fit_profile", {}) as rec:
        kholder = {}

        def ksetup():
            restore(kmodel, kstart)
            kholder["f"] = WLSFitter(ktoas, kmodel, device=run.dev)
            torch.cuda.synchronize()

        rec.update(profile_grid(
            torch, lambda: kholder["f"].fit_toas(maxiter=DD_MAXITER),
            run.out_dir, out_name="ddk_fit_profile", setup=ksetup))

    with phase("ddk_reference", {}) as rec:
        with open(DDK_REF_JSON) as f:
            ref = json.load(f)
        rmodel, rtoas = dd_load(torch, DDK_REF_TIM, REF_DMX_BINS,
                                perturb=ref["perturb"],
                                par=ddk_ecliptic_realistic_par)
        PhaseChain.launches = 0
        rfit, rchi2, _ = dd_fit(torch, run.dev, rmodel, rtoas,
                                maxiter=ref["maxiter"])
        rv, ru = fit_state(rmodel, rfit.fit_params)
        dev, unc = fit_gaps(rv, ru, ref["values"], ref["uncertainties"])
        gap = abs(rchi2 - ref["chi2"]) / ref["chi2"]
        rec.update(ntoas=rtoas.ntoas, n_fit=len(rfit.fit_params),
                   maxiter=ref["maxiter"],
                   status=rfit.fitresult.status.name,
                   rung=rfit.fitresult.rung, chi2=rchi2,
                   chi2_ref=ref["chi2"], max_rel_chi2_gap=gap,
                   max_sigma_gap=dev, max_unc_rel_gap=unc,
                   ref_status=ref["status"], launches=PhaseChain.launches)
        if rfit.fit_params != ref["fit_params"] or not (
                dev <= FIT_SIGMA_TOL and unc <= UNC_TOL and gap <= CHI2_TOL
                and rec["launches"] > 0):
            raise AssertionError(
                f"DDK reference: {dev} sigma, {unc} unc, chi2 gap {gap}")

    # the other DD and ELL1 variants, each on its path's full-width TOAs
    variants = variant_fitters(torch, run, toas, dtoas)

    with phase("delay_chain", {}) as chain_rec:
        from pint_tpu_torch.kernels import delay_chain as dc

        errs = [check_delay_chain(torch, label, m, f, chain_rec)
                for label, m, f in (("j0740_grid", model, fitter),
                                    ("dd_fit", dmodel, dfit),
                                    ("gls_fit", gmodel, gfit),
                                    ("ddk_fit", kmodel, kfit), *variants)]
        chain_rec["timing"] = {}
        for label, m, f, points in (("gls_fit", gmodel, gfit, 1),
                                    ("j0740_grid", model, fitter,
                                     GRID_POINTS),
                                    ("ddk_fit", kmodel, kfit, 1)):
            chain_rec["timing"][label] = {}
            time_delay_chain(torch, m, f, points,
                             chain_rec["timing"][label])
        chain_rec["grid_tangent_vs_plain"] = {}
        tangent_vs_plain(torch, model, fitter, GRID_POINTS,
                         chain_rec["grid_tangent_vs_plain"])
        chain_rec["registers"] = chain_registers(
            kbuild.build_log("delay_chain"))
        chain_rec["max_abs_err"] = max(errs)

    with phase("phase_chain", {}) as pc_rec:
        errs = [check_phase_chain(torch, label, m, f, pc_rec)
                for label, m, f in (("j0740_grid", model, fitter),
                                    ("dd_fit", dmodel, dfit),
                                    ("gls_fit", gmodel, gfit),
                                    ("ddk_fit", kmodel, kfit), *variants)]
        pc_rec["timing"] = {}
        for label, m, f, points in (("gls_fit", gmodel, gfit, 1),
                                    ("j0740_grid", model, fitter,
                                     GRID_POINTS)):
            pc_rec["timing"][label] = {}
            time_phase_chain(torch, m, f, points, pc_rec["timing"][label])
        # the kDDK instantiation at the DDK path's shapes: its nonlinear
        # columns and all its columns
        pc_rec["timing"]["ddk_fit"] = {}
        time_phase_chain(torch, kmodel, kfit, 1, pc_rec["timing"]["ddk_fit"],
                         sets=("nonlinear", "all"))
        pc_rec["registers"] = chain_registers(
            kbuild.build_log("phase_chain"), "phase_chain")
        fused = ("phase_chain_primal", "phase_chain_tangent")
        pc_rec.update(
            max_abs_frac_err=max(errs),
            launches={k: {"j0740_grid": grid_launches[k],
                          "dd_fit": dd_launches[k],
                          "gls_fit": gls_launches[k],
                          "ddk_ecl_fit": ddk_launches[k]}
                      for k in ON_PATHS + OFF_PATHS},
            launches_per_grid_call=grid_call_launches,
            launches_per_warm_dd_fit=[sum(f[k] for k in fused)
                                      for f in rec_dd_per_fit],
            launches_per_warm_gls_fit=[sum(f[k] for k in fused)
                                       for f in per_fit],
            launches_per_warm_ddk_fit=[sum(f[k] for k in fused)
                                       for f in ddk_per_fit])

    with phase("gls_card_vs_host", {}) as rec:
        # the final solve at the fitted point (the model holds the last
        # warm fit), on the card and on the CPU from the same assembly
        asm = build_whitened_assembly(gmodel, gfit.resids.batch, gnames,
                                      gfit.track_mode, include_offset=True)
        gp = gfit.resids.pdict
        with torch.no_grad():
            parts = asm.inline(torch.zeros(len(gnames), dtype=torch.float64,
                                           device=gfit.device), gp)
            noise = (gmodel.noise_basis(gp), gmodel.noise_weights(gp))
            esl = gmodel.ecorr_block(gp)
            card_args = (*parts, *noise, esl, len(gnames))
            # the host's noise basis from the params dict's blocks, as
            # pint_tpu's host solve takes it
            host_args = tuple(a.cpu() if isinstance(a, torch.Tensor) else a
                              for a in card_args)
            host_args = host_args[:4] + (torch.from_numpy(
                _host_noise_basis(gmodel, gp)),) + host_args[5:]
            outs = {"card": gls_solve(*card_args),
                    "host": gls_solve(*host_args)}
            card_ms = time_ms(torch, lambda: gls_solve(*card_args), reps=5)
            t0 = time.perf_counter()
            for _ in range(3):
                gls_solve(*host_args)
            host_ms = (time.perf_counter() - t0) / 3 * 1e3
        sd = {k: np.sqrt(np.diag(np.asarray(o["Sigma_n"].cpu(), np.float64)))
              / np.asarray(o["norms"].cpu(), np.float64)
              for k, o in outs.items()}
        dx = {k: np.asarray(o["dx"].cpu(), np.float64) for k, o in outs.items()}
        sig_gap = float(np.max(np.abs(dx["card"] - dx["host"]) / sd["host"]))
        unc_gap = float(np.max(np.abs(sd["card"] / sd["host"] - 1.0)))
        chi2_gap = abs(float(outs["card"]["chi2"])
                       / float(outs["host"]["chi2"]) - 1.0)
        # K6's least work for this solve: [M | U] read once, the coupling
        # block G_DK = D^T K and the Schur block's Gram (2 n m k each)
        n_rows = gfit.resids.batch.ntoas
        nk = len(gnames) + 1 + int(U.shape[1]) - (esl[1] - esl[0])
        nd = esl[1] - esl[0]
        ops = 2.0 * n_rows * nk * nd + 2.0 * n_rows * nk * nk
        nbytes = 8.0 * n_rows * (len(gnames) + 1 + int(U.shape[1]))
        t_ops, t_bytes = ops / PEAK_F64_MATMUL_PER_S, nbytes / MEM_BYTES_PER_S
        rec.update(solve_bound_ms=1e3 * max(t_ops, t_bytes),
                   solve_bound_by="operations" if t_ops >= t_bytes
                   else "bytes")
        rec.update(step_max_sigma_gap=sig_gap, unc_max_rel_gap=unc_gap,
                   chi2_rel_gap=chi2_gap, card_solve_ms=card_ms,
                   host_solve_ms=host_ms,
                   n_bad={k: int(o["n_bad"]) for k, o in outs.items()},
                   e_min={k: float(o["e_min"]) for k, o in outs.items()},
                   schur_columns=len(gnames) + 1 + int(U.shape[1])
                   - (esl[1] - esl[0]))
        if not (sig_gap <= FIT_SIGMA_TOL and unc_gap <= UNC_TOL
                and chi2_gap <= CHI2_TOL):
            raise AssertionError(f"GLS card vs host: {sig_gap} sigma, "
                                 f"{unc_gap} unc, chi2 {chi2_gap}")

    with phase("gls_fit_profile", {}) as rec:
        holder = {}

        def gsetup():
            restore(gmodel, gstart)
            from pint_tpu_torch.fitter import GLSFitter
            holder["f"] = GLSFitter(gtoas, gmodel, device=run.dev)
            torch.cuda.synchronize()

        rec.update(profile_grid(
            torch, lambda: holder["f"].fit_toas(maxiter=DD_MAXITER),
            run.out_dir, out_name="gls_fit_profile", setup=gsetup))

    with phase("gls_reference", {}) as rec:
        with open(GLS_REF_JSON) as f:
            ref = json.load(f)
        rmodel, rtoas = gls_load(torch, GLS_REF_TIM, REF_DMX_BINS,
                                 perturb=ref["perturb"])
        PhaseChain.launches = 0
        rfit, rchi2, _ = gls_fit(torch, run.dev, rmodel, rtoas)
        rv, ru = fit_state(rmodel, rfit.fit_params)
        dev, unc = fit_gaps(rv, ru, ref["values"], ref["uncertainties"])
        gap = abs(rchi2 - ref["chi2"]) / ref["chi2"]
        noise_gap = max(
            float(np.max(np.abs(rfit.noise_resids[k] - np.asarray(v)))
                  / np.std(v)) for k, v in ref["noise_resids"].items())
        rec.update(ntoas=rtoas.ntoas, n_fit=len(rfit.fit_params),
                   status=rfit.fitresult.status.name,
                   rung=rfit.fitresult.rung, chi2=rchi2,
                   chi2_ref=ref["chi2"], max_rel_chi2_gap=gap,
                   max_sigma_gap=dev, max_unc_rel_gap=unc,
                   noise_resid_max_gap_of_rms=noise_gap,
                   ref_status=ref["status"], launches=PhaseChain.launches)
        if rfit.fit_params != ref["fit_params"] or not (
                dev <= FIT_SIGMA_TOL and unc <= UNC_TOL and gap <= CHI2_TOL
                and noise_gap <= NOISE_RESID_TOL and rec["launches"] > 0):
            raise AssertionError(
                f"GLS reference: {dev} sigma, {unc} unc, chi2 gap {gap}, "
                f"noise {noise_gap}")

    # -- 8. the fitters Fitter.auto picks, LM, Powell and the grid API ------
    new_paths = fitter_paths(
        torch, np, run, {"model": dmodel, "toas": dtoas, "truth": truth,
                         "start": start}, {"fitter": fitter, "grid": grid})

    # -- 9. the wideband fit and the DM family -------------------------------
    wb_paths = wideband_paths(torch, np, run, {"grid_toas": toas,
                                               "dd_toas": dtoas})

    # -- 10. the chromatic noise fit and the chromatic family ----------------
    chrom_paths = chromatic_paths(torch, np, run, {"grid_toas": toas,
                                                   "dd_toas": dtoas})

    # -- 11. the spider-binary fit and the orbit family ---------------------
    orb_paths = orbit_paths(torch, np, run, {})

    def by_path(name):
        by = {"j0740_grid": grid_launches[name], "dd_fit": dd_launches[name],
              "gls_fit": gls_launches[name],
              "ddk_ecl_fit": ddk_launches[name],
              **{k: v[name] for k, v in new_paths["launches"].items()},
              **{k: v[name] for k, v in wb_paths["launches"].items()},
              **{k: v[name] for k, v in chrom_paths["launches"].items()},
              **{k: v[name] for k, v in orb_paths["launches"].items()}}
        return {"launches": sum(by.values()), "launches_by_path": by}

    def at_path(kernel, part, timing, labels):
        """A kernel's time and bound at one path's shapes (1 θ set; the
        tangent at all its fit parameters' lanes), on each layout of
        ``labels`` in ``timing``."""
        got = {}
        for label in labels:
            t = timing[kernel][label]
            if part == "primal":
                t = t["primal"]
                ms = t["device_ms"] if kernel == "delay_chain" \
                    else first_time(t)
            else:
                t = max(t["tangent"].values(), key=lambda x: x["lanes"])
                ms = t["ms"] if kernel == "delay_chain" else first_time(t)
            got[label] = {"theta_sets": 1, "lanes": t.get("lanes"),
                          "ms": ms, "bound_ms": t["bound_ms"],
                          "bound_by": t["bound_by"]}
        return got

    def at_wideband(kernel, part):
        """At the wideband path's shapes: its layout, and the DM family's
        costliest (SWM 1's quadrature)."""
        return at_path(kernel, part, wb_paths["timing"],
                       ("wideband", "DMF_DD_SWM1"))

    def at_chromatic(kernel, part):
        """At the chromatic path's shapes: its layout, and the WaveX
        family's."""
        return at_path(kernel, part, chrom_paths["timing"],
                       ("chromatic", "wavex"))

    def at_orbit(kernel, part):
        """At the spider path's shapes: its layout, and the layout that
        runs every family's terms."""
        return at_path(kernel, part, orb_paths["timing"],
                       ("spider", "ORB_MIXED"))

    grid_t = chain_rec["timing"]["j0740_grid"]
    grid_lin = max(grid_t["tangent"].values(), key=lambda t: t["lanes"])
    fused_t = pc_rec["timing"]["j0740_grid"]
    fused_lin = max(fused_t["tangent"].values(), key=lambda t: t["lanes"])
    ddk_t = pc_rec["timing"]["ddk_fit"]
    ddk_all = max(ddk_t["tangent"].values(), key=lambda t: t["lanes"])
    return [{
        "name": "qs_phase_frac", "route": "cuda",
        "source": "pint_tpu_torch/csrc/qs_phase.cu",
        "replaces": "pint_tpu/models/spindown.py:29",
        **by_path("qs_phase_frac"),
        "fused_on_the_paths_into": "phase_chain_primal",
        "max_abs_err": kernel_rec["max_abs_frac_err"],
        "ms": kernel_rec["ms"], "plain_ms": kernel_rec["plain_ms"],
        "bound_ms": kernel_rec["bound_ms"],
        "bound_by": kernel_rec["bound_by"], "library_ms": None}, {
        "name": "kepler_E", "route": "cuda",
        "source": "pint_tpu_torch/csrc/kepler.cu",
        "replaces": "pint_tpu/models/binary_orbits.py:49",
        **by_path("kepler_E"),
        "solved_on_the_paths_by": "delay_chain",
        "max_abs_err": kepler_rec["max_abs_err"],
        "ms": kepler_rec["ms"], "plain_ms": kepler_rec["plain_ms"],
        "bound_ms": kepler_rec["bound_ms"],
        "bound_by": kepler_rec["bound_by"], "library_ms": None}, {
        "name": "delay_chain_primal", "route": "cuda",
        "source": "pint_tpu_torch/csrc/delay_chain.cu",
        "replaces": "pint_tpu/models/astrometry.py:76",
        **by_path("delay_chain_primal"),
        "fused_on_the_paths_into": "phase_chain_primal",
        "max_abs_err": max(chain_rec["max_abs_err"],
                           wb_paths["max_abs_delay_err_s"],
                           chrom_paths["max_abs_delay_err_s"],
                           orb_paths["max_abs_delay_err_s"]),
        "theta_sets": GRID_POINTS,
        "ms": grid_t["primal"]["device_ms"],
        "plain_ms": grid_t["primal"]["plain_ms"],
        "bound_ms": grid_t["primal"]["bound_ms"],
        "bound_by": grid_t["primal"]["bound_by"], "library_ms": None,
        "dm_family": at_wideband("delay_chain", "primal"),
        "chromatic_family": at_chromatic("delay_chain", "primal"),
        "orbit_family": at_orbit("delay_chain", "primal")}, {
        "name": "delay_chain_tangent", "route": "cuda",
        "source": "pint_tpu_torch/csrc/delay_chain.cu",
        "replaces": "pint_tpu/models/astrometry.py:76",
        **by_path("delay_chain_tangent"),
        "fused_on_the_paths_into": "phase_chain_tangent",
        "max_abs_err": chain_rec["grid_tangent_vs_plain"]["max_abs_err"],
        "theta_sets": GRID_POINTS, "lanes": grid_lin["lanes"],
        "lanes_per_thread": grid_lin["lanes_per_thread"],
        "ms": grid_lin["ms"], "single_lane_ms": grid_lin["single_lane_ms"],
        "plain_ms": chain_rec["grid_tangent_vs_plain"]["plain_ms"],
        "bound_ms": grid_lin["bound_ms"], "bound_by": grid_lin["bound_by"],
        "library_ms": None,
        "dm_family": at_wideband("delay_chain", "tangent"),
        "chromatic_family": at_chromatic("delay_chain", "tangent"),
        "orbit_family": at_orbit("delay_chain", "tangent")}, {
        "name": "phase_chain_primal", "route": "cuda",
        "source": "pint_tpu_torch/csrc/phase_chain.cu",
        "replaces": "pint_tpu/models/spindown.py:29",
        **by_path("phase_chain_primal"),
        "max_abs_err": max(pc_rec["max_abs_frac_err"],
                           wb_paths["max_abs_frac_err"],
                           chrom_paths["max_abs_frac_err"],
                           orb_paths["max_abs_frac_err"]),
        "theta_sets": GRID_POINTS,
        "ms": first_time(fused_t["primal"]),
        "fused_chain_ms": fused_t["primal"]["fused_chain_ms"],
        "unfused_chain_ms": fused_t["primal"]["unfused_chain_ms"],
        "plain_ms": fused_t["primal"]["plain_ms"],
        "bound_ms": fused_t["primal"]["bound_ms"],
        "bound_by": fused_t["primal"]["bound_by"], "library_ms": None,
        "ddk_ecl_fit": {"theta_sets": 1, "ms": first_time(ddk_t["primal"]),
                        "bound_ms": ddk_t["primal"]["bound_ms"]},
        "dm_family": at_wideband("phase_chain", "primal"),
        "chromatic_family": at_chromatic("phase_chain", "primal"),
        "orbit_family": at_orbit("phase_chain", "primal")}, {
        "name": "phase_chain_tangent", "route": "cuda",
        "source": "pint_tpu_torch/csrc/phase_chain.cu",
        "replaces": "pint_tpu/models/spindown.py:29",
        **by_path("phase_chain_tangent"),
        "max_abs_err": fused_lin["max_abs_err_vs_plain"],
        "theta_sets": GRID_POINTS, "lanes": fused_lin["lanes"],
        "lanes_per_thread": fused_lin["lanes_per_thread"],
        "ms": first_time(fused_lin),
        "fused_chain_ms": fused_lin["fused_chain_ms"],
        "unfused_chain_ms": fused_lin["unfused_chain_ms"],
        "plain_ms": fused_lin["plain_ms"],
        "bound_ms": fused_lin["bound_ms"], "bound_by": fused_lin["bound_by"],
        "library_ms": None,
        "ddk_ecl_fit": {"theta_sets": 1, "lanes": ddk_all["lanes"],
                        "ms": first_time(ddk_all),
                        "bound_ms": ddk_all["bound_ms"]},
        "dm_family": at_wideband("phase_chain", "tangent"),
        "chromatic_family": at_chromatic("phase_chain", "tangent"),
        "orbit_family": at_orbit("phase_chain", "tangent")}]


def add_sim_scan(kernels: list, sim: dict) -> None:
    """The sim_scan path's launches in every kernel's count, and the fused
    kernels' times at its shapes: the primal over the random models' θ
    sets and at the scan's chunk width, the tangent at the chunk width."""
    for k in kernels:
        n = sim["launches"]["sim_scan"][k["name"]]
        k["launches"] += n
        k["launches_by_path"]["sim_scan"] = n
    by_name = {k["name"]: k for k in kernels}
    rm, chunk = sim["timing"]["random_models"], sim["timing"]["scan_chunk"]

    def at(t, sets):
        return {"theta_sets": sets, "lanes": t.get("lanes"),
                "ms": first_time(t), "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"]}

    width = chunk["theta_sets"]
    by_name["phase_chain_primal"]["sim_scan"] = {
        "random_models": at(rm["primal"], RANDOM_MODELS),
        "scan_chunk": at(chunk["primal"], width),
        "max_abs_err": sim["max_abs_frac_err"]}
    by_name["phase_chain_tangent"]["sim_scan"] = {
        "scan_chunk": {lanes: at(t, width)
                       for lanes, t in chunk["tangent"].items()}}


if __name__ == "__main__":
    if sys.argv[1:2] == ["--ptxas-reference"] and len(sys.argv) == 4:
        sys.exit(ptxas_reference(os.path.abspath(sys.argv[2]), sys.argv[3]))
    if len(sys.argv) > 1:
        print("usage: chip_smoke.py [--ptxas-reference CSRC OUT.json]",
              file=sys.stderr)
        sys.exit(2)
    sys.exit(main())
