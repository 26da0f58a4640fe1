#!/usr/bin/env python3
"""Smoke run of pint_tpu_torch on one NVIDIA GPU: the headline chi2 grid,
the full-width DD fit and the full-width GLS fit with a NANOGrav-style
noise model.

Run from the repository root, with no arguments::

    python3 chip_smoke.py

Phases, each printing one JSON line with its numbers and seconds:

1. device: the card (``nvidia-smi`` name and power limit);
2. build: every CUDA kernel of the package (``qs_phase``, ``kepler``,
   ``delay_chain``), compiled with nvcc for sm_90a, one nvcc process per
   source at once;
3. qs_phase_frac: the kernel against its plain PyTorch version on the
   card, at the main path's shapes (the bench tim's 12,500 TOAs at the 9
   grid points): fractions, tangents, the TZR words mode, kernel and
   plain times, and the kernel's least possible time on this card;
4. main_path: ``get_model(j0740_realistic_par())`` ->
   ``get_TOAs(bench_cache/j0740_bench_wide_12500.tim)`` -> ``WLSFitter`` ->
   ``grid_chisq_flat`` over the bench's 3x3 M2/SINI grid (maxiter=2), with
   the kernels' launch counts zeroed just before and read just after;
   grid_timing: warm grid wall time (median of 3) and launches per call;
   grid_profile: one warm grid call under torch.profiler (device busy and
   idle share, kernel launches, the kernels that take the device time);
   plain_grid: the same grid with the phase chain run by the plain
   version on the card; chi2 must agree within 1e-6 relative;
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
   delay_chain: the kernel against the plain component delays on the card
   on the three paths' full-width models: delay within 1e-12 s, every
   jacfwd column within 1e-10 relative, the DD orbit's E bit-equal to the
   kepler_E kernel's; kernel and plain times, the least possible time on
   this card, launches per grid call, DD fit and GLS fit;
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

Then a ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and, last,
``{"ok": true, "device": {...}}``.  Any failure raises: the script exits
non-zero without the last line.  It needs CUDA and the repository beside
it, and exits non-zero otherwise.

``main(Run(...))`` runs the same phases on another device or at other
sizes (``tests/test_torch_smoke_rehearsal.py`` runs them on the CPU at
200 TOAs); with no arguments it runs on the card at full width.
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
DD_MAXITER = 3
#: the DD fit's start: offsets [par units] from the simulated truth, as
#: pint_tpu's DD round trip perturbs it (tests/test_binary_dd.py)
DD_PERTURB = {"PB": 1e-7, "A1": 3e-6, "ECC": 1e-6, "OM": 3e-4,
              "F0": 1e-10}
#: the parameters whose pulls test_recover_dd_orbit checks, but DM (70
#: DMX bins over the whole span make DM degenerate)
DD_PULL_PARAMS = ("F0", "F1", "PB", "A1", "T0", "ECC", "OM")
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


class Run(NamedTuple):
    """Where the phases run and at what size: the card and the full width
    of the paths (TOAs, DMX bins, fit parameters), the grid's tim, and
    where the DD and GLS tims and the profiles are written."""

    dev: str = "cuda"
    tim: str = TIM
    ntoas: int = 12500
    dmx_bins: int = 70
    nfit: int = 86
    dd_tim: str = DD_TIM
    gls_tim: str = GLS_TIM
    out_dir: str = OUT_DIR


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


@contextlib.contextmanager
def phase(name: str, out: dict):
    t0 = time.perf_counter()
    yield out
    out["seconds"] = time.perf_counter() - t0
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


def device_kernel_ms(torch, fn, name: str, reps: int = 20):
    """Mean device time [ms] per call of ``fn()`` of the CUDA kernels whose
    name contains ``name``; None if the trace holds none."""
    events, _ = cuda_kernels(torch, fn, reps)
    total_us = sum(ev.device_time_total for ev in events if name in ev.name)
    return total_us / reps / 1e3 if total_us > 0 else None


#: kernel families of the grid's device time, by kernel-name substring
#: (the rest is PyTorch's elementwise and indexing kernels)
FAMILIES = (("qs_phase_frac", ("qs_phase",)),
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
    return {"wall_s": wall, "device_busy_s": busy_us * 1e-6,
            "device_idle_share": 1.0 - busy_us * 1e-6 / wall,
            "cuda_kernels": len(kernels), "copies_by_direction": copies,
            "families": {f: {"count": c, "ms": ms}
                         for f, (c, ms) in families.items()},
            "top_kernels": [{"name": k[:80], "count": n, "ms": t * 1e-3}
                            for k, (n, t) in ranked[:top]]}


def count_ops(torch, fn, extra=()):
    """Elementwise arithmetic operations of ``fn()`` by result dtype: one
    per output element of every add/sub/mul/div/neg/round/conversion the
    plain version dispatches, and of the ops named in ``extra`` (each
    sin or cos counted as ONE operation, so the bound stays a lower
    bound)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    arith = {"add", "sub", "mul", "div", "neg", "round", "rsub",
             "_to_copy", "where", "isnan", *extra}
    counts = {}

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func.overloadpacket.__name__ in arith \
                    and isinstance(out, torch.Tensor):
                dt = str(out.dtype).replace("torch.", "")
                counts[dt] = counts.get(dt, 0) + out.numel()
            return out

    with Count():
        fn()
    return counts


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
    ptzr = dict(p)
    ptzr["mask"] = {k: torch.as_tensor(np.asarray(v), device=dev)
                    for k, v in model.build_pdict_numpy(
                        None, model.make_tzr_toas_or_none())[1].items()}
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
    t_ops = sum(n / PEAK_OPS_PER_S.get(dt, PEAK_OPS_PER_S["float32"])
                for dt, n in ops.items())
    rec.update(ms=dev_ms if dev_ms is not None else call_ms,
               plain_ms=plain_ms, ops=ops, bytes=nbytes,
               bytes_ms=1e3 * t_bytes, ops_ms=1e3 * t_ops,
               bound_ms=1e3 * max(t_bytes, t_ops),
               bound_by="operations" if t_ops >= t_bytes else "bytes")


def dd_load(torch, tim: str, dmx_bins: int, perturb=None):
    """par + tim -> (model at the perturbed start, toas) of the DD
    configuration, as a user loads them."""
    import warnings

    from pint_tpu_torch.examples import dd_realistic_par
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.toa import get_TOAs

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        model = get_model(dd_realistic_par(
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


def dd_fit(torch, dev: str, model, toas, eager: bool = False):
    """A fresh ``WLSFitter`` on ``dev`` and its ``fit_toas(maxiter=3)``
    (or the eager rung), timed around the fit with a synchronize."""
    import warnings

    from pint_tpu_torch.fitter import WLSFitter

    fitter = WLSFitter(toas, model, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        chi2 = fitter._fit_eager(maxiter=DD_MAXITER) if eager else \
            fitter.fit_toas(maxiter=DD_MAXITER)
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
    t_ops = sum(n / PEAK_OPS_PER_S.get(dt, PEAK_OPS_PER_S["float32"])
                for dt, n in ops.items())
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
    if calc.chain_layout.cfg[1] == dc.DD:
        _, aux = chain_aux(calc, p, b)
        out["E_bit_equal_to_kepler_E"] = bool(torch.equal(
            kepler_E_op(aux[0].contiguous(), aux[1].contiguous()), aux[2]))
    rec[label] = out
    if not (err <= DELAY_TOL_S and out["max_rel_column_err"] <= COLUMN_TOL
            and out.get("E_bit_equal_to_kepler_E", True)):
        raise AssertionError(f"delay_chain vs plain on {label}: {out}")
    return err


def time_delay_chain(torch, model, fitter, lanes, rec: dict) -> None:
    """The delay_chain kernel's device time at one path's shapes: the
    primal launch and the tangent launch at each lane count of the path's
    jacfwds; the plain version's time; the least possible time of the
    primal on this card (bytes and operations of the plain version, the
    Kepler solve's counted through its plain version)."""
    from pint_tpu_torch.kernels import delay_chain as dc
    from pint_tpu_torch.models import binary_dd
    from pint_tpu_torch.models.binary_orbits import kepler_E

    r = fitter.resids
    p, b, calc = r.pdict, r.batch, model.calc
    lay = calc.chain_layout
    rows = [t.contiguous() for t in dc.row_inputs(lay, p, b)]
    with torch.no_grad():
        theta = lay.theta(p)

    def primal():
        return dc.DelayChain.apply(theta, lay, *rows)

    gen = torch.Generator(device="cpu").manual_seed(SEED)
    rec["primal_call_ms"] = time_ms(torch, primal)
    rec["primal_device_ms"] = device_kernel_ms(torch, primal,
                                               "delay_chain_primal")
    tangent = {}
    for L in lanes:
        dth = torch.randn(L, lay.P, generator=gen,
                          dtype=torch.float64).to(theta.device)
        th = theta.expand(L, lay.P)

        def tan():
            return dc.DelayChainTangent.apply(th, dth, lay, *rows)

        tangent[str(L)] = device_kernel_ms(torch, tan, "delay_chain_tangent")
    rec["tangent_device_ms_by_lanes"] = tangent
    with torch.no_grad():
        rec["plain_ms"] = time_ms(
            torch, lambda: calc.delay_plain(p, b), reps=5)
        real = binary_dd.kepler_E_op
        binary_dd.kepler_E_op = kepler_E
        try:
            ops = count_ops(torch, lambda: calc.delay_plain(p, b), extra=(
                "sin", "cos", "log", "sqrt", "atan2", "floor", "clamp",
                "pow", "exp", "isfinite"))
        finally:
            binary_dd.kepler_E_op = real
    N = b.ntoas
    nbytes = (sum(t.numel() * t.element_size() for t in rows)
              + theta.numel() * 8 + N * 8)
    t_bytes = nbytes / MEM_BYTES_PER_S
    t_ops = sum(n / PEAK_OPS_PER_S.get(dt, PEAK_OPS_PER_S["float32"])
                for dt, n in ops.items())
    rec.update(ms=rec["primal_device_ms"] if rec["primal_device_ms"]
               is not None else rec["primal_call_ms"],
               ops=ops, bytes=nbytes, bytes_ms=1e3 * t_bytes,
               ops_ms=1e3 * t_ops, bound_ms=1e3 * max(t_bytes, t_ops),
               bound_by="operations" if t_ops >= t_bytes else "bytes")


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

    from pint_tpu_torch.gridutils import grid_chisq_flat
    from pint_tpu_torch.kernels import qs_phase
    from pint_tpu_torch.kernels.delay_chain import DelayChain
    from pint_tpu_torch.kernels.qs_phase import QSPhaseFrac

    grid = {"M2": np.repeat(np.array(GRID_M2), 3),
            "SINI": np.tile(np.array(GRID_SINI), 3)}

    # -- 3. the kernel against its plain version, at the main path's shapes --
    with phase("qs_phase_frac", {}) as kernel_rec:
        t0 = time.perf_counter()
        model, _, fitter = load(torch, run.dev, run.tim, run.dmx_bins)
        kernel_rec["setup_first_s"] = time.perf_counter() - t0
        check_kernel(torch, np, model, fitter, grid, kernel_rec)

    # -- 4. the main path, as a user drives it --------------------------------
    QSPhaseFrac.launches = 0
    DelayChain.launches = 0
    with phase("main_path", {}) as rec:
        t0 = time.perf_counter()
        model, toas, fitter = load(torch, run.dev, run.tim, run.dmx_bins)
        rec["setup_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        chi2 = grid_chisq_flat(fitter, grid, maxiter=2)
        torch.cuda.synchronize()
        rec["grid_cold_s"] = time.perf_counter() - t0
        launches = QSPhaseFrac.launches
        grid_chain = DelayChain.launches
        rec.update(ntoas=toas.ntoas, n_free=len(model.free_params),
                   n_fit=len(fitter.fit_params), grid_points=len(chi2),
                   chi2=chi2.tolist(), launches={
                       "qs_phase_frac": launches, "delay_chain": grid_chain},
                   device=str(fitter.device))
        # read after the count: residuals launch the kernel once more
        rec["prefit_rms_us"] = float(np.std(fitter.resids.time_resids)) * 1e6
        rec["pulse_period_us"] = 1e6 / float(model.F0.value)
    if launches <= 0 or grid_chain <= 0:
        raise AssertionError("the main path skipped a kernel: "
                             f"qs_phase_frac {launches}, delay_chain "
                             f"{grid_chain}")
    if chi2.shape != (9,) or not np.all(np.isfinite(chi2)):
        raise AssertionError(f"bad grid chi2 {chi2}")
    if toas.ntoas != run.ntoas or len(fitter.fit_params) != run.nfit:
        raise AssertionError("not the full-width configuration")

    with phase("grid_timing", {}) as rec:
        walls = []
        for _ in range(3):
            QSPhaseFrac.launches = 0
            DelayChain.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            warm = grid_chisq_flat(fitter, grid, maxiter=2)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        grid_call_launches = {"qs_phase_frac": QSPhaseFrac.launches,
                              "delay_chain": DelayChain.launches}
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

    # the same grid with the phase chain run by the plain version
    with phase("plain_grid", {}) as rec:
        real_run = qs_phase.run
        qs_phase.run = lambda s, a, b, c: s.plain(a, b, c)
        try:
            QSPhaseFrac.launches = 0
            t0 = time.perf_counter()
            chi2_plain = grid_chisq_flat(fitter, grid, maxiter=2)
            torch.cuda.synchronize()
            rec["grid_plain_s"] = time.perf_counter() - t0
            rec["launches"] = QSPhaseFrac.launches
        finally:
            qs_phase.run = real_run
        gap = float(np.max(np.abs(chi2 - chi2_plain) / np.abs(chi2_plain)))
        rec.update(chi2_plain=chi2_plain.tolist(), max_rel_chi2_gap=gap)
        if rec["launches"] != 0 or not gap <= CHI2_TOL:
            raise AssertionError(f"plain grid chi2 gap {gap}")

    # a small set with a pint_tpu reference, on the card
    with phase("reference", {}) as rec:
        with open(REF_JSON) as f:
            ref = json.load(f)
        _, rtoas, rfit = load(torch, run.dev, REF_TIM, REF_DMX_BINS)
        QSPhaseFrac.launches = 0
        rchi2 = grid_chisq_flat(rfit, {k: np.asarray(v) for k, v in
                                       ref["grid"].items()},
                                maxiter=ref["maxiter"])
        want = np.asarray(ref["chi2"])
        gap = float(np.max(np.abs(rchi2 - want) / want))
        rec.update(ntoas=rtoas.ntoas, n_fit=len(rfit.fit_params),
                   chi2=rchi2.tolist(), chi2_ref=want.tolist(),
                   ref_kernel=ref["kernel"], max_rel_chi2_gap=gap,
                   launches=QSPhaseFrac.launches,
                   prefit_rms_us=float(np.std(
                       rfit.resids.time_resids)) * 1e6)
        if rfit.fit_params != ref["fit_params"] or not gap <= CHI2_TOL \
                or rec["launches"] <= 0:
            raise AssertionError(f"reference grid chi2 gap {gap}")

    # -- 5. the DD slice: simulate -> tim -> fit_toas, as a user drives it ----
    from pint_tpu_torch.examples import simulate_dd_realistic
    from pint_tpu_torch.fitter import WLSFitter, build_wls_step
    from pint_tpu_torch.kernels.kepler import KeplerE
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
        QSPhaseFrac.launches = 0
        KeplerE.launches = 0
        DelayChain.launches = 0
        t0 = time.perf_counter()
        dfit, dchi2, fit_s = dd_fit(torch, run.dev, dmodel, dtoas)
        rec.update(fit_cold_s=fit_s,
                   fitter_and_fit_s=time.perf_counter() - t0)
        # the Kepler solve of the DD orbit runs inside the delay_chain
        # kernel on this path, so kepler_E itself is not launched here
        dd_launches = {"kepler_E": KeplerE.launches,
                       "qs_phase_frac": QSPhaseFrac.launches,
                       "delay_chain": DelayChain.launches}
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
            QSPhaseFrac.launches = 0
            KeplerE.launches = 0
            DelayChain.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            wchi2 = wf.fit_toas(maxiter=DD_MAXITER)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            per_fit.append({"kepler_E": KeplerE.launches,
                            "qs_phase_frac": QSPhaseFrac.launches,
                            "delay_chain": DelayChain.launches})
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
    if dd_launches["delay_chain"] <= 0 or dd_launches["qs_phase_frac"] <= 0:
        raise AssertionError(f"the DD path skipped a kernel: {dd_launches}")

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
        DelayChain.launches = 0
        rfit, rchi2, _ = dd_fit(torch, run.dev, rmodel, rtoas)
        rv, ru = fit_state(rmodel, rfit.fit_params)
        dev, unc = fit_gaps(rv, ru, ref["values"], ref["uncertainties"])
        gap = abs(rchi2 - ref["chi2"]) / ref["chi2"]
        rec.update(ntoas=rtoas.ntoas, n_fit=len(rfit.fit_params),
                   status=rfit.fitresult.status.name,
                   rung=rfit.fitresult.rung, chi2=rchi2,
                   chi2_ref=ref["chi2"], max_rel_chi2_gap=gap,
                   max_sigma_gap=dev, max_unc_rel_gap=unc,
                   ref_status=ref["status"], launches=DelayChain.launches)
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
        QSPhaseFrac.launches = 0
        DelayChain.launches = 0
        with plain_delays() as plain:
            gfit, gchi2, fit_s = gls_fit(torch, run.dev, gmodel, gtoas)
        gls_launches = {"qs_phase_frac": QSPhaseFrac.launches,
                        "delay_chain": DelayChain.launches}
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
            QSPhaseFrac.launches = 0
            DelayChain.launches = 0
            wf, _, w = gls_fit(torch, run.dev, gmodel, gtoas)
            walls.append(w)
            per_fit.append({"qs_phase_frac": QSPhaseFrac.launches,
                            "delay_chain": DelayChain.launches})
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
    if gls_launches["delay_chain"] <= 0 or gls_launches["qs_phase_frac"] <= 0 \
            or plain["calls"]:
        raise AssertionError(f"the GLS path skipped a kernel: {gls_launches}"
                             f", {plain['calls']} plain delay chains")

    with phase("delay_chain", {}) as chain_rec:
        errs = [check_delay_chain(torch, label, m, f, chain_rec)
                for label, m, f in (("j0740_grid", model, fitter),
                                    ("dd_fit", dmodel, dfit),
                                    ("gls_fit", gmodel, gfit))]
        lin, nl = gmodel.partition_linear_params(gnames)
        time_delay_chain(torch, gmodel, gfit, (len(nl), len(lin)),
                         chain_rec)
        chain_rec.update(
            max_abs_err=max(errs),
            launches={"j0740_grid": grid_chain,
                      "dd_fit": dd_launches["delay_chain"],
                      "gls_fit": gls_launches["delay_chain"]},
            launches_per_grid_call=grid_call_launches["delay_chain"],
            launches_per_warm_dd_fit=[f["delay_chain"] for f in
                                      rec_dd_per_fit],
            launches_per_warm_gls_fit=[f["delay_chain"] for f in per_fit])

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
        DelayChain.launches = 0
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
                   ref_status=ref["status"], launches=DelayChain.launches)
        if rfit.fit_params != ref["fit_params"] or not (
                dev <= FIT_SIGMA_TOL and unc <= UNC_TOL and gap <= CHI2_TOL
                and noise_gap <= NOISE_RESID_TOL and rec["launches"] > 0):
            raise AssertionError(
                f"GLS reference: {dev} sigma, {unc} unc, chi2 gap {gap}, "
                f"noise {noise_gap}")

    emit({"kernels": [{
        "name": "qs_phase_frac", "route": "cuda",
        "source": "pint_tpu_torch/csrc/qs_phase.cu",
        "replaces": "pint_tpu/models/spindown.py:29",
        "launches": launches + dd_launches["qs_phase_frac"]
        + gls_launches["qs_phase_frac"],
        "launches_by_path": {"j0740_grid": launches,
                             "dd_fit": dd_launches["qs_phase_frac"],
                             "gls_fit": gls_launches["qs_phase_frac"]},
        "max_abs_err": kernel_rec["max_abs_frac_err"],
        "ms": kernel_rec["ms"], "plain_ms": kernel_rec["plain_ms"],
        "bound_ms": kernel_rec["bound_ms"],
        "bound_by": kernel_rec["bound_by"], "library_ms": None}, {
        "name": "kepler_E", "route": "cuda",
        "source": "pint_tpu_torch/csrc/kepler.cu",
        "replaces": "pint_tpu/models/binary_orbits.py:49",
        "launches": dd_launches["kepler_E"],
        "launches_by_path": {"j0740_grid": 0,
                             "dd_fit": dd_launches["kepler_E"],
                             "gls_fit": 0},
        "solved_on_the_paths_by": "delay_chain",
        "max_abs_err": kepler_rec["max_abs_err"],
        "ms": kepler_rec["ms"], "plain_ms": kepler_rec["plain_ms"],
        "bound_ms": kepler_rec["bound_ms"],
        "bound_by": kepler_rec["bound_by"], "library_ms": None}, {
        "name": "delay_chain", "route": "cuda",
        "source": "pint_tpu_torch/csrc/delay_chain.cu",
        "replaces": "pint_tpu/models/astrometry.py:76",
        "launches": sum(chain_rec["launches"].values()),
        "launches_by_path": chain_rec["launches"],
        "max_abs_err": chain_rec["max_abs_err"],
        "ms": chain_rec["ms"], "plain_ms": chain_rec["plain_ms"],
        "bound_ms": chain_rec["bound_ms"],
        "bound_by": chain_rec["bound_by"], "library_ms": None}]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
