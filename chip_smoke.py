#!/usr/bin/env python3
"""Smoke run of pint_tpu_torch on one NVIDIA GPU: the headline chi2 grid.

Run from the repository root, with no arguments::

    python3 chip_smoke.py

Phases, each printing one JSON line with its numbers and seconds:

1. device: the card (``nvidia-smi`` name and power limit);
2. build: every CUDA kernel of the package, compiled with nvcc for sm_90a;
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

Then a ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and, last,
``{"ok": true, "device": {...}}``.  Any failure raises: the script exits
non-zero without the last line.  It needs CUDA and the repository beside
it, and exits non-zero otherwise.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
TIM = os.path.join(REPO, "bench_cache", "j0740_bench_wide_12500.tim")
REF_TIM = os.path.join(REPO, "tests", "data", "j0740_sim_200.tim")
REF_JSON = os.path.join(REPO, "tests", "data", "j0740_sim_200_grid_chi2.json")
REF_DMX_BINS = 8
OUT_DIR = os.path.join(REPO, "chiprun_out")
GRID_M2 = (0.23, 0.25, 0.27)
GRID_SINI = (0.97, 0.99, 0.995)
SEED = 20261016

#: NVIDIA H100 SXM data sheet: HBM3 bandwidth, and the non-tensor-core
#: float32 and float64 rates (each add, sub, mul or conversion counted
#: as one operation)
MEM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float32": 67e12, "float64": 34e12}

#: bars of this run
FRAC_TOL_CYCLES = 1e-12
TANGENT_TOL = 1e-12
CHI2_TOL = 1e-6


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


def cuda_kernels(torch, fn, reps: int = 1):
    """The CUDA kernel events of ``reps`` calls of ``fn()`` (after one
    warm-up call), from the profiler's CUPTI trace, and the wall time of
    those calls.  Device activity only: the host op events of an eager
    grid call number in the hundreds of thousands and take minutes to
    parse."""
    from torch.profiler import ProfilerActivity, profile

    fn()
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
            ("eigh", ("sytrd", "ormtr", "orgtr", "syevd", "stedc", "steqr",
                      "larf", "syhemv", "lansy")),
            ("copies", ("Memcpy", "Memset")),
            ("reductions", ("reduce",)),
            ("gemm", ("gemm", "Gemm", "xmma")))


def profile_grid(torch, fn, top: int = 8) -> dict:
    """One warm call of ``fn()`` under torch.profiler: its wall time, the
    device time summed over its CUDA kernels, the device's idle share of
    the wall time, the number of kernels, their time by family, and the
    kernels that take the most device time.  The full list goes to
    chiprun_out/."""
    kernels, wall = cuda_kernels(torch, fn)
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
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "grid_profile.json"), "w") as f:
        json.dump([{"name": k, "count": n, "ms": t * 1e-3}
                   for k, (n, t) in ranked], f, indent=1)
    return {"wall_s": wall, "device_busy_s": busy_us * 1e-6,
            "device_idle_share": 1.0 - busy_us * 1e-6 / wall,
            "cuda_kernels": len(kernels),
            "families": {f: {"count": c, "ms": ms}
                         for f, (c, ms) in families.items()},
            "top_kernels": [{"name": k[:80], "count": n, "ms": t * 1e-3}
                            for k, (n, t) in ranked[:top]]}


def count_ops(torch, fn):
    """Elementwise arithmetic operations of ``fn()`` by result dtype: one
    per output element of every add/sub/mul/div/neg/round/conversion the
    plain version dispatches."""
    from torch.utils._python_dispatch import TorchDispatchMode

    arith = {"add", "sub", "mul", "div", "neg", "round", "rsub",
             "_to_copy", "where", "isnan"}
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


def load(torch, tim: str, dmx_bins: int = 70):
    """par + tim -> (model, toas, WLSFitter) on the card, M2/SINI frozen,
    as a user builds them."""
    import warnings

    from pint_tpu_torch.examples import j0740_realistic_par
    from pint_tpu_torch.fitter import WLSFitter
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.toa import get_TOAs

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        model = get_model(j0740_realistic_par(dmx_bins=dmx_bins).splitlines())
        toas = get_TOAs(tim, model=model)
    model.M2.frozen = True
    model.SINI.frozen = True
    fitter = WLSFitter(toas, model)
    torch.cuda.synchronize()
    return model, toas, fitter


def check_kernel(torch, np, model, fitter, grid, rec: dict) -> None:
    """qs_phase_frac against its plain version on the rows of the grid:
    outputs, tangents, TZR words, times, bound."""
    from pint_tpu_torch.gridutils import grid_in_axes, stack_grid_pdict
    from pint_tpu_torch.kernels.qs_phase import (PhaseSpec, QSPhaseFrac,
                                                 qs_phase_frac)

    dev = torch.device("cuda")
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

    k_frac, k_freq, k_dt = QSPhaseFrac.call(spec, shift, dF, other)
    p_frac, p_freq, p_dt = spec.plain(shift, dF, other)
    torch.cuda.synchronize()
    frac_err = float(torch.max(torch.abs(k_frac - p_frac)))
    rec.update(rows=G * N, G=G, N=N, K=K, max_abs_frac_err=frac_err,
               frac_bit_equal=bool(torch.equal(k_frac, p_frac)),
               max_rel_freq_err=float(torch.max(
                   torch.abs(k_freq - p_freq) / torch.abs(p_freq))),
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
    a_tan = p_freq * ts + to
    pk = p_dt
    for k in range(K):
        a_tan = a_tan + pk * td[:, k, None]
        pk = pk * p_dt / (k + 2.0)
    scale = torch.abs(a_tan)
    rel_rule = float(torch.max(torch.abs(k_tan - a_tan) / scale))
    rel_words = float(torch.max(torch.abs(k_tan - w_tan) / scale))
    # what word-level autodiff can lose: the terms of the spin series
    # above F0 (the F1*dt part of freq), as in pint_tpu's jacfwd
    hi = torch.abs(p_freq - p_freq.new_tensor(
        float(f_w[0].double().sum()))) * torch.abs(ts)
    words_bound = float(torch.max((2.0 * hi + 1e-12 * scale) / scale))
    rec.update(tangent_max_rel_vs_rule=rel_rule,
               tangent_max_rel_vs_word_autodiff=rel_words,
               word_autodiff_bound=words_bound)
    if rel_rule > TANGENT_TOL:
        raise AssertionError(f"kernel tangent off by {rel_rule}")
    if rel_words > words_bound:
        raise AssertionError(
            f"kernel tangent vs word autodiff {rel_words} > {words_bound}")

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


def main() -> int:
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
    from pint_tpu_torch.kernels.qs_phase import QSPhaseFrac

    grid = {"M2": np.repeat(np.array(GRID_M2), 3),
            "SINI": np.tile(np.array(GRID_SINI), 3)}

    # -- 3. the kernel against its plain version, at the main path's shapes --
    with phase("qs_phase_frac", {}) as kernel_rec:
        t0 = time.perf_counter()
        model, _, fitter = load(torch, TIM)
        kernel_rec["setup_first_s"] = time.perf_counter() - t0
        check_kernel(torch, np, model, fitter, grid, kernel_rec)

    # -- 4. the main path, as a user drives it --------------------------------
    QSPhaseFrac.launches = 0
    with phase("main_path", {}) as rec:
        t0 = time.perf_counter()
        model, toas, fitter = load(torch, TIM)
        rec["setup_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        chi2 = grid_chisq_flat(fitter, grid, maxiter=2)
        torch.cuda.synchronize()
        rec["grid_cold_s"] = time.perf_counter() - t0
        launches = QSPhaseFrac.launches
        rec.update(ntoas=toas.ntoas, n_free=len(model.free_params),
                   n_fit=len(fitter.fit_params), grid_points=len(chi2),
                   chi2=chi2.tolist(), launches=launches,
                   device=str(fitter.device))
        # read after the count: residuals launch the kernel once more
        rec["prefit_rms_us"] = float(np.std(fitter.resids.time_resids)) * 1e6
        rec["pulse_period_us"] = 1e6 / float(model.F0.value)
    if launches <= 0:
        raise AssertionError("the main path never launched qs_phase_frac")
    if chi2.shape != (9,) or not np.all(np.isfinite(chi2)):
        raise AssertionError(f"bad grid chi2 {chi2}")
    if toas.ntoas != 12500 or len(fitter.fit_params) != 86:
        raise AssertionError("not the full-width configuration")

    with phase("grid_timing", {}) as rec:
        walls = []
        for _ in range(3):
            QSPhaseFrac.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            warm = grid_chisq_flat(fitter, grid, maxiter=2)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        rec.update(grid_warm_s=median(walls), grid_walls_s=walls,
                   launches_per_grid_call=QSPhaseFrac.launches,
                   max_abs_chi2_change=float(np.max(np.abs(warm - chi2))),
                   peak_mem_bytes=torch.cuda.max_memory_allocated())

    with phase("grid_profile", {}) as rec:
        rec.update(profile_grid(torch, lambda: grid_chisq_flat(
            fitter, grid, maxiter=2)))

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
        _, rtoas, rfit = load(torch, REF_TIM, dmx_bins=REF_DMX_BINS)
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

    emit({"kernels": [{
        "name": "qs_phase_frac", "route": "cuda",
        "source": "pint_tpu_torch/csrc/qs_phase.cu",
        "replaces": "pint_tpu/models/spindown.py:29",
        "launches": launches, "max_abs_err": kernel_rec["max_abs_frac_err"],
        "ms": kernel_rec["ms"], "plain_ms": kernel_rec["plain_ms"],
        "bound_ms": kernel_rec["bound_ms"],
        "bound_by": kernel_rec["bound_by"], "library_ms": None}]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
