"""A CPU rehearsal of ``chip_smoke.py``: every phase, at small size.

``chip_smoke.py`` runs only on a card.  Here its ``main()`` runs on the
CPU at the 200-TOA sizes (a ``chip_smoke.Run`` passed in; the DDK path
in ecliptic coordinates, the DD and ELL1 variants, the noise-fitting
path that ``Fitter.auto`` picks, LM, the degraded chain, Powell, the
grid API, the wideband path and the DM family's variants, the chromatic
path and the chromatic family's variants, the spider path and the orbit
family's variants included; the chromatic fit,
whose dip 50 epochs do not constrain, may end DIVERGED here, and takes
the 200-TOA set's GP amplitudes), with
the
card-only calls (events, synchronize, memory, ``nvidia-smi``, the
profiler's CUDA trace, the nvcc build and its ptxas report, the delay
kernel's auxiliary output, the count of plain delay chains that on the
card must be zero) stubbed, the ``delay_chain`` and ``phase_chain``
kernels' launches run by their host builds (``csrc/*_host.cpp``, built
with g++; the test skips without it), the other kernels' plain runs
counted as their launches, and the fused rung taken as on CUDA; each
timing takes one timed call and one traced call, where the card takes
25 and 20.  It
catches wrong paths, shapes, names and control flow in the script
before a chip call does; it says nothing of the kernels' speed or of
their CUDA source.
"""

import contextlib
import ctypes
import importlib.util
import json
import os
import shutil
import time
import types

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _Event:
    def __init__(self, **_):
        self.t = 0.0

    def record(self):
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return (other.t - self.t) * 1e3


def _fake_kernels(torch_, fn, reps=1, setup=None):
    """cuda_kernels without a card: runs ``fn`` as the real one does and
    returns two stand-in kernel events with a long templated name."""
    if setup is not None:
        setup()
    fn()
    if setup is not None:
        setup()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    ev = types.SimpleNamespace(
        name="void at::native::kernel<double, " + "x" * 300 + ">(int)",
        device_time_total=1.0)
    return [ev, ev], max(time.perf_counter() - t0, 1e-9)


def _cpu_chain_aux(calc, p, batch):
    """chain_aux without a card: the plain delay, and M, e and E captured
    from the plain DD binary's Kepler solve."""
    from pint_tpu_torch.models import binary_dd

    seen = []
    real = binary_dd.kepler_E_op

    def capture(M, e):
        E = real(M, e)
        seen.append((M, torch.broadcast_to(e, M.shape), E))
        return E

    binary_dd.kepler_E_op = capture
    try:
        with torch.no_grad():
            d = calc.delay_plain(p, batch)
    finally:
        binary_dd.kepler_E_op = real
    return d, torch.stack(seen[0])


#: nvcc -Xptxas=-v output of the shape ptxas prints, for the register
#: report's parser
PTXAS_LOG = """\
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_125delay_chain_tangent_lanesILi2ELi4EEEvN7ptchain7RowDataEPKdS4_NS1_8ChainCfgEilPd' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_125delay_chain_tangent_lanesILi2ELi4EEEvN7ptchain7RowDataEPKdS4_NS1_8ChainCfgEilPd
    8 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 0 barriers, 512 bytes cmem[0]
ptxas info    : Function properties for __internal_trig_reduction_slowpathd
    40 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_118delay_chain_primalILi1EEEvN7ptchain7RowDataEPKdNS1_8ChainCfgEllPdS6_' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_118delay_chain_primalILi1EEEvN7ptchain7RowDataEPKdNS1_8ChainCfgEllPdS6_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 64 registers, used 0 barriers, 512 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_125phase_chain_tangent_lanesILi1ELi4EEEvN7ptchain7RowDataENS_11TangentDataEPKdS5_NS1_8ChainCfgEN12ptphasechain8PhaseCfgEilPd' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_125phase_chain_tangent_lanesILi1ELi4EEEvN7ptchain7RowDataENS_11TangentDataEPKdS5_NS1_8ChainCfgEN12ptphasechain8PhaseCfgEilPd
    16 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 512 bytes cmem[0]
"""


def _host_libs():
    """The host builds of the delay_chain and phase_chain kernels (g++,
    no FMA contraction, as the kernels are built; once per source hash,
    ``build.host_library``), loaded with ctypes."""
    from pint_tpu_torch.kernels import build, delay_chain, phase_chain

    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the kernels' row functions for "
                    "the host")
    libs = [ctypes.CDLL(build.host_library(name))
            for name in ("delay_chain_host", "phase_chain_host")]
    de, ph = libs
    vp, i64 = ctypes.c_void_p, ctypes.c_int64
    de.delay_chain_host.argtypes = [vp] * (len(delay_chain.ROWS) + 3) + [
        delay_chain.ChainCfg, i64, i64, i64, ctypes.c_int]
    ph.phase_chain_host.argtypes = [vp] * phase_chain.N_POINTERS + [
        phase_chain.PhCfg, phase_chain.PhaseCfg, i64, i64, i64, i64, i64,
        i64, ctypes.c_int]
    de.delay_chain_orbital_phase_host.argtypes = [vp] * (
        len(delay_chain.ROWS) + 2) + [delay_chain.ChainCfg, i64, i64]
    de.delay_chain_host.restype = ph.phase_chain_host.restype = ctypes.c_int
    de.delay_chain_orbital_phase_host.restype = ctypes.c_int

    class DelayLib:
        @staticmethod
        def delay_chain(*args):
            nptr = len(delay_chain.ROWS) + 4
            ptrs, (cfg, G, K, N, lpt, _stream) = args[:nptr], args[nptr:]
            assert ptrs[-1] is None
            return de.delay_chain_host(*ptrs[:-1], cfg, G, K, N, lpt)

        @staticmethod
        def delay_chain_orbital_phase(*args):
            return de.delay_chain_orbital_phase_host(*args[:-1])

    class PhaseLib:
        @staticmethod
        def phase_chain(*args):
            return ph.phase_chain_host(*args[:-1])

    return DelayLib, PhaseLib


#: the orbit family's layouts that orbit_chain holds here (on the card it
#: holds all of them; tests/test_torch_*_chain_host.py hold each here)
ORBIT_LAYOUTS = ("ORB_DD_FB", "ORB_NONE_PLANET", "ORB_BT_PIECES",
                 "ORB_MIXED")


def rehearsal_env(monkeypatch, tmp_path):
    """``chip_smoke`` loaded as a module, with the card-only calls stubbed,
    the delay_chain and phase_chain launches run by their host builds,
    the other kernels' plain runs counted as launches and the fused rung
    taken as on CUDA (see the module docstring)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_rehearsal", os.path.join(REPO, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from pint_tpu_torch.fitter import Fitter
    from pint_tpu_torch.kernels import (build, delay_chain, kepler,
                                        phase_chain, qs_phase)

    delay_lib, phase_lib = _host_libs()

    for name, value in (("is_available", lambda: True),
                        ("synchronize", lambda *a, **k: None),
                        ("get_device_name", lambda *a: "cpu-rehearsal"),
                        ("device_count", lambda: 1),
                        ("max_memory_allocated", lambda *a: 0),
                        ("reset_peak_memory_stats", lambda *a: None),
                        ("Event", _Event)):
        monkeypatch.setattr(torch.cuda, name, value)
    @contextlib.contextmanager
    def no_plain_count():
        yield {"calls": 0}

    for name, value in (("nvidia_smi_line", lambda: "cpu rehearsal, 0 W"),
                        ("cuda_kernels", _fake_kernels),
                        ("chain_aux", _cpu_chain_aux),
                        ("plain_delays", no_plain_count)):
        monkeypatch.setattr(cs, name, value)
    # chip_smoke points the host caches into its checkout unless they are
    # set: set them to where this process keeps them anyway, so that the
    # rehearsal reuses those caches and the environment is restored after
    cache = os.environ.get("PINT_TPU_CACHE") or os.path.join(
        os.path.expanduser("~"), ".cache", "pint_tpu")
    monkeypatch.setenv("PINT_TPU_CACHE", cache)
    monkeypatch.setenv("PINT_TPU_CLOCK_DIR",
                       os.environ.get("PINT_TPU_CLOCK_DIR",
                                      os.path.join(cache, "clock")))
    monkeypatch.setattr(build, "build_all", lambda *a, **k: {})
    monkeypatch.setattr(build, "build_log", lambda name: PTXAS_LOG)
    # the parent's ptxas report: the stand-in log's, so that the script's
    # comparison runs and finds nothing changed
    ref = tmp_path / "ptxas_reference.json"
    ref.write_text(json.dumps({"kernels": {
        k: cs.chain_registers(PTXAS_LOG, k)
        for k in ("delay_chain", "phase_chain")}}))
    monkeypatch.setattr(cs, "PTXAS_REFERENCE", str(ref))
    monkeypatch.setattr(Fitter, "_fused_ok", lambda self: True)
    real_q, real_k = qs_phase.run, kepler.run

    def q_run(s, a, b, c):
        qs_phase.QSPhaseFrac.launches += 1
        return real_q(s, a, b, c)

    def k_run(M, e):
        kepler.KeplerE.launches += 1
        return real_k(M, e)

    def chain(calc, p, batch):
        # the delay kernel's path as on CUDA, through its host build
        lay = calc.chain_layout
        return delay_chain.DelayChain.apply(
            lay.theta(p), lay, *delay_chain.row_inputs(lay, p, batch))

    class Stream:
        cuda_stream = 0

    monkeypatch.setattr(qs_phase, "run", q_run)
    monkeypatch.setattr(kepler, "run", k_run)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: Stream)
    monkeypatch.setattr(delay_chain, "_lib", lambda layout: delay_lib)
    monkeypatch.setattr(delay_chain, "delay_chain", chain)
    monkeypatch.setattr(delay_chain, "orbital_phase",
                        delay_chain.orbital_phase_kernel)
    monkeypatch.setattr(delay_chain, "run", lambda layout, theta, dtheta,
                        rows, lanes=None: delay_chain._launch(
                            layout, theta, dtheta, rows, lanes=lanes)[0])
    monkeypatch.setattr(phase_chain, "_lib", lambda spec: phase_lib)
    monkeypatch.setattr(phase_chain, "run", phase_chain._launch)
    monkeypatch.setattr(phase_chain, "phase_frac", phase_chain.fused)
    return cs


def reset_launches():
    """Every kernel's launch count back to 0."""
    from pint_tpu_torch.kernels import (delay_chain, kepler, phase_chain,
                                        qs_phase)

    for k in (qs_phase.QSPhaseFrac, kepler.KeplerE,
              delay_chain.DelayChain, delay_chain.DelayChainTangent,
              delay_chain.OrbitalPhase,
              phase_chain.PhaseChain, phase_chain.PhaseChainTangent,
              phase_chain.PhaseFamilyPrimal, phase_chain.PhaseFamilyTangent):
        k.launches = 0


def test_chip_smoke_rehearsal(monkeypatch, tmp_path, capsys):
    from pint_tpu_torch.examples import CHROM_NOISE_200
    from pint_tpu_torch.kernels import delay_chain

    cs = rehearsal_env(monkeypatch, tmp_path)
    # one timed call and one traced call per timing, where the card takes
    # 25 and 20: a CPU time is no measurement of the card
    time_ms, device_kernel_ms = cs.time_ms, cs.device_kernel_ms
    monkeypatch.setattr(cs, "time_ms",
                        lambda torch, fn, reps=25: time_ms(torch, fn, 1))
    monkeypatch.setattr(cs, "device_kernel_ms",
                        lambda torch, fn, name, reps=20: device_kernel_ms(
                            torch, fn, name, 1))
    try:
        assert cs.main(cs.Run(
            dev="cpu", tim=cs.REF_TIM, ntoas=200, dmx_bins=8, nfit=24,
            dd_tim=str(tmp_path / "dd.tim"), gls_tim=str(tmp_path / "gls.tim"),
            out_dir=str(tmp_path / "out"), ddk_tim=str(tmp_path / "ddk.tim"),
            ddk_nfit=26, noise_tim=str(tmp_path / "noise.tim"),
            wb_tim=str(tmp_path / "wb.tim"), wb_nfit=27,
            chrom_tim=str(tmp_path / "chrom.tim"), chrom_nfit=29,
            chrom_status=("CONVERGED", "DIVERGED"),
            chrom_noise=CHROM_NOISE_200,
            spider_tim=str(tmp_path / "spider.tim"), spider_nfit=33,
            orbit_layouts=ORBIT_LAYOUTS, paths=cs.EARLIER)) == 0
    finally:
        reset_launches()
    lines = capsys.readouterr().out.strip().splitlines()
    phases = [json.loads(ln)["phase"] for ln in lines if '"phase"' in ln]
    assert phases == ["device", "build", "qs_phase_frac", "main_path",
                      "grid_timing", "grid_profile", "plain_grid",
                      "reference", "dd_main_path", "kepler_E",
                      "dd_fused_vs_eager", "dd_fit_profile", "dd_reference",
                      "gls_main_path", "ddk_main_path", "ddk_fit_profile",
                      "ddk_reference",
                      "delay_chain", "phase_chain", "gls_card_vs_host",
                      "gls_fit_profile", "gls_reference", "auto_noise_fit",
                      "noise_fit_profile", "noise_lnlike_card_vs_cpu",
                      "auto_wls_fit", "lm_fit", "degraded_lm",
                      "fitter_reference", "grid_api", "wideband_main_path",
                      "wideband_profile", "wideband_reference",
                      "dm_family_chain", "chromatic_main_path",
                      "chromatic_profile", "chromatic_reference",
                      "chromatic_chain", "orbit_main_path", "orbit_profile",
                      "orbit_reference", "orbit_chain"]
    dd = next(json.loads(ln) for ln in lines if '"dd_main_path"' in ln)
    assert set(dd["fit_warm_share"]) == {"loop", "host_solve", "write_back",
                                         "other"}
    kernels = json.loads(lines[-3])["kernels"]
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"}
    assert [k["name"] for k in kernels] == [
        "qs_phase_frac", "kepler_E", "delay_chain_primal",
        "delay_chain_tangent", "phase_chain_primal", "phase_chain_tangent"]
    assert all(keys <= set(k) for k in kernels)
    # the paths run the fused phase chain alone: the delay chain, the
    # Kepler solve and the phase run inside its launches
    by_name = {k["name"]: k for k in kernels}
    assert all(by_name[n]["launches"] > 0
               for n in ("phase_chain_primal", "phase_chain_tangent"))
    assert all(by_name[n]["launches"] == 0 for n in (
        "qs_phase_frac", "delay_chain_primal", "delay_chain_tangent"))
    assert all(set(k["launches_by_path"]) == {
        "j0740_grid", "dd_fit", "gls_fit", "ddk_ecl_fit", "noise_fit",
        "auto_wls_fit", "lm_fit", "degraded_lm", "wideband_fit",
        "wideband_gls_fit", "wideband_lm_fit", "chromatic_fit",
        "spider_fit"}
        for k in kernels)
    assert all(by_name[n]["launches_by_path"]["wideband_fit"] > 0
               for n in ("phase_chain_primal", "phase_chain_tangent"))
    assert all(set(by_name[n]["dm_family"]) == {"wideband", "DMF_DD_SWM1"}
               for n in ("delay_chain_primal", "delay_chain_tangent",
                         "phase_chain_primal", "phase_chain_tangent"))
    assert all(by_name[n]["launches_by_path"]["noise_fit"] > 0
               for n in ("phase_chain_primal", "phase_chain_tangent"))
    assert all(by_name[n]["launches_by_path"]["ddk_ecl_fit"] > 0
               for n in ("phase_chain_primal", "phase_chain_tangent"))
    ddk = next(json.loads(ln) for ln in lines if '"ddk_main_path"' in ln)
    assert ddk["components"] == ["AstrometryEcliptic", "BinaryDDK"]
    assert (ddk["n_fit"], ddk["n_nonlinear"]) == (26, 12)
    assert ddk["plain_delay_chains"] == 0 and len(ddk["pulls"]) == 9
    assert kernels[1]["solved_on_the_paths_by"] == "delay_chain"
    # no profiler trace here: the fused kernels' times are their calls'
    assert all(isinstance(by_name[n]["ms"], float) and by_name[n][
        "bound_ms"] > 0 for n in ("phase_chain_primal", "phase_chain_tangent"))
    chain = next(rec for rec in map(json.loads, lines)
                 if rec.get("phase") == "delay_chain")
    assert chain["registers"] == {
        "DD/tangent_L4": {"stack_bytes": 8, "spill_store_bytes": 0,
                          "spill_load_bytes": 0, "registers": 168},
        "ELL1/primal": {"stack_bytes": 0, "spill_store_bytes": 0,
                        "spill_load_bytes": 0, "registers": 64}}
    assert all("profiler_retries" in json.loads(ln) for ln in lines
               if '"phase"' in ln)
    # the lanes of each path's jacfwds: its nonlinear and linear columns
    lanes = {"gls_fit": [10, 14], "j0740_grid": [10, 14],
             "ddk_fit": [12, 14]}
    for label, t in chain["timing"].items():
        assert sorted(int(k) for k in t["tangent"]) == lanes[label], label
        # a lane's tangent: float64 only (d dt is the kernel's analytic
        # one, not the quad-single words), its derivative factors shared
        assert set(t["ops_per_tangent_lane"]) == {"float64"}, label
        assert t["ops_shared_per_theta_set"]["float64"] > 0, label
        by_ops = t["speedup_vs_single_lane_by_ops"]
        assert 1.0 < by_ops["2"] < by_ops["4"] < by_ops["unbounded"], label
        for rec in t["tangent"].values():
            assert set(rec["device_ms_by_lanes_per_thread"]) == {
                "1", "2", "4"}
            assert 0 <= rec["ops_per_lane_zero_tangents_skipped"][
                "float64"] <= t["ops_per_tangent_lane"]["float64"], label
            assert rec["bound_by"] == "operations"
            assert len(rec["device_ms_by_lanes_per_thread"]["1"]) == 2
    from pint_tpu_torch.examples import VARIANTS

    paths = ["j0740_grid", "dd_fit", "gls_fit", "ddk_fit"] + [
        v for v in VARIANTS if v != "DDK_ECL"]
    assert all(all(chain[lab]["lanes_bit_equal_to_single_lane"].values())
               for lab in paths)
    fused = next(rec for rec in map(json.loads, lines)
                 if rec.get("phase") == "phase_chain")
    assert fused["registers"] == {
        "ELL1/tangent_L4": {"stack_bytes": 16, "spill_store_bytes": 8,
                            "spill_load_bytes": 8, "registers": 128}}
    for lab in paths:
        rec = fused[lab]
        assert all(all(v.values()) for v in
                   rec["primal_bit_equal_to_unfused"].values()), lab
        assert all(rec["tangents_bit_equal_to_unfused"].values()), lab
        assert all(rec["lanes_bit_equal_to_single_lane"].values()), lab
        assert rec["grid_jacfwd_launches"] == [1, 1], lab
        assert rec["tzr_words_bit_equal_to_unfused"], lab
    # the kDDK timings: its nonlinear columns and all 26, every L
    lanes["ddk_fit"] = [12, 26]
    for label, t in fused["timing"].items():
        assert sorted(int(k) for k in t["tangent"]) == lanes[label], label
        assert t["primal"]["bound_by"] == "operations", label
        for rec in t["tangent"].values():
            assert rec["bound_ms"] > 0 and rec["unfused_chain_ms"] > 0
            assert len(rec["device_ms_by_lanes_per_thread"]["4"]) == 2
    assert fused["launches_per_warm_dd_fit"][0] > 0
    gls = next(json.loads(ln) for ln in lines if '"gls_main_path"' in ln)
    assert set(gls["fit_warm_share"]) == {"steps", "assemble", "solve",
                                          "write_back"}
    assert gls["noise_basis_shape"] == [200, 200 // 4 + 60]
    noise = next(json.loads(ln) for ln in lines
                 if '"auto_noise_fit"' in ln)
    assert noise["fitter"] == "DownhillGLSFitter"
    assert (noise["n_fit"], noise["n_noise"]) == (24, 11)
    assert noise["phase_chain_backward_calls"] == 0
    assert len(noise["lbfgsb_evaluations"]) == 2
    assert len(noise["fit_walls_s"]) == 2
    recs = {rec["phase"]: rec for rec in
            (json.loads(ln) for ln in lines if '"phase"' in ln)}
    assert recs["auto_wls_fit"]["fitter"] == "DownhillWLSFitter"
    assert recs["degraded_lm"]["rung_statuses"]["eager"] == "NONFINITE"
    assert recs["degraded_lm"]["degraded_warnings"] >= 2
    assert recs["fitter_reference"]["failed"] == []
    assert all(recs["grid_api"]["bit_equal_to_flat"].values())
    wb = recs["wideband_main_path"]
    assert wb["fitter"] == "WidebandDownhillFitter"
    assert (wb["n_fit"], wb["n_noise"], wb["dm_rows"]) == (27, 3, 200)
    assert wb["phase_chain_backward_calls"] == 0
    assert len(wb["noise_fit_info"]) == 2 and wb["wb_fit_warm_s"] > 0
    assert wb["noise_basis_shape"] == [200, 200 // 4 + 60]
    assert len(wb["wideband_gls"]["fit_walls_s"]) == 3
    assert recs["wideband_reference"]["failed"] == []
    assert "copies_ms_by_direction" in recs["wideband_profile"]
    dmf = recs["dm_family_chain"]
    from pint_tpu_torch.examples import DM_FAMILY

    for lab in DM_FAMILY + ("wideband",):
        assert dmf["delay_chain"][lab]["delay_bit_equal"], lab
        assert all(dmf["phase_chain"][lab][
            "tangents_bit_equal_to_unfused"].values()), lab
    assert dmf["layouts"]["DMF_DD_SWM1"]["flags"] & 16384
    assert set(dmf["timing"]["phase_chain"]) == {"wideband", "DMF_DD_SWM1"}
    chrom = recs["chromatic_main_path"]
    assert chrom["fitter"] == "DownhillGLSFitter"
    assert (chrom["n_fit"], chrom["n_noise"]) == (29, 3)
    assert chrom["phase_chain_backward_calls"] == 0
    assert chrom["noise_basis_shape"] == [200, 200 // 4 + 180]
    assert all(chrom["launches"][n] > 0 for n in ("phase_chain_primal",
                                                  "phase_chain_tangent"))
    assert recs["chromatic_reference"]["failed"] == []
    chf = recs["chromatic_chain"]
    from pint_tpu_torch.examples import CHROM_FAMILY

    for lab in CHROM_FAMILY + ("wavex", "chromatic"):
        assert chf["delay_chain"][lab]["delay_bit_equal"], lab
        assert all(chf["phase_chain"][lab][
            "tangents_bit_equal_to_unfused"].values()), lab
    assert set(chf["timing"]["phase_chain"]) == {"chromatic", "wavex"}
    assert all(set(by_name[n]["chromatic_family"]) == {"chromatic", "wavex"}
               for n in ("delay_chain_primal", "delay_chain_tangent",
                         "phase_chain_primal", "phase_chain_tangent"))
    orb = recs["orbit_main_path"]
    assert orb["fitter"] == "DownhillWLSFitter" and orb["n_fit"] == 33
    assert orb["phase_chain_backward_calls"] == 0
    assert orb["planets_loaded"] == sorted(delay_chain.PLANETS)
    assert set(orb["pulls"]) == {
        "F0", "F1", "FB0", "FB1", "A1", "TASC", "EPS1", "EPS2",
        *[f"ORBWAVE{cs_}{k}" for cs_ in "CS" for k in range(4)]}
    assert orb["normal_matrix_condition"] > 1.0
    assert len(orb["fit_walls_s"]) == 2
    assert all(orb["launches"][n] > 0 for n in ("phase_chain_primal",
                                                "phase_chain_tangent"))
    assert recs["orbit_reference"]["failed"] == []
    assert recs["orbit_reference"]["spider"]["fitter"] == "DownhillWLSFitter"
    orc = recs["orbit_chain"]
    assert set(orc["layouts"]) == {*ORBIT_LAYOUTS, "spider"}
    for lab in ORBIT_LAYOUTS + ("spider",):
        assert orc["delay_chain"][lab]["delay_bit_equal"], lab
        assert all(orc["phase_chain"][lab][
            "tangents_bit_equal_to_unfused"].values()), lab
    flags = {lab: v["flags"] for lab, v in orc["layouts"].items()}
    assert flags["ORB_BT_PIECES"] & delay_chain.BT_PIECES
    assert flags["ORB_NONE_PLANET"] & delay_chain.PLANET_SHAPIRO
    assert flags["ORB_DD_FB"] & delay_chain.FB_ORBIT
    assert flags["ORB_MIXED"] & delay_chain.CM and \
        flags["ORB_MIXED"] & delay_chain.SOLAR_WIND
    assert orc["ptxas_changed_vs_parent"] == {}
    assert set(orc["timing"]["phase_chain"]) == {"spider", "ORB_MIXED"}
    assert all(set(by_name[n]["orbit_family"]) == {"spider", "ORB_MIXED"}
               for n in ("delay_chain_primal", "delay_chain_tangent",
                         "phase_chain_primal", "phase_chain_tangent"))
    assert all(by_name[n]["launches_by_path"]["spider_fit"] > 0
               for n in ("phase_chain_primal", "phase_chain_tangent"))
    assert json.loads(lines[-1]) == {"ok": True, "device": {
        "platform": "gpu", "kind": "cpu-rehearsal", "count": 1}}


#: (what the reference lists as moved, the kernel's ptxas now) -> whether
#: ``ptxas_vs_parent`` reports it as a change, and whether as moved
PTXAS_GATE_CASES = {
    "unlisted_kept": (False, "same", False, False),
    "unlisted_moved": (False, "other", True, False),
    "listed_moved": (True, "other", False, True),
    "listed_kept": (True, "same", True, False),
    "listed_missing": (True, None, True, False),
}


@pytest.mark.parametrize("case", sorted(PTXAS_GATE_CASES))
def test_ptxas_gate_moved_list_is_exact(tmp_path, monkeypatch, case):
    """chip_smoke's ptxas gate against the parent's report: a kernel the
    reference lists under ``moved`` must have moved, and every other
    kernel must have kept its ptxas."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_ptxas_gate", os.path.join(REPO, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    listed, now, changed, moved = PTXAS_GATE_CASES[case]
    then = {"registers": 128, "spill_load_bytes": 0,
            "spill_store_bytes": 0, "stack_bytes": 40}
    kernel = "DD+DM/tangent_L4"
    ref = tmp_path / "ptxas_reference.json"
    ref.write_text(json.dumps({
        "kernels": {"phase_chain": {kernel: then,
                                    "DD+DM/primal": then}},
        "moved": {"phase_chain": [kernel]} if listed else {}}))
    monkeypatch.setattr(cs, "PTXAS_REFERENCE", str(ref))
    got = {"same": then, "other": {**then, "registers": 142},
           None: None}[now]
    regs = {"phase_chain": {"DD+DM/primal": then}}
    if got is not None:
        regs["phase_chain"][kernel] = got
    into = {}
    out = cs.ptxas_vs_parent(regs, into)
    assert (kernel in out.get("phase_chain", {})) == changed
    assert (kernel in into.get("phase_chain", {})) == moved
    assert "DD+DM/primal" not in out.get("phase_chain", {})
    # without a ``moved`` dict a listed kernel that moved is left out
    assert cs.ptxas_vs_parent(regs) == out
