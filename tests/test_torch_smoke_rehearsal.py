"""A CPU rehearsal of ``chip_smoke.py``: every phase, at small size.

``chip_smoke.py`` runs only on a card.  Here its ``main()`` runs on the
CPU at the 200-TOA sizes (a ``chip_smoke.Run`` passed in), with the
card-only calls (events, synchronize, memory, ``nvidia-smi``, the
profiler's CUDA trace, the nvcc build, the delay kernel's own launches
and its auxiliary output, the count of plain delay chains that on the
card must be zero) stubbed, the kernels' plain runs counted as their
launches, and the fused rung taken as on CUDA.  It catches wrong paths,
shapes, names and control flow in the script before a chip call does; it
says nothing of the kernels' speed or of their CUDA source.
"""

import contextlib
import importlib.util
import json
import os
import time
import types

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


def test_chip_smoke_rehearsal(monkeypatch, tmp_path, capsys):
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_rehearsal", os.path.join(REPO, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from pint_tpu_torch.fitter import Fitter
    from pint_tpu_torch.kernels import build, delay_chain, kepler, qs_phase

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
    monkeypatch.setattr(Fitter, "_fused_ok", lambda self: True)
    real_q, real_k = qs_phase.run, kepler.run

    def q_run(s, a, b, c):
        qs_phase.QSPhaseFrac.launches += 1
        return real_q(s, a, b, c)

    def k_run(M, e):
        kepler.KeplerE.launches += 1
        return real_k(M, e)

    def chain(calc, p, batch):
        delay_chain.DelayChain.launches += 1
        return calc.delay_plain(p, batch)

    def chain_run(layout, theta, dtheta, rows):
        # the kernel's launches on CPU tensors, for the timing phase's
        # shapes only: zeros of the output's shape
        lead = theta.shape[:-1] if dtheta is None else \
            torch.broadcast_shapes(theta.shape[:-1], dtheta.shape[:-1])
        delay_chain.DelayChain.launches += 1
        return torch.zeros((*lead, rows[0].shape[0]), dtype=torch.float64)

    monkeypatch.setattr(qs_phase, "run", q_run)
    monkeypatch.setattr(kepler, "run", k_run)
    monkeypatch.setattr(delay_chain, "delay_chain", chain)
    monkeypatch.setattr(delay_chain, "run", chain_run)
    try:
        assert cs.main(cs.Run(
            dev="cpu", tim=cs.REF_TIM, ntoas=200, dmx_bins=8, nfit=24,
            dd_tim=str(tmp_path / "dd.tim"), gls_tim=str(tmp_path / "gls.tim"),
            out_dir=str(tmp_path / "out"))) == 0
    finally:
        qs_phase.QSPhaseFrac.launches = 0
        kepler.KeplerE.launches = 0
        delay_chain.DelayChain.launches = 0
    lines = capsys.readouterr().out.strip().splitlines()
    phases = [json.loads(ln)["phase"] for ln in lines if '"phase"' in ln]
    assert phases == ["device", "build", "qs_phase_frac", "main_path",
                      "grid_timing", "grid_profile", "plain_grid",
                      "reference", "dd_main_path", "kepler_E",
                      "dd_fused_vs_eager", "dd_fit_profile", "dd_reference",
                      "gls_main_path", "delay_chain", "gls_card_vs_host",
                      "gls_fit_profile", "gls_reference"]
    dd = next(json.loads(ln) for ln in lines if '"dd_main_path"' in ln)
    assert set(dd["fit_warm_share"]) == {"loop", "host_solve", "write_back",
                                         "other"}
    kernels = json.loads(lines[-3])["kernels"]
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"}
    assert [k["name"] for k in kernels] == ["qs_phase_frac", "kepler_E",
                                            "delay_chain"]
    assert all(keys <= set(k) for k in kernels)
    # kepler_E's Kepler solve runs inside delay_chain on the card's paths
    # (on the CPU the plain DD delay still calls it)
    on_paths = [k for k in kernels if k["name"] != "kepler_E"]
    assert all(k["launches"] > 0 for k in on_paths)
    assert all(set(k["launches_by_path"]) == {"j0740_grid", "dd_fit",
                                              "gls_fit"} for k in kernels)
    assert kernels[1]["solved_on_the_paths_by"] == "delay_chain"
    gls = next(json.loads(ln) for ln in lines if '"gls_main_path"' in ln)
    assert set(gls["fit_warm_share"]) == {"steps", "assemble", "solve",
                                          "write_back"}
    assert gls["noise_basis_shape"] == [200, 200 // 4 + 60]
    assert json.loads(lines[-1]) == {"ok": True, "device": {
        "platform": "gpu", "kind": "cpu-rehearsal", "count": 1}}
