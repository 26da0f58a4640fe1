"""A CPU rehearsal of ``chip_smoke.py``'s sim_scan path alone.

The simulate-fit-scan path runs here on the CPU at 300 TOAs (the
headline's par with 8 DMX bins, 24 fit parameters; a 3 x 3 M2/SINI grid
in chunks of 2 points), in the environment of
``tests/test_torch_smoke_rehearsal.py`` (the card-only calls stubbed, the
delay_chain and phase_chain launches run by their host builds): the
simulation, the fit, the scan whole and in chunks with its checkpoint,
the SIGTERM and resume, the retry and the reroute, the random models and
the fused primal at their 100 θ sets.  The timings take one timed call
(``time_ms``) and one traced call (``device_kernel_ms``) each, where the
card takes 25 and 20: here they time the host, and every call of the
path still runs.  It has a file of its own so that, under ``--dist
loadfile``, it runs beside the other paths' rehearsal and not after it.
"""

import json

from test_torch_smoke_rehearsal import rehearsal_env, reset_launches


def test_chip_smoke_rehearsal_sim_scan(monkeypatch, tmp_path, capsys):
    cs = rehearsal_env(monkeypatch, tmp_path)
    time_ms, device_kernel_ms = cs.time_ms, cs.device_kernel_ms
    monkeypatch.setattr(cs, "time_ms",
                        lambda torch, fn, reps=25: time_ms(torch, fn, 1))
    monkeypatch.setattr(cs, "device_kernel_ms",
                        lambda torch, fn, name, reps=20: device_kernel_ms(
                            torch, fn, name, 1))
    got = {}
    real = cs.sim_scan_paths

    def keep(*args):
        got["sim"] = real(*args)
        return got["sim"]

    monkeypatch.setattr(cs, "sim_scan_paths", keep)
    try:
        assert cs.main(cs.Run(
            dev="cpu", ntoas=300, dmx_bins=8, nfit=24,
            out_dir=str(tmp_path / "out"), paths=("sim_scan",),
            scan_axis=3, scan_chunk=2)) == 0
    finally:
        reset_launches()
    lines = capsys.readouterr().out.strip().splitlines()
    recs = {rec["phase"]: rec for rec in
            (json.loads(ln) for ln in lines if '"phase"' in ln)}
    assert list(recs) == ["device", "build", "sim_main_path",
                          "sim_scan_timing", "sim_scan_faults", "sim_chain"]
    main = recs["sim_main_path"]
    assert (main["ntoas"], main["n_fit"]) == (300, 24)
    assert main["zero_residuals_iterations"] >= 1
    assert main["n_chunks"] == 5 and main["chunk_statuses"] == {"OK": 5}
    assert main["max_rel_chunked_vs_whole"] <= cs.CHI2_TOL
    assert main["random_models_shapes"] == [[100, 300], [100, 19]]
    assert main["random_models_fit"]["n_fit"] == 19
    assert main["random_models_launches"]["phase_chain_primal"] == 1
    assert main["random_models_launches"]["phase_chain_tangent"] == 0
    assert 0.8 < main["random_models_scatter_ratio"] < 1.2
    assert all(len(v) == 3 for v in main["grid_axes"].values())
    assert main["chi2_min_at"] == [1, 1]
    assert max(main["grid_axes"]["SINI"]) < 1.0
    faults = recs["sim_scan_faults"]
    assert faults["interrupted"] == {"signum": 15, "chunks_done": 3,
                                     "n_chunks": 5}
    assert faults["resumed_chunks"] == 3 and faults["resume_bit_identical"]
    assert faults["resume_statuses"] == ["OK"] * 5
    assert faults["retry_bit_identical"]
    assert faults["retry_statuses"] == ["OK", "RETRIED", "OK", "OK", "OK"]
    assert faults["reroute_statuses"] == ["OK", "REROUTED", "OK", "OK", "OK"]
    assert faults["reroute_max_rel_gap"] <= cs.CHI2_TOL
    timing = recs["sim_scan_timing"]
    assert timing["deterministic"] and len(timing["scan_walls_s"]) == 3
    assert timing["chunk_statuses"] == [{"OK": 5}] * 5
    assert len(timing["launches_per_random_models"]) == 3
    chain = recs["sim_chain"]
    assert all(chain["random_models_primal"][
        "primal_bit_equal_to_unfused"].values())
    assert chain["timing"]["random_models"]["theta_sets"] == 100
    assert chain["timing"]["random_models"]["primal"]["bound_ms"] > 0
    assert chain["timing"]["scan_chunk"]["theta_sets"] == 2
    assert not any('"kernels"' in ln for ln in lines)
    # on the card the path's launches and times join the kernels line
    kernels = [{"name": n, "launches": 1, "launches_by_path": {}}
               for n in cs.counts()]
    cs.add_sim_scan(kernels, got["sim"])
    by_name = {k["name"]: k for k in kernels}
    assert all(k["launches_by_path"]["sim_scan"] == main["launches"][n]
               for n, k in by_name.items())
    assert by_name["phase_chain_primal"]["launches"] == \
        1 + main["launches"]["phase_chain_primal"]
    assert set(by_name["phase_chain_primal"]["sim_scan"]) == {
        "random_models", "scan_chunk", "max_abs_err"}
    assert by_name["phase_chain_primal"]["sim_scan"]["random_models"][
        "theta_sets"] == 100
    assert set(by_name["phase_chain_tangent"]["sim_scan"]["scan_chunk"]) \
        == set(chain["timing"]["scan_chunk"]["tangent"])
    assert json.loads(lines[-1]) == {"ok": True, "device": {
        "platform": "gpu", "kind": "cpu-rehearsal", "count": 1}}
