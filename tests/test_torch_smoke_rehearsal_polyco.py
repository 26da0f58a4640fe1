"""A CPU rehearsal of ``chip_smoke.py``'s polyco_orbphase path alone.

The path runs here on the CPU at 200 TOAs (the committed J0740 set, 8
DMX bins) in the environment of ``tests/test_torch_smoke_rehearsal.py``
(the card-only calls stubbed, the delay_chain and phase_chain launches,
the orbital-phase entry among them, run by their host builds): polycos
over two hours (two segments) held against the model at 200 off-node
times and against the CPU's polycos, the orbital phase of the J0740
(ELL1), DD, DDK and spider models, one launch each, against its plain
version with its bound, and AIC, BIC and an F-test of FD5 against the
CPU's.  The timings take one timed call and one traced call each, where
the card takes 5 and 20.
"""

import json

from test_torch_smoke_rehearsal import rehearsal_env, reset_launches


def test_chip_smoke_rehearsal_polyco(monkeypatch, tmp_path, capsys):
    cs = rehearsal_env(monkeypatch, tmp_path)
    time_ms, device_kernel_ms = cs.time_ms, cs.device_kernel_ms
    monkeypatch.setattr(cs, "time_ms",
                        lambda torch, fn, reps=25: time_ms(torch, fn, 1))
    monkeypatch.setattr(cs, "device_kernel_ms",
                        lambda torch, fn, name, reps=20: device_kernel_ms(
                            torch, fn, name, 1))
    try:
        assert cs.main(cs.Run(
            dev="cpu", tim=cs.REF_TIM, ntoas=200, dmx_bins=8,
            out_dir=str(tmp_path / "out"), paths=("polyco_orbphase",),
            polyco_days=2 / 24, polyco_offnode=200)) == 0
    finally:
        reset_launches()
    lines = capsys.readouterr().out.strip().splitlines()
    recs = {rec["phase"]: rec for rec in
            (json.loads(ln) for ln in lines if '"phase"' in ln)}
    assert list(recs) == ["device", "build", "polyco_main_path",
                          "polyco_orbphase_checks"]
    main = recs["polyco_main_path"]
    assert (main["ntoas"], main["segments"], main["sample_rows"]) == (
        200, 2, 48)
    assert main["polyco_launches"] == {"phase_chain_primal": 2}
    assert set(main["orbital_phase_launches"]) == {"J0740", "DD", "DDK",
                                                   "spider"}
    assert all(v == {"delay_chain_orbital_phase": 1}
               for v in main["orbital_phase_launches"].values())
    launches = main["launches"]
    assert launches["delay_chain_orbital_phase"] == 4
    assert launches["phase_chain_primal"] > 0
    assert main["plain_delay_chains"] == 0
    # the F-test's fit: the headline's parameters on the simulated set
    assert main["ftest_n_fit"] == main["n_fit"]
    assert main["ftest"]["dof_new"] == main["ftest"]["dof_base"] - 1
    checks = recs["polyco_orbphase_checks"]
    assert checks["polyco_vs_model_max_abs_cycles"] <= cs.POLYCO_TOL_CYCLES
    assert checks["polyco_ints_equal_to_cpu"]
    assert checks["polyco_card_vs_cpu_max_abs_cycles"] \
        <= cs.POLYCO_CPU_TOL_CYCLES
    assert checks["aic_bic_rel_gap_to_cpu"] <= cs.CHI2_TOL
    assert checks["ftest_chi2_rel_gap_to_cpu"] <= cs.CHI2_TOL
    orb = checks["orbital_phase"]
    assert {k: v["binary"] for k, v in orb.items()} == {
        "J0740": "BinaryELL1", "DD": "BinaryDD", "DDK": "BinaryDDK",
        "spider": "BinaryELL1"}
    for label, v in orb.items():
        # the host build of the entry is the plain version's arithmetic
        assert v["max_abs_err_orbits"] == 0.0, label
        assert v["in_unit_interval"] and v["bound_ms"] > 0, label
    assert orb["spider"]["template_value"].endswith("+DM+CHROM+ORB")
    # run alone, the path prints no kernels line
    assert lines[-2] == "cpu rehearsal, 0 W"
    assert json.loads(lines[-1])["ok"]
