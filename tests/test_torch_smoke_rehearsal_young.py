"""A CPU rehearsal of ``chip_smoke.py``'s young_fit path alone.

The young glitching pulsar's path runs here on the CPU at 300 TOAs
(``examples.young_par()``: three glitches, a PiecewiseSpindown group,
WAVE, IFUNC and PHOFF; 19 fit parameters), in the environment of
``tests/test_torch_smoke_rehearsal.py`` (the card-only calls stubbed, the
delay_chain and phase_chain launches run by their host builds, the phase
family's template values among them): the simulation, ``Fitter.auto``'s
fit and its warm repeats, the profile, the committed 200-TOA set against
pint_tpu's stored fit, and the phase family's checks on the path's model
and on one edge variant (``examples.PHASE_FAMILY``; the card holds every
variant and the layout with every family), with their timings.  The
timings take one timed call and one traced call each, where the card
takes 25 and 20.  Its 281 degrees of freedom spread chi2/dof by ~0.08,
so it sets a wider window than the card's 12,481 take.
"""

import json

from test_torch_smoke_rehearsal import (PTXAS_LOG, rehearsal_env,
                                        reset_launches)

#: the stand-in ptxas report with a kernel of the phase family's template
#: value on no binary (120 = 0 + 8 + 16 + 32 + 64)
PHASE_LOG = PTXAS_LOG + """\
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_118phase_chain_primalILi120EEEvN7ptchain9PhRowDataENS_9PhaseDataEPKdNS1_5PhCfgEN12ptphasechain8PhaseCfgEllPdPfS7_S7_' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_118phase_chain_primalILi120EEEvN7ptchain9PhRowDataENS_9PhaseDataEPKdNS1_5PhCfgEN12ptphasechain8PhaseCfgEllPdPfS7_S7_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 96 registers, used 1 barriers, 640 bytes cmem[0]
"""


def test_chip_smoke_rehearsal_young(monkeypatch, tmp_path, capsys):
    from pint_tpu_torch.kernels import build

    cs = rehearsal_env(monkeypatch, tmp_path)
    monkeypatch.setattr(build, "build_log", lambda name: PHASE_LOG)
    # 281 degrees of freedom spread chi2/dof by ~0.08
    monkeypatch.setattr(cs, "YOUNG_CHI2_PER_DOF", (0.7, 1.3))
    time_ms, device_kernel_ms = cs.time_ms, cs.device_kernel_ms
    monkeypatch.setattr(cs, "time_ms",
                        lambda torch, fn, reps=25: time_ms(torch, fn, 1))
    monkeypatch.setattr(cs, "device_kernel_ms",
                        lambda torch, fn, name, reps=20: device_kernel_ms(
                            torch, fn, name, 1))
    try:
        assert cs.main(cs.Run(
            dev="cpu", ntoas=300, out_dir=str(tmp_path / "out"),
            young_tim=str(tmp_path / "young.tim"), paths=("young_fit",),
            young_layouts=("PHF_EDGES_IF2",))) == 0
    finally:
        reset_launches()
    lines = capsys.readouterr().out.strip().splitlines()
    recs = {rec["phase"]: rec for rec in
            (json.loads(ln) for ln in lines if '"phase"' in ln)}
    assert list(recs) == ["device", "build", "young_main_path",
                          "young_profile", "young_reference", "young_chain"]
    main = recs["young_main_path"]
    assert (main["ntoas"], main["n_fit"]) == (300, 19)
    assert main["status"] == "CONVERGED"
    assert main["fitter"] == "DownhillWLSFitter"
    launches = main["launches"]
    assert launches["phase_chain_primal"] > 0
    assert launches["phase_chain_primal"] == launches[
        "phase_chain_primal_phase_family"]
    assert launches["phase_chain_tangent"] == launches[
        "phase_chain_tangent_phase_family"] > 0
    assert len(main["fit_walls_s"]) == 2
    ref = recs["young_reference"]
    assert ref["max_sigma_gap"] <= cs.FIT_SIGMA_TOL
    assert ref["max_unc_rel_gap"] <= cs.UNC_TOL
    # the young set's design matrix against pint_tpu's stored columns
    assert ref["max_rel_column_gap_vs_stored"] <= cs.COLUMN_TOL
    chain = recs["young_chain"]
    assert set(chain["phase_family"]) == {"PHF_EDGES_IF2", "young"}
    for label, rec in chain["phase_family"].items():
        # the unfused chain's exp, sin and cos are torch's, the host
        # build's libm's: within the bar, and bit-equal most rows
        bar = rec["frac_bar_vs_plain_cycles"]
        assert rec["primal_gap_to_unfused"]["out"] <= bar, label
        assert rec["primal_bit_equal_to_unfused"]["slope"], label
        assert rec["max_abs_frac_err_vs_plain"] <= bar, label
        assert all(rec["lanes_bit_equal_to_single_lane"].values()), label
        assert rec["tzr_words_match_pdict"] and rec[
            "tzr_words_bit_equal_to_unfused"], label
        assert rec["jacfwd_launches"] == [1, 1], label
        assert rec["jacfwd_family_launches"] == [1, 1], label
    assert chain["phase_family"]["young"]["kernel_index"] == 28
    assert chain["ptxas_changed_vs_parent"] == {}
    assert set(chain["registers_phase_family"]) == {
        "none+DM+CHROM+ORB+PHASE/primal"}
    t = chain["timing"]["young"]
    assert t["primal"]["bound_ms"] > 0
    assert {v["lanes"] for v in t["tangent"].values()} == {19}
    # run alone, the path prints no kernels line: the last lines are the
    # card's and the result
    assert lines[-2] == "cpu rehearsal, 0 W"
    assert json.loads(lines[-1])["ok"]
