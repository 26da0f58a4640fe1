"""Model selection and model-translation utilities.

A carried copy of :mod:`pint_tpu.modelselect` over the port's models,
residuals and fitters: the reference's `utils.py` helper tail, F-test
(`src/pint/utils.py:2143`), AIC/BIC (`utils.py:2935,3001`), the
`Fitter.ftest` workflow (`fitter.py:700`), DMX range construction
(`utils.py:782`), Wave<->WaveX translation (`utils.py:1810,1973`) and
WaveX->power-law red-noise conversion (`utils.py:3152-3339`).  The
likelihoods and fits run where the port's residuals and fitters do (the
card unless ``device`` says otherwise); the rest is host numpy.
"""

from __future__ import annotations

import math
import warnings
from typing import Dict, Sequence, Union

import numpy as np
import torch

SECS_PER_DAY = 86400.0
FYR_HZ = 1.0 / (365.25 * SECS_PER_DAY)

__all__ = ["FTest", "akaike_information_criterion",
           "bayesian_information_criterion", "ftest", "dmx_ranges",
           "translate_wave_to_wavex", "translate_wavex_to_wave",
           "plrednoise_from_wavex", "pldmnoise_from_dmwavex"]


def FTest(chi2_1: float, dof_1: int, chi2_2: float, dof_2: int) -> float:
    """F-test false-alarm probability that the chi2 improvement of the
    model with more parameters ('2') over the nested simpler model ('1')
    is due to chance (reference `FTest`,
    `src/pint/utils.py:2143`; identical to Sherpa's)."""
    from scipy.special import fdtrc

    delta_chi2 = chi2_1 - chi2_2
    if delta_chi2 > 0 and dof_1 != dof_2:
        delta_dof = dof_1 - dof_2
        new_redchi2 = chi2_2 / dof_2
        F = float((delta_chi2 / delta_dof) / new_redchi2)
        return float(fdtrc(delta_dof, dof_2, F))
    if dof_1 == dof_2:
        warnings.warn("models have equal degrees of freedom; F-test "
                      "undefined")
        return float("nan")
    warnings.warn("chi2 did not improve with the added parameters")
    return 1.0


def akaike_information_criterion(model, toas, device=None) -> float:
    """AIC = 2 k - 2 ln L at the model's current (best-fit) parameters
    (reference `akaike_information_criterion`, `utils.py:2935`), the
    likelihood from residuals on ``device``."""
    from pint_tpu_torch.residuals import Residuals

    k = len(model.free_params)
    return 2.0 * k - 2.0 * Residuals(toas, model,
                                     device=device).lnlikelihood()


def bayesian_information_criterion(model, toas, device=None) -> float:
    """BIC = k ln N - 2 ln L (reference
    `bayesian_information_criterion`, `utils.py:3001`); penalizes free
    parameters more heavily than the AIC."""
    from pint_tpu_torch.residuals import Residuals

    k = len(model.free_params)
    return k * math.log(toas.ntoas) - \
        2.0 * Residuals(toas, model, device=device).lnlikelihood()


def _model_without(model, key_pred, add_lines=()):
    """New model from `model`'s par file with every line whose leading
    key satisfies `key_pred` removed and `add_lines` appended, in ONE
    parse (shared by ftest and the Wave/WaveX translators so the
    filtering variants cannot drift; the single parse keeps remove+add
    component swaps valid — an intermediate removal-only par may not
    stand alone)."""
    from pint_tpu_torch.models import get_model

    lines = []
    for line in model.as_parfile().splitlines():
        key = line.split()[0] if line.split() else ""
        if key and key_pred(key):
            continue
        lines.append(line)
    lines += list(add_lines)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return get_model(lines)


def ftest(fitter, add_lines: Union[str, Sequence[str]] = (),
          unfreeze: Sequence[str] = (), remove: Sequence[str] = (),
          maxiter: int = 10) -> Dict[str, float]:
    """The `Fitter.ftest` workflow (reference
    `src/pint/fitter.py:700`): refit a modified model and F-test it
    against the fitter's current model, on the fitter's device.

    ``add_lines`` are par-file lines introducing new free parameters
    (e.g. ``"FD4 0 1"``); ``unfreeze`` names existing parameters to
    free; ``remove`` names parameters to drop/freeze (testing the
    *simpler* model).  Returns a dict with the F-test probability and
    both (chi2, dof) pairs; the modified fitter is under ``"fitter"``.
    """
    if isinstance(add_lines, str):
        add_lines = [add_lines]
    if isinstance(remove, str):
        remove = [remove]
    remove = set(remove)
    base_chi2 = fitter.resids.calc_chi2()
    base_dof = fitter.resids.dof
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        m2 = _model_without(fitter.model, lambda k: k in remove,
                            add_lines=add_lines)
        for n in unfreeze:
            m2[n].frozen = False
        f2 = type(fitter)(fitter.toas, m2, device=fitter.device)
        f2.fit_toas(maxiter=maxiter)
    new_chi2 = f2.resids.calc_chi2()
    new_dof = f2.resids.dof
    if new_dof < base_dof:
        p = FTest(base_chi2, base_dof, new_chi2, new_dof)
    else:  # the modified model is the simpler one
        p = FTest(new_chi2, new_dof, base_chi2, base_dof)
    return {"ft": p, "chi2_base": base_chi2, "dof_base": base_dof,
            "chi2_new": new_chi2, "dof_new": new_dof, "fitter": f2}


def dmx_ranges(toas, divide_freq_mhz: float = 1000.0,
               binwidth_days: float = 15.0):
    """Compute initial DMX bins for a TOA set (reference `dmx_ranges`,
    `src/pint/utils.py:782`): greedy fixed-width windows,
    each kept only if it contains TOAs both above and below
    ``divide_freq_mhz`` (otherwise DM is degenerate with the offset).

    Returns ``(mask, component)``: a bool array flagging TOAs assigned
    to a bin, and a configured DispersionDMX component."""
    from pint_tpu_torch.models.dispersion import DispersionDMX

    mjds = np.asarray(toas.utc.mjd_float, np.float64)
    freqs = np.asarray(toas.freq_mhz, np.float64)
    comp = DispersionDMX()
    mask = np.zeros(len(mjds), bool)
    prev_r2 = mjds.min() - 1e-3
    index = 1
    while np.any(mjds > prev_r2):
        start = mjds[mjds > prev_r2].min()
        binidx = (mjds > prev_r2) & (mjds <= start + binwidth_days)
        bin_mjds = mjds[binidx]
        bin_freqs = freqs[binidx]
        prev_r2 = bin_mjds.max()
        if not (np.any(bin_freqs < divide_freq_mhz)
                and np.any(bin_freqs >= divide_freq_mhz)):
            continue  # single-band window: DM unmeasurable
        comp.add_dmx_range(index, bin_mjds.min() - 1e-6,
                           bin_mjds.max() + 1e-6, value=0.0, frozen=False)
        mask |= binidx
        index += 1
    return mask, comp


def translate_wave_to_wavex(model):
    """Wave -> WaveX (reference `translate_wave_to_wavex`,
    `utils.py:1810`): WXFREQ_000k = (k WAVE_OM) / (2 pi) [1/d], with
    amplitude signs flipped (Wave adds *phase*, WaveX adds *delay*)."""
    from pint_tpu_torch.models.wave import WaveX

    wave = model.components["Wave"]
    om = float(model.WAVE_OM.value)
    epoch = model.WAVEEPOCH.value.mjd_float \
        if model.WAVEEPOCH.value is not None \
        else model.PEPOCH.value.mjd_float
    pairs = [tuple(model[n].value) for n in wave.wave_names()]
    m2 = _model_without(model, lambda k: k.startswith("WAVE"))
    wx = WaveX()
    m2.add_component(wx)
    m2.WXEPOCH.set_value(epoch)
    for k, (a, b) in enumerate(pairs):
        freq = (k + 1) * om / (2.0 * math.pi)
        wx.add_wavex_component(freq, index=k + 1, sin=-a, cos=-b,
                               frozen=False)
    m2.validate()
    return m2


def translate_wavex_to_wave(model):
    """WaveX -> Wave (reference `translate_wavex_to_wave`,
    `utils.py:1973`); requires harmonically spaced WXFREQs."""
    from pint_tpu_torch.models.wave import Wave

    wx = model.components["WaveX"]
    cs, ss = [], []
    idx = wx.wavex_indices()
    freqs = np.array([float(model[f"WXFREQ_{i:04d}"].value) for i in idx])
    base = freqs[0]
    if not np.allclose(freqs, base * np.arange(1, len(freqs) + 1),
                       rtol=1e-6):
        raise ValueError("WaveX frequencies are not harmonically spaced; "
                         "cannot express as a Wave series")
    epoch = model.WXEPOCH.value.mjd_float \
        if model.WXEPOCH.value is not None \
        else model.PEPOCH.value.mjd_float
    pairs = [(-float(model[f"WXSIN_{i:04d}"].value),
              -float(model[f"WXCOS_{i:04d}"].value)) for i in idx]
    m2 = _model_without(model, lambda k: k.startswith("WX"))
    wv = Wave()
    m2.add_component(wv)
    m2.WAVE_OM.value = 2.0 * math.pi * base
    m2.WAVEEPOCH.set_value(epoch)
    for k, (a, b) in enumerate(pairs):
        wv.add_wave_component(k + 1, a=a, b=b, frozen=False)
    m2.validate()
    return m2


def _wx2pl_mlnlike(model, component_name: str, ignore_fyr: bool):
    """Negative log-likelihood of the power-law spectral parameters given
    fitted WaveX-family amplitudes and their uncertainties (reference
    `_get_wx2pl_lnlike`, `utils.py:3152`)."""
    from pint_tpu_torch import DMconst
    from pint_tpu_torch.models.noise_model import powerlaw_psd

    prefix = {"WaveX": "WX", "DMWaveX": "DMWX", "CMWaveX": "CMWX"}[
        component_name]
    comp = model.components[component_name]
    idx = np.array(comp.wavex_indices())
    fs = np.array([float(model[f"{prefix}FREQ_{i:04d}"].value)
                   for i in idx]) / SECS_PER_DAY     # Hz
    f0 = fs.min()
    if not np.allclose(np.diff(np.diff(fs)), 0.0, atol=1e-3 * f0):
        raise ValueError(f"{component_name} frequencies must be "
                         "uniformly spaced for this conversion")
    if ignore_fyr:
        keep = np.abs((fs - FYR_HZ) / f0) > 0.5
        idx, fs = idx[keep], fs[keep]
        f0 = fs.min()
    if component_name == "WaveX":
        scale = 1.0
    elif component_name == "DMWaveX":
        scale = float(DMconst) / 1400.0**2
    else:
        scale = float(DMconst) / 1400.0 ** float(model.TNCHROMIDX.value)

    def amp_unc(stem):
        a = np.array([float(model[f"{prefix}{stem}_{i:04d}"].value)
                      for i in idx]) * scale
        da = np.array([model[f"{prefix}{stem}_{i:04d}"].uncertainty
                       for i in idx], np.float64) * scale
        return a, da

    a, da = amp_unc("SIN")
    b, db = amp_unc("COS")

    def mlnlike(params):
        gamma, log10_A = params
        sig2 = powerlaw_psd(torch.from_numpy(fs),
                            torch.tensor(10.0**log10_A, dtype=torch.float64),
                            gamma).numpy() * f0
        return 0.5 * float(
            np.sum(a**2 / (sig2 + da**2) + b**2 / (sig2 + db**2)
                   + np.log(sig2 + da**2) + np.log(sig2 + db**2)))

    return mlnlike, len(idx)


def _plnoise_from_wavex(model, component_name: str, noise_cls_name: str,
                        amp_name: str, gam_name: str, c_name: str,
                        ignore_fyr: bool):
    from scipy.optimize import minimize

    from pint_tpu_torch.models import noise_model as nm

    mlnlike, nmodes = _wx2pl_mlnlike(model, component_name, ignore_fyr)
    res = minimize(mlnlike, [4.0, -13.0], method="Nelder-Mead")
    if not res.success:
        raise ValueError("power-law likelihood maximization failed")
    gamma, log10_A = res.x
    # uncertainties from a finite-difference Hessian
    h = np.array([1e-3, 1e-3])
    H = np.zeros((2, 2))
    for i in range(2):
        for j in range(2):
            xpp = res.x.copy(); xpp[i] += h[i]; xpp[j] += h[j]
            xpm = res.x.copy(); xpm[i] += h[i]; xpm[j] -= h[j]
            xmp = res.x.copy(); xmp[i] -= h[i]; xmp[j] += h[j]
            xmm = res.x.copy(); xmm[i] -= h[i]; xmm[j] -= h[j]
            H[i, j] = (mlnlike(xpp) - mlnlike(xpm) - mlnlike(xmp)
                       + mlnlike(xmm)) / (4 * h[i] * h[j])
    errs = np.sqrt(np.maximum(np.diag(np.linalg.pinv(H)), 0.0))
    stem = {"WaveX": "WX", "DMWaveX": "DMWX", "CMWaveX": "CMWX"}[
        component_name]
    m2 = _model_without(model, lambda k: k.startswith(stem))
    noise = getattr(nm, noise_cls_name)()
    m2.add_component(noise)
    m2[amp_name].value = float(log10_A)
    m2[gam_name].value = float(gamma)
    m2[c_name].value = nmodes
    m2[amp_name].uncertainty = float(errs[1])
    m2[gam_name].uncertainty = float(errs[0])
    m2.validate()
    return m2


def plrednoise_from_wavex(model, ignore_fyr: bool = True):
    """WaveX -> PLRedNoise by maximizing the power-law likelihood over
    the fitted amplitudes (reference `plrednoise_from_wavex`,
    `utils.py:3241`)."""
    return _plnoise_from_wavex(model, "WaveX", "PLRedNoise",
                               "TNREDAMP", "TNREDGAM", "TNREDC",
                               ignore_fyr)


def pldmnoise_from_dmwavex(model, ignore_fyr: bool = False):
    """DMWaveX -> PLDMNoise (reference `pldmnoise_from_dmwavex`,
    `utils.py:3291`)."""
    return _plnoise_from_wavex(model, "DMWaveX", "PLDMNoise",
                               "TNDMAMP", "TNDMGAM", "TNDMC", ignore_fyr)
