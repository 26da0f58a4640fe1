"""Chi-squared grids over frozen parameters.

Port of the whole-grid path of :mod:`pint_tpu.gridutils` (reference
`grid_chisq`, `src/pint/gridutils.py:169`, here its flat form).  A grid point
is a different value of some ``p["delta"]`` leaves, so the whole grid is
one ``torch.func.vmap`` of the fixed-iteration Gauss-Newton fit over a
stacked params dict: every grid point's rows go through each device
operation together, and through one launch of the phase kernel.
Chunked and checkpointed scans are not ported yet.
"""

from __future__ import annotations

import warnings
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from pint_tpu_torch.exceptions import PintTpuWarning
from pint_tpu_torch.fitter import (Fitter, _default_wls_kernel,
                                   build_whitened_assembly, wls_solve)
from pint_tpu_torch.models.timing_model import TimingModel

__all__ = ["grid_chisq_flat", "build_grid_fit_fn",
           "stack_grid_pdict", "grid_in_axes"]


def _grid_deltas(model: TimingModel, p: dict,
                 grid_values: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Device-unit delta arrays (G,) that realize the requested par-unit
    grid values for each (frozen) grid parameter."""
    out = {}
    for name, vals in grid_values.items():
        par = model[name]
        vals = np.asarray(vals, np.float64)
        base = np.asarray(par.device_value, np.float64)
        if par.kind == "mjd":
            out[name] = vals - (base[0] + base[1])  # grid given in MJD
        else:
            out[name] = vals * par.par2dev - base
    return out


def stack_grid_pdict(model: TimingModel, p: dict,
                     grid_values: Dict[str, np.ndarray]) -> dict:
    """A params dict whose ``delta`` leaves for the grid parameters carry
    a leading grid axis; everything else is shared."""
    deltas = _grid_deltas(model, p, grid_values)
    delta = dict(p["delta"])
    for name, d in deltas.items():
        delta[name] = torch.as_tensor(d, device=p["delta"][name].device)
    out = dict(p)
    out["delta"] = delta
    return out


def grid_in_axes(p: dict, grid_names: Sequence[str]) -> dict:
    """The matching ``torch.func.vmap`` in_dims tree: 0 on the grid deltas."""
    names = set(grid_names)
    return {
        "const": {k: None for k in p["const"]},
        "delta": {k: (0 if k in names else None) for k in p["delta"]},
        "mask": {k: None for k in p["mask"]},
    }


def build_grid_fit_fn(model: TimingModel, batch, fit_params: Sequence[str],
                      track_mode: str, maxiter: int = 2,
                      threshold: Optional[float] = None, kernel=None,
                      design_matrix: Optional[str] = None):
    """``fit_one(p, cols=None) -> (chi2, x)``: a fixed-iteration WLS fit of
    one params dict — vmap it over stacked grid dicts.  With the split
    design-matrix path the linear-block columns are computed once per
    fit point and shared by its iterations (not across grid points, as in
    :func:`pint_tpu.gridutils.build_grid_fit_fn`)."""
    names = list(fit_params)
    P = len(names)
    assemble = build_whitened_assembly(model, batch, names, track_mode,
                                       include_offset=True,
                                       design_matrix=design_matrix)
    kern = _default_wls_kernel(batch.device) if kernel is None else kernel

    def zeros():
        return torch.zeros(P, dtype=torch.float64, device=batch.device)

    def step(x, p, cols):
        if assemble.split:
            c = assemble.lin_cols(x, p) if cols is None else cols
            r, M, sigma, offc = assemble.inline_with_cols(x, p, c)
        else:
            r, M, sigma, offc = assemble.inline(x, p)
        return wls_solve(r, M, sigma, offc, kern, P, threshold)

    def fit_one(p, cols=None):
        if assemble.split and cols is None:
            cols = assemble.lin_cols(zeros(), p)
        x = zeros()
        for _ in range(maxiter):
            x = x + step(x, p, cols)["dx"]
        out = step(x, p, cols)
        return out["chi2"], x

    fit_one.assemble = assemble
    return fit_one


def grid_chisq_flat(fitter: Fitter, grid_values: Dict[str, np.ndarray],
                    maxiter: int = 2, kernel=None) -> np.ndarray:
    """chi2 at each of G grid points (all grid arrays shape (G,)); the
    non-grid free parameters are re-fit at every point, all points in one
    vmapped program on the fitter's device."""
    model = fitter.model
    r = fitter.resids
    names = [n for n in fitter.fit_params if n not in grid_values]
    for n in grid_values:
        if not model[n].frozen:
            raise ValueError(f"grid parameter {n} must be frozen")
    sizes = {n: len(np.asarray(v)) for n, v in grid_values.items()}
    if len(set(sizes.values())) != 1:
        raise ValueError(f"grid arrays differ in length: {sizes}")
    fit_one = build_grid_fit_fn(
        model, r.batch, names, fitter.track_mode, maxiter=maxiter,
        kernel=kernel, design_matrix=fitter.design_matrix)
    stacked = stack_grid_pdict(model, r.pdict, grid_values)
    vfit = torch.func.vmap(fit_one, in_dims=(grid_in_axes(
        r.pdict, list(grid_values)),))
    with torch.no_grad():
        chi2, _ = vfit(stacked)
    return _check_grid_chi2(chi2.cpu().numpy())


def _check_grid_chi2(chi2: np.ndarray) -> np.ndarray:
    """Non-finite guard: a poisoned grid point is called out, never
    silently returned."""
    bad = int(np.sum(~np.isfinite(chi2)))
    if bad:
        warnings.warn(
            f"{bad}/{chi2.size} grid points returned non-finite chi2 "
            "(degenerate or diverging fits at those parameter values)",
            PintTpuWarning)
    return chi2
