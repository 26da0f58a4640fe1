"""Chi-squared grids over frozen parameters.

Port of the whole-grid path of :mod:`pint_tpu.gridutils` (reference
`grid_chisq`, `src/pint/gridutils.py:169`: its flat form, and the
outer-product, derived-quantity and tuple wrappers over it).  A grid point
is a different value of some ``p["delta"]`` leaves, so the whole grid is
one ``torch.func.vmap`` of the fixed-iteration Gauss-Newton fit over a
stacked params dict: every grid point's rows go through each device
operation together, and through one launch of the phase kernel.  With
``chunk_size`` or ``checkpoint`` the grid runs in chunks of one width
through :func:`pint_tpu_torch.runtime.run_checkpointed_scan`
(checkpoints, resume, retry, and a requeue onto one unbatched fit per
point).
"""

from __future__ import annotations

import warnings
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from pint_tpu_torch.exceptions import PintTpuWarning
from pint_tpu_torch.fitter import (Fitter, _default_wls_kernel,
                                   build_whitened_assembly, wls_solve)
from pint_tpu_torch.models.timing_model import TimingModel

__all__ = ["grid_chisq_flat", "grid_chisq", "grid_chisq_derived",
           "tuple_chisq", "build_grid_fit_fn", "stack_grid_pdict",
           "grid_in_axes"]


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


def _slice_stacked(stacked: dict, grid_names: Sequence[str], lo: int,
                   hi: int, width: Optional[int]) -> dict:
    """The [lo:hi) slice of a stacked grid params dict, padded to
    ``width`` points by repeating its last point (the pad's results are
    computed and dropped, so that every chunk has one width).
    ``width=None`` with ``hi == lo + 1`` gives scalar grid leaves: the
    unbatched form of one point."""
    gset = set(grid_names)
    delta = {}
    for k, v in stacked["delta"].items():
        if k not in gset:
            delta[k] = v
        elif width is None:
            delta[k] = v[lo]
        else:
            sl = v[lo:hi]
            if hi - lo < width:
                sl = torch.cat([sl, sl[-1:].expand(width - (hi - lo),
                                                   *sl.shape[1:])])
            delta[k] = sl
    return {"const": stacked["const"], "delta": delta,
            "mask": stacked["mask"]}


def _eager_grid_chisq(fitter: Fitter, grid_values: Dict[str, np.ndarray],
                      maxiter: int = 2, kernel=None) -> np.ndarray:
    """The requeue path of chunked scans: chi2 of each grid point from
    one unbatched fit per point (:func:`pint_tpu.gridutils.
    _eager_grid_chisq`), slower but independent of whatever spoiled the
    batched dispatch."""
    names = [n for n in fitter.fit_params if n not in grid_values]
    fit_one = build_grid_fit_fn(
        fitter.model, fitter.resids.batch, names, fitter.track_mode,
        maxiter=maxiter, kernel=kernel, design_matrix=fitter.design_matrix)
    stacked = stack_grid_pdict(fitter.model, fitter.resids.pdict,
                               grid_values)
    gnames = list(grid_values)
    g = len(np.asarray(next(iter(grid_values.values()))))
    out = np.empty(g, np.float64)
    with torch.no_grad():
        for i in range(g):
            chi2, _ = fit_one(_slice_stacked(stacked, gnames, i, i + 1,
                                             None))
            out[i] = float(chi2)
    return out


def grid_chisq_flat(fitter: Fitter, grid_values: Dict[str, np.ndarray],
                    maxiter: int = 2, kernel=None, *,
                    chunk_size: Optional[int] = None,
                    checkpoint: Optional[str] = None,
                    resume: bool = False, max_retries: int = 2,
                    checkpoint_every: int = 1,
                    return_summary: bool = False):
    """chi2 at each of G grid points (all grid arrays shape (G,)); the
    non-grid free parameters are re-fit at every point, all points in one
    vmapped program on the fitter's device.

    With ``chunk_size`` or ``checkpoint`` set (or ``return_summary``),
    the grid runs in chunks of ``chunk_size`` points (the last padded to
    that width) through :func:`pint_tpu_torch.runtime.
    run_checkpointed_scan`: a CRC32-verified checkpoint after every
    ``checkpoint_every`` chunks, SIGTERM or SIGINT mid-scan flushes a
    final checkpoint and raises ``ScanInterrupted``, ``resume=True``
    restores the completed chunks bit-identically; a chunk that raises
    or returns non-finite chi2 is dispatched again ``max_retries``
    times, then requeued onto :func:`_eager_grid_chisq`.
    ``return_summary=True`` returns ``(chi2, ScanSummary)``."""
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
    if chunk_size is None and checkpoint is None and not return_summary:
        with torch.no_grad():
            chi2, _ = vfit(stacked)
        return _check_grid_chi2(chi2.cpu().numpy())

    from pint_tpu_torch import runtime

    g = next(iter(sizes.values()))
    cs = int(chunk_size) if chunk_size else g
    gnames = list(grid_values)

    def run_chunk(ci, lo, hi):
        with torch.no_grad():
            chi2, _ = vfit(_slice_stacked(stacked, gnames, lo, hi, cs))
        return chi2.cpu().numpy()[: hi - lo]

    def fallback(ci, lo, hi):
        return _eager_grid_chisq(
            fitter, {k: np.asarray(v)[lo:hi]
                     for k, v in grid_values.items()},
            maxiter=maxiter, kernel=kernel)

    sig = runtime.scan_signature("grid", grid_values, names, maxiter, cs)
    chi2, summary = runtime.run_checkpointed_scan(
        g, run_chunk, chunk_size=cs, fallback=fallback,
        checkpoint=checkpoint, resume=resume, max_retries=max_retries,
        checkpoint_every=checkpoint_every, signature=sig)
    chi2 = _check_grid_chi2(chi2)
    return (chi2, summary) if return_summary else chi2


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


def grid_chisq(fitter: Fitter, parnames: Sequence[str],
               parvalues: Sequence[np.ndarray],
               maxiter: int = 2) -> Tuple[np.ndarray, List[np.ndarray]]:
    """The full outer-product chi2 grid (reference `grid_chisq`,
    `src/pint/gridutils.py:169`; :func:`pint_tpu.gridutils.grid_chisq`):
    ``(chi2 of shape G1 x G2 x ..., meshgrids)``."""
    grids = np.meshgrid(*[np.asarray(v) for v in parvalues], indexing="ij")
    flat = {n: g.ravel() for n, g in zip(parnames, grids)}
    chi2 = grid_chisq_flat(fitter, flat, maxiter=maxiter)
    return chi2.reshape(grids[0].shape), grids


def grid_chisq_derived(fitter: Fitter, parnames: Sequence[str],
                       parfuncs: Sequence, gridvalues: Sequence[np.ndarray],
                       maxiter: int = 2):
    """chi2 over a grid of derived quantities (reference
    `grid_chisq_derived`, `src/pint/gridutils.py:395`;
    :func:`pint_tpu.gridutils.grid_chisq_derived`): model parameter
    ``parnames[i]`` is set to ``parfuncs[i](*gridpoint)`` at each point of
    the outer product of ``gridvalues``.  Returns ``(chi2, parvalues)``
    in the grid's shape."""
    grids = np.meshgrid(*[np.asarray(v) for v in gridvalues],
                        indexing="ij")
    flatpts = [g.ravel() for g in grids]
    out = {}
    for name, func in zip(parnames, parfuncs):
        out[name] = np.asarray([func(*vals) for vals in zip(*flatpts)],
                               np.float64)
    chi2 = grid_chisq_flat(fitter, out, maxiter=maxiter)
    parvalues = [out[n].reshape(grids[0].shape) for n in parnames]
    return chi2.reshape(grids[0].shape), parvalues


def tuple_chisq(fitter: Fitter, parnames: Sequence[str], parvalues,
                maxiter: int = 2):
    """chi2 at a list of parameter tuples, one value per name in
    ``parnames`` (reference `tuple_chisq`, `src/pint/gridutils.py:593`;
    :func:`pint_tpu.gridutils.tuple_chisq`), all in one
    :func:`grid_chisq_flat` call.  Returns ``(chi2 (G,), dof)``."""
    vals = np.asarray([[float(v) for v in tup] for tup in parvalues],
                      np.float64)
    flat = {n: vals[:, i] for i, n in enumerate(parnames)}
    chi2 = grid_chisq_flat(fitter, flat, maxiter=maxiter)
    return chi2, fitter.resids.dof
