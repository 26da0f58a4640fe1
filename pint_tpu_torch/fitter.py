"""Weighted-least-squares fitting on the device, with autodiff design matrices.

Port of the WLS part of :mod:`pint_tpu.fitter`: the whitened, two-stage
column-normalized WLS solve (reference `fit_wls_svd`,
`src/pint/fitter.py:2551`) by SVD or by the normal-equations eigh
kernel, the residual function whose forward-mode jacobian is the design
matrix, the split assembly that computes the linear-parameter columns
once and differentiates only the nonlinear core, and
:meth:`WLSFitter.fit_toas`: on CUDA the fused Gauss-Newton loop
(:func:`build_fused_fit`, loop state on the card, one fetch, a host
float64 SVD final step), on the CPU the guarded eager step loop
(:func:`build_wls_step`), with the convergence sentinel
(:func:`sentinel_advance`, :class:`FitStatus`) and the fused -> eager
degradation rung; and :class:`GLSFitter` (:func:`gls_solve`, with the
ECORR block eliminated by its Schur complement), whose steps assemble
and solve on the device in the eager loop.  The damped-LM rescue rung,
the downhill fitters and noise-parameter fitting are not ported yet
(see ROADMAP.md).

Everything here is plain PyTorch on the batch's device; the phase chain
inside the residual function is the ``qs_phase_frac`` kernel and the DD
family's Kepler solve the ``kepler_E`` kernel.  The jacobians are
``torch.func.jacfwd`` (a ``vmap`` of ``jvp`` over basis tangents): the
primal evaluation runs once and every tangent lane goes through the
kernel wrappers' analytic tangent rules.
"""

from __future__ import annotations

import enum
import time
import warnings
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch
from torch.func import jacfwd

from pint_tpu_torch.exceptions import (ConvergenceFailure, DegeneracyWarning,
                                       PintTpuWarning)
from pint_tpu_torch.models.timing_model import TimingModel, pv
from pint_tpu_torch.residuals import Residuals, raw_phase_resids
from pint_tpu_torch.toabatch import TOABatch
from pint_tpu_torch.utils import normalize_designmatrix

__all__ = ["Fitter", "WLSFitter", "GLSFitter", "fit_wls_svd",
           "fit_wls_eigh", "gls_solve", "build_gls_step",
           "build_gls_fullcov_step",
           "masked_eigh_inverse", "wls_solve", "build_resid_sec_fn",
           "build_whitened_assembly", "build_wls_step", "build_fused_fit",
           "FitStatus", "FitSummary", "FitDegradedWarning",
           "sentinel_advance", "denormalize_covariance"]

#: float64 machine epsilon: the H100, like the CPU, has IEEE float64, so
#: the degeneracy thresholds are those of pint_tpu's CPU backend
EPS_F64 = float(np.finfo(np.float64).eps)
F64 = torch.float64


class FitStatus(enum.IntEnum):
    """Terminal state of one fit attempt (:class:`pint_tpu.fitter.FitStatus`),
    computed on the device by the fused loop's convergence sentinel and
    mirrored by the eager loop.

    * CONVERGED: consecutive-chi2 tolerance met.
    * MAXITER: iteration budget exhausted with finite, non-diverging chi2.
    * DIVERGED: chi2 rose for ``diverge_streak`` consecutive iterations,
      or produced no new best for ``stall_iters`` iterations (the period-2
      oscillation a consecutive-increase test alone misses), or the
      eager step search found no acceptable step.
    * NONFINITE: chi2 (or the solver output feeding it) went NaN/inf.

    DIVERGED and NONFINITE start the degradation chain in
    ``Fitter._fit_fused``."""

    CONVERGED = 0
    MAXITER = 1
    DIVERGED = 2
    NONFINITE = 3


#: sentinel code for "still iterating" (never escapes the loop)
_RUNNING = -1


class FitDegradedWarning(PintTpuWarning):
    """A fit rung failed (DIVERGED/NONFINITE) and the engine is falling
    back to the next rung of the degradation chain."""


def sentinel_advance(x, chi2, prev, best_x, best_chi2, inc_streak,
                     stall_streak, tol_chi2, diverge_streak, stall_iters):
    """One iteration of the convergence sentinel
    (:func:`pint_tpu.fitter.sentinel_advance`): the best-so-far, streak
    and :class:`FitStatus` bookkeeping of the fused loop, on tensors of
    the loop's device, without a host read.  ``chi2`` is the objective at
    ``x`` BEFORE the step is applied; NaN compares False everywhere
    below, so a non-finite chi2 can neither extend a streak nor claim the
    best slot.  Returns ``(best_x, best_chi2, inc_streak, stall_streak,
    status)`` with ``status`` one of the FitStatus codes or ``_RUNNING``
    (int32 tensors)."""
    def code(v):
        return torch.full_like(inc_streak, int(v))

    nonfinite = torch.logical_not(torch.isfinite(chi2))
    converged = torch.abs(prev - chi2) < tol_chi2
    inc_streak = torch.where(chi2 > prev + tol_chi2, inc_streak + 1, code(0))
    stall_streak = torch.where(chi2 < best_chi2 - tol_chi2, code(0),
                               stall_streak + 1)
    better = chi2 < best_chi2
    best_x = torch.where(better, x, best_x)
    best_chi2 = torch.where(better, chi2, best_chi2)
    diverged = torch.logical_or(inc_streak >= diverge_streak,
                                stall_streak >= stall_iters)
    status = torch.where(
        nonfinite, code(FitStatus.NONFINITE),
        torch.where(converged, code(FitStatus.CONVERGED),
                    torch.where(diverged, code(FitStatus.DIVERGED),
                                code(_RUNNING))))
    return best_x, best_chi2, inc_streak, stall_streak, status


def _whiten_normalize(M, r_sec, sigma_sec):
    """Whiten by sigma and column-normalize in two stages (max-abs first,
    then the norm of an O(1) matrix), as
    :func:`pint_tpu.fitter._whiten_normalize`.  Returns ``(Mn, rw, norms)``."""
    Mw = M / sigma_sec[:, None]
    rw = r_sec / sigma_sec
    cmax = torch.amax(torch.abs(Mw), dim=0)
    cmax = torch.where(cmax == 0.0, 1.0, cmax)
    Mc = Mw / cmax
    Mn, nc = normalize_designmatrix(Mc)
    return Mn, rw, cmax * nc


def fit_wls_svd(M, r_sec, sigma_sec, threshold: Optional[float] = None):
    """One linear WLS solve: whiten -> column-normalize -> SVD ->
    threshold.  Returns ``(dpars, Sigma_n, norms, n_bad)``; the true
    covariance is ``Sigma_n / outer(norms, norms)``."""
    Mn, rw, norms = _whiten_normalize(M, r_sec, sigma_sec)
    try:
        U, S, Vh = torch.linalg.svd(Mn, full_matrices=False)
    except torch.linalg.LinAlgError:
        # non-finite input: NaN out, as XLA's SVD returns it
        k = min(Mn.shape[-2:])
        U = torch.full((*Mn.shape[:-1], k), float("nan"), dtype=Mn.dtype,
                       device=Mn.device)
        S = torch.full((*Mn.shape[:-2], k), float("nan"), dtype=Mn.dtype,
                       device=Mn.device)
        Vh = torch.full((*Mn.shape[:-2], k, Mn.shape[-1]), float("nan"),
                        dtype=Mn.dtype, device=Mn.device)
    if threshold is None:
        threshold = EPS_F64 * max(M.shape)
    bad = S <= threshold * S[0]
    Sinv = torch.where(bad, 0.0, 1.0 / torch.where(bad, 1.0, S))
    dpars = (Vh.T @ (Sinv * (U.T @ rw))) / norms
    Sigma_n = (Vh.T * Sinv**2) @ Vh
    return dpars, Sigma_n, norms, torch.sum(bad)


def fit_wls_eigh(M, r_sec, sigma_sec, threshold: Optional[float] = None):
    """Same contract and thresholding as :func:`fit_wls_svd`, solved
    through the normal equations ``eigh(Mn^T Mn)`` (see
    :func:`pint_tpu.fitter.fit_wls_eigh` for the noise-floor rationale)."""
    Mn, rw, norms = _whiten_normalize(M, r_sec, sigma_sec)
    V, einv, n_bad = masked_eigh_inverse(Mn.T @ Mn, threshold, M.shape[0])
    y = Mn.T @ rw
    dpars = (V @ (einv * (V.T @ y))) / norms
    Sigma_n = (V * einv) @ V.T
    return dpars, Sigma_n, norms, n_bad


def masked_eigh_inverse(G, threshold, n_rows):
    """Thresholded eigendecomposition of a unit-normalized normal matrix
    ``G = Mn^T Mn``: relative singular-value cutoff plus the eigh noise
    floor ``eps * P * e_max``.  Returns ``(V, einv, n_bad)`` with
    ``pinv(G) = (V * einv) @ V.T``."""
    try:
        e, V = torch.linalg.eigh(G)
    except torch.linalg.LinAlgError:
        # a poisoned (non-finite) normal matrix: NaN out, as XLA's eigh
        # returns it, so the fit's sentinel reports NONFINITE
        e = torch.full(G.shape[:-1], float("nan"), dtype=G.dtype,
                       device=G.device)
        V = torch.full_like(G, float("nan"))
    S = torch.sqrt(torch.clamp(e, min=0.0))
    if threshold is None:
        threshold = EPS_F64 * max(n_rows, G.shape[0])
    efloor = EPS_F64 * G.shape[0] * torch.clamp(e[-1], min=0.0)
    bad = (S <= threshold * S[-1]) | (e <= efloor)
    einv = torch.where(bad, 0.0, 1.0 / torch.where(bad, 1.0, e))
    return V, einv, torch.sum(bad)


#: the eager split assembly refreshes its cached linear columns when the
#: nonlinear offsets' predicted model change, sum_j max|J_j| |dx_j|,
#: exceeds this [s] (:data:`pint_tpu.fitter.SPLIT_REFRESH_DRIFT_SEC`)
SPLIT_REFRESH_DRIFT_SEC = 0.05


def _default_wls_kernel(device):
    """Device-matched WLS solve kernel, as pint_tpu picks by backend: the
    reference's SVD recipe on the CPU, the normal-equations eigh kernel
    on accelerators."""
    return fit_wls_svd if torch.device(device).type == "cpu" else fit_wls_eigh


def build_resid_sec_fn(model: TimingModel, batch: TOABatch,
                       fit_params: Sequence[str], track_mode: str):
    """``(x, p) -> time residuals [s]`` (not mean-subtracted): the function
    whose jacobian is the design matrix."""
    calc = model.calc
    names = list(fit_params)

    def resid_sec(x, p):
        p2 = model.with_x(p, x, names)
        r_cyc = raw_phase_resids(calc, p2, batch, track_mode,
                                 subtract_mean=False, use_weights=False)
        return r_cyc / pv(p2, "F0")

    return resid_sec


def _resolve_design_matrix(design_matrix: Optional[str]) -> str:
    design_matrix = "split" if design_matrix is None else design_matrix
    if design_matrix not in ("split", "full"):
        raise ValueError(
            f"design_matrix must be 'split' or 'full', got "
            f"{design_matrix!r}")
    return design_matrix


def _with_primal(f):
    """``f`` returning ``(out, out)``: jacfwd's aux carries the primal."""
    def g(*args):
        out = f(*args)
        return out, out
    return g


def _make_assembly(model: TimingModel, names: Sequence[str], combined,
                   sigma_fn, offc, design_matrix: Optional[str]):
    """An ``(x, p) -> (r, M, sigma, offc)`` assembly from a residual-rows
    function ``combined(x, p)``, a row-uncertainty function ``sigma_fn(p)``
    and an offset-regressor column ``offc`` (tensor or None), as
    :func:`pint_tpu.fitter._make_assembly` builds its ``inline`` form.

    ``design_matrix="split"``: the linear block's columns (DMX, JUMPs,
    FD...) come from a jacfwd restricted to that block (``.lin_cols``),
    which a caller computes once and passes to ``.inline_with_cols`` for
    every Gauss-Newton step; only the nonlinear core is re-differentiated
    per step.  Called directly (the eager fit loop), the split assembly
    caches the columns itself, as pint_tpu's does: they are refreshed
    when ``p`` is a new object or the nonlinear offsets' predicted model
    drift exceeds ``SPLIT_REFRESH_DRIFT_SEC``.  ``"full"``: one jacfwd
    over everything (also used when no parameter is linear)."""
    names = list(names)
    design_matrix = _resolve_design_matrix(design_matrix)
    lin_names, nl_names = model.partition_linear_params(names)

    def _append_offset(M):
        if offc is None:
            return M, None
        return torch.cat([M, -offc[:, None]], dim=1), offc

    if design_matrix == "full" or not lin_names:
        def assemble_inline(x, p):
            J, r = jacfwd(_with_primal(combined), argnums=0,
                          has_aux=True)(x, p)
            M, offc_ = _append_offset(-J)
            return r, M, sigma_fn(p), offc_

        assemble_inline.inline = assemble_inline
        assemble_inline.lin_cols = None
        assemble_inline.inline_with_cols = None
        assemble_inline.split = False
        assemble_inline.lin_names, assemble_inline.nl_names = [], names
        assemble_inline.design_matrix = "full"
        return assemble_inline

    # ---------------- split path ----------------
    def offc_dev(p):
        return offc.device if offc is not None else \
            next(iter(p["const"].values())).device

    lin_set = set(lin_names)
    nl_pos = [i for i, n in enumerate(names) if n not in lin_set]
    lin_pos = [i for i, n in enumerate(names) if n in lin_set]
    n_nl = len(nl_pos)
    # x == cat([x_nl, x_lin])[perm]
    perm = torch.as_tensor(np.argsort(np.asarray(nl_pos + lin_pos)))
    nl_idx, lin_idx = torch.as_tensor(nl_pos), torch.as_tensor(lin_pos)

    def _join(a_nl, a_lin, dim):
        cat = torch.cat([a_nl, a_lin], dim=dim)
        return cat.index_select(dim, perm.to(cat.device))

    def resid_parts(x_nl, x_lin, p):
        return combined(_join(x_nl, x_lin, 0), p)

    def _split_x(x):
        return (x.index_select(0, nl_idx.to(x.device)),
                x.index_select(0, lin_idx.to(x.device)))

    def lin_cols(x, p):
        """(N, n_lin) linear-block jacobian d(resid)/d(x_lin), exact at x."""
        x_nl, x_lin = _split_x(x)
        return jacfwd(resid_parts, argnums=1)(x_nl, x_lin, p)

    def nl_block(x, p):
        x_nl, x_lin = _split_x(x)
        if n_nl:
            Jnl, r = jacfwd(_with_primal(resid_parts), argnums=0,
                            has_aux=True)(x_nl, x_lin, p)
        else:
            r = resid_parts(x_nl, x_lin, p)
            Jnl = r.new_zeros((r.shape[0], 0))
        return r, Jnl, sigma_fn(p)

    def inline_with_cols(x, p, cols):
        r, Jnl, sigma = nl_block(x, p)
        M, offc_ = _append_offset(-_join(Jnl, cols, 1))
        return r, M, sigma, offc_

    def assemble_inline(x, p):
        return inline_with_cols(x, p, lin_cols(x, p))

    state: dict = {}

    def assemble(x, p):
        # x arrives as host numpy from the eager loop (or a tensor); the
        # cache test reads the host copy, so it costs no device read
        x_h = np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor)
                         else x, np.float64)
        xt = torch.as_tensor(x_h, device=offc_dev(p))
        x_nl_h = x_h[nl_pos]
        hit = state.get("p") is p
        if hit and n_nl:
            drift = float(np.sum(state["nl_scale"]
                                 * np.abs(x_nl_h - state["x_nl"])))
            hit = drift <= SPLIT_REFRESH_DRIFT_SEC
        if not hit:
            x_nl, x_lin = _split_x(xt)
            cols = jacfwd(resid_parts, argnums=1)(x_nl, x_lin, p)
            nl_scale = np.zeros(0)
            if n_nl:
                Jnl = jacfwd(resid_parts, argnums=0)(x_nl, x_lin, p)
                nl_scale = torch.amax(torch.abs(Jnl), dim=0).cpu().numpy()
            state.update(p=p, cols=cols, x_nl=x_nl_h.copy(),
                         nl_scale=nl_scale)
        return inline_with_cols(xt, p, state["cols"])

    assemble.inline = assemble_inline
    assemble.lin_cols = lin_cols
    assemble.inline_with_cols = inline_with_cols
    assemble.split = True
    assemble.lin_names, assemble.nl_names = lin_names, nl_names
    assemble.design_matrix = "split"
    return assemble


def build_whitened_assembly(model: TimingModel, batch: TOABatch,
                            fit_params: Sequence[str], track_mode: str,
                            include_offset: bool,
                            design_matrix: Optional[str] = None):
    """``(x, p) -> (r, M, sigma, offc)``: residuals [s], design matrix
    (offset column appended when ``include_offset``), scaled per-TOA
    uncertainties [s] and the offset regressor column (or None)."""
    resid_sec = build_resid_sec_fn(model, batch, list(fit_params),
                                   track_mode)

    def sigma_fn(p):
        return model.scaled_toa_uncertainty(p, batch) * 1e-6

    offc = torch.ones(batch.ntoas, dtype=torch.float64,
                      device=batch.device) if include_offset else None
    return _make_assembly(model, list(fit_params), resid_sec, sigma_fn,
                          offc, design_matrix)


def _nan_solution(P: int):
    """The all-NaN stand-in for an impossible host solve (dpars, Sigma_n,
    norms, n_bad), with finite norms so denormalization stays defined."""
    nan = torch.full((P,), float("nan"), dtype=F64)
    return nan, torch.full((P, P), float("nan"), dtype=F64), \
        torch.ones(P, dtype=F64), torch.zeros((), dtype=torch.int64)


def wls_solve(r, M, sigma, offc, kern, npar, threshold=None,
              host: bool = False):
    """One WLS solve + chi2 from a whitened assembly
    (:func:`pint_tpu.fitter.wls_solve`): chi2 is evaluated at x with the
    offset profiled out.

    ``host=False`` is the device path of grids and of the CPU eager step
    (``e_min`` is inf, never consulted).  ``host=True`` is the host
    finish of an accelerator fit, on CPU float64 tensors: a non-finite
    assembly or a failed factorization gives an all-NaN result that the
    fit guards judge instead of an exception, and ``e_min`` is the
    smallest kept eigenvalue of the normalized Gram (1/||Sigma_n||_2),
    the conditioning figure the fit reports in ``fit_info``."""
    if host:
        finite_in = bool(torch.all(torch.isfinite(M))
                         and torch.all(torch.isfinite(r))
                         and torch.all(torch.isfinite(sigma)))
        solution = None
        if finite_in:
            try:
                solution = kern(M, r, sigma, threshold)
            except torch.linalg.LinAlgError:
                solution = None
        dpars, Sigma_n, norms, n_bad = solution if solution is not None \
            else _nan_solution(M.shape[1])
    else:
        dpars, Sigma_n, norms, n_bad = kern(M, r, sigma, threshold)
    if offc is not None:
        w = offc / sigma**2
        off = torch.sum(r * w) / torch.sum(w * offc)
        r_off = r - off * offc
    else:
        off = torch.zeros((), dtype=r.dtype, device=r.device)
        r_off = r
    chi2 = torch.sum((r_off / sigma) ** 2)
    e_min = float("inf")
    if host:
        if bool(torch.all(torch.isfinite(Sigma_n))):
            smax = float(torch.linalg.eigvalsh(Sigma_n)[-1])
            e_min = 1.0 / smax if smax > 0 else float("inf")
        else:
            e_min = float("nan")  # poisoned solve: compares False
    return {"dx": dpars[:npar], "offset": off, "chi2": chi2,
            "Sigma_n": Sigma_n[:npar, :npar], "norms": norms[:npar],
            "resid_sec": r, "n_bad": n_bad, "e_min": e_min}


def _np(t) -> np.ndarray:
    """A tensor (any device) or array as host float64 numpy."""
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def _fetch_host(r, M, sigma, offc):
    """The whitened system as CPU tensors, in ONE device-to-host transfer
    of the flattened parts (already-CPU inputs pass through)."""
    if r.device.type == "cpu":
        return r, M, sigma, offc
    parts = [r.reshape(-1), M.reshape(-1), sigma.reshape(-1)]
    if offc is not None:
        parts.append(offc.reshape(-1))
    flat = torch.cat(parts).cpu()
    n, m = r.shape[0], M.numel()
    offc_h = None if offc is None else flat[n + m + n:]
    return (flat[:n], flat[n:n + m].reshape(M.shape),
            flat[n + m:n + m + n], offc_h)


def _step_assembler(assemble, batch: TOABatch):
    """``(x, p) -> (r, M, sigma, offc)`` of an eager step: ``x`` host
    numpy or a tensor, no autograd graph kept."""
    def _assemble(x, p):
        if not assemble.split:
            x = torch.as_tensor(_np(x), dtype=F64, device=batch.device)
        with torch.no_grad():
            return assemble(x, p)

    return _assemble


def build_wls_step(model: TimingModel, batch: TOABatch,
                   fit_params: Sequence[str], track_mode: str,
                   threshold: Optional[float] = None,
                   include_offset: bool = True,
                   design_matrix: Optional[str] = None):
    """The Gauss-Newton step ``(x, p) -> dict`` for a frozen
    model structure (:func:`pint_tpu.fitter.build_wls_step`).

    ``x`` is the free-parameter offset vector (device units, offsets
    from the params dict's reference values; host numpy or a tensor);
    the dict holds ``dx`` (the step, offset column dropped), ``chi2``
    (at x, offset profiled out), ``Sigma_n``/``norms`` (the normalized
    covariance and column norms), ``resid_sec``, ``n_bad`` and ``e_min``.

    With the batch on an accelerator the device assembles (residuals +
    jacfwd), the system comes to the host in one transfer, and the solve
    is the reference's float64 SVD recipe on the CPU.  With the batch on
    the CPU the whole step is the SVD recipe there.

    pint_tpu re-assembles the final covariance on the CPU when the
    smallest kept eigenvalue is small (``_exact_assemble_factory``): its
    TPU's emulated float64 left ~1e-11 relative noise in the design
    matrix.  The H100's float64 is IEEE, and there that pass changes the
    DD fit's uncertainties by ~1e-10 relative (PERF.md), so the port
    takes the final covariance from the device assembly."""
    names = list(fit_params)
    _assemble = _step_assembler(build_whitened_assembly(
        model, batch, names, track_mode, include_offset,
        design_matrix=design_matrix), batch)

    if batch.device.type == "cpu":
        def step(x, p):
            r, M, sigma, offc = _assemble(x, p)
            with torch.no_grad():
                return wls_solve(r, M, sigma, offc, fit_wls_svd, len(names),
                                 threshold)

        return step

    def step(x, p):
        return wls_solve(*_fetch_host(*_assemble(x, p)), fit_wls_svd,
                         len(names), threshold, host=True)

    return step


def _nan_gls_out(r, npar: int) -> dict:
    """The all-NaN GLS solve dict (:func:`pint_tpu.fitter._nan_gls_out`):
    norms finite so denormalization stays defined, and no
    ``noise_ampls`` key, which :meth:`Fitter._store_noise` reads as
    "drop stale realizations"."""
    dev = r.device
    nan = float("nan")
    return {"dx": torch.full((npar,), nan, dtype=F64, device=dev),
            "offset": torch.full((), nan, dtype=F64, device=dev),
            "chi2": torch.full((), nan, dtype=F64, device=dev),
            "Sigma_n": torch.full((npar, npar), nan, dtype=F64, device=dev),
            "norms": torch.ones(npar, dtype=F64, device=dev),
            "resid_sec": r, "n_bad": torch.zeros((), dtype=torch.int64),
            "e_min": nan}


def _svd(B):
    """SVD with a poisoned (non-finite) matrix giving NaNs, as XLA's
    does, instead of an exception."""
    try:
        return torch.linalg.svd(B, full_matrices=False)
    except torch.linalg.LinAlgError:
        k = min(B.shape)
        nan = float("nan")
        return (torch.full((B.shape[0], k), nan, dtype=B.dtype,
                           device=B.device),
                torch.full((k,), nan, dtype=B.dtype, device=B.device),
                torch.full((k, B.shape[1]), nan, dtype=B.dtype,
                           device=B.device))


def _sqrt_solve(B, rhs, thr):
    """The thresholded solve of the normal equations B^T B x = B^T rhs
    through the SVD of B: eigenvalues e = s^2, those <= ``thr`` dropped.
    Returns ``(x, V, einv, e, bad)`` with pinv(B^T B) = (V * einv) @ V.T."""
    Ub, sv, Vh = _svd(B)
    e = sv**2
    bad = e <= thr
    sinv = torch.where(bad, 0.0, 1.0 / torch.where(bad, 1.0, sv))
    return Vh.T @ (sinv * (Ub.T @ rhs)), Vh.T, sinv**2, e, bad


def gls_solve(r, M, sigma, offc, U, phi, esl, npar: int,
              threshold: Optional[float] = None) -> dict:
    """The GLS linear solve + Woodbury chi2 on the tensors' device
    (:func:`pint_tpu.fitter.gls_solve` with ``xp`` the true-IEEE CPU
    backend's: the H100's float64 is IEEE too, so the port solves where
    the assembly lives, as pint_tpu does on the CPU).

    The normal matrix is that of ``[M | U]`` with the diagonal prior
    ``1/phi`` on the basis columns (zero, a flat prior, on the timing
    columns), in diagonally preconditioned coordinates; its eigenvalues
    at or below ``threshold`` (an ABSOLUTE cutoff there, default eps * P,
    since a strong noise prior inflates the largest eigenvalue by many
    orders) are dropped.  With ``esl`` (the ECORR column range of ``U``)
    the ECORR block is eliminated through its exactly diagonal Gram
    (Schur complement), so the remaining system is the timing + Fourier
    block only, and chi2 uses the matching per-epoch Sherman-Morrison.
    chi2 is r^T C^-1 r at x with the offset profiled out in the same
    C^-1 metric.  Returns the :func:`wls_solve` keys plus ``noise_ampls``
    (the basis amplitudes); ``e_min`` is the smallest kept eigenvalue.

    pint_tpu eigendecomposes the normal matrix itself.  The port takes
    the SVD of its square root (the stacked whitened design matrix and
    the square root of the prior; for the Schur complement, the design
    matrix with each ECORR epoch's share projected out), whose squared
    singular values are the same eigenvalues, thresholded alike.  A
    NANOGrav-width model is nearly degenerate in DM, the offset and FD1-4
    over three receivers (smallest eigenvalue ~1e-11 of ~1e3): forming
    the normal matrix rounds that direction at ~1e-3 relative, so an eigh
    solve there moves by ~1e-3 sigma between two machines' roundings,
    pint_tpu's included (PERF.md); the SVD of the square root keeps it to
    ~1e-9, so the card and the host give one answer."""
    from pint_tpu_torch.utils import woodbury_dot, woodbury_dot_split

    dev = r.device
    if phi is not None:
        # a zero prior variance would make 1/phi infinite: pin those
        # columns to ~zero amplitude instead of poisoning the solve
        phi = torch.where(phi > 0.0, phi, 1e-30)
    ntm = M.shape[1]
    Mfull = M if U is None else torch.cat([M, U], dim=1)
    P = Mfull.shape[1]
    Mn, rw, norms = _whiten_normalize(Mfull, r, sigma)
    zeros = torch.zeros(ntm, dtype=F64, device=dev)
    phiinv = torch.zeros(P, dtype=F64, device=dev) if phi is None else \
        torch.cat([zeros, 1.0 / phi])
    prior = (torch.sqrt(phiinv) / norms) ** 2
    thr = EPS_F64 * P if threshold is None else threshold
    if esl is None:
        B = torch.cat([Mn, torch.diag(torch.sqrt(prior))])
        rhs = torch.cat([rw, torch.zeros(P, dtype=F64, device=dev)])
        sol, V, einv, e, bad = _sqrt_solve(B, rhs, thr)
        sol = sol / norms
    else:
        dlo, dhi = ntm + esl[0], ntm + esl[1]
        kidx = torch.cat([torch.arange(dlo), torch.arange(dhi, P)]).to(dev)
        didx = torch.arange(dlo, dhi, device=dev)
        K = Mn[:, kidx]
        D = Mn[:, didx]
        b_D = D.T @ rw
        # D's Gram block is exactly diagonal (disjoint supports); unit
        # column normalization makes its diagonal 1, so D D^T projects
        # and W = I - D diag(c) D^T with c = 1 - sqrt(p/(1+p)) squares
        # to I - D diag(1/(1+p)) D^T: W K's Gram is the Schur complement
        # K^T K - G_DK^T diag(1/d_D) G_DK, and W rw its right-hand side
        d_D = 1.0 + prior[didx]
        c = 1.0 - torch.sqrt(prior[didx] / d_D)
        G_DK = D.T @ K
        Kw = K - D @ (c[:, None] * G_DK)
        rww = rw - D @ (c * b_D)
        nk = K.shape[1]
        B = torch.cat([Kw, torch.diag(torch.sqrt(prior[kidx]))])
        rhs = torch.cat([rww, torch.zeros(nk, dtype=F64, device=dev)])
        sol_K, V, einv, e, bad = _sqrt_solve(B, rhs, thr)
        sol_D = (b_D - G_DK @ sol_K) / d_D
        sol = torch.zeros(P, dtype=F64, device=dev)
        sol[kidx] = sol_K
        sol[didx] = sol_D
        sol = sol / norms
    # (A^-1)_KK is the Schur-complement inverse, and the timing columns
    # are the first npar entries of K
    Sigma_n = (V * einv) @ V.T
    off = torch.zeros((), dtype=F64, device=dev)
    if phi is None:
        if offc is not None:
            w = offc / sigma**2
            off = torch.sum(r * w) / torch.sum(w * offc)
        chi2 = torch.sum(((r - off * offc if offc is not None else r)
                          / sigma) ** 2)
    else:
        if esl is None:
            def cdot(a, b):
                return woodbury_dot(sigma**2, U, phi, a, b)[0]
        else:
            Ue = U[:, esl[0]:esl[1]]
            phie = phi[esl[0]:esl[1]]
            Uf = torch.cat([U[:, :esl[0]], U[:, esl[1]:]], dim=1)
            phif = torch.cat([phi[:esl[0]], phi[esl[1]:]])

            def cdot(a, b):
                return woodbury_dot_split(sigma**2, Ue, phie, Uf, phif,
                                          a, b)[0]
        if offc is not None:
            off = cdot(offc, r) / cdot(offc, offc)
        r_off = r - off * offc if offc is not None else r
        chi2 = cdot(r_off, r_off)
    return {"dx": sol[:npar], "offset": off, "chi2": chi2,
            "Sigma_n": Sigma_n[:npar, :npar], "norms": norms[:npar],
            "noise_ampls": sol[ntm:], "resid_sec": r,
            "n_bad": torch.sum(bad),
            "e_min": float(torch.min(torch.where(bad, float("inf"), e)))}


def _timed(seconds: dict, key: str, dev: torch.device, fn, *args):
    """``fn(*args)``, its host-clock seconds added to ``seconds[key]``
    (after a synchronize on CUDA, so the device work is counted)."""
    t0 = time.perf_counter()
    out = fn(*args)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    seconds[key] = seconds.get(key, 0.0) + time.perf_counter() - t0
    return out


def build_gls_step(model: TimingModel, batch: TOABatch,
                   fit_params: Sequence[str], track_mode: str,
                   threshold: Optional[float] = None,
                   include_offset: bool = True,
                   design_matrix: Optional[str] = None):
    """The GLS Gauss-Newton step ``(x, p) -> dict`` (reference
    `GLSFitter.fit_toas` basis path + `get_gls_mtcm_mtcy`,
    `src/pint/fitter.py:1841,2618`; :func:`pint_tpu.fitter.build_gls_step`):
    the whitened assembly and :func:`gls_solve`, both on the batch's
    device.  The noise basis and the ECORR block's column range are taken
    once per basis (keyed on the identity of the params dict's basis
    leaves); the prior variances are recomputed every step.  A
    non-finite assembly or a failed factorization gives the all-NaN dict
    that the fit guards judge.  ``step.seconds`` accumulates host-clock
    seconds of the assembly and of the solve."""
    names = list(fit_params)
    npar = len(names)
    _assemble = _step_assembler(build_whitened_assembly(
        model, batch, names, track_mode, include_offset,
        design_matrix=design_matrix), batch)
    cache: dict = {}
    dev = batch.device

    def noise(p):
        leaves = [p["const"].get(c.basis_pytree_name)
                  for c in model.correlated_noise_components]
        hit = ("leaves" in cache and len(cache["leaves"]) == len(leaves)
               and all(a is b for a, b in zip(cache["leaves"], leaves)))
        if not hit:
            cache["leaves"] = leaves
            cache["U"] = model.noise_basis(p)
            cache["esl"] = model.ecorr_block(p)
        with torch.no_grad():
            phi = model.noise_weights(p)
        return cache["U"], phi, cache["esl"]

    def solve(r, M, sigma, offc, p):
        U, phi, esl = noise(p)
        with torch.no_grad():
            if not bool(torch.all(torch.isfinite(M))
                        & torch.all(torch.isfinite(r))
                        & torch.all(torch.isfinite(sigma))):
                return _nan_gls_out(r, npar)
            try:
                return gls_solve(r, M, sigma, offc, U, phi, esl, npar,
                                 threshold)
            except torch.linalg.LinAlgError:
                return _nan_gls_out(r, npar)

    def step(x, p):
        r, M, sigma, offc = _timed(step.seconds, "assemble", dev,
                                   _assemble, x, p)
        return _timed(step.seconds, "solve", dev, solve, r, M, sigma, offc,
                      p)

    step.seconds = {}
    return step


def build_gls_fullcov_step(model: TimingModel, batch: TOABatch,
                           fit_params: Sequence[str], track_mode: str,
                           threshold: Optional[float] = None,
                           include_offset: bool = True,
                           design_matrix: Optional[str] = None):
    """The dense-covariance GLS step (reference `GLSFitter.fit_toas`
    ``full_cov=True`` + `get_gls_mtcm_mtcy_fullcov`,
    `src/pint/fitter.py:2601`; :func:`pint_tpu.fitter.
    build_gls_fullcov_step`): C = N + U Phi U^T formed and
    Cholesky-factored, M^T C^-1 M dx = M^T C^-1 r (solved, as
    :func:`gls_solve` solves, through the SVD of its square root
    L^-1 M).  O(N^2) memory: the cross-check of the basis path."""
    names = list(fit_params)
    npar = len(names)
    _assemble = _step_assembler(build_whitened_assembly(
        model, batch, names, track_mode, include_offset,
        design_matrix=design_matrix), batch)

    def solve(r, M, sigma, offc, p):
        from pint_tpu_torch.utils import _cho_factor, _cho_solve

        U = model.noise_basis(p)
        phi = model.noise_weights(p)
        C = torch.diag(sigma**2)
        if phi is not None:
            phi = torch.where(phi > 0.0, phi, 0.0)
            C = C + (U * phi) @ U.T
        L = _cho_factor(C)

        def csolve(b):
            return _cho_solve(L, b)

        # two-stage range-safe column normalization (see fit_wls_svd)
        Mw = M / sigma[:, None]
        cmax = torch.amax(torch.abs(Mw), dim=0)
        cmax = torch.where(cmax == 0.0, 1.0, cmax)
        _, nc = normalize_designmatrix(Mw / cmax)
        norms = cmax * nc
        Mn = M / norms
        # the normal matrix Mn^T C^-1 Mn through the SVD of its square
        # root L^-1 Mn, with the same ABSOLUTE eigenvalue cutoff as
        # build_gls_step's (see gls_solve)
        Lt = torch.linalg.solve_triangular(L, torch.cat(
            [Mn, r[:, None]], dim=1), upper=False)
        thr = EPS_F64 * Mn.shape[1] if threshold is None else threshold
        sol, V, einv, e, bad = _sqrt_solve(Lt[:, :-1], Lt[:, -1], thr)
        sol = sol / norms
        Sigma_n = (V * einv) @ V.T
        off = torch.zeros((), dtype=F64, device=r.device)
        if offc is not None:
            Cio = csolve(offc)
            off = (Cio @ r) / (Cio @ offc)
        r_off = r - off * offc if offc is not None else r
        chi2 = r_off @ csolve(r_off)
        return {"dx": sol[:npar], "offset": off, "chi2": chi2,
                "Sigma_n": Sigma_n[:npar, :npar], "norms": norms[:npar],
                "resid_sec": r, "n_bad": torch.sum(bad),
                "e_min": float(torch.min(torch.where(bad, float("inf"),
                                                     e)))}

    def step(x, p):
        r, M, sigma, offc = _assemble(x, p)
        with torch.no_grad():
            return solve(r, M, sigma, offc, p)

    return step


def _host_noise_basis(model: TimingModel, p: dict):
    """The concatenated noise basis U as host float64 numpy from a params
    dict (:func:`pint_tpu.fitter._host_noise_basis`); None without
    correlated components."""
    comps = [c for c in model.correlated_noise_components
             if c.basis_pytree_name in p["const"]]
    if not comps:
        return None
    return np.concatenate([_np(p["const"][c.basis_pytree_name]).astype(
        np.float64) for c in comps], axis=1)


#: fused-sentinel defaults (:mod:`pint_tpu.fitter`): DIVERGED after this
#: many CONSECUTIVE chi2 increases (each beyond tol_chi2) ...
FUSED_DIVERGE_STREAK = 3
#: ... or after this many consecutive iterations with no new best chi2
#: (the period-2 oscillation detector)
FUSED_STALL_ITERS = 6


def build_fused_fit(model: TimingModel, batch: TOABatch,
                    fit_params: Sequence[str], track_mode: str, *,
                    threshold: Optional[float] = None,
                    include_offset: bool = True, maxiter: int = 2,
                    tol_chi2: float = 1e-8,
                    design_matrix: Optional[str] = None):
    """A whole iterated WLS Gauss-Newton fit with its loop state on the
    device and ONE device-to-host transfer
    (:func:`pint_tpu.fitter.build_fused_fit`, whose ``lax.while_loop``
    becomes a Python loop over device tensors).

    The split assembly's linear columns are computed once per fit.  Each
    iteration: whitened assembly -> :func:`fit_wls_eigh` -> offset-
    profiled chi2 -> :func:`sentinel_advance` -> x += dx, all on the
    device; the only host read per iteration is the int32 status that
    stands in for the while_loop's early exit.  The loop exits on
    CONVERGED, DIVERGED, NONFINITE or ``maxiter``; on DIVERGED/NONFINITE
    it returns the best-so-far x.  After the loop: the final assembly at
    x, one transfer of the flat vector, the host float64 SVD solve
    (:func:`wls_solve` on CPU tensors) whose covariance is the fit's, and
    the final exact Gauss-Newton step with chi2 updated by its
    linearization.  pint_tpu's CPU re-assembly of the final covariance
    is not taken (see :func:`build_wls_step`).

    Returns ``fit(p) -> (x, out)`` with ``out`` the host
    :func:`wls_solve` dict plus ``status`` (:class:`FitStatus`),
    ``iterations``, ``best_chi2`` and ``seconds``: host-clock seconds of
    the device loop up to the fetch (``loop``, which waits for the
    device) and of the host solve and final step (``host_solve``)."""
    names = list(fit_params)
    npar = len(names)
    assemble = build_whitened_assembly(model, batch, names, track_mode,
                                       include_offset,
                                       design_matrix=design_matrix)
    n_rows = batch.ntoas
    ncol = npar + (1 if include_offset else 0)
    host_offc = torch.ones(n_rows, dtype=F64) if include_offset else None
    dev = batch.device

    def run(p):
        zeros = torch.zeros(npar, dtype=F64, device=dev)
        if assemble.split:
            cols = assemble.lin_cols(zeros, p)

            def _asm(x):
                return assemble.inline_with_cols(x, p, cols)
        else:
            def _asm(x):
                return assemble.inline(x, p)

        inf = torch.full((), float("inf"), dtype=F64, device=dev)
        i32 = torch.zeros((), dtype=torch.int32, device=dev)
        x, prev, best_x, best_chi2 = zeros, inf, zeros, inf
        inc_streak, stall_streak, i = i32, i32, i32
        status = i32 + _RUNNING
        for _ in range(maxiter):
            r, M, sigma, offc = _asm(x)
            dpars = fit_wls_eigh(M, r, sigma, threshold)[0]
            if offc is not None:
                w = offc / sigma**2
                off = torch.sum(r * w) / torch.sum(w * offc)
                chi2 = torch.sum(((r - off * offc) / sigma) ** 2)
            else:
                chi2 = torch.sum((r / sigma) ** 2)
            best_x, best_chi2, inc_streak, stall_streak, status = \
                sentinel_advance(x, chi2, prev, best_x, best_chi2,
                                 inc_streak, stall_streak, tol_chi2,
                                 FUSED_DIVERGE_STREAK, FUSED_STALL_ITERS)
            x, prev, i = x + dpars[:npar], chi2, i + 1
            # the while_loop's exit test: the one host read per iteration
            if int(status) != _RUNNING:
                break
        status = torch.where(status == _RUNNING,
                             i32 + int(FitStatus.MAXITER), status)
        # failed runs hand back the best finite iterate, never the
        # poisoned/oscillating last one
        ok = (status == FitStatus.CONVERGED) | (status == FitStatus.MAXITER)
        x = torch.where(ok, x, best_x)
        r, M, sigma, _ = _asm(x)
        tail = torch.stack([status.to(F64), i.to(F64), best_chi2])
        return torch.cat([x, r, sigma, M.reshape(-1), tail])

    def fit(p):
        t0 = time.perf_counter()
        with torch.no_grad():
            flat = run(p).cpu()
        t1 = time.perf_counter()
        x = flat[:npar]
        r = flat[npar:npar + n_rows]
        sigma = flat[npar + n_rows:npar + 2 * n_rows]
        M = flat[npar + 2 * n_rows:-3].reshape(n_rows, ncol)
        status = FitStatus(int(flat[-3]))
        iterations = int(flat[-2])
        best_chi2 = float(flat[-1])
        out = wls_solve(r, M, sigma, host_offc, fit_wls_svd, npar,
                        threshold, host=True)
        if status in (FitStatus.CONVERGED, FitStatus.MAXITER) and \
                not np.isfinite(float(out["chi2"])):
            # the sentinel judged the device chi2; a non-finite host
            # solve makes the fit NONFINITE regardless
            status = FitStatus.NONFINITE
        out.update(status=status, iterations=iterations,
                   best_chi2=best_chi2)
        # the final exact Gauss-Newton step from the device trajectory's
        # end, with residuals and chi2 updated by the linearization it is
        # based on (dr = -M dx); skipped on DIVERGED/NONFINITE, whose x is
        # a best-so-far diagnostic the degradation chain discards
        x = x.numpy()
        dx = _np(out["dx"])
        if status in (FitStatus.CONVERGED, FitStatus.MAXITER) and \
                np.all(np.isfinite(dx)):
            x = x + dx
            r_new = _np(out["resid_sec"]) - _np(M[:, :npar]) @ dx
            s = _np(sigma)
            if host_offc is not None:
                w = 1.0 / s**2
                off = float(np.sum(r_new * w) / np.sum(w))
                out["chi2"] = float(np.sum(((r_new - off) / s) ** 2))
                out["offset"] = off
            else:
                out["chi2"] = float(np.sum((r_new / s) ** 2))
            out["resid_sec"] = r_new
        out["seconds"] = {"loop": t1 - t0,
                          "host_solve": time.perf_counter() - t1}
        return x, out

    fit.run = run
    return fit


def denormalize_covariance(Sigma_n, norms) -> np.ndarray:
    """Host float64 covariance from the normalized one and the column
    norms (:func:`pint_tpu.fitter.denormalize_covariance`)."""
    norms = _np(norms).astype(np.float64)
    return _np(Sigma_n).astype(np.float64) / np.outer(norms, norms)


class FitSummary(NamedTuple):
    """Post-fit record (:class:`pint_tpu.fitter.FitSummary`): ``converged``
    is True for any non-failing finish (CONVERGED or MAXITER); ``status``,
    ``rung`` ("fused"/"eager") and ``guard_trips`` are the guarded
    engine's provenance."""

    chi2: float
    dof: int
    iterations: int
    converged: bool
    status: FitStatus = FitStatus.CONVERGED
    rung: str = ""
    guard_trips: Optional[Dict[str, int]] = None


class Fitter:
    """Base fitter (reference `Fitter`, `src/pint/fitter.py:116`):
    holds (toas, model, resids).  ``device`` (default ``"cuda"``) is where
    the residuals' batch and params dict live.  After a fit, parameter
    values and uncertainties are written back into the model,
    ``parameter_covariance_matrix`` holds the covariance and ``resids``
    reflects the post-fit model."""

    def __init__(self, toas, model: TimingModel,
                 track_mode: Optional[str] = None,
                 residuals: Optional[Residuals] = None,
                 design_matrix: Optional[str] = None,
                 policy: Optional[str] = None, device=None):
        self.toas = toas
        self.model = model
        self.policy = policy
        self.resids = residuals if residuals is not None else \
            Residuals(toas, model, track_mode=track_mode, policy=policy,
                      device=device)
        self.device = self.resids.device
        self.track_mode = self.resids.track_mode
        self.design_matrix = _resolve_design_matrix(design_matrix)
        self.fitresult: Optional[FitSummary] = None
        self.parameter_covariance_matrix: Optional[np.ndarray] = None
        self.covariance_params: List[str] = []
        #: the last fit's final solve: dropped directions ``n_bad`` and
        #: smallest kept normalized eigenvalue ``e_min``; ``seconds``, its
        #: wall split (host clock): after a fused fit into the device
        #: loop, the host solve and the write-back, after an eager fit
        #: into the steps (and, for GLS, their assembly and solve) and the
        #: write-back
        self.fit_info: Dict[str, object] = {}
        #: after a GLS fit: per correlated noise component, the basis
        #: amplitudes and their realization U @ a [s] (host numpy)
        self.noise_ampls: Dict[str, np.ndarray] = {}
        self.noise_resids: Dict[str, np.ndarray] = {}

    @property
    def fit_params(self) -> List[str]:
        """Free parameters the linear step moves (all free device params
        but noise-component ones)."""
        noise = {type(c).__name__ for c in self.model.noise_components}
        out = [n for n in self.model.free_params
               if self.model.param_component(n) not in noise]
        skipped = [n for n in self.model.free_params if n not in out]
        if skipped:
            warnings.warn(
                f"free noise parameters {skipped} are not fit by "
                f"{type(self).__name__}; freeze them")
        return out

    def fit_toas(self, maxiter: int = 2, **kw) -> float:
        raise NotImplementedError

    # -- reporting --------------------------------------------------------
    def update_model(self):
        """Record fit provenance into the model (START/FINISH/NTOA/CHI2/
        CHI2R/TRES), as the reference does post-fit."""
        m, r = self.model, self.resids
        mjds = _np(r.batch.tdbld)
        m.START.value = f"{mjds.min():.4f}"
        m.FINISH.value = f"{mjds.max():.4f}"
        m.NTOA.value = str(self.toas.ntoas)
        chi2 = r.calc_chi2()
        m.CHI2.value = f"{chi2:.4f}"
        m.CHI2R.value = f"{chi2 / r.dof:.6f}"
        m.TRES.value = f"{r.rms_weighted() * 1e6:.4f}"

    def _record_provenance(self, rung_statuses=None):
        """Stamp which rung of the degradation chain produced the accepted
        solution, its FitStatus and, after a degraded fit, every
        attempted rung's status onto the model."""
        fr = self.fitresult
        self.model.fit_provenance = {
            "fitter": type(self).__name__,
            "rung": fr.rung,
            "status": fr.status.name,
            "rung_statuses": {k: v.name
                              for k, v in (rung_statuses or {}).items()},
        }

    # -- steps ------------------------------------------------------------
    def _device_pdict(self):
        """The current params dict: the residuals' dict already lives on
        the fitter's device."""
        return self.resids.pdict

    def _make_step(self, names, threshold, include_offset):
        return build_wls_step(self.model, self.resids.batch, names,
                              self.track_mode, threshold=threshold,
                              include_offset=include_offset,
                              design_matrix=self.design_matrix)

    def _cached_step(self, names, threshold, include_offset):
        """One step function reused across fits of the same structure."""
        key = (tuple(names), threshold, include_offset, self.design_matrix)
        if getattr(self, "_step_cache_key", None) != key:
            self._step_cache_key = key
            self._step_cache = self._make_step(names, threshold,
                                               include_offset)
        return self._step_cache

    # -- fused whole-fit path ---------------------------------------------
    def _fused_ok(self) -> bool:
        """Whether fit_toas runs the fused device loop
        (:func:`build_fused_fit`): on CUDA, keyed on the fitter's device,
        as pint_tpu takes it on accelerators; the CPU keeps the eager
        step loop."""
        return self.device.type == "cuda"

    def _cached_fused(self, names, threshold, include_offset, maxiter,
                      tol_chi2):
        key = (tuple(names), threshold, include_offset, maxiter, tol_chi2,
               self.design_matrix)
        if getattr(self, "_fused_cache_key", None) != key:
            self._fused_cache_key = key
            self._fused_cache = build_fused_fit(
                self.model, self.resids.batch, names, self.track_mode,
                threshold=threshold, include_offset=include_offset,
                maxiter=maxiter, tol_chi2=tol_chi2,
                design_matrix=self.design_matrix)
        return self._fused_cache

    def _fit_fused(self, maxiter, threshold, tol_chi2=1e-8) -> float:
        m = self.model
        names = self.fit_params
        p = self._device_pdict()
        include_offset = "PhaseOffset" not in m.components
        fit = self._cached_fused(names, threshold, include_offset, maxiter,
                                 tol_chi2)
        x, out = fit(p)
        status = out["status"]
        self.fit_info = {"n_bad": int(out["n_bad"]),
                         "e_min": float(out["e_min"]),
                         "seconds": dict(out["seconds"])}
        if status in (FitStatus.DIVERGED, FitStatus.NONFINITE):
            # nothing has been written back to the model, so the eager
            # rung restarts from the same state
            return self._degraded_fit(status, maxiter, threshold, tol_chi2)
        if int(out["n_bad"]):
            warnings.warn(
                f"{int(out['n_bad'])} degenerate parameter "
                "combination(s) dropped by SVD threshold",
                DegeneracyWarning)
        Sigma = denormalize_covariance(out["Sigma_n"], out["norms"])
        r = self.resids
        seed_ok = (r.subtract_mean and r.use_weighted_mean) or \
            (not r.subtract_mean and float(out["offset"]) == 0.0)
        seed = (_np(out["resid_sec"]), float(out["offset"])) if seed_ok \
            else None
        t0 = time.perf_counter()
        self._finalize(p, x, Sigma, names, resid_seed=seed)
        self.fit_info["seconds"]["write_back"] = time.perf_counter() - t0
        self.fitresult = FitSummary(
            float(out["chi2"]), self.resids.dof, out["iterations"], True,
            status=status, rung="fused", guard_trips={})
        self._record_provenance()
        return float(out["chi2"])

    def _degraded_fit(self, fused_status, maxiter, threshold,
                      tol_chi2) -> float:
        """fused -> eager stepwise (:meth:`pint_tpu.fitter.Fitter.
        _degraded_fit` without its damped-LM rung, which is not ported):
        the eager rung gets one attempt; when it fails too,
        :class:`~pint_tpu_torch.exceptions.ConvergenceFailure` carries the
        statuses of the rungs tried."""
        statuses = {"fused": fused_status}
        warnings.warn(
            f"fused fit ended {fused_status.name}; degrading to the "
            "eager stepwise fitter", FitDegradedWarning)
        try:
            chi2 = self._fit_eager(maxiter=max(maxiter, 8),
                                   threshold=threshold, tol_chi2=tol_chi2)
            statuses["eager"] = st = self.fitresult.status
        except ConvergenceFailure as e:
            st = e.status if e.status is not None else FitStatus.NONFINITE
            statuses["eager"] = st
            chi2 = float("nan")
        if np.isfinite(chi2) and st not in (FitStatus.DIVERGED,
                                            FitStatus.NONFINITE):
            self.fitresult = self.fitresult._replace(rung="eager")
            self._record_provenance(statuses)
            return chi2
        raise ConvergenceFailure(
            "fit failed through the degradation chain (fused -> eager; "
            "the damped-LM rung is not ported): "
            f"{ {k: v.name for k, v in statuses.items()} }",
            status=st, rung_statuses=statuses)

    # -- write-back -------------------------------------------------------
    def _store_noise(self, out: dict, p: dict):
        """Per-component noise realizations from the solve's basis
        amplitudes (reference `fitter.py:1952-1968`;
        :meth:`pint_tpu.fitter.Fitter._store_noise`), each U @ a formed on
        the basis's device.  A solve without amplitudes (WLS, the
        full-covariance path, a failed solve) drops stale ones."""
        self.noise_ampls = {}
        self.noise_resids = {}
        if "noise_ampls" not in out:
            return
        ampls = out["noise_ampls"]
        k = 0
        for c in self.model.correlated_noise_components:
            U = p["const"][c.basis_pytree_name]
            w = U.shape[1]
            a = torch.as_tensor(ampls[k:k + w], device=U.device)
            self.noise_ampls[type(c).__name__] = _np(a)
            with torch.no_grad():
                self.noise_resids[type(c).__name__] = _np(U @ a)
            k += w

    def _seed_resids(self, r_sec: np.ndarray, offset: float):
        """Prime the post-fit residual cache from the fit's final assembly
        (unsubtracted residuals [s] + profiled offset) instead of running
        the residual pipeline again: with the default all-ones offset
        regressor and 1/sigma^2 weights, the offset-profiled residuals ARE
        the weighted-mean-subtracted residuals."""
        r = self.resids
        nt = r.batch.ntoas
        r._phase_resids = np.asarray(
            (r_sec[:nt] - offset) * float(self.model.F0.value))
        r._chi2_cache = None

    def _finalize(self, p: dict, x, Sigma: np.ndarray, names: List[str],
                  resid_seed=None):
        """Write the solution back into the host parameters and their
        uncertainties, refresh the residuals and record the provenance.
        ``x`` is host numpy, so the offsets fold back with no device
        read."""
        m = self.model
        p2 = m.with_x(p, _np(x), names)
        m.apply_deltas(p2)
        diag = np.diag(np.asarray(Sigma))
        if not np.all(np.isfinite(diag)):
            # a poisoned solve must not write NaN uncertainties into the
            # model as if they were measurements
            bad = [n for n, v in zip(names, diag) if not np.isfinite(v)]
            warnings.warn(
                f"non-finite parameter covariance for {bad}; their "
                "uncertainties are left unset", PintTpuWarning)
        for i, n in enumerate(names):
            if np.isfinite(diag[i]):
                m[n].set_device_uncertainty(
                    float(np.sqrt(max(diag[i], 0.0))))
        self.parameter_covariance_matrix = np.asarray(Sigma)
        self.covariance_params = list(names)
        self.resids.update()
        if resid_seed is not None:
            self._seed_resids(*resid_seed)
        self.update_model()


class WLSFitter(Fitter):
    """Iterated linear WLS (reference `WLSFitter`,
    `src/pint/fitter.py:1703`; :class:`pint_tpu.fitter.WLSFitter`): on
    CUDA the fused device loop, on the CPU the guarded eager step loop,
    whose steps that raise chi2 beyond ``max_chi2_increase`` are
    backtracked by halving down to ``min_lambda``.  A fit whose chi2
    goes non-finite raises :class:`~pint_tpu_torch.exceptions.
    ConvergenceFailure` instead of returning the poisoned number."""

    def fit_toas(self, maxiter: int = 2, threshold: Optional[float] = None,
                 tol_chi2: float = 1e-8, min_lambda: float = 1e-3,
                 max_chi2_increase: float = 1e-2) -> float:
        if self._fused_ok():
            return self._fit_fused(maxiter, threshold, tol_chi2)
        return self._fit_eager(maxiter=maxiter, threshold=threshold,
                               tol_chi2=tol_chi2, min_lambda=min_lambda,
                               max_chi2_increase=max_chi2_increase)

    def _fit_eager(self, maxiter: int = 2,
                   threshold: Optional[float] = None,
                   tol_chi2: float = 1e-8, min_lambda: float = 1e-3,
                   max_chi2_increase: float = 1e-2) -> float:
        """The guarded eager step loop (also the degradation chain's
        second rung).  Each accepted trial's step output doubles as the
        next iteration's linearization and, at the end, as the final
        solve."""
        m = self.model
        names = self.fit_params
        p = self._device_pdict()
        include_offset = "PhaseOffset" not in m.components
        step = self._cached_step(names, threshold, include_offset)
        guard_trips: Dict[str, int] = {}

        def trip(name):
            guard_trips[name] = guard_trips.get(name, 0) + 1

        t_start = time.perf_counter()
        if hasattr(step, "seconds"):
            step.seconds.clear()
        x = np.zeros(len(names))
        out = step(x, p)
        chi2 = float(out["chi2"])
        if not np.isfinite(chi2):
            trip("eager_nonfinite")
            raise ConvergenceFailure(
                f"chi2 is non-finite ({chi2}) at the start point: "
                "poisoned uncertainties or residuals (check the TOA "
                "validation policy)", status=FitStatus.NONFINITE)
        status = FitStatus.MAXITER
        it = -1
        for it in range(maxiter):
            if int(out["n_bad"]):
                warnings.warn(
                    f"{int(out['n_bad'])} degenerate parameter "
                    "combination(s) dropped by SVD threshold",
                    DegeneracyWarning)
            dx = _np(out["dx"])
            if not np.all(np.isfinite(dx)):
                # a NaN/inf step cannot be walked
                trip("eager_nonfinite_step")
                status = FitStatus.NONFINITE
                break
            lam = 1.0
            trial = None
            while True:
                cand = step(x + lam * dx, p)
                t_chi2 = float(cand["chi2"])
                if np.isfinite(t_chi2) and \
                        t_chi2 <= chi2 + max_chi2_increase:
                    trial = cand
                    break
                trip("eager_backtrack")
                lam *= 0.5
                if lam < min_lambda:
                    break
            if trial is None:
                # no acceptable step length even at min lambda: stop at
                # the (finite) pre-step x instead of walking uphill
                trip("eager_step_rejected")
                status = FitStatus.DIVERGED
                break
            x = x + lam * dx
            improvement = chi2 - t_chi2
            chi2 = t_chi2
            out = trial
            if abs(improvement) < tol_chi2:
                status = FitStatus.CONVERGED
                break
        if status is FitStatus.NONFINITE:
            raise ConvergenceFailure(
                "WLS solve produced a non-finite step "
                f"(iteration {it}); chi2 at the last good point: "
                f"{chi2:.6g}", status=FitStatus.NONFINITE)
        # `out` IS the step output at x (the last accepted trial), so it
        # is the final solve too
        seconds = {"steps": time.perf_counter() - t_start,
                   **getattr(step, "seconds", {})}
        self.fit_info = {"n_bad": int(out["n_bad"]),
                         "e_min": float(out["e_min"]), "seconds": seconds}
        t0 = time.perf_counter()
        Sigma = denormalize_covariance(out["Sigma_n"], out["norms"])
        self._store_noise(out, p)
        # seed the post-fit residuals from the final assembly; not under
        # correlated noise, whose offset is profiled in the C^-1 metric
        # rather than the weighted mean the residuals subtract
        r = self.resids
        seed_ok = not self.model.has_correlated_errors and (
            (r.subtract_mean and r.use_weighted_mean) or
            (not r.subtract_mean and float(out["offset"]) == 0.0))
        seed = (_np(out["resid_sec"]), float(out["offset"])) \
            if seed_ok else None
        self._finalize(p, x, Sigma, names, resid_seed=seed)
        seconds["write_back"] = time.perf_counter() - t0
        if status is FitStatus.DIVERGED:
            warnings.warn(
                "no acceptable step length found (chi2 rises even at "
                f"lambda={min_lambda:g}); returning the best point "
                "found", PintTpuWarning)
        self.fitresult = FitSummary(
            float(out["chi2"]), self.resids.dof, it + 1,
            status in (FitStatus.CONVERGED, FitStatus.MAXITER),
            status=status, rung="eager", guard_trips=guard_trips)
        self._record_provenance()
        return float(out["chi2"])


class GLSFitter(WLSFitter):
    """Generalized least squares over the augmented [timing | noise-basis]
    design matrix (reference `GLSFitter`, `src/pint/fitter.py:1821`;
    :class:`pint_tpu.fitter.GLSFitter`); chi2 is the Woodbury
    r^T C^-1 r.  Also valid (and equal to WLS) with no correlated
    components.  Every step assembles and solves on the fitter's device
    (:func:`build_gls_step`), in the guarded eager loop.

    ``fit_toas(full_cov=True)`` switches to the dense-covariance solve
    (:func:`build_gls_fullcov_step`), the O(N^2) cross-check of the basis
    path."""

    #: selected by fit_toas(full_cov=...); invalidates the cached step
    full_cov = False

    def fit_toas(self, maxiter: int = 2, *, full_cov: bool = False,
                 **kw) -> float:
        if full_cov != self.full_cov:
            self.full_cov = full_cov
            self._step_cache_key = None
        return super().fit_toas(maxiter=maxiter, **kw)

    def _make_step(self, names, threshold, include_offset):
        build = build_gls_fullcov_step if self.full_cov else build_gls_step
        return build(self.model, self.resids.batch, names, self.track_mode,
                     threshold=threshold, include_offset=include_offset,
                     design_matrix=self.design_matrix)

    def _fused_ok(self) -> bool:
        # never fused, as in pint_tpu: the GLS fit is the eager step loop
        # on every device (a fused GLS loop is not a feature of the
        # reference)
        return False
