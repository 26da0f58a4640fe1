"""Weighted-least-squares fitting on the device, with autodiff design matrices.

Port of the parts of :mod:`pint_tpu.fitter` that the chi2 grid reaches:
the whitened, two-stage column-normalized WLS solve (reference
`fit_wls_svd`, `src/pint/fitter.py:2551`) by SVD or by
the normal-equations eigh kernel, the residual function whose forward-mode
jacobian is the design matrix, and the split assembly that computes the
linear-parameter columns once and differentiates only the nonlinear core.
The fitters' ``fit_toas`` loops are not ported yet (see ROADMAP.md).

Everything here is plain PyTorch on the batch's device; the phase chain
inside the residual function is the ``qs_phase_frac`` kernel.  The
jacobians are ``torch.func.jacfwd`` (a ``vmap`` of ``jvp`` over basis
tangents): the primal evaluation runs once and every tangent lane goes
through the kernel wrapper's analytic tangent rule.
"""

from __future__ import annotations

import warnings
from typing import List, Optional, Sequence

import numpy as np
import torch
from torch.func import jacfwd

from pint_tpu_torch.models.timing_model import TimingModel, pv
from pint_tpu_torch.residuals import Residuals, raw_phase_resids
from pint_tpu_torch.toabatch import TOABatch
from pint_tpu_torch.utils import normalize_designmatrix

__all__ = ["Fitter", "WLSFitter", "fit_wls_svd", "fit_wls_eigh",
           "masked_eigh_inverse", "wls_solve", "build_resid_sec_fn",
           "build_whitened_assembly"]

#: float64 machine epsilon: the H100, like the CPU, has IEEE float64, so
#: the degeneracy thresholds are those of pint_tpu's CPU backend
EPS_F64 = float(np.finfo(np.float64).eps)


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
    U, S, Vh = torch.linalg.svd(Mn, full_matrices=False)
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
    e, V = torch.linalg.eigh(G)
    S = torch.sqrt(torch.clamp(e, min=0.0))
    if threshold is None:
        threshold = EPS_F64 * max(n_rows, G.shape[0])
    efloor = EPS_F64 * G.shape[0] * torch.clamp(e[-1], min=0.0)
    bad = (S <= threshold * S[-1]) | (e <= efloor)
    einv = torch.where(bad, 0.0, 1.0 / torch.where(bad, 1.0, e))
    return V, einv, torch.sum(bad)


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
    per step.  ``"full"``: one jacfwd over everything (also used when no
    parameter is linear).  The eager, cache-refreshing assembly of
    pint_tpu's ``fit_toas`` comes with that fitter loop."""
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

    assemble_inline.inline = assemble_inline
    assemble_inline.lin_cols = lin_cols
    assemble_inline.inline_with_cols = inline_with_cols
    assemble_inline.split = True
    assemble_inline.lin_names, assemble_inline.nl_names = lin_names, nl_names
    assemble_inline.design_matrix = "split"
    return assemble_inline


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


def wls_solve(r, M, sigma, offc, kern, npar, threshold=None):
    """One WLS solve + chi2 from a whitened assembly (the device path of
    :func:`pint_tpu.fitter.wls_solve`): chi2 is evaluated at x with the
    offset profiled out."""
    dpars, Sigma_n, norms, n_bad = kern(M, r, sigma, threshold)
    if offc is not None:
        w = offc / sigma**2
        off = torch.sum(r * w) / torch.sum(w * offc)
        r_off = r - off * offc
    else:
        off = torch.zeros((), dtype=r.dtype, device=r.device)
        r_off = r
    chi2 = torch.sum((r_off / sigma) ** 2)
    return {"dx": dpars[:npar], "offset": off, "chi2": chi2,
            "Sigma_n": Sigma_n[:npar, :npar], "norms": norms[:npar],
            "resid_sec": r, "n_bad": n_bad}


class Fitter:
    """Base fitter (reference `Fitter`, `src/pint/fitter.py:116`):
    holds (toas, model, resids).  ``device`` (default ``"cuda"``) is where
    the residuals' batch and params dict live."""

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
        raise NotImplementedError(
            "fit_toas is not ported yet; grid fits run through "
            "pint_tpu_torch.gridutils.grid_chisq_flat")


class WLSFitter(Fitter):
    """Iterated linear WLS (reference `WLSFitter`,
    `src/pint/fitter.py:1703`)."""
