"""Shared numeric helpers (host + device).

Port of :mod:`pint_tpu.utils`.  The device half (Taylor-Horner series,
design-matrix column normalization, the Woodbury and Sherman-Morrison
products of the GLS noise model, the device choice) is PyTorch; the
host half (``PosVel``, ``split_prefixed_name``, ...) is a copy of the
numpy-only helpers of :mod:`pint_tpu.utils`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``device`` if given, else
    ``"cuda"``.  Asking for CUDA where there is none raises — the port
    never falls back to the CPU quietly; pass ``device="cpu"`` for that.
    A CUDA device comes back with its index (``cuda`` -> ``cuda:0``), as
    tensors report theirs, so devices compare equal to tensors'."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "pint_tpu_torch runs on CUDA by default and no CUDA device is "
            'available; pass device="cpu" to run on the CPU')
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def get_xp(x):
    """numpy for numpy arrays and Python scalars, torch for tensors."""
    return torch if isinstance(x, torch.Tensor) else np


def taylor_horner(dt, coeffs):
    """Evaluate sum_k coeffs[k] * dt^k / k! by Horner's rule (same
    operation order as :func:`pint_tpu.utils.taylor_horner`).  Works for
    numpy arrays and tensors (pure arithmetic)."""
    acc = 0.0 * dt
    for k in range(len(coeffs) - 1, -1, -1):
        acc = acc * dt / (k + 1.0) + coeffs[k]
    return acc


def taylor_horner_deriv(dt, coeffs, deriv_order=1):
    """d^n/dt^n of `taylor_horner`: the same series on the coefficient
    tail."""
    return taylor_horner(dt, coeffs[deriv_order:])


def normalize_designmatrix(M, params=None):
    """Scale design-matrix columns to unit norm; returns (M_normalized,
    norms).  Zero-norm columns are left unscaled (norm reported as 1)."""
    xp = get_xp(M)
    norms = xp.sqrt(xp.sum(M * M, axis=0))
    safe = xp.where(norms == 0.0, 1.0, norms)
    return M / safe, safe


def sherman_morrison_dot(Ndiag, U, phi, x, y):
    """x^T C^-1 y and logdet C for C = diag(Ndiag) + phi U U^T, U with
    DISJOINT columns (the ECORR quantization basis), where the
    Sherman-Morrison update per column is exact and independent
    (:func:`pint_tpu.utils.sherman_morrison_dot`, reference
    `utils.py:3047`).  Returns (dot, logdet)."""
    Ninv_x = x / Ndiag
    Ninv_y = y / Ndiag
    dot = torch.sum(x * Ninv_y)
    logdet = torch.sum(torch.log(Ndiag))
    Utx = U.T @ Ninv_x
    Uty = U.T @ Ninv_y
    UtNU = torch.sum((U * U).T / Ndiag, dim=1)
    denom = 1.0 + phi * UtNU
    dot = dot - torch.sum(phi * Utx * Uty / denom)
    logdet = logdet + torch.sum(torch.log(denom))
    return dot, logdet


def woodbury_dot(Ndiag, U, Phidiag, x, y):
    """x^T C^-1 y and logdet C for C = diag(Ndiag) + U diag(Phidiag) U^T
    (:func:`pint_tpu.utils.woodbury_dot`, reference `utils.py:3097`).
    Returns (dot, logdet)."""
    Ninv_x = x / Ndiag
    Ninv_y = y / Ndiag
    UtNx = U.T @ Ninv_x
    UtNy = U.T @ Ninv_y
    Sigma = (U.T / Ndiag) @ U + torch.diag(1.0 / Phidiag)
    cf = _cho_factor(Sigma)
    expval = _cho_solve(cf, UtNy)
    dot = torch.sum(x * Ninv_y) - UtNx @ expval
    logdet = (torch.sum(torch.log(Ndiag)) + torch.sum(torch.log(Phidiag))
              + 2.0 * torch.sum(torch.log(_diag_of(cf))))
    return dot, logdet


def ecorr_ninv_apply(Ndiag, Ue, phie, X):
    """``(diag(N) + Ue diag(phie) Ue^T)^-1 X`` for DISJOINT 0/1 indicator
    columns ``Ue`` (the ECORR quantization basis): the Sherman-Morrison
    update per column is exact and independent, so the inverse applies
    as two matrix products, with no factorization
    (:func:`pint_tpu.utils.ecorr_ninv_apply`).  ``X`` is a vector or an
    (N, m) matrix."""
    vec = X.ndim == 1
    Xm = X[:, None] if vec else X
    Ninv_X = Xm / Ndiag[:, None]
    s = torch.sum((Ue * Ue).T / Ndiag, dim=1)          # (k,)
    coef = phie / (1.0 + phie * s)                     # (k,)
    NinvUe = Ue / Ndiag[:, None]
    out = Ninv_X - NinvUe @ (coef[:, None] * (Ue.T @ Ninv_X))
    return out[:, 0] if vec else out


def woodbury_dot_split(Ndiag, Ue, phie, Uf, phif, x, y):
    """``x^T C^-1 y`` and ``logdet C`` for
    ``C = diag(N) + Ue diag(phie) Ue^T + Uf diag(phif) Uf^T``, ``Ue`` the
    disjoint ECORR block (eliminated in closed form by
    :func:`ecorr_ninv_apply`) and ``Uf`` the dense bases (Fourier red/DM),
    so the only factorization is a Cholesky of the small (nfourier,
    nfourier) inner matrix (:func:`pint_tpu.utils.woodbury_dot_split`).
    Equal to :func:`woodbury_dot` with ``U = [Ue | Uf]``."""
    Cinv_y = ecorr_ninv_apply(Ndiag, Ue, phie, y)
    s = torch.sum((Ue * Ue).T / Ndiag, dim=1)
    logdet = torch.sum(torch.log(Ndiag)) + torch.sum(torch.log1p(phie * s))
    dot = torch.sum(x * Cinv_y)
    if Uf.shape[1] == 0:
        return dot, logdet
    Cinv_x = ecorr_ninv_apply(Ndiag, Ue, phie, x)
    CinvUf = ecorr_ninv_apply(Ndiag, Ue, phie, Uf)
    Sigma = Uf.T @ CinvUf + torch.diag(1.0 / phif)
    cf = _cho_factor(Sigma)
    a = Uf.T @ Cinv_x
    b = Uf.T @ Cinv_y
    dot = dot - a @ _cho_solve(cf, b)
    logdet = logdet + torch.sum(torch.log(phif)) \
        + 2.0 * torch.sum(torch.log(_diag_of(cf)))
    return dot, logdet


def _cho_factor(A):
    """The lower Cholesky factor of a symmetric positive-definite A."""
    return torch.linalg.cholesky(A)


def _cho_solve(L, b):
    """A^-1 b from A's lower Cholesky factor L (two triangular solves)."""
    vec = b.ndim == 1
    B = b[:, None] if vec else b
    y = torch.linalg.solve_triangular(L, B, upper=False)
    out = torch.linalg.solve_triangular(L.T, y, upper=True)
    return out[:, 0] if vec else out


def _diag_of(L):
    return torch.diagonal(L)


class PosVel(NamedTuple):
    """A position+velocity pair (3-vectors or (...,3) arrays), with frame
    bookkeeping by convention only (both in the same inertial frame).

    Equivalent of the reference's `PosVel` (`src/pint/utils.py:182`), minus
    astropy units: positions in meters, velocities in m/s unless stated.
    """

    pos: np.ndarray
    vel: np.ndarray

    def __add__(self, other):
        return PosVel(self.pos + other.pos, self.vel + other.vel)

    def __sub__(self, other):
        return PosVel(self.pos - other.pos, self.vel - other.vel)

    def __neg__(self):
        return PosVel(-self.pos, -self.vel)


def interval_hash(lo: float, hi: float) -> int:
    """Stable hash for (mjd-range) mask caching."""
    return hash((round(float(lo), 9), round(float(hi), 9)))


def split_prefixed_name(name: str):
    """Split 'F12' -> ('F', 12), 'DMX_0003' -> ('DMX_', 3).

    Equivalent of reference `split_prefixed_name` (`src/pint/utils.py:500`).
    Raises ValueError when there is no trailing integer index.
    """
    i = len(name)
    while i > 0 and name[i - 1].isdigit():
        i -= 1
    if i == len(name):
        raise ValueError(f"{name!r} has no numeric suffix")
    return name[:i], int(name[i:])


def open_or_use(path_or_file, mode="r"):
    """Context manager accepting either a path or an open file object."""
    import contextlib
    import io
    import os

    if isinstance(path_or_file, (str, bytes, os.PathLike)):
        return open(path_or_file, mode)
    return contextlib.nullcontext(path_or_file)


def dmxparse(fitter):
    """Summarize the DMX model of a fitted model (reference `dmxparse`,
    `src/pint/utils.py:1085`): returns a dict with the
    DMX epochs, values, (fit) uncertainties, range bounds, and the
    mean-subtracted values conventionally plotted."""
    import numpy as np

    model = fitter.model
    comp = model.components.get("DispersionDMX")
    if comp is None:
        raise ValueError("model has no DispersionDMX component")
    names = comp.dmx_names()
    vals = np.array([float(comp.params[n].value) for n in names])
    errs = np.array([
        float(comp.params[n].uncertainty)
        if comp.params[n].uncertainty is not None else np.nan
        for n in names])
    r1 = np.array([comp.params[f"DMXR1_{n.split('_')[1]}"].mjd_float
                   for n in names])
    r2 = np.array([comp.params[f"DMXR2_{n.split('_')[1]}"].mjd_float
                   for n in names])
    eps = 0.5 * (r1 + r2)
    # variance-weighted mean subtraction (reference ibid: mean_dmx)
    w = 1.0 / np.where(np.isfinite(errs) & (errs > 0), errs, np.inf) ** 2
    mean = np.sum(vals * w) / np.sum(w) if np.any(w > 0) else vals.mean()
    return {
        "dmxs": vals, "dmx_verrs": errs, "dmxeps": eps,
        "r1s": r1, "r2s": r2, "bins": names,
        "mean_dmx": mean, "dmxs_sub": vals - mean,
    }
