"""Device-resident TOA data: a frozen struct-of-arrays of tensors.

Port of :mod:`pint_tpu.toabatch`: the TOA columns the compute core needs,
staged once per dataset onto one device and closed over by the residual,
design-matrix and fit functions.  Host-side bookkeeping (flags,
observatory names, selection, clock corrections) lives in
:mod:`pint_tpu_torch.toa`.

Unit conventions (as :mod:`pint_tpu.toabatch`):

* times: TDB MJD as ``(day:int64, frac:float64)`` two-part values with
  ``|frac| <= 0.5``, plus the exact three-word float32 split of ``frac``.
* positions: light-seconds; velocities: dimensionless (v/c).
* frequencies: MHz (inf = infinite frequency / barycentered data).
* uncertainties: microseconds.
"""

from __future__ import annotations

import dataclasses
import os
import warnings
from typing import Dict, Optional

import numpy as np
import torch

from pint_tpu_torch.exceptions import InvalidTOAs, PintTpuWarning
from pint_tpu_torch.utils import resolve_device


class ValidationWarning(PintTpuWarning):
    """TOA batch validation found invalid rows and the active policy
    ("mask"/"warn") handled them without raising."""


#: the three user-facing input-validation policies (see
#: :func:`make_batch`); "off" additionally exists for INTERNAL trusted
#: reference batches (the 1-row TZR batch carries a deliberate zero
#: uncertainty — it is a phase reference, not a measurement)
VALIDATE_POLICIES = ("raise", "mask", "warn", "off")

#: explicit downweight sentinel [us] for invalid rows under policy="warn"
#: (same sentinel as :data:`pint_tpu.toabatch.DOWNWEIGHT_ERROR_US`)
DOWNWEIGHT_ERROR_US = 1e12


def resolve_validate_policy(policy: Optional[str]) -> str:
    """``policy`` if given, else $PINT_TPU_VALIDATE, else "raise"."""
    if policy is None:
        policy = os.environ.get("PINT_TPU_VALIDATE", "raise")
    if policy not in VALIDATE_POLICIES:
        raise ValueError(
            f"validation policy must be one of {VALIDATE_POLICIES}, "
            f"got {policy!r}")
    return policy


def split_f64_words(x: np.ndarray, nwords: int = 3) -> np.ndarray:
    """Exact host-side split of true-IEEE float64 values into ``nwords``
    non-overlapping float32 words (last axis).  sum(words) == x to 24*nwords
    bits."""
    x = np.asarray(x, np.float64)
    out = np.zeros(x.shape + (nwords,), np.float32)
    r = x.copy()
    for k in range(nwords):
        w = r.astype(np.float32)
        out[..., k] = w
        r = r - w.astype(np.float64)
    return out


@dataclasses.dataclass(frozen=True)
class TOABatch:
    """Struct-of-arrays TOA data on one device (every column on the same
    device; float columns float64, ``tdb_day`` int64, ``tdb_frac_w``
    float32)."""

    #: TDB epoch at the observatory, integer MJD part, shape (N,)
    tdb_day: torch.Tensor
    #: TDB epoch fractional MJD part (|frac| <= 0.5), shape (N,)
    tdb_frac: torch.Tensor
    #: exact 3-word float32 decomposition of tdb_frac, shape (N, 3): the
    #: quad-single phase arithmetic consumes these words
    tdb_frac_w: torch.Tensor
    #: TOA uncertainty [us], shape (N,)
    error_us: torch.Tensor
    #: observing frequency [MHz] (inf for barycentric/infinite), shape (N,)
    freq_mhz: torch.Tensor
    #: observatory position wrt SSB [light-s], shape (N, 3)
    ssb_obs_pos_ls: torch.Tensor
    #: observatory velocity wrt SSB [v/c, dimensionless], shape (N, 3)
    ssb_obs_vel_c: torch.Tensor
    #: Sun position wrt observatory [light-s], shape (N, 3)
    obs_sun_pos_ls: torch.Tensor
    #: tracked absolute pulse numbers (nan where absent), shape (N,)
    pulse_number: torch.Tensor
    #: planet positions wrt observatory [light-s], each shape (N, 3)
    obs_planet_pos_ls: Dict[str, torch.Tensor]

    @property
    def ntoas(self) -> int:
        return self.tdb_day.shape[0]

    @property
    def device(self) -> torch.device:
        return self.tdb_day.device

    @property
    def tdbld(self) -> torch.Tensor:
        """Lossy float64 TDB MJD (for quantities insensitive to ns)."""
        return self.tdb_day + self.tdb_frac

    def columns(self) -> Dict[str, object]:
        """The fields by name (planet positions as a nested dict)."""
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)}

    def replace(self, **changes) -> "TOABatch":
        return dataclasses.replace(self, **changes)

    def select(self, mask) -> "TOABatch":
        """Row-subset along the TOA axis (boolean mask or index array)."""
        idx = torch.as_tensor(np.asarray(mask), device=self.device)
        return TOABatch(**{
            k: ({p: v[idx] for p, v in col.items()} if isinstance(col, dict)
                else col[idx])
            for k, col in self.columns().items()})


def _validate_rows(day_f, frac64, error, policy):
    """The input-validation policy of :func:`pint_tpu.toabatch._validate_rows`:
    non-finite/zero/negative uncertainties and non-finite MJDs, judged on
    the host before anything reaches the device.  Returns
    ``(keep_mask_or_None, error, day_f, frac64)``."""
    bad_sigma = ~np.isfinite(error) | (error <= 0.0)
    bad_mjd = ~(np.isfinite(day_f) & np.isfinite(frac64))
    bad = bad_sigma | bad_mjd
    if not bad.any():
        return None, error, day_f, frac64
    msg = (f"invalid TOA rows: {int(bad_sigma.sum())} non-finite/"
           f"nonpositive uncertainties, {int(bad_mjd.sum())} non-finite "
           f"MJDs (of {len(bad)} TOAs)")
    if policy == "raise":
        raise InvalidTOAs(
            msg + '; use policy="mask" to drop them or policy="warn" '
            "to downweight them")
    if policy == "mask":
        warnings.warn(msg + f"; masking {int(bad.sum())} TOA(s)",
                      ValidationWarning)
        return ~bad, error, day_f, frac64
    warnings.warn(
        msg + f"; downweighting {int(bad.sum())} TOA(s) to "
        f"error={DOWNWEIGHT_ERROR_US:g} us", ValidationWarning)
    error = np.where(bad, DOWNWEIGHT_ERROR_US, error)
    good_day = day_f[~bad_mjd]
    fill_day = float(good_day[0]) if good_day.size else 50000.0
    day_f = np.where(bad_mjd, fill_day, day_f)
    frac64 = np.where(bad_mjd, 0.0, frac64)
    return None, error, day_f, frac64


def make_batch(
    tdb_day,
    tdb_frac,
    error_us,
    freq_mhz,
    ssb_obs_pos_ls=None,
    ssb_obs_vel_c=None,
    obs_sun_pos_ls=None,
    pulse_number=None,
    obs_planet_pos_ls: Optional[Dict[str, np.ndarray]] = None,
    policy: Optional[str] = None,
    device=None,
) -> TOABatch:
    """Build a TOABatch on ``device`` (default ``"cuda"``), filling absent
    geometry with zeros (data already at the solar-system barycenter).

    ``policy`` ("raise" | "mask" | "warn"; default $PINT_TPU_VALIDATE ->
    "raise") governs invalid inputs exactly as
    :func:`pint_tpu.toabatch.make_batch` does.
    """
    dev = resolve_device(device)
    policy = resolve_validate_policy(policy)
    frac64 = np.asarray(tdb_frac, np.float64)
    day_f = np.asarray(tdb_day, np.float64)
    error = np.broadcast_to(
        np.asarray(error_us, np.float64), frac64.shape).copy()
    keep = None
    if policy != "off":
        if frac64.shape[0] == 0:
            if policy == "warn":
                warnings.warn("empty TOA selection (0 rows)",
                              ValidationWarning)
            else:
                raise InvalidTOAs(
                    "empty TOA selection: cannot build a 0-row TOABatch "
                    '(policy="warn" to permit)')
        keep, error, day_f, frac64 = _validate_rows(day_f, frac64, error,
                                                    policy)
    if keep is not None:
        if not keep.any():
            raise InvalidTOAs(
                "every TOA row is invalid; nothing left after masking")
        frac64, day_f, error = frac64[keep], day_f[keep], error[keep]
        freq_mhz = np.asarray(freq_mhz, np.float64)[keep]
        ssb_obs_pos_ls = None if ssb_obs_pos_ls is None else \
            np.asarray(ssb_obs_pos_ls)[keep]
        ssb_obs_vel_c = None if ssb_obs_vel_c is None else \
            np.asarray(ssb_obs_vel_c)[keep]
        obs_sun_pos_ls = None if obs_sun_pos_ls is None else \
            np.asarray(obs_sun_pos_ls)[keep]
        pulse_number = None if pulse_number is None else \
            np.asarray(pulse_number)[keep]
        if obs_planet_pos_ls is not None:
            obs_planet_pos_ls = {k: np.asarray(v)[keep]
                                 for k, v in obs_planet_pos_ls.items()}
    n = frac64.shape[0]

    def f64(x, default=None):
        if x is None:
            x = default
        return torch.tensor(np.asarray(x, np.float64), device=dev)

    z3 = np.zeros((n, 3))
    return TOABatch(
        tdb_day=torch.as_tensor(np.asarray(day_f, np.int64), device=dev),
        tdb_frac=f64(frac64),
        tdb_frac_w=torch.as_tensor(split_f64_words(frac64), device=dev),
        error_us=f64(error),
        freq_mhz=f64(np.broadcast_to(np.asarray(freq_mhz, np.float64),
                                     (n,))),
        ssb_obs_pos_ls=f64(ssb_obs_pos_ls, z3),
        ssb_obs_vel_c=f64(ssb_obs_vel_c, z3),
        obs_sun_pos_ls=f64(obs_sun_pos_ls, z3),
        pulse_number=f64(pulse_number, np.full((n,), np.nan)),
        obs_planet_pos_ls=({} if obs_planet_pos_ls is None
                           else {k: f64(v)
                                 for k, v in obs_planet_pos_ls.items()}),
    )


def pad_batch_to(batch: TOABatch, n: int) -> TOABatch:
    """Pad the TOA axis to EXACTLY ``n`` rows by repeating the last row
    with ``DOWNWEIGHT_ERROR_US`` uncertainty (chi2/fit-neutral)."""
    if batch.ntoas > n:
        raise ValueError(
            f"cannot pad a {batch.ntoas}-row batch down to {n} rows")
    if batch.ntoas == n:
        return batch
    idx = np.concatenate([np.arange(batch.ntoas),
                          np.full(n - batch.ntoas, batch.ntoas - 1)])
    out = batch.select(idx)
    err = out.error_us.clone()
    err[batch.ntoas:] = DOWNWEIGHT_ERROR_US
    return out.replace(error_us=err)


def concatenate(batches) -> TOABatch:
    """Concatenate batches along the TOA axis (planet dicts must agree)."""
    batches = list(batches)
    keys = set(batches[0].obs_planet_pos_ls)
    for b in batches[1:]:
        if set(b.obs_planet_pos_ls) != keys:
            raise ValueError("cannot concatenate TOABatches with differing planet sets")
    cols = [b.columns() for b in batches]
    return TOABatch(**{
        k: ({p: torch.cat([c[k][p] for c in cols]) for p in keys}
            if k == "obs_planet_pos_ls" else torch.cat([c[k] for c in cols]))
        for k in cols[0]})
