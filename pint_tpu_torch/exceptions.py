"""Typed exception/warning taxonomy for pint_tpu.

Mirrors the role of the reference's exception module
(``src/pint/exceptions.py``): every failure mode raised by the framework has a
named type so callers can catch precisely.
"""


class PintTpuError(Exception):
    """Base class for all pint_tpu errors."""


# --- model / parameter errors -------------------------------------------------
class TimingModelError(PintTpuError):
    """Generic error constructing or evaluating a timing model."""


class MissingParameter(TimingModelError):
    """A parameter needed by a component is absent from the model/par file."""

    def __init__(self, module="", param="", msg=None):
        self.module = module
        self.param = param
        super().__init__(msg or f"{module} is missing parameter {param!r}")


class MissingBinaryError(TimingModelError):
    """BINARY was requested but no/unknown binary model given."""


class UnknownParameter(TimingModelError):
    """A par-file line names a parameter no component owns."""


class UnknownBinaryModel(TimingModelError):
    """BINARY value names an unimplemented binary model."""


class AliasConflict(TimingModelError):
    """Two components claim the same parameter alias."""


class PrefixError(TimingModelError):
    """Malformed prefix parameter name (e.g. F0, DMX_0001)."""


class InvalidModelParameters(TimingModelError):
    """Parameter values outside the physical domain (e.g. ECC > 1)."""


class ComponentConflict(TimingModelError):
    """Two mutually exclusive components in one model."""


# --- TOA / data errors --------------------------------------------------------
class TOAError(PintTpuError):
    """Generic TOA-layer error."""


class TimFileError(TOAError):
    """Malformed .tim file line or command."""


class InvalidTOAs(TOAError):
    """TOA data failed batch validation (non-finite/nonpositive
    uncertainties, non-finite MJDs, or an empty selection) under
    ``policy="raise"`` — see :func:`pint_tpu.toabatch.make_batch`."""


# --- observatory / clock ------------------------------------------------------
class ObservatoryError(PintTpuError):
    """Unknown observatory or bad observatory definition."""


class ClockCorrectionError(PintTpuError):
    """Base for clock-correction problems."""


class NoClockCorrections(ClockCorrectionError):
    """No clock file available for an observatory."""


class ClockCorrectionOutOfRange(ClockCorrectionError):
    """TOA outside the span of the clock file."""


# --- ephemeris ----------------------------------------------------------------
class EphemerisError(PintTpuError):
    """Solar-system ephemeris unavailable or out of range."""


# --- fitting ------------------------------------------------------------------
class FitError(PintTpuError):
    """Base class for fitter failures."""


class ConvergenceFailure(FitError):
    """Iterative fit failed to converge.

    When raised by the guarded fit engine's degradation chain
    (``Fitter._fit_fused`` fused -> eager stepwise -> damped LM), the
    exception carries the evidence: ``status`` is the terminal
    :class:`pint_tpu.fitter.FitStatus` and ``rung_statuses`` maps each
    attempted rung name (``"fused"``/``"eager"``/``"lm"``) to the
    status it ended with, so callers can see exactly how far the chain
    got before giving up."""

    def __init__(self, msg="", status=None, rung_statuses=None):
        self.status = status
        self.rung_statuses = dict(rung_statuses or {})
        super().__init__(msg)


class MaxiterReached(ConvergenceFailure):
    """Downhill fitter hit the iteration cap without meeting tolerance."""


class StepProblem(ConvergenceFailure):
    """No acceptable step length found in line search."""


class CorrelatedErrors(FitError):
    """Fitter cannot handle the model's correlated-noise structure."""

    def __init__(self, model):
        trouble = [c.__class__.__name__ for c in getattr(model, "noise_components", [])]
        super().__init__(
            f"Model has correlated errors ({trouble}); use a GLS-capable fitter"
        )


# --- execution / preemption ---------------------------------------------------
class CheckpointError(PintTpuError):
    """Base for scan/chain checkpoint problems."""


class CheckpointCorruptError(CheckpointError):
    """A checkpoint file failed its integrity check on load: the ``.npz``
    container is truncated/unreadable, or the stored CRC32 does not match
    the recomputed checksum of the arrays (see
    :func:`pint_tpu.runtime.load_checkpoint`).  Raised instead of the
    numpy/zipfile internals so a resume caller can catch one type and
    decide to restart from scratch."""


class ScanInterrupted(PintTpuError):
    """A checkpointed chunked scan received SIGTERM/SIGINT.  A final
    checkpoint was flushed before this was raised (when a checkpoint path
    was configured), so re-running with ``resume=True`` continues from
    the last completed chunk bit-identically.

    Attributes: ``checkpoint`` (path or None), ``chunks_done``,
    ``n_chunks``, ``signum``."""

    def __init__(self, msg="", checkpoint=None, chunks_done=0,
                 n_chunks=0, signum=None):
        self.checkpoint = checkpoint
        self.chunks_done = chunks_done
        self.n_chunks = n_chunks
        self.signum = signum
        super().__init__(msg)


class ServeError(PintTpuError):
    """Base for timing-service (``pint_tpu.serve``) failures."""


class ServeSaturated(ServeError):
    """The timing service's bounded request queue is full — backpressure,
    not a crash: the job was never admitted and can be resubmitted once
    in-flight batches drain (or to another replica)."""


class ServeDrained(ServeError):
    """The timing service is draining (SIGTERM/shutdown): admission is
    closed and this job was not fitted.  When the service has a spool
    configured, every still-queued job was flushed there through the
    checkpoint machinery before this was raised, so
    ``TimingService.resume_spool`` on a restarted daemon readmits them
    bit-identically.

    Attributes: ``spool`` (path or None), ``n_spooled``, ``signum``."""

    def __init__(self, msg="", spool=None, n_spooled=0, signum=None):
        self.spool = spool
        self.n_spooled = n_spooled
        self.signum = signum
        super().__init__(msg)


class ServePoisoned(ServeError):
    """A job was isolated as the poison member of a coalesced bucket
    batch: its bucket dispatch failed (or produced a non-finite row) and
    the solo eager-lane confirmation fit (the degradation chain)
    also failed to produce a finite result.  The batch-mates were
    re-served bit-identically; only this job carries the error.  A
    flight-recorder dump (reason ``"ServePoisoned"``) was written when a
    dump path is configured.

    Attributes: ``job`` (request name), ``bucket`` (structure key), and
    ``cause`` (the underlying exception, or None for a non-finite
    result with no raise)."""

    def __init__(self, msg="", job=None, bucket=None, cause=None):
        self.job = job
        self.bucket = bucket
        self.cause = cause
        super().__init__(msg)


class ServeDeadlineExceeded(ServeError):
    """The job's deadline expired while it was still queued, before its
    bucket was staged for dispatch — deadlines are checked at
    admission, at batch-take time, and once more at pre-staging (the
    take-to-stage scheduler gap), never mid-dispatch, so an expired
    job costs zero device work.

    Attributes: ``deadline_s`` (the relative deadline the job was
    submitted with), ``waited_s`` (how long it actually queued)."""

    def __init__(self, msg="", deadline_s=None, waited_s=None):
        self.deadline_s = deadline_s
        self.waited_s = waited_s
        super().__init__(msg)


class ServeOverCapacity(ServeError):
    """Admitting this job would push the predicted device peak bytes
    (from the compiled bucket program's cost card, or a conservative
    shape-based estimate when no card exists yet) past the service's
    configured ``max_device_bytes`` — the job is rejected *before* it
    can OOM the device.  A job whose own bucket can never fit is
    rejected immediately; one that could fit once in-flight batches
    drain is rejected only after a bounded wait.

    Attributes: ``predicted_bytes``, ``limit_bytes``."""

    def __init__(self, msg="", predicted_bytes=None, limit_bytes=None):
        self.predicted_bytes = predicted_bytes
        self.limit_bytes = limit_bytes
        super().__init__(msg)


class ServeCancelled(ServeError):
    """The job was cancelled via ``ServeFuture.cancel()`` while still
    queued (cancellation is only possible before staging; an in-flight
    job cannot be cancelled)."""


class GatewayError(PintTpuError):
    """Base for network front-door (``pint_tpu.gateway``) failures."""


class GatewayBadRequest(GatewayError):
    """A submitted job payload could not be decoded into a (model,
    TOAs) pair — malformed JSON, a missing column, or a par file the
    model builder rejects.  Maps to HTTP 400: the request is wrong,
    retrying it unchanged cannot succeed."""


class GatewayQuotaExceeded(GatewayError):
    """The tenant's token bucket cannot cover this request at its
    priority class — over-quota admission control, not queue pressure.
    Maps to HTTP 429 with a Retry-After hint; the request was never
    handed to the timing service, so retrying after the hint is safe.

    Attributes: ``tenant``, ``priority``, ``retry_after_s``."""

    def __init__(self, msg="", tenant=None, priority=None,
                 retry_after_s=None):
        self.tenant = tenant
        self.priority = priority
        self.retry_after_s = retry_after_s
        super().__init__(msg)


class GatewayIdempotencyConflict(GatewayError):
    """An idempotency key was replayed with a DIFFERENT payload than
    the one it originally admitted (payload CRCs disagree).  Maps to
    HTTP 409: honoring the replay would silently fit the wrong data
    under the original job id.

    Attributes: ``key``, ``expected_crc``, ``got_crc``."""

    def __init__(self, msg="", key=None, expected_crc=None,
                 got_crc=None):
        self.key = key
        self.expected_crc = expected_crc
        self.got_crc = got_crc
        super().__init__(msg)


class MultihostTimeoutError(PintTpuError):
    """A multi-host rendezvous (``multihost.init``) or collective barrier
    did not complete within its deadline — a peer process is likely dead
    or never joined.  Replaces the indefinite hang."""


# --- warnings -----------------------------------------------------------------
class PintTpuWarning(UserWarning):
    """Base warning class."""


class DegeneracyWarning(PintTpuWarning):
    """Near-degenerate combination of fit parameters detected (thresholded)."""


class ClockCorrectionWarning(PintTpuWarning):
    """Clock corrections missing/stale but proceeding anyway."""


class PrecisionWarning(PintTpuWarning):
    """An operation may have lost double-double precision."""


class ApproximateEphemerisWarning(PintTpuWarning):
    """Analytic (non-JPL) ephemeris in use; absolute barycentering is ~µs-level."""
