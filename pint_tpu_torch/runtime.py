"""Verified checkpoints and the checkpointed chunked scan.

Port of the checkpoint and scan part of :mod:`pint_tpu.runtime`: a long
grid scan that dies at 95% loses everything unless it can resume.

* :func:`write_checkpoint` / :func:`load_checkpoint`: atomic,
  CRC32-checksummed ``.npz`` checkpoints (write to a temporary file, then
  ``os.replace``); a truncated or bit-flipped file raises a typed
  :class:`~pint_tpu_torch.exceptions.CheckpointCorruptError` on load.
  The format is pint_tpu's, so a checkpoint either package writes loads
  in the other.
* :func:`run_checkpointed_scan`: the chunked scan engine behind the
  ``checkpoint=``/``resume=`` keywords of
  :func:`pint_tpu_torch.gridutils.grid_chisq_flat`.  It runs a scan in
  chunks, writes a checkpoint after each, records SIGTERM/SIGINT instead
  of dying so that it can flush a final checkpoint and raise
  :class:`~pint_tpu_torch.exceptions.ScanInterrupted`, and on resume
  restores the completed chunks bit-identically to an uninterrupted run.
  A chunk whose values come back non-finite or whose dispatch raises is
  retried up to ``max_retries`` times, then requeued onto the caller's
  fallback path; each chunk's :class:`ChunkStatus` goes into a
  :class:`ScanSummary`.

The failpoints of :mod:`pint_tpu_torch.faultinject` drive every guard.
"""

from __future__ import annotations

import enum
import os
import signal
import threading
import zlib
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np

from pint_tpu_torch import faultinject
from pint_tpu_torch.exceptions import CheckpointCorruptError, ScanInterrupted
from pint_tpu_torch.logging import child as _logchild

__all__ = ["write_checkpoint", "load_checkpoint", "scan_signature",
           "ChunkStatus", "ScanSummary", "run_checkpointed_scan"]

_log = _logchild("runtime")

CHECKPOINT_VERSION = 1


def _arrays_crc(arrays: Dict[str, np.ndarray]) -> int:
    """CRC32 over names, dtypes, shapes and bytes of every array, in
    sorted-name order: any truncation, bit flip, or dropped or renamed
    entry changes it."""
    crc = 0
    for k in sorted(arrays):
        a = np.ascontiguousarray(np.asarray(arrays[k]))
        crc = zlib.crc32(k.encode(), crc)
        crc = zlib.crc32(str(a.dtype).encode(), crc)
        crc = zlib.crc32(np.asarray(a.shape, np.int64).tobytes(), crc)
        crc = zlib.crc32(a.tobytes(), crc)
    return crc & 0xFFFFFFFF


def write_checkpoint(path: str, arrays: Dict[str, np.ndarray]) -> None:
    """Atomically write ``arrays`` to ``path`` as an ``.npz`` with an
    embedded CRC32: a reader never sees a half-written file, and
    :func:`load_checkpoint` verifies the checksum."""
    payload = {k: np.asarray(v) for k, v in arrays.items()}
    crc = _arrays_crc(payload)
    tmp = path + f".tmp{os.getpid()}.npz"
    np.savez(tmp, _crc32=np.uint32(crc),
             _version=np.int64(CHECKPOINT_VERSION), **payload)
    os.replace(tmp, path)


def load_checkpoint(path: str) -> Dict[str, np.ndarray]:
    """Load a checkpoint written by :func:`write_checkpoint`, raising
    :class:`~pint_tpu_torch.exceptions.CheckpointCorruptError` on a
    truncated or unreadable container or a CRC mismatch.  A checkpoint
    without an embedded CRC loads unverified."""
    try:
        with np.load(path, allow_pickle=False) as f:
            data = {k: np.asarray(f[k]) for k in f.files}
    except Exception as e:
        raise CheckpointCorruptError(
            f"checkpoint {path!r} is unreadable (truncated or corrupt "
            f"container): {type(e).__name__}: {e}") from e
    stored = data.pop("_crc32", None)
    data.pop("_version", None)
    if stored is not None and int(stored) != _arrays_crc(data):
        raise CheckpointCorruptError(
            f"checkpoint {path!r} failed its CRC32 integrity check "
            f"(stored {int(stored):#010x}, recomputed "
            f"{_arrays_crc(data):#010x}): the file was corrupted after "
            "it was written")
    return data


def scan_signature(tag: str, grid_values: Dict[str, np.ndarray],
                   names, maxiter: int, chunk_size: int) -> str:
    """A fingerprint of the scan's configuration, stored in its
    checkpoints, so that a resume against another grid or fit
    configuration is refused instead of mixing results."""
    crc = 0
    for k in sorted(grid_values):
        a = np.ascontiguousarray(np.asarray(grid_values[k], np.float64))
        crc = zlib.crc32(k.encode(), crc)
        crc = zlib.crc32(a.tobytes(), crc)
    return (f"{tag}|names={','.join(names)}|maxiter={maxiter}"
            f"|cs={chunk_size}|grid_crc={crc & 0xFFFFFFFF:#010x}")


class ChunkStatus(enum.IntEnum):
    """Terminal state of one scan chunk."""

    OK = 0         #: first dispatch returned finite values
    RETRIED = 1    #: succeeded after >= 1 retry of the primary path
    REROUTED = 2   #: primary path exhausted; the fallback path succeeded
    FAILED = 3     #: every attempt (and the fallback) failed


#: checkpoint code for "not yet run"
_PENDING = -1


class ScanSummary(NamedTuple):
    """What happened in one checkpointed chunked scan."""

    n_points: int
    chunk_size: int
    n_chunks: int
    statuses: Tuple[ChunkStatus, ...]   #: per-chunk terminal status
    retries: int                        #: primary-path re-dispatches
    reroutes: int                       #: chunks requeued to the fallback
    failures: int                       #: chunks with no usable result
    resumed_chunks: int                 #: chunks restored by resume
    checkpoint: Optional[str]

    @property
    def ok(self) -> bool:
        return self.failures == 0

    def counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for s in self.statuses:
            out[s.name] = out.get(s.name, 0) + 1
        return out


class _SignalFlush:
    """Install SIGTERM/SIGINT handlers that record the signal instead of
    killing the process, so that the scan loop can flush a final
    checkpoint and raise :class:`ScanInterrupted` at the next chunk
    boundary.  No-op outside the main thread (``signal.signal`` is
    main-thread only)."""

    SIGNALS = (signal.SIGTERM, signal.SIGINT)

    def __init__(self):
        self.fired: Optional[int] = None
        self._old: dict = {}

    def __enter__(self):
        if threading.current_thread() is not threading.main_thread():
            return self
        for sig in self.SIGNALS:
            try:
                self._old[sig] = signal.signal(sig, self._handler)
            except (ValueError, OSError):  # pragma: no cover
                pass
        return self

    def _handler(self, signum, frame):
        self.fired = signum

    def __exit__(self, *exc):
        for sig, old in self._old.items():
            try:
                signal.signal(sig, old)
            except (ValueError, OSError):  # pragma: no cover
                pass
        return False


def run_checkpointed_scan(
        n_points: int,
        run_chunk: Callable[[int, int, int], np.ndarray],
        chunk_size: Optional[int] = None,
        fallback: Optional[Callable[[int, int, int], np.ndarray]] = None,
        checkpoint: Optional[str] = None,
        resume: bool = False,
        max_retries: int = 2,
        checkpoint_every: int = 1,
        signature: str = "",
) -> Tuple[np.ndarray, ScanSummary]:
    """Run a scan of ``n_points`` results in chunks, preemption-
    tolerantly.  Returns ``(results, ScanSummary)``.

    ``run_chunk(ci, lo, hi)`` computes the ``(hi - lo,)`` float results
    of chunk ``ci`` (one vmapped grid dispatch); ``fallback(ci, lo, hi)``
    is the requeue path (the unbatched fit per point), tried once after
    ``max_retries`` re-dispatches of the primary path all raised or
    returned non-finite values.

    With ``checkpoint`` set, a CRC32-verified checkpoint is written
    atomically every ``checkpoint_every`` completed chunks, a
    SIGTERM/SIGINT arriving mid-scan flushes a final checkpoint and
    raises :class:`~pint_tpu_torch.exceptions.ScanInterrupted` at the
    next chunk boundary, and ``resume=True`` skips the chunks completed
    before (their results are restored from the checkpoint, not
    recomputed).  ``FAILED`` chunks are run again on resume.

    Failpoints (:mod:`pint_tpu_torch.faultinject`): ``chunk_nonfinite``
    and ``chunk_raise`` wrap the primary dispatch, ``sigterm_midscan``
    the hook after each chunk, ``corrupt_checkpoint`` the file itself."""
    n_points = int(n_points)
    cs = int(chunk_size) if chunk_size else n_points
    if n_points <= 0:
        raise ValueError("n_points must be positive")
    if cs <= 0:
        raise ValueError("chunk_size must be positive")
    n_chunks = -(-n_points // cs)

    results = np.full(n_points, np.nan, np.float64)
    statuses = np.full(n_chunks, _PENDING, np.int8)
    retries = reroutes = failures = 0
    resumed_chunks = 0

    if resume and checkpoint and os.path.exists(checkpoint):
        data = load_checkpoint(checkpoint)
        stored_sig = bytes(np.asarray(
            data.get("signature", np.zeros(0, np.uint8)),
            np.uint8)).decode(errors="replace")
        if (int(data["n_points"]) != n_points
                or int(data["chunk_size"]) != cs
                or (signature and stored_sig != signature)):
            raise ValueError(
                f"checkpoint {checkpoint!r} does not match this scan "
                f"configuration (stored n_points="
                f"{int(data['n_points'])}/chunk_size="
                f"{int(data['chunk_size'])}/signature={stored_sig!r}; "
                f"requested {n_points}/{cs}/{signature!r})")
        results = np.asarray(data["results"], np.float64).copy()
        statuses = np.asarray(data["statuses"], np.int8).copy()
        # FAILED chunks are requeued on resume; completed ones are final
        statuses[statuses == ChunkStatus.FAILED] = _PENDING
        retries = int(data.get("retries", 0))
        reroutes = int(data.get("reroutes", 0))
        resumed_chunks = int(np.sum(statuses != _PENDING))
        if resumed_chunks:
            _log.info("resuming scan from %s: %d/%d chunks already done",
                      checkpoint, resumed_chunks, n_chunks)

    def _flush() -> None:
        if not checkpoint:
            return
        write_checkpoint(checkpoint, {
            "results": results, "statuses": statuses,
            "n_points": np.int64(n_points), "chunk_size": np.int64(cs),
            "retries": np.int64(retries), "reroutes": np.int64(reroutes),
            "signature": np.frombuffer(signature.encode(), np.uint8),
        })

    after_chunk = faultinject.wrap("sigterm_midscan", lambda ci: None)
    ck_every = max(1, int(checkpoint_every))
    with _SignalFlush() as sigs:
        for ci in range(n_chunks):
            if statuses[ci] != _PENDING:
                continue
            lo, hi = ci * cs, min(n_points, (ci + 1) * cs)
            runner = faultinject.wrap(
                "chunk_nonfinite", faultinject.wrap("chunk_raise",
                                                    run_chunk))
            vals: Optional[np.ndarray] = None
            status = ChunkStatus.FAILED
            for attempt in range(max_retries + 1):
                if attempt:
                    retries += 1
                try:
                    # one fetch per chunk dispatch: the chunk is the unit
                    # of retry and checkpoint
                    v = np.asarray(runner(ci, lo, hi), np.float64)
                except ScanInterrupted:
                    raise
                except Exception as e:
                    _log.warning(
                        "scan chunk %d/%d dispatch raised (attempt %d): "
                        "%s: %s", ci, n_chunks, attempt + 1,
                        type(e).__name__, e)
                    continue
                if v.shape != (hi - lo,):
                    raise ValueError(
                        f"run_chunk returned shape {v.shape}, expected "
                        f"({hi - lo},)")
                if np.all(np.isfinite(v)):
                    vals = v
                    status = ChunkStatus.OK if attempt == 0 else \
                        ChunkStatus.RETRIED
                    break
                _log.warning(
                    "scan chunk %d/%d returned non-finite values "
                    "(attempt %d)", ci, n_chunks, attempt + 1)
            if vals is None and fallback is not None:
                # requeue onto the fallback path; its values are kept even
                # when non-finite (a partial grid is useful), but only
                # finite values count as a successful reroute
                _log.warning("scan chunk %d/%d requeued onto the "
                             "fallback path", ci, n_chunks)
                try:
                    v = np.asarray(fallback(ci, lo, hi), np.float64)
                except ScanInterrupted:
                    raise
                except Exception as e:
                    _log.warning(
                        "scan chunk %d/%d fallback raised: %s: %s",
                        ci, n_chunks, type(e).__name__, e)
                else:
                    vals = v
                    if np.all(np.isfinite(v)):
                        status = ChunkStatus.REROUTED
                        reroutes += 1
            if vals is not None:
                results[lo:hi] = vals
            if status == ChunkStatus.FAILED:
                failures += 1
            statuses[ci] = status
            after_chunk(ci)
            done = int(np.sum(statuses != _PENDING))
            if (done % ck_every == 0) or ci == n_chunks - 1:
                _flush()
            if sigs.fired is not None:
                _flush()
                raise ScanInterrupted(
                    f"scan interrupted by signal {sigs.fired} after "
                    f"chunk {ci} ({done}/{n_chunks} chunks done"
                    + (f"; checkpoint flushed to {checkpoint}"
                       if checkpoint else "; no checkpoint configured")
                    + ")",
                    checkpoint=checkpoint, chunks_done=done,
                    n_chunks=n_chunks, signum=sigs.fired)
    _flush()
    summary = ScanSummary(
        n_points=n_points, chunk_size=cs, n_chunks=n_chunks,
        statuses=tuple(ChunkStatus(int(s)) for s in statuses),
        retries=retries, reroutes=reroutes, failures=failures,
        resumed_chunks=resumed_chunks, checkpoint=checkpoint)
    return results, summary
