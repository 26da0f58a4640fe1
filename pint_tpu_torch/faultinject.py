"""Failpoints of the checkpointed chunked scan.

Port of the failpoint mechanism of :mod:`pint_tpu.faultinject` and its
four scan failpoints, which drive :func:`pint_tpu_torch.runtime.
run_checkpointed_scan`'s guards: chunk retry, requeue onto the fallback
path, the SIGTERM flush, and checkpoint integrity.  Core code calls
``faultinject.wrap("name", fn)``, which is ``fn`` itself unless an
injection named ``name`` is active; each failpoint is a context manager
that registers its wrapper for the length of the block.
"""

from __future__ import annotations

import contextlib
import os
import signal
from typing import Iterator, Sequence

import numpy as np

__all__ = ["wrap", "is_active", "chunk_nonfinite", "chunk_raise",
           "sigterm_midscan", "corrupt_checkpoint"]

#: active registry failpoints: name -> wrapper factory ``fn -> fn'``
_active: dict = {}


def is_active(name: str) -> bool:
    return name in _active


def wrap(name: str, fn):
    """The failpoint hook core code consults: returns ``fn`` unless an
    injection named ``name`` is active, in which case the injection's
    wrapper of ``fn``."""
    factory = _active.get(name)
    return fn if factory is None else factory(fn)


@contextlib.contextmanager
def _registered(name: str, factory) -> Iterator[None]:
    if name in _active:
        raise RuntimeError(f"faultinject {name!r} already active")
    _active[name] = factory
    try:
        yield
    finally:
        _active.pop(name, None)


@contextlib.contextmanager
def chunk_nonfinite(chunks: Sequence[int] = (0,),
                    times: int = 1) -> Iterator[None]:
    """Failpoint ``"chunk_nonfinite"``: the scan chunks in ``chunks``
    return NaN-poisoned values for their first ``times`` dispatches, the
    transient garbage a flaky device produces.  The scan must retry
    (``ChunkStatus.RETRIED``) and converge to the clean values."""
    hit = set(int(c) for c in chunks)
    counts: dict = {}

    def factory(fn):
        def poisoned(ci, lo, hi):
            out = np.asarray(fn(ci, lo, hi), np.float64)
            if ci in hit and counts.get(ci, 0) < times:
                counts[ci] = counts.get(ci, 0) + 1
                out = out.copy()
                out[:] = np.nan
            return out
        return poisoned

    with _registered("chunk_nonfinite", factory):
        yield


@contextlib.contextmanager
def chunk_raise(chunks: Sequence[int] = (0,),
                times: int = 1) -> Iterator[None]:
    """Failpoint ``"chunk_raise"``: the scan chunks in ``chunks`` raise
    from their first ``times`` dispatches, the crashed-dispatch failure
    (device out of memory, a failed launch).  ``times > max_retries``
    drives the requeue onto the fallback path (``ChunkStatus.REROUTED``)."""
    hit = set(int(c) for c in chunks)
    counts: dict = {}

    def factory(fn):
        def crashing(ci, lo, hi):
            if ci in hit and counts.get(ci, 0) < times:
                counts[ci] = counts.get(ci, 0) + 1
                raise RuntimeError(
                    f"injected dispatch failure on chunk {ci} "
                    "(chunk_raise failpoint)")
            return fn(ci, lo, hi)
        return crashing

    with _registered("chunk_raise", factory):
        yield


@contextlib.contextmanager
def sigterm_midscan(after_chunk: int = 0) -> Iterator[None]:
    """Failpoint ``"sigterm_midscan"``: deliver a real SIGTERM to this
    process right after scan chunk ``after_chunk`` completes, as a
    preemption notice does (the scan's handler flushes a final checkpoint
    and raises ``ScanInterrupted`` at the chunk boundary)."""
    def factory(fn):
        def fire(ci):
            fn(ci)
            if ci == after_chunk:
                os.kill(os.getpid(), signal.SIGTERM)
        return fire

    with _registered("sigterm_midscan", factory):
        yield


@contextlib.contextmanager
def corrupt_checkpoint(path: str, mode: str = "truncate") -> Iterator[None]:
    """Corrupt the checkpoint file at ``path`` in place, restored on exit:
    ``"truncate"`` cuts the file in half (a crash mid-write on a
    non-atomic filesystem, a partial copy), ``"flip"`` flips one byte in
    the middle (bit rot: the container may still unzip, so only the CRC32
    catches it).  Loading must raise ``CheckpointCorruptError``."""
    with open(path, "rb") as fh:
        orig = fh.read()
    if mode == "truncate":
        bad = orig[: max(1, len(orig) // 2)]
    elif mode == "flip":
        pos = len(orig) // 2
        bad = orig[:pos] + bytes([orig[pos] ^ 0xFF]) + orig[pos + 1:]
    else:
        raise ValueError(f"unknown corruption mode {mode!r}")
    with open(path, "wb") as fh:
        fh.write(bad)
    try:
        yield
    finally:
        with open(path, "wb") as fh:
            fh.write(orig)
