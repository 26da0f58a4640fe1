"""Logging setup with repeated-message suppression.

Reference: `pint.logging` (`src/pint/logging.py`, 372 LoC
of loguru configuration): its load-bearing behaviors are (a) one-line
opt-in setup with a level, (b) de-duplication of repeated warnings, and
(c) rerouting python ``warnings`` through the logger.  This module
provides the same three on the standard library logger — no third-party
logging dependency.
"""

from __future__ import annotations

import logging as _logging
import warnings as _warnings
from typing import Optional

__all__ = ["setup", "log", "child", "DedupFilter"]

log = _logging.getLogger("pint_tpu")


def child(name: str) -> _logging.Logger:
    """A namespaced child of the package logger (``pint_tpu.<name>``):
    subsystem modules (``runtime``, ``multihost``) log through it so
    records carry their origin while riding the one configured handler
    and its :class:`DedupFilter`."""
    return log.getChild(name)


class DedupFilter(_logging.Filter):
    """Drop messages already emitted (reference `LogFilter`,
    `src/pint/logging.py:192`): each distinct message
    text is shown at most ``max_repeats`` times."""

    def __init__(self, max_repeats: int = 1):
        super().__init__()
        self.max_repeats = max_repeats
        self._seen: dict = {}

    def filter(self, record: _logging.LogRecord) -> bool:
        key = (record.levelno, record.getMessage())
        n = self._seen.get(key, 0)
        self._seen[key] = n + 1
        return n < self.max_repeats

    def reset(self):
        self._seen.clear()


_state = {"handler": None, "filter": None, "showwarning": None}


def setup(level: str = "INFO", dedup: bool = True,
          capture_warnings: bool = True,
          stream=None) -> Optional[DedupFilter]:
    """Configure the ``pint_tpu`` logger (reference `pint.logging.setup`,
    `src/pint/logging.py:247`): attach one stream
    handler at ``level``, optionally de-duplicate repeats and reroute
    ``warnings.warn`` through the logger.  Idempotent."""
    if _state["handler"] is not None:
        log.removeHandler(_state["handler"])
    handler = _logging.StreamHandler(stream)
    handler.setFormatter(_logging.Formatter(
        "%(levelname)s (%(name)s): %(message)s"))
    filt = None
    if dedup:
        filt = DedupFilter()
        handler.addFilter(filt)
    log.addHandler(handler)
    log.setLevel(level.upper())
    _state["handler"], _state["filter"] = handler, filt

    if capture_warnings:
        if _state["showwarning"] is None:
            _state["showwarning"] = _warnings.showwarning

        def showwarning(message, category, filename, lineno, file=None,
                        line=None):
            log.warning("%s: %s", category.__name__, message)

        _warnings.showwarning = showwarning
    elif _state["showwarning"] is not None:
        _warnings.showwarning = _state["showwarning"]
        _state["showwarning"] = None
    return filt
