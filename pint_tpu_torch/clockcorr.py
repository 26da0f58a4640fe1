"""Global clock-correction repository client.

Reference: `pint.observatory.global_clock_corrections`
(`src/pint/observatory/global_clock_corrections.py`) —
observatory clock files are published centrally (the IPTA
pulsar-clock-corrections repository, indexed by ``index.txt``) and
fetched on demand with per-file expiry policies.  The reference builds
on astropy's download cache; this re-architecture uses a plain
directory cache (``$PINT_TPU_CLOCK_DIR`` or ``~/.cache/pint_tpu/clock``)
+ ``urllib``, which keeps the downloaded files directly on the
:func:`pint_tpu.clock.clock_search_dirs` search path — a downloaded
file is immediately visible to every `find_clock_file` consumer with no
extra wiring.

This module is fully functional but NETWORK-GATED: the build/test
environment has zero egress, so the test suite exercises the complete
download/index/expiry machinery against a loopback HTTP server
(tests/test_clockcorr.py), and real use only needs the default
``url_base`` reachable.

Usage::

    from pint_tpu_torch.clockcorr import update_clock_files
    update_clock_files()                  # fetch/refresh everything
    update_clock_files(["time_gbt.dat"])  # specific files
"""

from __future__ import annotations

import os
import time
import warnings
from typing import Dict, List, NamedTuple, Optional, Sequence

__all__ = ["URL_BASE", "IndexEntry", "Index", "get_file",
           "get_clock_correction_file", "update_clock_files",
           "clock_cache_dir"]

#: the IPTA global clock-correction repository (same as the reference)
URL_BASE = ("https://raw.githubusercontent.com/ipta/"
            "pulsar-clock-corrections/main/")
INDEX_NAME = "index.txt"
INDEX_UPDATE_INTERVAL_DAYS = 1.0


def clock_cache_dir() -> str:
    """Where downloaded clock files land — on the clock search path
    ahead of any TEMPO/TEMPO2 install dirs (explicit
    ``$PINT_TPU_CLOCK_DIR``/``$PINT_CLOCK_OVERRIDE`` still rank
    higher), so downloads are picked up immediately."""
    d = os.environ.get("PINT_TPU_CLOCK_DIR")
    if not d:
        d = os.path.join(os.path.expanduser("~"), ".cache", "pint_tpu",
                         "clock")
    return d


def _fetch(url: str, dest: str, timeout: float = 30.0) -> str:
    """Download ``url`` to ``dest`` atomically."""
    from urllib.request import urlopen

    os.makedirs(os.path.dirname(dest), exist_ok=True)
    tmp = dest + f".tmp{os.getpid()}"
    with urlopen(url, timeout=timeout) as r, open(tmp, "wb") as f:
        f.write(r.read())
    os.replace(tmp, dest)
    return dest


def get_file(name: str, update_interval_days: float = 7.0,
             download_policy: str = "if_expired",
             url_base: Optional[str] = None,
             invalid_if_older_than: Optional[float] = None,
             cache_dir: Optional[str] = None) -> str:
    """A local path to a current copy of repository file ``name``.

    ``download_policy``: ``"always"``, ``"never"``, ``"if_expired"``
    (older than ``update_interval_days``), or ``"if_missing"``.
    ``invalid_if_older_than``: unix time; an older cached copy is
    re-fetched regardless of policy.  On download failure an expired
    cached copy is served with a warning (the reference does the same).
    """
    url_base = url_base or URL_BASE
    cache = cache_dir or clock_cache_dir()
    local = os.path.join(cache, os.path.basename(name))
    have = os.path.isfile(local)
    if download_policy == "never":
        if not have:
            raise FileNotFoundError(name)
        return local
    stale = False
    if have:
        mtime = os.stat(local).st_mtime
        stale = (invalid_if_older_than is not None
                 and mtime < invalid_if_older_than)
        if not stale:
            if download_policy == "if_missing":
                return local
            if download_policy == "if_expired" and \
                    time.time() - mtime < update_interval_days * 86400.0:
                return local
    try:
        return _fetch(url_base + name, local)
    except OSError as e:
        # a merely-EXPIRED copy is an acceptable fallback; a copy the
        # index marks invalid_if_older_than contains KNOWN-BAD data and
        # must never be served silently
        if have and not stale and download_policy == "if_expired":
            warnings.warn(
                f"clock file {name}: download failed ({e}); using the "
                f"expired cached copy {local}")
            return local
        raise


class IndexEntry(NamedTuple):
    file: str                    #: path within the repository
    update_interval_days: float
    invalid_if_older_than: Optional[float]   #: unix time or None
    extra: str


class Index:
    """The repository's ``index.txt``: filename -> IndexEntry
    (reference `Index`, ibid:153).  Format per line:
    ``repo/path/name.clk  update_days  iso-date-or---  [notes]``."""

    def __init__(self, download_policy: str = "if_expired",
                 url_base: Optional[str] = None,
                 cache_dir: Optional[str] = None):
        import calendar

        path = get_file(INDEX_NAME, INDEX_UPDATE_INTERVAL_DAYS,
                        download_policy=download_policy,
                        url_base=url_base, cache_dir=cache_dir)
        self.files: Dict[str, IndexEntry] = {}
        for line in open(path):
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            e = line.split(maxsplit=3)
            if len(e) < 3:
                continue
            invalid = None
            if e[2] != "---":
                invalid = calendar.timegm(
                    time.strptime(e[2][:10], "%Y-%m-%d"))
            self.files[os.path.basename(e[0])] = IndexEntry(
                file=e[0], update_interval_days=float(e[1]),
                invalid_if_older_than=invalid,
                extra=e[3] if len(e) > 3 else "")


def get_clock_correction_file(filename: str,
                              download_policy: str = "if_expired",
                              url_base: Optional[str] = None,
                              cache_dir: Optional[str] = None) -> str:
    """Fetch one clock file via the index (KeyError if unknown there)."""
    idx = Index(download_policy=download_policy, url_base=url_base,
                cache_dir=cache_dir)
    ent = idx.files[filename]
    return get_file(ent.file, ent.update_interval_days,
                    download_policy=download_policy, url_base=url_base,
                    invalid_if_older_than=ent.invalid_if_older_than,
                    cache_dir=cache_dir)


def update_clock_files(names: Optional[Sequence[str]] = None,
                       download_policy: str = "if_expired",
                       url_base: Optional[str] = None,
                       cache_dir: Optional[str] = None) -> List[str]:
    """Fetch/refresh clock files from the global repository (reference
    `update_all`, ibid:228) — all files in the index, or just ``names``.
    Returns the local paths.  Files land on the clock search path AND
    the clock layer's in-process lookup cache (including cached misses)
    is invalidated, so a subsequent `get_TOAs` picks them up with no
    further action."""
    idx = Index(download_policy=download_policy, url_base=url_base,
                cache_dir=cache_dir)
    wanted = list(names) if names is not None else list(idx.files)
    out = []
    for n in wanted:
        ent = idx.files[n]
        out.append(get_file(ent.file, ent.update_interval_days,
                            download_policy=download_policy,
                            url_base=url_base,
                            invalid_if_older_than=ent.invalid_if_older_than,
                            cache_dir=cache_dir))
    from pint_tpu_torch import clock

    clock.reset_cache()
    return out
