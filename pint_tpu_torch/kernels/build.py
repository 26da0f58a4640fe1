"""Build and load the port's CUDA kernels.

Each ``pint_tpu_torch/csrc/<name>.cu`` source has a plain C interface and
is compiled by ``nvcc`` into its own shared library, loaded with
:mod:`ctypes` (no PyTorch headers, so a build takes seconds).  Libraries
land in ``build/pint_tpu_torch/`` beside the package (or
``$PINT_TPU_TORCH_BUILD``), named by a hash of source and flags, so an
unchanged kernel is not rebuilt.  Nothing is compiled at import: the first
launch builds, or :func:`build_all` builds every source at once, one
``nvcc`` process per library, all started together.  The delay chain
instantiates its kernels for 28 template values and the phase chain for
35 (the same 28 and the phase family's 7); each is built in parts
(:data:`PARTS`), library ``<name>.<p>`` holding the template values of
part p (``csrc/delay_chain.cuh`` ``in_part``), so that the parts compile
in parallel.

Flags: ``-gencode arch=compute_90a,code=sm_90a`` (Hopper) and
``--fmad=false``: ``qs_phase``, ``delay_chain`` and ``phase_chain`` run
chains of error-free transforms (``csrc/qs.cuh``), and a contracted ``a*b+c``
(FMA) silently breaks them, as a value-changing rewrite would in XLA
(:func:`pint_tpu.dd._guard`); every kernel keeps the flag so that each of
its products and sums rounds on its own, as the plain version's separate
PyTorch kernels do.  The shared headers ``csrc/*.cuh`` are found with
``-I csrc`` and are part of every library's hash.  Never ``--use_fast_math``
(it also flushes subnormals and reassociates).  ``-Xptxas=-v`` reports
each kernel's registers, stack and spills; the build's output is kept
beside the library as ``<library>.log`` (:func:`build_log`).

:func:`host_library` builds the host versions of the row functions
(``csrc/*_host.cpp``, the kernels' launch shapes around the same row
code) with g++, once per hash of source, headers, flags and compiler
version, into ``build/pint_tpu_torch/host/``: the tests on a machine
without a card hold them bit-equal to the plain versions.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Sequence

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas=-v")

#: g++ flags of the host builds: no FMA contraction, as the kernels; -O1
#: builds the chain sources (28 and 35 template values) in ~20-30 s each
HOST_FLAGS = ("-std=c++17", "-O1", "-ffp-contract=off", "-shared", "-fPIC")

#: every kernel source of the package
SOURCES = ("qs_phase", "kepler", "delay_chain", "phase_chain")
#: the sources built in parts: library "<name>.<p>" holds the template
#: values whose index (csrc/delay_chain.cuh family_index) is p mod parts.
#: The phase chain's 35 values, the phase family's the largest, take
#: eight (four took 201-211 s to build on the card's machine)
PARTS = {"delay_chain": 4, "phase_chain": 8}

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def build_dir() -> str:
    return os.environ.get("PINT_TPU_TORCH_BUILD") or os.path.join(
        os.path.dirname(PKG_DIR), "build", "pint_tpu_torch")


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def libraries(names: Sequence[str] = SOURCES) -> list:
    """The libraries of the sources ``names``: one per source, or its
    parts ``<name>.<p>``."""
    return [lib for n in names for lib in (
        [f"{n}.{p}" for p in range(PARTS[n])] if n in PARTS else [n])]


def part_of(name: str, index: int) -> str:
    """The library of source ``name`` that holds template value number
    ``index`` (csrc/delay_chain.cuh family_index)."""
    return f"{name}.{index % PARTS[name]}"


def _flags(lib: str):
    """(source name, nvcc flags) of library ``lib``."""
    name, _, part = lib.partition(".")
    if not part:
        return name, NVCC_FLAGS
    return name, (*NVCC_FLAGS, f"-DPT_PARTS={PARTS[name]}",
                  f"-DPT_PART={part}")


def _source_digest(source: str, salt: str) -> str:
    """A hash of ``salt``, the source file and the shared headers
    (``csrc/*.cuh``)."""
    digest = hashlib.sha256(salt.encode())
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for fname in [source, *headers]:
        with open(os.path.join(CSRC_DIR, fname), "rb") as f:
            digest.update(f.read())
    return digest.hexdigest()[:16]


def library_path(lib: str) -> str:
    """The library's path, named by a hash of its source, the shared
    headers (``csrc/*.cuh``) and the flags."""
    name, flags = _flags(lib)
    return os.path.join(build_dir(), f"lib{lib}_"
                        f"{_source_digest(f'{name}.cu', ' '.join(flags))}.so")


def host_library(name: str) -> str:
    """The path of the host build of ``csrc/<name>.cpp``, built with g++
    if it is not there yet.  The library is named by a hash of the
    source, the shared headers, :data:`HOST_FLAGS` and ``g++ --version``;
    a file lock beside it makes processes that ask at once build it
    once."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the host builds cannot be made")
    version = subprocess.run([gxx, "--version"], capture_output=True,
                             text=True, check=True).stdout
    salt = " ".join(HOST_FLAGS) + version
    out_dir = os.path.join(build_dir(), "host")
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, f"lib{name}_"
                       f"{_source_digest(f'{name}.cpp', salt)}.so")
    with open(os.path.join(out_dir, f"{name}.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not os.path.exists(out):
            tmp = f"{out}.{os.getpid()}.tmp"
            res = subprocess.run(
                [gxx, *HOST_FLAGS, "-I", CSRC_DIR,
                 os.path.join(CSRC_DIR, f"{name}.cpp"), "-o", tmp],
                capture_output=True, text=True)
            if res.returncode != 0:
                if os.path.exists(tmp):
                    os.remove(tmp)
                raise RuntimeError(f"g++ failed to build {name}:\n"
                                   f"{res.stderr}")
            os.replace(tmp, out)
    return out


def _start(lib: str):
    """Start one nvcc build; returns (process or None if up to date, paths)."""
    out = library_path(lib)
    if os.path.exists(out):
        return None, out, None
    os.makedirs(build_dir(), exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    name, flags = _flags(lib)
    cmd = [nvcc(), *flags, "-I", CSRC_DIR, "-o", tmp,
           os.path.join(CSRC_DIR, f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, out, tmp


def _finish(name: str, proc, out: str, tmp: str) -> None:
    if proc is None:
        return
    log, _ = proc.communicate()
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"nvcc failed to build {name}:\n{log}")
    with open(out + ".log", "w") as f:
        f.write(log)
    os.replace(tmp, out)


def build_all(names: Sequence[str] = SOURCES) -> Dict[str, str]:
    """Build the libraries of the sources (or libraries) ``names``, all
    nvcc processes at once; returns ``{library: path}``."""
    with _lock:
        started = {n: _start(n) for n in libraries(names)}
        errors = []
        for n, (proc, out, tmp) in started.items():
            try:
                _finish(n, proc, out, tmp)
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))
        return {n: started[n][1] for n in started}


def build_log(name: str) -> str:
    """nvcc's output of the build of source ``name``, its parts' in turn
    (ptxas's registers, stack and spills per kernel); empty where a
    library was built before logs were kept."""
    out = []
    for lib in libraries([name]):
        path = library_path(lib) + ".log"
        if os.path.exists(path):
            with open(path) as f:
                out.append(f.read())
    return "\n".join(out)


def load(lib: str) -> ctypes.CDLL:
    """The loaded library ``lib`` (a source's, or one part of it), building
    it first if needed."""
    got = _loaded.get(lib)
    if got is None:
        path = build_all([lib])[lib]
        with _lock:
            got = _loaded.setdefault(lib, ctypes.CDLL(path))
    return got
