"""Build and load the port's CUDA kernels.

Each ``pint_tpu_torch/csrc/<name>.cu`` source has a plain C interface and
is compiled by ``nvcc`` into its own shared library, loaded with
:mod:`ctypes` (no PyTorch headers, so a build takes seconds).  Libraries
land in ``build/pint_tpu_torch/`` beside the package (or
``$PINT_TPU_TORCH_BUILD``), named by a hash of source and flags, so an
unchanged kernel is not rebuilt.  Nothing is compiled at import: the first
launch builds, or :func:`build_all` builds every source at once, one
``nvcc`` process per source, all started together.

Flags: ``-gencode arch=compute_90a,code=sm_90a`` (Hopper) and
``--fmad=false``: ``qs_phase`` and ``delay_chain`` run chains of
error-free transforms (``csrc/qs.cuh``), and a contracted ``a*b+c``
(FMA) silently breaks them, as a value-changing rewrite would in XLA
(:func:`pint_tpu.dd._guard`); every kernel keeps the flag so that each of
its products and sums rounds on its own, as the plain version's separate
PyTorch kernels do.  The shared headers ``csrc/*.cuh`` are found with
``-I csrc`` and are part of every library's hash.  Never ``--use_fast_math``
(it also flushes subnormals and reassociates).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Sequence

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC")

#: every kernel source of the package, by library name
SOURCES = ("qs_phase", "kepler", "delay_chain")

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


def library_path(name: str) -> str:
    """The library's path, named by a hash of its source, the shared
    headers (``csrc/*.cuh``) and the flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for fname in [f"{name}.cu", *headers]:
        with open(os.path.join(CSRC_DIR, fname), "rb") as f:
            digest.update(f.read())
    return os.path.join(build_dir(), f"lib{name}_{digest.hexdigest()[:16]}.so")


def _start(name: str):
    """Start one nvcc build; returns (process or None if up to date, paths)."""
    out = library_path(name)
    if os.path.exists(out):
        return None, out, None
    os.makedirs(build_dir(), exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [nvcc(), *NVCC_FLAGS, "-I", CSRC_DIR, "-o", tmp,
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
    os.replace(tmp, out)


def build_all(names: Sequence[str] = SOURCES) -> Dict[str, str]:
    """Build every named kernel library, all nvcc processes at once;
    returns ``{name: library path}``."""
    with _lock:
        started = {n: _start(n) for n in names}
        errors = []
        for n, (proc, out, tmp) in started.items():
            try:
                _finish(n, proc, out, tmp)
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))
        return {n: started[n][1] for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, building it first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        path = build_all([name])[name]
        with _lock:
            lib = _loaded.setdefault(name, ctypes.CDLL(path))
    return lib
