"""Build the port's CUDA sources with ``nvcc`` and load them with ctypes.

Each ``csrc/*.cu`` file compiles on its own into a shared library with a
plain C interface (``-gencode arch=compute_90a,code=sm_90a``), at first
use, into ``kernels/build/`` beside this file (listed in ``.gitignore``).
The library name carries a hash of the source and the flags, so an edited
source is rebuilt and an unchanged one is reused.  :func:`build_all`
starts one ``nvcc`` per source at once, so a cold start pays for the
slowest file only.

Every C entry point returns ``cudaGetLastError()`` after its launch;
:func:`check` turns a non-zero code into an exception, since a refused
launch never runs and a later synchronize would not report it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List

_HERE = Path(__file__).resolve().parent
BUILD_DIR = _HERE / "build"
SOURCES = {"bitonic": _HERE / "bitonic" / "csrc" / "bitonic.cu",
           "partition": _HERE / "partition" / "csrc" / "partition.cu",
           "kway": _HERE / "kway" / "csrc" / "kway.cu"}
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: Dict[str, ctypes.CDLL] = {}
BUILD_LOG: Dict[str, str] = {}          # name -> nvcc's output (ptxas -v),
                                        # kept beside the library as .log


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "on a machine with the CUDA toolkit")


def _target(name: str) -> Path:
    h = hashlib.sha256(SOURCES[name].read_bytes())
    h.update(" ".join(FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def _start(name: str):
    out = _target(name)
    if out.exists():
        log = out.with_suffix(".log")
        if log.exists():
            BUILD_LOG[name] = log.read_text()
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *FLAGS, "-o", str(tmp), str(SOURCES[name])]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, job) -> None:
    proc, tmp, out = job
    log, _ = proc.communicate()
    BUILD_LOG[name] = log
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {SOURCES[name]}:\n{log}")
    out.with_suffix(".log").write_text(log)
    os.replace(tmp, out)


def build_all(names: List[str] = None) -> None:
    """Compile every (or the named) source not yet built, all in parallel."""
    names = list(SOURCES) if names is None else names
    jobs = {n: _start(n) for n in names}
    errors = []
    for n, job in jobs.items():
        if job is None:
            continue
        try:
            _finish(n, job)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``name``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(_target(name)))
        _LIBS[name] = lib
    return lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA launch of {what} failed with "
                           f"cudaError {err}")
