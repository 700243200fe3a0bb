"""Build the port's CUDA sources with nvcc and bind them with ctypes.

Each ``ops/csrc/<name>.cu`` exports a plain C entry point.  At first use
it is compiled for Hopper (``-gencode arch=compute_90a,code=sm_90a``)
into ``pilosa_tpu_torch/_build/lib<name>-<hash>.so``, keyed by a hash of
the source and the flags, and loaded with ctypes.  A source that does
not compile raises ``BuildError`` with the compiler's output; nothing
falls back to a plain version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "ops", "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")

ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-shared", "-Xcompiler",
                           "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_name_locks: dict[str, threading.Lock] = {}
_libs: dict[str, ctypes.CDLL] = {}
#: compiler output (ptxas register / shared-memory report) per source
build_logs: dict[str, str] = {}


class BuildError(RuntimeError):
    """nvcc is missing or refused a source."""


def find_nvcc() -> str:
    """The nvcc binary: $CUDA_HOME/bin/nvcc, then /usr/local/cuda, then
    PATH."""
    candidates = []
    for env in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(env)
        if root:
            candidates.append(os.path.join(root, "bin", "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    found = shutil.which("nvcc")
    if found is None:
        raise BuildError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


def _source(name: str) -> str:
    return os.path.join(CSRC_DIR, f"{name}.cu")


def _so_path(name: str) -> str:
    with open(_source(name), "rb") as f:
        digest = hashlib.sha256(
            f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")


def load(name: str) -> ctypes.CDLL:
    """The loaded library for one source, compiling it on first use.
    Raises ``BuildError`` with the compiler's output if nvcc fails.
    Sources build under a lock of their own, so threads that load
    different sources run their nvcc processes side by side."""
    with _lock:
        name_lock = _name_locks.setdefault(name, threading.Lock())
    with name_lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        os.makedirs(BUILD_DIR, exist_ok=True)
        so = _so_path(name)
        if not os.path.exists(so):
            tmp = f"{so}.{os.getpid()}.tmp"
            proc = subprocess.run(
                [find_nvcc(), *NVCC_FLAGS, "-o", tmp, _source(name)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            build_logs[name] = proc.stdout
            if proc.returncode != 0:
                raise BuildError(f"nvcc failed for {name}.cu "
                                 f"(exit {proc.returncode}):\n{proc.stdout}")
            os.replace(tmp, so)
        lib = _libs[name] = ctypes.CDLL(so)
        return lib
