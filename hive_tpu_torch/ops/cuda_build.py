"""Build and load the package's CUDA kernels (``hive_tpu_torch/csrc/*.cu``).

Each source has a plain C interface and compiles with ``nvcc`` alone into
its own shared library, loaded with ``ctypes`` (no PyTorch headers, so a
build takes seconds). Libraries go to ``hive_tpu_torch/_build/`` at first
use; a library older than its source is rebuilt. Nothing is built or
imported when this module is imported: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from typing import Dict, Iterable

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              # No a*b+c contraction into FMAs: the kernels' float math must
              # round like the plain PyTorch versions.
              "-fmad=false",
              "-shared", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.isfile("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _paths(name: str):
    return (os.path.join(SOURCE_DIR, f"{name}.cu"),
            os.path.join(BUILD_DIR, f"lib{name}.so"))


def _stale(name: str) -> bool:
    src, lib = _paths(name)
    return not os.path.isfile(lib) or os.path.getmtime(lib) < os.path.getmtime(src)


def _start_build(name: str):
    """Start one ``nvcc`` for ``name``; returns (process, temp path, final path)."""
    src, lib = _paths(name)
    os.makedirs(BUILD_DIR, exist_ok=True)
    # Compile to a per-process temp file and rename into place, so a
    # concurrent process never loads a half-written library.
    tmp = f"{lib}.build-{os.getpid()}"
    proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, tmp, lib


def build(names: Iterable[str]) -> None:
    """Build the stale libraries among ``names``, one ``nvcc`` per source,
    all started together."""
    with _lock:
        jobs = [(name, *_start_build(name)) for name in names if _stale(name)]
        errors = []
        for name, proc, tmp, lib in jobs:
            out, _ = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"nvcc failed for {name}.cu:\n{out}")
                continue
            os.replace(tmp, lib)
        if errors:
            raise RuntimeError("\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    lib = _libs.get(name)
    if lib is None:
        build([name])
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                lib = _libs[name] = ctypes.CDLL(_paths(name)[1])
    return lib
