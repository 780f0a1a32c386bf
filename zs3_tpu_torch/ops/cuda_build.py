"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface.  On first use it is
compiled with ``nvcc`` for ``sm_90a`` into a shared library in the build
directory, named by a hash of the source and flags so an edited kernel
is rebuilt, and loaded with ctypes.  The build directory is
``build/kernels/`` beside the package (a directory .gitignore lists)
unless `set_build_dir` names another: the CLI's ``--compilation-cache
DIR`` (or ``$ZS3_COMPILATION_CACHE``), the counterpart of zs3_tpu's
persistent XLA cache, so a restarted job with the same DIR runs no
``nvcc``.  Nothing is built at import time: the CPU tests import every
module on hosts that have no nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
_build_dir = BUILD_DIR  # where build() puts and finds libraries: set_build_dir
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def set_build_dir(path: Optional[str] = None) -> Path:
    """Build and load the kernels in `path` from now on (None: BUILD_DIR)
    and return it.  A named directory is made now, and one that cannot be
    written raises: there is no fallback to another."""
    global _build_dir
    if path is None:
        _build_dir = BUILD_DIR
        return _build_dir
    target = Path(path).resolve()
    target.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryFile(dir=target):  # raises unless a build could land here
        pass
    _build_dir = target
    return target


def library_path(name: str, directory: Optional[Path] = None) -> Path:
    """Where the build of csrc/<name>.cu lands (keyed by its content) in
    `directory`, by default the build directory."""
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return (directory or _build_dir) / f"lib{name}-{digest}.so"


def build(name: str, directory: Optional[Path] = None) -> Path:
    """Compile csrc/<name>.cu into `directory` (by default the build
    directory) unless its build is there; returns the .so path.

    The compiler's output (ptxas register and shared-memory report) is
    kept beside the library as ``<lib>.log``.
    """
    out = library_path(name, directory)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    # Build to a private name, then rename: a concurrent build never
    # loads a half-written library.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    try:
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
        Path(str(out) + ".log").write_text(log)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


class CudaLibrary:
    """A kernel library built on first use; `functions` sets each C
    function's (argtypes, restype) once it is loaded.  It is loaded again
    from the build directory, built there if need be, once that changes."""

    def __init__(self, name: str, functions: Dict[str, tuple]):
        self.name = name
        self._functions = functions
        self._lib = None
        self._dir = None
        self._lock = threading.Lock()

    def get(self) -> ctypes.CDLL:
        with self._lock:
            directory = _build_dir
            if self._lib is None or self._dir != directory:
                lib = ctypes.CDLL(str(build(self.name, directory)))
                for fn, (argtypes, restype) in self._functions.items():
                    getattr(lib, fn).argtypes = argtypes
                    getattr(lib, fn).restype = restype
                self._lib, self._dir = lib, directory
            return self._lib
