"""Build and load the port's CUDA kernels on first use.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``) into
a shared library with a plain C interface, ``vernemq_tpu_torch/_build/
lib<name>.so``, and loaded with ``ctypes``. Only sources in the package are
used. A library newer than its source is reused; :func:`build` compiles
several sources at once, one ``nvcc`` process each. A build that fails
raises with the compiler's output: nothing falls back to another path.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, Iterable, List

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_binders: Dict[str, Callable[[ctypes.CDLL], None]] = {}
_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def register(name: str, bind: Callable[[ctypes.CDLL], None]) -> None:
    """Declare kernel library ``name`` and the function that sets its
    ``ctypes`` signatures (called once, when the library loads)."""
    _binders[name] = bind


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    return str(Path(home) / "bin" / "nvcc")


def lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def log_path(name: str) -> Path:
    """Where the compiler's output (``-Xptxas -v``: registers, shared
    memory, spills per kernel) of the last build is kept."""
    return BUILD_DIR / f"{name}.nvcc.log"


def _stale(name: str) -> bool:
    out, src = lib_path(name), CSRC / f"{name}.cu"
    return not out.exists() or out.stat().st_mtime < src.stat().st_mtime


def build(names: Iterable[str]) -> List[str]:
    """Compile the stale ones of ``names`` in parallel; raise on failure.
    Returns the names compiled by this call (their :func:`log_path` holds
    this build's compiler output)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in names:
        if not _stale(name):
            continue
        tmp = BUILD_DIR / f"lib{name}.so.{os.getpid()}.tmp"
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for name, tmp, p in procs:
        out, _ = p.communicate()
        log_path(name).write_text(out)
        if p.returncode != 0:
            failed.append(f"{name} (nvcc exit {p.returncode}):\n{out}")
            continue
        os.replace(tmp, lib_path(name))  # atomic: no half-written library
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return [name for name, _, _ in procs]


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, building it first if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(lib_path(name)))
            _binders[name](lib)
            _libs[name] = lib
    return lib
