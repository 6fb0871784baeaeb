"""Native runtime components (SURVEY.md §2.6 equivalents).

- ``kvstore``  — C++ append-log storage engine (the eleveldb seat:
  offline message store backend + metadata persistence)
- ``counters`` — C++ wait-free sharded counters (the mzmetrics seat)
- ``vmq-passwd`` — C++ passwd tool (the vmq_passwd c_src seat)

Libraries are built from ``native/`` via make on first use when a
toolchain is present; every consumer gates on availability and falls back
to the pure-Python implementation, so the package works without a
compiler.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading

log = logging.getLogger("vernemq_tpu_torch.native")

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
NATIVE_DIR = os.path.join(_REPO_ROOT, "native")
BUILD_DIR = os.path.join(NATIVE_DIR, "build")

_build_lock = threading.Lock()
_build_attempted = False


_TARGETS = ("libvmq_kvstore.so", "libvmq_counters.so", "libvmq_bcrypt.so",
            "vmq-passwd", "_vmq_codec.so", "libvmq_fence.so")


def _all_built() -> bool:
    return all(os.path.exists(os.path.join(BUILD_DIR, t)) for t in _TARGETS)


def _ensure_built() -> bool:
    global _build_attempted
    # check the FULL target set: a build dir from an older checkout may
    # hold some libraries but miss newly-added ones
    if _all_built():
        return True
    with _build_lock:
        if _build_attempted:
            return _all_built()
        _build_attempted = True
        if not os.path.exists(os.path.join(NATIVE_DIR, "Makefile")):
            return False
        try:
            import sysconfig

            # pin the Python headers to THIS interpreter: PATH's python3
            # may be a different minor version, and a cross-ABI
            # _vmq_codec.so would fail to import (silently losing the
            # codec fast path)
            subprocess.run(
                ["make", "-C", NATIVE_DIR,
                 f"PY_INC={sysconfig.get_paths()['include']}"],
                check=True, capture_output=True, timeout=120)
        except (OSError, subprocess.SubprocessError) as e:
            log.warning("native build failed, using Python fallbacks: %s", e)
            return False
    return _all_built()


def load_library(name: str):
    """ctypes.CDLL for a built native library, or None."""
    if os.environ.get("VMQ_NO_NATIVE"):
        return None
    if not _ensure_built():
        return None
    path = os.path.join(BUILD_DIR, name)
    if not os.path.exists(path):
        return None
    try:
        return ctypes.CDLL(path)
    except OSError as e:
        log.warning("cannot load %s: %s", path, e)
        return None


def load_extension(name: str, min_version: int = 0,
                   version_attr: str = "FASTPATH_VERSION"):
    """Import a CPython extension module from the native build dir, or
    None. Extensions (vs ctypes libs) are used where per-call
    marshalling overhead matters — the wire codec's per-frame path.
    ``min_version`` guards against a stale prebuilt artifact whose
    function signatures predate the caller (which would TypeError at
    call time deep inside the hot path): an older module triggers one
    forced rebuild, and if it is still old, None is returned."""
    if os.environ.get("VMQ_NO_NATIVE"):
        return None
    if not _ensure_built():
        return None
    path = os.path.join(BUILD_DIR, name + ".so")
    if not os.path.exists(path):
        return None
    import importlib.machinery
    import importlib.util

    def _import():
        loader = importlib.machinery.ExtensionFileLoader(name, path)
        spec = importlib.util.spec_from_loader(name, loader)
        mod = importlib.util.module_from_spec(spec)
        loader.exec_module(mod)
        if getattr(mod, version_attr, 0) < min_version:
            raise ImportError(
                f"{name} is version {getattr(mod, version_attr, 0)}, "
                f"caller needs >= {min_version}")
        return mod

    try:
        return _import()
    except Exception:
        # stale artifact (another interpreter ABI, or older signatures
        # than min_version): rebuild once for THIS interpreter and
        # retry (otherwise the fast path would stay silently disabled
        # forever — _ensure_built sees the file exists). CPython caches
        # single-phase extension modules per (name, path) — a re-import
        # from the SAME path would return the stale cached module even
        # after a successful rebuild — so the retry loads the fresh
        # artifact from a versioned copy at a new path.
        try:
            import sysconfig

            subprocess.run(
                ["make", "-C", NATIVE_DIR, "-B", os.path.relpath(
                    path, NATIVE_DIR),
                 f"PY_INC={sysconfig.get_paths()['include']}"],
                check=True, capture_output=True, timeout=120)
            path = fresh_artifact_copy(path)
            return _import()
        except Exception as e:  # pragma: no cover - toolchain missing
            log.warning("cannot import extension %s: %s", path, e)
            return None


def fresh_artifact_copy(path: str) -> str:
    """Copy a rebuilt native artifact to a UNIQUE new path and return it.

    Two aliasing hazards make reloading from the original path wrong:
    dlopen dedups by dev/inode (a re-link in place hands back the stale
    handle — ctypes never dlcloses), and overwriting a fixed retry path
    would truncate an inode another live process has mmapped (its
    not-yet-faulted code pages would re-fault from mid-rewrite bytes).
    A pid+mtime-uniquified filename sidesteps both."""
    import shutil

    retry_dir = os.path.join(BUILD_DIR, "abi_retry")
    os.makedirs(retry_dir, exist_ok=True)
    base = os.path.basename(path)
    tag = f"{os.getpid()}_{int(os.stat(path).st_mtime_ns)}"
    fresh = os.path.join(retry_dir, f"{tag}_{base}")
    # prune stale copies from dead pids before adding another — repeated
    # ABI churn would otherwise leak .so files indefinitely (a live pid's
    # copy may still be mmapped and must survive)
    for old in os.listdir(retry_dir):
        if not old.endswith(f"_{base}") or old == os.path.basename(fresh):
            continue
        try:
            pid = int(old.split("_", 1)[0])
            os.kill(pid, 0)  # raises if the owning process is gone
        except (ValueError, ProcessLookupError):
            try:
                os.unlink(os.path.join(retry_dir, old))
            except OSError:
                pass
        except PermissionError:
            pass  # pid alive under another uid — keep its copy
    if not os.path.exists(fresh):
        shutil.copy2(path, fresh)
    return fresh


def passwd_tool_path() -> str:
    """Path to the vmq-passwd binary (built on demand)."""
    _ensure_built()
    return os.path.join(BUILD_DIR, "vmq-passwd")
