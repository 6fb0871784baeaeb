"""ctypes binding for the memory-fence shim (``native/fence.cc``).

The ShmRing publish ordering (payload-before-tail) is backed by x86-TSO
plus CPython's aligned stores alone; a weakly-ordered host (aarch64)
needs a real release fence before the tail store and an acquire fence
after the tail read. The shim is one ``atomic_thread_fence`` each —
when the library (or a toolchain to build it) is absent, consumers fall
back to no-op fences, which is CORRECT on x86-64 and a warned gap
elsewhere (``shm_ring.fence_startup_check``).
"""

from __future__ import annotations

from typing import Callable, Optional

from . import load_library

_lib = None
_lib_checked = False


def _get_lib():
    global _lib, _lib_checked
    if not _lib_checked:
        _lib_checked = True
        lib = load_library("libvmq_fence.so")
        if lib is not None:
            try:
                lib.vmq_release_fence.restype = None
                lib.vmq_acquire_fence.restype = None
                if lib.vmq_fence_probe() != 1:
                    lib = None
            except AttributeError:
                lib = None
        _lib = lib
    return _lib


def available() -> bool:
    return _get_lib() is not None


def release_fence_fn() -> Optional[Callable[[], None]]:
    """The release fence as a bound callable (None when the shim is
    unavailable — callers treat None as 'no fence, TSO fallback')."""
    lib = _get_lib()
    return lib.vmq_release_fence if lib is not None else None


def acquire_fence_fn() -> Optional[Callable[[], None]]:
    lib = _get_lib()
    return lib.vmq_acquire_fence if lib is not None else None
