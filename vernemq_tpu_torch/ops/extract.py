"""First-k extraction of bit-packed match masks: the one hand kernel that
extracts on every device path (``csrc/extract.cu``), and its plain PyTorch
version.

For the selected rows ``rows[i]`` of a packed mask ``int32 [R0, W]`` (bit j
of word w is column 32·w + j) it returns the first ``k`` set columns of each
row — the contract of the reference's ``extract_indices_packed``
(``vernemq_tpu/ops/match_kernel.py:225``): ``idx int32 [R, k]`` (meaningful
where valid, 0 elsewhere), ``valid bool [R, k]`` and ``count int32 [R]``,
the row's full count, which may exceed k. A row whose ``ok`` is False is
dead: it counts 0 and reads nothing. ``counts int32 [R0, W*32/CHUNK]``,
the set bits of each ``CHUNK``-column chunk (the retained compare kernel
writes them), are optional: without them the kernel counts the words
itself, and W may be any width (a ragged last chunk).

Its callers: the forward probes A and B (``tile_match._probe_tiles``),
dense region 0 (``match_kernel._dense_region0``), and the retained probe
and dense phases (``reverse_tiles.extract_chunks``).

- :func:`extract_rows` launches the kernel for CUDA tensors and raises
  (``tile_match.KernelError`` / ``KernelInputError``) on what it cannot
  take; it never falls back.
- :func:`extract_rows_ref` is the plain version; the wrapper takes it for
  tensors on the CPU only.

``launches`` counts kernel launches (reset it to read one run's count).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .match_kernel import extract_indices_packed
from .reverse_kernel import CHUNK
from .tile_match import KernelError, KernelInputError

launches = 0

WORDS_PER_CHUNK = CHUNK // 32
#: chunks a warp takes at once (lane = chunk), and such groups in flight
GROUP_CHUNKS = 32
GROUPS_IN_FLIGHT = 4
#: warps that may share one row, and the warps a launch aims to fill the
#: card with (132 SMs x 16)
MAX_SPLIT = 8
TARGET_WARPS = 2048


def split(R: int, W: int, with_counts: bool) -> int:
    """Warps per row of a launch over ``R`` rows of ``W`` words: doubled
    from 1 while ``R`` warps leave the card short, up to ``MAX_SPLIT`` and
    no more than the row's chunk groups. Without counts a split row's span
    must fit the ``GROUPS_IN_FLIGHT`` groups a warp keeps in registers;
    else the row streams through one warp."""
    groups = -(-W // (WORDS_PER_CHUNK * GROUP_CHUNKS))
    S = 1
    while S < MAX_SPLIT and R * S < TARGET_WARPS and S < groups:
        S *= 2
    if not with_counts and -(-groups // S) > GROUPS_IN_FLIGHT:
        return 1
    return S


def extract_rows_ref(packed: torch.Tensor, k: int, *, rows=None, ok=None,
                     counts=None):
    """Plain PyTorch version of the kernel: ``extract_indices_packed`` over
    the selected rows without counts, ``reverse_tiles.extract_chunks_ref``
    with them; dead rows zeroed, and ``idx`` 0 where not valid, as the
    kernel writes it."""
    from .reverse_tiles import extract_chunks_ref

    R0 = packed.shape[0]
    dev = packed.device
    if rows is None:
        rows = torch.arange(R0, dtype=torch.int32, device=dev)
    rows = rows.long().clamp(0, max(R0 - 1, 0))
    if ok is None:
        ok = torch.ones(rows.shape[0], dtype=torch.bool, device=dev)
    if counts is None:
        idx, valid, count = extract_indices_packed(
            packed.index_select(0, rows), k)
        count = torch.where(ok, count, 0)
        valid = valid & ok[:, None]
    else:
        idx, valid, count = extract_chunks_ref(packed, counts, k, rows=rows,
                                               ok=ok)
    return torch.where(valid, idx, 0), valid, count


def _refuse(msg: str):
    raise KernelInputError(f"extract_rows: {msg}")


def extract_rows(packed: torch.Tensor, k: int, *, rows=None, ok=None,
                 counts=None):
    """The first ``k`` set columns of rows ``rows`` (int32 ``[R]``, every
    row when None) of the packed mask ``[R0, W]``, live where ``ok`` (bool
    ``[R]``, all when None), optionally over its chunk ``counts``
    (``[R0, W*32/CHUNK]``): ``(idx [R, k] int32, valid [R, k] bool, count
    [R] int32)``. On CUDA it launches the extraction kernel and raises on
    what it cannot take; on the CPU it takes the plain version."""
    global launches
    dev = packed.device
    if packed.dim() != 2 or packed.dtype != torch.int32 \
            or not packed.is_contiguous():
        _refuse(f"packed must be a contiguous 2-D int32 tensor; got "
                f"{packed.dtype} {tuple(packed.shape)}")
    R0, W = packed.shape
    if k <= 0 or R0 <= 0 or W <= 0:
        _refuse(f"needs k > 0 and a non-empty mask; got k={k}, packed "
                f"{tuple(packed.shape)}")
    if counts is not None and (
            counts.dim() != 2 or counts.shape[0] != R0
            or W != counts.shape[1] * WORDS_PER_CHUNK):
        _refuse(f"counts {tuple(counts.shape)} are not the {CHUNK}-column "
                f"chunks of the packed mask {tuple(packed.shape)}")
    R = rows.shape[0] if rows is not None else R0
    for name, x, dt in (("rows", rows, torch.int32), ("ok", ok, torch.bool),
                        ("counts", counts, torch.int32)):
        if x is not None and (x.device != dev or x.dtype != dt
                              or not x.is_contiguous()):
            _refuse(f"{name} must be a contiguous {dt} tensor on {dev}; got "
                    f"{x.dtype} on {x.device} (contiguous="
                    f"{x.is_contiguous()})")
    if rows is not None and rows.dim() != 1 \
            or ok is not None and tuple(ok.shape) != (R,):
        _refuse(f"rows and ok must be vectors of one length; got "
                f"{None if rows is None else tuple(rows.shape)} and "
                f"{None if ok is None else tuple(ok.shape)}")
    if dev.type == "cpu":
        return extract_rows_ref(packed, k, rows=rows, ok=ok, counts=counts)
    if dev.type != "cuda":
        _refuse(f"unsupported device {dev}")
    idx = torch.empty((R, k), dtype=torch.int32, device=dev)
    valid = torch.empty((R, k), dtype=torch.bool, device=dev)
    count = torch.empty(R, dtype=torch.int32, device=dev)
    if R == 0:
        return idx, valid, count
    nb = counts.shape[1] if counts is not None else -(-W // WORDS_PER_CHUNK)
    S = split(R, W, counts is not None)
    ptr = lambda x: None if x is None else x.data_ptr()
    lib = _build.load("extract")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.extract_launch(
            packed.data_ptr(), ptr(counts), ptr(rows), ptr(ok),
            idx.data_ptr(), valid.data_ptr(), count.data_ptr(), R, R0, W, nb,
            k, S, stream)
    if rc != 0:
        raise KernelError(f"extract kernel launch failed: CUDA error {rc}")
    launches += 1
    return idx, valid, count


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.extract_launch
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int


_build.register("extract", _bind)
