"""Reverse-compare tile matcher: the hand kernel of the retained reverse
match (``csrc/reverse_match.cu``) and its plain PyTorch version.

For query slots ``sel [T, TP]`` (indices into the query block; a negative
selector is an empty slot) with window starts ``start [T]``, it computes
the packed mask ``int32 [T*TP, seg/32]``: bit j of word w of row
``t*TP + p`` is the full reverse rule (``reverse_kernel.
reverse_mask_unrolled``: length, ``$`` skip, liveness and ``lc`` levelwise
compares) for query ``sel[t, p]`` against table row ``start[t] + 32·w + j``
— the layout of ``match_kernel._pack_mask`` — and, beside it, the chunk
counts ``int32 [T*TP, seg/CHUNK]``: the set bits of each row in each
``CHUNK``-row chunk, the block counts of :func:`extract_chunks`.
An empty slot's row is 0 in both. It replaces the mask halves of the
reference's ``reverse_match`` (``vernemq_tpu/ops/reverse_kernel.py``:
``_tile_masks`` :130 and the dense ``_dense_compare`` :197 /
``_dense_coded`` :167), which XLA fuses with the bit-pack; the kernel writes
the packed words directly, so no boolean mask reaches device memory. One
kernel serves both phases: probe tiles against their bucket windows, and
the dense phase as one tile of up to ``MAX_TILE`` queries against a window
of the whole table.

- :func:`reverse_tiles_packed` launches the kernel for CUDA tensors and
  raises (``tile_match.KernelError`` / ``KernelInputError``) on what it
  cannot take; it never falls back. The window bounds are checked on the
  host copy of the starts (``start_host``), so a launch costs no
  device→host copy.
- :func:`reverse_tiles_packed_ref` is the plain version; the wrapper takes
  it for tensors on the CPU only.

The extraction over those counts is :func:`extract_chunks`, a call of the
one extraction kernel (``ops/extract.py``, ``csrc/extract.cu``) with the
counts; :func:`extract_chunks_ref` is its plain version.

``launches`` counts compare-kernel launches (reset it to read one run's
count); the extraction kernel counts its own in ``extract.launches``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build
from . import match_kernel as MK
from .extract import extract_rows
from .match_kernel import _pack_mask, _popcount, _select_bit
from .reverse_kernel import (CHUNK, MAX_TILE, TILE_QUERIES, _tile_masks,
                             _unpack_row_meta)
from .tile_match import KernelError, KernelInputError

launches = 0

MAX_LC = 32  # deepest level compare compiled


def chunk_counts(packed: torch.Tensor) -> torch.Tensor:
    """``int32 [R, W*32/CHUNK]``: the set bits of each ``CHUNK``-row chunk
    of each row of the packed mask ``[R, W]``."""
    R, W = packed.shape
    return _popcount(packed).reshape(R, -1, CHUNK // 32).sum(
        dim=2, dtype=torch.int32)


def reverse_tiles_packed_ref(row_words, meta, q_words, q_eff, q_flags, sel,
                             start, *, seg: int, lc: int):
    """Plain PyTorch version of the kernel: ``_tile_masks`` packed, one
    tile at a time (bounded memory on the card's full-table windows), empty
    slots zeroed; the counts from the packed words. Returns ``(packed,
    counts)``."""
    rl, rd, ra = _unpack_row_meta(meta)
    hh, fw = (q_flags & 1) > 0, (q_flags & 2) > 0
    live = (sel >= 0).reshape(-1, 1).to(torch.int32)
    sel = sel.clamp(0, q_words.shape[0] - 1)
    packed = torch.cat([
        _pack_mask(_tile_masks(row_words, rl, rd, ra, q_words, q_eff, hh,
                               fw, sel[t:t + 1], start[t:t + 1], seg=seg,
                               lc=lc))
        for t in range(sel.shape[0])]) * live
    return packed, chunk_counts(packed)


def _check(name, x, shape, dev):
    if x.device != dev or x.dtype != torch.int32 \
            or tuple(x.shape) != shape or not x.is_contiguous():
        raise KernelInputError(
            f"reverse_tiles: {name} must be a contiguous int32 tensor of "
            f"shape {shape} on {dev}; got {x.dtype} {tuple(x.shape)} on "
            f"{x.device} (contiguous={x.is_contiguous()})")


def reverse_tiles_packed(row_words, meta, q_words, q_eff, q_flags, sel,
                         start, *, seg: int, lc: int, start_host):
    """Run the reverse-compare matcher: ``(packed int32 [T*TP, seg/32],
    counts int32 [T*TP, seg/CHUNK])``.

    Inputs (int32): ``row_words [N, L]``, ``meta [N]``
    (``reverse_kernel.pack_row_meta``), ``q_words [B, L]``, ``q_eff [B]``,
    ``q_flags [B]`` (``reverse_kernel.query_flags``), ``sel [T, TP]``
    (query indices in ``[0, B)``, negative for an empty slot), ``start [T]``
    and ``start_host``, its host copy, on which every window is checked to
    lie inside the table; ``lc`` levels are compared (``1 <= lc <= L``);
    ``seg`` is a positive multiple of ``CHUNK``. On CUDA the kernel also
    needs ``TP`` a multiple of 32 up to 256 and ``lc <= 32``.
    """
    global launches
    dev = row_words.device
    N, L = row_words.shape
    T, TP = sel.shape
    s = np.asarray(start_host).reshape(-1)
    if s.shape != (T,) or (s.size and (int(s.min()) < 0
                                       or int(s.max()) + seg > N)):
        raise KernelInputError(
            f"reverse_tiles: window starts {s.tolist()} + seg {seg} leave "
            f"the table (N={N})")
    if not 0 < lc <= L:
        raise KernelInputError(f"reverse_tiles: lc={lc} outside 1..{L}")
    if seg <= 0 or seg % CHUNK:
        raise KernelInputError(
            f"reverse_tiles: seg={seg} must be a positive multiple of "
            f"{CHUNK}")
    if dev.type == "cpu":
        return reverse_tiles_packed_ref(row_words, meta, q_words, q_eff,
                                        q_flags, sel, start, seg=seg, lc=lc)
    if dev.type != "cuda":
        raise KernelInputError(f"reverse_tiles: unsupported device {dev}")
    B = q_words.shape[0]
    _check("row_words", row_words, (N, L), dev)
    _check("meta", meta, (N,), dev)
    _check("q_words", q_words, (B, L), dev)
    _check("q_eff", q_eff, (B,), dev)
    _check("q_flags", q_flags, (B,), dev)
    _check("sel", sel, (T, TP), dev)
    _check("start", start, (T,), dev)
    if B <= 0 or T <= 0 or TP % TILE_QUERIES or not 0 < TP <= MAX_TILE \
            or lc > MAX_LC:
        raise KernelInputError(
            f"reverse_tiles: needs B > 0, T > 0, TP a multiple of "
            f"{TILE_QUERIES} up to {MAX_TILE} and lc <= {MAX_LC}; got B={B} "
            f"T={T} TP={TP} lc={lc}")
    out = torch.empty((T * TP, seg // 32), dtype=torch.int32, device=dev)
    counts = torch.empty((T * TP, seg // CHUNK), dtype=torch.int32,
                         device=dev)
    lib = _build.load("reverse_match")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.reverse_match_launch(
            row_words.data_ptr(), meta.data_ptr(), q_words.data_ptr(),
            q_eff.data_ptr(), q_flags.data_ptr(), sel.data_ptr(),
            start.data_ptr(), out.data_ptr(), counts.data_ptr(), T, TP, L,
            N, B, seg, lc, stream)
    if rc != 0:
        raise KernelError(
            f"reverse_match kernel launch failed: CUDA error {rc}")
    launches += 1
    return out, counts


def extract_chunks_ref(packed: torch.Tensor, counts: torch.Tensor, k: int,
                       *, rows, ok):
    """Two-level compaction of a bit-packed mask ``[R0, W]`` over its chunk
    counts ``[R0, nb]`` (:func:`chunk_counts`): the first ``k`` set
    positions of each row ``rows[i]``, with rows where ``ok`` is False
    counted empty.

    A prefix sum of the small count array locates the chunk of each target
    match (``searchsorted``); popcounts run only over that chunk's words,
    and the bit select only on the chosen word — the reference's
    ``extract_indices_packed`` with the kernel's counts as its block
    counts, so no pass over the full-width mask is made. Returns ``(idx
    [R, k] int32, valid [R, k] bool, count [R] int32)``, the contract of
    ``match_kernel.extract_indices_packed``: ``idx`` is meaningful only
    where ``valid``, and ``count`` may exceed k. The plain version of the
    extraction kernel (:func:`extract_chunks`).
    """
    R0, W = packed.shape
    nb = counts.shape[1]
    wpb = W // nb
    dev = packed.device
    MK.plain_cuda_extractions += packed.is_cuda
    rows = rows.long()
    R = rows.shape[0]
    cnt = counts.index_select(0, rows) * ok[:, None].to(torch.int32)
    cum = cnt.cumsum(dim=1, dtype=torch.int32)  # inclusive
    count = cum[:, -1].contiguous()
    targets = torch.arange(k, dtype=torch.int32, device=dev) \
        .expand(R, k).contiguous()
    blk = torch.searchsorted(cum, targets, right=True).clamp(max=nb - 1)
    before = torch.where(blk > 0, cum.gather(1, (blk - 1).clamp(min=0)), 0)
    rank = targets - before  # rank of the target inside its chunk
    words = packed.view(R0, nb, wpb)[rows[:, None], blk]  # [R, k, wpb]
    wcum = _popcount(words).cumsum(dim=2, dtype=torch.int32)
    w = (wcum <= rank[:, :, None]).sum(dim=2).clamp(max=wpb - 1)
    prior = torch.where(
        w > 0, wcum.gather(2, (w - 1).clamp(min=0)[:, :, None])[:, :, 0], 0)
    word = words.gather(2, w[:, :, None])[:, :, 0]
    # past the count the rank is meaningless: those entries are not valid
    pos = _select_bit(word, (rank - prior).clamp(min=0))
    idx = (blk * (wpb * 32) + w * 32 + pos).to(torch.int32)
    return idx, targets < count[:, None], count


def extract_chunks(packed, counts, k: int, *, rows, ok):
    """Two-level extraction of rows ``rows`` (int32 ``[R]``, into the
    packed mask ``[R0, W]``) with liveness ``ok`` (bool ``[R]``) over the
    chunk counts ``[R0, nb]``: ``(idx [R, k] int32, valid [R, k] bool,
    count [R] int32)``, as :func:`extract_chunks_ref`. On CUDA it launches
    the extraction kernel with the counts (``idx`` is 0 where not valid)
    and raises on what it cannot take; on the CPU it takes the plain
    version."""
    return extract_rows(packed, k, rows=rows, ok=ok, counts=counts)


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.reverse_match_launch
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.reverse_match_smem_bytes
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int


_build.register("reverse_match", _bind)
