"""Reverse-compare tile matcher: the hand kernel of the retained reverse
match (``csrc/reverse_match.cu``) and its plain PyTorch version.

For query slots ``sel [T, TP]`` (indices into the query block) with window
starts ``start [T]``, it computes the packed mask ``int32 [T*TP, seg/32]``:
bit j of word w of row ``t*TP + p`` is the full reverse rule
(``reverse_kernel.reverse_mask_unrolled``: length, ``$`` skip, liveness and
``lc`` levelwise compares) for query ``sel[t, p]`` against table row
``start[t] + 32·w + j`` — the layout of ``match_kernel._pack_mask``. It
replaces the mask halves of the reference's ``reverse_match``
(``vernemq_tpu/ops/reverse_kernel.py``: ``_tile_masks`` :130 and the dense
``_dense_compare`` :197 / ``_dense_coded`` :167), which XLA fuses with the
bit-pack; the kernel writes the packed words directly, so no boolean mask
reaches device memory. One kernel serves both phases: probe tiles of 32
queries against their bucket windows, and the dense phase as tiles of 32
against a window of the whole table.

- :func:`reverse_tiles_packed` launches the kernel for CUDA tensors and
  raises (``tile_match.KernelError`` / ``KernelInputError``) on what it
  cannot take; it never falls back. The window bounds are checked on the
  host copy of the starts (``start_host``), so a launch costs no
  device→host copy.
- :func:`reverse_tiles_packed_ref` is the plain version; the wrapper takes
  it for tensors on the CPU only.

``launches`` counts kernel launches (reset it to read one run's count).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build
from .match_kernel import _pack_mask
from .reverse_kernel import _tile_masks, _unpack_row_meta
from .tile_match import KernelError, KernelInputError

launches = 0

ROW_CHUNK = 256  # window rows per kernel block: 8 warps of 32
QUERY_TILE = 32  # queries per kernel block (TP must be a multiple)
MAX_LC = 32      # deepest level compare compiled


def reverse_tiles_packed_ref(row_words, meta, q_words, q_eff, q_flags, sel,
                             start, *, seg: int, lc: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel: ``_tile_masks`` packed, one
    tile at a time (bounded memory on the card's full-table windows)."""
    rl, rd, ra = _unpack_row_meta(meta)
    hh, fw = (q_flags & 1) > 0, (q_flags & 2) > 0
    return torch.cat([
        _pack_mask(_tile_masks(row_words, rl, rd, ra, q_words, q_eff, hh,
                               fw, sel[t:t + 1], start[t:t + 1], seg=seg,
                               lc=lc))
        for t in range(sel.shape[0])])


def _check(name, x, shape, dev):
    if x.device != dev or x.dtype != torch.int32 \
            or tuple(x.shape) != shape or not x.is_contiguous():
        raise KernelInputError(
            f"reverse_tiles: {name} must be a contiguous int32 tensor of "
            f"shape {shape} on {dev}; got {x.dtype} {tuple(x.shape)} on "
            f"{x.device} (contiguous={x.is_contiguous()})")


def reverse_tiles_packed(row_words, meta, q_words, q_eff, q_flags, sel,
                         start, *, seg: int, lc: int,
                         start_host) -> torch.Tensor:
    """Run the reverse-compare matcher: ``int32 [T*TP, seg/32]``.

    Inputs (int32): ``row_words [N, L]``, ``meta [N]``
    (``reverse_kernel.pack_row_meta``), ``q_words [B, L]``, ``q_eff [B]``,
    ``q_flags [B]`` (``reverse_kernel.query_flags``), ``sel [T, TP]``
    (query indices in ``[0, B)``), ``start [T]`` and ``start_host``, its host
    copy, on which every window is checked to lie inside the table; ``lc``
    levels are compared (``1 <= lc <= L``). On CUDA the kernel also needs
    ``TP % 32 == 0``, ``seg % 256 == 0`` and ``lc <= 32``.
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
    if B <= 0 or T <= 0 or TP % QUERY_TILE or seg <= 0 or seg % ROW_CHUNK \
            or lc > MAX_LC:
        raise KernelInputError(
            f"reverse_tiles: needs B > 0, T > 0, TP % {QUERY_TILE} == 0, "
            f"seg a positive multiple of {ROW_CHUNK} and lc <= {MAX_LC}; "
            f"got B={B} T={T} TP={TP} seg={seg} lc={lc}")
    out = torch.empty((T * TP, seg // 32), dtype=torch.int32, device=dev)
    lib = _build.load("reverse_match")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.reverse_match_launch(
            row_words.data_ptr(), meta.data_ptr(), q_words.data_ptr(),
            q_eff.data_ptr(), q_flags.data_ptr(), sel.data_ptr(),
            start.data_ptr(), out.data_ptr(), T, TP, L, N, B, seg, lc,
            stream)
    if rc != 0:
        raise KernelError(
            f"reverse_match kernel launch failed: CUDA error {rc}")
    launches += 1
    return out


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.reverse_match_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int


_build.register("reverse_match", _bind)
