"""Probe-window tile matcher: the port of ``vernemq_tpu/ops/pallas_match.py``.

For each tile t — TP publishes against a window of ``seg_max`` contiguous
table rows starting at ``start[t]`` — it computes the coded mismatch
``G[TP, K] @ F_t[K, rows] + t1`` (0 exactly when every concrete level
matches, see ``match_kernel.build_operands``), the length / ``$`` /
liveness epilogue and the row mode's guard, and packs the boolean mask 32
rows to an int32 word: bit j of word w is window row 32·w + j, layout
``[T, TP, seg_max/32]``. The row modes (``mode``):

- ``"a"``, probe A: rows past region 0 (``row >= glob_pad``) whose first
  level is concrete;
- ``"b"``, probe B: rows past region 0 whose first level is a wildcard;
- ``"dense"``: the rows of region 0 (``row < glob_pad``), all of them —
  the forward path's dense region 0 (:func:`dense_region0_packed`);
- ``"shard"``: rows past region 0 (``row >= glob_pad``) with no split on
  the first level — a mesh shard's probe A, whose rows are a slice of the
  table (``parallel/sharded_match.py``). With ``glob_pad`` 0 the guard is
  off (``parallel/mesh_match.py``'s per-slice match).

``row`` is the window row's index in the tensors given plus ``row_base``:
a shard passes the global index of its first row, so the guard reads
global rows (the kernel gets the signed threshold ``glob_pad -
row_base``).

Two versions of the one function:

- :func:`window_tiles_packed` launches the hand-written CUDA kernel
  (``csrc/tile_match.cu``) for CUDA tensors, and raises on what it cannot
  take; it never falls back.
- :func:`window_tiles_packed_ref` is the plain PyTorch version. The wrapper
  uses it for tensors on the CPU only; on the card it is what the kernel is
  held against.

The window bounds are checked on the host copy of the starts
(``start_host``, the array the caller made ``start`` from), so a launch on
the card costs no device→host copy. ``launches`` counts the probes' kernel
launches and ``dense_launches`` the dense mode's (reset them to read one
run's counts).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build
from .match_kernel import _pack_mask

launches = 0
dense_launches = 0

ROW_CHUNK = 256  # window rows per kernel chunk: 8 warps of 32 rows
PUB_TILE = 16    # publishes per tensor-core tile (the mma's M)
MAX_K = 96       # 6 planes x 16 levels: the widest operand compiled
KEY_CLAMP = 31   # publish lengths clamp here in the kernel's row masks
T1_COLS = 3      # K columns in which the kernel carries t1 - 1
DENSE_TP = 128   # publishes per dense-mode tile
MODES = {"a": 0, "b": 1, "dense": 2, "shard": 3}  # the kernel's row modes


class KernelError(RuntimeError):
    """The kernel failed to launch or refused its inputs: a fault of the
    code, which the matcher raises to its caller and never feeds to the
    device breaker or answers from the trie."""


class KernelInputError(KernelError, ValueError):
    """The wrapper refused its inputs (device, dtype, shape, alignment or
    window bounds)."""


def padded_k(K: int) -> int:
    """The kernel's compiled width for operands of width ``K``: ``K`` plus
    the t1 columns, rounded up to the tensor-core k-step of 16."""
    return (K + T1_COLS + 15) // 16 * 16


def _mode(mode: str) -> int:
    if mode not in MODES:
        raise KernelInputError(
            f"tile_match: mode {mode!r} is none of {sorted(MODES)}")
    return MODES[mode]


def _row_ok(rows, fw, glob_pad: int, mode: str):
    """The row mode's guard (see the module docstring)."""
    code = _mode(mode)
    if code == MODES["dense"]:
        return rows < glob_pad
    if code == MODES["shard"]:
        return rows >= glob_pad
    return (rows >= glob_pad) & (fw if mode == "b" else ~fw)


def window_tiles_packed_ref(F_t, t1, eff, flags, Gt, plt, pdt, start, *,
                            seg_max: int, glob_pad: int, mode: str,
                            row_base: int = 0) -> torch.Tensor:
    """Plain PyTorch version of the tile matcher (one tile at a time), in
    the kernel's two halves: the packed verdict of the coded compare, ANDed
    with the packed word of the window rows a publish of that key may
    match (:func:`row_masks`, :func:`pub_keys`)."""
    T = Gt.shape[0]
    j = torch.arange(seg_max, device=F_t.device)
    keys = pub_keys(plt, pdt)
    bit = torch.arange(64, dtype=torch.int64, device=F_t.device)[:, None]
    # t1 rides the product as one more K column against G = 1 (exact: every
    # partial sum is an integer below 2^24, as in the kernel)
    G1 = torch.cat([Gt.to(torch.float32),
                    Gt.new_ones(Gt.shape[:2] + (1,), dtype=torch.float32)],
                   dim=2)
    # a tile's publishes repeat (pad slots select one publish): each
    # distinct (operand row, key) is computed once and copied to its slots
    ident = torch.cat([Gt.view(torch.int16).to(torch.int32),
                       keys.to(torch.int32)[:, :, None]], dim=2)
    out = []
    for t in range(T):
        s = int(start[t])
        win = slice(s, s + seg_max)  # the window's rows, contiguous
        _, inv = torch.unique(ident[t], dim=0, return_inverse=True)
        first = torch.zeros(int(inv.max()) + 1, dtype=torch.int64,
                            device=inv.device).scatter_(
            0, inv, torch.arange(inv.numel(), device=inv.device))
        mm = G1[t, first] @ torch.cat([F_t[:, win].to(torch.float32),
                                       t1[None, win]])
        rm = row_masks(eff, flags, s + j, glob_pad=glob_pad, mode=mode,
                       row_base=row_base)
        key_words = _pack_mask(((rm[None, :] >> bit) & 1) > 0)
        key_words = torch.cat([key_words, key_words.new_zeros(
            (1, seg_max // 32))])  # key 64: no bit
        out.append((_pack_mask(mm == 0.0) & key_words[keys[t, first]])[inv])
    return torch.stack(out)


def row_masks(eff, flags, rows, *, glob_pad: int, mode: str,
              row_base: int = 0) -> torch.Tensor:
    """The kernel's per-row epilogue as one int64 mask per row: bit
    ``key`` (see :func:`pub_keys`) is set iff a publish of that key may
    match the row — the length rule, the ``$`` rule (bits 32..63 are the
    ``$`` publishes'), liveness and the row mode's guard (on ``rows +
    row_base``). Exact for ``eff <= KEY_CLAMP - 1`` (the table's eff is at
    most L)."""
    e = eff[rows].to(torch.int64)
    fl = flags[rows]
    hh, fw, act = (fl & 1) > 0, (fl & 2) > 0, (fl & 4) > 0
    # bit b (a publish of length b): b >= e with '#', b == e without
    lo = torch.where(hh, (0xFFFFFFFF << e.clamp(0, 32)) & 0xFFFFFFFF,
                     torch.where((e >= 0) & (e < 32), 1 << e.clamp(0, 31),
                                 0))
    row_ok = act & _row_ok(rows + row_base, fw, glob_pad, mode)
    return torch.where(row_ok, lo | torch.where(fw, 0, lo << 32), 0)


def t1_columns(t1) -> torch.Tensor:
    """The kernel's extra F rows (``float32 [3, S]``, each entry
    bf16-exact): ``t1 - 1`` in base-256 pieces ``(t & 255) - 1``,
    ``t & 0xff00`` and ``t & ~0xffff`` of the integer ``t = t1``. Against
    ``G = 1`` they add ``t1 - 1`` to the product, so a pair's result is
    ``mismatch - 1``: negative exactly when the mismatch is 0."""
    t = t1.to(torch.int64)
    return torch.stack([(t & 255) - 1, t & 0xff00, t & ~0xffff]) \
        .to(torch.float32)


def pub_keys(plt, pdt) -> torch.Tensor:
    """Each publish's bit in :func:`row_masks`: ``min(plen, KEY_CLAMP) +
    32·(pd > 0)``, or 64 (no bit: never matches) for a negative length."""
    k = plt.to(torch.int64).clamp(max=KEY_CLAMP) + 32 * (pdt > 0)
    return torch.where(plt < 0, 64, k)


def _check(name, x, dtype, shape, dev, align=16):
    if x.device != dev or x.dtype != dtype or tuple(x.shape) != shape \
            or not x.is_contiguous():
        raise KernelInputError(
            f"tile_match: {name} must be a contiguous {dtype} tensor of "
            f"shape {shape} on {dev}; got {x.dtype} {tuple(x.shape)} on "
            f"{x.device} (contiguous={x.is_contiguous()})")
    if x.data_ptr() % align:
        raise KernelInputError(
            f"tile_match: {name} must start on a {align}-byte boundary "
            f"(cp.async copies 16-byte pieces; the starts are read one "
            f"int32 at a time)")


def window_tiles_packed(F_t, t1, eff, flags, Gt, plt, pdt, start, *,
                        seg_max: int, glob_pad: int, mode: str,
                        start_host, row_base: int = 0) -> torch.Tensor:
    """Run the tile matcher: ``int32 [T, TP, seg_max/32]`` packed mask.
    ``mode`` is the row mode, ``"a"``, ``"b"``, ``"dense"`` or
    ``"shard"``; ``row_base`` is the global index of the tensors' first row
    (the guard reads ``row_base`` + the row's index).

    Inputs: ``F_t`` bf16 [K, S], ``t1`` f32 [S], ``eff`` / ``flags`` int32
    [S] (flags: bit 0 has_hash, bit 1 first_wild, bit 2 active), ``Gt``
    bf16 [T, TP, K], ``plt`` / ``pdt`` int32 [T, TP], ``start`` int32 [T]
    (window start rows, any row) and ``start_host``, its host copy (numpy
    or a CPU tensor), on which every window is checked to lie inside the
    table. On CUDA the kernel also needs ``S % 8 == 0``, ``TP % 16 == 0``
    and ``seg_max % 256 == 0``.
    """
    global launches, dense_launches
    dev = F_t.device
    S = F_t.shape[1]
    code = _mode(mode)
    s = np.asarray(start_host).reshape(-1)
    if s.shape != (Gt.shape[0],) or (
            s.size and (int(s.min()) < 0 or int(s.max()) + seg_max > S)):
        raise KernelInputError(
            f"tile_match: window starts {s.tolist()} + seg_max {seg_max} "
            f"leave the table (S={S})")
    if dev.type == "cpu":
        return window_tiles_packed_ref(F_t, t1, eff, flags, Gt, plt, pdt,
                                       start, seg_max=seg_max,
                                       glob_pad=glob_pad, mode=mode,
                                       row_base=row_base)
    if dev.type != "cuda":
        raise KernelInputError(f"tile_match: unsupported device {dev}")
    K = F_t.shape[0]
    T, TP, _ = Gt.shape
    _check("F_t", F_t, torch.bfloat16, (K, S), dev)
    for name, x, dt in (("t1", t1, torch.float32), ("eff", eff, torch.int32),
                        ("flags", flags, torch.int32)):
        _check(name, x, dt, (S,), dev)
    _check("Gt", Gt, torch.bfloat16, (T, TP, K), dev)
    _check("plt", plt, torch.int32, (T, TP), dev)
    _check("pdt", pdt, torch.int32, (T, TP), dev)
    _check("start", start, torch.int32, (T,), dev, align=4)
    if not 0 < K <= MAX_K:
        raise KernelInputError(f"tile_match: K={K} outside 1..{MAX_K}")
    if seg_max <= 0 or seg_max % ROW_CHUNK or seg_max > S:
        raise KernelInputError(
            f"tile_match: seg_max={seg_max} must be a positive multiple "
            f"of {ROW_CHUNK} no larger than S={S}")
    if S % 8:
        raise KernelInputError(
            f"tile_match: S={S} must be a multiple of 8 (F_t rows are "
            f"copied in 16-byte pieces)")
    if TP % PUB_TILE:
        raise KernelInputError(
            f"tile_match: TP={TP} must be a multiple of {PUB_TILE} (the "
            f"tensor-core tile)")
    threshold = glob_pad - row_base  # the guard on the tensors' own rows
    if not -2**31 <= threshold < 2**31:
        raise KernelInputError(
            f"tile_match: glob_pad {glob_pad} - row_base {row_base} leaves "
            f"int32")
    out = torch.empty((T, TP, seg_max // 32), dtype=torch.int32, device=dev)
    lib = _build.load("tile_match")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.tile_match_launch(
            F_t.data_ptr(), t1.data_ptr(), eff.data_ptr(), flags.data_ptr(),
            Gt.data_ptr(), plt.data_ptr(), pdt.data_ptr(), start.data_ptr(),
            out.data_ptr(), T, TP, K, S, seg_max, threshold, code, stream)
    if rc != 0:
        raise KernelError(f"tile_match kernel launch failed: CUDA error {rc}")
    if code == MODES["dense"]:
        dense_launches += 1
    else:
        launches += 1
    return out


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.tile_match_launch
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int


_build.register("tile_match", _bind)


def row_flags(has_hash, first_wild, active) -> torch.Tensor:
    """The kernel's per-row flag word: bit 0 has_hash, bit 1 first_wild,
    bit 2 active (int32)."""
    return (has_hash.to(torch.int32) | (first_wild.to(torch.int32) << 1)
            | (active.to(torch.int32) << 2))


def tile_operands(G_all, pub_len, pub_dollar, t_sel):
    """The tile publishes' kernel operands, gathered by the ``[T, TP]``
    selectors: ``(Gt [T, TP, K], plt [T, TP], pdt [T, TP])``."""
    T, TP = t_sel.shape
    sel = t_sel.reshape(-1).long()
    return (G_all.index_select(0, sel).reshape(T, TP, -1),
            pub_len.index_select(0, sel).reshape(T, TP),
            pub_dollar.index_select(0, sel).reshape(T, TP))


def _probe_tiles(F_t, t1, sub_eff_len, flags, G_all, pub_len, pub_dollar,
                 t_sel, start_host, tile, pos, *, k: int, seg_max: int,
                 glob_pad: int, mode: str, start_dev=None, row_base: int = 0):
    """One probe (``mode`` "a" or "b"): gather the tile publishes'
    operands, run the tile matcher, extract the first ``k`` matches of
    each publish's own tile row and make them absolute slot ids. Publish
    i's row is tile ``tile[i]`` slot ``pos[i]`` (``tile < 0``: no window
    in this probe, a dead row). ``start_host`` holds the window starts on the host (numpy
    or a CPU tensor): the bounds are checked there. ``start_dev`` is the
    same starts already on the device (a view of a staged block); without
    it the host copy is uploaded, without waiting. ``row_base`` is the
    global index of the tensors' first row (a mesh shard's): the row
    guard reads global rows and the ids come back global.
    Returns ``(idx [B, k], valid, count [B])`` in publish order — the
    reference's ``_probe_pallas`` / ``_window_tiles_sel`` results gathered
    by ``_gather_parts`` (it extracts every tile row, then gathers)."""
    from .extract import extract_rows

    T, TP = t_sel.shape
    t_start = start_dev if start_dev is not None else torch.as_tensor(
        np.asarray(start_host, np.int32)).to(F_t.device, non_blocking=True)
    Gt, plt, pdt = tile_operands(G_all, pub_len, pub_dollar, t_sel)
    packed = window_tiles_packed(F_t, t1, sub_eff_len, flags, Gt, plt, pdt,
                                 t_start, seg_max=seg_max, glob_pad=glob_pad,
                                 mode=mode, start_host=start_host,
                                 row_base=row_base)
    tt = tile.clamp(min=0).to(torch.int32)
    idx, valid, cnt = extract_rows(
        packed.reshape(T * TP, -1), k, rows=tt * TP + pos.to(torch.int32),
        ok=tile >= 0)
    base = t_start.index_select(0, tt)[:, None]
    return idx + (base + row_base if row_base else base), valid, cnt


def dense_geometry(B: int, glob_pad: int, S: int):
    """``(T, TP, seg)`` of the dense-mode launch for a batch of ``B``: tiles
    of ``TP`` consecutive publishes (:func:`dense_tiles`) and one window of
    ``glob_pad`` rows (a multiple of 32) rounded up to the kernel's row
    chunk, clipped to the table's whole words. On the windowed path the
    table is bucketed: ``S`` and ``glob_pad`` are multiples of 2048
    (``models/table.py``), so the window is ``glob_pad`` itself; a window
    clipped to an ``S`` that is not a multiple of 256 is refused on the
    card like any such ``seg_max``."""
    T, TP = dense_tiles(B)
    seg = min(-(-glob_pad // ROW_CHUNK) * ROW_CHUNK, S - S % 32)
    return T, TP, seg


def dense_tiles(B: int):
    """``(T, TP)``: tiles of ``TP`` consecutive publishes covering a batch
    of ``B`` (``DENSE_TP``, or ``B`` rounded up to the tensor-core step
    when smaller)."""
    TP = min(DENSE_TP, -(-max(B, 1) // PUB_TILE) * PUB_TILE)
    return -(-max(B, 1) // TP), TP


_fills = {}  # (device, value) -> int32 buffer: the window starts of a launch


def _starts(dev, T: int, start: int = 0) -> torch.Tensor:
    """``T`` int32 copies of ``start`` on ``dev``, from a buffer made once
    per device and value (no fill launch per dispatch). The buffer's fill
    is waited for once, when it is made, so a launch on any stream reads
    it."""
    z = _fills.get((dev, start))
    if z is None or z.numel() < T:
        z = torch.full((max(T, 256),), start, dtype=torch.int32, device=dev)
        if dev.type == "cuda":
            torch.cuda.current_stream(dev).synchronize()
        _fills[(dev, start)] = z
    return z[:T]


def dense_tiles_packed(F_t, t1, sub_eff_len, flags, G_all, pub_len,
                       pub_dollar, *, glob_pad: int, seg: int, start: int = 0,
                       mode: str = "dense", row_base: int = 0
                       ) -> torch.Tensor:
    """The packed mask ``int32 [B, seg/32]`` of every publish of a batch
    against the one window of ``seg`` rows from row ``start``, by one launch
    of the tile matcher over tiles of consecutive publishes
    (:func:`dense_tiles`). ``G_all`` bf16 ``[B, K]``, ``pub_len`` /
    ``pub_dollar`` ``[B]``. The batch is padded to whole tiles with
    publishes that match nothing (length -1), whose rows are dropped
    here."""
    B, K = G_all.shape
    dev = G_all.device
    T, TP = dense_tiles(B)
    pl = pub_len.to(torch.int32)
    if pl.data_ptr() % 16:  # a view at any offset of a staged block
        pl = pl.clone()
    pd = pub_dollar.to(torch.int32)
    pad = T * TP - B
    if pad:
        G_all = torch.cat([G_all, G_all.new_zeros((pad, K))])
        pl = torch.cat([pl, pl.new_full((pad,), -1)])
        pd = torch.cat([pd, pd.new_zeros(pad)])
    packed = window_tiles_packed(
        F_t, t1, sub_eff_len, flags, G_all.reshape(T, TP, K),
        pl.reshape(T, TP), pd.reshape(T, TP), _starts(dev, T, start),
        seg_max=seg, glob_pad=glob_pad, mode=mode, row_base=row_base,
        start_host=np.full(T, start, np.int32))
    return packed.reshape(T * TP, seg // 32)[:B]


def dense_region0_packed(F_t, t1, sub_eff_len, flags, G_all, pub_len,
                         pub_dollar, *, glob_pad: int) -> torch.Tensor:
    """The packed mask ``int32 [B, seg/32]`` of every publish against
    region 0 (rows ``< glob_pad``; the words past ``glob_pad/32`` are 0),
    by one launch of the tile matcher in dense mode (:func:`dense_geometry`,
    :func:`dense_tiles_packed`)."""
    _, _, seg = dense_geometry(G_all.shape[0], glob_pad, F_t.shape[1])
    return dense_tiles_packed(F_t, t1, sub_eff_len, flags, G_all, pub_len,
                              pub_dollar, glob_pad=glob_pad, seg=seg)
