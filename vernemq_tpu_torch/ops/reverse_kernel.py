"""Batched reverse wildcard matching — subscription filters against a table
of retained topics — as PyTorch tensor code: the port of
``vernemq_tpu/ops/reverse_kernel.py`` (same names, same array layouts).

Retained replay on SUBSCRIBE inverts the forward roles (the MQTT dual,
``vmq_retain_srv:match_fold`` / ``vmq_reg.erl:380-418``): the query carries
the wildcards and the table rows are literal topics. A query filter matches
a topic row iff

- every concrete level is equal (``+`` is a per-level don't-care);
- ``row_len == eff_len`` without a trailing ``#``, ``row_len >= eff_len``
  with one (``#`` also accepts its parent level);
- MQTT-4.7.2-1: a filter whose level-0 word is a wildcard never matches a
  ``$``-topic;
- the row is live.

:func:`reverse_match` runs the reference's two phases — probe tiles of
concrete-level-0 queries against ``seg``-row windows of their bucket
regions, and the wildcard-first queries against every row — through ONE
hand kernel, ``ops/reverse_tiles.py`` (``csrc/reverse_match.cu``), which
writes the packed mask directly, so no ``[queries, rows]`` intermediate
reaches device memory (the reference relies on XLA's fusion for that), and
beside it the set bits of every ``CHUNK``-row chunk. The dense phase is the
same compare over one window of the whole table, its queries in tiles of up
to ``MAX_TILE``. The reference's coded-matmul variant (:func:`_dense_coded`,
which keeps a coded row operand ``G_t`` resident) is kept here as a plain
function only, for the parity tests and as a timing yardstick; the port
keeps no ``G_t`` on the device. The reference's own tests hold the two
dense variants bit-identical.

Extraction is two-level over the kernel's chunk counts, as the reference's
``extract_indices_packed`` works over its block counts, through the one
extraction kernel (``reverse_tiles.extract_chunks`` → ``ops/extract.py``,
``csrc/extract.cu``): no pass over the full-width packed mask.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from . import match_kernel as MK

PAD_ID = MK.PAD_ID
PLUS_ID = MK.PLUS_ID
HASH_ID = MK.HASH_ID

#: query slots come in warps of 32: a tile's width TP is a multiple, up to
#: MAX_TILE (the kernel's one thread per slot)
TILE_QUERIES = 32
MAX_TILE = 256
#: rows per chunk count (the first level of the extraction): the index
#: sizes probe windows and the table capacity (% 2048) in whole chunks
CHUNK = 256

#: row chunk of the plain dense functions: bounds their [BW, nc] mask
DENSE_CHUNK = 1 << 17

Parts = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def pack_row_meta(row_len, row_dollar, row_active):
    """The three per-row metadata arrays as ONE int32 word (len in bits
    0-15, dollar at bit 16, active at bit 17). Host side (numpy): the index
    packs at build/delta time; :func:`_unpack_row_meta` is the inverse and
    the kernel reads the same layout."""
    return (np.asarray(row_len, dtype=np.int32)
            | (np.asarray(row_dollar, dtype=np.int32) << 16)
            | (np.asarray(row_active, dtype=np.int32) << 17))


def _unpack_row_meta(meta: torch.Tensor):
    return meta & 0xFFFF, ((meta >> 16) & 1) > 0, ((meta >> 17) & 1) > 0


def query_flags(q_hh: torch.Tensor, q_fw: torch.Tensor) -> torch.Tensor:
    """The kernel's per-query flag word: bit 0 has_hash, bit 1 first_wild."""
    return q_hh.to(torch.int32) | (q_fw.to(torch.int32) << 1)


def build_row_operands(row_words: torch.Tensor, id_bits: int = 16):
    """Coded operand of the retained-topic table for the reference's dense
    coded phase: the forward ``build_pub_operand`` (rows are the concrete
    side here) transposed to ``bf16 [K, N]``. Plain only: the port's dense
    phase is the compare kernel, and chip_smoke times the coded product
    built from this as a yardstick."""
    return MK.build_pub_operand(row_words, id_bits).t().contiguous()


def _rule(len_ok, dollar, first_wild, active, qw, rw, q_eff, levels):
    """The reverse rule over broadcastable query/row operands: ``len_ok``,
    the ``$`` skip and liveness, then ``levels`` levelwise compares."""
    acc = len_ok & ~(dollar & first_wild) & active
    for lvl in range(levels):
        acc &= ((qw[..., lvl] == rw[..., lvl]) | (qw[..., lvl] == PLUS_ID)
                | (lvl >= q_eff))
    return acc


def reverse_mask_unrolled(q_words, q_eff, q_hh, q_fw, row_words, row_len,
                          row_dollar, row_active) -> torch.Tensor:
    """Reference reverse-match mask ``bool [B, N]`` (levelwise compare): the
    oracle, and the whole device path for tiny tables in tests."""
    qe = q_eff[:, None]
    len_ok = torch.where(q_hh[:, None], row_len[None, :] >= qe,
                         row_len[None, :] == qe)
    return _rule(len_ok, row_dollar[None, :], q_fw[:, None],
                 row_active[None, :], q_words[:, None, :],
                 row_words[None, :, :], qe, q_words.shape[1])


def _tile_masks(row_words, row_len, row_dollar, row_active, q_words, q_eff,
                q_hh, q_fw, t_sel, t_start, *, seg, lc) -> torch.Tensor:
    """Probe-phase mask over all tiles: gather each tile's query block and
    its ``seg``-row window, compare ``lc`` levels. Returns the flat
    ``bool [T*TP, seg]`` mask (pad slots compute rows nobody gathers).

    Only ``lc`` levels are compared (the deepest stored topic): a filter
    with more concrete levels than any row dies on the length rule."""
    T, TP = t_sel.shape
    sel = t_sel.reshape(-1).long()
    qw = q_words[:, :lc].index_select(0, sel).reshape(T, TP, lc)
    qe = q_eff.index_select(0, sel).reshape(T, TP, 1)
    qh = q_hh.index_select(0, sel).reshape(T, TP, 1)
    qf = q_fw.index_select(0, sel).reshape(T, TP, 1)
    ridx = (t_start.long()[:, None]
            + torch.arange(seg, device=row_words.device)[None, :])
    rw = row_words[:, :lc][ridx]                       # [T, seg, lc]
    rl = row_len[ridx][:, None, :]                     # [T, 1, seg]
    len_ok = torch.where(qh, rl >= qe, rl == qe)
    acc = _rule(len_ok, row_dollar[ridx][:, None, :], qf,
                row_active[ridx][:, None, :], qw[:, :, None, :],
                rw[:, None, :, :], qe, lc)
    return acc.reshape(T * TP, seg)


def _dense_chunks(mask_of, N: int, nc: int, k: int) -> Parts:
    """Pack the ``[BW, nc]`` chunk masks ``mask_of(slice)`` as they are made
    and extract the first ``k`` matches of every row."""
    packs = [MK._pack_mask(mask_of(slice(c, min(c + nc, N))))
             for c in range(0, N, nc)]
    packed = packs[0] if len(packs) == 1 else torch.cat(packs, dim=1)
    return MK.extract_indices_packed(packed, k)


def _dense_epilogue(sl, row_len, row_dollar, row_active, dq_eff, dq_hh,
                    dq_fw, dq_valid) -> torch.Tensor:
    qe = dq_eff[:, None]
    len_ok = torch.where(dq_hh[:, None], row_len[None, sl] >= qe,
                         row_len[None, sl] == qe)
    return (len_ok & ~(row_dollar[None, sl] & dq_fw[:, None])
            & row_active[None, sl] & dq_valid[:, None])


def _dense_coded(G_t, row_len, row_dollar, row_active, dq_words, dq_eff,
                 dq_hh, dq_fw, dq_valid, *, id_bits, k, nc) -> Parts:
    """The reference's dense phase as chunked coded products: the query
    block coded as the forward wildcard side (``build_operands``) against
    the row operand ``G_t``. The product runs in float32 on upcast operands
    (every partial sum an exact integer); plain only, see the module note."""
    F_t, t1 = MK.build_operands(dq_words, dq_eff, id_bits)  # [K, BW], [BW]
    Fq = F_t.to(torch.float32).t()

    def mask(sl):
        mm = Fq @ G_t[:, sl].to(torch.float32) + t1[:, None]
        return (mm == 0.0) & _dense_epilogue(
            sl, row_len, row_dollar, row_active, dq_eff, dq_hh, dq_fw,
            dq_valid)

    return _dense_chunks(mask, G_t.shape[1], nc, k)


def _dense_compare(row_words, row_len, row_dollar, row_active, dq_words,
                   dq_eff, dq_hh, dq_fw, dq_valid, *, k, nc, lc) -> Parts:
    """The reference's dense phase as a chunked levelwise compare
    (bit-identical to :func:`_dense_coded`)."""
    qe = dq_eff[:, None]

    def mask(sl):
        m = _dense_epilogue(sl, row_len, row_dollar, row_active, dq_eff,
                            dq_hh, dq_fw, dq_valid)
        for lvl in range(lc):
            m &= ((dq_words[:, lvl][:, None] == row_words[sl, lvl][None, :])
                  | (dq_words[:, lvl] == PLUS_ID)[:, None] | (lvl >= qe))
        return m

    return _dense_chunks(mask, row_words.shape[0], nc, k)


def dense_selectors(d_sel: torch.Tensor, d_valid: torch.Tensor):
    """The dense phase's kernel selectors ``[nt, TP]``: the live ``d_sel``
    slots in the fewest tiles of at most ``MAX_TILE`` slots (each a multiple
    of ``TILE_QUERIES`` wide), every other slot empty (-1)."""
    BW = d_sel.shape[0]
    nt = -(-BW // MAX_TILE)
    TP = -(-(-(-BW // nt)) // TILE_QUERIES) * TILE_QUERIES
    sel = torch.full((nt * TP,), -1, dtype=torch.int32, device=d_sel.device)
    sel[:BW] = torch.where(d_valid, d_sel, -1)
    return sel.reshape(nt, TP)


def reverse_match(row_words, meta, q_words, q_eff, q_hh, q_fw, t_sel,
                  t_start, q_tile, q_pos, d_sel, d_valid, *, k: int,
                  seg: int, lc: int = 0) -> Tuple[torch.Tensor, ...]:
    """One reverse-match dispatch: the probe tiles and the dense phase, both
    through the compare kernel (``reverse_tiles.reverse_tiles_packed``),
    each extracted in two levels over the kernel's chunk counts
    (``reverse_tiles.extract_chunks``, the extraction kernel).

    ``t_sel [T, TP]`` selects each probe tile's queries (negative: an empty
    slot). ``t_start`` holds the probe windows' start rows on the HOST
    (numpy or a CPU tensor): the kernel wrapper checks their bounds there
    and the starts are uploaded without a wait. Every other argument is a
    tensor on the table's device. Returns ``(idx [B,k], valid [B,k], cnt
    [B], didx [BW,k], dvalid [BW,k], dcnt [BW])`` — the reference's
    contract: probe results in query order with absolute row ids, zeroed
    where ``q_tile < 0``; dense results in ``d_sel`` slot order, zeroed
    where ``!d_valid``; ``cnt``/``dcnt`` may exceed ``k``
    (host-fallback)."""
    from .reverse_tiles import extract_chunks, reverse_tiles_packed

    dev = row_words.device
    lc = lc or row_words.shape[1]
    q_flags = query_flags(q_hh, q_fw)
    start_host = np.asarray(t_start, np.int32).reshape(-1)
    t_start_dev = torch.from_numpy(start_host).to(dev, non_blocking=True)
    packed, counts = reverse_tiles_packed(
        row_words, meta, q_words, q_eff, q_flags, t_sel, t_start_dev,
        seg=seg, lc=lc, start_host=start_host)
    TP = t_sel.shape[1]
    tiled = q_tile >= 0
    tile = q_tile.clamp(min=0)
    # packing and counting are per row: extract the queries' own rows
    idx, valid, cnt = extract_chunks(packed, counts, k,
                                     rows=tile * TP + q_pos, ok=tiled)
    starts = torch.where(tiled, t_start_dev.index_select(0, tile.long()), 0)
    idx = idx + starts[:, None].to(torch.int32)

    # dense phase: the live d_sel slots in tiles of up to MAX_TILE, each a
    # window of the whole table from row 0
    dsel = dense_selectors(d_sel, d_valid)
    nt = dsel.shape[0]
    dpacked, dcounts = reverse_tiles_packed(
        row_words, meta, q_words, q_eff, q_flags, dsel,
        torch.zeros(nt, dtype=torch.int32, device=dev),
        seg=row_words.shape[0], lc=lc, start_host=np.zeros(nt, np.int32))
    didx, dvalid, dcnt = extract_chunks(
        dpacked, dcounts, k,
        rows=torch.arange(d_sel.shape[0], dtype=torch.int32, device=dev),
        ok=d_valid)
    return idx, valid, cnt, didx, dvalid, dcnt


def retained_apply_delta(row_words, meta, slots, d_words, d_meta):
    """Scatter retain set/delete deltas into the device table IN PLACE
    (``index_copy_``); ``slots`` is an int64 tensor on the table's device.
    Callers must not let a match read the tensors meanwhile (the index
    uses :func:`retained_apply_delta_copy` while one is in flight).
    Returns ``(row_words, meta)``."""
    row_words.index_copy_(0, slots, d_words)
    meta.index_copy_(0, slots, d_meta)
    return row_words, meta


def retained_apply_delta_copy(row_words, meta, slots, d_words, d_meta):
    """:func:`retained_apply_delta` into copies, for when an in-flight
    reverse match still reads the current tensors."""
    return retained_apply_delta(row_words.clone(), meta.clone(), slots,
                                d_words, d_meta)
