"""Batched wildcard topic matching as PyTorch tensor code: the port of
``vernemq_tpu/ops/match_kernel.py`` (same names, same array layouts).

Subscriptions live on the device as padded rows of interned word ids
(``PLUS_ID`` for ``+``, ``PAD_ID`` beyond the filter length, a trailing
``#`` dropped into ``has_hash``), plus ``sub_eff_len`` (concrete levels),
``first_wild`` and ``active``. A filter matches a publish iff every concrete
level equals the publish word or is ``+``, the length rule holds (``==
eff_len`` without ``#``, ``>= eff_len`` with it) and the ``$``-rule holds —
``vmq_topic.erl:53-66`` + ``vmq_reg_trie.erl:283-288`` over a batch.

The windowed production path (:func:`match_extract_windowed_flat`) matches
three zones, all through the hand kernel in ``ops/tile_match.py``: region 0
densely (:func:`_dense_region0`, the kernel's dense mode), and the probe-A /
probe-B windows. Each zone's first k matches per publish
come from the extraction kernel (``ops/extract.py``), and the results are
compacted on the device into one flat buffer. Every function here runs on
whatever device its tensors are on; nothing falls back to another device.
"""

from __future__ import annotations

import functools
import operator
from typing import List, Sequence, Tuple

import numpy as np
import torch

PAD_ID = 0
PLUS_ID = 1
HASH_ID = 2
FIRST_WORD_ID = 3  # real words intern from here

Parts = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _planes(ids: torch.Tensor, id_bits: int):
    """Byte planes of int32 word ids (arithmetic shifts, as in the
    reference: UNKNOWN_ID = -2 splits into 254, 255(, 255))."""
    planes = [ids & 255, (ids >> 8) & 255]
    if id_bits != 16:
        planes.append((ids >> 16) & 255)
    return planes


def build_operands(sub_words: torch.Tensor, sub_eff_len: torch.Tensor,
                   id_bits: int = 16) -> Tuple[torch.Tensor, torch.Tensor]:
    """Coded match operands of a subscription table.

    ``mismatch = G(pub) @ F(sub) + t1(sub)`` is 0 exactly when every
    concrete level matches (the expansion of ``Σ_l w_l Σ_d (s−p)²``, with
    ``w_l = 0`` on ``+`` levels and beyond eff_len):

      16-bit ids (K = 5L):  F = [2wc₀, 2wc₁, 65536w, 256w, w]
      24-bit ids (K = 6L):  F = [2wc₀, 2wc₁, 2wc₂, 65536w, 256w, w]

    Every operand is an integer representable in bf16 and every product
    and partial sum an integer below 2^24, so the float32 sum is exact in
    any order. Returns ``(F_t bf16 [K, S], t1 f32 [S])`` (F transposed, as
    the reference keeps it).
    """
    S, L = sub_words.shape
    lvl = torch.arange(L, device=sub_words.device)
    wf = ((sub_words != PLUS_ID)
          & (lvl[None, :] < sub_eff_len[:, None])).to(torch.float32)
    pf = [c.to(torch.float32) for c in _planes(sub_words, id_bits)]
    parts = [2.0 * wf * c for c in pf] + [m * wf for m in (65536.0, 256.0, 1.0)]
    F = torch.cat(parts, dim=1)  # [S, K]
    t1 = sum((wf * c * c).sum(dim=1) for c in pf)
    return F.t().contiguous().to(torch.bfloat16), t1.contiguous()


def build_pub_operand(pub_words: torch.Tensor, id_bits: int = 16) -> torch.Tensor:
    """``G bf16 [B, K]`` of a publish batch: ``[−p₀, −p₁(, −p₂), q»16,
    (q»8)&255, q&255]`` with ``q = Σ_d p_d² < 2^18`` split into base-256
    planes so every entry is bf16-exact."""
    planes = _planes(pub_words, id_bits)
    q = sum(c * c for c in planes)
    G = torch.cat([-c for c in planes] + [q >> 16, (q >> 8) & 255, q & 255],
                  dim=1)
    return G.to(torch.bfloat16)


def _popcount(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each int32 word, as int32 (SWAR on the unsigned value
    widened to int64, so no step can overflow)."""
    x = x.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) >> 24 & 0xFF).to(torch.int32)


#: calls of the plain bit-pack (:func:`_pack_mask`, which the plain
#: compare-and-pack versions — :func:`_dense_region0_packed`,
#: ``tile_match.window_tiles_packed_ref`` — call) on CUDA tensors: every
#: device path packs in a kernel, so a run that resets it reads 0 unless
#: something compared a kernel with its plain version
plain_cuda_packs = 0


def _pack_mask(mask: torch.Tensor) -> torch.Tensor:
    """``[B, S]`` bool → ``[B, S/32]`` int32 words, bit j of word w being
    column 32w + j (the reference's uint32 words, same bits, as int32)."""
    global plain_cuda_packs
    plain_cuda_packs += mask.is_cuda
    B, S = mask.shape
    if not mask.is_cuda and S % 32 == 0:
        # the same words from numpy's little-endian bit-pack (the weighted
        # sum below costs ~60x more on the CPU)
        return torch.from_numpy(np.packbits(
            mask.contiguous().numpy(), axis=-1,
            bitorder="little").view("<i4").astype(np.int32))
    bits = mask.reshape(B, S // 32, 32).to(torch.int64)
    weights = torch.ones(32, dtype=torch.int64, device=mask.device) \
        << torch.arange(32, device=mask.device)
    words = (bits * weights).sum(dim=2)  # the uint32 value
    # bit 31 weighs -2^31: subtract 2^32 where it is set (computed on the
    # device; writing a host scalar into a device tensor would wait)
    return (words - ((words >> 31) << 32)).to(torch.int32)


def _select_bit(word: torch.Tensor, rank: torch.Tensor) -> torch.Tensor:
    """Position of the set bit of rank ``rank`` (0-based) in each int32
    word, by halving: keep the low half when it holds more than ``rank``
    set bits, else step into the high half (5 popcount steps)."""
    w = word.to(torch.int64) & 0xFFFFFFFF
    r = rank.to(torch.int64)
    pos = torch.zeros_like(w)
    for width in (16, 8, 4, 2, 1):
        low = w & ((1 << width) - 1)
        n_low = _popcount(low).to(torch.int64)
        high = r >= n_low
        r = torch.where(high, r - n_low, r)
        w = torch.where(high, w >> width, low)
        pos += high * width
    return pos


#: calls of a plain extraction (:func:`extract_indices_packed`,
#: ``reverse_tiles.extract_chunks_ref``) on CUDA tensors: every device path
#: extracts through the kernel (``ops/extract.py``), so a run that resets it
#: reads 0 unless something compared the kernel with its plain version
plain_cuda_extractions = 0


def extract_indices_packed(packed: torch.Tensor, k: int) -> Parts:
    """Sort-free compaction of a bit-packed mask (``[R, W]`` int32) into
    the first ``k`` set positions of each row.

    A prefix sum of word popcounts locates the word holding the j-th match
    (``searchsorted``), and a bit select inside that word its position.
    The reference's two-level block search exists to suit the TPU's lane
    layout; the result is the same, so this version needs no block size.
    Returns ``(idx [R, k] int32, valid [R, k] bool, count [R] int32)``;
    ``idx`` is meaningful only where ``valid``, and ``count`` may exceed k.
    """
    global plain_cuda_extractions
    plain_cuda_extractions += packed.is_cuda
    R, W = packed.shape
    dev = packed.device
    cum = _popcount(packed).cumsum(dim=1, dtype=torch.int32)  # inclusive
    count = cum[:, -1].contiguous()
    targets = torch.arange(k, dtype=torch.int32, device=dev).expand(R, k)
    w = torch.searchsorted(cum, targets.contiguous(), right=True)
    w = w.clamp(max=W - 1)
    before = torch.where(w > 0, cum.gather(1, (w - 1).clamp(min=0)), 0)
    # rank of the target match inside its word (negative past the count:
    # those entries are not valid and their position is never read)
    pos = _select_bit(packed.gather(1, w), (targets - before).clamp(min=0))
    idx = (w * 32 + pos).to(torch.int32)
    valid = targets < count[:, None]
    return idx, valid, count


def match_mask_unrolled(sub_words, sub_eff_len, has_hash, first_wild, active,
                        pub_words, pub_len, pub_dollar) -> torch.Tensor:
    """Boolean match matrix ``[B, S]`` by a level-wise compare — the
    oracle shape, used for tables too small to bucket."""
    L = sub_words.shape[1]
    acc = _epilogue(pub_len, pub_dollar, sub_eff_len, has_hash, first_wild,
                    active)
    for l in range(L):
        ok_l = ((sub_words[:, l][None, :] == pub_words[:, l][:, None])
                | (sub_words[:, l] == PLUS_ID)[None, :]
                | (l >= sub_eff_len)[None, :])
        acc &= ok_l
    return acc


def extract_indices(mask: torch.Tensor, k: int) -> Parts:
    """Compaction of a ``[B, S]`` bool mask into its first ``k`` set
    columns per row (same contract as :func:`extract_indices_packed`).

    With :func:`match_mask_unrolled` this is the port's one path for the
    unbucketed table, replacing both of the reference's
    ``match_extract_mxu`` and ``match_extract`` (they differ only in how
    the TPU computes the same mask)."""
    B, S = mask.shape
    cs = mask.to(torch.int32).cumsum(dim=1, dtype=torch.int32)
    count = cs[:, -1].contiguous()
    targets = torch.arange(k, dtype=torch.int32, device=mask.device) \
        .expand(B, k).contiguous()
    idx = torch.searchsorted(cs, targets + 1).clamp(max=S - 1)
    return idx.to(torch.int32), targets < count[:, None], count


def _epilogue(pub_len, pub_dollar, eff, hh, fw, act) -> torch.Tensor:
    """Length / ``$``-rule / liveness mask ``[B, Sseg]``."""
    len_ok = torch.where(hh[None, :], pub_len[:, None] >= eff[None, :],
                         pub_len[:, None] == eff[None, :])
    return len_ok & ~(pub_dollar[:, None] & fw[None, :]) & act[None, :]


def _dense_region0_packed(F_t, t1, sub_eff_len, has_hash, first_wild,
                          active, pub_words, pub_len, pub_dollar, *, id_bits,
                          glob_pad, gc) -> torch.Tensor:
    """The packed mask ``int32 [B, glob_pad/32]`` of every publish against
    region 0 (filters whose first two levels are wildcards), made in
    ``gc`` publish chunks: the plain version of the tile kernel's dense
    mode (``tile_match.dense_region0_packed``), which the forward path
    runs; it is what that mode is held against on the card.

    The product runs in float32 on operands upcast from bf16: a bf16
    ``matmul`` returns bf16, which would round ``G@F`` before ``t1`` is
    added and turn a large near-cancelling sum into a false match. In
    float32 every partial sum is an exact integer, with or without TF32
    (every operand has at most 8 significant bits)."""
    B = pub_words.shape[0]
    F0 = F_t[:, :glob_pad].to(torch.float32)
    t10 = t1[:glob_pad]
    ep = (sub_eff_len[:glob_pad], has_hash[:glob_pad],
          first_wild[:glob_pad], active[:glob_pad])
    packs = []
    for c in range(0, B, gc):
        sl = slice(c, c + gc)
        G = build_pub_operand(pub_words[sl], id_bits).to(torch.float32)
        mm = G @ F0 + t10
        m = (mm == 0.0) & _epilogue(pub_len[sl], pub_dollar[sl], *ep)
        packs.append(_pack_mask(m))
    return packs[0] if len(packs) == 1 else torch.cat(packs)


def _dense_region0(F_t, t1, sub_eff_len, has_hash, first_wild, active,
                   pub_words, pub_len, pub_dollar, *, id_bits, k, glob_pad,
                   gc, flags=None, G_all=None) -> Parts:
    """Every publish against region 0: its packed mask from one launch of
    the tile kernel in dense mode (``tile_match.dense_region0_packed``; on
    the CPU its plain version), then one extraction of the first ``k``
    matches of every row (``extract.extract_rows``). ``gc`` is the
    reference's publish chunk of the ``[B, glob_pad]`` mask; the kernel
    never forms that mask, so it is unused. ``flags`` / ``G_all`` pass the
    row flags and publish operand when the caller has them already."""
    from .extract import extract_rows
    from .tile_match import dense_region0_packed, row_flags

    if flags is None:
        flags = row_flags(has_hash, first_wild, active)
    if G_all is None:
        G_all = build_pub_operand(pub_words, id_bits)
    return extract_rows(dense_region0_packed(
        F_t, t1, sub_eff_len, flags, G_all, pub_len, pub_dollar,
        glob_pad=glob_pad), k)


def _flat_combine(real, k, C, *parts: Parts):
    """Flat compaction of the per-publish parts (dense region 0 and the
    probes; a mesh shard's dense chunk and probe): an exclusive prefix sum
    over the k-clamped totals gives each real publish the range ``[pre,
    pre+total)`` of one ``[C]`` buffer, each part's entries after the
    previous parts'. Entries past ``C`` are dropped (the reference's
    ``mode="drop"``) and flag ``overflow``, as does a part clipped at k."""
    clip = functools.reduce(operator.or_, (c > k for _, _, c in parts))
    cnts = [torch.where(real, c, 0).clamp(max=k) for _, _, c in parts]
    total = functools.reduce(operator.add, cnts).to(torch.int32)
    pre = total.cumsum(0, dtype=torch.int32) - total
    j = torch.arange(k, device=real.device)[None, :]
    # one spare slot past the end takes every dropped entry (a masked
    # scatter needs no device→host sync, unlike boolean indexing)
    flat = torch.zeros(C + 1, dtype=torch.int32, device=real.device)
    base = pre
    for i, ((idx, valid, _), cnt) in enumerate(zip(parts, cnts)):
        if i:
            base = base + cnts[i - 1]
        pos = base[:, None] + j
        keep = valid & real[:, None] & (j < cnt[:, None]) & (pos < C)
        flat.scatter_(0, torch.where(keep, pos, C).reshape(-1),
                      idx.to(torch.int32).reshape(-1))
    overflow = ((pre + total > C) | clip) & real
    return flat[:C], pre, total, overflow


def match_extract_windowed_flat(
    F_t, t1, sub_eff_len, has_hash, first_wild, active,
    pub_words, pub_len, pub_dollar, n_real: int,
    t_sel, t_start, t2_sel, t2_start, a_tile, a_pos, b_tile, b_pos,
    *, id_bits: int, k: int, glob_pad: int, seg_max: int, seg2_max: int,
    gc: int, C: int, starts_dev=None,
):
    """The production match path: dense region 0, probe A (level-0 bucket
    windows, concrete-first rows) and probe B (level-1 g-bucket windows,
    wildcard-first rows), flat-compacted on the device.

    Arguments and result follow the reference function of the same name:
    ``(flat [C] int32, pre [B] int32, total [B] int32, overflow [B]
    bool)``; publish i's matched slot ids are ``flat[pre[i]:pre[i] +
    total[i]]`` unless ``overflow[i]`` (flat capacity exhausted or a part
    clipped at k: the caller matches that publish on the host).
    The window starts ``t_start`` / ``t2_start`` stay on the host (numpy or
    CPU tensors): the tile matcher checks its window bounds there, so
    nothing here copies device→host. ``starts_dev`` optionally holds the
    same two start arrays already on the device (views of a staged block,
    :func:`call_match_many`); otherwise they are uploaded here.
    """
    from .tile_match import _probe_tiles, row_flags

    B = pub_words.shape[0]
    real = torch.arange(B, device=pub_words.device) < n_real
    flags = row_flags(has_hash, first_wild, active)
    G_all = build_pub_operand(pub_words, id_bits)
    pd = pub_dollar.to(torch.int32)
    g = _dense_region0(F_t, t1, sub_eff_len, has_hash, first_wild, active,
                       pub_words, pub_len, pd, id_bits=id_bits, k=k,
                       glob_pad=glob_pad, gc=gc, flags=flags, G_all=G_all)
    probe = dict(k=k, glob_pad=glob_pad)
    a_dev, b_dev = starts_dev if starts_dev is not None else (None, None)
    a = _probe_tiles(F_t, t1, sub_eff_len, flags, G_all, pub_len, pd, t_sel,
                     t_start, a_tile, a_pos, seg_max=seg_max,
                     mode="a", start_dev=a_dev, **probe)
    if seg2_max:
        b = _probe_tiles(F_t, t1, sub_eff_len, flags, G_all, pub_len, pd,
                         t2_sel, t2_start, b_tile, b_pos, seg_max=seg2_max,
                         mode="b", start_dev=b_dev, **probe)
    else:
        dev = pub_words.device
        b = (torch.zeros((B, k), dtype=torch.int32, device=dev),
             torch.zeros((B, k), dtype=torch.bool, device=dev),
             torch.zeros(B, dtype=torch.int32, device=dev))
    return _flat_combine(real, k, C, g, a, b)


def apply_delta_fused_nometa(dev_arrays, operands, slots, d_words, d_eff_len,
                             d_has_hash, d_first_wild, d_active, *,
                             id_bits: int) -> None:
    """Scatter dirty table rows into the device-resident state IN PLACE
    (``index_copy_``): the five base arrays and the coded operand columns
    (``operands`` is None when the ids are too wide to code), the latter
    rebuilt for the dirty rows only. ``slots`` is an int64 index tensor on
    the same device; repeated slots carry identical rows. Callers must not
    let a match read these tensors concurrently (the matcher copies first
    while a match is in flight)."""
    words, eff, hh, fw, act = dev_arrays
    words.index_copy_(0, slots, d_words)
    eff.index_copy_(0, slots, d_eff_len)
    hh.index_copy_(0, slots, d_has_hash)
    fw.index_copy_(0, slots, d_first_wild)
    act.index_copy_(0, slots, d_active)
    if operands is not None:
        F_t, t1 = operands
        F_d, t1_d = build_operands(d_words, d_eff_len, id_bits)
        F_t.index_copy_(1, slots, F_d)
        t1.index_copy_(0, slots, t1_d)


def apply_delta_windowed_fused(state, slots, d_words, d_eff_len, d_has_hash,
                               d_first_wild, d_active, *, id_bits: int,
                               glob: int, row_lo: int = 0,
                               copy: bool = False) -> tuple:
    """The sharded matcher's delta on one shard (the reference's
    ``apply_delta_windowed_fused``, which updates the whole sharded state
    in one scatter). ``state`` is the shard's twelve tensors in the
    reference's order: its table rows ``[row_lo, row_lo + Sl)`` of ``F_t``
    (columns), ``t1``, ``eff_len``, ``has_hash``, ``first_wild`` and
    ``active``, then its replicated mirrors of the g-zone (rows ``<
    glob``). ``slots`` and the ``d_*`` rows are host (numpy) arrays of
    global rows; a slot outside the shard's rows or the zone is dropped,
    as the reference's ``mode="drop"`` drops it. The coded operand columns
    of the dirty rows are built once on the shard's device. Updates in
    place (``index_copy_``), or, with ``copy`` (a match in flight still
    reads the tensors: the reference's ``_copy`` variant), updates copies
    of the touched tensors. Returns the twelve tensors."""
    dev = state[0].device
    slots = np.asarray(slots, np.int64)
    hi = row_lo + state[0].shape[1]
    parts = ((0, (slots >= row_lo) & (slots < hi), row_lo),
             (6, slots < glob, 0))
    if not any(m.any() for _, m, _ in parts):
        return tuple(state)
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    F_d, t1_d = build_operands(put(d_words), put(d_eff_len), id_bits)
    vals = (put(d_eff_len), put(d_has_hash), put(d_first_wild),
            put(d_active))
    out = list(state)
    for o, mask, lo in parts:
        if not mask.any():
            continue
        sel = put(np.nonzero(mask)[0])
        idx = put(slots[mask] - lo)
        src = [F_d.index_select(1, sel), t1_d.index_select(0, sel)] \
            + [v.index_select(0, sel) for v in vals]
        for i, v in enumerate(src):
            t = out[o + i].clone() if copy else out[o + i]
            t.index_copy_(1 if i == 0 else 0, idx, v)
            out[o + i] = t
    return tuple(out)


# ----------------------------------------------------- stacked transport

def flat_pack_args(args) -> np.ndarray:
    """Host side of the packed transport: every per-batch host argument of
    :func:`match_extract_windowed_flat` in ONE int32 vector, laid out as
    the reference's ``flat_pack_args``. :func:`_unpack_transport` is its
    one decoder."""
    (pw, pl, pd, n_real, t_sel, t_start, t2_sel, t2_start,
     a_tile, a_pos, b_tile, b_pos) = args
    return np.concatenate([
        np.ascontiguousarray(pw, dtype=np.int32).ravel(),
        np.asarray(pl, dtype=np.int32).ravel(),
        np.asarray(pd, dtype=np.int32).ravel(),
        np.asarray([n_real], dtype=np.int32),
        np.ascontiguousarray(t_sel, dtype=np.int32).ravel(),
        np.asarray(t_start, dtype=np.int32).ravel(),
        np.ascontiguousarray(t2_sel, dtype=np.int32).ravel(),
        np.asarray(t2_start, dtype=np.int32).ravel(),
        np.asarray(a_tile, dtype=np.int32).ravel(),
        np.asarray(a_pos, dtype=np.int32).ravel(),
        np.asarray(b_tile, dtype=np.int32).ravel(),
        np.asarray(b_pos, dtype=np.int32).ravel(),
    ])


def _packed_geometry(args) -> dict:
    """Shape geometry of one packed batch, derived from the arg shapes."""
    B, L = args[0].shape
    T, TP = args[4].shape
    return dict(B=B, L=L, T=T, TP=TP, T2=args[6].shape[0])


def _unpack_transport(packed: torch.Tensor, B: int, L: int, T: int,
                      TP: int, T2: int):
    """Decode one :func:`flat_pack_args` vector on its device: the twelve
    trailing arguments of :func:`match_extract_windowed_flat`, each a view
    of ``packed`` (``pub_dollar`` becomes a bool tensor, ``n_real`` a 0-d
    view). The reference's decoder also unpacks its ``pack_meta`` word;
    the port keeps the per-slot table arrays resident one by one, so there
    is no meta word."""
    o = 0
    pw = packed[o:o + B * L].view(B, L); o += B * L
    pl = packed[o:o + B]; o += B
    pd = packed[o:o + B].to(torch.bool); o += B
    n_real = packed[o]; o += 1
    t_sel = packed[o:o + T * TP].view(T, TP); o += T * TP
    t_start = packed[o:o + T]; o += T
    t2_sel = packed[o:o + T2 * TP].view(T2, TP); o += T2 * TP
    t2_start = packed[o:o + T2]; o += T2
    a_tile = packed[o:o + B]; o += B
    a_pos = packed[o:o + B]; o += B
    b_tile = packed[o:o + B]; o += B
    b_pos = packed[o:o + B]; o += B
    return (pw, pl, pd, n_real, t_sel, t_start, t2_sel, t2_start,
            a_tile, a_pos, b_tile, b_pos)


def stage_many(preps: Sequence[tuple], device) -> torch.Tensor:
    """Pack K prepped batches into ONE ``[K, P]`` int32 host block (pinned
    for a CUDA ``device``) and upload it with one ``non_blocking`` copy."""
    vecs = [flat_pack_args(a) for a in preps]
    stage = torch.empty((len(vecs), vecs[0].shape[0]), dtype=torch.int32,
                        pin_memory=torch.device(device).type == "cuda")
    host = stage.numpy()
    for i, v in enumerate(vecs):
        host[i] = v
    return stage.to(device, non_blocking=True)


def match_many_staged(F_t, t1, sub_eff_len, has_hash, first_wild, active,
                      staged: torch.Tensor, preps: Sequence[tuple],
                      statics: dict) -> torch.Tensor:
    """Run :func:`match_extract_windowed_flat` once per row of the staged
    block, back to back on the current stream, writing row k of one
    ``[K, C + 3B]`` int32 device result (``flat, pre, total, overflow``,
    the reference's packed result layout). Nothing here waits for the
    device: the window bounds are checked on the host starts of ``preps``
    (``args[5]``, ``args[7]``), the kernels read the staged views."""
    geom = _packed_geometry(preps[0])
    B, C = geom["B"], statics["C"]
    out = torch.empty((len(preps), C + 3 * B), dtype=torch.int32,
                      device=staged.device)
    for i, args in enumerate(preps):
        v = _unpack_transport(staged[i], **geom)
        flat, pre, total, overflow = match_extract_windowed_flat(
            F_t, t1, sub_eff_len, has_hash, first_wild, active,
            *v[:5], args[5], v[6], args[7], *v[8:], **statics,
            starts_dev=(v[5], v[7]))
        row = out[i]
        row[:C].copy_(flat)
        row[C:C + B].copy_(pre)
        row[C + B:C + 2 * B].copy_(total)
        row[C + 2 * B:].copy_(overflow)
    return out


def call_match_many(F_t, t1, sub_eff_len, has_hash, first_wild, active,
                    preps: Sequence[tuple], statics: dict) -> np.ndarray:
    """Super-batch dispatch: stage the K prepped batches as one block (one
    upload), run them back to back (:func:`match_many_staged`) and
    download the ``[K, C + 3B]`` result with one device→host copy. No host
    sync runs between the upload and the download. Decode with
    :func:`unpack_many_results`. (``device.dispatch`` injection point.)"""
    from ..robustness import faults

    faults.inject("device.dispatch")
    staged = stage_many(preps, F_t.device)
    out = match_many_staged(F_t, t1, sub_eff_len, has_hash, first_wild,
                            active, staged, preps, statics)
    return out.cpu().numpy()


def unpack_flat_result(out: np.ndarray, B: int, C: int):
    """Decode one ``[C + 3B]`` result vector into ``(flat [C], pre [B],
    total [B], overflow [B] bool)``. ``B`` is the PADDED batch."""
    return (out[:C], out[C:C + B], out[C + B:C + 2 * B],
            out[C + 2 * B:C + 3 * B].astype(bool))


def unpack_many_results(out: np.ndarray, B: int, C: int) -> List[tuple]:
    """Decode a stacked ``[K, C + 3B]`` result into K
    :func:`unpack_flat_result` tuples."""
    return [unpack_flat_result(out[i], B, C) for i in range(out.shape[0])]


# ------------------------------------------- kernel-resident scan probe

def scan_sums(rows: torch.Tensor, B: int, C: int) -> torch.Tensor:
    """``int32 [2]``: ``(chk, tot)`` of stacked ``[K, C + 3B]`` results —
    the sum of every flat entry and of every per-publish total, with the
    int32 wrap-around of the reference's ``lax.scan`` over ``jnp.int32``
    (sums modulo 2^32, read as signed). Computed on the device."""
    s = torch.stack([rows[:, :C].sum(dtype=torch.int64),
                     rows[:, C + B:C + 2 * B].sum(dtype=torch.int64)])
    s = s & 0xFFFFFFFF
    return (s - ((s >> 31) << 32)).to(torch.int32)


class PackedScan:
    """K staged windows (the ``[K, P]`` block of :func:`stage_many`) run as
    one unit: :func:`match_many_staged` over every row, then
    :func:`scan_sums` — the port of the reference's ``match_packed_scan``,
    its device-resident throughput probe.

    On CUDA the K dispatches and the sums are captured once in a CUDA graph
    and :meth:`run` replays it: no host work between the windows and no
    host traffic at all, so the time of a replay is the kernels' and the
    small operations' between them (the reference runs them inside one
    executable). Every window bound is checked on the host starts of
    ``preps`` when the graph is captured, and the capture runs with
    ``torch.cuda.set_sync_debug_mode("error")``: a host read on the
    dispatch raises there. The kernel wrappers count their launches at the
    capture, once per window; a replay launches them again uncounted
    (``captured`` holds the capture's ``tile`` / ``dense`` / ``extract``
    launches). On the CPU :meth:`run` is the plain loop. ``rows`` holds
    the ``[K, C + 3B]`` results of the last run and ``sums`` its ``int32
    [2]``."""

    def __init__(self, F_t, t1, sub_eff_len, has_hash, first_wild, active,
                 staged: torch.Tensor, preps: Sequence[tuple],
                 statics: dict):
        self._args = (F_t, t1, sub_eff_len, has_hash, first_wild, active,
                      staged, preps, statics)
        self.B = _packed_geometry(preps[0])["B"]
        self.C = statics["C"]
        self.K = len(preps)
        self.graph = None
        self.captured: dict = {}
        if staged.device.type == "cuda":
            self._capture(staged.device)
        else:
            self.run()

    def _compute(self):
        self.rows = match_many_staged(*self._args)
        self.sums = scan_sums(self.rows, self.B, self.C)

    def _capture(self, dev) -> None:
        from . import extract as EX
        from . import tile_match as TM

        counts = lambda: dict(tile=TM.launches, dense=TM.dense_launches,
                              extract=EX.launches)
        # one eager run first: it loads the kernel modules and fills the
        # wrappers' per-device buffers, which the graph then reads
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self._compute()
        side.synchronize()
        graph = torch.cuda.CUDAGraph()
        before = counts()
        with torch.cuda.stream(side):
            mode = torch.cuda.get_sync_debug_mode()
            graph.capture_begin()
            try:
                torch.cuda.set_sync_debug_mode("error")
                self._compute()
            finally:
                torch.cuda.set_sync_debug_mode(mode)
                graph.capture_end()
        torch.cuda.current_stream(dev).wait_stream(side)
        self.captured = {k: v - before[k] for k, v in counts().items()}
        self.graph = graph

    def run(self) -> None:
        """One pass over the K windows, on the current stream."""
        if self.graph is not None:
            self.graph.replay()
        else:
            self._compute()

    def result(self) -> Tuple[int, int]:
        """``(chk, tot)`` of the last run, read back with one copy."""
        chk, tot = self.sums.cpu().tolist()
        return chk, tot


def match_packed_scan(F_t, t1, sub_eff_len, has_hash, first_wild, active,
                      staged: torch.Tensor, preps: Sequence[tuple],
                      statics: dict) -> Tuple[int, int]:
    """Run the K staged windows once as one unit (:class:`PackedScan`: a
    CUDA graph on the card, the plain loop on the CPU) and return the
    reference's ``(chk, tot)`` as int32 values."""
    scan = PackedScan(F_t, t1, sub_eff_len, has_hash, first_wild, active,
                      staged, preps, statics)
    if scan.graph is not None:
        scan.run()
    return scan.result()
