"""The GPU match engine: a device-resident subscription table and batched
wildcard matching, behind the registry's reg-view seam.

The port of ``vernemq_tpu/models/tpu_matcher.py``'s core: ``vmq_reg_trie``'s
``fold_subscribers`` becomes one batched device call over thousands of
concurrent PUBLISHes.

- :class:`GpuMatcher` owns a :class:`SubscriptionTable`, mirrors it to the
  device (full upload on growth, in-place scatter of dirty rows otherwise)
  and serves ``match_batch``: a dense pass over region 0 plus probe-A /
  probe-B window tiles through the hand kernel (``ops/tile_match.py``),
  compacted on the device into one flat buffer. Publishes the device cannot
  serve exactly (window leftovers, fanout past ``max_fanout``, flat
  capacity) are matched on the host against the same table snapshot.
- :class:`GpuRegView` is the reg-view adapter over a registry that offers
  ``fold_subscriptions(mountpoint)`` and ``trie(mountpoint)``.

Not yet ported (ROADMAP): background rebuild, stall watchdog, circuit
breaker, warm-signature gate, ``match_many``, packed transport,
observability seams and the ``BatchCollector``.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Hashable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..ops import match_kernel as K
from .table import SubscriptionTable

Row = Tuple[Tuple[str, ...], Hashable, Any]

TILE_PUBS = 256  # publishes per window tile
FAIR_MULT = 2    # window width vs per-tile fair share of the zone


def _pow2ceil(n: int) -> int:
    return 1 << max(n - 1, 1).bit_length()


def _pad_pub_block(pw, pl, pd, Bpad: int):
    """Grow an encoded publish block to a larger padded batch size (so
    several batches can share one padded geometry)."""
    cur = pw.shape[0]
    if cur == Bpad:
        return pw, pl, pd
    extra = Bpad - cur
    pw = np.concatenate(
        [pw, np.full((extra, pw.shape[1]), np.int32(K.PAD_ID), np.int32)])
    pl = np.concatenate([pl, np.zeros(extra, np.int32)])
    pd = np.concatenate([pd, np.zeros(extra, bool)])
    return pw, pl, pd


def window_params(S: int, glob_pad: int, bucket_max: int, Bpad: int,
                  zone: Optional[int] = None):
    """Kernel geometry for a padded batch: tile count T (fixed per Bpad),
    window width seg_max (pow2, ≥ every bucket region and ≥ 2x the
    per-tile fair share of the zone) and the dense chunk gc. ``zone`` is
    the row span the tiles must cover (probe A: the level-0 buckets; probe
    B: the g-bucket zone), by default S - glob_pad."""
    slot_tiles = max(1, Bpad // TILE_PUBS)
    zone = (S - glob_pad) if zone is None else zone
    zone = max(zone, 4096)  # bucketed zones are >=4096 and 2048-aligned
    fair = FAIR_MULT * zone // slot_tiles
    # pow2 ≥ 4096 (a multiple of the extraction and kernel blocks),
    # clamped to the zone, to S and to a cap on the [TP, seg] working set
    # (span tiles absorb the difference: same work, bounded memory)
    SEG_CAP = 262_144
    seg_max = min(_pow2ceil(max(4096, bucket_max, fair)),
                  max(SEG_CAP, _pow2ceil(bucket_max)),
                  zone - zone % 2048, S)
    # greedy packing closes a tile when its window span fills even if pub
    # slots remain, so tiles needed ≈ slot tiles + span tiles
    span_tiles = -(-zone // seg_max)
    T = slot_tiles + span_tiles + 2
    gc = min(Bpad, max(256, (1 << 28) // max(glob_pad, 1)))
    return T, seg_max, gc


def prepare_windows(pb: np.ndarray, n: int, reg_start: np.ndarray,
                    reg_end: np.ndarray, S: int, T: int, seg_max: int,
                    row_lo: int = 0, row_hi: Optional[int] = None):
    """Host prep for the windowed kernels: sort the n real publishes by
    their region's address, pack them into at most T tiles of TILE_PUBS
    slots, window each tile at its first region's start. Publishes that
    cannot be tiled (window budget exhausted, or a region outside
    ``[row_lo, row_hi)``) come back as ``leftovers`` for exact host
    matching.

    Returns ``(t_sel [T, TP] int32, t_start [T] int32 (row_lo-relative),
    tile_of [n], pos_of [n], leftovers)``; pad slots select publish 0.
    """
    TP = TILE_PUBS
    hi_cap = S if row_hi is None else row_hi
    if seg_max > hi_cap - row_lo:
        raise ValueError("window wider than the row slice")
    # sort by region ADDRESS: relocation makes reg_start non-monotone in
    # bucket id, and windows span contiguous addresses
    pbn = pb[:n]
    rs = reg_start[pbn].astype(np.int64)
    re_ = reg_end[pbn].astype(np.int64)
    order = np.argsort(rs, kind="stable")
    t_sel = np.zeros((T, TP), dtype=np.int32)
    t_start = np.zeros(T, dtype=np.int32)
    tile_of = np.full(n, -1, dtype=np.int32)
    pos_of = np.zeros(n, dtype=np.int32)
    leftovers: List[int] = []
    # greedy packing over REGION GROUPS: consecutive regions share a tile
    # while the window spans them and slots remain; oversubscribed regions
    # split across tiles with the same window
    srs = rs[order]
    sre = re_[order]
    grp_first = np.concatenate([[0], np.nonzero(np.diff(srs))[0] + 1])
    grp_count = np.diff(np.concatenate([grp_first, [n]]))
    ti = -1
    cur_start = -1
    cur_used = TP  # force a new tile for the first group
    spans: List[Tuple[int, int, int, int]] = []  # (tile, slot0, lo, cnt)
    for g in range(len(grp_first)):
        lo = int(grp_first[g])
        c = int(grp_count[g])
        s0 = int(srs[lo])
        e0 = int(sre[lo])
        if s0 < row_lo or e0 > hi_cap:
            leftovers.extend(int(x) for x in order[lo:lo + c])
            continue
        placed = 0
        while placed < c:
            if cur_used >= TP or e0 - cur_start > seg_max:
                if ti + 1 >= T:
                    leftovers.extend(
                        int(x) for x in order[lo + placed:lo + c])
                    break
                ti += 1
                cur_start = max(min(s0, hi_cap - seg_max), row_lo)
                cur_used = 0
                t_start[ti] = cur_start - row_lo
            take = min(c - placed, TP - cur_used)
            spans.append((ti, cur_used, lo + placed, take))
            cur_used += take
            placed += take
    for tid, slot0, lo, cnt in spans:
        sel = order[lo:lo + cnt]
        t_sel[tid, slot0:slot0 + cnt] = sel
        tile_of[sel] = tid
        pos_of[sel] = np.arange(slot0, slot0 + cnt, dtype=np.int32)
    return t_sel, t_start, tile_of, pos_of, leftovers


class MatcherBusy(Exception):
    """The matcher cannot take this batch promptly (lock busy, or a cold
    shape); the caller serves the batch from the host trie."""

    def __init__(self, cold: bool = False):
        super().__init__("cold signature" if cold else "lock busy")
        self.cold = cold


class DeviceDegraded(Exception):
    """The device match path is unavailable; callers serve the batch from
    the exact host trie."""


class RebuildInProgress(Exception):
    """The device table is re-uploading after a capacity change; callers
    serve the publish from the host trie meanwhile."""


class GpuMatcher:
    """Device-resident subscription table plus batched matching.

    ``device`` defaults to the CUDA card and raises without one; pass
    ``device="cpu"`` to run the plain PyTorch path."""

    def __init__(self, max_levels: int = 16, initial_capacity: int = 1024,
                 max_fanout: int = 256, flat_avg: int = 128,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.table = SubscriptionTable(max_levels, initial_capacity)
        self.max_fanout = max_fanout
        # flat-compaction capacity per publish AVERAGED over the batch; a
        # batch whose total fanout exceeds it degrades per publish to the
        # host path, it never drops
        self.flat_avg = flat_avg
        self._dev_arrays: Optional[Tuple[torch.Tensor, ...]] = None
        self._operands: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
        self._ops_bits = 0
        self._reg_start: Optional[np.ndarray] = None
        self._reg_end: Optional[np.ndarray] = None
        self._glob_pad = 0
        self._gb_end = 0
        self._ng = 0
        self._bucketed = False
        self._entries_snapshot: Optional[np.ndarray] = None
        self.match_batches = 0
        self.match_publishes = 0
        self.host_fallbacks = 0  # publishes served by the exact host match
        # encode cache: hot topics skip per-word interner lookups;
        # invalidated when the interner or bucket layout changes
        self._enc_cache: Dict[Tuple[str, ...], int] = {}
        self._enc_rows = np.zeros((1024, self.table.L + 4), dtype=np.int32)
        self._enc_gen: Tuple[int, int] = (-1, -1)
        # guards table mutation vs sync/match
        self.lock = threading.Lock()
        # matches holding the device tensors outside the lock: while > 0,
        # sync() scatters into copies instead of in place
        self._inflight = 0

    # ------------------------------------------------------- full (re)build

    def _snapshot_host_locked(self) -> dict:
        """Everything a full device build needs, read from the live table
        (lock held; the build runs inline, so no copies)."""
        t = self.table
        entries = np.empty(len(t.entries), dtype=object)
        entries[:] = t.entries
        return {
            "words": t.words, "eff_len": t.eff_len,
            "has_hash": t.has_hash, "first_wild": t.first_wild,
            "active": t.active, "bits": t.id_bits,
            "reg_start": t.reg_start.copy(),
            "reg_end": (t.reg_start + t.reg_cap).copy(),
            "glob_pad": int(t.reg_cap[0]),
            "gb_end": t.gb_end if t.bucketed else int(t.reg_cap[0]),
            "ng": t.NG, "bucketed": t.bucketed, "entries": entries,
        }

    def _build_device(self, state: dict) -> tuple:
        """Upload a snapshot and derive the coded operands."""
        dev = tuple(torch.from_numpy(state[k]).to(self.device, copy=True)
                    for k in ("words", "eff_len", "has_hash", "first_wild",
                              "active"))
        operands = (K.build_operands(dev[0], dev[1], state["bits"])
                    if state["bits"] else None)
        return dev, operands

    def _install_built(self, built: tuple, state: dict) -> None:
        """Publish a finished build as the serving state (lock held)."""
        self._dev_arrays, self._operands = built
        self._ops_bits = state["bits"]
        self._reg_start = state["reg_start"]
        self._reg_end = state["reg_end"]
        self._glob_pad = state["glob_pad"]
        self._gb_end = state["gb_end"]
        self._ng = state["ng"]
        self._bucketed = state["bucketed"]
        self._entries_snapshot = state["entries"]

    # ------------------------------------------------------------ delta sync

    def sync(self) -> None:
        """Ship pending table mutations to the device: a full upload after
        a capacity or id-width change, an in-place scatter of the dirty
        rows otherwise. Also snapshots the slot→entry map, so a match
        resolves against the state it matched. Callers hold ``self.lock``."""
        t = self.table
        bits = t.id_bits
        if self._dev_arrays is None or t.resized or bits != self._ops_bits:
            state = self._snapshot_host_locked()
            self._install_built(self._build_device(state), state)
            t.resized = False
            t.dirty.clear()
            return
        if not t.dirty:
            return
        slots = np.fromiter(t.dirty, dtype=np.int64, count=len(t.dirty))
        t.dirty.clear()
        # copy-on-write: an in-flight match resolves against the previous
        # snapshot; mutating it would misroute a slot freed and reused
        snap = self._entries_snapshot.copy()
        for s in slots:
            snap[s] = t.entries[s]
        self._entries_snapshot = snap
        try:
            self._apply_delta_device(slots)
        except Exception:
            # the dirty set is consumed but the scatter did not land: the
            # next sync takes the full-rebuild path so host and device
            # re-converge
            t.resized = True
            raise
        # regions may move without a resize (relocation into the spare)
        self._reg_start = t.reg_start.copy()
        self._reg_end = (t.reg_start + t.reg_cap).copy()

    def _apply_delta_device(self, slots: np.ndarray) -> None:
        t = self.table
        dev = self.device
        put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        dev_arrays, operands = self._dev_arrays, self._operands
        if self._inflight:
            # a match outside the lock still reads the current tensors
            dev_arrays = tuple(a.clone() for a in dev_arrays)
            if operands is not None:
                operands = tuple(a.clone() for a in operands)
        K.apply_delta_fused_nometa(
            dev_arrays, operands, put(slots), put(t.words[slots]),
            put(t.eff_len[slots]), put(t.has_hash[slots]),
            put(t.first_wild[slots]), put(t.active[slots]),
            id_bits=self._ops_bits)
        self._dev_arrays, self._operands = dev_arrays, operands

    # ---------------------------------------------------------------- match

    def _pad_batch(self, n: int) -> int:
        b = 8
        while b < n:
            b *= 2
        return b

    def encode_batch(self, topics: Sequence[Sequence[str]]):
        B = self._pad_batch(len(topics))
        L = self.table.L
        pw = np.full((B, L), K.PAD_ID, dtype=np.int32)
        pl = np.zeros(B, dtype=np.int32)
        pd = np.zeros(B, dtype=bool)
        for i, t in enumerate(topics):
            row, n, dollar = self.table.encode_topic(t)
            pw[i], pl[i], pd[i] = row, n, dollar
        return pw, pl, pd

    def _encode_batch_ex(self, topics: Sequence[Sequence[str]]):
        """encode_batch + per-topic bucket ids (for the windowed path),
        through the hot-topic cache: one dict hit + one numpy gather per
        batch instead of per-topic row building."""
        t = self.table
        gen = (len(t.interner), t.NB)
        if self._enc_gen != gen:
            self._enc_cache.clear()
            self._enc_gen = gen
        cache = self._enc_cache
        rows = self._enc_rows
        L = t.L
        idxs = np.empty(len(topics), dtype=np.int32)
        for i, tp in enumerate(topics):
            tp = tuple(tp)
            j = cache.get(tp)
            if j is None:
                row, n, dollar, bucket, gbucket = t.encode_topic_ex(tp)
                j = len(cache)
                if j >= rows.shape[0]:
                    if j >= 1 << 20:  # bound memory on adversarial streams
                        cache.clear()
                        rows = np.zeros((1024, L + 4), dtype=np.int32)
                        self._enc_rows = rows
                        self._enc_gen = (-1, -1)
                        return self._encode_batch_ex(topics)
                    rows = np.vstack([rows, np.zeros_like(rows)])
                    self._enc_rows = rows
                rows[j, :L] = row
                rows[j, L] = n
                rows[j, L + 1] = dollar
                rows[j, L + 2] = bucket
                rows[j, L + 3] = gbucket
                cache[tp] = j
            idxs[i] = j
        B = self._pad_batch(len(topics))
        sel = rows[idxs]
        pw = np.full((B, L), K.PAD_ID, dtype=np.int32)
        pl = np.zeros(B, dtype=np.int32)
        pd = np.zeros(B, dtype=bool)
        pw[:len(topics)] = sel[:, :L]
        pl[:len(topics)] = sel[:, L]
        pd[:len(topics)] = sel[:, L + 1].astype(bool)
        pb = sel[:, L + 2].copy()
        gb = sel[:, L + 3].copy()
        return pw, pl, pd, pb, gb

    def match_batch(self, topics: Sequence[Sequence[str]]) -> List[List[Row]]:
        """Match a batch of publish topics; returns each topic's entry rows
        (the per-publish fold results)."""
        if not topics:
            return []
        with self.lock:
            self.sync()
            dev_arrays = self._dev_arrays
            operands = self._operands
            snapshot = self._entries_snapshot
            bucketed = self._bucketed and operands is not None
            if bucketed:
                reg_start, reg_end = self._reg_start, self._reg_end
                glob_pad, bits = self._glob_pad, self._ops_bits
                pw, pl, pd, pb, gb = self._encode_batch_ex(topics)
            else:
                pw, pl, pd = self.encode_batch(topics)
            self._inflight += 1
        try:
            self.match_batches += 1
            self.match_publishes += len(topics)
            if bucketed:
                idx_rows, need_host = self._match_windowed(
                    dev_arrays, operands, reg_start, reg_end, glob_pad, bits,
                    pw, pl, pd, pb, gb, len(topics))
            else:
                idx_rows, need_host = self._match_dense(
                    dev_arrays, pw, pl, pd, len(topics))
        finally:
            with self.lock:
                self._inflight -= 1
        return self._resolve_rows(topics, idx_rows, need_host, snapshot)

    def _match_dense(self, dev_arrays, pw, pl, pd, n):
        """Unbucketed (small) table: every publish against every row."""
        put = lambda a: torch.from_numpy(a).to(self.device)
        mask = K.match_mask_unrolled(*dev_arrays, put(pw), put(pl), put(pd))
        idx, valid, count = K.extract_indices(mask, self.max_fanout)
        idx, valid, count = idx.cpu().numpy(), valid.cpu().numpy(), \
            count.cpu().numpy()
        return ([idx[i][valid[i]] for i in range(n)],
                count[:n] > self.max_fanout)

    def _geometry(self, S, glob_pad, reg_start, reg_end, Bpad):
        """Kernel geometry for both probes at this batch size."""
        ng = self._ng
        gb_end = self._gb_end
        amax = (int((reg_end[1 + ng:] - reg_start[1 + ng:]).max())
                if len(reg_start) > 1 + ng else 0)
        T, seg_max, gc = window_params(S, glob_pad, amax, Bpad,
                                       zone=S - gb_end)
        if ng:
            gmax = int((reg_end[1:1 + ng] - reg_start[1:1 + ng]).max())
            T2, seg2, _ = window_params(S, glob_pad, gmax, Bpad,
                                        zone=gb_end - glob_pad)
        else:
            T2, seg2 = 1, 0
        return T, seg_max, gc, T2, seg2, gb_end

    def _flat_prep(self, reg_start, reg_end, glob_pad, bits, S,
                   pw, pl, pd, pb, gb, n):
        """Host prep for :func:`K.match_extract_windowed_flat`: geometry,
        selector tiles, per-publish tile coordinates, flat capacity.
        Returns ``(args, statics, left)``: the kernel's trailing positional
        arguments, its keyword arguments, and the publishes left to the
        host (window overflow)."""
        Bpad = pw.shape[0]
        T, seg_max, gc, T2, seg2, gb_end = self._geometry(
            S, glob_pad, reg_start, reg_end, Bpad)
        t_sel, t_start, tile_of, pos_of, leftovers = prepare_windows(
            pb, n, reg_start, reg_end, S, T, seg_max, row_lo=gb_end)
        t_start = t_start + gb_end  # starts are row_lo-relative
        a_tile = np.full(Bpad, -1, dtype=np.int32)
        a_pos = np.zeros(Bpad, dtype=np.int32)
        a_tile[:n] = tile_of
        a_pos[:n] = pos_of
        b_tile = np.full(Bpad, -1, dtype=np.int32)
        b_pos = np.zeros(Bpad, dtype=np.int32)
        if seg2:
            t2_sel, t2_start, tile2_of, pos2_of, left2 = prepare_windows(
                gb, n, reg_start, reg_end, S, T2, seg2, row_lo=glob_pad,
                row_hi=gb_end)
            t2_start = t2_start + glob_pad
            b_tile[:n] = tile2_of
            b_pos[:n] = pos2_of
        else:
            t2_sel = np.zeros((1, t_sel.shape[1]), np.int32)
            t2_start = np.zeros(1, np.int32)
            left2 = []
        args = (pw, pl, pd, np.int32(n), t_sel, t_start, t2_sel, t2_start,
                a_tile, a_pos, b_tile, b_pos)
        statics = dict(id_bits=bits, k=self.max_fanout, glob_pad=glob_pad,
                       seg_max=seg_max, seg2_max=seg2, gc=gc,
                       C=Bpad * self.flat_avg)
        return args, statics, set(leftovers) | set(left2)

    def _match_windowed(self, dev_arrays, operands, reg_start, reg_end,
                        glob_pad, bits, pw, pl, pd, pb, gb, n):
        """The windowed device path. Returns (per-publish slot id views,
        need_host bool array) in batch order; need_host marks publishes
        the device could not serve exactly."""
        F_t, t1 = operands
        S = int(F_t.shape[1])
        args, statics, left = self._flat_prep(
            reg_start, reg_end, glob_pad, bits, S, pw, pl, pd, pb, gb, n)
        dev = self.device
        put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        # the window starts (args[5], args[7]) stay on the host, where the
        # tile matcher checks their bounds without a device→host copy
        host = [put(a) for a in args[:3]] + [int(args[3]), put(args[4]),
                                            args[5], put(args[6]), args[7]] \
            + [put(a) for a in args[8:]]
        flat, pre, total, overflow = K.match_extract_windowed_flat(
            F_t, t1, *dev_arrays[1:], *host, **statics)
        C, B = flat.shape[0], pre.shape[0]
        out = torch.cat([flat, pre, total, overflow.to(torch.int32)]) \
            .cpu().numpy()  # one device→host copy
        flat, pre, total = out[:C], out[C:C + B], out[C + B:C + 2 * B]
        need_host = out[C + 2 * B:C + 2 * B + n].astype(bool)
        for i in left:
            need_host[i] = True
        # per-publish results are VIEWS into flat — no per-publish copies
        return [flat[pre[i]:pre[i] + total[i]] for i in range(n)], need_host

    def _resolve_rows(self, topics, idx_rows, need_host,
                      snapshot) -> List[List[Row]]:
        """Device slot ids → entry rows via the pinned snapshot, with the
        exact host match for publishes the device could not serve."""
        out: List[List[Row]] = []
        for i, topic in enumerate(topics):
            if need_host[i]:
                self.host_fallbacks += 1
                out.append(self._host_match(topic, snapshot))
                continue
            rows = [e for e in snapshot[idx_rows[i]] if e is not None]
            with self.lock:
                if len(self.table.overflow):
                    # >L-level filters live host-side; device rows stay
                    # valid for any topic length
                    rows = rows + self.table.overflow.match(list(topic))
            out.append(rows)
        return out

    def _host_match(self, topic: Sequence[str], snapshot=None) -> List[Row]:
        from ..protocol.topic import match_dollar_aware

        rows: List[Row] = []
        t = list(topic)
        with self.lock:
            entries = list(snapshot if snapshot is not None
                           else self.table.entries)
            overflow_rows = self.table.overflow.match(t)
        for e in entries:
            if e is not None and match_dollar_aware(t, list(e[0])):
                rows.append(e)
        rows.extend(overflow_rows)
        return rows


class GpuRegView:
    """Reg-view adapter over per-mountpoint :class:`GpuMatcher` s.

    ``registry`` provides ``fold_subscriptions(mountpoint)`` (an iterable
    of ``(filter_words, key, opts)``, the warm load) and
    ``trie(mountpoint)`` (the host trie that answers while the device
    cannot)."""

    def __init__(self, registry, max_levels: int = 16,
                 initial_capacity: int = 1024, max_fanout: int = 256,
                 flat_avg: int = 128, device: DeviceLike = None):
        self.registry = registry
        self.device = resolve_device(device)
        self._kw = dict(max_levels=max_levels,
                        initial_capacity=initial_capacity,
                        max_fanout=max_fanout, flat_avg=flat_avg,
                        device=self.device)
        self._matchers: Dict[str, GpuMatcher] = {}

    def matcher(self, mountpoint: str = "") -> GpuMatcher:
        """Get or create the mountpoint's matcher, warm-loaded from the
        registry's current subscriptions."""
        m = self._matchers.get(mountpoint)
        if m is None:
            m = GpuMatcher(**self._kw)
            with m.lock:
                for fw, key, opts in self.registry.fold_subscriptions(
                        mountpoint):
                    m.table.add(list(fw), key, opts)
            self._matchers[mountpoint] = m
        return m

    def on_delta(self, op: str, mountpoint: str, filter_words, key,
                 opts) -> None:
        """Subscription change feed from the registry."""
        m = self._matchers.get(mountpoint)
        if m is None:
            return  # warm-loaded on first use
        with m.lock:
            if op == "add":
                m.table.add(list(filter_words), key, opts)
            else:
                m.table.remove(list(filter_words), key)

    def fold(self, mountpoint: str, topic: Sequence[str]) -> List[Row]:
        """Single-topic fold (a batch of one); the host trie answers while
        the device path is rebuilding or degraded."""
        try:
            return self.matcher(mountpoint).match_batch([tuple(topic)])[0]
        except (RebuildInProgress, DeviceDegraded):
            return self.registry.trie(mountpoint).match(list(topic))

    def fold_batch(self, mountpoint: str,
                   topics: Sequence[Sequence[str]]) -> List[List[Row]]:
        return self.matcher(mountpoint).match_batch(topics)
