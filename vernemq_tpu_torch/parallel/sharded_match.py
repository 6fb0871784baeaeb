"""Sharded batched matching over a ``('batch', 'sub')`` mesh: the port of
``vernemq_tpu/parallel/sharded_match.py``.

Each grid device holds an ``S / n_sub`` slice of the subscription table
and matches the publish batch slice of its ``batch`` row. Where the
reference runs one ``shard_map`` program, the port runs the same program
once per grid entry, on that entry's device, and gathers on the host or on
the batch row's first device. Matched indices are globalised with the
shard offset so the host resolves them against the full entry list.

- :func:`build_sharded_matcher` / :class:`ShardedMatcher`: the level-wise
  compare of every shard row (plain PyTorch, as the reference's jnp; only
  tests call them).
- :func:`build_sharded_windowed` / :class:`ShardedWindowedMatcher`: the
  windowed production matcher per shard, through the hand kernels: the
  shard's column chunk of the replicated dense zone as one tile-kernel
  launch in dense mode, its probe-A tiles as a tile-kernel launch in shard
  mode (rows kept by their global index, ``ops/tile_match.py``), each part
  extracted by the extraction kernel (``ops/extract.py``), then the
  reference's per-shard flat compaction and, with ``merge``, the merge of a
  batch row's buffers on its first device.
- :class:`ShardedGpuMatcher`: the seat behind the reg-view seam, on
  :class:`~..models.matcher.GpuMatcher`'s machinery (lock, snapshot
  resolution, background rebuild, breaker, ``KernelError``).
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from ..broker import heap
from ..models.matcher import (TILE_PUBS, GpuMatcher, RebuildInProgress,
                              _pad_pub_block, _pow2ceil, prepare_windows)
from ..observability import histogram as obs
from ..observability.profiler import record_dispatch
from ..ops import match_kernel as K
from ..ops import tile_match as TM
from ..ops.extract import extract_rows
from ..robustness import faults
from ..robustness import watchdog as watchdog_mod
from .mesh import Mesh, make_shard_and_gather_fns, place_matcher_state


def _sharded(mesh: Mesh, named: dict, specs: dict) -> tuple:
    shard_fns, _ = make_shard_and_gather_fns(specs, mesh)
    return tuple(shard_fns[n](a) for n, a in named.items())


def build_sharded_matcher(mesh: Mesh, k: int):
    """Returns ``fn(sub_arrays..., pub_arrays...) -> (idx, valid, count)``
    over :func:`shard_table` / :func:`shard_pubs` placements. ``k`` is the
    per-shard fanout cap; the result carries ``k * n_sub`` candidate slots
    per publish (numpy), counts summed over the 'sub' axis."""
    nb, nsub = mesh.shape["batch"], mesh.shape["sub"]

    def fn(words, eff, hh, fw, act, pw, pl, pd):
        rows_idx, rows_valid, rows_total = [], [], []
        for b in range(nb):
            idxs, valids, total = [], [], 0
            for s in range(nsub):
                sw = words.data(b, s)
                s_local = sw.shape[0]
                mask = K.match_mask_unrolled(
                    sw, eff.data(b, s), hh.data(b, s), fw.data(b, s),
                    act.data(b, s), pw.data(b, s), pl.data(b, s),
                    pd.data(b, s))
                idx, valid, count = K.extract_indices(mask, min(k, s_local))
                idxs.append((idx + s * s_local).cpu().numpy())
                valids.append(valid.cpu().numpy())
                total = total + count.cpu().numpy()
            rows_idx.append(np.concatenate(idxs, axis=1))
            rows_valid.append(np.concatenate(valids, axis=1))
            rows_total.append(total)
        return (np.concatenate(rows_idx), np.concatenate(rows_valid),
                np.concatenate(rows_total))

    return fn


def shard_table(mesh: Mesh, words, eff_len, has_hash, first_wild, active):
    """Place numpy table mirrors on the mesh with 'sub' sharding. S must be
    a multiple of the 'sub' axis size."""
    named = dict(words=words, eff_len=eff_len, has_hash=has_hash,
                 first_wild=first_wild, active=active)
    specs = {n: ("sub", None) if n == "words" else ("sub",) for n in named}
    return _sharded(mesh, named, specs)


def shard_pubs(mesh: Mesh, pub_words, pub_len, pub_dollar):
    named = dict(pw=pub_words, pl=pub_len, pd=pub_dollar)
    specs = {n: ("batch", None) if n == "pw" else ("batch",) for n in named}
    return _sharded(mesh, named, specs)


class ShardedMatcher:
    """Multi-device wrapper around a SubscriptionTable: shards the table
    over the mesh, serves batched matches, re-shards on growth (mutations
    re-place the mirrors)."""

    def __init__(self, table, mesh: Mesh, max_fanout: int = 256):
        self.table = table
        self.mesh = mesh
        self.max_fanout = max_fanout
        self._dev = None
        self._fn = build_sharded_matcher(mesh, max_fanout)

    def sync(self) -> None:
        t = self.table
        if self._dev is None or t.resized or t.dirty:
            self._dev = shard_table(
                self.mesh, t.words, t.eff_len, t.has_hash, t.first_wild,
                t.active)
            t.resized = False
            t.dirty.clear()

    def match_batch(self, topics):
        if not topics:
            return []
        self.sync()
        nb = self.mesh.shape["batch"]
        B = max(nb, 1)
        while B < len(topics):
            B *= 2
        L = self.table.L
        pw = np.full((B, L), -2, dtype=np.int32)
        pl = np.zeros(B, dtype=np.int32)
        pd = np.zeros(B, dtype=bool)
        for i, t in enumerate(topics):
            row, n, dollar = self.table.encode_topic(t)
            pw[i], pl[i], pd[i] = row, n, dollar
        idx, valid, count = self._fn(*self._dev,
                                     *shard_pubs(self.mesh, pw, pl, pd))
        out = []
        for i, topic in enumerate(topics):
            rows = _resolve(self.table, idx[i][valid[i]])
            if count[i] > int(valid[i].sum()):
                # per-shard top-k truncated this row: recover exactly on
                # the host so no subscriber is silently skipped
                rows = self._host_match(topic)
            elif len(self.table.overflow):
                rows = rows + self.table.overflow.match(list(topic))
            out.append(rows)
        return out

    def _host_match(self, topic):
        return host_match(self.table, topic)


def _resolve(table, slots):
    """Matched slot indices → (filter, key, value) rows (the reference
    table's ``resolve``)."""
    return [e for e in (table.entries[s] for s in slots) if e is not None]


def host_match(table, topic):
    """Exact host-side fallback over a snapshot of the entry list (slow
    path for truncated/leftover publishes; snapshot so concurrent mutation
    from the event loop can't skip entries mid-scan)."""
    from ..protocol.topic import match_dollar_aware

    t = list(topic)
    entries = list(table.entries)
    rows = [
        e for e in entries
        if e is not None and match_dollar_aware(t, list(e[0]))
    ]
    rows.extend(table.overflow.match(t))
    return rows


# ---------------------------------------------------------------------------
# The windowed production matcher per shard
# ---------------------------------------------------------------------------

#: calls of the dense-mode and shard-mode tile launches and the extraction
#: launches made by :func:`build_sharded_windowed`'s programs, per grid
#: entry ``(b, s)`` (CUDA tensors only, as the wrappers count; reset it to
#: read one run's counts)
shard_launches: dict = {}


def _count(coords, **launched) -> None:
    c = shard_launches.setdefault(coords, {"tile": 0, "dense": 0,
                                           "extract": 0})
    for what, n in launched.items():
        c[what] += n


def build_sharded_windowed(mesh: Mesh, *, id_bits: int, k: int,
                           glob_pad: int, seg_max: int, gc: int, T: int,
                           Sl: int, Cl: int, with_total: bool = False,
                           merge: bool = False):
    """The flat windowed production matcher on a ``('batch', 'sub')``
    mesh: the multi-device form of
    :func:`ops.match_kernel.match_extract_windowed_flat`.

    The coded operand matrix is column-sharded over 'sub' (each device owns
    ``Sl`` contiguous table rows); the publish batch over 'batch'. The
    dense zone (region 0 + the level-1 g-buckets, ``glob_pad`` rows)
    travels replicated and each 'sub' shard matches its column chunk
    ``[sidx·GW, (sidx+1)·GW)``, so no work is duplicated. Probe-A tiles are
    per (batch, sub) device: ``[nb, nsub, T, TP]`` selectors into the
    device's local publish slice, windows at shard-local starts, rows kept
    by their global index only. Each device flat-compacts its own matches
    (dense chunk, then its probe tiles, each clipped at ``k``) into a
    ``[Cl]`` buffer with per-publish prefix ranges, exactly like the
    single-device path. ``gc`` (the reference's publish chunk of the dense
    product) is unused: the kernel never forms that product.

    Returns ``fn(*state12, pw, pl, pd, real, t_sel, t_start, a_tile,
    a_pos)`` over the :func:`~.mesh.place_matcher_state` arrays and host
    (numpy) publish arrays; ``a_tile`` / ``a_pos`` are ``[nsub, Bpad]``:
    publish i's tile and slot among shard s's tiles (-1: none there), so a
    publish may be probed on several shards (:meth:`ShardedWindowedMatcher.
    _prep_encoded`). It returns ``(flat, pre, cnt, ovf)`` as tensors
    on the devices, unpulled (:meth:`ShardedWindowedMatcher._pull` brings
    them to the host): with ``merge`` a list over batch rows of ``[Cl]`` /
    ``[Bl]`` tensors on each row's first device, else a list over batch
    rows of lists over 'sub' shards; ``with_total`` adds the total match
    count of the batch (summed over every shard, and over the processes of
    the ``torch.distributed`` process group when one is up)."""
    nb, nsub = mesh.shape["batch"], mesh.shape["sub"]
    GW = glob_pad // nsub
    if glob_pad % nsub or seg_max > Sl or GW % TM.ROW_CHUNK:
        raise TM.KernelInputError(
            f"sharded matcher: a dense zone of {glob_pad} rows does not "
            f"split into {nsub} chunks of a multiple of {TM.ROW_CHUNK} "
            f"rows, or the window {seg_max} exceeds the {Sl}-row shard")
    del gc, T

    def fn(F_sh, t1_sh, eff_sh, hh_sh, fw_sh, act_sh,
           Fg, t1g, effg, hhg, fwg, actg,
           pw, pl, pd, real, t_sel, t_start, a_tile, a_pos):
        Bl = pw.shape[0] // nb
        pubs = {}  # (device, batch row) -> uploaded operands, shared
        results = []
        for b in range(nb):
            lo = b * Bl
            row = []
            for s in range(nsub):
                dev = mesh.device(b, s)
                key = (dev, b)
                if key not in pubs:
                    put = lambda a: torch.from_numpy(
                        np.ascontiguousarray(a[lo:lo + Bl])).to(dev)
                    pwd = put(pw)
                    pubs[key] = (K.build_pub_operand(pwd, id_bits), put(pl),
                                 put(pd).to(torch.int32), put(real))
                G, pld, pdd, reald = pubs[key]
                cuda = dev.type == "cuda"
                # dense phase: this shard's column chunk of the zone
                goff = s * GW
                g_flags = TM.row_flags(hhg.data(b, s), fwg.data(b, s),
                                       actg.data(b, s))
                packed = TM.dense_tiles_packed(
                    Fg.data(b, s), t1g.data(b, s), effg.data(b, s), g_flags,
                    G, pld, pdd, glob_pad=glob_pad, seg=GW, start=goff)
                gidx, gvalid, gcount = extract_rows(packed, k)
                g = (gidx + goff, gvalid, gcount)
                if cuda:
                    _count((b, s), dense=1, extract=1)
                # probe-A tiles against this shard's rows
                ok = (a_tile[s, lo:lo + Bl] >= 0) & real[lo:lo + Bl]
                if ok.any():
                    tile = torch.from_numpy(np.where(
                        ok, a_tile[s, lo:lo + Bl], -1).astype(np.int32)
                    ).to(dev)
                    pos = torch.from_numpy(np.ascontiguousarray(
                        a_pos[s, lo:lo + Bl])).to(dev)
                    sel = torch.from_numpy(np.ascontiguousarray(
                        t_sel[b, s])).to(dev)
                    a = TM._probe_tiles(
                        F_sh.data(b, s), t1_sh.data(b, s), eff_sh.data(b, s),
                        TM.row_flags(hh_sh.data(b, s), fw_sh.data(b, s),
                                     act_sh.data(b, s)),
                        G, pld, pdd, sel, t_start[b, s], tile, pos, k=k,
                        seg_max=seg_max, glob_pad=glob_pad, mode="shard",
                        row_base=s * Sl)
                    if cuda:
                        _count((b, s), tile=1, extract=1)
                else:  # no publish of this row lives on this shard
                    a = (torch.zeros((Bl, k), dtype=torch.int32, device=dev),
                         torch.zeros((Bl, k), dtype=torch.bool, device=dev),
                         torch.zeros(Bl, dtype=torch.int32, device=dev))
                # flat compaction (the single-device contract, per shard)
                row.append(K._flat_combine(reald, k, Cl, g, a))
            results.append(row)
        total = None
        if with_total:
            total = sum(int(r[2].sum()) for row in results for r in row)
            total = _all_reduce_sum(total)
        if merge:
            rows = [_merge_row(row, mesh.device(b, 0), k, Cl,
                               pubs[(mesh.device(b, 0), b)][3])
                    for b, row in enumerate(results)]
            res = tuple([r[i] for r in rows] for i in range(4))
        else:
            res = tuple([[r[i] for r in row] for row in results]
                        for i in range(4))
        return res + (total,) if with_total else res

    return fn


def _all_reduce_sum(total: int) -> int:
    """``total`` summed over the default process group's processes (itself
    without one): the reference's ``psum`` over the mesh."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return total
    dev = "cuda" if dist.get_backend() == "nccl" else "cpu"
    t = torch.tensor([total], dtype=torch.int64, device=dev)
    dist.all_reduce(t)
    return int(t.item())


def _merge_row(row, dev, k: int, Cl: int, real) -> tuple:
    """Merge one batch row's per-shard ``(flat, pre, cnt, ovf)`` on the
    row's first device ``dev`` (the reference's ``all_gather`` over 'sub'):
    publish i's ranges of every shard, in shard order, land in one ``[Cl]``
    buffer. A shard's range may hold up to 2k entries (dense chunk and
    probe each up to k), so the copy window spans 2k; entries past ``Cl``
    are dropped and flag overflow."""
    g_flat = torch.stack([r[0].to(dev) for r in row])        # [nsub, Cl]
    g_pre = torch.stack([r[1].to(dev) for r in row])          # [nsub, Bl]
    g_cnt = torch.stack([r[2].to(dev) for r in row])
    g_ovf = torch.stack([r[3].to(dev) for r in row])
    before = g_cnt.cumsum(0, dtype=torch.int32) - g_cnt       # [nsub, Bl]
    mcnt = g_cnt.sum(0, dtype=torch.int32)                    # [Bl]
    mpre = mcnt.cumsum(0, dtype=torch.int32) - mcnt
    mflat = torch.zeros(Cl + 1, dtype=torch.int32, device=dev)
    jk2 = torch.arange(2 * k, dtype=torch.int32, device=dev)[None, :]
    for s_i in range(g_flat.shape[0]):
        src = g_pre[s_i][:, None] + jk2                        # [Bl, 2k]
        vals = g_flat[s_i].index_select(
            0, src.clamp(max=Cl - 1).reshape(-1).long())
        pos = (mpre + before[s_i])[:, None] + jk2
        ok = (jk2 < g_cnt[s_i][:, None]) & real[:, None] & (pos < Cl)
        mflat.scatter_(0, torch.where(ok, pos, Cl).reshape(-1).long(), vals)
    movf = (g_ovf.any(0) | (mpre + mcnt > Cl)) & real
    return mflat[:Cl], mpre, mcnt, movf


class ShardedWindowedMatcher:
    """Multi-device windowed matcher over a SubscriptionTable: the
    production (bucketed/windowed) path sharded on a ``('batch', 'sub')``
    mesh. Host prep assigns each publish to the 'sub' shard owning its
    bucket's rows; publishes in buckets straddling a shard cut (or
    overflowing their shard's tile slots) fall back to exact host
    matching."""

    def __init__(self, table, mesh: Mesh, max_fanout: int = 128,
                 with_total: bool = False, flat_avg: int = 128,
                 merge: bool = False):
        self.table = table
        self.mesh = mesh
        self.nsub = mesh.shape["sub"]
        self.nb = mesh.shape["batch"]
        self.max_fanout = max_fanout
        self.with_total = with_total
        self.flat_avg = flat_avg
        #: merge results across 'sub' on the batch row's first device: the
        #: host pulls ONE buffer per batch row instead of nsub
        self.merge = merge
        self._dev = None
        self._geom = None

    def _place(self, words, eff, hh, fw, act, bits: int, glob: int) -> tuple:
        """The coded operands built on this process's first mesh device,
        then placed through the partition rules (the 12 arrays)."""
        dev = self.mesh.first_device
        put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        F_t, t1 = K.build_operands(put(words), put(eff), bits)
        return place_matcher_state(self.mesh, F_t, t1, put(eff), put(hh),
                                   put(fw), put(act), glob)

    def sync(self) -> None:
        t = self.table
        self._reg_start = t.reg_start.copy()
        self._reg_end = (t.reg_start + t.reg_cap).copy()
        if self._dev is not None and not t.resized and not t.dirty:
            return
        if self._dev is not None and not t.resized:
            self._sync_delta()
            return
        assert t.bucketed and t.id_bits, \
            "windowed sharding needs a bucketed table"
        S = t.cap
        assert S % self.nsub == 0
        if S // self.nsub < 4096:
            raise ValueError(
                f"table of {S} rows is too small for a {self.nsub}-way "
                f"'sub' axis (each shard needs >= 4096 rows)")
        # the dense phase covers the whole g-zone (region 0 + level-1
        # g-buckets): the sharded path keeps one dense probe
        glob = t.gb_end
        self._dev = self._place(t.words, t.eff_len, t.has_hash,
                                t.first_wild, t.active, t.id_bits, glob)
        self._glob = glob
        self._S = S
        self._bits = t.id_bits
        t.resized = False
        t.dirty.clear()

    def _sync_delta(self, donate: bool = True) -> None:
        """Scatter the dirty slots into every shard's state: the shard's
        own rows and its g-zone mirror (:func:`K.apply_delta_windowed_fused`,
        in place), or into copies with ``donate=False`` while a dispatched
        match still reads the tensors (the seat's in-flight guard)."""
        t = self.table
        slots = np.fromiter(t.dirty, dtype=np.int64, count=len(t.dirty))
        t.dirty.clear()
        if len(slots) == 0:
            return
        rows = (t.words[slots], t.eff_len[slots], t.has_hash[slots],
                t.first_wild[slots], t.active[slots])
        Sl = self._S // self.nsub
        new = [dict() for _ in self._dev]
        for sh in self._dev[0].addressable_shards:
            b, s = sh.coords
            state = tuple(a.data(b, s) for a in self._dev)
            out = K.apply_delta_windowed_fused(
                state, slots, *rows, id_bits=self._bits, glob=self._glob,
                row_lo=s * Sl, copy=not donate)
            for i, (old, t_new) in enumerate(zip(state, out)):
                if t_new is not old:
                    new[i][(b, s)] = t_new
        self._dev = tuple(a.replace(d) if d else a
                          for a, d in zip(self._dev, new))

    def _fn_for(self, Bpad: int, T: int, seg_max: int, gc: int, Cl: int,
                glob: Optional[int] = None, S: Optional[int] = None,
                bits: Optional[int] = None):
        """The per-shard program for a geometry; callers racing a
        background rebuild pass the glob/S/bits their prep was taken
        against. (Nothing is compiled: the program is built per call.)"""
        glob = self._glob if glob is None else glob
        S = self._S if S is None else S
        bits = self._bits if bits is None else bits
        return build_sharded_windowed(
            self.mesh, id_bits=bits, k=self.max_fanout, glob_pad=glob,
            seg_max=seg_max, gc=gc, T=T, Sl=S // self.nsub, Cl=Cl,
            with_total=self.with_total, merge=self.merge)

    def _prep(self, topics):
        """Host-side prep of one batch against the CURRENT table/window
        state: encode, per-shard publish assignment, window tiles."""
        n = len(topics)
        nb = self.nb
        # batch padding: divisible by the batch axis, on a pow2 ladder
        Bpad = nb
        while Bpad < n:
            Bpad *= 2
        Bpad = max(Bpad, 8 * nb)
        L = self.table.L
        pw = np.full((Bpad, L), np.int32(K.PAD_ID), dtype=np.int32)
        pl = np.zeros(Bpad, dtype=np.int32)
        pd = np.zeros(Bpad, dtype=bool)
        pb = np.zeros(n, dtype=np.int32)
        for i, topic in enumerate(topics):
            row, ln, dollar, bucket, _gb = self.table.encode_topic_ex(topic)
            pw[i], pl[i], pd[i], pb[i] = row, ln, dollar, bucket
        return self._prep_encoded(pw, pl, pd, pb, n)

    def _pin_state(self) -> dict:
        """Pin every live field the window prep reads, under the caller's
        lock, so the prep itself can run after release against a
        consistent view."""
        return {"S": self._S, "glob": self._glob, "bits": self._bits,
                "dev": self._dev, "reg_start": self._reg_start,
                "reg_end": self._reg_end, "ng": self.table.NG}

    def _prep_encoded(self, pw, pl, pd, pb, n: int, pinned=None):
        """Window/tile prep for an already-encoded padded batch (pw [Bpad,
        L]; pb holds the n real publishes' buckets). Bpad must be
        divisible by the 'batch' axis. ``pinned`` (a :meth:`_pin_state`
        snapshot) lets callers run this outside their lock."""
        st = pinned or self._pin_state()
        S, glob, nsub = st["S"], st["glob"], self.nsub
        nb = self.nb
        Sl = S // nsub
        Bpad = pw.shape[0]
        assert Bpad % nb == 0, \
            f"Bpad {Bpad} not divisible by the batch axis {nb}"
        Bl = Bpad // nb  # local publish slice per batch row
        real = np.zeros(Bpad, dtype=bool)
        real[:n] = True
        # per-shard publish assignment by bucket-row ownership (pads: -1)
        shard_of = np.full(Bpad, -1, dtype=np.int32)
        reg_start, reg_end = st["reg_start"], st["reg_end"]
        shard_of[:n] = np.minimum(reg_start[pb] // Sl, nsub - 1)
        slot_tiles = max(1, -(-Bl // TILE_PUBS))
        # level-0 buckets only: the g-zone (regions 1..NG) is matched
        # densely here and must not inflate the window size
        ng = st["ng"]
        bucket_max = (int((reg_end[1 + ng:] - reg_start[1 + ng:]).max())
                      if len(reg_start) > 1 + ng else 0)
        # window: a multiple of 2048 rows that fits the shard slice
        sl_cap = Sl - Sl % 2048
        seg_max = min(_pow2ceil(max(4096, bucket_max, 2 * Sl // slot_tiles)),
                      sl_cap)
        # span budget: tiles close on window overflow even with free slots
        T = slot_tiles + -(-Sl // seg_max) + 2
        gc = min(Bl, 1024)
        Cl = Bl * self.flat_avg
        TP = TILE_PUBS
        tiles = {}  # (batch row, shard) -> [(t_sel, t_start), ...]
        a_tile = np.full((nsub, Bpad), -1, dtype=np.int32)
        a_pos = np.zeros((nsub, Bpad), dtype=np.int32)
        leftovers = set()
        for r in range(nb):
            lo = r * Bl
            sor = shard_of[lo:lo + Bl]
            for s in range(nsub):
                mine = np.nonzero(sor == s)[0]  # row-local indices
                if len(mine) == 0:
                    continue
                sel = lo + mine
                tsc, tss, tof, pof, left = prepare_windows(
                    pb[sel], len(mine), reg_start, reg_end, S, T, seg_max,
                    row_lo=s * Sl, row_hi=(s + 1) * Sl)
                # map compact-space selectors back to row-local indices
                tiles[r, s] = [(mine[tsc], tss)]
                placed = tof >= 0
                a_tile[s, sel[placed]] = tof[placed]
                a_pos[s, sel[placed]] = pof[placed]
                for li in left:
                    leftovers.add(int(sel[li]))
            leftovers -= self._split_straddlers(
                r, Bl, leftovers, pb, reg_start, reg_end, S, Sl, T, seg_max,
                tiles, a_tile, a_pos)
        T = max([T] + [sum(len(x[1]) for x in v) for v in tiles.values()])
        t_sel = np.zeros((nb, nsub, T, TP), dtype=np.int32)
        t_start = np.zeros((nb, nsub, T), dtype=np.int32)
        for (r, s), parts in tiles.items():
            sel = np.concatenate([x[0] for x in parts])
            st_ = np.concatenate([x[1] for x in parts])
            t_sel[r, s, :len(st_)] = sel
            t_start[r, s, :len(st_)] = st_
        return {
            "geom": (Bpad, T, seg_max, gc, Cl),
            "glob": glob, "S": S, "bits": st["bits"], "Bl": Bl,
            "dev": st["dev"], "leftovers": leftovers,
            "args": (pw, pl, pd, real, t_sel, t_start, a_tile, a_pos),
        }

    def _split_straddlers(self, r, Bl, leftovers, pb, reg_start, reg_end,
                          S, Sl, T, seg_max, tiles, a_tile, a_pos) -> set:
        """Departure from the reference, which serves on the host every
        publish whose bucket region straddles a shard cut (a leftover of
        its shard's window prep): such a publish is probed on every shard
        its region overlaps, against that shard's piece of the region, in
        tiles appended after the shard's own ``T``. Its matches are the
        region's rows, so its pieces' ids, in shard order, are its device
        rows. The other publishes keep the reference's tiles, ids and
        flags. Returns the batch row's straddlers that every piece placed
        (no longer leftovers); one with a piece longer than a window, or
        a piece the tiles could not place, stays a leftover with no tile
        anywhere."""
        lo = r * Bl
        mine = np.array(sorted(i for i in leftovers if lo <= i < lo + Bl),
                        dtype=np.int64)
        if len(mine) == 0:
            return set()
        first = np.minimum(reg_start[pb[mine]] // Sl, self.nsub - 1)
        rend = reg_end[pb[mine]]
        strad = mine[(rend > (first + 1) * Sl) & (rend <= S)]
        pieces, host = [], set()
        for s in range(self.nsub):
            # the regions clipped to this shard: windows cover the piece
            cs = np.clip(reg_start, s * Sl, (s + 1) * Sl)
            ce = np.clip(reg_end, s * Sl, (s + 1) * Sl)
            size = ce[pb[strad]] - cs[pb[strad]]
            host.update(strad[size > seg_max].tolist())
            pieces.append((s, strad[size > 0], cs, ce))
        placed = {int(i): True for i in strad if int(i) not in host}
        for s, on, cs, ce in pieces:
            on = np.array([i for i in on if int(i) in placed], np.int64)
            if len(on) == 0:
                continue
            Tx = len(np.unique(cs[pb[on]])) + -(-len(on) // TILE_PUBS)
            tsc, tss, tof, pof, _ = prepare_windows(
                pb[on], len(on), cs, ce, S, Tx, seg_max, row_lo=s * Sl,
                row_hi=(s + 1) * Sl)
            parts = tiles.setdefault(
                (r, s), [(np.zeros((T, TILE_PUBS), np.int64),
                          np.zeros(T, np.int32))])
            base = sum(len(x[1]) for x in parts)
            parts.append(((on - lo)[tsc], tss))
            ok = tof >= 0
            a_tile[s, on[ok]] = tof[ok] + base
            a_pos[s, on[ok]] = pof[ok]
            for i in on[~ok]:
                placed[int(i)] = False
        for i in strad:
            if not placed.get(int(i)):
                a_tile[:, i] = -1  # host-served: it takes no flat capacity
        return {i for i, ok in placed.items() if ok}

    def _dispatch_device(self, p):
        """Launch the device half of a prepped batch WITHOUT pulling the
        results: a caller can launch several prepped batches back to back
        (the card queues them) and only then pull."""
        faults.inject("device.dispatch")
        fn = self._fn_for(*p["geom"], glob=p["glob"], S=p["S"],
                          bits=p["bits"])
        return fn(*p["dev"], *p["args"])

    @staticmethod
    def _to_host(x) -> np.ndarray:
        if isinstance(x, list):
            return np.stack([ShardedWindowedMatcher._to_host(y) for y in x])
        return x.cpu().numpy()

    def _pull(self, res):
        return tuple(self._to_host(x) for x in res[:4])

    def _dispatch(self, p):
        """Run the device half of a prepped batch. Returns numpy arrays;
        the layout depends on ``self.merge``: unmerged flat [nb, nsub,
        Cl], pre/cnt/ovf [nb, nsub, Bl]; merged flat [nb, Cl], pre/cnt/ovf
        [nb, Bl]. Consumers go through :meth:`slots_for` /
        :meth:`_overflowed`."""
        return self._pull(self._dispatch_device(p))

    def slots_for(self, i, flat, pre, cnt, Bl):
        """Device-result slot ids for publish ``i`` under the configured
        result layout (merged: ONE contiguous range per publish; unmerged:
        one range per 'sub' shard)."""
        r, j = divmod(i, Bl)
        if self.merge:
            return flat[r, pre[r, j]:pre[r, j] + cnt[r, j]]
        return np.concatenate(
            [flat[r, s, pre[r, s, j]:pre[r, s, j] + cnt[r, s, j]]
             for s in range(self.nsub)])

    def _overflowed(self, i, ovf, Bl):
        r, j = divmod(i, Bl)
        return bool(ovf[r, j] if self.merge else ovf[r, :, j].any())

    def match_batch(self, topics):
        if not topics:
            return []
        self.sync()
        p = self._prep(topics)
        flat, pre, cnt, ovf = self._dispatch(p)
        Bl, leftovers = p["Bl"], p["leftovers"]
        out = []
        for i, topic in enumerate(topics):
            if i in leftovers or self._overflowed(i, ovf, Bl):
                out.append(self._host_match(topic))
                continue
            rows = _resolve(self.table, self.slots_for(i, flat, pre, cnt, Bl))
            if len(self.table.overflow):
                rows = rows + self.table.overflow.match(list(topic))
            out.append(rows)
        return out

    def _host_match(self, topic):
        return host_match(self.table, topic)


# ---------------------------------------------------------------------------
# The production seat: a GpuMatcher over the sharded matcher
# ---------------------------------------------------------------------------


class ShardedGpuMatcher(GpuMatcher):
    """The multi-device seat behind the reg-view seam: the trie replica
    sharded as row slices on a ``('batch', 'sub')`` mesh (the reference's
    ``ShardedTpuMatcher``).

    It keeps :class:`GpuMatcher`'s discipline — the mutation lock,
    entries-snapshot resolution, background growth rebuilds shed as
    :class:`RebuildInProgress`, the breaker, the watchdog hooks, and a CUDA
    fault raised as ``KernelError`` — and swaps the device half for
    :class:`ShardedWindowedMatcher`. ``GpuRegView`` builds it with a
    ``tpu_mesh`` and ``tpu_mesh_native=false``. The reference's cold
    compile gate and warm ladders have no counterpart (nothing compiles
    per shape)."""

    def __init__(self, mesh: Mesh, max_levels: int = 16,
                 initial_capacity: int = 1024, max_fanout: int = 128,
                 flat_avg: int = 128, **_ignored):
        nsub = mesh.shape["sub"]
        # every 'sub' shard needs >= 4096 rows (window-geometry floor) and
        # S must divide over the axis: pre-size the table accordingly —
        # growth doubles, so the invariant holds for life
        cap = max(initial_capacity, 4096 * nsub, 32768)
        super().__init__(max_levels=max_levels, initial_capacity=cap,
                         max_fanout=max_fanout, flat_avg=flat_avg,
                         device=mesh.first_device)
        self.mesh = mesh
        # merge=True: the production posture — results merged across the
        # 'sub' axis on each batch row's first device, one pull per row
        self._swm = ShardedWindowedMatcher(
            self.table, mesh, max_fanout=max_fanout, flat_avg=flat_avg,
            merge=True)

    # ------------------------------------------------------------- building

    def _build_device(self, state: dict) -> tuple:
        """Sharded device build from a host snapshot (no lock held): the
        coded operands column-sharded over 'sub', the dense g-zone
        replicated, from a pinned snapshot so the background rebuild can
        run it on a worker thread."""
        if not (state["bucketed"] and state["bits"]):
            raise ValueError("sharded windowed matcher needs a bucketed "
                             "table with codable ids")
        S = state["words"].shape[0]
        nsub = self.mesh.shape["sub"]
        if S % nsub != 0 or S // nsub < 4096:
            raise ValueError(
                f"table of {S} rows cannot shard over a {nsub}-way 'sub' "
                f"axis (needs S % {nsub} == 0 and >= 4096 rows/shard)")
        glob = state["gb_end"]
        dev = self._swm._place(state["words"], state["eff_len"],
                               state["has_hash"], state["first_wild"],
                               state["active"], state["bits"], glob)
        self._sync_mesh_devices()
        return (dev, S, glob)

    def _sync_mesh_devices(self) -> None:
        """Wait for this process's mesh devices (a build handed to
        :meth:`_install_built` is complete)."""
        for d in {md.device for md in self.mesh.devices.flat}:
            if d.type == "cuda":
                torch.cuda.current_stream(d).synchronize()

    def _install_built(self, built: tuple, state: dict) -> None:
        dev, S, glob = built
        sw = self._swm
        sw._dev = dev
        sw._S = S
        sw._glob = glob
        sw._bits = state["bits"]
        sw._reg_start = state["reg_start"]
        sw._reg_end = state["reg_end"]
        # the base-class bookkeeping the shared machinery reads
        self._dev_arrays = dev
        self._operands = None
        self._ops_bits = state["bits"]
        self._reg_start = state["reg_start"]
        self._reg_end = state["reg_end"]
        self._glob_pad = state["glob_pad"]
        self._gb_end = state["gb_end"]
        self._ng = state["ng"]
        self._bucketed = state["bucketed"]
        self._entries_snapshot = state["entries"]

    # ----------------------------------------------------------------- sync

    def sync(self) -> None:
        """Full sharded build on growth (in the background when enabled,
        with the same RebuildInProgress shed as the single-device seat),
        the sharded delta scatter otherwise. Callers hold ``self.lock``."""
        t = self.table
        if self._cuda_fault is not None:
            raise TM.KernelError(
                f"CUDA fault on the device path: {self._cuda_fault}") \
                from self._cuda_fault
        if self._rebuild_thread is not None:
            tok = self._rebuild_token
            abandoned = tok is not None and tok.get("abandoned")
            if self._rebuild_thread.is_alive() and not abandoned:
                raise RebuildInProgress
            # crashed, or abandoned by the watchdog: re-arm (a late
            # install discards against its token)
            self._rebuild_thread = None
            t.resized = True
        if self._dev_arrays is None or t.resized \
                or t.id_bits != self._ops_bits:
            if self._dev_arrays is not None and self.async_rebuild:
                self._spawn_rebuild_locked()
                raise RebuildInProgress
            state = self._snapshot_host_locked(copy=False, clear=False)
            self._install_built(self._build_device(state), state)
            t.resized = False
            t.dirty.clear()
            if self.warm_ms is None:
                self._warm_locked()
                heap.POLICY.settled(f"the first build of {t.count} rows")
            return
        sw = self._swm
        if t.dirty:
            # copy-on-write entries snapshot: in-flight resolutions keep
            # the state their device call actually matched
            snap = self._entries_snapshot.copy()
            for s in t.dirty:
                snap[s] = t.entries[s]
            self._entries_snapshot = snap
            try:
                faults.inject("device.delta")
                # in place only while NO dispatched match reads the
                # tensors; otherwise the scatter updates copies
                sw._sync_delta(donate=self._inflight == 0)
            except Exception:
                # the scatter didn't land but the dirty set is consumed:
                # force a full rebuild so host and device re-converge
                t.resized = True
                raise
            self._dev_arrays = sw._dev
        # bucket relocation (spare tail) moves regions without a resize
        self._reg_start = sw._reg_start = t.reg_start.copy()
        self._reg_end = sw._reg_end = (t.reg_start + t.reg_cap).copy()

    def _warm_locked(self) -> None:
        """After the first build (lock held), one dispatch on the card with
        its results discarded: CUDA loads each kernel's module at its first
        launch, and a fresh process's first flush would otherwise pay for
        it. Records ``warm_ms``."""
        t0 = time.monotonic()
        if any(md.device.type == "cuda" for md in self.mesh.devices.flat):
            sw = self._swm
            p = sw._prep_encoded(*self._encode_batch_ex([("$warm",)])[:4], 1)
            res = sw._fn_for(*p["geom"])(*p["dev"], *p["args"])
            ShardedWindowedMatcher._pull(sw, res)
        self.warm_ms = (time.monotonic() - t0) * 1e3

    # ---------------------------------------------------------------- match

    def _match_batch_impl(self, topics, lock_timeout):
        self._acquire(lock_timeout)
        try:
            self._sync_for_match()
            sw = self._swm
            snapshot = self._entries_snapshot
            # cached encoder + window prep, on a consistent table view
            pw, pl, pd, pb, _gb = self._encode_batch_ex(topics)
            p = sw._prep_encoded(pw, pl, pd, pb, len(topics))
            self._inflight += 1
        finally:
            self.lock.release()
        self.match_batches += 1
        self.match_publishes += len(topics)
        t_disp = time.monotonic()
        try:
            pulled = sw._dispatch(p)
        except TM.KernelError:
            raise
        except Exception as e:
            self._record_device_failure(e)
        else:
            self._record_device_success()
            if not watchdog_mod.current_op_abandoned():
                dur = (time.monotonic() - t_disp) * 1e3
                obs.observe("stage_device_dispatch_ms", dur)
                record_dispatch("match", t_disp, dur, k=1,
                                batch=len(topics), bpad=int(pw.shape[0]))
        finally:
            with self.lock:
                self._inflight -= 1
        return self._resolve_sharded(topics, p, pulled, snapshot)

    def _resolve_sharded(self, topics, p, pulled, snapshot):
        """Result resolution for one pulled sharded batch (shared by
        match_batch and the pipelined match_many)."""
        sw = self._swm
        flat, pre, cnt, ovf = pulled
        Bl, leftovers = p["Bl"], p["leftovers"]
        out = []
        for i, topic in enumerate(topics):
            if i in leftovers or sw._overflowed(i, ovf, Bl):
                self.host_fallbacks += 1
                out.append(self._host_match(topic, snapshot))
                continue
            rows = [e for e in
                    snapshot[sw.slots_for(i, flat, pre, cnt, Bl)]
                    if e is not None]
            with self.lock:
                if len(self.table.overflow):
                    rows = rows + self.table.overflow.match(list(topic))
            out.append(rows)
        return out

    def _match_many_impl(self, batches, lock_timeout):
        """The K-batch pipeline: every batch is encoded against ONE
        consistent table snapshot (one lock hold, one sync), then every
        batch is launched before any result is pulled, so the card queues
        the K programs back to back. Results per batch match K
        independent match_batch calls."""
        batches = [list(b) for b in batches]
        if not batches:
            return []
        self._acquire(lock_timeout)
        try:
            self._sync_for_match()
            sw = self._swm
            snapshot = self._entries_snapshot
            Bpad = max(self._pad_batch(len(b)) for b in batches)
            # only the encode (the table's interner) needs the lock; the
            # window prep runs on the pinned state after release
            encoded = []
            for topics in batches:
                pw, pl, pd, pb, _gb = self._encode_batch_ex(topics)
                pw, pl, pd = _pad_pub_block(pw, pl, pd, Bpad)
                encoded.append((pw, pl, pd, pb))
            pinned = sw._pin_state()
            self._inflight += 1
        finally:
            self.lock.release()
        n_pubs = sum(len(b) for b in batches)
        self.match_batches += len(batches)
        self.match_publishes += n_pubs
        t_disp = time.monotonic()
        try:
            preps = [sw._prep_encoded(pw, pl, pd, pb, len(topics),
                                      pinned=pinned)
                     for topics, (pw, pl, pd, pb) in zip(batches, encoded)]
            # launch ALL batches, then pull
            refs = [sw._dispatch_device(p) for p in preps]
            pulled = [sw._pull(r) for r in refs]
            self.super_dispatches += 1
        except TM.KernelError:
            raise
        except Exception as e:
            self._record_device_failure(e)
        else:
            self._record_device_success()
            if not watchdog_mod.current_op_abandoned():
                dur = (time.monotonic() - t_disp) * 1e3
                obs.observe("stage_device_dispatch_ms", dur)
                record_dispatch("match", t_disp, dur, k=len(batches),
                                batch=n_pubs, bpad=int(Bpad))
        finally:
            with self.lock:
                self._inflight -= 1
        return [self._resolve_sharded(topics, p, pl_, snapshot)
                for topics, p, pl_ in zip(batches, preps, pulled)]

    def _pad_batch(self, n: int) -> int:
        # the prep's Bpad ladder: divisible by the 'batch' axis
        b = 8 * self.mesh.shape["batch"]
        while b < n:
            b *= 2
        return b
