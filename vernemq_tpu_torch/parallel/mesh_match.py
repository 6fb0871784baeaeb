"""Mesh-native matcher: one logical subscription table spanning a mesh
that may span processes, with slice-routed delta scatter. The port of
``vernemq_tpu/parallel/mesh_match.py``.

Where :class:`~.sharded_match.ShardedWindowedMatcher` ships every delta to
every shard, :class:`MeshMatcher`

- places its twelve named state arrays through the shared partition rules
  (``parallel/mesh.py``), so the same specs serve a one-process mesh of
  one card (or of the CPU, repeated), a mesh of several cards, and a
  ``torch.distributed`` process group where each process holds only its
  addressable shards;
- routes delta write-throughs to the OWNING SLICE: the dirty slots are
  grouped on the host by row→slice ownership (slice = contiguous
  'sub'-axis row range) and scattered (``index_copy_``) only into the dirty
  slices' shards; the clean slices' tensors are untouched. Rows in the
  replicated dense g-zone dirty every replica by definition — counted
  separately (``route_gzone_flushes``), never against the routing hit
  rate;
- keeps the seat's discipline: :class:`MeshGpuMatcher` inherits the lock,
  snapshots, background rebuilds, breaker and watchdog from
  :class:`~.sharded_match.ShardedGpuMatcher`.

Across processes the windowed dispatch cannot run (no process holds every
shard), so it raises and the breaker degrades matching to the host trie,
as the reference's pjit dispatch does on a multi-process CPU runtime.
:meth:`MeshMatcher.match_local_slices` is the per-process device path:
each process matches the publishes against its OWN slices (one tile-kernel
launch per slice with the row guard off, then the extraction kernel) and
the cluster plane unions the partial fanouts. The two-process case runs
on ``gloo`` on the CPU (tests); NCCL across cards is unverified.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Sequence, Set, Tuple

import numpy as np
import torch

from ..observability import histogram as obs
from ..observability.profiler import record_dispatch
from ..ops import match_kernel as K
from ..ops import tile_match as TM
from ..ops.extract import extract_rows
from .mesh import MATCHER_STATE_NAMES
from .sharded_match import ShardedGpuMatcher, ShardedWindowedMatcher


# ---------------------------------------------------------------------------
# per-shard scatters
# ---------------------------------------------------------------------------

def _scatter_rows(data: torch.Tensor, idx, vals) -> torch.Tensor:
    """Row scatter into a 1-D shard ``[Sl]`` (metadata arrays), in place."""
    return data.index_copy_(0, idx, vals)


def _scatter_rows_copy(data: torch.Tensor, idx, vals) -> torch.Tensor:
    return data.clone().index_copy_(0, idx, vals)


def _scatter_cols(data: torch.Tensor, idx, vals) -> torch.Tensor:
    """Column scatter into a 2-D shard ``[K, Sl]`` (the coded operand —
    table rows are F_t columns), in place."""
    return data.index_copy_(1, idx, vals)


def _scatter_cols_copy(data: torch.Tensor, idx, vals) -> torch.Tensor:
    return data.clone().index_copy_(1, idx, vals)


def _shard_col_start(shard) -> int:
    """Row-axis start of a shard's index (the last axis for F_t, the only
    axis for metadata arrays)."""
    return shard.index[-1].start or 0


def _check_mesh_geometry(S: int, nslices: int) -> None:
    """The slice-geometry floor shared by every build path: rows must
    divide over the slices and each slice needs the windowed kernel's
    4096-row minimum."""
    if S % nslices != 0 or S // nslices < 4096:
        raise ValueError(
            f"table of {S} rows cannot shard over {nslices} mesh "
            f"slices (needs S % {nslices} == 0 and >= 4096 rows/slice)")


#: launches of :meth:`MeshMatcher.match_local_slices` on CUDA tensors:
#: tile-kernel launches (shard mode, guard off) and extraction launches
local_launches = {"tile": 0, "extract": 0}


class MeshMatcher(ShardedWindowedMatcher):
    """The windowed production matcher as persistent placed state over a
    mesh that may span processes. Dispatch is the sharded matcher's
    per-shard program; placement and delta routing are mesh-native (see
    the module docstring)."""

    def __init__(self, table, mesh, max_fanout: int = 128,
                 with_total: bool = False, flat_avg: int = 128,
                 merge: bool = False):
        super().__init__(table, mesh, max_fanout=max_fanout,
                         with_total=with_total, flat_avg=flat_avg,
                         merge=merge)
        # slice-routing accounting (`vmq-admin mesh show` / mesh_* gauges)
        self.route_flushes = 0          # slice-routed delta flushes
        self.route_dirty_slices = 0     # dirty slices scattered, cumulative
        self.route_gzone_flushes = 0    # flushes that touched the g-zone
        self.route_rows = 0             # delta rows shipped, cumulative
        self.full_scatters = 0          # full-table placements (builds)
        self.mesh_dispatches = 0        # pulled match dispatches
        self.last_route: Dict[str, Any] = {}

    @property
    def nslices(self) -> int:
        """Slices = the mesh's 'sub' axis."""
        return self.nsub

    # ------------------------------------------------------------ placement

    def sync(self) -> None:
        """Full placement through the partition rules on (re)build; the
        slice-routed delta otherwise (callers needing consistency hold
        their own lock)."""
        t = self.table
        self._reg_start = t.reg_start.copy()
        self._reg_end = (t.reg_start + t.reg_cap).copy()
        if self._dev is not None and not t.resized and not t.dirty:
            return
        if self._dev is not None and not t.resized:
            self._sync_delta()
            return
        assert t.bucketed and t.id_bits, \
            "mesh-native matching needs a bucketed table"
        S = t.cap
        _check_mesh_geometry(S, self.nslices)
        glob = t.gb_end
        self._dev = self._place(t.words, t.eff_len, t.has_hash,
                                t.first_wild, t.active, t.id_bits, glob)
        self.full_scatters += 1
        self._glob = glob
        self._S = S
        self._bits = t.id_bits
        t.resized = False
        t.dirty.clear()

    # --------------------------------------------------- slice-routed delta

    def slice_of_rows(self, rows: np.ndarray) -> np.ndarray:
        """Owning slice id per global table row (slice s owns ``[s*Sl,
        (s+1)*Sl)``)."""
        Sl = self._S // self.nslices
        return np.minimum(rows // Sl, self.nslices - 1)

    def slice_ranges(self) -> List[Tuple[int, int]]:
        Sl = self._S // self.nslices
        return [(s * Sl, (s + 1) * Sl) for s in range(self.nslices)]

    def addressable_slices(self) -> Set[int]:
        """Slices whose shards this process holds (all of them in one
        process; the owned subset under ``torch.distributed``)."""
        if self._dev is None:
            return set()
        Sl = self._S // self.nslices
        return {_shard_col_start(sh) // Sl
                for sh in self._dev[0].addressable_shards}

    def _sync_delta(self, donate: bool = True) -> None:
        """The slice-routed flush: per-slice sub-deltas scattered ONLY into
        the dirty slices' shards, clean slices' tensors untouched. A flush
        whose dirty rows all fall outside the g-zone leaves every replica
        mirror untouched too: there is no full-table scatter path here.
        ``donate=False`` (a match in flight reads the tensors) scatters
        into copies."""
        t = self.table
        t0 = time.monotonic()
        slots = np.fromiter(t.dirty, dtype=np.int64, count=len(t.dirty))
        t.dirty.clear()
        if len(slots) == 0:
            return
        Sl = self._S // self.nslices
        owners = self.slice_of_rows(slots)
        dirty_slices = sorted(int(s) for s in set(owners.tolist()))
        named = dict(zip(MATCHER_STATE_NAMES, self._dev))
        addressable = self.addressable_slices()
        rows_of = {"eff_len": t.eff_len[slots], "has_hash": t.has_hash[slots],
                   "first_wild": t.first_wild[slots],
                   "active": t.active[slots]}
        ops: Dict[torch.device, tuple] = {}  # the dirty rows' operands

        def operands(dev):
            if dev not in ops:
                put = lambda a: torch.from_numpy(
                    np.ascontiguousarray(a)).to(dev)
                F_d, t1_d = K.build_operands(put(t.words[slots]),
                                             put(rows_of["eff_len"]),
                                             self._bits)
                ops[dev] = dict(F_t=F_d, t1=t1_d,
                                **{n: put(v) for n, v in rows_of.items()})
            return ops[dev]

        def scatter(name: str, upd, base_name: str) -> None:
            """Rebuild one named array with every shard whose row start is
            in ``upd`` (start -> delta-row indices, shard-local indices)
            scattered; every other shard's tensor rides along untouched."""
            arr = named[name]
            two_d = name.endswith("F_t")
            fn = ((_scatter_cols if donate else _scatter_cols_copy) if two_d
                  else (_scatter_rows if donate else _scatter_rows_copy))
            datas = {}
            for sh in arr.addressable_shards:
                start = _shard_col_start(sh)
                if start not in upd:
                    continue
                vidx, lidx = upd[start]
                dev = sh.data.device
                vals = operands(dev)[base_name]
                vals = vals.index_select(1 if two_d else 0, vidx.to(dev))
                datas[sh.coords] = fn(sh.data, lidx.to(dev), vals)
            named[name] = arr.replace(datas)

        # per-slice sub-deltas for the row-sharded arrays: start -> (delta
        # rows, shard-local slots), dirty and addressable slices only
        rows_shipped = 0
        upd: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}
        for s in dirty_slices:
            if s not in addressable:
                # a remote process owns this slice: ITS write-through
                # applies the delta there (the metadata plane replicates
                # the subscription events to every node)
                continue
            mine = np.nonzero(owners == s)[0]
            upd[s * Sl] = (torch.from_numpy(mine),
                           torch.from_numpy(slots[mine] - s * Sl))
            rows_shipped += len(mine)
        if upd:
            for name in ("F_t", "t1", "eff_len", "has_hash", "first_wild",
                         "active"):
                scatter(name, upd, name)

        # replicated g-zone mirrors: a dirty row below gb_end is in every
        # replica — scatter each addressable copy (replication cost, not
        # a routing miss)
        gmask = slots < self._glob
        if gmask.any():
            gsel = np.nonzero(gmask)[0]
            gupd = {0: (torch.from_numpy(gsel),
                        torch.from_numpy(slots[gsel]))}
            for name in ("g/F_t", "g/t1", "g/eff_len", "g/has_hash",
                         "g/first_wild", "g/active"):
                scatter(name, gupd, name[2:])
            self.route_gzone_flushes += 1

        self._dev = tuple(named[n] for n in MATCHER_STATE_NAMES)
        self.route_flushes += 1
        self.route_dirty_slices += len(
            [s for s in dirty_slices if s in addressable])
        self.route_rows += rows_shipped
        self.last_route = {
            "rows": int(len(slots)), "dirty_slices": dirty_slices,
            "addressable": sorted(addressable),
            "total_slices": self.nslices,
            "gzone": bool(gmask.any()),
        }
        obs.observe("stage_mesh_delta_route_ms",
                    (time.monotonic() - t0) * 1e3)

    # ------------------------------------------------------------- dispatch

    def _pull(self, res):
        """Result pull for one launched batch (the blocking half of the
        dispatch): observed as the mesh dispatch seam, once per dispatched
        batch on both the match_batch and the match_many paths."""
        t0 = time.monotonic()
        out = super()._pull(res)
        self.mesh_dispatches += 1
        dur = (time.monotonic() - t0) * 1e3
        obs.observe("stage_mesh_dispatch_ms", dur)
        record_dispatch("mesh", t0, dur, slices=self.nslices)
        return out

    # -------------------------------------------- multi-process local match

    def match_local_slices(self, topics: Sequence[Sequence[str]]
                           ) -> Tuple[List[np.ndarray], List[Tuple[int, int]]]:
        """Partial fanout over this process's ADDRESSABLE slices: per local
        slice, one tile-kernel launch of every publish against all the
        slice's rows (shard mode with the row guard off) and one extraction
        of all set rows (a second, wider one when a publish's count passes
        the first's ``max_fanout``). No cross-process collective. Returns
        (per-topic GLOBAL slot-id arrays restricted to local rows, the
        owned row ranges); the cluster plane unions partials across
        processes, and rows outside the union are the callers' host-trie
        degradation."""
        t = self.table
        # the same serve-current-state contract as match_batch: pending
        # deltas and growth ship before serving
        self.sync()
        n = len(topics)
        L = t.L
        pw = np.full((max(n, 1), L), np.int32(K.PAD_ID), dtype=np.int32)
        pl = np.zeros(max(n, 1), dtype=np.int32)
        pd = np.zeros(max(n, 1), dtype=np.int32)
        for i, tp in enumerate(topics):
            row, ln, dollar = t.encode_topic(tp)
            pw[i], pl[i], pd[i] = row, ln, dollar
        named = dict(zip(MATCHER_STATE_NAMES, self._dev))
        Sl = self._S // self.nslices
        if Sl % TM.ROW_CHUNK:
            raise TM.KernelInputError(
                f"match_local_slices: slices of {Sl} rows are no multiple "
                f"of the kernel's {TM.ROW_CHUNK}-row chunk")
        by_slice = {}
        for sh in named["F_t"].addressable_shards:
            by_slice.setdefault(_shard_col_start(sh) // Sl, sh.coords)
        out = [[] for _ in range(n)]
        ranges: List[Tuple[int, int]] = []
        pubs = {}
        for s, (b, s_) in sorted(by_slice.items()):
            ranges.append((s * Sl, (s + 1) * Sl))
            st = [named[nm].data(b, s_) for nm in MATCHER_STATE_NAMES[:6]]
            dev = st[0].device
            if dev not in pubs:
                put = lambda a: torch.from_numpy(a).to(dev)
                pubs[dev] = (K.build_pub_operand(put(pw), self._bits),
                             put(pl), put(pd))
            G, pld, pdd = pubs[dev]
            packed = TM.dense_tiles_packed(
                st[0], st[1], st[2], TM.row_flags(*st[3:]), G, pld, pdd,
                glob_pad=0, seg=Sl, mode="shard")
            k = self.max_fanout
            idx, valid, cnt = extract_rows(packed, k)
            kmax = int(cnt.max())
            if kmax > k:  # every set row: extract again, as wide as needed
                idx, valid, cnt = extract_rows(packed, kmax)
            if dev.type == "cuda":
                local_launches["tile"] += 1
                local_launches["extract"] += 1 + (kmax > k)
            idx, valid = idx.cpu().numpy(), valid.cpu().numpy()
            for i in range(n):
                out[i].append(idx[i][valid[i]].astype(np.int64) + s * Sl)
        return ([np.concatenate(o) if o else np.empty(0, np.int64)
                 for o in out], ranges)

    # -------------------------------------------------------------- status

    def mesh_status(self) -> Dict[str, Any]:
        """Routing + residency snapshot for admin/gauges. The per-slice
        row counts are an O(S) active-mask reduction, cached per device
        generation (flush/build counters) so every metrics scrape does not
        rescan a 10M-row table."""
        rows_per_slice: List[int] = []
        if self._dev is not None:
            gen = (self.full_scatters, self.route_flushes, self._S)
            cached = getattr(self, "_rps_cache", None)
            if cached is not None and cached[0] == gen:
                rows_per_slice = cached[1]
            else:
                act = self.table.active
                rows_per_slice = [int(act[lo:hi].sum())
                                  for lo, hi in self.slice_ranges()]
                self._rps_cache = (gen, rows_per_slice)
        return {
            "slices": self.nslices,
            "slice_rows": self._S // self.nslices if self._dev else 0,
            "rows_per_slice": rows_per_slice,
            "addressable": sorted(self.addressable_slices()),
            "route_flushes": self.route_flushes,
            "route_dirty_slices": self.route_dirty_slices,
            "route_gzone_flushes": self.route_gzone_flushes,
            "route_rows": self.route_rows,
            "full_scatters": self.full_scatters,
            "mesh_dispatches": self.mesh_dispatches,
            "last_route": dict(self.last_route),
        }


# ---------------------------------------------------------------------------
# The production seat
# ---------------------------------------------------------------------------


class MeshGpuMatcher(ShardedGpuMatcher):
    """A GpuMatcher-compatible seat over :class:`MeshMatcher` — what
    ``GpuRegView`` builds when a mesh is configured (the default mesh
    seat; ``tpu_mesh_native=false`` keeps the per-call sharded seat). It
    inherits the discipline of :class:`ShardedGpuMatcher` and swaps
    placement and deltas for the mesh-native machinery. Growing the table
    re-partitions rows: the resize forces a full rebuild (in the
    background, the host trie serving behind RebuildInProgress) whose
    install re-derives every slice's row range from the new S."""

    def __init__(self, mesh, max_levels: int = 16,
                 initial_capacity: int = 1024, max_fanout: int = 128,
                 flat_avg: int = 128, **_ignored):
        super().__init__(mesh, max_levels=max_levels,
                         initial_capacity=initial_capacity,
                         max_fanout=max_fanout, flat_avg=flat_avg)
        # swap the device half for the mesh-native matcher (same table,
        # same merge posture as the sharded seat)
        self._swm = MeshMatcher(self.table, mesh, max_fanout=max_fanout,
                                flat_avg=flat_avg, merge=True)
        #: slice-map epochs already adopted (exactly-once replay guard)
        self._adopted_epochs: set = set()
        self.slice_adoptions = 0

    def _build_device(self, state: dict) -> tuple:
        """Background build from a host snapshot, placed through the
        partition rules (the async-rebuild worker runs this off the
        lock)."""
        if not (state["bucketed"] and state["bits"]):
            raise ValueError("mesh-native matching needs a bucketed "
                             "table with codable ids")
        S = state["words"].shape[0]
        _check_mesh_geometry(S, self.mesh.shape["sub"])
        glob = state["gb_end"]
        dev = self._swm._place(state["words"], state["eff_len"],
                               state["has_hash"], state["first_wild"],
                               state["active"], state["bits"], glob)
        self._sync_mesh_devices()
        self._swm.full_scatters += 1
        return (dev, S, glob)

    # ----------------------------------------------------- slice adoption

    def adopt_slices(self, slice_ids: Sequence[int], epoch) -> int:
        """Replay the rows of newly-owned slices into the device table
        exactly once per slice-map adoption token: the owned rows are
        marked dirty under the lock and the next sync ships them as
        per-slice sub-deltas (slice-routed, so the flush lands only on the
        adopted slices). ``epoch`` is an opaque hashable token (the slice
        map passes (claimer_node, its_epoch)). Returns rows marked; 0 on a
        repeat token."""
        key = (epoch, tuple(sorted(slice_ids)))
        with self.lock:
            if key in self._adopted_epochs:
                return 0
            self._adopted_epochs.add(key)
            t = self.table
            if self._dev_arrays is None:
                # nothing resident yet: the first build ships everything
                return 0
            Sl = self._swm._S // self._swm.nslices
            marked = 0
            for s in slice_ids:
                lo = s * Sl
                hi = min((s + 1) * Sl, len(t.entries))
                if hi <= lo:
                    continue
                # vectorized: the active mask IS the live-row set
                live = np.nonzero(t.active[lo:hi])[0]
                t.dirty.update((live + lo).tolist())
                marked += len(live)
            self.slice_adoptions += 1
        return marked

    def mesh_status(self) -> Dict[str, Any]:
        st = self._swm.mesh_status()
        st["slice_adoptions"] = self.slice_adoptions
        return st
