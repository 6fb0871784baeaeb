"""The GPU match engine: a device-resident subscription table and batched
wildcard matching, behind the registry's reg-view seam.

The port of ``vernemq_tpu/models/tpu_matcher.py``: ``vmq_reg_trie``'s
``fold_subscribers`` becomes one batched device call over thousands of
concurrent PUBLISHes.

- :class:`GpuMatcher` owns a :class:`SubscriptionTable`, mirrors it to the
  device (full upload on growth, in-place scatter of dirty rows otherwise)
  and serves ``match_batch``: a dense pass over region 0 plus probe-A /
  probe-B window tiles through the hand kernel (``ops/tile_match.py``),
  compacted on the device into one flat buffer. ``match_many`` runs K
  batches from one staged upload to one download. Publishes the device
  cannot serve exactly (window leftovers, fanout past ``max_fanout``, flat
  capacity) are matched on the host against the same table snapshot. Around
  the device path sit the circuit breaker, the background rebuild and the
  stall-watchdog hooks. A CUDA fault of the device path (a failed launch, an
  illegal address) raises :class:`~..ops.tile_match.KernelError` to the
  caller and never reaches the breaker or the trie.
- :class:`GpuRegView` is the reg-view adapter over a registry that offers
  ``fold_subscriptions(mountpoint)`` and ``trie(mountpoint)``: the
  production seat (background rebuilds, breaker, watchdog). With a
  ``mesh`` each mountpoint's seat is a mesh-native or sharded matcher
  (``parallel/mesh_match.py``, ``parallel/sharded_match.py``).
- :class:`BatchCollector` coalesces concurrent publishes into device calls
  (windows, two in flight, super-batches under load) and sheds to the host
  trie whenever the device cannot answer promptly.

Not yet ported (ROADMAP): the collector's match-service fold meta (worker
mode). The reference's warm-signature gate
and warm-up ladders have no counterpart: they bound XLA compiles, and eager
PyTorch compiles nothing per shape.
"""

from __future__ import annotations

import asyncio
import collections
import logging
import threading
import time
from typing import Any, Dict, Hashable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..broker import heap
from ..device import DeviceLike, resolve_device
from ..observability import histogram as obs
from ..observability.profiler import record_dispatch
from ..ops import _build
# imported for its binder: load_kernels(KERNEL_LIBS) loads its library
from ..ops import extract  # noqa: F401
from ..ops import match_kernel as K
from ..ops import tile_match as TM
from ..robustness import faults
from ..robustness import watchdog as watchdog_mod
from ..robustness.breaker import CircuitBreaker
from ..robustness.overload import collector_pressure, fold_latency_ewma
from ..robustness.watchdog import StallAbandoned
from .table import SubscriptionTable

Row = Tuple[Tuple[str, ...], Hashable, Any]

log = logging.getLogger("vernemq_tpu_torch.matcher")

#: background-rebuild threads stash their abandon token here so the
#: observability seams inside _build_device can tell a healthy build from
#: a watchdog-abandoned straggler
_rebuild_tls = threading.local()

TILE_PUBS = 256  # publishes per window tile
FAIR_MULT = 2    # window width vs per-tile fair share of the zone

#: the kernel libraries (``ops/_build.py`` names) the CUDA match path
#: launches
KERNEL_LIBS = ("tile_match", "extract")


def load_kernels(device: torch.device, names=KERNEL_LIBS) -> None:
    """Build and load the kernel libraries ``names`` (by default every one
    the match path launches), before anything is served. A build or load error raises here, to whoever
    creates the matcher or its view: it never reaches the breaker and is
    never answered from the trie. (The reference instead turns its Pallas
    kernel off for good when Mosaic cannot lower it and serves through
    XLA, ``_pallas_broken``; the port has no second device path.)"""
    if device.type == "cuda":
        for name in names:
            _build.load(name)


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
                    row_lo: int = 0, row_hi: Optional[int] = None,
                    tp: Optional[int] = None):
    """Host prep for the windowed kernels: sort the n real publishes by
    their region's address, pack them into at most T tiles of ``tp``
    (default TILE_PUBS) slots, window each tile at its first region's
    start. Publishes that
    cannot be tiled (window budget exhausted, or a region outside
    ``[row_lo, row_hi)``) come back as ``leftovers`` for exact host
    matching.

    Returns ``(t_sel [T, TP] int32, t_start [T] int32 (row_lo-relative),
    tile_of [n], pos_of [n], leftovers)``; pad slots select publish 0.
    """
    TP = tp or TILE_PUBS
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
    """The matcher lock stayed busy past the caller's bound; the caller
    serves the batch from the host trie."""

    def __init__(self) -> None:
        super().__init__("lock busy")


def _is_cuda_fault(exc: BaseException) -> bool:
    """A CUDA runtime error: a kernel that faulted (an illegal address, an
    unspecified launch failure) surfaces as one from the next launch or
    copy, not from the kernel's own launch, and it is sticky, so every later
    call fails the same way. A fault of the code, never of the device's
    load: it must not be fed to the breaker or answered from the trie."""
    accel = getattr(torch, "AcceleratorError", None)
    if accel is not None and isinstance(exc, accel):
        return True
    return isinstance(exc, RuntimeError) and str(exc).startswith("CUDA error")


class DeviceDegraded(Exception):
    """The device match path is unavailable; callers serve the batch from
    the exact host trie."""


class RebuildInProgress(Exception):
    """The device table is re-uploading after a capacity change; callers
    serve the publish from the host trie meanwhile."""


class GpuMatcher:
    """Device-resident subscription table plus batched matching.

    ``device`` defaults to the CUDA card and raises without one; pass
    ``device="cpu"`` to run the plain PyTorch path. On CUDA the kernel
    libraries are built and loaded here, before the matcher serves."""

    def __init__(self, max_levels: int = 16, initial_capacity: int = 1024,
                 max_fanout: int = 256, flat_avg: int = 128,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        load_kernels(self.device)
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
        self.super_dispatches = 0  # K-batch match_many dispatches
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
        # non-blocking growth: with async_rebuild a capacity rebuild
        # uploads on a worker thread while callers shed to the host trie
        # (RebuildInProgress). The first build stays synchronous. Off for
        # bare matchers; GpuRegView, the production seat, turns it on.
        self.async_rebuild = False
        self._rebuild_thread: Optional[threading.Thread] = None
        self._rebuild_barrier: Optional[threading.Event] = None  # tests
        self._closed = False  # close(): no rebuild respawns itself
        self.warm_ms: Optional[float] = None  # _warm_locked's wall
        # the first CUDA fault the device path met (dispatch, delta or
        # build): the context is unusable from then on, so every later
        # sync raises it as KernelError instead of rebuilding, shedding to
        # the trie meanwhile, into the same fault
        self._cuda_fault: Optional[BaseException] = None
        self.rebuilds_async = 0
        # stall watchdog (set by the production seat): background rebuilds
        # register a monitored op and are ABANDONED past
        # rebuild_deadline_s — sync() reaps the wedged thread like a
        # crashed one, its late install is discarded, the breaker is fed
        self.watchdog: Optional[Any] = None
        self.rebuild_deadline_s = 120.0
        self._rebuild_token: Optional[dict] = None
        self.rebuild_abandons = 0
        self.dispatch_stalls = 0  # abandoned dispatches fed via record_stall
        self.busy_sheds = 0  # lock-timeout sheds
        # device-path circuit breaker: N consecutive dispatch failures flip
        # ALL matching to the host trie until a half-open probe succeeds.
        # GpuRegView applies its breaker settings; None re-raises device
        # errors verbatim.
        self.breaker: Optional[CircuitBreaker] = CircuitBreaker(name="match")
        self.device_failures = 0   # dispatch/upload errors fed to it
        self.degraded_sheds = 0    # calls refused while open (host-served)

    # ------------------------------------------------------- full (re)build

    def _snapshot_host_locked(self, copy: bool = True,
                              clear: bool = True) -> dict:
        """Consistent host snapshot of everything a full device build
        needs (lock held). ``copy=True`` (the background path) copies the
        arrays, which keep mutating after the lock is released; the inline
        build passes the live ones. ``clear`` consumes ``resized``/``dirty``
        at snapshot time (the background path: later mutations re-mark);
        the inline path clears only after a successful install, so a failed
        build stays retryable."""
        t = self.table
        c = (lambda a: a.copy()) if copy else (lambda a: a)
        entries = np.empty(len(t.entries), dtype=object)
        entries[:] = t.entries
        state = {
            "words": c(t.words), "eff_len": c(t.eff_len),
            "has_hash": c(t.has_hash), "first_wild": c(t.first_wild),
            "active": c(t.active), "bits": t.id_bits,
            "reg_start": t.reg_start.copy(),
            "reg_end": (t.reg_start + t.reg_cap).copy(),
            "glob_pad": int(t.reg_cap[0]),
            "gb_end": t.gb_end if t.bucketed else int(t.reg_cap[0]),
            "ng": t.NG, "bucketed": t.bucketed, "entries": entries,
        }
        if clear:
            t.resized = False
            t.dirty.clear()
        return state

    def _build_device(self, state: dict) -> tuple:
        """Device half of a full build (no lock held): upload the snapshot
        and derive the coded operands. On CUDA it waits for its own work,
        so a build handed to :meth:`_install_built` is complete."""
        faults.inject("device.rebuild")
        t0 = time.monotonic()
        dev = tuple(torch.from_numpy(state[k]).to(self.device, copy=True)
                    for k in ("words", "eff_len", "has_hash", "first_wild",
                              "active"))
        t_upload = time.monotonic()
        operands = (K.build_operands(dev[0], dev[1], state["bits"])
                    if state["bits"] else None)
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        done = time.monotonic()
        # an abandoned build's straggler must not record its wedge-inflated
        # duration (stage_rebuild_ms is the tuning base of the deadline)
        tok = getattr(_rebuild_tls, "token", None)
        if not (tok and tok.get("abandoned")) \
                and not watchdog_mod.current_op_abandoned():
            obs.observe("stage_rebuild_ms", (done - t0) * 1e3)
            record_dispatch(
                "rebuild", t0, (done - t0) * 1e3,
                rows=int(state["words"].shape[0]),
                upload_ms=round((t_upload - t0) * 1e3, 3),
                operands_ms=round((done - t_upload) * 1e3, 3))
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

    def _abandon_rebuild(self, token: dict) -> None:
        """Stall-watchdog ``on_stall``: the background rebuild exceeded its
        deadline. Treat it like a crashed one: mark its token so sync()
        reaps it and its late install is discarded, and feed the breaker so
        matching degrades loudly now instead of shedding RebuildInProgress
        forever. Runs on the monitor thread, without the matcher lock (the
        wedged holder might be inside it)."""
        if token.get("abandoned"):
            return
        token["abandoned"] = True
        self.rebuild_abandons += 1
        self.device_failures += 1
        br = self.breaker
        if br is not None and br.record_failure():
            log.error("device path OPENED: background table rebuild stalled "
                      "past its %.1fs deadline (abandoned; host trie "
                      "serves)", self.rebuild_deadline_s)

    def _spawn_rebuild_locked(self) -> None:
        """Start the background rebuild (lock held). The thread builds from
        a snapshot; at install time, if the layout moved AGAIN or the
        watchdog abandoned this build, the stale build is discarded."""
        state = self._snapshot_host_locked(copy=True)
        self.rebuilds_async += 1
        token = {"abandoned": False}
        self._rebuild_token = token
        wd = self.watchdog
        op = (wd.register("device.rebuild", self.rebuild_deadline_s,
                          label="table-rebuild",
                          on_stall=lambda _op: self._abandon_rebuild(token))
              if wd is not None and self.rebuild_deadline_s > 0 else None)

        def _run() -> None:
            _rebuild_tls.token = token
            try:
                try:
                    built = self._build_device(state)
                except Exception as e:
                    if token["abandoned"]:
                        wd.note_late_discard("device.rebuild",
                                             "failed after abandonment")
                        return
                    if _is_cuda_fault(e):
                        self._cuda_fault = e  # sync() raises it
                        return
                    log.exception("background table rebuild failed; will "
                                  "retry from the next sync")
                    return  # sync() reaps the dead thread, re-arms resized
                barrier = self._rebuild_barrier
                if barrier is not None:
                    barrier.wait()
                with self.lock:
                    if token["abandoned"] or self._rebuild_thread is not th:
                        # abandoned (sync has reaped it and may run a fresh
                        # build): a late install would publish stale layout
                        if wd is not None:
                            wd.note_late_discard("device.rebuild",
                                                 "stale install discarded")
                        return
                    t = self.table
                    if t.resized or t.id_bits != state["bits"]:
                        if not self._closed:
                            self._spawn_rebuild_locked()
                        return
                    self._install_built(built, state)
                    self._rebuild_thread = None
                    # under the lock: a sync that sees the install sees
                    # the heap policy's collection done
                    heap.POLICY.settled(
                        f"a rebuild of {self.table.count} rows swapped in")
            finally:
                if op is not None:
                    wd.deregister(op)

        # cooperative stop: _run discards its install when abandoned, and
        # sync() reaps the handle; a join would park callers behind a
        # possibly wedged device call
        th = threading.Thread(target=_run, name="gpu-table-rebuild",
                              daemon=True)
        self._rebuild_thread = th
        th.start()

    def close(self) -> None:
        """Shut down (the broker's stop): a background rebuild respawns no
        more and is joined — at most ``rebuild_deadline_s``, past which
        the stall watchdog owns it — and the card's queued work is
        waited for, so nothing of this matcher runs on the device after
        the event loop closes."""
        with self.lock:
            self._closed = True
            th = self._rebuild_thread
        if th is not None:
            th.join(self.rebuild_deadline_s or None)
        if self.device.type == "cuda" and self._cuda_fault is None:
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------ delta sync

    def sync(self) -> None:
        """Ship pending table mutations to the device: a full upload after
        a capacity or id-width change (on a worker thread with
        ``async_rebuild``, raising :class:`RebuildInProgress` until it
        installs), an in-place scatter of the dirty rows otherwise. Also
        snapshots the slot→entry map, so a match resolves against the
        state it matched. Callers hold ``self.lock``."""
        t = self.table
        bits = t.id_bits
        if self._cuda_fault is not None:
            raise TM.KernelError(
                f"CUDA fault on the device path: {self._cuda_fault}") \
                from self._cuda_fault
        if self._rebuild_thread is not None:
            tok = self._rebuild_token
            abandoned = tok is not None and tok.get("abandoned")
            if self._rebuild_thread.is_alive() and not abandoned:
                raise RebuildInProgress
            # a crashed worker — or one the watchdog abandoned: the
            # snapshot consumed `resized`, so re-arm it (the delta path
            # would scatter grown-region slots against the OLD arrays)
            self._rebuild_thread = None
            t.resized = True
        if self._dev_arrays is None or t.resized or bits != self._ops_bits:
            if self._dev_arrays is not None and self.async_rebuild:
                self._spawn_rebuild_locked()
                raise RebuildInProgress
            # clear-after-success: a failed inline build must retry
            state = self._snapshot_host_locked(copy=False, clear=False)
            self._install_built(self._build_device(state), state)
            t.resized = False
            t.dirty.clear()
            if self.warm_ms is None:
                self._warm_locked()
                heap.POLICY.settled(f"the first build of {t.count} rows")
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
            # re-converge, and the error feeds the caller's breaker
            t.resized = True
            raise
        # regions may move without a resize (relocation into the spare)
        self._reg_start = t.reg_start.copy()
        self._reg_end = (t.reg_start + t.reg_cap).copy()

    def _warm_locked(self) -> None:
        """After the first build (lock held), run the match dispatch and
        the delta scatter once on the card, results discarded: CUDA loads
        a kernel's module at its first launch, and the first flush of a
        fresh process would otherwise pay that for every kernel of the
        path (about a second) while the publishes queued behind it expire
        to the trie. The reference warms its XLA shapes at matcher start
        for the same reason. The scatter rewrites slot 0 with its own
        device values; no fault point, counter or histogram sees either
        call. Records ``warm_ms``."""
        t0 = time.monotonic()
        if (self.device.type == "cuda" and self._bucketed
                and self._operands is not None):
            enc = self._encode_batch_ex([("$warm",)])
            args, statics, _ = self._flat_prep(
                self._layout_locked(), int(self._operands[0].shape[1]),
                *enc, 1)
            self._dispatch_flat(self._dev_arrays, self._operands, args,
                                statics)
            K.apply_delta_fused_nometa(
                self._dev_arrays, self._operands,
                torch.zeros(1, dtype=torch.int64, device=self.device),
                *(a[:1].clone() for a in self._dev_arrays),
                id_bits=self._ops_bits)
            torch.cuda.synchronize(self.device)
        self.warm_ms = (time.monotonic() - t0) * 1e3

    def _apply_delta_device(self, slots: np.ndarray) -> None:
        """Device half of a delta sync (lock held), registered with the
        stall watchdog when one is wired: a wedge here holds the matcher
        lock, so it cannot be abandoned, but it is visible while the lock
        timeouts bound everyone else's wait."""
        wd = self.watchdog
        if wd is None:
            return self._apply_delta_device_impl(slots)
        with wd.monitored("device.delta", 30.0,
                          label=f"scatter:{len(slots)}"):
            return self._apply_delta_device_impl(slots)

    def _apply_delta_device_impl(self, slots: np.ndarray) -> None:
        faults.inject("device.delta")
        t_obs = time.monotonic()
        self._apply_delta_device_inner(slots)
        # success-only + straggler-guarded: a failed or watchdog-abandoned
        # scatter records nothing (the launches are asynchronous: this is
        # the host's share of the scatter, as `profile device` shows it)
        if not watchdog_mod.current_op_abandoned():
            dur = (time.monotonic() - t_obs) * 1e3
            obs.observe("stage_delta_scatter_ms", dur)
            record_dispatch("delta", t_obs, dur, dpad=int(len(slots)))

    def _apply_delta_device_inner(self, slots: np.ndarray) -> None:
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

    # -------------------------------------------------- breaker discipline

    def _breaker_gate(self) -> bool:
        """Refuse device work while the breaker is open (DeviceDegraded:
        the caller serves from the host trie). Returns True when THIS call
        holds the half-open probe slot (the caller hands it back via
        ``probe_aborted`` if it exits without a device verdict)."""
        br = self.breaker
        if br is None:
            return False
        if not br.allow():
            self.degraded_sheds += 1
            raise DeviceDegraded("device circuit open")
        return br.state_name == "half_open"

    def _record_device_failure(self, exc: BaseException) -> None:
        """Feed a device dispatch/upload failure to the breaker and
        re-raise as DeviceDegraded (the host trie serves this batch). With
        no breaker the original error propagates verbatim. A dispatch whose
        waiter the watchdog already released records nothing (the stall
        was fed at abandonment, ``record_stall``). A CUDA fault
        (:func:`_is_cuda_fault`) is neither: it raises as
        :class:`~..ops.tile_match.KernelError`, to the caller, and so does
        every later sync."""
        if _is_cuda_fault(exc):
            self._cuda_fault = exc
            raise TM.KernelError(f"CUDA fault on the device path: {exc}") \
                from exc
        self.device_failures += 1
        br = self.breaker
        if br is None:
            raise exc
        if watchdog_mod.current_op_abandoned():
            raise DeviceDegraded(
                f"late failure of abandoned dispatch: {exc!r}") from exc
        if br.record_failure():
            log.error("device path OPENED after %d consecutive failures "
                      "(last: %s); all matching degrades to the host trie",
                      br.failure_threshold, exc)
        raise DeviceDegraded(f"device dispatch failed: {exc!r}") from exc

    def record_stall(self, exc: Optional[BaseException] = None) -> None:
        """An abandoned (deadline-overrun) dispatch is a device failure:
        feed the breaker. Called by the collector when the watchdog
        releases its waiter."""
        self.dispatch_stalls += 1
        try:
            self._record_device_failure(
                exc if exc is not None
                else RuntimeError("device dispatch stalled past deadline"))
        except Exception:
            pass  # DeviceDegraded (breaker fed) or re-raised exc (no breaker)

    def _record_device_success(self) -> None:
        br = self.breaker
        if br is None:
            return
        if watchdog_mod.current_op_abandoned():
            # a late success raced a stall the breaker already absorbed:
            # only a LIVE probe may close it
            return
        if br.record_success():
            log.warning("device path recovered (probe succeeded after "
                        "%.1fs degraded); closing the breaker",
                        br.time_degraded())

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

    def _acquire(self, lock_timeout: Optional[float]) -> None:
        if lock_timeout is None:
            self.lock.acquire()
        elif not self.lock.acquire(timeout=lock_timeout):
            self.busy_sheds += 1
            raise MatcherBusy()

    def _sync_for_match(self) -> None:
        """sync() under the lock, with a failed upload (delta scatter or
        inline build) fed to the breaker as a device failure."""
        try:
            self.sync()
        except (RebuildInProgress, TM.KernelError):
            raise
        except Exception as e:
            self._record_device_failure(e)

    def _layout_locked(self) -> dict:
        """The table layout the device arrays were built from, pinned
        under the lock with them: host prep outside the lock reads this,
        never a layout a concurrent install may have published since."""
        return dict(reg_start=self._reg_start, reg_end=self._reg_end,
                    glob_pad=self._glob_pad, bits=self._ops_bits,
                    gb_end=self._gb_end, ng=self._ng)

    def match_batch(self, topics: Sequence[Sequence[str]],
                    lock_timeout: Optional[float] = None) -> List[List[Row]]:
        """Match a batch of publish topics; returns each topic's entry rows
        (the per-publish fold results). ``lock_timeout`` bounds the wait
        for the matcher lock (seconds): past it, MatcherBusy — the caller
        serves the batch host-side. A device failure raises DeviceDegraded
        (the breaker is fed); a kernel that refuses its inputs, fails to
        launch or faults raises :class:`~..ops.tile_match.KernelError` and
        is never degraded."""
        if not topics:
            return []
        probe = self._breaker_gate()
        try:
            return self._match_batch_impl(topics, lock_timeout)
        except BaseException:
            if probe:
                # the granted half-open probe exited without a device
                # verdict: hand the slot back (no-op when a recorded
                # failure already re-opened the breaker)
                self.breaker.probe_aborted()
            raise

    def _match_batch_impl(self, topics, lock_timeout) -> List[List[Row]]:
        self._acquire(lock_timeout)
        try:
            self._sync_for_match()
            dev_arrays = self._dev_arrays
            operands = self._operands
            snapshot = self._entries_snapshot
            bucketed = self._bucketed and operands is not None
            if bucketed:
                layout = self._layout_locked()
                pw, pl, pd, pb, gb = self._encode_batch_ex(topics)
            else:
                pw, pl, pd = self.encode_batch(topics)
            self._inflight += 1
        finally:
            self.lock.release()
        self.match_batches += 1
        self.match_publishes += len(topics)
        t_disp = time.monotonic()
        try:
            if bucketed:
                idx_rows, need_host = self._match_windowed(
                    dev_arrays, operands, layout, pw, pl, pd, pb, gb,
                    len(topics))
            else:
                idx_rows, need_host = self._match_dense(
                    dev_arrays, pw, pl, pd, len(topics))
        except TM.KernelError:
            raise
        except Exception as e:
            self._record_device_failure(e)
        else:
            self._record_device_success()
            # straggler guard: an abandoned dispatch's late completion must
            # not record its wedge-inflated duration
            if not watchdog_mod.current_op_abandoned():
                dur = (time.monotonic() - t_disp) * 1e3
                obs.observe("stage_device_dispatch_ms", dur)
                record_dispatch("match", t_disp, dur, k=1, batch=len(topics),
                                bpad=int(pw.shape[0]))
        finally:
            with self.lock:
                self._inflight -= 1
        return self._resolve_rows(topics, idx_rows, need_host, snapshot)

    def match_many(self, batches: Sequence[Sequence[Sequence[str]]],
                   lock_timeout: Optional[float] = None
                   ) -> List[List[List[Row]]]:
        """Match K publish batches in one device dispatch: every batch is
        encoded and window-prepped against one table snapshot, padded to a
        common Bpad, staged as one upload and run back to back on the
        device, with one download (``ops.match_kernel.call_match_many``).
        Results are per batch, bit-identical to K :meth:`match_batch` calls
        at the same Bpad. With K == 1 or an unbucketed table it runs the K
        batches one by one. ``lock_timeout`` follows match_batch's
        contract."""
        if not batches:
            return []
        probe = self._breaker_gate()
        try:
            return self._match_many_impl(batches, lock_timeout)
        except BaseException:
            if probe:
                self.breaker.probe_aborted()  # see match_batch
            raise

    def _match_many_impl(self, batches,
                         lock_timeout) -> List[List[List[Row]]]:
        batches = [list(b) for b in batches]
        self._acquire(lock_timeout)
        fast = False
        try:
            self._sync_for_match()
            operands = self._operands
            snapshot = self._entries_snapshot
            dev_arrays = self._dev_arrays
            fast = (len(batches) > 1 and self._bucketed
                    and operands is not None)
            if fast:
                layout = self._layout_locked()
                Bpad = max(self._pad_batch(len(b)) for b in batches)
                # only the encode (interner access) needs the lock; the
                # window prep runs on the pinned layout after release
                encoded = []
                for topics in batches:
                    pw, pl, pd, pb, gb = self._encode_batch_ex(topics)
                    pw, pl, pd = _pad_pub_block(pw, pl, pd, Bpad)
                    encoded.append((pw, pl, pd, pb, gb))
                self._inflight += 1
        finally:
            self.lock.release()
        if not fast:
            # the impl, not the public wrapper: passage through the
            # breaker gate was already granted
            return [self._match_batch_impl(topics, lock_timeout)
                    for topics in batches]
        n_pubs = sum(len(b) for b in batches)
        self.match_batches += len(batches)
        self.match_publishes += n_pubs
        t_disp = time.monotonic()
        try:
            F_t = operands[0]
            S = int(F_t.shape[1])
            preps: List[tuple] = []
            lefts: List[set] = []
            statics = None
            for topics, enc in zip(batches, encoded):
                args, statics, left = self._flat_prep(
                    layout, S, *enc, len(topics))
                preps.append(args)
                lefts.append(left)
            out = K.call_match_many(*operands, *dev_arrays[1:], preps,
                                    statics)
            results = K.unpack_many_results(out, Bpad, statics["C"])
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
        outs: List[List[List[Row]]] = []
        for topics, (flat, pre, total, overflow), left in zip(
                batches, results, lefts):
            n = len(topics)
            need_host = overflow[:n].copy()
            for i in left:
                need_host[i] = True
            idx_rows = [flat[pre[i]:pre[i] + total[i]] for i in range(n)]
            outs.append(self._resolve_rows(topics, idx_rows, need_host,
                                           snapshot))
        return outs

    @property
    def supports_match_many(self) -> bool:
        """Whether the K-batch dispatch is available (bucketed layout,
        codable ids): table state, not device state, since match_many syncs
        first. The collector super-batches only when this holds, so K
        windows are never serialized."""
        t = self.table
        return bool(t.bucketed and t.id_bits)

    def _geometry(self, S, glob_pad, reg_start, reg_end, Bpad, gb_end, ng):
        """Kernel geometry for both probes at this batch size."""
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
        return T, seg_max, gc, T2, seg2

    def _flat_prep(self, layout: dict, S: int, pw, pl, pd, pb, gb, n):
        """Host prep for :func:`K.match_extract_windowed_flat` against the
        pinned ``layout`` (:meth:`_layout_locked`): geometry, selector
        tiles, per-publish tile coordinates, flat capacity. Returns
        ``(args, statics, left)``: the kernel's trailing positional
        arguments, its keyword arguments, and the publishes left to the
        host (window overflow)."""
        reg_start, reg_end = layout["reg_start"], layout["reg_end"]
        glob_pad, gb_end = layout["glob_pad"], layout["gb_end"]
        Bpad = pw.shape[0]
        T, seg_max, gc, T2, seg2 = self._geometry(
            S, glob_pad, reg_start, reg_end, Bpad, gb_end, layout["ng"])
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
        statics = dict(id_bits=layout["bits"], k=self.max_fanout,
                       glob_pad=glob_pad, seg_max=seg_max, seg2_max=seg2,
                       gc=gc, C=Bpad * self.flat_avg)
        return args, statics, set(leftovers) | set(left2)

    def _dispatch_flat(self, dev_arrays, operands, args,
                       statics) -> np.ndarray:
        """One batch through :func:`K.match_extract_windowed_flat`: returns
        its ``[C + 3B]`` int32 result (``flat, pre, total, overflow``, the
        layout of one row of :func:`K.call_match_many`) with one
        device→host copy."""
        dev = self.device
        put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        # the window starts (args[5], args[7]) stay on the host, where the
        # tile matcher checks their bounds without a device→host copy
        host = [put(a) for a in args[:3]] + [int(args[3]), put(args[4]),
                                            args[5], put(args[6]), args[7]] \
            + [put(a) for a in args[8:]]
        flat, pre, total, overflow = K.match_extract_windowed_flat(
            *operands, *dev_arrays[1:], *host, **statics)
        return torch.cat([flat, pre, total, overflow.to(torch.int32)]) \
            .cpu().numpy()

    def _match_windowed(self, dev_arrays, operands, layout, pw, pl, pd, pb,
                        gb, n):
        """The windowed device path. Returns (per-publish slot id views,
        need_host bool array) in batch order; need_host marks publishes
        the device could not serve exactly."""
        S = int(operands[0].shape[1])
        args, statics, left = self._flat_prep(layout, S, pw, pl, pd, pb,
                                              gb, n)
        faults.inject("device.dispatch")
        out = self._dispatch_flat(dev_arrays, operands, args, statics)
        flat, pre, total, overflow = K.unpack_flat_result(
            out, pw.shape[0], statics["C"])
        need_host = overflow[:n].copy()
        for i in left:
            need_host[i] = True
        # per-publish results are VIEWS into flat — no per-publish copies
        return [flat[pre[i]:pre[i] + total[i]] for i in range(n)], need_host

    def _match_dense(self, dev_arrays, pw, pl, pd, n):
        """Unbucketed (small) table: every publish against every row."""
        faults.inject("device.dispatch")
        put = lambda a: torch.from_numpy(a).to(self.device)
        mask = K.match_mask_unrolled(*dev_arrays, put(pw), put(pl), put(pd))
        idx, valid, count = K.extract_indices(mask, self.max_fanout)
        idx, valid, count = idx.cpu().numpy(), valid.cpu().numpy(), \
            count.cpu().numpy()
        return ([idx[i][valid[i]] for i in range(n)],
                count[:n] > self.max_fanout)

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
    """Reg-view adapter over per-mountpoint :class:`GpuMatcher` s: the
    production seat. Growth rebuilds run in the background while the
    registry's trie serves, a circuit breaker (``breaker_*``) degrades the
    device path to the trie after repeated failures (with
    ``breaker_enabled`` off a device error reaches the caller), and a stall
    ``watchdog`` abandons rebuilds past ``rebuild_deadline_s``. The
    defaults are the reference's (its ``tpu_breaker_*`` knobs).

    ``registry`` provides ``fold_subscriptions(mountpoint)`` (an iterable
    of ``(filter_words, key, opts)``, the initial load) and
    ``trie(mountpoint)`` (the host trie that answers while the device
    cannot). On CUDA the kernel libraries are built and loaded when the
    view is created.

    With a ``mesh`` (``parallel.mesh.make_mesh``; the ``tpu_mesh`` knob)
    each mountpoint gets a :class:`~..parallel.mesh_match.MeshGpuMatcher`,
    or with ``mesh_native`` False a
    :class:`~..parallel.sharded_match.ShardedGpuMatcher`: the serving path
    then matches on every device of the mesh with the same delta stream,
    rebuild shed and fallback discipline; ``device`` is then unused."""

    def __init__(self, registry, max_levels: int = 16,
                 initial_capacity: int = 1024, max_fanout: int = 256,
                 flat_avg: int = 128, mesh=None, mesh_native: bool = True,
                 breaker_enabled: bool = True,
                 breaker_failure_threshold: int = 3,
                 breaker_backoff_initial: float = 0.2,
                 breaker_backoff_max: float = 10.0,
                 watchdog=None, rebuild_deadline_s: float = 120.0,
                 device: DeviceLike = None):
        self.registry = registry
        self.mesh = mesh
        self.mesh_native = mesh_native
        self.device = mesh.first_device if mesh is not None \
            else resolve_device(device)
        load_kernels(self.device)
        self.watchdog = watchdog
        self.rebuild_deadline_s = rebuild_deadline_s
        self._kw = dict(max_levels=max_levels,
                        initial_capacity=initial_capacity,
                        max_fanout=max_fanout, flat_avg=flat_avg,
                        device=self.device)
        self._breaker_enabled = breaker_enabled
        self._breaker_kw = dict(failure_threshold=breaker_failure_threshold,
                                backoff_initial=breaker_backoff_initial,
                                backoff_max=breaker_backoff_max,
                                name="match")
        self._matchers: Dict[str, GpuMatcher] = {}

    def _mk(self) -> GpuMatcher:
        if self.mesh is not None and self.mesh_native:
            from ..parallel.mesh_match import MeshGpuMatcher

            m: GpuMatcher = MeshGpuMatcher(self.mesh, **self._kw)
        elif self.mesh is not None:
            from ..parallel.sharded_match import ShardedGpuMatcher

            m = ShardedGpuMatcher(self.mesh, **self._kw)
        else:
            m = GpuMatcher(**self._kw)
        m.async_rebuild = True
        m.breaker = (CircuitBreaker(**self._breaker_kw)
                     if self._breaker_enabled else None)
        m.watchdog = self.watchdog
        m.rebuild_deadline_s = self.rebuild_deadline_s
        return m

    def matcher(self, mountpoint: str = "") -> GpuMatcher:
        """Get or create the mountpoint's matcher, loaded from the
        registry's current subscriptions. Call it on the thread that
        mutates the registry (the event loop): the load iterates the
        registry."""
        m = self._matchers.get(mountpoint)
        if m is None:
            m = self._mk()
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
            return  # loaded on first use
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

    def fold_batch(self, mountpoint: str, topics: Sequence[Sequence[str]],
                   lock_timeout: Optional[float] = None) -> List[List[Row]]:
        """One batch through the device (``lock_timeout``: a bounded lock
        wait, past which MatcherBusy)."""
        return self.matcher(mountpoint).match_batch(
            topics, lock_timeout=lock_timeout)

    def fold_many(self, mountpoint: str,
                  batches: Sequence[Sequence[Sequence[str]]],
                  lock_timeout: Optional[float] = None):
        """K-window super-batch fold through one device dispatch
        (:meth:`GpuMatcher.match_many`); one result list per batch."""
        return self.matcher(mountpoint).match_many(
            batches, lock_timeout=lock_timeout)

    def supports_many(self, mountpoint: str = "") -> bool:
        """Whether this mountpoint's matcher can take a K-window
        super-batch in one dispatch now (the collector's gate); False
        while the matcher is uncreated."""
        m = self._matchers.get(mountpoint)
        return bool(m is not None and m.supports_match_many)

    def breaker_status(self) -> Dict[str, Any]:
        """Per-mountpoint breaker status."""
        return {mp or "(default)": m.breaker.status()
                for mp, m in self._matchers.items()}

    def mesh_status(self) -> Optional[Dict[str, Any]]:
        """Aggregated mesh-native status across mountpoints (None when
        this view is not mesh-native): summed routing counters and the
        default mountpoint's slice layout — what `vmq-admin mesh show`
        and the mesh_* gauges read."""
        if self.mesh is None or not self.mesh_native:
            return None
        agg: Dict[str, Any] = {
            "slices": int(self.mesh.shape["sub"]),
            "slice_rows": 0, "rows_per_slice": [], "addressable": [],
            "route_flushes": 0, "route_dirty_slices": 0,
            "route_gzone_flushes": 0, "route_rows": 0,
            "full_scatters": 0, "mesh_dispatches": 0,
            "slice_adoptions": 0, "last_route": {},
        }
        for mp, m in self._matchers.items():
            st = getattr(m, "mesh_status", None)
            if st is None:
                continue
            st = st()
            for k in ("route_flushes", "route_dirty_slices",
                      "route_gzone_flushes", "route_rows",
                      "full_scatters", "mesh_dispatches",
                      "slice_adoptions"):
                agg[k] += st.get(k, 0)
            if mp == "" or not agg["rows_per_slice"]:
                agg["slice_rows"] = st.get("slice_rows", 0)
                agg["rows_per_slice"] = st.get("rows_per_slice", [])
                agg["addressable"] = st.get("addressable", [])
                agg["last_route"] = st.get("last_route", {})
        return agg

    def adopt_slices(self, slice_ids, epoch) -> int:
        """Slice-map adoption fan-in: replay newly-owned slices' rows on
        every mountpoint's mesh matcher (exactly once per adoption token;
        the seat guards). Returns total rows marked."""
        total = 0
        for m in self._matchers.values():
            fn = getattr(m, "adopt_slices", None)
            if fn is not None:
                total += fn(slice_ids, epoch)
        return total

    def close(self) -> None:
        """Close every mountpoint's matcher (:meth:`GpuMatcher.close`)."""
        for m in self._matchers.values():
            m.close()


class BatchCollector:
    """Coalesce concurrent publishes into device calls.

    Publishes arriving within ``window_us`` (or until ``max_batch``) are
    matched together; each caller's future resolves to its own match rows,
    in submission order. Two flushes run at once (``MAX_INFLIGHT``); under
    load up to ``super_batch_k`` full windows ride one
    :meth:`GpuRegView.fold_many`. Whenever the device cannot answer
    promptly — a flush of at most ``host_threshold`` publishes, overload,
    an expired item, a dispatch past ``dispatch_deadline_ms`` under the
    ``watchdog``, a lock busy past ``lock_busy_shed_ms``, a rebuild or an
    open breaker — the registry's trie serves instead, with identical
    results; each such publish is counted (``*_host_pubs``), and an
    expired or stalled one is logged as a warning too. A kernel fault (``KernelError``) reaches the futures as an
    error. With a ``filter_engine`` every flush's matched fanout runs the
    payload-predicate phase before the futures settle, on every shed path
    too; a fault of the phase's kernel fails the flush's futures. A view
    with ``fold_meta_capable`` (the worker's match-service stub) fills a
    ``meta_box`` with the ring stamps of a traced flush."""

    #: device calls allowed in flight at once: two slots double-buffer the
    #: pipeline (batch N+1's host encode overlaps batch N's device work)
    MAX_INFLIGHT = 2

    def __init__(self, view, window_us: int = 200, max_batch: int = 4096,
                 host_threshold: int = 0, lock_busy_shed_ms: int = 500,
                 super_batch_k: int = 8, latency_budget_ms: float = 50.0,
                 watchdog=None, dispatch_deadline_ms: float = 0.0,
                 item_expiry_ms: float = 0.0, filter_engine=None):
        self.view = view
        # payload-filter engine (filters/engine.py): when set, each
        # flush's matched fanout runs the predicate phase before the
        # futures settle, and every trie-served publish is filtered too.
        # None touches nothing on any path.
        self.filter_engine = filter_engine
        # stall watchdog: with a deadline set, device flushes run as
        # SACRIFICIAL dispatches — the await is released at the deadline
        # (StallAbandoned: the trie serves, the breaker is fed) and the
        # late result is discarded. item_expiry_ms bounds the QUEUED tail
        # the same way. 0 disables either bound.
        self.watchdog = watchdog
        self.dispatch_deadline = dispatch_deadline_ms / 1e3
        self.item_expiry = item_expiry_ms / 1e3
        self.stalled_host_pubs = 0  # trie-served after an abandon
        self.expired_host_pubs = 0  # trie-served past item expiry
        self._late_logged = float("-inf")  # last _log_late warning
        self._expiry_handle: Optional[asyncio.TimerHandle] = None
        self.window = window_us / 1e6
        self.max_batch = max_batch
        # under load (more than one full window queued) up to this many
        # windows coalesce into ONE device dispatch; 1 disables
        self.super_batch_k = max(1, super_batch_k)
        self.super_batches = 0      # multi-window dispatches
        self.super_batch_pubs = 0   # publishes that rode one
        # bounded head-of-line blocking: a flush waits at most this long
        # for the matcher lock before the whole flush serves from the
        # trie. 0 disables.
        self.lock_busy_shed_ms = lock_busy_shed_ms
        # hybrid dispatch: a flush this small is served by the host trie on
        # the event loop — no device round trip, no executor hop (0, the
        # default, sends every flush to the device)
        self.host_threshold = host_threshold
        self.host_hybrid_pubs = 0
        self.saturated_merges = 0  # flushes deferred into a later batch
        self.overload_host_pubs = 0  # shed to the trie at overload
        # whole-flush latency EWMA (ms) and its budget: the device-path
        # pressure signal (robustness/overload.py)
        self.latency_budget_ms = latency_budget_ms
        self.dispatch_ewma_ms = 0.0
        self.rebuild_host_pubs = 0  # trie-served during a rebuild
        self.busy_host_pubs = 0  # trie-served past the lock bound
        self.degraded_host_pubs = 0  # trie-served while the breaker is open
        self._pending: List[tuple] = []
        self._flush_handle: Optional[asyncio.TimerHandle] = None
        self._inflight = 0
        # submission-order release queue: a future's caller sees its
        # result only after every EARLIER submission settled, with two
        # device batches racing in the pipeline or results coming from a
        # host shed path
        self._order: collections.deque = collections.deque()

    def pressure(self) -> float:
        """Device-path pressure in [0, 1]: queue depth against the overload
        shed bound (``super_batch_k`` windows) fused with the latency
        EWMA (``overload.collector_pressure``)."""
        return collector_pressure(
            len(self._pending), self.max_batch * max(1, self.super_batch_k),
            self.dispatch_ewma_ms, self.latency_budget_ms)

    def _many_capable(self, mountpoint: str) -> bool:
        """Can this mountpoint's flushes ride as super-batches now? Gated
        on the matcher's K-batch path, so K windows are never fed to a
        matcher that would serialize them."""
        if self.super_batch_k <= 1 or not hasattr(self.view, "fold_many"):
            return False
        probe = getattr(self.view, "supports_many", None)
        if probe is None:
            return True  # simple stand-in views: seam presence is the gate
        try:
            return bool(probe(mountpoint))
        except Exception:
            return False

    def _enqueue_fut(self, loop) -> asyncio.Future:
        fut = loop.create_future()
        fut._vmq_ready = False  # type: ignore[attr-defined]
        fut._vmq_res = None  # type: ignore[attr-defined]
        fut._vmq_exc = None  # type: ignore[attr-defined]
        self._order.append(fut)
        return fut

    def _settle(self, fut, res=None, exc=None) -> None:
        """Record a future's result and release the head run of settled
        futures in submission order."""
        fut._vmq_ready = True
        fut._vmq_res = res
        fut._vmq_exc = exc
        order = self._order
        while order and order[0]._vmq_ready:
            f = order.popleft()
            if f.done():  # cancelled by the caller
                continue
            if f._vmq_exc is not None:
                f.set_exception(f._vmq_exc)
            else:
                f.set_result(f._vmq_res)
            f._vmq_res = f._vmq_exc = None

    def _settle_via_trie(self, mp: str, topic, fut,
                         fallback_exc: Optional[BaseException] = None,
                         feat=None) -> None:
        """Serve one publish from the host trie and settle its future;
        without a registry the original cause reaches the caller. The
        payload-predicate phase applies here too (exact host evaluator),
        so a shed publish delivers the same filtered fanout."""
        reg = getattr(self.view, "registry", None)
        if reg is None:
            self._settle(fut, exc=fallback_exc
                         or RuntimeError("no registry for trie fallback"))
            return
        try:
            rows = reg.trie(mp).match(list(topic))
            eng = self.filter_engine
            if eng is not None and eng.wants(mp):
                rows = eng.filter_single(mp, topic, feat, list(rows))
            self._settle(fut, res=rows)
        except Exception as e:
            self._settle(fut, exc=e)

    def _log_late(self, n: int, why: str) -> None:
        """Publishes the device path was too slow for (``why``: expired
        in the queue, or a stalled dispatch) went to the trie: say so, at
        most once a second, beside the counters."""
        now = time.monotonic()
        if now - self._late_logged >= 1.0:
            self._late_logged = now
            log.warning("%d publish(es) %s: answered by the host trie "
                        "(%d expired, %d stalled in all)", n, why,
                        self.expired_host_pubs, self.stalled_host_pubs)

    def submit(self, mountpoint: str, topic: Sequence[str],
               trace=None, feat=None) -> asyncio.Future:
        """Queue one publish; the future resolves to its match rows.
        ``trace``: a flight-recorder trace (observability/recorder.py),
        stamped at submit, dequeue and match. ``feat``: the publish's
        payload feature row (``FilterEngine.encode``) for the predicate
        phase; None for unfiltered mountpoints."""
        loop = asyncio.get_event_loop()
        fut = self._enqueue_fut(loop)
        if (self._inflight >= self.MAX_INFLIGHT
                and len(self._pending) >= self.max_batch
                and len(self._pending) >= self.max_batch * (
                    self.super_batch_k
                    if self._many_capable(mountpoint) else 1)):
            # overload: both slots busy AND a full super-batch already
            # waiting. Match on the exact trie now instead of queueing
            # unboundedly; the result still releases in submission order.
            # Below the bound, queued publishes coalesce into one K-window
            # dispatch when a slot frees.
            if getattr(self.view, "registry", None) is not None:
                self.overload_host_pubs += 1
                self._settle_via_trie(mountpoint, topic, fut, feat=feat)
                return fut
        now_sub = time.monotonic()
        exp = now_sub + self.item_expiry if self.item_expiry > 0 else None
        if trace is not None:
            trace.stamp("submit")
        self._pending.append((mountpoint, tuple(topic), fut, exp, now_sub,
                              trace, feat))
        if exp is not None and self._expiry_handle is None:
            # the expiry sweep fires even when no flush can (both slots
            # wedged): the queued-tail bound
            self._expiry_handle = loop.call_later(self.item_expiry,
                                                  self._expire_sweep)
        if len(self._pending) >= self.max_batch:
            if self._flush_handle is not None:
                self._flush_handle.cancel()
                self._flush_handle = None
            self._flush()
        elif self._flush_handle is None:
            self._flush_handle = loop.call_later(self.window, self._flush)
        return fut

    def submit_batch(self, mountpoint: str,
                     topics: Sequence[Sequence[str]]) -> "asyncio.Future":
        """Submit a pre-batched group of publishes; resolves to the list of
        per-topic row lists, in submission order. The publishes coalesce in
        the same queue as single submissions."""
        futs = [self.submit(mountpoint, t) for t in topics]
        return asyncio.gather(*futs)

    #: expired items settled per sweep callback: the sweep runs on the
    #: loop, so a large backlog drains across loop iterations
    _EXPIRE_CHUNK = 256

    def _expire_sweep(self) -> None:
        """Anything pending past its expiry is answered by the exact trie
        now; release order is preserved by _settle."""
        self._expiry_handle = None
        if not self._pending:
            return
        now = time.monotonic()
        settled = 0
        keep = []
        for item in self._pending:
            mp, topic, fut, exp = item[:4]
            if (exp is not None and now >= exp
                    and settled < self._EXPIRE_CHUNK):
                self.expired_host_pubs += 1
                self._settle_via_trie(mp, topic, fut, feat=item[6])
                settled += 1
            else:
                keep.append(item)
        self._pending = keep
        if settled:
            self._log_late(settled, "expired in the collector queue")
        if self._pending and self._pending[0][3] is not None:
            delay = (0.0 if now >= self._pending[0][3]  # chunk remainder
                     else max(0.005, self._pending[0][3] - now))
            self._expiry_handle = asyncio.get_event_loop().call_later(
                delay, self._expire_sweep)

    def _flush(self) -> None:
        self._flush_handle = None
        if not self._pending:
            return
        reg = getattr(self.view, "registry", None)
        if len(self._pending) <= self.host_threshold and reg is not None:
            pending, self._pending = self._pending, []
            self.host_hybrid_pubs += len(pending)
            for mp, topic, fut, _exp, _t_sub, _trace, feat in pending:
                self._settle_via_trie(mp, topic, fut, feat=feat)
            return
        if self._inflight >= self.MAX_INFLIGHT:
            # both slots busy: leave the items pending so late arrivals
            # coalesce into one bigger batch; _on_done flushes the moment
            # a slot frees
            self.saturated_merges += 1
            return
        take = self.max_batch
        if (len(self._pending) > self.max_batch
                and self._many_capable(self._pending[0][0])):
            # more than one full window queued: ship up to super_batch_k
            # windows as ONE device dispatch
            take = min(len(self._pending),
                       self.max_batch * self.super_batch_k)
        pending, self._pending = self._pending[:take], self._pending[take:]
        self._inflight += 1
        task = asyncio.get_event_loop().create_task(
            self._flush_async(pending))
        task.add_done_callback(self._on_done)

    def _on_done(self, task) -> None:
        self._inflight -= 1
        if task.cancelled():
            return
        exc = task.exception()
        if exc is not None:  # futures already got the error; log path
            log.warning("batch flush task failed: %s", exc)
        if self._pending:
            # back-to-back dispatch keeps the device busy
            if self._flush_handle is not None:
                self._flush_handle.cancel()
                self._flush_handle = None
            self._flush()

    async def _settle_items_via_trie(self, mp, items, exc) -> None:
        """Serve a flush's items from the trie, yielding to the loop every
        64 (trie reads stay on the loop, where the trie is mutated)."""
        for i, (t_, fut, feat) in enumerate(items):
            self._settle_via_trie(mp, t_, fut, fallback_exc=exc, feat=feat)
            if (i + 1) % 64 == 0:
                await asyncio.sleep(0)

    async def _flush_async(self, pending) -> None:
        """Run the device call off the loop (an executor thread, or a
        sacrificial one under the watchdog): blocking the loop would stall
        every session's IO."""
        loop = asyncio.get_event_loop()
        flush_t0 = time.perf_counter()
        # group by mountpoint; items that expired while queued go to the
        # exact trie instead of riding a device dispatch
        now = time.monotonic()
        by_mp: Dict[str, List[Tuple[Tuple[str, ...], asyncio.Future,
                                    Any]]] = {}
        traces_mp: Dict[str, list] = {}
        expired = []
        oldest_sub = None
        for mp, topic, fut, exp, t_sub, trace, feat in pending:
            if exp is not None and now >= exp:
                expired.append((mp, topic, fut, feat))
            else:
                by_mp.setdefault(mp, []).append((topic, fut, feat))
                if oldest_sub is None or t_sub < oldest_sub:
                    oldest_sub = t_sub
                if trace is not None:
                    trace.stamp("dequeue")
                    traces_mp.setdefault(mp, []).append(trace)
        if oldest_sub is not None:
            obs.observe("stage_collector_wait_ms", (now - oldest_sub) * 1e3)
        if expired:
            self.expired_host_pubs += len(expired)
            self._log_late(len(expired), "expired in the collector queue")
        for i, (mp, t_, fut, feat) in enumerate(expired):
            self._settle_via_trie(mp, t_, fut, feat=feat)
            if (i + 1) % 64 == 0:
                await asyncio.sleep(0)
        for mp, items in by_mp.items():
            topics = [t for t, _, _ in items]
            self.view.matcher(mp)  # first load on the loop thread
            lock_to = (self.lock_busy_shed_ms / 1e3
                       if self.lock_busy_shed_ms else None)
            # flight-recorder envelope: when a sampled publish rides
            # this flush and the view can report fold meta (the
            # match-service client's cross-process ring stamps), hand
            # the fold a box to fill — the executor thread writes it,
            # the loop reads it after the await
            mtraces = traces_mp.get(mp)
            meta_box = ({} if mtraces
                        and getattr(self.view, "fold_meta_capable", False)
                        else None)
            view = self.view
            if meta_box is not None:
                fold_many_fn = (lambda m, c, lt, _mb=meta_box:
                                view.fold_many(m, c, lt, meta_out=_mb))
                fold_batch_fn = (lambda m, t, lt, _mb=meta_box:
                                 view.fold_batch(m, t, lt, meta_out=_mb))
            else:
                fold_many_fn = getattr(view, "fold_many", None)
                fold_batch_fn = view.fold_batch
            chunks = ([topics[i:i + self.max_batch]
                       for i in range(0, len(topics), self.max_batch)]
                      if len(topics) > self.max_batch
                      and self._many_capable(mp) else None)
            wd = self.watchdog
            sacrificial = wd is not None and self.dispatch_deadline > 0
            try:
                if chunks:
                    if sacrificial:
                        nested = await wd.dispatch_async(
                            "device.dispatch",
                            lambda m=mp, c=chunks, lt=lock_to:
                                fold_many_fn(m, c, lt),
                            self.dispatch_deadline,
                            label=f"fold_many:{mp or '(default)'}")
                    else:
                        nested = await loop.run_in_executor(
                            None, fold_many_fn, mp, chunks, lock_to)
                    results = [rows for batch in nested for rows in batch]
                    # counted only on success: a shed super-batch served
                    # elsewhere must not read as a fused dispatch
                    self.super_batches += 1
                    self.super_batch_pubs += len(topics)
                elif sacrificial:
                    results = await wd.dispatch_async(
                        "device.dispatch",
                        lambda m=mp, t=topics, lt=lock_to:
                            fold_batch_fn(m, t, lt),
                        self.dispatch_deadline,
                        label=f"fold_batch:{mp or '(default)'}")
                else:
                    results = await loop.run_in_executor(
                        None, fold_batch_fn, mp, topics, lock_to)
            except StallAbandoned as sa:
                # deadline overrun: a device failure for the breaker; THIS
                # flush is served by the trie, the late result discarded
                self.stalled_host_pubs += len(items)
                self._log_late(len(items), "rode a dispatch that stalled "
                               "past its deadline")
                m = (self.view.matcher(mp)
                     if hasattr(self.view, "matcher") else None)
                if m is not None and hasattr(m, "record_stall"):
                    m.record_stall(sa)
                await self._settle_items_via_trie(mp, items, sa)
                continue
            except (RebuildInProgress, MatcherBusy, DeviceDegraded) as rb:
                # the device can't take this batch promptly — a rebuild, a
                # busy lock, or an open breaker (a later flush is the
                # half-open probe): the trie serves, identical results
                if isinstance(rb, DeviceDegraded):
                    self.degraded_host_pubs += len(items)
                elif isinstance(rb, MatcherBusy):
                    self.busy_host_pubs += len(items)
                else:
                    self.rebuild_host_pubs += len(items)
                await self._settle_items_via_trie(mp, items, rb)
                continue
            except Exception as e:  # a kernel fault, a bug: the futures fail
                for _, fut, _feat in items:
                    self._settle(fut, exc=e)
                continue
            # the payload-predicate phase behind topic match, skipped at
            # one dict probe when the mountpoint carries no predicates; a
            # wedged phase is abandoned at the same dispatch deadline and
            # the host evaluator serves
            eng = self.filter_engine
            if eng is not None:
                if not eng.wants(mp):
                    eng.note_skip()
                else:
                    tf = [(t, feat) for t, _fut, feat in items]
                    try:
                        if sacrificial:
                            results = await wd.dispatch_async(
                                "device.predicate",
                                lambda m=mp, x=tf, r=results:
                                    eng.filter_batch(m, x, r),
                                self.dispatch_deadline,
                                label=f"predicate:{mp or '(default)'}")
                        else:
                            results = await loop.run_in_executor(
                                None, eng.filter_batch, mp, tf, results)
                    except StallAbandoned as sa:
                        eng.record_stall(sa)
                        results = await loop.run_in_executor(
                            None, eng.filter_batch_host, mp, tf, results)
                    except Exception as e:  # a fault of the phase's kernel
                        for _, fut, _feat in items:
                            self._settle(fut, exc=e)
                        continue
            for tr in mtraces or ():
                tr.stamp("match")
                if meta_box:
                    tr.meta = meta_box
            for (_, fut, _feat), rows in zip(items, results):
                self._settle(fut, res=rows)
        # the pressure EWMA: whole-flush service time (shed and degraded
        # paths included — a slow fallback is pressure too)
        self.dispatch_ewma_ms = fold_latency_ewma(
            self.dispatch_ewma_ms, (time.perf_counter() - flush_t0) * 1e3)
