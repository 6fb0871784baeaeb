"""GPU-resident retained-message index: the serving half of the retained
reverse-match engine (the port of ``vernemq_tpu/retained/index.py``).

:class:`RetainedIndex` owns a :class:`~.table.RetainedTopicTable`, mirrors
it to the device (full upload on growth, fused scatter delta otherwise —
the forward matcher's mutation discipline), and serves ``match_filters``:
B subscription filters against N retained-topic rows in ONE dispatch
(``ops/reverse_kernel.reverse_match``, through the hand kernel of
``ops/reverse_tiles.py``). :class:`RetainedEngine` holds one index per
mountpoint and is the write-through target of ``RetainStore``'s dirty hook.

Degradation contract (identical posture to ``GpuMatcher``):

- the device path sits behind a :class:`CircuitBreaker` — repeated
  dispatch failures (or an injected ``device.retained`` fault) open it
  and every replay serves from the exact host walk
  (``RetainStore.match_filter``, the correctness oracle) until a
  half-open probe succeeds;
- a capacity rebuild at scale re-uploads in the background
  (``RebuildInProgress`` → host walk serves meanwhile);
- per-filter escapes (fanout > k, untiled leftovers, filters the device
  cannot represent) come back as ``None`` rows — the caller resolves
  those exactly against the store. The device never returns a wrong or
  partial replay;
- a kernel that refuses its inputs or fails to launch, and a CUDA fault of
  the device path, raise :class:`~..ops.tile_match.KernelError` to the
  caller: never the breaker, never the host walk (a fault of the code,
  not of the device's load; the fault is sticky, so every later sync
  raises it too).

Departures from the reference, on purpose: the device holds the rows and
their meta word only (no coded dense operand ``G_t``: both phases run the
compare kernel, so the reference's ``dense_mode`` choice between its coded
and compare variants has no counterpart); the delta scatter is an
in-place ``index_copy_`` without the power-of-two padding (eager PyTorch
compiles nothing per shape); and the first device build runs one reverse
dispatch, results discarded, so CUDA loads the path's kernel modules
before the first replay flush.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..broker import heap
from ..device import DeviceLike, resolve_device
from ..models.matcher import (
    DeviceDegraded, RebuildInProgress, _is_cuda_fault,
    load_kernels, prepare_windows,
)
from ..ops import reverse_kernel as RK
# imported for their binders: load_kernels(KERNEL_LIBS) loads the libraries
from ..ops import extract, reverse_tiles  # noqa: F401
from ..ops.tile_match import KernelError
from ..protocol.topic import match_dollar_aware
from ..robustness import faults
from ..robustness import watchdog as watchdog_mod
from ..robustness.breaker import CircuitBreaker
from .table import RetainedTopicTable

log = logging.getLogger("vernemq_tpu_torch.retained")

Match = Tuple[Tuple[str, ...], Any]

#: the kernel libraries (``ops/_build.py`` names) the reverse match
#: launches, built and loaded when an index or engine is created on CUDA (a
#: build error raises there)
KERNEL_LIBS = ("reverse_match", "extract")


def _probe_tile(per_region_max: int) -> int:
    """Probe tile width: every query of the busiest region in one tile (a
    multiple of the kernel's warp of slots, at most its ``MAX_TILE``); the
    kernel skips a warp of empty slots, so a wider tile costs no compare."""
    return min(RK.MAX_TILE, -(-max(1, per_region_max) // RK.TILE_QUERIES)
               * RK.TILE_QUERIES)


class RetainedIndex:
    """``device`` defaults to the CUDA card and raises without one; pass
    ``device="cpu"`` to run the plain PyTorch path. On CUDA the kernel
    library is built and loaded here."""

    def __init__(self, store, mountpoint: str = "", max_levels: int = 16,
                 initial_capacity: int = 2048, max_fanout: int = 256,
                 device: DeviceLike = None,
                 breaker: Optional[CircuitBreaker] = None,
                 breaker_enabled: bool = True,
                 watchdog=None, rebuild_deadline_s: float = 120.0):
        self.store = store            # host RetainStore (oracle + warm load)
        self.mountpoint = mountpoint
        self.table = RetainedTopicTable(max_levels, initial_capacity)
        self.max_fanout = max_fanout
        self.device = resolve_device(device)
        load_kernels(self.device, KERNEL_LIBS)
        # guards table mutation (event loop) vs sync/match (executor)
        self.lock = threading.Lock()
        self._dev: Optional[Tuple] = None  # (row_words, meta)
        self.warm_ms: Optional[float] = None  # the first build's warm-up
        # the first CUDA fault of the device path: the context is unusable
        # from then on, so every later sync raises it as KernelError
        self._cuda_fault: Optional[BaseException] = None
        self._ops_bits = 0
        self._entries_snapshot: Optional[np.ndarray] = None
        self._overflow_snapshot: Tuple = ()
        self._reg_start: Optional[np.ndarray] = None
        self._reg_end: Optional[np.ndarray] = None
        self._bucket_max = 0
        self._NB = 1
        self._inflight = 0  # dispatched matches holding the device arrays
        # background growth rebuild (RebuildInProgress → host walk serves);
        # bare indexes in benches/tests time the inline path instead
        self.async_rebuild = True
        self._rebuild_thread: Optional[threading.Thread] = None
        # stall watchdog (robustness/watchdog.py): background rebuilds
        # register a monitored op; past rebuild_deadline_s the build is
        # abandoned (breaker fed, late install discarded) instead of
        # shedding RebuildInProgress silently forever
        self.watchdog = watchdog
        self.rebuild_deadline_s = rebuild_deadline_s
        self._rebuild_token: Optional[dict] = None
        self.rebuild_abandons = 0
        self.dispatch_stalls = 0  # abandoned dispatches (record_stall)
        # wildcard-first filters need a full-table dense pass; on the CPU
        # the host retain trie serves them better (it narrows on their
        # concrete deeper levels), so "auto" routes them host-side on the
        # cpu device and on-device on the card
        self.dense_policy = "auto"    # auto | device | host
        # device-extraction fanout cap: the extraction's cost scales with
        # k. 0 = auto: 64 on the cpu device (queries matching more resolve
        # against the host store — exact, counted), max_fanout on the card.
        self.extract_k = 0
        # hot-filter encode cache (storm batches repeat filters): maps
        # filter -> (row, eff, hh, fw, region); invalidated when the
        # interner or region layout changes
        self._enc_cache: Dict[Tuple[str, ...], tuple] = {}
        self._enc_gen: tuple = (-1, -1, -1)
        self.breaker = (breaker if breaker is not None
                        else (CircuitBreaker(name="retained")
                              if breaker_enabled else None))
        self._closed = False
        # mid-warm-load delta buffer (warm_load_async): non-None while a
        # chunked load is in flight; on_retain writes land here instead
        # of the table so a racing delete cannot be resurrected
        self._load_overrides: Optional[Dict[Tuple[str, ...], Any]] = None
        # gauges (monotonic counts exposed like the tpu_breaker_* family)
        self.match_dispatches = 0
        self.match_queries = 0
        self.host_fallback_queries = 0
        self.rebuilds = 0
        self.rebuilds_async = 0
        self.device_failures = 0
        self.degraded_sheds = 0

    def close(self) -> None:
        """Shut down (the broker's stop): a background rebuild installs and
        respawns no more and is joined — at most ``rebuild_deadline_s``,
        past which the stall watchdog owns it — and the card's queued work
        is waited for, so nothing of this index runs on the device after
        the event loop closes."""
        with self.lock:
            self._closed = True
            th = self._rebuild_thread
        if th is not None:
            th.join(self.rebuild_deadline_s or None)
        if self.device.type == "cuda" and self._cuda_fault is None:
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------ warm load

    def warm_load(self) -> None:
        """Load the current retained set for this mountpoint from the
        host store (the boot warm-load of ``vmq_retain_srv``'s cache,
        here store → device table). Call before serving; deltas arrive
        via :meth:`on_retain` afterwards. Synchronous variant for
        tests/bench/direct embedding — the broker path uses
        :meth:`warm_load_async` so a million-topic load cannot stall
        the event loop."""
        with self.lock:
            for topic, value in self.store.items(self.mountpoint):
                self.table.insert(topic, value)

    async def warm_load_async(self, chunk: int = 8192) -> None:
        """Loop-friendly warm load: the retained snapshot inserts in
        ``chunk``-sized slices with loop yields between them. Deltas
        arriving MID-LOAD (retain set/delete racing the load at chunk
        boundaries) buffer as overrides: a delete of a topic the load
        has not inserted yet must not be resurrected by the later
        insert — overrides supersede snapshot rows and apply last."""
        import asyncio

        with self.lock:
            self._load_overrides = {}
        try:
            items = list(self.store.items(self.mountpoint))
            for c in range(0, len(items), chunk):
                with self.lock:
                    ov = self._load_overrides
                    for topic, value in items[c:c + chunk]:
                        if tuple(topic) in ov:
                            continue  # superseded mid-load
                        self.table.insert(topic, value)
                await asyncio.sleep(0)
        finally:
            with self.lock:
                ov, self._load_overrides = self._load_overrides, None
                for topic, value in ov.items():
                    if value is None:
                        self.table.delete(topic)
                    else:
                        self.table.insert(topic, value)

    def on_retain(self, topic: Sequence[str], value: Any) -> None:
        """Write-through from the retain store's dirty hook:
        ``value=None`` deletes."""
        with self.lock:
            if self._load_overrides is not None:
                self._load_overrides[tuple(topic)] = value
                return
            if value is None:
                self.table.delete(topic)
            else:
                self.table.insert(topic, value)

    # ------------------------------------------------------- device mirror

    def _snapshot_locked(self, copy: bool) -> dict:
        t = self.table
        c = (lambda a: a.copy()) if copy else (lambda a: a)
        entries = np.empty(len(t.entries), dtype=object)
        entries[:] = t.entries
        return {
            "words": c(t.words), "row_len": c(t.row_len),
            "row_dollar": c(t.row_dollar), "active": c(t.active),
            "bits": t.id_bits, "reg_start": t.reg_start.copy(),
            # probe windows cover LIVE extents (slots fill from region
            # starts), not the 2x-headroom caps — scan work tracks rows
            "reg_end": (t.reg_start + t.reg_high).copy(),
            "cap": t.cap,
            "bucket_max": int(t.reg_high[1:].max()) if t.NB else 0,
            "lc": t.max_row_len, "nb": t.NB, "entries": entries,
        }

    def _build_device(self, state: dict) -> Optional[Tuple]:
        """Upload a snapshot's rows and meta words (no lock held on the
        async path). ``device.retained`` covers the upload too — a build
        failure is a device failure. On CUDA it waits for its own work, and
        the first build runs the warm dispatch (:meth:`_warm`)."""
        faults.inject("device.retained")
        if not state["bits"]:
            return None  # uncodable interner: host serves (absurd scale)
        meta = RK.pack_row_meta(state["row_len"], state["row_dollar"],
                                state["active"])
        built = tuple(torch.from_numpy(a).to(self.device, copy=True)
                      for a in (state["words"], meta))
        if self.warm_ms is None:
            self._warm(built, state)
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        return built

    def _warm(self, built: Tuple, state: dict) -> None:
        """The first build's warm-up: one reverse dispatch (a probe tile
        and a dense tile) on the new arrays, results discarded. CUDA loads
        a kernel's module at its first launch; without this the first
        replay flush of a fresh process would pay that for every kernel of
        the path while the replays queued behind it expire to the host
        walk. No fault point, counter or histogram sees it. Records
        ``warm_ms``."""
        t0 = time.monotonic()
        if self.device.type == "cuda":
            n = 8
            layout = {k: state[k] for k in ("reg_start", "reg_end", "nb",
                                            "bucket_max", "cap", "lc")}
            a, _, _, _ = self._prep(
                layout, np.zeros((n, self.table.L), np.int32),
                np.zeros(n, np.int32), np.zeros(n, bool), np.zeros(n, bool),
                np.full(n, -1, np.int32), 0)
            self._device_call(built, a)
            torch.cuda.synchronize(self.device)
        self.warm_ms = (time.monotonic() - t0) * 1e3

    def _install(self, built: Optional[Tuple], state: dict) -> None:
        self._dev = built
        self._ops_bits = state["bits"] if built is not None else 0
        self._reg_start = state["reg_start"]
        self._reg_end = state["reg_end"]
        self._cap = state["cap"]
        self._bucket_max = state["bucket_max"]
        self._lc = state["lc"]
        self._NB = state["nb"]
        self._entries_snapshot = state["entries"]
        self.rebuilds += 1

    def _abandon_rebuild(self, token: dict) -> None:
        """Stall-watchdog ``on_stall``: a wedged background build is
        treated exactly like a failed one — token marked (sync() reaps,
        the late install is discarded), breaker fed so a stalled device
        opens it instead of reading healthy while replays shed forever.
        Monitor-thread context: no index lock taken."""
        if token.get("abandoned"):
            return
        token["abandoned"] = True
        self.rebuild_abandons += 1
        self.device_failures += 1
        br = self.breaker
        if br is not None and br.record_failure():
            log.error("retained device path OPENED: background rebuild "
                      "stalled past its %.1fs deadline (abandoned; host "
                      "retain walk serves)", self.rebuild_deadline_s)

    def record_stall(self, exc: Optional[BaseException] = None) -> None:
        """An abandoned (deadline-overrun) reverse-match dispatch is a
        device failure — feed the breaker (collector-side hook, like
        ``TpuMatcher.record_stall``)."""
        self.dispatch_stalls += 1
        try:
            self._record_device_failure(
                exc if exc is not None
                else RuntimeError("retained dispatch stalled past deadline"))
        except Exception:
            pass

    def _spawn_rebuild_locked(self) -> None:
        state = self._snapshot_locked(copy=True)
        self.table.resized = False
        self.table.dirty.clear()
        self.rebuilds_async += 1
        token = {"abandoned": False}
        self._rebuild_token = token
        wd = self.watchdog
        op = (wd.register("device.retained", self.rebuild_deadline_s,
                          label="retained-rebuild",
                          on_stall=lambda _op: self._abandon_rebuild(token))
              if wd is not None and self.rebuild_deadline_s > 0 else None)

        def _run() -> None:
            try:
                if self._closed:
                    return
                try:
                    built = self._build_device(state)
                except Exception as e:
                    if token["abandoned"]:
                        wd.note_late_discard("device.retained",
                                             "failed after abandonment")
                        return
                    if isinstance(e, KernelError) or _is_cuda_fault(e):
                        # a fault of the code: sync() raises it as
                        # KernelError, the breaker never sees it
                        self._cuda_fault = e
                        return
                    # a failed background build is a DEVICE failure: feed
                    # the breaker so a persistent outage opens it (further
                    # replays shed at the gate instead of respawning a
                    # failing snapshot+upload thread per flush) — without
                    # this the breaker metrics read healthy while the
                    # device path is permanently down
                    self.device_failures += 1
                    br = self.breaker
                    if br is not None and br.record_failure():
                        log.error(
                            "retained device path OPENED after %d "
                            "consecutive failures (background rebuild: "
                            "%s); replays degrade to the host retain walk",
                            br.failure_threshold, e)
                    else:
                        log.exception(
                            "background retained-table rebuild failed; "
                            "will retry from the next sync")
                    return  # sync() reaps the dead thread, re-arms resized
                with self.lock:
                    if self._closed:
                        return  # broker stopped mid-build: don't respawn
                    if token["abandoned"] or self._rebuild_thread is not th:
                        # abandoned by the watchdog (sync may already be
                        # running a fresh build): a late install would
                        # publish stale layout — discard, never deliver
                        if wd is not None:
                            wd.note_late_discard(
                                "device.retained",
                                "stale install discarded")
                        return
                    t = self.table
                    if t.resized or t.id_bits != state["bits"]:
                        self._spawn_rebuild_locked()  # layout moved again
                        return
                    self._install(built, state)
                    self._rebuild_thread = None
                    # under the lock: a sync that sees the install sees
                    # the heap policy's collection done
                    heap.POLICY.settled(f"a retained build of "
                                        f"{self.table.count} rows swapped in")
            finally:
                if op is not None:
                    wd.deregister(op)

        # vmqlint: allow(thread-lifecycle): cooperative stop by design —
        # _run checks _closed/the abandon token before build AND install
        # and discards stale work; a join would park close() behind a
        # possibly-wedged device upload (the watchdog abandons instead)
        th = threading.Thread(target=_run, name="retained-rebuild",
                              daemon=True)
        self._rebuild_thread = th
        th.start()

    def sync(self) -> None:
        """Ship pending table mutations to the device (lock held by the
        caller): full upload after growth/id-width change, fused scatter
        of dirty slots otherwise. Pins the entries snapshot so in-flight
        results resolve against the state that was matched."""
        t = self.table
        bits = t.id_bits
        if self._cuda_fault is not None:
            raise KernelError(
                f"fault on the retained device path: {self._cuda_fault}") \
                from self._cuda_fault
        if self._rebuild_thread is not None:
            tok = self._rebuild_token
            abandoned = tok is not None and tok.get("abandoned")
            if self._rebuild_thread.is_alive() and not abandoned:
                raise RebuildInProgress
            # crashed — or watchdog-abandoned (wedged) — worker: re-arm
            # the full build; a late install discards against its token
            self._rebuild_thread = None
            t.resized = True
        if self._dev is None or t.resized or bits != self._ops_bits:
            if self.async_rebuild:
                # unlike the forward matcher, the FIRST build goes async
                # too: the host walk is always there to serve, and a
                # boot-time million-row build (compile + upload) must
                # not run inline under the lock the loop-side retain
                # write-through takes
                self._spawn_rebuild_locked()
                raise RebuildInProgress
            state = self._snapshot_locked(copy=False)
            self._install(self._build_device(state), state)
            t.resized = False
            t.dirty.clear()
        elif t.dirty and self._dev is not None:
            slots = np.fromiter(t.dirty, dtype=np.int64, count=len(t.dirty))
            t.dirty.clear()
            # copy-on-write: in-flight matches hold the previous snapshot
            snap = self._entries_snapshot.copy()
            for s in slots:
                snap[s] = t.entries[s]
            self._entries_snapshot = snap
            try:
                self._apply_delta(slots)
            except Exception:
                # dirty already consumed but the scatter did not land:
                # re-arm the full rebuild so host/device re-converge
                t.resized = True
                raise
            # delta-inserted rows may extend a region's live extent (or
            # deepen the topic population): refresh the window view so
            # probes keep covering every live row
            self._reg_end = (t.reg_start + t.reg_high).copy()
            self._bucket_max = int(t.reg_high[1:].max())
            self._lc = t.max_row_len
        # overflow topics live host-side only; refresh their snapshot on
        # every sync (they carry no dirty slots)
        self._overflow_snapshot = tuple(t.overflow.items())

    def _apply_delta(self, slots: np.ndarray) -> None:
        faults.inject("device.retained")
        t = self.table
        d_meta = RK.pack_row_meta(t.row_len[slots], t.row_dollar[slots],
                                  t.active[slots])
        put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(
            self.device)
        # in place, unless a match outside the lock still reads the arrays
        fn = (RK.retained_apply_delta if self._inflight == 0
              else RK.retained_apply_delta_copy)
        self._dev = fn(*self._dev, put(slots), put(t.words[slots]),
                       put(d_meta))

    # ----------------------------------------------------------- breaker

    def _breaker_gate(self) -> bool:
        br = self.breaker
        if br is None:
            return False
        if not br.allow():
            self.degraded_sheds += 1
            raise DeviceDegraded("retained device circuit open")
        return br.state_name == "half_open"

    def _record_device_failure(self, exc: BaseException) -> None:
        """Feed a device dispatch/upload failure to the breaker and raise
        DeviceDegraded (the host walk serves the batch). A kernel refusal
        or a CUDA fault is neither: it raises as KernelError, and so does
        every later sync."""
        if isinstance(exc, KernelError):
            raise exc
        if _is_cuda_fault(exc):
            self._cuda_fault = exc
            raise KernelError(
                f"CUDA fault on the retained device path: {exc}") from exc
        self.device_failures += 1
        br = self.breaker
        if br is None:
            raise exc
        if watchdog_mod.current_op_abandoned():
            # late error of an abandoned dispatch: the stall already fed
            # the breaker (record_stall) — don't double-count
            raise DeviceDegraded(
                f"late failure of abandoned dispatch: {exc!r}") from exc
        if br.record_failure():
            log.error("retained device path OPENED after %d consecutive "
                      "failures (last: %s); replays degrade to the host "
                      "retain walk", br.failure_threshold, exc)
        raise DeviceDegraded(
            f"retained dispatch failed: {exc!r}") from exc

    def _record_device_success(self) -> None:
        br = self.breaker
        if br is None:
            return
        if watchdog_mod.current_op_abandoned():
            return  # stale verdict: only a live probe may close it
        if br.record_success():
            log.warning("retained device path recovered (probe succeeded "
                        "after %.1fs degraded)", br.time_degraded())

    # ------------------------------------------------------------- match

    @staticmethod
    def _pad_batch(n: int) -> int:
        b = 8
        while b < n:
            b *= 2
        return b

    def match_filters(self, filters: Sequence[Sequence[str]],
                      ) -> List[Optional[List[Match]]]:
        """Reverse-match a batch of subscription filters against the
        device table. Returns one entry per filter: the matched
        ``(topic, value)`` rows, or ``None`` when the device could not
        serve that filter exactly (fanout > k, window overflow, filter
        unrepresentable) — the caller resolves ``None`` against the host
        store. Raises :class:`DeviceDegraded` / :class:`RebuildInProgress`
        when the whole batch must be host-served."""
        if not filters:
            return []
        if self._closed:
            # stopped broker: a straggler flush serves the host walk
            raise DeviceDegraded("retained index closed")
        probe = self._breaker_gate()
        try:
            return self._match_impl(filters)
        except BaseException:
            if probe:
                self.breaker.probe_aborted()
            raise

    def _layout_locked(self) -> dict:
        """The table layout the device arrays were built from, pinned under
        the lock with them (window prep outside the lock reads this)."""
        return dict(reg_start=self._reg_start, reg_end=self._reg_end,
                    nb=self._NB, bucket_max=self._bucket_max, cap=self._cap,
                    lc=self._lc)

    def _encode_locked(self, filters):
        """Encode a batch of filters (lock held): ``(qw, qe, qh, qf,
        region)`` padded to the batch ladder. The encode runs UNDER the
        lock (the forward matcher's discipline): regions must be consistent
        with the table state sync() just installed — encoding against a
        layout a concurrent rebuild produced would probe the wrong windows.
        The hold is bounded: steady-state storms hit the encode cache."""
        n = len(filters)
        L = self.table.L
        Bpad = self._pad_batch(n)
        qw = np.full((Bpad, L), RK.PAD_ID, dtype=np.int32)
        qe = np.zeros(Bpad, dtype=np.int32)
        qh = np.zeros(Bpad, dtype=bool)
        qf = np.zeros(Bpad, dtype=bool)
        region = np.full(n, -1, dtype=np.int32)
        t = self.table
        # layout_gen: a rebuild re-ranks the dedicated word->region map
        # even when NBD/NBH stay put — cached regions would silently probe
        # the wrong window otherwise
        gen = (len(t.interner), t.layout_gen)
        if self._enc_gen != gen:
            self._enc_cache.clear()
            self._enc_gen = gen
        cache = self._enc_cache
        for i, fw in enumerate(filters):
            enc = cache.get(fw)
            if enc is None:
                enc = cache[fw] = t.encode_filter(fw)
                if len(cache) > (1 << 20):  # adversarial streams
                    self._enc_cache = cache = {fw: enc}
            row, eff, hh, first_wild, reg = enc
            if row is not None:
                qw[i] = row
            qe[i], qh[i], qf[i] = eff, hh, first_wild
            region[i] = reg
        return qw, qe, qh, qf, region

    def _match_impl(self, filters) -> List[Optional[List[Match]]]:
        filters = [tuple(f) for f in filters]
        n = len(filters)
        with self.lock:
            try:
                self.sync()
            except (RebuildInProgress, KernelError):
                raise
            except Exception as e:
                self._record_device_failure(e)
            dev = self._dev
            if dev is None:
                return [None] * n  # uncodable: host walk serves
            snapshot = self._entries_snapshot
            overflow_snap = self._overflow_snapshot
            layout = self._layout_locked()
            qw, qe, qh, qf, region = self._encode_locked(filters)
            self._inflight += 1
        try:
            out, q_dense_pos, host, k_used = self._dispatch(
                dev, layout, qw, qe, qh, qf, region, n)
        except KernelError:
            raise
        except Exception as e:
            self._record_device_failure(e)
        else:
            self._record_device_success()
        finally:
            with self.lock:
                self._inflight -= 1
        self.match_dispatches += 1
        self.match_queries += n
        idx, valid, cnt, didx, dvalid, dcnt = out
        # vectorized resolve: ONE fancy index over the pinned snapshot
        # for every tiled query's matches (per-query numpy calls cost
        # ~2µs each — at storm batch sizes that was half the host time).
        # A matched slot's snapshot entry is never None: the device
        # active bit and the snapshot come from the same sync.
        counts = valid.sum(axis=1)
        offs = np.concatenate([[0], np.cumsum(counts)])
        flat_ids = idx[valid]
        ents_flat = (snapshot[flat_ids] if flat_ids.size
                     else np.empty(0, dtype=object))
        results: List[Optional[List[Match]]] = []
        for i, fw in enumerate(filters):
            if i in host:
                self.host_fallback_queries += 1
                results.append(None)
                continue
            if region[i] == 0:
                j = q_dense_pos[i]
                c = int(dcnt[j])
                if c > k_used:
                    self.host_fallback_queries += 1
                    results.append(None)
                    continue
                rows = list(snapshot[didx[j][dvalid[j]]])
            else:
                if int(cnt[i]) > k_used:
                    self.host_fallback_queries += 1
                    results.append(None)
                    continue
                rows = ents_flat[offs[i]:offs[i + 1]].tolist()
            if overflow_snap:
                for topic, value in overflow_snap:
                    # >L-level topics live host-side; a '#'-suffixed
                    # (or long) filter can still reach them
                    if match_dollar_aware(list(topic), list(fw)):
                        rows.append((topic, value))
            results.append(rows)
        return results

    def _prep(self, layout: dict, qw, qe, qh, qf, region, n):
        """Host prep of one dispatch against the pinned ``layout``: route
        the filters (probe tiles, dense slots, host), pack the probe tiles
        and size the windows. Returns ``(args, q_dense_pos, host, k_used)``:
        ``args`` holds :func:`RK.reverse_match`'s inputs as numpy arrays
        (``t_start`` stays on the host) and its ``k``, ``seg``, ``lc``."""
        reg_start, reg_end = layout["reg_start"], layout["reg_end"]
        NB, cap = layout["nb"], layout["cap"]
        Bpad = qw.shape[0]
        host = {i for i in range(n) if region[i] < 0}
        conc = [i for i in range(n) if region[i] > 0]
        dense = [i for i in range(n) if region[i] == 0]
        if dense and (self.dense_policy == "host"
                      or (self.dense_policy == "auto"
                          and self.device.type == "cpu")):
            # wildcard-first filters: the host trie narrows on their
            # concrete deeper levels, which a level-0-bucketed dense
            # scan cannot — on the cpu device route them host-side
            # (exact, counted); on the card the dense compare kernel
            # serves them on-device
            host.update(dense)
            dense = []
        # a probe window spans the widest live region, in whole chunks
        seg = min(-(-max(1, layout["bucket_max"]) // RK.CHUNK) * RK.CHUNK,
                  cap)
        q_tile = np.full(Bpad, -1, dtype=np.int32)
        q_pos = np.zeros(Bpad, dtype=np.int32)
        if conc:
            cidx = np.asarray(conc, dtype=np.int32)
            TP = _probe_tile(int(np.bincount(region[cidx]).max()))
            budget = min(len(conc), NB) + -(-len(conc) // TP) + 2
            (t_sel, t_start, tile_of, pos_of,
             leftovers) = prepare_windows(
                region[cidx], len(conc), reg_start, reg_end, cap, budget,
                seg, tp=TP)
            for j in leftovers:
                host.add(int(cidx[j]))
                tile_of[j] = -1
            # launch the tiles in use only; tile selectors index the
            # CONCRETE sub-batch: remap to full batch indices, and mark
            # the slots no query took empty (-1: the kernel skips them)
            tiled = tile_of >= 0
            used = int(tile_of.max()) + 1 if tiled.any() else 1
            live = np.zeros((used, TP), dtype=bool)
            live[tile_of[tiled], pos_of[tiled]] = True
            t_sel = np.where(live, cidx[t_sel[:used]], -1).astype(np.int32)
            t_start = t_start[:used]
            q_tile[cidx] = tile_of
            q_pos[cidx] = pos_of
        else:
            t_sel = np.full((1, RK.TILE_QUERIES), -1, dtype=np.int32)
            t_start = np.zeros(1, dtype=np.int32)
        BW = -(-max(1, len(dense)) // RK.TILE_QUERIES) * RK.TILE_QUERIES
        d_sel = np.zeros(BW, dtype=np.int32)
        d_valid = np.zeros(BW, dtype=bool)
        q_dense_pos = np.full(n, -1, dtype=np.int32)
        for j, i in enumerate(dense):
            d_sel[j] = i
            d_valid[j] = True
            q_dense_pos[i] = j
        k_used = self.extract_k or (64 if self.device.type == "cpu"
                                    else self.max_fanout)
        k_used = min(k_used, self.max_fanout)
        args = dict(qw=qw, qe=qe, qh=qh, qf=qf, t_sel=t_sel,
                    t_start=t_start, q_tile=q_tile, q_pos=q_pos,
                    d_sel=d_sel, d_valid=d_valid, k=k_used, seg=int(seg),
                    lc=int(layout["lc"]))
        return args, q_dense_pos, host, k_used

    def _device_call(self, dev, a: dict) -> Tuple[np.ndarray, ...]:
        """Upload ``a`` (:meth:`_prep`), run :func:`RK.reverse_match` on
        the pinned device arrays ``dev`` and download the six results with
        one device→host copy."""
        put = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(
            self.device)
        out = RK.reverse_match(
            *dev, *(put(a[k]) for k in ("qw", "qe", "qh", "qf", "t_sel")),
            a["t_start"], *(put(a[k]) for k in ("q_tile", "q_pos", "d_sel",
                                                "d_valid")),
            k=a["k"], seg=a["seg"], lc=a["lc"])
        flat = torch.cat([o.reshape(-1).to(torch.int32) for o in out]) \
            .cpu().numpy()
        parts, off = [], 0
        for o in out:
            n = o.numel()
            p = flat[off:off + n].reshape(tuple(o.shape))
            parts.append(p.astype(bool) if o.dtype == torch.bool else p)
            off += n
        return tuple(parts)

    def _dispatch(self, dev, layout, qw, qe, qh, qf, region, n):
        """Window prep + the device call (no lock held — operates ONLY on
        state pinned under the lock: ``dev`` is the device-array snapshot
        captured with the entries snapshot; re-reading ``self._dev`` here
        would let a concurrent delta/rebuild swap the arrays mid-dispatch
        and slot ids resolve against the WRONG entries)."""
        a, q_dense_pos, host, k_used = self._prep(layout, qw, qe, qh, qf,
                                                  region, n)
        faults.inject("device.retained")
        return self._device_call(dev, a), q_dense_pos, host, k_used

    # ------------------------------------------------------------ statuses

    def status(self) -> Dict[str, Any]:
        ts = self.table.stats()
        return {
            "rows": ts["rows"], "capacity": ts["capacity"],
            "buckets": ts["buckets"], "overflow": ts["overflow"],
            "interned_words": ts["interned_words"],
            "dispatches": self.match_dispatches,
            "queries": self.match_queries,
            "host_fallbacks": self.host_fallback_queries,
            "rebuilds": self.rebuilds,
            "device_failures": self.device_failures,
            "breaker": (self.breaker.state_name
                        if self.breaker is not None else "disabled"),
        }


class RetainedEngine:
    """Per-mountpoint :class:`RetainedIndex` registry — the retained
    sibling of ``GpuRegView``'s matcher map, and the write-through target
    for the broker's retain dirty hook. Every index lives on ``device``
    (default the CUDA card; raises without one); on CUDA the kernel library
    is built and loaded here, when the engine is created."""

    def __init__(self, store, *, max_levels: int = 16,
                 initial_capacity: int = 2048, max_fanout: int = 256,
                 breaker_enabled: bool = True,
                 breaker_failure_threshold: int = 3,
                 breaker_backoff_initial: float = 0.2,
                 breaker_backoff_max: float = 10.0,
                 watchdog=None, rebuild_deadline_s: float = 120.0,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        load_kernels(self.device, KERNEL_LIBS)
        self.store = store
        self._indexes: Dict[str, RetainedIndex] = {}
        self._loading: Dict[str, Any] = {}  # mp -> in-flight warm-load task
        self._mk = lambda mp: RetainedIndex(
            store, mp, max_levels=max_levels,
            initial_capacity=initial_capacity, max_fanout=max_fanout,
            device=self.device,
            breaker=(CircuitBreaker(
                failure_threshold=breaker_failure_threshold,
                backoff_initial=breaker_backoff_initial,
                backoff_max=breaker_backoff_max,
                name="retained")
                if breaker_enabled else None),
            breaker_enabled=breaker_enabled,
            watchdog=watchdog, rebuild_deadline_s=rebuild_deadline_s)

    def index(self, mountpoint: str = "") -> RetainedIndex:
        """Get/create the mountpoint's index, warm-loading SYNCHRONOUSLY
        on first use — the tests/bench/embedding entry point. Call on
        the event-loop thread (store mutation is loop-side); broker
        serving goes through :meth:`index_async` instead so a large
        warm load cannot stall the loop."""
        idx = self._indexes.get(mountpoint)
        if idx is None:
            idx = self._mk(mountpoint)
            idx.warm_load()
            self._indexes[mountpoint] = idx
        return idx

    async def index_async(self, mountpoint: str = "") -> RetainedIndex:
        """Loop-friendly get/create: the first use of a mountpoint
        chunk-loads the retained snapshot with loop yields
        (``warm_load_async``); concurrent callers await the same load,
        and none serves a half-loaded table. A failed load unpublishes
        the index so the next replay retries (callers meanwhile serve
        the host walk via their normal exception paths)."""
        import asyncio

        task = self._loading.get(mountpoint)
        if task is not None:
            await task
            return self._indexes[mountpoint]
        idx = self._indexes.get(mountpoint)
        if idx is not None:
            return idx
        idx = self._mk(mountpoint)
        # publish BEFORE loading: live retain deltas must reach the
        # mid-load override buffer, not vanish
        self._indexes[mountpoint] = idx
        task = asyncio.get_event_loop().create_task(idx.warm_load_async())
        self._loading[mountpoint] = task
        try:
            await task
        except Exception:
            self._indexes.pop(mountpoint, None)
            raise
        finally:
            self._loading.pop(mountpoint, None)
        return idx

    def on_retain(self, mountpoint: str, topic: Sequence[str],
                  value: Any) -> None:
        """Retain set/delete write-through (RetainStore dirty-hook
        signature). Mountpoints without a live index warm-load the
        change on first use instead."""
        idx = self._indexes.get(mountpoint)
        if idx is not None:
            idx.on_retain(topic, value)

    def breaker_status(self) -> Dict[str, Any]:
        return {mp or "(default)": (idx.breaker.status()
                                    if idx.breaker is not None else None)
                for mp, idx in self._indexes.items()}

    def stats(self) -> Dict[str, float]:
        out = {
            "retained_index_rows": 0, "retained_index_rebuilds": 0,
            "retained_match_dispatches": 0, "retained_match_queries": 0,
            "retained_host_fallback_queries": 0,
            "retained_device_failures": 0, "retained_degraded_sheds": 0,
            "retained_dispatch_stalls": 0, "retained_rebuild_abandons": 0,
        }
        state = 0
        for idx in self._indexes.values():
            ts = idx.table.stats()
            out["retained_index_rows"] += ts["rows"] + ts["overflow"]
            out["retained_index_rebuilds"] += idx.rebuilds
            out["retained_match_dispatches"] += idx.match_dispatches
            out["retained_match_queries"] += idx.match_queries
            out["retained_host_fallback_queries"] += \
                idx.host_fallback_queries
            out["retained_device_failures"] += idx.device_failures
            out["retained_degraded_sheds"] += idx.degraded_sheds
            out["retained_dispatch_stalls"] += idx.dispatch_stalls
            out["retained_rebuild_abandons"] += idx.rebuild_abandons
            if idx.breaker is not None:
                state = max(state, idx.breaker.state)
        out["retained_breaker_state"] = state
        return out

    def close(self) -> None:
        for idx in self._indexes.values():
            idx.close()
