"""The payload-filter serving engine: device predicate phase + window
aggregation table, with the exact host evaluator standing by.

Chained behind topic match: the BatchCollector hands every fold batch's
(topic, feature-row) pairs and matched fanout here; subscriptions whose
SubOpts carry a ``filter_expr`` have their rows kept/dropped by ONE
device dispatch evaluating every (matched-subscriber × compiled-
predicate) pair (``ops/predicate_kernel.py``), and aggregation
subscriptions feed a device-resident accumulator table updated by the
same dispatch — the fanout shrinks before any per-subscriber queue work
is spent.

Degradation discipline mirrors the matcher's: a CircuitBreaker guards
the device path (``vmq-admin breaker … path=predicate``), the
``device.predicate`` fault point drills it, the stall watchdog's
sacrificial dispatch bounds it (the collector wraps the call), and the
host evaluator — the same float32 semantics on the same feature rows —
serves bit-identical verdicts whenever the device cannot: breaker open,
dispatch abandoned, pairs below the host threshold, or predicates the
kernel cannot represent (conjunctions, >64-code enum alphabets), which
escape per-pair like the retained index's ``None`` escapes.

Zero-cost guarantee: a mountpoint with no registered predicates skips
the phase entirely (one dict probe, ``predicate_phase_skips``); a batch
whose matched rows carry no predicates dispatches nothing.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..models.matcher import _is_cuda_fault
from ..observability import histogram as obs
from ..ops import predicate_kernel as PK
from ..ops.tile_match import KernelError
from ..robustness import faults
from ..robustness import watchdog as watchdog_mod
from ..robustness.breaker import CircuitBreaker
from .predicate import (
    MISSING,
    OP_PAD,
    OP_TRUE,
    CompiledFilter,
    FilterError,
    compile_filter,
    encode_features,
    eval_filter_host,
    host_partials,
    parse_filter,
)

log = logging.getLogger("vernemq_tpu_torch.filters")

#: permanent predicate-table rows: 0 = OP_PAD (pad pairs), 1 = OP_TRUE
#: (unpredicated aggregation pairs — always fold)
ROW_PAD = 0
ROW_TRUE = 1


class PredicateDegraded(Exception):
    """Internal: the device predicate path refused/failed this batch —
    the host evaluator serves it (never escapes the engine)."""


def _pow2(n: int, floor: int = 8) -> int:
    b = floor
    while b < n:
        b *= 2
    return b


class _PredTable:
    """Per-mountpoint compiled-predicate rows (host arrays + device
    mirror). Tiny — one row per distinct (expression, schema) pair —
    so a change re-uploads the whole table (no delta machinery)."""

    def __init__(self, cap: int = 64):
        self._alloc(cap)
        self.n = 2  # rows 0/1 reserved (PAD / TRUE)
        self.op[ROW_TRUE] = OP_TRUE
        self.row_of: Dict[Tuple[str, Any], int] = {}
        self.dirty = True
        self.dev: Optional[tuple] = None

    def _alloc(self, cap: int) -> None:
        self.op = np.zeros(cap, np.int32)
        self.field = np.zeros(cap, np.int32)
        self.a = np.zeros(cap, np.float32)
        self.b = np.zeros(cap, np.float32)
        self.mlo = np.zeros(cap, np.int32)
        self.mhi = np.zeros(cap, np.int32)

    def clear(self) -> None:
        """Schema generation moved: every compiled row is stale."""
        self.row_of.clear()
        self.op[2:] = OP_PAD
        self.n = 2
        self.dirty = True

    def ensure_row(self, key: Tuple[str, Any],
                   row: Tuple[int, int, float, float, int, int]) -> int:
        rid = self.row_of.get(key)
        if rid is not None:
            return rid
        if self.n >= len(self.op):
            cap = len(self.op) * 2
            old = (self.op, self.field, self.a, self.b, self.mlo, self.mhi)
            self._alloc(cap)
            for new, prev in zip((self.op, self.field, self.a, self.b,
                                  self.mlo, self.mhi), old):
                new[:len(prev)] = prev
            self.dev = None  # shape changed: full re-upload
        rid = self.n
        self.n += 1
        (self.op[rid], self.field[rid], self.a[rid], self.b[rid],
         self.mlo[rid], self.mhi[rid]) = row
        self.row_of[key] = rid
        self.dirty = True
        return rid


@dataclass
class _WinMeta:
    mountpoint: str
    expr: str
    sub_key: Any            # SubscriberId or ("$g", group, sid)
    topic: Tuple[str, ...]
    agg: Any                # predicate.Agg
    opts: Any               # SubOpts (delivery transform for emissions)
    deadline: Optional[float]  # monotonic close time (time windows)


class _Windows:
    """The (topic, window) accumulator table: float32 [W, 4]
    (count, sum, min, max) host mirror + device-resident copy. Both
    sides apply the same float32 folds, so the mirror stays
    bit-compatible with the donated device table; any degraded (host-
    served) fold marks the device copy stale and the next device
    dispatch re-uploads the mirror."""

    def __init__(self, cap: int = 256, max_cap: int = 4096):
        self.cap = cap
        self.max_cap = max(cap, max_cap)
        self.acc = self._fresh(cap)
        self.meta: List[Optional[_WinMeta]] = [None] * cap
        self.slot_of: Dict[Tuple, int] = {}
        self.free = list(range(cap - 1, -1, -1))
        self.dev: Optional[Any] = None
        self.dev_stale = True
        self.opened = 0
        self.closed = 0
        self.overflows = 0

    @staticmethod
    def _fresh(n: int) -> np.ndarray:
        acc = np.zeros((n, 4), np.float32)
        acc[:, 2] = np.inf
        acc[:, 3] = -np.inf
        return acc

    def alloc(self, key: Tuple, meta: _WinMeta) -> Optional[int]:
        slot = self.slot_of.get(key)
        if slot is not None:
            return slot
        if not self.free:
            if self.cap >= self.max_cap:
                self.overflows += 1
                return None
            new_cap = min(self.cap * 2, self.max_cap)
            grown = self._fresh(new_cap)
            grown[:self.cap] = self.acc
            self.acc = grown
            self.meta.extend([None] * (new_cap - self.cap))
            self.free = list(range(new_cap - 1, self.cap - 1, -1))
            self.cap = new_cap
            self.dev = None
            self.dev_stale = True
        slot = self.free.pop()
        self.slot_of[key] = slot
        self.meta[slot] = meta
        self.acc[slot] = (0.0, 0.0, np.inf, -np.inf)
        self.opened += 1
        return slot

    def reset_slot(self, slot: int, now: float) -> None:
        """Window closed: the slot starts the next tumbling window."""
        self.acc[slot] = (0.0, 0.0, np.inf, -np.inf)
        m = self.meta[slot]
        if m is not None and m.agg.time_s:
            m.deadline = now + m.agg.time_s
        self.dev_stale = True
        self.closed += 1

    def release(self, key: Tuple) -> bool:
        """Free one window slot (its subscription unsubscribed): the
        slot returns to the free list and a later re-subscribe starts a
        FRESH window — stale accumulator values and stale SubOpts must
        never leak across subscription lifetimes."""
        slot = self.slot_of.pop(key, None)
        if slot is None:
            return False
        self.meta[slot] = None
        self.acc[slot] = (0.0, 0.0, np.inf, -np.inf)
        self.free.append(slot)
        self.dev_stale = True
        return True

    def open_count(self) -> int:
        return len(self.slot_of)


class FilterEngine:
    def __init__(self, schemas, metrics=None, *,
                 breaker_enabled: bool = True,
                 breaker_failure_threshold: int = 3,
                 breaker_backoff_initial: float = 0.2,
                 breaker_backoff_max: float = 10.0,
                 host_threshold: int = 16,
                 max_pairs: int = 65536,
                 window_initial: int = 256,
                 window_cap: int = 4096,
                 tick_ms: int = 250,
                 device_gate: Optional[Callable[[], bool]] = None,
                 device=None):
        """``device``: where the predicate phase's device path runs (the
        broker passes its own); None means no device path, so the exact host
        evaluator serves every batch. A CUDA device is resolved here (no
        card raises), the phase's kernel is built and one warm dispatch runs
        on scratch tensors, so the first batch does not wait on module
        loading; the warm-up leaves the engine's state untouched."""
        self.schemas = schemas
        self.metrics = metrics
        self.breaker: Optional[CircuitBreaker] = (CircuitBreaker(
            failure_threshold=breaker_failure_threshold,
            backoff_initial=breaker_backoff_initial,
            backoff_max=breaker_backoff_max,
            name="predicate") if breaker_enabled else None)
        #: pairs below this are host-evaluated (no device round trip —
        #: the predicate analog of the collector's hybrid threshold)
        self.host_threshold = host_threshold
        #: device pair cap per dispatch; past it the batch splits to host
        self.max_pairs = max_pairs
        self.tick_s = tick_ms / 1e3
        #: callable gating the device path (the broker wires the
        #: accelerator/worker-mode truth); None = device allowed
        self.device_gate = device_gate
        #: emission hook, wired by the broker:
        #: fn(mountpoint, sub_key, opts, topic_words, payload_bytes)
        self.emit: Optional[Callable[..., None]] = None
        self._lock = threading.Lock()          # registry + window state
        self._device_lock = threading.Lock()   # one device dispatch at a time
        self._tables: Dict[str, _PredTable] = {}
        self._win = _Windows(window_initial, window_cap)
        self._specs: Dict[str, Any] = {}       # expr -> FilterSpec | None(bad)
        self._compiled: Dict[Tuple[str, Any], CompiledFilter] = {}
        self._gen = -1
        # refcounted per-mountpoint predicate presence (the wants() gate);
        # fed by the registry's subscription deltas
        self._mp_refs: Dict[str, int] = {}
        self._enc_cache: Dict[Tuple[str, Tuple[str, ...]], Any] = {}
        self._device = None
        if device is not None:
            self._device = resolve_device(device)
            if self._device.type == "cuda":
                self._warm()
        self._loop = None
        self._tick_handle = None
        self._closed = False
        # counters (gauge surface; the registered COUNTERS families are
        # incremented through self._m when a Metrics handle is wired)
        self.dispatches = 0
        self.host_batches = 0
        self.phase_skips = 0
        self.pairs_device = 0
        self.pairs_host = 0
        self.pairs_escaped = 0
        self.rows_filtered = 0
        self.values_folded = 0
        self.windows_closed = 0
        self.emissions = 0
        self.device_failures = 0
        self.degraded_sheds = 0
        self.dispatch_stalls = 0
        self.errors = 0
        if schemas is not None:
            schemas.on_change(self._on_schema_change)

    # ------------------------------------------------------------ plumbing

    def _m(self, name: str, n: int = 1) -> None:
        if self.metrics is not None:
            self.metrics.incr(name, n)

    def _on_schema_change(self) -> None:
        with self._lock:
            self._compiled.clear()
            self._enc_cache.clear()
            for t in self._tables.values():
                t.clear()

    def on_sub_delta(self, op: str, mountpoint: str, opts: Any,
                     sub_key: Any = None) -> None:
        """Registry subscription-delta hook: refcount predicate-carrying
        subscriptions per mountpoint (the wants() fast gate), and free
        the removed subscription's aggregation windows (``sub_key`` is
        the routing-row key — sid or ("$g", group, sid)) so the slot
        table can't leak to its cap and a re-subscribe never inherits a
        dead window's accumulator or SubOpts."""
        expr = getattr(opts, "filter_expr", None) if opts is not None else None
        if not expr:
            return
        with self._lock:
            n = self._mp_refs.get(mountpoint, 0) + (1 if op == "add" else -1)
            if n <= 0:
                self._mp_refs.pop(mountpoint, None)
            else:
                self._mp_refs[mountpoint] = n
            if op == "remove" and sub_key is not None:
                win = self._win
                for wkey in [k for k in win.slot_of
                             if k[0] == mountpoint and k[1] == expr
                             and k[2] == sub_key]:
                    win.release(wkey)

    def wants(self, mountpoint: str) -> bool:
        """Any predicate-carrying subscriptions on this mountpoint? One
        dict probe — the zero-cost gate for unfiltered deployments."""
        return mountpoint in self._mp_refs

    def note_skip(self) -> None:
        self.phase_skips += 1
        self._m("predicate_phase_skips")

    # ------------------------------------------------------------- encode

    def _schema_for(self, mountpoint: str, topic: Tuple[str, ...]):
        if self.schemas is None:
            return None
        gen = self.schemas.generation
        if gen != self._gen:
            # dict ops are GIL-atomic; callers may already hold
            # self._lock (planning), so no lock is taken here — a racy
            # double-clear only costs a re-lookup
            self._enc_cache.clear()
            self._gen = gen
        key = (mountpoint, topic)
        hit = self._enc_cache.get(key)
        if hit is None:
            hit = (self.schemas.lookup(mountpoint, topic),)
            if len(self._enc_cache) > (1 << 16):
                self._enc_cache.clear()  # bound adversarial topic streams
            self._enc_cache[key] = hit
        return hit[0]

    def encode(self, mountpoint: str, topic: Sequence[str],
               payload: bytes) -> Optional[np.ndarray]:
        """Feature row for a publish on a schema-registered topic; None
        when no schema matches (predicates then see every field
        missing). First line is a dict probe — publishes on mountpoints
        with no schemas pay nothing."""
        if self.schemas is None or not self.schemas.has_schemas(mountpoint):
            return None
        schema = self._schema_for(mountpoint, tuple(topic))
        if schema is None:
            return None
        return encode_features(schema, payload)

    # ------------------------------------------------------------ compile

    def _compile(self, expr: str, schema) -> Optional[CompiledFilter]:
        key = (expr, schema)
        cf = self._compiled.get(key)
        if cf is None and key not in self._compiled:
            spec = self._specs.get(expr)
            if spec is None and expr not in self._specs:
                try:
                    spec = parse_filter(expr)
                except FilterError:
                    log.warning("unparseable replicated filter %r "
                                "(rows pass unfiltered)", expr)
                    spec = None
                self._specs[expr] = spec
            if spec is None:
                self._compiled[key] = None
                return None
            try:
                cf = compile_filter(spec, schema)
            except FilterError:
                log.warning("uncompilable filter %r (rows pass "
                            "unfiltered)", expr)
                cf = None
            self._compiled[key] = cf
        return cf

    # --------------------------------------------------------- the phase

    def filter_batch(self, mountpoint: str,
                     items: Sequence[Tuple[Sequence[str],
                                           Optional[np.ndarray]]],
                     results: List[List[Any]]) -> List[List[Any]]:
        """The second phase for one fold batch: ``items`` is the
        (topic, feature-row) list aligned with ``results`` (per-publish
        matched rows). Returns the predicate-filtered fanout with
        aggregation rows consumed into their windows. Runs on an
        executor thread (the collector wraps it in the watchdog's
        sacrificial dispatch); a failure fails open (unfiltered rows,
        counted) rather than losing publishes — except a fault of the
        device code (``KernelError``: a kernel that fails to build, refuses
        its input or faulted on the card), which raises to the caller and
        is never answered by the host evaluator."""
        try:
            return self._filter_batch_impl(mountpoint, items, results,
                                           force_host=False)
        except KernelError:
            raise
        except Exception:
            self.errors += 1
            self._m("predicate_errors")
            log.exception("predicate phase failed; batch delivered "
                          "unfiltered")
            return results

    def filter_batch_host(self, mountpoint: str, items, results):
        """Host-only variant (the collector's StallAbandoned fallback)."""
        try:
            return self._filter_batch_impl(mountpoint, items, results,
                                           force_host=True)
        except Exception:
            self.errors += 1
            self._m("predicate_errors")
            log.exception("host predicate fallback failed; batch "
                          "delivered unfiltered")
            return results

    def filter_single(self, mountpoint: str, topic: Sequence[str],
                      feat: Optional[np.ndarray],
                      rows: List[Any]) -> List[Any]:
        """One publish through the exact host path — the sync/shed seam
        (trie fallbacks, non-batched reg views, remote-publish refold)."""
        if not rows or not self.wants(mountpoint):
            return rows
        out = self.filter_batch_host(mountpoint, [(tuple(topic), feat)],
                                     [list(rows)])
        return out[0]

    def _filter_batch_impl(self, mountpoint, items, results, force_host):
        n = len(results)
        # order-preserving per-publish plans: (row, tag) where tag is
        # True (deliver), ("p", pair_k) (device/host pair verdict), or
        # ("h", CompiledFilter) (per-pair host escape) — the assembled
        # output keeps the fold's row order whichever executor served,
        # so device-vs-host fanout is bit-identical lists, not just sets
        plans: List[List[Tuple[Any, Any]]] = []
        pair_pub: List[int] = []
        pair_pred: List[int] = []
        n_escapes = 0
        # (slot, pub, field_idx, gate): gate is a predicate-row id, or
        # the CompiledFilter when the gate is only host-representable
        agg_feed: List[Tuple[int, int, int, Any]] = []
        emissions: List[Tuple[_WinMeta, np.ndarray]] = []
        now = time.monotonic()
        with self._lock:
            table = self._tables.get(mountpoint)
            if table is None:
                table = self._tables[mountpoint] = _PredTable()
            any_pred = False
            for i in range(n):
                rows = results[i]
                plan: List[Tuple[Any, Any]] = []
                plans.append(plan)
                if not rows:
                    continue
                topic, feat = items[i]
                schema = None
                schema_done = False
                for row in rows:
                    opts = row[2] if len(row) > 2 else None
                    expr = getattr(opts, "filter_expr", None) \
                        if opts is not None else None
                    if not expr:
                        plan.append((row, True))
                        continue
                    any_pred = True
                    if not schema_done:
                        schema = self._schema_for(mountpoint, tuple(topic))
                        schema_done = True
                    cf = self._compile(expr, schema)
                    if cf is None:          # unparseable: fail open
                        plan.append((row, True))
                        continue
                    if cf.spec.agg is not None:
                        self._plan_agg(mountpoint, i, topic, row, cf,
                                       table, schema, plan, agg_feed, now)
                        continue
                    if cf.device_row is not None and not force_host:
                        plan.append((row, ("p", len(pair_pub))))
                        pair_pub.append(i)
                        pair_pred.append(table.ensure_row(
                            (expr, schema), cf.device_row))
                    else:
                        # unrepresentable (conjunction / wide $in) or
                        # forced host: per-pair escape
                        if cf.device_row is None and not force_host:
                            n_escapes += 1
                        plan.append((row, ("h", cf)))
        if not any_pred:
            self.note_skip()
            return results
        # feature matrix (pairs + agg share it): width = max schema
        # width in batch, NaN-padded — field indexes are schema-local
        # and each pair reads its own publish's row
        feats = self._feats_matrix(items, n)
        # host-escape gates resolve now that the matrix exists: failing
        # entries drop, survivors fold ungated (ROW_TRUE)
        agg_norm: List[Tuple[int, int, int, int]] = []
        for slot, pub, fi, gate in agg_feed:
            if isinstance(gate, int):
                agg_norm.append((slot, pub, fi, gate))
                continue
            self.pairs_escaped += 1
            self._m("predicate_escapes")
            if eval_filter_host(gate, feats[pub]):
                agg_norm.append((slot, pub, fi, ROW_TRUE))
        verdicts = None
        if pair_pub:
            use_device = (not force_host
                          and len(pair_pub) >= self.host_threshold
                          and len(pair_pub) <= self.max_pairs
                          and self._device_ok())
            if use_device:
                try:
                    verdicts = self._dispatch(table, feats, pair_pub,
                                              pair_pred, agg_norm, now,
                                              emissions)
                except PredicateDegraded:
                    verdicts = None
            if verdicts is None:
                verdicts = self._host_pairs_eval(table, feats, pair_pub,
                                                 pair_pred)
                self.host_batches += 1
                self.pairs_host += len(pair_pub)
                self._m("predicate_host_evals", len(pair_pub))
                if agg_norm:
                    self._fold_host(table, feats, agg_norm, now,
                                    emissions)
        elif agg_norm:
            # aggregation-only batch: fold through the same discipline
            folded = False
            if not force_host and len(agg_norm) >= self.host_threshold \
                    and self._device_ok():
                try:
                    self._dispatch(table, feats, [], [], agg_norm, now,
                                   emissions)
                    folded = True
                except PredicateDegraded:
                    pass
            if not folded:
                self._fold_host(table, feats, agg_norm, now, emissions)
        if n_escapes:
            self.pairs_escaped += n_escapes
            self._m("predicate_escapes", n_escapes)
        # assemble in original fold order: base rows, pair verdicts and
        # host escapes interleave exactly as the match produced them
        out: List[List[Any]] = []
        n_host_esc = 0
        dropped = 0
        for i, plan in enumerate(plans):
            rows_out: List[Any] = []
            for row, tag in plan:
                if tag is True:
                    rows_out.append(row)
                elif tag[0] == "p":
                    if verdicts is not None and bool(verdicts[tag[1]]):
                        rows_out.append(row)
                    else:
                        dropped += 1
                else:  # per-pair host escape: exact evaluator
                    n_host_esc += 1
                    if eval_filter_host(tag[1], feats[i]):
                        rows_out.append(row)
                    else:
                        dropped += 1
            out.append(rows_out)
        if n_host_esc:
            self.pairs_host += n_host_esc
            self._m("predicate_host_evals", n_host_esc)
        if dropped:
            self.rows_filtered += dropped
            self._m("predicate_rows_filtered", dropped)
        self._flush_emissions(emissions)
        return out

    def _feats_matrix(self, items, n: int) -> np.ndarray:
        """[Bpad, Fpad] float32 feature matrix, NaN-padded. BOTH dims
        pad to pow2: the dispatch jit keys on this shape, and live
        batch sizes vary per flush — unpadded rows would mint one XLA
        compile per distinct size (the Bpad-ladder lesson)."""
        width = 2
        for _t, feat in items:
            if feat is not None:
                width = max(width, len(feat))
        feats = np.full((_pow2(max(n, 1)), _pow2(width, floor=2)),
                        MISSING, np.float32)
        for i, (_t, feat) in enumerate(items):
            if feat is not None:
                feats[i, :len(feat)] = feat
        return feats

    def _plan_agg(self, mountpoint, i, topic, row, cf, table, schema,
                  plan, agg_feed, now) -> None:
        """Allocate/locate the (subscription, topic) window slot and
        queue this publish's fold. Lock held. A full window table
        degrades to raw per-message delivery (counted) — downsampling
        never silently drops telemetry."""
        agg = cf.spec.agg
        key = (mountpoint, cf.spec.raw, row[1], tuple(topic))
        meta = _WinMeta(mountpoint, cf.spec.raw, row[1], tuple(topic),
                        agg, row[2],
                        now + agg.time_s if agg.time_s else None)
        slot = self._win.alloc(key, meta)
        if slot is None:
            self._m("aggregate_window_overflow")
            plan.append((row, True))  # degrade: deliver raw, visibly
            return
        if agg.field is None:
            fi = -1
        else:
            fi = (schema.field_index(agg.field)
                  if schema is not None else None)
            if fi is None:
                fi = schema.nan_index if schema is not None else 0
        # predicate gate: $gt(v,30)&$avg(v,100) folds only passing
        # messages — a device-representable gate rides the dispatch as
        # a predicate-row id; anything else carries the CompiledFilter
        # and resolves host-side once the feature matrix exists
        gate: Any = ROW_TRUE
        if cf.preds:
            gate = (table.ensure_row((cf.spec.raw, schema),
                                     cf.device_row)
                    if cf.device_row is not None else cf)
        agg_feed.append((slot, i, fi, gate))

    def _device_ok(self) -> bool:
        """Is the device path worth attempting? Deliberately does NOT
        consult the breaker — ``_dispatch``'s single ``allow()`` call
        owns the half-open probe slot (a second allow() here would
        consume the probe and wedge the breaker half-open). The device is
        the one the engine was given (no probe)."""
        gate = self.device_gate
        if gate is not None:
            try:
                if not gate():
                    return False
            except Exception:
                return False
        return self._device is not None

    def _warm(self) -> None:
        """Build the phase's kernel and run one dispatch on scratch tensors
        of the engine's device (CUDA loads a kernel's module at its first
        launch); nothing of the engine is read or written."""
        dev = self._device
        i32 = dict(dtype=torch.int32, device=dev)
        table = (torch.tensor([OP_PAD, OP_TRUE], **i32),
                 torch.zeros(2, **i32),
                 torch.zeros(2, dtype=torch.float32, device=dev),
                 torch.zeros(2, dtype=torch.float32, device=dev),
                 torch.zeros(2, **i32), torch.zeros(2, **i32))
        one = torch.ones(1, **i32)
        acc = torch.from_numpy(_Windows._fresh(1)).to(dev)
        PK.predicate_phase(*table, acc,
                           torch.zeros((1, 2), dtype=torch.float32,
                                       device=dev),
                           one, one, torch.zeros(1, **i32),
                           torch.zeros(1, **i32), torch.zeros(1, **i32),
                           one, torch.ones(1, dtype=torch.bool, device=dev),
                           W=1)
        torch.cuda.synchronize(dev)

    def record_stall(self, exc: Optional[BaseException] = None) -> None:
        """Collector hook: the sacrificial dispatch abandoned a wedged
        predicate phase — feed the breaker like any device failure."""
        self.dispatch_stalls += 1
        self.device_failures += 1
        self._m("predicate_device_failures")
        br = self.breaker
        if br is not None and br.record_failure():
            log.error("predicate device path OPENED after a stalled "
                      "dispatch; host evaluator serves")

    # device dispatch ------------------------------------------------------

    def _dispatch(self, table, feats, pair_pub, pair_pred, agg_norm,
                  now, emissions) -> Optional[np.ndarray]:
        """One device call for the whole batch: pair verdicts + window
        folds. Raises PredicateDegraded when the device cannot serve
        (breaker fed); the caller runs the exact host path. A fault of the
        device code raises ``KernelError`` instead: it is not fed to the
        breaker and the host evaluator does not answer it."""
        if not self._device_lock.acquire(timeout=0.5):
            # a wedged/slow dispatch holds the lock: don't pile in
            raise PredicateDegraded("device busy")
        try:
            br = self.breaker
            if br is not None and not br.allow():
                self.degraded_sheds += 1
                self._m("predicate_degraded_sheds")
                raise PredicateDegraded("breaker open")
            t0 = time.monotonic()
            dev = self._device
            put = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
            try:
                faults.inject("device.predicate")
                # snapshot HOST copies under the lock, upload OUTSIDE
                # it: the event loop takes self._lock every tick
                # (_tick, retained replay, admin status), and a wedged
                # upload held here would park every session. Copies are
                # tiny (the predicate table is hundreds of rows, the acc
                # table W×4 f32). Staleness flags are CONSUMED at
                # snapshot; a concurrent change re-marks them and the
                # next dispatch re-uploads.
                with self._lock:
                    t_host = ((table.op.copy(), table.field.copy(),
                               table.a.copy(), table.b.copy(),
                               table.mlo.copy(), table.mhi.copy())
                              if table.dev is None or table.dirty
                              else None)
                    if t_host is not None:
                        table.dirty = False
                    dev_table = table.dev
                    win = self._win
                    W = win.cap
                    acc_host = (win.acc.copy()
                                if agg_norm and (win.dev is None
                                                 or win.dev_stale)
                                else None)
                    if acc_host is not None:
                        win.dev_stale = False
                    acc_dev = win.dev
                if t_host is not None:
                    dev_table = tuple(put(a) for a in t_host)
                    with self._lock:
                        if not table.dirty:
                            table.dev = dev_table
                        # else: a schema change re-dirtied mid-upload —
                        # serve this batch from the consistent snapshot,
                        # leave table.dev for the next dispatch
                if acc_host is not None:
                    acc_dev = put(acc_host)
                # no padding: the pair and fold counts are the batch's own
                # (the reference pads both to powers of two to bound its
                # XLA compiles); one int32 block carries every index array,
                # each at a 16-byte offset (the kernel's vector loads)
                P, A = len(pair_pub), len(agg_norm)
                P4 = -(-P // 4) * 4
                idx = np.empty(2 * P4 + 4 * A, np.int32)
                idx[:P] = pair_pub
                idx[P4:P4 + P] = pair_pred
                if A:  # rows: slot, pub, field, gate
                    idx[2 * P4:] = np.asarray(agg_norm, np.int32).T.ravel()
                idx_dev = put(idx)
                pp, pr = idx_dev[:P], idx_dev[P4:P4 + P]
                f_dev = put(feats)
                if agg_norm:
                    agg = idx_dev[2 * P4:].view(4, A)
                    keep, new_acc, cnt, sm, mn, mx = PK.predicate_phase(
                        *dev_table, acc_dev, f_dev, pp, pr, *agg,
                        torch.ones(A, dtype=torch.bool, device=dev), W=W)
                    keep = keep.cpu().numpy()
                    partials = tuple(torch.stack((cnt, sm, mn, mx))
                                     .cpu().numpy())
                else:
                    keep = PK.eval_pairs(*dev_table, f_dev, pp,
                                         pr).cpu().numpy()
                    new_acc = partials = None
            except Exception as e:
                if agg_norm:
                    # the acc table is updated in place: a failed call may
                    # have left it half folded — invalidate so the next
                    # dispatch re-uploads from the authoritative host
                    # mirror; the kernel's held fold scratch likewise goes
                    with self._lock:
                        self._win.dev = None
                        self._win.dev_stale = True
                    PK.drop_scratch(dev)
                if isinstance(e, KernelError):
                    raise
                if _is_cuda_fault(e):
                    raise KernelError(
                        f"predicate phase: CUDA fault on the card: {e}") \
                        from e
                self.device_failures += 1
                self._m("predicate_device_failures")
                if br is not None:
                    if watchdog_mod.current_op_abandoned():
                        raise PredicateDegraded(
                            f"late failure of abandoned dispatch: {e!r}")
                    if br.record_failure():
                        log.error(
                            "predicate device path OPENED after %d "
                            "consecutive failures (last: %s); host "
                            "evaluator serves", br.failure_threshold, e)
                    raise PredicateDegraded(str(e)) from e
                raise
            if watchdog_mod.current_op_abandoned():
                # the watchdog released our waiter and the host path
                # already served this batch: committing the fold would
                # double-count — discard, mark the device table stale.
                # A held half-open probe is handed back (the stall was
                # already fed to the breaker via record_stall).
                if br is not None:
                    br.probe_aborted()
                with self._lock:
                    self._win.dev = None
                    self._win.dev_stale = True
                PK.drop_scratch(dev)
                raise PredicateDegraded("abandoned dispatch discarded")
            if br is not None:
                br.record_success()
            self.dispatches += 1
            self.pairs_device += len(pair_pub)
            self._m("predicate_dispatches")
            self._m("predicate_pairs_evaluated", len(pair_pub))
            obs.observe("stage_predicate_dispatch_ms",
                        (time.monotonic() - t0) * 1e3)
            if partials is not None:
                with self._lock:
                    if self._win.cap == W:
                        self._win.dev = new_acc
                    else:
                        # the table grew while we dispatched against
                        # the old capacity: the device copy is stale —
                        # re-upload the mirror next time
                        self._win.dev = None
                        self._win.dev_stale = True
                    self._commit_partials(partials, now, emissions)
            return keep if pair_pub else None
        finally:
            self._device_lock.release()

    # host twin ------------------------------------------------------------

    def _host_pairs_eval(self, table, feats, pair_pub,
                         pair_pred) -> np.ndarray:
        t0 = time.monotonic()
        out = np.zeros(len(pair_pub), bool)
        for k in range(len(pair_pub)):
            rid = pair_pred[k]
            out[k] = self._host_row(table, rid, feats[pair_pub[k]])
        obs.observe("stage_predicate_host_ms",
                    (time.monotonic() - t0) * 1e3)
        return out

    @staticmethod
    def _host_row(table, rid: int, feat_row: np.ndarray) -> bool:
        from .predicate import eval_compiled_row

        op = int(table.op[rid])
        if op == OP_TRUE:
            return True
        if op == OP_PAD:
            return False
        return eval_compiled_row(op, int(table.field[rid]),
                                 float(table.a[rid]),
                                 float(table.b[rid]),
                                 int(table.mlo[rid]),
                                 int(table.mhi[rid]), feat_row)

    def _fold_host(self, table, feats, agg_norm, now, emissions) -> None:
        """Exact host fold (degraded / small batches): same float32
        partial arithmetic as the kernel, device copy marked stale."""
        if watchdog_mod.current_op_abandoned():
            # a watchdog-abandoned filter_batch straggler falling back
            # to the host path: the collector already re-served this
            # batch (filter_batch_host) — folding here would count
            # every aggregated value twice
            return
        keep_feed = [(slot, pub, fi) for slot, pub, fi, gate in agg_norm
                     if gate == ROW_TRUE
                     or self._host_row(table, gate, feats[pub])]
        if not keep_feed:
            return
        with self._lock:
            win = self._win
            a_slot = np.fromiter((s for s, _p, _f in keep_feed), np.int32,
                                 count=len(keep_feed))
            a_pub = np.fromiter((p for _s, p, _f in keep_feed), np.int32,
                                count=len(keep_feed))
            a_field = np.fromiter((f for _s, _p, f in keep_feed), np.int32,
                                  count=len(keep_feed))
            a_valid = np.ones(len(keep_feed), bool)
            partials = host_partials(feats, a_slot, a_pub, a_field,
                                        a_valid, win.cap)
            win.dev_stale = True
            self._commit_partials(partials, now, emissions)

    def _commit_partials(self, partials, now, emissions) -> None:
        """Fold per-slot partials into the host mirror and collect
        closed windows. Lock held."""
        cnt, sm, mn, mx = partials
        win = self._win
        touched = np.nonzero(cnt > 0)[0]
        folded = 0
        for slot in touched:
            acc = win.acc[slot]
            acc[0] = np.float32(acc[0] + cnt[slot])
            acc[1] = np.float32(acc[1] + sm[slot])
            if mn[slot] < acc[2]:
                acc[2] = mn[slot]
            if mx[slot] > acc[3]:
                acc[3] = mx[slot]
            folded += int(cnt[slot])
            meta = win.meta[slot]
            if meta is None:
                continue
            if meta.agg.time_s and meta.deadline is None:
                meta.deadline = now + meta.agg.time_s
            if meta.agg.count_n and acc[0] >= meta.agg.count_n:
                emissions.append((meta, acc.copy()))
                win.reset_slot(slot, now)
        self.values_folded += folded
        self._m("aggregate_values_folded", folded)

    # emissions ------------------------------------------------------------

    def _flush_emissions(self, emissions) -> None:
        if not emissions or watchdog_mod.current_op_abandoned():
            return
        self.windows_closed += len(emissions)
        self._m("aggregate_windows_closed", len(emissions))
        loop = self._loop
        if loop is not None:
            loop.call_soon_threadsafe(self._emit_all, emissions)
        else:
            self._emit_all(emissions)

    def _emit_all(self, emissions) -> None:
        hook = self.emit
        for meta, acc in emissions:
            payload = self._agg_payload(meta, acc)
            self.emissions += 1
            self._m("aggregate_publishes")
            if hook is None:
                continue
            try:
                hook(meta.mountpoint, meta.sub_key, meta.opts,
                     meta.topic, payload)
            except Exception:
                log.exception("aggregate emission failed for %s",
                              meta.sub_key)

    @staticmethod
    def _agg_payload(meta: _WinMeta, acc: np.ndarray) -> bytes:
        fn = meta.agg.fn
        count = int(acc[0])
        if fn == "count":
            value: Any = count
        elif fn == "sum":
            value = float(acc[1])
        elif fn == "avg":
            value = float(np.float32(acc[1]) / np.float32(acc[0])) \
                if count else None
        elif fn == "min":
            value = float(acc[2]) if count else None
        else:
            value = float(acc[3]) if count else None
        return json.dumps({
            "$agg": fn, "field": meta.agg.field,
            "window": meta.agg.window_label, "count": count,
            "value": value, "topic": "/".join(meta.topic),
        }).encode()

    # time windows ---------------------------------------------------------

    def arm(self, loop) -> None:
        """Attach the event loop: emissions marshal onto it and the
        time-window close timer runs on it."""
        self._loop = loop
        if self._tick_handle is None:
            self._tick_handle = loop.call_later(self.tick_s, self._tick)

    def _tick(self) -> None:
        self._tick_handle = None
        if self._closed:
            return
        emissions: List[Tuple[_WinMeta, np.ndarray]] = []
        now = time.monotonic()
        with self._lock:
            win = self._win
            for key, slot in list(win.slot_of.items()):
                meta = win.meta[slot]
                if meta is None or not meta.agg.time_s:
                    continue
                if meta.deadline is not None and now >= meta.deadline:
                    if win.acc[slot][0] > 0:
                        emissions.append((meta, win.acc[slot].copy()))
                        win.reset_slot(slot, now)
                    else:
                        meta.deadline = now + meta.agg.time_s
        if emissions:
            self.windows_closed += len(emissions)
            self._m("aggregate_windows_closed", len(emissions))
            self._emit_all(emissions)
        if self._loop is not None and not self._closed:
            self._tick_handle = self._loop.call_later(self.tick_s,
                                                      self._tick)

    def flush_windows(self, force: bool = True) -> int:
        """Close accumulating windows NOW and emit their partial
        aggregates — the drain-node seam (cluster/handoff.py): a node
        about to evacuate must not let minutes of half-filled window
        state die with the process. ``force=True`` (the default) emits
        every non-empty window; ``force=False`` only the ones already
        past deadline (a tick the caller did not want to wait for).
        Returns the number of windows emitted."""
        emissions: List[Tuple[_WinMeta, np.ndarray]] = []
        now = time.monotonic()
        with self._lock:
            win = self._win
            for key, slot in list(win.slot_of.items()):
                meta = win.meta[slot]
                if meta is None:
                    continue
                due = (meta.deadline is not None and now >= meta.deadline)
                if not (force or due):
                    continue
                if win.acc[slot][0] > 0:
                    emissions.append((meta, win.acc[slot].copy()))
                    win.reset_slot(slot, now)
        if emissions:
            self.windows_closed += len(emissions)
            self._m("aggregate_windows_closed", len(emissions))
            self._emit_all(emissions)
        return len(emissions)

    def close(self) -> None:
        self._closed = True
        if self._tick_handle is not None:
            self._tick_handle.cancel()
            self._tick_handle = None

    def passes_single(self, mountpoint: str, topic: Sequence[str],
                      payload: bytes, opts: Any) -> Optional[bool]:
        """Host verdict for one stored message against one
        subscription's filter — the retained-replay seam (the replayed
        payload is right there, so the exact evaluator answers inline).
        True = deliver, False = drop, None = no filter on this sub.
        Aggregation subscriptions return False: they receive
        synthesized window aggregates, never raw replay."""
        expr = getattr(opts, "filter_expr", None) if opts is not None \
            else None
        if not expr:
            return None
        with self._lock:
            schema = self._schema_for(mountpoint, tuple(topic))
            cf = self._compile(expr, schema)
        if cf is None:
            return True  # unparseable: fail open, like the fold path
        if cf.spec.agg is not None:
            return False
        if schema is not None:
            row = encode_features(schema, payload)
        else:
            row = np.full(1, MISSING, np.float32)
        return eval_filter_host(cf, row)

    # introspection --------------------------------------------------------

    def breaker_status(self) -> Dict[str, Any]:
        return {"(all)": self.breaker.status()
                if self.breaker is not None else None}

    def status(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "predicates_compiled": sum(
                    max(0, t.n - 2) for t in self._tables.values()),
                "mountpoints": sorted(self._mp_refs),
                "windows_open": self._win.open_count(),
                "window_capacity": self._win.cap,
                "dispatches": self.dispatches,
                "host_batches": self.host_batches,
                "pairs_device": self.pairs_device,
                "pairs_host": self.pairs_host,
                "pairs_escaped": self.pairs_escaped,
                "rows_filtered": self.rows_filtered,
                "phase_skips": self.phase_skips,
                "values_folded": self.values_folded,
                "windows_closed": self.windows_closed,
                "aggregate_publishes": self.emissions,
                "breaker": (self.breaker.status()
                            if self.breaker is not None else None),
            }

    def stats(self) -> Dict[str, float]:
        """Gauge snapshot (broker metrics surface)."""
        out = {
            "predicate_compiled": float(sum(
                max(0, t.n - 2) for t in self._tables.values())),
            "predicate_dispatches_total": float(self.dispatches),
            "predicate_host_batches": float(self.host_batches),
            "predicate_rows_filtered_total": float(self.rows_filtered),
            "predicate_degraded_sheds_total": float(self.degraded_sheds),
            "predicate_device_failures_total": float(self.device_failures),
            "predicate_dispatch_stalls": float(self.dispatch_stalls),
            "predicate_fail_open_errors": float(self.errors),
            "aggregate_windows_open": float(self._win.open_count()),
            "aggregate_window_capacity": float(self._win.cap),
            "aggregate_window_overflows": float(self._win.overflows),
            "aggregate_emissions_total": float(self.emissions),
        }
        br = self.breaker
        if br is not None:
            out["predicate_breaker_state"] = float(br.state)
            out["predicate_breaker_opens"] = float(br.opens)
        else:
            out["predicate_breaker_state"] = 0.0
            out["predicate_breaker_opens"] = 0.0
        return out
