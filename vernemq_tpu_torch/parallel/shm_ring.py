"""Shared-memory plumbing for the multi-process session front end.

Two primitives, both over ``multiprocessing.shared_memory``:

- :class:`ShmRing` — a single-producer/single-consumer byte ring carrying
  length-prefixed records (the framing the worker<->match-service channel
  uses: pickled fold-request batches one way, match-result rows the
  other). Producer and consumer are in DIFFERENT processes; the ring is
  lock-free — the producer owns ``tail``, the consumer owns ``head``,
  each 8-byte counter store is a single aligned write, and records are
  written fully before the tail is published. That publish ordering is
  what the consumer relies on to never see a torn record. When the
  native fence shim is present (``native/fence.cc`` — a single
  ``atomic_thread_fence``), a RELEASE fence precedes every cursor
  publish (tail on push, head on drain — the head store hands the
  region back to the producer, so the consumer's payload loads must
  retire first) and an ACQUIRE fence follows every peer-cursor read,
  making the ordering architectural on any ISA. Without the shim the pure-Python fallback
  relies on x86-TSO (stores ordered) — correct on the x86-64 deployment
  target, and a LOUD gap elsewhere: :func:`fence_startup_check` warns
  once on a non-x86 ``platform.machine()`` and the ``shm_ring_fence``
  gauge reports which mode is live.

  Shared 8-byte fields are stored through a ``memoryview.cast`` view
  (:func:`_store`: one aligned store of the item's size) and read in
  native format (one aligned load). ``struct.pack_into`` zero-fills its
  target before it writes, and a standard-size ``<Q`` is read one byte
  at a time: the reference stores its cursors that way, so a consumer can
  read a tail of 0 (or torn across a carry), run its head past the real
  tail and lose the framing for good. Two processes streaming records
  through the reference's ring corrupt it within seconds (ROADMAP
  Queue 3).

- :class:`WorkerStatsBlock` — a fixed-layout per-worker stats table
  (pid, heartbeat, overload level/pressure, session + admitted-publish
  counters, a small loop-lag sample ring, a packed stage-histogram
  block, and a packed control-plane EVENT ring) plus a service header
  (epoch/generation/heartbeat). Every worker writes its own slot and
  reads everyone else's: this is how per-worker ``OverloadGovernor``
  instances fuse into one cluster-style aggregate pressure level, how
  histograms and the event journal merge at the scrape point, and
  what ``vmq-admin workers show`` / bench config 11 read.

Blocking helpers (``pop_wait``/``push_wait``) exist for plain-thread
consumers (the match service's drainer). They must never be called from
an ``async def`` body — ``tools/lint_blocking.py`` flags them, exactly
like a bare ``queue.get()``.
"""

from __future__ import annotations

import struct
import time
from array import array
from multiprocessing import shared_memory
from typing import Any, Dict, List, Optional

_MAGIC = 0x564D5152  # "VMQR"
_HDR = 64
_WRAP = 0xFFFFFFFF

#: loop-lag samples retained per worker slot (enough for a p99 over the
#: last ~2 minutes at the 1 Hz sysmon cadence)
LAG_SAMPLES = 64

_STATS_MAGIC = 0x564D5153  # "VMQS"
_STATS_HDR = 128
_SLOT_FIXED = 128 + LAG_SAMPLES * 8


def _pad4(n: int) -> int:
    return (n + 3) & ~3


def _store(buf, off: int, code: str, vals) -> None:
    """Store ``vals`` (format ``code``: ``"Q"``, ``"d"`` or ``"I"``) from
    byte ``off`` of ``buf``, each with one aligned store. The view is
    released at once: a view kept would pin the mapping past its owner's
    close."""
    a = array(code, vals)
    with buf[off:off + a.itemsize * len(a)].cast(code) as view:
        view[:] = a


# --------------------------------------------------------------- fences

_fence_checked = False
_release_fence = None
_acquire_fence = None
_fence_warned = False


def _load_fences() -> None:
    """Bind the native fences on first ring use (lazy: the native
    build must not run at module import)."""
    global _fence_checked, _release_fence, _acquire_fence
    if _fence_checked:
        return
    _fence_checked = True
    try:
        from ..native import fence as _f

        _release_fence = _f.release_fence_fn()
        _acquire_fence = _f.acquire_fence_fn()
    except Exception:
        _release_fence = _acquire_fence = None


def fence_active() -> bool:
    """True when the native release/acquire fences back the ring's tail
    publish (the ``shm_ring_fence`` gauge)."""
    _load_fences()
    return _release_fence is not None


def fence_startup_check() -> bool:
    """Warn ONCE when the rings run on the pure-Python TSO fallback on a
    weakly-ordered host — the one configuration where the publish
    ordering is not guaranteed. Returns fence_active(); called from ring
    creation and the worker-group boot."""
    global _fence_warned
    active = fence_active()
    if not active and not _fence_warned:
        import platform

        machine = platform.machine().lower()
        if machine not in ("x86_64", "amd64", "i686", "i386"):
            _fence_warned = True
            import logging

            logging.getLogger("vernemq_tpu_torch.shm_ring").warning(
                "ShmRing is running the pure-Python x86-TSO publish-"
                "ordering fallback on %s (weakly ordered): torn ring "
                "records are possible under load. Build the native "
                "fence shim (`make -C native`) before deploying the "
                "multi-process front end on this host "
                "(shm_ring_fence gauge = 0).", machine)
    return active


class RingClosed(Exception):
    """The peer marked the ring closed (orderly service shutdown)."""


class RingFull(Exception):
    """No space for the record (the consumer is behind or gone)."""


class ShmRing:
    """SPSC byte ring over one SharedMemory segment.

    Layout: 64B header (magic u32, capacity u64, head u64 @16 — consumer
    cursor, tail u64 @24 — producer cursor, closed u8 @32), then
    ``capacity`` bytes of record storage. Records are ``u32 length`` +
    payload, padded to 4 bytes; a ``0xFFFFFFFF`` length is a wrap marker
    (the rest of the buffer tail is skipped). Cursors are monotonic byte
    counts; ``cursor % capacity`` is the buffer offset.
    """

    def __init__(self, shm: shared_memory.SharedMemory, owner: bool):
        self._shm = shm
        self._buf = shm.buf
        self._owner = owner
        _load_fences()  # bind fences for BOTH ends (attach included)
        (magic,) = struct.unpack_from("I", self._buf, 0)
        if magic != _MAGIC:
            raise ValueError(f"not a ShmRing segment: {shm.name}")
        (self._cap,) = struct.unpack_from("Q", self._buf, 8)

    # ------------------------------------------------------------ lifecycle

    @classmethod
    def create(cls, name: str, capacity: int) -> "ShmRing":
        fence_startup_check()
        capacity = _pad4(max(capacity, 4096))
        shm = shared_memory.SharedMemory(name=name, create=True,
                                         size=_HDR + capacity)
        struct.pack_into("I", shm.buf, 0, _MAGIC)
        struct.pack_into("Q", shm.buf, 8, capacity)
        struct.pack_into("QQ", shm.buf, 16, 0, 0)
        struct.pack_into("B", shm.buf, 32, 0)
        return cls(shm, owner=True)

    @classmethod
    def attach(cls, name: str) -> "ShmRing":
        return cls(shared_memory.SharedMemory(name=name), owner=False)

    @property
    def name(self) -> str:
        return self._shm.name

    @property
    def closed(self) -> bool:
        return bool(self._buf[32])

    def mark_closed(self) -> None:
        self._buf[32] = 1

    def mark_open(self) -> None:
        """Clear the closed flag: a respawned producer re-opens its ring
        (closed means 'the producer is gone', and only the producer may
        say otherwise)."""
        self._buf[32] = 0

    def close(self) -> None:
        """Detach this process's mapping (unlink separately)."""
        try:
            self._buf = None
            self._shm.close()
        except (BufferError, OSError):
            pass

    def unlink(self) -> None:
        if self._owner:
            try:
                self._shm.unlink()
            except OSError:
                pass

    # ------------------------------------------------------------- cursors

    def _head(self) -> int:
        return struct.unpack_from("Q", self._buf, 16)[0]

    def _tail(self) -> int:
        return struct.unpack_from("Q", self._buf, 24)[0]

    def _set_head(self, v: int) -> None:
        _store(self._buf, 16, "Q", (v,))

    def _set_tail(self, v: int) -> None:
        _store(self._buf, 24, "Q", (v,))

    def depth_bytes(self) -> int:
        return self._tail() - self._head()

    # ------------------------------------------------------------ producer

    def push(self, payload: bytes) -> bool:
        """Append one record; returns False (without blocking) when the
        ring lacks space — the caller decides whether that means 'retry
        later' or 'peer is dead, degrade'."""
        if self.closed:
            raise RingClosed(self._shm.name)
        need = 4 + _pad4(len(payload))
        if need > self._cap // 2:
            # beyond cap/2 the worst-case wrap burn (contiguous < need)
            # means the record may NEVER fit even on an empty ring — a
            # plain False would have the caller retry to full timeout
            # instead of degrading immediately
            raise RingFull(f"record of {len(payload)}B exceeds ring "
                           f"capacity {self._cap}B / 2 (can never be "
                           f"guaranteed to fit)")
        head, tail = self._head(), self._tail()
        # pair of the consumer's head-publish release fence: the
        # payload stores below must not be satisfied before this head
        # read, or we could overwrite a region the consumer is still
        # copying out of (no-op on TSO)
        if _acquire_fence is not None:
            _acquire_fence()
        free = self._cap - (tail - head)
        off = tail % self._cap
        contiguous = self._cap - off
        if contiguous < need:
            # wrap: burn the buffer tail with a marker and restart at 0
            if free < contiguous + need:
                return False
            struct.pack_into("I", self._buf, _HDR + off, _WRAP)
            tail += contiguous
            off = 0
        elif free < need:
            return False
        base = _HDR + off
        self._buf[base + 4:base + 4 + len(payload)] = payload
        struct.pack_into("I", self._buf, base, len(payload))
        # publish AFTER the payload bytes are in place: a release fence
        # when the native shim is present (bound by __init__), x86-TSO
        # store ordering on the pure-Python fallback (module docstring)
        if _release_fence is not None:
            _release_fence()
        self._set_tail(tail + need)
        return True

    def push_wait(self, payload: bytes, timeout: float = 1.0,
                  poll_s: float = 0.0005) -> bool:
        """Blocking push for plain-thread producers (NEVER on the event
        loop — lint_blocking flags it)."""
        deadline = time.monotonic() + timeout
        while True:
            if self.push(payload):
                return True
            if time.monotonic() >= deadline:
                return False
            time.sleep(poll_s)

    # ------------------------------------------------------------ consumer

    def pop_many(self, max_records: int = 64) -> List[bytes]:
        """Drain up to ``max_records`` records without blocking."""
        out: List[bytes] = []
        head = self._head()
        tail = self._tail()
        # pair of the producer's release fence: payload reads below must
        # not be satisfied from before the tail read (no-op on TSO)
        if _acquire_fence is not None:
            _acquire_fence()
        while head != tail and len(out) < max_records:
            off = head % self._cap
            (ln,) = struct.unpack_from("I", self._buf, _HDR + off)
            if ln == _WRAP:
                head += self._cap - off
                continue
            base = _HDR + off
            out.append(bytes(self._buf[base + 4:base + 4 + ln]))
            head += 4 + _pad4(ln)
        # head publish is a RELEASE too: it hands the drained region
        # back to the producer, so the payload copies above must
        # complete before the head store becomes visible (ARM permits
        # load->store reordering; no-op on TSO)
        if _release_fence is not None:
            _release_fence()
        self._set_head(head)
        return out

    def pop_wait(self, timeout: float = 1.0,
                 poll_s: float = 0.0005) -> List[bytes]:
        """Blocking drain for plain-thread consumers (NEVER on the event
        loop — lint_blocking flags it)."""
        deadline = time.monotonic() + timeout
        while True:
            got = self.pop_many()
            if got or time.monotonic() >= deadline:
                return got
            if self.closed and self._head() == self._tail():
                raise RingClosed(self._shm.name)
            time.sleep(poll_s)


class WorkerStatsBlock:
    """Fixed-layout shared stats table: one 128B+lag-ring slot per
    worker plus a service header. All fields are written by exactly one
    process (the slot's worker, or the match service for the header) and
    read by anyone; every field is an aligned 8-byte store."""

    def __init__(self, shm: shared_memory.SharedMemory, owner: bool):
        self._shm = shm
        self._buf = shm.buf
        self._owner = owner
        magic, n = struct.unpack_from("II", self._buf, 0)
        if magic != _STATS_MAGIC:
            raise ValueError(f"not a WorkerStatsBlock: {shm.name}")

        self.n_workers = n
        # per-worker stage-histogram + event-ring block layout
        # (observability scrape-point aggregation): written by
        # create(), read here so both sides agree without recompiling
        # constants (a stale pre-events segment reads ev_f64 = 0 and
        # simply has no event region)
        self._hist_f64 = struct.unpack_from("I", self._buf, 120)[0]
        self._ev_f64 = struct.unpack_from("I", self._buf, 124)[0]
        self._slot_bytes = _SLOT_FIXED + (self._hist_f64
                                          + self._ev_f64) * 8

    @classmethod
    def create(cls, name: str, n_workers: int,
               hist_f64: Optional[int] = None,
               ev_f64: Optional[int] = None) -> "WorkerStatsBlock":
        """``hist_f64`` — flat f64 width of one histogram block
        (defaults to the full STAGE_FAMILIES pack width; 0 disables the
        region); ``ev_f64`` — flat f64 width of one packed event ring
        (defaults to events.PACK_WIDTH; 0 disables). One of each per
        worker slot plus ONE per region for the match service process:
        the device-side seams (dispatch, delta, rebuild) and the
        service's own control-plane transitions happen in the service,
        which has no scrape endpoint of its own — its blocks are how
        those observations reach a worker's /metrics and a merged
        event dump."""
        if hist_f64 is None:
            from ..observability import histogram as _hist

            hist_f64 = len(_hist.STAGE_FAMILIES) * _hist.FLAT_WIDTH
        if ev_f64 is None:
            from ..observability import events as _events

            ev_f64 = _events.PACK_WIDTH
        slot = _SLOT_FIXED + (hist_f64 + ev_f64) * 8
        size = _STATS_HDR + n_workers * slot + (hist_f64 + ev_f64) * 8
        shm = shared_memory.SharedMemory(name=name, create=True, size=size)
        shm.buf[:size] = b"\x00" * size
        struct.pack_into("II", shm.buf, 0, _STATS_MAGIC, n_workers)
        struct.pack_into("I", shm.buf, 120, hist_f64)
        struct.pack_into("I", shm.buf, 124, ev_f64)
        return cls(shm, owner=True)

    @classmethod
    def attach(cls, name: str) -> "WorkerStatsBlock":
        return cls(shared_memory.SharedMemory(name=name), owner=False)

    @property
    def name(self) -> str:
        return self._shm.name

    def close(self) -> None:
        try:
            self._buf = None
            self._shm.close()
        except (BufferError, OSError):
            pass

    def unlink(self) -> None:
        if self._owner:
            try:
                self._shm.unlink()
            except OSError:
                pass

    # ------------------------------------------------------ service header

    def set_service(self, epoch: int, pid: int) -> None:
        _store(self._buf, 8, "Q", (epoch,))
        _store(self._buf, 24, "Q", (pid,))
        self.service_heartbeat()

    def service_heartbeat(self) -> None:
        _store(self._buf, 32, "d", (time.time(),))

    def bump_generation(self, n: int = 1) -> None:
        (g,) = struct.unpack_from("Q", self._buf, 16)
        _store(self._buf, 16, "Q", (g + n,))

    def set_service_counters(self, ops: int, folds: int, pubs: int) -> None:
        _store(self._buf, 40, "Q", (ops, folds, pubs))

    def set_service_device(self, host_pubs: int, fold_errors: int,
                           device_batches: int) -> None:
        """The port's addition (header bytes 64-87, unused by the
        reference's layout): publishes the service's collector and matcher
        served off the device, folds that failed, device match batches."""
        _store(self._buf, 64, "Q", (host_pubs, fold_errors, device_batches))

    def set_service_launches(self, tile: int, extract: int,
                             plain: int) -> None:
        """The port's addition (header bytes 88-111, unused by the
        reference's layout): the service process's kernel launches — tile
        matcher and extraction — and its plain extractions on the card
        (``match_kernel.plain_cuda_extractions``)."""
        _store(self._buf, 88, "Q", (tile, extract, plain))

    def service_launches(self) -> Dict[str, int]:
        tile, extract, plain = struct.unpack_from("3Q", self._buf, 88)
        return {"tile": tile, "extract": extract, "plain": plain}

    def set_service_dense(self, dense: int, plain_packs: int) -> None:
        """The port's addition (header bytes 112-119, unused by the
        reference's layout): the service process's dense-mode tile
        launches (``tile_match.dense_launches``) and its plain bit-packs
        on the card (``match_kernel.plain_cuda_packs``), two uint32 kept
        modulo 2^32 (a reader takes differences modulo 2^32)."""
        _store(self._buf, 112, "I", (dense & 0xFFFFFFFF,
                                     plain_packs & 0xFFFFFFFF))

    def service_dense(self) -> Dict[str, int]:
        dense, packs = struct.unpack_from("2I", self._buf, 112)
        return {"dense": dense, "plain_packs": packs}

    def service_info(self) -> Dict[str, Any]:
        epoch, gen, pid = struct.unpack_from("QQQ", self._buf, 8)
        (hb,) = struct.unpack_from("d", self._buf, 32)
        ops, folds, pubs, host, errors, batches = struct.unpack_from(
            "6Q", self._buf, 40)
        return {"epoch": epoch, "generation": gen, "pid": pid,
                "heartbeat_age_s": (time.time() - hb) if hb else None,
                "ops": ops, "folds": folds, "fold_pubs": pubs,
                "host_pubs": host, "fold_errors": errors,
                "device_batches": batches}

    def generation(self) -> int:
        return struct.unpack_from("Q", self._buf, 16)[0]

    def epoch(self) -> int:
        return struct.unpack_from("Q", self._buf, 8)[0]

    # -------------------------------------------------------- worker slots

    def _base(self, idx: int) -> int:
        if not 0 <= idx < self.n_workers:
            raise IndexError(f"worker slot {idx} of {self.n_workers}")
        return _STATS_HDR + idx * self._slot_bytes

    def write_health(self, idx: int, *, pid: int, sessions: int,
                     admitted: int) -> None:
        b = self._base(idx)
        _store(self._buf, b, "Q", (pid,))
        _store(self._buf, b + 8, "d", (time.time(),))
        _store(self._buf, b + 32, "Q", (sessions, admitted))

    def write_offcard(self, idx: int, host_pubs: int,
                      folds_failed: int) -> None:
        """The port's addition (slot bytes 56-71, unused by the
        reference's layout): a worker's publishes its collector served
        from its local trie, and its match-service folds that timed out,
        were refused or were held."""
        _store(self._buf, self._base(idx) + 56, "Q", (host_pubs, folds_failed))

    def write_overload(self, idx: int, level: int, pressure: float) -> None:
        _store(self._buf, self._base(idx) + 16, "d", (float(level), pressure))

    def push_lag(self, idx: int, lag_s: float) -> None:
        b = self._base(idx)
        (i,) = struct.unpack_from("Q", self._buf, b + 48)
        _store(self._buf, b + 128 + (i % LAG_SAMPLES) * 8, "d", (lag_s,))
        _store(self._buf, b + 48, "Q", (i + 1,))

    def read_slot(self, idx: int) -> Dict[str, Any]:
        b = self._base(idx)
        (pid,) = struct.unpack_from("Q", self._buf, b)
        (hb,) = struct.unpack_from("d", self._buf, b + 8)
        level, pressure = struct.unpack_from("dd", self._buf, b + 16)
        sessions, admitted, n_lag, host, failed = struct.unpack_from(
            "5Q", self._buf, b + 32)
        k = min(n_lag, LAG_SAMPLES)
        lags = list(struct.unpack_from(f"{k}d", self._buf, b + 128))
        return {"worker": idx, "pid": pid,
                "heartbeat_age_s": (time.time() - hb) if hb else None,
                "level": int(level), "pressure": pressure,
                "sessions": sessions, "admitted_pubs": admitted,
                "host_pubs": host, "folds_failed": failed,
                "lag_samples": lags}

    def read_all(self) -> List[Dict[str, Any]]:
        return [self.read_slot(i) for i in range(self.n_workers)]

    # -------------------------------------------------- histogram slots

    def write_hist(self, idx: int, flat: List[float]) -> None:
        """Publish this worker's packed stage-histogram snapshot
        (observability.histogram.pack_all) into its slot. Single writer
        per slot; readers tolerate a mid-write tear — bucket counts are
        monotone, so the next heartbeat restores consistency and a
        scrape can only ever under-report by one interval."""
        if not self._hist_f64:
            return
        self._write_f64(self._base(idx) + _SLOT_FIXED, flat, self._hist_f64)

    def read_hist(self, idx: int) -> List[float]:
        if not self._hist_f64:
            return []
        return self._read_f64(self._base(idx) + _SLOT_FIXED, self._hist_f64)

    # ---------------------------------------------------- event slots

    def write_events(self, idx: int, flat: List[float]) -> None:
        """Publish this worker's packed event ring
        (observability.events.EventJournal.pack) into its slot. Single
        writer per slot; a torn read at worst drops/garbles one entry,
        which unpack() skips and the next heartbeat repairs."""
        if not self._ev_f64:
            return
        self._write_f64(self._base(idx) + _SLOT_FIXED + self._hist_f64 * 8,
                        flat, self._ev_f64)

    def read_events(self, idx: int) -> List[float]:
        if not self._ev_f64:
            return []
        return self._read_f64(
            self._base(idx) + _SLOT_FIXED + self._hist_f64 * 8, self._ev_f64)

    def write_service_events(self, flat: List[float]) -> None:
        if not self._ev_f64:
            return
        self._write_f64(self._service_hist_base() + self._hist_f64 * 8,
                        flat, self._ev_f64)

    def read_service_events(self) -> List[float]:
        if not self._ev_f64:
            return []
        return self._read_f64(self._service_hist_base() + self._hist_f64 * 8,
                              self._ev_f64)

    def _service_hist_base(self) -> int:
        return _STATS_HDR + self.n_workers * self._slot_bytes

    def write_service_hist(self, flat: List[float]) -> None:
        """The match service's packed histogram block (single writer:
        the service process) — how the device-side stage observations
        reach the workers' scrape endpoints."""
        if not self._hist_f64:
            return
        self._write_f64(self._service_hist_base(), flat, self._hist_f64)

    def read_service_hist(self) -> List[float]:
        if not self._hist_f64:
            return []
        return self._read_f64(self._service_hist_base(), self._hist_f64)

    def _write_f64(self, off: int, flat: List[float], width: int) -> None:
        _store(self._buf, off, "d", flat[:min(len(flat), width)])

    def _read_f64(self, off: int, width: int) -> List[float]:
        return list(struct.unpack_from(f"{width}d", self._buf, off))

    def peer_pressure(self, my_idx: int,
                      stale_s: float = 5.0) -> Dict[str, float]:
        """Fused view of the OTHER workers: max overload pressure and
        level across live slots (heartbeat fresher than ``stale_s``) —
        the governor's ``workers`` signal. A dead worker's last written
        pressure must not pin everyone at L3 forever, hence the
        staleness gate."""
        now = time.time()
        pressure = 0.0
        level = 0.0
        for i in range(self.n_workers):
            if i == my_idx:
                continue
            b = self._base(i)
            (hb,) = struct.unpack_from("d", self._buf, b + 8)
            if not hb or now - hb > stale_s:
                continue
            lv, p = struct.unpack_from("dd", self._buf, b + 16)
            pressure = max(pressure, p)
            level = max(level, lv)
        return {"pressure": pressure, "level": level}
