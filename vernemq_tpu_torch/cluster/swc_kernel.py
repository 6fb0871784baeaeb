"""Server-Wide-Clocks kernel: the pure logical-clock algebra underneath the
SWC metadata store.

Plays the role of the reference's ``swc`` dependency (the `swc_node` /
`swc_vv` / `swc_kv` / `swc_watermark` modules consumed at
``vmq_swc_store.erl:105-107`` and ``vmq_swc_exchange_fsm.erl:79,95``, plus
the dot-key-map ``vmq_swc_dkm.erl``), re-implemented from the
server-wide-clock semantics those call sites rely on:

- **BVV** (bitmapped version vector, the *node clock*): ``{node_id:
  (base, bitmap)}`` — counters ``1..base`` are all seen, plus bit ``k`` of
  ``bitmap`` marks ``base+k+1`` seen.  One dot per *server event*, not per
  key — that is the whole point of SWC: per-key causality metadata stays
  O(#concurrent-writers), not O(#nodes).
- **DCC** (dotted causal container, the per-key *object*): ``(dots, vv)``
  where ``dots`` maps ``(node_id, counter)`` → value (concurrent siblings)
  and ``vv`` is the causal context as a plain version vector.
- **Watermark** (key-matrix): ``{node_id: {node_id: counter}}`` — row *A*,
  column *B* holds the highest of B's counters that A is known to have
  seen; the column minimum bounds which dots may be GC'd from the log.
- **DotKeyMap**: the write-log index ``dot → key`` driving both
  anti-entropy (``sync_missing``) and watermark-based GC.

Everything here is pure data (dicts/tuples/ints) so the cluster codec can
ship clocks and objects between nodes unmodified.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional, Set, Tuple

NodeId = str
Entry = Tuple[int, int]          # (base, bitmap)
BVV = Dict[NodeId, Entry]
Dot = Tuple[NodeId, int]
VV = Dict[NodeId, int]
DCC = Tuple[Dict[Dot, Any], VV]

#: tombstone marker stored as a dot value for deletes (the reference's
#: ``'$deleted'`` atom, vmq_swc_store.erl sync_missing / process_write_op)
DELETED = "$swc_deleted$"


# --------------------------------------------------------------------- BVV

def entry_norm(e: Entry) -> Entry:
    """Fold contiguous low bits of the bitmap into the base."""
    n, b = e
    while b & 1:
        n += 1
        b >>= 1
    return n, b


def entry_contains(e: Entry, c: int) -> bool:
    n, b = e
    if c <= n:
        return True
    return bool((b >> (c - n - 1)) & 1)


def entry_add(e: Entry, c: int) -> Entry:
    n, b = e
    if c <= n:
        return e
    return entry_norm((n, b | (1 << (c - n - 1))))


def entry_join(a: Entry, b: Entry) -> Entry:
    (n1, b1), (n2, b2) = a, b
    if n1 < n2:
        (n1, b1), (n2, b2) = (n2, b2), (n1, b1)
    return entry_norm((n1, b1 | (b2 >> (n1 - n2))))


def entry_missing(remote: Entry, local: Entry) -> List[int]:
    """Counters seen by ``remote`` but not by ``local`` (ascending).
    O(gap), not O(history): everything at or below local's contiguous
    base is contained by definition."""
    rn, rb = remote
    lbase = entry_norm(local)[0]
    out = []
    for c in range(lbase + 1, rn + 1):
        if not entry_contains(local, c):
            out.append(c)
    k = 0
    while rb:
        if rb & 1:
            c = rn + k + 1
            if not entry_contains(local, c):
                out.append(c)
        rb >>= 1
        k += 1
    return out


def bvv_new() -> BVV:
    return {}


def bvv_add(clock: BVV, dot: Dot) -> BVV:
    nid, c = dot
    clock = dict(clock)
    clock[nid] = entry_add(clock.get(nid, (0, 0)), c)
    return clock


def bvv_event(clock: BVV, nid: NodeId) -> Tuple[int, BVV]:
    """Mint the next counter for ``nid`` (swc_node:event used at
    vmq_swc_store.erl process_write_op)."""
    n, b = entry_norm(clock.get(nid, (0, 0)))
    clock = dict(clock)
    clock[nid] = entry_norm((n + 1, b >> 1))
    return n + 1, clock


def bvv_merge(a: BVV, b: BVV) -> BVV:
    out = dict(a)
    for nid, e in b.items():
        out[nid] = entry_join(out[nid], e) if nid in out else entry_norm(e)
    return out


def bvv_base(clock: BVV) -> BVV:
    """Drop the bitmaps — only the contiguous prefix survives (what the
    exchange sends as the authoritative remote clock)."""
    return {nid: (entry_norm(e)[0], 0) for nid, e in clock.items()}


def bvv_contains(clock: BVV, dot: Dot) -> bool:
    e = clock.get(dot[0])
    return e is not None and entry_contains(e, dot[1])


def bvv_missing_dots(remote: BVV, local: BVV,
                     ids: Optional[Iterable[NodeId]] = None) -> List[Dot]:
    """Dots the remote clock covers that the local clock does not — the
    exchange's shopping list (vmq_swc_exchange_fsm.erl update_local)."""
    out: List[Dot] = []
    for nid in (ids if ids is not None else remote.keys()):
        re = remote.get(nid)
        if re is None:
            continue
        for c in entry_missing(re, local.get(nid, (0, 0))):
            out.append((nid, c))
    return out


# --------------------------------------------------------------------- DCC

def dcc_new() -> DCC:
    return {}, {}


def dcc_values(obj: DCC) -> List[Any]:
    return [v for v in obj[0].values() if v != DELETED]


def dcc_context(obj: DCC) -> VV:
    return obj[1]


def dcc_add(obj: DCC, dot: Dot, value: Any) -> DCC:
    dots, ctx = dict(obj[0]), dict(obj[1])
    dots[dot] = value
    ctx[dot[0]] = max(ctx.get(dot[0], 0), dot[1])
    return dots, ctx


def dcc_fill(obj: DCC, clock: BVV) -> DCC:
    """Extend the causal context with the node clock's contiguous base for
    every known node (swc_kv:fill)."""
    dots, ctx = obj
    ctx = dict(ctx)
    for nid, e in clock.items():
        base = entry_norm(e)[0]
        if base > ctx.get(nid, 0):
            ctx[nid] = base
    return dots, ctx


def dcc_strip(obj: DCC, clock: BVV) -> DCC:
    """Inverse of fill: drop context entries already covered by the node
    clock base — they are reconstructed on read (swc_kv:strip)."""
    dots, ctx = obj
    out = {nid: c for nid, c in ctx.items()
           if c > entry_norm(clock.get(nid, (0, 0)))[0]}
    return dots, out


def dcc_discard(obj: DCC, ctx: VV) -> DCC:
    """Drop dot-values made obsolete by a causal context (swc_kv:discard —
    the read-modify-write path)."""
    dots, own = obj
    kept = {d: v for d, v in dots.items() if d[1] > ctx.get(d[0], 0)}
    merged = dict(own)
    for nid, c in ctx.items():
        merged[nid] = max(merged.get(nid, 0), c)
    return kept, merged


def dcc_sync(a: DCC, b: DCC) -> DCC:
    """Merge two versions of the same key: keep dots present in both, plus
    dots one side has that the *other side's context* does not cover
    (swc_kv:sync — the anti-entropy merge)."""
    (d1, c1), (d2, c2) = a, b
    dots: Dict[Dot, Any] = {}
    for d, v in d1.items():
        if d in d2 or d[1] > c2.get(d[0], 0):
            dots[d] = v
    for d, v in d2.items():
        if d in d1 or d[1] > c1.get(d[0], 0):
            dots[d] = v
    ctx = dict(c1)
    for nid, c in c2.items():
        ctx[nid] = max(ctx.get(nid, 0), c)
    return dots, ctx


def bvv_add_dcc(clock: BVV, obj: DCC) -> BVV:
    """Record every dot of an object in the node clock (swc_kv:add/2 as
    used in fill_strip_save_batch)."""
    for dot in obj[0]:
        clock = bvv_add(clock, dot)
    return clock


def dcc_to_wire(obj: DCC) -> list:
    """Codec-friendly shape: dict keys must not be tuples on the wire for
    portability, so dots travel as a list of [node, counter, value]."""
    dots, ctx = obj
    return [[[nid, c, v] for (nid, c), v in dots.items()], dict(ctx)]


def dcc_from_wire(w) -> DCC:
    dots_w, ctx = w
    return ({(nid, c): v for nid, c, v in dots_w}, dict(ctx))


# --------------------------------------------------------------- watermark

Watermark = Dict[NodeId, VV]


def wm_new() -> Watermark:
    return {}


def wm_get(wm: Watermark, a: NodeId, b: NodeId) -> int:
    return wm.get(a, {}).get(b, 0)


def wm_update_cell(wm: Watermark, a: NodeId, b: NodeId, c: int) -> Watermark:
    wm = {k: dict(v) for k, v in wm.items()}
    row = wm.setdefault(a, {})
    row[b] = max(row.get(b, 0), c)
    return wm


def wm_update_peer(wm: Watermark, peer: NodeId, clock: BVV) -> Watermark:
    """Record that ``peer`` has seen at least the contiguous base of
    ``clock`` (swc_watermark:update_peer)."""
    wm = {k: dict(v) for k, v in wm.items()}
    row = wm.setdefault(peer, {})
    for nid, e in clock.items():
        base = entry_norm(e)[0]
        row[nid] = max(row.get(nid, 0), base)
    return wm


def wm_left_join(a: Watermark, b: Watermark) -> Watermark:
    """Pointwise-max join of b's rows into a, keeping only a's row keys
    (swc_watermark:left_join in update_watermark_after_sync)."""
    out = {k: dict(v) for k, v in a.items()}
    for peer, row in b.items():
        if peer not in out:
            continue
        mine = out[peer]
        for nid, c in row.items():
            mine[nid] = max(mine.get(nid, 0), c)
    return out


def wm_min(wm: Watermark, nid: NodeId, peers: Iterable[NodeId]) -> int:
    """Highest counter of ``nid`` that *every* peer is known to have seen —
    the GC horizon for nid's dots."""
    lo: Optional[int] = None
    for p in peers:
        c = wm.get(p, {}).get(nid, 0)
        lo = c if lo is None else min(lo, c)
    return lo or 0


def wm_fix(wm: Watermark, peers: List[NodeId]) -> Watermark:
    """Restrict the matrix to the current peer set, preserving surviving
    cells (fix_watermark at vmq_swc_store.erl set_peers)."""
    out: Watermark = {}
    for a in peers:
        out[a] = {b: wm_get(wm, a, b) for b in peers}
    return out


# -------------------------------------------------------------- dot-key map

class DotKeyMap:
    """Write-log index: dot → key, plus per-key liveness for GC
    (vmq_swc_dkm.erl: insert / mark_for_gc / prune / prune_for_peer)."""

    def __init__(self) -> None:
        self.log: Dict[NodeId, Dict[int, Any]] = {}
        self._key_dots: Dict[Any, Set[Dot]] = {}
        self._gc_marked: Set[Any] = set()

    def insert(self, nid: NodeId, counter: int, key: Any) -> None:
        self.log.setdefault(nid, {})[counter] = key
        self._key_dots.setdefault(key, set()).add((nid, counter))

    def lookup(self, dot: Dot) -> Optional[Any]:
        return self.log.get(dot[0], {}).get(dot[1])

    def mark_for_gc(self, key: Any) -> None:
        self._gc_marked.add(key)

    def unmark(self, key: Any) -> None:
        self._gc_marked.discard(key)

    def prune(self, wm: Watermark,
              peers: List[NodeId]) -> Tuple[List[Any], List[Dot]]:
        """Drop log entries every peer has seen; return (keys whose
        tombstones may now be deleted outright, the pruned dots) — the
        dots let the caller drop their durable log records too."""
        deletable: List[Any] = []
        pruned: List[Dot] = []
        for nid, row in list(self.log.items()):
            horizon = wm_min(wm, nid, peers)
            if horizon <= 0:
                continue
            for c in [c for c in row if c <= horizon]:
                key = row.pop(c)
                pruned.append((nid, c))
                dots = self._key_dots.get(key)
                if dots is not None:
                    dots.discard((nid, c))
                    if not dots:
                        del self._key_dots[key]
                        if key in self._gc_marked:
                            self._gc_marked.discard(key)
                            deletable.append(key)
            if not row:
                del self.log[nid]
        return deletable, pruned

    def prune_for_peer(self, nid: NodeId) -> None:
        row = self.log.pop(nid, None)
        if not row:
            return
        for c, key in row.items():
            dots = self._key_dots.get(key)
            if dots is not None:
                dots.discard((nid, c))
                if not dots:
                    del self._key_dots[key]
                    self._gc_marked.discard(key)

    def object_count(self) -> int:
        return len(self._key_dots)

    def tombstone_count(self) -> int:
        return len(self._gc_marked)
