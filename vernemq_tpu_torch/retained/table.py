"""Host-side management of the device-resident retained-topic table.

The mutation half of the retained reverse-match engine (the dual of
``models/table.py``): retain set/delete land in numpy mirrors plus a
dirty-slot set, ``RetainedIndex.sync()`` ships them as one fused scatter,
and capacity growth repartitions + re-uploads (``resized``). Word ids are
interned with the same :class:`~vernemq_tpu_torch.models.table.WordInterner`
machinery — retained-topic words **intern** (they are the stored side) and
query-filter words **look up** (a word no retained topic uses can only
match via ``+``/``#``), the exact inverse of the subscription table.

Rows are literal topics, so the layout needs no wildcard zones: slots are
allocated inside per-bucket regions hashed by the topic's level-0 word
(the retain trie's first-edge narrowing recast dense, like the forward
table's buckets) so a concrete-level-0 filter probes ~one region instead
of the whole table. Buckets are finer than the forward table's
(``min(512, cap/512)``): retained probes ride narrow compare windows, not
MXU matmuls, so small regions directly shrink per-query work. Total
capacity stays ``% 2048`` and regions ``% 256`` for the packed-extraction
blocks. Topics longer than ``L`` levels overflow to a host dict.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..models.table import (
    FIRST_WORD_ID, MAX_IDS_16, MAX_IDS_24, PAD_ID, PLUS_ID, UNKNOWN_ID,
    WordInterner, _bucket_for,
)
from ..protocol.topic import HASH, PLUS

REGION_ALIGN = 256   # bucket regions start/size-align to this
TOTAL_ALIGN = 2048   # total capacity aligns to this (dense packed extract)


def _nb_for_retained(total_hint: int) -> int:
    """Hashed-bucket count for a retained table sized ``total_hint``
    (1 = flat). Finer than the forward table's: per-query probe work ~
    region size."""
    if total_hint < 8192:
        return 1
    return min(512, max(1, total_hint // 512))

#: max level-0 words that get a DEDICATED region each (rebuild-time):
#: hashing low-cardinality word populations collides 2-3 words into one
#: bucket, and the widest bucket sets EVERY probe's window width — a
#: region per word removes that skew exactly like the trie's first edge
MAX_DEDICATED = 512


class RetainedTopicTable:
    """Bucket-partitioned retained-topic store: numpy mirrors + slots.

    Rows hold interned level ids; the per-slot payload ``(topic, value)``
    stays host-side — the reverse kernel returns slot indices and the
    host maps them back, mirroring the forward table's entries contract.
    """

    def __init__(self, max_levels: int = 16, initial_capacity: int = 2048):
        self.L = max_levels
        self.interner = WordInterner()
        self._slot_of: Dict[Tuple[str, ...], int] = {}
        self.dirty: set = set()
        self.resized = True  # force first full upload
        self.count = 0
        # topics longer than L levels: host-matched overflow (kept tiny)
        self.overflow: Dict[Tuple[str, ...], Any] = {}
        self.entries: List[Optional[Tuple[Tuple[str, ...], Any]]] = []
        self._alloc(max(initial_capacity, TOTAL_ALIGN))

    # ----------------------------------------------------------- region mgmt

    @property
    def id_bits(self) -> int:
        """Byte-plane width for the coded dense operand (0 = too many
        ids; the index then serves host-side)."""
        n = len(self.interner)
        if n <= MAX_IDS_16:
            return 16
        if n <= MAX_IDS_24:
            return 24
        return 0

    def _alloc(self, total_hint: int,
               need: Optional[List[int]] = None,
               dedicated: Optional[Dict[int, int]] = None,
               nbh: Optional[int] = None) -> None:
        """(Re)build the region layout for ``total_hint`` rows with
        per-region entry counts ``need``; the caller re-inserts.
        ``dedicated`` maps level-0 word ids to their own regions
        (1..NBD); everything else hashes into the ``nbh`` tail buckets."""
        self._dedicated = dedicated or {}
        self.NBD = len(self._dedicated)
        self.NBH = nbh or _nb_for_retained(total_hint)
        self.NB = self.NBD + self.NBH
        # monotone layout generation: rebuilds REMAP word->region (the
        # dedicated set is re-ranked by count), so anything caching
        # region assignments must key on this, not on NBD/NBH alone
        self.layout_gen = getattr(self, "layout_gen", 0) + 1
        self._bucket_cache: Dict[int, int] = {}
        align = REGION_ALIGN if total_hint >= 8192 else 8
        nreg = 1 + self.NB  # region 0 stays empty (keeps region ids 1-based)
        if need is None:
            need = [0] * nreg
        if len(need) != nreg:
            need = (need + [0] * nreg)[:nreg]
        spare = max(total_hint - 2 * sum(need), 0) // self.NB
        caps = [0] + [max(2 * n + spare, align) for n in need[1:]]
        caps = [0] + [-(-c // align) * align for c in caps[1:]]
        caps[-1] += -sum(caps) % TOTAL_ALIGN
        self.reg_cap = np.asarray(caps, dtype=np.int64)
        self.reg_start = np.concatenate(
            [[0], np.cumsum(self.reg_cap)[:-1]]).astype(np.int64)
        self.cap = int(self.reg_cap.sum())
        self._region_of_slot = np.zeros(self.cap, dtype=np.uint16)
        for r in range(nreg):
            s0, c0 = int(self.reg_start[r]), int(self.reg_cap[r])
            self._region_of_slot[s0:s0 + c0] = r
        # per-region live high-water (slot offsets fill from the region
        # start): probe windows cover [start, start+high) instead of the
        # 2x-headroom capacity — scan work tracks LIVE rows, not caps
        self.reg_high = np.zeros(nreg, dtype=np.int64)
        # deepest topic ever stored: the kernels compare only this many
        # levels (a filter with more concrete levels than any row is
        # killed by the length rule, so shallower compares stay exact)
        self.max_row_len = 1
        self.words = np.zeros((self.cap, self.L), dtype=np.int32)
        self.row_len = np.zeros(self.cap, dtype=np.int32)
        self.row_dollar = np.zeros(self.cap, dtype=bool)
        self.active = np.zeros(self.cap, dtype=bool)
        self.entries = [None] * self.cap
        self._free = [
            list(range(int(s + c) - 1, int(s) - 1, -1))
            for s, c in zip(self.reg_start, self.reg_cap)
        ]
        self.resized = True
        self.dirty.clear()

    def _bucket_of_id(self, word0_id: int) -> int:
        """Region for a level-0 word: its dedicated region when it has
        one (rebuild-time hot words), else a hashed tail bucket."""
        r = self._dedicated.get(word0_id)
        if r is not None:
            return r
        if self.NBH == 1:
            return self.NBD + 1
        b = self._bucket_cache.get(word0_id)
        if b is None:
            b = self._bucket_cache[word0_id] = \
                self.NBD + _bucket_for(word0_id, self.NBH)
        return b

    def query_region(self, word0_id: int) -> int:
        """Region a concrete-level-0 filter probes (mirrors the
        topic-side mapping, including never-interned words)."""
        return self._bucket_of_id(word0_id)

    def bucket_max(self) -> int:
        """Widest bucket region (probe-window sizing)."""
        return int(self.reg_cap[1:].max())

    def _rebuild(self) -> None:
        """Repartition all regions (doubling total), re-homing every
        entry. Slot numbers change wholesale; ``resized`` forces the
        full device upload.

        Region assignment is need-counted per level-0 word: the top
        :data:`MAX_DEDICATED` words get one region EACH (no hash
        collisions — the widest region sets every probe's window width,
        and on low-cardinality word populations hashing lands 2-3 words
        in one bucket, doubling every query's scan), the tail hashes."""
        old = [e for e in self.entries if e is not None]
        total_hint = max(2 * max(self.count - len(self.overflow), 1),
                         self.cap)
        counts: Dict[int, int] = {}
        for topic, _v in old:
            wid = self.interner.intern(topic[0])
            counts[wid] = counts.get(wid, 0) + 1
        hot = sorted(counts, key=lambda w: -counts[w])[:MAX_DEDICATED]
        dedicated = {wid: 1 + i for i, wid in enumerate(hot)}
        tail_total = sum(n for w, n in counts.items() if w not in dedicated)
        nbh = max(1, _nb_for_retained(max(2 * tail_total, 1)))
        nbd = len(dedicated)
        need = [0] * (1 + nbd + nbh)
        for wid, n in counts.items():
            r = dedicated.get(wid)
            if r is None:
                r = nbd + (_bucket_for(wid, nbh) if nbh > 1 else 1)
            need[r] += n
        self._alloc(total_hint, need, dedicated, nbh)
        self._slot_of.clear()
        for topic, value in old:
            self._insert(topic, value)

    # ------------------------------------------------------------- mutation

    def _insert(self, topic: Tuple[str, ...], value: Any) -> None:
        region = self._bucket_of_id(self.interner.intern(topic[0]))
        if not self._free[region]:
            self._rebuild()
            region = self._bucket_of_id(self.interner.intern(topic[0]))
        slot = self._free[region].pop()
        intern = self.interner.intern
        wrow = self.words[slot]
        ids = [intern(w) for w in topic]
        wrow[:len(ids)] = ids
        wrow[len(ids):] = PAD_ID
        self.row_len[slot] = len(topic)
        self.row_dollar[slot] = topic[0].startswith("$")
        self.active[slot] = True
        off = slot - int(self.reg_start[region]) + 1
        if off > self.reg_high[region]:
            self.reg_high[region] = off
        if len(topic) > self.max_row_len:
            self.max_row_len = len(topic)
        self.entries[slot] = (topic, value)
        self._slot_of[topic] = slot
        self.dirty.add(slot)

    def insert(self, topic: Sequence[str], value: Any) -> None:
        """Store/replace the retained row for ``topic``."""
        t = tuple(topic)
        if not t or len(t) > self.L:
            if t not in self.overflow:
                self.count += 1
            self.overflow[t] = value
            return
        existing = self._slot_of.get(t)
        if existing is not None:
            # payload replace: device row unchanged, but snapshot
            # consumers resolve entries by dirty slot
            self.entries[existing] = (t, value)
            self.dirty.add(existing)
            return
        self._insert(t, value)
        self.count += 1

    def delete(self, topic: Sequence[str]) -> bool:
        t = tuple(topic)
        if not t or len(t) > self.L:
            if self.overflow.pop(t, None) is not None:
                self.count -= 1
                return True
            return False
        slot = self._slot_of.pop(t, None)
        if slot is None:
            return False
        self.active[slot] = False
        self.entries[slot] = None
        self._free[int(self._region_of_slot[slot])].append(slot)
        self.dirty.add(slot)
        self.count -= 1
        return True

    # ------------------------------------------------------------ query side

    def encode_filter(self, fw: Sequence[str]):
        """Filter → ``(row [L], eff_len, has_hash, first_wild, region)``.
        ``region`` is the level-0 bucket to probe, 0 for wildcard-first
        filters (dense phase), -1 for filters the device cannot serve
        (empty, or more concrete levels than ``L`` — only host overflow
        topics could match those). Filter words NEVER intern."""
        fw = tuple(fw)
        hh = bool(fw) and fw[-1] == HASH
        concrete = fw[:-1] if hh else fw
        if not fw or len(concrete) > self.L:
            return None, 0, hh, False, -1
        row = np.full(self.L, PAD_ID, dtype=np.int32)
        lookup = self.interner.lookup
        for i, w in enumerate(concrete):
            row[i] = PLUS_ID if w == PLUS else lookup(w)
        first_wild = fw[0] in (PLUS, HASH)
        region = 0 if first_wild else self.query_region(int(row[0]))
        return row, len(concrete), hh, first_wild, region

    def stats(self) -> Dict[str, int]:
        return {
            "rows": self.count - len(self.overflow),
            "capacity": self.cap,
            "buckets": self.NB,
            "interned_words": len(self.interner),
            "overflow": len(self.overflow),
            "table_bytes": int(self.words.nbytes + self.row_len.nbytes
                               + self.row_dollar.nbytes + self.active.nbytes),
        }
