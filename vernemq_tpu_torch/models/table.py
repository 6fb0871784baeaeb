"""Host-side management of the device-resident subscription table.

The port's own copy of ``vernemq_tpu/models/tpu_table.py`` (same layout,
same slot allocation, so both engines place every filter in the same row):
subscribe/unsubscribe land in numpy mirrors plus a dirty-slot set, and the
matcher's ``sync()`` ships them to the card as one in-place scatter.
Capacity grows by doubling (full re-upload), word ids are interned, and
filters longer than ``L`` levels overflow to a host trie so the device
arrays stay rectangular.
"""

from __future__ import annotations

from typing import Any, Dict, Hashable, List, Optional, Sequence, Tuple

import numpy as np

from ..protocol.topic import HASH, PLUS
from .trie import SubscriptionTrie

PAD_ID = 0
PLUS_ID = 1
HASH_ID = 2
FIRST_WORD_ID = 3
UNKNOWN_ID = -2  # publish words never seen in any subscription

# id width for the coded match operands (ops/match_kernel.build_operands):
# 16-bit while every interned id's byte planes stay clear of UNKNOWN_ID's
# (-2 → planes 254,255); beyond that, 24-bit; beyond THAT, the level scan.
MAX_IDS_16 = (1 << 16) - FIRST_WORD_ID - 2
MAX_IDS_24 = (1 << 24) - FIRST_WORD_ID - 2

REGION_ALIGN = 256    # bucket regions start/size-align to this
GLOBAL_ALIGN = 2048   # global region + total capacity align (packed extract)


_M64 = (1 << 64) - 1


def _splitmix32(x: int) -> int:
    """Deterministic 32-bit mix (splitmix64's finalizer, truncated) — maps
    interned word ids to buckets without correlating with intern order."""
    z = ((x & 0xFFFFFFFF) + 0x9E3779B97F4A7C15) & _M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return (z ^ (z >> 31)) & 0xFFFFFFFF


def _nb_for(total_hint: int) -> int:
    """Bucket count for a table sized ``total_hint`` (1 = flat layout)."""
    if total_hint < 8192:
        return 1
    return min(256, max(1, total_hint // 2048))


def _bucket_for(word0_id: int, nb: int) -> int:
    """Region (1-based) for a level-0 word id under ``nb`` buckets."""
    return _splitmix32(word0_id & 0xFFFFFFFF) % nb + 1


class WordInterner:
    def __init__(self) -> None:
        self._ids: Dict[str, int] = {}
        self._next = FIRST_WORD_ID

    def intern(self, word: str) -> int:
        """Id for a subscription word (allocates)."""
        i = self._ids.get(word)
        if i is None:
            i = self._next
            self._next = i + 1
            self._ids[word] = i
        return i

    def lookup(self, word: str) -> int:
        """Id for a publish word (never allocates: a word no subscription
        uses can only match via ``+``/``#``)."""
        return self._ids.get(word, UNKNOWN_ID)

    def __len__(self) -> int:
        return self._next - FIRST_WORD_ID


class SubscriptionTable:
    """Bucket-partitioned subscription store: numpy mirrors + slot keeping.

    Rows hold interned level ids; the per-slot payload (key, opts) stays
    host-side — the kernel returns slot indices, the host maps them back,
    mirroring the fold returning subscriber rows (vmq_reg_trie.erl:60-85).

    Slots are allocated inside per-bucket REGIONS so the device arrays are
    bucket-sorted at all times: region 0 holds wildcard-first filters
    (``+``/``#`` at level 0 — the only ones a publish can match regardless
    of its first word), regions 1..NB hold filters hashed by their level-0
    word. This is the trie's first-edge narrowing
    (``vmq_reg_trie.erl:358-371``) recast as a dense layout: the bucketed
    matcher reads each region ~once per batch instead of B times. A region
    filling up triggers a full repartition (amortized doubling, like the
    old flat growth) and a full device re-upload (``resized``).
    """

    def __init__(self, max_levels: int = 16, initial_capacity: int = 1024):
        self.L = max_levels
        self.interner = WordInterner()
        self._slot_of: Dict[Tuple[Tuple[str, ...], Hashable], int] = {}
        self.dirty: set = set()
        self.resized = True  # force first full upload
        # filters longer than L levels: host-trie overflow (kept tiny)
        self.overflow = SubscriptionTrie()
        self.count = 0
        self.entries: List[Optional[Tuple[Tuple[str, ...], Hashable, Any]]] = []
        self._alloc_regions(max(initial_capacity, 16))

    # ----------------------------------------------------------- region mgmt

    @property
    def bucketed(self) -> bool:
        """Whether the layout satisfies the bucketed matcher's alignment
        contract (glob region % 2048, bucket regions % 256)."""
        return self.NB > 1

    @property
    def id_bits(self) -> int:
        """Byte-plane width for the coded match operands (0 = too many
        ids, callers must use the level-scan path)."""
        n = len(self.interner)
        if n <= MAX_IDS_16:
            return 16
        if n <= MAX_IDS_24:
            return 24
        return 0

    def _alloc_regions(self, total_hint: int,
                       need: Optional[List[int]] = None) -> None:
        """(Re)build the region layout sized for ``total_hint`` rows with
        per-region needs ``need`` (entry counts to re-home). Sets up empty
        arrays + free lists; the caller re-inserts entries."""
        big = total_hint >= 8192
        self.NB = _nb_for(total_hint)
        # level-1 sub-buckets for wildcard-first filters ("+"/w1/...):
        # the dense global phase shrinks to region 0 (both levels wild)
        # while g-buckets get window probes like ordinary buckets
        # NG >= 16 keeps the g-zone >= 4096 rows (window-geometry floor);
        # smaller bucketed tables keep wildcard-first filters dense
        self.NG = min(64, self.NB) if self.NB >= 16 else 0
        self._bucket_cache: Dict[int, int] = {}
        self._gbucket_cache: Dict[int, int] = {}
        align = REGION_ALIGN if big else 8
        nreg = 1 + self.NG + self.NB
        if need is None:
            need = [0] * nreg
        if len(need) != nreg:
            need = (need + [0] * nreg)[:nreg]
        # headroom: double each region's need, floor-split any spare hint
        spare = max(total_hint - 2 * sum(need), 0) // nreg
        caps = [max(2 * n + spare, align) for n in need]
        caps = [-(-c // align) * align for c in caps]
        if big:
            g = max(caps[0], GLOBAL_ALIGN)
            caps[0] = 1 << (g - 1).bit_length()  # pow2: bounds recompiles
            # the g-zone boundary (end of the g-buckets) is the sharded
            # dense-phase width — keep it GLOBAL_ALIGN-aligned
            gz = sum(caps[:1 + self.NG])
            caps[self.NG] += -gz % GLOBAL_ALIGN
            total = sum(caps)
            pad = -total % GLOBAL_ALIGN
            caps[-1] += pad
        elif sum(caps) >= 2048:
            caps[-1] += -sum(caps) % 2048
        self.reg_cap = np.asarray(caps, dtype=np.int64)
        self.reg_start = np.concatenate(
            [[0], np.cumsum(self.reg_cap)[:-1]]).astype(np.int64)
        used = int(self.reg_cap.sum())
        # reserve a spare tail (~1/8 of the used span, 2048-aligned) so an
        # overflowing region RELOCATES there (scatter-sized device update)
        # instead of forcing a full repartition + re-upload — the routing
        # stall killer for steady-state churn (VERDICT r2 weak-1)
        self.spare_start = used
        self.spare_cap = (-(-(used // 8) // GLOBAL_ALIGN) * GLOBAL_ALIGN
                          if big else 0)
        self.cap = used + self.spare_cap
        # slot→region map (regions may relocate, making reg_start
        # non-monotone — searchsorted would misattribute slots)
        self._region_of_slot = np.zeros(self.cap, dtype=np.uint16)
        for r in range(nreg):
            s0, c0 = int(self.reg_start[r]), int(self.reg_cap[r])
            self._region_of_slot[s0:s0 + c0] = r
        self.words = np.zeros((self.cap, self.L), dtype=np.int32)
        self.eff_len = np.zeros(self.cap, dtype=np.int32)
        self.has_hash = np.zeros(self.cap, dtype=bool)
        self.first_wild = np.zeros(self.cap, dtype=bool)
        self.active = np.zeros(self.cap, dtype=bool)
        self.entries = [None] * self.cap
        self._free = [
            list(range(int(s + c) - 1, int(s) - 1, -1))
            for s, c in zip(self.reg_start, self.reg_cap)
        ]
        self.resized = True
        self.dirty.clear()

    @property
    def gb_end(self) -> int:
        """End row of the g-zone (region 0 + level-1 g-buckets) — the
        dense-phase width for consumers that match the whole wildcard-first
        zone densely (the sharded matcher)."""
        i = self.NG
        return int(self.reg_start[i] + self.reg_cap[i])

    def _bucket_of_id(self, word0_id: int) -> int:
        b = self._bucket_cache.get(word0_id)
        if b is None:
            b = self.NG + _bucket_for(word0_id, self.NB)
            self._bucket_cache[word0_id] = b
        return b

    def _gbucket_of_id(self, word1_id: int) -> int:
        b = self._gbucket_cache.get(word1_id)
        if b is None:
            b = _bucket_for(word1_id, self.NG)
            self._gbucket_cache[word1_id] = b
        return b

    def _region_of_filter(self, fw: Tuple[str, ...]) -> int:
        if not fw or fw[0] in (PLUS, HASH):
            if (self.NG and len(fw) >= 2 and fw[0] == PLUS
                    and fw[1] not in (PLUS, HASH)):
                # "+"/w1/... pins level 1: level-1 g-bucket
                return self._gbucket_of_id(self.interner.intern(fw[1]))
            return 0
        if self.NB == 1:
            return 1
        return self._bucket_of_id(self.interner.intern(fw[0]))

    def pub_bucket(self, word0_id: int) -> int:
        """Bucket region a publish topic's level-0 word falls in (mirrors
        the subscription-side mapping, including UNKNOWN_ID)."""
        if self.NB == 1:
            return 1
        return self._bucket_of_id(word0_id)

    def pub_gbucket(self, word1_id: int) -> int:
        """Level-1 g-bucket a publish probes for wildcard-first filters
        ("+"/w1/...). Topics with <2 levels probe g-bucket 1 (harmless:
        nothing there can match them — g-bucket filters need >=2 levels)."""
        if not self.NG:
            return 0
        return self._gbucket_of_id(word1_id)

    def _rebuild(self) -> None:
        """Repartition all regions (doubling total), re-homing every entry.
        Slot numbers change wholesale; ``resized`` forces the full upload
        and consumers re-snapshot under the matcher lock."""
        old_entries = [e for e in self.entries if e is not None]
        # recompute per-region need under the NEW bucket count: NB depends
        # on total, so pick NB first from the doubled hint, then count
        total_hint = max(2 * max(self.count, 1), self.cap)
        nb = _nb_for(total_hint)
        ng = min(64, nb) if nb >= 16 else 0
        cache: Dict[int, int] = {}
        gcache: Dict[int, int] = {}
        need = [0] * (1 + ng + nb)
        for fw, _k, _v in old_entries:
            if not fw or fw[0] in (PLUS, HASH):
                if (ng and len(fw) >= 2 and fw[0] == PLUS
                        and fw[1] not in (PLUS, HASH)):
                    wid = self.interner.intern(fw[1])
                    g = gcache.get(wid)
                    if g is None:
                        g = _bucket_for(wid, ng)
                        gcache[wid] = g
                    need[g] += 1
                else:
                    need[0] += 1
            elif nb == 1:
                need[1] += 1
            else:
                wid = self.interner.intern(fw[0])
                b = cache.get(wid)
                if b is None:
                    b = ng + _bucket_for(wid, nb)
                    cache[wid] = b
                need[b] += 1
        self._alloc_regions(total_hint, need)
        assert self.NB == nb and self.NG == ng
        self._slot_of.clear()
        for fw, key, value in old_entries:
            self._insert(fw, key, value)

    # ------------------------------------------------------------- mutation

    def _relocate_region(self, region: int) -> bool:
        """Move an overflowing region into the spare tail at 2x capacity.
        O(region) host work + dirty-slot scatter on the device — no resize,
        no recompile (S unchanged). Returns False when the spare is spent
        (caller falls back to the full rebuild)."""
        if region <= self.NG:
            # g-zone regions must stay inside [g00, gb_end): the sharded
            # matcher covers that span densely and the two-probe kernel
            # window-bounds probe B to it — relocating one out would
            # silently hide its rows. Overflow there takes the rebuild.
            return False
        old_start = int(self.reg_start[region])
        old_cap = int(self.reg_cap[region])
        new_cap = -(-2 * old_cap // REGION_ALIGN) * REGION_ALIGN
        if new_cap > self.spare_cap:
            return False
        new_start = self.spare_start
        self.spare_start += new_cap
        self.spare_cap -= new_cap
        sl_old = slice(old_start, old_start + old_cap)
        sl_new = slice(new_start, new_start + old_cap)
        self.words[sl_new] = self.words[sl_old]
        self.eff_len[sl_new] = self.eff_len[sl_old]
        self.has_hash[sl_new] = self.has_hash[sl_old]
        self.first_wild[sl_new] = self.first_wild[sl_old]
        self.active[sl_new] = self.active[sl_old]
        self.active[sl_old] = False
        off = new_start - old_start
        for i in range(old_start, old_start + old_cap):
            e = self.entries[i]
            self.entries[i + off] = e
            self.entries[i] = None
            if e is not None:
                self._slot_of[(e[0], e[1])] = i + off
            self.dirty.add(i)
            self.dirty.add(i + off)
        self.reg_start[region] = new_start
        self.reg_cap[region] = new_cap
        self._region_of_slot[sl_old] = 0  # orphaned rows stay inactive
        self._region_of_slot[new_start:new_start + new_cap] = region
        # free list: relocated entries keep their offsets; the new upper
        # half plus any previously-free offsets become free
        old_free = {s - old_start for s in self._free[region]}
        self._free[region] = (
            [new_start + i for i in range(new_cap - 1, old_cap - 1, -1)]
            + [new_start + i for i in sorted(old_free, reverse=True)])
        return True

    def _insert(self, fw: Tuple[str, ...], key: Hashable, value: Any) -> None:
        region = self._region_of_filter(fw)
        if not self._free[region]:
            # region 0 (wildcard-first) must stay at the table head (the
            # kernel's global phase slices [:glob_pad]), so it cannot
            # relocate — only bucket regions can
            if region == 0 or not self._relocate_region(region):
                self._rebuild()
                region = self._region_of_filter(fw)  # NB may have changed
        slot = self._free[region].pop()
        hh = bool(fw) and fw[-1] == HASH
        concrete = fw[:-1] if hh else fw
        intern = self.interner.intern
        ids = [PLUS_ID if w == PLUS else intern(w) for w in concrete]
        # write in place: slicing beats building a temp row per insert
        # (np.full dominated the 1M-sub cold build profile)
        wrow = self.words[slot]
        wrow[:len(ids)] = ids
        wrow[len(ids):] = PAD_ID
        self.eff_len[slot] = len(concrete)
        self.has_hash[slot] = hh
        self.first_wild[slot] = bool(fw) and fw[0] in (PLUS, HASH)
        self.active[slot] = True
        self.entries[slot] = (fw, key, value)
        self._slot_of[(fw, key)] = slot
        self.dirty.add(slot)

    def add(self, filter_words: Sequence[str], key: Hashable, value: Any = None) -> None:
        fw = tuple(filter_words)
        if len(fw) > self.L:
            before = len(self.overflow)
            self.overflow.add(list(fw), key, value)
            self.count += len(self.overflow) - before  # re-subscribe: no drift
            return
        existing = self._slot_of.get((fw, key))
        if existing is not None:
            # re-subscribe with changed opts: device row is unchanged, but
            # consumers snapshotting entries by dirty slot must see the update
            self.entries[existing] = (fw, key, value)
            self.dirty.add(existing)
            return
        self._insert(fw, key, value)
        self.count += 1

    def remove(self, filter_words: Sequence[str], key: Hashable) -> bool:
        fw = tuple(filter_words)
        if len(fw) > self.L:
            ok = self.overflow.remove(list(fw), key)
            if ok:
                self.count -= 1
            return ok
        slot = self._slot_of.pop((fw, key), None)
        if slot is None:
            return False
        self.active[slot] = False
        self.entries[slot] = None
        region = int(self._region_of_slot[slot])
        self._free[region].append(slot)
        self.dirty.add(slot)
        self.count -= 1
        return True

    # ---------------------------------------------------------- publish side

    def encode_topic(self, topic: Sequence[str]) -> Tuple[np.ndarray, int, bool]:
        """Publish topic → (row [L], length, is_dollar). Topics longer than L
        are matched host-side only (overflow path)."""
        row = np.full(self.L, UNKNOWN_ID, dtype=np.int32)
        n = min(len(topic), self.L)
        for i in range(n):
            row[i] = self.interner.lookup(topic[i])
        return row, len(topic), bool(topic) and topic[0].startswith("$")

    def encode_topic_ex(self, topic: Sequence[str]):
        """encode_topic + the two probe regions: the level-0 bucket and
        the level-1 g-bucket (wildcard-first filters with a concrete
        level-1 word live there; the residual both-levels-wild region 0
        is matched densely for every pub)."""
        row, n, dollar = self.encode_topic(topic)
        w0 = int(row[0]) if n else UNKNOWN_ID
        w1 = int(row[1]) if n >= 2 else UNKNOWN_ID
        return (row, n, dollar, self.pub_bucket(w0), self.pub_gbucket(w1))

    def stats(self) -> Dict[str, int]:
        """Row count, capacity and host bytes (the registry's gauges)."""
        return {
            "subscriptions": self.count,
            "capacity": self.cap,
            "interned_words": len(self.interner),
            "overflow": len(self.overflow),
            "table_bytes": int(
                self.words.nbytes + self.eff_len.nbytes + self.has_hash.nbytes
                + self.first_wild.nbytes + self.active.nbytes
            ),
        }
