"""Carry a subscription table across from the JAX engine to the port.

The match engine has no weights; its state is the subscription table. This
turns the JAX side's table state — plain numpy arrays, the word interner and
the slot→entry list — into the port's :class:`SubscriptionTable` (same rows,
same slots, same regions, so the port matches exactly what the reference
matched) and the device tensors the port's kernels read. Only attributes
are read from the inputs; nothing of the JAX package is imported.
"""

from __future__ import annotations

from typing import Any, Mapping, Sequence, Tuple

import numpy as np
import torch

from .device import DeviceLike, resolve_device
from .models.table import WordInterner, SubscriptionTable
from .models.trie import SubscriptionTrie
from .ops.match_kernel import build_operands


def table_state_from_reference(
    arrays: Mapping[str, np.ndarray], interner: Any, entries: Sequence,
    *, device: DeviceLike = None,
) -> Tuple[SubscriptionTable, Tuple[torch.Tensor, ...]]:
    """Build the port's table and device state from the reference's.

    ``arrays`` holds ``words`` [S, L], ``eff_len``, ``has_hash``,
    ``first_wild``, ``active`` [S], ``reg_start`` and ``reg_end`` [regions]
    and ``ng`` (the g-bucket count) — the keys of the reference matcher's
    host snapshot. ``interner`` has the reference interner's ``_ids``
    (word → id) and ``_next``; ``entries`` is the slot → ``(filter, key,
    value)`` list (``None`` for free slots).

    Returns ``(table, (F_t, t1, eff, has_hash, first_wild, active))`` with
    the tensors on ``device`` (default ``cuda``).
    """
    dev = resolve_device(device)
    words = np.array(arrays["words"], dtype=np.int32)
    S, L = words.shape
    if len(entries) != S:
        raise ValueError(f"{len(entries)} entries for a {S}-row table")
    reg_start = np.asarray(arrays["reg_start"], dtype=np.int64).copy()
    reg_cap = np.asarray(arrays["reg_end"], dtype=np.int64) - reg_start
    ng = int(arrays["ng"])

    t = SubscriptionTable.__new__(SubscriptionTable)
    t.L = L
    t.interner = WordInterner()
    t.interner._ids = dict(interner._ids)
    t.interner._next = int(interner._next)
    t.words = words
    t.eff_len = np.array(arrays["eff_len"], dtype=np.int32)
    t.has_hash = np.array(arrays["has_hash"], dtype=bool)
    t.first_wild = np.array(arrays["first_wild"], dtype=bool)
    t.active = np.array(arrays["active"], dtype=bool)
    t.entries = list(entries)
    t.NG = ng
    t.NB = len(reg_start) - 1 - ng
    t.reg_start = reg_start
    t.reg_cap = reg_cap
    t.cap = S
    # regions relocate into the spare tail in order, so the spare starts
    # where the furthest region ends
    t.spare_start = int((reg_start + reg_cap).max())
    t.spare_cap = S - t.spare_start
    t._bucket_cache = {}
    t._gbucket_cache = {}
    t._region_of_slot = np.zeros(S, dtype=np.uint16)
    t._free = []
    for r in range(len(reg_start)):
        s0, c0 = int(reg_start[r]), int(reg_cap[r])
        t._region_of_slot[s0:s0 + c0] = r
        t._free.append([s for s in range(s0 + c0 - 1, s0 - 1, -1)
                        if t.entries[s] is None])
    t._slot_of = {(e[0], e[1]): s for s, e in enumerate(t.entries)
                  if e is not None}
    t.count = len(t._slot_of)
    t.overflow = SubscriptionTrie()
    t.dirty = set()
    t.resized = True

    if not t.id_bits:
        raise ValueError("more interned words than 24-bit operands can code")
    put = lambda a: torch.from_numpy(a).to(dev, copy=True)
    F_t, t1 = build_operands(put(t.words), put(t.eff_len), t.id_bits)
    return t, (F_t, t1, put(t.eff_len), put(t.has_hash), put(t.first_wild),
               put(t.active))
