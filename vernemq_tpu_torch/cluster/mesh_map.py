"""Mesh slice map: which broker node owns which matcher slice.

The mesh-native matcher (``parallel/mesh_match.py``) splits the
subscription table into contiguous row slices over the mesh's 'sub'
axis; in a multi-node deployment each broker node serves the slices it
owns (its processes hold those shards' HBM). This module is the
metadata-plane half: slice ownership lives in the replicated
:class:`~vernemq_tpu_torch.cluster.metadata.MetadataStore` under the
``mesh_slices`` prefix, so it gossips exactly like the netsplit CAPs and
peer capability flags do — every write broadcasts, reconnects reconcile
through anti-entropy, and LWW resolves concurrent claims.

Assignment is deterministic round-robin over the SORTED member list
(slice ``i`` belongs to ``members[i % len(members)]``), so every node
computes the same target map from the same membership and only ever
writes claims for itself — concurrent claims for the same slice can only
happen across a membership change, and LWW plus the next
:meth:`claim_local` pass converge them. When a node GAINS a slice, the
change event fires ``on_adopt(slice_ids, epoch)`` — the registry's mesh
seat replays the owned rows into its device table exactly once per
epoch (``MeshGpuMatcher.adopt_slices``).
"""

from __future__ import annotations

import logging
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from ..observability import events

log = logging.getLogger("vernemq_tpu_torch.mesh")

PREFIX = "mesh_slices"


def parse_mesh_spec(spec: str) -> Optional[Tuple[int, int]]:
    """THE parser for the ``tpu_mesh`` knob ("BxS" or "S") —
    deliberately jax-free (the broker builds the slice map before, and
    regardless of whether, a backend initialises) and shared with the
    registry's mesh construction so the slice map and the serving mesh
    can never disagree on the slice count. Returns (batch, sub) or
    None on an empty/malformed spec."""
    spec = str(spec or "").strip().lower()
    if not spec:
        return None
    try:
        if "x" in spec:
            b_s = spec.split("x")
            return int(b_s[0]), int(b_s[1])
        return 1, int(spec)
    except (ValueError, IndexError):
        return None


class MeshSliceMap:
    def __init__(self, metadata, node_name: str, n_slices: int,
                 on_adopt: Optional[Callable[[List[int], int], None]] = None,
                 metrics: Optional[Any] = None):
        self.metadata = metadata
        self.node_name = node_name
        self.n_slices = int(n_slices)
        #: fired with (newly_owned_slice_ids, token) after a claim pass
        #: or a gossiped change hands this node new slices; the token
        #: is the adopt-replay exactly-once key (claimer node + epoch)
        self.on_adopt = on_adopt
        self.metrics = metrics
        # wall-clock-seeded so a node's epochs stay monotonic ACROSS
        # boots: the adopt-replay guard keys on (claimer, epoch), and a
        # boot-reset counter could repeat an old epoch and silently
        # suppress a replay the re-adopted slice needs
        self._epoch = int(time.time())
        self.adoptions = 0
        # live-handoff state (cluster/handoff.py): frozen slices are
        # mid-move — the handoff FSM owns their records, so claim
        # passes must not race it. A fence entry (slice -> epoch)
        # makes this OLD owner reject any write for the slice at or
        # below the fenced epoch: a stale claim gossiped after the
        # transfer cannot re-adopt the slice here.
        self._frozen: set = set()
        self._fenced: Dict[int, int] = {}
        self.fenced_rejects = 0
        metadata.subscribe(PREFIX, self._on_change)

    # -------------------------------------------------------------- handoff

    def freeze(self, slice_id: int) -> None:
        """Pin one slice for a live handoff: claim passes skip it until
        :meth:`unfreeze` (the FSM owns its record mid-move)."""
        self._frozen.add(int(slice_id))

    def unfreeze(self, slice_id: int) -> None:
        self._frozen.discard(int(slice_id))

    def transfer_local(self, slice_id: int, to_node: str) -> int:
        """The handoff FENCE: write the epoch-bumped ownership record
        handing ``slice_id`` to ``to_node`` and arm the local fence at
        that epoch. The gossiped change IS the successor's adopt
        trigger (:meth:`_on_change` fires its ``on_adopt`` with the
        ``(origin, epoch)`` exactly-once token). ``pinned`` marks an
        explicit transfer: claim passes honour it while the new owner
        lives instead of round-robin-reclaiming the slice. Returns the
        fencing epoch."""
        s = int(slice_id)
        cur = self.metadata.get(PREFIX, s)
        if cur is None or cur.get("node") != self.node_name:
            raise RuntimeError(
                f"cannot transfer slice {s}: owned by "
                f"{cur.get('node') if cur else None!r}, not this node")
        self._epoch += 1
        self._fenced[s] = self._epoch
        self.metadata.put(PREFIX, s, {
            "node": to_node, "epoch": self._epoch, "pinned": True})
        return self._epoch

    # ---------------------------------------------------------------- claims

    def claim_local(self, members: Optional[Sequence[str]] = None) -> List[int]:
        """Write this node's claims for the slices the deterministic
        round-robin assigns it (single node: all slices). Returns the
        slices NEWLY owned by this pass; fires ``on_adopt`` for them."""
        members = sorted(members) if members else [self.node_name]
        if self.node_name not in members:
            members = sorted(set(members) | {self.node_name})
        newly: List[int] = []
        for s in range(self.n_slices):
            target = members[s % len(members)]
            if target != self.node_name:
                continue
            if s in self._frozen:
                # mid-handoff: the FSM owns this record until adopt
                # or rollback — a concurrent claim would race the fence
                continue
            cur = self.metadata.get(PREFIX, s)
            if cur is not None and cur.get("node") == self.node_name:
                continue
            if (cur is not None and cur.get("pinned")
                    and cur.get("node") in members):
                # an explicit handoff/rebalance placed this slice and
                # its owner still lives: honour the operator's move —
                # the slice is reclaimed round-robin only once the
                # pinned owner leaves the membership
                continue
            self._epoch += 1
            self.metadata.put(PREFIX, s, {
                "node": self.node_name, "epoch": self._epoch})
            newly.append(s)
        if newly:
            self.adoptions += 1
            log.info("claimed mesh slices %s (of %d) for %s", newly,
                     self.n_slices, self.node_name)
            events.emit("mesh_slice_claim",
                        detail=",".join(map(str, newly)),
                        value=float(len(newly)))
            if self.on_adopt is not None:
                self.on_adopt(newly, (self.node_name, self._epoch))
        return newly

    def release_local(self) -> List[int]:
        """Retract every slice this node currently claims (tombstones
        gossip like any other write). The registry calls this when the
        tpu view comes up WITHOUT its mesh (tpu_mesh unsatisfiable —
        the loud single-chip degrade): a node must not keep advertising
        slices it cannot serve."""
        released = []
        for s in range(self.n_slices):
            rec = self.metadata.get(PREFIX, s)
            if rec and rec.get("node") == self.node_name:
                self.metadata.delete(PREFIX, s)
                released.append(s)
        if released:
            log.warning("released mesh slices %s: this node cannot "
                        "serve them", released)
            events.emit("mesh_slice_release",
                        detail=",".join(map(str, released)),
                        value=float(len(released)))
        return released

    def _on_change(self, key: Any, old: Any, new: Any, origin: str) -> None:
        """Gossiped slice-map change: a slice that flipped TO this node
        from a remote claim (e.g. an admin rebalance) replays through
        the same adopt hook; everything else is bookkeeping only."""
        if origin == self.node_name or new is None:
            return
        if new.get("node") == self.node_name:
            fe = self._fenced.get(int(key))
            if fe is not None:
                if new.get("pinned") and int(new.get("epoch", 0)) > fe:
                    # an explicit transfer BACK to this node at a newer
                    # epoch lifts the fence — the adopt below proceeds
                    self._fenced.pop(int(key), None)
                else:
                    # late write at or below the fenced epoch: a stale
                    # claim gossiped after this node handed the slice
                    # away. Reject — we no longer serve it.
                    self.fenced_rejects += 1
                    if self.metrics is not None:
                        self.metrics.incr("handoff_fenced_writes")
                    log.warning(
                        "fenced stale claim for slice %s from %s "
                        "(epoch %s <= fence %s): rejected", key,
                        origin, new.get("epoch", 0), fe)
                    return
        if (new.get("node") == self.node_name
                and (old is None or old.get("node") != self.node_name)
                and self.on_adopt is not None):
            self.adoptions += 1
            events.emit("mesh_slice_adopt", detail=f"{key}<-{origin}")
            # token = (writer, its epoch): epochs are per-node
            # counters, so the claimer must ride in the exactly-once
            # key or two nodes' colliding counters suppress a replay
            self.on_adopt([int(key)], (origin, int(new.get("epoch", 0))))

    # ---------------------------------------------------------------- views

    def owner(self, slice_id: int) -> Optional[str]:
        rec = self.metadata.get(PREFIX, slice_id)
        return rec.get("node") if rec else None

    def local_slices(self) -> List[int]:
        return [s for s in range(self.n_slices)
                if self.owner(s) == self.node_name]

    def snapshot(self) -> List[Dict[str, Any]]:
        out = []
        for s in range(self.n_slices):
            rec = self.metadata.get(PREFIX, s) or {}
            out.append({"slice": s, "node": rec.get("node"),
                        "epoch": rec.get("epoch", 0)})
        return out

    def counts_by_node(self) -> Dict[str, int]:
        counts: Dict[str, int] = {}
        for row in self.snapshot():
            n = row["node"]
            if n is not None:
                counts[n] = counts.get(n, 0) + 1
        return counts
