"""Subscriber DB: subscription records in the replicated metadata store.

Mirrors ``vmq_subscriber_db.erl``: store/read/fold/delete over the
metadata facade under a dedicated prefix (``vmq_subscriber_db.erl:26-54``)
plus change-event subscription (``:56-71``). The record keeps the
reference's subscriber format — node + clean_session + per-filter
subinfo (``vmq_subscriber.erl:35-48``) — so queue migration can remap the
node field the same way (``change_node``, ``vmq_subscriber.erl:97-128``).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, Optional, Tuple

from ..protocol.types import SubOpts
from .message import SubscriberId

PREFIX = "subscriber"

Filter = Tuple[str, ...]


def opts_to_dict(opts: SubOpts) -> Dict[str, Any]:
    d = {
        "qos": opts.qos,
        "nl": opts.no_local,
        "rap": opts.rap,
        "rh": opts.retain_handling,
    }
    sub_id = getattr(opts, "subscription_id", None)
    if sub_id:
        d["sid"] = sub_id
    # MQTT+ payload-filter suffix (vernemq_tpu/filters/): carried
    # UNCONDITIONALLY — a node with payload filters disabled must
    # round-trip a replicated filtered subscription verbatim (re-storing
    # the record must never truncate it into a plain topic sub; the
    # "flt" cluster capability advertises which peers evaluate it)
    flt = getattr(opts, "filter_expr", None)
    if flt:
        d["flt"] = flt
    return d


def opts_from_dict(d: Dict[str, Any]) -> SubOpts:
    opts = SubOpts(qos=d.get("qos", 0), no_local=d.get("nl", False),
                   rap=d.get("rap", False), retain_handling=d.get("rh", 0))
    if "sid" in d:
        opts.subscription_id = d["sid"]
    if "flt" in d:
        opts.filter_expr = d["flt"]
    return opts


class SubscriberRecord:
    """One subscriber's replicated state: which node owns its queue, its
    clean-session flag, and its subscriptions."""

    __slots__ = ("node", "clean_session", "subs", "queue_opts")

    def __init__(self, node: str, clean_session: bool,
                 subs: Optional[Dict[Filter, SubOpts]] = None,
                 queue_opts: Optional[Dict[str, Any]] = None):
        self.node = node
        self.clean_session = clean_session
        self.subs: Dict[Filter, SubOpts] = subs or {}
        # durable queue parameters (session_expiry etc.) so offline queues
        # re-created at boot keep their semantics (vmq_reg_mgr boot path)
        self.queue_opts: Dict[str, Any] = queue_opts or {}

    def to_term(self) -> Dict[str, Any]:
        return {
            "node": self.node,
            "clean": self.clean_session,
            "subs": {f: opts_to_dict(o) for f, o in self.subs.items()},
            "qopts": self.queue_opts,
        }

    @classmethod
    def from_term(cls, t: Optional[Dict[str, Any]]) -> Optional["SubscriberRecord"]:
        if t is None:
            return None
        return cls(
            t["node"], t["clean"],
            {tuple(f): opts_from_dict(o) for f, o in t["subs"].items()},
            dict(t.get("qopts") or {}),
        )


class SubscriberDB:
    def __init__(self, metadata, node_name: str):
        self.metadata = metadata
        self.node_name = node_name

    def store(self, sid: SubscriberId, record: SubscriberRecord) -> None:
        self.metadata.put(PREFIX, tuple(sid), record.to_term())

    def store_many(
            self, pairs: Iterable[Tuple[SubscriberId,
                                        SubscriberRecord]]) -> int:
        """Store a batch of records as ONE logical write — the batched
        handoff's shared fence. The metadata facade has no multi-key
        primitive across its backends (LWW put vs SWC dotted puts), so
        physically this loops ``put``; the batching contract lives one
        level up: the caller bumps the fence counter and journals the
        fence event ONCE per batch, not per record. Returns the number
        of records stored."""
        n = 0
        for sid, record in pairs:
            self.metadata.put(PREFIX, tuple(sid), record.to_term())
            n += 1
        return n

    def read(self, sid: SubscriberId) -> Optional[SubscriberRecord]:
        return SubscriberRecord.from_term(
            self.metadata.get(PREFIX, tuple(sid)))

    def delete(self, sid: SubscriberId) -> None:
        self.metadata.delete(PREFIX, tuple(sid))

    def fold(self) -> Iterable[Tuple[SubscriberId, SubscriberRecord]]:
        for key, term in self.metadata.fold(PREFIX):
            yield (key[0], key[1]), SubscriberRecord.from_term(term)

    def fold_raw(self) -> Iterable[Tuple[SubscriberId, Dict[str, Any]]]:
        """Stream the raw stored terms WITHOUT materialising
        SubscriberRecord/SubOpts objects: the boot warm-load walks
        every stored subscriber and builds its routing rows straight
        from the terms (interning shared opts shapes), so a huge
        restart doesn't allocate a record object graph per parked
        session just to throw it away."""
        for key, term in self.metadata.fold(PREFIX):
            yield (key[0], key[1]), term

    def subscribe_db_events(
        self, fn: Callable[[SubscriberId, Optional[SubscriberRecord],
                            Optional[SubscriberRecord], str], None]) -> None:
        """fn(sid, old_record, new_record, origin) on every change — local
        writes fire synchronously (read-your-writes for the local trie,
        matching the reference's synchronous trie events); replicated
        writes carry the originating node so consumers can tell a remote
        remap (→ create the offline queue here, vmq_reg_mgr.erl:155-243)
        from their own."""

        def _on_change(key, old, new, origin):
            fn((key[0], key[1]),
               SubscriberRecord.from_term(old),
               SubscriberRecord.from_term(new), origin)

        self.metadata.subscribe(PREFIX, _on_change)
