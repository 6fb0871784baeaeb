"""Retained-message store.

Mirrors ``vmq_retain_srv.erl``: a write-through cache of retained messages
keyed by (mountpoint, topic), with wildcard lookup on subscribe. The
reference does a full-table ETS scan for wildcard filters
(``vmq_retain_srv.erl:75-97`` — its own "TODO optimize"); we instead keep
retained topics in a trie and walk it with the filter (exact descent on
words, children fan-out on ``+``, subtree collect on ``#``) — O(matches)
instead of O(table). Persistence to the metadata store is write-behind via
``dirty`` tracking (vmq_retain_srv.erl:186-191,223-237).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple

from ..protocol.topic import HASH, PLUS


class _RNode:
    __slots__ = ("children", "value")

    def __init__(self) -> None:
        self.children: Dict[str, _RNode] = {}
        self.value: Any = None  # retained payload record, None = no retained msg here


class RetainStore:
    def __init__(self, on_dirty: Optional[Callable[[str, Tuple[str, ...], Any], None]] = None):
        self._roots: Dict[str, _RNode] = {}  # per-mountpoint retain trees
        self._count = 0
        self._bytes = 0  # approximate payload+topic bytes (retain_memory)
        # write-behind hook: called with (mountpoint, topic, value|None) on
        # every mutation so the metadata store persists + replicates deltas
        # (vmq_retain_srv dirty table + metadata events,
        # vmq_retain_srv.erl:180-191)
        self._on_dirty = on_dirty

    def __len__(self) -> int:
        return self._count

    def memory(self) -> int:
        """Approximate bytes held by retained messages (the reference's
        ``retain_memory`` gauge — there ETS words, here payload + topic
        bytes + a fixed per-entry overhead)."""
        return self._bytes

    @staticmethod
    def _vsize(topic: Sequence[str], value: Any) -> int:
        payload = getattr(value, "payload", value)
        try:
            p = len(payload)
        except TypeError:
            p = 64
        return 64 + sum(len(w) + 8 for w in topic) + p

    def insert(self, mountpoint: str, topic: Sequence[str], value: Any) -> None:
        """Store/replace the retained message for a topic
        (vmq_retain_srv:insert/3)."""
        self._insert(mountpoint, topic, value)
        if self._on_dirty:
            self._on_dirty(mountpoint, tuple(topic), value)

    def _insert(self, mountpoint: str, topic: Sequence[str], value: Any) -> None:
        node = self._roots.setdefault(mountpoint, _RNode())
        for w in topic:
            node = node.children.setdefault(w, _RNode())
        if node.value is None:
            self._count += 1
        else:
            self._bytes -= self._vsize(topic, node.value)
        node.value = value
        self._bytes += self._vsize(topic, value)

    def delete(self, mountpoint: str, topic: Sequence[str]) -> bool:
        """Remove retained message (empty retained payload deletes,
        vmq_reg.erl:274-283)."""
        ok = self._delete(mountpoint, topic)
        if ok and self._on_dirty:
            self._on_dirty(mountpoint, tuple(topic), None)
        return ok

    def apply_remote(self, mountpoint: str, topic: Sequence[str], value: Any) -> None:
        """Apply a replicated change without re-firing the dirty hook (the
        metadata-event consumer path, vmq_retain_srv.erl:180-185)."""
        if value is None:
            self._delete(mountpoint, topic)
        else:
            self._insert(mountpoint, topic, value)

    def _delete(self, mountpoint: str, topic: Sequence[str]) -> bool:
        root = self._roots.get(mountpoint)
        if root is None:
            return False
        path: List[Tuple[_RNode, str]] = []
        node = root
        for w in topic:
            nxt = node.children.get(w)
            if nxt is None:
                return False
            path.append((node, w))
            node = nxt
        if node.value is None:
            return False
        self._bytes -= self._vsize(topic, node.value)
        node.value = None
        self._count -= 1
        for parent, w in reversed(path):
            child = parent.children[w]
            if child.value is not None or child.children:
                break
            del parent.children[w]
        return True

    def read(self, mountpoint: str, topic: Sequence[str]) -> Any:
        node = self._roots.get(mountpoint)
        if node is None:
            return None
        for w in topic:
            node = node.children.get(w)
            if node is None:
                return None
        return node.value

    def match_filter(
        self, mountpoint: str, filter_words: Sequence[str]
    ) -> List[Tuple[Tuple[str, ...], Any]]:
        """All retained (topic, value) whose topic matches the subscription
        filter — the retained-replay lookup on SUBSCRIBE
        (vmq_retain_srv:match_fold, vmq_reg.erl:380-418). Applies the
        MQTT-4.7.2-1 rule: root-level wildcards skip ``$``-topics."""
        root = self._roots.get(mountpoint)
        if root is None:
            return []
        out: List[Tuple[Tuple[str, ...], Any]] = []
        self._walk(root, list(filter_words), 0, (), out)
        return out

    def _collect_subtree(self, node: _RNode, path: Tuple[str, ...], out: list) -> None:
        if node.value is not None:
            out.append((path, node.value))
        for w, child in node.children.items():
            self._collect_subtree(child, path + (w,), out)

    def _walk(
        self,
        node: _RNode,
        fw: List[str],
        i: int,
        path: Tuple[str, ...],
        out: List[Tuple[Tuple[str, ...], Any]],
    ) -> None:
        if i == len(fw):
            if node.value is not None:
                out.append((path, node.value))
            return
        w = fw[i]
        if w == HASH:
            # '#' matches parent level too
            for cw, child in node.children.items():
                if i == 0 and cw.startswith("$"):
                    continue
                self._collect_subtree(child, path + (cw,), out)
            if node.value is not None:
                out.append((path, node.value))
        elif w == PLUS:
            for cw, child in node.children.items():
                if i == 0 and cw.startswith("$"):
                    continue
                self._walk(child, fw, i + 1, path + (cw,), out)
        else:
            child = node.children.get(w)
            if child is not None:
                self._walk(child, fw, i + 1, path + (w,), out)

    def items(self, mountpoint: Optional[str] = "") -> Iterator:
        """Iterate retained rows. With a named ``mountpoint`` (default
        ``""``) yields ``(topic, value)`` pairs, back-compat. With
        ``mountpoint=None`` iterates EVERY mountpoint, yielding
        ``(mountpoint, topic, value)`` triples — the all-mountpoints
        walk the admin/QL surface and the device-index warm load need."""
        if mountpoint is None:
            out_all: List[Tuple[str, Tuple[str, ...], Any]] = []
            for mp, root in self._roots.items():
                rows: List[Tuple[Tuple[str, ...], Any]] = []
                self._collect_subtree(root, (), rows)
                out_all.extend((mp, t, v) for t, v in rows)
            return iter(out_all)
        root = self._roots.get(mountpoint)
        if root is None:
            return iter(())
        out: List[Tuple[Tuple[str, ...], Any]] = []
        self._collect_subtree(root, (), out)
        return iter(out)
