"""Host-side subscription trie — the broker's CPU matcher and the parity
oracle for the TPU match engine.

Functional equivalent of the reference's in-RAM subscription index
(``apps/vmq_server/src/vmq_reg_trie.erl``): a per-node topic trie whose match
walk tries, at every level, the exact word edge, the ``+`` edge, and a
terminal ``#`` edge (``vmq_reg_trie.erl:358-383``), excludes root-level
wildcards for ``$``-prefixed topic names (MQTT-4.7.2-1,
``vmq_reg_trie.erl:283-288``), and lets a trailing ``#`` match its parent
level. The reference's ETS edge/node tables become Python dict nodes; its
fanout-table auto-promotion (``vmq_reg_trie.erl:448-496``) is unnecessary
here because entries per filter already live in one dict.

Entries are opaque ``(key, value)`` pairs stored per topic *filter* — the
registry layer stores local subscribers, shared-group members, and
remote-node pointers through the same structure, mirroring how
``vmq_trie_subs`` vs ``vmq_trie_remote_subs`` share one walk.
"""

from __future__ import annotations

from typing import Any, Dict, Hashable, Iterator, List, Optional, Sequence, Tuple

from ..protocol.topic import HASH, PLUS


class _Node:
    __slots__ = ("children", "subs")

    def __init__(self) -> None:
        self.children: Dict[str, _Node] = {}
        self.subs: Dict[Hashable, Any] = {}  # entries terminating at this node


class SubscriptionTrie:
    """Mutable topic trie mapping subscription filters to entry dicts."""

    def __init__(self) -> None:
        self._root = _Node()
        self._count = 0  # number of (filter, key) entries
        # trie nodes, the root included, kept as nodes are made and pruned
        # so stats() need not walk the trie (a metrics scrape runs on the
        # event loop)
        self._nodes = 1

    def __len__(self) -> int:
        return self._count

    def add(self, filter_words: Sequence[str], key: Hashable, value: Any = None) -> None:
        """Insert/update an entry under a (validated) subscription filter."""
        node = self._root
        for w in filter_words:
            nxt = node.children.get(w)
            if nxt is None:
                nxt = _Node()
                node.children[w] = nxt
                self._nodes += 1
            node = nxt
        if key not in node.subs:
            self._count += 1
        node.subs[key] = value

    def remove(self, filter_words: Sequence[str], key: Hashable) -> bool:
        """Remove an entry; prunes now-empty trie branches (the reference
        deletes edge rows bottom-up, vmq_reg_trie.erl trie_delete_path)."""
        path: List[Tuple[_Node, str]] = []
        node = self._root
        for w in filter_words:
            nxt = node.children.get(w)
            if nxt is None:
                return False
            path.append((node, w))
            node = nxt
        if key not in node.subs:
            return False
        del node.subs[key]
        self._count -= 1
        # prune empty leaves bottom-up
        for parent, w in reversed(path):
            child = parent.children[w]
            if child.subs or child.children:
                break
            del parent.children[w]
            self._nodes -= 1
        return True

    def match(self, topic_words: Sequence[str]) -> List[Tuple[Tuple[str, ...], Hashable, Any]]:
        """All entries whose filter matches the topic name.

        Returns ``[(filter, key, value)]`` — one row per matching
        subscription, like ``vmq_reg_trie:fold/4`` invoking the fold fun per
        matched topic row.
        """
        out: List[Tuple[Tuple[str, ...], Hashable, Any]] = []
        skip_root_wild = bool(topic_words) and topic_words[0].startswith("$")
        self._walk(self._root, topic_words, 0, (), skip_root_wild, out)
        return out

    def _walk(
        self,
        node: _Node,
        words: Sequence[str],
        i: int,
        path: Tuple[str, ...],
        skip_wild: bool,
        out: List[Tuple[Tuple[str, ...], Hashable, Any]],
    ) -> None:
        if i == len(words):
            for k, v in node.subs.items():
                out.append((path, k, v))
            # trailing '#' also matches the parent level ("a/#" matches "a")
            hash_child = node.children.get(HASH)
            if hash_child is not None and not (skip_wild and i == 0):
                hp = path + (HASH,)
                for k, v in hash_child.subs.items():
                    out.append((hp, k, v))
            return
        w = words[i]
        exact = node.children.get(w)
        if exact is not None:
            self._walk(exact, words, i + 1, path + (w,), skip_wild, out)
        wild_ok = not (skip_wild and i == 0)
        if wild_ok:
            plus = node.children.get(PLUS)
            if plus is not None:
                self._walk(plus, words, i + 1, path + (PLUS,), False, out)
            hash_child = node.children.get(HASH)
            if hash_child is not None:
                hp = path + (HASH,)
                for k, v in hash_child.subs.items():
                    out.append((hp, k, v))

    def entries(self) -> Iterator[Tuple[Tuple[str, ...], Hashable, Any]]:
        """Iterate every (filter, key, value) — used for warm-loading the TPU
        table, mirroring the trie warm-load fold (vmq_reg_trie.erl:144-151)."""
        stack: List[Tuple[_Node, Tuple[str, ...]]] = [(self._root, ())]
        while stack:
            node, path = stack.pop()
            for k, v in node.subs.items():
                yield (path, k, v)
            for w, child in node.children.items():
                stack.append((child, path + (w,)))

    def stats(self) -> Dict[str, int]:
        """Subscription count + rough memory, feeding the
        ``router_subscriptions`` / ``router_memory`` gauges
        (vmq_reg_trie.erl:101-112). The node count is kept by ``add`` and
        ``remove``, not walked."""
        import sys

        nodes = self._nodes
        return {
            "subscriptions": self._count,
            "nodes": nodes,
            "memory": nodes * (sys.getsizeof({}) * 2 + 64),
        }
