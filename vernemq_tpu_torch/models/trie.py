"""Host-side subscription trie: the exact oracle of the GPU match engine and
the subscription table's store for filters longer than ``L`` levels.

The match walk tries, at every level, the exact word edge, the ``+`` edge
and a terminal ``#`` edge (``vmq_reg_trie.erl:358-383``), skips root-level
wildcards for ``$``-prefixed topics (``vmq_reg_trie.erl:283-288``), and lets
a trailing ``#`` match its parent level.
"""

from __future__ import annotations

from typing import Any, Dict, Hashable, Iterator, List, Sequence, Tuple

from ..protocol.topic import HASH, PLUS

Row = Tuple[Tuple[str, ...], Hashable, Any]


class _Node:
    __slots__ = ("children", "subs")

    def __init__(self) -> None:
        self.children: Dict[str, _Node] = {}
        self.subs: Dict[Hashable, Any] = {}


class SubscriptionTrie:
    """Mutable topic trie mapping subscription filters to entry dicts."""

    def __init__(self) -> None:
        self._root = _Node()
        self._count = 0

    def __len__(self) -> int:
        return self._count

    def add(self, filter_words: Sequence[str], key: Hashable,
            value: Any = None) -> None:
        node = self._root
        for w in filter_words:
            nxt = node.children.get(w)
            if nxt is None:
                nxt = _Node()
                node.children[w] = nxt
            node = nxt
        if key not in node.subs:
            self._count += 1
        node.subs[key] = value

    def remove(self, filter_words: Sequence[str], key: Hashable) -> bool:
        """Remove an entry, pruning branches left empty."""
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
        for parent, w in reversed(path):
            child = parent.children[w]
            if child.subs or child.children:
                break
            del parent.children[w]
        return True

    def match(self, topic_words: Sequence[str]) -> List[Row]:
        """All ``(filter, key, value)`` rows whose filter matches the topic."""
        out: List[Row] = []
        skip_root_wild = bool(topic_words) and topic_words[0].startswith("$")
        self._walk(self._root, topic_words, 0, (), skip_root_wild, out)
        return out

    def _walk(self, node: _Node, words: Sequence[str], i: int,
              path: Tuple[str, ...], skip_wild: bool, out: List[Row]) -> None:
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
        if not (skip_wild and i == 0):
            plus = node.children.get(PLUS)
            if plus is not None:
                self._walk(plus, words, i + 1, path + (PLUS,), False, out)
            hash_child = node.children.get(HASH)
            if hash_child is not None:
                hp = path + (HASH,)
                for k, v in hash_child.subs.items():
                    out.append((hp, k, v))

    def entries(self) -> Iterator[Row]:
        """Every ``(filter, key, value)`` row (warm-loading the table)."""
        stack: List[Tuple[_Node, Tuple[str, ...]]] = [(self._root, ())]
        while stack:
            node, path = stack.pop()
            for k, v in node.subs.items():
                yield (path, k, v)
            for w, child in node.children.items():
                stack.append((child, path + (w,)))
