"""MQTT topic algebra: validation, wildcard matching, trie path triples.

Semantics mirror the reference broker's topic library
(``apps/vmq_commons/src/vmq_topic.erl``):

- topics are word lists split on ``/`` with empty words preserved
  (``vmq_topic.erl:96-133``: a leading ``/`` creates a distinct empty first
  word, trailing ``/`` a trailing empty word);
- publish topics reject any word containing ``+``/``#``
  (``vmq_topic.erl:97-112``);
- subscribe topics allow ``+`` only as a whole word and ``#`` only as the
  final whole word (``vmq_topic.erl:114-129``);
- ``$share/<group>/<topic...>`` shared subscriptions require a group *and* at
  least one topic word (``vmq_topic.erl:131-133``);
- ``match/2`` walks both word lists, ``+`` eats one level, a trailing ``#``
  eats the (possibly empty) remainder (``vmq_topic.erl:53-66``);
- ``triples/1`` produces (parent-path, word, path) edges for trie
  construction (``vmq_topic.erl:71-77``).

The MQTT-4.7.2-1 rule (wildcards must not match ``$``-prefixed topics) is NOT
part of plain ``match`` — the reference applies it inside the trie walk
(``vmq_reg_trie.erl:283-288``); we expose :func:`is_dollar_topic` and apply the
rule in the matchers.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

MAX_TOPIC_LEN = 65536

Topic = List[str]  # word list

PLUS = "+"
HASH = "#"
SHARE = "$share"


class TopicError(ValueError):
    """Raised for invalid topic names/filters; ``.reason`` is a stable slug."""

    def __init__(self, reason: str):
        super().__init__(reason)
        self.reason = reason


def word(topic_str: str) -> Topic:
    """Split a topic string into its word list (empty words preserved)."""
    return topic_str.split("/")


def unword(topic: Topic) -> str:
    """Join a word list back to the wire-format topic string."""
    return "/".join(topic)


def validate_topic(kind: str, topic_str: str) -> Topic:
    """Validate a wire topic string; returns the word list or raises TopicError.

    ``kind`` is ``"publish"`` or ``"subscribe"`` (vmq_topic.erl:82-90).
    """
    if topic_str == "":
        raise TopicError("no_empty_topic_allowed")
    if len(topic_str.encode("utf-8", "surrogatepass")) > MAX_TOPIC_LEN:
        raise TopicError("topic_too_long")
    if "\x00" in topic_str:
        raise TopicError("no_null_allowed_in_topic")
    words = topic_str.split("/")
    if kind == "publish":
        for w in words:
            if PLUS in w:
                raise TopicError(
                    "no_+_allowed_in_publish" if w == PLUS else "no_+_allowed_in_word"
                )
            if HASH in w:
                raise TopicError(
                    "no_#_allowed_in_publish" if w == HASH else "no_#_allowed_in_word"
                )
        return words
    elif kind == "subscribe":
        last = len(words) - 1
        for i, w in enumerate(words):
            if w == PLUS:
                continue
            if w == HASH:
                if i != last:
                    raise TopicError("no_#_allowed_in_word")
                continue
            if HASH in w:
                raise TopicError("no_#_allowed_in_word")
            if PLUS in w:
                raise TopicError("no_+_allowed_in_word")
        return _validate_shared(words)
    raise ValueError(f"unknown validate kind {kind!r}")


def _validate_shared(words: Topic) -> Topic:
    # $share requires a group and at least one topic word (vmq_topic.erl:131-133)
    if words and words[0] == SHARE and len(words) < 3:
        raise TopicError("invalid_shared_subscription")
    return words


def is_shared(topic: Topic) -> bool:
    return len(topic) >= 3 and topic[0] == SHARE


def unshare(topic: Topic) -> Tuple[Optional[str], Topic]:
    """Split ``$share/group/rest...`` into (group, rest); (None, topic) if unshared."""
    if is_shared(topic):
        return topic[1], topic[2:]
    return None, topic


def contains_wildcard(topic: Topic) -> bool:
    """True if any word is ``+`` or the topic ends in ``#`` (vmq_topic.erl:92-96)."""
    return any(w == PLUS for w in topic) or (bool(topic) and topic[-1] == HASH)


def is_dollar_topic(topic: Topic) -> bool:
    """True for ``$``-prefixed topic *names* (``$SYS/...``): wildcard
    subscriptions at the root must not match these (MQTT-4.7.2-1,
    vmq_reg_trie.erl:283-288)."""
    return bool(topic) and topic[0].startswith("$")


def match(name: Topic, filter_: Topic) -> bool:
    """Match a topic *name* against a subscription *filter*.

    Pure structural match (vmq_topic.erl:53-66) — the ``$`` rule is applied by
    callers via :func:`is_dollar_topic`. A trailing ``#`` also matches the
    parent level (``a/#`` matches ``a``).
    """
    i = 0
    n, f = len(name), len(filter_)
    while True:
        if i == f:
            return i == n
        fw = filter_[i]
        if fw == HASH:
            # '#' must be last word in a valid filter; matches remainder incl. empty
            return i == f - 1
        if i == n:
            return False
        if fw != PLUS and fw != name[i]:
            return False
        i += 1


def match_dollar_aware(name: Topic, filter_: Topic) -> bool:
    """`match` plus the MQTT-4.7.2-1 rule: root-level wildcard never matches
    a ``$``-topic."""
    if is_dollar_topic(name) and filter_ and filter_[0] in (PLUS, HASH):
        return False
    return match(name, filter_)


def triples(topic: Topic) -> List[Tuple[Tuple[str, ...], str, Tuple[str, ...]]]:
    """Trie edge list for a topic: [(parent_path, word, path)] with the root
    parent encoded as the empty tuple (vmq_topic.erl:71-77 uses ``root``)."""
    out = []
    path: Tuple[str, ...] = ()
    for w in topic:
        parent = path
        path = path + (w,)
        out.append((parent, w, path))
    return out
