"""The MQTT topic rules the match engine needs (``vmq_topic.erl:53-66``).

Topics and filters are word lists; ``+`` eats one level, a trailing ``#``
eats the (possibly empty) remainder, and root-level wildcards never match a
``$``-prefixed topic name (MQTT-4.7.2-1, ``vmq_reg_trie.erl:283-288``).
"""

from __future__ import annotations

from typing import List

Topic = List[str]

PLUS = "+"
HASH = "#"


def is_dollar_topic(topic: Topic) -> bool:
    """True for ``$``-prefixed topic names (``$SYS/...``)."""
    return bool(topic) and topic[0].startswith("$")


def match(name: Topic, filter_: Topic) -> bool:
    """Structural match of a topic name against a filter (no ``$`` rule)."""
    i = 0
    n, f = len(name), len(filter_)
    while True:
        if i == f:
            return i == n
        fw = filter_[i]
        if fw == HASH:
            return i == f - 1
        if i == n:
            return False
        if fw != PLUS and fw != name[i]:
            return False
        i += 1


def match_dollar_aware(name: Topic, filter_: Topic) -> bool:
    """:func:`match` plus the MQTT-4.7.2-1 rule."""
    if is_dollar_topic(name) and filter_ and filter_[0] in (PLUS, HASH):
        return False
    return match(name, filter_)
