"""File-based ACL plugin (mosquitto-style ACL syntax).

Mirrors ``apps/vmq_acl/src/vmq_acl.erl``: six rule sets — read/write ×
all-users/per-user/pattern (``vmq_acl.erl:38-45``); file syntax ``topic
[read|write] <filter>`` / ``user <name>`` / ``pattern [read|write]
<filter>`` with ``#`` comments (``parse_acl_line``, ``vmq_acl.erl:146-177``);
pattern rules substitute ``%u`` (username), ``%c`` (client-id) and ``%m``
(mountpoint) words before matching (``vmq_acl.erl:204-219``). Check order:
all-ACLs, then per-user, then patterns (``vmq_acl.erl:179-187``); a miss
returns ``next`` so other auth plugins may still allow (the hook chain's
default-deny applies when nobody answers). Reload replaces the rule sets
atomically (the reference ages + deletes entries; we swap whole sets).
"""

from __future__ import annotations

import logging
from typing import List, Optional, Sequence, Set, Tuple

from ..broker.plugins import NEXT, OK
from ..protocol import topic as T

log = logging.getLogger("vernemq_tpu_torch.acl")

Filter = Tuple[str, ...]


class AclPlugin:
    name = "vmq_acl"

    def __init__(self, acl_file: Optional[str] = None):
        self.acl_file = acl_file
        self.read_all: Set[Filter] = set()
        self.write_all: Set[Filter] = set()
        self.read_user: Set[Tuple[str, Filter]] = set()
        self.write_user: Set[Tuple[str, Filter]] = set()
        self.read_pattern: Set[Filter] = set()
        self.write_pattern: Set[Filter] = set()
        if acl_file:
            self.load_from_file(acl_file)

    # -- loading -----------------------------------------------------------

    def load_from_file(self, path: str) -> None:
        with open(path, "r", encoding="utf-8") as f:
            self.load_from_lines(f.read().splitlines())

    def load_from_lines(self, lines: Sequence[str]) -> None:
        ra: Set[Filter] = set()
        wa: Set[Filter] = set()
        ru: Set[Tuple[str, Filter]] = set()
        wu: Set[Tuple[str, Filter]] = set()
        rp: Set[Filter] = set()
        wp: Set[Filter] = set()
        user: Optional[str] = None

        def add(kind: str, rest: str) -> None:
            try:
                words = tuple(T.validate_topic("subscribe", rest.strip()))
            except T.TopicError as e:
                log.warning("invalid acl topic %r: %s", rest, e)
                return
            if kind in ("read", "both"):
                if user == "__pattern__":
                    rp.add(words)
                elif user is None:
                    ra.add(words)
                else:
                    ru.add((user, words))
            if kind in ("write", "both"):
                if user == "__pattern__":
                    wp.add(words)
                elif user is None:
                    wa.add(words)
                else:
                    wu.add((user, words))

        for raw in lines:
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            if line.startswith("topic read "):
                add("read", line[len("topic read "):])
            elif line.startswith("topic write "):
                add("write", line[len("topic write "):])
            elif line.startswith("topic "):
                add("both", line[len("topic "):])
            elif line.startswith("user "):
                user = line[len("user "):].strip()
            elif line.startswith("pattern read "):
                prev, user = user, "__pattern__"
                add("read", line[len("pattern read "):])
                user = prev
            elif line.startswith("pattern write "):
                prev, user = user, "__pattern__"
                add("write", line[len("pattern write "):])
                user = prev
            elif line.startswith("pattern "):
                prev, user = user, "__pattern__"
                add("both", line[len("pattern "):])
                user = prev
            else:
                log.warning("unparsable acl line: %r", line)
        self.read_all, self.write_all = ra, wa
        self.read_user, self.write_user = ru, wu
        self.read_pattern, self.write_pattern = rp, wp

    # -- checking ----------------------------------------------------------

    def check(self, access: str, topic: Sequence[str], user: Optional[str],
              sid: Tuple[str, str]) -> bool:
        """vmq_acl:check/4 — all-ACLs, then user ACLs, then patterns."""
        all_set = self.read_all if access == "read" else self.write_all
        for filt in all_set:
            if T.match(list(topic), list(filt)):
                return True
        if user is not None:
            user_set = self.read_user if access == "read" else self.write_user
            for u, filt in user_set:
                if u == user and T.match(list(topic), list(filt)):
                    return True
        # patterns apply to anonymous users too (vmq_acl.erl:179-187 only
        # short-circuits for the internal all-user marker); an unresolvable
        # %u word can then never match
        pat_set = self.read_pattern if access == "read" else self.write_pattern
        mp, client_id = sid
        unmatchable = "\x00anonymous"
        for filt in pat_set:
            resolved = tuple(
                (user if user is not None else unmatchable) if w == "%u"
                else client_id if w == "%c"
                else mp if w == "%m" else w
                for w in filt
            )
            if T.match(list(topic), list(resolved)):
                return True
        return False

    # -- hooks -------------------------------------------------------------

    def auth_on_publish(self, username, sid, qos, topic, payload, retain):
        return OK if self.check("write", topic, username, sid) else NEXT

    def auth_on_subscribe(self, username, sid, topics):
        for words, _qos in topics:
            if not self.check("read", words, username, sid):
                return NEXT
        return OK

    def register(self, hooks) -> None:
        hooks.register("auth_on_publish", self.auth_on_publish)
        hooks.register("auth_on_publish_m5", self.auth_on_publish)
        hooks.register("auth_on_subscribe", self.auth_on_subscribe)
        hooks.register("auth_on_subscribe_m5", self.auth_on_subscribe)

    def unregister(self, hooks) -> None:
        hooks.unregister("auth_on_publish", self.auth_on_publish)
        hooks.unregister("auth_on_publish_m5", self.auth_on_publish)
        hooks.unregister("auth_on_subscribe", self.auth_on_subscribe)
        hooks.unregister("auth_on_subscribe_m5", self.auth_on_subscribe)
